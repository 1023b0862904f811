"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py [--detail PATH] [--only PHASE [PHASE ...] | --only flash]

Run with no arguments, the script runs every phase below in one process
(steps 1-2 build and check the kernels, then the phases in PHASES order:
kernels, training_iterations, discovery, dataset, training, segmenter,
serving, transunet, swagan_emanet, dataset_gan, capstone, autoencoder,
options, evaluation) and ends in {"ok": true, "device": {...}}. `--only PHASE ...`
runs those phases and every phase whose outputs they need (each phase
names them: dataset needs discovery; segmenter dataset; serving
segmenter; transunet dataset and segmenter; swagan_emanet training and
segmenter; dataset_gan training and swagan_emanet; autoencoder training;
evaluation dataset, training, segmenter, capstone and autoencoder; options
dataset and segmenter), each
with its gates and its own launch checks, and ends in {"ok": true, "only":
[the phases run]}, never the full run's last line.

1. Builds the five hand-written kernel libraries from
   synthesis_in_style_tpu_torch/csrc (nvcc, one process per source, all
   started together).
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the two paths give it, with TF32 off for both: fused bias-act
   forward and backward at (16, 512) and (16, 256, 256, 128) in float32 and
   bfloat16, and the forward at the edges of its launch geometry (C of 3, 8,
   509, 512, fewer elements than one 16-byte vector, no rows, no bias, x at
   a storage offset) in both dtypes; the fused blur tail at the six
   upsample shapes of the 256px generator in float32 and bfloat16;
   union-find connected components,
   4- and 8-connected and bit-identical, on random masks, a 1-px snake, an
   all-foreground batch, a checkerboard, isolated pixels, a ragged
   (3, 37, 53), the real path's masks at (32, 256, 256) and their union at
   (16, 256, 256), and a page-sized (2, 1024, 768), every CC call under
   torch.cuda.set_sync_debug_mode("error") (no host sync inside). Each
   kernel is timed (wall per call, and device time from torch.profiler)
   beside its plain version, its bound and (backward) the nearest PyTorch
   calls.
3. Holds both autograd Functions (fused bias-act, fused blur tail) on the
   card against the same Functions on the CPU, first and second order.
4. Runs every step of one training iteration (D, R1, G, path length, EMA)
   of the full-width 256px G and D at batch 2, float32, on the card and on
   the CPU with the same draws, and holds the gradients of every parameter;
   it logs each step's worst tensor and, for R1, how far the card and the
   CPU each sit from a float64 run on the card (the fused ops' plain
   versions).
5. Cluster discovery on a randomly initialised 256px StyleGAN2 (seeded
   torch.Generator, the shipped stylegan_256px.yaml widths):
   `create_semantic_segmentation -n 20 -b 10 -c 6 9` (k = 6, 7, 8, all 14
   layers; the CLI's default -n 100 cut for time), once small to warm up,
   once measured with launch counts from 0
   (the bias-act forward and the blur tail must run, CC must not), with its
   generation, per-(layer, k) fit (seconds, steps, inertia), render and
   write seconds and activation bytes; its artifacts checked (14 unit-norm
   centres_ arrays with counts_ per catalog, int32 labels, uint8 NCHW
   arrays, the PNG grid). Then layer 8 (64px, 512 channels) fitted on the
   card and on the CPU with the same seed and TF32 off (equal steps,
   >= 99.9 % of labels equal, centres within 1e-3 cosine) and one epoch on
   the card under torch.cuda.set_sync_debug_mode("error");
   `select_cluster_config --ks 6 7 8 -n 32 -b 8` and `auto_label_clusters
   -k 8 -n 32` on the card with launch counts from 0, read as they return
   (every output parses; then the selection's outputs build the dataset
   segmenter, whose front half runs on one batch), and one statistics
   table card vs CPU (within 1e-4 of max|table|).
6. Holds the whole dataset path at full 256px width against itself on the
   CPU for a batch of 2: generator image and activations, and the device
   back half bit for bit.
7. Drives the dataset CLI (`create_dataset_for_segmentation --device-contours`)
   with that generator, the discovery phase's k = 8 catalog and a label map
   (two clusters by size rank as text), batch 16, 32 images; once to warm
   up, once measured, with every
   kernel's launch count set to 0 just before and read just after. Then
   the host contour route, the JAX package's default: the same CLI without
   --device-contours (batch 16, 16 images, launch counts from 0: the
   generator's bias-act and blur kernels must run and the CC kernel must
   not), its coco_gt.json decoded against the val labels, the same run with
   --contour-workers 2 (label pixels identical), the host route's stages
   per batch (synthesis, masks to the host, host half in process and in 2
   warm workers, PNG writing), and the host and device back halves on one
   batch of the path's own masks (<= 3 % of pixels apart). PNG pairs are
   written over a thread per core (`utils/png.write_png_batch`); the
   device route's per-batch stages time that writer and the one-thread
   writer, for the comparison in one run.
8. Drives the training CLI (`train_stylegan_2`) on the shipped
   configs/stylegan/stylegan_256px.yaml (bfloat16, frozen noise on layers
   0-5, the shipped regularization) with batch 16, 4 iterations and a
   snapshot at 4, over 64 synthetic 256px pages: once to warm up (2
   iterations; iteration 0 runs R1 and the path length), once
   measured (launch counts set to 0 before, read after; finite losses, D and
   G moved, the snapshot's g_ema loads through the dataset path's
   `load_generator` and renders); then one more iteration under
   torch.profiler (device busy share, kernels with the most device time).
   The fused bias-act forward is then held against its plain version at
   every (shape, dtype) the measured run launched, with its device time,
   bound and launches x (device time - bound) per shape.
9. Chains the segmenter path onto step 7's PNG pairs: the segmenter
   training CLI (`train`) on the shipped
   configs/segmenter/stylegan2_doc_ufcn_segmenter.yaml (DocUFCN 32/64/128/256,
   256px, batch 8, bfloat16) for 8 iterations with one validation pass at
   the end, once to warm up and once measured (launch counts set to 0
   before, read after); the loader alone (a pass that starts its workers,
   then one on the same workers, kept) and the training step alone (on a
   batch already on the card, one step under torch.profiler); the trained
   full-width DocUFCN forward, card vs CPU with TF32 off. Then
   `analyze_image_segments --use-device-component-filter` with its snapshot
   over 4 synthetic 2048x1536 pages and their ground truth, swept over
   min_confidence 0.0 0.7 x min_contour_area 0 55 (warm-up, then measured
   with launch counts; segmented_cc must have been launched on this path);
   pages/s of the segmenter at 0.7 / 55, one page under torch.profiler, the
   CC kernel bit for bit against its plain version on that page's closed
   masks, and one page card vs CPU (TF32 off) on a seeded full-width
   DocUFCN whose class map holds two classes or more at >= 1 % each: class
   map >= 99.9 % equal, >= 99.9 % of confidences within 1e-3. Then the
   analyze CLI at 0.7 / 55 without --use-device-component-filter (the host
   contour filter; its launch counts from 0), pages/s with that filter, and
   one page with -vis and every drawing flag (its images must exist).
10. Whole-page serving on that snapshot and those pages (0.7 / 55):
   pages/s of the unfused path, the fused path one page a call (a CUDA
   graph per page tiling) and `segment_images` 4 pages a replay, each in
   float32 and bfloat16 (2 x 16 pages a reading, after a first pass that
   captures the graphs), and one fused page under torch.profiler; with
   TF32 off, fused against unfused (confidences within 1e-5, class maps
   >= 99.9 %), each graph replay against the eager body on the same inputs
   (within 1e-5), bfloat16 against float32 class maps (>= 0.99 at 0.0 / 0,
   the JAX package's gate, on the trained snapshot; 0.7 / 55 reported), the
   first and the last again on a seeded multi-class DocUFCN (its bfloat16
   class map >= 0.99 on the pixels with a float32 logit margin >= 4, which
   must be a quarter of the page or more; all pixels reported), and a
   mixed-size set (2048x1536, 1536x2048, 1700x1200, 2480x3508, 2000x1500)
   served with bucket_quantum 0, None and page by page (within 1e-5; 4, 5
   and 5 graphs); a sweep 0.0 / 0.7 x 0 / 55 that must capture no graph
   beyond the structural ones, with the CC labellings per page counted
   from the replays x the labellings each capture recorded (> 0 at area
   55), equal to what the wrapper's launch count gained (a capture
   counts apart, a replay adds its labellings); then the analyze CLI in
   throughput mode (`--fused-page-inference --pages-per-batch 4`, launch
   counts from 0), whose confusion matrices must count no more than 1e-6
   of a page's pixels differently from the unfused CLI's (argmax
   near-ties: its class output skips the vote normalization, as the JAX
   package's does); both CLI modes at 0.7 / 55 over 4 and 8 pages
   (steady-state pages/s from the difference); and the phase's peak
   reserved memory.
11. The capstone recipe's training legs at the recipe's widths, cut in
   iterations and sample counts only: `make_capstone_fixture --size 256
   --num-pages 64 --num-eval 8` (host); the 128px leg's loader alone over
   three epochs (8 workers kept); `train_stylegan_2
   configs/stylegan/capstone_128px.yaml --val-images` cut to 20 iterations,
   snapshots and FID every 10 on 64 samples, its first attempt interrupted
   after the iteration-10 snapshot and a second one with `--resume-ckpt
   latest` that must start at 10 and end with iter_00000020.pt; then
   capstone_256px.yaml with `--init-ckpt` of that snapshot, cut to 8
   iterations and FID every 4 on 64 samples, its copied / fresh counts held
   against counts from the two snapshots' state dicts and one copied tensor
   of each network bit-equal to its 128px source; each GAN leg's launch
   counts from 0, its relative FID and seconds per evaluation, training
   images/s, and the alarm's fid_history; then `run_capstone_chain` on the
   256px snapshot (--ks 4 6 -n 16 --num-pairs 16 --epochs 1 --batch-size 8
   --min-confidence 0.0 0.7 --min-contour-area 0 55
   --use-device-component-filter, --select-args '--class-mode side
   --left-threshold 0.5 --num-fg-layers 1'), each
   leg a subprocess that writes its launch counts at exit, every leg exiting
   0 with its seconds and best_dice finite in [0, 1]; the fallback FID
   embedding's features card vs CPU with TF32 off (within 1e-4 relative)
   and one Frechet distance on each.
12. TransUNet (configs/segmenter/stylegan2_trans_u_net_segmenter.yaml:
   R50-ViT-B_16 at 512px, 12 blocks of 12 heads over 1024 tokens, batch 8,
   bfloat16, SGD). Before the other phases, with TF32 off: the flash
   attention kernels (csrc/flash_attention.cu, on the tensor cores:
   float32 in 3xTF32, csrc/flash_attention_f32.cuh; bfloat16,
   csrc/flash_attention_bf16.cuh) against their plain version
   at (8, 12, 1024, 64) (every training step and page batch; a short last
   batch of patches is padded to the batch), (4, 12, 1024, 64), (2, 2, 256,
   8), (1, 16, 128, 80) and (2, 12, 128, 64), and at N a multiple of no
   tile, (2, 2, 200, 64), (1, 4, 150, 128) and (1, 2, 257, 80), float32
   and bfloat16, and in float32 alone at head dims of no multiple of 8,
   (1, 3, 190, 36) and (2, 2, 130, 10); gradients through the autograd
   Function (float32 within 1e-5 / 1e-4 of max|ref|, bfloat16 within
   2^-7), two backward calls at the main shape bitwise equal in each dtype
   (the two-pass backwards have no atomics), timed at the main shape beside
   the plain version, the bound (float32: 3xTF32 at the TF32 rate, and on
   FMAs) and scaled_dot_product_attention, whose kernels a profile names.
   After the serving phase: the
   full-width network at 512px, batch 2, float32, TF32 off, on the card
   (flash) and on the CPU (plain), both against float64 on the card (eval
   logits within 1e-4; one step's gradients no further from float64 on the
   card than twice the CPU's); the training CLI on the shipped config with
   `attention_impl: flash` over step 7's pairs (2-iteration warm-up, then 4
   iterations and one validation pass with launch counts from 0: finite
   losses, weights moved, forward launches = 12 x forward passes, backward
   launches = 12 x iterations), then the same with the shipped config as it
   is (xla, no flash launch; no warm-up of its own: the flash runs warmed
   the process's convolutions), images/s of both; then
   `analyze_image_segments --use-device-component-filter` with the flash
   snapshot over step 9's 2048x1536 pages at 0.7 / 55 (512px patches; flash
   launches = 12 x forward passes, CC launched) and the segmenter's pages/s;
   then fused page inference against unfused with TF32 off (within 1e-5;
   flash launches = (replays + 2 warm-ups) x launches a replay), pages/s
   fused in float32 and bfloat16, bfloat16 class maps >= 0.99 of float32's.
   The training runs also time the step alone on a batch on the card (5
   steps, then one under torch.profiler), and then the same step in float32
   (the updater's compute_dtype unset: flash and xla; the flash run's 12
   forward and 12 backward launches a step counted from 0, none for xla;
   the flash kernels' device time in the profiled step). The flash page
   path profiles one float32 page (the float32 flash forward among its
   kernels).
13. The shipped swagan_* configurations, from GAN training to page
   inference. Beside step 4, with TF32 off: one full-width 256px SWAGAN
   iteration (D, R1, G, path length, EMA) at batch 2 in float32, card vs
   CPU, gradients of every parameter; the blur tail of step 2 covers
   SWAGAN's five upsample outputs ((8..64, 512) and (128, 256)). After
   the TransUNet phase: `train_stylegan_2` on configs/stylegan/
   swagan_256px.yaml (bfloat16) cut to batch 16, 4 iterations and a
   snapshot at 8 (a 2-iteration warm-up run, then measured with launch
   counts from 0:
   the bias-act forward and backward and the blur tail must run; one
   iteration under torch.profiler; the bias-act forward at every (shape,
   dtype) it launched); on that snapshot's g_ema, `create_semantic_
   segmentation -n 8 -b 8 -c 6 9` over all 12 wavelet-space layers
   (launch counts from 0), a label map for its k = 8 catalog, the dataset
   path at batch 2 card vs CPU (generator and activations within 1e-3, the
   device back half bit for bit) and the dataset CLI with configs/
   dataset_creation/swagan_cluster_based_bw_hwp_wpi.json (--device-
   contours, batch 16, 32 images; warm-up, then measured with launch
   counts from 0); one full-width EMANet float32 step (ResNet-50, stride
   8, 256px, batch 2, TF32 off, dropout off) on the card and on the CPU,
   both against the same step in float64 on the card (eval logits within
   1e-4; gradients, BatchNorm statistics and the new µ no further from
   float64 on the card than twice the CPU's); `train` on configs/
   segmenter/swagan_ema_net_segmenter.yaml (256px, batch 8, bfloat16) over
   the SWAGAN pairs (a 2-iteration warm-up, then 4 iterations and a
   validation pass with launch counts from 0; the step alone, 10 steps
   and one profiled); and its snapshot on step 9's four 2048x1536 pages
   at 0.7 / 55 (the analyze CLI with launch counts from 0, CC must run;
   with TF32 off fused within 1e-5 of unfused; pages/s unfused, fused and
   fused bfloat16, the bfloat16 class maps' agreement reported; one fused
   page profiled).
14. The DatasetGAN branch, after step 13, on step 8's StyleGAN2 snapshot
   (256px, F = 5888 features a pixel): `create_dataset_for_activation_
   classification -n 3 -b 3 --save-latents --save-activations -ge` (2
   train, 1 test image; images/s and the tensors.npz write's seconds),
   seeded rectangles of the class colours as hand labels; `train` on
   configs/dataset_creation/dataset_gan_wpi_stylegan2.yaml with the keys
   it lacks filled in (num_classes, tensor_path, checkpoint; as shipped it
   raises KeyError in both packages), generate: true, 3 members, batch 4
   pixels, 500 iterations, the datasets' length cut so that an epoch ends
   at 250 and the training set is regenerated on the card (iterations/s,
   the step alone over 50 steps and one profiled, each regeneration's
   seconds, the dice, peak reserved memory); one ensemble step from that
   state on the card and on the CPU with TF32 off (every parameter within
   1e-5 of the largest parameter, every BatchNorm statistic of the largest
   statistic); the same config with generate: false on the stored
   activations, 50 iterations; `create_dataset_for_segmentation` with
   configs/dataset_creation/stylegan2_dataset_gan_bw_hwp_wpi.json and the
   ensemble's snapshot, `-n 32 -b 16` (a warm-up at -n 16, then measured:
   labelled images/s, peak reserved memory) and its class map on 2 images
   card vs CPU with TF32 off (>= 0.999 of pixels); then 20 iterations of
   dataset_gan_wpi_swagan.yaml (filled in) on step 13's SWAGAN snapshot,
   its feature length read from its activations. The activation, training
   and dataset paths run with launch counts from 0 (the bias-act forward
   and the blur tail must run on each), and the two kernels are held
   against their plain versions at every (shape, dtype) each path launched.
15. The autoencoder and GAN-inversion branch, after step 11, on step 8's
   StyleGAN2 snapshot and its 64 pages (thresholded at 128 into the
   binary content images): a w+ autoencoder (seeded WPlusEncoder, the
   snapshot's g_ema as decoder) written with save_autoencoder_snapshot.
   With TF32 off, each gate in three runs on the same inputs, float32 on
   the card and on the CPU and float64 on the card (the fused ops' plain
   versions, `_float64_on_card`), every gradient tensor on the card no
   further from float64 than twice the CPU's plus 1e-3 of the step's
   largest gradient, capped at 5e-2 of the tensor's own and floored at
   1e-6 of the step's (`_grad_errors`: the encoder's first convolutions
   feed train-mode BatchNorm, where float32 loses ~1e-2 of max|ref| on
   either device, and ties break either way): one
   autoencoder step (MSE + LPIPS, batch 2; losses card vs CPU within
   1e-4, the decoder bitwise unchanged); one adversarial iteration (D,
   R1, G) at batch 1 (D's LeakyReLU tie flips against float64 counted,
   and the card's iteration repeated as it was and with cuDNN's
   deterministic algorithms, not gated); the
   first 3 steps of each projection stage at batch 1 on the g_ema with
   seeded non-zero noise weights; and the 256px StyleGAN1 generator and
   discriminator forwards (batch 2, within 1e-3 of max|ref|). Then, with
   PyTorch's defaults: autoencoder training (AutoencoderUpdater under the
   Trainer, denoising pairs, batch 8, 2 warm-up then 4 iterations with
   launch counts from 0: exactly 7 bias-act forwards, 6 blur tails and 13
   bias-act backwards an iteration; the step alone and profiled; peak
   reserved memory; the decoder unchanged); `train_adversarial_generator`
   (a 2-iteration first run that writes the snapshot, probe grid and log,
   then 4 iterations at batch 8 with launch counts from 0; D + G alone
   and profiled; peak memory); the same CLI with stylegan_variant 1 for 2
   iterations at batch 4 (no port kernel may run); run_image_reconstruction
   on 4 images at 50 + 50 steps (ms a step per stage, both losses
   falling, exactly a decode and its backward a step); analyze_latent_code
   on 8 images (the embedding's images/s, its cache and blueprints);
   `create_semantic_segmentation -i` at -n 8 -b 8 -c 6 8 (a decode a
   batch, the discovery artifacts). The bias-act pair and the blur tail
   are held against their plain versions at every (shape, dtype) the
   training, adversarial and projection paths launched.
16. Checkpoint evaluation and results analysis, after steps 11 and 15,
   on their outputs. With TF32 off, card against CPU on the same weights,
   images and draws (then, with PyTorch's defaults, the reconstruction
   scoring's images/s over the val pages on the card at -b 8, 3 passes
   after a warm one, no loader): `evaluate_checkpoints`' reconstruction
   scores of
   step 15's w+ autoencoder on 4 validation images, one a batch (each
   image's PSNR within 1e-3 dB; the SSIM of the two reconstructions
   computed in float64 within 1e-5, a w+ decode being ~1e-5 of max|ref|
   from the CPU; the script's float32 SSIM within 3e-5: 1e-5 for the
   decode plus each device's own float32 rounding of the metric, which
   sits up to ~1.05e-5 from its float64 value on these flat pages, where
   card and CPU read 1.01-1.03e-5 apart in float32 on an H100);
   GenerativeFID of step
   8's snapshot as the script builds it, 32 samples at -b 8 from the same
   z and the 16 val pages' real features (features within 1e-4 of
   max|ref|, the distance within 1e-3 relative; the capstone phase's FID
   check reads ~3e-7). Then with PyTorch's defaults:
   `evaluate_checkpoints` with its defaults (-b 8, --num-fid-samples 1000)
   on step 8's snapshot and the autoencoder snapshot over the last 16
   training pages (their val.json), launch counts from 0 and exactly the
   predicted ones (two FIDs of 125 forwards from z, 15 bias-act forwards
   and 6 blur tails each, and 2 w+ decodes, 7 and 6 each; nothing else),
   the reconstruction's seconds (loader start and PNG decoding in) and the
   FID seconds split into generation, features and the Frechet distance
   (each call between synchronizes); the same command again, which must skip every
   combination, load nothing (the loaders raise) and launch nothing;
   `fid_trend --num-samples 256 --batch 16` on step 11's 256px leg's
   checkpoints/ (its iter_* and init, 16 forwards each, exactly), seconds
   per checkpoint; `evaluate_metrics -p -c`, `extract_results_subset` on
   two pages and `plot_metrics` on step 9's results.json (no launch; the
   card machine has no pandas or matplotlib); COCODataset over step 7's
   host-route coco_gt.json through a DataLoader with its collate_func
   (every image once, with its annotations); and the bias-act forward and
   the blur tail at every (shape, dtype) `evaluate_checkpoints` and
   `fid_trend` launched against their plain versions.
17. The options phase, run after step 15 and before step 16, on step 7's
   run and step 9's snapshot and pages. The dataset CLI with `--quantize` (the w8a8 int8 generator,
   device contours, batch 16, 32 images after a one-batch warm-up; launch
   counts from 0: no blur tail, 7 int8 convolutions a forward, the
   forwards read from the bias-act count at 21 a forward), its labelled
   images/s read in turns with the float CLI's; the int8 kernel bit for
   bit at every shape that run launched; the quantized generator's
   cluster labels against the float one's on the same 16 latents, TF32
   off (the JAX package's gate: a k = 6 catalog fitted on the float
   activations of layers 4 and 6, > 0.99 each; the dataset path's
   catalogs at its layers 8, 9, 12, 13 reported). Page serving in int8
   (unfused and fused, beside float32 in the same run, 0.7 / 55) and the
   analyze CLI with `--quantize` (26 int8 convolutions a patch batch, CC
   launched); the JAX package's own DocUFCN gate on the card (widths 8 /
   16 / 24 / 32, 64 px, two BatchNorm updates: correlation > 0.995,
   agreement > 0.97, both decoders); the int8 kernel (csrc/int8_conv.cu)
   bit for bit against its plain version at every shape the page path and
   that gate launched and at (16, 256, 256, 128) x (3, 3, 128, 128), where
   it is timed beside the plain version, its bound, torch._int_mm over an
   im2col and cuDNN's float32, TF32 and bfloat16 convolutions; the served
   pages' class maps at 0.0 / 0 against float32 (> 0.97; on the seeded
   multi-class DocUFCN reported). Two training steps of the shipped
   DocUFCN with and without `remat` (TF32 off, cuDNN deterministic:
   gradients within 1e-5, BatchNorm statistics moved once a step, peak
   memory of each); a process group of world size 1 on NCCL driving a
   DocUFCN step (float64) and a 256px GAN iteration through the
   distributed route, against the same without a group (within 1e-5); and
   `scripts/sustained_synthesis.py` over 32 images (its samples of pairs
   written, RSS and open files).
   Steps 5, 7 to 10, the GAN legs of 11, the training and pages of 12,
   the paths of 13 and 14, the rates of 15, 16 and 17 run with PyTorch's
   defaults (TF32 cuDNN convolutions, float32 matmuls); each phase starts
   from that state (kernels, training_iterations and dataset from TF32
   off), so that it runs the same under --only.

The last lines are the card's name and power limit, a JSON line of per-kernel
numbers (the elementwise kernels' rows carry float32 and, as bf16_ms,
bf16_device_ms and bf16_bound_ms, bfloat16 numbers at the main shape), and
{"ok": true, "device": {...}}. Any failed phase raises, and the
script exits non-zero; without a CUDA device it exits 2 before any phase.
On one card, with the long per-phase record written to a file:
  python3 chip_smoke.py --detail chip_smoke_detail.json
The flash attention check of step 12 alone (build, ptxas's registers, spills
and shared memory for the flash kernels, the check and its timings; no path
is driven, so the last line is {"ok": true, "only": "flash"}):
  python3 chip_smoke.py --only flash [--detail PATH]
One phase with what it needs, e.g. the evaluation phase (discovery, dataset,
training, segmenter, capstone, autoencoder, evaluation):
  python3 chip_smoke.py --only evaluation [--detail PATH]
The detail file is rewritten after every phase, with each phase's seconds
and its steps' seconds (`phase_seconds`, `step_seconds`) and each finished
phase's record under `phases`.

The same paths by hand: cluster discovery, selection and labelling
  python -m synthesis_in_style_tpu_torch.cli.create_semantic_segmentation <ckpt> \
      -n 100 -b 10 -c 6 9
  python -m synthesis_in_style_tpu_torch.scripts.select_cluster_config <ckpt> \
      <run>/semantic_segmentation --ks 6 7 8
  python -m synthesis_in_style_tpu_torch.scripts.auto_label_clusters <ckpt> \
      <run>/semantic_segmentation -k 8
the training CLI
  python -m synthesis_in_style_tpu_torch.cli.train_stylegan_2 \
      configs/stylegan/stylegan_256px.yaml --images train.json -l <dir>
the dataset CLI on one of its snapshots (`<run>/checkpoints/iter_N.pt`), the
segmenter training CLI on the dataset's pairs
  python -m synthesis_in_style_tpu_torch.cli.train \
      configs/segmenter/stylegan2_doc_ufcn_segmenter.yaml --images train.json \
      --val-images val.json --class-to-color-map configs/handwriting_colors.json -l <dir>
and page inference with its snapshot, page by page or in throughput mode
  python -m synthesis_in_style_tpu_torch.cli.analyze_image_segments <pages> \
      -f eval.json -gt <gt> -o <out> -cds --use-device-component-filter \
      [--fused-page-inference --pages-per-batch 4] [--serving-dtype bfloat16]
checkpoint evaluation and the sweep's results
  python -m synthesis_in_style_tpu_torch.scripts.evaluate_checkpoints \
      checkpoints.txt datasets.json [-b 8] [--num-fid-samples 1000] [-d cuda|cpu]
  python -m synthesis_in_style_tpu_torch.scripts.fid_trend <run>/checkpoints \
      --images pages.json [--num-samples 256 --batch 16] [-d cuda|cpu]
  python -m synthesis_in_style_tpu_torch.cli.evaluate_metrics results.json -p -c
Their CPU counterparts, against the JAX package at small sizes:
  JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py -q

Rehearsing a phase on the CPU: the phase functions take the module's
DEVICE, CONFIG_256, CREATION_CONFIG, BATCH, NUM_IMAGES (HOST_ROUTE_IMAGES for
the host route) and NUM_CLUSTERS, so a script that imports this file can set
DEVICE = "cpu", a small generator (CONFIG_256 image_size 32, latent_size 32,
n_mlp 2, with the creation config's layers 4 5 / 6 7), BATCH 4, NUM_IMAGES
and HOST_ROUTE_IMAGES 8, write a run directory
(`make_run_dir`) with a catalog and label map of its own, and call
`host_route_phase(run, root, fns)` with stand-in counters (objects with a
`launches` attribute; on the CPU the plain versions run, so it must count
the two generator kernels itself). Its `if __name__ == "__main__"` guard
matters: --contour-workers spawns processes that import the main module.
The discovery phase rehearses the same way: `discovery_phase(run, fns)`
with DEVICE = "cpu", that small CONFIG_256, DISCOVERY_SAMPLES 8,
DISCOVERY_BATCH 4, a smaller DISCOVERY_WARMUP, FIT_LAYER "4", STATS_LAYER
"6", SELECT_SAMPLES 8, SELECT_BATCH 4, `_no_sync` and `profile_call` stubbed, stand-in
counters that the plain bias-act and blur functions increment; then
`write_catalog(run, gen)` with the creation config's layers 4 5 / 6 7
(~10 s).
The segmenter phase rehearses the same way (`segmenter_phase`, with
SEG_OVERRIDES, PAGE_H / PAGE_W / NUM_PAGES shrunk and bench_ms,
profile_call, _no_sync and the CC kernel's backend stubbed), and the
serving phase after it (`serving_phase(root, Path(seg["snapshot"]),
Path(seg["pages"]), Path(seg["pages_gt"]), fns)` on what it returns, with
MIXED_SIZES shrunk so that two pages share a bucket of the patch size,
e.g. 192x160 and 180x150 at 64-px patches, and seeded_page_network giving
a small network for pages under 256 px; ~45 s both). On the CPU the
page programs run eagerly, so no graph is captured and no replay counted.
The swagan_* phase's dataset half rehearses with DEVICE = "cpu":
`swagan_dataset(root, snapshot, fns)` on a seeded SWAGAN g_ema with
SWAGAN_CONFIG at image_size 32, latent_size 32, n_mlp 2, SWAGAN_CREATION a
file naming its layers 2 3 / 4 5, BATCH 8, NUM_IMAGES 8 and
SWAGAN_DISCOVERY (8, 8, (8, 9)) (~20 s; it skips the card-vs-CPU batch,
which needs 256 px); its EMANet half with EMANET_OVERRIDES and
EMANET_WARMUP at image_size 64, batch 2, num_workers 0, EMANET_CHECK_BATCH
1, profile_call stubbed, PAGE_H / PAGE_W / NUM_PAGES shrunk:
`check_emanet_card_vs_cpu()`, `emanet_training(root, pairs, fns)` and
`emanet_pages(root, snap, pages, gt, fns)` (~2 min).
The dataset_gan phase rehearses with DEVICE = "cpu": `dataset_gan_phase(root,
gan_snapshot, swagan_snapshot, fns)` on two seeded 32px g_ema snapshots
(`{"g_ema": state dict}` in `<run>/checkpoints/` beside `<run>/config/
config.json`; latent_size 32, n_mlp 2), DATASET_GAN_CUTS {"image_size":
32}, DATASET_GAN_ITERATIONS (20, 10), DATASET_GAN_SHORT 5,
DATASET_GAN_SWAGAN (4, 4), DATASET_GAN_SYNTHESIS (4, 2), NUM_IMAGES 4 and
stand-in counters (a `launches` count and a `shapes` Counter) that
wrappers of `ops.fused_act.fused_leaky_relu_plain` and
`models.stylegan2.blur_demod_noise_bias_act` increment (~15 s).
The autoencoder phase rehearses with DEVICE = "cpu": `autoencoder_phase(root,
snapshot, pages, fns)` on a seeded 32px g_ema snapshot (`{"g_ema": state
dict}` in `<run>/checkpoints/` beside `<run>/config/config.json`; latent_size
32, n_mlp 2, channel_multiplier 1), pages from `write_training_pages` with
TRAIN_PAGES 8, AE_STEP_BATCH 1, AE_RATE, ADV_RATE and ADV_V1 (2, 2),
PROJECTION (1, 30, 30), ANALYZE_IMAGES 4, AE_DISCOVERY (4, 2, (2, 3)),
set_tf32 stubbed and stand-in counters (a `launches` count and a `shapes`
Counter) that wrappers of `ops.fused_act.fused_leaky_relu_plain`,
`fused_leaky_relu_bwd_plain` and `ops.cuda.fused_blur.
blur_demod_noise_bias_act_plain` increment (~2 min).
So does the capstone phase: `capstone_phase(root, fns)` with DEVICE =
"cpu", CAPSTONE_WIDTHS giving both legs a small generator (latent_size 32,
n_mlp 2, batch_size 4, image_size 16 / 32), small CAPSTONE_*_CUTS and
CAPSTONE_INTERRUPT, FIXTURE_ARGS of 6 pages at 64px (one batch an epoch,
so the alarm runs every iteration), a small CHAIN_ARGS and
FID_CHECK_IMAGES, and stand-in counters (~1.5 min).
The evaluation phase rehearses with DEVICE = "cpu":
`evaluation_phase(root, gan_snapshot, pages, ae_snapshot, checkpoints_dir,
images_json, results_json, coco_gt, fns)` on a seeded 32px g_ema snapshot
(latent_size 32, n_mlp 2, channel_multiplier 1, beside its config), its
autoencoder from `write_autoencoder_snapshot`, a run's checkpoints/ with
two such snapshots, 32px pages with a train.json, a sweep results.json, a
coco_gt.json of 32px pairs, CONFIG_256 at image_size 32, EVAL_VAL_PAGES 4,
EVAL_BATCH 2, EVAL_FID_SAMPLES 4, EVAL_TREND (4, 2), EVAL_CHECK_IMAGES 1,
EVAL_CHECK_FID 4, EVAL_RATE_PASSES 1, set_tf32 and _defaults stubbed and stand-in counters (a
`launches` count and a `shapes` Counter) that wrappers of
`ops.fused_act.fused_leaky_relu_plain` and `ops.cuda.fused_blur.
blur_demod_noise_bias_act_plain` increment; the phase's own launch
predictions then hold on the CPU (~30 s;
tests/test_torch_chip_smoke_evaluation.py runs it).
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

SQRT2 = 2.0**0.5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SEED = 0
BATCH = 16
NUM_IMAGES = 32
CONFIG_256 = {  # configs/stylegan/stylegan_256px.yaml, as JSON
    "image_size": 256, "latent_size": 512, "n_mlp": 8, "channel_multiplier": 2,
    "stylegan_variant": 2,
}
CREATION_CONFIG = {  # configs/dataset_creation/stylegan2_cluster_based_bw_hwp_wpi.json
    "class_to_color_map": {"background": "#000000", "printed_text": "#0000FF",
                           "handwritten_text": "#FF0000"},
    "keys_for_finegrained_segmentation": ["12", "13"],
    "keys_for_class_determination": ["8", "9"],
    "keys_to_merge": {},
    "segmenter_type": "black_white_handwritten_printed",
    "only_keep_overlapping": False,
    "min_class_contour_area": 50,
    "seed": 1,
}
NUM_CLUSTERS = 8
SMALL_NUMEL = 1 << 22  # below this many elements a call is timed SMALL_ITERS times
SMALL_ITERS = 200


def log(msg: str) -> None:
    print(msg, flush=True)


SLOW_CALL_MS, SLOW_CALL_ITERS = 100.0, 3  # a call slower than this is timed over 3


def bench_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean time per fn() call over `iters` back-to-back calls, by CUDA
    events: the device's time, or the host's dispatch where that sets the
    pace (calls of a few microseconds of device work, timed over many
    iterations so that the mean settles). A call whose last warm-up took
    over SLOW_CALL_MS (the plain versions at page and path sizes) is timed
    over SLOW_CALL_ITERS calls."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(warmup):
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    if warmup and start.elapsed_time(end) > SLOW_CALL_MS:
        iters = min(iters, SLOW_CALL_ITERS)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20):
    """Mean device time per fn() call: the card's kernel time from
    torch.profiler over `iters` calls, without the host's dispatch between
    them (which bench_ms includes wherever it sets the pace). None if the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy_us / 1e3 / iters if busy_us > 0 else None


def queued_ms(fn, iters: int, repeats: int = 3) -> float:
    """Device time per fn() call with the host's dispatch hidden and no
    profiler: a sleep kernel holds the stream while the host queues `iters`
    calls, so CUDA events time them back to back on the card (kernels and
    the gaps between launches). The sleep is doubled until it outlasts the
    queueing; the median of `repeats` such means (the first of a process
    was seen to read 4x its neighbours). After the training runs, a
    torch.profiler profile of 20 calls was seen to hold only 8-10 of the
    launches and records of other profiles, so the phases after them time
    this way."""
    fn()
    torch.cuda.synchronize()
    cycles, means = 1 << 23, []
    while len(means) < repeats:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        torch.cuda._sleep(cycles)
        marks[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        marks[2].record()
        queueing_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if marks[0].elapsed_time(marks[1]) > queueing_ms:
            means.append(marks[1].elapsed_time(marks[2]) / iters)
        else:
            cycles *= 2
    return sorted(means)[repeats // 2]


def bound(nbytes: float, nops: float) -> dict:
    """The least time for the work: the larger of its bytes (each input read
    once, each output written once) over the memory rate and its operations
    over the float32 rate."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def set_tf32(enabled: bool) -> None:
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled


# ---------------------------------------------------------------------------
# kernel phases


def _summary(rows, key, main, keys=("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")):
    """The kernels-line numbers of an elementwise kernel: the float32 row at
    the main shape, and the bfloat16 row there (the training path's dtype) as
    bf16_ms, bf16_device_ms and bf16_bound_ms."""
    f32 = next(r for r in rows if r[key] == main and r["dtype"] == "float32")
    bf16 = next(r for r in rows if r[key] == main and r["dtype"] == "bfloat16")
    return {**{k: f32[k] for k in keys}, "bf16_ms": bf16["ms"],
            "bf16_device_ms": bf16["device_ms"], "bf16_bound_ms": bf16["bound_ms"]}


def _bias_act_bound(x: torch.Tensor) -> dict:
    # read x, write y, read the C-wide bias; add, compare, two multiplies per element
    return bound((2 * x.numel() + x.shape[-1]) * x.element_size(), 4 * x.numel())


def _check_forward(what, x, b, tol) -> tuple:
    """The forward kernel against its plain version on x (and b or None);
    returns (max abs error, tolerance)."""
    from synthesis_in_style_tpu_torch.ops.cuda.fused_bias_act import (
        fused_leaky_relu_cuda,
        fused_leaky_relu_plain,
    )

    got = fused_leaky_relu_cuda(x, b)
    ref = fused_leaky_relu_plain(x, b)
    if got.shape != x.shape or got.dtype != x.dtype:
        raise AssertionError(f"fused_bias_act {what}: {tuple(got.shape)} {got.dtype}")
    if x.numel() == 0:
        return 0.0, 0.0
    err = (got.float() - ref.float()).abs().max().item()
    limit = tol * max(1.0, ref.float().abs().max().item())
    if not err <= limit:
        raise AssertionError(f"fused_bias_act {what}: err {err} > {limit}")
    return err, limit


BIAS_ACT_TOLERANCES = ((torch.float32, 1e-5), (torch.bfloat16, 2.0**-7))


def check_fused_bias_act(detail):
    from synthesis_in_style_tpu_torch.ops.cuda.fused_bias_act import (
        bias_act_geometry,
        fused_leaky_relu_cuda,
        fused_leaky_relu_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    for shape in ((16, 512), (16, 256, 256, 128)):
        for dtype, tol in BIAS_ACT_TOLERANCES:
            x = torch.randn(shape, generator=g, device="cuda").to(dtype)
            b = torch.randn(shape[-1], generator=g, device="cuda").to(dtype)
            err, limit = _check_forward(f"{shape} {dtype}", x, b, tol)
            iters = SMALL_ITERS if x.numel() < SMALL_NUMEL else 10
            row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                   "max_abs_err": err, "tolerance": limit, "iters": iters,
                   "geometry": list(bias_act_geometry(x.numel(), shape[-1], x.element_size(),
                                                      x.data_ptr(), x.data_ptr())),
                   "ms": bench_ms(lambda: fused_leaky_relu_cuda(x, b), iters),
                   "device_ms": device_ms(lambda: fused_leaky_relu_cuda(x, b)),
                   "plain_ms": bench_ms(lambda: fused_leaky_relu_plain(x, b), iters),
                   # the card's practical rate for these bytes: a copy of x
                   "copy_ms": bench_ms(lambda: torch.empty_like(x).copy_(x), iters),
                   **_bias_act_bound(x)}
            detail.append(row)
            worst = max(worst, err)
            log(f"fused_bias_act {row}")
    return {**_summary(detail, "shape", [16, 256, 256, 128]), "max_abs_err": worst}


# (name, shape, with bias, x at a storage offset of one element)
BIAS_ACT_EDGES = (
    ("C=3", (37, 3), True, False),
    ("C=8", (1000, 8), True, False),
    ("C=509", (33, 509), True, False),
    ("C=512", (129, 512), True, False),
    ("numel below one vector", (3,), True, False),
    ("no rows", (0, 8), True, False),
    ("bias=None", (16, 64, 64, 512), False, False),
    ("bias=None C=3", (37, 3), False, False),
    ("misaligned C=8", (1000, 8), True, True),
    ("misaligned C=512", (16, 8, 8, 512), True, True),
    ("misaligned bias=None", (129, 512), False, True),
)


def check_fused_bias_act_edges(detail) -> float:
    """The forward kernel against its plain version at the edges of its
    geometry, float32 (1e-5) and bfloat16 (2^-7), both x max|ref|: channel
    counts that do and do not fill a 16-byte vector, fewer elements than one
    vector, no rows, no bias, and x one element past a 16-byte boundary
    (a contiguous view at a storage offset), which must take the scalar
    route. Returns the worst error."""
    from synthesis_in_style_tpu_torch.ops.cuda.fused_bias_act import bias_act_geometry

    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    worst = 0.0
    for dtype, tol in BIAS_ACT_TOLERANCES:
        for name, shape, with_bias, misaligned in BIAS_ACT_EDGES:
            n = math.prod(shape)
            buf = torch.randn(n + 1, generator=g, device="cuda").to(dtype)
            x = (buf[1:] if misaligned else buf[:n].clone()).view(shape)
            b = torch.randn(shape[-1], generator=g, device="cuda").to(dtype) if with_bias else None
            vec = bias_act_geometry(n, shape[-1], x.element_size(), x.data_ptr(), x.data_ptr())[0]
            full = 16 // x.element_size()
            want = 1 if misaligned or (shape[-1] * x.element_size()) % 16 else full
            if n and vec != want:
                raise AssertionError(f"fused_bias_act edge {name}: vector width {vec} != {want}")
            err, limit = _check_forward(f"edge {name} {dtype}", x, b, tol)
            row = {"case": name, "shape": list(shape), "dtype": str(dtype).split(".")[-1],
                   "bias": with_bias, "x_offset_bytes": x.data_ptr() % 16, "vec": vec,
                   "max_abs_err": err, "tolerance": limit}
            detail.append(row)
            worst = max(worst, err)
            log(f"fused_bias_act edge {row}")
    return worst


def check_fused_bias_act_path_shapes(detail, shapes, iterations: int) -> dict:
    """The forward kernel at every (shape, dtype) the training path launched
    (`shapes`: launches by key, from the measured run of `iterations`
    iterations): held against the plain version, its device time
    (`queued_ms`) beside its bound, and launches x (device_ms - bound_ms),
    the time above the bound that shape costs the run; summed, and per
    iteration."""
    from synthesis_in_style_tpu_torch.ops.cuda.fused_bias_act import fused_leaky_relu_cuda

    tols = dict(BIAS_ACT_TOLERANCES)
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    excess = 0.0
    for (shape, dtype), launches in sorted(shapes.items(), key=lambda kv: -kv[1]):
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        b = torch.randn(shape[-1], generator=g, device="cuda").to(dtype)
        err, limit = _check_forward(f"path {shape} {dtype}", x, b, tols[dtype])
        iters = SMALL_ITERS if x.numel() < SMALL_NUMEL else 10
        dev = queued_ms(lambda: fused_leaky_relu_cuda(x, b), iters)
        row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1], "launches": launches,
               "max_abs_err": err, "tolerance": limit, "iters": iters,
               "ms": bench_ms(lambda: fused_leaky_relu_cuda(x, b), iters), "device_ms": dev,
               **_bias_act_bound(x)}
        row["excess_ms"] = launches * (dev - row["bound_ms"])
        excess += row["excess_ms"]
        detail.append(row)
        log(f"fused_bias_act path shape {row['shape']} {row['dtype']}: launches {launches}, "
            f"ms {row['ms']:.6f}, device_ms {dev:.6f}, bound_ms {row['bound_ms']:.6f}, "
            f"launches x (device - bound) {row['excess_ms']:.6f}")
    summary = {"shapes": len(shapes), "launches": sum(shapes.values()),
               "excess_ms": excess, "excess_ms_per_iteration": excess / iterations}
    log(f"fused_bias_act on the training path: {summary}")
    return summary


def check_fused_bias_act_bwd(detail):
    """The backward kernel at the forward's shapes: y from the forward
    kernel (so its signs are the path's), g random."""
    from synthesis_in_style_tpu_torch.ops.cuda.fused_bias_act import (
        fused_leaky_relu_bwd_cuda,
        fused_leaky_relu_bwd_plain,
        fused_leaky_relu_cuda,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    worst = 0.0
    for shape in ((16, 512), (16, 256, 256, 128)):
        for dtype, tol in BIAS_ACT_TOLERANCES:
            x = torch.randn(shape, generator=g, device="cuda").to(dtype)
            b = torch.randn(shape[-1], generator=g, device="cuda").to(dtype)
            y = fused_leaky_relu_cuda(x, b)
            grad = torch.randn(shape, generator=g, device="cuda").to(dtype)
            got = fused_leaky_relu_bwd_cuda(y, grad).float()
            ref = fused_leaky_relu_bwd_plain(y, grad).float()
            err = (got - ref).abs().max().item()
            limit = tol * max(1.0, ref.abs().max().item())
            if not err <= limit:
                raise AssertionError(f"fused_bias_act_bwd {shape} {dtype}: err {err} > {limit}")

            def library():  # the nearest PyTorch calls: two of them
                return torch.ops.aten.leaky_relu_backward(grad, y, 0.2, True) * SQRT2

            iters = SMALL_ITERS if y.numel() < SMALL_NUMEL else 10
            row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                   "max_abs_err": err, "tolerance": limit, "iters": iters,
                   "ms": bench_ms(lambda: fused_leaky_relu_bwd_cuda(y, grad), iters),
                   "device_ms": device_ms(lambda: fused_leaky_relu_bwd_cuda(y, grad)),
                   "plain_ms": bench_ms(lambda: fused_leaky_relu_bwd_plain(y, grad), iters),
                   "library_ms": bench_ms(library, iters),
                   "library_device_ms": device_ms(library),
                   # read y and g, write dx; a compare and a multiply per element
                   **bound(3 * y.numel() * y.element_size(), 2 * y.numel())}
            detail.append(row)
            worst = max(worst, err)
            log(f"fused_bias_act_bwd {row}")
    return {**_summary(detail, "shape", [16, 256, 256, 128],
                       ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")),
            "max_abs_err": worst}


# StyleGAN2's six upsample outputs at 256px, and SWAGAN's (its pyramid ends
# one octave lower): (8..64, 512) shared, (128, 256) SWAGAN's last
BLUR_SHAPES = ((8, 512), (16, 512), (32, 512), (64, 512), (128, 256), (256, 128))


def check_fused_blur(detail):
    """The blur tail at the six upsample shapes, float32 (the dataset path)
    and bfloat16 (training). float32: max abs error <= 1e-4 (the 16
    taps are summed in another order); bfloat16: <= 2^-7 x max|ref|, both
    against the plain version in the working type. The kernels line reports
    the 256^2 x 128 shape in float32 and bfloat16 and the worst float32
    error."""
    from synthesis_in_style_tpu_torch.ops.cuda.fused_blur import (
        blur_demod_noise_bias_act_cuda,
        blur_demod_noise_bias_act_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for res, c in BLUR_SHAPES:
            x = torch.randn((BATCH, res + 1, res + 1, c), generator=g, device="cuda").to(dtype)
            demod = torch.rand((BATCH, c), generator=g, device="cuda") + 0.5
            noise = torch.randn((1, res, res), generator=g, device="cuda")
            bias = torch.randn((c,), generator=g, device="cuda")
            args = (x, demod, noise, bias)
            got = blur_demod_noise_bias_act_cuda(*args).float()
            ref = blur_demod_noise_bias_act_plain(*args).float()
            err = (got - ref).abs().max().item()
            limit = 1e-4 if dtype == torch.float32 else 2.0**-7 * ref.abs().max().item()
            name = str(dtype).split(".")[-1]
            if not err <= limit:
                raise AssertionError(f"fused_blur {res}x{res}x{c} {name}: err {err} > {limit}")
            out_bytes = got.numel() * x.element_size()
            in_bytes = x.numel() * x.element_size() + \
                (demod.numel() + noise.numel() + bias.numel()) * 4
            iters = SMALL_ITERS if got.numel() < SMALL_NUMEL else 10
            row = {"out": [BATCH, res, res, c], "dtype": name, "max_abs_err": err,
                   "tolerance": limit, "iters": iters,
                   "ms": bench_ms(lambda: blur_demod_noise_bias_act_cuda(*args), iters),
                   "device_ms": device_ms(lambda: blur_demod_noise_bias_act_cuda(*args)),
                   "plain_ms": bench_ms(lambda: blur_demod_noise_bias_act_plain(*args), iters),
                   # 16 multiply-adds, then demod, noise, bias, compare, two multiplies
                   **bound(in_bytes + out_bytes, 38 * got.numel())}
            detail.append(row)
            if dtype == torch.float32:
                worst = max(worst, err)
            log(f"fused_blur {row}")
    return {**_summary(detail, "out", [BATCH, 256, 256, 128]), "max_abs_err": worst}


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.detach().cpu().double() - ref.detach().double()).abs().max()
            / ref.detach().double().abs().max().clamp_min(1e-30)).item()


def check_autograd_functions(detail) -> float:
    """FusedLeakyReLUFunction and FusedBlurTailFunction on the card (kernels)
    against the same Functions fed CPU copies (plain versions), first and
    second order, TF32 off: L = sum(op(inputs) * t), its gradients (first
    order), then the gradients of R = sum(v * dL/dx^2) + sum(u * dL/d(bias
    or demod)) (second order, the R1 / path-length pattern). Relative
    tolerance 1e-4 and 1e-3 of the largest reference value. An element whose
    forward sign differs between kernel and plain version (a pre-activation
    within rounding of 0: the blur kernel sums its taps in another order)
    gets a zero cotangent and is left out of the gradient with respect to
    the cotangent, so a flipped LeakyReLU branch does not enter the
    comparison; the count of such elements is reported."""
    from synthesis_in_style_tpu_torch.ops.cuda.fused_blur import blur_demod_noise_bias_act
    from synthesis_in_style_tpu_torch.ops.fused_act import fused_leaky_relu

    g = torch.Generator().manual_seed(SEED + 8)
    cases = [("bias_act", fused_leaky_relu,
              lambda: [torch.randn((16, 256, 256, 128), generator=g),
                       torch.randn((128,), generator=g)])]
    for res, c in ((256, 128), (8, 512)):
        cases.append((f"blur_{res}", blur_demod_noise_bias_act, lambda res=res, c=c: [
            torch.randn((4, res + 1, res + 1, c), generator=g),
            torch.rand((4, c), generator=g) + 0.5,
            torch.randn((1, res, res), generator=g),
            torch.randn((c,), generator=g)]))
    worst = 0.0
    for name, op, make in cases:
        inputs = make()
        with torch.no_grad():
            y_card = op(*[a.cuda() for a in inputs]).cpu()
            y_cpu = op(*inputs)
        flipped = (y_card >= 0) != (y_cpu >= 0)
        t = torch.randn(y_cpu.shape, generator=g).masked_fill_(flipped, 0.0)
        v = torch.randn(inputs[0].shape, generator=g)
        u = torch.randn(inputs[1].shape, generator=g)
        out = {}
        for device in ("cuda", "cpu"):
            xs = [a.to(device).requires_grad_(True) for a in inputs]
            tt = t.to(device).requires_grad_(True)
            loss = (op(*xs) * tt).sum()
            first = torch.autograd.grad(loss, xs, create_graph=True)
            r = (v.to(device) * first[0] ** 2).sum() + (u.to(device) * first[1]).sum()
            second = torch.autograd.grad(r, [xs[0], xs[1], tt], allow_unused=True)
            out[device] = (first, second)
        row = {"case": name, "shape": list(inputs[0].shape), "flipped": int(flipped.sum())}
        # dR/dt of a flipped element carries that element's own branch
        for device in out:
            second = list(out[device][1])
            second[2] = second[2].masked_fill(flipped.to(second[2].device), 0.0)
            out[device] = (out[device][0], second)
        for order, tol in ((0, 1e-4), (1, 1e-3)):
            errs = []
            for got, ref in zip(out["cuda"][order], out["cpu"][order]):
                if ref is None or not ref.any():  # d/dx and d/db of the mask: 0
                    if got is not None and got.any():
                        raise AssertionError(f"{name} order {order + 1}: nonzero where 0")
                    continue
                errs.append(_rel(got, ref))
            row[f"rel_err_order{order + 1}"] = max(errs)
            if not max(errs) <= tol:
                raise AssertionError(f"{name} order {order + 1}: rel err {max(errs)} > {tol}")
            worst = max(worst, max(errs))
        detail.append(row)
        log(f"autograd Function {row}")
    return worst


def _snake(h: int, w: int) -> torch.Tensor:
    mask = torch.zeros((h, w), dtype=torch.bool)
    for row in range(0, h, 2):
        mask[row, :] = True
        if row + 1 < h:
            mask[row + 1, w - 1 if (row // 2) % 2 == 0 else 0] = True
    return mask


def _no_sync(fn):
    """fn() with every implicit device-to-host sync turned into an error."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _cc_cases(path_masks: torch.Tensor):
    from synthesis_in_style_tpu_torch.segmentation.device_cc import fill_holes

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    ys = torch.arange(256, device="cuda")[:, None]
    xs = torch.arange(256, device="cuda")[None, :]
    cases = [(f"random{d}", torch.rand((32, 256, 256), generator=g, device="cuda") < d)
             for d in (0.2, 0.45, 0.6)]
    cases += [
        ("snake", _snake(256, 256).cuda()[None].expand(32, -1, -1).contiguous()),
        ("all_foreground", torch.ones((32, 256, 256), dtype=torch.bool, device="cuda")),
        # joined only diagonally: one component under 8, none joined under 4
        ("checkerboard", ((ys + xs) % 2 == 0)[None].expand(32, -1, -1).contiguous()),
        ("isolated_pixels", ((ys % 3 == 0) & (xs % 3 == 0))[None].expand(32, -1, -1)
         .contiguous()),
        ("ragged_3x37x53", torch.rand((3, 37, 53), generator=g, device="cuda") < 0.5),
        ("path", path_masks),
        # the shape of device_segmenter's union call: the filled union of two layers
        ("path_union_16", fill_holes(path_masks[:16] | path_masks[16:])),
        ("page_2x1024x768", torch.rand((2, 1024, 768), generator=g, device="cuda") < 0.5),
    ]
    return cases


def check_segmented_cc(detail, path_masks: torch.Tensor):
    """path_masks: (32, 256, 256) bool, the first CC input of the real back
    half (dilated, hole-filled fine-layer masks). Every kernel call runs with
    implicit syncs made errors; the timed one too (the synchronizes of the
    timing itself lie outside)."""
    from synthesis_in_style_tpu_torch.segmentation.device_cc import connected_components

    for name, mask in _cc_cases(path_masks):
        for conn in (4, 8):
            got = _no_sync(lambda: connected_components(mask, connectivity=conn,
                                                        backend="kernel"))
            ref = connected_components(mask, connectivity=conn, backend="plain")
            if not torch.equal(got, ref):
                raise AssertionError(f"segmented_cc {name} conn {conn}: labels differ")
            if name == "all_foreground" and not bool((got == 0).all()):
                raise AssertionError("segmented_cc all_foreground: labels are not all 0")
            log(f"segmented_cc {name} {tuple(mask.shape)} conn {conn}: bit-identical, "
                f"{int((got >= 0).sum())} fg px, {len(torch.unique(got[got >= 0]))} components")
    mask = path_masks
    row = {"case": "path masks, connectivity 8, one fixpoint per call",
           "shape": list(mask.shape), "max_abs_err": 0, "sync_debug_mode": "error",
           "ms": bench_ms(lambda: _no_sync(lambda: connected_components(
               mask, connectivity=8, backend="kernel")), iters=50, warmup=2),
           "device_ms": device_ms(lambda: connected_components(mask, connectivity=8,
                                                               backend="kernel")),
           "plain_ms": bench_ms(lambda: connected_components(mask, connectivity=8,
                                                             backend="plain"),
                                iters=2, warmup=1),
           # the mask read once (1 B/px), the labels written once (4 B/px); a
           # one-pass labelling compares each pixel with its 8 neighbours
           **bound(mask.numel() * 5, mask.numel() * 8)}
    detail.append(row)
    log(f"segmented_cc {row}")
    return {k: row[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                "max_abs_err")}


# ---------------------------------------------------------------------------
# path set-up


def make_run_dir(root: Path) -> Path:
    """<root>/run/{config/config.json, checkpoints/g_ema.pt}: a randomly
    initialised 256px generator from a seeded torch.Generator."""
    from synthesis_in_style_tpu_torch.models.factory import get_generator

    run = root / "run"
    (run / "config").mkdir(parents=True)
    (run / "checkpoints").mkdir()
    (run / "config" / "config.json").write_text(json.dumps(CONFIG_256))
    gen = get_generator(CONFIG_256).init_weights(torch.Generator().manual_seed(SEED))
    torch.save({"g_ema": gen.state_dict()}, run / "checkpoints" / "g_ema.pt")
    return run


def write_catalog(run: Path, gen, config=None, creation=None) -> None:
    """merged_classes_<k>.json for catalogs/<k>.npz of the discovery phase
    (the port's own fit): two clusters (the same size ranks in every layer)
    printed and handwritten text, the rest background. `config` and
    `creation` default to CONFIG_256 and CREATION_CONFIG."""
    import numpy as np

    config, creation = config or CONFIG_256, creation or CREATION_CONFIG

    from synthesis_in_style_tpu_torch.segmentation.factor_catalog import load_catalogs

    sem = run / "semantic_segmentation"
    catalog = load_catalogs(sem / "catalogs" / f"{NUM_CLUSTERS}.npz")
    g = torch.Generator().manual_seed(SEED + 3)
    z = torch.randn((BATCH, config["latent_size"]), generator=g).to(DEVICE)
    with torch.no_grad():
        _, acts = gen([z], randomize_noise=False, return_intermediate_activations=True)
    layers = creation["keys_for_class_determination"] + \
        creation["keys_for_finegrained_segmentation"]
    sizes = {}
    for layer in layers:
        assign = catalog[layer].predict(acts[int(layer)]).reshape(-1)
        sizes[layer] = torch.bincount(assign, minlength=NUM_CLUSTERS).cpu().numpy()

    def label_map(printed_rank: int, handwritten_rank: int) -> dict:
        out = {}
        for layer in layers:
            order = np.argsort(-sizes[layer])
            names = ["background"] * NUM_CLUSTERS
            names[order[printed_rank]] = "printed_text"
            names[order[handwritten_rank]] = "handwritten_text"
            out[layer] = {str(int(c)): names[c] for c in range(NUM_CLUSTERS)}
        return out

    # which size ranks become text: the pair that paints most of the probe
    # batch while the drop rule keeps at least 3/4 of it
    from synthesis_in_style_tpu_torch.cli.create_dataset_for_segmentation import (
        get_dataset_segmenter,
    )

    map_file = sem / f"merged_classes_{NUM_CLUSTERS}.json"
    map_file.write_text(json.dumps(label_map(0, 1)))
    seg = get_dataset_segmenter(argparse.Namespace(num_clusters=NUM_CLUSTERS), creation,
                                config["image_size"], sem, DEVICE)
    acts = {str(k): v for k, v in acts.items() if str(k) in seg.catalog}
    best = None
    for p_rank in range(5):
        for h_rank in range(5):
            if p_rank == h_rank:
                continue
            seg.class_label_map = _invert(label_map(p_rank, h_rank))
            idx, drop = seg._build_device_segment_fn()(acts)
            painted = (idx[~drop] > 0).float().mean().item() if (~drop).any() else 0.0
            if int(drop.sum()) <= BATCH // 4 and (best is None or painted > best[0]):
                best = (painted, p_rank, h_rank)
    if best is None:
        raise AssertionError("no label map keeps 3/4 of the probe batch")
    map_file.write_text(json.dumps(label_map(best[1], best[2])))
    log(f"catalog: text classes at cluster size ranks {best[1:]}, probe painted share "
        f"{best[0]:.4f}")


def _invert(label_map: dict) -> dict:
    """{layer: {cluster_id: class}} -> {layer: {class: [cluster_ids]}}."""
    out = {}
    for layer, sub in label_map.items():
        out[layer] = {}
        for cluster, name in sub.items():
            out[layer].setdefault(name, []).append(int(cluster))
    return out


def counters():
    from synthesis_in_style_tpu_torch.ops.cuda.fused_bias_act import (
        fused_leaky_relu_bwd_cuda,
        fused_leaky_relu_cuda,
    )
    from synthesis_in_style_tpu_torch.ops.cuda.fused_blur import blur_demod_noise_bias_act_cuda
    from synthesis_in_style_tpu_torch.ops.cuda.int8_conv import int8_conv_cuda
    from synthesis_in_style_tpu_torch.ops.cuda.segmented_cc import connected_components_cuda

    # segmented_cc counts labellings (one fixpoint each), not kernel launches;
    # flash_attention_bwd counts backward calls (three kernels each)
    return {"fused_bias_act": fused_leaky_relu_cuda,
            "fused_bias_act_bwd": fused_leaky_relu_bwd_cuda,
            "fused_blur": blur_demod_noise_bias_act_cuda,
            "segmented_cc": connected_components_cuda, **flash_counters(),
            "int8_conv": int8_conv_cuda}


def reference_check(run: Path, config=None, creation=None) -> torch.Tensor:
    """Full-width port on the card against the same port on the CPU (plain
    versions), batch 2, TF32 off (`config` and `creation` default to
    CONFIG_256 and CREATION_CONFIG). Returns the first CC input of the
    card's back half at the path's batch (for the CC kernel phase)."""
    from synthesis_in_style_tpu_torch.cli.create_dataset_for_segmentation import (
        get_dataset_segmenter,
    )
    from synthesis_in_style_tpu_torch.models.factory import load_generator
    from synthesis_in_style_tpu_torch.segmentation.device_cc import dilate_cross, fill_holes

    config, creation = config or CONFIG_256, creation or CREATION_CONFIG
    ckpt = run / "checkpoints" / "g_ema.pt"
    args = argparse.Namespace(num_clusters=NUM_CLUSTERS)
    z = torch.randn((BATCH, 512), generator=torch.Generator().manual_seed(SEED + 4))
    out = {}
    for device in ("cuda", "cpu"):
        gen = load_generator(ckpt, config, device=device)
        seg = get_dataset_segmenter(args, creation, 256, run / "semantic_segmentation",
                                    device)
        zz = z[:2] if device == "cpu" else z
        with torch.no_grad():
            image, acts = gen([zz.to(device)], randomize_noise=False,
                              return_intermediate_activations=True)
        acts = {str(k): v for k, v in acts.items() if str(k) in seg.catalog}
        out[device] = (image, acts, seg)
    image_c, acts_c, seg_c = out["cuda"]
    image_h, acts_h, seg_h = out["cpu"]
    if not torch.isfinite(image_c).all():
        raise AssertionError("non-finite generator output on the card")
    worst = 0.0
    for name, a, b in [("image", image_c[:2], image_h)] + [
        (f"act {k}", acts_c[k][:2], acts_h[k]) for k in sorted(acts_h)
    ]:
        rel = ((a.cpu() - b).abs().max() / b.abs().max()).item()
        worst = max(worst, rel)
        if not rel <= 1e-3:  # float32, cuDNN vs CPU convolutions, 14 layers deep
            raise AssertionError(f"{name}: card vs CPU relative error {rel} > 1e-3")
    log(f"generator 256px card vs CPU: max relative error {worst:.3g}")
    # the back half, card vs CPU, on the card's masks (batch 2)
    masks_c = seg_c.compute_masks(acts_c)
    # the two images of the batch that the card's back half paints most
    idx_full, _ = seg_c._build_device_segment_fn().segment_masks(masks_c)
    pick = torch.argsort((idx_full > 0).sum(dim=(1, 2)), descending=True)[:2]
    small = {k: m[pick] for k, m in masks_c.items()}
    idx_c, drop_c = seg_c._build_device_segment_fn().segment_masks(small)
    idx_h, drop_h = seg_h._build_device_segment_fn().segment_masks(
        {k: m.cpu() for k, m in small.items()})
    if not (torch.equal(idx_c.cpu(), idx_h) and torch.equal(drop_c.cpu(), drop_h)):
        raise AssertionError("device_segment: card and CPU differ")
    log(f"device_segment card vs CPU: bit-identical, painted share "
        f"{(idx_h > 0).float().mean().item():.4f}")
    fine = torch.stack([masks_c[(layer, "printed_text")]
                        for layer in creation["keys_for_finegrained_segmentation"]])
    return fill_holes(dilate_cross(fine.reshape(-1, 256, 256)))


def drive_path(run: Path, save_to: Path, device_contours: bool = True, workers: int = 0,
               creation=None, extra=(), num_images=None) -> dict:
    """The dataset CLI on the card with `creation` (CREATION_CONFIG by
    default) and `extra` flags: build_dataset timed (warm kernels), then the
    train/val split and coco_gt.json."""
    from synthesis_in_style_tpu_torch.cli import create_dataset_for_segmentation as cds

    argv = [str(run / "checkpoints" / "g_ema.pt"), str(run / "creation_config.json"),
            "-n", str(num_images or NUM_IMAGES), "-b", str(BATCH), "--num-clusters",
            str(NUM_CLUSTERS), "-s", str(save_to), "-d", DEVICE, *extra]
    if device_contours:
        argv.append("--device-contours")
    if workers:
        argv += ["--contour-workers", str(workers)]
    args = cds.build_parser().parse_args(argv)
    _sync()
    t0 = time.perf_counter()
    written = cds.build_dataset(args, creation or CREATION_CONFIG)
    _sync()
    seconds = time.perf_counter() - t0
    args.only_create_train_val_split = True
    cds.main(args)
    return {"written": written, "seconds": seconds}


def stage_times(run: Path, save_to: Path) -> dict:
    """Per-batch wall time of each stage of the path, device work finished
    (synchronize) inside each stage: synthesis, segmentation (front half +
    back half + the transfer of palette indices), PNG writing. Mean of 3
    batches after one warm-up batch."""
    from synthesis_in_style_tpu_torch.cli import create_dataset_for_segmentation as cds
    from synthesis_in_style_tpu_torch.models.factory import load_generator
    from synthesis_in_style_tpu_torch.utils.dataset_creation import (
        build_latent_and_noise_generator,
        make_generate_fn,
        make_image,
        save_generated_images,
    )

    gen = load_generator(run / "checkpoints" / "g_ema.pt", CONFIG_256, device="cuda")
    generate = make_generate_fn(gen)
    seg = cds.get_dataset_segmenter(argparse.Namespace(num_clusters=NUM_CLUSTERS),
                                    CREATION_CONFIG, 256, run / "semantic_segmentation", "cuda")
    stream = build_latent_and_noise_generator({"batch_size": BATCH}, seed=2, device="cuda")
    totals = {"synthesis_s": 0.0, "segmentation_s": 0.0, "png_s": 0.0, "png_1thread_s": 0.0}
    for step in range(4):
        t0 = time.perf_counter()
        acts, images = generate(next(stream))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        labels, drops = seg.finish_segment_on_device(seg.begin_segment_on_device(acts))
        t2 = time.perf_counter()
        save_generated_images(make_image(images), labels, step * BATCH, save_to, 1000)
        t3 = time.perf_counter()
        with _one_png_thread():
            save_generated_images(make_image(images), labels, step * BATCH,
                                  save_to.with_name(save_to.name + "_1thread"), 1000)
        t4 = time.perf_counter()
        if step > 0:
            for key, dt in zip(totals, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                totals[key] += dt / 3
    return {**totals, "batch": BATCH, "png_threads": os.cpu_count()}


class _one_png_thread:
    """While active, the dataset path writes its PNGs in one thread (the
    encoder before the threaded writer), for a comparison in one run."""

    def __enter__(self):
        import functools

        from synthesis_in_style_tpu_torch.utils import dataset_creation, png

        dataset_creation.write_png_batch = functools.partial(png.write_png_batch,
                                                             num_threads=1)

    def __exit__(self, *exc):
        from synthesis_in_style_tpu_torch.utils import dataset_creation, png

        dataset_creation.write_png_batch = png.write_png_batch
        return False


HOST_ROUTE_IMAGES = 16  # the host route's -n (one batch; 32 before PR 17)


def host_route_phase(run: Path, root: Path, fns: dict) -> dict:
    """The dataset CLI without --device-contours (the host contour route):
    once measured with launch counts from 0 (the generator's two kernels
    must run, the CC kernel must not), once with --contour-workers 2 (the
    same label pixels), coco_gt.json decoded against the val labels; then
    the host route's stages timed per batch, and the host and device back
    halves on one batch of the path's own masks."""
    for fn in fns.values():
        fn.launches = 0
    path = drive_path(run, root / "generated_host", device_contours=False,
                      num_images=HOST_ROUTE_IMAGES)
    launches = {name: fn.launches for name, fn in fns.items()}
    for name in ("fused_bias_act", "fused_blur"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the host dataset route")
    if launches["segmented_cc"] != 0:
        raise AssertionError("the host dataset route launched the CC kernel")
    n = check_outputs(root / "generated_host", expected=HOST_ROUTE_IMAGES)
    annotations = check_coco_gt(root / "generated_host")
    workers = drive_path(run, root / "generated_host_workers", device_contours=False, workers=2,
                         num_images=HOST_ROUTE_IMAGES)
    same_files = compare_label_pngs(root / "generated_host", root / "generated_host_workers")
    stages, masks = host_stage_times(run, root / "host_stages")
    divergence = host_vs_device(run, masks)
    out = {**path, "images_per_s": path["written"] / path["seconds"], "launches": launches,
           "pngs": n, "coco_annotations": annotations, "workers2_seconds": workers["seconds"],
           "workers2_images_per_s": workers["written"] / workers["seconds"],
           "workers2_byte_identical_files": same_files, "stages": stages,
           "host_vs_device": divergence}
    log(f"host dataset route (no --device-contours, batch {BATCH}): {path['written']} images "
        f"in {path['seconds']:.3f} s = {out['images_per_s']:.2f} images/s; with "
        f"--contour-workers 2 {out['workers2_images_per_s']:.2f} images/s (worker start "
        f"included); launches {launches}")
    log(f"host route per batch of {BATCH}: " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items() if k != "batch"))
    return out


def check_coco_gt(save_to: Path) -> int:
    """coco_gt.json parses, names the val split's images, and every
    annotation's RLE decodes inside its class colour in that image's label
    half: on pixels of that colour, or pixels they enclose (an annotation
    is a filled external contour, so it covers its region's holes)."""
    from scipy import ndimage

    from synthesis_in_style_tpu_torch.evaluation.coco_gt import rle_area, rle_decode
    from synthesis_in_style_tpu_torch.utils.png import read_png
    from synthesis_in_style_tpu_torch.utils.segmentation_utils import parse_color

    coco = json.loads((save_to / "coco_gt.json").read_text())
    val = json.loads((save_to / "val.json").read_text())
    if [im["file_name"] for im in coco["images"]] != [e["file_name"] for e in val]:
        raise AssertionError("coco_gt.json does not list the val split")
    colors = {c["id"]: parse_color(c["color"]) for c in coco["categories"]}
    half = CONFIG_256["image_size"]
    labels = {im["id"]: read_png(save_to / im["file_name"])[:, half:] for im in coco["images"]}
    on_colour = total = 0
    for ann in coco["annotations"]:
        mask = rle_decode(ann["segmentation"]).astype(bool)
        if not mask.any() or rle_area(ann["segmentation"]) != ann["area"]:
            raise AssertionError(f"annotation {ann['id']}: empty or wrong area")
        cls = (labels[ann["image_id"]] == colors[ann["category_id"]]).all(axis=-1)
        outside = mask & ~ndimage.binary_fill_holes(cls)
        if outside.any() or not (mask & cls).any():
            raise AssertionError(f"annotation {ann['id']}: {int(outside.sum())} pixels outside "
                                 "its class colour")
        on_colour += int((mask & cls).sum())
        total += int(mask.sum())
    log(f"coco_gt.json: {len(coco['images'])} val images, {len(coco['annotations'])} "
        f"annotations, every RLE inside its class colour ({on_colour} of {total} pixels on "
        "it, the rest in the holes they enclose)")
    return len(coco["annotations"])


def compare_label_pngs(a: Path, b: Path) -> int:
    """The same PNG files in both directories with pixel-identical label
    halves; returns how many files are also byte-identical."""
    from synthesis_in_style_tpu_torch.utils.png import read_png

    names = sorted(p.relative_to(a) for p in a.glob("**/*.png"))
    if names != sorted(p.relative_to(b) for p in b.glob("**/*.png")):
        raise AssertionError(f"{a} and {b} hold different PNG files")
    same = 0
    for name in names:
        if (a / name).read_bytes() == (b / name).read_bytes():
            same += 1
        elif not (read_png(a / name)[:, CONFIG_256["image_size"]:]
                  == read_png(b / name)[:, CONFIG_256["image_size"]:]).all():
            raise AssertionError(f"{name}: labels differ between in-process and 2 workers")
    log(f"--contour-workers 2: {len(names)} pairs, labels identical, {same} files "
        "byte-identical")
    return same


def host_stage_times(run: Path, save_to: Path):
    """Per-batch wall time of each stage of the host route (mean of 2 warm
    batches after one warm-up): synthesis, masks (front half and their copy
    to the host), host half in process, host half in 2 worker processes
    (warm), PNG writing. Returns them and the last batch's host masks."""
    from synthesis_in_style_tpu_torch.cli import create_dataset_for_segmentation as cds
    from synthesis_in_style_tpu_torch.models.factory import load_generator
    from synthesis_in_style_tpu_torch.segmentation.contour_pool import ContourWorkerPool
    from synthesis_in_style_tpu_torch.utils.dataset_creation import (
        build_latent_and_noise_generator,
        make_generate_fn,
        make_image,
        save_generated_images,
    )

    size = CONFIG_256["image_size"]
    gen = load_generator(run / "checkpoints" / "g_ema.pt", CONFIG_256, device=DEVICE)
    generate = make_generate_fn(gen)
    seg = cds.get_dataset_segmenter(argparse.Namespace(num_clusters=NUM_CLUSTERS),
                                    CREATION_CONFIG, size, run / "semantic_segmentation", DEVICE)
    stream = build_latent_and_noise_generator(
        {"batch_size": BATCH, "latent_size": CONFIG_256["latent_size"]}, seed=2, device=DEVICE)
    keys = ("synthesis_s", "masks_s", "host_half_s", "host_half_2workers_s", "png_s")
    totals = dict.fromkeys(keys, 0.0)
    with ContourWorkerPool(seg, 2) as pool:
        for step in range(3):
            t0 = time.perf_counter()
            acts, images = generate(next(stream))
            _sync()
            t1 = time.perf_counter()
            masks = seg.finish_prepare(seg.begin_prepare(acts))
            t2 = time.perf_counter()
            labels, drops = seg.segment_prepared(
                {k: dict(v) for k, v in masks.items()}, BATCH)
            t3 = time.perf_counter()
            pool_labels, pool_drops = pool.segment_prepared(masks, BATCH)
            t4 = time.perf_counter()
            if not (pool_labels == labels).all() or sorted(pool_drops) != sorted(drops):
                raise AssertionError("host half: 2 workers and in process differ")
            save_generated_images(make_image(images), labels, step * BATCH, save_to, 1000)
            t5 = time.perf_counter()
            if step > 0:
                for key, dt in zip(keys, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
                    totals[key] += dt / 2
    return {**totals, "batch": BATCH}, masks


def host_vs_device(run: Path, masks: dict) -> dict:
    """The host and the device back half on the same batch of the path's
    masks: share of pixels whose colour differs (<= 3 %, the envelope the
    JAX package pins between its two routes) and both drop lists."""
    from synthesis_in_style_tpu_torch.cli import create_dataset_for_segmentation as cds
    from synthesis_in_style_tpu_torch.segmentation.device_segmenter import run_device_segment

    seg = cds.get_dataset_segmenter(argparse.Namespace(num_clusters=NUM_CLUSTERS),
                                    CREATION_CONFIG, CONFIG_256["image_size"],
                                    run / "semantic_segmentation", DEVICE)
    host, host_drops = seg.segment_prepared({k: dict(v) for k, v in masks.items()}, BATCH)
    device, device_drops = run_device_segment(seg, masks, BATCH)
    share = float((host != device).any(axis=-1).mean())
    out = {"pixels_differ": share, "host_drops": sorted(host_drops),
           "device_drops": sorted(device_drops),
           "host_painted": float((host != 0).any(axis=-1).mean()),
           "device_painted": float((device != 0).any(axis=-1).mean())}
    log(f"host vs device back half on one batch of the path's masks: {share:.6f} of pixels "
        f"differ (painted {out['host_painted']:.4f} / {out['device_painted']:.4f}); drops host "
        f"{out['host_drops']}, device {out['device_drops']}")
    if not share <= 0.03:
        raise AssertionError(f"host and device back halves differ on {share:.4%} of pixels")
    return out


def check_outputs(save_to: Path, size: int = 0, expected: int = 0) -> int:
    """The dataset path's [image | label] pairs (`size` px, CONFIG_256's by
    default; at least `expected`, NUM_IMAGES by default) and its train/val
    split."""
    from synthesis_in_style_tpu_torch.utils.png import read_png

    size = size or CONFIG_256["image_size"]
    expected = expected or NUM_IMAGES
    pngs = sorted(save_to.glob("**/*.png"))
    if len(pngs) < expected:
        raise AssertionError(f"{len(pngs)} PNGs written, expected >= {expected}")
    painted = 0
    for png in pngs:
        pair = read_png(png)
        if pair.shape != (size, 2 * size, 3):
            raise AssertionError(f"{png}: shape {pair.shape}")
        painted += int((pair[:, size:] != 0).any())
    split = json.loads((save_to / "train.json").read_text()) + \
        json.loads((save_to / "val.json").read_text())
    if len(split) != len(pngs):
        raise AssertionError("train/val split does not cover the PNGs")
    log(f"{len(pngs)} PNG pairs ({size}x{2 * size}), {painted} with painted labels, "
        f"{sum(e['has_printed_text'] for e in split)} has_printed_text")
    return len(pngs)


# ---------------------------------------------------------------------------
# training path


class GradRecorder:
    """Stands in for a GANOptimizer: keeps the gradients, moves nothing."""

    def __init__(self, module):
        self.names = [n for n, _ in module.named_parameters()]
        self.grads = {}

    def step(self, grads):
        self.grads = dict(zip(self.names, grads))


def check_training_iteration(detail, config=None) -> float:
    """Every step of one training iteration (D, R1, G, path length, EMA) of
    the full-width 256px G and D (`config`'s variant: StyleGAN2 by default,
    SWAGAN with SWAGAN_CONFIG) at batch 2, float32, TF32 off, with the same
    draws: the card's gradients of every parameter against the CPU's
    (plain versions), max abs difference <= 1e-3 x max|ref|, the largest
    reference gradient of the step.
    The D and G steps must reach every parameter, nonzero in every module."""
    import copy

    from synthesis_in_style_tpu_torch.models.factory import get_discriminator, get_generator
    from synthesis_in_style_tpu_torch.updaters.stylegan2_updater import (
        GANTrainState, StyleGAN2Config, d_reg_step, d_step, draw_mix, draw_path, ema_step,
        g_reg_step, g_step,
    )

    config = config or CONFIG_256
    size, variant = config["image_size"], config["stylegan_variant"]
    g = torch.Generator().manual_seed(SEED + 5)
    gen = get_generator(config).init_weights(g)
    disc = get_discriminator(config).init_weights(g)
    cfg = StyleGAN2Config(freeze_noise_layers=tuple(range(6)))
    real = torch.rand((2, size, size, 3), generator=g) * 2 - 1
    draws = {"d_step": draw_mix(g, gen, 2, cfg), "g_step": draw_mix(g, gen, 2, cfg),
             "g_reg_step": draw_path(g, gen, 2, cfg)}

    def to(mix, device):
        return type(mix)(mix.z1.to(device), mix.z2.to(device), mix.inject_index.to(device),
                         [n.to(device) for n in mix.noise])

    grads = {}
    for device in ("cuda", "cpu"):
        state = GANTrainState(copy.deepcopy(gen).to(device), copy.deepcopy(disc).to(device),
                              copy.deepcopy(gen).to(device).requires_grad_(False),
                              GradRecorder(gen), GradRecorder(disc), torch.zeros((), device=device))
        pl_mix, pl_noise = draws["g_reg_step"]
        metrics = {}
        metrics.update(d_step(state, cfg, real.to(device), to(draws["d_step"], device)))
        d_grads = state.d_optimizer.grads
        metrics.update(d_reg_step(state, cfg, real.to(device)))
        r1_grads = state.d_optimizer.grads
        metrics.update(g_step(state, cfg, to(draws["g_step"], device)))
        g_grads = state.g_optimizer.grads
        metrics.update(g_reg_step(state, cfg, to(pl_mix, device), pl_noise.to(device)))
        pl_grads = state.g_optimizer.grads
        ema_step(state, cfg)
        grads[device] = {"d_step": d_grads, "d_reg_step": r1_grads, "g_step": g_grads,
                         "g_reg_step": pl_grads}
        grads[device]["metrics"] = {k: float(v) for k, v in metrics.items()}
    # R1 in float64 on the card (the fused ops' plain versions): how far
    # each float32 run is from it
    state = GANTrainState(None, copy.deepcopy(disc).double().cuda(), None, None,
                          GradRecorder(disc), None)
    with _float64_on_card():
        d_reg_step(state, cfg, real.double().cuda())
    r1_float64 = {k: None if v is None else v.cpu() for k, v in state.d_optimizer.grads.items()}
    for step in ("d_step", "g_step"):  # these reach every parameter
        modules = {}
        for name, grad in grads["cuda"][step].items():
            if grad is None:
                raise AssertionError(f"{step}: no gradient for {name} on the card")
            module = ".".join(name.split(".")[:2])
            modules[module] = modules.get(module, False) or bool(grad.any())
        dead = sorted(m for m, live in modules.items() if not live)
        if dead:
            raise AssertionError(f"{step}: all-zero gradients on the card in {dead}")
    worst = 0.0
    tol = 1e-3
    for step in ("d_step", "d_reg_step", "g_step", "g_reg_step"):
        pairs = []
        for name, ref in grads["cpu"][step].items():
            got = grads["cuda"][step][name]
            if (ref is None) != (got is None):
                raise AssertionError(f"{step} {name}: gradient on one device only")
            if ref is not None:
                pairs.append((name, got.cpu(), ref))
        # max|ref| over the step's gradients: a parameter that barely moves
        # the loss (R1 through conv_in's bias: only via minibatch stddev)
        # has a gradient that is all rounding
        scale = max(ref.abs().max().item() for _, _, ref in pairs)
        errs = [((got - ref).abs().max().item(), name, ref) for name, got, ref in pairs]
        tensor_worst = 0.0
        for err, name, ref in errs:
            if not err <= tol * scale:
                raise AssertionError(f"{step} {name}: card vs CPU {err} > {tol} x {scale}")
            ref_max = ref.abs().max().item()
            tensor_worst = max(tensor_worst, err / ref_max if ref_max else 0.0)
        step_err, worst_name, _ = max(errs, key=lambda e: e[0])
        step_worst = step_err / scale
        row = {"variant": variant, "step": step, "max_err_over_max_ref": step_worst,
               "worst_tensor": worst_name, "worst_per_tensor_rel_err": tensor_worst,
               "tolerance": tol}
        if step == "d_reg_step":  # the same tensor, each float32 run against float64
            exact = r1_float64[worst_name]
            scale64 = max(v.abs().max().item() for v in r1_float64.values() if v is not None)
            row.update({f"{where}_vs_float64_over_max_ref":
                        (grads[device][step][worst_name].cpu().double() - exact).abs().max().item()
                        / scale64 for where, device in (("card", "cuda"), ("cpu", "cpu"))})
            row["worst_tensor_max_over_max_ref"] = exact.abs().max().item() / scale64
        detail.append(row)
        log(f"  {step}: card vs CPU {step_worst:.3g} of max|ref|, worst tensor {worst_name}" +
            "".join(f", {k} {v:.3g}" for k, v in row.items() if "float64" in k or "tensor_max" in k))
        worst = max(worst, step_worst)
    for key, ref in grads["cpu"]["metrics"].items():
        got = grads["cuda"]["metrics"][key]
        if not abs(got - ref) <= 1e-3 * max(1.0, abs(ref)):
            raise AssertionError(f"{key}: card {got} vs CPU {ref}")
    log(f"training iteration (variant {variant}) {size}px batch 2 card vs CPU: gradients max "
        f"rel err {worst:.3g}; metrics {grads['cuda']['metrics']}")
    return worst


TRAIN_CONFIG = Path(__file__).resolve().parent / "configs" / "stylegan" / "stylegan_256px.yaml"
TRAIN_OVERRIDES = {"batch_size": 16, "max_iter": 4, "snapshot_save_iter": 4}
TRAIN_WARMUP = {"max_iter": 2, "snapshot_save_iter": 2}  # iteration 0 runs R1 and path length
TRAIN_PAGES = 64


def write_training_pages(root: Path) -> Path:
    """64 synthetic 256px RGB pages (light background, dark strokes) from a
    seeded numpy generator, their train.json, and the shipped 256px config
    with the smoke's batch size and iteration counts, as JSON."""
    import numpy as np
    import yaml

    from synthesis_in_style_tpu_torch.utils.png import write_png

    data = root / "pages"
    data.mkdir()
    rs = np.random.default_rng(SEED)
    names = []
    for i in range(TRAIN_PAGES):
        page = np.full((256, 256, 3), 235, np.uint8) + rs.integers(0, 20, (256, 256, 1), np.uint8)
        for _ in range(12):  # text-like dark bars
            y, x = rs.integers(8, 240), rs.integers(8, 128)
            page[y:y + 4, x:x + rs.integers(32, 120)] = rs.integers(0, 80)
        write_png(data / f"page_{i:03d}.png", page)
        names.append(f"page_{i:03d}.png")
    (data / "train.json").write_text(json.dumps(names))
    config = {**yaml.safe_load(TRAIN_CONFIG.read_text()), **TRAIN_OVERRIDES}
    (data / "config.json").write_text(json.dumps(config))
    (data / "config_warmup.json").write_text(json.dumps({**config, **TRAIN_WARMUP}))
    return data


def run_training_cli(data: Path, log_dir: Path, config_name: str = "config.json"):
    """One run of the training CLI on the card with `data`/`config_name`."""
    from synthesis_in_style_tpu_torch.cli import train_stylegan_2 as cli

    argv = [str(data / config_name), "--images", str(data / "train.json"),
            "-l", str(log_dir), "-d", "cuda"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = cli.main(cli.resolve_log_dir(cli.build_parser().parse_args(argv)))
    torch.cuda.synchronize()
    return trainer, time.perf_counter() - t0


PORT_KERNELS = ("bias_act_fwd_kernel", "bias_act_bwd_kernel", "blur_tail_kernel",
                "cc_local_kernel", "cc_boundary_kernel", "cc_flatten_kernel",
                "flash_fwd_split_kernel", "flash_bwd_delta_kernel",
                "flash_bwd_dkdv_split_kernel", "flash_bwd_dq_split_kernel",
                "flash_fwd_wgmma_kernel", "flash_bwd_dkdv_mma_kernel", "flash_bwd_dq_mma_kernel")


def profile_call(fn, top: int = 12) -> dict:
    """fn() once under torch.profiler: its wall time, the device's busy
    share of it, the kernels with the most device time, and the port's own
    kernels wherever they rank."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    port = {}
    for e in kernels:
        for name in PORT_KERNELS:
            if name in e.key:
                calls, secs = port.get(name, (0, 0.0))
                port[name] = (calls + e.count, secs + e.self_device_time_total / 1e6)
    return {"wall_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall,
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "device_s": e.self_device_time_total / 1e6} for e in kernels[:top]],
            "port_kernels": {k: {"calls": c, "device_s": t} for k, (c, t) in port.items()}}


def profile_iteration(trainer, top: int = 12) -> dict:
    """Two more training iterations: the first fills the loader again, the
    second runs under torch.profiler (`profile_call`)."""
    updater = trainer.updater
    updater.update()
    out = {"iteration": updater.iteration, **profile_call(updater.update, top)}
    updater.iterators["images"].close()
    return out


def check_training_run(trainer, log_dir: Path) -> dict:
    """Finite losses, D and G moved from their seeded init, a snapshot whose
    g_ema loads through the dataset path's load_generator and renders."""
    from synthesis_in_style_tpu_torch.core.config import load_config_from_checkpoint
    from synthesis_in_style_tpu_torch.models.factory import (
        get_discriminator, get_generator, load_generator,
    )

    (run,) = (log_dir / "stylegan2").iterdir()
    log_lines = [json.loads(line) for line in (run / "log.jsonl").read_text().splitlines()]
    losses = {k: v for line in log_lines for k, v in line.items() if k.startswith("train/")}
    if not losses or not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"training losses not finite: {losses}")
    config = load_config_from_checkpoint(next((run / "checkpoints").glob("*.pt")))
    init = torch.Generator().manual_seed(int(config.get("seed", 0)))
    fresh_g = get_generator(config).init_weights(init)
    fresh_d = get_discriminator(config).init_weights(init)
    state = trainer.updater.state
    for name, fresh, trained in (("G", fresh_g, state.generator), ("D", fresh_d, state.discriminator)):
        moved = sum(not torch.equal(a, b.cpu())
                    for a, b in zip(fresh.parameters(), trained.parameters()))
        if moved == 0:
            raise AssertionError(f"{name}: no parameter moved")
        log(f"{name}: {moved} of {len(list(fresh.parameters()))} parameter tensors moved")
    snap = run / "checkpoints" / f"iter_{TRAIN_OVERRIDES['max_iter']:08d}.pt"
    gen = load_generator(snap, config, device="cuda")
    with torch.no_grad():
        image, _ = gen([torch.randn((1, 512), device="cuda")], randomize_noise=False)
    if image.shape != (1, 256, 256, 3) or not torch.isfinite(image).all():
        raise AssertionError(f"snapshot g_ema renders {tuple(image.shape)}, finite "
                             f"{bool(torch.isfinite(image).all())}")
    log(f"snapshot {snap.name}: g_ema loads through load_generator and renders a 256px image")
    return losses


# ---------------------------------------------------------------------------
# segmenter path: DocUFCN training on the dataset path's PNG pairs, then
# patch-tiled page inference whose small-region filter runs the CC kernel


REPO_ROOT = Path(__file__).resolve().parent
SEG_CONFIG = REPO_ROOT / "configs" / "segmenter" / "stylegan2_doc_ufcn_segmenter.yaml"
COLOR_MAP = REPO_ROOT / "configs" / "handwriting_colors.json"
SEG_OVERRIDES = {"max_iter": 8, "snapshot_save_iter": 8, "log_iter": 4}
PAGE_H, PAGE_W, NUM_PAGES = 1536, 2048, 4
SWEEP = {"min_confidence": ("0.0", "0.7"), "min_contour_area": ("0", "55")}
DEVICE = "cuda"  # the segmenter phase's device (its CPU rehearsal sets "cpu")


def _sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def write_segmenter_config(root: Path):
    """The shipped DocUFCN config (256px, batch 8, bfloat16) as JSON, with
    16 iterations and a snapshot at 16; returns (path, config)."""
    import yaml

    config = {**yaml.safe_load(SEG_CONFIG.read_text()), **SEG_OVERRIDES}
    path = root / "docufcn_config.json"
    path.write_text(json.dumps(config))
    return path, config


def run_segmenter_training(dataset: Path, config: Path, log_dir: Path):
    """The segmenter training CLI on the card over the dataset path's PNG
    pairs (train.json; one validation pass over val.json at the end)."""
    from synthesis_in_style_tpu_torch.cli import train as cli

    argv = [str(config), "--images", str(dataset / "train.json"),
            "--val-images", str(dataset / "val.json"), "--class-to-color-map", str(COLOR_MAP),
            "-l", str(log_dir), "-ln", "docufcn", "-d", DEVICE]
    args = cli.build_parser().parse_args(argv)
    args.log_dir = str(log_dir / "run")
    _sync()
    t0 = time.perf_counter()
    trainer = cli.main(args)
    _sync()
    return trainer, time.perf_counter() - t0


def check_segmenter_run(trainer, log_dir: Path, max_iter: int = 0) -> Path:
    """Finite losses, a validation pass in the log, parameters moved from
    the seeded init, and the snapshot at `max_iter` (SEG_OVERRIDES' by
    default); returns the snapshot's path."""
    run = log_dir / "run"
    lines = [json.loads(line) for line in (run / "log.jsonl").read_text().splitlines()]
    losses = [line["loss/softmax"] for line in lines if "loss/softmax" in line]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"segmenter losses not finite: {losses}")
    evals = [line for line in lines if "evaluation/dice_weighted_avg" in line]
    if len(evals) != 1:
        raise AssertionError(f"expected one validation pass, log has {len(evals)}")
    fresh = trainer.updater.network.__class__(num_classes=3).init_weights(
        torch.Generator().manual_seed(0))
    moved = sum(not torch.equal(a, b.cpu()) for a, b in
                zip(fresh.parameters(), trainer.updater.network.parameters()))
    name = type(fresh).__name__
    if moved == 0:
        raise AssertionError(f"{name}: no parameter moved")
    snap = run / "checkpoints" / f"iter_{max_iter or SEG_OVERRIDES['max_iter']:08d}.pt"
    if not snap.exists():
        raise AssertionError(f"no snapshot {snap}")
    log(f"{name}: {moved} of {len(list(fresh.parameters()))} parameter tensors moved; "
        f"losses {losses}; validation {evals[0]}")
    return snap


def check_doc_ufcn_card_vs_cpu(snap: Path, dataset: Path) -> float:
    """The trained full-width DocUFCN forward (eval) on the card against the
    CPU, TF32 off, on two validation patches: max abs diff <= 1e-3 x
    max|ref|."""
    from synthesis_in_style_tpu_torch.data.segmentation_dataset import SegmentationDataset
    from synthesis_in_style_tpu_torch.models.doc_ufcn import DocUFCN
    from synthesis_in_style_tpu_torch.utils.checkpoint import load_segmenter_snapshot

    data = SegmentationDataset(dataset / "val.json", COLOR_MAP, root=dataset, image_size=256)
    x = torch.stack([data[i]["images"] for i in range(2)]).permute(0, 3, 1, 2).contiguous()
    state = load_segmenter_snapshot(snap)["segmentation_network"]

    def logits(device):
        net = DocUFCN(num_classes=3)
        net.load_state_dict(state)
        with torch.no_grad():
            return net.to(device).eval()(x.to(device)).float().cpu()

    set_tf32(False)
    try:
        card, cpu = logits(DEVICE), logits("cpu")
    finally:
        set_tf32(True)
        torch.backends.cuda.matmul.allow_tf32 = False
    if not torch.isfinite(card).all():
        raise AssertionError("DocUFCN: non-finite logits on the card")
    rel = ((card - cpu).abs().max() / cpu.abs().max()).item()
    if not rel <= 1e-3:
        raise AssertionError(f"DocUFCN 256px card vs CPU: relative error {rel} > 1e-3")
    log(f"DocUFCN 256px (32/64/128/256) card vs CPU, float32, TF32 off: max relative error "
        f"{rel:.3g}")
    return rel


def draw_page(rs, page_h: int = 0, page_w: int = 0):
    """A synthetic page (light paper, lines of dark printed bars and
    thinner handwritten strokes, specks) and its colour ground truth, drawn
    from the numpy generator `rs`; PAGE_H x PAGE_W unless given."""
    import numpy as np

    page_h, page_w = page_h or PAGE_H, page_w or PAGE_W

    page = np.full((page_h, page_w, 3), 232, np.uint8) + \
        rs.integers(0, 16, (page_h, page_w, 1), np.uint8)
    mask = np.zeros((page_h, page_w, 3), np.uint8)
    for y in range(96, page_h - 96, 48):
        printed = rs.random() < 0.6
        x = int(rs.integers(80, 300))
        while x < page_w - 200:
            w = int(rs.integers(20, 120))
            h = 14 if printed else int(rs.integers(4, 10))
            dy = 0 if printed else int(rs.integers(-6, 7))
            page[y + dy:y + dy + h, x:x + w] = rs.integers(10, 70)
            mask[y + dy:y + dy + h, x:x + w] = (0, 0, 255) if printed else (255, 0, 0)
            x += w + int(rs.integers(8, 30))
    for _ in range(400):  # specks
        y, x = rs.integers(0, page_h - 3), rs.integers(0, page_w - 3)
        page[y:y + 2, x:x + 2] = rs.integers(20, 120)
    return page, mask


def write_pages(root: Path):
    """NUM_PAGES synthetic 2048x1536 pages (`draw_page`) and their colour
    ground truth, from a seeded numpy generator."""
    import numpy as np

    from synthesis_in_style_tpu_torch.utils.png import write_png

    pages, gt = root / "doc_pages", root / "doc_pages_gt"
    pages.mkdir()
    gt.mkdir()
    rs = np.random.default_rng(SEED + 7)
    for i in range(NUM_PAGES):
        page, mask = draw_page(rs)
        write_png(pages / f"page_{i}.png", page)
        write_png(gt / f"page_{i}_gt.png", mask)
    return pages, gt


def run_analyze(pages: Path, gt: Path, snap: Path, out: Path, sweep=SWEEP,
                device_filter: bool = True, extra=()) -> float:
    """The page inference CLI on the card (vote assembly; the device
    component filter, or the host contour filter without `device_filter`)
    over `pages`, every metric; returns its wall seconds."""
    from synthesis_in_style_tpu_torch.cli import analyze_image_segments as cli

    eval_config = out.parent / f"{out.name}_eval.json"
    eval_config.write_text(json.dumps({"checkpoint": str(snap),
                                       "class_to_color_map": str(COLOR_MAP)}))
    argv = [str(pages), "-f", str(eval_config), "-gt", str(gt), "-o", str(out),
            "-cds", "-cio", "-cpr", "-cre", "--min-confidence", *sweep["min_confidence"],
            "--min-contour-area", *sweep["min_contour_area"], "-d", DEVICE, *extra]
    if device_filter:
        argv.append("--use-device-component-filter")
    _sync()
    t0 = time.perf_counter()
    cli.main(cli.parse_and_check_arguments(argv))
    _sync()
    return time.perf_counter() - t0


def check_results(out: Path, sweep=SWEEP) -> dict:
    results = json.loads((out / "results.json").read_text())
    runs = results["runs"]
    want = len(sweep["min_confidence"]) * len(sweep["min_contour_area"])
    if len(runs) != want:
        raise AssertionError(f"results.json has {len(runs)} runs, expected {want}")
    scores = {}
    for run in runs:
        if len(run["confusion_matrices"]) != NUM_PAGES:
            raise AssertionError(f"run {run['hyperparams']}: {len(run['confusion_matrices'])} "
                                 f"pages evaluated")
        key = f"conf {run['hyperparams']['min_confidence']} area " \
              f"{run['hyperparams']['min_contour_area']}"
        scores[key] = {m: run[f"average_{m}_scores"]["weighted_avg"]["score"]
                       for m in ("dice", "iou", "precision", "recall")}
        if not all(0.0 <= v <= 1.0 for v in scores[key].values()):
            raise AssertionError(f"{key}: scores out of range {scores[key]}")
    log(f"results.json: {want} sweep runs x {NUM_PAGES} pages; weighted averages {scores}")
    return scores


def _page_segmenter(snap: Path, device: str, device_filter: bool = True):
    from synthesis_in_style_tpu_torch.segmentation.analysis_segmenter import (
        VotingAssemblySegmenter,
    )

    seg = VotingAssemblySegmenter(snap, COLOR_MAP, use_device_component_filter=device_filter,
                                  device=device)
    seg.set_hyperparams({"min_confidence": 0.7, "min_contour_area": 55})
    return seg


def page_path_numbers(snap: Path, pages: Path, detail) -> dict:
    """On the card, at min_confidence 0.7 and min_contour_area 55: pages/s
    of segment_image_classes over the pages (warm, ending in the class
    map's copy to the host), one page under torch.profiler, the CC kernel
    held bit for bit against its plain version on one batch's closed masks
    (the shape and content the page path gives it) and timed there, and one
    page card against CPU (`multi_class_page_parity`)."""
    from PIL import Image

    from synthesis_in_style_tpu_torch.segmentation import analysis_segmenter as pages_module
    from synthesis_in_style_tpu_torch.segmentation.device_cc import connected_components

    images = [Image.open(p).convert("RGB") for p in sorted(pages.glob("*.png"))]
    seg = _page_segmenter(snap, DEVICE)
    seg.segment_image_classes(images[0])
    _sync()
    t0 = time.perf_counter()
    for image in images:
        seg.segment_image_classes(image)
    seconds = time.perf_counter() - t0
    profile = profile_call(lambda: seg.segment_image_classes(images[0]))

    # the CC input of the page path: closed text masks of the first page's
    # batches at min_confidence 0.0 and 0.7, taken where the segmenter hands
    # them to filter_small_components; the batch whose foreground share is
    # nearest one half is held and timed
    captured = []
    original = pages_module.filter_small_components

    def capture(mask, min_area):
        captured.append(mask)
        return original(mask, min_area)

    pages_module.filter_small_components = capture
    try:
        for confidence in (0.0, 0.7):
            seg.set_hyperparams({"min_confidence": confidence})
            seg.segment_image_classes(images[0])
    finally:
        pages_module.filter_small_components = original
        seg.set_hyperparams({"min_confidence": 0.7})
    masks = min(captured, key=lambda m: abs(float(m.float().mean()) - 0.5))
    got = _no_sync(lambda: connected_components(masks, backend="kernel"))
    ref = connected_components(masks, backend="plain")
    if not torch.equal(got, ref):
        raise AssertionError("segmented_cc on the page path's masks: labels differ")
    own = torch.arange(masks[0].numel(), device=masks.device).view(masks.shape[1:])
    components = int((masks & (ref == own)).sum())  # roots: labelled with their own index
    cc = {"case": "page path masks (2 classes x 8 patches), connectivity 4",
          "shape": list(masks.shape), "max_abs_err": 0,
          "foreground_share": float(masks.float().mean()), "components": components,
          "ms": bench_ms(lambda: _no_sync(lambda: connected_components(
              masks, backend="kernel")), iters=50, warmup=2),
          "plain_ms": bench_ms(lambda: connected_components(masks, backend="plain"),
                               iters=2, warmup=1),
          **bound(masks.numel() * 5, masks.numel() * 4)}
    detail.append(cc)
    log(f"segmented_cc {cc}")

    parity = multi_class_page_parity(images[0])
    return {"pages": len(images), "seconds": seconds, "pages_per_s": len(images) / seconds,
            "profile": profile, "cc": cc, **parity}


PARITY_SEED = SEED + 11


def seeded_page_network(page) -> "torch.nn.Module":
    """A full-width DocUFCN (32/64/128/256, 3 classes) from a seeded
    torch.Generator whose class map is not one class: random init, running
    statistics set by one train-mode pass over (up to) 8 patches of the
    page, and
    the classifier scaled so its confidences pass 0.7 on the CPU."""
    import numpy as np

    from synthesis_in_style_tpu_torch.models.doc_ufcn import DocUFCN

    net = DocUFCN(num_classes=3, encoder_dropout=0.0, decoder_dropout=0.0)
    net.init_weights(torch.Generator().manual_seed(PARITY_SEED))
    arr = np.asarray(page.convert("RGB"), np.float32)
    corners = [(y, x) for y in range(0, arr.shape[0] - 255, 256)
               for x in range(0, arr.shape[1] - 255, 256)][:8]
    patches = torch.stack([torch.from_numpy(arr[y:y + 256, x:x + 256]) for y, x in corners])
    norms = [m for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in norms:
        m.momentum = 1.0  # the running statistics become this batch's
    with torch.no_grad():
        net.train()(((patches / 255.0 - 0.5) / 0.5).permute(0, 3, 1, 2))
        for m in norms:
            m.momentum = 0.1
        net.classifier.weight.mul_(PARITY_LOGIT_SCALE)
    return net.eval()


# on page 0 this gives class shares of 0.18 / 0.62 / 0.20 on the CPU at 0.7 / 55
PARITY_LOGIT_SCALE = 8.0


def multi_class_page_parity(page) -> dict:
    """One page (0.7 / 55, device filter) card against CPU with TF32 off,
    on `seeded_page_network`'s weights: two classes or more must each hold
    >= 1 % of the CPU's class map, then >= 99.9 % of class ids equal and
    >= 99.9 % of confidences within 1e-3."""
    from synthesis_in_style_tpu_torch.segmentation.analysis_segmenter import (
        VotingAssemblySegmenter,
    )

    net = seeded_page_network(page)

    def segment(device):
        seg = VotingAssemblySegmenter(
            None, COLOR_MAP, network=copy.deepcopy(net), device=device,
            config={"image_size": 256, "batch_size": SEG_OVERRIDES.get("batch_size", 8)},
            use_device_component_filter=True)
        seg.set_hyperparams({"min_confidence": 0.7, "min_contour_area": 55})
        return seg.segment_image(page)

    set_tf32(False)
    try:
        cpu = segment("cpu")
        shares = [float((cpu.argmax(-1) == k).mean()) for k in range(cpu.shape[-1])]
        if sum(share >= 0.01 for share in shares) < 2:
            raise AssertionError(f"parity network: class shares {shares}, need two >= 1 %")
        card = segment(DEVICE)
    finally:
        set_tf32(True)
        torch.backends.cuda.matmul.allow_tf32 = False
    # the class map is segment_image_classes' argmax (numpy's and torch's
    # both take the first maximum); a confidence may differ where the
    # threshold or the area filter cuts differently by a rounding
    agree = float((card.argmax(-1) == cpu.argmax(-1)).mean())
    close = float((abs(card - cpu).max(-1) <= 1e-3).mean())
    if not (agree >= 0.999 and close >= 0.999):
        raise AssertionError(f"page card vs CPU: {agree:.6f} of class ids and {close:.6f} of "
                             f"confidences (within 1e-3) agree")
    log(f"page {page.width}x{page.height} card vs CPU (TF32 off, seeded multi-class DocUFCN): "
        f"class shares {[round(v, 4) for v in shares]}; class map {agree:.6f} of pixels agree, "
        f"confidences within 1e-3 at {close:.6f} (max abs diff {float(abs(card - cpu).max()):.3g})")
    return {"card_vs_cpu_agreement": agree, "card_vs_cpu_confidences_within_1e-3": close,
            "card_vs_cpu_class_shares": shares}


def host_filter_numbers(snap: Path, pages: Path, root: Path) -> dict:
    """Pages/s of segment_image_classes at 0.7 / 55 with the host contour
    filter (warm), and one page through the analyze CLI with every drawing
    flag: its images exist and are not empty."""
    from PIL import Image

    images = [Image.open(p).convert("RGB") for p in sorted(pages.glob("*.png"))]
    seg = _page_segmenter(snap, DEVICE, device_filter=False)
    seg.segment_image_classes(images[0])
    _sync()
    t0 = time.perf_counter()
    for image in images:
        seg.segment_image_classes(image)
    seconds = time.perf_counter() - t0

    one = root / "one_page"
    one.mkdir()
    shutil.copy(sorted(pages.glob("*.png"))[0], one / "page_0.png")
    out = root / "analyze_vis"
    vis_seconds = run_analyze(one, pages.parent / "doc_pages_gt", snap, out,
                              {"min_confidence": ("0.7",), "min_contour_area": ("55",)},
                              device_filter=False, extra=VIS_FLAGS)
    files = {p.name: p.stat().st_size for p in out.glob("*.png")}
    stem = "page_0_min_confidence_0_7_min_contour_area_55_patch_overlap_0__0_0"
    for suffix in ("segmentation", "overlay", "bboxes"):
        if not files.get(f"{stem}_{suffix}.png"):
            raise AssertionError(f"-vis wrote no {stem}_{suffix}.png: {sorted(files)}")
    log(f"host contour filter: {len(images) / seconds:.3f} pages/s ({PAGE_W}x{PAGE_H}, "
        f"0.7 / 55, segment_image_classes, warm); -vis with every drawing flag on one page "
        f"in {vis_seconds:.3f} s wrote {len(files)} images")
    return {"pages": len(images), "seconds": seconds, "pages_per_s": len(images) / seconds,
            "vis_seconds": vis_seconds, "vis_files": len(files)}


VIS_FLAGS = ("-vis", "--extract-bboxes", "--draw-patches", "--draw-bboxes-on-segmentation",
             "--overlay-segmentation")


def _loader_pass(loader, n: int):
    """(seconds to the first batch of a new pass, images/s over up to n
    more batches, the first batch)."""
    t0 = time.perf_counter()
    batches = iter(loader)
    batch = next(batches)
    first_s = time.perf_counter() - t0
    n = min(n, len(loader) - 1)
    t0 = time.perf_counter()
    for _ in range(n):
        next(batches)
    return first_s, n * loader.batch_size / (time.perf_counter() - t0), batch


def segmenter_breakdown(trainer, top: int = 12) -> dict:
    """The two halves of a segmenter iteration, apart: the training loader
    alone (a pass after the run, whose workers start with it: seconds to
    its first batch, then images/s over up to 18 more batches; then a second
    pass on the same workers, kept), and the training step alone on one
    batch already on the card (10 synchronized steps, then one under
    torch.profiler)."""
    from synthesis_in_style_tpu_torch.data.loader import shutdown_workers
    from synthesis_in_style_tpu_torch.updaters.segmentation_updater import standard_train_step

    updater = trainer.updater
    loader = updater.iterators["images"]._loader
    n = 18
    first_s, loader_rate, batch = _loader_pass(loader, n)
    kept_first_s, kept_rate, _ = _loader_pass(loader, n)
    shutdown_workers(loader)
    n = min(n, len(loader) - 1)
    size = batch["images"].shape[0]
    on_card = {"images": batch["images"].to(updater.device).permute(0, 3, 1, 2),
               "segmented": batch["segmented"].to(updater.device)}

    def step():
        standard_train_step(updater.network, updater.optimizer, on_card, updater.class_weights,
                            updater.compute_dtype)

    step()
    _sync()
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    _sync()
    step_s = (time.perf_counter() - t0) / 10
    out = {"loader_first_batch_s": first_s, "loader_batches": n,
           "loader_images_per_s": loader_rate, "loader_kept_first_batch_s": kept_first_s,
           "loader_kept_images_per_s": kept_rate, "step_s": step_s,
           "step_images_per_s": size / step_s, "step_profile": profile_call(step, top)}
    log(f"segmenter iteration apart: loader first batch {first_s:.3f} s with its workers' "
        f"start, then {loader_rate:.2f} images/s over {n} batches; a second pass on the kept "
        f"workers {kept_first_s:.3f} s to its first batch, then {kept_rate:.2f} images/s; "
        f"step alone {step_s:.4f} s = {out['step_images_per_s']:.2f} images/s")
    return out


def segmenter_phase(root: Path, dataset: Path, fns: dict, cc_detail: list) -> dict:
    """DocUFCN training on `dataset`'s PNG pairs (warm-up run, then a
    measured run with launch counts from 0), then page inference with its
    snapshot (warm-up, then the measured sweep), then the page path's
    numbers; logs and returns them."""
    steps = Steps()
    seg_config, seg_settings = write_segmenter_config(root)
    run_segmenter_training(dataset, seg_config, root / "seg_warmup")
    steps.mark("training_warmup")
    for fn in fns.values():
        fn.launches = 0
    trainer, cli_seconds = run_segmenter_training(dataset, seg_config, root / "seg")
    launches = {name: fn.launches for name, fn in fns.items()}
    snap = check_segmenter_run(trainer, root / "seg")
    iters = trainer.updater.iteration
    steps.mark("training")
    breakdown = segmenter_breakdown(trainer)
    steps.mark("breakdown")
    doc_ufcn_rel = check_doc_ufcn_card_vs_cpu(snap, dataset)
    steps.mark("doc_ufcn_card_vs_cpu")
    pages, pages_gt = write_pages(root)
    run_analyze(pages, pages_gt, snap, root / "analyze_warmup",
                {"min_confidence": ("0.7",), "min_contour_area": ("55",)})
    for fn in fns.values():
        fn.launches = 0
    analyze_seconds = run_analyze(pages, pages_gt, snap, root / "analyze")
    page_launches = {name: fn.launches for name, fn in fns.items()}
    page_scores = check_results(root / "analyze")
    steps.mark("analyze")
    page = page_path_numbers(snap, pages, cc_detail)
    steps.mark("page_numbers")
    host_sweep = {"min_confidence": ("0.7",), "min_contour_area": ("55",)}
    for fn in fns.values():
        fn.launches = 0
    host_cli_seconds = run_analyze(pages, pages_gt, snap, root / "analyze_host", host_sweep,
                                   device_filter=False)
    host_launches = {name: fn.launches for name, fn in fns.items()}
    check_results(root / "analyze_host", host_sweep)
    host_page = host_filter_numbers(snap, pages, root)
    steps.mark("host_filter")

    batch = seg_settings["batch_size"]
    out = {"iterations": iters, "batch": batch, "loop_seconds": trainer.seconds,
           "cli_seconds": cli_seconds, "images_per_s": iters * batch / trainer.seconds,
           "launches": launches, **breakdown,
           "doc_ufcn_card_vs_cpu_rel_err": doc_ufcn_rel, "analyze_cli_seconds": analyze_seconds,
           "analyze_cli_pages": NUM_PAGES * len(SWEEP["min_confidence"])
           * len(SWEEP["min_contour_area"]),
           "page_launches": page_launches, "page_scores": page_scores, "page": page,
           "snapshot": str(snap), "pages": str(pages), "pages_gt": str(pages_gt),
           "host_filter_cli_seconds": host_cli_seconds, "host_filter_launches": host_launches,
           "host_filter": host_page, "seconds": steps.seconds}
    log(f"segmenter training path (DocUFCN 32/64/128/256, 256px, batch {batch}, bf16, "
        f"{iters} iterations): {out['images_per_s']:.2f} training images/s "
        f"(train loop {trainer.seconds:.3f} s incl. the validation pass, whole CLI "
        f"{cli_seconds:.3f} s, warm); launches {launches}")
    log(f"page inference path ({PAGE_W}x{PAGE_H}, patches 256, batch {batch}, vote "
        f"assembly, min_confidence 0.7, min_contour_area 55): {page['pages_per_s']:.3f} pages/s "
        f"(segment_image_classes, warm); analyze CLI {out['analyze_cli_pages']} page "
        f"passes in {analyze_seconds:.3f} s; launches {page_launches}")
    log(f"page inference with the host contour filter: {host_page['pages_per_s']:.3f} pages/s "
        f"against the device filter's {page['pages_per_s']:.3f}; analyze CLI {NUM_PAGES} page "
        f"passes in {host_cli_seconds:.3f} s; launches {host_launches}")
    for name, prof in (("segmenter training step", breakdown["step_profile"]),
                       ("page", page["profile"])):
        log(f"profiled {name}: wall {prof['wall_s']:.4f} s, device busy "
            f"{prof['device_busy_s']:.4f} s ({prof['device_busy_share']:.3f}); top kernels: " +
            "; ".join(f"{k['name']} x{k['calls']} {k['device_s']:.4f} s"
                      for k in prof["top_kernels"]))
    return out


# ---------------------------------------------------------------------------
# whole-page serving: the fused page program (one CUDA graph per page
# tiling), page batching (segment_images) and bfloat16 serving

SERVING_ROUNDS = 2  # timed passes over the pages per pages/s reading (16 pages)
# the analyze CLI's page counts for its steady-state rate: 1 and 2 of
# throughput mode's load chunks (4 x pages per batch), at one sweep setting
SERVING_CLI_PAGES = (4, 8)
# pixels whose float32 confidences' top two differ by at least this in log
# (the logit margin, where patches do not overlap) hold the bfloat16 gate
BF16_LOGIT_MARGIN = 4.0
SERVING_PAGES_PER_BATCH = 4
# (W, H): the phase's page size, its portrait, a smaller scan, A4 at 300 dpi,
# and one that shares the first one's 256-px bucket but not its tiling
MIXED_SIZES = ((2048, 1536), (1536, 2048), (1700, 1200), (2480, 3508), (2000, 1500))
MIXED_PAGES_PER_BATCH = 2
SERVING_MODES = ("unfused", "fused", "batched")


def _serving_segmenter(snap: Path, fused: bool, serving_dtype=None):
    """The segmenter the analyze CLI builds (vote assembly, device filter),
    at 0.7 / 55."""
    from synthesis_in_style_tpu_torch.segmentation.analysis_segmenter import (
        VotingAssemblySegmenter,
    )

    seg = VotingAssemblySegmenter(snap, COLOR_MAP, use_device_component_filter=True,
                                  fused_page_inference=fused, serving_dtype=serving_dtype,
                                  device=DEVICE)
    seg.set_hyperparams({"min_confidence": 0.7, "min_contour_area": 55})
    return seg


def _serve(seg, mode: str, images, output: str = "classes"):
    if mode == "batched":
        return seg.segment_images(images, SERVING_PAGES_PER_BATCH, output=output)
    if output == "classes":
        return [seg.segment_image_classes(image) for image in images]
    return [seg.segment_image(image) for image in images]


def _drop(seg) -> None:
    """Free a segmenter's graphs and their memory pools."""
    import gc

    seg._programs.clear()
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


def serving_rates(snap: Path, images) -> dict:
    """pages/s of the six serving modes at 0.7 / 55 (class maps to the
    host): unfused, fused one page per call, fused `segment_images` at
    SERVING_PAGES_PER_BATCH, each in float32 and bfloat16; one warm pass
    (it captures the graphs), then SERVING_ROUNDS timed passes (batched:
    one call over the pages SERVING_ROUNDS times, so that chunks overlap as
    in the CLI's chunks of 4 x pages_per_batch). One fused float32 page and
    one batched float32 call of SERVING_PAGES_PER_BATCH pages under
    torch.profiler."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        for mode in SERVING_MODES:
            seg = _serving_segmenter(snap, mode != "unfused", dtype)
            _sync()
            t0 = time.perf_counter()
            _serve(seg, mode, images)
            _sync()
            warm_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            if mode == "batched":  # one call, as the CLI makes: chunks in flight
                _serve(seg, mode, images * SERVING_ROUNDS)
            else:
                for _ in range(SERVING_ROUNDS):
                    _serve(seg, mode, images)
            _sync()
            seconds = time.perf_counter() - t0
            out[f"{mode}_{dtype}"] = {
                "pages_per_s": SERVING_ROUNDS * len(images) / seconds, "seconds": seconds,
                "first_pass_s": warm_s, "graphs": len(seg.page_programs())}
            if mode == "fused" and dtype == "float32":
                profile = profile_call(lambda: seg.segment_image_classes(images[0]))
            if mode == "batched" and dtype == "float32":
                batch_profile = profile_call(lambda: _serve(seg, mode, images))
                geometry = {"patch": seg.patch_size, "batch": seg.batch_size,
                            "patches_per_page": len(seg.calculate_bboxes_for_patches(
                                images[0].width, images[0].height))}
            _drop(seg)
    return {"modes": out, "profile": profile, "batch_profile": batch_profile,
            "geometry": geometry}


def confident_agreement(want, got, margin: float = BF16_LOGIT_MARGIN) -> tuple:
    """(share of pixels whose confidences in `want` have their top two at
    least `margin` apart in log, share of those pixels on which the class
    maps of `want` and `got` agree); (H, W, C) arrays."""
    import numpy as np

    top = np.sort(want, axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        gap = np.log(top[..., -1]) - np.log(top[..., -2])
    confident = gap >= margin
    same = want.argmax(-1) == got.argmax(-1)
    return float(confident.mean()), float(same[confident].mean()) if confident.any() else 0.0


def bf16_agreement(make_segmenter, images) -> dict:
    """bfloat16 serving against float32 (`make_segmenter(dtype)`), over
    `images`: the share of class-map pixels that agree at 0.0 / 0 and at
    0.7 / 55, and at 0.0 / 0 `confident_agreement` (the share of pixels
    with a float32 logit margin >= BF16_LOGIT_MARGIN, and the agreement on
    them)."""
    import numpy as np

    out = {}
    f32, bf16 = make_segmenter(None), make_segmenter("bfloat16")
    for confidence, area in ((0.0, 0), (0.7, 55)):
        for seg in (f32, bf16):
            seg.set_hyperparams({"min_confidence": confidence, "min_contour_area": area})
        if area == 0:
            pairs = [(f32.segment_image(image), bf16.segment_image(image)) for image in images]
            out[f"{confidence} / {area}"] = float(np.mean([
                (want.argmax(-1) == got.argmax(-1)).mean() for want, got in pairs]))
            confident = [confident_agreement(want, got) for want, got in pairs]
            out["confident_share"] = float(np.mean([c[0] for c in confident]))
            out["confident_agreement"] = float(np.mean([c[1] for c in confident]))
        else:
            out[f"{confidence} / {area}"] = float(np.mean([
                (f32.segment_image_classes(image) == bf16.segment_image_classes(image)).mean()
                for image in images]))
    _drop(f32)
    _drop(bf16)
    return out


def serving_parity(snap: Path, images, mixed) -> dict:
    """With TF32 off: fused against unfused confidences (within 1e-5, the
    JAX package's tolerance) and class maps; each graph replay against the
    eager body on the same inputs (pages the graph was not captured on: it
    was captured on zeros); the first again on one page with
    `seeded_page_network`, whose class map holds two classes or more;
    bfloat16 against float32 class maps on both networks (`bf16_agreement`:
    the trained snapshot's >= 0.99 at 0.0 / 0, the JAX package's gate and
    setting; the seeded network's >= 0.99 on its confident pixels, a
    quarter of the page or more; the rest reported); the mixed-size set served with
    bucket_quantum 0, None and page by page (within 1e-5), with the graphs
    each way."""
    import numpy as np

    set_tf32(False)
    try:
        unfused, fused = _serving_segmenter(snap, False), _serving_segmenter(snap, True)
        fused_diff, class_agree, replay_diff = 0.0, [], 0.0
        for image in images:
            want, got = unfused.segment_image(image), fused.segment_image(image)
            fused_diff = max(fused_diff, float(np.abs(want - got).max()))
            # the one-page probs program (segment_image's)
            program = fused._programs[next(key for key in fused._programs
                                           if key[-2:] == (1, "probs"))]
            if program._graph is not None:
                eager = program._body(*program._inputs())
                replay_diff = max(replay_diff, float((eager - program.output).abs().max()))
            class_agree.append(float(
                (fused.segment_image_classes(image) == want.argmax(-1)).mean()))
        _drop(unfused)
        _drop(fused)

        # the same on a network whose class map is not one class
        net = seeded_page_network(images[0])

        def seeded(fused, serving_dtype=None):
            from synthesis_in_style_tpu_torch.segmentation.analysis_segmenter import (
                VotingAssemblySegmenter,
            )

            seg = VotingAssemblySegmenter(
                None, COLOR_MAP, network=copy.deepcopy(net), device=DEVICE,
                config={"image_size": 256, "batch_size": SEG_OVERRIDES.get("batch_size", 8)},
                use_device_component_filter=True, fused_page_inference=fused,
                serving_dtype=serving_dtype)
            seg.set_hyperparams({"min_confidence": 0.7, "min_contour_area": 55})
            return seg

        want = seeded(False).segment_image(images[0])
        got = seeded(True).segment_image(images[0])
        seeded_diff = float(np.abs(want - got).max())
        seeded_shares = [float((want.argmax(-1) == k).mean()) for k in range(want.shape[-1])]
        bf16_agree = {
            "trained": bf16_agreement(lambda dtype: _serving_segmenter(snap, True, dtype), images),
            "seeded": bf16_agreement(lambda dtype: seeded(True, dtype), images[:1])}

        mixed_out, graphs = {}, {}
        for way, bucket in (("bucket_0", 0), ("bucket_none", None), ("pages", "pages")):
            seg = _serving_segmenter(snap, True)
            if bucket == "pages":
                mixed_out[way] = [seg.segment_image(image) for image in mixed]
            else:
                mixed_out[way] = seg.segment_images(mixed, MIXED_PAGES_PER_BATCH,
                                                    bucket_quantum=bucket)
            graphs[way] = len(seg.page_programs())
            _drop(seg)
        mixed_diff = {way: max(float(np.abs(a - b).max()) for a, b in
                               zip(mixed_out[way], mixed_out["pages"]))
                      for way in ("bucket_0", "bucket_none")}
    finally:
        set_tf32(True)
        torch.backends.cuda.matmul.allow_tf32 = False
    out = {"fused_vs_unfused_max_abs": fused_diff, "fused_vs_unfused_class_agreement": class_agree,
           "replay_vs_eager_max_abs": replay_diff, "bf16_vs_f32_class_agreement": bf16_agree,
           "seeded_fused_vs_unfused_max_abs": seeded_diff, "seeded_class_shares": seeded_shares,
           "mixed_sizes": [list(size) for size in MIXED_SIZES],
           "mixed_vs_pages_max_abs": mixed_diff, "mixed_graphs": graphs}
    if not fused_diff <= 1e-5 or min(class_agree) < 0.999 or not seeded_diff <= 1e-5:
        raise AssertionError(f"fused vs unfused: max abs {fused_diff} (seeded network "
                             f"{seeded_diff}), class maps {class_agree}")
    if sum(share >= 0.01 for share in seeded_shares) < 2:
        raise AssertionError(f"seeded network: class shares {seeded_shares}, need two >= 1 %")
    if not replay_diff <= 1e-5:
        raise AssertionError(f"graph replay vs eager body: max abs {replay_diff}")
    # the JAX package's gate, on a fitted network at 0.0 / 0
    # (tests/test_quantized_docufcn.py), holds the trained snapshot. On the
    # seeded network bfloat16 moves the logits by ~14 % (the JAX package's
    # own bfloat16 by ~15 %, and its class maps agree on < 0.99 of pixels:
    # tests/test_torch_serving_dtype.py), so there the gate holds the
    # pixels with a float32 logit margin >= BF16_LOGIT_MARGIN, which must
    # be a quarter of the page or more
    seeded_bf16 = bf16_agree["seeded"]
    if not (bf16_agree["trained"]["0.0 / 0"] >= 0.99 and seeded_bf16["confident_share"] >= 0.25
            and seeded_bf16["confident_agreement"] >= 0.99):
        raise AssertionError(f"bfloat16 vs float32 class maps agree on {bf16_agree}")
    if not max(mixed_diff.values()) <= 1e-5:
        raise AssertionError(f"mixed sizes: bucketed vs page by page {mixed_diff}")
    if not graphs["bucket_0"] < graphs["bucket_none"] == graphs["pages"] == len(MIXED_SIZES):
        raise AssertionError(f"mixed sizes: graphs {graphs}")
    return out


def _reserved_bytes() -> int:
    """Device memory the caching allocator holds after returning what no
    tensor or graph uses (0 on the CPU)."""
    if DEVICE != "cuda":
        return 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def serving_sweep(snap: Path, images) -> dict:
    """One fused segmenter: a page and a batch at area 0 and at 55 (the
    structural graphs), then the sweep 0.0 / 0.7 x 0 / 55 over every page,
    one by one and batched: no new graph. CC labellings per page at 55
    from the replays x the labellings each capture recorded, which must be
    what the wrapper's count of launches gained in the sweep."""
    from synthesis_in_style_tpu_torch.ops.cuda.segmented_cc import connected_components_cuda

    reserved = _reserved_bytes()
    seg = _serving_segmenter(snap, True)
    for area in (0, 55):
        seg.set_hyperparams({"min_confidence": 0.7, "min_contour_area": area})
        _serve(seg, "fused", images[:1])
        _serve(seg, "batched", images)
    structural = seg.page_programs()
    # what the 4 graphs keep: their private pools (and the static buffers)
    pool_bytes = _reserved_bytes() - reserved
    replays_before = [p.replays for p in structural]
    launches_before = connected_components_cuda.launches
    for confidence in (0.0, 0.7):
        for area in (0, 55):
            seg.set_hyperparams({"min_confidence": confidence, "min_contour_area": area})
            _serve(seg, "fused", images)
            _serve(seg, "batched", images)
    if seg.page_programs() != structural:
        raise AssertionError(f"the sweep captured {len(seg.page_programs()) - len(structural)} "
                             "new graphs")
    labellings = sum((p.replays - r) * p.cc_labellings_per_replay
                     for p, r in zip(structural, replays_before))
    counted = connected_components_cuda.launches - launches_before
    if counted != labellings:
        raise AssertionError(f"the CC wrapper counted {counted} launches in the sweep's "
                             f"replays, which ran {labellings} labellings")
    # the sweep served each page twice (one by one, batched) at each of the
    # two areas of 55
    per_page = labellings / (2 * 2 * len(images))
    single = [p for key, p in seg._programs.items()
              if key[-2] == 1 and p.cc_labellings_per_replay]
    out = {"graphs": len(structural), "sweep_settings": 4,
           "cc_labellings_per_replay": [p.cc_labellings_per_replay for p in structural],
           "replays": [p.replays for p in structural], "cc_labellings": labellings,
           "cc_labellings_per_page": per_page,
           "cc_labellings_per_single_page_replay": [p.cc_labellings_per_replay for p in single],
           "graph_pool_bytes": pool_bytes}
    _drop(seg)
    if DEVICE == "cuda" and not per_page > 0:
        raise AssertionError(f"no CC labelling inside the fused page graphs: {out}")
    return out


def serving_cli_rates(root: Path, snap: Path, pages: Path, pages_gt: Path) -> dict:
    """The analyze CLI at 0.7 / 55, unfused and in throughput mode, over
    each of SERVING_CLI_PAGES pages (the phase's pages again and again,
    linked): each run's wall seconds, and the steady-state pages/s from the
    difference of the two, which leaves out what a run pays once (loading
    the snapshot, cuDNN's warm-up, each graph's capture)."""
    setting = {"min_confidence": ("0.7",), "min_contour_area": ("55",)}
    sources = sorted(pages.glob("*.png"))
    modes = {"unfused": (), "throughput": ("--fused-page-inference", "--pages-per-batch",
                                           str(SERVING_PAGES_PER_BATCH))}
    out = {mode: {} for mode in modes}
    for n in SERVING_CLI_PAGES:
        many, many_gt = root / f"cli_pages_{n}", root / f"cli_pages_{n}_gt"
        many.mkdir()
        many_gt.mkdir()
        for k in range(n):
            source = sources[k % len(sources)]
            (many / f"page_{k}.png").symlink_to(source)
            (many_gt / f"page_{k}_gt.png").symlink_to(pages_gt / f"{source.stem}_gt.png")
        for mode, extra in modes.items():
            out[mode][f"{n}_pages_s"] = run_analyze(many, many_gt, snap, root / f"cli_{mode}_{n}",
                                                    setting, extra=extra)
    low, high = SERVING_CLI_PAGES
    for times in out.values():
        times["steady_pages_per_s"] = (high - low) / (times[f"{high}_pages_s"]
                                                      - times[f"{low}_pages_s"])
    return out


def serving_phase(root: Path, snap: Path, pages: Path, pages_gt: Path, fns: dict) -> dict:
    """The serving modes on the segmenter phase's DocUFCN snapshot and
    pages: rates, parity, the sweep, then the analyze CLI in throughput mode
    (launch counts from 0; its confusion matrices against the unfused
    CLI's results.json of the segmenter phase) and both CLI modes' rates
    (`serving_cli_rates`)."""
    import numpy as np
    from PIL import Image

    images = [Image.open(p).convert("RGB") for p in sorted(pages.glob("*.png"))]
    rs = np.random.default_rng(SEED + 13)
    mixed = [Image.fromarray(draw_page(rs, h, w)[0]) for w, h in MIXED_SIZES]
    reserved_at_start = _reserved_bytes()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    steps = Steps()
    rates = serving_rates(snap, images)
    steps.mark("rates")
    parity = serving_parity(snap, images, mixed)
    steps.mark("parity")
    sweep = serving_sweep(snap, images)
    steps.mark("sweep")

    for fn in fns.values():
        fn.launches = 0
    cli_s = run_analyze(pages, pages_gt, snap, root / "analyze_fused",
                        extra=("--fused-page-inference", "--pages-per-batch",
                               str(SERVING_PAGES_PER_BATCH)))
    cli_launches = {name: fn.launches for name, fn in fns.items()}
    check_results(root / "analyze_fused")
    # the class output takes the argmax of the summed votes, the unfused
    # path of the normalized ones (as in the JAX package): a pixel whose top
    # two votes lie within a rounding of each other may go either way
    fused_runs = json.loads((root / "analyze_fused" / "results.json").read_text())["runs"]
    unfused_runs = json.loads((root / "analyze" / "results.json").read_text())["runs"]
    differing = [sum(abs(x - y) for x, y in zip(a["confusion_matrices"][page],
                                                b["confusion_matrices"][page])) / 2
                 for a, b in zip(fused_runs, unfused_runs) for page in b["confusion_matrices"]]
    if max(differing) > 1e-6 * PAGE_H * PAGE_W:
        raise AssertionError(f"throughput CLI: pixels counted differently from the unfused "
                             f"CLI's confusion matrices, per page and setting: {differing}")
    steps.mark("cli_throughput")
    cli_rates = serving_cli_rates(root, snap, pages, pages_gt)
    steps.mark("cli_rates")
    memory = ({"reserved_at_start_bytes": reserved_at_start,
               "max_reserved_bytes": torch.cuda.max_memory_reserved(),
               "max_allocated_bytes": torch.cuda.max_memory_allocated(),
               "sweep_graph_pool_bytes": sweep["graph_pool_bytes"]}
              if DEVICE == "cuda" else {})

    out = {"rates": rates, "parity": parity, "sweep": sweep, "cli_seconds": cli_s,
           "cli_page_passes": NUM_PAGES * len(SWEEP["min_confidence"])
           * len(SWEEP["min_contour_area"]), "cli_launches": cli_launches,
           "cli_pixels_counted_differently": differing, "cli_rates": cli_rates,
           "memory": memory, "seconds": steps.seconds}
    geometry = rates["geometry"]
    log(f"serving ({PAGE_W}x{PAGE_H}, DocUFCN 32/64/128/256, patches {geometry['patch']}, "
        f"batch {geometry['batch']}, {geometry['patches_per_page']} patches a page, vote "
        f"assembly, 0.7 / 55, class maps to the host, {SERVING_ROUNDS} x {len(images)} pages "
        f"warm): " + "; ".join(
            f"{k} {v['pages_per_s']:.3f} pages/s ({v['graphs']} graphs, first pass "
            f"{v['first_pass_s']:.3f} s)" for k, v in rates["modes"].items()))
    for name, prof in (("fused page", rates["profile"]),
                       (f"batched call of {len(images)} pages", rates["batch_profile"])):
        log(f"profiled {name}: wall {prof['wall_s']:.4f} s, device busy "
            f"{prof['device_busy_s']:.4f} s ({prof['device_busy_share']:.3f}); top kernels: " +
            "; ".join(f"{k['name']} x{k['calls']} {k['device_s']:.4f} s"
                      for k in prof["top_kernels"]))
    log(f"serving parity (TF32 off): fused vs unfused max abs {parity['fused_vs_unfused_max_abs']:.3g}"
        f", class maps {parity['fused_vs_unfused_class_agreement']}; graph replay vs eager body "
        f"max abs {parity['replay_vs_eager_max_abs']:.3g}; seeded multi-class network (shares "
        f"{[round(v, 4) for v in parity['seeded_class_shares']]}): fused vs unfused max abs "
        f"{parity['seeded_fused_vs_unfused_max_abs']:.3g}; bfloat16 vs float32 class maps "
        f"(fused) {parity['bf16_vs_f32_class_agreement']}; mixed sizes {MIXED_SIZES} (W, H) "
        f"bucketed vs page by page {parity['mixed_vs_pages_max_abs']}, graphs "
        f"{parity['mixed_graphs']}")
    log(f"serving sweep 0.0 / 0.7 x 0 / 55: {sweep['graphs']} structural graphs, none new; "
        f"CC labellings {sweep['cc_labellings']} through replays = "
        f"{sweep['cc_labellings_per_page']:.2f} per page at area 55 (per replay "
        f"{sweep['cc_labellings_per_replay']}, replays {sweep['replays']})")
    log(f"analyze CLI in throughput mode (--fused-page-inference --pages-per-batch "
        f"{SERVING_PAGES_PER_BATCH}): {out['cli_page_passes']} page passes in {cli_s:.3f} s; "
        f"pixels its confusion matrices count differently from the unfused CLI's, per page "
        f"and setting: {differing}; launches (eager warm-ups and graph replays) "
        f"{cli_launches}; memory {memory}")
    low, high = SERVING_CLI_PAGES
    log(f"analyze CLI at 0.7 / 55 over {low} and {high} pages: " + "; ".join(
        f"{mode} {t[f'{low}_pages_s']:.3f} s and {t[f'{high}_pages_s']:.3f} s, steady state "
        f"{t['steady_pages_per_s']:.3f} pages/s" for mode, t in cli_rates.items()))
    return out


# ---------------------------------------------------------------------------
# cluster discovery: create_semantic_segmentation, the k-means fit card vs
# CPU, select_cluster_config and auto_label_clusters

DISCOVERY_SAMPLES = 20  # the CLI's -n (its default 100 cut for time) and -b
DISCOVERY_BATCH = 10
DISCOVERY_RANGE = (6, 9)  # -c 6 9: k = 6, 7, 8
DISCOVERY_WARMUP = ("-n", "10", "-c", "6", "7")
FIT_LAYER = "8"  # 64px, 512 channels
SELECT_KS = ("6", "7", "8")
SELECT_SAMPLES, SELECT_BATCH = 32, 8
STATS_LAYER, STATS_K = "12", 8  # 256px, 128 channels


def _discovery_sizes(sizes=None) -> tuple:
    """(-n, -b, (first k, last k + 1)) of the discovery CLI: `sizes`, or
    DISCOVERY_SAMPLES, DISCOVERY_BATCH and DISCOVERY_RANGE."""
    return sizes or (DISCOVERY_SAMPLES, DISCOVERY_BATCH, DISCOVERY_RANGE)


def run_discovery(run: Path, destination: str, extra=(), sizes=None) -> dict:
    """The discovery CLI on DEVICE at `sizes` (`_discovery_sizes`), timed
    end to end; its summary, with each fit's report under "fits"."""
    from synthesis_in_style_tpu_torch.cli import create_semantic_segmentation as css

    samples, batch, ks = _discovery_sizes(sizes)
    argv = [str(run / "checkpoints" / "g_ema.pt"), "-n", str(samples),
            "-b", str(batch), "-c", *map(str, ks),
            "--destination", destination, "-d", DEVICE, *extra]
    _sync()
    t0 = time.perf_counter()
    fits = []
    report = css.main(css.build_parser().parse_args(argv), fits)
    _sync()
    return {**report, "fits": fits, "cli_s": time.perf_counter() - t0}


def check_discovery_artifacts(sem: Path, num_layers: int, size: int = 0,
                              sizes=None) -> dict:
    """catalogs/<k>.npz hold `num_layers` unit-norm centres_ arrays with
    matching counts_; cluster_labels (int32 NHW), cluster_arrays (uint8
    NCHW) and cluster_images/<k>.png have the JAX CLI's shapes (images of
    `size` px, CONFIG_256's by default; `sizes` as for run_discovery)."""
    import numpy as np
    from PIL import Image

    size = size or CONFIG_256["image_size"]
    n, _, ks = _discovery_sizes(sizes)
    shapes = {}
    for k in range(*ks):
        with np.load(sem / "catalogs" / f"{k}.npz") as cat, \
                np.load(sem / "cluster_labels" / f"{k}.npz") as labels, \
                np.load(sem / "cluster_arrays" / f"{k}.npz") as arrays:
            layers = [name[len("centers_"):] for name in cat.files if name.startswith("centers_")]
            if len(layers) != num_layers or sorted(cat.files) != sorted(
                    [f"centers_{l}" for l in layers] + [f"counts_{l}" for l in layers]):
                raise AssertionError(f"catalogs/{k}.npz holds {cat.files}")
            if labels.files != layers or arrays.files != layers:
                raise AssertionError(f"k={k}: layers {labels.files} / {arrays.files} / {layers}")
            for layer in layers:
                centers, counts = cat[f"centers_{layer}"], cat[f"counts_{layer}"]
                norms = np.linalg.norm(centers, axis=1)
                if centers.shape[0] != k or counts.shape != (k,) or \
                        not np.allclose(norms, 1.0, atol=1e-4):
                    raise AssertionError(f"k={k} layer {layer}: centres {centers.shape}, counts "
                                         f"{counts.shape}, norms {norms}")
                lab, arr = labels[layer], arrays[layer]
                h = lab.shape[1]
                if lab.dtype != np.int32 or lab.shape != (n, h, h) or lab.max() >= k or \
                        arr.dtype != np.uint8 or arr.shape != (n, 3, h, h):
                    raise AssertionError(f"k={k} layer {layer}: labels {lab.dtype} {lab.shape}, "
                                         f"arrays {arr.dtype} {arr.shape}")
                shapes[layer] = (h, centers.shape[1])
        with Image.open(sem / "cluster_images" / f"{k}.png") as png:
            if png.size != (n * size, (num_layers + 1) * size) or png.mode != "RGB":
                raise AssertionError(f"cluster_images/{k}.png: {png.size} {png.mode}")
    return shapes


def _layer_activations(run: Path, layer: str) -> torch.Tensor:
    """(DISCOVERY_SAMPLES * h * w, C) activations of one layer on DEVICE,
    from the run's generator and its own seeded z stream."""
    from synthesis_in_style_tpu_torch.models.factory import load_generator
    from synthesis_in_style_tpu_torch.utils.dataset_creation import (
        build_latent_and_noise_generator,
        make_generate_fn,
    )

    gen = load_generator(run / "checkpoints" / "g_ema.pt", CONFIG_256, device=DEVICE)
    generate = make_generate_fn(gen)
    stream = build_latent_and_noise_generator({**CONFIG_256, "batch_size": DISCOVERY_BATCH},
                                              seed=SEED + 5, device=DEVICE)
    acts = [generate(next(stream))[0][int(layer)]
            for _ in range(DISCOVERY_SAMPLES // DISCOVERY_BATCH)]
    x = torch.cat(acts)
    return x.reshape(-1, x.shape[-1])


def fit_card_vs_cpu(run: Path, k: int = 8) -> dict:
    """One layer fitted on the card and on the CPU with the same seed (TF32
    off): equal n_steps_, >= 99.9 % of nearest-centre labels equal, centres
    within 1e-3 cosine; then one epoch on the card with every host sync an
    error."""
    from synthesis_in_style_tpu_torch.segmentation import kmeans

    torch.backends.cuda.matmul.allow_tf32 = False
    x = _layer_activations(run, FIT_LAYER)
    x_cpu = x.cpu()
    fits, seconds = {}, {}
    for name, data in (("card", x), ("cpu", x_cpu)):
        _sync()
        t0 = time.perf_counter()
        fits[name] = kmeans.MiniBatchSphericalKMeans(k, seed=SEED).fit(data)
        seconds[name] = time.perf_counter() - t0
    card, cpu = fits["card"], fits["cpu"]
    if card.n_steps_ != cpu.n_steps_:
        raise AssertionError(f"fit steps: card {card.n_steps_}, CPU {cpu.n_steps_}")
    agree = (card.predict(x).cpu() == cpu.predict(x_cpu)).double().mean().item()
    cosine = (card.cluster_centers_ * cpu.cluster_centers_).sum(axis=1).min()
    if agree < 0.999 or cosine < 1.0 - 1e-3:
        raise AssertionError(f"fit card vs CPU: labels {agree:.6f} equal, min centre cosine "
                             f"{cosine:.6f}")

    # one epoch, draws moved to the card beforehand, under the sync check
    bs = min(card.batch_size, x.shape[0])
    steps = -(-x.shape[0] // bs)
    g = torch.Generator().manual_seed(SEED)
    perm = kmeans._permutation(x.shape[0], g)
    perm = torch.cat([perm, perm[: steps * bs - x.shape[0]]]).to(x.device)
    new_idx = kmeans._reassignment_draws(steps, bs, k, g).to(x.device)
    centers = torch.as_tensor(card.cluster_centers_, device=x.device)
    counts = torch.zeros(k, device=x.device)
    _sync()
    t0 = time.perf_counter()
    _no_sync(lambda: kmeans._fit_epoch(x, perm, centers, counts, new_idx, 0, 0.01, bs=bs,
                                       reassign_every=10))
    _sync()
    epoch_s = time.perf_counter() - t0
    # the same epoch once more under the profiler: the device's busy share
    prof = profile_call(lambda: kmeans._fit_epoch(x, perm, centers, counts, new_idx, 0, 0.01,
                                                  bs=bs, reassign_every=10), top=6)
    out = {"layer": FIT_LAYER, "k": k, "points": int(x.shape[0]), "dim": int(x.shape[1]),
           "n_steps": card.n_steps_, "labels_equal": agree, "min_centre_cosine": float(cosine),
           "card_fit_s": seconds["card"], "cpu_fit_s": seconds["cpu"],
           "no_sync_epoch_steps": steps, "no_sync_epoch_s": epoch_s,
           "no_sync_epoch_ms_per_step": epoch_s / steps * 1e3, "epoch_profile": prof}
    log(f"k-means fit card vs CPU (layer {FIT_LAYER}, {out['points']} x {out['dim']}, k={k}): "
        f"{card.n_steps_} steps on both, labels {agree:.6f} equal, min centre cosine "
        f"{cosine:.7f}; card {seconds['card']:.3f} s, CPU {seconds['cpu']:.3f} s; one epoch of "
        f"{steps} steps with no host sync {epoch_s:.3f} s; profiled: wall {prof['wall_s']:.4f} s, "
        f"device busy {prof['device_busy_s']:.4f} s ({prof['device_busy_share']:.3f}); top "
        "kernels: " + "; ".join(f"{t['name']} x{t['calls']} {t['device_s']:.4f} s"
                                for t in prof["top_kernels"]))
    return out


def run_selection(run: Path, sem: Path) -> dict:
    """select_cluster_config and auto_label_clusters on DEVICE (appearance
    mode); every output exists and parses."""
    import numpy as np

    from synthesis_in_style_tpu_torch.scripts import auto_label_clusters
    from synthesis_in_style_tpu_torch.scripts import select_cluster_config as scc

    ckpt = str(run / "checkpoints" / "g_ema.pt")
    _sync()
    t0 = time.perf_counter()
    scc.main([ckpt, str(sem), "--ks", *SELECT_KS, "-n", str(SELECT_SAMPLES),
              "-b", str(SELECT_BATCH), "-d", DEVICE])
    _sync()
    select_s = time.perf_counter() - t0
    auto_label_clusters.main([ckpt, str(sem), "-k", SELECT_KS[-1], "-n", str(SELECT_SAMPLES),
                              "-b", str(SELECT_BATCH), "-d", DEVICE])
    _sync()
    label_s = time.perf_counter() - t0 - select_s
    creation = json.loads((sem / "creation_config_sel.json").read_text())
    report = json.loads((sem / "selection_report_sel.json").read_text())
    merged = json.loads((sem / "merged_classes_sel.json").read_text())
    auto = json.loads((sem / f"merged_classes_{SELECT_KS[-1]}.json").read_text())
    with np.load(sem / "catalogs" / "sel.npz") as cat:
        chosen = sorted(name[len("centers_"):] for name in cat.files
                        if name.startswith("centers_"))
    layers = creation["keys_for_class_determination"] + \
        creation["keys_for_finegrained_segmentation"]
    if sorted(set(layers)) != chosen or sorted(merged) != chosen or not report["rows"] or \
            len(auto) != len(report["rows"]) // len(SELECT_KS):
        raise AssertionError(f"selection outputs disagree: {layers}, {chosen}, {sorted(merged)}")
    log(f"select_cluster_config --ks {' '.join(SELECT_KS)} -n {SELECT_SAMPLES}: "
        f"{select_s:.3f} s, cd layers {report['cd_layers']}, fg layers {report['fg_layers']}; "
        f"auto_label_clusters -k {SELECT_KS[-1]}: {label_s:.3f} s")
    return {"select_s": select_s, "auto_label_s": label_s, "cd_layers": report["cd_layers"],
            "fg_layers": report["fg_layers"]}


def check_selection_segmenter(run: Path, sem: Path) -> float:
    """The dataset CLI's segmenter built from the selection's outputs, its
    front half (nearest-centre labels, class masks) on one batch of 2 from
    the run's generator; returns the share of pixels it labels as text."""
    from synthesis_in_style_tpu_torch.cli.create_dataset_for_segmentation import (
        get_dataset_segmenter,
    )
    from synthesis_in_style_tpu_torch.models.factory import load_generator

    creation = json.loads((sem / "creation_config_sel.json").read_text())
    layers = creation["keys_for_class_determination"] + \
        creation["keys_for_finegrained_segmentation"]
    seg = get_dataset_segmenter(argparse.Namespace(num_clusters="sel"), creation,
                                CONFIG_256["image_size"], sem, DEVICE)
    gen = load_generator(run / "checkpoints" / "g_ema.pt", CONFIG_256, device=DEVICE)
    z = torch.randn((2, CONFIG_256["latent_size"]),
                    generator=torch.Generator().manual_seed(SEED + 6)).to(DEVICE)
    with torch.no_grad():
        _, acts = gen([z], randomize_noise=False, return_intermediate_activations=True)
    masks = seg.compute_masks({str(k): v for k, v in acts.items() if str(k) in seg.catalog})
    if sorted({layer for layer, _ in masks}) != sorted(set(layers)):
        raise AssertionError(f"masks of the selection's segmenter: {sorted(masks)}")
    text = [m for (_, name), m in masks.items() if name != "background"]
    share = float(torch.stack(text).float().mean()) if text else 0.0
    log(f"the selection's segmenter labels {share:.4f} of one batch of 2 as text")
    return share


def stats_card_vs_cpu(run: Path, sem: Path) -> float:
    """One (layer, k) statistics table of select_cluster_config on the card
    and on the CPU from the same activations: within 1e-4 of max|table|."""
    from synthesis_in_style_tpu_torch.models.factory import load_generator
    from synthesis_in_style_tpu_torch.scripts import select_cluster_config as scc
    from synthesis_in_style_tpu_torch.segmentation.factor_catalog import load_catalogs

    args = scc.build_parser().parse_args(["ckpt", str(sem), "--ks", str(STATS_K)])
    centers = load_catalogs(sem / "catalogs" / f"{STATS_K}.npz")[STATS_LAYER].cluster_centers
    gen = load_generator(run / "checkpoints" / "g_ema.pt", CONFIG_256, device=DEVICE)
    z = torch.randn((SELECT_BATCH, CONFIG_256["latent_size"]),
                    generator=torch.Generator().manual_seed(SEED + 7)).to(DEVICE)
    with torch.no_grad():
        img, acts = gen([z], randomize_noise=False, return_intermediate_activations=True)
    lum = torch.clamp((img.float() + 1.0) / 2.0, 0.0, 1.0).mean(dim=-1)
    acts = {STATS_LAYER: acts[int(STATS_LAYER)]}
    run_len = scc.run_length(CONFIG_256["image_size"], args.run_len_frac)
    tables = {}
    for device in (DEVICE, "cpu"):
        a = {k: v.to(device) for k, v in acts.items()}
        feats = scc.layer_features(lum.to(device), a, args, run_len)
        h = int(a[STATS_LAYER].shape[1])
        tables[device] = scc.stats_table(a[STATS_LAYER], feats[h], centers, STATS_K).cpu()
    ref = tables["cpu"]
    rel = ((tables[DEVICE] - ref).abs().max() / ref.abs().max()).item()
    if not rel <= 1e-4:
        raise AssertionError(f"statistics table card vs CPU: relative error {rel}")
    log(f"statistics table (layer {STATS_LAYER}, k={STATS_K}) card vs CPU: max relative "
        f"error {rel:.3g}")
    return rel


def discovery_phase(run: Path, fns: dict) -> dict:
    """Cluster discovery on the run's generator: the CLI once small to warm
    up, then at -n 100 -b 10 -c 6 9 with launch counts from 0 (the
    generator's two kernels must run, CC must not); its artifacts; the fit
    card vs CPU; selection and labelling; one statistics table card vs
    CPU."""
    marks = Steps()
    run_discovery(run, "discovery_warmup", DISCOVERY_WARMUP)
    marks.mark("warmup")
    for fn in fns.values():
        fn.launches = 0
    report = run_discovery(run, "semantic_segmentation")
    marks.mark("cli")
    launches = {name: fn.launches for name, fn in fns.items()}
    for name in ("fused_bias_act", "fused_blur"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the discovery path")
    if launches["segmented_cc"] or launches["fused_bias_act_bwd"]:
        raise AssertionError(f"discovery launched CC or the backward: {launches}")
    sem = run / "semantic_segmentation"
    shapes = check_discovery_artifacts(sem, len(report["fits"]) // len(range(*DISCOVERY_RANGE)))
    fits = report["fits"]
    steps = sum(f["n_steps"] for f in fits)
    fit_sum = sum(f["fit_s"] for f in fits)
    log(f"discovery CLI (-n {DISCOVERY_SAMPLES} -b {DISCOVERY_BATCH} -c "
        f"{DISCOVERY_RANGE[0]} {DISCOVERY_RANGE[1]}, {len(shapes)} layers): generation "
        f"{report['generation_s']:.3f} s, to the device {report['to_device_s']:.3f} s, fits "
        f"{report['fit_s']:.3f} s ({steps} steps, "
        f"{fit_sum / steps * 1e3:.3f} ms per step), render and write {report['write_s']:.3f} s, "
        f"whole CLI {report['cli_s']:.3f} s; activations {report['activation_bytes']} bytes; "
        f"launches {launches}")
    for f in fits:
        log(f"  fit layer {f['layer']:>2} ({shapes[f['layer']][0]}px x {shapes[f['layer']][1]}) "
            f"k={f['k']}: {f['fit_s']:.4f} s, {f['n_steps']} steps, inertia {f['inertia']:.6f}")
    card_vs_cpu = fit_card_vs_cpu(run)
    marks.mark("fit_card_vs_cpu")
    for fn in fns.values():
        fn.launches = 0
    selection = run_selection(run, sem)
    marks.mark("selection")
    # read before the segmenter check's own generator forward
    selection_launches = {name: fn.launches for name, fn in fns.items()}
    selection["selected_text_share"] = check_selection_segmenter(run, sem)
    stats_rel = stats_card_vs_cpu(run, sem)
    marks.mark("selection_checks")
    return {**{k: v for k, v in report.items() if k != "fits"}, "fits": fits,
            "fit_steps": steps, "fit_ms_per_step": fit_sum / steps * 1e3,
            "layer_shapes": shapes, "launches": launches, "fit_card_vs_cpu": card_vs_cpu,
            "selection": selection, "selection_launches": selection_launches,
            "stats_card_vs_cpu_rel_err": stats_rel, "seconds": marks.seconds}


# ---------------------------------------------------------------------------
# capstone recipe: fixture -> 128px GAN (interrupted, resumed `latest`) ->
# 256px GAN warm-started from it (`--init-ckpt`) -> the five-leg chain

CAPSTONE_128 = REPO_ROOT / "configs" / "stylegan" / "capstone_128px.yaml"
CAPSTONE_256 = REPO_ROOT / "configs" / "stylegan" / "capstone_256px.yaml"
# the recipe's own configs at their widths; only iteration and sample counts cut
CAPSTONE_128_CUTS = {"max_iter": 20, "snapshot_save_iter": 10, "fid_eval_iter": 10,
                     "fid_samples": 64}
CAPSTONE_256_CUTS = {"max_iter": 8, "fid_eval_iter": 4, "fid_samples": 64}
CAPSTONE_INTERRUPT = 10  # the 128px leg's first attempt dies after this snapshot
CAPSTONE_WIDTHS = {}  # a CPU rehearsal shrinks widths and sizes here
FIXTURE_ARGS = ("--size", "256", "--num-pages", "64", "--num-eval", "8")
# g_ema after a few dozen iterations is still mostly its random init (EMA
# half-life ~3k steps): no printed-like strokes, so the appearance score
# labels every text cluster handwritten and the dataset leg finds no
# printed_text class. By side, split at 0.5, with one fine layer, both the
# class-determination layers and the fine layer hold both classes, as the
# dataset segmenter needs (class names only: no gate is read)
CHAIN_SELECT_ARGS = "--class-mode side --left-threshold 0.5 --num-fg-layers 1"
CHAIN_ARGS = ("--ks", "4", "6", "--num-discovery-samples", "16", "--num-pairs", "16",
              "--epochs", "1", "--batch-size", "8", "--min-confidence", "0.0", "0.7",
              "--min-contour-area", "0", "55", "--use-device-component-filter")
FID_CHECK_IMAGES = 8
CHAIN_LEGS = ("cluster_discovery", "select_config", "labelled_synthesis",
              "segmenter_training", "sweep_eval")

# run as `python <this file> -m <module> <args>`: the module as __main__,
# and the port's launch counters written to $SIS_LAUNCH_COUNTS_DIR at exit
COUNTING_LAUNCHER = '''
import atexit, json, os, runpy, sys
sys.path.insert(0, os.getcwd())
from synthesis_in_style_tpu_torch.ops.cuda.fused_bias_act import (
    fused_leaky_relu_bwd_cuda, fused_leaky_relu_cuda)
from synthesis_in_style_tpu_torch.ops.cuda.fused_blur import blur_demod_noise_bias_act_cuda
from synthesis_in_style_tpu_torch.ops.cuda.segmented_cc import connected_components_cuda
from synthesis_in_style_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_bwd_cuda, flash_attention_fwd_cuda)
from synthesis_in_style_tpu_torch.ops.cuda.int8_conv import int8_conv_cuda
fns = {"fused_bias_act": fused_leaky_relu_cuda, "fused_bias_act_bwd": fused_leaky_relu_bwd_cuda,
       "fused_blur": blur_demod_noise_bias_act_cuda, "segmented_cc": connected_components_cuda,
       "flash_attention_fwd": flash_attention_fwd_cuda,
       "flash_attention_bwd": flash_attention_bwd_cuda, "int8_conv": int8_conv_cuda}
assert sys.argv[1] == "-m"
module = sys.argv[2]
out = os.path.join(os.environ["SIS_LAUNCH_COUNTS_DIR"], f"{module}.{os.getpid()}.json")
atexit.register(lambda: open(out, "w").write(json.dumps(
    {"module": module, **{name: fn.launches for name, fn in fns.items()}})))
sys.argv = [module] + sys.argv[3:]
runpy.run_module(module, run_name="__main__", alter_sys=True)
'''


def capstone_config(root: Path, source: Path, cuts: dict, name: str) -> Path:
    """A shipped capstone config with the phase's cuts, as JSON."""
    import yaml

    config = {**yaml.safe_load(source.read_text()), **cuts, **CAPSTONE_WIDTHS.get(name, {})}
    path = root / f"{name}.json"
    path.write_text(json.dumps(config))
    return path


class _TrainerRecorder:
    """While active: every Trainer that trains (with the iteration it starts
    at), every evaluation (trainer.last_evaluation after each Evaluator run)
    and what each warm start returned; optionally a KeyboardInterrupt right
    after the snapshot at `interrupt_at`."""

    def __init__(self, interrupt_at=None):
        self.interrupt_at = interrupt_at
        self.trainers, self.evaluations, self.warm_starts = [], [], []

    def __enter__(self):
        from synthesis_in_style_tpu_torch.cli import train_stylegan_2 as cli
        from synthesis_in_style_tpu_torch.core import extensions
        from synthesis_in_style_tpu_torch.core.trainer import Trainer

        self._originals = (Trainer.train, extensions.Evaluator.run, extensions.Snapshotter.run,
                           cli.warm_start)
        train, evaluate, snapshot, warm_start = self._originals
        rec = self

        def train_recorded(trainer):
            entry = [trainer, trainer.updater.iteration, None]
            rec.trainers.append(entry)
            t0 = time.perf_counter()
            try:
                return train(trainer)
            finally:  # an interrupted run's loop seconds too
                entry[2] = time.perf_counter() - t0

        def evaluate_recorded(ext, trainer):
            evaluate(ext, trainer)
            rec.evaluations.append(dict(trainer.last_evaluation))

        def snapshot_then_die(ext, trainer):
            snapshot(ext, trainer)
            if trainer.updater.iteration == rec.interrupt_at:
                raise KeyboardInterrupt(f"interrupted after the iteration-{rec.interrupt_at} "
                                        "snapshot")

        def warm_start_recorded(state, init_ckpt, image_size):
            counts = warm_start(state, init_ckpt, image_size)
            rec.warm_starts.append({
                "counts": counts,
                **{key: {k: v.detach().cpu().clone() for k, v in
                         getattr(state, attr).state_dict().items()}
                   for key, attr in (("generator", "generator"), ("g_ema", "g_ema"),
                                     ("discriminator", "discriminator"))}})
            return counts

        Trainer.train = train_recorded
        extensions.Evaluator.run = evaluate_recorded
        extensions.Snapshotter.run = snapshot_then_die
        cli.warm_start = warm_start_recorded
        return self

    def __exit__(self, *exc):
        from synthesis_in_style_tpu_torch.cli import train_stylegan_2 as cli
        from synthesis_in_style_tpu_torch.core import extensions
        from synthesis_in_style_tpu_torch.core.trainer import Trainer

        (Trainer.train, extensions.Evaluator.run, extensions.Snapshotter.run,
         cli.warm_start) = self._originals
        return False


def run_gan_leg(config: Path, fixture: Path, log_root: Path, *extra) -> None:
    """The GAN training CLI on the fixture with FID on its val.json."""
    from synthesis_in_style_tpu_torch.cli import train_stylegan_2 as cli

    argv = [str(config), "--images", str(fixture / "train.json"),
            "--val-images", str(fixture / "val.json"), "-l", str(log_root), "-ln", "gan",
            "-d", DEVICE, *extra]
    cli.main(cli.resolve_log_dir(cli.build_parser().parse_args(argv)))


def _alarm(trainer):
    from synthesis_in_style_tpu_torch.core.extensions import DivergenceAlarm

    return next(e for e in trainer.extensions if isinstance(e, DivergenceAlarm))


def _leg_numbers(rec: _TrainerRecorder, batch: int) -> dict:
    """Per attempt: iterations, loop seconds, FID evaluations (iteration,
    relative FID, seconds), training images/s outside the evaluations, and
    the alarm's fid_history."""
    attempts = []
    for trainer, start, seconds in rec.trainers:
        evals = [e for e in rec.evaluations
                 if start < e["iteration"] <= trainer.updater.iteration]
        fid_s = sum(e["fid_seconds"] for e in evals)
        iters = trainer.updater.iteration - start
        attempts.append({
            "start_iteration": start, "end_iteration": trainer.updater.iteration,
            "loop_seconds": seconds,
            "fid": [[e["iteration"], e["fid_score"], e["fid_seconds"]] for e in evals],
            "fid_seconds": fid_s,
            "images_per_s": iters * batch / (seconds - fid_s),
            "alarm_fid_history": _alarm(trainer).fid_history})
    return {"attempts": attempts}


def _check_fid_history(attempt: dict, what: str) -> None:
    """Finite FIDs, and the alarm saw every evaluated iteration once (an
    evaluation repeated at the end of training joins once, with one of its
    values)."""
    evals = attempt["fid"]
    if not evals or not all(math.isfinite(f) and f >= 0 for _, f, _ in evals):
        raise AssertionError(f"{what}: FID evaluations {evals}")
    history = attempt["alarm_fid_history"]
    if [it for it, _ in history] != sorted({it for it, _, _ in evals}) or not all(
            any(it == e_it and f == e_f for e_it, e_f, _ in evals) for it, f in history):
        raise AssertionError(f"{what}: the alarm's fid_history {history} is not the "
                             f"evaluations {evals}")


def _expected_warm_counts(src: dict, dst: dict, shift: int, discriminator: bool) -> tuple:
    """(copied, fresh) computed from the two state dicts alone: a target
    tensor is copied where the source has the same name (for the
    discriminator, its block index less the shift; its input layer never)
    and the same shape."""
    copied = 0
    for name, value in dst.items():
        src_name = name
        if discriminator and name.startswith("convs."):
            parts = name.split(".")
            index = int(parts[1]) - shift
            src_name = ".".join(["convs", str(index), *parts[2:]]) if index >= 1 else None
        if src_name in src and src[src_name].shape == value.shape:
            copied += 1
    return copied, len(dst) - copied


def check_warm_start(rec: _TrainerRecorder, source: Path, target_snapshot: Path) -> dict:
    """The warm start's counts against counts from the two snapshots' state
    dicts, and one copied tensor of each network bit-equal to its source."""
    from synthesis_in_style_tpu_torch.core.config import load_config_from_checkpoint
    from synthesis_in_style_tpu_torch.utils.checkpoint import load_gan_snapshot

    (warm,) = rec.warm_starts
    src, dst = load_gan_snapshot(source), load_gan_snapshot(target_snapshot)
    shift = int(math.log2(load_config_from_checkpoint(target_snapshot)["image_size"])) - \
        int(math.log2(load_config_from_checkpoint(source)["image_size"]))
    probes = {"generator": ("conv1.conv.weight", "conv1.conv.weight"),
              "g_ema": ("convs.0.conv.weight", "convs.0.conv.weight"),
              "discriminator": ("convs.1.conv1.0.weight", f"convs.{1 + shift}.conv1.0.weight")}
    out = {}
    for key in ("generator", "discriminator", "g_ema"):
        expected = _expected_warm_counts(src[key], dst[key], shift, key == "discriminator")
        if tuple(warm["counts"][key]) != expected:
            raise AssertionError(f"warm start {key}: {warm['counts'][key]} copied / fresh, "
                                 f"the state dicts give {expected}")
        src_name, dst_name = probes[key]
        if not torch.equal(warm[key][dst_name], src[key][src_name]):
            raise AssertionError(f"warm start {key}: {dst_name} is not the source's {src_name}")
        out[key] = {"copied": expected[0], "fresh": expected[1],
                    "bit_equal": f"{dst_name} <- {src_name}"}
    if torch.equal(src["g_ema"]["conv1.conv.weight"], src["generator"]["conv1.conv.weight"]):
        raise AssertionError("the source's g_ema equals its generator: the probe proves nothing")
    if not torch.equal(warm["g_ema"]["conv1.conv.weight"], src["g_ema"]["conv1.conv.weight"]):
        raise AssertionError("warm start g_ema took another network's conv1")
    return out


def run_chain(root: Path, snapshot: Path, fixture: Path) -> dict:
    """`run_capstone_chain` on the 256px snapshot, each leg in a subprocess
    whose launch counts are written at its exit; returns the report and the
    counts by leg."""
    from synthesis_in_style_tpu_torch.scripts import run_capstone_chain

    launcher = root / "count_launches.py"
    launcher.write_text(COUNTING_LAUNCHER)
    counts_dir = root / "launch_counts"
    counts_dir.mkdir()
    work = root / "chain"
    env_before = dict(os.environ)
    os.environ["SIS_LAUNCH_COUNTS_DIR"] = str(counts_dir)
    try:
        rc = run_capstone_chain.main(
            [str(snapshot), str(work), "--fixture", str(fixture), "-d", DEVICE,
             "--select-args", CHAIN_SELECT_ARGS, *CHAIN_ARGS],
            interpreter=[sys.executable, str(launcher)])
    finally:
        os.environ.clear()
        os.environ.update(env_before)
    if rc != 0:
        raise AssertionError(f"run_capstone_chain returned {rc}")
    report = json.loads((work / "chain_report.json").read_text())
    modules = {"cluster_discovery": "create_semantic_segmentation",
               "select_config": "select_cluster_config",
               "labelled_synthesis": "create_dataset_for_segmentation",
               "segmenter_training": "cli.train", "sweep_eval": "analyze_image_segments"}
    by_leg = {}
    for path in counts_dir.glob("*.json"):
        record = json.loads(path.read_text())
        leg = next(name for name, m in modules.items() if record["module"].endswith(m))
        by_leg[leg] = {k: v for k, v in record.items() if k != "module"}
    return {"report": report, "launches_by_leg": by_leg}


def check_chain(chain: dict) -> None:
    report = chain["report"]
    if list(report["legs"]) != list(CHAIN_LEGS):
        raise AssertionError(f"chain legs {list(report['legs'])}")
    for name, leg in report["legs"].items():
        if leg["returncode"] != 0 or not leg["seconds"] > 0:
            raise AssertionError(f"chain leg {name}: {leg}")
    for name, score in report["best_dice"].items():
        if not (math.isfinite(score) and 0.0 <= score <= 1.0):
            raise AssertionError(f"best_dice {name} = {score}")
    if set(chain["launches_by_leg"]) != set(CHAIN_LEGS):
        raise AssertionError(f"launch counts from legs {sorted(chain['launches_by_leg'])}")


def fid_card_vs_cpu(fixture: Path, snapshot: Path) -> dict:
    """The fallback embedding (seeded random VGG16, pooled relu5_3) on the
    card and on the CPU, TF32 off, on FID_CHECK_IMAGES fixture pages and as
    many g_ema samples of the 256px snapshot: features within 1e-4 of
    max |cpu|; one Frechet distance of each device's features."""
    import warnings

    from synthesis_in_style_tpu_torch.cli.train_stylegan_2 import GANImageDataset
    from synthesis_in_style_tpu_torch.core.config import load_config_from_checkpoint
    from synthesis_in_style_tpu_torch.evaluation import fid
    from synthesis_in_style_tpu_torch.models.factory import load_generator

    config = load_config_from_checkpoint(snapshot)
    data = GANImageDataset(fixture / "train.json", root=fixture,
                           image_size=config["image_size"])
    real = torch.stack([data[i]["images"] for i in range(FID_CHECK_IMAGES)])
    gen = load_generator(snapshot, config, device="cpu")
    z = torch.randn((FID_CHECK_IMAGES, int(config["latent_size"])),
                    generator=torch.Generator().manual_seed(42))
    with torch.no_grad():
        fake, _ = gen([z], randomize_noise=False)
    set_tf32(False)
    feats, distance = {}, {}
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for device in (DEVICE, "cpu"):
                fn = fid.default_feature_fn(device=device)
                feats[device] = [fn(x.to(device)).float().cpu() for x in (real, fake)]
                r, f = (fid.get_statistics(t.double().numpy()) for t in feats[device])
                distance[device] = fid.calculate_frechet_distance(r.mu, r.sigma, f.mu, f.sigma)
    finally:
        set_tf32(True)
        torch.backends.cuda.matmul.allow_tf32 = False
    rel = max(((a - b).abs().max() / b.abs().max()).item()
              for a, b in zip(feats[DEVICE], feats["cpu"]))
    if not rel <= 1e-4:
        raise AssertionError(f"FID features card vs CPU: relative error {rel} > 1e-4")
    return {"features_rel_err": rel, "fid_card": distance[DEVICE], "fid_cpu": distance["cpu"],
            "fid_rel_diff": abs(distance[DEVICE] - distance["cpu"]) / abs(distance["cpu"])}


def gan_loader_epochs(fixture: Path, config: Path, epochs: int = 3) -> dict:
    """A GAN leg's training loader alone over the fixture (the leg's batch
    and workers, kept across epochs, as the CLI builds it): per epoch, the
    seconds to its first batch and to its end."""
    from synthesis_in_style_tpu_torch.cli.train_stylegan_2 import GANImageDataset
    from synthesis_in_style_tpu_torch.data.loader import make_loader, shutdown_workers

    cfg = json.loads(config.read_text())
    dataset = GANImageDataset(fixture / "train.json", root=fixture,
                              image_size=cfg["image_size"], num_channels=cfg.get("input_dim", 3))
    loader = make_loader(dataset, int(cfg["batch_size"]), shuffle=True, drop_last=True,
                         num_workers=int(cfg.get("num_workers", 8)), pin_memory=DEVICE == "cuda")
    first, whole = [], []
    try:
        for _ in range(epochs):
            t0 = time.perf_counter()
            batches = iter(loader)
            next(batches)
            first.append(time.perf_counter() - t0)
            for _ in batches:
                pass
            whole.append(time.perf_counter() - t0)
    finally:
        shutdown_workers(loader)
    return {"batches_per_epoch": len(loader), "workers": loader.num_workers,
            "first_batch_s": first, "epoch_s": whole,
            "images_per_s": [len(loader) * loader.batch_size / t for t in whole]}


def capstone_phase(root: Path, fns: dict) -> dict:
    """The capstone recipe's legs at the recipe's widths, cut in iterations
    and sample counts (CAPSTONE_*_CUTS): the fixture; the 128px GAN with
    FID, interrupted after its iteration-20 snapshot and resumed `latest`;
    the 256px GAN warm-started from its final snapshot; the five-leg chain
    on the 256px snapshot; the FID embedding card vs CPU. Launch counts are
    set to 0 before each GAN leg and read after it; the chain's legs count
    in their own processes."""
    steps = Steps()
    fixture = root / "fixture"
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m",
                    "synthesis_in_style_tpu_torch.scripts.make_capstone_fixture", str(fixture),
                    *FIXTURE_ARGS], check=True, timeout=600)
    fixture_s = time.perf_counter() - t0
    log(f"capstone fixture ({' '.join(FIXTURE_ARGS)}; cut from the recipe's 768 pages and 64 "
        f"eval pairs): {fixture_s:.3f} s on the host")

    # 128px: attempt 1 dies after its iteration-20 snapshot, attempt 2 resumes
    config_128 = capstone_config(root, CAPSTONE_128, CAPSTONE_128_CUTS, "capstone_128")
    batch = int(json.loads(config_128.read_text())["batch_size"])
    steps.mark("fixture")
    loader_128 = gan_loader_epochs(fixture, config_128)
    steps.mark("loader_128")
    log(f"capstone 128px leg's loader alone ({loader_128['workers']} workers kept, "
        f"{loader_128['batches_per_epoch']} batches an epoch): epochs' first batches "
        + ", ".join(f"{t:.3f}" for t in loader_128["first_batch_s"]) + " s, epochs "
        + ", ".join(f"{t:.3f}" for t in loader_128["epoch_s"]) + " s = "
        + ", ".join(f"{r:.2f}" for r in loader_128["images_per_s"]) + " images/s")
    for fn in fns.values():
        fn.launches = 0
    with _TrainerRecorder(interrupt_at=CAPSTONE_INTERRUPT) as rec_128:
        try:
            run_gan_leg(config_128, fixture, root / "gan128")
            raise AssertionError("the 128px leg's first attempt was not interrupted")
        except KeyboardInterrupt:
            pass
        run_gan_leg(config_128, fixture, root / "gan128", "--resume-ckpt", "latest")
    launches_128 = {name: fn.launches for name, fn in fns.items()}
    steps.mark("gan_128")
    leg_128 = _leg_numbers(rec_128, batch)
    first, second = leg_128["attempts"]
    if (first["end_iteration"], second["start_iteration"], second["end_iteration"]) != \
            (CAPSTONE_INTERRUPT, CAPSTONE_INTERRUPT, CAPSTONE_128_CUTS["max_iter"]):
        raise AssertionError(f"128px attempts {first} / {second}")
    attempts = sorted((root / "gan128" / "gan").iterdir())
    final_128 = attempts[-1] / "checkpoints" / f"iter_{CAPSTONE_128_CUTS['max_iter']:08d}.pt"
    if len(attempts) != 2 or not final_128.exists():
        raise AssertionError(f"128px attempts {attempts}, no {final_128}")
    for i, attempt in enumerate(leg_128["attempts"]):
        _check_fid_history(attempt, f"128px attempt {i + 1}")
    log(f"capstone 128px leg ({CAPSTONE_128.name}, shipped widths, cut to "
        f"{CAPSTONE_128_CUTS}): attempt 1 stopped after iteration {first['end_iteration']}, "
        f"attempt 2 resumed `latest` at {second['start_iteration']} and wrote "
        f"{final_128.name}; launches {launches_128}")
    for i, attempt in enumerate(leg_128["attempts"]):
        log(f"  attempt {i + 1}: {attempt['images_per_s']:.2f} training images/s outside FID "
            f"(loop {attempt['loop_seconds']:.3f} s, FID {attempt['fid_seconds']:.3f} s); "
            "relative FID (iteration, value, seconds): "
            + ", ".join(f"({it}, {f:.4f}, {s:.3f})" for it, f, s in attempt["fid"])
            + f"; alarm fid_history {attempt['alarm_fid_history']}")

    # 256px, warm-started from the 128px leg's final snapshot
    config_256 = capstone_config(root, CAPSTONE_256, CAPSTONE_256_CUTS, "capstone_256")
    for fn in fns.values():
        fn.launches = 0
    with _TrainerRecorder() as rec_256:
        t0 = time.perf_counter()
        run_gan_leg(config_256, fixture, root / "gan256", "--init-ckpt", str(final_128))
        leg_256_s = time.perf_counter() - t0
    launches_256 = {name: fn.launches for name, fn in fns.items()}
    steps.mark("gan_256")
    leg_256 = _leg_numbers(rec_256, batch)
    (attempt_256,) = leg_256["attempts"]
    _check_fid_history(attempt_256, "256px leg")
    (run_256,) = (root / "gan256" / "gan").iterdir()
    final_256 = run_256 / "checkpoints" / f"iter_{CAPSTONE_256_CUTS['max_iter']:08d}.pt"
    warm = check_warm_start(rec_256, final_128, final_256)
    log(f"capstone 256px leg ({CAPSTONE_256.name}, shipped widths, cut to {CAPSTONE_256_CUTS}) "
        f"warm-started from {final_128.name}: " + "; ".join(
            f"{k} {v['copied']} copied / {v['fresh']} fresh ({v['bit_equal']} bit-equal)"
            for k, v in warm.items())
        + f"; {attempt_256['images_per_s']:.2f} training images/s outside FID (loop "
        f"{attempt_256['loop_seconds']:.3f} s, whole CLI {leg_256_s:.3f} s, FID "
        f"{attempt_256['fid_seconds']:.3f} s); relative FID (iteration, value, seconds): "
        + ", ".join(f"({it}, {f:.4f}, {s:.3f})" for it, f, s in attempt_256["fid"])
        + f"; alarm fid_history {attempt_256['alarm_fid_history']}; launches {launches_256}")

    steps.mark("warm_start_check")
    chain = run_chain(root, final_256, fixture)
    check_chain(chain)
    steps.mark("chain")
    report = chain["report"]
    log("capstone chain (" + " ".join(CHAIN_ARGS) + f", --select-args '{CHAIN_SELECT_ARGS}'): "
        + ", ".join(f"{k} {v['seconds']:.3f} s" for k, v in report["legs"].items())
        + f"; total {report['total_seconds']:.3f} s; best dice {report['best_dice']}")
    log("  launches by leg: " + "; ".join(f"{k} {v}" for k, v in chain["launches_by_leg"].items()))
    fid_check = fid_card_vs_cpu(fixture, final_256)
    steps.mark("fid_card_vs_cpu")
    log(f"FID embedding card vs CPU (TF32 off, {FID_CHECK_IMAGES} pages and {FID_CHECK_IMAGES} "
        f"g_ema samples at 256px): features max relative error "
        f"{fid_check['features_rel_err']:.3g}; Frechet distance card {fid_check['fid_card']:.6f}, "
        f"CPU {fid_check['fid_cpu']:.6f}")
    chain_launches = {name: sum(leg[name] for leg in chain["launches_by_leg"].values())
                      for name in fns}
    return {"fixture_s": fixture_s, "gan_128": leg_128, "launches_128": launches_128,
            "loader_128": loader_128,
            "gan_256": leg_256, "launches_256": launches_256, "gan_256_cli_s": leg_256_s,
            "warm_start": warm, "chain": chain, "chain_launches": chain_launches,
            "fid_card_vs_cpu": fid_check, "snapshot_256": final_256, "seconds": steps.seconds}


# ---------------------------------------------------------------------------
# TransUNet: the flash attention kernels, the full-width network card vs CPU,
# training through the CLI with attention_impl flash and xla, page inference

BF16_OPS_PER_S = 989e12  # H100 SXM bfloat16 tensor cores, dense
TF32_OPS_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense
TU_CONFIG = REPO_ROOT / "configs" / "segmenter" / "stylegan2_trans_u_net_segmenter.yaml"
TU_OVERRIDES = {"max_iter": 4, "snapshot_save_iter": 4, "log_iter": 2}
TU_WARMUP = {"max_iter": 2, "snapshot_save_iter": 2}
TU_TIMED_STEPS = 5  # the training step alone: timed steps
TU_CHECK_SIZE = 512  # the card-vs-CPU network's image size (1024 tokens)
TU_CHECK_BATCH = 2
# (B, heads, N, d): the shipped R50-ViT-B_16 at 512px (training and every
# page batch: a short last batch of patches is padded to the batch), that
# shape's 4 real patches of a 2048x1536 page's last batch, the `testing`
# config at 256px, ViT-H_14's head dim at the smallest legal N, and N = 128
FLASH_MAIN = (8, 12, 1024, 64)
FLASH_SHAPES = (FLASH_MAIN, (4, 12, 1024, 64), (2, 2, 256, 8), (1, 16, 128, 80),
                (2, 12, 128, 64))
# N a multiple of no kernel's tile (float32: 64-row blocks, 64-key forward
# tiles, backward tiles of 64 rows or keys, 32 at d > 64; bfloat16: 128
# query rows, 128 keys at d <= 64 and 64 above, 32-row dK / dV query tiles,
# 64-key dQ tiles), so that the masks past N run, and d padded in each
FLASH_RAGGED = ((2, 2, 200, 64), (1, 4, 150, 128), (1, 2, 257, 80))
# float32 only (bfloat16 refuses d % 8 != 0): d a multiple of 4 but not of 8
# (16-byte copies, d padded to 64) and d a multiple of neither (4-byte copies)
FLASH_RAGGED_F32 = ((1, 3, 190, 36), (2, 2, 130, 10))
# relative to max|ref|: float32 forward 1e-5 and backward 1e-4 (the sums run
# in another order); bfloat16 2^-7, one rounding of the output on each side:
# the kernels and the plain version compute in float32 from the same
# bfloat16 inputs and both round P (before P V and P^T dO) and dS * scale
# (before dS^T Q and dS K) to bfloat16, the forward's P against its running
# maximum in the kernel and against the row's in the plain version
FLASH_TOLERANCES = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2.0**-7, 2.0**-7)}


def flash_counters() -> dict:
    from synthesis_in_style_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_bwd_cuda,
        flash_attention_fwd_cuda,
    )

    return {"flash_attention_fwd": flash_attention_fwd_cuda,
            "flash_attention_bwd": flash_attention_bwd_cuda}


def _flash_bound(shape, dtype, backward: bool) -> dict:
    """Forward: 4 B h N^2 d operations, q, k, v read and o written (and the
    float32 logsumexp); backward: 10 B h N^2 d (S recomputed, dP, dV, dK,
    dQ), q, k, v, o, dO and the logsumexp read, dq, dk, dv written. bfloat16
    runs them at the bfloat16 tensor-core rate; float32 at the TF32 rate,
    three products each (3xTF32, the float32 kernels' route), with the bound
    on float32 FMAs beside it as `fma_bound_ms`."""
    b, h, n, d = shape
    item = torch.finfo(dtype).bits // 8
    tensors = 8 if backward else 4
    nbytes = tensors * b * h * n * d * item + 4 * b * h * n
    nops = (10 if backward else 4) * b * h * n * n * d
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    out = {"gflop": nops / 1e9, "mbytes": nbytes / 1e6}
    if dtype == torch.bfloat16:
        by_ops, kind = nops / BF16_OPS_PER_S * 1e3, "operations"
    else:
        by_ops, kind = 3 * nops / TF32_OPS_PER_S * 1e3, "operations (3xTF32)"
        out["fma_bound_ms"] = max(by_bytes, nops / FP32_OPS_PER_S * 1e3)
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else kind, **out}


def _top_kernel_names(fn, top: int = 3) -> list:
    """The names of the kernels with the most device time in one fn() call
    under torch.profiler."""
    return [k["name"] for k in profile_call(fn, top)["top_kernels"]]


def check_flash_attention(detail) -> dict:
    """The flash forward and backward kernels against their plain versions
    on the card, TF32 off, at FLASH_SHAPES and FLASH_RAGGED in float32 and
    bfloat16 and at FLASH_RAGGED_F32 in float32; the gradients through the
    autograd Function (FlashAttentionFunction). At the main shape two
    backward calls give the same bits in each dtype, and each kernel is
    timed (bench_ms; device time from torch.profiler) beside its plain
    version, its bound and PyTorch's scaled_dot_product_attention (forward;
    its backward through autograd), whose kernels are named from a
    profile."""
    import torch.nn.functional as F

    from synthesis_in_style_tpu_torch.ops.attention import flash_attention
    from synthesis_in_style_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_bwd_cuda,
        flash_attention_bwd_plain,
        flash_attention_fwd_cuda,
        flash_attention_fwd_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    worst = {"fwd": 0.0, "bwd": 0.0}
    rows = {"fwd": [], "bwd": []}
    cases = list(itertools.product(FLASH_SHAPES + FLASH_RAGGED, FLASH_TOLERANCES))
    cases += [(shape, torch.float32) for shape in FLASH_RAGGED_F32]
    for shape, dtype in cases:
        tol_fwd, tol_bwd = FLASH_TOLERANCES[dtype]
        q, k, v, do = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                       for _ in range(4))
        scale = shape[-1] ** -0.5
        ref_o, ref_lse = flash_attention_fwd_plain(q, k, v, scale)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = flash_attention(*leaves, sm_scale=scale)
        o.backward(do)
        torch.cuda.synchronize()
        ref_grads = flash_attention_bwd_plain(q, k, v, ref_o, ref_lse, do, scale)
        name = f"{tuple(shape)} {str(dtype).split('.')[-1]}"
        if o.dtype != dtype or o.shape != q.shape:
            raise AssertionError(f"flash forward {name}: {o.dtype} {tuple(o.shape)}")
        errs = {"fwd": _rel(o.float(), ref_o.float().cpu())}
        errs["bwd"] = max(_rel(t.grad.float(), r.float().cpu())
                          for t, r in zip(leaves, ref_grads))
        _, lse = flash_attention_fwd_cuda(q, k, v, scale)
        errs["lse"] = (lse - ref_lse).abs().max().item()
        for kind, tol in (("fwd", tol_fwd), ("bwd", tol_bwd)):
            if not errs[kind] <= tol:
                raise AssertionError(f"flash {kind} {name}: relative error {errs[kind]} > "
                                     f"{tol}")
            worst[kind] = max(worst[kind], errs[kind])
        if not errs["lse"] <= 1e-4:
            raise AssertionError(f"flash logsumexp {name}: {errs['lse']}")
        row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
               "rel_err_fwd": errs["fwd"], "rel_err_bwd": errs["bwd"],
               "lse_abs_err": errs["lse"], "tolerance": [tol_fwd, tol_bwd]}
        if tuple(shape) == FLASH_MAIN:
            o_k, lse_k = flash_attention_fwd_cuda(q, k, v, scale)
            first, second = (flash_attention_bwd_cuda(q, k, v, o_k, lse_k, do, scale)
                             for _ in range(2))
            if not all(torch.equal(a, b) for a, b in zip(first, second)):
                raise AssertionError(f"flash backward {name}: two calls differ")
            row["bwd_bitwise_repeatable"] = True
            sdpa = [t.clone().requires_grad_(True) for t in (q, k, v)]
            sdpa_o = F.scaled_dot_product_attention(*sdpa, scale=scale)

            def fwd():
                flash_attention_fwd_cuda(q, k, v, scale)

            def bwd():
                flash_attention_bwd_cuda(q, k, v, o_k, lse_k, do, scale)

            def sdpa_bwd():
                torch.autograd.grad(sdpa_o, sdpa, do, retain_graph=True)

            def sdpa_fwd():
                F.scaled_dot_product_attention(q, k, v, scale=scale)

            rows["fwd"].append({**row, "ms": bench_ms(fwd), "device_ms": device_ms(fwd),
                                "plain_ms": bench_ms(lambda: flash_attention_fwd_plain(
                                    q, k, v, scale)),
                                "library_ms": bench_ms(sdpa_fwd),
                                "library_kernels": _top_kernel_names(sdpa_fwd),
                                **_flash_bound(shape, dtype, False)})
            rows["bwd"].append({**row, "ms": bench_ms(bwd), "device_ms": device_ms(bwd),
                                "plain_ms": bench_ms(lambda: flash_attention_bwd_plain(
                                    q, k, v, o_k, lse_k, do, scale)),
                                "library_ms": bench_ms(sdpa_bwd),
                                "library_kernels": _top_kernel_names(sdpa_bwd),
                                **_flash_bound(shape, dtype, True)})
            del sdpa_o
        detail.append(row)
        log(f"flash_attention {row}")
    out = {}
    for kind in ("fwd", "bwd"):
        f32 = next(r for r in rows[kind] if r["dtype"] == "float32")
        bf16 = next(r for r in rows[kind] if r["dtype"] == "bfloat16")
        out[f"flash_attention_{kind}"] = {
            **{key: f32[key] for key in ("ms", "device_ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by", "fma_bound_ms",
                                         "library_kernels")},
            **{f"bf16_{key}": bf16[key] for key in ("ms", "device_ms", "plain_ms",
                                                    "library_ms", "bound_ms")},
            "bf16_source": "synthesis_in_style_tpu_torch/csrc/flash_attention_bf16.cuh",
            "max_abs_err": worst[kind], "shape": list(FLASH_MAIN)}
        detail.append({"kind": kind, "main_shape": rows[kind]})
        log(f"flash_attention_{kind} at {FLASH_MAIN}: float32 {f32['ms']:.4f} ms (device "
            f"{f32['device_ms']}, plain {f32['plain_ms']:.4f}, SDPA {f32['library_ms']:.4f}) "
            f"against a bound of {f32['bound_ms']:.4f} in 3xTF32 ({f32['fma_bound_ms']:.4f} on "
            f"FMAs); bfloat16 {bf16['ms']:.4f} ms (device {bf16['device_ms']}, plain "
            f"{bf16['plain_ms']:.4f}, SDPA {bf16['library_ms']:.4f}) against "
            f"{bf16['bound_ms']:.4f}; SDPA's kernels: float32 {f32['library_kernels']}, "
            f"bfloat16 {bf16['library_kernels']}")
    return out


def _tu_network(size: int, impl: str, num_classes: int = 3):
    """The shipped config's R50-ViT-B_16 at `size` px, dropout off (the card
    and the CPU draw different masks)."""
    import yaml

    from synthesis_in_style_tpu_torch.models.trans_u_net import VIT_CONFIGS, VisionTransformer

    shipped = yaml.safe_load(TU_CONFIG.read_text())
    config = VIT_CONFIGS[shipped["pretrained_model_name"]]()
    config["transformer"]["dropout_rate"] = 0.0
    config["attention_impl"] = impl
    patch = shipped["vit_patch_size"]
    config["patches"]["grid"] = (size // patch, size // patch)
    config["n_skip"] = shipped["num_skip_channels"]
    return VisionTransformer(config, img_size=size, num_classes=num_classes)


class _float64_on_card:
    """While active, float64 tensors on the card take the fused ops' plain
    versions (the kernels take float32 and bfloat16): the reference runs of
    the card-vs-CPU gates (TransUNet, EMANet, the autoencoder branch)."""

    def __enter__(self):
        from synthesis_in_style_tpu_torch.ops import fused_act
        from synthesis_in_style_tpu_torch.ops.cuda import fused_bias_act as fba
        from synthesis_in_style_tpu_torch.ops.cuda import fused_blur as fb

        self.saved = (fused_act._forward, fused_act._backward, fb.blur_demod_noise_bias_act_cuda)
        fwd, bwd, blur = self.saved

        def forward(x, bias, slope, scale):
            if x.dtype == torch.float64:
                return fba.fused_leaky_relu_plain(x, bias, slope, scale)
            return fwd(x, bias, slope, scale)

        def backward(y, g, slope, scale):
            if g.dtype == torch.float64:
                return fba.fused_leaky_relu_bwd_plain(y, g, slope, scale)
            return bwd(y, g, slope, scale)

        def blur_tail(x, *args, **kwargs):
            if x.dtype == torch.float64:
                return fb.blur_demod_noise_bias_act_plain(x, *args, **kwargs)
            return blur(x, *args, **kwargs)

        fused_act._forward, fused_act._backward = forward, backward
        fb.blur_demod_noise_bias_act_cuda = blur_tail
        return self

    def __exit__(self, *exc):
        from synthesis_in_style_tpu_torch.ops import fused_act
        from synthesis_in_style_tpu_torch.ops.cuda import fused_blur as fb

        fused_act._forward, fused_act._backward, fb.blur_demod_noise_bias_act_cuda = self.saved
        return False


# the three runs of a card-vs-CPU gate: (name, device, dtype)
GATE_RUNS = (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
             ("float64", "cuda", torch.float64))


def _gate_runs():
    """GATE_RUNS on DEVICE (a CPU rehearsal runs them all on the CPU), the
    float64 one inside _float64_on_card."""
    import contextlib

    for name, device, dtype in GATE_RUNS:
        device = device if DEVICE == "cuda" else "cpu"
        with (_float64_on_card() if dtype == torch.float64 else contextlib.nullcontext()):
            yield name, device, dtype


def _tu_pass(net, x, labels, device, dtype, impl) -> tuple:
    """(eval logits, train-mode 0.5 * CE + 0.5 * Dice loss, its gradients)
    of a copy of `net` on `device` in `dtype` with attention `impl`, all
    returned in float64 on the CPU."""
    from synthesis_in_style_tpu_torch.losses.segmentation import cross_entropy_loss, dice_loss

    model = copy.deepcopy(net).to(device=device, dtype=dtype)
    for block in model.transformer.encoder.layer:
        block.attn.impl = impl
    x, labels = x.to(device, dtype), labels.to(device)
    with torch.no_grad():
        logits = model.eval()(x).double().cpu()
    out = model.train()(x)
    loss = 0.5 * cross_entropy_loss(out, labels) + 0.5 * dice_loss(out, labels, 3)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return logits, float(loss.detach()), {n: g.double().cpu() for n, g in zip(names, grads)}


def _leaf_errors(got: dict, ref: dict) -> dict:
    """Each gradient's max abs error over its tensor's max|ref|, floored at
    1 % of the largest reference gradient (the JAX package's flash test's
    rule: the key bias's gradient is zero up to rounding)."""
    floor = 1e-2 * max(r.abs().max().item() for r in ref.values())
    return {n: (got[n] - r).abs().max().item() / max(r.abs().max().item(), floor)
            for n, r in ref.items()}


def check_transunet_card_vs_cpu() -> dict:
    """The full-width R50-ViT-B_16 (seeded weights, dropout off) at
    TU_CHECK_SIZE px, batch TU_CHECK_BATCH, TF32 off: float32 on the card
    (flash kernels) and on the CPU (their plain version), each against a
    float64 pass on the card (attention through xla: the kernels take no
    float64). Eval logits within 1e-4 of max|ref| on both. The gradients of
    one train-mode 0.5 * CE + 0.5 * Dice loss, per tensor (`_leaf_errors`):
    the card's worst and median no more than twice the CPU's. At a random
    init the backbone's weight-standardised convolutions and GroupNorms are
    ill-conditioned in float32 (on an H100 the worst gradients landed 3 %
    from float64 on the card and on the CPU alike), so the card is held to
    the CPU's float32, not to a fixed bound."""
    from synthesis_in_style_tpu_torch.ops.cuda.flash_attention import flash_attention_fwd_cuda

    g = torch.Generator().manual_seed(SEED + 17)
    net = _tu_network(TU_CHECK_SIZE, "flash").init_weights(g)
    x = torch.rand((TU_CHECK_BATCH, 3, TU_CHECK_SIZE, TU_CHECK_SIZE), generator=g) * 2 - 1
    labels = torch.randint(0, 3, (TU_CHECK_BATCH, TU_CHECK_SIZE, TU_CHECK_SIZE), generator=g)
    runs, seconds = {}, {}
    set_tf32(False)
    try:
        for name, device, dtype in _gate_runs():
            impl = "xla" if dtype == torch.float64 else "flash"
            launches = flash_attention_fwd_cuda.launches
            t0 = time.perf_counter()
            runs[name] = _tu_pass(net, x, labels, device, dtype, impl)
            seconds[name] = time.perf_counter() - t0
            if name == "card" and flash_attention_fwd_cuda.launches - launches != 2 * 12:
                raise AssertionError("the card network did not run the flash kernel 24 times")
            torch.cuda.empty_cache()
    finally:
        set_tf32(True)
        torch.backends.cuda.matmul.allow_tf32 = False
    ref = runs["float64"]
    out = {"size": TU_CHECK_SIZE, "batch": TU_CHECK_BATCH, "seconds": seconds,
           "loss": {k: v[1] for k, v in runs.items()}, "parameters": len(ref[2])}
    for name in ("card", "cpu"):
        if not torch.isfinite(runs[name][0]).all():
            raise AssertionError(f"TransUNet: non-finite logits ({name})")
        by_leaf = _leaf_errors(runs[name][2], ref[2])
        errs = sorted(by_leaf.values())
        out[name] = {"logits_rel_err": _rel(runs[name][0], ref[0]), "grad_worst": errs[-1],
                     "grad_median": errs[len(errs) // 2],
                     "worst_leaves": sorted(by_leaf, key=by_leaf.get)[-3:]}
    out["card_vs_cpu"] = {"logits_rel_err": _rel(runs["card"][0], runs["cpu"][0]),
                          "grad_worst": max(_leaf_errors(runs["card"][2], runs["cpu"][2]).values())}
    for name in ("card", "cpu"):
        if not out[name]["logits_rel_err"] <= 1e-4:
            raise AssertionError(f"TransUNet {name} logits vs float64: {out[name]}")
    for key in ("grad_worst", "grad_median"):
        if not out["card"][key] <= 2 * out["cpu"][key]:
            raise AssertionError(f"TransUNet gradients vs float64, {key}: card {out['card'][key]} "
                                 f"> 2 x CPU {out['cpu'][key]}")
    log(f"TransUNet R50-ViT-B_16 {TU_CHECK_SIZE}px batch {TU_CHECK_BATCH}, float32, TF32 off, "
        f"against float64 on the card: card (flash kernels) {out['card']}, CPU (plain) "
        f"{out['cpu']}; card vs CPU {out['card_vs_cpu']}; losses {out['loss']}; seconds "
        f"{seconds}")
    return out


class _ForwardCounter:
    """Counts forward passes of every VisionTransformer while it is open."""

    def __enter__(self):
        from torch.nn.modules.module import register_module_forward_hook

        from synthesis_in_style_tpu_torch.models.trans_u_net import VisionTransformer

        self.count = 0

        def hook(module, inputs, output):
            if isinstance(module, VisionTransformer):
                self.count += 1

        self._handle = register_module_forward_hook(hook)
        return self

    def __exit__(self, *exc):
        self._handle.remove()


def write_transunet_config(root: Path, impl: str, cuts: dict) -> Path:
    """The shipped TransUNet config (R50-ViT-B_16, 512px, batch 8, bfloat16)
    with `attention_impl` and the cuts, as JSON."""
    import yaml

    config = {**yaml.safe_load(TU_CONFIG.read_text()), **cuts, "attention_impl": impl}
    path = root / f"transunet_{impl}_{cuts['max_iter']}.json"
    path.write_text(json.dumps(config))
    return path


def run_transunet_training(dataset: Path, config: Path, log_dir: Path):
    """The training CLI on `config` over the dataset's pairs; returns
    (trainer, CLI seconds, VisionTransformer forward passes)."""
    from synthesis_in_style_tpu_torch.cli import train as cli

    argv = [str(config), "--images", str(dataset / "train.json"),
            "--val-images", str(dataset / "val.json"), "--class-to-color-map", str(COLOR_MAP),
            "-l", str(log_dir), "-ln", "transunet", "-d", DEVICE]
    args = cli.build_parser().parse_args(argv)
    args.log_dir = str(log_dir / "run")
    _sync()
    with _ForwardCounter() as forwards:
        t0 = time.perf_counter()
        trainer = cli.main(args)
        _sync()
        seconds = time.perf_counter() - t0
    return trainer, seconds, forwards.count


def check_transunet_run(trainer, log_dir: Path, impl: str) -> dict:
    """Finite losses, one validation pass, weights moved from the seeded
    init, a snapshot; returns the losses and the snapshot."""
    run = log_dir / "run"
    lines = [json.loads(line) for line in (run / "log.jsonl").read_text().splitlines()]
    losses = {key: [line[f"loss/{key}"] for line in lines if f"loss/{key}" in line]
              for key in ("combined", "CE", "Dice")}
    if not losses["combined"] or not all(math.isfinite(v) for vs in losses.values() for v in vs):
        raise AssertionError(f"TransUNet ({impl}) losses not finite: {losses}")
    evals = [line for line in lines if "evaluation/dice_weighted_avg" in line]
    if len(evals) != 1:
        raise AssertionError(f"TransUNet ({impl}): expected one validation pass, log has "
                             f"{len(evals)}")
    net = trainer.updater.network
    fresh = copy.deepcopy(net).cpu().init_weights(torch.Generator().manual_seed(0))
    moved = sum(not torch.equal(a, b.cpu()) for a, b in zip(fresh.parameters(), net.parameters()))
    if moved == 0:
        raise AssertionError(f"TransUNet ({impl}): no parameter moved")
    snap = run / "checkpoints" / f"iter_{TU_OVERRIDES['max_iter']:08d}.pt"
    if not snap.exists():
        raise AssertionError(f"no snapshot {snap}")
    log(f"TransUNet ({impl}): {moved} of {len(list(fresh.parameters()))} parameter tensors "
        f"moved; losses {losses}; validation {evals[0]}")
    return {"losses": losses, "validation": evals[0], "moved": moved, "snapshot": str(snap)}


def transunet_training(root: Path, dataset: Path, impl: str, fns: dict) -> dict:
    """The shipped config with `attention_impl: impl`: a 2-iteration warm-up
    run (flash only: the same process then runs xla on warm convolutions),
    then TU_OVERRIDES' iterations with one validation pass, launch counts
    from 0 and forward passes counted."""
    if impl == "flash":
        run_transunet_training(dataset, write_transunet_config(root, impl, TU_WARMUP),
                               root / f"tu_{impl}_warmup")
    for fn in fns.values():
        fn.launches = 0
    config = write_transunet_config(root, impl, TU_OVERRIDES)
    trainer, seconds, forwards = run_transunet_training(dataset, config, root / f"tu_{impl}")
    launches = {name: fn.launches for name, fn in fns.items()}
    iters = trainer.updater.iteration
    out = {**check_transunet_run(trainer, root / f"tu_{impl}", impl), "iterations": iters,
           "batch": json.loads(config.read_text())["batch_size"],
           "loop_seconds": trainer.seconds, "cli_seconds": seconds, "forward_passes": forwards,
           "launches": launches}
    out["images_per_s"] = iters * out["batch"] / trainer.seconds
    out["layers"] = layers = len(trainer.updater.network.transformer.encoder.layer)
    if impl == "flash":  # one forward launch a block a pass, one backward a block a step
        want = {"flash_attention_fwd": layers * forwards, "flash_attention_bwd": layers * iters}
    else:
        want = {"flash_attention_fwd": 0, "flash_attention_bwd": 0}
    got = {name: launches[name] for name in want}
    if got != want:
        raise AssertionError(f"TransUNet ({impl}) flash launches {got}, expected {want} "
                             f"({forwards} forward passes, {iters} iterations)")
    settings = json.loads(config.read_text())
    out.update(transunet_step_alone(trainer.updater, out["batch"], settings["image_size"]))
    out["float32_step"] = transunet_float32_step(trainer.updater, out["batch"],
                                                 settings["image_size"], impl, layers, fns)
    log(f"TransUNet training ({impl}, {settings['pretrained_model_name']} "
        f"{settings['image_size']}px, batch {out['batch']}, {settings.get('compute_dtype')}, "
        f"{iters} iterations): {out['images_per_s']:.2f} training images/s (train loop "
        f"{trainer.seconds:.3f} s incl. the validation pass, whole CLI {seconds:.3f} s); "
        f"{forwards} forward passes; launches {launches}; the step alone "
        f"{out['step_s']:.4f} s = {out['step_images_per_s']:.2f} images/s")
    prof = out["step_profile"]
    f32 = out["float32_step"]
    for what, prof in (("", out["step_profile"]), (" in float32", f32["step_profile"])):
        log(f"profiled TransUNet step ({impl}){what}: wall {prof['wall_s']:.4f} s, device busy "
            f"{prof['device_busy_s']:.4f} s ({prof['device_busy_share']:.3f}); top kernels: " +
            "; ".join(f"{k['name']} x{k['calls']} {k['device_s']:.4f} s"
                      for k in prof["top_kernels"]) + "; the port's kernels: " + "; ".join(
                f"{k} x{v['calls']} {v['device_s']:.6f} s"
                for k, v in prof["port_kernels"].items()))
    log(f"TransUNet step alone in float32 ({impl}): {f32['step_s']:.4f} s = "
        f"{f32['step_images_per_s']:.2f} images/s; launches {f32['launches']}; the flash "
        f"kernels' device time in the profiled step {f32['flash_device_s']:.6f} s")
    del trainer
    return out


def transunet_step_alone(updater, batch: int, size: int) -> dict:
    """The training step alone on a seeded batch already on the device:
    TU_TIMED_STEPS synchronized steps after one warm-up, then one under torch.profiler
    (`profile_call`; a no-op stand-in in a CPU rehearsal)."""
    g = torch.Generator().manual_seed(SEED + 19)
    on_card = {"images": (torch.rand((batch, 3, size, size), generator=g) * 2 - 1).to(
                   updater.device).contiguous(memory_format=torch.channels_last),
               "segmented": torch.randint(0, 3, (batch, size, size), generator=g).to(
                   updater.device)}
    updater.step(on_card)
    _sync()
    t0 = time.perf_counter()
    for _ in range(TU_TIMED_STEPS):
        updater.step(on_card)
    _sync()
    step_s = (time.perf_counter() - t0) / TU_TIMED_STEPS
    return {"step_s": step_s, "step_images_per_s": batch / step_s,
            "step_profile": profile_call(lambda: updater.step(on_card))}


def transunet_float32_step(updater, batch: int, size: int, impl: str, layers: int,
                           fns: dict) -> dict:
    """The training step alone with the updater's compute_dtype unset
    (float32 throughout, a setting the JAX package supports; the float32
    flash kernels' backward runs on no other measured path), launch counts
    from 0: `layers` forward and backward flash launches a step with flash,
    none with xla; the flash kernels' device time in the profiled step."""
    saved, updater.compute_dtype = updater.compute_dtype, None
    for fn in fns.values():
        fn.launches = 0
    try:
        out = transunet_step_alone(updater, batch, size)
    finally:
        updater.compute_dtype = saved
    out["launches"] = {name: fn.launches for name, fn in fns.items()}
    steps = TU_TIMED_STEPS + 2  # transunet_step_alone: a warm-up, the timed, one profiled
    want = layers * steps if impl == "flash" else 0
    got = {name: out["launches"][name] for name in ("flash_attention_fwd", "flash_attention_bwd")}
    if got != {"flash_attention_fwd": want, "flash_attention_bwd": want}:
        raise AssertionError(f"TransUNet float32 step ({impl}): flash launches {got}, expected "
                             f"{want} each over {steps} steps")
    out["flash_device_s"] = sum(v["device_s"] for k, v in
                                out["step_profile"].get("port_kernels", {}).items()
                                if k.startswith("flash_"))
    return out


def transunet_page_path(root: Path, snap: Path, pages: Path, pages_gt: Path, fns: dict,
                        layers: int) -> dict:
    """`analyze_image_segments --use-device-component-filter` with the
    TransUNet snapshot (512px patches, batch 8, its config's flash attention)
    over the segmenter phase's pages at 0.7 / 55 (warm-up, then measured
    with launch counts from 0 and forward passes counted); then pages/s of
    the segmenter's segment_image_classes over the pages, warm."""
    sweep = {"min_confidence": ("0.7",), "min_contour_area": ("55",)}
    run_analyze(pages, pages_gt, snap, root / "tu_analyze_warmup", sweep)
    for fn in fns.values():
        fn.launches = 0
    with _ForwardCounter() as forwards:
        cli_seconds = run_analyze(pages, pages_gt, snap, root / "tu_analyze", sweep)
    launches = {name: fn.launches for name, fn in fns.items()}
    scores = check_results(root / "tu_analyze", sweep)
    if launches["flash_attention_fwd"] != layers * forwards.count or forwards.count == 0:
        raise AssertionError(f"TransUNet pages: {launches['flash_attention_fwd']} flash "
                             f"launches for {forwards.count} forward passes")
    if launches["flash_attention_bwd"] or not launches["segmented_cc"]:
        raise AssertionError(f"TransUNet pages: launches {launches}")
    from PIL import Image

    seg = _page_segmenter(snap, DEVICE)
    images = [Image.open(p).convert("RGB") for p in sorted(pages.glob("*.png"))]
    seg.segment_image_classes(images[0])
    _sync()
    t0 = time.perf_counter()
    for image in images:
        seg.segment_image_classes(image)
    _sync()
    rate = len(images) / (time.perf_counter() - t0)
    prof = profile_call(lambda: seg.segment_image_classes(images[0]))
    out = {"cli_seconds": cli_seconds, "cli_pages": NUM_PAGES, "forward_passes": forwards.count,
           "launches": launches, "scores": scores, "pages_per_s": rate,
           "patch": seg.patch_size, "batch": seg.batch_size, "page_profile": prof}
    log(f"TransUNet page inference ({PAGE_W}x{PAGE_H}, patches {seg.patch_size}, batch "
        f"{seg.batch_size}, flash, 0.7 / 55, device filter): {rate:.3f} pages/s "
        f"(segment_image_classes, warm); analyze CLI {NUM_PAGES} pages in {cli_seconds:.3f} s, "
        f"{forwards.count} forward passes; launches {launches}")
    if prof:
        log(f"profiled TransUNet page (float32): wall {prof['wall_s']:.4f} s, device busy "
            f"{prof['device_busy_s']:.4f} s ({prof['device_busy_share']:.3f}); top kernels: " +
            "; ".join(f"{k['name']} x{k['calls']} {k['device_s']:.4f} s"
                      for k in prof["top_kernels"]) + "; the port's kernels: " + "; ".join(
                f"{k} x{v['calls']} {v['device_s']:.6f} s"
                for k, v in prof["port_kernels"].items()))
    del seg
    return out


def transunet_serving(snap: Path, pages: Path, fns: dict, layers: int) -> dict:
    """Fused page inference and bfloat16 serving with the TransUNet
    snapshot over the pages (0.7 / 55, vote assembly, device filter): with
    TF32 off, fused confidences against unfused within 1e-5; the flash
    forward counted where it runs (2 eager warm-ups and every replay of
    each program, `layers` launches a batch of patches); pages/s fused
    float32 and fused bfloat16 (a pass that captures, then one timed); the
    bfloat16 class maps against float32's (>= 0.99, the JAX package's
    gate)."""
    import numpy as np
    from PIL import Image

    images = [Image.open(p).convert("RGB") for p in sorted(pages.glob("*.png"))]
    set_tf32(False)
    try:
        unfused = _serving_segmenter(snap, fused=False)
        want = [unfused.segment_image(image) for image in images]
        _drop(unfused)
        fns["flash_attention_fwd"].launches = 0
        fused = _serving_segmenter(snap, fused=True)
        got = [fused.segment_image(image) for image in images]
        launches = fns["flash_attention_fwd"].launches
        programs = fused.page_programs()
        expected = sum(p.flash_launches_per_replay * (p.replays + (2 if DEVICE == "cuda" else 0))
                       for p in programs)
        per_replay = [p.flash_launches_per_replay for p in programs]
        _drop(fused)
    finally:
        set_tf32(True)
        torch.backends.cuda.matmul.allow_tf32 = False
    fused_err = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    if not fused_err <= 1e-5:
        raise AssertionError(f"TransUNet fused vs unfused pages: {fused_err} > 1e-5")
    if DEVICE == "cuda" and (launches != expected or not all(
            n and n % layers == 0 for n in per_replay)):
        raise AssertionError(f"TransUNet fused pages: {launches} flash launches, expected "
                             f"{expected} (per replay {per_replay})")
    out = {"fused_vs_unfused_max_abs": fused_err, "fused_flash_launches": launches,
           "flash_launches_per_replay": per_replay}
    classes = {}
    for dtype in (None, "bfloat16"):
        seg = _serving_segmenter(snap, fused=True, serving_dtype=dtype)
        _serve(seg, "fused", images)  # captures
        _sync()
        t0 = time.perf_counter()
        classes[dtype] = _serve(seg, "fused", images)
        _sync()
        out[f"fused_{dtype or 'float32'}_pages_per_s"] = len(images) / (time.perf_counter() - t0)
        _drop(seg)
    agree = float(np.mean([np.mean(a == b) for a, b in zip(classes[None], classes["bfloat16"])]))
    if not agree >= 0.99:
        raise AssertionError(f"TransUNet bfloat16 class maps agree on {agree} < 0.99")
    out["bf16_class_agreement"] = agree
    log(f"TransUNet serving (0.7 / 55, device filter): fused vs unfused max abs {fused_err:.3g} "
        f"(TF32 off); flash launches {launches} = (replays + 2 warm-ups) x {per_replay} per "
        f"replay; fused {out['fused_float32_pages_per_s']:.3f} pages/s float32, "
        f"{out['fused_bfloat16_pages_per_s']:.3f} bfloat16; bfloat16 class maps agree with "
        f"float32's on {agree:.5f}")
    return out


def transunet_phase(root: Path, dataset: Path, pages: Path, pages_gt: Path, fns: dict) -> dict:
    """The full-width network card vs CPU, training through the CLI with
    flash and then xla, and page inference with the flash snapshot."""
    steps = Steps()
    network = check_transunet_card_vs_cpu()
    torch.cuda.empty_cache()
    steps.mark("network_card_vs_cpu")
    flash = transunet_training(root, dataset, "flash", fns)
    torch.cuda.empty_cache()
    steps.mark("training_flash")
    xla = transunet_training(root, dataset, "xla", fns)
    torch.cuda.empty_cache()
    steps.mark("training_xla")
    page = transunet_page_path(root, Path(flash["snapshot"]), pages, pages_gt, fns,
                               flash["layers"])
    steps.mark("page_path")
    page["serving"] = transunet_serving(Path(flash["snapshot"]), pages, fns, flash["layers"])
    steps.mark("serving")
    log(f"TransUNet training images/s: flash {flash['images_per_s']:.2f}, xla "
        f"{xla['images_per_s']:.2f}; the float32 step alone: flash "
        f"{flash['float32_step']['step_s']:.4f} s, xla {xla['float32_step']['step_s']:.4f} s")
    return {"network": network, "training_flash": flash,
            "training_xla": xla, "page": page, "seconds": steps.seconds}



# ---------------------------------------------------------------------------
# the shipped swagan_* path: SWAGAN training -> discovery -> labelled
# synthesis -> EMANet training -> EMANet pages

SWAGAN_TRAIN_CONFIG = REPO_ROOT / "configs" / "stylegan" / "swagan_256px.yaml"
SWAGAN_CREATION = REPO_ROOT / "configs" / "dataset_creation" / \
    "swagan_cluster_based_bw_hwp_wpi.json"
SWAGAN_CONFIG = {  # configs/stylegan/swagan_256px.yaml's generator, as JSON
    "image_size": 256, "latent_size": 512, "n_mlp": 8, "channel_multiplier": 2,
    "stylegan_variant": "swagan",
}
SWAGAN_DISCOVERY = (8, 8, (6, 9))  # -n 8 -b 8 -c 6 9
EMANET_CONFIG = REPO_ROOT / "configs" / "segmenter" / "swagan_ema_net_segmenter.yaml"
EMANET_OVERRIDES = {"max_iter": 4, "snapshot_save_iter": 4, "log_iter": 2}
EMANET_WARMUP = {"max_iter": 2, "snapshot_save_iter": 2}
EMANET_CHECK_BATCH = 2


def _launches(fns: dict) -> dict:
    return {name: fn.launches for name, fn in fns.items()}


def _zero(fns: dict) -> None:
    for fn in fns.values():
        fn.launches = 0


def swagan_training(data: Path, root: Path, fns: dict) -> dict:
    """`train_stylegan_2` on the shipped swagan_256px.yaml (bfloat16, its
    regularization) cut to TRAIN_OVERRIDES (batch 16, 4 iterations, a
    snapshot at 4) over the training pages: a warm-up run, a measured run
    with launch counts from 0 (the bias-act forward and backward and the
    blur tail must run) and the bias-act shapes it launched, then one
    iteration under torch.profiler."""
    import yaml

    config = {**yaml.safe_load(SWAGAN_TRAIN_CONFIG.read_text()), **TRAIN_OVERRIDES}
    (data / "swagan_config.json").write_text(json.dumps(config))
    (data / "swagan_config_warmup.json").write_text(json.dumps({**config, **TRAIN_WARMUP}))
    log(f"SWAGAN training: {SWAGAN_TRAIN_CONFIG.name} cut to {TRAIN_OVERRIDES}")
    run_training_cli(data, root / "swagan_train_warmup", config_name="swagan_config_warmup.json")
    _zero(fns)
    fns["fused_bias_act"].shapes.clear()
    trainer, wall = run_training_cli(data, root / "swagan_train", config_name="swagan_config.json")
    launches = _launches(fns)
    shapes = dict(fns["fused_bias_act"].shapes)
    from synthesis_in_style_tpu_torch.models import swagan

    if not isinstance(trainer.updater.state.generator, swagan.Generator):
        raise AssertionError("the swagan config did not train a SWAGAN generator")
    losses = check_training_run(trainer, root / "swagan_train")
    iters = trainer.updater.iteration
    (run,) = (root / "swagan_train" / "stylegan2").iterdir()
    snapshot = run / "checkpoints" / f"iter_{TRAIN_OVERRIDES['max_iter']:08d}.pt"
    profile = profile_iteration(trainer)
    out = {"iterations": iters, "batch": config["batch_size"], "loop_seconds": trainer.seconds,
           "cli_seconds": wall, "images_per_s": iters * config["batch_size"] / trainer.seconds,
           "launches": launches, "losses": losses, "profile": profile,
           "snapshot": str(snapshot), "bias_act_shapes": shapes}
    log(f"SWAGAN training path (256px, batch {config['batch_size']}, bf16, {iters} "
        f"iterations): {out['images_per_s']:.2f} training images/s (train loop "
        f"{trainer.seconds:.3f} s, whole CLI {wall:.3f} s, warm); launches {launches}")
    log(f"profiled SWAGAN iteration {profile['iteration']}: wall {profile['wall_s']:.4f} s, "
        f"device busy {profile['device_busy_s']:.4f} s ({profile['device_busy_share']:.3f}); "
        "top kernels: " + "; ".join(f"{k['name']} x{k['calls']} {k['device_s']:.4f} s"
                                    for k in profile["top_kernels"]) +
        "; the port's kernels: " + "; ".join(f"{k} x{v['calls']} {v['device_s']:.6f} s"
                                             for k, v in profile["port_kernels"].items()))
    return out


def swagan_dataset(root: Path, snapshot: Path, fns: dict) -> dict:
    """Discovery on the SWAGAN snapshot's g_ema (`create_semantic_segmentation
    -n 32 -b 8 -c 6 9`, all 12 wavelet-space layers, launch counts from 0),
    a label map for its k = 8 catalog, the dataset path at batch 2 against
    the CPU (generator, then the device back half bit for bit), and the
    dataset CLI with the shipped swagan creation config (`--device-contours`,
    batch 16, 32 images; a warm-up, then measured with launch counts from
    0)."""
    from synthesis_in_style_tpu_torch.models.factory import load_generator
    from synthesis_in_style_tpu_torch.utils.checkpoint import load_gan_snapshot

    run = root / "swagan_run"
    (run / "config").mkdir(parents=True)
    (run / "checkpoints").mkdir()
    (run / "config" / "config.json").write_text(json.dumps(SWAGAN_CONFIG))
    torch.save({"g_ema": load_gan_snapshot(snapshot)["g_ema"]}, run / "checkpoints" / "g_ema.pt")
    creation = json.loads(SWAGAN_CREATION.read_text())
    size = SWAGAN_CONFIG["image_size"]
    _zero(fns)
    report = run_discovery(run, "semantic_segmentation", sizes=SWAGAN_DISCOVERY)
    discovery_launches = _launches(fns)
    gen = load_generator(run / "checkpoints" / "g_ema.pt", SWAGAN_CONFIG, device=DEVICE)
    shapes = check_discovery_artifacts(run / "semantic_segmentation", gen.num_layers + 1, size,
                                       SWAGAN_DISCOVERY)
    write_catalog(run, gen, SWAGAN_CONFIG, creation)
    del gen
    (run / "creation_config.json").write_text(json.dumps(creation))
    if DEVICE == "cuda":  # with TF32 off, as the StyleGAN2 dataset path's
        set_tf32(False)
        try:
            reference_check(run, SWAGAN_CONFIG, creation)
        finally:
            set_tf32(True)
            torch.backends.cuda.matmul.allow_tf32 = False
    drive_path(run, root / "swagan_images_warmup", creation=creation)
    _zero(fns)
    path = drive_path(run, root / "swagan_images", creation=creation)
    launches = _launches(fns)
    n = check_outputs(root / "swagan_images", size)
    samples, batch, ks = SWAGAN_DISCOVERY
    log(f"SWAGAN discovery (-n {samples} -b {batch} -c {ks[0]} {ks[1]}, {len(shapes)} layers "
        f"{sorted(shapes.items(), key=lambda kv: int(kv[0]))}): generation "
        f"{report['generation_s']:.3f} s, fits {report['fit_s']:.3f} s, whole CLI "
        f"{report['cli_s']:.3f} s; launches {discovery_launches}")
    log(f"SWAGAN dataset path ({creation['keys_for_class_determination']} / "
        f"{creation['keys_for_finegrained_segmentation']}): {path['written']} images in "
        f"{path['seconds']:.3f} s = {path['written'] / path['seconds']:.2f} labelled images/s "
        f"(batch {BATCH}, --device-contours, warm); launches {launches}; {n} PNG pairs")
    return {"discovery": {k: v for k, v in report.items() if k != "fits"},
            "discovery_launches": discovery_launches, "layer_shapes": shapes,
            "written": path["written"], "seconds": path["seconds"],
            "images_per_s": path["written"] / path["seconds"], "launches": launches,
            "dataset": str(root / "swagan_images")}


def write_emanet_config(root: Path, cuts: dict) -> Path:
    """The shipped swagan_ema_net_segmenter.yaml (ResNet-50, stride 8, 256px,
    batch 8, bfloat16) with the cuts, as JSON."""
    import yaml

    path = root / f"emanet_{cuts['max_iter']}.json"
    path.write_text(json.dumps({**yaml.safe_load(EMANET_CONFIG.read_text()), **cuts}))
    return path


class _GradRecorder:
    """Stands in for an optimizer: keeps the gradients by parameter name, in
    float64 on the CPU, and moves nothing. `named` is a network or an
    iterable of (name, parameter)."""

    def __init__(self, named):
        if isinstance(named, torch.nn.Module):
            named = named.named_parameters()
        named = list(named)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.grads = {}

    def step(self, grads):
        self.grads = {n: None if g is None else g.detach().double().cpu()
                      for n, g in zip(self.names, grads)}


def check_emanet_card_vs_cpu() -> dict:
    """One full-width EMANet float32 training step (ResNet-50, stride 8,
    256px, batch 2, TF32 off, dropout off: its draws differ by device) on
    the card and on the CPU from the same weights, µ and batch, both held
    against the same step in float64 on the card: the eval logits (before
    the step) within 1e-4 of max|ref| on both; the gradients, the BatchNorm
    running statistics and the new µ no further from float64 on the card
    than twice the CPU's (plus 1e-6 of max|ref|)."""
    from synthesis_in_style_tpu_torch.models.ema_net import EMANet
    from synthesis_in_style_tpu_torch.updaters.segmentation_updater import emanet_train_step

    g = torch.Generator().manual_seed(SEED + 23)
    base = EMANet(num_classes=3).init_weights(g)
    base.dropout = 0.0
    x = torch.rand((EMANET_CHECK_BATCH, 3, 256, 256), generator=g) * 2 - 1
    labels = torch.randint(0, 3, (EMANET_CHECK_BATCH, 256, 256), generator=g)
    runs = {}
    set_tf32(False)
    try:
        for name, device, dtype in _gate_runs():
            net = copy.deepcopy(base).to(device=device, dtype=dtype)
            with torch.no_grad():
                logits = net.eval()(x.to(device, dtype)).double().cpu()
            rec = _GradRecorder(net)
            emanet_train_step(net, rec, {"images": x.to(device, dtype),
                                         "segmented": labels.to(device)}, em_mom=0.9)
            buffers = {k: v.double().cpu() for k, v in net.state_dict().items()
                       if k.endswith(("running_mean", "running_var")) or k == "emau.mu"}
            runs[name] = {"logits": logits, "grads": rec.grads, "buffers": buffers}
            del net
    finally:
        set_tf32(True)
        torch.backends.cuda.matmul.allow_tf32 = False
    ref = runs["float64"]

    def err(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    out = {}
    for name in ("card", "cpu"):
        got = runs[name]
        if not torch.isfinite(got["logits"]).all():
            raise AssertionError(f"EMANet {name}: non-finite logits")
        grad_errs = {k: err(v, ref["grads"][k]) for k, v in got["grads"].items()
                     if v is not None and ref["grads"][k].abs().max() > 0}
        out[name] = {"logits": err(got["logits"], ref["logits"]),
                     "grads_worst": max(grad_errs.values()),
                     "grads_l2": float(torch.cat([(v - ref["grads"][k]).flatten()
                                                  for k, v in got["grads"].items() if v is not None]
                                                 ).norm() /
                                       torch.cat([v.flatten() for v in ref["grads"].values()
                                                  if v is not None]).norm()),
                     "buffers_worst": max(err(v, ref["buffers"][k])
                                          for k, v in got["buffers"].items()),
                     "mu": err(got["buffers"]["emau.mu"], ref["buffers"]["emau.mu"])}
        if not out[name]["logits"] <= 1e-4:
            raise AssertionError(f"EMANet {name} eval logits vs float64: {out[name]['logits']}")
    if runs["card"]["grads"]["emau.conv1.weight"] is not None:
        raise AssertionError("EMANet: emau.conv1 received a gradient on the card")
    for key in ("grads_worst", "grads_l2", "buffers_worst", "mu"):
        if not out["card"][key] <= 2 * out["cpu"][key] + 1e-6:
            raise AssertionError(f"EMANet step {key}: card {out['card'][key]} vs float64, CPU "
                                 f"{out['cpu'][key]}")
    log(f"EMANet (ResNet-50, stride 8, 256px, batch {EMANET_CHECK_BATCH}) float32 step, TF32 "
        f"off, against float64 on the card: card {out['card']}; CPU {out['cpu']}")
    return out


def emanet_training(root: Path, dataset: Path, fns: dict) -> dict:
    """The training CLI on the shipped EMANet config over the SWAGAN
    dataset's pairs: a 2-iteration warm-up run, then 16 iterations and one
    validation pass with launch counts from 0 (no port kernel runs: the JAX
    package computes EMANet in plain XLA); losses finite, weights and µ
    moved; then the step alone on a batch on the card (10 steps, then one
    under torch.profiler)."""
    from synthesis_in_style_tpu_torch.models.ema_net import EMANet

    run_segmenter_training(dataset, write_emanet_config(root, EMANET_WARMUP),
                           root / "emanet_warmup")
    _zero(fns)
    config = write_emanet_config(root, EMANET_OVERRIDES)
    trainer, cli_seconds = run_segmenter_training(dataset, config, root / "emanet")
    launches = _launches(fns)
    snap = check_segmenter_run(trainer, root / "emanet", EMANET_OVERRIDES["max_iter"])
    net = trainer.updater.network
    if not isinstance(net, EMANet):
        raise AssertionError(f"the EMANet config trained a {type(net).__name__}")
    fresh = EMANet(num_classes=3).init_weights(torch.Generator().manual_seed(0))
    if torch.equal(fresh.emau.mu, net.emau.mu.cpu()):
        raise AssertionError("EMANet: µ did not move")
    settings = json.loads(config.read_text())
    iters, batch = trainer.updater.iteration, settings["batch_size"]
    step = transunet_step_alone(trainer.updater, batch, settings["image_size"])
    out = {"iterations": iters, "batch": batch, "loop_seconds": trainer.seconds,
           "cli_seconds": cli_seconds, "images_per_s": iters * batch / trainer.seconds,
           "launches": launches, "snapshot": str(snap), **step}
    prof = step["step_profile"]
    log(f"EMANet training (ResNet-50, stride 8, {settings['image_size']}px, batch {batch}, "
        f"{settings.get('compute_dtype')}, {iters} iterations): {out['images_per_s']:.2f} "
        f"training images/s (train loop {trainer.seconds:.3f} s incl. the validation pass, "
        f"whole CLI {cli_seconds:.3f} s, warm); launches {launches}; the step alone "
        f"{step['step_s']:.4f} s = {step['step_images_per_s']:.2f} images/s")
    if prof:
        log(f"profiled EMANet step: wall {prof['wall_s']:.4f} s, device busy "
            f"{prof['device_busy_s']:.4f} s ({prof['device_busy_share']:.3f}); top kernels: " +
            "; ".join(f"{k['name']} x{k['calls']} {k['device_s']:.4f} s"
                      for k in prof["top_kernels"]))
    del trainer
    return out


def emanet_pages(root: Path, snap: Path, pages: Path, pages_gt: Path, fns: dict) -> dict:
    """The EMANet snapshot on the segmenter phase's 2048x1536 pages at 0.7 /
    55 with the device filter: `analyze_image_segments` (warm-up, then
    measured with launch counts from 0: CC must run), then with TF32 off
    unfused, fused a page and fused bfloat16 (fused within 1e-5 of unfused;
    bfloat16 class maps against float32's reported), pages/s of each (warm;
    a fused pass that captures first), and one fused float32 page under
    torch.profiler."""
    import numpy as np
    from PIL import Image

    sweep = {"min_confidence": ("0.7",), "min_contour_area": ("55",)}
    run_analyze(pages, pages_gt, snap, root / "emanet_analyze_warmup", sweep)
    _zero(fns)
    cli_seconds = run_analyze(pages, pages_gt, snap, root / "emanet_analyze", sweep)
    launches = _launches(fns)
    scores = check_results(root / "emanet_analyze", sweep)
    images = [Image.open(p).convert("RGB") for p in sorted(pages.glob("*.png"))]
    set_tf32(False)
    try:
        unfused = _serving_segmenter(snap, fused=False)
        want = [unfused.segment_image(image) for image in images]
        _drop(unfused)
        fused = _serving_segmenter(snap, fused=True)
        got = [fused.segment_image(image) for image in images]
        _drop(fused)
    finally:
        set_tf32(True)
        torch.backends.cuda.matmul.allow_tf32 = False
    fused_err = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    if not fused_err <= 1e-5:
        raise AssertionError(f"EMANet fused vs unfused pages: {fused_err} > 1e-5")
    out = {"cli_seconds": cli_seconds, "cli_pages": NUM_PAGES, "launches": launches,
           "scores": scores, "fused_vs_unfused_max_abs": fused_err}
    classes = {}
    for mode, fused_mode, dtype in (("unfused", False, None), ("fused", True, None),
                                    ("fused_bfloat16", True, "bfloat16")):
        seg = _serving_segmenter(snap, fused=fused_mode, serving_dtype=dtype)
        _serve(seg, "fused" if fused_mode else "unfused", images)  # warms, captures
        _sync()
        t0 = time.perf_counter()
        classes[mode] = _serve(seg, "fused" if fused_mode else "unfused", images)
        _sync()
        out[f"{mode}_pages_per_s"] = len(images) / (time.perf_counter() - t0)
        if mode == "fused":
            out["fused_page_profile"] = profile_call(lambda: seg.segment_image_classes(images[0]))
        _drop(seg)
    out["bf16_class_agreement"] = float(np.mean(
        [np.mean(a == b) for a, b in zip(classes["fused"], classes["fused_bfloat16"])]))
    log(f"EMANet page inference ({PAGE_W}x{PAGE_H}, 256-px patches, 0.7 / 55, device filter): "
        f"analyze CLI {NUM_PAGES} pages in {cli_seconds:.3f} s, launches {launches}; "
        f"fused vs unfused max abs {fused_err:.3g} (TF32 off); pages/s unfused "
        f"{out['unfused_pages_per_s']:.3f}, fused {out['fused_pages_per_s']:.3f}, fused "
        f"bfloat16 {out['fused_bfloat16_pages_per_s']:.3f}; bfloat16 class maps agree with "
        f"float32's on {out['bf16_class_agreement']:.5f}")
    prof = out["fused_page_profile"]
    if prof:
        log(f"profiled fused EMANet page: wall {prof['wall_s']:.4f} s, device busy "
            f"{prof['device_busy_s']:.4f} s ({prof['device_busy_share']:.3f}); top kernels: " +
            "; ".join(f"{k['name']} x{k['calls']} {k['device_s']:.4f} s"
                      for k in prof["top_kernels"]) + "; the port's kernels: " + "; ".join(
                f"{k} x{v['calls']} {v['device_s']:.6f} s"
                for k, v in prof["port_kernels"].items()))
    return out


def swagan_emanet_phase(root: Path, train_pages: Path, pages: Path, pages_gt: Path,
                        fns: dict, detail: dict) -> dict:
    """The shipped swagan_* configurations end to end: SWAGAN training, the
    bias-act forward at the (shape, dtype)s it launched, discovery and the
    dataset CLI on its snapshot, EMANet card vs CPU, EMANet training on the
    dataset's pairs, EMANet pages."""
    marks = [time.perf_counter()]
    training = swagan_training(train_pages, root, fns)
    training["fused_bias_act_shapes"] = check_fused_bias_act_path_shapes(
        detail["fused_bias_act_path_shapes_swagan"], training.pop("bias_act_shapes"),
        training["iterations"])
    marks.append(time.perf_counter())
    dataset = swagan_dataset(root, Path(training["snapshot"]), fns)
    marks.append(time.perf_counter())
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    network = check_emanet_card_vs_cpu()
    marks.append(time.perf_counter())
    emanet = emanet_training(root, Path(dataset["dataset"]), fns)
    marks.append(time.perf_counter())
    emanet["pages"] = emanet_pages(root, Path(emanet["snapshot"]), pages, pages_gt, fns)
    marks.append(time.perf_counter())
    emanet["card_vs_cpu"] = network
    seconds = dict(zip(("swagan_training", "swagan_dataset", "emanet_card_vs_cpu",
                        "emanet_training", "emanet_pages"),
                       (b - a for a, b in zip(marks, marks[1:]))))
    log("swagan_* phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return {"training": training, "dataset": dataset, "emanet": emanet, "seconds": seconds}


# ---------------------------------------------------------------------------
# the DatasetGAN branch: activation dataset, PixelEnsemble training, DatasetGAN
# dataset synthesis


DATASET_GAN_YAML = REPO_ROOT / "configs" / "dataset_creation" / "dataset_gan_wpi_stylegan2.yaml"
DATASET_GAN_SWAGAN_YAML = REPO_ROOT / "configs" / "dataset_creation" / \
    "dataset_gan_wpi_swagan.yaml"
DATASET_GAN_CREATION = REPO_ROOT / "configs" / "dataset_creation" / \
    "stylegan2_dataset_gan_bw_hwp_wpi.json"
# the activation CLI's -n, -b: 4 train and 1 test image (10 until the script
# grew: its zlib tensors.npz write, ~6 s an image, set the phase's time)
DATASET_GAN_IMAGES = (3, 3)
DATASET_GAN_ITERATIONS = (500, 250)  # the generate: true run, and its forced epoch
DATASET_GAN_SHORT = 50  # iterations of the generate: false run
DATASET_GAN_SWAGAN = (4, 20)  # SWAGAN: the activation CLI's -n (and -b), iterations
DATASET_GAN_SYNTHESIS = (32, 16)  # the dataset CLI's -n, -b (after a warm-up at -n b)
DATASET_GAN_CHECK_IMAGES = 2  # images of the class map card vs CPU
DATASET_GAN_STEP_TOLERANCE = 1e-5  # the ensemble step card vs CPU, of max|ref|
DATASET_GAN_MAP_AGREEMENT = 0.999  # share of class-map pixels card vs CPU
DATASET_GAN_CUTS = {}  # a CPU rehearsal shrinks the training configs' image_size here


def _gan_config(snapshot: Path) -> dict:
    from synthesis_in_style_tpu_torch.core.config import load_config_from_checkpoint

    return load_config_from_checkpoint(snapshot)


def _reset_peak() -> None:
    """Peak memory counted from here, with what earlier runs left freed."""
    import gc

    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _peak_reserved_gb() -> float:
    return torch.cuda.max_memory_reserved() / 1e9 if DEVICE == "cuda" else 0.0


def _count_from_zero(fns: dict) -> None:
    """Launch counts from 0, the generator kernels' shape counters cleared."""
    _zero(fns)
    for name in ("fused_bias_act", "fused_blur"):
        fns[name].shapes.clear()


def _path_shapes(fns: dict) -> dict:
    return {name: dict(fns[name].shapes) for name in ("fused_bias_act", "fused_blur")}


def check_path_kernels(path: str, shapes: dict) -> list:
    """The bias-act forward and the blur tail at every (shape, dtype) the
    path launched, each against its plain version on random inputs of that
    shape (the bias-act forward within BIAS_ACT_TOLERANCES; the blur tail
    within 1e-4 in float32 and 2^-7 x max|ref| in bfloat16, as at its main
    shapes); the blur rows with the kernel's and the plain version's ms."""
    from synthesis_in_style_tpu_torch.ops.cuda.fused_blur import (
        blur_demod_noise_bias_act_cuda,
        blur_demod_noise_bias_act_plain,
    )

    if DEVICE != "cuda":
        return []
    tols = dict(BIAS_ACT_TOLERANCES)
    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    rows = []
    for (shape, dtype), launches in shapes["fused_bias_act"].items():
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        b = torch.randn(shape[-1], generator=g, device="cuda").to(dtype)
        err, _ = _check_forward(f"{path} {shape} {dtype}", x, b, tols[dtype])
        rows.append({"kernel": "fused_bias_act", "shape": list(shape),
                     "dtype": str(dtype).split(".")[-1], "launches": launches,
                     "max_abs_err": err})
    for (shape, dtype), launches in shapes["fused_blur"].items():
        batch, side, _, c = shape
        args = (torch.randn(shape, generator=g, device="cuda").to(dtype),
                torch.rand((batch, c), generator=g, device="cuda") + 0.5,
                torch.randn((batch, side - 1, side - 1), generator=g, device="cuda"),
                torch.randn((c,), generator=g, device="cuda"))
        got = blur_demod_noise_bias_act_cuda(*args).float()
        ref = blur_demod_noise_bias_act_plain(*args).float()
        err = (got - ref).abs().max().item()
        limit = 1e-4 if dtype == torch.float32 else 2.0**-7 * ref.abs().max().item()
        if not err <= limit:
            raise AssertionError(f"fused_blur on the {path} path, {shape} {dtype}: "
                                 f"err {err} > {limit}")
        rows.append({"kernel": "fused_blur", "shape": list(shape),
                     "dtype": str(dtype).split(".")[-1], "launches": launches,
                     "max_abs_err": err,
                     "ms": bench_ms(lambda: blur_demod_noise_bias_act_cuda(*args)),
                     "plain_ms": bench_ms(lambda: blur_demod_noise_bias_act_plain(*args))})
    worst = {k: max([r["max_abs_err"] for r in rows if r["kernel"] == k] or [0.0])
             for k in ("fused_bias_act", "fused_blur")}
    log(f"{path}: the bias-act forward at {len(shapes['fused_bias_act'])} and the blur tail at "
        f"{len(shapes['fused_blur'])} (shape, dtype)s against their plain versions, worst "
        f"errors {worst}")
    return rows


def write_hand_labels(directory: Path, entries: list, size: int) -> None:
    """Seeded rectangles of the two text classes' colours on background as
    each entry's hand label (tests/test_dataset_gan.py paints a square)."""
    import numpy as np

    from synthesis_in_style_tpu_torch.utils.png import write_png

    rs = np.random.default_rng(SEED + 21)
    for entry in entries:
        label = np.zeros((size, size, 3), np.uint8)
        for color in ((0, 0, 255), (255, 0, 0)):
            for _ in range(3):
                y, x = rs.integers(0, size * 3 // 4, 2)
                h, w = rs.integers(size // 16, size // 4, 2)
                label[y:y + h, x:x + w] = color
        write_png(directory / entry["label"], label)


def run_activation_cli(snapshot: Path, out: Path, n: int, batch: int,
                       activations: bool = True) -> dict:
    """`create_dataset_for_activation_classification` on DEVICE (`-n n -b
    batch --save-latents -ge`, with `--save-activations`): its seconds and
    those of its tensors.npz write."""
    import numpy as np

    from synthesis_in_style_tpu_torch.cli import (
        create_dataset_for_activation_classification as cdac,
    )

    argv = [str(snapshot), str(out), "-n", str(n), "-b", str(batch), "--save-latents", "-ge",
            "-d", DEVICE] + (["--save-activations"] if activations else [])
    original, npz = np.savez_compressed, []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        original(*args, **kwargs)
        npz.append(time.perf_counter() - t0)

    np.savez_compressed = timed
    try:
        _sync()
        t0 = time.perf_counter()
        cdac.main(cdac.build_parser().parse_args(argv))
        _sync()
        seconds = time.perf_counter() - t0
    finally:
        np.savez_compressed = original
    entries = json.loads((out / "full_data.json").read_text())
    train = json.loads((out / "train.json").read_text())
    if len(entries) != n or len(train) != int(n * 0.8):
        raise AssertionError(f"activation CLI: {len(entries)} entries, {len(train)} train")
    return {"seconds": seconds, "npz_seconds": npz[0], "images_per_s": n / seconds,
            "npz_mb": (out / "tensors.npz").stat().st_size / 1e6, "entries": entries}


def dataset_gan_config(root: Path, source: Path, acts: Path, snapshot: Path, name: str,
                       **cuts) -> Path:
    """The shipped training yaml with the three keys it lacks filled in
    (num_classes; tensor_path and checkpoint are null there) and the cuts,
    as JSON."""
    import yaml

    config = {**yaml.safe_load(source.read_text()), "num_classes": 3,
              "tensor_path": str(acts / "tensors.npz"), "checkpoint": str(snapshot),
              **DATASET_GAN_CUTS, **cuts}
    path = root / f"{name}.json"
    path.write_text(json.dumps(config))
    return path


class _forced_epoch:
    """The DatasetGAN datasets' length cut to `iterations` batches, so that
    the pixel stream's epoch passes 1 after that many iterations (the real
    epoch is N x 65536 / batch: 131072 iterations at N = 8, batch 4)."""

    def __init__(self, iterations: int, batch: int):
        self.pixels = iterations * batch

    def __enter__(self):
        from synthesis_in_style_tpu_torch.data.dataset_gan_dataset import BaseDatasetGANDataset

        self.cls, self.original = BaseDatasetGANDataset, BaseDatasetGANDataset.__len__
        self.cls.__len__ = lambda dataset: self.pixels
        return self

    def __exit__(self, *exc):
        self.cls.__len__ = self.original


class _timed_resets:
    """Seconds (synchronized) of every reset_dataset call, by manifest."""

    def __init__(self):
        self.seconds = []

    def __enter__(self):
        from synthesis_in_style_tpu_torch.data.dataset_gan_dataset import (
            DatasetGANGenerationDataset,
        )

        self.cls, original = DatasetGANGenerationDataset, \
            DatasetGANGenerationDataset.reset_dataset
        self.original = original

        def timed(dataset):
            _sync()
            t0 = time.perf_counter()
            original(dataset)
            _sync()
            self.seconds.append((dataset.json_path.name, time.perf_counter() - t0))

        self.cls.reset_dataset = timed
        return self

    def __exit__(self, *exc):
        self.cls.reset_dataset = self.original


def run_dataset_gan_training(config: Path, acts: Path, log_dir: Path):
    """`train` on DEVICE with the activation CLI's train.json / test.json."""
    from synthesis_in_style_tpu_torch.cli import train

    args = train.build_parser().parse_args(
        [str(config), "--images", str(acts / "train.json"), "--val-images",
         str(acts / "test.json"), "--class-to-color-map", str(COLOR_MAP), "-d", DEVICE])
    args.log_dir = str(log_dir)
    _sync()
    t0 = time.perf_counter()
    trainer = train.main(args)
    _sync()
    return trainer, time.perf_counter() - t0


def check_dataset_gan_run(trainer, log_dir: Path, iterations: int) -> dict:
    """Every member's loss finite, the dice in [0, 1], the last snapshot
    with every member and optimizer state."""
    lines = [json.loads(line) for line in (log_dir / "log.jsonl").read_text().splitlines()]
    members = trainer.updater.ensemble.num_models
    losses = {f"loss/CrossEntropyLoss_network_{i}": [l[f"loss/CrossEntropyLoss_network_{i}"]
                                                    for l in lines
                                                    if f"loss/CrossEntropyLoss_network_{i}" in l]
              for i in range(members)}
    if not all(v and all(math.isfinite(x) for x in v) for v in losses.values()):
        raise AssertionError(f"DatasetGAN losses not all finite: {losses}")
    dice = [l["evaluation/Dice Score"] for l in lines if "evaluation/Dice Score" in l]
    if not dice or not all(0.0 <= d <= 1.0 for d in dice):
        raise AssertionError(f"DatasetGAN dice {dice}")
    snapshot = log_dir / "checkpoints" / f"iter_{iterations:08d}.pt"
    keys = sorted(torch.load(snapshot, weights_only=True))
    want = sorted([f"network_{i}" for i in range(members)] +
                  [f"optimizer_{i}" for i in range(members)] + ["iteration"])
    if keys != want:
        raise AssertionError(f"snapshot {snapshot.name}: {keys}")
    return {"first_losses": {k: v[0] for k, v in losses.items()},
            "last_losses": {k: v[-1] for k, v in losses.items()}, "dice": dice,
            "snapshot": str(snapshot)}


def ensemble_step_alone(updater, steps: int = 50) -> dict:
    """The ensemble step on one batch already on the card: ms a step over
    `steps` synchronized steps, then one step under torch.profiler."""
    from synthesis_in_style_tpu_torch.updaters.dataset_gan_updater import ensemble_train_step

    batch = next(updater.iterators["feature_vectors"])

    def step():
        ensemble_train_step(updater.ensemble, updater.optimizer, batch)

    for _ in range(5):
        step()
    _sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    _sync()
    out = {"step_ms": (time.perf_counter() - t0) * 1e3 / steps}
    if DEVICE == "cuda":
        out["profile"] = profile_call(step, top=6)
    return out


def ensemble_step_card_vs_cpu(updater, dataset) -> dict:
    """One ensemble step from the same state (the trained members and a copy
    of their Adam state) on the same batch of 4 pixels, on the card and on
    the CPU, TF32 off: every parameter within DATASET_GAN_STEP_TOLERANCE of
    the largest parameter, every BatchNorm statistic of the largest
    statistic (the CPU's), and the losses."""
    import copy

    from synthesis_in_style_tpu_torch.updaters.dataset_gan_updater import (
        EnsembleOptimizer,
        ensemble_train_step,
    )

    batch = next(dataset.sample_pixel_batches(4, SEED + 22))
    cpu = copy.deepcopy(updater.ensemble).cpu()
    group = updater.optimizer.adam.param_groups[0]
    optimizer = EnsembleOptimizer(cpu, group["lr"], group["betas"], group["weight_decay"])
    # a copy: load_state_dict keeps the tensors it can (Adam's step counts)
    optimizer.adam.load_state_dict(copy.deepcopy(updater.optimizer.adam.state_dict()))
    set_tf32(False)
    card_losses = ensemble_train_step(updater.ensemble, updater.optimizer, batch)
    cpu_losses = ensemble_train_step(cpu, optimizer, {k: v.cpu() for k, v in batch.items()})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    ref = cpu.state_dict()
    got = {k: v.cpu() for k, v in updater.ensemble.state_dict().items()}
    out = {"losses_err": (card_losses.cpu() - cpu_losses).abs().max().item()}
    for kind, keys in (("parameters", [k for k in ref if "running" not in k]),
                       ("statistics", [k for k in ref if "running" in k])):
        scale = max(ref[k].abs().max().item() for k in keys)
        errs = {k: (got[k] - ref[k]).abs().max().item() for k in keys}
        worst = max(errs, key=errs.get)
        out[kind] = {"worst": worst, "err_of_max": errs[worst] / scale}
        if not errs[worst] <= DATASET_GAN_STEP_TOLERANCE * scale:
            raise AssertionError(f"ensemble step card vs CPU: {kind} {worst} "
                                 f"{errs[worst] / scale} of max|ref|")
    if not out["losses_err"] <= DATASET_GAN_STEP_TOLERANCE * cpu_losses.abs().max().item():
        raise AssertionError(f"ensemble step card vs CPU: losses {card_losses} vs {cpu_losses}")
    return out


def run_dataset_gan_cli(snapshot: Path, classifier: Path, out: Path, n: int, batch: int) -> dict:
    """The dataset CLI with the shipped DatasetGAN creation config and the
    ensemble: build_dataset timed, then the split and coco_gt.json; all n
    images written (the segmenter drops none)."""
    from synthesis_in_style_tpu_torch.cli import create_dataset_for_segmentation as cds

    args = cds.build_parser().parse_args(
        [str(snapshot), str(DATASET_GAN_CREATION), "-n", str(n), "-b", str(batch),
         "--classifier-path", str(classifier), "-s", str(out), "-d", DEVICE])
    _sync()
    t0 = time.perf_counter()
    written = cds.build_dataset(args, json.loads(DATASET_GAN_CREATION.read_text()))
    _sync()
    seconds = time.perf_counter() - t0
    args.only_create_train_val_split = True
    cds.main(args)
    if written != n or not (out / "coco_gt.json").exists():
        raise AssertionError(f"DatasetGAN dataset CLI: {written} of {n} written")
    return {"written": written, "seconds": seconds, "images_per_s": written / seconds}


def write_seeded_ensemble(path: Path, features: int) -> Path:
    """A 3-member, 3-class ensemble from a seeded torch.Generator as a
    snapshot: its votes mix the classes, where the trained ensemble's (on
    labels that the random-weight generator's activations cannot predict)
    are background almost everywhere."""
    from synthesis_in_style_tpu_torch.models.pixel_classifier import PixelEnsembleClassifier
    from synthesis_in_style_tpu_torch.utils.checkpoint import save_pixel_ensemble_snapshot

    ensemble = PixelEnsembleClassifier(3, features, 3)
    ensemble.init_weights(torch.Generator().manual_seed(SEED + 24))
    save_pixel_ensemble_snapshot(path, [ensemble.member_state_dict(i) for i in range(3)], [], 0)
    return path


def class_map_card_vs_cpu(snapshot: Path, classifier: Path, mixed: bool = False) -> dict:
    """The DatasetGAN segmenter on the card and on the CPU (TF32 off) on the
    same activations of DATASET_GAN_CHECK_IMAGES generated images: the share
    of pixels whose class agrees (votes flip only at float32 near-ties), and
    each class's share of the card's map; with `mixed`, at least two classes
    must hold 1 % of it each (else the agreement says little)."""
    import numpy as np

    from synthesis_in_style_tpu_torch.models.factory import load_generator
    from synthesis_in_style_tpu_torch.segmentation.dataset_gan_segmenter import (
        DatasetGANSegmenter,
    )
    from synthesis_in_style_tpu_torch.utils.dataset_creation import make_generate_fn

    config = _gan_config(snapshot)
    creation = json.loads(DATASET_GAN_CREATION.read_text())
    z = torch.randn((DATASET_GAN_CHECK_IMAGES, config.get("latent_size", 512)),
                    generator=torch.Generator().manual_seed(SEED + 23)).to(DEVICE)
    common = dict(base_dir=snapshot.parent, image_size=config["image_size"],
                  class_to_color_map=creation["class_to_color_map"], classifier_path=classifier)
    set_tf32(False)
    try:
        activations, _ = make_generate_fn(load_generator(snapshot, config, device=DEVICE))(z)
        card, _ = DatasetGANSegmenter(device=DEVICE, **common).create_segmentation_image(
            activations)
        cpu, _ = DatasetGANSegmenter(device="cpu", **common).create_segmentation_image(
            {k: v.cpu() for k, v in activations.items()})
    finally:
        set_tf32(True)
        torch.backends.cuda.matmul.allow_tf32 = False
    agreement = float(np.mean(np.all(card == cpu, axis=-1)))
    colors = {name: tuple(int(creation["class_to_color_map"][name][i:i + 2], 16)
                          for i in (1, 3, 5)) for name in creation["class_to_color_map"]}
    shares = {name: float(np.mean(np.all(card == color, axis=-1)))
              for name, color in colors.items()}
    if not agreement >= DATASET_GAN_MAP_AGREEMENT:
        raise AssertionError(f"DatasetGAN class map card vs CPU: {agreement} of pixels agree")
    if mixed and sum(share >= 0.01 for share in shares.values()) < 2:
        raise AssertionError(f"DatasetGAN class map of {classifier.name}: one class, {shares}")
    return {"agreement": agreement, "class_shares": shares}


def dataset_gan_swagan(root: Path, snapshot: Path, fns: dict) -> dict:
    """A few iterations of the shipped dataset_gan_wpi_swagan.yaml (filled
    in, generate: true) on the SWAGAN snapshot, on latents from the
    activation CLI; the ensemble's feature length is read from SWAGAN's
    activations."""
    n, iterations = DATASET_GAN_SWAGAN
    acts = root / "dataset_gan_swagan_acts"
    act = run_activation_cli(snapshot, acts, n, n, activations=False)
    write_hand_labels(acts, act["entries"], _gan_config(snapshot)["image_size"])
    config = dataset_gan_config(root, DATASET_GAN_SWAGAN_YAML, acts, snapshot,
                                "dataset_gan_swagan", max_iter=iterations,
                                snapshot_save_iter=iterations, image_save_iter=iterations,
                                log_iter=10)
    _reset_peak()
    _zero(fns)
    trainer, wall = run_dataset_gan_training(config, acts, root / "dataset_gan_swagan_logs")
    out = {"features": trainer.updater.ensemble.dim, "seconds": wall,
           "launches": _launches(fns), "peak_reserved_gb": _peak_reserved_gb(),
           **check_dataset_gan_run(trainer, root / "dataset_gan_swagan_logs", iterations)}
    log(f"DatasetGAN on SWAGAN ({DATASET_GAN_SWAGAN_YAML.name}, generate: true, "
        f"{iterations} iterations): F = {out['features']}, whole CLI {wall:.3f} s, dice "
        f"{out['dice']}, peak reserved {out['peak_reserved_gb']:.2f} GB; launches "
        f"{out['launches']}")
    return out


def dataset_gan_phase(root: Path, gan_snapshot: Path, swagan_snapshot: Path, fns: dict) -> dict:
    """The DatasetGAN branch on the training phase's StyleGAN2 snapshot:
    the activation CLI, hand labels, PixelEnsemble training with generate:
    true (a forced epoch crossing regenerates the set) and false, the
    ensemble step alone and card vs CPU, the dataset CLI with its snapshot
    and the class map card vs CPU; then a few iterations on SWAGAN. The
    three paths (activations, training, dataset) run with launch counts
    from 0, their bias-act and blur shapes held against the plain
    versions."""
    from synthesis_in_style_tpu_torch.data.dataset_gan_dataset import DatasetGANDataset

    marks = [time.perf_counter()]
    size = _gan_config(gan_snapshot)["image_size"]
    n, batch = DATASET_GAN_IMAGES
    acts = root / "dataset_gan_acts"
    _reset_peak()
    _count_from_zero(fns)
    activations = run_activation_cli(gan_snapshot, acts, n, batch)
    activations.update(launches=_launches(fns), peak_reserved_gb=_peak_reserved_gb())
    activations["path_kernels"] = check_path_kernels("dataset_gan_activations",
                                                     _path_shapes(fns))
    write_hand_labels(acts, activations.pop("entries"), size)
    log(f"DatasetGAN activation CLI (-n {n} -b {batch}, --save-activations): "
        f"{activations['images_per_s']:.3f} images/s (whole CLI {activations['seconds']:.3f} s, "
        f"of it the tensors.npz write {activations['npz_seconds']:.3f} s, "
        f"{activations['npz_mb']:.1f} MB); launches {activations['launches']}")
    marks.append(time.perf_counter())

    iterations, epoch = DATASET_GAN_ITERATIONS
    config = dataset_gan_config(root, DATASET_GAN_YAML, acts, gan_snapshot,
                                "dataset_gan_generate", max_iter=iterations,
                                snapshot_save_iter=iterations, image_save_iter=iterations,
                                log_iter=50)
    ensemble_batch = json.loads(config.read_text())["batch_size"]
    _reset_peak()
    _count_from_zero(fns)
    with _forced_epoch(epoch, ensemble_batch), _timed_resets() as resets:
        trainer, wall = run_dataset_gan_training(config, acts, root / "dataset_gan_logs")
    training = {"launches": _launches(fns), "peak_reserved_gb": _peak_reserved_gb(),
                "cli_seconds": wall, "loop_seconds": trainer.seconds,
                "iterations": trainer.updater.iteration,
                "iterations_per_s": trainer.updater.iteration / trainer.seconds,
                "features": trainer.updater.ensemble.dim, "resets": resets.seconds,
                **check_dataset_gan_run(trainer, root / "dataset_gan_logs", iterations)}
    training["path_kernels"] = check_path_kernels("dataset_gan_training", _path_shapes(fns))
    crossings = [name for name, _ in resets.seconds]
    if crossings != ["train.json", "test.json", "train.json"]:
        raise AssertionError(f"DatasetGAN training: resets {crossings} (want construction of "
                             "train and test, then the crossing)")
    training.update(ensemble_step_alone(trainer.updater))
    training["card_vs_cpu"] = ensemble_step_card_vs_cpu(
        trainer.updater, trainer.updater.iterators["feature_vectors"].dataset)
    log(f"DatasetGAN training ({DATASET_GAN_YAML.name} filled in, generate: true, batch "
        f"{ensemble_batch} pixels, F = {training['features']}, {iterations} iterations, an "
        f"epoch forced to {epoch}): {training['iterations_per_s']:.2f} iterations/s (train loop "
        f"{trainer.seconds:.3f} s, whole CLI {wall:.3f} s), the step alone "
        f"{training['step_ms']:.4f} ms, regeneration {resets.seconds} s, dice "
        f"{training['dice']}, peak reserved {training['peak_reserved_gb']:.2f} GB; launches "
        f"{training['launches']}")
    if "profile" in training:
        prof = training["profile"]
        log(f"profiled ensemble step: wall {prof['wall_s']:.6f} s, device busy "
            f"{prof['device_busy_s']:.6f} s ({prof['device_busy_share']:.3f}); top kernels: "
            + "; ".join(f"{k['name']} x{k['calls']} {k['device_s']:.6f} s"
                        for k in prof["top_kernels"]))
    log(f"ensemble step card vs CPU (TF32 off): {training['card_vs_cpu']}")
    classifier = Path(training["snapshot"])
    del trainer
    marks.append(time.perf_counter())

    _reset_peak()
    config = dataset_gan_config(root, DATASET_GAN_YAML, acts, gan_snapshot, "dataset_gan_stored",
                                generate=False, max_iter=DATASET_GAN_SHORT,
                                snapshot_save_iter=DATASET_GAN_SHORT,
                                image_save_iter=DATASET_GAN_SHORT, log_iter=10)
    trainer, wall = run_dataset_gan_training(config, acts, root / "dataset_gan_stored_logs")
    if not isinstance(trainer.updater.iterators["feature_vectors"].dataset, DatasetGANDataset):
        raise AssertionError("generate: false did not read the stored activations")
    stored = {"cli_seconds": wall, "loop_seconds": trainer.seconds,
              "iterations_per_s": trainer.updater.iteration / trainer.seconds,
              "peak_reserved_gb": _peak_reserved_gb(),
              **check_dataset_gan_run(trainer, root / "dataset_gan_stored_logs",
                                      DATASET_GAN_SHORT)}
    del trainer
    log(f"DatasetGAN training, generate: false ({DATASET_GAN_SHORT} iterations on the stored "
        f"tensors.npz): whole CLI {wall:.3f} s (reading and upsampling the stored activations "
        f"in), {stored['iterations_per_s']:.2f} iterations/s, dice {stored['dice']}, peak "
        f"reserved {stored['peak_reserved_gb']:.2f} GB")
    marks.append(time.perf_counter())

    n, batch = DATASET_GAN_SYNTHESIS
    run_dataset_gan_cli(gan_snapshot, classifier, root / "dataset_gan_warmup", batch, batch)
    _reset_peak()
    _count_from_zero(fns)
    images = root / "dataset_gan_images"
    dataset = run_dataset_gan_cli(gan_snapshot, classifier, images, n, batch)
    dataset.update(launches=_launches(fns), peak_reserved_gb=_peak_reserved_gb())
    if check_outputs(images, size) != n:
        raise AssertionError("DatasetGAN dataset CLI: PNG pairs other than written")
    dataset["path_kernels"] = check_path_kernels("dataset_gan_dataset", _path_shapes(fns))
    seeded = write_seeded_ensemble(root / "dataset_gan_seeded.pt", training["features"])
    dataset["class_map_card_vs_cpu"] = {
        "trained": class_map_card_vs_cpu(gan_snapshot, classifier),
        "seeded": class_map_card_vs_cpu(gan_snapshot, seeded, mixed=True)}
    log(f"DatasetGAN dataset CLI ({DATASET_GAN_CREATION.name}, -n {n} -b {batch}): "
        f"{dataset['written']} images in {dataset['seconds']:.3f} s = "
        f"{dataset['images_per_s']:.2f} labelled images/s (warm), peak reserved "
        f"{dataset['peak_reserved_gb']:.2f} GB; launches {dataset['launches']}; class map card "
        f"vs CPU {dataset['class_map_card_vs_cpu']}")
    marks.append(time.perf_counter())

    swagan = dataset_gan_swagan(root, swagan_snapshot, fns)
    marks.append(time.perf_counter())
    seconds = dict(zip(("activations", "training", "training_stored", "dataset", "swagan"),
                       (b - a for a, b in zip(marks, marks[1:]))))
    log("dataset_gan phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()) +
        f"; whole phase {marks[-1] - marks[0]:.1f}")
    return {"activations": activations, "training": training, "stored": stored,
            "dataset": dataset, "swagan": swagan, "seconds": seconds}


AE_STEP_BATCH = 2  # the autoencoder step card vs CPU
AE_RATE = (4, 8)  # autoencoder training: iterations, batch
ADV_RATE = (4, 8)  # the adversarial CLI: iterations, batch
ADV_V1 = (2, 4)  # the adversarial CLI with stylegan_variant 1: iterations, batch
PROJECTION = (4, 50, 50)  # run_image_reconstruction: images, w+ steps, noise steps
PROJECTION_CHECK_STEPS = 3  # steps of each stage held card vs CPU
ANALYZE_IMAGES = 8
AE_DISCOVERY = (8, 8, (6, 8))  # -i discovery's -n, -b, -c
AE_CUTS = {}  # a CPU rehearsal shrinks the autoencoder configs' sizes here
# how far beyond twice the CPU a gradient tensor on the card may sit from
# float64 (`_grad_errors`): AE_GRAD_TOL of the step's largest gradient, capped
# at AE_GRAD_OWN of the tensor's own, floored at AE_GRAD_FLOOR of the step's
AE_GRAD_TOL, AE_GRAD_OWN, AE_GRAD_FLOOR = 1e-3, 5e-2, 1e-6
AUTOENCODER_LEGS = ("ae_training", "adversarial", "adversarial_v1", "projection",
                    "analyze_latent_code", "discovery_images")


def _grad_errors(what: str, runs: dict) -> dict:
    """Gradients of one step from three runs on the same inputs: float32 on
    the card ("card") and on the CPU ("cpu"), and float64 on the card
    ("float64"). The float32 step itself can be ill-conditioned (an
    encoder's first convolutions feed train-mode BatchNorm at 256px, where
    the batch mean cancels most of their gradient: float32 sits up to ~4 %
    of a tensor's largest gradient from float64 there, on either device),
    and a ReLU or LeakyReLU tie (a pre-activation within float32 rounding
    of 0) that one device breaks the other way moves a small tensor by a
    few % of itself. So each tensor is held as the EMANet step is, the
    card no further from float64 than twice the CPU, plus an allowance:
    AE_GRAD_TOL of the step's largest gradient, but no more than
    AE_GRAD_OWN of the tensor's own largest (a defect moves a tensor by a
    good part of itself), and no less than AE_GRAD_FLOOR of the step's
    largest (float32's resolution of the step: a bias in front of
    train-mode BatchNorm has a gradient that is zero in exact arithmetic).
    Every failing tensor is named; the summary gives each run's worst
    tensor, the tightest tensor (card error over its bound) and every
    tensor's row."""
    ref = runs["float64"]
    names = [n for n, g in ref.items() if g is not None]
    missing = [n for n in ref if any((runs[k][n] is None) != (ref[n] is None)
                                     for k in ("card", "cpu"))]
    if missing:
        raise AssertionError(f"{what}: gradient in some runs only for {missing[:4]}")
    scale = max(ref[n].abs().max().item() for n in names)
    if not scale > 0:
        raise AssertionError(f"{what}: every gradient is zero")
    rows, worst = {}, {"card": (0.0, ""), "cpu": (0.0, ""), "card_vs_cpu": (0.0, ""),
                       "tightest": (0.0, "")}
    for n in names:
        exact = ref[n].cpu().double()
        card, cpu = runs["card"][n].cpu().double(), runs["cpu"][n].cpu().double()
        own = exact.abs().max().item()
        row = {"max_ref": own, "card": (card - exact).abs().max().item(),
               "cpu": (cpu - exact).abs().max().item(),
               "card_vs_cpu": (card - cpu).abs().max().item()}
        row["bound"] = 2 * row["cpu"] + max(AE_GRAD_FLOOR * scale,
                                            min(AE_GRAD_TOL * scale, AE_GRAD_OWN * own))
        rows[n] = row
        for key in ("card", "cpu", "card_vs_cpu"):
            worst[key] = max(worst[key], (row[key] / scale, n))
        worst["tightest"] = max(worst["tightest"], (row["card"] / row["bound"], n))
    failed = [n for n, row in rows.items() if not row["card"] <= row["bound"]]
    if failed:
        raise AssertionError(f"{what}: the card from float64 beyond its bound at {len(failed)} "
                             "tensors: " + "; ".join(f"{n} {rows[n]}" for n in failed[:4]))
    return {**{f"{k}_over_max_ref": v[0] for k, v in worst.items() if k != "tightest"},
            **{f"{k}_worst_tensor": v[1] for k, v in worst.items()},
            "tightest_share_of_bound": worst["tightest"][0], "max_ref": scale,
            "tensors": rows}


def _ae_config(gan_snapshot: Path) -> dict:
    return {**_gan_config(gan_snapshot), **AE_CUTS}


def write_binary_pages(pages: Path, root: Path) -> Path:
    """The training pages thresholded at 128 (gray), as PNGs with their
    binary.json: the adversarial CLI's binary content images."""
    import numpy as np
    from PIL import Image

    from synthesis_in_style_tpu_torch.utils.png import write_png

    out = root / "binary"
    out.mkdir()
    names = json.loads((pages / "train.json").read_text())
    for name in names:
        with Image.open(pages / name) as page:
            gray = np.asarray(page.convert("L"))
        write_png(out / name, np.repeat(np.where(gray < 128, 0, 255).astype(np.uint8)[..., None],
                                        3, axis=2))
    (out / "binary.json").write_text(json.dumps(names))
    return out


def write_autoencoder_snapshot(root: Path, gan_snapshot: Path, config: dict) -> Path:
    """A w+ autoencoder of the config's widths: the encoder seeded, the
    decoder the GAN snapshot's g_ema; `<run>/checkpoints/ae.pt` beside
    `<run>/config/config.json`."""
    from synthesis_in_style_tpu_torch.core.config import save_run_config
    from synthesis_in_style_tpu_torch.models.factory import get_autoencoder
    from synthesis_in_style_tpu_torch.utils.checkpoint import (
        load_generator_state,
        save_autoencoder_snapshot,
    )

    ae = get_autoencoder(config)
    ae.encoder.init_weights(torch.Generator().manual_seed(SEED + 30))
    ae.decoder.load_state_dict(load_generator_state(gan_snapshot), strict=True)
    run = root / "ae_run"
    save_run_config(run, config)
    path = run / "checkpoints" / "ae.pt"
    save_autoencoder_snapshot(path, ae)
    return path


def _lpips(device):
    import warnings

    from synthesis_in_style_tpu_torch.losses.lpips import LPIPS

    with warnings.catch_warnings():  # no ImageNet backbone on the card machine
        warnings.simplefilter("ignore")
        return LPIPS("alex", seed=SEED).to(device)


def _ae_batch(pages: Path, config: dict, batch: int) -> dict:
    from synthesis_in_style_tpu_torch.data.autoencoder_dataset import DenoisingAutoencoderDataset

    ds = DenoisingAutoencoderDataset(pages / "train.json", root=pages,
                                     image_size=config["image_size"], seed=SEED)
    items = [ds[i] for i in range(batch)]
    return {k: torch.stack([it[k] for it in items]) for k in items[0]}


def ae_step_card_vs_cpu(ae_path: Path, config: dict, pages: Path) -> dict:
    """One reconstruction step (MSE + LPIPS) at batch AE_STEP_BATCH, TF32
    off, float32 on the card and on the CPU and float64 on the card: the
    losses card vs CPU within 1e-4, every encoder gradient held by
    `_grad_errors`, and the decoder bitwise unchanged."""
    from synthesis_in_style_tpu_torch.models.factory import load_autoencoder_or_generator
    from synthesis_in_style_tpu_torch.updaters.autoencoder_updater import (
        create_ae_train_state,
        make_autoencoder_train_step,
    )

    batch = _ae_batch(pages, config, AE_STEP_BATCH)
    grads, losses = {}, {}
    for run, device, dtype in _gate_runs():
        ae = load_autoencoder_or_generator(ae_path, config, device=device).to(dtype)
        decoder_before = {k: v.clone() for k, v in ae.decoder.state_dict().items()}
        state = create_ae_train_state(
            ae, lambda params: _GradRecorder((n, p) for n, p in ae.named_parameters()
                                             if not n.startswith("decoder.")))
        step = make_autoencoder_train_step(lpips=_lpips(device).to(dtype))
        out = step(state, {k: v.to(device, dtype) for k, v in batch.items()})
        changed = [k for k, v in ae.decoder.state_dict().items()
                   if not torch.equal(v, decoder_before[k])]
        if changed:
            raise AssertionError(f"autoencoder step ({run}): decoder changed at {changed[:4]}")
        grads[run] = state.optimizer.grads
        losses[run] = {k: float(v) for k, v in out.items()}
    for key, ref in losses["cpu"].items():
        if not abs(losses["card"][key] - ref) <= 1e-4 * max(1.0, abs(ref)):
            raise AssertionError(f"autoencoder step {key}: card {losses['card'][key]} vs CPU {ref}")
    row = {"losses": losses["card"], **_grad_errors("autoencoder step", grads)}
    log(f"autoencoder step card vs CPU ({config['image_size']}px, batch {AE_STEP_BATCH}, "
        f"float32, TF32 off): from float64 the card {row['card_over_max_ref']:.3g} (at "
        f"{row['card_worst_tensor']}) and the CPU {row['cpu_over_max_ref']:.3g} (at "
        f"{row['cpu_worst_tensor']}) of max|ref|, card vs CPU "
        f"{row['card_vs_cpu_over_max_ref']:.3g}; tightest {row['tightest_worst_tensor']} at "
        f"{row['tightest_share_of_bound']:.3g} of its bound; decoder bitwise unchanged; losses "
        f"{row['losses']}")
    return row


class _LeakyReLUSigns:
    """While active, records the branch that each of a network's
    FusedLeakyReLU modules took (out > 0) at every call, on the CPU, in call
    order: two runs of one step compare them to count tie flips (a
    pre-activation within rounding of 0 that takes the other slope)."""

    def __init__(self, network):
        from synthesis_in_style_tpu_torch.models.stylegan2 import FusedLeakyReLU

        self.modules = {n: m for n, m in network.named_modules()
                        if isinstance(m, FusedLeakyReLU)}
        self.signs = []

    def __enter__(self):
        self.handles = [m.register_forward_hook(
            lambda mod, inputs, out, name=n: self.signs.append((name, (out > 0).cpu())))
            for n, m in self.modules.items()]
        return self

    def __exit__(self, *exc):
        for handle in self.handles:
            handle.remove()
        return False


def _flips(signs: list, ref: list) -> dict:
    """Elements whose LeakyReLU branch differs from ref's, by module."""
    out = {}
    for (name, a), (ref_name, b) in zip(signs, ref, strict=True):
        if name != ref_name or a.shape != b.shape:
            raise AssertionError(f"LeakyReLU calls differ: {name} {a.shape}, {ref_name} {b.shape}")
        if (a != b).any():
            out[name] = out.get(name, 0) + int((a != b).sum())
    return out


ADV_STEPS = ("d_step", "d_reg_step", "g_step")


def adversarial_card_vs_cpu(config: dict, ae_path: Path, pages: Path, binary: Path) -> dict:
    """One adversarial iteration (D, R1, G) at batch 1, float32, TF32 off,
    the networks as the CLI builds them from the autoencoder snapshot: each
    step's gradients held by `_grad_errors`, the metrics card vs CPU within
    1e-3. D's LeakyReLU branches are recorded in every run and their tie
    flips against float64 counted; the card's iteration runs twice more,
    as it was and with cuDNN's deterministic algorithms, to show how far
    its reading moves between runs (neither is gated)."""
    import copy

    from synthesis_in_style_tpu_torch.cli import train_adversarial_generator as adv
    from synthesis_in_style_tpu_torch.data.json_dataset import normalize_to_tensor, default_loader
    from synthesis_in_style_tpu_torch.losses.perceptual import PerceptualAndStyleLoss
    from synthesis_in_style_tpu_torch.models.factory import load_autoencoder_state
    from synthesis_in_style_tpu_torch.updaters.adversarial_updater import (
        AdversarialTrainState,
        make_adversarial_steps,
    )
    from synthesis_in_style_tpu_torch.utils.checkpoint import load_autoencoder_snapshot

    networks = adv.build_networks(config)
    adv.init_networks(networks, SEED)
    generation, reconstruction, disc = networks
    snap = load_autoencoder_snapshot(ae_path)
    load_autoencoder_state(reconstruction, snap["autoencoder"])
    load_autoencoder_state(generation.decoder, snap["g_ema"], "style")
    name = json.loads((pages / "train.json").read_text())[0]
    size = config["image_size"]
    style = normalize_to_tensor(default_loader(pages / name), size)[None]
    binary_img = normalize_to_tensor(default_loader(binary / name), size)[None]

    def iteration(device, dtype):
        g_net = copy.deepcopy(generation).to(device, dtype).train()
        d_net = copy.deepcopy(disc).to(device, dtype)
        state = AdversarialTrainState(
            g_net, d_net,
            copy.deepcopy(reconstruction).to(device, dtype).eval().requires_grad_(False),
            _GradRecorder(g_net), _GradRecorder(d_net))
        steps = make_adversarial_steps(
            PerceptualAndStyleLoss(use_style_loss=False).to(device, dtype))
        b, s = binary_img.to(device, dtype), style.to(device, dtype)
        out, grads, signs = {}, {}, {}
        for step, call, prefix in (("d_step", lambda: steps["d_step"](state, b, s), ""),
                                   ("d_reg_step", lambda: steps["d_reg_step"](state, s), ""),
                                   ("g_step", lambda: steps["g_step"](state, b, s), "g_")):
            with _LeakyReLUSigns(d_net) as rec:
                out.update({prefix + k: v for k, v in call().items()})
            optimizer = state.g_optimizer if step == "g_step" else state.d_optimizer
            grads[step], signs[step] = optimizer.grads, rec.signs
        return grads, {k: float(v) for k, v in out.items()}, signs

    grads, metrics, signs = {}, {}, {}
    for run, device, dtype in _gate_runs():
        grads[run], metrics[run], signs[run] = iteration(device, dtype)
    device = DEVICE
    grads["card_repeat"], _, signs["card_repeat"] = iteration(device, torch.float32)
    torch.backends.cudnn.deterministic = True
    try:
        grads["card_deterministic"], _, signs["card_deterministic"] = iteration(
            device, torch.float32)
    finally:
        torch.backends.cudnn.deterministic = False

    ref = grads["float64"]
    diagnosis = {}
    for step in ADV_STEPS:
        names = [n for n, g in ref[step].items() if g is not None]
        scale = max(ref[step][n].abs().max().item() for n in names)
        diagnosis[step] = {run: {
            "over_max_ref": max(((grads[run][step][n] - ref[step][n]).abs().max().item() / scale,
                                 n) for n in names),
            "flips": _flips(signs[run][step], signs["float64"][step])}
            for run in ("card", "cpu", "card_repeat", "card_deterministic")}
        diagnosis[step]["repeat_bitwise_equal"] = all(
            torch.equal(grads["card_repeat"][step][n], grads["card"][step][n]) for n in names)
    log(f"adversarial iteration ({size}px, batch 1, float32, TF32 off), each run's worst "
        "gradient from float64 (of max|ref|) and D's LeakyReLU tie flips against float64: " +
        "; ".join(f"{step}: " + ", ".join(
            f"{run} {d[run]['over_max_ref'][0]:.3g} at {d[run]['over_max_ref'][1]} flips "
            f"{d[run]['flips']}" for run in ("card", "cpu", "card_repeat",
                                              "card_deterministic"))
            + f", repeat bitwise equal {d['repeat_bitwise_equal']}"
            for step, d in diagnosis.items()))
    rows = {step: _grad_errors(f"adversarial {step}",
                               {k: grads[k][step] for k in ("card", "cpu", "float64")})
            for step in ADV_STEPS}
    for key, value in metrics["cpu"].items():
        if not abs(metrics["card"][key] - value) <= 1e-3 * max(1.0, abs(value)):
            raise AssertionError(f"adversarial {key}: card {metrics['card'][key]} vs CPU {value}")
    log(f"adversarial iteration card vs CPU ({size}px, batch 1, float32, TF32 off), from "
        "float64: " + "; ".join(
            f"{k} card {v['card_over_max_ref']:.3g} / CPU {v['cpu_over_max_ref']:.3g} of max|ref| "
            f"(card vs CPU {v['card_vs_cpu_over_max_ref']:.3g}; tightest "
            f"{v['tightest_worst_tensor']} at {v['tightest_share_of_bound']:.3g} of its bound)"
            for k, v in rows.items())
        + f"; metrics {metrics['card']}")
    return {"steps": rows, "metrics": metrics["card"], "diagnosis": diagnosis}


def _seeded_noise_generator(gan_snapshot: Path, config: dict, device):
    """The snapshot's g_ema with seeded non-zero noise weights (a fresh
    init's are 0, which would leave projection's noise stage no gradient)."""
    from synthesis_in_style_tpu_torch.models.factory import load_generator

    gen = load_generator(gan_snapshot, config, device="cpu")
    g = torch.Generator().manual_seed(SEED + 31)
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.endswith("noise.weight"):
                p.copy_(0.1 + 0.1 * torch.rand(p.shape, generator=g))
    return gen.to(device).eval()


def _start_latents(gen, batch: int, device):
    from synthesis_in_style_tpu_torch.models.encoder import Latents

    mean = gen.mean_latent(256, torch.Generator().manual_seed(SEED))  # z drawn on the CPU
    latent = mean[:, None, :].expand(batch, gen.n_latent, -1).contiguous()
    noise = tuple(n.expand(batch, -1, -1, -1).contiguous() for n in gen.noises.nhwc())
    return Latents(latent=latent, noise=noise)


def _target_images(pages: Path, config: dict, n: int, listing: str = "train.json"
                   ) -> torch.Tensor:
    from synthesis_in_style_tpu_torch.data.json_dataset import default_loader, normalize_to_tensor

    names = json.loads((pages / listing).read_text())[:n]
    return torch.stack([normalize_to_tensor(default_loader(pages / m), config["image_size"])
                        for m in names])


def projection_card_vs_cpu(gan_snapshot: Path, config: dict, pages: Path) -> dict:
    """The first PROJECTION_CHECK_STEPS steps of each stage of
    run_image_reconstruction's projection at batch 1 (w+ with LPIPS, then
    the noise with MSE) on the card: at each step's starting point the loss
    and the gradient of the optimized leaves card vs CPU (TF32 off), the
    noise stage's gradient non-zero."""
    from synthesis_in_style_tpu_torch import latent_projecting as lp

    target = _target_images(pages, config, 1)
    gens = {d: _seeded_noise_generator(gan_snapshot, config, d) for d in (DEVICE, "cpu")}
    lpips = {d: _lpips(d) for d in (DEVICE, "cpu")}
    latents = _start_latents(gens["cpu"], 1, "cpu")
    rows = {}
    for optimize, lr in (("latent", 0.1), ("noise", 5.0)):
        loss_fn = {d: (lp.w_plus_loss({"l_percept": 1.0, "l_mse": 0.0}, lpips[d])
                       if optimize == "latent" else lp.naive_noise_loss({"l_mse": 1.0}))
                   for d in (DEVICE, "cpu")}
        paths, final = lp.Projector(gens[DEVICE]).project(
            _to(latents, DEVICE), target.to(DEVICE), loss_fn[DEVICE], PROJECTION_CHECK_STEPS, lr,
            optimize=optimize, snapshot_every=1)
        starts = [latents] + [_from_numpy(item) for item in paths.items[:-1]]
        worst = []
        for i, start in enumerate(starts):
            out = {}
            for run, device, dtype in _gate_runs():
                lat = _to(start, device, dtype)
                leaves = [lat.latent] if optimize == "latent" else list(lat.noise)
                leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
                lat = (lat.replace(latent=leaves[0]) if optimize == "latent"
                       else lat.replace(noise=tuple(leaves)))
                gen = gens[device].to(dtype)
                loss_fn = (lp.w_plus_loss({"l_percept": 1.0, "l_mse": 0.0},
                                          lpips[device].to(dtype))
                           if optimize == "latent" else lp.naive_noise_loss({"l_mse": 1.0}))
                loss, _ = loss_fn(lp.Projector(gen).generate(lat), target.to(device, dtype))
                out[run] = (loss.item(), {str(j): g for j, g in enumerate(
                    torch.autograd.grad(loss, leaves))})
                gens[device].float()
                lpips[device].float()
            if not abs(out["card"][0] - out["cpu"][0]) <= 1e-4 * max(1.0, abs(out["cpu"][0])):
                raise AssertionError(f"projection {optimize} step {i}: loss card "
                                     f"{out['card'][0]} vs CPU {out['cpu'][0]}")
            worst.append(_grad_errors(f"projection {optimize} step {i}",
                                      {k: v[1] for k, v in out.items()}))
        rows[optimize] = {"steps": worst}
        latents = _to(final, "cpu")
    log("projection card vs CPU (batch 1, TF32 off, seeded noise weights), from float64: " +
        "; ".join(f"{k}: card worst {max(s['card_over_max_ref'] for s in v['steps']):.3g}, CPU "
                  f"{max(s['cpu_over_max_ref'] for s in v['steps']):.3g} of max|ref| over "
                  f"{len(v['steps'])} steps (max|grad| {v['steps'][0]['max_ref']:.3g}; tightest "
                  f"at {max(s['tightest_share_of_bound'] for s in v['steps']):.3g} of its bound)"
                  for k, v in rows.items()))
    return rows


def _to(latents, device, dtype=torch.float32):
    return latents.replace(latent=latents.latent.to(device, dtype),
                           noise=tuple(n.to(device, dtype) for n in latents.noise))


def _from_numpy(latents):
    return latents.replace(latent=torch.from_numpy(latents.latent),
                           noise=tuple(torch.from_numpy(n) for n in latents.noise))


def _expected_launches(size: int, decodes: int, backwards: int) -> dict:
    """Launches of `decodes` w+ decodes at `size` px and `backwards`
    backwards through them. A decode runs the bias-act forward in conv1 and
    in each resolution's second conv (7 at 256px) and a blur tail in each
    upsampling conv (6); its backward runs the bias-act backward once per
    bias-act forward and once per blur tail (13)."""
    ups = int(math.log2(size)) - 2
    return {"fused_bias_act": decodes * (ups + 1), "fused_blur": decodes * ups,
            "fused_bias_act_bwd": backwards * (2 * ups + 1)}


def _check_launches(path: str, launches: dict, want: dict) -> None:
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{path}: launches {got}, want {want}")


def ae_training_rate(ae_path: Path, config: dict, pages: Path, fns: dict) -> dict:
    """AutoencoderUpdater under the Trainer (the JAX package's API; it has no
    CLI): denoising pairs of the training pages, AE_RATE iterations at its
    batch after 2 warm-up iterations, launch counts from 0 (exactly a
    decode and its backward an iteration), the step alone on a batch on the
    card (and profiled), peak reserved memory, the decoder unchanged."""
    from synthesis_in_style_tpu_torch.core.trainer import Trainer
    from synthesis_in_style_tpu_torch.data.autoencoder_dataset import DenoisingAutoencoderDataset
    from synthesis_in_style_tpu_torch.data.loader import EpochStream, make_loader
    from synthesis_in_style_tpu_torch.models.factory import load_autoencoder_or_generator
    from synthesis_in_style_tpu_torch.updaters.autoencoder_updater import (
        AutoencoderUpdater,
        adam_optimizer,
        create_ae_train_state,
        make_autoencoder_train_step,
    )

    iterations, batch = AE_RATE
    ds = DenoisingAutoencoderDataset(pages / "train.json", root=pages,
                                     image_size=config["image_size"], seed=SEED)
    stream = EpochStream(make_loader(ds, batch, shuffle=True, drop_last=True, num_workers=4,
                                     seed=SEED, pin_memory=DEVICE == "cuda"))
    ae = load_autoencoder_or_generator(ae_path, config, device=DEVICE)
    decoder_before = {k: v.clone() for k, v in ae.decoder.state_dict().items()}
    state = create_ae_train_state(ae, adam_optimizer(1e-4))
    step = make_autoencoder_train_step(lpips=_lpips(DEVICE))
    updater = AutoencoderUpdater(step, state, {"images": stream}, seed=SEED, device=DEVICE)
    try:
        for _ in range(2):
            updater.update()
        _sync()
        _reset_peak()
        _count_from_zero(fns)
        trainer = Trainer(updater, (iterations + 2, "iteration"))
        trainer.train()
        _sync()
        launches = _launches(fns)
        shapes = {**_path_shapes(fns), "fused_bias_act_bwd": dict(fns["fused_bias_act_bwd"].shapes)}
        peak = _peak_reserved_gb()
        _check_launches("autoencoder training", launches,
                        _expected_launches(config["image_size"], iterations, iterations))
        fixed = {k: v.to(DEVICE) for k, v in next(stream).items()}
    finally:
        stream.close()
    out = {"iterations": iterations, "batch": batch, "loop_seconds": trainer.seconds,
           "iterations_per_s": iterations / trainer.seconds,
           "images_per_s": iterations * batch / trainer.seconds, "launches": launches,
           "peak_reserved_gb": peak, "shapes": shapes,
           **_step_alone(lambda: step(state, fixed, updater.rng))}
    changed = [k for k, v in ae.decoder.state_dict().items() if not torch.equal(v, decoder_before[k])]
    if changed:
        raise AssertionError(f"autoencoder training changed the decoder at {changed[:4]}")
    log(f"autoencoder training ({config['image_size']}px, batch {batch}, float32, {iterations} iterations): "
        f"{out['iterations_per_s']:.3f} iterations/s = {out['images_per_s']:.2f} images/s, the "
        f"step alone {out['step_ms']:.2f} ms, peak reserved {peak:.2f} GB, decoder unchanged; "
        f"launches {launches}")
    return out


def _step_alone(fn, steps: int = 5) -> dict:
    """fn (one training step on a batch already on the card) timed over
    `steps` calls after one, then once under torch.profiler."""
    fn()
    _sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    _sync()
    out = {"step_ms": (time.perf_counter() - t0) / steps * 1e3}
    if DEVICE == "cuda":
        out["profile"] = profile_call(fn)
    return out


def run_adversarial_cli(config: dict, ae_path: Path, pages: Path, binary: Path, log_dir: Path,
                        **overrides):
    """`train_adversarial_generator` on DEVICE with the GAN config and
    `overrides` (--overwrite-config: the config beside the checkpoint is
    the GAN's)."""
    from synthesis_in_style_tpu_torch.cli import train_adversarial_generator as cli

    cfg = {**config, "lr": 1e-4, "beta1": 0.5, "num_workers": 4, **overrides}
    path = log_dir.parent / f"{log_dir.name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(cfg))
    args = cli.build_parser().parse_args(
        [str(path), str(ae_path), "-o", str(pages / "train.json"), "-f",
         str(binary / "binary.json"), "-d", DEVICE, "--overwrite-config"])
    args.log_dir = str(log_dir)
    _sync()
    t0 = time.perf_counter()
    trainer = cli.main(args)
    _sync()
    return trainer, time.perf_counter() - t0


def adversarial_rates(config: dict, ae_path: Path, pages: Path, binary: Path, root: Path,
                      fns: dict) -> dict:
    """The adversarial CLI: a 2-iteration first run that writes the
    snapshot, the probe grid and the log (checked), then ADV_RATE iterations
    with launch counts from 0; the iteration alone on fixed batches on the
    card (and profiled), peak reserved memory."""
    import numpy as np
    from PIL import Image

    iterations, batch = ADV_RATE
    first = root / "adv_first"
    run_adversarial_cli(config, ae_path, pages, binary, first, batch_size=batch, max_iter=2,
                        snapshot_save_iter=2, image_save_iter=2, log_iter=1)
    snap = torch.load(first / "checkpoints" / "iter_00000002.pt", map_location="cpu",
                      weights_only=True)
    if not {"generator", "discriminator", "generator_optimizer"} <= set(snap):
        raise AssertionError(f"adversarial snapshot holds {sorted(snap)}")
    with Image.open(first / "images" / "iter_00000002.png") as png:
        size = config["image_size"]
        if png.size != (4 * size, min(4, batch) * size):
            raise AssertionError(f"adversarial probe grid {png.size}")
    log_lines = (first / "log.jsonl").read_text().splitlines()
    if len(log_lines) < 2 or "discriminator/loss" not in json.loads(log_lines[-1]):
        raise AssertionError(f"adversarial log: {log_lines[-1:]}")
    _reset_peak()
    _count_from_zero(fns)
    trainer, wall = run_adversarial_cli(config, ae_path, pages, binary, root / "adv_run",
                                        batch_size=batch, max_iter=iterations,
                                        snapshot_save_iter=iterations,
                                        image_save_iter=iterations, log_iter=8)
    launches = _launches(fns)
    shapes = {**_path_shapes(fns), "fused_bias_act_bwd": dict(fns["fused_bias_act_bwd"].shapes)}
    peak = _peak_reserved_gb()
    losses = [json.loads(line) for line in (root / "adv_run" / "log.jsonl").read_text()
              .splitlines()]
    if not all(np.isfinite(v) for rec in losses for k, v in rec.items()
               if k.startswith(("generator/", "discriminator/"))):
        raise AssertionError(f"adversarial losses not finite: {losses}")
    updater = trainer.updater
    binary_b = _target_images(binary, config, batch, "binary.json").to(DEVICE)
    style_b = _target_images(pages, config, batch).to(DEVICE)

    def iteration():
        updater.steps["d_step"](updater.state, binary_b, style_b, updater.rng)
        updater.steps["g_step"](updater.state, binary_b, style_b, updater.rng)

    out = {"iterations": iterations, "batch": batch, "cli_seconds": wall,
           "loop_seconds": trainer.seconds, "iterations_per_s": iterations / trainer.seconds,
           "images_per_s": iterations * batch / trainer.seconds, "launches": launches,
           "shapes": shapes, "peak_reserved_gb": peak, "last_log": losses[-1],
           **_step_alone(iteration, steps=3)}
    log(f"adversarial CLI ({config['image_size']}px, batch {batch}, float32, {iterations} iterations): "
        f"{out['iterations_per_s']:.3f} iterations/s = {out['images_per_s']:.2f} images/s (loop "
        f"{trainer.seconds:.3f} s, whole CLI {wall:.3f} s), D + G alone {out['step_ms']:.1f} ms, "
        f"peak reserved {peak:.2f} GB; launches {launches}; first run wrote the snapshot, the "
        f"probe grid and {len(log_lines)} log lines")
    return out


def projection_rate(gan_snapshot: Path, config: dict, pages: Path, fns: dict) -> dict:
    """run_image_reconstruction on PROJECTION's images at its w+ and noise
    steps (launch counts from 0: a decode and its backward a step), the
    losses read each step through the abort conditions (which return False):
    ms a step per stage, and both losses falling."""
    from synthesis_in_style_tpu_torch import latent_projecting as lp

    n, latent_steps, noise_steps = PROJECTION
    gen = _seeded_noise_generator(gan_snapshot, config, DEVICE)
    lpips = _lpips(DEVICE)
    target = _target_images(pages, config, n).to(DEVICE)
    latents = _start_latents(gen, n, DEVICE)
    record = {"latent": [], "noise": []}

    def watcher(stage):
        def watch(loss, i):
            record[stage].append((time.perf_counter(), loss))
            return False
        return watch

    _reset_peak()
    _count_from_zero(fns)
    _sync()
    t0 = time.perf_counter()
    _, best = lp.run_image_reconstruction(
        lp.Projector(gen), latents, target, lpips, latent_step=latent_steps,
        noise_step=noise_steps, latent_abort_condition=watcher("latent"),
        noise_abort_condition=watcher("noise"))
    _sync()
    wall = time.perf_counter() - t0
    launches = _launches(fns)
    _check_launches("projection", launches,
                    _expected_launches(config["image_size"], latent_steps + noise_steps,
                                       latent_steps + noise_steps))
    out = {"images": n, "steps": (latent_steps, noise_steps), "seconds": wall,
           "launches": launches, "peak_reserved_gb": _peak_reserved_gb(),
           "shapes": {**_path_shapes(fns),
                      "fused_bias_act_bwd": dict(fns["fused_bias_act_bwd"].shapes)}}
    for stage, rec in record.items():
        times, losses = zip(*rec)
        out[stage] = {"ms_per_step": (times[-1] - times[0]) / (len(times) - 1) * 1e3,
                      "loss_first": losses[0], "loss_last": losses[-1]}
        if not losses[-1] < losses[0]:
            raise AssertionError(f"projection {stage} stage: loss {losses[0]} -> {losses[-1]}")
    log(f"run_image_reconstruction ({n} images, {latent_steps} + {noise_steps} steps): "
        + "; ".join(f"{k} {v['ms_per_step']:.2f} ms a step, loss {v['loss_first']:.4g} -> "
                    f"{v['loss_last']:.4g}" for k, v in out.items() if k in record)
        + f"; whole {wall:.2f} s, peak reserved {out['peak_reserved_gb']:.2f} GB; launches "
        f"{launches}")
    return out


def analyze_rate(ae_path: Path, pages: Path, root: Path, fns: dict) -> dict:
    """analyze_latent_code on ANALYZE_IMAGES pages: the embedding's images/s
    (launch counts from 0: the encoder runs no port kernel), the cache's
    keys and both blueprints."""
    import argparse

    import numpy as np

    from synthesis_in_style_tpu_torch.core.config import load_config_from_checkpoint
    from synthesis_in_style_tpu_torch.scripts import analyze_latent_code as alc

    names = json.loads((pages / "train.json").read_text())[:ANALYZE_IMAGES]
    dataset = pages / "analyze.json"
    dataset.write_text(json.dumps(names))
    save_dir = root / "latent_analysis"
    args = argparse.Namespace(autoencoder_checkpoint=str(ae_path), dataset=str(dataset),
                              save_dir=str(save_dir), original_config_path=None, force=True,
                              batch_size=8, stats=False, check_reconstructed_cdf=False,
                              device=DEVICE)
    config = load_config_from_checkpoint(ae_path)
    _count_from_zero(fns)
    _sync()
    t0 = time.perf_counter()
    latents, noises = alc.embed_images(args, config)
    _sync()
    embed_s = time.perf_counter() - t0
    launches = _launches(fns)
    args.force = False
    t0 = time.perf_counter()
    blueprints = alc.main(args)
    analysis_s = time.perf_counter() - t0
    with np.load(save_dir / "embedded.npz") as cached:
        keys = sorted(cached.files)
    want_keys = sorted(["latents", "num_noise_layers"] + [f"noise_{i}" for i in range(len(noises))])
    n_latent = int(math.log2(config["image_size"])) * 2 - 2
    if keys != want_keys or latents.shape != (len(names), n_latent, config["latent_size"]):
        raise AssertionError(f"embedded.npz {keys}, latents {latents.shape}")
    if len(blueprints["noise"]) != n_latent - 1 or not (save_dir / "latents" / "latent_blueprint.json").exists():
        raise AssertionError("analyze_latent_code: blueprints missing")
    out = {"images": len(names), "embed_seconds": embed_s, "images_per_s": len(names) / embed_s,
           "analysis_seconds": analysis_s, "launches": launches}
    log(f"analyze_latent_code ({len(names)} images, -b 8): embedding {out['images_per_s']:.2f} "
        f"images/s ({embed_s:.3f} s with the loader's start), histograms and blueprints "
        f"{analysis_s:.2f} s; launches {launches}")
    return out


def discovery_with_images(ae_path: Path, pages: Path, fns: dict) -> dict:
    """create_semantic_segmentation -i on the autoencoder snapshot
    (AE_DISCOVERY), launch counts from 0 (a decode a batch), artifacts as
    the discovery phase checks them; a generator-only checkpoint raises."""
    from synthesis_in_style_tpu_torch.cli import create_semantic_segmentation as css

    n, batch, ks = AE_DISCOVERY
    argv = [str(ae_path), "-i", str(pages / "train.json"), "-n", str(n), "-b", str(batch),
            "-c", *map(str, ks), "--destination", "semantic_segmentation_images", "-d", DEVICE]
    _count_from_zero(fns)
    _sync()
    t0 = time.perf_counter()
    report = css.main(css.build_parser().parse_args(argv))
    _sync()
    wall = time.perf_counter() - t0
    launches = _launches(fns)
    batches = -(-n // batch)
    sem = ae_path.parent.parent / "semantic_segmentation_images"
    size = _gan_config(ae_path)["image_size"]
    _check_launches("discovery -i", launches, _expected_launches(size, batches, 0))
    layers = (int(math.log2(size)) - 2) * 2 + 2  # the constant input and every StyledConv
    check_discovery_artifacts(sem, layers, size, sizes=AE_DISCOVERY)
    out = {**report, "cli_s": wall, "launches": launches}
    log(f"discovery -i (-n {n} -b {batch} -c {ks[0]} {ks[1]}): generation "
        f"{report['generation_s']:.3f} s, fit {report['fit_s']:.3f} s, write "
        f"{report['write_s']:.3f} s, whole CLI {wall:.3f} s; launches {launches}")
    return out


def stylegan1_card_vs_cpu(config: dict) -> dict:
    """The 256px StyledGenerator (seeded, non-zero noise weights) and
    ProgressiveDiscriminator at batch 2, float32, TF32 off: image,
    activations and logits card vs CPU within 1e-3 of max|ref|."""
    from synthesis_in_style_tpu_torch.models.stylegan1 import (
        ProgressiveDiscriminator,
        StyledGenerator,
    )

    size, latent = config["image_size"], config["latent_size"]
    g = torch.Generator().manual_seed(SEED + 32)
    gen = StyledGenerator(size, latent, config.get("n_mlp", 8)).init_weights(g)
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if ".noise" in name:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    disc = ProgressiveDiscriminator(default_step=gen.step).init_weights(g)
    z = torch.randn((2, latent), generator=g)
    noise = [torch.randn((2,) + s[1:], generator=g) for s in gen.noise_shapes()]
    out = {}
    for device in (DEVICE, "cpu"):
        gen_d, disc_d = gen.to(device), disc.to(device)
        with torch.no_grad():
            img, acts = gen_d([z.to(device)], noise=[n.to(device) for n in noise],
                              return_intermediate_activations=True)
            out[device] = {"image": img.cpu(), "logits": disc_d(img).cpu(),
                           **{f"act_{k}": v.cpu() for k, v in acts.items()}}
    errs = {}
    for key, ref in out["cpu"].items():
        err = (out[DEVICE][key] - ref).abs().max().item() / ref.abs().max().item()
        if not err <= 1e-3:
            raise AssertionError(f"StyleGAN1 {key}: card vs CPU {err} of max|ref|")
        errs[key] = err
    log(f"StyleGAN1 {size}px generator and discriminator card vs CPU (batch 2, TF32 off): worst "
        f"{max(errs.values()):.3g} of max|ref| ({max(errs, key=errs.get)})")
    return {"max_err_over_max_ref": errs}


def check_bias_act_bwd_shapes(path: str, shapes: dict) -> list:
    """The bias-act backward at every (shape, dtype) the path launched: y
    from the forward kernel, g random, against the plain version."""
    from synthesis_in_style_tpu_torch.ops.cuda.fused_bias_act import (
        fused_leaky_relu_bwd_cuda,
        fused_leaky_relu_bwd_plain,
        fused_leaky_relu_cuda,
    )

    if DEVICE != "cuda":
        return []
    tols = dict(BIAS_ACT_TOLERANCES)
    g = torch.Generator(device="cuda").manual_seed(SEED + 33)
    rows = []
    for (shape, dtype), launches in shapes.items():
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        y = fused_leaky_relu_cuda(x, torch.randn(shape[-1], generator=g, device="cuda").to(dtype))
        grad = torch.randn(shape, generator=g, device="cuda").to(dtype)
        got = fused_leaky_relu_bwd_cuda(y, grad).float()
        ref = fused_leaky_relu_bwd_plain(y, grad).float()
        err = (got - ref).abs().max().item()
        if not err <= tols[dtype] * max(1.0, ref.abs().max().item()):
            raise AssertionError(f"fused_bias_act_bwd on the {path} path {shape} {dtype}: {err}")
        rows.append({"kernel": "fused_bias_act_bwd", "shape": list(shape),
                     "dtype": str(dtype).split(".")[-1], "launches": launches,
                     "max_abs_err": err})
    log(f"{path}: the bias-act backward at {len(rows)} (shape, dtype)s against its plain "
        f"version, worst error {max([r['max_abs_err'] for r in rows] or [0.0])}")
    return rows


def autoencoder_phase(root: Path, gan_snapshot: Path, pages: Path, fns: dict) -> dict:
    """The autoencoder and GAN-inversion branch on the training phase's
    256px snapshot and pages: step parity card vs CPU (TF32 off), then with
    PyTorch's defaults the rates of autoencoder training, the adversarial
    CLI, projection, analyze_latent_code and -i discovery with their launch
    counts, StyleGAN1 card vs CPU and its adversarial CLI (no port kernel),
    and each path's kernels at its shapes against their plain versions."""
    marks = [time.perf_counter()]
    config = _ae_config(gan_snapshot)
    binary = write_binary_pages(pages, root)
    ae_path = write_autoencoder_snapshot(root, gan_snapshot, config)
    set_tf32(False)
    parity = {"autoencoder_step": ae_step_card_vs_cpu(ae_path, config, pages),
              "adversarial": adversarial_card_vs_cpu(config, ae_path, pages, binary),
              "projection": projection_card_vs_cpu(gan_snapshot, config, pages),
              "stylegan1": stylegan1_card_vs_cpu(config)}
    marks.append(time.perf_counter())
    set_tf32(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    paths = {"ae_training": ae_training_rate(ae_path, config, pages, fns)}
    marks.append(time.perf_counter())
    paths["adversarial"] = adversarial_rates(config, ae_path, pages, binary, root, fns)
    marks.append(time.perf_counter())
    iterations, batch = ADV_V1
    _count_from_zero(fns)
    trainer, wall = run_adversarial_cli(
        {**config, "stylegan_variant": 1}, gan_snapshot, pages, binary, root / "adv_v1",
        batch_size=batch, max_iter=iterations, snapshot_save_iter=iterations,
        image_save_iter=iterations, log_iter=2)
    paths["adversarial_v1"] = {"iterations": iterations, "batch": batch, "cli_seconds": wall,
                               "iterations_per_s": iterations / trainer.seconds,
                               "launches": _launches(fns)}
    _check_launches("adversarial, stylegan_variant 1", paths["adversarial_v1"]["launches"],
                    _expected_launches(config["image_size"], 0, 0))
    log(f"adversarial CLI, stylegan_variant 1 ({iterations} iterations, batch {batch}): "
        f"{paths['adversarial_v1']['iterations_per_s']:.3f} iterations/s (whole CLI "
        f"{wall:.2f} s); launches {paths['adversarial_v1']['launches']}")
    del trainer
    marks.append(time.perf_counter())
    paths["projection"] = projection_rate(gan_snapshot, config, pages, fns)
    marks.append(time.perf_counter())
    paths["analyze_latent_code"] = analyze_rate(ae_path, pages, root, fns)
    paths["discovery_images"] = discovery_with_images(ae_path, pages, fns)
    marks.append(time.perf_counter())
    set_tf32(False)
    for name in ("ae_training", "adversarial", "projection"):
        shapes = paths[name].pop("shapes")
        paths[name]["path_kernels"] = (
            check_path_kernels(f"autoencoder_{name}", shapes)
            + check_bias_act_bwd_shapes(f"autoencoder_{name}", shapes["fused_bias_act_bwd"]))
    marks.append(time.perf_counter())
    seconds = dict(zip(("parity", "ae_training", "adversarial", "adversarial_v1", "projection",
                        "analyze_and_discovery", "path_kernels"),
                       (b - a for a, b in zip(marks, marks[1:]))))
    log("autoencoder phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()) +
        f"; whole phase {marks[-1] - marks[0]:.1f}")
    return {"parity": parity, **paths, "snapshot": ae_path, "seconds": seconds}


# ---------------------------------------------------------------------------
# checkpoint evaluation and results analysis: evaluate_checkpoints,
# fid_trend, the results CLIs and the COCO dataset

EVAL_VAL_PAGES = 16  # the training pages' val.json: the last 16 of them
EVAL_BATCH, EVAL_FID_SAMPLES = 8, 1000  # evaluate_checkpoints' defaults, -b and FID samples
EVAL_TREND = (256, 16)  # fid_trend's --num-samples and --batch
EVAL_CHECK_IMAGES = 4  # reconstruction card vs CPU, one image a batch
EVAL_CHECK_FID = 32  # FID card vs CPU: samples of each kind, at -b EVAL_BATCH
EVAL_SUBSET_PAGES = 2  # extract_results_subset's pages
EVAL_RATE_PASSES = 3  # timed passes over the val pages on the card: the reconstruction rate
PSNR_TOLERANCE, SSIM_TOLERANCE, FID_FEATURE_TOLERANCE, FID_TOLERANCE = 1e-3, 1e-5, 1e-4, 1e-3
# The script's float32 SSIM card vs CPU: SSIM_TOLERANCE for the decode plus,
# on each device, the float32 metric's own rounding on these flat pages (its
# variances E[x^2] - E[x]^2 cancel; read at up to 1.05e-5 from the float64
# SSIM of the same images, on either device). Readings card vs CPU:
# 1.007e-5 to 1.028e-5 (NVIDIA H100 80GB HBM3, 700 W).
SSIM32_TOLERANCE = 3e-5


class Steps:
    """Seconds of a phase's steps: `mark(name)` closes the step begun at the
    previous mark (or at construction) under that name."""

    def __init__(self):
        self.seconds = {}
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self._t
        self._t = now


def _forward_launches(size: int, forwards: int, n_mlp: int) -> dict:
    """Launches of `forwards` generator forwards from z at `size` px: the
    mapping MLP's n_mlp bias-acts, then those of a w+ decode."""
    out = _expected_launches(size, forwards, 0)
    out["fused_bias_act"] += forwards * n_mlp
    return {**out, "segmented_cc": 0, "flash_attention_fwd": 0, "flash_attention_bwd": 0}


def write_val_json(pages: Path) -> Path:
    """The training pages' val.json: their last EVAL_VAL_PAGES pages."""
    path = pages / "val.json"
    path.write_text(json.dumps(json.loads((pages / "train.json").read_text())[-EVAL_VAL_PAGES:]))
    return path


class _recording_reconstructions(list):
    """While active, each reconstruction `evaluate_checkpoints` scores is
    appended (PSNRSSIMEvaluator.psnr_and_ssim's image)."""

    def __enter__(self):
        from synthesis_in_style_tpu_torch.evaluation.psnr_ssim import PSNRSSIMEvaluator

        self._original = PSNRSSIMEvaluator.psnr_and_ssim
        original, record = self._original, self

        def recorded(evaluator, image, target):
            record.append(image)
            return original(evaluator, image, target)

        PSNRSSIMEvaluator.psnr_and_ssim = recorded
        return self

    def __exit__(self, *exc):
        from synthesis_in_style_tpu_torch.evaluation.psnr_ssim import PSNRSSIMEvaluator

        PSNRSSIMEvaluator.psnr_and_ssim = self._original
        return False


def reconstruction_card_vs_cpu(ae_path: Path, val_json: Path) -> dict:
    """`evaluate_checkpoints`' reconstruction scores of the autoencoder on
    EVAL_CHECK_IMAGES validation images, one a batch, on the card and on the
    CPU with TF32 off. Per image: PSNR within PSNR_TOLERANCE dB; the SSIM of
    the two reconstructions computed in float64 within SSIM_TOLERANCE (the
    decode is ~1e-5 of max|ref| from the CPU); the script's float32 SSIM
    within SSIM32_TOLERANCE (the metric's own float32 rounding on each
    device comes on top of the decode's difference)."""
    from synthesis_in_style_tpu_torch.cli.train_stylegan_2 import GANImageDataset
    from synthesis_in_style_tpu_torch.core.config import load_config_from_checkpoint
    from synthesis_in_style_tpu_torch.evaluation.psnr_ssim import ssim
    from synthesis_in_style_tpu_torch.models.factory import load_autoencoder_or_generator
    from synthesis_in_style_tpu_torch.scripts.evaluate_checkpoints import reconstruction_scores

    config = load_config_from_checkpoint(ae_path)
    data = GANImageDataset(val_json, root=val_json.parent, image_size=config["image_size"],
                           num_channels=config.get("input_dim", 3))
    batches = [{"images": data[i]["images"][None]} for i in range(EVAL_CHECK_IMAGES)]
    scores, ssim64 = {}, {}
    set_tf32(False)
    try:
        for device in (DEVICE, "cpu"):
            model = load_autoencoder_or_generator(ae_path, config, device)
            scores[device], ssim64[device] = [], []
            for b in batches:
                images = b["images"].to(device)
                with _recording_reconstructions() as recon:
                    scores[device].append(reconstruction_scores(model, [b],
                                                                torch.device(device)))
                ssim64[device].append(float(ssim(recon[0].double(), images.double())))
            del model
    finally:
        _defaults()
    d_psnr = max(abs(a["psnr"] - b["psnr"]) for a, b in zip(scores[DEVICE], scores["cpu"]))
    d_ssim = max(abs(a["ssim"] - b["ssim"]) for a, b in zip(scores[DEVICE], scores["cpu"]))
    d_ssim64 = max(abs(x - y) for x, y in zip(ssim64[DEVICE], ssim64["cpu"]))
    if not (d_psnr <= PSNR_TOLERANCE and d_ssim64 <= SSIM_TOLERANCE
            and d_ssim <= SSIM32_TOLERANCE):
        raise AssertionError(f"reconstruction card vs CPU: |dPSNR| {d_psnr} dB, |dSSIM| "
                             f"{d_ssim} (limit {SSIM32_TOLERANCE}), in float64 {d_ssim64}")
    return {"images": EVAL_CHECK_IMAGES, "psnr_abs_diff": d_psnr, "ssim_abs_diff": d_ssim,
            "ssim64_abs_diff": d_ssim64,
            "psnr_card": [s["psnr"] for s in scores[DEVICE]],
            "ssim_card": [s["ssim"] for s in scores[DEVICE]]}


def reconstruction_rate(ae_path: Path, val_json: Path) -> dict:
    """`evaluate_checkpoints`' reconstruction scoring (the w+ decode, then
    PSNR and SSIM image by image) of the val pages already on the card, in
    batches of EVAL_BATCH, with PyTorch's defaults and no loader: one warm
    pass, then EVAL_RATE_PASSES timed."""
    from synthesis_in_style_tpu_torch.cli.train_stylegan_2 import GANImageDataset
    from synthesis_in_style_tpu_torch.core.config import load_config_from_checkpoint
    from synthesis_in_style_tpu_torch.models.factory import load_autoencoder_or_generator
    from synthesis_in_style_tpu_torch.scripts.evaluate_checkpoints import reconstruction_scores

    config = load_config_from_checkpoint(ae_path)
    data = GANImageDataset(val_json, root=val_json.parent, image_size=config["image_size"],
                           num_channels=config.get("input_dim", 3))
    images = torch.stack([data[i]["images"] for i in range(len(data))]).to(DEVICE)
    batches = [{"images": images[i:i + EVAL_BATCH]} for i in range(0, len(images), EVAL_BATCH)]
    model = load_autoencoder_or_generator(ae_path, config, DEVICE)
    reconstruction_scores(model, batches, torch.device(DEVICE))
    _sync()
    t0 = time.perf_counter()
    for _ in range(EVAL_RATE_PASSES):
        reconstruction_scores(model, batches, torch.device(DEVICE))
    _sync()
    seconds = time.perf_counter() - t0
    n = EVAL_RATE_PASSES * len(images)
    return {"images": n, "batch": EVAL_BATCH, "seconds": seconds, "images_per_s": n / seconds}


def fid_card_vs_cpu_at_batch(gan_snapshot: Path, val_json: Path) -> dict:
    """GenerativeFID of the GAN snapshot's g_ema as evaluate_checkpoints
    builds it, on EVAL_CHECK_FID samples at -b EVAL_BATCH (the same z: a CPU
    generator seeded 42) and the real features of the val pages, on the
    card and on the CPU with TF32 off: features within FID_FEATURE_TOLERANCE
    of max|ref|, the distance within FID_TOLERANCE relative."""
    import warnings

    import numpy as np

    from synthesis_in_style_tpu_torch.cli.train_stylegan_2 import GANImageDataset
    from synthesis_in_style_tpu_torch.core.config import load_config_from_checkpoint
    from synthesis_in_style_tpu_torch.evaluation import fid
    from synthesis_in_style_tpu_torch.models.factory import load_generator

    config = load_config_from_checkpoint(gan_snapshot)
    data = GANImageDataset(val_json, root=val_json.parent, image_size=config["image_size"])
    images = torch.stack([data[i]["images"] for i in range(len(data))])
    real_batches = [{"images": images[i:i + EVAL_BATCH]}
                    for i in range(0, len(images), EVAL_BATCH)]
    feats, distance = {}, {}
    set_tf32(False)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for device in (DEVICE, "cpu"):
                gen = load_generator(gan_snapshot, config, device)
                metric = fid.GenerativeFID(latent_size=gen.style_dim, batch_size=EVAL_BATCH,
                                           num_samples=EVAL_CHECK_FID, batch_image_key="images",
                                           device=device)

                @torch.no_grad()
                def sample(z, gen=gen):
                    return gen([z], randomize_noise=False)[0]

                fake = metric._collect(metric.fake_batches(sample, None))
                real = np.concatenate([metric.feature_fn(b["images"].to(device)).float().cpu()
                                       .numpy() for b in real_batches])
                feats[device] = (real, fake)
                r, f = fid.get_statistics(real), fid.get_statistics(fake)
                distance[device] = fid.calculate_frechet_distance(r.mu, r.sigma, f.mu, f.sigma)
                del gen
    finally:
        _defaults()
    rel = max(float(abs(a - b).max() / abs(b).max())
              for a, b in zip(feats[DEVICE], feats["cpu"]))
    fid_rel = abs(distance[DEVICE] - distance["cpu"]) / abs(distance["cpu"])
    if not (rel <= FID_FEATURE_TOLERANCE and fid_rel <= FID_TOLERANCE):
        raise AssertionError(f"FID card vs CPU: features {rel} of max|ref|, distance {fid_rel} "
                             "relative")
    return {"samples": EVAL_CHECK_FID, "batch": EVAL_BATCH, "features_rel_err": rel,
            "fid_card": distance[DEVICE], "fid_cpu": distance["cpu"], "fid_rel_diff": fid_rel}


class _timed_evaluation:
    """While active: evaluate_checkpoints' reconstruction loops (loader
    start and PNG decoding included), and GenerativeFID's generation,
    features and Frechet distances, each call between synchronizes; seconds
    summed under `seconds`, the reconstructed images counted."""

    def __init__(self):
        self.seconds = {"reconstruction": 0.0, "generation": 0.0, "features": 0.0,
                        "frechet": 0.0}
        self.images = 0

    def _timed(self, name, fn):
        def run(*args, **kwargs):
            _sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync()
            self.seconds[name] += time.perf_counter() - t0
            return out
        return run

    def __enter__(self):
        from synthesis_in_style_tpu_torch.evaluation import fid
        from synthesis_in_style_tpu_torch.scripts import evaluate_checkpoints as ec

        self._originals = (ec.reconstruction_scores, fid.GenerativeFID.fake_batches,
                           fid.FID._collect, fid.calculate_frechet_distance)
        recon, fake, collect, frechet = self._originals
        rec = self

        def reconstruction(model, loader, device):
            rec.images += len(loader.dataset) if hasattr(model, "encode") else 0
            return rec._timed("reconstruction", recon)(model, loader, device)

        def fake_batches(metric, model_fn, loader):
            return fake(metric, rec._timed("generation", model_fn), loader)

        def timed_collect(metric, batches):
            feature_fn = metric.feature_fn
            metric.feature_fn = rec._timed("features", feature_fn)
            try:
                return collect(metric, batches)
            finally:
                metric.feature_fn = feature_fn

        ec.reconstruction_scores = reconstruction
        fid.GenerativeFID.fake_batches = fake_batches
        fid.FID._collect = timed_collect
        fid.calculate_frechet_distance = self._timed("frechet", frechet)
        return self

    def __exit__(self, *exc):
        from synthesis_in_style_tpu_torch.evaluation import fid
        from synthesis_in_style_tpu_torch.scripts import evaluate_checkpoints as ec

        (ec.reconstruction_scores, fid.GenerativeFID.fake_batches, fid.FID._collect,
         fid.calculate_frechet_distance) = self._originals
        return False


class _refuse_loading:
    """While active, loading a checkpoint or its config raises."""

    NAMES = ("load_autoencoder_or_generator", "load_generator", "load_config_from_checkpoint")

    def __enter__(self):
        from synthesis_in_style_tpu_torch.scripts import evaluate_checkpoints as ec

        self._originals = {name: getattr(ec, name) for name in self.NAMES}

        def refuse(*args, **kwargs):
            raise AssertionError("evaluate_checkpoints loaded a checkpoint it had evaluated")

        for name in self.NAMES:
            setattr(ec, name, refuse)
        return self

    def __exit__(self, *exc):
        from synthesis_in_style_tpu_torch.scripts import evaluate_checkpoints as ec

        for name, fn in self._originals.items():
            setattr(ec, name, fn)
        return False


def run_evaluate_checkpoints(root: Path, checkpoints: list, val_json: Path, fns: dict) -> dict:
    """`evaluate_checkpoints` with its defaults (-b 8, --num-fid-samples
    1000) on the checkpoints and the val.json, launch counts from 0 and its
    time split; then the same command again, which must skip every
    combination, load nothing and launch nothing."""
    import warnings

    from synthesis_in_style_tpu_torch.scripts import evaluate_checkpoints as ec

    listing = root / "eval_checkpoints.txt"
    listing.write_text("".join(f"{c}\n" for c in checkpoints))
    datasets = root / "eval_datasets.json"
    datasets.write_text(json.dumps([{"name": "pages_val", "images": str(val_json)}]))
    argv = [str(listing), str(datasets), "--evaluation-root", str(root / "evaluation_results"),
            "-b", str(EVAL_BATCH), "--num-fid-samples", str(EVAL_FID_SAMPLES), "-d", DEVICE]
    _count_from_zero(fns)
    report = {}
    with warnings.catch_warnings(), _timed_evaluation() as timed:
        warnings.simplefilter("ignore")
        t0 = time.perf_counter()
        failed = ec.main(ec.build_parser().parse_args(argv), report)
        _sync()
        wall = time.perf_counter() - t0
    launches, shapes = _launches(fns), _path_shapes(fns)
    if failed:
        raise AssertionError(f"evaluate_checkpoints failed: {failed}")
    results = {}
    for path in sorted((root / "evaluation_results" / "pages_val").glob("*.json")):
        results[path.stem] = json.loads(path.read_text())
    names = [Path(c).stem for c in checkpoints]
    want = {f"{n}_{kind}" for n in names for kind in ("reconstruction", "fid")}
    if set(results) != want:
        raise AssertionError(f"evaluate_checkpoints wrote {sorted(results)}, want {sorted(want)}")
    for key, value in results.items():
        numbers = [v for v in value.values() if not isinstance(v, str)]
        if not all(math.isfinite(v) for v in numbers) or ("skipped" in value) == bool(numbers):
            raise AssertionError(f"evaluate_checkpoints {key}: {value}")

    _count_from_zero(fns)
    again = {}
    with _refuse_loading():
        t0 = time.perf_counter()
        failed = ec.main(ec.build_parser().parse_args(argv), again)
        rerun_s = time.perf_counter() - t0
    if failed or any(set(entry) - {"checkpoint", "dataset"} for entry in again["seconds"]) or \
            any(_launches(fns).values()):
        raise AssertionError(f"evaluate_checkpoints' second run: failed {failed}, "
                             f"{again['seconds']}, launches {_launches(fns)}")
    fid_s = sum(entry.get("fid", 0.0) for entry in report["seconds"])
    return {"wall_s": wall, "seconds": report["seconds"], "split": timed.seconds,
            "reconstructed_images": timed.images,
            "fid_s": fid_s, "results": results, "launches": launches, "shapes": shapes,
            "second_run_s": rerun_s}


def run_fid_trend(checkpoints_dir: Path, images: Path, fns: dict) -> dict:
    """`fid_trend` on a run's checkpoints/ at EVAL_TREND, launch counts from 0."""
    import warnings

    from synthesis_in_style_tpu_torch.scripts import fid_trend

    out = checkpoints_dir.parent / "fid_trend.json"
    samples, batch = EVAL_TREND
    _count_from_zero(fns)
    report = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t0 = time.perf_counter()
        rc = fid_trend.main([str(checkpoints_dir), "--images", str(images), "--num-samples",
                             str(samples), "--batch", str(batch), "--json", str(out),
                             "-d", DEVICE], report)
        wall = time.perf_counter() - t0
    trend = json.loads(out.read_text())
    snapshots = sorted(p.stem for p in checkpoints_dir.glob("iter_*.pt"))
    if rc != 0 or list(trend["checkpoints"]) != ["init"] + snapshots or not all(
            math.isfinite(v) and v >= 0 for v in trend["checkpoints"].values()):
        raise AssertionError(f"fid_trend returned {rc}: {trend}")
    return {"wall_s": wall, "seconds": report["seconds"], "trend": trend,
            "launches": _launches(fns), "shapes": _path_shapes(fns)}


def run_results_tools(root: Path, results_json: Path, fns: dict) -> dict:
    """`evaluate_metrics -p -c`, `extract_results_subset` on its first
    EVAL_SUBSET_PAGES pages and `plot_metrics` on a sweep's results.json,
    launch counts from 0 (they launch nothing)."""
    import contextlib
    import io

    from synthesis_in_style_tpu_torch.cli import evaluate_metrics, extract_results_subset
    from synthesis_in_style_tpu_torch.cli import plot_metrics

    _zero(fns)
    seconds = {}
    t0 = time.perf_counter()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        evaluate_metrics.main(evaluate_metrics.build_parser().parse_args(
            [str(results_json), "-p", "-c"]))
    seconds["evaluate_metrics"] = time.perf_counter() - t0
    tables = text.getvalue()
    if "# Config for best mIoU" not in tables or "## Best Results" not in tables:
        raise AssertionError("evaluate_metrics -p -c printed no best-mIoU table")

    results = json.loads(results_json.read_text())
    pages = list(results["runs"][0]["confusion_matrices"])[:EVAL_SUBSET_PAGES]
    subset = root / "subset.txt"
    subset.write_text("".join(f"{p}.png\n" for p in pages))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = extract_results_subset.main(extract_results_subset.build_parser().parse_args(
            [str(results_json), str(subset), "-o", str(root / "subset_results.json")]))
    seconds["extract_results_subset"] = time.perf_counter() - t0
    sub = json.loads(out.read_text())
    if any(set(run["confusion_matrices"]) != set(pages) for run in sub["runs"]):
        raise AssertionError(f"extract_results_subset kept other pages than {pages}")

    t0 = time.perf_counter()
    figures = root / "figures"
    with contextlib.redirect_stdout(io.StringIO()):
        plot_metrics.main(plot_metrics.build_parser().parse_args(
            [str(results_json), str(figures), "-c"]))
    seconds["plot_metrics"] = time.perf_counter() - t0
    metrics = [k for k in results["runs"][0] if k.startswith("average_")]
    names = sorted(p.name for p in figures.glob("*.png"))
    if len(names) != len(metrics) * (len(results["runs"][0]["hyperparams"]) + 1):
        raise AssertionError(f"plot_metrics wrote {names}")
    launches = _launches(fns)
    if any(launches.values()):
        raise AssertionError(f"the results tools launched {launches}")
    return {"seconds": seconds, "table_lines": len(tables.splitlines()), "subset_pages": pages,
            "figures": names, "launches": launches}


def check_coco_dataset(coco_gt: Path) -> dict:
    """COCODataset over a dataset CLI's coco_gt.json through a DataLoader
    with its collate_func: every image once with its annotations."""
    from torch.utils.data import DataLoader

    from synthesis_in_style_tpu_torch.data.coco_dataset import COCODataset

    coco = json.loads(coco_gt.read_text())
    dataset = COCODataset(coco_gt, root=coco_gt.parent)
    t0 = time.perf_counter()
    ids, annotations = [], 0
    for batch in DataLoader(dataset, batch_size=4, collate_fn=COCODataset.collate_func):
        images = batch["images"]
        if images.shape[1:] != (CONFIG_256["image_size"], CONFIG_256["image_size"], 3) or \
                not (images.abs() <= 1).all():
            raise AssertionError(f"COCODataset images {tuple(images.shape)}")
        for image_id, anns in zip(batch["image_id"].tolist(), batch["annotations"]):
            if any(a["image_id"] != image_id for a in anns):
                raise AssertionError(f"COCODataset: image {image_id} got another's annotations")
            ids.append(image_id)
            annotations += len(anns)
    if sorted(ids) != sorted(im["id"] for im in coco["images"]) or \
            annotations != len(coco["annotations"]):
        raise AssertionError(f"COCODataset: images {ids}, {annotations} annotations")
    return {"images": len(ids), "annotations": annotations, "seconds": time.perf_counter() - t0}


def evaluation_phase(root: Path, gan_snapshot: Path, train_pages: Path, ae_snapshot: Path,
                     trend_checkpoints: Path, trend_images: Path, results_json: Path,
                     coco_gt: Path, fns: dict) -> dict:
    """Checkpoint evaluation and results analysis on the earlier phases'
    outputs: the gates card vs CPU with TF32 off (reconstruction PSNR / SSIM,
    FID at -b 8 with the same z), then with PyTorch's defaults
    `evaluate_checkpoints` on the GAN and autoencoder snapshots and the
    pages' val.json (launch counts from 0, exactly the predicted ones; a
    second run skips everything), `fid_trend` on a run's checkpoints/, the
    results CLIs on a sweep's results.json, COCODataset over a coco_gt.json,
    and the bias-act forward and the blur tail at the path's shapes."""
    steps = Steps()
    val_json = write_val_json(train_pages)
    gates = {"reconstruction": reconstruction_card_vs_cpu(ae_snapshot, val_json),
             "fid": fid_card_vs_cpu_at_batch(gan_snapshot, val_json)}
    steps.mark("gates")
    rate = reconstruction_rate(ae_snapshot, val_json)
    steps.mark("reconstruction_rate")
    rec, fid_gate = gates["reconstruction"], gates["fid"]
    log(f"evaluation gates (TF32 off): reconstruction of {EVAL_CHECK_IMAGES} images card vs CPU "
        f"|dPSNR| {rec['psnr_abs_diff']:.3g} dB, |dSSIM| {rec['ssim_abs_diff']:.3g} (in float64 "
        f"{rec['ssim64_abs_diff']:.3g}); FID at {EVAL_CHECK_FID} samples, -b "
        f"{EVAL_BATCH}: features {fid_gate['features_rel_err']:.3g} of max|ref|, distance card "
        f"{fid_gate['fid_card']:.6f} / CPU {fid_gate['fid_cpu']:.6f} "
        f"({fid_gate['fid_rel_diff']:.3g} relative); reconstruction scoring of the val pages on "
        f"the card at -b {EVAL_BATCH}, no loader: {rate['images']} images in "
        f"{rate['seconds']:.3f} s = {rate['images_per_s']:.2f} images/s")

    from synthesis_in_style_tpu_torch.core.config import load_config_from_checkpoint

    config = load_config_from_checkpoint(gan_snapshot)
    size, n_mlp = config["image_size"], config.get("n_mlp", 8)
    checkpoints = run_evaluate_checkpoints(root, [gan_snapshot, ae_snapshot], val_json, fns)
    fid_forwards = 2 * math.ceil(EVAL_FID_SAMPLES / EVAL_BATCH)
    decodes = math.ceil(EVAL_VAL_PAGES / EVAL_BATCH)
    want = _forward_launches(size, fid_forwards, n_mlp)
    for name, n in _expected_launches(size, decodes, 0).items():
        want[name] += n
    _check_launches("evaluate_checkpoints", checkpoints["launches"], want)
    steps.mark("evaluate_checkpoints")
    split = checkpoints["split"]
    log(f"evaluate_checkpoints (-b {EVAL_BATCH}, --num-fid-samples {EVAL_FID_SAMPLES}, the GAN "
        f"and the w+ autoencoder snapshots on {EVAL_VAL_PAGES} val pages): whole command "
        f"{checkpoints['wall_s']:.3f} s; reconstruction of {checkpoints['reconstructed_images']} "
        f"images {split['reconstruction']:.3f} s (2 loader workers started, the PNGs decoded); FID "
        f"{checkpoints['fid_s']:.3f} s = generation {split['generation']:.3f} + features "
        f"{split['features']:.3f} + Frechet {split['frechet']:.3f} s (and loading); results "
        f"{checkpoints['results']}; second run {checkpoints['second_run_s']:.3f} s, nothing "
        f"loaded or launched; launches {checkpoints['launches']}")

    trend = run_fid_trend(trend_checkpoints, trend_images, fns)
    samples, batch = EVAL_TREND
    _check_launches("fid_trend", trend["launches"], _forward_launches(
        size, len(trend["seconds"]) * math.ceil(samples / batch), n_mlp))
    steps.mark("fid_trend")
    log(f"fid_trend (--num-samples {samples} --batch {batch}) on {trend_checkpoints}: " +
        ", ".join(f"{k} {v:.4f} ({trend['seconds'][k]:.3f} s)"
                  for k, v in trend["trend"]["checkpoints"].items())
        + f"; whole command {trend['wall_s']:.3f} s; launches {trend['launches']}")

    tools = run_results_tools(root, results_json, fns)
    coco = check_coco_dataset(coco_gt)
    steps.mark("results_tools")
    log("results tools on the sweep's results.json: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in tools["seconds"].items())
        + f" ({len(tools['figures'])} figures, {tools['table_lines']} table lines); "
        f"COCODataset {coco['images']} images, {coco['annotations']} annotations in "
        f"{coco['seconds']:.3f} s; launches {tools['launches']}")

    set_tf32(False)
    try:
        path_kernels = {name: check_path_kernels(f"evaluation_{name}", entry.pop("shapes"))
                        for name, entry in (("checkpoints", checkpoints), ("fid_trend", trend))}
    finally:
        _defaults()
    steps.mark("path_kernels")
    log("evaluation phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                                 steps.seconds.items()))
    return {"gates": gates, "reconstruction_rate": rate, "evaluate_checkpoints": checkpoints,
            "fid_trend": trend,
            "results_tools": tools, "coco_dataset": coco, "path_kernels": path_kernels,
            "predicted_launches": {"evaluate_checkpoints": want}, "seconds": steps.seconds}


def flash_only(smi: str, detail_path) -> int:
    """`--only flash`: what ptxas reported for the flash kernels, then
    check_flash_attention."""
    from synthesis_in_style_tpu_torch.ops.cuda import build

    ptxas = (build.BUILD_ROOT / build.source_digest() / "flash_attention.log").read_text()
    lines, kernel = [], None
    for line in ptxas.splitlines():
        # a kernel's mangled name, e.g. ...16flash_fwd_kernelIfLi64EEEv...
        entry = re.search(r"Compiling entry function '.*?\d+(flash_[a-z_]+?_kernel)I(\w+?)EEv",
                          line)
        if entry:
            targs = entry.group(2)
            kind = ["bfloat16"] if "bfloat16" in targs else ["float"] * targs.startswith("f")
            kernel = f"{entry.group(1)}<{', '.join(kind + re.findall(r'Li(\d+)E', targs))}>"
            lines.append(kernel + ":")
        elif kernel and ("spill" in line or "Used" in line):
            lines[-1] += " " + line.split(":", 1)[-1].strip()
    log("ptxas, flash_attention.cu:\n" + "\n".join(lines))
    detail = []
    kernels = check_flash_attention(detail)
    if detail_path is not None:
        detail_path.parent.mkdir(parents=True, exist_ok=True)
        detail_path.write_text(json.dumps({"card": smi, "kernels": kernels, "ptxas": lines,
                                           "detail": detail}, indent=1, default=str))
    log(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "only": "flash"}))
    return 0


# ---------------------------------------------------------------------------
# the options phase: the int8 kernel, quantized synthesis and pages, DocUFCN
# remat, a process group of one on NCCL, the sustained-synthesis run

INT8_OPS_PER_S = 1979e12  # H100 SXM int8 tensor cores, dense
INT8_MAIN = ((16, 256, 256, 128), (3, 3, 128, 128))  # the 256px generator's last 3x3
# int8 convolutions a forward: the quantized generator's non-upsampling
# StyledConvs (conv1 and one a level: 1 + 6 at 256px); the quantized
# DocUFCN's convs but the first (4 + 3 x 5 encoder, 3 x 2 decoder, classifier)
INT8_PER_GENERATOR_FORWARD = 7
INT8_PER_DOCUFCN_FORWARD = 26
# bias-act forwards of a quantized 256px forward from z: the 8 mapping
# layers and all 13 StyledConvs (the upsampling ones take the unfused tail)
BIAS_ACT_PER_QUANTIZED_FORWARD = 21
SUSTAINED = {"num_images": 32, "interval": 2.0}
REMAT_BATCH = 8


def _int8_operands(x_shape, w_shape, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(-127, 128, x_shape, generator=g, device="cuda", dtype=torch.int8)
    w = torch.randint(-127, 128, w_shape, generator=g, device="cuda", dtype=torch.int8)
    return x, w


def _int_mm_im2col(x, w, pad: int):
    """The library route: a 9-tap im2col (KH * KW times x) and torch._int_mm."""
    import torch.nn.functional as F

    b, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    cols = torch.cat([xp[:, dy:dy + h, dx:dx + wd] for dy in range(kh) for dx in range(kw)],
                     dim=-1).reshape(b * h * wd, kh * kw * c)
    return torch._int_mm(cols, w.reshape(kh * kw * c, o)).reshape(b, h, wd, o)


def check_int8_conv(shapes, timed: bool = True, checked=()) -> dict:
    """The int8 kernel against its plain version (a float64 convolution of
    the int8 values, exact) on random int8 operands at every (x, w, stride,
    pads, lhs and rhs dilation) in `shapes` (the paths' launches) and the
    main shape: bit for bit. At the main shape: the kernel's time, the plain
    version's, the bound (bytes: x and w read, int32 out written; operations:
    2 x M x N x K at the int8 rate), and as library yardsticks _int_mm over
    an im2col (also held bit for bit) and cuDNN's float32 and bfloat16
    convolutions of the same shape (channels last). Without `timed`, only
    the check at `shapes`; `checked` carries an earlier call's list on."""
    import torch.nn.functional as F

    from synthesis_in_style_tpu_torch.ops.cuda.int8_conv import int8_conv_cuda, int8_conv_plain

    main = (INT8_MAIN[0], INT8_MAIN[1], 1, (1, 1, 1, 1), 1, 1)
    cases = sorted(set(shapes) | ({main} if timed else set()), key=str)
    checked = list(checked)
    for i, (xs, ws, stride, (pt, pb, pl, pr), ld, rd) in enumerate(cases):
        x, w = _int8_operands(xs, ws, SEED + 40 + i)
        kw = dict(stride=stride, padding=((pt, pb), (pl, pr)), lhs_dilation=(ld, ld),
                  rhs_dilation=(rd, rd))
        before = int8_conv_cuda.launches
        got = int8_conv_cuda(x, w, **kw)
        int8_conv_cuda.launches = before  # a comparison launch is not the path's
        want = int8_conv_plain(x, w, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"int8_conv {xs} x {ws} {kw}: kernel and plain differ by "
                                 f"{(got - want).abs().max().item()}")
        checked.append({"x": xs, "w": ws, "stride": stride, "pads": (pt, pb, pl, pr),
                        "lhs_dilation": ld, "rhs_dilation": rd})
    if not timed:
        return {"shapes_checked": checked}
    x, w = _int8_operands(*INT8_MAIN, SEED + 39)
    before = int8_conv_cuda.launches
    ms = bench_ms(lambda: int8_conv_cuda(x, w, padding=1), iters=20)
    queued = queued_ms(lambda: int8_conv_cuda(x, w, padding=1), iters=20)
    plain_ms = bench_ms(lambda: int8_conv_plain(x, w, padding=1), iters=3)
    int8_conv_cuda.launches = before
    library = _int_mm_im2col(x, w, 1)
    if not torch.equal(library, int8_conv_plain(x, w, padding=1)):
        raise AssertionError("int8_conv: _int_mm over the im2col differs from the plain version")
    del library
    library_ms = bench_ms(lambda: _int_mm_im2col(x, w, 1), iters=10)
    xf = x.float().permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    wf = w.float().permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    set_tf32(False)
    cudnn_f32 = bench_ms(lambda: F.conv2d(xf, wf, padding=1), iters=10)
    set_tf32(True)
    cudnn_tf32 = bench_ms(lambda: F.conv2d(xf, wf, padding=1), iters=10)
    xb, wb = xf.to(torch.bfloat16), wf.to(torch.bfloat16)
    cudnn_bf16 = bench_ms(lambda: F.conv2d(xb, wb, padding=1), iters=10)
    torch.backends.cuda.matmul.allow_tf32 = False
    m, n, k = x.shape[0] * x.shape[1] * x.shape[2], w.shape[3], 9 * w.shape[2]
    nbytes = x.numel() + w.numel() + 4 * m * n
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, 2 * m * n * k / INT8_OPS_PER_S * 1e3
    return {"ms": ms, "device_ms": queued, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_cudnn_float32_ms": cudnn_f32, "library_cudnn_tf32_ms": cudnn_tf32,
            "library_cudnn_bf16_ms": cudnn_bf16, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes_bound_ms": by_bytes, "ops_bound_ms": by_ops, "max_abs_err": 0.0,
            "shapes_checked": checked}


# the JAX package's gate (tests/test_quantized_synthesis.py:168-187): layers 4
# and 6, a k = 6 catalog fitted on the float activations, > 0.99 agreement
AGREEMENT_LAYERS, AGREEMENT_K = (4, 6), 6


def quantized_cluster_agreement(run: Path) -> dict:
    """Per-pixel cluster labels of the quantized generator's activations
    against the float generator's on the same latents (batch BATCH, stored
    noise, TF32 off): the JAX package's gate, a k = 6 catalog fitted on the
    float activations of layers 4 and 6, > 0.99 at each; and, reported, the
    dataset path's own catalogs at the layers it labels (8, 9 at 64 px, 12,
    13 at 256 px, where a quantization error has passed more layers)."""
    from synthesis_in_style_tpu_torch.cli.create_dataset_for_segmentation import (
        get_dataset_segmenter,
    )
    from synthesis_in_style_tpu_torch.models.factory import load_generator
    from synthesis_in_style_tpu_torch.segmentation.factor_catalog import FactorCatalog

    ckpt = run / "checkpoints" / "g_ema.pt"
    seg = get_dataset_segmenter(argparse.Namespace(num_clusters=NUM_CLUSTERS), CREATION_CONFIG,
                                256, run / "semantic_segmentation", DEVICE)
    z = torch.randn((BATCH, 512), generator=torch.Generator().manual_seed(SEED + 41))
    layers = sorted(set(AGREEMENT_LAYERS) | {int(k) for k in seg.catalog})
    acts = {}
    set_tf32(False)
    try:
        for quantize in (False, True):
            gen = load_generator(ckpt, {**CONFIG_256, "quantize": quantize}, device=DEVICE)
            with torch.no_grad():
                _, out = gen([z.to(DEVICE)], randomize_noise=False,
                             return_intermediate_activations=True)
            acts[quantize] = {k: out[k] for k in layers}
            del gen, out
        gate, catalog_layers = {}, {}
        for layer in AGREEMENT_LAYERS:
            catalog = FactorCatalog(k=AGREEMENT_K, seed=0)
            want = catalog.fit_predict(acts[False][layer])
            gate[layer] = float((catalog.predict(acts[True][layer]) == want).float().mean())
        for k, catalog in seg.catalog.items():
            want = catalog.predict(acts[False][int(k)])
            catalog_layers[int(k)] = float(
                (catalog.predict(acts[True][int(k)]) == want).float().mean())
        correlation = {k: float(torch.corrcoef(torch.stack([
            acts[False][k].flatten().float(), acts[True][k].flatten().float()]))[0, 1])
            for k in layers}
    finally:
        _defaults()
    if not min(gate.values()) > 0.99:
        raise AssertionError(f"quantized vs float cluster labels at layers {AGREEMENT_LAYERS} "
                             f"(k = {AGREEMENT_K}): {gate}, need > 0.99")
    return {"gate": gate, "dataset_catalogs": catalog_layers, "correlation": correlation}


def quantized_synthesis(run: Path, root: Path, fns: dict) -> dict:
    """The dataset CLI with --quantize (device contours, batch BATCH,
    NUM_IMAGES images) after a warm-up of one batch, with launch counts from
    0: no blur tail, int8 convolutions INT8_PER_GENERATOR_FORWARD a forward
    (the forwards read from the bias-act count), CC launched. Its rate is
    read in turns with the float CLI's in this run (float, int8, int8,
    float; a reading is 2-3 batches, host work included). Returns the
    rates, the launches and the int8 shapes the first int8 reading
    launched."""
    from synthesis_in_style_tpu_torch.ops.cuda.int8_conv import int8_conv_cuda

    drive_path(run, root / "quantized_warmup", extra=("--quantize",), num_images=BATCH)
    readings = {"float32": [], "int8": []}
    for i, kind in enumerate(("float32", "int8", "int8", "float32")):
        if i == 1:
            _zero(fns)
            int8_conv_cuda.shapes.clear()
        out = root / f"generated_{kind}_{i}"
        reading = drive_path(run, out, extra=("--quantize",) if kind == "int8" else ())
        readings[kind].append(reading["written"] / reading["seconds"])
        if i == 1:
            path, launches, shapes = reading, _launches(fns), dict(int8_conv_cuda.shapes)
            n = check_outputs(out)
    forwards, rest = divmod(launches["fused_bias_act"], BIAS_ACT_PER_QUANTIZED_FORWARD)
    want = {"fused_blur": 0, "int8_conv": INT8_PER_GENERATOR_FORWARD * forwards}
    if rest or not forwards:
        raise AssertionError(f"quantized synthesis: {launches['fused_bias_act']} bias-act "
                             f"forwards are no whole number of forwards of "
                             f"{BIAS_ACT_PER_QUANTIZED_FORWARD}")
    _check_launches("quantized synthesis", launches, want)
    return {**path, "images_per_s": readings["int8"],
            "float32_images_per_s": readings["float32"], "launches": launches,
            "forwards": forwards, "pngs": n, "shapes": shapes}


def _page_segmenter_q(snap, fused: bool, quantized: bool, network=None):
    from synthesis_in_style_tpu_torch.segmentation.analysis_segmenter import (
        VotingAssemblySegmenter,
    )

    extra = ({"network": copy.deepcopy(network),
              "config": {"image_size": 256, "batch_size": SEG_OVERRIDES.get("batch_size", 8)}}
             if network is not None else {})
    seg = VotingAssemblySegmenter(snap, COLOR_MAP, use_device_component_filter=True,
                                  fused_page_inference=fused, quantized=quantized,
                                  device=DEVICE, **extra)
    seg.set_hyperparams({"min_confidence": 0.7, "min_contour_area": 55})
    return seg


def quantized_pages(root: Path, snap: Path, images, pages: Path, pages_gt: Path,
                    fns: dict) -> dict:
    """The segmenter phase's DocUFCN snapshot and 2048x1536 pages served in
    w8a8 int8: pages/s unfused and fused (one page a call, a CUDA graph per
    tiling), beside float32 in this run (a warm pass, then SERVING_ROUNDS
    timed passes, 0.7 / 55); then the analyze CLI with --quantize at 0.7 /
    55 with launch counts from 0 (int8 INT8_PER_DOCUFCN_FORWARD a patch
    batch, CC launched). Returns the rates, the CLI's launches and the int8
    shapes the unfused route launched."""
    from synthesis_in_style_tpu_torch.ops.cuda.int8_conv import int8_conv_cuda

    int8_conv_cuda.shapes.clear()
    rates = {}
    for quantized in (False, True):
        for fused in (False, True):
            seg = _page_segmenter_q(snap, fused, quantized)
            _sync()
            t0 = time.perf_counter()
            for image in images:
                seg.segment_image_classes(image)
            _sync()
            first = time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in range(SERVING_ROUNDS):
                for image in images:
                    seg.segment_image_classes(image)
            _sync()
            seconds = time.perf_counter() - t0
            key = f"{'fused' if fused else 'unfused'}_{'int8' if quantized else 'float32'}"
            rates[key] = {"pages_per_s": SERVING_ROUNDS * len(images) / seconds,
                          "first_pass_s": first, "graphs": len(seg.page_programs())}
            if quantized and fused:
                rates[key]["int8_launches_per_replay"] = [
                    p.int8_launches_per_replay for p in seg.page_programs()]
            _drop(seg)
    shapes = dict(int8_conv_cuda.shapes)

    _zero(fns)
    cli_s = run_analyze(pages, pages_gt, snap, root / "analyze_quantized",
                        sweep={"min_confidence": ("0.7",), "min_contour_area": ("55",)},
                        extra=("--quantize",))
    launches = _launches(fns)
    seg = _page_segmenter_q(snap, False, False)
    batches = math.ceil(len(seg.calculate_bboxes_for_patches(images[0].width,
                                                             images[0].height))
                        / seg.batch_size)
    _check_launches("quantized pages CLI", launches,
                    {"int8_conv": INT8_PER_DOCUFCN_FORWARD * batches * len(images)})
    if launches["segmented_cc"] <= 0:
        raise AssertionError("quantized pages CLI: no CC labelling")
    return {"rates": rates, "cli_seconds": cli_s, "cli_launches": launches,
            "patch_batches_per_page": batches, "shapes": shapes}


def quantized_page_agreement(snap: Path, images) -> dict:
    """Class maps of int8 serving against float32 at 0.0 / 0, TF32 off: on
    the snapshot's pages (the served path; > 0.97, the JAX package's gate)
    and, reported, on the seeded multi-class DocUFCN (random weights and a
    classifier scaled by PARITY_LOGIT_SCALE: many pixels within a small
    margin of a tie)."""
    import numpy as np

    agreement = {}
    net = seeded_page_network(images[0])
    set_tf32(False)
    try:
        for name, snapshot, network in (("snapshot", snap, None),
                                        ("seeded_multi_class", None, net)):
            maps = {}
            for quantized in (False, True):
                seg = _page_segmenter_q(snapshot, False, quantized, network)
                seg.set_hyperparams({"min_confidence": 0.0, "min_contour_area": 0})
                maps[quantized] = [seg.segment_image_classes(image) for image in images]
                _drop(seg)
            agreement[name] = float(np.mean([(a == b).mean()
                                             for a, b in zip(maps[False], maps[True])]))
            agreement[f"{name}_class_shares"] = [
                float(np.mean([(m == k).mean() for m in maps[False]])) for k in range(3)]
    finally:
        _defaults()
    if not agreement["snapshot"] > 0.97:
        raise AssertionError(f"quantized pages: class maps agree with float32 on "
                             f"{agreement['snapshot']:.5f} of pixels, need > 0.97")
    return agreement


def check_quantized_docufcn_fitted() -> dict:
    """The JAX package's own gate (tests/test_quantized_docufcn.py:48-101) on
    the card: a DocUFCN of widths (8, 16, 24, 32) from a seeded init, two
    train-mode BatchNorm updates on uniform [-1, 1] inputs (2, 64, 64, 3)
    (the second + 0.1), calibrated on those inputs; quantized against float
    logits, TF32 off: correlation > 0.995 and argmax agreement > 0.97, for
    both decoders. Widths of 24 channels take the kernel's byte-wise loads."""
    from synthesis_in_style_tpu_torch.models.doc_ufcn import DocUFCN
    from synthesis_in_style_tpu_torch.models.doc_ufcn_quant import quantize_for_serving

    out = {}
    set_tf32(False)
    try:
        for pixel_shuffle in (False, True):
            net = DocUFCN(num_classes=3, feature_sizes=(8, 16, 24, 32),
                          pixel_shuffle=pixel_shuffle)
            net.init_weights(torch.Generator().manual_seed(SEED + 46)).to(DEVICE)
            x = (torch.rand((2, 3, 64, 64), generator=torch.Generator().manual_seed(SEED + 47))
                 * 2 - 1).to(DEVICE)
            torch.manual_seed(SEED + 48)
            with torch.no_grad():
                for i in range(2):
                    net.train()(x + 0.1 * i)
                net.eval()
                want = net(x)
                got = quantize_for_serving(net, [x])(x)
            corr = float(torch.corrcoef(torch.stack([want.flatten(), got.flatten()]))[0, 1])
            agree = float((want.argmax(1) == got.argmax(1)).float().mean())
            out["pixel_shuffle" if pixel_shuffle else "base"] = {"correlation": corr,
                                                                "agreement": agree}
            if not (corr > 0.995 and agree > 0.97):
                raise AssertionError(f"fitted DocUFCN (pixel_shuffle {pixel_shuffle}): "
                                     f"correlation {corr:.5f}, agreement {agree:.5f}")
    finally:
        _defaults()
    return out


def _doc_ufcn_batch(batch: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    images = (torch.rand((batch, 3, 256, 256), generator=g) * 2 - 1).to(DEVICE)
    labels = torch.randint(0, 3, (batch, 256, 256), generator=g).to(DEVICE)
    return images.contiguous(memory_format=torch.channels_last), labels


def check_doc_ufcn_remat() -> dict:
    """Two training steps of the shipped DocUFCN (32/64/128/256, dropout
    0.4, 256px, batch REMAT_BATCH, float32, TF32 off, cuDNN deterministic)
    with and without remat from the same weights and dropout seeds (an SGD
    update of 1e-3 between): every gradient within 1e-5 of its tensor's
    largest (a conv bias feeding train-mode BatchNorm, true gradient 0: of
    the step's largest), the BatchNorm statistics within 1e-5, the
    statistics moved once a step; peak allocated memory of each."""
    from synthesis_in_style_tpu_torch.losses.segmentation import cross_entropy_loss
    from synthesis_in_style_tpu_torch.models.doc_ufcn import DocUFCN

    set_tf32(False)
    torch.backends.cudnn.deterministic = True
    try:
        base = DocUFCN(num_classes=3).init_weights(torch.Generator().manual_seed(SEED + 42))
        out = {}
        for remat in (False, True):
            net = DocUFCN(num_classes=3, remat=remat)
            net.load_state_dict(base.state_dict())
            net.to(DEVICE).train()
            grads, peaks = [], []
            for step in range(2):
                images, labels = _doc_ufcn_batch(REMAT_BATCH, SEED + 43 + step)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                torch.manual_seed(SEED + 44 + step)
                loss = cross_entropy_loss(net(images), labels)
                g = torch.autograd.grad(loss, list(net.parameters()))
                torch.cuda.synchronize()
                peaks.append(torch.cuda.max_memory_allocated())
                with torch.no_grad():
                    for p, gp in zip(net.parameters(), g):
                        p.sub_(1e-3 * gp)
                grads.append([gp.detach().clone() for gp in g])
            out[remat] = {"grads": grads, "peak_bytes": max(peaks),
                          "state": {k: v.detach().clone() for k, v in net.state_dict().items()},
                          "names": [n for n, _ in net.named_parameters()]}
            del net
    finally:
        torch.backends.cudnn.deterministic = False
        _defaults()
    worst = 0.0
    names = out[False]["names"]
    for step in range(2):
        a, b = out[False]["grads"][step], out[True]["grads"][step]
        largest = max(float(t.abs().max()) for t in a)
        for name, ga, gb in zip(names, a, b):
            scale = largest if name.endswith("conv.bias") and "classifier" not in name else \
                float(ga.abs().max())
            err = float((ga - gb).abs().max()) / max(scale, 1e-30)
            worst = max(worst, err)
            if err > 1e-5:
                raise AssertionError(f"remat step {step}: {name} gradient {err:.3g} of its "
                                     f"scale from remat: false")
    for k, v in out[False]["state"].items():
        w = out[True]["state"][k]
        if "num_batches_tracked" in k:
            if int(w) != 2 or int(v) != 2:
                raise AssertionError(f"remat: {k} = {int(w)} / {int(v)}, want 2")
        elif float((w - v).abs().max()) > 1e-5 * float(v.abs().max()):
            raise AssertionError(f"remat: {k} differs from remat: false")
    return {"worst_grad_rel_err": worst, "peak_bytes_plain": out[False]["peak_bytes"],
            "peak_bytes_remat": out[True]["peak_bytes"], "batch": REMAT_BATCH}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _distributed_steps(seed: int) -> dict:
    """One DocUFCN weighted cross-entropy step (the shipped widths, no
    dropout, batch REMAT_BATCH, 256px, float64: the route's BatchNorm and
    cuDNN's sum in other orders, which float32 shows in the gradients of
    the BatchNorm shifts, sums of 2^19 terms that nearly cancel) and one
    full-width 256px StyleGAN2 iteration (D, R1, G, path length, EMA; batch
    4; float32) from seeded weights, through the updaters (Adam with eps 1,
    so a near-zero gradient moves its parameter by a near-zero amount, not
    +-lr); their states before ("<key>_before") and after."""
    from synthesis_in_style_tpu_torch.models.doc_ufcn import get_doc_ufcn
    from synthesis_in_style_tpu_torch.models.factory import get_discriminator, get_generator
    from synthesis_in_style_tpu_torch.updaters.segmentation_updater import SegmentationUpdater
    from synthesis_in_style_tpu_torch.updaters.stylegan2_updater import (
        GANOptimizer,
        StyleGAN2Config,
        StyleGAN2Updater,
        create_gan_train_state,
    )

    def snapshot(module):
        return {k: v.detach().clone() for k, v in module.state_dict().items()}

    out = {}
    net = get_doc_ufcn("no_dropout")(num_classes=3).init_weights(
        torch.Generator().manual_seed(seed)).to(DEVICE, torch.float64)
    out["docufcn_before"] = snapshot(net)
    opt = GANOptimizer(net.parameters(), lambda _: 1e-3, (0.9, 0.999), eps=1.0,
                       weight_decay=1e-4)
    images, labels = _doc_ufcn_batch(REMAT_BATCH, seed + 1)
    batch = {"images": images.permute(0, 2, 3, 1).contiguous().double(), "segmented": labels}
    updater = SegmentationUpdater(net, opt, {"images": iter([batch])},
                                  class_weights=[1.0, 1.0, 1.0], device=DEVICE)
    updater.report = lambda *a, **k: None
    updater.update()
    out["docufcn"] = snapshot(net)

    gen = get_generator(CONFIG_256).init_weights(torch.Generator().manual_seed(seed + 2))
    disc = get_discriminator(CONFIG_256).init_weights(torch.Generator().manual_seed(seed + 3))
    gen, disc = gen.to(DEVICE), disc.to(DEVICE)
    out["generator_before"], out["discriminator_before"] = snapshot(gen), snapshot(disc)
    out["g_ema_before"] = out["generator_before"]
    state = create_gan_train_state(gen, disc, lambda _: 2e-3, lambda _: 2e-3, (0.0, 0.99),
                                   (0.0, 0.99))
    state.g_optimizer = GANOptimizer(gen.parameters(), lambda _: 2e-3, (0.0, 0.99), eps=1.0)
    state.d_optimizer = GANOptimizer(disc.parameters(), lambda _: 2e-3, (0.0, 0.99), eps=1.0)
    size = CONFIG_256["image_size"]
    real = torch.rand((4, size, size, 3), generator=torch.Generator().manual_seed(seed + 4))
    gan = StyleGAN2Updater(state, {"images": iter([(real * 2 - 1).to(DEVICE)])}, batch_size=4,
                           cfg=StyleGAN2Config(d_reg_every=1, g_reg_every=1), seed=seed,
                           device=DEVICE)
    metrics = {}
    gan.report = lambda values, prefix="": metrics.update(
        {k: float(v) for k, v in values.items()})
    gan.update()
    for key, module in (("generator", gen), ("discriminator", disc), ("g_ema", state.g_ema)):
        out[key] = snapshot(module)
    out["gan_metrics"] = metrics
    return out


def check_process_group_of_one() -> dict:
    """The distributed route in a process group of world size 1 on NCCL
    (the one card; world size 2 runs only in the CPU tests): a DocUFCN step
    and a GAN iteration through it (BatchNorm by all-reduces, the gradients'
    all-reduce, the minibatch stddev's all-gather, the global path-length
    mean, the metrics' all-reduce), then the same single-process from the
    same seeds, TF32 off and cuDNN deterministic: every tensor within 1e-5
    of the larger of its largest element and the step's largest update of
    that network (a zero-initialised bias moves by its update alone), the
    metrics within 1e-5 relative."""
    import torch.distributed as dist

    from synthesis_in_style_tpu_torch.parallel import distributed

    env = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port())}
    saved = {k: os.environ.get(k) for k in env}
    set_tf32(False)
    torch.backends.cudnn.deterministic = True
    try:
        os.environ.update(env)
        t0 = time.perf_counter()
        if not distributed.maybe_initialize_distributed(device="cuda"):
            raise AssertionError("no process group opened")
        backend = dist.get_backend()
        init_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        grouped = _distributed_steps(SEED + 45)
        torch.cuda.synchronize()
        grouped_s = time.perf_counter() - t0
        dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        t0 = time.perf_counter()
        single = _distributed_steps(SEED + 45)
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        torch.backends.cudnn.deterministic = False
        _defaults()
    if backend != "nccl":
        raise AssertionError(f"process group backend {backend}, want nccl")
    worst = {}
    for key in ("docufcn", "generator", "discriminator", "g_ema"):
        a, b, before = grouped[key], single[key], single[f"{key}_before"]
        largest_update = max(float((b[k] - before[k]).abs().max()) for k in b
                             if b[k].is_floating_point())
        worst[key] = 0.0
        for k in a:
            if not a[k].is_floating_point():
                if not torch.equal(a[k], b[k]):
                    raise AssertionError(f"process group of one, {key}: {k} differs")
                continue
            scale = max(float(b[k].abs().max()), largest_update)
            err = float((a[k] - b[k]).abs().max()) / max(scale, 1e-30)
            worst[key] = max(worst[key], err)
            if err > 1e-5:
                raise AssertionError(f"process group of one, {key}: {k} {err:.3g} of its "
                                     f"largest from the single-process step")
    for k, v in single["gan_metrics"].items():
        got = grouped["gan_metrics"][k]
        if abs(got - v) > 1e-5 * abs(v) + 1e-7:
            raise AssertionError(f"process group of one: metric {k} {got} vs {v}")
    return {"backend": backend, "init_s": init_s, "grouped_s": grouped_s,
            "single_s": single_s, "worst_rel_err": worst, "gan_metrics": single["gan_metrics"]}


def run_sustained_synthesis(run: Path, root: Path) -> dict:
    """scripts/sustained_synthesis.py over the dataset CLI on the card
    (--device-contours, batch BATCH, --quantize off): its JSONL series
    (pairs written, the window's pairs/s, the CLI's RSS and open files) and
    the overall rate, in a subprocess of its own (which ends with the CLI)."""
    monitor = root / "sustained.jsonl"
    cmd = [sys.executable, "-m", "synthesis_in_style_tpu_torch.scripts.sustained_synthesis",
           str(run / "checkpoints" / "g_ema.pt"), str(run / "creation_config.json"),
           "-n", str(SUSTAINED["num_images"]), "--interval", str(SUSTAINED["interval"]),
           "--monitor-out", str(monitor), "--", "-b", str(BATCH), "--num-clusters",
           str(NUM_CLUSTERS), "-d", DEVICE, "--device-contours"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"sustained_synthesis exit {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    rows = [json.loads(line) for line in monitor.read_text().splitlines()]
    summary = [line for line in proc.stdout.splitlines() if line.startswith("CLI exit")]
    if not rows or not summary:
        raise AssertionError(f"sustained_synthesis: no samples ({proc.stdout[-2000:]})")
    return {"rows": rows, "summary": summary[-1], "seconds": seconds,
            "max_rss_mb": max(r["rss_mb"] or 0 for r in rows),
            "max_fds": max(r["fds"] or 0 for r in rows)}


def options_phase(root: Path, run: Path, snap: Path, pages: Path, pages_gt: Path,
                  fns: dict) -> dict:
    """The int8 serving paths, DocUFCN remat, a process group of one on NCCL
    and the sustained-synthesis run (module docstring, step 17)."""
    steps = Steps()
    synthesis = quantized_synthesis(run, root, fns)
    steps.mark("quantized_synthesis")
    # the kernel at the generator's shapes before anything reads its output
    kernel = check_int8_conv(list(synthesis.pop("shapes")), timed=False)
    synthesis["cluster_agreement"] = quantized_cluster_agreement(run)
    steps.mark("agreement")
    from PIL import Image

    images = [Image.open(p).convert("RGB") for p in sorted(pages.glob("*.png"))]
    page = quantized_pages(root, snap, images, pages, pages_gt, fns)
    steps.mark("quantized_pages")
    from synthesis_in_style_tpu_torch.ops.cuda.int8_conv import int8_conv_cuda

    int8_conv_cuda.shapes.clear()
    page["fitted_gate"] = check_quantized_docufcn_fitted()
    fitted_shapes = list(int8_conv_cuda.shapes)
    set_tf32(False)
    try:
        kernel = check_int8_conv(list(page.pop("shapes")) + fitted_shapes,
                                 checked=kernel["shapes_checked"])
    finally:
        _defaults()
    steps.mark("int8_kernel")
    page["agreement"] = quantized_page_agreement(snap, images)
    steps.mark("page_agreement")
    remat = check_doc_ufcn_remat()
    steps.mark("remat")
    group = check_process_group_of_one()
    steps.mark("process_group")
    sustained = run_sustained_synthesis(run, root)
    steps.mark("sustained")
    log(f"int8_conv at {INT8_MAIN[0]} x {INT8_MAIN[1]}: {kernel['ms']:.4f} ms (queued "
        f"{kernel['device_ms']:.4f}) against a bound of {kernel['bound_ms']:.4f} "
        f"({kernel['bound_by']}; operations {kernel['ops_bound_ms']:.4f}); plain "
        f"{kernel['plain_ms']:.3f}; _int_mm over im2col {kernel['library_ms']:.4f}, cuDNN "
        f"float32 {kernel['library_cudnn_float32_ms']:.4f}, TF32 "
        f"{kernel['library_cudnn_tf32_ms']:.4f}, bfloat16 {kernel['library_cudnn_bf16_ms']:.4f}; "
        f"bit-exact at {len(kernel['shapes_checked'])} shapes")
    log(f"quantized synthesis (--quantize, 256px, batch {BATCH}, {synthesis['written']} "
        f"images): labelled images/s int8 {synthesis['images_per_s']}, float32 in turns "
        f"{synthesis['float32_images_per_s']}; launches "
        f"{synthesis['launches']} ({synthesis['forwards']} forwards); cluster labels vs float "
        f"(TF32 off) {synthesis['cluster_agreement']}")
    log("quantized pages (2048x1536, 0.7 / 55): " + "; ".join(
        f"{k} {v['pages_per_s']:.3f} pages/s" for k, v in page["rates"].items())
        + f"; class maps vs float32 at 0.0 / 0 (TF32 off) {page['agreement']}; the JAX "
        f"package's fitted-model gate {page['fitted_gate']}; CLI --quantize "
        f"{page['cli_seconds']:.3f} s, launches {page['cli_launches']}")
    log(f"DocUFCN remat (batch {REMAT_BATCH}, 2 steps): gradients within "
        f"{remat['worst_grad_rel_err']:.3g} of remat: false; peak allocated "
        f"{remat['peak_bytes_plain'] / 2**30:.3f} GiB without, "
        f"{remat['peak_bytes_remat'] / 2**30:.3f} GiB with")
    log(f"process group of one ({group['backend']}, init {group['init_s']:.2f} s): DocUFCN "
        f"step and GAN iteration {group['grouped_s']:.2f} s against {group['single_s']:.2f} s "
        f"single-process, worst {group['worst_rel_err']}")
    log(f"sustained_synthesis ({SUSTAINED['num_images']} images, every "
        f"{SUSTAINED['interval']} s): {sustained['summary']}; samples {sustained['rows']}")
    return {"synthesis": synthesis, "pages": page, "int8_conv": kernel, "remat": remat,
            "process_group": group, "sustained": sustained, "seconds": steps.seconds}


# ---------------------------------------------------------------------------
# the phases: each names the phases whose outputs it needs, and returns its
# result with `paths`: {path: (launch counts, kernels that must have run)}

BIAS_BLUR = ("fused_bias_act", "fused_blur")
GAN_TRAINING = ("fused_bias_act", "fused_bias_act_bwd", "fused_blur")
FLASH = ("flash_attention_fwd", "flash_attention_bwd")


def _defaults() -> None:
    """PyTorch's defaults: TF32 cuDNN convolutions, float32 matmuls."""
    set_tf32(True)
    torch.backends.cuda.matmul.allow_tf32 = False


class Context:
    """What the phases share: the temporary root, the launch counters, the
    kernel rows and detail lists, and each finished phase's result."""

    def __init__(self, root: Path, fns: dict):
        self.root, self.fns = root, fns
        self.kernels = {}
        self.detail = {name: [] for name in (
            "fused_bias_act", "fused_bias_act_edges", "fused_bias_act_path_shapes",
            "fused_bias_act_bwd", "fused_blur", "segmented_cc", "autograd", "training_iteration",
            "flash_attention", "fused_bias_act_path_shapes_swagan")}
        self.results = {}

    def __getitem__(self, phase: str) -> dict:
        return self.results[phase]

    def add_kernel(self, name: str, row: dict) -> None:
        """A kernel's row, its error the larger of this and any earlier one."""
        old = self.kernels.get(name, {})
        self.kernels[name] = {**old, **row,
                              "max_abs_err": max(old.get("max_abs_err", 0.0), row["max_abs_err"])}

    def add_error(self, name: str, err: float) -> None:
        self.add_kernel(name, {"max_abs_err": err})


def phase_kernels(ctx: Context) -> dict:
    steps = Steps()
    detail = ctx.detail
    ctx.add_kernel("fused_bias_act", check_fused_bias_act(detail["fused_bias_act"]))
    ctx.add_kernel("fused_bias_act_bwd", check_fused_bias_act_bwd(detail["fused_bias_act_bwd"]))
    ctx.add_kernel("fused_blur", check_fused_blur(detail["fused_blur"]))
    ctx.add_error("fused_bias_act", check_fused_bias_act_edges(detail["fused_bias_act_edges"]))
    steps.mark("elementwise")
    for name, row in check_flash_attention(detail["flash_attention"]).items():
        ctx.add_kernel(name, row)
    steps.mark("flash")
    check_autograd_functions(detail["autograd"])
    steps.mark("autograd")
    return {"paths": {}, "seconds": steps.seconds}


def phase_training_iterations(ctx: Context) -> dict:
    steps = Steps()
    check_training_iteration(ctx.detail["training_iteration"])
    steps.mark("stylegan2")
    check_training_iteration(ctx.detail["training_iteration"], SWAGAN_CONFIG)
    steps.mark("swagan")
    return {"paths": {}, "seconds": steps.seconds}


def phase_discovery(ctx: Context) -> dict:
    run = make_run_dir(ctx.root)
    discovery = discovery_phase(run, ctx.fns)
    return {**discovery, "run": run,
            "paths": {"discovery": (discovery["launches"], BIAS_BLUR),
                      "selection": (discovery["selection_launches"], BIAS_BLUR)}}


def phase_dataset(ctx: Context) -> dict:
    from synthesis_in_style_tpu_torch.models.factory import load_generator

    steps = Steps()
    root, fns, run = ctx.root, ctx.fns, ctx["discovery"]["run"]
    gen = load_generator(run / "checkpoints" / "g_ema.pt", CONFIG_256, device="cuda")
    write_catalog(run, gen)
    del gen
    (run / "creation_config.json").write_text(json.dumps(CREATION_CONFIG))
    path_masks = reference_check(run)
    ctx.add_kernel("segmented_cc", check_segmented_cc(ctx.detail["segmented_cc"], path_masks))
    steps.mark("reference_and_cc")
    _defaults()
    drive_path(run, root / "warmup")
    steps.mark("warmup")
    _zero(fns)
    path = drive_path(run, root / "generated_images")
    launches = _launches(fns)
    n = check_outputs(root / "generated_images")
    steps.mark("device_route")
    stages = stage_times(run, root / "stages")
    steps.mark("stages")
    log(f"per batch of {BATCH}: " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items() if k != "batch"))
    log(f"dataset path PNG writing: {stages['png_s']:.4f} s a batch over "
        f"{stages['png_threads']} threads against {stages['png_1thread_s']:.4f} s in one")
    host_route = host_route_phase(run, root, fns)
    steps.mark("host_route")
    log(f"dataset path: {path['written']} images in {path['seconds']:.3f} s = "
        f"{path['written'] / path['seconds']:.2f} images/s (batch {BATCH}, build_dataset "
        f"wall time, warm); launches {launches}; {n} PNG pairs checked")
    return {"path": {**path, "launches": launches, "stages": stages},
            "host_route": host_route, "generated_images": root / "generated_images",
            "coco_gt": root / "generated_host" / "coco_gt.json",
            "paths": {"dataset": (launches, BIAS_BLUR + ("segmented_cc",)),
                      "dataset_host": (host_route["launches"], ())},
            "seconds": steps.seconds}


def phase_training(ctx: Context) -> dict:
    steps = Steps()
    root, fns = ctx.root, ctx.fns
    pages = write_training_pages(root)
    run_training_cli(pages, root / "train_warmup", config_name="config_warmup.json")
    steps.mark("warmup")
    _zero(fns)
    fns["fused_bias_act"].shapes.clear()
    trainer, train_wall = run_training_cli(pages, root / "train")
    launches = _launches(fns)
    training_shapes = dict(fns["fused_bias_act"].shapes)
    losses = check_training_run(trainer, root / "train")
    iters = trainer.updater.iteration
    steps.mark("measured")
    iteration_profile = profile_iteration(trainer)
    steps.mark("profile")
    set_tf32(False)
    try:
        path_shapes = check_fused_bias_act_path_shapes(
            ctx.detail["fused_bias_act_path_shapes"], training_shapes, iters)
    finally:
        _defaults()
    for row in ctx.detail["fused_bias_act_path_shapes"]:
        ctx.add_error("fused_bias_act", row["max_abs_err"])
    steps.mark("path_shapes")
    batch = TRAIN_OVERRIDES["batch_size"]
    training = {"iterations": iters, "batch": batch, "loop_seconds": trainer.seconds,
                "cli_seconds": train_wall, "iterations_per_s": iters / trainer.seconds,
                "images_per_s": iters * batch / trainer.seconds, "launches": launches,
                "losses": losses, "profile": iteration_profile,
                "fused_bias_act_shapes": path_shapes}
    log(f"training path (256px, batch {batch}, bf16, {iters} iterations): "
        f"{training['iterations_per_s']:.3f} iterations/s = {training['images_per_s']:.2f} "
        f"training images/s (train loop {trainer.seconds:.3f} s, whole CLI {train_wall:.3f} s, "
        f"warm); launches {launches}")
    prof = training["profile"]
    log(f"profiled iteration {prof['iteration']}: wall {prof['wall_s']:.4f} s, device busy "
        f"{prof['device_busy_s']:.4f} s ({prof['device_busy_share']:.3f}); top kernels: " +
        "; ".join(f"{k['name']} x{k['calls']} {k['device_s']:.4f} s" for k in prof["top_kernels"]))
    log("the port's kernels in that iteration: " + "; ".join(
        f"{k} x{v['calls']} {v['device_s']:.6f} s" for k, v in prof["port_kernels"].items()))
    (gan_run,) = (root / "train" / "stylegan2").iterdir()
    return {**training, "pages": pages,
            "snapshot": gan_run / "checkpoints" / f"iter_{TRAIN_OVERRIDES['max_iter']:08d}.pt",
            "paths": {"training": (launches, GAN_TRAINING)}, "seconds": steps.seconds}


def phase_segmenter(ctx: Context) -> dict:
    segmenter = segmenter_phase(ctx.root, ctx["dataset"]["generated_images"], ctx.fns,
                                ctx.detail["segmented_cc"])
    page_cc = segmenter["page"]["cc"]
    ctx.kernels.setdefault("segmented_cc", {"max_abs_err": 0.0}).update(
        {"page_ms": page_cc["ms"], "page_plain_ms": page_cc["plain_ms"],
         "page_bound_ms": page_cc["bound_ms"]})
    return {**segmenter, "results_json": ctx.root / "analyze" / "results.json",
            "paths": {"segmenter_training": (segmenter["launches"], ()),
                      "page_inference": (segmenter["page_launches"], ("segmented_cc",)),
                      "page_host_filter": (segmenter["host_filter_launches"], ())}}


def phase_serving(ctx: Context) -> dict:
    seg = ctx["segmenter"]
    serving = serving_phase(ctx.root, Path(seg["snapshot"]), Path(seg["pages"]),
                            Path(seg["pages_gt"]), ctx.fns)
    return {**serving, "paths": {"page_serving": (serving["cli_launches"], ("segmented_cc",))}}


def phase_transunet(ctx: Context) -> dict:
    seg = ctx["segmenter"]
    tu = transunet_phase(ctx.root, ctx["dataset"]["generated_images"], Path(seg["pages"]),
                         Path(seg["pages_gt"]), ctx.fns)
    flash, xla = tu["training_flash"], tu["training_xla"]
    return {**tu, "paths": {
        "transunet_training_flash": (flash["launches"], FLASH),
        "transunet_training_xla": (xla["launches"], ()),
        "transunet_float32_step_flash": (flash["float32_step"]["launches"], FLASH),
        "transunet_float32_step_xla": (xla["float32_step"]["launches"], ()),
        "transunet_page_inference": (tu["page"]["launches"],
                                     ("flash_attention_fwd", "segmented_cc"))}}


def phase_swagan_emanet(ctx: Context) -> dict:
    seg = ctx["segmenter"]
    sw = swagan_emanet_phase(ctx.root, ctx["training"]["pages"], Path(seg["pages"]),
                             Path(seg["pages_gt"]), ctx.fns, ctx.detail)
    return {**sw, "paths": {
        "swagan_training": (sw["training"]["launches"], GAN_TRAINING),
        "swagan_discovery": (sw["dataset"]["discovery_launches"], BIAS_BLUR),
        "swagan_dataset": (sw["dataset"]["launches"], BIAS_BLUR + ("segmented_cc",)),
        "emanet_training": (sw["emanet"]["launches"], ()),
        "emanet_page_inference": (sw["emanet"]["pages"]["launches"], ("segmented_cc",))}}


def phase_dataset_gan(ctx: Context) -> dict:
    dg = dataset_gan_phase(ctx.root, ctx["training"]["snapshot"],
                           Path(ctx["swagan_emanet"]["training"]["snapshot"]), ctx.fns)
    return {**dg, "paths": {f"dataset_gan_{leg}": (dg[leg]["launches"], BIAS_BLUR)
                            for leg in ("activations", "training", "dataset")}}


def phase_capstone(ctx: Context) -> dict:
    cap = capstone_phase(ctx.root, ctx.fns)
    return {**cap, "paths": {"capstone_gan_128": (cap["launches_128"], GAN_TRAINING),
                             "capstone_gan_256": (cap["launches_256"], GAN_TRAINING),
                             "capstone_chain": (cap["chain_launches"],
                                                BIAS_BLUR + ("segmented_cc",))}}


def phase_autoencoder(ctx: Context) -> dict:
    ae = autoencoder_phase(ctx.root, ctx["training"]["snapshot"], ctx["training"]["pages"],
                           ctx.fns)
    for leg in ("ae_training", "adversarial", "projection"):  # the branch's path shapes
        for row in ae[leg]["path_kernels"]:
            ctx.add_error(row["kernel"], row["max_abs_err"])
    needed = {"ae_training": GAN_TRAINING, "adversarial": GAN_TRAINING,
              "projection": GAN_TRAINING, "discovery_images": BIAS_BLUR}
    return {**ae, "paths": {f"autoencoder_{leg}": (ae[leg]["launches"], needed.get(leg, ()))
                            for leg in AUTOENCODER_LEGS}}


def phase_options(ctx: Context) -> dict:
    seg = ctx["segmenter"]
    opt = options_phase(ctx.root, ctx["discovery"]["run"], Path(seg["snapshot"]),
                        Path(seg["pages"]), Path(seg["pages_gt"]), ctx.fns)
    ctx.add_kernel("int8_conv", {k: v for k, v in opt["int8_conv"].items()
                                 if k != "shapes_checked"})
    return {**opt, "paths": {
        "quantized_synthesis": (opt["synthesis"]["launches"],
                                ("fused_bias_act", "int8_conv", "segmented_cc")),
        "quantized_pages": (opt["pages"]["cli_launches"], ("int8_conv", "segmented_cc"))}}


def phase_evaluation(ctx: Context) -> dict:
    cap = ctx["capstone"]
    fixture = ctx.root / "fixture"
    ev = evaluation_phase(
        ctx.root, ctx["training"]["snapshot"], ctx["training"]["pages"],
        Path(ctx["autoencoder"]["snapshot"]), Path(cap["snapshot_256"]).parent,
        fixture / "train.json", ctx["segmenter"]["results_json"], ctx["dataset"]["coco_gt"],
        ctx.fns)
    for name in ("checkpoints", "fid_trend"):
        for row in ev["path_kernels"][name]:
            ctx.add_error(row["kernel"], row["max_abs_err"])
    return {**ev, "paths": {
        "evaluation_checkpoints": (ev["evaluate_checkpoints"]["launches"], BIAS_BLUR),
        "evaluation_fid_trend": (ev["fid_trend"]["launches"], BIAS_BLUR),
        "evaluation_results_tools": (ev["results_tools"]["launches"], ())}}


class Phase:
    def __init__(self, name: str, title: str, needs: tuple, run, tf32: bool = True):
        self.name, self.title, self.needs, self.run, self.tf32 = name, title, needs, run, tf32


# in the order of the whole run; `title` names the phase in the seconds by phase
PHASES = (
    Phase("kernels", "kernel checks", (), phase_kernels, tf32=False),
    Phase("training_iterations", "training iterations card vs CPU", (),
          phase_training_iterations, tf32=False),
    Phase("discovery", "discovery", (), phase_discovery),
    Phase("dataset", "dataset paths", ("discovery",), phase_dataset, tf32=False),
    Phase("training", "training", (), phase_training),
    Phase("segmenter", "segmenter", ("dataset",), phase_segmenter),
    Phase("serving", "serving", ("segmenter",), phase_serving),
    Phase("transunet", "transunet", ("dataset", "segmenter"), phase_transunet),
    Phase("swagan_emanet", "swagan_emanet", ("training", "segmenter"), phase_swagan_emanet),
    Phase("dataset_gan", "dataset_gan", ("training", "swagan_emanet"), phase_dataset_gan),
    Phase("capstone", "capstone", (), phase_capstone),
    Phase("autoencoder", "autoencoder", ("training",), phase_autoencoder),
    Phase("options", "options", ("dataset", "segmenter"), phase_options),
    Phase("evaluation", "evaluation",
          ("dataset", "training", "segmenter", "capstone", "autoencoder"), phase_evaluation),
)


def resolve_phases(only=None) -> list:
    """The phases to run, in PHASES order: all of them, or `only` and every
    phase they need, transitively."""
    by_name = {p.name: p for p in PHASES}
    if not only:
        return list(PHASES)
    wanted, todo = set(), list(only)
    while todo:
        name = todo.pop()
        if name not in wanted:
            wanted.add(name)
            todo.extend(by_name[name].needs)
    return [p for p in PHASES if p.name in wanted]


def check_paths(phase: str, paths: dict) -> None:
    """Every kernel a path needs was launched on it."""
    for path_name, (launches, needed) in paths.items():
        for name in needed:
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the {path_name} path "
                                     f"({phase} phase)")


FLASH_TPU = ("jax/experimental/pallas/ops/tpu/flash_attention.py:{} (jax 0.9.0), reached "
             "from synthesis_in_style_tpu/models/trans_u_net.py:300")
KERNEL_SOURCES = {
    "fused_bias_act": ("csrc/fused_bias_act.cu",
                       "synthesis_in_style_tpu/ops/pallas/fused_bias_act.py:61"),
    "fused_bias_act_bwd": ("csrc/fused_bias_act.cu",
                           "synthesis_in_style_tpu/ops/pallas/fused_bias_act.py:87"),
    "fused_blur": ("csrc/fused_blur.cu", "synthesis_in_style_tpu/ops/pallas/fused_blur.py:223"),
    "segmented_cc": ("csrc/segmented_cc.cu",
                     "synthesis_in_style_tpu/ops/pallas/segmented_cc.py:158"),
    "flash_attention_fwd": ("csrc/flash_attention_f32.cuh", FLASH_TPU.format(758)),
    "flash_attention_bwd": ("csrc/flash_attention_f32.cuh",
                            FLASH_TPU.format("1121 (bwd_dkv) and :1456 (bwd_dq)")),
    # a kernel of the port's own: the JAX package's int8 convolution is XLA's
    "int8_conv": ("csrc/int8_conv.cu",
                  "none (synthesis_in_style_tpu/ops/quant.py:67 int8_conv is "
                  "lax.conv_general_dilated, an XLA op, no pallas_call)")}
ROW_EXTRAS = ("fma_bound_ms", "library_kernels", "bf16_ms", "bf16_device_ms", "bf16_bound_ms",
              "bf16_plain_ms", "bf16_library_ms", "bf16_source", "page_ms", "page_plain_ms",
              "page_bound_ms", "library_cudnn_float32_ms", "library_cudnn_tf32_ms",
              "library_cudnn_bf16_ms")


def kernel_rows(ctx: Context, phases: list) -> list:
    """The `kernels` line: each kernel's numbers and its launches by path."""
    rows = []
    for name, (src, tpu) in KERNEL_SOURCES.items():
        k = ctx.kernels.get(name, {})
        by_path = {path: launches[name] for p in phases
                   for path, (launches, _) in ctx[p.name]["paths"].items()}
        rows.append({"name": name, "route": "cuda",
                     "source": f"synthesis_in_style_tpu_torch/{src}", "replaces": tpu,
                     "launches": sum(by_path.values()), "launches_by_path": by_path,
                     "max_abs_err": k.get("max_abs_err"),
                     **{key: k.get(key) for key in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                    "bound_by", "library_ms")},
                     **{key: k[key] for key in ROW_EXTRAS if key in k}})
        if "bf16_ms" in k:
            log(f"{name} at the main shape: float32 {k['ms']:.4f} ms (device "
                f"{k['device_ms']}) against a bound of {k['bound_ms']:.4f} "
                f"({k['ms'] / k['bound_ms']:.2f}x); bfloat16 {k['bf16_ms']:.4f} ms (device "
                f"{k['bf16_device_ms']}) against {k['bf16_bound_ms']:.4f} "
                f"({k['bf16_ms'] / k['bf16_bound_ms']:.2f}x)")
    return rows


def main(argv=None) -> int:
    names = [p.name for p in PHASES]
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--detail", type=Path, default=None,
                        help="write every measured row to this JSON file")
    parser.add_argument("--only", nargs="+", choices=["flash"] + names, default=None,
                        metavar="PHASE",
                        help="run these phases and the phases they need (with their gates and "
                        "launch checks), or `flash`: the flash kernel check alone; phases: "
                        + ", ".join(names))
    cli = parser.parse_args(argv)
    if cli.only and "flash" in cli.only and len(cli.only) > 1:
        parser.error("--only flash runs alone")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from synthesis_in_style_tpu_torch.ops.cuda import build  # noqa: E402

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    set_tf32(False)  # parity phases compare in full float32
    if cli.only == ["flash"]:
        return flash_only(smi, cli.detail)

    phases = resolve_phases(cli.only)
    log("phases: " + ", ".join(p.name for p in phases))
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    ctx = Context(root, counters())
    phase_seconds, step_seconds = {}, {}
    start = time.perf_counter()

    def write_detail(rows=None) -> None:
        """The detail file as it stands (rewritten after every phase, so a
        failed run keeps what its finished phases measured)."""
        if cli.detail is None:
            return
        cli.detail.parent.mkdir(parents=True, exist_ok=True)
        cli.detail.write_text(json.dumps(
            {"card": smi, "kernels": rows, "detail": ctx.detail, "phase_seconds": phase_seconds,
             "step_seconds": step_seconds,
             "phases": {name: {k: v for k, v in result.items() if k != "paths"}
                        for name, result in ctx.results.items()}},
            indent=1, default=str))

    try:
        for phase in phases:
            if phase.tf32:
                _defaults()
            else:
                set_tf32(False)
            t0 = time.perf_counter()
            ctx.results[phase.name] = phase.run(ctx)
            phase_seconds[phase.title] = time.perf_counter() - t0
            step_seconds[phase.name] = ctx.results[phase.name].get("seconds", {})
            check_paths(phase.name, ctx.results[phase.name]["paths"])
            steps = step_seconds[phase.name]
            log(f"phase {phase.name}: {phase_seconds[phase.title]:.1f} s" + (
                " (" + ", ".join(f"{k} {v:.1f}" for k, v in steps.items()
                                 if isinstance(v, float)) + ")" if isinstance(steps, dict)
                else ""))
            write_detail()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rows = kernel_rows(ctx, phases)
    log("seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_seconds.items()) +
        f"; whole script after the build {time.perf_counter() - start:.1f}")
    write_detail(rows)
    log(f"card: {smi}")
    print(json.dumps({"kernels": rows}))
    if cli.only:
        print(json.dumps({"ok": True, "only": [p.name for p in phases]}))
    else:
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
