#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port on one NVIDIA card (H100 class).

    python3 chip_smoke.py

Builds the port's hand-written kernels from ``insenticap_model_tpu_torch/
csrc`` (``nvcc`` for sm_90a, one process a source, all started together,
into the git-ignored build directory), the host image decoders and the
feature-store gather (``csrc/imgdec.cc``, ``csrc/fstore.cc``, the host's
C++ compiler), then:

1. prints the card's name and power limit, the build time and ptxas's
   registers and spills of the int8 attention's instances (the B = 3
   ones must spill nothing);
2. holds every kernel against its plain PyTorch version on the card, at
   the serving shapes (bs=384; attention v1 at beams 1, 3 and 8 and v2 at
   beam 3, in bf16 and f32, v1's bf16 instance also with tanhf in place of
   tanh.approx.f32, both within the same tolerance, and v1 also at the RL
   and reproduce dumps' shape, bs=40 at beam 3; the
   Winograd transforms in bf16, the input transform also on the
   detector's permuted NHWC view, which must give the contiguous input's
   V exactly, and the stack on that view; the fused classifier top-k at 1152 rows x
   10,000 words in bf16 and f32, and the bf16 top-k's wgmma product alone
   against the f32 library product; the encoder stem's max pool in bf16 and
   f32 at [32,224,224,64] and [32,192,256,64], the 448x448 and 384x512
   buckets at bs=32, and an odd extent, exactly; the int8-storage
   attention at bs=384, N=196, 512 wide (both tanh entries) and the
   row-tiled product at the
   decode cell's two LSTM shapes and tile_rows 24, 48 and 96, at K = 4096
   (w streamed, not resident) and at a tile of 5 rows (wgmma n8), both in
   bf16 within one bf16 ulp; the Winograd output transform also equal to
   its plain version in bf16, on its element-wise path (M off its
   alignment) equal to its vector path, and in f32 within rounding), with
   the tolerances stated at each check;
3. drives the main path: a full-width bf16 ``DynamicBatcher`` (512-d
   model, 2048-d 14x14 features, vocab 10,000, beam 3, 16 tokens, random
   weights from a seed) answers 41 requests from threads, mixing auto and
   forced sentiment labels so that the 1-, 8- and 32-row buckets dispatch,
   with every kernel's launch count set to 0 just before and read just
   after;
3b. drives the trained path: the same batcher on the trained captioner
   ``assets/bench_trained.ckpt`` (read by the port's own checkpoint
   reader; the detector from a seed), standard-normal features, and
   ``ISC_FUSED_TOPK=1`` with ``ISC_ATT_KERNEL=v2`` set before ``warm()``,
   answers 40 requests; the launch counts are set to 0 just before and
   read just after, and every caption must end, with a mean length in
   [8, 13] and fewer than 16 decode steps a batch;
3c. drives the image path: a bf16 ``EncodeBatcher`` (ResNet-101 at full
   depth and the 2000-concept MLP, random weights from a seed, the ladder
   1/4/16/32 over the three resize buckets) chained to a phase-3 decode
   batcher through the concepts' ranked sentiment words (a synthetic
   concept list, sentiment table and vocabulary from the same seed)
   answers 40 uint8 image requests and 4 fc requests from threads, auto
   and forced labels; the launch counts are set to 0 just before and read
   just after, and the pool's must equal the image encode groups
   dispatched; every request gets a caption and 5 distinct concept ids in
   range; then 96 images of 448x448 at once give the encode throughput;
3d. drives the two studies' paths at their full shapes with few
   repetitions: ``tools/bench_torch_int8.attention`` (the bf16 v1 kernel
   against the int8-storage kernel at bs=384, and the int8 context's error)
   and ``tools/bench_torch_megacell.measure`` (both LSTM products through
   the row-tiled kernel at the three tile sizes, beside ``torch.matmul``);
   the launch counts are set to 0 just before and must equal the calls
   each function reports;
3e. drives the serving surface: the port's checkpoint writer saves the
   phase's random models (the RL composite at 512-d and vocab 10,000 with a
   synthetic ``idx2word``, the 2000-concept MLP with ``idx2concept``, the
   full ResNet-101), and its reader must read every leaf back
   bit-identical; ``cli.serve.make_server`` on 127.0.0.1:0 (bf16,
   ``--warm``, ``--image_root`` a copy of the committed fixtures with a
   YCbCr TIFF written beside them) answers feature
   requests (auto and forced), ``image_b64`` of the committed JPEG, PNG,
   GIF, BMP and WebP (lossless and lossy) fixtures and four
   ``image_path`` requests (a JPEG, a PNG, a lossless WebP animation and
   a lossy RGBA WebP) from threads, each
   with a caption and 5 distinct concepts, v1 and the pool launched (counts
   set to 0 just before; the three progressive JPEGs, CMYK (4:4:4 and a
   448x448 4:2:0), YCCK and Adobe-RGB JPEGs, Adam7 RGB and 4-bit palette
   PNGs, 16-bit RGB and grey PNGs, an interlaced palette GIF, a grey-ramp
   GIF and a GIF frame at an offset with a transparency index, and 8-bit
   palette, 24-bit, RLE8 and 5-6-5 bitfields BMPs, lossless WebPs
   (simple, RGBA, palette, VP8X with ICC, an animation whose first frame
   lies at an offset on its canvas) and lossy WebPs (odd-sized, grey,
   RGBA with its ALPH chunk, a lossy first frame at an offset, the test
   writer's frame with the simple filter and four token partitions, and
   448x448 at quality 80 and 100) among the fixtures; three YCbCr
   TIFFs of the 448x448 JPEG's pixels written here, which PIL reads
   through libtiff's RGBA interface: 2 x 2 under LZW, 1 x 1 in separate
   planes under Deflate, also as ``image_path``, and under JPEG; and
   three bilevel TIFFs of those pixels thresholded, written here
   (``tiff_fax``): Group 4 and Group 3 2D as ``image_b64``, RLE as
   ``image_path``); a
   path outside the root and a 12-bit JPEG (which the decoders and PIL
   both refuse) are 400s, an oversized body 413, /stats, /metrics and /healthz 200,
   and the server drains on shutdown (p50/p99 per bucket printed); the
   port's decoders on this host give the fixtures' committed PIL arrays
   exactly; ``cli.caption.run`` on four fixtures (a JPEG, a PNG, a
   lossless and a lossy RGBA WebP) in f32 dumps attention
   maps that sum to 1 within 1e-5; and the host's decode of a 448x448
   JPEG (4:2:0), baseline, progressive and CMYK (the same photo), and
   PNG, plain and Adam7 (its pixels), GIF and BMP, 24-bit and RLE8 (its
   pixels in the 3-3-2 colour cube for the GIF and RLE8, each written
   here without PIL and decoding to the pixels written), lossless WebP
   (PIL's of its pixels, committed; a corner of it written here decodes
   to its pixels too), lossy WebP at quality 80 and 100 (PIL's of its
   pixels, committed, each equal to its PIL array), the three YCbCr TIFFs
   (each within a mean of 1 level of the pixels they were made from), the
   three bilevel TIFFs and a 1728x2292 (fine-mode A4) Group 4 page of the
   thresholded pixels repeated (each equal to its bits as RGB of 0 and
   255), and a 480x640 ``resize_to_bucket`` are timed (median of 5, the
   card's name and power limit beside them);
3f. drives the XE pre-training stage (``cli.train_xe.train``) at full
   width (``Settings()``, the vocabulary padded to 10,000 words, xe_bs 20,
   the seq2seq batch 80, 16 tokens, beam 3) on a synthetic tree the
   port's ``synthetic`` writes (5 train batches, val with a padded last
   batch, 20 test images): the port's writer saves a seeded sentence
   classifier, read back bit-identical; two f32 epochs at dropout 0.5
   (epoch 1's ss_prob 0.05) with finite losses, epoch 1's train XE loss
   below epoch 0's, one caption a test image in result_0.json, and v1
   launched in the beam dumps (its count set to 0 just before, read just
   after); the epoch-0 checkpoint with its optimizer state read back
   bit-identical; ``--xe_resume`` from it for epoch 1, its params within
   1e-5 of the uninterrupted run's (the two softmax-invariant
   attention-score biases within lr a step); one f32 step with dropout
   off on the card against the same step on the CPU (losses within 1e-5
   relative, each leaf's gradient within 1e-4 of its norm, params within
   1e-5, the two biases within lr); one bf16 epoch with finite losses
   that fall over its steps; the ms a train step (f32, bf16; median of
   5) and the dump's captions/s; and that dump's decode (v1, mode xe,
   bs 20, beam 3) against the plain path: on the random weights of the
   timed dump no empty top-beam caption, and in f32 every top beam
   identical with scores within 1e-3; with the trained captioner on 400
   images of standard-normal features, in f32 every top beam identical
   with scores within 1e-3, in bf16 the share of identical top beams at
   least v1 with tanhf's, rounded down to a whole percent (phase 4's
   gate); a ``StepTimer`` over the two f32 epochs' steps (one JSONL
   record a step, its median beside the timed step); one f32 step under
   ``maybe_trace`` with ``annotate`` spans around its batch's gather and
   the step (the trace must hold both spans and a kernel of the card);
   and the first train batch's att gather (20 records of 14x14x2048)
   through the native and the numpy reader, from an fp16 copy of the
   tree's store (widened to f32) and from the f32 store itself: the
   arrays bit for bit identical, the medians of 9 taken in turns and
   their shares of the f32 step;
3g. drives the head-stage trainers and the concept CLIs at full width
   (``Settings()``: 2048-d features on a 14x14 grid, the detector 2048 ->
   1024 -> 512, 2000 concepts, vocab 10,000, bs 80) on a synthetic tree
   (240 train images, 100 val, 100 and 120 test): ``cli.train_cpt`` for
   two f32 epochs (finite losses, epoch 1's train loss below epoch 0's),
   ``cli.detect_concepts`` on its checkpoint (5 distinct known concepts
   for each of the 900 images of both fc stores) and ``cli.test_cpt``;
   ``cli.train_senti`` for two epochs in f32 and in bf16, with the launch
   counts set to 0 just before each run and read just after: each
   Winograd transform launched 2 x (val + test batches) x epochs times in
   bf16 (the eval step's two forwards a batch) and never in f32; on the
   f32-trained detector, over the eval batches of 80 that
   ``train_senti`` runs (120 test and 100 val images), the bf16 logits
   through the kernels within rounding of their plain twins' (rtol 1e-2,
   1e-3 of the scale, phase 2's tolerances), and the bf16 labels through
   the kernels, through the twins and by the direct conv, each against
   the f32 direct conv's, at thresholds 0 and 0.7 (printed), the kernels'
   equal to the twins' on at least 99% (at both thresholds);
   ``cli.train_sent_senti_cls_rnn`` resumed
   from an epoch-27 checkpoint the port's writer made (seeded weights,
   fresh Adam state) for epochs 28-29, finite accuracies; every checkpoint
   of the phase read back bit-identical with its optimizer state; one
   concept and one detector step with dropout off on the card against the
   CPU (phase 3f's loss and gradient gates; the params within 1e-5 of
   what Adam's first update makes of each side's gradient, which may part
   by 2 lr where a gradient is a near-cancelling sum); ms a train step of
   each trainer (host clock, median of 5), the bf16 detector step's
   device time and idle share, a bf16 eval batch's ms and its logits
   through the kernels within rounding of the twins';
3h. drives the RL fine-tuning stage (``cli.train_rl.train``) at full width
   (``Settings()``, vocab 10,000, rl_bs 40, the seq2seq batch 80, 16
   tokens, beam 3) on a synthetic tree (80 captioned train images, 40 val,
   40 test; 40 sentiment train and 40 test images), bootstrapped from
   checkpoints the port's writer saves (a seeded XE captioner, phase 3g's
   trained detector and classifier): one f32 epoch, epoch 1 resumed from
   its composite checkpoint (``--rl_resume``), one epoch under
   ``--compute_dtype bfloat16 --rl_detector_dtype bf16``, with the launch
   counts set to 0 just before each run and read just after: v1's launches
   equal the dump's decode steps (the beam's vocabulary tail counted) and
   each Winograd transform's the bf16 detector's calls (none in f32);
   finite metrics, each composite checkpoint read back bit-identical with
   its optimizer state, the resumed run at epoch 1; ``eval_cls_rnn`` on
   the f32 dump's sentiment split (all three sentiments detected); the
   device CIDEr-D within rtol 2e-5 of the host scorer on the sample,
   greedy and ground-truth rows of a fact batch; one fact step with
   dropout off and the draw forced to argmax(logprobs + G) on the card
   against the CPU (phase 3f's gates: losses within 1e-5 relative, each
   leaf's gradient within 1e-4 of its norm but the two softmax-invariant
   biases, the params within 1e-5 of Adam's first update of each side's
   gradient); the bf16 detector's logits through the kernels within
   rounding of the plain twins' (phase 2's tolerances) and its labels
   against f32's at thresholds 0 and 0.7 (printed); the dump's decode
   (``detect_and_decode``) against the plain path, in f32 on the test
   images (identical labels and top beams, scores within 1e-3) and in
   bf16 on 400 images of standard-normal features (phase 4's gate); the
   ms an RL step (f32, bf16; median of 5), its device time, idle share and
   largest kernels, the CIDEr-D reward's device time, the tables' build
   seconds and bytes and the dump's captions/s;
3i. drives the offline and evaluation CLIs on phase 3h's tree:
   ``preprocess`` (the text stages, the LMs, the features of the 32
   decodable fixtures and 32 PNGs, the pool's launches equal to the encode
   batches flushed), ``convert_checkpoint``, ``reproduce_table`` in f32
   (the ``.ckpt``, the ``.pth`` and the plain path, one table) and in bf16
   (kernels, plain path, tanhf: v1 launches equal to the decode steps, the
   Winograd kernels on the dump's own detector batches within rounding of
   their twins, the kernel path's captions equal to the plain path's on
   at least tanhf's share); as a record, the bf16 plain path's captions
   against the f32 path's and the f32 scores of the captions the two bf16
   paths part on; and ``eval_metrics``, ``eval_ppl``, ``eval_senti``;
3j. drives data-parallel training (``parallel/mesh.py``): (a)
   ``cli.train_xe`` in a process of its own started as torchrun starts a
   rank (``env://``, RANK 0 of WORLD_SIZE 1) with ``--mesh_shape [1]``,
   so on NCCL, for epoch 0 on phase 3f's tree rebuilt from its seeds: its
   metrics line, its epoch-0 checkpoint (params and Adam state) and its
   dump equal phase 3f's f32 run's bit for bit, v1 launched in its dump;
   (b) two ranks over gloo, processes of their own sharing the one card
   (NCCL refuses two ranks on one device), each joined within a time
   limit (a rank that fails fails the run), on CUDA tensors: the params
   broadcast from rank 0, the full-width f32 XE step (default dropout,
   each rank 10 rows of phase 3f's first batch and 40 of its seq2seq
   batch) and the bf16 sentiment-detector step at HEAD_BS (40 rows a
   rank) with its eval step, whose two forwards each launch every
   Winograd transform once in each rank (the launch counts set to 0 just
   before and read just after), against the one-process steps on the whole
   batches on the card: f32 losses within 1e-5 relative, each leaf's
   summed gradient within 1e-5 of its norm (but the two softmax-invariant
   biases), the params within 1e-5 of Adam's first update of each side's
   gradient; bf16 within its rounding (1e-2 relative for the loss, each
   leaf's gradient and the eval loss sum, the params also within one bf16
   ulp, 2^-7 of their value), the labels equal on at least 99%, the two
   ranks' params bit for bit alike; (c) the f32 XE step's time per global
   batch of 20,
   one process against the two ranks (host clock, median of 5, the
   card's name and power limit beside it; a reading, no limit);
3k. drives the RL stage's data-parallel training on phase 3h's tree (a
   copy taken before phase 3i writes into it): (a) ``cli.train_rl`` in a
   process of its own started as torchrun starts a rank (``env://``,
   RANK 0 of WORLD_SIZE 1, so NCCL) with ``--mesh_shape [1]`` for epoch
   0: its metrics line, its composite checkpoint (the three parts and
   Adam's state) and every file of its dump equal phase 3h's f32 run's
   bit for bit, v1 launched in its dump as often as there; (b) two ranks
   over gloo sharing the one card, on CUDA tensors, each building the
   CIDEr-D tables itself: the full-width f32 fact and senti RL steps
   (the default dropout, the real sampler, the RL scheduled sampling;
   each rank 20 rows of phase 3h's first fact and sentiment batches and
   40 of its seq2seq batch), and both again in float64, against the
   one-process steps on the whole batches on the card under phase 3j's
   gates (losses within 1e-5 relative, each leaf's summed gradient within
   1e-5 of its norm but the two softmax-invariant biases, the params
   within 1e-5 of Adam's first update of each side's gradient), the
   ranks' params bit for bit alike; then a fact step with the detector
   in bf16, which launches each Winograd transform once in each rank
   (the launch counts set to 0 just before and read just after); (c)
   the f32 fact step's time per global batch of 40 (a plain Adam, no
   copy of the gradients to the host), one process against the two
   ranks (host clock, median of 5 after one warm-up step, the card's
   name and power limit beside it; a reading, no limit);
3l. drives sharded serving in one process (``parallel.mesh.DeviceMesh``,
   a worker thread a device; the one card named twice, ``[cuda:0,
   cuda:0]``, where only one is visible): (a) every serving kernel (v1,
   v2, the top-k, the three Winograd transforms, the pool) from a fresh
   thread whose device was never set, against its twin, and where a
   second card is visible on ``cuda:1`` while ``cuda:0`` is current (else
   a line saying so); (b) ``make_sharded_serving_fn`` at bs=384, f32 and
   bf16: bit for bit the one-device function on each 192-row block,
   within the port's gate of it on all 384 rows (identical labels, at
   least 99% identical top beams, scores within 1e-3; the rows that differ
   counted), each Winograd transform launched once a block in bf16 and v1
   on every decode step of both blocks; (c) a bf16
   ``DynamicBatcher(mesh=)``, its default ladder (2, 8, 32, 128, 384),
   answering phase 3's requests as phase 3's one-device batcher did; (d)
   a bf16 ``EncodeBatcher(mesh=)`` on 40 images against the one-device
   one: the concept ids equal, fc and att within bf16 rounding, the
   pool's launches twice the image encode groups; (e) ``serve
   --mesh_shape [1]`` on phase 3e's checkpoints answering 3e's feature
   requests with 3e's JSON, and ``--mesh_shape [2]`` exiting with a
   message naming the visible card; (f) ``reproduce_table --mesh_shape
   [1]``, and its serving function over ``[cuda:0, cuda:0]``, on phase
   3i's tree writing 3i's bf16 dump files and table byte for byte; (g)
   the bf16 bs=384 step on one device, on one 192-row block and on the
   two workers (host clock, median of 6 in turns; a reading, no limit);
3m. drives multi-host serving (``serving/multihost.py``): two processes
   of their own share the one card as two one-card hosts would run (RANK
   0 and 1, WORLD_SIZE 2, LOCAL_RANK 0, the card as CUDA_VISIBLE_DEVICES,
   MASTER_ADDR and MASTER_PORT on a free port, each within a time limit:
   a process that fails or hangs fails the run), joined over gloo as
   ``serve`` joins them: (a) a bf16 ``DynamicBatcher`` of phase 3's
   weights on the mesh over both, process 0 warming and answering phase
   3's 41 requests, the other mirroring from ``follower_loop`` until
   process 0 closes it: the answers bit for bit 3l(c)'s, every stripe
   mirrored, v1 and the Winograd transforms launched in both processes;
   (b) the bs=384 batch through the lockstep path, f32 and bf16: bit for
   bit the one-device function on each 192-row block (3l(b)), in each
   process v1 launched once a decode step and each Winograd transform
   once in bf16 (the counts set to 0 just before the stripe and read just
   after); (c) ``python -m insenticap_model_tpu_torch.cli.serve
   --mesh_shape [2]`` in two processes on phase 3e's checkpoints: process
   0 answers 3e's feature and image requests, sent one at a time, with
   the JSON of 3e's daemon in one process on one device to the same
   requests (the image encode stays on process 0; the comparison with
   3e's concurrent answers recorded), the follower prints its two lines,
   SIGTERM drains process 0 and releases the follower, both exit 0;
   ``reproduce_table`` under WORLD_SIZE=2 exits with its message; (d) the
   bf16 bs=384 batch through the lockstep path, in turns with one device
   and one 192-row block: the control plane's ms and MB (batch out,
   results back), each process's compute ms, the whole dispatch (host
   clock, median of 6; a reading, no limit; print-outs of (c) in
   ``chiprun_out/multihost_serving.log``);
3n. drives the 2-D data x model mesh (``parallel/mesh.py``'s grid,
   ``parallel/vocab.py``): ranks of their own share the one card over
   gloo, each joining the group itself, the captioner's 10,000 words split
   over a model axis of two: (a) ``cli.train_xe.train`` at
   ``--mesh_shape [1, 2]`` for epoch 0 on phase 3f's tree rebuilt from its
   seeds: its metrics within 1e-5 of phase 3f's f32 epoch 0, rank 0's
   checkpoint the one-process file (read in one process; its params past
   1e-5 of 3f's on at most 1e-3 of the elements), its dump bit for bit one
   process's decode of those params, v1 launched in both; (b) the f32 XE
   stage step (scheduled sampling at 0.25), the RL fact rollouts (sampled
   and greedy) and the RL fact step at [1, 2] and [2, 2] (four processes)
   against one process on phase 3f's and 3h's first batches under phase
   3j's gates, the tokens identical, the replicated leaves alike on every
   rank and each shard on its data group, a bf16-detector RL step's
   Winograd launches; (c) the XE step's ms a global batch (one process,
   [1, 2], [2, 2]), its model-axis collectives (count, MB, the ms of the
   same collectives replayed alone) and the captioner's training state a
   rank (params, grads, moments, the peak allocated) (host clock, medians
   of 5; readings, no limit);
4. runs ``detect_and_decode`` at bs=384 in f32 on the kernel path and on
   the plain path, on random weights with the default kernels and on the
   trained weights with both switches, and requires identical labels,
   identical top-beam tokens on at least 99% of the images and, on those,
   top-beam scores within 1e-3; in bf16 on the trained weights, the share
   of images whose top beam equals the bf16 plain path's, for the default
   entries, v1 with tanhf (the op wrapped for the run) and both switches,
   the default's held to at least tanhf's, rounded down to a whole
   percent; decodes a beam of 9 (wider than the
   kernels take) in bf16 at bs=8, with and without ``ISC_FUSED_TOPK=1``,
   and requires the plain path's tokens and scores exactly, with no v1 or
   top-k launch; compares the detector's labels, bf16 (Winograd kernels,
   and the direct conv) against f32 direct, at bs=384 (printed, no limit);
   runs the f32 encoder (bs=16, 448x448) with
   the pool kernel and with the plain pool (fc/att within 1e-5 of scale,
   identical concept ids), and the bf16 encoder against the f32 one (rms
   error at most 0.1 of the f32 features' rms); the concept MLP's last
   layer is scaled in phase 3c so that its scores spread (no score at
   1.0, checked here), and its ids on the kernel path must equal the
   plain path's;
5. times each kernel, its plain version and, where one PyTorch call
   computes the same function, that call, with CUDA events (median of 5
   runs after warm-up); v1, v2 and the int8 attention (query product +
   attention, printed apart; the int8 one beside v1 on the same values,
   both tanh entries), the fused top-k (pass 1 + merge, printed apart,
   beside the bf16 ``torch.matmul`` of its product as a yardstick), the
   row-tiled product
   and ``torch.matmul``, some 30-100 us a call, by
   the profiler's device time (the latter two from phase 3d), since events
   around back-to-back launches of that size also read the host's
   dispatch (each profiler session must hold every launch its calls made,
   by the ops' launch counters, or is taken again, then refused); the
   three Winograd transforms by the profiler's device time
   beside events (the input transform on the permuted view the detector
   passes, and on contiguous x), and the stack's device time split into
   the transforms, the two products, the per-call filter transform and
   the rest; the bf16 serving step at bs=384 under the four
   switch settings on random weights, and captions/s and mean caption
   length on the trained weights, default and both switches (host clock,
   the settings taken in turns, median of 6 each); ``forward_raw_batch``
   at bs=32, 448x448, bf16 and f32 (host clock, median of 5);
6. prints one ``kernels`` JSON line (every check above passed, or the run
   would have stopped; each kernel's ``design`` says whether it is a
   Hopper-specific redesign or the first port), the card's name and power
   limit, then
   ``{"ok": true, "device": ...}``.

Any failed check raises and the script exits non-zero without the last
line. It exits non-zero at once where CUDA is absent or the package is
not beside it. Details go to ``chiprun_out/chip_smoke.json``.
"""
import contextlib
import functools
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

HBM_BYTES_S = 3.35e12        # H100 SXM memory rate (NVIDIA data sheet)
F32_FLOP_S = 67e12           # f32 outside the tensor cores
BF16_FLOP_S = 989e12         # bf16 tensor cores, dense
# tanh.approx.f32 runs on the special-function units (MUFU), 16 a clock on
# each SM of sm_90 (CUDA C++ Programming Guide, arithmetic instruction
# throughput), at the H100 SXM's maximum boost clock of 1980 MHz (NVIDIA
# data sheet; the card's own clocks.max.sm is printed beside it)
SFU_OPS_CLK = 16
SM_CLOCK_HZ = 1.98e9

BS = 384
VOCAB = 10_000
BEAM = 3
T = 16
M = 10                       # sentiment words per request
NUM_CATS = 3
BANNED = (0, 1, 2)           # pad, unk, sos: the beam's static bans
SOURCES = ["fused_attention", "winograd", "fused_topk", "maxpool",
           "tiled_mm"]
N_CONCEPTS = 2000            # the concept detector's outputs
K_CONCEPTS = 5               # concepts per image
ENC_BS = 32                  # the encode ladder's top bucket
# the stem's pool inputs at ENC_BS for the 448x448 and 384x512 buckets
POOL_SHAPES = {"448x448": (ENC_BS, 224, 224, 64),
               "384x512": (ENC_BS, 192, 256, 64)}
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
TRAINED_CKPT = os.path.join(REPO_DIR, "assets", "bench_trained.ckpt")
ATT_BEAMS = (1, BEAM, 8)     # v1's checks: narrowest, serving, widest
# each kernel's design on this card: "redesigned" for the Hopper-specific
# designs that replaced the first port, "first design" for the others
# (PERF.md's kernel table gives their history)
DESIGNS = {"beam_content_attention": "redesigned",
           "beam_content_attention_v2": "redesigned (runs on v1's kernel)",
           "wino_input": "redesigned", "wino_middle": "redesigned",
           "wino_output": "redesigned", "classifier_topk": "redesigned",
           "ceil_maxpool_3x3s2": "first design",
           "beam_content_attention_i8": "redesigned",
           "tiled_mm": "redesigned"}
# the committed image fixtures (JPEGs, PNGs, GIFs and BMPs written by PIL,
# or by tests/torch_images.py's writers where PIL cannot: Adam7, 16-bit
# RGB, YCCK, a GIF frame at an offset with a transparency index, RLE8 and
# 5-6-5 bitfields BMPs; expected.npz holding PIL's decoded arrays;
# tests/torch_images.py
# rebuilds them): name -> what phase 3e expects of the port's decoders,
# "decode" (identical to expected.npz) or "refuse" (ValueError, so a 400;
# PIL refuses it too)
FIXTURE_DIR = os.path.join(REPO_DIR, "tests", "data", "torch_images")
FIXTURES = {"j444.jpg": "decode", "j422.jpg": "decode",
            "j420_448.jpg": "decode", "grey.jpg": "decode",
            "rst.jpg": "decode", "prog.jpg": "decode",
            "prog420_448.jpg": "decode", "prog_rst.jpg": "decode",
            "cmyk.jpg": "decode", "cmyk420_448.jpg": "decode",
            "adobe_rgb.jpg": "decode", "ycck.jpg": "decode",
            "j12bit.jpg": "refuse", "rgb.png": "decode",
            "adam7.png": "decode", "rgb16.png": "decode",
            "grey16.png": "decode", "adam7_p4.png": "decode",
            "rgba.png": "decode", "p.png": "decode",
            "interlaced.gif": "decode", "ramp.gif": "decode",
            "offset.gif": "decode", "p8.bmp": "decode",
            "rgb24.bmp": "decode", "rle8.bmp": "decode",
            "bf565.bmp": "decode", "lossless_rgb.webp": "decode",
            "lossless_p.webp": "decode", "lossless_rgba.webp": "decode",
            "lossless_icc.webp": "decode", "lossless_anim.webp": "decode",
            "lossless_448.webp": "decode", "lossy_rgb.webp": "decode",
            "lossy_grey.webp": "decode", "lossy_rgba.webp": "decode",
            "lossy_anim.webp": "decode", "lossy_hand.webp": "decode",
            "lossy_448.webp": "decode", "lossy_448_q100.webp": "decode",
            "rgb.tif": "decode", "p_packbits.tif": "decode",
            "lab.tif": "decode", "rgba_o6.tif": "decode",
            "cmyk_tiles.tif": "decode", "grey16_big.tif": "decode",
            "rgb_lzw.tif": "decode", "grey_lzw_old.tif": "decode",
            "float_pred3.tif": "decode", "ycbcr_jpeg.tif": "decode",
            "ycbcr_tiles_jpeg.tif": "decode", "cmyk_jpeg.tif": "decode"}
# a fixture whose PIL array is another's, stored once in expected.npz
# under the other name: the same photo at the same quality and sampling,
# written progressive (the same coefficients, so the same pixels), and
# rgb.png's pixels interlaced, as the high bytes of 16-bit samples and as
# a 24-bit BMP; lossless WebPs of PNGs' and a JPEG's decoded pixels; PIL's
# TIFFs of rgb.png's (uncompressed and LZW) and p.png's
SAME_PIXELS = {"prog420_448.jpg": "j420_448.jpg", "adam7.png": "rgb.png",
               "rgb16.png": "rgb.png", "rgb24.bmp": "rgb.png",
               "lossless_rgb.webp": "rgb.png", "lossless_p.webp": "p.png",
               "lossless_rgba.webp": "rgba.png",
               "lossless_448.webp": "j420_448.jpg", "rgb.tif": "rgb.png",
               "p_packbits.tif": "p.png", "rgb_lzw.tif": "rgb.png"}
# phase 3f, the XE stage: the reference trainer's xe batch and learning
# rate; 34 train images of 3 captions give 5 batches, 7 val images 2 (the
# last padded), 20 test images one dump batch
XE_BS = 20
XE_LR = 4e-4
XE_N_IMG = {"train": 34, "val": 7, "test": 20}
# the card's f32 gradient of a leaf against the CPU's, |diff| / |CPU's|
# (L2): the two sum in other orders, so they part by rounding. f32 keeps
# within 1e-5 of f64 at the test widths
# (test_torch_training_steps.py::test_xe_gradients_f32_match_f64); the
# sums here are longer (10,000 logits, 2048 x 196 features), hence 1e-4.
# A wrong gradient size parts by far more; the params after one Adam step
# hold only the gradients' signs
XE_GRAD_RTOL = 1e-4
# the dump's decode with the trained captioner against the plain path: 20
# batches of 20 (400 images, as phase 4's 384)
XE_CMP_BATCHES = 20
# the XE batch's att gather, each reader timed this many times in turns
GATHER_RUNS = 9
# the captioner's attention-score biases, to which the softmax over
# positions is invariant (their gradient is zero up to rounding)
SOFTMAX_INVARIANT = (("attention", "cont", "att_alpha", "bias"),
                     ("attention", "senti", "word_alpha", "bias"))
# phase 3g, the head stages: the reference trainers' batch (concept_bs,
# senti_bs and the classifier's hard-coded 80) and learning rate; 240
# train images give 3 batches, 100 val images 2 (the last padded), 100 and
# 120 test images 2 (the sentiment split's last padded)
HEAD_BS = 80
HEAD_LR = 4e-4
HEAD_EPOCHS = 2
HEAD_N_IMG = {"train": 240, "val": 100, "test": 100}
HEAD_N_SENTI_IMG = {"train": 240, "val": 100, "test": 120}
# the detector's labels through the Winograd kernels against the plain
# twins' on the trained detector, on the eval batches train_senti runs: a
# printed reading and a floor (the logits are gated within rounding, as
# phase 2's transforms: rtol 1e-2, 1e-3 of the scale)
HEAD_LABEL_GATE = 0.99
# phase 3h, the RL stage: the reference trainer's rl_bs and learning rate;
# 80 train images give 2 fact batches, 40 sentiment train images 1, one
# val batch, one test batch of each split for the dump
RL_BS = 40
RL_LR = 4e-5
RL_N_IMG = {"train": 80, "val": 40, "test": 40}
RL_N_SENTI_IMG = {"train": 40, "val": 4, "test": 40}
# phase 3i, the offline and evaluation CLIs: 64 images for the features
# (the 32 fixtures the port decodes and 32 PNGs, over the three buckets) in
# encode batches of 32, the reference CLI's; two of them again on the CPU,
# whose f32 convolutions sum in other orders than cuDNN's through 104
# layers: fc and att within 1e-4 of their largest magnitude (the port and
# the JAX package agree within 1e-5 on the CPU, test_torch_encoder.py; a
# layout or weight fault is O(1))
# phase 3j, data parallelism: two ranks share the one card over gloo, the
# XE batch split 10 + 10 and the detector's HEAD_BS 40 + 40; the ranks'
# f32 gradient a sum of two halves against one sum of the whole (within
# 1e-5 of the leaf's norm); the bf16 detector step summed in f32 from two
# bf16 halves against one bf16 backward (within bf16's rounding, phase
# 2's 1e-2); each rank process joined within DP_TIMEOUT_S
DP_RANKS = 2
WINO_NAMES = ("wino_input", "wino_middle", "wino_output")
DP_TIMEOUT_S = 300
DP_TIMED_STEPS = 5
DP_GRAD_RTOL = 1e-5
# phase 3k's steps, each held to 3j's gates; the float64 ones show how far
# the f32 gaps are the rounding of a sum of two halves against one sum
RL_DP_STEPS = ("fact", "senti", "fact_f64", "senti_f64")
DP_BF16_RTOL = 1e-2
# phase 3n, the 2-D data x model mesh: ranks sharing the one card over
# gloo (each a process of its own), the captioner's VOCAB words split
# over a model axis of two; the XE and RL fact steps at [1, 2] and [2, 2]
# against one process under phase 3j's gates (the XE step with
# scheduled sampling at TP_SS_PROB, so that its draws cross the shards);
# each rank process joined within DP_TIMEOUT_S. train_xe's epoch at
# [1, 2] against phase 3f's: its checkpoint's params may part from 3f's
# by more than 1e-5 only where Adam's update of a near-zero gradient
# turns rounding into up to lr a step, on at most TP_PARAM_SHARE of the
# elements
TP_GRIDS = ((1, 2), (2, 2))
TP_TIMED_STEPS = 5
TP_SS_PROB = 0.25
TP_PARAM_SHARE = 1e-3
# the captioner's vocab-sized leaves, in _tree_paths' form
TP_VOCAB_LEAVES = (("classifier", "bias"), ("classifier", "weight"),
                   ("word_embed", "weight"))
PP_N_PNG = 32
PP_FEAT_BS = 32
PP_CPU_TOL = 1e-4
SWITCH_SETS = {"default": {}, "fused_topk": {"ISC_FUSED_TOPK": "1"},
               "v2": {"ISC_ATT_KERNEL": "v2"},
               "both": {"ISC_FUSED_TOPK": "1", "ISC_ATT_KERNEL": "v2"}}


def decode_expected(npz) -> dict:
    """{file name: PIL's array} from a loaded expected.npz, which stores
    each array as its differences along each row (uint8, wrapping), and
    once for the names in ``SAME_PIXELS``."""
    import numpy as np
    out = {k: np.cumsum(npz[k], axis=1, dtype=np.uint8) for k in npz.files}
    out.update({k: out[v] for k, v in SAME_PIXELS.items()})
    return out


def _fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _smi(fields="name,power.limit"):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def _bound(nbytes, flops, rate, tanh=0, sms=0):
    """The least time in ms and what sets it: the bytes over the memory
    rate ("bytes"), the flops over ``rate`` ("operations"), or ``tanh``
    special-function operations over SFU_OPS_CLK a clock on each of
    ``sms`` SMs at SM_CLOCK_HZ ("tanh"), whichever is the largest."""
    terms = [(nbytes / HBM_BYTES_S * 1e3, "bytes"),
             (flops / rate * 1e3, "operations")]
    if tanh:
        terms.append((tanh / (SFU_OPS_CLK * sms * SM_CLOCK_HZ) * 1e3, "tanh"))
    return max(terms, key=lambda t: t[0])


def _bound_by(term):
    """The kernels line's word for a bound's term: a tanh is an operation,
    over its type's peak rate."""
    return "bytes" if term == "bytes" else "operations"


@contextlib.contextmanager
def _switches(name):
    """The kernel switches of SWITCH_SETS[name], the others unset; the
    environment is restored on exit."""
    keys = ("ISC_FUSED_TOPK", "ISC_ATT_KERNEL")
    prev = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    os.environ.update(SWITCH_SETS[name])
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def _wino_plain(wk):
    """The Winograd stack's three wrappers replaced, for the block, by
    their plain twins, which ``conv3x3_stack_sm`` then calls on the card
    (the twins count no launch); restored on exit."""
    saved = wk.wino_input, wk.wino_middle, wk.wino_output
    wk.wino_input, wk.wino_middle, wk.wino_output = (
        wk.wino_input_plain, wk.wino_middle_plain, wk.wino_output_plain)
    try:
        yield
    finally:
        wk.wino_input, wk.wino_middle, wk.wino_output = saved


@contextlib.contextmanager
def _v1_exact_tanh(fa):
    """The beam's v1 attention calls with ``exact_tanh=True`` (tanhf) for
    the block: the op wrapped in the module the beam reads it from, its
    launch counts carried through and the op restored on exit (no switch
    is added)."""
    orig = fa.beam_content_attention

    def wrapped(*args, **kw):
        return orig(*args, exact_tanh=True, **kw)
    wrapped.launches = orig.launches
    wrapped.launches_v2 = orig.launches_v2
    fa.beam_content_attention = wrapped
    try:
        yield
    finally:
        orig.launches, orig.launches_v2 = (wrapped.launches,
                                           wrapped.launches_v2)
        fa.beam_content_attention = orig


def _first_eos(seqs, eos):
    """First-EOS position of every [.., T] row (T where absent)."""
    import numpy as np
    seqs = np.asarray(seqs).reshape(-1, seqs.shape[-1])
    hit = seqs == eos
    return np.where(hit.any(axis=1), hit.argmax(axis=1), seqs.shape[1])


def _run_groups(request, n, groups):
    """Call request(i) for every i from its own thread, the groups one
    after another; returns (results, errors, seconds)."""
    results = [None] * n
    errors = []

    def ask(i):
        try:
            results[i] = request(i)
        except Exception as e:  # noqa: BLE001 — raised by the caller
            errors.append(repr(e))

    t0 = time.time()
    for group in groups:
        threads = [threading.Thread(target=ask, args=(i,)) for i in group]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
            _check(not th.is_alive(), "a request never returned")
    return results, errors, time.time() - t0


def _serve(batcher, fcs, atts, sentis, forced, groups):
    """Submit every request from its own thread, group after group; returns
    (results, errors, seconds)."""
    return _run_groups(lambda i: batcher.submit(
        fcs[i], atts[i], sentis[i], forced_label=forced[i], timeout=600),
        len(fcs), groups)


def _check_results(results, errors):
    import numpy as np
    _check(not errors, f"requests failed: {errors}")
    for seqs, scores, label in results:
        _check(seqs.shape == (BEAM, T), f"seqs shape {seqs.shape}")
        _check(seqs.min() >= 0 and seqs.max() < VOCAB, "token id range")
        _check(np.isfinite(scores).all(), "non-finite score")
        _check((np.diff(scores) <= 0).all(), "scores not descending")
        _check(0 <= label < NUM_CATS, f"label {label}")


def _compare_e2e(torch, tag, kernel_out, plain_out):
    """f32 kernel path against the plain path: identical labels, >= 99%
    identical top beams, scores within 1e-3 on those. Returns a report."""
    ks, ksc, kl = kernel_out
    ps, psc, pl = plain_out
    # the score bound holds where the top beams are the same caption; an
    # image whose search took another path at a near-tie scores another
    # caption
    eq = (ks[:, 0] == ps[:, 0]).all(dim=1)
    same = eq.float().mean().item()
    dscore = (ksc[eq, 0] - psc[eq, 0]).abs().max().item() if eq.any() \
        else float("inf")
    print(f"f32 bs={BS} {tag}, kernel vs plain: labels equal "
          f"{bool(torch.equal(kl, pl))}, top-beam tokens identical on "
          f"{same:.2%} of images, max top-beam score diff on those "
          f"{dscore:.3g}")
    diverged = []
    for i in (~eq).nonzero()[:, 0].tolist():
        step = int((ks[i, 0] != ps[i, 0]).nonzero()[0, 0])
        diverged.append({"image": i, "first_step": step,
                         "kernel_score": float(ksc[i, 0]),
                         "plain_score": float(psc[i, 0])})
        print(f"  image {i}: top beams part at step {step}, scores kernel "
              f"{float(ksc[i, 0]):.6f} plain {float(psc[i, 0]):.6f}")
    _check(torch.equal(kl, pl), f"{tag}: labels differ between kernel and "
           "plain")
    _check(same >= 0.99, f"{tag}: top-beam tokens identical on only "
           f"{same:.2%}")
    _check(dscore <= 1e-3, f"{tag}: top-beam score diff {dscore}")
    return {"top_beam_identical": same, "max_score_diff": dscore,
            "diverged": diverged}


def _top_beams_vs_plain(seqs, scores, plain_seqs, plain_scores):
    """(the images whose top beam equals the plain path's, [bs] bool; the
    largest top-beam score difference on those)."""
    eq = (seqs[:, 0] == plain_seqs[:, 0]).all(dim=1)
    dscore = float((scores[eq, 0].float() - plain_scores[eq, 0].float())
                   .abs().max()) if eq.any() else float("inf")
    return eq, dscore


def _within_rounding(torch, got, want, rtol, scale_frac):
    """|got - want| <= rtol*|want| + scale_frac*max|want| everywhere;
    returns (ok, max_abs_err)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = rtol * want.abs() + scale_frac * want.abs().max()
    return bool((err <= tol).all()), float(err.max())


def _post(port, payload=None, raw=None, length=None):
    """POST /caption on 127.0.0.1:port; returns (status, JSON body).
    ``length`` sends that Content-Length with no body."""
    import http.client
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        if length is not None:
            c.putrequest("POST", "/caption")
            c.putheader("Content-Length", str(length))
            c.endheaders()
        else:
            c.request("POST", "/caption", raw or json.dumps(payload),
                      {"Content-Type": "application/json"})
        r = c.getresponse()
        return r.status, json.loads(r.read())
    finally:
        c.close()


def _get(port, path):
    import http.client
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def _png_bytes(img, zlib, interlace=False):
    """A PNG of an RGB uint8 image, the five row filters in turn (the
    decoder's sequential Sub and Paeth among them), from zlib and crc32;
    ``interlace``: Adam7, each of the seven passes filtered on its own."""
    import struct
    import numpy as np
    h, w, _ = img.shape
    passes = ([img] if not interlace else
              [img[y0::dy, x0::dx] for x0, y0, dx, dy in (
                  (0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
                  (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))])
    out = []
    for sub in passes:
        if not sub.size:
            continue
        rows = sub.reshape(sub.shape[0], -1).astype(np.int32)
        for y in range(len(rows)):
            ft = y % 5
            r = rows[y]
            up = rows[y - 1] if y else np.zeros_like(r)
            a = np.concatenate([np.zeros(3, np.int32), r[:-3]])
            c = np.concatenate([np.zeros(3, np.int32), up[:-3]])
            if ft == 4:
                p = a + up - c
                pa, pb, pc = abs(p - a), abs(p - up), abs(p - c)
                pred = np.where((pa <= pb) & (pa <= pc), a,
                                np.where(pb <= pc, up, c))
            else:
                pred = [0 * r, a, up, (a + up) // 2][ft]
            out.append(bytes([ft]) + ((r - pred) % 256).astype(np.uint8)
                       .tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                         int(interlace)))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))



def gif_lzw(np, indices, min_size=8, *, clear_when_full=True,
            end_after=None):
    """GIF's LZW code stream (before the sub-blocks) of a sequence of
    palette indices below 2^min_size: a clear code first, each code as wide
    as the decoder reads it (one bit more once it has filled the codes of
    the width), the end code last. A full table (4096 entries) is cleared
    where ``clear_when_full``, else the codes go on at 12 bits with no new
    entries; ``end_after``: an end code also after that many codes, the
    stream going on after it."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    bits = nbits = 0
    out = bytearray()
    width, dec_next, table, first, n_codes = min_size + 1, end + 1, {}, True, 0

    def emit(code):
        nonlocal bits, nbits, width, dec_next, first, n_codes
        bits |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(bits & 255)
            bits >>= 8
            nbits -= 8
        if code in (clear, end):
            return
        # the decoder adds an entry on every code but the first after a
        # clear, and widens its codes once it has made the last of a width
        if not first and dec_next < 4096:
            if dec_next == (1 << width) - 1 and width < 12:
                width += 1
            dec_next += 1
        first = False
        n_codes += 1
        if n_codes == end_after:
            emit(end)

    emit(clear)
    w = None
    for k in np.ravel(indices).tolist():
        if w is None:
            w = k
            continue
        key = (w, k)
        if key in table:
            w = table[key]
            continue
        emit(w)
        if len(table) + end + 1 < 4096:
            table[key] = len(table) + end + 1
        elif clear_when_full:
            emit(clear)
            width, dec_next, table, first = min_size + 1, end + 1, {}, True
        w = k
    if w is not None:
        emit(w)
    emit(end)
    if nbits:
        out.append(bits & 255)
    return bytes(out)


def gif_blocks(data):
    """``data`` in GIF sub-blocks of at most 255 bytes, and the empty block
    that ends them."""
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


# -- a VP8L (WebP lossless) writer: the bitstream and its containers --------

# the 120 short distance codes of VP8L: (dx, dy), a distance dy * width + dx
_VP8L_DISTANCE_MAP = (
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2), (2, 1),
    (-2, 1), (2, 2), (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3), (3, 1),
    (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2), (0, 4), (4, 0), (1, 4),
    (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4), (4, 2),
    (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0), (1, 5),
    (-1, 5), (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2), (4, 4),
    (-4, 4), (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6), (6, 0), (1, 6),
    (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2), (4, 5),
    (-4, 5), (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3), (0, 7),
    (7, 0), (1, 7), (-1, 7), (5, 5), (-5, 5), (7, 1), (-7, 1), (4, 6),
    (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2), (3, 7),
    (-3, 7), (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5), (8, 0),
    (4, 7), (-4, 7), (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6), (-6, 6),
    (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5), (8, 4), (6, 7), (-6, 7),
    (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7))
_VP8L_TRANSFORMS = {"predictor": 0, "cross_colour": 1, "subtract_green": 2,
                    "colour_indexing": 3}


class VP8LBitWriter:
    """VP8L's bits: least significant first."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, nbits):
        self.acc |= (value & ((1 << nbits) - 1)) << self.n
        self.n += nbits
        while self.n >= 8:
            self.out.append(self.acc & 255)
            self.acc >>= 8
            self.n -= 8

    def code(self, code, length):
        """A prefix code, its first (most significant) bit first."""
        for i in range(length - 1, -1, -1):
            self.put(code >> i & 1, 1)

    def bytes(self):
        return bytes(self.out) + (bytes([self.acc]) if self.n else b"")


def _vp8l_prefix(v):
    """A length or distance code v >= 1 as VP8L's prefix symbol, its
    number of extra bits and their value."""
    if v <= 4:
        return v - 1, 0, 0
    hi = (v - 1).bit_length() - 1
    second = (v - 1) >> (hi - 1) & 1
    return 2 * hi + second, hi - 1, v - 1 - ((2 + second) << (hi - 1))


def _huffman_lengths(freq, limit):
    """Code lengths of a Huffman code of the symbol frequencies, none past
    ``limit`` (the frequencies halved until it fits); one used symbol gets
    length 1."""
    import heapq
    used = [s for s, f in enumerate(freq) if f]
    lens = [0] * len(freq)
    if len(used) == 1:
        lens[used[0]] = 1
        return lens
    f = list(freq)
    while True:
        heap = [(f[s], k, (s,)) for k, s in enumerate(used)]
        heapq.heapify(heap)
        depth = dict.fromkeys(used, 0)
        k = len(heap)
        while len(heap) > 1:
            a, b = heapq.heappop(heap), heapq.heappop(heap)
            for s in a[2] + b[2]:
                depth[s] += 1
            heapq.heappush(heap, (a[0] + b[0], k, a[2] + b[2]))
            k += 1
        if max(depth.values()) <= limit:
            break
        f = [(x + 1) // 2 for x in f]
    for s, d in depth.items():
        lens[s] = d
    return lens


def _canonical(lens):
    """{symbol: (code, length)} of the canonical code of ``lens``; {} for a
    code of one symbol (read in no bits)."""
    order = sorted((n, s) for s, n in enumerate(lens) if n)
    if len(order) < 2:
        return {}
    out, code, prev = {}, 0, order[0][0]
    for n, s in order:
        code <<= n - prev
        prev = n
        out[s] = (code, n)
        code += 1
    return out


def _length_tokens(lens, rle):
    """The code lengths as code-length symbols (symbol, extra bits, their
    value): literals 0-15, 16 (repeat the last non-zero literal, 8 before
    any, 3-6 times), 17 (3-10 zeros) and 18 (11-138 zeros)."""
    out, prev, i = [], 8, 0
    while i < len(lens):
        v, j = lens[i], i
        while j < len(lens) and lens[j] == v:
            j += 1
        run, i = j - i, j
        if rle and v == 0:
            while run >= 3:
                k = min(run, 138)
                out.append((18, 7, k - 11) if k >= 11 else (17, 3, k - 3))
                run -= k
        elif rle:
            if prev != v:
                out.append((v, 0, 0))
                run -= 1
                prev = v
            while run >= 3:
                k = min(run, 6)
                out.append((16, 2, k - 3))
                run -= k
        out += [(v, 0, 0)] * run
        prev = v or prev
    return out


def _write_code(bw, freq, *, normal=False, max_symbol=True, rle=True):
    """One prefix code of the symbol frequencies (a code of one symbol 0
    where none is used), simple where it can be (one or two symbols below
    256, unless ``normal``), else normal: its lengths as code-length symbols
    (``rle``: with repeats), trailing zeros cut by ``max_symbol``. Returns
    {symbol: (code, length)}."""
    freq = list(freq)
    if not any(freq):
        freq[0] = 1
    used = [s for s, f in enumerate(freq) if f]
    if not normal and len(used) <= 2 and used[-1] < 256:
        bw.put(1, 1)
        bw.put(len(used) - 1, 1)
        bw.put(used[0] >= 2, 1)
        bw.put(used[0], 8 if used[0] >= 2 else 1)
        if len(used) == 2:
            bw.put(used[1], 8)
        return _canonical([1 if f else 0 for f in freq])
    lens = _huffman_lengths(freq, 15)
    tokens = _length_tokens(lens, rle)
    cut = tokens
    if max_symbol:
        while cut and cut[-1][0] in (0, 17, 18):
            cut = cut[:-1]
    cut = cut if max_symbol and 2 <= len(cut) < len(tokens) else tokens
    cl_freq = [0] * 19
    for s, _, _ in cut:
        cl_freq[s] += 1
    cl_lens = _huffman_lengths(cl_freq, 7)
    order = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
    ncodes = max([4] + [k + 1 for k, s in enumerate(order) if cl_lens[s]])
    bw.put(0, 1)
    bw.put(ncodes - 4, 4)
    for s in order[:ncodes]:
        bw.put(cl_lens[s], 3)
    if cut is tokens:
        bw.put(0, 1)
    else:
        nbits = next(b for b in range(2, 17, 2) if len(cut) - 2 < 1 << b)
        bw.put(1, 1)
        bw.put((nbits - 2) // 2, 3)
        bw.put(len(cut) - 2, nbits)
    cl_codes = _canonical(cl_lens)
    for s, nbits, extra in cut:
        if cl_codes:
            bw.code(*cl_codes[s])
        bw.put(extra, nbits)
    return _canonical(lens)


def _vp8l_stream(np, bw, img, *, cache_bits=0, meta=None, level0=False,
                 distances=range(1, 121), min_match=3, codes=None):
    """One VP8L image stream of ARGB ``img`` [h, w] (uint32): the colour
    cache, the meta codes (``meta``: (bits, [h', w'] group indices), the top
    level only), a prefix code group for each group index, then the pixels
    as literals, cache hits and backward references. ``distances``: the
    distance codes tried at each pixel, the longest match of at least
    ``min_match`` pixels taken (1-120: the distance map; above: that less
    120); ``codes``: ``_write_code``'s options."""
    codes = codes or {}
    h, w = img.shape
    px = [int(v) for v in np.ravel(img)]
    bw.put(cache_bits > 0, 1)
    if cache_bits:
        bw.put(cache_bits, 4)
    groups, gbits = None, 0
    if level0:
        bw.put(meta is not None, 1)
        if meta is not None:
            gbits, groups = meta[0], np.asarray(meta[1], np.int64)
            bw.put(gbits - 2, 3)
            _vp8l_stream(np, bw, ((groups & 0xFFFF) << 8).astype(np.uint32),
                         distances=distances, codes=codes)
    dists = []
    for c in distances:
        if c <= 120:
            dx, dy = _VP8L_DISTANCE_MAP[c - 1]
            dists.append((c, max(1, dy * w + dx)))
        else:
            dists.append((c, c - 120))
    cache = [0] * (1 << cache_bits)
    tokens, i = [], 0
    while i < len(px):
        best = (0, 0)
        for c, d in dists:
            if d <= i:
                n = 0
                while (n < 4096 and i + n < len(px)
                       and px[i + n] == px[i + n - d]):
                    n += 1
                if n > best[0]:
                    best = (n, c)
        g = 0 if groups is None else int(
            groups[(i // w) >> gbits, (i % w) >> gbits])
        if best[0] >= min_match:
            n = best[0]
            tokens.append((g, "copy", n, best[1]))
        else:
            n = 1
            key = (0x1E35A7BD * px[i] & 0xFFFFFFFF) >> (32 - cache_bits)
            if cache_bits and cache[key] == px[i]:
                tokens.append((g, "cache", key))
            else:
                tokens.append((g, "literal", px[i]))
        for v in px[i:i + n]:
            if cache_bits:
                cache[(0x1E35A7BD * v & 0xFFFFFFFF) >> (32 - cache_bits)] = v
        i += n
    ngroups = 1 if groups is None else int(groups.max()) + 1
    sizes = (280 + (1 << cache_bits if cache_bits else 0), 256, 256, 256, 40)
    freq = [[[0] * n for n in sizes] for _ in range(ngroups)]
    for t in tokens:
        f = freq[t[0]]
        if t[1] == "literal":
            v = t[2]
            for k, ch in ((0, v >> 8), (1, v >> 16), (2, v), (3, v >> 24)):
                f[k][ch & 255] += 1
        elif t[1] == "cache":
            f[0][280 + t[2]] += 1
        else:
            f[0][256 + _vp8l_prefix(t[2])[0]] += 1
            f[4][_vp8l_prefix(t[3])[0]] += 1
    tables = [[_write_code(bw, fk, **codes) for fk in f] for f in freq]

    def sym(table, s):
        if table:
            bw.code(*table[s])
    for t in tokens:
        tb = tables[t[0]]
        if t[1] == "literal":
            v = t[2]
            for k, ch in ((0, v >> 8), (1, v >> 16), (2, v), (3, v >> 24)):
                sym(tb[k], ch & 255)
        elif t[1] == "cache":
            sym(tb[0], 280 + t[2])
        else:
            for k, v, base in ((0, t[2], 256), (4, t[3], 0)):
                s, nbits, extra = _vp8l_prefix(v)
                sym(tb[k], base + s)
                bw.put(extra, nbits)


def vp8l(np, coded, *, size=None, transforms=(), cache_bits=0, meta=None,
         sub_cache_bits=0, **stream):
    """A VP8L bitstream (the chunk's payload) of ``coded`` [h, w'] ARGB
    (uint32), the pixels as coded: what the decoder reads before it undoes
    the transforms. ``size``: the header's (width, height), (w', h) by
    default (the width before colour indexing packs the pixels);
    ``transforms``: in the order written, ("predictor", bits, modes),
    ("cross_colour", bits, multipliers), ("subtract_green",) and
    ("colour_indexing", palette), each sub-image ARGB (the predictor's mode
    in green; green_to_red, green_to_blue, red_to_blue in blue, green and
    red; the palette [n] delta-coded); ``meta``: (bits, group indices);
    ``sub_cache_bits``: the sub-images' colour cache; the rest is
    ``_vp8l_stream``'s."""
    coded = np.asarray(coded, np.uint32)
    w, h = size or (coded.shape[1], coded.shape[0])
    bw = VP8LBitWriter()
    bw.put(0x2F, 8)
    bw.put(w - 1, 14)
    bw.put(h - 1, 14)
    bw.put(0, 4)                        # alpha_is_used, version 0
    for kind, *args in transforms:
        bw.put(1, 1)
        bw.put(_VP8L_TRANSFORMS[kind], 2)
        if kind in ("predictor", "cross_colour"):
            bw.put(args[0] - 2, 3)
            sub = np.asarray(args[1], np.uint32)
        elif kind == "colour_indexing":
            sub = np.asarray(args[0], np.uint32).reshape(1, -1)
            bw.put(sub.size - 1, 8)
        else:
            continue
        _vp8l_stream(np, bw, sub, cache_bits=sub_cache_bits, **stream)
    bw.put(0, 1)
    _vp8l_stream(np, bw, coded, cache_bits=cache_bits, meta=meta,
                 level0=True, **stream)
    return bw.bytes()


def webp_chunk(tag, payload):
    """A RIFF chunk: tag, little-endian size, payload, a pad byte to an
    even size."""
    import struct
    return tag + struct.pack("<I", len(payload)) + payload + bytes(
        len(payload) & 1)


def webp_file(*chunks):
    """A WebP file of the chunks: RIFF, its size, WEBP."""
    import struct
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def webp_vp8x(w, h, flags=0):
    """A VP8X chunk: flags (0x02 animation, 0x04 XMP, 0x08 EXIF, 0x10
    alpha, 0x20 ICC) and the canvas size."""
    return webp_chunk(b"VP8X", bytes([flags, 0, 0, 0])
                      + (w - 1).to_bytes(3, "little")
                      + (h - 1).to_bytes(3, "little"))


def webp_anmf(x, y, w, h, *chunks):
    """An ANMF chunk: the frame's offset (even) and size, a duration of
    100 ms, no flags (blending, no disposal), then its chunks."""
    head = b"".join(v.to_bytes(3, "little")
                    for v in (x // 2, y // 2, w - 1, h - 1, 100))
    return webp_chunk(b"ANMF", head + b"\0" + b"".join(chunks))


def webp_anim(background=0):
    """An ANIM chunk: the background colour (BGRA), loops 0 (forever)."""
    return webp_chunk(b"ANIM", background.to_bytes(4, "little") + bytes(2))


def _webp_bytes(np, img):
    """A lossless WebP of an RGB uint8 image written here: the
    subtract-green transform, a colour cache and backward references
    (the short distance codes and plain distances up to 64); and the pixels
    it decodes to."""
    img = np.asarray(img, np.uint32)
    r, g, b = img[:, :, 0], img[:, :, 1], img[:, :, 2]
    coded = (0xFF000000 | ((r - g) & 255) << 16 | g << 8 | ((b - g) & 255))
    data = vp8l(np, coded, transforms=[("subtract_green",)], cache_bits=6,
                distances=list(range(1, 121)) + list(range(121, 185)))
    return webp_file(webp_chunk(b"VP8L", data)), img.astype(np.uint8)


def _quantised(np, img):
    """An RGB uint8 image as indices into the 3-3-2 colour cube (256
    colours: R and G to 3 bits, B to 2) and that cube's [256, 3] palette."""
    idx = ((img[:, :, 0] >> 5).astype(np.int64) << 5
           | (img[:, :, 1] >> 5).astype(np.int64) << 2 | img[:, :, 2] >> 6)
    c = np.arange(256)
    pal = np.stack([(c >> 5) * 255 // 7, (c >> 2 & 7) * 255 // 7,
                    (c & 3) * 85], -1).astype(np.uint8)
    return idx.astype(np.uint8), pal


def _gif_bytes(np, img):
    """A plain GIF89a of an RGB uint8 image quantised to the 3-3-2 cube,
    and the pixels it decodes to."""
    import struct
    idx, pal = _quantised(np, img)
    h, w = idx.shape
    data = (b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0)
            + pal.tobytes() + b"," + struct.pack("<HHHHB", 0, 0, w, h, 0)
            + b"\x08" + gif_blocks(gif_lzw(np, idx)) + b";")
    return data, pal[idx]


def _rle8(np, idx):
    """BMP RLE8 of [h, w] indices, bottom-up: a run of 2 or more as an
    encoded run, the pixels between as absolute runs (3 to 255, word
    aligned) or runs of one, end of line after each row, end of bitmap."""
    out = bytearray()
    for row in idx[::-1].tolist():
        i, n = 0, len(row)
        while i < n:
            j = i
            while j < n and j - i < 255 and row[j] == row[i]:
                j += 1
            if j - i >= 2:
                out += bytes([j - i, row[i]])
                i = j
                continue
            j = i + 1                   # literals up to the next pair
            while j < n and j - i < 255 and not (j + 1 < n
                                                 and row[j] == row[j + 1]):
                j += 1
            lit = row[i:j]
            if len(lit) >= 3:
                out += bytes([0, len(lit)]) + bytes(lit) + bytes(len(lit) % 2)
            else:
                for v in lit:
                    out += bytes([1, v])
            i = j
        out += b"\0\0"
    return bytes(out + b"\0\1")


def write_bmp(np, px, bits, *, header=40, palette=None, compression=0,
              masks=None, top_down=False, colors=None, offset=None,
              rle=None):
    """A BMP of ``px``: [h, w] palette indices (1, 4, 8 bits), [h, w]
    16- or 32-bit pixel words, or [h, w, 3] RGB (24 bits); ``rle``: the
    RLE data itself, byte for byte, in place of the rows. ``palette``
    [n, 3] RGB (BGR0 entries, BGR after the 12-byte header); ``masks``
    (r, g, b[, a]) in the header from 52 bytes on, after a 40-byte one;
    ``colors`` the header's colour count (the palette's by default);
    ``offset`` the pixel data's offset in the file header (where it lies
    by default)."""
    import struct
    px = np.asarray(px)
    h, w = px.shape[:2]
    if rle is not None:
        body = rle
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        if bits < 8:                    # the first pixel in the high bits
            shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
            v = np.zeros((h, -(-w * bits // 8) * 8 // bits), np.uint8)
            v[:, :w] = px
            rows = np.bitwise_or.reduce(v.reshape(h, -1, 8 // bits) << shifts,
                                        axis=2).astype(np.uint8)
        elif bits == 24:
            rows = px[:, :, ::-1].astype(np.uint8).reshape(h, -1)
        else:
            rows = px.astype({8: np.uint8, 16: "<u2", 32: "<u4"}[bits]
                             ).reshape(h, -1).view(np.uint8)
        padded = np.zeros((h, stride), np.uint8)
        padded[:, :rows.shape[1]] = rows
        body = (padded if top_down else padded[::-1]).tobytes()
    entry = 3 if header == 12 else 4
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8).reshape(-1, 3)[:, ::-1]
        pal = np.concatenate([p, np.zeros((len(p), entry - 3), np.uint8)],
                             1).tobytes()
    if colors is None:
        colors = len(pal) // entry
    if header == 12:
        dib = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        dib = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h,
                          1, bits, compression, len(body), 2835, 2835,
                          colors, 0)
        if header >= 52 and masks is not None:
            dib += struct.pack("<4I", *(tuple(masks) + (0,))[:4])[
                :header - 40]
        dib += bytes(header - len(dib))
    extra = (struct.pack("<3I", *masks[:3])
             if header == 40 and masks is not None else b"")
    head = dib + extra + pal
    if offset is None:
        offset = 14 + len(head)
    data = b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset)
    data += head + bytes(max(0, offset - 14 - len(head)))
    return data + body


def _bmp_bytes(np, img, rle8=False):
    """A BMP (BITMAPINFOHEADER) of an RGB uint8 image: 24-bit bottom-up
    rows, or ``rle8``: RLE8 of its 3-3-2 quantisation with the cube's
    256-entry palette; and the pixels it decodes to."""
    if not rle8:
        return write_bmp(np, img, 24), img
    idx, pal = _quantised(np, img)
    return (write_bmp(np, idx, 8, compression=1, palette=pal,
                      rle=_rle8(np, idx)), pal[idx])


def packbits(data):
    """PackBits of a byte string: runs of 3 to 128 equal bytes as a repeat
    (-(n - 1), byte), the bytes between as literals of up to 128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i                           # literals up to the next run of 3
        while j < n and j - i < 128 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def tiff_lzw(data, *, old=False, clear_at=4094):
    """TIFF's LZW of a byte string as libtiff's LZWEncode codes it: CLEAR
    first, then the code of each longest string in the table, each adding
    an entry (up to 4095), CLEAR again once the next free entry reaches
    ``clear_at`` (libtiff's 4094; past 4095 the count goes on while the
    table stays as it is, as the decoder's does; None: never), EOI last;
    packed by ``lzw_pack``, new style or ``old``."""
    codes, table, nxt = [256], {}, 258
    data = bytes(data)
    if data:
        ent = data[0]
        for c in data[1:]:
            hit = table.get((ent, c))
            if hit is not None:
                ent = hit
                continue
            codes.append(ent)
            if nxt < 4096:
                table[(ent, c)] = nxt
            nxt += 1
            ent = c
            if nxt == clear_at:
                codes.append(256)
                table.clear()
                nxt = 258
        codes.append(ent)
    return lzw_pack(codes + [257], old=old)


def lzw_pack(codes, *, old=False):
    """TIFF LZW codes packed as libtiff's decoder reads them: each as wide
    as its table then calls for (9 bits after CLEAR; a bit more once the
    next free entry reaches 2^bits - 1 in the new style, 2^bits in the
    old; 12 at most), MSB-first (new) or LSB-first (old, the codes of
    LZWDecodeCompat), the last byte padded with zeros. The decoder adds
    an entry at each code but CLEAR, EOI and the first after CLEAR, up to
    5118; then only CLEAR or EOI may follow."""
    out, acc, nacc = bytearray(), 0, 0
    width, nxt, fresh = 9, -1, True
    for c in codes:
        if old:
            acc |= c << nacc
        else:
            acc = (acc << width) | c
        nacc += width
        while nacc >= 8:
            nacc -= 8
            if old:
                out.append(acc & 255)
                acc >>= 8
            else:
                out.append((acc >> nacc) & 255)
                acc &= (1 << nacc) - 1
        if c == 256:
            width, nxt, fresh = 9, 258, True
        elif c == 257 or nxt < 0:
            continue
        elif fresh:
            fresh = False
        else:
            nxt += 1
            if nxt > (1 << width) - (1 if old else 2):
                width = min(width + 1, 12)
                if nxt >= 5119:
                    nxt = -1
    if nacc:
        out.append(acc & 255 if old else (acc << (8 - nacc)) & 255)
    return bytes(out)


def tiff_file(pages, *, order="<", bigtiff=False, magic=None, loop=False):
    """A TIFF file: the header, each page's data blocks (word aligned),
    then the pages' IFDs, chained, each with its values that do not fit
    in an entry after it. ``pages``: [(entries, blocks)], an entry (tag,
    type, values) written in the order given, values a list of numbers
    (of pairs flattened for the rationals), bytes (types 1, 2 and 7), or
    "offsets" / "counts": the offsets / lengths of the page's blocks.
    ``magic``: the header's first four bytes in place of the byte order's
    own; ``loop``: the last IFD's next pointer back at the first IFD."""
    import struct
    from insenticap_model_tpu_torch.preprocessing import _TIFF_TYPES
    big = order == ">"
    head = 16 if bigtiff else 8
    off, cnt, esize, inline = ("Q", "Q", 20, 8) if bigtiff else (
        "I", "H", 12, 4)
    body = bytearray()
    placed = []
    for _, blocks in pages:
        offs = []
        for b in blocks:
            offs.append(head + len(body))
            body += b + bytes(len(b) % 2)
        placed.append((offs, [len(b) for b in blocks]))

    def value_bytes(typ, vals, offs, counts):
        if isinstance(vals, str):
            vals = offs if vals == "offsets" else counts
        if isinstance(vals, (bytes, bytearray)):
            return bytes(vals), len(vals)
        size, code = _TIFF_TYPES[typ]
        code = code or "B"
        return struct.pack(order + code * len(vals), *vals), len(vals) * (
            struct.calcsize("=" + code)) // size
    ifds, pos = [], head + len(body)
    for (entries, _), (offs, counts) in zip(pages, placed):
        table_end = pos + struct.calcsize(cnt) + esize * len(entries) + (
            struct.calcsize(off))
        table, extra = struct.pack(order + cnt, len(entries)), bytearray()
        for tag, typ, vals in entries:
            data, n = value_bytes(typ, vals, offs, counts)
            if len(data) <= inline:
                field = data + bytes(inline - len(data))
            else:
                field = struct.pack(order + off, table_end + len(extra))
                extra += data + bytes(len(data) % 2)
            table += struct.pack(order + "HH" + cnt.replace("H", "I"),
                                 tag, typ, n) + field
        ifds.append((pos, table, extra))
        pos = table_end + len(extra)
    out = bytearray((b"MM" if big else b"II") + struct.pack(
        order + "H", 43 if bigtiff else 42))
    if bigtiff:
        out += struct.pack(order + "HH", 8, 0)
    out += struct.pack(order + off, ifds[0][0] if ifds else 0)
    if magic is not None:
        out[:4] = magic
    out += body
    for i, (at, table, extra) in enumerate(ifds):
        nxt = (ifds[i + 1][0] if i + 1 < len(ifds)
               else ifds[0][0] if loop else 0)
        out += table + struct.pack(order + off, nxt) + extra
    return bytes(out)


def _tiff_bytes(np, zlib, img, compression=1):
    """A little-endian TIFF of an RGB uint8 image, written here: one IFD,
    strips of about 64 KiB (as PIL's writer cuts them), uncompressed (1),
    PackBits (32773, row by row), or LZW (5, ``tiff_lzw``'s new-style
    codes) or Deflate (8) with horizontal differencing (predictor 2); and
    the pixels it decodes to."""
    h, w, _ = img.shape
    rows = max(1, min(h, 65536 // (3 * w)))
    strips = []
    for y in range(0, h, rows):
        part = np.ascontiguousarray(img[y:y + rows])
        if compression in (5, 8):
            diff = part.copy()
            diff[:, 1:] -= part[:, :-1]      # wraps in uint8
            strips.append(zlib.compress(diff.tobytes()) if compression == 8
                          else tiff_lzw(diff.tobytes()))
        elif compression == 32773:
            strips.append(b"".join(packbits(r.tobytes()) for r in part))
        else:
            strips.append(part.tobytes())
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]),
               (259, 3, [compression]), (262, 3, [2]),
               (273, 4, "offsets"), (277, 3, [3]), (278, 4, [rows]),
               (279, 4, "counts"), (284, 3, [1])]
    if compression in (5, 8):
        entries.append((317, 3, [2]))
    return tiff_file([(entries, strips)]), img


def _tiff_jpeg_bytes(jpeg, h, w):
    """A little-endian TIFF of one YCbCr page under JPEG (7) whose one
    strip is the h x w 4:2:0 JPEG ``jpeg`` as it is (no encoder needed):
    YCbCrSubsampling 2, 2, no JPEGTables."""
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]),
               (259, 3, [7]), (262, 3, [6]), (273, 4, "offsets"),
               (277, 3, [3]), (278, 4, [h]), (279, 4, "counts"),
               (284, 3, [1]), (530, 3, [2, 2])]
    return tiff_file([(entries, [jpeg])])



# phase 3e's YCbCr TIFFs (``_tiff_ycbcr_bytes``): name -> (subsampling,
# compression, planar configuration)
YCBCR_PAGES = {"ycbcr22_lzw": ((2, 2), 5, 1),
               "ycbcr11_deflate_planar": ((1, 1), 8, 2),
               "ycbcr_jpeg_planar": ((1, 1), 7, 2)}


def ycbcr(np, img):
    """RGB uint8 -> YCbCr uint8 (JFIF's full-range transform, rounded),
    which libtiff's default YCbCrCoefficients and ReferenceBlackWhite
    undo."""
    c = img.astype(np.float64)
    y = 0.299 * c[..., 0] + 0.587 * c[..., 1] + 0.114 * c[..., 2]
    cb = 128 + (c[..., 2] - y) / 1.772
    cr = 128 + (c[..., 0] - y) / 1.402
    return np.clip(np.rint(np.stack([y, cb, cr], -1)), 0, 255).astype(
        np.uint8)


def ycbcr_units(np, part, hs, vs):
    """[n, w, 3] Y, Cb, Cr samples -> the bytes of TIFF's subsampled
    YCbCr in one plane: ceil(n / vs) rows of ceil(w / hs) data units, each
    its hs x vs Y samples row by row, then one Cb and one Cr (its top-left
    pixel's), the edges padded by repeating the last row and column."""
    n, w, _ = part.shape
    p = np.pad(np.asarray(part, np.uint8), ((0, -n % vs), (0, -w % hs),
                                            (0, 0)), mode="edge")
    down, across = p.shape[0] // vs, p.shape[1] // hs
    y = p[:, :, 0].reshape(down, vs, across, hs).transpose(0, 2, 1, 3)
    return np.concatenate([y.reshape(down, across, vs * hs),
                           p[::vs, ::hs, 1:]], 2).tobytes()


_JPEG_ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12,
                19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35,
                42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62,
                63)
_JPEG_LUMA_Q = (16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60,
                55, 14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87,
                80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81,
                104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95,
                98, 112, 100, 103, 99)


def jpeg_grey(np, plane, quality=90):
    """A baseline JPEG of one 8-bit component (1 x 1 sampling) of a 2-D
    uint8 ``plane``, written here without PIL: the forward DCT of each 8x8
    block (edges repeated), the luminance table of the JPEG standard
    scaled to ``quality`` as libjpeg scales it, and Huffman codes of one
    length a table (the fewest bits that hold the symbols used, so that
    no code is all ones)."""
    import struct
    h, w = plane.shape
    p = np.pad(plane.astype(np.float64) - 128, ((0, -h % 8), (0, -w % 8)),
               mode="edge")
    k = np.arange(8)
    dct = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    dct[0] /= np.sqrt(2)
    blocks = p.reshape(p.shape[0] // 8, 8, -1, 8).transpose(0, 2, 1, 3)
    coef = dct @ blocks @ dct.T
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    q = np.clip((np.array(_JPEG_LUMA_Q) * scale + 50) // 100, 1, 255)
    zz = np.rint(coef.reshape(-1, 64)[:, list(_JPEG_ZIGZAG)]
                 / q[list(_JPEG_ZIGZAG)]).astype(np.int64)
    syms, pred = [], 0                  # (table, symbol, extra bits, width)
    for row in zz:
        d, pred = int(row[0]) - pred, int(row[0])
        n = abs(d).bit_length()
        syms.append((0, n, d if d >= 0 else d + (1 << n) - 1, n))
        run = 0
        for v in row[1:].tolist():
            if v == 0:
                run += 1
                continue
            while run > 15:
                syms.append((1, 0xF0, 0, 0))
                run -= 16
            n = abs(v).bit_length()
            syms.append((1, run << 4 | n, v if v >= 0 else v + (1 << n) - 1,
                         n))
            run = 0
        if run:
            syms.append((1, 0, 0, 0))
    tables, bits = [], []
    for t in (0, 1):
        used = sorted({s for tt, s, _, _ in syms if tt == t})
        width = len(used).bit_length()
        tables.append(({s: i for i, s in enumerate(used)}, width))
        counts = [0] * 16
        counts[width - 1] = len(used)
        bits.append(bytes([t << 4]) + bytes(counts) + bytes(used))
    out = []
    for t, sym, extra, n in syms:
        code, width = tables[t]
        out.append(format(code[sym], f"0{width}b"))
        if n:
            out.append(format(extra, f"0{n}b"))
    stream = "".join(out)
    stream += "1" * (-len(stream) % 8)
    data = int(stream, 2).to_bytes(len(stream) // 8, "big") if stream else b""
    data = data.replace(b"\xff", b"\xff\x00")

    def seg(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body
    return (b"\xff\xd8" + seg(0xDB, bytes([0]) + bytes(
        q[list(_JPEG_ZIGZAG)].tolist())) + seg(0xC0, struct.pack(
            ">BHHB", 8, h, w, 1) + bytes([1, 0x11, 0])) + seg(0xC4, bits[0])
        + seg(0xC4, bits[1]) + seg(0xDA, bytes([1, 1, 0, 0, 63, 0])) + data
        + b"\xff\xd9")


def _tiff_ycbcr_bytes(np, zlib, img, subsampling=(2, 2), compression=5,
                      planar=1):
    """A little-endian YCbCr TIFF (photometric 6) of an RGB uint8 image,
    written here (``ycbcr``): in one plane as data units of
    ``subsampling`` (``ycbcr_units``), or in separate planes (planar 2,
    1 x 1), in strips of about 64 KiB (a multiple of the vertical factor
    of rows), under LZW (5, ``tiff_lzw``), Deflate (8) or JPEG (7, each
    plane's strip a one-component stream of ``jpeg_grey``); which PIL reads
    through libtiff's RGBA interface."""
    h, w, _ = img.shape
    hs, vs = subsampling
    ycc = ycbcr(np, img)
    rows = max(vs, min(h, 65536 // (3 * w)) // vs * vs)
    strips = []
    for plane in ([ycc] if planar == 1 else
                  [ycc[:, :, c:c + 1] for c in range(3)]):
        for y in range(0, h, rows):
            part = plane[y:y + rows]
            if compression == 7:
                strips.append(jpeg_grey(np, part[:, :, 0]))
                continue
            raw = ycbcr_units(np, part, hs, vs) if planar == 1 else (
                np.ascontiguousarray(part).tobytes())
            strips.append(zlib.compress(raw) if compression == 8
                          else tiff_lzw(raw))
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]),
               (259, 3, [compression]), (262, 3, [6]),
               (273, 4, "offsets"), (277, 3, [3]), (278, 4, [rows]),
               (279, 4, "counts"), (284, 3, [planar]),
               (530, 3, [hs, vs])]
    return tiff_file([(entries, strips)])


# CCITT coding (T.4 and T.6): the codes of two-dimensional coding's modes
# (pass, horizontal, vertical by a1 - b1) and EOL, first bit first
FAX_MODES = {"P": "0001", "H": "001", 0: "1", 1: "011", 2: "000011",
             3: "0000011", -1: "010", -2: "000010", -3: "0000010"}
FAX_EOL = "000000000001"


@functools.lru_cache(maxsize=1)
def fax_codes():
    """T.4's run codes as the decoder's tables hold them (``csrc/
    imgdec.cc``, one copy for the decoder and this writer): {name: [code,
    ...]} for kWhiteTerm and kBlackTerm (runs 0-63), kWhiteMakeUp and
    kBlackMakeUp (64-1728) and kExtMakeUp (1792-2560, both colours), each
    code its bits first bit first."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "insenticap_model_tpu_torch", "csrc",
                           "imgdec.cc")) as f:
        src = f.read()
    out = {}
    for name in ("kWhiteTerm", "kWhiteMakeUp", "kBlackTerm", "kBlackMakeUp",
                 "kExtMakeUp"):
        at = src.index(f" {name}[")
        out[name] = re.findall(r'"([01]+)"', src[at:src.index("};", at)])
    return out


def fax_span(codes, run, black):
    """One run of a colour: make-up codes of 2560 while more than 2560 are
    left, the make-up code of the rest's multiple of 64 (the colour's own
    to 1728, the shared ones from 1792), then the terminating code of the
    rest below 64."""
    colour = "Black" if black else "White"
    term, make, ext = (codes[f"k{colour}Term"], codes[f"k{colour}MakeUp"],
                       codes["kExtMakeUp"])
    out = []
    while run > 2560:
        out.append(ext[-1])
        run -= 2560
    if run >= 64:
        out.append(make[run // 64 - 1] if run < 1792 else ext[run // 64 - 28])
        run %= 64
    return "".join(out) + term[run]


def fax_row_1d(codes, changes, w):
    """A row of one-dimensional coding (Modified Huffman): its runs from
    the changing elements ``changes`` (the pixels whose colour differs
    from the one before, white before the first), white first."""
    edges = [0, *changes, w]
    return "".join(fax_span(codes, b - a, i % 2)
                   for i, (a, b) in enumerate(zip(edges, edges[1:])))


def fax_row_2d(codes, cur, ref, w):
    """A row of two-dimensional coding (T.4 4.2): the changing elements
    ``cur`` against the reference row's ``ref``, each step pass mode
    where b2 lies before a1, vertical mode where a1 is within 3 of b1,
    else horizontal mode (a0a1 and a1a2 as runs)."""
    import bisect
    cc, rc = cur + [w] * 3, ref + [w] * 3
    out, a0, colour = [], -1, 0
    while a0 < w:
        a1 = cc[bisect.bisect_right(cc, a0)]
        j = bisect.bisect_right(rc, a0)
        j += j % 2 != colour            # b1 of the colour opposite a0's
        b1, b2 = rc[j], rc[j + 1]
        if b2 < a1:
            out.append(FAX_MODES["P"])
            a0 = b2
        elif abs(a1 - b1) <= 3:
            out.append(FAX_MODES[a1 - b1])
            a0, colour = a1, colour ^ 1
        else:
            a2 = cc[min(bisect.bisect_right(cc, a1), len(cc) - 1)]
            out += [FAX_MODES["H"], fax_span(codes, a1 - max(a0, 0), colour),
                    fax_span(codes, a2 - a1, colour ^ 1)]
            a0 = a2
    return "".join(out)


def tiff_fax(np, bits, compression, t4options=0):
    """CCITT coding of [n, w] bits (1 black, as stored) as a strip or
    tile's bytes, first bit first: 2 (Modified Huffman, each row from a
    byte boundary), 3 (Group 3: an EOL before each row, filled with zeros
    to end on a byte boundary where T4Options bit 2 is set; with bit 0 a
    tag bit after it, every fourth row one-dimensional from the first, the
    rest two-dimensional against the row before; RTC last) or 4 (Group 4:
    two-dimensional against the row before, an all-white one first; EOFB
    last)."""
    codes = fax_codes()
    bits = np.asarray(bits)
    w = bits.shape[1]
    twod = compression == 3 and t4options & 1
    out, size, ref = [], 0, []

    def put(code):
        nonlocal size
        out.append(code)
        size += len(code)
    for y, row in enumerate(bits):
        cur = np.flatnonzero(np.diff(row.astype(np.int8), prepend=0)).tolist()
        if compression == 3:
            if t4options & 4:
                put("0" * (-(size + 12) % 8))
            put(FAX_EOL + ("" if not twod else "0" if y % 4 else "1"))
        if compression == 4 or (twod and y % 4):
            put(fax_row_2d(codes, cur, ref, w))
        else:
            put(fax_row_1d(codes, cur, w))
        if compression == 2:
            put("0" * (-size % 8))
        ref = cur
    if compression != 2:
        put((FAX_EOL + ("1" if twod else "")) * (6 if compression == 3 else 2))
    stream = "".join(out) + "0" * (-size % 8)
    return int(stream, 2).to_bytes(len(stream) // 8, "big") if stream else b""


# phase 3e's bilevel TIFFs (``_tiff_fax_bytes`` of ``fax_bits``): name ->
# (compression, T4Options)
FAX_PAGES = {"g4": (4, 0), "g3_2d": (3, 1), "rle": (2, 0)}


def fax_bits(np, img, size=None):
    """An RGB uint8 image thresholded to bits (1 black where its luma is
    below 128), scaled by repeating pixels to ``size`` = (h, w) where
    given (a fine-mode A4 fax page is 2292 x 1728)."""
    luma = img.astype(np.float64) @ np.array([0.299, 0.587, 0.114])
    bits = (luma < 128).astype(np.uint8)
    if size is not None:
        h, w = bits.shape
        bits = np.repeat(np.repeat(bits, -(-size[0] // h), 0),
                         -(-size[1] // w), 1)[:size[0], :size[1]]
    return bits


def _tiff_fax_bytes(np, bits, compression, t4options=0):
    """A little-endian bilevel TIFF of [h, w] bits (1 black), written here
    (``tiff_fax``): one strip, photometric 0 (WhiteIsZero), T4Options for
    Group 3; and the RGB pixels it decodes to, 0 for black and 255 for
    white."""
    h, w = bits.shape
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [1]),
               (259, 3, [compression]), (262, 3, [0]),
               (273, 4, "offsets"), (277, 3, [1]), (278, 4, [h]),
               (279, 4, "counts")]
    if compression == 3:
        entries.append((292, 4, [t4options]))
    white = np.where(np.asarray(bits) != 0, 0, 255).astype(np.uint8)
    return (tiff_file([(entries, [tiff_fax(np, bits, compression,
                                           t4options)])]),
            np.repeat(white[:, :, None], 3, 2))


# times the decode of each file in argv[3:] with the port under argv[1]:
# median of argv[2] calls after one, in ms, null where the port refuses
# it; and the path of the port's imgdec library
_DECODE_TIMES = r"""
import json, os, statistics, sys, time
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
from insenticap_model_tpu_torch import preprocessing as pre
assert pre.__file__.startswith(root + os.sep), pre.__file__
out = {"lib": pre._lib()._name}
for path in sys.argv[3:]:
    data = open(path, "rb").read()
    try:
        pre.load_image_bytes(data)
    except ValueError:
        out[os.path.basename(path)] = None
        continue
    walls = []
    for _ in range(int(sys.argv[2])):
        t0 = time.perf_counter()
        pre.load_image_bytes(data)
        walls.append(time.perf_counter() - t0)
    out[os.path.basename(path)] = statistics.median(walls) * 1e3
print(json.dumps(out))
"""


def decode_ab(roots, calls=200, reps=21):
    """Host decode times of the 448x448 JPEG fixtures (baseline 4:2:0,
    progressive, CMYK), for the port in each of ``roots`` (checkouts of
    the repo: a parent commit unpacked by ``git archive`` into a
    git-ignored directory beside this one, for an A/B on one host), and
    of the baseline one wrapped as a one-strip YCbCr JPEG TIFF. Each
    root's port first decodes the files in a process of its own (its
    imgdec library built; ``path_ms``: the whole path, median of
    ``reps`` after one call, null where that port refuses the file).
    Then both libraries' JPEG entry, ``isc_jpeg_decode``, are timed in
    this one process, the roots in turns call by call (a b, then b a),
    ``calls`` calls each (``entry_ms``: quartiles 1-3; ``wins``: calls
    the second root took less time than the first in the same turn).
    Prints the card's name and power limit, then one JSON line, and
    returns it.

        python3 -c "import chip_smoke; chip_smoke.decode_ab(['../parent', '.'])"
    """
    import ctypes
    import numpy as np
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "data", "torch_images")
    files = [os.path.join(fixtures, name) for name in (
        "j420_448.jpg", "prog420_448.jpg", "cmyk420_448.jpg")]
    report = {"path_ms": {}, "entry_ms": {}, "wins": {}}
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        tif = os.path.join(tmp, "j420_448.tif")
        with open(tif, "wb") as f:
            f.write(_tiff_jpeg_bytes(open(files[0], "rb").read(), 448, 448))
        for root in roots:
            run = subprocess.run(
                [sys.executable, "-c", _DECODE_TIMES, root, str(reps)]
                + files + [tif], capture_output=True, text=True, check=True)
            got = json.loads(run.stdout.strip().splitlines()[-1])
            libs[root] = ctypes.CDLL(got.pop("lib")).isc_jpeg_decode
            report["path_ms"][root] = got
    err = ctypes.create_string_buffer(256)
    for path in files:
        data = open(path, "rb").read()
        outs = {root: np.zeros(448 * 448 * 3, np.uint8) for root in roots}
        walls = {root: [] for root in roots}
        for i in range(calls):
            for root in (roots if i % 2 == 0 else roots[::-1]):
                t0 = time.perf_counter()
                rc = libs[root](data, ctypes.c_longlong(len(data)),
                                ctypes.c_void_p(outs[root].ctypes.data),
                                ctypes.c_longlong(outs[root].size), err,
                                256)
                walls[root].append((time.perf_counter() - t0) * 1e3)
                _check(rc == 0, f"{root}: {err.value!r}")
        _check(all(np.array_equal(outs[roots[0]], o) for o in outs.values()),
               f"the roots decode {os.path.basename(path)} otherwise")
        name = os.path.basename(path)
        for root in roots:
            report["entry_ms"].setdefault(root, {})[name] = \
                statistics.quantiles(walls[root], n=4)
        report["wins"][name] = sum(
            b < a for a, b in zip(walls[roots[0]], walls[roots[-1]]))
    print(f"card: {_smi()}")
    print(json.dumps(report))
    return report

def _serving_surface(torch, np, dev, settings, cap32, det32, cpt32, enc32,
                     words, idx2concept, senti_table, zero_counters,
                     read_counters, keep):
    """Phase 3e: checkpoints written by the port's writer and read back
    bit for bit, the daemon on a real socket in bf16 (feature and image
    mode, the status codes, the drain), the decoders against PIL's arrays,
    the caption command in f32, and the host's decode and resize times.
    Into ``keep`` go what phases 3l and 3m reuse: copies of the RL
    composite, the concept and encoder checkpoints and the sentiment table
    in ``keep["dir"]``, and the feature and image requests with the
    daemon's answers."""
    import shutil
    import base64
    import io
    import tempfile
    import zlib
    from insenticap_model_tpu_torch import preprocessing as pre
    from insenticap_model_tpu_torch.cli import caption as caption_cli
    from insenticap_model_tpu_torch.cli import serve as serve_cli
    from insenticap_model_tpu_torch.training import checkpoint as tck
    out = {}
    cats = ["positive", "negative", "neutral"]
    fixtures = FIXTURE_DIR

    def identical(a, b, path=""):
        if isinstance(a, dict):
            _check(isinstance(b, dict) and set(a) == set(b), f"{path} keys")
            for k in a:
                identical(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            _check(isinstance(b, list) and len(a) == len(b), f"{path} len")
            for i, (x, y) in enumerate(zip(a, b)):
                identical(x, y, f"{path}/{i}")
        else:
            _check(a.dtype == b.dtype and a.shape == b.shape and torch.equal(
                a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                b.view(torch.int16) if b.dtype == torch.bfloat16 else b),
                f"checkpoint leaf {path} differs after the round trip")

    with tempfile.TemporaryDirectory() as tmp:
        # 1. the port's writer, then its reader: every leaf bit-identical
        paths = {k: os.path.join(tmp, k + ".ckpt")
                 for k in ("rl", "concept", "resnet101")}
        t0 = time.time()
        tck.save(paths["rl"], {"captioner": cap32, "senti_detector": det32},
                 None, {"epoch": 0, "settings": settings.to_dict(),
                        "idx2word": words, "sentiment_categories": cats})
        tck.save(paths["concept"], cpt32, None,
                 {"epoch": 0, "settings": settings.to_dict(),
                  "idx2concept": idx2concept})
        tck.save(paths["resnet101"], enc32, None, {"epoch": -1})
        write_s = time.time() - t0
        back_rl, meta = tck.load(paths["rl"], device=dev)
        identical({"captioner": cap32, "senti_detector": det32}, back_rl)
        _check(meta["idx2word"] == words, "idx2word after the round trip")
        identical(cpt32, tck.load(paths["concept"], device=dev)[0])
        identical(enc32, tck.load(paths["resnet101"], device=dev)[0])
        sizes = {k: os.path.getsize(v) for k, v in paths.items()}
        print(f"serving surface: checkpoints written by the port in "
              f"{write_s:.2f} s ({sizes} bytes), read back bit-identical")
        senti_json = os.path.join(tmp, "senti.json")
        with open(senti_json, "w") as f:
            json.dump(senti_table, f)
        for k, path in (("rl", paths["rl"]), ("concept", paths["concept"]),
                        ("resnet101", paths["resnet101"]),
                        ("senti", senti_json)):
            keep[k] = shutil.copy(path, keep["dir"])
        del back_rl
        out["checkpoint_bytes"] = sizes
        out["checkpoint_write_s"] = write_s

        # 2. the daemon on a real socket, bf16, warm; its image root a
        # copy of the fixtures (phase 3m serves it again)
        root = keep["image_root"] = shutil.copytree(
            fixtures, os.path.join(keep["dir"], "images"))
        img448 = pre.load_image_bytes(open(os.path.join(
            fixtures, "j420_448.jpg"), "rb").read())
        a = serve_cli.build_parser().parse_args([
            "--rl_model", paths["rl"], "--concept_model", paths["concept"],
            "--resnet101_ckpt", paths["resnet101"],
            "--sentiment_detector_json", senti_json, "--image_root",
            root, "--compute_dtype", "bfloat16", "--warm", "--host",
            "127.0.0.1", "--port", "0", "--max_wait_ms", "20",
            "--max_body_mb", "16", "--device", str(dev)])
        t0 = time.time()
        srv = serve_cli.make_server(a)
        start_s = time.time() - t0
        port = srv.server_address[1]
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            rng = np.random.default_rng(8)
            feats = [{"fc": rng.random(settings.fc_feat_dim).tolist(),
                      "att": rng.random((14, 14, settings.att_feat_dim))
                      .tolist(), "sentiment": s_}
                     for s_ in ("auto", "negative", "auto", "positive")]
            images = [n for n, w in FIXTURES.items()
                      if w == "decode"]
            # YCbCr TIFFs of the 448x448 JPEG's pixels, written here, one
            # of them beside the fixtures' copy in the image root too
            ycc = {name: _tiff_ycbcr_bytes(np, zlib, img448, *args)
                   for name, args in YCBCR_PAGES.items()}
            with open(os.path.join(root, "ycbcr11_deflate_planar.tif"),
                      "wb") as f:
                f.write(ycc["ycbcr11_deflate_planar"])
            # bilevel TIFFs of its pixels thresholded: Group 4 and Group 3
            # 2D posted, the RLE page beside the fixtures' copy
            fax = {name: _tiff_fax_bytes(np, fax_bits(np, img448), *args)[0]
                   for name, args in FAX_PAGES.items()}
            with open(os.path.join(root, "fax_rle.tif"), "wb") as f:
                f.write(fax["rle"])
            progressive = [n for n in images if n.startswith("prog")]
            # the CMYK, YCCK and Adobe-RGB JPEGs, the Adam7 and 16-bit
            # PNGs, the GIFs, the BMPs, the WebPs and the TIFFs among them
            added = [n for n in images if n.startswith(
                ("cmyk", "ycck", "adobe", "adam7")) or "16" in n
                or n.endswith((".gif", ".bmp", ".webp", ".tif"))]
            _check(all(any(n.endswith(x) for n in images)
                       for x in (".gif", ".bmp", ".webp", ".tif")),
                   "no GIF, BMP, WebP or TIFF among the daemon's image "
                   "requests")
            b64 = {n: base64.b64encode(open(os.path.join(fixtures, n),
                                            "rb").read()).decode()
                   for n in images}
            payloads = feats + [
                {"image_b64": b64[n], "sentiment": ["auto", "neutral"][i % 2]}
                for i, n in enumerate(images)] + [
                {"image_b64": base64.b64encode(v).decode(),
                 "sentiment": ["auto", "negative", "positive"][i]}
                for i, v in enumerate(ycc.values())] + [
                {"image_b64": base64.b64encode(fax[n]).decode(),
                 "sentiment": ["auto", "positive"][i]}
                for i, n in enumerate(("g4", "g3_2d"))] + [
                {"image_path": os.path.join(root, "j420_448.jpg")},
                {"image_path": os.path.join(root, "rgba.png"),
                 "sentiment": "positive"},
                {"image_path": os.path.join(root, "lossless_anim.webp")},
                {"image_path": os.path.join(root, "lossy_rgba.webp"),
                 "sentiment": "negative"},
                {"image_path": os.path.join(root, "rgba_o6.tif")},
                {"image_path": os.path.join(root, "cmyk_tiles.tif"),
                 "sentiment": "positive"},
                {"image_path": os.path.join(root, "rgb_lzw.tif")},
                {"image_path": os.path.join(root, "ycbcr_tiles_jpeg.tif"),
                 "sentiment": "negative"},
                {"image_path": os.path.join(
                    root, "ycbcr11_deflate_planar.tif")},
                {"image_path": os.path.join(root, "fax_rle.tif"),
                 "sentiment": "neutral"}]
            torch.cuda.synchronize()
            zero_counters()
            results, errors, serve_s = _run_groups(
                lambda i: _post(port, payloads[i]), len(payloads),
                (range(4), range(4, len(payloads))))
            launches = read_counters()
            _check(not errors, f"daemon requests failed: {errors}")
            keep["feature_requests"] = feats
            keep["feature_answers"] = [body for _, body in results[:4]]
            keep["image_requests"] = payloads[4:]
            keep["image_answers"] = [body for _, body in results[4:]]
            for (status, body), pl in zip(results, payloads):
                _check(status == 200, f"daemon gave {status}: {body}")
                _check(isinstance(body["caption"], str) and body["caption"],
                       f"empty caption: {body}")
                _check(len(set(body["concepts"])) == K_CONCEPTS
                       and all(c in idx2concept for c in body["concepts"]),
                       f"concepts {body['concepts']}")
                want = pl.get("sentiment", "auto")
                _check(body["sentiment"] in cats and (
                    want == "auto" or body["sentiment"] == want),
                    f"sentiment {body['sentiment']} for {want}")
            for k in ("beam_content_attention", "ceil_maxpool_3x3s2"):
                _check(launches[k] > 0, f"kernel {k} never launched on the "
                       "serving surface")
            status, body = _post(port, {"image_path": os.path.abspath(
                __file__)})
            _check(status == 400 and "outside --image_root" in
                   body["error"], f"path outside the root: {status} {body}")
            # a file that the decoders and PIL both refuse (a 12-bit JPEG)
            # is a 400
            refused = [n for n, w in FIXTURES.items() if w == "refuse"]
            for n in refused:
                status, body = _post(port, {"image_b64": base64.b64encode(
                    open(os.path.join(fixtures, n), "rb").read())
                    .decode()})
                _check(status == 400 and "image_b64" in body["error"],
                       f"{n}: {status} {body}")
            status, body = _post(port, length=17_000_000)
            _check(status == 413, f"oversized body: {status} {body}")
            gets = {p_: _get(port, p_) for p_ in ("/stats", "/metrics",
                                                  "/healthz")}
            for p_, (status, _) in gets.items():
                _check(status == 200, f"GET {p_}: {status}")
            stats = json.loads(gets["/stats"][1])
        finally:
            srv.shutdown()
            srv.server_close()
            srv.app.close()
            th.join(timeout=60)
        _check(not th.is_alive(), "the daemon did not shut down")
        _check(srv.app.batcher._closed and srv.app.enc_batcher._closed,
               "the batchers did not close")
        lat = {"decode": stats["latency_by_bucket"],
               "encode": stats["encode"]["latency_by_bucket"]}
        print(f"serving surface: daemon up in {start_s:.1f} s (warm); "
              f"{len(payloads)} requests ({len(feats)} feature, "
              f"{len(images) + len(ycc)} image_b64, "
              f"{len(payloads) - len(feats) - len(images) - len(ycc)} "
              f"image_path; YCbCr TIFFs {list(ycc)} among the image_b64) in "
              f"{serve_s:.2f} s, "
              f"all 200 (progressive JPEGs {progressive}, and {added} "
              f"among them); 400 outside the root, 400 {refused}, 413 "
              f"oversized; launches {launches}")
        for stage, by in lat.items():
            print(f"  {stage} latency by bucket: " + ", ".join(
                f"{b}: n={v['n']} p50 {v['p50_ms']:.1f} ms p99 "
                f"{v['p99_ms']:.1f} ms" for b, v in by.items()))
        out.update(start_s=start_s, serve_s=serve_s, launches=launches,
                   requests=len(payloads), latency_by_bucket=lat,
                   decode_by_bucket=stats["by_bucket"],
                   encode_by_bucket=stats["encode"]["by_bucket"])

        # 3. the decoders on this host against PIL's committed arrays
        with np.load(os.path.join(fixtures, "expected.npz")) as npz:
            expected = decode_expected(npz)
        for name, what in FIXTURES.items():
            data = open(os.path.join(fixtures, name), "rb").read()
            if what == "refuse":
                try:
                    pre.load_image_bytes(data)
                    _check(False, f"{name} decoded, but must be refused")
                except ValueError:
                    continue
            got = pre.load_image_bytes(data)
            _check(got.shape == expected[name].shape
                   and np.array_equal(got, expected[name]),
                   f"{name} decodes unlike PIL")
        print(f"serving surface: {len(expected)} fixtures decode identical "
              "to PIL's arrays (progressive, CMYK, YCCK, Adobe-RGB JPEG, "
              "Adam7 and 16-bit PNG, interlaced, grey-ramp and offset GIF, "
              "palette, 24-bit, RLE8 and bitfields BMP, lossless WebP "
              "(simple, VP8X, an animation's offset first frame), lossy "
              "WebP (simple, grey, ALPH, an animation's offset first "
              "frame, the simple filter and four partitions, 448x448 at "
              "quality 80 and 100), TIFF (uncompressed, PackBits, Deflate "
              "with predictor 2 and orientation 6, planar big-endian CMYK "
              "tiles, CIELAB, 16-bit BigTIFF, LZW with predictor 2 in "
              "strips, old-style LZW, a float under LZW with predictor 3, "
              "PIL's YCbCr JPEG in strips, 4:2:0 JPEG tiles with "
              "JPEGTables, a CMYK JPEG) "
              "included), "
              f"{[n for n, w in FIXTURES.items() if w == 'refuse']} "
              "refused")

        # 4. the caption command in f32 with the attention dump
        img_args = [os.path.join(fixtures, "j420_448.jpg"),
                    os.path.join(fixtures, "rgb.png"),
                    os.path.join(fixtures, "lossless_rgba.webp"),
                    os.path.join(fixtures, "lossy_rgba.webp"),
                    os.path.join(fixtures, "rgba_o6.tif")]
        cap_out = io.StringIO()
        with contextlib.redirect_stdout(cap_out):
            recs = caption_cli.run(caption_cli.build_parser().parse_args(
                ["-i", *img_args, "--rl_model", paths["rl"],
                 "--concept_model", paths["concept"], "--resnet101_ckpt",
                 paths["resnet101"], "--sentiment_detector_json",
                 senti_json, "--dump_attention",
                 os.path.join(tmp, "att"), "--device", str(dev)]))
        _check(len(recs) == len(img_args), f"caption records {recs}")
        sums_err = 0.0
        for rec in recs:
            _check(rec["caption"] and rec["sentiment"] in cats,
                   f"caption record {rec}")
            with np.load(rec["attention"]) as z:
                cont = z["cont"]
            n_words = len(rec["caption"].split())
            _check(cont.shape == (n_words, 14, 14), f"map {cont.shape}")
            sums_err = max(sums_err, float(np.abs(cont.sum((1, 2)) - 1)
                                           .max()))
        _check(sums_err <= 1e-5, f"attention maps sum to 1 within "
               f"{sums_err}")
        print(f"serving surface: caption (f32) on {len(recs)} images: "
              + "; ".join(f"{r['image']}: {r['sentiment']}, "
                          f"{len(r['caption'].split())} words"
                          for r in recs)
              + f"; attention maps sum to 1 within {sums_err:.2g}")
        out["caption"] = {"records": [{k: v for k, v in r.items()
                                       if k != "attention"} for r in recs],
                          "map_sum_err": sums_err}

    # 5. host times: decode and resize, median of 5; the progressive and
    # CMYK fixtures are the same photo, quality and sampling as the
    # baseline one, the PNGs (plain and Adam7), the 24-bit BMP and the
    # lossless WebP (PIL's, method 4) its decoded pixels, the GIF and the
    # RLE8 BMP those pixels in the 3-3-2 colour cube; the lossy WebPs
    # (PIL's of those pixels at quality 80 and 100) equal to PIL's arrays
    jpeg = open(os.path.join(fixtures, "j420_448.jpg"), "rb").read()
    webp = open(os.path.join(fixtures, "lossless_448.webp"), "rb").read()
    lossy = {q: open(os.path.join(fixtures, name), "rb").read()
             for q, name in ((80, "lossy_448.webp"),
                             (100, "lossy_448_q100.webp"))}
    prog = open(os.path.join(fixtures, "prog420_448.jpg"), "rb").read()
    cmyk = open(os.path.join(fixtures, "cmyk420_448.jpg"), "rb").read()
    img448 = pre.load_image_bytes(jpeg)
    png = _png_bytes(img448, zlib)
    png_i = _png_bytes(img448, zlib, interlace=True)
    gif, gif_px = _gif_bytes(np, img448)
    bmp, _ = _bmp_bytes(np, img448)
    rle, rle_px = _bmp_bytes(np, img448, rle8=True)
    # a lossless WebP of a corner of it written here, without PIL
    own_webp, own_webp_px = _webp_bytes(np, img448[:64, :96] // 32 * 32)
    # TIFFs of its pixels written here: uncompressed, PackBits, LZW and
    # Deflate with predictor 2
    tiffs = {code: _tiff_bytes(np, zlib, img448, code)[0]
             for code in (1, 32773, 5, 8)}
    # and the JPEG itself as a one-strip YCbCr TIFF
    tiffs[7] = _tiff_jpeg_bytes(jpeg, *img448.shape[:2])
    # YCbCr TIFFs of its pixels, which PIL reads through libtiff's RGBA
    # interface
    ycc = {name: _tiff_ycbcr_bytes(np, zlib, img448, *args)
           for name, args in YCBCR_PAGES.items()}
    # bilevel TIFFs of its pixels thresholded, and a fine-mode A4 page of
    # them under Group 4 (2292 x 1728), each with the RGB it decodes to
    fax = {name: _tiff_fax_bytes(np, fax_bits(np, img448), *args)
           for name, args in FAX_PAGES.items()}
    fax["a4_g4"] = _tiff_fax_bytes(np, fax_bits(np, img448, (2292, 1728)),
                                   4)
    img480 = np.random.default_rng(9).integers(0, 256, (480, 640, 3),
                                               dtype=np.uint8)
    bucket = pre.bucket_for_shape(480, 640, pre.DEFAULT_BUCKET_SHAPES)

    def host_ms(fn):
        fn()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls) * 1e3
    cpu = "unknown"
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                cpu = line.split(":", 1)[1].strip()
                break
    times = {"jpeg_448_420_ms": host_ms(lambda: pre.load_image_bytes(jpeg)),
             "jpeg_448_420_progressive_ms": host_ms(
                 lambda: pre.load_image_bytes(prog)),
             "jpeg_448_cmyk_ms": host_ms(lambda: pre.load_image_bytes(cmyk)),
             "png_448_ms": host_ms(lambda: pre.load_image_bytes(png)),
             "png_448_adam7_ms": host_ms(
                 lambda: pre.load_image_bytes(png_i)),
             "gif_448_ms": host_ms(lambda: pre.load_image_bytes(gif)),
             "bmp_448_24bit_ms": host_ms(lambda: pre.load_image_bytes(bmp)),
             "bmp_448_rle8_ms": host_ms(lambda: pre.load_image_bytes(rle)),
             "webp_448_lossless_ms": host_ms(
                 lambda: pre.load_image_bytes(webp)),
             "webp_448_lossy_q80_ms": host_ms(
                 lambda: pre.load_image_bytes(lossy[80])),
             "webp_448_lossy_q100_ms": host_ms(
                 lambda: pre.load_image_bytes(lossy[100])),
             "tiff_448_raw_ms": host_ms(
                 lambda: pre.load_image_bytes(tiffs[1])),
             "tiff_448_packbits_ms": host_ms(
                 lambda: pre.load_image_bytes(tiffs[32773])),
             "tiff_448_deflate_pred2_ms": host_ms(
                 lambda: pre.load_image_bytes(tiffs[8])),
             "tiff_448_lzw_pred2_ms": host_ms(
                 lambda: pre.load_image_bytes(tiffs[5])),
             "tiff_448_jpeg_ms": host_ms(
                 lambda: pre.load_image_bytes(tiffs[7])),
             "tiff_448_ycbcr22_lzw_ms": host_ms(
                 lambda: pre.load_image_bytes(ycc["ycbcr22_lzw"])),
             "tiff_448_ycbcr11_deflate_planar_ms": host_ms(
                 lambda: pre.load_image_bytes(
                     ycc["ycbcr11_deflate_planar"])),
             "tiff_448_ycbcr_jpeg_planar_ms": host_ms(
                 lambda: pre.load_image_bytes(ycc["ycbcr_jpeg_planar"])),
             **{f"tiff_{'' if n == 'a4_g4' else '448_'}{n}_ms": host_ms(
                 lambda v=v: pre.load_image_bytes(v[0]))
                for n, v in fax.items()},
             "resize_480x640_ms": host_ms(
                 lambda: pre.resize_to_bucket(img480, bucket))}
    _check(np.array_equal(pre.load_image_bytes(png), img448)
           and np.array_equal(pre.load_image_bytes(png_i), img448),
           "the PNGs do not decode to their pixels")
    _check(np.array_equal(pre.load_image_bytes(gif), gif_px)
           and np.array_equal(pre.load_image_bytes(bmp), img448)
           and np.array_equal(pre.load_image_bytes(rle), rle_px),
           "the GIF and BMPs do not decode to their pixels")
    _check(np.array_equal(pre.load_image_bytes(webp), img448)
           and np.array_equal(pre.load_image_bytes(own_webp), own_webp_px),
           "the lossless WebPs do not decode to their pixels")
    _check(all(np.array_equal(pre.load_image_bytes(lossy[q]),
                              expected[name]) for q, name in (
                                  (80, "lossy_448.webp"),
                                  (100, "lossy_448_q100.webp"))),
           "the lossy WebPs do not decode to PIL's arrays")
    _check(all(np.array_equal(pre.load_image_bytes(t_), img448)
               for t_ in tiffs.values()),
           "the TIFFs do not decode to their pixels")
    ycc_err = {name: float(np.abs(pre.load_image_bytes(v).astype(np.int64)
                                  - img448).mean())
               for name, v in ycc.items()}
    _check(all(e < 1 for e in ycc_err.values()),
           f"the YCbCr TIFFs decode far from their pixels: {ycc_err}")
    _check(all(np.array_equal(pre.load_image_bytes(v), want)
               for v, want in fax.values()),
           "the bilevel TIFFs do not decode to their thresholded bits")
    card = _smi()
    print(f"serving surface host times (median of 5, host CPU {cpu}, "
          f"{os.cpu_count()} cores, card {card}): decode 448x448 JPEG 4:2:0 "
          f"({len(jpeg)} B) {times['jpeg_448_420_ms']:.2f} ms, progressive "
          f"({len(prog)} B, 10 scans) "
          f"{times['jpeg_448_420_progressive_ms']:.2f} ms, CMYK "
          f"({len(cmyk)} B) {times['jpeg_448_cmyk_ms']:.2f} ms, 448x448 PNG "
          f"({len(png)} B) {times['png_448_ms']:.2f} ms, Adam7 "
          f"({len(png_i)} B) {times['png_448_adam7_ms']:.2f} ms, GIF "
          f"({len(gif)} B) {times['gif_448_ms']:.2f} ms, BMP 24-bit "
          f"({len(bmp)} B) {times['bmp_448_24bit_ms']:.2f} ms, RLE8 "
          f"({len(rle)} B) {times['bmp_448_rle8_ms']:.2f} ms, lossless "
          f"WebP ({len(webp)} B) {times['webp_448_lossless_ms']:.2f} ms, "
          f"resize_to_bucket "
          f"480x640 -> {bucket[0]}x{bucket[1]} "
          f"{times['resize_480x640_ms']:.2f} ms")
    print(f"serving surface host times, lossy WebP (median of 5, card "
          f"{card}): decode 448x448 at quality 80 ({len(lossy[80])} B) "
          f"{times['webp_448_lossy_q80_ms']:.2f} ms, at quality 100 "
          f"({len(lossy[100])} B) {times['webp_448_lossy_q100_ms']:.2f} ms")
    print(f"serving surface host times, TIFF (median of 5, card {card}): "
          f"decode 448x448 uncompressed ({len(tiffs[1])} B) "
          f"{times['tiff_448_raw_ms']:.2f} ms, PackBits "
          f"({len(tiffs[32773])} B) {times['tiff_448_packbits_ms']:.2f} ms, "
          f"Deflate with predictor 2 ({len(tiffs[8])} B) "
          f"{times['tiff_448_deflate_pred2_ms']:.2f} ms, LZW with predictor "
          f"2 ({len(tiffs[5])} B) {times['tiff_448_lzw_pred2_ms']:.2f} ms, "
          f"JPEG 4:2:0 YCbCr in one strip ({len(tiffs[7])} B) "
          f"{times['tiff_448_jpeg_ms']:.2f} ms, "
          f"beside the baseline JPEG's {times['jpeg_448_420_ms']:.2f} ms; "
          f"YCbCr through libtiff's RGBA interface: 2 x 2 under LZW "
          f"({len(ycc['ycbcr22_lzw'])} B) "
          f"{times['tiff_448_ycbcr22_lzw_ms']:.2f} ms, 1 x 1 in separate "
          f"planes under Deflate ({len(ycc['ycbcr11_deflate_planar'])} B) "
          f"{times['tiff_448_ycbcr11_deflate_planar_ms']:.2f} ms and under "
          f"JPEG ({len(ycc['ycbcr_jpeg_planar'])} B) "
          f"{times['tiff_448_ycbcr_jpeg_planar_ms']:.2f} ms (mean error "
          f"against the pixels {ycc_err})")
    print(f"serving surface host times, CCITT TIFF (median of 5, card "
          f"{card}): decode the 448x448 page thresholded under Group 4 "
          f"({len(fax['g4'][0])} B) {times['tiff_448_g4_ms']:.2f} ms, "
          f"Group 3 2D ({len(fax['g3_2d'][0])} B) "
          f"{times['tiff_448_g3_2d_ms']:.2f} ms, RLE "
          f"({len(fax['rle'][0])} B) {times['tiff_448_rle_ms']:.2f} ms, "
          f"a 1728x2292 (A4 fine) Group 4 page "
          f"({len(fax['a4_g4'][0])} B) {times['tiff_a4_g4_ms']:.2f} ms, "
          f"each equal to its bits")
    out["host_times"] = dict(times, cpu=cpu, jpeg_bytes=len(jpeg),
                             progressive_bytes=len(prog),
                             cmyk_bytes=len(cmyk), png_bytes=len(png),
                             png_adam7_bytes=len(png_i),
                             gif_bytes=len(gif), bmp_24bit_bytes=len(bmp),
                             bmp_rle8_bytes=len(rle),
                             webp_lossless_bytes=len(webp),
                             webp_lossy_q80_bytes=len(lossy[80]),
                             webp_lossy_q100_bytes=len(lossy[100]),
                             tiff_bytes={str(k): len(v)
                                         for k, v in tiffs.items()},
                             ycbcr_tiff_bytes={k: len(v)
                                               for k, v in ycc.items()},
                             ycbcr_tiff_mean_error=ycc_err,
                             fax_tiff_bytes={k: len(v[0])
                                             for k, v in fax.items()},
                             card=card)
    return out


def _tree_paths(tree, prefix=()):
    """[(path, tensor)] of a nested dict/list tree, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_paths(tree[k],
                                                            prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _tree_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def _param_diff(a, b):
    """(max |a - b| over the captioner's leaves but the two
    softmax-invariant attention-score biases, max over those two): the
    softmax over positions ignores those biases, so their gradient is zero
    up to rounding and Adam's g / (|g| + eps) makes that rounding an
    update of up to lr a step."""
    pa, pb = _tree_paths(a), _tree_paths(b)
    _check([p for p, _ in pa] == [p for p, _ in pb], "param trees differ")
    rest = inv = 0.0
    for (path, x), (_, y) in zip(pa, pb):
        d = float((x.detach().float().cpu()
                   - y.detach().float().cpu()).abs().max())
        if path in SOFTMAX_INVARIANT:
            inv = max(inv, d)
        else:
            rest = max(rest, d)
    return rest, inv


def _xe_tree(torch, dev, settings, tmp):
    """Phase 3f's tree under ``tmp`` (>= 5 train batches, val with its last
    batch padded, test; the vocabulary padded to VOCAB words) and a seeded
    full-width sentence classifier saved there by the port's writer and
    read back bit-identical -> (words, the classifier, its file)."""
    from insenticap_model_tpu_torch import synthetic
    from insenticap_model_tpu_torch.models import sent_senti_cls as ss_cls
    from insenticap_model_tpu_torch.training import checkpoint as tck
    synthetic.build_tree(tmp, settings, seed=0, n_img=XE_N_IMG)
    synthetic.write_det_concepts(tmp)
    vpath = os.path.join(tmp, "data/captions/coco/part/idx2word.json")
    with open(vpath) as f:
        words = json.load(f)
    words += [f"w{i}" for i in range(len(words), VOCAB)]
    with open(vpath, "w") as f:
        json.dump(words, f)
    cls = ss_cls.init_params(torch.Generator().manual_seed(5), VOCAB,
                             NUM_CATS, settings, device=dev)
    cls_file = os.path.join(tmp, "cls.ckpt")
    tck.save(cls_file, cls, None, {
        "settings": settings.to_dict(), "idx2word": words,
        "sentiment_categories": ["positive", "negative", "neutral"],
        "dataset_name": "coco", "corpus_type": "part"})
    back, _ = tck.load(cls_file, device=dev)
    _check([p for p, _ in _tree_paths(back)]
           == [p for p, _ in _tree_paths(cls)] and all(
               torch.equal(a, b) for (_, a), (_, b) in
               zip(_tree_paths(back), _tree_paths(cls))),
           "the classifier checkpoint did not read back bit-identical")
    return words, cls, cls_file


def _xe_opts(settings, tmp, cls_file, name, **kw):
    """Phase 3f's train_xe options for a run ``name`` on the tree at
    ``tmp``, the classifier copied under its checkpoint root."""
    import shutil
    from insenticap_model_tpu_torch.config import Opts
    ck = os.path.join(tmp, "ck_" + name)
    d = os.path.join(ck, "sent_senti_cls", "coco", "part")
    os.makedirs(d)
    shutil.copy(cls_file, os.path.join(d, "model-best.ckpt"))
    return Opts(**dict(dict(
        settings=settings, xe_bs=XE_BS, beam_size=BEAM, max_seq_len=T,
        seed=0, scheduled_sampling_increase_every=1,
        captions_dir=os.path.join(tmp, "data/captions"),
        feats_dir=os.path.join(tmp, "data/features"), checkpoint=ck,
        result_dir=os.path.join(tmp, "res_" + name)), **kw))


def _train_xe(torch, np, dev, settings, cap_t, zero_counters,
              read_counters, keep):
    """Phase 3f: the XE pre-training stage through ``cli.train_xe.train``
    at full width on a synthetic tree: two f32 epochs, the epoch-0
    checkpoint read back bit for bit, a resume from it against the
    uninterrupted run, one f32 step on the card against the same step on
    the CPU, one bf16 epoch, and the step and dump times. ``keep`` gets,
    for phase 3j, the epoch-0 params, optimizer state, metrics and dump of
    the f32 run and the first train and seq2seq batches."""
    import dataclasses
    import tempfile
    from insenticap_model_tpu_torch import inference, nn
    from insenticap_model_tpu_torch.cli import common
    from insenticap_model_tpu_torch.cli import train_xe
    from insenticap_model_tpu_torch.config import Opts
    from insenticap_model_tpu_torch.data import feature_store as tfs
    from insenticap_model_tpu_torch.models import captioner as cap
    from insenticap_model_tpu_torch.ops import fused_attention as fa
    from insenticap_model_tpu_torch.training import checkpoint as tck
    from insenticap_model_tpu_torch.training import optim, steps
    from insenticap_model_tpu_torch.utils.profiling import (StepTimer,
                                                            annotate,
                                                            maybe_trace)
    from insenticap_model_tpu_torch.utils.timing import device_ms_by_kernel
    from insenticap_model_tpu_torch.vocab import Vocab
    cats = ["positive", "negative", "neutral"]
    out = {}
    saved, step_losses = {}, []
    timer = {}          # "t": the StepTimer of the two f32 epochs' steps
    orig_save, orig_make = tck.save, steps.make_xe_steps

    def recording_save(path, params, opt_state, metadata):
        """The trees each checkpoint was given, kept on the host."""
        saved[os.path.basename(path)] = (
            nn.tree_map(lambda x: x.detach().cpu().clone(), params),
            opt_state)
        orig_save(path, params, opt_state, metadata)

    def recording_make(settings_, adam):
        """make_xe_steps whose train step also records its losses, each
        step timed by ``timer["t"]`` where one is set."""
        train_step, eval_step = orig_make(settings_, adam)

        def step(*args):
            t = timer.get("t")
            if t is None:
                losses = train_step(*args)
            else:
                with t.step(len(step_losses), items=XE_BS):
                    losses = t.sink(train_step(*args))
            step_losses.append({k: float(v) for k, v in losses.items()})
            return losses
        return step, eval_step

    def dump_trained(params, feats, tag, ids):
        """The dump's decode (mode xe, bs 20, beam 3) with the trained
        captioner on XE_CMP_BATCHES batches of standard-normal features,
        against the plain path: in f32 every top beam identical, scores
        within 1e-3; in bf16 phase 4's gate, the share of identical top
        beams at least v1 with tanhf's, rounded down to a whole percent."""
        g = torch.Generator(device=dev).manual_seed(6)
        runs = {"kernel": [], "plain": [], "tanhf": []}
        for _ in range(XE_CMP_BATCHES):
            fc, att = (torch.randn(feats[k].shape, generator=g, device=dev)
                       .to(feats[k].dtype) for k in ("fc", "att"))

            def dec(**kw):
                return inference.decode_xe(
                    params, fc, att, settings=settings, ids=ids,
                    beam_size=BEAM, max_seq_len=T, **kw)
            runs["kernel"].append(dec())
            runs["plain"].append(dec(use_kernels=False))
            with _v1_exact_tanh(fa):
                runs["tanhf"].append(dec())
        ks, ksc, ps, psc, ts, tsc = (
            torch.cat([r[i] for r in runs[k]]) for k in
            ("kernel", "plain", "tanhf") for i in (0, 1))
        eq, dscore = _top_beams_vs_plain(ks, ksc, ps, psc)
        eq_t, _ = _top_beams_vs_plain(ts, tsc, ps, psc)
        share, share_t = float(eq.float().mean()), float(eq_t.float().mean())
        gate = 1.0 if tag == "f32" else \
            math.floor(100 * share_t + 1e-9) / 100
        res = {"images": int(eq.numel()), "top_beam_identical": share,
               "top_beam_identical_tanhf": share_t,
               "max_score_diff": dscore, "gate": gate}
        _check(share >= gate and (tag != "f32" or dscore <= 1e-3),
               f"train_xe {tag} trained dump against the plain path: {res}")
        return res

    with tempfile.TemporaryDirectory() as tmp:
        # 1. the tree: >= 5 train batches, val (its last batch padded) and
        # test; the vocabulary padded to VOCAB words; 2. a seeded
        # full-width sentence classifier through the port's writer and
        # reader
        t0 = time.time()
        words, cls, cls_file = _xe_tree(torch, dev, settings, tmp)
        out["tree_s"] = time.time() - t0

        def opts(name, **kw):
            return _xe_opts(settings, tmp, cls_file, name,
                            **dict(dict(device=str(dev)), **kw))

        def stage(o, *parts):
            return os.path.join(o.checkpoint, "xe", "coco", "part", *parts)

        tck.save, steps.make_xe_steps = recording_save, recording_make
        try:
            # 3. two f32 epochs at the default dropout; epoch 1's ss_prob
            # 0.05. No training step reaches a kernel, so v1's count, set
            # to 0 here, counts the two epochs' beam dumps
            o32 = opts("f32", xe_epochs=2)
            timer_log = os.path.join(tmp, "step_timer.jsonl")
            timer["t"] = StepTimer(log_path=timer_log)
            zero_counters()
            t0 = time.time()
            full = train_xe.train(o32)
            torch.cuda.synchronize()
            out["f32_two_epochs_s"] = time.time() - t0
            timer.clear()
            out["launches"] = read_counters()
            metrics = [json.loads(x) for x in open(stage(o32,
                                                         "metrics.jsonl"))]
            f32_steps = [s["all_loss"] for s in step_losses]
            # the StepTimer's JSONL: one record a step, in order
            recs = [json.loads(x) for x in open(timer_log)]
            _check([r["step"] for r in recs] == list(range(len(f32_steps)))
                   and all(r["step_time_s"] > 0 and r["items_per_s"] > 0
                           for r in recs),
                   f"StepTimer: {len(recs)} records for {len(f32_steps)} "
                   f"steps: {recs[:3]}")
            out["step_timer"] = {
                "records": len(recs), "steps": len(f32_steps),
                "median_step_ms": statistics.median(
                    r["step_time_s"] for r in recs) * 1e3}
            _check(len(metrics) == 2 and all(
                math.isfinite(v) for m in metrics for v in m.values()
                if isinstance(v, float)) and all(
                    math.isfinite(v) for s in step_losses
                    for v in s.values()), f"non-finite losses {metrics}")
            _check(metrics[1]["ss_prob"] == 0.05, "epoch 1's ss_prob")
            _check(metrics[1]["train_xe_loss"] < metrics[0]["train_xe_loss"],
                   "epoch 1's train XE loss is not below epoch 0's: "
                   f"{metrics}")
            res0 = json.load(open(os.path.join(
                o32.result_dir, "xe", "coco", "part", "result_0.json")))
            _check(len(res0) == XE_N_IMG["test"] and len(
                {r["image_id"] for r in res0}) == XE_N_IMG["test"] and all(
                    isinstance(r["caption"], str) for r in res0),
                   f"result_0.json: {len(res0)} captions")
            _check(out["launches"]["beam_content_attention"] > 0,
                   f"no v1 launch in the beam dumps: {out['launches']}")
            out["dump_mean_words"] = [float(np.mean([
                len(r["caption"].split()) for r in json.load(open(
                    os.path.join(o32.result_dir, "xe", "coco", "part",
                                 f"result_{e}.json")))])) for e in (0, 1)]

            # 4. the epoch-0 checkpoint, with its optimizer state, reads
            # back bit-identical to what was saved
            [name0] = [k for k in saved if k.startswith("model_0_")]
            p_back, s_back, meta0 = tck.load(stage(o32, name0), device=dev,
                                             with_opt_state=True)
            p_saved, s_saved = saved[name0]
            for tree_a, tree_b, what in ((p_back, p_saved, "params"),
                                         (s_back, s_saved, "opt_state")):
                pa, pb = _tree_paths(tree_a), _tree_paths(tree_b)
                _check([p for p, _ in pa] == [p for p, _ in pb] and all(
                    a.dtype == b.dtype and torch.equal(a.cpu(), b)
                    for (_, a), (_, b) in zip(pa, pb)),
                    f"epoch-0 {what} did not read back bit-identical")
            _check(int(s_back["count"]) == len(f32_steps) // 2
                   and meta0["epoch"] == 0, "epoch-0 step count")
            keep["epoch0"] = {
                "params": p_saved, "opt_state": s_saved,
                "metrics": metrics[0], "steps": f32_steps[:len(f32_steps)
                                                         // 2],
                "result_0": res0}

            # 5. --xe_resume from it: epoch 1 again, against the
            # uninterrupted run (the same batches and draws)
            t0 = time.time()
            resumed = train_xe.train(opts("resume", xe_epochs=2,
                                          xe_resume=stage(o32, name0)))
            torch.cuda.synchronize()
            out["resume_epoch_s"] = time.time() - t0
            steps1 = len(f32_steps) // 2
            rest, inv = _param_diff(resumed, full)
            out["resume_max_abs_diff"] = {"params": rest,
                                          "softmax_invariant_biases": inv}
            _check(rest <= 1e-5 and inv <= XE_LR * steps1,
                   f"resumed params differ from the uninterrupted run's: "
                   f"{rest} (tolerance 1e-5), biases {inv} (tolerance "
                   f"{XE_LR * steps1})")

            # 7. one bf16 epoch: finite losses that fall over its steps
            step_losses.clear()
            t0 = time.time()
            train_xe.train(opts("bf16", xe_epochs=1,
                                compute_dtype="bfloat16"))
            torch.cuda.synchronize()
            out["bf16_epoch_s"] = time.time() - t0
            bf16_steps = [s["all_loss"] for s in step_losses]
            _check(all(math.isfinite(v) for s in step_losses
                       for v in s.values())
                   and bf16_steps[-1] < bf16_steps[0],
                   f"bf16 epoch losses {bf16_steps}")
        finally:
            tck.save, steps.make_xe_steps = orig_save, orig_make
        out.update(metrics_f32=metrics, step_all_loss_f32=f32_steps,
                   step_all_loss_bf16=bf16_steps)

        # 6. one deterministic f32 step (dropout off, ss_prob 0) on the card
        # and on the CPU from the same weights and the tree's first batch
        o = opts("inputs")
        vocab = Vocab(words)
        caps_id = common.tokenize_captions(common.load_json(
            common.dataset_path(o, "img_captions.json")), vocab)
        cpts_id = common.tokenize_concepts(common.load_json(
            common.dataset_path(o, "img_det_concepts.json")), vocab)
        scs_id = common.tokenize_senti_corpus(common.load_json(
            common.corpus_path(o, "senti_captions.json")), vocab, cats)
        fc_s, att_s = (common.open_store(p) for p in common.feature_paths(o))
        loader = common.caption_loader(fc_s, att_s, caps_id["train"],
                                       cpts_id, vocab, o, XE_BS)
        batch = loader.assemble(loader._index_batches()[0])
        scs_loader = common.scs_loader(scs_id, vocab, o, train_xe.SCS_BS)
        scs_b = scs_loader.assemble(scs_loader._index_batches()[0])
        keep["batch"], keep["scs"] = (
            {k: v for k, v in b_.items() if k not in common.HOST_KEYS}
            for b_ in (batch, scs_b))
        nodrop = dataclasses.replace(settings, dropout_p=0.0)

        class RecordingAdam(optim.Adam):
            """Adam that keeps, on the host, the gradients it steps on."""
            def step(self):
                self.grads = [(path, torch.zeros(p.shape) if p.grad is None
                               else p.grad.detach().float().cpu())
                              for path, p in _tree_paths(self.params)]
                super().step()

        def one_step(device):
            params = nn.tree_map(
                lambda x: x.requires_grad_(True),
                cap.init_params(torch.Generator().manual_seed(3), VOCAB,
                                NUM_CATS, nodrop, device=device))
            adam = RecordingAdam(params, XE_LR)
            train_step, _ = steps.make_xe_steps(nodrop, adam)
            rt = common.Runtime(Opts(device=str(device)))
            with nn.exact_numerics():
                losses = train_step(
                    nn.tree_map(lambda x: x.to(device), cls),
                    rt.put(batch), rt.put(scs_b),
                    torch.Generator(device=device).manual_seed(0), 0.0)
            return ({k: float(v) for k, v in losses.items()},
                    nn.tree_map(lambda x: x.detach().cpu(), params),
                    adam.grads)
        t0 = time.time()
        l_card, p_card, g_card = one_step(dev)
        l_cpu, p_cpu, g_cpu = one_step(torch.device("cpu"))
        out["cpu_step_s"] = time.time() - t0
        loss_rel = max(abs(l_card[k] - l_cpu[k]) / abs(l_cpu[k])
                       for k in l_cpu)
        # Adam's first update is about lr * sign(g), so the params hold the
        # gradients' signs only: their sizes are held here, leaf by leaf
        grad_rel = {}
        for (path, gc), (_, gp) in zip(g_card, g_cpu):
            if path in SOFTMAX_INVARIANT:
                continue
            norm = float(gp.norm())
            grad_rel["/".join(path)] = (
                float((gc - gp).norm()) / norm if norm
                else (0.0 if torch.equal(gc, gp) else math.inf))
        worst = max(grad_rel, key=grad_rel.get)
        rest, inv = _param_diff(p_card, p_cpu)
        out["card_vs_cpu"] = {"losses_card": l_card, "losses_cpu": l_cpu,
                              "loss_max_rel": loss_rel,
                              "grad_max_rel": grad_rel[worst],
                              "grad_max_rel_leaf": worst,
                              "params_max_abs": rest,
                              "softmax_invariant_biases_max_abs": inv}
        _check(loss_rel <= 1e-5, f"card step losses {l_card} against the "
               f"CPU's {l_cpu}: {loss_rel} relative (tolerance 1e-5)")
        _check(grad_rel[worst] <= XE_GRAD_RTOL,
               f"card step gradient of {worst} differs from the CPU's by "
               f"{grad_rel[worst]} of its norm (tolerance {XE_GRAD_RTOL})")
        _check(rest <= 1e-5 and inv <= XE_LR,
               f"card step params differ from the CPU's by {rest} "
               f"(tolerance 1e-5), biases {inv} (tolerance {XE_LR})")

        # 8. ms per XE train step (bs 20 + the seq2seq batch of 80, the
        # default dropout, ss_prob 0), median of 5 after one warm-up, and
        # the beam dump's captions/s at bs 20, beam 3 (host clock around
        # synchronised calls)
        def wall_ms(fn, runs=5):
            fn()
            torch.cuda.synchronize()
            walls = []
            for _ in range(runs):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            return statistics.median(walls) * 1e3
        test_fns = sorted(caps_id["test"])[:XE_BS]
        ids = cap.TokenIds(pad=0, unk=1, sos=2, eos=3, neutral=2)
        timing = {}
        for tag, cdt in (("f32", "float32"), ("bf16", "bfloat16")):
            rt = common.Runtime(Opts(device=str(dev), compute_dtype=cdt))
            params = nn.tree_map(
                lambda x: x.requires_grad_(True),
                rt.cast(cap.init_params(torch.Generator().manual_seed(3),
                                        VOCAB, NUM_CATS, settings,
                                        device=dev)))
            # the dump on the random weights, before the timed steps
            # train them: random weights end no caption early (a few
            # steps of training make EOS the first word of every caption)
            frozen = nn.tree_map(lambda x: x.detach().clone(), params)
            train_step, _ = steps.make_xe_steps(
                settings, optim.Adam(params, XE_LR))
            b, s, c = rt.put(batch), rt.put(scs_b), rt.cast(cls)
            gen = torch.Generator(device=dev).manual_seed(0)
            step_ms = wall_ms(lambda: train_step(c, b, s, gen, 0.0))
            # the profiler's device time of a step, by kernel: the busy
            # share of the host-clock step
            by_kernel = device_ms_by_kernel(
                lambda: train_step(c, b, s, gen, 0.0), iters=5, warm=1)
            busy = sum(by_kernel.values())
            if tag == "f32":
                out["trace"] = _trace_xe_step(
                    os.path.join(tmp, "trace"), rt, loader, train_step,
                    lambda b_: (c, b_, s, gen, 0.0), maybe_trace, annotate)
            feats = rt.put({"fc": fc_s.batch(test_fns),
                            "att": att_s.batch(test_fns)})
            with torch.no_grad():
                def dump(use_kernels=True):
                    return inference.decode_xe(
                        frozen, feats["fc"], feats["att"], settings=settings,
                        ids=ids, beam_size=BEAM, max_seq_len=T,
                        use_kernels=use_kernels)
                dump_ms = wall_ms(dump)
                fa.beam_content_attention.launches = 0   # a v1 call a step
                seqs, scores = dump()
                dump_steps = fa.beam_content_attention.launches
                eq, dscore = _top_beams_vs_plain(
                    seqs, scores, *dump(use_kernels=False))
                _check(bool((seqs[:, 0, 0] != ids.eos).all()),
                       f"train_xe {tag} dump: an empty top-beam caption")
                vs_plain = {"random_weights": {
                    "top_beam_identical": float(eq.float().mean()),
                    "max_score_diff": dscore}}
                if tag == "f32":
                    _check(bool(eq.all()) and dscore <= 1e-3,
                           f"train_xe f32 dump: top beams identical to "
                           f"the plain path's on {vs_plain}")
                vs_plain["trained"] = dump_trained(
                    rt.cast(nn.tree_map(lambda x: x.float(), cap_t)),
                    feats, tag, ids)
            timing[tag] = {
                "train_step_ms": step_ms, "device_ms": busy,
                "idle_share": max(0.0, 1.0 - busy / step_ms),
                "top_kernels_ms": dict(sorted(
                    by_kernel.items(), key=lambda kv: -kv[1])[:6]),
                "dump_ms": dump_ms, "dump_steps": dump_steps,
                "dump_captions_per_s": XE_BS / dump_ms * 1e3,
                "dump_vs_plain": vs_plain}
        out["timing"] = timing

        # 9. the XE batch's att gather (the first train batch's 20 images)
        # both ways, on the tree's store rewritten in fp16 (as the feature
        # extraction writes it; widened to f32) and on the f32 store itself
        f16_path = os.path.join(tmp, "coco_att_f16.isc")
        tfs.write_native_store(
            f16_path, ((fn, att_s.get(fn)) for fn in att_s.keys()),
            att_s.shape, dtype="float16")
        out["gather"] = _gather_both_ways(
            np, tfs, {"fp16": f16_path, "f32": att_s.path},
            list(batch["fns"]), timing["f32"]["train_step_ms"])
    smi = _smi()
    print(f"train_xe (phase 3f, full width, vocab {VOCAB}, xe_bs {XE_BS}, "
          f"seq2seq {train_xe.SCS_BS}): tree {out['tree_s']:.1f} s; two f32 "
          f"epochs {out['f32_two_epochs_s']:.1f} s ({len(f32_steps)} steps), "
          "train/val all_loss by epoch " + ", ".join(
              f"{m['train_all_loss']:.4f}/{m['val_all_loss']:.4f}"
              for m in metrics) + f"; v1 launches in the dumps "
          f"{out['launches']['beam_content_attention']} (mean caption words "
          f"by epoch {out['dump_mean_words']}); resumed epoch 1 "
          f"{out['resume_epoch_s']:.1f} s, max |diff| "
          f"{out['resume_max_abs_diff']['params']:.3g} (biases "
          f"{out['resume_max_abs_diff']['softmax_invariant_biases']:.3g}); "
          f"bf16 epoch {out['bf16_epoch_s']:.1f} s, step all_loss "
          + " ".join(f"{v:.4f}" for v in bf16_steps))
    st, ga, tr = out["step_timer"], out["gather"], out["trace"]
    print(f"train_xe StepTimer over the two f32 epochs' steps on {smi}: "
          f"{st['records']} records for {st['steps']} steps, median "
          f"step_time_s {st['median_step_ms']:.2f} ms (the phase's timed "
          f"f32 step, median of 5: {timing['f32']['train_step_ms']:.2f} "
          "ms)")
    for kind in ("fp16", "f32"):
        g_ = ga[kind]
        print(f"train_xe att gather ({kind} store, {g_['records']} records "
              f"of 14x14x{settings.att_feat_dim}, "
              f"{g_['bytes_read'] / 1e6:.1f} MB read, "
              f"{g_['bytes_written'] / 1e6:.1f} MB written; median of "
              f"{GATHER_RUNS} in turns, page cache warm) on {smi}: native "
              f"{g_['native_ms']:.3f} ms, numpy {g_['numpy_ms']:.3f} ms, "
              f"arrays identical; share of the f32 XE step "
              f"({timing['f32']['train_step_ms']:.2f} ms): native "
              f"{g_['native_share']:.2%}, numpy {g_['numpy_share']:.2%}")
    print(f"train_xe trace of one f32 step (maybe_trace): "
          f"{tr['file_mb']:.1f} MB, {tr['kernel_events']} kernel events, "
          "spans " + ", ".join(f"{k} {v:.3f} ms"
                               for k, v in tr["spans_ms"].items()))
    cv = out["card_vs_cpu"]
    print(f"train_xe card step against the CPU's (f32, dropout off): loss "
          f"{cv['losses_card']['all_loss']:.6f} vs "
          f"{cv['losses_cpu']['all_loss']:.6f}, max rel "
          f"{cv['loss_max_rel']:.3g}; gradients max |diff|/|CPU's| "
          f"{cv['grad_max_rel']:.3g} ({cv['grad_max_rel_leaf']}, tolerance "
          f"{XE_GRAD_RTOL}); params max |diff| "
          f"{cv['params_max_abs']:.3g} (biases "
          f"{cv['softmax_invariant_biases_max_abs']:.3g})")
    for tag, r in timing.items():
        print(f"train_xe {tag} on {smi}: {r['train_step_ms']:.2f} ms a train "
              f"step (median of 5; device {r['device_ms']:.2f} ms, idle "
              f"share {r['idle_share']:.3f}; largest: " + ", ".join(
                  f"{k[:40]} {v:.3f}" for k, v in
                  list(r["top_kernels_ms"].items())[:3])
              + f"), beam dump {r['dump_ms']:.2f} ms a batch of {XE_BS} "
              f"({r['dump_steps']} steps, random weights) -> "
              f"{r['dump_captions_per_s']:.1f} captions/s")
        vr, vt = r["dump_vs_plain"]["random_weights"], \
            r["dump_vs_plain"]["trained"]
        print(f"train_xe {tag} dump against the plain path, top beams "
              f"identical: random weights {vr['top_beam_identical']:.2%} of "
              f"{XE_BS} (score diff {vr['max_score_diff']:.3g}); trained "
              f"{vt['top_beam_identical']:.2%} of {vt['images']} (v1 tanhf "
              f"{vt['top_beam_identical_tanhf']:.2%}, gate {vt['gate']:.2f},"
              f" score diff {vt['max_score_diff']:.3g})")
    out["device"] = smi
    return out


def _trace_xe_step(trace_dir, rt, loader, train_step, args, maybe_trace,
                   annotate):
    """One f32 XE step under ``maybe_trace``, its batch's gather and its
    step inside ``annotate`` spans; the trace file must exist and hold both
    spans and at least one kernel of the card."""
    with maybe_trace(trace_dir):
        with annotate("xe_gather"):
            b = rt.put(loader.assemble(loader._index_batches()[0]))
        with annotate("xe_train_step"):
            train_step(*args(b))
    files = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)
             if f.endswith(".pt.trace.json")] if os.path.isdir(
                 trace_dir) else []
    _check(len(files) == 1, f"maybe_trace wrote {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: e.get("dur", 0) / 1e3 for e in events
             if e.get("cat") == "user_annotation"}
    kernels = sum(e.get("cat") == "kernel" for e in events)
    _check({"xe_gather", "xe_train_step"} <= set(spans) and kernels > 0,
           f"the trace holds spans {sorted(spans)} and {kernels} kernel "
           "events")
    return {"file_mb": os.path.getsize(files[0]) / 1e6,
            "kernel_events": kernels, "spans_ms": spans}


def _gather_both_ways(np, tfs, paths, fns, step_ms):
    """The batch's gather from each store of ``paths`` ({kind: path})
    through the native and the numpy reader: the arrays must be bit for bit
    identical; the medians of ``GATHER_RUNS`` times each, taken in turns,
    and their shares of ``step_ms``."""
    out = {}
    for kind, path in paths.items():
        readers = {r: tfs.NativeFeatureStore(path, reader=r)
                   for r in ("native", "numpy")}
        a, b = (readers[r].batch(fns) for r in ("native", "numpy"))
        _check(a.dtype == b.dtype == np.float32 and a.shape == b.shape
               and np.array_equal(a.view(np.uint32), b.view(np.uint32)),
               f"{kind} store: the native gather differs from numpy's")
        walls = {r: [] for r in readers}
        for _ in range(GATHER_RUNS):
            for r, st in readers.items():
                t0 = time.perf_counter()
                st.batch(fns)
                walls[r].append(time.perf_counter() - t0)
        res = {"records": len(fns), "bytes_written": a.nbytes,
               "bytes_read": a[0].size * len(fns)
               * readers["native"].dtype.itemsize}
        for name, w in walls.items():
            res[f"{name}_ms"] = statistics.median(w) * 1e3
            res[f"{name}_share"] = res[f"{name}_ms"] / step_ms
            res[f"{name}_all_ms"] = [x * 1e3 for x in w]
        for st in readers.values():
            st.close()
        out[kind] = res
    return out


def _recording_adam(torch, optim):
    """Adam that keeps, on the host, the gradients it steps on, in
    ``_tree_paths`` order (float32 copies, float64 for a float64 leaf;
    zeros for a leaf without a gradient)."""
    class RecordingAdam(optim.Adam):
        def step(self):
            self.grads = [
                torch.zeros(p.shape) if p.grad is None else
                p.grad.detach().cpu().to(
                    torch.float64 if p.grad.dtype == torch.float64
                    else torch.float32, copy=True)
                for _, p in _tree_paths(self.params)]
            super().step()
    return RecordingAdam


def _dp_steps(torch, np, dev, inputs, settings):
    """Phase 3j(b)'s work on this process's rank (the whole batch where
    there is no process group): the full-width f32 XE step (the default
    dropout, ss_prob 0) on its rows of phase 3f's first train and seq2seq
    batches, then DP_TIMED_STEPS more steps, each timed between barriers;
    then the bf16 detector's train step and its eval step (two forwards
    through the Winograd kernels, their launch counts set to 0 just
    before and read just after) on its rows of a seeded HEAD_BS batch.
    Every rank seeds alike; the params are broadcast from rank 0
    (``mesh.replicate``); the gradients recorded are those Adam steps on."""
    from insenticap_model_tpu_torch import nn
    from insenticap_model_tpu_torch.models import captioner as cap
    from insenticap_model_tpu_torch.models import sent_senti_cls as ss_cls
    from insenticap_model_tpu_torch.models import sentiment_detector as sd
    from insenticap_model_tpu_torch.ops import winograd_kernels as wk
    from insenticap_model_tpu_torch.parallel import mesh
    from insenticap_model_tpu_torch.training import optim, steps

    RecordingAdam = _recording_adam(torch, optim)
    rank, world = mesh.rank(), mesh.world_size()

    def rows(batch, n):
        sl = mesh.shard_rows(n, rank, world)
        return {k: torch.from_numpy(np.ascontiguousarray(v[sl])).to(dev)
                for k, v in batch.items() if k != "valid"}

    def record(adam, params):
        return {"grads": adam.grads,
                "paths": [q for q, _ in _tree_paths(params)],
                "params": [p.detach().float().cpu().clone()
                           for _, p in _tree_paths(params)]}

    wino = (wk.wino_input, wk.wino_middle, wk.wino_output)
    out = {"rank": rank, "world": world}
    with nn.exact_numerics():
        params = nn.tree_map(
            lambda x: x.requires_grad_(True),
            mesh.replicate(cap.init_params(torch.Generator().manual_seed(3),
                                           VOCAB, NUM_CATS, settings,
                                           device=dev)))
        cls = mesh.replicate(ss_cls.init_params(
            torch.Generator().manual_seed(5), VOCAB, NUM_CATS, settings,
            device=dev))
        adam = RecordingAdam(params, XE_LR)
        train_step, _ = steps.make_xe_steps(settings, adam)
        b = rows(inputs["batch"], len(inputs["batch"]["caps"]))
        s = rows(inputs["scs"], len(inputs["scs"]["caps"]))
        losses = train_step(cls, b, s, torch.Generator(
            device=dev).manual_seed(0), 0.0)
        out["xe"] = dict(record(adam, params), losses={
            k: float(v) for k, v in losses.items()})
        walls = []
        sync = torch.cuda.synchronize if dev.type == "cuda" else (
            lambda: None)
        for i in range(DP_TIMED_STEPS):
            mesh.barrier()
            sync()
            t0 = time.perf_counter()
            train_step(cls, b, s, torch.Generator(device=dev).manual_seed(
                1 + i), 0.0)
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        out["xe"]["step_ms"] = walls
        # the gradient's all-reduce alone (the identity with one rank)
        walls = []
        for _ in range(DP_TIMED_STEPS):
            mesh.barrier()
            sync()
            t0 = time.perf_counter()
            mesh.reduce_gradients(params)
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        out["xe"]["allreduce_ms"] = walls
        out["xe"]["grad_bytes"] = 4 * sum(p.numel() for _, p in
                                          _tree_paths(params))

        det = nn.tree_map(
            lambda x: x.to(torch.bfloat16).requires_grad_(True),
            mesh.replicate(sd.init_params(torch.Generator().manual_seed(7),
                                          NUM_CATS, settings, device=dev)))
        adam = RecordingAdam(det, HEAD_LR)
        train_step, eval_step = steps.make_senti_steps(settings, adam)
        g = torch.Generator().manual_seed(8)
        batch = {"att": torch.randn((HEAD_BS, 14, 14, settings.att_feat_dim),
                                    generator=g).numpy(),
                 "labels": torch.randint(0, NUM_CATS, (HEAD_BS,),
                                         generator=g).int().numpy()}
        b = rows(batch, HEAD_BS)
        b["att"] = b["att"].to(torch.bfloat16)
        loss = train_step(b, torch.Generator(device=dev).manual_seed(0))
        for c in wino:
            c.launches = 0
        eval_sum, eval_rows, labels = eval_step(b)
        out["senti"] = dict(
            record(adam, det), loss=float(loss), eval_sum=float(eval_sum),
            eval_rows=float(eval_rows), labels=labels.cpu(),
            launches=[c.launches for c in wino])
    return out


def _dp_rank(work, rank, world, pg_file, inputs_path, out_path, device,
             settings_dict):
    """A rank of phase 3j(b), 3k(b) or 3n in a process of its own, every
    rank on the one card ``device``: joins the gloo group through
    ``pg_file``, runs ``work`` (``_dp_steps``, ``_rl_dp_steps``,
    ``_tp_cli`` or ``_tp_steps``) on the inputs at ``inputs_path`` and
    saves its record to ``out_path``."""
    import numpy as np
    import torch
    from insenticap_model_tpu_torch.config import Settings
    from insenticap_model_tpu_torch.parallel import mesh
    mesh.init(world, rank, "gloo", "file://" + pg_file,
              timeout_s=DP_TIMEOUT_S)
    try:
        out = work(torch, np, torch.device(device),
                   torch.load(inputs_path, weights_only=False),
                   Settings.from_dict(settings_dict))
    finally:
        mesh.teardown()
    torch.save(out, out_path)


def _spawn_ranks(torch, work, inputs, dev, settings, world=DP_RANKS,
                 timeout_s=DP_TIMEOUT_S):
    """``work`` in ``world`` processes of their own over gloo, every rank
    on the one card (NCCL refuses two ranks on one device), each joined
    within ``timeout_s`` (a rank that fails fails the run) -> (the ranks'
    records in rank order, seconds from their start)."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="dp_ranks_") as tmp:
        inputs_path = os.path.join(tmp, "inputs.pt")
        torch.save(inputs, inputs_path)
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_dp_rank, args=(
            work, r, world, os.path.join(tmp, "pg"), inputs_path,
            os.path.join(tmp, f"rank{r}.pt"), str(dev),
            settings.to_dict())) for r in range(world)]
        t0 = time.time()
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        _check(not alive, f"ranks {alive} of {world} ran past {timeout_s} s")
        _check(all(p.exitcode == 0 for p in procs), "a rank failed: exit "
               f"codes {[p.exitcode for p in procs]}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(world)]
        return ranks, time.time() - t0


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _one_rank_run(module, argv):
    """``cli.<module>.main(argv)`` in a process of its own, started as
    torchrun starts a rank (``env://``: RANK 0, WORLD_SIZE 1, LOCAL_RANK
    0), with ``--mesh_shape [1]`` in ``argv``, so on NCCL -> (the launches
    of v1 and of the three Winograd transforms in that process, in
    WINO_NAMES order, seconds from its start). Fails where it exits
    non-zero, runs past DP_TIMEOUT_S or joins no NCCL group."""
    what = f"{module} --mesh_shape [1]"
    code = ("import json, sys\n"
            f"from insenticap_model_tpu_torch.cli import {module}\n"
            "from insenticap_model_tpu_torch.ops import "
            "fused_attention as fa\n"
            "from insenticap_model_tpu_torch.ops import "
            "winograd_kernels as wk\n"
            f"{module}.main(sys.argv[1:])\n"
            "print('LAUNCHES', json.dumps([fa.beam_content_attention."
            f"launches] + [getattr(wk, n).launches for n in {WINO_NAMES!r}"
            "]))\n")
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               PYTHONPATH=os.pathsep.join(
                   [REPO_DIR] + [p for p in [os.environ.get(
                       "PYTHONPATH")] if p]))
    t0 = time.time()
    try:
        r = subprocess.run([sys.executable, "-c", code, *argv],
                           cwd=REPO_DIR, env=env, capture_output=True,
                           text=True, timeout=DP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        _fail(f"{what} ran past {DP_TIMEOUT_S} s")
    seconds = time.time() - t0
    _check(r.returncode == 0, f"{what} exited {r.returncode}: "
           f"{r.stderr[-3000:]}")
    _check("rank 0 of 1 over nccl" in r.stdout,
           f"{what} joined no NCCL group: {r.stdout[-2000:]}")
    launches = json.loads(re.findall(r"LAUNCHES (\[.*\])", r.stdout)[-1])
    return launches[0], launches[1:], seconds


def _dp_one_rank_cli(torch, dev, settings, keep):
    """Phase 3j(a): ``cli.train_xe`` in a process of its own, started as
    torchrun starts a rank (``env://``: RANK 0, WORLD_SIZE 1, LOCAL_RANK
    0) with ``--mesh_shape [1]``, so on NCCL, for epoch 0 on phase 3f's
    tree rebuilt from its seeds: its metrics line, its epoch-0 checkpoint
    (params and optimizer state) and its dump must equal phase 3f's f32
    run's bit for bit, and v1 must be launched in its dump."""
    from insenticap_model_tpu_torch.training import checkpoint as tck
    out = {}
    with tempfile.TemporaryDirectory(prefix="dp_") as tmp:
        t0 = time.time()
        _, _, cls_file = _xe_tree(torch, dev, settings, tmp)
        o = _xe_opts(settings, tmp, cls_file, "nccl1", device=str(dev))
        out["tree_s"] = time.time() - t0
        argv = ["--mesh_shape", "[1]", "--xe_epochs", "1",
                "--device", o.device,
                "--settings_json", json.dumps(settings.to_dict()),
                "--xe_bs", str(o.xe_bs), "--beam_size", str(o.beam_size),
                "--max_seq_len", str(o.max_seq_len), "--seed", str(o.seed),
                "--scheduled_sampling_increase_every",
                str(o.scheduled_sampling_increase_every),
                "--captions_dir", o.captions_dir, "--feats_dir", o.feats_dir,
                "--checkpoint", o.checkpoint, "--result_dir", o.result_dir]
        out["v1_launches"], _, out["cli_s"] = _one_rank_run("train_xe",
                                                            argv)
        _check(out["v1_launches"] > 0, "no v1 launch in the rank's dump")
        stage = os.path.join(o.checkpoint, "xe", "coco", "part")
        with open(os.path.join(stage, "metrics.jsonl")) as f:
            metrics = [json.loads(x) for x in f]
        ref = keep["epoch0"]
        _check(metrics == [ref["metrics"]], f"train_xe --mesh_shape [1] "
               f"metrics {metrics} != phase 3f's {ref['metrics']}")
        [name] = [f for f in os.listdir(stage) if f.startswith("model_0_")]
        p, st, _ = tck.load(os.path.join(stage, name), device="cpu",
                            with_opt_state=True)
        for tree_a, tree_b, what in ((p, ref["params"], "params"),
                                     (st, ref["opt_state"], "opt_state")):
            pa, pb = _tree_paths(tree_a), _tree_paths(tree_b)
            _check([q for q, _ in pa] == [q for q, _ in pb] and all(
                a.dtype == b.dtype and torch.equal(a, b.cpu())
                for (_, a), (_, b) in zip(pa, pb)),
                f"train_xe --mesh_shape [1] epoch-0 {what} differ from "
                "phase 3f's")
        with open(os.path.join(o.result_dir, "xe", "coco", "part",
                               "result_0.json")) as f:
            _check(json.load(f) == ref["result_0"], "train_xe --mesh_shape "
                   "[1] dump differs from phase 3f's")
        out["metrics"] = metrics[0]
    return out


def _dp_gaps(torch, rec, ref, lr, clip, eps, bf16=False):
    """A rank's step record against the one-process one: (the largest
    per-leaf |g - g_1| / |g_1| (L2) but the two softmax-invariant biases,
    that leaf, the largest param gap, the elements past its tolerance).
    The params hold Adam's first update of each side's gradient: the gap
    is |p - p_1 - lr (u(g_1) - u(g))|, u = c / (|c| + eps) of the clipped
    gradient (float64 on the host), held within 1e-5, and in bf16 also
    within one ulp of the params' rounding (2^-7 of the value: each side
    rounds its own update to the bf16 grid)."""
    def u(g):
        c = g.double().clamp(-clip, clip)
        return c / (c.abs() + eps)
    worst, leaf, gap, over = 0.0, None, 0.0, 0
    for path, g, g1, p, p1 in zip(ref["paths"], rec["grads"], ref["grads"],
                                  rec["params"], ref["params"]):
        if path not in SOFTMAX_INVARIANT:
            n = float(g1.norm())
            rel = float((g - g1).norm()) / n if n else \
                (0.0 if torch.equal(g, g1) else math.inf)
            if rel >= worst:
                worst, leaf = rel, "/".join(map(str, path))
        d = (p.double() - p1.double()) - lr * (u(g1) - u(g))
        tol = 1e-5 + (2.0 ** -7 * p1.double().abs() if bf16 else 0.0)
        gap = max(gap, float(d.abs().max()))
        over += int((d.abs() > tol).sum())
    return worst, leaf, gap, over


def _data_parallel(torch, np, dev, settings, keep):
    """Phase 3j: data-parallel training. (a) one rank on NCCL through the
    CLI (``_dp_one_rank_cli``); (b) DP_RANKS ranks over gloo, processes of
    their own sharing the one card (NCCL refuses two ranks on one
    device), each joined with a time limit, through ``parallel/mesh.py``
    on CUDA tensors (``_dp_rank``): the f32 XE step and the bf16 detector
    step on their rows, against the one-process steps on the whole
    batches on the card; (c) the f32 XE step's time per global batch of
    XE_BS, one process against the ranks (host clock, median of
    DP_TIMED_STEPS; a reading, no limit)."""
    from insenticap_model_tpu_torch.training import optim
    t_phase = time.time()
    out = {"one_rank_nccl": _dp_one_rank_cli(torch, dev, settings, keep)}
    inputs = {"batch": keep["batch"], "scs": keep["scs"]}
    ranks, out["ranks_s"] = _spawn_ranks(torch, _dp_steps, inputs, dev,
                                         settings)
    ref = _dp_steps(torch, np, dev, inputs, settings)   # one process

    rows = []
    for rec in ranks:
        xe, se = rec["xe"], rec["senti"]
        loss_rel = max(abs(xe["losses"][k] - ref["xe"]["losses"][k])
                       / abs(ref["xe"]["losses"][k]) for k in xe["losses"])
        g_xe, leaf_xe, gap_xe, over_xe = _dp_gaps(
            torch, xe, ref["xe"], XE_LR, 0.1, optim.EPS)
        s_rel = abs(se["loss"] - ref["senti"]["loss"]) / abs(
            ref["senti"]["loss"])
        g_se, leaf_se, gap_se, over_se = _dp_gaps(
            torch, se, ref["senti"], HEAD_LR, 0.1, optim.EPS, bf16=True)
        rows.append({"rank": rec["rank"], "xe_loss_rel": loss_rel,
                     "xe_grad_rel": g_xe, "xe_grad_leaf": leaf_xe,
                     "xe_param_gap": gap_xe, "xe_param_over": over_xe,
                     "senti_loss_rel": s_rel, "senti_grad_rel": g_se,
                     "senti_grad_leaf": leaf_se, "senti_param_gap": gap_se,
                     "senti_param_over": over_se,
                     "wino_launches": se["launches"]})
        _check(loss_rel <= 1e-5, f"rank {rec['rank']} XE losses "
               f"{xe['losses']} against one process's "
               f"{ref['xe']['losses']}: {loss_rel} relative (tolerance "
               "1e-5)")
        _check(g_xe <= DP_GRAD_RTOL, f"rank {rec['rank']} XE gradient of "
               f"{leaf_xe} differs from one process's by {g_xe} of its "
               f"norm (tolerance {DP_GRAD_RTOL})")
        _check(over_xe == 0, f"rank {rec['rank']} XE params: {over_xe} "
               f"elements past 1e-5 of Adam's update (largest {gap_xe})")
        _check(s_rel <= DP_BF16_RTOL and g_se <= DP_BF16_RTOL
               and over_se == 0, f"rank {rec['rank']} bf16 detector step "
               f"against one process's: loss {s_rel}, gradient {g_se} "
               f"({leaf_se}; tolerance {DP_BF16_RTOL}), params {over_se} "
               f"elements past their tolerance (largest {gap_se})")
        _check(se["launches"] == ref["senti"]["launches"] == [2, 2, 2],
               f"rank {rec['rank']} Winograd launches {se['launches']} "
               f"(one process {ref['senti']['launches']}); the eval step's "
               "two forwards launch each transform once")
    _check(all(torch.equal(a, b) for r in ranks[1:] for a, b in zip(
        r["xe"]["params"] + r["senti"]["params"],
        ranks[0]["xe"]["params"] + ranks[0]["senti"]["params"])),
        "the ranks' params differ")
    labels = torch.cat([r["senti"]["labels"] for r in ranks])
    share = float((labels == ref["senti"]["labels"]).float().mean())
    eval_sum = sum(r["senti"]["eval_sum"] for r in ranks)
    eval_rel = abs(eval_sum - ref["senti"]["eval_sum"]) / abs(
        ref["senti"]["eval_sum"])
    _check(sum(r["senti"]["eval_rows"] for r in ranks) == HEAD_BS
           and eval_rel <= DP_BF16_RTOL and share >= HEAD_LABEL_GATE,
           f"the ranks' bf16 eval against one process's: loss sum "
           f"{eval_rel} relative (tolerance {DP_BF16_RTOL}), labels equal "
           f"on {share:.2%} (gate {HEAD_LABEL_GATE:.0%})")
    per_batch = [max(r["xe"]["step_ms"][i] for r in ranks)
                 for i in range(DP_TIMED_STEPS)]
    allreduce = [max(r["xe"]["allreduce_ms"][i] for r in ranks)
                 for i in range(DP_TIMED_STEPS)]
    out.update(ranks=rows, eval_sum_rel=eval_rel, labels_equal=share,
               time={"one_process_ms": statistics.median(
                   ref["xe"]["step_ms"]),
                   "ranks_ms": statistics.median(per_batch),
                   "allreduce_ms": statistics.median(allreduce),
                   "grad_mb": ranks[0]["xe"]["grad_bytes"] / 1e6,
                   "one_process_all_ms": ref["xe"]["step_ms"],
                   "ranks_all_ms": per_batch, "allreduce_all_ms": allreduce},
               phase_s=time.time() - t_phase)
    smi = _smi()
    a = out["one_rank_nccl"]
    print(f"data parallel (phase 3j) (a) train_xe --mesh_shape [1] on NCCL "
          f"(env://, world size 1): epoch 0's metrics, checkpoint and dump "
          f"bit for bit phase 3f's (train all_loss "
          f"{a['metrics']['train_all_loss']:.6f}), v1 launches "
          f"{a['v1_launches']}, {a['cli_s']:.1f} s with the process's start")
    for r in rows:
        print(f"data parallel (b) rank {r['rank']} of {DP_RANKS} over gloo "
              f"on the one card against one process: f32 XE step (rows "
              f"{XE_BS // DP_RANKS} of {XE_BS}) losses max rel "
              f"{r['xe_loss_rel']:.3g}, gradient max rel "
              f"{r['xe_grad_rel']:.3g} ({r['xe_grad_leaf']}), params gap "
              f"{r['xe_param_gap']:.3g}; bf16 detector step (rows "
              f"{HEAD_BS // DP_RANKS} of {HEAD_BS}) loss rel "
              f"{r['senti_loss_rel']:.3g}, gradient max rel "
              f"{r['senti_grad_rel']:.3g}, params past tolerance "
              f"{r['senti_param_over']}; Winograd launches (input, middle, "
              f"output) {r['wino_launches']}")
    print(f"data parallel (b) bf16 eval over the ranks: loss sum rel "
          f"{eval_rel:.3g}, labels equal to one process's on {share:.2%}; "
          f"ranks' processes {out['ranks_s']:.1f} s with their start")
    t = out["time"]
    print(f"data parallel (c) f32 XE step per global batch of {XE_BS} on "
          f"{smi}: one process {t['one_process_ms']:.2f} ms, {DP_RANKS} "
          f"ranks sharing the card over gloo {t['ranks_ms']:.2f} ms, of "
          f"which the gradient's all-reduce alone ({t['grad_mb']:.1f} MB "
          f"f32) {t['allreduce_ms']:.2f} ms (medians of {DP_TIMED_STEPS}; "
          f"host clock); phase 3j {out['phase_s']:.1f} s")
    out["device"] = smi
    return out


def _keep_rl_tree(src, dst, opts):
    """Copy what phase 3k's ``train_rl`` run reads of phase 3h's tree
    ``src`` into ``dst`` before phase 3i writes into the tree: the data,
    the detector's file and the f32 run's bootstrap checkpoints (the XE
    captioner and the classifier)."""
    import shutil
    shutil.copytree(os.path.join(src, "data"), os.path.join(dst, "data"))
    shutil.copy(os.path.join(src, "det.ckpt"), dst)
    for stage in ("xe", "sent_senti_cls"):
        shutil.copytree(os.path.join(opts.checkpoint, stage),
                        os.path.join(dst, "ck", stage))


def _rl_one_rank_cli(torch, dev, settings, keep):
    """Phase 3k(a): ``cli.train_rl`` in a process of its own, started as
    torchrun starts a rank (``_one_rank_run``: NCCL, world size 1) with
    ``--mesh_shape [1]``, for epoch 0 on phase 3h's tree (the copy
    ``keep["root"]``) with phase 3h's f32 run's options: its metrics line,
    its composite checkpoint (the three parts and Adam's state) and every
    file of its dump must equal that run's bit for bit, and v1 must
    launch as often as there (the Winograd kernels not at all: the f32
    detector)."""
    from insenticap_model_tpu_torch.training import checkpoint as tck
    o, root = keep["opts"], keep["root"]
    argv = ["--mesh_shape", "[1]", "--rl_epochs", "1", "--device", o.device,
            "--settings_json", json.dumps(settings.to_dict()),
            "--rl_bs", str(o.rl_bs), "--beam_size", str(o.beam_size),
            "--max_seq_len", str(o.max_seq_len), "--seed", str(o.seed),
            "--rl_senti_times", str(o.rl_senti_times),
            "--rl_senti_resume", os.path.join(root, "det.ckpt"),
            "--img_senti_labels",
            os.path.join(root, "data/captions/img_senti_labels.json"),
            "--captions_dir", os.path.join(root, "data/captions"),
            "--feats_dir", os.path.join(root, "data/features"),
            "--checkpoint", os.path.join(root, "ck"),
            "--result_dir", os.path.join(root, "res")]
    out = {}
    out["v1_launches"], out["wino_launches"], out["cli_s"] = \
        _one_rank_run("train_rl", argv)
    _check(out["v1_launches"] == keep["v1_launches"] > 0
           and out["wino_launches"] == [0, 0, 0],
           f"train_rl --mesh_shape [1]: v1 launches {out['v1_launches']} "
           f"(phase 3h's f32 run {keep['v1_launches']}), Winograd "
           f"{out['wino_launches']} (the f32 detector takes none)")
    stage = os.path.join(root, "ck", "rl", "coco", "part")
    with open(os.path.join(stage, "metrics.jsonl")) as f:
        metrics = [json.loads(x) for x in f]
    _check(metrics == keep["metrics"], f"train_rl --mesh_shape [1] metrics "
           f"{metrics} != phase 3h's {keep['metrics']}")
    p, st, _ = tck.load(os.path.join(stage, "model_0.ckpt"), device="cpu",
                        with_opt_state=True)
    for tree_a, tree_b, what in zip((p, st), keep["composite"],
                                    ("parts", "opt_state")):
        pa, pb = _tree_paths(tree_a), _tree_paths(tree_b)
        _check([q for q, _ in pa] == [q for q, _ in pb] and all(
            a.dtype == b.dtype and torch.equal(a, b.cpu())
            for (_, a), (_, b) in zip(pa, pb)),
            f"train_rl --mesh_shape [1] epoch-0 {what} differ from phase "
            "3h's")
    res = os.path.join(root, "res", "rl", "coco", "part")
    names = sorted(os.listdir(res))
    _check(names == sorted(keep["results"]), f"train_rl --mesh_shape [1] "
           f"dump files {names} != phase 3h's {sorted(keep['results'])}")
    for name in names:
        with open(os.path.join(res, name), "rb") as f:
            _check(f.read() == keep["results"][name], f"train_rl "
                   f"--mesh_shape [1] dump file {name} differs from phase "
                   "3h's")
    out.update(metrics=metrics[0], files=len(names))
    return out


def _rl_dp_steps(torch, np, dev, inputs, settings):
    """Phase 3k(b)'s work on this process's rank (the whole batches where
    there is no process group), every rank seeding alike, the captioner
    broadcast from rank 0 and the CIDEr-D tables built by each rank from
    the same captions: from the seeded XE captioner of phase 3h, one f32
    fact step and one f32 senti step (the default dropout, the real
    sampler, the RL scheduled sampling, the f32 frozen detector and
    classifier of phase 3h) on its rows of phase 3h's first fact (RL_BS),
    sentiment (RL_BS) and seq2seq (80) batches; both again in float64;
    then, with a plain Adam (no copy of the gradients to the host), one
    f32 fact step to warm up and DP_TIMED_STEPS more, each timed between
    barriers, and one fact step with the detector in bf16, the Winograd
    kernels' launch counts set to 0 just before and read just after."""
    from insenticap_model_tpu_torch import nn
    from insenticap_model_tpu_torch.models import captioner as cap
    from insenticap_model_tpu_torch.ops import ciderd_device
    from insenticap_model_tpu_torch.ops import winograd_kernels as wk
    from insenticap_model_tpu_torch.parallel import mesh
    from insenticap_model_tpu_torch.rewards.ciderd import build_scorer
    from insenticap_model_tpu_torch.training import checkpoint as tck
    from insenticap_model_tpu_torch.training import optim, steps
    from insenticap_model_tpu_torch.utils.dtypes import cast_bf16
    RecordingAdam = _recording_adam(torch, optim)
    ids = cap.TokenIds(pad=0, unk=1, sos=2, eos=3, neutral=2)
    rank, world = mesh.rank(), mesh.world_size()
    caps_id = inputs["caps_id"]
    gts = {**caps_id["train"], **caps_id["val"]}
    tables, _ = ciderd_device.build_tables(
        build_scorer(caps_id, ids.sos, ids.eos), gts, list(gts), T,
        ids.sos, ids.eos, device=dev)
    det = tck.load(inputs["det_file"], device=dev, dtype=torch.float32)[0]
    cls = tck.load(inputs["cls_file"], device=dev, dtype=torch.float32)[0]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def rows(batch, dtype):
        sl = mesh.shard_rows(len(batch["fc" if "fc" in batch else "caps"]),
                             rank, world)
        out = {}
        for k, v in batch.items():
            if k == "valid":
                continue
            t = torch.from_numpy(np.ascontiguousarray(v[sl])).to(dev)
            out[k] = t.to(dtype) if t.is_floating_point() else t
        return out

    def train_step(data_type, dtype, adam_cls=RecordingAdam):
        """(a fresh ``adam_cls`` on the seeded captioner, its RL train
        step on this rank's rows of ``data_type``'s batch and of the
        seq2seq batch, bound to those rows: step(frozen, seed))."""
        params = nn.tree_map(
            lambda x: x.requires_grad_(True),
            mesh.replicate(cap.init_params(
                torch.Generator().manual_seed(3), VOCAB, NUM_CATS, settings,
                device=dev, dtype=dtype)))
        adam = adam_cls(params, RL_LR)
        step = steps.make_rl_steps(settings, adam, ids, T,
                                   tables)[(data_type, True)]
        b, s = rows(inputs[data_type], dtype), rows(inputs["scs"], dtype)
        return adam, lambda frozen, seed: step(
            frozen, b, s, torch.Generator(device=dev).manual_seed(seed))

    def one_step(data_type, dtype, frozen):
        """One step from the seeded captioner -> its record."""
        adam, step = train_step(data_type, dtype)
        losses = step(frozen, 0)
        return {"grads": adam.grads,
                "paths": [q for q, _ in _tree_paths(adam.params)],
                "params": [p.detach().float().cpu().clone()
                           for _, p in _tree_paths(adam.params)],
                "losses": {k: float(v) for k, v in losses.items()}}

    f32 = steps.RLModels(det, cls)
    f64 = steps.RLModels(*(nn.tree_map(lambda t: t.double(), m)
                           for m in (det, cls)))
    out = {"rank": rank, "world": world}
    for data_type in ("fact", "senti"):
        out[data_type] = one_step(data_type, torch.float32, f32)
        out[data_type + "_f64"] = one_step(data_type, torch.float64, f64)
    _, step = train_step("fact", torch.float32, optim.Adam)
    step(f32, 0)
    walls = []
    for i in range(DP_TIMED_STEPS):
        mesh.barrier()
        sync()
        t0 = time.perf_counter()
        step(f32, 1 + i)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["step_ms"] = walls
    bf16 = steps.RLModels(cast_bf16(det), cls)
    for name in WINO_NAMES:
        getattr(wk, name).launches = 0
    step(bf16, 0)
    out["wino_launches"] = [getattr(wk, n).launches for n in WINO_NAMES]
    return out


def _rl_data_parallel(torch, np, dev, settings, keep):
    """Phase 3k: the RL stage's data-parallel training. (a) one rank on
    NCCL through the CLI (``_rl_one_rank_cli``) against phase 3h's f32
    epoch 0; (b) DP_RANKS ranks over gloo sharing the one card
    (``_spawn_ranks`` of ``_rl_dp_steps``) against the one-process steps
    on the whole batches on the card, under phase 3j's gates; (c) the f32
    fact step's time per global batch of RL_BS, one process against the
    ranks (host clock, median of DP_TIMED_STEPS; a reading, no limit)."""
    from insenticap_model_tpu_torch.training import optim
    t_phase = time.time()
    out = {"one_rank_nccl": _rl_one_rank_cli(torch, dev, settings, keep)}
    inputs = dict(keep["inputs"],
                  det_file=os.path.join(keep["root"], "det.ckpt"),
                  cls_file=os.path.join(keep["root"], "ck", "sent_senti_cls",
                                        "coco", "part", "model-best.ckpt"))
    ranks, out["ranks_s"] = _spawn_ranks(torch, _rl_dp_steps, inputs, dev,
                                         settings)
    ref = _rl_dp_steps(torch, np, dev, inputs, settings)   # one process

    def loss_rel(got, want):
        return max(abs(got[k] - want[k]) / abs(want[k]) if want[k]
                   else abs(got[k]) for k in want)
    rows = []
    for rec in ranks:
        row = {"rank": rec["rank"], "wino_launches": rec["wino_launches"]}
        for tag in RL_DP_STEPS:
            g, leaf, gap, over = _dp_gaps(torch, rec[tag], ref[tag], RL_LR,
                                          0.1, optim.EPS)
            _check(set(rec[tag]["losses"]) == set(ref[tag]["losses"]),
                   f"rank {rec['rank']} {tag} loss keys")
            row[tag] = {"loss_rel": loss_rel(rec[tag]["losses"],
                                             ref[tag]["losses"]),
                        "grad_rel": g, "grad_leaf": leaf, "param_gap": gap,
                        "param_over": over}
        rows.append(row)
    per_batch = [max(r["step_ms"][i] for r in ranks)
                 for i in range(DP_TIMED_STEPS)]
    same = all(torch.equal(a, b) for r in ranks[1:] for tag in
               ("fact", "senti") for a, b in zip(r[tag]["params"],
                                                 ranks[0][tag]["params"]))
    out.update(ranks=rows, params_alike=same,
               one_process_wino_launches=ref["wino_launches"],
               losses={t: ref[t]["losses"] for t in ("fact", "senti")},
               time={"one_process_ms": statistics.median(ref["step_ms"]),
                     "ranks_ms": statistics.median(per_batch),
                     "one_process_all_ms": ref["step_ms"],
                     "ranks_all_ms": per_batch},
               phase_s=time.time() - t_phase)
    smi = _smi()
    a = out["one_rank_nccl"]
    n_scs = len(inputs["scs"]["caps"])
    print(f"RL data parallel (phase 3k) (a) train_rl --mesh_shape [1] on "
          f"NCCL (env://, world size 1): epoch 0's metrics, composite "
          f"checkpoint and {a['files']} dump files bit for bit phase 3h's "
          f"f32 run's (val cap_loss {a['metrics']['val_cap_loss']:.6f}), v1 "
          f"launches {a['v1_launches']}, {a['cli_s']:.1f} s with the "
          "process's start")
    for r in rows:
        print(f"RL data parallel (b) rank {r['rank']} of {DP_RANKS} over "
              f"gloo on the one card against one process (rows "
              f"{RL_BS // DP_RANKS} of {RL_BS}, seq2seq "
              f"{n_scs // DP_RANKS} of {n_scs}): " + "; ".join(
                  f"{t} losses max rel {v['loss_rel']:.3g}, gradient max "
                  f"rel {v['grad_rel']:.3g} ({v['grad_leaf']}), params gap "
                  f"{v['param_gap']:.3g} ({v['param_over']} past 1e-5)"
                  for t, v in r.items() if isinstance(v, dict))
              + f"; bf16 detector's Winograd launches (input, middle, "
              f"output) {r['wino_launches']}")
    t = out["time"]
    print(f"RL data parallel (c) f32 RL fact step per global batch of "
          f"{RL_BS} (+ {n_scs} seq2seq rows) on {smi}: one process "
          f"{t['one_process_ms']:.2f} ms, {DP_RANKS} ranks sharing the card "
          f"over gloo {t['ranks_ms']:.2f} ms (medians of {DP_TIMED_STEPS}; "
          f"host clock); ranks' processes {out['ranks_s']:.1f} s with their "
          f"start; phase 3k {out['phase_s']:.1f} s")
    out["device"] = smi
    for r in rows:
        for tag in RL_DP_STEPS:
            v = r[tag]
            _check(v["loss_rel"] <= 1e-5, f"rank {r['rank']} RL {tag} "
                   f"losses against one process's: {v['loss_rel']} "
                   "relative (tolerance 1e-5)")
            _check(v["grad_rel"] <= DP_GRAD_RTOL, f"rank {r['rank']} RL "
                   f"{tag} gradient of {v['grad_leaf']} differs from one "
                   f"process's by {v['grad_rel']} of its norm (tolerance "
                   f"{DP_GRAD_RTOL})")
            _check(v["param_over"] == 0, f"rank {r['rank']} RL {tag} "
                   f"params: {v['param_over']} elements past 1e-5 of Adam's "
                   f"update (largest {v['param_gap']})")
        _check(r["wino_launches"] == ref["wino_launches"] == [1, 1, 1],
               f"rank {r['rank']} Winograd launches {r['wino_launches']} "
               f"(one process {ref['wino_launches']}); the bf16 detector "
               "labels the fact batch once a step")
    _check(same, "the ranks' params differ")
    return out


def _step_card_vs_cpu(torch, dev, make_params, make_steps, batch, lr,
                      skip=()):
    """One train step with dropout off from the same seeded weights on the
    card and on the CPU: (the card's and the CPU's loss, {leaf: |card's
    gradient - CPU's| / |CPU's|} (L2) but the leaves of ``skip``, the
    params record).

    Adam's first update is lr * c / (|c| + eps), c the clipped gradient:
    about lr * sign(g), so an element whose gradient is a near-cancelling
    sum (rounding on one side) may move up to 2 lr apart on the two. The
    params record holds the max over the elements of |(card's params -
    CPU's) - lr * (u(CPU's gradient) - u(card's))|, u that first update
    computed on the host in float64 from each side's gradient, and, as
    readings, the raw max |card's params - CPU's| and the share of
    elements whose updates part by more than lr."""
    from insenticap_model_tpu_torch import nn
    from insenticap_model_tpu_torch.cli import common
    from insenticap_model_tpu_torch.config import Opts
    from insenticap_model_tpu_torch.training import optim

    class RecordingAdam(optim.Adam):
        """Adam that keeps, on the host, the gradients it steps on."""
        def step(self):
            self.grads = [(path, torch.zeros(p.shape) if p.grad is None
                           else p.grad.detach().float().cpu().clone())
                          for path, p in _tree_paths(self.params)]
            super().step()

    def one_step(device):
        params = nn.tree_map(lambda x: x.requires_grad_(True),
                             make_params(device))
        adam = RecordingAdam(params, lr)
        train_step, _ = make_steps(adam)
        rt = common.Runtime(Opts(device=str(device)))
        loss = float(train_step(rt.put(batch), torch.Generator(
            device=device).manual_seed(0)))
        return (loss, nn.tree_map(lambda x: x.detach().cpu(), params),
                adam.grads, adam.grad_clip)
    l_card, p_card, g_card, clip = one_step(dev)
    l_cpu, p_cpu, g_cpu, _ = one_step(torch.device("cpu"))

    def first_update(g):
        c = g.double().clamp(-clip, clip)
        return c / (c.abs() + optim.EPS)
    grad_rel = {}
    params = {"max_abs": 0.0, "raw_max_abs": 0.0, "parted_elements": 0,
              "elements": 0}
    for (path, gc), (_, gp), (_, pc), (_, pp) in zip(
            g_card, g_cpu, _tree_paths(p_card), _tree_paths(p_cpu)):
        norm = float(gp.norm())
        if path not in skip:
            grad_rel["/".join(map(str, path))] = (
                float((gc - gp).norm()) / norm if norm
                else (0.0 if torch.equal(gc, gp) else math.inf))
        diff = pc.double() - pp.double()
        parted = lr * (first_update(gp) - first_update(gc))
        params["max_abs"] = max(params["max_abs"],
                                float((diff - parted).abs().max()))
        params["raw_max_abs"] = max(params["raw_max_abs"],
                                    float(diff.abs().max()))
        params["parted_elements"] += int((parted.abs() > lr).sum())
        params["elements"] += diff.numel()
    return l_card, l_cpu, grad_rel, params


def _check_card_vs_cpu(name, l_card, l_cpu, grad_rel, params):
    """Phase 3f's gates on a head stage's step: the loss within 1e-5
    relative, each leaf's gradient within XE_GRAD_RTOL of its norm, the
    params within 1e-5 of what Adam's first update makes of each side's
    gradient (see ``_step_card_vs_cpu``). Returns the record."""
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    worst = max(grad_rel, key=grad_rel.get)
    rec = {"loss_card": l_card, "loss_cpu": l_cpu, "loss_rel": loss_rel,
           "grad_max_rel": grad_rel[worst], "grad_max_rel_leaf": worst,
           "params_max_abs": params["max_abs"],
           "params_raw_max_abs": params["raw_max_abs"],
           "params_parted_share": (params["parted_elements"]
                                   / params["elements"])}
    _check(loss_rel <= 1e-5 and grad_rel[worst] <= XE_GRAD_RTOL
           and params["max_abs"] <= 1e-5,
           f"{name} card step against the CPU's: {rec} (tolerances: loss "
           f"1e-5 relative, gradients {XE_GRAD_RTOL} of the norm, params "
           f"1e-5 of Adam's first update of each side's gradient)")
    return rec


def _head_stages(torch, np, dev, settings, zero_counters, read_counters):
    """Phase 3g: the head-stage trainers at full width on a synthetic tree
    through their CLIs' functions: ``train_cpt``, ``detect_concepts`` and
    ``test_cpt`` (f32); ``train_senti`` in f32, then in bf16 with the
    Winograd kernels' launches counted over its eval batches; the trained
    detector's labels, bf16 through the kernels and through their plain
    twins against f32; ``train_sent_senti_cls_rnn`` resumed for its last
    two epochs; one step of the concept and detector trainers on the card
    against the CPU; the step and eval times. Returns (the record, the
    f32-trained detector and the trained classifier, for phase 3h)."""
    import dataclasses
    import shutil
    import tempfile
    from insenticap_model_tpu_torch import nn, synthetic
    from insenticap_model_tpu_torch.cli import (
        common, detect_concepts, test_cpt, train_cpt,
        train_sent_senti_cls_rnn, train_senti)
    from insenticap_model_tpu_torch.config import Opts
    from insenticap_model_tpu_torch.models import concept_detector as cpt
    from insenticap_model_tpu_torch.models import sent_senti_cls as ss_cls
    from insenticap_model_tpu_torch.models import sentiment_detector as sd
    from insenticap_model_tpu_torch.ops import winograd_kernels as wk
    from insenticap_model_tpu_torch.training import checkpoint as tck
    from insenticap_model_tpu_torch.training import optim, steps
    from insenticap_model_tpu_torch.utils.dtypes import cast_bf16
    from insenticap_model_tpu_torch.utils.timing import device_ms_by_kernel
    cats = ["positive", "negative", "neutral"]
    wino = ("wino_input", "wino_middle", "wino_output")
    out, saved = {}, {}
    orig_save = tck.save

    def recording_save(path, params, opt_state, metadata):
        """The trees each checkpoint was given, kept on the host."""
        saved[path] = (nn.tree_map(lambda x: x.detach().cpu().clone(),
                                   params), opt_state)
        orig_save(path, params, opt_state, metadata)

    def read_back(path):
        """The checkpoint at ``path`` reads back bit-identical to the trees
        it was written from."""
        p_back, s_back, _ = tck.load(path, device=dev, with_opt_state=True)
        for tree_a, tree_b, what in ((p_back, saved[path][0], "params"),
                                     (s_back, saved[path][1], "opt_state")):
            pa, pb = _tree_paths(tree_a), _tree_paths(tree_b)
            _check([p for p, _ in pa] == [p for p, _ in pb] and all(
                a.dtype == b.dtype and torch.equal(a.cpu(), b)
                for (_, a), (_, b) in zip(pa, pb)),
                f"{os.path.basename(path)}: {what} did not read back "
                "bit-identical")

    def finite(metrics):
        return all(math.isfinite(v) for m in metrics for v in m.values()
                   if isinstance(v, float))

    def wall_ms(fn, runs=5):
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls) * 1e3

    with tempfile.TemporaryDirectory() as tmp:
        # 1. the tree at full feature width; idx2concept padded to
        # N_CONCEPTS concepts and idx2word to VOCAB words (the images'
        # concepts and the captions' words stay among the first few)
        t0 = time.time()
        synthetic.build_tree(tmp, settings, seed=0, n_img=HEAD_N_IMG,
                             n_senti_img=HEAD_N_SENTI_IMG)
        padded = {}
        for rel, n, stem in (("data/captions/coco/idx2concept.json",
                              N_CONCEPTS, "c"),
                             ("data/captions/coco/part/idx2word.json",
                              VOCAB, "w")):
            with open(os.path.join(tmp, rel)) as f:
                words = json.load(f)
            words += [f"{stem}{i}" for i in range(len(words), n)]
            with open(os.path.join(tmp, rel), "w") as f:
                json.dump(words, f)
            padded[stem] = words
        idx2concept, idx2word = padded["c"], padded["w"]
        out["tree_s"] = time.time() - t0

        def opts(name, **kw):
            return Opts(**dict(dict(
                settings=settings, seed=0, concept_bs=HEAD_BS,
                senti_bs=HEAD_BS, concept_lr=HEAD_LR, senti_lr=HEAD_LR,
                concept_epochs=HEAD_EPOCHS, senti_epochs=HEAD_EPOCHS,
                num_concepts=K_CONCEPTS,
                captions_dir=os.path.join(tmp, "data/captions"),
                feats_dir=os.path.join(tmp, "data/features"),
                img_senti_labels=os.path.join(
                    tmp, "data/captions/img_senti_labels.json"),
                checkpoint=os.path.join(tmp, "ck_" + name),
                result_dir=os.path.join(tmp, "res_" + name),
                device=str(dev)), **kw))

        def metrics_of(*parts):
            with open(os.path.join(*parts, "metrics.jsonl")) as f:
                return [json.loads(x) for x in f]

        tck.save = recording_save
        try:
            # 2. the concept stage, f32: train, detect, test
            o = opts("cpt")
            t0 = time.time()
            train_cpt.train(o)
            torch.cuda.synchronize()
            out["cpt_train_s"] = time.time() - t0
            ck_dir = os.path.join(o.checkpoint, "concept", "coco")
            m_cpt = metrics_of(ck_dir)
            _check(len(m_cpt) == HEAD_EPOCHS and finite(m_cpt)
                   and m_cpt[1]["train_loss"] < m_cpt[0]["train_loss"],
                   f"train_cpt metrics {m_cpt}")
            [ck1] = [p for p in saved if os.path.basename(p)
                     .startswith(f"model_{HEAD_EPOCHS - 1}_")
                     and p.startswith(ck_dir)]
            read_back(ck1)
            t0 = time.time()
            det = detect_concepts.run(opts("cpt", eval_model=ck1))
            out["detect_concepts_s"] = time.time() - t0
            n_fc = sum(HEAD_N_IMG.values()) + sum(HEAD_N_SENTI_IMG.values())
            known = set(idx2concept)
            _check(len(det) == n_fc and all(
                len(v) == K_CONCEPTS and len(set(v)) == K_CONCEPTS
                and set(v) <= known for v in det.values()),
                f"detect_concepts: {len(det)} entries for {n_fc} images")
            with open(os.path.join(tmp, "data/captions/coco",
                                   "img_det_concepts.json")) as f:
                _check(json.load(f) == det, "img_det_concepts.json is not "
                       "what detect_concepts returned")
            img, concepts, scores, wrong = test_cpt.run(
                opts("cpt", test_model=ck1))
            _check(len(concepts) == K_CONCEPTS and bool(np.isfinite(
                scores).all()), f"test_cpt: {concepts} {scores}")
            out["concept"] = {"metrics": m_cpt, "detected_images": len(det),
                              "test_cpt": {"image": img,
                                           "concepts": concepts,
                                           "wrong": wrong}}

            # 3. the detector, f32 then bf16; the Winograd kernels counted
            # over each run (the eval batches: 2 forwards each)
            runs = {}
            for tag, cdt in (("f32", "float32"), ("bf16", "bfloat16")):
                o = opts("senti_" + tag, compute_dtype=cdt)
                zero_counters()
                t0 = time.time()
                trained = train_senti.train(o)
                torch.cuda.synchronize()
                runs[tag] = {"s": time.time() - t0,
                             "launches": read_counters(),
                             "metrics": metrics_of(o.checkpoint,
                                                   "sentiment")}
                if tag == "f32":
                    det32 = nn.tree_map(lambda x: x.detach().clone(),
                                        trained)
            eval_batches = (-(-HEAD_N_SENTI_IMG["val"] // HEAD_BS)
                            + -(-HEAD_N_SENTI_IMG["test"] // HEAD_BS))
            want = 2 * eval_batches * HEAD_EPOCHS
            for tag, r in runs.items():
                _check(len(r["metrics"]) == HEAD_EPOCHS
                       and finite(r["metrics"]),
                       f"train_senti {tag} metrics {r['metrics']}")
                n_launch = [r["launches"][k] for k in wino]
                _check(n_launch == ([want] * 3 if tag == "bf16"
                                    else [0] * 3),
                       f"train_senti {tag}: Winograd launches {n_launch}, "
                       f"expected {want if tag == 'bf16' else 0} each")
            for path in saved:
                if "ck_senti_" in path or "ck_cpt" in path:
                    read_back(path)
            out["senti"] = runs
        finally:
            tck.save = orig_save

        # 4. the trained f32 detector on the eval batches train_senti runs
        # (the 120 test and 100 val images, bs HEAD_BS, the last of each
        # split padded): the bf16 logits through the kernels against their
        # plain twins' within rounding (phase 2's tolerances); the labels,
        # bf16 through the kernels, through the twins and by the direct
        # conv, each against the f32 direct conv's at the thresholds 0 and
        # 0.7, the kernels' equal to the twins' on at least HEAD_LABEL_GATE
        # of the images
        labels_json = common.load_json(os.path.join(
            tmp, "data/captions/img_senti_labels.json"))
        store = common.open_store(common.sniff_store_path(os.path.join(
            tmp, "data/features/sentiment/feats_att.h5")))
        det16 = cast_bf16(det32)
        parts = {k: [] for k in ("f32", "bf16_kernels", "bf16_plain_twins",
                                 "bf16_direct")}
        truth, twins_ok, twins_err, n_batches = [], True, 0.0, 0
        wk.wino_input.launches = 0
        with torch.no_grad():
            for split in ("test", "val"):
                items = [(fn, cats.index(c)) for fn, c in labels_json[split]]
                for batch in common.senti_image_loader(
                        store, items, HEAD_BS, shuffle=False,
                        drop_last=False):
                    feats = torch.from_numpy(batch["att"]).to(dev)
                    f16 = feats.bfloat16()
                    got = {"f32": sd.forward(det32, feats,
                                             use_kernels=False)[0],
                           "bf16_kernels": sd.forward(det16, f16)[0]}
                    with _wino_plain(wk):
                        got["bf16_plain_twins"] = sd.forward(det16, f16)[0]
                    got["bf16_direct"] = sd.forward(det16, f16,
                                                    use_kernels=False)[0]
                    ok, err = _within_rounding(
                        torch, got["bf16_kernels"], got["bf16_plain_twins"],
                        1e-2, 1e-3)
                    twins_ok, twins_err = twins_ok and ok, max(twins_err, err)
                    n = batch["valid"]
                    for k, v in got.items():
                        parts[k].append(v[:n].float())
                    truth += batch["labels"][:n].tolist()
                    n_batches += 1
        del feats, f16
        _check(wk.wino_input.launches == n_batches, "the bf16 detector did "
               f"not take the Winograd kernels: {wk.wino_input.launches} "
               f"launches over {n_batches} eval batches")
        _check(twins_ok, "trained detector: the bf16 logits through the "
               "Winograd kernels disagree with the plain twins' (rtol 1e-2, "
               f"1e-3 of the scale): max |diff| {twins_err:.4g}")
        logits = {k: torch.cat(v) for k, v in parts.items()}
        neutral = cats.index("neutral")
        labels = {thr: {k: sd.threshold_labels(v, thr, neutral)[0]
                        for k, v in logits.items()} for thr in (0.0, 0.7)}
        scores32 = sd.threshold_labels(logits["f32"], 0.0, neutral)[1]
        agree = {}
        for thr, lab in labels.items():
            for k in ("bf16_kernels", "bf16_plain_twins", "bf16_direct"):
                agree[f"{k}_vs_f32_t{thr}"] = float(
                    (lab[k] == lab["f32"]).float().mean())
            agree[f"kernels_vs_plain_twins_t{thr}"] = float(
                (lab["bf16_kernels"] == lab["bf16_plain_twins"])
                .float().mean())
        out["labels"] = {
            "images": len(truth), "eval_batches": n_batches,
            "agreement": agree,
            "f32_scores_above_0.7": int((scores32 > 0.7).sum()),
            "f32_accuracy_t0": float((labels[0.0]["f32"].cpu() == torch.tensor(
                truth)).float().mean()),
            "logits_kernels_vs_plain_twins_max_abs_err": twins_err,
            "logits_max_err_vs_f32": {
                k: float((v - logits["f32"]).abs().max())
                for k, v in logits.items() if k != "f32"},
            "logits_scale": float(logits["f32"].abs().max())}
        for thr in (0.0, 0.7):
            share = agree[f"kernels_vs_plain_twins_t{thr}"]
            _check(share >= HEAD_LABEL_GATE,
                   f"trained detector, threshold {thr}: the kernels' bf16 "
                   f"labels equal the plain twins' on {share:.4f} of "
                   f"{len(truth)} images (gate {HEAD_LABEL_GATE})")

        # 5. the sentence classifier at full width (vocab VOCAB): an
        # epoch-27 checkpoint through the port's writer (seeded weights,
        # fresh Adam state), then the CLI resumed from it for epochs 28-29
        cls = ss_cls.init_params(torch.Generator().manual_seed(5), VOCAB,
                                 NUM_CATS, settings, device=dev)
        cls_file = os.path.join(tmp, "cls27.ckpt")
        meta = {"epoch": train_sent_senti_cls_rnn.EPOCHS - 3,
                "lr": train_sent_senti_cls_rnn.LR,
                "settings": settings.to_dict(), "idx2word": idx2word,
                "sentiment_categories": cats, "dataset_name": "coco",
                "corpus_type": "part"}
        tck.save(cls_file, cls, optim.to_optax_state(optim.Adam(
            cls, train_sent_senti_cls_rnn.LR)), meta)
        o = opts("cls", senti_resume=cls_file)
        saved.clear()
        tck.save = recording_save
        try:
            t0 = time.time()
            cls_trained = nn.tree_map(lambda x: x.detach().clone(),
                                      train_sent_senti_cls_rnn.train(o))
            torch.cuda.synchronize()
            out["cls_two_epochs_s"] = time.time() - t0
        finally:
            tck.save = orig_save
        m_cls = metrics_of(o.checkpoint, "sent_senti_cls", "coco", "part")
        _check(len(m_cls) == 2 and [m["epoch"] for m in m_cls] == [
            train_sent_senti_cls_rnn.EPOCHS - 2,
            train_sent_senti_cls_rnn.EPOCHS - 1] and finite(m_cls),
            f"train_sent_senti_cls_rnn metrics {m_cls}")
        _check(len(saved) == 2, f"classifier checkpoints {sorted(saved)}")
        for path in saved:
            read_back(path)
        out["cls"] = {"metrics": m_cls}

        # 6. one step of the concept and detector trainers with dropout
        # off, on the card and on the CPU, from the same seeded weights
        # and the tree's first train batch
        nodrop = dataclasses.replace(settings, dropout_p=0.0)
        o = opts("inputs")
        img_concepts = common.load_json(common.dataset_path(
            o, "img_concepts.json"))
        c2i = {w: i for i, w in enumerate(idx2concept)}
        cpt_items = [(fn, [c2i[c] for c in cs])
                     for fn, cs in img_concepts["train"].items()]
        fc_store = common.open_store(common.feature_paths(o)[0])
        loader = common.concept_loader(fc_store, cpt_items, N_CONCEPTS,
                                       HEAD_BS)
        cpt_batch = loader.assemble(loader._index_batches()[0])
        senti_items = [(fn, cats.index(c))
                       for fn, c in labels_json["train"]]
        loader = common.senti_image_loader(store, senti_items, HEAD_BS)
        senti_batch = loader.assemble(loader._index_batches()[0])
        vocab = common.load_vocab(o)
        train_set, _ = train_sent_senti_cls_rnn.build_datasets(
            common.load_json(common.corpus_path(o, "senti_captions.json")),
            vocab, cats)
        loader = common.senti_sents_loader(train_set, o.max_seq_len,
                                           vocab.pad_id, HEAD_BS)
        cls_batch = loader.assemble(loader._index_batches()[0])

        def cpt_params(device):
            return cpt.init_params(torch.Generator().manual_seed(3),
                                   N_CONCEPTS, nodrop, device=device)

        def senti_params(device):
            return sd.init_params(torch.Generator().manual_seed(3),
                                  NUM_CATS, nodrop, device=device)
        t0 = time.time()
        out["card_vs_cpu"] = {
            "concept": _check_card_vs_cpu("train_cpt", *_step_card_vs_cpu(
                torch, dev, cpt_params,
                lambda a: steps.make_concept_steps(nodrop, a), cpt_batch,
                HEAD_LR)),
            "senti": _check_card_vs_cpu("train_senti", *_step_card_vs_cpu(
                torch, dev, senti_params,
                lambda a: steps.make_senti_steps(nodrop, a), senti_batch,
                HEAD_LR))}
        out["card_vs_cpu_s"] = time.time() - t0

        # 7. ms a train step (bs 80, the default dropout; host clock,
        # median of 5 after one warm-up), the bf16 detector step's device
        # time and idle share (the profiler, 5 steps), and a bf16 eval
        # batch of the detector (bs 80, its two forwards through the
        # kernels)
        timing = {}
        cases = (
            ("concept_f32", "float32", lambda d: cpt.init_params(
                torch.Generator().manual_seed(3), N_CONCEPTS, settings,
                device=d), steps.make_concept_steps, cpt_batch),
            ("senti_f32", "float32", lambda d: sd.init_params(
                torch.Generator().manual_seed(3), NUM_CATS, settings,
                device=d), steps.make_senti_steps, senti_batch),
            ("senti_bf16", "bfloat16", lambda d: sd.init_params(
                torch.Generator().manual_seed(3), NUM_CATS, settings,
                device=d), steps.make_senti_steps, senti_batch),
            ("cls_f32", "float32", lambda d: ss_cls.init_params(
                torch.Generator().manual_seed(3), VOCAB, NUM_CATS, settings,
                device=d), steps.make_cls_steps, cls_batch))
        for name, cdt, make, make_steps, batch in cases:
            rt = common.Runtime(Opts(device=str(dev), compute_dtype=cdt))
            params = nn.tree_map(lambda x: x.requires_grad_(True),
                                 rt.cast(make(dev)))
            train_step, eval_step = make_steps(
                settings, optim.Adam(params, HEAD_LR))
            b = rt.put(batch)
            gen = torch.Generator(device=dev).manual_seed(0)
            rec = {"train_step_ms": wall_ms(lambda: train_step(b, gen))}
            if name == "senti_bf16":
                by_kernel = device_ms_by_kernel(
                    lambda: train_step(b, gen), iters=5, warm=1)
                busy = sum(by_kernel.values())
                rec.update(device_ms=busy, idle_share=max(
                    0.0, 1.0 - busy / rec["train_step_ms"]),
                    top_kernels_ms=dict(sorted(
                        by_kernel.items(), key=lambda kv: -kv[1])[:6]))
                vb = dict(b, valid=HEAD_BS)
                zero_counters()
                eval_step(vb)
                _check(read_counters()["wino_input"] == 2,
                       "the bf16 eval batch did not take the kernels twice")
                # the batch's bf16 logits through the kernels against
                # their plain twins' (phase 2's tolerances)
                with torch.no_grad():
                    lk = sd.forward(params, b["att"])[0]
                    with _wino_plain(wk):
                        lp = sd.forward(params, b["att"])[0]
                ok, err = _within_rounding(torch, lk, lp, 1e-2, 1e-3)
                _check(ok, "the bf16 eval batch's logits through the "
                       "Winograd kernels disagree with the plain twins' "
                       f"(rtol 1e-2, 1e-3 of the scale): max |diff| "
                       f"{err:.4g}")
                rec["eval_logits_kernels_vs_twins_max_abs_err"] = err
                rec["eval_batch_ms"] = wall_ms(lambda: eval_step(vb))
            timing[name] = rec
        out["timing"] = timing
    smi = _smi()
    c, lab = out["concept"], out["labels"]
    print(f"head stages (phase 3g, full width, bs {HEAD_BS}, "
          f"{HEAD_EPOCHS} epochs): tree {out['tree_s']:.1f} s; train_cpt "
          f"{out['cpt_train_s']:.1f} s, train/val/test loss by epoch "
          + ", ".join(f"{m['train_loss']:.4f}/{m['val_loss']:.4f}/"
                      f"{m['test_loss']:.4f}" for m in c["metrics"])
          + f", precision {c['metrics'][-1]['precision']:.4f} recall "
          f"{c['metrics'][-1]['recall']:.4f}; detect_concepts "
          f"{c['detected_images']} images in "
          f"{out['detect_concepts_s']:.1f} s; test_cpt "
          f"{c['test_cpt']['image']}: {c['test_cpt']['concepts']}")
    for tag, r in out["senti"].items():
        print(f"train_senti {tag}: {r['s']:.1f} s, train/val loss and test "
              "accuracy by epoch " + ", ".join(
                  f"{m['train_loss']:.4f}/{m['val_loss']:.4f}/"
                  f"{m['corr_rate']:.4f}" for m in r["metrics"])
              + f"; Winograd launches "
              f"{[r['launches'][k] for k in wino]}")
    print(f"trained detector on {lab['images']} images in "
          f"{lab['eval_batches']} eval batches of {HEAD_BS}: bf16 logits, "
          f"kernels against plain twins, max |diff| "
          f"{lab['logits_kernels_vs_plain_twins_max_abs_err']:.4g} (gate: "
          f"rtol 1e-2, 1e-3 of the scale); labels (f32 direct "
          f"accuracy at threshold 0 {lab['f32_accuracy_t0']:.4f}; "
          f"{lab['f32_scores_above_0.7']} f32 scores above 0.7): " + ", ".join(
              f"{k} {v:.4f}" for k, v in lab["agreement"].items())
          + "; logits max err vs f32 " + ", ".join(
              f"{k} {v:.4g}" for k, v in lab["logits_max_err_vs_f32"].items())
          + f" (scale {lab['logits_scale']:.4g})")
    print("train_sent_senti_cls_rnn epochs 28-29 (resumed): train loss / "
          "all acc " + ", ".join(f"{m['train_loss']:.4f}/{m['all_acc']:.2f}"
                                 for m in out["cls"]["metrics"])
          + f" in {out['cls_two_epochs_s']:.1f} s")
    for name, r in out["card_vs_cpu"].items():
        print(f"{name} card step against the CPU's (f32, dropout off): loss "
              f"{r['loss_card']:.6f} vs {r['loss_cpu']:.6f} (rel "
              f"{r['loss_rel']:.3g}); gradients max |diff|/|CPU's| "
              f"{r['grad_max_rel']:.3g} ({r['grad_max_rel_leaf']}); params "
              f"max |diff - Adam's first update of each side's gradient| "
              f"{r['params_max_abs']:.3g}; raw max |diff| "
              f"{r['params_raw_max_abs']:.3g}, updates more than lr apart "
              f"on {r['params_parted_share']:.3g} of the elements")
    for name, r in out["timing"].items():
        print(f"{name} on {smi}: {r['train_step_ms']:.2f} ms a train step "
              f"(bs {HEAD_BS}, median of 5)" + (
                  f"; device {r['device_ms']:.2f} ms, idle share "
                  f"{r['idle_share']:.3f}; largest: " + ", ".join(
                      f"{k[:40]} {v:.3f}" for k, v in
                      list(r["top_kernels_ms"].items())[:3])
                  + f"; eval batch {r['eval_batch_ms']:.2f} ms, its bf16 "
                  f"logits kernels vs plain twins max |diff| "
                  f"{r['eval_logits_kernels_vs_twins_max_abs_err']:.4g}"
                  if "device_ms" in r else ""))
    out["device"] = smi
    return out, {"detector": det32, "classifier": cls_trained}


def _train_rl(torch, np, dev, settings, zero_counters, read_counters,
              trained, tmp, keep):
    """Phase 3h: the RL stage through ``cli.train_rl.train`` at full width
    on a synthetic tree under ``tmp``, bootstrapped from checkpoints the
    port's writer saves (a seeded XE captioner, phase 3g's trained detector
    and classifier): one f32 epoch, a resumed epoch, one bf16 epoch with
    the bf16 detector, ``eval_cls_rnn`` on the dump; the device CIDEr-D
    against the host scorer, one fact step on the card against the CPU,
    the detector's and the dump's kernels against their plain twins, and
    the step, reward and dump times. ``out["files"]`` names what phase 3i
    reuses: the tree, the f32 run's composite and checkpoint root, and the
    detector's file. Into ``keep`` go what phase 3k reuses: the f32 run's
    options, its epoch 0 (metrics, the composite's trees, the dump's
    files, v1's launches) and the first fact, sentiment and seq2seq train
    batches with the tokenized captions."""
    import dataclasses
    from insenticap_model_tpu_torch import inference, nn, synthetic
    from insenticap_model_tpu_torch.cli import common, eval_cls_rnn, train_rl
    from insenticap_model_tpu_torch.config import Opts
    from insenticap_model_tpu_torch.models import captioner as cap
    from insenticap_model_tpu_torch.models import sentiment_detector as sd
    from insenticap_model_tpu_torch.ops import ciderd_device
    from insenticap_model_tpu_torch.ops import fused_attention as fa
    from insenticap_model_tpu_torch.ops import fused_topk as ft
    from insenticap_model_tpu_torch.ops import winograd_kernels as wk
    from insenticap_model_tpu_torch.rewards.ciderd import (build_scorer,
                                                           seq_from_ids)
    from insenticap_model_tpu_torch.training import checkpoint as tck
    from insenticap_model_tpu_torch.training import optim, steps
    from insenticap_model_tpu_torch.utils.dtypes import cast_bf16
    from insenticap_model_tpu_torch.utils.timing import (device_ms,
                                                         device_ms_by_kernel)
    from insenticap_model_tpu_torch.vocab import Vocab
    cats = ["positive", "negative", "neutral"]
    wino = ("wino_input", "wino_middle", "wino_output")
    ids = cap.TokenIds(pad=0, unk=1, sos=2, eos=3, neutral=2)
    out, saved, calls = {}, {}, {"detector_bf16": 0, "decode_steps": 0}
    orig_save, orig_fwd = tck.save, sd.forward
    orig_tail = ft.classifier_topk_plain

    def recording_save(path, params, opt_state, metadata):
        """The trees each checkpoint was given, kept on the host."""
        saved[path] = (nn.tree_map(lambda x: x.detach().cpu().clone(),
                                   params), opt_state)
        orig_save(path, params, opt_state, metadata)

    def counting_fwd(params, features, **kw):
        """The detector's forward, its bf16 calls on the card counted."""
        if features.dtype == torch.bfloat16 and features.is_cuda:
            calls["detector_bf16"] += 1
        return orig_fwd(params, features, **kw)

    def counting_tail(*args, **kw):
        """The beam's vocabulary tail, once a decode step."""
        calls["decode_steps"] += 1
        return orig_tail(*args, **kw)

    def read_back(path):
        """The checkpoint at ``path`` reads back bit-identical to the trees
        it was written from, optimizer state included."""
        p_back, s_back, _ = tck.load(path, device=dev, with_opt_state=True)
        for tree_a, tree_b, what in ((p_back, saved[path][0], "params"),
                                     (s_back, saved[path][1], "opt_state")):
            pa, pb = _tree_paths(tree_a), _tree_paths(tree_b)
            _check([p for p, _ in pa] == [p for p, _ in pb] and all(
                a.dtype == b.dtype and torch.equal(a.cpu(), b)
                for (_, a), (_, b) in zip(pa, pb)),
                f"{os.path.basename(path)}: {what} did not read back "
                "bit-identical")

    def wall_ms(fn, runs=5):
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls) * 1e3

    # 1. the tree at full feature width (the vocabulary padded to VOCAB
    # words) and the RL inputs; the bootstrap's checkpoints through
    # the port's writer: a seeded XE captioner, phase 3g's trained
    # detector and classifier
    t0 = time.time()
    synthetic.build_tree(tmp, settings, seed=0, n_img=RL_N_IMG,
                         n_senti_img=RL_N_SENTI_IMG)
    synthetic.write_rl_inputs(tmp)
    vpath = os.path.join(tmp, "data/captions/coco/part/idx2word.json")
    with open(vpath) as f:
        words = json.load(f)
    words += [f"w{i}" for i in range(len(words), VOCAB)]
    with open(vpath, "w") as f:
        json.dump(words, f)
    out["tree_s"] = time.time() - t0
    meta = {"settings": settings.to_dict(), "idx2word": words,
            "sentiment_categories": cats, "dataset_name": "coco",
            "corpus_type": "part"}
    cap0 = cap.init_params(torch.Generator().manual_seed(3), VOCAB,
                           NUM_CATS, settings, device=dev)
    det_file = os.path.join(tmp, "det.ckpt")
    tck.save(det_file, trained["detector"], None, meta)
    boot = {"xe": cap0, "sent_senti_cls": trained["classifier"]}

    def opts(name, **kw):
        ck = os.path.join(tmp, "ck_" + name)
        for stage, params in boot.items():
            d = os.path.join(ck, stage, "coco", "part")
            os.makedirs(d, exist_ok=True)
            tck.save(os.path.join(d, "model-best.ckpt"), params, None,
                     meta)
        return Opts(**dict(dict(
            settings=settings, rl_bs=RL_BS, beam_size=BEAM,
            max_seq_len=T, seed=0, rl_senti_times=1,
            rl_senti_resume=det_file,
            img_senti_labels=os.path.join(
                tmp, "data/captions/img_senti_labels.json"),
            captions_dir=os.path.join(tmp, "data/captions"),
            feats_dir=os.path.join(tmp, "data/features"),
            checkpoint=ck, result_dir=os.path.join(tmp, "res_" + name),
            device=str(dev)), **kw))

    def stage(o, *parts):
        return os.path.join(o.checkpoint, "rl", "coco", "part", *parts)

    def metrics_of(o):
        with open(stage(o, "metrics.jsonl")) as f:
            return [json.loads(x) for x in f]

    def finite(metrics):
        return all(math.isfinite(v) for m in metrics for v in m.values()
                   if isinstance(v, float))

    # 2. the epochs: f32, then resumed from its checkpoint, then bf16
    # with the bf16 detector; the kernels counted over each run, the
    # bf16 detector's calls and the beam's decode steps beside them
    runs = {}
    tck.save, sd.forward = recording_save, counting_fwd
    ft.classifier_topk_plain = counting_tail
    try:
        for tag, kw in (
                ("f32", dict(rl_epochs=1)),
                ("resume", dict(rl_epochs=2)),
                ("bf16", dict(rl_epochs=1, compute_dtype="bfloat16",
                              rl_detector_dtype="bf16"))):
            if tag == "resume":
                kw["rl_resume"] = stage(runs["f32"]["opts"],
                                        "model_0.ckpt")
            o = opts(tag, **kw)
            calls.update(detector_bf16=0, decode_steps=0)
            zero_counters()
            t0 = time.time()
            params = train_rl.train(o)
            torch.cuda.synchronize()
            runs[tag] = {"opts": o, "s": time.time() - t0,
                         "launches": read_counters(),
                         "calls": dict(calls), "metrics": metrics_of(o),
                         "params": params}
    finally:
        tck.save, sd.forward = orig_save, orig_fwd
        ft.classifier_topk_plain = orig_tail
    for tag, r in runs.items():
        m, n = r["metrics"], r["launches"]
        _check(finite(m), f"train_rl {tag}: non-finite metrics {m}")
        _check([x["epoch"] for x in m] == ([1] if tag == "resume"
                                            else [0]),
               f"train_rl {tag}: epochs {[x['epoch'] for x in m]}")
        _check(n["beam_content_attention"] == r["calls"]["decode_steps"]
               and n["beam_content_attention"] > 0,
               f"train_rl {tag}: v1 launches {n['beam_content_attention']}"
               f" != the dump's decode steps {r['calls']['decode_steps']}")
        want = r["calls"]["detector_bf16"]
        _check([n[k] for k in wino] == [want] * 3
               and (want > 0) == (tag == "bf16"),
               f"train_rl {tag}: Winograd launches "
               f"{[n[k] for k in wino]}, bf16 detector calls {want}")
        read_back(stage(r["opts"], f"model_{m[0]['epoch']}.ckpt"))
    out["epochs"] = {tag: {k: v for k, v in r.items()
                           if k not in ("opts", "params")}
                     for tag, r in runs.items()}

    # 3. eval_cls_rnn on the f32 dump's sentiment split (the trained
    # detector labels it with all three sentiments)
    o = runs["f32"]["opts"]
    prefix = os.path.join(o.result_dir, "rl", "coco", "part",
                          "result_0")
    for c in cats:
        _check(os.path.exists(f"{prefix}_{c}_senti.txt"),
               f"the dump has no {c} captions of the sentiment split")
    t0 = time.time()
    out["cls_acc"] = eval_cls_rnn.compute_cls(prefix, "senti",
                                              o.checkpoint, device=dev)
    out["eval_cls_s"] = time.time() - t0
    _check(set(out["cls_acc"]) == {"all", *cats} and all(
        0.0 <= v <= 1.0 for v in out["cls_acc"].values()),
        f"eval_cls_rnn: {out['cls_acc']}")

    # 4. the inputs of the checks: the tree's first fact batch, a
    # seq2seq batch, the tables (timed, with their bytes)
    vocab = Vocab(words)
    caps_id = common.tokenize_captions(common.load_json(
        common.dataset_path(o, "img_captions.json")), vocab)
    cpts_id = common.tokenize_concepts(common.load_json(
        common.dataset_path(o, "img_det_concepts.json")), vocab)
    sentis_id = common.tokenize_sentiments(common.load_json(
        common.corpus_path(o, "img_det_sentiments.json")), vocab)
    scs_id = common.tokenize_senti_corpus(common.load_json(
        common.corpus_path(o, "senti_captions.json")), vocab, cats)
    t0 = time.time()
    scorer = build_scorer(caps_id, vocab.sos_id, vocab.eos_id)
    gts = {**caps_id["train"], **caps_id["val"]}
    tables, fn2row = ciderd_device.build_tables(
        scorer, gts, list(gts), T, vocab.sos_id, vocab.eos_id,
        device=dev)
    torch.cuda.synchronize()
    out["tables"] = {"build_s": time.time() - t0,
                     "bytes": tables.nbytes(), "images": len(fn2row),
                     "ngrams": int(tables.df_h1.numel())}
    cpu_tables, _ = ciderd_device.build_tables(
        scorer, gts, list(gts), T, vocab.sos_id, vocab.eos_id)
    fc_s, att_s = (common.open_store(p) for p in common.feature_paths(o))
    loader = common.rl_fact_loader(fc_s, att_s, caps_id["train"],
                                   cpts_id, sentis_id, vocab, o, RL_BS,
                                   fn2row=fn2row)
    batch = loader.assemble(loader._index_batches()[0])
    scs_loader = common.scs_loader(scs_id, vocab, o, train_rl.SCS_BS)
    scs_b = scs_loader.assemble(scs_loader._index_batches()[0])
    rt = common.Runtime(Opts(device=str(dev)))
    b = rt.put(batch)

    # 5. the device CIDEr-D against the host scorer on one fact batch:
    # the sample and greedy rollouts of the seeded captioner, and
    # ground-truth captions (which score high)
    with torch.no_grad():
        labels = sd.sample(trained["detector"], b["att"], 0.7,
                           ids.neutral)[0]
        rolls = [cap.forward_rl(
            cap0, b["fc"], b["att"], b["cpts"], b["sentis"], labels,
            settings=settings, ids=ids, max_seq_len=T, sample_max=greedy,
            gen=torch.Generator(device=dev).manual_seed(1),
            deterministic=True)[0] for greedy in (False, True)]
    gt_rows = torch.from_numpy(batch["caps"][:, 1:]).to(dev)
    hyps = torch.cat(rolls + [gt_rows.to(torch.int32)])
    img = torch.cat([b["img_rows"]] * 3)
    cid, clen = ciderd_device.canonicalize(hyps, ids.eos, T + 1)
    card = ciderd_device.cider_d(tables, cid, clen, img).cpu().numpy()
    fns = batch["fns"] * 3
    host = scorer.compute_score(
        {str(i): [seq_from_ids(c, ids.sos, ids.eos)
                  for c in batch["ground_truth"][fn]]
         for i, fn in enumerate(fns)},
        [{"image_id": str(i), "caption": [seq_from_ids(
            h, ids.sos, ids.eos)]} for i, h in
         enumerate(hyps.cpu().numpy())])[1]
    rel = np.abs(card - host) / np.maximum(np.abs(host), 1e-30)
    out["cider_vs_host"] = {
        "rows": len(host), "max_rel": float(np.where(
            host != 0, rel, np.abs(card)).max()),
        "mean_sample": float(host[:RL_BS].mean()),
        "mean_greedy": float(host[RL_BS:2 * RL_BS].mean()),
        "mean_ground_truth": float(host[2 * RL_BS:].mean())}
    _check(np.allclose(card, host, rtol=2e-5, atol=0),
           f"device CIDEr-D against the host scorer: "
           f"{out['cider_vs_host']} (tolerance rtol 2e-5)")
    out["reward_device_ms"] = device_ms(
        lambda: ciderd_device.self_critical_reward(
            tables, rolls[0], rolls[1], b["img_rows"], ids.eos),
        iters=10)

    # 6. one fact step with dropout off and the draw forced to
    # argmax(logprobs + G) (G one seeded Gumbel array), the
    # scheduled-sampling probabilities 0, on the card and on the CPU
    # from the same weights; a seeded detector (its labels far from
    # the threshold) and the trained classifier. In f32: the losses
    # within 1e-5 relative, the params within 1e-5 of Adam's first
    # update of each side's gradient. The gradients of att_embed and
    # att2att are near-cancelling sums over the batch's 7,840
    # positions, which f32 rounds to up to 1e-3 of their norms, on
    # either device (each side against float64 is printed); the same
    # step in float64 on both holds each leaf's gradient within
    # XE_GRAD_RTOL of its norm (the two softmax-invariant biases, zero
    # but for rounding, aside)
    nodrop = dataclasses.replace(settings, dropout_p=0.0)
    gumbel = torch.from_numpy(np.random.default_rng(123).gumbel(
        size=(train_rl.SCS_BS, VOCAB)).astype(np.float32))
    det_seeded = sd.init_params(torch.Generator().manual_seed(3),
                                NUM_CATS, settings, device="cpu")
    step_losses, step_grads = [], []    # card, CPU; f32, then f64

    def forced(gen, logprobs):
        g = gumbel[:logprobs.shape[0]].to(logprobs.device)
        return (logprobs.float() + g).argmax(dim=-1)

    def rl_steps(adam):
        p0 = nn.tree_leaves(adam.params)[0]
        d, dt = p0.device, p0.dtype
        rl = steps.make_rl_steps(
            nodrop, adam, ids, T, tables if d.type == "cuda"
            else cpu_tables)

        def put(t):
            return t.to(d, dt) if t.is_floating_point() else t.to(d)
        fz = steps.RLModels(nn.tree_map(put, det_seeded),
                            nn.tree_map(put, trained["classifier"]))
        scs = {k: put(v) if torch.is_tensor(v) else v
               for k, v in common.Runtime(Opts(
                   device=str(d))).put(scs_b).items()}

        def step(b_, gen):
            b_ = {k: put(v) if torch.is_tensor(v) else v
                  for k, v in b_.items()}
            losses = rl[("fact", True)](fz, b_, scs, gen)
            step_losses.append({k: float(v) for k, v in losses.items()})
            step_grads.append(adam.grads)
            return losses["cap_loss"] + losses["xe_loss"]
        return step, None
    saved_ss = steps.RL_XE_SS_PROB, steps.RL_SEQ_SS_PROB
    orig_cat = cap._categorical
    steps.RL_XE_SS_PROB = steps.RL_SEQ_SS_PROB = 0.0
    cap._categorical = forced
    t0 = time.time()
    try:
        card_cpu = {tag: _step_card_vs_cpu(
            torch, dev, lambda d, dt=dt: cap.init_params(
                torch.Generator().manual_seed(3), VOCAB, NUM_CATS,
                nodrop, device=d, dtype=dt), rl_steps, batch, RL_LR,
            skip=SOFTMAX_INVARIANT)
            for tag, dt in (("f32", torch.float32),
                            ("f64", torch.float64))}
    finally:
        steps.RL_XE_SS_PROB, steps.RL_SEQ_SS_PROB = saved_ss
        cap._categorical = orig_cat
    out["cpu_step_s"] = time.time() - t0

    def rel_max(a, b):
        return max(abs(a[k] - b[k]) / abs(b[k]) if b[k] else abs(a[k])
                   for k in b)

    def grad_vs(got, want):
        """(max over leaves of |got - want| / |want| (L2), its leaf),
        the softmax-invariant biases aside."""
        r = {"/".join(map(str, p)): float((a.double() - b).norm()
                                          / b.norm())
             for (p, a), (_, b) in zip(got, want)
             if p not in SOFTMAX_INVARIANT}
        worst = max(r, key=r.get)
        return r[worst], worst
    l32c, l32p, l64c, l64p = step_losses
    g32c, g32p, g64c, g64p = step_grads
    rec = {"losses_card": l32c, "losses_cpu": l32p,
           "losses_max_rel": rel_max(l32c, l32p),
           "losses_f64_max_rel": rel_max(l64c, l64p)}
    for tag, (_, _, grad_rel, params) in card_cpu.items():
        worst = max(grad_rel, key=grad_rel.get)
        rec[f"grad_max_rel_{tag}"] = grad_rel[worst]
        rec[f"grad_max_rel_leaf_{tag}"] = worst
        rec[f"params_max_abs_{tag}"] = params["max_abs"]
        rec[f"params_raw_max_abs_{tag}"] = params["raw_max_abs"]
    for side, g32, g64 in (("card", g32c, g64c), ("cpu", g32p, g64p)):
        rec[f"grad_f32_vs_f64_{side}"] = grad_vs(g32, g64)
    out["card_vs_cpu"] = rec
    _check(set(l32c) == set(l32p) and rec["losses_max_rel"] <= 1e-5
           and rec["losses_f64_max_rel"] <= 1e-5
           and rec["params_max_abs_f32"] <= 1e-5
           and rec["params_max_abs_f64"] <= 1e-5
           and rec["grad_max_rel_f64"] <= XE_GRAD_RTOL,
           f"train_rl card step against the CPU's: {rec} (tolerances: "
           "losses 1e-5 relative, params 1e-5 of Adam's first update "
           f"of each side's gradient, the f64 gradients {XE_GRAD_RTOL} "
           "of the norm)")

    # 7. the bf16 detector: its logits through the kernels against the
    # plain twins' (phase 2's tolerances) and its labels against the
    # f32 direct conv's at thresholds 0 and 0.7, on the fact batch and
    # the sentiment split's first batch
    senti_imgs = common.load_json(o.img_senti_labels)["train"]
    s_att = common.open_store(common.sniff_store_path(os.path.join(
        o.feats_dir, "sentiment", "feats_att.h5"))).batch(
        [fn for fn, _ in senti_imgs[:RL_BS]])
    feats = torch.cat([b["att"], torch.from_numpy(s_att).to(dev)])
    det16 = cast_bf16(trained["detector"])
    with torch.no_grad():
        with nn.exact_numerics():
            l32 = sd.forward(trained["detector"], feats,
                             use_kernels=False)[0]
        f16 = feats.bfloat16()
        wk.wino_input.launches = 0
        lk = sd.forward(det16, f16)[0]
        _check(wk.wino_input.launches == 1,
               "the bf16 detector did not take the Winograd kernels")
        with _wino_plain(wk):
            lp = sd.forward(det16, f16)[0]
    ok, err = _within_rounding(torch, lk, lp, 1e-2, 1e-3)
    _check(ok, "train_rl bf16 detector: the logits through the Winograd "
           "kernels disagree with the plain twins' (rtol 1e-2, 1e-3 of "
           f"the scale): max |diff| {err:.4g}")
    agree = {}
    for thr in (0.0, 0.7):
        lab32 = sd.threshold_labels(l32, thr, ids.neutral)[0]
        for k, v in (("kernels", lk), ("plain_twins", lp)):
            agree[f"{k}_vs_f32_t{thr}"] = float(
                (sd.threshold_labels(v, thr, ids.neutral)[0] == lab32)
                .float().mean())
    out["detector_bf16"] = {
        "images": int(feats.shape[0]),
        "logits_kernels_vs_twins_max_abs_err": err,
        "logits_scale": float(l32.abs().max()), "labels": agree}

    # 8. the dump's decode (detect_and_decode: the detector, then the
    # beam with v1) against the plain path: the f32-trained captioner
    # on the tree's test images in f32, every top beam identical and
    # scores within 1e-3; in bf16 on XE_CMP_BATCHES batches of
    # standard-normal features, phase 4's gate (the share of identical
    # top beams at least v1 with tanhf's, rounded down to a percent)
    test_fns = sorted(caps_id["test"])[:RL_BS]
    tb = next(train_rl.fact_test_batches(test_fns, RL_BS, fc_s, att_s,
                                         sentis_id, vocab, o))
    vs_plain = {}
    for tag in ("f32", "bf16"):
        rt_ = common.Runtime(Opts(device=str(dev), compute_dtype=(
            "bfloat16" if tag == "bf16" else "float32")))
        sp = inference.ServingParams(
            rt_.cast(nn.tree_map(lambda x: x.detach().float(),
                                 runs["f32"]["params"])),
            rt_.cast(trained["detector"]))
        kwd = dict(settings=settings, ids=ids, beam_size=BEAM,
                   max_seq_len=T)
        with torch.no_grad():
            if tag == "f32":
                x = rt_.put(tb)
                ks, ksc, kl = inference.detect_and_decode(
                    sp, x["fc"], x["att"], x["sentis"], **kwd)
                ps, psc, pl = inference.detect_and_decode(
                    sp, x["fc"], x["att"], x["sentis"], **kwd,
                    use_kernels=False)
                eq, dscore = _top_beams_vs_plain(ks, ksc, ps, psc)
                vs_plain[tag] = {"images": int(eq.numel()),
                                 "top_beam_identical":
                                 float(eq.float().mean()),
                                 "labels_identical":
                                 bool(torch.equal(kl, pl)),
                                 "max_score_diff": dscore}
                _check(bool(eq.all()) and dscore <= 1e-3
                       and torch.equal(kl, pl),
                       f"train_rl f32 dump against the plain path: "
                       f"{vs_plain[tag]}")
                dump_ms = wall_ms(lambda: inference.detect_and_decode(
                    sp, x["fc"], x["att"], x["sentis"], **kwd))
                continue
            g = torch.Generator(device=dev).manual_seed(6)
            got = {"kernel": [], "plain": [], "tanhf": []}
            for _ in range(XE_CMP_BATCHES):
                fc = torch.randn(RL_BS, settings.fc_feat_dim,
                                 generator=g, device=dev)
                att = torch.randn(RL_BS, 14, 14, settings.att_feat_dim,
                                  generator=g, device=dev)
                sw = torch.randint(4, VOCAB, (RL_BS, M), generator=g,
                                   device=dev)
                fc, att = fc.bfloat16(), att.bfloat16()
                got["kernel"].append(inference.detect_and_decode(
                    sp, fc, att, sw, **kwd)[:2])
                got["plain"].append(inference.detect_and_decode(
                    sp, fc, att, sw, **kwd, use_kernels=False)[:2])
                with _v1_exact_tanh(fa):
                    got["tanhf"].append(inference.detect_and_decode(
                        sp, fc, att, sw, **kwd)[:2])
        cat = {k: [torch.cat([r[i] for r in v]) for i in (0, 1)]
               for k, v in got.items()}
        eq, dscore = _top_beams_vs_plain(*cat["kernel"], *cat["plain"])
        eq_t, _ = _top_beams_vs_plain(*cat["tanhf"], *cat["plain"])
        share, share_t = float(eq.float().mean()), float(
            eq_t.float().mean())
        gate = math.floor(100 * share_t + 1e-9) / 100
        vs_plain[tag] = {"images": int(eq.numel()),
                         "top_beam_identical": share,
                         "top_beam_identical_tanhf": share_t,
                         "max_score_diff": dscore, "gate": gate}
        _check(share >= gate, f"train_rl bf16 dump against the plain "
               f"path: {vs_plain[tag]}")
    out["dump_vs_plain"] = vs_plain
    out["dump_ms"] = dump_ms
    out["dump_captions_per_s"] = RL_BS / dump_ms * 1e3

    # 9. ms an RL fact step (rl_bs 40 + the seq2seq batch of 80, the
    # default dropout and scheduled sampling; host clock, median of 5
    # after one warm-up), f32 and bf16 (the bf16 detector), its device
    # time and idle share (the profiler over 5 steps)
    timing = {}
    for tag, cdt in (("f32", "float32"), ("bf16", "bfloat16")):
        rt_ = common.Runtime(Opts(device=str(dev), compute_dtype=cdt))
        params = nn.tree_map(lambda x: x.requires_grad_(True),
                             rt_.cast(nn.tree_map(torch.clone, cap0)))
        rl = steps.make_rl_steps(settings, optim.Adam(params, RL_LR),
                                 ids, T, tables)
        fz = steps.RLModels(
            (cast_bf16(trained["detector"]) if tag == "bf16"
             else trained["detector"]), rt_.cast(trained["classifier"]))
        bb, ss = rt_.put(batch), rt_.put(scs_b)
        gen = torch.Generator(device=dev).manual_seed(0)

        def one():
            return rl[("fact", True)](fz, bb, ss, gen)
        ms = wall_ms(one)
        by_kernel = device_ms_by_kernel(one, iters=5, warm=1)
        busy = sum(by_kernel.values())
        timing[tag] = {
            "train_step_ms": ms, "device_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / ms),
            "top_kernels_ms": dict(sorted(
                by_kernel.items(), key=lambda kv: -kv[1])[:6])}
    out["timing"] = timing
    f32_opts = runs["f32"]["opts"]
    out["files"] = {"root": tmp, "checkpoint": f32_opts.checkpoint,
                    "composite": stage(f32_opts, "model_0.ckpt"),
                    "detector": det_file}
    res_dir = os.path.join(f32_opts.result_dir, "rl", "coco", "part")
    results = {}
    for name in sorted(os.listdir(res_dir)):
        with open(os.path.join(res_dir, name), "rb") as f:
            results[name] = f.read()
    s_stores = [common.open_store(common.sniff_store_path(os.path.join(
        o.feats_dir, "sentiment", f"feats_{kind}.h5")))
        for kind in ("fc", "att")]
    s_loader = common.rl_senti_loader(
        *s_stores, senti_imgs, cpts_id, sentis_id,
        {c: i for i, c in enumerate(cats)}, vocab, o, RL_BS)
    host_free = [{k: v for k, v in b_.items() if k not in common.HOST_KEYS}
                 for b_ in (batch, s_loader.assemble(
                     s_loader._index_batches()[0]), scs_b)]
    keep.update(opts=f32_opts, metrics=runs["f32"]["metrics"],
                composite=saved[stage(f32_opts, "model_0.ckpt")],
                results=results, v1_launches=runs["f32"]["launches"][
                    "beam_content_attention"],
                inputs=dict(zip(("fact", "senti", "scs"), host_free),
                            caps_id=caps_id))
    smi = _smi()
    ep = out["epochs"]
    print(f"train_rl (phase 3h, full width, vocab {VOCAB}, rl_bs {RL_BS}, "
          f"seq2seq {train_rl.SCS_BS}, beam {BEAM}): tree "
          f"{out['tree_s']:.1f} s; CIDEr-D tables {out['tables']['images']} "
          f"images, {out['tables']['ngrams']} n-grams, "
          f"{out['tables']['bytes']} bytes, built in "
          f"{out['tables']['build_s']:.3f} s; " + "; ".join(
              f"{tag} epoch {r['metrics'][0]['epoch']} {r['s']:.1f} s, val "
              f"cap/xe loss {r['metrics'][0]['val_cap_loss']:.4f}/"
              f"{r['metrics'][0]['val_xe_loss']:.4f}, fact reward "
              f"{r['metrics'][0]['val_fact_reward']:.4f}, wrong rate "
              f"{r['metrics'][0]['det_sentis_wrong_rate']:.3f}, v1 "
              f"{r['launches']['beam_content_attention']} = decode steps, "
              f"Winograd {[r['launches'][k] for k in wino]} = bf16 detector "
              f"calls {r['calls']['detector_bf16']}" for tag, r in ep.items())
          + f"; eval_cls_rnn {out['cls_acc']}")
    cv, cc = out["cider_vs_host"], out["card_vs_cpu"]
    print(f"train_rl device CIDEr-D against the host scorer on {cv['rows']} "
          f"rows (sample, greedy, ground truth; means "
          f"{cv['mean_sample']:.4f}/{cv['mean_greedy']:.4f}/"
          f"{cv['mean_ground_truth']:.4f}): max rel {cv['max_rel']:.3g} "
          f"(tolerance 2e-5); the reward's device time "
          f"{out['reward_device_ms']:.4f} ms at rl_bs {RL_BS} on {smi}")
    print(f"train_rl card step against the CPU's (dropout off, forced "
          f"draw): f32 losses max rel {cc['losses_max_rel']:.3g} (cap_loss "
          f"{cc['losses_card']['cap_loss']:.6f} vs "
          f"{cc['losses_cpu']['cap_loss']:.6f}), params max |diff - Adam's "
          f"first update of each side's gradient| "
          f"{cc['params_max_abs_f32']:.3g}, gradients max |diff|/|CPU's| "
          f"{cc['grad_max_rel_f32']:.3g} ({cc['grad_max_rel_leaf_f32']}; "
          f"against f64: card {cc['grad_f32_vs_f64_card'][0]:.3g} "
          f"({cc['grad_f32_vs_f64_card'][1]}), CPU "
          f"{cc['grad_f32_vs_f64_cpu'][0]:.3g} "
          f"({cc['grad_f32_vs_f64_cpu'][1]})); f64 gradients max "
          f"|diff|/|CPU's| {cc['grad_max_rel_f64']:.3g} "
          f"({cc['grad_max_rel_leaf_f64']}, tolerance {XE_GRAD_RTOL})")
    db = out["detector_bf16"]
    print(f"train_rl bf16 detector on {db['images']} images: logits kernels "
          f"vs plain twins max |diff| "
          f"{db['logits_kernels_vs_twins_max_abs_err']:.4g} (scale "
          f"{db['logits_scale']:.4g}); labels against f32 " + ", ".join(
              f"{k} {v:.4f}" for k, v in db["labels"].items()))
    for tag, r in out["dump_vs_plain"].items():
        print(f"train_rl {tag} dump against the plain path: top beams "
              f"identical {r['top_beam_identical']:.2%} of {r['images']}"
              + (f" (v1 tanhf {r['top_beam_identical_tanhf']:.2%}, gate "
                 f"{r['gate']:.2f})" if "gate" in r else "")
              + f", score diff {r['max_score_diff']:.3g}")
    print(f"train_rl dump on {smi}: {out['dump_ms']:.2f} ms a batch of "
          f"{RL_BS} -> {out['dump_captions_per_s']:.1f} captions/s")
    for tag, r in out["timing"].items():
        print(f"train_rl {tag} on {smi}: {r['train_step_ms']:.2f} ms an RL "
              f"fact step (median of 5; device {r['device_ms']:.2f} ms, idle "
              f"share {r['idle_share']:.3f}; largest: " + ", ".join(
                  f"{k[:40]} {v:.3f}" for k, v in
                  list(r["top_kernels_ms"].items())[:3]) + ")")
    out["device"] = smi
    return out


@contextlib.contextmanager
def _patched(obj, **attrs):
    """``obj``'s attributes set to ``attrs`` for the block, restored on
    exit."""
    saved = {k: getattr(obj, k) for k in attrs}
    for k, v in attrs.items():
        setattr(obj, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(obj, k, v)


def _timed(fn, seconds, key, results=None):
    """``fn`` that adds its host seconds to ``seconds[key]`` (and keeps its
    return value in ``results[key]``)."""
    def wrapped(*args, **kw):
        t0 = time.perf_counter()
        try:
            r = fn(*args, **kw)
            if results is not None:
                results[key] = r
            return r
        finally:
            seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0
    return wrapped


def _resnet_state_dict(enc):
    """The encoder's params as a torchvision ResNet-101 state dict (OIHW
    convs, BatchNorm weight / bias / running_mean / running_var), CPU
    tensors: what ``encoder.convert_torch_state_dict`` reads."""
    sd = {}

    def conv(name, p):
        sd[name + ".weight"] = p["weight"].detach().cpu().permute(
            3, 2, 0, 1).contiguous()

    def bn(name, p):
        for ours, theirs in (("scale", "weight"), ("bias", "bias"),
                             ("mean", "running_mean"),
                             ("var", "running_var")):
            sd[f"{name}.{theirs}"] = p[ours].detach().cpu().clone()
    conv("conv1", enc["conv1"])
    bn("bn1", enc["bn1"])
    for li, layer in enumerate(enc["layers"]):
        for b, blk in enumerate(layer):
            base = f"layer{li + 1}.{b}"
            for k in (1, 2, 3):
                conv(f"{base}.conv{k}", blk[f"conv{k}"])
                bn(f"{base}.bn{k}", blk[f"bn{k}"])
            if "downsample" in blk:
                conv(base + ".downsample.0", blk["downsample"]["conv"])
                bn(base + ".downsample.1", blk["downsample"]["bn"])
    return sd


def _same_tree(torch, a, b):
    """Two param trees with the same paths, dtypes and bits."""
    pa, pb = _tree_paths(a), _tree_paths(b)
    return [p for p, _ in pa] == [p for p, _ in pb] and all(
        x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
        for (_, x), (_, y) in zip(pa, pb))


def _shift_test_features(torch, np, dev, det, tree, write_store):
    """Give the captioned test images of phase 3h's tree the sentiment
    images' class shift (``synthetic.build_tree``: 2.0 on the k-th third
    of the channels), image i (by name) taking class i % 3, so that the
    dump's fact split, like its sentiment split, holds captions of every
    sentiment and cls% and ppl have their inputs (on noise features a
    detector tends to give one label). Checks that ``det`` (the trained
    detector) then detects all three; returns its labels' counts."""
    from insenticap_model_tpu_torch.data.feature_store import open_store
    from insenticap_model_tpu_torch.models import sentiment_detector as sd
    path = os.path.join(tree, "features/coco/coco_att.isc")
    store = open_store(path)
    rows = {fn: store.get(fn) for fn in store.keys()}
    del store
    tests = sorted(fn for fn in rows if fn.startswith("test_"))
    third = next(iter(rows.values())).shape[-1] // 3
    for i, fn in enumerate(tests):
        k = i % 3
        rows[fn] = rows[fn].copy()
        rows[fn][..., k * third:(k + 1) * third] += 2.0
    write_store(path, rows.items(), next(iter(rows.values())).shape,
                dtype="float32")
    with torch.no_grad():
        att = torch.from_numpy(np.stack([rows[fn] for fn in tests]))
        labels = sd.sample(det, att.to(dev), 0.7, 2)[0].cpu().numpy()
    counts = np.bincount(labels, minlength=3).tolist()
    _check(min(counts) > 0, f"the shifted test images' detected labels "
           f"{counts}: not every sentiment")
    return counts


def _f32_score_gaps(torch, cap32, settings, base, kernel, plain):
    """The captions on which two bf16 dumps (``kernel``, ``plain``: the
    batches ``recording_dd`` kept) part, each scored by the f32 captioner
    ``cap32`` on the f32 dump's (``base``) features: the teacher-forced sum
    of log-probabilities through the first EOS, under each dump's own
    detected label. [{"kernel", "plain", "gap" (kernel - plain),
    "bf16_rounding" (one bf16 ulp of each step's log-probability, summed
    over both captions)}]."""
    from insenticap_model_tpu_torch.models import captioner as cap
    out = []
    with torch.no_grad():
        for b32, bk, bp in zip(base, kernel, plain, strict=True):
            _check(torch.equal(b32["sentis"], bk["sentis"]),
                   "the f32 and bf16 dumps' batches differ")
            rows = (bk["seqs"] != bp["seqs"]).any(1).nonzero()[:, 0]
            if len(rows) == 0:
                continue
            scores = []
            for run in (bk, bp):
                ids = run["ids"]
                seqs = run["seqs"][rows].long()
                ctx = cap.build_visual_context(
                    cap32, b32["fc"][rows].float(), b32["att"][rows].float(),
                    senti_words=run["sentis"][rows],
                    senti_labels=run["labels"][rows], pad_id=ids.pad)
                sos = torch.full_like(seqs[:, :1], ids.sos)
                lp = cap._teacher_forced_scan(
                    cap32, ctx, torch.cat([sos, seqs], 1), mode="rl",
                    dropout_p=0.0, gen=None, ss_prob=0.0, deterministic=True,
                    hid_dim=settings.rnn_hid_dim)
                tok = lp.gather(2, seqs[..., None])[..., 0].double()
                eos = (seqs == ids.eos).long()
                keep = (eos.cumsum(1) - eos) == 0
                ulp = torch.ldexp(torch.ones_like(tok),
                                  torch.frexp(tok).exponent - 8)
                scores.append(((tok * keep).sum(1),
                               (ulp * (tok != 0) * keep).sum(1)))
            for j in range(len(rows)):
                k_, p_ = float(scores[0][0][j]), float(scores[1][0][j])
                out.append({"kernel": k_, "plain": p_, "gap": k_ - p_,
                            "bf16_rounding": float(scores[0][1][j]
                                                   + scores[1][1][j])})
    return out


def _offline_clis(torch, np, dev, settings, enc32, zero_counters,
                  read_counters, files, keep):
    """Phase 3i: the offline and evaluation CLIs on phase 3h's tree and
    checkpoints (``files``), nothing trained again. ``preprocess``'s text
    stages on a caption dataset and a sentiment corpus in the reference's
    schemas (the tree's captions), its LMs through ``isclm``;
    ``preprocess features`` (ResNet-101 from a reference-named ``.pth``,
    f32, the pool kernel) on 40 images; ``convert_checkpoint`` of the RL
    composite written as a reference ``.pth``, and of the ResNet-101;
    ``reproduce_table`` on the ``.ckpt`` and the ``.pth``, in f32 against
    the plain path and in bf16 (the Winograd kernels); ``eval_metrics``,
    ``eval_ppl`` and ``eval_senti`` as CLIs. The CLIs read ``./data/...``
    below their working directory, so the phase runs in a directory of its
    own under the tree. Into ``keep`` go what phase 3l's ``reproduce_table``
    runs reuse: the working directory, the bf16 run's options and its
    dump directory."""
    import functools
    import io
    import types
    import zlib
    from insenticap_model_tpu_torch import convert, inference
    from insenticap_model_tpu_torch import preprocessing as pp
    from insenticap_model_tpu_torch.cli import (
        convert_checkpoint, eval_cls_rnn, eval_metrics, eval_ppl,
        eval_senti, preprocess)
    from insenticap_model_tpu_torch.cli import reproduce_table as repro
    from insenticap_model_tpu_torch.config import Opts
    from insenticap_model_tpu_torch.data.feature_store import (
        open_store, write_native_store)
    from insenticap_model_tpu_torch.models import sentiment_detector as sd
    from insenticap_model_tpu_torch.ops import fused_attention as fa
    from insenticap_model_tpu_torch.ops import fused_topk as ft
    from insenticap_model_tpu_torch.ops import winograd_kernels as wk
    from insenticap_model_tpu_torch.rewards.meteor import Meteor
    from insenticap_model_tpu_torch.training import checkpoint as tck
    cats = ["positive", "negative", "neutral"]
    wino = ("wino_input", "wino_middle", "wino_output")
    root = files["root"]
    tree = os.path.join(root, "data")
    work = os.path.join(root, "offline")
    os.makedirs(work)
    out, home, t_phase = {}, os.getcwd(), time.time()
    log, quiet = io.StringIO(), contextlib.ExitStack()
    os.chdir(work)
    try:
        # the CLIs' own print-outs go to chiprun_out/offline_clis.log
        quiet.enter_context(contextlib.redirect_stdout(log))
        # 1. the text stages: a caption dataset (the tree's captions, and
        # the sentiment test images with train images' captions, so that
        # the anno captions cover both test splits) and a sentiment corpus
        # in the reference's schemas; senti_labels over image names
        with open(os.path.join(tree, "captions/coco/img_captions.json")) as f:
            tree_caps = json.load(f)
        with open(os.path.join(tree, "captions/img_senti_labels.json")) as f:
            senti_test = [fn for fn, _ in json.load(f)["test"]]

        def sents(caps):
            return [{"raw": " ".join(c).capitalize() + "."} for c in caps]
        images = [{"filename": fn, "split": split, "sentences": sents(cs)}
                  for split, by_fn in tree_caps.items()
                  for fn, cs in by_fn.items()]
        train = list(tree_caps["train"].values())
        images += [{"filename": fn, "split": "test",
                    "sentences": sents(train[i % len(train)])}
                   for i, fn in enumerate(senti_test)]
        os.makedirs("datasets")
        with open("datasets/dataset_coco.json", "w") as f:
            json.dump({"images": images}, f)
        rng = np.random.default_rng(11)
        adjs = {"positive": ("happy", "nice", "good"),
                "negative": ("sad", "ugly", "bad")}
        corpus = {senti: [
            f"The {a[int(rng.integers(3))]} {n} {v} near the "
            f"{('red', 'blue')[int(rng.integers(2))]} tree."
            for n, v in zip(rng.choice(["cat", "dog", "man"], 600),
                            rng.choice(["runs", "sits"], 600))]
            for senti, a in adjs.items()}
        os.makedirs("data/corpus/part")
        with open("data/corpus/part/senti_corpus.json", "w") as f:
            json.dump(corpus, f)
        os.makedirs("senti_imgs")
        for senti, n in (("positive", 260), ("negative", 240),
                         ("neutral", 150)):
            for i in range(n):
                open(f"senti_imgs/{senti}_{i}.jpg", "w").close()
        flags = ["--caption_datasets_dir", "datasets", "--dataset_names",
                 "coco", "--captions_dir", "data/captions", "--corpus_dir",
                 "data/corpus", "--senti_imgs_dir", "senti_imgs",
                 "--img_senti_labels", "data/captions/img_senti_labels.json"]
        stage_s, lm_s = {}, {}

        def run_lm(cmd, **kw):          # each LM trained, timed apart
            return _timed(subprocess.run, lm_s,
                          os.path.basename(cmd[-1]))(cmd, **kw)
        stages = ("process_caption_datasets", "process_senti_corpus",
                  "build_idx2concept", "build_idx2word",
                  "get_senti_captions", "get_anno_captions", "get_lm_sents",
                  "get_img_senti_labels", "get_img_det_sentiments")
        with _patched(pp, subprocess=types.SimpleNamespace(run=run_lm),
                      **{k: _timed(getattr(pp, k), stage_s, k)
                         for k in stages}):
            preprocess.main(["corpus_all", *flags])
            preprocess.main(["senti_labels", *flags])
            with open(os.path.join(tree, "captions/coco/"
                                   "img_det_concepts.json")) as f:
                det_concepts = json.load(f)
            with open("data/captions/coco/img_det_concepts.json", "w") as f:
                json.dump(det_concepts, f)
            preprocess.main(["det_sentiments", *flags])
        written = sorted(os.path.join(d, n) for d, _, ns in os.walk("data")
                         for n in ns if n.endswith(".json"))
        for path in written:
            with open(path) as f:
                _check(json.load(f) is not None, f"{path} is empty")
        lms = [f"data/captions/coco/part/lm/{c}_w.sri" for c in cats]
        _check(all(os.path.getsize(p) > 0 for p in lms),
               f"preprocess lms: missing LMs among {lms}")
        with open("data/captions/coco/part/senti_captions.json") as f:
            n_senti_caps = {k: len(v) for k, v in json.load(f).items()}
        _check(set(n_senti_caps) == set(cats) and min(
            n_senti_caps.values()) > 0, f"senti_captions: {n_senti_caps}")
        out["text"] = {"stage_s": stage_s, "lm_s": lm_s,
                       "json_files": len(written),
                       "senti_captions": n_senti_caps}

        # 2. the features: the 32 fixtures the port decodes (the
        # progressive and CMYK JPEGs, Adam7 PNGs, GIFs, BMPs and lossless
        # WebPs among them) and 32
        # PNGs over the three buckets, through `preprocess features` with
        # ResNet-101 read from a reference-named .pth, f32, encode batches
        # of 32; the pool's launches against the batches flushed
        os.makedirs("images")
        for name, what in FIXTURES.items():
            if what == "decode":
                with open(os.path.join(FIXTURE_DIR, name), "rb") as src, \
                        open(os.path.join("images", name), "wb") as dst:
                    dst.write(src.read())
        sizes = [(448, 448), (480, 640), (640, 480), (500, 500), (300, 420),
                 (420, 300), (384, 512), (512, 384)]
        for i in range(PP_N_PNG):
            h, w = sizes[i % len(sizes)]
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            with open(f"images/gen{i:02d}.png", "wb") as f:
                f.write(_png_bytes(img, zlib))
        names = sorted(os.listdir("images"))
        by_bucket = {}
        for n in names:
            h, w = pp.load_image(os.path.join("images", n)).shape[:2]
            b = pp.bucket_for_shape(h, w, pp.DEFAULT_BUCKET_SHAPES)
            by_bucket[b] = by_bucket.get(b, 0) + 1
        flushes = sum(-(-n // PP_FEAT_BS) for n in by_bucket.values())
        pth = os.path.join(work, "resnet101.pth")
        torch.save(_resnet_state_dict(enc32), pth)
        feat_s, rows = {}, {}
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            with _patched(pp, extract_imgs_feat=_timed(
                    pp.extract_imgs_feat, feat_s, "kernel", rows)):
                zero_counters()
                preprocess.main(["features", "--imgs_dir", "images",
                                 "--feats_dir", "feats", "--resnet101_file",
                                 pth, "--feat_batch_size", str(PP_FEAT_BS),
                                 "--device", str(dev)])
                torch.cuda.synchronize()
                launches_pp = read_counters()
            # the same extraction with the pool's plain version on the card
            plain = _timed(pp.extract_imgs_feat, feat_s, "plain")(
                "images", "feats_plain", enc32, batch_size=PP_FEAT_BS,
                bucket_mode="resize", device=dev, use_kernels=False)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        got = {n: (fc, att) for n, fc, att in rows["kernel"]}
        _check(sorted(got) == names, "features: the images written differ "
               "from the images given")
        _check(launches_pp["ceil_maxpool_3x3s2"] == flushes and flushes > 0,
               f"preprocess features: pool launches "
               f"{launches_pp['ceil_maxpool_3x3s2']} != the {flushes} "
               f"encode batches flushed ({by_bucket})")
        for kind, i in (("fc", 0), ("att", 1)):
            store = open_store(f"feats/feats_{kind}.isc")
            _check(all(np.array_equal(store.get(n), got[n][i])
                       for n in names), f"feats_{kind}.isc does not read "
                   "back equal to the arrays extracted")
        _check(all(np.array_equal(got[n][0], fc) and
                   np.array_equal(got[n][1], att) for n, fc, att in plain),
               "features: fc/att through the pool kernel differ from the "
               "plain pool's on the card (the pool is exact)")
        fin = all(np.isfinite(v).all() for r in got.values() for v in r)
        _check(fin, "features: non-finite fc/att")
        # two images on the CPU: one at a bucket's shape, one resized
        os.makedirs("images_cpu")
        two = ["j420_448.jpg", "gen03.png"]
        for n in two:
            with open(os.path.join("images", n), "rb") as src, \
                    open(os.path.join("images_cpu", n), "wb") as dst:
                dst.write(src.read())
        t0 = time.time()
        cpu = pp.extract_imgs_feat("images_cpu", "feats_cpu", enc32,
                                   batch_size=2, bucket_mode="resize",
                                   device="cpu")
        cpu_s = time.time() - t0
        cpu_err = {}
        for n, fc, att in cpu:
            for kind, a, b in (("fc", fc, got[n][0]), ("att", att,
                                                       got[n][1])):
                cpu_err[f"{n} {kind}"] = float(
                    np.abs(a - b).max() / np.abs(b).max())
        _check(max(cpu_err.values()) <= PP_CPU_TOL,
               f"features on the CPU against the card's: {cpu_err} "
               f"(tolerance {PP_CPU_TOL} of the largest magnitude)")
        out["features"] = {
            "images": len(names), "by_bucket": {
                f"{h}x{w}": n for (h, w), n in by_bucket.items()},
            "flushes": flushes, "launches": launches_pp,
            "s": feat_s["kernel"], "plain_s": feat_s["plain"],
            "images_per_s": len(names) / feat_s["kernel"],
            "cpu_rel_err": cpu_err, "cpu_s": cpu_s}

        # 3. convert_checkpoint: phase 3h's composite as a reference .pth
        # (reference names and settings), converted with `detector` onto
        # the card, reads back bit-identical; the ResNet-101 .pth too
        composite, meta = tck.load(files["composite"], device=dev)
        ref_settings = {k: v for k, v in meta["settings"].items() if k in (
            "word_emb_dim", "fc_feat_dim", "att_feat_dim", "feat_emb_dim",
            "dropout_p", "rnn_hid_dim", "att_hid_dim", "sentiment_convs_num",
            "sentiment_fcs_num")}
        ref_settings["concept_mid_him"] = meta["settings"]["concept_mid_dim"]
        t0 = time.time()
        ref_sd = convert.reference_state_dict("detector", composite)
        torch.save({"model": ref_sd,
                    "settings": ref_settings, "idx2word": meta["idx2word"],
                    "sentiment_categories": meta["sentiment_categories"],
                    "dataset_name": "coco", "corpus_type": "part",
                    "max_seq_len": meta["max_seq_len"],
                    "epoch": meta["epoch"]}, "rl.pth")
        convert_checkpoint.main(["detector", "rl.pth", "rl.ckpt",
                                 "--device", str(dev)])
        convert_checkpoint.main(["resnet101", pth, "resnet101.ckpt",
                                 "--device", str(dev)])
        conv_s = time.time() - t0
        back, back_meta = tck.load("rl.ckpt", device=dev)
        _check(_same_tree(torch, back, composite),
               "convert_checkpoint detector: the .ckpt does not read back "
               "bit-identical to phase 3h's composite")
        _check(back_meta["settings"] == ref_settings
               and back_meta["kind"] == "detector",
               f"convert_checkpoint detector: metadata {back_meta}")
        _check(_same_tree(torch, tck.load("resnet101.ckpt", device=dev)[0],
                          enc32), "convert_checkpoint resnet101: the .ckpt "
               "does not read back bit-identical to the encoder's params")
        out["convert"] = {"s": conv_s, "bytes": {
            k: os.path.getsize(k) for k in ("rl.pth", "rl.ckpt",
                                            "resnet101.ckpt")}}
        del back, composite

        # 4. reproduce_table at rl_bs 40, beam 3 with the anno captions and
        # the LMs of step 1, the captioned test images shifted as the
        # sentiment images are, so that phase 3g's detector (inside the
        # composite) detects all three sentiments: on the .ckpt and the
        # .pth, the plain path, and bf16 (kernels, plain path, v1 with
        # tanhf); each run's launches with the dump's decode steps and the
        # bf16 detector's calls
        composite, _ = tck.load(files["composite"], device=dev)
        out["test_labels"] = _shift_test_features(
            torch, np, dev, composite["senti_detector"], tree,
            write_native_store)
        del composite
        anno = os.path.join(work, "data/captions/coco/anno_captions.json")
        calls = {"decode_steps": 0, "detector_bf16": 0}
        # the bf16 kernel run's detector inputs, held against the plain
        # twins below
        rec = {"on": False, "inputs": []}
        orig_tail, orig_fwd = ft.classifier_topk_plain, sd.forward
        orig_dd = inference.detect_and_decode

        def counting_tail(*args, **kw):
            calls["decode_steps"] += 1
            return orig_tail(*args, **kw)

        def counting_fwd(params, features, **kw):
            if features.dtype == torch.bfloat16 and features.is_cuda:
                calls["detector_bf16"] += 1
                if rec["on"]:
                    rec["inputs"].append((params, features.clone(), kw))
            return orig_fwd(params, features, **kw)

        def repro_opts(tag, dtype):
            return dict(settings=settings, rl_bs=RL_BS, beam_size=BEAM,
                        max_seq_len=T, compute_dtype=dtype, device=str(dev),
                        captions_dir=os.path.join(tree, "captions"),
                        feats_dir=os.path.join(tree, "features"),
                        checkpoint=files["checkpoint"],
                        img_senti_labels=os.path.join(
                            tree, "captions/img_senti_labels.json"),
                        result_dir=os.path.join(work, "res_" + tag))
        keep.update(work=work, model=files["composite"], anno=anno,
                    bf16_opts=repro_opts("bf16", "bfloat16"),
                    bf16_dump=os.path.join(work, "res_bf16", "rl", "coco",
                                           "part"))

        def reproduce(tag, model, dtype="float32", plain=False,
                      tanhf=False):
            parts = {}
            o = Opts(**repro_opts(tag, dtype))
            dd = functools.partial(orig_dd, use_kernels=False) if plain \
                else orig_dd
            # each dump batch's inputs and top beams, for the f32 scores
            # of the captions the bf16 paths part on
            served = []

            def recording_dd(params, fc, att, sentis, **kw):
                res = dd(params, fc, att, sentis, **kw)
                served.append({"fc": fc, "att": att, "sentis": sentis,
                               "seqs": res[0][:, 0].clone(),
                               "labels": res[2].clone(), "ids": kw["ids"]})
                return res
            with contextlib.ExitStack() as stack:
                stack.enter_context(_patched(
                    repro, load_composite=_timed(repro.load_composite,
                                                 parts, "load"),
                    run_test_dump=_timed(repro.run_test_dump, parts,
                                         "dump")))
                stack.enter_context(_patched(
                    eval_metrics, compute_metrics=_timed(
                        eval_metrics.compute_metrics, parts, "metrics")))
                stack.enter_context(_patched(
                    eval_cls_rnn, compute_cls=_timed(
                        eval_cls_rnn.compute_cls, parts, "cls")))
                stack.enter_context(_patched(
                    eval_ppl, compute_ppl=_timed(eval_ppl.compute_ppl,
                                                 parts, "ppl")))
                stack.enter_context(_patched(
                    ft, classifier_topk_plain=counting_tail))
                stack.enter_context(_patched(sd, forward=counting_fwd))
                stack.enter_context(_patched(
                    inference, detect_and_decode=recording_dd))
                if tanhf:
                    stack.enter_context(_v1_exact_tanh(fa))
                calls.update(decode_steps=0, detector_bf16=0)
                rec["on"] = tag == "bf16"
                zero_counters()
                t0 = time.time()
                table = repro.reproduce(o, model, tag=tag, anno_file=anno,
                                        out=os.path.join(work,
                                                         f"{tag}.json"))
                torch.cuda.synchronize()
                s_ = time.time() - t0
                launches = read_counters()
                rec["on"] = False
            res_dir = os.path.join(o.result_dir, "rl", "coco", "part")
            caps = {}
            for n in os.listdir(res_dir):
                if n.startswith(f"result_{tag}_") and n.endswith(
                        ("_fact.json", "_senti.json")) and \
                        "_sentis_" not in n:
                    with open(os.path.join(res_dir, n)) as f:
                        for r in json.load(f):
                            caps[n.rsplit("_", 1)[1], r["image_id"]] = \
                                r["caption"]
            return {"table": table, "s": s_, "parts_s": parts,
                    "launches": launches, "calls": dict(calls),
                    "captions": caps,
                    "served": served if tag in ("ckpt", "bf16", "bf16_plain")
                    else []}
        runs = {"ckpt": reproduce("ckpt", files["composite"]),
                "pth": reproduce("pth", "rl.pth"),
                "plain": reproduce("plain", files["composite"], plain=True),
                "bf16": reproduce("bf16", files["composite"], "bfloat16"),
                "bf16_plain": reproduce("bf16_plain", files["composite"],
                                        "bfloat16", plain=True),
                "bf16_tanhf": reproduce("bf16_tanhf", files["composite"],
                                        "bfloat16", tanhf=True)}
        t32 = runs["ckpt"]["table"]
        for d in t32["splits"].values():
            _check(d["quality"] and d["cls"] is not None
                   and d["ppl"] is not None,
                   f"reproduce f32: a column is null: {d}")
        _check(runs["pth"]["table"] == t32, "reproduce f32: the .pth's "
               "table differs from the .ckpt's")
        _check(runs["plain"]["table"] == t32, "reproduce f32: the kernel "
               "path's table differs from the plain path's")
        _check(runs["plain"]["captions"] == runs["ckpt"]["captions"],
               "reproduce f32: the dump differs from the plain path's")
        for tag, r in runs.items():
            n, c = r["launches"], r["calls"]
            v1 = 0 if tag.endswith("plain") else c["decode_steps"]
            _check(n["beam_content_attention"] == v1 and c["decode_steps"]
                   > 0, f"reproduce {tag}: v1 launches "
                   f"{n['beam_content_attention']}, decode steps "
                   f"{c['decode_steps']}")
            want = c["detector_bf16"] if tag in ("bf16", "bf16_tanhf") \
                else 0
            _check([n[k] for k in wino] == [want] * 3 and (want > 0) == (
                tag in ("bf16", "bf16_tanhf")),
                f"reproduce {tag}: Winograd launches {[n[k] for k in wino]}"
                f", bf16 detector calls {c['detector_bf16']}")
        plain16 = runs["bf16_plain"]["captions"]

        def share(tag):
            caps = runs[tag]["captions"]
            return sum(caps.get(k) == v for k, v in plain16.items()) \
                / len(plain16)
        same, same_t = share("bf16"), share("bf16_tanhf")
        gate = math.floor(100 * same_t + 1e-9) / 100
        _check(same >= gate, f"reproduce bf16: captions identical to the "
               f"plain path's {same:.4f}, below v1 with tanhf's "
               f"{same_t:.4f} rounded down ({gate:.2f})")
        # is that share bf16's own? (a) the bf16 plain path against the
        # f32 one; (b) each caption the kernel and plain bf16 paths part
        # on, both scored in f32 (not a gate: a record)
        caps32 = runs["ckpt"]["captions"]
        plain_vs_f32 = sum(caps32.get(k) == v for k, v in plain16.items()) \
            / len(plain16)
        gaps = _f32_score_gaps(torch, tck.load(files["composite"],
                                               device=dev)[0]["captioner"],
                               settings, runs["ckpt"]["served"],
                               runs["bf16"]["served"],
                               runs["bf16_plain"]["served"])
        # the Winograd kernels on the dump's own bf16 detector batches
        # (the fact and senti test splits, rl_bs rows each) against their
        # plain twins: the logits within phase 3h's rounding (rtol 1e-2,
        # 1e-3 of the scale), the same labels, the same wrong rate as the
        # bf16 plain path's table
        ins = rec["inputs"]
        _check(len(ins) == runs["bf16"]["calls"]["detector_bf16"] == 2
               and all(f.shape[0] == RL_BS for _, f, _ in ins),
               f"reproduce bf16: detector batches "
               f"{[tuple(f.shape) for _, f, _ in ins]}")
        wino_err = []
        with torch.no_grad():
            for params, f, kw in ins:
                lk = orig_fwd(params, f, **kw)[0]
                with _wino_plain(wk):
                    lp = orig_fwd(params, f, **kw)[0]
                ok, err = _within_rounding(torch, lk, lp, 1e-2, 1e-3)
                _check(ok, "reproduce bf16: the dump's detector logits "
                       "through the Winograd kernels disagree with the "
                       "plain twins' (rtol 1e-2, 1e-3 of the scale): max "
                       f"|diff| {err:.4g}")
                _check(torch.equal(lk.argmax(-1), lp.argmax(-1)),
                       "reproduce bf16: the dump's detector labels through "
                       "the Winograd kernels differ from the plain twins'")
                wino_err.append(err)
        wr = {t: runs[t]["table"]["det_sentis_wrong_rate"]
              for t in ("bf16", "bf16_plain")}
        _check(wr["bf16"] == wr["bf16_plain"], f"reproduce bf16: "
               f"det_sentis_wrong_rate {wr} differs from the plain path's")
        del ins[:], lk, lp
        out["reproduce"] = {
            tag: {k: v for k, v in r.items() if k not in ("captions",
                                                          "served")}
            for tag, r in runs.items()}
        out["reproduce_bf16_vs_plain"] = {
            "captions": len(plain16), "identical": same,
            "identical_tanhf": same_t, "gate": gate,
            "wino_logits_max_abs_err": wino_err,
            "plain_bf16_identical_to_f32": plain_vs_f32,
            "f32_logprob_gaps": gaps}
        for r in runs.values():
            del r["served"]
        n_caps = len(runs["ckpt"]["captions"])
        out["dump_captions_per_s"] = n_caps / runs["ckpt"]["parts_s"]["dump"]
        out["meteor_mode"] = Meteor().mode

        # 5. the evaluation CLIs on those files (their ppl and BLEU-1 the
        # f32 table's); eval_senti on phase 3g's f32 detector with a
        # hand-labeled file the phase writes (the tree's captioned images,
        # labels in turn)
        prefix = os.path.join(work, "res_ckpt/rl/coco/part/result_ckpt")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            eval_metrics.main([prefix, "fact", anno])
            eval_ppl.main([prefix, "fact"])
        printed = buf.getvalue().splitlines()
        fact = t32["splits"]["fact"]
        ppl_line = next(x for x in printed if x.startswith("ppl scores: {"))
        bleu1 = next(x for x in printed if x.startswith("Bleu-1 ")).split()
        header = next(x for x in printed if x.startswith("Metric ")).split()
        _check(ppl_line == f"ppl scores: {fact['ppl']}" and bleu1[1:] == [
            f"{fact['quality'][c]['Bleu-1']:.1f}" for c in header[1:]],
            f"eval_metrics / eval_ppl disagree with reproduce's f32 table: "
            f"{printed}")
        fns = sorted(fn for by_fn in tree_caps.values() for fn in by_fn)
        labeled = {c: fns[i::3] for i, c in enumerate(cats)}
        os.makedirs("data/labeled_data")
        with open("data/labeled_data/at_most_one_disagree.json", "w") as f:
            json.dump(labeled, f)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            eval_senti.main(["--rl_senti_resume", files["detector"],
                             "--feats_dir", os.path.join(tree, "features"),
                             "--device", str(dev)])
        lines = buf.getvalue().splitlines()
        acc0 = float(lines[lines.index("THRESHOLD: 0.0") + 4].split(
            ": ")[1])
        det, _ = tck.load(files["detector"], device=dev)
        att = open_store(os.path.join(tree, "features/coco/coco_att.isc"))
        hits = n_all = 0
        with torch.no_grad():
            for i, c in enumerate(cats):
                x = torch.from_numpy(att.batch(labeled[c])).to(dev)
                hits += int((orig_fwd(det, x)[0].argmax(-1) == i).sum())
                n_all += len(labeled[c])
        _check(acc0 == hits / n_all and sum(
            x.startswith("THRESHOLD:") for x in lines) == 21,
            f"eval_senti: threshold-0 accuracy {acc0} != the share of "
            f"argmax labels matching the file {hits}/{n_all}")
        out["eval"] = {"eval_ppl": fact["ppl"], "eval_senti_acc_t0": acc0}
    finally:
        quiet.close()
        os.chdir(home)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "offline_clis.log"), "w") as f:
            f.write(log.getvalue())
    out["phase_s"] = time.time() - t_phase
    smi = _smi()
    tx, fe = out["text"], out["features"]
    print(f"offline CLIs (phase 3i): {out['phase_s']:.1f} s in all; text "
          "stages, s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in tx["stage_s"].items())
        + f"; {tx['json_files']} JSON files read back, senti_captions "
        f"{tx['senti_captions']}")
    print("offline CLIs LMs trained (isclm), s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(tx["lm_s"].items())))
    print(f"offline CLIs features on {smi}: {fe['images']} images "
          f"{fe['by_bucket']}, batch {PP_FEAT_BS}, f32: {fe['s']:.2f} s -> "
          f"{fe['images_per_s']:.1f} images/s (plain pool "
          f"{fe['plain_s']:.2f} s, fc/att equal); pool launches "
          f"{fe['launches']['ceil_maxpool_3x3s2']} = batches flushed "
          f"{fe['flushes']}; 2 images on the CPU ({fe['cpu_s']:.1f} s) max "
          f"rel err {max(fe['cpu_rel_err'].values()):.3g} (tolerance "
          f"{PP_CPU_TOL})")
    print(f"offline CLIs convert_checkpoint (detector, resnet101) "
          f"{out['convert']['s']:.2f} s with the .pth write, read back "
          f"bit-identical: {out['convert']['bytes']} bytes")
    for tag, r in out["reproduce"].items():
        n, c = r["launches"], r["calls"]
        print(f"offline CLIs reproduce {tag}: {r['s']:.2f} s (" + ", ".join(
            f"{k} {v:.3f}" for k, v in r["parts_s"].items())
            + f"); v1 launches {n['beam_content_attention']}, decode steps "
            f"{c['decode_steps']}; Winograd {[n[k] for k in wino]}, bf16 "
            f"detector calls {c['detector_bf16']}; wrong rate "
            f"{r['table']['det_sentis_wrong_rate']:.3f}")
    b16 = out["reproduce_bf16_vs_plain"]
    print(f"offline CLIs reproduce bf16 against the bf16 plain path: "
          f"captions identical {b16['identical']:.2%} of {b16['captions']} "
          f"(v1 tanhf {b16['identical_tanhf']:.2%}, gate {b16['gate']:.2f})"
          f"; the dump's bf16 detector batches ({RL_BS} rows) through the "
          f"Winograd kernels against the plain twins: logits max |diff| "
          f"{b16['wino_logits_max_abs_err']} (rtol 1e-2, 1e-3 of the "
          f"scale), labels equal")
    gaps = b16["f32_logprob_gaps"]
    inside = sum(abs(x["gap"]) <= x["bf16_rounding"] for x in gaps)
    print(f"offline CLIs reproduce bf16 plain path against the f32 path: "
          f"captions identical {b16['plain_bf16_identical_to_f32']:.2%}; "
          f"the {len(gaps)} captions where the bf16 kernel and plain paths "
          f"part, scored in f32 (sum of log-probabilities through EOS, "
          f"kernel minus plain): gaps "
          + ", ".join(f"{x['gap']:.4f}" for x in gaps)
          + f"; largest |gap| "
          f"{max([abs(x['gap']) for x in gaps] or [0.0]):.4f}; {inside} of "
          f"{len(gaps)} within bf16 rounding of the steps' log-probabilities"
          f" (budgets {min([x['bf16_rounding'] for x in gaps] or [0.0]):.4f}"
          f"-{max([x['bf16_rounding'] for x in gaps] or [0.0]):.4f})")
    for tag in ("ckpt", "bf16"):
        print(f"offline CLIs reproduce {tag} table:")
        repro._print_section6(out["reproduce"][tag]["table"])
    print(f"offline CLIs dump on {smi}: {out['dump_captions_per_s']:.1f} "
          f"captions/s; METEOR* mode: {out['meteor_mode']}; eval_senti "
          f"threshold-0 accuracy {out['eval']['eval_senti_acc_t0']:.4f}")
    out["device"] = smi
    return out


def _serving_kernel_checks(torch, device, settings, cap16):
    """Each serving kernel on ``device``'s tensors against its plain twin
    there, at the decode's and the detector's per-device shapes (RL_BS
    images, beam 3): {name: max_abs_err}; a disagreement fails the run.
    The caller picks the thread and its current device."""
    from insenticap_model_tpu_torch.ops import fused_attention as fa
    from insenticap_model_tpu_torch.ops import fused_topk as ft
    from insenticap_model_tpu_torch.ops import pool
    from insenticap_model_tpu_torch.ops import winograd_kernels as wk
    from insenticap_model_tpu_torch.utils.dtypes import to_device
    g = torch.Generator(device=device).manual_seed(21)
    bf16 = torch.bfloat16

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=device).to(bf16)
    p_cont = to_device(cap16["attention"]["cont"], device)
    cls = to_device(cap16["classifier"], device)
    H, Ah, Fe = (settings.rnn_hid_dim, settings.att_hid_dim,
                 settings.feat_emb_dim)
    errs = {}
    h, att, p_att = (rand(RL_BS * BEAM, H) * 2 - 1, rand(RL_BS, 196, Fe),
                     rand(RL_BS, 196, Ah))
    for variant in ("v1", "v2"):
        got = fa.beam_content_attention(h, p_cont, att, p_att, B=BEAM,
                                        variant=variant)
        want = fa.beam_content_attention_plain(h, p_cont, att, p_att, B=BEAM,
                                               variant=variant)
        ok, errs[f"attention_{variant}"] = _within_rounding(
            torch, got, want, 1e-2, 1e-3)
        _check(ok and got.device == device, f"attention {variant} on "
               f"{device} disagrees with its plain version")
    last = torch.randint(0, VOCAB, (RL_BS * BEAM,), generator=g,
                         device=device)
    args = (h, cls["weight"], cls["bias"], last)
    gv, gi = ft.classifier_topk(*args, k=BEAM, banned=BANNED)
    pv, pi = ft.classifier_topk_plain(*args, k=BEAM + 1, banned=BANNED)
    gv, gi, pv, pi = gv.cpu(), gi.cpu(), pv.cpu(), pi.cpu()
    errs["classifier_topk"] = float((gv - pv[:, :BEAM]).abs().max())
    swapped = (gi != pi[:, :BEAM]).nonzero().tolist()
    _check(errs["classifier_topk"] <= 1e-4 and all(
        min(abs(float(pv[r, j] - pv[r, q])) for q in (j - 1, j + 1)
            if 0 <= q <= BEAM) <= 1e-4 for r, j in swapped),
        f"classifier_topk on {device} disagrees with its plain version")
    x = rand(14, 14, RL_BS, 256)
    v = wk.wino_input(x)
    ok, errs["wino_input"] = _within_rounding(
        torch, v, wk.wino_input_plain(x), 1e-2, 1e-3)
    _check(ok, f"wino_input on {device} disagrees with its plain version")
    m, bias = rand(*v.shape) * 2 - 1, rand(256)
    for name, kern, twin in (("wino_middle", wk.wino_middle,
                              wk.wino_middle_plain),
                             ("wino_output", wk.wino_output,
                              wk.wino_output_plain)):
        ok, errs[name] = _within_rounding(
            torch, kern(m, bias, 14, 14), twin(m, bias, 14, 14), 1e-2, 1e-3)
        _check(ok, f"{name} on {device} disagrees with its plain version")
    xp = rand(4, 112, 112, 64)
    same = torch.equal(pool.ceil_maxpool_3x3s2_nhwc(xp),
                       pool.ceil_maxpool_3x3s2_plain(xp))
    errs["ceil_maxpool_3x3s2"] = 0.0 if same else float("inf")
    _check(same, f"the max pool on {device} differs from its plain version")
    torch.cuda.synchronize(device)
    return errs


def _launch_counters():
    """(zero, read): set the serving kernels' launch counts of this process
    to 0, and read them."""
    from insenticap_model_tpu_torch.ops import fused_attention as fa
    from insenticap_model_tpu_torch.ops import fused_topk as ft
    from insenticap_model_tpu_torch.ops import pool
    from insenticap_model_tpu_torch.ops import winograd_kernels as wk

    def zero():
        fa.beam_content_attention.launches = 0
        fa.beam_content_attention.launches_v2 = 0
        ft.classifier_topk.launches = 0
        for c in (wk.wino_input, wk.wino_middle, wk.wino_output,
                  pool.ceil_maxpool_3x3s2_nhwc):
            c.launches = 0

    def read():
        return {"beam_content_attention": fa.beam_content_attention.launches,
                "beam_content_attention_v2":
                fa.beam_content_attention.launches_v2,
                "classifier_topk": ft.classifier_topk.launches,
                "wino_input": wk.wino_input.launches,
                "wino_middle": wk.wino_middle.launches,
                "wino_output": wk.wino_output.launches,
                "ceil_maxpool_3x3s2": pool.ceil_maxpool_3x3s2_nhwc.launches}
    return zero, read


def _mesh_inputs(torch, card, settings):
    """Phase 3l(b)'s bs=384 inputs on ``card`` (fc, att, sentiment words),
    from a seeded generator of the card, so that phase 3m's process 0
    makes the same."""
    g = torch.Generator(device=card).manual_seed(33)
    fc = torch.rand(BS, settings.fc_feat_dim, generator=g, device=card)
    att = torch.rand(BS, 14, 14, settings.att_feat_dim, generator=g,
                     device=card)
    sw = torch.randint(4, VOCAB, (BS, M), generator=g, device=card)
    return fc, att, sw


def _in_thread(fn):
    """``fn()`` on a thread of its own (started fresh, its CUDA device
    never set unless ``fn`` sets it); its exception raises here."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 — raised below
            box["err"] = e
    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=900)
    _check(not th.is_alive(), "a kernel check's thread never returned")
    if "err" in box:
        raise box["err"]
    return box["out"]


def _dump_captions(res_dir):
    """{(split, image): (detected sentiment, caption)} of a bf16 dump's
    result_bf16_<sentiment>_<split>.json files."""
    caps = {}
    for n in os.listdir(res_dir):
        m = re.fullmatch(r"result_bf16_([a-z]+)_(fact|senti)\.json", n)
        if m:
            with open(os.path.join(res_dir, n)) as f:
                for r in json.load(f):
                    caps[m.group(2), r["image_id"]] = (m.group(1),
                                                       r["caption"])
    return caps


def _mesh_decode_batcher(torch, np, mesh2, settings, ids, cap32, det32,
                         phase3, zero_counters, read_counters, mp_keep):
    """Phase 3l(c): ``DynamicBatcher(mesh=mesh2)`` in bf16 on phase 3's
    requests (``phase3``: their features, labels, groups and phase 3's
    answers). Returns the record of the checks.

    On its default ladder every dispatched block must equal the one-device
    functions on that block bit for bit; its answers against phase 3's
    are recorded, not held, since a row's bf16 answer depends on the rows
    its products run with (cuBLAS may round 12 decode rows otherwise than
    24). On twice phase 3's ladder, where each block is phase 3's bucket,
    the answers must be phase 3's exactly. The default ladder's answers
    go into ``mp_keep["answers"]`` (phase 3m's two processes run the same
    blocks)."""
    from insenticap_model_tpu_torch import inference
    from insenticap_model_tpu_torch.serving_daemon import DynamicBatcher
    out = {}
    card = mesh2.devices[0]
    kw = dict(beam_size=BEAM, max_seq_len=T)
    wino = ("wino_input", "wino_middle", "wino_output")
    fcs, atts, sentis, forced, groups, results = phase3
    one_detect = inference.make_detect_fn(inference.SENTI_THRESHOLD,
                                          ids.neutral, settings)
    one_forced = inference.make_forced_serving_fn(settings, ids, **kw)

    def mesh_batcher(ladder, warm, record=None):
        db = DynamicBatcher(cap32, det32, settings=settings, ids=ids,
                            beam_size=BEAM, max_seq_len=T,
                            max_wait_s=0.25, num_sentiments=M,
                            num_cats=NUM_CATS, bucket_sizes=ladder,
                            compute_dtype="bfloat16", mesh=mesh2)
        try:
            with _switches("default"):
                db.warm(warm)
                if record is not None:      # each dispatch's blocks
                    for name in ("_detect", "_serve"):
                        def spy(*a, _f=getattr(db, name), _n=name):
                            res = _f(*a)
                            record.append((_n, a, res))
                            return res
                        setattr(db, name, spy)
                torch.cuda.synchronize()
                zero_counters()
                got, errors, serve_s = _serve(db, fcs, atts, sentis,
                                              forced, groups)
                launches = read_counters()
            return db._buckets, got, errors, serve_s, launches, \
                db.stats()
        finally:
            db.close()

    def differ_from_phase3(got):
        return [i for i, (a_, b_) in enumerate(zip(got, results))
                if not (np.array_equal(a_[0], b_[0])
                        and np.array_equal(a_[1], b_[1])
                        and a_[2] == b_[2])]
    record = []
    ladder, got_c, errors_c, serve_s, launches_c, stats_c = \
        mesh_batcher(None, [2, 8, 32], record)
    _check_results(got_c, errors_c)
    mp_keep.update(answers=got_c, by_bucket=stats_c["by_bucket"])
    _check(ladder == (2, 8, 32, 128, 384),
           f"mesh batcher's default ladder {ladder}")
    blocks_ok = n_blocks = 0
    with _switches("default"):
        for name, args, res in record:
            params, xs = args[0], args[1:]
            for i in range(mesh2.size):
                if name == "_detect":
                    want = (one_detect(params.trees[i], xs[0][i]),)
                    got_b = (res[i],)
                else:
                    want = one_forced(params.trees[i],
                                      *(x[i] for x in xs))
                    got_b = tuple(r[i] for r in res)
                n_blocks += 1
                blocks_ok += all(torch.equal(a_, b_)
                                 for a_, b_ in zip(got_b, want))
    differ = differ_from_phase3(got_c)
    top_differ = [i for i in differ if not np.array_equal(
        got_c[i][0][0], results[i][0][0]) or got_c[i][2] != results[i][2]]
    del record
    ladder2, got_2, errors_2, serve_2_s, _, stats_2 = mesh_batcher(
        (2, 16, 64, 256, 768), [2, 16, 64])
    _check_results(got_2, errors_2)
    differ_2 = differ_from_phase3(got_2)
    out.update({
        "serve_s": serve_s, "by_bucket": stats_c["by_bucket"],
        "launches": launches_c, "blocks": n_blocks,
        "blocks_bitwise": blocks_ok, "differ_from_phase3": differ,
        "top_beam_or_label_differ": top_differ,
        "doubled_ladder": {"by_bucket": stats_2["by_bucket"],
                           "serve_s": serve_2_s, "differ": differ_2}})
    print(f"sharded serving (c) DynamicBatcher(mesh=[{card}, {card}]) "
          f"bf16: default ladder {ladder}, {len(got_c)} requests of "
          f"phase 3 in {serve_s:.2f} s, batches by bucket "
          f"{stats_c['by_bucket']}, launches {launches_c}; "
          f"{blocks_ok} of {n_blocks} dispatched blocks bit for bit the "
          f"one-device functions on the block; answers differing from "
          f"phase 3's (buckets of 8 where these blocks are 4 rows): "
          f"{differ}, top beam or label among them: {top_differ}")
    print(f"sharded serving (c) on the ladder {ladder2} (blocks of "
          f"phase 3's buckets): batches by bucket {stats_2['by_bucket']}"
          f", answers differing from phase 3's one-device batcher: "
          f"{differ_2}")
    _check(n_blocks > 0 and blocks_ok == n_blocks, f"mesh batcher: "
           f"{n_blocks - blocks_ok} blocks differ from the one-device "
           "functions on them")
    _check(not differ_2, f"mesh batcher answers differ from the "
           f"one-device batcher's on requests {differ_2}")
    for k in ("beam_content_attention",) + wino:
        _check(launches_c[k] > 0, f"{k} never launched by the mesh "
               "batcher")
    return out


def _mesh_encode_batcher(torch, np, mesh2, settings, enc32, cpt32,
                         zero_counters, read_counters):
    """Phase 3l(d): ``EncodeBatcher(mesh=mesh2)`` in bf16 on 40 images
    against the one-device batcher. Returns the record of the checks.

    On the mesh's default ladder every block the workers ran must equal
    the one-device applies on that block bit for bit, and the pool
    launch once a block. Against the one-device batcher the features
    part by more than bf16's rounding of one layer, since a row's bf16
    features depend on the batch its convolutions run in (cuDNN's
    algorithm for 2 images is not its algorithm for 4) and 104 layers
    compound that: recorded, not held. Held exactly instead: on twice the
    one-device ladder, where the image groups (1, 3, 9 and 1 images a
    shape) put each image in a block of the one-device batch's size, fc,
    att and the concept ids equal the one-device batcher's."""
    from insenticap_model_tpu_torch.models import encoder
    from insenticap_model_tpu_torch.preprocessing import (
        DEFAULT_BUCKET_SHAPES)
    from insenticap_model_tpu_torch.serving.encode import make_cpt_apply
    from insenticap_model_tpu_torch.serving_daemon import (
        EncodeBatcher, default_encode_buckets)
    from insenticap_model_tpu_torch.utils.dtypes import cast_bf16
    out = {}
    card = mesh2.devices[0]
    rng = np.random.default_rng(61)
    imgs = [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
            for h, w in (DEFAULT_BUCKET_SHAPES[i % 3]
                         for i in range(40))]
    enc_groups = ([0], range(1, 10), range(10, 37), range(37, 40))
    enc16 = cast_bf16(enc32)
    enc_reps = mesh2.replicate(enc32).map(cast_bf16)
    one_enc = lambda x: encoder.forward_raw_batch(enc16, x)  # noqa: E731
    one_cpt = make_cpt_apply(cpt32, K_CONCEPTS)
    mesh_cpt = make_cpt_apply(mesh2.replicate(cpt32), K_CONCEPTS)
    record, lock = [], threading.Lock()

    def recorded(fn, name):          # each block the mesh's workers ran
        def wrapped(x):
            res = fn(x)
            with lock:
                record.append((name, x, res))
            return res
        return wrapped

    def run(mesh_, ladder, enc_apply, cpt_apply):
        eb = EncodeBatcher(enc_apply, cpt_apply,
                           fc_dim=settings.fc_feat_dim,
                           shape_buckets=DEFAULT_BUCKET_SHAPES,
                           batch_buckets=ladder, max_wait_s=0.05,
                           device=card, mesh=mesh_)
        try:
            eb.warm()
            torch.cuda.synchronize()
            zero_counters()
            res, errs, _ = _run_groups(
                lambda i: eb.submit_image(imgs[i], timeout=600),
                len(imgs), enc_groups)
            launches = read_counters()
            st = eb.stats()
        finally:
            eb.close()
        _check(not errs, f"encode requests failed (ladder {ladder}): "
               f"{errs}")
        return res, launches, st

    one_r, _, _ = run(None, default_encode_buckets(), one_enc, one_cpt)
    ladder = default_encode_buckets(mesh2)
    mesh_r, launches, st = run(mesh2, ladder, recorded(
        lambda x: encoder.forward_raw_batch(enc_reps.on(x.device), x),
        "enc"), recorded(mesh_cpt, "cpt"))
    blocks_ok, n_blocks = 0, len(record)
    for name, x, res in record:
        want = one_enc(x) if name == "enc" else (one_cpt(x),)
        got_b = res if name == "enc" else (res,)
        blocks_ok += all(torch.equal(a_, b_) for a_, b_ in zip(got_b, want))
    del record[:]
    groups = sum(st["by_bucket"][f"{h}x{w}"]
                 for h, w in DEFAULT_BUCKET_SHAPES)

    def compare(rows):
        """(images with fc and att bit for bit, images whose concept ids
        differ, the largest rms(diff) / rms of fc and att) against the
        one-device batcher's rows."""
        rms = lambda a: float(np.sqrt(np.mean(  # noqa: E731
            np.square(a, dtype=np.float64))))
        same = sum(np.array_equal(a_[0], b_[0]) and np.array_equal(
            a_[1], b_[1]) for a_, b_ in zip(rows, one_r))
        ids_differ = [i for i, (a_, b_) in enumerate(zip(rows, one_r))
                      if not np.array_equal(a_[2], b_[2])]
        rel = max(rms(a_[k] - b_[k]) / rms(b_[k])
                  for a_, b_ in zip(rows, one_r) for k in (0, 1))
        return same, ids_differ, rel
    same, ids_differ, rel = compare(mesh_r)
    ladder2 = tuple(2 * b for b in default_encode_buckets())
    mesh2_r, _, st2 = run(mesh2, ladder2, lambda x: encoder.forward_raw_batch(
        enc_reps.on(x.device), x), mesh_cpt)
    same2, ids_differ2, rel2 = compare(mesh2_r)
    out.update({"ladder": ladder, "by_bucket": st["by_bucket"],
                "launches": launches, "groups": groups, "blocks": n_blocks,
                "blocks_bitwise": blocks_ok, "features_bitwise": same,
                "ids_differ": ids_differ, "max_rms_rel": rel,
                "doubled_ladder": {"ladder": ladder2,
                                   "by_bucket": st2["by_bucket"],
                                   "features_bitwise": same2,
                                   "ids_differ": ids_differ2}})
    print(f"sharded serving (d) EncodeBatcher(mesh=[{card}, {card}]) bf16 "
          f"on {len(imgs)} images: ladder {ladder}, groups by bucket "
          f"{st['by_bucket']}, pool launches "
          f"{launches['ceil_maxpool_3x3s2']} (2 x {groups} groups); "
          f"{blocks_ok} of {n_blocks} blocks (warm-up included) bit for bit "
          f"the one-device applies on the block; against the one-device "
          f"batcher (a record): fc and att bit for bit on {same} images, "
          f"largest rms(diff)/rms {rel:.3g}, concept ids differing on "
          f"{ids_differ}")
    print(f"sharded serving (d) on the ladder {ladder2} (blocks of the "
          f"one-device batches): groups by bucket {st2['by_bucket']}; fc "
          f"and att bit for bit the one-device batcher's on {same2} of "
          f"{len(imgs)} images, concept ids differing on {ids_differ2}")
    _check(n_blocks > 0 and blocks_ok == n_blocks, f"mesh encode batcher: "
           f"{n_blocks - blocks_ok} blocks differ from the one-device "
           "applies on them")
    _check(launches["ceil_maxpool_3x3s2"] == 2 * groups > 0,
           f"pool launches {launches['ceil_maxpool_3x3s2']} != 2 x "
           f"{groups} encode groups")
    _check(same2 == len(imgs) and not ids_differ2, "mesh encode batcher "
           "on blocks of the one-device batches differs from the "
           "one-device batcher")
    return out


def _sharded_serving(torch, np, settings, ids, cap32, det32, enc32, cpt32,
                     phase3, serve_keep, offline_keep, zero_counters,
                     read_counters, mp_keep):
    """Phase 3l: one process serving on the devices of a ``DeviceMesh``:
    (a) the launch repair (kernels from a fresh thread, and on a second
    card while the first is current where there is one); (b) the sharded
    serving function over [card, card] at bs=384 in f32 and bf16, bit for
    bit the one-device function on each 192-row block, within the port's
    gate of it on all 384 rows, its launch counts; (c) the mesh
    DynamicBatcher on phase 3's requests against phase 3's answers; (d)
    the mesh EncodeBatcher against the one-device one on 40 images; (e)
    ``serve --mesh_shape [1]`` on phase 3e's checkpoints answering 3e's
    feature requests with 3e's JSON, ``[2]`` refused on one card; (f)
    ``reproduce_table`` at ``--mesh_shape [1]`` and on [card, card]
    writing phase 3i's bf16 dump files; (g) the bf16 bs=384 step on one
    device, on one 192-row block and on [card, card], in turns. Into
    ``mp_keep`` go what phase 3m compares with: the one-device function's
    rows, block by block, f32 and bf16 ((b)), and (c)'s answers."""
    import io
    from insenticap_model_tpu_torch import inference
    from insenticap_model_tpu_torch.cli import reproduce_table as repro
    from insenticap_model_tpu_torch.cli import serve as serve_cli
    from insenticap_model_tpu_torch.config import Opts
    from insenticap_model_tpu_torch.models import encoder
    from insenticap_model_tpu_torch.ops import fused_topk as ft
    from insenticap_model_tpu_torch.parallel import mesh as pmesh
    from insenticap_model_tpu_torch.preprocessing import (
        DEFAULT_BUCKET_SHAPES)
    from insenticap_model_tpu_torch.serving.encode import make_cpt_apply
    from insenticap_model_tpu_torch.serving_daemon import (
        DynamicBatcher, EncodeBatcher, default_encode_buckets)
    from insenticap_model_tpu_torch.utils.dtypes import cast_bf16
    out, t_phase = {}, time.time()
    card = torch.device("cuda", torch.cuda.current_device())
    cards = torch.cuda.device_count()
    cap16, det16 = cast_bf16(cap32), cast_bf16(det32)
    wino = ("wino_input", "wino_middle", "wino_output")

    # (a) the launch repair: every serving kernel from a fresh thread whose
    # device was never set; on cuda:1 while cuda:0 is current where a
    # second card is visible
    out["fresh_thread"] = _in_thread(
        lambda: _serving_kernel_checks(torch, card, settings, cap16))
    if cards > 1:
        def other_card():
            torch.cuda.set_device(0)
            return _serving_kernel_checks(torch, torch.device("cuda", 1),
                                          settings, cap16)
        out["cuda1_while_cuda0"] = _in_thread(other_card)
        print(f"sharded serving (a): the serving kernels on cuda:1 while "
              f"cuda:0 is current agree with their twins: "
              f"{out['cuda1_while_cuda0']}")
    else:
        print("sharded serving (a): one card is visible, so the check of "
              "the kernels on cuda:1 while cuda:0 is current did not run")
    print(f"sharded serving (a): the serving kernels from a fresh thread "
          f"(its device never set) agree with their twins: "
          f"{out['fresh_thread']}")

    mesh2 = pmesh.DeviceMesh([card, card])
    try:
        # (b) the sharded serving function at bs=384 against the one-device
        # function on each block (bit for bit) and on the whole batch (the
        # port's gate), with its launches
        fc, att, sw = _mesh_inputs(torch, card, settings)
        kw = dict(beam_size=BEAM, max_seq_len=T)
        one = inference.make_serving_fn(settings, ids, **kw)
        sharded = inference.make_sharded_serving_fn(mesh2, settings, ids,
                                                    **kw)
        steps, lock = {"n": 0}, threading.Lock()
        orig_tail = ft.classifier_topk_plain

        def counting_tail(*a, **k):       # a decode step, either block
            with lock:
                steps["n"] += 1
            return orig_tail(*a, **k)
        half = BS // 2
        out["function"] = {}
        for tag, params, dt in (
                ("f32", (cap32, det32), torch.float32),
                ("bf16", (cap16, det16), torch.bfloat16)):
            p = inference.ServingParams(*params)
            fcx, attx = fc.to(dt), att.to(dt)
            with _switches("default"), _patched(
                    ft, classifier_topk_plain=counting_tail):
                torch.cuda.synchronize()
                zero_counters()
                steps["n"] = 0
                got = sharded(mesh2.replicate(p), fcx, attx, sw)
                torch.cuda.synchronize()
                launches, n_steps = read_counters(), steps["n"]
                blocks = [one(p, fcx[i:i + half], attx[i:i + half],
                              sw[i:i + half]) for i in (0, half)]
                whole = one(p, fcx, attx, sw)
            bitwise = all(torch.equal(got[k][i * half:(i + 1) * half],
                                      blocks[i][k])
                          for k in range(3) for i in range(2))
            # phase 3m's lockstep path runs a block a process: its rows
            mp_keep["blocks_" + tag] = [
                torch.cat([blk[k] for blk in blocks]).cpu()
                for k in range(3)]
            eq = (got[0][:, 0] == whole[0][:, 0]).all(dim=1)
            rows_differ = int((got[0] != whole[0]).flatten(1).any(1).sum()
                              + (got[2] != whole[2]).sum())
            share = float(eq.float().mean())
            dscore = float((got[1][eq, 0].float() - whole[1][eq, 0].float())
                           .abs().max()) if eq.any() else float("inf")
            labels_eq = bool(torch.equal(got[2], whole[2]))
            want_wino = 2 if dt == torch.bfloat16 else 0
            out["function"][tag] = {
                "bitwise_vs_blocks": bitwise, "labels_equal": labels_eq,
                "top_beam_identical": share, "max_score_diff": dscore,
                "rows_differing_from_whole": rows_differ,
                "launches": launches, "decode_steps": n_steps}
            print(f"sharded serving (b) {tag} bs={BS} over [{card}, {card}]: "
                  f"bit for bit the one-device fn on each {half}-row block "
                  f"{bitwise}; against the whole batch: labels equal "
                  f"{labels_eq}, top beams identical {share:.2%}, max score "
                  f"diff on those {dscore:.3g}, rows differing "
                  f"{rows_differ} of {BS}; launches {launches}, decode "
                  f"steps of both blocks {n_steps}")
            _check(bitwise, f"sharded fn {tag}: not bit for bit the "
                   "one-device fn on its blocks")
            _check(labels_eq and share >= 0.99 and dscore <= 1e-3,
                   f"sharded fn {tag}: outside the gate of the one-device "
                   "fn on the whole batch")
            _check([launches[k] for k in wino] == [want_wino] * 3,
                   f"sharded fn {tag}: Winograd launches "
                   f"{[launches[k] for k in wino]} != {want_wino} each "
                   "(once a block a call in bf16)")
            _check(n_steps > 0 and launches["beam_content_attention"]
                   == n_steps, f"sharded fn {tag}: v1 launches "
                   f"{launches['beam_content_attention']} != decode steps "
                   f"{n_steps}")
        del got, blocks, whole

        # (c) the mesh decode batcher in bf16 on phase 3's requests
        out["batcher"] = _mesh_decode_batcher(
            torch, np, mesh2, settings, ids, cap32, det32, phase3,
            zero_counters, read_counters, mp_keep)

        # (d) the mesh encode batcher against the one-device one, bf16
        out["encode"] = _mesh_encode_batcher(
            torch, np, mesh2, settings, enc32, cpt32, zero_counters,
            read_counters)

        # (e) the serve CLI: --mesh_shape [1] on phase 3e's checkpoints
        # answers 3e's feature requests with 3e's JSON; [2] refused on one
        # card, naming it
        base = ["--rl_model", serve_keep["rl"], "--concept_model",
                serve_keep["concept"], "--sentiment_detector_json",
                serve_keep["senti"], "--compute_dtype", "bfloat16",
                "--host", "127.0.0.1", "--port", "0", "--max_wait_ms",
                "20", "--device", str(card)]
        srv = serve_cli.make_server(serve_cli.build_parser().parse_args(
            base + ["--mesh_shape", "[1]"]))
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            feats = serve_keep["feature_requests"]
            answers, errors_e, _ = _run_groups(
                lambda i: _post(srv.server_address[1], feats[i]),
                len(feats), [range(len(feats))])
        finally:
            srv.shutdown()
            srv.server_close()
            srv.app.close()
            th.join(timeout=60)
        _check(not errors_e and not th.is_alive(), f"serve --mesh_shape [1]:"
               f" {errors_e}")
        same_json = [body for _, body in answers] == \
            serve_keep["feature_answers"]
        print(f"sharded serving (e) serve --mesh_shape [1]: "
              f"{len(answers)} feature requests, statuses "
              f"{[st_ for st_, _ in answers]}, JSON identical to phase 3e's "
              f"{same_json}")
        _check(all(st_ == 200 for st_, _ in answers) and same_json,
               "serve --mesh_shape [1] answers differ from phase 3e's: "
               f"{answers} != {serve_keep['feature_answers']}")
        if cards == 1:
            refusal = None
            try:
                serve_cli.ServeApp(serve_cli.build_parser().parse_args(
                    base + ["--mesh_shape", "[2]"]))
            except SystemExit as e:
                refusal = e
            msg = str(refusal)
            _check(refusal is not None and isinstance(refusal.code, str)
                   and "1 is visible" in msg
                   and torch.cuda.get_device_name(0) in msg,
                   f"serve --mesh_shape [2] on one card: {refusal!r}")
            out["serve_2_refusal"] = msg
            print(f"sharded serving (e) serve --mesh_shape [2] on one card "
                  f"exits non-zero: {msg}")
        else:
            print(f"sharded serving (e): {cards} cards are visible, so the "
                  "refusal of --mesh_shape [2] on one card did not run")

        # (f) reproduce_table at --mesh_shape [1], and on [card, card]
        # through run_test_dump's sharded fn: phase 3i's bf16 dump files and
        # table exactly, the latter at twice 3i's rl_bs, so that each block
        # is 3i's batch; at 3i's rl_bs (blocks of 20 where 3i's batches are
        # 40: another rounding in bf16, as (c)) the files are recorded
        want_dir = offline_keep["bf16_dump"]
        want_names = sorted(n for n in os.listdir(want_dir)
                            if n.startswith("result_bf16_"))
        home, log = os.getcwd(), io.StringIO()
        out["reproduce"] = {}
        os.chdir(offline_keep["work"])
        try:
            for tag, shape, rl_bs, held in (
                    ("mesh1", (1,), RL_BS, True),
                    ("mesh_twice", (2,), 2 * RL_BS, True),
                    ("mesh_twice_bs40", (2,), RL_BS, False)):
                o = Opts(**dict(offline_keep["bf16_opts"],
                                result_dir=os.path.join(
                                    offline_keep["work"], "res_" + tag),
                                mesh_shape=shape, rl_bs=rl_bs))
                with contextlib.ExitStack() as stack:
                    stack.enter_context(contextlib.redirect_stdout(log))
                    if shape == (2,):   # two entries for the one card
                        stack.enter_context(_patched(
                            pmesh, make_device_mesh=lambda n, device:
                            pmesh.DeviceMesh([card] * n)))
                    zero_counters()
                    t0 = time.time()
                    repro.reproduce(o, offline_keep["model"], tag="bf16",
                                    anno_file=offline_keep["anno"],
                                    out=os.path.join(
                                        offline_keep["work"], tag + ".json"))
                    torch.cuda.synchronize()
                    s_ = time.time() - t0
                    launches_f = read_counters()
                got_dir = os.path.join(o.result_dir, "rl", "coco", "part")
                names = sorted(n for n in os.listdir(got_dir)
                               if n.startswith("result_bf16_"))
                differ_f = [n for n in want_names if n not in names or open(
                    os.path.join(got_dir, n), "rb").read() != open(
                    os.path.join(want_dir, n), "rb").read()]
                table_same = open(tag + ".json", "rb").read() == open(
                    "bf16.json", "rb").read()
                caps = [_dump_captions(d) for d in (got_dir, want_dir)]
                caps_differ = sum(caps[0].get(k) != v
                                  for k, v in caps[1].items())
                out["reproduce"][tag] = {
                    "s": s_, "launches": launches_f, "files": len(names),
                    "files_differing": differ_f, "table_identical":
                    table_same, "captions_differing": caps_differ,
                    "captions": len(caps[1])}
                print(f"sharded serving (f) reproduce_table bf16 "
                      f"--mesh_shape {list(shape)}"
                      + (f" on [{card}, {card}]" if shape == (2,) else "")
                      + f", rl_bs {rl_bs}: {s_:.2f} s, {len(names)} dump "
                      f"files, {len(differ_f)} differing from phase 3i's "
                      f"({caps_differ} of {len(caps[1])} captions or "
                      f"detected sentiments); table identical "
                      f"{table_same}; launches {launches_f}"
                      + ("" if held else " (a record)"))
                _check(not held or (names == want_names and not differ_f
                                    and table_same),
                       f"reproduce_table --mesh_shape {list(shape)}: dump "
                       f"files or table differ from phase 3i's bf16 run: "
                       f"{differ_f}")
                _check(launches_f["beam_content_attention"] > 0 and [
                    launches_f[k] for k in wino] == [2 * shape[0]] * 3,
                    f"reproduce_table --mesh_shape {list(shape)}: launches "
                    f"{launches_f}")
        finally:
            os.chdir(home)
            os.makedirs("chiprun_out", exist_ok=True)
            with open(os.path.join("chiprun_out", "sharded_serving.log"),
                      "w") as f:
                f.write(log.getvalue())

        # (g) the bf16 bs=384 step: one device, one 192-row block, and
        # [card, card], in turns (host clock, median of 6)
        p16 = inference.ServingParams(cap16, det16)
        reps16 = mesh2.replicate(p16)
        fc16, att16 = fc.bfloat16(), att.bfloat16()
        variants = {
            "one_device_384": lambda: one(p16, fc16, att16, sw),
            "one_block_192": lambda: one(p16, fc16[:half], att16[:half],
                                         sw[:half]),
            "mesh_twice_384": lambda: sharded(reps16, fc16, att16, sw)}
        walls = {k: [] for k in variants}
        with _switches("default"):
            for _ in range(6):
                for k, f_ in variants.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    f_()
                    torch.cuda.synchronize()
                    walls[k].append(time.perf_counter() - t0)
        med = {k: statistics.median(v) * 1e3 for k, v in walls.items()}
        smi = _smi()
        out["step_ms"] = dict(med, card=smi,
                              overlap=2 * med["one_block_192"]
                              / med["mesh_twice_384"])
        print(f"sharded serving (g) bf16 bs={BS} step on {smi} (host clock, "
              f"median of 6, in turns): one device "
              f"{med['one_device_384']:.1f} ms, one {half}-row block "
              f"{med['one_block_192']:.1f} ms, two workers on [{card}, "
              f"{card}] {med['mesh_twice_384']:.1f} ms (2 x block / mesh = "
              f"{out['step_ms']['overlap']:.2f}; a reading, no limit)")
    finally:
        mesh2.close()
    out["phase_s"] = time.time() - t_phase
    print(f"sharded serving (phase 3l): {out['phase_s']:.1f} s")
    return out


MH_TIMEOUT_S = 300               # a phase 3m process's time limit


def _multihost_rank(work):
    """One process of phase 3m's pair (RANK, WORLD_SIZE=2, LOCAL_RANK=0,
    CUDA_VISIBLE_DEVICES and MASTER_ADDR/PORT in its environment; the one
    card shared): joins the serving group as ``serve`` does
    (``cli.common.serving_mesh([2], processes=True)``: gloo over env://),
    then (a), (b) and (d) on DynamicBatchers of phase 3's weights over the
    two processes, process 0 batching and the other mirroring from
    ``follower_loop``. Every stripe a process runs is logged with its
    time, launches and decode steps (the counts set to 0 just before and
    read just after). Writes its record to ``work/rank<r>.pt``."""
    import numpy as np
    import torch
    from insenticap_model_tpu_torch import inference
    from insenticap_model_tpu_torch.cli import common
    from insenticap_model_tpu_torch.config import Settings
    from insenticap_model_tpu_torch.models.captioner import TokenIds
    from insenticap_model_tpu_torch.ops import fused_topk as ft
    from insenticap_model_tpu_torch.serving import multihost as mh
    from insenticap_model_tpu_torch.serving_daemon import AUTO, DynamicBatcher
    spec = torch.load(os.path.join(work, "spec.pt"), weights_only=False)
    settings = Settings.from_dict(spec["settings"])
    pm = common.serving_mesh([2], "cuda", processes=True)
    rank, card = pm.rank, pm.devices[0]
    zero, read = _launch_counters()
    lock, steps, log, tag = threading.Lock(), {"n": 0}, [], {"now": ""}
    real_tail, real_run = ft.classifier_topk_plain, mh.run_stripe

    def counting_tail(*a, **k):        # a decode step of this stripe
        with lock:
            steps["n"] += 1
        return real_tail(*a, **k)

    def logged_run(b, stripe, run_detect):
        torch.cuda.synchronize()
        zero()
        steps["n"] = 0
        t0 = time.perf_counter()
        res = real_run(b, stripe, run_detect)     # ends in a host copy
        log.append({"tag": tag["now"], "rows": int(stripe[0].shape[0]),
                    "ms": (time.perf_counter() - t0) * 1e3,
                    "launches": read(), "steps": steps["n"]})
        return res
    ft.classifier_topk_plain = counting_tail
    mh.run_stripe = logged_run

    def lockstep(name, dtype, work0):
        """A batcher over the two processes: process 0 runs ``work0`` on it
        and closes it (STOP), the other mirrors until then."""
        tag["now"] = name
        db = DynamicBatcher(spec["cap"], spec["det"], settings=settings,
                            ids=TokenIds(*spec["ids"]), beam_size=BEAM,
                            max_seq_len=T, max_wait_s=0.25, num_sentiments=M,
                            num_cats=NUM_CATS, compute_dtype=dtype, mesh=pm)
        try:
            if rank != 0:
                db.follower_loop()
                return None
            return work0(db)
        finally:
            db.close()

    def batcher_run(db):               # (a)
        db.warm([2, 8, 32])
        got, errors, serve_s = _serve(db, *spec["phase3"])
        return {"answers": got, "errors": errors, "serve_s": serve_s,
                "stats": db.stats(), "ladder": db._buckets}

    out = {"rank": rank, "device": str(card), "world": pm.world}
    try:
        with _switches("default"):
            out["a"] = lockstep("a", "bfloat16", batcher_run)
            if rank == 0:
                fc, att, sw = _mesh_inputs(torch, card, settings)
                host = (fc.cpu(), att.cpu(), sw.cpu(),
                        np.full(BS, AUTO, np.int32))
            for name, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
                out["b_" + name] = lockstep(   # (b) through _launch
                    "b_" + name, dtype,
                    lambda db: db._launch(BS, *host, True))

            def timing(db):                # (d), in turns with one device
                batch = (host[0].bfloat16(), host[1].bfloat16()) + host[2:]
                p16 = inference.ServingParams(db._cap_params.trees[0],
                                              db._senti_params.trees[0])
                one = inference.make_serving_fn(settings, db._ids,
                                                beam_size=BEAM,
                                                max_seq_len=T)
                fc16, att16, half = fc.bfloat16(), att.bfloat16(), BS // 2
                walls = {k: [] for k in ("dispatch", "send", "compute",
                                         "back", "one_device_384",
                                         "one_block_192")}
                for _ in range(6):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    mh.send_control(db, mh.MP_EXEC, BS, True)
                    stripe = mh.scatter_batch(db, BS, batch)
                    t1 = time.perf_counter()
                    res = mh.run_stripe(db, stripe, True)
                    t2 = time.perf_counter()
                    whole = mh.gather_results(db, res)
                    t3 = time.perf_counter()
                    for k, v in (("send", t1 - t0), ("compute", t2 - t1),
                                 ("back", t3 - t2), ("dispatch", t3 - t0)):
                        walls[k].append(v * 1e3)
                    for k, args in (
                            ("one_device_384", (fc16, att16, sw)),
                            ("one_block_192", (fc16[:half], att16[:half],
                                               sw[:half]))):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        one(p16, *args)
                        torch.cuda.synchronize()
                        walls[k].append((time.perf_counter() - t0) * 1e3)
                w = pm.world
                return {"walls": walls, "last": whole,
                        "send_bytes": sum(x.nbytes for x in batch)
                        * (w - 1) // w,
                        "back_bytes": sum(x.nbytes for x in whole)
                        * (w - 1) // w}
            out["d"] = lockstep("d", "bfloat16", timing)
    finally:
        pm.close()
        out["log"] = log
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))


def _pair_env(torch, rank, port):
    """The environment of a phase 3m process, as torchrun starts a rank of
    a two-process job on two one-card hosts: RANK, WORLD_SIZE=2,
    LOCAL_RANK=0, the one card as CUDA_VISIBLE_DEVICES, MASTER_ADDR and
    MASTER_PORT on ``port``, the repo on the path."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    card = visible.split(",")[torch.cuda.current_device()] if visible \
        else str(torch.cuda.current_device())
    return dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0",
                CUDA_VISIBLE_DEVICES=card, MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port), PYTHONPATH=os.pathsep.join(
                    [REPO_DIR] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))


def _start_pair(torch, cmd, work, name):
    """``cmd`` in two processes of their own (``_pair_env``), their output
    to files under ``work`` -> the Popen objects, rank order."""
    port = _free_port()
    procs = []
    for r in range(2):
        out = open(os.path.join(work, f"{name}{r}.out"), "w")
        err = open(os.path.join(work, f"{name}{r}.err"), "w")
        procs.append(subprocess.Popen(cmd, cwd=REPO_DIR, stdout=out,
                                      stderr=err, env=_pair_env(torch, r,
                                                                port)))
    return procs


def _wait_pair(procs, work, name, deadline):
    """Wait for both processes until ``deadline`` (killing one that
    outlives it) -> (exit codes, stdouts, stderrs); a process that hangs
    fails the phase."""
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    hung = [r for r, p in enumerate(procs) if p.poll() is None]
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    texts = [[open(os.path.join(work, f"{name}{r}.{k}")).read()
              for r in range(2)] for k in ("out", "err")]
    _check(not hung, f"phase 3m {name}: processes {hung} ran past "
           f"{MH_TIMEOUT_S} s: {[t[-2000:] for t in texts[1]]}")
    return [p.returncode for p in procs], texts[0], texts[1]


def _multihost_serving(torch, np, settings, ids, cap32, det32, phase3,
                       serve_keep, mp_keep):
    """Phase 3m: multi-host serving, two processes sharing the one card as
    two one-card hosts would run (``_pair_env``), over gloo: (a) the bf16
    DynamicBatcher of phase 3's weights on the mesh over both, process 0
    answering phase 3's 41 requests bit for bit as 3l(c)'s one-process
    [card, card] batcher did (each process runs the one-device body on
    the same block), the follower leaving its loop at STOP; (b) the bs=384
    batch through the lockstep path, f32 and bf16, bit for bit the
    one-device function on each 192-row block (3l(b)), each process's
    launches: v1 once a decode step, each Winograd transform once in bf16;
    (c) ``python -m ...cli.serve --mesh_shape [2]`` in two processes on
    3e's checkpoints: process 0's answers to 3e's feature and image
    requests equal those of 3e's daemon in one process on one device to
    the same requests sent one at a time (the answers to 3e's concurrent
    requests recorded beside them), the follower's two lines, SIGTERM
    draining process 0 and releasing the follower, both exiting 0;
    ``reproduce_table`` under WORLD_SIZE=2 exiting with its message; (d)
    the bf16 bs=384 batch through the lockstep path, its control plane's
    ms and MB, each process's compute ms, the whole dispatch, against one
    device and one block, in turns (host clock, median of 6)."""
    from insenticap_model_tpu_torch import nn
    from insenticap_model_tpu_torch.cli import serve as serve_cli
    out, t_phase, smi = {}, time.time(), _smi()
    wino = ("wino_input", "wino_middle", "wino_output")
    with tempfile.TemporaryDirectory(prefix="multihost_") as work:
        host = lambda t: t.cpu()  # noqa: E731
        torch.save({"settings": settings.to_dict(), "ids": tuple(ids),
                    "cap": nn.tree_map(host, cap32),
                    "det": nn.tree_map(host, det32),
                    "phase3": phase3[:5]}, os.path.join(work, "spec.pt"))
        code = (f"import sys; sys.path.insert(0, {REPO_DIR!r}); "
                "import chip_smoke; chip_smoke._multihost_rank(sys.argv[1])")
        t0 = time.time()
        procs = _start_pair(torch, [sys.executable, "-c", code, work], work,
                            "rank")
        rcs, outs, errs = _wait_pair(procs, work, "rank",
                                     time.monotonic() + MH_TIMEOUT_S)
        pair_s = time.time() - t0
        _check(rcs == [0, 0], f"phase 3m ranks exited {rcs}: "
               f"{[e[-3000:] for e in errs]}")
        p0, p1 = (torch.load(os.path.join(work, f"rank{r}.pt"),
                             weights_only=False) for r in range(2))

        # (a) the batcher: 3l(c)'s answers bit for bit
        a = p0["a"]
        _check_results(a["answers"], a["errors"])
        differ = [i for i, (x, y) in enumerate(zip(a["answers"],
                                                   mp_keep["answers"]))
                  if not (np.array_equal(x[0], y[0])
                          and np.array_equal(x[1], y[1]) and x[2] == y[2])]
        logs = {r: [e for e in rec["log"] if e["tag"] == "a"]
                for r, rec in ((0, p0), (1, p1))}
        launches_a = {r: {k: sum(e["launches"][k] for e in es)
                          for k in ("beam_content_attention",) + wino}
                      for r, es in logs.items()}
        st = a["stats"]
        out["batcher"] = {"serve_s": a["serve_s"], "ladder": a["ladder"],
                          "by_bucket": st["by_bucket"],
                          "batches": st["batches"],
                          "padded_rows": st["padded_rows"],
                          "differ_from_3l": differ,
                          "stripes": {r: len(es) for r, es in logs.items()},
                          "launches": launches_a}
        print(f"multi-host serving (a) bf16 DynamicBatcher over 2 processes "
              f"on {smi}: ladder {a['ladder']}, {len(a['answers'])} requests "
              f"in {a['serve_s']:.2f} s, {st['batches']} batches by bucket "
              f"{st['by_bucket']} ({mp_keep['by_bucket']} in 3l(c)), "
              f"{st['padded_rows']} padded rows; stripes run: process 0 "
              f"{len(logs[0])}, follower {len(logs[1])} (the warm-up's "
              f"included); launches {launches_a}; answers differing from "
              f"3l(c)'s one-process [card, card] batcher: {differ}")
        _check(not differ, f"multi-host batcher answers differ from 3l(c)'s "
               f"on requests {differ}")
        _check(len(logs[0]) == len(logs[1]) > 0,
               f"the follower mirrored {len(logs[1])} of process 0's "
               f"{len(logs[0])} stripes")
        _check(all(launches_a[r][k] > 0 for r in (0, 1)
                   for k in ("beam_content_attention",) + wino),
               f"a kernel never launched in a process: {launches_a}")

        # (b) the bs=384 batch, bit for bit the one-device fn's blocks
        out["function"] = {}
        for name in ("f32", "bf16"):
            seqs, scores, labels = p0["b_" + name]
            want = mp_keep["blocks_" + name]
            same = (np.array_equal(seqs, want[0].numpy())
                    and np.array_equal(scores, want[1].float().numpy())
                    and np.array_equal(labels, want[2].numpy()))
            per = {r: [e for e in rec["log"] if e["tag"] == "b_" + name]
                   for r, rec in ((0, p0), (1, p1))}
            launches = {r: es[0]["launches"] for r, es in per.items()}
            n_steps = {r: es[0]["steps"] for r, es in per.items()}
            want_wino = 1 if name == "bf16" else 0
            out["function"][name] = {"bitwise_vs_blocks": same,
                                     "launches": launches,
                                     "decode_steps": n_steps}
            print(f"multi-host serving (b) {name} bs={BS} through the "
                  f"lockstep path over 2 processes: bit for bit the "
                  f"one-device fn on each {BS // 2}-row block {same}; "
                  f"launches {launches}, decode steps {n_steps}")
            _check(same, f"lockstep {name}: not bit for bit the one-device "
                   "fn on its blocks")
            for r in (0, 1):
                _check(len(per[r]) == 1 and per[r][0]["rows"] == BS // 2,
                       f"lockstep {name}: process {r} ran {per[r]}")
                _check([launches[r][k] for k in wino] == [want_wino] * 3,
                       f"lockstep {name}: process {r}'s Winograd launches "
                       f"{launches[r]} != {want_wino} each")
                _check(n_steps[r] > 0 and n_steps[r] == launches[r][
                    "beam_content_attention"], f"lockstep {name}: process "
                    f"{r}'s v1 launches {launches[r]} != decode steps "
                    f"{n_steps[r]}")

        # (d) the timing, in turns within the pair
        d = p0["d"]
        med = {k: statistics.median(v) for k, v in d["walls"].items()}
        follower_ms = statistics.median(
            e["ms"] for e in p1["log"] if e["tag"] == "d")
        p0_ms = statistics.median(
            e["ms"] for e in p0["log"] if e["tag"] == "d")
        last = d["last"]
        _check(all(np.array_equal(x, y) for x, y in zip(last, p0["b_bf16"])),
               "a timed lockstep dispatch differs from (b)'s bf16 answers")
        out["timing"] = {"ms": med, "process0_compute_ms": p0_ms,
                         "follower_compute_ms": follower_ms,
                         "send_MB": d["send_bytes"] / 1e6,
                         "back_MB": d["back_bytes"] / 1e6,
                         "pair_s": pair_s, "card": smi}
        print(f"multi-host serving (d) bf16 bs={BS} on {smi} (host clock, "
              f"median of 6 in turns): the lockstep dispatch "
              f"{med['dispatch']:.1f} ms = control and batch scatter "
              f"{med['send']:.1f} ms ({d['send_bytes'] / 1e6:.1f} MB to the "
              f"follower) + process 0's stripe {med['compute']:.1f} ms + "
              f"results back {med['back']:.1f} ms "
              f"({d['back_bytes'] / 1e6:.3f} MB, waiting on the follower "
              f"included); each process's compute: process 0 {p0_ms:.1f} "
              f"ms, follower {follower_ms:.1f} ms; one device "
              f"{med['one_device_384']:.1f} ms, one {BS // 2}-row block "
              f"{med['one_block_192']:.1f} ms; the pair's processes "
              f"{pair_s:.1f} s")

        # (c) the serve CLI over two processes, and reproduce_table refused
        out["cli"] = _multihost_cli(torch, serve_cli, serve_keep, work)
    out["phase_s"] = time.time() - t_phase
    print(f"multi-host serving (phase 3m): {out['phase_s']:.1f} s")
    return out


def _multihost_cli(torch, serve_cli, keep, work):
    """Phase 3m(c): ``serve --mesh_shape [2]`` in two processes on 3e's
    checkpoints, held to 3e's daemon in one process on the same requests
    sent one at a time; ``reproduce_table`` under WORLD_SIZE=2 refused."""
    out = {}
    base = ["--rl_model", keep["rl"], "--concept_model", keep["concept"],
            "--resnet101_ckpt", keep["resnet101"],
            "--sentiment_detector_json", keep["senti"], "--image_root",
            keep["image_root"], "--compute_dtype", "bfloat16", "--warm",
            "--host",
            "127.0.0.1", "--port", "0", "--max_wait_ms", "20",
            "--max_body_mb", "16"]
    requests = keep["feature_requests"] + keep["image_requests"]
    concurrent = keep["feature_answers"] + keep["image_answers"]
    repro = subprocess.Popen(
        [sys.executable, "-m", "insenticap_model_tpu_torch.cli."
         "reproduce_table", "--rl_model", keep["rl"], "--mesh_shape", "[2]"],
        cwd=REPO_DIR, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=_pair_env(torch, 0, _free_port()))
    procs = _start_pair(torch, [sys.executable, "-m",
                                "insenticap_model_tpu_torch.cli.serve",
                                "--mesh_shape", "[2]"] + base, work, "serve")
    deadline = time.monotonic() + MH_TIMEOUT_S
    try:
        # the reference: 3e's daemon in this process on the one card
        srv = serve_cli.make_server(serve_cli.build_parser().parse_args(
            base + ["--device", "cuda"]))
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            want = [_post(srv.server_address[1], r) for r in requests]
        finally:
            srv.shutdown()
            srv.server_close()
            srv.app.close()
            th.join(timeout=60)
        m = None
        while m is None and time.monotonic() < deadline:
            _check(procs[0].poll() is None, "serve --mesh_shape [2] process "
                   "0 exited: " + open(os.path.join(work, "serve0.err"))
                   .read()[-3000:])
            m = re.search(r"serving on http://127\.0\.0\.1:(\d+)",
                          open(os.path.join(work, "serve0.out")).read())
            if m is None:
                time.sleep(0.5)
        _check(m is not None, "serve --mesh_shape [2] never served")
        port = int(m.group(1))
        t0 = time.time()
        got = [_post(port, r) for r in requests]
        serve_s = time.time() - t0
    finally:
        if procs[0].poll() is None:
            procs[0].send_signal(signal.SIGTERM)
        rcs, outs, errs = _wait_pair(procs, work, "serve", deadline)
        try:
            r_out, r_err = repro.communicate(timeout=max(
                1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            repro.kill()
            r_out, r_err = repro.communicate()
    same = [g == w for g, w in zip(got, want)]
    as_3e = sum(g[1] == c for g, c in zip(got, concurrent))
    lines = outs[1].splitlines()
    out.update(requests=len(requests), serve_s=serve_s, rcs=rcs,
               identical_to_one_process=sum(same),
               identical_to_3e_concurrent=as_3e, follower_lines=lines,
               reproduce_table_rc=repro.returncode)
    print(f"multi-host serving (c) serve --mesh_shape [2] over 2 processes: "
          f"{len(requests)} requests (4 feature, {len(requests) - 4} image, "
          f"one at a time) in {serve_s:.2f} s, statuses "
          f"{sorted({g[0] for g in got})}, JSON identical to 3e's daemon "
          f"in one process on the same requests {sum(same)} of "
          f"{len(requests)} (to 3e's concurrent answers, a record: {as_3e});"
          f" process 0 {'drained' if 'drained, exiting' in outs[0] else '?'}"
          f"; follower printed {lines}; exit codes {rcs}; reproduce_table "
          f"under WORLD_SIZE=2 exited {repro.returncode}: "
          f"{r_err.strip().splitlines()[-1:] if r_err else r_err!r}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "multihost_serving.log"), "w") as f:
        for k, texts in (("out", outs), ("err", errs)):
            for r, t in enumerate(texts):
                f.write(f"== serve process {r}, std{k} ==\n{t}\n")
    _check(all(g[0] == 200 for g in got) and all(same),
           f"serve --mesh_shape [2]: answers differ from one process's on "
           f"requests {[i for i, s_ in enumerate(same) if not s_]}")
    _check(rcs == [0, 0] and "drained, exiting" in outs[0],
           f"serve --mesh_shape [2]: exit codes {rcs}, "
           f"{[e[-2000:] for e in errs]}")
    _check(lines == ["follower 1/2: mirroring process 0", "follower done"],
           f"the follower printed {lines}")
    _check(repro.returncode not in (0, None) and "only serve runs a mesh "
           "over processes" in r_err, f"reproduce_table under WORLD_SIZE=2"
           f" exited {repro.returncode}: {r_err[-2000:]}")
    return out


# ---------------------------------------------------------------------------
# Phase 3n: the 2-D data x model mesh (the captioner's vocabulary sharded)
# ---------------------------------------------------------------------------

def _tp_cli(torch, np, dev, inputs, settings):
    """Phase 3n(a)'s work on this rank: ``cli.train_xe.train`` with the
    options ``inputs["opts"]`` (``--mesh_shape [1, 2]``) on the process
    group the rank joined, v1's launches (rank 0's dump) and the
    model-axis collectives counted from 0."""
    from insenticap_model_tpu_torch.cli import train_xe
    from insenticap_model_tpu_torch.ops import fused_attention as fa
    from insenticap_model_tpu_torch.parallel import mesh, vocab
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.world_size()))
    fa.beam_content_attention.launches = 0
    vocab.stats.update(collectives=0, bytes=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    train_xe.train(inputs["opts"])
    torch.cuda.synchronize()
    return {"rank": mesh.rank(), "s": time.time() - t0,
            "v1_launches": fa.beam_content_attention.launches,
            "collectives": vocab.stats["collectives"],
            "bytes": vocab.stats["bytes"],
            "peak_mb": torch.cuda.max_memory_allocated() / 1e6}


def _tp_steps(torch, np, dev, inputs, settings):
    """Phase 3n(b)'s and (c)'s work on this rank, on ``inputs["grid"]``
    (None: one process, the whole batches): from the seeded full-width
    captioner, its vocab leaves and their moments sharded over the model
    axis, (1) the f32 XE stage step (XE, domain alignment, seq2seq; the
    default dropout, scheduled sampling at TP_SS_PROB) on the data
    group's rows of phase 3f's first batches, recorded; (2) with a plain
    Adam, one step to warm up, one with the model-axis collectives
    recorded, then TP_TIMED_STEPS timed between barriers, and the
    recorded collectives replayed alone, timed; (3) the sampled and
    greedy rollouts of phase 3h's first fact batch's rows (the f32
    detector's labels), their tokens; (4) the f32 RL fact step on those
    rows and the seq2seq batch's, recorded, then one with the detector in
    bf16, the Winograd launch counts set to 0 just before and read just
    after. Every rank seeds alike; the params are broadcast from rank 0
    before they are sharded."""
    import torch.distributed as dist
    from insenticap_model_tpu_torch import nn
    from insenticap_model_tpu_torch.models import captioner as cap
    from insenticap_model_tpu_torch.models import sent_senti_cls as ss_cls
    from insenticap_model_tpu_torch.models import sentiment_detector as sd
    from insenticap_model_tpu_torch.ops import ciderd_device
    from insenticap_model_tpu_torch.ops import winograd_kernels as wk
    from insenticap_model_tpu_torch.parallel import mesh, vocab
    from insenticap_model_tpu_torch.rewards.ciderd import build_scorer
    from insenticap_model_tpu_torch.training import checkpoint as tck
    from insenticap_model_tpu_torch.training import optim, steps
    from insenticap_model_tpu_torch.utils.dtypes import cast_bf16
    RecordingAdam = _recording_adam(torch, optim)
    # the host's cores shared among the ranks (gloo's loops spin)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.world_size()))
    grid = inputs["grid"]
    if grid is not None:
        mesh.init_grid(grid)
    shard = mesh.vocab_shard(VOCAB)
    r, n = mesh.data_rank(), mesh.data_size()
    torch.cuda.reset_peak_memory_stats()
    ids = cap.TokenIds(pad=0, unk=1, sos=2, eos=3, neutral=2)

    def rows(batch):
        sl = mesh.shard_rows(len(batch["fc" if "fc" in batch else "caps"]),
                             r, n)
        return {k: torch.from_numpy(np.ascontiguousarray(v[sl])).to(dev)
                for k, v in batch.items() if k != "valid"}

    def captioner(adam_cls, lr):
        params = nn.tree_map(
            lambda x: x.requires_grad_(True),
            mesh.replicate(cap.init_params(torch.Generator().manual_seed(3),
                                           VOCAB, NUM_CATS, settings,
                                           device=dev)))
        adam = adam_cls(params, lr)
        optim.shard_captioner(adam, shard)
        return adam

    def record(adam, losses):
        return {"grads": adam.grads,
                "paths": [q for q, _ in _tree_paths(adam.params)],
                "params": [p.detach().float().cpu().clone()
                           for _, p in _tree_paths(adam.params)],
                "losses": {k: float(v) for k, v in losses.items()}}

    out = {"rank": mesh.rank(), "grid": grid,
           "shard": shard and (shard.start, shard.size)}
    b, s = rows(inputs["batch"]), rows(inputs["scs"])
    with nn.exact_numerics():
        cls = mesh.replicate(ss_cls.init_params(
            torch.Generator().manual_seed(5), VOCAB, NUM_CATS, settings,
            device=dev))
        adam = captioner(RecordingAdam, XE_LR)
        train_step, _ = steps.make_xe_steps(settings, adam)
        out["xe"] = record(adam, train_step(
            cls, b, s, torch.Generator(device=dev).manual_seed(0),
            TP_SS_PROB))
        del adam, train_step
        adam = captioner(optim.Adam, XE_LR)
        train_step, _ = steps.make_xe_steps(settings, adam)
        state = nn.tree_leaves([adam.params, adam.mu, adam.nu])
        out["state_mb"] = {
            "params": 4e-6 * sum(p.numel() for p in nn.tree_leaves(
                adam.params)),
            "grads": 4e-6 * sum(p.numel() for p in nn.tree_leaves(
                adam.params)),
            "moments": 4e-6 * sum(p.numel() for p in state[len(state) // 3:])}

        def step(i):
            return train_step(cls, b, s, torch.Generator(
                device=dev).manual_seed(1 + i), TP_SS_PROB)
        step(0)
        vocab.stats.update(collectives=0, bytes=0, sizes=[])
        step(0)
        sizes = vocab.stats["sizes"]
        out["collectives"] = {"count": vocab.stats["collectives"],
                              "mb": vocab.stats["bytes"] / 1e6}
        vocab.stats["sizes"] = None
        walls = []
        for i in range(TP_TIMED_STEPS):
            mesh.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(1 + i)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out["step_ms"] = walls
        # the step's model-axis collectives alone, on buffers made first
        bufs = [torch.zeros(k, dtype=dt, device=dev) for k, dt in sizes]
        walls = []
        for _ in range(TP_TIMED_STEPS):
            mesh.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for buf in bufs:
                dist.all_reduce(buf, group=shard.group)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out["collectives"]["ms"] = walls if bufs else [0.0]
        del adam, train_step, bufs

    caps_id = inputs["caps_id"]
    gts = {**caps_id["train"], **caps_id["val"]}
    tables, _ = ciderd_device.build_tables(
        build_scorer(caps_id, ids.sos, ids.eos), gts, list(gts), T,
        ids.sos, ids.eos, device=dev)
    det = tck.load(inputs["det_file"], device=dev, dtype=torch.float32)[0]
    rl_cls = tck.load(inputs["cls_file"], device=dev, dtype=torch.float32)[0]
    fb, sb = rows(inputs["fact"]), rows(inputs["scs_rl"])
    adam = captioner(RecordingAdam, RL_LR)
    rl = steps.make_rl_steps(settings, adam, ids, T, tables)
    with torch.no_grad(), nn.exact_numerics():
        labels, _, _ = sd.module_for(settings).sample(
            det, fb["att"], steps.SENTI_THRESHOLD, ids.neutral)
        rollouts = {}
        with vocab.sharded(shard):
            for name, greedy in (("sampled", False), ("greedy", True)):
                seq, _, _, _ = cap.forward_rl(
                    adam.params, fb["fc"], fb["att"], fb["cpts"],
                    fb["sentis"], labels, settings=settings, ids=ids,
                    max_seq_len=T, sample_max=greedy,
                    gen=torch.Generator(device=dev).manual_seed(100),
                    deterministic=greedy)
                rollouts[name] = seq.cpu()
    out["rollouts"] = rollouts
    out["rl"] = record(adam, rl[("fact", True)](
        steps.RLModels(det, rl_cls), fb, sb,
        torch.Generator(device=dev).manual_seed(0)))
    for name in WINO_NAMES:
        getattr(wk, name).launches = 0
    rl[("fact", True)](steps.RLModels(cast_bf16(det), rl_cls), fb, sb,
                       torch.Generator(device=dev).manual_seed(1))
    out["wino_launches"] = [getattr(wk, n).launches for n in WINO_NAMES]
    out["peak_mb"] = torch.cuda.max_memory_allocated() / 1e6
    return out


def _tp_sliced(ref, shard):
    """A one-process step record cut to a rank's vocabulary ``shard``
    (start, size): the vocab leaves' gradients and params their rows."""
    sl = slice(shard[0], shard[0] + shard[1])
    cut = [(g[sl], p[sl]) if path in TP_VOCAB_LEAVES else (g, p)
           for path, g, p in zip(ref["paths"], ref["grads"], ref["params"])]
    return dict(ref, grads=[g for g, _ in cut], params=[p for _, p in cut])


def _tp_cli_check(torch, dev, settings, keep):
    """Phase 3n(a): ``cli.train_xe`` at ``--mesh_shape [1, 2]`` in two
    processes sharing the card over gloo, each joining the group itself,
    for epoch 0 on phase 3f's tree rebuilt from its seeds: its metrics
    within 3j's loss gate of phase 3f's f32 epoch 0; rank 0's checkpoint
    read in one process (the one-process file: the structure, shapes and
    types of phase 3f's, its step count) with its params against phase
    3f's epoch-0 params (the share of elements past 1e-5 within
    TP_PARAM_SHARE: the two runs' gradients part by rounding, and Adam's
    update turns that into up to lr a step where a gradient is near
    zero); its dump bit for bit one process's ``decode_split`` of the
    checkpoint's params, v1 launched in both."""
    from insenticap_model_tpu_torch.cli import common, train_xe
    from insenticap_model_tpu_torch.ops import fused_attention as fa
    from insenticap_model_tpu_torch.training import checkpoint as tck
    out = {}
    with tempfile.TemporaryDirectory(prefix="tp_") as tmp:
        _, _, cls_file = _xe_tree(torch, dev, settings, tmp)
        o = _xe_opts(settings, tmp, cls_file, "tp", device=str(dev),
                     xe_epochs=1, mesh_shape=(1, 2))
        ranks, out["cli_s"] = _spawn_ranks(torch, _tp_cli, {"opts": o}, dev,
                                           settings, 2)
        out["ranks"] = ranks
        stage = os.path.join(o.checkpoint, "xe", "coco", "part")
        with open(os.path.join(stage, "metrics.jsonl")) as f:
            metrics = [json.loads(x) for x in f]
        ref = keep["epoch0"]
        _check(len(metrics) == 1 and set(metrics[0]) == set(ref["metrics"]),
               f"train_xe --mesh_shape [1, 2] metrics {metrics}")
        rel = max(abs(metrics[0][k] - v) / abs(v) if v else abs(metrics[0][k])
                  for k, v in ref["metrics"].items())
        out.update(metrics=metrics[0], metrics_rel=rel)
        _check(rel <= 1e-5, f"train_xe --mesh_shape [1, 2] metrics "
               f"{metrics[0]} against phase 3f's {ref['metrics']}: {rel} "
               "relative (tolerance 1e-5)")
        [name] = [f for f in os.listdir(stage) if f.startswith("model_0_")]
        p, st, meta = tck.load(os.path.join(stage, name), device="cpu",
                               with_opt_state=True)
        pa, pb = _tree_paths(p), _tree_paths(ref["params"])
        _check([q for q, _ in pa] == [q for q, _ in pb] and all(
            a.dtype == b.dtype and a.shape == b.shape
            for (_, a), (_, b) in zip(pa, pb))
            and int(st["count"]) == int(ref["opt_state"]["count"]),
            "train_xe --mesh_shape [1, 2]: rank 0's checkpoint is not the "
            "one-process file of phase 3f's structure")
        over = total = 0
        gap = 0.0
        for (_, a), (_, b) in zip(pa, pb):
            d = (a.double() - b.detach().cpu().double()).abs()
            gap = max(gap, float(d.max()))
            over += int((d > 1e-5).sum())
            total += d.numel()
        out.update(param_gap=gap, param_over=over, param_total=total)
        _check(over <= TP_PARAM_SHARE * total, f"train_xe --mesh_shape "
               f"[1, 2] epoch-0 params: {over} of {total} elements past "
               f"1e-5 of phase 3f's (largest {gap}; gate "
               f"{TP_PARAM_SHARE:.0e} of them)")
        # the dump against one process's decode of the checkpoint's params
        whole, _ = tck.load(os.path.join(stage, name), device=dev)
        o1 = _xe_opts(settings, tmp, cls_file, "tp_decode", device=str(dev))
        rt = common.Runtime(o1)
        vocab_ = common.load_vocab(o1)
        ids = common.token_ids(vocab_, o1.sentiment_categories)
        stores = [common.open_store(q) for q in common.feature_paths(o1)]
        fns = sorted(common.load_json(common.dataset_path(
            o1, "img_captions.json"))["test"])
        fa.beam_content_attention.launches = 0
        want = train_xe.decode_split(whole, *stores, fns, XE_BS, rt, o1, ids,
                                     vocab_)
        out["decode_v1_launches"] = fa.beam_content_attention.launches
        with open(os.path.join(o.result_dir, "xe", "coco", "part",
                               "result_0.json")) as f:
            got = json.load(f)
        _check(got == [{"image_id": x["image_id"], "caption": x["caption"]}
                       for x in want], "train_xe --mesh_shape [1, 2]: rank "
               "0's dump differs from one process's decode of its "
               "checkpoint's params")
        _check(ranks[0]["v1_launches"] == out["decode_v1_launches"] > 0
               and ranks[1]["v1_launches"] == 0, f"v1 launches: ranks "
               f"{[x['v1_launches'] for x in ranks]}, one process's decode "
               f"{out['decode_v1_launches']}")
    return out


def _model_parallel(torch, np, dev, settings, xe_keep, rl_keep):
    """Phase 3n: the 2-D data x model mesh. (a) ``train_xe --mesh_shape
    [1, 2]`` through the CLI (``_tp_cli_check``); (b) the f32 XE stage
    step, the RL fact rollouts (sampled and greedy) and the RL fact step
    (``_tp_steps``) at [1, 2] and [2, 2], ranks sharing the one card over
    gloo, against one process (a process of its own, the whole batches)
    under phase 3j's gates, the sampled and greedy tokens identical, the
    replicated leaves alike on every rank and each shard on every rank of
    its data group; (c) the XE step's ms a global batch, its model-axis
    collectives (count, MB, ms alone) and the captioner's training state
    a rank (host clock, medians of TP_TIMED_STEPS; readings, no limit)."""
    from insenticap_model_tpu_torch.training import optim
    t_phase = time.time()
    out = {"cli": _tp_cli_check(torch, dev, settings, xe_keep)}
    inputs = dict(batch=xe_keep["batch"], scs=xe_keep["scs"],
                  fact=rl_keep["inputs"]["fact"],
                  scs_rl=rl_keep["inputs"]["scs"],
                  caps_id=rl_keep["inputs"]["caps_id"],
                  det_file=os.path.join(rl_keep["root"], "det.ckpt"),
                  cls_file=os.path.join(rl_keep["root"], "ck",
                                        "sent_senti_cls", "coco", "part",
                                        "model-best.ckpt"))
    [ref], out["one_s"] = _spawn_ranks(torch, _tp_steps,
                                       dict(inputs, grid=None), dev,
                                       settings, 1)
    runs = {}
    for grid in TP_GRIDS:
        world = grid[0] * grid[1]
        runs[grid], out[f"ranks_s_{grid[0]}x{grid[1]}"] = _spawn_ranks(
            torch, _tp_steps, dict(inputs, grid=grid), dev, settings, world)
    rows = []
    for grid, ranks in runs.items():
        for rec in ranks:
            row = {"grid": list(grid), "rank": rec["rank"],
                   "shard": rec["shard"], "wino_launches":
                   rec["wino_launches"], "peak_mb": rec["peak_mb"]}
            for tag, lr in (("xe", XE_LR), ("rl", RL_LR)):
                want = _tp_sliced(ref[tag], rec["shard"])
                g, leaf, gap, over = _dp_gaps(torch, rec[tag], want, lr, 0.1,
                                              optim.EPS)
                got_l, want_l = rec[tag]["losses"], want["losses"]
                _check(set(got_l) == set(want_l), f"3n {grid} rank "
                       f"{rec['rank']} {tag} loss keys")
                row[tag] = {"loss_rel": max(
                    abs(got_l[k] - v) / abs(v) if v else abs(got_l[k])
                    for k, v in want_l.items()), "grad_rel": g,
                    "grad_leaf": leaf, "param_gap": gap, "param_over": over}
            row["tokens_equal"] = {k: bool(torch.equal(
                rec["rollouts"][k], ref["rollouts"][k][_tp_rows(
                    ref, rec, grid)])) for k in ("sampled", "greedy")}
            rows.append(row)
        # replicated leaves alike everywhere, shards within a data group
        tp = grid[1]
        for rec in ranks:
            twin = ranks[rec["rank"] % tp]
            for tag in ("xe", "rl"):
                _check(all(torch.equal(a, b) for a, b in zip(
                    rec[tag]["params"], twin[tag]["params"])),
                    f"3n {grid}: rank {rec['rank']}'s {tag} params differ "
                    f"from rank {twin['rank']}'s (the same shard)")
                _check(all(torch.equal(a, b) for q, a, b in zip(
                    rec[tag]["paths"], rec[tag]["params"],
                    ranks[0][tag]["params"]) if q not in TP_VOCAB_LEAVES),
                    f"3n {grid}: rank {rec['rank']}'s replicated {tag} "
                    "params differ from rank 0's")
    times = {"one_process_ms": statistics.median(ref["step_ms"])}
    for grid, ranks in runs.items():
        tag = f"{grid[0]}x{grid[1]}"
        per_batch = [max(x["step_ms"][i] for x in ranks)
                     for i in range(TP_TIMED_STEPS)]
        alone = [max(x["collectives"]["ms"][i] for x in ranks)
                 for i in range(TP_TIMED_STEPS)]
        times[tag] = {"ms": statistics.median(per_batch),
                      "all_ms": per_batch,
                      "collectives": ranks[0]["collectives"]["count"],
                      "collectives_mb": ranks[0]["collectives"]["mb"],
                      "collectives_ms": statistics.median(alone),
                      "state_mb": ranks[0]["state_mb"],
                      "peak_mb": max(x["peak_mb"] for x in ranks)}
    times["one_process_state_mb"] = ref["state_mb"]
    times["one_process_peak_mb"] = ref["peak_mb"]
    out.update(ranks=rows, time=times, phase_s=time.time() - t_phase)
    smi = _smi()
    a = out["cli"]
    print(f"model parallel (phase 3n) (a) train_xe --mesh_shape [1, 2] "
          f"(two processes sharing the card over gloo): epoch 0's metrics "
          f"within {a['metrics_rel']:.3g} of phase 3f's f32 run's (train "
          f"all_loss {a['metrics']['train_all_loss']:.6f}); rank 0's "
          f"checkpoint read in one process, params {a['param_over']} of "
          f"{a['param_total']} elements past 1e-5 of phase 3f's (largest "
          f"{a['param_gap']:.3g}); its dump bit for bit one process's decode "
          f"of those params, v1 launches {a['ranks'][0]['v1_launches']} "
          f"(rank 0) and {a['decode_v1_launches']} (the decode); model-axis "
          f"collectives in the epoch {a['ranks'][0]['collectives']} "
          f"({a['ranks'][0]['bytes'] / 1e6:.1f} MB); {a['cli_s']:.1f} s "
          "with the processes' start")
    for r in rows:
        print(f"model parallel (b) {r['grid']} rank {r['rank']} (vocab rows "
              f"{r['shard'][0]}-{r['shard'][0] + r['shard'][1] - 1}) against "
              f"one process: " + "; ".join(
                  f"{t} losses max rel {r[t]['loss_rel']:.3g}, gradient max "
                  f"rel {r[t]['grad_rel']:.3g} ({r[t]['grad_leaf']}), params "
                  f"gap {r[t]['param_gap']:.3g} ({r[t]['param_over']} past "
                  "1e-5)" for t in ("xe", "rl"))
              + f"; RL tokens identical {r['tokens_equal']}; bf16 "
              f"detector's Winograd launches {r['wino_launches']}")
    t = times
    print(f"model parallel (c) f32 XE step per global batch of {XE_BS} "
          f"(+ {len(inputs['scs']['caps'])} seq2seq rows, ss_prob "
          f"{TP_SS_PROB}) on {smi}: one process {t['one_process_ms']:.2f} "
          "ms, " + ", ".join(
              f"[{g.replace('x', ', ')}] {t[g]['ms']:.2f} ms ({t[g]['collectives']} "
              f"model-axis collectives a step, {t[g]['collectives_mb']:.3f} "
              f"MB, {t[g]['collectives_ms']:.2f} ms replayed alone)"
              for g in ("1x2", "2x2"))
          + f" (medians of {TP_TIMED_STEPS}; host clock)")
    print(f"model parallel (c) the captioner's training state a rank, MB "
          f"(params + grads + moments, f32): one process "
          f"{sum(t['one_process_state_mb'].values()):.1f} (peak allocated "
          f"{t['one_process_peak_mb']:.1f}), " + ", ".join(
              f"[{g.replace('x', ', ')}] {sum(t[g]['state_mb'].values()):.1f} "
              f"(params {t[g]['state_mb']['params']:.1f}; peak allocated "
              f"{t[g]['peak_mb']:.1f})" for g in ("1x2", "2x2"))
          + f" on {smi}; phase 3n {out['phase_s']:.1f} s")
    out["device"] = smi
    for r in rows:
        for tag in ("xe", "rl"):
            v = r[tag]
            _check(v["loss_rel"] <= 1e-5, f"3n {r['grid']} rank {r['rank']}"
                   f" {tag} losses against one process's: {v['loss_rel']} "
                   "relative (tolerance 1e-5)")
            _check(v["grad_rel"] <= DP_GRAD_RTOL, f"3n {r['grid']} rank "
                   f"{r['rank']} {tag} gradient of {v['grad_leaf']} differs "
                   f"from one process's by {v['grad_rel']} of its norm "
                   f"(tolerance {DP_GRAD_RTOL})")
            _check(v["param_over"] == 0, f"3n {r['grid']} rank {r['rank']} "
                   f"{tag} params: {v['param_over']} elements past 1e-5 of "
                   f"Adam's update (largest {v['param_gap']})")
        _check(all(r["tokens_equal"].values()), f"3n {r['grid']} rank "
               f"{r['rank']}: RL rollout tokens differ from one process's "
               f"{r['tokens_equal']}")
        _check(r["wino_launches"] == ref["wino_launches"] == [1, 1, 1],
               f"3n {r['grid']} rank {r['rank']} Winograd launches "
               f"{r['wino_launches']} (one process {ref['wino_launches']})")
    return out


def _tp_rows(ref, rec, grid):
    """The rows of the one-process batch that a rank of ``grid`` holds:
    its data group's block."""
    n = len(ref["rollouts"]["sampled"])
    b = n // grid[0]
    d = rec["rank"] // grid[1]
    return slice(d * b, (d + 1) * b)


def main():
    t_start = time.time()
    import torch
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this check needs a card")
    try:
        from insenticap_model_tpu_torch import inference, nn
        from insenticap_model_tpu_torch.cli.common import senti_word_ids
        from insenticap_model_tpu_torch.config import Settings
        from insenticap_model_tpu_torch.models import captioner as cap
        from insenticap_model_tpu_torch.models import concept_detector as cpt
        from insenticap_model_tpu_torch.models import encoder
        from insenticap_model_tpu_torch.models import sentiment_detector as sd
        from insenticap_model_tpu_torch.ops import _build
        from insenticap_model_tpu_torch.ops import fused_attention as fa
        from insenticap_model_tpu_torch.ops import fused_attention_i8 as fa8
        from insenticap_model_tpu_torch.ops import fused_topk as ft
        from insenticap_model_tpu_torch.ops import pool
        from insenticap_model_tpu_torch.ops import tiled_mm as tmm
        from insenticap_model_tpu_torch.ops import winograd_kernels as wk
        from insenticap_model_tpu_torch.ops.winograd import transform_filter
        from insenticap_model_tpu_torch.preprocessing import (
            DEFAULT_BUCKET_SHAPES)
        from insenticap_model_tpu_torch.serving.encode import make_cpt_apply
        from insenticap_model_tpu_torch.serving_daemon import (
            AUTO, DynamicBatcher, EncodeBatcher)
        from insenticap_model_tpu_torch.training import checkpoint as tck
        from insenticap_model_tpu_torch.utils.dtypes import (cast_bf16,
                                                             cast_f32)
        from insenticap_model_tpu_torch.utils.timing import (
            SESSIONS, cuda_ms, device_ms, device_ms_by_kernel,
            device_ms_by_name, launches_per_call)
        from insenticap_model_tpu_torch.utils.tolerance import bf16_ulp_error
        from insenticap_model_tpu_torch.vocab import Vocab
        from tools import bench_torch_int8 as bti
        from tools import bench_torch_megacell as btm
    except ImportError as e:
        _fail(f"the port's package is not importable here: {e}")
    import numpy as np

    dev = torch.device("cuda")
    report = {}

    # -- 1. device and build ------------------------------------------------
    smi = _smi()
    print(f"device: {smi}")
    print(f"SM clock, maximum (nvidia-smi clocks.max.sm): "
          f"{_smi('clocks.max.sm')}; the tanh bounds take "
          f"{SM_CLOCK_HZ / 1e6:.0f} MHz")
    t0 = time.time()
    _build.build(SOURCES)                  # one nvcc each, all together
    build_s = time.time() - t0
    t0 = time.time()
    _build.build_host("imgdec")            # the host image decoders (c++)
    _build.build_host("fstore")            # the feature-store gather (c++)
    from tools.build_anchor_torch import ensure_isclm
    ensure_isclm()                         # the LM tool of phase 3i
    host_build_s = time.time() - t0
    print(f"kernel build: {build_s:.1f} s; host builds (image decoders, "
          "feature-store gather, isclm where absent): "
          f"{host_build_s:.1f} s")
    report["host_build_s"] = host_build_s
    for name, log in sorted(_build.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    report["build_s"] = build_s
    # the int8 attention's instances by beam and tanh; where this run built
    # the source, the B = 3 ones must spill nothing
    i8_ptxas = {}
    for entry, r in _build.ptxas_report(
            _build.build_logs.get("fused_attention", "")).items():
        m = re.search(r"beam_att_i8_kernelILi(\d+)ELb([01])E", entry)
        if m:
            i8_ptxas[f"B={m.group(1)} " + ("factored exp" if m.group(2)
                                           == "1" else "tanhf")] = r
    for name, r in sorted(i8_ptxas.items()):
        print(f"  ptxas beam_att_i8_kernel {name}: {r.get('registers')} "
              f"registers, spill stores {r.get('spill_stores')} bytes, "
              f"loads {r.get('spill_loads')} bytes")
    if "fused_attention" in _build.build_logs:
        b3 = [r for name, r in i8_ptxas.items() if name.startswith("B=3 ")]
        _check(len(b3) == 2 and all(
            r.get("spill_stores") == 0 and r.get("spill_loads") == 0
            for r in b3), f"int8 attention at B=3 spills: {i8_ptxas}")
    report["ptxas_attention_i8"] = i8_ptxas

    settings = Settings()
    ids = cap.TokenIds(pad=0, unk=1, sos=2, eos=3, neutral=2)
    gen = torch.Generator().manual_seed(0)
    cap32 = cap.init_params(gen, VOCAB, NUM_CATS, settings, device=dev)
    det32 = sd.init_params(gen, NUM_CATS, settings, device=dev)
    cap16, det16 = cast_bf16(cap32), cast_bf16(det32)
    g = torch.Generator(device=dev).manual_seed(1)
    H, Ah, Fe, N = (settings.rnn_hid_dim, settings.att_hid_dim,
                    settings.feat_emb_dim, 14 * 14)
    C0 = settings.att_feat_dim

    # -- 2. every kernel against its plain version at serving shapes -------
    checks = {}
    att_in = {}

    def att_tol(dt, got, want):
        if dt == torch.bfloat16:   # one bf16 rounding of the same f32 value
            return _within_rounding(torch, got, want, 1e-2, 1e-3)
        # f32: another order of the same sums
        return _within_rounding(torch, got, want, 1e-4, 1e-4)

    for dt in (torch.bfloat16, torch.float32):
        p_cont = (cap16 if dt == torch.bfloat16 else cap32)[
            "attention"]["cont"]
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        att = torch.rand(BS, N, Fe, generator=g, device=dev).to(dt)
        p_att = torch.rand(BS, N, Ah, generator=g, device=dev).to(dt)
        # v1 at the narrowest, the serving and the widest beam
        for b_ in ATT_BEAMS:
            hb = (torch.rand(BS * b_, H, generator=g, device=dev) * 2
                  - 1).to(dt)
            got = fa.beam_content_attention(hb, p_cont, att, p_att, B=b_)
            torch.cuda.synchronize()
            want_b = fa.beam_content_attention_plain(hb, p_cont, att, p_att,
                                                     B=b_)
            ok, err = att_tol(dt, got, want_b)
            checks[f"attention_{tag}_B{b_}"] = err
            print(f"check attention {tag} bs={BS} B={b_}: max_abs_err="
                  f"{err:.3g} {'ok' if ok else 'FAIL'}")
            _check(ok, f"attention kernel {tag} B={b_} disagrees with its "
                   "plain version")
            if b_ == BEAM:
                h, want = hb, want_b
        checks[f"attention_{tag}"] = checks[f"attention_{tag}_B{BEAM}"]
        # v1 at the RL and reproduce dumps' shape, rl_bs 40 at beam 3
        # (bf16 also with tanhf), on inputs of their own
        gd = torch.Generator(device=dev).manual_seed(40)
        hd = (torch.rand(RL_BS * BEAM, H, generator=gd, device=dev) * 2
              - 1).to(dt)
        attd = torch.rand(RL_BS, N, Fe, generator=gd, device=dev).to(dt)
        p_attd = torch.rand(RL_BS, N, Ah, generator=gd, device=dev).to(dt)
        want_d = fa.beam_content_attention_plain(hd, p_cont, attd, p_attd,
                                                 B=BEAM)
        for exact in ((False, True) if dt == torch.bfloat16 else (False,)):
            got = fa.beam_content_attention(hd, p_cont, attd, p_attd, B=BEAM,
                                            exact_tanh=exact)
            torch.cuda.synchronize()
            ok, err = att_tol(dt, got, want_d)
            key = f"attention_{tag}_bs{RL_BS}" + ("_tanhf" if exact else "")
            checks[key] = err
            print(f"check attention {tag} bs={RL_BS} B={BEAM}"
                  f"{' with tanhf' if exact else ''} (the dumps' shape): "
                  f"max_abs_err={err:.3g} {'ok' if ok else 'FAIL'}")
            _check(ok, f"attention kernel {tag} at bs={RL_BS} B={BEAM} "
                   "disagrees with its plain version")
        del hd, attd, p_attd, want_d
        if dt == torch.bfloat16:
            # the bf16 instance's tanh.approx.f32 against tanhf: both held
            # to the same tolerance, both errors kept
            got = fa.beam_content_attention(h, p_cont, att, p_att, B=BEAM,
                                            exact_tanh=True)
            torch.cuda.synchronize()
            ok, err = att_tol(dt, got, want)
            checks["attention_bf16_tanhf"] = err
            print(f"check attention bf16 bs={BS} B={BEAM} with tanhf: "
                  f"max_abs_err={err:.3g} (tanh.approx.f32: "
                  f"{checks['attention_bf16']:.3g}) {'ok' if ok else 'FAIL'}")
            _check(ok, "attention kernel bf16 with tanhf disagrees with its "
                   "plain version")
        del hb, want_b
        att_in[dt] = (h, p_cont, att, p_att)
        # v2: the same inputs, v1's tolerances
        got = fa.beam_content_attention(h, p_cont, att, p_att, B=BEAM,
                                        variant="v2")
        torch.cuda.synchronize()
        want = fa.beam_content_attention_plain(h, p_cont, att, p_att, B=BEAM,
                                               variant="v2")
        ok, err = att_tol(dt, got, want)
        checks[f"attention_v2_{tag}"] = err
        print(f"check attention v2 {tag} bs={BS}: max_abs_err={err:.3g} "
              f"{'ok' if ok else 'FAIL'}")
        _check(ok, f"attention v2 kernel {tag} disagrees with its plain "
               "version")

    # the fused classifier top-k at the decode's rows: values within 1e-4,
    # indices identical except at near-ties (the plain version's
    # neighbouring values within 1e-4: the logits are sums in another
    # order), bans held
    rows = BS * BEAM
    last = torch.randint(0, VOCAB, (rows,), generator=g, device=dev)
    topk_in = {}
    for dt in (torch.bfloat16, torch.float32):
        cp = (cap16 if dt == torch.bfloat16 else cap32)["classifier"]
        hq = (torch.rand(rows, H, generator=g, device=dev) * 2 - 1).to(dt)
        args = (hq, cp["weight"], cp["bias"], last)
        gv, gi = ft.classifier_topk(*args, k=BEAM, banned=BANNED)
        torch.cuda.synchronize()
        pv, pi = ft.classifier_topk_plain(*args, k=BEAM + 1, banned=BANNED)
        gv, gi, pv, pi = gv.cpu(), gi.cpu(), pv.cpu(), pi.cpu()
        err = float((gv - pv[:, :BEAM]).abs().max())
        swapped = (gi != pi[:, :BEAM]).nonzero().tolist()
        near = [min(abs(float(pv[r, j] - pv[r, q])) for q in (j - 1, j + 1)
                    if 0 <= q <= BEAM) for r, j in swapped]
        bans_ok = not (torch.isin(gi, torch.tensor(BANNED)).any()
                       or (gi == last.cpu()[:, None]).any())
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        ok = err <= 1e-4 and all(x <= 1e-4 for x in near) and bans_ok
        checks[f"classifier_topk_{tag}"] = err
        checks[f"classifier_topk_{tag}_near_tie_swaps"] = len(swapped)
        print(f"check classifier_topk {tag} rows={rows} V={VOCAB}: "
              f"max_abs_err={err:.3g}, {len(swapped)} index swaps at "
              f"near-ties (gaps {[f'{x:.2g}' for x in near]}), bans held "
              f"{bans_ok} {'ok' if ok else 'FAIL'}")
        _check(ok, f"classifier_topk kernel {tag} disagrees with its plain "
               "version")
        topk_in[dt] = args
    # the bf16 pass's wgmma product alone against the f32 library product
    # of the same bf16 values: products exact in f32, sums in another
    # order, held to 1e-4 of the logits' scale (a layout fault is O(1))
    hq, wq = topk_in[torch.bfloat16][:2]
    got = ft.wgmma_product(hq, wq)
    torch.cuda.synchronize()
    with nn.exact_numerics():
        want = hq.float() @ wq.float().t()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    checks["topk_wgmma_product"] = err
    ok = err <= 1e-4 * max(1.0, scale)
    print(f"check topk wgmma product bf16 [{rows},{H}]x[{H},{VOCAB}]: "
          f"max_abs_err={err:.3g} (logits scale {scale:.3g}) "
          f"{'ok' if ok else 'FAIL'}")
    _check(ok, "the top-k's wgmma product disagrees with torch.matmul")
    del got, want

    x16 = torch.rand(14, 14, BS, C0, generator=g, device=dev).to(
        torch.bfloat16)
    convs = det16["convs"]
    v = wk.wino_input(x16)
    torch.cuda.synchronize()
    ok, err = _within_rounding(torch, v, wk.wino_input_plain(x16), 1e-2,
                               1e-3)
    checks["wino_input"] = err
    print(f"check wino_input bf16: max_abs_err={err:.3g} "
          f"{'ok' if ok else 'FAIL'}")
    _check(ok, "wino_input kernel disagrees with its plain version")
    # the detector's own input: the permuted view of NHWC features, read
    # in place through its strides (no copy); the same values as x16
    feats16 = x16.permute(2, 0, 1, 3).contiguous()
    x16_view = feats16.permute(1, 2, 0, 3)
    v_view = wk.wino_input(x16_view)
    torch.cuda.synchronize()
    same = torch.equal(v_view, v)
    checks["wino_input_view_equal"] = same
    print(f"check wino_input bf16 on the permuted NHWC view: identical to "
          f"the contiguous input's {'ok' if same else 'FAIL'}")
    _check(same, "wino_input on the permuted view differs from the "
           "contiguous input's")
    del v_view

    def gemm(v, w):
        cin, cout = w.shape[2], w.shape[3]
        with nn.exact_numerics():
            u = transform_filter(w).to(v.dtype).reshape(49, cin, cout)
            return torch.bmm(v.reshape(49, -1, cin), u).reshape(
                49, 9, BS, cout)
    m1 = gemm(v, convs[0]["weight"])
    b1 = convs[0]["bias"]
    v2 = wk.wino_middle(m1, b1, 14, 14)
    torch.cuda.synchronize()
    ok, err = _within_rounding(torch, v2, wk.wino_middle_plain(m1, b1, 14, 14),
                               1e-2, 1e-3)
    checks["wino_middle"] = err
    print(f"check wino_middle bf16: max_abs_err={err:.3g} "
          f"{'ok' if ok else 'FAIL'}")
    _check(ok, "wino_middle kernel disagrees with its plain version")
    m2 = gemm(v2, convs[1]["weight"])
    b2 = convs[1]["bias"]
    y = wk.wino_output(m2, b2, 14, 14)
    torch.cuda.synchronize()
    ok, err = _within_rounding(torch, y, wk.wino_output_plain(m2, b2, 14, 14),
                               1e-2, 1e-3)
    checks["wino_output"] = err
    print(f"check wino_output bf16: max_abs_err={err:.3g} "
          f"{'ok' if ok else 'FAIL'}")
    _check(ok, "wino_output kernel disagrees with its plain version")
    # the same f32 sums in the same order as the twin, one rounding: equal;
    # M one element past an aligned base takes the kernel's element-wise
    # path, which must give the same numbers; f32 within rounding
    same = torch.equal(y, wk.wino_output_plain(m2, b2, 14, 14))
    buf = torch.empty(m2.numel() + 1, dtype=m2.dtype, device=dev)
    m2_off = buf[1:].view(m2.shape)
    m2_off.copy_(m2)
    same_off = torch.equal(wk.wino_output(m2_off, b2, 14, 14), y)
    del buf, m2_off
    m2_32 = m2.float()
    ok32, err32 = _within_rounding(
        torch, wk.wino_output(m2_32, b2, 14, 14),
        wk.wino_output_plain(m2_32, b2, 14, 14), 1e-5, 1e-5)
    del m2_32
    torch.cuda.synchronize()
    checks.update(wino_output_equal=same,
                  wino_output_elementwise_equal=same_off,
                  wino_output_f32=err32)
    ok = same and same_off and ok32
    print(f"check wino_output bf16 equal to its plain version {same}, "
          f"element-wise path (M off its alignment) equal {same_off}; f32: "
          f"max_abs_err={err32:.3g} {'ok' if ok else 'FAIL'}")
    _check(same and same_off, "wino_output kernel is not equal to its plain "
           "version in bf16, or its element-wise path differs")
    _check(ok32, "wino_output f32 kernel disagrees with its plain version")

    # the whole stack: kernels against the plain stack at the same cast
    # points, and both against the f32 direct conv chain
    layers16 = [(c["weight"], c["bias"]) for c in convs]
    stack_k = wk.conv3x3_stack_sm(x16_view, layers16).float()
    del x16_view, feats16
    ref = x16.float().permute(2, 0, 1, 3)
    for c in det32["convs"]:
        ref = nn.conv2d(c, ref)                    # f32, TF32 off
    ref = ref.permute(1, 2, 0, 3)
    direct16 = x16.permute(2, 0, 1, 3)
    for c in convs:
        direct16 = nn.conv2d(c, direct16)
    direct16 = direct16.permute(1, 2, 0, 3).float()
    # the plain stack on the card: the twins' arithmetic on CUDA tensors
    vp = wk.wino_input_plain(x16)
    mp = gemm(vp, convs[0]["weight"])
    vp = wk.wino_middle_plain(mp, b1, 14, 14)
    mp = gemm(vp, convs[1]["weight"])
    stack_p = wk.wino_output_plain(mp, b2, 14, 14).float()
    del vp, mp
    scale = float(ref.abs().max())
    rms = lambda a: float(a.float().pow(2).mean().sqrt())  # noqa: E731
    diff_rms = rms(stack_k - stack_p) / rms(stack_p)
    diff_max = float((stack_k - stack_p).abs().max()) / scale
    err_k = float((stack_k - ref).abs().max()) / scale
    err_p = float((stack_p - ref).abs().max()) / scale
    err_direct = float((direct16 - ref).abs().max()) / scale
    conv_rule = max(4 * err_direct, 0.05)
    checks.update(stack_rms_vs_plain=diff_rms, stack_max_vs_plain=diff_max,
                  stack_err_kernel=err_k,
                  stack_err_plain=err_p, stack_err_bf16_direct=err_direct)
    print(f"check winograd stack bf16: rms(kernel-plain)/rms(plain)="
          f"{diff_rms:.3g} (<= 2e-2), max|kernel-plain| {diff_max:.3g} of "
          f"scale; max err vs f32 conv, of scale: "
          f"kernel {err_k:.4g}, plain {err_p:.4g} (kernel <= 1.25 x plain "
          f"+ 1e-3); bf16 direct conv {err_direct:.4g}; the "
          f"max(4 x direct, 0.05) = {conv_rule:.4g} rule "
          f"{'met' if err_k <= conv_rule else 'not met: F(5x5,3x3) loses more in bf16 than that rule allows, in the plain version as well'}")
    _check(diff_rms <= 2e-2, "Winograd stack kernels disagree with the "
           "plain stack")
    _check(err_k <= 1.25 * err_p + 1e-3, "Winograd stack kernels lose more "
           "against the f32 conv than the plain stack does")
    del stack_k, stack_p, ref, direct16, m1, m2, v, v2, y
    torch.cuda.empty_cache()

    # the stem's ceil-mode max pool at the serving buckets' shapes, an odd
    # extent (the ceil-pad row and column masked) and the spatial-major
    # form: max is exact, so torch.equal
    pool_in = {}
    for dt in (torch.bfloat16, torch.float32):
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        for name, shape in list(POOL_SHAPES.items()) + [
                ("odd", (5, 111, 97, 64))]:
            xp = torch.randn(shape, generator=g, device=dev).to(dt)
            same = torch.equal(pool.ceil_maxpool_3x3s2_nhwc(xp),
                               pool.ceil_maxpool_3x3s2_plain(xp))
            if name == "odd":
                same = same and torch.equal(
                    pool.ceil_maxpool_3x3s2_sm(
                        xp.permute(1, 2, 0, 3).contiguous())
                    .permute(2, 0, 1, 3), pool.ceil_maxpool_3x3s2_plain(xp))
            else:
                pool_in[(name, dt)] = xp
            torch.cuda.synchronize()
            print(f"check ceil_maxpool_3x3s2 {tag} {list(shape)}: equal "
                  f"{same} {'ok' if same else 'FAIL'}")
            _check(same, f"max pool kernel {tag} {shape} differs from its "
                   "plain version")
    checks["ceil_maxpool_3x3s2"] = 0.0

    # the int8-storage attention at the study's shapes: bf16 h and weights,
    # int8 att/p_att with per-(image, channel) scales; the kernel and its
    # plain version both sum in f32 and round once to bf16
    p_cont16 = cap16["attention"]["cont"]
    h16 = (torch.rand(BS * BEAM, H, generator=g, device=dev) * 2 - 1).to(
        torch.bfloat16)
    att_f = torch.randn(BS, N, Fe, generator=g, device=dev)
    p_att_f = torch.randn(BS, N, Ah, generator=g, device=dev)
    i8_in = (h16, p_cont16) + fa8.quantize_per_channel(att_f) \
        + fa8.quantize_per_channel(p_att_f)
    got = fa8.beam_content_attention_i8(*i8_in, B=BEAM)
    torch.cuda.synchronize()
    err, ulps = bf16_ulp_error(
        got, fa8.beam_content_attention_i8_plain(*i8_in, B=BEAM))
    ok = ulps <= 1
    checks["attention_i8"] = err
    print(f"check attention_i8 bs={BS} N={N} {Fe} wide: max_abs_err={err:.3g}"
          f" ({ulps:.2f} bf16 ulp) {'ok' if ok else 'FAIL'}")
    _check(ok, "int8 attention kernel disagrees with its plain version")
    # the tanhf entry, held to the same check
    got = fa8.beam_content_attention_i8(*i8_in, B=BEAM, exact_tanh=True)
    torch.cuda.synchronize()
    err, ulps = bf16_ulp_error(
        got, fa8.beam_content_attention_i8_plain(*i8_in, B=BEAM))
    ok = ulps <= 1
    checks["attention_i8_tanhf"] = err
    print(f"check attention_i8 with tanhf bs={BS} N={N} {Fe} wide: "
          f"max_abs_err={err:.3g} ({ulps:.2f} bf16 ulp) "
          f"{'ok' if ok else 'FAIL'}")
    _check(ok, "int8 attention kernel with tanhf disagrees with its plain "
           "version")

    # the row-tiled product at the decode cell's LSTM shapes, every tile
    mm_in = {}
    for name, K, Nw in btm.LSTM_SHAPES:
        x, w = btm.make_inputs(K, Nw, dev, seed=K)
        want = tmm.tiled_mm_plain(x, w)
        for tile_b in btm.TILE_BS:
            tr = tile_b * BEAM
            got = tmm.tiled_mm(x, w, tile_rows=tr)
            torch.cuda.synchronize()
            err, ulps = bf16_ulp_error(got, want)
            ok = ulps <= 1
            checks[f"tiled_mm_{name}_{tr}"] = err
            print(f"check tiled_mm {name} [{x.shape[0]}x{K}]@[{K}x{Nw}] "
                  f"tile_rows={tr}: max_abs_err={err:.3g} ({ulps:.2f} bf16 "
                  f"ulp) {'ok' if ok else 'FAIL'}")
            _check(ok, f"tiled_mm kernel {name} tile_rows={tr} disagrees "
                   "with its plain version")
        mm_in[name] = (x, w)
    # the kernel's other cases: K = 4096, whose 64-column slab (512 KB)
    # does not fit a block, so w streams with x; and a tile of 5 rows,
    # which runs as wgmma n8 with 3 zero rows
    for tr, K, Nw, rows_ in ((24, 4096, 2048, 1152), (96, 4096, 2048, 1152),
                             (5, 1536, 2048, 1150)):
        x = (torch.randn(rows_, K, generator=g, device=dev) * 0.02).to(
            torch.bfloat16)
        w = (torch.randn(K, Nw, generator=g, device=dev) * 0.02).to(
            torch.bfloat16)
        pl = tmm.plan(rows_, tr, K, Nw, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        got = tmm.tiled_mm(x, w, tile_rows=tr)
        torch.cuda.synchronize()
        err, ulps = bf16_ulp_error(got, tmm.tiled_mm_plain(x, w))
        ok = ulps <= 1
        checks[f"tiled_mm_K{K}_{tr}"] = err
        print(f"check tiled_mm [{rows_}x{K}]@[{K}x{Nw}] tile_rows={tr} "
              f"(n{pl.n}, w {'resident' if pl.resident else 'streamed'}, "
              f"{pl.stages} stages): max_abs_err={err:.3g} ({ulps:.2f} bf16 "
              f"ulp) {'ok' if ok else 'FAIL'}")
        _check(ok, f"tiled_mm kernel K={K} tile_rows={tr} disagrees with "
               "its plain version")
    del got, want, x, w

    # -- 3. the main path: full-width bf16 serving through DynamicBatcher --
    rng = np.random.default_rng(2)
    n_req = 41
    fcs = rng.random((n_req, settings.fc_feat_dim), np.float32)
    atts = rng.random((n_req, 14, 14, C0), np.float32)
    sentis = rng.integers(4, VOCAB, size=(n_req, M))
    forced = [AUTO] + [AUTO, 1, AUTO, 0, 2, AUTO] + \
        [AUTO if i % 3 else i % NUM_CATS for i in range(30)] + [0, 1, 2, 1]
    groups = ([0], range(1, 7), range(7, 37), range(37, 41))

    zero_counters, read_counters = _launch_counters()

    with _switches("default"):
        batcher = DynamicBatcher(cap32, det32, settings=settings, ids=ids,
                                 beam_size=BEAM, max_seq_len=T,
                                 max_wait_s=0.25, num_sentiments=M,
                                 num_cats=NUM_CATS, compute_dtype="bfloat16",
                                 device=dev)
        try:
            batcher.warm([1, 8, 32])
            torch.cuda.synchronize()
            zero_counters()
            results, errors, serve_s = _serve(batcher, fcs, atts, sentis,
                                              forced, groups)
            launches = read_counters()
            stats = batcher.stats()
        finally:
            batcher.close()
    _check_results(results, errors)
    by = stats["by_bucket"]
    _check(by[1] >= 1 and by[8] >= 1 and by[32] >= 1,
           f"buckets dispatched: {by}")
    print(f"serve: {n_req} requests in {serve_s:.2f} s, batches by bucket "
          f"{by}, launches {launches}")
    for k in ("beam_content_attention", "wino_input", "wino_middle",
              "wino_output"):
        _check(launches[k] > 0, f"kernel {k} never launched on the main path")
    report.update(serve_s=serve_s, by_bucket=by, launches=launches,
                  labels=sorted({r[2] for r in results}))
    # phase 3l's mesh batcher answers the same requests
    phase3 = (fcs, atts, sentis, forced, groups, results)

    # -- 3b. the trained path: checkpoint weights, both kernel switches ----
    t0 = time.time()
    trained, meta = tck.load(TRAINED_CKPT, device=dev)
    load_s = time.time() - t0
    _check(meta.get("vocab_size") == VOCAB and set(trained) == {"captioner"},
           f"unexpected checkpoint: {sorted(trained)}, "
           f"{meta.get('vocab_size')}")
    cap_t = trained["captioner"]
    # the checkpoint holds the captioner only; the detector from a seed
    det_t = sd.init_params(torch.Generator().manual_seed(3), NUM_CATS,
                           settings, device=dev)
    rng = np.random.default_rng(4)
    n_t = 40
    fcs_t = rng.standard_normal((n_t, settings.fc_feat_dim), np.float32)
    atts_t = rng.standard_normal((n_t, 14, 14, C0), np.float32)
    sentis_t = rng.integers(4, VOCAB, size=(n_t, M))
    forced_t = [AUTO if i % 3 else i % NUM_CATS for i in range(n_t)]
    with _switches("both"):
        batcher = DynamicBatcher(cap_t, det_t, settings=settings, ids=ids,
                                 beam_size=BEAM, max_seq_len=T,
                                 max_wait_s=0.25, num_sentiments=M,
                                 num_cats=NUM_CATS, compute_dtype="bfloat16",
                                 device=dev)
        try:
            batcher.warm([1, 8, 32])
            torch.cuda.synchronize()
            zero_counters()
            results_t, errors_t, serve_t_s = _serve(
                batcher, fcs_t, atts_t, sentis_t, forced_t,
                ([0], range(1, 7), range(7, 37), range(37, 40)))
            launches_t = read_counters()
            stats_t = batcher.stats()
        finally:
            batcher.close()
    _check_results(results_t, errors_t)
    lens = _first_eos(np.stack([r[0] for r in results_t]), ids.eos)
    steps_per_batch = launches_t["classifier_topk"] / stats_t["batches"]
    print(f"trained serve: checkpoint read in {load_s:.2f} s; {n_t} "
          f"requests in {serve_t_s:.2f} s, batches by bucket "
          f"{stats_t['by_bucket']}, launches {launches_t}; caption length "
          f"mean {lens.mean():.2f} max {lens.max()} (all beams), "
          f"{steps_per_batch:.2f} decode steps a batch")
    for k in ("classifier_topk", "beam_content_attention_v2"):
        _check(launches_t[k] > 0, f"kernel {k} never launched on the "
               "trained path")
    _check(launches_t["beam_content_attention"] == 0,
           "ISC_ATT_KERNEL=v2 still launched the v1 attention")
    _check(lens.max() < T, f"a caption did not end: max length {lens.max()}")
    _check(8.0 <= lens.mean() <= 13.0, f"mean caption length {lens.mean()}")
    _check(launches_t["classifier_topk"] < T * stats_t["batches"],
           "the trained decode never exited early")
    report["trained_serve"] = {
        "checkpoint_load_s": load_s, "serve_s": serve_t_s,
        "by_bucket": stats_t["by_bucket"], "launches": launches_t,
        "mean_len": float(lens.mean()), "max_len": int(lens.max()),
        "steps_per_batch": steps_per_batch}

    # -- 3c. the image path: uint8 images -> ResNet-101 + concepts -> ------
    # sentiment words -> captions, two batchers chained
    gen_e = torch.Generator().manual_seed(5)
    enc32 = encoder.init_params(gen_e, device=dev)
    cpt32 = cpt.init_params(gen_e, N_CONCEPTS, settings, device=dev)
    # the seeded MLP on these features saturates its scores at 1.0 (the
    # top-5 is then the lowest ids, whatever the features): fc3 is scaled
    # so that its logits on 4 images of the seed have a standard deviation
    # of 2 (ReLU is positively homogeneous, so this only scales them)
    with torch.no_grad():
        probe = torch.randint(0, 256, (4, 448, 448, 3), dtype=torch.uint8,
                              generator=gen_e).to(dev)
        fc_probe = encoder.forward_raw_batch(enc32, probe,
                                             use_kernels=False)[0]
        hid = torch.relu(nn.linear(cpt32["fc2"], torch.relu(
            nn.linear(cpt32["fc1"], fc_probe))))
        z_std = float(nn.linear(cpt32["fc3"], hid).std())
        for k in ("weight", "bias"):
            cpt32["fc3"][k] = cpt32["fc3"][k] * (2.0 / z_std)
    del probe, fc_probe, hid
    report["concept_logit_scale"] = 2.0 / z_std
    enc16 = cast_bf16(enc32)
    rng = np.random.default_rng(6)
    idx2concept = [f"concept{i}" for i in range(N_CONCEPTS)]
    words = ["<PAD>", "<UNK>", "<SOS>", "<EOS>"] + [
        f"word{i}" for i in range(VOCAB - 4)]
    vocab = Vocab(words)
    _check((vocab.pad_id, vocab.unk_id, vocab.sos_id, vocab.eos_id)
           == (ids.pad, ids.unk, ids.sos, ids.eos), "vocab special ids")
    senti_table = {c: [[words[int(w)], float(s)] for w, s in zip(
        rng.integers(4, VOCAB, 6), rng.random(6))] for c in idx2concept}
    n_img, n_fc = 40, 4
    shapes = [DEFAULT_BUCKET_SHAPES[i % 3] for i in range(n_img)]
    imgs = [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
            for h, w in shapes]
    fcs_c = rng.random((n_fc, settings.fc_feat_dim), np.float32)
    atts_c = rng.random((n_fc, 14, 14, C0), np.float32)
    forced_c = [AUTO if i % 3 else i % NUM_CATS for i in range(n_img + n_fc)]

    def image_request(eb, db):
        def request(i):
            if i < n_img:
                fc, att, top = eb.submit_image(imgs[i], timeout=600)
            else:
                fc, att = fcs_c[i - n_img], atts_c[i - n_img]
                top = eb.submit_fc(fc, timeout=600)
            sentis = senti_word_ids([idx2concept[k] for k in top],
                                    senti_table, vocab, M)
            return top, sentis, db.submit(fc, att, sentis,
                                          forced_label=forced_c[i],
                                          timeout=600)
        return request

    eb = EncodeBatcher(lambda x: encoder.forward_raw_batch(enc16, x),
                       make_cpt_apply(cpt32, K_CONCEPTS),
                       fc_dim=settings.fc_feat_dim,
                       shape_buckets=DEFAULT_BUCKET_SHAPES, max_wait_s=0.05,
                       device=dev)
    db = DynamicBatcher(cap32, det32, settings=settings, ids=ids,
                        beam_size=BEAM, max_seq_len=T, max_wait_s=0.05,
                        num_sentiments=M, num_cats=NUM_CATS,
                        compute_dtype="bfloat16", device=dev)
    try:
        with _switches("default"):
            t0 = time.time()
            eb.warm()
            db.warm([1, 8, 32])
            torch.cuda.synchronize()
            warm_c_s = time.time() - t0
            zero_counters()
            results_c, errors_c, serve_c_s = _run_groups(
                image_request(eb, db), n_img + n_fc,
                ([0], range(1, 7), range(7, 37), range(37, n_img + n_fc)))
            launches_c = read_counters()
            enc_stats, dec_stats = eb.stats(), db.stats()
            # encode throughput: 96 images of 448x448 in flight at once
            tput = [rng.integers(0, 256, size=(448, 448, 3), dtype=np.uint8)
                    for _ in range(3 * ENC_BS)]
            torch.cuda.synchronize()
            _, errors_t, tput_s = _run_groups(
                lambda i: eb.submit_image(tput[i], timeout=600),
                len(tput), [range(len(tput))])
            _check(not errors_t, f"throughput requests failed: {errors_t}")
    finally:
        eb.close()
        db.close()
    _check(not errors_c, f"image-path requests failed: {errors_c}")
    _check_results([r[2] for r in results_c], [])
    for top, sentis, _ in results_c:
        top = np.asarray(top)
        _check(top.shape == (K_CONCEPTS,) and top.min() >= 0
               and top.max() < N_CONCEPTS, f"concept ids {top}")
        _check(len(set(top.tolist())) == K_CONCEPTS, "repeated concept id")
    img_groups = sum(enc_stats["by_bucket"][f"{h}x{w}"]
                     for h, w in DEFAULT_BUCKET_SHAPES)
    print(f"image path: {n_img} images + {n_fc} fc requests in "
          f"{serve_c_s:.2f} s (warm-up {warm_c_s:.1f} s); encode groups by "
          f"bucket {enc_stats['by_bucket']}, decode batches by bucket "
          f"{dec_stats['by_bucket']}, launches {launches_c}; encode "
          f"throughput {len(tput) / tput_s:.1f} images/s ({len(tput)} "
          f"images of 448x448 in {tput_s:.2f} s)")
    _check(enc_stats["requests"] == n_img + n_fc
           and enc_stats["failed_requests"] == 0, f"encode stats {enc_stats}")
    _check(launches_c["ceil_maxpool_3x3s2"] > 0
           and launches_c["ceil_maxpool_3x3s2"] == img_groups,
           f"max pool launches {launches_c['ceil_maxpool_3x3s2']} != "
           f"{img_groups} image encode groups")
    for k in ("beam_content_attention", "wino_input", "wino_middle",
              "wino_output"):
        _check(launches_c[k] > 0, f"kernel {k} never launched on the image "
               "path")
    report["image_path"] = {
        "serve_s": serve_c_s, "warm_s": warm_c_s,
        "encode_by_bucket": enc_stats["by_bucket"],
        "encode_latency": enc_stats["latency_by_bucket"],
        "decode_by_bucket": dec_stats["by_bucket"],
        "decode_latency": dec_stats["latency_by_bucket"],
        "padded_rows": enc_stats["padded_rows"], "launches": launches_c,
        "encode_images_per_s_448": len(tput) / tput_s,
        "labels": sorted({int(r[2][2]) for r in results_c}),
        "distinct_concept_sets": len({tuple(np.asarray(r[0]).tolist())
                                      for r in results_c})}
    del tput, imgs
    torch.cuda.empty_cache()

    # -- 3d. the two studies' paths at full shapes, few repetitions -------
    fa.beam_content_attention.launches = 0
    fa8.beam_content_attention_i8.launches = 0
    study_t, study_err, study_calls = bti.attention(dev, iters=4, reps=3)
    launches_d = {"beam_content_attention_i8":
                  fa8.beam_content_attention_i8.launches,
                  "beam_content_attention": fa.beam_content_attention.launches}
    tmm.tiled_mm.launches = 0
    mega = btm.measure(dev, iters=16, reps=3)
    launches_d["tiled_mm"] = tmm.tiled_mm.launches
    i8_t, v1_t = (study_t["int8_device_ms"]["total"],
                  study_t["bf16_device_ms"]["total"])
    print(f"studies: int8 attention device {i8_t:.4f} ms (events "
          f"{study_t['int8_ms']:.4f}) against the bf16 v1 kernel's "
          f"{v1_t:.4f} ms (events {study_t['bf16_ms']:.4f}), context error "
          + ", ".join(f"{k} mean {v['mean']:.5f} max {v['max']:.4f}"
                      for k, v in study_err.items())
          + "; decode cell: " + "; ".join(
              f"{name} device ms: matmul "
              f"{mega[name]['matmul_device_ms']:.4f}, tiled "
              + ", ".join(f"{tr}: {t:.4f}" for tr, t in
                          mega[name]["tiled_device_ms"].items())
              for name, _, _ in btm.LSTM_SHAPES)
          + f"; launches {launches_d}")
    _check(launches_d["beam_content_attention_i8"] == study_calls["i8"]
           and launches_d["beam_content_attention"] == study_calls["v1"],
           f"attention launches {launches_d} != calls {study_calls}")
    _check(launches_d["tiled_mm"] == mega["calls"],
           f"tiled_mm launches {launches_d['tiled_mm']} != {mega['calls']}")
    _check(all(np.isfinite(v["max"]) for v in study_err.values()),
           f"int8 context error {study_err}")
    report["studies"] = {"attention_ms": study_t, "attention_error": study_err,
                         "megacell": mega, "launches": launches_d}

    # -- 3e. the serving surface: the HTTP daemon and the caption command --
    serve_keep_dir = tempfile.TemporaryDirectory(prefix="serve_keep_")
    serve_keep = {"dir": serve_keep_dir.name}
    report["serving_surface"] = _serving_surface(
        torch, np, dev, settings, cap32, det32, cpt32, enc32, words,
        idx2concept, senti_table, zero_counters, read_counters, serve_keep)
    torch.cuda.empty_cache()

    # -- 3f. the XE pre-training stage (train_xe) -------------------------
    xe_keep = {}
    report["train_xe"] = _train_xe(torch, np, dev, settings, cap_t,
                                   zero_counters, read_counters, xe_keep)
    torch.cuda.empty_cache()

    # -- 3g. the head-stage trainers and the concept CLIs -----------------
    report["head_stages"], trained = _head_stages(
        torch, np, dev, settings, zero_counters, read_counters)
    torch.cuda.empty_cache()

    # -- 3h. the RL fine-tuning stage (train_rl) -------------------------
    rl_keep = {}
    with tempfile.TemporaryDirectory(prefix="rl_") as rl_tmp, \
            tempfile.TemporaryDirectory(prefix="rl_keep_") as rl_copy:
        report["train_rl"] = _train_rl(torch, np, dev, settings,
                                       zero_counters, read_counters, trained,
                                       rl_tmp, rl_keep)
        del trained
        torch.cuda.empty_cache()
        _keep_rl_tree(rl_tmp, rl_copy, rl_keep["opts"])
        rl_keep["root"] = rl_copy

        # -- 3i. the offline and evaluation CLIs, on 3h's tree ------------
        offline_keep = {}
        report["offline_clis"] = _offline_clis(
            torch, np, dev, settings, enc32, zero_counters, read_counters,
            report["train_rl"]["files"], offline_keep)
        torch.cuda.empty_cache()

        # -- 3j. data-parallel training (parallel/mesh.py) -----------------
        report["data_parallel"] = _data_parallel(torch, np, dev, settings,
                                                 xe_keep)
        torch.cuda.empty_cache()

        # -- 3k. the RL stage's data-parallel training, on 3h's tree ------
        report["rl_data_parallel"] = _rl_data_parallel(torch, np, dev,
                                                       settings, rl_keep)
        torch.cuda.empty_cache()

        # -- 3l. sharded serving in one process (a DeviceMesh) -------------
        mp_keep = {}
        report["sharded_serving"] = _sharded_serving(
            torch, np, settings, ids, cap32, det32, enc32, cpt32, phase3,
            serve_keep, offline_keep, zero_counters, read_counters, mp_keep)
        torch.cuda.empty_cache()

        # -- 3m. multi-host serving: two processes sharing the one card ---
        report["multihost_serving"] = _multihost_serving(
            torch, np, settings, ids, cap32, det32, phase3, serve_keep,
            mp_keep)
        del mp_keep
        serve_keep_dir.cleanup()
        del offline_keep, serve_keep
        torch.cuda.empty_cache()

        # -- 3n. the 2-D data x model mesh: the vocabulary over two ranks --
        report["model_parallel"] = _model_parallel(torch, np, dev, settings,
                                                   xe_keep, rl_keep)
        del xe_keep, rl_keep
        torch.cuda.empty_cache()

    # -- 4. f32 end to end: kernel path against the plain path -------------
    params32 = inference.ServingParams(cap32, det32)
    fc = torch.rand(BS, settings.fc_feat_dim, generator=g, device=dev)
    att = torch.rand(BS, 14, 14, C0, generator=g, device=dev)
    sw = torch.randint(4, VOCAB, (BS, M), generator=g, device=dev)
    kw = dict(settings=settings, ids=ids, beam_size=BEAM, max_seq_len=T)
    # random weights give a flat 10,000-word distribution, so near-ties
    # are common there
    with _switches("default"):
        report["e2e_f32"] = _compare_e2e(
            torch, "random weights, default kernels",
            inference.detect_and_decode(params32, fc, att, sw, **kw),
            inference.detect_and_decode(params32, fc, att, sw,
                                        use_kernels=False, **kw))
    # the trained captioner in f32, standard-normal features, both switches
    params_t32 = inference.ServingParams(cast_f32(cap_t), det_t)
    fc_n = torch.randn(BS, settings.fc_feat_dim, generator=g, device=dev)
    att_n = torch.randn(BS, 14, 14, C0, generator=g, device=dev)
    with _switches("both"):
        ft.classifier_topk.launches = 0
        kernel_out = inference.detect_and_decode(params_t32, fc_n, att_n, sw,
                                                 **kw)
        steps_f32 = ft.classifier_topk.launches
        report["e2e_f32_trained_both"] = _compare_e2e(
            torch, "trained weights, both switches", kernel_out,
            inference.detect_and_decode(params_t32, fc_n, att_n, sw,
                                        use_kernels=False, **kw))
    _check(0 < steps_f32 < T, f"f32 trained decode ran {steps_f32} steps")
    report["e2e_f32_trained_both"]["steps"] = steps_f32

    # the served bf16 path on the trained weights against the bf16 plain
    # path: the share of images whose top beam is identical, for the
    # default entries (v1's tanh.approx.f32), v1 with tanhf (the op wrapped
    # for the run) and both switches. The default's share must reach
    # tanhf's, rounded down to a whole percent: the gate is set from tanhf
    # and is not loosened to fit a faster entry
    params_t16 = inference.ServingParams(cast_bf16(cap_t), cast_bf16(det_t))
    fc_t16, att_t16 = fc_n.bfloat16(), att_n.bfloat16()
    plain16 = inference.detect_and_decode(params_t16, fc_t16, att_t16, sw,
                                          use_kernels=False, **kw)

    def top_beam_rate():
        out = inference.detect_and_decode(params_t16, fc_t16, att_t16, sw,
                                          **kw)
        return {"top_beam_identical": float(
                    (out[0][:, 0] == plain16[0][:, 0]).all(dim=1)
                    .float().mean()),
                "labels_identical": float((out[2] == plain16[2])
                                          .float().mean())}
    bf16_rates = {}
    with _switches("default"):
        bf16_rates["default"] = top_beam_rate()
        with _v1_exact_tanh(fa):
            fa.beam_content_attention.launches = 0
            bf16_rates["v1_tanhf"] = top_beam_rate()
            _check(fa.beam_content_attention.launches > 0,
                   "the v1 tanhf run launched no attention kernel")
    with _switches("both"):
        bf16_rates["both_switches"] = top_beam_rate()
    gate = math.floor(100 * bf16_rates["v1_tanhf"]["top_beam_identical"]
                      + 1e-9) / 100
    print(f"bf16 bs={BS} trained weights, top beam identical to the bf16 "
          "plain path: " + ", ".join(
              f"{k} {v['top_beam_identical']:.2%} (labels "
              f"{v['labels_identical']:.2%})" for k, v in bf16_rates.items())
          + f"; gate: default >= {gate:.2f} (tanhf's, whole percent down)")
    report["bf16_top_beam_vs_plain"] = dict(bf16_rates, gate=gate)
    _check(bf16_rates["default"]["top_beam_identical"] >= gate,
           f"bf16 default top-beam share "
           f"{bf16_rates['default']['top_beam_identical']:.4f} below the "
           f"tanhf form's {gate:.2f}")

    # a beam wider than the kernels take (kernel_takes): bf16 at full width,
    # bs=8, through the plain cell and tail on the card, token for token the
    # use_kernels=False path, with no v1 or top-k launch
    params16 = inference.ServingParams(cap16, det16)
    fc9 = torch.rand(8, settings.fc_feat_dim, generator=g,
                     device=dev).bfloat16()
    att9 = torch.rand(8, 14, 14, C0, generator=g, device=dev).bfloat16()
    kw9 = dict(kw, beam_size=9)
    beam9 = {}
    for name in ("default", "fused_topk"):
        with _switches(name):
            zero_counters()
            got9 = inference.detect_and_decode(params16, fc9, att9, sw[:8],
                                               **kw9)
            l9 = read_counters()
            want9 = inference.detect_and_decode(params16, fc9, att9, sw[:8],
                                                use_kernels=False, **kw9)
        same = all(torch.equal(a, b) for a, b in zip(got9, want9))
        beam9[name] = {"identical_to_plain": same, "launches": l9}
        _check(tuple(got9[0].shape) == (8, 9, T) and same,
               f"beam 9 ({name}) differs from the plain path")
        _check(l9["beam_content_attention"] == 0
               and l9["classifier_topk"] == 0,
               f"beam 9 ({name}) launched a kernel that does not take it: "
               f"{l9}")
    print(f"beam 9 decode bf16 bs=8: identical to the plain path, launches "
          f"{ {k: v['launches'] for k, v in beam9.items()} }")
    report["beam9_decode"] = beam9

    # the detector's labels at bs=384: its bf16 path through the Winograd
    # kernels (deterministic, as served) and its bf16 direct conv, each
    # against the f32 direct conv, on uniform and on standard-normal
    # features: labels after the 0.7 threshold, argmax before it, and the
    # logits' max error. A record of what the bf16 F(5x5,3x3) loss does to
    # labels (the same in both packages): no limit is set, since the repo
    # has no trained detector to judge labels by
    label_check = {}
    for name, feats in (("uniform", att), ("normal", att_n)):
        l32 = sd.forward(det32, feats, use_kernels=False)[0]
        lab32 = sd.threshold_labels(l32, 0.7, ids.neutral)[0]
        wk.wino_input.launches = 0
        l16k = sd.forward(det16, feats.bfloat16())[0].float()
        _check(wk.wino_input.launches == 1, "the bf16 detector did not take "
               "the Winograd kernels")
        l16d = sd.forward(det16, feats.bfloat16(),
                          use_kernels=False)[0].float()
        for path, l16 in (("winograd", l16k), ("direct", l16d)):
            lab16 = sd.threshold_labels(l16, 0.7, ids.neutral)[0]
            label_check[f"{name}_bf16_{path}"] = {
                "labels_agree": float((lab16 == lab32).float().mean()),
                "argmax_agree": float((l16.argmax(-1) == l32.argmax(-1))
                                      .float().mean()),
                "logits_max_err": float((l16 - l32).abs().max()),
                "logits_scale": float(l32.abs().max()),
                "neutral_share_f32": float((lab32 == ids.neutral)
                                           .float().mean())}
    print(f"detector labels bf16 vs f32 direct bs={BS}: " + "; ".join(
        f"{k}: labels {v['labels_agree']:.4f}, argmax "
        f"{v['argmax_agree']:.4f}, logits max err {v['logits_max_err']:.4g}"
        f" (scale {v['logits_scale']:.4g}, f32 neutral share "
        f"{v['neutral_share_f32']:.3f})" for k, v in label_check.items()))
    report["detector_labels_bf16_vs_f32"] = label_check
    del params32, params_t32, kernel_out
    torch.cuda.empty_cache()

    # the f32 encoder at 448x448, pool kernel against the plain pool: the
    # pool is exact, so only cuDNN's choice of algorithm between calls may
    # move fc/att (held to 1e-5 of scale); concept ids identical. Then the
    # bf16 encoder against the f32 one: 101 layers of bf16 roundings, held
    # to an rms error of 0.1 of the f32 features' rms
    imgs4 = torch.randint(0, 256, (16, 448, 448, 3), dtype=torch.uint8,
                          generator=g, device=dev)
    fk, ak = encoder.forward_raw_batch(enc32, imgs4)
    fp, ap = encoder.forward_raw_batch(enc32, imgs4, use_kernels=False)
    e_fc = float((fk - fp).abs().max()) / float(fp.abs().max())
    e_att = float((ak - ap).abs().max()) / float(ap.abs().max())
    tk = cpt.sample(cpt32, fk, K_CONCEPTS)[1]
    tp_ = cpt.sample(cpt32, fp, K_CONCEPTS)[1]
    f16, a16 = encoder.forward_raw_batch(enc16, imgs4)
    rel = lambda a, b: float((a.float() - b).pow(2).mean().sqrt()  # noqa
                             / b.pow(2).mean().sqrt())
    r_fc, r_att = rel(f16, fp), rel(a16, ap)
    m_fc = float((f16.float() - fp).abs().max()) / float(fp.abs().max())
    t16 = cpt.sample(cpt32, f16.float(), K_CONCEPTS)[1]
    shared = float(np.mean([len(set(a) & set(b)) / K_CONCEPTS for a, b in
                            zip(t16.tolist(), tp_.tolist())]))
    sat = float((cpt.forward(cpt32, fp) == 1.0).float().mean())
    print(f"encoder f32 bs=16 448x448, kernel vs plain pool: max err of "
          f"scale fc {e_fc:.3g} att {e_att:.3g} (<= 1e-5), concept ids "
          f"equal {bool(torch.equal(tk, tp_))}; bf16 vs f32: rms err fc "
          f"{r_fc:.4g} att {r_att:.4g} (<= 0.1), max err of scale fc "
          f"{m_fc:.4g}, top-{K_CONCEPTS} concepts shared {shared:.2%}; "
          f"features scale fc {float(fp.abs().max()):.4g}, concept scores "
          f"at exactly 1.0: {sat:.2%}")
    _check(e_fc <= 1e-5 and e_att <= 1e-5, "encoder kernel path differs from "
           "the plain path")
    _check(torch.equal(tk, tp_), "concept ids differ between the kernel "
           "and plain encoder paths")
    _check(sat == 0.0, f"{sat:.2%} of the concept scores saturate at 1.0: "
           "the top-5 ranking is not exercised")
    report["encoder_concept_sets"] = len({tuple(r) for r in tk.tolist()})
    _check(r_fc <= 0.1 and r_att <= 0.1, "bf16 encoder too far from f32")
    report["encoder_f32_kernel_vs_plain"] = {"fc": e_fc, "att": e_att}
    report["encoder_bf16_vs_f32"] = {
        "rms_fc": r_fc, "rms_att": r_att, "max_fc_of_scale": m_fc,
        "concepts_shared": shared, "saturated_scores_f32": sat}
    del fk, ak, fp, ap, f16, a16
    torch.cuda.empty_cache()

    # -- 5. times ------------------------------------------------------------
    kernels = []
    h, p_cont, att16, p_att16 = att_in[torch.bfloat16]
    # v1 is two launches of some 0.1 ms together, near the host's dispatch
    # of a call: the line carries the profiler's device time, split into
    # the query product and the attention, with CUDA events beside it
    # Each session's instances of every part are held to the launches one
    # call adds to its op's counter, times the calls (a short session is
    # taken again, then refused: utils/timing.device_ms_by_name)
    def split(fn, parts, op, attr="launches"):
        return device_ms_by_name(fn, parts, per_call=launches_per_call(
            fn, {p_: (op, attr) for p_ in parts}))
    v1_parts = ("query_", "beam_att_kernel")
    a_dev = split(lambda: fa.beam_content_attention(
        h, p_cont, att16, p_att16, B=BEAM), v1_parts,
        fa.beam_content_attention)
    a_ms = cuda_ms(lambda: fa.beam_content_attention(
        h, p_cont, att16, p_att16, B=BEAM))
    a_tanhf = split(lambda: fa.beam_content_attention(
        h, p_cont, att16, p_att16, B=BEAM, exact_tanh=True), v1_parts,
        fa.beam_content_attention)
    a_plain = cuda_ms(lambda: fa.beam_content_attention_plain(
        h, p_cont, att16, p_att16, B=BEAM), iters=5)
    rows = BS * BEAM
    a_bytes = 2 * (rows * H + Ah * H + Ah + Ah + BS * N * (Ah + Fe)
                   + rows * Fe)
    a_flops = 2 * rows * H * Ah + 3 * rows * N * Ah + 5 * rows * N \
        + 2 * rows * N * Fe
    a_tanh = rows * N * Ah           # one tanh a (beam, position, channel)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    a_bound, a_by = _bound(a_bytes, a_flops, F32_FLOP_S, a_tanh, sms)
    h32, p32, att32, patt32 = att_in[torch.float32]
    a32_dev = split(lambda: fa.beam_content_attention(
        h32, p32, att32, patt32, B=BEAM), v1_parts,
        fa.beam_content_attention)
    a32_ms = cuda_ms(lambda: fa.beam_content_attention(
        h32, p32, att32, patt32, B=BEAM))
    a32_bound, _ = _bound(2 * a_bytes, a_flops, F32_FLOP_S, a_tanh, sms)
    report["attention_f32"] = {"device_ms": a32_dev, "ms_events": a32_ms,
                               "bound_ms": a32_bound}
    # the narrowest and the widest beam on the same att/p_att
    a_by_beam = {BEAM: a_dev}
    for b_ in ATT_BEAMS:
        if b_ != BEAM:
            hb = (torch.rand(BS * b_, H, generator=g, device=dev) * 2
                  - 1).bfloat16()
            a_by_beam[b_] = split(
                lambda: fa.beam_content_attention(hb, p_cont, att16, p_att16,
                                                  B=b_), v1_parts,
                fa.beam_content_attention)
    del hb
    report["attention_bf16"] = {"device_ms": a_dev, "ms_events": a_ms,
                                "device_ms_tanhf": a_tanhf,
                                "device_ms_by_beam": a_by_beam}
    per_batch = launches["beam_content_attention"] / stats["batches"]
    kernels.append({
        "name": "beam_content_attention",
        "route": "cuda",
        "source": "insenticap_model_tpu_torch/csrc/fused_attention.cu",
        "replaces": "insenticap_model_tpu/ops/fused_attention.py:27",
        "launches": launches["beam_content_attention"],
        "launches_train_xe": report["train_xe"]["launches"][
            "beam_content_attention"],
        "launches_data_parallel": report["data_parallel"]["one_rank_nccl"][
            "v1_launches"] + report["rl_data_parallel"]["one_rank_nccl"][
            "v1_launches"],
        "launches_model_parallel": report["model_parallel"]["cli"]["ranks"][
            0]["v1_launches"],
        "launches_train_rl": sum(
            r["launches"]["beam_content_attention"]
            for r in report["train_rl"]["epochs"].values()),
        "launches_reproduce": sum(
            r["launches"]["beam_content_attention"]
            for r in report["offline_clis"]["reproduce"].values()),
        "max_abs_err": checks["attention_bf16"],
        "ms": a_dev["total"], "ms_events": a_ms,
        "query_ms": a_dev["query_"], "attention_ms": a_dev["beam_att_kernel"],
        "plain_ms": a_plain, "bound_ms": a_bound,
        "bound_by": _bound_by(a_by), "bound_term": a_by, "library_ms": None,
        "passed": True})
    # v2: the same function up to the weights' rounding, on v1's kernels
    # (kRoundW), the same bound
    v2_ms = cuda_ms(lambda: fa.beam_content_attention(
        h, p_cont, att16, p_att16, B=BEAM, variant="v2"))
    v2_dev = split(lambda: fa.beam_content_attention(
        h, p_cont, att16, p_att16, B=BEAM, variant="v2"), v1_parts,
        fa.beam_content_attention, "launches_v2")
    v2_plain = cuda_ms(lambda: fa.beam_content_attention_plain(
        h, p_cont, att16, p_att16, B=BEAM, variant="v2"), iters=5)
    v2_32 = cuda_ms(lambda: fa.beam_content_attention(
        h32, p32, att32, patt32, B=BEAM, variant="v2"))
    report["attention_v2_f32"] = {"ms": v2_32, "bound_ms": a32_bound}
    report["attention_v2_bf16"] = {"ms_events": v2_ms, "device_ms": v2_dev}
    kernels.append({
        "name": "beam_content_attention_v2",
        "route": "cuda",
        "source": "insenticap_model_tpu_torch/csrc/fused_attention.cu",
        "replaces": "insenticap_model_tpu/ops/fused_attention.py:51",
        "launches": launches_t["beam_content_attention_v2"],
        "max_abs_err": checks["attention_v2_bf16"],
        "ms": v2_dev["total"], "ms_events": v2_ms,
        "query_ms": v2_dev["query_"],
        "attention_ms": v2_dev["beam_att_kernel"],
        "plain_ms": v2_plain, "bound_ms": a_bound,
        "bound_by": _bound_by(a_by), "bound_term": a_by, "library_ms": None,
        "passed": True})
    # the fused top-k: 2 rows H V flops on the tensor cores (bf16), the
    # operands read once, [rows, k] values and ids written once. Two
    # launches of some 0.03-0.1 ms together: the line carries the
    # profiler's device time, pass 1 and the merge apart, CUDA events
    # beside it; the bf16 torch.matmul of the same product is a yardstick
    # for the product alone (no one call computes the top-k)
    tk16, tk32 = topk_in[torch.bfloat16], topk_in[torch.float32]
    tk_parts = ("topk_wgmma", "topk_merge")
    tk_dev = split(lambda: ft.classifier_topk(
        *tk16, k=BEAM, banned=BANNED), tk_parts, ft.classifier_topk)
    tk_ms = cuda_ms(lambda: ft.classifier_topk(*tk16, k=BEAM,
                                               banned=BANNED))
    tk_plain = cuda_ms(lambda: ft.classifier_topk_plain(
        *tk16, k=BEAM, banned=BANNED), iters=5)
    wt16 = tk16[1].t()
    mm16_dev = device_ms(lambda: torch.matmul(tk16[0], wt16))
    mm16_ms = cuda_ms(lambda: torch.matmul(tk16[0], wt16))
    tk32_dev = split(lambda: ft.classifier_topk(
        *tk32, k=BEAM, banned=BANNED), ("topk_tiles_f32", "topk_merge"),
        ft.classifier_topk)
    tk32_ms = cuda_ms(lambda: ft.classifier_topk(*tk32, k=BEAM,
                                                 banned=BANNED))
    tk32_plain = cuda_ms(lambda: ft.classifier_topk_plain(
        *tk32, k=BEAM, banned=BANNED), iters=5)
    tk_flops = 2 * rows * H * VOCAB
    tk_io = 8 * rows + rows * BEAM * (4 + 8)
    tk_bound, tk_by = _bound(2 * (rows * H + VOCAB * H + VOCAB) + tk_io,
                             tk_flops, BF16_FLOP_S)
    tk32_bound, _ = _bound(4 * (rows * H + VOCAB * H + VOCAB) + tk_io,
                           tk_flops, F32_FLOP_S)
    report["classifier_topk_f32"] = {
        "device_ms": tk32_dev, "ms_events": tk32_ms, "plain_ms": tk32_plain,
        "bound_ms": tk32_bound}
    report["classifier_topk_bf16"] = {
        "device_ms": tk_dev, "ms_events": tk_ms,
        "matmul_bf16_device_ms": mm16_dev, "matmul_bf16_ms_events": mm16_ms}
    kernels.append({
        "name": "classifier_topk",
        "route": "cuda",
        "source": "insenticap_model_tpu_torch/csrc/fused_topk.cu",
        "replaces": "insenticap_model_tpu/ops/fused_topk.py:59",
        "launches": launches_t["classifier_topk"],
        "max_abs_err": checks["classifier_topk_bf16"],
        "ms": tk_dev["total"], "ms_events": tk_ms,
        "pass1_ms": tk_dev["topk_wgmma"], "pass2_ms": tk_dev["topk_merge"],
        "matmul_yardstick_ms": mm16_dev, "plain_ms": tk_plain,
        "bound_ms": tk_bound, "bound_by": tk_by, "library_ms": None,
        "passed": True})

    # the detector's input as it serves it: NHWC features, permuted
    feats16 = torch.rand(BS, 14, 14, C0, generator=g, device=dev).to(
        torch.bfloat16)
    x16 = feats16.permute(1, 2, 0, 3)
    x16c = x16.contiguous()
    v = wk.wino_input(x16)
    m1 = gemm(v, convs[0]["weight"])
    v2 = wk.wino_middle(m1, b1, 14, 14)
    m2 = gemm(v2, convs[1]["weight"])
    c1, c2 = convs[0]["weight"].shape[3], convs[1]["weight"].shape[3]
    tr = 2 * 7 * 7 * 7 * 2        # dense 7x7 transform: two 7x7x7 products
    inv = 2 * (5 * 7 * 7 + 5 * 5 * 7)
    specs = [
        ("wino_input", "insenticap_model_tpu/ops/winograd_pallas.py:67",
         lambda: wk.wino_input(x16), lambda: wk.wino_input_plain(x16),
         2 * (14 * 14 * BS * C0 + 49 * 9 * BS * C0), 9 * BS * C0 * tr),
        ("wino_middle", "insenticap_model_tpu/ops/winograd_pallas.py:99",
         lambda: wk.wino_middle(m1, b1, 14, 14),
         lambda: wk.wino_middle_plain(m1, b1, 14, 14),
         2 * 2 * 49 * 9 * BS * c1 + 4 * c1, 9 * BS * c1 * (tr + inv)),
        ("wino_output", "insenticap_model_tpu/ops/winograd_pallas.py:83",
         lambda: wk.wino_output(m2, b2, 14, 14),
         lambda: wk.wino_output_plain(m2, b2, 14, 14),
         2 * (49 * 9 * BS * c2 + 14 * 14 * BS * c2) + 4 * c2,
         9 * BS * c2 * inv),
    ]
    # each transform by the profiler's device time (the kernel alone;
    # "total" also holds any copy the wrapper makes) beside CUDA events;
    # wino_input on the permuted view, as the detector calls it
    wino_names = ("wino_input_kernel", "wino_middle_kernel",
                  "wino_output_kernel")
    wino_times = {}
    # one call of a transform: one activity of its kernel, none of the
    # other two
    wino_counters = {n_: (getattr(wk, n_.replace("_kernel", "")), "launches")
                     for n_ in wino_names}
    for name, replaces, kfn, pfn, nbytes, flops in specs:
        k_dev = device_ms_by_name(kfn, wino_names, per_call=launches_per_call(
            kfn, wino_counters))
        k_ms = cuda_ms(kfn)
        p_ms = cuda_ms(pfn, iters=3)
        bnd, by_ = _bound(nbytes, flops, F32_FLOP_S)
        wino_times[name] = {"device_ms": k_dev[name + "_kernel"],
                            "device_total_ms": k_dev["total"],
                            "ms_events": k_ms, "plain_ms": p_ms,
                            "bound_ms": bnd, "bound_by": by_}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "insenticap_model_tpu_torch/csrc/winograd.cu",
            "replaces": replaces, "launches": launches[name],
            "launches_train_senti": report["head_stages"]["senti"]["bf16"][
                "launches"][name],
            "launches_train_rl": report["train_rl"]["epochs"]["bf16"][
                "launches"][name],
            "launches_reproduce": sum(
                r["launches"][name]
                for r in report["offline_clis"]["reproduce"].values()),
            "launches_data_parallel": sum(
                r["wino_launches"][WINO_NAMES.index(name)]
                for r in report["data_parallel"]["ranks"]
                + report["rl_data_parallel"]["ranks"]),
            "launches_model_parallel": sum(
                r["wino_launches"][WINO_NAMES.index(name)]
                for r in report["model_parallel"]["ranks"]),
            "max_abs_err": checks[name], "ms": k_dev[name + "_kernel"],
            "ms_events": k_ms, "plain_ms": p_ms,
            "bound_ms": bnd, "bound_by": by_, "library_ms": None,
            "passed": True})
    wino_times["wino_input_contiguous"] = {
        "device_ms": device_ms_by_name(
            lambda: wk.wino_input(x16c), wino_names,
            per_call=launches_per_call(lambda: wk.wino_input(x16c),
                                       wino_counters))["wino_input_kernel"],
        "ms_events": cuda_ms(lambda: wk.wino_input(x16c))}
    report["winograd_transforms"] = wino_times

    # the whole stack (kernels + the two products) on the permuted view,
    # beside the library's two bf16 convolutions on the same input, NCHW
    # as cuDNN prefers; then its device time split by activity, by the
    # names of the device activities: the three transforms, the two
    # products (the names the two torch.bmm show alone), the per-call
    # filter transform (the other names its f32 einsums and casts show
    # alone) and the rest; the copy kernels among them apart
    def stack_fn():
        return wk.conv3x3_stack_sm(x16, layers16)
    stack_ms = cuda_ms(stack_fn, iters=5)
    stack_by = device_ms_by_kernel(stack_fn, iters=5)

    def filters():
        with nn.exact_numerics():
            return [transform_filter(c["weight"]).to(torch.bfloat16)
                    .reshape(49, *c["weight"].shape[2:]) for c in convs]
    us = filters()
    vs = [v.reshape(49, -1, C0), v2.reshape(49, -1, c1)]
    bmm_by = device_ms_by_kernel(
        lambda: [torch.bmm(vs[i], us[i]) for i in range(2)], iters=5)
    filt_by = device_ms_by_kernel(filters, iters=5)
    del us, vs

    def part(names):
        return sum(ms for n_, ms in stack_by.items() if n_ in names)
    wino_in_stack = {n_: sum(ms for k_, ms in stack_by.items() if n_ in k_)
                     for n_ in wino_names}
    trans_names = {n_ for n_ in stack_by if "wino_" in n_}
    prod_names = set(bmm_by) - trans_names
    filt_names = set(filt_by) - prod_names - trans_names
    stack_split = {
        "total": sum(stack_by.values()), **wino_in_stack,
        "transforms": part(trans_names), "products": part(prod_names),
        "filter_transform": part(filt_names),
        "rest": part(set(stack_by) - trans_names - prod_names - filt_names),
        "copy_kernels": sum(ms for n_, ms in stack_by.items()
                            if "copy" in n_.lower()),
        "products_alone": sum(bmm_by.values()),
        "filter_transform_alone": sum(filt_by.values()),
        "by_kernel": dict(sorted(stack_by.items(), key=lambda kv: -kv[1]))}
    xn = x16.permute(2, 3, 0, 1).contiguous()
    wn = [c["weight"].permute(3, 2, 0, 1).contiguous() for c in convs]

    def lib():
        with nn.exact_numerics():
            y = torch.nn.functional.conv2d(xn, wn[0], b1, padding=1)
            return torch.nn.functional.conv2d(y, wn[1], b2, padding=1)
    lib_ms = cuda_ms(lib, iters=5)
    gemm_flops = 2 * 49 * 9 * BS * (C0 * c1 + c1 * c2)
    stack_bytes = 2 * (14 * 14 * BS * C0 + 14 * 14 * BS * c2
                       + 9 * (C0 * c1 + c1 * c2))
    stack_bound = max(stack_bytes / HBM_BYTES_S, gemm_flops / BF16_FLOP_S) \
        * 1e3
    report["winograd_stack"] = {"ms": stack_ms, "library_ms": lib_ms,
                                "bound_ms": stack_bound,
                                "device_ms": stack_split}
    del v, v2, m1, m2, xn, x16c, feats16

    # the stem's max pool at both buckets' shapes, bf16 and f32: each
    # input read once and each output written once; the library's
    # F.max_pool2d on the channels-last view as the yardstick
    pool_times = {}
    for (name, dt), xp in pool_in.items():
        B_, H_, W_, C_ = xp.shape
        oh_, ow_ = pool.out_extent(H_), pool.out_extent(W_)
        x_cl = xp.permute(0, 3, 1, 2)
        nbytes = xp.element_size() * (B_ * H_ * W_ + B_ * oh_ * ow_) * C_
        bnd, by_ = _bound(nbytes, 8 * B_ * oh_ * ow_ * C_, F32_FLOP_S)
        pool_times[f"{name}_{'bf16' if dt == torch.bfloat16 else 'f32'}"] = {
            "ms": cuda_ms(lambda: pool.ceil_maxpool_3x3s2_nhwc(xp)),
            "plain_ms": cuda_ms(lambda: pool.ceil_maxpool_3x3s2_plain(xp),
                                iters=5),
            "library_ms": cuda_ms(lambda: torch.nn.functional.max_pool2d(
                x_cl, 3, 2, 0, ceil_mode=True)),
            "bound_ms": bnd, "bound_by": by_}
    report["ceil_maxpool_3x3s2"] = pool_times
    p16 = pool_times["448x448_bf16"]
    kernels.append({
        "name": "ceil_maxpool_3x3s2", "route": "cuda",
        "source": "insenticap_model_tpu_torch/csrc/maxpool.cu",
        "replaces": "insenticap_model_tpu/ops/pool_pallas.py:38",
        "launches": launches_c["ceil_maxpool_3x3s2"],
        "launches_preprocess": report["offline_clis"]["features"][
            "launches"]["ceil_maxpool_3x3s2"],
        "max_abs_err": checks["ceil_maxpool_3x3s2"], "ms": p16["ms"],
        "plain_ms": p16["plain_ms"], "bound_ms": p16["bound_ms"],
        "bound_by": p16["bound_by"], "library_ms": p16["library_ms"],
        "passed": True})
    del pool_in, x_cl

    # the int8-storage attention: int8 att/p_att and their f32 scales read
    # once, h and W read and the bf16 output written once; v1's operations
    # plus one multiply a dequantised value, and v1's tanh. Two launches of
    # some 0.05 ms together: the line carries the profiler's device time,
    # the query product and the attention apart, CUDA events beside it. No
    # one PyTorch call computes it: the bf16 v1 kernel on the same values,
    # timed the same way, is its reference
    i8_parts = bti.I8_PARTS
    i8_dev = split(lambda: fa8.beam_content_attention_i8(
        *i8_in, B=BEAM), i8_parts, fa8.beam_content_attention_i8)
    i8_ms = cuda_ms(lambda: fa8.beam_content_attention_i8(*i8_in, B=BEAM))
    i8_tanhf = split(lambda: fa8.beam_content_attention_i8(
        *i8_in, B=BEAM, exact_tanh=True), i8_parts,
        fa8.beam_content_attention_i8)
    i8_plain = cuda_ms(lambda: fa8.beam_content_attention_i8_plain(
        *i8_in, B=BEAM), iters=5)
    att16_i8, p_att16_i8 = att_f.bfloat16(), p_att_f.bfloat16()
    i8_ref = split(lambda: fa.beam_content_attention(
        h16, p_cont16, att16_i8, p_att16_i8, B=BEAM), v1_parts,
        fa.beam_content_attention)
    i8_ref_ms = cuda_ms(lambda: fa.beam_content_attention(
        h16, p_cont16, att16_i8, p_att16_i8, B=BEAM))
    i8_bytes = BS * N * (Ah + Fe) + 4 * BS * (Ah + Fe) \
        + 2 * (rows * H + Ah * H + 2 * Ah + rows * Fe)
    i8_bound, i8_by = _bound(i8_bytes, a_flops + BS * N * (Ah + Fe),
                             F32_FLOP_S, a_tanh, sms)
    i8_bytes_ms = i8_bytes / HBM_BYTES_S * 1e3
    report["attention_i8"] = {
        "device_ms": i8_dev, "ms_events": i8_ms, "device_ms_tanhf": i8_tanhf,
        "reference_device_ms": i8_ref, "reference_ms_events": i8_ref_ms,
        "bound_ms": i8_bound, "bound_term": i8_by,
        "bytes_bound_ms": i8_bytes_ms}
    kernels.append({
        "name": "beam_content_attention_i8", "route": "cuda",
        "source": "insenticap_model_tpu_torch/csrc/fused_attention.cu",
        "replaces": "tools/bench_int8.py:283",
        "launches": launches_d["beam_content_attention_i8"],
        "max_abs_err": checks["attention_i8"], "ms": i8_dev["total"],
        "ms_events": i8_ms, "query_ms": i8_dev["query_"],
        "attention_ms": i8_dev["beam_att_i8_kernel"],
        "plain_ms": i8_plain, "bound_ms": i8_bound,
        "bound_by": _bound_by(i8_by), "bound_term": i8_by,
        "library_ms": None, "reference_ms": i8_ref["total"],
        "reference_ms_events": i8_ref_ms, "passed": True})
    del att16_i8, p_att16_i8

    # the row-tiled product at both LSTM shapes and every tile, timed in
    # phase 3d's run of the study: at some 50 us a call, CUDA events around
    # back-to-back launches also read the host's dispatch, so the line
    # carries the profiler's device time (events beside it). att_lstm at
    # tile_rows=24 (tile_b 8); torch.matmul at the full 1152 rows, with f32
    # accumulation as the kernel, is the yardstick
    mm_times = {}
    for name, (x, w) in mm_in.items():
        mm_times[name] = dict(mega[name], plain_ms=cuda_ms(
            lambda: tmm.tiled_mm_plain(x, w), iters=5))
    report["tiled_mm"] = mm_times
    m24 = mm_times["att_lstm"]
    kernels.append({
        "name": "tiled_mm", "route": "cuda",
        "source": "insenticap_model_tpu_torch/csrc/tiled_mm.cu",
        "replaces": "tools/bench_megacell.py:71",
        "launches": launches_d["tiled_mm"],
        "max_abs_err": checks["tiled_mm_att_lstm_24"],
        "ms": m24["tiled_device_ms"][24], "ms_events": m24["tiled_ms"][24],
        "plain_ms": m24["plain_ms"], "bound_ms": m24["bound_ms"],
        "bound_by": m24["bound_by"], "library_ms": m24["matmul_device_ms"],
        "library_ms_events": m24["matmul_ms"],
        "by_shape": {name: {"device_ms": r["tiled_device_ms"],
                            "bound_ms": r["bound_ms"],
                            "library_ms": r["matmul_device_ms"]}
                     for name, r in mm_times.items()},
        "passed": True})
    del mm_in, i8_in

    # the encoder at the top of the encode ladder, 448x448, host clock
    imgs32 = torch.randint(0, 256, (ENC_BS, 448, 448, 3), dtype=torch.uint8,
                           generator=g, device=dev)
    enc_times = {}
    for tag, ep in (("bf16", enc16), ("f32", enc32)):
        walls = []
        for r in range(6):
            t0 = time.perf_counter()
            encoder.forward_raw_batch(ep, imgs32)
            torch.cuda.synchronize()
            if r:                                  # the first is warm-up
                walls.append(time.perf_counter() - t0)
        s_ = statistics.median(walls)
        enc_times[tag] = {"ms": s_ * 1e3, "images_per_s": ENC_BS / s_}
    report["encoder_bs32_448"] = enc_times
    del imgs32, enc32, enc16

    # the serving step: detect + decode, bf16, bs=384, host clock; its
    # detector alone; and the same step on the plain path
    fc16, att16b = fc.bfloat16(), att.bfloat16()

    def wall_s(fn, runs=5):
        fn()
        torch.cuda.synchronize()
        wall = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
        return statistics.median(wall)

    def interleaved_s(fn, names, rounds=6):
        """Median host time of fn under each switch set of ``names``, the
        sets taken in turns (a b .. b a) so that drift in the shared
        host's speed falls on all of them alike."""
        for name in names:
            with _switches(name):
                fn()
        torch.cuda.synchronize()
        walls = {name: [] for name in names}
        for r in range(rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                with _switches(name):
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    walls[name].append(time.perf_counter() - t0)
        return {name: statistics.median(w) for name, w in walls.items()}

    def step_fn(params, fc_, att_):
        return lambda: inference.detect_and_decode(params, fc_, att_, sw,
                                                   **kw)
    steps_by_switch = interleaved_s(step_fn(params16, fc16, att16b),
                                    list(SWITCH_SETS))
    step_s = steps_by_switch["default"]
    with _switches("default"):
        detect_s = wall_s(lambda: sd.sample(det16, att16b, 0.7,
                                            ids.neutral))
        plain_step_s = wall_s(lambda: inference.detect_and_decode(
            params16, fc16, att16b, sw, use_kernels=False, **kw), runs=3)
    # the trained weights: standard-normal features, default and both
    trained_walls = interleaved_s(step_fn(params_t16, fc_t16, att_t16),
                                  ["default", "both"])
    trained_step = {}
    for name, wall in trained_walls.items():
        with _switches(name):
            ft.classifier_topk.launches = 0
            seqs_t = inference.detect_and_decode(params_t16, fc_t16, att_t16,
                                                 sw, **kw)[0]
            n_steps = ft.classifier_topk.launches
        lens_t = _first_eos(seqs_t.cpu().numpy(), ids.eos)
        trained_step[name] = {"step_s": wall, "captions_per_s": BS / wall,
                              "mean_len": float(lens_t.mean()),
                              "max_len": int(lens_t.max())}
        if name == "both":
            trained_step[name]["decode_steps"] = n_steps
            _check(0 < n_steps < T, f"trained bf16 decode ran {n_steps} "
                   "steps")
    report.update(serve_step_bs384_bf16_s=step_s,
                  captions_per_s=BS / step_s, detect_bs384_bf16_s=detect_s,
                  plain_serve_step_bs384_bf16_s=plain_step_s,
                  plain_captions_per_s=BS / plain_step_s,
                  serve_step_bs384_bf16_s_by_switch=steps_by_switch,
                  trained_step_bs384_bf16=trained_step, device=smi,
                  checks=checks, kernels=kernels,
                  attention_launches_per_batch=per_batch,
                  total_s=time.time() - t_start)
    print(f"winograd stack bf16 bs={BS}: {stack_ms:.3f} ms (bound "
          f"{stack_bound:.3f} ms), F.conv2d two convs {lib_ms:.3f} ms")
    sp = stack_split
    print(f"winograd stack bf16 bs={BS}, device ms: total {sp['total']:.4f}"
          f" = transforms {sp['transforms']:.4f} (input "
          f"{sp['wino_input_kernel']:.4f}, middle "
          f"{sp['wino_middle_kernel']:.4f}, output "
          f"{sp['wino_output_kernel']:.4f}) + products {sp['products']:.4f}"
          f" + filter transform {sp['filter_transform']:.4f} + rest "
          f"{sp['rest']:.4f}; copy kernels among them "
          f"{sp['copy_kernels']:.4f}; alone: products "
          f"{sp['products_alone']:.4f}, filter transform "
          f"{sp['filter_transform_alone']:.4f}")
    for name, r in wino_times.items():
        print(f"{name} bf16 bs={BS}: device {r['device_ms']:.4f} ms "
              + (f"(with the wrapper's work {r['device_total_ms']:.4f}) "
                 if "device_total_ms" in r else "")
              + f"events {r['ms_events']:.4f} ms"
              + (f", plain {r['plain_ms']:.4f} ms, bound "
                 f"{r['bound_ms']:.4f} ms ({r['bound_by']})"
                 if "bound_ms" in r else ""))
    for name, r in pool_times.items():
        print(f"ceil_maxpool_3x3s2 {name} bs={ENC_BS}: {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, F.max_pool2d "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms")
    for name, r in mm_times.items():
        print(f"tiled_mm {name} bf16, device ms (events): " + ", ".join(
            f"tile_rows={tr} {t:.4f} ({r['tiled_ms'][tr]:.4f})"
            for tr, t in r["tiled_device_ms"].items())
            + f"; torch.matmul {r['matmul_device_ms']:.4f} "
            f"({r['matmul_ms']:.4f}); plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    print(f"attention_i8 bf16 bs={BS} B={BEAM}, device ms: query "
          f"{i8_dev['query_']:.4f} + attention "
          f"{i8_dev['beam_att_i8_kernel']:.4f} = {i8_dev['total']:.4f} "
          f"(events {i8_ms:.4f}; with tanhf "
          f"{i8_tanhf['beam_att_i8_kernel']:.4f}, total "
          f"{i8_tanhf['total']:.4f}); v1 bf16 kernel on the same values "
          f"{i8_ref['query_']:.4f} + {i8_ref['beam_att_kernel']:.4f} = "
          f"{i8_ref['total']:.4f} (events {i8_ref_ms:.4f}); plain "
          f"{i8_plain:.4f} ms; bound {i8_bound:.4f} ms ({i8_by}; bytes "
          f"{i8_bytes_ms:.4f}, tanh at {SFU_OPS_CLK} a clock on {sms} SMs "
          f"at {SM_CLOCK_HZ / 1e6:.0f} MHz)")
    for tag, r in enc_times.items():
        print(f"encoder forward_raw_batch {tag} bs={ENC_BS} 448x448: "
              f"{r['ms']:.2f} ms median of 5 -> {r['images_per_s']:.1f} "
              "images/s")
    print(f"attention v1 bf16 bs={BS} B={BEAM}, device ms: query "
          f"{a_dev['query_']:.4f} + attention {a_dev['beam_att_kernel']:.4f}"
          f" = {a_dev['total']:.4f} (events {a_ms:.4f}; with tanhf "
          f"{a_tanhf['beam_att_kernel']:.4f}, total {a_tanhf['total']:.4f});"
          f" v2 {v2_dev['query_']:.4f} + {v2_dev['beam_att_kernel']:.4f} = "
          f"{v2_dev['total']:.4f} (events {v2_ms:.4f}); bound "
          f"{a_bound:.4f} ms")
    print(f"attention v1 bf16 bs={BS} by beam, device ms (query + "
          "attention): " + ", ".join(
              f"B={b_} {d['query_']:.4f} + {d['beam_att_kernel']:.4f}"
              for b_, d in sorted(a_by_beam.items())))
    print(f"attention v1 f32 bs={BS}, device ms: query "
          f"{a32_dev['query_']:.4f} + attention "
          f"{a32_dev['beam_att_kernel']:.4f} = {a32_dev['total']:.4f} "
          f"(events {a32_ms:.4f}; bound {a32_bound:.4f} ms)")
    print(f"classifier_topk bf16 rows={rows} H={H} V={VOCAB} k={BEAM}, "
          f"device ms: pass 1 {tk_dev['topk_wgmma']:.4f} + merge "
          f"{tk_dev['topk_merge']:.4f} = {tk_dev['total']:.4f} (events "
          f"{tk_ms:.4f}); bound {tk_bound:.4f} ms ({tk_by}); bf16 "
          f"torch.matmul of the product alone {mm16_dev:.4f} (events "
          f"{mm16_ms:.4f})")
    print(f"attention v2 f32 bs={BS}: {v2_32:.4f} ms; classifier_topk "
          f"f32, device ms: tiles {tk32_dev['topk_tiles_f32']:.4f} + merge "
          f"{tk32_dev['topk_merge']:.4f} = {tk32_dev['total']:.4f} (events "
          f"{tk32_ms:.4f}; plain {tk32_plain:.4f} ms, bound "
          f"{tk32_bound:.4f} ms)")
    print(f"serving step bf16 bs={BS}: {step_s * 1e3:.2f} ms median of 5 "
          f"-> {BS / step_s:.1f} captions/s (detector alone "
          f"{detect_s * 1e3:.2f} ms); plain path {plain_step_s * 1e3:.2f} ms "
          f"-> {BS / plain_step_s:.1f} captions/s")
    print("serving step bf16 by switch (random weights, median of 6 taken "
          "in turns): " + ", ".join(
        f"{k} {v * 1e3:.2f} ms" for k, v in steps_by_switch.items()))
    for name, r in trained_step.items():
        print(f"trained weights, {name}: {r['step_s'] * 1e3:.2f} ms -> "
              f"{r['captions_per_s']:.1f} captions/s, caption length mean "
              f"{r['mean_len']:.2f} max {r['max_len']}"
              + (f", {r['decode_steps']} decode steps"
                 if "decode_steps" in r else ""))
    report["profiler_sessions"] = dict(SESSIONS)
    print(f"profiler sessions: {SESSIONS['taken']} taken, "
          f"{SESSIONS['short']} of them taken again for a part's instance "
          "count (utils/timing.device_ms_by_name)")
    for k in kernels:
        k["design"] = DESIGNS[k["name"]]
        print(f"  {k['name']} ({k['design']}): {k['ms']:.4f} ms, plain "
              f"{k['plain_ms']:.4f} "
              f"ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']}), "
              f"{k['launches']} launches on the main path")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=2)

    # -- 6. result lines ------------------------------------------------------
    print(json.dumps({"kernels": kernels}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
