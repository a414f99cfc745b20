#!/usr/bin/env python3
"""Drive the PyTorch port (clip_lite_torch) on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

(``--crop-kernel`` runs phases 1, 2 and 10d's crop kernel alone, and
prints its row; ``--native`` runs phases 1, 2 and 10d alone;
``--quality`` phases 1, 2 and 11; ``--ranks`` phases 1, 2 and 12;
``--matrix`` phases 1, 2 and 13; ``--clip`` phases 1, 2 and 14;
``--long`` phases 1, 2 and 15.)  The
whole run logs each phase's seconds as it ends, and all of them before
the kernels line.

Phases; any failure raises and exits non-zero, and no phase's error is
caught:

1. Environment: the card's name and power limit, torch and CUDA versions;
   TF32 and reduced-precision bf16 reductions off, so fp32 references are
   fp32.
2. Build: every kernel of the port from clip_lite_torch/ops/csrc, one
   nvcc per source, all started together (decode_crop.cu links nvJPEG);
   each kernel's registers from ptxas, and no variant may spill.
3. K1 (attention forward) against its plain PyTorch version at the
   flagship text batch, in fp32 (the launch counted on the 3xTF32 route)
   and bf16; the kernel's, the plain version's and the library call's
   times, in fp32 beside the CUDA-core kernel's (fp32 training's route)
   on the same inputs in turns; the least time the card could take (bytes
   over 3.35 TB/s or operations over the peak rate).
4. Inference main path: the flagship model (configs/fs_bs1024_ni250k.yaml:
   ResNet-50 at 224 px, BERT-12/768 over 30 tokens, 2048-d projection
   heads, AMP bf16) with seeded random weights, as an EncoderBundle on the
   card, scores retrieval on 256 seeded images and captions at batch 128.
   Launch counts are set to 0 just before and read just after.  Checks:
   finite unit-norm (256, 2048) embeddings, K1 launched 12 layers x 2
   text batches, every launch on the tensor-core route (bf16 at S = 30;
   the same holds for every bf16 main path below), and the text embeddings against the same model with
   FUSED_ATTENTION false (the plain attention) in bf16 and in fp32.
   Then images/s and captions/s through the bundle.
5. K1 with dropout and K2 (attention backward) at the same shape, fp32
   and bf16, dropout rate 0 and 0.1, each against its plain version given
   the Philox keep mask that the kernels' own entry point writes; in bf16
   also against the float64 evaluation of the same function, where each
   kernel's max error may be at most twice its plain version's (a bar
   that does not depend on the order of sums); the mask's keep fraction
   and its dependence on the seed; times and bounds, and where a kernel's
   route is not the CUDA cores' (bf16; fp32 K1, the 3xTF32 route) that
   route timed in turns with the CUDA-core route on the same inputs, each
   as a caller pays it and on the device alone (the card held busy while
   the host enqueues).
6. Training main path: the flagship at full width (dropout 0.1, SGD +
   Lookahead, warmup-cosine) with seeded weights, 10 steps of 128 seeded
   pairs through the engine and the train loop, then one eval sweep.
   Counts set to 0 just before and read just after.  Checks: finite loss
   and grad norm at every step, K1 and K2 launched 12 x 10 times (K1 12
   more in the eval sweep), parameters unchanged by step 1 (LR multiplier
   0) and changed by step 2, parameters equal to the Lookahead slow
   weights after step 5, BatchNorm running statistics moved.  Then the
   median step time over steps 3-10 (a sync per step), pairs/s and peak
   memory; each step's line also holds the host time until the step was
   enqueued (``enqueue_seconds``), near the whole step when the host, not
   the card, sets the pace.
6a. The step trace: phase 6's flagship step (AMP bf16, batch 128, S 30)
   under torch.profiler (utils/trace.py), five steps after three, the
   counts set to 0 just before and read just after.  Prints per step the
   host's enqueue (the train_step range), the device's busy time (the
   union of its kernels), the window (start to start) and the idle share,
   and the idle share of phase 6's untraced step at the traced busy time;
   ms a step by component and by category; the ten longest kernels with
   their counts; the longest idle gaps with what the host was doing.
   The last warm step runs in the profiler's warm-up.  Fails unless each
   hand-written kernel's events in the trace equal its wrapper's launches
   over the same steps, each inside its wrapper's range (the backward's
   through the trace's forward-backward links), and unless every kernel
   launch the trace records has its kernel event.
6b. Checkpoints (the JAX package's msgpack format), the flagship as in
   phase 6 with dropout 0.1, cuDNN's deterministic algorithms on:
   (a) 10 steps through train_loop with a CheckpointManager
   (checkpoint_every 5: a val sweep of one batch, then an asynchronous
   checkpoint; climax_freq 1; keep_recent 1); every save logged with its
   bytes, the seconds it held the loop and until it was written, each
   step with whether a write was in flight; a save with none in flight
   must return within a tenth of its write; a sync save of the final
   state equals the async checkpoint_10 bit for bit.  (b) A fresh state
   resumes from checkpoint_5 and runs steps 6-10; (c) the same 10 steps
   with no checkpoints: after step 10 the resumed run's parameters,
   BatchNorm statistics, trace and slow weights lie no further from (a)'s
   than (c)'s do, and the counters agree.  (d) EncoderBundle from the
   final checkpoint encodes one batch of images and captions exactly as
   one built from (a)'s live state_dict, K1 launched 12 times each.  (e)
   The uint8 path (fs_tpu_tuned + DATA.DEVICE_CACHE, 512 tiles): 3 steps
   with a checkpoint after step 2, then a fresh state resumed there: its
   step 3 sees the same cache batch and the same augmented images (K3's
   fused pass) bit for bit.  (f) PARALLEL.STEPS_PER_CALL 2: (c)'s 10 steps
   through train_loop as 5 calls of two eager steps, (c)'s state bit for
   bit; the seconds a call beside (c)'s a step.  (g) OPTIM.FUSED false:
   checkpoint_5 written again in the optax chain's layout (``{inner_state,
   slow_params, step_count}``), a fresh state resumed from it to step 10,
   (b)'s state bit for bit.  Launch counts set to 0 just before each run
   and read just after.
7. Training parity on the card: from one state, one step with
   FUSED_ATTENTION true (K1/K2) and one with false (plain attention),
   dropout 0, at batch 32 (to keep the phase short): loss, grad norm and
   every layer's QKV weight gradient agree, in fp32 (AMP off) and in
   bf16; and with the image tower kept in fp32, the bf16 step through
   K1/K2 lies no further from the fp32 step than the plain bf16 step
   does, within a factor.  Every K1/K2 launch of a step on its route (fp32:
   K1 and K2 on the CUDA cores).
8. MPNet's text tower (the flagship with MODEL.TEXTUAL.NETWORK_NAME
   microsoft/mpnet-base), which runs K1 and K2 under a full
   (B, NH, S, S) bias: first K1 and K2 with that bias (a relative bias
   table plus padding, as MPNet builds it) against their plain versions
   at (128, 30, 2304), fp32 and bf16, dropout 0 and 0.1, K2's dbias in
   fp32 included, with times, bounds and the library call's
   (``scaled_dot_product_attention`` with a float mask); then phase 4's
   inference (K1 launched 12 x 2 times), phase 6's training (K1 12 x 11,
   K2 12 x 10; the relative bias table unchanged by step 1, its gradient
   finite and non-zero at every step, the table moved by step 10) and
   phase 7's parity (fp32, bf16, and bf16 with the image tower in fp32),
   the relative bias table's gradient held with the QKV gradients.
   Counts set to 0 just before each path and read just after.
9. K3 (the ImageNet normalize) against its plain PyTorch version at the
   flagship image batch (128, 224, 224, 3), uint8 and float32 in, fp32
   and bf16 out, bit for bit; its output's NCHW view is channels_last;
   the kernel's (as a caller pays it and on the device alone), the plain
   version's and the library call's (``torch.addcmul``, uint8 or float32
   in) times and the bound.  Then K3's fused pass (flip, colour jitter
   and normalize in one launch) at the same batch with StepRNG draws
   against the plain composition: within FUSED_ATOL with its own contrast
   means and given the twin's (the count of elements that differ at all
   logged), bit for bit with the flip alone; its times beside the eager
   composition's, and its bound (bytes, and fp32 instructions a jittered
   pixel counted in the SASS of ``augment_pixel_probe`` by cuobjdump, at
   132 SMs x 128 lanes x the maximum SM clock), and the route it replaced
   (eager flip and jitter, then the standalone K3); then
   ``device_preprocess`` whole (flip + normalize, and with colour jitter)
   in ms per batch.
10. The uint8 training path: configs/fs_tpu_tuned.yaml with DATA.DEVICE_CACHE
   (PARALLEL.ZERO1 falls back to the replicated update on one card), a
   DeviceDataCache over a synthetic decoded corpus the size of COCO
   train2017 (118,287 tiles of 256 px, 23.26 GB of uint8 filled on the
   card from a seeded generator; 5 captions an item of 8-20 tokens, so
   the static bucket is 20), 10 steps of 128 through the train loop with
   the cache as its batch iterator, then one eval sweep over one uint8
   cache batch.  Counts set to 0 just before and read just after.  Checks:
   finite loss and grad norm at every step; uint8 (128, 224, 224, 3)
   batches with S = 20; the images the model received in step 1 differ
   from a normalize-only pass exactly where that step's draws flipped or
   jittered; K3's fused pass launched 10 times (one a step) and the
   standalone K3 once (the eval sweep), K1 12 x 11, K2 12 x 10; BatchNorm
   statistics moved.  Then the median step over steps 3-10, pairs/s, the
   host's enqueue time, each beside phase 6's float32 step, peak memory,
   the cache's bytes, and K1/K2 times at qkv (128, 20, 2304), key and
   full bias, both routes and the library call.
10a. The self-supervised terms: configs/fs_tpu_tuned.yaml +
   DATA.DEVICE_CACHE + MODEL.VISUAL.SELF_SUPERVISED at full width and
   depth, a synthetic corpus of SSL_CORPUS tiles with the cache's ssl_aug
   view, 10 steps of 128 through the loop (step s, pairs/s, peak memory;
   K3's fused pass twice a step, K1/K2 12 a step, the visual loss
   positive), then five more steps traced (as 6a) and set beside phase
   6's trace; then one step with visual and textual SSL through the
   kernels (K1/K2 24 launches, K3's fused pass 2), same state and cache
   batch, dropout 0, at batch 32, fp32 and bf16: K3's fused pass held
   against its composition on that step's images and draws within
   FUSED_ATOL, and the step against one through the plain attention
   given the same images at phase 7's bars (given the composition's
   images instead, ResNet-50's gradients move past those bars).
10b. Data and the training CLI: CLRec files of ndarray records at COCO's
   shapes (512 train and 256 val images of 480 x 640 and 640 x 480, five
   captions each) written with the port's ClRecWriter; the host loader
   alone (batches/s of 128 with a worker a core, pinned), and its item
   stage by stage (the record read, each image transform, the caption
   transform and tokenizer, the float32 copy) on LOADER_SPLIT_ITEMS of its
   items on one thread; then
   clip_lite_torch.train.main as ``python -m clip_lite_torch.train`` runs
   it, each run with the counts set to 0 just before and read just after:
   (A) the flagship through the host loader, DATA_STEPS (12) steps of
   128, --checkpoint-every DATA_SAVE (6: a val sweep of
   two batches, then a checkpoint), K1 12 a step and 24 a sweep, K2 12 a
   step, checkpoint_6 and _12 written, finite losses; the CLI's median
   step over steps 3-5 (start to start) beside the loader's batches/s
   and phase 6's step; (C) A resumed from its checkpoint_6 to 12 at
   PARALLEL.STEPS_PER_CALL 2 (three calls of two steps): the batches of
   steps 7-12 equal A's (image_id, input_ids, attention_mask, and images
   to the byte), and the final state equals A's bit for bit (A and C run
   under deterministic algorithms); an EncoderBundle from
   A's checkpoint_12 encodes as A's live weights do; (B) fs_tpu_tuned with DATA.DEVICE_CACHE: the cache
   built through load_host from the train dataset (512 tiles of 256 px;
   its build seconds and bytes), K3's fused pass once a step, K1/K2 as in
   A; its median step; (D) the flagship with MODEL.TEXTUAL.SELF_SUPERVISED
   through the host loader, SSL_CLI_STEPS steps: K1 and K2 24 a step, the
   textual loss positive, its median step, pairs/s and peak memory.
10c. The downstream eval CLIs on JPEG files: the seeded flagship written
   as the JAX package's model-only checkpoint; synthetic trees of 480 x 640
   JPEGs (PIL, seeded) in each dataset's layout: COCO retrieval (256
   images, five captions each), ImageNet (10 classes of 32 train and 16
   val images), VOC07 (20 classes, 256 trainval and 256 test images) and
   the gender-labelled COCO subset (128 images with boxes).  The host
   side first: images/s of the decode alone and of decode + transforms on
   one thread (the decode's share of an item), and of the loader.  Then
   each CLI's main as ``python -m clip_lite_torch.<cli>`` runs it, K1's
   count set to 0 just before and read just after each: retrieval (K1 12
   x 10 caption batches), zero-shot (12), bias_eda --prompt (12 x 2),
   linear_clf --frozen (10 steps of 64) and a fine-tune (5 steps), voc_clf
   (20 classes x 4 costs x 3 folds of the port's SVM, float64 on the
   card) and voc_det (the Detectron2 export).  Checks: every recall and
   top-1 a percentage, K1's launches and the tensor-core route, finite
   unit-norm text embeddings that agree with the plain attention's on the
   card (same checkpoint) within TEXT_TOL bf16, finite losses and the
   probe's checkpoints in the JAX tree, every SVM at its gradient
   tolerance and one against the same solver on the CPU within
   SVM_REL_TOL, the export's 265 tensors with the checkpoint's stem.  Each
   CLI's JSON and seconds are printed.  Then the solver alone at VOC07's
   real fold shape (VOC07_SVM: more samples than features, so the active
   set moves and fits take several Newton steps), on seeded unit-norm
   features, for three positive shares x three costs, each fit on the card
   and on the CPU: every fit converged, some in more than one Newton step,
   decision values within SVM_REL_TOL.
10d. The native JPEG batch path (DATA.NATIVE_PIPELINE): a COCO-layout
   tree of 512 train and 256 val JPEGs (PIL, quality 90, 480 x 640 and
   640 x 480, every 16th 640 x 640, textured to COCO train2017's bytes a
   file) made into CLRec records by
   ``python -m clip_lite_torch.scripts.coco_preprocess``; the mean and
   largest bytes a JPEG of the tree and of the records.  First
   crop_resize_flip_u8 alone, on the twin's own PIL decode of 128 records
   in one arena on the card, against its plain twin bit for bit: train
   boxes, whole images, 1 x 1 and edge-clamped crops, flips on and off, at
   224 and the cache's 256, images cut to odd widths in an arena and
   tiles at odd addresses, and a batch of 1024; its times at (128, 224),
   at the configs' (1024, 224) and at the cache build's (256, 256) beside
   its byte bound (tiles plus crop regions).  Then nvJPEG + the kernel per JPEG kind
   (baseline 4:2:0, 4:2:2, 4:4:4, progressive, greyscale, 640 x 480,
   640 x 640; train and whole boxes): within DECODE_BARS of the twin at
   full resolution per tile, within SCALED_BARS of the JAX core's scaled
   decode where it takes one, and the JAX core's failures (CMYK, bytes
   that are no JPEG, a JPEG cut inside a header; a truncated JPEG decodes
   in both), but for a scan of restart markers only, which nvJPEG refuses
   and libjpeg decodes.  nvJPEG's time a batch of 128 records.  The
   loader alone, native against the Python path on the same records
   (batches/s).  Then the CLI, each run with the counts set to 0 just
   before and read just after: (A) configs/fs_native_input.yaml, 12 steps
   of 128, a val sweep at 10; the same with the decode replaced by
   a fixed tile tensor (A0: what the decode costs the step) and with
   every batch the first one again (A1: what reading the records and
   tokenizing cost it); (B) configs/fs_tpu_tuned.yaml + DATA.DEVICE_CACHE, the
   cache built through the native decode (its build seconds against the
   Python path's); (C) configs/fs_tpu_tuned.yaml as written, 10 steps.
   Checks: finite losses; K1, K2, K3's fused pass (one a step), the
   standalone K3 (one a val batch) exactly, crop_resize_flip_u8 and
   nvJPEG once a decoded batch; each run's median step start to start and
   the host's enqueue beside phase 6's and phase 10b's.  Then (A) and
   (A0) again with --profile-dir, 9 steps (five traced after three, the
   third in the profiler's warm-up, as 6a): K1-K3's events equal their
   launches in the traced steps, and every launch the trace records has
   its kernel event; per
   step the enqueue, busy and idle split, nvJPEG's kernel ms and how much
   of it overlaps the step's kernels, and the host's time blocked in
   synchronisations, (A) beside (A0).
11. The quality path (the JAX package's quality campaign, cut short):
   the port's make_synth_data writes the synthetic learnable corpus
   (512 train and 128 val scenes of 256 px, one zero-shot image a class)
   and coco_preprocess its records; then the CLI, each run with the
   counts set to 0 just before and read just after: (N)
   configs/fs_tpu_tuned.yaml + DATA.DEVICE_CACHE at full width (the cache
   built through the native decode), 4 steps of 128 and a checkpoint at
   4; scripts/cluster.py on that checkpoint for both splits (k 2-10, one
   K1 batch an image); (S) a fresh run of 4 steps that switches to the
   cluster curriculum inside the run at step 3 (the native batch path's
   stream closed, the host clustered loaders built); (C) the run resumed
   at 4 into the cluster curriculum (DATA.NEGATIVE_SAMPLING clusters
   from iteration 4), 4 steps through the host loader of 64 pairs and 64
   hard negatives, a val sweep and a checkpoint at 8.  Checks: finite
   losses and grad norms; (N) K1/K2 12 a step, K3's fused pass one a
   step, the standalone K3 and the crop kernel in the sweep and the
   cache's build; cluster.py's K1 one batch an image; (S) 128 pairs a
   step before the switch and 64 with negatives after, K1/K2 12 then 24
   launches a step, K3's fused pass and the crop kernel before it; (C)
   every batch 64 pairs with negatives, K1
   and K2 24 a step (the pair's and the negatives' BERT passes) and K1
   24 a val batch; one of (C)'s steps again through K1/K2 and through
   the plain attention, same state and batch, dropout 0, at phase 7's
   bars in fp32 and bf16; quality_campaign --families sweep on (C)'s
   checkpoint prints its JSON.  Prints both runs' step times start to
   start and the clustering's seconds.
12. Multi-GPU training (one process a card, ``torch.distributed``):
   CLRec files of RANKS_TRAIN and RANKS_VAL ndarray records of 256 px;
   ``python -m clip_lite_torch.train`` over configs/fs_tpu_tuned.yaml +
   DATA.DEVICE_CACHE at full width (ResNet-50 with sync BatchNorm,
   BERT-12, AMP bf16, global batch 128, global negatives,
   PARALLEL.ZERO1), RANKS_STEPS steps and a checkpoint, deterministic
   algorithms: (world1) under ``torch.distributed.run --standalone
   --nproc-per-node 1`` (torchrun; an NCCL group of one rank) and
   (plain) the same command without it, the two at once.  Checks:
   world1's per-step metrics equal plain's and its checkpoint equals
   plain's byte for byte; each run's K1/K2 12 a step (tensor cores), K3's fused pass one
   a step, as each process logged them; no collective at a world of
   one.  With two cards or more, the run at the card count against
   plain, its per-step losses printed beside plain's and held within
   RANKS_LOSS_REL (the loss's critics normalize over each rank's rows,
   so they are not the one process's).  Then
   ZeRO-1's flat update (which the CLI uses only across ranks) with one
   shard over an NCCL group of one, against the replicated fused
   update on one step's gradients of the same model (batch
   PARITY_BATCH), from one state past warmup on a Lookahead sync step:
   the norm within ZERO1_NORM_REL, parameters and slow weights within
   ZERO1_UPDATE_REL of the largest update (see the constants), one
   reduce-scatter, one all-reduce and one all-gather.
13. The rest of the model matrix, at full width, AMP bf16, batch 128,
   MATRIX_STEPS (4) steps a path on seeded uint8 batches (K3's fused pass
   a step), each with the counts set to 0 just before and read just after:
   (a) vgg16 at 224 px (its classifier kept: 1000 features, dropout 0.5)
   with the flagship BERT-12 at S = 30 (K1/K2 12 a step), then phase
   10a's parity for its step (K3's fused pass against its composition on
   the step's images, FUSED_ATOL; K1/K2 against the plain attention given
   those images at batch 32: fp32 at PARITY_TOL; bf16 at its loss and
   max-rel, and phase 7's floor against the fp32 step in place of its
   cosine, which two correct bf16 steps of VGG16 miss); (b) ``python -m clip_lite_torch.train`` in the
   glove mode over ndarray records (MATRIX_TRAIN and MATRIX_VAL tiles of
   MATRIX_TILE px) with ResNet-50 and GloVe's 400,002 x 300 table, its
   word dictionary written by the port's generate_word_dict from the
   records' COCO annotations, and the final checkpoint (the
   host loader normalizes, so no kernel launches there); (c) the sbert
   mode with ResNet-50 and 768-d caption_encodings; (d) finetune_sbert
   with ResNet-50 and BERT-base loaded by apply_pretrained_weights from
   seeded torchvision- and HF-layout files the phase writes, every loaded
   tensor equal to the file's on the card before the first step (K1/K2 12
   a step); (e) zoo::wrn_40_2 at its CIFAR 32 px with BERT-12.  Each prints
   the median step over steps 2-4 (host clock, each step from a sync to
   the sync that reads its metrics; the first, a warm-up, beside it), the
   peak memory, the losses and grad norms (all
   finite) and the launches, each kernel's count checked exactly and every
   K1/K2 launch on its route.
14. The CLIP comparison, ``python -m clip_lite_torch.retrieval
   --weight-init clip`` as it runs (retrieval's main), over a COCO tree of
   CLIP_ITEMS (256) seeded JPEGs with one caption each, batch 128, on two
   seeded CLIP directories (fp32 Flax msgpack written by the port's
   writer, a synthetic byte-level vocabulary and merges), each with the
   counts set to 0 just before and read just after: (a)
   openai/clip-vit-base-patch32's published widths (vision 768 wide, 12
   layers, 12 heads, patch 32 at 224 px; text 512 wide, 12 layers, 8
   heads, 77 positions, vocab 49,408; projection 512): K1 12 x 2 times at
   S = 50 (vision, zero key bias) and 12 x 2 at S = 77 (text, the causal
   and padding mask as the full bias), all on the 3xTF32 route; (b)
   openai/clip-vit-large-patch14's (vision 1024 wide, intermediate 4096,
   24 layers, 16 heads, patch 14 at 224 px; text 768 wide, intermediate
   3072, 12 layers, 12 heads; projection 768; 1.7 GB of weights): K1 24 x
   2 times at S = 257 on the key-tiled 3xTF32 route and 12 x 2 at S = 77
   on the 3xTF32 route.  Each: finite unit-norm embeddings; recalls in
   percent; the same model through the plain attention on the same
   inputs within CLIP_TOL (1e-5) of them; images/s and captions/s of the
   towers alone.  Then K1 against its plain version (and within four
   times its distance from float64) with its times, the plain version's,
   ``scaled_dot_product_attention``'s and the bound: on the 3xTF32 route
   at ViT-B/32's two shapes beside the CUDA-core kernel in turns; on the
   key-tiled route at (128, 197, 2304) (ViT-B/16, 12 heads; the
   CUDA-core kernel beside it in turns), (128, 257, 3072) (ViT-L/14, 16
   heads) and (128, 577, 3072) (ViT-L/14 at 336 px), each with a zero
   key bias.
15. Past 256 tokens, where the JAX package's wrapper takes XLA: the
   flagship with DATA.MAX_CAPTION_LENGTH 512 (BERT-12's 512 positions),
   captions of 257-512 tokens, each path with the counts set to 0 just
   before and read just after: (a) serving, EncoderBundle over N_ITEMS
   captions at batch BATCH: K1 12 x 2 launches, all on the key-tiled
   tensor-core route, the embeddings against the plain attention's at
   TEXT_TOL bf16, captions/s; (b) LONG_STEPS (4) training steps of BATCH
   through train_step (dropout 0.1): K1 and K2 12 a step on the key-tiled
   routes (check_routes), the median step over steps 2-4, pairs/s, peak
   memory; (c, e) phase 7's parity at PARITY_BATCH on long captions: fp32
   (K1 on the key-tiled 3xTF32 kernel in training, K2's key-tiled pair)
   at PARITY_TOL, bf16 at LONG_PARITY_TOL (loss) and the floor against
   the fp32 step; (d) MPNet's full bias, LONG_MPNET_STEPS (2) steps of
   LONG_MPNET_BATCH (64), the relative bias table's gradient (the sum of
   every layer's dbias from K2) finite and non-zero at every step; (f) K1
   and K2 at (128, 512, 2304), 12 heads, dropout 0.1: key bias in bf16
   and fp32, MPNet's full bias in bf16, each against its plain version
   and the float64 evaluation (bf16 within twice the plain version's
   distance, fp32 within four times plus 2^-21 of the output's size),
   with times, the plain version's, SDPA's (autograd for K2) and bounds
   (fp32 as three TF32 products at the TF32 peak).
16. One JSON line listing every kernel (K3's standalone and fused entry
   points each with their own launches, fp32 K1's 3xTF32 route with its
   rows at the CLIP towers' shapes and the flagship's S = 30, its
   key-tiled route with its rows at the three vision shapes and phase
   15's fp32 row, bf16 K1's key-tiled route and K2's key-tiled pair with
   phase 15's rows, crop_resize_flip_u8, which replaces the JAX core's
   host C++ and no TPU kernel); then the device line last.
"""

import functools
import gc
import json
import logging
import math
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
FLAGSHIP = ROOT / "configs" / "fs_bs1024_ni250k.yaml"
TUNED = ROOT / "configs" / "fs_tpu_tuned.yaml"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, per second
TOLS = {torch.float32: dict(rtol=1e-5, atol=1e-5),
        torch.bfloat16: dict(rtol=1.6e-2, atol=1e-2)}
# Text embeddings, fused K1 against the plain attention, same weights:
# bf16 may flip a rounding where the fp32 sums' order differs, and that
# carries through 12 layers; fp32 differs only in the sums' order.
TEXT_TOL = {"bfloat16": dict(max_abs=1e-2, min_cos=0.999),
            "float32": dict(max_abs=1e-4, min_cos=0.99999)}
# One training step through K1/K2 against one through the plain attention,
# same state and batch, dropout 0.  fp32: only the sums' order differs
# (kernels, cuDNN's convolution algorithms), through 12 layers and a
# ResNet-50.  bf16: roundings flip where the sums' order differs and the
# flips carry through the forward and backward of 12 layers.  The bf16 bar
# is about twice the largest reading on an H100 (max rel 0.147, cosine
# 0.99506), and two correct bf16 steps differ by as much: on the CPU the
# port's and the JAX package's bf16 steps differ in their QKV gradients by
# max rel 0.13-0.19 and cosine 0.987-0.992 (means over four batches with a
# ResNet-18 image tower; ``python tests/test_torch_amp.py``).  ``rel``
# bounds max|a - b| / max|b| of each QKV weight gradient, ``cos`` their
# cosine, ``loss`` the relative difference of total_loss and grad_norm.
PARITY_TOL = {"float32": dict(loss=1e-5, rel=1e-3, cos=0.99999),
              "bfloat16": dict(loss=1e-2, rel=0.3, cos=0.99)}
# And each bf16 step against the plain fp32 step: the K1/K2 step may lie at
# most BF16_FLOOR_FACTOR times as far as the plain bf16 step (in rel and in
# 1 - cos; the readings on an H100 are 0.98x and 1.00x).  Held with the
# image tower in fp32: at initialisation ResNet-50's bf16 rounding moves
# the text tower's QKV gradients to cosine 0.65-0.81 from fp32 in the JAX
# package itself (tests/test_torch_amp.py readings), which would hide any
# fault of the kernels.
BF16_FLOOR_FACTOR = 1.5
KEEP_RATE_TOL = 0.002
# K3's fused pass against the plain composition (flip, jitter, normalize as
# separate tensor operations), same draws, on the normalized output: with
# its own contrast means (an exact integer sum against the twin's fp32
# mean) and given the twin's means (then only the two sides' roundings may
# differ, and they mirror each other).
FUSED_ATOL = {"own means": 1e-4, "twin means": 1e-5}
# SASS opcodes that run on the fp32 pipes (and the conversions and the
# special-function unit, counted at the fp32 rate: a lower bound).
FP32_OPCODES = {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET",
                "FCHK", "FRND", "FADD32I", "FMUL32I", "FFMA32I", "MUFU",
                "F2I", "I2F", "F2F", "I2FP", "F2IP"}
H100_SMS, FP32_LANES = 132, 128
L2_SPILL_BYTES = 120e6  # timed inputs together: over twice the 50 MB L2
N_ITEMS, BATCH = 256, 128
# The flagship with MPNet-base as its text tower (768 wide, 12 layers of 12
# heads; MODEL.TEXTUAL.NUM_HIDDEN_LAYERS stays the flagship's 12).
MPNET = ["MODEL.TEXTUAL.NETWORK_NAME", "microsoft/mpnet-base"]
TRAIN_STEPS, PARITY_BATCH, RATE = 10, 32, 0.1
IMAGE_SHAPE = (BATCH, 224, 224, 3)
# The data phase: CLRec records at COCO's shapes, CLI steps per run, and
# batches timed through the host loader alone.
# Phase 10b's CLI runs take DATA_STEPS steps, saving every DATA_SAVE: 12
# (once 20), to keep the whole script well inside its time limit on slow
# hosts with phase 13 in it.
DATA_TRAIN, DATA_VAL, DATA_STEPS, DATA_LOADER_BATCHES = 512, 256, 12, 6
DATA_SAVE = DATA_STEPS // 2
SSL_CLI_STEPS = 6  # phase 10b's textual SSL run (D): no sweep, one save
# COCO train2017's image count, at the configs' CACHE_IMAGE_SIZE of 256.
N_CORPUS, CACHE_SIZE, N_CAPS, CAPTION_TOKENS = 118_287, 256, 5, (8, 20)
WORDS = ("a an the man woman child dog cat horse bus train car plate pizza "
         "table street city field beach kitchen red blue white black small "
         "large young old two three sitting standing riding eating holding "
         "walking parked next to on in with near under of at while").split()


def log(msg: str) -> None:
    print(msg, flush=True)


@functools.cache
def sleep_cycles_per_ms() -> float:
    """The card's clock as ``torch.cuda._sleep`` counts it, in cycles per ms."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def enqueue_ms(fn, args_list, iters=40) -> float:
    """Mean host ms per call until it is enqueued (the card idle first)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return host


def _events_ms(fn, args_list, iters: int, busy_ms: float) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if busy_ms:
        torch.cuda._sleep(int(sleep_cycles_per_ms() * busy_ms))
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, args_list, iters=40, warmup=5) -> float:
    """Mean ms per call over ``iters`` calls back to back, cycling through
    ``args_list`` (copies from :func:`l2_spilling_copies`, so every call
    reads its inputs from device memory), timed by events from an idle
    card: what a caller pays per call, the larger of the host's time to
    enqueue it and the card's time to run it."""
    for i in range(warmup):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    return _events_ms(fn, args_list, iters, 0.0)


def device_ms(fn, args_list, iters=40, warmup=5) -> float:
    """As :func:`time_ms`, but the card's time alone: it is held busy
    (``torch.cuda._sleep``) for twice the host's time to enqueue the
    calls, so that the events time them back to back on the device even
    where the host is slower than the kernels."""
    for i in range(warmup):
        fn(*args_list[i % len(args_list)])
    host = enqueue_ms(fn, args_list, iters) * iters
    return _events_ms(fn, args_list, iters, 2.0 * host + 1.0)


def l2_spilling_copies(*xs: torch.Tensor) -> list:
    """Enough copies of the tensors ``xs`` (at least 2) that together they
    exceed the 50 MB L2 more than twice over, as tuples for
    :func:`time_ms`."""
    n = max(2, math.ceil(L2_SPILL_BYTES / sum(x.nbytes for x in xs)))
    return [tuple(x.clone() for x in xs) for _ in range(n)]


def phase_environment() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def phase_build(sources=("attention_fwd", "attention_bwd", "normalize",
                         "decode_crop")) -> None:
    from clip_lite_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all(list(sources))
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'none (cached)'}")
    spills = []
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill",
                                       "error")):
                log(f"  {name}: {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and (int(m[1]) or int(m[2])):
                spills.append(f"{name}: {line.strip()}")
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")


def attention_inputs(s: int = 30, lengths=(1, 25)):
    """The flagship text batch's attention: qkv (128, s, 2304) fp32, the
    (128, s) key bias and the (128, s) bool of real keys, with real
    lengths drawn in ``lengths`` (inclusive)."""
    from clip_lite_torch.ops.attention import MASK_VALUE

    b, h = BATCH, 768
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv32 = torch.randn(b, s, 3 * h, device="cuda", generator=g)
    # Caption-like lengths: at s = 30 keys 25..29 are padding on every row,
    # more on most.
    lengths = torch.randint(lengths[0], lengths[1] + 1, (b,), device="cuda",
                            generator=g)
    keep = torch.arange(s, device="cuda")[None, :] < lengths[:, None]
    return qkv32, (1.0 - keep.float()) * MASK_VALUE, keep


def bound(n_bytes: int, n_ops: int, dtype: torch.dtype) -> dict:
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate, whichever is larger."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS[dtype]
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def phase_attention() -> dict:
    """K1 at the flagship text batch: (128, 30, 2304), 12 heads of 64; in
    fp32 the 3xTF32 route and the CUDA-core kernel (fp32 training's route)
    in turns (A B B A), ``host_ms`` the wrapper's.  Returns the fp32 row
    of the 3xTF32 route."""
    from clip_lite_torch.ops.attention import (
        _launch_fwd, attention_reference, fused_short_attention)

    b, s, nh, hd = BATCH, 30, 12, 64
    h = nh * hd
    qkv32, bias, keep = attention_inputs()
    mask4 = keep[:, None, None, :]

    def library(qkv):
        q, k, v = qkv.view(b, s, 3, nh, hd).permute(2, 0, 3, 1, 4)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask4)

    # The fp32 routes timed through the same launcher, so that their host
    # paths match.
    def cuda_core(qkv):
        return _launch_fwd(qkv, bias, nh, 0.0, 0, None, "cuda_core")

    def tf32x3(qkv):
        return _launch_fwd(qkv, bias, nh, 0.0, 0, None, "tf32x3")

    row = None
    for dtype in (torch.float32, torch.bfloat16):
        qkv = qkv32.to(dtype)
        before = fused_short_attention.tf32x3_launches
        out = fused_short_attention(qkv, bias, nh)
        on_route = fused_short_attention.tf32x3_launches - before
        ref = attention_reference(qkv, bias, nh)
        lib = library(qkv).transpose(1, 2).reshape(b, s, h)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lib_err = (lib.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(), **TOLS[dtype])
        if on_route != (dtype == torch.float32):
            raise AssertionError(f"K1 {dtype} at S = {s}: {on_route} launches "
                                 "on the 3xTF32 route")
        copies = l2_spilling_copies(qkv)

        def fwd(x):
            return fused_short_attention(x, bias, nh)

        item = qkv.element_size()
        n_bytes = qkv.numel() * item + bias.numel() * 4 + b * s * h * item
        n_ops = 4 * b * nh * s * s * hd  # two products, 2 operations a MAC
        least = bound(n_bytes, n_ops, dtype)
        times = {}
        if dtype == torch.float32:
            turns = (tf32x3, cuda_core, cuda_core, tf32x3)
            t = [time_ms(f, copies) for f in turns]
            d = [device_ms(f, copies) for f in turns]
            times = dict(ms=(t[0] + t[3]) / 2, ms_cuda_core=(t[1] + t[2]) / 2,
                         ms_device=(d[0] + d[3]) / 2,
                         ms_cuda_core_device=(d[1] + d[2]) / 2,
                         host_ms=enqueue_ms(fwd, copies))
        else:
            times = dict(ms=time_ms(fwd, copies))
        times.update(plain_ms=time_ms(lambda x: attention_reference(x, bias, nh),
                                      copies),
                     library_ms=time_ms(library, copies))
        log(f"K1 {str(dtype).replace('torch.', '')}: max|kernel-plain| {err} "
            f"(tol {TOLS[dtype]}), max|library-plain| {lib_err}; "
            f"{json.dumps(times)}; bound {least['bound_ms']} ms "
            f"({least['bound_by']}: {n_bytes} bytes, {n_ops} operations)")
        if dtype == torch.float32:
            row = dict(shape=[b, s, 3 * h], heads=nh, bias="key",
                       max_abs_err=err, launches=on_route, **times, **least)
    return row


def captions(rng: np.random.Generator, n: int) -> list:
    lengths = rng.integers(3, 36, n)  # some exceed the 30 tokens and truncate
    return [" ".join(rng.choice(WORDS, k)) for k in lengths]


def text_agreement(a: np.ndarray, b: np.ndarray) -> dict:
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    return dict(max_abs=float(np.abs(a - b).max()), min_cos=float(cos.min()))


def check_embeddings(name: str, emb: np.ndarray) -> None:
    if emb.shape != (N_ITEMS, 2048) or not np.isfinite(emb).all():
        raise AssertionError(f"{name}: shape {emb.shape}, finite "
                             f"{np.isfinite(emb).all()}")
    norm_err = float(np.abs(np.linalg.norm(emb, axis=1) - 1.0).max())
    if norm_err > 1e-4:
        raise AssertionError(f"{name}: norms off 1 by {norm_err}")


def text_tower(cfg, model) -> str:
    return (f"{cfg.MODEL.TEXTUAL.NETWORK_NAME}-"
            f"{cfg.MODEL.TEXTUAL.NUM_HIDDEN_LAYERS}/"
            f"{model.text_encoder.transformer.hidden_size}")


def check_routes(cfg, seq: int, launches: dict, training: bool = False) -> None:
    """Every K1 and K2 launch of a main path took the route that
    attention_route picks for its kernel, compute type and caption length,
    and for fp32 K1 whether it ``training`` (the tensor cores for bf16 at S
    <= 64; for fp32 K1 at S <= 80 outside training the 3xTF32 kernel; above
    256 the key-tiled kernels): all of them on that route's count
    (``<kernel>_tc``, ``<kernel>_tf32x3``, ``attention_fwd_tc_tiled``,
    ``attention_bwd_tiled`` ...), none on another's."""
    from clip_lite_torch.factories import compute_dtype
    from clip_lite_torch.ops.attention import attention_route

    for kernel, name in (("forward", "attention_fwd"),
                         ("backward", "attention_bwd")):
        if name not in launches:
            continue
        route = attention_route(compute_dtype(cfg), seq, kernel, training)
        for other, key in (("tensor_core", f"{name}_tc"),
                           ("tf32x3", f"{name}_tf32x3"),
                           ("tf32x3_tiled", f"{name}_tf32x3_tiled"),
                           ("tensor_core_tiled", f"{name}_tc_tiled"),
                           ("tiled", f"{name}_tiled")):
            if key not in launches:
                if route == other:
                    raise AssertionError(f"{name}: the {other} route's "
                                         "launches were not counted")
                continue
            want = launches[name] if route == other else 0
            if launches[key] != want:
                raise AssertionError(f"{name}: {launches[key]} of "
                                     f"{launches[name]} launches on the {other} "
                                     f"route, expected {want} ({route})")


def phase_main_path(overrides=(), name: str = "main path") -> dict:
    """Inference through EncoderBundle: the flagship, or the flagship with
    ``overrides`` (MPNet's text tower)."""
    from clip_lite_torch.config import Config
    from clip_lite_torch.data.tokenizers import HashingTokenizer
    from clip_lite_torch.eval_utils import EncoderBundle
    from clip_lite_torch.ops.attention import fused_short_attention
    from clip_lite_torch.retrieval import score_retrieval

    overrides = list(overrides)
    cfg = Config(str(FLAGSHIP), overrides)
    bundle = EncoderBundle(cfg, batch_size=BATCH, device="cuda")
    n_layers = cfg.MODEL.TEXTUAL.NUM_HIDDEN_LAYERS
    log(f"{name}: {cfg.MODEL.VISUAL.NETWORK_NAME} + "
        f"{text_tower(cfg, bundle.model)}, AMP "
        f"{cfg.AMP} {cfg.DTYPE}, "
        f"{sum(p.numel() for p in bundle.model.parameters())} parameters")
    rng = np.random.default_rng(0)
    images = rng.standard_normal((N_ITEMS, 224, 224, 3), dtype=np.float32)
    texts = captions(rng, N_ITEMS)
    tok = HashingTokenizer(cfg.MODEL.TEXTUAL.VOCAB_SIZE,
                           cfg.DATA.MAX_CAPTION_LENGTH)
    txt2img = {i: i for i in range(N_ITEMS)}
    img2txt = {i: [i] for i in range(N_ITEMS)}
    # Warm-up (cuDNN algorithm choice, allocator), outside the counted run.
    bundle.encode_images(images[:BATCH])
    bundle.encode_texts(texts[:BATCH], tok)
    torch.cuda.synchronize()

    fused_short_attention.launches = 0
    fused_short_attention.tc_launches = 0
    fused_short_attention.tf32x3_launches = 0
    fused_short_attention.tf32x3_tiled_launches = 0
    t0 = time.perf_counter()
    recalls, img_emb, txt_emb = score_retrieval(bundle, images, texts, tok,
                                                txt2img, img2txt)
    wall = time.perf_counter() - t0
    launches = {"attention_fwd": fused_short_attention.launches,
                "attention_fwd_tc": fused_short_attention.tc_launches,
                "attention_fwd_tf32x3": fused_short_attention.tf32x3_launches,
                "attention_fwd_tf32x3_tiled":
                    fused_short_attention.tf32x3_tiled_launches}
    log(f"{name}: score_retrieval of {N_ITEMS} images + {N_ITEMS} captions "
        f"in {wall} s; launches {launches}; recalls "
        f"{json.dumps({k: float(v) for k, v in recalls.items()})}")
    check_embeddings("image embeddings", img_emb)
    check_embeddings("text embeddings", txt_emb)
    expected = n_layers * math.ceil(N_ITEMS / BATCH)
    if launches["attention_fwd"] != expected:
        raise AssertionError(f"K1 launched {launches['attention_fwd']} times, "
                             f"expected {expected}")
    check_routes(cfg, cfg.DATA.MAX_CAPTION_LENGTH, launches)
    if not all(0.0 <= float(v) <= 100.0 for v in recalls.values()):
        raise AssertionError(f"recalls out of range: {recalls}")

    # The text path once more through the plain attention on the card, with
    # the same weights: bf16 as on the main path, then both in fp32.
    state = bundle.model.state_dict()
    plain = EncoderBundle(Config(str(FLAGSHIP), overrides + [
        "MODEL.TEXTUAL.FUSED_ATTENTION", "false"]), state_dict=state,
        device="cuda")
    agree = {"bfloat16": text_agreement(txt_emb, plain.encode_texts(texts, tok))}
    del plain
    fp32 = [EncoderBundle(Config(str(FLAGSHIP), overrides + [
        "AMP", False, "MODEL.TEXTUAL.FUSED_ATTENTION", flag]),
        state_dict=state, device="cuda").encode_texts(texts, tok)
        for flag in ("true", "false")]
    agree["float32"] = text_agreement(*fp32)
    for dt, got in agree.items():
        tol = TEXT_TOL[dt]
        log(f"{name}: text embeddings, K1 vs plain attention, {dt}: {got} "
            f"(tol {tol})")
        if got["max_abs"] > tol["max_abs"] or got["min_cos"] < tol["min_cos"]:
            raise AssertionError(f"{dt} text embeddings disagree: {got}")

    img_s, txt_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        bundle.encode_images(images)
        img_s.append(N_ITEMS / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        bundle.encode_texts(texts, tok)
        txt_s.append(N_ITEMS / (time.perf_counter() - t0))
    log(f"{name} throughput at batch {BATCH} (numpy in, numpy out): images/s "
        f"{img_s} (median {statistics.median(img_s)}), captions/s {txt_s} "
        f"(median {statistics.median(txt_s)})")
    del bundle
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches, captions_per_s=statistics.median(txt_s))


def float64_bar(name: str, pairs, exact, tf32x3: bool = False) -> dict:
    """Each (kernel, plain) output against the float64 evaluation of the
    same function from the same inputs and keep mask: the kernel's max
    error may be at most twice the plain version's; with ``tf32x3`` (fp32
    products as three TF32 products, 2^-22 of each left out) four times
    plus 2^-21 of the output's size."""
    out = {}
    for what, (got, twin), want in zip(("out", "dqkv", "dbias"), pairs, exact):
        if want is None:
            continue
        plain = (twin.double() - want).abs().max().item()
        out[what] = dict(kernel=(got.double() - want).abs().max().item(),
                         plain=plain, bar=4.0 * plain + 2.0 ** -21
                         * want.abs().max().item() if tf32x3 else 2.0 * plain)
    log(f"{name}: max error from float64, kernel vs plain: {out}")
    over = {k: v for k, v in out.items() if v["kernel"] > v["bar"]}
    if over:
        raise AssertionError(f"{name}: kernel over its bar from float64: {over}")
    return out


def time_attention(qkv, g, bias, valid, rate: float, seed: int, keep) -> tuple:
    """K1 and K2 on ``qkv`` (128, S, 2304), output gradient ``g``, bias
    (B, S) or (B, NH, S, S), dropout ``rate`` from Philox(``seed``)
    (``keep``, its mask, for the plain versions): ms of the kernels on
    their route, and where that is not the CUDA-core route (bf16; fp32 K1)
    of the CUDA-core route on the same inputs in turns (A B B A), each as a
    caller pays it (``ms``, :func:`time_ms`)
    and on the device alone (``ms_device``, :func:`device_ms`); the
    host's ms to enqueue one call of the wrapper; the plain versions; the
    library call (``scaled_dot_product_attention`` with the bool of real
    keys, or the full bias as a float mask whose gradient the backward
    takes), both ways; bounds.  Every call reads its inputs from device
    memory (``l2_spilling_copies``).  Past MAX_SEQ (256) the CUDA-core
    kernels take no launch, so the routes there are timed alone, and fp32's
    bound counts its products as three TF32 products each at the TF32
    peak, as the key-tiled routes compute them."""
    from clip_lite_torch.ops.attention import (
        MAX_SEQ, _launch_bwd, _launch_fwd, attention_backward,
        attention_backward_reference, attention_forward, attention_reference,
        attention_route)

    b, s, three_h = qkv.shape
    nh, hd = 12, 64
    h = nh * hd
    dtype, item = qkv.dtype, qkv.element_size()
    full_bias = bias.ndim == 4
    copies = l2_spilling_copies(qkv, g, bias)

    def library_fwd(x, _, m):
        q, k, v = x.view(b, s, 3, nh, hd).permute(2, 0, 3, 1, 4)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                              dropout_p=rate)

    # The library call's mask: the bool of real keys, or the full bias in
    # the compute type, requiring its gradient in the graphs.
    lib_inputs = [(x, y, m.to(dtype, copy=True) if full_bias
                   else valid[:, None, None, :]) for x, y, m in copies]
    graphs = []
    for x, y, m in lib_inputs:
        x = x.detach().requires_grad_()
        m = m.detach().requires_grad_(full_bias)
        graphs.append((library_fwd(x, None, m), x,
                       y.view(b, s, nh, hd).transpose(1, 2), m))
    wrt = (lambda x, m: (x, m)) if full_bias else (lambda x, m: x)
    o, x, y, m = graphs[0]
    mask_grad = not full_bias or torch.autograd.grad(
        o, wrt(x, m), y, retain_graph=True, allow_unused=True)[1] is not None
    if not mask_grad:
        log("scaled_dot_product_attention gave the float mask no gradient: "
            "no library time for K2")

    # The wrappers (the route attention_route picks), or the CUDA-core
    # kernels launched directly.
    def fwd(cuda_core: bool):
        if cuda_core:
            return lambda x, _, m: _launch_fwd(x, m, nh, rate, seed, None,
                                               "cuda_core")
        return lambda x, _, m: attention_forward(x, m, nh, dropout_rate=rate,
                                                 seed=seed)

    def bwd(cuda_core: bool):
        if cuda_core:
            return lambda x, y, m: _launch_bwd(x, m, y, nh, rate, seed, None,
                                               "cuda_core")
        return lambda x, y, m: attention_backward(x, m, y, nh, dropout_rate=rate,
                                                  seed=seed)

    def turns(make, kernel: str) -> dict:
        times = dict(host_ms=enqueue_ms(make(False), copies))
        for key, timer in (("ms", time_ms), ("ms_device", device_ms)):
            if attention_route(dtype, s, kernel) == "cuda_core" or s > MAX_SEQ:
                times[key] = timer(make(False), copies)  # one route
                continue
            t = [timer(make(c), copies) for c in (False, True, True, False)]
            times[key] = (t[0] + t[3]) / 2
            times[key.replace("ms", "ms_cuda_core", 1)] = (t[1] + t[2]) / 2
        return times

    def library(fn, inputs) -> dict:
        return dict(library_ms=time_ms(fn, inputs),
                    library_ms_device=device_ms(fn, inputs))

    def least(n_bytes: int, n_ops: int) -> dict:
        if dtype == torch.float32 and s > MAX_SEQ:  # 3xTF32
            t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, 3 * n_ops / TF32_PEAK_OPS
            return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops else "operations")
        return bound(n_bytes, n_ops, dtype)

    k1 = dict(
        **turns(fwd, "forward"),
        plain_ms=time_ms(lambda x, _, m: attention_reference(x, m, nh, rate, keep),
                         copies),
        **library(library_fwd, lib_inputs),
        # qkv and the bias read once, the context written once.
        **least(qkv.numel() * item + bias.numel() * 4 + b * s * h * item,
                4 * b * nh * s * s * hd))
    k2 = dict(
        **turns(bwd, "backward"),
        plain_ms=time_ms(lambda x, y, m: attention_backward_reference(
            x, m, y, nh, rate, keep), copies),
        **(library(lambda o, x, y, m: torch.autograd.grad(
            o, wrt(x, m), y, retain_graph=True), graphs) if mask_grad
           else dict(library_ms=None, library_ms_device=None)),
        # qkv, bias and g read once, dqkv (and dbias) written once; five
        # products.
        **least(2 * qkv.numel() * item + (2 if full_bias else 1) * bias.numel() * 4
                + g.numel() * item, 10 * b * nh * s * s * hd))
    del copies, lib_inputs, graphs, o, x, y, m
    return k1, k2


def phase_attention_training(full_bias: bool = False) -> dict:
    """K1 with dropout and K2 at the flagship text batch, fp32 and bf16,
    rate 0 and RATE, each against its plain version given the Philox
    mask that the kernels' own entry point writes.  With ``full_bias``,
    under MPNet's (B, NH, S, S) bias, K2's fp32 dbias included, and the
    library call's backward takes the float mask's gradient too."""
    from clip_lite_torch.ops.attention import (
        attention_backward, attention_backward_reference, attention_float64,
        attention_forward, attention_reference, dropout_keep_mask)

    b, s, nh, h = BATCH, 30, 12, 768
    qkv32, key_bias, valid = attention_inputs()
    bias = mpnet_bias(key_bias) if full_bias else key_bias
    variant = "full bias " if full_bias else ""
    g32 = torch.randn(b, s, h, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(1))
    seed = 2024
    keep = dropout_keep_mask(seed, b, nh, s, RATE, "cuda")
    frac = keep.float().mean().item()
    same = torch.equal(keep, dropout_keep_mask(seed, b, nh, s, RATE, "cuda"))
    other = not torch.equal(keep, dropout_keep_mask(seed + 1, b, nh, s, RATE,
                                                    "cuda"))
    log(f"Philox keep mask, rate {RATE}: keep fraction {frac} over "
        f"{keep.numel()} draws (want {1 - RATE} +- {KEEP_RATE_TOL}); same seed "
        f"same mask {same}; next seed another mask {other}")
    if abs(frac - (1.0 - RATE)) > KEEP_RATE_TOL or not same or not other:
        raise AssertionError("the dropout mask fails its checks")

    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for rate in (0.0, RATE):
            qkv, g = qkv32.to(dtype), g32.to(dtype)
            km = keep if rate else None
            out = attention_forward(qkv, bias, nh, dropout_rate=rate, seed=seed)
            ref = attention_reference(qkv, bias, nh, rate, km)
            dqkv, dbias = attention_backward(qkv, bias, g, nh, dropout_rate=rate,
                                             seed=seed)
            dref, dbias_ref = attention_backward_reference(qkv, bias, g, nh,
                                                           rate, km)
            torch.cuda.synchronize()
            errs = [(a.float() - r.float()).abs().max().item()
                    for a, r in ((out, ref), (dqkv, dref))]
            # The float64 reading first, so that a failing bar below comes
            # with it.
            exact = None
            if dtype == torch.bfloat16:
                exact = float64_bar(
                    f"K1/K2 {variant}{name} rate {rate}",
                    [(out, ref), (dqkv, dref), (dbias, dbias_ref)],
                    attention_float64(qkv, bias, g, nh, rate, km))
            torch.testing.assert_close(out.float(), ref.float(), **TOLS[dtype])
            torch.testing.assert_close(dqkv.float(), dref.float(),
                                       **TOLS[dtype])
            if full_bias:
                # dbias is fp32 on both sides, whatever the compute type.
                if dbias.dtype != torch.float32 or dbias.shape != bias.shape:
                    raise AssertionError(f"dbias {dbias.dtype} "
                                         f"{tuple(dbias.shape)}")
                errs.append((dbias - dbias_ref).abs().max().item())
                torch.testing.assert_close(dbias, dbias_ref,
                                           **TOLS[torch.float32])
            elif dbias is not None or dbias_ref is not None:
                raise AssertionError("a key bias got a gradient")
            del out, ref, dqkv, dref, dbias, dbias_ref
            k1, k2 = time_attention(qkv, g, bias, valid, rate, seed, km)
            k1["max_abs_err"], k2["max_abs_err"] = errs[:2]
            if full_bias:
                k2["dbias_max_abs_err"] = errs[2]
            if exact is not None:
                k1["float64_err"] = exact["out"]
                k2["float64_err"] = {k: v for k, v in exact.items() if k != "out"}
            result[(name, rate)] = dict(k1=k1, k2=k2)
            for kname, r in (("K1", k1), ("K2", k2)):
                log(f"{kname} {variant}{name} rate {rate}: max|kernel-plain| "
                    f"{r['max_abs_err']} (tol {TOLS[dtype]}), dbias "
                    f"{r.get('dbias_max_abs_err', '-')}; kernel {r['ms']} ms "
                    f"({r['ms_device']} on the device; CUDA-core route "
                    f"{r.get('ms_cuda_core', '-')}, "
                    f"{r.get('ms_cuda_core_device', '-')}; host "
                    f"{r['host_ms']} ms a call), plain {r['plain_ms']} ms, "
                    f"library {r['library_ms']} ({r['library_ms_device']}) ms, "
                    f"bound {r['bound_ms']} ms ({r['bound_by']})")
    return result


def mpnet_bias(key_bias: torch.Tensor) -> torch.Tensor:
    """A full (B, 12, S, S) bias built as MPNet builds it: a seeded
    relative bias table (32 buckets x 12 heads) gathered over the
    (query, key) buckets, plus the padding of ``key_bias`` (B, S)."""
    from clip_lite_torch.models.mpnet import relative_bucket_grid

    s = key_bias.shape[1]
    table = torch.randn(32, 12, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(6))
    rel = table[relative_bucket_grid(s, 32, torch.device("cuda"))]
    # Contiguous before the add, which takes its inputs' layout.
    return rel.permute(2, 0, 1).contiguous()[None] + key_bias[:, None, None, :]


def training_batch(rng: np.random.Generator, tok, n: int, crop: int,
                   make_captions=captions) -> dict:
    enc = tok(make_captions(rng, n), max_length=tok.max_length)
    return {"image": rng.standard_normal((n, crop, crop, 3), dtype=np.float32),
            "input_ids": np.asarray(enc["input_ids"], np.int32),
            "attention_mask": np.asarray(enc["attention_mask"], np.int32)}


def lr_group(name: str) -> str:
    return ("image_encoder" if "image_encoder" in name else
            "text_encoder" if "text_encoder" in name else "rest")


def phase_training(overrides=(), name: str = "training") -> dict:
    """The training main path: flagship (or the flagship with
    ``overrides``), 10 steps of 128 pairs through the engine and the loop,
    then one eval sweep of one batch."""
    from clip_lite_torch.config import Config
    from clip_lite_torch.data.tokenizers import HashingTokenizer
    from clip_lite_torch.engine import (
        create_train_state, make_eval_step, make_train_step, metrics_to_floats)
    from clip_lite_torch.ops.attention import (
        attention_backward, fused_short_attention)
    from clip_lite_torch.train import train_loop

    cfg = Config(str(FLAGSHIP), list(overrides))
    t0 = time.perf_counter()
    state = create_train_state(cfg, device="cuda")
    n_layers = cfg.MODEL.TEXTUAL.NUM_HIDDEN_LAYERS
    log(f"{name}: {cfg.MODEL.VISUAL.NETWORK_NAME} + "
        f"{text_tower(cfg, state.model)}, "
        f"dropout {cfg.MODEL.TEXTUAL.DROPOUT}, "
        f"AMP {cfg.AMP} {cfg.DTYPE}, {cfg.OPTIM.OPTIMIZER_NAME} + Lookahead "
        f"k={cfg.OPTIM.LOOKAHEAD.STEPS}, warmup {cfg.OPTIM.WARMUP_STEPS}; "
        f"state built in {time.perf_counter() - t0} s")
    rng = np.random.default_rng(1)
    tok = HashingTokenizer(cfg.MODEL.TEXTUAL.VOCAB_SIZE,
                           cfg.DATA.MAX_CAPTION_LENGTH)
    crop = cfg.DATA.IMAGE_CROP_SIZE
    batches = [training_batch(rng, tok, BATCH, crop) for _ in range(TRAIN_STEPS)]
    val_batches = [training_batch(rng, tok, BATCH, crop)]
    params = dict(state.model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    # MPNet's relative bias table: its gradient is the sum of every
    # layer's dbias from K2, checked finite and non-zero at every step,
    # and the table moved by the last step.  Not by step 2: the text LR
    # there is 1e-3 x 1e-4 (warmup), and an update of 1e-7 x the clipped
    # gradient lies below fp32's spacing of its N(0, 0.02) values.
    tables = [n for n in params if n.endswith("relative_attention_bias.weight")]
    stats_before = {n: b.clone() for n, b in state.model.named_buffers()}
    train_step, eval_step = make_train_step(cfg), make_eval_step(cfg)
    steps, evals = [], []

    def checked_step(st, batch):
        torch.cuda.synchronize()
        start = time.perf_counter()
        st, metrics = train_step(st, batch)
        enqueued = time.perf_counter() - start  # the host's share
        values = metrics_to_floats(metrics)  # this step's one sync
        steps.append(dict(seconds=time.perf_counter() - start,
                          enqueue_seconds=enqueued, **values))
        if not (math.isfinite(values["total_loss"])
                and math.isfinite(values["grad_norm"])):
            raise AssertionError(f"step {st.step}: {values}")
        for n in tables:
            gmax = float(params[n].grad.abs().max())
            steps[-1].update(table_grad_max=gmax, table_moved=not torch.equal(
                params[n], before[n]))
            if not 0.0 < gmax < math.inf:
                raise AssertionError(f"step {st.step}: the relative bias "
                                     f"table's gradient has max {gmax}")
        if st.step == 1 and not all(torch.equal(p, before[n])
                                    for n, p in params.items()):
            raise AssertionError("step 1 (LR multiplier 0) moved parameters")
        if st.step == 2:
            moved = {}
            for n, p in params.items():
                moved.setdefault(lr_group(n), []).append(
                    not torch.equal(p, before[n]))
            log(f"tensors moved by step 2, by LR group: "
                f"{ {k: f'{sum(v)}/{len(v)}' for k, v in moved.items()} }")
            if not all(any(v) for v in moved.values()):
                raise AssertionError("step 2 left an LR group unmoved")
        if st.step == 5:
            slow = st.optimizer.slow_state()
            if not all(torch.equal(p, slow[n]) for n, p in params.items()):
                raise AssertionError("after step 5 the parameters are not the "
                                     "Lookahead slow weights")
        return st, metrics

    def recorded_eval(st, batch, index=0):
        comps = eval_step(st, batch, index)
        evals.append(metrics_to_floats(comps))
        return comps

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_short_attention.launches = fused_short_attention.tc_launches = 0
    fused_short_attention.tf32x3_launches = 0
    fused_short_attention.tf32x3_tiled_launches = 0
    attention_backward.launches = attention_backward.tc_launches = 0
    t0 = time.perf_counter()
    state = train_loop(state, checked_step, iter(batches), TRAIN_STEPS,
                       log_every=TRAIN_STEPS, eval_step=recorded_eval,
                       val_batches=val_batches, checkpoint_every=TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"attention_fwd": fused_short_attention.launches,
                "attention_bwd": attention_backward.launches}
    routes = {"attention_fwd_tc": fused_short_attention.tc_launches,
              "attention_fwd_tf32x3": fused_short_attention.tf32x3_launches,
              "attention_fwd_tf32x3_tiled":
                  fused_short_attention.tf32x3_tiled_launches,
              "attention_bwd_tc": attention_backward.tc_launches}
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    for i, rec in enumerate(steps):
        log(f"{name} step {i + 1}: {json.dumps(rec)}")
    log(f"{name} eval sweep: {json.dumps(evals)}")
    log(f"{name}: {TRAIN_STEPS} steps + eval in {wall} s; launches {launches}, "
        f"on the tensor-core route {routes}; "
        f"relative bias tables {tables}: unchanged by step 1, a finite "
        f"non-zero gradient at every step, moved by step {TRAIN_STEPS}")
    expected = {"attention_fwd": n_layers * (TRAIN_STEPS + len(val_batches)),
                "attention_bwd": n_layers * TRAIN_STEPS}
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    check_routes(cfg, cfg.DATA.MAX_CAPTION_LENGTH, dict(launches, **routes))
    if tables and not steps[-1]["table_moved"]:
        raise AssertionError(f"step {TRAIN_STEPS} left the relative bias "
                             "table where it started")
    if state.step != TRAIN_STEPS or len(evals) != 1 or not all(
            math.isfinite(v) for v in evals[0].values()):
        raise AssertionError(f"step {state.step}, evals {evals}")
    unmoved = [n for n, b in state.model.named_buffers()
               if torch.equal(b, stats_before[n])]
    if unmoved:
        raise AssertionError(f"BatchNorm statistics that did not move: {unmoved}")
    times = [rec["seconds"] for rec in steps[2:]]
    median = statistics.median(times)
    enqueue = statistics.median(rec["enqueue_seconds"] for rec in steps[2:])
    log(f"{name} throughput at batch {BATCH}: median step {median} s over "
        f"steps 3-{TRAIN_STEPS} ({times}), {BATCH / median} pairs/s; median "
        f"host enqueue {enqueue} s; peak memory {peak_mb} MiB")
    del state, params, before
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, step_s=median, pairs_per_s=BATCH / median,
                enqueue_s=enqueue, peak_mib=peak_mb)


def parity(a, b) -> dict:
    """How far run ``a`` lies from run ``b``: the larger relative difference
    of total_loss and grad_norm, and over the layers' QKV weight gradients
    (and MPNet's relative bias table's) the largest max|a - b| / max|b|
    and the smallest cosine."""
    (ma, ga), (mb, gb) = a, b
    return dict(
        loss_rel=max(abs(ma[k] - mb[k]) / abs(mb[k])
                     for k in ("total_loss", "grad_norm")),
        qkv_grad_rel_max=max(((x - y).abs().max() / y.abs().max()).item()
                             for x, y in zip(ga, gb)),
        qkv_grad_cos_min=min(F.cosine_similarity(x.flatten(), y.flatten(),
                                                 dim=0).item()
                             for x, y in zip(ga, gb)))


def within(got: dict, tol: dict) -> bool:
    return (got["loss_rel"] <= tol["loss"] and got["qkv_grad_rel_max"] <= tol["rel"]
            and got["qkv_grad_cos_min"] >= tol["cos"])


def phase_training_parity(overrides=(), name: str = "training parity",
                          make_captions=captions, tol=None,
                          floor_kinds=("text_bf16",)) -> dict:
    """One step through K1/K2 against one through the plain attention, same
    state and batch, dropout 0, at batch PARITY_BATCH: in fp32 and in bf16
    (AMP), held at PARITY_TOL (or ``tol``); and each bf16 step, the bf16
    one with the image tower in fp32 ("text_bf16") too, against the plain
    fp32 step, the bf16 noise floor, held at BF16_FLOOR_FACTOR for
    ``floor_kinds``.  The flagship, or the flagship with ``overrides``;
    captions from ``make_captions``."""
    tol = dict(PARITY_TOL, **(tol or {}))
    from clip_lite_torch.config import Config
    from clip_lite_torch.data.tokenizers import HashingTokenizer
    from clip_lite_torch.engine import (
        create_train_state, make_train_step, metrics_to_floats)

    runs, state_dict, batch, launches = {}, None, None, {}
    for kind in ("float32", "bfloat16", "text_bf16"):
        for flag in ("true", "false"):
            cfg = Config(str(FLAGSHIP), list(overrides) + [
                "MODEL.TEXTUAL.DROPOUT", 0.0, "AMP", kind != "float32",
                "MODEL.TEXTUAL.FUSED_ATTENTION", flag])
            if batch is None:
                tok = HashingTokenizer(cfg.MODEL.TEXTUAL.VOCAB_SIZE,
                                       cfg.DATA.MAX_CAPTION_LENGTH)
                batch = training_batch(np.random.default_rng(2), tok,
                                       PARITY_BATCH, cfg.DATA.IMAGE_CROP_SIZE,
                                       make_captions)
            state = create_train_state(cfg, device="cuda", state_dict=state_dict)
            if state_dict is None:
                state_dict = {k: v.detach().cpu()
                              for k, v in state.model.state_dict().items()}
            if kind == "text_bf16":  # all but the text tower in fp32
                text = set(state.model.text_encoder.modules())
                for module in state.model.modules():
                    if module not in text and hasattr(module, "compute_dtype"):
                        module.compute_dtype = torch.float32
            before = attention_counts()
            state, metrics = make_train_step(cfg)(state, batch)
            counts = {k: v - before[k] for k, v in attention_counts().items()}
            if flag == "true" and not counts["attention_fwd"]:
                raise AssertionError(f"{name} {kind}: K1 never launched")
            check_routes(cfg, cfg.DATA.MAX_CAPTION_LENGTH, counts, training=True)
            launches[f"{kind} {flag}"] = counts
            layers = state.model.text_encoder.transformer
            grads = [getattr(layers, n).qkv.weight.grad.float().clone()
                     for n in layers.layer_names]
            if hasattr(layers, "relative_attention_bias"):
                grads.append(layers.relative_attention_bias.weight.grad.clone())
            runs[kind, flag] = (metrics_to_floats(metrics), grads)
            log(f"{name} {kind}, FUSED_ATTENTION {flag}, batch "
                f"{PARITY_BATCH}: {runs[kind, flag][0]}; launches {counts}")
            del state, layers, grads
            torch.cuda.empty_cache()
    out = {kind: parity(runs[kind, "true"], runs[kind, "false"])
           for kind in ("float32", "bfloat16")}
    for kind, got in out.items():
        log(f"{name} {kind}, K1/K2 vs plain attention: {got} "
            f"(tol {tol[kind]})")
    floor = {(kind, flag): parity(runs[kind, flag], runs["float32", "false"])
             for kind in ("bfloat16", "text_bf16") for flag in ("true", "false")}
    for (kind, flag), got in floor.items():
        log(f"{name}: {kind} step, FUSED_ATTENTION {flag}, against the plain "
            f"fp32 step: {got}")
    for kind, got in out.items():
        if not within(got, tol[kind]):
            raise AssertionError(f"{name} {kind}: step parity fails: {got}")
    for kind in floor_kinds:
        fused, plain = floor[kind, "true"], floor[kind, "false"]
        if (fused["qkv_grad_rel_max"]
                > BF16_FLOOR_FACTOR * plain["qkv_grad_rel_max"]
                or 1 - fused["qkv_grad_cos_min"]
                > BF16_FLOOR_FACTOR * (1 - plain["qkv_grad_cos_min"])):
            raise AssertionError(
                f"{name}: the {kind} step through K1/K2 lies more than "
                f"{BF16_FLOOR_FACTOR}x as far from fp32 as the plain "
                "attention's")
    out["bf16_vs_float32"] = {f"{kind} {flag}": got
                              for (kind, flag), got in floor.items()}
    out["launches"] = launches
    return out


def attention_counts() -> dict:
    """K1's and K2's launches so far, and on each route but the CUDA
    cores', under check_routes' names."""
    from clip_lite_torch.ops.attention import (
        attention_backward, fused_short_attention)

    return {"attention_fwd": fused_short_attention.launches,
            "attention_fwd_tc": fused_short_attention.tc_launches,
            "attention_fwd_tf32x3": fused_short_attention.tf32x3_launches,
            "attention_fwd_tf32x3_tiled":
                fused_short_attention.tf32x3_tiled_launches,
            "attention_fwd_tc_tiled": fused_short_attention.tc_tiled_launches,
            "attention_bwd": attention_backward.launches,
            "attention_bwd_tc": attention_backward.tc_launches,
            "attention_bwd_tiled": attention_backward.tiled_launches}


def kernel_counters() -> dict:
    """Each hand-written kernel's wrapper, whose ``launches`` counts it,
    by the name of the wrapper's trace range (utils/trace.KERNEL_RANGES)."""
    from clip_lite_torch.data import native
    from clip_lite_torch.ops.attention import (
        attention_backward, fused_short_attention)
    from clip_lite_torch.ops.normalize import augment_normalize_u8, normalize_u8

    return {"K1 attention_fwd": fused_short_attention,
            "K2 attention_bwd": attention_backward,
            "K3 normalize_u8": normalize_u8,
            "K3 augment_normalize_u8": augment_normalize_u8,
            "crop_resize_flip_u8": native.crop_resize_flip_u8}


NVJPEG_KERNELS = r"^void nvjpeg::|^nvjpeg::"


def analyze_trace(name: str, path: str, launches: dict, n_steps: int,
                  exact=None, inside=None) -> dict:
    """Parse a trace of ``n_steps`` train steps and print: per step the
    host's enqueue (the train_step range), the device's busy time (the
    union of its kernels), the window (step start to next step start) and
    the idle share; ms a step by component and by category; the ten
    longest kernels with their counts; the longest idle gaps with what the
    host was doing; nvJPEG's kernels a step and how much of them overlaps
    the other kernels; the host's time in blocking runtime calls
    (synchronisations, copies).
    Fails unless each hand-written kernel of ``exact`` (default: all) has
    as many events as its wrapper's ``launches`` over the same steps,
    unless every event of the kernels of ``inside`` (default: ``exact``)
    sits inside its wrapper's range, and unless every kernel launch the
    trace records (on any thread) has its kernel event."""
    from clip_lite_torch.utils import trace as T

    t0 = time.perf_counter()
    tr = T.Trace(path)
    ops = tr.ops()
    split = T.step_split(tr, ops=ops)
    parse_s = time.perf_counter() - t0
    if len(split) != n_steps:
        raise AssertionError(f"{name}: {len(split)} train_step ranges in the "
                             f"trace, expected {n_steps}")
    window_us = sum(s["window_ms"] for s in split) * 1e3
    summary = T.roofline_summary(ops, n_steps, *T.device_specs("cuda"),
                                 window_us=window_us)
    for i, s in enumerate(split):
        log(f"{name} trace step {i + 1}: host enqueue {s['enqueue_ms']} ms, "
            f"device busy {s['busy_ms']} ms, window {s['window_ms']} ms, "
            f"idle share {s['idle_share']}")
    log(f"{name} trace, the host's ms a step by range (the profiler's cost "
        f"included): {json.dumps(T.host_ranges(tr))}")
    log(f"{name} trace, ms a step by component: "
        f"{json.dumps(summary['by_component'])}")
    log(f"{name} trace, ms a step by category: "
        f"{json.dumps(summary['by_category'])}")
    log(f"{name} trace roofline (a step): " + json.dumps(
        {k: v for k, v in summary.items()
         if k not in ("by_component", "by_category")}))
    kernels = {}
    for o in ops:
        if o["category"] == "kernel":
            k = kernels.setdefault(o["name"], [0.0, 0])
            k[0] += o["dur_us"]
            k[1] += 1
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    for kname, (us, n) in top:
        log(f"{name} trace kernel {us / 1e3 / n_steps:.4f} ms a step, "
            f"{n / n_steps:g} a step: {kname[:110]}")
    gaps = T.idle_gaps(tr, top=5, ops=ops)
    for g in gaps:
        log(f"{name} trace idle gap {g['gap_ms']:.4f} ms at "
            f"{g['start_ms']:.3f} ms, host: {g['host']}")
    syncs = T.sync_ms(tr)
    kernel_ops = [o for o in ops if o["category"] == "kernel"]
    nvjpeg = [(o["ts_us"], o["ts_us"] + o["dur_us"]) for o in kernel_ops
              if re.search(NVJPEG_KERNELS, o["name"])]
    others = [(o["ts_us"], o["ts_us"] + o["dur_us"]) for o in kernel_ops
              if not re.search(NVJPEG_KERNELS, o["name"])]
    nvjpeg_ms = sum(b - a for a, b in nvjpeg) / 1e3 / n_steps
    overlap_ms = T.overlap_us(nvjpeg, others) / 1e3 / n_steps
    log(f"{name} trace: nvJPEG's kernels {nvjpeg_ms} ms a step "
        f"({len(nvjpeg) / n_steps:g} a step), {overlap_ms} ms of it overlapping "
        f"the other kernels; the host in blocking runtime calls {syncs} ms "
        f"over {n_steps} steps; parsed in {parse_s} s")
    counts = T.kernel_counts(ops)
    # Every launch the trace records has its kernel event.
    lost = tr.lost_launches()
    steps = tr.ranges("train_step")
    for i in lost[:16]:
        e = tr.host[i]
        k = max([j for j, r in enumerate(steps) if r["ts"] <= e["ts"]],
                default=0)
        log(f"{name} trace: a launch without its kernel, {e['name']} in step "
            f"{k + 1} at {(e['ts'] - steps[k]['ts']) / 1e3:.3f} ms, thread "
            f"{'of the steps' if e['tid'] == steps[0]['tid'] else 'other'}, "
            f"inside {[tr.host[j]['name'] for j in tr.chain(i)][1:4]}, scope "
            f"{'/'.join(tr.scope_of(i))!r}")
    ranges = {k: len(tr.ranges(k)) for k in T.KERNEL_RANGES}
    outside = {k: sum(1 for o in kernel_ops if re.search(rx, o["name"])
                      and k not in o["scope"])
               for k, rx in T.KERNEL_RANGES.items()}
    log(f"{name} trace: kernel events {counts}, the wrappers' launches "
        f"{launches}, their ranges in the trace {ranges}, events outside "
        f"their wrapper's range {outside}; {len(lost)} launches of any "
        f"kernel without their kernel event")
    if lost:
        raise AssertionError(f"{name}: {len(lost)} kernel launches recorded "
                             "without their kernel")
    exact = list(T.KERNEL_RANGES) if exact is None else list(exact)
    inside = exact if inside is None else list(inside)
    if any(counts[k] != launches.get(k, 0) for k in exact):
        raise AssertionError(f"{name}: kernel events {counts} differ from the "
                             f"wrappers' launches {launches} ({exact})")
    if any(outside[k] for k in inside):
        raise AssertionError(f"{name}: kernel events outside their wrapper's "
                             f"range: {outside}")
    return dict(split=split, summary=summary, gaps=gaps, syncs_ms=syncs,
                counts=counts, nvjpeg_ms=nvjpeg_ms, nvjpeg_overlap_ms=overlap_ms,
                top=[(k[:110], us / 1e3 / n_steps, n / n_steps)
                     for k, (us, n) in top])


TRACE_WARM, TRACE_STEPS = 3, 5
# Seconds phase 10a waits after record_trace before its traced steps: the
# card's tracer has dropped the first kernels launched right after a
# record began (the device cache's sampling kernels, which open a step),
# their launches kept.
TRACE_SETTLE_S = 0.05


def phase_trace(float_step: dict, overrides=(), name: str = "trace") -> dict:
    """Phase 6's flagship step (AMP bf16, batch 128, S 30, the same batches'
    kind and one sync a step) under the profiler: TRACE_WARM steps, then
    TRACE_STEPS traced, the counts set to 0 just before and read just
    after; :func:`analyze_trace` prints and checks the trace."""
    import shutil
    import tempfile

    from clip_lite_torch.config import Config
    from clip_lite_torch.data.tokenizers import HashingTokenizer
    from clip_lite_torch.engine import (
        create_train_state, make_train_step, metrics_to_floats)
    from clip_lite_torch.utils.trace import capture_trace

    cfg = Config(str(FLAGSHIP), list(overrides))
    state = create_train_state(cfg, device="cuda")
    train_step = make_train_step(cfg)
    tok = HashingTokenizer(cfg.MODEL.TEXTUAL.VOCAB_SIZE,
                           cfg.DATA.MAX_CAPTION_LENGTH)
    rng = np.random.default_rng(1)
    batches = [training_batch(rng, tok, BATCH, cfg.DATA.IMAGE_CROP_SIZE)
               for _ in range(TRACE_WARM + TRACE_STEPS)]
    counters = kernel_counters()

    def run(todo):
        nonlocal state
        for batch in todo:
            state, metrics = train_step(state, batch)
            metrics_to_floats(metrics)  # phase 6's one sync a step

    def warm_up():
        """The last warm step, in the profiler's warm-up; then the counts
        set to 0."""
        run(batches[TRACE_WARM - 1:TRACE_WARM])
        for c in counters.values():
            c.launches = 0

    run(batches[:TRACE_WARM - 1])
    outdir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        t0 = time.perf_counter()
        path = capture_trace(lambda: run(batches[TRACE_WARM:]), outdir, "cuda",
                             warm_up)
        traced_s = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        out = analyze_trace(name, path, launches, TRACE_STEPS)
        out["launches"] = launches
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    split = out["split"]
    busy = statistics.median(s["busy_ms"] for s in split)
    out["untraced_idle_share"] = 1.0 - busy / 1e3 / float_step["step_s"]
    log(f"{name}: {TRACE_STEPS} steps traced after {TRACE_WARM}, captured and "
        f"written in {traced_s} s; median step window "
        f"{statistics.median(s['window_ms'] for s in split)} ms and host "
        f"enqueue {statistics.median(s['enqueue_ms'] for s in split)} ms "
        f"under the profiler (its cost: phase 6's untraced step "
        f"{float_step['step_s']} s, enqueue {float_step['enqueue_s']} s); "
        f"device busy {busy} ms a step, an idle share of "
        f"{out['untraced_idle_share']} of phase 6's untraced step")
    del state, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sass_fp32_instructions(kernel: str) -> dict:
    """The fp32-pipe instructions of ``kernel`` in the built K3 library's
    SASS (cuobjdump), up to its first unconditional EXIT (the division's
    slow path lies beyond): their count and opcodes."""
    from torch.utils.cpp_extension import CUDA_HOME

    from clip_lite_torch.ops import _build

    sass = subprocess.run(
        [str(Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"),
         "-sass", str(_build._target("normalize"))],
        capture_output=True, text=True, check=True).stdout
    sections = re.split(r"\n\s*Function : ", sass)
    body = [sec for sec in sections if kernel in sec.split("\n", 1)[0]]
    if len(body) != 1:
        raise AssertionError(f"{kernel}: {len(body)} SASS functions found")
    counts = {}
    for line in body[0].splitlines():
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z0-9_]+)",
                     line)
        if not m:
            continue
        if m[2] == "EXIT" and not m[1]:
            break
        if m[2] in FP32_OPCODES:
            counts[m[2]] = counts.get(m[2], 0) + 1
    return dict(count=sum(counts.values()), opcodes=counts)


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi), in Hz."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]
    return float(mhz) * 1e6


def phase_fused(u8: torch.Tensor) -> dict:
    """K3's fused flip + colour jitter + normalize pass at the flagship
    image batch with StepRNG draws, against the plain composition at both
    tolerances; its times beside the eager composition's, and its bound
    (bytes, and SASS-counted fp32 instructions a jittered pixel)."""
    from clip_lite_torch.ops.image_ops import (
        AugDraws, augment_reference, random_color_jitter, random_flip)
    from clip_lite_torch.ops.layers import StepRNG
    from clip_lite_torch.ops.normalize import augment_normalize_u8, normalize_u8

    draws = AugDraws.sample(StepRNG(0, 0, "cuda"), BATCH)
    means = (random_flip(u8, draws.flip).float()
             * draws.brightness.view(-1, 1, 1, 1)).mean(dim=(1, 2, 3))
    errors = {}
    for name, mu in (("own means", None), ("twin means", means)):
        got = augment_normalize_u8(u8, draws, True, True, mu)
        want = augment_reference(u8, draws, True, True, mu)
        torch.cuda.synchronize()
        if got.shape != u8.shape or not torch.isfinite(got).all():
            raise AssertionError(f"K3 fused ({name}): {tuple(got.shape)}, "
                                 "or values that are not finite")
        errors[name] = dict(max_abs_err=(got - want).abs().max().item(),
                            not_identical=int((got != want).sum()))
        if errors[name]["max_abs_err"] > FUSED_ATOL[name]:
            raise AssertionError(f"K3 fused ({name}): {errors[name]} over "
                                 f"{FUSED_ATOL[name]}")
    flip_only = augment_normalize_u8(u8, draws, True, False)
    if not torch.equal(flip_only, augment_reference(u8, draws, True, False)):
        raise AssertionError("K3 fused, flip only: not bit for bit the plain "
                             "composition")
    if not got.permute(0, 3, 1, 2).is_contiguous(
            memory_format=torch.channels_last):
        raise AssertionError("K3 fused: the NCHW view is not channels_last")
    del got, want, flip_only
    copies = l2_spilling_copies(u8)
    fused = lambda y: augment_normalize_u8(y, draws, True, True)  # noqa: E731
    eager = lambda y: augment_reference(y, draws, True, True)  # noqa: E731
    # The route before the fused pass: the eager flip and jitter, then the
    # standalone K3 (the plain twin's normalize builds its constants from
    # host memory, a sync on every call, so its host time is no "before").
    before = lambda y: normalize_u8(random_color_jitter(  # noqa: E731
        random_flip(y, draws.flip), draws))
    sass = sass_fp32_instructions("augment_pixel_probe")
    pixels = u8.numel() // 3
    jittered = int(draws.apply.sum()) * pixels // BATCH
    # A plain pixel's three conversions, subtractions and multiplications.
    n_ops = jittered * sass["count"] + (pixels - jittered) * 9
    n_bytes = (u8.numel() * (1 + 4) + BATCH * (2 + 4 * 4))
    t_ops = n_ops / (H100_SMS * FP32_LANES * sm_clock_hz())
    t_bytes = n_bytes / HBM_BYTES_PER_S
    r = dict(
        errors=errors, max_abs_err=errors["own means"]["max_abs_err"],
        ms=time_ms(fused, copies), ms_device=device_ms(fused, copies),
        host_ms=enqueue_ms(fused, copies),
        plain_ms=time_ms(eager, copies, iters=10),
        plain_ms_device=device_ms(eager, copies, iters=10),
        plain_host_ms=enqueue_ms(eager, copies, iters=10),
        before_ms=time_ms(before, copies, iters=10),
        before_ms_device=device_ms(before, copies, iters=10),
        before_host_ms=enqueue_ms(before, copies, iters=10),
        library_ms=None, bound_ms=1e3 * max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bound_bytes_ms=1e3 * t_bytes, bound_ops_ms=1e3 * t_ops,
        sass_fp32_per_jittered_pixel=sass, jittered_images=int(
            draws.apply.sum()), flipped_images=int(draws.flip.sum()))
    log(f"K3 fused at {IMAGE_SHAPE} ({r['flipped_images']} flipped, "
        f"{r['jittered_images']} jittered): max|kernel-plain| {errors}; flip "
        f"only bit for bit; kernel {r['ms']} ms ({r['ms_device']} on the "
        f"device, {r['host_ms']} of host time to enqueue), eager composition "
        f"{r['plain_ms']} ms ({r['plain_ms_device']} on the device, "
        f"{r['plain_host_ms']} to enqueue), eager flip + jitter + the "
        f"standalone K3 {r['before_ms']} ms ({r['before_ms_device']} on the "
        f"device, {r['before_host_ms']} to enqueue), bound {r['bound_ms']} ms "
        f"({r['bound_by']}: {n_bytes} bytes, {r['bound_bytes_ms']} ms; "
        f"{n_ops} fp32 instructions, {sass['count']} a jittered pixel "
        f"{sass['opcodes']}, {r['bound_ops_ms']} ms); NCHW view channels_last")
    return r


def phase_normalize() -> dict:
    """K3 at the flagship image batch in its four variants, against its
    plain version bit for bit; then the fused pass; then
    device_preprocess whole."""
    from clip_lite_torch.ops.image_ops import AugDraws, device_preprocess
    from clip_lite_torch.ops.layers import StepRNG
    from clip_lite_torch.ops.normalize import (
        INV_STD_255, MEAN_255, normalize_reference, normalize_u8)

    g = torch.Generator(device="cuda").manual_seed(3)
    u8 = torch.randint(0, 256, IMAGE_SHAPE, dtype=torch.uint8, device="cuda",
                       generator=g)
    # Float input as the colour jitter leaves it: [0, 255], not integral.
    f32 = torch.rand(IMAGE_SHAPE, device="cuda", generator=g) * 255.0
    scale = torch.tensor(INV_STD_255, device="cuda")
    shift = -torch.tensor(MEAN_255, device="cuda") * scale
    result = {}
    for x in (u8, f32):
        for dtype in (torch.float32, torch.bfloat16):
            name = (f"{str(x.dtype).replace('torch.', '')}->"
                    f"{str(dtype).replace('torch.', '')}")
            out = normalize_u8(x, dtype)
            ref = normalize_reference(x, dtype)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if out.dtype != dtype or out.shape != x.shape or not torch.equal(out, ref):
                raise AssertionError(f"K3 {name}: not bit for bit its plain "
                                     f"version (max abs err {err})")
            if not out.permute(0, 3, 1, 2).is_contiguous(
                    memory_format=torch.channels_last):
                raise AssertionError(f"K3 {name}: the NCHW view is not "
                                     "channels_last")
            copies = l2_spilling_copies(x)
            # One call for the same affine map (up to rounding): addcmul
            # promotes uint8 x float32 to float32 and casts into ``buf``.
            buf = torch.empty(x.shape, dtype=dtype, device="cuda")
            torch.addcmul(shift, x, scale, out=buf)
            lib_err = (buf.float() - ref.float()).abs().max().item()
            if not torch.allclose(buf.float(), ref.float(), **TOLS[dtype]):
                raise AssertionError(f"torch.addcmul {name}: not K3's map "
                                     f"(max abs err {lib_err})")
            library_ms = time_ms(
                lambda y: torch.addcmul(shift, y, scale, out=buf), copies)
            n_bytes = x.numel() * (x.element_size() + out.element_size())
            result[name] = dict(
                max_abs_err=err,
                ms=time_ms(lambda y: normalize_u8(y, dtype), copies),
                ms_device=device_ms(lambda y: normalize_u8(y, dtype), copies),
                plain_ms=time_ms(lambda y: normalize_reference(y, dtype), copies),
                library_ms=library_ms,
                library_ms_device=device_ms(
                    lambda y: torch.addcmul(shift, y, scale, out=buf), copies),
                **bound(n_bytes, 2 * x.numel(), torch.float32))
            r = result[name]
            log(f"K3 {name}: max|kernel-plain| {err} (bit for bit); kernel "
                f"{r['ms']} ms ({r['ms_device']} on the device), plain {r['plain_ms']} ms, library "
                f"(torch.addcmul on {x.dtype} input, max|lib-plain| "
                f"{lib_err}) {library_ms} ms ({r['library_ms_device']} on the "
                f"device), bound {r['bound_ms']} ms "
                f"({r['bound_by']}: {n_bytes} bytes); {len(copies)} input "
                f"copies; NCHW view channels_last")
            del copies, buf, out, ref
    del f32
    result["fused"] = phase_fused(u8)
    draws = AugDraws.sample(StepRNG(0, 0, "cuda"), BATCH)
    copies = l2_spilling_copies(u8)
    pre = {jitter: time_ms(lambda y: device_preprocess(
        y, draws, flip=True, color_jitter=jitter), copies, iters=20)
        for jitter in (False, True)}
    log(f"device_preprocess at {IMAGE_SHAPE} uint8 (K3's fused pass): flip "
        f"+ normalize {pre[False]} ms, flip + colour jitter + normalize "
        f"{pre[True]} ms per batch")
    result["device_preprocess_ms"] = {"flip": pre[False],
                                      "flip_jitter": pre[True]}
    return result


def synthetic_corpus(cfg, rng: np.random.Generator, n: int = N_CORPUS):
    """A decoded corpus of ``n`` items, by default the size of COCO
    train2017: uint8 tiles filled on the card from a seeded generator,
    N_CAPS captions an item of 8-20 real tokens (ids drawn with numpy), as
    DecodedCorpus."""
    from clip_lite_torch.data.device_cache import DecodedCorpus

    images = torch.empty((n, CACHE_SIZE, CACHE_SIZE, 3),
                         dtype=torch.uint8, device="cuda")
    images.random_(0, 256, generator=torch.Generator(device="cuda").manual_seed(5))
    seq = cfg.DATA.MAX_CAPTION_LENGTH
    lengths = rng.integers(CAPTION_TOKENS[0], CAPTION_TOKENS[1] + 1,
                           (n, N_CAPS))
    mask = (np.arange(seq) < lengths[..., None]).astype(np.int32)
    ids = rng.integers(1, cfg.MODEL.TEXTUAL.VOCAB_SIZE,
                       (n, N_CAPS, seq)).astype(np.int32) * mask
    return DecodedCorpus(images, list(ids), list(mask),
                         np.full(n, N_CAPS, np.int32),
                         np.arange(n, dtype=np.int64))


def attention_times_at(s: int) -> dict:
    """K1 and K2 in bf16, dropout RATE, at qkv (128, s, 2304) with the
    uint8 path's 8-20 real tokens, under the key bias and under an MPNet
    full bias: :func:`time_attention`'s times and bounds."""
    from clip_lite_torch.ops.attention import dropout_keep_mask

    qkv32, key_bias, valid = attention_inputs(s, CAPTION_TOKENS)
    g = torch.randn(BATCH, s, 768, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    keep = dropout_keep_mask(7, BATCH, 12, s, RATE, "cuda")
    out = {}
    for variant, bias in (("key bias", key_bias),
                          ("full bias", mpnet_bias(key_bias))):
        k1, k2 = time_attention(qkv32.bfloat16(), g.bfloat16(), bias, valid,
                                RATE, 7, keep)
        out[variant] = dict(k1=k1, k2=k2)
        for name, r in (("K1", k1), ("K2", k2)):
            log(f"{name} {variant} bf16 rate {RATE} at qkv ({BATCH}, {s}, 2304): "
                f"kernel {r['ms']} ms ({r['ms_device']} on the device), "
                f"CUDA-core route {r['ms_cuda_core']} "
                f"({r['ms_cuda_core_device']}) ms, host {r['host_ms']} ms a "
                f"call, plain {r['plain_ms']} ms, library {r['library_ms']} "
                f"({r['library_ms_device']}) ms, bound "
                f"{r['bound_ms']} ms ({r['bound_by']})")
    return out


def phase_uint8_training(float_step: dict) -> dict:
    """The uint8 training main path: fs_tpu_tuned + DATA.DEVICE_CACHE, a
    COCO-sized corpus on the card, 10 steps of 128 through the loop with
    the cache as the batch iterator, one eval sweep of one cache batch."""
    from clip_lite_torch.config import Config
    from clip_lite_torch.data.device_cache import DeviceDataCache
    from clip_lite_torch.engine import (
        create_train_state, make_eval_step, make_train_step, metrics_to_floats)
    from clip_lite_torch.ops.attention import (
        attention_backward, fused_short_attention)
    from clip_lite_torch.ops.image_ops import AugDraws
    from clip_lite_torch.ops.layers import StepRNG
    from clip_lite_torch.ops.normalize import augment_normalize_u8, normalize_u8
    from clip_lite_torch.train import train_loop

    gc.collect()
    torch.cuda.empty_cache()
    cfg = Config(str(TUNED), ["DATA.DEVICE_CACHE", True])
    if not (cfg.PARALLEL.ZERO1 and cfg.DATA.DEVICE_CACHE):
        raise AssertionError("fs_tpu_tuned.yaml no longer sets PARALLEL.ZERO1")
    t0 = time.perf_counter()
    corpus = synthetic_corpus(cfg, np.random.default_rng(4))
    cache = DeviceDataCache(corpus, BATCH, cache_size=cfg.DATA.CACHE_IMAGE_SIZE,
                            crop_size=cfg.DATA.IMAGE_CROP_SIZE,
                            seq_buckets=cfg.DATA.SEQ_BUCKETS,
                            seed=cfg.RANDOM_SEED, device="cuda")
    del corpus
    torch.cuda.synchronize()
    log(f"device cache: {N_CORPUS} tiles of {CACHE_SIZE} px, "
        f"{cache.memory_bytes()} bytes ({cache.memory_bytes() / 1e9} GB), "
        f"built in {time.perf_counter() - t0} s")
    state = create_train_state(cfg, device="cuda")
    n_layers = cfg.MODEL.TEXTUAL.NUM_HIDDEN_LAYERS
    stats_before = {n: b.clone() for n, b in state.model.named_buffers()}
    train_step, eval_step = make_train_step(cfg), make_eval_step(cfg)
    crop, seq = cfg.DATA.IMAGE_CROP_SIZE, 20
    steps, evals, first_batch, seen = [], [], {}, {}

    def grab(module, args):
        if "image" not in seen:
            seen["image"] = args[0].detach().clone()

    def checked_step(st, batch):
        if (batch["image"].dtype != torch.uint8
                or tuple(batch["image"].shape) != (BATCH, crop, crop, 3)
                or tuple(batch["input_ids"].shape) != (BATCH, seq)):
            raise AssertionError(
                f"cache batch: image {batch['image'].dtype} "
                f"{tuple(batch['image'].shape)}, ids "
                f"{tuple(batch['input_ids'].shape)}")
        first_batch.setdefault("image", batch["image"])
        torch.cuda.synchronize()
        start = time.perf_counter()
        st, metrics = train_step(st, batch)
        enqueued = time.perf_counter() - start  # the host's share
        values = metrics_to_floats(metrics)  # this step's one sync
        steps.append(dict(seconds=time.perf_counter() - start,
                          enqueue_seconds=enqueued, **values))
        if not (math.isfinite(values["total_loss"])
                and math.isfinite(values["grad_norm"])):
            raise AssertionError(f"step {st.step}: {values}")
        return st, metrics

    def recorded_eval(st, batch, index=0):
        comps = eval_step(st, batch, index)
        evals.append(metrics_to_floats(comps))
        return comps

    val_batches = [cache.batch_at(10 ** 6)]
    hook = state.model.image_encoder.register_forward_pre_hook(grab)
    cache.set_start(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    normalize_u8.launches = augment_normalize_u8.launches = 0
    fused_short_attention.launches = fused_short_attention.tc_launches = 0
    fused_short_attention.tf32x3_launches = 0
    fused_short_attention.tf32x3_tiled_launches = 0
    attention_backward.launches = attention_backward.tc_launches = 0
    t0 = time.perf_counter()
    state = train_loop(state, checked_step, iter(cache), TRAIN_STEPS,
                       log_every=TRAIN_STEPS, eval_step=recorded_eval,
                       val_batches=val_batches, checkpoint_every=TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"normalize": normalize_u8.launches,
                "augment_normalize": augment_normalize_u8.launches,
                "attention_fwd": fused_short_attention.launches,
                "attention_bwd": attention_backward.launches}
    routes = {"attention_fwd_tc": fused_short_attention.tc_launches,
              "attention_fwd_tf32x3": fused_short_attention.tf32x3_launches,
              "attention_fwd_tf32x3_tiled":
                  fused_short_attention.tf32x3_tiled_launches,
              "attention_bwd_tc": attention_backward.tc_launches}
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    hook.remove()
    for i, rec in enumerate(steps):
        log(f"uint8 step {i + 1}: {json.dumps(rec)}")
    log(f"uint8 eval sweep: {json.dumps(evals)}")
    log(f"uint8 training path: {TRAIN_STEPS} steps + eval in {wall} s; "
        f"launches {launches}, on the tensor-core route {routes}")
    # Training: K3's fused pass, one a step; the eval sweep: the
    # standalone K3 (no draws).
    expected = {"normalize": len(val_batches),
                "augment_normalize": TRAIN_STEPS,
                "attention_fwd": n_layers * (TRAIN_STEPS + len(val_batches)),
                "attention_bwd": n_layers * TRAIN_STEPS}
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    check_routes(cfg, seq, dict(launches, **routes))
    if state.step != TRAIN_STEPS or len(evals) != 1 or not all(
            math.isfinite(v) for v in evals[0].values()):
        raise AssertionError(f"step {state.step}, evals {evals}")
    unmoved = [n for n, b in state.model.named_buffers()
               if torch.equal(b, stats_before[n])]
    if unmoved:
        raise AssertionError(f"BatchNorm statistics that did not move: {unmoved}")
    # Step 1's images as the model received them, against a normalize-only
    # pass of the same batch: they differ exactly where step 1's draws
    # flipped or jittered.
    plain = normalize_u8(first_batch["image"])
    differ = (seen["image"] != plain).flatten(1).any(1)
    draws = AugDraws.sample(StepRNG(cfg.RANDOM_SEED, 0, "cuda"), BATCH)
    acted = draws.flip | draws.apply
    log(f"step 1: {int(differ.sum())} of {BATCH} images changed by flip or "
        f"jitter ({int(draws.flip.sum())} flips, {int(draws.apply.sum())} "
        "jittered)")
    if not torch.equal(differ, acted) or not 0 < int(differ.sum()) < BATCH:
        raise AssertionError("the augmentation did not act as its draws say")
    times = [rec["seconds"] for rec in steps[2:]]
    median = statistics.median(times)
    enqueue = statistics.median(rec["enqueue_seconds"] for rec in steps[2:])
    log(f"uint8 training throughput at batch {BATCH}: median step {median} s "
        f"over steps 3-{TRAIN_STEPS} ({times}), {BATCH / median} pairs/s, "
        f"median host enqueue {enqueue} s "
        f"(float32 path, phase 6: median step {float_step['step_s']} s, "
        f"{float_step['pairs_per_s']} pairs/s, median host enqueue "
        f"{float_step['enqueue_s']} s); peak memory {peak_mb} MiB with the "
        f"cache's {cache.memory_bytes() / 2 ** 20} MiB")
    del state, cache, val_batches, seen, first_batch
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, step_s=median, pairs_per_s=BATCH / median,
                enqueue_s=enqueue, peak_mib=peak_mb,
                attention_s20=attention_times_at(seq))

SSL_CORPUS = 8192  # tiles of the visual SSL phase's cache (1.6 GB)
SSL = ["DATA.DEVICE_CACHE", True, "MODEL.VISUAL.SELF_SUPERVISED", True]


def phase_ssl(float_step: dict, flagship_trace: dict) -> dict:
    """Visual SSL at full width and depth: configs/fs_tpu_tuned.yaml +
    DATA.DEVICE_CACHE + MODEL.VISUAL.SELF_SUPERVISED, a synthetic corpus
    of SSL_CORPUS tiles with the cache's ssl_aug view, TRAIN_STEPS steps of
    128 through the loop (counts set to 0 just before and read just
    after: K3's fused pass twice a step, for the image and its view), then
    TRACE_STEPS more steps traced, beside phase 6's trace.  Then the SSL
    step (visual and textual on) through the kernels, same state and
    batch, dropout 0, at PARITY_BATCH, in fp32 and bf16: K3's fused pass
    against its composition on the step's own images and draws within
    FUSED_ATOL, and the step against one through the plain attention fed
    the same images at phase 7's bars; K1/K2 24 launches a step."""
    import shutil
    import tempfile

    import clip_lite_torch.ops.image_ops as image_ops
    from clip_lite_torch.config import Config
    from clip_lite_torch.data.device_cache import DeviceDataCache
    from clip_lite_torch.engine import (
        create_train_state, make_train_step, metrics_to_floats)
    from clip_lite_torch.train import train_loop
    from clip_lite_torch.utils.trace import capture_trace

    gc.collect()
    torch.cuda.empty_cache()
    cfg = Config(str(TUNED), SSL)
    corpus = synthetic_corpus(cfg, np.random.default_rng(6), n=SSL_CORPUS)
    cache = DeviceDataCache(corpus, BATCH, cache_size=cfg.DATA.CACHE_IMAGE_SIZE,
                            crop_size=cfg.DATA.IMAGE_CROP_SIZE,
                            seq_buckets=cfg.DATA.SEQ_BUCKETS,
                            seed=cfg.RANDOM_SEED, ssl_aug=True, device="cuda")
    del corpus
    state = create_train_state(cfg, device="cuda")
    if state.model.loss.visual_d is None or state.model.loss.textual_d:
        raise AssertionError("fs_tpu_tuned + visual SSL: no visual critic")
    n_layers = cfg.MODEL.TEXTUAL.NUM_HIDDEN_LAYERS
    crop = cfg.DATA.IMAGE_CROP_SIZE
    stats_before = {n: b.clone() for n, b in state.model.named_buffers()}
    train_step = make_train_step(cfg)
    steps = []

    def checked_step(st, batch):
        shapes = {k: (batch[k].dtype, tuple(batch[k].shape))
                  for k in ("image", "aug_image")}
        if set(shapes.values()) != {(torch.uint8, (BATCH, crop, crop, 3))}:
            raise AssertionError(f"cache batch: {shapes}")
        torch.cuda.synchronize()
        start = time.perf_counter()
        st, metrics = train_step(st, batch)
        enqueued = time.perf_counter() - start
        values = metrics_to_floats(metrics)
        steps.append(dict(seconds=time.perf_counter() - start,
                          enqueue_seconds=enqueued, **values))
        if not (math.isfinite(values["total_loss"])
                and math.isfinite(values["grad_norm"])
                and values["visual_loss"] > 0.0
                and values["textual_loss"] == 0.0):
            raise AssertionError(f"step {st.step}: {values}")
        return st, metrics

    counters = kernel_counters()
    cache.set_start(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    state = train_loop(state, checked_step, iter(cache), TRAIN_STEPS,
                       log_every=TRAIN_STEPS, checkpoint_every=10 ** 9)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    for i, rec in enumerate(steps):
        log(f"ssl step {i + 1}: {json.dumps(rec)}")
    expected = dict(dict.fromkeys(counters, 0), **{
        "K1 attention_fwd": n_layers * TRAIN_STEPS,
        "K2 attention_bwd": n_layers * TRAIN_STEPS,
        "K3 augment_normalize_u8": 2 * TRAIN_STEPS})
    log(f"ssl (visual, device cache): launches {launches}: K3's fused pass "
        f"{launches['K3 augment_normalize_u8'] / TRAIN_STEPS:g} a step")
    if launches != expected:
        raise AssertionError(f"ssl launches {launches}, expected {expected}")
    unmoved = [n for n, b in state.model.named_buffers()
               if torch.equal(b, stats_before[n])]
    if unmoved:
        raise AssertionError(f"BatchNorm statistics that did not move: {unmoved}")
    times = [rec["seconds"] for rec in steps[2:]]
    median = statistics.median(times)
    enqueue = statistics.median(rec["enqueue_seconds"] for rec in steps[2:])
    log(f"ssl (visual, device cache) at batch {BATCH}: median step {median} s "
        f"over steps 3-{TRAIN_STEPS}, {BATCH / median} pairs/s, median host "
        f"enqueue {enqueue} s, peak memory {peak_mb} MiB (the cache's "
        f"{cache.memory_bytes() / 2 ** 20} MiB); phase 6's step "
        f"{float_step['step_s']} s")
    out = dict(launches=launches, step_s=median, pairs_per_s=BATCH / median,
               enqueue_s=enqueue, peak_mib=peak_mb)

    # TRACE_STEPS more steps under the profiler, after one in its warm-up
    # and, once it records, a wait of TRACE_SETTLE_S.
    batches = iter(cache)

    def run(n=TRACE_STEPS):
        nonlocal state
        for _ in range(n):
            state, metrics = train_step(state, next(batches))
            metrics_to_floats(metrics)

    def warm_up():
        run(1)
        for c in counters.values():
            c.launches = 0

    def settled_run():
        time.sleep(TRACE_SETTLE_S)
        run()

    outdir = tempfile.mkdtemp(prefix="chip_smoke_ssl_trace_")
    try:
        path = capture_trace(settled_run, outdir, "cuda", warm_up)
        traced = analyze_trace("ssl", path, {k: c.launches for k, c in
                                             counters.items()}, TRACE_STEPS)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)

    def med(t, k):
        return statistics.median(s[k] for s in t["split"])

    log("ssl trace beside phase 6's, a step: " + json.dumps({
        k: {"ssl": med(traced, k), "phase 6": med(flagship_trace, k)}
        for k in ("enqueue_ms", "busy_ms", "window_ms", "idle_share")}) +
        "; by component (ms): " + json.dumps({
            k: {"ssl": traced["summary"]["by_component"].get(k, {}).get("ms"),
                "phase 6": flagship_trace["summary"]["by_component"].get(
                    k, {}).get("ms")}
            for k in ("resnet", "bert", "loss", "optimizer", "input")}))
    out["trace"] = {k: med(traced, k) for k in ("enqueue_ms", "busy_ms",
                                                "window_ms", "idle_share")}
    del state, cache, batches
    gc.collect()
    torch.cuda.empty_cache()

    # Kernels against twins: one SSL step each, visual and textual on.
    cfg32 = Config(str(TUNED), SSL + ["MODEL.TEXTUAL.SELF_SUPERVISED", True])
    corpus = synthetic_corpus(cfg32, np.random.default_rng(7), n=2 * BATCH)
    cache = DeviceDataCache(corpus, PARITY_BATCH, cache_size=CACHE_SIZE,
                            crop_size=crop, seq_buckets=cfg32.DATA.SEQ_BUCKETS,
                            seed=1, ssl_aug=True, device="cuda")
    batch = cache.batch_at(0)
    other = cache.batch_at(1)  # the second captions
    batch.update(aug_input_ids=other["input_ids"],
                 aug_attention_mask=other["attention_mask"])
    del corpus, cache
    real_augment = image_ops.augment_normalize_u8
    runs, state_dict, k3_err = {}, None, {}
    # Two steps a compute type: "kernels" (K1, K2, K3's fused pass, whose
    # images are held against its composition on the same draws), and
    # "twins" (the plain attention, given those images).  A step through
    # the composition's images too moves ResNet-50's grad norm past the
    # bars from images in their last bits apart (PERF.md, section 6).
    try:
        for kind in ("float32", "bfloat16"):
            made = []

            def recorded(images, draws, flip=True, color_jitter=True):
                made.append(real_augment(images, draws, flip, color_jitter))
                twin = image_ops.augment_reference(images, draws, flip,
                                                   color_jitter)
                k3_err[kind, len(made)] = float(
                    (made[-1] - twin).abs().max())
                return made[-1]

            def replayed(images, draws, flip=True, color_jitter=True):
                return made.pop(0)

            for mode, augment in (("kernels", recorded), ("twins", replayed)):
                c = Config(str(TUNED), SSL + [
                    "MODEL.TEXTUAL.SELF_SUPERVISED", True,
                    "MODEL.TEXTUAL.DROPOUT", 0.0, "AMP", kind != "float32",
                    "MODEL.TEXTUAL.FUSED_ATTENTION",
                    str(mode == "kernels").lower()])
                st = create_train_state(c, device="cuda", state_dict=state_dict)
                if state_dict is None:
                    state_dict = {k: v.detach().cpu()
                                  for k, v in st.model.state_dict().items()}
                image_ops.augment_normalize_u8 = augment
                for k in counters.values():
                    k.launches = 0
                st, metrics = make_train_step(c)(st, batch)
                got = {k: k_.launches for k, k_ in counters.items()}
                want = dict(dict.fromkeys(counters, 0))
                if mode == "kernels":
                    want.update({"K1 attention_fwd": 2 * n_layers,
                                 "K2 attention_bwd": 2 * n_layers,
                                 "K3 augment_normalize_u8": 2})
                if got != want:
                    raise AssertionError(f"ssl parity {kind} {mode}: "
                                         f"launches {got}, expected {want}")
                layers = st.model.text_encoder.transformer
                grads = [getattr(layers, n).qkv.weight.grad.float().clone()
                         for n in layers.layer_names]
                runs[kind, mode] = (metrics_to_floats(metrics), grads)
                log(f"ssl parity {kind}, {mode} (launches {got}): "
                    f"{runs[kind, mode][0]}")
                del st, layers, grads
                torch.cuda.empty_cache()
    finally:
        image_ops.augment_normalize_u8 = real_augment
    log(f"ssl parity: K3's fused pass against its composition on the step's "
        f"images and draws, max |difference| {k3_err} (bar "
        f"{FUSED_ATOL['own means']})")
    if max(k3_err.values()) > FUSED_ATOL["own means"]:
        raise AssertionError(f"ssl: K3's fused pass off its twin: {k3_err}")
    out["parity"] = {kind: parity(runs[kind, "kernels"], runs[kind, "twins"])
                     for kind in ("float32", "bfloat16")}
    out["k3_max_abs"] = max(k3_err.values())
    for kind, got in out["parity"].items():
        log(f"ssl parity {kind}, K1/K2 against the plain attention in the SSL "
            f"step: {got} (tol {PARITY_TOL[kind]})")
        if not within(got, PARITY_TOL[kind]):
            raise AssertionError(f"ssl {kind}: step parity fails: {got}")
    log(f"ssl: K1 and K2 {2 * n_layers} launches a step with textual SSL, K3's "
        "fused pass 2 with visual SSL")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def write_coco_corpus(root: str, rng: np.random.Generator) -> None:
    """CLRec train and val files of ndarray records at COCO's shapes (480 x
    640 and 640 x 480 in turn), seeded uint8 images, five captions each
    drawn from WORDS; written with the port's ClRecWriter."""
    import os

    from clip_lite_torch.data.readers import ClRecWriter

    for split, n in (("train", DATA_TRAIN), ("val", DATA_VAL)):
        with ClRecWriter(os.path.join(
                root, f"coco_{split}_train_sbert2017.clrec")) as w:
            for i in range(n):
                shape = (480, 640, 3) if i % 2 == 0 else (640, 480, 3)
                w.append({"image_id": i, "captions": captions(rng, 5),
                          "image": rng.integers(0, 256, shape, dtype=np.uint8)})


LOADER_SPLIT_ITEMS = 64


def loader_split(dataset, n: int = LOADER_SPLIT_ITEMS) -> dict:
    """A host loader's item stage by stage, on the dataset's own first
    ``n`` items, in its order and with its generator, on one thread: the
    record read (and decode), the caption draw, each image transform, the
    caption transform and the tokenizer, the float32 copy; host ms an
    item, and the whole ``dataset[i]`` beside their sum."""
    spent = {}

    def timed(key, fn, *a, **kw):
        t0 = time.perf_counter()
        result = fn(*a, **kw)
        spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
        return result

    for i in range(n):
        rng = dataset._rng(i)
        rec = timed("read", dataset.reader.__getitem__, i)
        caps = rec["captions"]
        caption = caps[int(rng.integers(len(caps)))]
        sample = {"image": rec["image"], "caption": caption}
        for t in dataset.image_transform.transforms:
            sample = timed(type(t).__name__, t, sample, rng)
        caption = timed("caption_transform", dataset.caption_transform,
                        caption=sample["caption"], rng=rng)["caption"]
        timed("tokenize", dataset._tokenize, caption)
        timed("to_float32", np.asarray, sample["image"], np.float32)
    t0 = time.perf_counter()
    for i in range(n):
        dataset[i]
    whole = (time.perf_counter() - t0) * 1e3 / n
    ms = {k: v * 1e3 / n for k, v in spent.items()}
    return dict(ms_an_item=ms, sum_ms=sum(ms.values()), whole_item_ms=whole,
                items=n)


def phase_data_cli(float_step: dict) -> dict:
    """The training CLI (clip_lite_torch.train.main, as ``python -m
    clip_lite_torch.train`` calls it) over a COCO-shaped CLRec corpus:
    (A) the flagship through the host loader, DATA_STEPS steps of 128, val
    sweeps and checkpoints every DATA_SAVE; (B) fs_tpu_tuned through the
    device cache built from the dataset; (C) A resumed from its first
    checkpoint to the end; then an EncoderBundle from A's last checkpoint.  A and C run under
    deterministic algorithms (CUDNN_DETERMINISTIC, no cuDNN benchmark), so
    C must end where A did, bit for bit."""
    import os
    import shutil
    import tempfile

    import clip_lite_torch.data.device_cache as device_cache
    import clip_lite_torch.train as cli
    from clip_lite_torch.config import Config
    from clip_lite_torch.data.pipeline import infinite_batches
    from clip_lite_torch.data.tokenizers import HashingTokenizer
    from clip_lite_torch.eval_utils import EncoderBundle
    from clip_lite_torch.ops.attention import (
        attention_backward, fused_short_attention)
    from clip_lite_torch.ops.normalize import augment_normalize_u8, normalize_u8

    counters = {"attention_fwd": fused_short_attention,
                "attention_bwd": attention_backward,
                "normalize": normalize_u8,
                "augment_normalize": augment_normalize_u8}
    workers = os.cpu_count() or 1
    root = tempfile.mkdtemp(prefix="chip_smoke_data_")
    real_make_step, real_from_dataset = cli.make_train_step, \
        device_cache.DeviceDataCache.from_dataset.__func__
    real_load_host = device_cache.load_host
    flags = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    logger = logging.getLogger("clip_lite_torch")
    out = {}
    try:
        t0 = time.perf_counter()
        write_coco_corpus(root, np.random.default_rng(21))
        log(f"data: {DATA_TRAIN} train and {DATA_VAL} val records of 480 x 640 "
            f"and 640 x 480 uint8 written in {time.perf_counter() - t0} s")
        sizes = ["MODEL.NAME", "captions", "DATA.ROOT", root,
                 "OPTIM.BATCH_SIZE", BATCH, "OPTIM.NUM_ITERATIONS", DATA_STEPS,
                 "OPTIM.WARMUP_STEPS", DATA_STEPS // 2]
        same_bits = ["CUDNN_DETERMINISTIC", True, "CUDNN_BENCHMARK", False]

        def args(name, config, extra=(), flags=(), every=DATA_SAVE):
            return cli.parser.parse_args([str(a) for a in (
                "--config", config, "--serialization-dir",
                os.path.join(root, name), "--checkpoint-every", every,
                "--log-every", 5, "--cpu-workers", workers, *flags,
                "--config-override", *sizes, *extra)])

        # The loader alone: batches/s with the CLI's loader over the corpus.
        cfg_a = Config(str(FLAGSHIP), sizes)
        loader, _ = cli.init_dataloaders(cfg_a, args("loader", FLAGSHIP),
                                         torch.device("cuda"))
        stream = infinite_batches(loader)
        first = next(stream)
        t0 = time.perf_counter()
        for _ in range(DATA_LOADER_BATCHES):
            next(stream)
        loader_s = (time.perf_counter() - t0) / DATA_LOADER_BATCHES
        stream.close()
        log(f"data: the host loader alone, {workers} workers: "
            f"{1 / loader_s} batches/s of {BATCH} ({loader_s} s a batch over "
            f"{DATA_LOADER_BATCHES}); image {first['image'].dtype} "
            f"{tuple(first['image'].shape)} pinned "
            f"{first['image'].is_pinned()}, ids "
            f"{tuple(first['input_ids'].shape)}")
        if not (first["image"].is_pinned() and tuple(first["image"].shape) == (
                BATCH, 224, 224, 3)):
            raise AssertionError("the loader's batches are not pinned crops")
        split = loader_split(loader.dataset)
        log(f"data: the host loader's item by stage, host ms an item over "
            f"{split['items']} of its items on one thread: "
            f"{json.dumps(split['ms_an_item'])}; their sum {split['sum_ms']} "
            f"ms, a whole item {split['whole_item_ms']} ms; {workers} workers "
            f"at {loader_s} s a batch of {BATCH} is "
            f"{loader_s * 1e3 * workers / BATCH} worker-ms an item")
        out["loader_split"] = split
        del loader, stream, first

        def run(name, a, keep_batches=()):
            """main(a) with the launch counts set to 0 just before and read
            just after; every step's entry time, and the batches of the
            steps in ``keep_batches``."""
            record = {"t": [], "batches": {}}

            def make_step(cfg):
                step = real_make_step(cfg)

                def recorded(state, batch):
                    it = state.step + 1
                    record["t"].append(time.perf_counter())
                    if it in keep_batches:  # host batches: no sync
                        record["batches"][it] = batch
                    return step(state, batch)
                return recorded

            cli.make_train_step = make_step
            for k in counters.values():
                k.launches = 0
            fused_short_attention.tc_launches = 0
            fused_short_attention.tf32x3_launches = 0
            fused_short_attention.tf32x3_tiled_launches = 0
            attention_backward.tc_launches = 0
            t0 = time.perf_counter()
            state = cli.main(a)
            torch.cuda.synchronize()
            record["wall"] = time.perf_counter() - t0
            record["launches"] = {n: k.launches for n, k in counters.items()}
            record["launches"].update(
                attention_fwd_tc=fused_short_attention.tc_launches,
                attention_fwd_tf32x3=fused_short_attention.tf32x3_launches,
                attention_fwd_tf32x3_tiled=fused_short_attention.tf32x3_tiled_launches,
                attention_bwd_tc=attention_backward.tc_launches)
            cli.make_train_step = real_make_step
            metrics = [json.loads(line) for line in open(os.path.join(
                root, name, "metrics.jsonl"))]
            record["metrics"] = metrics
            log(f"data ({name}): to step {state.step}, with sweeps and "
                f"checkpoints, in {record['wall']} s; launches "
                f"{record['launches']}; "
                f"metrics {json.dumps(metrics)}")
            if not metrics or not all(math.isfinite(m["total_loss"])
                                      for m in metrics):
                raise AssertionError(f"({name}) loss not finite: {metrics}")
            return state, record

        def expect(name, cfg, record, steps, **want):
            n_layers = cfg.MODEL.TEXTUAL.NUM_HIDDEN_LAYERS
            sweeps = len([m for m in record["metrics"] if m["split"] == "val"])
            expected = dict(dict.fromkeys(counters, 0), attention_fwd=n_layers * (
                steps + sweeps * (DATA_VAL // BATCH)),
                attention_bwd=n_layers * steps)
            expected.update(want)
            got = {k: record["launches"][k] for k in counters}
            if got != expected:
                raise AssertionError(f"({name}) launches {got}, expected "
                                     f"{expected}")
            check_routes(cfg, cfg.DATA.MAX_CAPTION_LENGTH, record["launches"])

        def step_times(record):
            """Steps 3 to DATA_SAVE - 1 (before the first sweep), each from its start to
            the next step's: the step, its share of the loop, and the wait
            for the next batch.  Steps 1-2 are left out, as phase 6 leaves
            them out (and the loader's prefetch fills while the state is
            built)."""
            t = record["t"]
            return [b - a for a, b in zip(t[2:DATA_SAVE - 1], t[3:DATA_SAVE])]

        torch.use_deterministic_algorithms(True, warn_only=True)
        # (A) The host loader.
        a_args = args("a", FLAGSHIP, same_bits)
        resumed = range(DATA_SAVE + 1, DATA_STEPS + 1)  # (C)'s steps
        state_a, rec_a = run("a", a_args, keep_batches=resumed)
        expect("a", cfg_a, rec_a, DATA_STEPS)
        ckpt_a = a_args.serialization_dir + cfg_a.RUN_ID
        files = sorted(os.listdir(ckpt_a))
        if not {f"checkpoint_{DATA_SAVE}.msgpack",
                f"checkpoint_{DATA_STEPS}.msgpack"} <= set(files):
            raise AssertionError(f"(a) wrote {files}")
        times_a = step_times(rec_a)
        step_a = statistics.median(times_a)
        log(f"data (a): checkpoints {files}; the CLI through the host loader "
            f"at batch {BATCH}: median step {step_a} s over steps "
            f"3-{DATA_SAVE - 1} "
            f"({times_a}), {1 / step_a} steps/s; "
            f"{DATA_STEPS / rec_a['wall']} steps/s over the whole run with "
            f"sweeps and checkpoints; the loader alone {1 / loader_s} "
            f"batches/s; phase 6's step on fixed batches "
            f"{float_step['step_s']} s ({1 / float_step['step_s']} steps/s)")
        out["a"] = dict(launches=rec_a["launches"], step_s=step_a,
                        loader_batches_per_s=1 / loader_s,
                        wall_s=rec_a["wall"])
        final_a = state_tensors(state_a)
        live_sd = {k: v.detach().clone()
                   for k, v in state_a.model.state_dict().items()}
        del state_a
        gc.collect()

        # (C) A resumed from its first checkpoint, to the end, at two steps
        # a call.
        c_args = args("c", FLAGSHIP, same_bits + ["PARALLEL.STEPS_PER_CALL", 2],
                      ["--resume-from", os.path.join(
                          ckpt_a, f"checkpoint_{DATA_SAVE}.msgpack")])
        state_c, rec_c = run("c", c_args, keep_batches=resumed)
        expect("c", cfg_a, rec_c, DATA_STEPS - DATA_SAVE)
        same = sorted(rec_c["batches"]) == list(resumed) and all(
            torch.equal(rec_a["batches"][i][k], rec_c["batches"][i][k])
            for i in resumed
            for k in ("image_id", "input_ids", "attention_mask", "image"))
        d_ac = distance(final_a, state_tensors(state_c))
        log(f"data (c): resumed at {DATA_SAVE}, PARALLEL.STEPS_PER_CALL 2: "
            f"batches of steps {DATA_SAVE + 1}-{DATA_STEPS} equal "
            f"(A's) {same}; the final state at max |difference| {d_ac} from A's")
        if not same or d_ac != 0.0:
            raise AssertionError("the resumed CLI run left run A's stream or "
                                 "state")
        out["c"] = dict(launches=rec_c["launches"], distance=d_ac)
        del state_c, rec_a, rec_c, final_a
        gc.collect()
        torch.use_deterministic_algorithms(flags[0], warn_only=flags[1])

        # An EncoderBundle from A's last checkpoint against A's live weights.
        n_layers = cfg_a.MODEL.TEXTUAL.NUM_HIDDEN_LAYERS
        rng = np.random.default_rng(22)
        images = rng.standard_normal((BATCH, 224, 224, 3), dtype=np.float32)
        texts = captions(rng, BATCH)
        tok = HashingTokenizer(cfg_a.MODEL.TEXTUAL.VOCAB_SIZE,
                               cfg_a.DATA.MAX_CAPTION_LENGTH)
        encoded = []
        for kw in (dict(checkpoint_path=os.path.join(
                       ckpt_a, f"checkpoint_{DATA_STEPS}.msgpack")),
                   dict(state_dict=live_sd)):
            bundle = EncoderBundle(cfg_a, batch_size=BATCH, device="cuda", **kw)
            fused_short_attention.launches = 0
            encoded.append((bundle.encode_images(images),
                            bundle.encode_texts(texts, tok)))
            if fused_short_attention.launches != n_layers:
                raise AssertionError("the bundle's text encode launched K1 "
                                     f"{fused_short_attention.launches} times")
            del bundle
        out["bundle_launches"] = 2 * n_layers
        if not all(np.isfinite(x).all() and np.array_equal(x, y)
                   for x, y in zip(*encoded)):
            raise AssertionError("the bundle from the CLI's checkpoint encodes "
                                 "otherwise than the run's live weights")
        log(f"data: EncoderBundle from (a)'s checkpoint_{DATA_STEPS}: embeddings "
            f"{encoded[0][0].shape} {encoded[0][1].shape}, equal to the live "
            "weights'")
        del live_sd, encoded
        gc.collect()
        torch.cuda.empty_cache()

        # (B) The device cache built from the dataset.
        built = {}

        def from_dataset(klass, *a, **kw):
            built["cache"] = real_from_dataset(klass, *a, **kw)
            return built["cache"]

        def load_host(*a, **kw):
            built["load_host"] = built.get("load_host", 0) + 1
            return real_load_host(*a, **kw)

        device_cache.DeviceDataCache.from_dataset = classmethod(from_dataset)
        device_cache.load_host = load_host
        # These records hold ndarray images: the Python path (phase 10d
        # runs fs_tpu_tuned's native path over JPEG records).
        b_extra = ["DATA.DEVICE_CACHE", True, "DATA.NATIVE_PIPELINE", False]
        cfg_b = Config(str(TUNED), sizes + b_extra)
        state_b, rec_b = run("b", args("b", TUNED, b_extra))
        cache = built["cache"]
        expect("b", cfg_b, rec_b, DATA_STEPS, augment_normalize=DATA_STEPS)
        tiles = tuple(cache._images.shape)
        if built.get("load_host") != 1 or tiles != (
                DATA_TRAIN, cfg_b.DATA.CACHE_IMAGE_SIZE,
                cfg_b.DATA.CACHE_IMAGE_SIZE, 3):
            raise AssertionError(f"(b) cache of {tiles} tiles, load_host "
                                 f"called {built.get('load_host')} times")
        times_b = step_times(rec_b)
        step_b = statistics.median(times_b)
        log(f"data (b): the device cache built through load_host in "
            f"{cache.build_seconds} s: {tiles} uint8 tiles, "
            f"{cache.memory_bytes()} bytes; the CLI through the cache at batch "
            f"{BATCH}: median step {step_b} s over steps "
            f"3-{DATA_SAVE - 1} ({times_b}), "
            f"{1 / step_b} steps/s; {DATA_STEPS / rec_b['wall']} steps/s over "
            f"the whole run with the cache's build, sweeps and checkpoints")
        out["b"] = dict(launches=rec_b["launches"], step_s=step_b,
                        build_s=cache.build_seconds,
                        cache_bytes=cache.memory_bytes())
        del state_b, rec_b, cache, built
        device_cache.DeviceDataCache.from_dataset = classmethod(real_from_dataset)
        device_cache.load_host = real_load_host
        gc.collect()
        torch.cuda.empty_cache()

        # (D) Textual SSL through the host loader: the flagship with
        # MODEL.TEXTUAL.SELF_SUPERVISED, every item with a second caption
        # of its image, through BERT's 12 layers a second time.
        d_extra = ["MODEL.TEXTUAL.SELF_SUPERVISED", True,
                   "OPTIM.NUM_ITERATIONS", SSL_CLI_STEPS,
                   "OPTIM.WARMUP_STEPS", SSL_CLI_STEPS // 2]
        cfg_d = Config(str(FLAGSHIP), sizes + d_extra)
        torch.cuda.reset_peak_memory_stats()
        state_d, rec_d = run("d", args("d", FLAGSHIP, d_extra, every=10 ** 6))
        peak_d = torch.cuda.max_memory_allocated() / 2 ** 20
        n_layers = cfg_d.MODEL.TEXTUAL.NUM_HIDDEN_LAYERS
        expect("d", cfg_d, rec_d, SSL_CLI_STEPS,
               attention_fwd=2 * n_layers * SSL_CLI_STEPS,
               attention_bwd=2 * n_layers * SSL_CLI_STEPS)
        train_rows = [m for m in rec_d["metrics"] if m["split"] == "train"]
        if not train_rows or not all(m["textual_loss"] > 0 for m in train_rows):
            raise AssertionError(f"(d) textual SSL loss: {train_rows}")
        t = rec_d["t"]
        times_d = [b - a for a, b in zip(t[2:], t[3:])]
        step_d = statistics.median(times_d)
        log(f"data (d): textual SSL through the host loader at batch {BATCH}: "
            f"median step {step_d} s over steps 3-{SSL_CLI_STEPS} ({times_d}),"
            f" {BATCH / step_d} pairs/s; K1 and K2 "
            f"{rec_d['launches']['attention_fwd'] // SSL_CLI_STEPS} and "
            f"{rec_d['launches']['attention_bwd'] // SSL_CLI_STEPS} a step; "
            f"peak memory {peak_d} MiB; (a)'s step {step_a} s")
        out["d"] = dict(launches=rec_d["launches"], step_s=step_d,
                        pairs_per_s=BATCH / step_d, peak_mib=peak_d)
        del state_d, rec_d
    finally:
        cli.make_train_step = real_make_step
        device_cache.DeviceDataCache.from_dataset = classmethod(real_from_dataset)
        device_cache.load_host = real_load_host
        torch.use_deterministic_algorithms(flags[0], warn_only=flags[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags[2:]
        for handler in logger.handlers:  # the CLI's, into the directory
            handler.close()
        logger.handlers.clear()
        logger.propagate = True
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# The eval phase: synthetic JPEG trees at COCO's 480 x 640, and the CLIs'
# sizes.
VOC_CLASSES = ("aeroplane bicycle bird boat bottle bus car cat chair cow "
               "diningtable dog horse motorbike person pottedplant sheep sofa "
               "train tvmonitor").split()
EVAL_COCO, EVAL_VOC, EVAL_GENDER = 256, 256, 128
EVAL_IMAGENET = (10, 32, 16)  # classes, train and val images a class
PROBE_STEPS, FINETUNE_STEPS, PROBE_BATCH = 10, 5, 64
# The SVM on the card against the same solver on the CPU (both float64, both
# at their optimum to a gradient 1e-10 of its start): decision values.
SVM_REL_TOL = 1e-6
# VOC07 at its real size: 5,011 trainval images of the flagship's 2,048-d
# pooled features, so each 3-fold fit trains on 3,340 of them; positive
# shares across VOC's range of classes, and costs of the CLI's sweep.
VOC07_SVM = dict(n=5011, d=2048, shares=(0.03, 0.1, 0.4),
                 costs=(0.1, 1.0, 10.0))


def svm_card_vs_cpu(svm, fit, x_train: np.ndarray, labels: np.ndarray,
                    x_test: np.ndarray, cost: float) -> dict:
    """One SVM of the VOC07 eval's class weights fitted on the card and on
    the CPU, float64: its Newton steps, seconds, gradient norms and
    convergence on each, and the largest difference of their decision
    values on ``x_test``, relative to the CPU's largest."""
    from clip_lite_torch.voc_clf import CLASS_WEIGHT

    out = {"steps": {}, "seconds": {}, "grad_norm": {}, "converged": True}
    scores = {}
    for device in ("cuda", "cpu"):
        x = torch.as_tensor(x_train, dtype=torch.float64, device=device)
        t0 = time.perf_counter()
        clf = fit(svm.LinearSVC(cost, CLASS_WEIGHT), x, labels)
        scores[device] = clf.decision_function(torch.as_tensor(
            x_test, dtype=torch.float64, device=device)).cpu().numpy()
        out["seconds"][device] = time.perf_counter() - t0
        out["steps"][device] = clf.n_iter_
        out["grad_norm"][device] = clf.grad_norm_
        out["converged"] &= clf.converged_
    out["rel"] = float(np.abs(scores["cuda"] - scores["cpu"]).max()
                       / np.abs(scores["cpu"]).max())
    return out


def write_jpeg_trees(root: str, rng: np.random.Generator) -> dict:
    """The downstream datasets' layouts under ``root``, every image a
    480 x 640 or 640 x 480 JPEG (quality 90, PIL) of seeded smooth
    patterns: COCO retrieval (EVAL_COCO images, five captions each),
    ImageNet (EVAL_IMAGENET), VOC07 (20 classes, EVAL_VOC trainval and
    EVAL_VOC test images, labels absent, difficult or present) and the
    gender-labelled COCO subset (EVAL_GENDER images with person boxes).
    Returns each dataset's root."""
    import os
    import pickle
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    yy, xx = np.mgrid[0:480, 0:640].astype(np.float32)
    bases = []
    for _ in range(8):
        f, p = rng.uniform(0.005, 0.05, 6), rng.uniform(0, 6, 3)
        img = np.stack([np.sin(xx * f[c] + p[c]) * np.cos(yy * f[3 + c])
                        for c in range(3)], axis=-1)
        bases.append(((img + 1) * 127.5).astype(np.uint8))
    jobs = []

    def add(path):
        jobs.append((path, int(rng.integers(8)), int(rng.integers(480)),
                     int(rng.integers(640)), bool(rng.integers(2))))

    def save(job):
        path, base, dy, dx, portrait = job
        arr = np.roll(bases[base], (dy, dx), axis=(0, 1))
        if portrait:
            arr = arr.transpose(1, 0, 2)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(np.ascontiguousarray(arr)).save(path, "JPEG",
                                                        quality=90)

    def dump_json(path, obj):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(obj, f)

    trees = {k: os.path.join(root, k) for k in ("coco", "imagenet", "VOC2007",
                                                "coco_gender")}
    anns = []
    for i in range(EVAL_COCO):
        add(os.path.join(trees["coco"], "val2017", f"{i + 1:012d}.jpg"))
        anns += [{"image_id": i + 1, "caption": c} for c in captions(rng, 5)]
    dump_json(os.path.join(trees["coco"], "annotations",
                           "captions_val2017.json"), {"annotations": anns})
    n_classes, n_train, n_val = EVAL_IMAGENET
    for c in range(n_classes):
        for split, n in (("train", n_train), ("val", n_val)):
            for i in range(n):
                add(os.path.join(trees["imagenet"], split, f"n{c:08d}",
                                 f"n{c:08d}_{i}.JPEG"))
    voc = trees["VOC2007"]
    for split, start in (("trainval", 0), ("test", EVAL_VOC)):
        names = [f"{start + i:06d}" for i in range(EVAL_VOC)]
        for name in names:
            add(os.path.join(voc, "JPEGImages", f"{name}.jpg"))
        for cls in VOC_CLASSES:
            labels = rng.choice([-1, 0, 1], EVAL_VOC, p=[0.6, 0.1, 0.3])
            labels[:2] = (1, -1)
            path = os.path.join(voc, "ImageSets", "Main", f"{cls}_{split}.txt")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                f.writelines(f"{n} {lab:2d}\n" for n, lab in zip(names, labels))
    gender = []
    for i in range(EVAL_GENDER):
        name = f"val2014/COCO_val2014_{i:012d}.jpg"
        add(os.path.join(trees["coco_gender"], name))
        x0, y0 = (int(v) for v in rng.integers(0, 300, 2))
        gender.append({"image_id": 5000 + i, "filename": name,
                       "gender": "man" if i % 2 else "woman",
                       "boxes": [[x0, y0, x0 + int(rng.integers(5, 200)),
                                  y0 + int(rng.integers(5, 200))]]})
    path = os.path.join(trees["coco_gender"], "gender_annotations", "val.pkl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(gender, f)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        list(pool.map(save, jobs))
    trees["n_images"] = len(jobs)
    return trees


def phase_eval_cli() -> dict:
    """The downstream eval CLIs (each ``main`` as ``python -m
    clip_lite_torch.<cli>`` calls it) on the card, over synthetic JPEG trees,
    from the flagship's seeded weights written as the JAX package's
    model-only checkpoint: retrieval, zero-shot, the linear probe
    (``--frozen``) and a fine-tune, the VOC07 SVMs, the bias analysis's
    ``--prompt`` and the Detectron2 export.  Each run with K1's count set
    to 0 just before and read just after."""
    import os
    import pickle
    import shutil
    import tempfile

    import clip_lite_torch.bias_eda as bias_eda
    import clip_lite_torch.linear_clf as linear_clf
    import clip_lite_torch.retrieval as retrieval
    import clip_lite_torch.voc_clf as voc_clf
    import clip_lite_torch.voc_det as voc_det
    import clip_lite_torch.zero_shot as zero_shot
    from clip_lite_torch import bridge
    from clip_lite_torch.config import Config
    from clip_lite_torch.data.pipeline import DataLoader
    from clip_lite_torch.data.readers import read_image
    from clip_lite_torch.eval_utils import EncoderBundle
    from clip_lite_torch.factories import (
        DownstreamDatasetFactory, TokenizerFactory)
    from clip_lite_torch.ops.attention import fused_short_attention
    from clip_lite_torch.utils import msgpack_io, svm
    from clip_lite_torch.utils.checkpointing import load_model_variables

    cfg = Config(str(FLAGSHIP))
    n_layers = cfg.MODEL.TEXTUAL.NUM_HIDDEN_LAYERS
    workers = os.cpu_count() or 1
    root = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    logger = logging.getLogger("clip_lite_torch")
    real_encode_texts = EncoderBundle.encode_texts
    real_fit = svm.LinearSVC.fit
    real_extract = voc_clf.extract_features
    real_make_step = linear_clf.make_train_step
    phase_t0 = time.perf_counter()
    out = {"launches": {}, "seconds": {}}
    try:
        t0 = time.perf_counter()
        seeded = EncoderBundle(cfg, batch_size=BATCH, device="cuda")
        ckpt = os.path.join(root, "climax_model_1.msgpack")
        n_bytes = msgpack_io.write(ckpt, bridge.to_jax_variables(
            seeded.model.state_dict(), seeded.model))
        stem = bridge.to_numpy(seeded.model.image_encoder.backbone.stem.conv.weight)
        del seeded
        trees = write_jpeg_trees(root, np.random.default_rng(31))
        log(f"eval: the seeded flagship written as the JAX package's model-only "
            f"checkpoint ({n_bytes} bytes) and {trees['n_images']} JPEGs of 480 "
            f"x 640 written in {time.perf_counter() - t0} s")

        # The host side of an eval: decode alone, decode + transforms, one
        # thread, then the loader over the COCO tree.
        dataset = DownstreamDatasetFactory.from_config(
            Config(None, ["DATA.ROOT", trees["coco"]]), split="val")
        n = min(64, len(dataset))
        t0 = time.perf_counter()
        for path in dataset.image[:n]:
            read_image(path)
        decode_s = (time.perf_counter() - t0) / n
        t0 = time.perf_counter()
        for i in range(n):
            dataset[i]
        item_s = (time.perf_counter() - t0) / n
        loader = DataLoader(dataset, BATCH, shuffle=False, drop_last=False,
                            num_workers=workers, background=False)
        t0 = time.perf_counter()
        n_loaded = sum(len(b["image"]) for b in loader)
        loader_ips = n_loaded / (time.perf_counter() - t0)
        out.update(decode_ips=1 / decode_s, item_ips=1 / item_s,
                   loader_ips=loader_ips, decode_share=decode_s / item_s)
        log(f"eval: one thread decodes {1 / decode_s} images/s (480 x 640 JPEG, "
            f"PIL) and decodes + transforms (smallest edge 224, centre crop, "
            f"normalize) {1 / item_s} images/s: decode {decode_s / item_s} of "
            f"an item; the loader with {workers} threads {loader_ips} images/s "
            f"over {n_loaded}")
        del dataset, loader

        recorded = {"cli": None, "texts": {}, "fits": [], "features": [],
                    "losses": []}

        def encode_texts(self, texts, tokenizer):
            emb = real_encode_texts(self, texts, tokenizer)
            recorded["texts"].setdefault(recorded["cli"], []).append(
                (list(texts), self.batch_size, emb))
            return emb

        def fit(self, x, labels):
            recorded["fits"].append(real_fit(self, x, labels))
            return self

        def extract_features(*a, **kw):
            recorded["features"].append(real_extract(*a, **kw))
            return recorded["features"][-1]

        def make_train_step():
            step = real_make_step()

            def recorded_step(state, batch):
                state, loss = step(state, batch)
                recorded["losses"][-1].append(loss)
                return state, loss
            return recorded_step

        EncoderBundle.encode_texts = encode_texts
        svm.LinearSVC.fit = fit
        voc_clf.extract_features = extract_features
        linear_clf.make_train_step = make_train_step

        def run(name, module, data_root, text_batches, flags=(), overrides=()):
            """``module.main`` on the card with K1's counts set to 0 just
            before and read just after."""
            recorded["cli"] = name
            argv = [str(a) for a in (
                "--serialization-dir", os.path.join(root, "out", name),
                "--cpu-workers", workers, "--pretrain-config", FLAGSHIP,
                *flags, "--config-override", "DATA.ROOT", data_root,
                *overrides)]
            args = module.parser.parse_args(argv)
            fused_short_attention.launches = 0
            fused_short_attention.tc_launches = 0
            fused_short_attention.tf32x3_launches = 0
            fused_short_attention.tf32x3_tiled_launches = 0
            t0 = time.perf_counter()
            result = module.main(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"attention_fwd": fused_short_attention.launches,
                        "attention_fwd_tc": fused_short_attention.tc_launches,
                        "attention_fwd_tf32x3": fused_short_attention.tf32x3_launches,
                        "attention_fwd_tf32x3_tiled":
                            fused_short_attention.tf32x3_tiled_launches}
            out["launches"][name], out["seconds"][name] = \
                launches["attention_fwd"], wall
            log(f"eval ({name}): {json.dumps(result)} in {wall} s; launches "
                f"{launches}")
            if launches["attention_fwd"] != n_layers * text_batches:
                raise AssertionError(f"({name}) K1 launched "
                                     f"{launches['attention_fwd']} times, "
                                     f"expected {n_layers * text_batches}")
            check_routes(cfg, cfg.DATA.MAX_CAPTION_LENGTH, launches)
            return args, result

        def in_range(name, value):
            if not (math.isfinite(value) and 0.0 <= value <= 100.0):
                raise AssertionError(f"({name}) {value} is no percentage")

        ckpt_flag = ("--checkpoint-path", ckpt)
        n_caps = 5 * EVAL_COCO
        _, recalls = run("retrieval", retrieval, trees["coco"],
                         math.ceil(n_caps / BATCH),
                         ckpt_flag + ("--batch-size", BATCH))
        for v in recalls.values():
            in_range("retrieval", v)
        n_classes = EVAL_IMAGENET[0]
        _, top1 = run("zero_shot", zero_shot, trees["imagenet"],
                      math.ceil(n_classes / BATCH),
                      ckpt_flag + ("--batch-size", BATCH))
        in_range("zero_shot", top1)
        # bias_eda: the definitional pairs in one batch of 64, the prompt in
        # another.
        _, bias = run("bias_eda", bias_eda, trees["coco_gender"], 2,
                      ckpt_flag + ("--prompt", "a photo of a doctor"))
        if not all(math.isfinite(v) for v in bias.values()
                   if isinstance(v, float)):
            raise AssertionError(f"(bias_eda) {bias}")
        texts = recorded["texts"]
        shapes = {k: [e.shape for _, _, e in v] for k, v in texts.items()}
        if shapes != {"retrieval": [(n_caps, 2048)],
                      "zero_shot": [(n_classes, 2048)],
                      "bias_eda": [(12, 2048), (1, 2048)]}:
            raise AssertionError(f"text embeddings of shapes {shapes}")
        for name, batches in texts.items():
            for _, _, emb in batches:
                norm_err = float(np.abs(np.linalg.norm(emb, axis=1) - 1).max())
                if not np.isfinite(emb).all() or norm_err > 1e-4:
                    raise AssertionError(f"({name}) text embeddings: finite "
                                         f"{np.isfinite(emb).all()}, norms "
                                         f"off 1 by {norm_err}")

        # Each CLI's text embeddings against the plain attention on the card,
        # same checkpoint, same batch size.
        plain_cfg = Config(str(FLAGSHIP), ["MODEL.TEXTUAL.FUSED_ATTENTION",
                                           "false"])
        tok = TokenizerFactory.from_config(plain_cfg)
        plain = EncoderBundle(plain_cfg, ckpt, device="cuda")
        agree = {}
        for name, batches in texts.items():
            for captions_, batch_size, emb in batches:
                plain.batch_size = batch_size
                got = text_agreement(emb, real_encode_texts(plain, captions_,
                                                            tok))
                agree[name] = {k: (min if k == "min_cos" else max)(
                    v, agree.get(name, got)[k]) for k, v in got.items()}
        del plain
        tol = TEXT_TOL["bfloat16"]
        log(f"eval: text embeddings, K1 vs plain attention, bfloat16: {agree} "
            f"(tol {tol})")
        for name, got in agree.items():
            if got["max_abs"] > tol["max_abs"] or got["min_cos"] < tol["min_cos"]:
                raise AssertionError(f"({name}) text embeddings disagree: {got}")

        # The linear probe and a fine-tune on the ImageNet tree.
        sizes = ["OPTIM.BATCH_SIZE", PROBE_BATCH, "OPTIM.WARMUP_STEPS", 2]
        for name, flags, steps in (("linear_probe", ("--frozen",), PROBE_STEPS),
                                   ("fine_tune", (), FINETUNE_STEPS)):
            recorded["losses"].append([])
            args, top1 = run(name, linear_clf, trees["imagenet"], 0,
                             ckpt_flag + flags + ("--log-every", 5),
                             sizes + ["OPTIM.NUM_ITERATIONS", steps])
            in_range(name, top1)
            losses = [float(v) for v in recorded["losses"][-1]]
            files = sorted(os.listdir(os.path.join(args.serialization_dir,
                                                   "linear_clf")))
            tree = load_model_variables(os.path.join(
                args.serialization_dir, "linear_clf",
                f"checkpoint_{steps}.msgpack"))
            log(f"eval ({name}): {steps} steps of {PROBE_BATCH}, CE {losses}; "
                f"checkpoints {files}, params {sorted(tree['params'])}")
            if len(losses) != steps or not all(map(math.isfinite, losses)) \
                    or "checkpoint_best.msgpack" not in files \
                    or sorted(tree["params"]) != ["backbone", "fc"]:
                raise AssertionError(f"({name}) did not train as expected")

        # The VOC07 SVMs, then the same solver on the card and on the CPU.
        _, maps = run("voc_clf", voc_clf, trees["VOC2007"], 0, ckpt_flag)
        in_range("voc_clf", maps[ckpt])
        fits = recorded["fits"]
        grad = max(f.grad_norm_ for f in fits)
        steps = [f.n_iter_ for f in fits]
        log(f"eval (voc_clf): {len(fits)} SVM fits in float64 on the card, "
            f"Newton steps {min(steps)}-{max(steps)}, largest gradient norm at "
            f"a solution {grad}")
        if not all(f.converged_ for f in fits):
            raise AssertionError("an SVM stopped before its gradient tolerance")
        (tr_f, tr_l), (te_f, _) = recorded["features"][:2]
        if tr_f.shape != (EVAL_VOC, 2048) or te_f.shape != (EVAL_VOC, 2048):
            raise AssertionError(f"VOC features {tr_f.shape} {te_f.shape}")
        keep = tr_l[:, 0] != -1
        got = svm_card_vs_cpu(svm, real_fit, tr_f[keep], tr_l[keep, 0], te_f,
                              1.0)
        rel = got["rel"]
        out["svm"] = dict(fits=len(fits), max_grad_norm=grad, card_vs_cpu=rel)
        log(f"eval (voc_clf): class 0 at cost 1, card against CPU: {got}; "
            f"decision values within {rel} (tol {SVM_REL_TOL})")
        if rel > SVM_REL_TOL or not got["converged"]:
            raise AssertionError(f"the SVM on the card and on the CPU: {got}")

        # The solver alone at VOC07's real fold shape: 3,340 training
        # samples over 2,048 features, seeded unit-norm (non-negative, as
        # pooled ReLU features are) with labels from a noisy linear score.
        rng = np.random.default_rng(37)
        n, d = VOC07_SVM["n"], VOC07_SVM["d"]
        x = np.abs(rng.standard_normal((n, d)))
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        score = (x - x.mean(0)) @ rng.standard_normal(d)
        score /= score.std()
        tr_idx, va_idx = next(svm.kfold(n, 3, seed=0))
        voc07 = []
        for share in VOC07_SVM["shares"]:
            noisy = score + rng.standard_normal(n)
            y = (noisy > np.quantile(noisy, 1 - share)).astype(np.int64)
            for cost in VOC07_SVM["costs"]:
                voc07.append(svm_card_vs_cpu(svm, real_fit, x[tr_idx],
                                             y[tr_idx], x[va_idx], cost))
                log(f"eval (SVM at VOC07's fold shape {len(tr_idx)} x {d}): "
                    f"positives {share}, cost {cost}: {voc07[-1]}")
        steps = [f["steps"]["cuda"] for f in voc07]
        out["svm"]["voc07_shape"] = dict(
            fits=len(voc07), newton_steps=steps,
            card_vs_cpu=max(f["rel"] for f in voc07),
            card_s=sum(f["seconds"]["cuda"] for f in voc07),
            cpu_s=sum(f["seconds"]["cpu"] for f in voc07))
        log(f"eval (SVM at VOC07's fold shape): {out['svm']['voc07_shape']}")
        if not all(f["converged"] for f in voc07) or max(steps) < 2 \
                or out["svm"]["voc07_shape"]["card_vs_cpu"] > SVM_REL_TOL:
            raise AssertionError("the SVM at VOC07's fold shape: every fit "
                                 "converged, some in more than one Newton "
                                 "step, card and CPU within SVM_REL_TOL")

        # The Detectron2 export.
        output = os.path.join(root, "backbone_d2.pkl")
        run("voc_det", voc_det, "unused", 0, ckpt_flag + ("--output", output))
        with open(output, "rb") as f:
            d2 = pickle.load(f)["model"]
        # ResNet-50: the stem, 16 bottlenecks of three cells and 4
        # projections, five tensors a cell.
        if len(d2) != 5 * (1 + 16 * 3 + 4) or not all(
                v.dtype == np.float32 and np.isfinite(v).all()
                for v in d2.values()) or not np.array_equal(
                    d2["stem.conv1.weight"], stem):
            raise AssertionError("the Detectron2 export does not hold the "
                                 "checkpoint's tower")
        out["wall_s"] = time.perf_counter() - phase_t0
        log(f"eval: phase in {out['wall_s']} s; CLI seconds {out['seconds']}")
    finally:
        EncoderBundle.encode_texts = real_encode_texts
        svm.LinearSVC.fit = real_fit
        voc_clf.extract_features = real_extract
        linear_clf.make_train_step = real_make_step
        for handler in logger.handlers:  # the CLIs', into the directory
            handler.close()
        logger.handlers.clear()
        logger.propagate = True
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# The native phase: a COCO-layout tree of JPEGs made into CLRec records by
# the port's coco_preprocess; the decode's bars against the twin per JPEG
# kind; CLI steps a run.
NATIVE_STEPS = 12
# nvJPEG's tiles against the twin's at the same (full) resolution, per
# image: the decoders' IDCT and chroma upsampling differ.
DECODE_BARS = dict(mean_abs=1.0, psnr_db=40.0)
# Against the JAX core's tiles where it takes a DCT-domain scaled decode
# (the deliberate difference: nvJPEG's full decode averaged over blocks of
# the same scale).  A sanity bar: an H100 read mean 1.26, 43.7 dB for
# smooth 640 x 640 whole images at 224 without the block average; the
# block average alone reads 0.6, 48 dB on textured ones (the CPU test).
SCALED_BARS = dict(mean_abs=2.0, psnr_db=35.0)
# A JPEG whose scan holds restart markers only: libjpeg (the JAX core, the
# twin) decodes it, nvJPEG refuses it; counted as a failure on the card.
RESTART_MARKERS = "restart markers only"


# COCO train2017's JPEGs hold about 152 kB a file on average (18 GB for
# 118K images, cocodataset.org's download page).  The luminance texture of
# photo_jpeg is sized to that: 157 kB a 480 x 640 JPEG at quality 90.
PHOTO_TEXTURE = 30.0


def photo_jpeg(rng: np.random.Generator, h: int, w: int, grey=False,
               **kw) -> bytes:
    """A seeded h x w image as PIL's JPEG: smooth colour waves, a 1/f-like
    luminance texture (noise fields at 1 to 1/32 of the resolution, each
    repeated up to full size; PHOTO_TEXTURE levels in all) and mild noise
    per channel.  Like a photo, its detail lies in the luminance and its
    chroma is smooth; its bytes are COCO's."""
    import io

    from PIL import Image

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f, p = rng.uniform(0.005, 0.05, 6), rng.uniform(0, 6, 3)
    img = np.stack([np.sin(xx * f[c] + p[c]) * np.cos(yy * f[3 + c])
                    for c in range(3)], axis=-1)
    texture = np.zeros((h, w), np.float32)
    for k in range(6):
        field = rng.normal(0, 1, (-(-h >> k), -(-w >> k))).astype(np.float32)
        texture += field.repeat(1 << k, 0).repeat(1 << k, 1)[:h, :w]
    texture *= PHOTO_TEXTURE / np.sqrt(6)
    img = np.clip((img + 1) * 127.5 + texture[..., None]
                  + rng.normal(0, 4, img.shape), 0, 255)
    img = img.astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img[..., 1] if grey else img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def write_coco_tree(root: str, rng: np.random.Generator) -> None:
    """COCO's own layout under ``root`` (``images/{split}2017/*.jpg``,
    ``annotations/captions_{split}2017.json``): DATA_TRAIN train and DATA_VAL
    val JPEGs (photo_jpeg, quality 90, 4:2:0) of 480 x 640 and 640 x 480 in
    turn, every 16th 640 x 640, five captions each."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    jobs = []
    for split, n in (("train", DATA_TRAIN), ("val", DATA_VAL)):
        os.makedirs(os.path.join(root, "images", f"{split}2017"))
        os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
        images, anns = [], []
        for i in range(n):
            image_id = 100_000 * (split == "val") + i + 1
            name = f"{image_id:012d}.jpg"
            shape = (640, 640) if i % 16 == 15 else (
                (480, 640) if i % 2 == 0 else (640, 480))
            jobs.append((os.path.join(root, "images", f"{split}2017", name),
                         shape, int(rng.integers(1 << 31))))
            images.append({"id": image_id, "file_name": name})
            anns += [{"image_id": image_id, "caption": c}
                     for c in captions(rng, 5)]
        with open(os.path.join(root, "annotations",
                               f"captions_{split}2017.json"), "w") as f:
            json.dump({"images": images, "annotations": anns}, f)

    def save(job):
        path, (h, w), seed = job
        with open(path, "wb") as f:
            f.write(photo_jpeg(np.random.default_rng(seed), h, w, quality=90))

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        list(pool.map(save, jobs))


def crop_bytes(boxes: np.ndarray, sizes: np.ndarray, out_size: int) -> int:
    """What crop_resize_flip_u8 must move: each tile written once and each
    crop region of the source read once."""
    h, w = sizes[:, 0].astype(np.float64), sizes[:, 1].astype(np.float64)
    full = boxes[:, 0] < 0
    frac_h = np.where(full, 1.0, boxes[:, 2] - boxes[:, 0])
    frac_w = np.where(full, 1.0, boxes[:, 3] - boxes[:, 1])
    region = np.ceil(frac_h * h) * np.ceil(frac_w * w) * 3
    return int(len(boxes) * out_size * out_size * 3 + region.sum())


def native_kernel_alone(jpegs: list) -> dict:
    """crop_resize_flip_u8 on the twin's own decode (PIL at the JAX core's
    scale) of ``jpegs`` in one arena on the card, against the twin on the
    same arena, bit for bit: train boxes, whole images, 1 x 1 and
    edge-clamped crops, flips on and off, at 224 and the cache's 256; whole
    images at full resolution averaged over blocks of the JAX core's scale;
    images cut to odd widths, so that every row and image starts at an odd
    byte, in an arena and tiles at odd addresses; and the configs' batch
    of 1024 (two launches).  Then its times at the main path's shapes:
    nvJPEG's full resolution, no flip, train boxes and their blocks at
    (128, 224) (the loader's batch) and at (1024, 224) (the configs'
    batch), and whole images at (256, 256) (a chunk of the device cache's
    build)."""
    from clip_lite_torch.data import native

    n = len(jpegs)
    rng = np.random.default_rng(41)
    train = native.random_resized_crop_boxes(rng, n)
    edges = train.copy()
    edges[0::4] = (0.999, 0.0, 1.0, 0.001)   # 1 x 1 at the bottom-left
    edges[1::4] = (0.0, 0.999, 0.001, 1.0)   # 1 x 1 at the top-right
    edges[2::4] = (0.6, 0.7, 1.0, 1.0)       # against two borders
    alternate = (np.arange(n) % 2).astype(np.uint8)
    zeros, ones = np.zeros(n, np.uint8), np.ones(n, np.uint8)
    # nvJPEG's arena: every image at full resolution.
    full = [native.decode_rgb(j, None, 224, scaled=False) for j in jpegs]

    def check(name, images, boxes, flips, size, denoms=None, lead=0):
        packed, offsets, sizes = native.pack_arena(images)
        m = len(images)
        arena = torch.empty(len(packed) + lead, dtype=torch.uint8,
                            device="cuda")[lead:]
        arena.copy_(torch.from_numpy(packed))
        out = torch.full((lead + m * size * size * 3,), 7, dtype=torch.uint8,
                         device="cuda")[lead:].view(m, size, size, 3)
        got = native.crop_resize_flip_u8(arena, offsets, sizes, boxes, flips,
                                         size, out=out, denoms=denoms)
        want = native.crop_resize_flip_reference(arena, offsets, sizes, boxes,
                                                 flips, size, denoms)
        torch.cuda.synchronize()
        diff = int((got.int() - want.int()).abs().max())
        log(f"crop_resize_flip_u8 {name} at B {m}: max|kernel-plain| {diff}")
        if not torch.equal(got, want):
            raise AssertionError(f"crop_resize_flip_u8 {name}: not bit for bit "
                                 f"its plain version (max {diff})")

    cases = {"train 224, flips alternate": (train, alternate, 224),
             "whole 224": (native.full_image_boxes(n), zeros, 224),
             "edges 224, flipped": (edges, ones, 224),
             "whole 256 (cache tiles)": (native.full_image_boxes(n), zeros, 256),
             "train 256, flipped": (train, ones, 256)}
    for name, (boxes, flips, size) in cases.items():
        check(name, [native.decode_rgb(j, b, size) for j, b in
                     zip(jpegs, boxes)], boxes, flips, size)
    whole = native.full_image_boxes(n)
    denoms = native.scale_denoms(whole, np.array([im.shape[:2] for im in full]),
                                 224)
    if not (denoms > 1).any():
        raise AssertionError("crop_resize_flip_u8: no block in the whole images")
    check("whole 224, full resolution, blocks", full, whole, alternate, 224,
          denoms)
    odd = [im[:im.shape[0] - i % 3, :im.shape[1] - 1 - 2 * (i % 5)]
           for i, im in enumerate(full)]
    check("train 224, odd widths at odd offsets, full resolution", odd, train,
          alternate, 224,
          native.scale_denoms(train, np.array([im.shape[:2] for im in odd]),
                              224), lead=1)
    big = full * (1024 // n)
    boxes = native.random_resized_crop_boxes(rng, len(big))
    check("batch 1024, train 224, full resolution", big, boxes,
          (np.arange(len(big)) % 2).astype(np.uint8), 224,
          native.scale_denoms(boxes, np.array([im.shape[:2] for im in big]),
                              224))

    def times(images, boxes, size) -> dict:
        packed, offsets, sizes = native.pack_arena(images)
        denoms = native.scale_denoms(boxes, sizes, size)
        flips = np.zeros(len(images), np.uint8)
        copies = l2_spilling_copies(torch.from_numpy(packed).cuda())

        def kernel(a):
            return native.crop_resize_flip_u8(a, offsets, sizes, boxes, flips,
                                              size, denoms=denoms)

        def plain(a):
            return native.crop_resize_flip_reference(a, offsets, sizes, boxes,
                                                     flips, size, denoms)

        err = int((kernel(copies[0][0]).int() - plain(copies[0][0]).int())
                  .abs().max())
        # Half a second of calls first: a fresh process (--crop-kernel)
        # finds the clocks down.
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 0.5:
            for a in copies:
                kernel(*a)
            torch.cuda.synchronize()
        n_bytes = crop_bytes(boxes, sizes, size)
        row = dict(max_abs_err=err, ms=time_ms(kernel, copies),
                   ms_device=device_ms(kernel, copies),
                   host_ms=enqueue_ms(kernel, copies),
                   plain_ms=time_ms(plain, copies, iters=3, warmup=1),
                   library_ms=None, **bound(n_bytes, 0, torch.float32))
        log(f"crop_resize_flip_u8 at B {len(images)}, {size}: kernel "
            f"{row['ms']} ms ({row['ms_device']} on the device, "
            f"{row['host_ms']} host), plain {row['plain_ms']} ms, bound "
            f"{row['bound_ms']} ms ({row['bound_by']}: {n_bytes} bytes); no "
            f"library call crops per-image boxes")
        return row

    row = times(full, train, 224)
    row["cache_256"] = times(full * (256 // n), native.full_image_boxes(256),
                             256)
    # The configs' batch: the same images and boxes eight times over, in
    # launches of crop_images_per_launch() images.
    row["batch_1024"] = times(full * (1024 // n),
                              np.tile(train, (1024 // n, 1)), 224)
    return row


def native_decode_kinds() -> dict:
    """Four JPEGs of each kind (PIL, seeded): baseline 4:2:0, 4:2:2 and
    4:4:4 at 480 x 640, progressive, greyscale, 640 x 480 and 640 x 640
    sources; then what the JAX core cannot decode (CMYK, bytes that are no
    JPEG) and a truncated baseline one."""
    import io

    from PIL import Image

    rng = np.random.default_rng(43)
    kinds = {
        "baseline 4:2:0": lambda: photo_jpeg(rng, 480, 640, quality=90),
        "baseline 4:2:2": lambda: photo_jpeg(rng, 480, 640, quality=90,
                                              subsampling=1),
        "baseline 4:4:4": lambda: photo_jpeg(rng, 480, 640, quality=90,
                                              subsampling=0),
        "progressive": lambda: photo_jpeg(rng, 480, 640, quality=90,
                                           progressive=True),
        "greyscale": lambda: photo_jpeg(rng, 480, 640, grey=True, quality=90),
        "640 x 480": lambda: photo_jpeg(rng, 640, 480, quality=90),
        "640 x 640": lambda: photo_jpeg(rng, 640, 640, quality=90),
    }
    out = {k: [make() for _ in range(4)] for k, make in kinds.items()}
    buf = io.BytesIO()
    Image.open(io.BytesIO(out["baseline 4:2:0"][0])).convert("CMYK").save(
        buf, "JPEG")
    out["cmyk"] = [buf.getvalue()]
    out["no jpeg"] = [b"\xff\xd8" + bytes(100)]
    out["truncated"] = [out["baseline 4:2:0"][1][:20000]]
    base = out["baseline 4:2:0"][2]
    sos = base.index(b"\xff\xda")
    out["cut in a header"] = [base[:sos + 5]]
    out[RESTART_MARKERS] = [base[:sos + 14] + b"\xff\xd0\xff\xd3" * 200
                            + b"\xff\xd9"]
    return out


def tile_distance(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """Per image: mean |a - b| in levels and PSNR in dB (inf where equal)."""
    d = (a.double() - b.double()).flatten(1)
    mse = (d ** 2).mean(1)
    psnr = torch.where(mse > 0, 10 * torch.log10(255.0 ** 2 / mse),
                       torch.full_like(mse, float("inf")))
    return d.abs().mean(1).tolist(), psnr.tolist()


def native_decode(kinds: dict) -> dict:
    """nvJPEG + the kernel against the twin, per JPEG kind, train and whole
    boxes at 224: within DECODE_BARS of the twin at nvJPEG's (full)
    resolution, per image; against the JAX core's own scaled decode where
    it takes one, within SCALED_BARS; the same failures as the twin (which
    equals the JAX core's, tests/test_torch_native.py)."""
    from clip_lite_torch.data import native

    result = {}
    for kind, jpegs in kinds.items():
        n = len(jpegs)
        boxes = np.concatenate([native.full_image_boxes(n),
                                native.random_resized_crop_boxes(
                                    np.random.default_rng(n), n)])
        jpegs = jpegs * 2
        flips = np.zeros(2 * n, np.uint8)
        card, card_fail = native.decode_crop_batch(jpegs, 224, boxes, flips)
        card = card.cpu()
        twin, twin_fail = native.decode_crop_batch_plain(jpegs, 224, boxes, flips)
        images = [native.decode_rgb(j, b, 224, scaled=False)
                  for j, b in zip(jpegs, boxes)]
        arena, offsets, sizes = native.pack_arena(images)
        full = native.crop_resize_flip_reference(
            arena, offsets, sizes, boxes, flips, 224,
            native.scale_denoms(boxes, sizes, 224))
        mean, psnr = tile_distance(card, full)
        scaled = [i for i, (j, b) in enumerate(zip(jpegs, boxes))
                  if images[i] is not None and native.scale_denom(
                      b, *images[i].shape[:2], 224) > 1]
        s_mean, s_psnr = tile_distance(card[scaled], twin[scaled]) \
            if scaled else ([], [])
        result[kind] = dict(failures=card_fail, twin_failures=twin_fail,
                            max_mean_abs=max(mean), min_psnr_db=min(psnr),
                            scaled_images=len(scaled),
                            scaled_max_mean_abs=max(s_mean, default=None),
                            scaled_min_psnr_db=min(s_psnr, default=None))
        log(f"nvJPEG {kind}: {2 * n} tiles, failures {card_fail} (twin "
            f"{twin_fail}); against the twin at full resolution max mean|d| "
            f"{max(mean)}, min PSNR {min(psnr)} dB; {len(scaled)} tiles where "
            f"the JAX core decodes at a DCT scale: max mean|d| "
            f"{result[kind]['scaled_max_mean_abs']}, min PSNR "
            f"{result[kind]['scaled_min_psnr_db']} dB")
        if kind == RESTART_MARKERS:  # the deliberate difference
            if (card_fail, twin_fail) != (len(jpegs), 0):
                raise AssertionError(f"nvJPEG {kind}: {card_fail} failures, "
                                     f"the JAX core's {twin_fail}")
            continue
        if card_fail != twin_fail:
            raise AssertionError(f"nvJPEG {kind}: {card_fail} failures, the "
                                 f"JAX core's {twin_fail}")
        if kind == "truncated":  # decoded as far as it goes: no bar
            continue
        if twin_fail == 0 and (max(mean) > DECODE_BARS["mean_abs"]
                               or min(psnr) < DECODE_BARS["psnr_db"]):
            raise AssertionError(f"nvJPEG {kind}: outside {DECODE_BARS}")
        if scaled and (max(s_mean) > SCALED_BARS["mean_abs"]
                       or min(s_psnr) < SCALED_BARS["psnr_db"]):
            raise AssertionError(f"nvJPEG {kind} against the scaled decode: "
                                 f"outside {SCALED_BARS}")
    return result


def native_decode_ms(jpegs: list) -> dict:
    """nvJPEG's decode of one batch from an idle card, host clock: until
    the call returns (``host_ms``) and until the card is done (``ms``),
    medians of five after a warm-up."""
    from clip_lite_torch.data import native

    done, returned = [], []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        native.nvjpeg_decode(jpegs, torch.device("cuda"))
        returned.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        done.append(1e3 * (time.perf_counter() - t0))
    out = {"ms": statistics.median(done[1:]),
           "host_ms": statistics.median(returned[1:])}
    log(f"nvJPEG (GPU_HYBRID), a batch of {len(jpegs)} of the records' "
        f"JPEGs: {out['ms']} ms until done, the call returns after "
        f"{out['host_ms']} ms (medians of 5)")
    return out


def native_records(root: str) -> tuple:
    """Phase 10d's records under ``root``: a COCO tree (write_coco_tree)
    made into CLRec records by coco_preprocess.  Returns their directory,
    the first BATCH train JPEGs and the bytes a JPEG of the tree and of
    the records."""
    import argparse
    import os

    from clip_lite_torch.data.readers import ClRecReader
    from clip_lite_torch.scripts import coco_preprocess

    serialized = os.path.join(root, "serialized")
    t0 = time.perf_counter()
    write_coco_tree(os.path.join(root, "coco"), np.random.default_rng(31))
    t1 = time.perf_counter()
    for split in ("train", "val"):
        coco_preprocess.main(argparse.Namespace(
            data_root=os.path.join(root, "coco"), split=split,
            mode="train_sbert", output_dir=serialized, short_edge=0,
            jpeg_quality=95))
    log(f"native: a COCO tree of {DATA_TRAIN} + {DATA_VAL} JPEGs written "
        f"in {t1 - t0} s, made into CLRec records by coco_preprocess in "
        f"{time.perf_counter() - t1} s")
    tree = [os.path.getsize(os.path.join(d, f)) for d, _, files in
            os.walk(os.path.join(root, "coco", "images")) for f in files]
    reader = ClRecReader(os.path.join(
        serialized, "coco_train_train_sbert2017.clrec"))
    records = [len(reader[i]["image"]) for i in range(len(reader))]
    jpegs = [reader[i]["image"] for i in range(BATCH)]
    reader.close()
    log(f"native: bytes a JPEG, the tree (quality 90) mean "
        f"{statistics.mean(tree)} max {max(tree)}; the train records "
        f"(quality 95) mean {statistics.mean(records)} max "
        f"{max(records)}; COCO train2017 about 152 kB a file")
    return serialized, jpegs, {
        "tree": {"mean": statistics.mean(tree), "max": max(tree)},
        "records": {"mean": statistics.mean(records), "max": max(records)}}


def phase_native(float_step: dict, host_step: float) -> dict:
    """The native JPEG batch path (DATA.NATIVE_PIPELINE): records made by
    the port's coco_preprocess from a COCO-layout tree; the kernel alone
    and the decode per JPEG kind; the loader alone, native against the
    Python path on the same records; then the CLI (each run with the
    counts set to 0 just before and read just after): (A)
    configs/fs_native_input.yaml, (B) configs/fs_tpu_tuned.yaml with
    DATA.DEVICE_CACHE (the cache built through the native decode), (C)
    configs/fs_tpu_tuned.yaml as written."""
    import os
    import shutil
    import tempfile

    import clip_lite_torch.data.device_cache as device_cache
    import clip_lite_torch.train as cli
    from clip_lite_torch.config import Config
    from clip_lite_torch.data import native
    from clip_lite_torch.data.datasets import CocoCaptionsDataset
    from clip_lite_torch.data.pipeline import infinite_batches
    from clip_lite_torch.factories import PretrainingDatasetFactory
    from clip_lite_torch.ops.attention import (
        attention_backward, fused_short_attention)
    from clip_lite_torch.ops.normalize import augment_normalize_u8, normalize_u8

    counters = {"attention_fwd": fused_short_attention,
                "attention_bwd": attention_backward,
                "normalize": normalize_u8,
                "augment_normalize": augment_normalize_u8,
                "crop_resize_flip": native.crop_resize_flip_u8,
                "nvjpeg": native.nvjpeg_decode}
    native_cfg = ROOT / "configs" / "fs_native_input.yaml"
    workers = os.cpu_count() or 1
    root = tempfile.mkdtemp(prefix="chip_smoke_native_")
    real_make_step = cli.make_train_step
    real_record, real_stop = cli.record_trace, cli.stop_trace
    real_from_dataset = device_cache.DeviceDataCache.from_dataset.__func__
    logger = logging.getLogger("clip_lite_torch")
    phase_t0 = time.perf_counter()
    out = {}
    try:
        serialized, jpegs, out["jpeg_bytes"] = native_records(root)
        out["kernel"] = native_kernel_alone(jpegs)
        out["decode"] = native_decode(native_decode_kinds())
        out["nvjpeg"] = native_decode_ms(jpegs)

        sizes = ["DATA.ROOT", serialized, "OPTIM.BATCH_SIZE", BATCH,
                 "OPTIM.NUM_ITERATIONS", NATIVE_STEPS,
                 "OPTIM.WARMUP_STEPS", NATIVE_STEPS // 2]

        def args(name, config, extra=(), steps=NATIVE_STEPS, flags=()):
            return cli.parser.parse_args([str(a) for a in (
                "--config", config, "--serialization-dir",
                os.path.join(root, name), "--checkpoint-every", 10,
                "--log-every", 5, "--cpu-workers", workers, *flags,
                "--config-override", *sizes, "OPTIM.NUM_ITERATIONS", steps,
                "OPTIM.WARMUP_STEPS", steps // 2, *extra)])

        # The loader alone, native and Python path on the same records.
        loader_s = {}
        for path in (True, False):
            cfg = Config(str(native_cfg), sizes + ["DATA.NATIVE_PIPELINE", path])
            loader, _ = cli.init_dataloaders(cfg, args("loader", native_cfg),
                                             torch.device("cuda"))
            stream = infinite_batches(loader)
            first = next(stream)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DATA_LOADER_BATCHES):
                batch = next(stream)
            torch.cuda.synchronize()
            loader_s[path] = (time.perf_counter() - t0) / DATA_LOADER_BATCHES
            stream.close()
            image = first["image"]
            log(f"native: the loader alone, DATA.NATIVE_PIPELINE {path}, "
                f"{workers} workers: {1 / loader_s[path]} batches/s of {BATCH}"
                f" ({loader_s[path]} s a batch over {DATA_LOADER_BATCHES}); "
                f"image {image.dtype} {tuple(image.shape)} on {image.device}")
            want = (torch.uint8, "cuda") if path else (torch.float32, "cpu")
            if (image.dtype, image.device.type) != want or tuple(
                    image.shape) != (BATCH, 224, 224, 3):
                raise AssertionError(f"the loader's batch: {image.dtype} on "
                                     f"{image.device}, expected {want}")
            del loader, stream, first, batch, image
        out["loader_batches_per_s"] = {"native": 1 / loader_s[True],
                                       "python": 1 / loader_s[False]}

        tracer = kernel_counters()

        def counted_record(*a, **kw):
            """The wrappers' counts as the profiler's record begins ..."""
            real_record(*a, **kw)
            window["start"] = {k: c.launches for k, c in tracer.items()}

        def counted_stop(*a, **kw):
            """... and as it stops: their launches in the traced steps."""
            window["path"] = real_stop(*a, **kw)
            window["launches"] = {k: c.launches - window["start"][k]
                                  for k, c in tracer.items()}
            return window["path"]

        window = {}

        def run(name, a):
            """main(a) with the counts set to 0 just before and read just
            after; each step's entry and return times; with --profile-dir,
            the wrappers' launches in the traced steps."""
            record = {"t": [], "t_out": []}
            window.clear()
            cli.record_trace, cli.stop_trace = counted_record, counted_stop

            def make_step(cfg):
                step = real_make_step(cfg)

                def recorded(state, batch):
                    record["t"].append(time.perf_counter())
                    result = step(state, batch)
                    record["t_out"].append(time.perf_counter())
                    return result
                return recorded

            cli.make_train_step = make_step
            for k in counters.values():
                k.launches = 0
            fused_short_attention.tc_launches = 0
            fused_short_attention.tf32x3_launches = 0
            fused_short_attention.tf32x3_tiled_launches = 0
            attention_backward.tc_launches = 0
            t0 = time.perf_counter()
            cli.main(a)
            torch.cuda.synchronize()
            record["wall"] = time.perf_counter() - t0
            record["launches"] = {n: k.launches for n, k in counters.items()}
            record["launches"].update(
                attention_fwd_tc=fused_short_attention.tc_launches,
                attention_fwd_tf32x3=fused_short_attention.tf32x3_launches,
                attention_fwd_tf32x3_tiled=fused_short_attention.tf32x3_tiled_launches,
                attention_bwd_tc=attention_backward.tc_launches)
            record["window"] = dict(window)
            cli.make_train_step = real_make_step
            cli.record_trace, cli.stop_trace = real_record, real_stop
            metrics = [json.loads(line) for line in open(os.path.join(
                root, name, "metrics.jsonl"))]
            t, t_out = record["t"], record["t_out"]
            record["step_s"] = statistics.median(
                [b - a for a, b in zip(t[2:9], t[3:10])])
            record["enqueue_s"] = statistics.median(
                [b - a for a, b in zip(t[2:9], t_out[2:9])])
            record["sweeps"] = len([m for m in metrics if m["split"] == "val"])
            log(f"native ({name}): {len(t)} steps with sweeps and checkpoints "
                f"in {record['wall']} s; median step {record['step_s']} s over "
                f"steps 3-9 (start to start), the host's enqueue "
                f"{record['enqueue_s']} s a step; launches "
                f"{record['launches']}; metrics {json.dumps(metrics)}")
            if not metrics or not all(math.isfinite(m["total_loss"])
                                      for m in metrics):
                raise AssertionError(f"({name}) loss not finite: {metrics}")
            return record

        def expect(name, cfg, record, steps, decodes_at_least):
            """K1-K3's launches exactly, and at least ``decodes_at_least``
            decoded batches (None: the decode was replaced)."""
            n_layers = cfg.MODEL.TEXTUAL.NUM_HIDDEN_LAYERS
            val_batches = record["sweeps"] * (DATA_VAL // BATCH)
            got = {k: record["launches"][k] for k in counters}
            want = dict(attention_fwd=n_layers * (steps + val_batches),
                        attention_bwd=n_layers * steps,
                        normalize=val_batches, augment_normalize=steps)
            if any(got[k] != v for k, v in want.items()) or not (
                    got["crop_resize_flip"] == got["nvjpeg"]) or (
                    decodes_at_least is not None
                    and got["nvjpeg"] < decodes_at_least):
                raise AssertionError(f"({name}) launches {got}, expected "
                                     f"{want} and at least {decodes_at_least} "
                                     "decodes")
            check_routes(cfg, cfg.DATA.MAX_CAPTION_LENGTH, record["launches"])

        # (A) fs_native_input.yaml through the loader.
        cfg_a = Config(str(native_cfg), sizes)
        rec_a = run("a", args("a", native_cfg))
        expect("a", cfg_a, rec_a, NATIVE_STEPS,
               NATIVE_STEPS + rec_a["sweeps"] * (DATA_VAL // BATCH))
        # (A0) the same with the decode replaced by a fixed tile tensor on
        # the card (a copy a batch), (A1) with every batch of a split the
        # first one again: what the decode, then reading the records and
        # tokenizing, cost the step.
        fixed_tiles = native.decode_crop_batch(
            jpegs, 224, native.full_image_boxes(BATCH),
            np.zeros(BATCH, np.uint8))[0]
        real_decode = native.decode_crop_batch
        real_load_batch = CocoCaptionsDataset.load_batch

        def fixed_decode(jpegs, out_size, crop_boxes, flips, device="cuda",
                         out=None):
            tiles = fixed_tiles[:len(jpegs)]
            return (tiles.clone() if out is None else out.copy_(tiles)), 0

        first_batches = {}

        def first_batch(self, indices):
            key = (self.split, len(indices))
            if key not in first_batches:
                first_batches[key] = real_load_batch(self, indices)
            return dict(first_batches[key])

        try:
            native.decode_crop_batch = fixed_decode
            rec_a0 = run("a0", args("a0", native_cfg))
        finally:
            native.decode_crop_batch = real_decode
        expect("a0", cfg_a, rec_a0, NATIVE_STEPS, None)
        try:
            CocoCaptionsDataset.load_batch = first_batch
            rec_a1 = run("a1", args("a1", native_cfg))
        finally:
            CocoCaptionsDataset.load_batch = real_load_batch
        expect("a1", cfg_a, rec_a1, NATIVE_STEPS, None)
        # (A) and (A0) again under --profile-dir: TRACE_STEPS steps traced
        # after TRACE_WARM (the last in the profiler's warm-up), and one
        # more; no sweep.  The kernels of the step's thread (K1-K3): as many
        # events as launches in the traced steps, each inside its wrapper's
        # range.  The loader thread's (the crop kernel, nvJPEG's) launch
        # beside the record's start and stop, so their counts are printed
        # as the trace has them; every launch the trace records has its
        # kernel.
        traced_steps = TRACE_WARM + TRACE_STEPS + 1
        main_thread = ("K1 attention_fwd", "K2 attention_bwd",
                       "K3 normalize_u8", "K3 augment_normalize_u8")
        traces = {}
        for key in ("a", "a0"):
            name = f"{key}_trace"
            a = args(name, native_cfg, steps=traced_steps, flags=(
                "--profile-dir", os.path.join(root, name, "trace")))
            try:
                if key == "a0":
                    native.decode_crop_batch = fixed_decode
                rec = run(name, a)
            finally:
                native.decode_crop_batch = real_decode
            expect(name, cfg_a, rec, traced_steps,
                   traced_steps if key == "a" else None)
            w = rec["window"]
            traces[key] = analyze_trace(f"native ({name})", w["path"],
                                        w["launches"], TRACE_STEPS,
                                        exact=main_thread)
            traces[key].update(step_s=rec["step_s"],
                               launches=rec["launches"])
        ta, ta0 = traces["a"], traces["a0"]

        def med(t, k):
            return statistics.median(s[k] for s in t["split"])

        log(f"native: (a) against (a0) under the profiler, a step: window "
            f"{med(ta, 'window_ms')} against {med(ta0, 'window_ms')} ms, host "
            f"enqueue {med(ta, 'enqueue_ms')} against {med(ta0, 'enqueue_ms')}"
            f" ms, device busy {med(ta, 'busy_ms')} against "
            f"{med(ta0, 'busy_ms')} ms; nvJPEG's kernels {ta['nvjpeg_ms']} ms, "
            f"{ta['nvjpeg_overlap_ms']} ms of it beside the step's kernels; "
            f"the host in blocking runtime calls {ta['syncs_ms']} against "
            f"{ta0['syncs_ms']} ms over {TRACE_STEPS} steps")
        out["traces"] = {k: {key: t[key] for key in (
            "split", "nvjpeg_ms", "nvjpeg_overlap_ms", "syncs_ms", "launches")}
            for k, t in traces.items()}
        del fixed_tiles, first_batches
        # (B) fs_tpu_tuned.yaml + DATA.DEVICE_CACHE, built natively.
        built = {}

        def from_dataset(klass, *a, **kw):
            built["cache"] = real_from_dataset(klass, *a, **kw)
            return built["cache"]

        device_cache.DeviceDataCache.from_dataset = classmethod(from_dataset)
        cfg_b = Config(str(TUNED), sizes + ["DATA.DEVICE_CACHE", True])
        rec_b = run("b", args("b", TUNED, ["DATA.DEVICE_CACHE", True]))
        cache = built.pop("cache")
        chunks = -(-DATA_TRAIN // device_cache.NATIVE_CHUNK)
        expect("b", cfg_b, rec_b, NATIVE_STEPS,
               chunks + rec_b["sweeps"] * (DATA_VAL // BATCH))
        if tuple(cache._images.shape) != (DATA_TRAIN, 256, 256, 3):
            raise AssertionError(f"(b) tiles {tuple(cache._images.shape)}")
        build_native = cache.build_seconds
        del cache
        # The same cache through the Python path, for its build time.
        py_ds = PretrainingDatasetFactory.from_config(
            Config(str(TUNED), sizes + ["DATA.NATIVE_PIPELINE", False]),
            "train")
        t0 = time.perf_counter()
        device_cache.load_host(py_ds, 256, np.arange(len(py_ds)))
        build_python = time.perf_counter() - t0
        log(f"native (b): the cache of {DATA_TRAIN} tiles of 256 built in "
            f"{build_native} s through the native decode, {build_python} s "
            "through the Python path (load_host alone)")
        # (C) fs_tpu_tuned.yaml as written, through the loader.
        cfg_c = Config(str(TUNED), sizes + ["OPTIM.NUM_ITERATIONS", 10])
        rec_c = run("c", args("c", TUNED, steps=10))
        expect("c", cfg_c, rec_c, 10, 10 + rec_c["sweeps"] * (DATA_VAL // BATCH))
        log(f"native: the CLI at batch {BATCH}, median step start to start: "
            f"(a) fs_native_input {rec_a['step_s']} s, (a0) its decode "
            f"replaced by fixed tiles {rec_a0['step_s']} s, (a1) every "
            f"batch the first {rec_a1['step_s']} s, (b) fs_tpu_tuned + "
            f"cache {rec_b['step_s']} s, (c) fs_tpu_tuned {rec_c['step_s']} s;"
            f" beside phase 6's fixed batches {float_step['step_s']} s and "
            f"phase 10b's host loader {host_step} s; nvJPEG "
            f"{out['nvjpeg']['ms']} ms a batch, "
            f"{out['nvjpeg']['ms'] / 1e3 / rec_a['step_s']} of (a)'s step")
        out.update(a=rec_a, a0=rec_a0, a1=rec_a1, b=rec_b, c=rec_c, build_s={
            "native": build_native, "python": build_python})
        for r in (rec_a, rec_a0, rec_a1, rec_b, rec_c):
            del r["t"], r["t_out"]
        out["seconds"] = time.perf_counter() - phase_t0
        log(f"native: phase 10d in {out['seconds']} s")
    finally:
        cli.make_train_step = real_make_step
        cli.record_trace, cli.stop_trace = real_record, real_stop
        device_cache.DeviceDataCache.from_dataset = classmethod(real_from_dataset)
        for handler in logger.handlers:  # the CLI's, into the directory
            handler.close()
        logger.handlers.clear()
        logger.propagate = True
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# The quality path (phase 11): the synthetic corpus's size, the steps of
# each run, the host loader's workers (the campaign's, the CLI's default).
QUALITY_TRAIN, QUALITY_VAL, QUALITY_STEPS, QUALITY_WORKERS = 512, 128, 4, 4


def qkv_grads(state) -> list:
    """Every BERT layer's QKV weight gradient, fp32, after a step."""
    layers = state.model.text_encoder.transformer
    return [getattr(layers, n).qkv.weight.grad.float().clone()
            for n in layers.layer_names]


def phase_quality(float_step: dict) -> dict:
    """The quality campaign's path at full width, cut short: the port's
    make_synth_data writes a corpus (QUALITY_TRAIN train and QUALITY_VAL
    val scenes of 256 px, one zero-shot image a class), coco_preprocess
    makes its records; then, each CLI run with the counts set to 0 just
    before and read just after: (N) fs_tpu_tuned through the native decode
    and the device cache, QUALITY_STEPS steps of BATCH and a checkpoint;
    scripts/cluster.py on that checkpoint for both splits (k 2-10, a K1
    batch an image); (S) a fresh run that switches to the cluster
    curriculum inside the run (DATA.NEGATIVE_SAMPLING clusters from step
    QUALITY_STEPS // 2 + 1; the native batch path before, the host
    loader's BATCH / 2 pairs and negatives after, K1/K2 twice a step);
    (C) the run resumed at QUALITY_STEPS into the cluster
    curriculum (DATA.NEGATIVE_SAMPLING clusters from QUALITY_STEPS) for
    QUALITY_STEPS steps through the host loader, BATCH / 2 pairs and as
    many negatives a step, a val sweep and a checkpoint; one of its steps
    again through K1/K2 and through the plain attention, same state and
    batch, dropout 0, fp32 and bf16, at phase 7's bars; quality_campaign
    --families sweep on (C)'s last checkpoint."""
    import os
    import shutil
    import tempfile

    import clip_lite_torch.train as cli
    from clip_lite_torch.config import Config
    from clip_lite_torch.data import native
    from clip_lite_torch.engine import create_train_state, make_train_step
    from clip_lite_torch.engine import metrics_to_floats
    from clip_lite_torch.ops.attention import (
        attention_backward, fused_short_attention)
    from clip_lite_torch.ops.normalize import augment_normalize_u8, normalize_u8
    from clip_lite_torch.scripts import (
        cluster, coco_preprocess, make_synth_data, quality_campaign)

    counters = {"attention_fwd": fused_short_attention,
                "attention_bwd": attention_backward,
                "normalize": normalize_u8,
                "augment_normalize": augment_normalize_u8,
                "crop_resize_flip": native.crop_resize_flip_u8}
    root = tempfile.mkdtemp(prefix="chip_smoke_quality_")
    synth = os.path.join(root, "synth")
    real_make_step = cli.make_train_step
    logger = logging.getLogger("clip_lite_torch")
    out = {}

    def zero():
        for k in counters.values():
            k.launches = 0
        fused_short_attention.tc_launches = 0
        fused_short_attention.tf32x3_launches = 0
        fused_short_attention.tf32x3_tiled_launches = 0
        attention_backward.tc_launches = 0

    def read() -> dict:
        got = {n: k.launches for n, k in counters.items()}
        got.update(attention_fwd_tc=fused_short_attention.tc_launches,
                   attention_fwd_tf32x3=fused_short_attention.tf32x3_launches,
                   attention_fwd_tf32x3_tiled=fused_short_attention.tf32x3_tiled_launches,
                   attention_bwd_tc=attention_backward.tc_launches)
        return got

    try:
        t0 = time.perf_counter()
        make_synth_data.main(make_synth_data.parser.parse_args([str(a) for a in (
            "--output-dir", synth, "--train-n", QUALITY_TRAIN, "--val-n",
            QUALITY_VAL, "--zeroshot-per-class", 1, "--probe-train-per-class",
            0, "--voc-trainval", 0, "--voc-test", 0, "--gender-n", 0,
            "--image-size", 256)]))
        for split in ("train", "val"):
            coco_preprocess.main(coco_preprocess.parser.parse_args([
                "--data-root", os.path.join(synth, "coco"), "--split", split,
                "--output-dir", os.path.join(synth, "serialized"),
                "--short-edge", "256"]))
        out["corpus_s"] = time.perf_counter() - t0
        log(f"quality: make_synth_data + coco_preprocess, {QUALITY_TRAIN} "
            f"train and {QUALITY_VAL} val scenes of 256 px and 64 zero-shot "
            f"images, in {out['corpus_s']} s")
        sizes = ["DATA.ROOT", os.path.join(synth, "serialized"),
                 "OPTIM.BATCH_SIZE", BATCH, "OPTIM.WARMUP_STEPS",
                 QUALITY_STEPS // 2]

        def run(name, steps, extra, resume=None, keep=()):
            """cli.main over ``extra`` to ``steps`` iterations, the counts
            set to 0 just before and read just after; every step's start
            time, image rows and negatives, and the batches of ``keep``."""
            record = {"t": [], "rows": [], "batches": {}, "k1k2": []}

            def make_step(cfg):
                step = real_make_step(cfg)

                def recorded(state, batch):
                    record["t"].append(time.perf_counter())
                    record["rows"].append((batch["image"].shape[0],
                                           "neg_image" in batch))
                    if state.step + 1 in keep:  # host batches: no sync
                        record["batches"][state.step + 1] = batch
                    k1, k2 = (fused_short_attention.launches,
                              attention_backward.launches)
                    result = step(state, batch)
                    record["k1k2"].append(
                        (fused_short_attention.launches - k1,
                         attention_backward.launches - k2))
                    return result
                return recorded

            args = cli.parser.parse_args([str(a) for a in (
                "--config", TUNED, "--serialization-dir",
                os.path.join(root, name), "--checkpoint-every", QUALITY_STEPS,
                "--log-every", 1, "--cpu-workers", QUALITY_WORKERS,
                *(("--resume-from", resume) if resume else ()),
                "--config-override", *sizes, "OPTIM.NUM_ITERATIONS", steps,
                *extra)])
            cli.make_train_step = make_step
            zero()
            t0 = time.perf_counter()
            try:
                state = cli.main(args)
                torch.cuda.synchronize()
            finally:
                cli.make_train_step = real_make_step
            record["wall"] = time.perf_counter() - t0
            record["launches"] = read()
            record["metrics"] = [json.loads(line) for line in open(
                os.path.join(root, name, "metrics.jsonl"))]
            record["checkpoint"] = os.path.join(
                args.serialization_dir + Config(
                    args.config, list(args.config_override)).RUN_ID,
                f"checkpoint_{steps}.msgpack")
            t = record["t"]
            record["step_s"] = [b - a for a, b in zip(t[1:], t[2:])]
            log(f"quality ({name}): to step {state.step} in {record['wall']} "
                f"s; launches {record['launches']}; step times start to "
                f"start {record['step_s']}; metrics "
                f"{json.dumps(record['metrics'])}")
            if not record["metrics"] or not all(
                    math.isfinite(m["total_loss"]) and math.isfinite(
                        m.get("grad_norm", 0.0)) for m in record["metrics"]):
                raise AssertionError(f"({name}) loss or grad norm not finite")
            if not os.path.exists(record["checkpoint"]):
                raise AssertionError(f"({name}) wrote no {record['checkpoint']}")
            return state, record

        def expect(name, cfg, record, want):
            got = {k: record["launches"][k] for k in counters}
            if got != dict(dict.fromkeys(counters, 0), **want):
                raise AssertionError(f"({name}) launches {got}, expected {want}")
            check_routes(cfg, cfg.DATA.MAX_CAPTION_LENGTH, record["launches"])

        # (N) The normal phase through the native decode and the cache.
        n_extra = ["DATA.DEVICE_CACHE", True]
        cfg_n = Config(str(TUNED), sizes + n_extra)
        layers = cfg_n.MODEL.TEXTUAL.NUM_HIDDEN_LAYERS
        state_n, rec_n = run("normal", QUALITY_STEPS, n_extra)
        crops = rec_n["launches"]["crop_resize_flip"]
        if crops < 2:  # the cache's build and the val sweep decode
            raise AssertionError(f"(normal) crop kernel launched {crops} times")
        expect("normal", cfg_n, rec_n, dict(
            attention_fwd=layers * (QUALITY_STEPS + 1),
            attention_bwd=layers * QUALITY_STEPS,
            augment_normalize=QUALITY_STEPS, normalize=1,
            crop_resize_flip=crops))
        out["normal"] = dict(rec_n["launches"], step_s=rec_n["step_s"],
                             wall_s=rec_n["wall"])
        del state_n
        gc.collect()
        torch.cuda.empty_cache()

        # scripts/cluster.py on (N)'s checkpoint, both splits.
        zero()
        out["clustering"] = {}
        for split in ("train", "val"):
            out["clustering"][split] = cluster.main(cluster.parser.parse_args([
                "--coco-root", os.path.join(synth, "coco"), "--split", split,
                "--output-dir", os.path.join(synth, "clusters"),
                "--min-clusters", "2", "--max-clusters", "10",
                "--pretrain-config",
                os.path.join(root, "normal", "pretrain_config.yaml"),
                "--checkpoint-path", rec_n["checkpoint"]]))
        embed = read()
        if embed["attention_fwd"] != layers * (QUALITY_TRAIN + QUALITY_VAL):
            raise AssertionError(f"cluster.py: K1 {embed['attention_fwd']}, "
                                 "expected a batch an image")
        out["embed_launches"] = embed["attention_fwd"]
        log(f"quality: cluster.py, {QUALITY_TRAIN} + {QUALITY_VAL} images "
            f"encoded one a call (K1 {embed['attention_fwd']} launches), "
            f"k 2-10: {json.dumps(out['clustering'])}")

        clustered = ["DATA.NEGATIVE_SAMPLING", "clusters",
                     "DATA.CLUSTER_PATH", os.path.join(synth, "clusters"),
                     "DATA.COCO_ROOT", os.path.join(synth, "coco")]
        val_batches = QUALITY_VAL // (BATCH // 2)

        # (S) A fresh run that switches inside the run: the native batch
        # path's stream closed, the host clustered loaders built.
        before = QUALITY_STEPS // 2
        s_extra = clustered + ["DATA.NEGATIVE_SAMPLING_START_ITERATION",
                               before + 1]
        cfg_s = Config(str(TUNED), sizes + s_extra)
        state_s, rec_s = run("switched", QUALITY_STEPS, s_extra)
        after = QUALITY_STEPS - before
        if rec_s["rows"] != [(BATCH, False)] * before + [
                (BATCH // 2, True)] * after or rec_s["k1k2"] != [
                (layers, layers)] * before + [(2 * layers, 2 * layers)] * after:
            raise AssertionError(f"(switched) batches {rec_s['rows']}, K1/K2 "
                                 f"a step {rec_s['k1k2']}")
        crops = rec_s["launches"]["crop_resize_flip"]
        if crops < before:  # a decoded batch a step before the switch
            raise AssertionError(f"(switched) crop kernel launched {crops} "
                                 "times")
        expect("switched", cfg_s, rec_s, dict(
            attention_fwd=layers * before + 2 * layers * (after + val_batches),
            attention_bwd=layers * before + 2 * layers * after,
            augment_normalize=before, crop_resize_flip=crops))
        out["switched"] = dict(rec_s["launches"], step_s=rec_s["step_s"],
                               wall_s=rec_s["wall"], k1k2=rec_s["k1k2"])
        log(f"quality: the switch inside a run at step {before + 1}: "
            f"image rows {rec_s['rows']}, K1/K2 a step {rec_s['k1k2']}")
        del state_s
        gc.collect()
        torch.cuda.empty_cache()

        # (C) Resumed into the cluster curriculum through the host loader.
        c_extra = clustered + ["DATA.NEGATIVE_SAMPLING_START_ITERATION",
                               QUALITY_STEPS]
        cfg_c = Config(str(TUNED), sizes + c_extra)
        first = QUALITY_STEPS + 1
        state_c, rec_c = run("clusters", 2 * QUALITY_STEPS, c_extra,
                             resume=rec_n["checkpoint"], keep=(first,))
        if rec_c["rows"] != [(BATCH // 2, True)] * QUALITY_STEPS or \
                rec_c["k1k2"] != [(2 * layers, 2 * layers)] * QUALITY_STEPS:
            raise AssertionError(f"(clusters) batches {rec_c['rows']}, K1/K2 "
                                 f"a step {rec_c['k1k2']}")
        expect("clusters", cfg_c, rec_c, dict(
            attention_fwd=2 * layers * (QUALITY_STEPS + val_batches),
            attention_bwd=2 * layers * QUALITY_STEPS))
        out["clusters"] = dict(rec_c["launches"], step_s=rec_c["step_s"],
                               wall_s=rec_c["wall"])
        log(f"quality: the cluster steps through the host loader "
            f"({QUALITY_WORKERS} workers, {BATCH // 2} pairs + {BATCH // 2} "
            f"negatives): {rec_c['step_s']} s start to start, K1/K2 "
            f"{2 * layers} a step; the cache steps {rec_n['step_s']} s; "
            f"phase 6's step {float_step['step_s']} s")

        # One cluster step through K1/K2 against the plain attention.
        batch = rec_c["batches"][first]
        state_dict = {k: v.detach().clone()
                      for k, v in state_c.model.state_dict().items()}
        del state_c
        gc.collect()
        runs = {}
        for kind in ("float32", "bfloat16"):
            for flag in ("true", "false"):
                cfg = Config(str(TUNED), sizes + c_extra + [
                    "MODEL.TEXTUAL.DROPOUT", 0.0, "AMP", kind != "float32",
                    "MODEL.TEXTUAL.FUSED_ATTENTION", flag])
                state = create_train_state(cfg, device="cuda",
                                           state_dict=state_dict)
                state, metrics = make_train_step(cfg)(state, batch)
                runs[kind, flag] = (metrics_to_floats(metrics), qkv_grads(state))
                del state
                torch.cuda.empty_cache()
        out["parity"] = {}
        for kind in ("float32", "bfloat16"):
            got = parity(runs[kind, "true"], runs[kind, "false"])
            log(f"quality: cluster step {kind}, K1/K2 vs plain attention: "
                f"{got} (tol {PARITY_TOL[kind]})")
            if not within(got, PARITY_TOL[kind]):
                raise AssertionError(f"cluster step {kind}: parity fails: {got}")
            out["parity"][kind] = got
        del runs, state_dict, batch, rec_c
        gc.collect()
        torch.cuda.empty_cache()

        # quality_campaign's sweep on (C)'s last checkpoint (its CLIs are
        # processes of their own, on the card).
        t0 = time.perf_counter()
        result = quality_campaign.main(quality_campaign.parser.parse_args([
            "--run-dir", os.path.join(root, "clusters"), "--synth-root", synth,
            "--output", os.path.join(root, "quality.json"), "--work-dir",
            os.path.join(root, "campaign"), "--families", "sweep",
            "--retrieval-checkpoints", "1"]))
        out["campaign_s"] = time.perf_counter() - t0
        entry = result["checkpoints"].get(str(2 * QUALITY_STEPS), {})
        if result.get("failures") or not (
                0 <= entry["retrieval"]["r_mean"] <= 100
                and 0 <= entry["zero_shot"]["zero_shot_top1"] <= 100):
            raise AssertionError(f"quality_campaign: {json.dumps(result)}")
        out["campaign"] = entry
        log(f"quality: quality_campaign --families sweep in "
            f"{out['campaign_s']} s: {json.dumps(result)}")
    finally:
        cli.make_train_step = real_make_step
        for handler in logger.handlers:  # the CLI's, into the directory
            handler.close()
        logger.handlers.clear()
        logger.propagate = True
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def state_tensors(state) -> dict:
    """Copies of every tensor of a train state: parameters, BatchNorm
    statistics, the optimizer's trace and slow weights."""
    out = {f"model.{k}": v.detach().clone()
           for k, v in state.model.state_dict().items()}
    for attr in ("trace", "slow"):
        out.update({f"{attr}.{k}": v.clone()
                    for k, v in state.optimizer._by_name(attr).items()})
    return out


def distance(a: dict, b: dict) -> float:
    """The largest |a - b| over every element of two state_tensors."""
    if set(a) != set(b):
        raise AssertionError("the two states hold other tensors")
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)


def phase_checkpoint() -> dict:
    """Checkpoints on the card: the flagship at full width and depth, AMP
    bf16, batch 128, in a temporary directory deleted at the end.
    (a) 10 steps through train_loop, checkpoint_every 5 (a val sweep of one
    batch, then a checkpoint), climax_freq 1, keep_recent 1, asynchronous
    writes; then a sync save of the same state, bit for bit the async one;
    (b) a fresh state resumed from checkpoint_5 runs steps 6-10 on the same
    batches; (c) the same 10 steps with no checkpoints; (d) EncoderBundle
    from the final checkpoint against one from (a)'s live state_dict; (e)
    the uint8 path (fs_tpu_tuned + DATA.DEVICE_CACHE, 512 tiles) resumed
    after step 2, whose step 3 must see the uninterrupted batch."""
    import os
    import shutil
    import tempfile

    from clip_lite_torch.config import Config
    from clip_lite_torch.data.device_cache import DeviceDataCache
    from clip_lite_torch.data.tokenizers import HashingTokenizer
    from clip_lite_torch.engine import (
        create_train_state, make_eval_step, make_scanned_train_step,
        metrics_to_floats)
    from clip_lite_torch.eval_utils import EncoderBundle
    from clip_lite_torch.ops.attention import (
        attention_backward, fused_short_attention)
    from clip_lite_torch.ops.normalize import augment_normalize_u8, normalize_u8
    from clip_lite_torch.train import train_loop
    from clip_lite_torch.utils import msgpack_io
    from clip_lite_torch.utils.checkpointing import (
        CheckpointManager, peek_iteration)

    kernels = {"attention_fwd": fused_short_attention,
               "attention_bwd": attention_backward,
               "normalize": normalize_u8,
               "augment_normalize": augment_normalize_u8}
    launches = {}

    def counted(name: str, fn, **want):
        """Run ``fn`` with every launch count set to 0 just before and read
        just after into ``launches[name]``, which must equal ``want``
        (kernels not named: 0)."""
        for k in kernels.values():
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = launches[name] = {n: k.launches for n, k in kernels.items()}
        log(f"checkpoint ({name}): launches {got}")
        if got != dict(dict.fromkeys(kernels, 0), **want):
            raise AssertionError(f"({name}) launches {got}, expected {want}")
        return out

    def loop(name, cfg, state, source, steps, manager=None, **kw):
        """train_loop with each call (PARALLEL.STEPS_PER_CALL steps) timed
        between syncs of the training stream (not of the checkpoints' side
        stream), noting whether a write was in flight as it began; returns
        the state, the records and the last batch."""
        train_step, records, last = make_scanned_train_step(cfg), [], {}

        def step(st, batch):
            torch.cuda.current_stream().synchronize()
            rec = dict(step=st.step + 1, during_write=bool(
                manager is not None and manager.in_flight))
            start = time.perf_counter()
            st, metrics = train_step(st, batch)
            values = metrics_to_floats(metrics)  # syncs the training stream
            rec["seconds"] = time.perf_counter() - start
            records.append(rec)
            last["batch"] = batch
            if not math.isfinite(values["total_loss"]):
                raise AssertionError(f"({name}) step {st.step}: {values}")
            return st, metrics

        state = train_loop(state, step, source, steps, log_every=10 ** 6,
                           manager=manager, steps_per_call=max(
                               1, cfg.PARALLEL.STEPS_PER_CALL), **kw)
        return state, records, last["batch"]

    # Bit for bit between runs: deterministic algorithms.  By default the
    # token-type embedding's gradient (all 3,840 indices 0) sums in another
    # order from run to run on the card, one ulp apart; the deterministic
    # mode has an implementation of every op of the step (no warning).
    flags = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.benchmark = False
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            cfg = Config(str(FLAGSHIP), [])
            n_layers = cfg.MODEL.TEXTUAL.NUM_HIDDEN_LAYERS
            rng = np.random.default_rng(11)
            tok = HashingTokenizer(cfg.MODEL.TEXTUAL.VOCAB_SIZE,
                                   cfg.DATA.MAX_CAPTION_LENGTH)
            crop = cfg.DATA.IMAGE_CROP_SIZE
            batches = [training_batch(rng, tok, BATCH, crop)
                       for _ in range(TRAIN_STEPS)]
            val_batches = [training_batch(rng, tok, BATCH, crop)]
            cadence = dict(eval_step=make_eval_step(cfg), val_batches=val_batches,
                           checkpoint_every=5, climax_freq=1)

            # (a) The uninterrupted run with checkpoints.
            dir_a = os.path.join(root, "a")
            kept5 = os.path.join(root, "checkpoint_5.msgpack")
            state = create_train_state(cfg, device="cuda")
            t0 = time.perf_counter()
            manager = CheckpointManager(dir_a, keep_recent=1, state=state)
            log(f"checkpoint: the manager (its device and pinned buffers) built "
                f"in {time.perf_counter() - t0} s")
            if not manager.async_writes:
                raise AssertionError("a CUDA state's manager writes "
                                     "synchronously")
            saves = []
            real = {"step": manager.step, "climax": manager.climax_step}

            def timed_save(kind):
                def save(iteration, *args, **kwargs):
                    rec = dict(kind=kind, iteration=iteration,
                               waited_for_a_write=manager.in_flight,
                               start=time.perf_counter())
                    path = real[kind](iteration, *args, **kwargs)
                    rec.update(path=os.path.basename(path),
                               blocked_s=time.perf_counter() - rec["start"])
                    saves.append(rec)
                    if kind == "step" and iteration == 5:
                        # keep_recent 1 rotates checkpoint_5 away at step 10; (b)
                        # resumes from a link to it, made once it is written.
                        manager._pending.add_done_callback(
                            lambda _: os.link(path, kept5))
                    return path
                return save

            manager.step, manager.climax_step = timed_save("step"), \
                timed_save("climax")
            t0 = time.perf_counter()
            state, steps_a, _ = counted(
                "a", lambda: loop("a", cfg, state, iter(batches), TRAIN_STEPS,
                                  manager, **cadence),
                attention_fwd=n_layers * (TRAIN_STEPS + 2),
                attention_bwd=n_layers * TRAIN_STEPS)
            wall = time.perf_counter() - t0
            for rec in saves:
                w = next(x for x in manager.written if x["done"] > rec["start"]
                         and os.path.basename(x["path"]) == rec["path"])
                rec.update(bytes=w["bytes"], host_s=w["host_s"],
                           write_s=w["write_s"],
                           until_written_s=w["done"] - rec.pop("start"))
                log(f"checkpoint (a) save: {json.dumps(rec)}")
            files = sorted(os.listdir(dir_a))
            log(f"checkpoint (a): 10 steps in {wall} s, files left {files}; "
                f"steps {json.dumps(steps_a)}")
            if [r["path"] for r in saves] != [
                    "checkpoint_5.msgpack", "climax_model_9.msgpack",
                    "checkpoint_10.msgpack", "climax_model_10.msgpack",
                    "checkpoint_10.msgpack"] or files != [
                    "checkpoint_10.msgpack", "checkpoint_best.msgpack",
                    "climax_model_10.msgpack", "climax_model_9.msgpack"]:
                raise AssertionError(f"saves {saves}, files left {files}")
            free = [r for r in saves if not r["waited_for_a_write"]]
            if not free or any(r["blocked_s"] >= r["until_written_s"] / 10
                               for r in free):
                raise AssertionError("an asynchronous save with none in flight "
                                     "held the loop for a tenth of its write")
            final_a = state_tensors(state)
            counters_a = (state.step, state.optimizer.count,
                          state.optimizer.la_count)
            live_sd = {k: v.detach().clone()
                       for k, v in state.model.state_dict().items()}
            t0 = time.perf_counter()
            sync_path = CheckpointManager(
                os.path.join(root, "sync"), async_writes=False,
                state=state).step(10)
            sync_s = time.perf_counter() - t0
            with open(sync_path, "rb") as f_sync, open(
                    os.path.join(dir_a, "checkpoint_10.msgpack"), "rb") as f_a:
                if f_sync.read() != f_a.read():
                    raise AssertionError("the async checkpoint_10 differs from a "
                                         "sync save of the same state")
            log(f"checkpoint: a sync save of the state took {sync_s} s "
                f"({os.path.getsize(sync_path)} bytes), bit for bit the async "
                "checkpoint_10")
            os.remove(sync_path)
            del state, manager
            gc.collect()
            torch.cuda.empty_cache()

            # (b) A fresh state resumed from checkpoint_5, steps 6-10.
            state = create_train_state(cfg, device="cuda")
            manager = CheckpointManager(os.path.join(root, "b"), keep_recent=1,
                                        state=state)
            t0 = time.perf_counter()
            if peek_iteration(kept5) != 5 or manager.load(kept5) != 5:
                raise AssertionError("checkpoint_5 holds another iteration")
            load_s = time.perf_counter() - t0
            log(f"checkpoint: loading checkpoint_5 ({os.path.getsize(kept5)} "
                f"bytes) into a state on the card took {load_s} s")
            state, _, _ = counted(
                "b", lambda: loop("b", cfg, state, iter(batches[5:]), TRAIN_STEPS,
                                  manager, resume_from=kept5, **cadence),
                attention_fwd=n_layers * 6, attention_bwd=n_layers * 5)
            final_b = state_tensors(state)
            counters_b = (state.step, state.optimizer.count,
                          state.optimizer.la_count)
            del state, manager
            gc.collect()
            shutil.rmtree(os.path.join(root, "b"))

            # (g) OPTIM.FUSED false: checkpoint_5 written again in the optax
            # chain's layout, resumed from there to step 10: (b)'s state.
            cfg_g = Config(str(FLAGSHIP), ["OPTIM.FUSED", False])
            state = create_train_state(cfg_g, device="cuda")
            writer = CheckpointManager(os.path.join(root, "g_chain"),
                                       async_writes=False, state=state)
            writer.load(kept5)
            chain5 = writer.step(5)
            layout = sorted(msgpack_io.read(chain5)["state"]["opt_state"])
            if layout != ["inner_state", "slow_params", "step_count"]:
                raise AssertionError(f"the chain's checkpoint holds {layout}")
            del state, writer
            state = create_train_state(cfg_g, device="cuda")
            manager = CheckpointManager(os.path.join(root, "g"), keep_recent=1,
                                        state=state)
            state, _, _ = counted(
                "g", lambda: loop("g", cfg_g, state, iter(batches[5:]),
                                  TRAIN_STEPS, manager, resume_from=chain5,
                                  **cadence),
                attention_fwd=n_layers * 6, attention_bwd=n_layers * 5)
            d_bg = distance(final_b, state_tensors(state))
            log(f"checkpoint (g): OPTIM.FUSED false, checkpoint_5 in the optax "
                f"chain's layout (opt_state {layout}, "
                f"{os.path.getsize(chain5)} bytes) resumed to step 10: max "
                f"|difference| {d_bg} from (b), resumed from the fused layout")
            if d_bg != 0.0:
                raise AssertionError("the chain layout's resume differs from "
                                     "the fused layout's")
            del state, manager
            gc.collect()
            shutil.rmtree(os.path.join(root, "g"))
            shutil.rmtree(os.path.join(root, "g_chain"))
            os.remove(kept5)

            # (c) The same 10 steps, no checkpoints.
            state = create_train_state(cfg, device="cuda")
            state, steps_c, _ = counted(
                "c", lambda: loop("c", cfg, state, iter(batches), TRAIN_STEPS),
                attention_fwd=n_layers * TRAIN_STEPS,
                attention_bwd=n_layers * TRAIN_STEPS)
            final_c = state_tensors(state)
            counters_c = (state.step, state.optimizer.count,
                          state.optimizer.la_count)
            del state
            gc.collect()

            # (f) The same 10 steps at PARALLEL.STEPS_PER_CALL 2 (5 calls of
            # two eager steps): (c)'s state bit for bit.
            cfg_f = Config(str(FLAGSHIP), ["PARALLEL.STEPS_PER_CALL", 2])
            state = create_train_state(cfg_f, device="cuda")
            state, calls_f, _ = counted(
                "f", lambda: loop("f", cfg_f, state, iter(batches),
                                  TRAIN_STEPS),
                attention_fwd=n_layers * TRAIN_STEPS,
                attention_bwd=n_layers * TRAIN_STEPS)
            d_cf = distance(final_c, state_tensors(state))
            per_call = [r["seconds"] for r in calls_f[1:]]
            log(f"checkpoint (f): {TRAIN_STEPS} steps at STEPS_PER_CALL 2, "
                f"{len(calls_f)} calls; max |difference| {d_cf} from (c)'s "
                f"one step a call; s a call (calls 2-{len(calls_f)}) "
                f"{per_call}, median {statistics.median(per_call)} against "
                f"(c)'s s a step {statistics.median(r['seconds'] for r in steps_c[2:])}")
            if d_cf != 0.0 or (state.step, state.optimizer.count) != (10, 10):
                raise AssertionError("two steps a call differ from one")
            del state
            gc.collect()
            torch.cuda.empty_cache()
            d_ab, d_ac, d_bc = (distance(final_a, final_b),
                                distance(final_a, final_c),
                                distance(final_b, final_c))
            del final_a, final_b, final_c
            log(f"checkpoint: after step 10, max |difference| over params, "
                f"BatchNorm statistics, trace and slow: resumed (b) to (a) "
                f"{d_ab}, second run (c) to (a) {d_ac}, (b) to (c) {d_bc}; "
                f"(step, count, la_count) {counters_a} {counters_b} {counters_c}")
            if not counters_a == counters_b == counters_c == (10, 10, 10):
                raise AssertionError("the counters differ")
            if d_ab > d_ac:
                raise AssertionError("the resumed run lies further from (a) than "
                                     "a second uninterrupted run")
            quiet = [r["seconds"] for r in steps_c[2:]]
            during = [r for r in steps_a if r["during_write"]]
            log(f"checkpoint: steps that began during a write "
                f"{json.dumps(during)};"
                f" (c)'s steps 3-10, no writes: {min(quiet)}-{max(quiet)} s, "
                f"median {statistics.median(quiet)}")

            # (d) EncoderBundle from the final checkpoint against the live model.
            images = val_batches[0]["image"]
            texts = captions(np.random.default_rng(12), BATCH)
            t0 = time.perf_counter()
            from_file = EncoderBundle(cfg, os.path.join(
                dir_a, "checkpoint_10.msgpack"), batch_size=BATCH, device="cuda")
            bundle_s = time.perf_counter() - t0
            live = EncoderBundle(cfg, batch_size=BATCH, state_dict=live_sd,
                                 device="cuda")
            del live_sd
            out = {}
            for name, bundle in (("d_file", from_file), ("d_live", live)):
                bundle.encode_images(images[:8])  # warm-up, not counted
                out[name] = counted(name, lambda: (
                    bundle.encode_images(images),
                    bundle.encode_texts(texts, tok)),
                    attention_fwd=n_layers)
            log(f"checkpoint (d): EncoderBundle from checkpoint_10 built in "
                f"{bundle_s} s; embeddings {out['d_file'][0].shape} "
                f"{out['d_file'][1].shape}")
            for a, b in zip(out["d_file"], out["d_live"]):
                if not (np.isfinite(a).all() and np.array_equal(a, b)):
                    raise AssertionError("the bundle from the checkpoint encodes "
                                         "otherwise than the live model")
            del from_file, live, out
            gc.collect()
            torch.cuda.empty_cache()

            # (e) The uint8 path, resumed after step 2.
            cfg_u8 = Config(str(TUNED), ["DATA.DEVICE_CACHE", True])
            cache = DeviceDataCache(
                synthetic_corpus(cfg_u8, np.random.default_rng(13), n=512),
                BATCH,
                cache_size=cfg_u8.DATA.CACHE_IMAGE_SIZE,
                crop_size=cfg_u8.DATA.IMAGE_CROP_SIZE,
                seq_buckets=cfg_u8.DATA.SEQ_BUCKETS, seed=cfg_u8.RANDOM_SEED,
                device="cuda")
            dir_e = os.path.join(root, "e")
            seen = {}
            after_2 = os.path.join(dir_e, "checkpoint_2.msgpack")
            for name, resume in (("e", None), ("e_resumed", after_2)):
                state = create_train_state(cfg_u8, device="cuda")
                inputs = []
                hook = state.model.image_encoder.register_forward_pre_hook(
                    lambda module, args: inputs.append(args[0].detach().clone()))
                manager = CheckpointManager(dir_e, keep_recent=2, state=state)
                cache.set_start(0)
                want = dict(attention_fwd=n_layers, attention_bwd=n_layers,
                            augment_normalize=1)
                if resume is None:
                    want = {k: 3 * v for k, v in want.items()}
                state, _, batch = counted(name, lambda: loop(
                    name, cfg_u8, state, cache, 3, manager, checkpoint_every=2,
                    resume_from=resume), **want)
                hook.remove()
                seen[name] = (batch, inputs[-1], state_tensors(state))
                del state, manager, inputs
                gc.collect()
            (b1, x1, s1), (b2, x2, s2) = seen["e"], seen["e_resumed"]
            same_batch = all(torch.equal(b1[k], b2[k]) for k in b1)
            same_input = torch.equal(x1, x2)
            log(f"checkpoint (e): uint8 step 3 after a resume at step 2: the "
                f"cache "
                f"batch equal {same_batch}, the augmented images the model saw "
                f"equal {same_input}; the state after step 3 at max |difference| "
                f"{distance(s1, s2)} from the uninterrupted run's")
            if not (same_batch and same_input):
                raise AssertionError("the resumed uint8 step saw another batch")
            del cache, seen
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.use_deterministic_algorithms(flags[0], warn_only=flags[1])
        torch.backends.cudnn.benchmark = flags[2]
    nondeterministic = sorted({str(w.message) for w in warned
                               if "deterministic" in str(w.message)})
    log(f"checkpoint: ops with no deterministic implementation: "
        f"{nondeterministic or 'none'}")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, sync_save_s=sync_s, load_s=load_s,
                bundle_s=bundle_s, distances=(d_ab, d_ac),
                call_s=statistics.median(per_call))


RANKS_STEPS, RANKS_TRAIN, RANKS_VAL, RANKS_TILE = 4, 256, 128, 256
# fs_tpu_tuned.yaml (global negatives, PARALLEL.ZERO1) at full width, the
# cache over ndarray records, sync BatchNorm, deterministic algorithms.
RANKS_OVERRIDES = ["MODEL.NAME", "captions", "OPTIM.BATCH_SIZE", BATCH,
                   "OPTIM.NUM_ITERATIONS", RANKS_STEPS,
                   "OPTIM.WARMUP_STEPS", 1, "DATA.DEVICE_CACHE", True,
                   "DATA.NATIVE_PIPELINE", False,
                   "MODEL.VISUAL.BN_MODE", "sync",
                   "CUDNN_DETERMINISTIC", True, "CUDNN_BENCHMARK", False]
# ZeRO-1's flat update against the replicated fused one on the same
# gradients: the clip's global norm is a sum of 1.5e8 fp32 squares taken in
# another order (ZeRO-1 sums the flat slice, the fused update per tensor
# with torch._foreach_norm), so the norms may differ by about 1e-6 of
# their size, and the clip scale and every clipped update with them; and
# p - (lr x mult) d rounds its product once against p + (-(lr x mult)) d.
# Bars: the norm within ZERO1_NORM_REL; each parameter and slow weight
# within ZERO1_UPDATE_REL of the largest update plus two ulps of the
# largest value.
ZERO1_NORM_REL, ZERO1_UPDATE_REL = 1e-5, 1e-5
# Losses across cards against one process's (see phase_ranks).
RANKS_LOSS_REL = 0.1


def write_tile_corpus(root: str, rng: np.random.Generator) -> None:
    """CLRec train and val files of RANKS_TILE-square ndarray records,
    seeded uint8 images, five captions each drawn from WORDS."""
    import os

    from clip_lite_torch.data.readers import ClRecWriter

    for split, n in (("train", RANKS_TRAIN), ("val", RANKS_VAL)):
        with ClRecWriter(os.path.join(
                root, f"coco_{split}_train_sbert2017.clrec")) as w:
            for i in range(n):
                w.append({"image_id": i, "captions": captions(rng, 5),
                          "image": rng.integers(0, 256, (RANKS_TILE,
                                                         RANKS_TILE, 3),
                                                dtype=np.uint8)})


def ranks_cli(root: str, name: str, nproc) -> subprocess.Popen:
    """Start ``python -m clip_lite_torch.train`` over the records, under
    torchrun with ``nproc`` ranks (``torch.distributed.run
    --standalone``), or alone where ``nproc`` is None; its output goes to
    ``root/<name>.out``.  :func:`ranks_result` reads the run."""
    import os

    cli = ["-m", "clip_lite_torch.train", "--config", str(TUNED),
           "--serialization-dir", os.path.join(root, name),
           "--checkpoint-every", 1000, "--log-every", 1, "--cpu-workers", 4,
           "--config-override", "DATA.ROOT", root, *RANKS_OVERRIDES]
    launcher = [] if nproc is None else [
        "-m", "torch.distributed.run", "--standalone",
        f"--nproc-per-node={nproc}"]
    cmd = [sys.executable, *launcher, *[str(a) for a in cli]]
    with open(os.path.join(root, f"{name}.out"), "w") as f:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=f,
                                stderr=subprocess.STDOUT)
    proc.t0 = time.perf_counter()
    return proc


def ranks_result(root: str, name: str, proc: subprocess.Popen) -> dict:
    """Wait for a :func:`ranks_cli` run (killed past 600 s); its per-step
    losses, the kernel launches and collectives rank 0 logged, its process
    group, its wall seconds and its last checkpoint's path.  Raises if it
    failed."""
    import glob
    import os

    from clip_lite_torch.config import Config

    try:
        rc = proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "killed at 600 s"
    wall = time.perf_counter() - proc.t0
    text = open(os.path.join(root, f"{name}.out")).read()
    if rc:
        raise AssertionError(f"ranks ({name}): exit {rc}:\n{text[-4000:]}")
    m = re.search(r"Kernel launches: (\{.*?\}); collectives: (\{.*?\})", text)
    group = re.search(r"\(process group: (\w+)\)", text)
    out = os.path.join(root, name)
    losses = [json.loads(line) for line in open(os.path.join(
        out, "metrics.jsonl"))]
    run_dir = out + Config(str(TUNED), RANKS_OVERRIDES).RUN_ID
    ckpt = glob.glob(os.path.join(glob.escape(run_dir),
                                  f"checkpoint_{RANKS_STEPS}.msgpack"))
    if not m or not group or len(ckpt) != 1:
        raise AssertionError(f"ranks ({name}): no launch line, group or "
                             f"checkpoint ({ckpt}):\n{text[-4000:]}")
    times = [float(t) for t in re.findall(r"Time/iter ([0-9.]+)s", text)]
    return dict(losses=[r for r in losses if r["split"] == "train"],
                launches=json.loads(m[1]), collectives=json.loads(m[2]),
                group=group[1], wall_s=wall, step_s=times, checkpoint=ckpt[0])


def zero1_flat_check() -> dict:
    """ZeRO-1's flat update (``parallel/zero1.py``) with one shard, over an
    NCCL group of one rank, against the replicated fused update, both from
    one state (random momentum and slow weights, past warmup, the step
    before a Lookahead sync) on one step's gradients of fs_tpu_tuned at
    full width (a batch of PARITY_BATCH)."""
    import socket

    import torch.distributed as dist

    from clip_lite_torch.config import Config
    from clip_lite_torch.data.tokenizers import HashingTokenizer
    from clip_lite_torch.engine import create_train_state
    from clip_lite_torch.factories import LRSchedulerFactory
    from clip_lite_torch.ops.layers import StepRNG
    from clip_lite_torch.parallel.collectives import COUNTS
    from clip_lite_torch.parallel.zero1 import Zero1Optimizer

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        cfg = Config(str(TUNED), ["DATA.DEVICE_CACHE", True])
        state = create_train_state(cfg, device="cuda")
        model, fused = state.model, state.optimizer
        rng = np.random.default_rng(12)
        gen = torch.Generator(device="cuda").manual_seed(12)
        tok = HashingTokenizer(cfg.MODEL.TEXTUAL.VOCAB_SIZE,
                               cfg.DATA.MAX_CAPTION_LENGTH)
        batch = training_batch(rng, tok, PARITY_BATCH,
                               cfg.DATA.IMAGE_CROP_SIZE)
        model.train()
        out = model({k: torch.as_tensor(v).cuda() for k, v in batch.items()},
                    rng=StepRNG(0, 0, "cuda"))
        out["loss"].backward()
        fused.count = cfg.OPTIM.WARMUP_STEPS
        fused.la_count = cfg.OPTIM.LOOKAHEAD.STEPS - 1
        with torch.no_grad():
            for g in fused.groups:
                for t, s_, p in zip(g.trace, g.slow, g.params):
                    t.normal_(0.0, 1e-3, generator=gen)
                    s_.copy_(p + 1e-3 * torch.randn(p.shape, generator=gen,
                                                    device="cuda"))
        zero1 = Zero1Optimizer(model, cfg, LRSchedulerFactory.from_config(cfg))
        zero1.load_jax_state(fused.jax_state(lambda d: d), lambda d: d)
        params = [p for p in model.parameters()]
        p0 = [p.detach().clone() for p in params]
        COUNTS.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        norm_z = float(zero1.step())
        zero1_s = time.perf_counter() - t0
        counts = dict(COUNTS)
        pz = [p.detach().clone() for p in params]
        slow_z = {k: v.clone() for k, v in zero1.slow_state().items()}
        with torch.no_grad():
            for p, q in zip(params, p0):
                p.copy_(q)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        norm_f = float(fused.step())
        torch.cuda.synchronize()
        fused_s = time.perf_counter() - t0
        pf = [p.detach() for p in params]
        slow_f = fused.slow_state()
        update = max(float((a - b).abs().max()) for a, b in zip(pf, p0))
        largest = max(float(a.abs().max()) for a in pf)
        ulps = 2 * largest * 2.0 ** -23
        diff = max(float((a - b).abs().max()) for a, b in zip(pz, pf))
        slow_diff = max(float((slow_z[k] - v).abs().max())
                        for k, v in slow_f.items())
        moved = sum(int((a != b).sum()) for a, b in zip(pz, pf))
        res = dict(norm_zero1=norm_z, norm_fused=norm_f,
                   norm_rel=abs(norm_z - norm_f) / norm_f, update_max=update,
                   param_max_abs_diff=diff, slow_max_abs_diff=slow_diff,
                   elements_that_differ=moved,
                   elements=sum(p.numel() for p in params),
                   zero1_step_s=zero1_s, fused_step_s=fused_s,
                   collectives=counts, backend=dist.get_backend())
        log(f"ranks: ZeRO-1's flat update (one shard, NCCL) against the "
            f"fused one: {res}")
        bar = ZERO1_UPDATE_REL * update + ulps
        if res["norm_rel"] > ZERO1_NORM_REL or diff > bar \
                or slow_diff > bar or counts != {
                    "reduce_scatter": 1, "all_reduce": 1, "all_gather": 1}:
            raise AssertionError(f"ranks: ZeRO-1 against the fused update "
                                 f"past its bars (norm {ZERO1_NORM_REL}, "
                                 f"update {bar}): {res}")
        del state, model, fused, zero1, out
        return res
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()


def phase_ranks() -> dict:
    """Multi-GPU training: the CLI under torchrun at the machine's card
    count (NCCL), against it alone; ZeRO-1's flat path on the card."""
    import filecmp
    import os
    import tempfile

    phase_t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    n_cards = torch.cuda.device_count()
    out = {"cards": n_cards}
    log(f"ranks: {n_cards} card(s); this process still holds "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB of the card")
    with tempfile.TemporaryDirectory() as root:
        write_tile_corpus(root, np.random.default_rng(14))
        # Both at once on the card: each alone is deterministic.
        procs = {"world1": ranks_cli(root, "world1", 1),
                 "plain": ranks_cli(root, "plain", None)}
        runs = {name: ranks_result(root, name, proc)
                for name, proc in procs.items()}
        w1, plain = runs["world1"], runs["plain"]
        for name, run in runs.items():
            log(f"ranks ({name}): process group {run['group']}, "
                f"{run['wall_s']} s of wall, step s {run['step_s']}, "
                f"losses {[r['total_loss'] for r in run['losses']]}, "
                f"launches {run['launches']}, collectives {run['collectives']}")
        # At a world of one the run is the single process's, bit for bit:
        # every step's metrics, and the final checkpoint (parameters,
        # BatchNorm statistics, optimizer state) byte for byte.
        same_ckpt = filecmp.cmp(w1["checkpoint"], plain["checkpoint"],
                                shallow=False)
        if w1["group"] != "nccl" or plain["group"] != "None" \
                or w1["losses"] != plain["losses"] or not same_ckpt \
                or len(w1["losses"]) != RANKS_STEPS:
            raise AssertionError(
                f"ranks: torchrun at a world of one ({w1['group']}) against "
                f"one process: losses {w1['losses']} against "
                f"{plain['losses']}, checkpoints equal {same_ckpt}")
        per_step = dict(attention_fwd=12 * RANKS_STEPS,
                        attention_bwd=12 * RANKS_STEPS,
                        augment_normalize=RANKS_STEPS)
        for name, run in runs.items():
            got = run["launches"]
            if (got["K1 attention_fwd"], got["K2 attention_bwd"],
                    got["K3 augment_normalize_u8"], got["K1 tensor cores"],
                    got["K2 tensor cores"]) != (
                    per_step["attention_fwd"], per_step["attention_bwd"],
                    per_step["augment_normalize"], per_step["attention_fwd"],
                    per_step["attention_bwd"]):
                raise AssertionError(f"ranks ({name}): launches {got}, "
                                     f"expected {per_step} a run")
        if w1["collectives"]:
            raise AssertionError(f"ranks (world1): collectives "
                                 f"{w1['collectives']} at a world of one")
        log(f"ranks: torchrun --nproc-per-node 1 (NCCL) equals the single "
            f"process bit for bit: {RANKS_STEPS} steps' metrics and "
            f"checkpoint_{RANKS_STEPS} ({os.path.getsize(w1['checkpoint'])} "
            f"bytes); NCCL collectives a step at a world of one: 0 (the step "
            f"skips them); K1/K2/K3 a run {per_step}")
        if n_cards >= 2:
            runs["world"] = many = ranks_result(
                root, "world", ranks_cli(root, "world", n_cards))
            rel = [abs(a["total_loss"] - b["total_loss"]) / abs(b["total_loss"])
                   for a, b in zip(many["losses"], plain["losses"])]
            log(f"ranks ({n_cards} ranks): losses "
                f"{[r['total_loss'] for r in many['losses']]} against one "
                f"process's {[r['total_loss'] for r in plain['losses']]}, "
                f"relative {rel}; collectives {many['collectives']} "
                f"({RANKS_STEPS} steps, the cache's build and the checkpoint's "
                f"gathers); launches {many['launches']}")
            # Not the one process's run: the loss's critics hold local
            # BatchNorm (as in JAX), which normalizes over each rank's rows,
            # so the losses differ from step 1 on (a CPU rehearsal at 4 rows
            # a rank: 0.074 at step 1).  Held within RANKS_LOSS_REL.
            if many["group"] != "nccl" or len(rel) != RANKS_STEPS or \
                    max(rel) > RANKS_LOSS_REL:
                raise AssertionError(f"ranks ({n_cards} ranks) against one "
                                     f"process: relative {rel}")
        else:
            log("ranks: one card, so no run across cards (NCCL between "
                "cards not exercised)")
        out["runs"] = {k: {kk: vv for kk, vv in v.items() if kk != "checkpoint"}
                       for k, v in runs.items()}
    out["zero1"] = zero1_flat_check()
    out["phase_s"] = time.perf_counter() - phase_t0
    log(f"ranks: phase {out['phase_s']} s")
    return out


# Phase 13, the model matrix: steps a path, the CLI's records (tiles of
# MATRIX_TILE px), and overrides put after every config's own (empty here;
# a rehearsal on the CPU shrinks the models through them).
# The first step of a path is a warm-up (cuDNN's algorithm search): the
# median is over the other three.
MATRIX_STEPS, MATRIX_TRAIN, MATRIX_VAL, MATRIX_TILE = 4, 3 * BATCH, BATCH, 256
MATRIX_SIZES: list = []
VGG16 = ["MODEL.VISUAL.NETWORK_NAME", "vgg16", "MODEL.VISUAL.FEATURE_SIZE", 1000]
WRN_40_2 = ["MODEL.VISUAL.NETWORK_NAME", "zoo::wrn_40_2",
            "MODEL.VISUAL.FEATURE_SIZE", 128, "DATA.IMAGE_CROP_SIZE", 32]
GLOVE = ["MODEL.TEXTUAL.NAME", "glove", "DATA.NAME", "glove",
         "MODEL.TEXTUAL.FEATURE_SIZE", 300]
SBERT = ["MODEL.TEXTUAL.NAME", "sbert", "DATA.NAME", "sbert"]
FINETUNE = ["MODEL.TEXTUAL.NAME", "finetune_sbert"]


def matrix_batch(cfg, rng: np.random.Generator, n: int = BATCH) -> dict:
    """Seeded uint8 images at the config's crop and the text tower's input:
    hashed caption ids, or 768-d sentence vectors in the sbert mode."""
    from clip_lite_torch.data.tokenizers import HashingTokenizer

    crop = cfg.DATA.IMAGE_CROP_SIZE
    batch = {"image": rng.integers(0, 256, (n, crop, crop, 3), dtype=np.uint8)}
    if cfg.MODEL.TEXTUAL.NAME == "sbert":
        batch["caption_encodings"] = rng.standard_normal((n, 768), np.float32)
    else:
        tok = HashingTokenizer(cfg.MODEL.TEXTUAL.VOCAB_SIZE,
                               cfg.DATA.MAX_CAPTION_LENGTH)
        enc = tok(captions(rng, n), max_length=tok.max_length)
        batch.update(input_ids=np.asarray(enc["input_ids"], np.int32),
                     attention_mask=np.asarray(enc["attention_mask"], np.int32))
    return batch


def launch_counts() -> dict:
    """Each kernel's launches by its trace range name, K1's and K2's on
    the tensor-core and key-tiled routes and K1's on the 3xTF32 routes."""
    from clip_lite_torch.ops.attention import (
        attention_backward, fused_short_attention)

    counts = {k: c.launches for k, c in kernel_counters().items()}
    counts.update(attention_fwd_tc=fused_short_attention.tc_launches,
                  attention_fwd_tf32x3=fused_short_attention.tf32x3_launches,
                  attention_fwd_tf32x3_tiled=fused_short_attention.tf32x3_tiled_launches,
                  attention_fwd_tc_tiled=fused_short_attention.tc_tiled_launches,
                  attention_bwd_tc=attention_backward.tc_launches,
                  attention_bwd_tiled=attention_backward.tiled_launches)
    return counts


def zero_launch_counts() -> None:
    from clip_lite_torch.ops.attention import (
        attention_backward, fused_short_attention)

    for c in kernel_counters().values():
        c.launches = 0
    fused_short_attention.tc_launches = attention_backward.tc_launches = 0
    fused_short_attention.tf32x3_launches = 0
    fused_short_attention.tf32x3_tiled_launches = 0
    fused_short_attention.tc_tiled_launches = attention_backward.tiled_launches = 0


def matrix_check(name: str, cfg, launches: dict, steps: int, attention: bool,
                 k3_fused: bool, sweeps: int = 0) -> None:
    """K1 and K2 a text layer a step where BERT runs (K1 too a layer a val
    batch), K3's fused pass a step on uint8 batches, nothing else; every
    K1/K2 launch on the route attention_route picks."""
    layers = cfg.MODEL.TEXTUAL.NUM_HIDDEN_LAYERS if attention else 0
    want = dict.fromkeys(kernel_counters(), 0)
    want.update({"K1 attention_fwd": layers * (steps + sweeps),
                 "K2 attention_bwd": layers * steps,
                 "K3 augment_normalize_u8": steps if k3_fused else 0})
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"matrix ({name}): launches {got}, expected {want}")
    check_routes(cfg, cfg.DATA.MAX_CAPTION_LENGTH, {
        "attention_fwd": launches["K1 attention_fwd"],
        "attention_bwd": launches["K2 attention_bwd"],
        "attention_fwd_tc": launches["attention_fwd_tc"],
        "attention_fwd_tf32x3": launches["attention_fwd_tf32x3"],
        "attention_fwd_tf32x3_tiled": launches["attention_fwd_tf32x3_tiled"],
        "attention_bwd_tc": launches["attention_bwd_tc"]})


def matrix_steps(name: str, cfg, state, rng: np.random.Generator) -> dict:
    """MATRIX_STEPS train steps of seeded batches through the engine, the
    counts set to 0 just before and read just after: each step on the host
    clock from a sync to the sync that reads its metrics, the median after
    the first, the peak memory, finite losses and grad norms."""
    from clip_lite_torch.engine import make_train_step, metrics_to_floats

    batches = [matrix_batch(cfg, rng) for _ in range(MATRIX_STEPS)]
    train_step = make_train_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    seconds, metrics = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, batch)
        metrics.append(metrics_to_floats(m))  # the step's sync
        seconds.append(time.perf_counter() - t0)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    if not all(math.isfinite(m["total_loss"]) and math.isfinite(m["grad_norm"])
               for m in metrics):
        raise AssertionError(f"matrix ({name}): {metrics}")
    out = dict(step_s=statistics.median(seconds[1:]), seconds=seconds,
               peak_mib=peak, launches=launches,
               total_loss=[m["total_loss"] for m in metrics],
               grad_norm=[m["grad_norm"] for m in metrics])
    log(f"matrix ({name}): {cfg.MODEL.VISUAL.NETWORK_NAME} + "
        f"{cfg.MODEL.TEXTUAL.NAME} at {cfg.DATA.IMAGE_CROP_SIZE} px, batch "
        f"{BATCH}, AMP {cfg.AMP}: median step {out['step_s']} s over steps "
        f"2-{MATRIX_STEPS} (host clock, each ending in a sync: {seconds}), peak "
        f"memory {peak} MiB, losses {out['total_loss']}, grad norms "
        f"{out['grad_norm']}, launches {launches}")
    return out


def matrix_vgg_parity() -> dict:
    """Phase 10a's parity for the vgg16 + BERT-12 step: from one state and
    uint8 batch at PARITY_BATCH, dropout 0 in BERT (VGG's classifier
    dropout draws alike in both, from the same StepRNG), one step through
    the kernels (K1, K2 and K3's fused pass, whose images are held against
    its composition on the same draws within FUSED_ATOL) and one through
    the plain attention given those images, in fp32, in bf16 and in bf16
    with all but the text tower in fp32.  fp32 is held at PARITY_TOL.  In
    bf16 the two steps' QKV gradients lie at cosine 0.9897 apart on an
    H100 (PERF.md, section 6), under PARITY_TOL's 0.99, yet each lies as far
    from the fp32 step as the other (cosine 0.9720 and 0.9729): two correct
    bf16 steps of this model differ that much.  So bf16 is held at
    PARITY_TOL's loss and max-rel, and, in place of its cosine, by phase
    7's floor: the kernels' step no further from the fp32 step than the
    twins', within BF16_FLOOR_FACTOR, in max-rel and in 1 - cosine."""
    import clip_lite_torch.ops.image_ops as image_ops
    from clip_lite_torch.config import Config
    from clip_lite_torch.engine import (
        create_train_state, make_train_step, metrics_to_floats)
    from clip_lite_torch.factories import OptimizerFactory

    real_augment = image_ops.augment_normalize_u8
    runs, k3_err = {}, {}
    # One model for the three kinds: AMP's compute types as built, all fp32,
    # or all but the text tower's in fp32; each step from the same start.
    cfg = Config(str(FLAGSHIP), VGG16 + MATRIX_SIZES + [
        "MODEL.TEXTUAL.DROPOUT", 0.0])
    batch = matrix_batch(cfg, np.random.default_rng(40), PARITY_BATCH)
    state = create_train_state(cfg, device="cuda")
    state_dict = {k: v.detach().clone()
                  for k, v in state.model.state_dict().items()}
    amp = {m: m.compute_dtype for m in state.model.modules()
           if hasattr(m, "compute_dtype")}
    text = set(state.model.text_encoder.modules())
    layers = state.model.text_encoder.transformer
    try:
        for kind in ("float32", "bfloat16", "text_bf16"):
            for module, dtype in amp.items():
                module.compute_dtype = (
                    dtype if kind == "bfloat16"
                    or (kind == "text_bf16" and module in text)
                    else torch.float32)
            made = []

            def recorded(images, draws, flip=True, color_jitter=True):
                made.append(real_augment(images, draws, flip, color_jitter))
                twin = image_ops.augment_reference(images, draws, flip,
                                                   color_jitter)
                k3_err[kind] = float((made[-1] - twin).abs().max())
                return made[-1]

            def replayed(images, draws, flip=True, color_jitter=True):
                return made.pop(0)

            for flag, augment in (("true", recorded), ("false", replayed)):
                state.model.load_state_dict(state_dict)
                state.optimizer = OptimizerFactory.from_config(cfg, state.model)
                state.step = 0
                for n in layers.layer_names:
                    getattr(layers, n).fused_attention = flag
                image_ops.augment_normalize_u8 = augment
                state, metrics = make_train_step(cfg)(state, batch)
                grads = [getattr(layers, n).qkv.weight.grad.float().clone()
                         for n in layers.layer_names]
                runs[kind, flag] = (metrics_to_floats(metrics), grads)
    finally:
        image_ops.augment_normalize_u8 = real_augment
        del state, layers, state_dict
        gc.collect()
        torch.cuda.empty_cache()
    log(f"matrix (a) parity: K3's fused pass against its composition on the "
        f"step's images and draws, max |difference| {k3_err} (bar "
        f"{FUSED_ATOL['own means']})")
    if max(k3_err.values()) > FUSED_ATOL["own means"]:
        raise AssertionError(f"matrix (a): K3's fused pass off its twin: "
                             f"{k3_err}")
    out = {kind: parity(runs[kind, "true"], runs[kind, "false"])
           for kind in ("float32", "bfloat16", "text_bf16")}
    for kind, got in out.items():
        log(f"matrix (a) parity {kind}, vgg16 + BERT-12 at batch "
            f"{PARITY_BATCH}, K1/K2 against the plain attention: {got} (tol "
            f"{PARITY_TOL['float32' if kind == 'float32' else 'bfloat16']})")
    floor = {(kind, flag): parity(runs[kind, flag], runs["float32", "false"])
             for kind in ("bfloat16", "text_bf16") for flag in ("true", "false")}
    for (kind, flag), got in floor.items():
        log(f"matrix (a) parity: {kind} step, FUSED_ATTENTION {flag}, against "
            f"the plain fp32 step: {got}")
    out["bf16_vs_float32"] = {f"{kind} {flag}": got
                              for (kind, flag), got in floor.items()}
    out["k3_max_abs"] = max(k3_err.values())
    if not within(out["float32"], PARITY_TOL["float32"]):
        raise AssertionError(f"matrix (a) float32: step parity fails: "
                             f"{out['float32']}")
    bar = PARITY_TOL["bfloat16"]
    for kind in ("bfloat16", "text_bf16"):
        got = out[kind]
        fused, plain = floor[kind, "true"], floor[kind, "false"]
        if (got["loss_rel"] > bar["loss"] or got["qkv_grad_rel_max"] > bar["rel"]
                or fused["qkv_grad_rel_max"]
                > BF16_FLOOR_FACTOR * plain["qkv_grad_rel_max"]
                or 1 - fused["qkv_grad_cos_min"]
                > BF16_FLOOR_FACTOR * (1 - plain["qkv_grad_cos_min"])):
            raise AssertionError(
                f"matrix (a) {kind}: the step through the kernels is off the "
                f"twins' ({got}) or lies more than {BF16_FLOOR_FACTOR}x as far "
                f"from the fp32 step ({fused} against {plain})")
    return out


def write_matrix_records(root: str, mode: str,
                         rng: np.random.Generator) -> None:
    """CLRec train and val files of MATRIX_TILE-square ndarray records for
    the ``mode`` datasets, five captions each drawn from WORDS, and COCO's
    caption annotations of the train split."""
    import os

    from clip_lite_torch.data.readers import ClRecWriter

    anns = []
    for split, n in (("train", MATRIX_TRAIN), ("val", MATRIX_VAL)):
        with ClRecWriter(os.path.join(
                root, f"coco_{split}_{mode}2017.clrec")) as w:
            for i in range(n):
                caps = captions(rng, 5)
                if split == "train":
                    anns += [{"image_id": i, "id": 5 * i + j, "caption": c}
                             for j, c in enumerate(caps)]
                w.append({"image_id": i, "captions": caps,
                          "image": rng.integers(0, 256, (MATRIX_TILE,
                                                         MATRIX_TILE, 3),
                                                dtype=np.uint8)})
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    with open(os.path.join(root, "annotations", "captions_train2017.json"),
              "w") as f:
        json.dump({"annotations": anns}, f)


def matrix_glove_cli(root: str) -> dict:
    """(b) ``python -m clip_lite_torch.train`` in the glove mode: the word
    dictionary from the port's generate_word_dict over the records'
    annotations, the table at GloVe's 400,002 x 300, ResNet-50, the host
    loader over ndarray records (float32 batches: it normalizes on the
    host, so K3 has no launch here), MATRIX_STEPS steps and the final
    checkpoint.  Counts set to 0 just before and read just
    after."""
    import argparse
    import os

    import clip_lite_torch.train as cli
    from clip_lite_torch.config import Config
    from clip_lite_torch.scripts import generate_word_dict

    write_matrix_records(root, "glove", np.random.default_rng(41))
    word_dict = generate_word_dict.main(argparse.Namespace(
        coco_root=root, splits=["train"], glove_path=None, min_count=1,
        output=os.path.join(root, "word_dict.json")))
    overrides = ["MODEL.NAME", "captions", "DATA.ROOT", root,
                 "OPTIM.BATCH_SIZE", BATCH, "OPTIM.NUM_ITERATIONS",
                 MATRIX_STEPS, "OPTIM.WARMUP_STEPS", 1, *GLOVE,
                 "MODEL.TEXTUAL.WORD_DICT_PATH",
                 os.path.join(root, "word_dict.json"), *MATRIX_SIZES]
    args = cli.parser.parse_args([str(a) for a in (
        "--config", FLAGSHIP, "--serialization-dir",
        os.path.join(root, "glove_run"), "--checkpoint-every", 10 ** 6,
        "--log-every", 1, "--cpu-workers", os.cpu_count() or 1,
        "--config-override", *overrides)])
    cfg = Config(str(FLAGSHIP), overrides)
    real_make_step = cli.make_train_step
    seconds, tokens = [], []

    def make_step(c):
        step = real_make_step(c)

        def timed(state, batch):
            tokens.append(int(batch["caption_tokens"].max()))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            return state, metrics
        return timed

    cli.make_train_step = make_step
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        state = cli.main(args)
        torch.cuda.synchronize()
        launches = launch_counts()
    finally:
        cli.make_train_step = real_make_step
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    metrics = [json.loads(line) for line in open(os.path.join(
        root, "glove_run", "metrics.jsonl"))]
    table = state.model.text_encoder.embedding.weight
    if (tuple(table.shape) != (400002, 300) or state.step != MATRIX_STEPS
            or not all(math.isfinite(m["total_loss"]) for m in metrics)
            or min(tokens) <= 3):  # ids above the specials: real words
        raise AssertionError(f"matrix (b): table {tuple(table.shape)}, step "
                             f"{state.step}, largest ids {tokens}, metrics "
                             f"{metrics}")
    out = dict(step_s=statistics.median(seconds[1:]), seconds=seconds,
               peak_mib=peak, launches=launches, words=len(word_dict),
               total_loss=[m["total_loss"] for m in metrics
                           if m["split"] == "train"],
               grad_norm=[m["grad_norm"] for m in metrics
                          if m["split"] == "train"])
    log(f"matrix (b): the CLI, resnet50 + glove (400,002 x 300, a word "
        f"dictionary of {len(word_dict)} entries), batch {BATCH}, host "
        f"loader: median step {out['step_s']} s over steps 2-{MATRIX_STEPS} "
        f"(host clock, each from a sync to a sync, the loader's threads "
        f"running beside it: {seconds}), peak memory {peak} "
        f"MiB, metrics {json.dumps(metrics)}, launches {launches}")
    del state
    return out


def matrix_pretrained_files(root: str, cfg) -> tuple:
    """A seeded ResNet of the config (ResNet-50) in torchvision's layout
    (``.pth``) and a seeded BERT of its text tower (BERT-base) in Hugging
    Face's (``.pt``, wrapped in ``state_dict``), each made by the port's
    own export of a seeded tower."""
    import os

    from clip_lite_torch.models.bert import BertModel
    from clip_lite_torch.models.image_encoder import torchvision_resnet_state_dict
    from clip_lite_torch.models.pretrained import export_hf_bert_state_dict
    from clip_lite_torch.models.resnet import RESNETS
    from clip_lite_torch.ops.layers import init_weights

    vis_cfg, txt_cfg = cfg.MODEL.VISUAL, cfg.MODEL.TEXTUAL
    h = txt_cfg.HIDDEN_SIZE
    gen = torch.Generator().manual_seed(42)
    tower = init_weights(RESNETS[vis_cfg.NETWORK_NAME](width=vis_cfg.WIDTH), gen)
    with torch.no_grad():
        for b in tower.buffers():
            b.uniform_(0.5, 1.5, generator=gen)
    vis = os.path.join(root, "resnet50_torchvision.pth")
    torch.save({k: torch.from_numpy(v) for k, v in
                torchvision_resnet_state_dict(tower).items()}, vis)
    txt = os.path.join(root, "bert_base_hf.pt")
    torch.save({"state_dict": export_hf_bert_state_dict(init_weights(BertModel(
        vocab_size=txt_cfg.VOCAB_SIZE, hidden_size=h, num_heads=max(1, h // 64),
        intermediate_size=4 * h, num_hidden_layers=txt_cfg.NUM_HIDDEN_LAYERS),
        gen))}, txt)
    return vis, txt


def phase_matrix() -> dict:
    """Phase 13: the rest of the model matrix on the card at full width,
    AMP bf16, batch 128, MATRIX_STEPS steps each on seeded uint8 batches
    (K3's fused pass a step): (a) vgg16 at 224 px with the flagship BERT-12
    at S = 30, then its kernels' step against the twins' (phase 10a's
    parity); (b) the
    glove mode through the CLI; (c) the sbert mode (768-d
    caption_encodings) with ResNet-50; (d) finetune_sbert, ResNet-50 and
    BERT-base loaded by apply_pretrained_weights from seeded torchvision-
    and HF-layout files, checked equal to the files' tensors on the card
    before the first step; (e) zoo::wrn_40_2 at 32 px with BERT-12."""
    import shutil
    import tempfile

    from clip_lite_torch.config import Config
    from clip_lite_torch.engine import create_train_state
    from clip_lite_torch.factories import OptimizerFactory
    from clip_lite_torch.models import pretrained

    phase_t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_matrix_")
    try:
        # (a) vgg16 + BERT-12.
        cfg = Config(str(FLAGSHIP), VGG16 + MATRIX_SIZES)
        state = create_train_state(cfg, device="cuda")
        if state.model.image_encoder.feature_size != 1000:
            raise AssertionError("vgg16 emits its classifier's 1000 features")
        out["a"] = matrix_steps("a", cfg, state, np.random.default_rng(43))
        matrix_check("a", cfg, out["a"]["launches"], MATRIX_STEPS, True, True)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        out["a"]["parity"] = matrix_vgg_parity()

        # (b) glove through the CLI.
        out["b"] = matrix_glove_cli(root)
        matrix_check("b", Config(str(FLAGSHIP), GLOVE + MATRIX_SIZES),
                     out["b"]["launches"], MATRIX_STEPS, False, False)
        gc.collect()
        torch.cuda.empty_cache()

        # (c) sbert: precomputed sentence vectors.
        cfg = Config(str(FLAGSHIP), SBERT + MATRIX_SIZES)
        state = create_train_state(cfg, device="cuda")
        out["c"] = matrix_steps("c", cfg, state, np.random.default_rng(44))
        matrix_check("c", cfg, out["c"]["launches"], MATRIX_STEPS, False, True)
        del state
        gc.collect()
        torch.cuda.empty_cache()

        # (d) finetune_sbert from local files.
        cfg = Config(str(FLAGSHIP), FINETUNE + MATRIX_SIZES)
        vis, txt = matrix_pretrained_files(root, cfg)
        cfg = Config(str(FLAGSHIP), FINETUNE + MATRIX_SIZES + [
            "MODEL.VISUAL.PRETRAINED", True, "MODEL.VISUAL.PRETRAINED_PATH", vis,
            "MODEL.TEXTUAL.PRETRAINED", True,
            "MODEL.TEXTUAL.PRETRAINED_PATH", txt])
        state = create_train_state(cfg, device="cuda")
        t0 = time.perf_counter()
        pretrained.apply_pretrained_weights(state.model, cfg)
        state.optimizer = OptimizerFactory.from_config(cfg, state.model)
        load_s = time.perf_counter() - t0
        files = {"image_encoder.backbone": pretrained.import_torch_resnet_state_dict(
                     pretrained.load_torch_state_dict(vis)),
                 "text_encoder.transformer": pretrained.import_hf_bert_state_dict(
                     pretrained.load_torch_state_dict(txt),
                     cfg.MODEL.TEXTUAL.NUM_HIDDEN_LAYERS)}
        on_card = state.model.state_dict()
        unequal = [f"{prefix}.{k}" for prefix, sd in files.items()
                   for k, t in sd.items()
                   if not torch.equal(on_card[f"{prefix}.{k}"].cpu(), t)]
        n_tensors = sum(len(sd) for sd in files.values())
        log(f"matrix (d): apply_pretrained_weights loaded {n_tensors} tensors "
            f"(ResNet-50 torchvision, BERT-base HF) in {load_s} s; on the card "
            f"{n_tensors - len(unequal)} of them equal the files'")
        if unequal or not n_tensors:
            raise AssertionError(f"matrix (d): {len(unequal)} tensors differ "
                                 f"from the files: {unequal[:5]}")
        del files, on_card
        out["d"] = matrix_steps("d", cfg, state, np.random.default_rng(45))
        out["d"]["tensors_loaded"] = n_tensors
        matrix_check("d", cfg, out["d"]["launches"], MATRIX_STEPS, True, True)
        del state
        gc.collect()
        torch.cuda.empty_cache()

        # (e) a zoo tower at its CIFAR input.
        cfg = Config(str(FLAGSHIP), WRN_40_2 + MATRIX_SIZES)
        state = create_train_state(cfg, device="cuda")
        out["e"] = matrix_steps("e", cfg, state, np.random.default_rng(46))
        matrix_check("e", cfg, out["e"]["launches"], MATRIX_STEPS, True, True)
        del state
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"matrix: phase 13 in {time.perf_counter() - phase_t0} s")
    return out


CLIP_ITEMS = 256  # phase 14's images and captions, encoded at BATCH
CLIP_TOL = 1e-5  # the embeddings through K1 against the plain attention
# openai/clip-vit-large-patch14's config.json, where it differs from the
# defaults of models/clip.py (clip-vit-base-patch32's widths).
VIT_L14 = {"projection_dim": 768,
           "text_config": dict(hidden_size=768, intermediate_size=3072,
                               num_hidden_layers=12, num_attention_heads=12),
           "vision_config": dict(hidden_size=1024, intermediate_size=4096,
                                 num_hidden_layers=24, num_attention_heads=16,
                                 patch_size=14)}
TF32_PEAK_OPS = 495e12  # dense, per second (the H100 SXM data sheet)


def write_clip_dir(path: str, rng: np.random.Generator, config=None) -> dict:
    """A seeded CLIP directory in what transformers' FlaxCLIPModel and
    CLIPTokenizerFast read: ``config.json`` (``config``'s
    ``projection_dim``, ``text_config`` and ``vision_config`` over the
    defaults, openai/clip-vit-base-patch32's published widths: vision 768
    wide, 12 layers, 12 heads, patch 32 at 224 px; text 512 wide, 12
    layers, 8 heads, 77 positions, vocab 49,408; projection 512),
    ``flax_model.msgpack`` (N(0, 0.02) weights in Flax's layout, written by
    the port's msgpack writer), a synthetic byte-level ``vocab.json`` and
    ``merges.txt`` (the 512 byte symbols, 48,894 merges of letter runs,
    then the start and end tokens at 49,406 and 49,407) and
    ``special_tokens_map.json``.  Returns the directory's config."""
    import os

    from clip_lite_torch.data.tokenizers import bytes_to_unicode
    from clip_lite_torch.models.clip import (
        PROJECTION_DIM, TEXT_DEFAULTS, VISION_DEFAULTS)
    from clip_lite_torch.utils import msgpack_io

    config = config or {}
    text = {**TEXT_DEFAULTS, **config.get("text_config", {})}
    vision = {**VISION_DEFAULTS, **config.get("vision_config", {})}
    proj = config.get("projection_dim", PROJECTION_DIM)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "clip", "projection_dim": proj,
                   "text_config": config.get("text_config", {}),
                   "vision_config": config.get("vision_config", {})}, f)

    def w(*shape, scale=0.02):
        return (rng.standard_normal(shape, dtype=np.float32) * scale)

    def dense(n_in, n_out, bias=True):
        out = {"kernel": w(n_in, n_out)}
        if bias:
            out["bias"] = np.zeros(n_out, np.float32)
        return out

    def norm(d):
        return {"scale": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)}

    def encoder(cfg):
        d, inner = cfg["hidden_size"], cfg["intermediate_size"]
        return {"layers": {str(i): {
            "self_attn": {p: dense(d, d) for p in ("q_proj", "k_proj",
                                                   "v_proj", "out_proj")},
            "layer_norm1": norm(d), "layer_norm2": norm(d),
            "mlp": {"fc1": dense(d, inner), "fc2": dense(inner, d)}}
            for i in range(cfg["num_hidden_layers"])}}

    dt, dv, p = text["hidden_size"], vision["hidden_size"], vision["patch_size"]
    n_pos = (vision["image_size"] // p) ** 2 + 1
    params = {
        "text_model": {
            "embeddings": {
                "token_embedding": {"embedding": w(text["vocab_size"], dt)},
                "position_embedding": {"embedding": w(
                    text["max_position_embeddings"], dt)}},
            "encoder": encoder(text), "final_layer_norm": norm(dt)},
        "vision_model": {
            "embeddings": {"class_embedding": w(dv),
                           "patch_embedding": {"kernel": w(p, p, 3, dv)},
                           "position_embedding": {"embedding": w(n_pos, dv)}},
            "pre_layrnorm": norm(dv), "encoder": encoder(vision),
            "post_layernorm": norm(dv)},
        "text_projection": dense(dt, proj, bias=False),
        "visual_projection": dense(dv, proj, bias=False),
        "logit_scale": np.asarray(2.6592, np.float32)}
    msgpack_io.write(os.path.join(path, "flax_model.msgpack"), params)

    chars = list(bytes_to_unicode().values())
    tokens = chars + [c + "</w>" for c in chars]
    letters, merges, frontier = "abcdefghijklmnopqrstuvwxyz", [], [""]
    n_merges = text["vocab_size"] - len(tokens) - 2
    while len(merges) < n_merges:
        grown = []
        for a in (frontier if frontier != [""] else letters):
            for b in letters:
                for tail in (b, b + "</w>"):
                    if len(merges) < n_merges:
                        merges.append((a, tail))
                        grown.append(a + tail)
        frontier = [t for t in grown if not t.endswith("</w>")]
    tokens += [a + b for a, b in merges] + ["<|startoftext|>", "<|endoftext|>"]
    vocab = {t: i for i, t in enumerate(tokens)}
    if len(vocab) != text["vocab_size"]:
        raise AssertionError(f"synthetic vocab of {len(vocab)} tokens")
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    with open(os.path.join(path, "special_tokens_map.json"), "w") as f:
        json.dump({"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
                   "pad_token": "<|endoftext|>",
                   "unk_token": "<|endoftext|>"}, f)
    return dict(text=text, vision=vision, projection_dim=proj, n_params=sum(
        x.size for x in _leaves(params)))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield np.asarray(tree)


def write_clip_coco(root: str, rng: np.random.Generator) -> str:
    """A COCO retrieval tree of CLIP_ITEMS seeded 320 x 256 JPEGs, one
    caption each (captions of 3-35 words, some over 77 tokens)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    coco = os.path.join(root, "coco")
    os.makedirs(os.path.join(coco, "val2017"))
    os.makedirs(os.path.join(coco, "annotations"))
    texts = captions(rng, CLIP_ITEMS)
    with open(os.path.join(coco, "annotations", "captions_val2017.json"),
              "w") as f:
        json.dump({"annotations": [{"image_id": i + 1, "caption": c}
                                   for i, c in enumerate(texts)]}, f)
    yy, xx = np.mgrid[0:256, 0:320].astype(np.float32)
    params = [(rng.uniform(0.01, 0.08, 6), rng.uniform(0, 6, 3))
              for _ in range(CLIP_ITEMS)]

    def save(i):
        f, ph = params[i]
        img = np.stack([np.sin(xx * f[c] + ph[c]) * np.cos(yy * f[3 + c])
                        for c in range(3)], -1)
        Image.fromarray(((img + 1) * 127.5).astype(np.uint8)).save(
            os.path.join(coco, "val2017", f"{i + 1:012d}.jpg"), "JPEG",
            quality=90)

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        list(pool.map(save, range(CLIP_ITEMS)))
    return coco


# K1's counters by route, as phase 14 reads them.
K1_ROUTE_COUNTERS = {"all": "launches", "tensor_core": "tc_launches",
                     "tf32x3": "tf32x3_launches",
                     "tf32x3_tiled": "tf32x3_tiled_launches",
                     "tensor_core_tiled": "tc_tiled_launches"}


def k1_route_counts() -> dict:
    from clip_lite_torch.ops.attention import fused_short_attention

    return {k: getattr(fused_short_attention, c)
            for k, c in K1_ROUTE_COUNTERS.items()}


def clip_k1_row(name: str, qkv: torch.Tensor, bias: torch.Tensor,
                nh: int, route: str = "tf32x3", cuda_core: bool = True) -> dict:
    """K1 at one of the CLIP towers' shapes, fp32, on ``route`` (3xTF32,
    or the key-tiled 3xTF32 above S = 80): against its plain version
    (TOLS) and within four times the plain version's distance from the
    float64 evaluation plus 2^-21 of the output's size (both distances
    kept); its times as a caller pays them and on the device alone, with
    ``cuda_core`` each beside the CUDA-core kernel's on the same inputs in
    turns (A B B A); the host's enqueue, the plain version's and
    ``scaled_dot_product_attention``'s times (with the full bias as its
    float mask, or no mask for the zero key bias), and the bound: bytes
    at the memory rate against the products, on the 3xTF32 route at
    fp32's CUDA-core peak, on the key-tiled one as three
    TF32 products at the TF32 peak."""
    from clip_lite_torch.ops.attention import (
        _launch_fwd, attention_forward, attention_reference)

    b, s, three_h = qkv.shape
    h, hd = three_h // 3, 64
    full = bias.ndim == 4
    before = k1_route_counts()[route]
    out = attention_forward(qkv, bias, nh)
    if k1_route_counts()[route] != before + 1:
        raise AssertionError(f"K1 {name}: not on the {route} route")
    ref = attention_reference(qkv, bias, nh)
    err = (out - ref).abs().max().item()
    if not err <= TOLS[torch.float32]["atol"]:
        raise AssertionError(f"K1 {name}: max|kernel-plain| {err}")
    exact = float64_attention(qkv, bias, qkv.new_zeros(b, s, h), nh, 0.0,
                              None)[0]
    f64 = {k: (x.double() - exact).abs().max().item()
           for k, x in (("kernel", out), ("plain", ref))}
    floor = 2.0 ** -21 * exact.abs().max().item()
    if f64["kernel"] > 4.0 * f64["plain"] + floor:
        raise AssertionError(f"K1 {name}: distance from float64 {f64}")
    del out, ref, exact
    copies = l2_spilling_copies(qkv, bias)

    def fwd(x, m):
        return attention_forward(x, m, nh)

    def cuda_core_kernel(x, m):
        return _launch_fwd(x, m, nh, 0.0, 0, None, "cuda_core")

    def library(x, m):
        q, k, v = x.view(b, s, 3, nh, hd).permute(2, 0, 3, 1, 4)
        return F.scaled_dot_product_attention(q, k, v,
                                              attn_mask=m if full else None)

    turns = (fwd, cuda_core_kernel, cuda_core_kernel, fwd) if cuda_core \
        else (fwd, fwd)
    t = [time_ms(f, copies) for f in turns]
    d = [device_ms(f, copies) for f in turns]
    n_bytes = qkv.nbytes + bias.nbytes + b * s * h * 4
    n_ops = 4 * b * nh * s * s * hd  # two products, 2 operations a MAC
    if route == "tf32x3":
        least = bound(n_bytes, n_ops, torch.float32)
    else:
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, 3 * n_ops / TF32_PEAK_OPS
        least = dict(bound_ms=1e3 * max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations",
                     bytes_ms=1e3 * t_bytes, operations_ms=1e3 * t_ops)
    row = dict(shape=[b, s, three_h], heads=nh, k1_route=route,
               bias="full" if full else "key", max_abs_err=err,
               float64_err=f64, ms=(t[0] + t[-1]) / 2,
               ms_device=(d[0] + d[-1]) / 2,
               host_ms=enqueue_ms(fwd, copies),
               plain_ms=time_ms(lambda x, m: attention_reference(x, m, nh),
                                copies),
               library_ms=time_ms(library, copies),
               library_ms_device=device_ms(library, copies),
               bytes=n_bytes, fp32_operations=n_ops, **least)
    if cuda_core:
        row.update(ms_cuda_core=(t[1] + t[2]) / 2,
                   ms_cuda_core_device=(d[1] + d[2]) / 2)
    log(f"K1 {name} fp32 at qkv {tuple(qkv.shape)}, {nh} heads, "
        f"{row['bias']} bias: {json.dumps(row)}")
    del copies
    return row


def clip_leg(name: str, root: str, clip_dir: str, coco: str, cfg: dict,
             routes: dict) -> dict:
    """One CLIP directory through ``python -m clip_lite_torch.retrieval
    --weight-init clip`` as the CLI runs it, batch BATCH, the counts set
    to 0 just before and read just after; K1 counted by encoder and route
    (``routes``: the route of each tower's every layer and batch); finite
    unit-norm embeddings; the same model through the plain attention on
    the same inputs within CLIP_TOL; then the towers alone.  Returns the
    launches, recalls, errors, rates and the bundle's tokens."""
    import os

    from clip_lite_torch import retrieval
    from clip_lite_torch.models.clip import ClipLayer
    from clip_lite_torch.ops.attention import fused_short_attention

    t_leg = time.perf_counter()
    bundle_cls = retrieval.ClipComparisonBundle
    real = {n: getattr(bundle_cls, n)
            for n in ("encode_texts", "encode_image_batches")}
    seen = {}

    def recording(encoder):
        def wrapped(self, data, *args):
            torch.cuda.synchronize()
            before, t0 = k1_route_counts(), time.perf_counter()
            if encoder == "encode_image_batches":
                data = list(data)  # the loader's batches, kept for the twin
            out = real[encoder](self, data, *args)
            torch.cuda.synchronize()
            seen[encoder] = dict(
                out=out, data=data, bundle=self,
                seconds=time.perf_counter() - t0,
                launches={k: n - before[k] for k, n in k1_route_counts().items()})
            return out
        return wrapped

    try:
        for n in real:
            setattr(bundle_cls, n, recording(n))
        args = retrieval.parser.parse_args([str(a) for a in (
            "--serialization-dir", os.path.join(root, f"out-{name}"),
            "--cpu-workers", os.cpu_count() or 1, "--weight-init", "clip",
            "--checkpoint-path", clip_dir, "--batch-size", BATCH,
            "--config-override", "DATA.ROOT", coco)])
        for c in K1_ROUTE_COUNTERS.values():
            setattr(fused_short_attention, c, 0)
        t0 = time.perf_counter()
        recalls = retrieval.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = k1_route_counts()
    finally:
        for n, fn in real.items():
            setattr(bundle_cls, n, fn)
    text, image = seen["encode_texts"], seen["encode_image_batches"]
    batches = math.ceil(CLIP_ITEMS / BATCH)
    by_encoder = {"text": text["launches"], "vision": image["launches"]}
    log(f"clip ({name}): the CLI in {wall} s: {json.dumps(recalls)}; K1 "
        f"launches by route {launches}, by encoder {by_encoder}; encodes (with "
        f"the loader's JPEG decode for the images) {text['seconds']} s and "
        f"{image['seconds']} s")
    want = {}
    for tower, (route, seq) in routes.items():
        n = cfg[tower]["num_hidden_layers"] * batches
        want[tower] = dict(dict.fromkeys(K1_ROUTE_COUNTERS, 0),
                           **{"all": n, route: n})
    total = {k: want["text"][k] + want["vision"][k] for k in K1_ROUTE_COUNTERS}
    if by_encoder != want or launches != total:
        raise AssertionError(
            f"clip ({name}): K1 launches {launches}, by encoder {by_encoder}; "
            f"expected {want} (routes and lengths {routes})")
    dim = cfg["projection_dim"]
    for tower, emb in (("text", text["out"]), ("image", image["out"])):
        norm_err = float(np.abs(np.linalg.norm(emb, axis=1) - 1).max())
        if emb.shape != (CLIP_ITEMS, dim) or not np.isfinite(emb).all() \
                or norm_err > 1e-5:
            raise AssertionError(f"clip ({name}) {tower} embeddings "
                                 f"{emb.shape}, norms off 1 by {norm_err}")
    if not all(0.0 <= v <= 100.0 for v in recalls.values()):
        raise AssertionError(f"clip ({name}) recalls {recalls}")

    # The same model through the plain attention, on the same inputs.
    bundle = text["bundle"]
    layers = [m for m in bundle.model.modules() if isinstance(m, ClipLayer)]
    for layer in layers:
        layer.fused_attention = "false"
    plain = {"text": bundle.encode_texts(text["data"]),
             "image": bundle.encode_image_batches(image["data"])}
    for layer in layers:
        layer.fused_attention = "auto"
    errors = {k: float(np.abs(plain[k] - seen[n]["out"]).max())
              for k, n in (("text", "encode_texts"),
                           ("image", "encode_image_batches"))}
    log(f"clip ({name}): max |K1 - plain| over the unit-norm embeddings "
        f"{errors} (tol {CLIP_TOL})")
    if max(errors.values()) > CLIP_TOL:
        raise AssertionError(f"clip ({name}) embeddings: {errors}")

    # The towers alone: images on the card, captions tokenized.
    model = bundle.model
    images = torch.cat([torch.as_tensor(b["image"]) for b in image["data"]]
                       ).to("cuda", torch.float32)
    enc = bundle.tokenizer(text["data"])
    ids = torch.from_numpy(enc["input_ids"]).cuda()
    mask = torch.from_numpy(enc["attention_mask"]).cuda()
    rates = {}
    with torch.no_grad():
        for rate, fn in (
                ("images_per_s", lambda i: model.get_image_features(
                    images[i:i + BATCH])),
                ("captions_per_s", lambda i: model.get_text_features(
                    ids[i:i + BATCH], mask[i:i + BATCH]))):
            fn(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                for i in range(0, CLIP_ITEMS, BATCH):
                    fn(i)
            torch.cuda.synchronize()
            rates[rate] = 3 * CLIP_ITEMS / (time.perf_counter() - t0)
    log(f"clip ({name}): the towers alone at batch {BATCH}, fp32: {rates}; "
        f"the leg in {time.perf_counter() - t_leg} s")
    out = dict(launches=launches, by_encoder=by_encoder, recalls=recalls,
               errors=errors, rates=rates, mask=mask[:BATCH].clone())
    del seen, text, image, bundle, model, images, layers
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_clip() -> dict:
    """Phase 14: ``python -m clip_lite_torch.retrieval --weight-init clip``
    over a COCO tree of CLIP_ITEMS images and captions, batch BATCH, on two
    seeded CLIP directories: ViT-B/32's widths (K1 on the 3xTF32 route at
    S = 50 and 77), then ViT-L/14's (the key-tiled route at S = 257 in
    the vision tower, the 3xTF32 route at 77 in the text tower); then K1
    at the towers' shapes, and on the key-tiled route at ViT-B/16's,
    ViT-L/14's and ViT-L/14-336's vision shapes."""
    import os
    import shutil
    import tempfile

    from clip_lite_torch.models.clip import text_bias

    phase_t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_clip_")
    legs, rows = {}, {}
    try:
        rng = np.random.default_rng(14)
        t0 = time.perf_counter()
        coco = write_clip_coco(root, rng)
        log(f"clip: a COCO tree of {CLIP_ITEMS} JPEGs written in "
            f"{time.perf_counter() - t0} s")
        for name, config, routes in (
                ("vit-b32", None, {"text": ("tf32x3", 77),
                                   "vision": ("tf32x3", 50)}),
                ("vit-l14", VIT_L14, {"text": ("tf32x3", 77),
                                      "vision": ("tf32x3_tiled", 257)})):
            t0 = time.perf_counter()
            clip_dir = os.path.join(root, f"clip-{name}")
            cfg = write_clip_dir(clip_dir, rng, config)
            log(f"clip ({name}): a seeded CLIP directory ({cfg['n_params']} "
                "parameters, "
                f"{os.path.getsize(os.path.join(clip_dir, 'flax_model.msgpack'))}"
                f" bytes of Flax msgpack) written in {time.perf_counter() - t0} s")
            legs[name] = clip_leg(name, root, clip_dir, coco, cfg, routes)
            shutil.rmtree(clip_dir, ignore_errors=True)

        # K1 at the towers' shapes, on seeded inputs.
        g = torch.Generator(device="cuda").manual_seed(14)
        vision_qkv = torch.randn(BATCH, 50, 3 * 768, device="cuda", generator=g)
        text_qkv = torch.randn(BATCH, 77, 3 * 512, device="cuda", generator=g)
        rows["clip_vision"] = clip_k1_row(
            "clip vision", vision_qkv, torch.zeros(BATCH, 50, device="cuda"), 12)
        rows["clip_text"] = clip_k1_row(
            "clip text", text_qkv, text_bias(legs["vit-b32"]["mask"], 8), 8)
        del vision_qkv, text_qkv
        # The key-tiled route at the larger vision towers' shapes, each with
        # its zero key bias; the CUDA-core kernel beside it at 197 (it stops
        # at 256).
        for key, s, width, nh in (("vit_b16", 197, 768, 12),
                                  ("vit_l14", 257, 1024, 16),
                                  ("vit_l14_336", 577, 1024, 16)):
            qkv = torch.randn(BATCH, s, 3 * width, device="cuda", generator=g)
            rows[key] = clip_k1_row(
                f"{key} vision", qkv, torch.zeros(BATCH, s, device="cuda"), nh,
                route="tf32x3_tiled", cuda_core=s <= 256)
            del qkv
            gc.collect()
            torch.cuda.empty_cache()
        b32, l14 = legs["vit-b32"]["by_encoder"], legs["vit-l14"]["by_encoder"]
        rows["clip_vision"]["launches_at_shape"] = b32["vision"]["tf32x3"]
        rows["clip_text"]["launches_at_shape"] = b32["text"]["tf32x3"]
        rows["vit_l14"]["launches_at_shape"] = l14["vision"]["tf32x3_tiled"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"clip: phase 14 in {time.perf_counter() - phase_t0} s")
    return dict(
        launches=sum(leg["launches"]["all"] for leg in legs.values()),
        tf32x3_launches=sum(leg["launches"]["tf32x3"] for leg in legs.values()),
        tf32x3_tiled_launches=sum(leg["launches"]["tf32x3_tiled"]
                                  for leg in legs.values()),
        legs={k: {f: leg[f] for f in ("launches", "by_encoder", "recalls",
                                      "errors", "rates")}
              for k, leg in legs.items()},
        rows=rows)


# Phase 15: the flagship at DATA.MAX_CAPTION_LENGTH 512 (BERT's 512
# positions), captions of 257-512 tokens; training LONG_STEPS steps of
# BATCH, MPNet LONG_MPNET_STEPS steps of LONG_MPNET_BATCH (its full
# (B, 12, 512, 512) bias is 1.61 GB at batch 128, and its dbias as much).
LONG_SEQ = 512
LONG = ["DATA.MAX_CAPTION_LENGTH", LONG_SEQ]
LONG_STEPS, LONG_MPNET_STEPS, LONG_MPNET_BATCH = 4, 2, 64
# Phase 15's bf16 step parity.  At 512 tokens two correct bf16 steps lie
# far apart: the plain attention's bf16 step lies at max-rel 1.10 and
# cosine 0.570 from the plain fp32 step, the step through K1/K2 at 1.13
# and 0.575, and the two bf16 steps at 0.80 and 0.848 from each other
# (call F20c, NVIDIA H100 80GB HBM3, 700 W; at 30 tokens phase 7 reads
# 0.147 and 0.995).  So PARITY_TOL's bf16 max-rel and cosine, set at 30
# tokens, cannot tell a fault from bf16's rounding there: the bf16 step is
# held by PARITY_TOL's loss, and by phase 7's floor against the fp32 step
# (BF16_FLOOR_FACTOR), with the whole model in bf16 and with the image
# tower in fp32.  The fp32 step is held at PARITY_TOL.
LONG_PARITY_TOL = {"bfloat16": dict(PARITY_TOL["bfloat16"], rel=math.inf,
                                    cos=-1.0)}


def long_captions(rng: np.random.Generator, n: int) -> list:
    """Captions of 257-512 tokens with [CLS] and [SEP] (one word a token
    for the hashing tokenizer), so that the key bias masks padding."""
    lengths = rng.integers(LONG_SEQ // 2 - 1, LONG_SEQ - 1, n)
    return [" ".join(rng.choice(WORDS, k)) for k in lengths]


def long_serving() -> dict:
    """(a) The flagship's text tower through EncoderBundle at S = 512 on
    N_ITEMS captions of 257-512 tokens, batch BATCH: K1 12 x 2 launches,
    all on the key-tiled tensor-core route; the embeddings against the
    same weights through the plain attention at TEXT_TOL bf16; captions/s."""
    from clip_lite_torch.config import Config
    from clip_lite_torch.data.tokenizers import HashingTokenizer
    from clip_lite_torch.eval_utils import EncoderBundle

    cfg = Config(str(FLAGSHIP), LONG)
    bundle = EncoderBundle(cfg, batch_size=BATCH, device="cuda")
    tok = HashingTokenizer(cfg.MODEL.TEXTUAL.VOCAB_SIZE, LONG_SEQ)
    texts = long_captions(np.random.default_rng(15), N_ITEMS)
    tokens = [sum(m) for m in tok(texts)["attention_mask"]]
    bundle.encode_texts(texts[:BATCH], tok)  # warm-up
    torch.cuda.synchronize()
    zero_launch_counts()
    emb = bundle.encode_texts(texts, tok)
    launches, counts = k1_route_counts(), attention_counts()
    want = cfg.MODEL.TEXTUAL.NUM_HIDDEN_LAYERS * math.ceil(N_ITEMS / BATCH)
    log(f"long serving: {N_ITEMS} captions of {min(tokens)}-{max(tokens)} tokens "
        f"at S = {LONG_SEQ}; K1 launches by route {launches}")
    check_embeddings("long text embeddings", emb)
    if launches["all"] != want or launches["tensor_core_tiled"] != want:
        raise AssertionError(f"long serving: K1 launches {launches}, expected "
                             f"{want}, all on the key-tiled tensor-core route")
    plain = EncoderBundle(Config(str(FLAGSHIP), LONG + [
        "MODEL.TEXTUAL.FUSED_ATTENTION", "false"]),
        state_dict=bundle.model.state_dict(), device="cuda")
    agree = text_agreement(emb, plain.encode_texts(texts, tok))
    del plain
    log(f"long serving: text embeddings, K1 vs plain attention, bf16: {agree} "
        f"(tol {TEXT_TOL['bfloat16']})")
    if agree["max_abs"] > TEXT_TOL["bfloat16"]["max_abs"] or \
            agree["min_cos"] < TEXT_TOL["bfloat16"]["min_cos"]:
        raise AssertionError(f"long serving: embeddings disagree: {agree}")
    rates = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bundle.encode_texts(texts, tok)
        rates.append(N_ITEMS / (time.perf_counter() - t0))
    log(f"long serving throughput at batch {BATCH}, S = {LONG_SEQ} (numpy in, "
        f"numpy out): captions/s {rates} (median {statistics.median(rates)})")
    del bundle
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=counts, agreement=agree,
                captions_per_s=statistics.median(rates))


def long_training(overrides=(), name: str = "long training", batch=None,
                  steps: int = LONG_STEPS) -> dict:
    """(b), (d) ``steps`` steps of ``batch`` pairs through train_step at
    S = 512 (dropout 0.1), the counts set to 0 just before and read just
    after: finite losses and grad norms, K1 and K2 12 a step, every launch
    on its key-tiled route (check_routes); MPNet's relative bias table's
    gradient (the sum of every layer's dbias) finite and non-zero at every
    step.  The median step after the first, pairs/s, peak memory."""
    from clip_lite_torch.config import Config
    from clip_lite_torch.data.tokenizers import HashingTokenizer
    from clip_lite_torch.engine import (
        create_train_state, make_train_step, metrics_to_floats)

    batch = batch or BATCH
    cfg = Config(str(FLAGSHIP), LONG + list(overrides))
    state = create_train_state(cfg, device="cuda")
    tok = HashingTokenizer(cfg.MODEL.TEXTUAL.VOCAB_SIZE, LONG_SEQ)
    rng = np.random.default_rng(16)
    batches = [training_batch(rng, tok, batch, cfg.DATA.IMAGE_CROP_SIZE,
                              long_captions) for _ in range(steps)]
    params = dict(state.model.named_parameters())
    tables = [n for n in params if n.endswith("relative_attention_bias.weight")]
    train_step = make_train_step(cfg)
    records = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    for batch_ in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch_)
        values = metrics_to_floats(metrics)
        records.append(dict(seconds=time.perf_counter() - t0, **values))
        if not (math.isfinite(values["total_loss"])
                and math.isfinite(values["grad_norm"])):
            raise AssertionError(f"{name} step {state.step}: {values}")
        for n in tables:
            gmax = float(params[n].grad.abs().max())
            records[-1]["table_grad_max"] = gmax
            if not 0.0 < gmax < math.inf:
                raise AssertionError(f"{name} step {state.step}: the relative "
                                     f"bias table's gradient has max {gmax}")
    torch.cuda.synchronize()
    launches = attention_counts()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    for i, rec in enumerate(records):
        log(f"{name} step {i + 1}: {json.dumps(rec)}")
    n = cfg.MODEL.TEXTUAL.NUM_HIDDEN_LAYERS * steps
    if launches["attention_fwd"] != n or launches["attention_bwd"] != n:
        raise AssertionError(f"{name}: launches {launches}, expected {n} each")
    check_routes(cfg, LONG_SEQ, launches, training=True)
    median = statistics.median(r["seconds"] for r in records[1:])
    log(f"{name}: {text_tower(cfg, state.model)} at S = {LONG_SEQ}, batch "
        f"{batch}, AMP {cfg.AMP}: launches {launches}; median step {median} s "
        f"over steps 2-{steps}, {batch / median} pairs/s; peak memory "
        f"{peak_mib} MiB")
    del state, params, batches
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, step_s=median, pairs_per_s=batch / median,
                peak_mib=peak_mib, batch=batch)


def float64_attention(qkv, bias, g, nh, rate, keep, chunk: int = 8):
    """``attention_float64``, (out, dqkv, dbias), a chunk of the batch at a
    time to bound its memory (its float64 probabilities are 3.2 GB at
    (128, 12, 512, 512))."""
    from clip_lite_torch.ops.attention import attention_float64

    parts = [attention_float64(qkv[i:i + chunk], bias[i:i + chunk], g[i:i + chunk],
                               nh, rate, None if keep is None else keep[i:i + chunk])
             for i in range(0, qkv.shape[0], chunk)]
    return [None if parts[0][k] is None else torch.cat([p[k] for p in parts])
            for k in range(3)]


def long_kernel_rows() -> dict:
    """(f) K1 and K2 at (128, 512, 2304), 12 heads, dropout RATE from the
    kernels' Philox draw: key bias (lengths 257-512) in bf16 and fp32, and
    MPNet's full bias in bf16; each against its plain version (TOLS; dbias
    at fp32's) and the float64 evaluation (bf16 within twice the plain
    version's distance, fp32 within four times plus 2^-21 of the output's
    size), then timed by time_attention; bf16 with the key bias also
    without dropout."""
    from clip_lite_torch.ops.attention import (
        attention_backward, attention_backward_reference, attention_forward,
        attention_reference, dropout_keep_mask)

    b, s, nh, h = BATCH, LONG_SEQ, 12, 768
    qkv32, key_bias, valid = attention_inputs(s, (s // 2 + 1, s))
    g32 = torch.randn(b, s, h, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(15))
    seed = 1515
    keep = dropout_keep_mask(seed, b, nh, s, RATE, "cuda")
    rows = {}
    for variant, dtype in (("key", torch.bfloat16), ("key", torch.float32),
                           ("full", torch.bfloat16)):
        bias = mpnet_bias(key_bias) if variant == "full" else key_bias
        qkv, g = qkv32.to(dtype), g32.to(dtype)
        out = attention_forward(qkv, bias, nh, dropout_rate=RATE, seed=seed)
        dqkv, dbias = attention_backward(qkv, bias, g, nh, dropout_rate=RATE,
                                         seed=seed)
        ref = attention_reference(qkv, bias, nh, RATE, keep)
        dref, dbias_ref = attention_backward_reference(qkv, bias, g, nh, RATE,
                                                       keep)
        torch.cuda.synchronize()
        errs = [(a.float() - r.float()).abs().max().item()
                for a, r in ((out, ref), (dqkv, dref))]
        name = f"long K1/K2 {variant} bias {str(dtype).replace('torch.', '')}"
        log(f"{name} rate {RATE}: max|kernel-plain| {errs}")
        # The float64 reading first, so that a failing bar below comes
        # with it.
        f64 = float64_bar(name, [(out, ref), (dqkv, dref), (dbias, dbias_ref)],
                          float64_attention(qkv, bias, g, nh, RATE, keep),
                          tf32x3=dtype == torch.float32)
        torch.testing.assert_close(out.float(), ref.float(), **TOLS[dtype])
        torch.testing.assert_close(dqkv.float(), dref.float(), **TOLS[dtype])
        if variant == "full":
            errs.append((dbias - dbias_ref).abs().max().item())
            torch.testing.assert_close(dbias, dbias_ref, **TOLS[torch.float32])
        del out, ref, dqkv, dref, dbias, dbias_ref
        gc.collect()
        torch.cuda.empty_cache()
        k1, k2 = time_attention(qkv, g, bias, valid, RATE, seed, keep)
        if variant == "key" and dtype == torch.bfloat16:
            # Without dropout: what the kernels' Philox draws cost.
            for r, r0 in zip((k1, k2), time_attention(qkv, g, bias, valid, 0.0,
                                                      seed, None)):
                r.update(ms_no_dropout=r0["ms"],
                         ms_device_no_dropout=r0["ms_device"])
        k1.update(max_abs_err=errs[0], float64_err=f64["out"],
                  shape=[b, s, 3 * h], heads=nh, bias=variant, dropout_rate=RATE)
        k2.update(max_abs_err=errs[1],
                  float64_err={k: v for k, v in f64.items() if k != "out"},
                  shape=[b, s, 3 * h], heads=nh, bias=variant, dropout_rate=RATE)
        if variant == "full":
            k2["dbias_max_abs_err"] = errs[2]
        for kname, r in (("K1", k1), ("K2", k2)):
            log(f"{name} {kname}: {json.dumps(r)}")
        rows[variant, str(dtype).replace("torch.", "")] = dict(k1=k1, k2=k2)
        del qkv, g, bias
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def phase_long() -> dict:
    """Phase 15: the flagship at DATA.MAX_CAPTION_LENGTH 512, past the
    256 tokens where the JAX package's wrapper takes XLA: (a) serving, (b)
    training, (c) step parity in bf16 and (e) in fp32 at PARITY_BATCH
    (long captions; the plain attention keeps (B, 12, 512, 512) fp32
    probabilities a layer), (d) MPNet, (f) the kernels at (128, 512,
    2304)."""
    t0 = time.perf_counter()
    serving = long_serving()
    training = long_training()
    parity = phase_training_parity(LONG, "long training parity", long_captions,
                                   LONG_PARITY_TOL, ("bfloat16", "text_bf16"))
    mpnet = long_training(MPNET, "long MPNet training", LONG_MPNET_BATCH,
                          LONG_MPNET_STEPS)
    rows = long_kernel_rows()
    log(f"long: phase 15 in {time.perf_counter() - t0} s")
    by_path = {"long_serving": serving["launches"],
               "long_training": training["launches"],
               "long_mpnet_training": mpnet["launches"],
               **{f"long_parity_{k}": v for k, v in parity["launches"].items()}}
    return dict(serving=serving, training=training, parity=parity, mpnet=mpnet,
                rows=rows, by_path=by_path)


def crop_kernel_only() -> int:
    """``--crop-kernel``: phase 10d's records, then crop_resize_flip_u8
    alone (native_kernel_alone), its row printed as one JSON line."""
    import shutil
    import tempfile

    phase_build(["decode_crop"])
    root = tempfile.mkdtemp(prefix="chip_smoke_crop_")
    try:
        _, jpegs, _ = native_records(root)
        row = native_kernel_alone(jpegs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"crop_resize_flip_u8": row}))
    return 0


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--native", action="store_true",
        help="run phases 1, 2 and 10d (the native batch path and its "
             "traced CLI runs) alone")
    parser.add_argument(
        "--quality", action="store_true",
        help="run phases 1, 2 and 11 (the quality path) alone")
    parser.add_argument(
        "--ranks", action="store_true",
        help="run phases 1, 2 and 12 (multi-GPU training) alone")
    parser.add_argument(
        "--matrix", action="store_true",
        help="run phases 1, 2 and 13 (the model matrix) alone")
    parser.add_argument(
        "--clip", action="store_true",
        help="run phases 1, 2 and 14 (retrieval --weight-init clip) alone")
    parser.add_argument(
        "--long", action="store_true",
        help="run phases 1, 2 and 15 (the flagship at 512 tokens) alone")
    parser.add_argument(
        "--crop-kernel", action="store_true",
        help="build decode_crop.cu, check and time crop_resize_flip_u8 alone "
             "on phase 10d's records and print its row, nothing else (to "
             "time the kernel of two checkouts in turns)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run",
              file=sys.stderr)
        return 1
    import clip_lite_torch

    if Path(clip_lite_torch.__file__).resolve().parents[1] != ROOT:
        raise RuntimeError("run chip_smoke.py from the root of a checkout")
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(name)s: %(message)s")
    phase_environment()
    if args.crop_kernel:
        return crop_kernel_only()
    if args.native:
        phase_build()
        phase_native({"step_s": None}, None)
        return 0
    if args.quality:
        phase_build()
        phase_quality({"step_s": None})
        return 0
    if args.ranks:
        phase_build()
        phase_ranks()
        return 0
    if args.matrix:
        phase_build()
        phase_matrix()
        return 0
    if args.clip:
        phase_build()
        phase_clip()
        return 0
    if args.long:
        phase_build()
        phase_long()
        return 0
    script_t0 = time.perf_counter()
    seconds = {}

    def timed(label, fn, *a):
        """``fn(*a)``, its seconds kept under ``label``."""
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[label] = time.perf_counter() - t0
        log(f"phase {label}: {seconds[label]} s")
        return out

    timed("2", phase_build)
    flagship_fp32 = timed("3", phase_attention)
    inference = timed("4", phase_main_path)
    attn = timed("5", phase_attention_training)
    training = timed("6", phase_training)
    flagship_trace = timed("6a", phase_trace, training)
    ckpt = timed("6b", phase_checkpoint)
    parity = timed("7", phase_training_parity)
    full = timed("8 (K1/K2)", phase_attention_training, True)
    mpnet_inference = timed("8 (inference)", phase_main_path, MPNET,
                            "MPNet inference")
    mpnet_training = timed("8 (training)", phase_training, MPNET,
                           "MPNet training")
    log(f"MPNet against BERT, same run, batch {BATCH}: training step "
        f"{mpnet_training['step_s']} s against {training['step_s']} s, "
        f"captions/s {mpnet_inference['captions_per_s']} against "
        f"{inference['captions_per_s']}, peak {mpnet_training['peak_mib']} MiB "
        f"against {training['peak_mib']} MiB")
    mpnet_parity = timed("8 (parity)", phase_training_parity, MPNET,
                         "MPNet training parity")
    norm = timed("9", phase_normalize)
    uint8 = timed("10", phase_uint8_training, training)
    ssl = timed("10a", phase_ssl, training, flagship_trace)
    data = timed("10b", phase_data_cli, training)
    nat = timed("10d", phase_native, training, data["a"]["step_s"])
    evals = timed("10c", phase_eval_cli)
    quality = timed("11", phase_quality, training)
    ranks = {f"ranks_{name}": run["launches"]
             for name, run in timed("12", phase_ranks)["runs"].items()}
    # Phase 13's runs, counted by range name as the ranks'.
    matrix = {f"matrix_{run}": result["launches"]
              for run, result in timed("13", phase_matrix).items()}
    clip = timed("14", phase_clip)
    long = timed("15", phase_long)
    log(f"phase seconds: {json.dumps(seconds)}; the script so far "
        f"{time.perf_counter() - script_t0} s after phase 1")
    cli = {"cli_host_loader": data["a"]["launches"],
           "cli_resumed": data["c"]["launches"],
           "cli_device_cache": data["b"]["launches"],
           "cli_textual_ssl": data["d"]["launches"],
           "cli_native_input": nat["a"]["launches"],
           "cli_native_input_traced": nat["traces"]["a"]["launches"],
           "cli_native_fixed_tiles_traced": nat["traces"]["a0"]["launches"],
           "cli_native_tuned_cache": nat["b"]["launches"],
           "cli_native_tuned": nat["c"]["launches"]}
    # The traced paths and the SSL cache path, counted by range name.
    by_range = {"trace": flagship_trace["launches"],
                "ssl_visual_training": ssl["launches"]}
    # phase_checkpoint's runs: (a) train with checkpoints, (b) resumed, (c)
    # again without, (d) the two bundles' encodes, (e) uint8 and resumed.
    by_run = {f"checkpoint_{run}": n for run, n in ckpt["launches"].items()}
    k1_launches = {"inference": inference["attention_fwd"],
                   "training": training["launches"]["attention_fwd"],
                   "mpnet_inference": mpnet_inference["attention_fwd"],
                   "mpnet_training": mpnet_training["launches"]["attention_fwd"],
                   "uint8_training": uint8["launches"]["attention_fwd"],
                   **{k: n["K1 attention_fwd"] for k, n in by_range.items()},
                   **{k: n["attention_fwd"] for k, n in by_run.items()},
                   **{k: n["attention_fwd"] for k, n in cli.items()},
                   "cli_bundle": data["bundle_launches"],
                   **{f"eval_{k}": n for k, n in evals["launches"].items()
                      if n},
                   "quality_cache_training": quality["normal"]["attention_fwd"],
                   "quality_cluster_embed": quality["embed_launches"],
                   "quality_switched_training":
                       quality["switched"]["attention_fwd"],
                   "quality_cluster_training":
                       quality["clusters"]["attention_fwd"],
                   **{k: n["K1 attention_fwd"] for k, n in ranks.items()},
                   **{k: n["K1 attention_fwd"] for k, n in matrix.items()
                      if n["K1 attention_fwd"]},
                   "clip_retrieval": clip["launches"],
                   **{k: n["attention_fwd"] for k, n in long["by_path"].items()}}
    k2_launches = {"training": training["launches"]["attention_bwd"],
                   "mpnet_training": mpnet_training["launches"]["attention_bwd"],
                   "uint8_training": uint8["launches"]["attention_bwd"],
                   **{k: n["K2 attention_bwd"] for k, n in by_range.items()},
                   **{k: n["attention_bwd"] for k, n in by_run.items()
                      if n["attention_bwd"]},
                   **{k: n["attention_bwd"] for k, n in cli.items()},
                   "quality_cache_training": quality["normal"]["attention_bwd"],
                   "quality_switched_training":
                       quality["switched"]["attention_bwd"],
                   "quality_cluster_training":
                       quality["clusters"]["attention_bwd"],
                   **{k: n["K2 attention_bwd"] for k, n in ranks.items()},
                   **{k: n["K2 attention_bwd"] for k, n in matrix.items()
                      if n["K2 attention_bwd"]},
                   **{k: n["attention_bwd"] for k, n in long["by_path"].items()
                      if n.get("attention_bwd")}}
    k3_fused_launches = {
        "uint8_training": uint8["launches"]["augment_normalize"],
        "ssl_visual_training": ssl["launches"]["K3 augment_normalize_u8"],
        **{k: n["augment_normalize"] for k, n in by_run.items()
           if n["augment_normalize"]},
        **{k: n["augment_normalize"] for k, n in cli.items()
           if n["augment_normalize"]},
        "quality_cache_training": quality["normal"]["augment_normalize"],
        "quality_switched_native": quality["switched"]["augment_normalize"],
        **{k: n["K3 augment_normalize_u8"] for k, n in ranks.items()},
        **{k: n["K3 augment_normalize_u8"] for k, n in matrix.items()
           if n["K3 augment_normalize_u8"]}}
    k3_launches = {"uint8_eval": uint8["launches"]["normalize"],
                   **{k: n["normalize"] for k, n in cli.items()
                      if n["normalize"]},
                   "quality_cache_eval": quality["normal"]["normalize"]}
    crop_launches = {k: n["crop_resize_flip"] for k, n in cli.items()
                     if n.get("crop_resize_flip")}
    crop_launches["quality_cache_build_and_eval"] = \
        quality["normal"]["crop_resize_flip"]
    crop_launches["quality_switched_native"] = \
        quality["switched"]["crop_resize_flip"]
    s20 = uint8["attention_s20"]
    timed = ("ms", "ms_device", "ms_cuda_core", "ms_cuda_core_device",
             "library_ms", "library_ms_device")

    def at_s20(variant: str, k: str) -> dict:
        r = s20[variant][k]
        return {f"{key}_s20": r[key] for key in timed + ("bound_ms",)}

    # Each attention kernel's main keys: bf16 at qkv (128, 30, 2304), dropout
    # RATE, on the tensor-core route, beside the CUDA-core route's time on
    # the same inputs, each as a caller pays it (ms) and on the device
    # alone; the dropout-off times, and the S = 20 times.
    def attention_row(k: str, result: dict, variant: str) -> dict:
        off = result[("bfloat16", 0.0)][k]
        return dict(result[("bfloat16", RATE)][k], dropout_rate=RATE,
                    **{f"{key}_no_dropout": off[key] for key in timed[:4]},
                    **at_s20(variant, k))

    def long_on(key: str) -> dict:
        """Phase 15's launches on a key-tiled route, by path."""
        return {k: n[key] for k, n in long["by_path"].items() if n.get(key)}

    kernels = [
        dict(name="attention_fwd (K1)", route="cuda",
             source="clip_lite_torch/ops/csrc/attention_fwd.cu",
             replaces="clip_lite_tpu/ops/attention.py:95",
             launches=sum(k1_launches.values()), launches_by_path=k1_launches,
             **attention_row("k1", attn, "key bias"),
             full_bias=attention_row("k1", full, "full bias")),
        # fp32 K1's route: 3xTF32 on mma.sync, S <= 80.  Main keys: CLIP's
        # text tower (phase 14: qkv (128, 77, 1536), 8 heads, the causal
        # and padding mask as the full bias); the vision tower (S = 50,
        # key bias) and the flagship's S = 30 (phase 3) beside it, each
        # with the CUDA-core kernel's times on the same inputs in turns.
        dict(name="attention_fwd_tf32x3 (K1, float32)", route="cuda",
             source="clip_lite_torch/ops/csrc/attention_fwd.cu",
             replaces="clip_lite_tpu/ops/attention.py:95",
             **clip["rows"]["clip_text"],
             launches=clip["tf32x3_launches"],
             launches_by_path={f"clip_retrieval_{k}": leg["launches"]["tf32x3"]
                               for k, leg in clip["legs"].items()},
             clip_vision=clip["rows"]["clip_vision"],
             flagship_s30=flagship_fp32),
        # fp32 K1 above S = 80: the key-tiled 3xTF32 kernel.  Main keys:
        # ViT-L/14's vision tower (phase 14: qkv (128, 257, 3072), 16
        # heads, zero key bias); ViT-B/16's (128, 197, 2304), with the
        # CUDA-core kernel's times on the same inputs in turns, and
        # ViT-L/14-336's (128, 577, 3072) beside it.
        dict(name="attention_fwd_tf32x3_tiled (K1, float32, S > 80)",
             route="cuda",
             source="clip_lite_torch/ops/csrc/attention_fwd.cu",
             replaces="clip_lite_tpu/ops/attention.py:95",
             **clip["rows"]["vit_l14"],
             launches=clip["tf32x3_tiled_launches"]
             + sum(long_on("attention_fwd_tf32x3_tiled").values()),
             launches_by_path={**{f"clip_retrieval_{k}":
                                  leg["launches"]["tf32x3_tiled"]
                                  for k, leg in clip["legs"].items()},
                               **long_on("attention_fwd_tf32x3_tiled")},
             vit_b16=clip["rows"]["vit_b16"],
             vit_l14_336=clip["rows"]["vit_l14_336"],
             long_s512_training=long["rows"]["key", "float32"]["k1"]),
        dict(name="attention_bwd (K2)", route="cuda",
             source="clip_lite_torch/ops/csrc/attention_bwd.cu",
             replaces="clip_lite_tpu/ops/attention.py:122",
             launches=sum(k2_launches.values()), launches_by_path=k2_launches,
             **attention_row("k2", attn, "key bias"),
             full_bias=attention_row("k2", full, "full bias")),
        # Past 256 tokens (phase 15, the flagship at 512).  bf16 K1's
        # key-tiled tensor-core kernel: main keys at qkv (128, 512, 2304),
        # 12 heads, key bias of 257-512 real keys, dropout RATE; MPNet's
        # full bias beside them.
        dict(name="attention_fwd_tc_tiled (K1, bf16, S > 256)", route="cuda",
             source="clip_lite_torch/ops/csrc/attention_fwd.cu",
             replaces="clip_lite_tpu/ops/attention.py:95",
             **long["rows"]["key", "bfloat16"]["k1"],
             launches=sum(long_on("attention_fwd_tc_tiled").values()),
             launches_by_path=long_on("attention_fwd_tc_tiled"),
             full_bias=long["rows"]["full", "bfloat16"]["k1"]),
        # K2's key-tiled pair (one launch of K2: a kernel by query rows and
        # one by key columns), bf16 and fp32.  Main keys: bf16 at the same
        # shape and draws; fp32 (3xTF32) and MPNet's full bias beside them.
        dict(name="attention_bwd_tiled (K2, S > 256)", route="cuda",
             source="clip_lite_torch/ops/csrc/attention_bwd.cu",
             replaces="clip_lite_tpu/ops/attention.py:122",
             **long["rows"]["key", "bfloat16"]["k2"],
             launches=sum(long_on("attention_bwd_tiled").values()),
             launches_by_path=long_on("attention_bwd_tiled"),
             float32=long["rows"]["key", "float32"]["k2"],
             full_bias=long["rows"]["full", "bfloat16"]["k2"]),
        # The eval sweep's launch (uint8 in, no draws); the main keys are
        # that variant, the other three beside it.
        dict(name="normalize_u8 (K3)", route="cuda",
             source="clip_lite_torch/ops/csrc/normalize.cu",
             replaces="clip_lite_tpu/ops/pallas_kernels.py:30",
             launches=sum(k3_launches.values()),
             launches_by_path=k3_launches,
             **norm["uint8->float32"],
             variants={k: v for k, v in norm.items()
                       if k not in ("fused", "device_preprocess_ms")}),
        # The training step's launch: flip, colour jitter and K3 in one
        # pass (XLA's fusion of image_ops.py:44-145 around K3 in JAX).
        dict(name="augment_normalize_u8 (K3, fused)", route="cuda",
             source="clip_lite_torch/ops/csrc/normalize.cu",
             replaces="clip_lite_tpu/ops/pallas_kernels.py:30",
             launches=sum(k3_fused_launches.values()),
             launches_by_path=k3_fused_launches,
             **norm["fused"],
             device_preprocess_ms=norm["device_preprocess_ms"]),
        # Not a TPU kernel: the JAX core's host C++ sample_crop, after the
        # decode (nvJPEG here, libjpeg there).
        dict(name="crop_resize_flip_u8 (native batch path)", route="cuda",
             source="clip_lite_torch/ops/csrc/crop_resize.cuh",
             replaces="native/clrec_core.cpp:163",
             replaces_a_tpu_kernel=False,
             launches=sum(crop_launches.values()),
             launches_by_path=crop_launches, **nat["kernel"],
             nvjpeg_ms_batch=nat["nvjpeg"]["ms"],
             nvjpeg_host_ms_batch=nat["nvjpeg"]["host_ms"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
