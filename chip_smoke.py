#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (paddle_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--seed N]

Phases (any failed check raises, so the script exits non-zero):

1. build   -- nvcc builds every kernel source under
              paddle_tpu_torch/ops/kernels/csrc/ for sm_90a, all at once;
              ptxas's register and spill lines are printed, and the count of
              wgmma instructions cuobjdump finds in each attention library
              and the fused conv's (HGMMA) and the int8 libraries' (IGMMA),
              which must be nonzero (and the conv's HMMA and the int8
              libraries' IMMA, mma.sync, counts zero).
2. kernels -- each kernel against its plain PyTorch version on the card at
              the ERNIE-base shapes (b 8, s 512, h 12, d 64, rows 4096 of
              dim 768) in fp32 and bf16: the forwards of attention (A),
              LayerNorm (B) and residual + LayerNorm (C) at dropout 0 and
              (A, C) 0.1, and the three backwards (A at dropout 0.1, C at
              0.1), plus ragged, padded, causal and head_dim-128 attention
              cases forward and backward; each kernel's time beside its
              plain version's, a PyTorch library call's and its bound;
              the LayerNorm backwards' dw and db repeat bit for bit.
              Then all six kernels in bf16 against their plain versions
              at the training step's own shapes (b 64, s 512; 32768 rows),
              the four LayerNorm kernels in fp32 too, and the (b, h, s, d)
              kernels of phase 5 there, on the split-head route's views
              (dropout 0.1, ragged keys), with their times and bounds
              there and aten's LayerNorm backward beside row 6.
3. slice   -- serving: full-width ERNIE-base (L12 H768 A12 I3072 V18000,
              random weights from --seed) answers token-id requests of
              mixed lengths, batched and padded at s 128 and s 512: the
              top-1 MLM token at each request's [MASK] and the NSP argmax.
              Checks: 12 / 24 / 2 launches of attention / residual-LN / LN
              per forward, fp32 logits against the plain path (flags off),
              bf16 answers against fp32, and each request's answer alone
              and unpadded against its batched answer.  Then the bf16
              forward's tokens/s at b 8, s 512.
4. train   -- the pretraining step of ``paddle_tpu_torch.entry
              .make_train_step`` (MLM + NSP loss, dropout 0.1, Adam lr 1e-4):
              at L2 b8 s512 in fp32, the loss and every gradient of the
              kernel path against the same step with every kernel wrapper
              swapped for its plain version (same seeds, same masks); then
              full-width ERNIE-base at b64 s512, 76 masked positions, bf16
              compute over fp32 masters: 12 / 12 / 24 / 24 / 2 / 2
              launches of A / A-backward / C / C-backward / B / B-backward
              per step, 25 steps on one batch with a finite, falling loss,
              the step's tokens/s, its MFU (bench.py's analytic FLOPs
              against 989 TF/s) and the peak device memory; then two more
              steps run under torch.profiler and their device time is
              split by kernel and by kind (the port's kernels, cuBLAS
              matrix products, the rest).
5. bhsd    -- the (batch, heads, seq, head_dim) flash-attention kernels
              (rows 3-4; the packed kernel's sources with other strides):
              (a) forward and backward against their plain versions in
              fp32 and bf16 at ERNIE-base's attention (b8 h12 s512 d64,
              ragged keys, dropout 0 and 0.1), GPT-2 XL's (b2 h25 s1024
              d64, causal), LLaMA-2-7B's (b1 h32 s4096 d128, causal),
              Gemma-7B's (b1 h16 s2048 d256), d192 (b2 h3 s256) and the
              wide heads d320 and d512 (b2 h2 s256, d512 causal; ragged
              keys, dropout 0 and 0.1), each backward run twice and held bit
              for bit; (b) the ERNIE-base fp32 case at dropout 0.1
              against kernel A on the same inputs in packed layout (out,
              lse, dq, dk, dv within 1e-4: one mask key); (c) each case's
              times beside the plain version, SDPA (backend named) and the
              bound; (d) full-width ERNIE-base through MultiHeadAttention's
              split-head route (the packed layout gate swapped for one that
              refuses every layout): the bf16 b8 s512 forward (12 / 0
              launches of the (b, h, s, d) / packed forward, logits against
              the packed route), the fp32 L2 b8 step at dropout 0.1 against
              the packed route (loss and every gradient), and 5 bf16 b64
              s512 steps (12 / 12 launches, falling loss, tokens/s beside
              the packed route's).
6. paged   -- (a) the paged-attention kernel against its plain version at
              256 rows x 128 blocks of 16 tokens, d 128, ragged lengths
              1..2048 from --seed (and rows of 0, 3, 16, 2048) over a
              32768-block pool, in fp32, bf16 and int8, plus d 32 / block
              8, a prefill chunk's stride-0 table and the recorded stride-0
              draw on which the int8 case once failed an absolute bound
              (int8 held within 2e-5 (v_max + |ref|) of the plain version
              and of a float64 evaluation); then the paged server's own
              launches, from generators of their own: a decode step (64
              rows, own tables of 128 blocks, mean length ~1078, 4 rows of
              0) and a prefill chunk (64 rows on one stride-0 table of
              128, lengths 1141..1204), in the three cache types; every
              case's second call equal to its first bit for bit; each
              timed case's time beside its bound (live bytes; for the
              chunk the one table's, or its products at the cache type's
              peak) and SDPA on pre-gathered K/V (the chunk's 64 rows
              against one gathered K/V with a length mask a row).
              (b) the slice: ``PagedDecoder`` serving the paged toy LM at
              vocab 32000, hidden 128, 4096 positions (random weights from
              --seed) from a 16384-block pool, 64 rows, 64-token prefill
              chunks: 96 requests of 16-2048 prompt tokens, 32 of them
              behind one 512-token system prompt, 64 new tokens each.
              Checks: launches = prefill chunks + live decode steps;
              tokens of the kernel path against the plain path and against
              ``dense_reference_decode`` (near-ties excepted); prefix hits,
              and hit requests equal to the same prompts decoded cold;
              int8 KV blocks: kernel path equal to the plain path, and a
              token match rate against fp32 >= 0.9 over the first 8 new
              tokens of each request (the JAX package's gate; the rate over
              all 64 is printed).  Then decode and
              prefill tokens/s, TTFT p50/p99; runs of the first 32
              requests in fp32 and int8 KV under torch.profiler (their
              tokens equal unprofiled runs' of the same 32), with row 9's
              device time split into
              prefill chunks and decode steps (the kernels launched under
              each step's profiler range) and the device's busy time by
              kernel (the cache, whose int8 scales are calibrated on the
              model's activations, built before the profiler starts); and
              the kernel's share of the device time over 20 decode steps
              of 64 rows.

7. vision kernels -- rows 10 and 13 against their plain versions in fp32
              (cuDNN's TF32 off) and bf16: the fused conv + BN + act at
              VGG-16's fused shapes at b128 (128->128 16x16, 256->256 8x8,
              512->512 4x4 and 2x2, 128->256 8x8, 256->512 4x4), a 3x3 s2
              p1, a 1x1 s2 and a 7x7 s2 p3 conv, and every epilogue act at
              a small shape (fp32 within 1e-4 of the largest value, bf16
              2e-2 of the fp32 plain version; every output, split K or
              not, repeats bit for bit on a second call); NHWC pooling at VGG-16's four 2x2/2 max pools,
              a 3x3/2 p1 max, a 2x2/2 and a 3x3/1 p1 non-exclusive avg
              (max bit for bit, avg within 1e-6); each case's CUDA-graph
              and eager times beside the plain version's, the library
              call's (cuDNN on the folded weights; PyTorch's pooling, both
              channels-last) and the bound.
8. static  -- static-graph inference in fp32 through the port's Program,
              layers, Executor and DEFAULT_PIPELINE: bench_vision.py's
              conv tower (ch 128, 32 x 32, b64) and the Paddle book's
              vgg16_bn_drop (b128), startup from --seed, random BN
              statistics, clone(for_test=True).  Checks: 1 / 2 (tower) and
              10 / 4 (VGG) conv / pool kernel launches per forward, zero
              pipeline rollbacks, golden parity of the rewrite against the
              unrewritten program (cuDNN and torch ops; within 1e-4 of
              each fetch's largest value), the kernels against their plain
              versions in the rewritten program, no launches with the
              pipeline off.  Then a profile of one forward with the
              pipeline on and off, and images/s of Executor.run in
              alternating blocks of runs with the pipeline on and off
              (medians and quartile spread).

9. vision train -- the forward of the main (train-mode) programs under
              DEFAULT_PIPELINE in fp32: vgg16_bn_drop (b128, its dropouts
              on) and the conv tower with train-mode BNs (b64, no
              dropout).  Checks: 11 / 2 launches of each of rows 11 and 12
              (train-mode BN statistics; scale + act) per forward, the
              fetches and every running statistic against the same run
              with their plain versions (same seed, same dropout masks)
              within 1e-4 of the largest value, and the tower's golden
              parity against the unfused program.
10. int8 kernels -- rows 11 and 12 against their plain versions in fp32
              and bf16 at VGG-16's train-mode BN shapes at b128 (32768 x
              128, 8192 x 256, 2048 x 512, 512 x 512) and ResNet-50's stage
              1 at b64 (200704 x 256, beyond L2): the sums within 1e-5 of
              the largest, two runs of row 11 bit for bit, row 12 bit for
              bit; times beside the plain versions', torch.var_mean /
              addcmul + relu and the bounds.  Rows 14 and 15 against their
              plain versions (exact sums in float64) with fp32 and bf16
              out: the int8 matmul at
              VGG-16's 512 x 512 fc (b128) and an ERNIE-base FFN shape
              (4096 x 768 -> 3072), the int8 conv at VGG-16's six int8
              conv shapes (b128), the tower's (b64), a 3x3 s2 p1 and a 7x7
              s2 p3 conv; every epilogue act at small shapes, among them a
              K (C) % 128 == 64 one and one the plan splits K for
              (piecewise-linear acts bit for bit); times beside the plain
              versions', torch._int_mm (row 14) or cuDNN on the dequantized
              operands (row 15, context only), row 10's bf16 time at the
              shapes the two share, and the bounds.
11. int8     -- post-training quantization (one calibration batch) and
              QUANT_INFER_PIPELINE on the conv tower (b64) and vgg16_bn_drop
              (b128) test programs: 1 / 0 and 10 / 2 launches of rows 15 /
              14 per forward, the program against its plain versions and
              against the simulate route (use_pallas_int8 off), the int8
              error against the float program, images/s of the int8
              program against the fp32 program under DEFAULT_PIPELINE in
              alternating blocks, and a profile of one int8 forward.
12. cold     -- rows 11, 12 and 13 at VGG-16's train-mode BN and pooling
              shapes (b128), fp32 and bf16, timed on inputs beyond the
              50 MB L2 (a CUDA graph calling the kernel in turn on >= 200
              MB of distinct inputs) beside the warm time (20 calls on one
              input), the library call's cold time and the bound; no cold
              time under its bound.  Each row's share of its bound over a
              VGG-16 forward's launches at those shapes, and with each
              launch held to at least one launch's floor.
13. static train -- static-graph training in fp32 (TF32 off) through
              ``static.optimizer.Adam(1e-3).minimize`` (append_backward,
              the Executor's backward_region on torch autograd): the book's
              vgg16_bn_drop and resnet_cifar10 at depth 32 (widths 16 / 32
              / 64), each with fc(10, softmax), cross_entropy, mean and
              accuracy, b128 synthetic CIFAR batches from --seed.  Checks:
              the first step (dropouts at 0) from one state and batch on
              the card (cuDNN's own algorithms, deterministic, off) and on
              the CPU in fp32, each against the port's CPU Executor in
              float64 (loss, and every gradient relative to the largest),
              and the step on another batch far outside those limits;
              fuse_conv_bn_act on every conv (13 / 33), train-mode, no
              rollback; no port kernel launch in a training step (training
              programs stay NCHW, as in the JAX package); the first step's
              loss repeated by a fresh Executor at the book's dropout
              rates; finite losses.
              Then step ms and images/s with the pipeline on and off in
              alternating blocks, and a profile of a step.  QAT:
              QuantizationTransformPass on VGG-16's training program and
              its test program, 20 Adam steps, QuantizationFreezePass and
              QUANT_INFER_PIPELINE: 10 / 2 / 4 launches of rows 15 / 14 /
              13 per forward, the program against its plain versions and
              the simulate route, the int8 error against the float test
              program (10 / 4 launches of rows 10 / 13 under
              DEFAULT_PIPELINE), and images/s of both.

14. recipe  -- ERNIE-base pretraining with the BERT-base recipe (AdamW,
              weight decay 0.01, LinearWarmup over PolynomialDecay to a
              1e-4 peak, ClipGradByGlobalNorm 1.0), three ways: without
              recompute, ``ErnieConfig(enable_recompute=True)`` and
              ``recompute_policy="dots_saveable"``.  Checks: at fp32 L2 b8
              (dropout 0.1) each way's kernel path against its plain
              wrappers (loss, every gradient); each recompute way's loss
              and gradients bit for bit those without recompute at dropout
              0 and 0.1 under one generator (fp32 L2 b8, and bf16 at full
              width b64); the eager loop ``loss.backward(); opt.step();
              opt.clear_grad()`` bit for bit the functional
              ``make_train_step`` over two recipe steps; per full-width
              bf16 b64 s512 step 12 / 12 / 24 / 24 / 2 / 2 launches of rows
              1 / 2 / 7 / 8 / 5 / 6 without recompute and 24 / 12 / 48 / 24
              / 2 / 2 with it (the encoder's forward kernels run again in
              the backward).  Then each way's step ms, tokens/s, MFU
              (579.1 MFLOP/token, the extra forward not counted) and peak
              memory; and one GradScaler step with an injected non-finite
              gradient (skipped; the scale halves) and one finite step.
15. seq2seq -- Transformer-base (d512, 8 heads, 6 + 6 layers, FFN 2048,
              dropout 0.1, post-LN; the script's shared 32000-token
              embedding and tied output projection around it) trained with
              Adam(0.9, 0.98, 1e-9) under NoamDecay(512, 4000) at b64,
              source and target 256 tokens, bf16 compute over fp32
              masters.  Checks: at fp32 2 + 2 layers b8 the kernel path
              against its plain wrappers; per full-size step 12 / 12
              launches of rows 1 / 2 (encoder self and decoder cross
              attention; the decoder's masked self attention takes the
              plain route, as in the JAX package) and 30 / 30 of rows 7 /
              8; step ms, tokens/s, peak memory.
16. dygraph quant -- ``ImperativeQuantAware().quantize`` on ERNIE-base:
              the fp32 L2 b8 QAT step against its plain wrappers (the
              activation scales restored between the two runs), then QAT
              steps at bf16 b64 s512 with the recipe (12 / 12 / 24 / 24 /
              2 / 2 launches a step); ``PostTrainingQuantization`` of
              ERNIE-base's 75 Linears on 3 calibration batches, the b8
              s512 eval forward through ``Int8Linear`` (its MLM logits'
              error against the fp32 forward, of the largest logit), and
              ``Int8Linear``'s int32 accumulator equal to an int64 product.
17. ops     -- every exported op of the tensor op library
              (``paddle_tpu_torch.ops.cases``: 295 ops, the LoD family,
              CTC, chunk_eval and the operator tail among them, the table
              the CPU parity test holds against the JAX package) and the
              12 ``nn.functional`` functions of its sibling table
              ``FUNCTIONAL_CASES`` (pad, interpolate, the norms, one_hot,
              ctc_loss, dropout2d, ...) on the card and on the CPU on the
              same inputs: every output a tensor on the card; data
              movement, integers, booleans and creation bit for bit,
              elementwise and reductions within rtol 1e-5 / atol 1e-6,
              bicubic interpolation within 1e-5 / 1e-5, products, solves,
              ctc_loss and the flash-attention op within 1e-4 / 1e-5,
              decompositions by their reconstructions (1e-4); random ops
              in range and repeated bit for bit under one seed on the
              card.
18. dygraph -- ERNIE-base fine-tuned for sentence classification
              (``ErnieForSequenceClassification``, 2 classes) through the
              book's loop under ``dygraph.guard()``: ``loss =
              mean(cross_entropy(model(ids, types, attention_mask=mask),
              labels)); loss.backward(); opt.minimize(loss);
              model.clear_gradients()``, BERT's GLUE recipe (b32 s128,
              lengths 16-128 from --seed, dropout 0.1, AdamW 2e-5 with
              weight decay 0.01, 10% linear warm-up into a linear decay,
              global-norm clip 1.0, fp32, TF32 off), the weights put in
              with ``set_state_dict`` as numpy arrays under the JAX
              package's names.  Checks: at fp32 L2 the loop's step on the
              kernels against its plain wrappers (loss, every gradient at
              TOL_TRAIN_*), and two steps bit for bit those of
              ``autograd.value_and_grad`` + ``opt.update`` (deterministic
              algorithms on); at full width 12 / 12 / 24 / 24 / 1 / 1
              launches of rows 1 / 2 / 7 / 8 / 5 / 6 a step, 2 warm-up and
              5 timed steps (step ms, sequences/s, real tokens/s, peak
              memory, finite losses); then one eval batch under
              ``no_grad`` (12 / 24 / 1 forward launches, finite logits,
              accuracy by ``argmax`` / ``equal`` / ``cast`` / ``mean``),
              and a torch.profiler split of two more steps.
19. tagging -- ERNIE-base + CRF NER fine-tuning (ERNIE 1.0's MSRA-NER
              task with PaddleNLP's CRF head): ``ErnieModel``, dropout, an
              emission Linear(768, 7) over the IOB tags of PER / ORG / LOC
              (O = 6) and ``ops.crf.linear_chain_crf``, through phase 18's
              loop, recipe and batches (random IOB labels).  Checks: at
              fp32 L2 the step on the kernels against its plain wrappers
              (loss and every gradient, the CRF transition's among them,
              at TOL_TRAIN_*); at full width 12 / 12 / 24 / 24 / 1 / 1
              launches of rows 1 / 2 / 7 / 8 / 5 / 6 a step, 2 warm-up and
              5 timed steps (step ms, sequences/s, peak memory, finite
              losses) and a torch.profiler split of two more; one eval
              batch under ``no_grad`` (12 / 24 / 1 forward launches):
              ``crf_decoding`` on the card equal to the CPU's on the same
              emissions wherever the best path beats the runner-up by more
              than 1e-4 (float64 max-marginals), ``chunk_eval``'s counts
              exact against the CPU on those rows, on the model's
              emissions and on a noisy probe of them; P / R / F1 printed.
20. rnn     -- Baidu's LAC BiGRU-CRF tagger at its published widths (word
              embedding 128 with sparse=True, two stacked bidirectional
              GRUs of hidden 128, 57 tags, b300, up to 64 words; a guessed
              vocabulary of 60,000 ids), no port kernel under it.
              Checks: the GRU's outputs and final states and the loss and
              every gradient on the card against the CPU, ragged lengths,
              at TOL_TRAIN_*; no port kernel launched in a step; 2 warm-up
              and 5 timed ``Lookahead(Adam(1e-3))`` steps with an EMA of
              the weights (step ms, words/s, peak memory, a profiler split
              with the busy share); the decode and chunk_eval checks of
              phase 19 on the EMA weights; Ftrl, Dpsgd (sigma 0),
              DGCMomentum and ModelAverage 3 steps each on a 1-layer copy,
              the card's eager optimizer against the CPU's on the same
              gradients.
21. resnet  -- bench_vision's ResNet-50 training (PaddleClas's
              configuration): ``vision.models.resnet50(num_classes=1000,
              data_format="NHWC")``, b256 224 x 224, Momentum (lr 0.1,
              0.9), bf16 compute over fp32 parameters, cross entropy on
              fp32 logits; no port kernel under it (its BatchNorms are
              ``F.batch_norm``, its one max pool has C = 64, which the pool
              kernel's gate refuses).  Checks at fp32, b4, 224: the eval
              logits on the card against the CPU; the NCHW model on the
              same weights gives the NHWC model's logits; an eval-mode
              step's loss and every gradient at TOL_TRAIN_*; a train-mode
              step's loss, gradients and BatchNorm statistics as vectors
              within VISION_CHAOS times the CPU's own move under a 1e-6
              input perturbation (train-mode BatchNorm at random init is
              chaotic); LeNet, VGG-11 (BN) and MobileNet V1 / V2 eval
              logits; no port kernel launched in a step.  Then 2 warm-up
              and 5 timed steps: step ms, images/s, MFU (3 x 4.09e9 FLOP
              an image against 989 TF/s), peak memory, and a profiler
              split (convolutions and products, cuDNN's layout
              conversions, BatchNorm / elementwise, the optimizer; the
              busy share; the layout conversions a step launches, fewer
              than one a convolution).
22. yolo    -- bench_vision's YOLOv3-DarkNet53 training (PaddleDetection's
              configuration): ``yolov3_darknet53(num_classes=80)``, b64
              416 x 416, 16 gt boxes an image from --seed, Momentum (lr
              1e-4, 0.9), bf16 compute, fp32 heads into ``model.loss``;
              no port kernel.  Checks at fp32, b2, 128: the three heads,
              the eval- and train-mode steps as in phase 21, and
              ``predict`` (``yolo_box`` + ``multiclass_nms``) on the CPU's
              heads, card against CPU: equal counts, labels and scores on
              the rows with distinct scores, boxes within 1e-4.  Then 2
              warm-up and 5 timed steps (step ms, images/s, MFU against 3
              x 65.86e9 FLOP an image, peak memory, busy share) and the
              wall time of one b64 ``predict``.
23. hapi    -- ERNIE-base fine-tuned for IMDB sentiment the Paddle 2.0
              way: ``text.datasets.Imdb`` (synthetic, 512 train / 256 test
              reviews, maxlen 256, lengths 8-255) through ``io.DataLoader``
              (b32, shuffled, 2 spawned workers returning batches through
              shared memory, device prefetch) into ``hapi.Model.fit`` (2
              epochs; LRSchedulerCallback, EarlyStopping, MetricsLogger),
              ``evaluate``, ``predict``, ``save`` / ``load``, with phase
              18's recipe (fp32, TF32 off, dropout 0.1), around a user
              layer that builds token types and the padding mask from the
              ids.  Checks: the native host runtime builds from native/src
              and loads; 4 batches fit twice from one state at dropout 0,
              kernels against plain wrappers (losses at TOL_TRAIN_LOSS_REL,
              the first step's gradients tensor by tensor as in phase
              18), and fit against the book loop bit for bit; batches
              staged on the feeder's stream while the main stream is
              busy, and while the feeder's copy stream is busy, equal the
              host batches (checksums); 12 / 12 / 24 / 24 / 1 / 1
              launches of rows 1 / 2 / 7 / 8 / 5 / 6 a fit step, 12 / 24
              / 1 of rows 1 / 7 / 5 an evaluate or predict batch, and no
              other kernel; parameters and AdamW
              state bit for bit through save / load; the book's fit_a_line
              on UCIHousing rows in a multi-slot file through
              InMemoryDataset on the native feed: ``train_from_dataset(
              prefetch_to_device=True)``'s losses equal ``Executor.run``'s.
              Then epoch 2's step ms and sequences/s beside the book loop's
              on the same batches, the mean io.prefetch_depth, the busy
              share of a profiled 2-step fit, the loader's batches/s alone
              with the split of a spawned worker's start-up, predict's
              wall for 256 reviews and the peak memory.
24. dp      -- data-parallel ERNIE-base pretraining through
              ``paddle_tpu_torch.parallel``: this script's ranks run
              under the port's launcher (``python -m
              paddle_tpu_torch.distributed.launch``, ``--dp-worker``).
              (a) One NCCL rank (``fleet.init()``), bench.py's step (b64
              s512, 76 masked positions, bf16 over fp32 masters, dropout
              0.1) through ``entry.make_train_step`` with
              ``DataParallel(comm_buffer_size=25)`` and
              ``fleet.distributed_optimizer(Adam)``: the first step's
              gradients and loss equal the same step without DataParallel
              and fleet bit for bit (one member: the buckets' flatten ->
              all-reduce -> unflatten moves no value); 12 / 12 / 2 / 2 /
              24 / 24 launches of rows 1 / 2 / 5 / 6 / 7 / 8 in the step
              and no other; ``quantize_blockwise`` / ``dequantize_
              blockwise`` (int8, fp8, block 256) of every gradient bucket
              on the card equal to the CPU's bit for bit, and
              ``all_reduce_compressed`` at one member returning its input;
              10 timed steps and a profiled split of 2 more.  (b) Two gloo ranks on the one card (the
              worker creates the gloo default group, which
              ``init_parallel_env`` takes: NCCL refuses two ranks on one
              device), each stepping b32 of the b64 batch in fp32 at
              dropout 0 with the bucketed sync: the averaged gradients and
              the ranks' mean loss against the single-process b64 step
              (``steps_agree``); all_reduce is the one collective it
              calls (``dp_probe``, run by ``phase_experiments.py --phases
              24probe``, tries the others on CUDA tensors under gloo).
              Printed: the step times (the world-1 step against the train
              phase's in this run), the launches, each rank's start-up
              split and each job's seconds.
25. hybrid  -- hybrid-parallel ERNIE pretraining through
              ``paddle_tpu_torch.text.pretrainer.HybridPretrainer``, ranks
              under the port's launcher (``--dp-worker hybrid1`` /
              ``hybrid4``).  (a) One NCCL rank through fleet at
              full width (L12 H768 A12 I3072 V18000): bench.py's bf16 b64
              s512 step with 76 masked positions and Adam: 12 / 12 / 2 /
              2 / 24 / 24 launches of rows 1 / 2 / 5 / 6 / 7 / 8 and no
              other, 10 timed steps (finite, falling loss), peak memory;
              then the same step in fp32 at dropout 0 from the same
              parameters against ``entry.make_train_step`` (loss within
              1e-5 relative, every gradient within 1e-4 of its tensor's
              largest).  (b) Four gloo ranks sharing the card (their own
              gloo group: NCCL refuses two ranks on one device),
              full-width ERNIE-base in fp32 at dropout 0, b8 s512, one
              set of parameters, the meshes pp2 x tp2 GPipe (4
              micro-batches), the same 1F1B, dp2 x sp2 with fleet
              ``sharding`` (ZeRO-1), tp4 (3 heads a rank: the split-head
              route, rows 3-4) and ep2 x sp2 with 4 experts, in turn:
              each mesh's loss within 2e-4 relative and its gradients,
              gathered whole, within 1e-3 of each tensor's largest
              against the world-1 step of the same parameters and batch
              on rank 0; ZeRO-1's moments (bytes a rank against the
              whole) and its Adam step against the world-1 Adam step
              (ZERO_STEP_REL's rule); per rank and mesh the step ms, the
              peak GiB (1F1B's step peak below GPipe's), the kernel
              launches of one step and the collective routes it took
              (``collective.routes()``: ppermute as all_to_all_single on
              gloo with CUDA tensors).
26. elastic -- (a) resumable ERNIE-base fine-tuning on one NCCL rank:
              ``fleet.init(DistributedStrategy(elastic=True,
              elastic_configs=ElasticConfig(save_every=2)))`` sets the
              elastic flags and phase 23's IMDB classifier (fp32 b32
              s256, dropout 0, AdamW) fits 4 steps through ``Model.fit``,
              which writes manifest checkpoints at steps 2 and 4; 48 / 48
              / 96 / 96 / 4 / 4 launches of rows 1 / 2 / 7 / 8 / 5 / 6 and
              no other; ``utils.checkpoint.load`` of step 4's directory
              equals the model's parameters and AdamW slots bit for bit;
              a fresh model with zeroed weights through
              ``elastic.restore_model(step=2)`` fits steps 3-4 on the same
              batches with the uninterrupted run's losses (bit for bit, or
              within 1e-4 relative, printed which).  Printed: each step's
              ms (2 and 4 save), the checkpoint's bytes,
              ``elastic.checkpoint_ms`` / ``restore_ms``.  (b) bench.py's
              ERNIE-base pretraining step (fp32 b8 s512, dropout 0)
              through ``HybridPretrainer`` with fleet ``sharding``
              (ZeRO-1) on 4 gloo ranks sharing the card (``--dp-worker
              elastic4``), then ``save_checkpoint(plan=ShardingPlan(
              zero_stage=1))``: the Adam moments written as dp slices,
              the parameters once, each rank's slices read back bit for
              bit; 2 gloo ranks (``elastic2``) restore under dp2: the
              gathered state equals the saved one bit for bit,
              ``resharded_leaves`` equals the leaves saved as dp slices
              (the ``_placement_sig`` rule), rank 0 restores with no plan
              and takes the world-1 step, and the dp2 step from the
              restored state agrees with it (loss within 2e-4, the Adam
              step by ZERO_STEP_REL's rule).  Rows 1, 2, 5-8 counted in
              each job's step.  Printed: save / restore ms and bytes a
              rank.
27. heter-ps -- phase 18's ERNIE-base sentence classification (fp32 b32
              s128, dropout 0) with ``word_embeddings`` (18000 x 768) in
              a host ``SparseTable(num_shards=4, optimizer="adagrad")``
              behind a ``PSServer``, reached through
              ``RemoteSparseTable``; the rest of the model on the card
              under Adam; the rows' gradient pushed through
              ``AsyncCommunicator``.  One step against the same model
              whose local embedding holds the pulled rows: loss and dense
              gradients equal, the per-position row gradients merged as
              ``ps._merge_duplicate_ids`` within 1e-5 of the embedding's
              weight gradient; after the flush the table's rows equal a
              numpy sparse-adagrad update by hand, bit for bit; 12 / 12 /
              24 / 24 / 1 / 1 launches of rows 1 / 2 / 7 / 8 / 5 / 6 a
              step and no other; timed steps (pull, push, step ms, rows a
              step, busy share); then a ``TableSnapshotter`` snapshot,
              the primary stops, a ``StandbyServer`` promotes and serves
              the snapshot's rows bit for bit, and two more steps train
              against it.
Phases 17-20 and 23 run right after the build (and row 11's profile),
before the first CUDA graph capture: the card's profiler loses eager
launches after one; phases 21-22 follow them.

Before the last line it prints ``{"train": ...}``, ``{"bhsd": ...}``,
``{"paged": ...}``, ``{"static": ...}``, ``{"vision_train": ...}``,
``{"int8": ...}``, ``{"cold": ...}``, ``{"static_train": ...}``,
``{"recipe": ...}``, ``{"seq2seq": ...}``, ``{"dygraph_quant": ...}``,
``{"ops": ...}``, ``{"dygraph": ...}``, ``{"tagging": ...}``,
``{"rnn": ...}``, ``{"resnet": ...}``, ``{"yolo": ...}``, ``{"hapi":
...}``, ``{"dp": ...}``, ``{"hybrid": ...}`` and ``{"kernels": [...]}``
JSON lines (one kernel entry for each of the 15 TPU kernels; rows 10 and
13-15 with their launches on the static-train path, rows 11-13 with their
cold times, rows 1, 2 and 5-8 with their launches on each path of phases
14-16, 18, 19 and 23, every row with its launches on phases 21 and 22's
paths, 0, on phase 24's data-parallel step, ``dp_launches``, and on phase
25's world-1 hybrid step and each mesh's step, ``hybrid_launches`` /
``hybrid_mesh_launches``) and the card's name and power limit;
the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import time

_T_MODULE_TOP = time.time()      # a spawned worker's start-up, SpawnProbe
import numpy as np  # noqa: E402
import torch  # noqa: E402

_T_TORCH = time.time()

# Published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12}

# Tolerances.  fp32: the kernel and its plain version do the same
# arithmetic in another summation order.  bf16: relative to the largest
# reference value, against the plain version in fp32 on the same inputs
# (bf16 keeps ~3 significant digits).  dw/db sum 4096 rows: relative to
# their largest value.
TOL_FP32 = {"flash_attention_packed": 1e-4, "flash_attention_packed_bwd": 1e-4,
            "flash_attention": 1e-4, "flash_attention_bwd": 1e-4,
            "layer_norm": 2e-5, "residual_layer_norm": 2e-5,
            "layer_norm_bwd": 2e-5, "residual_layer_norm_bwd": 2e-5}
TOL_BF16_REL = 2e-2
TOL_LSE = 1e-4
TOL_SLICE_FP32_REL = 1e-4    # logits, kernel path vs plain path, fp32
TOL_ALONE_FP32_REL = 1e-4    # logits, alone and unpadded vs batched, fp32
MIN_BF16_AGREE = 0.95
TOL_TRAIN_LOSS_REL = 1e-4    # train step, kernel vs plain wrappers, fp32
TOL_TRAIN_GRAD_REL = 1e-3    # each gradient, of its largest value
KEPT_SHARE, KEPT_BAND = 0.9, 0.005
RATE = 0.1
SEED = 20240611
KERNEL_SHAPE = dict(b=8, s=512, h=12, d=64, dim=768)   # main-path shapes
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 64, 512, 25      # bench.py's TPU run

# The port's kernels in a profile, by names no library kernel has (the
# csrc/*.cu __global__ functions).
PORT_KERNEL = re.compile(r"\b(flash_(fwd|bwd)(_dkdv|_dq)?_(fp32|wgmma)|flash_bwd_delta|"
                         r"ln_(fwd|bwd|partials_reduce)|"
                         r"paged_attn_(rows|shared|merge)|"
                         r"conv2d_bn_act(_fp32|_wgmma|_split_sum)?|pool2d_nhwc|"
                         r"bn_stats_cluster|bn_scale_act|"
                         r"int8_(matmul|conv)_(wgmma|split_sum))_kernel\b")
# Row 9's kernels in a profile: the one-row kernel, the shared-table
# kernel and their merge.
ROW9 = re.compile(r"\bpaged_attn_(rows|shared|merge)_kernel\b")

# Paged attention (phase 5).  Tolerances: fp32 against the plain version on
# the same blocks with rtol = atol = 2e-5 (tests/test_paged.py's kernel
# check); bf16 relative to the fp32 plain version on the same values.  int8
# blocks dequantise to |V| up to 127 x 0.1, and the fp32 roundings of the
# scores and of the weighted V sums grow with those magnitudes, which the
# absolute 2e-5 does not: on the draw below it failed at 2.71e-5 while the
# kernel was as close to a float64 evaluation as the plain version (1.49e-5
# and 1.28e-5 on an H100).  So the int8 cases hold the kernel within 2e-5
# (v_max + |ref|) of the plain version and of the float64 evaluation, v_max
# the largest dequantised |V| (in units of V, as 2e-5 (1 + |ref|) is for
# data of unit size).
# Token checks: a differing greedy token must be a near-tie, the top-2
# logit gap of the context below NEAR_TIE_REL of the top logit.
PAGED_KERNEL_SHAPE = dict(num_seqs=256, max_blocks=128, block_size=16,
                          d=128, max_len=2048)
PAGED_SERVE = dict(vocab=32000, hidden=128, max_positions=4096,
                   num_blocks=16384, block_size=16, max_seqs=64,
                   max_blocks_per_seq=256, prefill_chunk=64, requests=96,
                   shared=32, system_len=512, prompt_lo=16, prompt_hi=2048,
                   max_new=64, oracle=4, cold=4, int8_probe=12,
                   profile_prompt=1024, profile_steps=20,
                   profile_requests=32)
# The paged server's own launches (PAGED_SERVE): a decode step is 64 rows
# with own tables (live width 128 at the profile's mean context of 1078; 4
# idle slots of length 0), a prefill chunk 64 rows on one stride-0 table
# (lengths start+1..start+64).  Drawn from generators of their own.
PAGED_DECODE = dict(rows=64, width=128, len_lo=108, len_hi=2048, idle=4)
PAGED_CHUNK = dict(rows=64, width=128, start=1140)
TOL_PAGED_FP32 = 2e-5
TOL_PAGED_BF16_REL = 2e-2
# The stride-0 prefill-chunk draw on which the int8 case once failed the
# absolute bound: the seed-0 torch generator `words` 32-bit draws on, the
# numpy generator at `rng`; the rest fingerprints the draw.
PAGED_FAIL_DRAW = dict(
    words=1_001_542_940, start=1140, q00=-1.131712555885315, k8_sum=-46932,
    v8_sum=-17216,
    rng={"bit_generator": "PCG64",
         "state": {"state": 125358452017946240032439705099848920504,
                   "inc": 87136372517582989555478159403783844777},
         "has_uint32": 1, "uinteger": 1214891778})
NEAR_TIE_REL = 1e-4
PAGED_MAX_DIFFERING = 1      # requests, kernel path vs plain path
# int8 KV against fp32: the JAX package's gate (tests/test_paged.py:343-356)
# is a token match rate >= 0.9 over 8 new tokens a request.  Greedy decode
# diverges for good after the first flip, so over 64 tokens the rate also
# measures how long the streams run; the gate is taken over the first 8
# and the whole-stream rate is printed beside it.
MIN_INT8_MATCH = 0.9
INT8_GATE_TOKENS = 8
# Each int8 stream's first flip away from fp32 must be at a near-tie of the
# fp32 logits: the top-2 gap below this share of the top logit (the H100
# readings at seed 0 reach 1.25e-2).  The int8 pool itself is checked value
# by value in int8_kv_check, so a store or scale fault fails there.
INT8_FLIP_GAP_REL = 2e-2

MASK_ID, CLS_ID, SEP_ID = 3, 1, 2
DEV = "cuda"
REQUEST_LENGTHS = (37, 64, 120, 200, 311, 500)


def log(*args):
    print(*args, flush=True)


def _events_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def eager_ms(fn, reps=20, warmup=3):
    """Per-call time of back-to-back eager calls: the device time, or the
    host's launch time where that is longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return _events_ms(fn, reps)


def time_ms(fn, reps=20, warmup=3, replays=5):
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    replayed, so host launch overhead is not in the number."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(graph.replay, replays) / reps


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


def rel_err(a, ref):
    return max_abs(a, ref) / max(float(ref.float().abs().max()), 1e-30)


def check(ok, what):
    if not ok:
        raise AssertionError(f"chip_smoke check failed: {what}")
    log(f"  ok: {what}")


def compare(tag, name, got, ref, ref32, dtype, relative=False):
    """Kernel output against the plain version: fp32 max abs error (or
    relative to the largest value) within TOL_FP32[name]; bf16 relative to
    the fp32 plain version within TOL_BF16_REL.  Returns the max abs error
    against the plain version in the same type."""
    err = max_abs(got, ref)
    if dtype == torch.float32:
        e = rel_err(got, ref) if relative else err
        check(e <= TOL_FP32[name], f"{tag}: max {'rel' if relative else 'abs'}"
              f" err {e:.3g} <= {TOL_FP32[name]}")
    else:
        r = rel_err(got, ref32)
        check(r <= TOL_BF16_REL, f"{tag}: rel err vs fp32 plain {r:.3g} <= "
              f"{TOL_BF16_REL} (max abs vs bf16 plain {err:.3g})")
    return err


def randn(gen, shape, dtype, scale=1.0, shift=0.0):
    x = torch.randn(shape, generator=gen, dtype=torch.float32) * scale + shift
    return x.to(dtype).to(DEV)


def dtag(dtype):
    return str(dtype)[6:]


def bits(t):
    """The bit patterns of a float tensor, NaNs included."""
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


# -- phase 2: kernels ---------------------------------------------------------

def padding_bias(lengths, s):
    bias = torch.zeros(len(lengths), s, dtype=torch.float32)
    for i, n in enumerate(lengths):
        bias[i, n:] = -1e4
    return bias.to(DEV)


def attention_case(fap, gen, b, s, h, d, dtype, causal, lengths=None,
                   rate=0.0, backward=False):
    """Kernel A (forward, and backward with ``backward``) against its plain
    version; returns the inputs and errors."""
    q, k, v, do = (randn(gen, (b, s, h * d), dtype) for _ in range(4))
    bias = padding_bias(lengths or [s] * b, s)
    scale = 1.0 / d ** 0.5
    args = (h, bias, scale, causal, rate, SEED)
    out, lse = fap.flash_attention_packed_fwd(q, k, v, *args)
    torch.cuda.synchronize()
    ref, ref_lse = fap.flash_attention_packed_plain(q, k, v, *args)
    f32 = [t.float() for t in (q, k, v, do)]
    ref32, ref32_lse = fap.flash_attention_packed_plain(*f32[:3], *args)
    tag = (f"attention b{b} s{s} h{h} d{d} {dtag(dtype)} "
           f"causal={int(causal)} dropout={rate}")
    err = compare(tag, fap.KERNEL, out, ref, ref32, dtype)
    lerr = max_abs(lse, ref_lse)
    check(lerr <= TOL_LSE * max(1.0, float(ref32_lse.abs().max())),
          f"{tag}: lse max abs err {lerr:.3g}")
    case = dict(q=q, k=k, v=v, do=do, bias=bias, scale=scale, out=out,
                lse=lse, err=err)
    if backward:
        bargs = (h, scale, causal, rate, SEED)
        grads = fap.flash_attention_packed_bwd(q, k, v, bias, out, lse, do,
                                               *bargs)
        torch.cuda.synchronize()
        refs = fap.flash_attention_packed_bwd_plain(q, k, v, bias, ref,
                                                    ref_lse, do, *bargs)
        refs32 = fap.flash_attention_packed_bwd_plain(
            *f32[:3], bias, ref32, ref32_lse, f32[3], *bargs)
        case["bwd_err"] = max(
            compare(f"{tag} d{name}", fap.KERNEL_BWD, g, r, r32, dtype)
            for name, g, r, r32 in zip("qkv", grads, refs, refs32))
    return case


def ln_case(ln, name, run, plain, plain32, dtype, tag):
    """A LayerNorm kernel's outputs against its plain version: the first
    output elementwise, dw/db (the last two of a backward) relative to their
    largest value, mean/rstd of a forward within 1e-5."""
    got = run()
    torch.cuda.synchronize()
    ref, ref32 = plain(), plain32()
    backward = name.endswith("_bwd")
    n_main = len(got) - 2 if backward else 1
    labels = (["dx", "dres"] if len(got) == 4 else ["dx"]) if backward \
        else ["out"]
    err = 0.0
    for i in range(n_main):
        err = max(err, compare(f"{tag} {labels[i]}", name, got[i], ref[i],
                               ref32[i], dtype))
    if backward:
        for i, label in ((-2, "dw"), (-1, "db")):
            compare(f"{tag} {label}", name, got[i], ref[i], ref32[i], dtype,
                    relative=True)
        again = run()
        check(all(torch.equal(g, a) for g, a in zip(got[-2:], again[-2:])),
              f"{tag}: dw and db repeat bit for bit on a second call")
    else:
        stats = max(max_abs(got[1], ref[1]), rel_err(got[2], ref[2]))
        check(stats <= 1e-5, f"{tag}: mean/rstd err {stats:.3g}")
    return got, err


def traced(fn, reps, tries=3):
    """A torch.profiler session over ``reps`` calls of ``fn``, taken again
    (at most ``tries`` sessions) while it records no device activity at
    all: on the card, a session now and then comes back empty, whatever
    ran in it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        if device_events(prof):
            break
    return prof


def profiled_ms(fn, reps=20, warmup=3):
    """Device time per call from torch.profiler: the summed durations of the
    kernels and memsets ``fn`` launches (gaps between them excluded), for a
    call that cannot be captured in a CUDA graph."""
    for _ in range(warmup):
        fn()
    us = sum(us for us, _, _ in device_events(traced(fn, reps)))
    check(us > 0, f"the profiler saw {us:.1f} us of device time")
    return us / 1e3 / reps


def device_events(prof):
    """(device us, count, name) of each kernel a profile recorded."""
    out = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out.append((us, e.count, e.key))
    return out


def timings(run, plain, lib, nbytes, flops, dtype, lib_profiled=False):
    return dict(ms=time_ms(run), eager_ms=eager_ms(run),
                plain_ms=time_ms(plain),
                library_ms=(None if lib is None else
                            profiled_ms(lib) if lib_profiled
                            else time_ms(lib)),
                bound=bound(nbytes, flops, dtype))


def attn_cost(backward, b, s, h, d, elt, causal=False):
    """(bytes, flops) of attention in either layout: q, k, v read and o
    written (and dO, o read, dq, dk, dv written for the backward), the fp32
    bias and LSE; 4 b h s^2 d flops forward, 10 backward (S recomputed
    once), over the s (s + 1) / 2 scores a causal mask leaves."""
    io = (8 if backward else 4) * b * s * h * d * elt
    scores = s * (s + 1) // 2 if causal else s * s
    return io + b * s * 4 + b * h * s * 4, \
        (10 if backward else 4) * b * h * scores * d


def ln_cost(name, n, dim, elt):
    """(bytes, flops) of a LayerNorm kernel on (n, dim) rows: its (n, dim)
    tensors read or written once, w and b (or dw and db) and w, fp32 mean
    and rstd, and its flops per value."""
    tensors, vectors, flops = {
        "layer_norm": (2, 2, 8), "layer_norm_bwd": (3, 3, 14),
        "residual_layer_norm": (3, 2, 9),
        "residual_layer_norm_bwd": (5, 3, 16)}[name]
    return (tensors * n * dim * elt + vectors * dim * elt + 8 * n,
            flops * n * dim)


def ln_family(ln, gen, n, dim, dtype):
    """Kernels B and C forward and backward against their plain versions on
    one set of (n, dim) inputs: B forward and backward, C forward at dropout
    0 and RATE, C backward at RATE (with its kept share).  Returns
    ``{key: (run, plain, err)}`` keyed by kernel name, C's dropout forward
    under ``(RDLN, RATE)``, and the inputs."""
    x = randn(gen, (n, dim), dtype, 2.0, 0.5)
    res = randn(gen, (n, dim), dtype, 1.0, -0.25)
    w = randn(gen, (dim,), dtype, 0.1, 1.0)
    bb = randn(gen, (dim,), dtype, 0.1)
    dy = randn(gen, (n, dim), dtype)
    f32 = lambda *ts: [t.float() for t in ts]
    tag = f"{n}x{dim} {dtag(dtype)}"
    cases = {}

    def case(key, name, run, plain, plain32, label=""):
        got, err = ln_case(ln, name, run, plain, plain32, dtype,
                           f"{name} {tag}{label}")
        cases[key] = (run, plain, err)
        return got

    _, mean, rstd = case(
        ln.LN, ln.LN, lambda: ln.layer_norm_fwd(x, w, bb),
        lambda: ln.layer_norm_plain(x, w, bb),
        lambda: ln.layer_norm_plain(*f32(x, w, bb)))
    case(ln.LN_BWD, ln.LN_BWD,
         lambda: ln.layer_norm_bwd(x, w, mean, rstd, dy),
         lambda: ln.layer_norm_bwd_plain(x, w, mean, rstd, dy),
         lambda: ln.layer_norm_bwd_plain(*f32(x, w), mean, rstd, dy.float()))
    case(ln.RDLN, ln.RDLN, lambda: ln.residual_layer_norm_fwd(x, res, w, bb),
         lambda: ln.residual_layer_norm_plain(x, res, w, bb),
         lambda: ln.residual_layer_norm_plain(*f32(x, res, w, bb)))
    cargs = (1e-5, RATE, SEED)
    _, mean_c, rstd_c = case(
        (ln.RDLN, RATE), ln.RDLN,
        lambda: ln.residual_layer_norm_fwd(x, res, w, bb, *cargs),
        lambda: ln.residual_layer_norm_plain(x, res, w, bb, *cargs),
        lambda: ln.residual_layer_norm_plain(*f32(x, res, w, bb), *cargs),
        f" dropout={RATE}")
    bargs = (RATE, SEED)
    got = case(
        ln.RDLN_BWD, ln.RDLN_BWD,
        lambda: ln.residual_layer_norm_bwd(x, res, w, mean_c, rstd_c, dy,
                                           *bargs),
        lambda: ln.residual_layer_norm_bwd_plain(x, res, w, mean_c, rstd_c,
                                                 dy, *bargs),
        lambda: ln.residual_layer_norm_bwd_plain(
            *f32(x, res, w), mean_c, rstd_c, dy.float(), *bargs),
        f" dropout={RATE}")
    kept = float((got[0] != 0).float().mean())
    check(abs(kept - KEPT_SHARE) <= KEPT_BAND,
          f"{ln.RDLN_BWD} {tag}: share of x the kernel kept (dx != 0) "
          f"{kept:.4f} = {KEPT_SHARE} +- {KEPT_BAND}")
    return cases, dict(x=x, w=w, bb=bb, dy=dy)


def kernel_phase(gen):
    from paddle_tpu_torch.ops.kernels import dropout
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fap
    from paddle_tpu_torch.ops.kernels import layer_norm as ln

    F = torch.nn.functional
    b, s, h, d, dim = (KERNEL_SHAPE[k] for k in ("b", "s", "h", "d", "dim"))
    n = b * s
    lengths = [512, 480, 300, 37, 512, 128, 200, 450]
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        log(f"[kernels] {dtype} at b{b} s{s} h{h} d{d}, rows {n} x {dim}")
        elt = torch.tensor([], dtype=dtype).element_size()

        # A: packed flash attention, forward at dropout 0 and 0.1, backward
        a = attention_case(fap, gen, b, s, h, d, dtype, False, lengths)
        qkv = (a["q"], a["k"], a["v"])
        fargs = (h, a["bias"], a["scale"])
        run = lambda: fap.flash_attention_packed_fwd(*qkv, *fargs)
        plain = lambda: fap.flash_attention_packed_plain(*qkv, *fargs)
        split = lambda t: t.reshape(b, s, h, d).transpose(1, 2).contiguous()
        leaf = lambda t: split(t).requires_grad_()
        qh, kh, vh = (split(t) for t in qkv)
        mask = a["bias"][:, None, None, :].to(dtype)
        lib = lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                     attn_mask=mask)
        r = timings(run, plain, lib, *attn_cost(False, b, s, h, d, elt),
                    dtype)
        results[(fap.KERNEL, dtype)] = dict(r, err=a["err"])

        ad = attention_case(fap, gen, b, s, h, d, dtype, False, lengths,
                            rate=RATE, backward=True)
        qkv = (ad["q"], ad["k"], ad["v"])
        dargs = (h, ad["bias"], ad["scale"], False, RATE, SEED)
        run = lambda: fap.flash_attention_packed_fwd(*qkv, *dargs)
        results[(fap.KERNEL, dtype)].update(
            dropout_ms=time_ms(run), dropout_err=ad["err"],
            dropout_plain_ms=time_ms(
                lambda: fap.flash_attention_packed_plain(*qkv, *dargs)))
        bargs = (ad["bias"], ad["out"], ad["lse"], ad["do"], h, ad["scale"],
                 False, RATE, SEED)
        run = lambda: fap.flash_attention_packed_bwd(*qkv, *bargs)
        plain = lambda: fap.flash_attention_packed_bwd_plain(*qkv, *bargs)
        qh, kh, vh = (leaf(t) for t in qkv)
        doh = split(ad["do"])
        lib_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                 dropout_p=RATE)
        # an autograd call cannot be graph-captured alone: the profiler
        # gives its device time
        lib = lambda: torch.autograd.grad(lib_out, (qh, kh, vh), doh,
                                          retain_graph=True)
        r = timings(run, plain, lib, *attn_cost(True, b, s, h, d, elt),
                    dtype, lib_profiled=True)
        results[(fap.KERNEL_BWD, dtype)] = dict(r, err=ad["bwd_err"],
                                                library_eager_ms=eager_ms(lib))
        del lib_out, lib

        # B: LayerNorm; C: residual + dropout + LayerNorm; and backwards
        cases, t = ln_family(ln, gen, n, dim, dtype)
        x, w, bb, dy = t["x"], t["w"], t["bb"], t["dy"]
        _, mean_l, rstd_l = torch.ops.aten.native_layer_norm(x, [dim], w, bb,
                                                             1e-5)
        libs = {ln.LN: lambda: F.layer_norm(x, (dim,), w, bb, 1e-5),
                ln.LN_BWD: lambda: torch.ops.aten.native_layer_norm_backward(
                    dy, x, [dim], mean_l, rstd_l, w, bb, [True, True, True])}
        for name in (ln.LN, ln.LN_BWD, ln.RDLN, ln.RDLN_BWD):
            run, plain, err = cases[name]
            results[(name, dtype)] = dict(
                timings(run, plain, libs.get(name), *ln_cost(name, n, dim,
                                                             elt), dtype),
                err=err)
        run, plain, err = cases[(ln.RDLN, RATE)]
        results[(ln.RDLN, dtype)].update(
            dropout_ms=time_ms(run), dropout_err=err,
            dropout_plain_ms=time_ms(plain))

    pos = torch.arange(s, device=DEV)
    keep = dropout.keep_mask(SEED, torch.arange(b * h, device=DEV)[:, None,
                                                                  None],
                             pos[:, None], pos[None, :], RATE)
    kept = float(keep.float().mean())
    check(abs(kept - KEPT_SHARE) <= KEPT_BAND,
          f"attention keep mask at b{b} h{h} s{s}: kept share {kept:.4f} = "
          f"{KEPT_SHARE} +- {KEPT_BAND}")

    log("[kernels] edge cases")
    for dtype in (torch.float32, torch.bfloat16):
        for rate, bwd in ((0.0, False), (RATE, True)):
            attention_case(fap, gen, 2, 200, 12, 64, dtype, False, [200, 77],
                           rate, bwd)
            attention_case(fap, gen, 2, 200, 4, 128, dtype, True, [150, 200],
                           rate, bwd)
            attention_case(fap, gen, 1, 77, 2, 64, dtype, True, None, rate,
                           bwd)
            # a row of one key has dS = P (dP - delta) = 0 up to rounding,
            # which bf16 cannot hold to 2e-2: the backward takes 5 keys
            attention_case(fap, gen, 3, 128, 12, 64, dtype, False,
                           [5 if bwd else 1, 128, 64], rate, bwd)
        attention_case(fap, gen, 2, 512, 2, 128, dtype, False, [512, 300],
                       RATE, True)
    x = randn(gen, (256, 128), torch.float32, 1.0, 1000.0)
    w = randn(gen, (128,), torch.float32, 0.1, 1.0)
    z = torch.zeros(128, device=DEV)
    ref = torch.nn.functional.layer_norm(x.double(), (128,), w.double(),
                                         z.double(), 1e-5)
    out, mean, rstd = ln.layer_norm_fwd(x, w, z)
    err = max_abs(out, ref)
    check(err <= 1e-3, f"layer_norm rows of mean 1e3: max abs err vs fp64 "
          f"{err:.3g} <= 1e-3")
    dy = randn(gen, (256, 128), torch.float32)
    got = ln.layer_norm_bwd(x, w, mean, rstd, dy)
    refs = ln.layer_norm_bwd_plain(x, w, mean, rstd, dy)
    err = max(rel_err(g, r) for g, r in zip(got, refs))
    check(err <= 1e-3, f"layer_norm_bwd rows of mean 1e3: rel err vs plain "
          f"{err:.3g} <= 1e-3")
    for (name, dtype), r in results.items():
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        if "library_eager_ms" in r:
            lib += (f" (profiler device time; eager "
                    f"{r['library_eager_ms']:.4f} ms)")
        extra = (f"; dropout {RATE}: {r['dropout_ms']:.4f} ms (plain "
                 f"{r['dropout_plain_ms']:.4f} ms)" if "dropout_ms" in r
                 else "")
        log(f"  {name} {dtag(dtype)}: {r['ms']:.4f} ms (eager "
            f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, library "
            f"{lib}, bound {r['bound'][0]:.4f} ms ({r['bound'][1]}){extra}")
    return results


def train_shape_phase(gen):
    """The main path's kernels against their plain versions at the bf16
    training step's own shapes (b TRAIN_BATCH, s TRAIN_SEQ; TRAIN_BATCH *
    TRAIN_SEQ rows), where the wrappers launch other grids than at
    KERNEL_SHAPE (the LayerNorm backwards' warps walk ~8 rows each, not 1-2;
    the attention backwards' delta pre-pass covers b * h * s rows), with
    the same seeds and tolerances: kernel A and A-backward, the (b, h, s,
    d) kernels on the split-head route's views, and the four LayerNorm
    kernels in bf16 and fp32 (dw/db bit for bit across two calls); then
    each kernel's device time and bound there, and aten's LayerNorm
    backward beside row 6."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fap
    from paddle_tpu_torch.ops.kernels import layer_norm as ln

    b, s = TRAIN_BATCH, TRAIN_SEQ
    h, d, dim = (KERNEL_SHAPE[k] for k in ("h", "d", "dim"))
    n, dtype = b * s, torch.bfloat16
    elt = torch.tensor([], dtype=dtype).element_size()
    log(f"[kernels] training shapes, bf16: b{b} s{s} h{h} d{d}, rows {n} x "
        f"{dim}, dropout {RATE}")
    lengths = [s] * (b - 2) + [300, 37]
    a = attention_case(fap, gen, b, s, h, d, dtype, False, lengths,
                       rate=RATE, backward=True)
    qkv = (a["q"], a["k"], a["v"])
    fargs = (h, a["bias"], a["scale"], False, RATE, SEED)
    bargs = (a["bias"], a["out"], a["lse"], a["do"], h, a["scale"], False,
             RATE, SEED)
    runs = {fap.KERNEL: (lambda: fap.flash_attention_packed_fwd(*qkv, *fargs),
                         attn_cost(False, b, s, h, d, elt), a["err"]),
            fap.KERNEL_BWD: (
                lambda: fap.flash_attention_packed_bwd(*qkv, *bargs),
                attn_cost(True, b, s, h, d, elt), a["bwd_err"])}
    c = bhsd_case(fa, gen, b, h, s, d, dtype, False, lengths, RATE,
                  f"(b, h, s, d) attention on split-head views b{b} h{h} "
                  f"s{s} d{d} bf16 dropout={RATE}", split=True)
    runs[fa.KERNEL] = (
        lambda: fa.flash_attention_fwd(c["q"], c["k"], c["v"], *c["fargs"]),
        attn_cost(False, b, s, h, d, elt), c["err"])
    runs[fa.KERNEL_BWD] = (
        lambda: fa.flash_attention_bwd(c["q"], c["k"], c["v"], c["bias"],
                                       c["out"], c["lse"], c["do"],
                                       *c["bargs"]),
        attn_cost(True, b, s, h, d, elt), c["bwd_err"])
    out = {}
    for name, (run, cost, err) in runs.items():
        out[name] = dict(ms=time_ms(run), bound=bound(*cost, dtype), err=err)
        log(f"  {name} bf16 at the training shapes: {out[name]['ms']:.4f} ms,"
            f" bound {out[name]['bound'][0]:.4f} ms ({out[name]['bound'][1]})"
            f"; max abs err vs bf16 plain {err:.3g}")
    del a, c, qkv, runs
    torch.cuda.empty_cache()
    # The LayerNorms in bf16 (the step's type) and fp32, with aten's
    # LayerNorm backward beside row 6.  The fp32 inputs come from a
    # generator of their own, so the later phases draw what they drew
    # before this case was added.
    for ln_dtype, ln_gen in ((torch.bfloat16, gen),
                             (torch.float32,
                              torch.Generator().manual_seed(SEED))):
        ln_elt = torch.tensor([], dtype=ln_dtype).element_size()
        cases, t = ln_family(ln, ln_gen, n, dim, ln_dtype)
        cases[ln.RDLN] = cases.pop((ln.RDLN, RATE))
        _, mean_l, rstd_l = torch.ops.aten.native_layer_norm(
            t["x"], [dim], t["w"], t["bb"], 1e-5)
        lib = lambda: torch.ops.aten.native_layer_norm_backward(
            t["dy"], t["x"], [dim], mean_l, rstd_l, t["w"], t["bb"],
            [True, True, True])
        for name in (ln.LN, ln.LN_BWD, ln.RDLN, ln.RDLN_BWD):
            run, _, err = cases[name]
            r = dict(ms=time_ms(run),
                     bound=bound(*ln_cost(name, n, dim, ln_elt), ln_dtype),
                     err=err)
            if name == ln.LN_BWD:
                r["library_ms"] = time_ms(lib)
            key = name if ln_dtype == torch.bfloat16 else (name, ln_dtype)
            out[key] = r
            extra = (f", library (aten native_layer_norm_backward) "
                     f"{r['library_ms']:.4f} ms" if "library_ms" in r else "")
            log(f"  {name} {dtag(ln_dtype)} at the training shapes: "
                f"{r['ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
                f"({r['bound'][1]}){extra}; max abs err vs plain {err:.3g}")
        del cases, t, lib
        torch.cuda.empty_cache()
    return out


# -- phase 3: the ERNIE-base serving slice -------------------------------------

def make_requests(rng, vocab):
    reqs = []
    for length in REQUEST_LENGTHS:
        ids = rng.integers(5, vocab, length)
        ids[0], ids[-1] = CLS_ID, SEP_ID
        pos = int(rng.integers(1, length - 1))
        ids[pos] = MASK_ID
        reqs.append((ids.astype(np.int64), pos))
    return reqs


def batches(reqs, edges=(128, 512)):
    """Group requests by the smallest padded length that holds them."""
    out = []
    for lo, hi in zip((0,) + edges[:-1], edges):
        idx = [i for i, (ids, _) in enumerate(reqs) if lo < len(ids) <= hi]
        if not idx:
            continue
        ids = np.zeros((len(idx), hi), np.int64)   # pad_token_id 0
        pos = np.zeros((len(idx), 1), np.int64)
        for row, i in enumerate(idx):
            ids[row, :len(reqs[i][0])] = reqs[i][0]
            pos[row, 0] = reqs[i][1]
        out.append((idx, torch.from_numpy(ids).to(DEV),
                    torch.from_numpy(pos).to(DEV)))
    return out


def serve(model, reqs):
    """Answer every request: (mlm logits at [MASK] (n, V), nsp (n, 2))."""
    mlm = [None] * len(reqs)
    nsp = [None] * len(reqs)
    with torch.inference_mode():
        for idx, ids, pos in batches(reqs):
            logits, seq_rel = model(ids, masked_positions=pos)
            for row, i in enumerate(idx):
                mlm[i] = logits[row, 0].float()
                nsp[i] = seq_rel[row].float()
    return torch.stack(mlm), torch.stack(nsp)


def agree(ref_logits, got_logits, band):
    """Per request: the got top-1 equals the ref top-1, or the ref scores
    the got top-1 within ``band`` of its own top-1 (a tie at this
    precision)."""
    ref_top = ref_logits.argmax(-1)
    got_top = got_logits.argmax(-1)
    exact = ref_top == got_top
    ref_max = ref_logits.gather(-1, ref_top[:, None])[:, 0]
    ref_at_got = ref_logits.gather(-1, got_top[:, None])[:, 0]
    return exact, exact | (ref_max - ref_at_got <= band)


def slice_phase(seed):
    import copy

    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.text.ernie import ErnieConfig, ErnieForPretraining

    cfg = ErnieConfig()
    log(f"[slice] ERNIE-base L{cfg.num_hidden_layers} H{cfg.hidden_size} "
        f"A{cfg.num_attention_heads} I{cfg.intermediate_size} "
        f"V{cfg.vocab_size}, random weights from seed {seed}")
    gen = torch.Generator().manual_seed(seed)
    model = ErnieForPretraining(cfg, device=DEV, generator=gen).eval()
    # weights representable in bf16, so fp32 and bf16 serve one model
    model.to(torch.bfloat16).to(torch.float32)
    reqs = make_requests(np.random.default_rng(seed), cfg.vocab_size)
    n_fwd = len(batches(reqs))
    log(f"  {len(reqs)} requests, lengths {[len(r[0]) for r in reqs]}, "
        f"{n_fwd} padded batches")
    expect = {"flash_attention_packed": cfg.num_hidden_layers,
              "residual_layer_norm": 2 * cfg.num_hidden_layers,
              "layer_norm": 2}

    def counted(m):
        config.reset_counts()
        out = serve(m, reqs)
        torch.cuda.synchronize()
        counts = config.launch_counts()
        for name, per_fwd in expect.items():
            got = counts.get(name, 0)
            check(got == per_fwd * n_fwd, f"{name}: {got} launches in "
                  f"{n_fwd} forwards ({per_fwd} per forward)")
        return out, counts

    # fp32: kernel path vs plain path on the same card
    (mlm32, nsp32), _ = counted(model)
    flags.set_flags({"use_flash_attention": False,
                     "use_fused_layer_norm": False})
    config.reset_counts()
    mlm_p, nsp_p = serve(model, reqs)
    check(not config.launch_counts(), "plain path launches no kernel")
    flags.set_flags({"use_flash_attention": True,
                     "use_fused_layer_norm": True})
    r = max(rel_err(mlm32, mlm_p), rel_err(nsp32, nsp_p))
    check(r <= TOL_SLICE_FP32_REL, f"fp32 logits vs plain path: rel err "
          f"{r:.3g} <= {TOL_SLICE_FP32_REL}")
    check(bool(torch.isfinite(mlm32).all() and torch.isfinite(nsp32).all()),
          "fp32 logits finite")

    # each request alone and unpadded (ragged s) answers as in its batch
    with torch.inference_mode():
        for i, (ids, pos) in enumerate(reqs):
            t = torch.from_numpy(ids)[None].to(DEV)
            p = torch.tensor([[pos]], device=DEV)
            logits, seq_rel = model(t, masked_positions=p)
            r = max(rel_err(logits[0, 0], mlm32[i]),
                    rel_err(seq_rel[0], nsp32[i]))
            check(r <= TOL_ALONE_FP32_REL, f"request {i} (len {len(ids)}) "
                  f"alone and unpadded vs batched: rel err {r:.3g}")

    # bf16 serving: the main path whose launches the kernels line reports
    model16 = copy.deepcopy(model).to(torch.bfloat16)
    (mlm16, nsp16), counts = counted(model16)
    band = max_abs(mlm16, mlm32)
    exact, tie_ok = agree(mlm32, mlm16, band)
    nsp_ok = nsp16.argmax(-1) == nsp32.argmax(-1)
    ok = (tie_ok & nsp_ok).float().mean().item()
    log(f"  answers fp32: mlm {mlm32.argmax(-1).tolist()} nsp "
        f"{nsp32.argmax(-1).tolist()}; bf16: mlm {mlm16.argmax(-1).tolist()} "
        f"nsp {nsp16.argmax(-1).tolist()}")
    log(f"  bf16 vs fp32: max abs logit diff {band:.4g}; mlm top-1 exact "
        f"{exact.float().mean().item():.3f}; nsp {nsp_ok.float().mean().item():.3f}")
    check(ok >= MIN_BF16_AGREE, f"bf16 answers agree with fp32 on {ok:.3f} "
          f"of requests (mlm top-1 equal or within the bf16 logit band) "
          f">= {MIN_BF16_AGREE}")

    # throughput: bf16 forward at b 8, s 512 (4096 tokens), all positions
    ids = torch.randint(5, cfg.vocab_size, (8, 512), generator=gen).to(DEV)
    tokens = ids.numel()
    with torch.inference_mode():
        fwd = lambda: model16(ids)
        for on in (True, False):
            flags.set_flags({"use_flash_attention": on,
                             "use_fused_layer_norm": on})
            eager, graphed = eager_ms(fwd, reps=10), time_ms(fwd, reps=5)
            log(f"[slice] bf16 forward b8 s512, "
                f"{'kernel' if on else 'plain'} path: eager {eager:.3f} ms "
                f"= {tokens / eager * 1e3:.1f} tokens/s; CUDA graph "
                f"{graphed:.3f} ms = {tokens / graphed * 1e3:.1f} tokens/s; "
                f"host-bound share of eager {1 - graphed / eager:.3f}")
            if on:
                fwd_ms = graphed
    flags.set_flags({"use_flash_attention": True,
                     "use_fused_layer_norm": True})
    return counts, fwd_ms


# -- phase 4: the ERNIE-base pretraining step ---------------------------------

class _GradCapture:
    """An optimizer whose update hands back the gradients, so a train step
    returns them in place of the new parameters."""

    def update(self, grads, state, params, lr=None):
        return grads, state


@contextlib.contextmanager
def plain_wrappers():
    """Every kernel wrapper swapped for its plain version (same arguments),
    as module attributes, so the autograd Functions call the plain
    arithmetic on CUDA tensors."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fap
    from paddle_tpu_torch.ops.kernels import layer_norm as ln

    saved = []
    for mod in (fa, fap, ln):
        for k in mod.KERNELS:
            saved.append((mod, k.wrapper.__name__, k.wrapper))
            setattr(mod, k.wrapper.__name__, k.plain)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def pretrain_batch(rng, b, s, vocab, n_mask, pad_rows=0):
    """bench.py's batch: random ids, n_mask masked positions per row with
    random labels, random NSP labels; ``pad_rows`` rows padded from 3/4."""
    ids = rng.integers(5, vocab, (b, s))
    for row in range(pad_rows):
        ids[b - 1 - row, 3 * s // 4:] = 0
    limit = 3 * s // 4 if pad_rows else s
    pos = np.stack([rng.choice(limit, n_mask, replace=False)
                    for _ in range(b)])
    batch = {"input_ids": ids, "token_type_ids": np.zeros((b, s), np.int64),
             "masked_positions": pos,
             "mlm_labels": rng.integers(0, vocab, (b, n_mask)),
             "nsp_labels": rng.integers(0, 2, (b,))}
    return {k: torch.from_numpy(np.asarray(v, np.int64)).to(DEV)
            for k, v in batch.items()}


def profile_steps(step, params, state, batch, gen, steps=2):
    """``profile_split`` of ``steps`` train steps of ``make_train_step``'s
    form; returns the parameters and state after them."""
    box = [params, state]

    def run():
        box[0], box[1], _ = step(box[0], box[1], batch, gen)

    profile_split(run, steps)
    return box[0], box[1]


def profile_split(run, steps=2):
    """Device time of ``steps`` calls of ``run`` (a train step) by kernel,
    from torch.profiler: the top kernels, the split into the port's
    kernels / matrix products / the rest, and the device's busy share of
    the wall time (the profiler's own host cost is in the wall time).
    Returns the split per step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((us / 1e3 / steps, count // steps, name)
                      for us, count, name in device_events(prof)),
                     reverse=True)
    kinds = {"port kernels": 0.0, "matrix products": 0.0, "rest": 0.0}
    ours = {}
    for ms, _, name in kernels:
        own = PORT_KERNEL.search(name)
        if own:
            kinds["port kernels"] += ms
            ours[own.group(0)] = ours.get(own.group(0), 0.0) + ms
        elif any(g in name for g in ("gemm", "xmma", "cutlass", "nvjet")):
            kinds["matrix products"] += ms
        else:
            kinds["rest"] += ms
    busy = sum(kinds.values())
    step_ms = wall_ms / steps
    log(f"[profile] per step: device busy {busy:.2f} ms of {step_ms:.2f} ms "
        f"wall (busy share {busy / step_ms:.3f}); "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in kinds.items()))
    log("  port kernels: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in sorted(ours.items(),
                                             key=lambda kv: -kv[1])))
    for ms, count, name in kernels[:20]:
        log(f"  {ms:8.3f} ms  x{count:<4d} {name[:100]}")
    return dict(busy_ms=busy, wall_ms=step_ms, kinds=kinds, port=ours)


def steps_agree(loss, grads, loss_ref, grads_ref, ref_name, floor=1e-4,
                grad_tol=TOL_TRAIN_GRAD_REL):
    """One fp32 train step's loss and every gradient against another run of
    the step: the loss within TOL_TRAIN_LOSS_REL, each gradient within
    ``grad_tol`` (TOL_TRAIN_GRAD_REL unless a phase names its own) of its
    largest value, floored at ``floor`` of the largest gradient of all
    (1e-4: the key-projection bias's is rounding noise; 1 under fake
    quantization, where a last-bit difference ahead of a quantizer moves an
    activation by a whole level)."""
    r = abs(loss.item() - loss_ref.item()) / abs(loss_ref.item())
    check(r <= TOL_TRAIN_LOSS_REL, f"loss {loss.item():.6f} vs {ref_name} "
          f"{loss_ref.item():.6f}: rel err {r:.3g} <= {TOL_TRAIN_LOSS_REL}")
    top = max(float(g.abs().max()) for g in grads_ref.values())
    worst = max((max_abs(grads[k], g) / max(float(g.abs().max()),
                                            floor * top), k)
                for k, g in grads_ref.items())
    own = max((max_abs(grads[k], g) / max(float(g.abs().max()), 1e-30), k)
              for k, g in grads_ref.items())
    what = "the gradient's max" if floor < 1 else "the largest gradient"
    check(worst[0] <= grad_tol, f"{len(grads_ref)} gradients vs "
          f"{ref_name}: worst err {worst[0]:.3g} of {what} ({worst[1]}) <= "
          f"{grad_tol}; of its own max {own[0]:.3g} ({own[1]})")


def train_phase(seed):
    from paddle_tpu_torch import convert, entry
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.text.ernie import (
        ErnieConfig,
        ErnieForPretraining,
        ErniePretrainingCriterion,
    )

    cfg = ErnieConfig()
    seq = TRAIN_SEQ
    n_mask = max(1, int(seq * 0.15))
    crit = ErniePretrainingCriterion(cfg.vocab_size)
    rng = np.random.default_rng(seed)

    # fp32, L2 b8: kernel wrappers against their plain versions
    small = ErnieConfig(num_hidden_layers=2)
    log(f"[train] fp32 L2 H768 b8 s{seq}, dropout {cfg.hidden_dropout_prob}"
        f"/{cfg.attention_probs_dropout_prob}: kernel path vs plain wrappers")
    model = ErnieForPretraining(small, device=DEV,
                                generator=torch.Generator().manual_seed(seed))
    step = entry.make_train_step(model, crit, _GradCapture())
    batch = pretrain_batch(rng, 8, seq, cfg.vocab_size, n_mask, pad_rows=2)
    params = convert.parameters_dict(model)
    config.reset_counts()
    grads_k, _, loss_k = step(params, None, batch,
                              torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    launched = config.launch_counts()
    check(len(launched) == 6 and min(launched.values()) >= 2,
          f"kernel path launches all six kernels: {launched}")
    config.reset_counts()
    with plain_wrappers():
        grads_p, _, loss_p = step(params, None, batch,
                                  torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    check(not config.launch_counts(), "plain wrappers launch no kernel")
    steps_agree(loss_k, grads_k, loss_p, grads_p, "plain")
    del model, step, grads_k, grads_p, params

    # bf16 over fp32 masters, full width, b64: the main path
    b = TRAIN_BATCH
    log(f"[train] bf16 ERNIE-base L{cfg.num_hidden_layers} H"
        f"{cfg.hidden_size} b{b} s{seq}, {n_mask} masked positions, Adam "
        f"lr 1e-4, fp32 masters")
    model = ErnieForPretraining(cfg, device=DEV,
                                generator=torch.Generator().manual_seed(seed))
    params = convert.parameters_dict(model)
    opt = Adam(learning_rate=1e-4)
    state = opt.init(params)
    step = entry.make_train_step(model, crit, opt, torch.bfloat16)
    batch = pretrain_batch(rng, b, seq, cfg.vocab_size, n_mask)
    gen = torch.Generator().manual_seed(seed)
    L = cfg.num_hidden_layers
    expect = {"flash_attention_packed": L, "flash_attention_packed_bwd": L,
              "residual_layer_norm": 2 * L,
              "residual_layer_norm_bwd": 2 * L, "layer_norm": 2,
              "layer_norm_bwd": 2}
    config.reset_counts()
    params, state, loss = step(params, state, batch, gen)
    torch.cuda.synchronize()
    counts = config.launch_counts()
    for name, want in expect.items():
        check(counts.get(name, 0) == want,
              f"{name}: {counts.get(name, 0)} launches in one step ({want})")
    losses = [loss]
    n_steps, warm = TRAIN_STEPS, 5
    for i in range(1, n_steps):
        if i == warm:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
        params, state, loss = step(params, state, batch, gen)
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / (n_steps - warm) * 1e3
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).tolist()
    log(f"  losses: {[round(x, 4) for x in losses]}")
    check(all(np.isfinite(losses)), "losses finite")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    check(last < first and losses[-1] < losses[0],
          f"loss falls: mean of the first 5 steps {first:.4f} -> last 5 "
          f"{last:.4f}")
    tokens = b * seq
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    fwd_per_tok = (L * (8 * H * H + 4 * H * I + 4 * seq * H)
                   + n_mask / seq * (2 * H * H + 2 * H * V)
                   + (2 * H * H + 4 * H) / seq)
    toks = tokens / step_ms * 1e3
    mfu = toks * 3 * fwd_per_tok / PEAK_FLOPS[torch.bfloat16]
    params, state = profile_steps(step, params, state, batch, gen)
    log(f"[train] bf16 step b{b} s{seq} (eager, mean of steps {warm}-"
        f"{n_steps - 1}): {step_ms:.2f} ms = {toks:.1f} tokens/s; MFU "
        f"{mfu:.4f} of 989 TF/s (bench.py's analytic FLOPs, "
        f"{3 * fwd_per_tok / 1e6:.1f} MFLOP/token); peak device memory "
        f"{peak / 2 ** 30:.2f} GiB")
    return counts, dict(step_ms=step_ms, tokens_per_s=toks, mfu=mfu,
                        peak_gib=peak / 2 ** 30, losses=losses)


# -- phase 5: (b, h, s, d) flash attention and the split-head route ---------

# (label, b, h, s, d, causal, key lengths (None: all s), dropout rates): the
# (b, h, s, d) kernels at ERNIE-base's attention, GPT-2 XL's 25 heads of 64
# (causal), LLaMA-2-7B's 32 heads of 128 at 4096 (causal), Gemma-7B's 16
# heads of 256, and heads of 192, 320 and 512 (the column-split route above
# 256) at a small size.
BHSD_CASES = (
    ("ERNIE-base", 8, 12, 512, 64, False,
     (512, 480, 300, 37, 512, 128, 200, 450), (0.0, RATE)),
    ("GPT-2 XL", 2, 25, 1024, 64, True, None, (0.0,)),
    ("LLaMA-2-7B", 1, 32, 4096, 128, True, None, (0.0,)),
    ("Gemma-7B", 1, 16, 2048, 256, False, None, (0.0,)),
    ("d192", 2, 3, 256, 192, False, (256, 100), (0.0, RATE)),
    ("d320", 2, 2, 256, 320, False, (256, 100), (0.0, RATE)),
    ("d512", 2, 2, 256, 512, True, (256, 180), (0.0, RATE)),
)
TOL_KERNEL_A = 1e-4   # fp32: (b, h, s, d) kernels vs kernel A, same inputs
BHSD_TRAIN_STEPS = 5


def bhsd_case(fa, gen, b, h, s, d, dtype, causal, lengths, rate, tag,
              split=False):
    """The (b, h, s, d) forward and backward kernels against their plain
    versions (fp32 max abs, bf16 relative to the fp32 plain version, LSE);
    returns the inputs, outputs and errors.  With ``split``, q, k, v and dO
    are what the split-head route gives the kernels: (b, h, s, d) views of
    (b, s, h*d) tensors; else contiguous (b, h, s, d) tensors."""
    if split:
        q, k, v, do = (randn(gen, (b, s, h, d), dtype).transpose(1, 2)
                       for _ in range(4))
    else:
        q, k, v, do = (randn(gen, (b, h, s, d), dtype) for _ in range(4))
    bias = padding_bias(lengths or [s] * b, s)
    scale = d ** -0.5
    fargs = (bias, scale, causal, rate, SEED)
    out, lse = fa.flash_attention_fwd(q, k, v, *fargs)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_fwd_plain(q, k, v, *fargs)
    f32 = [t.float() for t in (q, k, v, do)]
    ref32, ref32_lse = fa.flash_attention_fwd_plain(*f32[:3], *fargs)
    err = compare(tag, fa.KERNEL, out, ref, ref32, dtype)
    lerr = max_abs(lse, ref_lse)
    check(lerr <= TOL_LSE * max(1.0, float(ref32_lse.abs().max())),
          f"{tag}: lse max abs err {lerr:.3g}")
    bargs = (scale, causal, rate, SEED)
    grads = fa.flash_attention_bwd(q, k, v, bias, out, lse, do, *bargs)
    torch.cuda.synchronize()
    refs = fa.flash_attention_bwd_plain(q, k, v, bias, ref, ref_lse, do,
                                        *bargs)
    refs32 = fa.flash_attention_bwd_plain(*f32[:3], bias, ref32, ref32_lse,
                                          f32[3], *bargs)
    bwd_err = max(compare(f"{tag} d{name}", fa.KERNEL_BWD, g, r, r32, dtype)
                  for name, g, r, r32 in zip("qkv", grads, refs, refs32))
    again = fa.flash_attention_bwd(q, k, v, bias, out, lse, do, *bargs)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(grads, again)),
          f"{tag}: a second backward on the same inputs gives the same dq, "
          f"dk, dv bit for bit")
    return dict(q=q, k=k, v=v, do=do, bias=bias, fargs=fargs, bargs=bargs,
                out=out, lse=lse, grads=grads, err=err, bwd_err=bwd_err)


def sdpa_mask(c, causal, dtype):
    """SDPA's arguments for case ``c``'s masking: is_causal, or the key
    bias as a (b, 1, 1, s) float mask."""
    if causal:
        return dict(is_causal=True)
    return dict(attn_mask=c["bias"][:, None, None, :].to(dtype))


def sdpa_backend(q, k, v, mask, rate):
    """The backend SDPA's dispatcher picks for these arguments."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(
        q, k, v, mask.get("attn_mask"), rate,
        mask.get("is_causal", False))).name


def bhsd_fwd_timings(fa, c, b, h, s, d, dtype, causal):
    """The forward kernel's device time on case ``c`` beside its plain
    version's, SDPA's on the same (b, h, s, d) tensors and the bound."""
    q, k, v = c["q"], c["k"], c["v"]
    elt = torch.tensor([], dtype=dtype).element_size()
    mask = sdpa_mask(c, causal, dtype)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, **mask)
    r = timings(lambda: fa.flash_attention_fwd(q, k, v, *c["fargs"]),
                lambda: fa.flash_attention_fwd_plain(q, k, v, *c["fargs"]),
                lib, *attn_cost(False, b, s, h, d, elt, causal), dtype)
    return dict(r, err=c["err"],
                library_backend=sdpa_backend(q, k, v, mask, 0.0))


def bhsd_bwd_timings(fa, c, b, h, s, d, dtype, causal, rate):
    """The backward kernels' device time on case ``c`` beside their plain
    version's, SDPA's backward at the same dropout rate (an autograd call:
    profiler device time) and the bound."""
    q, k, v = c["q"], c["k"], c["v"]
    elt = torch.tensor([], dtype=dtype).element_size()
    bargs = (c["bias"], c["out"], c["lse"], c["do"], *c["bargs"])
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    mask = sdpa_mask(c, causal, dtype)
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, dropout_p=rate, **mask)
    lib = lambda: torch.autograd.grad(lib_out, leaves, c["do"],
                                      retain_graph=True)
    r = timings(lambda: fa.flash_attention_bwd(q, k, v, *bargs),
                lambda: fa.flash_attention_bwd_plain(q, k, v, *bargs),
                lib, *attn_cost(True, b, s, h, d, elt, causal), dtype,
                lib_profiled=True)
    return dict(r, err=c["bwd_err"], dropout=rate,
                library_eager_ms=eager_ms(lib),
                library_backend=sdpa_backend(*leaves, mask, rate))


def kernel_a_cross_check(fa, fap, c, b, h, s, d, rate):
    """The (b, h, s, d) kernels and kernel A on the same fp32 inputs (kernel
    A's in packed layout) with the same seed: out, lse, dq, dk and dv agree
    within TOL_KERNEL_A (both key the dropout mask by batch * heads +
    head)."""
    packed = lambda t: t.transpose(1, 2).reshape(b, s, h * d).contiguous()
    q, k, v, do = (packed(c[n]) for n in ("q", "k", "v", "do"))
    bias, scale, causal, _, _ = c["fargs"]
    out, lse = fap.flash_attention_packed_fwd(q, k, v, h, bias, scale, causal,
                                              rate, SEED)
    grads = fap.flash_attention_packed_bwd(q, k, v, bias, out, lse, do, h,
                                           scale, causal, rate, SEED)
    torch.cuda.synchronize()
    errs = {"out": max_abs(out, packed(c["out"])),
            "lse": max_abs(lse, c["lse"])}
    errs.update({f"d{n}": max_abs(g, packed(mine))
                 for n, g, mine in zip("qkv", grads, c["grads"])})
    for name, e in errs.items():
        check(e <= TOL_KERNEL_A, f"ERNIE-base fp32 dropout {rate}: {name} of "
              f"the (b, h, s, d) kernels vs kernel A: max abs {e:.3g} <= "
              f"{TOL_KERNEL_A}")
    return errs


def bhsd_kernel_phase(gen):
    """(a) each case against the plain versions in fp32 and bf16, forward
    and backward; (b) the ERNIE-base case against kernel A; (c) bf16 times
    (fp32 for ERNIE-base) beside plain, SDPA and the bound."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fap

    results, cross = {}, {}
    for label, b, h, s, d, causal, lengths, rates in BHSD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            timed = dtype == torch.bfloat16 or label == "ERNIE-base"
            for rate in rates:
                tag = (f"(b, h, s, d) attention {label} b{b} h{h} s{s} d{d} "
                       f"{dtag(dtype)} causal={int(causal)} dropout={rate}")
                c = bhsd_case(fa, gen, b, h, s, d, dtype, causal, lengths,
                              rate, tag)
                if label == "ERNIE-base" and dtype == torch.float32 \
                        and rate > 0:
                    cross = kernel_a_cross_check(fa, fap, c, b, h, s, d,
                                                 rate)
                fkey, bkey = (label, dtype, "fwd"), (label, dtype, "bwd")
                if timed and rate == 0.0:
                    results[fkey] = bhsd_fwd_timings(fa, c, b, h, s, d,
                                                     dtype, causal)
                elif timed:
                    results[fkey].update(dropout=rate, dropout_ms=time_ms(
                        lambda: fa.flash_attention_fwd(
                            c["q"], c["k"], c["v"], *c["fargs"])))
                if timed and rate == rates[-1]:
                    results[bkey] = bhsd_bwd_timings(fa, c, b, h, s, d,
                                                     dtype, causal, rate)
                del c
            torch.cuda.empty_cache()
    for (label, dtype, kind), r in results.items():
        log(f"  (b, h, s, d) {kind} {label} {dtag(dtype)}: {r['ms']:.4f} ms "
            f"(eager {r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
            f"SDPA {r['library_ms']:.4f} ms ({r['library_backend']}), "
            f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
    return results, cross


@contextlib.contextmanager
def split_route():
    """``MultiHeadAttention``'s split-head route for every head layout: the
    packed dispatch's layout gate swapped, as a module attribute, for one
    that refuses every layout (as ``plain_wrappers`` swaps the wrappers)."""
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fap

    saved = fap.head_layout_ok
    fap.head_layout_ok = lambda num_heads, head_dim: False
    try:
        yield
    finally:
        fap.head_layout_ok = saved


def bhsd_model_phase(seed, packed_tokens_per_s):
    """(d) full-width ERNIE-base through the split-head route: the bf16
    serving forward at b8 s512 (launches, logits against the packed route,
    times), the fp32 L2 b8 train step against the packed route (loss and
    every gradient), and the bf16 b64 s512 step (launches, falling loss,
    tokens/s beside the packed route's from phase 4)."""
    from paddle_tpu_torch import convert, entry
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.text.ernie import (
        ErnieConfig,
        ErnieForPretraining,
        ErniePretrainingCriterion,
    )

    cfg = ErnieConfig()
    L, seq = cfg.num_hidden_layers, TRAIN_SEQ
    n_mask = max(1, int(seq * 0.15))
    crit = ErniePretrainingCriterion(cfg.vocab_size)
    rng = np.random.default_rng(seed + 1)
    gen = torch.Generator().manual_seed(seed)
    out = {}

    log(f"[bhsd] ERNIE-base serving forward through the split-head route, "
        f"bf16 b8 s{seq}")
    model = ErnieForPretraining(cfg, device=DEV, generator=gen).eval().to(
        torch.bfloat16)
    ids = torch.randint(5, cfg.vocab_size, (8, seq), generator=gen)
    ids[-2:, 3 * seq // 4:] = 0
    ids = ids.to(DEV)
    fwd = lambda: model(ids)
    with torch.inference_mode():
        ref = fwd()
        graphed = {"packed": time_ms(fwd, reps=5)}
        with split_route():
            config.reset_counts()
            got = fwd()
            torch.cuda.synchronize()
            counts = config.launch_counts()
            graphed["split"] = time_ms(fwd, reps=5)
    check(counts.get("flash_attention", 0) == L
          and counts.get("flash_attention_packed", 0) == 0,
          f"split-head forward: {counts.get('flash_attention', 0)} (b, h, s, "
          f"d) and {counts.get('flash_attention_packed', 0)} packed "
          f"attention launches ({L} and 0)")
    r = max(rel_err(g, p) for g, p in zip(got, ref))
    check(r <= TOL_BF16_REL, f"split-head bf16 logits vs the packed route: "
          f"rel err {r:.3g} <= {TOL_BF16_REL} (bitwise equal: "
          f"{all(torch.equal(g, p) for g, p in zip(got, ref))})")
    tokens = ids.numel()
    for route, ms in graphed.items():
        log(f"  bf16 forward b8 s{seq}, {route} route: CUDA graph {ms:.3f} ms "
            f"= {tokens / ms * 1e3:.1f} tokens/s")
    out["serving"] = dict(launches=counts, graph_ms=graphed,
                          logits_rel_err_vs_packed=r)
    del model, ref, got

    log(f"[bhsd] fp32 L2 b8 s{seq} train step, dropout "
        f"{cfg.attention_probs_dropout_prob}: split-head vs packed route")
    model = ErnieForPretraining(ErnieConfig(num_hidden_layers=2), device=DEV,
                                generator=torch.Generator().manual_seed(seed))
    step = entry.make_train_step(model, crit, _GradCapture())
    batch = pretrain_batch(rng, 8, seq, cfg.vocab_size, n_mask, pad_rows=2)
    params = convert.parameters_dict(model)
    grads_p, _, loss_p = step(params, None, batch,
                              torch.Generator().manual_seed(seed))
    with split_route():
        config.reset_counts()
        grads_s, _, loss_s = step(params, None, batch,
                                  torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        counts = config.launch_counts()
    check(counts.get("flash_attention", 0) == 2
          and counts.get("flash_attention_bwd", 0) == 2
          and not counts.get("flash_attention_packed", 0)
          and not counts.get("flash_attention_packed_bwd", 0),
          f"split-head L2 step launches 2 / 2 (b, h, s, d) kernels, no "
          f"packed one: {counts}")
    steps_agree(loss_s, grads_s, loss_p, grads_p, "the packed route")
    del model, step, grads_p, grads_s, params

    b = TRAIN_BATCH
    log(f"[bhsd] bf16 ERNIE-base b{b} s{seq} train steps through the "
        f"split-head route")
    model = ErnieForPretraining(cfg, device=DEV,
                                generator=torch.Generator().manual_seed(seed))
    params = convert.parameters_dict(model)
    opt = Adam(learning_rate=1e-4)
    state = opt.init(params)
    step = entry.make_train_step(model, crit, opt, torch.bfloat16)
    batch = pretrain_batch(rng, b, seq, cfg.vocab_size, n_mask)
    gen = torch.Generator().manual_seed(seed)
    with split_route():
        config.reset_counts()
        params, state, loss = step(params, state, batch, gen)
        torch.cuda.synchronize()
        counts = config.launch_counts()
        losses = [loss]
        t0 = time.perf_counter()
        for _ in range(1, BHSD_TRAIN_STEPS):
            params, state, loss = step(params, state, batch, gen)
            losses.append(loss)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / (BHSD_TRAIN_STEPS - 1) * 1e3
        log("[bhsd] split-head route, profiled:")
        profile_steps(step, params, state, batch, gen)
    want = {"flash_attention": L, "flash_attention_bwd": L,
            "flash_attention_packed": 0, "flash_attention_packed_bwd": 0}
    for name, n in want.items():
        check(counts.get(name, 0) == n, f"split-head b{b} step: "
              f"{counts.get(name, 0)} launches of {name} ({n})")
    losses = torch.stack(losses).tolist()
    log(f"  losses: {[round(x, 4) for x in losses]}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"split-head loss finite and falling over {BHSD_TRAIN_STEPS} steps: "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    toks = b * seq / step_ms * 1e3
    log(f"[bhsd] bf16 step b{b} s{seq}, split-head route (eager, mean of "
        f"steps 1-{BHSD_TRAIN_STEPS - 1}): {step_ms:.2f} ms = {toks:.1f} "
        f"tokens/s; packed route (phase 4): {packed_tokens_per_s:.1f} "
        f"tokens/s; split / packed {toks / packed_tokens_per_s:.3f}")
    out["train"] = dict(launches=counts, step_ms=step_ms, tokens_per_s=toks,
                        packed_tokens_per_s=packed_tokens_per_s,
                        share_of_packed=toks / packed_tokens_per_s,
                        losses=losses)
    return counts, out


# -- phase 6: paged attention and the paged decode slice ----------------------

def paged_cost(lens, block_size, d, kv_elt, q_elt, quantized, shared=False):
    """(bytes, flops) that one paged-attention call needs for these
    lengths: K and V of the live tokens at the storage type, the live table
    entries (and int8 scale pairs), q, out and the lengths; ~4 d + 5 flops a
    token and row.  Rows that share one table (``shared``) need its live
    tokens once: those of the longest row."""
    lens = lens.long()
    n = lens.numel()
    flops = int(lens.sum()) * (4 * d + 5)
    if shared:
        lens = lens.max().reshape(1)
    tokens = int(lens.sum())
    blocks = int(((lens + block_size - 1) // block_size).sum())
    nbytes = (2 * tokens * d * kv_elt + blocks * 4 + n * 4
              + 2 * n * d * q_elt + (blocks * 8 if quantized else 0))
    return nbytes, flops


def paged_inputs(gen, rng, num_seqs, max_blocks, block_size, d, max_len,
                 lens=None):
    """fp32 q and caches over a pool of num_seqs * max_blocks blocks plus
    the null block, tables a random permutation, int8 blocks with random
    per-block scales, and ragged lengths 1..max_len from ``rng`` with rows
    of 0, 3, one block and the full table (unless ``lens`` is given)."""
    nb = num_seqs * max_blocks + 1
    q = torch.randn((num_seqs, d), generator=gen).to(DEV)
    k = torch.randn((nb, block_size, d), generator=gen).to(DEV)
    v = torch.randn((nb, block_size, d), generator=gen).to(DEV)
    k8, v8 = (torch.randint(-127, 128, (nb, block_size, d), generator=gen,
                            dtype=torch.int8).to(DEV) for _ in range(2))
    scales = (torch.rand((nb, 2), generator=gen) * 0.09 + 0.01).to(DEV)
    tables = (torch.from_numpy(rng.permutation(nb - 1)[:num_seqs * max_blocks]
                               + 1).int().reshape(num_seqs, max_blocks)
              .to(DEV))
    if lens is None:
        lens = rng.integers(1, max_len + 1, num_seqs)
        lens[:4] = [0, 3, block_size, max_blocks * block_size]
    lens = torch.from_numpy(np.asarray(lens, np.int32)).to(DEV)
    return dict(q=q, k=k, v=v, k8=k8, v8=v8, scales=scales, tables=tables,
                lens=lens)


def paged_oracle64(q, k, v, tables, lens, kv_scales):
    """Paged attention over int8 blocks in float64: the blocks times their
    scales (exact in float64), the scores, softmax and weighted sum."""
    tb = tables.long()
    s = kv_scales[tb].double()
    kg = k[tb].double() * s[..., 0, None, None]
    vg = v[tb].double() * s[..., 1, None, None]
    n, d = q.shape
    span = tb.shape[1] * k.shape[1]
    kg, vg = kg.reshape(n, span, d), vg.reshape(n, span, d)
    scores = torch.einsum("sd,smd->sm", q.double(), kg) / math.sqrt(d)
    valid = (torch.arange(span, device=q.device)[None, :]
             < lens.long()[:, None])
    scores = scores.masked_fill(~valid, -math.inf)
    p = torch.where(valid, torch.exp(scores - scores.amax(-1, keepdim=True)
                                     .clamp_min(-1e300)), 0.0)
    return (torch.einsum("sm,smd->sd", p, vg)
            / p.sum(-1, keepdim=True).clamp_min(1e-300))


def paged_chunk(gen, rng, start, rows, width, bs, d):
    """A prefill chunk's layout: ``rows`` rows sharing one table of
    ``width`` blocks (row stride 0), lengths start+1..start+rows."""
    chunk = paged_inputs(gen, rng, 1, width, bs, d, 0, lens=[0])
    chunk.update(q=torch.randn((rows, d), generator=gen).to(DEV),
                 tables=chunk["tables"].expand(rows, width),
                 lens=torch.arange(start + 1, start + rows + 1,
                                   dtype=torch.int32, device=DEV))
    return chunk


def paged_fail_draw(rows, width, bs, d):
    """PAGED_FAIL_DRAW's chunk, from generators of its own."""
    gen = torch.Generator().manual_seed(0)
    left = PAGED_FAIL_DRAW["words"]
    while left:   # one 32-bit word an element
        n = min(left, 1 << 24)
        torch.randint(0, 2, (n,), generator=gen, dtype=torch.int8)
        left -= n
    rng = np.random.default_rng()
    rng.bit_generator.state = PAGED_FAIL_DRAW["rng"]
    start = int(rng.integers(0, width * bs - rows + 1))
    chunk = paged_chunk(gen, rng, start, rows, width, bs, d)
    f = PAGED_FAIL_DRAW
    check(start == f["start"] and float(chunk["q"][0, 0]) == f["q00"]
          and int(chunk["k8"].long().sum()) == f["k8_sum"]
          and int(chunk["v8"].long().sum()) == f["v8_sum"],
          "the recorded failing paged draw is reproduced")
    return chunk, start


def paged_kernel_case(pa, t, dtype, tag):
    """The kernel against its plain version on ``t`` in ``dtype`` (float32,
    bfloat16: q and caches rounded to bf16; int8: the int8 blocks, fp32 q),
    and a second call bit for bit.  Returns (run, plain, library, cost, max
    abs err, cache dtype)."""
    F = torch.nn.functional
    q, tb, lens = t["q"], t["tables"], t["lens"]
    kw = {}
    if dtype == torch.int8:
        k, v, kw = t["k8"], t["v8"], {"kv_scales": t["scales"]}
    elif dtype == torch.bfloat16:
        q, k, v = (x.to(dtype) for x in (q, t["k"], t["v"]))
    else:
        k, v = t["k"], t["v"]
    run = lambda: pa.paged_attention(q, k, v, tb, lens, **kw)
    plain = lambda: pa.paged_attention_plain(q, k, v, tb, lens, **kw)
    out = run()
    torch.cuda.synchronize()
    ref = plain()
    err = max_abs(out, ref)
    label = " ".join(x for x in ("paged_attention", tag, dtag(dtype)) if x)
    if dtype == torch.bfloat16:
        ref32 = pa.paged_attention_plain(q.float(), k.float(), v.float(), tb,
                                         lens)
        r = rel_err(out, ref32)
        check(r <= TOL_PAGED_BF16_REL, f"{label}: rel err vs fp32 plain "
              f"{r:.3g} <= {TOL_PAGED_BF16_REL} (max abs vs bf16 plain "
              f"{err:.3g})")
    elif dtype == torch.int8:
        sv = t["scales"][:, 1]
        v_max = float((v.abs().amax(dim=(1, 2)).float() * sv).max())
        ref64 = paged_oracle64(q, k, v, tb, lens, t["scales"])
        for what, r in (("plain", ref.double()), ("float64", ref64)):
            excess = float(((out.double() - r).abs() - TOL_PAGED_FP32
                            * (v_max + r.abs())).max())
            check(excess <= 0, f"{label}: |err| <= 2e-5 (v_max + |{what}|),"
                  f" v_max {v_max:.3g} (max abs err "
                  f"{max_abs(out.double(), r):.3g})")
        log(f"  {label}: max abs vs float64: kernel "
            f"{max_abs(out.double(), ref64):.3g}, plain "
            f"{max_abs(ref.double(), ref64):.3g}")
    else:
        excess = float(((out - ref).abs() - TOL_PAGED_FP32
                        * (1 + ref.abs())).max())
        check(excess <= 0, f"{label}: |err| <= 2e-5 + 2e-5 |plain| "
              f"(max abs err {err:.3g})")
    zero = lens == 0
    check(bool((out[zero] == 0).all()), f"{label}: {int(zero.sum())} rows "
          f"of length 0 are exactly 0")
    check(torch.equal(run(), out), f"{label}: a second call equals the "
          f"first bit for bit")
    # library yardstick: SDPA over K/V gathered beforehand (gather
    # excluded); rows sharing one table attend to one gathered K/V
    shared = tb.stride(0) == 0
    n, d = q.shape
    span = tb.shape[1] * k.shape[1]
    tg = tb[:1].long() if shared else tb.long()
    kg, vg = k[tg], v[tg]
    if dtype == torch.int8:
        s = t["scales"][tg]
        kg = kg.float() * s[..., 0, None, None]
        vg = vg.float() * s[..., 1, None, None]
    heads = 1 if shared else n
    kg, vg = (x.reshape(heads, 1, span, d) for x in (kg, vg))
    qg = q.reshape(heads, 1, n // heads, d).to(kg.dtype)
    mask = (torch.arange(span, device=DEV)[None, :] < lens.long()[:, None]
            ).reshape(heads, 1, n // heads, span)
    lib = lambda: F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    cost = paged_cost(lens, k.shape[1], d, k.element_size(),
                      q.element_size(), dtype == torch.int8, shared)
    return run, plain, lib, cost, err, dtype


def paged_timings(run, plain, lib, cost, err, dtype):
    """A case's CUDA-graph times (kernel, plain version, SDPA) beside its
    bound.  The products' peak is the cache type's: bf16 x bf16 products
    are exact in fp32, so tensor cores could take them; fp32 and int8
    caches meet an fp32 q."""
    peak = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    return dict(ms=time_ms(run), eager_ms=eager_ms(run),
                plain_ms=time_ms(plain), library_ms=time_ms(lib),
                bound=bound(*cost, peak), bytes=cost[0], err=err)


def paged_server_inputs(seed):
    """The paged server's own launches (PAGED_DECODE, PAGED_CHUNK): a
    decode step and a prefill chunk, from generators of their own."""
    gen = torch.Generator().manual_seed(seed + 1)
    rng = np.random.default_rng(seed + 1)
    bs, d = (PAGED_KERNEL_SHAPE[k] for k in ("block_size", "d"))
    c = PAGED_DECODE
    lens = rng.integers(c["len_lo"], c["len_hi"] + 1, c["rows"])
    lens[:c["idle"]] = 0
    dec = paged_inputs(gen, rng, c["rows"], c["width"], bs, d, 0, lens=lens)
    c = PAGED_CHUNK
    chunk = paged_chunk(gen, rng, c["start"], c["rows"], c["width"], bs, d)
    return dec, chunk


def paged_server_cases(pa, seed):
    """The paged server's own launches in the three cache types."""
    dec, chunk = paged_server_inputs(seed)
    out = {}
    for name, t, tag in (
            ("decode64", dec, f"decode step: {PAGED_DECODE['rows']} rows, own "
             f"tables of {PAGED_DECODE['width']}, mean length "
             f"{float(dec['lens'].float().mean()):.0f}, "
             f"{PAGED_DECODE['idle']} of 0"),
            ("chunk64", chunk, f"prefill chunk: {PAGED_CHUNK['rows']} rows on "
             f"one stride-0 table of {PAGED_CHUNK['width']}, lengths "
             f"{PAGED_CHUNK['start'] + 1}..{PAGED_CHUNK['start'] + 64}")):
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            out[(name, dtype)] = paged_timings(
                *paged_kernel_case(pa, t, dtype, tag))
            torch.cuda.empty_cache()
    del dec, chunk
    return out


def paged_kernel_phase(gen, seed):
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    S, MB, bs, d, max_len = (PAGED_KERNEL_SHAPE[k] for k in (
        "num_seqs", "max_blocks", "block_size", "d", "max_len"))
    rng = np.random.default_rng(seed)
    t = paged_inputs(gen, rng, S, MB, bs, d, max_len)
    cache_mb = {dt: 2 * t["k"].numel() * e / 1e6 for dt, e in (
        (torch.float32, 4), (torch.bfloat16, 2), (torch.int8, 1))}
    log(f"[paged] kernel: {S} rows x {MB} blocks of {bs}, d {d}, pool "
        f"{S * MB} blocks + null; lengths 1..{max_len} (mean "
        f"{float(t['lens'].float().mean()):.1f}, rows of 0/3/{bs}/{MB * bs}); "
        f"K+V {', '.join(f'{dtag(k)} {v:.0f} MB' for k, v in cache_mb.items())}")
    results = {}
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        case = paged_kernel_case(pa, t, dtype, "")
        results[dtype] = paged_timings(*case)
        full = pa.paged_attention_cost(S, MB, bs, d,
                                       1 if dtype == torch.int8 else
                                       (2 if dtype == torch.bfloat16 else 4))
        results[dtype]["full_table_bytes"] = full[1]
        del case
        torch.cuda.empty_cache()
    small = paged_inputs(gen, rng, 4, 3, 8, 32, 24, lens=[0, 3, 8, 24])
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        paged_kernel_case(pa, small, dtype, "4 rows x 3 blocks of 8, d 32")
    # a prefill chunk's layout: its rows share one table (row stride 0),
    # lengths start+1..start+rows
    rows, width = (PAGED_SERVE[k] for k in ("prefill_chunk",
                                            "max_blocks_per_seq"))
    start = int(rng.integers(0, width * bs - rows + 1))
    chunk = paged_chunk(gen, rng, start, rows, width, bs, d)
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        paged_kernel_case(pa, chunk, dtype, f"{rows} rows sharing one table "
                          f"of {width} (stride 0), lengths {start + 1}.."
                          f"{start + rows}")
    fail, fstart = paged_fail_draw(rows, width, bs, d)
    for dtype in (torch.float32, torch.int8):
        paged_kernel_case(pa, fail, dtype, f"the recorded stride-0 draw, "
                          f"lengths {fstart + 1}..{fstart + rows}")
    del t, small, chunk, fail
    torch.cuda.empty_cache()
    server = paged_server_cases(pa, seed)
    rows = [(f"{S} rows", dtype, r) for dtype, r in results.items()]
    rows += [(name, dtype, r) for (name, dtype), r in server.items()]
    for name, dtype, r in rows:
        log(f"  paged_attention {name} {dtag(dtype)}: {r['ms']:.4f} ms (eager "
            f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms (F.scaled_dot_product_attention"
            f" on K/V gathered beforehand, gather excluded), bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}, {r['bytes'] / 1e6:.2f}"
            f" MB of live context{', unique' if 'chunk' in name else ''}; "
            f"{r['bound'][0] / r['ms']:.2f} of it); max abs err vs plain "
            f"{r['err']:.3g}")
    return results, server


def serve_traffic(rng, cfg):
    """``requests`` prompts of prompt_lo..prompt_hi tokens; ``shared`` of
    them, at random places, begin with one system prompt of system_len
    tokens (and are longer than it, so its full blocks can be shared)."""
    vocab = cfg["vocab"]
    system = rng.integers(1, vocab, cfg["system_len"]).tolist()
    shared = set(rng.choice(cfg["requests"], cfg["shared"],
                            replace=False).tolist())
    prompts = []
    for i in range(cfg["requests"]):
        if i in shared:
            n = int(rng.integers(cfg["system_len"] + 1, cfg["prompt_hi"] + 1))
            prompts.append(system + rng.integers(
                1, vocab, n - cfg["system_len"]).tolist())
        else:
            n = int(rng.integers(cfg["prompt_lo"], cfg["prompt_hi"] + 1))
            prompts.append(rng.integers(1, vocab, n).tolist())
    return prompts, sorted(shared)


# The profiler ranges of a slice run's prefill chunks and decode steps.
SLICE_RANGES = ("paged.prefill_chunk", "paged.decode_step")


def in_range(name, fn):
    """``fn`` called inside a profiler range ``name``."""
    def ranged(*args):
        with torch.profiler.record_function(name):
            return fn(*args)
    return ranged


def serve_once(model, prompts, cfg, kv_dtype="float32", kernel=True,
               num_blocks=None, ranges=False, cache=None):
    """Decode ``prompts`` through a fresh cache (or ``cache``, built by the
    caller) and decoder; returns the tokens and what the run counted and
    timed.  ``ranges``: each prefill chunk and decode step in a profiler
    range (SLICE_RANGES)."""
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.serving import PagedDecoder, PagedKVCache
    from paddle_tpu_torch.serving import paged as P
    from paddle_tpu_torch.utils import monitor

    if cache is None:
        cache = PagedKVCache(model, num_blocks or cfg["num_blocks"],
                             cfg["block_size"], kv_dtype=kv_dtype)
    dec = PagedDecoder(model, cache, max_seqs=cfg["max_seqs"],
                       max_blocks_per_seq=cfg["max_blocks_per_seq"],
                       prefill_chunk=cfg["prefill_chunk"])
    steps, hits = [0], []
    joined, waiting, first = [], [], {}
    decode_step, try_join, step = dec._decode_step, dec.try_join, dec.step
    if ranges:
        dec._prefill_step = in_range(SLICE_RANGES[0], dec._prefill_step)
        decode_step = in_range(SLICE_RANGES[1], decode_step)

    def counted_decode_step(width):
        steps[0] += 1
        return decode_step(width)

    def counted_try_join(prompt, max_new_tokens):
        before = P.KV_PREFIX_HITS.value()
        h = try_join(prompt, max_new_tokens)
        if h is not None:       # decode() joins in prompt order
            hits.append(int(P.KV_PREFIX_HITS.value() - before))
            waiting.append((len(joined), h))
            joined.append(time.perf_counter())
        return h

    def timed_step():
        n = step()
        now = time.perf_counter()
        for i, h in [w for w in waiting if w[1].tokens]:
            first[i] = now
            waiting.remove((i, h))
        return n

    # count live decode steps and each request's prefix hits; time each
    # request's first token (a step returns once its tokens are on the host)
    dec._decode_step, dec.try_join = counted_decode_step, counted_try_join
    dec.step = timed_step
    flags.set_flags({"use_paged_attention": kernel})
    monitor.default_registry().reset()
    torch.cuda.synchronize()
    config.reset_counts()
    t0 = time.perf_counter()
    try:
        tokens = dec.decode(prompts, cfg["max_new"])
    finally:
        flags.set_flags({"use_paged_attention": True})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = config.launch_counts().get("paged_attention", 0)
    if len(first) != len(prompts):
        raise AssertionError(f"chip_smoke check failed: {len(first)} of "
                             f"{len(prompts)} first tokens timed")
    from_join = [(first[i] - joined[i]) * 1e3 for i in range(len(prompts))]
    from_call = [(first[i] - t0) * 1e3 for i in range(len(prompts))]
    ttft = {}
    for q in (50, 99):
        hist = P.TTFT_MS.percentile(q)
        lo = max((b for b in P.TTFT_MS.buckets if b < hist), default=0.0)
        hi = min((b for b in P.TTFT_MS.buckets if b >= hist),
                 default=float("inf"))
        ttft.update({f"ttft_p{q}_ms": float(np.percentile(from_join, q)),
                     f"ttft_call_p{q}_ms": float(np.percentile(from_call, q)),
                     f"ttft_hist_p{q}_ms": hist,
                     f"ttft_hist_p{q}_bucket_ms": [lo, hi]})
    return dict(tokens=tokens, wall_s=wall, launches=launches,
                decode_steps=steps[0], hits=hits,
                chunks=int(P.KV_PREFILL_CHUNKS.value()),
                prefix_hits=int(P.KV_PREFIX_HITS.value()),
                cache_bytes=cache.bytes, **ttft)


def dense_logits(model, context):
    """The next-token logits after ``context`` (dense, fp32)."""
    dev = model.device
    with torch.no_grad():
        q, k, v = model.qkv(torch.tensor(context, device=dev),
                            torch.arange(len(context), device=dev))
        p = torch.softmax((q[-1:] @ k.T) / model.hidden ** 0.5, dim=-1)
        return ((p @ v) @ model.wo)[0]


def near_tie(model, prompt, ref, got, label):
    """None if ``got == ref``; else the first differing step, which must be
    a near-tie of ``ref``'s context (top-2 logit gap below NEAR_TIE_REL of
    the top logit)."""
    if got == ref:
        return None
    i = next(j for j, (a, b) in enumerate(zip(ref, got)) if a != b)
    top2 = torch.topk(dense_logits(model, prompt + ref[:i]), 2).values
    gap = float(top2[0] - top2[1])
    rel = gap / max(abs(float(top2[0])), 1e-30)
    check(rel < NEAR_TIE_REL, f"{label}: first differs at step {i}, top-2 "
          f"logit gap {gap:.3g} = {rel:.3g} of the top logit < {NEAR_TIE_REL}")
    return i


def int8_kv_check(model, prompts, cfg):
    """The int8 pool a decoder wrote on the card against the fp32 K/V of the
    same contexts: each dequantised value within half its block's scale
    (plus tol for the recomputed K/V), and the int8 kernel's attention of
    each context's last query within the bound those scales imply of fp32
    attention.  A score moves by at most D = sm * |q|_1 * (ks/2 + tol), so
    each softmax weight by a factor within exp(+-2D), and a value by at
    most vs/2 + tol: |out8 - out| <= vs/2 + expm1(2D) max|v| + 2 tol."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.serving import PagedDecoder, PagedKVCache

    cache = PagedKVCache(model, cfg["num_blocks"], cfg["block_size"],
                         kv_dtype="int8")
    dec = PagedDecoder(model, cache, max_seqs=cfg["max_seqs"],
                       max_blocks_per_seq=cfg["max_blocks_per_seq"],
                       prefill_chunk=cfg["prefill_chunk"])
    # streams long enough that none retires before the last one's prefill
    handles = [dec.join(p, cfg["max_positions"] - len(p)) for p in prompts]
    while any(len(h.tokens) < 2 for h in handles):   # prefill + a decode
        dec.step()
    dev, bs, tol = model.device, cache.block_size, TOL_PAGED_FP32
    sm = 1.0 / model.hidden ** 0.5
    excess, held, qs, lens, tables, refs, bounds = (float("-inf"), [], [], [],
                                                    [], [], [])
    with torch.no_grad():
        for h in handles:
            seq = dec._slots[h.slot]
            ctx = h.prompt + h.tokens[:-1]      # what the pool holds
            n = len(ctx)
            held.append(seq.context_len == n)
            q, k, v = model.qkv(torch.tensor(ctx, device=dev),
                                torch.arange(n, device=dev))
            bids = torch.tensor(seq.block_ids, device=dev)
            s = cache.scales[bids].repeat_interleave(bs, dim=0)[:n]
            for pool, ref, sc in ((cache.k, k, s[:, :1]),
                                  (cache.v, v, s[:, 1:])):
                deq = pool[bids].reshape(-1, model.hidden)[:n].float() * sc
                excess = max(excess, float(((deq - ref).abs() - sc / 2
                                            - tol).max()))
            refs.append(torch.softmax((q[-1] @ k.T) * sm, dim=-1) @ v)
            dscore = sm * float(q[-1].abs().sum()) * (
                float(s[:, 0].max()) / 2 + tol)
            bounds.append(float(s[:, 1].max()) / 2 + 2 * tol
                          + math.expm1(2 * dscore) * float(v.abs().max()))
            qs.append(q[-1])
            lens.append(n)
            tables.append(seq.block_ids)
        width = max(map(len, tables))
        tb = torch.tensor([t + [0] * (width - len(t)) for t in tables],
                          dtype=torch.int32, device=dev)
        out = pa.paged_attention(
            torch.stack(qs), cache.k, cache.v, tb,
            torch.tensor(lens, dtype=torch.int32, device=dev), sm_scale=sm,
            kv_scales=cache.scales)
    err = (out - torch.stack(refs)).abs().amax(dim=1).tolist()
    share = max(e / b for e, b in zip(err, bounds))
    for h in handles:
        dec.evict(h)
    check(all(held), f"int8 KV: each pool holds its prompt and all but the "
          f"last generated token")
    check(excess <= 0, f"int8 KV: {len(handles)} contexts ({sum(lens)} "
          f"tokens) stored by the decoder read back within half their "
          f"scale of the fp32 K/V (largest excess over that {excess:.3g})")
    check(share <= 1, f"int8 KV: the kernel's attention over them is "
          f"within the bound the scales imply of fp32 attention (max err "
          f"{max(err):.3g}, at most {share:.3g} of its bound; bounds "
          f"{min(bounds):.3g}-{max(bounds):.3g})")
    return dict(contexts=len(handles), tokens=sum(lens),
                max_attn_err=max(err), max_err_over_bound=share,
                bound_min=min(bounds), bound_max=max(bounds),
                k_scale=cache.k_scale, v_scale=cache.v_scale)


def paged_slice_phase(seed):
    from paddle_tpu_torch.serving import (PagedDecoder, PagedKVCache,
                                          dense_reference_decode,
                                          kv_pool_bytes, make_paged_toy_lm)

    cfg = PAGED_SERVE
    log(f"[paged] slice: paged toy LM vocab {cfg['vocab']} hidden "
        f"{cfg['hidden']} positions {cfg['max_positions']}, random weights "
        f"from seed {seed}; pool {cfg['num_blocks']} blocks of "
        f"{cfg['block_size']} ({kv_pool_bytes(cfg['num_blocks'], cfg['block_size'], cfg['hidden']) / 1e6:.0f} MB fp32), "
        f"{cfg['max_seqs']} rows, tables of {cfg['max_blocks_per_seq']}, "
        f"prefill chunk {cfg['prefill_chunk']}")
    model = make_paged_toy_lm(vocab=cfg["vocab"], hidden=cfg["hidden"],
                              max_positions=cfg["max_positions"], seed=seed,
                              device=DEV)
    rng = np.random.default_rng(seed)
    prompts, shared = serve_traffic(rng, cfg)
    n_prompt = sum(len(p) for p in prompts)
    log(f"  {len(prompts)} requests, {n_prompt} prompt tokens (lengths "
        f"{min(map(len, prompts))}-{max(map(len, prompts))}), {len(shared)} "
        f"behind a {cfg['system_len']}-token system prompt, "
        f"{cfg['max_new']} new tokens each")
    serve_once(model, [prompts[0][:40], prompts[1][:300]], cfg)   # warm-up

    runs = {"kernel": serve_once(model, prompts, cfg)}
    r = runs["kernel"]
    check(r["launches"] > 0 and r["launches"] == r["chunks"]
          + r["decode_steps"], f"paged_attention: {r['launches']} launches "
          f"= {r['chunks']} prefill chunks + {r['decode_steps']} live decode "
          f"steps")
    check(r["prefix_hits"] > 0, f"prefix cache: {r['prefix_hits']} block "
          f"hits")
    n_new = sum(len(t) for t in r["tokens"])
    check(n_new == len(prompts) * cfg["max_new"], f"{n_new} tokens generated")
    runs["plain"] = serve_once(model, prompts, cfg, kernel=False)
    check(runs["plain"]["launches"] == 0, "plain path launches no kernel")
    same = 0
    for i, (p, a, b) in enumerate(zip(prompts, runs["plain"]["tokens"],
                                      r["tokens"])):
        same += near_tie(model, p, a, b, f"request {i} kernel vs plain "
                         f"path") is None
    want = len(prompts) - PAGED_MAX_DIFFERING
    check(same >= want, f"kernel path tokens equal the plain path's for "
          f"{same} of {len(prompts)} requests (>= {want}; the rest "
          f"near-ties)")

    # the oracle: dense_reference_decode on the card, one request with hits
    with_hits = [i for i, n in enumerate(r["hits"]) if n > 0]
    check(len(with_hits) > cfg["cold"], f"{len(with_hits)} requests took "
          f"prefix hits ({sum(r['hits'])} blocks)")
    hit = with_hits[0]
    picks = [hit] + [i for i in range(len(prompts)) if i != hit][
        :cfg["oracle"] - 1]
    for i in picks:
        ref = dense_reference_decode(model, prompts[i], cfg["max_new"])
        step = near_tie(model, prompts[i], ref, r["tokens"][i],
                        f"request {i} vs dense_reference_decode")
        log(f"  request {i} (len {len(prompts[i])}"
            f"{', prefix hits' if i == hit else ''}) vs "
            f"dense_reference_decode: "
            f"{'equal' if step is None else f'near-tie at step {step}'}")

    # prefix-hit requests against the same prompts decoded cold
    for i in with_hits[:cfg["cold"]]:
        cold = serve_once(model, [prompts[i]], cfg, num_blocks=1024)
        check(cold["prefix_hits"] == 0 and cold["tokens"][0] ==
              r["tokens"][i], f"request {i} ({r['hits'][i]} prefix hits in "
              f"the batch): tokens equal the prompt decoded cold")

    runs["int8"] = serve_once(model, prompts, cfg, kv_dtype="int8")
    r8 = runs["int8"]
    runs["int8_plain"] = serve_once(model, prompts, cfg, kv_dtype="int8",
                                    kernel=False)
    same8 = sum(a == b for a, b in zip(runs["int8_plain"]["tokens"],
                                       r8["tokens"]))
    want = len(prompts) - PAGED_MAX_DIFFERING
    check(same8 >= want, f"int8 KV: kernel path tokens equal the plain "
          f"path's for {same8} of {len(prompts)} requests (>= {want})")
    rate = sum(a == b for ta, tb in zip(r8["tokens"], r["tokens"])
               for a, b in zip(ta, tb)) / n_new
    flips, gaps = [], []
    for p, ta, tb in zip(prompts, r8["tokens"], r["tokens"]):
        if ta != tb:
            i = next(j for j, (a, b) in enumerate(zip(ta, tb)) if a != b)
            top2 = torch.topk(dense_logits(model, p + tb[:i]), 2).values
            flips.append(i)
            gaps.append(float((top2[0] - top2[1]) / top2[0].abs()))
    h = INT8_GATE_TOKENS
    head = sum(a == b for ta, tb in zip(r8["tokens"], r["tokens"])
               for a, b in zip(ta[:h], tb[:h])) / (h * len(prompts))
    log(f"  int8 vs fp32: {len(flips)} of {len(prompts)} requests differ; "
        f"first differing step {sorted(flips)}; fp32 top-2 gap there, of "
        f"the top logit: median {np.median(gaps) if gaps else 0:.3g}, max "
        f"{max(gaps, default=0):.3g}; token match over all "
        f"{cfg['max_new']} new tokens {rate:.4f}")
    check(head >= MIN_INT8_MATCH, f"int8 KV tokens match the fp32 kernel "
          f"run at {head:.4f} >= {MIN_INT8_MATCH} over the first {h} new "
          f"tokens of each request")
    check(max(gaps, default=0.0) < INT8_FLIP_GAP_REL, f"int8 KV: every "
          f"first flip is at an fp32 top-2 gap below {INT8_FLIP_GAP_REL} of "
          f"the top logit (max {max(gaps, default=0.0):.3g})")
    want = kv_pool_bytes(cfg["num_blocks"], cfg["block_size"], cfg["hidden"],
                         "int8")
    check(r8["cache_bytes"] == want, f"int8 cache holds {want} bytes "
          f"(kv_pool_bytes)")
    kv8 = int8_kv_check(model, [prompts[i] for i in sorted(
        set(range(cfg["int8_probe"])) | set(shared[:4]))], cfg)

    speed = {}
    for name, run in runs.items():
        speed[name] = dict(
            wall_s=run["wall_s"], decode_tokens_per_s=n_new / run["wall_s"],
            prompt_tokens_per_s=n_prompt / run["wall_s"],
            launches=run["launches"], prefill_chunks=run["chunks"],
            decode_steps=run["decode_steps"], prefix_hits=run["prefix_hits"],
            **{k: v for k, v in run.items() if k.startswith("ttft_")})
        s = speed[name]
        hist = ", ".join(
            f"p{q} in the {b[0]:g}-{b[1]:g} ms bucket"
            for q in (50, 99) for b in [s[f"ttft_hist_p{q}_bucket_ms"]])
        log(f"[paged] {name}: {run['wall_s']:.3f} s wall, "
            f"{s['decode_tokens_per_s']:.1f} generated tokens/s, "
            f"{s['prompt_tokens_per_s']:.1f} prompt tokens/s; TTFT over "
            f"{len(prompts)} requests from join p50 {s['ttft_p50_ms']:.1f} "
            f"ms p99 {s['ttft_p99_ms']:.1f} ms, from the decode() call p50 "
            f"{s['ttft_call_p50_ms']:.1f} ms p99 {s['ttft_call_p99_ms']:.1f}"
            f" ms (serve.ttft_ms histogram: {hist}); {run['chunks']} chunks "
            f"+ {run['decode_steps']} decode steps, {run['prefix_hits']} "
            f"prefix hits")

    # row 9's device time over runs of the first profile_requests
    # requests, prefill chunks and decode steps (the profile of a whole
    # run took ~95 s of trace processing a KV type; the script's run has a
    # time limit)
    sub = prompts[:cfg["profile_requests"]]
    slices = {kv: slice_device_time(
        model, sub, cfg, kv, serve_once(model, sub, cfg, kv_dtype=kv)[
            "tokens"]) for kv in ("float32", "int8")}
    # 20 decode steps of 64 rows at ~1024 tokens of context, profiled
    prof = profile_decode(model, cfg, rng, PagedDecoder, PagedKVCache)
    out = dict(runs=speed, int8_token_match_first8=head,
               int8_token_match=rate, int8_first_flip_steps=sorted(flips),
               int8_flip_gap_max=max(gaps, default=0.0), int8_kv=kv8,
               int8_same_as_plain=same8, same_as_plain=same,
               requests=len(prompts), prompt_tokens=n_prompt,
               generated_tokens=n_new, profile=prof, slice_row9=slices)
    return r["launches"], out


def slice_device_time(model, prompts, cfg, kv_dtype, tokens, log_as=None,
                      kernels=ROW9):
    """A whole run of the slice under torch.profiler, each prefill chunk and
    decode step in a profiler range of its own: row 9's device time (the
    kernels whose names match ``kernels``), split into prefill chunks and
    decode steps by the range in which each kernel started (a step ends on
    a device-to-host copy of its tokens, so its kernels run before the
    next range opens), and the device's busy time, split by kernel name.
    The cache is built (an int8 cache calibrates its scales on the model's
    activations) before the profiler starts, so only serving is counted.
    Its tokens must equal ``tokens`` (an unprofiled run's)."""
    import bisect

    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving import PagedKVCache

    cache = PagedKVCache(model, cfg["num_blocks"], cfg["block_size"],
                         kv_dtype=kv_dtype)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run = serve_once(model, prompts, cfg, kv_dtype=kv_dtype,
                         ranges=True, cache=cache)
    # the ranges' own device-side spans are not kernels
    events = [e for e in device_events(prof) if e[2] not in SLICE_RANGES]
    total = sum(us for us, _, name in events if kernels.search(name)) / 1e3
    cpu = torch.autograd.DeviceType.CPU
    all_events = prof.events()
    ranges = sorted((e.time_range.start, e.name) for e in all_events
                    if e.name in SLICE_RANGES and e.device_type == cpu)
    starts = [r[0] for r in ranges]
    by_range = dict.fromkeys(SLICE_RANGES, 0.0)
    for e in all_events:
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and kernels.search(e.name)):
            i = bisect.bisect_right(starts, e.time_range.start) - 1
            if i >= 0:
                by_range[ranges[i][1]] += e.time_range.elapsed_us() / 1e3
    prefill, decode = by_range[SLICE_RANGES[0]], by_range[SLICE_RANGES[1]]
    label = log_as or f"paged slice run, {kv_dtype} KV"
    check(run["tokens"] == tokens, f"{label}: tokens under the profiler "
          f"equal the unprofiled run's")
    check(abs(prefill + decode - total) <= 1e-3 * total, f"{label}: row 9's "
          f"{total:.3f} ms of device time = prefill chunks {prefill:.3f} ms "
          f"+ decode steps {decode:.3f} ms")
    busy = sum(us for us, _, _ in events) / 1e3
    by_kernel = sorted(((us / 1e3, n, name) for us, n, name in events),
                       reverse=True)
    log(f"[profile] {label}, {len(prompts)} requests: row 9 {total:.3f} ms "
        f"of device time ({run['launches']} launches: {run['chunks']} "
        f"prefill chunks {prefill:.3f} ms, {run['decode_steps']} decode "
        f"steps {decode:.3f} ms); device busy {busy:.2f} ms (cache built "
        f"before the profile), by kernel:")
    for ms, n, name in by_kernel[:15]:
        log(f"  {ms:9.3f} ms  x{n:<6d} {name[:100]}")
    return dict(row9_ms=total, prefill_ms=prefill, decode_ms=decode,
                launches=run["launches"], prefill_chunks=run["chunks"],
                decode_steps=run["decode_steps"], busy_ms=busy,
                wall_s=run["wall_s"],
                busy_by_kernel=[dict(name=name, ms=ms, calls=n)
                                for ms, n, name in by_kernel[:15]])


def profile_decode(model, cfg, rng, PagedDecoder, PagedKVCache):
    from torch.profiler import ProfilerActivity, profile

    n = cfg["max_seqs"]
    cache = PagedKVCache(model, cfg["num_blocks"], cfg["block_size"])
    dec = PagedDecoder(model, cache, max_seqs=n,
                       max_blocks_per_seq=cfg["max_blocks_per_seq"],
                       prefill_chunk=cfg["prefill_chunk"])
    plen = cfg["profile_prompt"]
    max_new = cfg["max_positions"] - plen
    handles = [dec.join(rng.integers(1, cfg["vocab"], plen).tolist(),
                        max_new) for _ in range(n)]
    while any(len(h.tokens) == 0 for h in handles):
        dec.step()
    torch.cuda.synchronize()
    steps = cfg["profile_steps"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        for _ in range(steps):
            dec.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = device_events(p)
    busy = sum(us for us, _, _ in events) / 1e3 / steps
    kernel = sum(us for us, _, name in events
                 if ROW9.search(name)) / 1e3 / steps
    ctx = float(np.mean([len(h.prompt) + len(h.tokens) for h in handles]))
    for h in handles:
        dec.evict(h)
    top = sorted(events, reverse=True)[:8]
    log(f"[profile] paged decode step, {n} rows, mean context {ctx:.0f}: "
        f"{wall_ms:.3f} ms wall (under the profiler), device busy "
        f"{busy:.4f} ms (busy share {busy / wall_ms:.3f}), paged_attention "
        f"{kernel:.4f} ms = {kernel / busy:.3f} of device time, "
        f"{kernel / wall_ms:.3f} of wall")
    for us, count, name in top:
        log(f"  {us / 1e3 / steps:8.4f} ms  x{count // steps:<3d} {name[:90]}")
    return dict(step_wall_ms=wall_ms, device_busy_ms=busy,
                kernel_ms=kernel, kernel_share_of_device=kernel / busy,
                kernel_share_of_wall=kernel / wall_ms, mean_context=ctx,
                rows=n)


# -- phase 7: vision kernels (rows 10 and 13) ---------------------------------

# Row 10 at its main-path shapes: VGG-16's fused convs at b128 (3x3 s1 p1;
# the four in-group shapes, then the first convs of groups 3 and 4, so the
# cases cover all 10 launches of a VGG forward), a 3x3 s2 p1, a 1x1 s2 and
# a 7x7 s2 p3 conv, as (n, h, w, c, o, k, s, p).
CONV_CASES = (
    ("vgg 128->128 16x16", (128, 16, 16, 128, 128, 3, 1, 1)),
    ("vgg 256->256 8x8", (128, 8, 8, 256, 256, 3, 1, 1)),
    ("vgg 512->512 4x4", (128, 4, 4, 512, 512, 3, 1, 1)),
    ("vgg 512->512 2x2", (128, 2, 2, 512, 512, 3, 1, 1)),
    ("vgg 128->256 8x8", (128, 8, 8, 128, 256, 3, 1, 1)),
    ("vgg 256->512 4x4", (128, 4, 4, 256, 512, 3, 1, 1)),
    ("3x3 s2 p1 128->256 16x16", (128, 16, 16, 128, 256, 3, 2, 1)),
    ("1x1 s2 256->512 8x8", (128, 8, 8, 256, 512, 1, 2, 0)),
    ("7x7 s2 p3 128->128 32x32", (32, 32, 32, 128, 128, 7, 2, 3)),
)
CONV_ACT_SHAPE = (2, 8, 8, 128, 128, 3, 1, 1)
# Row 13: VGG-16's four kernel-gated 2x2/2 max pools at b128 (the inputs of
# groups 2-5), then 3x3/2 p1 max, 2x2/2 avg and 3x3/1 p1 non-exclusive avg,
# as (mode, n, h, w, c, k, s, p).
POOL_CASES = (
    ("vgg max 16x16 c128", ("max", 128, 16, 16, 128, 2, 2, 0)),
    ("vgg max 8x8 c256", ("max", 128, 8, 8, 256, 2, 2, 0)),
    ("vgg max 4x4 c512", ("max", 128, 4, 4, 512, 2, 2, 0)),
    ("vgg max 2x2 c512", ("max", 128, 2, 2, 512, 2, 2, 0)),
    ("max 3x3/2 p1 32x32 c128", ("max", 32, 32, 32, 128, 3, 2, 1)),
    ("avg 2x2/2 16x16 c256", ("avg", 128, 16, 16, 256, 2, 2, 0)),
    ("avg 3x3/1 p1 16x16 c128", ("avg", 64, 16, 16, 128, 3, 1, 1)),
)
# Row 13 at the windows phase 7's cases lack (own generators, untimed): a
# max and an average with NaN taps at a compile-time window, the generic
# instantiation at 5x5/1 p2 and 3x2/2 p(0, 1), and VGG's 2x2 c512 pool at
# b2, as (mode, n, h, w, c, (kh, kw), (sh, sw), (ph, pw), NaNs).
POOL_EDGE_CASES = (
    ("max", 8, 15, 17, 256, (3, 3), (2, 2), (1, 1), True),
    ("avg", 8, 16, 16, 128, (2, 2), (2, 2), (0, 0), True),
    ("max", 16, 9, 6, 128, (5, 5), (1, 1), (2, 2), False),
    ("avg", 16, 9, 6, 128, (5, 5), (1, 1), (2, 2), False),
    ("max", 16, 7, 9, 256, (3, 2), (2, 2), (0, 1), False),
    ("avg", 16, 7, 9, 256, (3, 2), (2, 2), (0, 1), True),
    ("max", 2, 2, 2, 512, (2, 2), (2, 2), (0, 0), False),
)
TOL_CONV_FP32_REL = 1e-4     # of the largest value: same fp32 sums, reordered
# The static phase's VGG kernel launches per forward, pinned on the CPU by
# tests/test_torch_static.py (the JAX dispatch at full width): 10 fused
# convs (group 2's second, groups 3-5) and the 4 pools of groups 2-5; the
# tower's 1 / 2.
STATIC_LAUNCHES = {"vgg16_bn_drop": {"conv2d_bn_act": 10, "max_pool2d": 4},
                   "conv_tower": {"conv2d_bn_act": 1, "max_pool2d": 2}}
STATIC_BATCH = {"vgg16_bn_drop": 128, "conv_tower": 64}
STATIC_REPS = 10       # runs a timed block
STATIC_BLOCKS = 8      # blocks, alternating pipeline on / off / off / on
TOL_STATIC_REL = 1e-4        # of each fetch's largest value


def conv_case(cf, gen, dims, dtype, act, timed=True):
    """Row 10 against its plain version (fp32 relative to the largest value,
    bf16 against the fp32 plain version); with ``timed`` its times beside
    the plain version's, cuDNN's on the folded weights (channels-last, plus
    the act) and the bound."""
    n, h, w, c, o, k, s, p = dims
    x = randn(gen, (n, h, w, c), dtype)
    wt = randn(gen, (o, c, k, k), dtype, 1.0 / math.sqrt(c * k * k))
    a = randn(gen, (o,), torch.float32, 0.2, 1.0)
    b = randn(gen, (o,), torch.float32, 0.5)
    args = ((s, s), (p, p), act)
    with torch.no_grad():
        run = lambda: cf.conv2d_bn_act(x, wt, a, b, *args)
        plain = lambda: cf.conv2d_bn_act_plain(x, wt, a, b, *args)
        got = run()
        torch.cuda.synchronize()
        ref32 = cf.conv2d_bn_act_plain(x.float(), wt.float(), a, b, *args)
        err = max_abs(got, plain())
        splits = cf.conv_plan(n, h, w, c, o, k, k, s, s, p, p, dtype).splits
        tag = f"conv2d_bn_act n{n} {h}x{w} {c}->{o} k{k} s{s} p{p} " \
              f"{dtag(dtype)} act={act or 'none'} (K splits {splits})"
        check(torch.equal(run(), got), f"{tag}: a second call repeats the "
              f"output bit for bit")
        r = rel_err(got, ref32)
        if dtype == torch.float32:
            check(r <= TOL_CONV_FP32_REL, f"{tag}: rel err {r:.3g} <= "
                  f"{TOL_CONV_FP32_REL}")
        else:
            check(r <= TOL_BF16_REL, f"{tag}: rel err vs fp32 plain {r:.3g}"
                  f" <= {TOL_BF16_REL} (max abs vs bf16 plain {err:.3g})")
        if not timed:
            return dict(err=err, splits=splits)
        wf = (wt * a.to(dtype).reshape(-1, 1, 1, 1)).contiguous(
            memory_format=torch.channels_last)
        bf = b.to(dtype)
        xc = x.permute(0, 3, 1, 2)
        lib = lambda: cf.apply_act(torch.nn.functional.conv2d(
            xc, wf, bf, s, p), act)
        elt = x.element_size()
        oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
        flops, nbytes = cf.conv_cost(n, oh, ow, c, o, k, k, elt, h, w)
        return dict(timings(run, plain, lib, nbytes, flops, dtype), err=err,
                    flops=flops, splits=splits)


def pool_case(pl, gen, dims, dtype, timed=True, nans=False):
    """Row 13 against its plain version (bit for bit: the same taps in the
    same order, NaNs where the plain version has them); with ``timed`` its
    times beside the plain version's, PyTorch's pooling on a channels-last
    view and the bound.  k, s, p: ints or (h, w) pairs."""
    mode, n, h, w, c, k, s, p = dims
    (kh, kw), (sh, sw), (ph, pw) = (
        (v, v) if isinstance(v, int) else tuple(v) for v in (k, s, p))
    x = randn(gen, (n, h, w, c), dtype)
    if nans:   # NaN in 3% of the inputs
        where = torch.rand((n, h, w, c), generator=gen) < 0.03
        x = torch.where(where.to(DEV), torch.full_like(x, float("nan")), x)
    args = ((kh, kw), (sh, sw), (ph, pw))
    fn = pl.max_pool2d_nhwc if mode == "max" else pl.avg_pool2d_nhwc
    plain_fn = (pl.max_pool2d_nhwc_plain if mode == "max"
                else pl.avg_pool2d_nhwc_plain)
    run = lambda: fn(x, *args)
    plain = lambda: plain_fn(x, *args)
    got = run()
    torch.cuda.synchronize()
    ref = plain()
    plan = pl.pool_plan(n, h, w, c, kh, kw, sh, sw, dtype, ph, pw)
    window = "generic" if plan.window == pl.GENERIC_WINDOW else "fixed"
    tag = (f"{mode}_pool2d n{n} {h}x{w} c{c} k{kh}x{kw} s{sh}x{sw} "
           f"p{ph}x{pw} {dtag(dtype)} ({window} window, {plan.threads} "
           f"threads)")
    nan = got.isnan()
    check(torch.equal(nan, ref.isnan())
          and torch.equal(got.nan_to_num(), ref.nan_to_num()),
          f"{tag}: bit for bit the plain version"
          + (f" ({int(nan.sum())} NaN outputs)" if nans else ""))
    check(torch.equal(bits(run()), bits(got)),
          f"{tag}: a second call repeats the output bit for bit")
    if not timed:
        return None
    err = max_abs(got, ref)
    xc = x.permute(0, 3, 1, 2)
    F = torch.nn.functional
    lib = ((lambda: F.max_pool2d(xc, args[0], args[1], args[2]))
           if mode == "max" else
           (lambda: F.avg_pool2d(xc, args[0], args[1], args[2],
                                 count_include_pad=True)))
    oh, ow = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
    flops, nbytes = pl.pool_cost(n, oh, ow, c, kh, kw, x.element_size(), h,
                                 w)
    return dict(timings(run, plain, lib, nbytes, flops, dtype), err=err,
                mode=mode)


def vision_kernel_phase(gen):
    """Rows 10 and 13 against their plain versions at their main-path
    shapes in fp32 (cuDNN's TF32 off) and bf16, with their times."""
    from paddle_tpu_torch.ops.kernels import conv_fused as cf
    from paddle_tpu_torch.ops.kernels import pooling as pl

    log("[vision kernels] rows 10 and 13 against their plain versions "
        "(fp32 without TF32: torch.backends.cudnn.allow_tf32 = False)")
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, dims in CONV_CASES:
            results[("conv", label, dtype)] = conv_case(cf, gen, dims, dtype,
                                                        "relu")
        for act in cf.EPILOGUE_ACTS:
            conv_case(cf, gen, CONV_ACT_SHAPE, dtype, act, timed=False)
        for label, dims in POOL_CASES:
            results[("pool", label, dtype)] = pool_case(pl, gen, dims, dtype)
    edge = torch.Generator().manual_seed(SEED + 13)
    for dtype in (torch.float32, torch.bfloat16):
        for *dims, nans in POOL_EDGE_CASES:
            pool_case(pl, edge, tuple(dims), dtype, timed=False, nans=nans)
    check(sum(pl.pool_plan(*d[1:5], *d[5], *d[6], torch.float32, *d[7])
              .window == pl.GENERIC_WINDOW for d in POOL_EDGE_CASES) == 4,
          "row 13 edge cases: 4 of them take the generic window")
    for (kind, label, dtype), r in results.items():
        name = "conv2d_bn_act" if kind == "conv" else f"{r['mode']}_pool2d"
        extra = (f", K splits {r['splits']}, factor against the library "
                 f"{r['ms'] / r['library_ms']:.2f}" if kind == "conv" else "")
        log(f"  {name} {label} {dtag(dtype)}: {r['ms']:.4f} ms (eager "
            f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]}){extra}")
    return results


# -- phase 8: static-graph vision inference -----------------------------------

def conv_tower(static, L, nets, seed):
    """bench_vision.py's conv tower at its TPU settings (ch 128, 32 x 32):
    conv/BN(relu)/max-pool twice, then fc 10."""
    main, startup = static.Program(), static.Program()
    main.random_seed = startup.random_seed = seed
    with static.program_guard(main, startup):
        img = L.data("img", [3, 32, 32])
        h = L.conv2d(img, 128, 3, padding=1)
        h = L.batch_norm(h, act="relu", is_test=True)
        h = L.pool2d(h, 2, "max", 2)
        h = L.conv2d(h, 128, 3, padding=1)
        h = L.batch_norm(h, act="relu", is_test=True)
        h = L.pool2d(h, 2, "max", 2)
        out = L.fc(L.flatten(h), 10)
    return main, startup, [out.name]


def vgg16_bn_drop_body(L, nets, img, rate=1.0):
    """The Paddle book's CIFAR-10 VGG (chapter 03,
    test_image_classification.py) up to its second fc 512: five
    img_conv_group blocks of 64 x 2, 128 x 2, 256 x 3, 512 x 3, 512 x 3
    filters (3 x 3, BN + ReLU, conv dropouts), 2 x 2 max pools, dropout
    0.5, fc 512, BN + ReLU, dropout 0.5, fc 512; every dropout at ``rate``
    times the book's."""
    def block(x, filters, groups, drops):
        return nets.img_conv_group(
            x, conv_num_filter=[filters] * groups, pool_size=2,
            pool_stride=2, conv_filter_size=3, conv_act="relu",
            conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=[d * rate for d in drops])

    h = block(img, 64, 2, [0.3, 0])
    h = block(h, 128, 2, [0.4, 0])
    h = block(h, 256, 3, [0.4, 0.4, 0])
    h = block(h, 512, 3, [0.4, 0.4, 0])
    h = block(h, 512, 3, [0.4, 0.4, 0])
    h = L.dropout(h, dropout_prob=0.5 * rate)
    h = L.fc(h, 512, act=None)
    h = L.batch_norm(h, act="relu")
    h = L.dropout(h, dropout_prob=0.5 * rate)
    return L.fc(h, 512, act=None)


def vgg16_bn_drop(static, L, nets, seed):
    """vgg16_bn_drop_body, then fc 10 + softmax.  Fetches the logits and
    the softmax."""
    main, startup = static.Program(), static.Program()
    main.random_seed = startup.random_seed = seed
    with static.program_guard(main, startup):
        img = L.data("img", [3, 32, 32])
        out = L.fc(vgg16_bn_drop_body(L, nets, img), 10, act="softmax")
    logits = main.global_block().ops[-1].inputs["X"][0]
    return main, startup, [logits, out.name]


def bn_state(static, startup, test, rng):
    """The startup program's parameters, with random BN statistics and
    affine parameters (positive variances), in a fresh scope."""
    scope = static.Scope()
    static.Executor(DEV).run(startup, scope=scope)
    for op in test.global_block().ops:
        if op.type != "batch_norm":
            continue
        for slot, lo, hi in (("Mean", -0.5, 0.5), ("Variance", 0.5, 2.0),
                             ("Scale", 0.5, 1.5), ("Bias", -0.5, 0.5)):
            name = op.inputs[slot][0]
            v = scope.find_var(name)
            scope.set(name, torch.from_numpy(
                rng.uniform(lo, hi, tuple(v.shape)).astype(np.float32))
                .to(v.device))
    return scope


def run_static(exe, program, feed, fetches, scope):
    return exe.run(program, feed=feed, fetch_list=fetches, scope=scope,
                   return_numpy=False)


def interleaved_timings(exe, runs, feed, fetches, batch, blocks=None,
                        reps=None):
    """Executor.run of two (program, scope, opt_passes) runs in alternating
    blocks (a, b, b, a, ...: host noise on a shared machine drifts), each
    block STATIC_REPS runs after one warm run.  Per run: the median wall
    ms of a run (the numpy feed's copy to the card and the fetches' copies
    back included) as images/s, the quartile spread, and the median span
    between CUDA events around a run."""
    a, b = runs
    blocks, reps = blocks or STATIC_BLOCKS, reps or STATIC_REPS
    walls = {k: [] for k in runs}
    spans = {k: [] for k in runs}
    for mode in (a, b, b, a) * (blocks // 4):
        program, scope, passes = runs[mode]
        with opt_passes(passes):
            exe.run(program, feed=feed, fetch_list=fetches, scope=scope)
            torch.cuda.synchronize()
            for _ in range(reps):
                t0 = time.perf_counter()
                exe.run(program, feed=feed, fetch_list=fetches, scope=scope)
                walls[mode].append((time.perf_counter() - t0) * 1e3)
            spans[mode].append(_events_ms(
                lambda: run_static(exe, program, feed, fetches, scope),
                reps))
    out = {}
    for mode in walls:
        q1, med, q3 = np.percentile(walls[mode], [25, 50, 75])
        out[mode] = dict(images_per_s=batch / med * 1e3, wall_ms=med,
                         wall_iqr_ms=q3 - q1,
                         device_span_ms=float(np.median(spans[mode])))
    return out


def static_timings(exe, program, feed, fetches, scope, batch):
    """The pipeline on and off (``interleaved_timings``)."""
    return interleaved_timings(exe, {"on": (program, scope, "default"),
                                     "off": (program, scope, "")},
                               feed, fetches, batch)


def profile_forward(exe, program, feed, fetches, scope, reps=3,
                    what="one forward"):
    """Device time of one Executor.run (under the current ``opt_passes``)
    by kind (the port's kernels, cuDNN convolutions, copies, the rest)
    from torch.profiler, and the busy share of the run's wall time
    (profiler overhead included)."""
    from torch.profiler import ProfilerActivity, profile

    run_static(exe, program, feed, fetches, scope)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run_static(exe, program, feed, fetches, scope)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kinds = {"port kernels": 0.0, "cudnn": 0.0, "copies": 0.0, "rest": 0.0}
    ours, top = {}, []
    for us, count, name in device_events(prof):
        ms = us / 1e3 / reps
        top.append((ms, count // reps, name))
        own = PORT_KERNEL.search(name)
        if own:
            kinds["port kernels"] += ms
            ours[own.group(0)] = ours.get(own.group(0), 0.0) + ms
        elif re.search(r"cudnn|xmma|conv|implicit|winograd|fft|nchw|nhwc",
                       name, re.I) and "copy" not in name.lower():
            kinds["cudnn"] += ms
        elif "copy" in name.lower():
            kinds["copies"] += ms
        else:
            kinds["rest"] += ms
    busy = sum(kinds.values())
    from paddle_tpu_torch.core import flags

    log(f"[profile] {what} (opt_passes="
        f"{flags.get_flag('opt_passes')!r}): device busy {busy:.3f} ms of "
        f"{wall_ms:.3f} "
        f"ms wall (busy share {busy / wall_ms:.3f}); "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in kinds.items()))
    log("  port kernels: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in sorted(ours.items(),
                                             key=lambda kv: -kv[1])))
    for ms, count, name in sorted(top, reverse=True)[:12]:
        log(f"  {ms:8.4f} ms  x{count:<3d} {name[:100]}")
    return dict(wall_ms=wall_ms, busy_ms=busy, busy_share=busy / wall_ms,
                kinds=kinds, port_kernels=ours)


@contextlib.contextmanager
def opt_passes(value):
    from paddle_tpu_torch.core import flags

    saved = flags.get_flag("opt_passes")
    flags.set_flags({"opt_passes": value})
    try:
        yield
    finally:
        flags.set_flags({"opt_passes": saved})


@contextlib.contextmanager
def vision_plain():
    """The vision kernels' wrappers swapped, as module attributes, for
    their plain versions (as ``plain_wrappers`` swaps the others)."""
    from paddle_tpu_torch.ops.kernels import conv_fused as cf
    from paddle_tpu_torch.ops.kernels import pooling as pl

    saved = (cf.conv2d_bn_act, pl.max_pool2d_nhwc, pl.avg_pool2d_nhwc)
    cf.conv2d_bn_act = cf.conv2d_bn_act_plain
    pl.max_pool2d_nhwc = pl.max_pool2d_nhwc_plain
    pl.avg_pool2d_nhwc = pl.avg_pool2d_nhwc_plain
    try:
        yield
    finally:
        cf.conv2d_bn_act, pl.max_pool2d_nhwc, pl.avg_pool2d_nhwc = saved


def static_model(name, build, seed):
    """One program through the port's static graph in fp32: the pipeline's
    op counts, kernel launches per forward, rollbacks, golden parity with
    the unrewritten program, the kernels against their plain versions in
    the rewritten program, images/s with the pipeline on and off."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.static import layers as L
    from paddle_tpu_torch.static import nets
    from paddle_tpu_torch.static import passes as P
    from paddle_tpu_torch.utils import monitor

    batch = STATIC_BATCH[name]
    main, startup, fetches = build(static, L, nets, seed)
    test = main.clone(for_test=True)
    rng = np.random.default_rng(seed)
    scope = bn_state(static, startup, test, rng)
    state = {k: scope.find_var(k).cpu().numpy() for k in scope.keys()}
    feed = {"img": rng.standard_normal((batch, 3, 32, 32)).astype(np.float32)}
    rewritten, report = P.PassManager(P.DEFAULT_PIPELINE).apply(
        test, {"img"}, fetches)
    log(f"[static] {name} b{batch} fp32: {report.to_text()}")
    exe = static.Executor(DEV)
    rollbacks = monitor.counter("passes.rollbacks")
    rollbacks0 = rollbacks.value()
    with opt_passes("default"):
        check(exe.executed_program(test, ["img"], fetches) is not test,
              f"{name}: the Executor runs the pipeline's rewrite")
        run_static(exe, test, feed, fetches, scope)
        torch.cuda.synchronize()
        config.reset_counts()
        outs = run_static(exe, test, feed, fetches, scope)
        torch.cuda.synchronize()
        counts = config.launch_counts()
        for k, n in STATIC_LAUNCHES[name].items():
            check(counts.get(k, 0) == n, f"{name}: {counts.get(k, 0)} {k} "
                  f"launches per forward (want {n})")
        check(counts.get("avg_pool2d", 0) == 0, f"{name}: no avg pools")
        with vision_plain():
            plain_outs = run_static(exe, test, feed, fetches, scope)
        for f, got, ref in zip(fetches, outs, plain_outs):
            r = rel_err(got, ref)
            check(r <= TOL_STATIC_REL, f"{name}: fetch {f} kernels vs plain "
                  f"versions rel err {r:.3g} <= {TOL_STATIC_REL}")
        prof = profile_forward(exe, test, feed, fetches, scope)
    check(all(torch.isfinite(t).all() for t in outs),
          f"{name}: finite fetches of shapes "
          f"{[tuple(t.shape) for t in outs]}")
    with opt_passes(""):
        parity = {}
        for f in fetches:
            ref = exe.run(test, feed=feed, fetch_list=[f], scope=scope)[0]
            tol = TOL_STATIC_REL * float(np.abs(ref).max())
            rep = P.golden_parity(test, rewritten, feed, [f], state=state,
                                  rtol=0.0, atol=tol, place=DEV)
            check(rep.ok, f"{name}: golden parity of {f}, pipeline vs "
                  f"none: {rep.to_text()} (atol {tol:.3g})")
            parity[f] = rep.per_fetch[f] / float(np.abs(ref).max())
        config.reset_counts()
        run_static(exe, test, feed, fetches, scope)
        torch.cuda.synchronize()
        check(not config.launch_counts(), f"{name}: no kernel launches "
              "with the pipeline off")
        prof_off = profile_forward(exe, test, feed, fetches, scope)
    times = static_timings(exe, test, feed, fetches, scope, batch)
    rolled = rollbacks.value() - rollbacks0
    check(rolled == 0, f"{name}: {rolled} pipeline rollbacks")
    on, off = times["on"], times["off"]
    log(f"[static] {name}: pipeline on {on['images_per_s']:.1f} images/s "
        f"(median {on['wall_ms']:.3f} ms wall a run, IQR "
        f"{on['wall_iqr_ms']:.3f}; {on['device_span_ms']:.3f} ms between "
        f"device events), off {off['images_per_s']:.1f} images/s "
        f"({off['wall_ms']:.3f} ms, IQR {off['wall_iqr_ms']:.3f}; "
        f"{off['device_span_ms']:.3f} ms): "
        f"{on['images_per_s'] / off['images_per_s']:.3f}x; device busy on "
        f"{prof['busy_ms']:.3f} ms, off {prof_off['busy_ms']:.3f} ms")
    return counts, dict(
        batch=batch, dtype="float32", ops_before=report.ops_before,
        ops_after=report.ops_after,
        passes={p.name: [p.ops_before, p.ops_after] for p in report.passes},
        launches=counts, rollbacks=rolled, parity_rel_err=parity,
        pipeline_on=dict(on, profile=prof),
        pipeline_off=dict(off, profile=prof_off))


def static_phase(seed):
    log("[static] static-graph inference: Program, layers, Executor, "
        "DEFAULT_PIPELINE")
    counts, out = {}, {}
    for name, build in (("conv_tower", conv_tower),
                        ("vgg16_bn_drop", vgg16_bn_drop)):
        counts[name], out[name] = static_model(name, build, seed)
    return counts["vgg16_bn_drop"], out


def vision_entries(vision, counts):
    """The kernels-line entries of rows 10 and 13: fp32 at a VGG-16 shape
    (the static phase's path), bf16 beside it, every case listed; launches
    per VGG-16 forward of the static phase."""
    from paddle_tpu_torch.ops.kernels import conv_fused as cf
    from paddle_tpu_torch.ops.kernels import pooling as pl

    def numbers(kind, label, prefix=""):
        r = vision[(kind, label, torch.float32)]
        rb = vision[(kind, label, torch.bfloat16)]
        return {f"{prefix}max_abs_err": r["err"], f"{prefix}ms": r["ms"],
                f"{prefix}plain_ms": r["plain_ms"],
                f"{prefix}bound_ms": r["bound"][0],
                f"{prefix}bound_by": r["bound"][1],
                f"{prefix}library_ms": r["library_ms"],
                f"{prefix}eager_ms": r["eager_ms"],
                f"{prefix}bf16_ms": rb["ms"],
                f"{prefix}bf16_max_abs_err": rb["err"],
                f"{prefix}bf16_bound_ms": rb["bound"][0],
                f"{prefix}bf16_library_ms": rb["library_ms"]}

    def cases(kind, mode=None):
        return [dict(case=label, dtype=dtag(dtype), ms=x["ms"],
                     eager_ms=x["eager_ms"], plain_ms=x["plain_ms"],
                     library_ms=x["library_ms"], bound_ms=x["bound"][0],
                     bound_by=x["bound"][1], max_abs_err=x["err"],
                     **({"splits": x["splits"]} if "splits" in x else {}))
                for (k, label, dtype), x in vision.items()
                if k == kind and x.get("mode", mode) == mode]

    conv = {"name": cf.KERNEL, "route": "cuda",
            "source": f"paddle_tpu_torch/ops/kernels/csrc/{cf.SOURCE}.cu",
            "replaces": cf.REPLACES,
            "launches": counts.get(cf.KERNEL, 0),
            **numbers("conv", CONV_CASES[0][0]),
            "library": "F.conv2d (cuDNN, channels-last, TF32 off) on the "
                       "folded weights and bias, then the act",
            "dtype": "float32", "shape": CONV_CASES[0][0] + " b128",
            "launches_per": "vgg16_bn_drop forward (static phase, b128)",
            "cases": cases("conv")}
    pool = {"name": pl.MAX_KERNEL, "route": "cuda",
            "source": f"paddle_tpu_torch/ops/kernels/csrc/{pl.SOURCE}.cu",
            "replaces": pl.REPLACES,
            "launches": counts.get(pl.MAX_KERNEL, 0),
            **numbers("pool", POOL_CASES[0][0]),
            "library": "F.max_pool2d on a channels-last view",
            "dtype": "float32", "shape": POOL_CASES[0][0] + " b128",
            "launches_per": "vgg16_bn_drop forward (static phase, b128)",
            "cases": cases("pool", "max"),
            pl.AVG_KERNEL: {"launches": counts.get(pl.AVG_KERNEL, 0),
                            **numbers("pool", POOL_CASES[5][0]),
                            "library": "F.avg_pool2d on a channels-last "
                                       "view",
                            "cases": cases("pool", "avg")}}
    return [conv, pool]


# -- phase 9: train-mode vision forward (rows 11 and 12) -----------------------

# Rows 11 and 12 at their main-path shapes: the (rows, C) of VGG-16's
# train-mode BNs that the gate passes at b128 (groups 2-5), and one
# cold-cache shape beyond the 50 MB L2 (ResNet-50's stage 1 at b64: 64 x 56
# x 56 rows of 256 channels, 205 MB in fp32).
BN_CASES = (
    ("vgg 16x16 c128 b128", (32768, 128)),
    ("vgg 8x8 c256 b128", (8192, 256)),
    ("vgg 4x4 c512 b128", (2048, 512)),
    ("vgg 2x2 c512 b128", (512, 512)),
    ("resnet50 stage1 c256 b64 (cold)", (200704, 256)),
)
# Rows 11 and 12 at edge shapes (own generator, untimed): 8 rows at C =
# 128 and 1024, rows that no row block divides (the last block shorter)
# at C = 128 and 1024.
BN_EDGE_SHAPES = ((8, 128), (8, 1024), (32776, 128), (2056, 1024))
# Row 11 against its plain version: the same fp32 sums in another order,
# relative to the largest sum.  Row 12 multiplies and adds without FMA
# contraction, as the plain version does: bit for bit.
TOL_BN_STATS_REL = 1e-5
# Launches of each of rows 11 and 12 per train-mode forward, pinned on the
# CPU by tests/test_torch_bn_train.py (the JAX dispatch at full width: the
# BNs of groups 2-5); the conv-BN tower's 2.
VISION_TRAIN_LAUNCHES = {"vgg16_bn_drop": 11, "conv_bn_tower": 2}
VISION_TRAIN_BATCH = {"vgg16_bn_drop": 128, "conv_bn_tower": 64}
# The train-mode forward with rows 11-12 against the same program with their
# plain versions (same seed, same dropout masks): the batch statistics'
# fp32 sums in another order, carried through 13 normalised layers;
# relative to each fetch's and each running statistic's largest value.
TOL_VISION_TRAIN_REL = 1e-4


def bn_case(bt, gen, rows, c, dtype, timed=True):
    """Rows 11 and 12 against their plain versions (row 11 twice, bit for
    bit); with ``timed`` their times beside the plain versions', the
    library calls' (``torch.var_mean``; ``torch.addcmul`` then
    ``torch.relu``) and the bounds."""
    x = randn(gen, (rows, c), dtype, 2.0, 0.5)
    gamma = randn(gen, (c,), torch.float32, 0.2, 1.0)
    beta = randn(gen, (c,), torch.float32, 0.5)
    tag = f"{rows} x {c} {dtag(dtype)}"
    with torch.no_grad():
        s, ss = bt.batch_stats(x)
        torch.cuda.synchronize()
        ps, pss = bt.batch_stats_plain(x)
        err = max(rel_err(s, ps), rel_err(ss, pss))
        check(err <= TOL_BN_STATS_REL, f"{bt.STATS_KERNEL} {tag}: sums rel "
              f"err {err:.3g} <= {TOL_BN_STATS_REL}")
        s2, ss2 = bt.batch_stats(x)
        check(torch.equal(s, s2) and torch.equal(ss, ss2),
              f"{bt.STATS_KERNEL} {tag}: two runs agree bit for bit")
        mean = s / rows
        var = torch.clamp(ss / rows - mean * mean, min=0.0)
        a = gamma * torch.rsqrt(var + 1e-5)
        b = beta - mean * a
        y = bt.scale_act(x, a, b, "relu")
        torch.cuda.synchronize()
        check(torch.equal(y, bt.scale_act_plain(x, a, b, "relu")),
              f"{bt.SCALE_KERNEL} {tag} relu: bit for bit the plain version")
        check(torch.equal(bt.scale_act(x, a, b, ""),
                          bt.scale_act_plain(x, a, b, "")),
              f"{bt.SCALE_KERNEL} {tag} no act: bit for bit the plain "
              f"version")
        if not timed:
            return None
        elt = x.element_size()
        ad, bd = a.to(dtype), b.to(dtype)
        stats = dict(timings(lambda: bt.batch_stats(x),
                             lambda: bt.batch_stats_plain(x),
                             lambda: torch.var_mean(x, dim=0),
                             *reversed(bt.stats_cost(rows, c, elt)), dtype),
                     err=max(max_abs(s, ps), max_abs(ss, pss)))
        scale = dict(timings(lambda: bt.scale_act(x, a, b, "relu"),
                             lambda: bt.scale_act_plain(x, a, b, "relu"),
                             lambda: torch.relu(torch.addcmul(bd, x, ad)),
                             *reversed(bt.scale_cost(rows, c, elt)), dtype),
                     err=max_abs(y, bt.scale_act_plain(x, a, b, "relu")))
    return stats, scale


def stats_profile(calls=3):
    """Row 11 in a profile of ``calls`` calls: one launch of the port's
    kernel a call and nothing else on the device.  Run before any CUDA
    graph is captured: after one has, the card's profiler records fewer
    launches than ran."""
    from paddle_tpu_torch.ops.kernels import bn_act_train as bt

    x = randn(torch.Generator().manual_seed(SEED + 11), BN_CASES[0][1],
              torch.float32)
    for _ in range(3):
        bt.batch_stats(x)
    prof = traced(lambda: bt.batch_stats(x), calls)
    seen = [(n, name) for _, n, name in device_events(prof)]
    check(len(seen) == 1 and seen[0][0] == calls
          and PORT_KERNEL.search(seen[0][1]) is not None
          and "bn_stats_cluster_kernel" in seen[0][1],
          f"{bt.STATS_KERNEL}: a profile of {calls} calls holds one launch "
          f"of the port's kernel a call and nothing else on the device "
          f"({seen}; all events "
          f"{sorted({e.key for e in prof.key_averages()})})")


def stats_plans(bt):
    """Row 11's plan at each main-path shape, its clusters against
    ``cudaOccupancyMaxActiveClusters``."""
    for dtype in (torch.float32, torch.bfloat16):
        for label, (rows, c) in BN_CASES:
            p = bt.stats_plan(rows, c, dtype)
            most = bt.stats_max_clusters(rows, c, dtype)
            check(most >= 1, f"{bt.STATS_KERNEL} {label} {dtag(dtype)}: "
                  f"channel tile {p.tile_c}, clusters of {p.cluster} CTAs "
                  f"x {p.rows_per_cta} rows, {p.ctas} CTAs; the card holds "
                  f"{most} such clusters at once (the plan has "
                  f"{p.channel_tiles})")


@contextlib.contextmanager
def bn_plain():
    """Rows 11 and 12 swapped, as module attributes, for their plain
    versions."""
    from paddle_tpu_torch.ops.kernels import bn_act_train as bt

    saved = (bt.batch_stats, bt.scale_act)
    bt.batch_stats, bt.scale_act = bt.batch_stats_plain, bt.scale_act_plain
    try:
        yield
    finally:
        bt.batch_stats, bt.scale_act = saved


def conv_bn_tower(static, L, nets, seed):
    """The conv tower with train-mode BNs (conv/BN(relu)/max-pool twice,
    fc 10; ch 128, 32 x 32) and no dropout."""
    main, startup = static.Program(), static.Program()
    main.random_seed = startup.random_seed = seed
    with static.program_guard(main, startup):
        img = L.data("img", [3, 32, 32])
        h = L.conv2d(img, 128, 3, padding=1)
        h = L.batch_norm(h, act="relu")
        h = L.pool2d(h, 2, "max", 2)
        h = L.conv2d(h, 128, 3, padding=1)
        h = L.batch_norm(h, act="relu")
        h = L.pool2d(h, 2, "max", 2)
        out = L.fc(L.flatten(h), 10)
    return main, startup, [out.name]


def bn_stat_names(program):
    return [n for op in program.global_block().ops if op.type == "batch_norm"
            for n in op.inputs["Mean"] + op.inputs["Variance"]]


def copy_scope(static, scope):
    new = static.Scope()
    for k in scope.keys():
        new.set(k, scope.find_var(k).clone())
    return new


def vision_train_model(name, build, seed):
    """One main (train-mode) program forward under DEFAULT_PIPELINE in
    fp32: launches of rows 11 and 12 per forward; the fetches and running
    statistics against the same run with their plain versions; golden
    parity with the pipeline off (programs without dropout); the forward's
    device span and a profile."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops.kernels import bn_act_train as bt
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.static import layers as L
    from paddle_tpu_torch.static import nets
    from paddle_tpu_torch.static import passes as P

    batch = VISION_TRAIN_BATCH[name]
    main, startup, fetches = build(static, L, nets, seed)
    # a nonzero program seed: with 0 the Executor draws one for each run,
    # and the two runs below would draw different dropout masks
    main.random_seed = seed + 1
    rng = np.random.default_rng(seed)
    scope0 = static.Scope()
    static.Executor(DEV).run(startup, scope=scope0)
    feed = {"img": rng.standard_normal((batch, 3, 32, 32)).astype(np.float32)}
    want = VISION_TRAIN_LAUNCHES[name]
    stats = bn_stat_names(main)
    with opt_passes("default"):
        runs = {}
        for mode in ("kernels", "plain"):
            scope = copy_scope(static, scope0)
            exe = static.Executor(DEV)      # step 0: the same dropout masks
            ctx = bn_plain() if mode == "plain" else contextlib.nullcontext()
            config.reset_counts()
            with ctx:
                outs = run_static(exe, main, feed, fetches, scope)
                torch.cuda.synchronize()
            runs[mode] = (outs, scope, config.launch_counts())
        counts = runs["kernels"][2]
        fused = [op for op in exe.executed_program(
            main, ["img"], fetches).global_block().ops
            if op.type == "fused_conv2d_bn_act"]
        check(fused and not any(op.attrs["is_test"] for op in fused),
              f"{name}: {len(fused)} train-mode fused convs run")
        for k in (bt.STATS_KERNEL, bt.SCALE_KERNEL):
            check(counts.get(k, 0) == want, f"{name}: {counts.get(k, 0)} "
                  f"{k} launches per forward (want {want})")
            check(runs["plain"][2].get(k, 0) == 0,
                  f"{name}: no {k} launch with the plain versions")
        err = {}
        for f, got, ref in zip(fetches, runs["kernels"][0], runs["plain"][0]):
            err[f] = rel_err(got, ref)
            check(torch.isfinite(got).all() and err[f] <=
                  TOL_VISION_TRAIN_REL, f"{name}: fetch {f} "
                  f"{tuple(got.shape)} kernels vs plain versions rel err "
                  f"{err[f]:.3g} <= {TOL_VISION_TRAIN_REL}")
        stat_err = 0.0
        for n in stats:
            got = runs["kernels"][1].find_var(n)
            ref = runs["plain"][1].find_var(n)
            check(not torch.equal(ref, scope0.find_var(n)),
                  f"{name}: running statistic {n} updated")
            stat_err = max(stat_err, rel_err(got, ref))
        check(stat_err <= TOL_VISION_TRAIN_REL, f"{name}: {len(stats)} "
              f"running statistics, kernels vs plain versions rel err "
              f"{stat_err:.3g} <= {TOL_VISION_TRAIN_REL}")
        scope = runs["kernels"][1]
        span = _events_ms(lambda: run_static(exe, main, feed, fetches, scope),
                          STATIC_REPS)
        with bn_plain():
            plain_span = _events_ms(
                lambda: run_static(exe, main, feed, fetches, scope),
                STATIC_REPS)
        prof = profile_forward(exe, main, feed, fetches, scope)
    out = dict(batch=batch, dtype="float32", launches=counts,
               fetch_rel_err=err, running_stats=len(stats),
               running_stats_rel_err=stat_err, forward_span_ms=span,
               plain_forward_span_ms=plain_span, profile=prof)
    if name == "conv_bn_tower":
        rewritten, _ = P.PassManager(P.DEFAULT_PIPELINE).apply(
            main, {"img"}, fetches)
        state = {k: scope0.find_var(k).cpu().numpy() for k in scope0.keys()}
        with opt_passes(""):
            rep = P.golden_parity(main, rewritten, feed, fetches, state=state,
                                  rtol=TOL_VISION_TRAIN_REL,
                                  atol=TOL_VISION_TRAIN_REL / 10, place=DEV)
        check(rep.ok, f"{name}: golden parity, pipeline (rows 11-12) vs "
              f"none (batch_norm + relu): {rep.to_text()}")
        out["golden_parity"] = dict(max_abs_err=rep.max_abs_err,
                                    state_max_err=rep.state_max_err)
    log(f"[vision train] {name} b{batch}: forward {span:.3f} ms between "
        f"device events with rows 11-12, {plain_span:.3f} ms with their "
        f"plain versions; fetch rel err {max(err.values()):.3g}, running "
        f"statistics {stat_err:.3g}")
    return counts, out


def vision_train_phase(seed):
    """The train-mode forward of VGG-16 and the conv-BN tower."""
    log("[vision train] train-mode forward under DEFAULT_PIPELINE")
    counts, out = {}, {}
    for name, build in (("vgg16_bn_drop", vgg16_bn_drop),
                        ("conv_bn_tower", conv_bn_tower)):
        counts[name], out[name] = vision_train_model(name, build, seed)
    return counts["vgg16_bn_drop"], out


# -- phase 10: int8 kernels (rows 14 and 15) -----------------------------------

# Row 14 at VGG-16's 512 x 512 fcs at b128 and an ERNIE-base FFN shape
# (4096 tokens x 768 -> 3072), as (m, k, n); row 15 at VGG-16's int8 convs
# at b128, the tower's second conv at b64, a 3x3 s2 p1 and a 7x7 s2 p3
# conv, as (n, h, w, c, o, k, s, p).
INT8_MM_CASES = (
    ("vgg fc 512->512 b128", (128, 512, 512)),
    ("ernie-base ffn 768->3072 4096 rows", (4096, 768, 3072)),
)
# Untimed shapes held at every act: a plain tile, K % 128 == 64 (the last K
# unit half zeros), and a shape the plan splits K for (2 output tiles).
INT8_MM_ACT_SHAPES = ((40, 256, 256), (40, 192, 256), (40, 1024, 256))
INT8_CONV_CASES = (
    ("vgg 128->128 16x16 b128", (128, 16, 16, 128, 128, 3, 1, 1)),
    ("vgg 256->256 8x8 b128", (128, 8, 8, 256, 256, 3, 1, 1)),
    ("vgg 512->512 4x4 b128", (128, 4, 4, 512, 512, 3, 1, 1)),
    ("vgg 512->512 2x2 b128", (128, 2, 2, 512, 512, 3, 1, 1)),
    ("vgg 128->256 8x8 b128", (128, 8, 8, 128, 256, 3, 1, 1)),
    ("vgg 256->512 4x4 b128", (128, 4, 4, 256, 512, 3, 1, 1)),
    ("tower 128->128 16x16 b64", (64, 16, 16, 128, 128, 3, 1, 1)),
    ("3x3 s2 p1 128->256 16x16 b128", (128, 16, 16, 128, 256, 3, 2, 1)),
    ("7x7 s2 p3 128->128 32x32 b32", (32, 32, 32, 128, 128, 7, 2, 3)),
)
# The same for the conv: a plain tile, C % 128 == 64, split K.
INT8_CONV_ACT_SHAPES = ((2, 7, 9, 128, 128, 3, 1, 1),
                        (2, 7, 9, 192, 128, 3, 1, 1),
                        (4, 2, 2, 512, 256, 3, 1, 1))
# Kernel against plain version: both sum exactly and apply the epilogue as
# the same two fp32 roundings, so the piecewise-linear acts agree bit for
# bit; sigmoid and tanh differ by the ulps of expf / tanhf against
# PyTorch's (relative to the largest value; bf16: one rounding flip).
TOL_INT8_REL = {torch.float32: 1e-6, torch.bfloat16: 1e-2}
LINEAR_ACTS = ("", "relu", "relu6")


def int8_operands(gen, x_shape, w_shape, n_out):
    x = torch.randint(-127, 128, x_shape, generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, w_shape, generator=gen, dtype=torch.int8)
    scale = torch.rand(n_out, generator=gen) * 1e-4 + 1e-5
    bias = torch.randn(n_out, generator=gen) * 0.5
    return x.to(DEV), w.to(DEV), scale.to(DEV), bias.to(DEV)


def int8_check(name, tag, got, ref, dtype, act):
    r = rel_err(got, ref)
    if act in LINEAR_ACTS:
        check(torch.equal(got, ref), f"{name} {tag}: bit for bit the plain "
              f"version")
    else:
        check(r <= TOL_INT8_REL[dtype], f"{name} {tag}: rel err {r:.3g} <= "
              f"{TOL_INT8_REL[dtype]}")
    return max_abs(got, ref)


def int8_mm_case(i8, gen, dims, dtype, act, timed=True):
    """Row 14 against its plain version (exact sums: float64 on the card);
    with ``timed`` its times beside the plain version's, ``torch._int_mm``'s
    product alone, and the bound."""
    m, k, n = dims
    x, w, scale, bias = int8_operands(gen, (m, k), (k, n), n)
    run = lambda: i8.int8_matmul_dequant(x, w, scale, bias, act, dtype)
    plain = lambda: i8.int8_matmul_dequant_plain(x, w, scale, bias, act,
                                                 dtype)
    got = run()
    torch.cuda.synchronize()
    splits = i8.matmul_plan(m, n, k).splits
    err = int8_check(i8.MATMUL_KERNEL, f"{m}x{k} @ {k}x{n} {dtag(dtype)} "
                     f"act={act or 'none'} (K splits {splits})", got,
                     plain(), dtype, act)
    if not timed:
        return None
    ops, nbytes = i8.matmul_cost(m, n, k, got.element_size())
    return dict(timings(run, plain, lambda: torch._int_mm(x, w), nbytes,
                        ops, torch.int8), err=err, ops=ops)


def int8_conv_case(i8, gen, dims, dtype, act, timed=True):
    """Row 15 against its plain version; with ``timed`` its times beside the
    plain version's and the bound.  No single PyTorch call computes an int8
    convolution: cuDNN's convolution on the dequantized operands
    (channels-last, in the output type, TF32 off) is timed as context."""
    n, h, w, c, o, k, s, p = dims
    x, wq, scale, bias = int8_operands(gen, (n, h, w, c), (o, c, k, k), o)
    args = ((s, s), (p, p), act, dtype)
    run = lambda: i8.int8_conv2d_dequant(x, wq, scale, bias, *args)
    plain = lambda: i8.int8_conv2d_dequant_plain(x, wq, scale, bias, *args)
    got = run()
    torch.cuda.synchronize()
    splits = i8.conv_plan(n, h, w, c, o, k, k, s, s, p, p).splits
    err = int8_check(i8.CONV_KERNEL, f"n{n} {h}x{w} {c}->{o} k{k} s{s} p{p} "
                     f"{dtag(dtype)} act={act or 'none'} (K splits "
                     f"{splits})", got, plain(), dtype, act)
    if not timed:
        return None
    oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    ops, nbytes = i8.conv_cost(n, oh, ow, c, o, k, k, h, w,
                               got.element_size())
    xf = x.permute(0, 3, 1, 2).to(dtype) * 0.01
    wf = (wq.to(dtype) * 0.01).contiguous(memory_format=torch.channels_last)
    bf = bias.to(dtype)
    cudnn = lambda: torch.nn.functional.conv2d(xf, wf, bf, s, p)
    return dict(timings(run, plain, None, nbytes, ops, torch.int8), err=err,
                ops=ops, cudnn_dequant_ms=time_ms(cudnn), splits=splits)


def int8_kernel_phase(gen, vision):
    """Rows 11 and 12 against their plain versions at their shapes in fp32
    and bf16; rows 14 and 15 at theirs, fp32 and bf16 out, every act at
    small shapes (a K % 128 == 64 one and a split one among them); row
    15's times beside row 10's bf16 times at the shapes the two share
    (``vision``: the [vision kernels] results of this run)."""
    from paddle_tpu_torch.ops.kernels import bn_act_train as bt
    from paddle_tpu_torch.ops.kernels import int8 as i8

    log("[int8 kernels] rows 11, 12, 14 and 15 against their plain "
        "versions")
    stats_plans(bt)
    bn_cases = {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, (rows, c) in BN_CASES:
            bn_cases[(label, dtype)] = bn_case(bt, gen, rows, c, dtype)
        bn_case(bt, gen, 8 * 3, 384, dtype, timed=False)   # a ragged grid
    edge = torch.Generator().manual_seed(SEED + 11)
    for dtype in (torch.float32, torch.bfloat16):
        for rows, c in BN_EDGE_SHAPES:
            bn_case(bt, edge, rows, c, dtype, timed=False)
    for (label, dtype), (st, sc) in bn_cases.items():
        for k, r in ((bt.STATS_KERNEL, st), (bt.SCALE_KERNEL, sc)):
            log(f"  {k} {label} {dtag(dtype)}: {r['ms']:.4f} ms (eager "
                f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
                f"library {r['library_ms']:.4f} ms, bound "
                f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, dims in INT8_MM_CASES:
            results[("matmul", label, dtype)] = int8_mm_case(
                i8, gen, dims, dtype, "relu")
        for label, dims in INT8_CONV_CASES:
            results[("conv", label, dtype)] = int8_conv_case(
                i8, gen, dims, dtype, "relu")
        for act in i8.EPILOGUE_ACTS:
            for dims in INT8_MM_ACT_SHAPES:
                int8_mm_case(i8, gen, dims, dtype, act, timed=False)
            for dims in INT8_CONV_ACT_SHAPES:
                int8_conv_case(i8, gen, dims, dtype, act, timed=False)
    (m, k, n), (cn, ch, cw, cc, co, ck, cs, cp) = (INT8_MM_ACT_SHAPES[2],
                                                   INT8_CONV_ACT_SHAPES[2])
    check(i8.matmul_plan(m, n, k).splits > 1
          and i8.conv_plan(cn, ch, cw, cc, co, ck, ck, cs, cs, cp,
                           cp).splits > 1
          and INT8_MM_ACT_SHAPES[1][1] % 128 == 64
          and INT8_CONV_ACT_SHAPES[1][3] % 128 == 64,
          "int8 act shapes include K splits and K / C % 128 == 64")
    row10 = {dims: r["ms"] for (kind, label, dt), r in vision.items()
             if kind == "conv" and dt == torch.bfloat16
             for lab, dims in CONV_CASES if lab == label}
    for (kind, label, dtype), r in results.items():
        lib = (f"torch._int_mm {r['library_ms']:.4f} ms" if kind == "matmul"
               else f"cuDNN on dequantized operands (context) "
                    f"{r['cudnn_dequant_ms']:.4f} ms")
        if kind == "conv":
            dims = dict(INT8_CONV_CASES)[label]
            r["row10_bf16_ms"] = row10.get(dims)
            if r["row10_bf16_ms"] is not None:
                lib += (f", row 10 bf16 at this shape {r['row10_bf16_ms']:.4f}"
                        f" ms ({r['ms'] / r['row10_bf16_ms']:.2f}x)")
            lib += f", K splits {r['splits']}"
        log(f"  int8 {kind} {label} {dtag(dtype)} out: {r['ms']:.4f} ms "
            f"(eager {r['eager_ms']:.4f} ms; {r['ops'] / r['ms'] / 1e9:.1f} "
            f"TOPS), plain {r['plain_ms']:.4f} ms, {lib}, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")
    return bn_cases, results


# -- phase 11: int8 static inference -------------------------------------------

# Launches of rows 15 / 14 per int8 forward, pinned on the CPU by
# tests/test_torch_int8.py (the JAX dispatch at full width): the tower's
# second conv; VGG-16's 10 convs of C, O % 128 and its two 512 x 512 fcs.
INT8_LAUNCHES = {
    "conv_tower": {"int8_conv2d_dequant": 1, "int8_matmul_dequant": 0},
    "vgg16_bn_drop": {"int8_conv2d_dequant": 10, "int8_matmul_dequant": 2}}
# The int8 program with rows 14-15 against the same program with their
# plain versions: exact sums and the same epilogue in both, bit for bit up
# to the order of cuDNN's float convolutions elsewhere in the program.
TOL_INT8_PLAIN_REL = 1e-6
# The kernel route against the simulate route (use_pallas_int8 off: the
# fake-quant values through cuDNN's fp32 convolution or cuBLAS): the same
# int8 grid, exact sums against fp32 ones.  Each quant op of a program is
# held on the inputs the kernel route gave it, and one quantized fc is held
# end to end, to the reference's rtol = atol = 1e-4 for one fc
# (tests/test_pallas_vision.py:333), relative to the op's largest output.
# Whole programs are not compared: the next layer's quantization moves a
# value that lies an fp32 rounding from a rounding boundary by one level,
# and over VGG-16's 16 quantized layers that reaches ~1% of the largest
# logit (on the CPU, scaling the input by 1 + 1e-6 moves the int8 logits
# by 1.1% at b32); the two routes' program-level difference is printed.
TOL_INT8_OP_REL = 1e-4
TOL_INT8_FC = 1e-4
INT8_FC_BATCH = 128


@contextlib.contextmanager
def int8_plain():
    from paddle_tpu_torch.ops.kernels import int8 as i8

    saved = (i8.int8_matmul_dequant, i8.int8_conv2d_dequant)
    i8.int8_matmul_dequant = i8.int8_matmul_dequant_plain
    i8.int8_conv2d_dequant = i8.int8_conv2d_dequant_plain
    try:
        yield
    finally:
        i8.int8_matmul_dequant, i8.int8_conv2d_dequant = saved


def int8_ops_against_simulate(exe, program, feed, fetches, scope):
    """Run ``program`` recording each quant op's inputs and output, then
    hold each output against the simulate route (use_pallas_int8 off) on
    the same inputs.  Returns (ops, ops on the kernel route, worst rel err
    of an op's output relative to its largest value)."""
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.static import registry

    real = {t: registry._REGISTRY[t] for t in ("quant_conv2d", "quant_mul")}
    records = []

    def recorder(t):
        def lowering(ins, attrs, op):
            n0 = sum(config.launch_counts().values())
            outs = real[t](ins, attrs, op)
            kernel = sum(config.launch_counts().values()) > n0
            records.append((t, ins, attrs, op, outs, kernel))
            return outs
        return lowering

    registry._REGISTRY.update({t: recorder(t) for t in real})
    try:
        run_static(exe, program, feed, fetches, scope)
    finally:
        registry._REGISTRY.update(real)
    worst = 0.0
    with int8_flag(False):
        for t, ins, attrs, op, outs, _ in records:
            slot = "Output" if t == "quant_conv2d" else "Out"
            sim = real[t](ins, attrs, op)[slot][0]
            worst = max(worst, rel_err(outs[slot][0], sim))
    return len(records), sum(r[-1] for r in records), worst


@contextlib.contextmanager
def int8_flag(on):
    from paddle_tpu_torch.core import flags

    saved = flags.get_flag("use_pallas_int8")
    flags.set_flags({"use_pallas_int8": on})
    try:
        yield
    finally:
        flags.set_flags({"use_pallas_int8": saved})


def int8_model(name, build, seed):
    """One program through PTQ (one calibration batch) and
    QUANT_INFER_PIPELINE in fp32: quant op counts, launches of rows 15 / 14
    per forward, the kernel route against its plain versions and against
    the simulate route, the int8 error against the float program, images/s
    of the int8 and fp32 programs, and a profile of one int8 forward."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.slim.quant_static import PostTrainingQuantization
    from paddle_tpu_torch.static import layers as L
    from paddle_tpu_torch.static import nets
    from paddle_tpu_torch.static import passes as P

    batch = STATIC_BATCH[name]
    main, startup, fetches = build(static, L, nets, seed)
    fp32_prog = main.clone(for_test=True)
    qprog = main.clone(for_test=True)
    rng = np.random.default_rng(seed)
    scope = bn_state(static, startup, qprog, rng)
    fp32_scope = copy_scope(static, scope)
    feed = {"img": rng.standard_normal((batch, 3, 32, 32)).astype(np.float32)}
    exe = static.Executor(DEV)
    with opt_passes(""):
        fp32_out = run_static(exe, fp32_prog, feed, fetches, fp32_scope)
        t0 = time.perf_counter()
        PostTrainingQuantization(
            exe, program=qprog, feed_names=["img"],
            batch_generator=lambda: iter([feed]), batch_nums=1,
            scope=scope).quantize()
        ptq_s = time.perf_counter() - t0
        rewritten, report = P.PassManager(P.QUANT_INFER_PIPELINE).apply(
            qprog, {"img"}, fetches)
        types = [op.type for op in rewritten.global_block().ops]
        quant_ops = {t: types.count(t) for t in ("quant_conv2d", "quant_mul")}
        log(f"[int8] {name} b{batch}: PTQ {ptq_s:.2f} s; "
            f"{report.to_text()}; {quant_ops}")
        run_static(exe, rewritten, feed, fetches, scope)
        torch.cuda.synchronize()
        config.reset_counts()
        outs = run_static(exe, rewritten, feed, fetches, scope)
        torch.cuda.synchronize()
        counts = config.launch_counts()
        for k, n in INT8_LAUNCHES[name].items():
            check(counts.get(k, 0) == n, f"{name}: {counts.get(k, 0)} {k} "
                  f"launches per int8 forward (want {n})")
        check(all(torch.isfinite(t).all() for t in outs),
              f"{name}: finite int8 fetches of shapes "
              f"{[tuple(t.shape) for t in outs]}")
        with int8_plain():
            plain_outs = run_static(exe, rewritten, feed, fetches, scope)
        with int8_flag(False):
            config.reset_counts()
            sim_outs = run_static(exe, rewritten, feed, fetches, scope)
            torch.cuda.synchronize()
            check(not any(k.startswith("int8") for k in
                          config.launch_counts()),
                  f"{name}: no int8 launch on the simulate route")
        errs = {}
        for f, got, ref, sim, flt in zip(fetches, outs, plain_outs, sim_outs,
                                         fp32_out):
            e_plain, e_sim = rel_err(got, ref), rel_err(got, sim)
            e_int8 = rel_err(got, flt)
            check(e_plain <= TOL_INT8_PLAIN_REL, f"{name}: fetch {f} kernels "
                  f"vs plain versions rel err {e_plain:.3g} <= "
                  f"{TOL_INT8_PLAIN_REL}")
            errs[f] = dict(vs_plain=e_plain, vs_simulate=e_sim,
                           int8_rel_err=e_int8)
        n_ops, n_kernel, op_err = int8_ops_against_simulate(
            exe, rewritten, feed, fetches, scope)
        want = sum(INT8_LAUNCHES[name].values())
        check(n_kernel == want and op_err <= TOL_INT8_OP_REL,
              f"{name}: {n_ops} quant ops ({n_kernel} on the kernels) "
              f"against the simulate route on the same inputs: rel err "
              f"{op_err:.3g} <= {TOL_INT8_OP_REL}")
        prof = profile_forward(exe, rewritten, feed, fetches, scope)
    times = interleaved_timings(
        exe, {"int8": (rewritten, scope, ""),
              "fp32": (fp32_prog, fp32_scope, "default")},
        feed, fetches, batch)
    q, f = times["int8"], times["fp32"]
    log(f"[int8] {name}: int8 {q['images_per_s']:.1f} images/s (median "
        f"{q['wall_ms']:.3f} ms a run, IQR {q['wall_iqr_ms']:.3f}; "
        f"{q['device_span_ms']:.3f} ms between device events), fp32 with "
        f"DEFAULT_PIPELINE {f['images_per_s']:.1f} images/s "
        f"({f['wall_ms']:.3f} ms, IQR {f['wall_iqr_ms']:.3f}; "
        f"{f['device_span_ms']:.3f} ms): "
        f"{q['images_per_s'] / f['images_per_s']:.3f}x; int8 rel err vs the "
        f"float program {errs[fetches[0]]['int8_rel_err']:.4g}")
    return counts, dict(
        batch=batch, dtype="float32", ptq_s=ptq_s, quant_ops=quant_ops,
        ops_before=report.ops_before, ops_after=report.ops_after,
        launches=counts, errors=errs, op_vs_simulate_rel_err=op_err,
        int8=dict(q, profile=prof), fp32=f,
        vs_fp32=q["images_per_s"] / f["images_per_s"])


def int8_fc_check(seed):
    """The reference's fc check on the card: fc 128 -> 128 + relu at b128,
    PTQ'd; its quant_mul on row 14 against the simulate route within
    rtol = atol = TOL_INT8_FC, and within the PTQ error bound of the float
    program (5% of the largest value + 1e-3)."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.slim.quant_static import PostTrainingQuantization
    from paddle_tpu_torch.static import layers as L
    from paddle_tpu_torch.static import passes as P

    main, startup = static.Program(), static.Program()
    main.random_seed = startup.random_seed = seed + 1
    with static.program_guard(main, startup):
        x = L.data("x", [128])
        y = L.fc(x, 128, act="relu")
    scope = static.Scope()
    exe = static.Executor(DEV)
    exe.run(startup, scope=scope)
    feed = {"x": np.random.default_rng(seed).standard_normal(
        (INT8_FC_BATCH, 128)).astype(np.float32)}
    with opt_passes(""):
        float_out = exe.run(main, feed=feed, fetch_list=[y], scope=scope)[0]
        PostTrainingQuantization(
            exe, program=main, feed_names=["x"],
            batch_generator=lambda: iter([feed]), batch_nums=1,
            scope=scope).quantize()
        rewritten, _ = P.PassManager(("quant_infer",)).apply(
            main, {"x"}, [y.name])
        sim = exe.run(main, feed=feed, fetch_list=[y.name], scope=scope)[0]
        config.reset_counts()
        got = exe.run(rewritten, feed=feed, fetch_list=[y.name],
                      scope=scope)[0]
        launched = config.launch_counts().get("int8_matmul_dequant", 0)
    check(launched == 1, f"fc 128 -> 128 b{INT8_FC_BATCH}: {launched} "
          f"int8_matmul_dequant launch")
    err = float(np.abs(got - sim).max())
    check(np.allclose(got, sim, rtol=TOL_INT8_FC, atol=TOL_INT8_FC),
          f"fc 128 -> 128 b{INT8_FC_BATCH}: row 14 route vs simulate route "
          f"max abs err {err:.3g} within rtol = atol = {TOL_INT8_FC}")
    scale = float(np.abs(float_out).max())
    ptq = float(np.abs(got - float_out).max())
    check(ptq <= 0.05 * scale + 1e-3, f"fc 128 -> 128: int8 vs float max "
          f"abs err {ptq:.3g} <= 5% of {scale:.3g} + 1e-3")
    return dict(vs_simulate_max_abs_err=err, vs_float_max_abs_err=ptq)


def int8_phase(seed):
    log("[int8] int8 static inference: PostTrainingQuantization, "
        "QUANT_INFER_PIPELINE, Executor")
    counts, out = {}, {"fc128": int8_fc_check(seed)}
    for name, build in (("conv_tower", conv_tower),
                        ("vgg16_bn_drop", vgg16_bn_drop)):
        counts[name], out[name] = int8_model(name, build, seed)
    return counts["vgg16_bn_drop"], out


# -- phase 12: rows 11-13 timed on inputs beyond L2 -----------------------------

# A timed call reads inputs that the calls between its two reads of them
# pushed out of the H100's 50 MB L2: at least COLD_BYTES of distinct input
# sets, called in turn in one CUDA graph.
COLD_BYTES = 4 * 50 * 2 ** 20
COLD_BN_CASES = BN_CASES[:4]          # VGG-16's train-mode BN shapes, b128
COLD_POOL_CASES = POOL_CASES[:4]      # VGG-16's four gated max pools, b128
# Launches per VGG-16 forward at each of those shapes: the train-mode BNs
# of blocks 2-5 (2, 3, 3, 3 convs; block 1's 64 channels and the fc's BN
# are not gated) and one pool after each of those blocks.
COLD_BN_LAUNCHES = (2, 3, 3, 3)
COLD_POOL_LAUNCHES = (1, 1, 1, 1)


def cold_ms(fn, make, nbytes, replays=3):
    """(device ms a call, input sets) of ``fn(*make())`` on inputs that
    are not in L2: ``n`` distinct sets of at least COLD_BYTES in all, each
    read once a replay of a CUDA graph that calls ``fn`` on each in
    turn."""
    n = max(4, math.ceil(COLD_BYTES / nbytes))
    sets = [make() for _ in range(n)]
    for args in sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in sets:
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    ms = _events_ms(graph.replay, replays) / n
    del graph, sets
    return ms, n


def cold_phase(seed):
    """Rows 11, 12 and 13 at VGG-16's train-mode BN and pooling shapes,
    fp32 and bf16: the warm time (20 calls on one input, ``time_ms``) and
    the cold time (``cold_ms``) beside the bound, each one's share of it
    and the library call's cold time; then each row's share over one
    forward's launches at those shapes, against the bound and against
    the larger of the bound and one launch's floor (a one-element fill in
    a CUDA graph).  No share may exceed 1."""
    from paddle_tpu_torch.ops.kernels import bn_act_train as bt
    from paddle_tpu_torch.ops.kernels import pooling as pl

    F = torch.nn.functional
    one = torch.zeros(1, device=DEV)
    floor = time_ms(lambda: one.zero_())
    log(f"[cold] rows 11-13 on inputs beyond L2 (>= {COLD_BYTES >> 20} MB "
        f"of distinct inputs between two reads of one) and warm (one "
        f"input); one launch's floor {floor:.4f} ms")
    gen = torch.Generator().manual_seed(seed + 12)
    out = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            elt = torch.tensor([], dtype=dtype).element_size()
            for (label, (rows, c)), w in zip(COLD_BN_CASES,
                                             COLD_BN_LAUNCHES):
                a = randn(gen, (c,), torch.float32, 0.2, 1.0)
                b = randn(gen, (c,), torch.float32, 0.5)
                ad, bd = a.to(dtype), b.to(dtype)
                make = lambda: (randn(gen, (rows, c), dtype, 2.0, 0.5),)
                for name, fn, lib, cost in (
                        (bt.STATS_KERNEL, lambda x: bt.batch_stats(x),
                         lambda x: torch.var_mean(x, dim=0), bt.stats_cost),
                        (bt.SCALE_KERNEL,
                         lambda x: bt.scale_act(x, a, b, "relu"),
                         lambda x: torch.relu(torch.addcmul(bd, x, ad)),
                         bt.scale_cost)):
                    flops, nbytes = cost(rows, c, elt)
                    out[(name, label, dtype)] = cold_case(
                        name, label, dtype, fn, lib, make, rows * c * elt,
                        bound(nbytes, flops, dtype), w)
            for (label, (mode, n, h, w_, c, k, st, pd)), w in zip(
                    COLD_POOL_CASES, COLD_POOL_LAUNCHES):
                args = ((k, k), (st, st), (pd, pd))
                make = lambda: (randn(gen, (n, h, w_, c), dtype),)
                oh = (h + 2 * pd - k) // st + 1
                ow = (w_ + 2 * pd - k) // st + 1
                flops, nbytes = pl.pool_cost(n, oh, ow, c, k, k, elt, h, w_)
                out[(pl.MAX_KERNEL, label, dtype)] = cold_case(
                    pl.MAX_KERNEL, label, dtype,
                    lambda x: pl.max_pool2d_nhwc(x, *args),
                    lambda x: F.max_pool2d(x.permute(0, 3, 1, 2), k, st, pd),
                    make, n * h * w_ * c * elt,
                    bound(nbytes, flops, dtype), w)
    by_row = {}
    for (name, _, dtype), r in out.items():
        by_row.setdefault((name, dtype), []).append(r)
    summary = []
    for (name, dtype), cases in by_row.items():
        total = lambda key: sum(r["launches"] * r[key] for r in cases)
        bnd = total("bound_ms")
        floored = sum(r["launches"] * max(r["bound_ms"], floor)
                      for r in cases)
        s = dict(name=name, dtype=dtag(dtype), launch_floor_ms=floor,
                 launches=sum(r["launches"] for r in cases),
                 cold_ms=total("cold_ms"), bound_ms=bnd,
                 library_cold_ms=total("library_cold_ms"),
                 share=bnd / total("cold_ms"),
                 floor_share=floored / total("cold_ms"))
        log(f"  {name} {s['dtype']}, a VGG-16 forward's {s['launches']} "
            f"launches: cold {s['cold_ms']:.4f} ms, bound {bnd:.4f} ms "
            f"({s['share']:.2f} of it), with each launch at least the floor "
            f"{floored:.4f} ms ({s['floor_share']:.2f}); library cold "
            f"{s['library_cold_ms']:.4f} ms")
        summary.append(s)
    return out, summary


def cold_case(name, label, dtype, fn, lib, make, in_bytes, bnd, launches):
    x = make()
    warm = time_ms(lambda: fn(*x))
    cold, sets = cold_ms(fn, make, in_bytes)
    lib_cold = cold_ms(lib, make, in_bytes)[0]
    del x
    r = dict(name=name, case=label, dtype=dtag(dtype), warm_ms=warm,
             cold_ms=cold, library_cold_ms=lib_cold, bound_ms=bnd[0],
             bound_by=bnd[1], warm_share=bnd[0] / warm,
             cold_share=bnd[0] / cold, input_sets=sets, launches=launches)
    log(f"  {name} {label} {dtag(dtype)}: cold {cold:.4f} ms ({sets} input "
        f"sets), warm {warm:.4f} ms, library cold {lib_cold:.4f} ms, bound "
        f"{bnd[0]:.4f} ms ({bnd[1]}): {r['cold_share']:.2f} of the bound "
        f"cold, {r['warm_share']:.2f} warm")
    check(r["cold_share"] <= 1.0, f"{name} {label} {dtag(dtype)}: cold time "
          f"{cold:.4f} ms is no faster than its bound {bnd[0]:.4f} ms")
    return r


# -- phase 13: static-graph training and QAT into int8 ---------------------------

# The book's image-classification programs at their published widths on
# 3 x 32 x 32: vgg16_bn_drop (as ``vgg16_bn_drop``) and resnet_cifar10 at
# depth 32 (widths 16 / 32 / 64), each ending in fc(10, softmax),
# cross_entropy, mean, accuracy and Adam(1e-3).minimize.
TRAIN_BOOK_BATCH = 128
TRAIN_BOOK_BLOCKS = 4      # timed blocks, alternating pipeline on / off
TRAIN_BOOK_REPS = 5        # steps a block
RESNET_DEPTH = 32
QAT_STEPS = 20
# Convs per training program that fuse_conv_bn_act rewrites (every conv:
# each is followed by a batch_norm), pinned for VGG on the CPU by
# tests/test_torch_static_train.py.
TRAIN_FUSED = {"vgg16_bn_drop": 13, "resnet32": 33}
# The first step (dropouts at 0) from one startup state and batch, on the
# card and on the CPU, each held against the witness: the port's CPU
# Executor in float64 (``float64_executor``).  Errors: the loss relative
# to the witness's, each gradient's largest error relative to the
# witness's largest gradient.  The card runs cuDNN's own algorithm choice
# (what training uses), then cuDNN deterministic, then cuDNN off (ATen's
# im2col and fp32 cuBLAS GEMMs); TF32 is off throughout.  At b128 the
# gradients are ill-conditioned: the witness itself, on the input changed
# in its last bit (each pixel times 1 +- 2^-24, rounded to fp32), moves
# them by a few 1e-3 of the largest, and every fp32 run, card or CPU,
# lands about as far from it (1.7e-3 - 3.8e-3 on the H100 and its host,
# PERF.md).  A step on another batch reads above 1.  These limits hold
# this section alone; the dygraph phases keep TOL_TRAIN_LOSS_REL /
# TOL_TRAIN_GRAD_REL.
TOL_STATIC_TRAIN_LOSS_REL = 1e-5
TOL_STATIC_TRAIN_GRAD_REL = 1e-2
# A real fault must read far above the gradient limit: the card's first
# step on another batch (a feed bound to the wrong data) against the
# witness must exceed FAULT_MARGIN times it.
FAULT_MARGIN = 10
# QAT-frozen VGG-16: launches of rows 15 / 14 / 13 per int8 forward, the
# PTQ'd program's (INT8_LAUNCHES, the [int8] phase); the float test program
# under DEFAULT_PIPELINE: rows 10 / 13.
QAT_LAUNCHES = {"int8_conv2d_dequant": 10, "int8_matmul_dequant": 2,
                "max_pool2d": 4}
FLOAT_TEST_LAUNCHES = {"conv2d_bn_act": 10, "max_pool2d": 4}


def book_resnet_body(L, nets, img, rate=1.0):
    """resnet_cifar10 (test_image_classification.py) at RESNET_DEPTH:
    conv-BN layers, basic blocks with projection shortcuts, 8 x 8 avg
    pool."""
    def conv_bn(x, ch, k, stride, pad, act="relu", bias_attr=False):
        x = L.conv2d(x, ch, k, stride=stride, padding=pad, act=None,
                     bias_attr=bias_attr)
        return L.batch_norm(x, act=act)

    def basicblock(x, ch_in, ch_out, stride):
        tmp = conv_bn(x, ch_out, 3, stride, 1)
        tmp = conv_bn(tmp, ch_out, 3, 1, 1, act=None, bias_attr=None)
        short = (conv_bn(x, ch_out, 1, stride, 0, None) if ch_in != ch_out
                 else x)
        return L.elementwise_add(tmp, short, act="relu")

    def layer_warp(x, ch_in, ch_out, count, stride):
        x = basicblock(x, ch_in, ch_out, stride)
        for _ in range(1, count):
            x = basicblock(x, ch_out, ch_out, 1)
        return x

    n = (RESNET_DEPTH - 2) // 6
    h = conv_bn(img, 16, 3, 1, 1)
    h = layer_warp(h, 16, 16, n, 1)
    h = layer_warp(h, 16, 32, n, 2)
    h = layer_warp(h, 32, 64, n, 2)
    return L.pool2d(h, 8, pool_type="avg", pool_stride=1)


BOOK_BODIES = {"vgg16_bn_drop": vgg16_bn_drop_body,
               "resnet32": book_resnet_body}


def book_train_program(static, L, nets, seed, name, rate=1.0):
    """(main, startup, test program cloned before minimize, fetch names:
    cost, accuracy, logits, softmax)."""
    main, startup = static.Program(), static.Program()
    main.random_seed = startup.random_seed = seed + 1
    with static.program_guard(main, startup):
        img = L.data("img", [3, 32, 32])
        label = L.data("label", [1], dtype="int64")
        out = L.fc(BOOK_BODIES[name](L, nets, img, rate), 10, act="softmax")
        cost = L.mean(L.cross_entropy(out, label))
        acc = L.accuracy(out, label)
        test = main.clone(for_test=True)
        static.optimizer.Adam(learning_rate=1e-3).minimize(cost)
    logits = [op for op in main.global_block().ops
              if op.type == "softmax"][-1].inputs["X"][0]
    return main, startup, test, [cost.name, acc.name, logits, out.name]


def book_batch(rng, batch):
    """A synthetic CIFAR batch (3 x 32 x 32 normal pixels, labels 0-9)."""
    return {"img": rng.standard_normal((batch, 3, 32, 32)).astype(np.float32),
            "label": rng.integers(0, 10, (batch, 1)).astype(np.int64)}


def grads_of(program):
    region, = [op for op in program.global_block().ops
               if op.type == "backward_region"]
    return region.outputs["Grads"]


@contextlib.contextmanager
def float64_executor():
    """The port's Executor computing in float64, as a witness: values of
    either float width resolve to float64 (feeds, scope reads) and
    ``Tensor.float()`` leaves a float64 tensor as it is (the lowerings' fp32
    statistics and the region's summed loss)."""
    from paddle_tpu_torch.core import dtype as D

    saved_map, saved_float = dict(D._X32), torch.Tensor.float
    own = torch.Tensor.__dict__.get("float")
    D._X32.update({torch.float32: torch.float64,
                   torch.float64: torch.float64})
    torch.Tensor.float = lambda t, *a, **k: (
        t if t.dtype == torch.float64 else saved_float(t, *a, **k))
    try:
        yield
    finally:
        D._X32.clear()
        D._X32.update(saved_map)
        if own is None:
            del torch.Tensor.float
        else:
            torch.Tensor.float = own


def cudnn_flags(enabled=True, deterministic=False):
    """cuDNN on or off, deterministic or not, with TF32 off as ``main()``
    sets it and no autotuning."""
    return torch.backends.cudnn.flags(enabled=enabled, benchmark=False,
                                      deterministic=deterministic,
                                      allow_tf32=False)


def step_errors(out, ref, names):
    """(loss rel err, largest gradient error / the reference's largest
    gradient, the four worst gradients) of one first step against
    another."""
    top = max(float(np.abs(r).max()) for r in ref[1:])
    errs = sorted(((float(np.abs(g.astype(np.float64) - r).max()), n,
                    float(np.abs(r).max()))
                   for n, g, r in zip(names, out[1:], ref[1:])),
                  reverse=True)
    loss = abs(float(out[0]) - float(ref[0])) / abs(float(ref[0]))
    return loss, errs[0][0] / top, errs[:4]


def train_cpu_check(name, seed, batch):
    """The first training step of the program with its dropouts at 0 on
    the card (cuDNN's own algorithms, deterministic, off) and on the CPU in
    fp32, each against the float64 witness, from one startup state and
    batch: the loss and every parameter's gradient.  Beside them, the
    witness on the input changed in its last bit (the gradients'
    conditioning) and the card on another batch (a fault)."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.static import layers as L
    from paddle_tpu_torch.static import nets

    main, startup, _, fetches = book_train_program(static, L, nets, seed,
                                                   name, rate=0.0)
    grads = grads_of(main)
    scope = static.Scope()
    static.Executor(DEV).run(startup, scope=scope)
    state = {k: scope.find_var(k).cpu().clone() for k in scope.keys()}
    feed = book_batch(np.random.default_rng(seed + 3), batch)
    ulp = np.random.default_rng(seed + 7).choice([-1.0, 1.0],
                                                 feed["img"].shape)
    moved = dict(feed, img=(feed["img"] * (1 + 2.0 ** -24 * ulp))
                 .astype(np.float32))
    other = book_batch(np.random.default_rng(seed + 6), batch)

    def first_step(place, ctx, feed=feed):
        sc = static.Scope()
        for k, v in state.items():
            sc.set(k, v.to(place))
        with ctx:
            t0 = time.perf_counter()
            out = static.Executor(place).run(
                main, feed=feed, scope=sc, fetch_list=[fetches[0]] + grads)
        return out, time.perf_counter() - t0

    runs = {"card": (DEV, cudnn_flags()),
            "card cuDNN deterministic": (DEV, cudnn_flags(deterministic=True)),
            "card cuDNN off": (DEV, cudnn_flags(enabled=False)),
            "CPU fp32": ("cpu", contextlib.nullcontext()),
            "witness, input's last bit changed": ("cpu", float64_executor(),
                                                  moved),
            "card, another batch": (DEV, cudnn_flags(), other)}
    with opt_passes("default"):
        witness, w_s = first_step("cpu", float64_executor())
        outs = {k: first_step(*v) for k, v in runs.items()}
    check(all(g.dtype == np.float64 for g in witness),
          f"{name}: the witness's loss and {len(grads)} gradients are "
          f"float64 ({w_s:.1f} s)")
    out = dict(gradients=len(grads), witness_s=w_s)
    for run, (got, secs) in outs.items():
        loss, grad, worst = step_errors(got, witness, grads)
        log(f"[static train] {name} b{batch} step 1, {run} vs the float64 "
            f"witness ({secs:.2f} s): loss rel err {loss:.3g}, gradients "
            f"{grad:.3g} of the largest; worst: " + ", ".join(
                f"{n} {e:.3g} (its largest {m:.3g})" for e, n, m in worst))
        out[run] = dict(loss_rel_err=loss, grad_err_of_largest=grad,
                        seconds=secs,
                        worst=[dict(name=n, err=e, largest=m)
                               for e, n, m in worst])
    card_cpu = step_errors(outs["card"][0], outs["CPU fp32"][0], grads)
    out["card vs CPU fp32"] = dict(loss_rel_err=card_cpu[0],
                                   grad_err_of_largest=card_cpu[1])
    log(f"[static train] {name}: card vs CPU fp32: loss {card_cpu[0]:.3g}, "
        f"gradients {card_cpu[1]:.3g} of the largest")
    for run in ("card", "card cuDNN deterministic", "card cuDNN off",
                "CPU fp32"):
        r = out[run]
        check(np.isfinite(outs[run][0][0])
              and r["loss_rel_err"] <= TOL_STATIC_TRAIN_LOSS_REL
              and r["grad_err_of_largest"] <= TOL_STATIC_TRAIN_GRAD_REL,
              f"{name} b{batch} step 1, {run} vs the float64 witness: loss "
              f"rel err {r['loss_rel_err']:.3g} <= "
              f"{TOL_STATIC_TRAIN_LOSS_REL}, "
              f"{len(grads)} gradients {r['grad_err_of_largest']:.3g} of "
              f"the largest <= {TOL_STATIC_TRAIN_GRAD_REL}")
    fault = out["card, another batch"]["grad_err_of_largest"]
    check(fault > FAULT_MARGIN * TOL_STATIC_TRAIN_GRAD_REL,
          f"{name}: the step on another batch reads {fault:.3g} of the "
          f"largest gradient > {FAULT_MARGIN} x {TOL_STATIC_TRAIN_GRAD_REL}")
    return out


def train_model(name, seed):
    """One book program trained on the card in fp32 (TF32 off): the
    pipeline's rewrite (fused convs, no rollback), no kernel launch in a
    step, the first step against the CPU, the first step's loss repeated
    by a fresh Executor at the book's dropout rates, finite losses, step
    ms and images/s with the pipeline on and off (alternating blocks), and
    a profile of one step."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.static import layers as L
    from paddle_tpu_torch.static import nets
    from paddle_tpu_torch.utils import monitor

    batch = TRAIN_BOOK_BATCH
    first_step = train_cpu_check(name, seed, batch)
    main, startup, _, fetches = book_train_program(static, L, nets, seed,
                                                   name)
    scope0 = static.Scope()
    static.Executor(DEV).run(startup, scope=scope0)
    rng = np.random.default_rng(seed + 4)
    feed = book_batch(rng, batch)
    rollbacks = monitor.counter("passes.rollbacks")
    rollbacks0 = rollbacks.value()
    feeds = ["img", "label"]
    with opt_passes("default"):
        first = []
        for _ in range(2):      # a fresh Executor: step 0's dropout masks
            with cudnn_flags(deterministic=True):
                first.append(static.Executor(DEV).run(
                    main, feed=feed, fetch_list=fetches[:1],
                    scope=copy_scope(static, scope0))[0])
        check(first[0] == first[1], f"{name}: the first step's loss "
              f"{float(first[0]):.6f} repeats at the book's dropout rates")
        exe = static.Executor(DEV)
        scope = copy_scope(static, scope0)
        ops = exe.executed_program(main, feeds, fetches[:1]) \
            .global_block().ops
        fused = [op for op in ops if op.type == "fused_conv2d_bn_act"]
        n_conv = sum(op.type == "conv2d" for op in main.global_block().ops)
        check(len(fused) == TRAIN_FUSED[name] == n_conv
              and not any(op.attrs["is_test"] for op in fused),
              f"{name}: fuse_conv_bn_act fires on {len(fused)} of the "
              f"training program's {n_conv} convs (want "
              f"{TRAIN_FUSED[name]}), train-mode")
        losses = [float(exe.run(main, feed=feed, fetch_list=fetches[:1],
                                scope=scope)[0])]
        torch.cuda.synchronize()
        config.reset_counts()
        losses.append(float(exe.run(main, feed=feed, fetch_list=fetches[:1],
                                    scope=scope)[0]))
        torch.cuda.synchronize()
        launched = config.launch_counts()
        check(not launched, f"{name}: no port kernel launches in a training "
              f"step ({launched})")
        prof = profile_forward(exe, main, feed, fetches[:1], scope, reps=2,
                               what="training step")
    rolled = rollbacks.value() - rollbacks0
    check(rolled == 0, f"{name}: {rolled} pipeline rollbacks")
    scope_off = copy_scope(static, scope)
    times = interleaved_timings(
        exe, {"on": (main, scope, "default"), "off": (main, scope_off, "")},
        feed, fetches[:1], batch, blocks=TRAIN_BOOK_BLOCKS,
        reps=TRAIN_BOOK_REPS)
    for sc in (scope, scope_off):
        losses.append(float(exe.run(main, feed=feed, fetch_list=fetches[:1],
                                    scope=sc)[0]))
    check(np.isfinite(losses).all(), f"{name}: finite losses {losses}")
    on, off = times["on"], times["off"]
    log(f"[static train] {name} b{batch} fp32: step {on['wall_ms']:.2f} ms "
        f"(IQR {on['wall_iqr_ms']:.2f}) = {on['images_per_s']:.1f} "
        f"images/s with the pipeline, {off['wall_ms']:.2f} ms = "
        f"{off['images_per_s']:.1f} images/s without; device busy "
        f"{prof['busy_ms']:.2f} ms of {prof['wall_ms']:.2f} ms a step "
        f"(share {prof['busy_share']:.3f}); losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}")
    return dict(batch=batch, dtype="float32", fused_convs=len(fused),
                rollbacks=rolled, launches=launched, first_step=first_step,
                losses=losses, pipeline_on=dict(on, profile=prof),
                pipeline_off=off)


def qat_model(seed):
    """vgg16_bn_drop through QuantizationTransformPass (training program
    and its test program), QAT_STEPS Adam steps, QuantizationFreezePass on
    the test program and QUANT_INFER_PIPELINE: launches of rows 15 / 14 /
    13 per forward, the program against its plain versions and against the
    simulate route, the int8 error against the float test program (its
    trained float weights) under DEFAULT_PIPELINE with rows 10 / 13, and
    images/s of both."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.slim import (QuantizationFreezePass,
                                       QuantizationTransformPass)
    from paddle_tpu_torch.static import layers as L
    from paddle_tpu_torch.static import nets
    from paddle_tpu_torch.static import passes as P

    name, batch = "vgg16_bn_drop", TRAIN_BOOK_BATCH
    main, startup, test, fetches = book_train_program(static, L, nets, seed,
                                                      name)
    float_test = test.clone()
    QuantizationTransformPass().apply(main, startup)
    QuantizationTransformPass().apply(test)
    n_fake = sum(op.type.startswith("fake_")
                 for op in main.global_block().ops)
    scope = static.Scope()
    exe = static.Executor(DEV)
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(seed + 5)
    batches = [book_batch(rng, batch) for _ in range(4)]
    losses, walls = [], []
    with opt_passes("default"):
        for i in range(QAT_STEPS):
            t0 = time.perf_counter()
            losses.append(float(exe.run(main, feed=batches[i % 4],
                                        fetch_list=fetches[:1],
                                        scope=scope)[0]))
            walls.append((time.perf_counter() - t0) * 1e3)
    check(np.isfinite(losses).all(), f"qat {name}: {QAT_STEPS} finite "
          f"losses {losses[0]:.4f} -> {losses[-1]:.4f}")
    states = [n for n in scope.keys() if n.endswith("@quant_moving_scale")]
    check(len(states) == 16 and all(float(scope.find_var(n)) > 0
                                    for n in states),
          f"qat {name}: {len(states)} activation-scale states trained")
    qat_ms = float(np.median(walls[2:]))
    float_scope = copy_scope(static, scope)
    QuantizationFreezePass(scope).apply(test)
    logit_fetches = fetches[2:]
    rewritten, report = P.PassManager(P.QUANT_INFER_PIPELINE).apply(
        test, {"img"}, logit_fetches)
    types = [op.type for op in rewritten.global_block().ops]
    quant_ops = {t: types.count(t) for t in ("quant_conv2d", "quant_mul")}
    log(f"[qat] {name} b{batch}: {n_fake} fake-quant ops, {QAT_STEPS} QAT "
        f"steps ({qat_ms:.2f} ms a step, {batch / qat_ms * 1e3:.1f} "
        f"images/s), losses {losses[0]:.4f} -> {losses[-1]:.4f}; frozen: "
        f"{report.to_text()}; {quant_ops}")
    feed = {"img": batches[0]["img"]}
    with opt_passes(""):
        run_static(exe, rewritten, feed, logit_fetches, scope)
        torch.cuda.synchronize()
        config.reset_counts()
        outs = run_static(exe, rewritten, feed, logit_fetches, scope)
        torch.cuda.synchronize()
        counts = config.launch_counts()
        for k, n in QAT_LAUNCHES.items():
            check(counts.get(k, 0) == n, f"qat {name}: {counts.get(k, 0)} "
                  f"{k} launches per int8 forward (want {n})")
        check(all(torch.isfinite(t).all() for t in outs),
              f"qat {name}: finite int8 fetches of shapes "
              f"{[tuple(t.shape) for t in outs]}")
        with int8_plain(), vision_plain():
            plain_outs = run_static(exe, rewritten, feed, logit_fetches,
                                    scope)
        with int8_flag(False):
            sim_outs = run_static(exe, rewritten, feed, logit_fetches, scope)
        n_ops, n_kernel, op_err = int8_ops_against_simulate(
            exe, rewritten, feed, logit_fetches, scope)
        check(n_kernel == 12 and op_err <= TOL_INT8_OP_REL,
              f"qat {name}: {n_ops} quant ops ({n_kernel} on the kernels) "
              f"against the simulate route on the same inputs: rel err "
              f"{op_err:.3g} <= {TOL_INT8_OP_REL}")
        prof = profile_forward(exe, rewritten, feed, logit_fetches, scope)
    with opt_passes("default"):
        config.reset_counts()
        float_outs = run_static(exe, float_test, feed, logit_fetches,
                                float_scope)
        torch.cuda.synchronize()
        fcounts = config.launch_counts()
    for k, n in FLOAT_TEST_LAUNCHES.items():
        check(fcounts.get(k, 0) == n, f"qat {name}: float test program "
              f"under DEFAULT_PIPELINE: {fcounts.get(k, 0)} {k} launches "
              f"(want {n})")
    errs = {}
    for f, got, ref, sim, flt in zip(logit_fetches, outs, plain_outs,
                                     sim_outs, float_outs):
        # the simulate route is held op by op (int8_ops_against_simulate,
        # as the [int8] phase holds it); through the program a last-bit
        # difference that moves an activation across a rounding boundary
        # of the next quantization flips a level, so the whole program's
        # difference is printed, not bounded
        e_plain, e_sim = rel_err(got, ref), rel_err(got, sim)
        check(e_plain <= TOL_INT8_PLAIN_REL, f"qat {name}: fetch {f} "
              f"kernels vs plain versions rel err {e_plain:.3g} <= "
              f"{TOL_INT8_PLAIN_REL} (vs the simulate route {e_sim:.3g})")
        errs[f] = dict(vs_plain=e_plain, vs_simulate=e_sim,
                       int8_rel_err=rel_err(got, flt))
    times = interleaved_timings(
        exe, {"int8": (rewritten, scope, ""),
              "fp32": (float_test, float_scope, "default")},
        feed, logit_fetches, batch)
    q, f = times["int8"], times["fp32"]
    log(f"[qat] {name}: int8 {q['images_per_s']:.1f} images/s (median "
        f"{q['wall_ms']:.3f} ms a run), fp32 test program with "
        f"DEFAULT_PIPELINE {f['images_per_s']:.1f} images/s "
        f"({f['wall_ms']:.3f} ms): {q['images_per_s'] / f['images_per_s']:.3f}"
        f"x; int8 rel err vs the float program "
        f"{errs[logit_fetches[0]]['int8_rel_err']:.4g}")
    return counts, fcounts, dict(
        batch=batch, fake_quant_ops=n_fake, qat_steps=QAT_STEPS,
        qat_step_ms=qat_ms, qat_images_per_s=batch / qat_ms * 1e3,
        losses=[losses[0], losses[-1]], quant_ops=quant_ops,
        ops_before=report.ops_before, ops_after=report.ops_after,
        launches=counts, float_launches=fcounts, errors=errs,
        op_vs_simulate_rel_err=op_err, int8=dict(q, profile=prof), fp32=f,
        vs_fp32=q["images_per_s"] / f["images_per_s"])


def static_train_phase(seed):
    """Static-graph training of the book's VGG-16 and ResNet-32, then QAT
    of VGG-16 into the int8 kernels.  Returns (launches of the QAT-frozen
    forward, of the float test forward, the phase's JSON)."""
    log("[static train] append_backward, Adam, fp32 (TF32 off), b"
        f"{TRAIN_BOOK_BATCH}")
    out = {}
    for name in ("vgg16_bn_drop", "resnet32"):
        out[name] = train_model(name, seed)
        torch.cuda.empty_cache()
    counts, fcounts, out["qat_vgg16_bn_drop"] = qat_model(seed)
    return counts, fcounts, out


def new_entries(bn_cases, train_counts, int8_cases, int8_counts):
    """The kernels-line entries of rows 11, 12, 14 and 15: fp32 at the
    first main-path case, bf16 beside it, every case listed; launches per
    VGG-16 forward of the [vision train] (rows 11-12) and [int8] (rows
    14-15) phases."""
    from paddle_tpu_torch.ops.kernels import bn_act_train as bt
    from paddle_tpu_torch.ops.kernels import int8 as i8

    def entry(name, source, replaces, r, rb, launches, per, shape, library,
              cases):
        return {"name": name, "route": "cuda",
                "source": f"paddle_tpu_torch/ops/kernels/csrc/{source}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                "bound_by": r["bound"][1], "library_ms": r["library_ms"],
                "library": library, "eager_ms": r["eager_ms"],
                "dtype": "float32", "shape": shape,
                "bf16_ms": rb["ms"], "bf16_max_abs_err": rb["err"],
                "bf16_bound_ms": rb["bound"][0],
                "bf16_library_ms": rb["library_ms"],
                "launches_per": per, "cases": cases}

    def cases(results, pick):
        return [dict(case=label, dtype=dtag(dtype), ms=x["ms"],
                     eager_ms=x["eager_ms"], plain_ms=x["plain_ms"],
                     library_ms=x["library_ms"], bound_ms=x["bound"][0],
                     bound_by=x["bound"][1], max_abs_err=x["err"],
                     **{key: x[key] for key in ("cudnn_dequant_ms",
                                                "row10_bf16_ms", "splits")
                        if key in x})
                for label, dtype, x in pick(results)]

    first = BN_CASES[0][0]
    out = []
    for i, (name, replaces, lib) in enumerate((
            (bt.STATS_KERNEL, bt.STATS_REPLACES, "torch.var_mean(x, dim=0)"),
            (bt.SCALE_KERNEL, bt.SCALE_REPLACES,
             "torch.addcmul(b, x, a) then torch.relu"))):
        out.append(entry(
            name, bt.SOURCE, replaces, bn_cases[(first, torch.float32)][i],
            bn_cases[(first, torch.bfloat16)][i],
            train_counts.get(name, 0),
            "vgg16_bn_drop train-mode forward ([vision train], b128)",
            first, lib,
            cases(bn_cases, lambda res: [(lab, dt, x[i]) for (lab, dt), x
                                         in res.items()])))
    for kind, name, source, replaces, lib, first in (
            ("conv", i8.CONV_KERNEL, i8.CONV_SOURCE, i8.CONV_REPLACES,
             "none (no PyTorch call convolves int8; cudnn_dequant_ms is "
             "cuDNN on the dequantized operands, for context)",
             INT8_CONV_CASES[0][0]),
            ("matmul", i8.MATMUL_KERNEL, i8.MATMUL_SOURCE, i8.MATMUL_REPLACES,
             "torch._int_mm (the int32 product alone)",
             INT8_MM_CASES[0][0])):
        r = int8_cases[(kind, first, torch.float32)]
        rb = int8_cases[(kind, first, torch.bfloat16)]
        e = entry(name, source, replaces, r, rb, int8_counts.get(name, 0),
                  "vgg16_bn_drop int8 forward ([int8], b128)", first, lib,
                  cases(int8_cases, lambda res: [
                      (lab, dt, x) for (k, lab, dt), x in res.items()
                      if k == kind]))
        if kind == "conv":
            e["cudnn_dequant_ms"] = r["cudnn_dequant_ms"]
        out.append(e)
    return out

# -- phases 14-16: dygraph training, the rest --------------------------------

# The BERT-base pretraining recipe (Devlin et al. 2019, App. A.2; ERNIE 1.0
# follows it): AdamW, weight decay 0.01, peak LR 1e-4 after a 10000-step
# linear warm-up, then linear decay to 0 over the run (1M steps), and the
# global-norm clip at 1.0.
RECIPE = dict(peak_lr=1e-4, warmup=10000, decay_steps=1_000_000,
              weight_decay=0.01, clip=1.0)
RECIPE_MODES = (("plain", False, None), ("recompute", True, None),
                ("dots_saveable", True, "dots_saveable"))
RECIPE_STEPS, RECIPE_WARM = 7, 2        # steps a mode, of them untimed
# Transformer-base (the JAX package's Transformer defaults; Vaswani et al.
# 2017 base): trained with Adam(0.9, 0.98, 1e-9) under NoamDecay(512, 4000)
# (ibid. 5.3) at b64, source and target 256 tokens, vocab 32000 (the
# script's shared embedding and tied output projection).
SEQ2SEQ = dict(vocab=32000, batch=64, src=256, tgt=256, check_batch=8,
               check_layers=2)
SEQ2SEQ_STEPS, SEQ2SEQ_WARM = 7, 2
QAT_TRAIN_STEPS = 2
# The kernel path against its plain wrappers, each gradient of its largest
# value.  Transformer-base's decoder: its ReLU FFN switches where an input
# sits at 0, and a last-bit difference on either side of 0 flips the
# decision and the whole unit's gradient with it (a decoder linear1.bias
# read 5.09e-3 on an H100).  QAT: a last-bit difference ahead of a
# quantizer moves an activation by a whole int8 level (held against the
# largest gradient of all, 4.77e-3 on an H100).  Each phase's limit is
# about twice its reading; phases 4, 5, 14 and 18 keep
# TOL_TRAIN_GRAD_REL.
TOL_SEQ2SEQ_GRAD_REL = 1e-2
TOL_QAT_GRAD_REL = 1e-2
PTQ_CALIB_BATCHES, PTQ_BATCH = 3, 8
# int8 ERNIE logits against fp32, of the largest: a sanity bound (a wrong
# int8 path reads O(1)); the reading is printed
TOL_PTQ_REL = 0.5
ERNIE_KERNELS = ("flash_attention_packed", "flash_attention_packed_bwd",
                 "residual_layer_norm", "residual_layer_norm_bwd",
                 "layer_norm", "layer_norm_bwd")


def recipe_optimizer():
    from paddle_tpu_torch import optimizer as O

    sched = O.lr.LinearWarmup(
        O.lr.PolynomialDecay(RECIPE["peak_lr"], RECIPE["decay_steps"],
                             end_lr=0.0, power=1.0),
        RECIPE["warmup"], 0.0, RECIPE["peak_lr"])
    return O.AdamW(sched, weight_decay=RECIPE["weight_decay"],
                   grad_clip=O.ClipGradByGlobalNorm(RECIPE["clip"]))


def ernie_cfg(recompute=False, policy=None, **kw):
    from paddle_tpu_torch.text.ernie import ErnieConfig

    return ErnieConfig(enable_recompute=recompute, recompute_policy=policy,
                       **kw)


def count_one(step, *args):
    """``step(*args)`` with every launch count set to 0 just before it;
    returns (its result, the counts just after)."""
    from paddle_tpu_torch.ops.kernels import config

    config.reset_counts()
    out = step(*args)
    torch.cuda.synchronize()
    return out, config.launch_counts()


def check_counts(tag, counts, expect, only=False):
    """Each kernel of ``expect`` launched as often as it says; with
    ``only``, every other kernel that launched fails the check too."""
    for name, want in expect.items():
        check(counts.get(name, 0) == want,
              f"{tag}: {name} {counts.get(name, 0)} launches a step "
              f"({want})")
    if only:
        other = {k: v for k, v in counts.items() if k not in expect and v}
        check(not other, f"{tag}: no other kernel launched ({other})")


def ernie_expect(L, recompute):
    """Launches a pretraining step: the encoder's forward kernels (rows 1
    and 7) run again in the backward under recompute; the embedding and
    MLM-head LayerNorms (rows 5-6) are outside the encoder."""
    k = 2 if recompute else 1
    return {"flash_attention_packed": k * L,
            "flash_attention_packed_bwd": L,
            "residual_layer_norm": 2 * k * L,
            "residual_layer_norm_bwd": 2 * L, "layer_norm": 2,
            "layer_norm_bwd": 2}


def timed_steps(step, params, state, batch, gen, steps, warm):
    """``steps`` steps, the last ``steps - warm`` timed; returns (params,
    state, mean ms, peak GiB over the timed steps, losses)."""
    losses = []
    for i in range(steps):
        if i == warm:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
        params, state, loss = step(params, state, batch, gen)
        losses.append(loss)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (steps - warm) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return params, state, ms, peak, torch.stack(losses).tolist()


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms (warnings only where an op has
    none): the CUDA embedding backward adds duplicate ids' rows in
    whatever order its atomics land, so the token-type gradient moves by
    ~1e-6 between two runs of one step with or without recompute; the
    bit-for-bit comparisons run with it off.  The port's kernels are
    deterministic either way."""
    import warnings

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.use_deterministic_algorithms(False)


def grads_identical(ga, gb):
    """Bit-for-bit equality of two gradient dicts; the largest difference
    (0.0 when identical)."""
    return max(max_abs(ga[k], gb[k]) for k in ga)


def recipe_phase(seed):
    """ERNIE-base pretraining with the BERT recipe, without recompute, with
    it, and with the dots_saveable policy."""
    from paddle_tpu_torch import convert, entry
    from paddle_tpu_torch.core import random as trandom
    from paddle_tpu_torch.text.ernie import (ErnieForPretraining,
                                             ErniePretrainingCriterion)

    base = ernie_cfg()
    seq, b = TRAIN_SEQ, TRAIN_BATCH
    n_mask = max(1, int(seq * 0.15))
    crit = ErniePretrainingCriterion(base.vocab_size)
    rng = np.random.default_rng(seed + 13)
    small_batch = pretrain_batch(rng, 8, seq, base.vocab_size, n_mask,
                                 pad_rows=2)
    out = {"recipe": dict(RECIPE), "modes": {}}
    counts_of = {}

    # fp32 L2 b8: each mode's kernel path against its plain wrappers, and
    # recompute against none (dropout 0 and 0.1, one generator)
    small = {}
    for rate in (0.0, 0.1):
        for name, remat, policy in RECIPE_MODES:
            cfg = ernie_cfg(remat, policy, num_hidden_layers=2,
                            hidden_dropout_prob=rate,
                            attention_probs_dropout_prob=rate)
            model = ErnieForPretraining(
                cfg, device=DEV, generator=torch.Generator().manual_seed(seed))
            model.train()
            step = entry.make_train_step(model, crit, _GradCapture())
            params = convert.parameters_dict(model)
            with deterministic():
                g, _, loss = step(params, None, small_batch,
                                  torch.Generator().manual_seed(seed))
            small[(name, rate)] = (g, loss)
            if rate > 0:
                with plain_wrappers():
                    gp, _, lp = step(params, None, small_batch,
                                     torch.Generator().manual_seed(seed))
                log(f"[recipe] fp32 L2 b8 s{seq} dropout {rate}, {name}: "
                    f"kernel path vs plain wrappers")
                steps_agree(loss, g, lp, gp, "plain")
            del model, step, params
    for rate in (0.0, 0.1):
        g0, l0 = small[("plain", rate)]
        for name in ("recompute", "dots_saveable"):
            g1, l1 = small[(name, rate)]
            d = grads_identical(g0, g1)
            check(torch.equal(l0, l1) and d == 0.0,
                  f"recipe fp32 L2 dropout {rate}: {name} loss and all "
                  f"{len(g0)} gradients bit for bit those without recompute "
                  f"(largest difference {d})")
    del small

    # the eager loop against the functional step, from one state (recipe,
    # recompute on, dropout 0.1)
    cfg = ernie_cfg(True, None, num_hidden_layers=2)
    m1 = ErnieForPretraining(cfg, device=DEV,
                             generator=torch.Generator().manual_seed(seed))
    m2 = ErnieForPretraining(cfg, device=DEV,
                             generator=torch.Generator().manual_seed(seed))
    m1.train()
    m2.train()
    o1, o2 = recipe_optimizer(), recipe_optimizer()
    o1._parameters = list(m1.parameters())
    params = convert.parameters_dict(m2)
    state = o2.init(params)
    step = entry.make_train_step(m2, crit, o2)
    for i in range(2):
        with deterministic(), \
                trandom.rng_scope(torch.Generator().manual_seed(seed + i)):
            logits, nsp = m1(small_batch["input_ids"],
                             small_batch["token_type_ids"],
                             masked_positions=small_batch["masked_positions"])
            loss1 = crit(logits.float(), nsp.float(),
                         small_batch["mlm_labels"], small_batch["nsp_labels"])
            loss1.backward()
        o1.step()
        o1.clear_grad()
        with deterministic():
            params, state, loss2 = step(
                params, state, small_batch,
                torch.Generator().manual_seed(seed + i))
        check(torch.equal(loss1.detach(), loss2),
              f"eager loop step {i}: loss {loss1.item():.6f} equals the "
              f"functional step's")
    d = max(max_abs(p1.detach(), p2.detach())
            for p1, p2 in zip(m1.parameters(), m2.parameters()))
    check(d == 0.0, f"eager loop (loss.backward; opt.step; opt.clear_grad) "
          f"and make_train_step: parameters bit for bit after 2 recipe "
          f"steps (largest difference {d})")
    del m1, m2, o1, o2, params, state, step
    torch.cuda.empty_cache()

    # full width, bf16 over fp32 masters, b64: launches, timings, memory
    L = base.num_hidden_layers
    batch = pretrain_batch(rng, b, seq, base.vocab_size, n_mask)
    H, I, V = base.hidden_size, base.intermediate_size, base.vocab_size
    fwd_per_tok = (L * (8 * H * H + 4 * H * I + 4 * seq * H)
                   + n_mask / seq * (2 * H * H + 2 * H * V)
                   + (2 * H * H + 4 * H) / seq)
    full_grads = {}
    for name, remat, policy in RECIPE_MODES:
        model = ErnieForPretraining(
            ernie_cfg(remat, policy), device=DEV,
            generator=torch.Generator().manual_seed(seed))
        model.train()
        params = convert.parameters_dict(model)
        gstep = entry.make_train_step(model, crit, _GradCapture(),
                                      torch.bfloat16)
        with deterministic():
            g, _, _ = gstep(params, None, batch,
                            torch.Generator().manual_seed(seed))
        full_grads[name] = g
        if name != "plain":
            d = grads_identical(full_grads["plain"], g)
            check(d == 0.0, f"bf16 b{b} s{seq} dropout 0.1: {name} "
                  f"gradients bit for bit those without recompute "
                  f"(largest difference {d})")
        del g
        if name != "plain":
            del full_grads[name]
        opt = recipe_optimizer()
        state = opt.init(params)
        step = entry.make_train_step(model, crit, opt, torch.bfloat16)
        gen = torch.Generator().manual_seed(seed)
        (params, state, _), counts = count_one(step, params, state, batch,
                                               gen)
        check_counts(f"recipe {name}", counts, ernie_expect(L, remat))
        counts_of[name] = counts
        params, state, ms, peak, losses = timed_steps(
            step, params, state, batch, gen, RECIPE_STEPS, RECIPE_WARM)
        check(all(np.isfinite(losses)), f"recipe {name}: losses finite")
        toks = b * seq / ms * 1e3
        mfu = toks * 3 * fwd_per_tok / PEAK_FLOPS[torch.bfloat16]
        lr = float(opt.get_lr(state["step"]))
        log(f"[recipe] {name}: bf16 b{b} s{seq} step {ms:.2f} ms = "
            f"{toks:.1f} tokens/s, MFU {mfu:.4f} (579.1 MFLOP/token, the "
            f"recompute's extra forward not counted), peak {peak:.2f} GiB; "
            f"LR at step {state['step']} {lr:.3e}; losses "
            f"{[round(x, 4) for x in losses]}")
        out["modes"][name] = dict(step_ms=ms, tokens_per_s=toks, mfu=mfu,
                                  peak_gib=peak, launches=counts,
                                  losses=losses)
        del model, params, state, step, gstep, opt
        torch.cuda.empty_cache()
    del full_grads
    base_ms = out["modes"]["plain"]["step_ms"]
    for name in ("recompute", "dots_saveable"):
        m = out["modes"][name]
        m["step_vs_plain"] = m["step_ms"] / base_ms
        log(f"[recipe] {name}: step x{m['step_vs_plain']:.3f} of no "
            f"recompute, peak {m['peak_gib']:.2f} GiB vs "
            f"{out['modes']['plain']['peak_gib']:.2f}")
    out["scaler"] = scaler_check(seed)
    return counts_of, out


def scaler_check(seed):
    """One GradScaler step with a non-finite gradient injected: the update
    is skipped and the scale halves (decr_every_n_nan_or_inf=1); the next,
    finite step updates and counts one good step."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.core import random as trandom
    from paddle_tpu_torch.text.ernie import (ErnieForPretraining,
                                             ErniePretrainingCriterion)

    cfg = ernie_cfg(num_hidden_layers=2)
    crit = ErniePretrainingCriterion(cfg.vocab_size)
    model = ErnieForPretraining(cfg, device=DEV,
                                generator=torch.Generator().manual_seed(seed))
    model.train()
    opt = recipe_optimizer()
    opt._parameters = list(model.parameters())
    scaler = GradScaler(init_loss_scaling=2.0 ** 15,
                        decr_every_n_nan_or_inf=1)
    batch = pretrain_batch(np.random.default_rng(seed), 8, TRAIN_SEQ,
                           cfg.vocab_size, max(1, int(TRAIN_SEQ * 0.15)))
    ran, scales = [], []
    for i, inject in enumerate((True, False)):
        with trandom.rng_scope(torch.Generator().manual_seed(seed + i)):
            logits, nsp = model(batch["input_ids"], batch["token_type_ids"],
                                masked_positions=batch["masked_positions"])
            loss = crit(logits.float(), nsp.float(), batch["mlm_labels"],
                        batch["nsp_labels"])
        scaler.scale(loss).backward()
        if inject:
            p = opt._parameters[5]
            p.grad.view(-1)[7] = float("inf")
        before = [p.detach().clone() for p in opt._parameters]
        ran.append(scaler.step(opt))
        scaler.update()
        scales.append(scaler.get_scale())
        moved = max(max_abs(a, p.detach())
                    for a, p in zip(before, opt._parameters))
        if inject:
            check(not ran[-1] and moved == 0.0, "GradScaler: a non-finite "
                  "gradient skips the update (no parameter moved)")
        else:
            check(ran[-1] and moved > 0.0, "GradScaler: the next finite step "
                  "updates the parameters")
        opt.clear_grad()
    check(scales == [2.0 ** 14, 2.0 ** 14]
          and scaler.state_dict()["incr_count"] == 1,
          f"GradScaler state machine: scale {scales}, "
          f"{scaler.state_dict()}")
    return dict(ran=ran, scales=scales, state=scaler.state_dict())


class Seq2Seq(torch.nn.Module):
    """Transformer-base between the script's own pieces: one embedding of
    the shared vocabulary (scaled by sqrt(d_model)) plus sinusoidal
    positions and dropout on both sides, and the output projection tied to
    the embedding (Vaswani et al. 2017, 3.4-3.5)."""

    def __init__(self, vocab, layers=6, dropout=0.1, generator=None):
        super().__init__()
        from paddle_tpu_torch import nn as pnn

        self.transformer = pnn.Transformer(
            512, 8, layers, layers, 2048, dropout, generator=generator)
        self.embedding = pnn.Embedding(vocab, 512, std=512 ** -0.5,
                                       generator=generator)
        self.dropout = pnn.Dropout(dropout)
        self.d_model = 512

    def embed(self, ids):
        s = ids.shape[1]
        pos = torch.arange(s, device=ids.device, dtype=torch.float32)[:, None]
        i = torch.arange(0, self.d_model, 2, device=ids.device,
                         dtype=torch.float32)
        angle = pos / torch.pow(10000.0, i / self.d_model)
        pe = torch.stack([angle.sin(), angle.cos()], -1).reshape(s, -1)
        x = self.embedding(ids) * math.sqrt(self.d_model)
        return self.dropout(x + pe.to(x.dtype))

    def forward(self, src, tgt, tgt_mask):
        h = self.transformer(self.embed(src), self.embed(tgt),
                             tgt_mask=tgt_mask)
        return torch.matmul(h, self.embedding.weight.t())


def seq2seq_train_step(model, optimizer, compute_dtype):
    """(params, state, batch, generator) -> (params, state, loss), as
    ``entry.make_train_step`` builds it for ERNIE: compute in
    ``compute_dtype`` over fp32 masters, fp32 cross-entropy over the
    target tokens."""
    from paddle_tpu_torch.core import random as trandom
    from paddle_tpu_torch.nn import functional as F

    def train_step(params, state, batch, gen):
        names = list(params)
        leaves = {k: params[k].detach().requires_grad_(True) for k in names}
        with trandom.rng_scope(gen):
            p = {k: v.to(compute_dtype) if v.is_floating_point() else v
                 for k, v in leaves.items()}
            logits = torch.func.functional_call(
                model, p, (batch["src"], batch["tgt"], batch["mask"]))
            loss = F.cross_entropy(logits.float().reshape(
                -1, logits.shape[-1]), batch["labels"].reshape(-1))
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        params, state = optimizer.update(dict(zip(names, grads)), state,
                                         params)
        return params, state, loss.detach()

    return train_step


def seq2seq_phase(seed):
    """Transformer-base training steps at b64, 256 + 256 tokens."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.nn import Transformer

    cfg = SEQ2SEQ
    rng = np.random.default_rng(seed + 14)

    def make_batch(b):
        ids = lambda s: torch.from_numpy(rng.integers(
            4, cfg["vocab"], (b, s))).to(DEV)
        return {"src": ids(cfg["src"]), "tgt": ids(cfg["tgt"]),
                "labels": ids(cfg["tgt"]),
                "mask": Transformer.generate_square_subsequent_mask(
                    cfg["tgt"], device=DEV)}

    def noam_adam():
        return O.Adam(O.lr.NoamDecay(512, 4000), beta1=0.9, beta2=0.98,
                      epsilon=1e-9)

    # fp32 at 2 + 2 layers, b8: kernel path vs plain wrappers at dropout 0.1
    model = Seq2Seq(cfg["vocab"], cfg["check_layers"],
                    generator=torch.Generator().manual_seed(seed)).to(DEV)
    model.train()
    batch = make_batch(cfg["check_batch"])
    step = seq2seq_train_step(model, _GradCapture(), torch.float32)
    params = convert.parameters_dict(model)
    (g, _, loss), counts = count_one(step, params, None, batch,
                                     torch.Generator().manual_seed(seed))
    n = cfg["check_layers"]
    check_counts("seq2seq fp32 check", counts, {
        "flash_attention_packed": 2 * n, "flash_attention_packed_bwd": 2 * n,
        "residual_layer_norm": 5 * n, "residual_layer_norm_bwd": 5 * n})
    with plain_wrappers():
        gp, _, lp = step(params, None, batch,
                         torch.Generator().manual_seed(seed))
    log(f"[seq2seq] fp32 Transformer {n}+{n} layers b{cfg['check_batch']}, "
        f"dropout 0.1: kernel path vs plain wrappers")
    steps_agree(loss, g, lp, gp, "plain", grad_tol=TOL_SEQ2SEQ_GRAD_REL)
    del model, step, params, g, gp
    torch.cuda.empty_cache()

    # full depth, bf16 over fp32 masters, b64
    b = cfg["batch"]
    model = Seq2Seq(cfg["vocab"],
                    generator=torch.Generator().manual_seed(seed)).to(DEV)
    model.train()
    params = convert.parameters_dict(model)
    opt = noam_adam()
    state = opt.init(params)
    step = seq2seq_train_step(model, opt, torch.bfloat16)
    batch = make_batch(b)
    gen = torch.Generator().manual_seed(seed)
    (params, state, _), counts = count_one(step, params, state, batch, gen)
    # encoder self and decoder cross attention: packed kernel; decoder self
    # attention under the (s, s) mask: the plain route
    check_counts("seq2seq", counts, {
        "flash_attention_packed": 12, "flash_attention_packed_bwd": 12,
        "residual_layer_norm": 30, "residual_layer_norm_bwd": 30,
        "layer_norm": 0, "layer_norm_bwd": 0})
    params, state, ms, peak, losses = timed_steps(
        step, params, state, batch, gen, SEQ2SEQ_STEPS, SEQ2SEQ_WARM)
    check(all(np.isfinite(losses)), "seq2seq losses finite")
    tgt_toks = b * cfg["tgt"] / ms * 1e3
    all_toks = b * (cfg["src"] + cfg["tgt"]) / ms * 1e3
    n_params = sum(p.numel() for p in params.values())
    log(f"[seq2seq] Transformer-base bf16 b{b} src {cfg['src']} tgt "
        f"{cfg['tgt']} ({n_params / 1e6:.1f} M parameters), Adam + "
        f"NoamDecay(512, 4000): step {ms:.2f} ms = {tgt_toks:.1f} target "
        f"tokens/s ({all_toks:.1f} source + target), peak {peak:.2f} GiB; "
        f"losses {[round(x, 4) for x in losses]}")
    out = dict(step_ms=ms, target_tokens_per_s=tgt_toks,
               tokens_per_s=all_toks, peak_gib=peak, launches=counts,
               losses=losses, parameters=n_params)
    del model, params, state, step, opt
    torch.cuda.empty_cache()
    return counts, out


def dygraph_quant_phase(seed):
    """ERNIE-base QAT (ImperativeQuantAware) steps, PTQ to Int8Linear, and
    the int32 accumulator against an int64 reference."""
    from paddle_tpu_torch import convert, entry
    from paddle_tpu_torch import slim
    from paddle_tpu_torch.slim import quant as squant
    from paddle_tpu_torch.text.ernie import (ErnieForPretraining,
                                             ErniePretrainingCriterion)

    base = ernie_cfg()
    seq = TRAIN_SEQ
    n_mask = max(1, int(seq * 0.15))
    crit = ErniePretrainingCriterion(base.vocab_size)
    rng = np.random.default_rng(seed + 15)
    out = {}

    def scales(m):
        return {k: v.clone() for k, v in m.named_buffers()
                if k.endswith("in_scale")}

    def restore(m, saved):
        with torch.no_grad():
            for k, v in m.named_buffers():
                if k in saved:
                    v.copy_(saved[k])

    # fp32 L2 b8: the QAT step's kernel path against its plain wrappers
    model = ErnieForPretraining(ernie_cfg(num_hidden_layers=2), device=DEV,
                                generator=torch.Generator().manual_seed(seed))
    slim.ImperativeQuantAware().quantize(model)
    model.train()
    step = entry.make_train_step(model, crit, _GradCapture())
    params = convert.parameters_dict(model)
    batch = pretrain_batch(rng, 8, seq, base.vocab_size, n_mask, pad_rows=2)
    s0 = scales(model)
    (g, _, loss), _ = count_one(step, params, None, batch,
                                torch.Generator().manual_seed(seed))
    s1 = scales(model)
    restore(model, s0)
    with plain_wrappers():
        gp, _, lp = step(params, None, batch,
                         torch.Generator().manual_seed(seed))
    log("[qat] fp32 L2 b8 QAT step: kernel path vs plain wrappers")
    steps_agree(loss, g, lp, gp, "plain", floor=1.0,
                grad_tol=TOL_QAT_GRAD_REL)
    sd = max(abs(float(s1[k]) - float(v)) / float(v)
             for k, v in scales(model).items())
    check(all(float(v) > 0 for v in s1.values()) and sd <= 1 / 127,
          f"{len(s1)} activation scales learned, the two paths' within "
          f"{sd:.3g} relative (<= one int8 level, 1/127: a rounding "
          f"difference ahead of a quantizer moves an activation by a "
          f"level, and the abs-maxes after it)")
    del model, step, params, g, gp
    torch.cuda.empty_cache()

    # full width bf16 b64: QAT steps with the recipe
    b = TRAIN_BATCH
    model = ErnieForPretraining(base, device=DEV,
                                generator=torch.Generator().manual_seed(seed))
    slim.ImperativeQuantAware().quantize(model)
    model.train()
    params = convert.parameters_dict(model)
    opt = recipe_optimizer()
    state = opt.init(params)
    step = entry.make_train_step(model, crit, opt, torch.bfloat16)
    batch = pretrain_batch(rng, b, seq, base.vocab_size, n_mask)
    gen = torch.Generator().manual_seed(seed)
    (params, state, _), qat_counts = count_one(step, params, state, batch,
                                               gen)
    check_counts("qat", qat_counts, ernie_expect(base.num_hidden_layers,
                                                 False))
    params, state, ms, peak, losses = timed_steps(
        step, params, state, batch, gen, QAT_TRAIN_STEPS + 1, 1)
    check(all(np.isfinite(losses)), "QAT losses finite")
    log(f"[qat] ERNIE-base QAT bf16 b{b} s{seq}: step {ms:.2f} ms = "
        f"{b * seq / ms * 1e3:.1f} tokens/s, peak {peak:.2f} GiB")
    out["qat"] = dict(step_ms=ms, tokens_per_s=b * seq / ms * 1e3,
                      peak_gib=peak, launches=qat_counts, losses=losses)
    del model, params, state, step, opt
    torch.cuda.empty_cache()

    # PTQ: calibrate ERNIE-base's Linears, convert, the b8 eval forward
    model = ErnieForPretraining(base, device=DEV,
                                generator=torch.Generator().manual_seed(seed))
    model.eval()
    ids = lambda: torch.from_numpy(rng.integers(5, base.vocab_size,
                                                (PTQ_BATCH, seq))).to(DEV)
    x = ids()
    with torch.no_grad():
        ref = model(x)[0].float()
    ptq = slim.PostTrainingQuantization(model)
    for _ in range(PTQ_CALIB_BATCHES):
        ptq.sample(ids())
    ptq.convert()
    n_int8 = sum(isinstance(m, squant.Int8Linear) for m in model.modules())
    with torch.no_grad():
        (got, _), ptq_counts = count_one(model, x)
    err = rel_err(got.float(), ref)
    check(n_int8 == 6 * base.num_hidden_layers + 3 and torch.isfinite(
        got).all() and err <= TOL_PTQ_REL,
        f"PTQ ERNIE-base: {n_int8} Int8Linear layers; the int8 b{PTQ_BATCH} "
        f"s{seq} MLM logits within {err:.4f} of the largest fp32 logit "
        f"(<= {TOL_PTQ_REL})")
    check_counts("PTQ forward", ptq_counts, {
        "flash_attention_packed": base.num_hidden_layers,
        "residual_layer_norm": 2 * base.num_hidden_layers, "layer_norm": 2})
    # Int8Linear's int32 accumulator against an int64 product
    lin = model.ernie.encoder.layers[0].linear1
    h = torch.randn(PTQ_BATCH * seq, base.hidden_size, device=DEV,
                    generator=torch.Generator(DEV).manual_seed(seed))
    xq = lin.quantize_input(h * 2.0)
    acc = squant.int8_matmul(xq, lin.w_int8)
    ref64 = xq.cpu().to(torch.int64) @ lin.w_int8.cpu().to(torch.int64)
    check(acc.dtype == torch.int32 and torch.equal(acc.cpu().to(torch.int64),
                                                   ref64),
          f"Int8Linear int32 accumulator ({tuple(acc.shape)}, |max| "
          f"{int(ref64.abs().max())}) equals the int64 product exactly")
    odd = squant.int8_matmul(xq[:5, :40], lin.w_int8[:40, :6])
    odd64 = xq[:5, :40].cpu().to(torch.int64) @ \
        lin.w_int8[:40, :6].cpu().to(torch.int64)
    check(torch.equal(odd.cpu().to(torch.int64), odd64),
          "int8_matmul padded to torch._int_mm's shape rules (5 x 40 x 6) "
          "exact")
    log(f"[ptq] ERNIE-base int8 b{PTQ_BATCH} s{seq}: logits rel err {err:.4f}"
        f" of the largest; launches {ptq_counts}")
    out["ptq"] = dict(rel_err=err, int8_layers=n_int8, launches=ptq_counts)
    del model, ptq
    torch.cuda.empty_cache()
    return qat_counts, ptq_counts, out

# -- phase 17: the tensor op library ---------------------------------------

def ops_phase(seed):
    """Every exported op of the library (``paddle_tpu_torch.ops.cases``, the
    table the CPU parity test runs against the JAX package) and every
    ``nn.functional`` function of its sibling table ``FUNCTIONAL_CASES``
    on the card and on the CPU on the same inputs: every tensor out lies
    on the card; exact families bit for bit, the rest within
    ``cases.TOLERANCE``, decompositions by their reconstructions (1e-4),
    random ops by their range and by repeating under one seed on the
    card."""
    import paddle_tpu_torch as P
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.ops import cases as C

    def on(dev):
        return lambda a: torch.from_numpy(a).to(dev)

    t0 = time.perf_counter()
    worst = {}
    names = {"ops": set(), "nn.functional": set()}
    tables = (("ops", P, C.CASES, 0),
              ("nn.functional", F, C.FUNCTIONAL_CASES, len(C.CASES)))
    for table, mod, cases, offset in tables:
        for j, case in enumerate(cases):
            i = offset + j
            args, kwargs = case.make(np.random.default_rng(seed + i))
            fn = getattr(mod, case.name)
            names[table].add(case.name)
            tag = f"{table} {case.name} (case {j})"
            if case.family == "random":
                draws = []
                with P.device_guard(DEV):
                    for _ in range(2):
                        P.seed(seed + i)
                        draws.append(fn(*C.to_framework(args, on(DEV)),
                                        **kwargs))
                a, b = draws
                ok = (a.device.type == torch.device(DEV).type
                      and torch.equal(a, b)
                      and case.check(args, a.cpu().numpy()))
                if not ok:
                    check(False, f"{tag}: a draw on the card, repeated "
                          f"under one seed, in range")
                continue
            with P.device_guard("cpu"):
                ref = fn(*C.to_framework(args, on("cpu")),
                         **C.to_framework(kwargs, on("cpu")))
            with P.device_guard(DEV):
                got = fn(*C.to_framework(args, on(DEV)),
                         **C.to_framework(kwargs, on(DEV)))
            rl, gl = C.leaves(ref), C.leaves(got)
            if len(rl) != len(gl) or not all(
                    isinstance(g, torch.Tensor)
                    and g.device.type == torch.device(DEV).type for g in gl):
                check(False, f"{tag}: every output a tensor on the card")
            gl = [g.cpu() for g in gl]
            if case.family == "decomp":
                out = [g.numpy() for g in gl]
                err = case.check(args, out if len(out) > 1 else out[0])
                ok = err < 1e-4
            else:
                err = 0.0
                ok = all(r.shape == g.shape and r.dtype == g.dtype
                         for r, g in zip(rl, gl))
                for r, g in zip(rl, gl):
                    if not ok:
                        break
                    if case.family == "exact" or not (r.is_floating_point()
                                                     or r.is_complex()):
                        same = (r == g) | (r.isnan() & g.isnan()) if (
                            r.is_floating_point()) else (r == g)
                        ok = bool(same.all())
                    else:
                        rtol, atol = C.TOLERANCE[case.family]
                        ok = torch.allclose(g, r, rtol=rtol, atol=atol,
                                            equal_nan=True)
                        d = (g - r).abs()
                        d = d[~d.isnan()]
                        if d.numel():
                            err = max(err, float(d.max()))
            if not ok:
                check(False, f"{tag} [{case.family}]: the card's result "
                      f"against the CPU's (err {err:.3g})")
            worst[case.family] = max(worst.get(case.family, 0.0), err)
    secs = time.perf_counter() - t0
    cases = C.CASES + C.FUNCTIONAL_CASES
    families = {f: sum(c.family == f for c in cases)
                for f in sorted({c.family for c in cases})}
    check(names["ops"] == {n for n in P.ops.__all__
                           if callable(getattr(P.ops, n))},
          f"ops: all {len(names['ops'])} exported ops and "
          f"{len(names['nn.functional'])} nn.functional functions ran, "
          f"{len(cases)} cases ({families}) on the card against the CPU in "
          f"{secs:.1f} s; exact bit for bit, worst abs err by family "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()
                      if k != "exact"))
    return dict(ops=len(names["ops"]),
                functional=len(names["nn.functional"]), cases=len(cases),
                families=families, worst_abs_err=worst, seconds=secs)


# -- phase 18: ERNIE-base fine-tuning through the dygraph loop ----------------

# BERT's GLUE fine-tuning (Devlin et al. 2019, 4.1 and App. A.3): batch 32,
# sequences of 128 (lengths drawn from --seed in 16-128, so the packed
# kernel's key bias runs), dropout 0.1, AdamW at lr 2e-5 with weight decay
# 0.01, LinearWarmup over the first 10% into a linear decay, global-norm
# clip 1.0, fp32 with TF32 off (what the JAX package's dygraph loop
# computes).  The schedule spans 3 epochs of MRPC's 3668 training pairs
# (345 steps, 34 of warm-up).
FINETUNE = dict(batch=32, seq=128, len_lo=16, len_hi=128, lr=2e-5,
                weight_decay=0.01, clip=1.0, num_classes=2, total_steps=345,
                warmup=34, check_layers=2, steps=7, warm=2)
# Launches of rows 1, 2, 7, 8, 5 and 6 per fine-tuning step: the encoder's
# attention and its two residual LayerNorms a layer, the embedding
# LayerNorm once (no MLM head).
FINETUNE_LAUNCHES = {"flash_attention_packed": 12,
                     "flash_attention_packed_bwd": 12,
                     "residual_layer_norm": 24, "residual_layer_norm_bwd": 24,
                     "layer_norm": 1, "layer_norm_bwd": 1}


def finetune_optimizer(parameters=None):
    from paddle_tpu_torch import optimizer as O

    cfg = FINETUNE
    sched = O.lr.LinearWarmup(
        O.lr.PolynomialDecay(cfg["lr"], cfg["total_steps"], end_lr=0.0,
                             power=1.0), cfg["warmup"], 0.0, cfg["lr"])
    return O.AdamW(sched, parameters=parameters,
                   weight_decay=cfg["weight_decay"],
                   grad_clip=O.ClipGradByGlobalNorm(cfg["clip"]))


def finetune_batch(rng, vocab):
    """Sentence pairs as token ids: lengths in [len_lo, len_hi], segment 1
    after a random split, padding 0 past the length; labels 0 / 1."""
    import paddle_tpu_torch as P

    cfg = FINETUNE
    b, s = cfg["batch"], cfg["seq"]
    lens = rng.integers(cfg["len_lo"], cfg["len_hi"] + 1, b)
    mask = (np.arange(s)[None] < lens[:, None]).astype(np.int64)
    ids = rng.integers(5, vocab, (b, s)) * mask
    split = (lens * rng.uniform(0.3, 0.7, b)).astype(np.int64)
    types = ((np.arange(s)[None] >= split[:, None]) * mask).astype(np.int64)
    labels = rng.integers(0, cfg["num_classes"], b)
    return [P.to_tensor(a) for a in (ids, types, mask, labels)], int(
        lens.sum())


def finetune_model(cfg, state, seed):
    """``ErnieForSequenceClassification`` on the card with ``state`` (the
    JAX package's ``state_dict()`` form: numpy arrays under its names) put
    in through ``set_state_dict``."""
    from paddle_tpu_torch.text.ernie import ErnieForSequenceClassification

    model = ErnieForSequenceClassification(
        cfg, num_classes=FINETUNE["num_classes"], device=DEV,
        generator=torch.Generator().manual_seed(seed + 1))
    missing, unexpected = model.set_state_dict(state)
    check(missing == [] and unexpected == [],
          f"finetune: set_state_dict took all {len(state)} weights")
    return model


def finetune_state(cfg, seed):
    from paddle_tpu_torch.text.ernie import ErnieForSequenceClassification

    src = ErnieForSequenceClassification(
        cfg, num_classes=FINETUNE["num_classes"], device="cpu",
        generator=torch.Generator().manual_seed(seed))
    return {k: v.numpy() for k, v in src.state_dict().items()}


def finetune_loss(model, batch):
    import paddle_tpu_torch as P
    import paddle_tpu_torch.nn.functional as F

    ids, types, mask, labels = batch
    return P.mean(F.cross_entropy(model(ids, types, attention_mask=mask),
                                  labels))


def finetune_phase(seed):
    """The book's dygraph loop (``loss.backward(); opt.minimize(loss);
    model.clear_gradients()``) fine-tuning ERNIE-base for sentence
    classification, then one eval batch."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import autograd, dygraph
    from paddle_tpu_torch.core import random as trandom

    rng = np.random.default_rng(seed + 18)
    cfg = FINETUNE
    base = ernie_cfg()
    out = {"recipe": dict(cfg)}

    # fp32 L2: the loop's step on the kernels against its plain wrappers,
    # and against autograd.value_and_grad + opt.update bit for bit
    small = ernie_cfg(num_hidden_layers=cfg["check_layers"])
    state = finetune_state(small, seed)
    batch, _ = finetune_batch(rng, base.vocab_size)
    model = finetune_model(small, state, seed)
    model.train()

    def grads_of_one_step():
        with dygraph.guard(), \
                trandom.rng_scope(torch.Generator().manual_seed(seed)):
            loss = finetune_loss(model, batch)
            loss.backward()
        g = {k: p.grad.detach().clone()
             for k, p in model.named_parameters()}
        model.clear_gradients()
        return loss.detach(), g

    with deterministic():
        loss, g = grads_of_one_step()
        with plain_wrappers():
            lp, gp = grads_of_one_step()
    log(f"[finetune] fp32 L{cfg['check_layers']} b{cfg['batch']} "
        f"s{cfg['seq']} dropout 0.1: the loop's kernel path vs plain "
        f"wrappers")
    steps_agree(loss, g, lp, gp, "plain")
    del g, gp

    eager = finetune_model(small, state, seed)
    eager.train()
    opt = finetune_optimizer(eager.parameters())
    func = finetune_model(small, state, seed)
    func.train()
    fopt = finetune_optimizer()
    params = autograd.parameters_dict(func)
    fstate = fopt.init(params)
    vag = autograd.value_and_grad(func, lambda *b: finetune_loss(func, b))
    with deterministic():
        for i in range(2):
            with dygraph.guard(), trandom.rng_scope(
                    torch.Generator().manual_seed(seed + i)):
                loss1 = finetune_loss(eager, batch)
                loss1.backward()
                opt.minimize(loss1)
                eager.clear_gradients()
            loss2, grads = vag(params, *batch,
                               rng=torch.Generator().manual_seed(seed + i))
            params, fstate = fopt.update(grads, fstate, params)
            check(torch.equal(loss1.detach(), loss2),
                  f"finetune loop step {i}: loss {loss1.item():.6f} equals "
                  f"autograd.value_and_grad's")
    d = max(max_abs(a, b) for a, b in zip(eager.state_dict().values(),
                                          func.state_dict().values()))
    check(d == 0.0, f"finetune: the dygraph loop and value_and_grad + "
          f"opt.update, parameters bit for bit after 2 recipe steps "
          f"(largest difference {d})")
    del model, eager, func, opt, fopt, params, fstate, vag, grads
    torch.cuda.empty_cache()

    # full width: launches a step, timed steps, peak memory, one eval batch
    L = base.num_hidden_layers
    model = finetune_model(base, finetune_state(base, seed), seed)
    model.train()
    opt = finetune_optimizer(model.parameters())
    batches = [finetune_batch(rng, base.vocab_size) for _ in range(2)]

    def step(batch):
        with dygraph.guard():
            loss = finetune_loss(model, batch)
            loss.backward()
            opt.minimize(loss)
            model.clear_gradients()
        return loss.detach()

    _, counts = count_one(step, batches[0][0])
    check_counts("finetune", counts, FINETUNE_LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(cfg["steps"]):
        if i == cfg["warm"]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(step(batches[i % 2][0]))
    torch.cuda.synchronize()
    timed = cfg["steps"] - cfg["warm"]
    ms = (time.perf_counter() - t0) / timed * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = torch.stack(losses).tolist()
    check(all(np.isfinite(losses)), "finetune losses finite")
    seqs = cfg["batch"] / ms * 1e3
    toks = sum(batches[i % 2][1] for i in range(cfg["warm"], cfg["steps"])
               ) / timed / ms * 1e3
    lr = float(opt.get_lr())
    prof = profile_split(lambda: step(batches[0][0]))
    log(f"[finetune] ERNIE-base fp32 b{cfg['batch']} s{cfg['seq']} "
        f"(lengths {cfg['len_lo']}-{cfg['len_hi']}): step {ms:.2f} ms = "
        f"{seqs:.1f} sequences/s ({toks:.1f} real tokens/s), peak "
        f"{peak:.2f} GiB; LR after {cfg['steps'] + 3} steps {lr:.3e}; "
        f"losses {[round(x, 4) for x in losses]}; launches {counts}")

    ids, types, mask, labels = finetune_batch(rng, base.vocab_size)[0]
    model.eval()
    with P.no_grad():
        (logits, acc), eval_counts = count_one(
            lambda: _eval(model, ids, types, mask, labels))
    check(logits.shape == (cfg["batch"], cfg["num_classes"])
          and bool(torch.isfinite(logits).all()) and 0.0 <= acc <= 1.0
          and not logits.requires_grad,
          f"finetune eval: logits {tuple(logits.shape)} finite, accuracy "
          f"{acc:.4f}")
    check_counts("finetune eval forward", eval_counts, {
        "flash_attention_packed": L, "residual_layer_norm": 2 * L,
        "layer_norm": 1, "flash_attention_packed_bwd": 0})
    out.update(step_ms=ms, sequences_per_s=seqs, tokens_per_s=toks,
               peak_gib=peak, launches=counts, eval_launches=eval_counts,
               losses=losses, eval_accuracy=acc, profile=prof)
    del model, opt
    torch.cuda.empty_cache()
    return counts, out


def _eval(model, ids, types, mask, labels):
    import paddle_tpu_torch as P

    logits = model(ids, types, attention_mask=mask)
    acc = P.mean(P.cast(P.equal(P.argmax(logits, -1), labels), "float32"))
    return logits, float(acc)


# -- phases 19-20: sequence labelling -----------------------------------------

# Phase 19: ERNIE 1.0's MSRA-NER task (Sun et al. 2019, 4) with a CRF head,
# as PaddleNLP's ERNIE-CRF taggers: ERNIE-base, dropout, an emission
# Linear(768, 7) and ``ops.crf.linear_chain_crf``; the 7 tags are the IOB
# tags of PER, ORG and LOC in chunk_eval's convention (type * 2 + tag, O =
# 6).  Phase 18's recipe and batches (b32 s128, lengths 16-128 from
# --seed, dropout 0.1, AdamW 2e-5 with decay 0.01, clip 1.0, fp32 with TF32
# off); labels are random IOB chunkings.
TAGGING = dict(num_tags=7, num_chunk_types=3, check_layers=2, steps=7, warm=2)
# Phase 20: Baidu's LAC (Jiao et al. 2018; PaddlePaddle/models
# lexical_analysis, the Fluid-era net): word embedding 128 (is_sparse, a
# dense gradient in the port), two stacked bidirectional GRUs of hidden
# 128, an emission to 57 tags (28 chunk types in IOB, O = 56) and Fluid's
# linear_chain_crf / crf_decoding / chunk_eval, at batch 300 and sequences
# up to 64 words, as its training script sets them.  LAC's dictionary is
# not in the repo and its size is not confirmed: the vocabulary, 60,000
# ids, is a guess, and the embedding table's share of the step time and
# the peak memory goes with it.  Lookahead(Adam(1e-3)), an EMA of the
# weights applied for the eval decode.
LAC = dict(vocab=60000, emb=128, hidden=128, layers=2, num_tags=57,
           num_chunk_types=28, batch=300, max_len=64, len_lo=4, lr=1e-3,
           lookahead_alpha=0.5, lookahead_k=5, ema_decay=0.999, steps=7,
           warm=2, extras_steps=3)
# Decoded paths are compared where the best path beats every other path by
# more than this (the max-marginal margin, float64 on the host)
VITERBI_MARGIN = 1e-4

_TAGGING_MODELS = None


def tagging_models():
    """The two sequence-labelling models of phases 19-20, as port layers:
    (ErnieCrfTagger, BiGruCrfTagger).  Built on the first call (the script
    imports the port only once a card is found)."""
    global _TAGGING_MODELS
    if _TAGGING_MODELS is not None:
        return _TAGGING_MODELS
    import paddle_tpu_torch as P
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.nn import initializer as I
    from paddle_tpu_torch.nn.layer.common import make_param
    from paddle_tpu_torch.ops import crf
    from paddle_tpu_torch.text.ernie import ErnieModel

    class _CrfTagger(nn.Layer):
        """A linear-chain CRF over the emissions of ``forward``; the
        transition in Fluid's layout (start, stop, then [from, to]),
        XavierUniform as Fluid's default."""

        def _transition(self, num_tags, generator):
            make_param(self, "transition", I.XavierUniform(),
                       (num_tags + 2, num_tags), generator)

        def loss(self, emission, labels, lengths):
            return P.mean(crf.linear_chain_crf(emission, labels,
                                               self.transition, lengths))

        def decode(self, emission, lengths):
            return crf.crf_decoding(emission, self.transition, lengths)

    class ErnieCrfTagger(_CrfTagger):
        """ERNIE, dropout, an emission Linear and a CRF."""

        def __init__(self, config, num_tags, *, device=None, generator=None):
            super().__init__()
            self.ernie = ErnieModel(config, device="cpu",
                                    generator=generator)
            self.dropout = nn.Dropout(config.hidden_dropout_prob)
            self.emission = nn.Linear(config.hidden_size, num_tags,
                                      generator=generator)
            self._transition(num_tags, generator)
            self.to(resolve_device(device))

        def forward(self, input_ids, token_type_ids, attention_mask):
            seq, _ = self.ernie(input_ids, token_type_ids,
                                attention_mask=attention_mask)
            return self.emission(self.dropout(seq))

    class BiGruCrfTagger(_CrfTagger):
        """LAC's net: a word embedding, stacked bidirectional GRUs over the
        ragged batch, an emission Linear and a CRF."""

        def __init__(self, vocab, emb_dim, hidden, num_layers, num_tags, *,
                     device=None, generator=None):
            super().__init__()
            # sparse=True as LAC's is_sparse (the gradient is dense)
            self.word_emb = nn.Embedding(vocab, emb_dim, None, True,
                                         std=0.1, generator=generator)
            self.gru = nn.GRU(emb_dim, hidden, num_layers, "bidirect",
                              generator=generator)
            self.emission = nn.Linear(2 * hidden, num_tags,
                                      generator=generator)
            self._transition(num_tags, generator)
            self.to(resolve_device(device))

        def forward(self, word_ids, lengths):
            out, _ = self.gru(self.word_emb(word_ids),
                              sequence_length=lengths)
            return self.emission(out)

    _TAGGING_MODELS = ErnieCrfTagger, BiGruCrfTagger
    return _TAGGING_MODELS


def iob_tags(rng, lengths, s, n_types):
    """Random IOB chunkings (chunks of 1-4 steps of a random type, O
    between), type * 2 + tag with O = 2 * n_types, O past each length."""
    other = 2 * n_types
    tags = np.full((len(lengths), s), other, np.int64)
    for i, n in enumerate(lengths):
        t = 0
        while t < n:
            if rng.random() < 0.4:
                typ, k = int(rng.integers(0, n_types)), int(
                    min(rng.integers(1, 5), n - t))
                tags[i, t] = 2 * typ
                tags[i, t + 1:t + k] = 2 * typ + 1
                t += k
            else:
                t += 1
    return tags


def tagging_batch(rng, vocab):
    """Phase 18's sentence batches with IOB labels: (ids, types, mask,
    labels, lengths) on the current device."""
    import paddle_tpu_torch as P

    b, s = FINETUNE["batch"], FINETUNE["seq"]
    lens = rng.integers(FINETUNE["len_lo"], FINETUNE["len_hi"] + 1, b)
    mask = (np.arange(s)[None] < lens[:, None]).astype(np.int64)
    ids = rng.integers(5, vocab, (b, s)) * mask
    labels = iob_tags(rng, lens, s, TAGGING["num_chunk_types"])
    return [P.to_tensor(a) for a in (ids, np.zeros_like(ids), mask, labels,
                                     lens)]


def tagging_loss(model, batch):
    ids, types, mask, labels, lens = batch
    return model.loss(model(ids, types, mask), labels, lens)


def viterbi_margins(emission, transition, lengths):
    """For each sequence, its best path's score minus the best score of any
    path that differs from it somewhere, from max-marginals (max-product
    forward and backward messages) in float64 on the host."""
    e = emission.detach().cpu().double().numpy()
    tr = transition.detach().cpu().double().numpy()
    start, stop, trans = tr[0], tr[1], tr[2:]
    out = []
    for b, n in enumerate(lengths.tolist()):
        fwd = [start + e[b, 0]]
        for t in range(1, n):
            fwd.append((fwd[-1][:, None] + trans).max(0) + e[b, t])
        bwd = [stop]
        for t in range(n - 2, -1, -1):
            bwd.append((trans + (e[b, t + 1] + bwd[-1])[None, :]).max(1))
        m = np.stack(fwd) + np.stack(bwd[::-1])                  # (n, D)
        best = m.max()
        m[np.arange(n), m.argmax(1)] = -np.inf
        out.append(best - m.max())
    return np.asarray(out)


def decode_check(tag, model, emission, labels, lens, n_types, seed):
    """The card's Viterbi paths against the CPU's on the same emissions,
    wherever the best path beats the runner-up by more than
    VITERBI_MARGIN, and chunk_eval's counts there exact; on the model's
    emissions and on them plus N(0, 3^2) noise from ``seed`` (a model
    this briefly trained tags nearly everything O: the noisy probe gives
    paths with chunks).  Returns the card's P / R / F1 of the model's
    paths over every row and the compared shares."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.ops import crf

    noise = torch.randn(emission.shape, generator=torch.Generator()
                        .manual_seed(seed)).to(emission.device)
    out = {}
    for name, em in (("model", emission), ("probe", emission + 3 * noise)):
        paths = model.decode(em, lens)
        with P.device_guard("cpu"):
            cpu_paths = crf.crf_decoding(em.cpu(), model.transition.cpu(),
                                         lens.cpu())
        clear = torch.from_numpy(viterbi_margins(em, model.transition, lens)
                                 > VITERBI_MARGIN)
        same = (paths.cpu() == cpu_paths).all(1)
        check(bool(same[clear].all()) and bool(clear.any()),
              f"{tag} {name}: crf_decoding on the card equals the CPU's on "
              f"{int(clear.sum())} of {len(clear)} rows with a margin over "
              f"{VITERBI_MARGIN} ({int(same.sum())} rows equal in all)")
        rows = clear.nonzero()[:, 0]
        got = P.chunk_eval(paths[rows.to(paths.device)],
                           labels[rows.to(labels.device)],
                           lens[rows.to(lens.device)], "IOB", n_types)
        with P.device_guard("cpu"):
            ref = P.chunk_eval(cpu_paths[rows], labels.cpu()[rows],
                               lens.cpu()[rows], "IOB", n_types)
        counts = [int(x) for x in got[3:]]
        check(counts == [int(x) for x in ref[3:]]
              and (name == "model" or min(counts) > 0),
              f"{tag} {name}: chunk_eval counts (inferred, labelled, "
              f"correct) {counts} on the card equal the CPU's on those rows")
        prf = [float(x) for x in P.chunk_eval(paths, labels, lens, "IOB",
                                              n_types)[:3]]
        log(f"[{tag}] {name} paths: P / R / F1 {prf[0]:.4f} / {prf[1]:.4f} "
            f"/ {prf[2]:.4f} (random weights and labels)")
        out[name] = dict(precision=prf[0], recall=prf[1], f1=prf[2],
                         counts=counts, compared_rows=int(clear.sum()),
                         rows=len(clear), equal_rows=int(same.sum()))
    return out


def tagging_phase(seed):
    """ERNIE-base + CRF NER fine-tuning through the book's dygraph loop,
    then one eval batch decoded on the card."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.core import random as trandom

    ErnieCrfTagger, _ = tagging_models()
    rng = np.random.default_rng(seed + 19)
    cfg = TAGGING
    base = ernie_cfg()
    out = {"recipe": dict(FINETUNE, **cfg)}

    # fp32 L2: the loop's step on the kernels against its plain wrappers
    small = ernie_cfg(num_hidden_layers=cfg["check_layers"])
    model = ErnieCrfTagger(small, cfg["num_tags"], device=DEV,
                           generator=torch.Generator().manual_seed(seed))
    model.train()
    batch = tagging_batch(rng, base.vocab_size)

    def grads_of_one_step():
        with dygraph.guard(), \
                trandom.rng_scope(torch.Generator().manual_seed(seed)):
            loss = tagging_loss(model, batch)
            loss.backward()
        g = {k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None}
        model.clear_gradients()
        return loss.detach(), g

    with deterministic():
        loss, g = grads_of_one_step()
        with plain_wrappers():
            lp, gp = grads_of_one_step()
    check("transition" in g and set(g) == set(gp),
          f"tagging: {len(g)} gradients, the CRF transition's among them")
    log(f"[tagging] fp32 L{cfg['check_layers']} b{FINETUNE['batch']} "
        f"s{FINETUNE['seq']} dropout 0.1: the loop's kernel path vs plain "
        f"wrappers")
    steps_agree(loss, g, lp, gp, "plain")
    del model, g, gp
    torch.cuda.empty_cache()

    # full width: launches a step, timed steps, peak memory, one eval batch
    L = base.num_hidden_layers
    model = ErnieCrfTagger(base, cfg["num_tags"], device=DEV,
                           generator=torch.Generator().manual_seed(seed))
    model.train()
    opt = finetune_optimizer(model.parameters())
    batches = [tagging_batch(rng, base.vocab_size) for _ in range(2)]

    def step(batch):
        with dygraph.guard():
            loss = tagging_loss(model, batch)
            loss.backward()
            opt.minimize(loss)
            model.clear_gradients()
        return loss.detach()

    _, counts = count_one(step, batches[0])
    check_counts("tagging", counts, FINETUNE_LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(cfg["steps"]):
        if i == cfg["warm"]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(step(batches[i % 2]))
    torch.cuda.synchronize()
    timed = cfg["steps"] - cfg["warm"]
    ms = (time.perf_counter() - t0) / timed * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = torch.stack(losses).tolist()
    check(all(np.isfinite(losses)), "tagging losses finite")
    seqs = FINETUNE["batch"] / ms * 1e3
    prof = profile_split(lambda: step(batches[0]))
    log(f"[tagging] ERNIE-base + CRF fp32 b{FINETUNE['batch']} "
        f"s{FINETUNE['seq']}: step {ms:.2f} ms = {seqs:.1f} sequences/s, "
        f"peak {peak:.2f} GiB, device busy {prof.get('busy_ms', 0.0):.2f} "
        f"ms of it (profiled); losses {[round(x, 3) for x in losses]}; "
        f"launches {counts}")

    ids, types, mask, labels, lens = tagging_batch(rng, base.vocab_size)
    model.eval()
    with P.no_grad():
        emission, eval_counts = count_one(lambda: model(ids, types, mask))
        check(tuple(emission.shape) == (FINETUNE["batch"], FINETUNE["seq"],
                                        cfg["num_tags"])
              and bool(torch.isfinite(emission).all()),
              f"tagging eval: emissions {tuple(emission.shape)} finite")
        check_counts("tagging eval forward", eval_counts, {
            "flash_attention_packed": L, "residual_layer_norm": 2 * L,
            "layer_norm": 1, "flash_attention_packed_bwd": 0})
        evaluation = decode_check("tagging", model, emission, labels, lens,
                                  cfg["num_chunk_types"], seed)
    out.update(step_ms=ms, sequences_per_s=seqs, peak_gib=peak,
               launches=counts, eval_launches=eval_counts, losses=losses,
               eval=evaluation, profile=prof,
               busy_share_of_step=prof.get("busy_ms", 0.0) / ms)
    del model, opt
    torch.cuda.empty_cache()
    return counts, out


def lac_batch(rng):
    """LAC-shaped batches: word ids in [1, vocab), lengths in [len_lo,
    max_len], random IOB labels over 28 chunk types; on the current
    device."""
    import paddle_tpu_torch as P

    cfg = LAC
    b, s = cfg["batch"], cfg["max_len"]
    lens = rng.integers(cfg["len_lo"], s + 1, b)
    ids = rng.integers(1, cfg["vocab"], (b, s)) * (
        np.arange(s)[None] < lens[:, None])
    labels = iob_tags(rng, lens, s, cfg["num_chunk_types"])
    return [P.to_tensor(a) for a in (ids, lens, labels)]


def lac_model(seed, device, layers=None):
    _, BiGruCrfTagger = tagging_models()
    cfg = LAC
    return BiGruCrfTagger(cfg["vocab"], cfg["emb"], cfg["hidden"],
                          layers or cfg["layers"], cfg["num_tags"],
                          device=device,
                          generator=torch.Generator().manual_seed(seed))


def lac_grads(model, batch):
    ids, lens, labels = batch
    loss = model.loss(model(ids, lens), labels, lens)
    loss.backward()
    g = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    model.clear_gradients()
    return loss.detach(), g


def to_cpu(batch):
    return [t.cpu() for t in batch]


def lac_extras(seed, batch):
    """Ftrl, Dpsgd (sigma 0), DGCMomentum and ModelAverage (over SGD), 3
    steps each on a 1-layer copy: the card's eager optimizer against the
    CPU's functional one on the card's gradients; each parameter within
    TOL_TRAIN_GRAD_REL of the largest change the CPU made to it."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import optimizer as O

    makers = {
        "Ftrl": lambda ps: O.Ftrl(0.05, 0.01, 0.01, parameters=ps),
        "Dpsgd": lambda ps: O.Dpsgd(0.05, 1.0, LAC["batch"], 0.0,
                                    parameters=ps),
        "DGCMomentum": lambda ps: O.DGCMomentum(0.05, 0.9, ps, 0.99),
        "ModelAverage": lambda ps: O.SGD(0.1, parameters=ps),
    }
    out = {}
    for name, make in makers.items():
        model = lac_model(seed, DEV, layers=1)
        start = {k: p.detach().cpu().clone()
                 for k, p in model.named_parameters()}
        cpu = {k: v.clone() for k, v in start.items()}
        opt, ref = make(list(model.parameters())), make(None)
        avg = avg_ref = None
        if name == "ModelAverage":
            avg, avg_ref = O.ModelAverage(0.15, 2, 2), O.ModelAverage(
                0.15, 2, 2)
        with P.device_guard("cpu"):
            state = ref.init(cpu)
        for _ in range(LAC["extras_steps"]):
            ids, lens, labels = batch
            model.loss(model(ids, lens), labels, lens).backward()
            grads = {k: p.grad.detach().cpu()
                     for k, p in model.named_parameters()}
            opt.step()
            model.clear_gradients()
            with P.device_guard("cpu"):
                cpu, state = ref.update(grads, state, cpu)
            if avg is not None:
                got = avg.update({k: p.detach() for k, p in
                                  model.named_parameters()})
                want = avg_ref.update(cpu)
        if avg is not None:
            card, host = got, want
        else:
            card, host = dict(model.named_parameters()), cpu
        worst = max((max_abs(card[k].detach().cpu(), host[k])
                     / max(float((host[k] - start[k]).abs().max()), 1e-30),
                     k) for k in host)
        check(worst[0] <= TOL_TRAIN_GRAD_REL,
              f"rnn extras {name}: {LAC['extras_steps']} steps on the card "
              f"vs the CPU on the same gradients, worst err {worst[0]:.3g} "
              f"of the CPU's change ({worst[1]}) <= {TOL_TRAIN_GRAD_REL}")
        out[name] = worst[0]
        del model, opt
    return out


def lac_phase(seed):
    """LAC's BiGRU-CRF tagger at its published widths: the GRU on the card
    against the CPU, timed Lookahead(Adam) steps with an EMA, the EMA
    weights' eval decode, and the long-tail optimizers."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import optimizer as O

    cfg = LAC
    rng = np.random.default_rng(seed + 20)
    batch = lac_batch(rng)
    out = {"config": dict(cfg)}

    # the GRU's outputs, final states and every gradient, card vs CPU
    card = lac_model(seed, DEV)
    with P.device_guard("cpu"):
        host = lac_model(seed, "cpu")
        cb = to_cpu(batch)
        ids, lens = cb[0], cb[1]
        ref_out, ref_final = host.gru(host.word_emb(ids),
                                      sequence_length=lens)
        ref_loss, ref_g = lac_grads(host, cb)
    got_out, got_final = card.gru(card.word_emb(batch[0]),
                                  sequence_length=batch[1])
    errs = [max_abs(a.detach().cpu(), b.detach())
            / float(b.detach().abs().max())
            for a, b in ((got_out, ref_out), (got_final, ref_final))]
    check(max(errs) <= TOL_TRAIN_GRAD_REL,
          f"rnn: the BiGRU's outputs / final states on the card vs the CPU "
          f"(b{cfg['batch']}, lengths {cfg['len_lo']}-{cfg['max_len']}): "
          f"errs {errs[0]:.3g} / {errs[1]:.3g} of their max <= "
          f"{TOL_TRAIN_GRAD_REL}")
    loss, g = lac_grads(card, batch)
    log("[rnn] BiGRU-CRF fp32 loss and gradients, the card vs the CPU")
    steps_agree(loss, {k: v.cpu() for k, v in g.items()}, ref_loss, ref_g,
                "the CPU")
    out.update(gru_output_err=errs[0], gru_final_err=errs[1])
    del host, ref_g

    del card
    torch.cuda.empty_cache()

    # training: Lookahead(Adam), an EMA of the weights
    model = lac_model(seed, DEV)
    model.train()
    opt = O.Lookahead(O.Adam(cfg["lr"], parameters=model.parameters()),
                      cfg["lookahead_alpha"], cfg["lookahead_k"])
    ema = O.ExponentialMovingAverage(cfg["ema_decay"])
    batches = [batch, lac_batch(rng)]

    def step(b):
        ids, lens, labels = b
        loss = model.loss(model(ids, lens), labels, lens)
        loss.backward()
        opt.minimize(loss)
        opt.clear_grad()
        ema.update(dict(model.named_parameters()))
        return loss.detach()

    _, counts = count_one(step, batches[0])
    check(sum(counts.values()) == 0, f"rnn: a LAC step launches no port "
          f"kernel ({counts})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(cfg["steps"]):
        if i == cfg["warm"]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(step(batches[i % 2]))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (cfg["steps"] - cfg["warm"]) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = torch.stack(losses).tolist()
    check(all(np.isfinite(losses)), "rnn losses finite")
    prof = profile_split(lambda: step(batches[0]))
    words = int(sum(b[1].sum() for b in batches)) / 2
    log(f"[rnn] LAC BiGRU-CRF fp32 b{cfg['batch']} s{cfg['max_len']}: step "
        f"{ms:.2f} ms = {cfg['batch'] / ms * 1e3:.1f} sequences/s "
        f"({words / ms * 1e3:.0f} words/s), peak {peak:.2f} GiB, device "
        f"busy {prof.get('busy_ms', 0.0):.2f} ms of it (profiled); losses "
        f"{[round(x, 3) for x in losses]}; port kernel launches {counts}")

    # the eval decode on the EMA's weights
    ids, lens, labels = lac_batch(rng)
    shadow = ema.apply()
    saved = {k: p.detach().clone() for k, p in model.named_parameters()}
    model.eval()
    with P.no_grad():
        for k, p in model.named_parameters():
            p.copy_(shadow[k])
        emission = model(ids, lens)
        evaluation = decode_check("rnn", model, emission, labels, lens,
                                  cfg["num_chunk_types"], seed)
        for k, p in model.named_parameters():
            p.copy_(saved[k])
    del model, opt, ema, saved, shadow
    torch.cuda.empty_cache()
    extras = lac_extras(seed, batch)
    out.update(step_ms=ms, sequences_per_s=cfg["batch"] / ms * 1e3,
               words_per_s=words / ms * 1e3, peak_gib=peak, losses=losses,
               port_kernel_launches=counts, profile=prof, eval=evaluation,
               busy_share_of_step=prof.get("busy_ms", 0.0) / ms,
               extras_worst_err=extras)
    torch.cuda.empty_cache()
    return out


# -- phase 23: the data pipeline and the high-level API --------------------

# ERNIE-base fine-tuned for IMDB sentiment the Paddle 2.0 way: a
# ``DataLoader`` (2 spawned workers returning batches through shared memory,
# device prefetch) feeding ``hapi.Model.fit`` / ``evaluate`` / ``predict``
# / ``save`` / ``load``, on ``text.datasets.Imdb``'s synthetic corpus
# (maxlen 256, lengths 8-255, zero padding), with phase 18's recipe (b32,
# AdamW 2e-5, decay 0.01, warm-up into a linear decay, clip 1.0, fp32 with
# TF32 off, dropout 0.1).  ``check_batches`` train the kernel-vs-plain and
# fit-vs-hand-loop checks (dropout 0, no shuffle); ``stage_batches`` host
# batches go through the feeder while the main stream is busy.
HAPI = dict(batch=32, maxlen=256, train_size=512, test_size=256, epochs=2,
            workers=2, check_batches=4, stage_batches=48, busy_matmuls=24,
            busy_size=8192, loader_timeout=120)
# Launches of rows 1, 7 and 5 per evaluate / predict batch: the encoder's
# forward kernels and the embedding LayerNorm; no other kernel.
HAPI_EVAL_LAUNCHES = {"flash_attention_packed": 12, "residual_layer_norm": 24,
                      "layer_norm": 1}

_IMDB_CLASSIFIER = None
class SpawnProbe:
    """A dataset that serves ``dataset``'s items and, when a spawned
    worker unpickles it, writes into ``folder`` the wall times at which
    that worker reached this module's top, had imported numpy and torch,
    had run this module to its end and had unpickled its arguments (the
    port's imports among them).  Against the parent's time before it
    started the workers, they split a worker's start-up into the
    interpreter's start, torch, this module and the unpickling."""

    def __init__(self, dataset, folder):
        self.dataset, self.folder, self.parent = dataset, folder, os.getpid()

    def __setstate__(self, state):
        self.__dict__.update(state)
        if os.getpid() != self.parent:
            times = dict(top=_T_MODULE_TOP, torch=_T_TORCH,
                         module=_T_MODULE_END, unpickled=time.time())
            with open(os.path.join(self.folder, f"probe_{os.getpid()}.json"),
                      "w") as f:
                json.dump(times, f)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        return self.dataset[i]


def spawn_split(folder, t_start):
    """Each probed worker's start-up in seconds, split as SpawnProbe's
    docstring says, from the parent's wall time ``t_start``."""
    out = []
    for name in sorted(os.listdir(folder)):
        if name.startswith("probe_"):
            with open(os.path.join(folder, name)) as f:
                t = json.load(f)
            out.append(dict(interpreter=t["top"] - t_start,
                            torch=t["torch"] - t["top"],
                            module=t["module"] - t["torch"],
                            unpickle=t["unpickled"] - t["module"],
                            total=t["unpickled"] - t_start))
    return out


def imdb_classifier():
    """The user's model around ``ErnieForSequenceClassification``: it takes
    the token ids alone and builds token type 0 and the padding mask
    ``ids != 0`` (a port layer, built on the first call)."""
    global _IMDB_CLASSIFIER
    if _IMDB_CLASSIFIER is None:
        from paddle_tpu_torch import nn

        class ImdbClassifier(nn.Layer):
            def __init__(self, model):
                super().__init__()
                self.model = model

            def forward(self, ids):
                return self.model(ids, torch.zeros_like(ids),
                                  attention_mask=ids != 0)

        _IMDB_CLASSIFIER = ImdbClassifier
    return _IMDB_CLASSIFIER


def hapi_model(cfg, state, seed, optimizer=True):
    """A ``hapi.Model`` over the classifier with ``state`` put in, prepared
    with phase 18's optimizer, cross entropy and accuracy."""
    from paddle_tpu_torch import hapi, metric, nn

    net = imdb_classifier()(finetune_model(cfg, state, seed))
    model = hapi.Model(net)
    model.prepare(finetune_optimizer(net.parameters()) if optimizer else None,
                  nn.CrossEntropyLoss(), [metric.Accuracy()])
    return model


def _state_of(net):
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def prefetch_under_load(loader_batches, seed):
    """Stage host batches through ``DeviceFeeder`` while one stream is kept
    busy by a chain of large products: each staged batch's
    position-weighted checksum, taken on the main stream, equals the host
    batch's.  With the main stream busy, a staged batch whose memory the
    allocator handed out again before the consumer read it (no
    ``record_stream``) fails; with the feeder's copy stream busy and the
    main stream idle, a consumer that does not wait for the copies (no
    ``wait_event``) reads memory not yet written and fails."""
    from paddle_tpu_torch.io import DeviceFeeder

    b, s = loader_batches[0][0].shape
    host = [int((ids.astype(np.int64) * np.arange(1, s + 1)).sum()) * 3
            + int((labels.astype(np.int64) * np.arange(1, b + 1)).sum())
            for ids, labels in loader_batches]
    ws, wb = (torch.arange(1, n + 1, device=DEV) for n in (s, b))
    gen = torch.Generator(device=DEV).manual_seed(seed)
    n, k = HAPI["busy_size"], HAPI["busy_matmuls"]
    a = torch.randn(n, n, device=DEV, generator=gen) / n ** 0.5
    for busy in ("main", "copy"):
        feeder = DeviceFeeder(loader_batches, device=DEV, depth=2)
        stream = (torch.cuda.current_stream() if busy == "main" else
                  feeder._stager._stream(feeder._device))
        torch.cuda.synchronize()
        with torch.cuda.stream(stream):
            x = a
            for _ in range(k):                  # queued, not waited for
                x = torch.tanh(x @ a)
        got = []
        for ids, labels in feeder:
            got.append((ids.long() * ws).sum() * 3
                       + (labels.long() * wb).sum())
            del ids, labels
        torch.cuda.synchronize()
        busy_done = bool(torch.isfinite(x.sum()))
        got = [int(g) for g in got]
        wrong = sum(g != h for g, h in zip(got, host))
        check(len(got) == len(host) and not wrong and busy_done,
              f"hapi prefetch: {len(got)} batches staged while the {busy} "
              f"stream ran {k} {n}^2 products: every checksum equals the "
              f"host batch's ({wrong} differ)")
        del x
    del a


def fit_a_line(static, L, seed):
    main, startup = static.Program(), static.Program()
    main.random_seed = startup.random_seed = seed
    with static.program_guard(main, startup):
        x = L.data("x", [13])
        y = L.data("y", [1])
        loss = L.mean(L.square_error_cost(L.fc(x, 1), y))
        static.optimizer.SGD(0.01).minimize(loss)
    return main, startup, loss


def train_from_dataset_check(seed, tmp):
    """The book's fit_a_line on UCIHousing's rows, written to a multi-slot
    file and read through InMemoryDataset on the native feed:
    ``train_from_dataset(prefetch_to_device=True)``'s fetched losses equal
    ``Executor.run``'s over the same batches from the same state."""
    import paddle_tpu_torch.static as static
    from paddle_tpu_torch.core import native
    from paddle_tpu_torch.io import InMemoryDataset
    from paddle_tpu_torch.static import layers as L
    from paddle_tpu_torch.text import UCIHousing

    housing = UCIHousing(mode="train")
    path = os.path.join(tmp, "housing.txt")
    with open(path, "w") as f:
        for i in range(len(housing)):
            xs, y = housing[i]
            f.write(",".join(repr(float(v)) for v in xs) + ";"
                    + repr(float(y[0])) + "\n")

    def dataset():
        ds = InMemoryDataset()
        ds.set_use_var([("x", "float32", 13), ("y", "float32", 1)])
        ds.set_batch_size(32)
        ds.set_filelist([path])
        ds.load_into_memory()
        ds.local_shuffle(seed)
        return ds

    main, startup, loss = fit_a_line(static, L, seed)
    exe = static.Executor()
    scope = static.Scope()
    exe.run(startup, scope=scope)
    init = {k: scope.find_var(k).clone() for k in scope.keys()}
    ds = dataset()
    check(isinstance(ds._feed, native.NativeDataFeed),
          "hapi train_from_dataset: InMemoryDataset runs on the native feed")
    losses = []
    run = exe.run

    def recording(*args, **kwargs):
        out = run(*args, **kwargs)
        losses.append(out[0].copy())
        return out

    exe.run = recording
    last = exe.train_from_dataset(main, ds, scope=scope, fetch_list=[loss],
                                  prefetch_to_device=True)
    del exe.run
    ref_scope = static.Scope()
    for k, v in init.items():
        ref_scope.set(k, v.clone())
    ref = [exe.run(main, feed=b, fetch_list=[loss], scope=ref_scope)[0]
           for b in dataset()]
    same = len(ref) == len(losses) and all(
        np.array_equal(a, b) for a, b in zip(losses, ref))
    check(same and np.array_equal(last[0], ref[-1])
          and all(np.isfinite(ref)),
          f"hapi train_from_dataset: {len(losses)} fetched losses "
          f"({float(losses[0]):.4f} -> {float(losses[-1]):.4f}) equal "
          f"Executor.run's over the same {len(ref)} batches bit for bit")
    return dict(batches=len(ref), first_loss=float(ref[0]),
                last_loss=float(ref[-1]))


def hapi_phase(seed):
    """Phase 23: ERNIE-base IMDB fine-tuning through DataLoader and
    hapi.Model (module docstring)."""
    import tempfile

    from paddle_tpu_torch import hapi, io
    from paddle_tpu_torch.core import native
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.text import Imdb
    from paddle_tpu_torch.utils import monitor

    cfg = HAPI
    out = {"config": dict(cfg)}
    t0 = time.perf_counter()
    ok = native.available()
    check(ok, f"hapi: the native host runtime loads ({native.build_error()})"
          f", built from native/src in {native.build_seconds():.2f} s")
    out["native_build_s"] = native.build_seconds()
    log(f"[hapi] native runtime {native.library_path()} built in "
        f"{native.build_seconds():.2f} s")

    train = Imdb(mode="train", synthetic_size=cfg["train_size"],
                 maxlen=cfg["maxlen"])
    test = Imdb(mode="test", synthetic_size=cfg["test_size"],
                maxlen=cfg["maxlen"])
    lens = (np.stack(train.docs) != 0).sum(1)
    check(lens.min() >= 8 and lens.max() <= cfg["maxlen"] - 1,
          f"hapi: IMDB lengths {lens.min()}-{lens.max()} of "
          f"{cfg['maxlen']}, zero padded")
    base = ernie_cfg()
    quiet = ernie_cfg(hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    state = finetune_state(base, seed)
    tmp = tempfile.mkdtemp(prefix="hapi_phase_")
    try:
        # -- the kernels against their plain versions, fit against the book
        # loop: the same check_batches from the same weights, dropout 0
        nb = cfg["check_batches"]
        head = io.Subset(train, list(range(nb * cfg["batch"])))

        class StepLog(hapi.callbacks.Callback):
            """Each fit step's loss (a device read a step)."""

            def __init__(self):
                super().__init__()
                self.losses = []

            def on_train_batch_end(self, step, logs=None):
                self.losses.append(logs["loss"])

        def check_fit(plain):
            """fit over ``head``: its losses, its first step's gradients
            (taken as the optimizer is handed them) and its parameters."""
            model = hapi_model(quiet, state, seed)
            log_cb = StepLog()
            opt, grads = model._optimizer, {}
            minimize = opt.minimize

            def first_grads(loss, *args, **kwargs):
                if not grads:
                    grads.update((k, p.grad.detach().clone()) for k, p in
                                 model.network.named_parameters())
                return minimize(loss, *args, **kwargs)

            opt.minimize = first_grads
            ctx = plain_wrappers() if plain else contextlib.nullcontext()
            with deterministic(), ctx:
                model.fit(io.DataLoader(head, batch_size=cfg["batch"]),
                          epochs=1, shuffle=False, verbose=0,
                          callbacks=[log_cb])
            del opt.minimize
            return model, log_cb.losses, grads

        kmodel, klosses, kgrads = check_fit(False)
        kstate = _state_of(kmodel.network)
        pmodel, plosses, pgrads = check_fit(True)
        del pmodel
        worst = max(abs(a - b) / abs(b) for a, b in zip(klosses, plosses))
        check(len(klosses) == nb and worst <= TOL_TRAIN_LOSS_REL,
              f"hapi fit, fp32 ERNIE-base b{cfg['batch']} s{cfg['maxlen']} "
              f"dropout 0, kernels vs plain wrappers: {nb} losses, worst "
              f"rel err {worst:.3g} <= {TOL_TRAIN_LOSS_REL}")
        steps_agree(torch.tensor(klosses[0]), kgrads,
                    torch.tensor(plosses[0]), pgrads,
                    "plain wrappers, hapi fit's first step")
        del kgrads, pgrads
        torch.cuda.empty_cache()

        net = imdb_classifier()(finetune_model(quiet, state, seed))
        net.train()
        opt = finetune_optimizer(net.parameters())
        loss_fn = kmodel._loss
        hand = []
        with deterministic():
            for ids, labels in io.DataLoader(head, batch_size=cfg["batch"]):
                ids = torch.from_numpy(ids).to(DEV)
                labels = torch.from_numpy(labels).to(DEV)
                loss = loss_fn(net(ids), labels)
                loss.backward()
                opt.minimize(loss)
                net.clear_gradients()
                hand.append(float(loss))
        hstate = _state_of(net)
        d = max(max_abs(kstate[k], hstate[k]) for k in kstate)
        check(d == 0.0 and hand == klosses,
              f"hapi: Model.fit and the book loop (loss.backward(); "
              f"opt.minimize(loss); clear_gradients()) on the same "
              f"{nb} batches: losses and parameters bit for bit (largest "
              f"difference {d})")
        out["check"] = dict(losses=klosses, plain_losses=plosses,
                            loss_rel_err=worst)
        del kmodel, net, opt, kstate, hstate
        torch.cuda.empty_cache()

        # -- the prefetch under load, on the loader's own host batches
        host_batches = list(io.DataLoader(
            train, batch_size=cfg["batch"], shuffle=True))
        prefetch_under_load(
            (host_batches * 4)[:cfg["stage_batches"]], seed)

        # -- fit at full width: 2 spawned workers, shared memory, device
        # prefetch; the batch sampler records each epoch's batches
        class Recording(io.BatchSampler):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                self.epochs = []

            def __iter__(self):
                self.epochs.append([])
                for b in super().__iter__():
                    self.epochs[-1].append(list(b))
                    yield b

        class Timer(hapi.callbacks.Callback):
            """Epoch 2's step ms from its first step's start to its end,
            its wait for the first batch, and io.prefetch_depth at each
            step's start."""

            def __init__(self):
                super().__init__()
                self.depth, self.t, self.epoch = [], {}, 0

            def on_epoch_begin(self, epoch, logs=None):
                torch.cuda.synchronize()
                self.epoch = epoch
                self.t[("begin", epoch)] = time.perf_counter()

            def on_train_batch_begin(self, step, logs=None):
                self.depth.append(monitor.gauge("io.prefetch_depth").value())
                if step == 0:
                    torch.cuda.synchronize()
                    self.t[("first", self.epoch)] = time.perf_counter()

            def on_epoch_end(self, epoch, logs=None):
                torch.cuda.synchronize()
                self.t[("end", epoch)] = time.perf_counter()

        np.random.seed(seed)
        sampler = Recording(train, shuffle=True, batch_size=cfg["batch"])
        loader = io.DataLoader(train, batch_sampler=sampler,
                               num_workers=cfg["workers"],
                               use_shared_memory=True, prefetch_to_device=True,
                               timeout=cfg["loader_timeout"])
        model = hapi_model(base, state, seed)
        timer = Timer()
        steps = len(loader)
        early = hapi.callbacks.EarlyStopping(monitor="acc", patience=2,
                                             verbose=0)
        logger = hapi.callbacks.MetricsLogger()
        sched = model._optimizer._lr
        sched_at, steps_at = sched.last_epoch, logger._steps.value()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        config.reset_counts()
        t_fit = time.perf_counter()
        model.fit(loader, epochs=cfg["epochs"], verbose=0,
                  callbacks=[hapi.callbacks.LRSchedulerCallback(by_step=True),
                             early, logger, timer])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t_fit
        counts = config.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_steps = steps * cfg["epochs"]
        check_counts("hapi fit", {k: v / n_steps for k, v in counts.items()},
                     FINETUNE_LAUNCHES, only=True)
        e = cfg["epochs"] - 1
        step_ms = (timer.t[("end", e)] - timer.t[("first", e)]) / steps * 1e3
        first_wait = timer.t[("first", e)] - timer.t[("begin", e)]
        depth = timer.depth[steps:]
        mean_depth = float(np.mean(depth))
        stepped = sched.last_epoch - sched_at
        logged = logger._steps.value() - steps_at
        check(stepped == n_steps + cfg["epochs"] and logged == n_steps,
              f"hapi fit: LRSchedulerCallback(by_step=True) stepped the "
              f"schedule {stepped} times in {n_steps} steps and "
              f"{cfg['epochs']} epochs; MetricsLogger counted {logged} "
              f"steps; EarlyStopping best acc {early.best}")

        # the book loop on epoch 2's batches, the same model, same run
        batches = [tuple(torch.from_numpy(a).to(DEV) for a in
                         io.default_collate_fn([train[i] for i in idx]))
                   for idx in sampler.epochs[e]]
        net, opt, loss_fn = model.network, model._optimizer, model._loss

        def hand_step(ids, labels):
            loss = loss_fn(net(ids), labels)
            loss.backward()
            opt.minimize(loss)
            net.clear_gradients()
            return loss.detach()

        torch.cuda.synchronize()
        th = time.perf_counter()
        hand_losses = [hand_step(*b) for b in batches]
        torch.cuda.synchronize()
        hand_ms = (time.perf_counter() - th) / len(batches) * 1e3
        check(all(np.isfinite(torch.stack(hand_losses).tolist())),
              "hapi book loop losses finite")
        seqs = cfg["batch"] / step_ms * 1e3

        two = io.DataLoader(io.Subset(train, list(range(2 * cfg["batch"]))),
                            batch_size=cfg["batch"], prefetch_to_device=True)
        prof = profile_split(lambda: model.fit(two, verbose=0, shuffle=False),
                             steps=1)
        busy_share = prof["busy_ms"] / prof["wall_ms"]

        # the loader alone: a fresh epoch, spawn included (its workers'
        # start-up split by SpawnProbe), then steady
        probe_dir = os.path.join(tmp, "spawn")
        os.mkdir(probe_dir)
        alone = io.DataLoader(SpawnProbe(train, probe_dir),
                              batch_size=cfg["batch"], shuffle=True,
                              num_workers=cfg["workers"],
                              use_shared_memory=True, prefetch_to_device=True,
                              timeout=cfg["loader_timeout"])
        t_spawn = time.time()
        tl = time.perf_counter()
        it = iter(alone)
        next(it)
        t_first = time.perf_counter()
        rest = sum(1 for _ in it)
        torch.cuda.synchronize()
        loader_bps = rest / (time.perf_counter() - t_first)
        loader_first_s = t_first - tl
        spawn = spawn_split(probe_dir, t_spawn)
        check(len(spawn) == cfg["workers"], f"hapi loader: the start-up "
              f"of its {len(spawn)} spawned workers, s: " + "; ".join(
                  ", ".join(f"{k} {v:.2f}" for k, v in w.items())
                  for w in spawn))

        # evaluate and predict: launches per batch, finite answers, wall
        n_eval = -(-cfg["test_size"] // cfg["batch"])
        ev, ev_counts = count_one(lambda: model.evaluate(
            test, batch_size=cfg["batch"], verbose=0))
        check_counts("hapi evaluate", {k: v / n_eval for k, v in
                                       ev_counts.items()}, HAPI_EVAL_LAUNCHES,
                     only=True)
        check(np.isfinite(ev["loss"]) and 0.0 <= ev["acc"] <= 1.0,
              f"hapi evaluate: loss {ev['loss']:.4f}, acc {ev['acc']:.4f}")
        torch.cuda.synchronize()
        tp = time.perf_counter()
        (preds,), pr_counts = count_one(lambda: model.predict(
            test, batch_size=cfg["batch"]))
        predict_s = time.perf_counter() - tp
        check_counts("hapi predict", {k: v / n_eval for k, v in
                                      pr_counts.items()}, HAPI_EVAL_LAUNCHES,
                     only=True)
        check(preds.shape == (cfg["test_size"], 2)
              and bool(np.isfinite(preds).all()),
              f"hapi predict: {preds.shape} finite logits in "
              f"{predict_s * 1e3:.1f} ms")

        # save / load: parameters and the optimizer state bit for bit
        path = os.path.join(tmp, "imdb")
        ts = time.perf_counter()
        model.save(path)
        save_s = time.perf_counter() - ts
        fresh = hapi_model(base, state, seed)
        fresh.load(path)
        d = max(max_abs(a, b) for a, b in zip(
            model.network.state_dict().values(),
            fresh.network.state_dict().values()))
        s0, s1 = model._optimizer._state, fresh._optimizer._state
        od = max(max_abs(a, b) for k, slots in s0["per_param"].items()
                 for a, b in zip(slots, s1["per_param"][k]))
        check(d == 0.0 and od == 0.0 and s1["step"] == s0["step"]
              and fresh._optimizer._step_count == s0["step"],
              f"hapi save / load: {len(model.network.state_dict())} "
              f"parameters and {len(s0['per_param'])} AdamW slot pairs "
              f"bit for bit, step {s1['step']} (save {save_s:.2f} s)")
        del fresh
        tfd = train_from_dataset_check(seed, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    phase_s = time.perf_counter() - t0
    log(f"[hapi] ERNIE-base IMDB fit fp32 b{cfg['batch']} s{cfg['maxlen']}, "
        f"{cfg['workers']} spawned workers, device prefetch: epoch 2 step "
        f"{step_ms:.2f} ms = {seqs:.1f} sequences/s (first batch after "
        f"{first_wait * 1e3:.1f} ms), book loop on the same batches "
        f"{hand_ms:.2f} ms: overhead ratio {step_ms / hand_ms:.3f}; mean "
        f"io.prefetch_depth {mean_depth:.2f}; peak {peak:.2f} GiB; busy share "
        f"{busy_share:.3f}; loader alone {loader_bps:.1f} batches/s (first "
        f"batch {loader_first_s:.2f} s); predict {cfg['test_size']} "
        f"samples {predict_s * 1e3:.1f} ms; evaluate {ev}; fit {fit_s:.2f} "
        f"s; phase {phase_s:.1f} s")
    out.update(step_ms=step_ms, sequences_per_s=seqs, hand_step_ms=hand_ms,
               overhead_ratio=step_ms / hand_ms, first_batch_wait_ms=
               first_wait * 1e3, mean_prefetch_depth=mean_depth,
               prefetch_depths=depth, peak_gib=peak, busy_share=busy_share,
               profile=prof, loader_batches_per_s=loader_bps,
               loader_first_batch_s=loader_first_s, spawn_split=spawn,
               predict_ms=predict_s * 1e3,
               evaluate=ev, save_s=save_s, fit_s=fit_s, launches=counts,
               steps=n_steps, per_step_launches={k: v / n_steps for k, v in
                                                 counts.items()},
               eval_launches=ev_counts, predict_launches=pr_counts,
               train_from_dataset=tfd, phase_s=phase_s)
    del model
    torch.cuda.empty_cache()
    per = {"fit": (counts, n_steps), "evaluate": (ev_counts, n_eval),
           "predict": (pr_counts, n_eval)}
    return {path: {k: v // n for k, v in c.items()}
            for path, (c, n) in per.items()}, out


# -- phases 21-22: bench_vision's ResNet-50 and YOLOv3-DarkNet53 training ----

# bench_vision.py's two training recipes at their full widths: PaddleClas's
# ResNet-50 (b256, 224 x 224, NHWC, Momentum lr 0.1 / 0.9) and
# PaddleDetection's YOLOv3-DarkNet53 (b64, 416 x 416, 80 classes, 16 gt
# boxes an image, Momentum lr 1e-4 / 0.9), bf16 compute over fp32
# parameters; the card-against-CPU checks at fp32 at b4 / 224 and at
# bench_vision's CPU size (b2, 128).  Forward FLOPs an image as
# bench_vision counts them (2 x MACs); a training step is 3 x forward.
RESNET = dict(batch=256, size=224, classes=1000, lr=0.1, momentum=0.9,
              check_batch=4, steps=7, warm=2, fwd_flops=4.09e9, convs=53)
YOLO = dict(batch=64, size=416, classes=80, n_gt=16, lr=1e-4, momentum=0.9,
            check_batch=2, check_size=128, steps=7, warm=2,
            fwd_flops=65.86e9, keep_top_k=100)
# Train-mode BatchNorm at random initialization makes a deep network's
# step chaotic (tests/test_torch_vision_models.py): scaling the input by
# 1 + 1e-6 moves ResNet-50's per-tensor gradients by ~30%, and even in
# eval mode ReLU decisions near zero move its layer4 gradients by 2e-3 of
# their size at b4 224.  Each step is held against the CPU's within
# VISION_CHAOS times the distance the CPU's own step moves under that
# perturbation, where that is more than TOL_TRAIN_*; an eval-mode gradient
# below VISION_FLOOR of the largest is held relative to that floor
# (vision_card_vs_cpu).
VISION_PERTURB, VISION_CHAOS, VISION_FLOOR = 1e-6, 10.0, 1e-2
# cuDNN / cuBLAS kernels in a profile: convolutions (forward, data and
# weight gradients) and matrix products
CONV_KERNEL = re.compile(r"conv|xmma|implicit|gemm|cutlass|nvjet|cudnn|"
                         r"wgrad|dgrad|fprop|sm90_", re.I)
# cuDNN's own layout conversions
LAYOUT_KERNEL = re.compile(r"nchwToNhwc|nhwcToNchw|nchw2nhwc|nhwc2nchw|"
                           r"transpose", re.I)


def vision_train_step(model, loss_of, opt, compute_dtype):
    """bench_vision's ``train_step``: the floating parameters (fp32
    masters) cast to ``compute_dtype`` and bound with
    ``torch.func.functional_call``, ``loss_of(outputs, *rest)``, the
    gradients with respect to the masters, ``opt.update``.  Returns
    ``step(params, state, images, *rest) -> (params, state, loss)``."""

    def step(params, state, images, *rest):
        names = list(params)
        leaves = {k: params[k].detach().requires_grad_(True) for k in names}
        cast = {k: v.to(compute_dtype) for k, v in leaves.items()}
        out = torch.func.functional_call(model, cast, (images,))
        loss = loss_of(out, *rest)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        params, state = opt.update(dict(zip(names, grads)), state, params)
        return params, state, loss.detach()

    return step


def vision_grads(model, loss_of, images, *rest):
    """One fp32 step's loss, gradients and buffers after it (the model's
    own parameters; BatchNorm in the model's mode)."""
    loss = loss_of(model(images), *rest)
    loss.backward()
    grads = {k: p.grad.detach().cpu().clone()
             for k, p in model.named_parameters()}
    model.clear_gradients()
    bufs = {k: b.detach().cpu().clone() for k, b in model.named_buffers()}
    return {"loss": loss.detach().cpu()}, grads, bufs


def _l2(a, b):
    d = sum(float(((a[k].float() - b[k].float()) ** 2).sum()) for k in b)
    n = sum(float((b[k].float() ** 2).sum()) for k in b)
    return (d / max(n, 1e-300)) ** 0.5


def vision_card_vs_cpu(tag, make, loss_of, images, *rest):
    """``make(device)`` builds the model (one seed, one set of weights) on
    the card and on the CPU; one fp32 step each in eval mode (BatchNorm
    on its running statistics) and in train mode (batch statistics),
    each against the CPU's step, with the CPU's own move under an input
    scaled by 1 + VISION_PERTURB as the measure of how well the step is
    conditioned.  Eval mode: the loss within TOL_TRAIN_LOSS_REL and each
    gradient within TOL_TRAIN_GRAD_REL of its largest value (floored at
    VISION_FLOOR of the largest gradient of all: a BatchNorm bias's
    gradient sums thousands of terms of both signs, which the card and
    the CPU add in their own orders), or within VISION_CHAOS times its
    own move (ReLU decisions near zero flip: at b4 224 the move reaches
    2e-3 of ResNet-50's layer4 gradients).  Train mode: the
    loss, all gradients and all running statistics after the step, each
    as one vector, within max(TOL_TRAIN_LOSS_REL, VISION_CHAOS times the
    move).  Returns the errors."""
    import paddle_tpu_torch as P

    card = make(DEV)
    out = {}
    with P.device_guard("cpu"):
        host = make("cpu")
        cpu_in = [t.cpu() for t in (images,) + rest]
        for train in (False, True):
            mode = "train" if train else "eval"
            for m in (card, host):
                m.train() if train else m.eval()
            start = {k: b.clone() for k, b in host.named_buffers()}
            moved = vision_grads(host, loss_of,
                                 cpu_in[0] * (1 + VISION_PERTURB),
                                 *cpu_in[1:])
            for k, b in host.named_buffers():
                b.copy_(start[k])
            ref = vision_grads(host, loss_of, *cpu_in)
            got = vision_grads(card, loss_of, images, *rest)
            if train:
                for i, what in enumerate(("loss", "gradients",
                                          "statistics")):
                    err = _l2(got[i], ref[i])
                    allowed = max(TOL_TRAIN_LOSS_REL,
                                  VISION_CHAOS * _l2(moved[i], ref[i]))
                    check(err <= allowed, f"{tag}: fp32 {mode}-mode step's "
                          f"{what} ({len(ref[i])} tensors), the card vs the "
                          f"CPU: rel L2 err {err:.3g} <= {allowed:.3g} (max "
                          f"of {TOL_TRAIN_LOSS_REL} and {VISION_CHAOS:g} x "
                          f"the CPU's move under x (1 + "
                          f"{VISION_PERTURB:g}))")
                    out[f"{mode}_{what}_rel_l2"] = err
                    out[f"{mode}_{what}_allowed"] = allowed
                continue
            loss, ref_loss = float(got[0]["loss"]), float(ref[0]["loss"])
            err = abs(loss - ref_loss)
            allowed = max(TOL_TRAIN_LOSS_REL * abs(ref_loss), VISION_CHAOS
                          * abs(float(moved[0]["loss"]) - ref_loss))
            check(err <= allowed, f"{tag}: fp32 {mode}-mode loss {loss:.6f} "
                  f"on the card, {ref_loss:.6f} on the CPU: err {err:.3g} <= "
                  f"{allowed:.3g}")
            top = max(float(g.abs().max()) for g in ref[1].values())
            worst, beyond, failed = (0.0, ""), 0, []
            for k, g in ref[1].items():
                scale = max(float(g.abs().max()), VISION_FLOOR * top)
                e = max_abs(got[1][k], g)
                worst = max(worst, (e / scale, k))
                beyond += e > TOL_TRAIN_GRAD_REL * scale
                if e > max(TOL_TRAIN_GRAD_REL * scale,
                           VISION_CHAOS * max_abs(moved[1][k], g)):
                    failed.append(k)
            check(not failed, f"{tag}: fp32 {mode}-mode step, the card vs "
                  f"the CPU: {len(ref[1])} gradients (the largest "
                  f"{top:.3g}), worst {worst[0]:.3g} of the gradient's max "
                  f"floored at {VISION_FLOOR:g} of the largest "
                  f"({worst[1]}), {beyond} beyond {TOL_TRAIN_GRAD_REL} of "
                  f"it, each within {VISION_CHAOS:g} x its move under x (1 "
                  f"+ {VISION_PERTURB:g}) (beyond that: {failed})")
            out.update(eval_loss_err=err, eval_grad_worst=worst[0],
                       eval_grads_beyond_tol=beyond)
    del card, host
    return out


def vision_profile(run, update, steps=2):
    """``profile_split`` of ``steps`` training steps by kind: convolutions
    and products (cuDNN / cuBLAS), cuDNN's layout conversions, the
    optimizer (the device time of ``update`` alone, profiled apart), and
    BatchNorm / elementwise (the rest of the step); the busy share, and
    the layout conversions a step launches."""
    from torch.profiler import ProfilerActivity, profile

    def device(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / steps
        return [(us / 1e3 / steps, count / steps, name)
                for us, count, name in device_events(prof)], wall

    kernels, wall = device(run)
    opt_kernels, _ = device(update)
    busy = sum(ms for ms, _, _ in kernels)
    layout_ms = sum(ms for ms, _, name in kernels
                    if LAYOUT_KERNEL.search(name))
    layout = sum(c for _, c, name in kernels if LAYOUT_KERNEL.search(name))
    conv = sum(ms for ms, _, name in kernels if CONV_KERNEL.search(name)
               and not LAYOUT_KERNEL.search(name))
    opt_ms = sum(ms for ms, _, _ in opt_kernels)
    port = sum(ms for ms, _, name in kernels if PORT_KERNEL.search(name))
    kinds = {"convolutions and products": conv,
             "layout conversions": layout_ms, "optimizer": opt_ms,
             "BatchNorm / elementwise": busy - conv - layout_ms - opt_ms}
    log(f"[profile] per step: device busy {busy:.2f} ms of {wall:.2f} ms "
        f"wall (busy share {busy / wall:.3f}); "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in kinds.items())
        + f"; layout conversions {layout:g} launches; port kernels "
        f"{port:.3f} ms")
    for ms, count, name in sorted(kernels, reverse=True)[:12]:
        log(f"  {ms:8.3f} ms  x{count:<6g} {name[:100]}")
    return dict(busy_ms=busy, wall_ms=wall, busy_share=busy / wall,
                kinds=kinds, layout_launches=layout, port_ms=port)


def zoo_forwards(seed):
    """LeNet, VGG-11 with BatchNorm and MobileNet V1 / V2 (eval, b4): the
    card's logits against the CPU's on the same weights."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.vision import models as M

    rng = np.random.default_rng(seed + 21)
    s = RESNET["size"]
    makers = {"lenet": (lambda d, g: M.LeNet(device=d, generator=g), 1, 28),
              "vgg11_bn": (lambda d, g: M.vgg11(batch_norm=True, device=d,
                                                generator=g), 3, s),
              "mobilenet_v1": (lambda d, g: M.mobilenet_v1(
                  device=d, generator=g), 3, s),
              "mobilenet_v2": (lambda d, g: M.mobilenet_v2(
                  device=d, generator=g), 3, s)}
    errs = {}
    for name, (make, ch, size) in makers.items():
        x = torch.from_numpy(rng.standard_normal(
            (RESNET["check_batch"], ch, size, size)).astype(np.float32))
        card = make(DEV, torch.Generator().manual_seed(seed)).eval()
        with P.device_guard("cpu"), torch.no_grad():
            ref = make("cpu", torch.Generator().manual_seed(seed)).eval()(x)
        with torch.no_grad():
            got = card(x.to(DEV)).cpu()
        errs[name] = rel_err(got, ref)
        check(errs[name] <= TOL_TRAIN_GRAD_REL, f"resnet zoo: {name} eval "
              f"logits {tuple(got.shape)} on the card vs the CPU, rel err "
              f"{errs[name]:.3g} <= {TOL_TRAIN_GRAD_REL}")
        del card
    return errs


def resnet_phase(seed):
    """bench_vision's ResNet-50 training (PaddleClas's configuration) on
    the card; see the module docstring, phase 21."""
    import paddle_tpu_torch as P
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import models as M

    cfg = RESNET
    rng = np.random.default_rng(seed + 21)
    out = {"config": dict(cfg)}

    def make(dev, fmt="NHWC"):
        return M.resnet50(num_classes=cfg["classes"], data_format=fmt,
                          device=dev,
                          generator=torch.Generator().manual_seed(seed))

    def ce(logits, labels):
        return P.mean(F.cross_entropy(logits.float(), labels))

    b, s = cfg["check_batch"], cfg["size"]
    x = torch.from_numpy(rng.standard_normal((b, s, s, 3)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, cfg["classes"], (b, 1)))
    card = make(DEV).eval()
    with P.device_guard("cpu"), torch.no_grad():
        ref = make("cpu").eval()(x)
    with torch.no_grad():
        got = card(x.to(DEV))
    out["eval_logits_rel_err"] = rel_err(got.cpu(), ref)
    check(out["eval_logits_rel_err"] <= TOL_TRAIN_GRAD_REL,
          f"resnet: fp32 b{b} {s}x{s} NHWC eval logits on the card vs the "
          f"CPU, rel err {out['eval_logits_rel_err']:.3g} <= "
          f"{TOL_TRAIN_GRAD_REL}")
    nchw = make(DEV, "NCHW").eval()
    nchw.set_state_dict(card.state_dict())
    with torch.no_grad():
        got_nchw = nchw(x.to(DEV).permute(0, 3, 1, 2).contiguous())
    out["nchw_vs_nhwc_rel_err"] = rel_err(got_nchw, got)
    check(out["nchw_vs_nhwc_rel_err"] <= TOL_TRAIN_GRAD_REL,
          f"resnet: the NCHW model on the NHWC model's weights, its logits "
          f"rel err {out['nchw_vs_nhwc_rel_err']:.3g} <= "
          f"{TOL_TRAIN_GRAD_REL}")
    del card, nchw, got, got_nchw
    out.update(vision_card_vs_cpu("resnet", make, ce, x.to(DEV), y.to(DEV)))
    out["zoo_logits_rel_err"] = zoo_forwards(seed)
    torch.cuda.empty_cache()

    # full width: bf16 compute over fp32 parameters, Momentum
    model = make(DEV).train()
    opt = Momentum(learning_rate=cfg["lr"], momentum=cfg["momentum"])
    params = convert.parameters_dict(model)
    state = opt.init(params)
    step = vision_train_step(model, ce, opt, torch.bfloat16)
    b = cfg["batch"]
    images = torch.from_numpy(rng.standard_normal((b, s, s, 3)).astype(
        np.float32)).to(DEV, torch.bfloat16)
    labels = torch.from_numpy(rng.integers(0, cfg["classes"], (b, 1))).to(
        DEV)
    (params, state, _), counts = count_one(step, params, state, images,
                                           labels)
    check(sum(counts.values()) == 0, f"resnet: a ResNet-50 step launches no "
          f"port kernel ({counts})")
    params, state, ms, peak, losses = timed_steps(
        lambda p, st, batch, _: step(p, st, *batch), params, state,
        (images, labels), None, cfg["steps"], cfg["warm"])
    check(all(np.isfinite(losses)), f"resnet losses finite {losses}")
    grads = {k: torch.zeros_like(v) for k, v in params.items()}

    def run():
        nonlocal params, state
        params, state, _ = step(params, state, images, labels)

    prof = vision_profile(run, lambda: opt.update(grads, state, params))
    check(prof["layout_launches"] < cfg["convs"], f"resnet: "
          f"{prof['layout_launches']:g} layout conversions a step, fewer "
          f"than one a convolution ({cfg['convs']}): no per-layer copy")
    ips = b / ms * 1e3
    mfu = 3 * cfg["fwd_flops"] * ips / PEAK_FLOPS[torch.bfloat16]
    log(f"[resnet] ResNet-50 NHWC bf16 b{b} {s}x{s} Momentum: step "
        f"{ms:.2f} ms = {ips:.1f} images/s, MFU {mfu:.4f}, peak "
        f"{peak:.2f} GiB, busy share {prof['busy_share']:.3f}; losses "
        f"{[round(v, 4) for v in losses]}; port kernel launches {counts}")
    out.update(step_ms=ms, images_per_s=ips, mfu=mfu, peak_gib=peak,
               losses=losses, port_kernel_launches=counts, profile=prof,
               busy_share=prof["busy_share"])
    del model, opt, params, state, grads, images
    torch.cuda.empty_cache()
    return out


def yolo_batch(rng, b, size):
    """Images and bench_vision's gt boxes: normalized (cx, cy, w, h), w and
    h in 0.05-0.4, centres in 0.2-0.8, labels in [0, 80)."""
    cfg = YOLO
    images = rng.standard_normal((b, 3, size, size)).astype(np.float32)
    wh = rng.uniform(0.05, 0.4, (b, cfg["n_gt"], 2))
    cxy = rng.uniform(0.2, 0.8, (b, cfg["n_gt"], 2))
    box = np.concatenate([cxy, wh], -1).astype(np.float32)
    label = rng.integers(0, cfg["classes"], (b, cfg["n_gt"])).astype(
        np.int32)
    return [torch.from_numpy(a) for a in (images, box, label)]


def yolo_predict_check(model, heads, size):
    """``predict`` on the CPU's heads, on the card and on the CPU: equal
    counts, labels and scores on the rows whose scores are distinct (1e-6
    apart) from their neighbours', boxes within 1e-4 of the largest."""
    import paddle_tpu_torch as P

    b = heads[0].shape[0]
    img = torch.tensor([[size, size]] * b, dtype=torch.int32)
    with torch.no_grad():
        dets, num = model.predict([h.to(DEV) for h in heads], img.to(DEV),
                                  keep_top_k=YOLO["keep_top_k"])
        with P.device_guard("cpu"):
            rd, rn = model.predict(heads, img, keep_top_k=YOLO["keep_top_k"])
    dets, num = dets.cpu(), num.cpu()
    check(torch.equal(num, rn) and num.dtype == torch.int32,
          f"yolo predict: num_valid {num.tolist()} on the card, "
          f"{rn.tolist()} on the CPU")
    s = rd[..., 1]
    gap = torch.full_like(s, float("inf"))
    gap[:, 1:] = torch.minimum(gap[:, 1:], (s[:, :-1] - s[:, 1:]).abs())
    gap[:, :-1] = torch.minimum(gap[:, :-1], (s[:, :-1] - s[:, 1:]).abs())
    rows = gap > 1e-6
    same = torch.equal(dets[..., 0][rows], rd[..., 0][rows])
    serr = float((dets[..., 1] - s)[rows].abs().max())
    berr = rel_err(dets[..., 2:][rows], rd[..., 2:][rows])
    check(same and serr <= 1e-6 and berr <= 1e-4,
          f"yolo predict: {int(rows.sum())} of {rows.numel()} rows with "
          f"distinct scores: labels equal, scores within {serr:.3g}, boxes "
          f"rel err {berr:.3g} <= 1e-4")
    return dict(num_valid=num.tolist(), distinct_rows=int(rows.sum()),
                score_err=serr, box_rel_err=berr)


def yolo_phase(seed):
    """bench_vision's YOLOv3-DarkNet53 training (PaddleDetection's
    configuration) and one b64 prediction on the card; see the module
    docstring, phase 22."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import models as M

    cfg = YOLO
    rng = np.random.default_rng(seed + 22)
    out = {"config": dict(cfg)}

    def make(dev):
        return M.yolov3_darknet53(num_classes=cfg["classes"], device=dev,
                                  generator=torch.Generator().manual_seed(
                                      seed))

    def heads_loss(model):
        def loss_of(heads, box, label):
            return model.loss([h.float() for h in heads], box, label)
        return loss_of

    b, s = cfg["check_batch"], cfg["check_size"]
    x, box, label = yolo_batch(rng, b, s)
    card = make(DEV).eval()
    with P.device_guard("cpu"), torch.no_grad():
        host = make("cpu").eval()
        ref_heads = host(x)
    with torch.no_grad():
        heads = card(x.to(DEV))
    errs = [rel_err(h.cpu(), r) for h, r in zip(heads, ref_heads)]
    check(max(errs) <= TOL_TRAIN_GRAD_REL, f"yolo: fp32 b{b} {s}x{s} eval "
          f"heads {[tuple(h.shape) for h in heads]} on the card vs the CPU, "
          f"rel errs {[f'{e:.3g}' for e in errs]} <= {TOL_TRAIN_GRAD_REL}")
    out["eval_heads_rel_err"] = errs
    # predict on train-mode heads: at random init the eval-mode heads are
    # nearly their biases (75 layers of unnormalized activations shrink),
    # so their scores tie; batch statistics keep the heads' spread
    with P.device_guard("cpu"), torch.no_grad():
        spread = host.train()(x)
    out["predict_check"] = yolo_predict_check(card, list(spread), s)
    del card, heads
    out.update(vision_card_vs_cpu("yolo", make, heads_loss(host), x.to(DEV),
                                  box.to(DEV), label.to(DEV)))
    del host
    torch.cuda.empty_cache()

    # full width: bf16 compute over fp32 parameters, fp32 heads into the loss
    model = make(DEV).train()
    opt = Momentum(learning_rate=cfg["lr"], momentum=cfg["momentum"])
    params = convert.parameters_dict(model)
    state = opt.init(params)
    step = vision_train_step(model, heads_loss(model), opt, torch.bfloat16)
    b, s = cfg["batch"], cfg["size"]
    images, box, label = yolo_batch(rng, b, s)
    images = images.to(DEV, torch.bfloat16)
    box, label = box.to(DEV), label.to(DEV)
    (params, state, _), counts = count_one(step, params, state, images, box,
                                           label)
    check(sum(counts.values()) == 0, f"yolo: a YOLOv3 step launches no port "
          f"kernel ({counts})")
    params, state, ms, peak, losses = timed_steps(
        lambda p, st, batch, _: step(p, st, *batch), params, state,
        (images, box, label), None, cfg["steps"], cfg["warm"])
    check(all(np.isfinite(losses)), f"yolo losses finite {losses}")
    grads = {k: torch.zeros_like(v) for k, v in params.items()}

    def run():
        nonlocal params, state
        params, state, _ = step(params, state, images, box, label)

    prof = vision_profile(run, lambda: opt.update(grads, state, params))
    ips = b / ms * 1e3
    mfu = 3 * cfg["fwd_flops"] * ips / PEAK_FLOPS[torch.bfloat16]

    # one b64 prediction: the forward, then decode and NMS timed apart
    model.eval()
    with torch.no_grad():
        heads = [h.float() for h in torch.func.functional_call(
            model, {k: v.to(torch.bfloat16) for k, v in params.items()},
            (images,))]
        img = torch.tensor([[s, s]] * b, dtype=torch.int32, device=DEV)
        (dets, num), pcounts = count_one(model.predict, heads, img)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets, num = model.predict(heads, img)
        torch.cuda.synchronize()
        predict_ms = (time.perf_counter() - t0) * 1e3
    check(tuple(dets.shape) == (b, 100, 6) and bool(torch.isfinite(
        dets).all()) and sum(pcounts.values()) == 0,
          f"yolo predict b{b}: dets {tuple(dets.shape)} finite, "
          f"{int(num.sum())} detections, {predict_ms:.1f} ms wall "
          f"(yolo_box + multiclass_nms, {len(heads)} heads), no port "
          f"kernel")
    log(f"[yolo] YOLOv3-DarkNet53 bf16 b{b} {s}x{s} Momentum: step "
        f"{ms:.2f} ms = {ips:.1f} images/s, MFU {mfu:.4f}, peak "
        f"{peak:.2f} GiB, busy share {prof['busy_share']:.3f}; predict "
        f"{predict_ms:.1f} ms; losses {[round(v, 4) for v in losses]}; "
        f"port kernel launches {counts}")
    out.update(step_ms=ms, images_per_s=ips, mfu=mfu, peak_gib=peak,
               losses=losses, port_kernel_launches=counts, profile=prof,
               busy_share=prof["busy_share"], predict_ms=predict_ms,
               predict_detections=num.tolist())
    del model, opt, params, state, grads, images, heads
    torch.cuda.empty_cache()
    return out



# -- phase 24: data-parallel ERNIE-base pretraining through fleet -----------

# The job's ranks run this script with ``--dp-worker MODE OUT`` under the
# port's launcher.  DP["buffer_mb"] is DataParallel's comm_buffer_size (17
# buckets of ERNIE-base's ~110 M fp32 gradients); the 2-rank job runs in
# fp32 at dropout 0 so the averaged halves can be held against the b64 step
# at the train phase's fp32 tolerances (each bf16 half would round its own
# sums); DP_PROBE are the port's collectives tried on CUDA tensors on gloo,
# the point-to-point ones last (gloo's TCP transport aborts the process on a
# device pointer there, and each abort costs a new job).
DP = dict(buffer_mb=25.0, steps=10, warm=2, gloo_steps=3, timeout_s=400,
          probe_timeout_s=30)
DP_PROBE = ("all_reduce", "all_reduce_max", "all_reduce_prod", "all_gather",
            "reduce_scatter", "all_to_all", "broadcast", "scatter", "barrier",
            "all_reduce_int8", "ppermute", "send_recv")


def _dp_capture(dopt):
    """The gradients the inner optimizer of ``dopt`` receives at its first
    update (after DataParallel's sync), kept as they are."""
    seen = []
    update = dopt.inner.update

    def capturing(grads, state, params, lr=None):
        if not seen:
            seen.append({k: v.clone() for k, v in grads.items()})
        return update(grads, state, params, lr)

    dopt.inner.update = capturing
    return seen


def _dp_buckets(grads, buffer_mb):
    """The bucketer's flat fp32 buffers of ``grads`` (parallel/compress.py
    bucketed_all_reduce's layout), each padded to a multiple of 256."""
    from paddle_tpu_torch.parallel import compress as C

    rev = list(reversed(C._flatten(grads)))
    out = []
    for bucket in C.bucket_assignment([g.numel() * 4 for _, g in rev],
                                      buffer_mb):
        flat = torch.cat([rev[i][1].float().reshape(-1) for i in bucket])
        pad = (-flat.numel()) % 256
        out.append(torch.cat([flat, flat.new_zeros(pad)]) if pad else flat)
    return out


def dp_quantize_check(buckets):
    """quantize / dequantize_blockwise (block 256, int8 and fp8) of every
    bucket on the card against the CPU bit for bit, and
    all_reduce_compressed at one member against its n <= 1 route."""
    from paddle_tpu_torch.parallel import compress as C

    out = {}
    for kind in C.COMPRESS_KINDS:
        worst_q = worst_d = moved = 0
        for flat in buckets:
            qg, sg = C.quantize_blockwise(flat, kind, 256)
            qc, sc = C.quantize_blockwise(flat.cpu(), kind, 256)
            bits = torch.uint8 if kind == "fp8" else torch.int8
            worst_q += int((qg.cpu().view(bits) != qc.view(bits)).sum()) \
                + int((sg.cpu() != sc).sum())
            dg = C.dequantize_blockwise(qg, sg, 256)
            dc = C.dequantize_blockwise(qc, sc, 256)
            worst_d += int((dg.cpu() != dc).sum())
            one = C.all_reduce_compressed(flat, "dp", compress=kind)
            moved += int((one != flat).sum())
        n = sum(b.numel() for b in buckets)
        check(worst_q == 0 and worst_d == 0,
              f"{kind} block 256: quantize and dequantize of "
              f"{len(buckets)} buckets ({n} values) on the card equal the "
              f"CPU's bit for bit ({worst_q} / {worst_d} differing)")
        check(moved == 0, f"{kind}: all_reduce_compressed at one member "
              f"returns each bucket as it is (the n <= 1 route; {moved} "
              f"values moved)")
        out[kind] = dict(differing_payload_or_scales=worst_q,
                         differing_dequantized=worst_d)
    return out


def _dp_model(cfg, seed):
    from paddle_tpu_torch.text.ernie import ErnieForPretraining

    return ErnieForPretraining(cfg, device=DEV,
                               generator=torch.Generator().manual_seed(seed))


def dp_one_rank(seed, rank):
    """One NCCL rank at full width, bench.py's step: the first step through
    DataParallel + fleet against the same step without them, bit for bit;
    the launches of one step; 10 timed steps; the quantizer on the card."""
    from paddle_tpu_torch import convert, entry
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import DataParallel, mesh
    from paddle_tpu_torch.parallel.fleet import DistributedStrategy
    from paddle_tpu_torch.text.ernie import (
        ErnieConfig,
        ErniePretrainingCriterion,
    )

    cfg = ErnieConfig()
    seq, b = TRAIN_SEQ, TRAIN_BATCH
    n_mask = max(1, int(seq * 0.15))
    crit = ErniePretrainingCriterion(cfg.vocab_size)
    rng = np.random.default_rng(seed)
    model = _dp_model(cfg, seed)
    params = convert.parameters_dict(model)
    batch = pretrain_batch(rng, b, seq, cfg.vocab_size, n_mask)
    dp = DataParallel(model, comm_buffer_size=DP["buffer_mb"])
    dopt = fleet.distributed_optimizer(Adam(learning_rate=1e-4),
                                       DistributedStrategy())
    seen = _dp_capture(dopt)
    step = entry.make_train_step(dp, crit, dopt, torch.bfloat16)
    state = dopt.init(params)
    with deterministic():
        ref, _, ref_loss = entry.make_train_step(
            model, crit, _GradCapture(), torch.bfloat16)(
            params, None, batch, torch.Generator().manual_seed(seed))
        gen = torch.Generator().manual_seed(seed)
        config.reset_counts()
        params, state, loss = step(params, state, batch, gen)
        torch.cuda.synchronize()
        counts = config.launch_counts()
    grads = seen[0]
    diff = grads_identical(grads, ref)
    check(set(grads) == set(ref) and diff == 0.0,
          f"[dp] world 1 (NCCL, {mesh.mesh_fingerprint()}): {len(ref)} "
          f"first-step gradients through DataParallel + fleet equal the "
          f"step without them bit for bit (largest difference {diff})")
    check(bits(loss) == bits(ref_loss), f"[dp] loss {loss.item():.6f} equal "
          f"to the step without DataParallel bit for bit")
    check_counts("[dp] world-1 step", counts, ernie_expect(
        cfg.num_hidden_layers, False), only=True)
    buckets = _dp_buckets(grads, DP["buffer_mb"])
    del ref, seen, grads
    quant = dp_quantize_check(buckets)
    bucket_mb = [f.numel() * 4 / 2 ** 20 for f in buckets]
    del buckets
    params, state, ms, peak, losses = timed_steps(
        step, params, state, batch, gen, DP["steps"] + DP["warm"], DP["warm"])
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"[dp] losses finite and falling: {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}")
    box = [params, state]

    def run():
        box[0], box[1], _ = step(box[0], box[1], batch, gen)

    prof = profile_split(run)
    toks = b * seq / ms * 1e3
    log(f"[dp] rank {rank}: bf16 ERNIE-base b{b} s{seq} through DataParallel"
        f" ({len(bucket_mb)} buckets of <= {DP['buffer_mb']:g} MB: "
        f"{min(bucket_mb):.1f}-{max(bucket_mb):.1f} MB) + fleet Adam: "
        f"{ms:.2f} ms a step (mean of {DP['steps']}) = {toks:.1f} tokens/s;"
        f" peak {peak:.2f} GiB")
    return dict(step_ms=ms, tokens_per_s=toks, peak_gib=peak, losses=losses,
                profile=prof, launches=counts, buckets=len(bucket_mb),
                bucket_mb=bucket_mb,
                grad_diff=diff, quantize=quant,
                fingerprint=mesh.mesh_fingerprint())


def dp_two_ranks(seed, rank):
    """Two gloo ranks on the one card, each stepping b32 of one b64 batch in
    fp32 (dropout 0): rank 0 holds the averaged gradients and the mean
    loss against the single-process b64 step (steps_agree)."""
    from paddle_tpu_torch import convert, entry
    from paddle_tpu_torch.distributed import all_reduce, fleet
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import DataParallel, mesh, shard_batch
    from paddle_tpu_torch.parallel.fleet import DistributedStrategy
    from paddle_tpu_torch.text.ernie import (
        ErnieConfig,
        ErniePretrainingCriterion,
    )

    cfg = ErnieConfig(hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    seq, b = TRAIN_SEQ, TRAIN_BATCH
    n_mask = max(1, int(seq * 0.15))
    crit = ErniePretrainingCriterion(cfg.vocab_size)
    model = _dp_model(cfg, seed)
    params = convert.parameters_dict(model)
    full = pretrain_batch(np.random.default_rng(seed), b, seq,
                          cfg.vocab_size, n_mask)
    gen = torch.Generator().manual_seed(seed)
    if rank == 0:
        ref, _, ref_loss = entry.make_train_step(model, crit, _GradCapture())(
            params, None, full, gen)
    half = shard_batch(full)
    dp = DataParallel(model, comm_buffer_size=DP["buffer_mb"])
    dopt = fleet.distributed_optimizer(Adam(learning_rate=1e-4),
                                       DistributedStrategy())
    seen = _dp_capture(dopt)
    step = entry.make_train_step(dp, crit, dopt)
    state = dopt.init(params)
    config.reset_counts()
    params, state, loss = step(params, state, half, gen)
    torch.cuda.synchronize()
    counts = config.launch_counts()
    mean_loss = all_reduce(loss, op="avg")
    out = dict(launches=counts, loss=loss.item(), mean_loss=mean_loss.item(),
               fingerprint=mesh.mesh_fingerprint())
    if rank == 0:
        steps_agree(mean_loss, seen[0], ref_loss, ref,
                    "the b64 single-process step")
        out["ref_loss"] = ref_loss.item()
        del ref
    del seen
    params, state, ms, peak, losses = timed_steps(
        step, params, state, half, gen, DP["gloo_steps"] + 1, 1)
    log(f"[dp] rank {rank} of 2 (gloo on CUDA tensors, one card): fp32 b"
        f"{b // 2} of b{b} s{seq}: {ms:.2f} ms a step (mean of "
        f"{DP['gloo_steps']}); peak {peak:.2f} GiB")
    out.update(step_ms=ms, peak_gib=peak, losses=losses)
    return out


def dp_gloo_probe(rank, first, out_dir):
    """Which of the port's collectives gloo takes on CUDA tensors: from
    DP_PROBE[first] on, each is tried on every rank on a small CUDA
    tensor, and its outcome (ok, or the error it raised) is appended to
    ``probe<first>.rank<r>.jsonl`` as soon as it is known.  A collective
    that gloo hands a device pointer to its TCP transport aborts the
    process instead of raising; ``dp_probe`` reads how far the lines go
    and starts a new job after it."""
    import paddle_tpu_torch.distributed as dist

    x = torch.arange(8, dtype=torch.float32, device=DEV) + rank
    tries = {
        "all_reduce": lambda: dist.all_reduce(x),
        "all_reduce_max": lambda: dist.all_reduce(x, op="max"),
        "all_reduce_prod": lambda: dist.all_reduce(x, op="prod"),
        "all_gather": lambda: dist.all_gather(x),
        "reduce_scatter": lambda: dist.reduce_scatter(x),
        "all_to_all": lambda: dist.all_to_all(x),
        "broadcast": lambda: dist.broadcast(x, src=1),
        "scatter": lambda: dist.scatter(None, tensor_list=[x, x + 1]),
        "barrier": lambda: dist.barrier(),
        "ppermute": lambda: dist.ppermute(x, [(0, 1), (1, 0)]),
        "send_recv": lambda: (dist.send(x, dst=1) if rank == 0
                              else dist.recv(torch.empty_like(x), src=0)),
        "all_reduce_int8": lambda: dist.all_reduce(x, compress="int8",
                                                   block_size=4)}
    path = os.path.join(out_dir, f"probe{first}.rank{rank}.jsonl")
    for name in DP_PROBE[first:]:
        try:
            tries[name]()
            torch.cuda.synchronize()
            got = "ok"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            got = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
        with open(path, "a") as f:
            f.write(json.dumps([name, got]) + "\n")
    return {}


def dp_worker(mode, out_dir, seed):
    """A rank of phases 24-26's jobs: join the job (gloo over a default
    group this process creates for the multi-rank jobs, as NCCL refuses two
    ranks on one card; NCCL through fleet.init for the 1-rank jobs), run
    ``mode`` ("nccl1", "gloo2", "probe<first>", "hybrid1", "hybrid4",
    "elastic4" or "elastic2"), write its result to
    ``out_dir/<mode>.rank<r>.json`` and leave the job in order
    (``shutdown_parallel_env``)."""
    import datetime

    import torch.distributed as tdist
    from paddle_tpu_torch.distributed import fleet, shutdown_parallel_env

    t_init = time.time()
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    if mode not in ("nccl1", "hybrid1"):
        tdist.init_process_group(
            "gloo", init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
            f"{os.environ['MASTER_PORT']}", rank=rank,
            world_size=int(os.environ["PADDLE_TRAINERS_NUM"]),
            timeout=datetime.timedelta(seconds=DP["probe_timeout_s"]
                                       if mode.startswith("probe") else 600))
    fleet.init()
    times = dict(top=_T_MODULE_TOP, torch=_T_TORCH, module=_T_MODULE_END,
                 init_start=t_init, ready=time.time())
    if mode.startswith("probe"):
        res = dp_gloo_probe(rank, int(mode[len("probe"):]), out_dir)
    elif mode in ("elastic4", "elastic2"):
        res = elastic_ranks(seed, rank, out_dir)
    else:
        res = {"nccl1": dp_one_rank, "gloo2": dp_two_ranks,
               "hybrid1": hybrid_one_rank,
               "hybrid4": hybrid_four_ranks}[mode](seed, rank)
    res.update(times=times, backend=tdist.get_backend())
    with open(os.path.join(out_dir, f"{mode}.rank{rank}.json"), "w") as f:
        json.dump(res, f)
    # a barrier (not after a probe, whose group a failed collective may
    # have broken), then the groups destroyed and collected while the
    # interpreter is whole
    shutdown_parallel_env(barrier=not mode.startswith("probe"))
    return 0


def _dp_run(mode, nproc, out_dir, seed, timeout):
    """Run ``mode`` on ``nproc`` ranks of the port's launcher (this script
    under ``--dp-worker``) in its own process group, killed whole at the
    timeout; returns (its exit code or "killed", the parent's wall time at
    the start)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc", str(nproc), os.path.abspath(__file__), "--seed",
           str(seed), "--dp-worker", mode, out_dir]
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=root, env=env, start_new_session=True)
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        rc = "killed at the timeout"
    return rc, t0


def _dp_job(mode, nproc, out_dir, seed, timeout=None):
    """``_dp_run`` that must exit 0; returns (the parent's wall time at the
    start, each rank's result)."""
    rc, t0 = _dp_run(mode, nproc, out_dir, seed,
                     timeout or DP["timeout_s"])
    check(rc == 0, f"[dp] {mode} job on {nproc} rank(s) exits 0 ({rc})")
    res = []
    for r in range(nproc):
        with open(os.path.join(out_dir, f"{mode}.rank{r}.json")) as f:
            res.append(json.load(f))
    return t0, res


def dp_probe(out_dir, seed):
    """Each of DP_PROBE's collectives on CUDA tensors under gloo on two
    ranks: "ok", the error it raised (each rank's where they differ), or
    how its job died; a job that dies is followed by one from the next
    collective, so each is tried once.  Not a phase of ``main`` (phase 24
    calls only all_reduce on gloo): ``phase_experiments.py --phases
    24probe`` runs it."""
    out, first = {}, 0
    while first < len(DP_PROBE):
        rc, _ = _dp_run(f"probe{first}", 2, out_dir, seed,
                        DP["probe_timeout_s"] + 60)
        lines = []
        for r in range(2):
            path = os.path.join(out_dir, f"probe{first}.rank{r}.jsonl")
            with open(path) if os.path.exists(path) else \
                    contextlib.nullcontext([]) as f:
                lines.append([tuple(json.loads(ln)) for ln in f])
        done = min(len(x) for x in lines)
        for (name, a), (_, b) in zip(lines[0][:done], lines[1][:done]):
            out[name] = a if a == b else f"rank 0: {a}; rank 1: {b}"
        first += done
        if rc != 0:
            check(first < len(DP_PROBE), f"[dp] a probe job died ({rc}) "
                  f"in a collective, not after the last")
            out[DP_PROBE[first]] = f"the job died ({rc})"
            first += 1
    return out


def _startup(t0, times):
    """A rank's start-up split from the parent's launch time ``t0``: the
    interpreter, torch, this module, the process group and mesh."""
    return dict(interpreter=times["top"] - t0,
                torch=times["torch"] - times["top"],
                module=times["module"] - times["torch"],
                parallel_env=times["ready"] - times["init_start"],
                total=times["ready"] - t0)


def dp_phase(seed, train_ms=None):
    """Phase 24 (module docstring): the world-1 NCCL job and the 2-rank
    gloo job; ``train_ms`` is the train phase's step in this run, which
    the world-1 step is printed against."""
    import tempfile

    t_phase = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="dp_phase_")
    try:
        t0, (one,) = _dp_job("nccl1", 1, out_dir, seed)
        t1, two = _dp_job("gloo2", 2, out_dir, seed)
        t2 = time.time()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    check(one["backend"] == "nccl" and two[0]["backend"] == "gloo",
          f"[dp] backends: world 1 {one['backend']}, 2 ranks "
          f"{two[0]['backend']}")
    startup = dict(nccl1=_startup(t0, one["times"]),
                   gloo2=[_startup(t1, r["times"]) for r in two])
    jobs_s = dict(nccl1=t1 - t0, gloo2=t2 - t1)
    phase_s = time.perf_counter() - t_phase
    against = (f"the train phase's {train_ms:.2f} ms in this run: x"
               f"{one['step_ms'] / train_ms:.3f}" if train_ms else
               "the train phase's 65.44-68.32 ms, PERF.md")
    log(f"[dp] world 1: step {one['step_ms']:.2f} ms ({against}), launches "
        f"{one['launches']}; start-up "
        + ", ".join(f"{k} {v:.2f} s" for k, v in startup["nccl1"].items()))
    log(f"[dp] 2 gloo ranks: mean loss {two[0]['mean_loss']:.6f} (b64 "
        f"{two[0]['ref_loss']:.6f}); step {two[0]['step_ms']:.2f} / "
        f"{two[1]['step_ms']:.2f} ms; start-ups "
        + "; ".join(", ".join(f"{k} {v:.2f} s" for k, v in s.items())
                    for s in startup["gloo2"]))
    log(f"[dp] phase {phase_s:.1f} s (jobs: world 1 {jobs_s['nccl1']:.1f} "
        f"s, 2 ranks {jobs_s['gloo2']:.1f} s)")
    return one["launches"], dict(
        world1=one, gloo2=[{k: v for k, v in r.items() if k != "times"}
                           for r in two],
        train_step_ms=train_ms, startup=startup, jobs_s=jobs_s,
        phase_s=phase_s)


# -- phase 25: hybrid parallelism ---------------------------------------------

# (a) one NCCL rank: bench.py's bf16 b64 s512 step through HybridPretrainer,
# then its fp32 dropout-0 step against entry.make_train_step; (b) four gloo
# ranks sharing the card, full-width ERNIE-base in fp32 at dropout 0, b8
# s512, one mesh after another, each held against the world-1 step of the
# same parameters and batch (computed on rank 0)
HYBRID = dict(steps=10, warm=2, batch=8, mesh_steps=2, mesh_warm=1,
              lr=1e-4, timeout_s=600)
# name, degrees, micro-batches, pipeline schedule, MoE experts, ZeRO-1
HYBRID_MESHES = (
    ("pp2tp2_gpipe", dict(pp=2, tp=2), 4, "gpipe", 0, False),
    ("pp2tp2_1f1b", dict(pp=2, tp=2), 4, "1f1b", 0, False),
    ("dp2sp2_zero", dict(dp=2, sp=2), 1, "gpipe", 0, True),
    ("tp4", dict(tp=4), 1, "gpipe", 0, False),
    ("ep2sp2_moe", dict(ep=2, sp=2), 1, "gpipe", 4, False))
TOL_HYBRID_W1_LOSS_REL = 1e-5   # (a) fp32 against entry.make_train_step
TOL_HYBRID_W1_GRAD_REL = 1e-4
TOL_HYBRID_LOSS_REL = 2e-4      # (b) the _dryrun_on_mesh contract
TOL_HYBRID_GRAD_REL = 1e-3
# a gradient's tolerance is of its own largest value floored at this share
# of the largest gradient of all (the key bias's is rounding noise)
HYBRID_GRAD_FLOOR = 1e-4
# ZeRO-1's Adam step against the world-1 Adam step from the world-1
# gradients: Adam's first step is -lr g / (|g| + eps), about -lr sign(g), so
# an element whose gradient is rounding noise (under HYBRID_GRAD_FLOOR of
# the largest gradient of all) may step either way: held within 2 lr; every
# other element within ZERO_STEP_REL lr of the world-1 step
ZERO_STEP_REL = 1e-2
HYBRID_ROWS = ("flash_attention_packed", "flash_attention_packed_bwd",
               "flash_attention", "flash_attention_bwd", "layer_norm",
               "layer_norm_bwd", "residual_layer_norm",
               "residual_layer_norm_bwd")


class _HybridCapture:
    """An optimizer whose first update keeps the gradients it gets (this
    rank's slices, keyed "<group>/<name>") in ``grads``; every update then
    goes to ``inner`` (none: no parameter moves)."""

    def __init__(self, inner=None):
        self.inner = inner
        self.grads = None

    def init(self, params):
        return {} if self.inner is None else self.inner.init(params)

    def update(self, grads, state, params, lr=None):
        if self.grads is None:
            self.grads = {k: g.detach().clone() for k, g in grads.items()}
        if self.inner is None:
            return params, state
        return self.inner.update(grads, state, params, lr)


def _nested(flat):
    out = {}
    for key, v in flat.items():
        g, k = key.split("/", 1)
        out.setdefault(g, {})[k] = v
    return out


def _hybrid_trainer(cfg, mesh, seed, experts=0, strategy=None):
    from paddle_tpu_torch.text.pretrainer import HybridPretrainer

    return HybridPretrainer(cfg, mesh=mesh, moe_experts=experts,
                            strategy=strategy, device=DEV,
                            generator=torch.Generator().manual_seed(seed))


def _hybrid_grads(tr, params, batch, seed):
    """One step's loss and every gradient, gathered whole (ZeRO-1 off for
    the capture: its gradients would be dp slices)."""
    zero, tr.zero_sharding = tr.zero_sharding, False
    cap = _HybridCapture()
    _, _, loss = tr.make_train_step(cap)(
        params, tr.init_opt_state(cap, params), batch,
        torch.Generator().manual_seed(seed))
    tr.zero_sharding = zero
    return loss, tr.unshard_params(_nested(cap.grads))


def _flat(nested):
    return {f"{g}/{k}": v for g, leaves in nested.items()
            for k, v in leaves.items()}


def _entry_names(nested, layers):
    """The hybrid trainer's {"embed", "blocks", "head"} leaves under
    ``ErnieForPretraining``'s parameter names (blocks unstacked)."""
    out = {f"ernie.embeddings.{k}": v for k, v in nested["embed"].items()}
    for k, v in nested["blocks"].items():
        for i in range(layers):
            out[f"ernie.encoder.layers.{i}.{k}"] = v[i]
    for k, v in nested["head"].items():
        out[("ernie." + k) if k.startswith("pooler.") else k] = v
    return out


def hybrid_agree(tag, loss, grads, loss_ref, grads_ref, loss_tol, grad_tol):
    """The loss within ``loss_tol`` (relative) and every gradient within
    ``grad_tol`` of its largest value (floored at HYBRID_GRAD_FLOOR of the
    largest of all) of the reference; returns both errors."""
    r = abs(float(loss) - float(loss_ref)) / abs(float(loss_ref))
    check(r <= loss_tol, f"{tag}: loss {float(loss):.6f} vs "
          f"{float(loss_ref):.6f}, rel err {r:.3g} <= {loss_tol}")
    check(set(grads) == set(grads_ref), f"{tag}: the same {len(grads_ref)} "
          f"gradients")
    top = max(float(g.abs().max()) for g in grads_ref.values())
    worst = max((max_abs(grads[k].to(g.device), g) / max(
        float(g.abs().max()), HYBRID_GRAD_FLOOR * top), k)
        for k, g in grads_ref.items())
    check(worst[0] <= grad_tol, f"{tag}: worst gradient err {worst[0]:.3g} "
          f"of the tensor's largest ({worst[1]}) <= {grad_tol}")
    return r, worst[0]


def hybrid_one_rank(seed, rank):
    """Phase 25 (a): one NCCL rank through fleet."""
    from paddle_tpu_torch import entry
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import mesh
    from paddle_tpu_torch.text.ernie import (
        ErnieConfig,
        ErnieForPretraining,
        ErniePretrainingCriterion,
    )

    cfg = ErnieConfig()
    L, seq, b = cfg.num_hidden_layers, TRAIN_SEQ, TRAIN_BATCH
    n_mask = max(1, int(seq * 0.15))
    batch = pretrain_batch(np.random.default_rng(seed), b, seq,
                           cfg.vocab_size, n_mask)
    tr = _hybrid_trainer(cfg, fleet.mesh, seed, strategy=fleet.strategy)
    whole = tr.init_params()
    params = tr.place_params(whole)
    local = tr.place_batch(batch)
    opt = Adam(learning_rate=HYBRID["lr"])
    state = tr.init_opt_state(opt, params)
    step = tr.make_train_step(opt, torch.bfloat16)
    gen = torch.Generator().manual_seed(seed)
    config.reset_counts()
    params, state, _ = step(params, state, local, gen)
    torch.cuda.synchronize()
    counts = config.launch_counts()
    check_counts("[hybrid] world-1 bf16 step", counts,
                 ernie_expect(L, False), only=True)
    params, state, ms, peak, losses = timed_steps(
        step, params, state, local, gen, HYBRID["steps"] + HYBRID["warm"],
        HYBRID["warm"])
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"[hybrid] world-1 losses finite and falling: {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}")
    del params, state, step
    torch.cuda.empty_cache()
    cfg0 = ErnieConfig(hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    tr0 = _hybrid_trainer(cfg0, fleet.mesh, seed)
    loss, grads = _hybrid_grads(tr0, tr0.place_params(whole), local, seed)
    grads = _entry_names(grads, L)
    torch.cuda.empty_cache()
    model = ErnieForPretraining(cfg0, device=DEV)
    ref_grads, _, ref_loss = entry.make_train_step(
        model, ErniePretrainingCriterion(cfg0.vocab_size), _GradCapture())(
        {k: v.to(DEV, copy=True) for k, v in _entry_names(whole, L).items()},
        None,
        batch, torch.Generator().manual_seed(seed))
    loss_err, grad_err = hybrid_agree(
        "[hybrid] world-1 fp32 b64 step vs entry.make_train_step", loss,
        grads, ref_loss, ref_grads, TOL_HYBRID_W1_LOSS_REL,
        TOL_HYBRID_W1_GRAD_REL)
    toks = b * seq / ms * 1e3
    log(f"[hybrid] world 1 (NCCL, {mesh.mesh_fingerprint()}): bf16 "
        f"ERNIE-base b{b} s{seq} through HybridPretrainer + Adam: {ms:.2f} "
        f"ms a step (mean of {HYBRID['steps']}) = {toks:.1f} tokens/s; peak "
        f"{peak:.2f} GiB")
    return dict(step_ms=ms, tokens_per_s=toks, peak_gib=peak, losses=losses,
                launches=counts, fp32_loss_rel_err=loss_err,
                fp32_grad_rel_err=grad_err,
                fingerprint=mesh.mesh_fingerprint())


def _zero_steps_agree(tag, new, ref_new, ref_grads, lr):
    """ZeRO-1's updated parameters against the world-1 Adam step (rule at
    ZERO_STEP_REL)."""
    top = max(float(g.abs().max()) for g in ref_grads.values())
    worst_big, worst_noise = 0.0, 0.0
    for k, g in ref_grads.items():
        d = (new[k].to(g.device) - ref_new[k]).abs()
        noise = g.abs() < HYBRID_GRAD_FLOOR * top
        if (~noise).any():
            worst_big = max(worst_big, float(d[~noise].max()) / lr)
        if noise.any():
            worst_noise = max(worst_noise, float(d[noise].max()) / lr)
    check(worst_big <= ZERO_STEP_REL and worst_noise <= 2 * (1 + 1e-6),
          f"{tag}: the ZeRO-1 Adam step against the world-1 step: "
          f"{worst_big:.3g} lr where the gradient is above the floor (<= "
          f"{ZERO_STEP_REL}), {worst_noise:.3g} lr where it is noise (<= 2)")
    return worst_big, worst_noise


def hybrid_four_ranks(seed, rank):
    """Phase 25 (b): four gloo ranks sharing the card, the meshes of
    HYBRID_MESHES in turn."""
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.parallel import mesh as M
    from paddle_tpu_torch.parallel.fleet import DistributedStrategy
    from paddle_tpu_torch.text.ernie import ErnieConfig

    cfg0 = ErnieConfig(hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    seq, b = TRAIN_SEQ, HYBRID["batch"]
    n_mask = max(1, int(seq * 0.15))
    batch = pretrain_batch(np.random.default_rng(seed), b, seq,
                           cfg0.vocab_size, n_mask)
    lr = HYBRID["lr"]
    refs = {}
    if rank == 0:  # the world-1 steps (and Adam step) the meshes are held to
        world1 = M.build_mesh(M.MeshConfig(devices=[0]))
        M.set_mesh(world1)
        for experts in (0, 4):
            tr = _hybrid_trainer(cfg0, world1, seed, experts)
            whole = tr.init_params()
            loss, grads = _hybrid_grads(tr, tr.place_params(whole), batch,
                                        seed)
            ref = dict(loss=loss, grads=_flat(grads))
            if experts == 0:
                p = {k: v.to(DEV, copy=True) for k, v in _flat(whole).items()}
                opt = Adam(learning_rate=lr)
                new, st = opt.update(ref["grads"], opt.init(p), p)
                ref.update(adam=new, moment_bytes=sum(
                    s.numel() * s.element_size()
                    for slots in st["per_param"].values() for s in slots
                    if torch.is_tensor(s)))
            refs[experts] = ref
            del tr, whole
            torch.cuda.empty_cache()
    out = {}
    for name, degrees, num_micro, schedule, experts, zero in HYBRID_MESHES:
        t_mesh = time.perf_counter()
        m = M.build_mesh(M.MeshConfig(**dict({"dp": 1}, **degrees)))
        M.set_mesh(m)
        strategy = DistributedStrategy()
        strategy.pipeline = True
        strategy.pipeline_configs.schedule = schedule
        strategy.pipeline_configs.micro_batch = num_micro
        strategy.sequence_parallel = "sp" in degrees
        strategy.sharding = zero
        # the same seed draws the world-1 reference's parameters
        tr = _hybrid_trainer(cfg0, m, seed, experts, strategy)
        whole = tr.init_params()
        local = tr.place_batch(batch)
        params = tr.place_params(whole)
        opt = _HybridCapture(Adam(learning_rate=lr))
        state = tr.init_opt_state(opt, params)
        step = tr.make_train_step(opt)
        gen = torch.Generator().manual_seed(seed)
        C.reset_routes()
        config.reset_counts()
        params, state, loss = step(params, state, local, gen)
        torch.cuda.synchronize()
        res = dict(launches=config.launch_counts(), routes=C.routes())
        if zero:  # its update got dp slices: one step more, ZeRO-1 off
            loss, grads = _hybrid_grads(tr, tr.place_params(whole), local,
                                        seed)
        else:
            grads = tr.unshard_params(_nested(opt.grads))
        opt.grads = {}
        res["loss"] = float(loss)
        if rank == 0:
            ref = refs[experts]
            res["loss_rel_err"], res["grad_rel_err"] = hybrid_agree(
                f"[hybrid] {name} (4 gloo ranks) vs the world-1 step", loss,
                _flat(grads), ref["loss"], ref["grads"],
                TOL_HYBRID_LOSS_REL, TOL_HYBRID_GRAD_REL)
        del grads
        if zero:
            res["moment_bytes"] = sum(
                s.numel() * s.element_size()
                for slots in state["per_param"].values() for s in slots
                if torch.is_tensor(s))
            new = _flat(tr.unshard_params(params))
            if rank == 0:
                res["full_moment_bytes"] = refs[0]["moment_bytes"]
                res["zero_step_err_lr"] = _zero_steps_agree(
                    f"[hybrid] {name}", new, refs[0]["adam"],
                    refs[0]["grads"], lr)
            del new
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        params, state, ms, peak, losses = timed_steps(
            step, params, state, local, gen,
            HYBRID["mesh_steps"] + HYBRID["mesh_warm"], HYBRID["mesh_warm"])
        res.update(step_ms=ms, peak_gib=peak,
                   step_peak_gib=peak - base / 2 ** 30, losses=losses,
                   seconds=time.perf_counter() - t_mesh)
        out[name] = res
        del params, state, step, tr, local, whole
        torch.cuda.empty_cache()
    M.set_mesh(None)
    return dict(meshes=out)


def hybrid_phase(seed, train_ms=None):
    """Phase 25 (module docstring): the world-1 NCCL job and the 4-rank
    gloo job; ``train_ms`` is the train phase's step in this run."""
    import tempfile

    t_phase = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="hybrid_phase_")
    try:
        t0, (one,) = _dp_job("hybrid1", 1, out_dir, seed,
                             HYBRID["timeout_s"])
        t1, four = _dp_job("hybrid4", 4, out_dir, seed, HYBRID["timeout_s"])
        t2 = time.time()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    check(one["backend"] == "nccl" and four[0]["backend"] == "gloo",
          f"[hybrid] backends: world 1 {one['backend']}, 4 ranks "
          f"{four[0]['backend']}")
    against = (f"the train phase's {train_ms:.2f} ms in this run: x"
               f"{one['step_ms'] / train_ms:.3f}" if train_ms else
               "the train phase's, PERF.md")
    log(f"[hybrid] world 1: step {one['step_ms']:.2f} ms ({against}), peak "
        f"{one['peak_gib']:.2f} GiB, launches {one['launches']}")
    meshes = {name: [r["meshes"][name] for r in four]
              for name, *_ in HYBRID_MESHES}
    for name, ranks in meshes.items():
        for r, res in enumerate(ranks):
            log(f"[hybrid] {name} rank {r}: {res['step_ms']:.1f} ms a step, "
                f"peak {res['peak_gib']:.2f} GiB ({res['step_peak_gib']:.2f} "
                f"above the step's start), launches "
                f"{ {k: v for k, v in res['launches'].items() if v} }, "
                f"routes {res['routes']}")
    for r in range(4):
        g, f = meshes["pp2tp2_gpipe"][r], meshes["pp2tp2_1f1b"][r]
        check(f["step_peak_gib"] < g["step_peak_gib"],
              f"[hybrid] rank {r}: 1F1B's step peak {f['step_peak_gib']:.3f}"
              f" GiB below GPipe's {g['step_peak_gib']:.3f}")
    for rows, where in ((("flash_attention_packed",
                          "flash_attention_packed_bwd"), "packed (rows 1-2)"),
                        (("flash_attention", "flash_attention_bwd"),
                         "split-head (rows 3-4)")):
        for k in rows:
            n = {name: sum(res["launches"].get(k, 0) for res in ranks)
                 for name, ranks in meshes.items()}
            check(any(n.values()), f"[hybrid] {where}: {k} launched on "
                  f"{[m for m, v in n.items() if v]} ({n})")
    z = meshes["dp2sp2_zero"]
    check(all(2 * r["moment_bytes"] <= z[0]["full_moment_bytes"] * 1.001
              for r in z), f"[hybrid] ZeRO-1: each rank's moments "
          f"{[r['moment_bytes'] for r in z]} B against the whole "
          f"{z[0]['full_moment_bytes']} B")
    phase_s = time.perf_counter() - t_phase
    log(f"[hybrid] phase {phase_s:.1f} s (jobs: world 1 {t1 - t0:.1f} s, "
        f"4 ranks {t2 - t1:.1f} s)")
    launches = dict(one["launches"])
    mesh_launches = {name: {k: sum(res["launches"].get(k, 0)
                                   for res in ranks) for k in HYBRID_ROWS}
                     for name, ranks in meshes.items()}
    return launches, mesh_launches, dict(
        world1={k: v for k, v in one.items() if k != "times"},
        meshes=meshes, train_step_ms=train_ms, phase_s=phase_s,
        jobs_s=dict(hybrid1=t1 - t0, hybrid4=t2 - t1))


# -- phases 26-27: elastic training and the heterogeneous parameter server --

ELASTIC = dict(batch=32, steps=4, save_every=2, reshard_batch=8, lr=1e-4,
               timeout_s=600)
# a PS step: the rows of the batch's ids pulled from the host table over
# TCP, the dense rest of ERNIE-base on the card under Adam, the rows'
# gradient pushed back through the AsyncCommunicator (adagrad on the host)
HETER = dict(shards=4, table_lr=0.05, steps=6, warm=2, probe_s=0.1,
             max_missed=2, after_failover=2)
# the pushed row gradients against the local-embedding step's weight
# gradient rows: the same sums in another order (numpy's add.at over the
# positions against the card's embedding backward), so within fp32
# rounding of the tensor's largest value
TOL_HETER_ROW_REL = 1e-5


def _fit_log():
    """A hapi callback keeping each fit step's loss (a device read a step)
    and the wall time at each step's start and at the fit's end, the card
    synchronized first."""
    from paddle_tpu_torch import hapi

    class FitLog(hapi.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.losses, self.t = [], []

        def on_train_batch_begin(self, step, logs=None):
            torch.cuda.synchronize()
            self.t.append(time.perf_counter())

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

        def on_train_end(self, logs=None):
            torch.cuda.synchronize()
            self.t.append(time.perf_counter())

    return FitLog()


def _flight(kind):
    from paddle_tpu_torch.utils import trace

    return [e for e in trace.flight_recorder().events() if e["kind"] == kind]


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, n))
               for n in os.listdir(path))


def elastic_fit_phase(seed, tmp):
    """Phase 26 (a): resumable ERNIE-base fine-tuning through Model.fit on
    one NCCL rank (module docstring)."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.distributed import (
        DistributedStrategy,
        fleet,
        shutdown_parallel_env,
    )
    from paddle_tpu_torch.elastic import checkpoint as ec
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.parallel.fleet import ElasticConfig
    from paddle_tpu_torch.text import Imdb
    from paddle_tpu_torch.utils import checkpoint as uckpt

    cfg = ELASTIC
    quiet = ernie_cfg(hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    state = finetune_state(quiet, seed)
    n = cfg["steps"] * cfg["batch"]
    train = Imdb(mode="train", synthetic_size=n, maxlen=HAPI["maxlen"])
    ckpt = os.path.join(tmp, "fit")
    names = ["elastic_save_every", "elastic_ckpt_dir", "elastic_keep_last"]
    saved_flags = flags.get_flags(names)
    strategy = DistributedStrategy()
    strategy.elastic = True
    strategy.elastic_configs = ElasticConfig(save_every=cfg["save_every"],
                                             ckpt_dir=ckpt)
    out = {"config": dict(cfg, maxlen=HAPI["maxlen"])}
    fleet.init(strategy=strategy)
    try:
        check(flags.get_flag("elastic_save_every") == cfg["save_every"]
              and flags.get_flag("elastic_ckpt_dir") == ckpt,
              "[elastic] fleet.init(DistributedStrategy(elastic=True)) set "
              "the elastic flags")
        model = hapi_model(quiet, state, seed)
        rec = _fit_log()
        n_ckpt0, n_rest0 = (len(_flight("elastic_checkpoint")),
                            len(_flight("elastic_restore")))
        config.reset_counts()
        with deterministic():
            model.fit(io.DataLoader(train, batch_size=cfg["batch"]),
                      epochs=1, shuffle=False, verbose=0, callbacks=[rec])
        torch.cuda.synchronize()
        counts = config.launch_counts()
        check_counts(f"[elastic] fit of {cfg['steps']} steps", counts,
                     {k: cfg["steps"] * v
                      for k, v in FINETUNE_LAUNCHES.items()}, only=True)
        steps = ec.list_steps(ckpt)
        check(steps == [2, 4], f"[elastic] Model.fit wrote checkpoints at "
              f"steps {steps} ([2, 4]: save_every {cfg['save_every']})")
        step_ms = [(b - a) * 1e3 for a, b in zip(rec.t, rec.t[1:])]
        saves = _flight("elastic_checkpoint")[n_ckpt0:]
        ckpt_bytes = _dir_bytes(os.path.join(ckpt, "step_00000002"))

        # the whole state of step 4 through utils.checkpoint.load
        whole = uckpt.load(os.path.join(ckpt, "step_00000004"))
        _, slots = ec._opt_slots(model)
        d_param = max(max_abs(torch.from_numpy(whole[f"param/{k}"]), p.cpu())
                      for k, p in model.network.named_parameters())
        d_slot = max(max_abs(torch.from_numpy(whole[f"opt/{i + 1:04d}"]),
                             s.cpu()) for i, s in enumerate(slots))
        check(d_param == 0.0 and d_slot == 0.0
              and int(whole["opt/0000"]) == cfg["steps"],
              f"[elastic] utils.checkpoint.load of step 4's directory: "
              f"{len(whole)} leaves, parameters and optimizer slots bit for "
              f"bit (largest differences {d_param}, {d_slot})")
        del whole, model, slots
        torch.cuda.empty_cache()

        # a fresh model (zeroed weights, no optimizer state) restored at
        # step 2 fits steps 3-4 on the same batches
        flags.set_flags({"elastic_save_every": 0})
        fresh = hapi_model(quiet, {k: np.zeros_like(v)
                                   for k, v in state.items()}, seed)
        meta = ec.restore_model(fresh, ckpt, step=2)
        restores = _flight("elastic_restore")[n_rest0:]
        rec2 = _fit_log()
        with deterministic():
            fresh.fit(io.DataLoader(io.Subset(train, list(range(
                2 * cfg["batch"], n))), batch_size=cfg["batch"]),
                epochs=1, shuffle=False, verbose=0, callbacks=[rec2])
        resumed, straight = rec2.losses, rec.losses[2:]
        bitwise = resumed == straight
        worst = max(abs(a - b) / abs(b) for a, b in zip(resumed, straight))
        check(meta["step"] == 2 and len(resumed) == 2
              and worst <= TOL_TRAIN_LOSS_REL,
              f"[elastic] restored at step 2, steps 3-4 losses {resumed} "
              f"against the uninterrupted run's {straight}: "
              f"{'bit for bit' if bitwise else f'rel err {worst:.3g}'} "
              f"(<= {TOL_TRAIN_LOSS_REL})")
        del fresh
        torch.cuda.empty_cache()
    finally:
        shutdown_parallel_env()
        flags.set_flags(saved_flags)
    log(f"[elastic] (a) fp32 ERNIE-base b{cfg['batch']} s{HAPI['maxlen']} "
        f"through Model.fit, one NCCL rank: steps {[round(x, 2) for x in step_ms]}"
        f" ms (steps 2 and 4 save); checkpoint {ckpt_bytes / 1e6:.1f} MB, "
        f"elastic.checkpoint_ms {[round(e['dur_ms'], 1) for e in saves]}, "
        f"elastic.restore_ms {[round(e['dur_ms'], 1) for e in restores]}; "
        f"losses {rec.losses}, resumed {resumed}; launches {counts}")
    out.update(step_ms=step_ms, saving_steps=[2, 4], losses=rec.losses,
               resumed_losses=resumed, resumed_bitwise=bitwise,
               resumed_loss_rel_err=worst, checkpoint_bytes=ckpt_bytes,
               checkpoint_ms=[e["dur_ms"] for e in saves],
               restore_ms=[e["dur_ms"] for e in restores], launches=counts)
    return counts, out


def _elastic_flat(params, state):
    """A hybrid trainer's parameters and Adam state as a flat checkpoint
    state: ``param/<group>/<name>``, ``opt/<group>/<name>/m`` and ``/v``
    (ZeRO-1's marked dp slices, or whole), ``opt/step``."""
    flat = {f"param/{k}": v for k, v in _flat(params).items()}
    for k, (m, v) in state["per_param"].items():
        flat[f"opt/{k}/m"], flat[f"opt/{k}/v"] = m, v
    flat["opt/step"] = np.asarray(state["step"], np.int64)
    return flat


def _elastic_rank_bytes(ckpt, rank, world, reading=False):
    """Bytes of the shard files that rank ``rank`` of a dp-only mesh of
    ``world`` ranks writes (a split leaf's shard ``rank``, rank 0 the whole
    ones) or, ``reading``, reads from a checkpoint of as many shards or
    more (the shards of its rows, every whole leaf)."""
    from paddle_tpu_torch.elastic import checkpoint as ec

    d = os.path.join(ckpt, f"step_{ec.latest_step(ckpt):08d}")
    total = 0
    for leaf in ec.load_manifest(ckpt)["leaves"]:
        shards = leaf["shards"]
        if len(shards) == 1:
            mine = shards if reading or rank == 0 else []
        else:
            per = len(shards) // world
            mine = shards[rank * per:(rank + 1) * per]
        total += sum(os.path.getsize(os.path.join(d, s["file"]))
                     for s in mine)
    return total


def elastic_ranks(seed, rank, out_dir):
    """Phase 26 (b), a rank of the 4-rank job (ZeRO-1 step, save) or of
    the 2-rank job (restore under dp2, the world-1 reference on rank 0,
    one dp2 step)."""
    import torch.distributed as tdist

    from paddle_tpu_torch.elastic import checkpoint as ec
    from paddle_tpu_torch.ops.kernels import config
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.parallel import mesh as M
    from paddle_tpu_torch.parallel.fleet import DistributedStrategy
    from paddle_tpu_torch.parallel.sharding import ShardingPlan, slice_spec
    from paddle_tpu_torch.text.ernie import ErnieConfig

    world = tdist.get_world_size()
    cfg0 = ErnieConfig(hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    seq, b, lr = TRAIN_SEQ, ELASTIC["reshard_batch"], ELASTIC["lr"]
    batch = pretrain_batch(np.random.default_rng(seed), b, seq,
                           cfg0.vocab_size, max(1, int(seq * 0.15)))
    strategy = DistributedStrategy()
    strategy.sharding = True
    ckpt = os.path.join(out_dir, "ckpt")
    m = M.build_mesh(M.MeshConfig(dp=world))
    M.set_mesh(m)
    plan = ShardingPlan(zero_stage=1)
    res = dict(fingerprint=plan.fingerprint())
    if world == 4:
        tr = _hybrid_trainer(cfg0, m, seed, 0, strategy)
        params = tr.place_params(tr.init_params())
        opt = Adam(learning_rate=lr)
        state = tr.init_opt_state(opt, params)
        step = tr.make_train_step(opt)
        config.reset_counts()
        params, state, loss = step(params, state, tr.place_batch(batch),
                                   torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        res.update(launches=config.launch_counts(), loss=float(loss))
        flat = _elastic_flat(params, state)
        slots = [k for k in flat if k.startswith("opt/") and k != "opt/step"]
        tdist.barrier()
        t0 = time.perf_counter()
        ec.save_checkpoint(ckpt, flat, 1, plan=plan, optimizer_slots=slots)
        res["save_ms"] = (time.perf_counter() - t0) * 1e3
        res["bytes"] = _elastic_rank_bytes(ckpt, rank, world)
        # read back on the same mesh: this rank's slices bit for bit
        got, meta = ec.restore_checkpoint(ckpt, plan=plan,
                                          optimizer_slots=slots)
        d = max(max_abs(torch.as_tensor(got[k]).to(DEV),
                        torch.as_tensor(v).to(DEV)) for k, v in flat.items())
        check(d == 0.0 and meta["resharded_leaves"] == 0,
              f"[elastic] rank {rank}: dp4 restore of its own dp4 save, "
              f"{len(got)} leaves bit for bit (largest difference {d}), "
              f"{meta['resharded_leaves']} resharded")
        res["split_moments"] = sum(1 for k in slots
                                   if slice_spec(flat[k]) is not None)
        return res

    # the 2-rank job
    names = [leaf["name"] for leaf in ec.load_manifest(ckpt)["leaves"]]
    slots = [k for k in names if k.startswith("opt/") and k != "opt/step"]
    tdist.barrier()
    t0 = time.perf_counter()
    got, meta = ec.restore_checkpoint(ckpt, plan=plan, optimizer_slots=slots)
    res["restore_ms"] = (time.perf_counter() - t0) * 1e3
    res["bytes"] = _elastic_rank_bytes(ckpt, rank, world, reading=True)
    # the _placement_sig rule on dp-only meshes: a leaf moves when it is
    # split on either side (dp's size goes 4 -> 2), not when it is whole
    # on both
    split = sum(1 for leaf in ec.load_manifest(ckpt)["leaves"]
                if leaf["spec"] or slice_spec(got[leaf["name"]]) is not None)
    res.update(resharded=meta["resharded_leaves"], split_either=split)
    check(meta["resharded_leaves"] == split,
          f"[elastic] rank {rank}: resharded_leaves "
          f"{meta['resharded_leaves']} = the {split} leaves split over dp4 "
          f"when saved or over dp2 when restored")
    whole = None
    if rank == 0:  # the world-1 rank restores with no plan
        t0 = time.perf_counter()
        whole, _ = ec.restore_checkpoint(ckpt)
        res["restore_whole_ms"] = (time.perf_counter() - t0) * 1e3
    worst = 0.0
    for k in names:   # every rank in the same order: the gathers match
        v = got[k]
        marked = slice_spec(v)
        if marked is not None:
            dim = next(i for i, a in enumerate(marked[0]) if a is not None)
            v = C.all_gather(v, group="dp", axis=dim)
        if rank == 0:
            worst = max(worst, max_abs(torch.as_tensor(v).cpu(),
                                       torch.as_tensor(whole[k])))
    if rank == 0:
        check(worst == 0.0, f"[elastic] dp2 restore of the dp4 checkpoint, "
              f"gathered: {len(names)} leaves equal the saved state bit for "
              f"bit (largest difference {worst})")
    step_count = int(torch.as_tensor(got["opt/step"]))
    gen = torch.Generator().manual_seed(seed + 1)
    ref = {}
    if rank == 0:  # the world-1 step from the restored whole state
        world1 = M.build_mesh(M.MeshConfig(devices=[0]))
        M.set_mesh(world1)
        tr1 = _hybrid_trainer(cfg0, world1, seed)
        p1 = tr1.place_params(_nested({k[6:]: torch.from_numpy(v)
                                       for k, v in whole.items()
                                       if k.startswith("param/")}))
        opt1 = _HybridCapture(Adam(learning_rate=lr))
        st1 = tr1.init_opt_state(opt1, p1)
        for k, (mo, vo) in st1["per_param"].items():
            mo.copy_(torch.from_numpy(whole[f"opt/{k}/m"]))
            vo.copy_(torch.from_numpy(whole[f"opt/{k}/v"]))
        st1["step"] = step_count
        p1, _, loss1 = tr1.make_train_step(opt1)(p1, st1, batch, gen)
        ref = dict(loss=loss1, new=_flat(p1), grads=opt1.grads)
        del tr1, st1, whole
        torch.cuda.empty_cache()
        M.set_mesh(m)
    tr = _hybrid_trainer(cfg0, m, seed, 0, strategy)
    params = tr.place_params(_nested({k[6:]: v for k, v in got.items()
                                      if k.startswith("param/")}))
    opt = Adam(learning_rate=lr)
    state = tr.init_opt_state(opt, params)
    wrong = [k for k, (mo, _) in state["per_param"].items()
             if mo.shape != got[f"opt/{k}/m"].shape]
    check(not wrong, f"[elastic] rank {rank}: every restored moment is the "
          f"dp2 step's slice ({wrong})")
    for k, (mo, vo) in state["per_param"].items():
        mo.copy_(got[f"opt/{k}/m"])
        vo.copy_(got[f"opt/{k}/v"])
    state["step"] = step_count
    del got
    config.reset_counts()
    params, state, loss = tr.make_train_step(opt)(
        params, state, tr.place_batch(batch),
        torch.Generator().manual_seed(seed + 1))
    torch.cuda.synchronize()
    res.update(launches=config.launch_counts(), loss=float(loss))
    if rank == 0:
        r = abs(float(loss) - float(ref["loss"])) / abs(float(ref["loss"]))
        check(r <= TOL_HYBRID_LOSS_REL, f"[elastic] dp2 step from the "
              f"restored state vs the world-1 step: loss {float(loss):.6f} "
              f"vs {float(ref['loss']):.6f}, rel err {r:.3g} <= "
              f"{TOL_HYBRID_LOSS_REL}")
        res["loss_rel_err"] = r
        res["step_err_lr"] = _zero_steps_agree(
            "[elastic] dp2 (ZeRO-1) step vs world 1", _flat(params),
            ref["new"], ref["grads"], lr)
    return res


def elastic_phase(seed):
    """Phase 26 (module docstring): (a) in this process, (b) the 4-rank and
    2-rank gloo jobs."""
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="elastic_phase_")
    try:
        fit_counts, out = elastic_fit_phase(seed, tmp)
        torch.cuda.empty_cache()
        t_jobs = time.perf_counter()
        _, four = _dp_job("elastic4", 4, tmp, seed, ELASTIC["timeout_s"])
        _, two = _dp_job("elastic2", 2, tmp, seed, ELASTIC["timeout_s"])
        t_end = time.perf_counter()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    L = ernie_cfg().num_hidden_layers
    reshard = {}
    for tag, ranks in (("dp4", four), ("dp2", two)):
        reshard[tag] = {k: sum(r["launches"].get(k, 0) for r in ranks)
                        for k in ERNIE_KERNELS}
        check_counts(f"[elastic] (b) the {tag} step summed over its "
                     f"{len(ranks)} ranks", reshard[tag],
                     {k: len(ranks) * v
                      for k, v in ernie_expect(L, False).items()})
    check(all(r["split_moments"] > 0 for r in four),
          f"[elastic] (b) the dp4 save held the Adam moments as dp slices "
          f"({[r['split_moments'] for r in four]} a rank)")
    log(f"[elastic] (b) fp32 ERNIE-base b{ELASTIC['reshard_batch']} "
        f"s{TRAIN_SEQ} ZeRO-1 on 4 gloo ranks, saved and restored on 2: "
        f"save {[round(r['save_ms'], 1) for r in four]} ms, written "
        f"{[round(r['bytes'] / 1e6, 1) for r in four]} MB a rank; restore "
        f"{[round(r['restore_ms'], 1) for r in two]} ms, read "
        f"{[round(r['bytes'] / 1e6, 1) for r in two]} MB a rank (whole, "
        f"no plan: {two[0]['restore_whole_ms']:.1f} ms); resharded "
        f"{two[0]['resharded']} leaves; dp2 step loss rel err "
        f"{two[0]['loss_rel_err']:.3g}, step err {two[0]['step_err_lr']} lr;"
        f" jobs {t_end - t_jobs:.1f} s")
    out["reshard"] = dict(
        dp4=[{k: v for k, v in r.items() if k != "times"} for r in four],
        dp2=[{k: v for k, v in r.items() if k != "times"} for r in two],
        launches=reshard, jobs_s=t_end - t_jobs)
    out["phase_s"] = time.perf_counter() - t_phase
    return fit_counts, reshard, out


def _pulled_rows():
    """A layer standing in for ``word_embeddings``: it returns the rows set
    on it for this step (pulled from the PS table), so autograd gives their
    gradient."""
    from paddle_tpu_torch import nn

    class PulledRows(nn.Layer):
        def __init__(self):
            super().__init__()
            self.rows = None

        def forward(self, ids):
            return self.rows

    return PulledRows()


def heter_ps_phase(seed):
    """Phase 27 (module docstring): ERNIE-base sentence classification with
    its word embeddings in a host PS table."""
    import tempfile

    import paddle_tpu_torch as P
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.distributed import ps as PS
    from paddle_tpu_torch.distributed.ps_server import (
        PSServer,
        RemoteSparseTable,
    )
    from paddle_tpu_torch.elastic.failover import (
        StandbyServer,
        TableSnapshotter,
    )
    from paddle_tpu_torch.ops.kernels import config

    t_phase = time.perf_counter()
    cfg = HETER
    rng = np.random.default_rng(seed + 27)
    quiet = ernie_cfg(hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    vocab, dim = quiet.vocab_size, quiet.hidden_size
    state = finetune_state(quiet, seed)
    dense = {k: v for k, v in state.items()
             if k != "ernie.embeddings.word_embeddings.weight"}
    model = finetune_model(quiet, state, seed)
    model.ernie.embeddings.word_embeddings = _pulled_rows()
    model.train()
    table = PS.SparseTable(dim=dim, num_shards=cfg["shards"],
                           optimizer="adagrad", seed=seed)
    primary = PSServer(table).start()
    remote = RemoteSparseTable([primary.endpoint], dim=dim)
    comm = PS.AsyncCommunicator(remote, lr=cfg["table_lr"])
    opt = P.optimizer.Adam(learning_rate=FINETUNE["lr"],
                           parameters=model.parameters())
    out = {"config": dict(cfg, vocab=vocab, dim=dim)}
    tmp = tempfile.mkdtemp(prefix="heter_ps_")
    standby = None
    try:
        # -- one step against the same model with a local embedding that
        # holds the pulled rows: loss, dense gradients, row gradients
        batch, _ = finetune_batch(rng, vocab)
        ids = batch[0].cpu().numpy()
        flat = ids.reshape(-1)
        before = remote.pull(flat)
        rows = torch.tensor(before, device=DEV, requires_grad=True)

        def ps_loss(rows, batch):
            """The loss with ``rows`` ([b * s, dim], the batch's ids in
            order) in place of the word-embedding lookup."""
            model.ernie.embeddings.word_embeddings.rows = rows.view(
                *batch[0].shape, dim)
            return finetune_loss(model, batch)

        with deterministic(), dygraph.guard():
            loss = ps_loss(rows, batch)
            loss.backward()
        g_rows = rows.grad.cpu().numpy()
        g_dense = {k: p.grad.detach().clone()
                   for k, p in model.named_parameters()}
        local = finetune_model(quiet, dense | {
            "ernie.embeddings.word_embeddings.weight":
                np.zeros((quiet.vocab_size, dim), np.float32)}, seed)
        with torch.no_grad():
            local.ernie.embeddings.word_embeddings.weight[
                torch.from_numpy(flat).to(DEV)] = rows.detach()
        local.train()
        with deterministic(), dygraph.guard():
            lloss = finetune_loss(local, batch)
            lloss.backward()
        uniq, merged = PS._merge_duplicate_ids(flat, g_rows)
        w_grad = local.ernie.embeddings.word_embeddings.weight.grad[
            torch.from_numpy(uniq).to(DEV)].cpu()
        row_err = max_abs(torch.from_numpy(merged), w_grad) / max(
            float(w_grad.abs().max()), 1e-30)
        d_dense = max(max_abs(g_dense[k], p.grad)
                      for k, p in local.named_parameters()
                      if k in g_dense)
        loss_same = float(loss.detach()) == float(lloss.detach())
        check(loss_same and d_dense == 0.0 and row_err <= TOL_HETER_ROW_REL,
              f"[heter-ps] a PS step against the local-embedding step: "
              f"loss {float(loss):.6f} vs {float(lloss):.6f}, dense "
              f"gradients bit for bit (largest difference {d_dense}), the "
              f"{len(uniq)} pushed rows merged as ps._merge_duplicate_ids "
              f"against the embedding's weight gradient: {row_err:.3g} of "
              f"the largest (<= {TOL_HETER_ROW_REL})")
        del local, g_dense
        torch.cuda.empty_cache()
        comm.start()
        comm.send(flat, g_rows)
        opt.minimize(loss)
        model.clear_gradients()
        comm.flush()
        # the table's rows after the push: sparse adagrad by hand (the
        # accumulator starts at 0: it is the merged gradient squared)
        after = remote.pull(uniq)
        first = {}
        for i, r in enumerate(flat):
            first.setdefault(int(r), before[i])
        hand = np.stack([first[int(r)] for r in uniq])
        hand -= cfg["table_lr"] * merged / (np.sqrt(merged * merged) + 1e-6)
        check(np.array_equal(after, hand),
              f"[heter-ps] after the flush the table's {len(uniq)} rows equal "
              f"a numpy sparse-adagrad update by hand, bit for bit (largest "
              f"difference {float(np.abs(after - hand).max())})")

        # -- timed steps: pull the batch's distinct rows, the dense step
        # on the card, push the rows' gradient through the communicator
        batches = [finetune_batch(rng, vocab) for _ in range(2)]
        timing = {"pull": [], "push": [], "step": []}

        def step(batch, timed=False):
            ids = batch[0].cpu().numpy()
            uniq, inv = np.unique(ids.reshape(-1), return_inverse=True)
            t0 = time.perf_counter()
            slab = torch.from_numpy(remote.pull(uniq)).to(DEV)
            t1 = time.perf_counter()
            slab.requires_grad_(True)
            with dygraph.guard():
                loss = ps_loss(slab[torch.from_numpy(inv).to(DEV)], batch)
                loss.backward()
                opt.minimize(loss)
                model.clear_gradients()
            t2 = time.perf_counter()
            comm.send(uniq, slab.grad.cpu().numpy())
            t3 = time.perf_counter()
            if timed:
                timing["pull"].append((t1 - t0) * 1e3)
                timing["push"].append((t3 - t2) * 1e3)
            return loss.detach(), len(uniq)

        _, counts = count_one(step, batches[0][0])
        check_counts("[heter-ps] a PS step", counts, FINETUNE_LAUNCHES,
                     only=True)
        losses, rows_a_step = [], []
        for i in range(cfg["steps"]):
            if i == cfg["warm"]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            loss, u = step(batches[i % 2][0], timed=i >= cfg["warm"])
            losses.append(loss)
            rows_a_step.append(u)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / (cfg["steps"] - cfg["warm"]) * 1e3
        comm.flush()
        prof = profile_split(lambda: step(batches[0][0]))
        comm.flush()
        losses = torch.stack(losses).tolist()
        check(all(np.isfinite(losses)), f"[heter-ps] losses finite: "
              f"{[round(x, 4) for x in losses]}")

        # -- failover: snapshot, the primary stops, the standby promotes
        # and serves the snapshot's rows bitwise, training carries on
        snap = os.path.join(tmp, "table.snap")
        TableSnapshotter(table, snap).snapshot_now()
        touched = table.state_dict()["ids"]
        expect_rows = remote.pull(touched)
        standby = StandbyServer(
            PS.SparseTable(dim=dim, num_shards=cfg["shards"],
                           optimizer="adagrad", seed=seed + 99),
            snapshot_path=snap, primary_endpoint=primary.endpoint,
            probe_interval_s=cfg["probe_s"],
            max_missed=cfg["max_missed"]).start()
        comm.stop()
        remote.close()
        t_stop, t_wall = time.perf_counter(), time.time()
        primary.stop()
        check(standby.wait_promoted(timeout=30), "[heter-ps] the standby "
              "promoted after the primary stopped")
        failover_ms = (time.perf_counter() - t_stop) * 1e3
        # its split from the flight events: each missed probe, and the
        # promotion (the snapshot replayed, the server started)
        evs = [e for kind in ("ps_probe_missed", "failover")
               for e in _flight(kind) if e["ts"] >= t_wall]
        failover_split = dict(
            missed_s=[e["ts"] - t_wall for e in evs
                      if e["kind"] == "ps_probe_missed"],
            promoted_s=[e["ts"] - t_wall for e in evs
                        if e["kind"] == "failover"])
        remote = RemoteSparseTable([standby.endpoint], dim=dim)
        got = remote.pull(touched)
        check(np.array_equal(got, expect_rows),
              f"[heter-ps] the standby serves the snapshot's {len(touched)} "
              f"rows bit for bit after {failover_ms:.1f} ms")
        comm = PS.AsyncCommunicator(remote, lr=cfg["table_lr"])
        comm.start()
        after_losses = [float(step(batches[i % 2][0])[0])
                        for i in range(cfg["after_failover"])]
        comm.flush()
        check(all(np.isfinite(after_losses)), f"[heter-ps] training "
              f"carries on against the standby: losses {after_losses}")
    finally:
        comm.stop()
        remote.close()
        primary.stop()
        if standby is not None:
            standby.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    timed = cfg["steps"] - cfg["warm"]
    pull_ms = sum(timing["pull"]) / timed
    push_ms = sum(timing["push"]) / timed
    log(f"[heter-ps] ERNIE-base fp32 b{FINETUNE['batch']} s{FINETUNE['seq']}"
        f", word embeddings ({vocab} x {dim}) in a "
        f"{cfg['shards']}-shard host table behind PSServer: step {ms:.2f} "
        f"ms, pull {pull_ms:.2f} ms, push {push_ms:.2f} ms, rows "
        f"{rows_a_step} a step (pulled and pushed), busy share "
        f"{prof['busy_ms'] / prof['wall_ms']:.3f}; failover {failover_ms:.1f}"
        f" ms (probes missed at {failover_split['missed_s']} s, promoted at "
        f"{failover_split['promoted_s']} s); launches {counts}")
    out.update(step_ms=ms, pull_ms=pull_ms, push_ms=push_ms,
               rows_a_step=rows_a_step, losses=losses,
               after_failover_losses=after_losses, failover_ms=failover_ms,
               failover_split=failover_split,
               row_grad_rel_err=row_err, loss_bitwise=loss_same,
               launches=counts, profile=prof,
               busy_share=prof["busy_ms"] / prof["wall_ms"],
               phase_s=time.perf_counter() - t_phase)
    del model, opt
    torch.cuda.empty_cache()
    return counts, out


def timed(phase, *args):
    """``phase(*args)``, its seconds logged as ``[time] <name>``: the
    script's whole run has a time limit (1200 s), and this is where it
    goes."""
    t0 = time.perf_counter()
    out = phase(*args)
    log(f"[time] {phase.__name__} {time.perf_counter() - t0:.1f} s")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dp-worker", nargs=2, metavar=("MODE", "OUT"),
                    help="run as a rank of phase 24's jobs (the port's "
                    "launcher starts these)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only "
              "on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.dp_worker:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return dp_worker(*args.dp_worker, args.seed)
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.ops.kernels import conv_fused as cf
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import flash_attention_packed as fap
    from paddle_tpu_torch.ops.kernels import int8 as i8
    from paddle_tpu_torch.ops.kernels import layer_norm as ln
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f} s wall: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    for name in secs:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    # (library, its wgmma opcode, the mma.sync opcode it must not have):
    # HGMMA / HMMA for bf16, IGMMA / IMMA for s8
    for name, wgmma, mma in ((fa.SOURCE, "HGMMA", None),
                             (fa.SOURCE_BWD, "HGMMA", None),
                             (cf.SOURCE, "HGMMA", "HMMA"),
                             (i8.CONV_SOURCE, "IGMMA", "IMMA"),
                             (i8.MATMUL_SOURCE, "IGMMA", "IMMA")):
        sass = subprocess.run(
            [os.path.join(os.path.dirname(build._nvcc()), "cuobjdump"),
             "-sass", str(build.library_path(name))],
            capture_output=True, text=True, check=True).stdout
        n = len(re.findall(rf"\b{wgmma}\b", sass))
        check(n > 0, f"{name}: {n} {wgmma} (wgmma) instructions in its SASS")
        if mma:
            n = len(re.findall(rf"\b{mma}\b", sass))
            check(n == 0, f"{name}: {n} {mma} (mma.sync) instructions in "
                  f"its SASS")

    stats_profile()
    # phases 17-20 before the first CUDA graph capture: the card's profiler
    # loses eager launches after one, and phases 18-20 profile their steps
    t_phase = time.perf_counter()
    ops_out = ops_phase(args.seed)
    finetune_counts, finetune = finetune_phase(args.seed)
    torch.cuda.empty_cache()
    t_tagging = time.perf_counter()
    tagging_counts, tagging = tagging_phase(args.seed)
    t_rnn = time.perf_counter()
    rnn = lac_phase(args.seed)
    t_hapi = time.perf_counter()
    torch.cuda.empty_cache()
    hapi_counts, hapi_out = hapi_phase(args.seed)
    t_end = time.perf_counter()
    tagging["phase_s"], rnn["phase_s"] = t_rnn - t_tagging, t_hapi - t_rnn
    log(f"[phases 17-20, 23] {t_end - t_phase:.1f} s: ops and dygraph "
        f"{t_tagging - t_phase:.1f} s, tagging {t_rnn - t_tagging:.1f} s, "
        f"rnn {t_hapi - t_rnn:.1f} s, hapi {t_end - t_hapi:.1f} s")
    torch.cuda.empty_cache()
    resnet = resnet_phase(args.seed)
    torch.cuda.empty_cache()
    t_yolo = time.perf_counter()
    yolo = yolo_phase(args.seed)
    torch.cuda.empty_cache()
    t_vision = time.perf_counter()
    resnet["phase_s"], yolo["phase_s"] = t_yolo - t_end, t_vision - t_yolo
    log(f"[phases 21-22] {t_vision - t_end:.1f} s: resnet "
        f"{t_yolo - t_end:.1f} s, yolo {t_vision - t_yolo:.1f} s")
    gen = torch.Generator().manual_seed(args.seed)
    results = timed(kernel_phase, gen)
    at_train = timed(train_shape_phase, gen)
    serve_counts, fwd_ms = timed(slice_phase, args.seed)
    per_fwd = {"flash_attention_packed": 12, "residual_layer_norm": 24,
               "layer_norm": 2}
    share = {k: results[(k, torch.bfloat16)]["ms"] * n / fwd_ms
             for k, n in per_fwd.items()}
    log("[slice] share of the bf16 b8 s512 forward's device time: "
        + ", ".join(f"{k} {v:.3f}" for k, v in share.items()))
    counts, train = timed(train_phase, args.seed)
    torch.cuda.empty_cache()
    log("[bhsd] (b, h, s, d) kernels against their plain versions")
    bhsd, cross = timed(bhsd_kernel_phase, gen)
    bhsd_counts, bhsd_model = timed(bhsd_model_phase, args.seed,
                                    train["tokens_per_s"])
    torch.cuda.empty_cache()
    paged, paged_server = timed(paged_kernel_phase, gen, args.seed)
    paged_launches, paged_slice = timed(paged_slice_phase, args.seed)
    torch.cuda.empty_cache()
    vision = timed(vision_kernel_phase, gen)
    vision_counts, static_out = timed(static_phase, args.seed)
    torch.cuda.empty_cache()
    train_counts, vision_train = timed(vision_train_phase, args.seed)
    torch.cuda.empty_cache()
    bn_cases, int8_cases = timed(int8_kernel_phase, gen, vision)
    int8_counts, int8_out = timed(int8_phase, args.seed)
    torch.cuda.empty_cache()
    cold, cold_rows = timed(cold_phase, args.seed)
    torch.cuda.empty_cache()
    qat_counts, float_counts, static_train = timed(static_train_phase,
                                                   args.seed)
    torch.cuda.empty_cache()
    recipe_counts, recipe = timed(recipe_phase, args.seed)
    torch.cuda.empty_cache()
    seq2seq_counts, seq2seq = timed(seq2seq_phase, args.seed)
    torch.cuda.empty_cache()
    dyq_counts, ptq_counts, dygraph_quant = timed(dygraph_quant_phase,
                                                  args.seed)
    torch.cuda.empty_cache()
    dp_counts, dp_out = timed(dp_phase, args.seed, train["step_ms"])
    torch.cuda.empty_cache()
    hybrid_counts, hybrid_mesh_counts, hybrid_out = timed(
        hybrid_phase, args.seed, train["step_ms"])
    torch.cuda.empty_cache()
    elastic_counts, reshard_counts, elastic_out = timed(elastic_phase,
                                                        args.seed)
    torch.cuda.empty_cache()
    heter_counts, heter_out = timed(heter_ps_phase, args.seed)
    torch.cuda.empty_cache()

    kernels = []
    for k in fap.KERNELS + ln.KERNELS:
        r = results[(k.name, torch.bfloat16)]
        r32 = results[(k.name, torch.float32)]
        entry = {
            "name": k.name, "route": "cuda",
            "source": f"paddle_tpu_torch/ops/kernels/csrc/{k.source}.cu",
            "replaces": k.replaces, "launches": counts.get(k.name, 0),
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            "dtype": "bfloat16", "eager_ms": r["eager_ms"],
            "fp32_ms": r32["ms"], "fp32_max_abs_err": r32["err"],
            "launches_per": "train step",
            "train_shape_ms": at_train[k.name]["ms"],
            "train_shape_bound_ms": at_train[k.name]["bound"][0],
            "train_shape_max_abs_err": at_train[k.name]["err"]}
        if "library_ms" in at_train[k.name]:
            entry["train_shape_library_ms"] = at_train[k.name]["library_ms"]
        if (k.name, torch.float32) in at_train:
            entry["train_shape_fp32_ms"] = \
                at_train[(k.name, torch.float32)]["ms"]
        if "library_eager_ms" in r:
            entry.update(library_timing="torch.profiler device time",
                         library_eager_ms=r["library_eager_ms"])
        if k.name in serve_counts:
            entry["serving_launches"] = serve_counts[k.name]
        if "dropout_ms" in r:
            entry.update(dropout=RATE, dropout_ms=r["dropout_ms"],
                         dropout_plain_ms=r["dropout_plain_ms"],
                         dropout_max_abs_err=r["dropout_err"])
        if k.name.endswith("_bwd"):
            entry["dropout"] = RATE if k.name != ln.LN_BWD else 0.0
        kernels.append(entry)
    for k in fa.KERNELS:
        kind = "bwd" if k.name == fa.KERNEL_BWD else "fwd"
        r = bhsd[("ERNIE-base", torch.bfloat16, kind)]
        r32 = bhsd[("ERNIE-base", torch.float32, kind)]
        entry = {
            "name": k.name, "route": "cuda",
            "source": f"paddle_tpu_torch/ops/kernels/csrc/{k.source}.cu",
            "replaces": k.replaces, "launches": bhsd_counts.get(k.name, 0),
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            "library": f"F.scaled_dot_product_attention "
                       f"({r['library_backend']} backend)",
            "dtype": "bfloat16", "shape": "b8 h12 s512 d64", "eager_ms":
            r["eager_ms"], "fp32_ms": r32["ms"], "fp32_max_abs_err":
            r32["err"], "launches_per": "train step (split-head route)",
            "train_shape_ms": at_train[k.name]["ms"],
            "train_shape_bound_ms": at_train[k.name]["bound"][0],
            "train_shape_max_abs_err": at_train[k.name]["err"],
            "cases": [dict(case=label, dtype=dtag(dtype), ms=x["ms"],
                           plain_ms=x["plain_ms"],
                           library_ms=x["library_ms"],
                           bound_ms=x["bound"][0], bound_by=x["bound"][1],
                           max_abs_err=x["err"])
                      for (label, dtype, kd), x in bhsd.items()
                      if kd == kind]}
        for key in ("dropout", "dropout_ms", "library_eager_ms"):
            if key in r:
                entry[key] = r[key]
        if kind == "bwd":
            entry["library_timing"] = "torch.profiler device time"
        if kind == "fwd":
            entry["serving_launches"] = \
                bhsd_model["serving"]["launches"].get(k.name, 0)
        kernels.append(entry)
    p32 = paged[torch.float32]
    entry = {
        "name": pa.KERNEL, "route": "cuda",
        "source": f"paddle_tpu_torch/ops/kernels/csrc/{pa.SOURCE}.cu",
        "replaces": pa.REPLACES, "launches": paged_launches,
        "max_abs_err": p32["err"], "ms": p32["ms"],
        "plain_ms": p32["plain_ms"], "bound_ms": p32["bound"][0],
        "bound_by": p32["bound"][1], "library_ms": p32["library_ms"],
        "library": "F.scaled_dot_product_attention on K/V gathered "
                   "beforehand (gather excluded)",
        "dtype": "float32", "eager_ms": p32["eager_ms"],
        "launches_per": "paged slice run (96 requests)"}
    for dtype, r in paged.items():
        t = {torch.float32: "fp32", torch.bfloat16: "bf16"}.get(dtype, "int8")
        entry.update({f"{t}_ms": r["ms"], f"{t}_max_abs_err": r["err"],
                      f"{t}_bound_ms": r["bound"][0],
                      f"{t}_plain_ms": r["plain_ms"],
                      f"{t}_library_ms": r["library_ms"]})
    # the paged server's own launches: decode64_ms / chunk64_ms (fp32) and
    # the same per cache type, each beside its bound and SDPA
    for (name, dtype), r in paged_server.items():
        t = {torch.float32: "", torch.bfloat16: "bf16_"}.get(dtype, "int8_")
        entry.update({f"{t}{name}_ms": r["ms"],
                      f"{t}{name}_bound_ms": r["bound"][0],
                      f"{t}{name}_bound_by": r["bound"][1],
                      f"{t}{name}_library_ms": r["library_ms"],
                      f"{t}{name}_plain_ms": r["plain_ms"],
                      f"{t}{name}_max_abs_err": r["err"]})
    kernels.append(entry)
    kernels += vision_entries(vision, vision_counts)
    kernels += new_entries(bn_cases, train_counts, int8_cases, int8_counts)
    check(len(kernels) == 15, f"the kernels line lists {len(kernels)} "
          f"kernels, one for each of the 15 TPU kernels")
    # this slice's path: the QAT-frozen VGG-16's int8 forward (rows 15, 14
    # and 13) and its float test program under DEFAULT_PIPELINE (rows 10
    # and 13), each counted from 0 around one forward
    path = {cf.KERNEL: float_counts.get(cf.KERNEL, 0),
            i8.CONV_KERNEL: qat_counts.get(i8.CONV_KERNEL, 0),
            i8.MATMUL_KERNEL: qat_counts.get(i8.MATMUL_KERNEL, 0),
            "max_pool2d": qat_counts.get("max_pool2d", 0)}
    for entry in kernels:
        if entry["name"] in path:
            entry["static_train_launches"] = path[entry["name"]]
            entry["static_train_launches_per"] = (
                "float test forward of the trained vgg16_bn_drop "
                "([static train], b128)" if entry["name"] == cf.KERNEL else
                "QAT-frozen vgg16_bn_drop int8 forward ([static train], "
                "b128)")
            check(path[entry["name"]] > 0, f"{entry['name']}: "
                  f"{path[entry['name']]} launches on the static-train path")
        cold_cases = [r for r in cold.values() if r["name"] == entry["name"]]
        if cold_cases:
            entry["cold_cases"] = cold_cases
            entry["cold_forward"] = [r for r in cold_rows
                                     if r["name"] == entry["name"]]
    # this slice's paths: each recipe mode, Transformer-base, the QAT
    # step and the PTQ forward, each counted from 0 around one step
    slice_paths = {f"recipe_{m}_launches": c for m, c in
                   recipe_counts.items()}
    slice_paths.update(seq2seq_launches=seq2seq_counts,
                       qat_launches=dyq_counts, ptq_launches=ptq_counts,
                       finetune_launches=finetune_counts,
                       tagging_launches=tagging_counts)
    for entry in kernels:
        if entry["name"] in ERNIE_KERNELS:
            for key, c in slice_paths.items():
                entry[key] = c.get(entry["name"], 0)
        # phase 23's path: launches a fit step, an evaluate / predict batch
        entry["hapi_launches"] = hapi_counts["fit"].get(entry["name"], 0)
        entry["hapi_eval_launches"] = hapi_counts["evaluate"].get(
            entry["name"], 0)
        entry["hapi_predict_launches"] = hapi_counts["predict"].get(
            entry["name"], 0)
        # phase 24's path: one data-parallel step in the world-1 rank
        entry["dp_launches"] = dp_counts.get(entry["name"], 0)
        # phase 25's paths: one world-1 hybrid step, and one step of each
        # mesh summed over its four ranks
        entry["hybrid_launches"] = hybrid_counts.get(entry["name"], 0)
        entry["hybrid_mesh_launches"] = {
            name: c.get(entry["name"], 0)
            for name, c in hybrid_mesh_counts.items()}
        # phase 26's paths: (a) the 4-step fit, (b) one step of the dp4
        # and of the dp2 job summed over its ranks; phase 27's: a PS step
        entry["elastic_fit_launches"] = elastic_counts.get(entry["name"], 0)
        entry["elastic_reshard_launches"] = {
            tag: c.get(entry["name"], 0) for tag, c in reshard_counts.items()}
        entry["heter_ps_launches"] = heter_counts.get(entry["name"], 0)
        # phases 21-22's paths launch no port kernel (checked there)
        entry["resnet_launches"] = resnet["port_kernel_launches"].get(
            entry["name"], 0)
        entry["yolo_launches"] = yolo["port_kernel_launches"].get(
            entry["name"], 0)
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"bhsd": dict(bhsd_model, kernel_a_max_abs_err=cross)}),
          flush=True)
    print(json.dumps({"paged": paged_slice}), flush=True)
    print(json.dumps({"static": static_out}), flush=True)
    print(json.dumps({"vision_train": vision_train}), flush=True)
    print(json.dumps({"int8": int8_out}), flush=True)
    print(json.dumps({"cold": {"cases": list(cold.values()),
                               "forward": cold_rows}}), flush=True)
    print(json.dumps({"static_train": static_train}), flush=True)
    print(json.dumps({"recipe": recipe}), flush=True)
    print(json.dumps({"seq2seq": seq2seq}), flush=True)
    print(json.dumps({"dygraph_quant": dygraph_quant}), flush=True)
    print(json.dumps({"ops": ops_out}), flush=True)
    print(json.dumps({"dygraph": finetune}), flush=True)
    print(json.dumps({"tagging": tagging}), flush=True)
    print(json.dumps({"rnn": rnn}), flush=True)
    print(json.dumps({"resnet": resnet}), flush=True)
    print(json.dumps({"yolo": yolo}), flush=True)
    print(json.dumps({"hapi": hapi_out}), flush=True)
    print(json.dumps({"dp": dp_out}), flush=True)
    print(json.dumps({"hybrid": hybrid_out}), flush=True)
    print(json.dumps({"elastic": elastic_out}), flush=True)
    print(json.dumps({"heter_ps": heter_out}), flush=True)
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


_T_MODULE_END = time.time()

if __name__ == "__main__":
    sys.exit(main())
