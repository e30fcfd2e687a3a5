#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card: serve the decoder-transformer LM,
train it at full width through DataParallelTrainer, train its vocabulary
head through runtime-compiled user kernels, serve and train ResNet-50 v1 at
bench.py's shape, then sweep the array surface and train, checkpoint,
resume and serve ResNet-50 v1 from its file, then hold the rest of the
model zoo and of the op library against the CPU, serve AlexNet, VGG-16 and
Inception-v3 and train AlexNet, then train the symbolic ResNet-50 through
Module.fit, serve it through Server(module=), and run the LM's attention
layer as a Symbol through the Executor, then train BASELINE configs 1 and
2 and the LM through the single-card KVStore, and profile the LM and
ResNet-50 with mx.profiler, then run those paths through mx.engine.bulk,
then feed ResNet-50 from train_imagenet.py's RecordIO path and the LM from
a gluon.data DataLoader, then hold the fused RNN op's cuDNN route against
its plain loop and train and serve bench_lstm.py's LSTM LM, word_lm.py's
loop, CTC, an LSTM encoder under B1 and mx.rnn through BucketingModule,
then run them hybridized, then train BASELINE config 5 (sparse linear
classification) at 1,000,000 features through sparse arrays and the store,
then train BASELINE config 2 and the LM across ranks through the dist
stores and DataParallelTrainer, and BASELINE config 1 over several
contexts in one process, then ring attention, pipeline and expert
parallelism across two ranks, then Faster R-CNN, R-FCN's deformable head,
FlowNetC's correlation and the samplers, and a calibrated INT8 ResNet-50.

Run from the root of a checkout, with one CUDA card and the CUDA toolkit:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:

1. device  — the card's name and power limit (nvidia-smi), or exit non-zero
             when torch sees no CUDA device;
2. build   — every hand-written kernel of the port, from ``csrc/`` with nvcc
             (one per source, all at once), and the launcher of runtime
             kernels (``csrc/rtc_launch.c``, a CPython extension, with the
             host C compiler), with ptxas's report (registers,
             shared memory, spills) and the count of HGMMA (wgmma)
             instructions in the SASS of the bf16, f16 and f32 forward
             kernels, of the wide kernels (route A in bf16 and f16, route B)
             and of the bf16 and f16 backward kernels (dQ, dK/dV), none of
             which may be 0: every route runs on the tensor cores;
3. kernel  — each kernel against its plain PyTorch version on the card, at
             the shapes of its tests and of the serving path and at head dims
             160, 192 and 256, and 320 and 512 (the wide routes: A in bf16
             and f16, B in f32), in f32, bf16 and f16; bf16 and f16 also
             element by element (2^-8·|ref| + 5e-5, 2^-11·|ref| + 5e-5);
             the f32 route's split pass bit for bit; mixes of dtypes (the
             f32 route, and route B above D = 256, q's dtype out); flash
             attention's backward against torch autograd through the plain
             version in f32, TF32 off: the backward kernel
             in bf16 and f16 at the training shape and at Sq < Sk, Sq > Sk,
             Sk = 65, D = 20 and 64 (each through the kernel: its launch
             count moved, the torch ops' did not), the torch ops at small
             f32 shapes and D = 320;
4. serve   — small LMs on the card against the same weights on the CPU, with
             the same greedy tokens: f32 at D = 16 (the f32 route), f16 at
             D = 128 (the f16 route), bf16 and f32 at D = 256 (two output
             slices a block on the 16-bit and the f32 route), f32 and bf16
             at D = 320 (routes B and A), each route's launch count zeroed
             just before and read just after, none 0, and the wide count
             equal to the layers at D = 320 and 0 below; then
             the LM of bench_transformer.py at its full width (vocab 16384,
             d_model 4096, 32 heads, d_ffn 16384, 4 layers, seq 1024; random
             weights from a seed) answering 4 requests of 8 prompts x 1024
             tokens with each prompt's greedy next token; the kernels' launch
             counts are zeroed just before and read just after; then one more
             request under torch.profiler for its device time by kernel;
4f. serve  — the serving runtime on the same net: ``mx.serving.Server``
             (max_batch 8, max_wait 5 ms) loads LastToken(LM) (the last
             position's bf16 logits and their argmax), captures one CUDA
             graph per bucket 1, 2, 4, 8 (capture seconds, pool bytes),
             answers 32 requests of 1024 tokens from 4 closed-loop client
             threads (each row bit-equal to the bucket-1 program, the SLO
             components summing exactly to each request's wall; batch
             sizes, p50/p99, tokens/s, component means), swaps to a second
             version (HostXavier(SEED + 1), bf16) mid-traffic (every
             response entirely one version's, monotonic per client),
             evicts and reloads (bit-equal, same version), serves one
             fused pass (the probe's verdict; no delivered row differs
             from the bucket-1 program), traces one exact bucket-8 replay
             (32 flash_fwd_sm90_kernel launches; busy and idle share) and
             runs ``python -m incubator_mxnet_tpu_torch.serving --selftest``;
4e. serve  — the same LM with BENCH_HEADS=8 (D = 512, the same parameter
             shapes) in bf16 answering 2 requests of 8 x 1024 tokens, every
             attention through route A (4 launches a request, counted with
             the counters zeroed just before and read just after), each
             request's ms beside the D = 128 model's;
4d. train — the small f32 LM trained 3 steps through DataParallelTrainer on
             the card against the same 3 steps on the CPU (weights within
             1e-4, losses within 1e-5 relative); then the same LM at full
             width, uncut, trained as bench_transformer.py:147-170 trains it:
             DataParallelTrainer, SoftmaxCrossEntropyLoss, SGD with momentum
             0.9 at lr 0.05, bf16 compute with f32 master weights, batch 8 x
             1024 tokens from np.random.RandomState(0); 3 warm-up steps,
             then TRAIN_STEPS timed steps with the kernels' counts zeroed
             just before and read just after: each step's ms and loss,
             tokens/s, MFU (bench_transformer.py's model_flops_per_step over
             989 TFLOP/s), peak memory; it fails unless every loss is finite
             and the last below the first, and unless every flash backward
             of the timed steps went through the backward kernel (4 a step,
             none through the torch ops); then one step under
             torch.profiler, by group (GEMMs, flash forward, flash backward,
             optimizer update, the rest) with the idle share;
4c. rtc   — the user kernels of RTC_SOURCE compiled by the port's NVRTC
             binding (mx.rtc.CudaModule, sm_90a); axpy against 2x + y
             (exact); 3 SGD steps of the LM's vocabulary head at full width
             (8192 tokens x 4096 -> 16384, f32) through FullyConnected, the
             custom op rtc_softmax (softmax_fwd, softmax_bwd) and
             sgd_update, held step by step against the same steps with the
             plain versions, launch counts zeroed just before and read just
             after; each kernel's time, bound, plain and library times at
             the head shape; the host cost of one CudaKernel.launch (noop,
             no arguments; axpy, 4) in rounds, in turns with one torch.neg,
             the same launches written plainly over ctypes and the floor
             (cuLaunchKernel of noop in a loop from C), and the parts of
             axpy's launch, each alone;
5. timing  — the flash kernel at the serving shape: its time, its bound, the
             plain version's time and one PyTorch library call's time, in
             bf16 (the serving path), f16, and on the f32 route (with the
             split pass and the attention kernel also timed alone); at
             (8, 16, 1024, 256) causal on the bf16 and f32 routes; the wide
             routes at (8, 8, 1024, 512) causal (the serving shape's work at
             D = 512) in bf16, f16 (route A) and f32 (route B, with its split
             pass and attention kernel also alone), each beside SDPA, with
             the design's floor (the tensor work its walk issues at 989
             TFLOP/s); the backward kernel at the training
             shape beside the torch ops it replaced, the plain version and
             SDPA's backward, with the card's bound and the design's floor;
6. resnet  — ResNet-50 v1 of the model zoo, whose path reaches no hand
             kernel (convolutions on cuDNN, TF32 off in f32; Pooling and
             BatchNorm in torch ops):
             6a: resnet50_v1(thumbnail=True, classes=10), batch 4 of 32x32,
             the same seeded weights on the card and on the CPU: the
             inference forward, the training-mode forward and loss in f32
             with torch's TF32 default on (within 1e-4; the same forward
             with TF32 convolutions must break that bound, and both errors
             are printed), then 3 DataParallelTrainer steps in f32 and in
             bf16 compute, each taken on the card from the CPU's state
             before it (loss, running statistics, every update and
             momentum);
             6b: resnet50_v1(classes=1000) in bf16, inference mode, batch 32
             of 3x224x224 (BASELINE.md:17), one warm-up and 4 timed
             batches: ms a batch, img/s, peak memory, the bf16 logits
             against the f32 net's, and one batch under torch.profiler by
             group (cuDNN convolutions, layout transposes, BatchNorm,
             relu/add, pooling, other) with the idle share;
             6c: bench.py's training run (:199-211): resnet50_v1(classes=
             1000), Xavier, DataParallelTrainer with SoftmaxCrossEntropyLoss,
             SGD momentum 0.9 at lr 0.1, bf16 compute over f32 master
             weights, batch 256 of 3x224x224 from np.random.RandomState(0);
             3 warm-up and 5 timed steps on the same batch: step ms (mean,
             spread), img/s, MFU (the convolutions' and the dense layer's
             flop counted from the net's own shapes, x3, over 989 TFLOP/s),
             peak memory; it fails unless every loss is finite, the last
             below the first, and the running statistics moved and stayed
             finite; then one step under torch.profiler by group (adding
             cuDNN dgrad/wgrad and the optimizer update);
7. arrays  — the array surface and checkpoints, which launch no hand
             kernel:
             7a: every op of ops/math.py, ops/tensor.py and ops/init_ops.py
             that this slice ports, on CUDA tensors against the port's CPU
             result for the same seeded numpy inputs, forward and backward,
             in f32, bf16 and int32 (elementwise, broadcast and reduction
             ops at (1024, 4096), dot at (1024, 4096)·(4096, 4096),
             batch_dot at (32, 1024, 128)·(32, 128, 1024)), each at its
             bound in ulps (SWEEP_ULP; data movement, indexing, ordering and
             integer results bit-equal), each call and backward under torch's
             sync-debug mode "error"; every alias resolving to its op; int32
             mod and power at their edge values; the creation ops; one line
             per family;
             7b: resnet50_v1(classes=1000) in f32 trained through the plain
             Gluon loop (record, SoftmaxCrossEntropyLoss, backward,
             gluon.Trainer.step(64): sgd lr 0.1, momentum 0.9, wd 1e-4,
             MultiFactorScheduler(step=[2, 4], factor=0.1)) on a batch of
             64 x 3x224x224 from np.random.RandomState(0): run A takes 3
             steps, save_params and save_states, then steps 4-6; run B, a
             net of another seed and a fresh Trainer, load_params and
             load_states, then steps 4-6: the state after loading and the
             step-4 loss bit-equal to A's, the learning rates and
             num_update equal, steps 5-6 within CKPT_LOSS_REL and
             CKPT_WEIGHT_REL, and each tensor whose RMS is at least
             CKPT_LIVE_RMS of the net's within CKPT_TENSOR_REL; a third net loads A's file from its bytes
             (nd.load_buffer, serving's load_params_bytes) and its logits on
             a batch of 32 are bit-equal to A's; file sizes, save and load
             seconds and A's step ms;
8. zoo     — the rest of the vision zoo and of the op library, which
             launch no hand kernel:
             8a: alexnet, vgg11, vgg11_bn, squeezenet1_0/1_1, densenet121,
             mobilenet0_25 (224x224) and inception_v3 (299x299), classes
             10, on the card against the CPU from the same seeded f32
             weights, batch 2, inference mode, TF32 off (ZOO_REL); alexnet's
             training-mode forward bit-equal after the same mx.random.seed
             and different under another;
             8b: alexnet, vgg16 and inception_v3 (classes=1000) in bf16,
             batch 32 (BASELINE.md:13-16): ms a batch, img/s, peak memory,
             the bf16 logits against the f32 net's (ZOO_BF16_REL), one batch
             profiled by group; alexnet behind mx.serving.Server(max_batch
             8): 16 one-image requests from 2 client threads, every row
             bit-equal to the bucket-1 program;
             8c: alexnet(classes=1000) in f32 trained by the plain Gluon
             loop at batch 256 (BASELINE.md:27), Trainer 'nag' (lr 0.01,
             momentum 0.9, wd 1e-4), dropout live: step ms, img/s, MFU,
             peak memory, the loss finite and falling, one step profiled by
             group; every other optimizer of the slice 2 steps from one
             saved state, finite losses, every tensor moved;
             8d: the nn ops at AlexNet's and Inception's activation shapes
             (7a's harness, f32 and bf16), bilinear UpSampling, the update
             ops at fc6's shape and the optimizers on bf16 weights through
             multi_precision, the losses at (256, 1000), the linalg ops on
             64 stacked 256x256 matrices and fft/ifft at (256, 4096), the
             deterministic initializers: CUDA against CPU, forward and
             backward, under sync-debug mode "error" (syevd, which waits
             for the card, outside it);
             8e: 2^24 draws of each sampler on the card: moments, KS
             against scipy's CDF, multinomial chi-square, shuffle, dropout's
             keep share, values and gradient, rrelu's slopes, every draw
             bit-equal after the same seed with torch's default generators
             reseeded;
9. sym     — the symbolic path and the Module API (mx.sym, the Executor,
             mx.mod.Module, mx.serving.Server(module=)):
             9a: the symbolic ResNet-50 v1 (a copy over mx.sym of
             example/image-classification/symbols/resnet.py, classes 1000)
             on the card against the CPU from the same seeded f32 weights,
             simple_bind at batch 2, inference, TF32 off (ZOO_REL); the
             executor's output bit-equal to sym.eval through nd calls;
             infer_shape and infer_type of the whole graph on meta tensors
             under sync-debug mode "error" with no device memory allocated;
             9b: Module.fit of that symbol at batch 256 of 3x224x224 f32
             (sgd lr 0.05, momentum 0.9, wd 1e-4, Xavier(magnitude=2),
             eval_metric "acc"; example/image-classification/common.py:32-50)
             over 6 NDArrayIter batches made as train_imagenet.py's
             synthetic_iters makes them: step ms (mean and std after 3
             warm-up steps), img/s, MFU (6c's flop count over 989 TFLOP/s),
             peak memory, one step profiled by group; a witness: each step
             run again in plain PyTorch (F.conv2d, F.batch_norm, autograd,
             sgd with momentum written out) from the Module's weights
             before it, its loss within 1e-4 of the Module's and its new
             weights within f32 rounding of the step's move (0.1 overall,
             0.25 of a tensor's); the loss falling (the first batch's,
             again after the epoch, below its first step's); one BatchNorm
             layer's moving statistics after a training forward against
             MXNet's blend recomputed in f64 (1e-5); save_checkpoint,
             Module.load into a fresh Module and score: the same accuracy
             and one batch's outputs bit-equal;
             9d: the trained module behind mx.serving.Server(max_batch=8)
             through srv.load(module=): 16 one-image requests from 2 client
             threads, every row bit-equal to the bucket-1 program and within
             ZOO_REL of Module.predict, p50/p99 and the capture seconds;
             9c: the LM's attention layer as a Symbol at bench_transformer.
             py's width (d_model 4096, 32 heads, D = 128, batch 8 x 1024,
             bf16, simple_bind(type_dict=bfloat16)): one forward and
             backward through the Executor, its output and every gradient
             bit-equal to the same ops run eagerly under autograd.record();
             flash_attention's forward and backward-kernel counters (zeroed
             just before, read just after) at 1 each and its torch-ops
             backward count at 0; ms a forward+backward;
10. kv    — 10a: ``mx.kv.create("device")`` on the card: push of three
             arrays and pull into two outs bit-equal to the sum in torch
             (f32, bf16); ``set_optimizer`` updates bit-equal to the updater
             applied by hand; the optimizer's states through a file; the
             later items' paths raise; 10b: BASELINE config 1
             (train_mnist.py's MLP and LeNet, as symbols through
             ``fit_module`` and as Gluon nets through ``fit_gluon``, copies
             of example/image-classification/common.py's wiring) with a
             ``"device"`` store, each step's weights bit-equal to the run
             without a store; 10c: BASELINE config 2 (train_imagenet.py on
             synthetic_iters: ResNet-50 v1 f32 at batch 256 through
             ``fit_gluon``, ``symbol_convnet`` through ``fit_module``), the
             same; 10d: the full-width LM in bf16 through
             ``gluon.Trainer(kvstore=mx.kv.create("device"))``, the update
             on the store, equal after every step to a Trainer without a
             store, B1's forward and backward kernels once per layer a step;
             10e: ``mx.profiler`` over one LM request and one 10d step with
             ``sync=True``: the flash kernel rows inside their op's span;
             the host split of an eager op (the LM request, ResNet-50 bf16
             at batch 32); an LM request with the profiler stopped;
11. bulk  — ``mx.engine.bulk`` on the card (segments recorded and replayed
             as CUDA graphs; ``flush_stats()`` and ``cache_sizes()`` after
             each part): the graphs' contracts at a small size (a capture,
             replays bit-equal to eager, a new input address, outputs that
             survive the next replay, draws bit-equal to eager ones, a
             backward graph); 11a bench_eager.py's chains (eager, bulk(65),
             bulk(256), the view chain, the recorded training chain), bit-
             equal, one flush a scope and no capture in the timed loop,
             ops/s; 11b 4b's LM request (run beside 4b on its net),
             ResNet-50 v1 and Inception-v3 bf16 at batch 32 under bulk(64)
             and bulk(n), bit-equal to eager, ms a batch and one replay's
             trace (the LM's: one flash_fwd_sm90_kernel row a layer); 11c
             the LM step (bf16) and ResNet-50 f32 b64 as one recorded
             segment, one flush (autograd), losses bit-equal, gradients
             compared, the step's trace (B1's forward kernel in the forward
             graph and again in the backward graph's recompute, its
             backward kernel); 11d one case per op of 7a's sweep captured
             and replayed, bit-equal to eager, the ops registered not
             deferrable listed; 11e the symbolic ResNet-50 cut at stage 3
             into two Modules under SequentialModule, weights bit-equal to
             one Module after each of 3 steps, PythonLossModule after the
             MLP of 10b, print_summary's total; 11f autograd.get_symbol of
             the LM's attention layer through the Executor, equal to eager,
             B1's forward and backward kernels once each;
12. data  — the data plane (RecordIO, mx.image, ImageRecordIter,
             gluon.data), its host work on the card's CPU: 12a the native
             RecordIO library built from src/io/recordio.cc, its files
             byte-identical to the Python framing's and read across, the
             prefetch reader, one pipeline with ctx=gpu(0) and ctx=cpu(0)
             bit-equal, imdecode's MXNetError naming OpenCV where cv2 is
             absent; 12b train_imagenet.py's record path (:80-101) over
             1,280 raw 224² records: one epoch drained with no model, the
             first batch's loss through ResNet-50 bit-equal to NDArrayIter's,
             then fit_gluon (10c's wiring) for 5 steps fed by it: step ms,
             img/s, the share of a step in next(), the copy's ms, beside
             10c's synthetic step; 12c the augmenting pipeline over 512
             raw 256² records (crop, flip, jitter, lighting, normalize) at
             preprocess_threads 1, 4 and 8 against 6c's step; 12d gluon.data
             (RandomResizedCrop, flip, ToTensor, Normalize) through a
             DataLoader of 4 workers, img/s; ToTensor, Normalize and Resize
             on the card against the CPU, the pipeline with num_workers=0
             over the card's and the CPU's copy of the images, a
             DataLoader(num_workers=2) feeding steps inside mx.engine.bulk;
             12e the full-width LM trained 3 steps from a
             DataLoader(num_workers=2), its losses equal to the same steps
             fed directly, B1's forward and backward kernels once a layer a
             step; what is left out without OpenCV is printed;
13. rnn   — the RNN family (no hand kernel of its own: cuDNN through
             ``torch._cudnn_rnn``, as MXNet's GPU path): 13a the fused RNN
             op in every mode, uni- and bidirectional, 2 layers, f32 (TF32
             off) and bf16 at (T, N, I, H) (7, 3, 5, 4) and bench_lstm.py's
             (128, 256, 512, 512), f16 at the first, out, hy, cy and every
             gradient against the plain loop in f64 (1e-4 f32, 2e-2 bf16,
             5e-3 f16 relative, or twice the plain loop's own error in the
             dtype where the recurrence amplifies rounding past that), each
             case's route counted; cuDNN and the plain loop timed forward and
             forward+backward beside the bound, and the per-call copy of
             the weights into cuDNN's buffer; TF32 off inside an f32 call
             whatever the caller's switch, record(train_mode=False) then
             backward, an LSTM inside mx.engine.bulk bit-equal to eager;
             13b the small WordLM (f32) trained 3 steps on the card against
             the CPU (1e-4), then bench_lstm.py's WordLM at full width
             (vocab 10000, embed and hidden 512, 2 layers, NTC, 256 x 128
             tokens, bf16 through DataParallelTrainer, sgd lr 0.5): 3
             warm-up and 10 timed steps, ms, tokens/s, MFU, peak memory,
             the loss falling, every LSTM call on cuDNN; 13c the same net
             in bf16 serving 32 x 128 tokens: ms, tokens/s, device busy
             time; 13d word_lm.py's loop at its defaults (adam, the state
             carried across BPTT windows, 6 epochs) below the unigram
             perplexity; 13e CTCLoss at (200, 32, 29) with labels of 20-50
             tokens and 4 empty, card against CPU (1e-4), timed; 13f a
             bidirectional LSTM encoder under MultiHeadAttention (head dim
             128) trained 3 bf16 steps: B1's forward and backward kernels
             once a step, none through the torch ops; 13g a FusedRNNCell
             LM through BucketingModule.fit over BucketSentenceIter, and
             unfuse() against the fused node (1e-4); the phase's seconds;
14. hybrid — Gluon ``hybridize()`` as CUDA graphs (CachedOp) and the SSD
             ops (``hybrid_phase``);
15. sparse — sparse storage, no hand kernel (``sparse_phase``): 15a the
             casts between dense, row-sparse and CSR of a (8192, 1,000,000)
             CSR batch and a (1,000,000, 1) weight, retain, CSR·dense,
             CSRᵀ·dense and their backward, add_n, the lazy updates with and
             without momentum, wd and clipping, each against the port's CPU
             path (structure and elementwise results bit-equal, a product
             element within 2(n-1)·2^-24·Σ|terms| of its n terms), each
             timed beside dense torch and torch's sparse layouts; 15b
             BASELINE config 5 (example/sparse's loop: LibSVMIter,
             row_sparse_pull, sparse.dot, the row-sparse push to the
             store's sgd) at 1,000,000 features and batch 8192 over 65,536
             Zipf rows written from the seed, 3 epochs: the loss falls, the
             weights match a dense plain rerun within its carried bound,
             untouched rows bit-equal, ms a step by part, one step's busy
             time; 15c sparse .params records bit-equal through the card,
             rand_ndarray's densities; 15d the lazy update inside
             mx.engine.bulk bit-equal to eager; 15e ROADMAP C11 (a failed
             capture leaves mx.random usable, for a CachedOp and a bulk
             segment);
16. dist  — several devices and processes (``dist_phase``; the ranks are
             processes of this script started through tools/launch.py,
             ``dist_worker``, and a rank that fails fails the smoke): 16a
             two ranks on the card under dist_sync (gloo): a push's sum,
             several keys and dtypes in one push, integer sums exact, the
             row-sparse union, dist_async with SGD on rank 0's parameter
             server, barrier, a (2^24,) f32 all-reduce timed, and
             dist_device_sync refusing ranks that share a card; then one
             rank a card under dist_device_sync (NCCL), the same
             all-reduce; 16b BASELINE config 2 (train_imagenet.py's
             ResNet-50 v1, f32, global batch 256 as 2 x 128) through
             Module.fit(kvstore="dist_sync") and a hybridized
             gluon.Trainer(kvstore="dist_sync"), one warm-up and 1 timed
             step: step ms, img/s, the all-reduce's ms and bytes, peak
             memory a rank, the ranks' weights bit-equal, and the Module's
             within a measured bound of a one-process run of the same two
             halves; 16c the full-width LM (1 of its 4 layers) as 2 ranks
             x 4 x 1024 tokens through DataParallelTrainer over
             worker_mesh() (bf16): step
             ms, tokens/s, the all-reduce's ms and bytes, B1's forward and
             backward kernels once a layer a step on each rank, the loss
             falling, the ranks' master weights bit-equal; 16d BASELINE
             config 1's MLP and LeNet through Module over [gpu(0), cpu(0)]
             with a "device" store, within 1e-4 of max |w| of the
             one-context run after the first step, 2e-2 after 2 epochs;
             16e (two cards or more) 16d over every card and 16b, 16c under
             dist_device_sync, one rank a card, else a line saying why not;
17. par   — ring attention, pipeline and expert parallelism over two
             ranks sharing the card over gloo (``parallel_phase``, one
             launch of ``par_task``): 17a the axis collectives on card
             tensors bit-equal to the host's answers; 17b the full-width
             LM (2 of its 4 layers) with every attention on "sp" through
             DataParallelTrainer over {"dp": 1, "sp": 2} (bf16), the
             ranks bit-equal, its
             first update of the weights against a flash witness's, one
             MHA layer against flash; 17c PipelineTrainer over {"pp": 2}
             (B1's f32 route in every stage) against the unpipelined
             step; 17d ExpertParallelMoE(16384, 4) over {"ep": 2}, dense
             and capacity dispatch on each rank's experts against one
             rank's dense layer, tokens dropped as a host recount says,
             then adam over {"dp": 1, "ep": 2}; 17e (two cards or more)
             the same under NCCL, else a line saying why not;
18. det   — the detection, sampling and INT8 ops (no hand kernel;
             ``detection_phase``): 18a Faster R-CNN (ResNet-50-C4, the
             RPN, MultiProposal at proposal.cc's defaults, ROIPooling then
             ROIAlign at 14 x 14, res5 and the heads) on two 600 x 1000
             images, f32: request, Proposal and ROI-op ms, peak memory;
             the trunk and RPN within 1e-4 of the CPU, Proposal on the
             card's RPN outputs bit for bit the CPU's, the head and d feat
             through each ROI op on 32 ROIs within 1e-4; 18b R-FCN: a
             deformable convolution (512 filters, dilate 2, 4 groups) on
             (2, 512, 38, 63), PSROIPooling and DeformablePSROIPooling
             (21 x 7 x 7) over 18a's ROIs, forward and backward within
             1e-4 / 1e-5 of the CPU; 18c Correlation at FlowNetC's width
             (441 channels), the warp sampler, a SpatialTransformer on (32,
             3, 224, 224) and Crop, each within 1e-5 of the CPU; 18d
             ResNet-50 v1 folded and calibrated (naive, entropy) into one
             int8 chain on the card: its census, top-1 agreement with f32,
             ms a batch of 32 in f32, bf16 and int8, every int8 and int32
             intermediate of a batch bit for bit the CPU's;
19. one JSON ``kernels`` line (the hand kernels of phases 2-5, and the
   launches of B1 in 9c, 10d, 11, 12e, 13f, 14d, 16c, 17b and 17c; phases
   6-8, 15 and 18 launch none), each phase's seconds and the whole run's,
   then the card's name and power limit, and last ``{"ok": true,
   "device": {...}}``.

It imports nothing of JAX or of the JAX package.
"""
import contextlib
import gc
import json
import logging
import math
import os
import random
import re
import shutil
import subprocess
import sys
import threading
import time
import weakref

import numpy as np

H100_BF16_FLOPS = 989e12     # dense tensor-core peak (NVIDIA data sheet)
H100_F32_CUDA_CORE_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12
SEED = 0

# (shape (B, H, Sq, Sk, D), causal): the kernel's test shapes and the
# serving shape, which is last
ATTENTION_CASES = [
    ((2, 4, 256, 256, 64), False),
    ((2, 4, 256, 256, 64), True),
    ((1, 2, 128, 256, 64), True),    # Sq < Sk: the causal diagonal moves right
    ((1, 2, 256, 128, 64), True),    # Sq > Sk: 128 rows see no key at all
    ((1, 3, 40, 40, 24), False),     # ragged: no dimension a multiple of 64
    ((1, 3, 40, 40, 24), True),
    ((8, 8, 256, 256, 128), False),  # 13f's encoder (MultiHeadAttention)
    ((2, 4, 32, 32, 16), True),      # the small LM of phase 4a
    ((8, 32, 1024, 1024, 128), True),
]
# head dims past 128: two output slices a block column on every route
WIDE_CASES = [
    ((1, 2, 200, 200, 160), True),
    ((2, 2, 130, 130, 192), False),
    ((2, 4, 512, 512, 256), True),
]
# head dims above 256: the wide routes (csrc/flash_attention_wide_sm90.cu),
# route A in bf16 and f16, route B in f32, with the main path's shape (phase
# 4e and WIDER_TIMING: 16 key tiles, 16 row blocks) last; one mix of its own
# (route B), q's dtype out
WIDER_CASES = [
    ((1, 2, 200, 200, 320), True),
    ((2, 2, 130, 150, 512), True),   # Sq < Sk, ragged tiles, four slices
    ((1, 2, 150, 100, 320), True),   # Sq > Sk: 50 rows see no key
    ((8, 8, 1024, 1024, 512), True),
]
WIDE_MIXED = (("float16", "bfloat16", "float32"), (1, 2, 96, 160, 320))
# mixes of dtypes (q, k, v): the f32 route, q's dtype out
MIXED_CASES = [(("bfloat16", "float32", "float16"), (2, 3, 256, 320, 96)),
               (("float32", "bfloat16", "bfloat16"), (1, 2, 200, 200, 256))]
# kernel vs plain, max abs error. f32: both sum the same products in f32 in
# other orders (|o| <= ~4, D <= 256, Sk <= 1024), a few ulp of 4, far below
# 1e-4. bf16 (f16): the plain result is computed in f32 from the same
# 16-bit inputs, and the kernel rounds its f32 result once: half an ulp at
# |o| < 4 is 7.8e-3 (9.8e-4), within 2e-2 (2e-3).
TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-3}
# bf16, element by element against the f32 plain result: one bf16 rounding
# (2^-9 relative) and as much again for the f32 arithmetic (f16: 2^-11). P
# rounded to the type once before P·V breaks it at many elements (the
# negative controls of tests/test_torch_attention.py); the kernel's split
# P_hi + P_lo must break it nowhere.
BF16_REL, BF16_ABS = 2.0 ** -8, 5e-5
HALF_REL = {"bfloat16": BF16_REL, "float16": 2.0 ** -11}
# small LMs on the card against the CPU (phase 4a): (name, dtype, widths,
# the launch counter of their route, max abs error bound as ulps of the
# dtype at max |CPU logits| (f32: absolute))
SMALL_LMS = [
    ("f32_d16", "float32", dict(vocab=97, d_model=64, n_heads=4, d_ffn=256,
                                n_layers=2, seq_len=32), "f32_launches", None),
    ("f16_d128", "float16", dict(vocab=97, d_model=256, n_heads=2, d_ffn=512,
                                 n_layers=2, seq_len=32), "f16_launches", 16),
    ("bf16_d256", "bfloat16", dict(vocab=97, d_model=512, n_heads=2,
                                   d_ffn=1024, n_layers=2, seq_len=32),
     "launches", 8),
    ("f32_d256", "float32", dict(vocab=97, d_model=512, n_heads=2, d_ffn=1024,
                                 n_layers=2, seq_len=32), "f32_launches",
     None),
    ("f32_d320", "float32", dict(vocab=97, d_model=640, n_heads=2, d_ffn=1280,
                                 n_layers=2, seq_len=32), "wide_f32_launches",
     None),
    ("bf16_d320", "bfloat16", dict(vocab=97, d_model=640, n_heads=2,
                                   d_ffn=1280, n_layers=2, seq_len=32),
     "wide16_launches", 8),
]
# flash attention's backward on the card against torch autograd through the
# plain version in f32 with TF32 off: (shape (B, H, Sq, Sk, D), causal,
# dtype).  f32 (the torch ops): the same products in other orders, within
# 1e-4.  bf16 and f16 (the backward kernel; the training shape first): both
# compute in f32, but the kernel starts from the 16-bit output (delta =
# sum(g·out)), carries P and dS as two halves of the type and rounds each
# gradient once, so the bound is 2^-7 of the largest |gradient|
BACKWARD_CASES = [
    ((8, 32, 1024, 1024, 128), True, "bfloat16"),
    ((8, 32, 1024, 1024, 128), True, "float16"),
    ((8, 8, 256, 256, 128), False, "bfloat16"),  # 13f's encoder
    ((8, 8, 256, 256, 128), False, "float16"),
    ((1, 2, 128, 256, 64), True, "bfloat16"),    # Sq < Sk
    ((1, 2, 128, 256, 64), True, "float16"),
    ((1, 2, 256, 128, 64), True, "bfloat16"),    # Sq > Sk: rows see no key
    ((1, 2, 256, 128, 64), True, "float16"),
    ((2, 2, 65, 65, 64), True, "bfloat16"),      # Sk = 65: a ragged tile
    ((2, 2, 65, 65, 64), True, "float16"),
    ((1, 2, 77, 77, 20), True, "bfloat16"),      # D = 20, padded to 24
    ((1, 2, 77, 77, 20), True, "float16"),
    ((1, 2, 128, 256, 64), True, "float32"),     # the torch ops from here
    ((1, 2, 256, 128, 64), True, "float32"),
    ((2, 2, 65, 65, 32), True, "float32"),       # Sk = 65: one ragged chunk
    ((1, 2, 200, 200, 320), True, "float32"),    # D = 320, the wide forward
]
BACKWARD_F32_TOL = 1e-4
BACKWARD_BF16_REL = 2.0 ** -7
# the full-width training run: bench_transformer.py's LM and step (:147-170)
LM_CONFIG = dict(vocab=16384, d_model=4096, n_heads=32, d_ffn=16384,
                 n_layers=4, seq_len=1024)
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 8, 3, 5
TRAIN_OPT = {"learning_rate": 0.05, "momentum": 0.9}
SMALL_TRAIN_STEPS = 3
# card vs CPU, the small f32 LM's 3 training steps: the same f32 operations
# (TF32 off) in other orders, a few f32 ulps a step
SMALL_TRAIN_W_TOL, SMALL_TRAIN_LOSS_RTOL = 1e-4, 1e-5
MANTISSA = {"bfloat16": 7, "float16": 10}
FLASH_DESIGN = ("bf16: wgmma m64n64k16 for S = Q·Kᵀ (shared-memory operands) "
                "and for O += P_hi·V + P_lo·V (P from registers, V "
                "transposed), S of tile t issued with P·V of tile t-1, TMA "
                "3-stage K/V ring with mbarriers, 1 producer warp + 2 "
                "consumer warpgroups, 128 query rows x 64 keys a tile")
F32_DESIGN = ("f32: a split pass writes three bf16 planes (h, m, l) of "
              "q·scale, k and v from their strides; then wgmma m64n64k16, six "
              "products (lh, hl, mm, mh, hm, hh) for S = Q·Kᵀ and six for "
              "O += P·V with P split into three bf16 pieces in registers; Q's "
              "planes resident, K and V through an 8-slot TMA ring of "
              "(tile, plane) slots on mbarriers, 1 producer warp + 2 consumer "
              "warpgroups, 128 query rows x 64 keys a tile, S, softmax and "
              "P·V in turn in each warpgroup")
F16_DESIGN = ("f16: the bf16 kernel's template instantiated for __half: "
              "wgmma m64n64k16 .f16, TMA maps of FLOAT16, P split into two "
              "f16 halves (f16 x f16 products exact in f32)")
WIDE_DESIGN = ("bf16 at head dims 129-256: Q and K in four 64-column panels "
               "(three up to 192), one block per 128 output columns (grid "
               "z): S over the full D, O over the block's slice, 64 f32 "
               "registers of O a thread as at D = 128; 208 KB of shared "
               "memory at D = 256")
F32_WIDE_DESIGN = ("f32 at head dims 129-256: 64 query rows and one consumer "
                   "warpgroup a block (Q's three planes 96 KB at D = 256), "
                   "one block per 128 output columns, a four-slot ring of "
                   "32 KB (K plane) slots, 224 KB of shared memory")
BWD_DESIGN = ("bf16 and f16 backward over the row stats (m, 1/l) the "
              "forward kernel keeps when training; two kernels without "
              "atomics: dQ with queries outer (delta = sum(g·out) first, "
              "then S = Q·Kᵀ, dP = g·Vᵀ, dQ += dS_hi·K + dS_lo·K, K and V "
              "through a 3-stage TMA ring); "
              "dK and dV with keys outer, one 64-column output slice a block "
              "(Sᵀ = K·Qᵀ, dPᵀ = V·gᵀ, dV += Pᵀ_hi·g + Pᵀ_lo·g, dK += "
              "dSᵀ_hi·Q + dSᵀ_lo·Q, Q, g and their row stats through the "
              "ring); P and dS only in registers, 1 producer warp + 2 "
              "consumer warpgroups, 128 rows x 64 a tile")
BF16_SOURCE = "incubator_mxnet_tpu_torch/csrc/flash_attention_sm90.cu"
F32_SOURCE = "incubator_mxnet_tpu_torch/csrc/flash_attention_f32_sm90.cu"
BWD_SOURCE = "incubator_mxnet_tpu_torch/csrc/flash_attention_bwd_sm90.cu"
# the (mangled) kernel names cuobjdump lists, by route
HGMMA_FUNCTIONS = {"bf16": "flash_fwd_sm90_kernelI13__nv_bfloat16",
                   "f16": "flash_fwd_sm90_kernelI6__half",
                   "f32": "flash_fwd_f32_sm90_kernel",
                   "wide16_bf16": "flash_fwd_wide16_kernelI13__nv_bfloat16",
                   "wide16_f16": "flash_fwd_wide16_kernelI6__half",
                   "wide_f32": "flash_fwd_wide_f32_kernel",
                   "bwd_dq_bf16": "flash_bwd_dq_kernelI13__nv_bfloat16",
                   "bwd_dkdv_bf16": "flash_bwd_dkdv_kernelI13__nv_bfloat16",
                   "bwd_dq_f16": "flash_bwd_dq_kernelI6__half",
                   "bwd_dkdv_f16": "flash_bwd_dkdv_kernelI6__half"}
# the head dim 256 timing shape (B, H, Sq, Sk, D), causal
WIDE_TIMING = ((8, 16, 1024, 1024, 256), True)
# the wide routes' timing shape: the serving shape's work at D = 512
WIDER_TIMING = ((8, 8, 1024, 1024, 512), True)
WIDER_SOURCE = "incubator_mxnet_tpu_torch/csrc/flash_attention_wide_sm90.cu"
WIDE16_DESIGN = ("route A, bf16 and f16 at head dims above 256: 64 query rows "
                 "and 256 output columns (3 or 4 panels) a block, one "
                 "consumer warpgroup (255-register cap) + 1 producer warp; "
                 "wgmma m64n64k16 for S over 64-column panels of K streamed "
                 "through a ring of 8 KB slots (Q resident up to D = 768, "
                 "streamed beside K above; 16 slots, 27 when streamed), a "
                 "commit group a panel with up to 5 (kLag) in flight; O += "
                 "P_hi·V + P_lo·V from registers, the softmax of tile t "
                 "beside P·V of tile t-1")
WIDE_F32_DESIGN = ("route B, f32 and mixes at head dims above 256: the split "
                   "pass's three bf16 planes, 64 query rows and 256 output "
                   "columns a block, one consumer warpgroup; S in two walks "
                   "over the head-dim panels (the five small products, then "
                   "hh), Q's plane h resident up to D = 768 beside a 16-slot "
                   "ring of 8 KB panels (27 slots when it streams), planes m "
                   "and l streamed; O += P·V with six products, P in three "
                   "pieces in registers")
# the LM served at head dim 512 (phase 4e): bench_transformer.py's widths
# with BENCH_HEADS=8, the same parameter shapes; route A, 4 launches a request
WIDE_LM_HEADS, WIDE_LM_REQUESTS = 8, 2
# phase 4f: the serving runtime's requests (1024 tokens each), closed-loop
# client threads and batch buckets
SERVE_REQUESTS, SERVE_CLIENTS, SERVE_BUCKETS = 32, 4, (1, 2, 4, 8)
# flash_attention's launch counters: all routes, then those of head dims
# above 256
WIDE_COUNTERS = ("launches", "wide_launches", "wide16_launches",
                 "wide_f32_launches")
RTC_DESIGNS = {
    "softmax_fwd": ("one block per row; where c % 4 == 0 and the row fits, "
                    "the row read once as float4 into registers (SOFTMAX_VEC "
                    "a thread), block max, expf in registers, block sum, "
                    "float4 stores of e / s; else a three-pass loop in the "
                    "same kernel"),
    "softmax_bwd": ("a wide row a block of up to 1024 threads, narrow rows "
                    "several (softmax_bwd_geometry), copied as float4 with "
                    "BWD_VEC loads a thread in flight, then one fix-up a row "
                    "by the thread that stored column label: p - 1.0; a "
                    "scalar loop where c % 4 != 0 or a base is unaligned"),
    "axpy": ("float4 loads and stores, AXPY_VEC float4 of x and y a thread "
             "in flight, grid-stride; a scalar tail for n % 4 and for "
             "unaligned bases"),
}


# The rtc phase's user kernels: CUDA C that the port compiles at run time
# with NVRTC for sm_90a (mx.rtc.CudaModule), the counterpart of the JAX
# build's runtime Pallas kernels (incubator_mxnet_tpu/rtc.py:86), whose one
# user kernel is the axpy of tests/test_rtc_resume.py.  softmax_fwd and
# softmax_bwd are the forward and backward of the custom op "rtc_softmax",
# a softmax output with the gradient p - onehot(label) (upstream MXNet's
# example/numpy-ops/custom_softmax_rtc.py).  Each is bound by memory bytes
# on this card: one pass of reads and writes at 3.35 TB/s, the head's 1.07
# GB far past the 50 MB L2, so all three stream.  axpy reads x and y and
# writes o as float4, AXPY_VEC float4 of each input in flight a thread
# before its stores; n % 4 elements, and every element when a base is not
# 16-byte aligned, take a scalar loop; axpy_geometry(n) picks its grid.
# softmax_bwd copies p into dz the same way, a wide row by a block of up to
# 1024 threads with BWD_VEC float4 each in flight (narrow rows several to
# a block; softmax_bwd_geometry(c)), and applies the one-hot as one fix-up
# a row: the thread that stored column label[row] stores p - 1.0 there
# after its own float4 store, so no element is compared; rows with
# c % 4 != 0 or unaligned bases take a scalar loop in the same kernel.
# Plain loads and stores: streaming cache hints (__ldcs, __stcs) and
# blocks of 256 threads over several wide rows were slower on the card.  softmax_fwd takes
# one block per row and reads the row from memory once: where c % 4 ==
# 0, the bases are 16-byte aligned and the row fits the block's registers
# (SOFTMAX_VEC float4 a thread), each thread loads its slice as float4 into
# registers, and the block reduces the max (warp shuffles, then one value per
# warp in shared memory), turns its registers into expf(z - m), reduces the
# sum and stores e / s as float4.  Every other row width takes the three-pass
# loop of the same kernel (max, sum, write, each reading the row again from
# L2).  softmax_geometry(c) picks the block for both.  noop measures the
# host cost of one launch.
RTC_SOURCE = r"""
#define SOFTMAX_VEC 8
#define AXPY_VEC 4
#define BWD_VEC 2

// o = 2x + y over n elements as float4, AXPY_VEC float4 of x and of y a
// thread in flight before its stores, over a grid-stride loop; the last
// n % 4 elements (all n when a base is unaligned) by a scalar loop
extern "C" __global__ void axpy(const float *x, const float *y, float *o,
                                int n) {
    const bool vec = (((size_t)x | (size_t)y | (size_t)o) & 15) == 0;
    const long long n4 = vec ? n / 4 : 0;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long j0 = (long long)blockIdx.x * blockDim.x * AXPY_VEC +
                        threadIdx.x; j0 < n4; j0 += stride * AXPY_VEC) {
        float4 a[AXPY_VEC], b[AXPY_VEC];
#pragma unroll
        for (int u = 0; u < AXPY_VEC; ++u) {
            const long long j = j0 + (long long)u * blockDim.x;
            if (j < n4) {
                a[u] = ((const float4 *)x)[j];
                b[u] = ((const float4 *)y)[j];
            }
        }
#pragma unroll
        for (int u = 0; u < AXPY_VEC; ++u) {
            const long long j = j0 + (long long)u * blockDim.x;
            if (j < n4)
                ((float4 *)o)[j] = make_float4(
                    2.0f * a[u].x + b[u].x, 2.0f * a[u].y + b[u].y,
                    2.0f * a[u].z + b[u].z, 2.0f * a[u].w + b[u].w);
        }
    }
    for (long long i = 4 * n4 + (long long)blockIdx.x * blockDim.x +
                       threadIdx.x; i < n; i += stride)
        o[i] = 2.0f * x[i] + y[i];
}

__device__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// the max (is_max) or the sum of v over the block, returned to every thread
__device__ float block_reduce(float v, bool is_max, float *scratch) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const float neutral = is_max ? -3.402823466e38f : 0.0f;
    v = is_max ? warp_max(v) : warp_sum(v);
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = lane < (int)(blockDim.x >> 5) ? scratch[lane] : neutral;
        v = is_max ? warp_max(v) : warp_sum(v);
        if (lane == 0) scratch[32] = v;
    }
    __syncthreads();
    v = scratch[32];
    __syncthreads();
    return v;
}

__device__ float max4(float4 v) {
    return fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
}

// p = softmax(z) over each row of c columns; one block per row
extern "C" __global__ void softmax_fwd(const float *z, float *p, int c) {
    __shared__ float scratch[33];
    const float *row = z + (size_t)blockIdx.x * c;
    float *out = p + (size_t)blockIdx.x * c;
    if ((c & 3) == 0 && c <= 4 * SOFTMAX_VEC * (int)blockDim.x &&
            (((size_t)z | (size_t)p) & 15) == 0) {
        // the row in registers: float4 j of the row is x[i] of thread
        // j % blockDim.x, i = j / blockDim.x
        const float4 *row4 = (const float4 *)row;
        float4 *out4 = (float4 *)out;
        const int n4 = c >> 2;
        float4 x[SOFTMAX_VEC];
        float m = -3.402823466e38f;
#pragma unroll
        for (int i = 0; i < SOFTMAX_VEC; ++i) {
            const int j = threadIdx.x + i * blockDim.x;
            if (j < n4) {
                x[i] = __ldg(row4 + j);
                m = fmaxf(m, max4(x[i]));
            }
        }
        m = block_reduce(m, true, scratch);
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < SOFTMAX_VEC; ++i) {
            if (threadIdx.x + i * blockDim.x < n4) {
                x[i] = make_float4(expf(x[i].x - m), expf(x[i].y - m),
                                   expf(x[i].z - m), expf(x[i].w - m));
                s += (x[i].x + x[i].y) + (x[i].z + x[i].w);
            }
        }
        s = block_reduce(s, false, scratch);
#pragma unroll
        for (int i = 0; i < SOFTMAX_VEC; ++i) {
            const int j = threadIdx.x + i * blockDim.x;
            if (j < n4)
                out4[j] = make_float4(x[i].x / s, x[i].y / s, x[i].z / s,
                                      x[i].w / s);
        }
        return;
    }
    float m = -3.402823466e38f;
    for (int j = threadIdx.x; j < c; j += blockDim.x) m = fmaxf(m, row[j]);
    m = block_reduce(m, true, scratch);
    float s = 0.0f;
    for (int j = threadIdx.x; j < c; j += blockDim.x) s += expf(row[j] - m);
    s = block_reduce(s, false, scratch);
    for (int j = threadIdx.x; j < c; j += blockDim.x)
        out[j] = expf(row[j] - m) / s;
}

// dz = p - onehot(label) over rows of c columns, ceil(rows / gridDim.x)
// rows a block: each row copied as float4, BWD_VEC float4 a thread in
// flight before its stores (a scalar loop where c % 4 != 0 or a base is
// unaligned); then the thread that stored column label[row] stores
// p - 1.0f there, after its own store of that element
extern "C" __global__ void softmax_bwd(const float *p, const float *label,
                                       float *dz, int rows, int c) {
    const bool vec = (c & 3) == 0 && (((size_t)p | (size_t)dz) & 15) == 0;
    const int per = (rows + gridDim.x - 1) / gridDim.x;
    const int r_end = min(rows, (int)(blockIdx.x + 1) * per);
    for (int r = blockIdx.x * per; r < r_end; ++r) {
        const size_t base = (size_t)r * c;
        if (vec) {
            const float4 *src = (const float4 *)(p + base);
            float4 *dst = (float4 *)(dz + base);
            const int n4 = c >> 2;
            for (int j0 = threadIdx.x; j0 < n4; j0 += BWD_VEC * blockDim.x) {
                float4 v[BWD_VEC];
#pragma unroll
                for (int u = 0; u < BWD_VEC; ++u)
                    if (j0 + u * (int)blockDim.x < n4)
                        v[u] = src[j0 + u * blockDim.x];
#pragma unroll
                for (int u = 0; u < BWD_VEC; ++u)
                    if (j0 + u * (int)blockDim.x < n4)
                        dst[j0 + u * blockDim.x] = v[u];
            }
        } else {
            for (int j = threadIdx.x; j < c; j += blockDim.x)
                dz[base + j] = p[base + j];
        }
        // the owner of column l: float4 l / 4 (element l) went to thread
        // (l / 4) % blockDim.x (l % blockDim.x) of the loops above
        const int l = (int)label[r];
        if (l >= 0 && l < c &&
                threadIdx.x == (vec ? (l >> 2) : l) % blockDim.x)
            dz[base + l] = p[base + l] - 1.0f;
    }
}

extern "C" __global__ void noop() {}
"""
RTC_SIGNATURES = {
    "axpy": "const float *x, const float *y, float *o, int n",
    "softmax_fwd": "const float *z, float *p, int c",
    "softmax_bwd": ("const float *p, const float *label, float *dz, "
                    "int rows, int c"),
    "noop": "",
}
RTC_KERNELS = ("axpy", "softmax_fwd", "softmax_bwd")
SOFTMAX_THREADS = 512


def _define(name):
    return int(re.search(r"#define %s (\d+)" % name, RTC_SOURCE).group(1))


# float4 a thread holds on softmax_fwd's one-read path, and keeps in flight
# in axpy and softmax_bwd (RTC_SOURCE's own)
SOFTMAX_VEC, AXPY_VEC, BWD_VEC = (_define(n) for n in
                                  ("SOFTMAX_VEC", "AXPY_VEC", "BWD_VEC"))
SOFTMAX_MAX_THREADS = 1024
AXPY_THREADS = 256
BWD_THREADS = 1024
# about this many elements of p a softmax_bwd block copies (rows x c)
BWD_BLOCK_ELEMENTS = 1 << 14
AXPY_N = 2 ** 26
# the LM's vocabulary head at full width: 8 x 1024 tokens of d_model 4096
# into vocab 16384 (bench_transformer.py's LM), f32
HEAD = dict(tokens=8192, d_model=4096, vocab=16384)
HEAD_STEPS = 3
HEAD_LR = 1e-4
# rtc vs plain, max abs error.  softmax_fwd: expf and the two reductions run
# in other orders than torch.softmax; p <= 1 and both are within a few ulp
# of the exact value, so a few ulp of 1 (1.2e-7 each) stays under 1e-6.
# softmax_bwd and axpy: the same single IEEE operations as the plain
# version (2x is exact, so a fused multiply-add equals a multiply and an
# add): exact.  Head weights: the GEMMs are the same calls on the same
# inputs, and p differs at the ulp level, which moves dW by at most
# 8192·|Δp|·max|h| and W by lr times that, far below 1e-6.
RTC_TOLERANCE = {"softmax_fwd": 1e-6, "softmax_bwd": 0.0, "axpy": 0.0,
                 "head_p": 1e-6, "head_w": 1e-6}


def softmax_geometry(c):
    """softmax_fwd's launch for rows of ``c`` columns: ``(block threads,
    dynamic shared bytes, whether the row is read once)``.  The one-read path
    needs c % 4 == 0 (16-byte aligned rows) and c <= 4 * SOFTMAX_VEC * block;
    its block is the least multiple of 32 threads that holds the row.  Every
    other width runs the three-pass loop on SOFTMAX_THREADS threads."""
    if c % 4 == 0 and c <= 4 * SOFTMAX_VEC * SOFTMAX_MAX_THREADS:
        per_warp = 4 * SOFTMAX_VEC * 32
        return 32 * -(-c // per_warp), 0, True
    return SOFTMAX_THREADS, 0, False


def softmax_bwd_geometry(c):
    """softmax_bwd's launch for rows of ``c`` columns: ``(block threads, rows
    a block, whether rows are copied as float4)``; the grid is
    ceil(rows / rows a block).  A block has the least multiple of 32 threads
    that gives each thread at most BWD_VEC float4 (or elements) of a row,
    at most BWD_THREADS, and as many rows as make about BWD_BLOCK_ELEMENTS
    elements.  The float4 path needs c % 4 == 0 (and 16-byte aligned bases,
    which the kernel checks)."""
    vec = c % 4 == 0
    units = c // 4 if vec else c
    block = min(BWD_THREADS, 32 * -(-units // (32 * BWD_VEC)))
    return max(block, 32), max(1, BWD_BLOCK_ELEMENTS // c), vec


def axpy_geometry(n):
    """axpy's launch for ``n`` elements: ``(grid blocks, block threads)``,
    one block per AXPY_THREADS x AXPY_VEC float4 (its loop strides over the
    grid, so any grid is right)."""
    return max(1, -(-n // (4 * AXPY_VEC * AXPY_THREADS))), AXPY_THREADS


def rtc_module(mx):
    """Compile RTC_SOURCE once (NVRTC, sm_90a); returns the module and its
    kernels by name."""
    mod = mx.rtc.CudaModule(RTC_SOURCE, exports=list(RTC_SIGNATURES))
    return mod, {n: mod.get_kernel(n, s) for n, s in RTC_SIGNATURES.items()}


def softmax_plain(z):
    """Plain version of softmax_fwd."""
    import torch
    return torch.softmax(z, dim=-1)


def softmax_bwd_plain(p, label):
    """Plain version of softmax_bwd: p - onehot(label), label held as f32."""
    import torch
    return p - torch.nn.functional.one_hot(label.long(),
                                           p.shape[-1]).to(p.dtype)


def register_rtc_softmax(mx, kernels=None):
    """Register the custom op ``rtc_softmax``: ``nd.Custom(z, label,
    op_type="rtc_softmax")`` is softmax(z) over the last axis, and its
    backward, which ignores the head gradient (``need_top_grad=False``), is
    p - onehot(label) into z; the label gets no gradient.

    On a CUDA NDArray it launches the rtc kernels, ``kernels`` from
    :func:`rtc_module` (without them a CUDA call raises); on a CPU NDArray
    it runs the plain versions.  Which one runs follows from the device
    alone."""

    def launch_into(name, req, dst, args, rows, c):
        """Launch ``name`` writing its (rows, c) result into ``dst``; the
        port asks a custom op only for ``write`` or ``null``."""
        if req == "null":
            return
        if req != "write":
            raise mx.MXNetError("rtc_softmax writes its result, got req %r"
                                % req)
        if kernels is None:
            raise mx.MXNetError("rtc_softmax on %s needs the rtc kernels: "
                                "register_rtc_softmax(mx, rtc_module(mx)[1])"
                                % dst.context)
        if name == "softmax_fwd":
            block, shared, _ = softmax_geometry(c)
            kernels[name].launch(args + [dst, c], dst.context, (rows,),
                                 (block,), shared)
        else:
            block, per, _ = softmax_bwd_geometry(c)
            kernels[name].launch(args + [dst, rows, c], dst.context,
                                 (-(-rows // per),), (block,))

    class RtcSoftmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            z = in_data[0]
            if z.context.device_type == "gpu":
                rows, c = z.shape
                launch_into("softmax_fwd", req[0], out_data[0], [z], rows, c)
            else:
                self.assign(out_data[0], req[0],
                            mx.nd.NDArray(softmax_plain(z._data)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            p, label = out_data[0], in_data[1]
            if p.context.device_type == "gpu":
                rows, c = p.shape
                launch_into("softmax_bwd", req[0], in_grad[0], [p, label],
                            rows, c)
            else:
                self.assign(in_grad[0], req[0], mx.nd.NDArray(
                    softmax_bwd_plain(p._data, label._data)))

    class RtcSoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return RtcSoftmax()

    mx.operator.register("rtc_softmax")(RtcSoftmaxProp)
    return RtcSoftmaxProp


def case_key(shape, causal, dtype_name):
    return "x".join(map(str, shape)) + ("_causal" if causal else "") + \
        "_" + dtype_name


def fail(msg):
    print("chip_smoke: FAILED: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, "nvidia-smi failed: " + out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, torch):
    """Mean ms of ``fn()`` over ``reps`` back-to-back calls, by CUDA events,
    after two warm-up calls."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention_work(b, h, sq, sk, d, causal, itemsize):
    """(flops, bytes) the attention on these inputs needs: each input read
    once, the output written once, and 4·D flops per (query, key) pair the
    mask lets through (a row that sees no key averages all of them)."""
    if causal:
        pairs = 0
        for i in range(sq):
            seen = min(max(i + sk - sq + 1, 0), sk)
            pairs += seen if seen else sk
    else:
        pairs = sq * sk
    flops = 4.0 * b * h * d * pairs
    nbytes = itemsize * b * h * d * (2 * sq + 2 * sk)
    return flops, nbytes


def f32_tensor_work(b, h, sq, sk, d, causal):
    """The tensor work (flop) flash_fwd_f32_sm90_kernel does: its walk over
    128-row query blocks and 64-key tiles (whole tiles across the causal
    diagonal), six products in each of S and P·V over the head-dim bucket."""
    bucket = 64 if d <= 64 else 128
    tiles = 0
    for q0 in range(0, sq, 128):
        n_end = sk
        if causal and q0 + sk - sq >= 0:
            n_end = min(sk, q0 + min(128, sq - q0) + sk - sq)
        tiles += -(-n_end // 64)
    return b * h * tiles * 2 * 6 * 2.0 * 128 * 64 * bucket


def wide_tensor_work(b, h, sq, sk, d, causal, products):
    """The tensor work (flop) the wide kernels issue: their walk over 64-row
    query blocks and 64-key tiles (whole tiles across the diagonal), for
    each of the ceil(panels / slice) output slices of 3 or 4 panels, S over
    the padded head dim and P·V over the slice, ``products`` wgmma products
    for each f32 product (route A: 1 for S and the two halves of P for P·V,
    so 1 and 2; route B: 6 and 6)."""
    panels = -(-(-(-d // 8) * 8) // 64)
    slices = -(-panels // 4)
    width = 3 if -(-panels // slices) <= 3 else 4
    slices = -(-panels // width)
    tiles = 0
    for q0 in range(0, sq, 64):
        n_end = sk
        if causal and q0 + sk - sq >= 0:
            n_end = min(sk, q0 + min(64, sq - q0) + sk - sq)
        tiles += -(-n_end // 64)
    s_prod, pv_prod = products
    per_tile = 2.0 * 64 * 64 * 64 * (s_prod * panels + pv_prod * width)
    return b * h * slices * tiles * per_tile


def ptxas_resources(log, function):
    """ptxas's report for each instance of the kernels whose (mangled) name
    contains ``function``: {instance: (registers, spill stores, spill loads
    in bytes)}."""
    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1) if function in m.group(1) else None
            if name is not None:   # the kernel's name and template arguments
                name = name[name.find("flash_fwd"):].split("EEEv")[0]
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            found[name] = (0, int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            spills = found.get(name, (0, 0, 0))
            found[name] = (int(m.group(1)), spills[1], spills[2])
    return found


def time_flash(q, k, v, causal, card, torch):
    """flash_attention on q, k, v (one dtype) by CUDA events, beside its
    plain version and scaled_dot_product_attention with the bottom-right
    bool mask (the yardstick; the port never calls it), and its bound: the
    larger of the bytes at 3.35 TB/s and the operations, f32 on the CUDA
    cores or the split's six bf16 products on the tensor cores, whichever is
    less, for f32; 16-bit on the tensor cores otherwise."""
    from incubator_mxnet_tpu_torch.ops.attention import (
        flash_attention, _attention_reference)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    scale = 1.0 / math.sqrt(d)
    t = {"ms": cuda_ms(lambda: flash_attention(q, k, v, causal), 20, torch),
         "plain_ms": cuda_ms(lambda: _attention_reference(q, k, v, causal), 5,
                             torch),
         "library_ms": cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask,
                                            scale=scale), 10, torch)}
    flops, nbytes = attention_work(b, h, sq, sk, d, causal, q.element_size())
    terms = {"bytes": nbytes / H100_BYTES_PER_S * 1e3}
    if q.dtype == torch.float32:
        terms["cuda_core"] = flops / H100_F32_CUDA_CORE_FLOPS * 1e3
        terms["split_tensor"] = 6 * flops / H100_BF16_FLOPS * 1e3
        ops_ms = min(terms["cuda_core"], terms["split_tensor"])
    else:
        terms["tensor"] = flops / H100_BF16_FLOPS * 1e3
        ops_ms = terms["tensor"]
    t["bound_ms"] = max(terms["bytes"], ops_ms)
    t["bound_by"] = "bytes" if terms["bytes"] >= ops_ms else "operations"
    t["bound_terms_ms"] = terms
    t["tflops"] = flops / t["ms"] / 1e9
    t["shape"] = "(%d,%d,%d,%d,%d)%s %s" % (
        b, h, sq, sk, d, " causal" if causal else "",
        str(q.dtype).replace("torch.", ""))
    print("timing: flash_attention_fwd at %s: kernel_ms %.4f, bound_ms %.4f "
          "(%s; terms ms %s; %.3e flop, %.3e bytes), plain_ms %.4f, "
          "library_ms %.4f (scaled_dot_product_attention with a bottom-right "
          "bool mask%s); kernel at %.1f TFLOP/s of the needed work | %s"
          % (t["shape"], t["ms"], t["bound_ms"], t["bound_by"],
             json.dumps({k_: round(v_, 4) for k_, v_ in terms.items()}),
             flops, nbytes, t["plain_ms"], t["library_ms"],
             ", TF32 off" if q.dtype == torch.float32 else "", t["tflops"],
             card), flush=True)
    return t


GEMM_NAMES = ("gemm", "xmma", "cutlass", "nvjet")


DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# the record_function span around the timed call of ``profiled``
PROFILED_SPAN = "chip_smoke.profiled"


def timed_device_work(prof, spans=()):
    """The device activities (kernels, copies, fills) of a :func:`profiled`
    session that its timed call launched: those whose launching runtime or
    driver call (by correlation id) lies inside the span PROFILED_SPAN,
    whichever thread made it; CUDA graph replays' kernels included.
    Returns ([(name, us, launch ts)], [(start, end, name)] of the
    record_function spans named in ``spans``), from the exported trace."""
    from incubator_mxnet_tpu_torch import cuda_build
    path = cuda_build.BUILD_DIR.parent / ("trace-%d.json" % os.getpid())
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        path.unlink()
    launch_ts, timed, named, device = {}, [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args") or {}
        interval = (e["ts"], e["ts"] + e.get("dur", 0), e.get("name"))
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch_ts[args["correlation"]] = e["ts"]
        elif cat == "user_annotation" and e.get("name") == PROFILED_SPAN:
            timed.append(interval)
        elif cat == "user_annotation" and e.get("name") in spans:
            named.append(interval)
        elif cat in DEVICE_CATEGORIES:
            device.append((e.get("name", ""), float(e.get("dur", 0)),
                           args.get("correlation")))
    work = []
    for name, us, corr in device:
        ts = launch_ts.get(corr)
        if ts is not None and any(a <= ts <= b for a, b, _ in timed):
            work.append((name, us, ts))
    return work, named


def trace_kernels(prof):
    """{name: [device us, count]} of :func:`timed_device_work`."""
    kernels = {}
    for name, us, _ts in timed_device_work(prof)[0]:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += us
        k[1] += 1
    return kernels


def profiled(run):
    """One call of ``run`` under torch.profiler, after one untimed call in
    the same window: (the profile, the timed call's wall us by the host
    clock, device synchronized at both ends).  The timed call runs inside
    the record_function span PROFILED_SPAN, by which :func:`trace_kernels`
    keeps its device work.  Late in this script the profiler dropped the
    first kernels a window saw (the head step's forward GEMM and
    softmax_fwd, launched from the main thread before its backward, whose
    kernels it kept); the untimed call takes that loss."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
        with record_function(PROFILED_SPAN):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    return prof, wall_us


def profile_device(run, what, kernel_groups, gemm_flops, card):
    """Where one call of ``run`` spends its time: device time by kernel
    (torch.profiler, CUPTI; :func:`profiled`, :func:`trace_kernels`),
    grouped by ``kernel_groups`` ({group: kernel name substring}), GEMMs and
    the rest, against the call's wall time; the remainder is the device's
    idle share.  ``gemm_flops`` is the call's matrix-product work, for the
    GEMMs' achieved rate."""
    prof, wall_us = profiled(run)
    kernels = trace_kernels(prof)
    if not kernels:
        print("profile: torch.profiler recorded no device time: not measured")
        return None
    groups = dict.fromkeys(list(kernel_groups) + ["gemm", "other"], 0.0)
    for name, (us, _) in kernels.items():
        low = name.lower()
        group = next((g for g, key in kernel_groups.items() if key in low),
                     None)
        if group is None:
            group = "gemm" if any(t in low for t in GEMM_NAMES) else "other"
        groups[group] += us
    busy = sum(groups.values())
    print("profile: %s under torch.profiler: wall %.1f us, device busy %.1f "
          "us (%d device activities), idle share %.4f | %s"
          % (what, wall_us, busy, sum(n for _, n in kernels.values()),
             max(0.0, 1 - busy / wall_us), card))
    print("profile: device us by group %s; GEMMs %.4e flop at %.1f TFLOP/s"
          % (json.dumps({k: round(v, 1) for k, v in groups.items()}),
             gemm_flops, gemm_flops / groups["gemm"] / 1e6 if groups["gemm"]
             else 0.0))
    for name, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
        print("profile:   %10.1f us  %3d x  %s" % (us, n, name[:110]))


_SASS_LISTINGS = {}


def sass_listing(lib):
    """``cuobjdump -sass`` of the library, run once a library (~12 s for
    flash_attention's; phase 2 counts ten routes in it)."""
    key = str(lib)
    if key not in _SASS_LISTINGS:
        tool = shutil.which("cuobjdump") or os.path.join(
            os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
            "cuobjdump")
        out = subprocess.run([tool, "-sass", key], capture_output=True,
                             text=True, timeout=120)
        check(out.returncode == 0, "cuobjdump failed: " +
              out.stderr.strip())
        _SASS_LISTINGS[key] = out.stdout
    return _SASS_LISTINGS[key]


def sass_count(lib, opcode, function=""):
    """How many SASS instructions of ``opcode`` the library's device code
    holds (cuobjdump -sass), in the functions whose (mangled) name contains
    ``function``."""
    count, inside = 0, not function
    for line in sass_listing(lib).splitlines():
        if line.strip().startswith("Function :"):
            inside = function in line
        elif inside and re.search(r"\b%s\b" % opcode, line):
            count += 1
    return count


def host_rounds(fns, rounds, reps):
    """Host µs of one call of each of ``fns`` (name -> fn) in each of
    ``rounds`` rounds of ``reps`` calls: name -> the rounds' means.  The fns
    take turns, in order on even rounds and reversed on odd ones (a, b, b,
    a), and the device is synchronized after every ``reps`` calls (outside
    the clock), so its queue never holds more than ``reps`` launches and a
    full queue never blocks the host.  10 warm-up calls of each first."""
    import torch
    names = list(fns)
    for name in names:
        for _ in range(10):
            fns[name]()
    torch.cuda.synchronize()
    out = {name: [] for name in names}
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            fn = fns[name]
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            out[name].append((time.perf_counter() - t0) / reps * 1e6)
            torch.cuda.synchronize()
    return out


def plain_softmax_output(torch):
    """The rtc_softmax op in plain PyTorch, as one torch.autograd.Function:
    the oracle of the head-training run."""

    class PlainSoftmaxOutput(torch.autograd.Function):
        @staticmethod
        def forward(ctx, z, label):
            p = softmax_plain(z)
            ctx.save_for_backward(p, label)
            return p

        @staticmethod
        def backward(ctx, grad_p):
            p, label = ctx.saved_tensors
            return softmax_bwd_plain(p, label), None

    return PlainSoftmaxOutput


def train_head(mx, kernels, dev, card):
    """The head-training path: HEAD_STEPS SGD steps of the LM's vocabulary
    head through FullyConnected, the rtc_softmax custom op (rtc kernels) and
    sgd_update, held step by step against the same steps with the plain
    versions.  Returns the kernels' launches on the path."""
    import torch
    n, d, v = HEAD["tokens"], HEAD["d_model"], HEAD["vocab"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    h = torch.randn(n, d, generator=gen, device=dev)
    w0 = torch.randn(v, d, generator=gen, device=dev) * 0.02
    bias = torch.randn(v, generator=gen, device=dev) * 0.01
    label = torch.randint(0, v, (n,), generator=gen, device=dev).to(
        torch.float32)

    # the plain run first: its p and W after each step are the oracle
    plain = plain_softmax_output(torch)
    w = w0.clone().requires_grad_()
    want_p, want_w = [], []
    for _ in range(HEAD_STEPS):
        p = plain.apply(torch.matmul(h, w.t()) + bias, label)
        (g,) = torch.autograd.grad(p, [w], torch.ones_like(p))
        with torch.no_grad():
            w.copy_(w - HEAD_LR * (g * 1.0 + 0.0 * w))
        want_p.append(p.detach())
        want_w.append(w.detach().clone())
    del w, p, g

    H, B, L = (mx.nd.NDArray(t) for t in (h, bias, label))
    W = mx.nd.NDArray(w0.clone())
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    softmax = ("softmax_fwd", "softmax_bwd")
    for name in softmax:
        kernels[name].launches = 0

    def train_step():
        W.attach_grad()
        with mx.autograd.record():
            z = mx.nd.FullyConnected(H, W, B, num_hidden=v)
            p = mx.nd.Custom(z, L, op_type="rtc_softmax")
        p.backward()
        mx.nd.sgd_update(W, W.grad, lr=HEAD_LR, out=W)
        return p

    step_ms, ce, p_err, w_err = [], [], [], []
    for step_i in range(HEAD_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = train_step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        pt = p._data.detach()
        check(pt.shape == (n, v) and bool(torch.isfinite(pt).all()),
              "head step %d: p %s not finite" % (step_i, tuple(pt.shape)))
        ce.append(-torch.log(pt.gather(1, label.long()[:, None])).mean()
                  .item())
        p_err.append((pt - want_p[step_i]).abs().max().item())
        w_err.append((W._data.detach() - want_w[step_i]).abs().max().item())
        del p, pt
    launches = {name: kernels[name].launches for name in softmax}
    peak = torch.cuda.max_memory_allocated() - held
    with torch.no_grad():
        logits = torch.matmul(h, W._data.t()) + bias
        ce.append(-torch.log(softmax_plain(logits).gather(
            1, label.long()[:, None])).mean().item())
        del logits
    for step in range(HEAD_STEPS):
        print("rtc: head step %d: %.3f ms, cross-entropy %.6f -> %.6f, p vs "
              "plain max_abs_err %.3e (bound %.0e), W vs plain %.3e (bound "
              "%.0e) | %s" % (step, step_ms[step], ce[step], ce[step + 1],
                              p_err[step], RTC_TOLERANCE["head_p"],
                              w_err[step], RTC_TOLERANCE["head_w"], card))
    print("rtc: head training %s, %d steps, lr %g, f32: launches %s, peak "
          "memory allocated by the steps %d bytes (beyond %d held) | %s"
          % (HEAD, HEAD_STEPS, HEAD_LR, launches, peak, held, card),
          flush=True)
    check(max(p_err) <= RTC_TOLERANCE["head_p"], "head p disagrees with plain")
    check(max(w_err) <= RTC_TOLERANCE["head_w"], "head W disagrees with plain")
    check(all(a > b for a, b in zip(ce, ce[1:])),
          "cross-entropy did not fall at every step: %s" % ce)
    for name in softmax:
        check(launches[name] == HEAD_STEPS, "%s launched %d times in %d head "
              "steps" % (name, launches[name], HEAD_STEPS))
    # one more step, after the checks and the counts, for its device time
    profile_device(train_step, "one head step", {k: k for k in softmax},
                   4.0 * n * d * v, card)
    return launches


def rtc_phase(mx, dev, card):
    """Phase rtc: compile the user kernels with the port's NVRTC binding,
    check axpy, train the vocabulary head through them, time each kernel and
    the host cost of a launch.  Returns the kernels' JSON entries."""
    import numpy as np
    import torch
    ctx = mx.gpu(0)
    t0 = time.perf_counter()
    mod, kernels = rtc_module(mx)
    print("rtc: NVRTC compiled %s for %s in %.3f s (%d-byte CUBIN) | %s" % (
        sorted(RTC_SIGNATURES), mod.options[0], time.perf_counter() - t0,
        len(mod._cubin), card), flush=True)
    register_rtc_softmax(mx, kernels)
    axpy = kernels["axpy"]

    def run_axpy(x, y):
        o = mx.nd.empty(x.shape, ctx=ctx)
        grid, block = axpy_geometry(x.size)
        axpy.launch([x, y, o, x.size], ctx, (grid,), (block,))
        return o

    axpy.launches = 0
    x8 = mx.nd.array(np.arange(8, dtype=np.float32), ctx=ctx)
    got = run_axpy(x8, mx.nd.ones(8, ctx=ctx)).asnumpy()
    check(np.array_equal(got, np.arange(8, dtype=np.float32) * 2 + 1),
          "axpy (8,) != 2x + 1: %s" % got)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    n = AXPY_N
    x, y = (mx.nd.NDArray(torch.randn(n, generator=gen, device=dev))
            for _ in range(2))
    o = run_axpy(x, y)
    axpy_err = (o._data - (2 * x._data + y._data)).abs().max().item()
    print("rtc: axpy (8,) == 2x + 1 exactly; axpy (%d,) vs 2 * x + y "
          "max_abs_err %.3e (bound 0)" % (n, axpy_err), flush=True)
    check(axpy_err == RTC_TOLERANCE["axpy"], "axpy is not exact")
    launches = {"axpy": axpy.launches}
    launches.update(train_head(mx, kernels, dev, card))

    # timing at the head shape (these launches are not counted above)
    rows, c = HEAD["tokens"], HEAD["vocab"]
    Z = mx.nd.NDArray(torch.randn(rows, c, generator=gen, device=dev))
    P, DZ = mx.nd.empty((rows, c), ctx=ctx), mx.nd.empty((rows, c), ctx=ctx)
    lab = mx.nd.NDArray(torch.randint(0, c, (rows,), generator=gen,
                                      device=dev).to(torch.float32))
    idx = lab._data.long()[:, None]
    fwd, bwd = kernels["softmax_fwd"], kernels["softmax_bwd"]
    grid = (rows,)
    fwd_block, fwd_shared, one_read = softmax_geometry(c)
    check(one_read, "softmax_fwd at c = %d does not take its one-read path"
          % c)
    bwd_block, bwd_rows, bwd_vec = softmax_bwd_geometry(c)
    check(bwd_vec, "softmax_bwd at c = %d does not take its float4 path" % c)
    bwd_grid = (-(-rows // bwd_rows),)
    axpy_grid, axpy_block = axpy_geometry(n)
    fwd.launch([Z, P, c], ctx, grid, (fwd_block,), fwd_shared)
    bwd.launch([P, lab, DZ, rows, c], ctx, bwd_grid, (bwd_block,))
    errs = {"axpy": axpy_err,
            "softmax_fwd": (P._data - softmax_plain(Z._data)).abs().max()
            .item(),
            "softmax_bwd": (DZ._data - softmax_bwd_plain(P._data, lab._data))
            .abs().max().item()}
    for name in ("softmax_fwd", "softmax_bwd"):
        check(errs[name] <= RTC_TOLERANCE[name], "%s: max_abs_err %.3e > %.0e"
              % (name, errs[name], RTC_TOLERANCE[name]))
    check(torch.equal(torch.scatter(P._data, 1, idx, -1.0, reduce="add"),
                      softmax_bwd_plain(P._data, lab._data)),
          "softmax_bwd's library yardstick computes another function")
    xs, ys = x._data, y._data
    elems = rows * c
    work = {   # (flops, bytes): each input read once, each output written once
        "softmax_fwd": (7.0 * elems, 4.0 * 2 * elems),
        "softmax_bwd": (1.0 * elems, 4.0 * (2 * elems + rows)),
        "axpy": (2.0 * n, 4.0 * 3 * n),
    }
    timed = {
        "softmax_fwd": (lambda: fwd.launch([Z, P, c], ctx, grid,
                                           (fwd_block,), fwd_shared),
                        lambda: softmax_plain(Z._data),
                        lambda: torch.softmax(Z._data, dim=-1),
                        "torch.softmax"),
        "softmax_bwd": (lambda: bwd.launch([P, lab, DZ, rows, c], ctx,
                                           bwd_grid, (bwd_block,)),
                        lambda: softmax_bwd_plain(P._data, lab._data),
                        lambda: torch.scatter(P._data, 1, idx, -1.0,
                                              reduce="add"),
                        "torch.scatter(p, 1, label, -1.0, reduce='add')"),
        "axpy": (lambda: axpy.launch([x, y, o, n], ctx, (axpy_grid,),
                                     (axpy_block,)),
                 lambda: 2 * xs + ys,
                 lambda: torch.add(ys, xs, alpha=2),
                 "torch.add(y, x, alpha=2)"),
    }
    geometry = {"softmax_fwd": {"grid": rows, "block": fwd_block},
                "softmax_bwd": {"grid": bwd_grid[0], "block": bwd_block,
                                "rows_a_block": bwd_rows},
                "axpy": {"grid": axpy_grid, "block": axpy_block}}
    entries = []
    for name in RTC_KERNELS:
        kern, plain, library, library_name = timed[name]
        # the kernel and its library call in turns (kernel, library,
        # library, kernel), each the mean of its two turns
        turns = [cuda_ms(f, 50, torch) for f in (kern, library, library,
                                                  kern)]
        kernel_ms, library_ms = (turns[0] + turns[3]) / 2, \
            (turns[1] + turns[2]) / 2
        plain_ms = cuda_ms(plain, 20, torch)
        flops, nbytes = work[name]
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_F32_CUDA_CORE_FLOPS * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        shape = "(%d,)" % n if name == "axpy" else "(%d, %d)" % (rows, c)
        print("timing: rtc %s at %s f32: kernel_ms %.4f, bound_ms %.4f (%s: "
              "%.3e bytes at 3.35 TB/s, %.3e flop at 67 TFLOP/s f32), plain_ms "
              "%.4f, library_ms %s; %.1f GB/s; turns kernel, library, "
              "library, kernel %s | %s" % (
                  name, shape, kernel_ms, bound_ms, bound_by, nbytes, flops,
                  plain_ms, "%.4f (%s)" % (library_ms, library_name),
                  nbytes / kernel_ms / 1e6,
                  " ".join("%.4f" % t for t in turns), card), flush=True)
        entries.append({
            "name": name, "route": "cuda", "compiler": "nvrtc",
            "source": "chip_smoke.py",
            "replaces": "incubator_mxnet_tpu/rtc.py:86",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms})
        entries[-1]["design"] = RTC_DESIGNS[name]
        entries[-1]["geometry"] = geometry[name]
        check(launches[name] > 0, "%s was not launched on its path" % name)

    entries.append(launch_cost(mx, kernels, dev, card, launches))
    return entries


# the launch-cost timing: rounds x calls a round (far below the device's
# launch queue, synchronized between rounds)
LAUNCH_ROUNDS, LAUNCH_REPS = 20, 200


def spread(xs):
    return {"mean": sum(xs) / len(xs), "min": min(xs), "max": max(xs)}


def plain_launch(mx, kernel, args, grid, block):
    """One launch of ``kernel`` written plainly, the driver reached through
    ctypes as the port's first launch path reached it: a ctypes holder per
    argument, the primary context made current, torch's Stream object,
    cuLaunchKernel through its ctypes binding.  None of the launch's
    checks: the yardstick of the compiled launcher."""
    import ctypes
    import torch
    from incubator_mxnet_tpu_torch import _cuda_driver as cu
    from incubator_mxnet_tpu_torch import rtc
    holders = [ctypes.c_uint64(a._data.data_ptr()) if p.is_pointer
               else rtc._TYPES[p.ctype][1](a)
               for p, a in zip(kernel.params, args)]
    params = (ctypes.c_void_p * max(len(holders), 1))(
        *[ctypes.addressof(h) for h in holders])
    cu.use_primary_context(0)
    cu.check(cu.driver().cuLaunchKernel(
        kernel._sites[0].func, grid, 1, 1, block, 1, 1, 0,
        torch.cuda.current_stream(torch.device("cuda", 0)).cuda_stream,
        params, None), "cuLaunchKernel(%s)" % kernel.name)


def launch_cost(mx, kernels, dev, card, path_launches):
    """The host cost of one CudaKernel.launch: noop (no arguments) and axpy
    (4 arguments, n = 8, one block), beside one torch.neg on a 1-element
    tensor, the same launches written plainly over ctypes, and the floor
    (one cuLaunchKernel of noop issued from C, no Python in the loop),
    timed in turns; then the parts of axpy's launch, each alone, as the
    launch runs them.  ``path_launches`` are the user kernels' launches on
    the main path, all through this launch path.  Returns the rtc_launch
    entry."""
    import torch
    from incubator_mxnet_tpu_torch import _cuda_driver as cu
    from incubator_mxnet_tpu_torch import rtc
    ctx = mx.gpu(0)
    noop, axpy = kernels["noop"], kernels["axpy"]
    n = 8
    x = mx.nd.array(list(range(n)), ctx=ctx)
    y, o = mx.nd.ones(n, ctx=ctx), mx.nd.zeros(n, ctx=ctx)
    grid, block = axpy_geometry(n)
    args = [x, y, o, n]
    small = torch.zeros(1, device=dev)
    totals = host_rounds({
        "noop": lambda: noop.launch([], ctx, (1,), (1,)),
        "torch_neg": lambda: torch.neg(small),
        "axpy_4_args": lambda: axpy.launch(args, ctx, (grid,), (block,)),
        "plain_noop": lambda: plain_launch(mx, noop, [], 1, 1),
        "plain_axpy_4_args": lambda: plain_launch(mx, axpy, args, grid,
                                                  block),
    }, LAUNCH_ROUNDS, LAUNCH_REPS)
    o_err = (o._data - (2 * x._data + y._data)).abs().max().item()
    check(o_err == 0.0, "axpy through the timed launches != 2x + y")
    site = noop._sites[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    floor = []
    for _ in range(LAUNCH_ROUNDS):
        floor.append(cu.launch_floor_ns(site.func, site.ctx, LAUNCH_REPS,
                                        stream) / 1e3)
        torch.cuda.synchronize()

    # the parts of axpy's launch, each alone, as CudaKernel.launch runs them
    asite = axpy._sites[0]
    holders, _, params = axpy._buffer()
    device = axpy._devices[0]
    grid_t, block_t = (grid,), (block,)

    def checks_and_dims():
        c = ctx if ctx.__class__ is rtc.Context else rtc.Context(ctx)
        if c.device_type != "gpu" or len(args) != len(axpy._packers):
            raise AssertionError
        rtc._dims(grid_t, "grid_dims")
        b = rtc._dims(block_t, "block_dims")
        if b[0] * b[1] * b[2] > 1024 or axpy._devices.get(0) is None:
            raise AssertionError

    def arguments():
        for (pack, _), arg, holder in zip(axpy._packers, args, holders):
            pack(arg, holder, device)

    def bumps():
        for i in axpy._mutable:
            rtc._increment_version(args[i]._data)

    xt = x._data

    def getters():
        # what a pointer argument's check asks of its tensor
        return (xt.dtype, xt.get_device(), xt.is_contiguous(), xt.data_ptr())

    parts = {k: spread(v)["mean"] for k, v in host_rounds({
        "checks_and_dims": checks_and_dims,
        "arguments": arguments,
        "of_which_tensor_getters_one_pointer": getters,
        "stream": lambda: asite.stream(0),
        "launcher": lambda: asite.launch(asite.table, asite.func, asite.ctx,
                                         grid, 1, 1, block, 1, 1, 0, stream,
                                         params),
        "version_bumps": bumps,
    }, LAUNCH_ROUNDS, LAUNCH_REPS).items()}
    t = {k: spread(v) for k, v in totals.items()}
    f = spread(floor)
    for name, label in (
            ("noop", "CudaKernel.launch of noop (no arguments)"),
            ("axpy_4_args", "CudaKernel.launch of axpy (4 arguments, n = 8)"),
            ("torch_neg", "torch.neg on a 1-element tensor"),
            ("plain_noop", "noop launched plainly over ctypes"),
            ("plain_axpy_4_args", "axpy launched plainly over ctypes")):
        print("rtc: launch host cost, %s: %.3f us (mean of %d rounds of %d "
              "calls; rounds %.3f-%.3f) | %s" % (
                  label, t[name]["mean"], LAUNCH_ROUNDS, LAUNCH_REPS,
                  t[name]["min"], t[name]["max"], card), flush=True)
    print("rtc: launch floor, one cuLaunchKernel of noop issued from C: "
          "%.3f us (rounds %.3f-%.3f) | %s" % (f["mean"], f["min"], f["max"],
                                                card), flush=True)
    print("rtc: launch parts of axpy (us, each alone): %s; sum %.3f of the "
          "launch's %.3f | %s" % (
              ", ".join("%s %.3f" % kv for kv in parts.items()),
              sum(v for k, v in parts.items() if not k.startswith("of_")),
              t["axpy_4_args"]["mean"], card), flush=True)
    return {"name": "rtc_launch", "route": "cuda", "compiler": "cc",
            "source": "incubator_mxnet_tpu_torch/rtc.py, "
                      "incubator_mxnet_tpu_torch/csrc/rtc_launch.c",
            "replaces": "incubator_mxnet_tpu/rtc.py:86",
            "launches": sum(path_launches.values()), "max_abs_err": o_err,
            "ms": t["noop"]["mean"] / 1e3,
            "plain_ms": t["plain_noop"]["mean"] / 1e3,
            "bound_ms": f["mean"] / 1e3, "bound_by": "operations",
            "library_ms": t["torch_neg"]["mean"] / 1e3,
            "host_us": t["noop"]["mean"],
            "host_us_4_args": t["axpy_4_args"]["mean"],
            "bound_us": f["mean"], "library_us": t["torch_neg"]["mean"],
            "plain_us": t["plain_noop"]["mean"],
            "plain_us_4_args": t["plain_axpy_4_args"]["mean"],
            "parts_us": parts,
            "rounds_us": {k: [v["min"], v["max"]] for k, v in t.items()},
            "bound_rounds_us": [f["min"], f["max"]]}


def model_flops_per_step(n_params, tokens, seq_len, d_model, n_layers=1):
    """Model FLOPs of one training step (forward and backward) as
    bench_transformer.py:46-51 counts them: 6·N·tokens over the N
    non-embedding parameters, plus the causal attention term."""
    dense = 6.0 * n_params * tokens
    attn = 6.0 * seq_len * tokens * d_model * n_layers
    return dense + attn


def kernels_by_span(prof, spans):
    """Device time of the timed call of a :func:`profiled` session, by named
    span: a kernel belongs to the innermost span (a record_function of
    ``spans``) whose CPU interval holds the runtime call that launched it.
    Returns ({span: [us, GEMM us]}, [(kernel name, us) outside every
    span])."""
    work, intervals = timed_device_work(prof, spans)
    intervals.sort(key=lambda iv: iv[1] - iv[0])      # innermost first
    by_span = {name: [0.0, 0.0] for name in spans}
    outside = []
    for name, us, ts in work:
        span = next((n for a, b, n in intervals if a <= ts <= b), None)
        if span is None:
            outside.append((name, us))
            continue
        by_span[span][0] += us
        if any(t in name.lower() for t in GEMM_NAMES):
            by_span[span][1] += us
    return by_span, outside


def profile_training_step(run, gemm_flops, card):
    """One training step under torch.profiler, by group: cuBLAS GEMMs of the
    model, the flash forward kernel, the flash backward (the backward
    kernel and the copies its wrapper makes, the span
    flash_attention_backward), the optimizer update (the span
    DataParallelTrainer.update) and the rest, against the step's wall time;
    the remainder is the device's idle share."""
    spans = ("flash_attention_backward", "DataParallelTrainer.update")
    prof, wall_us = profiled(run)
    by_span, outside = kernels_by_span(prof, spans)
    if not outside and not any(v[0] for v in by_span.values()):
        print("profile: torch.profiler recorded no device time: not measured")
        return None
    groups = {"gemm": 0.0, "flash_attention_fwd": 0.0,
              "flash_attention_bwd": by_span[spans[0]][0],
              "optimizer_update": by_span[spans[1]][0], "other": 0.0}
    for name, us in outside:
        low = name.lower()
        if "flash_fwd" in low:
            groups["flash_attention_fwd"] += us
        elif any(t in low for t in GEMM_NAMES):
            groups["gemm"] += us
        else:
            groups["other"] += us
    busy = sum(groups.values())
    print("profile: one training step under torch.profiler: wall %.1f us, "
          "device busy %.1f us, idle share %.4f | %s"
          % (wall_us, busy, max(0.0, 1 - busy / wall_us), card))
    print("profile: device us by group %s (the flash backward's own GEMMs "
          "%.1f us of its %.1f); the model's GEMMs %.4e flop at %.1f "
          "TFLOP/s" % (json.dumps({k: round(v, 1) for k, v in groups.items()}),
                       by_span[spans[0]][1], by_span[spans[0]][0], gemm_flops,
                       gemm_flops / groups["gemm"] / 1e6 if groups["gemm"]
                       else 0.0), flush=True)
    top = {}
    for name, us in outside:
        top[name] = top.get(name, 0.0) + us
    for name, us in sorted(top.items(), key=lambda kv: -kv[1])[:6]:
        print("profile:   %10.1f us  %s" % (us, name[:110]))
    return dict(groups, wall_us=wall_us, busy_us=busy,
                idle_share=max(0.0, 1 - busy / wall_us))


def check_backward(gen, dev, card):
    """Flash attention's backward on the card against torch autograd through
    the plain version in f32, TF32 off, at BACKWARD_CASES: the 16-bit cases
    through the backward kernel, the f32 ones through the torch ops (each
    checked by the routes' counts).  Returns the max abs errors by case."""
    import torch
    from incubator_mxnet_tpu_torch.ops.attention import (
        flash_attention, _attention_reference)
    errs = {}
    for (b, h, sq, sk, d), causal, dname in BACKWARD_CASES:
        dtype = getattr(torch, dname)
        q, k, v = (torch.randn(b, h, s_, d, generator=gen, device=dev)
                   .to(dtype) for s_ in (sq, sk, sk))
        g = torch.randn(b, h, sq, d, generator=gen, device=dev).to(dtype)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = (flash_attention.backward_calls,
                  flash_attention.backward_kernel_launches,
                  flash_attention.backward_torch_calls)
        got = torch.autograd.grad(flash_attention(*leaves, causal), leaves, g)
        torch.cuda.synchronize()
        kernel = dtype != torch.float32
        check((flash_attention.backward_calls,
               flash_attention.backward_kernel_launches,
               flash_attention.backward_torch_calls) ==
              (before[0] + 1, before[1] + kernel, before[2] + (not kernel)),
              "the flash backward %s did not take its route (%s)"
              % (dname, "the kernel" if kernel else "the torch ops"))
        plain = [t.float().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(_attention_reference(*plain, causal),
                                   plain, g.float())
        key = case_key((b, h, sq, sk, d), causal, dname)
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            check(a.dtype == dtype and a.shape == w.shape and
                  bool(torch.isfinite(a).all()), "flash backward %s %s: %s "
                  "%s" % (key, name, a.dtype, tuple(a.shape)))
            err = (a.float() - w).abs().max().item()
            top = w.abs().max().item()
            bound = BACKWARD_F32_TOL if dtype == torch.float32 else \
                BACKWARD_BF16_REL * top
            errs["%s_%s" % (key, name)] = err
            ulps = "" if dtype == torch.float32 else \
                ", %.2f ulps of the type at max |grad|" % (err / 2.0 ** (
                    math.floor(math.log2(top)) - MANTISSA[dname]))
            print("kernel flash_attention_bwd %-36s %s max_abs_err %.3e "
                  "(bound %.3e%s; %s)" % (
                      key, name, err, bound, "" if dtype == torch.float32
                      else ": 2^-7 of max |grad| %.4f" % top, "the kernel"
                      if kernel else "the torch ops") + ulps, flush=True)
            check(err <= bound, "flash backward %s %s: max_abs_err %.3e > "
                  "%.3e" % (key, name, err, bound))
        del q, k, v, g, leaves, got, plain, want
    return errs


def bwd_tensor_work(b, h, sq, sk, d, causal):
    """The tensor work (flop) the backward kernel issues: the tile walks of
    its dQ and dK/dV kernels (csrc/flash_attention_bwd_sm90.cu), whole
    64 x 64 tiles across the diagonal over the head dim rounded up to 64
    (the row stats come from the forward, which computes them anyway)."""
    dp = -(-d // 64) * 64
    tile = 2.0 * 128 * 64        # one 128-row block by one 64-row tile
    offset, work = sk - sq, 0.0
    for q0 in range(0, sq, 128):
        rows = min(128, sq - q0)
        n_end = max(1, min(sk, q0 + rows + offset)) if causal else sk
        work += -(-n_end // 64) * tile * 4 * dp      # S, dP, dS_hi·K, dS_lo·K
    n_qt = -(-sq // 64)
    for n0 in range(0, sk, 128):
        t_lo = t_start = 0
        if causal:
            t_lo = min(n_qt, -(-(-offset) // 64)) if offset < 0 else 0
            first = n0 - offset - 63
            t_start = max(t_lo, -(-first // 64) if first > 0 else 0)
        walk = t_lo + n_qt - t_start
        # each 64-column slice: Sᵀ, dPᵀ over dp, and two halves of dV and dK
        work += walk * (dp // 64) * tile * (2 * dp + 4 * 64)
    return b * h * work


def time_backward(gen, dev, card):
    """The flash backward at the training shape (bf16): the backward kernel's
    time (autograd.grad with retain_graph, so the forward is not timed), the
    torch ops it replaced (_flash_backward called alone), the plain version
    (torch autograd through _attention_reference in f32) and SDPA's backward
    (the yardstick; the port never calls it).  Its bound is the card's: the
    bytes (q, k, v, out and g read once, dq, dk and dv written once) or the
    products with the 16-bit operands exact and P and dS carried to f32,
    16·D flop a visible (query, key) pair on the tensor cores (S and dP
    once, dV, dK and dQ as two products each), whichever is larger; the
    design's floor is the bf16 tensor work it issues (bwd_tensor_work).
    Also: each of its kernels' device time (torch.profiler), and in f16 on
    the same values the kernel's time, the plain version's (autograd through
    _attention_reference in f32 from the f16 values) and SDPA's backward in
    f16."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from incubator_mxnet_tpu_torch.ops.attention import (
        flash_attention, _attention_reference, _flash_backward)
    (b, h, sq, sk, d), causal, dname = BACKWARD_CASES[0]
    dtype = getattr(torch, dname)
    scale = 1.0 / math.sqrt(d)
    q, k, v = (torch.randn(b, h, s_, d, generator=gen, device=dev).to(dtype)
               for s_ in (sq, sk, sk))
    g = torch.randn(b, h, sq, d, generator=gen, device=dev).to(dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, causal)
    launches = flash_attention.backward_kernel_launches
    ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, g,
                                             retain_graph=True), 20, torch)
    check(flash_attention.backward_kernel_launches == launches + 22,
          "the timed backward did not run the kernel")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            torch.autograd.grad(out, leaves, g, retain_graph=True)
        torch.cuda.synchronize()
    kernel_us = {}
    for evt in prof.key_averages():
        for part in ("flash_bwd_dq", "flash_bwd_dkdv"):
            if part in evt.key:
                kernel_us[part] = kernel_us.get(part, 0.0) + (getattr(
                    evt, "self_device_time_total", 0) or 0) / 5
    half = [t.half().requires_grad_() for t in (q, k, v)]
    out16 = flash_attention(*half, causal)
    f16_ms = cuda_ms(lambda: torch.autograd.grad(out16, half, g.half(),
                                                 retain_graph=True), 20, torch)
    del out16, half
    o = out.detach()
    torch_ops_ms = cuda_ms(lambda: _flash_backward(q, k, v, o, g, causal,
                                                   scale), 5, torch)
    del out, o
    plain = [t.float().requires_grad_() for t in (q, k, v)]
    ref = _attention_reference(*plain, causal)
    plain_ms = cuda_ms(lambda: torch.autograd.grad(ref, plain, g.float(),
                                                   retain_graph=True),
                       5, torch)
    del ref, plain
    mask = torch.ones(sq, sk, dtype=torch.bool, device=dev).tril(sk - sq)
    lib = [t.clone().requires_grad_() for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *lib, attn_mask=mask, scale=scale)
    library_ms = cuda_ms(lambda: torch.autograd.grad(out, lib, g,
                                                     retain_graph=True),
                         20, torch)
    del out, lib, leaves
    plain = [t.half().float().requires_grad_() for t in (q, k, v)]
    ref = _attention_reference(*plain, causal)
    f16_plain_ms = cuda_ms(lambda: torch.autograd.grad(
        ref, plain, g.half().float(), retain_graph=True), 5, torch)
    del ref, plain
    lib = [t.half().requires_grad_() for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *lib, attn_mask=mask, scale=scale)
    f16_library_ms = cuda_ms(lambda: torch.autograd.grad(
        out, lib, g.half(), retain_graph=True), 20, torch)
    del out, lib
    fwd_flops, _ = attention_work(b, h, sq, sk, d, causal, 2)
    flops = 4 * fwd_flops              # 16·D a pair against the forward's 4·D
    issued = bwd_tensor_work(b, h, sq, sk, d, causal)
    nbytes = q.element_size() * b * h * d * (4 * sq + 4 * sk)
    terms = {"bytes": nbytes / H100_BYTES_PER_S * 1e3,
             "operations": flops / H100_BF16_FLOPS * 1e3,
             "design_floor": issued / H100_BF16_FLOPS * 1e3}
    t = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
         "torch_ops_ms": torch_ops_ms, "f16_ms": f16_ms,
         "f16_plain_ms": f16_plain_ms, "f16_library_ms": f16_library_ms,
         "kernel_us": kernel_us,
         "bound_ms": max(terms["bytes"], terms["operations"]),
         "bound_by": "bytes" if terms["bytes"] >= terms["operations"]
         else "operations", "bound_terms_ms": terms,
         "tflops": flops / ms / 1e9, "issued_tflops": issued / ms / 1e9,
         "shape": "(%d,%d,%d,%d,%d)%s %s" % (b, h, sq, sk, d,
                                             " causal" if causal else "",
                                             dname)}
    print("timing: flash_attention_bwd (the backward kernel) at %s: ms %.4f, "
          "bound_ms %.4f (%s; terms ms %s; %.3e flop needed, %.3e flop "
          "issued, %.3e bytes), torch_ops_ms %.4f (the torch ops it "
          "replaced, f32 products, TF32 off), plain_ms %.4f (autograd "
          "through the plain version in f32), library_ms %.4f "
          "(scaled_dot_product_attention's backward, bf16, bottom-right bool "
          "mask); %.1f TFLOP/s of the needed work, %.1f of the issued; "
          "device us by kernel %s (torch.profiler); f16 on the same values "
          "%.4f ms (plain %.4f, SDPA's backward in f16 %.4f) | %s"
          % (t["shape"], ms, t["bound_ms"], t["bound_by"],
             json.dumps({k_: round(v_, 4) for k_, v_ in terms.items()}),
             flops, issued, nbytes, torch_ops_ms, plain_ms, library_ms,
             t["tflops"], t["issued_tflops"],
             json.dumps({k_: round(v_, 1) for k_, v_ in kernel_us.items()}),
             f16_ms, f16_plain_ms, f16_library_ms, card), flush=True)
    return t


def _by_suffix(weights):
    return {n.split("_", 1)[1]: a for n, a in weights.items()}


def serve_wide_lm(mx, card, rs, d128_request_ms):
    """Phase 4e: the LM of bench_transformer.py:63-69 at its published widths
    with BENCH_HEADS=8 (D = 512, the same parameter shapes as the 32-head
    model), bf16, random weights from the seed, answering WIDE_LM_REQUESTS
    requests of 8 prompts x 1024 tokens with each prompt's greedy next
    token; every attention takes route A of the wide kernels, counted with
    the counters zeroed just before the requests and read just after."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch.ops.attention import flash_attention
    from incubator_mxnet_tpu_torch.models import TransformerLM, HostXavier
    cfg = dict(LM_CONFIG, n_heads=WIDE_LM_HEADS)
    batch = 8
    net = TransformerLM(**cfg)
    net.pos_embed.init = None
    net.initialize(HostXavier(SEED), ctx=mx.gpu(0))
    net.cast("bfloat16")
    net.collect_params().setattr("grad_req", "null")
    requests = [mx.nd.array(rs.randint(0, cfg["vocab"],
                                       (batch, cfg["seq_len"])),
                            ctx=mx.gpu(0), dtype="int32")
                for _ in range(WIDE_LM_REQUESTS)]
    with mx.autograd.predict_mode():
        net(requests[0]).wait_to_read()   # resolves the deferred shapes
    torch.cuda.synchronize()
    for c in WIDE_COUNTERS:
        setattr(flash_attention, c, 0)
    request_ms = []
    with mx.autograd.predict_mode():
        for tokens_nd in requests:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = net(tokens_nd)
            last = mx.nd.slice_axis(logits, axis=1, begin=-1, end=None)
            ids = mx.nd.argmax(last, axis=-1).asnumpy().reshape(-1)
            torch.cuda.synchronize()
            request_ms.append((time.perf_counter() - t0) * 1e3)
            check(logits.shape == (batch, cfg["seq_len"], cfg["vocab"]) and
                  bool(torch.isfinite(logits._data).all()),
                  "D = 512 LM: logits %s not finite or misshapen"
                  % (logits.shape,))
            check(ids.min() >= 0 and ids.max() < cfg["vocab"],
                  "D = 512 LM: token ids out of range: %s" % ids)
            print("serve: D = 512 LM request %d: %.3f ms, %.1f tokens/s "
                  "(the D = 128 model: mean %.3f ms), next tokens %s | %s"
                  % (len(request_ms) - 1, request_ms[-1],
                     batch * cfg["seq_len"] / request_ms[-1] * 1e3,
                     sum(d128_request_ms) / len(d128_request_ms),
                     ids.astype(np.int64).tolist(), card), flush=True)
            del logits
    launches = {c: getattr(flash_attention, c) for c in WIDE_COUNTERS}
    expected = WIDE_LM_REQUESTS * cfg["n_layers"]
    print("serve: D = 512 LM %s, launches %s (expected %d route A) | %s"
          % (cfg, launches, expected, card), flush=True)
    check(launches == dict(launches=expected, wide_launches=expected,
                           wide16_launches=expected, wide_f32_launches=0),
          "D = 512 LM: launches %s, expected %d through route A"
          % (launches, expected))
    del net, requests
    gc.collect()
    torch.cuda.empty_cache()
    return dict(request_ms=request_ms, launches=launches["wide16_launches"])


def last_token(mx, lm):
    """The served model of phase 4f: ``lm``'s last position, as a tuple of
    its logits (vocab,) in the LM's dtype and their argmax, so a response
    row is 64 KB rather than the whole (seq, vocab) logits."""

    class LastToken(mx.gluon.HybridBlock):
        def __init__(self, lm, **kwargs):
            super().__init__(**kwargs)
            self.lm = lm

        def hybrid_forward(self, F, tokens):
            last = F.slice_axis(self.lm(tokens), axis=1, begin=-1, end=None)
            last = F.reshape(last, shape=(0, -1))
            return last, F.argmax(last, axis=-1)

    return LastToken(lm)


def graph_pool_bytes(torch, pool):
    """Bytes of the caching allocator's segments in a CUDA graph memory
    pool (torch.cuda.memory_snapshot), or None when the snapshot does not
    name pools."""
    segs = torch.cuda.memory_snapshot()
    if not any("segment_pool_id" in seg for seg in segs):
        return None
    return sum(seg["total_size"] for seg in segs
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def closed_loop(srv, prompts, clients, until=None):
    """``clients`` threads, each sending its share of ``prompts`` one after
    another (the next when the last answered): once, or round and round
    until ``until(answers so far)`` is true.  Returns ([(request, row,
    record, client)] in answer order, errors, wall s)."""
    results, errors, lock = [], [], threading.Lock()

    def client(k):
        try:
            while True:
                for i in range(k, len(prompts), clients):
                    with lock:
                        if until is not None and until(len(results)):
                            return
                    fut = srv.submit("lm", prompts[i])
                    row = fut.get(timeout=600.0)
                    with lock:
                        results.append((i, row, fut.record, k))
                if until is None:
                    return
        except Exception as exc:
            errors.append(repr(exc))

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900.0)
    return results, errors, time.perf_counter() - t0


def traffic_report(what, results, wall_s, card):
    """Print and check one traffic run's SLO records: the exact sum, the
    batch sizes, latency quantiles, tokens/s and each component's mean."""
    from incubator_mxnet_tpu_torch.serving import slo
    recs = [r for _, _, r, _ in results]
    for r in recs:
        check(sum(r["components"][c] for c in slo.COMPONENTS) == r["wall_s"],
              "%s: SLO components do not sum to the wall exactly: %r"
              % (what, r))
    hist = {}
    for r in recs:
        hist[r["batch_size"]] = hist.get(r["batch_size"], 0) + 1
    batches = {b: n // b for b, n in sorted(hist.items())}
    p50, p99 = slo.quantiles(recs)
    means = {c: round(sum(r["components"][c] for r in recs) / len(recs) * 1e3,
                      3) for c in slo.COMPONENTS}
    tokens = len(recs) * LM_CONFIG["seq_len"]
    print("serve 4f: %s: %d requests in %.3f s, %.1f tokens/s; batches by "
          "size %s; latency p50 %.3f ms p99 %.3f ms; mean ms by component "
          "%s (their sum equals each request's wall exactly) | %s"
          % (what, len(recs), wall_s, tokens / wall_s, batches, p50 * 1e3,
             p99 * 1e3, json.dumps(means), card), flush=True)
    return dict(requests=len(recs), wall_s=wall_s,
                tokens_per_s=tokens / wall_s, batches_by_size=batches,
                p50_ms=p50 * 1e3, p99_ms=p99 * 1e3, component_ms=means)


def serve_runtime(mx, net, card, rs):
    """Phase 4f: the serving runtime (``mx.serving.Server``) serving the
    full-width LM through per-bucket CUDA-graph programs.  The flash
    launch counter is zeroed just before and read just after (it counts at
    eager runs and captures; a replay launches no Python); the trace of
    one bucket-8 replay proves the kernel runs in the served path."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch import serving
    from incubator_mxnet_tpu_torch.serving.batcher import host_rows
    from incubator_mxnet_tpu_torch.models import TransformerLM, HostXavier
    from incubator_mxnet_tpu_torch.ops.attention import flash_attention
    cfg = LM_CONFIG
    dev = torch.device("cuda", 0)
    lm = last_token(mx, net)
    prompts = [rs.randint(0, cfg["vocab"], (cfg["seq_len"],)).astype(np.int32)
               for _ in range(SERVE_REQUESTS)]
    out = {}
    torch.cuda.synchronize()
    flash_attention.launches = 0
    srv = serving.Server(max_batch=max(SERVE_BUCKETS), max_wait_ms=5)
    # 1. load: the registry's own copy of the weights and a pinned host copy
    t0 = time.perf_counter()
    h = srv.load("lm", block=lm, example=mx.nd.array(
        prompts[0][None], ctx=mx.gpu(0), dtype="int32"))
    out["load_s"] = time.perf_counter() - t0
    print("serve 4f: Server(max_batch=%d, max_wait_ms=5).load(\"lm\", "
          "LastToken(TransformerLM %s), bf16): %d bytes of weights in %.3f s "
          "| %s" % (max(SERVE_BUCKETS), cfg, h.nbytes, out["load_s"], card),
          flush=True)
    # 2. warmup: one program per bucket, captured off the hot path
    out["buckets"] = {}
    for b in SERVE_BUCKETS:
        n0 = len(h.capture_log)
        t0 = time.perf_counter()
        srv.warmup("lm", prompts[0], buckets=[b])
        warm_s = time.perf_counter() - t0
        cap_s = sum(sec for _, _, sec in h.capture_log[n0:])
        pool = graph_pool_bytes(torch, h._pool)
        out["buckets"][b] = dict(capture_s=cap_s, warmup_s=warm_s,
                                 pool_bytes=pool)
        print("serve 4f: bucket %d: capture %.3f s (warmup with its eager "
              "run and probe %.3f s); the handle's graph pool %s bytes | %s"
              % (b, cap_s, warm_s, "not measured" if pool is None else pool,
                 card), flush=True)
    check(h.captures == len(SERVE_BUCKETS), "warmup captured %d programs for "
          "%d buckets" % (h.captures, len(SERVE_BUCKETS)))

    def oracle():
        """Every request's answer by the bucket-1 program of the current
        version (host rows: logits as f32, the argmax)."""
        _e, params, version = srv.registry.acquire("lm")
        rows = []
        for x in prompts:
            logits, ids = h.jit_for(1)(params, torch.from_numpy(x[None]).to(
                dev))
            rows.append((host_rows(logits)[0], host_rows(ids)[0]))
        return rows, version

    def same(row, ref):
        return row[0].tobytes() == ref[0].tobytes() and \
            row[1].tobytes() == ref[1].tobytes()

    # 3. the oracle, and the eager batch-1 forward against it
    v1, version = oracle()
    check(version == 1, "version %d before any swap" % version)
    eager_err = 0.0
    with mx.autograd.predict_mode():
        for x, ref in zip(prompts, v1):
            logits, ids = lm(mx.nd.array(x[None], ctx=mx.gpu(0),
                                         dtype="int32"))
            eager_err = max(eager_err, float(np.abs(
                logits.asnumpy()[0] - ref[0]).max()))
    out["eager_vs_graph_max_abs"] = eager_err
    print("serve 4f: the bucket-1 program's answers (oracle) for %d "
          "requests; the eager batch-1 forward differs by max |d| %.3e "
          "(reported, not required to be 0)" % (len(prompts), eager_err),
          flush=True)
    # bucket-1 replay against the eager batch-1 forward, in turns
    _e, params, _v = srv.registry.acquire("lm")
    x1 = torch.from_numpy(prompts[0][None]).to(dev)
    x1_nd = mx.nd.NDArray(x1)

    def replay1():
        h.jit_for(1)(params, x1)

    def eager1():
        with mx.autograd.predict_mode():
            lm(x1_nd)

    times = {"graph": [], "eager": []}
    for r in range(6):
        for name, fn in (("graph", replay1), ("eager", eager1)) if r % 2 \
                else (("eager", eager1), ("graph", replay1)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    out["bucket1_graph_ms"] = sum(times["graph"][1:]) / 5
    out["bucket1_eager_ms"] = sum(times["eager"][1:]) / 5
    print("serve 4f: one batch-1 request (%d tokens): bucket-1 graph "
          "replay %.3f ms, eager forward %.3f ms (host clock to "
          "synchronize, mean of 5 after one, in turns) | %s"
          % (cfg["seq_len"], out["bucket1_graph_ms"],
             out["bucket1_eager_ms"], card), flush=True)
    del params, _e
    # 4. closed-loop traffic
    results, errors, wall = closed_loop(srv, prompts, SERVE_CLIENTS)
    check(not errors and len(results) == len(prompts),
          "traffic: %d answers, errors %s" % (len(results), errors))
    for i, row, rec, _k in results:
        check(same(row, v1[i]) and rec["version"] == 1, "traffic: request %d "
              "differs from the bucket-1 program" % i)
    out["traffic"] = traffic_report("closed loop, %d clients" % SERVE_CLIENTS,
                                    results, wall, card)
    # 5. a swap mid-traffic to a second version (HostXavier(SEED + 1), bf16)
    v2net = TransformerLM(**cfg)
    v2net.pos_embed.init = None
    v2net.initialize(HostXavier(SEED + 1), ctx=mx.gpu(0))
    v2net.cast("bfloat16")
    v2net.collect_params().setattr("grad_req", "null")
    with mx.autograd.predict_mode():
        v2net(mx.nd.array(prompts[0][None], ctx=mx.gpu(0),
                          dtype="int32")).wait_to_read()
    names = sorted(lm.collect_params().keys())
    v2names = sorted(v2net.collect_params().keys())
    check([n[len(net.prefix):] for n in names] ==
          [n[len(v2net.prefix):] for n in v2names],
          "the second version's parameters do not match the served ones")
    new_params = {n: v2net.collect_params()[m].data()._data.cpu()
                  for n, m in zip(names, v2names)}
    del v2net
    gc.collect()
    torch.cuda.empty_cache()
    # the clients go round until SERVE_REQUESTS answers came after the
    # commit; the swap starts after SERVE_REQUESTS // 4 answers
    swap_at = SERVE_REQUESTS // 4
    box = {}

    def until(n):       # called under closed_loop's lock
        if n >= swap_at and "thread" not in box:
            box["thread"] = threading.Thread(target=swapper)
            box["thread"].start()
        if "version" not in box:
            return False
        return n >= box.setdefault("answers_at_commit", n) + SERVE_REQUESTS

    def swapper():
        t0 = time.perf_counter()
        version = srv.swap("lm", new_params)
        box["swap_s"] = time.perf_counter() - t0
        box["version"] = version

    results, errors, wall = closed_loop(srv, prompts, SERVE_CLIENTS, until)
    box.pop("thread").join(600.0)
    check(not errors and box.get("version") == 2, "swap traffic: %d answers, "
          "errors %s, swap %s" % (len(results), errors, box))
    v2, version = oracle()
    check(version == 2, "version %d after the swap" % version)
    by_version = {1: 0, 2: 0}
    per_client = {}
    for i, row, rec, k in results:
        ref = v1[i] if rec["version"] == 1 else v2[i]
        check(same(row, ref), "swap traffic: request %d is not entirely "
              "version %d's answer" % (i, rec["version"]))
        check(not same(v1[i], v2[i]), "the two versions answer request %d "
              "alike" % i)
        by_version[rec["version"]] += 1
        per_client.setdefault(k, []).append(rec["version"])
    for k, vs in per_client.items():
        check(vs == sorted(vs), "client %d saw versions %s: not monotonic"
              % (k, vs))
    check(by_version[1] > 0 and by_version[2] > 0, "responses by version %s: "
          "the swap did not land mid-traffic" % by_version)
    out["swap"] = dict(box, by_version=by_version, traffic=traffic_report(
        "closed loop with a swap after %d answers" % swap_at, results, wall,
        card))
    print("serve 4f: swap to version 2 (HostXavier(%d), bf16) in %.3f s "
          "mid-traffic; responses by version %s, every one entirely its "
          "version's, monotonic per client | %s"
          % (SEED + 1, box["swap_s"], by_version, card), flush=True)
    del new_params
    # 6. eviction, then one request: a transparent reload, bit for bit
    loader, reload_s = h._loader, []

    def timed_loader():
        t0 = time.perf_counter()
        params = loader()
        reload_s.append(time.perf_counter() - t0)
        return params

    h._loader = timed_loader
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    check(srv.registry.evict("lm") and not h.resident and
          not h.graph_keys(), "evict kept the weights or the graphs")
    gc.collect()
    torch.cuda.synchronize()
    freed = held - torch.cuda.memory_allocated()
    captures = h.captures
    t0 = time.perf_counter()
    row = srv.predict("lm", prompts[0], timeout=600.0)
    request_s = time.perf_counter() - t0
    check(len(reload_s) == 1 and h.resident and h.version == 2 and
          srv.registry.reloads_total == 1 and same(row, v2[0]),
          "the evicted model did not reload to version 2 bit for bit")
    out["reload"] = dict(reload_s=reload_s[0], request_s=request_s,
                         freed_bytes=freed,
                         recaptures=h.captures - captures)
    print("serve 4f: evict freed %d bytes (weights and graphs); the next "
          "request reloaded version 2 in %.3f s (request %.3f s with its "
          "bucket-1 capture), bit-equal | %s"
          % (freed, reload_s[0], request_s, card), flush=True)
    # 7. one fused pass: the probe decides, no delivered row may differ
    os.environ["GRAFT_SERVE_BATCH_MODE"] = "fused"
    try:
        futs = [srv.submit("lm", prompts[i]) for i in range(8)]
        rows = [f.get(timeout=600.0) for f in futs]
    finally:
        del os.environ["GRAFT_SERVE_BATCH_MODE"]
    for i, (f, row) in enumerate(zip(futs, rows)):
        check(same(row, v2[i]), "fused pass: request %d differs from the "
              "bucket-1 program" % i)
    demoted = bool(h.no_batch)
    _e, params, _v = srv.registry.acquire("lm")
    x8 = torch.from_numpy(np.stack(prompts[:8])).to(dev)
    logits8, _ids8 = h.jit_for(8, "fused")(params, x8)
    fused_err = float(np.abs(host_rows(logits8) - np.stack(
        [r[0] for r in v2[:8]])).max())
    out["fused"] = dict(demoted=demoted, sizes=sorted(
        {f.record["batch_size"] for f in futs}), max_abs_vs_bucket1=fused_err)
    print("serve 4f: fused pass (GRAFT_SERVE_BATCH_MODE=fused), batch sizes "
          "%s: the probe %s; the fused bucket-8 program differs from the "
          "bucket-1 program by max |d| %.3e; every delivered row bit-equal "
          "to the bucket-1 program | %s"
          % (out["fused"]["sizes"], "demoted the shape to per-request "
             "dispatch" if demoted else "found row 0 bit-equal (kept)",
             fused_err, card), flush=True)
    # 8. the kernel in the served path: one exact bucket-8 replay, traced
    program = h.jit_for(8, "exact")
    got = [program(params, x8)]
    prof, wall_us = profiled(lambda: got.__setitem__(0, program(params, x8)))
    got = got[0]
    kernels = trace_kernels(prof)
    flash = sum(n for name, (_, n) in kernels.items()
                if "flash_fwd_sm90_kernel" in name)
    busy = sum(us for us, _ in kernels.values())
    for i in range(8):
        check(same((host_rows(got[0])[i], host_rows(got[1])[i]), v2[i]),
              "the traced bucket-8 replay differs from the bucket-1 program "
              "on row %d" % i)
    out["replay8"] = dict(flash_fwd_sm90_kernel=flash, wall_us=wall_us,
                          busy_us=busy, busy_share=busy / wall_us,
                          idle_share=max(0.0, 1 - busy / wall_us))
    print("serve 4f: one exact bucket-8 replay under torch.profiler: %d "
          "flash_fwd_sm90_kernel launches (expected %d), %d device "
          "activities, wall "
          "%.1f us, device busy %.1f us, busy share %.4f, idle share %.4f "
          "| %s" % (flash, 8 * cfg["n_layers"], sum(
              n for _, n in kernels.values()), wall_us, busy,
                    busy / wall_us, out["replay8"]["idle_share"], card),
          flush=True)
    check(flash == 8 * cfg["n_layers"], "the bucket-8 replay's trace lists "
          "%d flash_fwd_sm90_kernel launches, expected %d"
          % (flash, 8 * cfg["n_layers"]))
    del got, logits8, _ids8, params, _e, x8, program
    out["launches"] = flash_attention.launches
    out["captures"] = h.captures
    out["stats"] = srv.stats()["registry"]["models"]["lm"]
    srv.close()
    srv.registry.unload("lm")
    print("serve 4f: flash_attention launches counted on the path (eager "
          "runs and captures; replays launch no Python) %d; captures %d "
          "| %s" % (out["launches"], out["captures"], card), flush=True)
    check(out["launches"] > 0, "phase 4f launched no flash kernel")
    # 9. the CLI's selftest on the card, as a subprocess
    proc = subprocess.run([sys.executable, "-m",
                           "incubator_mxnet_tpu_torch.serving", "--selftest"],
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    for line in proc.stdout.splitlines():
        print("serve 4f: selftest: " + line)
    check(proc.returncode == 0 and "selftest OK" in proc.stdout,
          "python -m incubator_mxnet_tpu_torch.serving --selftest exited %d: "
          "%s" % (proc.returncode, proc.stderr[-2000:]))
    del srv, h, lm
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_small_lm(mx, card):
    """The small f32 LM trained SMALL_TRAIN_STEPS steps through
    DataParallelTrainer on the card against the same steps on the CPU, from
    the same weights; the flash kernel's counts zeroed just before the
    card's run and read just after.  Returns the card run's launches."""
    import numpy as np
    from incubator_mxnet_tpu_torch.models import TransformerLM, HostXavier
    from incubator_mxnet_tpu_torch.convert import (load_numpy_params,
                                                   numpy_params)
    from incubator_mxnet_tpu_torch.ops.attention import (flash_attention,
                                                         split_f32)
    small = SMALL_LMS[0][2]
    rs = np.random.RandomState(SEED + 3)
    tokens = rs.randint(0, small["vocab"], (2, small["seq_len"]))
    labels = rs.randint(0, small["vocab"],
                        (2, small["seq_len"])).astype(np.float32)
    with mx.cpu():
        init = TransformerLM(**small)
        init.initialize(HostXavier(SEED))
        init(mx.nd.array(tokens))
        weights = numpy_params(init)

    def run(ctx):
        with ctx:
            net = TransformerLM(**small)
            load_numpy_params(net, weights, ctx)
            trainer = mx.parallel.DataParallelTrainer(
                net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                dict(TRAIN_OPT))
            x = mx.nd.array(tokens, dtype="int32")
            y = mx.nd.array(labels)
            losses = [float(trainer.step(x, y).asscalar())
                      for _ in range(SMALL_TRAIN_STEPS)]
            trainer.sync_params()
            return losses, _by_suffix(numpy_params(net))

    want_losses, want_w = run(mx.cpu())
    flash_attention.launches = flash_attention.f32_launches = 0
    flash_attention.backward_calls = split_f32.launches = 0
    flash_attention.backward_kernel_launches = 0
    flash_attention.backward_torch_calls = 0
    got_losses, got_w = run(mx.gpu(0))
    launches = {"launches": flash_attention.launches,
                "f32_launches": flash_attention.f32_launches,
                "split_f32": split_f32.launches,
                "backward_calls": flash_attention.backward_calls,
                "backward_torch_calls": flash_attention.backward_torch_calls,
                "backward_kernel_launches":
                    flash_attention.backward_kernel_launches}
    w_err = max(float(np.abs(got_w[k] - want_w[k]).max()) for k in want_w)
    l_err = max(abs(a - b) / abs(b) for a, b in zip(got_losses, want_losses))
    print("train: small LM %s f32, %d steps through DataParallelTrainer on "
          "the card vs the CPU: losses %s vs %s (max rel err %.3e, bound "
          "%.0e), weights max_abs_err %.3e (bound %.0e); launches %s | %s"
          % (small, SMALL_TRAIN_STEPS, ["%.6f" % v for v in got_losses],
             ["%.6f" % v for v in want_losses], l_err, SMALL_TRAIN_LOSS_RTOL,
             w_err, SMALL_TRAIN_W_TOL, launches, card), flush=True)
    expected = small["n_layers"] * SMALL_TRAIN_STEPS
    check(launches["f32_launches"] == expected and
          launches["backward_calls"] == expected and
          launches["backward_torch_calls"] == expected and
          launches["backward_kernel_launches"] == 0,
          "small LM training: %s for %d layers x %d steps" % (
              launches, small["n_layers"], SMALL_TRAIN_STEPS))
    check(sorted(got_w) == sorted(want_w), "small LM training: names differ")
    check(w_err <= SMALL_TRAIN_W_TOL, "small LM training: card and CPU "
          "weights disagree")
    check(l_err <= SMALL_TRAIN_LOSS_RTOL, "small LM training: card and CPU "
          "losses disagree")
    check(got_losses[-1] < got_losses[0], "small LM training: the loss did "
          "not fall: %s" % got_losses)
    return launches


def train_full_lm(mx, card):
    """The LM of bench_transformer.py at full width, uncut, trained as the
    bench trains it (:147-170), TRAIN_WARMUP steps then TRAIN_STEPS timed
    steps; one more step under the profiler.  Returns the run's numbers."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch.models import TransformerLM, HostXavier
    from incubator_mxnet_tpu_torch.ops.attention import flash_attention
    cfg = LM_CONFIG
    batch, seq, vocab = TRAIN_BATCH, cfg["seq_len"], cfg["vocab"]
    t0 = time.perf_counter()
    net = TransformerLM(**cfg)
    net.pos_embed.init = None      # HostXavier for every weight, as the bench
    net.initialize(HostXavier(SEED), ctx=mx.gpu(0))
    rs = np.random.RandomState(0)
    x = mx.nd.array(rs.randint(0, vocab, (batch, seq)), ctx=mx.gpu(0),
                    dtype="int32")
    y = mx.nd.array(rs.randint(0, vocab, (batch, seq)).astype(np.float32),
                    ctx=mx.gpu(0))
    trainer = mx.parallel.DataParallelTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", dict(TRAIN_OPT),
        dtype="bfloat16")
    losses, step_ms = [], []
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        if i == TRAIN_WARMUP:      # the timed steps: counts from 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            flash_attention.launches = flash_attention.backward_calls = 0
            flash_attention.backward_kernel_launches = 0
            flash_attention.backward_torch_calls = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(float(trainer.step(x, y).asscalar()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        if i == 0:
            print("train: TransformerLM %s, DataParallelTrainer(sgd %s, "
                  "dtype=bfloat16), batch %d x %d: built, initialized and "
                  "the first step in %.1f s" % (cfg, TRAIN_OPT, batch, seq,
                                                time.perf_counter() - t0),
                  flush=True)
    launches = {"flash_attention_fwd": flash_attention.launches,
                "flash_attention_bwd_calls": flash_attention.backward_calls,
                "flash_attention_bwd": flash_attention.backward_kernel_launches,
                "flash_attention_bwd_torch_calls":
                    flash_attention.backward_torch_calls}
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(int(np.prod(p.shape)) for p in
                   net.collect_params().values())
    n_matmul = n_params - (vocab + seq) * cfg["d_model"]
    tokens = batch * seq
    flops = model_flops_per_step(n_matmul, tokens, seq, cfg["d_model"],
                                 cfg["n_layers"])
    timed = step_ms[TRAIN_WARMUP:]
    mean_s = sum(timed) / len(timed) / 1e3
    for i, (ms, loss) in enumerate(zip(step_ms, losses)):
        print("train: step %d%s: %.3f ms, loss %.6f | %s"
              % (i, " (warm-up)" if i < TRAIN_WARMUP else "", ms, loss, card))
    result = {"n_params": n_params, "n_params_non_embedding": n_matmul,
              "step_ms": timed, "step_ms_mean": mean_s * 1e3,
              "tokens_per_s": tokens / mean_s,
              "mfu": flops / mean_s / H100_BF16_FLOPS,
              "model_flops_per_step": flops, "peak_memory_bytes": peak,
              "losses": losses, "launches": launches}
    print("train: %d parameters (%d non-embedding); %d timed steps: mean "
          "%.3f ms, %.1f tokens/s, MFU %.4f (%.4e model flop a step over "
          "989 TFLOP/s); peak memory allocated %d bytes; launches %s in %d "
          "steps (%.1f flash forward launches a step) | %s"
          % (n_params, n_matmul, TRAIN_STEPS, result["step_ms_mean"],
             result["tokens_per_s"], result["mfu"], flops, peak, launches,
             TRAIN_STEPS, launches["flash_attention_fwd"] / TRAIN_STEPS,
             card), flush=True)
    check(all(math.isfinite(v) for v in losses), "training loss not finite: "
          "%s" % losses)
    check(losses[-1] < losses[0], "training loss did not fall: %s" % losses)
    expected = cfg["n_layers"] * TRAIN_STEPS
    check(launches["flash_attention_fwd"] == expected and
          launches["flash_attention_bwd_calls"] == expected and
          launches["flash_attention_bwd"] == expected and
          launches["flash_attention_bwd_torch_calls"] == 0,
          "training launches %s, expected %d each and no backward through "
          "the torch ops" % (launches, expected))
    d, f = cfg["d_model"], cfg["d_ffn"]
    gemm_flops = 3 * 2.0 * tokens * (cfg["n_layers"] * (4 * d * d + 2 * d * f)
                                     + d * vocab)
    result["profile"] = profile_training_step(
        lambda: trainer.step(x, y).asscalar(), gemm_flops, card)
    del trainer, net, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 6: ResNet-50 v1, the model of bench.py (:199-211) and of
# BASELINE.json's config 2: convolutions on cuDNN (aten.convolution, TF32
# off for f32), Pooling and BatchNorm in torch ops; no hand kernel
# ---------------------------------------------------------------------------
RESNET_SMALL = dict(thumbnail=True, classes=10)
RESNET_SMALL_BATCH, RESNET_SMALL_STEPS = 4, 3
RESNET_SMALL_OPT = {"learning_rate": 0.01, "momentum": 0.9}
# card vs CPU in f32 (6a): the same f32 operations summed in other orders
# (cuDNN's convolutions, the CPU's), ~1e-7 each, carried through 49
# (batch-)normalized layers: ~1e-5 of the largest logit (the CPU tests
# measure 2.4e-5 between the port and the JAX build in training mode).  A
# TF32 convolution rounds its inputs to 10 mantissa bits (~5e-4 each), so
# this bound must fail for it; the smoke runs the same forward with TF32 on
# and checks that it does
RESNET_F32_REL = 1e-4
# a trainer step taken on the card from the CPU's state: the loss and the
# running statistics to RESNET_F32_REL, each weight's update and momentum
# to a relative L2 distance of 0.1 (the gradients: relu's derivative jumps
# at 0, and the JAX build's own gradients move by 2-2.5% when its input
# moves by one ulp, tests/test_torch_resnet.py); in bf16 each to twice the
# CPU's own bf16-to-f32 distance after its first step, or those floors
RESNET_UPDATE_L2 = 0.1
# 6b: BASELINE.md:17's ResNet-50 inference batch, bf16, 224x224
RESNET_IMAGE = 224
RESNET_SERVE_BATCH, RESNET_SERVE_BATCHES = 32, 4
# 6c: bench.py's step: batch 256 of 3x224x224, bf16 compute over f32
# master weights, SGD momentum 0.9 at lr 0.1
RESNET_TRAIN_BATCH, RESNET_TRAIN_WARMUP, RESNET_TRAIN_STEPS = 256, 3, 5
RESNET_TRAIN_OPT = {"learning_rate": 0.1, "momentum": 0.9}
# the ops whose calls a profile attributes by span (smoke-side
# record_function wrappers, installed only around a profiled call), and the
# autograd nodes of their backward
RESNET_OP_SPANS = ("Convolution", "BatchNorm", "Pooling", "Activation",
                   "broadcast_add", "FullyConnected")
RESNET_GROUPS = (
    ("conv_layout_transpose", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("conv_fwd", ("op:Convolution",)),
    ("conv_dgrad_wgrad", ("_ConvolutionFunctionBackward",)),
    ("batchnorm", ("op:BatchNorm", "_BatchNormTrainFunction")),
    ("relu_add", ("op:Activation", "op:broadcast_add", "ReluBackward",
                  "ThresholdBackward", "AddBackward")),
    ("pooling", ("op:Pooling", "MaxPool2DWithIndicesBackward",
                 "AvgPool2DBackward", "ConstantPadNdBackward")),
    ("optimizer_update", ("DataParallelTrainer.update",)),
)


def op_device_work(prof):
    """The device work of a :func:`profiled` session's timed call, each
    item with the names of the CPU spans (record_function spans and torch
    ops, autograd nodes included) that enclose its launch on the launching
    thread: [(kernel name, us, [span names])]."""
    from incubator_mxnet_tpu_torch import cuda_build
    path = cuda_build.BUILD_DIR.parent / ("trace-op-%d.json" % os.getpid())
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        path.unlink()
    launches, spans, timed, device = {}, {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args") or {}
        a, b = e["ts"], e["ts"] + e.get("dur", 0)
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = (a, e.get("tid"))
        elif cat in ("cpu_op", "user_annotation"):
            if e.get("name") == PROFILED_SPAN:
                timed.append((a, b))
            spans.setdefault(e.get("tid"), []).append((a, b, e.get("name")))
        elif cat in DEVICE_CATEGORIES:
            device.append((e.get("name", ""), float(e.get("dur", 0)),
                           args.get("correlation")))
    work = []
    for name, us, corr in device:
        ts, tid = launches.get(corr, (None, None))
        if ts is None or not any(a <= ts <= b for a, b in timed):
            continue
        work.append((name, us, [n for a, b, n in spans.get(tid, ())
                                if a <= ts <= b]))
    return work


@contextlib.contextmanager
def wrapped_ops(names, wrap):
    """While active, the fcompute of each registered op in ``names`` is
    ``wrap(name, fcompute)``; the originals come back on the way out."""
    from incubator_mxnet_tpu_torch.ops.registry import get_op
    saved = [(get_op(n), get_op(n).fcompute) for n in names]
    for (op, real), n in zip(saved, names):
        op.fcompute = wrap(n, real)
    try:
        yield
    finally:
        for op, real in saved:
            op.fcompute = real


def _in_span(name, real):
    """``real`` inside a record_function span ``op:<name>``."""
    import torch

    def call(*a, **k):
        with torch.profiler.record_function("op:" + name):
            return real(*a, **k)
    return call


def resnet_profile(run, what, card, spans=RESNET_OP_SPANS,
                   groups=RESNET_GROUPS):
    """One call of ``run`` under torch.profiler (:func:`profiled`), device
    time by ``groups`` (a kernel joins the first group one of whose keys
    is in its name or in a span around its launch; the registered ops in
    ``spans`` run inside spans ``op:<name>``), with the idle share."""
    with wrapped_ops(spans, _in_span):
        prof, wall_us = profiled(run)
    work = op_device_work(prof)
    if not work:
        print("profile: torch.profiler recorded no device time: not measured")
        return None
    by_group = dict.fromkeys([g for g, _ in groups] + ["other"], 0.0)
    top = {}
    for name, us, names in work:
        low = name.lower()
        group = next((g for g, keys in groups
                      if any(k in low for k in keys) or
                      any(k in n for k in keys for n in names if n)), "other")
        by_group[group] += us
        top[(group, name)] = top.get((group, name), 0.0) + us
    busy = sum(by_group.values())
    out = dict(by_group, wall_us=wall_us, busy_us=busy,
               idle_share=max(0.0, 1 - busy / wall_us))
    print("profile: %s under torch.profiler: wall %.1f us, device busy %.1f "
          "us, idle share %.4f | %s" % (what, wall_us, busy,
                                        out["idle_share"], card))
    print("profile: device us by group %s" % json.dumps(
        {k: round(v, 1) for k, v in by_group.items()}), flush=True)
    for (group, name), us in sorted(top.items(), key=lambda kv: -kv[1])[:10]:
        print("profile:   %10.1f us  %-22s %s" % (us, group, name[:90]))
    return out


@contextlib.contextmanager
def conv_flops():
    """While active, counts into the yielded list's one item the flop (2 a
    multiply-add) of every Convolution and FullyConnected call, from its
    own shapes; a call on meta tensors (shape inference) computes nothing
    and is not counted."""
    count = [0]

    def wrap(_name, real):
        def call(data, weight, *a, **k):
            out = real(data, weight, *a, **k)
            if out.device.type != "meta":
                count[0] += 2 * out.numel() * int(math.prod(
                    weight.shape[1:]))
            return out
        return call
    with wrapped_ops(("Convolution", "FullyConnected"), wrap):
        yield count


def _resnet_weights(mx, np, rs):
    """The small ResNet's f32 weights by name: the port's Xavier draws
    (seeded) with BatchNorm's gamma, beta and running statistics drawn away
    from their init."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    from incubator_mxnet_tpu_torch.convert import numpy_params
    mx.random.seed(SEED)
    with mx.cpu():
        net = vision.resnet50_v1(**RESNET_SMALL)
        net.initialize(mx.init.Xavier())
        with mx.autograd.predict_mode():
            net(mx.nd.array(np.zeros((1, 3, 32, 32), np.float32)))
        weights = numpy_params(net)
    for name, v in weights.items():
        if name.endswith("gamma") or name.endswith("running_var"):
            weights[name] = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif name.endswith("beta") or name.endswith("running_mean"):
            weights[name] = (0.1 * rs.standard_normal(v.shape)).astype(
                np.float32)
    return weights


def _resnet_forward(mx, weights, x, y, ctx):
    """The small ResNet from ``weights`` on ``ctx``: (inference logits,
    training-mode logits, the loss of that forward)."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    from incubator_mxnet_tpu_torch.convert import load_numpy_params
    with ctx:
        net = vision.resnet50_v1(**RESNET_SMALL)
        load_numpy_params(net, weights, ctx)
        xs, ys = mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx)
        with mx.autograd.predict_mode():
            infer = net(xs).asnumpy()
        with mx.autograd.train_mode():
            logits = net(xs)
            loss = mx.nd.mean(mx.gluon.loss.SoftmaxCrossEntropyLoss()(
                logits, ys)).asscalar()
        return infer, logits.asnumpy(), float(loss)


class _SmallTrainer(object):
    """A DataParallelTrainer of the small ResNet on ``ctx`` whose state (f32
    master weights and momenta, by short name) can be read and set, so the
    card can take each step from the CPU's state before it."""

    def __init__(self, mx, weights, x, y, ctx, dtype):
        from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
        from incubator_mxnet_tpu_torch.convert import load_numpy_params
        self.ctx = ctx
        with ctx:
            self.net = vision.resnet50_v1(**RESNET_SMALL)
            load_numpy_params(self.net, weights, ctx)
            self.x, self.y = mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx)
            self.tr = mx.parallel.DataParallelTrainer(
                self.net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                dict(RESNET_SMALL_OPT), dtype=dtype)
            self.tr._gather_params(self.x._data)

    def state(self):
        cut = len(self.net.prefix)
        return ({n[cut:]: v.cpu().numpy().copy()
                 for n, v in self.tr._params.items()},
                {n[cut:]: s[0].cpu().numpy().copy()
                 for n, s in self.tr._opt_state.items()})

    def load(self, state):
        import torch
        weights, moms = state
        cut = len(self.net.prefix)
        with torch.no_grad():
            for n, v in self.tr._params.items():
                v.copy_(torch.from_numpy(weights[n[cut:]]))
            for n, (mom,) in self.tr._opt_state.items():
                mom.copy_(torch.from_numpy(moms[n[cut:]]))

    def step(self):
        with self.ctx:
            return float(self.tr.step(self.x, self.y).asscalar())


def _step_errors(before, got, want, loss_got, loss_want):
    """One step taken from the same state: the loss's relative error, the
    running statistics' largest error over each one's largest value (the
    forward's), and the largest relative L2 distance of a weight's update or
    momentum (the gradient's); the 1x1 convolutions' biases, which feed
    BatchNorm and have no true gradient, as their largest |update|."""
    (w0, _), (g1, gm), (w1, m1) = before, got, want
    out = dict(loss=abs(loss_got - loss_want) / abs(loss_want), stats=0.0,
               update=0.0, pre_bn_bias=0.0, update_name="")

    def l2(a, b):
        return float(((a - b) ** 2).sum() ** 0.5 /
                     max(float((b ** 2).sum() ** 0.5), 1e-30))
    for n in w1:
        if "running" in n:
            out["stats"] = max(out["stats"], float(abs(g1[n] - w1[n]).max()
                                                   / abs(w1[n]).max()))
        elif n.endswith("bias") and not n.startswith("dense"):
            out["pre_bn_bias"] = max(out["pre_bn_bias"],
                                     float(abs(g1[n] - w0[n]).max()))
        else:
            e = max(l2(g1[n] - w0[n], w1[n] - w0[n]), l2(gm[n], m1[n]))
            if e > out["update"]:
                out["update"], out["update_name"] = e, n
    return out


def resnet_small(mx, card):
    """Phase 6a: resnet50_v1(thumbnail=True, classes=10), batch 4 of 32x32,
    the same weights on the card and on the CPU: the inference forward, the
    training-mode forward and loss in f32 (TF32 on by torch's default: the
    op's guard must keep f32), and once more with TF32 convolutions, which
    must break the f32 bound; then RESNET_SMALL_STEPS DataParallelTrainer
    steps in f32 and in bf16 compute, each taken on the card from the CPU's
    state before it (two runs from one start part after a step: relu's
    derivative jumps at 0 and the net amplifies rounding differences,
    tests/test_torch_resnet.py)."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch.ops import nn as tnn
    rs = np.random.RandomState(SEED + 6)
    weights = _resnet_weights(mx, np, rs)
    x = rs.standard_normal((RESNET_SMALL_BATCH, 3, 32, 32)).astype(
        np.float32)
    y = rs.randint(0, RESNET_SMALL["classes"], RESNET_SMALL_BATCH).astype(
        np.float32)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True      # torch's default
    try:
        cpu_fwd = _resnet_forward(mx, weights, x, y, mx.cpu())
        card_fwd = _resnet_forward(mx, weights, x, y, mx.gpu(0))

        @contextlib.contextmanager
        def tf32_convolutions():
            yield                       # the guard left out: TF32 stays on
        real_guard = tnn._f32_convolutions
        tnn._f32_convolutions = tf32_convolutions
        try:
            tf32_fwd = _resnet_forward(mx, weights, x, y, mx.gpu(0))
        finally:
            tnn._f32_convolutions = real_guard
        steps = {}
        for dtype in (None, "bfloat16"):
            cpu = _SmallTrainer(mx, weights, x, y, mx.cpu(), dtype)
            gpu = _SmallTrainer(mx, weights, x, y, mx.gpu(0), dtype)
            rows = []
            for _ in range(RESNET_SMALL_STEPS):
                before = cpu.state()
                loss_want = cpu.step()
                gpu.load(before)
                loss_got = gpu.step()
                rows.append((before, gpu.state(), cpu.state(), loss_got,
                             loss_want))
            steps[dtype] = rows
    finally:
        torch.backends.cudnn.allow_tf32 = prev

    def rel(got, want):
        return float(np.abs(got - want).max() / np.abs(want).max())
    errs = {"infer_f32": rel(card_fwd[0], cpu_fwd[0]),
            "infer_tf32": rel(tf32_fwd[0], cpu_fwd[0]),
            "train_logits_f32": rel(card_fwd[1], cpu_fwd[1]),
            "train_logits_tf32": rel(tf32_fwd[1], cpu_fwd[1]),
            "train_loss_f32": abs(card_fwd[2] - cpu_fwd[2]) / cpu_fwd[2]}
    print("resnet 6a: resnet50_v1%s, batch %d: card vs CPU, max |d| / max "
          "|CPU|: %s; f32 bound %.0e, which TF32 must break | %s"
          % (RESNET_SMALL, RESNET_SMALL_BATCH, json.dumps(
              {k: "%.3e" % v for k, v in errs.items()}), RESNET_F32_REL,
             card), flush=True)
    check(errs["infer_f32"] <= RESNET_F32_REL and
          errs["train_logits_f32"] <= RESNET_F32_REL and
          errs["train_loss_f32"] <= RESNET_F32_REL,
          "6a: card and CPU disagree in f32: %s" % errs)
    check(errs["infer_tf32"] > RESNET_F32_REL and
          errs["train_logits_tf32"] > RESNET_F32_REL,
          "6a: TF32 convolutions do not break the f32 bound, so it does not "
          "show that f32 stays f32: %s" % errs)
    # bf16: the CPU's own bf16-to-f32 distance after the first step (both
    # from the same start) is the scale of bf16's differences
    (w0, m0), _, f1, _, f_loss = steps[None][0]
    _, _, b1, _, b_loss = steps["bfloat16"][0]
    noise = _step_errors((w0, m0), b1, f1, b_loss, f_loss)
    out = dict(errs, bf16_noise=noise)
    for dtype in (None, "bfloat16"):
        tag = "f32" if dtype is None else "bf16"
        if dtype is None:
            bounds = dict(loss=RESNET_F32_REL, stats=RESNET_F32_REL,
                          update=RESNET_UPDATE_L2, pre_bn_bias=1e-6)
        else:
            bounds = {k: max(floor, 2 * noise[k]) for k, floor in
                      (("loss", RESNET_F32_REL), ("stats", RESNET_F32_REL),
                       ("update", RESNET_UPDATE_L2), ("pre_bn_bias", 1e-6))}
        for k, (before, got, want, loss_got, loss_want) in enumerate(
                steps[dtype]):
            e = _step_errors(before, got, want, loss_got, loss_want)
            out["%s_step%d" % (tag, k)] = e
            print("resnet 6a: %s step %d from the CPU's state: loss card %.6f "
                  "CPU %.6f; errors %s; bounds %s"
                  % (tag, k, loss_got, loss_want, json.dumps(
                      {k_: ("%.3e" % v if isinstance(v, float) else v)
                       for k_, v in e.items()}), json.dumps(
                      {k_: "%.3e" % v for k_, v in bounds.items()})),
                  flush=True)
            check(math.isfinite(loss_got), "6a: a loss is not finite")
            for k_, bound in bounds.items():
                check(e[k_] <= bound, "6a: %s step %d: %s %.3e above %.3e"
                      % (tag, k, k_, e[k_], bound))
    return out


def _resnet_full(mx, np, seed=SEED):
    """resnet50_v1(classes=1000) on the card, Xavier (seeded), its deferred
    shapes resolved."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    mx.random.seed(seed)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    with mx.autograd.predict_mode():
        net(mx.nd.array(np.zeros((1, 3, RESNET_IMAGE, RESNET_IMAGE),
                                 np.float32), ctx=mx.gpu(0)))
    return net


def resnet_serve(mx, card):
    """Phase 6b: resnet50_v1(classes=1000) in bf16, inference mode, batch
    RESNET_SERVE_BATCH of 3x224x224 (seeded): one warm-up batch, then
    RESNET_SERVE_BATCHES timed ones (host clock to synchronize); the bf16
    logits against the f32 net's on the same batch; one batch under the
    profiler by group."""
    import numpy as np
    import torch
    net = _resnet_full(mx, np)
    net.collect_params().setattr("grad_req", "null")
    rs = np.random.RandomState(SEED + 7)
    x32 = mx.nd.array(rs.rand(RESNET_SERVE_BATCH, 3, RESNET_IMAGE,
                              RESNET_IMAGE).astype(np.float32), ctx=mx.gpu(0))
    with mx.autograd.predict_mode():
        ref = net(x32).asnumpy()
    net.cast("bfloat16")
    x = x32.astype("bfloat16")
    del x32

    def batch():
        with mx.autograd.predict_mode():
            return net(x)
    out = batch().asnumpy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(RESNET_SERVE_BATCHES):
        t0 = time.perf_counter()
        batch()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    with conv_flops() as flop:
        batch()
    flop = flop[0]
    mean = sum(ms) / len(ms)
    err = float(np.linalg.norm(out - ref) / np.linalg.norm(ref))
    result = dict(batch_ms=ms, batch_ms_mean=mean,
                  img_per_s=RESNET_SERVE_BATCH / mean * 1e3,
                  peak_memory_bytes=peak, flop=flop,
                  tflops=flop / mean / 1e9, bf16_vs_f32_rel_l2=err)
    print("resnet 6b: resnet50_v1(classes=1000) bf16 inference, batch %d x "
          "3x%dx%d: %s ms a batch (mean %.3f), %.1f img/s, %.4e conv and "
          "dense flop a batch (%.1f TFLOP/s), peak memory allocated %d "
          "bytes; bf16 logits vs the f32 net's, relative L2 %.3e | %s"
          % (RESNET_SERVE_BATCH, RESNET_IMAGE, RESNET_IMAGE,
             ["%.3f" % v for v in ms], mean, result["img_per_s"], flop,
             result["tflops"], peak, err, card), flush=True)
    check(out.shape == (RESNET_SERVE_BATCH, 1000) and
          np.isfinite(out).all(), "6b: logits of shape %s, finite %s"
          % (out.shape, np.isfinite(out).all()))
    check(err <= 0.1, "6b: bf16 logits %.3e (relative L2) from the f32 "
          "net's" % err)
    result["profile"] = resnet_profile(batch, "6b one inference batch", card)
    del net, x
    gc.collect()
    torch.cuda.empty_cache()
    return result


def resnet_train(mx, card):
    """Phase 6c: bench.py's training run on the card: resnet50_v1(classes=
    1000), Xavier, DataParallelTrainer with SoftmaxCrossEntropyLoss, SGD
    momentum 0.9 at lr 0.1, bf16 compute over f32 master weights, batch
    RESNET_TRAIN_BATCH from np.random.RandomState(0) as bench.py makes it;
    RESNET_TRAIN_WARMUP warm-up and RESNET_TRAIN_STEPS timed steps on the
    same batch; one more under the profiler."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    net = _resnet_full(mx, np)
    rs = np.random.RandomState(0)
    x = mx.nd.array(rs.rand(RESNET_TRAIN_BATCH, 3, RESNET_IMAGE,
                            RESNET_IMAGE).astype(np.float32), ctx=mx.gpu(0))
    y = mx.nd.array((rs.rand(RESNET_TRAIN_BATCH) * 1000).astype(np.float32),
                    ctx=mx.gpu(0))
    trainer = mx.parallel.DataParallelTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        dict(RESNET_TRAIN_OPT), dtype="bfloat16")
    running = [n for n in net.collect_params().keys() if "running" in n]
    losses, step_ms, start = [], [], None
    for i in range(RESNET_TRAIN_WARMUP + RESNET_TRAIN_STEPS):
        if i == RESNET_TRAIN_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if i == 0:
            with conv_flops() as forward_flop:
                loss = trainer.step(x, y)
            start = {n: trainer._params[n].clone() for n in running}
        else:
            loss = trainer.step(x, y)
        losses.append(float(loss.asscalar()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        if i == 0:
            print("resnet 6c: built, initialized and the first step in %.1f "
                  "s" % (time.perf_counter() - t0), flush=True)
    peak = torch.cuda.max_memory_allocated()
    timed = step_ms[RESNET_TRAIN_WARMUP:]
    mean = sum(timed) / len(timed)
    std = (sum((v - mean) ** 2 for v in timed) / len(timed)) ** 0.5
    flop = 3 * forward_flop[0]
    moved = max(float((trainer._params[n] - start[n]).abs().max())
                for n in running)
    finite = all(bool(torch.isfinite(trainer._params[n]).all())
                 for n in running)
    result = dict(step_ms=timed, step_ms_mean=mean, step_ms_std=std,
                  step_ms_min=min(timed), step_ms_max=max(timed),
                  img_per_s=RESNET_TRAIN_BATCH / mean * 1e3,
                  flop_per_step=flop, mfu=flop / (mean / 1e3) /
                  H100_BF16_FLOPS, floor_ms=flop / H100_BF16_FLOPS * 1e3,
                  peak_memory_bytes=peak, losses=losses,
                  running_stats_max_move=moved)
    for i, (ms, loss) in enumerate(zip(step_ms, losses)):
        print("resnet 6c: step %d%s: %.3f ms, loss %.6f | %s"
              % (i, " (warm-up)" if i < RESNET_TRAIN_WARMUP else "", ms, loss,
                 card))
    print("resnet 6c: resnet50_v1(classes=1000), DataParallelTrainer(sgd %s, "
          "dtype=bfloat16), batch %d x 3x%dx%d: %d timed steps, mean %.3f "
          "ms (std %.3f, %.3f-%.3f), %.1f img/s, MFU %.4f (%.4e conv and "
          "dense flop a step, 3x the forward's, over 989 TFLOP/s; floor "
          "%.3f ms), peak memory allocated %d bytes; running statistics "
          "moved by up to %.3e, finite %s | %s"
          % (RESNET_TRAIN_OPT, RESNET_TRAIN_BATCH, RESNET_IMAGE, RESNET_IMAGE,
             RESNET_TRAIN_STEPS, mean,
             std, min(timed), max(timed), result["img_per_s"], result["mfu"],
             flop, result["floor_ms"], peak, moved, finite, card),
          flush=True)
    check(all(math.isfinite(v) for v in losses), "6c: a loss is not finite: "
          "%s" % losses)
    check(losses[-1] < losses[0], "6c: the loss did not fall: %s" % losses)
    check(finite and moved > 0, "6c: running statistics moved %.3e, finite "
          "%s" % (moved, finite))
    result["profile"] = resnet_profile(
        lambda: trainer.step(x, y).asscalar(), "6c one training step", card)
    del trainer, net, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 7: the array surface (the ops of ops/math.py, ops/tensor.py and
# ops/init_ops.py ported in this slice) on the card against the port's CPU
# result, and checkpoints: ResNet-50 v1 trained, saved, resumed and served
# from its file.  No hand kernel on this path.
# ---------------------------------------------------------------------------
SWEEP_ROWS, SWEEP_COLS = 1024, 4096          # elementwise, broadcast, reduce
SWEEP_DOT = ((1024, 4096), (4096, 4096))
SWEEP_BATCH_DOT = ((32, 1024, 128), (32, 128, 1024))
# the families of the sweep, and every alias of each op (checked to resolve
# to the same Operator as its canonical name)
SWEEP_ALIASES = {
    "broadcast_mod": ("_mod",), "broadcast_power": ("_power", "_pow"),
    "broadcast_maximum": ("_maximum",), "broadcast_minimum": ("_minimum",),
    "broadcast_hypot": ("_hypot",),
    "broadcast_logical_and": ("_logical_and",),
    "broadcast_logical_or": ("_logical_or",),
    "broadcast_logical_xor": ("_logical_xor",),
    "add_n": ("ElementWiseSum", "elemwise_sum", "_sum"),
    "abs": ("_np_abs",), "negative": ("_np_negative",),
    "max": ("max_axis",), "min": ("min_axis",), "sum": ("sum_axis",),
    "broadcast_axis": ("broadcast_axes",), "swapaxes": ("SwapAxis",),
    "slice": ("crop",), "Concat": ("concat",), "SliceChannel": ("split",),
    "reverse": ("flip",), "Pad": ("pad",), "_copy": ("identity",),
    "BlockGrad": ("stop_gradient",), "make_loss": ("MakeLoss",),
    "_arange": ("arange",), "_eye": ("eye",), "_linspace": ("linspace",),
}
TRANSCENDENTAL = ("sqrt", "rsqrt", "cbrt", "rcbrt", "exp", "log", "log10",
                  "log2", "log1p", "expm1", "sin", "cos", "tan", "arcsin",
                  "arccos", "arctan", "sinh", "cosh", "tanh", "arcsinh",
                  "arccosh", "arctanh", "sigmoid", "erf", "gamma", "gammaln")
EXACT_UNARY = ("abs", "negative", "square", "degrees", "radians",
               "reciprocal", "relu", "softsign", "sign", "rint", "round",
               "ceil", "floor", "trunc", "fix", "logical_not")
DOMAIN = {"sqrt": "pos", "rsqrt": "pos", "log": "pos", "log10": "pos",
          "log2": "pos", "log1p": "pos", "gamma": "pos", "gammaln": "pos",
          "arcsin": "unit", "arccos": "unit", "arctanh": "unit",
          "tan": "unit", "arccosh": "gt1"}
# bounds, card against CPU (n ulps of the output's dtype, at each element
# or at the largest |CPU value| for values that cancel; 0: bit-equal).
# libdevice's and the CPU's transcendentals are each within 1-2 ulps of
# the exact value; a sum runs in another order (cuBLAS, CUDA's reduction
# trees); a 16-bit result is rounded once from f32 on both.  The inputs
# are seeded and both sides' libraries deterministic, so a case gives the
# same error on every run.  Each bound against the largest error of its key
# measured on an NVIDIA H100 80GB HBM3 at these inputs: f32 transcendental
# forwards 4 (rsqrt's: no room), their gradients 6 (sigmoid's 4),
# broadcast gradients 4 (2), pow and hypot 4 and 6 (3.5), sums 4 (3),
# products
# of 4096 factors 160 (nanprod's 108), products 48 (dot 35.5, batch_dot
# 17), gathers' sums 2 (1.5); 16-bit forwards 1 (1: no room), 16-bit
# gradients 2 (1).
SWEEP_ULP = {
    # key: ((f32 forward, f32 backward), (16-bit forward, 16-bit backward))
    "transcendental": (((4, "elem"), (6, "max")),
                       ((1, "elem"), (2, "max"))),
    # a broadcast operand's gradient is a sum over the broadcast rows
    "broadcast": (((0, "elem"), (4, "max")), ((0, "elem"), (2, "max"))),
    "broadcast_tx": (((4, "elem"), (6, "max")),
                     ((1, "elem"), (2, "max"))),
    "reduce": (((4, "max"), (4, "max")), ((1, "max"), (2, "max"))),
    "prod": (((160, "elem"), (160, "max")), ((1, "elem"), (2, "max"))),
    "product": (((48, "max"), (48, "max")), ((1, "max"), (2, "max"))),
    "scatter": (((0, "elem"), (2, "max")), ((0, "elem"), (2, "max"))),
}


def sweep_input(rng, kind, shape):
    """Seeded host inputs by domain (a ``np.random.Generator``), off exact
    zeros; only the draw the domain needs."""
    import numpy as np
    f32 = np.float32
    if kind in ("small", "int", "exp"):
        lo, hi = {"small": (0, 3), "int": (-9, 10), "exp": (0, 4)}[kind]
        return rng.integers(lo, hi, shape).astype(f32)
    if kind == "any":
        x = rng.standard_normal(shape, dtype=f32) * f32(2)
    else:
        lo, span = {"pos": (0.5, 2.5), "unit": (-0.9, 1.8),
                    "gt1": (1.1, 2.0), "near1": (0.7, 0.6)}[kind]
        x = f32(lo) + f32(span) * rng.random(shape, dtype=f32)
    x = np.asarray(x, f32)
    x[np.abs(x) < 1e-2] = f32(0.37)
    return x


def sweep_cases():
    """(family, op, params, input domains and shapes, dtypes, bound key or
    0, inputs with a gradient).  Shapes: (1024, 4096) for
    elementwise, broadcast and reduction ops, the products at their own."""
    R, C = SWEEP_ROWS, SWEEP_COLS
    full = ("any", (R, C))
    cases = []
    for name in TRANSCENDENTAL + EXACT_UNARY:
        diff = name not in ("sign", "rint", "round", "ceil", "floor",
                            "trunc", "fix", "logical_not")
        dts = ("float32", "bfloat16") + (
            ("int32",) if name in ("abs", "negative", "square", "relu",
                                   "sign", "round", "floor", "exp") else ())
        bound = "transcendental" if name in TRANSCENDENTAL else 0
        cases.append(("unary", name, {}, [(DOMAIN.get(name, "any"), (R, C))],
                      dts, bound, (0,) if diff else ()))
    cases += [
        ("unary", "clip", {"a_min": -0.7, "a_max": 1.1}, [full],
         ("float32", "bfloat16", "int32"), 0, (0,)),
        ("unary", "hard_sigmoid", {}, [full], ("float32", "bfloat16"), 0,
         (0,)),
        ("unary", "smooth_l1", {"scalar": 2.0}, [full],
         ("float32", "bfloat16"), 0, (0,)),
    ]
    for name, kinds, dts in (
            ("broadcast_mod", ("any", "pos"), ("float32", "bfloat16",
                                               "int32")),
            ("broadcast_power", ("pos", "any"), ("float32", "bfloat16")),
            ("broadcast_maximum", ("any", "any"), ("float32", "bfloat16",
                                                   "int32")),
            ("broadcast_minimum", ("any", "any"), ("float32", "int32")),
            ("broadcast_hypot", ("any", "any"), ("float32", "bfloat16")),
            ("broadcast_logical_and", ("small", "small"),
             ("float32", "int32")),
            ("broadcast_logical_or", ("small", "small"), ("float32",)),
            ("broadcast_logical_xor", ("small", "small"), ("float32",))):
        bound = "broadcast_tx" if name in ("broadcast_power",
                                           "broadcast_hypot") else \
            "broadcast"
        grads = (0, 1) if "logical" not in name else ()
        cases.append(("binary", name, {}, [(kinds[0], (R, C)),
                                           (kinds[1], (1, C))], dts, bound,
                      grads))
    cases.append(("binary", "add_n", {}, [full, full, full],
                  ("float32", "bfloat16", "int32"), 0, (0, 1, 2)))
    for name, s, kind, dts, bound in (
            ("_mod_scalar", 1.7, "any", ("float32", "int32"), 0),
            ("_rmod_scalar", 2.5, "pos", ("float32",), 0),
            ("_power_scalar", 2.5, "pos", ("float32", "bfloat16"),
             "transcendental"),
            ("_power_scalar", 3, "int", ("int32",), 0),
            ("_rpower_scalar", 1.5, "any", ("float32",), "transcendental"),
            ("_maximum_scalar", 0.3, "any", ("float32", "int32"), 0),
            ("_minimum_scalar", -0.3, "any", ("float32", "bfloat16"), 0),
            ("_hypot_scalar", 1.3, "any", ("float32",), "transcendental")):
        cases.append(("scalar", name, {"scalar": s}, [(kind, (R, C))], dts,
                      bound, (0,)))
    cases += [
        ("reduction", "prod", {"axis": 1}, [("near1", (R, C))],
         ("float32", "bfloat16"), "prod", (0,)),
        ("reduction", "nansum", {"axis": 0}, [full], ("float32", "int32"),
         "reduce", (0,)),
        ("reduction", "nanprod", {"axis": 1}, [("near1", (R, C))],
         ("float32",), "prod", (0,)),
        ("reduction", "max", {"axis": 1}, [full],
         ("float32", "bfloat16", "int32"), 0, (0,)),
        ("reduction", "min", {}, [full], ("float32",), 0, (0,)),
        ("reduction", "norm", {"axis": 1}, [full], ("float32", "bfloat16"),
         "reduce", (0,)),
        ("reduction", "square_sum", {"axis": 0}, [full], ("float32",),
         "reduce", (0,)),
        ("reduction", "L2Normalization", {}, [("any", (R // 4, 4, C))],
         ("float32",), "reduce", (0,)),
        ("product", "dot", {}, [("any", SWEEP_DOT[0]), ("any", SWEEP_DOT[1])],
         ("float32", "bfloat16"), "product", (0, 1)),
        ("product", "dot", {"transpose_b": True},
         [("int", (64, 256)), ("int", (128, 256))], ("int32",), 0, ()),
        ("product", "batch_dot", {}, [("any", SWEEP_BATCH_DOT[0]),
                                      ("any", SWEEP_BATCH_DOT[1])],
         ("float32", "bfloat16"), "product", (0, 1)),
        ("product", "batch_dot", {}, [("int", (4, 32, 64)),
                                      ("int", (4, 64, 16))], ("int32",), 0,
         ()),
        ("product", "khatri_rao", {}, [("any", (64, C)), ("any", (16, C))],
         ("float32",), "product", (0, 1)),
        ("index", "argmin", {"axis": 1}, [full], ("float32", "int32"), 0,
         ()),
        ("index", "argmax_channel", {}, [full], ("float32",), 0, ()),
        ("index", "take", {"axis": 0, "mode": "clip"},
         [full, ("idx", (64, 32))], ("float32", "bfloat16", "int32"),
         "scatter", (0,)),
        ("index", "take", {"axis": 1, "mode": "wrap"},
         [full, ("idx", (2048,))], ("float32",), "scatter", (0,)),
        ("index", "one_hot", {"depth": 1000}, [("idx", (4096,))],
         ("float32",), 0, ()),
        ("index", "gather_nd", {}, [full, ("idx2", (2, 8192))],
         ("float32", "int32"), "scatter", (0,)),
        ("index", "scatter_nd", {"shape": (R, C)},
         [("any", (8192,)), ("idx2", (2, 8192))], ("float32",), "scatter",
         (0,)),
        ("index", "where", {}, [("small", (R, C)), full, full],
         ("float32", "int32"), 0, (1, 2)),
        ("shape", "squeeze", {"axis": 1}, [("any", (R, 1, C))],
         ("float32", "int32"), 0, (0,)),
        ("shape", "swapaxes", {"dim1": 0, "dim2": 1}, [full],
         ("float32", "bfloat16"), 0, (0,)),
        ("shape", "slice", {"begin": (1, None), "end": (None, -3),
                            "step": (2, -3)}, [full], ("float32", "int32"),
         0, (0,)),
        ("shape", "slice_like", {}, [full, ("any", (R // 2, C // 4))],
         ("float32",), 0, (0,)),
        ("shape", "Concat", {"dim": 0}, [full, full], ("float32", "int32"),
         0, (0, 1)),
        ("shape", "stack", {"axis": 1}, [full, full], ("float32",), 0,
         (0, 1)),
        ("shape", "SliceChannel", {"num_outputs": 4, "axis": 1}, [full],
         ("float32", "int32"), 0, (0,)),
        ("shape", "repeat", {"repeats": 2, "axis": 0}, [full],
         ("float32",), 0, (0,)),
        ("shape", "tile", {"reps": (2, 1)}, [full], ("float32",), 0, (0,)),
        ("shape", "reverse", {"axis": (0, 1)}, [full], ("float32", "int32"),
         0, (0,)),
        ("shape", "Pad", {"mode": "reflect",
                          "pad_width": (0, 0, 0, 0, 3, 2, 1, 4)},
         [("any", (16, 64, 32, 32))], ("float32",), "scatter", (0,)),
        ("shape", "Pad", {"mode": "edge",
                          "pad_width": (0, 0, 0, 0, 2, 2, 2, 2)},
         [("any", (16, 64, 32, 32))], ("bfloat16",), 0, ()),
        ("shape", "Pad", {"mode": "constant", "constant_value": 1.5,
                          "pad_width": (0, 0, 1, 1, 2, 2, 0, 3)},
         [("any", (16, 64, 32, 32))], ("float32", "int32"), 0, (0,)),
        ("shape", "space_to_depth", {"block_size": 2},
         [("any", (16, 64, 32, 32))], ("float32",), 0, (0,)),
        ("shape", "depth_to_space", {"block_size": 2},
         [("any", (16, 64, 32, 32))], ("float32",), 0, (0,)),
        ("shape", "broadcast_to", {"shape": (R, C)}, [("any", (1, C))],
         ("float32", "int32"), "reduce", (0,)),
        ("shape", "broadcast_axis", {"axis": 1, "size": C},
         [("any", (R, 1))], ("float32",), "reduce", (0,)),
        ("shape", "_copy", {}, [full], ("float32", "int32"), 0, (0,)),
        ("shape", "BlockGrad", {}, [full], ("float32",), 0, ()),
        ("shape", "make_loss", {"grad_scale": 0.25}, [full], ("float32",),
         0, (0,)),
        ("shape", "_grad_add", {}, [full, full], ("float32",), 0, (0, 1)),
        ("ordering", "topk", {"k": 8}, [("perm", (R, C))],
         ("float32", "bfloat16", "int32"), 0, ()),
        ("ordering", "topk", {"k": 5, "ret_typ": "both", "is_ascend": True},
         [("small", (R, C))], ("float32", "int32"), 0, ()),
        ("ordering", "topk", {"k": 3, "ret_typ": "mask", "axis": 0},
         [("perm", (R, C))], ("float32",), 0, ()),
        ("ordering", "sort", {}, [("perm", (R, C))], ("float32", "int32"),
         0, ()),
        ("ordering", "sort", {"is_ascend": False}, [("small", (R, C))],
         ("bfloat16",), 0, ()),
        ("ordering", "argsort", {}, [("perm", (R, C))], ("float32",), 0,
         ()),
        ("ordering", "argsort", {"is_ascend": False}, [("small", (R, C))],
         ("float32", "int32"), 0, ()),
        ("sequence", "SequenceLast", {"use_sequence_length": True},
         [full, ("len", (C,))], ("float32",), 0, (0,)),
        ("sequence", "SequenceMask", {"use_sequence_length": True,
                                      "value": -1.0},
         [full, ("len", (C,))], ("float32", "int32"), 0, (0,)),
        ("sequence", "SequenceReverse", {"use_sequence_length": True},
         [full, ("len", (C,))], ("float32",), 0, (0,)),
    ]
    return cases


def _sweep_arrays(rs, specs, dtype):
    """The host inputs of one case: values by domain in ``dtype`` (int32
    values for an int32 case), index arrays as int32, permutations for the
    orderings (bf16 rounds some to ties, which the stable sorts order
    alike on both sides), sequence lengths in [0, rows]."""
    import numpy as np
    out = []
    for kind, shape in specs:
        if kind == "perm":      # distinct but where bf16 rounds them
            a = rs.permutation(int(np.prod(shape))).reshape(shape)
            a = (a.astype(np.float64) - a.size / 2).astype(np.float32)
        elif kind == "idx":
            a = rs.integers(-8, SWEEP_ROWS + 8, shape).astype(np.int32)
        elif kind == "idx2":
            a = np.stack([rs.integers(0, SWEEP_ROWS, shape[1:]),
                          rs.integers(0, SWEEP_COLS, shape[1:])]).astype(
                np.int32)
        elif kind == "len":
            a = rs.integers(0, SWEEP_ROWS + 1, shape).astype(np.int32)
        else:
            a = sweep_input(rs, kind, shape)
            if dtype == "int32":
                a = np.round(a).astype(np.int32)
        out.append(a)
    return out


def _ulp_err(got, want, measure):
    """max |got - want| in ulps of ``want``'s dtype, at each element's
    |want| (``elem``) or at max |want| (``max``), computed in float64 on
    ``got``'s device; inf when NaN or inf do not match."""
    import torch
    mant = {torch.float32: 23, torch.bfloat16: 7, torch.float16: 10}[
        want.dtype]
    g = got.detach().to(torch.float64)
    w = want.detach().to(device=g.device, dtype=torch.float64)
    if g.shape != w.shape or not torch.equal(torch.isnan(g), torch.isnan(w)):
        return math.inf
    fin = torch.isfinite(w)
    odd = ~fin & ~torch.isnan(w)
    if not torch.equal(g[odd], w[odd]):
        return math.inf
    err = torch.where(fin, (g - w).abs(), torch.zeros_like(w))
    ref = w.abs() if measure == "elem" else w.abs().max()
    e = torch.floor(torch.log2(torch.clamp(ref, min=2.0 ** -126)))
    return float((err / torch.exp2(e - mant)).max()) if err.numel() \
        else 0.0


def _sweep_run(mx, op, arrays, params, dtype, ctx, heads_host, grads):
    """One case through the port on ``ctx``: the outputs and the gradients
    (as tensors) for seeded head gradients.  Inputs and heads are placed
    on ``ctx`` outside the op's call and its backward, which on the card
    run under torch's sync-debug mode "error": an op that waited for the
    card would raise.  ``heads_host`` caches the head gradients' host
    values by shape, so both runs of a case use the same."""
    import numpy as np
    import torch
    xs = [mx.nd.array(a, ctx=ctx, dtype=dtype if a.dtype.kind == "f"
                      else "int32") for a in arrays]
    with card_calls(ctx, torch):
        for i in grads:
            xs[i].attach_grad()
        with mx.autograd.record():
            out = mx.nd.invoke(op, xs, dict(params))
    outs = out if isinstance(out, list) else [out]
    if grads:
        rng = np.random.default_rng(SEED)
        heads = [mx.nd.NDArray(torch.from_numpy(heads_host.setdefault(
            o.shape, np.array(sweep_input(rng, "any", o.shape)))).to(
                o._data.device, o._data.dtype)) for o in outs]
        with card_calls(ctx, torch):
            mx.autograd.backward(outs, heads)
    return ([o._data for o in outs],
            [xs[i].grad._data for i in grads])


@contextlib.contextmanager
def sync_debug_error(torch):
    """torch's sync-debug mode "error" inside: a call that synchronizes
    with the card (an ``.item()``, a host copy) raises."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def card_calls(ctx, torch):
    """Around calls on ``ctx``: on the card, sync-debug mode "error" after
    a synchronize (so only the calls inside can trip it); on the CPU,
    nothing."""
    if ctx.device_type != "gpu":
        return contextlib.nullcontext()
    torch.cuda.synchronize()
    return sync_debug_error(torch)


def sweep_case(mx, case, dtype, rs):
    """One case of the sweep in ``dtype``: the op on the card against the
    CPU, forward and backward, each at its bound (failing the run past
    it).  Returns the largest error in ulps and the case's bound."""
    import torch
    from incubator_mxnet_tpu_torch.ops.registry import get_op
    family, name, params, specs, _, bound, grads = case
    op = get_op(name)
    arrays = _sweep_arrays(rs, specs, dtype)
    g = () if dtype == "int32" else grads
    heads = {}
    want = _sweep_run(mx, op, arrays, params, dtype, mx.cpu(), heads, g)
    got = _sweep_run(mx, op, arrays, params, dtype, mx.gpu(0), heads, g)
    fb, bb = SWEEP_ULP[bound][dtype != "float32"] if bound else (
        (0, "elem"), (0, "elem"))
    worst = 0.0
    for part, (gl, wl, (n, measure)) in enumerate(
            ((got[0], want[0], fb), (got[1], want[1], bb))):
        for gt, wt in zip(gl, wl):
            check(gt.dtype == wt.dtype and gt.shape == wt.shape,
                  "7a: %s %s %s: %s %s on the card, %s %s on the CPU"
                  % (name, params, dtype, gt.dtype, gt.shape, wt.dtype,
                     wt.shape))
            if n == 0 or not wt.is_floating_point():
                same = torch.equal(gt, wt.to(gt.device)) or (
                    wt.is_floating_point() and bool(torch.equal(
                        torch.isnan(gt), torch.isnan(wt.to(gt.device)))
                        and torch.equal(torch.nan_to_num(gt),
                                        torch.nan_to_num(wt.to(gt.device)))))
                err = 0.0 if same else math.inf
            else:
                err = _ulp_err(gt, wt, measure)
            check(err <= n, "7a: %s %s %s: %s %.3g ulp above %d"
                  % (name, params, dtype, "gradient" if part else "forward",
                     err, n))
            worst = max(worst, err)
    return worst, max(fb[0], bb[0] if g else 0)


def array_sweep(mx, card):
    """Phase 7a: every op this slice ports, on CUDA tensors against the
    port's CPU result for the same numpy inputs, forward and backward, each
    case at its stated bound; the aliases resolve to one Operator; integer
    mod and power at their edge values; the creation ops.  One line per
    family: cases, ops, the largest error and its bound."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch.ops.registry import get_op
    t0 = time.perf_counter()
    for name, aliases in SWEEP_ALIASES.items():
        for a in aliases:
            check(get_op(a) is get_op(name), "7a: alias %s is not %s's "
                  "Operator" % (a, name))
    gpu, cpu = mx.gpu(0), mx.cpu()
    families = {}
    rs = np.random.default_rng(SEED)
    for case in sweep_cases():
        family, name = case[0], case[1]
        for dtype in case[4]:
            worst, bound = sweep_case(mx, case, dtype, rs)
            fam = families.setdefault(family, dict(cases=0, ops=set(),
                                                   max_ulp=0.0, bound=0,
                                                   worst_case=None))
            fam["cases"] += 1
            fam["ops"].add(name)
            if worst > fam["max_ulp"]:
                fam["max_ulp"], fam["worst_case"] = worst, "%s %s" % (
                    name, dtype)
            fam["bound"] = max(fam["bound"], bound)
    families["integer edges"] = integer_edges(mx, gpu, cpu, np, torch)
    families["creation"] = creation_sweep(mx, gpu, cpu, np)
    for family, fam in families.items():
        print("sweep %s: %d cases of %d ops (%s), max error %.3g ulp (%s), "
              "bound %d ulp | %s" % (family, fam["cases"], len(fam["ops"]),
                                     " ".join(sorted(fam["ops"])),
                                     fam["max_ulp"], fam.get("worst_case"),
                                     fam["bound"], card), flush=True)
    seconds = time.perf_counter() - t0
    print("sweep: %d cases in %.1f s" % (sum(f["cases"] for f in
                                              families.values()), seconds),
          flush=True)
    return {f: dict(v, ops=sorted(v["ops"])) for f, v in families.items()}


def integer_edges(mx, gpu, cpu, np, torch):
    """int32 mod by 0 and -1 (INT_MIN too) and powers with negative and
    large exponents: on the card, under sync-debug mode "error", equal to
    the CPU (the JAX build's values, tests/test_torch_ops_math.py)."""
    lhs = np.array([5, -5, 7, 0, -2 ** 31, 3, -7, 2 ** 31 - 1] * 512,
                   np.int32)
    cases = [("broadcast_mod", np.array([0, 0, -1, 0, -1, 0, 2, -3] * 512,
                                        np.int32)),
             ("broadcast_power", np.array([-1, -1, -1, -1, -2, 70, 31, -64]
                                          * 512, np.int32))]
    from incubator_mxnet_tpu_torch.ops.registry import get_op
    for name, rhs in cases:
        want = _sweep_run(mx, get_op(name), [lhs, rhs], {}, "int32", cpu,
                          {}, ())[0][0]
        got = _sweep_run(mx, get_op(name), [lhs, rhs], {}, "int32", gpu,
                         {}, ())[0][0]
        check(torch.equal(got.cpu(), want), "7a: int32 %s edge values "
              "differ on the card" % name)
    return dict(cases=2, ops={"broadcast_mod", "broadcast_power"},
                max_ulp=0.0, bound=0)


def creation_sweep(mx, gpu, cpu, np):
    """The creation ops on the card against the CPU, bit-equal (outside
    sync-debug mode: arange copies numpy's values to the card)."""
    cases = [("arange", dict(start=0.5, stop=4000.0, step=0.3, repeat=2)),
             ("arange", dict(start=-3, stop=10 ** 6, step=7,
                             dtype="int32")),
             ("eye", dict(N=SWEEP_ROWS, M=SWEEP_COLS, k=5)),
             ("linspace", dict(start=-2.5, stop=3.1, num=SWEEP_COLS)),
             ("linspace", dict(start=0.0, stop=1.0, num=777,
                               endpoint=False, dtype="bfloat16"))]
    for name, params in cases:
        a = getattr(mx.nd, name)(ctx=gpu, **params)
        b = getattr(mx.nd, name)(ctx=cpu, **params)
        check(a.context == gpu and np.array_equal(a.asnumpy(), b.asnumpy()),
              "7a: %s %s differs on the card" % (name, params))
    x = mx.nd.array(np.zeros((SWEEP_ROWS, SWEEP_COLS), np.float32), ctx=gpu)
    for name in ("ones_like", "shape_array", "size_array"):
        a, b = getattr(mx.nd, name)(x), getattr(mx.nd, name)(x.copyto(cpu))
        check(np.array_equal(a.asnumpy(), b.asnumpy()), "7a: %s differs on "
              "the card" % name)
    return dict(cases=len(cases) + 3,
                ops={"_arange", "_eye", "_linspace", "ones_like",
                     "shape_array", "size_array"}, max_ulp=0.0, bound=0)


# 7b: ResNet-50 v1 through the plain Gluon loop at
# example/image-classification/train_imagenet.py's optimizer (sgd, lr 0.1,
# momentum 0.9, wd 1e-4, MultiFactorScheduler), the schedule's steps cut to
# [2, 4] so the rate falls before and after the checkpoint at step 3
CKPT_BATCH, CKPT_SERVE_BATCH = 64, 32
CKPT_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
CKPT_SCHEDULE = dict(step=[2, 4], factor=0.1)
CKPT_SAVE_AT, CKPT_STEPS = 3, 6
# steps 5-6 of the resumed run against the uninterrupted one: cuDNN's
# backward (wgrad) and the loss's scatter may add in another order, ~1e-7
# relative a step, which the next step's forward carries on (this net's
# gradients move by percents for a one-ulp change of its input).  The
# weights are compared by their relative L2 distance over the whole net,
# and each tensor by its own where its RMS is at least CKPT_LIVE_RMS of the
# net's (a convolution's bias before BatchNorm starts at 0 and takes only
# rounding for a gradient, so it has no scale of its own).  Measured on an
# NVIDIA H100 80GB HBM3: losses 9.2e-7 to 5.3e-6 apart over six runs,
# weights 6.6e-6 to 7.3e-6, each checked tensor 1.14e-4 to 1.20e-4 (a
# BatchNorm beta) over three; the bounds leave ~10x.  The 32 convolution
# biases sit below 1.1e-6 of the net's RMS, every other tensor above 5e-3
CKPT_LOSS_REL, CKPT_WEIGHT_REL = 5e-5, 1e-4
CKPT_LIVE_RMS, CKPT_TENSOR_REL = 1e-3, 1e-3


def _ckpt_state(net, trainer):
    """Every parameter (running statistics too) and momentum, on the host,
    and the update count."""
    params = {n[len(net.prefix):]: p.data().asnumpy()
              for n, p in net.collect_params().items()}
    moms = {i: (s.asnumpy() if hasattr(s, "asnumpy") else s)
            for i, s in trainer._updaters[0].states.items()}
    return params, moms, trainer._optimizer.num_update


def checkpoint_cycle(mx, card):
    """Phase 7b: ResNet-50 v1 (classes=1000, f32, on the card) trained by
    autograd.record / SoftmaxCrossEntropyLoss / backward /
    gluon.Trainer.step(64) under a MultiFactorScheduler: run A takes 3
    steps, saves (save_params, save_states), takes steps 4-6; run B, a net
    of another seed with a fresh Trainer, loads both and takes steps 4-6;
    then a third net serves A's file from its bytes (nd.load_buffer,
    serving.loader.load_params_bytes)."""
    import tempfile
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch.serving.loader import load_params_bytes
    gpu = mx.gpu(0)
    rs = np.random.RandomState(0)
    x = mx.nd.array(rs.rand(CKPT_BATCH, 3, RESNET_IMAGE, RESNET_IMAGE)
                    .astype(np.float32), ctx=gpu)
    y = mx.nd.array(rs.randint(0, 1000, CKPT_BATCH).astype(np.float32),
                    ctx=gpu)
    serve_x = mx.nd.array(rs.rand(CKPT_SERVE_BATCH, 3, RESNET_IMAGE,
                                  RESNET_IMAGE).astype(np.float32), ctx=gpu)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def trainer_of(net):
        sched = mx.lr_scheduler.MultiFactorScheduler(**CKPT_SCHEDULE)
        return mx.gluon.Trainer(net.collect_params(), "sgd",
                                dict(CKPT_OPT, lr_scheduler=sched))

    def step(net, trainer):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(CKPT_BATCH)
        out = loss.asnumpy()
        return out, (time.perf_counter() - t1) * 1e3, \
            trainer._optimizer._get_lr(0)

    def logits(net):
        with mx.autograd.predict_mode():
            return net(serve_x).asnumpy()

    def timed(fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t1

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        p, s = os.path.join(tmp, "resnet50.params"), \
            os.path.join(tmp, "resnet50.states")
        net = _resnet_full(mx, np, SEED)
        trainer = trainer_of(net)
        run_a = [step(net, trainer) for _ in range(CKPT_SAVE_AT)]
        sec = dict(save_params=timed(lambda: net.save_params(p)),
                   save_states=timed(lambda: trainer.save_states(s)))
        saved = _ckpt_state(net, trainer)
        served_a = logits(net)
        run_a += [step(net, trainer) for _ in range(CKPT_SAVE_AT,
                                                    CKPT_STEPS)]
        end_a = _ckpt_state(net, trainer)
        del net, trainer
        gc.collect()
        net = _resnet_full(mx, np, SEED + 1)
        trainer = trainer_of(net)
        sec["load_params"] = timed(lambda: net.load_params(p, ctx=gpu))
        sec["load_states"] = timed(lambda: trainer.load_states(s))
        loaded = _ckpt_state(net, trainer)
        run_b = [step(net, trainer) for _ in range(CKPT_SAVE_AT,
                                                   CKPT_STEPS)]
        end_b = _ckpt_state(net, trainer)
        del net, trainer
        gc.collect()
        buf = open(p, "rb").read()
        sec["load_buffer"] = timed(lambda: mx.nd.load_buffer(buf))
        args, aux = load_params_bytes(buf)
        served = _resnet_full(mx, np, SEED + 2)
        served.collect_params().setattr("grad_req", "null")
        for name, prm in served.collect_params().items():
            short = name[len(served.prefix):]
            prm.set_data(args[short] if short in args else aux[short])
        served_c = logits(served)
        sizes = dict(params_bytes=os.path.getsize(p),
                     states_bytes=os.path.getsize(s))
        del served, args, aux
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    same = all(np.array_equal(saved[0][k], loaded[0][k]) for k in saved[0])
    same_mom = sorted(saved[1]) == sorted(loaded[1]) and all(
        np.array_equal(saved[1][i], loaded[1][i]) for i in saved[1])
    loss_a = [float(l_.mean()) for l_, _, _ in run_a]
    loss_b = [float(l_.mean()) for l_, _, _ in run_b]
    lrs_a = [lr for _, _, lr in run_a[CKPT_SAVE_AT:]]
    lrs_b = [lr for _, _, lr in run_b]
    step4 = bool(np.array_equal(run_a[CKPT_SAVE_AT][0], run_b[0][0]))
    loss_rel = max(abs(a - b) / abs(a) for a, b in
                   zip(loss_a[CKPT_SAVE_AT:], loss_b))
    diff2 = {k: float(np.square(end_a[0][k].astype(np.float64)
                                - end_b[0][k]).sum()) for k in end_a[0]}
    norm2 = {k: float(np.square(end_a[0][k].astype(np.float64)).sum())
             for k in end_a[0]}
    weight_rel = math.sqrt(sum(diff2.values()) / sum(norm2.values()))
    net_ms = sum(norm2.values()) / sum(v.size for v in end_a[0].values())
    rms = {k: math.sqrt(norm2[k] / end_a[0][k].size / net_ms)
           for k in end_a[0]}
    live = [k for k in end_a[0] if rms[k] >= CKPT_LIVE_RMS]
    gap = (max([rms[k] for k in rms if k not in live], default=0.0),
           min(rms[k] for k in live))
    worst = max(live, key=lambda k: diff2[k] / norm2[k])
    worst_rel = math.sqrt(diff2[worst] / norm2[worst])
    served_equal = bool(np.array_equal(served_a, served_c))
    result = dict(step_ms=[ms for _, ms, _ in run_a], losses_a=loss_a,
                  losses_b=loss_b, lrs_a=lrs_a, lrs_b=lrs_b,
                  step4_loss_bit_equal=step4, loss_rel_steps_5_6=loss_rel,
                  weight_rel_l2_after_6=weight_rel,
                  worst_tensor=(worst, worst_rel),
                  tensors_checked=(len(live), len(end_a[0])),
                  rms_gap=gap,
                  state_bit_equal=same,
                  momentum_bit_equal=same_mom,
                  num_update=(saved[2], loaded[2]),
                  served_logits_bit_equal=served_equal, seconds=sec, **sizes)
    for i, (l_, ms, lr) in enumerate(run_a):
        print("ckpt 7b: run A step %d: %.3f ms, loss %.6f, lr %g | %s"
              % (i + 1, ms, float(l_.mean()), lr, card), flush=True)
    print("ckpt 7b: files %d bytes (.params) and %d bytes (.states); "
          "seconds: %s | %s" % (sizes["params_bytes"], sizes["states_bytes"],
                                json.dumps({k: round(v, 4) for k, v in
                                            sec.items()}), card), flush=True)
    print("ckpt 7b: resumed run B: losses %s (A %s), lr %s (A %s), step-4 "
          "loss bit-equal %s, steps 5-6 loss rel %.3e (bound %g), weights "
          "after step 6 rel L2 %.3e (bound %g), each of %d of %d tensors "
          "(RMS at least %g of the net's; the others below %.3g, these "
          "above %.3g) within %.3e (%s; bound %g); state "
          "bit-equal after load %s, momentum %s, num_update %s; served "
          "logits from the file's bytes bit-equal %s"
          % (loss_b, loss_a[CKPT_SAVE_AT:], lrs_b, lrs_a, step4, loss_rel,
             CKPT_LOSS_REL, weight_rel, CKPT_WEIGHT_REL, len(live),
             len(end_a[0]), CKPT_LIVE_RMS, gap[0], gap[1], worst_rel, worst,
             CKPT_TENSOR_REL, same, same_mom, result["num_update"],
             served_equal),
          flush=True)
    check(all(math.isfinite(v) for v in loss_a + loss_b),
          "7b: a loss is not finite")
    check(same and same_mom, "7b: the state after load differs from A's at "
          "the save (parameters %s, momentum %s)" % (same, same_mom))
    check(saved[2] == loaded[2] and lrs_a == lrs_b, "7b: num_update %s or "
          "the resumed learning rates %s differ from A's %s"
          % (result["num_update"], lrs_b, lrs_a))
    check(lrs_a == [CKPT_OPT["learning_rate"] * 0.1 ** k for k in
                    (1, 2, 2)], "7b: the schedule gave %s" % lrs_a)
    check(step4, "7b: B's step-4 loss is not bit-equal to A's")
    check(loss_rel <= CKPT_LOSS_REL and weight_rel <= CKPT_WEIGHT_REL,
          "7b: steps 5-6 drifted: loss %.3e, weights %.3e" % (loss_rel,
                                                              weight_rel))
    check(worst_rel <= CKPT_TENSOR_REL, "7b: tensor %s drifted %.3e after "
          "step 6" % (worst, worst_rel))
    check(served_equal, "7b: logits served from the file's bytes differ")
    return result


# ---------------------------------------------------------------------------
# phase 8: the rest of the op library (the nn ops, random ops, update ops
# and optimizers, losses, initializers and linalg of this slice) and the
# rest of the vision zoo, served and trained.  No hand kernel on this
# path: the ops are PyTorch calls, as the JAX build's are jnp/lax outside
# any Pallas kernel.
# ---------------------------------------------------------------------------
# 8a: each new family on the card against the CPU, f32, TF32 off, the same
# seeded weights, batch 2 at full resolution.  Relative L2 of the logits:
# the same f32 operations summed in other orders (cuDNN's convolutions and
# cuBLAS's products against the CPU's), ~1e-7 an op through 8 to 121
# layers; a TF32 product (10-bit mantissa) would break it
ZOO_BATCH = 2
ZOO_FAMILIES = (("alexnet", 224), ("vgg11", 224), ("vgg11_bn", 224),
                ("squeezenet1_0", 224), ("squeezenet1_1", 224),
                ("densenet121", 224), ("mobilenet0_25", 224),
                ("inception_v3", 299))
ZOO_REL = 1e-4
# 8b: BASELINE.md:13-16's inference batch, bf16; the bf16 logits against
# the f32 net's (relative L2)
ZOO_SERVE = (("alexnet", 224), ("vgg16", 224), ("inception_v3", 299))
ZOO_SERVE_BATCH, ZOO_SERVE_BATCHES = 32, 4
ZOO_BF16_REL = 2e-2
# the reference's published inference img/s at batch 32 (BASELINE.md; no
# bar here: other cards, cuDNN 5.1)
ZOO_PUBLISHED = {"alexnet": "1443.90 img/s on a K80, 4883.77 on a P100 "
                            "(BASELINE.md:13, :21)",
                 "vgg16": "228.96 img/s on a K80 (BASELINE.md:14)",
                 "inception_v3": "106.43 img/s on a K80 (BASELINE.md:16)"}
SERVER_REQUESTS, SERVER_CLIENTS, SERVER_MAX_BATCH = 16, 2, 8
# 8c: BASELINE.md:27's AlexNet training batch (483.37 img/s on a K80)
ALEXNET_TRAIN_BATCH, ALEXNET_WARMUP, ALEXNET_STEPS = 256, 3, 5
ALEXNET_OPT = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
# every other optimizer of this slice, 2 steps each from one saved state
OTHER_OPTIMIZERS = (
    ("adagrad", {"learning_rate": 1e-4}),
    ("adadelta", {}),
    ("rmsprop", {"learning_rate": 1e-4}),
    ("rmsprop", {"learning_rate": 1e-4, "centered": True}),
    ("ftrl", {"learning_rate": 0.01}),
    ("ftml", {"learning_rate": 1e-4}),
    ("signum", {"learning_rate": 1e-4, "momentum": 0.9}),
    ("sgld", {"learning_rate": 1e-6}),
    ("dcasgd", {"learning_rate": 0.01, "momentum": 0.9}),
    ("lbsgd", {"learning_rate": 0.01, "momentum": 0.9, "batch_scale": 2}),
    ("test", {}),
)
ZOO_OP_SPANS = ("Convolution", "FullyConnected", "Pooling", "Dropout",
                "Activation", "BatchNorm", "Concat", "nag_mom_update")
ZOO_GROUPS = (
    ("conv_layout_transpose", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("conv_fwd", ("op:Convolution",)),
    ("conv_dgrad_wgrad", ("_ConvolutionFunctionBackward",)),
    ("dense", ("op:FullyConnected", "MmBackward", "AddmmBackward",
               "TBackward")),
    ("pooling", ("op:Pooling", "MaxPool2DWithIndicesBackward",
                 "AvgPool2DBackward", "ConstantPadNdBackward")),
    ("dropout", ("op:Dropout", "WhereBackward", "DivBackward")),
    ("relu", ("op:Activation", "ReluBackward", "ThresholdBackward")),
    ("batchnorm", ("op:BatchNorm", "_BatchNormTrainFunction")),
    ("concat", ("op:Concat", "CatBackward")),
    ("optimizer_update", ("op:nag_mom_update",)),
)
# 8d: the op library on CUDA tensors against the port's CPU result.  Shapes:
# AlexNet's first activation (batch 8) and Inception's 35x35, 17x17 and
# 8x8 ones (batch 4); fc6's weight for the updates; (256, 1000) losses;
# 64 stacked 256x256 matrices; fft at (256, 4096)
OPLIB_SHAPES = {"alexnet_c1": (8, 64, 55, 55), "inc_35": (4, 192, 35, 35),
                "inc_17": (4, 768, 17, 17), "inc_8": (4, 2048, 8, 8)}
FC6 = (4096, 9216)
LOSS_SHAPE = (256, 1000)
LINALG_STACK, LINALG_N = 64, 256
FFT_SHAPE = (256, 4096)
# bounds (n ulps; as SWEEP_ULP's keys): the normalizations, LRN and the
# softmaxes sum a window or a row in another order on the card
# (reductions of 9 to 3025 values), the rest are one IEEE step or a
# library call both sides round once (a grouped deconvolution's sums)
SWEEP_ULP["nn"] = (((8, "max"), (16, "max")), ((1, "max"), (2, "max")))
# the update ops: elementwise f32 steps on both sides, in ulps at each
# output's largest value (the new weight w - u cancels where u ~ w, so a
# one-ulp difference of u is thousands of ulps of a tiny result: call 1 of
# PR 14 measured up to 2.6e5 ulps element by element)
UPDATE_ULP = 4
# 8d's bf16 weights through multi_precision: every optimizer but SGLD
# (random) at the rates and options of tests/test_torch_optimizer.py's
# OPTIMIZERS, which are not 8c's training rates: two steps of an fc6-shaped
# weight (0.01·N(0, 1)) on an fc6-shaped gradient (MP_GRAD·N(0, 1))
MP_OPTIMIZERS = (
    ("nag", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("adagrad", dict(learning_rate=0.1, wd=0.01, clip_gradient=1.5)),
    ("adadelta", dict(rho=0.8, epsilon=1e-4, wd=0.01)),
    ("rmsprop", dict(learning_rate=0.01, gamma1=0.8, clip_weights=2.0)),
    ("rmsprop", dict(learning_rate=0.01, centered=True, epsilon=1e-4)),
    ("ftrl", dict(learning_rate=0.1, lamda1=0.02, wd=0.01)),
    ("ftml", dict(learning_rate=0.01, wd=0.01)),
    ("signum", dict(learning_rate=0.05, momentum=0.8, wd_lh=0.01)),
    ("dcasgd", dict(learning_rate=0.1, momentum=0.9, lamda=0.1, wd=0.01)),
    ("lbsgd", dict(learning_rate=0.1, momentum=0.9, batch_scale=4,
                   warmup_epochs=1, updates_per_epoch=3)),
    ("test", {}),
)
MP_GRAD = 0.1
# the card's bf16 weights within MP_ULP bf16 ulps of the CPU's at the
# largest weight; the CPU's two steps move the largest-moved weight by at
# least MP_MOVE_ULP such ulps, so an update the card skipped or got wrong
# by more than an eighth of its size fails the bound
MP_ULP, MP_MOVE_ULP = 1, 8
# a loss: a row's log-softmax or a mean over 1000 values in another order
LOSS_REL = 1e-5
# linalg card vs CPU (cuSOLVER, cuBLAS, cuFFT against LAPACK, MKL or
# pocketfft): each output within 1e-4 of its largest value
LINALG_REL = 1e-4
# syevd's eigenvectors, card against CPU up to a sign per row: a vector
# moves by ~n·u·|A|/gap (n = 256, u = 6e-8, gaps of |A|/256) ~ 4e-3 of its
# unit norm, whichever solver runs; call 2 of PR 14 measured 1.5e-3
SYEVD_VECTOR_REL = 1e-2
# 8e: 2^24 draws a sampler; KS at p = 1e-6 and chi-square at p = 1e-6
RANDOM_N = 1 << 24
RANDOM_P = 1e-6


def _zoo_weights(mx, np, name, size, classes, rs):
    """A zoo net on the CPU with seeded weights (the port's Xavier draws
    after ``mx.random.seed``, BatchNorm's gamma, beta and running
    statistics drawn away from their init): the weights by name."""
    from incubator_mxnet_tpu_torch.convert import numpy_params
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    mx.random.seed(SEED)
    with mx.cpu():
        net = getattr(vision, name)(classes=classes)
        net.initialize(mx.init.Xavier())
        with mx.autograd.predict_mode():
            net(mx.nd.array(np.zeros((1, 3, size, size), np.float32)))
        weights = numpy_params(net)
    for n, v in weights.items():
        if n.endswith("gamma") or n.endswith("running_var"):
            weights[n] = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif n.endswith("beta") or n.endswith("running_mean"):
            weights[n] = (0.1 * rs.standard_normal(v.shape)).astype(
                np.float32)
    return weights


def _zoo_net(mx, name, weights, ctx, classes):
    from incubator_mxnet_tpu_torch.convert import load_numpy_params
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    net = getattr(vision, name)(classes=classes)
    load_numpy_params(net, weights, ctx)
    return net


def _rel_l2(np, got, want):
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) /
                 max(np.linalg.norm(np.asarray(want, np.float64)), 1e-30))


def zoo_parity(mx, card):
    """Phase 8a: each family on the card against the CPU from the same
    seeded f32 weights, inference mode, batch ZOO_BATCH at full resolution,
    TF32 off; then AlexNet's training-mode forward on the card, whose two
    dropout masks follow ``mx.random.seed``."""
    import numpy as np
    import torch
    rs = np.random.RandomState(SEED + 8)
    out = {}
    t0 = time.perf_counter()
    for name, size in ZOO_FAMILIES:
        weights = _zoo_weights(mx, np, name, size, 10, rs)
        x = rs.uniform(-1, 1, (ZOO_BATCH, 3, size, size)).astype(np.float32)
        logits = {}
        for ctx in (mx.cpu(), mx.gpu(0)):
            net = _zoo_net(mx, name, weights, ctx, 10)
            with mx.autograd.predict_mode():
                logits[ctx.device_type] = net(mx.nd.array(
                    x, ctx=ctx)).asnumpy()
            del net
        err = _rel_l2(np, logits["gpu"], logits["cpu"])
        out[name] = err
        print("zoo 8a: %s (classes=10) f32 inference, batch %d x 3x%dx%d, "
              "card vs CPU logits relative L2 %.3e (bound %.0e), %d "
              "parameters | %s" % (name, ZOO_BATCH, size, size, err, ZOO_REL,
                                   len(weights), card), flush=True)
        check(np.isfinite(logits["gpu"]).all() and err <= ZOO_REL,
              "8a: %s: card vs CPU relative L2 %.3e" % (name, err))
    gc.collect()
    torch.cuda.empty_cache()
    # training mode: dropout draws from the card's framework generator
    weights = _zoo_weights(mx, np, "alexnet", 224, 10, rs)
    net = _zoo_net(mx, "alexnet", weights, mx.gpu(0), 10)
    x = mx.nd.array(rs.uniform(-1, 1, (ZOO_BATCH, 3, 224, 224)).astype(
        np.float32), ctx=mx.gpu(0))
    runs = []
    for seed in (SEED, SEED, SEED + 1):
        mx.random.seed(seed)
        torch.manual_seed(seed + 100)   # the default generator plays no part
        with mx.autograd.train_mode():
            runs.append(net(x).asnumpy())
    with mx.autograd.predict_mode():
        infer = net(x).asnumpy()
    same = bool(np.array_equal(runs[0], runs[1]))
    differ = not np.array_equal(runs[0], runs[2])
    print("zoo 8a: alexnet training-mode forward on the card: bit-equal "
          "after the same mx.random.seed %s, different under another %s, "
          "unlike inference %s | %s" % (same, differ,
                                        not np.array_equal(runs[0], infer),
                                        card), flush=True)
    check(same and differ and not np.array_equal(runs[0], infer),
          "8a: alexnet's training-mode forward does not follow the seed")
    out["seconds"] = time.perf_counter() - t0
    del net
    gc.collect()
    torch.cuda.empty_cache()
    return out


def zoo_serve(mx, card):
    """Phase 8b: alexnet, vgg16 and inception_v3 (classes=1000) served in
    bf16, inference mode, batch ZOO_SERVE_BATCH: one warm-up and
    ZOO_SERVE_BATCHES timed batches (host clock to synchronize), the bf16
    logits against the f32 net's, one batch profiled by group; then alexnet
    behind ``mx.serving.Server``."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    rs = np.random.RandomState(SEED + 9)
    out = {}
    for name, size in ZOO_SERVE:
        mx.random.seed(SEED)
        net = getattr(vision, name)(classes=1000)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        net.collect_params().setattr("grad_req", "null")
        x32 = mx.nd.array(rs.uniform(0, 1, (ZOO_SERVE_BATCH, 3, size, size))
                          .astype(np.float32), ctx=mx.gpu(0))
        with mx.autograd.predict_mode():
            ref = net(x32).asnumpy()
        net.cast("bfloat16")
        x = x32.astype("bfloat16")
        del x32

        def batch():
            with mx.autograd.predict_mode():
                return net(x)
        got = batch().asnumpy()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(ZOO_SERVE_BATCHES):
            t0 = time.perf_counter()
            batch()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        with conv_flops() as flop:
            batch()
        mean = sum(ms) / len(ms)
        err = _rel_l2(np, got, ref)
        res = dict(batch_ms=ms, batch_ms_mean=mean,
                   img_per_s=ZOO_SERVE_BATCH / mean * 1e3,
                   peak_memory_bytes=peak, flop=flop[0],
                   tflops=flop[0] / mean / 1e9, bf16_vs_f32_rel_l2=err)
        print("zoo 8b: %s(classes=1000) bf16 inference, batch %d x 3x%dx%d: "
              "%s ms a batch (mean %.3f), %.1f img/s, %.4e conv and dense "
              "flop a batch (%.1f TFLOP/s), peak memory allocated %d bytes; "
              "bf16 logits vs the f32 net's, relative L2 %.3e (bound %.0e); "
              "published: %s | %s"
              % (name, ZOO_SERVE_BATCH, size, size, ["%.3f" % v for v in ms],
                 mean, res["img_per_s"], flop[0], res["tflops"], peak, err,
                 ZOO_BF16_REL, ZOO_PUBLISHED[name], card), flush=True)
        check(got.shape == (ZOO_SERVE_BATCH, 1000) and np.isfinite(got).all()
              and err <= ZOO_BF16_REL, "8b: %s: logits %s, finite %s, bf16 "
              "vs f32 %.3e" % (name, got.shape, np.isfinite(got).all(), err))
        res["profile"] = resnet_profile(
            batch, "8b %s one inference batch" % name, card,
            spans=ZOO_OP_SPANS, groups=ZOO_GROUPS)
        out[name] = res
        if name == "alexnet":
            out["server"] = zoo_server(mx, net, card, rs)
        del net, x
        gc.collect()
        torch.cuda.empty_cache()
    return out


def bf16_input(mx, net):
    """The served model of phase 8b: ``net`` (bf16) on requests that
    arrive as f32 host images, cast to bf16 inside the program."""

    class Bf16Input(mx.gluon.HybridBlock):
        def __init__(self, net, **kwargs):
            super().__init__(**kwargs)
            self.net = net

        def hybrid_forward(self, F, x):
            return self.net(F.Cast(x, dtype="bfloat16"))

    return Bf16Input(net)


def zoo_server(mx, net, card, rs):
    """8b: the bf16 AlexNet behind ``mx.serving.Server(max_batch=
    SERVER_MAX_BATCH)``: SERVER_REQUESTS one-image requests from
    SERVER_CLIENTS client threads; every served row bit-equal to the
    bucket-1 program's answer for that image."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch import serving
    from incubator_mxnet_tpu_torch.serving.batcher import host_rows
    dev = torch.device("cuda", 0)
    images = [rs.uniform(0, 1, (3, 224, 224)).astype(np.float32)
              for _ in range(SERVER_REQUESTS)]
    served = bf16_input(mx, net)
    t0 = time.perf_counter()
    srv = serving.Server(max_batch=SERVER_MAX_BATCH, max_wait_ms=5)
    try:
        h = srv.load("alexnet", block=served, example=mx.nd.array(
            images[0][None], ctx=mx.gpu(0)))
        load_s = time.perf_counter() - t0
        results, errors = [None] * len(images), []

        def client(k):
            try:
                for i in range(k, len(images), SERVER_CLIENTS):
                        results[i] = srv.predict("alexnet", images[i])
            except Exception as exc:       # reported below, then failed
                errors.append(repr(exc))
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(SERVER_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        check(not errors, "8b: a Server request failed: %s" % errors[:2])
        _e, params, _v = srv.registry.acquire("alexnet")
        prog = h.jit_for(1)
        same = 0
        for img, row in zip(images, results):
            want = host_rows(prog(params, torch.from_numpy(img[None]).to(
                dev)))[0]
            same += np.asarray(row).tobytes() == want.tobytes()
        stats = srv.stats()
    finally:
        srv.close()
    out = dict(load_s=load_s, wall_s=wall, requests=len(images),
               bit_equal_rows=same, captures=h.captures)
    print("zoo 8b: Server(max_batch=%d) serving the bf16 alexnet: %d "
          "one-image requests from %d client threads in %.3f s (load %.3f "
          "s, %d programs captured); %d of %d rows bit-equal to the bucket-1 "
          "program | %s" % (SERVER_MAX_BATCH, len(images), SERVER_CLIENTS,
                            wall, load_s, h.captures, same, len(images),
                            card), flush=True)
    check(same == len(images), "8b: %d of %d served rows differ from the "
          "bucket-1 program" % (len(images) - same, len(images)))
    out["stats"] = {k: v for k, v in stats.items()
                    if isinstance(v, (int, float, str))}
    return out


def alexnet_train(mx, card):
    """Phase 8c: alexnet(classes=1000) in f32 (Xavier, seeded) trained by
    the plain Gluon loop at BASELINE.md:27's batch: record,
    SoftmaxCrossEntropyLoss, backward, gluon.Trainer('nag').step, both
    Dropout(0.5) layers live; ALEXNET_WARMUP warm-up and ALEXNET_STEPS
    timed steps on one batch from np.random.RandomState(0); one step
    profiled; then each of OTHER_OPTIMIZERS takes 2 steps from the same
    saved state (each weight tensor must move; FTRL may keep a bias at
    0, its sparsity)."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch.convert import numpy_params
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    t0 = time.perf_counter()
    mx.random.seed(SEED)
    net = vision.alexnet(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    rs = np.random.RandomState(0)
    x = mx.nd.array(rs.rand(ALEXNET_TRAIN_BATCH, 3, 224, 224).astype(
        np.float32), ctx=mx.gpu(0))
    y = mx.nd.array((rs.rand(ALEXNET_TRAIN_BATCH) * 1000).astype(
        np.float32), ctx=mx.gpu(0))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.predict_mode():
        net(x[0:1])                      # resolves the deferred shapes
    saved = numpy_params(net)

    def step(trainer):
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(ALEXNET_TRAIN_BATCH)
        return mx.nd.mean(loss)

    trainer = mx.gluon.Trainer(net.collect_params(), "nag",
                               dict(ALEXNET_OPT))
    losses, step_ms = [], []
    for i in range(ALEXNET_WARMUP + ALEXNET_STEPS):
        if i == ALEXNET_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if i == 0:
            with conv_flops() as forward_flop:
                with mx.autograd.predict_mode():
                    net(x)
            loss = step(trainer)
        else:
            loss = step(trainer)
        losses.append(float(loss.asscalar()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    timed = step_ms[ALEXNET_WARMUP:]
    mean = sum(timed) / len(timed)
    std = (sum((v - mean) ** 2 for v in timed) / len(timed)) ** 0.5
    flop = 3 * forward_flop[0]
    out = dict(step_ms=timed, step_ms_mean=mean, step_ms_std=std,
               img_per_s=ALEXNET_TRAIN_BATCH / mean * 1e3,
               flop_per_step=flop, mfu=flop / (mean / 1e3) / H100_BF16_FLOPS,
               peak_memory_bytes=peak, losses=losses,
               setup_s=time.perf_counter() - t0)
    for i, (ms, loss) in enumerate(zip(step_ms, losses)):
        print("zoo 8c: step %d%s: %.3f ms, loss %.6f | %s"
              % (i, " (warm-up)" if i < ALEXNET_WARMUP else "", ms, loss,
                 card))
    print("zoo 8c: alexnet(classes=1000) f32, gluon.Trainer(nag %s), batch "
          "%d x 3x224x224, dropout live: %d timed steps, mean %.3f ms (std "
          "%.3f, %.3f-%.3f), %.1f img/s, MFU %.4f (%.4e conv and dense flop "
          "a step, 3x the forward's, over 989 TFLOP/s), peak memory "
          "allocated %d bytes; published: 483.37 img/s on a K80 "
          "(BASELINE.md:27) | %s"
          % (ALEXNET_OPT, ALEXNET_TRAIN_BATCH, ALEXNET_STEPS, mean, std,
             min(timed), max(timed), out["img_per_s"], out["mfu"], flop,
             peak, card), flush=True)
    check(all(math.isfinite(v) for v in losses), "8c: a loss is not finite: "
          "%s" % losses)
    check(losses[-1] < losses[0], "8c: the loss did not fall: %s" % losses)
    out["profile"] = resnet_profile(
        lambda: step(trainer).asscalar(), "8c one training step", card,
        spans=ZOO_OP_SPANS, groups=ZOO_GROUPS)
    # the other optimizers, each from the saved start
    moved = {}
    names = [n for n in saved]
    for opt, kwargs in OTHER_OPTIMIZERS:
        for name, p in net.collect_params().items():
            p.set_data(mx.nd.array(saved[name], ctx=mx.gpu(0)))
        tr = mx.gluon.Trainer(net.collect_params(), opt, dict(kwargs))
        ls = [float(step(tr).asscalar()) for _ in range(2)]
        now = numpy_params(net)
        least = min(float(np.abs(now[n] - saved[n]).max()) for n in names
                    if n.endswith("weight"))
        key = opt + ("_centered" if kwargs.get("centered") else "")
        moved[key] = dict(losses=ls, least_weight_move=least)
        check(all(math.isfinite(v) for v in ls) and least > 0,
              "8c: %s: losses %s, the least-moved weight %.3e" % (key, ls,
                                                                  least))
    out["other_optimizers"] = moved
    print("zoo 8c: from one saved state, 2 steps each: %s | %s" % (
        ", ".join("%s losses %.4f %.4f, every weight moved (least %.2e)" % (
            k, v["losses"][0], v["losses"][1], v["least_weight_move"])
            for k, v in moved.items()), card), flush=True)
    del trainer, net, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return out


def oplib_cases():
    """The deterministic ops of ops/nn.py at AlexNet's and Inception's
    activation shapes, as 7a's cases (family, op, params, input specs,
    dtypes, bound key, inputs with a gradient)."""
    s = OPLIB_SHAPES
    c, n = s["inc_35"][1], s["inc_17"][1]
    both = ("float32", "bfloat16")
    return [
        ("nn", "LRN", dict(nsize=5), [("any", s["alexnet_c1"])], both, "nn",
         (0,)),
        ("nn", "InstanceNorm", {}, [("any", s["inc_35"]), ("near1", (c,)),
                                    ("any", (c,))], both, "nn", (0, 1, 2)),
        ("nn", "LeakyReLU", dict(slope=0.1), [("any", s["inc_17"])], both,
         "broadcast", (0,)),
        ("nn", "LeakyReLU", dict(act_type="elu", slope=0.5),
         [("any", s["inc_17"])], both, "transcendental", (0,)),
        ("nn", "LeakyReLU", dict(act_type="prelu"),
         [("any", s["inc_17"]), ("unit", (n,))], both, "nn", (0, 1)),
        ("nn", "UpSampling", dict(scale=2), [("any", s["inc_17"])], both,
         "nn", (0,)),
        ("nn", "SoftmaxActivation", dict(mode="channel"),
         [("any", s["inc_8"])], both, "nn", (0,)),
        ("nn", "SoftmaxActivation", {}, [("any", s["inc_8"])], both, "nn",
         (0,)),
        ("nn", "LinearRegressionOutput", {},
         [("any", LOSS_SHAPE), ("any", LOSS_SHAPE)], both, "nn", (0,)),
        ("nn", "MAERegressionOutput", {},
         [("any", LOSS_SHAPE), ("any", LOSS_SHAPE)], both, "nn", (0,)),
        ("nn", "LogisticRegressionOutput", {},
         [("any", LOSS_SHAPE), ("unit", LOSS_SHAPE)], both, "nn", (0,)),
        ("nn", "SVMOutput", dict(margin=0.5), [("any", LOSS_SHAPE),
                                               ("small", (LOSS_SHAPE[0],))],
         ("float32",), "nn", (0,)),
    ]


def _upsampling_bilinear(mx, np, rs, card):
    """Bilinear UpSampling (MXNet's grouped Deconvolution with the
    Bilinear weight) at Inception's 17x17 map, card against CPU, under
    sync-debug mode "error"."""
    import torch
    x = sweep_input(rs, "any", OPLIB_SHAPES["inc_17"])
    c = x.shape[1]
    outs = {}
    for ctx in (mx.cpu(), mx.gpu(0)):
        w = mx.nd.zeros((c, 1, 4, 4), ctx=ctx)
        mx.init.Bilinear()(mx.initializer.InitDesc("up_weight"), w)
        xs = mx.nd.array(x, ctx=ctx)
        with card_calls(ctx, torch):
            y = mx.nd.UpSampling(xs, w, scale=2, sample_type="bilinear",
                                 num_filter=c)
        outs[ctx.device_type] = y._data
    return _ulp_err(outs["gpu"], outs["cpu"], "max")


def _update_inputs(rs, np, names):
    """fc6-shaped f32 update inputs: the weight, its gradient, and states
    (``var``-named states non-negative)."""
    f = lambda scale: (rs.standard_normal(FC6) * scale).astype(np.float32)
    make = {"w": lambda: f(0.01), "g": lambda: f(1e-3),
            "mom": lambda: f(1e-4), "var": lambda: np.abs(f(1e-4)),
            "mean": lambda: f(1e-5)}
    return [make[n]() for n in names]


# each update op's inputs and parameters (module 6), at fc6's shape
UPDATE_CASES = (
    ("nag_mom_update", ("w", "g", "mom"), dict(lr=0.01, momentum=0.9,
                                               wd=1e-4)),
    ("rmsprop_update", ("w", "g", "var"), dict(lr=1e-3, gamma1=0.9,
                                               clip_weights=1.0)),
    ("rmspropalex_update", ("w", "g", "var", "mom", "mean"),
     dict(lr=1e-3, gamma1=0.9, gamma2=0.9, epsilon=1e-4)),
    ("ftrl_update", ("w", "g", "mom", "var"), dict(lr=0.1, lamda1=1e-3)),
    ("ftml_update", ("w", "g", "var", "var", "mom"), dict(lr=1e-3, t=3)),
    ("signsgd_update", ("w", "g"), dict(lr=1e-3, wd=1e-4)),
    ("signum_update", ("w", "g", "mom"), dict(lr=1e-3, momentum=0.9,
                                              wd_lh=1e-4)),
)


def updates_on_card(mx, rs):
    """8d: each update op of this slice at fc6's shape in f32, on CUDA
    tensors under sync-debug mode "error" against the CPU: the new weight
    and every state written back, within UPDATE_ULP ulps at its largest
    value; then each of MP_OPTIMIZERS on a bf16 weight of that shape
    through ``multi_precision`` (an f32 master copy), 2 steps, the bf16
    weights within MP_ULP bf16 ulps at their largest value, where the
    CPU's 2 steps moved them at least MP_MOVE_ULP.  Returns the largest
    errors and (``*_move``) the CPU's moves, in those ulps."""
    import numpy as np
    import torch
    worst = {}
    for name, names, params in UPDATE_CASES:
        arrays = _update_inputs(rs, np, names)
        res = {}
        for ctx in (mx.cpu(), mx.gpu(0)):
            xs = [mx.nd.array(a, ctx=ctx) for a in arrays]
            with card_calls(ctx, torch):
                getattr(mx.nd, name)(*xs, out=xs[0], **params)
            res[ctx.device_type] = [x._data for i, x in enumerate(xs)
                                    if i != 1]
        err = max(_ulp_err(g, w, "max") for g, w in zip(res["gpu"],
                                                         res["cpu"]))
        worst[name] = err
        check(err <= UPDATE_ULP, "8d: %s: %.3g ulp above %d"
              % (name, err, UPDATE_ULP))
    grad = (rs.standard_normal(FC6) * MP_GRAD).astype(np.float32)
    w0 = (rs.standard_normal(FC6) * 0.01).astype(np.float32)
    for opt, kwargs in MP_OPTIMIZERS:
        res = {}
        for ctx in (mx.cpu(), mx.gpu(0)):
            o = mx.optimizer.create(opt, multi_precision=True, **kwargs)
            upd = mx.optimizer.get_updater(o)
            w = mx.nd.array(w0, ctx=ctx).astype("bfloat16")
            res["start"] = w._data.clone()
            g = mx.nd.array(grad, ctx=ctx).astype("bfloat16")
            for _ in range(2):
                upd(0, g, w)
            res[ctx.device_type] = w._data
        key = "mp_" + opt + ("_centered" if kwargs.get("centered") else "")
        worst[key] = _ulp_err(res["gpu"], res["cpu"], "max")
        moved = _ulp_err(res["start"], res["cpu"], "max")
        worst[key + "_move"] = moved
        check(worst[key] <= MP_ULP and moved >= MP_MOVE_ULP,
              "8d: %s: bf16 weights %.3g ulp apart (bound %d), the CPU's "
              "update moved them %.3g ulp (at least %d)"
              % (key, worst[key], MP_ULP, moved, MP_MOVE_ULP))
    return worst


# the losses of module 8 at (256, 1000): (class, kwargs, label kind)
LOSS_CASES = (
    ("L1Loss", {}, "any"), ("SigmoidBinaryCrossEntropyLoss", {}, "bits"),
    ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True}, "bits"),
    ("KLDivLoss", {"from_logits": False}, "probs"), ("HuberLoss", {}, "any"),
    ("HingeLoss", {}, "signs"), ("SquaredHingeLoss", {}, "signs"),
    ("LogisticLoss", {}, "signs"),
    ("LogisticLoss", {"label_format": "binary"}, "bits"),
    ("TripletLoss", {}, "any"),
)


def losses_on_card(mx, rs):
    """8d: each loss at LOSS_SHAPE on CUDA tensors against the CPU,
    forward and the prediction's gradient, under sync-debug mode "error",
    within LOSS_REL of the largest value.  Returns the largest errors."""
    import numpy as np
    import torch
    worst = {}
    for name, kwargs, kind in LOSS_CASES:
        pred = sweep_input(rs, "any", LOSS_SHAPE)
        if kwargs.get("from_sigmoid"):
            pred = 1 / (1 + np.exp(-pred))
        label = {"any": lambda: sweep_input(rs, "any", LOSS_SHAPE),
                 "bits": lambda: (rs.random(LOSS_SHAPE) < 0.5).astype(
                     np.float32),
                 "signs": lambda: np.where(rs.random(LOSS_SHAPE) < 0.5, -1,
                                           1).astype(np.float32),
                 "probs": lambda: (lambda p: p / p.sum(-1, keepdims=True))(
                     rs.random(LOSS_SHAPE, dtype=np.float32) + 0.05)}[kind]()
        extra = [sweep_input(rs, "any", LOSS_SHAPE)] \
            if name == "TripletLoss" else []
        res = {}
        for ctx in (mx.cpu(), mx.gpu(0)):
            loss_fn = getattr(mx.gluon.loss, name)(**kwargs)
            p = mx.nd.array(pred, ctx=ctx)
            args = [mx.nd.array(a, ctx=ctx) for a in [label] + extra]
            p.attach_grad()
            with card_calls(ctx, torch):
                with mx.autograd.record():
                    loss = loss_fn(p, *args)
                loss.backward()
            res[ctx.device_type] = (loss.asnumpy(), p.grad.asnumpy())
        key = name + "".join("_%s" % v for v in kwargs.values())
        worst[key] = max(
            float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)
            for g, w in zip(res["gpu"], res["cpu"]))
        check(worst[key] <= LOSS_REL, "8d: %s: card vs CPU %.3e of the "
              "largest value" % (key, worst[key]))
    return worst


def _spd(np, rs, n, s):
    """``s`` symmetric positive definite n x n matrices Q·diag(λ)·Qᵀ with
    the eigenvalues λ spread evenly over [1, 2]: well conditioned, and
    with gaps of 1/n between eigenvalues, so that the eigenvectors are too
    (a Wishart matrix's smallest eigenvalues lie ~1e-5 apart, which moved
    syevd's vectors by 0.42 between card and CPU in call 1 of PR 14)."""
    q = np.linalg.qr(rs.standard_normal((s, n, n)))[0]
    lam = np.linspace(1.0, 2.0, n)
    return ((q * lam) @ q.transpose(0, 2, 1)).astype(np.float32)


def linalg_on_card(mx, rs):
    """8d: the linalg ops on LINALG_STACK stacked LINALG_N x LINALG_N
    well-conditioned matrices and fft/ifft at FFT_SHAPE, on CUDA tensors
    against the CPU, forward and backward, each output within LINALG_REL of
    its largest value; under sync-debug mode "error" but ``syevd``, which
    waits for the card (cuSOLVER's ``info``, read by ``eigh``): its
    eigenvalues and U·A·Uᵀ = diag(L) within LINALG_REL, its vectors up to
    a sign per row within SYEVD_VECTOR_REL.  Returns the largest errors."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch.ops.registry import get_op
    s, n = LINALG_STACK, LINALG_N
    a = (rs.standard_normal((s, n, n)) / np.sqrt(n)).astype(np.float32)
    b = (rs.standard_normal((s, n, n)) / np.sqrt(n)).astype(np.float32)
    low = (np.tril(a) + 2 * np.eye(n)).astype(np.float32)
    spd = _spd(np, rs, n, s)
    chol = np.linalg.cholesky(spd.astype(np.float64)).astype(np.float32)
    wide = a[:, : n // 2]
    cases = [("_linalg_gemm", [a, b, a], dict(alpha=0.5, beta=2.0),
              (0, 1, 2)),
             ("_linalg_gemm2", [a, b], dict(transpose_b=True), (0, 1)),
             ("_linalg_potrf", [spd], {}, (0,)),
             ("_linalg_potri", [chol], {}, (0,)),
             ("_linalg_trmm", [low, b], dict(rightside=True), (0, 1)),
             ("_linalg_trsm", [low, b], dict(transpose=True), (0, 1)),
             ("_linalg_sumlogdiag", [spd], {}, (0,)),
             ("_linalg_syrk", [a], dict(alpha=0.5), (0,)),
             ("_linalg_gelqf", [wide], {}, (0,)),
             ("_contrib_fft", [sweep_input(rs, "any", FFT_SHAPE)], {}, (0,)),
             ("_contrib_ifft", [sweep_input(rs, "any", FFT_SHAPE)], {},
              (0,))]
    worst = {}
    heads = {}
    for name, arrays, params, grads in cases:
        want = _sweep_run(mx, get_op(name), arrays, params, "float32",
                          mx.cpu(), heads, grads)
        got = _sweep_run(mx, get_op(name), arrays, params, "float32",
                         mx.gpu(0), heads, grads)
        err = 0.0
        for gt, wt in zip(got[0] + got[1], want[0] + want[1]):
            w = wt.detach().double()
            err = max(err, float((gt.detach().cpu().double() - w).abs().max()) /
                      max(float(w.abs().max()), 1e-30))
        worst[name] = err
        check(err <= LINALG_REL, "8d: %s: card vs CPU %.3e of the largest "
              "value" % (name, err))
    # syevd (waits for the card): the eigenvalues, U·A·Uᵀ = diag(L) on the
    # card, and the vectors up to a sign per row against the CPU's
    res = {}
    for ctx in (mx.cpu(), mx.gpu(0)):
        u, lam = mx.nd.linalg.syevd(mx.nd.array(spd, ctx=ctx))
        res[ctx.device_type] = (u.asnumpy().astype(np.float64),
                                lam.asnumpy().astype(np.float64))
    (gu, gl), (wu, wl) = res["gpu"], res["cpu"]
    sign = np.sign((gu * wu).sum(-1, keepdims=True))
    diag = gu @ spd.astype(np.float64) @ gu.transpose(0, 2, 1)
    worst["_linalg_syevd"] = max(
        float(np.abs(gl - wl).max() / np.abs(wl).max()),
        float(np.abs(diag - gl[..., None] * np.eye(n)).max() /
              np.abs(gl).max()))
    worst["_linalg_syevd_vectors"] = float(np.abs(gu * sign - wu).max() /
                                           np.abs(wu).max())
    check(worst["_linalg_syevd"] <= LINALG_REL and
          worst["_linalg_syevd_vectors"] <= SYEVD_VECTOR_REL,
          "8d: syevd: eigenvalues and U·A·Uᵀ %.3e, vectors %.3e, card vs "
          "CPU" % (worst["_linalg_syevd"], worst["_linalg_syevd_vectors"]))
    return worst


def initializers_on_card(mx):
    """8d: the deterministic initializers fill the same values on the card
    as on the CPU, bit for bit."""
    import numpy as np
    cases = [(mx.init.Bilinear(), "up_weight", (64, 1, 8, 8)),
             (mx.init.LSTMBias(forget_bias=1.5), "lstm_bias", (4096,)),
             (mx.init.Constant(0.3), "w_weight", FC6),
             (mx.init.One(), "w_weight", FC6),
             (mx.init.Load({"arg:w_weight": np.arange(12.0).reshape(3, 4)}),
              "w_weight", (3, 4)),
             (mx.init.Mixed(["up.*", ".*"], [mx.init.Bilinear(),
                                             mx.init.Zero()]),
              "up_weight", (8, 2, 4, 4))]
    for init, name, shape in cases:
        vals = []
        for ctx in (mx.cpu(), mx.gpu(0)):
            arr = mx.nd.zeros(shape, ctx=ctx)
            init(mx.initializer.InitDesc(name), arr)
            vals.append(arr.asnumpy())
        check(np.array_equal(vals[0], vals[1]), "8d: %s fills other values "
              "on the card" % type(init).__name__)
    return len(cases)


def op_library(mx, card):
    """Phase 8d: the op library of this slice on CUDA tensors against the
    port's CPU result for the same numpy inputs, forward and backward,
    under sync-debug mode "error" (only syevd exempt): the nn ops
    (:func:`oplib_cases`, 7a's harness), bilinear UpSampling, the update
    ops and optimizers, the losses, the linalg ops, the deterministic
    initializers.  One line each."""
    import numpy as np
    t0 = time.perf_counter()
    rs = np.random.default_rng(SEED + 10)
    out = {}
    nn = dict(cases=0, max_ulp=0.0, worst_case=None)
    for case in oplib_cases():
        for dtype in case[4]:
            worst, _bound = sweep_case(mx, case, dtype, rs)
            nn["cases"] += 1
            if worst > nn["max_ulp"]:
                nn["max_ulp"] = worst
                nn["worst_case"] = "%s %s %s" % (case[1], case[2], dtype)
    nn["upsampling_bilinear_ulp"] = _upsampling_bilinear(mx, np, rs, card)
    check(nn["upsampling_bilinear_ulp"] <= SWEEP_ULP["nn"][0][0][0],
          "8d: bilinear UpSampling %.3g ulp" % nn["upsampling_bilinear_ulp"])
    out["nn"] = nn
    print("oplib 8d nn: %d cases (f32 and bf16) at AlexNet's and "
          "Inception's activation shapes %s, max error %.3g ulp (%s; bounds "
          "f32 %s, bf16 %s); bilinear UpSampling %.3g ulp | %s"
          % (nn["cases"], OPLIB_SHAPES, nn["max_ulp"], nn["worst_case"],
             SWEEP_ULP["nn"][0], SWEEP_ULP["nn"][1],
             nn["upsampling_bilinear_ulp"], card), flush=True)
    out["updates"] = updates_on_card(mx, rs)
    print("oplib 8d updates: at fc6's shape %s, card vs CPU in ulps "
          "(f32 ops bound %d; bf16 weights through multi_precision bound "
          "%d where the CPU moved them at least %d): %s | %s" % (
              FC6, UPDATE_ULP, MP_ULP, MP_MOVE_ULP, json.dumps(
              {k: round(v, 3) for k, v in out["updates"].items()}), card),
          flush=True)
    out["losses"] = losses_on_card(mx, rs)
    print("oplib 8d losses: at %s, card vs CPU (forward and gradient, of "
          "the largest value; bound %.0e): %s | %s" % (
              LOSS_SHAPE, LOSS_REL, json.dumps(
                  {k: "%.2e" % v for k, v in out["losses"].items()}), card),
          flush=True)
    out["linalg"] = linalg_on_card(mx, rs)
    print("oplib 8d linalg: %d stacked %dx%d matrices, fft/ifft at %s, "
          "card vs CPU (forward and gradient, of the largest value; bound "
          "%.0e; syevd outside sync-debug mode: eigenvalues and U·A·Uᵀ to "
          "that bound, vectors up to a sign per row to %.0e): %s | %s"
          % (LINALG_STACK, LINALG_N, LINALG_N, FFT_SHAPE, LINALG_REL,
             SYEVD_VECTOR_REL, json.dumps({k: "%.2e" % v for k, v in
                                           out["linalg"].items()}), card),
          flush=True)
    out["initializers"] = initializers_on_card(mx)
    out["seconds"] = time.perf_counter() - t0
    print("oplib 8d: %d deterministic initializers bit-equal on the card; "
          "8d in %.1f s | %s" % (out["initializers"], out["seconds"], card),
          flush=True)
    return out


def _moments(x, mean, var, m4):
    """(|mean - μ| / SE, |var - σ²| / SE) of the draws ``x`` on the card,
    in float64; ``m4`` the fourth central moment."""
    x = x.double().flatten()
    n = x.numel()
    m, v = float(x.mean()), float(x.var(unbiased=False))
    return (abs(m - mean) / math.sqrt(var / n),
            abs(v - var) / math.sqrt(max(m4 - var * var, 1e-30) / n))


def _ks(np, x, cdf):
    """Kolmogorov-Smirnov distance of the draws against ``cdf`` (scipy)."""
    xs = np.sort(x.double().cpu().numpy())
    f = cdf(xs)
    n = xs.size
    i = np.arange(1, n + 1)
    return float(max((i / n - f).max(), (f - (i - 1) / n).max()))


def random_draws(mx, card):
    """Phase 8e: the samplers on the card, RANDOM_N draws each (f32; uniform
    and normal also bf16), drawn under sync-debug mode "error": mean and
    variance within 6 standard errors, the KS distance against scipy's CDF
    below the large-n bound at p = RANDOM_P, multinomial frequencies by
    chi-square, shuffle a permutation of whole rows, Dropout's keep share,
    values and gradient, rrelu's slopes in their range, and every draw
    bit-equal after the same ``mx.random.seed`` with torch's default
    generators reseeded in between."""
    import numpy as np
    import scipy.stats as st
    import torch
    gpu = mx.gpu(0)
    n = RANDOM_N
    t0 = time.perf_counter()
    ks_bound = math.sqrt(-math.log(RANDOM_P / 2) / (2 * n))

    def gm4(a, b):
        return 3 * a * (a + 2) * b ** 4
    # (name, draw, mean, var, 4th central moment, scipy cdf or None)
    samplers = [
        ("uniform", lambda d: mx.random.uniform(-1, 3, shape=(n,), ctx=gpu,
                                                dtype=d),
         1.0, 16 / 12, 256 / 80, st.uniform(-1, 4).cdf),
        ("normal", lambda d: mx.random.normal(2, 0.5, shape=(n,), ctx=gpu,
                                              dtype=d),
         2.0, 0.25, 3 * 0.0625, st.norm(2, 0.5).cdf),
        ("exponential", lambda d: mx.random.exponential(
            4.0, shape=(n,), ctx=gpu), 0.25, 1 / 16, 9 / 256,
         st.expon(scale=0.25).cdf),
        ("gamma_0.5", lambda d: mx.random.gamma(0.5, 2.0, shape=(n,),
                                                ctx=gpu),
         1.0, 2.0, gm4(0.5, 2.0), st.gamma(0.5, scale=2.0).cdf),
        ("gamma_2", lambda d: mx.random.gamma(2.0, 1.0, shape=(n,), ctx=gpu),
         2.0, 2.0, gm4(2.0, 1.0), st.gamma(2.0).cdf),
        ("gamma_9", lambda d: mx.random.gamma(9.0, 0.5, shape=(n,), ctx=gpu),
         4.5, 2.25, gm4(9.0, 0.5), st.gamma(9.0, scale=0.5).cdf),
        ("poisson", lambda d: mx.random.poisson(3.5, shape=(n,), ctx=gpu),
         3.5, 3.5, 3.5 + 3 * 3.5 ** 2, None),
        ("negative_binomial", lambda d: mx.random.negative_binomial(
            4, 0.3, shape=(n,), ctx=gpu), 4 * 0.7 / 0.3, 4 * 0.7 / 0.09,
         None, None),
        ("generalized_negative_binomial",
         lambda d: mx.random.generalized_negative_binomial(
             2.0, 0.5, shape=(n,), ctx=gpu), 2.0, 4.0, None, None),
    ]
    out = {}
    mx.random.seed(SEED)
    for name, draw, mean, var, m4, cdf in samplers:
        dtypes = ("float32", "bfloat16") if name in ("uniform", "normal") \
            else ("float32",)
        for dtype in dtypes:
            with card_calls(gpu, torch):
                x = draw(dtype)._data
            check(x.device.type == "cuda" and x.numel() == n,
                  "8e: %s drew %s on %s" % (name, tuple(x.shape), x.device))
            fourth = m4 if m4 is not None else float(
                ((x.double() - x.double().mean()) ** 4).mean())
            zm, zv = _moments(x, mean, var, fourth)
            key = "%s_%s" % (name, dtype)
            res = dict(mean_se=zm, var_se=zv)
            if cdf is not None and dtype == "float32":
                res["ks"] = _ks(np, x, cdf)
            out[key] = res
            check(zm <= 6 and zv <= 6, "8e: %s: mean %.2f, variance %.2f "
                  "standard errors off" % (key, zm, zv))
            check(res.get("ks", 0.0) <= ks_bound, "8e: %s: KS %.3e above "
                  "%.3e" % (key, res.get("ks", 0.0), ks_bound))
            if name == "uniform":
                check(float(x.min()) >= -1 and float(x.max()) < 3,
                      "8e: uniform %s outside [-1, 3)" % dtype)
            del x
    # multinomial: class frequencies by chi-square, per row
    p = torch.tensor([[0.05, 0.15, 0.3, 0.5], [0.5, 0.3, 0.15, 0.05]],
                     device="cuda")
    probs = mx.nd.NDArray(p)
    with card_calls(gpu, torch):
        ids = mx.random.multinomial(probs, shape=n // 4)._data
    chi = []
    for row, q in zip(ids, p.double().cpu().numpy()):
        counts = torch.bincount(row.long(), minlength=4).cpu().numpy()
        chi.append(float(st.chisquare(counts, q / q.sum() * row.numel())
                         .pvalue))
    out["multinomial_chi2_p"] = chi
    check(min(chi) > RANDOM_P, "8e: multinomial frequencies, chi-square p "
          "%s" % chi)
    # shuffle: a permutation of whole rows
    rows = n // 16
    data = torch.arange(rows, device="cuda", dtype=torch.float32)[:, None] \
        * 4 + torch.arange(4, device="cuda", dtype=torch.float32)
    with card_calls(gpu, torch):
        sh = mx.random.shuffle(mx.nd.NDArray(data))._data
    ok = torch.equal(torch.sort(sh[:, 0])[0], data[:, 0]) and torch.equal(
        sh - sh[:, :1], data - data[:, :1]) and not torch.equal(sh, data)
    out["shuffle_rows"] = rows
    check(ok, "8e: shuffle is not a permutation of whole rows")
    # dropout: keep share, kept values, gradient
    pdrop = 0.5
    x = mx.nd.array(np.random.RandomState(SEED).uniform(
        0.5, 2.0, (256, 4096)).astype(np.float32), ctx=gpu)
    x.attach_grad()
    with card_calls(gpu, torch):
        with mx.autograd.record():
            y = mx.nd.Dropout(x, p=pdrop)
        y.backward()
    yt, xt, gt = y._data, x._data, x.grad._data
    mask = yt != 0
    keep = torch.full((), 1 - pdrop, device="cuda")
    share = float(mask.float().mean())
    sigma = math.sqrt(pdrop * (1 - pdrop) / mask.numel())
    values = torch.equal(yt[mask], (xt / keep)[mask])
    grads = torch.equal(gt, torch.where(mask, 1 / keep, torch.zeros_like(gt)))
    out["dropout"] = dict(keep_share=share, sigmas=abs(share - 0.5) / sigma,
                          values=values, gradient=grads)
    check(abs(share - (1 - pdrop)) <= 6 * sigma and values and grads,
          "8e: dropout keep share %.5f, values %s, gradient %s"
          % (share, values, grads))
    # rrelu: n slopes in f32 and bf16 on x = -1 (the output is minus the
    # slope, exactly), in [lower, upper) and by their moments
    lo, hi = 0.1, 0.3
    slopes = {}
    for dtype in ("float32", "bfloat16"):
        neg = mx.nd.full((n,), -1.0, ctx=gpu, dtype=dtype)
        with card_calls(gpu, torch):
            with mx.autograd.train_mode():
                r = -mx.nd.LeakyReLU(neg, act_type="rrelu", lower_bound=lo,
                                     upper_bound=hi)._data
        zm, zv = _moments(r, (lo + hi) / 2, (hi - lo) ** 2 / 12,
                          (hi - lo) ** 4 / 80)
        least, most = float(r.min()), float(r.max())
        slopes[dtype] = dict(mean_se=zm, var_se=zv, least=least, most=most)
        check(lo <= least and most < hi and zm <= 6 and zv <= 6,
              "8e: rrelu %s slopes in [%.4f, %.4f], mean %.2f, variance "
              "%.2f standard errors off" % (dtype, least, most, zm, zv))
        del neg, r
    out["rrelu_slopes"] = slopes
    # seeds: every sampler again after the same seed, default generators
    # reseeded in between
    def all_draws():
        outs = []
        with card_calls(gpu, torch):
            for name, draw, *_ in samplers:
                outs.append(draw("float32")._data[:4096].clone())
            outs.append(mx.random.multinomial(probs, shape=64)._data)
            outs.append(mx.random.shuffle(mx.nd.NDArray(data))._data[:64])
            with mx.autograd.train_mode():
                outs.append(mx.nd.Dropout(x, p=0.5)._data[:4])
        return outs
    mx.random.seed(SEED + 5)
    torch.manual_seed(1)
    torch.cuda.manual_seed_all(1)
    first = all_draws()
    mx.random.seed(SEED + 5)
    torch.manual_seed(2)
    torch.cuda.manual_seed_all(2)
    again = all_draws()
    mx.random.seed(SEED + 6)
    other = all_draws()
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    differ = sum(not torch.equal(a, b) for a, b in zip(first, other))
    out["seed_bit_equal"] = same
    check(same and differ == len(first), "8e: draws after the same seed "
          "equal %s; %d of %d differ under another" % (same, differ,
                                                      len(first)))
    out["seconds"] = time.perf_counter() - t0
    print("random 8e: %d draws a sampler on the card (KS bound %.3e at p = "
          "%.0e): %s; multinomial chi-square p %s; shuffle of %d rows a "
          "permutation; dropout keep share %.5f (%.2f sigma), kept x/keep "
          "and gradient mask/keep exact; rrelu slopes in [%g, %g) %s; every "
          "draw bit-equal after the same seed with torch's default "
          "generators reseeded; %.1f s | %s"
          % (n, ks_bound, RANDOM_P, json.dumps(
              {k: {m: round(v, 6) for m, v in r.items()}
               for k, r in out.items() if isinstance(r, dict) and
               "mean_se" in r}), ["%.3g" % v for v in chi], rows, share,
             out["dropout"]["sigmas"], lo, hi, json.dumps(
                 {d: {m: round(v, 6) for m, v in r.items()}
                  for d, r in slopes.items()}), out["seconds"], card),
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 9: the symbolic path (mx.sym, the Executor) and the Module API.
# The symbolic ResNet-50 v1 is a copy, over the port's mx.sym, of
# example/image-classification/symbols/resnet.py get_symbol (its JSON is
# held byte-equal to the example's in tests/test_torch_symbol.py); it is
# trained through Module.fit as example/image-classification/common.py:32-50
# trains it, and served through Server(module=).  The LM's attention layer
# runs as a Symbol through the Executor: kernel B1 (forward and backward)
# in the second execution mode
# ---------------------------------------------------------------------------
SYM_PARITY_BATCH = 2
SYM_TRAIN_BATCH, SYM_TRAIN_BATCHES, SYM_TRAIN_WARMUP = 256, 6, 3
SYM_TRAIN_OPT = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
SYM_CLASSES = 1000
# 9b's one-layer check of MXNet's moving-statistics blend against an f64
# recomputation from the batch statistics the forward saw
SYM_BN_TOL = 1e-5
# 9b's witness, each step again in plain PyTorch from the Module's weights:
# its loss within SYM_WITNESS_LOSS (relative) of the Module's; where the
# two steps' new weights differ, the difference against the step's move,
# over all weights and over each tensor, within SYM_WITNESS_MOVE and
# SYM_WITNESS_TENSOR.  One f32 step of ResNet-50 at batch 256 moves
# BatchNorm's beta and gamma by sums with deep cancellation: on an H100,
# plain PyTorch in f32 and in f64 land 0.0233 of the first step's move
# apart overall and 0.0280 of a tensor's (a gamma), and the Module is as
# far from either (tools/sgd_step_rounding.py).  Six free-running steps
# in f32 and in f64 end 0.108 apart, so the witness reruns each step from
# the Module's weights
SYM_WITNESS_LOSS, SYM_WITNESS_MOVE, SYM_WITNESS_TENSOR = 1e-4, 0.1, 0.25
# 9c: bench_transformer.py's attention width, bf16
SYM_ATTN = dict(batch=8, seq=1024, d_model=4096, heads=32)
SYM_OP_SPANS = RESNET_OP_SPANS + ("elemwise_add", "sgd_mom_update")
SYM_GROUPS = tuple(
    (g, keys + (("op:elemwise_add",) if g == "relu_add" else ()))
    for g, keys in RESNET_GROUPS if g != "optimizer_update") + (
    ("optimizer_update", ("op:sgd_mom_update",)),)
RESNET_SPECS = {18: (False, (2, 2, 2, 2)), 34: (False, (3, 4, 6, 3)),
                50: (True, (3, 4, 6, 3)), 101: (True, (3, 4, 23, 3)),
                152: (True, (3, 8, 36, 3))}


def _sym_conv_bn(mx, data, num_filter, kernel, stride, pad, name, act=True):
    c = mx.sym.Convolution(data, kernel=kernel, stride=stride, pad=pad,
                           num_filter=num_filter, no_bias=True,
                           name=name + "_conv")
    b = mx.sym.BatchNorm(c, fix_gamma=False, eps=2e-5, momentum=0.9,
                         name=name + "_bn")
    return mx.sym.Activation(b, act_type="relu", name=name + "_relu") \
        if act else b


def _sym_residual_unit(mx, data, num_filter, stride, dim_match, name,
                       bottle_neck):
    if bottle_neck:
        mid = num_filter // 4
        plan = [(mid, (1, 1), (1, 1), (0, 0)),
                (mid, (3, 3), stride, (1, 1)),
                (num_filter, (1, 1), (1, 1), (0, 0))]
    else:
        plan = [(num_filter, (3, 3), stride, (1, 1)),
                (num_filter, (3, 3), (1, 1), (1, 1))]
    x = data
    for i, (f, k, st, pad) in enumerate(plan):
        x = _sym_conv_bn(mx, x, f, k, st, pad, "%s_c%d" % (name, i + 1),
                         act=(i + 1 < len(plan)))
    if dim_match:
        shortcut = data
    else:
        shortcut = _sym_conv_bn(mx, data, num_filter, (1, 1), stride, (0, 0),
                                name + "_sc", act=False)
    return mx.sym.Activation(x + shortcut, act_type="relu",
                             name=name + "_out")


def resnet_symbol(mx, num_classes=1000, num_layers=50, thumbnail=False):
    """example/image-classification/symbols/resnet.py get_symbol over the
    port's ``mx.sym``: ResNet v1 ending in SoftmaxOutput."""
    bottle_neck, units = RESNET_SPECS[num_layers]
    filters = (256, 512, 1024, 2048) if bottle_neck else (64, 128, 256, 512)
    data = mx.sym.var("data")
    if thumbnail:
        x = _sym_conv_bn(mx, data, 64, (3, 3), (1, 1), (1, 1), "stem")
    else:
        x = _sym_conv_bn(mx, data, 64, (7, 7), (2, 2), (3, 3), "stem")
        x = mx.sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="max", name="stem_pool")
    for s, (n_units, f) in enumerate(zip(units, filters)):
        for u in range(n_units):
            stride = (1, 1) if (s == 0 or u > 0) else (2, 2)
            x = _sym_residual_unit(mx, x, f, stride, dim_match=(u > 0),
                                   name="stage%d_unit%d" % (s + 1, u + 1),
                                   bottle_neck=bottle_neck)
    x = mx.sym.Pooling(x, global_pool=True, pool_type="avg", kernel=(7, 7),
                       name="pool_final")
    x = mx.sym.Flatten(x, name="flat")
    x = mx.sym.FullyConnected(x, num_hidden=num_classes, name="fc1")
    return mx.sym.SoftmaxOutput(x, name="softmax")


def symbol_weights(np, sym, shapes, rs):
    """Seeded f32 values for every argument and auxiliary state of ``sym``
    but the inputs in ``shapes``: He-scaled normal weights, BatchNorm's
    gamma, beta and moving statistics drawn away from their init, zero
    biases.  Returns (arg_params, aux_params) of numpy arrays."""
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, aux = {}, {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in shapes:
            continue
        if n.endswith("gamma"):
            args[n] = rs.uniform(0.5, 1.5, s)
        elif n.endswith("beta"):
            args[n] = 0.1 * rs.standard_normal(s)
        elif n.endswith("bias"):
            args[n] = np.zeros(s)
        else:
            args[n] = rs.standard_normal(s) * math.sqrt(
                2.0 / max(1, int(np.prod(s[1:]))))
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        aux[n] = rs.uniform(0.5, 1.5, s) if n.endswith("var") else \
            0.1 * rs.standard_normal(s)
    return ({n: v.astype(np.float32) for n, v in args.items()},
            {n: v.astype(np.float32) for n, v in aux.items()})


def symbolic_parity(mx, card, batch=SYM_PARITY_BATCH, image=RESNET_IMAGE,
                    classes=SYM_CLASSES, layers=50):
    """Phase 9a: the symbolic ResNet's logits (``fc1_output``) on the card
    against the CPU from the same seeded f32 weights, ``simple_bind`` at
    ``batch``, inference, TF32 off (ZOO_REL); the executor's output
    bit-equal to ``sym.eval`` through ``nd`` calls on the card;
    ``infer_shape``/``infer_type`` of the whole graph on meta tensors, no
    device sync and no device memory (timed twice: the first call also
    imports torch's meta kernels)."""
    import numpy as np
    import torch
    rs = np.random.RandomState(SEED + 90)
    sym = resnet_symbol(mx, classes, layers)
    shapes = {"data": (batch, 3, image, image), "softmax_label": (batch,)}
    check(not torch.backends.cuda.matmul.allow_tf32, "9a: TF32 products on")
    torch.cuda.synchronize()
    # the allocator's count of allocations, which a free (a collection of
    # an earlier caller's tensors) does not move
    before = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    infer_s = []
    try:
        for _ in range(2):
            t0 = time.perf_counter()
            arg_shapes, out_shapes, aux_shapes = sym.infer_shape(**shapes)
            arg_types, out_types, _ = sym.infer_type(data="float32")
            infer_s.append(time.perf_counter() - t0)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    check(torch.cuda.memory_stats().get("allocation.all.allocated", 0) ==
          before, "9a: shape inference allocated device memory")
    check(out_shapes == [(batch, classes)] and
          all(str(t) == "float32" for t in arg_types + out_types),
          "9a: inferred %s %s" % (out_shapes, out_types))
    args, aux = symbol_weights(np, sym, shapes, rs)
    x = rs.uniform(-1, 1, shapes["data"]).astype(np.float32)
    logits = sym.get_internals()["fc1_output"]
    outs = {}
    for key, ctx in (("cpu", mx.cpu()), ("gpu", mx.gpu(0))):
        ex = logits.simple_bind(ctx=ctx, grad_req="null",
                                data=shapes["data"])
        ex.copy_params_from(args, aux)
        outs[key] = ex.forward(is_train=False, data=x)[0]
    got = outs["gpu"].asnumpy()
    values = {n: mx.nd.array(v, ctx=mx.gpu(0))
              for n, v in list(args.items()) + list(aux.items())}
    values["data"] = mx.nd.array(x, ctx=mx.gpu(0))
    with mx.autograd.predict_mode():
        eager = logits.eval(ctx=mx.gpu(0), **values)[0].asnumpy()
    err = _rel_l2(np, got, outs["cpu"].asnumpy())
    same = bool(np.array_equal(got, eager))
    out = dict(nodes=len(sym._topo()), arguments=len(arg_shapes),
               aux_states=len(aux_shapes), infer_s=infer_s, rel_l2=err,
               executor_vs_eval_bit_equal=same)
    print("sym 9a: symbolic resnet%d_v1 (classes=%d, %d nodes, %d arguments, "
          "%d auxiliary states): infer_shape and infer_type on meta in "
          "%.3f s, then %.3f s (no device sync, no device memory); "
          "simple_bind batch %d x 3x%dx%d f32 inference, card vs CPU logits "
          "relative L2 %.3e "
          "(bound %.0e); executor bit-equal to sym.eval through nd %s | %s"
          % (layers, classes, out["nodes"], len(arg_shapes), len(aux_shapes),
             infer_s[0], infer_s[1], batch, image, image, err, ZOO_REL, same,
             card), flush=True)
    check(np.isfinite(got).all() and 0 < err <= ZOO_REL,
          "9a: card vs CPU relative L2 %.3e" % err)
    check(same, "9a: the executor's output differs from sym.eval's")
    return out


def _bn_blend_error(mx, np, mod, batch, layer, before):
    """One more training forward of ``batch``: (the largest difference,
    relative to the largest value, between ``layer``'s moving statistics
    after it and MXNet's blend, recomputed in f64 from ``before`` and the
    batch statistics of the layer's input that forward saw, read through
    the monitor tap; the forward's outputs on the host)."""
    seen = {}
    exe = mod._exec_group.execs[0]
    conv = layer[:-len("_bn")] + "_conv_output0"
    exe.set_monitor_callback(lambda name, arr: seen.update(
        {name: arr.asnumpy().astype(np.float64)}) if name == conv else None)
    mod.forward(batch, is_train=True)
    exe.set_monitor_callback(None)
    x = seen[conv]
    mean = x.mean(axis=(0, 2, 3))
    var = x.var(axis=(0, 2, 3))
    m = 0.9
    worst = 0.0
    for key, b in (("moving_mean", mean), ("moving_var", var)):
        want = m * before[key] + (1 - m) * b
        got = exe.aux_dict["%s_%s" % (layer, key)].asnumpy().astype(
            np.float64)
        worst = max(worst, float(np.abs(got - want).max() /
                                 max(np.abs(want).max(), 1e-30)))
    return worst, mod.get_outputs()[0].asnumpy()


def _plain_attr(attrs, key, default):
    """One attribute of a node in a Symbol's JSON: a bool, an int tuple
    ("(3, 3)" or "[3, 3]") or a number."""
    v = attrs.get(key)
    if v is None:
        return default
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    if v[:1] in "([":
        return tuple(int(d) for d in v.strip("()[]").split(",") if d.strip())
    return float(v)


def plain_symbol_forward(torch, sym_json):
    """9b's witness: the graph of ``sym_json`` (Convolution, BatchNorm in
    training mode, relu, the sum of two, Pooling, Flatten, FullyConnected,
    SoftmaxOutput) in plain PyTorch (torch.nn.functional), nothing of the
    port.  Returns ``forward(weights, data)`` -> the logits."""
    import torch.nn.functional as F
    graph = json.loads(sym_json)
    nodes, head = graph["nodes"], graph["heads"][0]

    def forward(w, x):
        vals = []
        for node in nodes:
            op, a = node["op"], node.get("attrs", {})
            ins = [vals[i] for i, _j, *_ in node["inputs"]]
            if op == "null":
                out = x if node["name"] == "data" else w.get(node["name"])
            elif op == "Convolution":
                out = F.conv2d(ins[0], ins[1], None if _plain_attr(
                    a, "no_bias", False) else ins[2],
                    stride=_plain_attr(a, "stride", 1),
                    padding=_plain_attr(a, "pad", 0))
            elif op == "BatchNorm":
                gamma = torch.ones_like(ins[1]) if _plain_attr(
                    a, "fix_gamma", True) else ins[1]
                out = F.batch_norm(ins[0], None, None, gamma, ins[2],
                                   training=True,
                                   eps=_plain_attr(a, "eps", 1e-3))
            elif op == "Activation" and a["act_type"] == "relu":
                out = F.relu(ins[0])
            elif op in ("elemwise_add", "broadcast_add"):
                out = ins[0] + ins[1]
            elif op == "Pooling" and _plain_attr(a, "global_pool", False):
                out = ins[0].mean(dim=(2, 3), keepdim=True)
            elif op == "Pooling" and a["pool_type"] == "max":
                out = F.max_pool2d(ins[0], _plain_attr(a, "kernel", None),
                                   _plain_attr(a, "stride", 1),
                                   _plain_attr(a, "pad", 0))
            elif op == "Flatten":
                out = ins[0].flatten(1)
            elif op == "FullyConnected":
                out = F.linear(ins[0], ins[1], None if _plain_attr(
                    a, "no_bias", False) else ins[2])
            elif op == "SoftmaxOutput":
                out = ins[0]            # the logits; the loss takes labels
            else:
                raise ValueError("plain_symbol_forward: no plain version "
                                 "of %s" % op)
            vals.append(out)
        return vals[head[0]]

    return forward


def plain_sgd_step(torch, forward, w, prev, x, y, opt):
    """One training step of the witness from the weights ``w`` (name ->
    tensor), whose momentum is ``w - prev`` (the last step's move; ``prev``
    is ``w`` at the first step): the softmax cross-entropy's gradient
    through autograd, then sgd with momentum written out, g = grad/batch +
    wd·w, mom = momentum·mom - lr·g, w + mom.  wd applies to the names that
    end in ``_weight`` or ``_gamma`` only, MXNet's rule under Module (its
    optimizer knows the names: biases and BatchNorm's beta get wd 0).
    Returns (the step's softmax probabilities on the host, the new
    weights)."""
    import torch.nn.functional as F
    lr, momentum = opt["learning_rate"], opt["momentum"]
    wds = {n: opt["wd"] if n.endswith(("_weight", "_gamma")) else 0.0
           for n in w}
    leaves = {n: v.detach().requires_grad_() for n, v in w.items()}
    logits = forward(leaves, x)
    grads = torch.autograd.grad(F.cross_entropy(logits, y, reduction="sum"),
                                list(leaves.values()))
    probs = torch.softmax(logits.detach(), 1).cpu().numpy()
    del logits
    with torch.no_grad():
        new = {n: v + (momentum * (v - prev[n]) -
                       lr * (g * (1.0 / x.shape[0]) + wds[n] * v))
               for (n, v), g in zip(w.items(), grads)}
    return probs, new


def symbolic_train(mx, card, batch=SYM_TRAIN_BATCH,
                   batches=SYM_TRAIN_BATCHES, warmup=SYM_TRAIN_WARMUP,
                   image=RESNET_IMAGE, classes=SYM_CLASSES, layers=50,
                   profile=True):
    """Phase 9b: Module.fit of the symbolic ResNet at ``batch`` x
    3x``image``x``image`` f32: sgd (lr 0.05, momentum 0.9, wd 1e-4),
    Xavier(magnitude=2), eval_metric "acc", over ``batches`` NDArrayIter
    batches made as train_imagenet.py's synthetic_iters makes them (the
    class signal at pixel 0).  Step ms after ``warmup`` steps, img/s, MFU,
    peak memory, one step profiled by group (a step's time leaves out
    the callback that reads its loss and keeps its weights); a witness:
    each step run again in plain PyTorch (``plain_symbol_forward``,
    ``plain_sgd_step``) from the Module's weights before it, whose loss and
    new weights must match the Module's (each step's batch is new and its
    labels random, so the steps' own losses need not fall: the witness
    shows that they are what these steps give); the loss must fall: the
    training loss of the epoch's first batch, taken again after the epoch,
    below the first step's; one BatchNorm layer's
    moving statistics held to MXNet's blend; then
    save_checkpoint, Module.load, score: the same accuracy and the same
    logits, bit for bit.  Returns (result, the trained module, its data)."""
    import numpy as np
    import tempfile
    import torch
    t0 = time.perf_counter()
    rs = np.random.RandomState(3)
    n = batch * batches
    y = (rs.rand(n) * classes).astype(np.int64)
    x = rs.rand(n, 3, image, image).astype(np.float32)
    x[np.arange(n), 0, 0, 0] = y / float(classes)
    np.random.seed(SEED)
    mx.random.seed(SEED)
    with mx.gpu(0):
        train = mx.io.NDArrayIter(x, y.astype(np.float32), batch,
                                  shuffle=True, label_name="softmax_label")
    del x
    sym = resnet_symbol(mx, classes, layers)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    # bound and initialized here so that the witness has the weights
    # before the first step; fit's own bind and init_params then leave them
    mod.bind(train.provide_data, train.provide_label)
    mod.init_params(initializer=mx.init.Xavier(magnitude=2.0))
    exe = mod._exec_group.execs[0]
    names = mod._exec_group.param_names

    def weights_now():
        return {n: exe.arg_dict[n]._data.detach().clone() for n in names}
    weights, starts, stamps, losses = [weights_now()], [], [], []

    def xent(p, lab):
        return float(-np.log(np.maximum(
            p[np.arange(len(lab)), lab.astype(np.int64)], 1e-30)).mean())

    def batch_end(param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if param.nbatch == warmup - 1:
            torch.cuda.reset_peak_memory_stats()
        losses.append(xent(mod.get_outputs()[0].asnumpy(),
                           train_labels[param.nbatch]))
        weights.append(weights_now())
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
    train_batches = [(b.data[0]._data.clone(), b.label[0]._data.long())
                     for b in train]
    train_labels = [lab.cpu().numpy() for _x, lab in train_batches]
    train.reset()
    torch.cuda.synchronize()
    t_fit = time.perf_counter()
    with conv_flops() as flop:
        mod.fit(train, num_epoch=1, optimizer="sgd",
                optimizer_params=dict(SYM_TRAIN_OPT), kvstore="local",
                initializer=mx.init.Xavier(magnitude=2.0), eval_metric="acc",
                batch_end_callback=batch_end)
    peak = torch.cuda.max_memory_allocated()
    step_ms = [(b - a) * 1e3 for a, b in zip([t_fit] + starts, stamps)]
    timed = step_ms[warmup:]
    mean = sum(timed) / len(timed)
    std = (sum((v - mean) ** 2 for v in timed) / len(timed)) ** 0.5
    # conv_flops saw every forward of the fit: one a step
    fwd_flop = flop[0] / batches
    step_flop = 3 * fwd_flop
    res = dict(step_ms=step_ms, step_ms_mean=mean, step_ms_std=std,
               img_per_s=batch / mean * 1e3, flop_per_step=step_flop,
               mfu=step_flop / (mean / 1e3) / H100_BF16_FLOPS,
               peak_memory_bytes=peak, losses=losses,
               fit_s=time.perf_counter() - t_fit)
    for i, (ms, loss) in enumerate(zip(step_ms, losses)):
        print("sym 9b: step %d%s: %.3f ms, loss %.6f | %s"
              % (i, " (warm-up)" if i < warmup else "", ms, loss, card))
    print("sym 9b: Module.fit of the symbolic resnet%d_v1 (classes=%d), sgd "
          "%s, Xavier(magnitude=2), batch %d x 3x%dx%d f32: %d timed steps "
          "after %d, mean %.3f ms (std %.3f), %.1f img/s, MFU %.4f (%.4e "
          "conv and dense flop a step, 3x the forward's, over 989 TFLOP/s), "
          "peak memory allocated %d bytes | %s"
          % (layers, classes, SYM_TRAIN_OPT, batch, image, image, len(timed),
             warmup, mean, std, res["img_per_s"], res["mfu"], step_flop,
             peak, card), flush=True)
    check(all(math.isfinite(v) for v in losses), "9b: a loss is not finite")
    # the witness: each step again in plain PyTorch from the Module's
    # weights before it; its loss must be the Module's, and its new weights
    # the Module's to within f32 rounding of the step's move
    t1 = time.perf_counter()
    forward = plain_symbol_forward(torch, sym.tojson())
    plain, moves, worst = [], [], (0.0, "")
    for i, (xb, yb) in enumerate(train_batches):
        probs, new = plain_sgd_step(torch, forward, weights[i],
                                    weights[max(i - 1, 0)], xb, yb,
                                    SYM_TRAIN_OPT)
        plain.append(xent(probs, train_labels[i]))
        gap2 = move2 = 0.0
        for n, v in new.items():
            g = float(((weights[i + 1][n] - v) ** 2).sum())
            m = float(((v - weights[i][n]) ** 2).sum())
            gap2, move2 = gap2 + g, move2 + m
            worst = max(worst, (math.sqrt(g / max(m, 1e-30)),
                                "step %d %s" % (i, n)))
        moves.append(math.sqrt(gap2 / move2))
        del new
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
    res.update(plain_losses=plain, plain_loss_rel_err=loss_err,
               plain_gap_of_move=moves, plain_worst_tensor=list(worst),
               plain_s=time.perf_counter() - t1)
    print("sym 9b: witness, each step again in plain PyTorch (F.conv2d, "
          "F.batch_norm, autograd, sgd with momentum written out) from the "
          "Module's weights before it: losses %s against the Module's %s, "
          "largest relative difference %.3e (bound %.0e); new weights apart "
          "by %s of the step's move (bound %.2f), at most %.3e of a "
          "tensor's (%s; bound %.2f); %.1f s | %s"
          % (["%.6f" % v for v in plain], ["%.6f" % v for v in losses],
             loss_err, SYM_WITNESS_LOSS, ["%.3e" % v for v in moves],
             SYM_WITNESS_MOVE, worst[0], worst[1], SYM_WITNESS_TENSOR,
             res["plain_s"], card), flush=True)
    check(loss_err <= SYM_WITNESS_LOSS and max(moves) <= SYM_WITNESS_MOVE
          and worst[0] <= SYM_WITNESS_TENSOR, "9b: the Module's steps "
          "differ from plain PyTorch's: losses %.3e apart, weights %.3e of "
          "the move, %.3e of %s's" % (loss_err, max(moves), worst[0],
                                      worst[1]))
    del weights, train_batches, forward
    gc.collect()
    torch.cuda.empty_cache()
    # MXNet's blend of the moving statistics, on one layer, in f64, in one
    # more training forward of the first batch, which also gives its loss
    layer = "stage1_unit1_c1_bn"
    before = {k: exe.aux_dict["%s_%s" % (layer, k)].asnumpy().astype(
        np.float64) for k in ("moving_mean", "moving_var")}
    moved = max(float(np.abs(v).max()) for v in before.values())
    train.reset()
    blend, probs = _bn_blend_error(mx, np, mod, next(train), layer, before)
    first_after = xent(probs, train_labels[0])
    res.update(bn_blend_rel_err=blend, first_batch_loss=[losses[0],
                                                         first_after])
    print("sym 9b: the first batch's training loss %.6f at step 0, %.6f "
          "after the epoch | %s" % (losses[0], first_after, card), flush=True)
    check(math.isfinite(first_after) and first_after < losses[0],
          "9b: the loss did not fall: the first batch's %.6f, then %.6f"
          % (losses[0], first_after))
    print("sym 9b: %s moving statistics after a training forward vs "
          "m·moving + (1-m)·batch in f64: relative error %.3e (bound %.0e); "
          "after the epoch they hold values up to %.4f | %s"
          % (layer, blend, SYM_BN_TOL, moved, card), flush=True)
    check(blend <= SYM_BN_TOL and moved > 0, "9b: BatchNorm's moving "
          "statistics are not MXNet's blend (%.3e)" % blend)
    if profile:
        first = next(iter(train))

        def step():
            mod.forward_backward(first)
            mod.update()
        res["profile"] = resnet_profile(
            step, "9b one Module training step", card, spans=SYM_OP_SPANS,
            groups=SYM_GROUPS)
    # checkpoint round trip
    d = tempfile.mkdtemp()
    try:
        prefix = os.path.join(d, "resnet")
        t1 = time.perf_counter()
        mod.save_checkpoint(prefix, 1)
        save_s = time.perf_counter() - t1
        fresh = mx.mod.Module.load(prefix, 1, context=mx.gpu(0))
        fresh.bind(train.provide_data, train.provide_label,
                   for_training=False)
        acc = [dict(m_.score(train, "acc"))["accuracy"]
               for m_ in (mod, fresh)]
        train.reset()
        one = next(train)
        logits = []
        for m_ in (mod, fresh):
            m_.forward(one, is_train=False)
            logits.append(m_.get_outputs()[0].asnumpy())
    finally:
        shutil.rmtree(d)
    same = bool(np.array_equal(logits[0], logits[1]))
    res.update(checkpoint_save_s=save_s, score_acc=acc,
               checkpoint_logits_bit_equal=same)
    print("sym 9b: save_checkpoint in %.3f s, Module.load into a fresh "
          "Module: score accuracy %.6f vs %.6f, one batch's outputs "
          "bit-equal %s | %s" % (save_s, acc[0], acc[1], same, card),
          flush=True)
    check(acc[0] == acc[1] and same, "9b: the loaded module differs")
    res["seconds"] = time.perf_counter() - t0
    return res, mod, train


def attention_symbol(mx, d_model, heads):
    """The LM's attention layer as a Symbol: q/k/v FullyConnected
    (flatten=False, no bias) reshaped to (B, S, H, D) and transposed to
    (B, H, S, D), causal flash attention, transposed back, the output
    FullyConnected, and MakeLoss of the sum."""
    x = mx.sym.var("data")
    qkv = []
    for n in ("q", "k", "v"):
        p = mx.sym.FullyConnected(x, num_hidden=d_model, flatten=False,
                                  no_bias=True, name=n)
        p = mx.sym.Reshape(p, shape=(0, 0, heads, -1))
        qkv.append(mx.sym.transpose(p, axes=(0, 2, 1, 3)))
    a = mx.sym.contrib.FlashAttention(*qkv, causal=True, name="attn")
    a = mx.sym.Reshape(mx.sym.transpose(a, axes=(0, 2, 1, 3)),
                       shape=(0, 0, -1))
    o = mx.sym.FullyConnected(a, num_hidden=d_model, flatten=False,
                              no_bias=True, name="o")
    return mx.sym.MakeLoss(mx.sym.sum(o), name="loss")


def attention_eager(mx, values, d_model, heads, copies=None):
    """The same ops as :func:`attention_symbol`, called through ``nd`` under
    ``autograd.record()``: (loss, {name: gradient}); ``copies`` receives
    the arrays the ops took."""
    nd = mx.nd
    arrays = {n: v.copy() for n, v in values.items()}
    if copies is not None:
        copies.update(arrays)
    for v in arrays.values():
        v.attach_grad()
    with mx.autograd.record():
        qkv = []
        for n in ("q", "k", "v"):
            p = nd.FullyConnected(arrays["data"], arrays[n + "_weight"],
                                  num_hidden=d_model, flatten=False,
                                  no_bias=True)
            p = nd.Reshape(p, shape=(0, 0, heads, -1))
            qkv.append(nd.transpose(p, axes=(0, 2, 1, 3)))
        a = nd.contrib.FlashAttention(*qkv, causal=True)
        a = nd.Reshape(nd.transpose(a, axes=(0, 2, 1, 3)), shape=(0, 0, -1))
        o = nd.FullyConnected(a, arrays["o_weight"], num_hidden=d_model,
                              flatten=False, no_bias=True)
        loss = nd.MakeLoss(nd.sum(o))
    loss.backward()
    return loss, {n: v.grad for n, v in arrays.items()}


def symbolic_attention(mx, card, batch=SYM_ATTN["batch"],
                       seq=SYM_ATTN["seq"], d_model=SYM_ATTN["d_model"],
                       heads=SYM_ATTN["heads"], reps=5):
    """Phase 9c: the LM's attention layer as a Symbol, bf16,
    ``simple_bind(type_dict=bfloat16)``, one forward and backward through
    the Executor with the flash counters zeroed just before and read just
    after, held bit for bit (output and every gradient) against the same
    ops run eagerly under ``autograd.record()``; then ``reps`` timed
    forward+backward."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch.ops.attention import flash_attention
    rs = np.random.RandomState(SEED + 91)
    sym = attention_symbol(mx, d_model, heads)
    names = sym.list_arguments()
    ex = sym.simple_bind(ctx=mx.gpu(0), grad_req="write",
                         type_dict={n: "bfloat16" for n in names},
                         data=(batch, seq, d_model))
    values = {}
    for n in names:
        shape = ex.arg_dict[n].shape
        scale = 1.0 if n == "data" else 1.0 / math.sqrt(shape[-1])
        values[n] = mx.nd.array((rs.standard_normal(shape) * scale).astype(
            np.float32), ctx=mx.gpu(0), dtype="bfloat16")
    ex.copy_params_from(values)
    counters = ("launches", "backward_kernel_launches", "backward_torch_calls")
    for c in counters:
        setattr(flash_attention, c, 0)
    out = ex.forward(is_train=True)[0]
    ex.backward()
    torch.cuda.synchronize()
    launches = {c: getattr(flash_attention, c) for c in counters}
    loss, grads = attention_eager(mx, values, d_model, heads)
    same = {"loss": bool(np.array_equal(out.asnumpy(), loss.asnumpy()))}
    for n in names:
        same[n] = bool(torch.equal(ex.grad_dict[n]._data, grads[n]._data))
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.forward(is_train=True)
        ex.backward()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    mean = sum(times) / len(times)
    res = dict(launches=launches, bit_equal=same, fwd_bwd_ms=times,
               fwd_bwd_ms_mean=mean, shape=[batch, seq, d_model, heads])
    print("sym 9c: the LM's attention layer as a Symbol (batch %d x %d, "
          "d_model %d, %d heads, D = %d, bf16) through Executor.forward/"
          "backward: flash counters %s; output and gradients bit-equal to "
          "eager %s; forward+backward %s ms (mean %.3f) | %s"
          % (batch, seq, d_model, heads, d_model // heads,
             json.dumps(launches), json.dumps(same),
             ["%.3f" % t for t in times], mean, card), flush=True)
    check(launches["launches"] == 1 and
          launches["backward_kernel_launches"] == 1 and
          launches["backward_torch_calls"] == 0,
          "9c: flash counters %s (want 1, 1, 0)" % launches)
    check(all(same.values()), "9c: the executor differs from eager: %s"
          % same)
    return res


def symbolic_serve(mx, mod, train, card, requests=SERVER_REQUESTS,
                   clients=SERVER_CLIENTS, max_batch=SERVER_MAX_BATCH):
    """Phase 9d: the trained 9b module behind ``mx.serving.Server(max_batch
    =8)`` through ``srv.load(..., module=mod)``: each bucket's program
    captured by ``warmup`` (its seconds), then one-image requests from
    ``clients`` threads; every row bit-equal to the bucket-1 program and
    within ZOO_REL of ``Module.predict``; p50/p99."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch import serving
    from incubator_mxnet_tpu_torch.serving.batcher import host_rows
    dev = mx.gpu(0).torch_device()
    train.reset()
    images = next(train).data[0].asnumpy()[:requests]
    predicted = mod.predict(mx.nd.array(images, ctx=mx.gpu(0))).asnumpy()
    srv = serving.Server(max_batch=max_batch, max_wait_ms=5)
    try:
        t0 = time.perf_counter()
        h = srv.load("resnet_sym", module=mod)
        load_s = time.perf_counter() - t0
        capture_s = {}
        b = 1
        while b <= max_batch:
            t0 = time.perf_counter()
            srv.warmup("resnet_sym", images[0], buckets=[b])
            capture_s[b] = time.perf_counter() - t0
            b *= 2
        results, walls, errors = [None] * len(images), [None] * len(images), []

        def client(k):
            try:
                for i in range(k, len(images), clients):
                    t1 = time.perf_counter()
                    results[i] = srv.predict("resnet_sym", images[i])
                    walls[i] = (time.perf_counter() - t1) * 1e3
            except Exception as exc:       # reported below, then failed
                errors.append(repr(exc))
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        check(not errors, "9d: a Server request failed: %s" % errors[:2])
        _e, params, _v = srv.registry.acquire("resnet_sym")
        prog = h.jit_for(1)
        same = 0
        for img, row in zip(images, results):
            want = host_rows(prog(params, torch.from_numpy(
                np.ascontiguousarray(img[None])).to(dev)))[0]
            same += np.asarray(row).tobytes() == want.tobytes()
        err = _rel_l2(np, np.stack([np.asarray(r) for r in results]),
                      predicted)
        captures = h.captures
    finally:
        srv.close()
    ordered = sorted(walls)
    p50 = ordered[len(ordered) // 2]
    p99 = ordered[min(len(ordered) - 1, int(math.ceil(0.99 * len(ordered)))
                  - 1)]
    res = dict(load_s=load_s, capture_s=capture_s, wall_s=wall,
               requests=len(images), bit_equal_rows=same, captures=captures,
               vs_predict_rel_l2=err, p50_ms=p50, p99_ms=p99)
    print("sym 9d: Server(max_batch=%d) serving the trained symbolic module "
          "(srv.load(module=)): load %.3f s, warmup (capture) seconds by "
          "bucket %s; %d one-image requests from %d client threads in %.3f "
          "s, p50 %.3f ms, p99 %.3f ms, %d programs captured; %d of %d rows "
          "bit-equal to the bucket-1 program; vs Module.predict relative L2 "
          "%.3e (bound %.0e) | %s"
          % (max_batch, load_s, json.dumps({k: round(v, 3) for k, v in
                                            capture_s.items()}),
             len(images), clients, wall, p50, p99, captures, same,
             len(images), err, ZOO_REL, card), flush=True)
    check(same == len(images), "9d: %d of %d served rows differ from the "
          "bucket-1 program" % (len(images) - same, len(images)))
    check(err <= ZOO_REL, "9d: served rows vs Module.predict %.3e" % err)
    return res


def symbolic_phase(mx, card):
    """Phase 9: 9a, 9b, 9c and 9d, in that order."""
    import torch
    t0 = time.perf_counter()
    out = dict(parity=symbolic_parity(mx, card))
    out["train"], mod, train = symbolic_train(mx, card)
    out["serve"] = symbolic_serve(mx, mod, train, card)
    del mod, train
    gc.collect()
    torch.cuda.empty_cache()
    out["attention"] = symbolic_attention(mx, card)
    out["seconds"] = time.perf_counter() - t0
    print("sym: phase 9 in %.1f s | %s" % (out["seconds"], card), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 10: the single-card KVStore; BASELINE configs 1 and 2 through the
# wiring of example/image-classification/common.py; the full-width LM
# through a store-backed gluon.Trainer; the profiler on the card
# ---------------------------------------------------------------------------
KV_SHAPE = (1024, 4096)
KV_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
          "rescale_grad": 1.0 / 64}
# common.py add_fit_args's defaults with train_mnist.py's batch
FIT_ARGS = dict(batch_size=64, num_epochs=2, lr=0.05, momentum=0.9,
                wd=1e-4, optimizer="sgd", kv_store="device", disp_batches=20)
MNIST_SYNTH = 640           # 576 training images (9 batches), 64 to score
# train_imagenet.py on synthetic_iters: ResNet-50 v1, f32, batch 256, one
# epoch of 4 batches (the fifth scores)
IMAGENET_ARGS = dict(FIT_ARGS, batch_size=256, num_epochs=1,
                     num_classes=1000, num_batches=5)
IMAGENET_SHAPE = (3, 224, 224)
# the steps they are set beside (PERF.md, NVIDIA H100 80GB HBM3, 700.00 W):
# 6c's ResNet-50 bf16 step and 9b's symbolic f32 Module step
PHASE_6C_MS, PHASE_9B_MS = 197.964, 361.084
LM_STORE_STEPS = 3
LM_STORE_OPT = {"learning_rate": 0.05, "momentum": 0.9,
                "multi_precision": True}
FLASH_KERNELS = {"flash_fwd_sm90_kernel": "_contrib_FlashAttention",
                 "flash_bwd_dq_kernel": "_backward__contrib_FlashAttention",
                 "flash_bwd_dkdv_kernel": "_backward__contrib_FlashAttention"}


def kv_on_card(mx, card, shape=None):
    """Phase 10a: ``mx.kv.create("device")`` on the card: ``init`` an f32
    and a bf16 key, ``push`` three arrays, ``pull`` into two outs, each
    bit-equal to the sum in torch in the same order; ``set_optimizer``
    (sgd with momentum): each push one update, bit-equal to
    ``opt.get_updater`` applied by hand; the optimizer's states through a
    file and back, bit-equal; the paths of later items raise."""
    import torch
    from incubator_mxnet_tpu_torch import cuda_build
    from incubator_mxnet_tpu_torch.ndarray import NDArray
    shape = shape or KV_SHAPE
    dev = mx.gpu(0).torch_device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 10)

    def randn(dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    kv = mx.kv.create("device")
    check((kv.type, kv.rank, kv.num_workers) == ("device", 0, 1),
          "10a: store %s rank %d of %d" % (kv.type, kv.rank, kv.num_workers))
    sums = {}
    for key, dtype in (("w32", torch.float32), (7, torch.bfloat16)):
        kv.init(key, NDArray(randn(dtype)))
        vals = [randn(dtype) for _ in range(3)]
        kv.push(key, [NDArray(v) for v in vals])
        outs = [NDArray(torch.empty(shape, dtype=dtype, device=dev))
                for _ in range(2)]
        kv.pull(key, out=outs)
        want = (vals[0] + vals[1]) + vals[2]
        sums[str(key)] = all(torch.equal(o._data, want) for o in outs)
        check(sums[str(key)] and outs[0]._data.dtype == want.dtype,
              "10a: pull of key %r is not the sum of its push" % key)
    # the update on the store, against the updater applied by hand
    opt = mx.optimizer.create("sgd", **KV_OPT)
    kv.init("w", NDArray(randn()))
    by_hand = mx.optimizer.get_updater(mx.optimizer.create("sgd", **KV_OPT))
    w_hand = NDArray(kv._store["w"]._data.clone())
    kv.set_optimizer(opt)
    out = NDArray(torch.empty(shape, device=dev))
    steps = []
    for _ in range(3):
        g = randn()
        kv.push("w", NDArray(g))
        by_hand("w", NDArray(g.clone()), w_hand)
        kv.pull("w", out=out)
        steps.append(torch.equal(out._data, w_hand._data))
    check(all(steps), "10a: the store's updates differ from the updater "
          "by hand: %s" % steps)
    path = cuda_build.BUILD_DIR.parent / ("kv-states-%d" % os.getpid())
    kv.save_optimizer_states(str(path))
    other = mx.kv.create("device")
    other.init("w", NDArray(kv._store["w"]._data.clone()))
    other.set_optimizer(mx.optimizer.create("sgd", **KV_OPT))
    other.load_optimizer_states(str(path))
    path.unlink()
    g = randn()
    kv.push("w", NDArray(g))
    other.push("w", NDArray(g.clone()))
    round_trip = torch.equal(kv._store["w"]._data, other._store["w"]._data)
    check(round_trip, "10a: the optimizer's states did not round-trip")
    raised = {}
    for what, call, item in (
            ("set_gradient_compression", lambda: kv.set_gradient_compression(
                {"type": "2bit"}), "item 12"),):
        try:
            call()
            message = None
        except mx.MXNetError as exc:
            message = str(exc)
        check(message is not None and item in message,
              "10a: %s did not raise naming %s: %r" % (what, item, message))
        raised[what] = item
    print("kv 10a: mx.kv.create('device') on the card, %s f32 and bf16: "
          "push of 3 arrays then pull into 2 outs bit-equal to the sum in "
          "torch %s; set_optimizer(sgd %s): 3 pushes bit-equal to the "
          "updater by hand %s; optimizer states through a file bit-equal %s; "
          "raising MXNetError naming their ROADMAP items: %s | %s"
          % (shape, sums, KV_OPT, steps, round_trip, raised, card),
          flush=True)
    del kv, other
    return dict(sums=sums, updates=steps, states_round_trip=round_trip)


def fit_module(mx, symbol, train_iter, val_iter, args, on_step=None):
    """``example/image-classification/common.py`` ``fit_module`` (:32-52)
    line for line, with the port as ``mx``.  Two additions: an empty
    ``args.kv_store`` trains without a store, and ``on_step(mod)`` runs
    after every batch."""
    kv = mx.kv.create(args.kv_store) if args.kv_store else None
    mod = mx.mod.Module(symbol, context=mx.context.Context.default_ctx())
    batch_end = mx.callback.Speedometer(args.batch_size, args.disp_batches)
    if on_step is not None:
        batch_end = [batch_end, lambda _param: on_step(mod)]
    mod.fit(train_iter,
            eval_data=val_iter,
            num_epoch=args.num_epochs,
            kvstore=kv,
            optimizer=args.optimizer,
            optimizer_params={"learning_rate": args.lr,
                              "momentum": args.momentum, "wd": args.wd},
            initializer=mx.init.Xavier(magnitude=2.0),
            batch_end_callback=batch_end,
            eval_metric="acc")
    score = mod.score(val_iter, "acc")
    for name, val in score:
        logging.info("final validation %s=%f", name, val)
    return dict(score)["accuracy"]


def fit_gluon(mx, net, train_iter, val_iter, args, on_step=None):
    """``common.py`` ``fit_gluon`` (:55-81) line for line, with the port as
    ``mx``; the same two additions (``on_step(net)`` after every
    ``trainer.step``)."""
    kv = mx.kv.create(args.kv_store) if args.kv_store else None
    net.initialize(mx.init.Xavier(magnitude=2.0))
    trainer = mx.gluon.Trainer(net.collect_params(), args.optimizer,
                               {"learning_rate": args.lr,
                                "momentum": args.momentum, "wd": args.wd},
                               kvstore=kv)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    autograd = mx.autograd
    for epoch in range(args.num_epochs):
        train_iter.reset()
        tic = time.time()
        n = 0
        for i, batch in enumerate(train_iter):
            x, y = batch.data[0], batch.label[0]
            if x.dtype == np.uint8:   # raw-record pipeline: cast on use
                x = x.astype("float32")
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(x.shape[0] * max(kv.num_workers if kv else 1, 1))
            if on_step is not None:
                on_step(net)
            n += x.shape[0]
            if args.disp_batches and (i + 1) % args.disp_batches == 0:
                logging.info("epoch %d batch %d speed %.1f samples/s",
                             epoch, i + 1, n / (time.time() - tic))
        logging.info("epoch %d done in %.1fs", epoch, time.time() - tic)
    return evaluate_gluon(net, val_iter)


def evaluate_gluon(net, val_iter):
    """``common.py`` ``evaluate_gluon`` (:84-99) line for line."""
    val_iter.reset()
    correct = total = 0
    for batch in val_iter:
        x = batch.data[0]
        if x.dtype == np.uint8:
            x = x.astype("float32")
        out = net(x).asnumpy()
        y = batch.label[0].asnumpy()
        keep = len(y) - batch.pad
        correct += (out.argmax(1)[:keep] == y[:keep]).sum()
        total += keep
    acc = correct / max(total, 1)
    logging.info("final validation accuracy=%f", acc)
    return acc


def synthetic_mnist(n_synth, seed=SEED):
    """train_mnist.py ``load_mnist``'s synthetic stand-in (:63-75): ten
    class templates plus noise, MNIST's shapes, from ``seed``."""
    rs = np.random.RandomState(seed)
    templates = rs.rand(10, 1, 28, 28).astype(np.float32)
    y = (rs.rand(n_synth) * 10).astype(np.int64)
    x = templates[y] + 0.25 * rs.randn(n_synth, 1, 28, 28).astype(np.float32)
    x = np.clip(x, 0.0, 1.0)
    cut = int(n_synth * 0.9)
    return (x[:cut], y[:cut].astype(np.float32),
            x[cut:], y[cut:].astype(np.float32))


def mnist_nets(mx):
    """train_mnist.py's four nets (:78-119) over the port: (name, fit,
    builder)."""
    sym, nn = mx.sym, mx.gluon.nn

    def mlp_symbol():
        data = sym.Variable("data")
        net = sym.FullyConnected(data, num_hidden=128, name="fc1")
        net = sym.Activation(net, act_type="relu")
        net = sym.FullyConnected(net, num_hidden=64, name="fc2")
        net = sym.Activation(net, act_type="relu")
        net = sym.FullyConnected(net, num_hidden=10, name="fc3")
        return sym.SoftmaxOutput(net, name="softmax")

    def lenet_symbol():
        data = sym.Variable("data")
        net = sym.Convolution(data, kernel=(5, 5), num_filter=20)
        net = sym.Activation(net, act_type="tanh")
        net = sym.Pooling(net, pool_type="max", kernel=(2, 2), stride=(2, 2))
        net = sym.Convolution(net, kernel=(5, 5), num_filter=50)
        net = sym.Activation(net, act_type="tanh")
        net = sym.Pooling(net, pool_type="max", kernel=(2, 2), stride=(2, 2))
        net = sym.Flatten(net)
        net = sym.FullyConnected(net, num_hidden=500)
        net = sym.Activation(net, act_type="tanh")
        net = sym.FullyConnected(net, num_hidden=10)
        return sym.SoftmaxOutput(net, name="softmax")

    def mlp_gluon():
        net = nn.HybridSequential()
        net.add(nn.Flatten(), nn.Dense(128, activation="relu"),
                nn.Dense(64, activation="relu"), nn.Dense(10))
        return net

    def lenet_gluon():
        net = nn.HybridSequential()
        net.add(nn.Conv2D(20, kernel_size=5, activation="tanh"),
                nn.MaxPool2D(pool_size=2, strides=2),
                nn.Conv2D(50, kernel_size=5, activation="tanh"),
                nn.MaxPool2D(pool_size=2, strides=2),
                nn.Flatten(), nn.Dense(500, activation="tanh"),
                nn.Dense(10))
        return net

    return (("mlp Module", fit_module, mlp_symbol),
            ("lenet Module", fit_module, lenet_symbol),
            ("mlp Gluon", fit_gluon, mlp_gluon),
            ("lenet Gluon", fit_gluon, lenet_gluon))


class StepTrail(object):
    """``on_step`` of the fit copies: the card's copy of every weight (and
    auxiliary state) after each step, each step's ms by the host clock to
    ``synchronize`` (the copying left out), and, given the trail of a first
    run, whether each step's weights equal that run's bit for bit."""

    def __init__(self, torch, against=None):
        self.torch = torch
        self.against = against
        self.weights, self.equal, self.ms = [], [], []
        self._t = None

    def start(self):
        self.torch.cuda.synchronize()
        self._t = time.perf_counter()

    def __call__(self, model):
        torch = self.torch
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - self._t) * 1e3)
        if hasattr(model, "_exec_group"):
            group = model._exec_group
            arrays = [a for arrs in group.param_arrays + group.aux_arrays
                      for a in arrs]
        else:
            arrays = [p.data() for p in model.collect_params().values()]
        ws = [a._data.detach().clone() for a in arrays]
        if self.against is None:
            self.weights.append(ws)
        else:
            want = self.against.weights[len(self.equal)]
            self.equal.append(len(ws) == len(want) and all(
                torch.equal(a, b) for a, b in zip(ws, want)))
        self._t = time.perf_counter()


@contextlib.contextmanager
def deterministic_kernels(torch):
    """torch's deterministic algorithms inside (cuDNN's convolutions among
    them): two runs of the same steps then give the same bits.  Without
    them cuDNN's backward may add in another order from one run to the
    next (phase 7b)."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.backends.cudnn.deterministic,
              os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0])
        torch.backends.cudnn.deterministic = before[1]
        if before[2] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


def store_pair(mx, what, fit, build, make_iters, args, card):
    """``fit`` of ``build()`` with ``args.kv_store`` (a store), timed; then,
    with torch's deterministic algorithms, again with the store and
    without one, both from the same seeds: every step's weights
    bit-equal.  Returns the timed run's accuracy, step ms, img/s and peak
    memory, and the deterministic pair's step ms."""
    import torch
    from types import SimpleNamespace
    runs = []
    for kv_store, exact in ((args["kv_store"], False),
                            (args["kv_store"], True), (None, True)):
        mx.random.seed(SEED)
        np.random.seed(SEED)
        train_iter, val_iter = make_iters()
        trail = StepTrail(torch, runs[1][1] if kv_store is None else None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with deterministic_kernels(torch) if exact else \
                contextlib.nullcontext():
            trail.start()
            acc = fit(mx, build(), train_iter, val_iter,
                      SimpleNamespace(**dict(args, kv_store=kv_store)),
                      on_step=trail)
        wall = time.perf_counter() - t0
        runs.append((acc, trail, torch.cuda.max_memory_allocated(), wall))
        del train_iter, val_iter
        gc.collect()
        torch.cuda.empty_cache()
    (acc, timed, peak, wall), (acc1, store, _, _), (acc0, plain, _, _) = runs

    def steady(ms):
        return sum(ms[1:]) / max(len(ms) - 1, 1)

    mean = steady(timed.ms)
    result = dict(accuracy=float(acc), steps=len(timed.ms),
                  step_ms=timed.ms, step_ms_mean=mean,
                  img_per_s=args["batch_size"] / mean * 1e3,
                  peak_memory_bytes=peak, seconds=wall,
                  deterministic_step_ms_mean=steady(store.ms),
                  deterministic_no_store_step_ms_mean=steady(plain.ms),
                  deterministic_accuracy=(float(acc1), float(acc0)),
                  equal_steps=sum(plain.equal))
    print("fit %s: kvstore %r, %d steps (batch %d, lr %s, momentum %s, wd "
          "%s): step ms %s (mean after the first %.3f, %.1f img/s), final "
          "accuracy %.4f, peak memory allocated %d bytes, %.1f s; with "
          "torch's deterministic algorithms, with the store and without: "
          "weights bit-equal after %d of %d steps, mean step %.3f and %.3f "
          "ms (the store's copy, push and pull: %+.3f ms a step), accuracy "
          "%.4f and %.4f | %s"
          % (what, args["kv_store"], len(timed.ms), args["batch_size"],
             args["lr"], args["momentum"], args["wd"],
             ["%.3f" % v for v in timed.ms], mean, result["img_per_s"], acc,
             peak, wall, sum(plain.equal), len(plain.equal),
             steady(store.ms), steady(plain.ms),
             steady(store.ms) - steady(plain.ms), acc1, acc0, card),
          flush=True)
    check(len(plain.equal) == len(store.ms) == len(timed.ms) > 0 and
          all(plain.equal),
          "fit %s: the weights with a store differ from those without "
          "after steps %s" % (what, [i for i, e in enumerate(plain.equal)
                                     if not e]))
    check(acc1 == acc0 and 0.0 <= acc <= 1.0, "fit %s: accuracy %s with a "
          "store, %s without" % (what, acc1, acc0))
    return result


def baseline_config1(mx, card):
    """Phase 10b: BASELINE config 1, train_mnist.py (:78-119): the MLP and
    LeNet symbols through ``fit_module`` and the two Gluon nets through
    ``fit_gluon``, each with ``mx.kv.create("device")``, 2 epochs of
    synthetic MNIST-shaped batches of 64, each step's weights bit-equal to
    the run without a store."""
    tx, ty, vx, vy = synthetic_mnist(MNIST_SYNTH)
    args = dict(FIT_ARGS)

    def make_iters():
        return (mx.io.NDArrayIter(tx, ty, args["batch_size"], shuffle=True,
                                  label_name="softmax_label"),
                mx.io.NDArrayIter(vx, vy, args["batch_size"],
                                  label_name="softmax_label"))

    out = {}
    for what, fit, build in mnist_nets(mx):
        def built(build=build, fit=fit):
            net = build()
            if fit is fit_gluon:
                net.hybridize()
            return net
        out[what] = store_pair(mx, "10b " + what, fit, built, make_iters,
                               args, card)
    return out


def synthetic_iters(mx, args, shape):
    """train_imagenet.py ``synthetic_iters`` (:50-77) line for line, with
    the port as ``mx`` (one process: no rank sharding)."""
    rs = np.random.RandomState(3)
    n = args["batch_size"] * args["num_batches"]
    y = (rs.rand(n) * args["num_classes"]).astype(np.int64)
    x = rs.rand(n, *shape).astype(np.float32)
    # inject a weak class signal so accuracy is measurable
    x[np.arange(n), 0, 0, 0] = y / float(args["num_classes"])
    cut = n - args["batch_size"]
    if cut <= 0:
        cut = n
        vx, vy = x, y
    else:
        vx, vy = x[cut:], y[cut:]
    tx, ty = x[:cut], y[:cut]
    train = mx.io.NDArrayIter(tx, ty.astype(np.float32),
                              args["batch_size"], shuffle=True,
                              label_name="softmax_label")
    val = mx.io.NDArrayIter(vx, vy.astype(np.float32),
                            args["batch_size"], label_name="softmax_label")
    return train, val


def symbol_convnet(mx, num_classes):
    """train_imagenet.py ``symbol_convnet`` (:105-121) line for line."""
    net = mx.sym.Variable("data")
    for i, filters in enumerate((32, 64, 128)):
        net = mx.sym.Convolution(net, kernel=(3, 3), stride=(2, 2),
                                 pad=(1, 1), num_filter=filters,
                                 name="conv%d" % i)
        net = mx.sym.BatchNorm(net, fix_gamma=False, name="bn%d" % i)
        net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.Pooling(net, global_pool=True, pool_type="avg",
                         kernel=(1, 1))
    net = mx.sym.Flatten(net)
    net = mx.sym.FullyConnected(net, num_hidden=num_classes, name="fc")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def baseline_config2(mx, card):
    """Phase 10c: BASELINE config 2, train_imagenet.py (:50-77, :153-160)
    on ``synthetic_iters``: ResNet-50 v1 in f32 through ``fit_gluon``
    (``--gluon-trainer``) and ``symbol_convnet`` through ``fit_module``
    (``--module``), each with a ``"device"`` store, each step's weights
    bit-equal to the run without a store."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    args, shape = dict(IMAGENET_ARGS), IMAGENET_SHAPE

    def make_iters():
        return synthetic_iters(mx, args, shape)

    def resnet():
        net = vision.resnet50_v1(classes=args["num_classes"])
        net.hybridize()
        return net

    out = {"resnet50 Gluon": store_pair(
        mx, "10c resnet50_v1 f32 Gluon", fit_gluon, resnet, make_iters,
        args, card)}
    out["symbol_convnet Module"] = store_pair(
        mx, "10c symbol_convnet f32 Module", fit_module,
        lambda: symbol_convnet(mx, args["num_classes"]), make_iters, args,
        card)
    r = out["resnet50 Gluon"]
    print("fit 10c: resnet50_v1 f32 through fit_gluon with a store, batch "
          "%d: %.3f ms a step, %.1f img/s, against 6c's %.3f ms (bf16, "
          "DataParallelTrainer) and 9b's %.3f ms (f32, symbolic Module); "
          "the store's copy of the weights and its push and pull %+.3f ms "
          "a step (deterministic algorithms, %.3f with the store, %.3f "
          "without); peak memory %d bytes | %s"
          % (args["batch_size"], r["step_ms_mean"], r["img_per_s"],
             PHASE_6C_MS, PHASE_9B_MS,
             r["deterministic_step_ms_mean"] -
             r["deterministic_no_store_step_ms_mean"],
             r["deterministic_step_ms_mean"],
             r["deterministic_no_store_step_ms_mean"],
             r["peak_memory_bytes"], card), flush=True)
    return out


def lm_store_trainer(mx, card):
    """Phase 10d: the LM of bench_transformer.py at full width in bf16
    through ``gluon.Trainer(..., kvstore=mx.kv.create("device"))``, the
    update on the store (sgd with momentum, multi_precision), beside a
    copy of it through a Trainer without a store, both with torch's
    deterministic algorithms: after every step the weights are equal, and
    B1's forward and backward kernel counters (of the store-backed run,
    zeroed just before each of its steps and read just after) rise by one
    per layer per step while the torch-ops backward stays at 0.  Returns
    (the net, its token batch, one training step of it, the numbers)."""
    import torch
    from incubator_mxnet_tpu_torch.models import TransformerLM
    from incubator_mxnet_tpu_torch.ops.attention import flash_attention
    cfg, batch, steps = LM_CONFIG, TRAIN_BATCH, LM_STORE_STEPS
    ctx = mx.gpu(0)
    t0 = time.perf_counter()
    mx.random.seed(SEED)
    nets = []
    for _ in range(2):
        net = TransformerLM(**cfg)
        net.initialize(mx.init.Xavier(rnd_type="gaussian"), ctx=ctx)
        nets.append(net)
    rs = np.random.RandomState(SEED + 10)
    x = mx.nd.array(rs.randint(0, cfg["vocab"], (batch, cfg["seq_len"])),
                    ctx=ctx, dtype="int32")
    y = mx.nd.array(rs.randint(0, cfg["vocab"], (batch, cfg["seq_len"]))
                    .astype(np.float32), ctx=ctx)
    with mx.autograd.predict_mode():
        for net in nets:
            net(x)                          # resolves the deferred shapes
    a, b = nets
    pa, pb = list(a.collect_params().values()), \
        list(b.collect_params().values())
    with torch.no_grad():
        for p, q in zip(pb, pa):
            p.data()._data.copy_(q.data()._data)
    for net in nets:
        net.cast("bfloat16")
    store = mx.kv.create("device")
    trainers = (mx.gluon.Trainer(a.collect_params(), "sgd",
                                 dict(LM_STORE_OPT), kvstore=store),
                mx.gluon.Trainer(b.collect_params(), "sgd",
                                 dict(LM_STORE_OPT), kvstore=None))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def step(net, trainer):
        with mx.autograd.record():
            loss = loss_fn(net(x).astype("float32"), y)
        loss.backward()
        trainer.step(batch)
        return float(loss.mean().asscalar())

    built_s = time.perf_counter() - t0
    counters = ("launches", "backward_kernel_launches",
                "backward_torch_calls", "backward_calls")
    totals = dict.fromkeys(counters, 0)
    losses, ms, equal = [], [], []
    exact = deterministic_kernels(torch)
    exact.__enter__()
    for i in range(steps):
        torch.cuda.synchronize()
        for c in counters:
            setattr(flash_attention, c, 0)
        t1 = time.perf_counter()
        losses.append(step(a, trainers[0]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        for c in counters:
            totals[c] += getattr(flash_attention, c)
        step(b, trainers[1])
        equal.append(all(torch.equal(p.data()._data, q.data()._data)
                         for p, q in zip(pa, pb)))
    exact.__exit__(None, None, None)
    store_bytes = sum(v._data.numel() * v._data.element_size()
                      for v in store._store.values())
    n_params = sum(int(np.prod(p.shape)) for p in pa)
    peak = torch.cuda.max_memory_allocated()
    print("train 10d: TransformerLM %s, %d parameters in bf16, "
          "gluon.Trainer(sgd %s, kvstore=mx.kv.create('device')), the "
          "update on the store, batch %d x %d, built in %.1f s; torch's "
          "deterministic algorithms: step ms %s, "
          "losses %s; weights equal to the Trainer without a store after "
          "each step %s; flash launches in %d steps %s (%d layers); the "
          "store holds a second copy of the %d weights, %d bytes in bf16, "
          "and the optimizer an f32 master copy and momentum; peak memory "
          "allocated %d bytes | %s"
          % (cfg, n_params, LM_STORE_OPT, batch, cfg["seq_len"], built_s,
             ["%.3f" % v for v in ms], ["%.4f" % v for v in losses], equal,
             steps, totals, cfg["n_layers"], n_params, store_bytes, peak,
             card), flush=True)
    expected = cfg["n_layers"] * steps
    check(all(equal), "10d: the store-backed Trainer's weights differ from "
          "the Trainer without a store after steps %s" % equal)
    check(totals["launches"] == expected and
          totals["backward_kernel_launches"] == expected and
          totals["backward_calls"] == expected and
          totals["backward_torch_calls"] == 0,
          "10d: flash counters %s, expected %d forward and backward kernel "
          "launches and no torch-ops backward" % (totals, expected))
    check(all(math.isfinite(v) for v in losses), "10d: losses %s" % losses)
    trainer = trainers[0]
    del b, trainers, pb
    gc.collect()
    torch.cuda.empty_cache()
    result = dict(step_ms=ms, losses=losses, equal_steps=sum(equal),
                  launches=totals, store_bytes=store_bytes,
                  n_params=n_params, peak_memory_bytes=peak,
                  built_s=built_s)
    return a, x, lambda: step(a, trainer), result


def _trace_rows(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _inside(t, span):
    return span[0] <= t <= span[1]


def flash_rows_in_spans(rows, sync):
    """{kernel: (rows, rows launched inside their op's span, rows run
    inside it)} for the flash kernels of FLASH_KERNELS in a dump, by
    correlation id to their launch; a row runs inside its span when
    ``sync`` made the span wait for it."""
    spans, launch, kernels = {}, {}, []
    for r in rows:
        cat, args = r.get("cat"), r.get("args") or {}
        if r.get("ph") != "X":
            continue
        if cat == "operator":
            spans.setdefault(r["name"], []).append(
                (r["ts"], r["ts"] + r["dur"]))
        elif cat in ("cuda_runtime", "cuda_driver") and \
                "correlation" in args:
            launch[args["correlation"]] = r["ts"]
        elif cat == "kernel":
            kernels.append(r)
    out = {}
    for k in kernels:
        kind = next((n for n in FLASH_KERNELS if n in k["name"]), None)
        if kind is None:
            continue
        own = spans.get(FLASH_KERNELS[kind], [])
        t = launch.get((k.get("args") or {}).get("correlation"))
        n, launched, ran = out.get(kind, (0, 0, 0))
        launched_in = t is not None and any(_inside(t, s) for s in own)
        ran_in = any(_inside(k["ts"], s) and _inside(k["ts"] + k["dur"], s)
                     for s in own)
        out[kind] = (n + 1, launched + launched_in, ran + ran_in)
    return out


def host_split(rows):
    """How the host time of eager ops splits, from a dump without sync:
    the top-level op spans of the main thread; in each, the CUDA runtime
    and driver calls, the rest of torch's ops (ATen dispatch), and the
    framework's own Python (the span less both); and the host's time
    between the spans, from the first span's start to the last one's end
    (Gluon's blocks and the caller; a final wait for the card is left
    out)."""
    tid = threading.get_native_id()
    spans = sorted((r for r in rows if r.get("cat") == "operator" and
                    r.get("ph") == "X" and r.get("tid") == tid),
                   key=lambda r: r["ts"])
    top, end = [], -1.0
    for s in spans:
        if s["ts"] >= end:
            top.append(s)
            end = s["ts"] + s["dur"]
    aten = sorted(((r["ts"], r["ts"] + r["dur"]) for r in rows
                   if r.get("cat") == "cpu_op" and r.get("tid") == tid),
                  key=lambda iv: iv[0])
    runtime = [(r["ts"], r["ts"] + r["dur"]) for r in rows
               if r.get("cat") in ("cuda_runtime", "cuda_driver")
               and r.get("tid") == tid]
    totals = dict(ops=len(top), span_us=0.0, runtime_us=0.0, aten_us=0.0,
                  python_us=0.0)
    for s in top:
        a, b = s["ts"], s["ts"] + s["dur"]
        tops, cur = [], -1.0
        for lo, hi in aten:
            if lo >= a and hi <= b and lo >= cur:
                tops.append((lo, hi))
                cur = hi
        rt = [(lo, hi) for lo, hi in runtime if lo >= a and hi <= b]
        rt_us = sum(hi - lo for lo, hi in rt)
        rt_in_aten = sum(hi - lo for lo, hi in rt if any(
            x <= lo and hi <= y for x, y in tops))
        aten_us = sum(hi - lo for lo, hi in tops)
        totals["span_us"] += b - a
        totals["runtime_us"] += rt_us
        totals["aten_us"] += aten_us - rt_in_aten
        totals["python_us"] += (b - a) - aten_us - (rt_us - rt_in_aten)
    totals["window_us"] = (top[-1]["ts"] + top[-1]["dur"] - top[0]["ts"]
                           if top else 0.0)
    totals["between_ops_us"] = totals["window_us"] - totals["span_us"]
    n = max(totals["ops"], 1)
    totals["per_op_us"] = {k: totals[k] / n for k in (
        "span_us", "runtime_us", "aten_us", "python_us", "between_ops_us")}
    return totals


def profiler_on_card(mx, card, lm, tokens, lm_step, request_ms_4b):
    """Phase 10e: ``mx.profiler`` on the card.  One LM request and one 10d
    training step with ``sync=True``: every flash kernel row of the dump
    launched and run inside its op's span (``_contrib_FlashAttention``,
    ``_backward__contrib_FlashAttention``); ``dumps()`` lists the ops by
    count and total.  Then without sync, one LM request and one ResNet-50
    batch of 32 in bf16 (6b's serving): how an eager op's host time
    splits.  Last, an LM request with the profiler stopped, against phase
    4b's eager requests."""
    import torch
    from incubator_mxnet_tpu_torch import cuda_build
    prof = mx.profiler
    path = cuda_build.BUILD_DIR.parent / ("mx-profile-%d.json" % os.getpid())

    def request():
        with mx.autograd.predict_mode():
            logits = lm(tokens)
            mx.nd.argmax(mx.nd.slice_axis(logits, axis=1, begin=-1,
                                          end=None), axis=-1).asnumpy()

    request()
    prof.set_config(filename=str(path), sync=True, profile_memory=True)
    prof.set_state("run")
    request()
    lm_step()
    prof.set_state("stop")
    table = prof.dumps()
    stats = prof.stats()
    prof.dump()
    rows = _trace_rows(path)
    inside = flash_rows_in_spans(rows, sync=True)
    names = {r["name"] for r in rows if r.get("cat") == "operator"}
    kernels = sum(1 for r in rows if r.get("cat") == "kernel")
    print("prof 10e: one LM request and one 10d step under "
          "mx.profiler(sync=True): %d rows, %d op names, %d kernel rows; "
          "flash kernel rows (rows, launched inside their op's span, run "
          "inside it) %s | %s" % (len(rows), len(names), kernels, inside,
                                  card), flush=True)
    for line in table.splitlines()[:16]:
        print("prof 10e dumps: " + line)
    n_layers = LM_CONFIG["n_layers"]
    for kind in FLASH_KERNELS:
        n, launched, ran = inside.get(kind, (0, 0, 0))
        check(n >= n_layers and launched == n and ran == n,
              "10e: %s rows %d, %d launched and %d run inside their op's "
              "span" % (kind, n, launched, ran))
    for op in ("FullyConnected", "_contrib_FlashAttention",
               "_backward__contrib_FlashAttention"):
        check(op in names and stats.get(("operator", op), (0,))[0] > 0,
              "10e: no %s span in the dump or in dumps()" % op)
    # the host split, without sync: the LM request, ResNet-50 at batch 32
    prof.set_config(sync=False, profile_memory=False)
    splits = {}
    resnet = _resnet_full(mx, np)
    resnet.collect_params().setattr("grad_req", "null")
    resnet.cast("bfloat16")
    xr = mx.nd.array(np.random.RandomState(SEED + 7).rand(
        RESNET_SERVE_BATCH, 3, RESNET_IMAGE, RESNET_IMAGE), ctx=mx.gpu(0),
        dtype="bfloat16")

    def serve_resnet():
        with mx.autograd.predict_mode():
            resnet(xr).asnumpy()

    serve_resnet()
    for what, run in (("LM request", request),
                      ("ResNet-50 bf16 batch 32", serve_resnet)):
        off = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            off.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        prof.set_state("run")
        t0 = time.perf_counter()
        run()
        on = (time.perf_counter() - t0) * 1e3
        prof.set_state("stop")
        prof.dump()
        s = splits[what] = dict(host_split(_trace_rows(path)),
                                wall_ms_profiled=on, wall_ms=off)
        p = s["per_op_us"]
        print("prof 10e host split, %s: %.3f ms with the profiler on (no "
              "sync; off %s ms): %d top-level op spans in a %.1f us host "
              "window; per op: span %.2f us = framework Python %.2f + ATen "
              "dispatch %.2f + CUDA runtime %.2f, and %.2f us between the "
              "spans (Gluon blocks, the caller) | %s"
              % (what, on, ["%.3f" % v for v in off], s["ops"],
                 s["window_us"], p["span_us"], p["python_us"], p["aten_us"],
                 p["runtime_us"], p["between_ops_us"], card), flush=True)
        check(s["ops"] > 0 and s["span_us"] > 0, "10e: no op spans in %s"
              % what)
    path.unlink()
    del resnet, xr
    # the profiler stopped: one op_span flag check an op
    check(prof.state() == "stop" and mx.profiler.op_span("x") is None,
          "10e: the profiler did not stop")
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    mean4b = sum(request_ms_4b) / len(request_ms_4b)
    print("prof 10e: an LM request with the profiler stopped %s ms (mean "
          "%.3f) against phase 4b's eager requests %s ms (mean %.3f) | %s"
          % (["%.3f" % v for v in ms], sum(ms) / len(ms),
             ["%.3f" % v for v in request_ms_4b], mean4b, card), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(flash_rows=inside, ops=len(names), kernel_rows=kernels,
                host_split=splits, request_ms=ms, request_ms_4b=request_ms_4b)


def store_phase(mx, card, request_ms_4b):
    """Phase 10: 10a-10e; returns their numbers."""
    import torch
    t10 = time.perf_counter()
    out = dict(kv=kv_on_card(mx, card), config1=baseline_config1(mx, card),
               config2=baseline_config2(mx, card))
    lm, tokens, lm_step, out["lm"] = lm_store_trainer(mx, card)
    out["profiler"] = profiler_on_card(mx, card, lm, tokens, lm_step,
                                       request_ms_4b)
    del lm, lm_step
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t10
    print("kv: phase 10 in %.1f s | %s" % (out["seconds"], card), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 11: engine bulking (mx.engine.bulk: recorded segments replayed as
# CUDA graphs) on the paths of the earlier phases, and the rest of the
# Module/Symbol surface (SequentialModule, PythonLossModule, print_summary,
# autograd.get_symbol)
# ---------------------------------------------------------------------------
# bench_eager.py:93-95
BULK_CHAIN, BULK_SHAPE, BULK_ITERS = 64, (64, 64), 30
# a segment size no request of this script reaches: one flush a request
BULK_WHOLE = 100000
BULK_CNN_BATCH = 32
BULK_RESNET_TRAIN_BATCH = 64
BULK_SEQ_STEPS = 3
# 4b, 6b, 8b and 4d measured by this script on an NVIDIA H100 80GB HBM3,
# 700.00 W (PERF.md §5)
BULK_REFERENCE_MS = {"lm_request": 27.503, "resnet50_batch": 27.658,
                     "inception_v3_batch": 76.447, "lm_train_step": 118.40}


def bulk_chain(a, b, c, n):
    """bench_eager.py's _chain_eager (:1258-1264)."""
    for _ in range(n // 4):
        a = a * b
        a = a + c
        a = a.abs()
        a = a - c
    return a


def bulk_chain_views(a, b, c, n, shape=BULK_SHAPE):
    """bench_eager.py's _chain_views (:1267-1282)."""
    x = a
    h, w = shape
    for _ in range(n // 4):
        x = x * b
        x = x.reshape((h * w,))
        x = x + 1.0
        x = x.reshape(shape)
        x = x.transpose((1, 0))
        x = x.abs()
        x = x[0:h]
        x = x - c
    return x


def same_bits(torch, a, b):
    """Whether two tensors hold the same bits (NaN payloads included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    a, b = a.detach().contiguous(), b.detach().to(a.device).contiguous()
    if a.is_floating_point():
        view = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[a.element_size()]
        return torch.equal(a.view(view), b.view(view))
    return torch.equal(a, b)


def max_diff(a, b):
    return float((a.detach().float() - b.detach().float().to(
        a.device)).abs().max())


def bulk_report(mx, what):
    """Print flush_stats() and cache_sizes() after a phase."""
    stats, sizes = mx.engine.flush_stats(), mx.engine.cache_sizes()
    print("bulk %s: flush_stats %s, cache_sizes %s" % (
        what, json.dumps(stats), json.dumps(sizes)), flush=True)
    return dict(flush_stats=stats, cache_sizes=sizes)


def bulk_pool_bytes(mx):
    """Bytes of the engine's graph memory pool on the card."""
    import torch
    return graph_pool_bytes(torch, mx.engine.graph_pool(
        torch.device("cuda", 0)))


def bulk_release(mx):
    """Drop the engine's cached graphs after a part of phase 11 (their
    memory stays in the engine's pool for the next part)."""
    import torch
    mx.engine.clear_graphs()
    gc.collect()
    torch.cuda.empty_cache()


def bulk_scope(mx, size):
    return mx.engine.bulk(size) if size else contextlib.nullcontext()


def bulk_card_contracts(mx, card, shape=(64, 64)):
    """The engine's card contracts at a small size: a segment captured and
    replayed bit-equal to eager; an input that moves once (a weight after
    a load) gets one graph more and is never copied, and two alternating
    inputs replay their own graphs; an input at a new address on every call
    gets two captures more, then is copied into the entry's own buffer and
    replayed without one; an output of replay 1 unchanged after replay 2;
    the graphs hold no input alive; draws in two scopes
    bit-equal to two eager draws from the same seed; a recorded segment's
    backward captured, then replayed, with eager's gradients."""
    import numpy as np
    import torch
    eng = mx.engine
    rs = np.random.RandomState(SEED + 111)
    gpu = mx.gpu(0)
    a, b, c = (mx.nd.array(rs.rand(*shape).astype(np.float32) + k,
                           ctx=gpu) for k in (0.0, 0.5, 0.0))
    want = bulk_chain(a, b, c, 16)._data.clone()
    eng.reset_flush_stats()
    outs = []
    for _ in range(3):
        with eng.bulk(64):
            outs.append(bulk_chain(a, b, c, 16))
    first = [o._data.clone() for o in outs]
    g = eng.flush_stats()["graphs"]
    res = {"captures": g["captures"], "replays": g["replays"]}
    check(g["captures"] == 1 and g["replays"] == 2, "11 contracts: graphs "
          "%s, want 1 capture and 2 replays" % g)
    check(all(same_bits(torch, o._data, want) for o in outs), "11 contracts:"
          " a replay differs from eager")
    def captures_for(ins, what):
        before = eng.flush_stats()["graphs"]["captures"]
        for k, (x, y) in enumerate(ins):
            want2 = bulk_chain(x, y, c, 16)._data.clone()
            with eng.bulk(64):
                got2 = bulk_chain(x, y, c, 16)
            check(same_bits(torch, got2._data, want2), "11 contracts: %s, "
                  "call %d differs from eager" % (what, k))
        return eng.flush_stats()["graphs"]["captures"] - before

    # the chain's entry: the cache's most recently used
    entry = eng._replay_cache[list(eng._replay_cache)[-1]]
    # a weight that moves once, then two alternating: no copy
    b2 = b.copy()
    res["captures_moved_once"] = captures_for([(a, b2)] * 3, "moved once")
    res["captures_alternating"] = captures_for([(a, b), (a, b2)] * 2,
                                               "alternating")
    check(res["captures_moved_once"] == 1 and
          res["captures_alternating"] == 0 and
          all(buf is None for buf in entry.owned),
          "11 contracts: %d captures for an input moved once, %d for two "
          "alternating, owned slots %s: want 1, 0 and none"
          % (res["captures_moved_once"], res["captures_alternating"],
             [buf is not None for buf in entry.owned]))
    # an activation made anew for every call: two captures, then copies
    fresh = [mx.nd.array(rs.rand(*shape).astype(np.float32), ctx=gpu)
             for _ in range(5)]
    res["captures_fresh"] = [captures_for([(x, b)], "fresh input")
                             for x in fresh]
    check(res["captures_fresh"] == [1, 1, 0, 0, 0] and
          sum(buf is not None for buf in entry.owned) == 1,
          "11 contracts: captures %s for five fresh inputs (want 1, 1, 0, "
          "0, 0), owned slots %s"
          % (res["captures_fresh"], [buf is not None for buf in entry.owned]))
    # the graphs pin no input: a dropped input is freed
    ref = weakref.ref(b2._data)
    del b2
    gc.collect()
    check(ref() is None, "11 contracts: a graph holds a dropped input")
    check(all(same_bits(torch, o._data, f) for o, f in zip(outs, first)),
          "11 contracts: an output changed under a later replay")
    # draws: the framework generator advances per replay as eagerly
    mx.random.seed(SEED)
    draws = []
    for _ in range(3):
        with eng.bulk(8):
            draws.append(mx.nd.random.uniform(shape=(4096,), ctx=gpu)._data)
    mx.random.seed(SEED)
    eager = [mx.nd.random.uniform(shape=(4096,), ctx=gpu)._data
             for _ in range(3)]
    res["rng_bit_equal"] = [same_bits(torch, x, y)
                            for x, y in zip(draws, eager)]
    check(all(res["rng_bit_equal"]) and not same_bits(torch, draws[1],
                                                      draws[2]),
          "11 contracts: bulked draws %s against eager" % res["rng_bit_equal"])
    # a recorded segment: forward graph, backward graph
    w = mx.nd.array(rs.rand(shape[1], 32).astype(np.float32), ctx=gpu)
    w.attach_grad()

    def step(size):
        with bulk_scope(mx, size):
            with mx.autograd.record():
                h = mx.nd.relu(mx.nd.dot(a, w)) * 0.5
                loss = (h * h).sum()
            loss.backward()
        return loss._data.clone(), w.grad._data.clone()

    loss_e, grad_e = step(0)
    eng.reset_flush_stats()
    got = [step(64) for _ in range(3)]
    g = eng.flush_stats()["graphs"]
    res["backward"] = g
    check(g["backward_captures"] == 1 and g["backward_replays"] == 2,
          "11 contracts: backward graphs %s" % g)
    check(all(same_bits(torch, l, loss_e) and same_bits(torch, gr, grad_e)
              for l, gr in got), "11 contracts: a bulked step's loss or "
          "gradient differs from eager")
    print("bulk 11 contracts: %s | %s" % (json.dumps(res), card), flush=True)
    return res


def bulk_chains(mx, card):
    """Phase 11a: bench_eager.py's chains on the card (CHAIN 64, SHAPE
    (64, 64) f32, ITERS 30): eager, bulk(CHAIN + 1), bulk(4 * CHAIN), the
    view chain eager and under bulk(4 * CHAIN), and the recorded training
    chain eager and under bulk(CHAIN + 8): bit-equal to eager, one flush a
    scope and no capture in the timed loop; ops/s of each mode and the
    first flush's capture ms."""
    import numpy as np
    import torch
    eng = mx.engine
    rs = np.random.RandomState(0)
    gpu = mx.gpu(0)
    a = mx.nd.array(rs.rand(*BULK_SHAPE).astype(np.float32), ctx=gpu)
    b = mx.nd.array(rs.rand(*BULK_SHAPE).astype(np.float32) + 0.5, ctx=gpu)
    c = mx.nd.array(rs.rand(*BULK_SHAPE).astype(np.float32), ctx=gpu)
    res = {}
    modes = (("eager", 0, bulk_chain), ("bulk", BULK_CHAIN + 1, bulk_chain),
             ("bulk4", 4 * BULK_CHAIN, bulk_chain),
             ("views_eager", 0, bulk_chain_views),
             ("views_bulk", 4 * BULK_CHAIN, bulk_chain_views))
    for name, size, chain in modes:
        want = chain(a, b, c, BULK_CHAIN)._data.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with bulk_scope(mx, size):
            first = chain(a, b, c, BULK_CHAIN)
        first = first._data
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        replay_before = eng.cache_sizes()["replay"]
        eng.reset_flush_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(BULK_ITERS):
            with bulk_scope(mx, size):
                out = chain(a, b, c, BULK_CHAIN)
        out = out._data
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        stats = eng.flush_stats()
        res[name] = dict(ops_per_s=BULK_CHAIN * BULK_ITERS / dt,
                         first_scope_ms=first_ms, flushes=sum(
                             stats["causes"].values()),
                         captures=stats["graphs"]["captures"])
        check(same_bits(torch, out, want) and same_bits(torch, first, want),
              "11a %s: the result differs from eager" % name)
        if size:
            check(sum(stats["causes"].values()) == BULK_ITERS and
                  stats["graphs"]["captures"] == 0 and
                  eng.cache_sizes()["replay"] == replay_before,
                  "11a %s: %s, replay cache %d -> %d: want one flush a "
                  "scope and no capture" % (name, stats, replay_before,
                                            eng.cache_sizes()["replay"]))
        print("bulk 11a %s: %.1f ops/s (%d iterations of %d ops), first "
              "scope %.3f ms (capture included), %d flushes, %d captures "
              "in the timed loop | %s"
              % (name, res[name]["ops_per_s"], BULK_ITERS, BULK_CHAIN,
                 first_ms, res[name]["flushes"], res[name]["captures"],
                 card), flush=True)
    a.attach_grad()

    def train_step(size):
        with bulk_scope(mx, size):
            with mx.autograd.record():
                out = bulk_chain(a, b, c, BULK_CHAIN)
                loss = (out * out).sum()
            loss.backward()
        return loss

    loss_e = train_step(0)._data.clone()
    grad_e = a.grad._data.clone()
    for name, size in (("train_eager", 0), ("train_bulk", BULK_CHAIN + 8)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(size)._data
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        eng.reset_flush_stats()
        t0 = time.perf_counter()
        for _ in range(BULK_ITERS):
            loss = train_step(size)
        loss = loss._data
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        stats = eng.flush_stats()
        res[name] = dict(ops_per_s=BULK_CHAIN * BULK_ITERS / dt,
                         first_scope_ms=first_ms,
                         flushes=sum(stats["causes"].values()),
                         graphs=stats["graphs"])
        check(same_bits(torch, loss, loss_e) and
              same_bits(torch, a.grad._data, grad_e),
              "11a %s: loss or gradient differs from eager (%.3e, %.3e)"
              % (name, max_diff(loss, loss_e), max_diff(a.grad._data,
                                                        grad_e)))
        if size:
            check(stats["causes"]["autograd"] == BULK_ITERS and
                  sum(stats["causes"].values()) == BULK_ITERS and
                  stats["graphs"]["captures"] == 0 and
                  stats["graphs"]["backward_captures"] == 0,
                  "11a %s: %s" % (name, stats))
        print("bulk 11a %s: %.1f ops/s forward ops (%d steps), first step "
              "%.3f ms, flushes %d, graphs %s | %s"
              % (name, res[name]["ops_per_s"], BULK_ITERS, first_ms,
                 res[name]["flushes"], json.dumps(stats["graphs"]), card),
              flush=True)
    res["report"] = bulk_report(mx, "11a")
    return res


def _segment_length(mx, run):
    """The instructions of the one segment ``run`` records under
    bulk(BULK_WHOLE), from the flush statistics."""
    mx.engine.reset_flush_stats()
    with mx.engine.bulk(BULK_WHOLE):
        run()
    lengths = mx.engine.flush_stats()["segment_lengths"]
    return max(lengths) if lengths else 0


def _replay_trace(mx, run, names):
    """(kernel rows by name among ``names``, device-busy us, wall us) of
    one call of ``run`` under torch.profiler (:func:`profiled`)."""
    prof, wall_us = profiled(run)
    kernels = trace_kernels(prof)
    busy = sum(us for us, _ in kernels.values())
    rows = {n: sum(cnt for k, (_, cnt) in kernels.items() if n in k)
            for n in names}
    return rows, busy, wall_us


def _timed_ms(run, reps, torch):
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def bulk_serve(mx, card, what, forward, want, reps, reference_ms,
               flash_layers=None):
    """One model's batch under bulk(): eager, bulk(64) and bulk(n) with n
    its op count (one segment); each bulked output bit-equal to ``want``
    on the capture and on a replay; ms a batch of each against the
    earlier phase's; one replay of bulk(n) traced for its device-busy ms
    (and its flash_fwd_sm90_kernel rows, one per layer, for the LM)."""
    import torch
    n = _segment_length(mx, forward)
    res = {"ops": n, "reference_ms": reference_ms}
    for name, size in (("eager", 0), ("bulk64", 64), ("bulk_n", n)):
        for rep in range(2):
            with bulk_scope(mx, size):
                out = forward()
            got = out._data
            check(same_bits(torch, got, want), "11b %s %s call %d: output "
                  "differs from the eager batch (max %.3e)"
                  % (what, name, rep, max_diff(got, want)))
            del out, got

        def run(size=size):
            with bulk_scope(mx, size):
                forward()._data
        ms = _timed_ms(run, reps, torch)
        res[name] = dict(ms=ms, ms_mean=sum(ms) / len(ms))
    rows, busy, wall = _replay_trace(mx, lambda: run(n), ("flash_fwd_sm90",))
    res["trace"] = dict(busy_ms=busy / 1e3, wall_ms=wall / 1e3,
                        flash_fwd_sm90_kernel=rows["flash_fwd_sm90"])
    res["pool_bytes"] = bulk_pool_bytes(mx)
    if flash_layers is not None:
        check(rows["flash_fwd_sm90"] == flash_layers, "11b %s: %d "
              "flash_fwd_sm90_kernel rows in one replay's trace, want %d"
              % (what, rows["flash_fwd_sm90"], flash_layers))
    print("bulk 11b %s: %d ops a batch; eager %.3f ms, bulk(64) %.3f ms, "
          "bulk(%d) %.3f ms a batch (the earlier phase: %.3f ms); one "
          "bulk(%d) replay traced: wall %.3f ms, device busy %.3f ms, "
          "flash_fwd_sm90_kernel rows %d; engine graph pool %s bytes | %s"
          % (what, n, res["eager"]["ms_mean"], res["bulk64"]["ms_mean"], n,
             res["bulk_n"]["ms_mean"], reference_ms, n, wall / 1e3,
             busy / 1e3, rows["flash_fwd_sm90"], res["pool_bytes"], card),
          flush=True)
    return res


def bulk_lm_serving(mx, card, net, tokens, want):
    """Phase 11b, the LM: the full-width LM's eager request of 4b (bf16)
    under bulk(64) and bulk(n)."""
    def forward():
        with mx.autograd.predict_mode():
            return net(tokens)
    mx.engine.reset_flush_stats()
    res = bulk_serve(mx, card, "LM request", forward, want._data, 3,
                     BULK_REFERENCE_MS["lm_request"],
                     flash_layers=LM_CONFIG["n_layers"])
    res["report"] = bulk_report(mx, "11b LM")
    bulk_release(mx)
    return res


def bulk_cnn_serving(mx, card):
    """Phase 11b, the CNNs: ResNet-50 v1 (6b) and Inception-v3 (8b), bf16
    at batch 32, under bulk(64) and bulk(n), bit-equal to their eager
    batch."""
    import numpy as np
    import torch
    res = {}
    for name, size, ref in (("resnet50_v1", RESNET_IMAGE,
                             BULK_REFERENCE_MS["resnet50_batch"]),
                            ("inception_v3", 299,
                             BULK_REFERENCE_MS["inception_v3_batch"])):
        mx.random.seed(SEED)
        from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
        net = getattr(vision, name)(classes=1000)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        net.collect_params().setattr("grad_req", "null")
        with mx.autograd.predict_mode():
            net(mx.nd.zeros((1, 3, size, size), ctx=mx.gpu(0)))
        net.cast("bfloat16")
        rs = np.random.RandomState(SEED + 7)
        x = mx.nd.array(rs.rand(BULK_CNN_BATCH, 3, size, size).astype(
            np.float32), ctx=mx.gpu(0), dtype="bfloat16")

        def forward(net=net, x=x):
            with mx.autograd.predict_mode():
                return net(x)
        want = forward()._data.clone()
        mx.engine.reset_flush_stats()
        res[name] = bulk_serve(mx, card, name, forward, want, 4, ref)
        res[name]["report"] = bulk_report(mx, "11b " + name)
        bulk_release(mx)
        del net, x, want
        gc.collect()
        torch.cuda.empty_cache()
    return res


def _grads(net):
    return {n: p.grad()._data.clone() for n, p in
            net.collect_params().items() if p.grad_req != "null"}


def bulk_train_step(mx, card, what, net, x, y, loss_fn, reference_ms,
                    trainer, flash_layers=None):
    """Phase 11c for one model: forward and loss under record() inside
    bulk(n), then backward() inside it (one flush, cause autograd): the
    loss bit-equal to the unbulked step's and each gradient bit-equal or
    its largest difference printed, on the capture and on a replay; step
    ms (with the Trainer's update) bulked and eager; the traced replay of
    a bulked step (forward and backward flash rows for the LM); peak
    memory."""
    import numpy as np
    import torch

    def loss_of():
        with mx.autograd.record():
            out = net(x)
            if out.dtype != np.float32:
                out = out.astype("float32")
            return loss_fn(out, y).mean()

    def step(size):
        with bulk_scope(mx, size):
            loss = loss_of()
            loss.backward()
        return loss._data

    n = _segment_length(mx, lambda: loss_of())
    loss_e = step(0).clone()
    grads_e = _grads(net)
    mx.engine.reset_flush_stats()
    res = {"ops": n, "reference_ms": reference_ms, "grad_max_diff": {}}
    for rep in range(2):
        loss = step(n)
        stats = mx.engine.flush_stats()
        check(same_bits(torch, loss, loss_e), "11c %s call %d: loss %r, "
              "unbulked %r" % (what, rep, float(loss), float(loss_e)))
        diffs = {k: max_diff(g, grads_e[k]) for k, g in _grads(net).items()
                 if not same_bits(torch, g, grads_e[k])}
        res["grad_max_diff"]["call%d" % rep] = diffs
    check(stats["causes"]["autograd"] == 2 and
          sum(stats["causes"].values()) == 2, "11c %s: flushes %s, want "
          "one a step, cause autograd" % (what, stats))
    res["graphs"] = stats["graphs"]
    for name, size in (("eager", 0), ("bulk_n", n)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def run(size=size):
            step(size)
            trainer.step(x.shape[0])
        ms = _timed_ms(run, 3, torch)
        res[name] = dict(ms=ms, ms_mean=sum(ms) / len(ms),
                         peak_memory_bytes=torch.cuda.max_memory_allocated())
    rows, busy, wall = _replay_trace(
        mx, lambda: step(n), ("flash_fwd_sm90", "flash_bwd"))
    res["trace"] = dict(busy_ms=busy / 1e3, wall_ms=wall / 1e3, rows=rows)
    res["pool_bytes"] = bulk_pool_bytes(mx)
    if flash_layers is not None:
        check(rows["flash_fwd_sm90"] == 2 * flash_layers and
              rows["flash_bwd"] == 2 * flash_layers, "11c %s: kernel rows "
              "%s in a bulked step's trace, want %d forward (the forward "
              "graph and the backward graph's recompute) and %d backward "
              "(dQ and dK/dV a layer)" % (what, rows, 2 * flash_layers,
                                           2 * flash_layers))
    differ = any(res["grad_max_diff"].values())
    print("bulk 11c %s: %d ops recorded into one segment; loss bit-equal to "
          "the unbulked step; gradients that differ (largest difference): "
          "%s%s; step ms eager %.3f, bulk(%d) %.3f (the earlier "
          "phase: %.3f); peak memory eager %d, bulk %d bytes; a bulked "
          "step traced: wall %.3f ms, device busy %.3f ms, rows %s; graphs "
          "%s; engine graph pool %s bytes | %s"
          % (what, n, json.dumps(res["grad_max_diff"]),
             " (cause: the segment's backward recomputes the forward and "
             "takes torch.autograd.grad inside a captured graph, where the "
             "unbulked step's autograd may add a weight's contributions in "
             "another order)" if differ else "",
             res["eager"]["ms_mean"], n, res["bulk_n"]["ms_mean"],
             reference_ms, res["eager"]["peak_memory_bytes"],
             res["bulk_n"]["peak_memory_bytes"], wall / 1e3, busy / 1e3,
             json.dumps(rows), json.dumps(res["graphs"]), res["pool_bytes"],
             card), flush=True)
    return res


def bulk_training(mx, card):
    """Phase 11c: the LM step of 4d (bf16 weights, batch 8 x 1024) and
    ResNet-50 v1 f32 at batch 64 (under deterministic_kernels), each step
    recorded into one segment."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch.models import TransformerLM, HostXavier
    res = {}
    cfg = LM_CONFIG
    net = TransformerLM(**cfg)
    net.pos_embed.init = None
    net.initialize(HostXavier(SEED), ctx=mx.gpu(0))
    rs = np.random.RandomState(0)
    x = mx.nd.array(rs.randint(0, cfg["vocab"], (TRAIN_BATCH,
                                                 cfg["seq_len"])),
                    ctx=mx.gpu(0), dtype="int32")
    net(x).wait_to_read()
    net.cast("bfloat16")
    y = mx.nd.array(rs.randint(0, cfg["vocab"], (TRAIN_BATCH,
                                                 cfg["seq_len"])).astype(
        np.float32), ctx=mx.gpu(0))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 1e-4})
    mx.engine.reset_flush_stats()
    res["lm"] = bulk_train_step(
        mx, card, "LM", net, x, y, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
        BULK_REFERENCE_MS["lm_train_step"], trainer,
        flash_layers=cfg["n_layers"])
    res["lm"]["report"] = bulk_report(mx, "11c LM")
    bulk_release(mx)
    del net, trainer, x, y
    gc.collect()
    torch.cuda.empty_cache()
    with deterministic_kernels(torch):
        mx.random.seed(SEED)
        from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
        net = vision.resnet50_v1(classes=1000)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        rs = np.random.RandomState(SEED + 3)
        x = mx.nd.array(rs.rand(BULK_RESNET_TRAIN_BATCH, 3, RESNET_IMAGE,
                                RESNET_IMAGE).astype(np.float32),
                        ctx=mx.gpu(0))
        y = mx.nd.array(rs.randint(0, 1000, BULK_RESNET_TRAIN_BATCH).astype(
            np.float32), ctx=mx.gpu(0))
        net(x).wait_to_read()
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.01, "momentum": 0.9})
        mx.engine.reset_flush_stats()
        res["resnet50"] = bulk_train_step(
            mx, card, "ResNet-50 f32 batch %d" % BULK_RESNET_TRAIN_BATCH,
            net, x, y, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
            float("nan"), trainer)
        res["resnet50"]["report"] = bulk_report(mx, "11c ResNet-50")
    bulk_release(mx)
    del net, trainer, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return res


def bulk_ops(mx, card):
    """Phase 11d: one case per op of 7a's sweep inside bulk(): the op's
    output after a capture and after a replay bit-equal to its eager output
    (within two eager runs' spread for an op that differs between them);
    the ops registered not deferrable are listed; a deferrable op that
    was not deferred fails the phase, and one whose meta inference or
    capture fails raises."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch.ops.registry import _REGISTRY, get_op
    eng = mx.engine
    flagged = sorted({op.name for op in _REGISTRY.values()
                      if not op.deferrable})
    print("bulk 11d: ops registered not deferrable: %s" % flagged,
          flush=True)
    rs = np.random.default_rng(SEED)
    seen, not_deferred, spread, failures = set(), [], {}, []
    t0 = time.perf_counter()
    for case in sweep_cases():
        _, name, params, specs, dtypes, _, _ = case
        if name in seen:
            continue
        seen.add(name)
        op = get_op(name)
        dtype = dtypes[0]
        xs = [mx.nd.array(a, ctx=mx.gpu(0), dtype=dtype if a.dtype.kind ==
                          "f" else "int32")
              for a in _sweep_arrays(rs, specs, dtype)]

        def call():
            out = mx.nd.invoke(op, xs, dict(params))
            return out if isinstance(out, list) else [out]
        e1 = [o._data.clone() for o in call()]
        e2 = [o._data.clone() for o in call()]
        for rep in range(2):
            eng.reset_flush_stats()
            with eng.bulk(64):
                outs = call()
                deferred = any(type(o._slot) is eng._Pending for o in outs)
            got = [o._data for o in outs]
            graphs = eng.flush_stats()["graphs"]
            if not deferred:
                if op.deferrable:
                    not_deferred.append(name)
                break
            if rep == 1 and graphs["replays"] != 1:
                failures.append("%s: no replay (%s)" % (name, graphs))
            for g, a_, b_ in zip(got, e1, e2):
                if same_bits(torch, g, a_):
                    continue
                if not same_bits(torch, a_, b_):
                    d = max_diff(a_, b_)
                    spread[name] = d
                    if max_diff(g, a_) <= d:
                        continue
                failures.append("%s call %d: max diff %.3e from eager"
                                % (name, rep, max_diff(g, a_)))
        del xs
    seconds = time.perf_counter() - t0
    res = dict(ops=len(seen), not_deferrable=flagged,
               deferrable_not_deferred=sorted(set(not_deferred)),
               eager_spread=spread, failures=failures, seconds=seconds)
    print("bulk 11d: %d ops of 7a's sweep inside bulk(), captured then "
          "replayed, in %.1f s; deferrable but run eagerly: %s; "
          "differing between two eager runs: %s; failures: %s | %s"
          % (len(seen), seconds, res["deferrable_not_deferred"],
             json.dumps(spread), failures, card), flush=True)
    check(not failures and not not_deferred, "11d: failures %s, deferrable "
          "ops run eagerly %s" % (failures, not_deferred))
    res["report"] = bulk_report(mx, "11d")
    bulk_release(mx)
    return res


def resnet_symbol_parts(mx, num_layers=50, split_stage=3,
                        num_classes=1000):
    """:func:`resnet_symbol` cut before stage ``split_stage``: (the stem
    and the stages before it, ``data`` -> the rest and SoftmaxOutput), with
    the whole net's layer names."""
    bottle_neck, units = RESNET_SPECS[num_layers]
    filters = (256, 512, 1024, 2048) if bottle_neck else (64, 128, 256, 512)
    x = mx.sym.var("data")
    x = _sym_conv_bn(mx, x, 64, (7, 7), (2, 2), (3, 3), "stem")
    x = mx.sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max", name="stem_pool")
    parts = []
    for s, (n_units, f) in enumerate(zip(units, filters)):
        if s + 1 == split_stage:
            parts.append(x)
            x = mx.sym.var("data")
        for u in range(n_units):
            stride = (1, 1) if (s == 0 or u > 0) else (2, 2)
            x = _sym_residual_unit(mx, x, f, stride, dim_match=(u > 0),
                                   name="stage%d_unit%d" % (s + 1, u + 1),
                                   bottle_neck=bottle_neck)
    x = mx.sym.Pooling(x, global_pool=True, pool_type="avg", kernel=(7, 7),
                       name="pool_final")
    x = mx.sym.Flatten(x, name="flat")
    x = mx.sym.FullyConnected(x, num_hidden=num_classes, name="fc1")
    parts.append(mx.sym.SoftmaxOutput(x, name="softmax"))
    return parts


def _module_weights(mod):
    arg, aux = mod.get_params()
    return {n: v._data.clone() for n, v in list(arg.items()) +
            list(aux.items())}


def bulk_modules(mx, card, batch=BULK_RESNET_TRAIN_BATCH, steps=BULK_SEQ_STEPS,
                 image=RESNET_IMAGE, classes=1000):
    """Phase 11e: the symbolic ResNet-50 cut at stage 3 into two Modules
    chained by SequentialModule(auto_wiring=True), f32 at batch 64, for 3
    steps, its weights after each step bit-equal to one Module over the
    whole symbol (deterministic kernels); PythonLossModule after the MLP of
    10b; print_summary of the symbolic ResNet-50."""
    import numpy as np
    import torch
    res = {}
    shapes = {"data": (batch, 3, image, image)}
    whole = resnet_symbol(mx, num_classes=classes)
    rs = np.random.RandomState(SEED + 11)
    arg_np, aux_np = symbol_weights(np, whole, dict(
        shapes, softmax_label=(batch,)), rs)
    batches = [(rs.rand(batch, 3, image, image).astype(np.float32),
                rs.randint(0, classes, batch).astype(np.float32))
               for _ in range(steps)]
    opt = dict(SYM_TRAIN_OPT)

    def fresh(mod, data_shapes, label_shapes):
        mod.bind(data_shapes, label_shapes)
        mod.init_params(arg_params={n: mx.nd.array(v, ctx=mx.gpu(0))
                                    for n, v in arg_np.items()},
                        aux_params={n: mx.nd.array(v, ctx=mx.gpu(0))
                                    for n, v in aux_np.items()},
                        allow_missing=False, allow_extra=True)
        mod.init_optimizer(optimizer="sgd", optimizer_params=opt)
        return mod

    data_shapes = [("data", shapes["data"])]
    label_shapes = [("softmax_label", (batch,))]
    with deterministic_kernels(torch):
        single = fresh(mx.mod.Module(whole, context=mx.gpu(0)), data_shapes,
                       label_shapes)
        part1, part2 = resnet_symbol_parts(mx, num_classes=classes)
        seq = mx.mod.SequentialModule()
        seq.add(mx.mod.Module(part1, label_names=None, context=mx.gpu(0)))
        seq.add(mx.mod.Module(part2, context=mx.gpu(0)), take_labels=True,
                auto_wiring=True)
        fresh(seq, data_shapes, label_shapes)
        same, ms = [], {"single": [], "sequential": []}
        for xb, yb in batches:
            db = mx.io.DataBatch(data=[mx.nd.array(xb, ctx=mx.gpu(0))],
                                 label=[mx.nd.array(yb, ctx=mx.gpu(0))])
            for name, mod in (("single", single), ("sequential", seq)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mod.forward(db, is_train=True)
                mod.backward()
                mod.update()
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t0) * 1e3)
            w1, w2 = _module_weights(single), _module_weights(seq)
            diff = {n: max_diff(w2[n], v) for n, v in w1.items()
                    if not same_bits(torch, w2[n], v)}
            same.append(diff)
    res["sequential"] = dict(step_ms=ms, differing_weights=same)
    print("bulk 11e: symbolic ResNet-50 cut at stage 3 into two Modules "
          "under SequentialModule(auto_wiring=True), f32 batch %d, %d steps "
          "beside one Module over the whole symbol (deterministic kernels): "
          "weights that differ after each step %s; step ms %s | %s"
          % (batch, steps, json.dumps(same), json.dumps(ms), card),
          flush=True)
    check(all(not d for d in same), "11e: SequentialModule's weights differ "
          "from the single Module's: %s" % same)
    del single, seq
    gc.collect()
    torch.cuda.empty_cache()
    # PythonLossModule after 10b's MLP
    mlp = mnist_nets(mx)[0][2]()
    feat = mlp.get_internals()["fc3_output"]
    x, y = synthetic_mnist(320)[:2]
    x, y = x[:256].reshape(256, -1), y[:256]
    seq = mx.mod.SequentialModule()
    seq.add(mx.mod.Module(feat, label_names=None, context=mx.gpu(0)))
    seq.add(mx.mod.PythonLossModule(), take_labels=True)
    it = mx.io.NDArrayIter(x, y, batch_size=64, shuffle=False)
    seq.fit(it, num_epoch=3, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05},
            initializer=mx.init.Xavier())
    seq.forward(mx.io.DataBatch(data=[mx.nd.array(x, ctx=mx.gpu(0))],
                                label=[mx.nd.array(y, ctx=mx.gpu(0))]),
                is_train=False)
    scores = seq.get_outputs()[0].asnumpy()
    acc = float((scores.argmax(1) == y).mean())
    res["python_loss"] = dict(train_accuracy=acc)
    print("bulk 11e: PythonLossModule after the MLP of 10b (softmax "
          "gradient in numpy), 3 epochs of 256 synthetic digits: training "
          "accuracy %.4f | %s" % (acc, card), flush=True)
    check(np.isfinite(scores).all() and acc > 0.5, "11e: PythonLossModule "
          "accuracy %.4f" % acc)
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        text = mx.viz.print_summary(whole, shape={
            "data": (1, 3, image, image), "softmax_label": (1,)})
    total = [ln for ln in text.splitlines() if ln.startswith("Total params")]
    res["print_summary_total"] = total[0] if total else None
    arg_shapes, _, aux_shapes = whole.infer_shape(data=(1, 3, image, image),
                                                  softmax_label=(1,))
    counted = sum(int(np.prod(s)) for n, s in zip(
        whole.list_arguments(), arg_shapes) if n not in (
            "data", "softmax_label")) + sum(int(np.prod(s))
                                            for s in aux_shapes)
    print("bulk 11e: print_summary of the symbolic ResNet-50: %s (its "
          "arguments and auxiliary states hold %d values)"
          % (res["print_summary_total"], counted), flush=True)
    check(res["print_summary_total"] == "Total params: %d" % counted,
          "11e: %s, counted %d" % (res["print_summary_total"], counted))
    return res


def bulk_get_symbol(mx, card, batch=SYM_ATTN["batch"], seq=SYM_ATTN["seq"],
                    d_model=SYM_ATTN["d_model"], heads=SYM_ATTN["heads"]):
    """Phase 11f: one recorded forward of the LM's attention layer (bf16,
    D = 128) through nd, autograd.get_symbol of its loss, bound through the
    Executor with the same arrays: forward and backward equal to eager,
    with B1's forward and backward kernels once each."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch.autograd import _trace
    from incubator_mxnet_tpu_torch.ops.attention import flash_attention
    rs = np.random.RandomState(SEED + 93)
    shapes = {"data": (batch, seq, d_model)}
    for n in ("q", "k", "v", "o"):
        shapes[n + "_weight"] = (d_model, d_model)
    values = {n: mx.nd.array((rs.standard_normal(s) * (
        1.0 if n == "data" else 1.0 / math.sqrt(s[-1]))).astype(np.float32),
        ctx=mx.gpu(0), dtype="bfloat16") for n, s in shapes.items()}
    copies = {}
    loss, grads = attention_eager(mx, values, d_model, heads, copies)
    name_of = {id(a): n for n, a in copies.items()}
    sym, arrays = _trace(loss)
    ops = [node._op.name for node in sym._topo() if not node.is_variable()]
    ex = sym.bind(mx.gpu(0), dict(arrays), args_grad={
        n: mx.nd.zeros(a.shape, ctx=mx.gpu(0), dtype="bfloat16")
        for n, a in arrays.items()}, grad_req="write")
    counters = ("launches", "backward_kernel_launches", "backward_torch_calls")
    for c in counters:
        setattr(flash_attention, c, 0)
    out = ex.forward(is_train=True)[0]
    ex.backward()
    torch.cuda.synchronize()
    launches = {c: getattr(flash_attention, c) for c in counters}
    same = {"loss": same_bits(torch, out._data, loss._data)}
    for n, a in arrays.items():
        same[name_of[id(a)]] = same_bits(torch, ex.grad_dict[n]._data,
                                         grads[name_of[id(a)]]._data)
    res = dict(ops=ops, arguments=sym.list_arguments(), launches=launches,
               bit_equal=same)
    print("bulk 11f: autograd.get_symbol of the LM's attention layer (batch "
          "%d x %d, d_model %d, %d heads, D = %d, bf16): %d ops %s, "
          "arguments %s; bound through the Executor: flash counters %s, "
          "output and gradients equal to eager %s | %s"
          % (batch, seq, d_model, heads, d_model // heads, len(ops), ops,
             sym.list_arguments(), json.dumps(launches), json.dumps(same),
             card), flush=True)
    check(launches["launches"] == 1 and
          launches["backward_kernel_launches"] == 1 and
          launches["backward_torch_calls"] == 0,
          "11f: flash counters %s (want 1, 1, 0)" % launches)
    check(all(same.values()), "11f: the symbol differs from eager: %s"
          % same)
    return res


def bulk_phase(mx, card):
    """Phase 11 after phase 10: 11a, 11b's CNNs, 11c, 11d, 11e, 11f and the
    engine's card contracts (11b's LM runs beside 4b, on its net)."""
    t0 = time.perf_counter()
    res = dict(contracts=bulk_card_contracts(mx, card),
               chains=bulk_chains(mx, card),
               cnn_serving=bulk_cnn_serving(mx, card),
               training=bulk_training(mx, card),
               ops=bulk_ops(mx, card),
               modules=bulk_modules(mx, card),
               get_symbol=bulk_get_symbol(mx, card))
    res["seconds"] = time.perf_counter() - t0
    print("bulk: phase 11 in %.1f s | %s" % (res["seconds"], card),
          flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 12: the data plane (RecordIO, mx.image, ImageRecordIter, gluon.data)
# feeding the card: train_imagenet.py's record path into ResNet-50 and a
# DataLoader into the LM
# ---------------------------------------------------------------------------
# train_imagenet.py's record path (:80-101): 5 batches of 256 raw 224²
# records (10 until the smoke's time was cut for phase 18); the augmenting
# pipeline over 512 256² records cropped to 224² (1024 until then)
DATA_RECORDS = 1280
DATA_AUG_RECORDS, DATA_AUG_RAW, DATA_AUG_BATCH = 512, (3, 256, 256), 128
DATA_THREADS = (1, 4, 8)
DATA_READERS = 4            # preprocess_threads and prefetch_buffer of 12b
# 12d: gluon.data at ImageNet's widths
DATA_GLUON_IMAGES, DATA_GLUON_SIZE, DATA_GLUON_CROP = 512, 256, 224
DATA_GLUON_BATCH, DATA_GLUON_WORKERS = 64, 4
IMAGENET_MEAN_STD = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
# the bound of Resize on the card against the CPU, on images in [0, 255]:
# 2^-15 of the range.  Both compute the filter in f32 and neither is exact:
# the CPU's f32 result lies up to 1.8e-5 of the range (2^-15.8) from the
# same resize in f64 (256² -> 224², 4 seeds); the CPU tests hold the CPU
# within 6-28 ulps of jax.image.resize, which computes in f32 alike.  A
# uint8 output truncates to the other side where a value lies within that
# gap of an integer, so the two are at most one uint8 step apart; how many
# values do depends on how many exact results fall on integers (the scale
# ratio), so that share is reported, not bounded
DATA_RESIZE_TOL = 2.0 ** -15 * 255
LM_LOADER_STEPS = 3
# what phase 12 leaves out where OpenCV is not installed, and where it is
DATA_NO_CV2 = ("JPEG/PNG decode (imdecode, imread, ImageRecordIter and "
               "ImageRecordDataset over encoded records, ImageDetIter), "
               "OpenCV resizes (ResizeAug, ForceResizeAug, RandomSizedCropAug, "
               "resize_short, _DetResizeAug), pack_img/unpack_img")
DATA_NOT_DRIVEN = ("the OpenCV resizes (ResizeAug, ForceResizeAug, "
                   "RandomSizedCropAug, resize_short, _DetResizeAug), "
                   "ImageDetIter, PNG records, imread, pack_img/unpack_img")


@contextlib.contextmanager
def env_var(name, value):
    """``os.environ[name] = value`` inside, the old value restored after."""
    before = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = before


def seeded(seed=SEED):
    """Seed every host generator the data plane draws from: Python's
    ``random`` (augmenters, ImageIter's shuffle) and ``np.random``
    (LightingAug, the samplers, the gluon transforms)."""
    random.seed(seed)
    np.random.seed(seed)


def raw_images(n, shape, seed):
    """``n`` HWC uint8 images of CHW ``shape`` and their labels (0-999),
    from ``seed``."""
    rs = np.random.RandomState(seed)
    c, h, w = shape
    imgs = np.frombuffer(rs.bytes(n * c * h * w), np.uint8).reshape(n, h, w, c)
    return imgs, rs.randint(0, 1000, n).astype(np.float32)


def write_records(mx, prefix, imgs, labels):
    """Raw records (``tools/im2rec.py --pack-raw``'s layout) with an index;
    returns the seconds the writes took."""
    t0 = time.perf_counter()
    w = mx.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(len(imgs)):
        w.write_idx(i, mx.recordio.pack(
            mx.recordio.IRHeader(0, float(labels[i]), i, 0), imgs[i].tobytes()))
    w.close()
    return time.perf_counter() - t0


def drain(it):
    """Images of one epoch of ``it`` (a DataIter or a DataLoader) and the
    seconds it took; every batch's arrays are read to the host."""
    t0 = time.perf_counter()
    count = 0
    for batch in it:
        if isinstance(batch, (list, tuple)):
            x = batch[0]
        else:
            x = batch.data[0]
        count += x.shape[0] - getattr(batch, "pad", 0)
        x.wait_to_read()
    return count, time.perf_counter() - t0


def data_card_contracts(mx, card, tmp, n=512, batch=64):
    """Phase 12a: the native writer and reader on the card's host (the same
    bytes as the Python framing, files read across, the prefetch reader in
    order); one pipeline with ``ctx=gpu(0)`` and with ``ctx=cpu(0)``,
    bit-equal batches on their devices; ``imdecode`` raises ``MXNetError``
    naming OpenCV where cv2 is absent."""
    import torch
    from incubator_mxnet_tpu_torch import _native, cuda_build
    shape = (3, 32, 32)
    imgs, labels = raw_images(n, shape, SEED + 20)
    t0 = time.perf_counter()
    _native.io_lib()
    build_s = time.perf_counter() - t0
    files = {}
    for native in (True, False):
        with env_var("MXTPU_NATIVE_IO", "1" if native else "0"):
            prefix = os.path.join(tmp, "a%d" % native)
            write_s = write_records(mx, prefix, imgs, labels)
            files[native] = prefix
            r = mx.recordio.MXRecordIO(prefix + ".rec", "r")
            check(r._native_handle is native, "12a: NATIVE_IO=%d chose the "
                  "other framing" % native)
            r.close()
        print("data 12a: %d raw %s records written %s in %.3f s"
              % (n, shape, "natively" if native else "in Python", write_s),
              flush=True)
    for ext in (".rec", ".idx"):
        with open(files[True] + ext, "rb") as a, \
                open(files[False] + ext, "rb") as b:
            check(a.read() == b.read(), "12a: the native and Python %s "
                  "files differ" % ext)
    want = [mx.recordio.pack(mx.recordio.IRHeader(0, float(labels[i]), i, 0),
                             imgs[i].tobytes()) for i in range(n)]
    for native in (True, False):
        with env_var("MXTPU_NATIVE_IO", "1" if native else "0"):
            r = mx.recordio.MXIndexedRecordIO(
                files[not native] + ".idx", files[not native] + ".rec", "r")
            got = [r.read() for _ in range(n)] + [r.read()]
            keyed = [r.read_idx(k) for k in (n - 1, 0, n // 2)]
            r.close()
        check(got == want + [None] and keyed == [want[n - 1], want[0],
                                                 want[n // 2]],
              "12a: the %s reader misreads the other framing's file"
              % ("native" if native else "Python"))
    pr = _native.NativePrefetchReader(files[True] + ".rec", 16)
    got = [pr.read() for _ in range(n + 1)]
    pr.close()
    check(got == want + [None], "12a: the prefetch reader's records differ")
    out = {}
    for ctx in (mx.gpu(0), mx.cpu(0)):
        seeded()
        it = mx.io.ImageRecordIter(
            path_imgrec=files[True] + ".rec", path_imgidx=files[True] + ".idx",
            data_shape=shape, batch_size=batch, shuffle=True, rand_crop=True,
            rand_mirror=True, brightness=0.4, pca_noise=0.1, mean=True,
            std=True, preprocess_threads=1, prefetch_buffer=2, ctx=ctx)
        batches = list(it)
        out[ctx.device_type] = batches
        check(all(b.data[0]._data.device == ctx.torch_device() and
                  b.label[0]._data.device == ctx.torch_device()
                  for b in batches), "12a: batches not on %s" % ctx)
    check(len(out["gpu"]) == len(out["cpu"]) == -(-n // batch) and all(
        torch.equal(g.data[0]._data.cpu(), c.data[0]._data) and
        torch.equal(g.label[0]._data.cpu(), c.label[0]._data)
        for g, c in zip(out["gpu"], out["cpu"])),
        "12a: ctx=gpu(0) and ctx=cpu(0) batches differ")
    try:
        import cv2
    except ImportError:
        cv2 = None
    # without OpenCV (absent, or its import blocked here) imdecode raises
    blocked = sys.modules.get("cv2")
    sys.modules["cv2"] = None
    try:
        mx.image.imdecode(b"\x89PNG\r\n\x1a\n")
        fail("12a: imdecode ran without OpenCV")
    except mx.MXNetError as exc:
        check("OpenCV" in str(exc), "12a: imdecode's error names no "
              "OpenCV: %s" % exc)
        print("data 12a: OpenCV %s: imdecode raises MXNetError (%s)"
              % ("blocked" if cv2 else "absent", str(exc)[:72]), flush=True)
    finally:
        if blocked is None:
            sys.modules.pop("cv2", None)
        else:
            sys.modules["cv2"] = blocked
    jpeg = None
    if cv2 is not None:
        jpeg = jpeg_contract(mx, cv2, tmp, imgs[:batch], labels[:batch])
    print("data 12a: native RecordIO library %s built in %.2f s; native and "
          "Python files byte-identical, read across both ways and by key; "
          "prefetch reader in order; %d batches with ctx=gpu(0) bit-equal to "
          "ctx=cpu(0) | %s"
          % (cuda_build.host_lib_path("recordio").name, build_s,
             len(out["gpu"]), card), flush=True)
    return dict(records=n, build_s=build_s, batches=len(out["gpu"]),
                opencv=cv2 is not None, jpeg=jpeg)


def write_jpeg_records(mx, cv2, prefix, imgs, labels, quality=95):
    """JPEG records of RGB ``imgs`` (OpenCV, quality 95); returns the
    payloads' decoded RGB images."""
    w = mx.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    decoded = []
    for i in range(len(imgs)):
        ok, buf = cv2.imencode(".jpg", cv2.cvtColor(imgs[i], cv2.COLOR_RGB2BGR),
                               [cv2.IMWRITE_JPEG_QUALITY, quality])
        check(ok, "12a: cv2.imencode failed")
        w.write_idx(i, mx.recordio.pack(
            mx.recordio.IRHeader(0, float(labels[i]), i, 0), buf.tobytes()))
        decoded.append(cv2.cvtColor(cv2.imdecode(buf, cv2.IMREAD_COLOR),
                                    cv2.COLOR_BGR2RGB))
    w.close()
    return np.stack(decoded)


def jpeg_contract(mx, cv2, tmp, imgs, labels):
    """Where OpenCV is installed: JPEG records through ImageRecordIter
    (decode 'auto', four decode threads) give what cv2.imdecode gives."""
    prefix = os.path.join(tmp, "jpeg")
    want = write_jpeg_records(mx, cv2, prefix, imgs, labels)
    it = mx.io.ImageRecordIter(
        path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
        data_shape=(3,) + imgs.shape[1:3], batch_size=len(imgs),
        dtype="uint8", aug_list=[], preprocess_threads=4, prefetch_buffer=0,
        ctx=mx.cpu(0))
    got = it.next().data[0].asnumpy()
    it.close()
    check(np.array_equal(got, want.transpose(0, 3, 1, 2)), "12a: JPEG "
          "records decode other than cv2.imdecode")
    print("data 12a: OpenCV %s installed: %d JPEG records through "
          "ImageRecordIter equal cv2.imdecode's images" % (cv2.__version__,
                                                           len(imgs)),
          flush=True)
    return dict(opencv=cv2.__version__, records=len(imgs))


def close_record_iter(it):
    """Stop an ImageRecordIter's prefetch thread and its decode pool."""
    it.close()
    for inner in it.iters:
        inner.close()


class CardFeed(object):
    """The DataIter protocol over host batches copied to the card: each
    ``next()``'s wait for the host pipeline and the copy's ms (the card
    synchronized before and after it) are recorded."""

    def __init__(self, torch, it, ctx):
        self.torch, self.it, self.ctx = torch, it, ctx
        self.next_ms, self.h2d_ms = [], []
        self.provide_data = it.provide_data
        self.provide_label = it.provide_label

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def reset(self):
        self.it.reset()

    def next(self):
        t0 = time.perf_counter()
        batch = self.it.next()
        t1 = time.perf_counter()
        self.torch.cuda.synchronize()
        t2 = time.perf_counter()
        data = [a.as_in_context(self.ctx) for a in batch.data]
        label = [a.as_in_context(self.ctx) for a in batch.label]
        self.torch.cuda.synchronize()
        self.next_ms.append((t1 - t0) * 1e3)
        self.h2d_ms.append((time.perf_counter() - t2) * 1e3)
        return type(batch)(data, label, batch.pad)


def record_pipeline(mx, card, tmp, c10):
    """Phase 12b: train_imagenet.py's record path (:80-101):
    ``ImageRecordIter(dtype="uint8", aug_list=[], shuffle=True,
    ctx=cpu(0), preprocess_threads=4, prefetch_buffer=4)`` over 2,560 raw
    224² records; one epoch drained with no model; the first batch's loss
    through ResNet-50 v1 bit-equal to the same batch's through
    ``NDArrayIter``; then ``fit_gluon`` (10c's wiring, a ``"device"``
    store) for one epoch of 5 steps fed by it, the batches copied to the
    card: step ms, img/s, the share of each step in ``next()``, the copy's
    ms, beside 10c's synthetic step (``c10``) measured in this run."""
    import torch
    from types import SimpleNamespace
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    shape, bs, gpu = IMAGENET_SHAPE, IMAGENET_ARGS["batch_size"], mx.gpu(0)
    imgs, labels = raw_images(DATA_RECORDS, shape, SEED + 21)
    prefix = os.path.join(tmp, "imagenet_raw")
    write_s = write_records(mx, prefix, imgs, labels)
    rec_bytes = os.path.getsize(prefix + ".rec")

    def make(shuffle=True):
        return mx.io.ImageRecordIter(
            path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
            data_shape=shape, batch_size=bs, shuffle=shuffle, dtype="uint8",
            aug_list=[], preprocess_threads=DATA_READERS,
            prefetch_buffer=DATA_READERS, ctx=mx.cpu(0))

    seeded()
    count, drain_s = drain(make())
    check(count == DATA_RECORDS, "12b: the epoch held %d images" % count)
    # the first batch against NDArrayIter over the same images
    seeded()
    it = make()
    keys = list(it.iters[0].seq[:bs])
    first = it.next()
    close_record_iter(it)
    host = imgs[keys].transpose(0, 3, 1, 2)
    check(np.array_equal(first.data[0].asnumpy(), host) and np.array_equal(
        first.label[0].asnumpy(), labels[keys]), "12b: the first batch "
        "is not the records it names")
    ref = mx.io.NDArrayIter(host.astype(np.float32), labels[keys], bs).next()
    mx.random.seed(SEED)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(magnitude=2.0), ctx=gpu)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    with deterministic_kernels(torch):
        for x, y in ((first.data[0].as_in_context(gpu).astype("float32"),
                      first.label[0].as_in_context(gpu)),
                     (ref.data[0], ref.label[0])):
            with mx.autograd.record():
                losses.append(loss_fn(net(x), y).asnumpy())
    check(np.array_equal(losses[0], losses[1]) and
          np.isfinite(losses[0]).all(), "12b: the first batch's loss "
          "differs from NDArrayIter's (mean %r, %r)"
          % (losses[0].mean(), losses[1].mean()))
    del net, first, ref, x, y
    gc.collect()
    torch.cuda.empty_cache()
    # pageable copies of one batch, alone
    copies = {}
    for what, arr in (("uint8", host), ("float32", host.astype(np.float32))):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        ms = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.to(gpu.torch_device())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        copies[what] = dict(bytes=t.numel() * t.element_size(), ms=ms[1:])
    del host
    # one epoch of fit_gluon fed by the record path
    args = dict(IMAGENET_ARGS, num_batches=DATA_RECORDS // bs)
    mx.random.seed(SEED)
    seeded()
    train = CardFeed(torch, make(), gpu)
    val = CardFeed(torch, mx.io.ResizeIter(make(False), 1), gpu)
    trail = StepTrail(torch)
    net = vision.resnet50_v1(classes=1000)
    net.hybridize()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trail.start()
    acc = fit_gluon(mx, net, train, val, SimpleNamespace(**args),
                    on_step=trail)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps = len(trail.ms)
    check(steps == DATA_RECORDS // bs and len(train.next_ms) == steps,
          "12b: %d steps, %d batches" % (steps, len(train.next_ms)))
    ms = trail.ms[1:]
    mean = sum(ms) / len(ms)
    share = [n_ / s for n_, s in zip(train.next_ms[1:], ms)]
    h2d = sum(train.h2d_ms[1:]) / len(ms)
    nxt = sum(train.next_ms[1:]) / len(ms)
    c10_ms = c10["step_ms_mean"]
    print("data 12b: %d raw records of %s (%d bytes) written in %.3f s "
          "(%.1f MB/s); one epoch drained with no model: %.3f s, %.1f img/s "
          "(preprocess_threads %d, prefetch_buffer %d, ctx=cpu(0)) | %s"
          % (DATA_RECORDS, shape, rec_bytes, write_s, rec_bytes / write_s
             / 1e6, drain_s, count / drain_s, DATA_READERS, DATA_READERS,
             card), flush=True)
    print("data 12b: the first batch's loss through ResNet-50 v1 equals "
          "NDArrayIter's bit for bit (mean %.6f); a pageable copy of one "
          "batch to the card: uint8 %d bytes %s ms, float32 %d bytes %s ms "
          "| %s" % (float(losses[0].mean()), copies["uint8"]["bytes"],
                    ["%.3f" % v for v in copies["uint8"]["ms"]],
                    copies["float32"]["bytes"],
                    ["%.3f" % v for v in copies["float32"]["ms"]], card),
          flush=True)
    print("data 12b: ResNet-50 v1 f32 through fit_gluon (kvstore 'device', "
          "batch %d) fed by ImageRecordIter: %d steps %s ms (mean after the "
          "first %.3f, %.1f img/s; 10c's synthetic step in this run %.3f ms, "
          "%.1f img/s); next() %.3f ms a step (%.1f%% of the step, each "
          "%s), the copy to the card %.3f ms a step; accuracy %.4f, peak "
          "memory allocated %d bytes, %.1f s | %s"
          % (bs, steps, ["%.3f" % v for v in trail.ms], mean, bs / mean * 1e3,
             c10_ms, bs / c10_ms * 1e3, nxt, 100 * nxt / mean,
             ["%.3f" % v for v in share], h2d, acc, peak, wall, card),
          flush=True)
    close_record_iter(train.it)
    close_record_iter(val.it.data_iter)
    del net
    gc.collect()
    torch.cuda.empty_cache()
    return dict(write_s=write_s, rec_bytes=rec_bytes, drain_s=drain_s,
                drain_img_per_s=count / drain_s, first_loss=float(
                    losses[0].mean()), copies=copies, step_ms=trail.ms,
                step_ms_mean=mean, img_per_s=bs / mean * 1e3, next_ms=nxt,
                next_share=nxt / mean, h2d_ms=h2d, accuracy=float(acc),
                peak_memory_bytes=peak, c10_step_ms=c10_ms)


def augment_pipeline(mx, card, tmp, step_img_s):
    """Phase 12c: ``ImageRecordIter(data_shape=(3, 224, 224),
    rand_crop=True, rand_mirror=True, brightness=0.4, contrast=0.4,
    saturation=0.4, pca_noise=0.1, mean=True, std=True)`` in float32 over
    1,024 raw 256² records (``raw_shape``), one epoch drained at
    ``preprocess_threads`` 1, 4 and 8: img/s against the rate 6c's step
    consumes; where OpenCV is installed, the same over the images as JPEG
    records (quality 95) at the most threads."""
    imgs, labels = raw_images(DATA_AUG_RECORDS, DATA_AUG_RAW, SEED + 22)
    prefix = os.path.join(tmp, "imagenet_256")
    write_records(mx, prefix, imgs, labels)
    try:
        import cv2
    except ImportError:
        cv2 = None
    runs = [("raw", threads, prefix) for threads in DATA_THREADS]
    if cv2 is not None:
        write_jpeg_records(mx, cv2, prefix + "_jpeg", imgs, labels)
        runs.append(("jpeg", DATA_THREADS[-1], prefix + "_jpeg"))
    del imgs
    rates = {}
    for kind, threads, path in runs:
        seeded()
        it = mx.io.ImageRecordIter(
            path_imgrec=path + ".rec", path_imgidx=path + ".idx",
            data_shape=IMAGENET_SHAPE, raw_shape=DATA_AUG_RAW,
            decode="raw" if kind == "raw" else "auto",
            batch_size=DATA_AUG_BATCH, shuffle=True, rand_crop=True,
            rand_mirror=True, brightness=0.4, contrast=0.4, saturation=0.4,
            pca_noise=0.1, mean=True, std=True, preprocess_threads=threads,
            prefetch_buffer=4, ctx=mx.cpu(0))
        first = it.next()
        x = first.data[0].asnumpy()
        check(x.dtype == np.float32 and x.shape == (DATA_AUG_BATCH,) +
              IMAGENET_SHAPE and np.isfinite(x).all() and
              abs(float(x.mean())) < 2.0, "12c: batch %s %s mean %r"
              % (x.dtype, x.shape, float(x.mean())))
        it.reset()
        count, secs = drain(it)
        check(count == DATA_AUG_RECORDS, "12c: %d images" % count)
        close_record_iter(it)
        rates["%s_%d" % (kind, threads)] = count / secs
        print("data 12c: the augmenting pipeline over %s 256² records (crop "
              "to 224², flip, color jitter, lighting, normalize; float32) at "
              "preprocess_threads %d: %d images in %.3f s, %.1f img/s (6c's "
              "step in this run consumes %.1f; PERF.md's 6c %.1f) | %s"
              % (kind, threads, count, secs, count / secs, step_img_s,
                 RESNET_TRAIN_BATCH / PHASE_6C_MS * 1e3, card), flush=True)
    return dict(img_per_s=rates, step_img_per_s=step_img_s)


def gluon_data_card_contracts(mx, card, n=DATA_GLUON_IMAGES,
                              size=DATA_GLUON_SIZE, crop=DATA_GLUON_CROP):
    """12d's card contracts: ToTensor, Normalize and Resize on card tensors
    against the CPU (the first two bit-equal, Resize within
    DATA_RESIZE_TOL); the transform pipeline through a DataLoader with
    ``num_workers=0`` from the same seeds over the images on the card and
    on the CPU (the same crops and flips, values at most one uint8 step
    apart, where the resize truncates to the other side); a DataLoader
    with two
    workers feeding a small net's steps inside ``mx.engine.bulk`` (recorded
    segments replayed as CUDA graphs while the workers copy batches to the
    card), losses and weights bit-equal to the eager steps."""
    import torch
    T = mx.gluon.data.vision.transforms
    imgs, labels = raw_images(n, (3, size, size), SEED + 23)
    gpu, cpu = mx.gpu(0), mx.cpu(0)
    img = imgs[0]
    on = {c.device_type: mx.nd.array(img, ctx=c, dtype="uint8")
          for c in (gpu, cpu)}
    exact = {}
    for what, t, x in (("ToTensor", T.ToTensor(), on),
                       ("Normalize", T.Normalize(*IMAGENET_MEAN_STD), {
                           k: T.ToTensor()(v) for k, v in on.items()})):
        g, c = t(x["gpu"]), t(x["cpu"])
        exact[what] = torch.equal(g._data.cpu(), c._data)
        check(exact[what], "12d: %s on the card differs from the CPU" % what)
    resize = {}
    for dtype in ("float32", "uint8"):
        src = {k: v.astype(dtype) for k, v in on.items()}
        g = T.Resize(crop)(src["gpu"]).asnumpy().astype(np.float64)
        c = T.Resize(crop)(src["cpu"]).asnumpy().astype(np.float64)
        resize[dtype] = (float(np.abs(g - c).max()),
                         float((g != c).mean()))
    check(resize["float32"][0] <= DATA_RESIZE_TOL and
          resize["uint8"][0] <= 1, "12d: Resize on the card against the "
          "CPU %s" % resize)

    def pipeline(ctx):
        ds = mx.gluon.data.ArrayDataset(
            mx.nd.array(imgs, ctx=ctx, dtype="uint8"), labels)
        return ds.transform_first(T.Compose([
            T.RandomResizedCrop(crop), T.RandomFlipLeftRight(), T.ToTensor(),
            T.Normalize(*IMAGENET_MEAN_STD)]))

    batches = {}
    for ctx in (gpu, cpu):
        seeded()
        loader = mx.gluon.data.DataLoader(pipeline(ctx), batch_size=max(
            n // 8, 1), shuffle=True, num_workers=0)
        batches[ctx.device_type] = [(x.asnumpy(), y.asnumpy())
                                    for x, y in loader]
    step = 1.0 / 255 / min(IMAGENET_MEAN_STD[1]) + 1e-6
    worst, apart = 0.0, 0
    for (gx, gy), (cx, cy) in zip(batches["gpu"], batches["cpu"]):
        check(np.array_equal(gy, cy) and gx.shape == cx.shape,
              "12d: the loaders' labels or shapes differ")
        d = np.abs(gx - cx)
        worst, apart = max(worst, float(d.max())), apart + int((d > 0).sum())
    total = sum(x.size for x, _ in batches["cpu"])
    check(worst <= step, "12d: the pipeline on the card and on the CPU: "
          "max diff %r, %d of %d apart" % (worst, apart, total))
    bulk = bulk_loader_contract(mx, torch)
    print("data 12d: on the card against the CPU: ToTensor and Normalize "
          "bit-equal, Resize %d² -> %d² f32 max diff %.3e (%.2e of values "
          "apart), uint8 max diff %.0f (%.2e apart); the transform pipeline "
          "(RandomResizedCrop, flip, ToTensor, Normalize) through "
          "DataLoader(num_workers=0) over %d images from the same seeds on "
          "the card and on the CPU: the same crops and flips, %d of %d "
          "values apart, max diff %.3e (one uint8 step %.3e); a "
          "DataLoader(num_workers=2) feeding %d steps inside "
          "mx.engine.bulk: losses and weights bit-equal to eager, %s | %s"
          % (size, crop, resize["float32"][0], resize["float32"][1],
             resize["uint8"][0], resize["uint8"][1], n, apart, total, worst,
             step, bulk["steps"], bulk["graphs"], card), flush=True)
    return dict(exact=exact, resize=resize, loader_max_diff=worst,
                loader_apart=apart, loader_values=total, bulk=bulk)


def bulk_loader_contract(mx, torch, steps_per_epoch=4, epochs=2):
    """A DataLoader with two worker threads (numpy samples: each batch
    made on the card by its worker) feeding an MLP's training steps inside
    ``mx.engine.bulk(BULK_WHOLE)`` on the card, against the same steps
    eagerly: losses and weights bit-equal."""
    rs = np.random.RandomState(SEED + 24)
    x = rs.standard_normal((steps_per_epoch * 32, 64)).astype(np.float32)
    y = rs.randint(0, 10, steps_per_epoch * 32).astype(np.float32)

    def run(bulk, workers):
        mx.random.seed(SEED)
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Dense(128, activation="relu", in_units=64),
                mx.gluon.nn.Dense(10, in_units=128))
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1, "momentum": 0.9})
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        loader = mx.gluon.data.DataLoader(mx.gluon.data.ArrayDataset(x, y),
                                          batch_size=32,
                                          num_workers=workers)
        losses = []
        for _ in range(epochs):
            for xb, yb in loader:
                with (mx.engine.bulk(BULK_WHOLE) if bulk else
                      contextlib.nullcontext()):
                    with mx.autograd.record():
                        loss = loss_fn(net(xb), yb)
                    loss.backward()
                    trainer.step(32)
                losses.append(loss._data.detach().clone())
        loader.close()
        return losses, [p.data()._data.detach().clone()
                        for p in net.collect_params().values()]

    with mx.gpu(0):             # the workers make each batch on the card
        eager = run(False, 0)
        mx.engine.reset_flush_stats()
        bulked = run(True, 2)
    graphs = mx.engine.flush_stats()["graphs"]
    check(all(torch.equal(a, b) for a, b in zip(bulked[0], eager[0])) and
          all(torch.equal(a, b) for a, b in zip(bulked[1], eager[1])),
          "12d: the bulked steps fed by DataLoader(num_workers=2) differ "
          "from the eager ones")
    return dict(steps=len(eager[0]), graphs=graphs)


def gluon_data_pipeline(mx, card):
    """Phase 12d: ``gluon.data`` at ImageNet's widths: an ArrayDataset of
    512 HWC uint8 256² images on the host through
    ``transform_first(Compose([RandomResizedCrop(224),
    RandomFlipLeftRight(), ToTensor(), Normalize(...)]))`` and
    ``DataLoader(batch_size=64, shuffle=True, num_workers=4)``: img/s over
    one epoch; then the card's contracts at the same widths."""
    T = mx.gluon.data.vision.transforms
    imgs, labels = raw_images(DATA_GLUON_IMAGES, (3, DATA_GLUON_SIZE,
                                                  DATA_GLUON_SIZE), SEED + 23)
    ds = mx.gluon.data.ArrayDataset(
        mx.nd.array(imgs, ctx=mx.cpu(0), dtype="uint8"), labels)
    ds = ds.transform_first(T.Compose([
        T.RandomResizedCrop(DATA_GLUON_CROP), T.RandomFlipLeftRight(),
        T.ToTensor(), T.Normalize(*IMAGENET_MEAN_STD)]))
    seeded()
    loader = mx.gluon.data.DataLoader(ds, batch_size=DATA_GLUON_BATCH,
                                      shuffle=True,
                                      num_workers=DATA_GLUON_WORKERS)
    with mx.cpu(0):
        count, secs = drain(loader)
    loader.close()
    check(count == DATA_GLUON_IMAGES, "12d: %d images" % count)
    print("data 12d: gluon.data pipeline over %d HWC uint8 %d² images "
          "(RandomResizedCrop(%d), RandomFlipLeftRight, ToTensor, Normalize; "
          "DataLoader batch %d, shuffle, num_workers %d): %.3f s, %.1f img/s "
          "| %s" % (count, DATA_GLUON_SIZE, DATA_GLUON_CROP, DATA_GLUON_BATCH,
                    DATA_GLUON_WORKERS, secs, count / secs, card), flush=True)
    return dict(img_per_s=count / secs, seconds=secs,
                contracts=gluon_data_card_contracts(mx, card))


def lm_from_loader(mx, card):
    """Phase 12e: the full-width LM (bf16, 8 x 1024, the weights of two
    copies equal) trained LM_LOADER_STEPS steps through ``gluon.Trainer``
    (sgd with momentum, multi_precision), one copy fed by
    ``DataLoader(ArrayDataset(tokens, labels), batch_size=8,
    num_workers=2)``, the other the same arrays directly, with torch's
    deterministic algorithms: the losses equal step by step; B1's forward
    and backward kernel counters (zeroed just before the loader-fed steps,
    read just after) at one launch a layer a step each, none through the
    torch-ops backward."""
    import torch
    from incubator_mxnet_tpu_torch.models import TransformerLM
    from incubator_mxnet_tpu_torch.ops.attention import flash_attention
    cfg, batch, steps = LM_CONFIG, TRAIN_BATCH, LM_LOADER_STEPS
    ctx = mx.gpu(0)
    t0 = time.perf_counter()
    mx.random.seed(SEED)
    rs = np.random.RandomState(SEED + 25)
    tokens = rs.randint(0, cfg["vocab"], (batch * steps, cfg["seq_len"]))
    labels = rs.randint(0, cfg["vocab"], (batch * steps, cfg["seq_len"])
                        ).astype(np.float32)
    nets = []
    for _ in range(2):
        net = TransformerLM(**cfg)
        net.initialize(mx.init.Xavier(rnd_type="gaussian"), ctx=ctx)
        nets.append(net)
    probe = mx.nd.array(tokens[:batch], ctx=ctx, dtype="int32")
    with mx.autograd.predict_mode():
        for net in nets:
            net(probe)                      # resolves the deferred shapes
    a, b = nets
    pa, pb = list(a.collect_params().values()), \
        list(b.collect_params().values())
    with torch.no_grad():
        for p, q in zip(pb, pa):
            p.data()._data.copy_(q.data()._data)
    for net in nets:
        net.cast("bfloat16")
    trainers = [mx.gluon.Trainer(net.collect_params(), "sgd",
                                 dict(LM_STORE_OPT)) for net in nets]
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def step(net, trainer, x, y):
        with mx.autograd.record():
            loss = loss_fn(net(x).astype("float32"), y)
        loss.backward()
        trainer.step(batch)
        return float(loss.mean().asscalar())

    loader = mx.gluon.data.DataLoader(
        mx.gluon.data.ArrayDataset(tokens, labels), batch_size=batch,
        num_workers=2)
    built_s = time.perf_counter() - t0
    counters = ("launches", "backward_kernel_launches",
                "backward_torch_calls", "backward_calls")
    got, want, ms, dtypes = [], [], [], None
    with deterministic_kernels(torch):
        torch.cuda.synchronize()
        for c in counters:
            setattr(flash_attention, c, 0)
        for i, (x, y) in enumerate(loader):
            dtypes = (str(x.dtype), str(y.dtype), x.context)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got.append(step(a, trainers[0], x, y))
            ms.append((time.perf_counter() - t1) * 1e3)
        launches = {c: getattr(flash_attention, c) for c in counters}
        for i in range(steps):
            sl = slice(i * batch, (i + 1) * batch)
            want.append(step(b, trainers[1],
                             mx.nd.array(tokens[sl], ctx=ctx, dtype="int32"),
                             mx.nd.array(labels[sl], ctx=ctx)))
    loader.close()
    expected = cfg["n_layers"] * steps
    print("data 12e: TransformerLM %s in bf16 (gluon.Trainer sgd %s) fed by "
          "DataLoader(ArrayDataset(tokens, labels), batch_size %d, "
          "num_workers 2; batches %s), built in %.1f s: %d steps %s ms, "
          "losses %s; the same steps fed the arrays directly: losses %s; "
          "flash counters in the loader-fed steps %s (%d layers) | %s"
          % (cfg, LM_STORE_OPT, batch, dtypes, built_s, len(got),
             ["%.3f" % v for v in ms], ["%.6f" % v for v in got],
             ["%.6f" % v for v in want], launches, cfg["n_layers"], card),
          flush=True)
    check(len(got) == steps and got == want and
          all(math.isfinite(v) for v in got), "12e: the loader-fed losses "
          "%s differ from the direct ones %s" % (got, want))
    check(launches["launches"] == expected and
          launches["backward_kernel_launches"] == expected and
          launches["backward_calls"] == expected and
          launches["backward_torch_calls"] == 0,
          "12e: flash counters %s, expected %d forward and backward kernel "
          "launches and no torch-ops backward" % (launches, expected))
    del a, b, nets, trainers, pa, pb, probe
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=got, direct_losses=want, step_ms=ms,
                launches=launches, built_s=built_s)


def data_phase(mx, card, c6, c10):
    """Phase 12: 12a-12e over records written into a directory under the
    checkout's ``build/`` (removed after); ``c6`` and ``c10`` are 6c's and
    10c's ResNet-50 results of this run."""
    import tempfile
    import torch
    from incubator_mxnet_tpu_torch import cuda_build
    t12 = time.perf_counter()
    cuda_build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="data-", dir=str(cuda_build.BUILD_DIR.parent))
    try:
        out = dict(contracts=data_card_contracts(mx, card, tmp))
        out["records"] = record_pipeline(mx, card, tmp, c10)
        out["augment"] = augment_pipeline(
            mx, card, tmp, RESNET_TRAIN_BATCH / c6["step_ms_mean"] * 1e3)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["gluon"] = gluon_data_pipeline(mx, card)
    out["lm"] = lm_from_loader(mx, card)
    print("data: not driven on the card (the CPU tests hold them against "
          "the JAX build): %s" % (DATA_NOT_DRIVEN if out["contracts"]["opencv"]
                                  else "OpenCV is not installed: "
                                  + DATA_NO_CV2), flush=True)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t12
    print("data: phase 12 in %.1f s | %s" % (out["seconds"], card),
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 13: the RNN family: the fused RNN op over cuDNN against its plain
# loop, bench_lstm.py's WordLM trained and served at full width, word_lm.py's
# loop, CTCLoss at a speech-like size, an LSTM encoder under B1, and mx.rnn
# through BucketingModule (no hand kernel of its own: cuDNN, as MXNet's GPU
# path; B1's forward and backward run in 13f)
# ---------------------------------------------------------------------------
RNN_MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")
RNN_SMALL = (7, 3, 5, 4)                    # T, N, I, H
RNN_BENCH = (128, 256, 512, 512)            # bench_lstm.py's shape
# 13a's cases: every mode at the small shape, the gated ones at the bench
# shape.  A relu or tanh recurrence over 128 steps amplifies rounding past
# these bounds in every implementation (the plain loop too), and relu's
# steps flip by the thousands there; rnn_route_readings prints those cases
RNN_CASES = ((RNN_SMALL, RNN_MODES, ("float32", "bfloat16", "float16")),
             (RNN_BENCH, ("lstm", "gru"), ("float32", "bfloat16")))
# bound on max|route - oracle| / max(1, max|oracle|) for each array, the
# oracle the plain loop in f64 on the same values.  rnn_relu in 16 bits: its
# derivative is a step at 0, and the 16-bit rounding of the same values can
# put a pre-activation on the other side of 0 from the f64 run, which moves
# that gradient by O(1) in any 16-bit implementation; so its gradients are
# held to the plain loop in its own dtype (the same rounded values), its
# forward arrays still to the f64 loop
RNN_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 5e-3}
RNN_TIMING_REPS = 10
# bench_lstm.py:29-35 and :56-60 (its defaults) and word_lm.py's defaults
WORD_LM = dict(vocab=10000, embed=512, hidden=512, layers=2, seq=128,
               batch=256, lr=0.5)
WORD_LM_SMALL = dict(vocab=200, embed=32, hidden=32, layers=2, seq=16,
                     batch=8, lr=0.5)
WORD_LM_WARMUP, WORD_LM_STEPS, WORD_LM_SMALL_STEPS = 3, 10, 3
WORD_LM_SERVE_BATCH = 32
WORD_LM_LOOP = dict(embed=64, hidden=128, layers=2, bptt=32, batch=32,
                    epochs=6, lr=0.003, corpus=20000)
CTC_SHAPE = (200, 32, 29)                   # T, N, C (28 letters + blank)
CTC_LABEL_LENGTHS = (20, 50)
CTC_EMPTY = 4                               # samples with an empty label
CTC_TOL = 1e-4
RNN_ENCODER = dict(vocab=10000, embed=512, hidden=512, heads=8, seq=256,
                   batch=8, steps=3, lr=0.05)
BUCKET_LM = dict(vocab=1000, embed=256, hidden=512, layers=2, batch=32,
                 buckets=(16, 32, 48), sentences=384, lr=0.01, epochs=4)
# the CPU's fit beside the card's from the same weights and batches: the
# perplexity after each batch within 1e-3 relative (the two devices' f32
# sums differ in order; adam amplifies that to ~3e-5 in an epoch)
BUCKET_WITNESS_EPOCHS, BUCKET_WITNESS_TOL = 1, 1e-3


def rnn_bound_ms(shape, layers, dirs, gates, itemsize, peak, passes=1):
    """The least time of a fused recurrent stack over (T, N, I, H): its
    products (2·T·N·gates·H·(I + H) flop a layer and direction; ``passes``
    3 for a forward and backward) at ``peak``, against reading the data,
    states and weights and writing the outputs and states once at 3.35
    TB/s.  (ms, "operations" or "bytes", flop, bytes)."""
    t, n, i, h = shape
    flop, weights = 0.0, 0
    for layer in range(layers):
        in_dim = i if layer == 0 else dirs * h
        flop += dirs * 2.0 * t * n * gates * h * (in_dim + h)
        weights += dirs * gates * h * (in_dim + h + 2)
    elems = t * n * i + weights + 4 * layers * dirs * n * h + \
        t * n * dirs * h
    nbytes = passes * elems * itemsize
    ops_ms = passes * flop / peak * 1e3
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms
            else "bytes", passes * flop, nbytes)


def _rnn_case_inputs(rnn_ops, mode, bidirectional, dtype, shape, dev, seed):
    import torch
    t, n, i, h = shape
    params = dict(state_size=h, num_layers=2, bidirectional=bidirectional,
                  mode=mode)
    shapes = rnn_ops._rnn_param_shapes((t, n, i), params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    inputs = []
    for name in rnn_ops._rnn_argnames(params):
        scale = 1.0 if name in ("data", "state", "state_cell") else \
            1.0 / math.sqrt(h)
        s = (t, n, i) if name == "data" else shapes[name]
        inputs.append((torch.randn(s, generator=gen, device=dev) * scale).to(
            getattr(torch, dtype)))
    return inputs, params, gen


def _rel_err(got, want):
    want = want.detach().double()
    return float((got.detach().double() - want).abs().max()) / max(
        1.0, float(want.abs().max()))


def rnn_route_case(mx, mode, bidirectional, dtype, shape, seed=SEED):
    """13a: one case of the fused op on CUDA tensors: the op's route (cuDNN
    for a dtype it takes), the plain loop in the same dtype and the plain
    loop in f64 on the same values: out, hy, cy and the gradients of data,
    states and every weight for the same random head gradients.  Each
    array is held to RNN_TOL against its oracle (the f64 loop; the
    same-dtype loop for rnn_relu's gradients in 16 bits); the errors
    against both loops are returned, with the cuDNN calls the op made."""
    import torch
    from incubator_mxnet_tpu_torch.ops import rnn as rnn_ops
    dev = mx.gpu(0).torch_device()
    inputs, params, gen = _rnn_case_inputs(rnn_ops, mode, bidirectional,
                                           dtype, shape, dev, seed)
    heads = None

    def run(fn, xs):
        nonlocal heads
        leaves = [x.detach().requires_grad_() for x in xs]
        outs = fn(*leaves, **params)
        if heads is None:
            heads = [torch.randn(o.shape, generator=gen, device=dev)
                     for o in outs]
        pairs = [(o, g.to(o.dtype)) for o, g in zip(outs, heads)
                 if o.requires_grad]
        torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
        return [o.detach() for o in outs] + [x.grad for x in leaves]

    before = (rnn_ops.rnn_op.cudnn_calls, rnn_ops.rnn_op.plain_calls)
    got = run(rnn_ops.rnn_op, inputs)
    calls = (rnn_ops.rnn_op.cudnn_calls - before[0],
             rnn_ops.rnn_op.plain_calls - before[1])
    plain = run(rnn_ops._rnn_reference, inputs)
    f64 = run(rnn_ops._rnn_reference, [x.double() for x in inputs])
    names = ["out", "hy", "cy"] + ["d_" + k for k in
                                   rnn_ops._rnn_argnames(params)]
    same_dtype = mode == "rnn_relu" and dtype != "float32"
    errs, oracle = {}, {}
    for k, g, p_, o in zip(names, got, plain, f64):
        if k == "cy" and mode != "lstm":
            continue
        errs[k] = dict(f64=_rel_err(g, o), plain=_rel_err(g, p_),
                       plain_f64=_rel_err(p_, o))
        oracle[k] = "plain" if same_dtype and k.startswith("d_") else "f64"
    held = {k: errs[k][oracle[k]] for k in errs}
    worst = max(held, key=held.get)
    return dict(mode=mode, bidirectional=bidirectional, dtype=dtype,
                shape=shape, route=rnn_ops._route(inputs[0]),
                calls=dict(cudnn=calls[0], plain=calls[1]),
                max_abs_err=max(held.values()), worst=worst,
                worst_oracle=oracle[worst], bound=RNN_TOL[dtype],
                ok=max(held.values()) <= RNN_TOL[dtype], errs=errs,
                readings={w: max(v[w] for v in errs.values())
                          for w in ("f64", "plain_f64", "plain")})


def rnn_route_readings(mx, card):
    """13a's readings where it holds no bound (run alone: python3 -c
    "import chip_smoke as cs, incubator_mxnet_tpu_torch as mx;
    cs.rnn_route_readings(mx, cs.card_line())"): rnn_tanh and rnn_relu at
    bench_lstm.py's shape in f32 and bf16, each array's distance from the
    f64 loop on the route and on the same-dtype plain loop, and the
    route's from that loop."""
    for dtype in ("float32", "bfloat16"):
        for mode in ("rnn_tanh", "rnn_relu"):
            for bidirectional in (False, True):
                row = rnn_route_case(mx, mode, bidirectional, dtype,
                                     RNN_BENCH)
                fwd = [k for k in row["errs"] if not k.startswith("d_")]
                top = {which: (max(row["errs"][k][which] for k in fwd),
                               max(v[which] for v in row["errs"].values()))
                       for which in ("f64", "plain_f64", "plain")}
                print("rnn 13a reading: %s %s %s 2 layers at (T, N, I, H) "
                      "%s, route %s %s: largest error (forward arrays; all "
                      "arrays) of the route against the f64 loop %.3e; "
                      "%.3e, of the plain %s loop against it %.3e; %.3e, "
                      "of the route against the plain %s loop %.3e; %.3e "
                      "| %s" % (mode, "bidirectional" if bidirectional else
                                "unidirectional", dtype, RNN_BENCH,
                                row["route"], row["calls"], *top["f64"],
                                dtype, *top["plain_f64"], dtype,
                                *top["plain"], card), flush=True)


def rnn_timing(mx, dtype, card, shape=RNN_BENCH):
    """13a's timing at bench_lstm.py's shape: the 2-layer LSTM's cuDNN route
    and plain loop, forward and forward+backward, by CUDA events, beside
    the bound of the work; and what cuDNN's copy of the separate weights
    into its flat buffer costs a call (the same forward with a buffer
    flattened once)."""
    import torch
    from incubator_mxnet_tpu_torch.ops import rnn as rnn_ops
    dev = mx.gpu(0).torch_device()
    inputs, params, gen = _rnn_case_inputs(rnn_ops, "lstm", False, dtype,
                                           shape, dev, SEED + 1)
    leaves = [x.detach().requires_grad_() for x in inputs]
    head = torch.randn(shape[:2] + (shape[3],), generator=gen,
                       device=dev).to(inputs[0].dtype)

    def fwd(fn):
        with torch.no_grad():
            fn(*inputs, **params)

    def fwd_bwd(fn):
        out = fn(*leaves, **params)[0]
        out.backward(head)

    reps = RNN_TIMING_REPS
    t = dict(cudnn_fwd_ms=cuda_ms(lambda: fwd(rnn_ops.rnn_op), reps, torch),
             plain_fwd_ms=cuda_ms(lambda: fwd(rnn_ops._rnn_reference), 3,
                                  torch),
             cudnn_fwd_bwd_ms=cuda_ms(lambda: fwd_bwd(rnn_ops.rnn_op), reps,
                                      torch),
             plain_fwd_bwd_ms=cuda_ms(lambda: fwd_bwd(
                 rnn_ops._rnn_reference), 3, torch))
    # one layer through cuDNN as the op calls it (weights copied into a
    # flat buffer each call) and with a buffer flattened once
    t_, n_, i_, h_ = shape
    w = [x.detach().clone() for x in inputs[3:3 + 2]] + \
        [x.detach().clone() for x in inputs[3 + 4:3 + 6]]
    x0, h0, c0 = inputs[0], inputs[1][:1].contiguous(), \
        inputs[2][:1].contiguous()
    buf = torch._cudnn_rnn_flatten_weight(w, 4, i_, 2, h_, 0, 1, False,
                                          False)

    def layer(weight_buf):
        with torch.no_grad():
            torch._cudnn_rnn(x0, w, 4, weight_buf, h0, c0, 2, h_, 0, 1,
                             False, 0.0, False, False, [], None)

    t["layer_copy_ms"] = cuda_ms(lambda: layer(None), reps, torch)
    t["layer_flat_ms"] = cuda_ms(lambda: layer(buf), reps, torch)
    t["weight_copy_ms"] = t["layer_copy_ms"] - t["layer_flat_ms"]
    itemsize = inputs[0].element_size()
    peak = H100_BF16_FLOPS if dtype == "bfloat16" else \
        H100_F32_CUDA_CORE_FLOPS
    for passes, key in ((1, "fwd"), (3, "fwd_bwd")):
        ms, by, flop, nbytes = rnn_bound_ms(shape, 2, 1, 4, itemsize, peak,
                                            passes)
        t["bound_%s_ms" % key], t["bound_%s_by" % key] = ms, by
        t["flop_%s" % key], t["bytes_%s" % key] = flop, nbytes
    print("rnn 13a: timing LSTM 2 layers at (T, N, I, H) %s %s: cuDNN "
          "forward %.4f ms, forward+backward %.4f ms; plain loop forward "
          "%.4f ms, forward+backward %.4f ms; bound forward %.4f ms (%s: "
          "%.3e flop at %.0f TFLOP/s, %.3e bytes at 3.35 TB/s), "
          "forward+backward %.4f ms (%s); one layer's forward %.4f ms with "
          "the weights copied into cuDNN's buffer (the op), %.4f ms from a "
          "buffer flattened once: the copy %.4f ms a call | %s"
          % (shape, dtype, t["cudnn_fwd_ms"], t["cudnn_fwd_bwd_ms"],
             t["plain_fwd_ms"], t["plain_fwd_bwd_ms"], t["bound_fwd_ms"],
             t["bound_fwd_by"], t["flop_fwd"], peak / 1e12, t["bytes_fwd"],
             t["bound_fwd_bwd_ms"], t["bound_fwd_bwd_by"],
             t["layer_copy_ms"], t["layer_flat_ms"], t["weight_copy_ms"],
             card), flush=True)
    return t


def rnn_card_contracts(mx, card):
    """13a's contracts: TF32 stays off inside an f32 call (and the caller's
    switch comes back), ``record(train_mode=False)`` then ``backward()``
    through cuDNN, and a gluon.rnn.LSTM inside ``mx.engine.bulk`` (its
    neighbours deferred into a captured graph, the RNN op not deferrable)
    bit-equal to eager."""
    import torch
    from incubator_mxnet_tpu_torch.ops import rnn as rnn_ops
    dev = mx.gpu(0).torch_device()
    out = {}
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True          # torch's default
    try:
        row = rnn_route_case(mx, "lstm", True, "float32", RNN_BENCH)
        out["tf32_on_caller"] = dict(max_abs_err=row["max_abs_err"],
                                     worst=row["worst"], ok=row["ok"])
        check(torch.backends.cudnn.allow_tf32,
              "13a: the caller's TF32 switch did not come back")
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    check(out["tf32_on_caller"]["max_abs_err"] <= RNN_TOL["float32"],
          "13a: f32 with the caller's TF32 on: %s" % out["tf32_on_caller"])

    inputs, params, _ = _rnn_case_inputs(rnn_ops, "lstm", True, "float32",
                                         RNN_SMALL, dev, SEED + 2)
    nds = [mx.nd.array(x.cpu().numpy(), ctx=mx.gpu(0)) for x in inputs]
    cpu = [mx.nd.array(x.cpu().numpy(), ctx=mx.cpu()) for x in inputs]
    for a in nds + cpu:
        a.attach_grad()
    before = rnn_ops.rnn_op.cudnn_calls
    with mx.autograd.record(train_mode=False):
        y = mx.nd.RNN(*nds, **params)
    y.backward()
    with mx.autograd.record(train_mode=False):
        y_cpu = mx.nd.RNN(*cpu, **params)
    y_cpu.backward()
    err = max(_rel_err(a.grad._data, b.grad._data.to(dev))
              for a, b in zip(nds, cpu))
    out["inference_record_backward"] = dict(
        cudnn_calls=rnn_ops.rnn_op.cudnn_calls - before, max_abs_err=err)
    check(out["inference_record_backward"]["cudnn_calls"] == 2 and
          err <= RNN_TOL["float32"], "13a: record(train_mode=False) and "
          "backward on the card: %s" % out["inference_record_backward"])
    layer = mx.gluon.rnn.LSTM(64, num_layers=2, layout="NTC", input_size=32)
    layer.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    x = mx.nd.array(np.random.RandomState(SEED).standard_normal(
        (16, 24, 32)).astype(np.float32), ctx=mx.gpu(0))
    want = (layer(x * 2.0) + 1.0).asnumpy()
    mx.engine.reset_flush_stats()
    with mx.engine.bulk(64):
        got = layer(x * 2.0) + 1.0
    got = got.asnumpy()
    stats = mx.engine.flush_stats()
    out["bulk"] = dict(bit_equal=bool(np.array_equal(got, want)),
                       flushes=stats["causes"], graphs=stats["graphs"])
    check(out["bulk"]["bit_equal"], "13a: the LSTM inside mx.engine.bulk "
          "differs from eager: %s" % out["bulk"])
    print("rnn 13a: contracts %s | %s" % (json.dumps(out), card), flush=True)
    return out


def word_lm_net(mx, vocab, embed, hidden, layers):
    """bench_lstm.py:40-52's WordLM (and word_lm.py:55-65's) in the port."""
    gluon, nn, rnn = mx.gluon, mx.gluon.nn, mx.gluon.rnn

    class WordLM(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.embed = nn.Embedding(vocab, embed)
                self.lstm = rnn.LSTM(hidden, num_layers=layers,
                                     layout="NTC", input_size=embed)
                self.proj = nn.Dense(vocab, flatten=False, in_units=hidden)

        def hybrid_forward(self, F, x):
            return self.proj(self.lstm(self.embed(x)))

    return WordLM()


def word_lm_flops(cfg, tokens):
    """3 × (2·T·N·4H·(I + H) a layer + 2·T·N·H·V): the LSTM's and the
    projection's products, forward and backward (the embedding's gather
    and the elementwise gates not counted)."""
    h, layers = cfg["hidden"], cfg["layers"]
    per = sum(2.0 * tokens * 4 * h * ((cfg["embed"] if i == 0 else h) + h)
              for i in range(layers))
    return 3 * (per + 2.0 * tokens * h * cfg["vocab"])


def word_lm_small(mx, card):
    """13b's small net (WORD_LM_SMALL, f32) trained WORD_LM_SMALL_STEPS
    steps through DataParallelTrainer on the card and on the CPU from the
    same weights: losses and weights within 1e-4."""
    import torch
    from incubator_mxnet_tpu_torch.convert import numpy_params
    cfg = WORD_LM_SMALL
    rs = np.random.RandomState(SEED + 3)
    shape = (WORD_LM_SMALL_STEPS, cfg["batch"], cfg["seq"])
    xs = rs.randint(0, cfg["vocab"], shape)
    ys = rs.randint(0, cfg["vocab"], shape).astype(np.float32)
    runs = []
    weights = None
    for ctx in (mx.gpu(0), mx.cpu()):
        net = word_lm_net(mx, cfg["vocab"], cfg["embed"], cfg["hidden"],
                          cfg["layers"])
        net.initialize(mx.init.Xavier(), ctx=ctx)
        if weights is None:
            weights = list(numpy_params(net).values())
        else:      # another prefix, the same parameters in the same order
            for p, w in zip(net.collect_params().values(), weights):
                p.set_data(mx.nd.array(w, ctx=ctx))
        tr = mx.parallel.DataParallelTrainer(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": cfg["lr"]})
        losses = [float(tr.step(mx.nd.array(x, ctx=ctx, dtype="int32"),
                                mx.nd.array(y, ctx=ctx)).asnumpy())
                  for x, y in zip(xs, ys)]
        tr.sync_params()
        runs.append((losses, list(numpy_params(net).values())))
    (gl, gw), (cl, cw) = runs
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    weight_err = max(float(np.abs(g - c).max()) / max(
        1.0, float(np.abs(c).max())) for g, c in zip(gw, cw))
    print("rnn 13b: WordLM %s f32, %d DataParallelTrainer steps on the card "
          "against the CPU from the same weights: losses %s vs %s, worst "
          "loss error %.3e relative, worst weight error %.3e (bound 1e-4) "
          "| %s" % (cfg, WORD_LM_SMALL_STEPS, ["%.6f" % v for v in gl],
                    ["%.6f" % v for v in cl], loss_err, weight_err, card),
          flush=True)
    check(loss_err <= 1e-4 and weight_err <= 1e-4, "13b: the small WordLM "
          "on the card differs from the CPU")
    torch.cuda.synchronize()
    return dict(losses=gl, cpu_losses=cl, loss_err=loss_err,
                weight_err=weight_err)


def word_lm_train(mx, card):
    """13b at full width: bench_lstm.py's step (DataParallelTrainer, sgd at
    lr 0.5, bf16 compute with f32 master weights) on its shape, then one
    step under the profiler (device time by kernel group); returns the
    trained net for 13c."""
    import torch
    from incubator_mxnet_tpu_torch.ops import rnn as rnn_ops
    cfg = WORD_LM
    t0 = time.perf_counter()
    mx.random.seed(SEED)
    net = word_lm_net(mx, cfg["vocab"], cfg["embed"], cfg["hidden"],
                      cfg["layers"])
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    rs = np.random.RandomState(0)
    x = mx.nd.array(rs.randint(0, cfg["vocab"], (cfg["batch"], cfg["seq"])),
                    ctx=mx.gpu(0), dtype="int32")
    y = mx.nd.array(rs.randint(0, cfg["vocab"], (cfg["batch"], cfg["seq"]))
                    .astype(np.float32), ctx=mx.gpu(0))
    trainer = mx.parallel.DataParallelTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        {"learning_rate": cfg["lr"]}, dtype="bfloat16")
    losses, step_ms = [], []
    for i in range(WORD_LM_WARMUP + WORD_LM_STEPS):
        if i == WORD_LM_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            rnn_ops.rnn_op.cudnn_calls = rnn_ops.rnn_op.plain_calls = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(float(trainer.step(x, y).asnumpy()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    calls = dict(cudnn=rnn_ops.rnn_op.cudnn_calls,
                 plain=rnn_ops.rnn_op.plain_calls)
    peak = torch.cuda.max_memory_allocated()
    tokens = cfg["batch"] * cfg["seq"]
    timed = step_ms[WORD_LM_WARMUP:]
    mean_s = sum(timed) / len(timed) / 1e3
    flops = word_lm_flops(cfg, tokens)
    n_params = sum(int(np.prod(p.shape)) for p in
                   net.collect_params().values())
    result = dict(n_params=n_params, step_ms=timed,
                  step_ms_mean=mean_s * 1e3, tokens_per_s=tokens / mean_s,
                  mfu=flops / mean_s / H100_BF16_FLOPS,
                  model_flops_per_step=flops, peak_memory_bytes=peak,
                  losses=losses, calls=calls,
                  built_s=time.perf_counter() - t0 - sum(step_ms) / 1e3)
    for i, (ms, loss) in enumerate(zip(step_ms, losses)):
        print("rnn 13b: step %d%s: %.3f ms, loss %.6f | %s"
              % (i, " (warm-up)" if i < WORD_LM_WARMUP else "", ms, loss,
                 card))
    print("rnn 13b: WordLM %s (%d parameters), DataParallelTrainer sgd, "
          "bf16 compute: %d timed steps, mean %.3f ms, %.1f tokens/s, MFU "
          "%.4f (%.4e flop a step: 3 x (2·T·N·4H·(I+H) a layer + "
          "2·T·N·H·V), over 989 TFLOP/s), peak memory allocated %d bytes; "
          "RNN op routes in the timed steps %s | %s"
          % (cfg, n_params, WORD_LM_STEPS, result["step_ms_mean"],
             result["tokens_per_s"], result["mfu"], flops, peak, calls,
             card), flush=True)
    check(all(math.isfinite(v) for v in losses), "13b: loss not finite: %s"
          % losses)
    check(losses[-1] < losses[0], "13b: loss did not fall: %s" % losses)
    check(calls["cudnn"] == cfg["layers"] * WORD_LM_STEPS and
          calls["plain"] == 0, "13b: RNN routes %s, expected %d cuDNN calls"
          % (calls, cfg["layers"] * WORD_LM_STEPS))
    profile_device(lambda: trainer.step(x, y).asnumpy(), "one WordLM step",
                   {"cudnn_rnn": "rnn", "cudnn_lstm": "lstm"}, flops, card)
    trainer.sync_params()
    del trainer, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return net, result


def word_lm_serve(mx, net, card):
    """13c: the trained full-width net in bf16 answering requests of
    WORD_LM_SERVE_BATCH x seq tokens with nothing recorded: request ms,
    tokens/s, and one request under the profiler (device busy time)."""
    import torch
    cfg = WORD_LM
    net.cast("bfloat16")
    net.collect_params().setattr("grad_req", "null")
    rs = np.random.RandomState(SEED + 4)
    x = mx.nd.array(rs.randint(0, cfg["vocab"], (WORD_LM_SERVE_BATCH,
                                                 cfg["seq"])),
                    ctx=mx.gpu(0), dtype="int32")

    def request():
        with mx.autograd.predict_mode():
            logits = net(x)
        logits.wait_to_read()
        return logits

    request()
    ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = request()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    tokens = WORD_LM_SERVE_BATCH * cfg["seq"]
    check(out.shape == (WORD_LM_SERVE_BATCH, cfg["seq"], cfg["vocab"]) and
          bool(torch.isfinite(out._data).all()), "13c: logits %s not finite"
          " or of the wrong shape" % (out.shape,))
    prof, wall_us = profiled(request)
    busy_us = sum(us for us, _ in trace_kernels(prof).values())
    mean = sum(ms) / len(ms)
    result = dict(request_ms=ms, request_ms_mean=mean,
                  tokens_per_s=tokens / mean * 1e3,
                  device_busy_ms=busy_us / 1e3 if busy_us else None,
                  profiled_wall_ms=wall_us / 1e3)
    print("rnn 13c: WordLM bf16 forward, %d x %d tokens, nothing recorded: "
          "requests %s ms (mean %.3f), %.1f tokens/s; under the profiler "
          "device busy %s ms of %.3f ms wall | %s"
          % (WORD_LM_SERVE_BATCH, cfg["seq"], ["%.3f" % v for v in ms], mean,
             result["tokens_per_s"], "%.3f" % result["device_busy_ms"]
             if busy_us else "not measured", wall_us / 1e3, card),
          flush=True)
    return result


def synth_corpus(n, seed=0):
    """word_lm.py:33-44's Markov-chain characters over 26 symbols."""
    rs = np.random.RandomState(seed)
    trans = rs.dirichlet(np.ones(26) * 0.2, size=26)
    out = np.zeros(n, np.int64)
    s = 0
    for i in range(n):
        s = rs.choice(26, p=trans[s])
        out[i] = s
    return out, 26


def word_lm_loop(mx, card):
    """13d: word_lm.py:64-136 at its defaults on the card: gluon.Trainer
    adam, the LSTM's state carried across BPTT windows and detached each
    step, WORD_LM_LOOP epochs; the final perplexity below the unigram one
    (tests/test_examples.py:93-101)."""
    cfg = WORD_LM_LOOP
    t0 = time.perf_counter()
    mx.random.seed(1)
    corpus, vocab = synth_corpus(cfg["corpus"])
    per_row = len(corpus) // cfg["batch"]
    trimmed = corpus[:per_row * cfg["batch"]].reshape(cfg["batch"], per_row)
    nwin = (per_row - 1) // cfg["bptt"]
    bptt = cfg["bptt"]
    xs = [trimmed[:, i * bptt:(i + 1) * bptt] for i in range(nwin)]
    ys = [trimmed[:, i * bptt + 1:(i + 1) * bptt + 1] for i in range(nwin)]
    net = word_lm_net(mx, vocab, cfg["embed"], cfg["hidden"], cfg["layers"])
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tr = mx.gluon.Trainer(net.collect_params(), "adam",
                          {"learning_rate": cfg["lr"]})
    ppl = []
    for _ in range(cfg["epochs"]):
        state, total = None, 0.0
        for x, y in zip(xs, ys):
            xb = mx.nd.array(x.astype(np.float32), ctx=mx.gpu(0))
            yb = mx.nd.array(y.astype(np.float32), ctx=mx.gpu(0))
            if state is None:
                state = net.lstm.begin_state(x.shape[0], ctx=mx.gpu(0))
            with mx.autograd.record():
                out, new_state = net.lstm(net.embed(xb), state)
                loss = loss_fn(net.proj(out), yb)
            loss.backward()
            tr.step(x.shape[0])
            state = [s.detach() for s in new_state]
            total += float(loss.asnumpy().mean())
        ppl.append(math.exp(min(total / nwin, 20)))
    counts = np.bincount(corpus, minlength=vocab).astype(np.float64)
    p = counts / counts.sum()
    unigram = math.exp(-(p[p > 0] * np.log(p[p > 0])).sum())
    seconds = time.perf_counter() - t0
    print("rnn 13d: word_lm.py's loop %s, %d windows an epoch: perplexity "
          "by epoch %s, unigram %.4f, %.1f s | %s"
          % (cfg, nwin, ["%.4f" % v for v in ppl], unigram, seconds, card),
          flush=True)
    check(ppl[-1] < unigram, "13d: final perplexity %.4f not below the "
          "unigram %.4f" % (ppl[-1], unigram))
    return dict(perplexity=ppl, unigram=unigram, seconds=seconds,
                windows=nwin)


def ctc_on_card(mx, card):
    """13e: CTCLoss at CTC_SHAPE with labels of CTC_LABEL_LENGTHS tokens and
    CTC_EMPTY empty ones: the card's loss and data gradient against the
    CPU's in f32, each within CTC_TOL relative, and the card's loss against
    the CPU in f64 within CTC_TOL.  The data gradient's distance from the
    CPU in f64 is a reading, printed beside the CPU's own in f32 (a long
    label's log-space sums lose ~4e-4 in f32 on either device); and the
    card's forward+backward time."""
    import torch
    t, n, c = CTC_SHAPE
    rs = np.random.RandomState(SEED + 5)
    data = rs.standard_normal((t, n, c)).astype(np.float32)
    lengths = rs.randint(CTC_LABEL_LENGTHS[0], CTC_LABEL_LENGTHS[1] + 1, n)
    lengths[:CTC_EMPTY] = 0
    label = np.zeros((n, CTC_LABEL_LENGTHS[1]), np.float32)
    for i, k in enumerate(lengths):
        label[i, :k] = rs.randint(1, c, k)
    res = {}
    for name, ctx, dtype in (("card", mx.gpu(0), "float32"),
                             ("cpu", mx.cpu(), "float32"),
                             ("cpu_f64", mx.cpu(), "float64")):
        d = mx.nd.array(data, ctx=ctx, dtype=dtype)
        lab = mx.nd.array(label, ctx=ctx)
        d.attach_grad()
        with mx.autograd.record():
            loss = mx.nd.CTCLoss(d, lab)
        loss.backward()
        res[name] = (loss.asnumpy().astype(np.float64),
                     d.grad.asnumpy().astype(np.float64))

    def rel(a, b):
        return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))

    loss_err = rel(res["card"][0], res["cpu_f64"][0])
    grad_err = rel(res["card"][1], res["cpu_f64"][1])
    cpu_grad_err = rel(res["cpu"][1], res["cpu_f64"][1])
    card_cpu = (rel(res["card"][0], res["cpu"][0]),
                rel(res["card"][1], res["cpu"][1]))
    d = mx.nd.array(data, ctx=mx.gpu(0))
    lab = mx.nd.array(label, ctx=mx.gpu(0))
    d.attach_grad()

    def step():
        with mx.autograd.record():
            loss = mx.nd.CTCLoss(d, lab)
        loss.backward()

    ms = cuda_ms(step, 10, torch)
    out = dict(loss_err=loss_err, grad_err=grad_err,
               cpu_f32_grad_err=cpu_grad_err, card_vs_cpu_f32=card_cpu,
               fwd_bwd_ms=ms, empty_losses=res["card"][0][:CTC_EMPTY].tolist())
    print("rnn 13e: CTCLoss (T, N, C) %s, labels of %s tokens and %d empty: "
          "the card against the CPU in f32: loss %.3e, data gradient %.3e "
          "(bound %.0e each); the card's loss against the CPU in f64 %.3e "
          "(bound %.0e); reading, no bound: the data gradient against the "
          "CPU in f64 %.3e on the card, %.3e on the CPU in f32; "
          "forward+backward %.4f ms on the card | %s"
          % (CTC_SHAPE, CTC_LABEL_LENGTHS, CTC_EMPTY, card_cpu[0],
             card_cpu[1], CTC_TOL, loss_err, CTC_TOL, grad_err, cpu_grad_err,
             ms, card), flush=True)
    check(np.isfinite(res["card"][0]).all() and card_cpu[0] <= CTC_TOL and
          card_cpu[1] <= CTC_TOL and loss_err <= CTC_TOL,
          "13e: CTC card vs CPU %s" % out)
    return out


def rnn_encoder_attention(mx, card):
    """13f: a bidirectional gluon.rnn.LSTM encoder under
    gluon.nn.MultiHeadAttention (head dim 128) trained RNN_ENCODER["steps"]
    steps in bf16 through DataParallelTrainer: kernel B1's forward and
    backward launches, counted from 0 just before and read just after
    (phase 3 holds both kernels to the plain version at this shape,
    ATTENTION_CASES and BACKWARD_CASES)."""
    import torch
    from incubator_mxnet_tpu_torch.ops.attention import flash_attention
    from incubator_mxnet_tpu_torch.ops import rnn as rnn_ops
    cfg = RNN_ENCODER
    units = 2 * cfg["hidden"]
    gluon = mx.gluon

    class Encoder(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.embed = gluon.nn.Embedding(cfg["vocab"], cfg["embed"])
                self.lstm = gluon.rnn.LSTM(cfg["hidden"], layout="NTC",
                                           bidirectional=True,
                                           input_size=cfg["embed"])
                self.attn = gluon.nn.MultiHeadAttention(units, cfg["heads"])
                self.proj = gluon.nn.Dense(cfg["vocab"], flatten=False,
                                           in_units=units)

        def hybrid_forward(self, F, x):
            return self.proj(self.attn(self.lstm(self.embed(x))))

    mx.random.seed(SEED)
    net = Encoder()
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    rs = np.random.RandomState(SEED + 6)
    shape = (cfg["batch"], cfg["seq"])
    x = mx.nd.array(rs.randint(0, cfg["vocab"], shape), ctx=mx.gpu(0),
                    dtype="int32")
    y = mx.nd.array(rs.randint(0, cfg["vocab"], shape).astype(np.float32),
                    ctx=mx.gpu(0))
    trainer = mx.parallel.DataParallelTrainer(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        {"learning_rate": cfg["lr"]}, dtype="bfloat16")
    counters = ("launches", "backward_kernel_launches",
                "backward_torch_calls", "backward_calls")
    # the first step also runs a forward that resolves the deferred shapes
    losses = [float(trainer.step(x, y).asnumpy())]
    torch.cuda.synchronize()
    for k in counters:
        setattr(flash_attention, k, 0)
    rnn_ops.rnn_op.cudnn_calls = 0
    losses += [float(trainer.step(x, y).asnumpy())
               for _ in range(cfg["steps"])]
    launches = {k: getattr(flash_attention, k) for k in counters}
    launches["rnn_cudnn_calls"] = rnn_ops.rnn_op.cudnn_calls
    print("rnn 13f: Encoder (Embedding, bidirectional LSTM %d, "
          "MultiHeadAttention %d units x %d heads: head dim %d, Dense) %s in "
          "bf16, a first step then %d counted DataParallelTrainer steps: "
          "losses %s; counters in the counted steps %s | %s"
          % (cfg["hidden"], units, cfg["heads"], units // cfg["heads"], cfg,
             cfg["steps"], ["%.6f" % v for v in losses], launches, card),
          flush=True)
    check(all(math.isfinite(v) for v in losses), "13f: loss not finite")
    check(launches["launches"] == cfg["steps"] and
          launches["backward_kernel_launches"] == cfg["steps"] and
          launches["backward_torch_calls"] == 0 and
          launches["rnn_cudnn_calls"] == cfg["steps"],
          "13f: counters %s, expected %d flash forward and backward kernel "
          "launches, no torch-ops backward, one cuDNN call a step"
          % (launches, cfg["steps"]))
    del trainer, net
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, launches=launches)


def bucket_lm_module(mx, ctx):
    """13g's FusedRNNCell LM (BUCKET_LM) as a BucketingModule on ``ctx``,
    with its BucketSentenceIter (each next token the one after it, mod
    vocab - 1: learnable), the shuffles seeded from SEED."""
    cfg = BUCKET_LM
    rs = np.random.RandomState(SEED + 7)
    sentences = [[1 + (s + i) % (cfg["vocab"] - 1) for i in range(k)]
                 for s, k in zip(rs.randint(0, cfg["vocab"] - 1,
                                            cfg["sentences"]),
                                 rs.choice(cfg["buckets"],
                                           cfg["sentences"]))]
    random.seed(SEED)
    np.random.seed(SEED)
    with ctx:
        it = mx.rnn.BucketSentenceIter(sentences, cfg["batch"],
                                       buckets=list(cfg["buckets"]),
                                       invalid_label=0)
    cell = mx.rnn.FusedRNNCell(cfg["hidden"], num_layers=cfg["layers"],
                               mode="lstm", prefix="lm_")
    h = cfg["hidden"]

    def sym_gen(seq_len):
        data = mx.sym.var("data")
        label = mx.sym.var("softmax_label")
        emb = mx.sym.Embedding(data, input_dim=cfg["vocab"],
                               output_dim=cfg["embed"], name="embed")
        out, _ = cell.unroll(seq_len, emb, merge_outputs=True)
        pred = mx.sym.FullyConnected(mx.sym.Reshape(out, shape=(-1, h)),
                                     num_hidden=cfg["vocab"], name="pred")
        pred = mx.sym.SoftmaxOutput(pred, mx.sym.Reshape(label, shape=(-1,)),
                                    name="softmax")
        return pred, ("data",), ("softmax_label",)

    return it, mx.mod.BucketingModule(sym_gen, default_bucket_key=max(
        cfg["buckets"]), context=ctx)


def bucket_lm_fit(mx, ctx, weights, epochs):
    """BucketingModule.fit of 13g's LM on ``ctx`` from ``weights`` (name ->
    numpy) for ``epochs`` epochs, adam at BUCKET_LM["lr"]: the module and
    (epoch, the epoch's perplexity so far) after each batch."""
    it, mod = bucket_lm_module(mx, ctx)
    seen = []
    with ctx:
        mod.fit(it, num_epoch=epochs, eval_metric=mx.metric.Perplexity(
            ignore_label=0), optimizer="adam",
            optimizer_params={"learning_rate": BUCKET_LM["lr"]},
            arg_params={k: mx.nd.array(v, ctx=ctx)
                        for k, v in weights.items()},
            batch_end_callback=lambda p: seen.append(
                (p.epoch, p.eval_metric.get()[1])))
    return mod, seen


def bucket_lm(mx, card):
    """13g: mx.rnn on the card: a FusedRNNCell LM (BUCKET_LM) unrolled per
    bucket of BucketSentenceIter and trained BUCKET_LM["epochs"] epochs by
    BucketingModule.fit from weights drawn on the host (Xavier after
    mx.random.seed(SEED)), the last epoch's perplexity below half the
    first's (as tests/test_torch_rnn_symbolic.py asks on the CPU); its
    witness, the same fit on the CPU from the same weights and batches for
    BUCKET_WITNESS_EPOCHS epoch, within BUCKET_WITNESS_TOL of the card's
    perplexity after each batch; then unfuse() against the fused node on
    the card, same weights, within 1e-4."""
    import torch
    from incubator_mxnet_tpu_torch.ops import rnn as rnn_ops
    cfg = BUCKET_LM
    t0 = time.perf_counter()
    it, host = bucket_lm_module(mx, mx.cpu())
    with mx.cpu():
        host.bind(it.provide_data, it.provide_label)
        mx.random.seed(SEED)
        host.init_params(mx.init.Xavier())
    weights = {k: v.asnumpy() for k, v in host.get_params()[0].items()}
    rnn_ops.rnn_op.cudnn_calls = rnn_ops.rnn_op.plain_calls = 0
    mod, seen = bucket_lm_fit(mx, mx.gpu(0), weights, cfg["epochs"])
    calls = dict(cudnn=rnn_ops.rnn_op.cudnn_calls,
                 plain=rnn_ops.rnn_op.plain_calls)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    _, cpu_seen = bucket_lm_fit(mx, mx.cpu(), weights, BUCKET_WITNESS_EPOCHS)
    witness_err = max(abs(g - c) / c for (_, g), (_, c) in
                      zip(seen, cpu_seen))
    rs = np.random.RandomState(SEED + 8)
    # unfuse() against the fused node, bidirectional, on the card
    fcell = mx.rnn.FusedRNNCell(64, num_layers=2, mode="lstm",
                                bidirectional=True, prefix="u_")
    fout, _ = fcell.unroll(12, mx.sym.var("data"), merge_outputs=True)
    uout, _ = fcell.unfuse().unroll(12, mx.sym.var("data"),
                                    merge_outputs=True)
    arg_shapes, _, _ = fout.infer_shape(data=(8, 12, 32))
    vals = {n: mx.nd.array((rs.standard_normal(s) * 0.3).astype(np.float32),
                           ctx=mx.gpu(0))
            for n, s in zip(fout.list_arguments(), arg_shapes)}
    fused = fout.eval_dict(vals)
    fused = (fused[0] if isinstance(fused, list) else fused).asnumpy()
    unfused = uout.eval_dict(vals).asnumpy()
    unfuse_err = float(np.abs(fused - unfused).max() /
                       max(1.0, np.abs(fused).max()))
    by_epoch = [v for e, v in sorted(dict(seen).items())]
    out = dict(batches=len(seen), perplexity_first_batch=seen[0][1],
               perplexity_by_epoch=by_epoch, buckets=sorted(mod._buckets),
               calls=calls, fit_s=fit_s, witness_err=witness_err,
               witness_batches=len(cpu_seen), unfuse_err=unfuse_err)
    print("rnn 13g: BucketingModule.fit of a FusedRNNCell LM %s over "
          "BucketSentenceIter from host-drawn weights: %d batches, buckets "
          "bound %s, perplexity %.4f after the first batch, by epoch %s (the "
          "last below half the first), RNN routes %s, %.1f s; the CPU's fit "
          "from the same weights, %d batches: %s after its last, the card's "
          "perplexities within %.3e of it relative (bound %.0e); unfuse() "
          "against the fused node on the card: %.3e relative (bound 1e-4) "
          "| %s" % (cfg, len(seen), out["buckets"], seen[0][1],
                    ["%.4f" % v for v in by_epoch], calls, fit_s,
                    len(cpu_seen), "%.4f" % cpu_seen[-1][1], witness_err,
                    BUCKET_WITNESS_TOL, unfuse_err, card), flush=True)
    check(witness_err <= BUCKET_WITNESS_TOL, "13g: the card's fit differs "
          "from the CPU's from the same weights: %s" % out)
    check(np.isfinite(by_epoch).all() and len(out["buckets"]) ==
          len(cfg["buckets"]) and calls["cudnn"] > 0 and
          calls["plain"] == 0, "13g: %s" % out)
    check(by_epoch[-1] < by_epoch[0] / 2, "13g: the perplexity did not fall "
          "to half: %s" % by_epoch)
    check(unfuse_err <= 1e-4, "13g: unfuse() differs from the fused cell")
    return out


def rnn_phase(mx, card):
    """Phase 13: 13a-13g; the phase's seconds."""
    import torch
    t13 = time.perf_counter()
    rows = []
    for shape, modes, dtypes in RNN_CASES:
        for dtype in dtypes:
            for mode in modes:
                for bidirectional in (False, True):
                    row = rnn_route_case(mx, mode, bidirectional, dtype,
                                         shape)
                    rows.append(row)
                    print("rnn 13a: %s %s %s 2 layers at (T, N, I, H) %s: "
                          "route %s (%s), max_abs_err %.3e relative (%s "
                          "against the %s loop; bound RNN_TOL %.0e); all "
                          "arrays: the route %.3e from the f64 loop, the "
                          "plain %s loop %.3e from it, the route %.3e from "
                          "the plain %s loop | %s"
                          % (mode, "bidirectional" if bidirectional else
                             "unidirectional", dtype, shape, row["route"],
                             row["calls"], row["max_abs_err"], row["worst"],
                             "f64" if row["worst_oracle"] == "f64" else
                             "same-dtype", row["bound"],
                             row["readings"]["f64"], dtype,
                             row["readings"]["plain_f64"],
                             row["readings"]["plain"], dtype, card),
                          flush=True)
                    check(row["route"] == "cudnn" and
                          row["calls"]["cudnn"] == 2,
                          "13a: %s %s took route %s %s" % (
                              mode, dtype, row["route"], row["calls"]))
                    check(row["ok"], "13a: %s" % row)
    torch.cuda.empty_cache()
    out = dict(cases=[{k: r[k] for k in ("mode", "bidirectional", "dtype",
                                         "shape", "route", "max_abs_err",
                                         "worst", "worst_oracle", "bound")}
                      for r in rows])
    out["timing"] = {dt: rnn_timing(mx, dt, card)
                     for dt in ("float32", "bfloat16")}
    out["contracts"] = rnn_card_contracts(mx, card)
    out["small"] = word_lm_small(mx, card)
    net, out["train"] = word_lm_train(mx, card)
    out["serve"] = word_lm_serve(mx, net, card)
    del net
    gc.collect()
    torch.cuda.empty_cache()
    out["word_lm"] = word_lm_loop(mx, card)
    out["ctc"] = ctc_on_card(mx, card)
    out["encoder"] = rnn_encoder_attention(mx, card)
    out["bucketing"] = bucket_lm(mx, card)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t13
    print("rnn: phase 13 in %.1f s | %s" % (out["seconds"], card),
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 14: Gluon hybridize() as CUDA graphs and the SSD ops
# ---------------------------------------------------------------------------

# 14a: benchmark_score.py's _build (:57-71): Xavier(magnitude=2), bf16, then
# hybridize(), batch 32 of uniform(-1, 1)
HYBRID_SCORE_NETS = (("resnet50_v1", 224), ("inception_v3", 299),
                     ("alexnet", 224), ("vgg16", 224))
HYBRID_SCORE_BATCH, HYBRID_SCORE_REPS = 32, 4
# 14b: train_imagenet.py --gluon-trainer at 10c's shape, 3 + 5 steps
HYBRID_IMAGENET_STEPS = (3, 5)
# 14c: word_lm.py's loop (Adam, states carried) at bench_lstm.py's width
HYBRID_WORD_LM = dict(WORD_LM, lr=0.003, steps=(2, 5))
# 14d: 3 hybridized gluon.Trainer steps of the full-width LM
HYBRID_LM_STEPS = 3
# 14e: example/ssd/train.py at its defaults
SSD = dict(batch=32, epochs=12, batches=4, lr=0.1, momentum=0.9, seed=3,
           size=32, eval_iou=0.3, classes=2, sizes=(0.3, 0.55),
           ratios=(1.0, 2.0, 0.5))
SSD_BOX_REL = 1e-5


def hybrid_counts(mx):
    return mx.gluon.block.cached_op_stats()


def hybrid_release(mx):
    """Drop every graph of the engine's pool and its memory (after a
    hybridized net is gone)."""
    import torch
    gc.collect()
    mx.engine.clear_graphs()
    torch.cuda.empty_cache()


def hybrid_card_contracts(mx, card, failing=True):
    """The card's contracts of ``hybridize()`` at a small size: a replay
    bit-equal to eager under deterministic algorithms (a conv, BatchNorm,
    dropout net trained 3 steps: outputs, weights and moving statistics),
    a fresh dropout mask per replay, an output surviving the next replay,
    a parameter moved to a new address (a new variant captured, then
    read), four threads on four streams calling two hybridized nets that
    share the graph pool, an op that cannot be captured splitting the
    graph (``_linalg_syevd``: two pieces, the split op counted, equal to
    eager; ``RNN`` likewise, its backward eager; a custom op that checks
    its input values and runs once a call; ``CTCLoss`` with lengths the
    block computes; an RNN with dropout drawing eager's masks), and
    (``failing``) a capture that fails raising MXNetError that names the
    block and the op."""
    import threading
    import torch
    from incubator_mxnet_tpu_torch.base import MXNetError
    nn, nd, gpu = mx.gluon.nn, mx.nd, mx.gpu(0)
    res, fails = {}, []

    def need(cond, what):
        if not cond:
            fails.append(what)

    def convnet():
        net = nn.HybridSequential(prefix="hc_")
        with net.name_scope():
            net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
                    nn.BatchNorm(in_channels=8), nn.Activation("relu"),
                    nn.Dropout(0.5), nn.Dense(4, in_units=8 * 64))
        net.initialize(mx.init.Xavier(), ctx=gpu)
        rs = np.random.RandomState(SEED)
        for p in net.collect_params().values():
            v = rs.standard_normal(p.shape).astype(np.float32) * 0.1
            if p.name.endswith("running_var"):
                v = np.abs(v) + 1.0
            p.set_data(v)
        return net

    x = nd.array(np.random.RandomState(1).randn(4, 3, 8, 8), ctx=gpu)

    def train(net):
        mx.random.seed(5)
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1, "momentum": 0.9})
        outs = []
        for _ in range(3):
            with mx.autograd.record():
                y = net(x)
                loss = (y * y).sum()
            loss.backward()
            tr.step(1)
            outs.append(y._data.clone())
        return outs, [p.data()._data.clone()
                      for p in net.collect_params().values()]

    with deterministic_kernels(torch):
        want = train(convnet())
        mx.gluon.block.reset_cached_op_stats()
        net = convnet()
        net.hybridize()
        got = train(net)
    res["train_counts"] = hybrid_counts(mx)
    need(all(same_bits(torch, a, b) for a, b in zip(got[0] + got[1],
                                                    want[0] + want[1])),
         "3 training steps not bit-equal to eager")
    need(res["train_counts"]["captures"] == 1 and
         res["train_counts"]["replays"] == 2 and
         res["train_counts"]["backward_captures"] == 1 and
         res["train_counts"]["backward_replays"] == 2,
         "captures and replays %s" % res["train_counts"])
    with mx.autograd.record():
        a = net(x)._data.clone()
        b = net(x)._data.clone()
    need(not torch.equal(a, b), "two training replays drew one mask")
    with mx.autograd.predict_mode():
        y1 = net(x)
        keep = y1._data.clone()
        net(x * 2)
    need(torch.equal(y1._data, keep), "an output changed by the next replay")
    # a parameter moved to a new address: a new variant, its values read
    w = net[0].weight.data()
    before = mx.gluon.block.cached_op_stats()["captures"]
    old = w._data
    w._data = old.detach().clone().mul_(0.5).requires_grad_(
        old.requires_grad)
    with mx.autograd.predict_mode():
        moved = net(x)._data.clone()
        net.hybridize(False)
        eager_moved = net(x)._data.clone()
        net.hybridize()
    need(same_bits(torch, moved, eager_moved), "the moved weight not read")
    need(mx.gluon.block.cached_op_stats()["captures"] == before + 1,
         "the moved weight not recaptured")
    # four threads on four streams: two call net, two call another
    # hybridized net, whose graphs share net's memory pool
    xs = [nd.array(np.random.RandomState(10 + i).randn(4, 3, 8, 8), ctx=gpu)
          for i in range(2)]
    other = nn.HybridSequential(prefix="hc2_")
    with other.name_scope():
        other.add(nn.Dense(512, in_units=3 * 64, activation="relu"),
                  nn.Dense(512, in_units=512, activation="tanh"),
                  nn.Dense(4, in_units=512))
    other.initialize(mx.init.Xavier(), ctx=gpu)
    nets = [net, net, other, other]
    xs = xs + xs
    with mx.autograd.predict_mode():
        want2 = [nets[i](xs[i])._data.clone() for i in range(4)]
        other.hybridize()
        other(xs[2])
    equal = []

    def work(i):
        s = torch.cuda.Stream()
        with torch.cuda.stream(s), mx.autograd.predict_mode():
            for _ in range(20):
                equal.append(bool(torch.equal(nets[i](xs[i])._data,
                                              want2[i])))
        s.synchronize()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    need(len(equal) == 80 and all(equal), "threads: %d of %d calls equal"
         % (sum(equal), len(equal)))

    class Eig(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.d = nn.Dense(6, in_units=6)

        def hybrid_forward(self, F, v):
            a_ = self.d(v)
            u, lam = F._linalg_syevd(F.dot(a_, a_, transpose_b=True))
            return F.relu(lam) * 2 + 1, u

    eig = Eig(prefix="eig_")
    eig.initialize(mx.init.Xavier(), ctx=gpu)
    v = nd.array(np.random.RandomState(3).randn(6, 6), ctx=gpu)
    want3 = [o._data.clone() for o in eig(v)]
    eig.hybridize()
    mx.gluon.block.reset_cached_op_stats()
    for _ in range(3):
        got3 = eig(v)
    res["split_counts"] = hybrid_counts(mx)
    graph = list(eig._cached_op._graphs.values())[0]
    res["split"] = dict(pieces=graph.pieces, split_ops=graph.split_ops)
    need(all(same_bits(torch, g._data, w_) for g, w_ in zip(got3, want3)),
         "the split program differs from eager")
    need(graph.pieces == 2 and graph.split_ops == 1 and
         res["split_counts"]["split_ops"] == 3,
         "split: %s %s" % (res["split"], res["split_counts"]))
    v.attach_grad()
    with mx.autograd.record():
        lam, _ = eig(v)
    lam.backward()
    need(hybrid_counts(mx)["eager_backwards"] == 1,
         "the split program's backward did not run eagerly")
    # RNN splits the graph (cuDNN's capture is not safe): two pieces, the
    # op eager between them and in the backward, results as eager's
    lstm = mx.gluon.rnn.LSTM(16, num_layers=2, input_size=8, prefix="hl_")
    lstm.initialize(mx.init.Xavier(), ctx=gpu)
    seq = nd.array(np.random.RandomState(4).randn(6, 3, 8), ctx=gpu)
    seq.attach_grad()
    runs = []
    for hyb in (False, True, True):
        lstm.hybridize(hyb)
        mx.gluon.block.reset_cached_op_stats()
        with mx.autograd.record():
            out = lstm(seq)
            loss = (out * out).sum()
        loss.backward()
        runs.append((out._data.clone(), seq.grad._data.clone()))
    res["rnn_counts"] = hybrid_counts(mx)
    graph = list(lstm._cached_op._graphs.values())[0]
    res["rnn"] = dict(pieces=graph.pieces, split_ops=graph.split_ops,
                      err=[max(max_diff(a, b) for a, b in zip(r, runs[0]))
                           for r in runs[1:]])
    need(graph.pieces == 2 and graph.split_ops == 1 and
         res["rnn_counts"]["eager_backwards"] == 1 and
         max(res["rnn"]["err"]) <= 1e-5, "RNN split: %s %s"
         % (res["rnn"], res["rnn_counts"]))
    # a hybridized custom op: it runs once a call, never in the capture,
    # and reads the values the piece before it wrote
    runs, bad = [], []

    class Check(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            v = in_data[0].asnumpy()
            runs.append(1)
            if not (np.isfinite(v).all() and
                    np.abs(v.sum(axis=1) - 1).max() < 1e-5):
                bad.append(v.tolist())
            self.assign(out_data[0], req[0], in_data[0] * 2)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * 2)

    class CheckProp(mx.operator.CustomOpProp):
        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Check()

    mx.operator.register("hc_check")(CheckProp)

    class Softmaxed(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.d = nn.Dense(5, in_units=6)

        def hybrid_forward(self, F, v):
            p_ = F.Custom(F.softmax(self.d(v)), op_type="hc_check")
            return F.relu(p_ - 0.3) + 1

    cus = Softmaxed(prefix="cus_")
    cus.initialize(mx.init.Xavier(), ctx=gpu)
    vs = [nd.array(np.random.RandomState(20 + i).randn(3, 6), ctx=gpu)
          for i in range(3)]
    want4 = [cus(v_)._data.clone() for v_ in vs]
    cus.hybridize()
    mx.gluon.block.reset_cached_op_stats()
    got4 = [cus(v_)._data.clone() for v_ in vs]
    graph = list(cus._cached_op._graphs.values())[0]
    res["custom"] = dict(runs=len(runs), bad=len(bad), pieces=graph.pieces,
                         split_ops=graph.split_ops,
                         counts=hybrid_counts(mx))
    need(len(runs) == 6 and not bad and graph.pieces == 2 and
         graph.split_ops == 1 and
         all(same_bits(torch, a, b) for a, b in zip(got4, want4)),
         "custom op: %s" % res["custom"])
    # CTCLoss whose lengths the block computes: the op between the pieces
    # reads each call's lengths
    class Ctc(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.d = nn.Dense(6, in_units=8, flatten=False)

        def hybrid_forward(self, F, feats, label):
            dat_len = F.sum(F.sum(F.abs(feats), axis=2) > 0, axis=0)
            lab_len = F.sum(label > 0, axis=1)
            return F.CTCLoss(self.d(feats), label, dat_len, lab_len,
                             use_data_lengths=True, use_label_lengths=True)

    ctc = Ctc(prefix="ctc_")
    ctc.initialize(mx.init.Xavier(), ctx=gpu)
    batches = []
    for i in range(3):
        rs = np.random.RandomState(30 + i)
        feats = rs.randn(20, 4, 8).astype(np.float32)
        label = np.zeros((4, 5), np.float32)
        for j in range(4):
            feats[12 + rs.randint(0, 8):, j] = 0
            k = rs.randint(1, 6)
            label[j, :k] = rs.randint(1, 6, k)
        batches.append((nd.array(feats, ctx=gpu), nd.array(label, ctx=gpu)))

    def ctc_runs():
        out = []
        for f_, l_ in batches:
            f_.attach_grad()
            with mx.autograd.record():
                loss = ctc(f_, l_)
            loss.backward()
            out.append((loss._data.clone(), f_.grad._data.clone(),
                        ctc.d.weight.grad()._data.clone()))
        return out

    want5 = ctc_runs()
    ctc.hybridize()
    mx.gluon.block.reset_cached_op_stats()
    got5 = ctc_runs()
    graph = list(ctc._cached_op._graphs.values())[0]
    err5 = max(max_diff(a, b) / max(1.0, float(b.abs().max()))
               for g, w_ in zip(got5, want5) for a, b in zip(g, w_))
    res["ctc"] = dict(err=err5, pieces=graph.pieces,
                      split_ops=graph.split_ops, counts=hybrid_counts(mx))
    need(err5 <= 1e-5 and graph.pieces == 2 and graph.split_ops == 1 and
         res["ctc"]["counts"]["replays"] == 2,
         "CTCLoss: %s" % res["ctc"])
    # an RNN with dropout between layers: the hybridized calls draw the
    # masks the eager calls draw from the same seed, call after call
    drop = mx.gluon.rnn.LSTM(16, num_layers=2, input_size=8, dropout=0.5,
                             prefix="hd_")
    drop.initialize(mx.init.Xavier(), ctx=gpu)
    drop_runs = []
    for hyb in (False, True):
        drop.hybridize(hyb)
        mx.random.seed(11)
        outs = []
        for _ in range(3):
            with mx.autograd.record():
                outs.append(drop(seq)._data.clone())
        drop_runs.append(outs)
    res["rnn_dropout_err"] = [max_diff(a, b)
                              for a, b in zip(*drop_runs)]
    need(max(res["rnn_dropout_err"]) <= 1e-5 and
         not torch.equal(drop_runs[0][0], drop_runs[0][1]),
         "RNN dropout: %s" % res["rnn_dropout_err"])
    if failing:
        class Host(mx.gluon.HybridBlock):
            def hybrid_forward(self, F, v):
                return v * float((v * 2).asnumpy().sum())

        host = Host(prefix="host_")
        host.hybridize()
        try:
            host(nd.ones((2, 2), ctx=gpu))
            need(False, "a capture that reads the host did not raise")
        except MXNetError as exc:
            res["capture_error"] = str(exc)[:300]
            need("CachedOp(host)" in str(exc) and " at op " in str(exc),
                 "the capture error names no block or op: %s" % exc)
        # the process goes on capturing afterwards
        with mx.autograd.predict_mode():
            need(torch.equal(net(xs[0])._data, want2[0]),
                 "a replay after the failed capture differs")
        after = mx.gluon.nn.Dense(3, in_units=4, prefix="after_")
        after.initialize(ctx=gpu)
        after.hybridize()
        after(nd.ones((2, 4), ctx=gpu))
        need(after._cached_op is not None, "no capture after the failure")
    res["failures"] = fails
    res["ok"] = not fails
    print("hybrid 14 contracts: %s | %s" % (json.dumps(res, default=str),
                                            card), flush=True)
    del net, other, eig, lstm, cus, ctc, drop
    hybrid_release(mx)
    return res


def _timed_calls(run, reps, torch):
    run()
    return _timed_ms(run, reps, torch)


def hybrid_score(mx, card):
    """14a: benchmark_score.py's path at batch 32 in bf16 for ResNet-50 v1,
    Inception-v3, AlexNet and VGG-16: ms a batch eager and hybridized
    (mean of 4 after a warm-up), the capture's seconds, one call of each
    traced for its device-busy ms; the hybridized outputs bit-equal to
    eager (capture and replay)."""
    import torch
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    out = {}
    for name, size in HYBRID_SCORE_NETS:
        mx.random.seed(0)
        net = getattr(vision, name)(classes=1000)
        net.initialize(mx.init.Xavier(magnitude=2.0), ctx=mx.gpu(0))
        net.collect_params().setattr("grad_req", "null")
        net.cast("bfloat16")
        rs = np.random.RandomState(0)
        x = mx.nd.array(rs.uniform(-1, 1, (HYBRID_SCORE_BATCH, 3, size, size))
                        .astype(np.float32), ctx=mx.gpu(0)).astype(
                            "bfloat16")

        def batch():
            with mx.autograd.predict_mode():
                return net(x)._data
        want = batch().clone()             # resolves the deferred shapes
        eager_ms = _timed_calls(batch, HYBRID_SCORE_REPS, torch)
        _, eager_busy, eager_wall = _replay_trace(mx, batch, ())
        net.hybridize()
        mx.gluon.block.reset_cached_op_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = batch().clone()
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        replay = batch().clone()
        hyb_ms = _timed_ms(batch, HYBRID_SCORE_REPS, torch)
        _, busy, wall = _replay_trace(mx, batch, ())
        counts = hybrid_counts(mx)
        equal = same_bits(torch, first, want) and same_bits(torch, replay,
                                                            want)
        res = dict(eager_ms=eager_ms, eager_ms_mean=sum(eager_ms) / 4,
                   eager_busy_ms=eager_busy / 1e3,
                   eager_wall_ms=eager_wall / 1e3,
                   ms=hyb_ms, ms_mean=sum(hyb_ms) / 4, busy_ms=busy / 1e3,
                   wall_ms=wall / 1e3, capture_s=capture_s,
                   bit_equal=equal, counts=counts,
                   img_per_s=HYBRID_SCORE_BATCH / (sum(hyb_ms) / 4) * 1e3)
        print("hybrid 14a: %s bf16 batch %d: eager %s ms (mean %.3f, busy "
              "%.3f of %.3f traced), hybridized %s ms (mean %.3f, %.1f "
              "img/s, busy %.3f of %.3f traced), capture (eager run + "
              "capture) %.3f s; outputs bit-equal to eager %s; counts %s "
              "| %s" % (name, HYBRID_SCORE_BATCH,
                        ["%.3f" % v for v in eager_ms], res["eager_ms_mean"],
                        res["eager_busy_ms"], res["eager_wall_ms"],
                        ["%.3f" % v for v in hyb_ms], res["ms_mean"],
                        res["img_per_s"], res["busy_ms"], res["wall_ms"],
                        capture_s, equal, json.dumps(counts), card),
              flush=True)
        check(equal, "14a %s: hybridized outputs differ from eager (max "
              "%.3e)" % (name, max_diff(first, want)))
        check(counts["captures"] == 1 and counts["replays"] >= 6 and
              counts["split_ops"] == 0, "14a %s: counts %s" % (name, counts))
        out[name] = res
        del net, x, want, first, replay
        hybrid_release(mx)
    return out


def _imagenet_run(mx, hybrid, steps, data):
    """``fit_gluon``'s step (common.py:66-72) on ResNet-50 v1 for ``steps``
    batches of ``data``: (losses, step ms, moving statistics, peak
    memory)."""
    import torch
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    args = IMAGENET_ARGS
    mx.random.seed(SEED)
    net = vision.resnet50_v1(classes=args["num_classes"])
    if hybrid:
        net.hybridize()
    net.initialize(mx.init.Xavier(magnitude=2.0), ctx=mx.gpu(0))
    trainer = mx.gluon.Trainer(net.collect_params(), args["optimizer"],
                               {"learning_rate": args["lr"],
                                "momentum": args["momentum"],
                                "wd": args["wd"]})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for i in range(steps):
        x, y = data[i % len(data)]
        t0 = time.perf_counter()
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(loss.mean().asscalar()))
        ms.append((time.perf_counter() - t0) * 1e3)
    stats = [p.data()._data.clone() for n, p in
             net.collect_params().items() if n.endswith(("running_mean",
                                                         "running_var"))]
    peak = torch.cuda.max_memory_allocated()
    del net, trainer
    hybrid_release(mx)
    return losses, ms, stats, peak


def hybrid_imagenet(mx, card):
    """14b: train_imagenet.py --gluon-trainer (common.fit_gluon's step) on
    ResNet-50 v1 at 10c's shape (f32, batch 256), 3 + 5 steps, eager and
    hybridized: under deterministic algorithms the losses and moving
    statistics of the two within f32 rounding; step ms and peak memory of
    a free-running pair."""
    import torch
    warm, timed = HYBRID_IMAGENET_STEPS
    steps = warm + timed
    bs = IMAGENET_ARGS["batch_size"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    data = [(mx.nd.NDArray(torch.rand((bs,) + IMAGENET_SHAPE, device="cuda",
                                      generator=gen)),
             mx.nd.NDArray(torch.randint(0, IMAGENET_ARGS["num_classes"],
                                         (bs,), device="cuda",
                                         generator=gen).float()))
            for _ in range(2)]
    runs = {}
    for hybrid in (False, True):
        with deterministic_kernels(torch):
            runs[("exact", hybrid)] = _imagenet_run(mx, hybrid, steps, data)
    for hybrid in (False, True):
        runs[("free", hybrid)] = _imagenet_run(mx, hybrid, steps, data)
    (le, _, se, _), (lh, _, sh, _) = runs[("exact", False)], \
        runs[("exact", True)]
    loss_err = max(abs(a - b) / max(abs(a), 1e-30) for a, b in zip(le, lh))
    stat_err = max(max_diff(h, e) / max(float(e.abs().max()), 1e-30)
                   for h, e in zip(sh, se))
    bit_equal = le == lh and all(torch.equal(h, e) for h, e in zip(sh, se))

    def mean(ms):
        return sum(ms[warm:]) / timed

    res = dict(losses_eager=le, losses_hybrid=lh, loss_rel_err=loss_err,
               moving_stats_rel_err=stat_err, bit_equal=bit_equal,
               eager_step_ms=runs[("free", False)][1],
               step_ms=runs[("free", True)][1],
               eager_step_ms_mean=mean(runs[("free", False)][1]),
               step_ms_mean=mean(runs[("free", True)][1]),
               eager_peak_memory_bytes=runs[("free", False)][3],
               peak_memory_bytes=runs[("free", True)][3],
               exact_eager_step_ms_mean=mean(runs[("exact", False)][1]),
               exact_step_ms_mean=mean(runs[("exact", True)][1]))
    res["img_per_s"] = bs / res["step_ms_mean"] * 1e3
    print("hybrid 14b: resnet50_v1 f32 batch %d through gluon.Trainer (%s), "
          "%d + %d steps: eager %.3f ms a step (peak %d bytes), hybridized "
          "%.3f ms (%.1f img/s, peak %d bytes); deterministic algorithms: "
          "eager %.3f, hybridized %.3f ms, losses %s vs %s (worst relative "
          "%.3e), moving statistics worst relative %.3e, bit-equal %s | %s"
          % (bs, IMAGENET_ARGS["optimizer"], warm, timed,
             res["eager_step_ms_mean"], res["eager_peak_memory_bytes"],
             res["step_ms_mean"], res["img_per_s"], res["peak_memory_bytes"],
             res["exact_eager_step_ms_mean"], res["exact_step_ms_mean"],
             ["%.6f" % v for v in le], ["%.6f" % v for v in lh], loss_err,
             stat_err, bit_equal, card), flush=True)
    check(loss_err <= 1e-5 and stat_err <= 1e-5, "14b: hybridized losses or "
          "moving statistics differ from eager (%.3e, %.3e)"
          % (loss_err, stat_err))
    del data
    hybrid_release(mx)
    return res


def hybrid_word_lm(mx, card):
    """14c: BASELINE config 3, word_lm.py's hybridized loop (:106-126:
    hybridize(), Adam, the LSTM's states carried and detached) at
    bench_lstm.py's width (vocab 10000, embed and hidden 512, 2 layers,
    256 x 128 tokens, f32), eager and hybridized from the same weights on
    the same batches: step ms, tokens/s, the losses against eager, and
    whether RNN was captured or split (the counters)."""
    import torch
    from incubator_mxnet_tpu_torch.convert import numpy_params
    cfg = HYBRID_WORD_LM
    warm, timed = cfg["steps"]
    rs = np.random.RandomState(SEED + 14)
    shape = (warm + timed, cfg["batch"], cfg["seq"])
    xs = rs.randint(0, cfg["vocab"], shape).astype(np.float32)
    ys = rs.randint(0, cfg["vocab"], shape).astype(np.float32)
    gpu = mx.gpu(0)
    batches = [(mx.nd.array(x, ctx=gpu), mx.nd.array(y, ctx=gpu))
               for x, y in zip(xs, ys)]
    weights, runs = None, {}
    for hybrid in (False, True):
        mx.random.seed(1)
        net = word_lm_net(mx, cfg["vocab"], cfg["embed"], cfg["hidden"],
                          cfg["layers"])
        net.initialize(mx.init.Xavier(), ctx=gpu)
        if weights is None:
            weights = list(numpy_params(net).values())
        else:
            for p, w in zip(net.collect_params().values(), weights):
                p.set_data(mx.nd.array(w, ctx=gpu))
        if hybrid:
            net.hybridize()
        tr = mx.gluon.Trainer(net.collect_params(), "adam",
                              {"learning_rate": cfg["lr"]})
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        mx.gluon.block.reset_cached_op_stats()
        state, losses, ms = None, [], []
        for xb, yb in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if state is None:
                state = net.lstm.begin_state(xb.shape[0], ctx=gpu)
            with mx.autograd.record():
                h = net.embed(xb)
                out, new_state = net.lstm(h, state)
                loss = loss_fn(net.proj(out), yb)
            loss.backward()
            tr.step(xb.shape[0])
            state = [s.detach() for s in new_state]
            losses.append(float(loss.asnumpy().mean()))
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = hybrid_counts(mx)
        graphs = list(net.lstm._cached_op._graphs.values()) if hybrid \
            else []
        runs[hybrid] = (losses, ms, counts, graphs[0] if graphs else None)
        del net, tr
        hybrid_release(mx)
    (le, me, _, _), (lh, mh, counts, graph) = runs[False], runs[True]
    tokens = cfg["batch"] * cfg["seq"]
    loss_err = max(abs(a - b) / abs(a) for a, b in zip(le, lh))
    pieces, split = (graph.pieces, graph.split_ops) if graph else (0, 0)
    res = dict(losses_eager=le, losses_hybrid=lh, loss_rel_err=loss_err,
               eager_step_ms=me, step_ms=mh,
               eager_step_ms_mean=sum(me[warm:]) / timed,
               step_ms_mean=sum(mh[warm:]) / timed, counts=counts,
               rnn="split" if split else "captured", lstm_pieces=pieces,
               lstm_split_ops=split)
    res["tokens_per_s"] = tokens / res["step_ms_mean"] * 1e3
    res["eager_tokens_per_s"] = tokens / res["eager_step_ms_mean"] * 1e3
    print("hybrid 14c: word_lm.py's loop %s f32, %d + %d steps of %d x %d "
          "tokens: eager %.3f ms a step (%.1f tokens/s), hybridized %.3f ms "
          "(%.1f tokens/s); 13b's eager bench_lstm step (bf16, "
          "DataParallelTrainer) in PERF.md: 25.353-33.633 ms; losses %s vs "
          "eager %s (worst relative %.3e); RNN %s: the LSTM's program is %d "
          "graph pieces with %d op run eagerly between them; counts %s | %s"
          % ({k: v for k, v in cfg.items() if k != "steps"}, warm, timed,
             cfg["batch"], cfg["seq"], res["eager_step_ms_mean"],
             res["eager_tokens_per_s"], res["step_ms_mean"],
             res["tokens_per_s"], ["%.5f" % v for v in lh],
             ["%.5f" % v for v in le], loss_err, res["rnn"], pieces, split,
             json.dumps(counts), card), flush=True)
    check(loss_err <= 1e-4, "14c: hybridized losses differ from eager by "
          "%.3e" % loss_err)
    check(counts["captures"] == 3 and split == 1 and
          counts["split_ops"] == warm + timed, "14c: counts %s, the "
          "LSTM's program %d pieces, %d split ops" % (counts, pieces, split))
    return res


def hybrid_lm_serving(mx, card, net, tokens, want, request_ms_4b):
    """14d, serving: 4b's full-width LM (bf16) hybridized: its request
    captured once and replayed, bit-equal to 4b's eager logits; ms a
    request beside 4b's; the flash forward kernel's rows in the trace of
    one replay (one a layer) while its launch counter stays flat."""
    import torch
    from incubator_mxnet_tpu_torch.ops.attention import flash_attention
    net.hybridize()
    mx.gluon.block.reset_cached_op_stats()

    def request():
        with mx.autograd.predict_mode():
            return net(tokens)._data
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = request().clone()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    flash_attention.launches = 0
    ms = _timed_ms(request, 4, torch)
    replay_launches = flash_attention.launches
    last = request()
    rows, busy, wall = _replay_trace(mx, request, ("flash_fwd_sm90",))
    equal = same_bits(torch, first, want._data) and same_bits(
        torch, last, want._data)
    counts = hybrid_counts(mx)
    res = dict(request_ms=ms, request_ms_mean=sum(ms) / len(ms),
               eager_request_ms=request_ms_4b, capture_s=capture_s,
               bit_equal=equal, busy_ms=busy / 1e3, wall_ms=wall / 1e3,
               flash_fwd_rows=rows["flash_fwd_sm90"],
               replay_counter_launches=replay_launches, counts=counts)
    print("hybrid 14d: the LM request (bf16, 8 x 1024) hybridized: %s ms "
          "(mean %.3f) against 4b's eager %s; capture %.3f s; one replay "
          "traced: wall %.3f ms, busy %.3f ms, %d flash_fwd_sm90_kernel rows; "
          "the launch counter rose %d over 4 replays; logits bit-equal to "
          "4b's %s; counts %s | %s"
          % (["%.3f" % v for v in ms], res["request_ms_mean"],
             ["%.3f" % v for v in request_ms_4b], capture_s, wall / 1e3,
             busy / 1e3, rows["flash_fwd_sm90"], replay_launches, equal,
             json.dumps(counts), card), flush=True)
    check(equal, "14d: hybridized logits differ from 4b's eager ones")
    check(rows["flash_fwd_sm90"] == LM_CONFIG["n_layers"] and
          replay_launches == 0, "14d: %d flash rows in a replay's trace, "
          "%d counted launches in replays" % (rows["flash_fwd_sm90"],
                                             replay_launches))
    net.hybridize(False)
    del first, last
    hybrid_release(mx)
    return res


def hybrid_lm_train(mx, card):
    """14d, training: the full-width LM in bf16 (multi_precision sgd with
    momentum) through gluon.Trainer, HYBRID_LM_STEPS steps eager and then,
    from the same weights, hybridized, under deterministic algorithms:
    the losses against eager; the flash counters zeroed before and read
    after the hybridized steps (the captures' calls); one hybridized step
    traced: flash forward rows (forward graph and the backward graph's
    recompute) and backward kernel rows."""
    import torch
    from incubator_mxnet_tpu_torch.models import TransformerLM
    from incubator_mxnet_tpu_torch.ops.attention import flash_attention
    cfg, batch = LM_CONFIG, TRAIN_BATCH
    ctx = mx.gpu(0)
    t0 = time.perf_counter()
    mx.random.seed(SEED)
    net = TransformerLM(**cfg)
    net.initialize(mx.init.Xavier(rnd_type="gaussian"), ctx=ctx)
    rs = np.random.RandomState(SEED + 20)
    x = mx.nd.array(rs.randint(0, cfg["vocab"], (batch, cfg["seq_len"])),
                    ctx=ctx, dtype="int32")
    y = mx.nd.array(rs.randint(0, cfg["vocab"], (batch, cfg["seq_len"]))
                    .astype(np.float32), ctx=ctx)
    with mx.autograd.predict_mode():
        net(x)
    net.cast("bfloat16")
    params = list(net.collect_params().values())
    start = [p.data()._data.detach().clone() for p in params]
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    built_s = time.perf_counter() - t0
    counters = ("launches", "backward_kernel_launches",
                "backward_torch_calls", "backward_calls")

    def run(hybrid):
        with torch.no_grad():
            for p, v in zip(params, start):
                p.data()._data.copy_(v)
        net.hybridize(hybrid)
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   dict(LM_STORE_OPT))

        def step():
            with mx.autograd.record():
                loss = loss_fn(net(x).astype("float32"), y)
            loss.backward()
            trainer.step(batch)
            return float(loss.mean().asscalar())
        for c in counters:
            setattr(flash_attention, c, 0)
        losses, ms = [], []
        with deterministic_kernels(torch):
            for _ in range(HYBRID_LM_STEPS):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                losses.append(step())
                ms.append((time.perf_counter() - t1) * 1e3)
        launches = {c: getattr(flash_attention, c) for c in counters}
        return losses, ms, launches, step

    le, me, _, _ = run(False)
    mx.gluon.block.reset_cached_op_stats()
    lh, mh, launches, step = run(True)
    counts = hybrid_counts(mx)
    torch.cuda.reset_peak_memory_stats()
    with deterministic_kernels(torch):     # the same key: replays
        rows, busy, wall = _replay_trace(mx, step, ("flash_fwd_sm90",
                                                    "flash_bwd"))
    peak = torch.cuda.max_memory_allocated()
    loss_err = max(abs(a - b) / abs(a) for a, b in zip(le, lh))
    res = dict(losses_eager=le, losses=lh, loss_rel_err=loss_err,
               eager_step_ms=me, step_ms=mh, launches=launches,
               counts=counts, trace_rows=rows, busy_ms=busy / 1e3,
               wall_ms=wall / 1e3, peak_memory_bytes=peak, built_s=built_s)
    print("hybrid 14d: the LM (%s, bf16) through gluon.Trainer(sgd %s), "
          "batch %d x %d, built in %.1f s, deterministic algorithms: eager "
          "steps %s ms, losses %s; hybridized steps %s ms, losses %s (worst "
          "relative %.3e); flash counters over the hybridized steps %s "
          "(the captures' Python runs: forward, recompute, backward); one "
          "hybridized step traced: wall %.3f ms, busy %.3f ms, rows %s; "
          "counts %s; peak memory allocated %d bytes | %s"
          % (cfg, LM_STORE_OPT, batch, cfg["seq_len"], built_s,
             ["%.3f" % v for v in me], ["%.4f" % v for v in le],
             ["%.3f" % v for v in mh], ["%.4f" % v for v in lh], loss_err,
             launches, wall / 1e3, busy / 1e3, rows, json.dumps(counts),
             peak, card), flush=True)
    layers = cfg["n_layers"]
    check(loss_err <= 1e-5, "14d: hybridized losses %s, eager %s"
          % (lh, le))
    check(rows["flash_fwd_sm90"] == 2 * layers and
          rows["flash_bwd"] == 2 * layers, "14d: trace rows %s, want %d "
          "forward (forward graph and recompute) and %d backward"
          % (rows, 2 * layers, 2 * layers))
    check(launches["backward_torch_calls"] == 0 and
          launches["backward_kernel_launches"] >= layers,
          "14d: flash counters %s" % launches)
    check(counts["captures"] == 1 and counts["backward_captures"] == 1,
          "14d: counts %s" % counts)
    del net, params, start, x, y
    hybrid_release(mx)
    return res


def tiny_ssd(mx):
    """example/ssd/train.py's TinySSD in the port."""
    nn = mx.gluon.nn
    n_anchors = len(SSD["sizes"]) + len(SSD["ratios"]) - 1
    classes = SSD["classes"]

    class TinySSD(mx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.backbone = nn.HybridSequential()
                for filters in (16, 32, 64):
                    self.backbone.add(nn.Conv2D(filters, 3, padding=1,
                                                strides=2),
                                      nn.BatchNorm(), nn.Activation("relu"))
                self.cls_head = nn.Conv2D(n_anchors * classes, 3, padding=1)
                self.loc_head = nn.Conv2D(n_anchors * 4, 3, padding=1)

        def hybrid_forward(self, F, x):
            feat = self.backbone(x)
            cls = self.cls_head(feat)
            loc = self.loc_head(feat)
            b = x.shape[0]
            cls = F.reshape(F.transpose(cls, axes=(0, 2, 3, 1)),
                            shape=(b, -1, classes))
            loc = F.reshape(F.transpose(loc, axes=(0, 2, 3, 1)),
                            shape=(b, -1))
            return feat, cls, loc

    return TinySSD()


def ssd_scene(rs, size):
    """train.py:36-49 make_scene: one bright square on a textured
    background, its label [cls, x1, y1, x2, y2] normalized."""
    img = rs.rand(3, size, size).astype(np.float32) * 0.3
    s = rs.randint(size // 4, size // 2)
    x0 = rs.randint(0, size - s)
    y0 = rs.randint(0, size - s)
    img[:, y0:y0 + s, x0:x0 + s] = rs.rand(3, 1, 1) * 0.5 + 0.5
    return img, np.array([[0, x0 / size, y0 / size, (x0 + s) / size,
                           (y0 + s) / size]], np.float32)


def ssd_train(mx, hybrid, X, Y, ctx):
    """train.py:101-143 on ``ctx``: (losses by epoch, step ms, the net,
    the anchors, the last batch's (anchors, labels, class scores))."""
    import torch
    nd, autograd = mx.nd, mx.autograd
    mx.random.seed(SSD["seed"])
    net = tiny_ssd(mx)
    net.initialize(mx.init.Xavier(magnitude=2.0), ctx=ctx)
    if hybrid:
        net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": SSD["lr"],
                                "momentum": SSD["momentum"]})
    n, bs = len(X), SSD["batch"]
    zero, one = nd.zeros((1,), ctx=ctx), nd.ones((1,), ctx=ctx)
    anchors, epochs, ms, last = None, [], [], None
    for _ in range(SSD["epochs"]):
        tot = 0.0
        for i in range(0, n, bs):
            if ctx.device_type == "gpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            xb = nd.array(X[i:i + bs], ctx=ctx)
            yb = nd.array(Y[i:i + bs], ctx=ctx)
            with autograd.record():
                feat, cls, loc = net(xb)
                if anchors is None:
                    anchors = nd.MultiBoxPrior(feat, sizes=SSD["sizes"],
                                               ratios=SSD["ratios"])
                cls_t_in = nd.transpose(cls, axes=(0, 2, 1))
                loc_t, loc_m, cls_t = nd.MultiBoxTarget(
                    anchors, yb, cls_t_in, negative_mining_ratio=3.0)
                valid = cls_t >= 0
                oh = nd.one_hot(nd.broadcast_maximum(cls_t, zero),
                                depth=SSD["classes"])
                ce = -nd.sum(oh * nd.log_softmax(cls, axis=-1), axis=-1)
                nvalid = nd.broadcast_maximum(nd.sum(valid, axis=1), one)
                l_cls = nd.sum(ce * valid, axis=1) / nvalid
                ax = nd.abs((loc - loc_t) * loc_m)
                l_loc = nd.mean(nd.where(ax < 1.0, 0.5 * ax * ax, ax - 0.5),
                                axis=1)
                loss = l_cls + l_loc
            loss.backward()
            trainer.step(xb.shape[0])
            tot += float(nd.mean(loss).asscalar())
            ms.append((time.perf_counter() - t0) * 1e3)
            last = (anchors, yb, cls_t_in.detach(), loc.detach())
        epochs.append(tot / SSD["batches"])
    return epochs, ms, net, anchors, last


def ssd_hits(mx, net, anchors, X, Y, ctx):
    """train.py:145-167: batch-1 decode + NMS, the top detection's IoU
    against the ground truth at --eval-iou."""
    nd = mx.nd
    hits = 0
    for i in range(len(X)):
        feat, cls, loc = net(nd.array(X[i:i + 1], ctx=ctx))
        probs = nd.softmax(cls, axis=-1)
        dets = nd.MultiBoxDetection(nd.transpose(probs, axes=(0, 2, 1)), loc,
                                    anchors, nms_threshold=0.45)
        d = dets.asnumpy()[0]
        d = d[d[:, 0] >= 0]
        if not len(d):
            continue
        best = d[np.argmax(d[:, 1])]
        gt, bx = Y[i, 0, 1:], best[2:6]
        ix1, iy1 = max(bx[0], gt[0]), max(bx[1], gt[1])
        ix2, iy2 = min(bx[2], gt[2]), min(bx[3], gt[3])
        inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0)
        union = ((bx[2] - bx[0]) * (bx[3] - bx[1])
                 + (gt[2] - gt[0]) * (gt[3] - gt[1]) - inter)
        if union > 0 and inter / union >= SSD["eval_iou"]:
            hits += 1
    return hits / len(X)


def hybrid_ssd(mx, card):
    """14e: BASELINE config 4, example/ssd/train.py at its defaults (batch
    32, 12 epochs of 4 batches, sgd lr 0.1 momentum 0.9, seed 3, 32x32
    scenes) with TinySSD hybridized on the card, and eagerly beside it:
    step ms; the loss falls; the hit rate at --eval-iou 0.3 (batch-1
    evaluation, a second cache key); the four SSD ops on the card against
    the CPU on the last batch's inputs: indices and masks exact, boxes and
    offsets within SSD_BOX_REL of their magnitude."""
    import torch
    rs = np.random.RandomState(SSD["seed"])
    n = SSD["batch"] * SSD["batches"]
    imgs, labels = zip(*(ssd_scene(rs, SSD["size"]) for _ in range(n)))
    X, Y = np.stack(imgs), np.stack(labels)
    gpu = mx.gpu(0)
    eager = ssd_train(mx, False, X, Y, gpu)
    mx.gluon.block.reset_cached_op_stats()
    epochs, ms, net, anchors, last = ssd_train(mx, True, X, Y, gpu)
    train_counts = hybrid_counts(mx)
    hits = ssd_hits(mx, net, anchors, X, Y, gpu)
    keys = len(net._cached_op._entries)
    # the ops on the card against the CPU
    a, yb, cls_in, loc = last
    cpu = mx.cpu()
    errs = {}

    def both(op, arrays, **kw):
        g = getattr(mx.nd, op)(*arrays, **kw)
        c = getattr(mx.nd, op)(*[v.as_in_context(cpu) for v in arrays], **kw)
        g = g if isinstance(g, (list, tuple)) else [g]
        c = c if isinstance(c, (list, tuple)) else [c]
        return [v.asnumpy() for v in g], [v.asnumpy() for v in c]

    def rel(g, c):
        return float(np.abs(g.astype(np.float64) - c).max() /
                     max(1.0, np.abs(c).max())) if g.size else 0.0

    g, c = both("MultiBoxPrior", [mx.nd.zeros((1, 64, 4, 4), ctx=gpu)],
                sizes=SSD["sizes"], ratios=SSD["ratios"])
    errs["MultiBoxPrior"] = rel(g[0], c[0])
    g, c = both("MultiBoxTarget", [a, yb, cls_in], negative_mining_ratio=3.0)
    errs["MultiBoxTarget"] = rel(g[0], c[0])
    exact = [np.array_equal(g[1], c[1]), np.array_equal(g[2], c[2])]
    probs = mx.nd.softmax(cls_in, axis=1)
    g, c = both("MultiBoxDetection", [probs, loc, a], nms_threshold=0.45)
    errs["MultiBoxDetection"] = rel(g[0], c[0])
    exact.append(np.array_equal(g[0][..., 0], c[0][..., 0]))
    g, c = both("box_nms", [mx.nd.array(g[0], ctx=gpu)], overlap_thresh=0.3,
                topk=20)
    errs["box_nms"] = rel(g[0], c[0])
    exact.append(np.array_equal(g[0][..., :2], c[0][..., :2]))
    ssd_ops = {k: v for k, v in errs.items()}
    res = dict(losses=epochs, eager_losses=eager[0], step_ms=ms,
               step_ms_mean=sum(ms[1:]) / (len(ms) - 1),
               eager_step_ms_mean=sum(eager[1][1:]) / (len(eager[1]) - 1),
               hit_rate=hits, cache_keys=keys, train_counts=train_counts,
               ops_rel_err=ssd_ops, ops_exact=exact)
    print("hybrid 14e: example/ssd/train.py %s: loss by epoch %s (eager "
          "%s); step ms hybridized %.3f, eager %.3f (mean after the first); "
          "hit rate at IoU %.1f: %.4f over %d images (batch-1 "
          "evaluation: %d cache keys); counts in training %s; the four ops "
          "card vs CPU: relative errors %s, indices and masks exact %s | %s"
          % ({k: v for k, v in SSD.items() if k not in ("sizes", "ratios")},
             ["%.4f" % v for v in epochs], ["%.4f" % v for v in eager[0]],
             res["step_ms_mean"], res["eager_step_ms_mean"],
             SSD["eval_iou"], hits, n, keys, json.dumps(train_counts),
             json.dumps(ssd_ops), exact, card), flush=True)
    check(epochs[-1] < 0.7 * epochs[0] and all(math.isfinite(v)
                                               for v in epochs),
          "14e: the loss did not fall: %s" % epochs)
    check(all(exact) and max(errs.values()) <= SSD_BOX_REL,
          "14e: the SSD ops on the card differ from the CPU: %s %s"
          % (errs, exact))
    check(keys >= 2 and train_counts["captures"] >= 1,
          "14e: %d cache keys, counts %s" % (keys, train_counts))
    del net, eager
    hybrid_release(mx)
    return res


def hybrid_phase(mx, card):
    """Phase 14: Gluon hybridize() as CUDA graphs (CachedOp) on the card
    and the SSD ops (14a-14c, 14e; 14d's serving half runs on 4b's net
    before 11b, its training half here)."""
    import torch
    t0 = time.perf_counter()
    out = dict(contracts=hybrid_card_contracts(mx, card, failing=False))
    check(out["contracts"]["ok"], "14 contracts: %s"
          % out["contracts"]["failures"])
    out["score"] = hybrid_score(mx, card)
    out["imagenet"] = hybrid_imagenet(mx, card)
    out["word_lm"] = hybrid_word_lm(mx, card)
    out["lm_train"] = hybrid_lm_train(mx, card)
    out["ssd"] = hybrid_ssd(mx, card)
    out["seconds"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    print("hybrid: phase 14 in %.1f s | %s" % (out["seconds"], card),
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 15: sparse storage (RowSparse and CSR NDArrays, cast_storage,
# retain, sparse dot, the lazy row-sparse SGD, row_sparse_pull, LibSVMIter,
# sparse records) and BASELINE config 5; no hand kernel runs in it
# ---------------------------------------------------------------------------

# BASELINE config 5 at the width of MXNet 1.2's example/sparse/
# linear_classification/train.py (Avazu: 1,000,000 hashed features, batch
# 8192).  The data is written from the seed: 65,536 rows (8 batches) of 15
# distinct features, ids drawn with p(rank k) ~ k^-1.1, value 1 (hashed
# click features), label sign(w_true . x); 3 epochs of the example's loop
SPARSE = dict(dim=1000000, batch=8192, rows=65536, nnz=15, zipf=1.1,
              epochs=3, lr=2.0, w_scale=0.01, seed=SEED)
SPARSE_REPS = 5
# 15a's lazy updates: with and without momentum, weight decay and clipping
SPARSE_UPDATES = (dict(momentum=0.0, wd=0.0, clip_gradient=-1.0),
                  dict(momentum=0.0, wd=1e-4, clip_gradient=0.01),
                  dict(momentum=0.9, wd=0.0, clip_gradient=-1.0),
                  dict(momentum=0.9, wd=1e-4, clip_gradient=0.01))
U32 = 2.0 ** -24      # f32's unit roundoff
HOST_SYNC_OP = "_smoke_host_sync"


def zipf_ids(rs, rows, nnz, dim, exponent):
    """(rows, nnz) feature ids, distinct and sorted within a row: ranks
    drawn with p(k) ~ k^-exponent over ``dim`` ids, mapped to ids by a
    seeded permutation (the head of a hashed feature space lies anywhere
    in it); a repeat within a row is drawn again."""
    cdf = np.cumsum(np.arange(1, dim + 1, dtype=np.float64) ** -exponent)
    cdf /= cdf[-1]
    perm = rs.permutation(dim)

    def draw(n):
        k = np.searchsorted(cdf, rs.random_sample(n), side="right")
        return perm[np.minimum(k, dim - 1)]
    ids = np.sort(draw(rows * nnz).reshape(rows, nnz), axis=1)
    while True:
        dup = np.zeros(ids.shape, bool)
        dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
        n = int(dup.sum())
        if not n:
            return ids
        ids[dup] = draw(n)
        ids.sort(axis=1)


def sparse_data(cfg, path):
    """Write 15b's LibSVM file from the seed; (ids, labels, the initial
    weight (dim, 1))."""
    rs = np.random.RandomState(cfg["seed"])
    ids = zipf_ids(rs, cfg["rows"], cfg["nnz"], cfg["dim"], cfg["zipf"])
    w_true = rs.standard_normal(cfg["dim"])
    labels = (w_true[ids].sum(1) > 0).astype(np.int64)
    w0 = (rs.standard_normal((cfg["dim"], 1)) * cfg["w_scale"]).astype(
        np.float32)
    with open(path, "w") as f:
        for lab, row in zip(labels, ids):
            f.write("%d %s\n" % (lab, " ".join("%d:1" % i for i in row)))
    return ids, labels, w0


class SparseLinear(object):
    """The model and the store of example/sparse/linear_classification.py
    (:60-75) against ``mx`` (either package): a store holding the weight
    (dim, 1), first ``w0``, and the bias, its sgd updating them; a
    row-sparse weight the batches pull into."""

    def __init__(self, mx, dim, lr, w0, ctx):
        self.mx, self.ctx, self.dim = mx, ctx, dim
        nd = mx.nd
        self.kv = mx.kv.create("local")
        self.w = nd.zeros((dim, 1), ctx=ctx).tostype("row_sparse")
        self.b = nd.zeros((1,), ctx=ctx)
        self.kv.init("w", nd.array(w0, ctx=ctx))
        self.kv.init("b", self.b)
        self.kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=lr))

    def step(self, bt, lap=lambda name: None):
        """The loop's body (:93-130) on one batch: row_sparse_pull of its
        rows, nd.sparse.dot(x, w) + b, the mean logistic loss, backward,
        the weight's gradient pushed row-sparse.  ``lap(part)`` closes
        each part.  Returns (loss, correct predictions, rows pulled)."""
        nd, kv = self.mx.nd, self.kv
        x, y = bt.data[0], bt.label[0]
        row_ids = nd.array(np.unique(x.indices.asnumpy().astype(np.int64)),
                           ctx=self.ctx)
        kv.row_sparse_pull("w", out=self.w, row_ids=row_ids)
        kv.pull("b", out=self.b)
        dense_w = self.w.tostype("default")
        lap("pull")
        dense_w.attach_grad()
        self.b.attach_grad()
        with self.mx.autograd.record():
            z = (nd.sparse.dot(x, dense_w) + self.b).reshape((-1,))
            loss = nd.mean(nd.log(1 + nd.exp(-(2 * y - 1) * z)))
        loss.backward()
        lap("forward_backward")
        grad = dense_w.grad.tostype("row_sparse")
        lap("cast")
        kv.push("w", grad)
        kv.push("b", self.b.grad)
        lap("push_update")
        correct = int(((z.asnumpy() > 0) == (y.asnumpy() > 0.5)).sum())
        return float(loss.asscalar()), correct, int(row_ids.shape[0])

    def weights(self):
        nd = self.mx.nd
        w, b = nd.zeros((self.dim, 1), ctx=self.ctx), nd.zeros(
            (1,), ctx=self.ctx)
        self.kv.pull("w", out=w)
        self.kv.pull("b", out=b)
        return w.asnumpy(), b.asnumpy()


def sparse_linear_fit(mx, path, dim, batch, epochs, lr, w0, ctx,
                      sync=lambda: None, times=None):
    """example/sparse/linear_classification.py's training (:77-132): its
    LibSVMIter over ``path`` and :class:`SparseLinear`'s step, ``epochs``
    times.  ``times`` gathers the seconds of each part (iterator, pull,
    forward_backward, cast, push_update) step by step, ``sync`` waiting
    for the device at each boundary.  Returns the loss and accuracy of each epoch, the
    rows each batch pulled, and the store's weight and bias."""
    it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(dim,),
                          batch_size=batch)
    model = SparseLinear(mx, dim, lr, w0, ctx)
    out = dict(loss=[], acc=[], rows=[])
    clock = [time.perf_counter()]

    def lap(name):
        sync()
        t = time.perf_counter()
        if times is not None:
            times.setdefault(name, []).append(t - clock[0])
        clock[0] = t
    for _ in range(epochs):
        it.reset()
        losses, correct, total = [], 0, 0
        clock[0] = time.perf_counter()
        for bt in it:
            lap("iterator")
            loss, right, rows = model.step(bt, lap)
            losses.append(loss)
            correct += right
            total += bt.data[0].shape[0]
            out["rows"].append(rows)
            clock[0] = time.perf_counter()
        out["loss"].append(float(np.mean(losses)))
        out["acc"].append(correct / max(total, 1))
    out["w"], out["b"] = model.weights()
    return out


def sparse_plain_step(torch, ids, labels, w, b, lr):
    """One of 15b's steps in plain torch with dense tensors: the dense
    weight ``w`` (dim,) and bias ``b`` (1,) updated on every row by a dense
    gradient (``index_add_``), no store; ``ids`` (B, k) the batch's
    features (value 1).  Returns the new weight and bias and, per element,
    the bound on |the port's step from the same weights - this one|: the
    two sum the same terms in other orders, so a forward sum of m terms may
    differ by 2m·u·Σ|terms| and a gradient sum of n terms by 2n·u·Σ|terms|
    (u = 2^-24), the loss's derivative by 8u of itself plus what a
    difference e in its input makes (at most e / 4B), and the update by
    its own rounding."""
    f64 = torch.float64
    dev = w.device
    n_b, k = ids.shape
    r = torch.arange(n_b, device=dev).repeat_interleave(k)
    c = torch.as_tensor(ids.reshape(-1), device=dev)
    y = torch.as_tensor(labels, dtype=torch.float32, device=dev)
    terms = w[c]
    z = torch.zeros(n_b, device=dev).index_add_(0, r, terms) + b
    zz = z.detach().requires_grad_(True)
    loss = torch.log(1 + torch.exp(-(2 * y - 1) * zz)).mean()
    dz, = torch.autograd.grad(loss, zz)
    gw = torch.zeros_like(w).index_add_(0, c, dz[r])
    gb = dz.sum().reshape(1)
    rowsum = torch.zeros(n_b, dtype=f64, device=dev).index_add_(
        0, r, terms.abs().double())
    ez = 2 * (k + 1) * U32 * (rowsum + float(b.abs()))
    edz = ez / (4 * n_b) + 8 * U32 * dz.abs().double()
    n_j = torch.zeros(w.numel(), dtype=f64, device=dev).index_add_(
        0, c, torch.ones(c.numel(), dtype=f64, device=dev))
    colsum = torch.zeros_like(n_j).index_add_(0, c, dz[r].abs().double())
    egw = torch.zeros_like(n_j).index_add_(0, c, edz[r]) + \
        2 * n_j * U32 * colsum
    egb = float(edz.sum()) + 2 * n_b * U32 * float(dz.abs().sum())
    ew = lr * egw + torch.where(
        (gw != 0) | (egw > 0),
        U32 * (2 * w.abs().double() + 2 * lr * gw.abs().double()), 0.0)
    eb = lr * egb + U32 * (2 * float(b.abs()) + 2 * lr * float(gb.abs()))
    return w - lr * gw, b - lr * gb, ew, eb


def sum_bound(torch, abs_terms, n_terms):
    """Per output element, how far two sums of the same ``n_terms`` terms
    in other orders may lie apart: 2(n - 1)·u·Σ|terms|."""
    return 2.0 * (n_terms - 1).clamp(min=0) * U32 * abs_terms


def _timed(fn, reps, torch, dev):
    """Mean ms of ``fn()`` on the card after warm-up (``cuda_ms``); None
    on the CPU (a rehearsal)."""
    if dev.type != "cuda":
        fn()
        return None
    return cuda_ms(fn, reps, torch)


def _try_ms(fn, reps, torch, dev, what):
    """``_timed`` of a torch formulation that may not take this size: its
    error is printed and the time is None."""
    try:
        return _timed(fn, reps, torch, dev)
    except (RuntimeError, NotImplementedError, MemoryError) as exc:
        print("sparse 15a: %s not measured (%s: %s)"
              % (what, type(exc).__name__, str(exc)[:160]), flush=True)
        return None


def _host(a):
    return a.asnumpy() if hasattr(a, "asnumpy") else np.asarray(a)


def same_sparse(a, b):
    """Whether two sparse arrays (or two dense ones) hold the same
    components, bit for bit."""
    if a.stype != b.stype:
        return False
    keys = {"csr": ("indptr", "indices", "data"),
            "row_sparse": ("indices", "data")}.get(a.stype)
    if keys is None:
        return np.array_equal(a.asnumpy(), b.asnumpy())
    return all(np.array_equal(_host(getattr(a, k)), _host(getattr(b, k)))
               for k in keys)


def sparse_card_ops(mx, card, dim=SPARSE["dim"], batch=SPARSE["batch"],
                    nnz=SPARSE["nnz"], seed=SEED, reps=SPARSE_REPS):
    """15a: the sparse ops on the card against the port's CPU path on the
    same inputs, f32, at config 5's size: a (batch, dim) CSR batch of
    ``nnz`` distinct Zipf ids a row with normal values, a (dim, 1) weight,
    and row-sparse gradients over the batch's rows.  Structure (indices,
    indptr), casts, retain and add_n must be bit-equal; a product's
    element within ``sum_bound`` of its terms.  Each op's mean ms beside
    the same result in dense torch (``dense_ms``) and through torch's own
    sparse layouts or cuSPARSE (``torch_ms``), where those take the size.
    The updates, elementwise f32 steps on both sides, are held in ulps at
    each output's largest value (``UPDATE_ULP``, as 8d's).  The dense batch
    is batch x dim f32: its casts run while the card has 1.3 times that
    free, else they are reported as not measured."""
    import torch
    nd, sp = mx.nd, mx.nd.sparse
    gpu, cpu = mx.gpu(0), mx.cpu()
    dev = gpu.torch_device()
    cuda = dev.type == "cuda"
    rs = np.random.RandomState(seed + 15)
    ids = zipf_ids(rs, batch, nnz, dim, SPARSE["zipf"])
    vals = rs.standard_normal(ids.size).astype(np.float32)
    indptr = np.arange(0, ids.size + 1, nnz, dtype=np.int64)
    triple = (vals, ids.reshape(-1).astype(np.int64), indptr)
    X = sp.csr_matrix(triple, shape=(batch, dim), ctx=gpu)
    Xc = sp.csr_matrix(triple, shape=(batch, dim), ctx=cpu)
    W0 = rs.standard_normal((dim, 1)).astype(np.float32)
    rows = np.unique(ids)
    G0 = np.zeros((dim, 1), np.float32)
    G0[rows] = rs.standard_normal((rows.size, 1))
    G1 = np.zeros((dim, 1), np.float32)
    G1[rows[::3]] = rs.standard_normal((rows[::3].size, 1))
    D = rs.standard_normal((batch, 1)).astype(np.float32)
    res = dict(shape=[batch, dim], nnz=int(ids.size),
               distinct_rows=int(rows.size), ops={})
    fails = []

    def record(name, ok, err, bound, ms, dense_ms=None, torch_ms=None,
               **extra):
        res["ops"][name] = dict(ok=bool(ok), max_abs_err=err, bound=bound,
                                ms=ms, dense_ms=dense_ms, torch_ms=torch_ms,
                                **extra)
        if not ok:
            fails.append("%s: error %r, bound %r" % (name, err, bound))
        print("sparse 15a: %-36s %s err %.3e (bound %.3e) | ms %s, dense %s, "
              "torch %s | %s" % (name, "ok" if ok else "FAILED", err, bound,
                                 ms, dense_ms, torch_ms, card), flush=True)

    def exact(name, got, want, ms, **kw):
        ok = same_sparse(got, want)
        record(name, ok, 0.0 if ok else float("inf"), 0.0, ms, **kw)

    t_csr = torch.sparse_csr_tensor(X.indptr._data, X.indices._data,
                                    X.data._data, (batch, dim))
    Wg, Dg = nd.array(W0, ctx=gpu), nd.array(D, ctx=gpu)
    dense_ms = {}
    # -- the batch: CSR -> dense -> CSR
    big = 4 * batch * dim
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0] if cuda else 1 << 62
    res["dense_batch"] = dict(bytes=big, free_bytes=int(free))
    if free >= 1.3 * big:
        ms = _timed(lambda: X.tostype("default"), reps, torch, dev)
        torch_ms = _try_ms(lambda: t_csr.to_dense(), reps, torch, dev,
                           "torch's CSR to_dense")
        Xd = X.tostype("default")
        td = Xd._data
        at = td[torch.arange(batch, device=dev).repeat_interleave(nnz),
                X.indices._data]
        step = max(1, (1 << 28) // dim)     # count_nonzero makes int64s
        found = sum(int((td[i:i + step] != 0).sum())
                    for i in range(0, batch, step))
        ok = same_bits(torch, at, X.data._data) and \
            found == int(np.count_nonzero(vals))
        record("cast csr->default (batch)", ok, 0.0 if ok else float("inf"),
               0.0, ms, torch_ms=torch_ms)
        exact("cast default->csr (batch)", Xd.tostype("csr"), Xc,
              _timed(lambda: Xd.tostype("csr"), reps, torch, dev),
              torch_ms=_try_ms(lambda: td.to_sparse_csr(), reps, torch, dev,
                               "torch's to_sparse_csr"))
        dense_ms["dot"] = _try_ms(lambda: td @ Wg._data, reps, torch, dev,
                                  "dense X·W")
        dense_ms["dotT"] = _try_ms(lambda: td.t() @ Dg._data, reps, torch,
                                   dev, "dense Xᵀ·D")
        del Xd, td, at
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    else:
        print("sparse 15a: the dense batch (%d bytes) not measured: %d bytes "
              "free | %s" % (big, free, card), flush=True)
    # -- the weight and a gradient: dense <-> row-sparse <-> CSR
    Wc = nd.array(W0, ctx=cpu)
    Gg, Gc = nd.array(G0, ctx=gpu), nd.array(G0, ctx=cpu)
    for name, src_g, src_c, to, torch_fn in (
            ("cast default->row_sparse", Wg, Wc, "row_sparse",
             lambda: Wg._data.to_sparse(1)),
            ("cast gradient->row_sparse", Gg, Gc, "row_sparse",
             lambda: Gg._data.to_sparse(1)),
            ("cast default->csr", Wg, Wc, "csr",
             lambda: Wg._data.to_sparse_csr())):
        exact(name, src_g.tostype(to), src_c.tostype(to),
              _timed(lambda: src_g.tostype(to), reps, torch, dev),
              torch_ms=_try_ms(torch_fn, reps, torch, dev, name))
    Rg, Rc = Wg.tostype("row_sparse"), Wc.tostype("row_sparse")
    Cg, Cc = Wg.tostype("csr"), Wc.tostype("csr")
    for name, src_g, src_c, to in (
            ("cast row_sparse->default", Rg, Rc, "default"),
            ("cast row_sparse->csr", Rg, Rc, "csr"),
            ("cast csr->row_sparse", Cg, Cc, "row_sparse"),
            ("cast csr->default", Cg, Cc, "default")):
        exact(name, src_g.tostype(to), src_c.tostype(to),
              _timed(lambda: src_g.tostype(to), reps, torch, dev))
    # -- retain every other row of the gradient
    Sg, Sc = Gg.tostype("row_sparse"), Gc.tostype("row_sparse")
    keep = nd.array(rows[::2].astype(np.float32), ctx=gpu)
    mask = torch.zeros(dim, 1, dtype=torch.bool, device=dev)
    mask[torch.as_tensor(rows[::2], device=dev)] = True
    exact("retain", sp.retain(Sg, keep), sp.retain(Sc, rows[::2]),
          _timed(lambda: sp.retain(Sg, keep), reps, torch, dev),
          dense_ms=_timed(lambda: torch.where(mask, Gg._data, 0.0), reps,
                          torch, dev))
    # -- products, and their backward into the dense operand
    per_row = torch.full((batch, 1), float(nnz), dtype=torch.float64)
    per_col = torch.zeros(dim, 1, dtype=torch.float64).index_add_(
        0, torch.as_tensor(triple[1]), torch.ones(ids.size, 1,
                                                  dtype=torch.float64))
    absX = sp.csr_matrix((np.abs(vals), triple[1], indptr),
                         shape=(batch, dim), ctx=cpu)
    absW, absD = nd.array(np.abs(W0), ctx=cpu), nd.array(np.abs(D), ctx=cpu)
    Dc = nd.array(D, ctx=cpu)

    def product(name, fn_g, fn_c, abs_terms, n_terms, dense, torch_fn):
        got, again, want = fn_g(), fn_g(), fn_c()
        diff = (got._data.double().cpu() - want._data.double()).abs()
        bound = sum_bound(torch, abs_terms._data.double(), n_terms)
        repeat = same_bits(torch, got._data, again._data)
        record(name, bool((diff <= bound).all()) and repeat,
               float(diff.max()), float(bound.max()),
               _timed(fn_g, reps, torch, dev), dense_ms=dense,
               torch_ms=_try_ms(torch_fn, reps, torch, dev, name),
               repeats_bit_equal=repeat)

    def backward(lhs, rhs, head, transpose):
        r = rhs.copy()
        r.attach_grad()
        with mx.autograd.record():
            out = sp.dot(lhs, r, transpose_a=transpose)
        out.backward(head)
        return r.grad

    Hg, Hc, Vg, Vc = Dg, Dc, Wg, Wc
    product("dot csr·dense", lambda: sp.dot(X, Wg), lambda: sp.dot(Xc, Wc),
            sp.dot(absX, absW), per_row, dense_ms.get("dot"),
            lambda: torch.sparse.mm(t_csr, Wg._data))
    product("dot csrᵀ·dense", lambda: sp.dot(X, Dg, transpose_a=True),
            lambda: sp.dot(Xc, Dc, transpose_a=True),
            sp.dot(absX, absD, transpose_a=True), per_col,
            dense_ms.get("dotT"),
            lambda: torch.sparse.mm(t_csr.t(), Dg._data))
    product("dot csr·dense, backward", lambda: backward(X, Wg, Hg, False),
            lambda: backward(Xc, Wc, Hc, False),
            sp.dot(absX, absD, transpose_a=True), per_col, None,
            lambda: torch.sparse.mm(t_csr.t(), Hg._data))
    product("dot csrᵀ·dense, backward", lambda: backward(X, Dg, Vg, True),
            lambda: backward(Xc, Dc, Vc, True), sp.dot(absX, absW), per_row,
            None, lambda: torch.sparse.mm(t_csr, Vg._data))
    # -- add_n of row-sparse gradients: a row sums at most two terms, and
    # IEEE addition commutes, so bit-equal
    S1g = nd.array(G1, ctx=gpu).tostype("row_sparse")
    S1c = nd.array(G1, ctx=cpu).tostype("row_sparse")
    G1g = nd.array(G1, ctx=gpu)
    exact("add_n row_sparse", sp.add_n(Sg, S1g), sp.add_n(Sc, S1c),
          _timed(lambda: sp.add_n(Sg, S1g), reps, torch, dev),
          dense_ms=_timed(lambda: Gg._data + G1g._data, reps, torch, dev))
    # -- the lazy updates against the CPU, bit for bit
    untouched = np.setdiff1d(np.arange(dim), rows)
    for kw in SPARSE_UPDATES:
        kw = dict(kw, lr=0.1, rescale_grad=1.0 / batch)
        mom = kw["momentum"] != 0.0
        if not mom:
            del kw["momentum"]
        op = "_sparse_sgd_mom_update" if mom else "_sparse_sgd_update"
        dense_op = "sgd_mom_update" if mom else "sgd_update"

        def lazy(w, s, m, op=op, kw=kw):
            args = [w, s.data, s.indices] + ([m] if mom else [])
            return getattr(nd, op)(*args, out=w, **kw)
        outs = []
        for ctx_, W_, S_ in ((gpu, Wg, Sg), (cpu, Wc, Sc)):
            w, m = W_.copy(), nd.zeros((dim, 1), ctx=ctx_) + 0.5
            lazy(w, S_, m)
            outs.append((w._data, m._data))
        err = max(_ulp_err(a, b, "max") for a, b in zip(*outs))
        ok = err <= UPDATE_ULP and np.array_equal(
            outs[0][0].cpu().numpy()[untouched], W0[untouched])
        wg, mg = Wg.copy(), nd.zeros((dim, 1), ctx=gpu)
        dense_args = [wg, Gg] + ([mg] if mom else [])
        record("lazy %s %s" % (op, json.dumps(
            {k: kw.get(k, 0.0) for k in ("momentum", "wd", "clip_gradient")})),
               ok, err, UPDATE_ULP,
               _timed(lambda: lazy(wg, Sg, mg), reps, torch, dev),
               dense_ms=_timed(lambda: getattr(nd, dense_op)(
                   *dense_args, out=wg, **kw), reps, torch, dev))
    res["failures"] = fails
    res["ok"] = not fails
    del X, t_csr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return res


def sparse_train(mx, card, cfg=SPARSE):
    """15b: BASELINE config 5 through the port on the card
    (``sparse_linear_fit``): the loss falls; ms a step by part, the rows a
    batch pulls, one step's device busy time.  Then the same training again
    as a witness: each step's weights (the store's, pulled whole) within
    ``sparse_plain_step``'s bound of a plain dense step from the weights
    before it, the final weights bit-equal to the first run's; and a free
    plain rerun of all the steps from the first weights, whose distance to
    the port is reported.  Rows no batch touched keep their first values
    bit for bit in all three."""
    import tempfile
    import torch
    gpu = mx.gpu(0)
    dev = gpu.torch_device()
    cuda = dev.type == "cuda"
    res = dict(config=dict(cfg), source="example/sparse/linear_"
               "classification/train.py (MXNet 1.2): Avazu, 1,000,000 "
               "features, batch 8192")
    batch, lr = cfg["batch"], cfg["lr"]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "train.libsvm")
        t0 = time.perf_counter()
        ids, labels, w0 = sparse_data(cfg, path)
        res["data_s"] = time.perf_counter() - t0
        res["file_bytes"] = os.path.getsize(path)
        t0 = time.perf_counter()
        it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(cfg["dim"],),
                              batch_size=batch)
        res["parse_s"] = time.perf_counter() - t0
        first = it.next()
        check(np.array_equal(first.data[0].indices.asnumpy(),
                             ids[:batch].reshape(-1)) and
              np.array_equal(first.label[0].asnumpy(), labels[:batch]),
              "15b: LibSVMIter's first batch differs from the rows written")
        times = {}
        sync = torch.cuda.synchronize if cuda else (lambda: None)
        t0 = time.perf_counter()
        fit = sparse_linear_fit(mx, path, cfg["dim"], batch, cfg["epochs"],
                                lr, w0, gpu, sync, times)
        res["train_s"] = time.perf_counter() - t0
        res["steps"] = len(fit["rows"])
        # the first step loads the kernels: its ms apart, the mean of the rest
        res["first_step_ms"] = {k: 1e3 * v[0] for k, v in times.items()}
        res["ms_a_step"] = {k: 1e3 * float(np.mean(v[1:]))
                            for k, v in times.items()}
        for row in (res["first_step_ms"], res["ms_a_step"]):
            row["total"] = sum(row.values())
        res["distinct_rows_a_batch"] = dict(
            mean=float(np.mean(fit["rows"])), min=min(fit["rows"]),
            max=max(fit["rows"]))
        res["loss_by_epoch"], res["acc_by_epoch"] = fit["loss"], fit["acc"]
        check(fit["loss"][-1] < fit["loss"][0],
              "15b: the loss did not fall: %s" % fit["loss"])
        plain = [(ids[i * batch:(i + 1) * batch],
                  labels[i * batch:(i + 1) * batch])
                 for i in range(cfg["rows"] // batch)]
        # the witness, step by step
        model = SparseLinear(mx, cfg["dim"], lr, w0, gpu)
        wit = dict(max_abs_err=0.0, bound_max=0.0, worst_share=0.0,
                   bias_err=0.0, ok=True)
        for _ in range(cfg["epochs"]):
            it.reset()
            for bt, (b_ids, b_labels) in zip(it, plain):
                wb, bb = (torch.as_tensor(a.reshape(-1), device=dev)
                          for a in model.weights())
                model.step(bt)
                wa, ba = (torch.as_tensor(a.reshape(-1), device=dev)
                          for a in model.weights())
                pw, pb, ew, eb = sparse_plain_step(torch, b_ids, b_labels, wb,
                                                   bb, lr)
                err = (wa.double() - pw.double()).abs()
                berr = abs(float(ba[0]) - float(pb[0]))
                wit["ok"] &= bool((err <= ew).all()) and berr <= eb
                wit["max_abs_err"] = max(wit["max_abs_err"], float(err.max()))
                wit["bound_max"] = max(wit["bound_max"], float(ew.max()))
                wit["worst_share"] = max(wit["worst_share"], float(
                    (err / ew.clamp(min=1e-300)).max()))
                wit["bias_err"] = max(wit["bias_err"], berr)
        again = model.weights()
        wit["final_bit_equal_to_first_run"] = bool(
            np.array_equal(again[0], fit["w"]) and
            np.array_equal(again[1], fit["b"]))
        res["witness"] = wit
        check(wit["ok"] and wit["final_bit_equal_to_first_run"],
              "15b: the steps differ from plain dense steps beyond the "
              "bound, or the run does not repeat: %s" % wit)
        # the free plain rerun
        w = torch.as_tensor(w0.reshape(-1), device=dev)
        b = torch.zeros(1, device=dev)
        for _ in range(cfg["epochs"]):
            for b_ids, b_labels in plain:
                w, b, _, _ = sparse_plain_step(torch, b_ids, b_labels, w, b,
                                               lr)
        wp = torch.as_tensor(fit["w"].reshape(-1), device=dev)
        res["plain_rerun"] = dict(
            max_abs_err=float((wp - w).abs().max()),
            bit_equal_rows=int((wp == w).sum()),
            bias_err=abs(float(fit["b"][0]) - float(b[0])))
        touched = np.zeros(cfg["dim"], bool)
        touched[ids.reshape(-1)] = True
        res["untouched_rows"] = int((~touched).sum())
        check(np.array_equal(fit["w"][~touched], w0[~touched]) and
              np.array_equal(w.cpu().numpy()[~touched],
                             w0.reshape(-1)[~touched]),
              "15b: rows no batch touched moved")
        if cuda:
            res["profile"] = sparse_step_profile(mx, it, cfg, w0)
    print("sparse 15b: %s | %s" % (json.dumps(res, default=str), card),
          flush=True)
    return res


def sparse_step_profile(mx, it, cfg, w0):
    """One step of 15b's loop (:class:`SparseLinear`, the batch already
    read) under torch.profiler (``profiled``: an untimed step, then the
    timed one): wall and device busy us, the idle share, the top
    kernels."""
    model = SparseLinear(mx, cfg["dim"], cfg["lr"], w0, mx.gpu(0))
    it.reset()
    batches = [it.next(), it.next()]
    prof, wall_us = profiled(lambda: model.step(batches.pop()))
    kernels = trace_kernels(prof)
    busy = sum(us for us, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
    return dict(wall_us=wall_us, busy_us=busy,
                idle_share=1 - busy / wall_us if wall_us else None,
                kernels=sum(n for _, n in kernels.values()),
                top=[(name[:80], round(us, 1), n)
                     for name, (us, n) in top])


def sparse_records(mx, card, dim=SPARSE["dim"], batch=SPARSE["batch"],
                   nnz=SPARSE["nnz"], seed=SEED):
    """15c: a CSR batch and a row-sparse gradient saved with ``nd.save``
    and loaded back on the card, bit-equal; ``rand_ndarray`` of each
    sparse stype at the density asked (within 5 standard deviations)."""
    import tempfile
    rs = np.random.RandomState(seed + 16)
    ids = zipf_ids(rs, batch, nnz, dim, SPARSE["zipf"])
    gpu = mx.gpu(0)
    sp = mx.nd.sparse
    X = sp.csr_matrix((rs.standard_normal(ids.size).astype(np.float32),
                       ids.reshape(-1),
                       np.arange(0, ids.size + 1, nnz)),
                      shape=(batch, dim), ctx=gpu)
    rows = np.unique(ids)
    G = sp.row_sparse_array((rs.standard_normal((rows.size, 1)).astype(
        np.float32), rows), shape=(dim, 1), ctx=gpu)
    res = {}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "sparse.params")
        t0 = time.perf_counter()
        mx.nd.save(path, {"batch": X, "grad": G})
        res["save_s"] = time.perf_counter() - t0
        res["file_bytes"] = os.path.getsize(path)
        t0 = time.perf_counter()
        back = mx.nd.load(path)
        res["load_s"] = time.perf_counter() - t0
    res["bit_equal"] = dict(
        batch=back["batch"].stype == "csr" and same_sparse(back["batch"], X),
        grad=back["grad"].stype == "row_sparse" and
        same_sparse(back["grad"], G),
        on_card=all(c._data.is_cuda for a in back.values()
                    for c in a._components()))
    check(all(res["bit_equal"].values()), "15c: %s" % res["bit_equal"])
    np.random.seed(seed)
    res["density"] = {}
    for stype, shape, want in (("csr", (2048, 4096), 0.05),
                               ("row_sparse", (4096, 64), 0.02)):
        a = mx.test_utils.rand_ndarray(shape, stype, density=want, ctx=gpu)
        got = float(np.count_nonzero(a.data.asnumpy())) / np.prod(shape)
        sigma = math.sqrt(want * (1 - want) / np.prod(shape))
        res["density"][stype] = dict(asked=want, got=got)
        check(a.stype == stype and abs(got - want) <= 5 * sigma,
              "15c: rand_ndarray(%s) density %r, asked %r" % (stype, got,
                                                              want))
    print("sparse 15c: %s | %s" % (json.dumps(res), card), flush=True)
    return res


def sparse_bulk(mx, card, dim=SPARSE["dim"], rows=50000, seed=SEED):
    """15d: the lazy update (sgd with momentum and wd on a row-sparse
    gradient) twice inside ``mx.engine.bulk(16)``, each followed by a read
    of the weight through an op, against the same eagerly: weights and
    momentum bit-equal; the flushes counted (one a scope, the second
    scope a replay of the first's graph)."""
    import torch
    nd = mx.nd
    gpu = mx.gpu(0)
    rs = np.random.RandomState(seed + 17)
    w0 = rs.standard_normal((dim, 1)).astype(np.float32)
    idx = np.sort(rs.choice(dim, rows, replace=False))
    grad = nd.sparse.row_sparse_array(
        (rs.standard_normal((rows, 1)).astype(np.float32), idx),
        shape=(dim, 1), ctx=gpu)

    def run(bulked):
        opt = mx.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=1e-4)
        w = nd.array(w0, ctx=gpu)
        state = opt.create_state(0, w)
        sums = []
        for _ in range(2):
            if bulked:
                with mx.engine.bulk(16):
                    opt.update(0, w, grad, state)
                    s = (w * 1.0).sum()
            else:
                opt.update(0, w, grad, state)
                s = (w * 1.0).sum()
            sums.append(s.asnumpy())
        return w._data.clone(), state._data.clone(), sums
    we, se, sums_e = run(False)
    mx.engine.reset_flush_stats()
    wb, sb, sums_b = run(True)
    stats = mx.engine.flush_stats()
    res = dict(bit_equal=same_bits(torch, we, wb) and same_bits(torch, se, sb)
               and all(np.array_equal(a, b) for a, b in zip(sums_e, sums_b)),
               flushes=sum(stats["causes"].values()), causes=stats["causes"],
               graphs=stats["graphs"],
               untouched_equal=bool(np.array_equal(
                   np.delete(wb.cpu().numpy(), idx, 0),
                   np.delete(w0, idx, 0))))
    check(res["bit_equal"] and res["untouched_equal"] and
          res["flushes"] == 2 and stats["causes"]["scope-close"] == 2,
          "15d: %s" % res)
    if gpu.torch_device().type == "cuda":
        check(stats["graphs"]["captures"] == 1 and
              stats["graphs"]["replays"] == 1, "15d: graphs %s" % res)
    print("sparse 15d: %s | %s" % (json.dumps(res, default=str), card),
          flush=True)
    return res


def register_host_sync(mx):
    """Register ``HOST_SYNC_OP`` (x + 1 after waiting for the card), which
    claims ``deferrable=True``: a capture that reaches it fails, as a
    capture of any op that synchronizes does."""
    import torch
    from incubator_mxnet_tpu_torch.ops import registry
    if HOST_SYNC_OP not in registry._REGISTRY:
        def host_sync(data):
            if data.is_cuda:
                torch.cuda.synchronize(data.device)
            return data + 1
        registry.register(HOST_SYNC_OP, num_inputs=1)(host_sync)
    return registry.get_op(HOST_SYNC_OP)


def c11_contract(mx, card, shape=(256, 1024), seed=SEED):
    """15e (ROADMAP C11): a capture that fails inside a block that drew
    random numbers (Dropout, then an op that waits for the card) raises
    MXNetError naming the block, and afterwards the card's next draw works
    and equals an eager run of the same calls from the same seed; a second
    hybridized block with Dropout then captures and replays, bit-equal to
    eager.  The same for a bulk segment."""
    import torch
    from incubator_mxnet_tpu_torch.base import MXNetError
    from incubator_mxnet_tpu_torch import random_state
    nd = mx.nd
    gpu = mx.gpu(0)
    dev = gpu.torch_device()
    sync_op = register_host_sync(mx)
    x = nd.array(np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32), ctx=gpu)

    class Drop(mx.gluon.HybridBlock):
        def __init__(self, sync, **kw):
            super().__init__(**kw)
            self.sync = sync
            with self.name_scope():
                self.drop = mx.gluon.nn.Dropout(0.5)

        def hybrid_forward(self, F, v):
            y = self.drop(v)
            return F.invoke(sync_op, [y], {}) if self.sync else y * 2

    def draw():
        return nd.random.uniform(shape=(64,), ctx=gpu)._data.clone()

    res = {}
    for what in ("CachedOp", "bulk"):
        def call():
            with mx.autograd.train_mode():
                if what == "CachedOp":
                    return bad(x)
                with mx.engine.bulk(16):
                    y = nd.Dropout(x, p=0.5)
                    z = nd.invoke(sync_op, [y], {})
                return z
        bad = Drop(True, prefix="c11_%s_bad_" % what.lower())
        bad.initialize(ctx=gpu)
        mx.random.seed(seed + 7)
        with mx.autograd.train_mode():
            bad(x) if what == "CachedOp" else nd.invoke(
                sync_op, [nd.Dropout(x, p=0.5)], {})
        want = draw()
        bad.hybridize()
        mx.random.seed(seed + 7)
        old = random_state.generator(dev)
        err = None
        try:
            call()._data
        except MXNetError as exc:
            err = str(exc)
        after = draw()
        named = err is not None and (
            "CachedOp(%s)" % bad.name in err if what == "CachedOp"
            else "bulk engine segment" in err)
        good = Drop(False, prefix="c11_%s_good_" % what.lower())
        good.initialize(ctx=gpu)
        runs = []
        for hyb in (False, True):
            good.hybridize(hyb)
            mx.random.seed(seed + 9)
            outs = []
            for _ in range(3):
                with mx.autograd.train_mode():
                    if what == "CachedOp":
                        outs.append(good(x)._data.clone())
                    else:
                        if hyb:
                            with mx.engine.bulk(16):
                                o = nd.Dropout(x, p=0.5) * 2
                        else:
                            o = nd.Dropout(x, p=0.5) * 2
                        outs.append(o._data.clone())
            runs.append(outs)
        res[what] = dict(
            raised=err is not None, names_it=named,
            error=(err or "")[:200],
            draw_equal_to_eager=same_bits(torch, after, want),
            generator_replaced=random_state.generator(dev) is not old,
            second_block_bit_equal=all(same_bits(torch, a, b)
                                       for a, b in zip(*runs)),
            masks_differ=not torch.equal(runs[1][0], runs[1][1]))
        check(all(v for k, v in res[what].items() if k != "error"),
              "15e %s: %s" % (what, res[what]))
    print("sparse 15e: C11 %s | %s" % (json.dumps(res), card), flush=True)
    return res


def sparse_phase(mx, card):
    """Phase 15: sparse storage on the card (15a-15e)."""
    import torch
    t0 = time.perf_counter()
    out = dict(ops=sparse_card_ops(mx, card))
    check(out["ops"]["ok"], "15a: %s" % out["ops"]["failures"])
    out["train"] = sparse_train(mx, card)
    out["records"] = sparse_records(mx, card)
    out["bulk"] = sparse_bulk(mx, card)
    out["c11"] = c11_contract(mx, card)
    out["seconds"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    print("sparse: phase 15 in %.1f s | %s" % (out["seconds"], card),
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 16: several devices and processes (parallel/dist.py, parallel/ps.py,
# the Module, Trainer and DataParallelTrainer over several contexts): 16a
# the dist stores across ranks, 16b BASELINE config 2 across two ranks on
# the card, 16c the LM across two ranks through DataParallelTrainer over
# worker_mesh() (kernel B1 on every rank), 16d several contexts in one
# process, 16e one rank a card on a machine of two cards or more.  The
# ranks are processes of this script started through tools/launch.py
# (``dist_worker``); a rank that fails fails the smoke.
# ---------------------------------------------------------------------------
DIST_RANKS = 2
DIST_BIG = 1 << 24              # f32 elements of 16a's reduces
# 16b: train_imagenet.py's ResNet-50 v1, f32, global batch 256 as 2 x 128,
# one warm-up step and 1 timed (3 until the smoke's time was cut for phase
# 18), Module.fit then a hybridized gluon.Trainer
DIST_RESNET = dict(batch=128, warmup=1, steps=1, classes=1000, lr=0.05,
                   momentum=0.9, wd=1e-4, image=224)
# 16c: bench_transformer.py:64-70's LM at full width, global batch 8 as 2 x
# 4, one warm-up step and 1 timed (4d's optimizer and dtype); its depth cut
# to 1 of the 4 layers and 1 timed step for the smoke's time (2 layers and
# 3 steps until phase 18; 17b trains 2 across the ranks; the gradient
# all-reduce is the same path at any depth)
DIST_LM = dict(batch=4, warmup=1, steps=1, layers=1)
# what a 16c rank holds beyond dist_lm_layers' model of it (workspaces,
# the loss's f32 logits): 24.33 GB measured against 22.41 GB modelled
DIST_LM_SLACK = 2 << 30
DIST_TIMEOUT = {"store": 240, "nccl": 180, "resnet": 420, "lm": 480}
# 16d: several contexts in one process against one context, BASELINE
# config 1's nets from common.py's Xavier.  After one step the contexts'
# gradients differ from one card's by the order of their sums and by the
# kernels their batch sizes pick (~1e-7 to 1e-5 of max |w|); 2 epochs of
# momentum carry that (LeNet 3.4e-6 of max |w| over cpu(0..3) against
# cpu(0) on the CPU, 5.3e-3 over four cards against one)
MIXED_REL, MIXED_END_REL = 1e-4, 2e-2
ROOT = os.path.dirname(os.path.abspath(__file__))


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(task, n, out_dir, timeout, *args, cards=None):
    """``dist_worker(task, out_dir, *args)`` in ``n`` processes started by
    tools/launch.py (the repo on PYTHONPATH, a free coordinator port; with
    ``cards``, only the first ``cards`` cards visible to them, so that
    ranks share a card on a machine of several); prints their output;
    fails the smoke if a rank exits non-zero or the job outlives
    ``timeout`` (its whole process group is killed).  Returns each rank's
    result (``<task>-rank<r>.json`` under ``out_dir``)."""
    import signal
    script = os.path.join(out_dir, "dist_worker.py")
    with open(script, "w") as f:
        f.write("import sys\nsys.path.insert(0, %r)\nimport chip_smoke\n"
                "chip_smoke.dist_worker(sys.argv[1:])\n" % ROOT)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    if cards is not None:
        env["CUDA_VISIBLE_DEVICES"] = ",".join(map(str, range(cards)))
    cmd = [sys.executable, os.path.join(ROOT, "tools", "launch.py"), "-n",
           str(n), "-p", str(_free_port()), sys.executable, script, task,
           out_dir] + [str(a) for a in args]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        out, _ = proc.communicate()
        print(out[-6000:], flush=True)
        fail("dist %s: %d ranks outlived %d s; killed" % (task, n, timeout))
    for line in out.splitlines():
        if "hostname of the client socket" not in line:
            print("  | " + line, flush=True)
    check(proc.returncode == 0, "dist %s: %d ranks through tools/launch.py "
          "exited %d" % (task, n, proc.returncode))
    results = []
    for r in range(n):
        with open(os.path.join(out_dir, "%s-rank%d.json" % (task, r))) as f:
            results.append(json.load(f))
    print("dist %s: %d ranks in %.1f s (process start, imports and the "
          "process group included)" % (task, n, time.perf_counter() - t0),
          flush=True)
    return results


def dist_worker(argv):
    """A rank of phase 16 (started by :func:`launch_ranks`): runs one task
    and writes its result to ``<task>-rank<r>.json`` under the out
    directory."""
    import torch
    import torch.distributed
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.parallel import dist
    task, out_dir, args = argv[0], argv[1], argv[2:]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process()
    rank = dist.rank()
    torch.cuda.set_device(dist.local_context().torch_device())
    wire = WireClock(dist, torch)
    result = {"store": dist_store_task, "nccl": dist_nccl_task,
              "resnet": dist_resnet_task, "lm": dist_lm_task,
              "parallel": par_task}[task](
                  mx, dist, wire, out_dir, *args)
    result["rank"] = rank
    with open(os.path.join(out_dir, "%s-rank%d.json" % (task, rank)),
              "w") as f:
        json.dump(result, f)
    dist.barrier()
    torch.distributed.destroy_process_group()


class WireClock(object):
    """Times each ``all_reduce`` of the stores and trainers (the card
    synchronized before and after) and counts its bytes."""

    def __init__(self, dist, torch):
        self.calls, self.bytes, self.ms = 0, 0, 0.0
        inner = dist._global_sum

        def timed(flat, group=None):
            if flat.is_cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(flat, group)
            if flat.is_cuda:
                torch.cuda.synchronize()
            self.ms += (time.perf_counter() - t0) * 1e3
            self.calls += 1
            self.bytes += flat.numel() * flat.element_size()
            return out

        dist._global_sum = timed

    def reset(self):
        self.calls, self.bytes, self.ms = 0, 0, 0.0

    def read(self, steps=1):
        return dict(calls=self.calls, bytes=self.bytes, ms=self.ms,
                    ms_a_step=self.ms / max(steps, 1),
                    bytes_a_step=self.bytes // max(steps, 1))


def dist_store_task(mx, dist, wire, out_dir, big=DIST_BIG):
    """16a on one rank: the store invariants of
    tests/test_dist_multiprocess.py:48-125 on card tensors under dist_sync
    (two ranks share the card over gloo), dist_async through the
    parameter service, barrier; a (big,) f32 all-reduce timed; then
    dist_device_sync must refuse ranks that share a card."""
    import torch
    big = int(big)
    rank, nw = dist.rank(), dist.num_workers()
    ctx = dist.local_context()
    nd = mx.nd
    checks = {}
    with ctx:
        kv = mx.kv.create("dist_sync")
        kv.init("w", nd.zeros((3, 2)))
        kv.push("w", nd.ones((3, 2)) * (rank + 1))
        out = nd.zeros((3, 2))
        kv.pull("w", out=out)
        checks["sum"] = bool((out.asnumpy() == nw * (nw + 1) / 2).all()) \
            and out.context == ctx and out._data.is_cuda
        kv.init(["a", "b", "i", "l"],
                [nd.zeros(2), nd.zeros(2), nd.zeros(3, dtype="int32"),
                 nd.array(np.zeros(2), dtype="int64")])
        big_ints = np.array([(1 << 40) + 3, (1 << 41) + 5])
        kv.push(["a", "b", "i", "l"],
                [nd.ones(2) * (rank + 1), nd.ones(2) * 10 * (rank + 1),
                 nd.array(np.full(3, 1000003 * (rank + 1)), dtype="int32"),
                 nd.array(big_ints * (rank + 1), dtype="int64")])
        outs = [nd.zeros(2), nd.zeros(2), nd.zeros(3, dtype="int32"),
                nd.array(np.zeros(2), dtype="int64")]
        kv.pull(["a", "b", "i", "l"], out=outs)
        tri = nw * (nw + 1) // 2
        checks["multi_key"] = outs[0].asnumpy().tolist() == [tri] * 2 and \
            outs[1].asnumpy().tolist() == [10 * tri] * 2
        checks["integers_exact"] = \
            outs[2].asnumpy().tolist() == [1000003 * tri] * 3 and \
            outs[3].asnumpy().tolist() == (big_ints * tri).tolist()
        kv.init("rs", nd.zeros((6, 3)))
        dense = np.zeros((6, 3), np.float32)
        for r in [rank % 2, 2 + rank % 2, 4]:
            dense[r] = rank + 1
        kv.push("rs", nd.array(dense).tostype("row_sparse"))
        ors = nd.zeros((6, 3))
        kv.pull("rs", out=ors)
        want = np.zeros((6, 3), np.float32)
        for r in range(nw):
            for row in [r % 2, 2 + r % 2, 4]:
                want[row] += r + 1
        checks["row_sparse_union"] = bool(np.array_equal(ors.asnumpy(),
                                                          want))
        kva = mx.kv.create("dist_async")
        kva.init("aw", nd.ones((4,)) * 10.0)
        kva.set_optimizer(mx.optimizer.create("sgd", learning_rate=1.0))
        kva.push("aw", nd.ones((4,)) * (rank + 1))
        kva.barrier()
        oa = nd.zeros((4,))
        kva.pull("aw", out=oa)
        checks["dist_async_sgd_on_server"] = \
            oa.asnumpy().tolist() == [10.0 - tri] * 4
        kva.barrier()
        kva.close()
        t0 = time.perf_counter()
        kv.barrier()
        barrier_ms = (time.perf_counter() - t0) * 1e3
        checks["barrier"] = True
        buf = torch.full((big,), float(rank + 1), device=ctx.torch_device())
        dist._global_sum(buf, kv._group)        # the wire's first use
        wire.reset()
        for _ in range(3):
            buf.fill_(float(rank + 1))
            dist._global_sum(buf, kv._group)
        checks["big_sum"] = bool((buf == tri).all().item())
        gloo = wire.read(3)
        try:
            mx.kv.create("dist_device_sync")
            refused = None
        except mx.MXNetError as exc:
            refused = str(exc)
        checks["shared_card_refused"] = refused is not None and \
            "share the card" in refused
    print("dist 16a rank %d of %d on %s: dist_sync over gloo, card tensors: "
          "%s; a (%d,) f32 all-reduce %.3f ms (%d bytes, mean of 3); barrier "
          "%.3f ms; dist_device_sync with the card shared: %r"
          % (rank, nw, ctx, checks, big, gloo["ms_a_step"],
             big * 4, barrier_ms, refused), flush=True)
    return dict(checks=checks, gloo_allreduce=gloo, barrier_ms=barrier_ms,
                refusal=refused)


def dist_nccl_task(mx, dist, wire, out_dir, big=DIST_BIG):
    """16a's NCCL half: dist_device_sync with one rank a card, a (big,)
    f32 all-reduce over NCCL, and a push through the store."""
    import torch
    big = int(big)
    rank, nw = dist.rank(), dist.num_workers()
    ctx = dist.local_context()
    with ctx:
        kv = mx.kv.create("dist_device_sync")
        buf = torch.full((big,), float(rank + 1), device=ctx.torch_device())
        dist._global_sum(buf, kv._group)        # NCCL's communicator
        wire.reset()
        for _ in range(3):
            buf.fill_(float(rank + 1))
            dist._global_sum(buf, kv._group)
        tri = nw * (nw + 1) // 2
        summed = bool((buf == tri).all().item())
        kv.init(0, mx.nd.zeros((1024,)))
        kv.push(0, mx.nd.ones((1024,)) * (rank + 1))
        out = mx.nd.zeros((1024,))
        kv.pull(0, out=out)
        pushed = bool((out.asnumpy() == tri).all())
    nccl = wire.read(3)
    version = ".".join(map(str, torch.cuda.nccl.version())) \
        if hasattr(torch.cuda, "nccl") else "unknown"
    print("dist 16a rank %d of %d on %s: dist_device_sync over NCCL %s: a "
          "(%d,) f32 all-reduce %.3f ms (mean of 3), sum %s; push/pull %s"
          % (rank, nw, ctx, version, big, nccl["ms_a_step"], summed, pushed),
          flush=True)
    return dict(summed=summed, pushed=pushed, nccl_allreduce=nccl,
                nccl_version=version)


def xavier_weights(names, shapes, seed=SEED, magnitude=2.0):
    """common.py's ``mx.init.Xavier(magnitude=2.0)`` (uniform, fan
    average) drawn from numpy under ``seed``, the same in every process:
    weights uniform in +-sqrt(magnitude / ((fan_in + fan_out) / 2)),
    BatchNorm's gamma and moving variance 1, biases, beta and moving mean
    0."""
    rs = np.random.RandomState(seed)
    out = {}
    for name, shape in zip(names, shapes):
        shape = tuple(shape)
        if name.endswith("_weight"):
            rf = int(np.prod(shape[2:]))
            fan_in, fan_out = shape[1] * rf, shape[0] * rf
            scale = np.sqrt(magnitude / ((fan_in + fan_out) / 2.0))
            out[name] = rs.uniform(-scale, scale, shape).astype(np.float32)
        elif name.endswith(("_gamma", "_var")):
            out[name] = np.ones(shape, np.float32)
        else:
            out[name] = np.zeros(shape, np.float32)
    return out


def resnet_module_init(mx, sym, batch, image, seed=SEED):
    """The ResNet-50 symbol's (arg, aux) weights from ``seed`` through
    :func:`xavier_weights`."""
    arg_shapes, _, aux_shapes = sym.infer_shape(
        data=(batch, 3, image, image), softmax_label=(batch,))
    names = [n for n in sym.list_arguments()
             if n not in ("data", "softmax_label")]
    args = xavier_weights(names, [s for n, s in zip(sym.list_arguments(),
                                                    arg_shapes)
                                  if n in names], seed)
    aux = xavier_weights(sym.list_auxiliary_states(), aux_shapes, seed)
    return args, aux


def dist_images(cfg, nw, seed=3):
    """train_imagenet.py synthetic_iters' batches (:50-77) for ``nw``
    ranks: (images, labels) of rank r are ``[r::nw]`` of the whole set,
    ``warmup + steps`` batches each."""
    n = cfg["batch"] * nw * (cfg["warmup"] + cfg["steps"])
    rs = np.random.RandomState(seed)
    y = (rs.rand(n) * cfg["classes"]).astype(np.int64)
    x = rs.rand(n, 3, cfg["image"], cfg["image"]).astype(np.float32)
    x[np.arange(n), 0, 0, 0] = y / float(cfg["classes"])
    return x, y.astype(np.float32)


def dist_resnet_task(mx, dist, wire, out_dir, cfg, kind="dist_sync"):
    """16b on one rank: its shard of train_imagenet.py's synthetic batches
    through Module.fit(kvstore=kind) on the ResNet-50 symbol (f32), then
    through a hybridized gluon ResNet-50 v1 and gluon.Trainer(kvstore=
    kind); each part's final weights saved for the ranks' and the
    reference's comparison.  ``cfg``: DIST_RESNET's keys, as JSON."""
    import torch
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    cfg = json.loads(cfg)
    rank, nw = dist.rank(), dist.num_workers()
    ctx = dist.local_context()
    dev = ctx.torch_device()
    x, y = dist_images(cfg, nw)
    xs, ys = x[rank::nw], y[rank::nw]
    del x, y
    out = {}
    opt = {"learning_rate": cfg["lr"], "momentum": cfg["momentum"],
           "wd": cfg["wd"]}
    # Module.fit
    sym = resnet_symbol(mx, num_classes=cfg["classes"],
                        thumbnail=cfg["image"] < 224)
    args, aux = resnet_module_init(mx, sym, cfg["batch"], cfg["image"])
    it = mx.io.NDArrayIter(xs, ys, cfg["batch"], shuffle=False,
                           label_name="softmax_label")
    stamps, marks = [], {}

    def on_batch(param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if len(stamps) == cfg["warmup"] + 1:    # the timed steps from here
            wire.reset()
        if param is not None and len(stamps) == 2:
            # after the first step: the witness's tight comparison
            torch.save({n: v._data.cpu() for n, v in
                        mod.get_params()[0].items()},
                       os.path.join(out_dir, "resnet-first-rank%d.pt"
                                    % rank))
            torch.cuda.synchronize()
            stamps[-1] = time.perf_counter()

    mod = mx.mod.Module(sym, context=ctx)
    kv = mx.kv.create(kind)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps.append(time.perf_counter())
    mod.fit(it, num_epoch=1, kvstore=kv, optimizer="sgd",
            optimizer_params=dict(opt), arg_params={
                n: mx.nd.array(v, ctx=ctx) for n, v in args.items()},
            aux_params={n: mx.nd.array(v, ctx=ctx) for n, v in aux.items()},
            batch_end_callback=on_batch)
    marks["module"] = wire.read(cfg["steps"])
    ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    arg_p, aux_p = mod.get_params()
    torch.save({n: v._data.cpu() for n, v in arg_p.items()},
               os.path.join(out_dir, "resnet-module-rank%d.pt" % rank))
    out["module"] = dict(step_ms=ms, timed_ms=ms[cfg["warmup"]:],
                         peak_memory_bytes=torch.cuda.max_memory_allocated(),
                         wire=marks["module"],
                         rescale_grad=mod._optimizer.rescale_grad)
    del mod, kv, it, arg_p, aux_p
    gc.collect()
    torch.cuda.empty_cache()
    # a hybridized gluon.Trainer
    mx.random.seed(SEED)
    net = vision.resnet50_v1(classes=cfg["classes"],
                             thumbnail=cfg["image"] < 224)
    net.initialize(mx.init.Xavier(magnitude=2.0), ctx=ctx)
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(opt),
                               kvstore=mx.kv.create(kind))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    stamps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps.append(time.perf_counter())
    losses = []
    for i in range(cfg["warmup"] + cfg["steps"]):
        sl = slice(i * cfg["batch"], (i + 1) * cfg["batch"])
        xb = mx.nd.array(xs[sl], ctx=ctx)
        yb = mx.nd.array(ys[sl], ctx=ctx)
        with mx.autograd.record():
            loss = loss_fn(net(xb), yb)
        loss.backward()
        trainer.step(cfg["batch"] * nw)
        losses.append(float(loss.mean().asscalar()))
        on_batch(None)
    marks["gluon"] = wire.read(cfg["steps"])
    ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    # the weights; BatchNorm's running statistics stay each rank's own
    torch.save({n: p.data()._data.cpu() for n, p in
                net.collect_params().items() if p.grad_req != "null"},
               os.path.join(out_dir, "resnet-gluon-rank%d.pt" % rank))
    out["gluon"] = dict(step_ms=ms, timed_ms=ms[cfg["warmup"]:],
                        losses=losses, wire=marks["gluon"],
                        peak_memory_bytes=torch.cuda.max_memory_allocated())
    del net, trainer
    hybrid_release(mx)
    for part in ("module", "gluon"):
        r = out[part]
        mean = sum(r["timed_ms"]) / len(r["timed_ms"])
        r.update(step_ms_mean=mean,
                 img_per_s=cfg["batch"] * nw / mean * 1e3)
        print("dist 16b rank %d of %d (%s, %s): ResNet-50 v1 f32, batch %d a "
              "rank (%d global): step ms %s, timed mean %.3f (%.1f img/s "
              "global); all-reduce %.3f ms and %d bytes a step (%d calls in "
              "%d steps); peak memory allocated %d bytes"
              % (rank, nw, kind, part, cfg["batch"], cfg["batch"] * nw,
                 ["%.3f" % v for v in r["step_ms"]], mean, r["img_per_s"],
                 r["wire"]["ms_a_step"], r["wire"]["bytes_a_step"],
                 r["wire"]["calls"], cfg["steps"], r["peak_memory_bytes"]),
              flush=True)
    return out


def resnet_two_halves(mx, card, cfg=None, nw=DIST_RANKS):
    """16b's witness, in this process on the card: the ResNet-50 symbol's
    Module step as ``nw`` ranks take it, each rank's half through an
    executor of its own (its own BatchNorm statistics, as MXNet keeps
    them per device), the gradients summed in rank order and one SGD
    update from the Module's optimizer (wd rule, rescale 1/global batch).
    Returns the weights after the first step and after the last."""
    import torch
    from incubator_mxnet_tpu_torch.ndarray import NDArray
    cfg = cfg or DIST_RESNET
    ctx = mx.gpu(0)
    sym = resnet_symbol(mx, num_classes=cfg["classes"],
                        thumbnail=cfg["image"] < 224)
    args, aux = resnet_module_init(mx, sym, cfg["batch"], cfg["image"])
    x, y = dist_images(cfg, nw)
    names = [n for n in sym.list_arguments()
             if n not in ("data", "softmax_label")]
    req = {n: ("null" if n in ("data", "softmax_label") else "write")
           for n in sym.list_arguments()}
    exes = []
    for r in range(nw):
        exe = sym.simple_bind(ctx=ctx, grad_req=req,
                              data=(cfg["batch"], 3, cfg["image"],
                                    cfg["image"]),
                              softmax_label=(cfg["batch"],))
        exe.copy_params_from({n: mx.nd.array(v, ctx=ctx)
                              for n, v in args.items()},
                             {n: mx.nd.array(v, ctx=ctx)
                              for n, v in aux.items()})
        exes.append(exe)
    optimizer = mx.optimizer.create(
        "sgd", sym=sym, param_idx2name=dict(enumerate(names)),
        rescale_grad=1.0 / (cfg["batch"] * nw), learning_rate=cfg["lr"],
        momentum=cfg["momentum"], wd=cfg["wd"])
    updater = mx.optimizer.get_updater(optimizer)
    weights = {n: mx.nd.array(args[n], ctx=ctx) for n in names}
    first = None
    for s in range(cfg["warmup"] + cfg["steps"]):
        for r, exe in enumerate(exes):
            sl = slice(s * cfg["batch"], (s + 1) * cfg["batch"])
            exe.forward(is_train=True,
                        data=mx.nd.array(x[r::nw][sl], ctx=ctx),
                        softmax_label=mx.nd.array(y[r::nw][sl], ctx=ctx))
            exe.backward()
        for i, n in enumerate(names):
            g = exes[0].grad_dict[n]._data.clone()
            for exe in exes[1:]:
                g = g + exe.grad_dict[n]._data
            updater(i, NDArray(g, ctx=ctx), weights[n])
            with torch.no_grad():
                for exe in exes:
                    exe.arg_dict[n]._data.copy_(weights[n]._data)
        if first is None:
            first = {n: w._data.cpu() for n, w in weights.items()}
    torch.cuda.synchronize()
    out = {n: w._data.cpu() for n, w in weights.items()}
    del exes, weights
    gc.collect()
    torch.cuda.empty_cache()
    return first, out


def _same_bits(a, b):
    import torch
    return a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)


def dist_resnet_phase(mx, card, out_dir, kind="dist_sync", nw=DIST_RANKS):
    """16b: the ranks, then (under dist_sync on one card) the witness run
    twice in this process.  Its spread between the two runs (cuDNN's
    backward adds in no fixed order, and the steps carry the difference)
    sets the bound, after the first step and after the last."""
    import torch
    results = launch_ranks("resnet", nw, out_dir, DIST_TIMEOUT["resnet"],
                           json.dumps(DIST_RESNET), kind,
                           cards=1 if kind == "dist_sync" else None)

    def load(name, r):
        return torch.load(os.path.join(out_dir, "resnet-%s-rank%d.pt"
                                       % (name, r)))

    ranks = {part: [load(part, r) for r in range(nw)]
             for part in ("module", "gluon")}
    equal = {part: all(_same_bits(ranks[part][0], w)
                       for w in ranks[part][1:]) for part in ranks}
    check(all(equal.values()), "16b: the ranks' weights differ: %s" % equal)
    out = dict(ranks=results, ranks_bit_equal=equal)
    if kind == "dist_sync":
        t0 = time.perf_counter()
        ref = [resnet_two_halves(mx, card, nw=nw) for _ in range(2)]
        top = max(float(w.abs().max()) for w in ref[0][1].values())
        floor = 2.0 ** -20 * top
        witness = {}
        for i, (when, mine) in enumerate((("first step", load("first", 0)),
                                          ("last step", ranks["module"][0]))):
            spread = _max_abs(ref[0][i], ref[1][i])
            err = _max_abs(mine, ref[0][i])
            bound = max(4 * spread, floor)
            witness[when] = dict(max_abs_err=err, bound=bound, spread=spread)
            print("dist 16b: Module.fit over %d ranks against the one-process "
                  "run of the same halves (own BatchNorm statistics, "
                  "gradients summed in rank order) after the %s: max |w - "
                  "w_ref| %.3e, bound %.3e (4 x the spread %.3e between two "
                  "one-process runs, at least 2^-20 of max |w| %.4f) | %s"
                  % (nw, when, err, bound, spread, top, card), flush=True)
            check(err <= bound, "16b: after the %s the ranks lie %.3e from "
                  "the one-process run, beyond %.3e" % (when, err, bound))
        out.update(witness=witness,
                   witness_seconds=time.perf_counter() - t0)
    for part in ("module", "gluon"):
        r0 = results[0][part]
        print("dist 16b %s (%s, %d ranks): step %.3f ms, %.1f img/s global; "
              "all-reduce %.3f ms and %d bytes a step on rank 0; peak "
              "memory by rank %s; ranks' weights bit-equal %s | %s"
              % (part, kind, nw, r0["step_ms_mean"], r0["img_per_s"],
                 r0["wire"]["ms_a_step"], r0["wire"]["bytes_a_step"],
                 [r[part]["peak_memory_bytes"] for r in results],
                 equal[part], card), flush=True)
    return out


def _digest(tensors):
    """sha256 of the tensors' bytes, by name."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for n in sorted(tensors):
        h.update(n.encode())
        h.update(tensors[n].detach().contiguous().view(-1).view(
            torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def dist_lm_task(mx, dist, wire, out_dir, cfg, lcfg, kind="dist_sync"):
    """16c on one rank: the LM (``cfg``, LM_CONFIG's keys as JSON) through
    DataParallelTrainer over ``worker_mesh()`` in bf16, its own batch
    (``lcfg``, DIST_LM's keys); B1's counters zeroed before the timed
    steps."""
    import torch
    from incubator_mxnet_tpu_torch.models import TransformerLM, HostXavier
    from incubator_mxnet_tpu_torch.ops.attention import flash_attention
    cfg, lcfg = json.loads(cfg), json.loads(lcfg)
    rank, nw = dist.rank(), dist.num_workers()
    ctx = dist.local_context()
    batch, seq, vocab = lcfg["batch"], cfg["seq_len"], cfg["vocab"]
    t0 = time.perf_counter()
    net = TransformerLM(**cfg)
    net.pos_embed.init = None
    net.initialize(HostXavier(SEED + rank), ctx=ctx)
    rs = np.random.RandomState(rank)
    x = mx.nd.array(rs.randint(0, vocab, (batch, seq)), ctx=ctx,
                    dtype="int32")
    y = mx.nd.array(rs.randint(0, vocab, (batch, seq)).astype(np.float32),
                    ctx=ctx)
    trainer = mx.parallel.DataParallelTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", dict(TRAIN_OPT),
        mesh=dist.worker_mesh(kvstore=kind), dtype="bfloat16")
    losses, step_ms = [], []
    for i in range(lcfg["warmup"] + lcfg["steps"]):
        if i == lcfg["warmup"]:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            wire.reset()
            flash_attention.launches = flash_attention.backward_calls = 0
            flash_attention.backward_kernel_launches = 0
            flash_attention.backward_torch_calls = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(float(trainer.step(x, y).asscalar()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        if i == 0:
            first_s = time.perf_counter() - t0
    launches = {"flash_attention_fwd": flash_attention.launches,
                "flash_attention_bwd_calls": flash_attention.backward_calls,
                "flash_attention_bwd": flash_attention.backward_kernel_launches,
                "flash_attention_bwd_torch_calls":
                    flash_attention.backward_torch_calls}
    timed = step_ms[lcfg["warmup"]:]
    mean = sum(timed) / len(timed)
    n_params = sum(int(np.prod(p.shape)) for p in
                   net.collect_params().values())
    out = dict(n_layers=cfg["n_layers"], n_params=n_params, losses=losses,
               step_ms=step_ms, step_ms_mean=mean,
               tokens_per_s=batch * seq * nw / mean * 1e3,
               wire=wire.read(lcfg["steps"]), launches=launches,
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               first_step_s=first_s, digest=_digest(trainer._params))
    print("dist 16c rank %d of %d (%s): TransformerLM %s, %d parameters, "
          "batch %d x %d a rank: built, initialized, weights broadcast and "
          "the first step in %.1f s; step ms %s, timed mean %.3f (%.1f "
          "tokens/s global); all-reduce %.3f ms and %d bytes a step; losses "
          "%s; launches %s in %d steps; peak memory allocated %d bytes"
          % (rank, nw, kind, cfg, n_params, batch, seq, first_s,
             ["%.3f" % v for v in step_ms], mean, out["tokens_per_s"],
             out["wire"]["ms_a_step"], out["wire"]["bytes_a_step"],
             ["%.6f" % v for v in losses], launches, lcfg["steps"],
             out["peak_memory_bytes"]), flush=True)
    return out


def dist_lm_layers(torch, lm_peak, n_params, nw, cards):
    """16c's depth from 4d's peak (one process, batch 8): its state, 14
    bytes a parameter (f32 weights, momentum and gradients, the bf16
    weights), plus half its activations (the rest of the peak: a rank
    takes 4 sequences, not 8), plus the flat gradient buffer (4 bytes a
    parameter) and DIST_LM_SLACK, for each rank that shares a card,
    against 90% of the card's free memory; the layers (DIST_LM's at most)
    cut until it fits.  Returns (layers, the estimate a rank in bytes)."""
    free, _ = torch.cuda.mem_get_info()
    per_card = -(-nw // cards)
    activations = max(lm_peak - 14 * n_params, 0) * DIST_LM["batch"] \
        / TRAIN_BATCH
    d, f = LM_CONFIG["d_model"], LM_CONFIG["d_ffn"]
    layer_params = 4 * d * d + 2 * d * f
    layers = DIST_LM["layers"]
    while True:
        params = n_params - (LM_CONFIG["n_layers"] - layers) * layer_params
        est = int(18 * params + activations * layers
                  / LM_CONFIG["n_layers"]) + DIST_LM_SLACK
        if per_card * est <= 0.9 * free or layers == 1:
            return layers, est
        layers -= 1


def dist_lm_phase(mx, card, out_dir, lm_peak, n_params, kind="dist_sync",
                  nw=DIST_RANKS):
    """16c: the ranks, B1's launches on each, the loss falling, the ranks'
    master weights bit-equal."""
    import torch
    cards = torch.cuda.device_count() if kind == "dist_device_sync" else 1
    layers, est = dist_lm_layers(torch, lm_peak, n_params, nw, cards)
    print("dist 16c: from 4d's peak %d bytes (batch 8) and a flat "
          "gradient buffer of %d bytes: about %d bytes a rank of batch %d; "
          "%d ranks on %d card(s) with %d bytes free: %d of %d layers%s | %s"
          % (lm_peak, 4 * n_params, est, DIST_LM["batch"], nw, cards,
             torch.cuda.mem_get_info()[0], layers, LM_CONFIG["n_layers"],
             "" if layers == DIST_LM["layers"] else " (cut to fit)",
             card), flush=True)
    results = launch_ranks("lm", nw, out_dir, DIST_TIMEOUT["lm"],
                           json.dumps(dict(LM_CONFIG, n_layers=layers)),
                           json.dumps(DIST_LM), kind,
                           cards=1 if kind == "dist_sync" else None)
    expected = layers * DIST_LM["steps"]
    for r in results:
        la = r["launches"]
        check(la["flash_attention_fwd"] == expected and
              la["flash_attention_bwd_calls"] == expected and
              la["flash_attention_bwd"] == expected and
              la["flash_attention_bwd_torch_calls"] == 0,
              "16c rank %d: launches %s, expected %d each and none through "
              "the torch ops" % (r["rank"], la, expected))
        check(all(math.isfinite(v) for v in r["losses"]) and
              r["losses"][-1] < r["losses"][0],
              "16c rank %d: the loss did not fall: %s" % (r["rank"],
                                                          r["losses"]))
    equal = len({r["digest"] for r in results}) == 1
    check(equal, "16c: the ranks' master weights differ")
    r0 = results[0]
    print("dist 16c (%s, %d ranks, %d layers): step %.3f ms, %.1f tokens/s "
          "global; all-reduce %.3f ms and %d bytes a step on rank 0; B1 "
          "launches by rank %s; losses by rank %s; peak memory by rank %s; "
          "ranks' master weights bit-equal (sha256) %s | %s"
          % (kind, nw, layers, r0["step_ms_mean"], r0["tokens_per_s"],
             r0["wire"]["ms_a_step"], r0["wire"]["bytes_a_step"],
             [r["launches"] for r in results],
             [["%.6f" % v for v in r["losses"]] for r in results],
             [r["peak_memory_bytes"] for r in results], equal, card),
          flush=True)
    return dict(layers=layers, estimate_bytes=est, ranks=results,
                ranks_bit_equal=equal,
                launches=dict(
                    launches=sum(r["launches"]["flash_attention_fwd"]
                                 for r in results),
                    backward_kernel_launches=sum(
                        r["launches"]["flash_attention_bwd"]
                        for r in results)))


def _module_steps(mx, sym, ctxs, tx, ty, init, args):
    """BASELINE config 1's Module loop over ``ctxs`` with a "device" store
    (none on one context), from the weights ``init``: (weights after the
    first step, weights at the end, mean step ms after the first)."""
    import torch
    it = mx.io.NDArrayIter(tx, ty, args["batch_size"], shuffle=False,
                           label_name="softmax_label")
    mod = mx.mod.Module(sym, context=ctxs)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params={n: mx.nd.array(v, ctx=ctxs[0])
                                for n, v in init.items()})
    mod.init_optimizer(kvstore="device", optimizer="sgd", optimizer_params={
        "learning_rate": args["lr"], "momentum": args["momentum"],
        "wd": args["wd"]})

    def weights():
        return {n: v.asnumpy() for n, v in mod.get_params()[0].items()}

    first, ms = None, []
    for _ in range(args["num_epochs"]):
        it.reset()
        for batch in it:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if first is None:
                first = weights()
    store = (mod._kvstore.type if mod._kvstore is not None else None,
             [str(e._ctx) for e in mod._exec_group.execs])
    return first, weights(), sum(ms[1:]) / max(len(ms) - 1, 1), store


def _max_abs(a, b):
    """The largest |a - b| over the arrays (numpy or CPU tensors) by name."""
    return max(float(np.abs(np.asarray(a[n], np.float64) -
                            np.asarray(b[n], np.float64)).max()) for n in a)


def mixed_context_phase(mx, card, contexts=None):
    """16d: BASELINE config 1's MLP and LeNet (10b's batch 64, 2 epochs)
    through Module with kvstore="device" over ``contexts`` (default
    [gpu(0), cpu(0)], MXNet's mixed list: each batch split, the other
    contexts' gradients summed into the first's on the store), against the
    same weights and batches on gpu(0) alone: every weight within
    MIXED_REL of the largest after the first step, MIXED_END_REL after the
    last."""
    contexts = contexts or [mx.gpu(0), mx.cpu(0)]
    tx, ty, _, _ = synthetic_mnist(MNIST_SYNTH)
    args = dict(FIT_ARGS)
    out = {}
    for what, _fit, build in mnist_nets(mx)[:2]:
        sym = build()
        arg_shapes, _, _ = sym.infer_shape(
            data=(args["batch_size"],) + tx.shape[1:],
            softmax_label=(args["batch_size"],))
        keep = [(n, sh) for n, sh in zip(sym.list_arguments(), arg_shapes)
                if n not in ("data", "softmax_label")]
        init = xavier_weights([n for n, _ in keep], [sh for _, sh in keep])
        m1, mend, ms_mixed, store = _module_steps(mx, sym, contexts, tx, ty,
                                                  init, args)
        c1, cend, ms_one, _ = _module_steps(mx, sym, [mx.gpu(0)], tx, ty,
                                            init, args)
        top = max(float(np.abs(v).max()) for v in cend.values())
        first_err, end_err = _max_abs(m1, c1), _max_abs(mend, cend)
        out[what] = dict(first_step_max_abs_err=first_err,
                         first_step_bound=MIXED_REL * top,
                         max_abs_err=end_err, bound=MIXED_END_REL * top,
                         step_ms_mixed=ms_mixed, step_ms_one=ms_one,
                         store=store)
        print("dist 16d %s over %s (store %s): every weight within %.3e of "
              "the one-context run after the first step (bound %.0e of max "
              "|w| %.4f), %.3e after %d epochs (bound %.0e of it); step "
              "%.3f ms over the contexts, %.3f ms on one card | %s"
              % (what, store[1], store[0], first_err, MIXED_REL, top,
                 end_err, args["num_epochs"], MIXED_END_REL, ms_mixed,
                 ms_one, card), flush=True)
        check(first_err <= MIXED_REL * top, "16d %s: %.3e from the "
              "one-context run after one step" % (what, first_err))
        check(end_err <= MIXED_END_REL * top, "16d %s: %.3e from the "
              "one-context run after %d epochs" % (what, end_err,
                                                   args["num_epochs"]))
    return out


def dist_store_phase(mx, card, out_dir, big=DIST_BIG):
    """16a: two ranks on the card under dist_sync, then one rank a card
    under dist_device_sync (on this machine: torch.cuda.device_count()
    ranks)."""
    import torch
    sync = launch_ranks("store", DIST_RANKS, out_dir, DIST_TIMEOUT["store"],
                        big, cards=1)
    for r in sync:
        check(all(r["checks"].values()), "16a rank %d: %s"
              % (r["rank"], r["checks"]))
    cards = torch.cuda.device_count()
    nccl = launch_ranks("nccl", cards, out_dir, DIST_TIMEOUT["nccl"], big)
    for r in nccl:
        check(r["summed"] and r["pushed"], "16a NCCL rank %d: %s"
              % (r["rank"], r))
    print("dist 16a: %d ranks on one card under dist_sync: every invariant "
          "holds (%s); a (%d,) f32 all-reduce over gloo %.3f ms; "
          "dist_device_sync refused the shared card on every rank; %d "
          "rank(s), one a card, under dist_device_sync: NCCL %s, a (%d,) f32 "
          "all-reduce %.3f ms | %s"
          % (DIST_RANKS, sorted(sync[0]["checks"]), big,
             sync[0]["gloo_allreduce"]["ms_a_step"], cards,
             nccl[0]["nccl_version"], big,
             nccl[0]["nccl_allreduce"]["ms_a_step"], card), flush=True)
    return dict(ok=True, shared_card_refused=all(
        r["checks"]["shared_card_refused"] for r in sync), sync=sync,
        nccl=nccl)


def multicard_phase(mx, card, out_dir, lm_peak, n_params):
    """16e, on a machine of two cards or more: 16d over every card, 16b and
    16c under dist_device_sync with one rank a card (NCCL)."""
    import torch
    cards = torch.cuda.device_count()
    return dict(
        cards=cards,
        mixed=mixed_context_phase(mx, card, [mx.gpu(i) for i in
                                             range(cards)]),
        resnet=dist_resnet_phase(mx, card, out_dir, "dist_device_sync",
                                 cards),
        lm=dist_lm_phase(mx, card, out_dir, lm_peak, n_params,
                         "dist_device_sync", cards))


def dist_phase(mx, card, lm_peak, n_params):
    """Phase 16 (16a-16e); the card's memory released first: the ranks
    are processes of their own."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    hybrid_release(mx)          # the graphs of earlier phases hold memory
    print("dist: this process holds %d bytes allocated, %d reserved on the "
          "card before the ranks start | %s"
          % (torch.cuda.memory_allocated(), torch.cuda.memory_reserved(),
             card), flush=True)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        out["store"] = dist_store_phase(mx, card, tmp)
        out["resnet"] = dist_resnet_phase(mx, card, tmp)
        out["lm"] = dist_lm_phase(mx, card, tmp, lm_peak, n_params)
        out["mixed"] = mixed_context_phase(mx, card)
        cards = torch.cuda.device_count()
        if cards >= 2:
            out["e"] = multicard_phase(mx, card, tmp, lm_peak, n_params)
        else:
            print("dist 16e: not run: this machine has %d card "
                  "(torch.cuda.device_count() = %d); 16e needs 2 or more "
                  "(16d over every card, 16b and 16c under dist_device_sync "
                  "with one rank a card)" % (cards, cards), flush=True)
    out["seconds"] = time.perf_counter() - t0
    print("dist: phase 16 in %.1f s | %s" % (out["seconds"], card),
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 17: the rest of ROADMAP item 7 (parallel/ring_attention.py,
# parallel/pipeline.py, parallel/moe.py, the axis collectives of
# parallel/mesh.py and dist.RankAxis, DataParallelTrainer over 2-D meshes)
# at the LM's width, in two ranks sharing the card over gloo, one launch:
# 17a the axis collectives on card tensors, 17b ring attention over "sp"
# (the LM through DataParallelTrainer over {"dp": 1, "sp": 2}), 17c
# PipelineTrainer over {"pp": 2}, 17d ExpertParallelMoE over {"ep": 2};
# 17e on machines of two cards or more.
# ---------------------------------------------------------------------------
PAR_RANKS = 2
PAR_TIMEOUT = 480
# 17a: a K/V block of 17b's ring (bf16), 17d's dispatched slots (f32), a
# (2^24,) f32 sum, 17b's output block (bf16)
PAR_COLLECTIVES = dict(ring=(8, 32, 512, 128), a2a=(4, 1280, 4096),
                       psum=(1 << 24,), gather=(8, 32, 512, 128))
# 17b: the LM's 8 x 1024 tokens on every rank of {"dp": 1, "sp": 2}
# (the batch splits over "dp" only), 4d's optimizer, bf16; 2 timed steps
# and 2 of the LM's 4 layers (3 steps and 4 layers until the smoke's time
# was cut for phase 18; the ring is the same path at either depth)
PAR_LM = dict(batch=8, warmup=1, steps=2, layers=2)
# 17c: 2 stages of 2 DecoderBlocks, f32 (the JAX trainer's only dtype), 4
# microbatches of 2 x 1024, 1 timed step (3 until phase 18)
PAR_PP = dict(batch=8, micro=4, warmup=1, steps=1, lr=0.05)
# 17d: the LM's FFN widths over 4 experts, 8192 tokens of d_model, f32
# tokens; every token shares a seeded direction of norm ``skew`` (a token's
# own norm is ~64), so the router sends ~43% of them to one expert against
# a capacity of 31% (1.25 / 4) and capacity dispatch drops ~12% of them
PAR_MOE = dict(tokens=8192, hidden=16384, experts=4, capacity_factor=1.25,
               classes=16, lr=1e-4, warmup=1, steps=3, skew=32.0)
# 17b: the ring against flash attention's bf16 kernel on one MHA layer
PAR_MHA_REL = 2e-2
# 17c: pipelined against unpipelined after one SGD step: the gradients are
# the same f32 sums in another order (microbatches of 2048 tokens against
# one product over 8192, TF32 off), a few ulps of the sum each: held to
# 2^-10 of the step's largest update plus 2 ulps of the largest weight
PAR_PP_REL = 2.0 ** -10
# 17d: the split experts against one rank's dense layer, f32
PAR_MOE_REL = 1e-4


def set_seq_axis(net, axis):
    """Every MultiHeadAttention of ``net`` on ``axis`` (None: flash
    attention on the local device)."""
    stack = [net]
    while stack:
        b = stack.pop()
        if hasattr(b, "_seq_axis"):
            b._seq_axis = axis
        stack.extend(b._children)


class AxisClock(object):
    """Times each collective of ``dist.RankAxis`` (the card synchronized
    before and after) by kind; bytes sent from ``dist.axis_stats``."""

    KINDS = ("ring_shift", "_all_to_all", "_psum", "_all_gather", "send",
             "recv")

    def __init__(self, dist, torch):
        self.dist, self.torch = dist, torch
        self.reset()
        for name in self.KINDS:
            inner = getattr(dist.RankAxis, name)

            def timed(ax, *a, _inner=inner, _name=name, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _inner(ax, *a, **k)
                torch.cuda.synchronize()
                self.ms[_name] = self.ms.get(_name, 0.0) + \
                    (time.perf_counter() - t0) * 1e3
                self.calls[_name] = self.calls.get(_name, 0) + 1
                return out

            setattr(dist.RankAxis, name, timed)

    def reset(self):
        import copy
        self.ms, self.calls = {}, {}
        self._stats = copy.deepcopy(self.dist.axis_stats)

    def read(self):
        out = {}
        for name in self.KINDS:
            kind = name.lstrip("_")
            st = self.dist.axis_stats.get(kind, {})
            before = self._stats.get(kind, {})
            out[kind] = dict(
                calls=self.calls.get(name, 0), ms=self.ms.get(name, 0.0),
                bytes=st.get("bytes", 0) - before.get("bytes", 0),
                staged=st.get("staged", 0) - before.get("staged", 0))
        return out


def _flash_counts(flash_attention, split_f32):
    return dict(fwd=flash_attention.launches,
                f32=flash_attention.f32_launches,
                bwd_calls=flash_attention.backward_calls,
                bwd=flash_attention.backward_kernel_launches,
                bwd_torch=flash_attention.backward_torch_calls,
                split=split_f32.launches)


def _minus(a, b):
    return {k: a[k] - b[k] for k in a}


def par_collectives(mx, dist, torch, clock, meshes):
    """17a on one rank: each axis collective on card tensors against the
    answer made on the host from every rank's seeded values, bit for bit
    (over gloo the all-to-all and the gather take the card tensors
    themselves, the ring shift stages them); the second of two calls
    timed (the first sets up the wire: NCCL makes its communicators
    then), with its bytes.  The sum of more than two ranks is added in the
    wire's own order: it is held to the rounding of n - 1 additions of the
    sum in f64, and its bits compared across the ranks (``psum_digest``)."""
    ax = dist.RankAxis(meshes["sp"], "sp")
    dev, n, me = ax.device, ax.size, ax.index

    def host(shape, dtype, r):
        v = np.random.default_rng(SEED + 17 * r).standard_normal(
            shape, np.float32)
        return torch.from_numpy(v).to(dtype)

    calls = dict(ring=lambda t: ax.ring_shift(t),
                 a2a=lambda t: ax.all_to_all(t, 0, 1),
                 psum=lambda t: ax.psum(t),
                 gather=lambda t: ax.all_gather(t, 2))
    cases = dict(ring=torch.bfloat16, a2a=torch.float32, psum=torch.float32,
                 gather=torch.bfloat16)
    checks, ms, digest = {}, {}, None
    for kind, dtype in cases.items():
        shape = PAR_COLLECTIVES[kind]
        mine = host(shape, dtype, me).to(dev)
        every = [host(shape, dtype, r) for r in range(n)]
        calls[kind](mine)
        clock.reset()
        got = calls[kind](mine)
        read = clock.read()
        if kind == "ring":
            want = every[(me - 1) % n]
        elif kind == "a2a":
            want = torch.cat([v.chunk(n, 0)[me] for v in every], 1)
        elif kind == "psum":
            want = every[0].clone()
            for v in every[1:]:
                want += v
            digest = _digest({"psum": got})
        else:
            want = torch.cat(every, 2)
        same = got.is_cuda and got.dtype == want.dtype
        if kind == "psum" and n > 2:
            # against the sum in f64: n - 1 f32 additions and the rounding
            # of the result, each within 2^-24 of the sum of magnitudes
            exact = sum(v.double() for v in every)
            slack = n * 2.0 ** -24 * sum(v.double().abs() for v in every)
            checks[kind] = bool(same and ((got.cpu().double() - exact).abs()
                                          <= slack).all())
        else:
            checks[kind] = bool(same and torch.equal(got.cpu(), want))
        key = {"ring": "ring_shift", "a2a": "all_to_all", "psum": "psum",
               "gather": "all_gather"}[kind]
        ms[kind] = dict(ms=read[key]["ms"], bytes=read[key]["bytes"],
                        staged=read[key]["staged"], shape=list(shape),
                        dtype=str(dtype))
    return dict(checks=checks, ms=ms, psum_digest=digest)


def par_mha(mx, dist, torch, mesh, ctx):
    """17b's layer check: one MultiHeadAttention at the LM's width, bf16,
    forward and backward through the ring over ``mesh`` against the same
    layer through flash attention (B1's bf16 kernels) on this rank."""
    from incubator_mxnet_tpu_torch.models import HostXavier
    d, heads = LM_CONFIG["d_model"], LM_CONFIG["n_heads"]
    shape = (PAR_LM["batch"], LM_CONFIG["seq_len"], d)
    rs = np.random.default_rng(SEED + 5)
    x0 = torch.from_numpy(rs.standard_normal(shape, np.float32)).to(
        ctx.torch_device(), torch.bfloat16)
    g = torch.from_numpy(rs.standard_normal(shape, np.float32)).to(
        ctx.torch_device(), torch.bfloat16)
    res = {}
    for tag, axis in (("local", None), ("ring", "sp")):
        blk = mx.gluon.nn.MultiHeadAttention(d, heads, causal=True,
                                             use_bias=False, seq_axis=axis,
                                             prefix="mha_")
        blk.initialize(HostXavier(SEED), ctx=ctx)
        blk.cast("bfloat16")
        x = mx.nd.NDArray(x0.clone(), ctx=ctx)
        x.attach_grad()
        with mx.parallel.use_mesh(mesh), mx.autograd.record():
            out = blk(x)
        out.backward(mx.nd.NDArray(g, ctx=ctx))
        res[tag] = [out._data.detach().float(), x.grad._data.float()] + [
            p.grad()._data.float() for p in blk.collect_params().values()]
        del blk
    errs = [float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))
            for a, b in zip(res["ring"], res["local"])]
    del res
    return dict(rel_errs=dict(zip(["out", "dx", "wq", "wk", "wv", "wo"],
                                  errs)), bound=PAR_MHA_REL,
                ok=max(errs) <= PAR_MHA_REL)


def par_lm(mx, dist, torch, clock, meshes, layers, ctx):
    """17b on one rank: the LM with every MultiHeadAttention on "sp",
    trained through DataParallelTrainer(dtype="bfloat16") over {"dp": 1,
    "sp": 2}, as a user runs it (the trainer keeps the ranks' replicated
    weights bit-equal itself); rank 0 first runs the witness, the same LM
    from the same weights on flash attention, one step alone, and holds
    the ring's first update of the weights against the witness's."""
    from incubator_mxnet_tpu_torch.models import TransformerLM, HostXavier
    from incubator_mxnet_tpu_torch.ops.attention import (flash_attention,
                                                         split_f32)
    rank = dist.rank()
    cfg = dict(LM_CONFIG, n_layers=layers)
    net = TransformerLM(**cfg)
    net.pos_embed.init = None
    net.initialize(HostXavier(SEED), ctx=ctx)
    rs = np.random.RandomState(SEED)
    B, S, V = PAR_LM["batch"], cfg["seq_len"], cfg["vocab"]
    x = mx.nd.array(rs.randint(0, V, (B, S)), ctx=ctx, dtype="int32")
    y = mx.nd.array(rs.randint(0, V, (B, S)).astype(np.float32), ctx=ctx)
    loss_blk = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    sp_mesh = meshes["dp_sp"]
    out = {}
    set_seq_axis(net, None)
    # the deferred shapes resolved alike on every rank, with no collective
    # (a rank that resolved them in the witness would skip the pass)
    net._run_deferred_init(x[:1])
    w0 = {n: p.data()._data for n, p in net.collect_params().items()}
    c0 = _flash_counts(flash_attention, split_f32)
    moved = None
    if rank == 0:
        wit = mx.parallel.DataParallelTrainer(
            net, loss_blk, "sgd", dict(TRAIN_OPT),
            mesh=mx.parallel.make_mesh({"dp": 1}, [ctx]), dtype="bfloat16")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out["witness_loss"] = float(wit.step(x, y).asscalar())
        torch.cuda.synchronize()
        out["witness_ms"] = (time.perf_counter() - t1) * 1e3
        with torch.no_grad():
            moved = {n: v - w0[n] for n, v in wit._params.items()}
        del wit
        gc.collect()
        torch.cuda.empty_cache()
    out["mha"] = par_mha(mx, dist, torch, sp_mesh, ctx)
    out["witness_launches"] = _minus(_flash_counts(flash_attention,
                                                   split_f32), c0)
    set_seq_axis(net, "sp")
    trainer = mx.parallel.DataParallelTrainer(
        net, loss_blk, "sgd", dict(TRAIN_OPT), mesh=sp_mesh,
        dtype="bfloat16")
    losses, step_ms = [], []
    for i in range(PAR_LM["warmup"] + PAR_LM["steps"]):
        if i == PAR_LM["warmup"]:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            clock.reset()
            c1 = _flash_counts(flash_attention, split_f32)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(float(trainer.step(x, y).asscalar()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        if i == 0:
            out["digest_after_one_step"] = _digest(trainer._params)
            if moved is not None:
                out["update_gap"] = _update_gap(torch, trainer._params, w0,
                                                moved)
                moved = None
    timed = step_ms[PAR_LM["warmup"]:]
    mean = sum(timed) / len(timed)
    out.update(layers=layers, losses=losses, step_ms=step_ms,
               step_ms_mean=mean, tokens_per_s=B * S / mean * 1e3,
               wire=clock.read(), steps=PAR_LM["steps"],
               sp_launches=_minus(_flash_counts(flash_attention, split_f32),
                                  c1),
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    del trainer, w0
    set_seq_axis(net, None)
    gc.collect()
    torch.cuda.empty_cache()
    return net, x, y, out


def _update_gap(torch, params, w0, moved):
    """How far one step's update of the weights (``params`` less ``w0``)
    lies from the witness's (``moved``): the norm of the difference over
    every weight against the norm of the witness's update, and the tensor
    whose largest difference is the largest share of its own largest
    update."""
    num = den = 0.0
    worst = (0.0, None)
    with torch.no_grad():
        for n, m in moved.items():
            diff = (params[n] - w0[n]) - m
            num += float(diff.double().square().sum())
            den += float(m.double().square().sum())
            top = float(m.abs().max())
            if top > 0:
                share = float(diff.abs().max()) / top
                if share > worst[0]:
                    worst = (share, n)
    return dict(rel_l2=math.sqrt(num / max(den, 1e-300)), worst=worst)


def _lm_parts(mx, net, stages):
    """The LM cut for the pipeline: ``pre`` (the token and position
    embeddings), ``stages`` stages of as many DecoderBlocks each as divide
    evenly (the blocks left over unused), ``post`` (the last LayerNorm and
    the head), sharing ``net``'s blocks and values."""
    nn = mx.gluon.nn

    class Pre(mx.gluon.HybridBlock):
        def __init__(self):
            super().__init__(prefix="pre_")
            with self.name_scope():
                self.embed = net.embed
                self.pos_embed = self.params.get(
                    "pos_embed", shape=net.pos_embed.shape)

        def hybrid_forward(self, F, tokens, pos_embed):
            return self.embed(tokens) + F.expand_dims(pos_embed, axis=0)

    class Post(mx.gluon.HybridBlock):
        def __init__(self):
            super().__init__(prefix="post_")
            with self.name_scope():
                self.ln_f = net.ln_f
                self.head = net.head

        def hybrid_forward(self, F, h):
            return self.head(self.ln_f(h))

    ctx = net.pos_embed.list_ctx()[0]
    pre = Pre()
    pre.pos_embed.initialize(ctx=ctx)
    pre.pos_embed.set_data(net.pos_embed.data())
    body = nn.HybridSequential(prefix="pp_")
    blocks = list(net.blocks._children)
    per = max(1, len(blocks) // stages)
    for i in range(stages):
        stage = nn.HybridSequential(prefix="stage%d_" % i)
        for b in blocks[i * per:(i + 1) * per]:
            stage.add(b)
        body.add(stage)
    return pre, body, Post()


def par_pipeline(mx, dist, torch, clock, meshes, net, x, y, ctx):
    """17c on one rank: PipelineTrainer over {"pp": 2} on the LM's blocks
    in f32; rank 0 first runs the same step unpipelined (the reference of
    the weights after one step)."""
    from incubator_mxnet_tpu_torch.ops.attention import (flash_attention,
                                                         split_f32)
    rank = dist.rank()
    nw = meshes["pp"].size
    pre, body, post = _lm_parts(mx, net, nw)
    per_stage = len(body[0]._children)
    loss_blk = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    lr = PAR_PP["lr"]
    blocks = [pre, body, post]
    params = {n: p for b in blocks for n, p in b.collect_params().items()}
    out = {}
    if rank == 0:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with mx.autograd.record():
            per = loss_blk(post(body(pre(x))), y)
            ref_loss = per.mean()
        ref_loss.backward()
        torch.cuda.synchronize()
        out["reference_ms"] = (time.perf_counter() - t1) * 1e3
        out["reference_loss"] = float(ref_loss.asscalar())
        ref = {}
        with torch.no_grad():
            for n, p in params.items():
                w, g = p.data()._data, p.grad()._data
                ref[n] = (w - lr * g, lr * float(g.abs().max()),
                          float(w.abs().max()))
        del per, ref_loss
        gc.collect()
        torch.cuda.empty_cache()
    pp_mesh = meshes["pp"]
    trainer = mx.parallel.PipelineTrainer(
        body, loss_blk, pp_mesh, num_microbatches=PAR_PP["micro"],
        learning_rate=lr, pre=pre, post=post)
    losses, step_ms = [], []
    for i in range(PAR_PP["warmup"] + PAR_PP["steps"]):
        if i == PAR_PP["warmup"]:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            clock.reset()
            c1 = _flash_counts(flash_attention, split_f32)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(float(trainer.step(x, y)))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        if i == 0:
            trainer.sync_params()
            if rank == 0:
                errs = {}
                for n, p in params.items():
                    w_ref, step_max, w_max = ref[n]
                    err = float((p.data()._data - w_ref).abs().max())
                    ulp = 2.0 ** (math.floor(math.log2(max(w_max, 1e-30)))
                                  - 23)
                    errs[n] = (err, PAR_PP_REL * step_max + 2 * ulp)
                out["weights_after_one_step"] = dict(
                    worst=max(errs.items(), key=lambda kv: kv[1][0] /
                              kv[1][1]),
                    within=all(e <= b for e, b in errs.values()),
                    params=len(errs))
                del ref
                gc.collect()
                torch.cuda.empty_cache()
    timed = step_ms[PAR_PP["warmup"]:]
    mean = sum(timed) / len(timed)
    n, m = nw, PAR_PP["micro"]
    wire = clock.read()
    out.update(losses=losses, step_ms=step_ms, step_ms_mean=mean,
               tokens_per_s=x.shape[0] * x.shape[1] / mean * 1e3,
               wire=wire, recv_share=wire["recv"]["ms"] / sum(timed),
               schedule_bubble=(n - 1) / (m + n - 1),
               launches=_minus(_flash_counts(flash_attention, split_f32), c1),
               expected_f32_launches=per_stage * m * PAR_PP["steps"],
               stages=nw, blocks_a_stage=per_stage,
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def par_moe(mx, dist, torch, clock, meshes, ctx):
    """17d on one rank: ExpertParallelMoE at the LM's FFN widths over
    {"ep": 2}, dense and capacity dispatch, forward and backward, each rank
    holding its own experts (as the trainer hands them over), against one
    rank's dense layer from the same whole weights (every rank computes it
    and holds its shard to its slice); then DataParallelTrainer over
    {"dp": 1, "ep": 2} with adam.  The tokens share a seeded direction, so
    the router favours one expert and capacity dispatch drops tokens."""
    from incubator_mxnet_tpu_torch.models import HostXavier
    from incubator_mxnet_tpu_torch.parallel import ExpertParallelMoE
    cfg = PAR_MOE
    N, d, E, h = cfg["tokens"], LM_CONFIG["d_model"], cfg["experts"], \
        cfg["hidden"]
    ep_mesh = meshes["ep"]
    nw = ep_mesh.size
    me = dist.RankAxis(ep_mesh, "ep").index
    lo, hi = me * E // nw, (me + 1) * E // nw
    rs = np.random.default_rng(SEED + 7)
    skew = np.random.default_rng(SEED + 8).standard_normal(d).astype(
        np.float32)
    skew *= cfg["skew"] / np.linalg.norm(skew)
    x0 = torch.from_numpy(rs.standard_normal((N, d), np.float32) + skew).to(
        ctx.torch_device())

    def layer(dispatch, params=None):
        blk = ExpertParallelMoE(h, E, dispatch=dispatch,
                                capacity_factor=cfg["capacity_factor"],
                                prefix="moe_", params=params)
        if params is None:
            blk._pre_infer(x0)
        return blk

    def run(blk, mesh, mask=None):
        x = mx.nd.NDArray(x0.clone(), ctx=ctx)
        x.attach_grad()
        scope = mx.parallel.use_mesh(mesh) if mesh is not None else \
            contextlib.nullcontext()
        torch.cuda.synchronize()
        clock.reset()
        t1 = time.perf_counter()
        with scope, mx.autograd.record():
            out = blk(x)
            sq = out * out if mask is None else \
                mx.nd.broadcast_mul(out * out, mask)
            loss = sq.sum()
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        vals = [out._data, x.grad._data] + [
            p.grad()._data for p in blk.collect_params().values()]
        return [v.detach().clone() for v in vals], ms, clock.read()

    def rel(a, b):
        return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))

    res = {}
    # one set of whole weights, drawn once: the one-rank reference's and,
    # later, the trainer's (which splits them itself)
    whole = layer("dense")
    whole.initialize(HostXavier(SEED + 3), ctx=ctx)
    gw, w1, w2 = (p.data()._data for p in whole.collect_params().values())
    def own(dispatch):
        # this rank's experts only, as DataParallelTrainer hands them over
        blk = layer(dispatch)
        blk.expert_w1.shape = (hi - lo, d, h)
        blk.expert_w2.shape = (hi - lo, h, d)
        blk.initialize(mx.init.Zero(), ctx=ctx)
        for p, w in zip(blk.collect_params().values(),
                        (gw, w1[lo:hi], w2[lo:hi])):
            p.set_data(mx.nd.NDArray(w.detach(), ctx=ctx))
        return blk

    got, res["dense_ms"], res["dense_wire"] = run(own("dense"), ep_mesh)
    cap = own("capacity")
    got_cap, res["capacity_ms"], res["capacity_wire"] = run(cap, ep_mesh)
    res["last_drop_fraction"] = cap.last_drop_fraction
    del cap
    # the host recount: each shard's tokens (N/2 each) routed by the
    # router's argmax on the card, slots in arrival order, cap per expert
    nloc = N // nw
    capn = max(1, int(math.ceil(cfg["capacity_factor"] * nloc / E)))
    keep, drops = [], []
    with torch.no_grad():
        for s in range(nw):
            xs = x0[s * nloc:(s + 1) * nloc]
            choice = torch.argmax(torch.softmax(xs @ gw, dim=-1),
                                  dim=-1).cpu().numpy()
            seen = np.zeros(E, np.int64)
            k = np.zeros(nloc, bool)
            for t, e in enumerate(choice):
                k[t] = seen[e] < capn
                seen[e] += 1
            keep.append(k)
            drops.append(1.0 - k.sum() / nloc)
    keep = np.concatenate(keep)
    res["host_drop_fraction"] = float(np.mean(drops))
    res["drop_matches"] = abs(res["last_drop_fraction"] -
                              res["host_drop_fraction"]) <= 1e-6
    # the reference's expert gradients are whole: this rank's slice of them
    ref, res["reference_ms"], _ = run(whole, None)
    ref[3], ref[4] = ref[3][lo:hi], ref[4][lo:hi]
    res["dense_rel"] = [rel(a, b) for a, b in zip(got, ref)]
    mask = mx.nd.NDArray(torch.from_numpy(keep.astype(np.float32))[
        :, None].to(ctx.torch_device()), ctx=ctx)
    ref_cap, _, _ = run(whole, None, mask)
    ref_cap[3], ref_cap[4] = ref_cap[3][lo:hi], ref_cap[4][lo:hi]
    kept = torch.from_numpy(keep).to(ctx.torch_device())
    res["capacity_rel"] = [
        rel(got_cap[0][kept], ref_cap[0][kept]),
        rel(got_cap[1][kept], ref_cap[1][kept])] + [
        rel(a, b) for a, b in zip(got_cap[2:], ref_cap[2:])]
    res["dropped_rows"] = int((~kept).sum())
    res["dropped_rows_zero"] = bool(
        (got_cap[0][~kept] == 0).all() and (got_cap[1][~kept] == 0).all())
    res["dense_ok"] = max(res["dense_rel"]) <= PAR_MOE_REL
    res["capacity_ok"] = max(res["capacity_rel"]) <= PAR_MOE_REL
    del got, got_cap, ref, ref_cap, gw, w1, w2
    gc.collect()
    torch.cuda.empty_cache()
    # the trainer: the capacity layer and a classifier head, adam
    net = mx.gluon.nn.HybridSequential(prefix="moe_net_")
    moe = layer("capacity", whole.collect_params())
    del whole
    net.add(moe)
    head = mx.gluon.nn.Dense(cfg["classes"], in_units=d, prefix="moe_head_")
    head.initialize(HostXavier(SEED + 4), ctx=ctx)
    net.add(head)
    labels = mx.nd.array(np.random.RandomState(SEED).randint(
        0, cfg["classes"], N).astype(np.float32), ctx=ctx)
    trainer = mx.parallel.DataParallelTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {"learning_rate": cfg["lr"]},
        mesh=meshes["dp_ep"])
    xin = mx.nd.NDArray(x0, ctx=ctx)
    losses, step_ms, drops = [], [], []
    for i in range(cfg["warmup"] + cfg["steps"]):
        if i == cfg["warmup"]:
            clock.reset()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(float(trainer.step(xin, labels).asscalar()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        drops.append(moe.last_drop_fraction)
    w1 = trainer._params[moe.expert_w1.name]
    timed = step_ms[cfg["warmup"]:]
    res["trainer"] = dict(
        losses=losses, step_ms=step_ms, step_ms_mean=sum(timed) / len(timed),
        wire=clock.read(), drop_fractions=drops,
        expert_shard_shape=list(w1.shape),
        sharded=w1.shape[0] == E // nw,
        # the weights every rank of "ep" holds whole (the gate, the head)
        replicated_digest=_digest({n: v for n, v in trainer._params.items()
                                   if n not in trainer._split}))
    del trainer, net
    gc.collect()
    torch.cuda.empty_cache()
    return res


def par_task(mx, dist, wire, out_dir, layers, kind="dist_sync"):
    """Phase 17 on one rank (17a-17d, in order), its meshes of ranks on
    the wire ``kind``."""
    import torch
    from incubator_mxnet_tpu_torch.ops.attention import (flash_attention,
                                                         split_f32)
    ctx = dist.local_context()
    nw = dist.num_workers()
    meshes = {name: dist.worker_mesh(kvstore=kind, axes=axes) for name, axes
              in (("sp", {"sp": nw}), ("dp_sp", {"dp": 1, "sp": nw}),
                  ("pp", {"pp": nw}), ("ep", {"ep": nw}),
                  ("dp_ep", {"dp": 1, "ep": nw}))}
    clock = AxisClock(dist, torch)
    out = {}
    t0 = time.perf_counter()
    out["a"] = par_collectives(mx, dist, torch, clock, meshes)
    out["a_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    net, x, y, out["b"] = par_lm(mx, dist, torch, clock, meshes,
                                 int(layers), ctx)
    out["b_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["c"] = par_pipeline(mx, dist, torch, clock, meshes, net, x, y, ctx)
    out["c_s"] = time.perf_counter() - t0
    del net
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["d"] = par_moe(mx, dist, torch, clock, meshes, ctx)
    out["d_s"] = time.perf_counter() - t0
    out["flash_totals"] = _flash_counts(flash_attention, split_f32)
    return out


def par_lm_layers(torch, lm_peak, nw):
    """17b's depth: each rank holds 4d's whole step (batch 8, bf16: its
    peak ``lm_peak`` for 4 layers) plus DIST_LM_SLACK; PAR_LM['layers'],
    cut further until ``nw`` such ranks fit 90% of the card's free
    memory."""
    free, _ = torch.cuda.mem_get_info()
    layers = PAR_LM["layers"]
    while True:
        est = int(lm_peak * layers / LM_CONFIG["n_layers"]) + DIST_LM_SLACK
        if nw * est <= 0.9 * free or layers == 1:
            return layers, est
        layers -= 1


def par_report(ranks, layers, card, label=""):
    """Phase 17's checks and lines over the ranks' results (17a-17d, or
    17e's with ``label``); returns B1's launches in them."""
    def chk(cond, msg):
        check(cond, label + msg)

    r0 = ranks[0]
    # 17a
    for r in ranks:
        chk(all(r["a"]["checks"].values()), "17a rank %d: %s"
            % (r["rank"], r["a"]["checks"]))
    chk(len({r["a"]["psum_digest"] for r in ranks}) == 1,
        "17a: the ranks' sums differ")
    print(label + "par 17a: ring shift, all_to_all, psum and all_gather on "
          "card tensors bit-equal to the host's answers on every rank; "
          "rank 0 ms and bytes %s | %s" % (json.dumps(r0["a"]["ms"]), card),
          flush=True)
    # 17b
    b = [r["b"] for r in ranks]
    wl = b[0]["witness_launches"]
    for r in b:
        want = layers + 1 if r is b[0] else 1
        got = r["witness_launches"]
        chk(got["fwd"] == want and got["bwd"] == want and
            got["bwd_torch"] == 0,
            "17b: the witness step and the local MHA layer launched %s, "
            "expected %d forward and backward kernels" % (got, want))
    for r in b:
        chk(r["mha"]["ok"], "17b: the ring MHA layer against flash: %s"
            % r["mha"])
        chk(r["sp_launches"]["fwd"] == 0 and r["sp_launches"]["bwd"] == 0,
            "17b: the ring run launched flash kernels %s"
            % r["sp_launches"])
        chk(all(math.isfinite(v) for v in r["losses"]) and
            r["losses"][-1] < r["losses"][0],
            "17b: the loss did not fall: %s" % r["losses"])
    equal = len({r["digest_after_one_step"] for r in b}) == 1
    chk(equal, "17b: the ranks' weights differ after one step")
    # the bound: the ring and flash round each layer's attention output to
    # bf16 in their own ways, one MHA layer's gradients within flash's bf16
    # bound (PAR_MHA_REL) of each other; every gradient passes through at
    # most ``layers`` such layers
    bound = layers * PAR_MHA_REL
    upd = b[0]["update_gap"]
    gap = abs(b[0]["losses"][0] - b[0]["witness_loss"])
    chk(upd["rel_l2"] <= bound, "17b: the ring's first update of the "
        "weights is %.3g of the witness's away from it, bound %.3g"
        % (upd["rel_l2"], bound))
    ring = b[0]["wire"]["ring_shift"]
    gath = b[0]["wire"]["all_gather"]
    print(label + "par 17b (%d layers, {dp: 1, sp: %d}, bf16): step %.3f ms, "
          "%.1f tokens/s (each rank the whole batch); ring hops %d calls %.3f "
          "ms %d bytes, gathers %d calls %.3f ms %d bytes in %d steps on rank "
          "0 (staged through the host: %d, %d); losses by rank %s; first loss "
          "%.6f against the witness's %.6f (flash, one rank, %.3f ms a step): "
          "%.3g; the first update of the weights %.3g of the witness's from "
          "it (norm over every weight; bound %.3g), at most %.3g of a "
          "tensor's largest (%s); weights bit-equal after one step %s; MHA "
          "ring vs flash relative %s (bound %g); witness launches %s; peak "
          "memory by rank %s | %s"
          % (layers, len(b), b[0]["step_ms_mean"], b[0]["tokens_per_s"],
             ring["calls"], ring["ms"], ring["bytes"], gath["calls"],
             gath["ms"], gath["bytes"], b[0]["steps"], ring["staged"],
             gath["staged"], [["%.6f" % v for v in r["losses"]] for r in b],
             b[0]["losses"][0], b[0]["witness_loss"], b[0]["witness_ms"],
             gap, upd["rel_l2"], bound, upd["worst"][0], upd["worst"][1],
             equal,
             {k: "%.3g" % v for k, v in b[0]["mha"]["rel_errs"].items()},
             PAR_MHA_REL, wl, [r["peak_memory_bytes"] for r in b], card),
          flush=True)
    # 17c
    c = [r["c"] for r in ranks]
    for r, rc in zip(ranks, c):
        la = rc["launches"]
        chk(la["f32"] == rc["expected_f32_launches"] and
            la["bwd_torch"] == rc["expected_f32_launches"],
            "17c rank %d: B1's f32 launches %s, expected %d forward and "
            "%d backward through the torch ops" % (
                r["rank"], la, rc["expected_f32_launches"],
                rc["expected_f32_launches"]))
        chk(all(math.isfinite(v) for v in rc["losses"]) and
            rc["losses"][-1] < rc["losses"][0],
            "17c: the loss did not fall: %s" % rc["losses"])
    w = c[0]["weights_after_one_step"]
    chk(w["within"], "17c: the pipelined step's weights against the "
        "unpipelined step's: worst %s" % (w["worst"],))
    chk(abs(c[0]["losses"][0] - c[0]["reference_loss"]) <=
        1e-5 * abs(c[0]["reference_loss"]),
        "17c: the first loss %.7f against the unpipelined %.7f"
        % (c[0]["losses"][0], c[0]["reference_loss"]))
    hops = c[0]["wire"]
    print(label + "par 17c ({pp: %d}, %d stages of %d DecoderBlocks, f32, %d "
          "microbatches of 2 x 1024): step %.3f ms, %.1f tokens/s; sends "
          "%d calls %.3f ms %d bytes, receives %d calls %.3f ms on rank 0 "
          "(staged %d); receive wait %.3f of the step on rank 0, %.3f on "
          "rank 1 (the schedule's bubble %.3f); losses %s; first loss "
          "%.7f, unpipelined %.7f (%.3f ms); weights after one step: %d "
          "within 2^-10 of the largest update plus 2 ulps, worst %s; B1 "
          "f32 launches by rank %s; peak memory by rank %s | %s"
          % (c[0]["stages"], c[0]["stages"], c[0]["blocks_a_stage"],
             PAR_PP["micro"], c[0]["step_ms_mean"], c[0]["tokens_per_s"],
             hops["send"]["calls"], hops["send"]["ms"], hops["send"]["bytes"],
             hops["recv"]["calls"], hops["recv"]["ms"],
             hops["send"]["staged"], c[0]["recv_share"], c[1]["recv_share"],
             c[0]["schedule_bubble"], ["%.6f" % v for v in c[0]["losses"]],
             c[0]["losses"][0], c[0]["reference_loss"],
             c[0]["reference_ms"], w["params"], w["worst"],
             [rc["launches"] for rc in c],
             [rc["peak_memory_bytes"] for rc in c], card), flush=True)
    # 17d
    d = [r["d"] for r in ranks]
    d0 = d[0]
    for r, rd in zip(ranks, d):
        chk(rd["dense_ok"], "17d rank %d: dense dispatch against one rank: "
            "%s" % (r["rank"], rd["dense_rel"]))
        chk(rd["capacity_ok"] and rd["dropped_rows_zero"],
            "17d rank %d: capacity dispatch against one rank: %s, dropped "
            "rows zero %s" % (r["rank"], rd["capacity_rel"],
                              rd["dropped_rows_zero"]))
        chk(rd["dropped_rows"] > 0, "17d: capacity dispatch dropped no "
            "token, so the drop path went untested")
        chk(rd["drop_matches"], "17d: last_drop_fraction %r against the "
            "host's recount %r" % (rd["last_drop_fraction"],
                                   rd["host_drop_fraction"]))
        t = rd["trainer"]
        chk(t["sharded"] and t["losses"][-1] < t["losses"][0] and
            all(math.isfinite(v) for v in t["losses"]),
            "17d: the trainer: losses %s, expert shard %s"
            % (t["losses"], t["expert_shard_shape"]))
    chk(len({rd["trainer"]["replicated_digest"] for rd in d}) == 1,
        "17d: the ranks' replicated weights (gate, head) differ after the "
        "trainer's steps")
    t = d0["trainer"]
    print(label + "par 17d (ExpertParallelMoE(%d, %d) on (%d, %d) f32 over "
          "{ep: %d}): dense fwd+bwd %.3f ms (psum %d bytes), capacity %.3f ms "
          "(all_to_all %d calls %d bytes), one rank's dense %.3f ms; "
          "relative to it on rank 0 (its experts' slice): dense %s, "
          "capacity kept rows %s (bound %g), %d dropped rows zero %s; drop "
          "fraction %.6f = host recount %.6f; adam over {dp: 1, ep: %d}: "
          "step %.3f ms, losses %s, drop fractions %s, expert shard %s, "
          "all_to_all %d bytes in %d steps, the gate and head bit-equal "
          "across the ranks | %s"
          % (PAR_MOE["hidden"], PAR_MOE["experts"], PAR_MOE["tokens"],
             LM_CONFIG["d_model"], len(ranks), d0["dense_ms"],
             d0["dense_wire"]["psum"]["bytes"], d0["capacity_ms"],
             d0["capacity_wire"]["all_to_all"]["calls"],
             d0["capacity_wire"]["all_to_all"]["bytes"], d0["reference_ms"],
             ["%.3g" % v for v in d0["dense_rel"]],
             ["%.3g" % v for v in d0["capacity_rel"]], PAR_MOE_REL,
             d0["dropped_rows"], d0["dropped_rows_zero"],
             d0["last_drop_fraction"],
             d0["host_drop_fraction"], len(ranks), t["step_ms_mean"],
             ["%.6f" % v for v in t["losses"]],
             ["%.4f" % v for v in t["drop_fractions"]],
             t["expert_shard_shape"], t["wire"]["all_to_all"]["bytes"],
             PAR_MOE["steps"], card), flush=True)
    return dict(
        bf16_fwd=sum(r["witness_launches"]["fwd"] for r in b),
        bf16_bwd=sum(r["witness_launches"]["bwd"] for r in b),
        f32_fwd=sum(rc["launches"]["f32"] for rc in c),
        f32_fwd_by_rank=[rc["launches"]["f32"] for rc in c],
        split=sum(rc["launches"]["split"] for rc in c))


def parallel_phase(mx, card, lm_peak):
    """Phase 17 (17a-17e); the card's memory released first: the ranks
    are processes of their own."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    hybrid_release(mx)
    layers, est = par_lm_layers(torch, lm_peak, PAR_RANKS)
    print("par: %d ranks sharing the card over gloo; 17b's LM: about %d "
          "bytes a rank (4d's peak %d for 4 layers, batch 8) with %d bytes "
          "free: %d of %d layers%s | %s"
          % (PAR_RANKS, est, lm_peak, torch.cuda.mem_get_info()[0], layers,
             LM_CONFIG["n_layers"], "" if layers == PAR_LM["layers"]
             else " (cut to fit)", card), flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_par_") as tmp:
        ranks = launch_ranks("parallel", PAR_RANKS, tmp, PAR_TIMEOUT, layers,
                             cards=1)
    launches = par_report(ranks, layers, card)
    out = dict(layers=layers, ranks=ranks, launches=launches)
    cards = torch.cuda.device_count()
    if cards >= 2:
        out["e"] = parallel_multicard(mx, card, layers)
    else:
        print("par 17e: not run: this machine has %d card "
              "(torch.cuda.device_count() = %d); 17e needs 2 or more (17a-"
              "17d with one rank a card under NCCL, and ring attention over "
              "a one-process mesh of every card)" % (cards, cards),
              flush=True)
    out["seconds"] = time.perf_counter() - t0
    r0 = ranks[0]
    print("par: phase 17 in %.1f s (rank 0: 17a %.1f, 17b %.1f, 17c %.1f, "
          "17d %.1f) | %s" % (out["seconds"], r0["a_s"], r0["b_s"],
                              r0["c_s"], r0["d_s"], card), flush=True)
    return out


def parallel_multicard(mx, card, layers):
    """17e, on a machine of two cards or more: ring attention over a
    one-process mesh of every card against flash attention on one, then
    17a-17d with one rank a card under NCCL (dist_device_sync)."""
    import tempfile
    import torch
    cards = torch.cuda.device_count()
    mesh = mx.parallel.make_mesh({"sp": cards},
                                 [mx.gpu(i) for i in range(cards)])
    from incubator_mxnet_tpu_torch.parallel.ring_attention import \
        ring_attention
    from incubator_mxnet_tpu_torch.ops.attention import flash_attention
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn((2, 8, 256 * cards, 128), generator=gen,
                           device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    got = ring_attention(q, k, v, mesh, "sp", True)
    want = flash_attention(q, k, v, True)
    rel = float((got.float() - want.float()).abs().max() /
                want.float().abs().max())
    check(rel <= PAR_MHA_REL, "17e: ring over %d cards against flash: %.3g"
          % (cards, rel))
    print("par 17e: ring attention over a one-process mesh of %d cards "
          "against flash on one: %.3g (bound %g) | %s"
          % (cards, rel, PAR_MHA_REL, card), flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_par_") as tmp:
        ranks = launch_ranks("parallel", cards, tmp, PAR_TIMEOUT, layers,
                             "dist_device_sync")
    label = "17e, %d ranks, one a card, under NCCL: " % cards
    return dict(ring_rel=rel, ranks=ranks,
                launches=par_report(ranks, layers, card, label))


# ---------------------------------------------------------------------------
# phase 18: the rest of the op registry (ROADMAP items 9b and 11a): the
# detection and sampling ops (ops/vision.py) and INT8 quantized inference
# (ops/quantization.py, contrib/quantization.py).  No hand kernel on this
# path: the JAX build reaches no Pallas kernel here either.
# ---------------------------------------------------------------------------

# 18a: MXNet's example/rcnn Faster R-CNN (ResNet-50-C4): two 600 x 1000
# images, f32, TF32 off; the RPN's anchors are proposal.cc's defaults
DET = dict(batch=2, image=(600, 1000), rpn_mid=512, anchors=12, pooled=14,
           scale=1.0 / 16, classes=21, sample_ratio=2, requests=4,
           cpu_rois=16)
# 18b: Deformable ConvNets' R-FCN head at R-FCN's 7 x 7 bins, 21 VOC classes
RFCN = dict(channels=512, filters=512, dilate=2, groups=4, bins=7,
            part=7, samples=4, trans_std=0.1)
# 18c: FlowNetC's correlation; a spatial transformer on ImageNet images
FLOW = dict(shape=(8, 256, 48, 64), displacement=20, stride2=2, pad=20,
            cpu_batch=1)
STN = dict(shape=(32, 3, 224, 224), target=(224, 224), cpu_batch=4)
# 18d: example/quantization/imagenet_inference.py's path: ResNet-50 v1 at
# batch 32, 4 calibration batches of 8, 2 held-out batches
QUANT = dict(batch=32, image=224, calib_batches=4, calib_batch=8,
             held_out=2, reps=5, classes=1000, bn_passes=40)
# card against the port on the CPU, in f32 with TF32 off: the same
# operations summed in other orders (cuDNN's convolutions, cuBLAS's and
# MKL's products, CUDA's and the CPU's reductions and scatter-adds), a few
# ulps an op, carried through stage 3 of ResNet-50: 1e-4 of the largest
# magnitude (ZOO_REL's bound for whole nets); the sampling ops' gathers and
# channel means: 1e-5.  Proposal on the same RPN outputs, and every int8
# and int32 code: bit for bit.
DET_REL = 1e-4
SAMPLE_REL = 1e-5
# d feat through the whole head (res5's relus, then the ROI op): an input
# that moves by an ulp flips relu's derivative where a value sits at 0, so
# gradients through a ResNet stage are held as phase 6 holds its updates,
# by relative L2 distance (the JAX build's own gradients move by 2-2.5%
# when their input moves by one ulp, tests/test_torch_resnet.py); the ROI
# op's own backward, from the card's d pooled, is held to SAMPLE_REL
HEAD_GRAD_REL = 0.1


def _max_rel(got, want):
    """max |got - want| over max |want| (numpy)."""
    return float(np.abs(got.astype(np.float64) - want).max() /
                 max(float(np.abs(want).max()), 1e-30))


def _seeded_rpn(np, rs, c, mid, n_a):
    return dict(conv=(rs.standard_normal((mid, c, 3, 3)) *
                      math.sqrt(2.0 / (c * 9))).astype(np.float32),
                conv_b=np.zeros(mid, np.float32),
                cls=(rs.standard_normal((2 * n_a, mid, 1, 1)) * 0.01)
                .astype(np.float32),
                cls_b=np.zeros(2 * n_a, np.float32),
                box=(rs.standard_normal((4 * n_a, mid, 1, 1)) * 0.01)
                .astype(np.float32),
                box_b=np.zeros(4 * n_a, np.float32))


def _rcnn_nets(mx, np, ctx, rs_seed=SEED, rpn_scale=1.0):
    """resnet50_v1 with seeded numpy weights (He-scaled, BatchNorm's
    statistics drawn away from their init) loaded through
    ``convert.load_numpy_params`` on ``ctx``, the RPN's weights (its 3 x 3
    convolution's scaled by ``rpn_scale``) and the class and box heads'
    (21 classes, 84 box values)."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    from incubator_mxnet_tpu_torch.convert import (load_numpy_params,
                                                    numpy_params)
    rs = np.random.RandomState(rs_seed + 18)
    mx.random.seed(SEED)
    with mx.cpu():
        shape_net = vision.resnet50_v1(classes=1000)
        shape_net.initialize(mx.init.Xavier())
        with mx.autograd.predict_mode():
            shape_net(mx.nd.zeros((1, 3, 64, 64)))
        weights = {}
        for name, v in numpy_params(shape_net).items():
            if name.endswith("gamma") or name.endswith("running_var"):
                w = rs.uniform(0.5, 1.5, v.shape)
            elif name.endswith("beta") or name.endswith("running_mean"):
                w = 0.1 * rs.standard_normal(v.shape)
            else:
                w = rs.standard_normal(v.shape) * math.sqrt(
                    2.0 / max(1, int(np.prod(v.shape[1:]))))
            weights[name] = w.astype(np.float32)
    net = vision.resnet50_v1(classes=1000)
    load_numpy_params(net, weights, ctx)
    rpn = _seeded_rpn(np, rs, 1024, DET["rpn_mid"], DET["anchors"])
    heads = dict(fc_cls=(rs.standard_normal((DET["classes"], 2048)) *
                         0.01).astype(np.float32),
                 fc_cls_b=np.zeros(DET["classes"], np.float32),
                 fc_box=(rs.standard_normal((4 * DET["classes"], 2048)) *
                         0.001).astype(np.float32),
                 fc_box_b=np.zeros(4 * DET["classes"], np.float32))
    rpn.update(heads)
    rpn["conv"] = rpn["conv"] * np.float32(rpn_scale)
    params = {k: mx.nd.array(v, ctx=ctx) for k, v in rpn.items()}
    return net, params


def _rcnn_trunk(mx, net, x):
    """ResNet-50 v1 through stage 3: stride 16, 1024 channels."""
    for i in range(7):
        x = net.features[i](x)
    return x


def _rcnn_rpn(mx, p, feat, im_info):
    """The RPN: 3 x 3 conv and relu, 1 x 1 class scores (2A) softmaxed
    over background/object, 1 x 1 box deltas (4A), MultiProposal at
    proposal.cc's defaults (pre 6000, post 300, threshold 0.7, min size
    16, scales (4, 8, 16, 32), ratios (0.5, 1, 2), stride 16)."""
    nd = mx.nd
    n_a = DET["anchors"]
    r = nd.relu(nd.Convolution(feat, p["conv"], p["conv_b"], kernel=(3, 3),
                               pad=(1, 1), num_filter=DET["rpn_mid"]))
    score = nd.Convolution(r, p["cls"], p["cls_b"], kernel=(1, 1),
                           num_filter=2 * n_a)
    b, _, h, w = score.shape
    prob = nd.reshape(nd.softmax(nd.reshape(score, shape=(b, 2, -1, w)),
                                 axis=1), shape=(b, 2 * n_a, h, w))
    deltas = nd.Convolution(r, p["box"], p["box_b"], kernel=(1, 1),
                            num_filter=4 * n_a)
    return prob, deltas


def _rcnn_head(mx, net, p, pooled):
    """res5 (stage 4, stride 2: 14 x 14 -> 7 x 7) on the pooled ROIs,
    global pooling, the class scores (softmax) and box deltas."""
    nd = mx.nd
    x = net.features[8](net.features[7](pooled))
    x = nd.Flatten(x)
    cls = nd.softmax(nd.FullyConnected(x, p["fc_cls"], p["fc_cls_b"],
                                       num_hidden=DET["classes"]))
    box = nd.FullyConnected(x, p["fc_box"], p["fc_box_b"],
                            num_hidden=4 * DET["classes"])
    return cls, box


def _roi_ops(mx):
    nd = mx.nd
    k = DET["pooled"]
    return {
        "ROIPooling": lambda f, r: nd.ROIPooling(
            f, r, pooled_size=(k, k), spatial_scale=DET["scale"]),
        "ROIAlign": lambda f, r: nd.contrib.ROIAlign(
            f, r, pooled_size=(k, k), spatial_scale=DET["scale"],
            sample_ratio=DET["sample_ratio"])}


def _head_grad(mx, net, p, feat_np, rois_np, roi_op, ctx, pooled_g=None):
    """One backward of the head's outputs over ``rois_np`` (each weighted
    by a seeded normal value: a plain sum of the class softmax has no
    gradient but rounding) through ``roi_op``, from the same feature map on
    ``ctx``: (d feat, d pooled).  With ``pooled_g`` the ROI op's backward
    alone: d feat for that gradient of its output."""
    feat = mx.nd.array(feat_np, ctx=ctx)
    feat.attach_grad()
    rois = mx.nd.array(rois_np, ctx=ctx)
    if pooled_g is not None:
        with mx.autograd.record(train_mode=False):
            pooled = roi_op(feat, rois)
        pooled.backward(mx.nd.array(pooled_g, ctx=ctx))
        return feat.grad.asnumpy(), pooled_g
    rs = np.random.RandomState(SEED + 1811)
    wc = rs.standard_normal((len(rois_np), DET["classes"])).astype(
        np.float32)
    wb = rs.standard_normal((len(rois_np), 4 * DET["classes"])).astype(
        np.float32)
    with mx.autograd.record(train_mode=False):
        pooled = roi_op(feat, rois)
        pooled.attach_grad()
        cls, box = _rcnn_head(mx, net, p, pooled)
        loss = mx.nd.sum(cls * mx.nd.array(wc, ctx=ctx)) + mx.nd.sum(
            box * mx.nd.array(wb, ctx=ctx))
    loss.backward()
    return feat.grad.asnumpy(), pooled.grad.asnumpy()


def faster_rcnn(mx, card):
    """18a: Faster R-CNN inference at two 600 x 1000 images (ResNet-50-C4,
    the RPN, MultiProposal, ROIPooling then ROIAlign at 14 x 14 and 1/16,
    res5 and the heads) on the card; the request timed (host clock to
    synchronize, mean of DET['requests'] after a warm-up), Proposal and
    the ROI op alone (CUDA events), the peak memory.  Held against the port
    on the CPU from the same weights: the trunk's features and the RPN's
    outputs (DET_REL), Proposal on the card's RPN outputs bit for bit (the
    kept ROIs), the head on DET['cpu_rois'] ROIs of each image (DET_REL),
    and d feat of the head's sum over them through each ROI op (DET_REL of
    its largest magnitude)."""
    import torch
    nd = mx.nd
    rs = np.random.RandomState(SEED + 181)
    b, (ih, iw) = DET["batch"], DET["image"]
    x_np = rs.standard_normal((b, 3, ih, iw)).astype(np.float32)
    info_np = np.array([[ih, iw, 1.0]] * b, np.float32)
    gpu, cpu = mx.gpu(0), mx.cpu()
    net, p = _rcnn_nets(mx, np, gpu)
    x, info = nd.array(x_np, ctx=gpu), nd.array(info_np, ctx=gpu)
    # the random trunk's features grow through its 13 units (RMS ~1e3):
    # the RPN's convolution takes 1/RMS, so that its scores and deltas
    # have a trained RPN's spread (distinct boxes for NMS to keep)
    with torch.backends.cudnn.flags(allow_tf32=False), \
            mx.autograd.predict_mode():
        f0 = _rcnn_trunk(mx, net, x).asnumpy()
    rpn_scale = float(np.float32(1.0 / np.sqrt(np.mean(
        f0.astype(np.float64) ** 2))))
    del f0
    net, p = _rcnn_nets(mx, np, gpu, rpn_scale=rpn_scale)
    ops = _roi_ops(mx)
    out = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.backends.cudnn.flags(allow_tf32=False), \
            mx.autograd.predict_mode():
        def request(op_name):
            feat = _rcnn_trunk(mx, net, x)
            prob, deltas = _rcnn_rpn(mx, p, feat, info)
            rois = nd.contrib.MultiProposal(prob, deltas, info)
            cls, box = _rcnn_head(mx, net, p, ops[op_name](feat, rois))
            return feat, prob, deltas, rois, cls, box

        for op_name in ops:
            res = request(op_name)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DET["requests"]):
                request(op_name)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / DET["requests"]
            feat, prob, deltas, rois = res[:4]
            roi_ms = cuda_ms(lambda: ops[op_name](feat, rois), 4, torch)
            out[op_name] = dict(request_ms=ms, roi_op_ms=roi_ms,
                                res=[a.asnumpy() for a in res])
        prop_ms = cuda_ms(lambda: nd.contrib.MultiProposal(prob, deltas,
                                                           info), 4, torch)
    peak = torch.cuda.max_memory_allocated()
    feat_g, prob_g, deltas_g, rois_g = out["ROIPooling"]["res"][:4]
    check(rois_g.shape == (b * 300, 5) and np.isfinite(rois_g).all(),
          "18a: rois %s" % (rois_g.shape,))
    kept = [int(((rois_g[:, 0] == i) & (rois_g[:, 3] > rois_g[:, 1]))
                .sum()) for i in range(b)]
    # the port on the CPU, the same weights
    net_c, p_c = _rcnn_nets(mx, np, cpu, rpn_scale=rpn_scale)
    with mx.autograd.predict_mode(), cpu:
        feat_c = _rcnn_trunk(mx, net_c, nd.array(x_np))
        prob_c, deltas_c = _rcnn_rpn(mx, p_c, feat_c, nd.array(info_np))
        rois_same = nd.contrib.MultiProposal(
            nd.array(prob_g), nd.array(deltas_g), nd.array(info_np))
        rois_own = nd.contrib.MultiProposal(prob_c, deltas_c,
                                            nd.array(info_np)).asnumpy()
    errs = dict(feat=_max_rel(feat_g, feat_c.asnumpy()),
                prob=_max_rel(prob_g, prob_c.asnumpy()),
                deltas=_max_rel(deltas_g, deltas_c.asnumpy()))
    same = bool(np.array_equal(rois_same.asnumpy(), rois_g))
    own_same = bool(np.array_equal(rois_own, rois_g))
    check(same, "18a: Proposal on the CPU from the card's RPN outputs kept "
          "other ROIs than the card")
    for k_, v_ in errs.items():
        check(v_ <= DET_REL, "18a: %s on the card %.3e from the CPU (bound "
              "%.0e)" % (k_, v_, DET_REL))
    sub = np.concatenate([np.where(rois_g[:, 0] == i)[0][:DET["cpu_rois"]]
                          for i in range(b)])
    for op_name, op in ops.items():
        cls_g, box_g = out[op_name]["res"][4:]
        with mx.autograd.predict_mode(), cpu:
            cls_c, box_c = _rcnn_head(mx, net_c, p_c, op(
                nd.array(feat_g), nd.array(rois_g[sub])))
        e_cls = _max_rel(cls_g[sub], cls_c.asnumpy())
        e_box = _max_rel(box_g[sub], box_c.asnumpy())
        with torch.backends.cudnn.flags(allow_tf32=False):
            g_card, pooled_g = _head_grad(mx, net, p, feat_g, rois_g[sub],
                                          op, gpu)
            op_card, _ = _head_grad(mx, net, p, feat_g, rois_g[sub], op,
                                    gpu, pooled_g)
        with cpu:
            g_cpu, _ = _head_grad(mx, net_c, p_c, feat_g, rois_g[sub], op,
                                  cpu)
            op_cpu, _ = _head_grad(mx, net_c, p_c, feat_g, rois_g[sub], op,
                                   cpu, pooled_g)
        e_op = _max_rel(op_card, op_cpu)
        e_grad = float(np.linalg.norm((g_card - g_cpu).ravel()) /
                       max(np.linalg.norm(g_cpu.ravel()), 1e-30))
        check(max(e_cls, e_box) <= DET_REL and e_op <= SAMPLE_REL and
              e_grad <= HEAD_GRAD_REL and np.abs(op_cpu).max() > 0,
              "18a %s: head %.3e / %.3e, the ROI op's d feat %.3e (bound "
              "%.0e), the head's d feat %.3e relative L2 (bound %.0e) from "
              "the CPU" % (op_name, e_cls, e_box, e_op, SAMPLE_REL, e_grad,
                           HEAD_GRAD_REL))
        out[op_name].update(cls_err=e_cls, box_err=e_box, roi_grad_err=e_op,
                            head_grad_rel_l2=e_grad)
        del out[op_name]["res"]
        print("det 18a %s: Faster R-CNN request (2 x 600 x 1000, f32) "
              "%.3f ms, the ROI op alone %.3f ms on (%d, 1024, 38, 63) -> "
              "(%d, 1024, 14, 14); head vs CPU on %d ROIs: cls %.3e, box "
              "%.3e (bound %.0e); d feat of the ROI op's backward for the "
              "card's d pooled %.3e (bound %.0e), of the whole head %.3e "
              "relative L2 (bound %.0e) | %s"
              % (op_name, out[op_name]["request_ms"],
                 out[op_name]["roi_op_ms"], b, len(rois_g), len(sub), e_cls,
                 e_box, DET_REL, e_op, SAMPLE_REL, e_grad, HEAD_GRAD_REL,
                 card), flush=True)
    print("det 18a: MultiProposal alone %.3f ms (2 x 22,680 anchors, pre "
          "6000, post 300, NMS 0.7); kept ROIs a image %s; on the CPU from "
          "the card's RPN outputs the same ROIs bit for bit: %s; from its "
          "own RPN outputs: %s; trunk %.3e, RPN prob %.3e, deltas %.3e from "
          "the CPU (bound %.0e); peak memory %d bytes | %s"
          % (prop_ms, kept, same, own_same, errs["feat"], errs["prob"],
             errs["deltas"], DET_REL, peak, card), flush=True)
    del net_c, feat_c
    gc.collect()
    return dict(out, proposal_ms=prop_ms, kept=kept, same_rois=same,
                own_rpn_same_rois=own_same, errs=errs,
                peak_memory_bytes=peak, rois=rois_g, feat=feat_g)


def _card_cpu(mx, fn, arrays, grads, ct_seed, cpu_slice=None):
    """``fn(*nd arrays)`` on the card (forward and forward with backward
    timed by CUDA events; one forward and backward of a seeded head
    gradient) and on the CPU on the same arrays, the first ``cpu_slice``
    images of the batch where given (every op here maps the images of a
    batch independently): (card outputs, card grads, CPU outputs, CPU
    grads, forward ms, forward and backward ms)."""
    import torch
    nd = mx.nd

    def run(ctx, arrs, ct):
        xs = [nd.array(a, ctx=ctx) for a in arrs]
        for i in grads:
            xs[i].attach_grad()
        with mx.autograd.record():
            y = fn(*xs)
        if ct is None:
            ct = np.random.RandomState(ct_seed).standard_normal(
                y.shape).astype(np.float32)
        y.backward(nd.array(ct[:y.shape[0]], ctx=ctx))
        return y.asnumpy(), [xs[i].grad.asnumpy() for i in grads], xs, ct

    with torch.backends.cudnn.flags(allow_tf32=False):
        yg, gg, xs, ct = run(mx.gpu(0), arrays, None)
        fwd_ms = cuda_ms(lambda: fn(*xs), 3, torch)

        def fwd_bwd():
            with mx.autograd.record():
                y = fn(*xs)
            y.backward()
        both_ms = cuda_ms(fwd_bwd, 3, torch)
    del xs
    cut = arrays if cpu_slice is None else [a[:cpu_slice] for a in arrays]
    with mx.cpu():
        yc, gc_, _, _ = run(mx.cpu(), cut, ct)
    if cpu_slice is not None:
        yg = yg[:cpu_slice]
        gg = [g[:cpu_slice] for g in gg]
    return yg, gg, yc, gc_, fwd_ms, both_ms


def _held(what, card, bound, yg, gg, yc, gc_, fwd_ms, both_ms, names):
    errs = {"out": _max_rel(yg, yc)}
    for n, g, c in zip(names, gg, gc_):
        errs["d " + n] = _max_rel(g, c)
    check(all(v <= bound for v in errs.values()) and np.isfinite(yg).all(),
          "%s: card vs CPU %s (bound %.0e)" % (what, errs, bound))
    print("%s: forward %.3f ms, forward and backward %.3f ms; card vs CPU "
          "%s (bound %.0e) | %s" % (what, fwd_ms, both_ms, ", ".join(
              "%s %.3e" % kv for kv in errs.items()), bound, card),
          flush=True)
    return dict(fwd_ms=fwd_ms, fwd_bwd_ms=both_ms, errs=errs)


def rfcn_heads(mx, card, rois, feat):
    """18b: Deformable ConvNets' R-FCN head: a 3 x 3 deformable
    convolution (512 filters, dilate 2, pad 2, 4 deformable groups) on
    (2, 512, 38, 63) with its 72 offset channels from a 3 x 3 convolution;
    PSROIPooling and DeformablePSROIPooling (output_dim 21, 7 x 7 bins, 1/16)
    of a 1029-channel score map over 18a's ROIs; each forward and backward
    against the port on the CPU."""
    import torch
    nd = mx.nd
    rs = np.random.RandomState(SEED + 182)
    c, f, dg = RFCN["channels"], RFCN["filters"], RFCN["groups"]
    n, _, h, w = feat.shape
    data = (rs.standard_normal((n, c, h, w))).astype(np.float32)
    w_off = (rs.standard_normal((2 * dg * 9, c, 3, 3)) * 0.02).astype(
        np.float32)
    weight = (rs.standard_normal((f, c, 3, 3)) *
              math.sqrt(2.0 / (c * 9))).astype(np.float32)
    bias = np.zeros(f, np.float32)
    conf = dict(kernel=(3, 3), pad=(2, 2), dilate=(2, 2), num_filter=f,
                num_deformable_group=dg)

    with torch.backends.cudnn.flags(allow_tf32=False):
        offset = nd.Convolution(nd.array(data, ctx=mx.gpu(0)), nd.array(
            w_off, ctx=mx.gpu(0)), kernel=(3, 3), pad=(2, 2), dilate=(2, 2),
            num_filter=2 * dg * 9, no_bias=True).asnumpy()
    out = {}
    out["deformable_conv"] = _held(
        "rfcn 18b DeformableConvolution (2, 512, 38, 63) 3x3 dilate 2 DG 4, "
        "offsets (2, 72, 38, 63) from a 3x3 conv", card, DET_REL,
        *_card_cpu(mx, lambda d, o, wt, bi: nd.contrib.DeformableConvolution(
            d, o, wt, bi, **conf), [data, offset, weight, bias], (0, 1, 2),
            SEED + 1821), ("data", "offset", "weight"))
    k, od = RFCN["bins"], DET["classes"]
    scores = rs.standard_normal((n, od * k * k, h, w)).astype(np.float32)
    out["psroi"] = _held(
        "rfcn 18b PSROIPooling (%d ROIs, 21 x 7 x 7 over (2, 1029, 38, 63))"
        % len(rois), card, SAMPLE_REL,
        *_card_cpu(mx, lambda s, r: nd.contrib.PSROIPooling(
            s, r, spatial_scale=DET["scale"], output_dim=od,
            pooled_size=k, group_size=k), [scores, rois], (0,),
            SEED + 1822), ("data",))
    trans = rs.standard_normal((len(rois), 2, RFCN["part"], RFCN["part"])) \
        .astype(np.float32)
    out["deformable_psroi"] = _held(
        "rfcn 18b DeformablePSROIPooling (part 7, 4 x 4 samples, trans_std "
        "0.1)", card, SAMPLE_REL,
        *_card_cpu(mx, lambda s, r, t: nd.contrib.DeformablePSROIPooling(
            s, r, t, spatial_scale=DET["scale"], output_dim=od,
            pooled_size=k, group_size=k, part_size=RFCN["part"],
            sample_per_part=RFCN["samples"], trans_std=RFCN["trans_std"]),
            [scores, rois, trans], (0, 2), SEED + 1823), ("data", "trans"))
    return out


def sampling_ops(mx, card):
    """18c: FlowNetC's Correlation at (8, 256, 48, 64), displacement 20,
    stride2 2, pad 20 (441 channels); GridGenerator(warp) and
    BilinearSampler on a flow at that width; a SpatialTransformer (affine)
    on (32, 3, 224, 224); Crop with center_crop.  Each forward and
    backward against the port on the CPU (the first images of the batch:
    every op maps images independently)."""
    nd = mx.nd
    rs = np.random.RandomState(SEED + 183)
    shape = FLOW["shape"]
    a = rs.standard_normal(shape).astype(np.float32)
    b_ = rs.standard_normal(shape).astype(np.float32)
    out = {}
    corr = lambda x, y: nd.Correlation(  # noqa: E731
        x, y, max_displacement=FLOW["displacement"],
        stride2=FLOW["stride2"], pad_size=FLOW["pad"])
    got = _card_cpu(mx, corr, [a, b_], (0, 1), SEED + 1831,
                    cpu_slice=FLOW["cpu_batch"])
    check(got[0].shape[1] == (2 * (FLOW["displacement"] //
                                   FLOW["stride2"]) + 1) ** 2,
          "18c: Correlation gives %s" % (got[0].shape,))
    out["correlation"] = _held(
        "flow 18c Correlation %s max_displacement %d stride2 %d pad %d -> "
        "%d channels" % (shape, FLOW["displacement"], FLOW["stride2"],
                         FLOW["pad"], got[0].shape[1]), card, SAMPLE_REL,
        *got, ("data1", "data2"))
    flow = (rs.standard_normal((shape[0], 2) + shape[2:]) * 3.0).astype(
        np.float32)
    warp = lambda d, fl: nd.BilinearSampler(  # noqa: E731
        d, nd.GridGenerator(fl, transform_type="warp"))
    out["warp"] = _held(
        "flow 18c GridGenerator(warp) + BilinearSampler %s" % (shape,),
        card, SAMPLE_REL, *_card_cpu(mx, warp, [a, flow], (0, 1),
                                     SEED + 1832, cpu_slice=2),
        ("data", "flow"))
    imgs = rs.standard_normal(STN["shape"]).astype(np.float32)
    theta = (np.tile([0.9, 0.1, 0.05, -0.1, 0.9, -0.05], (STN["shape"][0],
                                                          1)) +
             0.05 * rs.standard_normal((STN["shape"][0], 6))).astype(
        np.float32)
    stn = lambda d, t: nd.SpatialTransformer(  # noqa: E731
        d, t, target_shape=STN["target"], transform_type="affine",
        sampler_type="bilinear")
    out["spatial_transformer"] = _held(
        "flow 18c SpatialTransformer %s affine" % (STN["shape"],), card,
        SAMPLE_REL, *_card_cpu(mx, stn, [imgs, theta], (0, 1), SEED + 1833,
                               cpu_slice=STN["cpu_batch"]),
        ("data", "loc"))
    side = STN["target"][0] * 6 // 7
    crop = lambda d: nd.Crop(d, h_w=(side, side),  # noqa: E731
                             center_crop=True)
    got = _card_cpu(mx, crop, [imgs], (0,), SEED + 1834, cpu_slice=2)
    check(np.array_equal(got[0], got[2]) and np.array_equal(
        got[1][0], got[3][0]), "18c: Crop differs from the CPU")
    out["crop"] = _held("flow 18c Crop %s -> %d x %d centred"
                        % (STN["shape"], side, side), card, 0.0, *got,
                        ("data",))
    return out


def _walk_graph(mx, qsym, values, ctx):
    """Every output of every node of ``qsym``, each op called alone
    through ``invoke`` on ``ctx`` (an int8 graph's intermediates):
    {(node, output): NDArray}."""
    from incubator_mxnet_tpu_torch.ndarray.ndarray import invoke
    vals = {k: v.as_in_context(ctx) for k, v in values.items()}
    cache, out = {}, {}
    with ctx:
        for node in qsym._topo():
            if node.is_variable():
                cache[id(node)] = [vals[node.name]]
                continue
            ins = []
            for e in node._inputs:
                got = cache[id(e._base())]
                ins.append(got[min(e._out_index or 0, len(got) - 1)])
            res = invoke(node._op, ins, dict(node._params))
            res = res if isinstance(res, (list, tuple)) else [res]
            cache[id(node)] = list(res)
            for j, r in enumerate(res):
                out[(node._name, j)] = r
    return out


def _int8_prepare(mx):
    """18d's preparation and its entropy calibration, on the current
    context (the card): the symbolic ResNet-50 v1's logits with seeded
    weights, BatchNorm's moving statistics from training-mode forwards over
    the calibration images (QUANT['bn_passes'] at momentum 0.9, so that
    every layer sees normalized activations as in a trained net and the
    logits tell the images apart), ``fold_batchnorm``, then
    ``quantize_model(calib_mode="entropy")``, whose numpy threshold search
    takes ~0.8 s a layer of one host core."""
    from incubator_mxnet_tpu_torch.contrib import quantization as qz
    nd, gpu = mx.nd, mx.gpu(0)
    quiet = logging.getLogger("chip_smoke.int8")
    quiet.setLevel(logging.WARNING)
    bsz, img = QUANT["batch"], QUANT["image"]
    pred = resnet_symbol(mx, num_classes=QUANT["classes"]).get_internals()[
        "fc1_output"]
    rs = np.random.RandomState(SEED + 184)
    args_np, aux_np = symbol_weights(np, pred, {"data": (bsz, 3, img, img)},
                                     rs)
    n_cal = QUANT["calib_batches"] * QUANT["calib_batch"]
    calib = rs.uniform(-1, 1, (n_cal, 3, img, img)).astype(np.float32)
    held = [rs.uniform(-1, 1, (bsz, 3, img, img)).astype(np.float32)
            for _ in range(QUANT["held_out"])]
    out = dict(calib=calib, held=held, quiet=quiet)
    t0 = time.perf_counter()
    with gpu:
        args = {k: nd.array(v) for k, v in args_np.items()}
        aux = {k: nd.array(v) for k, v in aux_np.items()}
        exe = pred.bind(gpu, dict(args, data=nd.array(calib)),
                        aux_states=aux, grad_req="null")
        for _ in range(QUANT["bn_passes"]):
            exe.forward(is_train=True)
        exe.outputs[0].asnumpy()
        del exe
        out["bn_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["folded"] = qz.fold_batchnorm(pred, args, aux)
        out["fold_s"] = time.perf_counter() - t0
        fsym, fargs, _ = out["folded"]
        t0 = time.perf_counter()
        out["entropy"] = qz.quantize_model(
            fsym, fargs, {}, calib_mode="entropy",
            calib_data=mx.io.NDArrayIter(data=calib,
                                         batch_size=QUANT["calib_batch"]),
            num_calib_examples=n_cal, logger=quiet)
        out["entropy_s"] = time.perf_counter() - t0
    return out


class Int8Prep(object):
    """:func:`_int8_prepare` on a host thread, started before phase 16:
    the main process then waits on the ranks of phases 16-17, so the
    threshold search costs the smoke no wall time.  ``result()`` joins it
    and raises what it raised."""

    def __init__(self, mx):
        self._out, self._error = None, None
        self._thread = threading.Thread(target=self._run, args=(mx,),
                                        name="int8-calibration", daemon=True)
        self._thread.start()

    def _run(self, mx):
        # the lowest priority for this thread alone (Linux): the ranks of
        # phases 16-17 and the main thread take the cores first
        os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 19)
        try:
            self._out = _int8_prepare(mx)
        except BaseException as exc:          # re-raised by result()
            self._error = exc

    def result(self, timeout=900):
        self._thread.join(timeout)
        check(not self._thread.is_alive(), "18d: the int8 calibration "
              "thread did not finish in %d s" % timeout)
        if self._error is not None:
            raise self._error
        return self._out


def int8_resnet(mx, card, prep):
    """18d: example/quantization/imagenet_inference.py's path on the card:
    the symbolic ResNet-50 v1 (batch 32, 224 x 224, seeded weights),
    ``fold_batchnorm``, ``quantize_model`` with ``naive`` and ``entropy``
    calibration on 4 batches of 8 (the calibration on the card, the
    default context; the entropy one from ``prep``, an :class:`Int8Prep`
    that ran beside phases 16-17); the int8 graph's census (one
    ``_contrib_quantize``, one ``_contrib_dequantize``:
    tests/test_quantization.py:352's contract); top-1 agreement of int8
    with f32 on 2 held-out batches; ms a batch in f32, bf16 and int8
    (Executor forward, host clock to synchronize, mean of QUANT['reps']
    after a warm-up); every int8 and int32 intermediate of one batch
    through the entropy-calibrated graph bit for bit the port's on the
    CPU, and the dequantized logits too."""
    import torch
    from incubator_mxnet_tpu_torch.contrib import quantization as qz
    nd, gpu = mx.nd, mx.gpu(0)
    ready = prep.result()
    calib, held, quiet = ready["calib"], ready["held"], ready["quiet"]
    fsym, fargs, faux = ready["folded"]
    check(not faux and "BatchNorm" not in {
        n._op.name for n in fsym._topo() if not n.is_variable()},
        "18d: fold_batchnorm left %s" % sorted(faux))
    bsz, img = QUANT["batch"], QUANT["image"]
    n_cal = QUANT["calib_batches"] * QUANT["calib_batch"]

    def timed(sym, values, dtype):
        exe = sym.bind(gpu, dict(values), grad_req="null")
        x = nd.array(held[0], ctx=gpu, dtype=dtype)
        exe.forward(is_train=False, data=x)[0].asnumpy()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(QUANT["reps"]):
            exe.forward(is_train=False, data=x)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / QUANT["reps"], exe

    def top1(exe, dtype):
        return [exe.forward(is_train=False, data=nd.array(
            h, ctx=gpu, dtype=dtype))[0].asnumpy().astype(
                np.float32).argmax(1) for h in held]

    zero = {"data": nd.zeros((bsz, 3, img, img), ctx=gpu)}
    with torch.backends.cudnn.flags(allow_tf32=False):
        f32_ms, f32_exe = timed(fsym, dict(fargs, **zero), "float32")
        f32_top = top1(f32_exe, "float32")
        del f32_exe
        bf = {k: v.astype("bfloat16") for k, v in fargs.items()}
        bf16_ms, bf_exe = timed(fsym, dict(bf, data=nd.zeros(
            (bsz, 3, img, img), ctx=gpu, dtype="bfloat16")), "bfloat16")
        bf16_top = top1(bf_exe, "bfloat16")
        del bf_exe, bf
    classes = len(np.unique(np.concatenate(f32_top)))
    out = dict(bn_s=ready["bn_s"], fold_s=ready["fold_s"], f32_ms=f32_ms,
               bf16_ms=bf16_ms, f32_classes=classes, modes={})
    t0 = time.perf_counter()
    naive = qz.quantize_model(
        fsym, fargs, {}, calib_mode="naive", calib_data=mx.io.NDArrayIter(
            data=calib, batch_size=QUANT["calib_batch"]),
        num_calib_examples=n_cal, logger=quiet)
    calibrated = {"naive": (naive, time.perf_counter() - t0),
                  "entropy": (ready["entropy"], ready["entropy_s"])}
    for mode in ("naive", "entropy"):
        (qsym, qargs, _), calib_s = calibrated[mode]
        census = {}
        for node in qsym._topo():
            if not node.is_variable():
                census[node._op.name] = census.get(node._op.name, 0) + 1
        check(census.get("_contrib_quantize") == 1 and
              census.get("_contrib_dequantize") == 1 and
              census.get("_contrib_quantized_elemwise_add", 0) > 0 and
              census.get("_contrib_quantized_act", 0) > 0,
              "18d %s: the int8 graph is not one chain: %s" % (mode, census))
        int8_ms, q_exe = timed(qsym, dict(qargs, **zero), "float32")
        q_top = top1(q_exe, "float32")
        del q_exe
        agree = float(np.mean([np.mean(a == b) for a, b in zip(q_top,
                                                               f32_top)]))
        bf_agree = float(np.mean([np.mean(a == b) for a, b in zip(
            bf16_top, f32_top)]))
        out["modes"][mode] = dict(calib_s=calib_s, census=census,
                                  int8_ms=int8_ms, top1_agreement=agree)
        print("int8 18d %s: census %s; calibration %.1f s on the card%s; "
              "top-1 agreement with f32 on %d held-out images (f32 predicts "
              "%d classes) %.4f (bf16 %.4f) | %s"
              % (mode, json.dumps(census, sort_keys=True), calib_s,
                 " (on a host thread beside phases 16-17)"
                 if mode == "entropy" else "", bsz * QUANT["held_out"],
                 classes, agree, bf_agree, card), flush=True)
        if mode != "entropy":
            continue
        # one batch op by op on the card and on the CPU: every code equal
        values = dict(qargs, data=nd.array(held[-1], ctx=gpu))
        card_vals = _walk_graph(mx, qsym, values, gpu)
        cpu_vals = _walk_graph(mx, qsym, values, mx.cpu())
        ints = unequal = 0
        for key, v in card_vals.items():
            g, c = v.asnumpy(), cpu_vals[key].asnumpy()
            ints += g.dtype.kind in "iu"
            unequal += not np.array_equal(g, c)
        last = (list(qsym._topo())[-1]._name, 0)
        logit_err = _max_rel(card_vals[last].asnumpy(),
                             cpu_vals[last].asnumpy())
        n_vals = len(card_vals)
        del card_vals, cpu_vals
        check(unequal == 0 and ints > 100 and logit_err == 0.0,
              "18d %s: %d of %d intermediates differ from the CPU (%d "
              "integer), logits %.3e" % (mode, unequal, n_vals, ints,
                                         logit_err))
        out["modes"][mode].update(intermediates=ints, logit_err=logit_err)
        print("int8 18d %s: %d int8/int32 intermediates of one batch of %d "
              "(every output of every node, op by op) bit for bit the "
              "CPU's, logits %.1e | %s" % (mode, ints, bsz, logit_err, card),
              flush=True)
        gc.collect()
    print("int8 18d: ResNet-50 v1 batch %d x %d x %d through the "
          "Executor, ms a batch (mean of %d): f32 %.3f, bf16 %.3f, int8 "
          "%.3f (naive) / %.3f (entropy); BatchNorm statistics %.1f s, "
          "fold_batchnorm %.2f s | %s"
          % (bsz, img, img, QUANT["reps"], f32_ms, bf16_ms,
             out["modes"]["naive"]["int8_ms"],
             out["modes"]["entropy"]["int8_ms"], out["bn_s"], out["fold_s"],
             card), flush=True)
    return out


def detection_phase(mx, card, prep):
    """Phase 18 (18a-18d; ``prep``, an :class:`Int8Prep`, 18d's
    calibration); returns their numbers."""
    import torch
    t0 = time.perf_counter()
    seconds = {}
    det = faster_rcnn(mx, card)
    seconds["18a"] = time.perf_counter() - t0
    rois, feat = det.pop("rois"), det.pop("feat")
    out = dict(faster_rcnn=det, rfcn=rfcn_heads(mx, card, rois, feat))
    seconds["18b"] = time.perf_counter() - t0 - sum(seconds.values())
    out["sampling"] = sampling_ops(mx, card)
    seconds["18c"] = time.perf_counter() - t0 - sum(seconds.values())
    del rois, feat
    gc.collect()
    torch.cuda.empty_cache()
    out["int8"] = int8_resnet(mx, card, prep)
    seconds["18d"] = time.perf_counter() - t0 - sum(seconds.values())
    out["seconds"] = time.perf_counter() - t0
    print("det: phase 18 in %.1f s (%s) | %s" % (
        out["seconds"], ", ".join("%s %.1f s" % kv for kv in seconds.items()),
        card), flush=True)
    return out



class PhaseClock(object):
    """Seconds of each phase of ``main``, printed as each one ends."""

    def __init__(self):
        self.seconds = {}
        self.label, self.t0 = "1", time.perf_counter()

    def mark(self, label):
        """End the running phase (print its seconds) and start ``label``
        (None: none)."""
        now = time.perf_counter()
        if self.label is not None:
            self.seconds[self.label] = round(now - self.t0, 1)
            print("smoke: phase %s took %.1f s" % (self.label,
                                                  now - self.t0), flush=True)
        self.label, self.t0 = label, now


def main():
    import torch
    t_run = time.perf_counter()
    clock = PhaseClock()
    # phase 1: device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke runs only on a "
             "CUDA card")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print("device: %s | torch.cuda.get_device_name(0) = %s | torch %s, CUDA %s"
          % (card, kind, torch.__version__, torch.version.cuda), flush=True)

    try:
        import incubator_mxnet_tpu_torch as mx
    except ImportError as exc:
        fail("cannot import incubator_mxnet_tpu_torch (%s); run from the root "
             "of a checkout" % exc)
    from incubator_mxnet_tpu_torch import cuda_build
    from incubator_mxnet_tpu_torch.ops.attention import (
        flash_attention, _attention_reference, split_f32,
        _split_f32_reference, _attention_f32_planes)
    from incubator_mxnet_tpu_torch.models import TransformerLM, HostXavier
    from incubator_mxnet_tpu_torch.convert import load_numpy_params
    import numpy as np

    clock.mark('2')
    # phase 2: build
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    print("build: %.1f s for %s (nvcc %s) into %s" % (
        time.perf_counter() - t0, sorted(built) or "nothing (cached)",
        " ".join(cuda_build.NVCC_FLAGS), cuda_build.BUILD_DIR), flush=True)
    t0 = time.perf_counter()
    cuda_build.load_extension("_rtc_launch")
    print("build: the rtc launcher %s (%s %s) loaded in %.2f s" % (
        cuda_build.extension_path("_rtc_launch").name, cuda_build._cc(),
        " ".join(cuda_build.CC_FLAGS), time.perf_counter() - t0), flush=True)
    for name in cuda_build.KERNELS:
        for line in cuda_build.build_log(name).splitlines():
            if any(t in line for t in ("entry function", "registers",
                                       "spill", "C7515", "C7512")):
                print("  ptxas %s: %s" % (name, line.strip()))
    flash_lib = cuda_build.lib_path("flash_attention")
    hgmma = {route: sass_count(flash_lib, "HGMMA", function)
             for route, function in HGMMA_FUNCTIONS.items()}
    print("build: HGMMA instructions in the flash_attention library's SASS "
          "by route (cuobjdump -sass): %s" % hgmma, flush=True)
    for route, count in hgmma.items():
        check(count > 0, "no HGMMA in the %s route's kernel: it does not run "
              "on the tensor cores" % route)

    clock.mark('3')
    # phase 3: each kernel against its plain version on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("kernel: plain versions run with TF32 off "
          "(torch.backends.cuda.matmul.allow_tf32 = False)", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    errs, violations = {}, {}
    for (b, h, sq, sk, d), causal in ATTENTION_CASES + WIDE_CASES + \
            WIDER_CASES:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            q = torch.randn(b, h, sq, d, generator=gen, device=dev).to(dtype)
            k = torch.randn(b, h, sk, d, generator=gen, device=dev).to(dtype)
            v = torch.randn(b, h, sk, d, generator=gen, device=dev).to(dtype)
            out = flash_attention(q, k, v, causal)
            torch.cuda.synchronize()
            ref = _attention_reference(q.float(), k.float(), v.float(), causal)
            check(out.dtype == dtype and out.shape == (b, h, sq, d),
                  "kernel output %s %s" % (out.dtype, tuple(out.shape)))
            check(bool(torch.isfinite(out).all()), "kernel output not finite")
            err = (out.float() - ref).abs().max().item()
            dname = str(dtype).replace("torch.", "")
            tol = TOLERANCE[dname]
            key = case_key((b, h, sq, sk, d), causal, dname)
            errs[key] = err
            extra = ""
            if dtype != torch.float32:
                rel = HALF_REL[dname]
                bad = int(((out.float() - ref).abs() >
                           rel * ref.abs() + BF16_ABS).sum().item())
                violations[key] = bad
                extra = ", %d of %d elements outside 2^%d·|ref| + 5e-5" % (
                    bad, ref.numel(), round(math.log2(rel)))
            print("kernel flash_attention_fwd %-34s max_abs_err %.3e "
                  "(bound %.0e)%s" % (key, err, tol, extra), flush=True)
            check(err <= tol, "flash_attention_fwd %s: max_abs_err %.3e > %.0e"
                  % (key, err, tol))
            check(not violations.get(key), "flash_attention_fwd %s: %d "
                  "elements break the per-element bound"
                  % (key, violations.get(key, 0)))
            del q, k, v, out, ref
    # mixes of dtypes: the f32 route reads each input at its own dtype
    for dtypes, (b, h, sq, sk, d) in MIXED_CASES:
        q, k, v = (torch.randn(b, h, s_, d, generator=gen, device=dev).to(
            getattr(torch, t)) for t, s_ in zip(dtypes, (sq, sk, sk)))
        before = flash_attention.mixed_launches, split_f32.launches
        out = flash_attention(q, k, v, True)
        torch.cuda.synchronize()
        ref = _attention_reference(q, k, v, True)
        check(out.dtype == q.dtype and ref.dtype == q.dtype,
              "mixed %s: output %s" % (dtypes, out.dtype))
        check((flash_attention.mixed_launches, split_f32.launches) ==
              (before[0] + 1, before[1] + 3), "mixed %s did not take the f32 "
              "route's kernels" % (dtypes,))
        err = (out.float() - ref.float()).abs().max().item()
        key = case_key((b, h, sq, sk, d), True, "+".join(dtypes))
        errs[key] = err
        print("kernel flash_attention_fwd mixed %-42s max_abs_err %.3e (bound "
              "%.0e, q's dtype out)" % (key, err, TOLERANCE[dtypes[0]]),
              flush=True)
        check(err <= TOLERANCE[dtypes[0]], "mixed %s: max_abs_err %.3e"
              % (dtypes, err))
        del q, k, v, out, ref
    # a mix of dtypes above D = 256: route B, each input at its dtype
    dtypes, (b, h, sq, sk, d) = WIDE_MIXED
    q, k, v = (torch.randn(b, h, s_, d, generator=gen, device=dev).to(
        getattr(torch, t)) for t, s_ in zip(dtypes, (sq, sk, sk)))
    before = (flash_attention.wide_launches, flash_attention.wide_f32_launches,
              split_f32.launches)
    out = flash_attention(q, k, v, True)
    torch.cuda.synchronize()
    ref = _attention_reference(q, k, v, True)
    check(out.dtype == q.dtype and (
        flash_attention.wide_launches, flash_attention.wide_f32_launches,
        split_f32.launches) == (before[0] + 1, before[1] + 1, before[2] + 3),
          "wide mixed %s: output %s, not route B" % (dtypes, out.dtype))
    err = (out.float() - ref.float()).abs().max().item()
    key = case_key((b, h, sq, sk, d), True, "+".join(dtypes))
    errs[key] = err
    print("kernel flash_attention_fwd wide mixed %-37s max_abs_err %.3e "
          "(bound %.0e, q's dtype out)" % (key, err, TOLERANCE[dtypes[0]]),
          flush=True)
    check(err <= TOLERANCE[dtypes[0]], "wide mixed %s: max_abs_err %.3e"
          % (dtypes, err))
    del q, k, v, out, ref
    # the f32 route's split pass, bit for bit, on split-heads views at the
    # small LM's shape and the serving shape
    split_errs = {}
    for (b, h, sq, sk, d), causal in ATTENTION_CASES[-2:]:
        x = torch.randn(b, sq, h, d, generator=gen, device=dev).transpose(1, 2)
        got = split_f32(x, 1.0 / math.sqrt(d))
        torch.cuda.synchronize()
        want = _split_f32_reference(x, 1.0 / math.sqrt(d))
        key = case_key((b, h, sq, sk, d), causal, "float32")
        split_errs[key] = (got.float() - want.float()).abs().max().item()
        print("kernel split_f32 %-32s planes %s, max_abs_err %.3e against "
              "the plain version (bound 0: bit for bit)"
              % (key, tuple(got.shape), split_errs[key]), flush=True)
        check(torch.equal(got, want), "split_f32 %s differs from its plain "
              "version" % key)
        del x, got, want

    # flash attention's backward against autograd through the plain version
    backward_errs = check_backward(gen, dev, card)

    clock.mark('4a')
    # phase 4a: small LMs on the card against the same weights on the CPU,
    # each route's path: its launch count zeroed just before, read after
    small_launches = {}
    rs = np.random.RandomState(SEED)
    for name, dtype, small, counter, ulps in SMALL_LMS:
        tokens = rs.randint(0, small["vocab"], (2, small["seq_len"]))
        with mx.cpu():
            cpu_net = TransformerLM(**small)
            cpu_net.initialize(HostXavier(SEED))
            cpu_net(mx.nd.array(tokens))
            weights = {n: p.data().asnumpy() for n, p in
                       cpu_net.collect_params().items()}
            cpu_net.cast(dtype)
            cpu_logits = np.asarray(cpu_net(mx.nd.array(
                tokens, dtype="int32")).asnumpy(), np.float32)
        gpu_net = TransformerLM(**small)
        load_numpy_params(gpu_net, weights, mx.gpu(0))
        gpu_net.cast(dtype)
        small_tokens = mx.nd.array(tokens, ctx=mx.gpu(0), dtype="int32")
        torch.cuda.synchronize()
        for c in WIDE_COUNTERS + ("f32_launches", "f16_launches"):
            setattr(flash_attention, c, 0)
        split_f32.launches = 0
        with mx.autograd.predict_mode():
            gpu_logits = np.asarray(gpu_net(small_tokens).asnumpy(),
                                    np.float32)
        launches = {c: getattr(flash_attention, c) for c in
                    WIDE_COUNTERS + ("f32_launches", "f16_launches")}
        launches["split_f32"] = split_f32.launches
        small_launches[name] = launches[counter]
        del small_tokens
        err = float(np.abs(gpu_logits - cpu_logits).max())
        top = float(np.abs(cpu_logits).max())
        bound = 1e-4 if ulps is None else \
            ulps * 2.0 ** (math.floor(math.log2(top)) - MANTISSA[dtype])
        print("serve: small LM %s %s %s, card vs CPU logits max_abs_err %.3e "
              "(bound %.3e%s); launches %s"
              % (name, dtype, small, err, bound, "" if ulps is None else
                 ": %d ulps at max |logits| %.4f" % (ulps, top), launches),
              flush=True)
        check(launches[counter] == small["n_layers"], "small LM %s launched "
              "%d %s for %d layers" % (name, launches[counter], counter,
                                       small["n_layers"]))
        check(launches["launches"] == small["n_layers"], "small LM %s: %d "
              "flash launches" % (name, launches["launches"]))
        wide = small["d_model"] // small["n_heads"] > 256
        check(launches["wide_launches"] == wide * small["n_layers"],
              "small LM %s: %d wide launches" % (name,
                                                 launches["wide_launches"]))
        if dtype == "float32":
            f32_routes = launches["f32_launches"] + \
                launches["wide_f32_launches"]
            check(launches["split_f32"] == 3 * f32_routes,
                  "split_f32 launched %d times for %d f32 attentions"
                  % (launches["split_f32"], f32_routes))
        check(err <= bound, "small LM %s: card and CPU disagree" % name)
        check(np.array_equal(gpu_logits[:, -1].argmax(-1),
                             cpu_logits[:, -1].argmax(-1)),
              "small LM %s: greedy tokens differ between card and CPU" % name)
        del cpu_net, gpu_net
        gc.collect()   # Blocks hold reference cycles: free the card's copy

    clock.mark('4b')
    # phase 4b: the full-width LM serving 4 requests
    cfg = LM_CONFIG
    batch, n_requests = 8, 4
    t0 = time.perf_counter()
    net = TransformerLM(**cfg)
    net.pos_embed.init = None      # HostXavier for every weight, as the bench
    net.initialize(HostXavier(SEED), ctx=mx.gpu(0))
    net.cast("bfloat16")
    # a served model keeps no gradient buffers
    net.collect_params().setattr("grad_req", "null")
    requests = [mx.nd.array(rs.randint(0, cfg["vocab"], (batch, cfg["seq_len"])),
                            ctx=mx.gpu(0), dtype="int32")
                for _ in range(n_requests)]
    with mx.autograd.predict_mode():
        net(requests[0]).wait_to_read()   # resolves the deferred shapes
    n_params = sum(int(np.prod(p.shape)) for p in
                   net.collect_params().values())
    print("serve: TransformerLM %s, %d parameters (bfloat16), built and "
          "initialized in %.1f s" % (cfg, n_params, time.perf_counter() - t0),
          flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    request_ms, answers, all_logits = [], [], []
    with mx.autograd.predict_mode():
        for tokens_nd in requests:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = net(tokens_nd)
            last = mx.nd.slice_axis(logits, axis=1, begin=-1, end=None)
            ids = mx.nd.argmax(last, axis=-1).asnumpy()
            torch.cuda.synchronize()
            request_ms.append((time.perf_counter() - t0) * 1e3)
            answers.append(ids.reshape(-1).astype(np.int64))
            all_logits.append(logits)
    launches = {"flash_attention_fwd": flash_attention.launches}
    peak = torch.cuda.max_memory_allocated()
    for logits, ids in zip(all_logits, answers):
        check(logits.shape == (batch, cfg["seq_len"], cfg["vocab"]),
              "logits shape %s" % (logits.shape,))
        check(bool(torch.isfinite(logits._data).all()), "non-finite logits")
        check(ids.shape == (batch,) and ids.min() >= 0
              and ids.max() < cfg["vocab"], "token ids out of range: %s" % ids)
    first_logits = all_logits[0]
    del all_logits
    expected = n_requests * cfg["n_layers"]
    check(launches["flash_attention_fwd"] == expected,
          "flash_attention_fwd launched %d times on the serving path, "
          "expected %d" % (launches["flash_attention_fwd"], expected))
    tokens_per_request = batch * cfg["seq_len"]
    for i, (ms, ids) in enumerate(zip(request_ms, answers)):
        print("serve: request %d: %.3f ms, %.1f tokens/s, next tokens %s | %s"
              % (i, ms, tokens_per_request / ms * 1e3, ids.tolist(), card))
    print("serve: launches on the serving path %s; peak memory allocated "
          "%d bytes | %s" % (launches, peak, card), flush=True)
    d, f = cfg["d_model"], cfg["d_ffn"]
    gemm_flops = 2.0 * tokens_per_request * (
        cfg["n_layers"] * (4 * d * d + 2 * d * f) + d * cfg["vocab"])

    def request():
        with mx.autograd.predict_mode():
            logits = net(requests[0])
            mx.nd.argmax(mx.nd.slice_axis(logits, axis=1, begin=-1, end=None),
                         axis=-1).asnumpy()

    profile_device(request, "one request",
                   {"flash_attention_fwd": "flash_fwd"}, gemm_flops,
                   card)

    clock.mark('4f')
    # phase 4f: the serving runtime on the same net (Server, CUDA graphs)
    runtime = serve_runtime(mx, net, card, rs)
    clock.mark('11b')
    # phase 11b's LM: 4b's request under mx.engine.bulk, on the same net
    bulk_lm = bulk_lm_serving(mx, card, net, requests[0], first_logits)
    clock.mark('14d')
    # phase 14d's serving half: the same request hybridized (CachedOp)
    hybrid_lm = hybrid_lm_serving(mx, card, net, requests[0], first_logits,
                                  request_ms)
    del net, requests, first_logits
    gc.collect()

    clock.mark('4e')
    # phase 4e: the same LM at head dim 512 (8 heads), route A
    wide_lm = serve_wide_lm(mx, card, rs, request_ms)

    clock.mark('4d')
    # phase 4d: training through DataParallelTrainer, small and full width
    small_train_launches = train_small_lm(mx, card)
    train = train_full_lm(mx, card)

    clock.mark('rtc')
    # phase rtc: runtime-compiled user kernels, and the head trained by them
    rtc_entries = rtc_phase(mx, dev, card)

    clock.mark('5')
    # phase 5: kernel timing at the serving shape, then at D = 256
    (b, h, sq, sk, d), causal = ATTENTION_CASES[-1]
    qkv = [torch.randn(b, h, s_, d, generator=gen, device=dev).to(
        torch.bfloat16) for s_ in (sq, sk, sk)]
    bf16 = time_flash(*qkv, causal, card, torch)
    f16 = time_flash(*(t.half() for t in qkv), causal, card, torch)
    # the f32 route on the same values in f32: the split pass, then six bf16
    # products for each f32 product on the tensor cores
    q, k, v = (t.float() for t in qkv)
    del qkv
    scale = 1.0 / math.sqrt(d)
    lib = cuda_build.load("flash_attention")
    planes = (split_f32(q, scale), split_f32(k), split_f32(v))

    def split3():
        return split_f32(q, scale), split_f32(k), split_f32(v)

    def split3_plain():
        return (_split_f32_reference(q, scale), _split_f32_reference(k),
                _split_f32_reference(v))

    f32 = time_flash(q, k, v, causal, card, torch)
    f32["split_ms"] = cuda_ms(split3, 10, torch)
    f32["attention_ms"] = cuda_ms(lambda: _attention_f32_planes(
        *planes, q.shape, causal, lib), 10, torch)
    split_plain_ms = cuda_ms(split3_plain, 5, torch)
    del q, k, v, planes
    done = f32_tensor_work(b, h, sq, sk, d, causal)
    print("timing: flash_attention_fwd f32 route at (%d,%d,%d,%d): split pass "
          "%.4f ms, attention kernel %.4f ms; the kernel does %.3e flop of "
          "tensor work (64-key tiles across the diagonal), %.1f TFLOP/s; %d "
          "HGMMA in its SASS | %s"
          % (b, h, sq, d, f32["split_ms"], f32["attention_ms"], done,
             done / f32["attention_ms"] / 1e9, hgmma["f32"], card), flush=True)
    dp = -(-d // 8) * 8
    split_bytes = 4 * b * h * (sq + 2 * sk) * d + 3 * 2 * b * h * (
        sq + 2 * sk) * dp
    split_bound = split_bytes / H100_BYTES_PER_S * 1e3
    print("timing: split_f32 (q, k, v) at (%d,%d,%d,%d) f32: kernel_ms %.4f, "
          "bound_ms %.4f (bytes: %.3e bytes at 3.35 TB/s), plain_ms %.4f, "
          "library_ms null (no one PyTorch call splits); %.1f GB/s | %s"
          % (b, h, sq, d, f32["split_ms"], split_bound, split_bytes,
             split_plain_ms, split_bytes / f32["split_ms"] / 1e6, card),
          flush=True)
    # head dim 256: two output slices a block column on both routes
    (b2, h2, sq2, sk2, d2), causal2 = WIDE_TIMING
    q, k, v = (torch.randn(b2, h2, s_, d2, generator=gen, device=dev).to(
        torch.bfloat16) for s_ in (sq2, sk2, sk2))
    wide_bf16 = time_flash(q, k, v, causal2, card, torch)
    q, k, v = (t.float() for t in (q, k, v))
    wide_f32 = time_flash(q, k, v, causal2, card, torch)
    del q, k, v
    # head dim 512: the wide routes, the serving shape's work; route A in
    # bf16 and f16, route B in f32 (split pass and attention also alone)
    (b3, h3, sq3, sk3, d3), causal3 = WIDER_TIMING
    q, k, v = (torch.randn(b3, h3, s_, d3, generator=gen, device=dev).to(
        torch.bfloat16) for s_ in (sq3, sk3, sk3))
    wider_bf16 = time_flash(q, k, v, causal3, card, torch)
    wider_f16 = time_flash(q.half(), k.half(), v.half(), causal3, card, torch)
    q, k, v = (t.float() for t in (q, k, v))
    wider_f32 = time_flash(q, k, v, causal3, card, torch)
    scale3 = 1.0 / math.sqrt(d3)
    planes = (split_f32(q, scale3), split_f32(k), split_f32(v))
    wider_f32["split_ms"] = cuda_ms(lambda: (
        split_f32(q, scale3), split_f32(k), split_f32(v)), 10, torch)
    wider_f32["attention_ms"] = cuda_ms(lambda: _attention_f32_planes(
        *planes, q.shape, causal3, lib), 10, torch)
    del q, k, v, planes
    wide_floor = {}
    for route, products, t_ in (("wide16", (1, 2), wider_bf16),
                                ("wide_f32", (6, 6), wider_f32)):
        issued = wide_tensor_work(b3, h3, sq3, sk3, d3, causal3, products)
        wide_floor[route] = issued / H100_BF16_FLOPS * 1e3
        t_["floor_ms"] = wide_floor[route]
        t_["issued_flop"] = issued
        print("timing: %s at %s: the design issues %.3e flop of tensor work "
              "(its floor %.4f ms at 989 TFLOP/s), %.1f TFLOP/s of it in "
              "%.4f ms%s | %s"
              % (route, t_["shape"], issued, wide_floor[route],
                 issued / (t_.get("attention_ms", t_["ms"])) / 1e9,
                 t_.get("attention_ms", t_["ms"]),
                 " (the attention kernel alone; split pass %.4f ms)"
                 % t_["split_ms"] if "split_ms" in t_ else "", card),
              flush=True)
    backward = time_backward(gen, dev, card)
    serving = case_key(*ATTENTION_CASES[-1], "bfloat16")

    clock.mark('6')
    # phase 6: ResNet-50 v1 (no hand kernel on its path): the small net on
    # the card against the CPU, serving at full width, bench.py's training
    resnet = dict(small=resnet_small(mx, card), serve=resnet_serve(mx, card),
                  train=resnet_train(mx, card))

    clock.mark('7')
    # phase 7: the array surface on the card against the CPU, and
    # ResNet-50 v1 trained, checkpointed, resumed and served from its file
    arrays = dict(sweep=array_sweep(mx, card),
                  checkpoint=checkpoint_cycle(mx, card))

    clock.mark('8')
    # phase 8: the rest of the zoo and of the op library (no hand kernel)
    t8 = time.perf_counter()
    zoo = dict(parity=zoo_parity(mx, card), serve=zoo_serve(mx, card),
               train=alexnet_train(mx, card), oplib=op_library(mx, card),
               random=random_draws(mx, card))
    zoo["seconds"] = time.perf_counter() - t8
    print("zoo: phase 8 in %.1f s | %s" % (zoo["seconds"], card), flush=True)

    clock.mark('9')
    # phase 9: the symbolic path and the Module API; 9c runs kernel B1 (its
    # forward and backward) through the Executor
    symbolic = symbolic_phase(mx, card)
    sym_launches = symbolic["attention"]["launches"]

    clock.mark('10')
    # phase 10: the single-card KVStore, BASELINE configs 1 and 2 through
    # common.py's wiring, the LM through a store-backed Trainer (kernel B1,
    # forward and backward), and the profiler on the card
    store = store_phase(mx, card, request_ms)
    store_launches = store["lm"]["launches"]

    clock.mark('11')
    # phase 11: engine bulking (recorded segments replayed as CUDA graphs;
    # B1's forward and backward inside them) and the rest of the
    # Module/Symbol surface
    bulk = bulk_phase(mx, card)
    bulk["lm_serving"] = bulk_lm
    bulk_rows = bulk["training"]["lm"]["trace"]["rows"]

    clock.mark('12')
    # phase 12: the data plane feeding the card (RecordIO, ImageRecordIter
    # into ResNet-50, gluon.data, a DataLoader into the LM: kernel B1)
    data = data_phase(mx, card, resnet["train"],
                      store["config2"]["resnet50 Gluon"])
    data_launches = data["lm"]["launches"]

    clock.mark('13')
    # phase 13: the RNN family (the fused RNN op over cuDNN, CTCLoss,
    # gluon.rnn, mx.rnn); 13f runs kernel B1 under an LSTM encoder
    rnn = rnn_phase(mx, card)
    rnn_launches = rnn["encoder"]["launches"]

    clock.mark('14')
    # phase 14: Gluon hybridize() as CUDA graphs (benchmark_score.py's
    # path, train_imagenet.py --gluon-trainer, word_lm.py's loop, the LM:
    # kernel B1's forward and backward inside the graphs) and the SSD ops
    hybrid = hybrid_phase(mx, card)
    hybrid["lm_serving"] = hybrid_lm
    hybrid_launches = hybrid["lm_train"]["launches"]
    hybrid_rows = hybrid["lm_train"]["trace_rows"]
    hybrid_release(mx)

    clock.mark('15')
    # phase 15: sparse storage and BASELINE config 5 (no hand kernel), then
    # C11's contract: a failed capture leaves mx.random usable
    sparse = sparse_phase(mx, card)

    # 18d's preparation and entropy calibration on a host thread, while
    # the main process waits on the ranks of phases 16-17
    int8_prep = Int8Prep(mx)

    clock.mark('16')
    # phase 16: several devices and processes: the dist stores across two
    # ranks on the card and one rank a card (16a), BASELINE config 2 across
    # two ranks (16b), the LM across two ranks through DataParallelTrainer
    # over worker_mesh() (16c: kernel B1's forward and backward on every
    # rank), several contexts in one process (16d), 16e on 2+ cards
    dist = dist_phase(mx, card, train["peak_memory_bytes"], train["n_params"])
    dist_launches = dist["lm"]["launches"]

    clock.mark('17')
    # phase 17: the rest of item 7 across two ranks sharing the card: the
    # axis collectives (17a), ring attention in the LM over {"dp": 1, "sp":
    # 2} (17b: its witness runs kernel B1's bf16 forward and backward),
    # PipelineTrainer over {"pp": 2} (17c: B1's f32 route in every stage),
    # ExpertParallelMoE over {"ep": 2} (17d), 17e on 2+ cards
    par = parallel_phase(mx, card, train["peak_memory_bytes"])
    par_launches = par["launches"]

    # phase 18: the rest of the op registry (no hand kernel): Faster R-CNN
    # with ROIPooling and ROIAlign (18a), R-FCN with deformable convolution
    # (18b), FlowNetC's correlation and the samplers (18c), a calibrated
    # INT8 ResNet-50 (18d)
    clock.mark("18")
    det = detection_phase(mx, card, int8_prep)
    clock.mark(None)

    def entry(name, source, design, launches_, err, t,
              replaces="incubator_mxnet_tpu/ops/attention.py:56", **extra):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    design=design, launches=launches_, max_abs_err=err,
                    ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                    bound_by=t["bound_by"], library_ms=t["library_ms"],
                    shape=t["shape"], **extra)

    wide_key = case_key(*WIDE_CASES[-1], "%s")
    wider_key = case_key(*WIDER_CASES[-1], "%s")
    build_log = cuda_build.build_log("flash_attention")
    print("serve 4f: summary " + json.dumps(runtime, default=str),
          flush=True)
    print("train: summary " + json.dumps({
        k_: v_ for k_, v_ in train.items() if k_ != "losses"}), flush=True)
    print("backward: " + json.dumps(dict(backward, max_abs_err_cases=
                                         backward_errs)), flush=True)
    print("resnet: summary " + json.dumps(resnet, default=str), flush=True)
    print("arrays: summary " + json.dumps(arrays, default=str), flush=True)
    print("zoo: summary " + json.dumps(zoo, default=str), flush=True)
    print("sym: summary " + json.dumps(symbolic, default=str), flush=True)
    print("kv: summary " + json.dumps(store, default=str), flush=True)
    print("bulk: summary " + json.dumps(bulk, default=str), flush=True)
    print("data: summary " + json.dumps(data, default=str), flush=True)
    print("rnn: summary " + json.dumps(rnn, default=str), flush=True)
    print("hybrid: summary " + json.dumps(dict(hybrid, card=card),
                                          default=str), flush=True)
    print("sparse: summary " + json.dumps(dict(sparse, card=card),
                                          default=str), flush=True)
    print("dist: summary " + json.dumps(dict(dist, card=card), default=str),
          flush=True)
    print("par: summary " + json.dumps(dict(par, card=card), default=str),
          flush=True)
    print("det: summary " + json.dumps(dict(det, card=card), default=str),
          flush=True)
    print("smoke: seconds by phase " + json.dumps(clock.seconds),
          flush=True)
    print("smoke: the whole run took %.1f s | %s"
          % (time.perf_counter() - t_run, card), flush=True)
    print(json.dumps({"kernels": [
        entry("flash_attention_fwd", BF16_SOURCE, FLASH_DESIGN,
              launches["flash_attention_fwd"] + sym_launches["launches"] +
              store_launches["launches"] + data_launches["launches"] +
              rnn_launches["launches"] + hybrid_launches["launches"] +
              dist_launches["launches"] + par_launches["bf16_fwd"],
              errs[serving], bf16,
              parallel_ring_witness_launches=par_launches["bf16_fwd"],
              dist_trainer_launches_by_rank=[
                  r["launches"]["flash_attention_fwd"]
                  for r in dist["lm"]["ranks"]],
              symbolic_executor_launches=sym_launches["launches"],
              store_trainer_launches=store_launches["launches"],
              data_loader_trainer_launches=data_launches["launches"],
              rnn_encoder_trainer_launches=rnn_launches["launches"],
              hybridized_trainer_launches=hybrid_launches["launches"],
              hybridized_replay_trace_launches=dict(
                  lm_request=hybrid_lm["flash_fwd_rows"],
                  lm_train_step=hybrid_rows["flash_fwd_sm90"]),
              max_abs_err_cases=errs, half_violations_cases=violations,
              tflops=bf16["tflops"],
              training_launches=train["launches"]["flash_attention_fwd"],
              serving_runtime_launches=runtime["launches"],
              serving_runtime_replay8_trace_launches=runtime["replay8"][
                  "flash_fwd_sm90_kernel"],
              bulk_replay_trace_launches=dict(
                  lm_request=bulk_lm["trace"]["flash_fwd_sm90_kernel"],
                  lm_train_step=bulk_rows["flash_fwd_sm90"]),
              training_steps=TRAIN_STEPS,
              small_training_launches=small_train_launches),
        entry("flash_attention_fwd_f16", BF16_SOURCE, F16_DESIGN,
              small_launches["f16_d128"],
              errs[case_key(*ATTENTION_CASES[-1], "float16")], f16,
              tflops=f16["tflops"]),
        entry("flash_attention_fwd_f32", F32_SOURCE, F32_DESIGN,
              small_launches["f32_d16"] + par_launches["f32_fwd"],
              errs[case_key(*ATTENTION_CASES[-1], "float32")], f32,
              split_ms=f32["split_ms"], attention_ms=f32["attention_ms"],
              bound_terms_ms=f32["bound_terms_ms"], hgmma=hgmma["f32"],
              pipeline_launches_by_rank=par_launches["f32_fwd_by_rank"]),
        entry("split_f32", F32_SOURCE, "the f32 route's split pass (q, k, "
              "v: three calls)", 3 * small_launches["f32_d16"] +
              par_launches["split"],
              split_errs[case_key(*ATTENTION_CASES[-1], "float32")],
              dict(ms=f32["split_ms"], plain_ms=split_plain_ms,
                   bound_ms=split_bound, bound_by="bytes", library_ms=None,
                   shape=f32["shape"])),
        entry("flash_attention_fwd_d256", BF16_SOURCE, WIDE_DESIGN,
              small_launches["bf16_d256"], errs[wide_key % "bfloat16"],
              wide_bf16, tflops=wide_bf16["tflops"]),
        entry("flash_attention_fwd_f32_d256", F32_SOURCE, F32_WIDE_DESIGN,
              small_launches["f32_d256"], errs[wide_key % "float32"],
              wide_f32, bound_terms_ms=wide_f32["bound_terms_ms"]),
        entry("flash_attention_fwd_wide16", WIDER_SOURCE, WIDE16_DESIGN,
              wide_lm["launches"], errs[wider_key % "bfloat16"],
              wider_bf16, tflops=wider_bf16["tflops"],
              floor_ms=wider_bf16["floor_ms"],
              hgmma={r: hgmma[r] for r in ("wide16_bf16", "wide16_f16")},
              ptxas=ptxas_resources(build_log, "flash_fwd_wide16_kernel"),
              small_lm_launches=small_launches["bf16_d320"],
              d512_request_ms=wide_lm["request_ms"],
              f16=dict(ms=wider_f16["ms"], plain_ms=wider_f16["plain_ms"],
                       bound_ms=wider_f16["bound_ms"],
                       library_ms=wider_f16["library_ms"],
                       max_abs_err=errs[wider_key % "float16"])),
        entry("flash_attention_fwd_wide_f32", WIDER_SOURCE, WIDE_F32_DESIGN,
              small_launches["f32_d320"], errs[wider_key % "float32"],
              wider_f32, floor_ms=wider_f32["floor_ms"],
              split_ms=wider_f32["split_ms"],
              attention_ms=wider_f32["attention_ms"],
              bound_terms_ms=wider_f32["bound_terms_ms"],
              hgmma=hgmma["wide_f32"],
              ptxas=ptxas_resources(build_log, "flash_fwd_wide_f32_kernel")),
        entry("flash_attention_bwd", BWD_SOURCE, BWD_DESIGN,
              train["launches"]["flash_attention_bwd"] +
              sym_launches["backward_kernel_launches"] +
              store_launches["backward_kernel_launches"] +
              data_launches["backward_kernel_launches"] +
              rnn_launches["backward_kernel_launches"] +
              hybrid_launches["backward_kernel_launches"] +
              dist_launches["backward_kernel_launches"] +
              par_launches["bf16_bwd"],
              max(backward_errs[case_key(*BACKWARD_CASES[0][:2], "bfloat16")
                                + "_" + n] for n in ("dq", "dk", "dv")),
              backward, replaces="incubator_mxnet_tpu/ops/attention.py:168",
              training_steps=TRAIN_STEPS,
              symbolic_executor_launches=sym_launches[
                  "backward_kernel_launches"],
              store_trainer_launches=store_launches[
                  "backward_kernel_launches"],
              data_loader_trainer_launches=data_launches[
                  "backward_kernel_launches"],
              rnn_encoder_trainer_launches=rnn_launches[
                  "backward_kernel_launches"],
              hybridized_trainer_launches=hybrid_launches[
                  "backward_kernel_launches"],
              dist_trainer_launches_by_rank=[
                  r["launches"]["flash_attention_bwd"]
                  for r in dist["lm"]["ranks"]],
              parallel_ring_witness_launches=par_launches["bf16_bwd"],
              bulk_replay_trace_launches=dict(
                  lm_train_step=bulk_rows["flash_bwd"]),
              hybridized_replay_trace_launches=dict(
                  lm_train_step=hybrid_rows["flash_bwd"]),
              get_symbol_executor_launches=bulk["get_symbol"]["launches"][
                  "backward_kernel_launches"], torch_ops_ms=backward[
                  "torch_ops_ms"], f16_ms=backward["f16_ms"],
              kernel_us=backward["kernel_us"],
              f16_plain_ms=backward["f16_plain_ms"],
              f16_library_ms=backward["f16_library_ms"],
              bound_terms_ms=backward["bound_terms_ms"],
              tflops=backward["tflops"], hgmma={
                  r: n for r, n in hgmma.items() if r.startswith("bwd")}),
    ] + rtc_entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
