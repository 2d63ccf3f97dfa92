#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — the card's name and power limit (nvidia-smi's own line is
   printed as is, too);
2. build — every kernel under paddle_tpu_torch/csrc/ built with nvcc for
   sm_90a (ptxas's register and spill report, kernel by kernel);
3. kernel cases — the ragged paged attention kernel against its plain
   PyTorch version on the card at the serving path's shapes (BERT-base
   heads: Hq = 12, D = 64, page 16, 32 pages per sequence; and a decode
   over contexts of 1,024 to 2,000 slots, 128 pages per sequence): max abs
   error <= 2e-5 with rtol 1e-4, and exact zeros on inactive rows. Each
   case gives the kernel's, the plain version's and one PyTorch call's time
   (`scaled_dot_product_attention` on the pre-gathered dense K/V, a
   yardstick only) beside the least time the card could take;
4. main paths — the serving engine at BERT-base widths (vocab 30522,
   embed 768, 12 layers, 12 heads, ffn 3072, max_seq 512; random weights
   from seed 0) serves a synthetic multi-tenant trace with system
   prompts, once over bfloat16 pages and once over int8 pages, every
   bucket captured as a CUDA graph by `warmup` and replayed. The launch
   counts are set to 0 just before each path and read just after: every
   dispatch must have launched the kernel once per layer (a replay
   counts the launches its capture recorded). Then one
   prefill and three decode buckets run through `forward` with the kernel
   and with the plain version on equal pages: last-row logits within
   1e-3, next tokens equal wherever the top-two margin exceeds that;
5. flash cases — the flash attention forward, dK/dV and dQ kernels
   against their plain PyTorch versions on the card, on the inputs the
   wrapper gives them: (a) the trainer's shape (B 8, H 12, S 512, D 64,
   bf16, causal), with q, k, v and the cotangent laid out as the trainer
   makes them (views of one [B, S, 3, H, D] tensor and of a [B, S, H, D]
   one, read in place: no copy inside the timed calls), (b) BERT's (S 128,
   fp32, a padding key bias), (c) S 100 (fp32, causal, the padding path),
   (d) fp32 with a key bias and dropout 0.1 at a fixed seed, (e) bf16 at
   the trainer's widths with a key bias and dropout 0.1, (f) the fluid
   BERT path's long leg (B 2, H 12, S 4096, D 64, bf16, key bias,
   dropout 0.1, q, k, v as views of one [B, S, 3H] projection), (g) the
   same in float16 (phase 17 leg b's), then the mesh trainer's shapes.
   Tolerances: fp32 forward 2e-5 and gradients 3e-4, bf16 2e-2, float16
   5e-3. Each kernel's time beside its plain version's, the least time
   the card could take, its rate on the attending pairs (TFLOP/s), its
   design (bf16 and fp16 on tensor cores, "wgmma bf16" and "wgmma f16";
   fp32 "simt"), and `scaled_dot_product_attention`'s
   forward and backward as a yardstick; then the dropout kernel against
   its plain version at fluid BERT leg a's shapes (the hidden dropout,
   bf16 [256, 128, 768], and the attention probabilities, fp32 [256, 12,
   128, 128], p 0.1): the Mask exactly, Out within one unit in the last
   place, beside its bytes bound and `torch.native_dropout`;
6. the training path — `parallel.transformer` at the default `SPMDConfig`
   (vocab 32000, d_model 768, 12 heads, d_ff 3072, seq 512, 12 layers,
   bf16 compute, remat; random weights from seed 0), batch 8: one warm-up
   step, then 5 timed steps with finite losses; the launch counts, set to
   0 just before them, must be 2L forward and L each of dK/dV and dQ per
   step, every one of them on tensor cores. Then one step with the
   kernels and one with the plain attention on the same params and batch:
   loss within 1e-2 relative and every gradient leaf within 2e-2 relative
   in norm;
7. the fluid static graph — the MNIST MLP of tests/test_mnist_mlp.py
   (784-128-64-10, batch 64; synthetic data from seed 0, the startup
   program's random_seed 1) through
   `fluid.layers` -> `optimizer.minimize` -> `Executor.run`: the startup
   program on `fluid.Executor()` with no place (every persistable must
   land on cuda:0), then 30 SGD steps on the card and the same steps on
   the CPU from the same numpy params (losses within 1e-4 relative,
   accuracies equal, the card's last loss below half its first), then 20
   Adam steps the same way; the median step time (host clock, ending in
   a synchronize) beside the card's name and power limit. This path runs
   none of the kernels: MNIST has no attention. Phases 7 to 10 run with
   `FLAGS_cuda_graphs` on, as a user does: each block's first step is
   eager, its second is captured, the rest replay;
8. fluid BERT — BERT-base pretraining (vocab 30522, hidden 768, 12
   layers, 12 heads, FFN 3072; random weights from the startup program's
   random_seed 1, bench.py's synthetic masked-LM feed) through
   `bert_pretrain_loss` (scan encoder) -> `mixed_precision.decorate`
   (bf16, O2) over Adam -> `minimize` -> `fuse_optimizer_ops` ->
   `Executor.run`, as bench.py builds it. Leg a: S 128, batch 256, no
   remat, composite attention. Leg b: S 4096, batch 2, scan remat, the
   three flash kernels with the key bias and dropout in them. Each leg
   runs 2 warm-up and 5 timed steps: every loss finite, the first within
   0.5 of ln(30522) + ln(2); tokens/s, the median step ms, peak memory,
   MFU, the busy share of one profiled step; the flash and dropout
   launch counts, zeroed just before the timed steps, exact (leg a no
   flash, 1 + 3L dropouts a step; leg b 2L forward, L dK/dV and L dQ a
   step, all on tensor cores, and 1 + 4L dropouts); the step captured.
   Leg c: the
   S 4096 program at 2 layers, one step with the kernels and one with
   their plain version from the same params: loss within 1e-2 and every
   gradient within 2e-2 relative in norm;
9. fluid ResNet50 — ImageNet training as bench.py builds it
   (`build_resnet_train_program`: `models/resnet.py resnet(depth=50)`
   with `scan_stages`, 224 x 224 NCHW images, 1000 classes,
   softmax_with_cross_entropy then mean, `mixed_precision.decorate`
   (bf16, O2, no loss scaling) over Momentum(0.1, 0.9), `minimize`,
   `fuse_optimizer_ops`, random_seed 11; the feed from RandomState(0)).
   Leg a: batch 128, 2 warm-up and 10 timed steps: every loss finite;
   the median step ms, images/s, MFU on the model FLOPs counted from the
   program's conv and fc shapes, peak memory, the busy share and kernels
   of one profiled step, and the launches of the five attention kernels
   (none: the path has no attention). Leg b: the port on the card
   against the port on the CPU, fp32 (TF32 off), AMP off, 32 x 32,
   batch 4, 10 classes, Momentum(3e-3), from one startup state with each
   residual branch's last BN scale set to 0 (zero-gamma: from the plain
   random start the model is chaotic under batch statistics, PERF.md):
   3 steps and then one step of the program's for_test clone (running
   statistics, no update); losses and every running statistic within
   1e-3 relative;
10. fluid Transformer — Transformer-big WMT en-de
   (`TransformerConfig.big`: d_model 1024, 16 heads, FFN 4096, 6 + 6
   layers, dropout 0.1, vocabularies of 32,000; random weights from the
   programs' random_seed 13) through the unrolled
   `build_transformer_train` (label smoothing 0.1, soft-label
   cross-entropy, the masked mean, noam with warmup 4000 over
   Adam(0.9, 0.997, 1e-9)) under bf16 AMP O2 with `fuse_optimizer_ops`.
   Leg a: batch 32 at source and target length 128 (4,096 target tokens;
   per-sentence lengths 16-128, ids from RandomState(0)), 2 warm-up and
   10 timed steps: every loss finite; the median step ms, target
   tokens/s, MFU on the program's `mul` and `matmul` FLOPs, peak memory,
   the busy share and kernels of one profiled step. Leg b:
   `beam_search_decode` over leg a's scope, the 32 sentences, beam 4,
   alpha 0.6, at most 128 new tokens: shapes [32, 4, 129] and [32, 4],
   bos first, the beams sorted by score; decode ms, steps and generated
   tokens/s. Neither leg launches any of the five attention kernels (the
   counts are zeroed before each and read after). Leg c: the card
   against the CPU in fp32, 2 + 2 layers at the same widths, S 32, batch
   4, dropout 0, from one startup state: 3 noam-Adam steps' losses within
   1e-4 relative, then beam 4 over 16 steps: sequences equal (but where
   the CPU's top-k margin fell below 1e-5 at some step) and scores within
   1e-4; and the `while_loop` and cond-in-while programs equal, each run
   eagerly by design (their `while` reads its condition on the host) and
   naming that reason;
11. graphs — each captured path against the same steps run eagerly
   (`FLAGS_cuda_graphs` off) from the same start state: MNIST SGD and
   Adam (8 steps), BERT legs a and b, ResNet50 leg a and Transformer
   leg a (5 steps each), each eager run made three times. Wherever the
   eager runs are bit-equal (a fetch or a final persistable), the graph
   run must equal them bit for bit; elsewhere (atomics in a backward
   kernel) it must lie within twice the largest difference between two
   eager runs, and the leg says which case held. Each leg reports
   graph (replay) and eager median step ms, the busy share and kernels
   of one profiled replay, the capture ms, the graph pool bytes and the
   wrapper-counted launches of a replay. The bf16 serving trace runs
   with captured and with eager buckets: equal token streams, tokens/s
   of each, one profiled decode replay, capture ms and pool bytes. Each
   leg prints its own line (`graphs_leg`), the phase a closing one;
12. fleet_dp — fleet collective data parallelism (BASELINE config 5),
   each leg on a line of its own (`fleet_dp_leg`), the phase a closing
   one with its seconds. Every rank is a process that
   `paddle_tpu_torch.distributed.spawn` starts with the launcher's
   contract; a rank that fails (or outlives the phase's time limit) fails
   the phase, and every process is gone after. Leg a: phase 9 leg a's
   ResNet50 (224 x 224, 1000 classes, scan_stages, bf16 AMP O2 over
   Momentum(0.1, 0.9), random_seed 11) wrapped in
   `fleet.distributed_optimizer`, `minimize`, `fuse_optimizer_ops`, on 2
   ranks that share the one card over gloo (NCCL needs a card per rank),
   each taking Paddle's per-card batch of 128 from the global batch of
   256, with the sharded weight update (the default: ZeRO-1, fleet's
   gradient all-reduces lowered to bucketed reduce-scatters, the
   Momentum velocities and AMP masters held as 1/N slices, the params
   all-gathered): 2 warm-up and 2 timed steps, eager (gloo collectives
   run on the host, so the block is not captured, and the leg checks
   that it says so); every gathered loss finite, every parameter and
   optimizer state (read at its logical shape) bit-equal across the
   ranks after the steps (running statistics stay per rank); per-rank
   median step ms, total images/s, the host ms, calls and MB a step of
   the collectives, the optimizer state a rank holds, peak memory per
   rank, beside phase 9 leg a's single-process figures. Leg b: ResNet50 at 32 x 32,
   10 classes, fp32, zero-gamma, batch 4 a rank, fleet DP, 2 ranks over
   gloo on the card and 2 on the CPU from one startup state, once
   without and once with `sync_batch_norm`: 3 steps' gathered losses and
   rank 0's running statistics within 1e-3 relative, replicas
   bit-equal (the four spawns of the two runs and leg c's run together:
   these legs check numbers, not times). Leg c: an NCCL world of one
   rank; a data-parallel program
   of every single-input collective op runs eagerly, then captured and
   replayed (bit-equal to the eager run, which equals the ops' identity
   outside a world); then the MNIST MLP trains 8 steps through
   `with_data_parallel`, captured, with losses bit-equal to the plain
   program's, and again under float16 AMP O2 with dynamic loss scaling
   (the found-inf count's all-reduce in the eager step, then captured);
13. spmd_mesh — the SPMD trainer (`parallel.transformer` with a
   `parallel.env.Mesh`) over ranks that share the card over gloo
   (`distributed.spawn`; NCCL needs a card a rank), each leg on a line of
   its own (`spmd_mesh_leg`), the phase a closing one. Leg a: the
   default `SPMDConfig` (phase 6's widths, bf16, remat, random weights
   from seed 0) cut to 2 of its 12 layers (`SPMD_LAYERS`), Megatron
   sequence parallelism on dp1 pp2 tp2 (4 ranks),
   4 microbatches of the global batch of 8 (GPipe), 1 warm-up and 1
   timed step: the loss finite and the same on every rank; the flash
   launches a rank, zeroed just before the timed steps, exactly
   2 x 1 layer x 4 microbatches forward (remat) and 1 x 4 each of dK/dV
   and dQ a step, all on tensor cores at [8, 6, 512, 64]; per-rank median
   step ms, tokens/s, the host ms a step spent in collectives (gloo
   stages through the host), peak memory per rank, beside phase 6's
   single-process figures. Leg b: Ulysses on dp1 pp1 tp2 (2 ranks),
   the same widths and checks (2 layers a rank, flash at [8, 6, 512,
   64] after the all-to-all). Leg c: the CPU tests' widths (vocab 64,
   d_model 32, 4 heads, d_ff 64, seq 16, 4 layers, 4 microbatches, fp32)
   with the kernels on, on dp1 pp2 tp2 (Megatron) and dp2 pp1 tp2
   (Ulysses; the two meshes' ranks run together), from the params of one
   process on the card: 3 steps' losses within 2e-4 and the step-0 gradients, gathered, within 5e-4
   of that process's, with the kernels and with `attn_impl="reference"`
   alike; a rank that fails fails the phase;
14. zero — the sharded weight update (ZeRO-1) against the replicated
   one, on 2 gloo ranks sharing the card (`distributed.spawn`), each
   rank running both from the same start state for 1 warm-up and 1
   timed step, each leg on a line of its own (`zero_leg`), the phase a
   closing one. Leg a:
   BASELINE config 5 (phase 12 leg a's fleet ResNet50, 128 a rank):
   losses and every persistable at its logical shape bit-equal on
   against off. Leg b: fluid BERT-base pretraining at S 4096 x 2, cut to
   2 of its 12 layers (1 a rank; phase 8 leg b's program: bf16 AMP O2,
   fused Adam, scan remat,
   the flash kernels with the key bias and dropout) through
   `with_data_parallel`: the fp32 masters and the moments sharded, the
   flash and dropout kernels' launch counts (zeroed just before the
   steps) above 0 in both runs, losses and state within 1e-2 (relative,
   the state in norm) where not bit-equal. Both legs: the state
   sharded on (a rank holds about half the logical optimizer-state
   bytes, as `CompiledBlock.info()` reports) and not off, the replicas
   bit-equal; per rank the optimizer-state bytes (logical and held),
   the collectives' calls, MB and host ms a step, the step ms, peak
   memory;
15. hybrid — data parallelism over a (dcn 2, ici 2) world of 4 gloo
   ranks sharing the card (``FLAGS_tpu_dcn_replicas`` 2: gradient sums
   within the pod, then across pods; the sharded state laid out within
   the pod; each bucket's exchange launched from the backward) with
   ``FLAGS_cudnn_deterministic`` on, each rank running every variant from
   one start state for 1 warm-up and 1 timed step, each leg on a line
   of its own (`hybrid_leg`), the phase a closing one. Leg a: BASELINE
   config 5 (phase 12 leg a's fleet ResNet50) at 32 a rank (cut from 128
   so that four ranks fit on the one card): the hybrid sharded update
   bit-equal to the hybrid replicated one (losses and every persistable
   at its logical shape); against the flat sharded update on 4 ranks
   (itself against the flat replicated one), the first step's exchanged
   gradients, read as the Momentum velocities after it, within one bf16
   unit (2^-8) relative in norm (the gradients are bf16, and the
   pods-first sum rounds twice where the flat one rounds once; the
   losses after the later steps are reported beside); a rank holding
   about half the logical optimizer state, and
   `Executor.overlap_report` showing bucket 0 launched with backward
   left to run. Leg b: fluid BERT-base pretraining at S 4096 x
   1 a rank (phase 14 leg b's program, 2 layers) on the hybrid sharded
   update
   against the flat one: losses and state within 1e-2 (each kind of
   state, masters, first and second moments and the rest, relative in
   norm as one vector), the flash and dropout kernels' launch counts
   (zeroed just before the timed steps) above 0. Per rank the step ms,
   the collectives' calls, MB and host ms a step split by axis (ici,
   dcn, the world), the optimizer-state bytes held, peak memory;
16. ckpt — checkpoints and model io with ``FLAGS_cudnn_deterministic``
   on, each leg on a line of its own (`ckpt_leg`), the phase a closing
   one with every leg's bit-equality and leg c's agreed steps. Leg a:
   phase 9 leg a's config 5 (batch 128) in one process, captured: 3
   steps, `checkpoint.save_checkpoint`, then an `AsyncCheckpointer` save
   of the same state with the next 3 steps running meanwhile (losses A);
   the checkpoint loaded into the live scope of the captured block and
   into a fresh executor and scope, each followed by the same 3 steps:
   both bit-equal to A, and the async checkpoint bit-equal to the
   synchronous one. Leg b: phase 8 leg b's BERT-base S 4096 x 2 (the
   flash kernels on every layer, launched: their counts zeroed before
   the leg and read after) with both dropout probabilities 0 (the step
   seed is not saved): `fluid.save` and `fluid.load` of the whole
   program state around 2 steps, bit-equal to the uninterrupted ones;
   `save_inference_model` and `load_inference_model`: the pruned
   program's loss bit-equal to the for_test clone's on the same feed.
   Then one spawn of 2 gloo ranks sharing the card runs legs c and d.
   Leg c: config 5 through fleet with the sharded update (128 a rank):
   `save_persistables` from both ranks (rank 0 writes each var at its
   logical shape; every file bit-equal to `read_logical`), a fresh
   executor and scope loaded from the files repeating the next 2 steps
   bit for bit, and two numbered checkpoints a rank with rank 1's newest
   truncated: `load_checkpoint` under ``PADDLE_CKPT_AGREE=1`` takes the
   older step on both ranks. Leg d: the default `SPMDConfig` (Megatron)
   on a tp2 mesh: `ShardedCheckpointManager.save` at step 2, the step
   restored into the same layout repeating the next 2 steps bit for
   bit, and restored whole in this process: every param bit-equal to
   the tp2 params gathered at the save. Each leg reports the MB written
   and the save, load (and `save_async`) ms beside the card's name and
   power limit;
17. fluid_bert_fp16_lamb — BERT pretraining as Paddle trains it on a
   GPU: phase 8's BERT-base (vocab 30522, hidden 768, 12 layers, 12
   heads, FFN 3072, the startup's random_seed 1, bench.py's masked-LM
   feed) through `bert_pretrain_loss` -> `LambOptimizer(1e-4,
   lamb_weight_decay=0.01, exclude_from_weight_decay_fn=` the reference's
   exclusions`, grad_clip=GradientClipByGlobalNorm(1.0))` ->
   `mixed_precision.decorate(amp_dtype="float16", amp_level="O2",
   init_loss_scaling=2^15, use_dynamic_loss_scaling=True)` -> `minimize`
   -> `fuse_optimizer_ops` -> `Executor.run`, captured. Legs a (S 128 x
   256, composite attention) and b (S 4096 x 2, scan remat, the three
   flash kernels in float16 with the key bias and dropout 0.1): phase
   8's checks and figures, the loss scale, its good and bad counts and
   the skipped steps; leg b's launches, zeroed just before the timed
   steps, exactly 2L forward, L dK/dV and L dQ a step, every one a
   float16 launch on tensor cores ("wgmma f16"), and no float16 CUDA
   tensor reaching the plain attention (its functions watched through
   the whole leg); leg a 1 + 3L dropouts a step. Leg c: the S 4096
   program at 2 layers, captured, `decr_every_n_nan_or_inf` 1 and
   `incr_every_n_steps` 2: after two clean steps the scale is set to
   2^40 and one replayed step must leave every param, master and moment
   bit-equal, multiply the scale by `decr_ratio` and fetch a global norm
   of 0; then from a scale of 1 two clean replays double it; the same
   steps run eagerly from the same start are bit-equal (losses and every
   persistable). Leg d: that program, one step with the kernels and one
   with their plain version from the same params: loss within 1e-2 and
   every unscaled gradient within 2e-2 relative in norm. Leg e: the card
   against the CPU in fp32 with AMP off, LAMB with the clip at
   BertConfig.tiny's widths (2 layers, hidden 64), S 32, batch 4,
   dropout 0, 3 steps: losses and the fetched global norm within 1e-4
   relative. Each leg prints its own line (`fluid_bert_fp16_lamb_leg`);
18. bert_large_batch — large-batch BERT pretraining as Paddle's fleet
   runs it, with ``FLAGS_cudnn_deterministic`` on: BERT-base (the unrolled
   encoder, its 12 layer outputs collected by `checkpoints_out`), LAMB
   (1e-4, wd 0.01, the reference's exclusions) with
   `GradientClipByGlobalNorm(1.0)`, through `fleet.distributed_optimizer`
   at one worker with the `recompute` (checkpoints: the layer outputs),
   `gradient_merge` (k 4, avg), `lamb` and `amp` (bf16 O2) knobs. Leg a:
   S 4096, micro-batch 8, dropout 0.1 (4 x 8 x 4096 = 131,072 tokens an
   optimizer step), 12 micro-steps (3 windows; the accumulating and the
   applying step each captured at its second run): the median
   accumulating micro-step ms, the applying step's, tokens/s, peak memory
   and the flash and dropout launches over the last window (exactly 2L
   forward with the recompute, L dK/dV and L dQ a micro-step, all on
   tensor cores, and 2(1 + 2L) dropouts), the busy share of one profiled
   micro-step. Leg b, at 4 layers: recompute against none on one step
   (loss and every gradient bit-equal, the forward kernel launched once
   more a layer, the peak lower); k 4 x micro-batch 2 against k 1 x
   batch 8, dropout 0 (the accumulating steps leave params, masters and
   moments bit-equal, the params after the window within 1e-2 relative
   in norm); captured against eager over 8 micro-steps with a
   `fluid.save` after step 6 and steps 7-8 repeated after a `fluid.load`
   (losses and every persistable bit-equal); and the flash kernels under
   recompute against their plain version on one step (loss within 1e-2,
   gradients 2e-2 in norm). Leg c: the MNIST MLP under Lookahead (k 5)
   over the local DGC momentum with an EMA and a ModelAverage, captured
   on the card against the CPU from the same params, with both
   averages' apply()/restore() between replays (in place: the scope's
   tensors stay the captured step's buffers; restored bit for bit):
   losses, applied and final params within 1e-4. Leg d: the slice's 75
   new op types at the CPU tests' shapes (tests/torch_tensor_cases.py),
   the card against the CPU (fp32 within 1e-5, integers exact; random
   types by shape, dtype, repetition and moments). Each leg prints a
   line (`bert_large_batch_leg`), the phase a closing one;
19. book — the Paddle book's programs (tests/torch_book_programs.py), with
   ``FLAGS_cudnn_deterministic`` on. Leg a: understand_sentiment's
   stacked_lstm_net at the book's widths (embedding 128 over a vocabulary
   of 5,000, fc and dynamic_lstm size 512, hidden 128, 3 layers, the
   second reversed; max over time, fc(2, softmax), cross_entropy,
   Adagrad 0.002), T 256, batch 128, every row full: 7 steps captured
   (the first eager, the second captured, then replays) and 3 eager from
   one state; the captured and eager step ms (median), the capture's ms
   and pool, tokens/s, the busy share and kernels of one profiled
   replay, peak memory. Leg b, T 32 (depth and length only): leg a's
   program captured against eager over 6 steps (losses and every
   persistable bit-equal); with ragged Length, the card against the CPU
   (2 steps' losses and every gradient within 1e-4 relative in norm);
   machine_translation's dynamic_gru program likewise; one
   bidirectional cudnn_lstm layer over a ragged SequenceLength (outputs
   and gradients within 1e-4). Leg c: fit_a_line, recognize_digits and
   recommender_system 20 steps captured against the CPU (losses within
   1e-4 relative; recognize_digits' falls). Leg d: the 122 cases of
   tests/torch_nn_cases.py (the slice's 81 op types), forward and
   gradients, the card against the CPU within 1e-4 x (1 + max |value|),
   integers exact; the cuDNN types and pool3d twice, bit-equal. Each leg
   prints a line (`book_leg`), the phase a closing one. The path runs
   none of the hand-written kernels;
20. sequences — Paddle's sequence ops, with ``FLAGS_cudnn_deterministic``
   on. Leg a: the book's convolution_net (tests/torch_book_programs.py:
   an embedding of 128 over a vocabulary of 5,000, two
   `nets.sequence_conv_pool` of 512 filters, sizes 3 and 4, tanh and
   sqrt pooling, fc(2, softmax), cross_entropy, Adagrad 0.002) with a
   streaming `auc` over 4,096 buckets, T 256, batch 128, every row full:
   7 steps captured and 3 eager from one state; step ms, tokens/s, the
   capture's ms and pool, busy share and kernels of one profiled replay,
   peak memory, the AUC after the last step. Leg b, T 32: leg a's
   program captured against eager over 6 steps (losses, accuracies, AUCs
   and every persistable, the AUC's histograms among them, bit-equal); a
   ragged classifier (tests/torch_seq_cases.py `ragged_net`: its rows
   padded by `fluid.create_lod_tensor(...).to_padded()`, every
   `sequence_pool` type, `sequence_softmax` and `sequence_reverse` with
   Length) card against CPU, 2 steps' losses and every gradient within
   1e-5 relative in norm. Leg c: the cases of tests/torch_seq_cases.py
   (the slice's 58 op types; `run_program` on a Program of its own),
   card against CPU within 1e-4 x (1 + max |value|), integers exact;
   every capturable case captured with its gradients, one replay
   bit-equal to eager; every host-side case run in a one-op program on
   the card, its block eager with the reason naming the op;
   `sequence_scatter` and `SelectedRows.merge` at 65,536 rows twice,
   bit-equal. Each leg prints a line (`sequences_leg`), the phase a
   closing one. The path runs none of the hand-written kernels;
21. detection — YOLOv3, ResNet50 under QAT, the small programs and the
   op cases of tests/torch_det_quant_cases.py (PERF.md §4);
22. detection pipeline — with ``FLAGS_cudnn_deterministic`` on, float32.
   Leg a: Mask R-CNN R50-FPN at 800 x 1344 (tests/torch_detection_programs
   .py MASK_RCNN_FULL, random weights from the startup), 5 training steps
   (eager: the proposal and label ops run on the host) and one
   evaluation pass (box_decoder_and_assign, multiclass_nms,
   detection_map): step ms, the host seconds of each host type a step,
   busy share and kernels of one profiled step, peak memory, the
   evaluation's ms and mAP, the blocks' modes and reasons. Leg b: SSD
   MobileNet-v1 at 300 (SSD_FULL, 1,917 priors), the same. Leg c: the
   tiny programs of the CPU tests, card against CPU (losses and
   gradients within DET_TOL), their input-exact host ops' outputs the
   reference's recorded ones (HOST_OUTPUT_DIGESTS). Leg d: every case of
   tests/torch_det_extra_cases.py card against CPU within 1e-4 x (1 +
   max |value|), integers exact; the capturable ones captured with their
   gradients and bit-equal to eager; the gathering types twice, bit-equal;
   each host case a one-op program (its block eager, named) whose
   outputs are the reference's recorded ones (HOST_DIGESTS). The phase
   runs none of the hand-written kernels;
23. kernels — one line listing every ported kernel with its launches on
   its main path and its times (RPA at the decode bucket, with its prefill
   case's times beside; the flash kernels also with their design and
   TFLOP/s, their launches and times on the fluid BERT path, their
   launches a rank on the mesh trainer and their launches on phase 18 leg
   a's last window; the float16 flash kernels with their launches on
   phase 17 leg b and their times at phase 5 case g; the dropout kernel
   with its launches on fluid BERT leg a and on phase 18 leg a); launches
   made by graph replays count;
24. the last line, ``{"ok": true, "device": {...}}``, printed only when
   every phase passed. Any failure exits non-zero.

It needs one card and exits non-zero without one, or without the
repository around it. The data-parallel and mesh phases add no kernel:
their collectives are NCCL's and gloo's (the reference's are XLA's).
"""
import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
FP32_FLOPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
ATOL, RTOL = 2e-5, 1e-4     # kernel vs plain, float32 arithmetic
LOGIT_TOL = 1e-3            # serving forward, kernel vs plain attention

BERT_BASE = dict(vocab=30522, embed=768, layers=12, heads=12, kv_heads=12,
                 head_dim=64, ffn=3072, max_seq=512)
POOL = dict(num_pages=512, page_size=16, max_seqs=8)
BF16_TRACE = dict(n_requests=8, n_tenants=2, vocab=30522,
                  prompt_range=(32, 256), output_range=(16, 32),
                  system_prompt_range=(16, 48))
INT8_TRACE = dict(n_requests=4, n_tenants=2, seed=1, vocab=30522,
                  prompt_range=(32, 256), output_range=(8, 16),
                  system_prompt_range=(16, 48))
DEV = "cuda"
RPA_SOURCE = "paddle_tpu_torch/csrc/ragged_paged_attention.cu"
RPA_TPU = "paddle_tpu/ops/pallas/ragged_paged_attention.py"
FLASH_SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
FLASH_TPU = "paddle_tpu/ops/pallas/flash_attention.py"
DROPOUT_SOURCE = "paddle_tpu_torch/csrc/dropout.cu"
DROPOUT_REF = "paddle_tpu/ops/nn_ops.py:421"
#: dtype -> (forward tol, gradient tol), atol = rtol
FLASH_TOL = {"float32": (2e-5, 3e-4), "bfloat16": (2e-2, 2e-2),
             "float16": (5e-3, 5e-3)}
FLASH_CASES = [
    dict(name="trainer_bf16_causal", B=8, H=12, S=512, D=64,
         dtype="bfloat16", causal=True, bias=False, p=0.0, qkv_views=True),
    dict(name="bert_f32_bias", B=8, H=12, S=128, D=64, dtype="float32",
         causal=False, bias=True, p=0.0),
    dict(name="unaligned_f32_causal", B=4, H=12, S=100, D=64,
         dtype="float32", causal=True, bias=False, p=0.0),
    dict(name="dropout_f32_bias", B=8, H=12, S=128, D=64, dtype="float32",
         causal=False, bias=True, p=0.1),
    dict(name="bias_dropout_bf16", B=8, H=12, S=512, D=64, dtype="bfloat16",
         causal=False, bias=True, p=0.1),
    dict(name="bert_s4096_bf16", B=2, H=12, S=4096, D=64, dtype="bfloat16",
         causal=False, bias=True, p=0.1, qkv_views=True),
    # phase 17 leg b's: float16 BERT at S 4096
    dict(name="bert_s4096_f16", B=2, H=12, S=4096, D=64, dtype="float16",
         causal=False, bias=True, p=0.1, qkv_views=True),
    # the mesh trainer's: Megatron at tp 2 (6 heads, views of the rank's
    # qkv), Ulysses at tp 2 and 4 (6 and 3 heads after the all-to-all)
    dict(name="megatron_tp2_bf16_causal", B=8, H=6, S=512, D=64,
         dtype="bfloat16", causal=True, bias=False, p=0.0, qkv_views=True),
    dict(name="ulysses_tp2_bf16_causal", B=8, H=6, S=512, D=64,
         dtype="bfloat16", causal=True, bias=False, p=0.0, bshd=True),
    dict(name="ulysses_tp4_bf16_causal", B=8, H=3, S=512, D=64,
         dtype="bfloat16", causal=True, bias=False, p=0.0, bshd=True),
]
FLASH_SEED = 1234
#: the dropout kernel at fluid BERT leg a's shapes (S 128, batch 256): the
#: hidden dropout under bf16 AMP and the composite attention's dropout on
#: its float32 probabilities
DROPOUT_CASES = [
    dict(name="bert_hidden_bf16", shape=[256, 128, 768], dtype="bfloat16",
         p=0.1),
    dict(name="bert_probs_f32", shape=[256, 12, 128, 128], dtype="float32",
         p=0.1),
]
DROPOUT_SEED = 4321 << 20
TRAIN_BATCH, TRAIN_STEPS = 8, 5
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-2, 2e-2
FLUID_BATCH, FLUID_SGD_STEPS, FLUID_ADAM_STEPS = 64, 30, 20
FLUID_SEED = 0               # synthetic data
FLUID_INIT_SEED = 1          # the startup program's random_seed
FLUID_LOSS_RTOL = 1e-4      # fluid MLP losses, card vs CPU (fp32, no TF32)
#: fluid BERT legs (bench.py's BATCH/SEQ_LEN and LONGCTX_BATCH/_SEQ; scan
#: remat on where bench.py turns it on)
BERT_FLUID_LEGS = [
    dict(name="a_s128", seq=128, batch=256, remat=False),
    dict(name="b_s4096", seq=4096, batch=2, remat=True),
]
BERT_WARMUP, BERT_STEPS = 2, 5
BERT_INIT_SEED = 1           # the startup and main programs' random_seed
BERT_LR = 1e-4
BERT_LOSS0_TOL = 0.5         # first loss against ln(vocab) + ln(2)
BERT_CHECK = dict(seq=4096, batch=2, layers=2)
#: kernels vs plain flash on one bf16 step: the tensor-core kernels round
#: P and dS to bf16 before their second product, so gradients differ by
#: about one bf16 step (2^-8) relative; 2e-2 in norm, as the trainer's
#: check in phase 6
BERT_CHECK_LOSS_RTOL, BERT_CHECK_GRAD_RTOL = 1e-2, 2e-2
#: fluid ResNet50 (bench.py `_resnet_feed` and
#: `build_resnet_train_program`): leg a at full size, leg b card vs CPU
RESNET_A = dict(img=224, classes=1000, batch=128, lr=0.1, amp=True)
RESNET_B = dict(img=32, classes=10, batch=4, lr=3e-3, amp=False)
RESNET_WARMUP, RESNET_STEPS, RESNET_B_STEPS = 2, 10, 3
RESNET_INIT_SEED = 11        # the startup and main programs' random_seed
RESNET_B_RTOL = 1e-3         # leg b: losses and running stats, card vs CPU
#: fluid Transformer (models/transformer.py TransformerConfig.big): leg a
#: trains at Paddle's per-card batch of its Transformer-big recipe in
#: tokens (32 x 128 target tokens), leg b decodes leg a's scope, leg c
#: holds the card against the CPU in fp32
TRANSFORMER_A = dict(batch=32, seq=128)
TRANSFORMER_B = dict(sentences=32, beam=4, max_out_len=128, bos=0, eos=1,
                     alpha=0.6)
#: leg c: a sentence whose CPU top-k margin falls below `margin` at some
#: step may pick other beams on the card (a tie in float32); only its
#: sequence check is waived
TRANSFORMER_C = dict(layers=2, seq=32, batch=4, steps=3, beam=4,
                     max_out_len=16, tol=1e-4, margin=1e-5)
TRANSFORMER_WARMUP_STEPS, TRANSFORMER_STEPS = 2, 10
TRANSFORMER_INIT_SEED = 13   # the startup and main programs' random_seed
TRANSFORMER_WARMUP = 4000    # noam warmup steps
TRANSFORMER_LR = 2.0         # noam's scale (Paddle's Transformer recipe)
#: phase 11: steps a leg runs with capture on (the first eager, the second
#: captured, the rest replays), then eagerly GRAPH_EAGER_RUNS times: the
#: eager runs' spread is the yardstick where they are not bit-equal
GRAPH_STEPS = {"mnist": 8, "large": 5}
GRAPH_EAGER_RUNS = 3
#: phase 12, fleet data parallelism. Leg a: BASELINE config 5 at phase 9
#: leg a's size, Paddle's per-card batch of 128 on each of 2 ranks that
#: share the card over gloo (the global batch 256); leg b: the card
#: against the CPU, 2 ranks each, batch 4 a rank (phase 9 leg b's batch:
#: at 2 a rank the last stage normalizes 2 values a channel, and the card
#: and the CPU drifted 9.8e-3 apart in the third loss); leg c: NCCL at
#: world 1
FLEET_A = dict(img=224, classes=1000, batch=256, lr=0.1)
FLEET_WARMUP, FLEET_STEPS = 2, 2
FLEET_B = dict(img=32, classes=10, batch=8, lr=3e-3, steps=3)
FLEET_B_RTOL = 1e-3          # phase 9 leg b's tolerance
FLEET_C_STEPS = 8
#: the legacy and extra single-input collective ops of leg c's program
FLEET_C_OPS = [("c_reduce_sum", {"root_id": 0}), ("alltoall", {}),
               ("c_concat", {"nranks": 1}), ("c_split", {"nranks": 1}),
               ("c_identity", {}), ("allreduce", {"reduce_type": 0}),
               ("broadcast", {"root": 0})]
FLEET_TIMEOUT_S = 420        # a spawn's ranks, joined
#: phase 13, the SPMD trainer over a mesh of ranks sharing the card over
#: gloo. Legs a and b: the default SPMDConfig, 4 microbatches of the
#: global batch of 8, 1 warm-up and 1 timed step; leg a Megatron on
#: dp1 pp2 tp2 (4 ranks), leg b Ulysses on dp1 pp1 tp2 (2 ranks)
SPMD_A = dict(dp=1, pp=2, tp=2, sp_mode="megatron")
SPMD_B = dict(dp=1, pp=1, tp=2, sp_mode="ulysses")
SPMD_MICRO, SPMD_BATCH, SPMD_WARMUP, SPMD_STEPS = 4, 8, 1, 1
#: legs a and b run the default SPMDConfig's widths at 2 of its 12 layers
#: (a gloo mesh step at 12 layers took 10-14 s on one card)
SPMD_LAYERS = 2
#: phase 5's case at the shapes and layouts each leg gives the flash
#: kernels ([8, 6, 512, 64] bf16 causal)
SPMD_FLASH_CASES = {"a": "megatron_tp2_bf16_causal",
                    "b": "ulysses_tp2_bf16_causal"}
#: leg c: the CPU tests' widths with the kernels on, against one process
#: on the card from the same params (seed 5, demo_batch(cfg, 8, seed=5))
SPMD_C_KW = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, seq_len=16,
                 n_layers=4, n_micro=4, dtype="float32", remat=False,
                 use_flash=True)
SPMD_C_MESHES = [dict(dp=1, pp=2, tp=2, sp_mode="megatron"),
                 dict(dp=2, pp=1, tp=2, sp_mode="ulysses")]
SPMD_C_STEPS, SPMD_C_SEED = 3, 5
SPMD_C_LOSS_RTOL, SPMD_C_GRAD_RTOL, SPMD_C_GRAD_ATOL = 2e-4, 5e-4, 1e-6
#: phase 14, the sharded weight update (ZeRO-1) on 2 gloo ranks sharing
#: the card, on against off from one state: leg a BASELINE config 5 (phase
#: 12 leg a's ResNet50, 128 a rank), leg b fluid BERT-base at S 4096 x 2
#: (1 a rank; phase 8 leg b's program: bf16 AMP O2, fused Adam, scan
#: remat, the flash kernels); leg b's tolerance, losses and the state
#: relative in norm, where its runs are not bit-equal
ZERO_WARMUP, ZERO_STEPS = 1, 1
#: leg b at 2 of BERT-base's 12 layers
ZERO_B = dict(seq=4096, batch=2, layers=2)
ZERO_B_RTOL = 1e-2
#: phase 15, the hybrid (dcn 2, ici 2) world of 4 gloo ranks sharing the
#: card: leg a config 5 at 32 a rank (the global batch 128; four ranks of
#: 128 would not fit on one card), leg b phase 14 leg b's BERT at 1 a
#: rank; the variants each leg runs from one start state (pods, sharded
#: update). Leg a's bound against the flat world: its bf16 gradients are
#: summed within the pod and then across pods, each stage rounding to
#: bf16, where the flat sum rounds once; the first step's exchanged
#: gradients, read as the Momentum velocities after it, must lie within
#: one bf16 unit (2^-8) of the flat run's, relative in norm. The losses
#: after later steps are reported, not bounded: ResNet50 from its random
#: start amplifies a one-unit gradient difference (ROADMAP Queue 3)
HYBRID_RANKS, HYBRID_DCN = 4, 2
HYBRID_A = dict(FLEET_A, batch=32 * HYBRID_RANKS)
HYBRID_B = dict(seq=4096, batch=HYBRID_RANKS, layers=2)
HYBRID_VARIANTS = {"a": [("hier_zero", HYBRID_DCN, True),
                         ("hier_replicated", HYBRID_DCN, False),
                         ("flat_zero", 1, True),
                         ("flat_replicated", 1, False)],
                   "b": [("hier_zero", HYBRID_DCN, True),
                         ("flat_zero", 1, True)]}
HYBRID_A_GRAD_RTOL = 2.0 ** -8
#: phase 17, BERT pretraining as Paddle trains it on a GPU: float16 AMP O2
#: with dynamic loss scaling (Paddle's defaults but the scale's floor:
#: init 2^15, x2 every 1000 clean steps, x0.8 after 2 overflows), LAMB with
#: the reference's exclusions from weight decay, global-norm clipping at
#: 1.0. Legs a and b: phase 8's cells; leg c the S 4096 program at 2 layers
#: captured, an overflow forced at a scale of 2^40 (float16 ends at 65504)
#: and the growth from a scale of 1 every 2 clean steps; leg d kernels vs
#: plain at 2 layers (phase 8 leg c's bounds); leg e the card against the
#: CPU in fp32 with AMP off at BertConfig.tiny's widths
F16_LEGS = [dict(name="a_s128", seq=128, batch=256, remat=False),
            dict(name="b_s4096", seq=4096, batch=2, remat=True)]
F16_SCALE = dict(init_loss_scaling=2.0 ** 15, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.8)
F16_LAMB = dict(lr=1e-4, weight_decay=0.01, clip=1.0)
F16_C = dict(seq=4096, batch=2, layers=2, overflow=2.0 ** 40,
             incr_every_n_steps=2, decr_every_n_nan_or_inf=1)
F16_E = dict(seq=32, batch=4, steps=3, rtol=1e-4)
#: phase 16, checkpoints and model io with FLAGS_cudnn_deterministic on:
#: leg a config 5 in one process, 3 steps between saves and loads; leg b
#: BERT-base S 4096 x 2 with dropout 0 (the step seed is not saved:
#: a resumed run repeats the uninterrupted one only without dropout), 2
#: steps; leg c config 5 on 2 gloo ranks with the sharded update, 2
#: steps; leg d the default SPMDConfig on tp2 (2 gloo ranks), 2 steps
CKPT_STEPS = 3
CKPT_B = dict(seq=4096, batch=2)
CKPT_B_STEPS = CKPT_C_STEPS = CKPT_D_STEPS = 2
#: phase 18, large-batch BERT as Paddle's fleet runs it: leg a BERT-base at
#: S 4096, micro-batch 8, k 4 (131,072 tokens an optimizer step, BERT's
#: 256 x 512), recompute at every layer output, LAMB (wd 0.01, the
#: reference's exclusions) with global-norm clipping at 1.0, bf16 AMP O2;
#: leg b its gates at 4 layers (params within bf16's rtol after a window);
#: leg c the MNIST MLP under Lookahead, DGC, EMA and ModelAverage, card
#: against CPU; leg d the new op types, card against CPU
LB_K = 4
LB_A = dict(seq=4096, batch=8)
LB_B = dict(layers=4, rtol=1e-2)
LB_LAMB = dict(lr=1e-4, weight_decay=0.01, clip=1.0)
LB_C_STEPS, LB_C_RTOL = 10, 1e-4
LB_D_DRAWS = 200000
#: phase 19, the Paddle book's programs (tests/torch_book_programs.py) with
#: FLAGS_cudnn_deterministic on: leg a understand_sentiment's stacked LSTM at
#: the book's widths (embedding 128, fc and LSTM 512, 3 layers, a
#: vocabulary of 5,000), T 256 (IMDB reviews run to a few hundred words),
#: batch 128, every row full, captured (the first step eager, the second
#: captured, then replays) and eager from one state; leg b its gates at T
#: 32 (captured against eager bit for bit; ragged rows, machine_translation's
#: GRUs and a bidirectional cudnn_lstm layer, the card against the CPU);
#: leg c fit_a_line, recognize_digits and recommender_system card against
#: CPU; leg d the slice's op cases card against CPU, and captured against
#: eager
BOOK_A = dict(seq=256, batch=128, graph_steps=7, eager_steps=3)
BOOK_B = dict(seq=32, batch=128, steps=6, rtol=1e-4,
              translation=dict(seq=32, src_vocab=10000, trg_vocab=10000,
                               hid=256), translation_batch=32)
BOOK_C = dict(steps=20, batch=64, rtol=1e-4)
BOOK_D_RTOL = 1e-4
#: leg d: the cuDNN types run twice on the card, bit-equal
BOOK_D_REPEAT = {"conv2d_transpose", "conv3d", "conv3d_transpose", "pool3d"}
#: phase 20, Paddle's sequence ops: leg a the book's convolution_net at its
#: widths (tests/torch_book_programs.py CONV_SENTIMENT), T 256 as phase
#: 19's, batch 128; leg b its gates at T 32 (and the ragged classifier of
#: tests/torch_seq_cases.py within SEQ_B's rtol of the CPU); leg c the
#: slice's op cases card against CPU within SEQ_C_RTOL, and the ordered
#: sums at SEQ_C_ROWS rows
SEQ_A = dict(seq=256, batch=128, graph_steps=7, eager_steps=3)
SEQ_B = dict(seq=32, batch=128, steps=6, rtol=1e-5, ragged_steps=2)
SEQ_C_RTOL = 1e-4
SEQ_C_ROWS = 65536
#: phase 21, detection and quantization (tests/torch_detection_programs.py)
#: with FLAGS_cudnn_deterministic on: leg a YOLOv3 DarkNet-53 at
#: PaddleDetection's widths (608 x 608, 80 classes, 50 ground-truth rows),
#: batch 8, captured (the first step eager, the second captured, then
#: replays) and eager from one state, then its inference program once on a
#: batch of 8; leg b ResNet50 under slim's QAT pass at 224 x 224, batch 128
#: (phase 9's), the same, with the scales' drift, the plain network's
#: captured step beside it, the freeze, a save and a load; leg c the
#: tests' tiny YOLOv3, small QAT ResNet and window-max MLP captured
#: against eager and eager against eager over DET_C_STEPS steps, bit for
#: bit, and card against CPU within the CPU tests' tolerances (dp.TOL);
#: leg d the slice's op cases card against CPU within DET_D_RTOL and
#: captured against eager, the NMS cases as one-op programs
DET_A = dict(batch=8, graph_steps=7, eager_steps=3, infer_batch=8)
DET_B = dict(depth=50, img=224, classes=1000, batch=128, graph_steps=7,
             eager_steps=3, plain_steps=4)
DET_C_STEPS = 6
DET_D_RTOL = 1e-4
#: leg d: the types whose gradients gather (a fixed-order sum), run twice
DET_D_REPEAT = {"yolov3_loss", "roi_align", "linear_interp",
                "bilinear_interp", "trilinear_interp", "bicubic_interp",
                "nearest_interp"}
# phase 22: Mask R-CNN R50-FPN at 800 x 1344 and SSD MobileNet-v1 at 300
# (tests/torch_detection_programs.py MASK_RCNN_FULL, SSD_FULL), one image
# a step: training steps, then one evaluation pass; leg d's tolerance
DX_STEPS = 5
DX_D_RTOL = 1e-4
# leg d's types whose gradients gather: each case run twice, bit-equal
DX_D_REPEAT = {"deformable_conv", "deformable_conv_v1",
               "deformable_psroi_pooling", "roi_perspective_transform",
               "bilateral_slice", "conv_shift", "hsigmoid", "target_assign",
               "box_decoder_and_assign", "prroi_pool", "psroi_pool",
               "unpool", "max_pool3d_with_index", "sample_logits",
               "sampled_softmax_with_cross_entropy", "random_crop"}


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line, with `t_s`, the seconds since the script started."""
    print(json.dumps(dict(obj, t_s=round(time.perf_counter() - _T0, 1))),
          flush=True)


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


# -- phase 1 ------------------------------------------------------------------

def nvidia_smi_line():
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    check(smi.returncode == 0 and line, "nvidia-smi failed: %s"
          % smi.stderr.strip())
    return line


def phase_device(torch):
    line = nvidia_smi_line()
    print(line, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": line,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return name


# -- phase 2 ------------------------------------------------------------------

def phase_build():
    from paddle_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    built = _build.build()
    report = {name: ptxas_report(b["log"]) for name, b in built.items()}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "sources": sorted(built), "ptxas": report})


def kernel_label(mangled):
    """The kernel's name in a mangled symbol (each name is preceded by its
    length), with its template arguments as mangled."""
    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group())):  # the length is a suffix of the run
            name = mangled[m.end():m.end() + int(m.group()[i:])]
            rest = mangled[m.end() + len(name):]
            if name.endswith("kernel") and rest.startswith("I"):
                return "%s<%s>" % (name, rest[1:rest.find("EEv")])
            if name.endswith("kernel") and rest.startswith("E"):
                return name
    return mangled


def ptxas_report(log):
    """{kernel: "N registers; spills"} from nvcc's -Xptxas -v output. A
    kernel is named by its mangled core, e.g. ``fa_fwd_tc_kernel<Li1E>``
    (template arguments as mangled: ``Li64E`` is 64, ``f`` float)."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = kernel_label(ln.split()[-1])
            out[name] = ""
        elif name is not None and ("spill" in ln or "registers" in ln):
            out[name] = (out[name] + "; " + ln.strip().replace(
                "ptxas info    : ", "")).strip("; ")
    return out


# -- phase 3 ------------------------------------------------------------------

class Timer:
    """Median device time of one call, in ms, with the L2 cache flushed
    before each launch (the serving step streams 400+ MB of weights
    between two attention calls, so the kernel finds its pages cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)

    def __call__(self, fn, reps):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for start, end in ev:
            self.flush.zero_()
            # keep the card busy while the host enqueues fn, so that the
            # timed interval holds no host gap
            torch.cuda._sleep(2_000_000)
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in ev)
        return times[len(times) // 2]


def make_case(torch, name, seed, S, Q, Hq, Hkv, ctx, qlen, dtype, pps=32,
              pool=POOL["num_pages"]):
    """Seeded inputs at the serving path's page geometry: each sequence's
    live pages drawn at random from the pool (512 pages, 32 a sequence,
    as the engine's)."""
    D, page, P = 64, POOL["page_size"], pool
    gen = torch.Generator().manual_seed(seed)
    kf = torch.randn((P, page, Hkv, D), generator=gen)
    vf = torch.randn((P, page, Hkv, D), generator=gen)
    perm = torch.randperm(P, generator=gen)
    tables = torch.zeros((S, pps), dtype=torch.int32)
    n = 0
    for s in range(S):
        live = -(-int(ctx[s]) // page)
        tables[s, :live] = perm[n:n + live].int()
        n += live
    kw = {}
    if dtype == torch.int8:
        ks = kf.abs().amax(dim=(2, 3)).clamp_min(1e-9) / 127.0
        vs = vf.abs().amax(dim=(2, 3)).clamp_min(1e-9) / 127.0
        kp = torch.round(kf / ks[:, :, None, None]).clamp(-127, 127)
        vp = torch.round(vf / vs[:, :, None, None]).clamp(-127, 127)
        kw = dict(k_scale=ks.to(DEV), v_scale=vs.to(DEV))
    else:
        kp, vp = kf, vf
    args = (torch.randn((S, Q, Hq, D), generator=gen).to(DEV),
            kp.to(dtype).to(DEV), vp.to(dtype).to(DEV), tables.to(DEV),
            torch.tensor(ctx, dtype=torch.int32).to(DEV),
            torch.tensor(qlen, dtype=torch.int32).to(DEV))
    return dict(name=name, args=args, kw=kw, ctx=list(ctx), qlen=list(qlen))


def bound_of(torch, case):
    """Least time for this call: the bytes it must move (q read, output
    written, the live pages' K/V and scales read once) over the memory
    rate, and its float32 operations over the fp32 peak; the larger."""
    q, kp, _, tables, _, _ = case["args"]
    S, Q, Hq, D = q.shape
    page, Hkv = kp.shape[1], kp.shape[2]
    nbytes = 2 * q.numel() * 4 + tables.numel() * 4 + 2 * S * 4
    flops = 0
    for c, ql in zip(case["ctx"], case["qlen"]):
        if ql == 0:
            continue
        live = -(-c // page)
        nbytes += 2 * live * page * Hkv * D * kp.element_size()
        if case["kw"]:
            nbytes += 2 * live * page * 4
        keys = sum(c - ql + i + 1 for i in range(ql))
        flops += 4 * keys * Hq * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def library_call(torch, case):
    """scaled_dot_product_attention over the pre-gathered dense K/V with
    the same mask (gather excluded from the timing)."""
    import torch.nn.functional as F

    q, kp, vp, tables, ctx, qlen = case["args"]
    S, Q, Hq, D = q.shape
    Hkv = kp.shape[2]
    kvmax = tables.shape[1] * kp.shape[1]
    k = kp[tables.long()].reshape(S, kvmax, Hkv, D).float()
    v = vp[tables.long()].reshape(S, kvmax, Hkv, D).float()
    if case["kw"]:
        k = k * case["kw"]["k_scale"][tables.long()].reshape(S, kvmax)[
            :, :, None, None]
        v = v * case["kw"]["v_scale"][tables.long()].reshape(S, kvmax)[
            :, :, None, None]
    k = k.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2).contiguous()
    v = v.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2).contiguous()
    qd = q.transpose(1, 2).contiguous()
    kpos = torch.arange(kvmax, device=DEV)[None, None, None, :]
    rows = torch.arange(Q, device=DEV)[None, None, :, None]
    qpos = (ctx - qlen).long()[:, None, None, None] + rows
    mask = (kpos <= qpos) & (rows < qlen.long()[:, None, None, None])
    return lambda: F.scaled_dot_product_attention(qd, k, v, attn_mask=mask)


def phase_kernel_cases(torch, timer):
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    gen = torch.Generator().manual_seed(1234)

    def ragged(n, lo, hi):
        return torch.randint(lo, hi + 1, (n,), generator=gen).tolist()

    bf16, i8 = torch.bfloat16, torch.int8
    dec_ctx = ragged(8, 48, 512)
    pre_q = ragged(4, 16, 64)
    pre_ctx = [q + p for q, p in zip(pre_q, ragged(4, 0, 448))]
    inactive = [0 if s in (5, 7) else 1 for s in range(8)]
    cases = [
        make_case(torch, "decode_bf16", 1, 8, 1, 12, 12, dec_ctx, [1] * 8,
                  bf16),
        make_case(torch, "prefill_bf16", 2, 4, 64, 12, 12, pre_ctx, pre_q,
                  bf16),
        make_case(torch, "decode_gqa_bf16", 3, 8, 1, 12, 4, dec_ctx,
                  [1] * 8, bf16),
        make_case(torch, "decode_int8", 4, 8, 1, 12, 12, dec_ctx, [1] * 8,
                  i8),
        make_case(torch, "prefill_int8", 5, 4, 64, 12, 12, pre_ctx, pre_q,
                  i8),
        make_case(torch, "decode_inactive_bf16", 6, 8, 1, 12, 12,
                  [c * a for c, a in zip(dec_ctx, inactive)], inactive,
                  bf16),
        make_case(torch, "decode_f32", 7, 8, 1, 12, 12, dec_ctx, [1] * 8,
                  torch.float32),
        make_case(torch, "decode_f16", 8, 8, 1, 12, 12, dec_ctx, [1] * 8,
                  torch.float16),
        make_case(torch, "decode_long_bf16", 9, 8, 1, 12, 12,
                  ragged(8, 1024, 2000), [1] * 8, bf16, pps=128, pool=1024),
    ]
    results = {}
    for case in cases:
        args, kw = case["args"], case["kw"]
        got = rpa(*args, impl="kernel", **kw)
        torch.cuda.synchronize()
        want = rpa(*args, impl="reference", **kw)
        err = float((got - want).abs().max())
        zeros = all(not bool(got[s, ql:].any()) and
                    not bool(want[s, ql:].any())
                    for s, ql in enumerate(case["qlen"]))
        ok = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL)) and \
            zeros and bool(torch.isfinite(got).all())
        bound, by, nbytes, flops = bound_of(torch, case)
        res = {
            "phase": "kernel_case", "case": case["name"],
            "shape": list(args[0].shape), "pages": str(args[1].dtype),
            "kv_heads": args[1].shape[2], "ctx": case["ctx"],
            "q_lens": case["qlen"], "max_abs_err": err,
            "inactive_rows_zero": zeros, "ok": ok,
            "ms": timer(lambda: rpa(*args, impl="kernel", **kw), 50),
            "plain_ms": timer(
                lambda: rpa(*args, impl="reference", **kw), 10),
            "library_ms": timer(library_call(torch, case), 20),
            "bound_ms": bound, "bound_by": by, "bytes": nbytes,
            "flops": flops}
        emit(res)
        check(ok, "kernel case %s disagrees with the plain version "
              "(max abs err %g)" % (case["name"], err))
        results[case["name"]] = res
    return results


# -- phase 4 ------------------------------------------------------------------

def run_main_path(torch, serving, model, kv_dtype, trace):
    """Serve `trace` through the user entry points; the launch counts are
    zeroed just before and read just after."""
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    engine = serving.Engine(model, config=serving.EngineConfig(
        kv_dtype=kv_dtype, **POOL), seed=0, device=DEV)
    warm = engine.warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rpa.launches = rpa.quant_launches = 0
    summary = serving.run_trace(engine, trace, warmup=False)
    torch.cuda.synchronize()
    launches, quant = rpa.launches, rpa.quant_launches
    st = engine.stats()
    modes = sorted({v["mode"] for v in
                    engine._compiler.bucket_info().values()})
    dispatches = st["prefill_dispatches"] + st["decode_dispatches"]
    want_tokens = sum(tr.max_new_tokens for tr in trace)
    res = {
        "phase": "main_path", "kv_dtype": kv_dtype,
        "requests": summary["requests"], "finished": summary["finished"],
        "tokens_generated": summary["tokens_generated"],
        "tokens_expected": want_tokens, "steps": summary["steps"],
        "wall_s": summary["wall_s"],
        "tokens_per_sec": summary["tokens_per_sec"],
        "prefill_dispatches": st["prefill_dispatches"],
        "decode_dispatches": st["decode_dispatches"],
        "mean_prefill_ms": st["prefill_ms_total"]
        / max(1, st["prefill_dispatches"]),
        "mean_decode_ms": st["decode_ms_total"]
        / max(1, st["decode_dispatches"]),
        "prefix_hit_tokens": summary["prefix_hit_tokens"],
        "cow_copies": summary["cow_copies"],
        "kernel_launches": launches, "int8_kernel_launches": quant,
        "launches_expected": model.config.layers * dispatches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "kv_pool_bytes": st["kv_pool_bytes"],
        "warmup_buckets": warm["buckets"], "bucket_modes": modes,
        "capture_ms": sum(c["capture_ms"] or 0 for c in warm["compiled"])}
    emit(res)
    check(summary["finished"] == len(trace)
          and summary["tokens_generated"] == want_tokens,
          "%s path: not every request finished with exactly "
          "max_new_tokens tokens" % kv_dtype)
    check(launches == model.config.layers * dispatches and launches > 0,
          "%s path: %d kernel launches for %d dispatches"
          % (kv_dtype, launches, dispatches))
    check(modes == ["graph"], "%s path: buckets ran %s, not captured"
          % (kv_dtype, modes))
    check(quant == (launches if kv_dtype == "int8" else 0),
          "%s path: %d int8 launches of %d" % (kv_dtype, quant, launches))
    engine.close()
    del engine
    torch.cuda.empty_cache()
    return res


def phase_forward_kernel_vs_plain(torch, serving, model):
    """One prefill bucket and three decode buckets through `forward`,
    with the kernel and with the plain version, each on its own fresh
    pool with equal block tables; decode feeds both the kernel run's
    tokens."""
    c = model.config
    kv = serving.PagedKVCache(model.kv_cache_spec(
        POOL["num_pages"], POOL["page_size"], c.max_seq // POOL["page_size"],
        dtype="bfloat16"))
    pages = {impl: kv.init_device_state(DEV)
             for impl in ("auto", "reference")}
    gen = torch.Generator().manual_seed(7)
    S, T = 4, 64
    qlens = torch.tensor([64, 50, 33, 17], dtype=torch.int32)
    tables = torch.zeros((S, c.max_seq // POOL["page_size"]),
                         dtype=torch.int32)
    perm = torch.randperm(POOL["num_pages"], generator=gen).int()
    for s in range(S):
        tables[s] = perm[s * tables.shape[1]:(s + 1) * tables.shape[1]]
    tokens = torch.randint(0, c.vocab, (S, T), generator=gen,
                           dtype=torch.int32)
    ctx = qlens.clone()
    worst, tok_mismatch, compared = 0.0, 0, 0
    for step in range(4):
        outs = {}
        for impl in ("auto", "reference"):
            model.attention_impl = impl
            outs[impl] = model(tokens.to(DEV), pages[impl], tables.to(DEV),
                               ctx.to(DEV), qlens.to(DEV))
        model.attention_impl = "auto"
        tk, lk, _ = outs["auto"]
        tp, lp, _ = outs["reference"]
        check(bool(torch.isfinite(lk).all() and torch.isfinite(lp).all()),
              "forward gave non-finite logits")
        worst = max(worst, float((lk - lp).abs().max()))
        top2 = lp.topk(2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1]) > LOGIT_TOL
        tok_mismatch += int(((tk != tp) & decisive).sum())
        compared += int(decisive.sum())
        tokens = tk.cpu()[:, None]
        qlens = torch.ones((S,), dtype=torch.int32)
        ctx = ctx + 1
    res = {"phase": "forward_kernel_vs_plain", "buckets": [[S, T]]
           + [[S, 1]] * 3, "max_abs_logit_err": worst,
           "tokens_compared": compared, "token_mismatches": tok_mismatch,
           "tol": LOGIT_TOL,
           "ok": worst <= LOGIT_TOL and tok_mismatch == 0}
    emit(res)
    check(res["ok"], "forward with the kernel disagrees with the plain "
          "version (logit err %g, %d token mismatches)"
          % (worst, tok_mismatch))


# -- phase 5 ------------------------------------------------------------------

def flash_inputs(torch, case, seed):
    """Seeded [B, H, S, D] inputs, a cotangent, and a padding bias (each
    sequence keeps a random prefix of at least half its keys). With
    `qkv_views`, q, k and v are the trainer's views of one [B, S, 3, H, D]
    tensor and the cotangent a view of a [B, S, H, D] one; with `bshd`,
    each is a [B, S, H, D] tensor transposed, as Ulysses' all-to-all
    hands them on."""
    B, H, S, D = case["B"], case["H"], case["S"], case["D"]
    dtype = getattr(torch, case["dtype"])
    gen = torch.Generator().manual_seed(seed)
    if case.get("qkv_views"):
        qkv = torch.randn((B, S, 3, H, D), generator=gen).to(DEV, dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        do = torch.randn((B, S, H, D), generator=gen).to(
            DEV, dtype).transpose(1, 2)
    elif case.get("bshd"):
        q, k, v, do = (torch.randn((B, S, H, D), generator=gen).to(
            DEV, dtype).transpose(1, 2) for _ in range(4))
    else:
        q, k, v, do = (torch.randn((B, H, S, D), generator=gen).to(
            DEV, dtype) for _ in range(4))
    bias = None
    if case["bias"]:
        keep = torch.randint(S // 2, S + 1, (B,), generator=gen)
        mask = (torch.arange(S)[None, :] < keep[:, None]).float()
        bias = ((mask - 1.0) * 1e4).to(DEV)
    return q, k, v, do, bias


def flash_pairs(case):
    """(row, col) pairs that attend, per (b, h): the work of one call."""
    S = case["S"]
    return S * (S + 1) // 2 if case["causal"] else S * S


def flash_bounds(case):
    """Least time of each kernel: the bytes it must move (each input read
    once, each output written once) over the memory rate, and its
    operations on the attending pairs over the peak for the input type
    (bf16 tensor cores, or fp32); the larger of the two."""
    B, H, S, D = case["B"], case["H"], case["S"], case["D"]
    BH = B * H
    elt = 4 if case["dtype"] == "float32" else 2
    tile = BH * S * D * elt           # one of q, k, v, o, do, dq, dk, dv
    rows = BH * S * 4                 # lse, delta or the bias, float32
    bias = rows if case["bias"] else 0
    peak, peak_name = ((BF16_FLOPS_PER_S, "%s tensor cores 989 TFLOP/s"
                        % ("fp16" if case["dtype"] == "float16" else "bf16"))
                       if elt == 2 else (FP32_FLOPS_PER_S,
                                         "fp32 67 TFLOP/s"))
    pairs = BH * flash_pairs(case)
    work = {"forward": (4 * tile + rows + bias, 4 * pairs * D),
            "dkv": (6 * tile + 2 * rows + bias, 8 * pairs * D),
            "dq": (5 * tile + 2 * rows + bias, 6 * pairs * D)}
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        out[name] = {"bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations", "bytes": nbytes, "flops": flops,
                     "peak": peak_name}
    return out


def flash_design(kname, dtype):
    """How the wrapper runs a kernel for this dtype: every bf16 and fp16
    kernel (forward, dK/dV, dQ) on tensor cores, fp32 SIMT."""
    return {"bfloat16": "wgmma bf16", "float16": "wgmma f16"}.get(
        dtype, "simt fp32")


def flash_library(torch, q, k, v, do, bias, case):
    """scaled_dot_product_attention with the same mask and dropout rate:
    (forward, backward of dq/dk/dv, forward + backward) callables."""
    import torch.nn.functional as F

    mask = None if bias is None else bias[:, None, None, :].to(q.dtype)
    qs, ks, vs = (x.detach().clone().requires_grad_(True) for x in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, dropout_p=case["p"],
            is_causal=case["causal"])

    out = fwd()
    return (fwd,
            lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                        retain_graph=True),
            lambda: torch.autograd.grad(fwd(), (qs, ks, vs), do))


def phase_flash_cases(torch, timer):
    """Each flash kernel against its plain version on the same inputs:
    forward (o, lse); dK/dV and dQ from the plain forward's lse and
    delta."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    fa_mod = sys.modules[fa.__module__]
    results = {}
    for n, case in enumerate(FLASH_CASES):
        q, k, v, do, bias4 = flash_inputs(torch, case, 100 + n)
        qf, kf, vf, bias = fa_mod.pad_and_flatten(q, k, v, bias4)
        dof = fa_mod.pad_and_flatten(do, k, v)[0]
        dof[:, :, case["S"]:] = 0  # the padded rows get no gradient
        kw = dict(sm_scale=1.0 / math.sqrt(case["D"]),
                  causal=case["causal"], dropout_p=case["p"])
        args = (qf, kf, vf, bias, FLASH_SEED)
        fwd = lambda impl: fa_mod.flash_attention_fwd(*args, impl=impl, **kw)
        o, lse = fwd("kernel")
        o_r, lse_r = fwd("reference")
        delta = fa_mod.flash_attention_delta(o_r, dof)
        grad_args = args + (dof, lse_r, delta)
        dkv = lambda impl: fa_mod.flash_attention_bwd_dkv(
            *grad_args, impl=impl, **kw)
        dq = lambda impl: fa_mod.flash_attention_bwd_dq(
            *grad_args, impl=impl, **kw)
        got = dict(zip(("dk", "dv"), dkv("kernel")), dq=dq("kernel"), o=o,
                   lse=lse)
        torch.cuda.synchronize()
        want = dict(zip(("dk", "dv"), dkv("reference")), dq=dq("reference"),
                    o=o_r, lse=lse_r)
        fwd_tol, grad_tol = FLASH_TOL[case["dtype"]]
        errs, ok = {}, True
        for name in ("o", "lse", "dk", "dv", "dq"):
            g, w = got[name].float(), want[name].float()
            tol = fwd_tol if name in ("o", "lse") else grad_tol
            errs[name] = float((g - w).abs().max())
            ok = ok and bool(torch.isfinite(g).all()) and bool(
                torch.allclose(g, w, atol=tol, rtol=tol))
        bounds = flash_bounds(case)
        lib_fwd, lib_bwd, lib_both = flash_library(torch, q, k, v, do,
                                                   bias4, case)
        timed = {
            "forward": (timer(lambda: fwd("kernel"), 20),
                        timer(lambda: fwd("reference"), 5)),
            "dkv": (timer(lambda: dkv("kernel"), 20),
                    timer(lambda: dkv("reference"), 5)),
            "dq": (timer(lambda: dq("kernel"), 20),
                   timer(lambda: dq("reference"), 5))}
        library = {"forward": timer(lib_fwd, 20),
                   "backward": timer(lib_bwd, 20),
                   "forward_backward": timer(lib_both, 20)}
        res = {"phase": "flash_case", "case": case["name"],
               "shape": [case["B"], case["H"], case["S"], case["D"]],
               "dtype": case["dtype"], "causal": case["causal"],
               "key_bias": case["bias"], "dropout_p": case["p"],
               "qkv_views": bool(case.get("qkv_views")),
               "bshd": bool(case.get("bshd")),
               "padded_s": qf.shape[2], "max_abs_err": errs,
               "tol": {"forward": fwd_tol, "grads": grad_tol}, "ok": ok,
               "library_ms": library, "kernels": {
                   name: dict(bounds[name], ms=t[0], plain_ms=t[1],
                              route=flash_design(name, case["dtype"]),
                              tflops=bounds[name]["flops"] / (t[0] * 1e9))
                   for name, t in timed.items()}}
        emit(res)
        check(ok, "flash case %s: the kernels disagree with the plain "
              "version (max abs errors %s)" % (case["name"], errs))
        results[case["name"]] = res
    return results


def ulps(torch, a, b):
    """Largest distance in units in the last place between two float
    tensors of one dtype (same-sign values; zeros are exact)."""
    itype = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
             torch.float16: torch.int16}[a.dtype]
    return int((a.view(itype).long() - b.view(itype).long()).abs().max())


def phase_dropout_cases(torch, timer):
    """The dropout kernel against its plain version (the same hash in
    torch integer ops) at fluid BERT leg a's two shapes: the Mask
    exactly, Out within one unit in the last place; each time beside the
    bytes bound (x read once, Out and the uint8 Mask written once) and
    `torch.native_dropout` as the yardstick."""
    from paddle_tpu_torch.core.rng import seed_tensor
    from paddle_tpu_torch.ops.kernels import dropout, dropout_reference

    results = {}
    g = torch.Generator().manual_seed(3)
    for case in DROPOUT_CASES:
        dtype = getattr(torch, case["dtype"])
        x = torch.randn(case["shape"], generator=g).to(DEV, dtype)
        seed = seed_tensor(DROPOUT_SEED, DEV)
        out, mask = dropout(x, seed, case["p"])
        ref_out, ref_mask = dropout_reference(x, seed, case["p"])
        torch.cuda.synchronize()
        mask_equal = bool(torch.equal(mask, ref_mask))
        err_ulps = ulps(torch, out, ref_out)
        nbytes = x.numel() * (2 * x.element_size() + 1)
        res = {"phase": "dropout_case", "case": case["name"],
               "shape": case["shape"], "dtype": case["dtype"],
               "p": case["p"], "mask_equal": mask_equal,
               "max_ulps": err_ulps,
               "max_abs_err": float((out.float() - ref_out.float()).abs()
                                    .max()),
               "keep_rate": float(mask.float().mean()),
               "ms": timer(lambda: dropout(x, seed, case["p"]), 20),
               "plain_ms": timer(lambda: dropout_reference(
                   x, seed, case["p"]), 5),
               "library_ms": timer(lambda: torch.native_dropout(
                   x, case["p"], True), 20),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes"}
        emit(res)
        check(mask_equal and err_ulps <= 1,
              "dropout case %s: the kernel disagrees with the plain "
              "version (mask equal %s, %d ulps)" % (case["name"],
                                                    mask_equal, err_ulps))
        results[case["name"]] = res
    return results


# -- phase 6 ------------------------------------------------------------------

def train_model_flops(cfg, batch):
    """Model FLOPs of one step (forward and backward, no recompute): the
    matmuls, the tied LM head and causal attention over the attending
    pairs."""
    D, Fd, V, S, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.seq_len, \
        cfg.n_layers
    tokens = batch * S
    matmul = tokens * (L * 2 * (4 * D * D + 2 * D * Fd) + 2 * D * V)
    attn = L * batch * cfg.n_heads * 4 * (S * (S + 1) // 2) * cfg.d_head
    return 3 * (matmul + attn)


def phase_training(torch):
    """The trainer's steps through its user entry points, with the launch
    counts zeroed just before and read just after; then kernels vs plain
    attention on one step."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.parallel import transformer as tt

    cfg = tt.SPMDConfig()
    L = cfg.n_layers
    params = tt.init_params(cfg, seed=0, device=DEV)
    opt = tt.init_opt_state(params)
    step = tt.make_train_step(cfg, device=DEV)
    tokens, labels = tt.demo_batch(cfg, TRAIN_BATCH, seed=0)
    params, opt, loss = step(params, opt, tokens, labels, 0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.fwd_launches = fa.dkv_launches = fa.dq_launches = 0
    fa.tc_launches = dict.fromkeys(fa.tc_launches, 0)
    losses, step_ms = [], []
    for i in range(1, TRAIN_STEPS + 1):
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, tokens, labels, i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches = {"forward": fa.fwd_launches, "dkv": fa.dkv_launches,
                "dq": fa.dq_launches}
    tc_launches = dict(fa.tc_launches)
    want = {"forward": 2 * L * TRAIN_STEPS, "dkv": L * TRAIN_STEPS,
            "dq": L * TRAIN_STEPS}
    mean_s = sum(step_ms) / len(step_ms) / 1e3
    flops = train_model_flops(cfg, TRAIN_BATCH)

    # one step with the kernels and one with the plain attention
    with_grads = {impl: tt.make_train_step(cfg, device=DEV, with_grads=True,
                                           attn_impl=impl)
                  for impl in ("auto", "reference")}
    outs = {impl: fn(params, opt, tokens, labels, TRAIN_STEPS + 1)
            for impl, fn in with_grads.items()}
    lk, lp = float(outs["auto"][2]), float(outs["reference"][2])
    grad_err = {name: float((a - b).norm() / b.norm().clamp_min(1e-30))
                for (name, a), (_, b) in zip(leaves(outs["auto"][3]),
                                             leaves(outs["reference"][3]))}
    loss_err = abs(lk - lp) / abs(lp)
    res = {"phase": "train_path", "config": dataclasses.asdict(cfg),
           "batch": TRAIN_BATCH, "steps": TRAIN_STEPS, "losses": losses,
           "step_ms": step_ms, "mean_step_ms": mean_s * 1e3,
           "tokens_per_sec": TRAIN_BATCH * cfg.seq_len / mean_s,
           "model_flops_per_step": flops,
           "mfu_vs_bf16_peak": flops / mean_s / BF16_FLOPS_PER_S,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "launches_expected": want,
           "tensor_core_launches": tc_launches,
           "kernel_vs_plain": {"loss_kernel": lk, "loss_plain": lp,
                               "loss_rel_err": loss_err,
                               "max_grad_rel_err": max(grad_err.values()),
                               "grad_rel_err": grad_err}}
    emit(res)
    check(all(math.isfinite(x) for x in losses),
          "training: non-finite loss %s" % losses)
    check(launches == want and tc_launches == want,
          "training: launches %s (tensor cores %s), expected %s"
          % (launches, tc_launches, want))
    check(loss_err <= TRAIN_LOSS_RTOL and
          max(grad_err.values()) <= TRAIN_GRAD_RTOL,
          "training: kernels vs plain attention: loss rel err %g, max "
          "grad rel err %g" % (loss_err, max(grad_err.values())))
    del params, opt, outs
    torch.cuda.empty_cache()
    return res


# -- phase 7 ------------------------------------------------------------------

def fluid_mnist_data(n=512):
    """tests/test_mnist_mlp.py's separable synthetic MNIST, seeded."""
    import numpy as np

    rng = np.random.RandomState(FLUID_SEED)
    x = rng.rand(n, 784).astype("float32") * 0.1
    y = rng.randint(0, 10, size=(n, 1)).astype("int64")
    for i in range(n):
        x[i, y[i, 0] * 78:(y[i, 0] + 1) * 78] += 1.0
    return x, y


def build_fluid_mlp(fluid, kind):
    """The MNIST MLP of tests/test_mnist_mlp.py in fresh programs, with
    its optimizer ("sgd", "adam", or "sgd_f16": SGD under float16 AMP O2
    with dynamic loss scaling): (main, startup, loss, accuracy)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = FLUID_INIT_SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data(name="img", shape=[784], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=img, size=128, act="relu")
        h = fluid.layers.fc(input=h, size=64, act="relu")
        logits = fluid.layers.fc(input=h, size=10, act=None)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        acc = fluid.layers.accuracy(input=fluid.layers.softmax(logits),
                                    label=label)
        opt = (fluid.optimizer.SGDOptimizer(learning_rate=0.5)
               if kind.startswith("sgd")
               else fluid.optimizer.AdamOptimizer(learning_rate=1e-3))
        if kind == "sgd_f16":
            from paddle_tpu_torch.fluid.contrib import mixed_precision

            opt = mixed_precision.decorate(opt, amp_dtype="float16")
        opt.minimize(loss)
    return main, startup, loss, acc


def fluid_steps(torch, fluid, exe, main, scope, fetch, steps):
    """`steps` feed/fetch runs over the synthetic batches: losses,
    accuracies and host-clock ms a step (ending in a synchronize)."""
    x, y = fluid_mnist_data()
    losses, accs, step_ms = [], [], []
    for step in range(steps):
        i = (step * FLUID_BATCH) % (len(x) - FLUID_BATCH)
        feed = {"img": x[i:i + FLUID_BATCH], "label": y[i:i + FLUID_BATCH]}
        t0 = time.perf_counter()
        loss, acc = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        if exe.device.type == "cuda":
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss[0]))
        accs.append(float(acc[0]))
    return losses, accs, step_ms


def phase_fluid(torch, name):
    """The fluid static graph: the MNIST MLP through layers -> minimize
    -> Executor.run, on the card (Executor() with no place) and on the
    CPU from the same numpy params, for SGD and for Adam."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.core.scope import dump_numpy_state, \
        load_numpy_state

    res = {"phase": "fluid_static_graph",
           "model": "MNIST MLP 784-128-64-10", "batch": FLUID_BATCH}
    for kind, steps in (("sgd", FLUID_SGD_STEPS),
                        ("adam", FLUID_ADAM_STEPS)):
        main, startup, loss, acc = build_fluid_mlp(fluid, kind)
        exe = fluid.Executor()
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        off_card = [n for n in names
                    if scope.find_var(n).device != torch.device("cuda", 0)]
        check(not off_card, "fluid %s: persistables not on cuda:0: %s"
              % (kind, off_card))
        state = dump_numpy_state(scope, names)
        card = fluid_steps(torch, fluid, exe, main, scope, [loss, acc],
                           steps)
        cpu_scope = fluid.Scope()
        load_numpy_state(cpu_scope, state, "cpu")
        cpu = fluid_steps(torch, fluid, fluid.Executor(fluid.CPUPlace()),
                          main, cpu_scope, [loss, acc], steps)
        rel = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
        res[kind] = {"steps": steps, "persistables": len(names),
                     "losses": card[0], "losses_cpu": cpu[0],
                     "max_loss_rel_err": rel, "accuracies": card[1],
                     "step_ms": card[2],
                     "median_step_ms": statistics.median(card[2]),
                     "cpu_median_step_ms": statistics.median(cpu[2])}
        check(all(math.isfinite(v) for v in card[0]),
              "fluid %s: non-finite loss %s" % (kind, card[0]))
        check(rel <= FLUID_LOSS_RTOL, "fluid %s: card vs CPU losses differ "
              "by %g relative" % (kind, rel))
        check(card[1] == cpu[1], "fluid %s: accuracies differ: %s vs %s"
              % (kind, card[1], cpu[1]))
        check(card[0][-1] < 0.5 * card[0][0], "fluid %s: loss %g -> %g did "
              "not halve" % (kind, card[0][0], card[0][-1]))
    res.update(device=name, nvidia_smi=nvidia_smi_line())
    emit(res)
    return res


# -- phase 8 ------------------------------------------------------------------

def build_fluid_bert(fluid, cfg, seq, remat, attention_impl="auto"):
    """BERT pretraining as bench.py builds it, in fresh programs:
    `bert_pretrain_loss` (scan encoder), bf16 AMP O2 over Adam(1e-4)
    without loss scaling, `minimize`, `fuse_optimizer_ops`. Returns
    (main, startup, total loss, names of the params' gradients)."""
    from paddle_tpu_torch.fluid.contrib import mixed_precision
    from paddle_tpu_torch.models import bert

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = BERT_INIT_SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        total, _, _, _ = bert.bert_pretrain_loss(
            cfg, seq, scan_layers=True, scan_remat=remat,
            attention_impl=attention_impl)
        opt = mixed_precision.decorate(
            fluid.optimizer.AdamOptimizer(learning_rate=BERT_LR),
            use_dynamic_loss_scaling=False)
        _, params_grads = opt.minimize(total)
        fluid.fuse_optimizer_ops(main)
    return main, startup, total, [g.name for _, g in params_grads]


def bert_cfg(seq, layers=None):
    """BERT-base (paddle_tpu/models/bert.py BertConfig.base), its
    position table stretched to `seq` where longer than 512 (as bench.py
    does for its long-context leg), its depth cut to `layers` if given."""
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base()
    cfg.max_position_embeddings = max(cfg.max_position_embeddings, seq)
    if layers is not None:
        cfg.num_hidden_layers = layers
    return cfg


def bert_model_flops(cfg, batch, seq, n_pred):
    """Model FLOPs of one pretraining step (forward and backward, no
    recompute): per layer the qkv, output and two FFN products over the
    B*S tokens and attention's two products over S*S pairs, then the
    masked-LM transform and vocab head over the B*n_pred masked tokens
    and the pooler and NSP head over the B [CLS] rows."""
    h, f, V, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_hidden_layers)
    tokens, masked = batch * seq, batch * n_pred
    encoder = L * (2 * tokens * (4 * h * h + 2 * h * f)
                   + 4 * batch * seq * seq * h)
    heads = 2 * masked * h * (h + V) + 2 * batch * h * (h + 2)
    return 3 * (encoder + heads)


def device_busy_share(torch, fn):
    """Run `fn` once under torch.profiler: (device busy us summed over
    kernels, wall us, kernels launched)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    busy, count = 0.0, 0
    for e in prof.key_averages():
        if "cuda" in str(e.device_type).lower():
            us = float(getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0)))
            if us > 0:
                busy += us
                count += e.count
    return busy, wall, count


def fluid_bert_leg(torch, fluid, leg):
    """One leg of the fluid BERT path at full width on the card:
    startup on `fluid.Executor()`, warm-up steps, then timed steps with
    the flash launch counts zeroed just before them and read just after,
    then one profiled step for the device's busy share."""
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops.kernels import dropout, \
        flash_attention as fa

    cfg = bert_cfg(leg["seq"])
    main, startup, total, _ = build_fluid_bert(fluid, cfg, leg["seq"],
                                               leg["remat"])
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = bert.bert_feed(cfg, leg["batch"], leg["seq"])
    n_pred = feed["mask_pos"].shape[1]

    def step():
        return float(exe.run(main, feed=feed, fetch_list=[total],
                             scope=scope)[0][0])

    losses = [step() for _ in range(BERT_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.fwd_launches = fa.dkv_launches = fa.dq_launches = 0
    fa.tc_launches = dict.fromkeys(fa.tc_launches, 0)
    dropout.launches = 0
    step_ms = []
    for _ in range(BERT_STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"forward": fa.fwd_launches, "dkv": fa.dkv_launches,
                "dq": fa.dq_launches}
    tc_launches = dict(fa.tc_launches)
    drop_launches = dropout.launches
    entry = exe.last_entry.info()
    peak = torch.cuda.max_memory_allocated()
    busy, wall, kernels = device_busy_share(torch, step)
    L = cfg.num_hidden_layers
    flash = leg["seq"] >= fluid.get_flags(
        "FLAGS_flash_attention_min_seq")["FLAGS_flash_attention_min_seq"]
    # a step runs each layer's attention forward once, and once more in
    # the backward's recompute under remat; dK/dV and dQ once
    fwd_per_step = (2 if leg["remat"] else 1) * L if flash else 0
    want = {"forward": fwd_per_step * BERT_STEPS,
            "dkv": (L if flash else 0) * BERT_STEPS,
            "dq": (L if flash else 0) * BERT_STEPS}
    # the embeddings' dropout and two a layer, again in remat's
    # recompute; the composite attention's dropout on the probabilities
    drop_per_step = 1 + 2 * L * (2 if leg["remat"] else 1) \
        + (0 if flash else L)
    median_s = statistics.median(step_ms) / 1e3
    flops = bert_model_flops(cfg, leg["batch"], leg["seq"], n_pred)
    res = {"leg": leg["name"], "seq": leg["seq"], "batch": leg["batch"],
           "layers": L, "hidden": cfg.hidden_size, "vocab": cfg.vocab_size,
           "masked_per_seq": n_pred, "scan_remat": leg["remat"],
           "attention": "flash kernels" if flash else "composite",
           "losses": losses, "step_ms": step_ms,
           "median_step_ms": median_s * 1e3,
           "tokens_per_sec": leg["batch"] * leg["seq"] / median_s,
           "model_flops_per_step": flops,
           "mfu_vs_bf16_peak": flops / median_s / BF16_FLOPS_PER_S,
           "peak_mem_bytes": peak, "profiled_step": {
               "wall_us": wall, "device_busy_us": busy,
               "device_busy_share": busy / wall, "kernels": kernels},
           "launches": launches, "launches_expected": want,
           "tensor_core_launches": tc_launches,
           "dropout_launches": drop_launches,
           "dropout_launches_expected": drop_per_step * BERT_STEPS,
           "entry": entry}
    first_want = math.log(cfg.vocab_size) + math.log(2)
    check(all(math.isfinite(x) for x in losses),
          "fluid bert %s: non-finite loss %s" % (leg["name"], losses))
    check(abs(losses[0] - first_want) <= BERT_LOSS0_TOL,
          "fluid bert %s: first loss %g, expected %g +- %g" % (
              leg["name"], losses[0], first_want, BERT_LOSS0_TOL))
    check(launches == want and tc_launches == want,
          "fluid bert %s: flash launches %s (tensor cores %s), expected %s"
          % (leg["name"], launches, tc_launches, want))
    check(drop_launches == drop_per_step * BERT_STEPS,
          "fluid bert %s: %d dropout launches, expected %d" % (
              leg["name"], drop_launches, drop_per_step * BERT_STEPS))
    check(entry["mode"] == "graph" and entry["phase"] == "captured",
          "fluid bert %s: the step is %s, not captured" % (
              leg["name"], entry))
    del exe, scope
    torch.cuda.empty_cache()
    return res


def fluid_bert_kernels_vs_plain(torch, fluid):
    """One step of the S 4096 program with the flash kernels and one with
    their plain version (`attention_impl="reference"`), from the same
    params and feed: the loss and every parameter's gradient."""
    from paddle_tpu_torch.models import bert

    c = BERT_CHECK
    cfg = bert_cfg(c["seq"], c["layers"])
    feed = bert.bert_feed(cfg, c["batch"], c["seq"])
    out, state = {}, None
    for impl in ("auto", "reference"):
        main, startup, total, grads = build_fluid_bert(
            fluid, cfg, c["seq"], True, attention_impl=impl)
        exe = fluid.Executor()
        scope = fluid.Scope()
        if state is None:
            exe.run(startup, scope=scope)
            state = {n: scope.find_var(n).clone()
                     for n in scope.local_var_names()}
        else:
            for n, v in state.items():
                scope.set_var(n, v.clone())
        vals = [f.value for f in exe.run(
            main, feed=feed, fetch_list=[total] + grads, scope=scope,
            return_numpy=False)]
        out[impl] = (float(vals[0].reshape(-1)[0]),
                     dict(zip(grads, (v.float() for v in vals[1:]))))
    lk, gk = out["auto"]
    lp, gp = out["reference"]
    grad_err = {n: float((gk[n] - gp[n]).norm()
                         / gp[n].norm().clamp_min(1e-30)) for n in gp}
    res = {"seq": c["seq"], "batch": c["batch"], "layers": c["layers"],
           "loss_kernel": lk, "loss_plain": lp,
           "loss_rel_err": abs(lk - lp) / abs(lp),
           "max_grad_rel_err": max(grad_err.values()),
           "grad_rel_err": grad_err,
           "tol": {"loss": BERT_CHECK_LOSS_RTOL,
                   "grads": BERT_CHECK_GRAD_RTOL}}
    check(math.isfinite(lk) and res["loss_rel_err"] <= BERT_CHECK_LOSS_RTOL
          and res["max_grad_rel_err"] <= BERT_CHECK_GRAD_RTOL,
          "fluid bert: kernels vs plain: loss rel err %g, max grad rel err "
          "%g" % (res["loss_rel_err"], res["max_grad_rel_err"]))
    return res


def phase_fluid_bert(torch, name):
    """BERT-base pretraining through the fluid static graph on the card:
    leg a at S 128 (composite attention), leg b at S 4096 (the three
    flash kernels, with the key bias and dropout inside them), then leg
    c, the kernels against their plain version on one step."""
    from paddle_tpu_torch import fluid

    res = {"phase": "fluid_bert", "config": "BERT-base (BertConfig.base)",
           "optimizer": "Adam 1e-4, bf16 AMP O2, fuse_optimizer_ops",
           "legs": [fluid_bert_leg(torch, fluid, leg)
                    for leg in BERT_FLUID_LEGS]}
    res["kernels_vs_plain"] = fluid_bert_kernels_vs_plain(torch, fluid)
    res.update(device=name, nvidia_smi=nvidia_smi_line())
    emit(res)
    return res


# -- phase 17 -----------------------------------------------------------------

def build_fluid_bert_f16(fluid, cfg, seq, remat, attention_impl="auto",
                         amp=True, **scale):
    """BERT pretraining as Paddle trains it on a GPU, in fresh programs:
    `bert_pretrain_loss` (scan encoder), LAMB (the reference's exclusions
    from weight decay) with `GradientClipByGlobalNorm`, float16 AMP O2
    with dynamic loss scaling (`F16_SCALE`, updated by `scale`; `amp`
    False leaves the program in fp32), `minimize`, `fuse_optimizer_ops`.
    Returns (main, startup, total loss, gradient names, the decorated
    optimizer or None, the global norm's var name)."""
    from paddle_tpu_torch.fluid.contrib import mixed_precision
    from paddle_tpu_torch.models import bert

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = BERT_INIT_SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        total, _, _, _ = bert.bert_pretrain_loss(
            cfg, seq, scan_layers=True, scan_remat=remat,
            attention_impl=attention_impl)
        opt = fluid.optimizer.LambOptimizer(
            learning_rate=F16_LAMB["lr"],
            lamb_weight_decay=F16_LAMB["weight_decay"],
            exclude_from_weight_decay_fn=bert.exclude_from_weight_decay,
            grad_clip=fluid.clip.GradientClipByGlobalNorm(F16_LAMB["clip"]))
        dec = None
        if amp:
            opt = dec = mixed_precision.decorate(
                opt, amp_dtype="float16", amp_level="O2",
                use_dynamic_loss_scaling=True, **dict(F16_SCALE, **scale))
        _, params_grads = opt.minimize(total)
        fluid.fuse_optimizer_ops(main)
    norm = next(n for op in main.global_block().ops if op.type == "sqrt"
                for n in op.output_arg_names)
    return (main, startup, total, [g.name for _, g in params_grads], dec,
            norm)


def scale_state(scope, dec):
    """(scale, good, bad) of a decorated optimizer's state in `scope`."""
    st = dec._scale_state
    return (float(scope.find_var(st["scale"]).reshape(-1)[0]),
            int(scope.find_var(st["good"]).reshape(-1)[0]),
            int(scope.find_var(st["bad"]).reshape(-1)[0]))


@contextlib.contextmanager
def plain_attention_watch(torch):
    """Counts the calls of the plain attention (the composite
    `reference_attention` and the flash kernels' plain versions) that
    receive float16 CUDA tensors while the block is open."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    mod = sys.modules[fa.__module__]
    names = ("reference_attention", "flash_attention_fwd_reference",
             "flash_attention_bwd_dkv_reference",
             "flash_attention_bwd_dq_reference")
    saved = {n: getattr(mod, n) for n in names}
    calls = {"f16_cuda": 0}

    def wrap(fn):
        def counted(q, *args, **kwargs):
            if q.is_cuda and q.dtype == torch.float16:
                calls["f16_cuda"] += 1
            return fn(q, *args, **kwargs)
        return counted

    for n, fn in saved.items():
        setattr(mod, n, wrap(fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(mod, n, fn)


def f16_leg(torch, fluid, leg):
    """One leg of phase 17 at full width on the card, as `fluid_bert_leg`
    runs phase 8's (warm-up, timed steps with the launch counts zeroed
    just before them, one profiled step), with the loss-scale state read
    after each step (scale, good and bad counts, the skipped steps) and
    the plain attention watched for float16 CUDA inputs."""
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops.kernels import dropout, \
        flash_attention as fa

    t0 = time.perf_counter()
    cfg = bert_cfg(leg["seq"])
    main, startup, total, _, dec, _ = build_fluid_bert_f16(
        fluid, cfg, leg["seq"], leg["remat"])
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = bert.bert_feed(cfg, leg["batch"], leg["seq"])
    n_pred = feed["mask_pos"].shape[1]

    def step():
        return float(exe.run(main, feed=feed, fetch_list=[total],
                             scope=scope)[0][0])

    states = [scale_state(scope, dec)]
    with plain_attention_watch(torch) as plain:
        losses = []
        for _ in range(BERT_WARMUP):
            losses.append(step())
            states.append(scale_state(scope, dec))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.fwd_launches = fa.dkv_launches = fa.dq_launches = 0
        fa.tc_launches = dict.fromkeys(fa.tc_launches, 0)
        fa.dtype_launches = {}
        dropout.launches = 0
        dropout.dtype_launches = {}
        step_ms = []
        for _ in range(BERT_STEPS):
            t1 = time.perf_counter()
            losses.append(step())
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            states.append(scale_state(scope, dec))
        launches = {"forward": fa.fwd_launches, "dkv": fa.dkv_launches,
                    "dq": fa.dq_launches}
        tc_launches = dict(fa.tc_launches)
        f16_launches = dict(fa.dtype_launches.get(
            "float16", dict.fromkeys(launches, 0)))
        drop = dict(dropout.dtype_launches, total=dropout.launches)
    entry = exe.last_entry.info()
    peak = torch.cuda.max_memory_allocated()
    busy, wall, kernels = device_busy_share(torch, step)
    L = cfg.num_hidden_layers
    flash = leg["seq"] >= fluid.get_flags(
        "FLAGS_flash_attention_min_seq")["FLAGS_flash_attention_min_seq"]
    fwd_per_step = (2 if leg["remat"] else 1) * L if flash else 0
    want = {"forward": fwd_per_step * BERT_STEPS,
            "dkv": (L if flash else 0) * BERT_STEPS,
            "dq": (L if flash else 0) * BERT_STEPS}
    drop_per_step = 1 + 2 * L * (2 if leg["remat"] else 1) \
        + (0 if flash else L)
    skipped = sum(1 for a, b in zip(states, states[1:])
                  if b[2] > a[2] or b[0] < a[0])
    median_s = statistics.median(step_ms) / 1e3
    flops = bert_model_flops(cfg, leg["batch"], leg["seq"], n_pred)
    res = {"phase": "fluid_bert_fp16_lamb_leg", "leg": leg["name"],
           "seq": leg["seq"], "batch": leg["batch"], "layers": L,
           "attention": "flash kernels (float16)" if flash
           else "composite", "losses": losses, "step_ms": step_ms,
           "median_step_ms": median_s * 1e3,
           "tokens_per_sec": leg["batch"] * leg["seq"] / median_s,
           "model_flops_per_step": flops,
           "mfu_vs_fp16_peak": flops / median_s / BF16_FLOPS_PER_S,
           "peak_mem_bytes": peak, "profiled_step": {
               "wall_us": wall, "device_busy_us": busy,
               "device_busy_share": busy / wall, "kernels": kernels},
           "loss_scale": states[-1][0], "good_steps": states[-1][1],
           "bad_steps": states[-1][2], "skipped_steps": skipped,
           "scale_history": [s_[0] for s_ in states],
           "launches": launches, "launches_expected": want,
           "tensor_core_launches": tc_launches,
           "float16_launches": f16_launches,
           "design": flash_design("forward", "float16") if flash else None,
           "plain_attention_f16_cuda_calls": plain["f16_cuda"],
           "dropout_launches": drop,
           "dropout_launches_expected": drop_per_step * BERT_STEPS,
           "entry": {k: entry[k] for k in ("mode", "phase")},
           "seconds": time.perf_counter() - t0}
    emit(res)
    name = "fluid_bert_fp16_lamb %s" % leg["name"]
    first_want = math.log(cfg.vocab_size) + math.log(2)
    check(all(math.isfinite(x) for x in losses),
          "%s: non-finite loss %s" % (name, losses))
    check(abs(losses[0] - first_want) <= BERT_LOSS0_TOL,
          "%s: first loss %g, expected %g +- %g" % (
              name, losses[0], first_want, BERT_LOSS0_TOL))
    check(launches == want and tc_launches == want and f16_launches == want,
          "%s: flash launches %s (tensor cores %s, float16 %s), expected %s"
          % (name, launches, tc_launches, f16_launches, want))
    check(plain["f16_cuda"] == 0 or not flash,
          "%s: %d float16 CUDA calls reached the plain attention" % (
              name, plain["f16_cuda"]))
    check(drop["total"] == drop_per_step * BERT_STEPS,
          "%s: dropout launches %s, expected %d" % (
              name, drop, drop_per_step * BERT_STEPS))
    check(entry["mode"] == "graph" and entry["phase"] == "captured",
          "%s: the step is %s, not captured" % (name, entry))
    del exe, scope
    torch.cuda.empty_cache()
    return res


def f16_leg_c(torch, fluid):
    """The S 4096 program at 2 layers, captured: a replay at a scale of
    2^40 must skip (every param, master and moment bit-equal; the scale
    times decr_ratio), then from a scale of 1 two clean replays double
    it; the same steps run eagerly from the same start are bit-equal to
    the captured ones."""
    from paddle_tpu_torch.models import bert

    t0 = time.perf_counter()
    c = F16_C
    cfg = bert_cfg(c["seq"], c["layers"])
    feed = bert.bert_feed(cfg, c["batch"], c["seq"])
    main, startup, total, _, dec, norm = build_fluid_bert_f16(
        fluid, cfg, c["seq"], True,
        incr_every_n_steps=c["incr_every_n_steps"],
        decr_every_n_nan_or_inf=c["decr_every_n_nan_or_inf"])
    st = dec._scale_state
    scope0 = fluid.Scope()
    fluid.Executor().run(startup, scope=scope0)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    start = {n: scope0.find_var(n).clone() for n in names}
    del scope0
    # (scale set before the step or None, steps)
    plan = [(None, 2), (c["overflow"], 1), (1.0, 2)]

    def run(graphs):
        graph_flag(fluid, graphs)
        exe, scope = fluid.Executor(), fluid.Scope()
        for n, v in start.items():
            scope.set_var(n, v.clone())
        counter = main._seed_counter
        out = {"losses": [], "norms": [], "states": [], "skips": []}
        for scale, steps in plan:
            for i in range(steps):
                if scale is not None and i == 0:
                    scope.set_var(st["scale"], torch.full(
                        (1,), scale, dtype=torch.float32, device=DEV))
                before = {n: scope.find_var(n).clone() for n in names}
                loss, gn = exe.run(main, feed=feed, fetch_list=[total, norm],
                                   scope=scope)
                out["losses"].append(float(loss.reshape(-1)[0]))
                out["norms"].append(float(gn.reshape(-1)[0]))
                out["states"].append(scale_state(scope, dec))
                out["skips"].append(all(
                    torch.equal(before[n], scope.find_var(n))
                    for n in names if n not in st.values()))
                out.setdefault("phases", []).append(exe.last_entry.phase)
        out["final"] = {n: scope.find_var(n).clone() for n in names}
        out["mode"] = exe.last_entry.mode
        main._seed_counter = counter
        graph_flag(fluid, True)
        return out

    graph, eager = run(True), run(False)
    decr = float(torch.tensor(c["overflow"], dtype=torch.float32)
                 * torch.tensor(F16_SCALE["decr_ratio"],
                                dtype=torch.float32))
    want_states = [graph["states"][0], graph["states"][1],
                   (decr, 0, 0), (1.0, 1, 0), (2.0, 0, 0)]
    bit_equal = graph["losses"] == eager["losses"] and all(
        torch.equal(graph["final"][n], eager["final"][n]) for n in names)
    res = {"leg": "c", "seq": c["seq"], "batch": c["batch"],
           "layers": c["layers"], "losses": graph["losses"],
           "global_norms": graph["norms"], "states": graph["states"],
           "skipped": graph["skips"], "phases": graph["phases"],
           "mode": graph["mode"], "overflow_scale": c["overflow"],
           "replay_skip_bit_equal": graph["skips"][2],
           "captured_equals_eager": bit_equal,
           "seconds": time.perf_counter() - t0}
    emit(dict(res, phase="fluid_bert_fp16_lamb_leg"))
    check(graph["mode"] == "graph" and graph["phases"][2:] ==
          ["captured"] * 3, "fluid_bert_fp16_lamb c: not replayed: %s"
          % graph["phases"])
    check(graph["skips"] == [False, False, True, False, False]
          and graph["norms"][2] == 0.0,
          "fluid_bert_fp16_lamb c: skips %s (global norms %s), expected "
          "only the third" % (graph["skips"], graph["norms"]))
    check(graph["states"][2:] == want_states[2:],
          "fluid_bert_fp16_lamb c: scale states %s, expected %s" % (
              graph["states"], want_states))
    check(bit_equal, "fluid_bert_fp16_lamb c: captured steps differ from "
          "eager ones (losses %s / %s)" % (graph["losses"],
                                           eager["losses"]))
    return res


def f16_leg_d(torch, fluid):
    """The S 4096 program at 2 layers, one step with the flash kernels and
    one with their plain version from the same params: the loss and
    every unscaled gradient (phase 8 leg c's bounds)."""
    from paddle_tpu_torch.models import bert

    t0 = time.perf_counter()
    c = F16_C
    cfg = bert_cfg(c["seq"], c["layers"])
    feed = bert.bert_feed(cfg, c["batch"], c["seq"])
    out, state = {}, None
    for impl in ("auto", "reference"):
        main, startup, total, grads, dec, _ = build_fluid_bert_f16(
            fluid, cfg, c["seq"], True, attention_impl=impl)
        exe, scope = fluid.Executor(), fluid.Scope()
        if state is None:
            exe.run(startup, scope=scope)
            state = {n: scope.find_var(n).clone()
                     for n in scope.local_var_names()}
        else:
            for n, v in state.items():
                scope.set_var(n, v.clone())
        vals = [f.value for f in exe.run(
            main, feed=feed, fetch_list=[total] + grads, scope=scope,
            return_numpy=False)]
        out[impl] = (float(vals[0].reshape(-1)[0]),
                     dict(zip(grads, (v.float() for v in vals[1:]))),
                     scale_state(scope, dec))
    lk, gk, sk = out["auto"]
    lp, gp, sp = out["reference"]
    grad_err = {n: float((gk[n] - gp[n]).norm()
                         / gp[n].norm().clamp_min(1e-30)) for n in gp}
    finite = all(bool(torch.isfinite(g).all()) for g in gk.values())
    res = {"leg": "d", "loss_kernel": lk, "loss_plain": lp,
           "loss_rel_err": abs(lk - lp) / abs(lp),
           "max_grad_rel_err": max(grad_err.values()),
           "scale_states": [sk, sp], "grads_finite": finite,
           "tol": {"loss": BERT_CHECK_LOSS_RTOL,
                   "grads": BERT_CHECK_GRAD_RTOL},
           "seconds": time.perf_counter() - t0}
    emit(dict(res, phase="fluid_bert_fp16_lamb_leg"))
    check(finite and sk == sp and math.isfinite(lk)
          and res["loss_rel_err"] <= BERT_CHECK_LOSS_RTOL
          and res["max_grad_rel_err"] <= BERT_CHECK_GRAD_RTOL,
          "fluid_bert_fp16_lamb d: kernels vs plain: %s" % res)
    return res


def f16_leg_e(torch, fluid):
    """LAMB with global-norm clipping in fp32 (AMP off) on the card and on
    the CPU from one startup state, at BertConfig.tiny's widths (2 layers,
    hidden 64), S 32, batch 4, dropout 0: the losses and the fetched
    global norm of 3 steps within 1e-4 relative."""
    from paddle_tpu_torch.models import bert

    t0 = time.perf_counter()
    e = F16_E
    cfg = bert.BertConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    feed = bert.bert_feed(cfg, e["batch"], e["seq"])
    main, startup, total, _, _, norm = build_fluid_bert_f16(
        fluid, cfg, e["seq"], False, amp=False)
    runs, state = {}, None
    for where in ("card", "cpu"):
        exe = fluid.Executor() if where == "card" else \
            fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        if state is None:
            exe.run(startup, scope=scope)
            state = {n: scope.find_var(n).detach().cpu().clone()
                     for n in scope.local_var_names()}
        else:
            for n, v in state.items():
                scope.set_var(n, v.clone())
        runs[where] = [[float(v.reshape(-1)[0]) for v in exe.run(
            main, feed=feed, fetch_list=[total, norm], scope=scope)]
            for _ in range(e["steps"])]
    errs = [abs(a - b) / max(abs(b), 1e-30) for ra, rb in
            zip(runs["card"], runs["cpu"]) for a, b in zip(ra, rb)]
    res = {"leg": "e", "card": runs["card"], "cpu": runs["cpu"],
           "max_rel_err": max(errs), "tol": e["rtol"],
           "seconds": time.perf_counter() - t0}
    emit(dict(res, phase="fluid_bert_fp16_lamb_leg"))
    check(res["max_rel_err"] <= e["rtol"],
          "fluid_bert_fp16_lamb e: card vs CPU %s" % res)
    return res


def phase_fluid_bert_fp16_lamb(torch, name):
    """Phase 17: BERT-base pretraining under float16 AMP O2 with dynamic
    loss scaling, LAMB and global-norm clipping (legs a, b), the overflow
    under replay (c), kernels vs plain (d), card vs CPU (e)."""
    from paddle_tpu_torch import fluid

    t0 = time.perf_counter()
    legs = [f16_leg(torch, fluid, leg) for leg in F16_LEGS]
    res = {"phase": "fluid_bert_fp16_lamb",
           "config": "BERT-base (BertConfig.base)",
           "optimizer": "LAMB 1e-4 (wd 0.01), GradientClipByGlobalNorm(1.0),"
                        " float16 AMP O2, dynamic loss scaling from 2^15",
           "legs": legs, "leg_c": f16_leg_c(torch, fluid),
           "leg_d": f16_leg_d(torch, fluid), "leg_e": f16_leg_e(torch, fluid)}
    emit({"phase": "fluid_bert_fp16_lamb", "device": name,
          "nvidia_smi": nvidia_smi_line(),
          "median_step_ms": {leg["leg"]: leg["median_step_ms"]
                             for leg in legs},
          "seconds": time.perf_counter() - t0})
    return res


# -- phase 18 -----------------------------------------------------------------

def build_large_batch(fluid, cfg, seq, recompute=True, k=LB_K,
                      attention_impl="auto"):
    """Large-batch BERT pretraining as Paddle's fleet runs it, in fresh
    programs: `bert_pretrain_loss` (the unrolled encoder, its 12 layer
    outputs collected by `checkpoints_out`), LAMB (`LB_LAMB`, the
    reference's exclusions from weight decay) with
    `GradientClipByGlobalNorm`, through `fleet.distributed_optimizer` at
    one worker with the `recompute` (checkpoints: the layer outputs),
    `gradient_merge` (k steps, avg), `lamb` (the optimizer is LAMB
    already) and `amp` (bf16 O2, no loss scaling) knobs. Returns (main,
    startup, total loss, gradient names, the knobs applied)."""
    from paddle_tpu_torch import fleet
    from paddle_tpu_torch.models import bert

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = BERT_INIT_SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ckpts = []
        total, _, _, _ = bert.bert_pretrain_loss(
            cfg, seq, checkpoints_out=ckpts, attention_impl=attention_impl)
        st = fleet.DistributedStrategy()
        st.recompute = recompute
        st.recompute_configs = {"checkpoints": ckpts}
        st.gradient_merge = True
        st.gradient_merge_configs = {"k_steps": k, "avg": True}
        st.lamb = True
        st.amp = True
        st.amp_configs = {"amp_dtype": "bfloat16", "amp_level": "O2",
                          "use_dynamic_loss_scaling": False}
        opt = fleet.distributed_optimizer(fluid.optimizer.LambOptimizer(
            learning_rate=LB_LAMB["lr"],
            lamb_weight_decay=LB_LAMB["weight_decay"],
            exclude_from_weight_decay_fn=bert.exclude_from_weight_decay,
            grad_clip=fluid.clip.GradientClipByGlobalNorm(
                LB_LAMB["clip"])), st)
        _, params_grads = opt.minimize(total)
    return (main, startup, total, [g.name for _, g in params_grads],
            opt._applied_meta_list)


def lb_cfg(layers=None, dropout=None):
    cfg = bert_cfg(LB_A["seq"], layers)
    if dropout is not None:
        cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = dropout
    return cfg


def lb_counts():
    """The flash and dropout kernels' launch counters."""
    from paddle_tpu_torch.ops.kernels import dropout, \
        flash_attention as fa

    return {"forward": fa.fwd_launches, "dkv": fa.dkv_launches,
            "dq": fa.dq_launches, "dropout": dropout.launches,
            "tensor_cores": dict(fa.tc_launches)}


def lb_zero():
    from paddle_tpu_torch.ops.kernels import dropout

    zero_attention_launches()
    dropout.launches = 0


def lb_leg_a(torch, fluid):
    """Leg a: BERT-base at S 4096, micro-batch 8, dropout 0.1, k 4 on the
    card: 3 windows (12 micro-steps; the accumulating step captured at
    its second run, the applying one at its second, in the second
    window), the launch counts and peak memory over the third window,
    then one profiled micro-step."""
    from paddle_tpu_torch.models import bert

    t0 = time.perf_counter()
    cfg = lb_cfg()
    L, k = cfg.num_hidden_layers, LB_K
    main, startup, total, _, applied = build_large_batch(
        fluid, cfg, LB_A["seq"])
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = bert.bert_feed(cfg, LB_A["batch"], LB_A["seq"])
    n_pred = feed["mask_pos"].shape[1]

    def step():
        return float(exe.run(main, feed=feed, fetch_list=[total],
                             scope=scope)[0][0])

    losses, step_ms, kinds = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(3 * k):
        if i == 2 * k:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            lb_zero()
        s0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - s0) * 1e3)
        kinds.append("apply" if (i + 1) % k == 0 else "accumulate")
        if i == 0:
            # the first micro-step runs eagerly: its peak is the working
            # set, where a replay's lives in its graph's pool
            eager_peak = torch.cuda.max_memory_allocated()
    window = lb_counts()
    peak = torch.cuda.max_memory_allocated()
    info = exe.last_entry.info()
    busy, wall, kernels = device_busy_share(torch, step)
    acc_ms = [ms for i, ms in enumerate(step_ms)
              if i >= k and kinds[i] == "accumulate"]
    median_s = statistics.median(acc_ms) / 1e3
    apply_ms = step_ms[-1]
    window_s = (k - 1) * median_s + apply_ms / 1e3
    tokens = k * LB_A["batch"] * LB_A["seq"]
    flops = bert_model_flops(cfg, LB_A["batch"], LB_A["seq"], n_pred)
    # a micro-step runs each layer's attention forward twice (the
    # recompute), dK/dV and dQ once; the embeddings' dropout and two a
    # layer, again in the recompute
    want = {"forward": 2 * L * k, "dkv": L * k, "dq": L * k,
            "dropout": 2 * (1 + 2 * L) * k}
    res = {"leg": "a", "seq": LB_A["seq"], "micro_batch": LB_A["batch"],
           "k_steps": k, "layers": L, "dropout": cfg.hidden_dropout_prob,
           "knobs_applied": applied, "tokens_per_optimizer_step": tokens,
           "losses": losses, "step_ms": step_ms, "step_kinds": kinds,
           "median_micro_step_ms": median_s * 1e3, "apply_step_ms": apply_ms,
           "tokens_per_sec": tokens / window_s,
           "model_flops_per_micro_step": flops,
           "mfu_vs_bf16_peak": flops / median_s / BF16_FLOPS_PER_S,
           "peak_mem_bytes": peak, "eager_micro_step_peak_bytes": eager_peak,
           "graph_pool_bytes": {st["kind"]: st.get("pool_bytes") for st in
                                info["gradient_merge"]["steps"]},
           "launches_per_micro_step": {
               n: window[n] / k for n in ("forward", "dkv", "dq",
                                          "dropout")},
           "launches_window": window, "launches_expected": want,
           "profiled_micro_step": {"wall_us": wall, "device_busy_us": busy,
                                   "device_busy_share": busy / wall,
                                   "kernels": kernels},
           "entry": info, "seconds": time.perf_counter() - t0}
    emit({"phase": "bert_large_batch_leg", **res})
    first_want = math.log(cfg.vocab_size) + math.log(2)
    check(all(math.isfinite(x) for x in losses),
          "large batch a: non-finite loss %s" % losses)
    check(abs(losses[0] - first_want) <= BERT_LOSS0_TOL,
          "large batch a: first loss %g, expected %g" % (losses[0],
                                                         first_want))
    # the lamb knob leaves a LAMB optimizer as it is
    check(applied == ["recompute", "gradient_merge", "amp"],
          "large batch a: knobs applied %s" % applied)
    check({n: window[n] for n in want} == want
          and window["tensor_cores"] == {n: want[n] for n in
                                         ("forward", "dkv", "dq")},
          "large batch a: launches %s, expected %s" % (window, want))
    check([s["phase"] for s in info["gradient_merge"]["steps"]]
          == ["captured", "captured"],
          "large batch a: the window's steps are %s, not captured" % info)
    del exe, scope
    torch.cuda.empty_cache()
    return res


def lb_state(scope):
    """A clone of every scope value (a start state on the card)."""
    return {n: scope.find_var(n).clone() for n in scope.local_var_names()}


def lb_scope(fluid, state):
    scope = fluid.Scope()
    for n, v in state.items():
        scope.set_var(n, v.clone())
    return scope


def lb_quarter(feed, i, n):
    """Micro-batch i of n of a feed (rows split along the batch)."""
    rows = next(iter(feed.values())).shape[0] // n
    return {name: v[i * rows:(i + 1) * rows] for name, v in feed.items()}


def lb_recompute_gate(torch, fluid, feed, state_of):
    """Gate 1: one step of the 4-layer program with and without
    recompute (k 1, dropout 0.1) from one start: loss and every
    gradient bit-equal; the peaks; the forward kernel's launches."""
    out = {}
    for rc in (False, True):
        main, startup, total, grads, _ = build_large_batch(
            fluid, lb_cfg(LB_B["layers"]), LB_A["seq"], recompute=rc, k=1)
        exe = fluid.Executor()
        scope = state_of(exe, startup)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lb_zero()
        vals = [f.value for f in exe.run(
            main, feed=feed, fetch_list=[total] + grads, scope=scope,
            return_numpy=False)]
        torch.cuda.synchronize()
        out[rc] = {"loss": vals[0].clone(), "grads": dict(zip(grads, (
            v.clone() for v in vals[1:]))), "launches": lb_counts(),
            "peak": torch.cuda.max_memory_allocated()}
        exe.close()
        del exe, scope
        torch.cuda.empty_cache()
    a, b = out[False], out[True]
    differ = [n for n in a["grads"] if not torch.equal(a["grads"][n],
                                                       b["grads"][n])]
    L = LB_B["layers"]
    res = {"loss_plain": float(a["loss"].reshape(-1)[0]),
           "loss_recompute": float(b["loss"].reshape(-1)[0]),
           "bit_equal": torch.equal(a["loss"], b["loss"]) and not differ,
           "grads_differing": differ[:5],
           "max_grad_abs_diff": max((max_abs_diff(a["grads"][n],
                                                  b["grads"][n])
                                     for n in differ), default=0.0),
           "peak_plain_bytes": a["peak"], "peak_recompute_bytes": b["peak"],
           "peak_drop_bytes": a["peak"] - b["peak"],
           "forward_launches": {"plain": a["launches"]["forward"],
                                "recompute": b["launches"]["forward"]},
           "dropout_launches": {"plain": a["launches"]["dropout"],
                                "recompute": b["launches"]["dropout"]}}
    check(res["bit_equal"], "large batch b1: recompute against none: %s"
          % res)
    check(res["forward_launches"] == {"plain": L, "recompute": 2 * L},
          "large batch b1: forward launches %s" % res["forward_launches"])
    check(res["peak_drop_bytes"] > 0, "large batch b1: recompute does not "
          "lower the peak: %s" % res)
    return res


def lb_merge_gate(torch, fluid, feed, state_of):
    """Gate 2: k 4 x micro-batch 2 against k 1 x batch 8 (dropout 0):
    the accumulating steps leave every param, master and moment bit-equal;
    after the apply the fp32 masters, as one vector, agree within bf16's
    rtol, relative in norm; the updates' difference is reported."""
    cfg = lb_cfg(LB_B["layers"], dropout=0.0)
    res = {}
    finals = {}
    for k in (LB_K, 1):
        main, startup, total, _, _ = build_large_batch(
            fluid, cfg, LB_A["seq"], k=k)
        exe = fluid.Executor()
        scope = state_of(exe, startup)
        start = lb_state(scope)
        names = sorted(v.name for v in main.list_vars() if v.persistable
                       and "@GRAD@MERGE" not in v.name
                       and "gradient_merge_counter" not in v.name)
        still = True
        for i in range(k):
            exe.run(main, feed=lb_quarter(feed, i, k), fetch_list=[total],
                    scope=scope)
            if i < k - 1:
                still = still and all(torch.equal(scope.find_var(n),
                                                  start[n]) for n in names)
        if k > 1:
            res["off_steps_bit_equal"] = still
        finals[k] = ({n: scope.find_var(n).float().clone() for n in names},
                     {n: start[n].float() for n in names})
        exe.close()
        del exe, scope
        torch.cuda.empty_cache()
    (got, start), (want, _) = finals[LB_K], finals[1]
    # the fp32 masters as one vector (ROADMAP Queue 3 by-design 8: where
    # a gradient is zero in exact arithmetic, the attention key biases',
    # LAMB turns rounding noise into full steps of either sign)
    masters = [n for n in want if n.endswith("@MASTER")]

    def flat(vals, minus=None):
        return torch.cat([(vals[n] - (0 if minus is None else minus[n]))
                          .reshape(-1) for n in masters])

    g, w = flat(got), flat(want)
    du, dw = flat(got, start), flat(want, start)
    res.update(param_rel_err=float((g - w).norm() / w.norm()),
               update_rel_diff=float((du - dw).norm() / dw.norm()),
               tol=LB_B["rtol"])
    check(res["off_steps_bit_equal"], "large batch b2: an accumulating "
          "step moved the state")
    check(res["param_rel_err"] <= LB_B["rtol"], "large batch b2: k 4 x 2 "
          "against 1 x 8: params %g apart" % res["param_rel_err"])
    return res


def lb_capture_gate(torch, fluid, feed, state_of):
    """Gate 3: the k 4 x 2 program (dropout 0.1), 8 micro-steps captured
    and eagerly from one start and one seed counter, with a `fluid.save`
    after step 6 (the middle of the second window) and steps 7-8 run again
    after a `fluid.load` of it: every loss and persistable bit-equal."""
    import shutil
    import tempfile

    from paddle_tpu_torch.fluid import io

    cfg = lb_cfg(LB_B["layers"])
    main, startup, total, _, _ = build_large_batch(fluid, cfg, LB_A["seq"])
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    seed0 = main._seed_counter
    out_dir = tempfile.mkdtemp(prefix="large_batch_")
    runs = {}
    try:
        state = None
        for graphs in (True, False):
            graph_flag(fluid, graphs)
            exe = fluid.Executor()
            if state is None:
                scope = state_of(exe, startup)
                state = lb_state(scope)
            else:
                scope = lb_scope(fluid, state)
            main._seed_counter = seed0
            feeds = [lb_quarter(feed, i % LB_K, LB_K) for i in range(8)]

            def steps(fs):
                return [host_bits(exe.run(main, feed=f, fetch_list=[total],
                                          scope=scope,
                                          return_numpy=False)[0].value)
                        for f in fs]

            losses = steps(feeds[:6])
            path = os.path.join(out_dir, "g" if graphs else "e", "bert")
            with fluid.scope_guard(scope):
                io.save(main, path)
            seed_at_save = main._seed_counter
            losses += steps(feeds[6:])
            digests = {n: digest(scope.find_var(n)) for n in names}
            with fluid.scope_guard(scope):
                io.load(main, path, exe)
            main._seed_counter = seed_at_save
            again = steps(feeds[6:])
            runs[graphs] = {
                "losses": losses, "digests": digests,
                "reloaded_equal": all(
                    (a == b).all() for a, b in zip(again, losses[6:]))
                and {n: digest(scope.find_var(n)) for n in names}
                == digests,
                "info": exe.last_entry.info()}
            exe.close()
            del exe, scope
            torch.cuda.empty_cache()
    finally:
        graph_flag(fluid, True)
        shutil.rmtree(out_dir, ignore_errors=True)
    g, e = runs[True], runs[False]
    res = {"steps": 8, "save_after_step": 6,
           "losses_bit_equal": all((a == b).all() for a, b in
                                   zip(g["losses"], e["losses"])),
           "state_bit_equal": g["digests"] == e["digests"],
           "reload_repeats": {"graph": g["reloaded_equal"],
                              "eager": e["reloaded_equal"]},
           "graph_steps": [s["phase"] for s in
                           g["info"]["gradient_merge"]["steps"]],
           "eager_reason": e["info"]["reason"]}
    check(res["losses_bit_equal"] and res["state_bit_equal"],
          "large batch b3: captured against eager: %s" % res)
    check(all(res["reload_repeats"].values()), "large batch b3: after "
          "fluid.load: %s" % res)
    check(res["graph_steps"] == ["captured", "captured"],
          "large batch b3: %s" % res)
    return res


def lb_kernels_vs_plain(torch, fluid, feed, state_of):
    """The flash kernels under recompute at leg b's shape against their
    plain version (`attention_impl="reference"`): one step (k 1) from one
    start, loss within 1e-2 and every gradient within 2e-2 relative in
    norm (phase 8 leg c's bounds) but the key projections' biases, whose
    gradient is rounding noise (reported beside, against the query
    biases' norms)."""
    out = {}
    for impl in ("auto", "reference"):
        main, startup, total, grads, _ = build_large_batch(
            fluid, lb_cfg(LB_B["layers"]), LB_A["seq"], k=1,
            attention_impl=impl)
        exe = fluid.Executor()
        scope = state_of(exe, startup)
        vals = [f.value for f in exe.run(
            main, feed=feed, fetch_list=[total] + grads, scope=scope,
            return_numpy=False)]
        out[impl] = (float(vals[0].reshape(-1)[0]),
                     dict(zip(grads, (v.float() for v in vals[1:]))))
        exe.close()
        del exe, scope
        torch.cuda.empty_cache()
    (lk, gk), (lp, gp) = out["auto"], out["reference"]
    err = {n: float((gk[n] - gp[n]).norm() / gp[n].norm().clamp_min(1e-30))
           for n in gp}
    # a key projection's bias has a gradient of zero in exact arithmetic
    # (softmax is blind to a shift along the keys): its values are
    # rounding noise of either side (ROADMAP Queue 3 by-design 8)
    noise = [n for n in gp if "_attn_k.b" in n]
    worst = sorted(err, key=err.get, reverse=True)[:3]
    res = {"loss_kernel": lk, "loss_plain": lp,
           "loss_rel_err": abs(lk - lp) / abs(lp),
           "max_grad_rel_err": max(v for n, v in err.items()
                                   if n not in noise),
           "worst_grads": {n: err[n] for n in worst},
           "key_bias_grad_norm_vs_query_bias": max(
               float(gp[n].norm() / gp[n.replace("_attn_k.b", "_attn_q.b")]
                     .norm().clamp_min(1e-30)) for n in noise),
           "tol": {"loss": BERT_CHECK_LOSS_RTOL,
                   "grads": BERT_CHECK_GRAD_RTOL}}
    check(math.isfinite(lk) and res["loss_rel_err"] <= BERT_CHECK_LOSS_RTOL
          and res["max_grad_rel_err"] <= BERT_CHECK_GRAD_RTOL,
          "large batch: kernels vs plain under recompute: %s" % res)
    return res


def lb_leg_b(torch, fluid):
    """Leg b: the gates at 4 layers (the same widths), micro-batch 8."""
    from paddle_tpu_torch.models import bert

    t0 = time.perf_counter()
    feed = bert.bert_feed(lb_cfg(LB_B["layers"]), LB_A["batch"],
                          LB_A["seq"])
    state = {}

    def state_of(exe, startup):
        """A scope holding the one start state (the first program's
        startup; every program of the leg has the same persistables but
        the window's accumulators, counter and the recompute-free
        variants', which the startup fills alike)."""
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        for n, v in state.items():
            if scope.find_var(n) is not None:
                scope.set_var(n, v.clone())
        if not state:
            state.update(lb_state(scope))
        return scope

    res = {"leg": "b", "layers": LB_B["layers"], "seq": LB_A["seq"],
           "batch": LB_A["batch"],
           "recompute_vs_none": lb_recompute_gate(torch, fluid, feed,
                                                  state_of),
           "merge_vs_batch": lb_merge_gate(torch, fluid, feed, state_of),
           "captured_vs_eager": lb_capture_gate(torch, fluid, feed,
                                                state_of),
           "kernels_vs_plain": lb_kernels_vs_plain(torch, fluid, feed,
                                                   state_of),
           "seconds": time.perf_counter() - t0}
    emit({"phase": "bert_large_batch_leg", **res})
    return res


def lb_mlp(fluid):
    """The MNIST MLP (phase 7's) under Lookahead (k 5) over the local DGC
    momentum (ramp-up at step 3), an EMA (decay 0.9) and a ModelAverage
    (a window of 3): (main, startup, loss, accuracy, ema, average)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = FLUID_INIT_SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data(name="img", shape=[784], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=img, size=128, act="relu")
        h = fluid.layers.fc(input=h, size=64, act="relu")
        logits = fluid.layers.fc(input=h, size=10, act=None)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        acc = fluid.layers.accuracy(input=fluid.layers.softmax(logits),
                                    label=label)
        fluid.optimizer.LookaheadOptimizer(
            fluid.optimizer.DGCMomentumOptimizer(
                learning_rate=0.1, momentum=0.9, rampup_begin_step=3,
                sparsity=[0.75]), alpha=0.5, k=5).minimize(loss)
        ema = fluid.optimizer.ExponentialMovingAverage(0.9)
        ema.update()
        avg = fluid.optimizer.ModelAverage(0.15, min_average_window=1,
                                           max_average_window=3)
    return main, startup, loss, acc, ema, avg


def lb_leg_c(torch, fluid):
    """Leg c: the MNIST MLP of `lb_mlp` on the card (captured) and on the
    CPU from the same params: 6 steps, the EMA's and the ModelAverage's
    apply()/restore() (applied params compared; the scope's tensors the
    same objects throughout), 4 more steps; losses and applied params
    within 1e-4."""
    from paddle_tpu_torch.core.scope import dump_numpy_state, \
        load_numpy_state

    out = {}
    state = None
    x, y = fluid_mnist_data()
    starts = [(i * FLUID_BATCH) % (len(x) - FLUID_BATCH)
              for i in range(LB_C_STEPS)]
    feeds = [{"img": x[i:i + FLUID_BATCH], "label": y[i:i + FLUID_BATCH]}
             for i in starts]
    for where in ("cuda", "cpu"):
        main, startup, loss, acc, ema, avg = lb_mlp(fluid)
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        params = [p.name for p in main.all_parameters()]
        exe = fluid.Executor(None if where == "cuda" else fluid.CPUPlace())
        scope = fluid.Scope()
        if state is None:
            exe.run(startup, scope=scope)
            state = dump_numpy_state(scope, names)
        else:
            load_numpy_state(scope, state, "cpu")
        rec = {"losses": []}
        with fluid.scope_guard(scope):
            for i, f in enumerate(feeds):
                rec["losses"].append(float(exe.run(
                    main, feed=f, fetch_list=[loss], scope=scope)[0][0]))
                if i == LB_C_STEPS // 2:
                    bufs = {n: scope.find_var(n) for n in names}
                    for tag, swap in (("ema", ema), ("average", avg)):
                        live = {n: bufs[n].clone() for n in params}
                        with swap.apply(exe):
                            rec[tag] = {n: scope.find_var(n).cpu().clone()
                                        for n in params}
                        rec[tag + "_restored"] = all(
                            torch.equal(scope.find_var(n), live[n])
                            for n in params)
                    rec["same_tensors"] = all(
                        scope.find_var(n) is v for n, v in bufs.items())
        rec["info"] = exe.last_entry.info()
        rec["final"] = {n: scope.find_var(n).cpu().clone() for n in params}
        out[where] = rec
    card, cpu = out["cuda"], out["cpu"]

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    res = {"leg": "c", "model": "MNIST MLP 784-128-64-10",
           "optimizer": "Lookahead(k 5, alpha 0.5) over DGC momentum "
           "(local, ramp-up at step 3); EMA 0.9; ModelAverage window 3",
           "losses_card": card["losses"], "losses_cpu": cpu["losses"],
           "loss_max_rel_err": max(abs(a - b) / abs(b) for a, b in
                                   zip(card["losses"], cpu["losses"])),
           "applied_max_rel_err": max(rel(card[t][n], cpu[t][n])
                                      for t in ("ema", "average")
                                      for n in card[t]),
           "final_max_rel_err": max(rel(card["final"][n], cpu["final"][n])
                                    for n in card["final"]),
           "restored_bit_equal": card["ema_restored"]
           and card["average_restored"],
           "scope_tensors_kept": card["same_tensors"],
           "card_phase": card["info"]["phase"], "tol": LB_C_RTOL}
    emit({"phase": "bert_large_batch_leg", **res})
    check(res["loss_max_rel_err"] <= LB_C_RTOL
          and res["applied_max_rel_err"] <= LB_C_RTOL
          and res["final_max_rel_err"] <= LB_C_RTOL,
          "large batch c: card against CPU: %s" % res)
    check(res["restored_bit_equal"] and res["scope_tensors_kept"]
          and res["card_phase"] == "captured",
          "large batch c: apply/restore on the captured step: %s" % res)
    return res


def lb_leg_d(torch, fluid):
    """Leg d: the slice's new op types at the CPU tests' shapes
    (tests/torch_tensor_cases.py), the card against the CPU:
    deterministic types within fp32 1e-5 (integer, index and bool
    outputs exact), and those that a CUDA graph can capture
    (tests/torch_case_runner.py capturable) again from one replay of a
    graph captured around them and their gradients, bit-equal to eager;
    random types by shape and dtype, one seed repeating
    its draws bit for bit, and the moments of a few against their
    distributions."""
    import numpy as np

    cr, tc = tests_modules("torch_case_runner", "torch_tensor_cases")
    dev = torch.device("cuda")

    def run(op, ins, attrs, device):
        return cr.run_case(op, ins, attrs, device, seed=7)

    worst, bad, captured = 0.0, [], 0
    for name, case in sorted(tc.CASES.items()):
        ins = tc.inputs(name)
        got = run(case[0], ins, case[2], dev)
        err, _, faults = cr.compare(got, run(case[0], ins, case[2], "cpu"),
                                    1e-5)
        worst = max(worst, err)
        bad += [(name,) + f for f in faults]
        if cr.capturable(case[0]):
            try:
                graph = cr.capture_case(case[0], ins, case[2], dev, case[3],
                                        seed=7)
            except RuntimeError as e:
                bad.append((name, "capture", str(e).splitlines()[0][:200]))
            else:
                captured += 1
                eager = cr.run_case(case[0], ins, case[2], dev, case[3],
                                    seed=7)
                bad += [(name, "captured") + f
                        for f in cr.compare(graph, eager, 0.0)[2]]
    rng = {}
    for name, (makers, attrs) in sorted(tc.RNG_CASES.items()):
        ins = tc.inputs(name, tc.RNG_CASES)
        a, b = (run(name, ins, attrs, dev)[0] for _ in range(2))
        c = run(name, ins, attrs, "cpu")[0]
        rng[name] = {"shape": list(a.shape), "dtype": str(a.dtype),
                     "repeats": torch.equal(a, b),
                     "like_cpu": a.dtype == c.dtype and a.shape == c.shape}
        if not (rng[name]["repeats"] and rng[name]["like_cpu"]):
            bad.append((name, "Out", rng[name]))
    n = LB_D_DRAWS
    u = run("uniform_random_batch_size_like",
            {"Input": [np.zeros((n, 1), "float32")]},
            {"shape": [-1, 1], "min": -1.0, "max": 1.0}, dev)[0]
    k = run("poisson", {"X": [np.full((n,), 30.0, "float32")]}, {},
            dev)[0]
    g = run("gaussian_random_batch_size_like",
            {"Input": [np.zeros((n, 1), "float32")]},
            {"shape": [-1, 1], "mean": 0.0, "std": 1.0}, dev)[0]
    moments = {"uniform_mean": float(u.mean()),
               "uniform_range": [float(u.min()), float(u.max())],
               "normal_mean": float(g.mean()), "normal_std": float(g.std()),
               "poisson30_mean": float(k.mean()),
               "poisson30_var": float(k.var())}
    se = 6.0 / math.sqrt(n)
    moments_ok = (abs(moments["uniform_mean"]) <= se * 0.58
                  and -1.0 <= moments["uniform_range"][0]
                  and moments["uniform_range"][1] < 1.0
                  and abs(moments["normal_mean"]) <= se
                  and abs(moments["normal_std"] - 1.0) <= 0.02
                  and abs(moments["poisson30_mean"] - 30.0) <= se * 5.5
                  and abs(moments["poisson30_var"] / 30.0 - 1.0) <= 0.06)
    res = {"leg": "d", "deterministic_cases": len(tc.CASES),
           "captured_cases": captured,
           "random_types": len(tc.RNG_CASES), "max_abs_err": worst,
           "tol": "fp32 1e-5 x (1 + max |value|); integers exact; "
           "captured (with gradients) bit-equal to eager",
           "random": rng, "moments": moments, "moments_ok": moments_ok,
           "failures": bad[:10]}
    emit({"phase": "bert_large_batch_leg", **res})
    check(not bad, "large batch d: card against CPU or captured against "
          "eager: %s" % bad[:10])
    check(moments_ok, "large batch d: moments %s" % moments)
    return res


def phase_bert_large_batch(torch, name):
    """Phase 18: large-batch BERT pretraining as Paddle's fleet runs it
    (recompute and gradient merge over the flash kernels), with
    ``FLAGS_cudnn_deterministic`` on."""
    from paddle_tpu_torch import fluid

    t0 = time.perf_counter()
    before = fluid.get_flags("FLAGS_cudnn_deterministic")
    os.environ["FLAGS_cudnn_deterministic"] = "1"
    fluid.set_flags({"FLAGS_cudnn_deterministic": True})
    try:
        res = {"leg_a": lb_leg_a(torch, fluid),
               "leg_b": lb_leg_b(torch, fluid),
               "leg_c": lb_leg_c(torch, fluid),
               "leg_d": lb_leg_d(torch, fluid)}
    finally:
        fluid.set_flags(before)
        os.environ.pop("FLAGS_cudnn_deterministic", None)
    a = res["leg_a"]
    emit({"phase": "bert_large_batch", "device": name,
          "nvidia_smi": nvidia_smi_line(),
          "median_micro_step_ms": a["median_micro_step_ms"],
          "apply_step_ms": a["apply_step_ms"],
          "tokens_per_sec": a["tokens_per_sec"],
          "peak_mem_bytes": a["peak_mem_bytes"],
          "eager_micro_step_peak_bytes": a["eager_micro_step_peak_bytes"],
          "seconds": time.perf_counter() - t0})
    return res


# -- phase 19 -----------------------------------------------------------------

def tests_modules(*names):
    """The numpy case tables and helpers kept beside the port's tests
    (they import no JAX)."""
    import importlib

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if here not in sys.path:
        sys.path.insert(0, here)
    return [importlib.import_module(n) for n in names]


def book_state(fluid, book):
    """The startup's persistables on the card (name -> tensor)."""
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(book.startup, scope=scope)
    state = {n: scope.find_var(n).clone() for n in sorted(
        v.name for v in book.main.list_vars() if v.persistable)}
    exe.close()
    return state


def book_cpu_run(torch, fluid, book, state, feeds, fetch):
    """The steps on the CPU from `state` (moved there): the fetches of
    each step (numpy)."""
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    for n, v in state.items():
        scope.set_var(n, v.cpu().clone())
    out = [exe.run(book.main, feed=f, fetch_list=fetch, scope=scope)
           for f in feeds]
    exe.close()
    return out


def rel_err(a, b):
    """|a - b| / |b| in norm (numpy or tensors, as float64)."""
    import numpy as np

    a, b = (np.asarray(v.cpu() if hasattr(v, "cpu") else v, "float64")
            for v in (a, b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def book_leg_a(torch, fluid, bp):
    """Leg a: understand_sentiment's stacked LSTM at the book's widths,
    T 256, batch 128, every row full, Adagrad: trained captured (the
    first step eager, the second captured, then replays) and, from the
    same state, eagerly; step times, capture, busy share, kernels a
    replay, peak memory, the graph pool."""
    import numpy as np

    seq, batch = BOOK_A["seq"], BOOK_A["batch"]
    book = bp.understand_sentiment(fluid, seq)
    state = book_state(fluid, book)
    rng = np.random.RandomState(0)
    feeds = [book.feed(batch, rng) for _ in range(BOOK_A["graph_steps"])]
    torch.cuda.reset_peak_memory_stats()
    graph = fluid_run(torch, fluid, book.main, state, feeds, [book.loss],
                      True)
    peak = torch.cuda.max_memory_allocated()
    busy, wall, kernels = device_busy_share(
        torch, lambda: graph["exe"].run(book.main, feed=feeds[-1],
                                        fetch_list=[book.loss],
                                        scope=graph["scope"]))
    info = graph["info"]
    graph["exe"].close()
    del graph["exe"], graph["scope"]
    eager = fluid_run(torch, fluid, book.main, state,
                      feeds[:BOOK_A["eager_steps"]], [book.loss], False)
    eager["exe"].close()
    del eager["exe"], eager["scope"]
    losses = [float(f[0].reshape(-1)[0]) for f in graph["fetches"]]
    replay_ms = statistics.median(graph["step_ms"][2:])
    eager_ms = statistics.median(eager["step_ms"][1:])
    res = {"leg": "a", "model": "understand_sentiment stacked_lstm_net",
           "widths": dict(bp.SENTIMENT, seq=seq, batch=batch),
           "lstm_steps_a_step": seq * bp.SENTIMENT["stacked"],
           "mode": info["mode"], "entry_phase": info["phase"],
           "losses": losses, "eager_losses": [
               float(f[0].reshape(-1)[0]) for f in eager["fetches"]],
           "graph_step_ms": graph["step_ms"], "eager_step_ms":
           eager["step_ms"], "captured_step_ms": replay_ms,
           "eager_step_median_ms": eager_ms,
           "first_eager_step_ms": graph["step_ms"][0],
           "capture_step_ms": graph["step_ms"][1],
           "capture_ms": info.get("capture_ms"),
           "pool_bytes": info.get("pool_bytes"),
           "tokens_per_sec": batch * seq / (replay_ms / 1e3),
           "eager_tokens_per_sec": batch * seq / (eager_ms / 1e3),
           "replay": {"wall_us": wall, "device_busy_us": busy,
                      "device_busy_share": busy / wall, "kernels": kernels},
           "peak_mem_bytes": peak}
    del graph, eager, state
    torch.cuda.empty_cache()
    emit({"phase": "book_leg", **res})
    check(info["mode"] == "graph" and info["phase"] == "captured",
          "book a: the step is %s (%s), not captured" % (info["mode"],
                                                         info["reason"]))
    check(all(math.isfinite(x) for x in losses + res["eager_losses"]),
          "book a: losses %s" % losses)
    check(abs(losses[0] - math.log(2.0)) < 0.5,
          "book a: first loss %s against ln 2" % losses[0])
    return res


def book_grads_vs_cpu(torch, fluid, book, feeds, steps):
    """`steps` of `book` on the card (captured after the first) and on
    the CPU from one startup state, fetching the loss and every
    parameter's gradient: the largest relative difference of the losses
    and of the gradients (in norm)."""
    params = [p.name for p in book.main.all_parameters()]
    fetch = [book.loss] + [p + "@GRAD" for p in params]
    state = book_state(fluid, book)
    card = fluid_run(torch, fluid, book.main, state, feeds[:steps], fetch,
                     True)
    card["exe"].close()
    cpu = book_cpu_run(torch, fluid, book, state, feeds[:steps], fetch)
    loss = max(rel_err(a[0], b[0]) for a, b in zip(card["fetches"], cpu))
    grad = max(rel_err(x, y) for a, b in zip(card["fetches"], cpu)
               for x, y in zip(a[1:], b[1:]))
    return {"loss_rel_err": loss, "grad_rel_err": grad,
            "losses_card": [float(a[0].reshape(-1)[0])
                            for a in card["fetches"]],
            "losses_cpu": [float(b[0].reshape(-1)[0]) for b in cpu],
            "card_phase": card["info"]["phase"], "params": len(params)}


def book_leg_b(torch, fluid, bp):
    """Leg b, the gates at T 32: leg a's program captured against eager
    over 6 steps (losses and every persistable bit-equal); with ragged
    Length, the card against the CPU (losses and every gradient within
    1e-4); machine_translation's dynamic_gru program and a bidirectional
    cudnn_lstm layer over a ragged SequenceLength, the card against the
    CPU."""
    import numpy as np

    seq, batch, tol = BOOK_B["seq"], BOOK_B["batch"], BOOK_B["rtol"]
    rng = np.random.RandomState(1)
    book = bp.understand_sentiment(fluid, seq)
    feeds = [book.feed(batch, rng) for _ in range(BOOK_B["steps"])]
    state = book_state(fluid, book)
    runs = [fluid_run(torch, fluid, book.main, state, feeds, [book.loss], g)
            for g in (True, False)]
    graph, eager = runs
    for r in runs:
        r["exe"].close()
    eager_tensors = dict(run_tensors(torch, eager))
    differ = sorted(n for n, a in run_tensors(torch, graph)
                    if not torch.equal(a, eager_tensors[n]))
    res = {"leg": "b", "seq": seq, "batch": batch,
           "captured_vs_eager": {"steps": len(feeds),
                                 "mode": graph["info"]["mode"],
                                 "entry_phase": graph["info"]["phase"],
                                 "bit_equal": not differ,
                                 "differ": differ[:5]}}
    del graph, eager, runs, state
    ragged = bp.understand_sentiment(fluid, seq, ragged=True)
    rng = np.random.RandomState(2)
    res["ragged_vs_cpu"] = book_grads_vs_cpu(
        torch, fluid, ragged, [ragged.feed(batch, rng) for _ in range(2)], 2)
    mt = bp.machine_translation(fluid, **BOOK_B["translation"])
    rng = np.random.RandomState(3)
    res["gru_vs_cpu"] = book_grads_vs_cpu(
        torch, fluid, mt, [mt.feed(BOOK_B["translation_batch"], rng)
                           for _ in range(2)], 2)
    res["cudnn_lstm_vs_cpu"] = book_cudnn_lstm(torch)
    res["rtol"] = tol
    torch.cuda.empty_cache()
    emit({"phase": "book_leg", **res})
    check(res["captured_vs_eager"]["bit_equal"]
          and res["captured_vs_eager"]["entry_phase"] == "captured",
          "book b: captured against eager: %s" % res["captured_vs_eager"])
    for key in ("ragged_vs_cpu", "gru_vs_cpu"):
        check(res[key]["loss_rel_err"] <= tol
              and res[key]["grad_rel_err"] <= tol,
              "book b: %s: %s" % (key, res[key]))
    check(res["cudnn_lstm_vs_cpu"]["max_rel_err"] <= tol,
          "book b: cudnn_lstm: %s" % res["cudnn_lstm_vs_cpu"])
    return res


def book_cudnn_lstm(torch):
    """One bidirectional `cudnn_lstm` layer (T 32, batch 128, input and
    hidden 128) over ragged SequenceLength: its outputs and the
    gradients of Input, W, InitH and InitC under one seeded cotangent,
    the card against the CPU (relative, in norm)."""
    import numpy as np

    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.ops import registry

    t, b, d, h = BOOK_B["seq"], BOOK_B["batch"], 128, 128
    r = np.random.RandomState(4)
    n_w = 2 * (4 * h * d + 4 * h * h + 8 * h)
    ins = {"Input": r.randn(t, b, d), "W": r.randn(n_w) * 0.1,
           "InitH": r.randn(2, b, h), "InitC": r.randn(2, b, h)}
    lens = r.randint(1, t + 1, b)
    attrs = {"hidden_size": h, "num_layers": 1, "is_bidirec": True}
    outs = []
    for dev in (resolve_device(None), torch.device("cpu")):
        x = {k: torch.tensor(v, dtype=torch.float32, device=dev,
                             requires_grad=True) for k, v in ins.items()}
        x["SequenceLength"] = torch.tensor(lens, dtype=torch.int32,
                                           device=dev)
        o = registry.normalize_outs(registry.get_op("cudnn_lstm").compute(
            {k: [v] for k, v in x.items()}, dict(attrs, _device=dev)))
        cr = np.random.RandomState(5)
        ys = [o[s][0] for s in ("Out", "last_h", "last_c")]
        cts = [torch.tensor(cr.randn(*y.shape), dtype=torch.float32,
                            device=dev) for y in ys]
        grads = torch.autograd.grad(ys, [x[k] for k in sorted(ins)], cts)
        outs.append([y.detach() for y in ys] + list(grads))
    errs = [rel_err(a, c) for a, c in zip(*outs)]
    return {"shape": [t, b, d], "hidden": h, "max_rel_err": max(errs),
            "outputs_and_grads": len(errs)}


def book_leg_c(torch, fluid, bp):
    """Leg c: fit_a_line, recognize_digits and recommender_system, 20
    steps each, captured on the card and on the CPU from one startup
    state: losses within 1e-4 relative; recognize_digits' loss falls."""
    import numpy as np

    res = {"leg": "c", "steps": BOOK_C["steps"], "rtol": BOOK_C["rtol"]}
    for name, build in (("fit_a_line", bp.fit_a_line),
                        ("recognize_digits", bp.recognize_digits),
                        ("recommender_system", bp.recommender_system)):
        book = build(fluid)
        rng = np.random.RandomState(6)
        feeds = [book.feed(BOOK_C["batch"], rng)
                 for _ in range(BOOK_C["steps"])]
        state = book_state(fluid, book)
        card = fluid_run(torch, fluid, book.main, state, feeds, [book.loss],
                         True)
        card["exe"].close()
        cpu = book_cpu_run(torch, fluid, book, state, feeds, [book.loss])
        a = [float(f[0].reshape(-1)[0]) for f in card["fetches"]]
        b = [float(f[0].reshape(-1)[0]) for f in cpu]
        res[name] = {"losses_card": a, "losses_cpu": b,
                     "loss_max_rel_err": max(abs(x - y) / abs(y)
                                             for x, y in zip(a, b)),
                     "entry_phase": card["info"]["phase"],
                     "step_ms": statistics.median(card["step_ms"][2:])}
    emit({"phase": "book_leg", **res})
    for name in ("fit_a_line", "recognize_digits", "recommender_system"):
        check(res[name]["loss_max_rel_err"] <= BOOK_C["rtol"]
              and res[name]["entry_phase"] == "captured",
              "book c: %s: %s" % (name, res[name]))
    digits = res["recognize_digits"]["losses_card"]
    check(digits[-1] < digits[0], "book c: recognize_digits' loss %s"
          % digits)
    return res


def book_leg_d(torch, cr, cases):
    """Leg d: every case of tests/torch_nn_cases.py (the slice's 81 op
    types), the card against the CPU: each output and the gradient of
    each float input under one seeded cotangent within 1e-4 x (1 + max
    |value|), integer outputs exact; each case again from one replay of
    a CUDA graph captured around it and its gradients, bit-equal to the
    card's eager run, but for the types that read a value on the host
    (tests/torch_case_runner.py capturable); the convolution and
    pooling cases run twice on the card, bit-equal
    (FLAGS_cudnn_deterministic)."""
    from paddle_tpu_torch.core.place import resolve_device

    dev = resolve_device(None)
    worst, bad, repeats, captured = 0.0, [], {}, 0
    for name in sorted(cases.CASES):
        op, _, attrs, diff, _ = cases.CASES[name]
        ins = cases.inputs(name)
        got = cr.run_case(op, ins, attrs, dev, diff)
        _, err, faults = cr.compare(
            got, cr.run_case(op, ins, attrs, "cpu", diff), BOOK_D_RTOL)
        worst = max(worst, err)
        bad += [(name,) + f for f in faults]
        if cr.capturable(op):
            try:
                graph = cr.capture_case(op, ins, attrs, dev, diff)
            except RuntimeError as e:
                bad.append((name, "capture", str(e).splitlines()[0][:200]))
            else:
                captured += 1
                bad += [(name, "captured") + f
                        for f in cr.compare(graph, got, 0.0)[2]]
        if op in BOOK_D_REPEAT:
            again = cr.run_case(op, ins, attrs, dev, diff)
            repeats[name] = all(torch.equal(a, b)
                                for a, b in zip(got, again))
    res = {"leg": "d", "cases": len(cases.CASES),
           "types": len({c[0] for c in cases.CASES.values()}),
           "captured_cases": captured, "max_rel_err": worst,
           "tol": "%g x (1 + max |value|); integers exact; captured "
           "bit-equal to eager" % BOOK_D_RTOL, "bit_repeat": repeats,
           "failures": bad[:10]}
    emit({"phase": "book_leg", **res})
    check(not bad, "book d: card against CPU or captured against eager: "
          "%s" % bad[:10])
    check(all(repeats.values()), "book d: a repeat differs: %s" % repeats)
    return res


def phase_book(torch, name):
    """Phase 19: the Paddle book's programs on the card, with
    ``FLAGS_cudnn_deterministic`` on."""
    from paddle_tpu_torch import fluid

    bp, cr, cases = tests_modules("torch_book_programs",
                                  "torch_case_runner", "torch_nn_cases")
    t0 = time.perf_counter()
    before = fluid.get_flags("FLAGS_cudnn_deterministic")
    os.environ["FLAGS_cudnn_deterministic"] = "1"
    fluid.set_flags({"FLAGS_cudnn_deterministic": True})
    try:
        res = {"leg_a": book_leg_a(torch, fluid, bp),
               "leg_b": book_leg_b(torch, fluid, bp),
               "leg_c": book_leg_c(torch, fluid, bp),
               "leg_d": book_leg_d(torch, cr, cases)}
    finally:
        fluid.set_flags(before)
        os.environ.pop("FLAGS_cudnn_deterministic", None)
    a = res["leg_a"]
    emit({"phase": "book", "device": name, "nvidia_smi": nvidia_smi_line(),
          "captured_step_ms": a["captured_step_ms"],
          "eager_step_median_ms": a["eager_step_median_ms"],
          "tokens_per_sec": a["tokens_per_sec"],
          "busy_share": a["replay"]["device_busy_share"],
          "peak_mem_bytes": a["peak_mem_bytes"],
          "seconds": time.perf_counter() - t0})
    return res


# -- phase 20 -----------------------------------------------------------------

def seq_leg_a(torch, fluid, bp):
    """Leg a: convolution_net with its streaming AUC at the book's widths,
    T 256, batch 128, every row full: trained captured (the first step
    eager, the second captured, then replays) and, from the same state,
    eagerly; step times, capture, busy share, kernels a replay, peak
    memory, the graph pool, the AUC."""
    import numpy as np

    seq, batch = SEQ_A["seq"], SEQ_A["batch"]
    book = bp.convolution_net(fluid, seq)
    fetch = [book.loss] + book.fetch
    state = book_state(fluid, book)
    rng = np.random.RandomState(0)
    feeds = [book.feed(batch, rng) for _ in range(SEQ_A["graph_steps"])]
    torch.cuda.reset_peak_memory_stats()
    graph = fluid_run(torch, fluid, book.main, state, feeds, fetch, True)
    peak = torch.cuda.max_memory_allocated()
    busy, wall, kernels = device_busy_share(
        torch, lambda: graph["exe"].run(book.main, feed=feeds[-1],
                                        fetch_list=fetch,
                                        scope=graph["scope"]))
    info = graph["info"]
    graph["exe"].close()
    eager = fluid_run(torch, fluid, book.main, state,
                      feeds[:SEQ_A["eager_steps"]], fetch, False)
    eager["exe"].close()

    def col(run, j):
        return [float(f[j].reshape(-1)[0]) for f in run["fetches"]]

    replay_ms = statistics.median(graph["step_ms"][2:])
    eager_ms = statistics.median(eager["step_ms"][1:])
    res = {"leg": "a", "model": "convolution_net + streaming auc",
           "widths": dict(bp.CONV_SENTIMENT, seq=seq, batch=batch,
                          auc_buckets=bp.AUC_THRESHOLDS + 1),
           "mode": info["mode"], "entry_phase": info["phase"],
           "losses": col(graph, 0), "eager_losses": col(eager, 0),
           "accuracies": col(graph, 1), "aucs": col(graph, 2),
           "auc_last": col(graph, 2)[-1],
           "graph_step_ms": graph["step_ms"], "eager_step_ms":
           eager["step_ms"], "captured_step_ms": replay_ms,
           "eager_step_median_ms": eager_ms,
           "first_eager_step_ms": graph["step_ms"][0],
           "capture_step_ms": graph["step_ms"][1],
           "capture_ms": info.get("capture_ms"),
           "pool_bytes": info.get("pool_bytes"),
           "tokens_per_sec": batch * seq / (replay_ms / 1e3),
           "eager_tokens_per_sec": batch * seq / (eager_ms / 1e3),
           "replay": {"wall_us": wall, "device_busy_us": busy,
                      "device_busy_share": busy / wall, "kernels": kernels},
           "peak_mem_bytes": peak}
    del graph, eager, state
    torch.cuda.empty_cache()
    emit({"phase": "sequences_leg", **res})
    check(info["mode"] == "graph" and info["phase"] == "captured",
          "sequences a: the step is %s (%s), not captured"
          % (info["mode"], info["reason"]))
    check(all(math.isfinite(x) for x in res["losses"] + res["eager_losses"]),
          "sequences a: losses %s" % res["losses"])
    check(abs(res["losses"][0] - math.log(2.0)) < 0.5,
          "sequences a: first loss %s against ln 2" % res["losses"][0])
    check(all(0.0 <= a <= 1.0 for a in res["aucs"]),
          "sequences a: AUCs %s" % res["aucs"])
    return res


def seq_leg_b(torch, fluid, bp, sc):
    """Leg b, the gates at T 32: leg a's program captured against eager
    over 6 steps (losses, accuracies, AUCs and every persistable
    bit-equal); the ragged classifier, the card against the CPU (losses
    and every gradient within SEQ_B's rtol, relative in norm)."""
    import numpy as np

    seq, batch, tol = SEQ_B["seq"], SEQ_B["batch"], SEQ_B["rtol"]
    book = bp.convolution_net(fluid, seq)
    rng = np.random.RandomState(1)
    feeds = [book.feed(batch, rng) for _ in range(SEQ_B["steps"])]
    state = book_state(fluid, book)
    runs = [fluid_run(torch, fluid, book.main, state, feeds,
                      [book.loss] + book.fetch, g) for g in (True, False)]
    graph, eager = runs
    for r in runs:
        r["exe"].close()
    eager_tensors = dict(run_tensors(torch, eager))
    differ = sorted(n for n, a in run_tensors(torch, graph)
                    if not torch.equal(a, eager_tensors[n]))
    res = {"leg": "b", "seq": seq, "batch": batch,
           "captured_vs_eager": {"steps": len(feeds),
                                 "mode": graph["info"]["mode"],
                                 "entry_phase": graph["info"]["phase"],
                                 "tensors": len(eager_tensors),
                                 "bit_equal": not differ,
                                 "differ": differ[:5]}}
    del graph, eager, runs, state
    main, startup, loss, feed = sc.ragged_net(fluid, seq)
    ragged = bp.Book(main, startup, loss, [], feed)
    rng = np.random.RandomState(2)
    feeds = [feed(batch, rng) for _ in range(SEQ_B["ragged_steps"])]
    res["ragged_vs_cpu"] = dict(book_grads_vs_cpu(
        torch, fluid, ragged, feeds, SEQ_B["ragged_steps"]),
        lengths=[int(x) for x in feeds[0]["length"][:8]])
    res["rtol"] = tol
    torch.cuda.empty_cache()
    emit({"phase": "sequences_leg", **res})
    check(res["captured_vs_eager"]["bit_equal"]
          and res["captured_vs_eager"]["entry_phase"] == "captured",
          "sequences b: captured against eager: %s"
          % res["captured_vs_eager"])
    r = res["ragged_vs_cpu"]
    check(r["loss_rel_err"] <= tol and r["grad_rel_err"] <= tol
          and r["card_phase"] == "captured",
          "sequences b: ragged card against CPU: %s" % r)
    return res


def one_op_program(fluid, op, ins, out_slots, attrs):
    """A program of op `op` alone over data vars fed `ins` (slot -> numpy
    arrays), its outputs new vars: (program, feed, output vars in slot
    order)."""
    main = fluid.Program()
    block = main.global_block()
    feed, inputs = {}, {}
    for slot, arrs in ins.items():
        inputs[slot] = []
        for i, a in enumerate(arrs):
            name = "%s_%d" % (slot, i)
            inputs[slot].append(block.create_var(
                name=name, shape=list(a.shape), dtype=str(a.dtype)))
            feed[name] = a
    outputs = {slot: [block.create_var(name="out_%s_%d" % (slot, i))
                      for i in range(n)] for slot, n in out_slots.items()}
    block.append_op(type=op, inputs=inputs, outputs=outputs,
                    attrs=dict(attrs))
    return main, feed, [v for s in sorted(outputs) for v in outputs[s]]


def seq_host_case(fluid, cr, sc, name, exe):
    """A host-side case as a one-op program run twice by `exe` (the
    card's executor): its block's entry eager with a reason naming the
    op, its outputs those of the op run directly."""
    from paddle_tpu_torch.core.types import from_numpy
    from paddle_tpu_torch.ops import registry

    op, _, attrs, _, _ = sc.CASES[name]
    ins = sc.inputs(name)
    direct = registry.normalize_outs(registry.get_op(op).compute(
        {s: [from_numpy(a, exe.device) for a in v] for s, v in ins.items()},
        dict(attrs, _device=exe.device)))
    main, feed, outs = one_op_program(
        fluid, op, ins, {s: len(v) for s, v in direct.items()}, attrs)
    scope = fluid.Scope()
    for _ in range(2):
        got = [f.value for f in exe.run(main, feed=feed, fetch_list=outs,
                                        scope=scope, return_numpy=False)]
    entry = exe.last_entry
    exe.close()
    want = [t for s in sorted(direct) for t in direct[s]]
    bad = cr.compare(list(got), want, 0.0)[2]
    ok = entry.mode == "eager" and "%r" % op in (entry.reason or "")
    return {"mode": entry.mode, "reason": entry.reason, "ok": ok and not bad,
            "faults": bad[:3]}


def seq_leg_c(torch, fluid, cr, sc):
    """Leg c: every case of tests/torch_seq_cases.py, the card against
    the CPU (each output and the gradient of each float input within
    SEQ_C_RTOL x (1 + max |value|), integers exact); each capturable case
    from one replay of a CUDA graph captured around it and its
    gradients, bit-equal to the card's eager run; each host-side case as
    a one-op program, its block eager; `run_program` card against CPU;
    `sequence_scatter` and `SelectedRows.merge` at SEQ_C_ROWS rows twice,
    bit-equal."""
    import numpy as np

    import paddle_tpu_torch.ops.framework_ops as tfo
    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    from paddle_tpu_torch.ops import registry

    sc.prepare(tfo)
    dev = resolve_device(None)
    worst, bad, captured, host = 0.0, [], 0, {}
    for name in sorted(sc.CASES):
        op, _, attrs, diff, _ = sc.CASES[name]
        ins = sc.inputs(name)
        got = cr.run_case(op, ins, attrs, dev, diff, seed=7)
        _, err, faults = cr.compare(
            got, cr.run_case(op, ins, attrs, "cpu", diff, seed=7),
            SEQ_C_RTOL)
        worst = max(worst, err)
        bad += [(name,) + f for f in faults]
        if cr.capturable(op):
            try:
                graph = cr.capture_case(op, ins, attrs, dev, diff, seed=7)
            except RuntimeError as e:
                bad.append((name, "capture", str(e).splitlines()[0][:200]))
            else:
                captured += 1
                bad += [(name, "captured") + f
                        for f in cr.compare(graph, got, 0.0)[2]]
        elif op not in host:
            host[op] = seq_host_case(fluid, cr, sc, name, fluid.Executor())
            if not host[op]["ok"]:
                bad.append((name, "host block", host[op]))
    runs = []
    for place in (fluid.CUDAPlace(dev.index or 0), fluid.CPUPlace()):
        scope, ins, attrs = sc.run_program_case(fluid, place)
        if runs:
            for n, v in runs[0][1].items():
                scope.set_var(n, v.cpu().clone())
        d = scope.find_var("fc_0.w_0").device
        with fluid.scope_guard(scope):
            out = registry.get_op("run_program").compute(
                {"X": [torch.tensor(ins["X"][0]).to(d)]},
                dict(attrs, _device=d))["Out"]
        runs.append((out, {n: scope.find_var(n)
                           for n in ("fc_0.w_0", "fc_0.b_0")}))
    program_err, _, faults = cr.compare(runs[0][0], runs[1][0], SEQ_C_RTOL)
    bad += [("run_program",) + f for f in faults]
    r = np.random.RandomState(9)
    n, width = SEQ_C_ROWS, 64
    ids = torch.tensor(r.randint(0, 512, n), device=dev)
    upd = torch.tensor(r.randn(n, width).astype("float32"), device=dev)
    x = torch.zeros(512, width, device=dev)
    scatter = [registry.get_op("sequence_scatter").compute(
        {"X": [x], "Ids": [ids], "Updates": [upd]}, {"_device": dev})["Out"]
        for _ in range(2)]
    merged = [SelectedRows(ids, upd, 512).merge() for _ in range(2)]
    repeats = {"sequence_scatter": torch.equal(*scatter),
               "selected_rows_merge": torch.equal(merged[0].values,
                                                  merged[1].values)
               and torch.equal(merged[0].rows, merged[1].rows)}
    res = {"leg": "c", "cases": len(sc.CASES),
           "types": len({c[0] for c in sc.CASES.values()}) + 1,
           "captured_cases": captured, "host_types": sorted(host),
           "host_reason_example": next(iter(host.values()))["reason"]
           if host else None, "max_rel_err": worst,
           "run_program_max_abs_err": program_err,
           "tol": "%g x (1 + max |value|); integers exact; captured "
           "bit-equal to eager" % SEQ_C_RTOL, "bit_repeat": repeats,
           "failures": bad[:10]}
    emit({"phase": "sequences_leg", **res})
    check(not bad, "sequences c: card against CPU, captured against eager "
          "or a host block: %s" % bad[:10])
    check(all(repeats.values()), "sequences c: a repeat differs: %s"
          % repeats)
    return res


def phase_sequences(torch, name):
    """Phase 20: Paddle's sequence ops on the card, with
    ``FLAGS_cudnn_deterministic`` on."""
    from paddle_tpu_torch import fluid

    bp, cr, sc = tests_modules("torch_book_programs", "torch_case_runner",
                               "torch_seq_cases")
    t0 = time.perf_counter()
    before = fluid.get_flags("FLAGS_cudnn_deterministic")
    os.environ["FLAGS_cudnn_deterministic"] = "1"
    fluid.set_flags({"FLAGS_cudnn_deterministic": True})
    try:
        res = {"leg_a": seq_leg_a(torch, fluid, bp),
               "leg_b": seq_leg_b(torch, fluid, bp, sc),
               "leg_c": seq_leg_c(torch, fluid, cr, sc)}
    finally:
        fluid.set_flags(before)
        os.environ.pop("FLAGS_cudnn_deterministic", None)
    a = res["leg_a"]
    emit({"phase": "sequences", "device": name,
          "nvidia_smi": nvidia_smi_line(),
          "captured_step_ms": a["captured_step_ms"],
          "eager_step_median_ms": a["eager_step_median_ms"],
          "tokens_per_sec": a["tokens_per_sec"],
          "busy_share": a["replay"]["device_busy_share"],
          "peak_mem_bytes": a["peak_mem_bytes"], "auc_last": a["auc_last"],
          "seconds": time.perf_counter() - t0})
    return res


# -- phase 21 -----------------------------------------------------------------

def recorded_warnings(fn):
    """fn() with warnings recorded: (its result, the first lines of the
    nondeterminism warnings PyTorch raised)."""
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = fn()
    return out, sorted({str(w.message).splitlines()[0][:200] for w in seen
                        if "determinis" in str(w.message)})


def train_leg(torch, fluid, prog, batch, steps, fetch, rng):
    """`prog` trained captured (`steps` runs) and eagerly (`eager`) from
    one startup state, over two batches in turn: the captured run
    (executor closed), its peak
    memory, a profiled replay, the eager run (executor open, for what
    follows on its scope), the nondeterminism warnings."""
    state = book_state(fluid, prog)
    # two batches in turn: drawing 128 images of 224 x 224 a step takes
    # the host about 0.5 s
    drawn = [prog.feed(batch, rng) for _ in range(2)]
    feeds = [drawn[i % 2] for i in range(steps[0])]
    torch.cuda.reset_peak_memory_stats()
    graph, warned = recorded_warnings(lambda: fluid_run(
        torch, fluid, prog.main, state, feeds, fetch, True))
    peak = torch.cuda.max_memory_allocated()
    busy, wall, kernels = device_busy_share(
        torch, lambda: graph["exe"].run(prog.main, feed=feeds[-1],
                                        fetch_list=fetch,
                                        scope=graph["scope"]))
    graph["exe"].close()
    graph.pop("scope")
    torch.cuda.empty_cache()
    eager, warned2 = recorded_warnings(lambda: fluid_run(
        torch, fluid, prog.main, state, feeds[:steps[1]], fetch, False))
    replay_ms = statistics.median(graph["step_ms"][2:])
    return {"graph": graph, "eager": eager, "peak": peak, "state": state,
            "replay": {"wall_us": wall, "device_busy_us": busy,
                       "device_busy_share": busy / wall,
                       "kernels": kernels},
            "replay_ms": replay_ms,
            "eager_ms": statistics.median(eager["step_ms"][1:]),
            "warnings": sorted(set(warned) | set(warned2))}


def train_summary(run, batch):
    """The numbers legs a and b report of a `train_leg`."""
    info = run["graph"]["info"]
    return {"mode": info["mode"], "entry_phase": info["phase"],
            "losses": [float(f[0].reshape(-1)[0])
                       for f in run["graph"]["fetches"]],
            "eager_losses": [float(f[0].reshape(-1)[0])
                             for f in run["eager"]["fetches"]],
            "graph_step_ms": run["graph"]["step_ms"],
            "eager_step_ms": run["eager"]["step_ms"],
            "captured_step_ms": run["replay_ms"],
            "eager_step_median_ms": run["eager_ms"],
            "first_eager_step_ms": run["graph"]["step_ms"][0],
            "capture_step_ms": run["graph"]["step_ms"][1],
            "capture_ms": info.get("capture_ms"),
            "pool_bytes": info.get("pool_bytes"),
            "images_per_sec": batch / (run["replay_ms"] / 1e3),
            "eager_images_per_sec": batch / (run["eager_ms"] / 1e3),
            "replay": run["replay"], "peak_mem_bytes": run["peak"],
            "nondeterminism_warnings": run["warnings"]}


def det_inference(torch, fluid, det, state, batch):
    """The inference program once on `batch` images from the startup
    `state` (its first run; the convolutions warmed by the calibration
    below): its ms, its entry (eager, the NMS naming the reason), the
    detections it keeps, the ms of its `multiclass_nms` on the host
    (timed inside the run) and of its three `yolo_box` on the card (run
    again on its head outputs, which must give the boxes and scores the
    NMS read). The batch norms' running statistics are first set from
    the batch (a copy of the program up to the heads, batch norm in
    training mode with momentum 0): at their initial 0 and 1 the
    untrained heads overflow `exp`, and a net trained a few steps on
    random boxes scores every box below `conf_thresh`, where an
    untrained one passes them all, the NMS's full load (80 classes x
    `nms_top_k` 1,000 an image)."""
    import numpy as np

    from paddle_tpu_torch.ops import registry

    exe = fluid.Executor()
    dev = exe.device
    scope = fluid.Scope()
    for n, v in state.items():
        scope.set_var(n, v.clone())
    feed = det.infer_feed(batch, np.random.RandomState(3))
    ops = det.infer.global_block().ops
    yb = [op for op in ops if op.type == "yolo_box"]
    nms = next(op for op in ops if op.type == "multiclass_nms")
    heads = [op.input_names["X"][0] for op in yb]
    calib = det.infer.clone()
    block = calib.global_block()
    block.ops = block.ops[:next(i for i, op in enumerate(block.ops)
                                if op.type == "yolo_box")]
    for op in block.ops:
        if op.type == "batch_norm":
            op.attrs.update(is_test=False, momentum=0.0)
    exe.run(calib, feed={"image": feed["image"]}, fetch_list=heads,
            scope=scope)
    fetch = heads + [nms.input_names[s][0] for s in ("BBoxes", "Scores")] \
        + [nms.output_names["Out"][0]]
    nms_def = registry.get_op("multiclass_nms")
    inner, spent = nms_def.compute, []

    def timed(ins, attrs):
        t = time.perf_counter()
        out = inner(ins, attrs)
        spent.append(time.perf_counter() - t)
        return out

    nms_def.compute = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [f.value for f in exe.run(det.infer, feed=feed,
                                        fetch_list=fetch, scope=scope,
                                        return_numpy=False)]
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t0) * 1e3
    finally:
        nms_def.compute = inner
    entry = exe.last_entry
    exe.close()
    img = torch.tensor(feed["im_size"], device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decoded = [registry.get_op("yolo_box").compute(
        {"X": [x], "ImgSize": [img]}, dict(op.attrs, _device=dev))
        for op, x in zip(yb, out[:3])]
    boxes = torch.cat([d["Boxes"] for d in decoded], 1)
    scores = torch.cat([d["Scores"] for d in decoded], 1).transpose(1, 2)
    torch.cuda.synchronize()
    yolo_box_ms = (time.perf_counter() - t0) * 1e3
    dets = out[5]
    return {"batch": batch, "boxes": int(boxes.shape[1]),
            "classes": int(scores.shape[1]), "run_ms": run_ms,
            "mode": entry.mode, "reason": entry.reason,
            "detections": int(dets.shape[0]),
            "candidates": int((scores > nms.attrs["score_threshold"])
                              .sum()),
            "yolo_box_ms": yolo_box_ms, "nms_ms": sum(spent) * 1e3,
            "yolo_box_nms_ms": yolo_box_ms + sum(spent) * 1e3,
            "same_as_program": torch.equal(boxes, out[3])
            and torch.equal(scores, out[4]) and len(spent) == 1,
            "finite": bool(torch.isfinite(boxes).all()
                           and torch.isfinite(dets).all())}


def det_leg_a(torch, fluid, dp):
    """Leg a: YOLOv3 DarkNet-53 at 608 x 608, batch 8, trained captured
    and eagerly from one state; then its inference program on 8 images
    from the startup state (`det_inference`)."""
    import numpy as np

    a = DET_A
    t0 = time.perf_counter()
    det = dp.yolov3_darknet53(fluid, **dp.YOLO_FULL)
    build_s = time.perf_counter() - t0
    run = train_leg(torch, fluid, det, a["batch"],
                    (a["graph_steps"], a["eager_steps"]), [det.loss],
                    np.random.RandomState(0))
    infer = det_inference(torch, fluid, det, run["state"],
                          a["infer_batch"])
    run["eager"]["exe"].close()
    res = dict(train_summary(run, a["batch"]), leg="a",
               model="yolov3 darknet-53", widths=dict(dp.YOLO_FULL),
               batch=a["batch"], build_s=build_s, inference=infer)
    del run
    torch.cuda.empty_cache()
    emit({"phase": "detection_leg", **res})
    check(res["mode"] == "graph" and res["entry_phase"] == "captured",
          "detection a: the step is %s, not captured" % res["mode"])
    check(all(math.isfinite(x) for x in res["losses"]
              + res["eager_losses"]), "detection a: losses %s"
          % res["losses"])
    check(not res["nondeterminism_warnings"],
          "detection a: nondeterminism warnings %s"
          % res["nondeterminism_warnings"])
    check(infer["mode"] == "eager" and "multiclass_nms" in (
        infer["reason"] or "") and infer["same_as_program"]
        and infer["finite"] and 0 < infer["detections"]
        <= 100 * a["infer_batch"], "detection a: inference %s" % infer)
    return res


def det_leg_b(torch, fluid, dp):
    """Leg b: ResNet50 under slim's QAT pass at 224 x 224, batch 128,
    trained captured and eagerly from one state; the scale states over
    the captured steps; the plain network's captured step; then the
    evaluation clone frozen, saved, loaded and run on one batch."""
    import tempfile

    import numpy as np

    from paddle_tpu_torch.fluid.contrib.slim import quantization as slim

    b = DET_B
    cfg = dict(depth=b["depth"], img=b["img"], classes=b["classes"])
    t0 = time.perf_counter()
    qat = dp.resnet_qat(fluid, **cfg)
    build_s = time.perf_counter() - t0
    states = dp.quant_state_names(qat.main)
    run = train_leg(torch, fluid, qat, b["batch"],
                    (b["graph_steps"], b["eager_steps"]),
                    [qat.loss] + states, np.random.RandomState(1))
    scales = np.asarray([[float(v.reshape(-1)[0]) for v in f[1:]]
                         for f in run["graph"]["fetches"]])
    drift = np.abs(scales[-1] - scales[0]) / np.maximum(scales[0], 1e-30)
    # the evaluation clone, frozen from the eager run's state
    scope, exe = run["eager"]["scope"], run["eager"]["exe"]
    test = qat.test.clone()
    slim.QuantizationFreezePass(
        scope=scope, weight_quantize_type="channel_wise_abs_max").apply(
            test, scope=scope)
    image = np.random.RandomState(2).randn(
        b["batch"], 3, b["img"], b["img"]).astype("float32")
    frozen = exe.run(test, feed={"image": image, "label": np.zeros(
        (b["batch"], 1), "int64")}, fetch_list=qat.fetch, scope=scope)[0]
    with tempfile.TemporaryDirectory() as d, fluid.scope_guard(scope):
        fluid.io.save_inference_model(d, ["image"], qat.fetch, exe,
                                      main_program=test)
        prog, _, fetch = fluid.io.load_inference_model(d, exe)
        exe.run(prog, feed={"image": image}, fetch_list=fetch, scope=scope)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = exe.run(prog, feed={"image": image}, fetch_list=fetch,
                         scope=scope)[0]
        torch.cuda.synchronize()
        infer_ms = (time.perf_counter() - t0) * 1e3
    exe.close()
    res = dict(train_summary(run, b["batch"]), leg="b",
               model="resnet50 + QuantizationTransformPass", widths=cfg,
               batch=b["batch"], build_s=build_s,
               quant_states=len(states),
               scale_first=scales[0, :3].tolist(),
               scale_last=scales[-1, :3].tolist(),
               scale_drift_median=float(np.median(drift)),
               scale_drift_max=float(drift.max()),
               frozen={"infer_ms": infer_ms, "batch": b["batch"],
                       "finite": bool(np.isfinite(loaded).all()),
                       "equal_after_load": bool(np.array_equal(loaded,
                                                               frozen))})
    del run
    torch.cuda.empty_cache()
    plain = dp.resnet_qat(fluid, quant=False, **cfg)
    state = book_state(fluid, plain)
    feeds = [plain.feed(b["batch"], np.random.RandomState(1))] \
        * b["plain_steps"]
    prun = fluid_run(torch, fluid, plain.main, state, feeds, [plain.loss],
                     True)
    prun["exe"].close()
    res["plain_captured_step_ms"] = statistics.median(prun["step_ms"][2:])
    res["quant_share"] = 1.0 - res["plain_captured_step_ms"] \
        / res["captured_step_ms"]
    del prun, state
    torch.cuda.empty_cache()
    emit({"phase": "detection_leg", **res})
    check(res["mode"] == "graph" and res["entry_phase"] == "captured",
          "detection b: the step is %s, not captured" % res["mode"])
    check(all(math.isfinite(x) for x in res["losses"]
              + res["eager_losses"]), "detection b: losses %s"
          % res["losses"])
    check(np.isfinite(scales).all() and (scales > 0).all(),
          "detection b: scales not positive and finite")
    check(not res["nondeterminism_warnings"],
          "detection b: nondeterminism warnings %s"
          % res["nondeterminism_warnings"])
    check(res["frozen"]["finite"] and res["frozen"]["equal_after_load"],
          "detection b: frozen program %s" % res["frozen"])
    return res


def det_small(torch, fluid, name, prog, batch, fetch, cpu_check):
    """One program of leg c: captured against eager and eager against
    eager over DET_C_STEPS steps (every fetch and persistable bit-equal,
    no nondeterminism warning), then its first 3 steps on the CPU from
    the same state, held by `cpu_check(card fetches, cpu fetches)`."""
    import numpy as np

    state = book_state(fluid, prog)
    rng = np.random.RandomState(5)
    feeds = [prog.feed(batch, rng) for _ in range(DET_C_STEPS)]
    runs, warned = recorded_warnings(lambda: [
        fluid_run(torch, fluid, prog.main, state, feeds, fetch, g)
        for g in (True, False, False)])
    for r in runs:
        r["exe"].close()
    tensors = [dict(run_tensors(torch, r)) for r in runs]
    differ = {what: sorted(n for n, t in tensors[0 if what == "graph"
                                                 else 2].items()
                           if not torch.equal(t, tensors[1][n]))[:5]
              for what in ("graph", "eager")}
    cpu = book_cpu_run(torch, fluid, prog, state, feeds[:3], fetch)
    res = {"program": name, "steps": DET_C_STEPS,
           "mode": runs[0]["info"]["mode"],
           "entry_phase": runs[0]["info"]["phase"],
           "tensors": len(tensors[1]), "captured_vs_eager": differ["graph"],
           "eager_vs_eager": differ["eager"],
           "nondeterminism_warnings": warned,
           "vs_cpu": cpu_check(runs[0]["fetches"][:3], cpu)}
    res["ok"] = (not differ["graph"] and not differ["eager"]
                 and not warned and res["entry_phase"] == "captured"
                 and res["vs_cpu"]["ok"])
    return res, runs[0]["final"]


def det_frozen_vs_cpu(torch, fluid, qat, state):
    """The small QAT ResNet's evaluation clone frozen from `state` on the
    card (then saved and loaded) and on the CPU: the largest difference
    of their logits over the largest |logit|."""
    import tempfile

    import numpy as np

    from paddle_tpu_torch.fluid.contrib.slim import quantization as slim

    feed = qat.feed(8, np.random.RandomState(6))
    cpu_feed = {"image": feed["image"], "label": feed["label"]}
    out = []
    for place in (None, fluid.CPUPlace()):
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        for n, v in state.items():
            scope.set_var(n, v.clone() if place is None else v.cpu().clone())
        test = qat.test.clone()
        slim.QuantizationFreezePass(
            scope=scope, weight_quantize_type="channel_wise_abs_max").apply(
                test, scope=scope)
        if place is None:
            with tempfile.TemporaryDirectory() as d, \
                    fluid.scope_guard(scope):
                fluid.io.save_inference_model(d, ["image"], qat.fetch, exe,
                                              main_program=test)
                test, _, fetch = fluid.io.load_inference_model(d, exe)
            run_feed = {"image": feed["image"]}
        else:
            fetch, run_feed = qat.fetch, cpu_feed
        out.append(exe.run(test, feed=run_feed, fetch_list=fetch,
                           scope=scope)[0])
        exe.close()
    scale = float(np.abs(out[1]).max())
    return float(np.abs(out[0] - out[1]).max()) / scale


def det_leg_c(torch, fluid, dp):
    """Leg c, the gates at small size (module constants)."""
    import numpy as np

    tol = dp.TOL

    def loss_of(f):
        return float(f[0].reshape(-1)[0])

    def yolo_check(card, cpu):
        first = rel_err(card[0][0], cpu[0][0])
        steps = max(abs(loss_of(a) / loss_of(b) - 1)
                    for a, b in zip(card, cpu))
        return {"first_loss_rel_err": first, "steps_loss_rel_err": steps,
                "ok": first <= tol["yolo_first"]
                and steps <= tol["yolo_steps"]}

    def qat_check(card, cpu):
        first = abs(loss_of(card[0]) / loss_of(cpu[0]) - 1)
        scales = max(float(np.max(np.abs(a / b - 1)))
                     for a, b in zip(card[-1][1:], cpu[-1][1:]))
        return {"first_loss_rel_err": first, "scales_rel_err": scales,
                "ok": first <= tol["qat_loss"]
                and scales <= tol["qat_scales"]}

    def range_check(card, cpu):
        err = max(rel_err(a, b) for f, g in zip(card, cpu)
                  for a, b in zip(f[:3], g[:3]))
        iters = all(np.array_equal(f[3], g[3]) for f, g in zip(card, cpu))
        return {"rel_err": err, "iter_equal": iters,
                "ok": err <= 1e-5 and iters}

    yolo = dp.yolov3_darknet53(fluid, **dp.TINY_YOLO)
    qat = dp.resnet_qat(fluid, **dp.SMALL_QAT)
    rmlp = dp.range_mlp(fluid)
    states = dp.quant_state_names(qat.main)
    out = {}
    out["tiny_yolov3"], _ = det_small(torch, fluid, "tiny_yolov3", yolo,
                                      dp.TINY_YOLO_BATCH, [yolo.loss],
                                      yolo_check)
    out["small_qat_resnet"], final = det_small(
        torch, fluid, "small_qat_resnet", qat, dp.SMALL_QAT_BATCH,
        [qat.loss] + states, qat_check)
    out["range_mlp"], _ = det_small(torch, fluid, "range_mlp", rmlp, 8,
                                    [rmlp.loss] + rmlp.fetch, range_check)
    frozen = det_frozen_vs_cpu(torch, fluid, qat, final)
    res = {"leg": "c", **out, "frozen_qat_vs_cpu": frozen, "tol": dict(tol)}
    emit({"phase": "detection_leg", **res})
    bad = [k for k, v in out.items() if not v["ok"]]
    check(not bad, "detection c: %s" % {k: out[k] for k in bad})
    check(frozen <= tol["frozen"],
          "detection c: frozen QAT card against CPU %g" % frozen)
    return res


def det_leg_d(torch, fluid, cr, dq):
    """Leg d: every case of tests/torch_det_quant_cases.py card against
    CPU (outputs and gradients within DET_D_RTOL x (1 + max |value|),
    integers exact); each capturable case from one replay of a CUDA
    graph captured around it and its gradients, bit-equal to eager; the
    gathering types' cases run twice, bit-equal; each NMS case as a
    one-op program (its block eager, the NMS named) whose outputs are
    the reference's recorded ones (`NMS_DIGESTS`)."""
    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.core.types import to_numpy
    from paddle_tpu_torch.ops import registry

    dev = resolve_device(None)
    worst, bad, captured, repeated, host = 0.0, [], 0, 0, {}
    for name in sorted(dq.CASES):
        op, _, attrs, diff, _ = dq.CASES[name]
        ins = dq.inputs(name)
        got = cr.run_case(op, ins, attrs, dev, diff, seed=7)
        _, err, faults = cr.compare(
            got, cr.run_case(op, ins, attrs, "cpu", diff, seed=7),
            DET_D_RTOL)
        worst = max(worst, err)
        bad += [(name,) + f for f in faults]
        if op in DET_D_REPEAT:
            repeated += 1
            bad += [(name, "repeat") + f for f in cr.compare(
                cr.run_case(op, ins, attrs, dev, diff, seed=7), got,
                0.0)[2]]
        if cr.capturable(op):
            try:
                graph = cr.capture_case(op, ins, attrs, dev, diff, seed=7)
            except RuntimeError as e:
                bad.append((name, "capture", str(e).splitlines()[0][:200]))
            else:
                captured += 1
                bad += [(name, "captured") + f
                        for f in cr.compare(graph, got, 0.0)[2]]
            continue
        block = seq_host_case(fluid, cr, dq, name, fluid.Executor())
        outs = registry.normalize_outs(registry.get_op(op).compute(
            {s: [torch.tensor(a).to(dev) for a in v]
             for s, v in ins.items()}, dict(attrs, _device=dev)))
        digests = {s: dq.digest(to_numpy(v[0])) for s, v in outs.items()}
        host[name] = {"mode": block["mode"], "ok": block["ok"],
                      "recorded": digests == dq.NMS_DIGESTS[name]}
        if not (block["ok"] and host[name]["recorded"]):
            bad.append((name, "host", host[name], block["reason"]))
    res = {"leg": "d", "cases": len(dq.CASES),
           "types": len({c[0] for c in dq.CASES.values()}),
           "captured_cases": captured, "repeated_cases": repeated,
           "host_cases": sorted(host), "max_rel_err": worst,
           "tol": "%g x (1 + max |value|); integers exact; captured and "
           "repeats bit-equal; NMS outputs the reference's recorded ones"
           % DET_D_RTOL, "failures": bad[:10]}
    emit({"phase": "detection_leg", **res})
    check(not bad, "detection d: %s" % bad[:10])
    return res


def phase_detection(torch, name):
    """Phase 21: detection and quantization on the card, with
    ``FLAGS_cudnn_deterministic`` on."""
    from paddle_tpu_torch import fluid

    dp, cr, dq = tests_modules("torch_detection_programs",
                               "torch_case_runner", "torch_det_quant_cases")
    t0 = time.perf_counter()
    before = fluid.get_flags("FLAGS_cudnn_deterministic")
    os.environ["FLAGS_cudnn_deterministic"] = "1"
    fluid.set_flags({"FLAGS_cudnn_deterministic": True})
    try:
        res = {"leg_a": det_leg_a(torch, fluid, dp),
               "leg_b": det_leg_b(torch, fluid, dp),
               "leg_c": det_leg_c(torch, fluid, dp),
               "leg_d": det_leg_d(torch, fluid, cr, dq)}
    finally:
        fluid.set_flags(before)
        os.environ.pop("FLAGS_cudnn_deterministic", None)
    a, b = res["leg_a"], res["leg_b"]
    emit({"phase": "detection", "device": name,
          "nvidia_smi": nvidia_smi_line(),
          "yolov3_captured_step_ms": a["captured_step_ms"],
          "yolov3_eager_step_ms": a["eager_step_median_ms"],
          "yolov3_images_per_sec": a["images_per_sec"],
          "yolov3_busy_share": a["replay"]["device_busy_share"],
          "yolov3_peak_mem_bytes": a["peak_mem_bytes"],
          "yolov3_infer_yolo_box_nms_ms": a["inference"]["yolo_box_nms_ms"],
          "qat_captured_step_ms": b["captured_step_ms"],
          "qat_eager_step_ms": b["eager_step_median_ms"],
          "qat_images_per_sec": b["images_per_sec"],
          "qat_busy_share": b["replay"]["device_busy_share"],
          "qat_peak_mem_bytes": b["peak_mem_bytes"],
          "qat_quant_share": b["quant_share"],
          "seconds": time.perf_counter() - t0})
    return res


# -- phase 22 -----------------------------------------------------------------

@contextlib.contextmanager
def timed_ops(types):
    """Each op type of `types` timed where it runs (host seconds a call,
    type -> list), the registry's compute functions put back after."""
    from paddle_tpu_torch.ops import registry

    spent = {t: [] for t in types}
    saved = {t: registry.get_op(t).compute for t in types}

    def timed(t, fn):
        def run(ins, attrs):
            t0 = time.perf_counter()
            out = fn(ins, attrs)
            spent[t].append(time.perf_counter() - t0)
            return out
        return run

    for t in types:
        registry.get_op(t).compute = timed(t, saved[t])
    try:
        yield spent
    finally:
        for t in types:
            registry.get_op(t).compute = saved[t]


def dx_train_eval(torch, fluid, prog, model):
    """Legs a and b: DX_STEPS training steps of `prog` (a TwoStage) from
    its startup on the card, one profiled step, then one evaluation
    pass of its test program on the trained scope."""
    import numpy as np

    state = book_state(fluid, prog)
    exe, scope = fluid.Executor(), fluid.Scope()
    for n, v in state.items():
        scope.set_var(n, v)
    rng = np.random.RandomState(0)
    feeds = [prog.feed(rng) for _ in range(DX_STEPS + 1)]
    torch.cuda.reset_peak_memory_stats()
    step_ms, host_s, losses = [], [], []

    def steps():
        with timed_ops(prog.host_ops) as spent:
            for feed in feeds[:DX_STEPS]:
                before = {t: len(v) for t, v in spent.items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = exe.run(prog.main, feed=feed, fetch_list=prog.fetch,
                              scope=scope)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append([float(o.reshape(-1)[0]) for o in out])
                host_s.append({t: sum(v[before[t]:]) for t, v in
                               spent.items()})
                calls = {t: len(v) - before[t] for t, v in spent.items()}
        return calls

    calls, warned = recorded_warnings(steps)
    peak = torch.cuda.max_memory_allocated()
    train_entry = exe.last_entry
    busy, wall, kernels = device_busy_share(torch, lambda: exe.run(
        prog.main, feed=feeds[-1], fetch_list=prog.fetch, scope=scope))
    test_feed = prog.test_feed(np.random.RandomState(1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dets, m_ap = exe.run(prog.test, feed=test_feed,
                         fetch_list=prog.test_fetch, scope=scope)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    test_entry = exe.last_entry
    exe.close()
    later = step_ms[1:]
    res = {"model": model, "steps": DX_STEPS, "step_ms": step_ms,
           "step_median_ms": statistics.median(later),
           "step_spread_ms": [min(later), max(later)],
           "host_s_per_step": host_s,
           "host_s_median": {t: statistics.median(h[t] for h in host_s[1:])
                             for t in prog.host_ops},
           "host_calls_per_step": calls, "losses": losses,
           "profiled_step": {"wall_us": wall, "device_busy_us": busy,
                             "device_busy_share": busy / wall,
                             "kernels": kernels},
           "peak_mem_bytes": peak, "eval_ms": eval_ms,
           "eval_detections": int(dets.shape[0]), "mAP": float(m_ap[0]),
           "train_mode": train_entry.mode,
           "train_reason": train_entry.reason,
           "eval_mode": test_entry.mode, "eval_reason": test_entry.reason,
           "nondeterminism_warnings": warned}
    del state, scope
    torch.cuda.empty_cache()
    return res


def dx_check_train(res, leg):
    check(all(math.isfinite(x) for step in res["losses"] for x in step),
          "detection pipeline %s: losses %s" % (leg, res["losses"]))
    check(res["train_mode"] == "eager" and res["eval_mode"] == "eager",
          "detection pipeline %s: modes %s %s" % (leg, res["train_mode"],
                                                  res["eval_mode"]))
    check(not res["nondeterminism_warnings"],
          "detection pipeline %s: nondeterminism warnings %s"
          % (leg, res["nondeterminism_warnings"]))
    check(0.0 <= res["mAP"] <= 1.0, "detection pipeline %s: mAP %r"
          % (leg, res["mAP"]))


def dx_leg_a(torch, fluid, dp):
    """Leg a: Mask R-CNN R50-FPN at 800 x 1344."""
    t0 = time.perf_counter()
    prog = dp.mask_rcnn_fpn(fluid, **dp.MASK_RCNN_FULL)
    build_s = time.perf_counter() - t0
    res = dict(dx_train_eval(torch, fluid, prog, "mask_rcnn_r50_fpn"),
               leg="a", build_s=build_s, widths=dict(dp.MASK_RCNN_FULL))
    emit({"phase": "detection_pipeline_leg", **res})
    dx_check_train(res, "a")
    check(res["host_calls_per_step"].get("generate_proposals") == 5,
          "detection pipeline a: generate_proposals calls %s"
          % res["host_calls_per_step"])
    return res


def dx_leg_b(torch, fluid, dp):
    """Leg b: SSD MobileNet-v1 at 300."""
    t0 = time.perf_counter()
    prog = dp.ssd_mobilenet_v1(fluid, **dp.SSD_FULL)
    build_s = time.perf_counter() - t0
    res = dict(dx_train_eval(torch, fluid, prog, "ssd_mobilenet_v1"),
               leg="b", build_s=build_s, priors=1917,
               widths=dict(dp.SSD_FULL))
    emit({"phase": "detection_pipeline_leg", **res})
    dx_check_train(res, "b")
    return res


def dx_tiny(torch, fluid, dp, dx, model, builder, size):
    """One tiny program's first step on the card and on the CPU from one
    state: losses and gradients within DET_TOL, the input-exact host
    ops' outputs the recorded ones."""
    import numpy as np

    prog = builder(fluid, **size)
    grads = dp.DET_GRADS[model] + ([dp.SSD_DEEP[0]] if model == "ssd"
                                   else [])
    host = [op for op in prog.main.global_block().ops
            if op.type in prog.host_ops]
    recorded = {t: d for (m, t), d in dp.HOST_OUTPUT_DIGESTS.items()
                if m == model}
    outs = [(op.type, s, n) for op in host if op.type in recorded
            for s, ns in sorted(op.output_names.items()) for n in ns]
    fetch = prog.fetch + [g + "@GRAD" for g in grads] + [n for _, _, n
                                                        in outs]
    state = book_state(fluid, prog)
    feed = prog.feed(np.random.RandomState(0))
    exe, scope = fluid.Executor(), fluid.Scope()
    for n, v in state.items():
        scope.set_var(n, v.clone())
    card = exe.run(prog.main, feed=feed, fetch_list=fetch, scope=scope)
    exe.close()
    cpu = book_cpu_run(torch, fluid, prog, state, [feed], fetch)[0]
    k = len(prog.fetch)
    loss_tol = dp.DET_TOL["mask_loss" if model == "mask_rcnn"
                          else "ssd_loss"]
    grad_tol = dp.DET_TOL["mask_grads" if model == "mask_rcnn"
                          else "ssd_grads"]
    loss_err = max(abs(float(a.reshape(-1)[0]) / float(b.reshape(-1)[0])
                       - 1) for a, b in zip(card[:k], cpu[:k]))
    grad_err = {}
    for i, g in enumerate(grads):
        a, b = card[k + i], cpu[k + i]
        grad_err[g] = float(np.abs(a - b).max()
                            / max(np.abs(b).max(), 1e-30))
    bad_grads = {g: e for g, e in grad_err.items()
                 if e > (dp.SSD_DEEP[1] if g == dp.SSD_DEEP[0]
                         else grad_tol)}
    got = {}
    for (t, s, _), v in zip(outs, card[k + len(grads):]):
        if s in recorded[t]:
            got.setdefault(t, {}).setdefault(s, []).append(
                dx.digest(dx.canon(v)))
    res = {"program": model, "loss_rel_err": loss_err,
           "grad_rel_err": grad_err, "bad_grads": bad_grads,
           "recorded_host_ops": sorted(recorded),
           "host_equal_recorded": got == recorded,
           "ok": loss_err <= loss_tol and not bad_grads
           and got == recorded}
    return res


def dx_leg_c(torch, fluid, dp, dx):
    """Leg c: the tiny Mask R-CNN and SSD, card against CPU."""
    out = {"mask_rcnn": dx_tiny(torch, fluid, dp, dx, "mask_rcnn",
                                dp.mask_rcnn_fpn, dp.TINY_MASK_RCNN),
           "ssd": dx_tiny(torch, fluid, dp, dx, "ssd",
                          dp.ssd_mobilenet_v1, dp.TINY_SSD)}
    res = {"leg": "c", **out, "tol": dict(dp.DET_TOL)}
    emit({"phase": "detection_pipeline_leg", **res})
    bad = [k for k, v in out.items() if not v["ok"]]
    check(not bad, "detection pipeline c: %s" % {k: out[k] for k in bad})
    return res


def dx_leg_d(torch, fluid, cr, dx):
    """Leg d: every case of tests/torch_det_extra_cases.py (its random
    cases at one seed) card against CPU; the capturable ones captured,
    one replay bit-equal to eager; the gathering types twice, bit-equal;
    each host case as a one-op program whose outputs are the reference's
    recorded ones (`HOST_DIGESTS`)."""
    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.core.types import to_numpy
    from paddle_tpu_torch.ops import registry

    dev = resolve_device(None)
    worst, bad, captured, repeated, host = 0.0, [], 0, 0, {}
    table = dict(dx.CASES, **{n: c + ([],) for n, c in
                              dx.RANDOM_CASES.items()})
    for name in sorted(table):
        op, _, attrs, diff, _ = table[name]
        ins = dx.inputs(name)
        got = cr.run_case(op, ins, attrs, dev, diff, seed=7)
        _, err, faults = cr.compare(
            got, cr.run_case(op, ins, attrs, "cpu", diff, seed=7),
            DX_D_RTOL)
        worst = max(worst, err)
        bad += [(name,) + f for f in faults]
        if op in DX_D_REPEAT:
            repeated += 1
            bad += [(name, "repeat") + f for f in cr.compare(
                cr.run_case(op, ins, attrs, dev, diff, seed=7), got,
                0.0)[2]]
        if cr.capturable(op):
            try:
                graph = cr.capture_case(op, ins, attrs, dev, diff, seed=7)
            except RuntimeError as e:
                bad.append((name, "capture", str(e).splitlines()[0][:200]))
            else:
                captured += 1
                bad += [(name, "captured") + f
                        for f in cr.compare(graph, got, 0.0)[2]]
            continue
        block = seq_host_case(fluid, cr, dx, name, fluid.Executor())
        outs = registry.normalize_outs(registry.get_op(op).compute(
            {s: [torch.tensor(a).to(dev) for a in v]
             for s, v in ins.items()}, dict(attrs, _device=dev)))
        digests = {s: [dx.digest(dx.canon(to_numpy(t))) for t in v]
                   for s, v in outs.items()}
        host[name] = {"mode": block["mode"], "ok": block["ok"],
                      "recorded": digests == dx.HOST_DIGESTS[name]}
        if not (block["ok"] and host[name]["recorded"]):
            bad.append((name, "host", host[name], block["reason"]))
    res = {"leg": "d", "cases": len(table),
           "types": len({c[0] for c in table.values()}),
           "captured_cases": captured, "repeated_cases": repeated,
           "host_cases": sorted(host), "max_rel_err": worst,
           "tol": "%g x (1 + max |value|); integers exact; captured and "
           "repeats bit-equal; host outputs the reference's recorded ones"
           % DX_D_RTOL, "failures": bad[:10]}
    emit({"phase": "detection_pipeline_leg", **res})
    check(not bad, "detection pipeline d: %s" % bad[:10])
    return res


def phase_det_extra(torch, name):
    """Phase 22: the detection pipeline on the card, with
    ``FLAGS_cudnn_deterministic`` on."""
    from paddle_tpu_torch import fluid

    dp, cr, dx = tests_modules("torch_detection_programs",
                               "torch_case_runner", "torch_det_extra_cases")
    t0 = time.perf_counter()
    before = fluid.get_flags("FLAGS_cudnn_deterministic")
    os.environ["FLAGS_cudnn_deterministic"] = "1"
    fluid.set_flags({"FLAGS_cudnn_deterministic": True})
    try:
        res = {"leg_a": dx_leg_a(torch, fluid, dp),
               "leg_b": dx_leg_b(torch, fluid, dp),
               "leg_c": dx_leg_c(torch, fluid, dp, dx),
               "leg_d": dx_leg_d(torch, fluid, cr, dx)}
    finally:
        fluid.set_flags(before)
        os.environ.pop("FLAGS_cudnn_deterministic", None)
    a, b = res["leg_a"], res["leg_b"]
    emit({"phase": "detection_pipeline", "device": name,
          "nvidia_smi": nvidia_smi_line(),
          "mask_rcnn_step_median_ms": a["step_median_ms"],
          "mask_rcnn_step_spread_ms": a["step_spread_ms"],
          "mask_rcnn_host_s_median": a["host_s_median"],
          "mask_rcnn_busy_share":
              a["profiled_step"]["device_busy_share"],
          "mask_rcnn_kernels": a["profiled_step"]["kernels"],
          "mask_rcnn_peak_mem_bytes": a["peak_mem_bytes"],
          "mask_rcnn_eval_ms": a["eval_ms"],
          "ssd_step_median_ms": b["step_median_ms"],
          "ssd_step_spread_ms": b["step_spread_ms"],
          "ssd_host_s_median": b["host_s_median"],
          "ssd_busy_share": b["profiled_step"]["device_busy_share"],
          "ssd_kernels": b["profiled_step"]["kernels"],
          "ssd_peak_mem_bytes": b["peak_mem_bytes"],
          "ssd_eval_ms": b["eval_ms"],
          "seconds": time.perf_counter() - t0})
    return res


# -- phase 9 ------------------------------------------------------------------

def build_fluid_resnet(fluid, img, classes, lr, amp, strategy=None):
    """ResNet50 training as bench.py's `build_resnet_train_program`
    builds it, in fresh programs: `resnet(depth=50, scan_stages=True)`,
    softmax_with_cross_entropy then mean, Momentum(lr, 0.9) (with `amp`
    decorated bf16 O2 without loss scaling), wrapped in
    `fleet.distributed_optimizer` when a fleet `strategy` is given,
    `minimize`, `fuse_optimizer_ops`. Returns (main, startup, loss)."""
    from paddle_tpu_torch import fleet
    from paddle_tpu_torch.fluid.contrib import mixed_precision
    from paddle_tpu_torch.models import resnet

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = RESNET_INIT_SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        image = fluid.layers.data("image", shape=[3, img, img],
                                  dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        logits = resnet.resnet(image, class_dim=classes, depth=50,
                               scan_stages=True)
        loss = fluid.layers.mean(
            fluid.layers.loss.softmax_with_cross_entropy(logits, label))
        opt = fluid.optimizer.MomentumOptimizer(lr, momentum=0.9)
        if amp:
            opt = mixed_precision.decorate(opt,
                                           use_dynamic_loss_scaling=False)
        if strategy is not None:
            opt = fleet.distributed_optimizer(opt, strategy)
        opt.minimize(loss)
        fluid.fuse_optimizer_ops(main)
    return main, startup, loss


def resnet_feed(batch, img, classes):
    """bench.py's `_resnet_feed`: images and labels from RandomState(0)."""
    import numpy as np

    r = np.random.RandomState(0)
    return {"image": r.randn(batch, 3, img, img).astype("float32"),
            "label": r.randint(0, classes, (batch, 1)).astype("int64")}


def resnet_model_flops(main, batch):
    """Model FLOPs of one training step: 2 x the multiply-adds of every
    conv2d (output elements x input channels a group x kernel area) and
    fc (`mul`) of the forward, a scan's body counted once an iteration,
    times 3 for the forward and the backward's two products."""
    def block_macs(block):
        macs = 0
        for op in block.ops:
            if op.type == "conv2d":
                out = block._find_var_recursive(op.output("Output")[0])
                w = block._find_var_recursive(op.input("Filter")[0])
                macs += math.prod(out.shape[1:]) * math.prod(w.shape[1:])
            elif op.type == "mul":
                w = block._find_var_recursive(op.input("Y")[0])
                macs += math.prod(w.shape)
            elif op.type == "scan":
                macs += op.attrs["n"] * block_macs(
                    main.block(op.attrs["sub_block"]))
        return macs

    return 3 * 2 * block_macs(main.global_block()) * batch


def attention_launches():
    """The five attention kernels' launch counters, by kernel."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    return {"ragged_paged_attention": rpa.launches - rpa.quant_launches,
            "ragged_paged_attention_int8": rpa.quant_launches,
            "flash_attention_forward": fa.fwd_launches,
            "flash_attention_dkv": fa.dkv_launches,
            "flash_attention_dq": fa.dq_launches}


def zero_attention_launches():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    rpa.launches = rpa.quant_launches = 0
    fa.fwd_launches = fa.dkv_launches = fa.dq_launches = 0
    fa.tc_launches = dict.fromkeys(fa.tc_launches, 0)


def fluid_resnet_leg_a(torch, fluid):
    """Leg a: the bench.py workload at batch 128 on the card: startup,
    warm-up steps, timed steps (the attention kernels' counts zeroed just
    before them and read just after), one profiled step."""
    c = RESNET_A
    main, startup, loss = build_fluid_resnet(fluid, c["img"], c["classes"],
                                             c["lr"], c["amp"])
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = resnet_feed(c["batch"], c["img"], c["classes"])

    def step():
        return float(exe.run(main, feed=feed, fetch_list=[loss],
                             scope=scope)[0][0])

    t0 = time.perf_counter()
    losses = [step() for _ in range(RESNET_WARMUP)]
    warmup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_attention_launches()
    step_ms = []
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = attention_launches()
    peak = torch.cuda.max_memory_allocated()
    busy, wall, kernels = device_busy_share(torch, step)
    median_s = statistics.median(step_ms) / 1e3
    flops = resnet_model_flops(main, c["batch"])
    res = dict(c, depth=50, scan_stages=True, losses=losses,
               first_loss=losses[0], last_loss=losses[-1],
               warmup_s=warmup_s, step_ms=step_ms,
               median_step_ms=median_s * 1e3,
               images_per_sec=c["batch"] / median_s,
               model_flops_per_step=flops,
               gflop_per_image=flops / c["batch"] / 1e9,
               mfu_vs_bf16_peak=flops / median_s / BF16_FLOPS_PER_S,
               peak_mem_bytes=peak,
               profiled_step={"wall_us": wall, "device_busy_us": busy,
                              "device_busy_share": busy / wall,
                              "kernels": kernels},
               attention_launches=launches,
               cudnn_benchmark=torch.backends.cudnn.benchmark)
    check(all(math.isfinite(x) for x in losses),
          "fluid resnet a: non-finite loss %s" % losses)
    check(not any(launches.values()),
          "fluid resnet a: attention kernels launched: %s" % launches)
    del exe, scope
    torch.cuda.empty_cache()
    return res


def fluid_resnet_leg_b(torch, fluid):
    """Leg b: the same program at 32 x 32, fp32, AMP off, on the card and
    on the CPU from one startup state (zero-gamma): the steps' losses, the
    for_test clone's loss and every running statistic."""
    import numpy as np

    from paddle_tpu_torch.core.scope import dump_numpy_state, \
        load_numpy_state

    c = RESNET_B
    main, startup, loss = build_fluid_resnet(fluid, c["img"], c["classes"],
                                             c["lr"], c["amp"])
    test = main.clone(for_test=True)
    feed = resnet_feed(c["batch"], c["img"], c["classes"])
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    stats = [n for n in names if n.endswith(("_bn_mean", "_bn_var"))]
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    state = dump_numpy_state(scope, names)
    state.update((n, np.zeros_like(v)) for n, v in state.items()
                 if n.endswith("2c_bn_scale"))
    out = {}
    for where, place in (("card", None), ("cpu", fluid.CPUPlace())):
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        load_numpy_state(scope, state, exe.device)
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope)[0][0])
                  for _ in range(RESNET_B_STEPS)]
        losses.append(float(exe.run(test, feed=feed, fetch_list=[loss],
                                    scope=scope)[0][0]))
        out[where] = (losses, dump_numpy_state(scope, stats))
    card, cpu = out["card"], out["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
    stat_err = {n: float(np.linalg.norm(card[1][n] - cpu[1][n])
                         / max(np.linalg.norm(cpu[1][n]), 1e-30))
                for n in stats}
    res = dict(c, losses=card[0], losses_cpu=cpu[0],
               loss_rel_err=loss_err, stats=len(stats),
               max_stat_rel_err=max(stat_err.values()), tol=RESNET_B_RTOL)
    check(all(math.isfinite(x) for x in card[0])
          and loss_err <= RESNET_B_RTOL
          and res["max_stat_rel_err"] <= RESNET_B_RTOL,
          "fluid resnet b: card vs CPU: loss rel err %g, max running stat "
          "rel err %g" % (loss_err, res["max_stat_rel_err"]))
    return res


def phase_fluid_resnet(torch, name):
    """ResNet50 ImageNet training through the fluid static graph on the
    card: leg a at full size (batch 128), leg b the card against the
    CPU."""
    from paddle_tpu_torch import fluid

    res = {"phase": "fluid_resnet",
           "config": "ResNet50 (models/resnet.py, scan_stages)",
           "optimizer": "Momentum 0.1/0.9, bf16 AMP O2, "
                        "fuse_optimizer_ops",
           "leg_a": fluid_resnet_leg_a(torch, fluid),
           "leg_b": fluid_resnet_leg_b(torch, fluid)}
    res.update(device=name, nvidia_smi=nvidia_smi_line())
    emit(res)
    return res


# -- phase 10 -----------------------------------------------------------------

@contextlib.contextmanager
def amp_adam(fluid):
    """Inside, `fluid.optimizer.AdamOptimizer` is bf16 AMP O2 (fp32
    masters, no loss scaling) over Adam: `build_transformer_train` makes
    its own optimizer, so AMP is put around the one it makes."""
    from paddle_tpu_torch.fluid.contrib import mixed_precision

    real = fluid.optimizer.AdamOptimizer
    fluid.optimizer.AdamOptimizer = lambda **kw: mixed_precision.decorate(
        real(**kw), use_dynamic_loss_scaling=False)
    try:
        yield
    finally:
        fluid.optimizer.AdamOptimizer = real


def build_fluid_transformer(fluid, cfg, seq, amp):
    """The unrolled `build_transformer_train` in fresh programs: label
    smoothing 0.1, noam (warmup 4000, scale TRANSFORMER_LR) over
    Adam(0.9, 0.997, 1e-9); with `amp` under bf16 AMP O2 and then
    `fuse_optimizer_ops`. Returns (main, startup, loss)."""
    from paddle_tpu_torch.models import transformer

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = TRANSFORMER_INIT_SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        with amp_adam(fluid) if amp else contextlib.nullcontext():
            loss, _ = transformer.build_transformer_train(
                cfg, src_len=seq, tgt_len=seq, lr=TRANSFORMER_LR,
                warmup=TRANSFORMER_WARMUP, label_smooth_eps=0.1)
        if amp:
            fluid.fuse_optimizer_ops(main)
    return main, startup, loss


def transformer_feed(cfg, batch, seq, min_len=16):
    """WMT-like synthetic batches from RandomState(0): per-sentence
    lengths min_len..seq for source and target, ids in [2, V), padding
    id 1 with mask 0; the decoder reads bos (0) and the target shifted
    right, and predicts the target."""
    import numpy as np

    r = np.random.RandomState(0)

    def side(vocab):
        lens = r.randint(min_len, seq + 1, size=batch)
        mask = (np.arange(seq)[None] < lens[:, None]).astype("float32")
        ids = np.where(mask > 0, r.randint(2, vocab, (batch, seq)), 1)
        return ids.astype("int64"), mask

    src, src_mask = side(cfg.src_vocab)
    lbl, tgt_mask = side(cfg.tgt_vocab)
    tgt = np.concatenate([np.zeros((batch, 1), "int64"), lbl[:, :-1]], 1)
    return {"src_ids": src, "tgt_ids": tgt, "lbl_ids": lbl,
            "src_mask": src_mask, "tgt_mask": tgt_mask}


def transformer_model_flops(main, batch):
    """Model FLOPs of one training step: 2 x the multiply-adds of every
    `mul` (the projections, FFNs and vocab head) and `matmul` (attention's
    two products) of the forward, times 3 for the forward and the
    backward's two products."""
    block = main.global_block()

    def shape(name):
        return [batch if d < 0 else d
                for d in block._find_var_recursive(name).shape]

    macs = 0
    for op in block.ops:
        if op.type == "backward":
            break
        if op.type == "mul":
            x, w = shape(op.input("X")[0]), shape(op.input("Y")[0])
            macs += math.prod(x[:op.attrs.get("x_num_col_dims", 1)]) \
                * math.prod(w)
        elif op.type == "matmul":
            x = shape(op.input("X")[0])
            k = x[-2] if op.attrs.get("transpose_X") else x[-1]
            macs += math.prod(shape(op.output("Out")[0])) * k
    return 3 * 2 * macs


def fluid_transformer_leg_a(torch, fluid):
    """Leg a: Transformer-big training under bf16 AMP O2 at full width
    on the card: startup, warm-up steps, timed steps with the attention
    kernels' counts zeroed just before them and read just after, one
    profiled step. Returns (result, trained scope, feed)."""
    from paddle_tpu_torch.models import transformer

    c = TRANSFORMER_A
    cfg = transformer.TransformerConfig.big()
    main, startup, loss = build_fluid_transformer(fluid, cfg, c["seq"],
                                                  amp=True)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = transformer_feed(cfg, c["batch"], c["seq"])

    def step():
        return float(exe.run(main, feed=feed, fetch_list=[loss],
                             scope=scope)[0][0])

    t0 = time.perf_counter()
    losses = [step() for _ in range(TRANSFORMER_WARMUP_STEPS)]
    warmup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_attention_launches()
    step_ms = []
    for _ in range(TRANSFORMER_STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = attention_launches()
    peak = torch.cuda.max_memory_allocated()
    busy, wall, kernels = device_busy_share(torch, step)
    median_s = statistics.median(step_ms) / 1e3
    flops = transformer_model_flops(main, c["batch"])
    tokens = c["batch"] * c["seq"]
    res = dict(c, d_model=cfg.d_model, heads=cfg.n_head, d_ff=cfg.d_ff,
               layers=cfg.n_layer, vocab=cfg.tgt_vocab,
               dropout=cfg.dropout, label_smoothing=0.1,
               noam_warmup=TRANSFORMER_WARMUP, lr_scale=TRANSFORMER_LR,
               losses=losses, warmup_s=warmup_s, step_ms=step_ms,
               median_step_ms=median_s * 1e3,
               target_tokens_per_step=tokens,
               unpadded_target_tokens=int(feed["tgt_mask"].sum()),
               tokens_per_sec=tokens / median_s,
               model_flops_per_step=flops,
               mfu_vs_bf16_peak=flops / median_s / BF16_FLOPS_PER_S,
               peak_mem_bytes=peak,
               profiled_step={"wall_us": wall, "device_busy_us": busy,
                              "device_busy_share": busy / wall,
                              "kernels": kernels},
               attention_launches=launches,
               lr_decay_counter=int(scope.find_var(
                   "@LR_DECAY_COUNTER@").reshape(-1)[0]))
    check(all(math.isfinite(x) for x in losses),
          "fluid transformer a: non-finite loss %s" % losses)
    check(not any(launches.values()),
          "fluid transformer a: attention kernels launched: %s" % launches)
    return res, scope, feed


def fluid_transformer_leg_b(torch, scope, feed):
    """Leg b: beam search over leg a's trained scope, the first
    TRANSFORMER_B["sentences"] source sentences, with the attention
    kernels' counts zeroed just before and read just after."""
    from paddle_tpu_torch.models import transformer

    c = TRANSFORMER_B
    cfg = transformer.TransformerConfig.big()
    n = c["sentences"]
    zero_attention_launches()
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seqs, scores = transformer.beam_search_decode(
        scope, feed["src_ids"][:n], feed["src_mask"][:n], cfg,
        beam_size=c["beam"], max_out_len=c["max_out_len"],
        bos_id=c["bos"], eos_id=c["eos"], alpha=c["alpha"], stats=stats)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = attention_launches()
    # the raw log-probabilities (score times the length penalty) come
    # out of the top-k sorted, best beam first
    lengths = (seqs[:, :, 1:] != c["eos"]).sum(-1).float() + 1.0
    raw = scores * ((5.0 + lengths) / 6.0) ** c["alpha"]
    sorted_ok = bool((raw[:, :-1] >= raw[:, 1:] - 1e-4 * raw.abs()[:, 1:]
                      ).all())
    generated = n * c["beam"] * stats["steps"]
    res = dict(c, decode_ms=decode_s * 1e3, steps=stats["steps"],
               generated_tokens=generated,
               generated_tokens_per_sec=generated / decode_s,
               finished_beams=int((seqs == c["eos"]).any(-1).sum()),
               seqs_shape=list(seqs.shape), scores_shape=list(scores.shape),
               best_scores=scores[:, 0].tolist(), beams_sorted=sorted_ok,
               attention_launches=launches)
    check(list(seqs.shape) == [n, c["beam"], c["max_out_len"] + 1]
          and list(scores.shape) == [n, c["beam"]],
          "fluid transformer b: shapes %s %s" % (seqs.shape, scores.shape))
    check(bool((seqs[:, :, 0] == c["bos"]).all()),
          "fluid transformer b: a sequence does not start with bos")
    check(bool(torch.isfinite(scores).all()) and sorted_ok,
          "fluid transformer b: scores not finite or beams not sorted")
    check(not any(launches.values()),
          "fluid transformer b: attention kernels launched: %s" % launches)
    return res


def cf_while_loop(fluid):
    """tests/test_control_flow.py's while_loop: 5! by a functional
    while."""
    L = fluid.layers
    i = L.fill_constant([1], "int64", 1)
    limit = L.fill_constant([1], "int64", 6)
    fact = L.fill_constant([1], "int64", 1)

    def body(i, fact):
        return (L.elementwise_add(i, L.fill_constant([1], "int64", 1)),
                L.elementwise_mul(fact, i))

    i, fact = L.while_loop(lambda i, fact: L.less_than(i, limit), body,
                           [i, fact])
    return [fact, i]


def cf_cond_in_while(fluid):
    """tests/test_control_flow.py's cond inside a while: the branch
    updates the loop's accumulator (3 if i is odd, else 1)."""
    L = fluid.layers
    i = L.fill_constant([1], "int64", 0)
    six = L.fill_constant([1], "int64", 6)
    acc = L.fill_constant([1], "float32", 0.0)
    cond_var = L.less_than(i, six)
    w = L.While(cond_var)
    with w.block():
        is_odd = L.equal(L.elementwise_mod(i, L.fill_constant(
            [1], "int64", 2)), L.fill_constant([1], "int64", 1))

        def add(v):
            def branch():
                L.assign(L.elementwise_add(
                    acc, L.fill_constant([1], "float32", v)), output=acc)
                return L.fill_constant([1], "float32", 0.0)
            return branch

        L.cond(is_odd, add(3.0), add(1.0))
        L.increment(i, value=1)
        L.less_than(i, six, cond=cond_var)
    return [acc, i]


def fluid_transformer_leg_c(torch, fluid):
    """Leg c: the card against the CPU in fp32 (AMP off, TF32 off) at
    Transformer-big widths, 2 + 2 layers, dropout 0, from one startup
    state: noam-Adam steps, then beam search from each trained scope;
    then the two control-flow programs."""
    import numpy as np

    from paddle_tpu_torch.core.scope import dump_numpy_state, \
        load_numpy_state
    from paddle_tpu_torch.models import transformer

    c = TRANSFORMER_C
    cfg = transformer.TransformerConfig.big()
    cfg.n_layer, cfg.dropout = c["layers"], 0.0
    main, startup, loss = build_fluid_transformer(fluid, cfg, c["seq"],
                                                  amp=False)
    feed = transformer_feed(cfg, c["batch"], c["seq"], min_len=c["seq"] // 2)
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    state = dump_numpy_state(scope, sorted(
        v.name for v in main.list_vars() if v.persistable))
    out = {}
    for where, place, dev in (("card", None, None),
                              ("cpu", fluid.CPUPlace(), "cpu")):
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        load_numpy_state(scope, state, exe.device)
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope)[0][0])
                  for _ in range(c["steps"])]
        stats = {}
        seqs, scores = transformer.beam_search_decode(
            scope, feed["src_ids"], feed["src_mask"], cfg,
            beam_size=c["beam"], max_out_len=c["max_out_len"], device=dev,
            stats=stats)
        out[where] = (losses, seqs.cpu().numpy(), scores.cpu().numpy(),
                      stats["min_topk_margin"].cpu().numpy())
    card, cpu = out["card"], out["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
    margin = cpu[3]
    waived = [int(b) for b in np.nonzero(margin < c["margin"])[0]]
    seq_diff = [b for b in range(c["batch"])
                if not np.array_equal(card[1][b], cpu[1][b])]
    score_err = float(np.max(np.abs(card[2] - cpu[2])
                             / np.maximum(np.abs(cpu[2]), 1e-30)))
    flow = {}
    for fname, build in (("while_loop", cf_while_loop),
                         ("cond_in_while", cf_cond_in_while)):
        vals, entry = [], None
        for place in (None, fluid.CPUPlace()):
            m, s = fluid.Program(), fluid.Program()
            with fluid.program_guard(m, s), fluid.unique_name.guard():
                fetch = build(fluid)
            exe = fluid.Executor(place)
            sc = fluid.Scope()
            exe.run(s, scope=sc)
            vals.append([v.tolist() for v in exe.run(m, fetch_list=fetch,
                                                     scope=sc)])
            entry = entry or exe.last_entry
        flow[fname] = {"card": vals[0], "cpu": vals[1], "mode": entry.mode,
                       "reason": entry.reason}
        check(vals[0] == vals[1], "fluid transformer c: %s card %s vs "
              "CPU %s" % (fname, vals[0], vals[1]))
        # host control flow runs eagerly by design, and says why
        check(entry.mode == "eager" and "'while'" in entry.reason,
              "fluid transformer c: %s is %s (%s), not eager for its "
              "while" % (fname, entry.mode, entry.reason))
    res = dict(c, d_model=cfg.d_model, losses=card[0], losses_cpu=cpu[0],
               loss_rel_err=loss_err, decode_score_rel_err=score_err,
               cpu_min_topk_margin=margin.tolist(),
               sequences_waived=waived, sequences_differ=seq_diff,
               control_flow=flow)
    check(all(math.isfinite(x) for x in card[0])
          and loss_err <= c["tol"],
          "fluid transformer c: card vs CPU loss rel err %g" % loss_err)
    check(not set(seq_diff) - set(waived),
          "fluid transformer c: sequences differ for sentences %s (CPU "
          "top-k margins %s)" % (seq_diff, margin.tolist()))
    check(score_err <= c["tol"],
          "fluid transformer c: decode scores rel err %g" % score_err)
    return res


def phase_fluid_transformer(torch, name):
    """Transformer-big WMT en-de through the fluid static graph on the
    card: leg a training at full width, leg b beam search over its
    trained scope, leg c the card against the CPU."""
    from paddle_tpu_torch import fluid

    leg_a, scope, feed = fluid_transformer_leg_a(torch, fluid)
    leg_b = fluid_transformer_leg_b(torch, scope, feed)
    del scope
    torch.cuda.empty_cache()
    res = {"phase": "fluid_transformer",
           "config": "Transformer big (models/transformer.py "
                     "TransformerConfig.big)",
           "optimizer": "noam + Adam(0.9, 0.997, 1e-9), bf16 AMP O2, "
                        "fuse_optimizer_ops",
           "leg_a": leg_a, "leg_b": leg_b,
           "leg_c": fluid_transformer_leg_c(torch, fluid)}
    res.update(device=name, nvidia_smi=nvidia_smi_line())
    emit(res)
    return res


# -- phase 11 -----------------------------------------------------------------

def graph_flag(fluid, on):
    fluid.set_flags({"FLAGS_cuda_graphs": bool(on)})


def fluid_run(torch, fluid, main, state, feeds, fetch, graphs):
    """`len(feeds)` runs of `main` from a copy of `state` (name -> tensor
    on the card), capture on or off, the program's seed counter put back
    after: fetches (numpy) and host-clock ms a step (ending in a
    synchronize), the final persistables (tensors), the entry's info, and
    the executor and scope (for a profiled step after)."""
    graph_flag(fluid, graphs)
    exe = fluid.Executor()
    scope = fluid.Scope()
    for n, v in state.items():
        scope.set_var(n, v.clone())
    counter = main._seed_counter
    fetches, step_ms = [], []
    for feed in feeds:
        t0 = time.perf_counter()
        fetches.append(exe.run(main, feed=feed, fetch_list=fetch,
                               scope=scope))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    main._seed_counter = counter
    graph_flag(fluid, True)
    return {"fetches": fetches, "step_ms": step_ms,
            "final": {n: scope.find_var(n).clone() for n in state},
            "info": exe.last_entry.info(), "exe": exe, "scope": scope}


def run_tensors(torch, run):
    """(name, tensor) of a run's every fetch and final persistable."""
    for i, step in enumerate(run["fetches"]):
        for j, v in enumerate(step):
            yield "fetch%d.%d" % (i, j), torch.from_numpy(
                v.astype("float32") if v.dtype.kind == "V" else v)
    yield from run["final"].items()


def max_abs_diff(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() \
        else 0.0


def graph_vs_eager(torch, graph, eagers):
    """Per tensor: where the eager runs are bit-equal to each other the
    graph run must equal them bit for bit; elsewhere (atomics in some
    backward kernels sum in another order each run) it must be within
    twice the eager-to-eager difference, the largest between any two
    eager runs. Returns (case, worst graph-eager difference, tensors held
    exactly, tensors held within 2x, the first violations)."""
    g = dict(run_tensors(torch, graph))
    runs = [dict(run_tensors(torch, e)) for e in eagers]
    exact = within = 0
    worst, bad = 0.0, []
    for n, ta in runs[0].items():
        others = [r[n] for r in runs[1:]]
        d_ge = max_abs_diff(g[n], ta)
        worst = max(worst, d_ge)
        if all(torch.equal(ta, tb) for tb in others):
            exact += 1
            if not torch.equal(g[n], ta):
                bad.append((n, d_ge, 0.0))
        else:
            within += 1
            d_ee = max(max_abs_diff(x, y) for i, x in enumerate(
                [ta] + others) for y in others[i:])
            if d_ge > 2 * d_ee:
                bad.append((n, d_ge, d_ee))
    case = "bit-equal" if within == 0 else \
        "bit-equal where eager is, else within 2x eager-to-eager"
    return case, worst, exact, within, bad[:5]


def graph_leg(torch, fluid, name, main, startup, feeds, fetch):
    """One leg of phase 11: the startup once, then the same steps from
    its state with capture on, eagerly, and eagerly again; the check of
    graph against eager; step ms of replays and of eager steps; the busy
    share and kernels of one profiled replay; the capture's ms and pool
    bytes."""
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    state = {n: scope.find_var(n).clone() for n in sorted(
        v.name for v in main.list_vars() if v.persistable)}
    del exe, scope
    graph = fluid_run(torch, fluid, main, state, feeds, fetch, True)
    counter = main._seed_counter
    busy, wall, kernels = device_busy_share(
        torch, lambda: graph["exe"].run(main, feed=feeds[-1],
                                        fetch_list=fetch,
                                        scope=graph["scope"]))
    main._seed_counter = counter  # the eager runs draw the same seeds
    info = graph["exe"].last_entry.info()
    graph["exe"].close()
    del graph["exe"], graph["scope"]
    eagers = []
    for _ in range(GRAPH_EAGER_RUNS):
        eagers.append(fluid_run(torch, fluid, main, state, feeds, fetch,
                                False))
        eagers[-1]["exe"].close()
    eager = eagers[0]
    case, worst, exact, within, bad = graph_vs_eager(torch, graph, eagers)
    res = {"leg": name, "steps": len(feeds), "mode": info["mode"],
           "reason": info["reason"], "eager_mode": eager["info"]["mode"],
           "graph_step_ms": graph["step_ms"],
           "eager_step_ms": eager["step_ms"],
           "graph_median_ms": statistics.median(graph["step_ms"][2:]),
           "eager_median_ms": statistics.median(eager["step_ms"][1:]),
           "replay": {"wall_us": wall, "device_busy_us": busy,
                      "device_busy_share": busy / wall, "kernels": kernels},
           "capture_ms": info.get("capture_ms"),
           "pool_bytes": info.get("pool_bytes"),
           "launches_per_replay": info.get("launches"),
           "case": case, "max_abs_graph_vs_eager": worst,
           "tensors_exact": exact, "tensors_within_2x": within,
           "violations": bad}
    del graph, eager, eagers, state
    torch.cuda.empty_cache()
    emit(dict(res, phase="graphs_leg"))
    check(info["mode"] == "graph" and info["phase"] == "captured",
          "graphs %s: the step is %s (%s), not captured" % (
              name, info["mode"], info["reason"]))
    check(res["eager_mode"] == "eager",
          "graphs %s: FLAGS_cuda_graphs off did not run eagerly" % name)
    check(not bad, "graphs %s: graph vs eager outside the rule: %s"
          % (name, bad))
    return res


def graph_legs(torch, fluid):
    """The fluid legs of phase 11: (name, main, startup, feeds, fetch)."""
    from paddle_tpu_torch.models import bert, transformer

    x, y = fluid_mnist_data()
    mnist = [{"img": x[i:i + FLUID_BATCH], "label": y[i:i + FLUID_BATCH]}
             for i in range(0, GRAPH_STEPS["mnist"] * FLUID_BATCH,
                            FLUID_BATCH)]
    for kind in ("sgd", "adam"):
        main, startup, loss, acc = build_fluid_mlp(fluid, kind)
        yield "mnist_" + kind, main, startup, mnist, [loss, acc]
    for leg in BERT_FLUID_LEGS:
        cfg = bert_cfg(leg["seq"])
        main, startup, total, _ = build_fluid_bert(fluid, cfg, leg["seq"],
                                                   leg["remat"])
        feed = bert.bert_feed(cfg, leg["batch"], leg["seq"])
        yield "bert_" + leg["name"], main, startup, \
            [feed] * GRAPH_STEPS["large"], [total]
    c = RESNET_A
    main, startup, loss = build_fluid_resnet(fluid, c["img"], c["classes"],
                                             c["lr"], c["amp"])
    yield "resnet50_a", main, startup, \
        [resnet_feed(c["batch"], c["img"], c["classes"])] \
        * GRAPH_STEPS["large"], [loss]
    cfg = transformer.TransformerConfig.big()
    main, startup, loss = build_fluid_transformer(
        fluid, cfg, TRANSFORMER_A["seq"], amp=True)
    yield "transformer_a", main, startup, [transformer_feed(
        cfg, TRANSFORMER_A["batch"], TRANSFORMER_A["seq"])] \
        * GRAPH_STEPS["large"], [loss]


def graph_serving(torch, serving):
    """The bf16 serving trace of phase 4 with every bucket captured and
    with capture off: equal token streams; tokens/s of each; the busy
    share and kernels of one profiled decode replay; capture ms and pool
    bytes summed over the buckets."""
    from paddle_tpu_torch import fluid

    trace = serving.synthetic_trace(**BF16_TRACE)
    model = serving.TinyDecoderLM(serving.TinyLMConfig(**BERT_BASE))
    out = {}
    for on in (True, False):
        graph_flag(fluid, on)
        engine = serving.Engine(model, config=serving.EngineConfig(
            kv_dtype="bfloat16", **POOL), seed=0, device=DEV)
        engine.warmup()
        reqs = [engine.submit(tr.prompt, max_new_tokens=tr.max_new_tokens)
                for tr in trace]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = engine.stats()
        info = engine._compiler.bucket_info()
        out[on] = {"streams": [list(r.output_tokens) for r in reqs],
                   "tokens_per_sec": st["tokens_generated"] / wall,
                   "wall_s": wall,
                   "mean_decode_ms": st["decode_ms_total"]
                   / max(1, st["decode_dispatches"]),
                   "modes": sorted({v["mode"] for v in info.values()})}
        if on:
            decode = max(b for b in info if b[1] == 1)
            g = engine._compiler._buckets[decode].graph
            busy, wall_us, kernels = device_busy_share(torch, g.replay)
            out[on].update(
                capture_ms=sum(v["capture_ms"] for v in info.values()),
                pool_bytes=sum(v["pool_bytes"] for v in info.values()),
                buckets=len(info), replay_bucket=list(decode),
                replay={"wall_us": wall_us, "device_busy_us": busy,
                        "device_busy_share": busy / wall_us,
                        "kernels": kernels})
        engine.close()
        del engine
    graph_flag(fluid, True)
    del model
    torch.cuda.empty_cache()
    g, e = out[True], out[False]
    res = {"leg": "serving_bf16", "mode": "graph" if g["modes"] == [
        "graph"] else g["modes"], "graph_tokens_per_sec": g["tokens_per_sec"],
        "eager_tokens_per_sec": e["tokens_per_sec"],
        "graph_mean_decode_ms": g["mean_decode_ms"],
        "eager_mean_decode_ms": e["mean_decode_ms"],
        "replay_bucket": g["replay_bucket"], "replay": g["replay"],
        "capture_ms": g["capture_ms"], "pool_bytes": g["pool_bytes"],
        "buckets": g["buckets"], "streams_equal": g["streams"] == e[
            "streams"], "case": "token streams equal"}
    emit(dict(res, phase="graphs_leg"))
    check(g["modes"] == ["graph"] and e["modes"] == ["eager"],
          "graphs serving: bucket modes %s / %s" % (g["modes"], e["modes"]))
    check(res["streams_equal"], "graphs serving: token streams differ "
          "between captured and eager buckets")
    return res


def phase_graphs(torch, name):
    """Phase 11: every captured path against the same steps run eagerly
    from the same start state."""
    from paddle_tpu_torch import fluid, serving

    legs = [graph_leg(torch, fluid, *leg) for leg in graph_legs(torch,
                                                                fluid)]
    legs.append(graph_serving(torch, serving))
    res = {"phase": "graphs", "legs": [leg["leg"] for leg in legs],
           "device": name, "nvidia_smi": nvidia_smi_line()}
    emit(res)
    return dict(res, legs=legs)


# -- phase 12 -----------------------------------------------------------------

def host_bits(v):
    """A tensor's or array's bits as a numpy array on the host (bfloat16
    as uint16: numpy has no bfloat16, and the port does not import
    `ml_dtypes`)."""
    from paddle_tpu_torch.fluid import io

    return io._host_array(v)[0]


def digest(v):
    """sha256 of a value's bits."""
    import hashlib

    return hashlib.sha256(host_bits(v).tobytes()).hexdigest()


def fleet_state_digest(exe, program, scope, names):
    """name -> sha256 of the value's bytes at its logical shape
    (bit-equality across ranks without moving the values; the moments
    and masters the sharded update keeps as 1/N slices are gathered
    first, so every rank calls this alike)."""
    return {n: digest(exe.read_logical(n, program, scope)) for n in names}


def fleet_dump(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


def fleet_worker_a(out_dir):
    """Leg a, one rank: ResNet50 at phase 9 leg a's size through fleet,
    2 warm-up and 3 timed steps of the global batch, eager (gloo)."""
    import torch

    from paddle_tpu_torch import distributed, fleet, fluid
    from paddle_tpu_torch.ops import collective_ops

    c = FLEET_A
    rank = distributed.get_rank()
    main, startup, loss = build_fluid_resnet(
        fluid, c["img"], c["classes"], c["lr"], True,
        strategy=fleet.DistributedStrategy())
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = resnet_feed(c["batch"], c["img"], c["classes"])

    def step():
        return exe.run(main, feed=feed, fetch_list=[loss],
                       scope=scope)[0].ravel().tolist()

    losses = [step() for _ in range(FLEET_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    collective_ops.reset_stats()
    step_ms = []
    for _ in range(FLEET_STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    stats = {k: dict(v) for k, v in collective_ops.stats.items()}
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    fleet_dump(os.path.join(out_dir, "a%d.json" % rank), {
        "losses": losses, "step_ms": step_ms,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "collectives": stats, "device": str(exe.device),
        "mode": exe.last_entry.mode, "reason": exe.last_entry.reason,
        "opt_state": {k: v for k, v in exe.last_entry.info().items()
                      if k.startswith(("opt_state", "grad_buckets"))},
        "types": [op.type for op in main.global_block().ops],
        "digest": fleet_state_digest(exe, main, scope, names)})


def fleet_worker_b(out_dir, where, sync_bn, state_path):
    """Leg b, one rank: ResNet50 at 32 x 32 in fp32 through fleet
    (`sync_bn`: with sync_batch_norm) on the card or the CPU; rank 0
    starts from the saved state, rank 1 from the executor's broadcast."""
    import numpy as np
    import torch

    from paddle_tpu_torch import distributed, fleet, fluid
    from paddle_tpu_torch.core.scope import dump_numpy_state, \
        load_numpy_state

    c = FLEET_B
    torch.set_num_threads(2)
    rank = distributed.get_rank()
    st = fleet.DistributedStrategy()
    st.sync_batch_norm = sync_bn
    main, startup, loss = build_fluid_resnet(fluid, c["img"], c["classes"],
                                             c["lr"], False, strategy=st)
    exe = fluid.Executor(None if where == "card" else fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    if rank == 0:
        with np.load(state_path) as f:
            load_numpy_state(scope, dict(f), exe.device)
    feed = resnet_feed(c["batch"], c["img"], c["classes"])
    losses = [exe.run(main, feed=feed, fetch_list=[loss],
                      scope=scope)[0].ravel().tolist()
              for _ in range(c["steps"])]
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    stats = [n for n in names if n.endswith(("_bn_mean", "_bn_var"))]
    fleet_dump(os.path.join(out_dir, "b_%s_%d_%d.json" % (
        where, int(sync_bn), rank)), {
        "losses": losses, "device": str(exe.device),
        "sync_bn_ops": sum(op.type == "sync_batch_norm"
                           for b in main.blocks for op in b.ops),
        "stats": {n: v.tolist() for n, v in dump_numpy_state(
            scope, stats).items()} if rank == 0 else {},
        "digest": fleet_state_digest(
            exe, main, scope, [n for n in names if n not in stats])})


def fleet_collective_program(fluid, layers_collective):
    """Every single-input collective op of the port over one [8, 4]
    input, in a data-parallel program: (program, fetch vars)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        block = main.global_block()
        fetch = [layers_collective._c_allreduce(x, reduce_type=r)
                 for r in ("sum", "max", "min", "prod")]
        fetch += [layers_collective._c_broadcast(x, root=0),
                  layers_collective._c_allgather(x, nranks=1),
                  layers_collective._c_reducescatter(x, nranks=1),
                  layers_collective._c_sync_calc_stream(x),
                  layers_collective._c_sync_comm_stream(x)]
        for op, attrs in FLEET_C_OPS:
            o = block.create_var(name="c_" + op, dtype="float32",
                                 shape=(-1, 4))
            block.append_op(type=op, inputs={"X": [x]},
                            outputs={"Out": [o]}, attrs=attrs)
            fetch.append(o)
    return fluid.CompiledProgram(main).with_data_parallel(), fetch


def fleet_worker_c(out_dir):
    """Leg c, the one rank of an NCCL world: the collective program run
    eagerly, then captured and replayed; the MNIST MLP 8 steps through
    `with_data_parallel` against the plain program, both captured."""
    import numpy as np
    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.core.scope import dump_numpy_state, \
        load_numpy_state
    from paddle_tpu_torch.fluid.layers import collective
    from paddle_tpu_torch.ops import collective_ops
    from paddle_tpu_torch.parallel import env as penv

    res = {"backend": penv.global_mesh().backend,
           "world": penv.global_mesh().size}
    prog, fetch = fleet_collective_program(fluid, collective)
    x = np.arange(32, dtype="float32").reshape(8, 4) - 9.0
    exe = fluid.Executor()
    collective_ops.reset_stats()
    runs, phases = [], []
    for _ in range(4):
        runs.append(exe.run(prog, feed={"x": x}, fetch_list=fetch))
        phases.append(exe.last_entry.phase)
    res.update(phases=phases, mode=exe.last_entry.mode,
               eager_collectives=collective_ops.stats.get(
                   "all_reduce", {}).get("calls", 0),
               ops=len(fetch))
    res["replays_equal_eager"] = all(
        np.array_equal(a, b) for r in runs[2:] for a, b in zip(r, runs[0]))
    plain = prog._unwrap().clone()
    plain._data_parallel = False
    cpu = fluid.Executor(fluid.CPUPlace()).run(plain, feed={"x": x},
                                               fetch_list=fetch)
    res["eager_equals_identity"] = all(
        np.array_equal(a, b) for a, b in zip(runs[0], cpu))
    mlp = {}
    for name, dp, kind in (("plain", False, "sgd"),
                           ("with_data_parallel", True, "sgd"),
                           ("f16_plain", False, "sgd_f16"),
                           ("f16_with_data_parallel", True, "sgd_f16")):
        main, startup, loss, acc = build_fluid_mlp(fluid, kind)
        scope = fluid.Scope()
        exe = fluid.Executor()
        if name in ("plain", "f16_plain"):
            exe.run(startup, scope=scope)
            state = dump_numpy_state(
                scope, [v.name for v in main.list_vars() if v.persistable])
        else:
            load_numpy_state(scope, state)
        collective_ops.reset_stats()
        target = fluid.CompiledProgram(main).with_data_parallel() if dp \
            else main
        xs, ys = fluid_mnist_data()
        losses = []
        for i in range(FLEET_C_STEPS):
            feed = {"img": xs[i * FLUID_BATCH:(i + 1) * FLUID_BATCH],
                    "label": ys[i * FLUID_BATCH:(i + 1) * FLUID_BATCH]}
            losses.append(exe.run(target, feed=feed, fetch_list=[loss],
                                  scope=scope)[0].tolist())
        mlp[name] = {"losses": losses, "mode": exe.last_entry.mode,
                     "phase": exe.last_entry.phase,
                     "all_reduce_calls": collective_ops.stats.get(
                         "all_reduce", {}).get("calls", 0)}
    res["mlp"] = mlp
    fleet_dump(os.path.join(out_dir, "c.json"), res)


def collectives_per_step(stats, steps):
    """Each rank's collectives a step from its `collective_ops.stats`
    over `steps` steps: host ms, calls and MB in all, and by kind."""
    return {
        "collective_ms_per_step": [sum(
            v["seconds"] for v in st.values()) * 1e3 / steps
            for st in stats],
        "collective_calls_per_step": [sum(
            v["calls"] for v in st.values()) / steps for st in stats],
        "collective_mb_per_step": [sum(
            v["bytes"] for v in st.values()) / 1e6 / steps for st in stats],
        "collectives_by_kind": [{k: {
            "calls": v["calls"] / steps, "ms": v["seconds"] * 1e3 / steps,
            "mb": v["bytes"] / 1e6 / steps} for k, v in st.items()}
            for st in stats]}


def fleet_spawn(distributed, func, args, nprocs, backend):
    """Run `func(*args)` on `nprocs` ranks over `backend`; a failing rank
    or the time limit fails the phase (every process is gone after)."""
    try:
        distributed.spawn(func, args, nprocs=nprocs, backend=backend,
                          timeout=FLEET_TIMEOUT_S)
    except (RuntimeError, TimeoutError) as e:
        raise SmokeFailure("fleet_dp: %s" % e)


def join_spawns(ctxs, what):
    """Join spawns started together (`distributed.spawn(..., join=False)`):
    a failing rank or the time limit fails the phase, and every process
    of every spawn is gone after."""
    for sc in ctxs:
        try:
            sc.join(FLEET_TIMEOUT_S)
        except (RuntimeError, TimeoutError) as e:
            for other in ctxs:
                try:
                    other.join(1)
                except (RuntimeError, TimeoutError):
                    pass
            raise SmokeFailure("%s: %s" % (what, e))


def fleet_read(out_dir, name):
    with open(os.path.join(out_dir, name)) as f:
        return json.load(f)


def fleet_leg_a(torch, distributed, out_dir, single):
    fleet_spawn(distributed, fleet_worker_a, (out_dir,), 2, "gloo")
    ranks = [fleet_read(out_dir, "a%d.json" % r) for r in range(2)]
    c = FLEET_A
    med = [statistics.median(r["step_ms"]) for r in ranks]
    res = dict(c, ranks=2, backend="gloo", per_rank_batch=c["batch"] // 2,
               losses=ranks[0]["losses"],
               median_step_ms=med, step_ms=[r["step_ms"] for r in ranks],
               images_per_sec=c["batch"] / (max(med) / 1e3),
               **collectives_per_step([r["collectives"] for r in ranks],
                                      FLEET_STEPS),
               opt_state=[r["opt_state"] for r in ranks],
               peak_mem_bytes=[r["peak_mem_bytes"] for r in ranks],
               devices=[r["device"] for r in ranks],
               mode=ranks[0]["mode"], eager_reason=ranks[0]["reason"],
               c_allreduce_sum_ops=ranks[0]["types"].count(
                   "c_allreduce_sum"),
               single_process={k: single[k] for k in (
                   "batch", "median_step_ms", "images_per_sec",
                   "peak_mem_bytes")})
    differ = [n for n in ranks[0]["digest"]
              if ranks[0]["digest"][n] != ranks[1]["digest"][n]
              and not n.endswith(("_bn_mean", "_bn_var"))]
    res["replicas_bit_equal"] = not differ
    emit({"phase": "fleet_dp_leg", "leg": "a", **res})
    check(all(math.isfinite(v) for step in res["losses"] for v in step)
          and len(res["losses"][0]) == 2,
          "fleet_dp a: losses %s" % res["losses"])
    check(not differ, "fleet_dp a: replicas differ in %s" % differ[:5])
    check(res["mode"] == "eager" and "gloo" in (res["eager_reason"] or ""),
          "fleet_dp a: expected an eager gloo block, got %s (%s)"
          % (res["mode"], res["eager_reason"]))
    return res


def fleet_leg_b(torch, distributed, fluid, out_dir, beside=()):
    """Card against CPU, fleet DP with and without sync_batch_norm: the
    four spawns (card and CPU, each without and with it) run together,
    with the spawns of `beside` (callables that start a spawn: leg c's),
    which check numbers only."""
    import numpy as np

    from paddle_tpu_torch.core.scope import dump_numpy_state

    c = FLEET_B
    main, startup, _ = build_fluid_resnet(fluid, c["img"], c["classes"],
                                          c["lr"], False)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    state = dump_numpy_state(scope, sorted(
        v.name for v in main.list_vars() if v.persistable))
    state.update((n, np.zeros_like(v)) for n, v in state.items()
                 if n.endswith("2c_bn_scale"))
    path = os.path.join(out_dir, "b_state.npz")
    np.savez(path, **state)
    res = {}
    ctxs = [distributed.spawn(
        fleet_worker_b, (out_dir, where, sync_bn, path), nprocs=2,
        backend="gloo", join=False)
        for sync_bn in (False, True) for where in ("card", "cpu")]
    ctxs += [start() for start in beside]
    join_spawns(ctxs, "fleet_dp b, c")
    for sync_bn in (False, True):
        got = {w: [fleet_read(out_dir, "b_%s_%d_%d.json"
                              % (w, int(sync_bn), r)) for r in range(2)]
               for w in ("card", "cpu")}
        card, cpu = got["card"][0], got["cpu"][0]
        loss_err = max(abs(a - b) / abs(b) for sa, sb in zip(
            card["losses"], cpu["losses"]) for a, b in zip(sa, sb))
        stat_err = max(float(np.linalg.norm(
            np.asarray(card["stats"][n]) - np.asarray(cpu["stats"][n]))
            / max(np.linalg.norm(cpu["stats"][n]), 1e-30))
            for n in card["stats"])
        equal = {w: got[w][0]["digest"] == got[w][1]["digest"]
                 for w in got}
        leg = {"sync_batch_norm": sync_bn, "losses": card["losses"],
               "losses_cpu": cpu["losses"], "loss_rel_err": loss_err,
               "max_stat_rel_err": stat_err, "stats": len(card["stats"]),
               "sync_bn_ops": card["sync_bn_ops"],
               "replicas_bit_equal": equal, "tol": FLEET_B_RTOL,
               "devices": [got["card"][0]["device"], cpu["device"]]}
        res["sync_bn" if sync_bn else "plain"] = leg
        check(loss_err <= FLEET_B_RTOL and stat_err <= FLEET_B_RTOL
              and all(equal.values())
              and (card["sync_bn_ops"] > 0) == sync_bn,
              "fleet_dp b: card vs CPU %s" % leg)
    emit({"phase": "fleet_dp_leg", "leg": "b", **dict(c, **res)})
    return res


def fleet_leg_c_start(distributed, out_dir):
    """Leg c's spawn, started (one rank over NCCL)."""
    return distributed.spawn(fleet_worker_c, (out_dir,), nprocs=1,
                             backend="nccl", join=False)


def fleet_leg_c(distributed, out_dir):
    """Leg c's checks, after its spawn (`fleet_leg_c_start`) ended."""
    res = fleet_read(out_dir, "c.json")
    emit({"phase": "fleet_dp_leg", "leg": "c", **res})
    mlp = res["mlp"]
    check(res["backend"] == "nccl" and res["world"] == 1
          and res["mode"] == "graph"
          and res["phases"][1:] == ["captured"] * 3
          and res["eager_collectives"] > 0,
          "fleet_dp c: collective program not captured over NCCL: %s" % res)
    check(res["replays_equal_eager"] and res["eager_equals_identity"],
          "fleet_dp c: replayed collectives differ from eager: %s" % res)
    check(mlp["plain"]["losses"] == mlp["with_data_parallel"]["losses"]
          and mlp["with_data_parallel"]["mode"] == "graph",
          "fleet_dp c: world-1 DP MLP differs from the plain one: %s" % mlp)
    # float16 dynamic loss scaling: the found-inf count's all-reduce runs
    # in the eager first step and is captured with the step
    f16 = mlp["f16_with_data_parallel"]
    check(mlp["f16_plain"]["losses"] == f16["losses"]
          and f16["mode"] == "graph" and f16["phase"] == "captured"
          and f16["all_reduce_calls"] > 0
          and all(math.isfinite(x[0]) for x in f16["losses"]),
          "fleet_dp c: world-1 float16 DP MLP differs from the plain one: "
          "%s" % mlp)
    return res


def phase_fleet_dp(torch, name, single):
    """Phase 12: fleet collective data parallelism. Leg a: BASELINE
    config 5 at full size, 2 ranks sharing the card over gloo; leg b: the
    card against the CPU; leg c: NCCL at world 1, captured."""
    import shutil
    import tempfile

    from paddle_tpu_torch import distributed, fluid

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out_dir = tempfile.mkdtemp(prefix="fleet_dp_")
    try:
        res = {"phase": "fleet_dp",
               "leg_a": fleet_leg_a(torch, distributed, out_dir, single),
               "leg_b": fleet_leg_b(
                   torch, distributed, fluid, out_dir,
                   beside=[lambda: fleet_leg_c_start(distributed,
                                                     out_dir)]),
               "leg_c": fleet_leg_c(distributed, out_dir)}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    res = {"phase": "fleet_dp", "seconds": time.perf_counter() - t0,
           "legs": ["a", "b", "c"], "device": name,
           "nvidia_smi": nvidia_smi_line(),
           "leg_a_median_step_ms": res["leg_a"]["median_step_ms"],
           "leg_a_images_per_sec": res["leg_a"]["images_per_sec"]}
    emit(res)
    return res


# -- phase 13 -----------------------------------------------------------------

def spmd_worker_full(out_dir, leg, mesh_kw):
    """Legs a and b, one rank: the default SPMDConfig on the mesh, the
    flash launch counts zeroed just before the timed steps and read just
    after."""
    import torch

    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.ops import collective_ops
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.parallel import transformer as tt

    rank = distributed.get_rank()
    cfg = tt.SPMDConfig(n_micro=SPMD_MICRO, n_layers=SPMD_LAYERS, **mesh_kw)
    mesh = cfg.mesh(device=DEV)
    params = tt.shard_params(tt.init_params(cfg, seed=0, device=mesh.device),
                             cfg, mesh)
    opt = tt.init_opt_state(params)
    step = tt.make_train_step(cfg, mesh)
    tokens, labels = tt.demo_batch(cfg, SPMD_BATCH, seed=0)
    losses = []
    for i in range(SPMD_WARMUP):
        params, opt, loss = step(params, opt, tokens, labels, i)
        losses.append(float(loss))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    collective_ops.reset_stats()
    fa.fwd_launches = fa.dkv_launches = fa.dq_launches = 0
    fa.tc_launches = dict.fromkeys(fa.tc_launches, 0)
    step_ms = []
    for i in range(SPMD_WARMUP, SPMD_WARMUP + SPMD_STEPS):
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, tokens, labels, i)
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    fleet_dump(os.path.join(out_dir, "spmd_%s%d.json" % (leg, rank)), {
        "losses": losses, "step_ms": step_ms,
        "launches": {"forward": fa.fwd_launches, "dkv": fa.dkv_launches,
                     "dq": fa.dq_launches},
        "tensor_core_launches": dict(fa.tc_launches),
        "device": str(mesh.device),
        "backend": mesh.backend, "coords": list(mesh.coords),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "collectives": {k: dict(v) for k, v in
                        collective_ops.stats.items()}})


def spmd_worker_c(out_dir, mesh_kw, params_path):
    """Leg c, one rank: the small model on the mesh from the saved
    global params, with the kernels and with the plain attention: 3
    steps' losses and the step-0 gradients gathered."""
    import numpy as np

    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.parallel import transformer as tt

    rank = distributed.get_rank()
    cfg = tt.SPMDConfig(**dict(SPMD_C_KW, **mesh_kw))
    mesh = cfg.mesh(device=DEV)
    with np.load(params_path) as f:
        tree = spmd_tree(dict(f), cfg)
    tokens, labels = tt.demo_batch(cfg, SPMD_BATCH, seed=SPMD_C_SEED)
    res = {"device": str(mesh.device)}
    for impl in ("auto", "reference"):
        res[impl] = spmd_small_run(tt, cfg, mesh, tree, tokens, labels, impl)
    if rank == 0:
        fleet_dump(os.path.join(out_dir, "spmd_c_%s.json" % "x".join(
            str(mesh_kw[a]) for a in ("dp", "pp", "tp"))), res)


def spmd_tree(flat, cfg):
    """The saved global params (layer leaves [n_layers, ...]) as the tree
    of `cfg`, its layer leaves stacked [pp, n_layers / pp, ...]."""
    tree = {"ln_f": {}, "layers": {}}
    for path, v in flat.items():
        if path.startswith("layers/"):
            v = v.reshape((cfg.pp, cfg.layers_per_stage) + v.shape[1:])
        node = tree
        *keys, last = path.split("/")
        for k in keys:
            node = node[k]
        node[last] = v
    return tree


def spmd_small_run(tt, cfg, mesh, tree, tokens, labels, impl):
    """SPMD_C_STEPS steps: the losses and the step-0 gradients, layer
    leaves flattened to [n_layers, ...]."""
    params = tt.shard_params(tree, cfg, mesh) if mesh is not None \
        else tt.params_from_numpy(tree, device=DEV)
    opt = tt.init_opt_state(params)
    step = tt.make_train_step(cfg, mesh, device=DEV if mesh is None
                              else None, with_grads=True, attn_impl=impl)
    losses, grads = [], None
    for i in range(SPMD_C_STEPS):
        params, opt, loss, g = step(params, opt, tokens, labels, i)
        losses.append(float(loss))
        if grads is None:
            grads = {k: v.reshape((-1,) + v.shape[2:]).tolist()
                     if k.startswith("layers/") else v.tolist()
                     for k, v in leaves(tt.params_to_numpy(g, cfg, mesh))}
    return {"losses": losses, "grads": grads}


def spmd_run_leg(distributed, func, args, nprocs):
    try:
        distributed.spawn(func, args, nprocs=nprocs, backend="gloo",
                          timeout=FLEET_TIMEOUT_S)
    except (RuntimeError, TimeoutError) as e:
        raise SmokeFailure("spmd_mesh: %s" % e)


def spmd_leg_full(torch, distributed, out_dir, leg, mesh_kw, single):
    """Legs a and b: the ranks' figures beside phase 6's single
    process."""
    from paddle_tpu_torch.parallel import transformer as tt

    n = mesh_kw["dp"] * mesh_kw["pp"] * mesh_kw["tp"]
    spmd_run_leg(distributed, spmd_worker_full, (out_dir, leg, mesh_kw), n)
    ranks = [fleet_read(out_dir, "spmd_%s%d.json" % (leg, r))
             for r in range(n)]
    cfg = tt.SPMDConfig(n_micro=SPMD_MICRO, n_layers=SPMD_LAYERS, **mesh_kw)
    per_step = cfg.layers_per_stage * SPMD_MICRO * SPMD_STEPS
    # remat runs each layer's forward twice
    want = {"forward": 2 * per_step, "dkv": per_step, "dq": per_step}
    med = [statistics.median(r["step_ms"]) for r in ranks]
    tokens = SPMD_MICRO * SPMD_BATCH * cfg.seq_len
    coll = [r["collectives"] for r in ranks]
    res = dict(mesh_kw, leg=leg, ranks=n, backend=ranks[0]["backend"],
               n_micro=SPMD_MICRO, global_batch=SPMD_BATCH,
               steps=SPMD_STEPS, losses=ranks[0]["losses"],
               median_step_ms=med, step_ms=[r["step_ms"] for r in ranks],
               tokens_per_step=tokens,
               tokens_per_sec=tokens / (max(med) / 1e3),
               collective_host_ms_per_step=[
                   sum(v["seconds"] for v in c.values()) * 1e3 / SPMD_STEPS
                   for c in coll],
               collective_mb_per_step=[
                   sum(v["bytes"] for v in c.values()) / 1e6 / SPMD_STEPS
                   for c in coll],
               collective_calls_per_step=[
                   {k: v["calls"] / SPMD_STEPS for k, v in c.items()}
                   for c in coll],
               peak_mem_bytes=[r["peak_mem_bytes"] for r in ranks],
               devices=[r["device"] for r in ranks],
               flash_launches=[r["launches"] for r in ranks],
               flash_tensor_core_launches=[r["tensor_core_launches"]
                                           for r in ranks],
               flash_launches_expected=want,
               single_process={k: single[k] for k in (
                   "batch", "mean_step_ms", "tokens_per_sec",
                   "peak_mem_bytes")})
    emit({"phase": "spmd_mesh_leg", **res})
    check(all(math.isfinite(x) for x in res["losses"]),
          "spmd_mesh %s: losses %s" % (leg, res["losses"]))
    check(all(r["losses"] == ranks[0]["losses"] for r in ranks),
          "spmd_mesh %s: the ranks report other losses: %s"
          % (leg, [r["losses"] for r in ranks]))
    check(all(r["launches"] == want and r["tensor_core_launches"] == want
              for r in ranks),
          "spmd_mesh %s: flash launches %s (tensor cores %s), expected %s "
          "a rank" % (leg, res["flash_launches"],
                      res["flash_tensor_core_launches"], want))
    return res


def spmd_rel_err(a, b):
    import numpy as np

    a, b = np.asarray(a, "float64"), np.asarray(b, "float64")
    return float(np.max(np.abs(a - b) / (np.abs(b) + 1e-30)))


def spmd_leg_c(torch, distributed, out_dir):
    """The small model on two meshes over gloo on the card, with the
    kernels and with the plain attention, against one process on the
    card with the kernels from the same params."""
    import numpy as np

    from paddle_tpu_torch.parallel import transformer as tt

    cfg1 = tt.SPMDConfig(**SPMD_C_KW)
    params = tt.params_to_numpy(tt.init_params(cfg1, seed=SPMD_C_SEED,
                                               device="cpu"))
    flat = {k: v.reshape((-1,) + v.shape[2:]) if k.startswith("layers/")
            else v for k, v in leaves(params)}
    path = os.path.join(out_dir, "spmd_c_params.npz")
    np.savez(path, **flat)
    tokens, labels = tt.demo_batch(cfg1, SPMD_BATCH, seed=SPMD_C_SEED)
    # both meshes' ranks run together (their numbers only are checked),
    # while this process runs the single-process reference
    ranks = {id(kw): kw["dp"] * kw["pp"] * kw["tp"] for kw in SPMD_C_MESHES}
    ctxs = [distributed.spawn(spmd_worker_c, (out_dir, kw, path),
                              nprocs=ranks[id(kw)], backend="gloo",
                              join=False) for kw in SPMD_C_MESHES]
    single = spmd_small_run(tt, cfg1, None, spmd_tree(flat, cfg1), tokens,
                            labels, "auto")
    join_spawns(ctxs, "spmd_mesh c")
    res = {"single": single["losses"], "meshes": []}
    for mesh_kw in SPMD_C_MESHES:
        n = ranks[id(mesh_kw)]
        got = fleet_read(out_dir, "spmd_c_%s.json" % "x".join(
            str(mesh_kw[a]) for a in ("dp", "pp", "tp")))
        for impl in ("auto", "reference"):
            loss_err = spmd_rel_err(got[impl]["losses"], single["losses"])
            bad = {}
            for k, want in single["grads"].items():
                a, b = np.asarray(got[impl]["grads"][k]), np.asarray(want)
                if not np.allclose(a, b, rtol=SPMD_C_GRAD_RTOL,
                                   atol=SPMD_C_GRAD_ATOL):
                    bad[k] = float(np.max(np.abs(a - b)))
            leg = dict(mesh_kw, attn_impl=impl, ranks=n,
                       losses=got[impl]["losses"], loss_rel_err=loss_err,
                       grads_outside_tol=bad, device=got["device"])
            res["meshes"].append(leg)
            check(loss_err <= SPMD_C_LOSS_RTOL and not bad,
                  "spmd_mesh c: mesh vs one process: %s" % leg)
    emit({"phase": "spmd_mesh_leg", "leg": "c", **res})
    return res


def phase_spmd_mesh(torch, name, single):
    """Phase 13: the SPMD trainer over a mesh of ranks that share the
    card over gloo. Leg a: Megatron dp1 pp2 tp2 at full width; leg b:
    Ulysses dp1 pp1 tp2 at full width; leg c: the small model on two
    meshes against one process."""
    import shutil
    import tempfile

    from paddle_tpu_torch import distributed

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out_dir = tempfile.mkdtemp(prefix="spmd_mesh_")
    try:
        legs = {"a": spmd_leg_full(torch, distributed, out_dir, "a", SPMD_A,
                                   single),
                "b": spmd_leg_full(torch, distributed, out_dir, "b", SPMD_B,
                                   single),
                "c": spmd_leg_c(torch, distributed, out_dir)}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    res = {"phase": "spmd_mesh", "seconds": time.perf_counter() - t0,
           "legs": ["a", "b", "c"], "device": name,
           "nvidia_smi": nvidia_smi_line(),
           "median_step_ms": {k: legs[k]["median_step_ms"] for k in "ab"},
           "tokens_per_sec": {k: legs[k]["tokens_per_sec"] for k in "ab"}}
    emit(res)
    return legs


# -- phase 14 -----------------------------------------------------------------

def zero_worker(out_dir, leg):
    """One rank of phase 14: leg "a" (fleet ResNet50) or "b" (BERT-base
    through `with_data_parallel`), with the sharded update on and then
    off, each from the same start state (the first run's startup, put
    back into the second's scope): the steps' losses and ms, the
    collectives a step, the optimizer state a rank holds, the kernels'
    launch counts (zeroed just before the steps, read just after) and,
    against the other run, the state at its logical shape."""

    import torch

    from paddle_tpu_torch import distributed, fleet, fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import collective_ops
    from paddle_tpu_torch.ops.kernels import dropout, \
        flash_attention as fa

    rank = distributed.get_rank()
    out, start, logical = {}, None, {}
    for variant in ("on", "off"):
        fluid.set_flags({"FLAGS_tpu_sharded_weight_update":
                         variant == "on"})
        if leg == "a":
            c = FLEET_A
            main, startup, loss = build_fluid_resnet(
                fluid, c["img"], c["classes"], c["lr"], True,
                strategy=fleet.DistributedStrategy())
            prog = main
            feed = resnet_feed(c["batch"], c["img"], c["classes"])
        else:
            cfg = bert_cfg(ZERO_B["seq"], ZERO_B["layers"])
            main, startup, loss, _ = build_fluid_bert(fluid, cfg,
                                                      ZERO_B["seq"], True)
            prog = fluid.CompiledProgram(main).with_data_parallel()
            feed = bert.bert_feed(cfg, ZERO_B["batch"], ZERO_B["seq"])
        exe = fluid.Executor()
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        if start is None:
            start = {n: scope.find_var(n).clone() for n in names}
        else:
            for n in names:
                scope.set_var(n, start[n].clone())
        def step():
            return exe.run(prog, feed=feed, fetch_list=[loss],
                           scope=scope)[0].ravel().tolist()

        # the warm-up step also broadcasts rank 0's state
        losses = [step() for _ in range(ZERO_WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        collective_ops.reset_stats()
        fa.fwd_launches = fa.dkv_launches = fa.dq_launches = 0
        fa.tc_launches = dict.fromkeys(fa.tc_launches, 0)
        dropout.launches = 0
        step_ms = []
        for _ in range(ZERO_STEPS):
            t0 = time.perf_counter()
            losses.append(step())
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = {"flash_forward": fa.fwd_launches,
                    "flash_dkv": fa.dkv_launches, "flash_dq": fa.dq_launches,
                    "dropout": dropout.launches}
        stats = {k: dict(v) for k, v in collective_ops.stats.items()}
        info = exe.last_entry.info()
        plan = main._shard_plan if variant == "on" else None
        logical[variant] = {n: exe.read_logical(n, main, scope).clone()
                            for n in names}
        out[variant] = {
            "losses": losses, "step_ms": step_ms, "launches": launches,
            "collectives": stats, "mode": info["mode"],
            "reason": info["reason"],
            "opt_state": {k: v for k, v in info.items()
                          if k.startswith(("opt_state", "grad_buckets"))},
            "masters_sharded": len(plan.master_of) if plan else 0,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "digest": {n: digest(v) for n, v in logical[variant].items()
                       if not n.endswith(("_bn_mean", "_bn_var"))}}
        del exe, scope, prog, main
        torch.cuda.empty_cache()
    on, off = logical["on"], logical["off"]
    out["state_bit_equal"] = all(torch.equal(on[n], off[n]) for n in on)
    out["state_max_abs_diff"] = max(float((on[n].double() - off[n].double())
                                          .abs().max()) for n in on)
    out["state_max_rel_norm"] = max(float(
        (on[n].double() - off[n].double()).norm()
        / max(float(off[n].double().norm()), 1e-30)) for n in on)
    fleet_dump(os.path.join(out_dir, "zero_%s%d.json" % (leg, rank)), out)


def legs_worker(worker, out_dir, legs):
    """One rank running `worker(out_dir, leg)` for each of `legs` in
    turn (one spawn for a phase's legs: a rank's start-up is paid once)."""
    import torch

    for leg in legs:
        worker(out_dir, leg)
        torch.cuda.empty_cache()


def zero_leg(distributed, out_dir, leg):
    """Leg `leg`'s figures and checks, from its ranks' files."""
    ranks = [fleet_read(out_dir, "zero_%s%d.json" % (leg, r))
             for r in range(2)]
    res = {"leg": leg, "ranks": 2, "backend": "gloo",
           "warmup_steps": ZERO_WARMUP, "timed_steps": ZERO_STEPS,
           "config": ("BASELINE config 5: fleet ResNet50, 224 x 224, "
                      "batch 128 a rank, bf16 AMP O2, fused Momentum"
                      if leg == "a" else
                      "fluid BERT-base pretraining, S 4096 x 2 (1 a rank), "
                      "bf16 AMP O2, fused Adam, scan remat")}
    for variant in ("on", "off"):
        v = [r[variant] for r in ranks]
        med = [statistics.median(x["step_ms"]) for x in v]
        res[variant] = dict(
            losses=v[0]["losses"], step_ms=[x["step_ms"] for x in v],
            median_step_ms=med, mode=v[0]["mode"],
            opt_state=[x["opt_state"] for x in v],
            masters_sharded=v[0]["masters_sharded"],
            launches=[x["launches"] for x in v],
            peak_mem_bytes=[x["peak_mem_bytes"] for x in v],
            **collectives_per_step([x["collectives"] for x in v],
                                   ZERO_STEPS))
    res["losses_bit_equal"] = res["on"]["losses"] == res["off"]["losses"]
    res["max_loss_rel_diff"] = max(
        abs(a - b) / max(abs(b), 1e-30) for sa, sb in zip(
            res["on"]["losses"], res["off"]["losses"])
        for a, b in zip(sa, sb))
    res["state_bit_equal"] = [r["state_bit_equal"] for r in ranks]
    res["state_max_abs_diff"] = [r["state_max_abs_diff"] for r in ranks]
    res["state_max_rel_norm"] = [r["state_max_rel_norm"] for r in ranks]
    res["replicas_bit_equal"] = all(
        ranks[0][v]["digest"] == ranks[1][v]["digest"] for v in ("on", "off"))
    emit({"phase": "zero_leg", **res})
    on = res["on"]
    check(all(math.isfinite(x) for s_ in on["losses"] for x in s_)
          and len(on["losses"][0]) == 2, "zero %s: losses %s"
          % (leg, on["losses"]))
    check(on["mode"] == "eager" and res["off"]["mode"] == "eager",
          "zero %s: expected eager gloo blocks" % leg)
    check(all(o["opt_state_sharded_vars"] > 0
              and 2 * o["opt_state_per_replica_bytes"]
              < 1.01 * o["opt_state_logical_bytes"] for o in on["opt_state"])
          and all(o["opt_state_sharded_vars"] == 0
                  for o in res["off"]["opt_state"]),
          "zero %s: state not sharded: %s / %s" % (
              leg, on["opt_state"], res["off"]["opt_state"]))
    check(res["replicas_bit_equal"], "zero %s: replicas differ" % leg)
    if leg == "a":
        check(res["losses_bit_equal"] and all(res["state_bit_equal"]),
              "zero a: on and off differ (losses %s, state %s)" % (
                  res["max_loss_rel_diff"], res["state_max_abs_diff"]))
    else:
        check(on["masters_sharded"] > 0, "zero b: AMP masters not sharded")
        check(all(x["flash_forward"] > 0 and x["flash_dkv"] > 0
                  and x["flash_dq"] > 0 and x["dropout"] > 0
                  for v in ("on", "off") for x in res[v]["launches"]),
              "zero b: kernel launches %s / %s" % (
                  on["launches"], res["off"]["launches"]))
        check(res["max_loss_rel_diff"] <= ZERO_B_RTOL
              and max(res["state_max_rel_norm"]) <= ZERO_B_RTOL,
              "zero b: on and off differ by %s (losses), %s (state)" % (
                  res["max_loss_rel_diff"], res["state_max_rel_norm"]))
    return res


def phase_zero(torch, name):
    """Phase 14: the sharded weight update on against off, on 2 gloo
    ranks sharing the card. Leg a: BASELINE config 5; leg b: fluid
    BERT-base with its AMP masters sharded and the flash kernels."""
    import shutil
    import tempfile

    from paddle_tpu_torch import distributed

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out_dir = tempfile.mkdtemp(prefix="zero_")
    try:
        fleet_spawn(distributed, legs_worker, (zero_worker, out_dir, "ab"),
                    2, "gloo")
        legs = {leg: zero_leg(distributed, out_dir, leg) for leg in "ab"}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    res = {"phase": "zero", "seconds": time.perf_counter() - t0,
           "legs": ["a", "b"], "device": name,
           "nvidia_smi": nvidia_smi_line(),
           "median_step_ms": {k: {v: legs[k][v]["median_step_ms"]
                                  for v in ("on", "off")} for k in legs},
           "bit_equal": {k: legs[k]["losses_bit_equal"]
                         and all(legs[k]["state_bit_equal"])
                         for k in legs}}
    emit(res)
    return legs


# -- phase 15 -----------------------------------------------------------------

def hybrid_axes(stats):
    """A rank's `collective_ops.stats` summed by the axis each collective
    ran along: "ici", "dcn" or "world" (a gather or broadcast over the
    whole world, and every collective of a flat world)."""
    out = {}
    for kind, v in stats.items():
        axis = kind.rsplit(".", 1)[-1]
        axis = axis if axis in ("ici", "dcn") else "world"
        a = out.setdefault(axis, {"calls": 0, "seconds": 0.0, "bytes": 0})
        for k in a:
            a[k] += v[k]
    return out


def hybrid_worker(out_dir, leg):
    """One rank of phase 15: each variant of `HYBRID_VARIANTS[leg]` (pods,
    sharded update) from the first variant's start state, 1 warm-up and
    1 timed step: losses, step ms, collectives a step by axis, the
    optimizer state held, the exchange record (`overlap_report`), peak
    memory, the kernels' launches (zeroed just before the timed steps of
    each variant) and the state at its logical shape (digests; leg b
    also its distance to the flat run)."""

    import torch

    from paddle_tpu_torch import distributed, fleet, fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import collective_ops
    from paddle_tpu_torch.ops.kernels import dropout, \
        flash_attention as fa

    rank = distributed.get_rank()
    fluid.set_flags({"FLAGS_cudnn_deterministic": True})
    out, start, logical = {}, None, {}
    for variant, dcn, sharded in HYBRID_VARIANTS[leg]:
        fluid.set_flags({"FLAGS_tpu_dcn_replicas": dcn,
                         "FLAGS_tpu_sharded_weight_update": sharded})
        if leg == "a":
            c = HYBRID_A
            main, startup, loss = build_fluid_resnet(
                fluid, c["img"], c["classes"], c["lr"], True,
                strategy=fleet.DistributedStrategy())
            prog = main
            feed = resnet_feed(c["batch"], c["img"], c["classes"])
        else:
            cfg = bert_cfg(HYBRID_B["seq"], HYBRID_B["layers"])
            main, startup, loss, _ = build_fluid_bert(fluid, cfg,
                                                      HYBRID_B["seq"], True)
            prog = fluid.CompiledProgram(main).with_data_parallel()
            feed = bert.bert_feed(cfg, HYBRID_B["batch"], HYBRID_B["seq"])
        exe = fluid.Executor()
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        if start is None:
            start = {n: scope.find_var(n).clone() for n in names}
        else:
            for n in names:
                scope.set_var(n, start[n].clone())

        def step():
            return exe.run(prog, feed=feed, fetch_list=[loss],
                           scope=scope)[0].ravel().tolist()

        losses = [step() for _ in range(ZERO_WARMUP)]
        if leg == "a" and variant in ("hier_zero", "flat_zero"):
            # the first step's exchanged gradients, in the velocities
            logical[variant] = torch.cat([
                exe.read_logical(n, main, scope).reshape(-1)
                for n in names if "velocity" in n])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        collective_ops.reset_stats()
        fa.fwd_launches = fa.dkv_launches = fa.dq_launches = 0
        fa.tc_launches = dict.fromkeys(fa.tc_launches, 0)
        dropout.launches = 0
        step_ms = []
        for _ in range(ZERO_STEPS):
            t0 = time.perf_counter()
            losses.append(step())
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = {"flash_forward": fa.fwd_launches,
                    "flash_dkv": fa.dkv_launches, "flash_dq": fa.dq_launches,
                    "dropout": dropout.launches}
        stats = {k: dict(v) for k, v in collective_ops.stats.items()}
        info = exe.last_entry.info()
        overlap = exe.overlap_report(prog, feed=feed, fetch_list=[loss],
                                     scope=scope)
        state = {n: exe.read_logical(n, main, scope) for n in names}
        out[variant] = {
            "losses": losses, "step_ms": step_ms, "launches": launches,
            "collectives": stats, "by_axis": hybrid_axes(stats),
            "mode": info["mode"],
            "pods": list(main._mesh.shape.values()) if main._mesh else None,
            "opt_state": {k: v for k, v in info.items()
                          if k.startswith(("opt_state", "grad_buckets"))},
            "overlap": overlap and dict(
                {k: v for k, v in overlap.items() if k != "collectives"},
                bucket0=overlap["collectives"][0],
                backward_after=[c["backward_after"]
                                for c in overlap["collectives"]]),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "digest": {n: digest(v) for n, v in state.items()
                       if not n.endswith(("_bn_mean", "_bn_var"))}}
        if leg == "b":
            logical[variant] = state
        del exe, scope, prog, main, state
        torch.cuda.empty_cache()
    hier, flat = logical["hier_zero"], logical["flat_zero"]
    if leg == "a":
        out["first_step_velocity_rel_norm"] = float(
            (hier.double() - flat.double()).norm()
            / flat.double().norm())
    else:
        # each kind of state as one vector: a var whose bf16 gradient is
        # rounding noise (the attention's key bias) takes an Adam step of
        # either sign, so no per-var bound holds (ROADMAP Queue 3)
        kinds = {}
        for n in hier:
            kinds.setdefault("master" if n.endswith("@MASTER") else
                             "moment1" if "moment1" in n else
                             "moment2" if "moment2" in n else "other",
                             []).append(n)
        out["state_rel_norm"] = {kind: float(
            torch.cat([(hier[n].double() - flat[n].double()).reshape(-1)
                       for n in names]).norm()
            / torch.cat([flat[n].double().reshape(-1)
                         for n in names]).norm())
            for kind, names in kinds.items()}
    fleet_dump(os.path.join(out_dir, "hybrid_%s%d.json" % (leg, rank)), out)


def hybrid_leg(distributed, out_dir, leg):
    """Leg `leg`'s figures and checks, from its ranks' files."""
    ranks = [fleet_read(out_dir, "hybrid_%s%d.json" % (leg, r))
             for r in range(HYBRID_RANKS)]
    res = {"leg": leg, "ranks": HYBRID_RANKS, "pods": HYBRID_DCN,
           "backend": "gloo", "cudnn_deterministic": True,
           "warmup_steps": ZERO_WARMUP, "timed_steps": ZERO_STEPS,
           "config": ("BASELINE config 5: fleet ResNet50, 224 x 224, bf16 "
                      "AMP O2, fused Momentum, 32 a rank (cut from 128 so "
                      "that 4 ranks fit on one card)" if leg == "a" else
                      "fluid BERT-base pretraining, S 4096 x 1 a rank, "
                      "bf16 AMP O2, fused Adam, scan remat")}
    for variant, _, _ in HYBRID_VARIANTS[leg]:
        v = [r[variant] for r in ranks]
        res[variant] = dict(
            losses=v[0]["losses"], step_ms=[x["step_ms"] for x in v],
            median_step_ms=[statistics.median(x["step_ms"]) for x in v],
            mode=v[0]["mode"], pods=v[0]["pods"],
            opt_state=[x["opt_state"] for x in v],
            overlap=[x["overlap"] for x in v],
            launches=[x["launches"] for x in v],
            peak_mem_bytes=[x["peak_mem_bytes"] for x in v],
            by_axis=[{a: {"calls": c["calls"] / ZERO_STEPS,
                          "mb": c["bytes"] / 1e6 / ZERO_STEPS,
                          "ms": c["seconds"] * 1e3 / ZERO_STEPS}
                      for a, c in x["by_axis"].items()} for x in v],
            **collectives_per_step([x["collectives"] for x in v],
                                   ZERO_STEPS))
        res[variant]["replicas_bit_equal"] = all(
            r[variant]["digest"] == ranks[0][variant]["digest"]
            for r in ranks[1:])

    def rel(a, b):
        return max(abs(x - y) / max(abs(y), 1e-30) for sa, sb in zip(
            res[a]["losses"], res[b]["losses"]) for x, y in zip(sa, sb))

    hz = res["hier_zero"]
    res["flat_max_loss_rel_diff"] = rel("hier_zero", "flat_zero")
    if leg == "a":
        res["hier_zero_vs_replicated_bit_equal"] = \
            hz["losses"] == res["hier_replicated"]["losses"] and all(
                r["hier_zero"]["digest"] == r["hier_replicated"]["digest"]
                for r in ranks)
        fz, fr = res["flat_zero"], res["flat_replicated"]
        res["flat_zero_vs_replicated_bit_equal"] = \
            fz["losses"] == fr["losses"] and all(
                r["flat_zero"]["digest"] == r["flat_replicated"]["digest"]
                for r in ranks)
        res["first_step_velocity_rel_norm"] = [
            r["first_step_velocity_rel_norm"] for r in ranks]
    else:
        res["state_rel_norm"] = [r["state_rel_norm"] for r in ranks]
    emit({"phase": "hybrid_leg", **res})
    check(all(math.isfinite(x) for s_ in hz["losses"] for x in s_)
          and len(hz["losses"][0]) == HYBRID_RANKS,
          "hybrid %s: losses %s" % (leg, hz["losses"]))
    check(hz["pods"] == [HYBRID_DCN, HYBRID_RANKS // HYBRID_DCN]
          and res["flat_zero"]["pods"] is None,
          "hybrid %s: worlds %s / %s" % (leg, hz["pods"],
                                         res["flat_zero"]["pods"]))
    check(all(res[v]["replicas_bit_equal"] for v, _, _ in
              HYBRID_VARIANTS[leg]), "hybrid %s: replicas differ" % leg)
    check(all(o["opt_state_sharded_vars"] > 0
              and 2 * o["opt_state_per_replica_bytes"]
              < 1.01 * o["opt_state_logical_bytes"]
              and 2.2 * o["opt_state_per_replica_bytes"]
              > o["opt_state_logical_bytes"] for o in hz["opt_state"]),
          "hybrid %s: a rank does not hold half the state: %s"
          % (leg, hz["opt_state"]))
    check(all(o is not None and o["launched_in_backward"]
              and o["bucket0"]["bucket"] == 0
              and o["bucket0"]["backward_after"] > 0
              for o in hz["overlap"]),
          "hybrid %s: bucket 0 not launched inside the backward: %s"
          % (leg, hz["overlap"]))
    if leg == "a":
        check(res["hier_zero_vs_replicated_bit_equal"],
              "hybrid a: hierarchical sharded and replicated differ")
        check(max(res["first_step_velocity_rel_norm"])
              <= HYBRID_A_GRAD_RTOL,
              "hybrid a: the first step's gradients differ from the flat "
              "run's by %s in norm" % res["first_step_velocity_rel_norm"])
    else:
        check(all(x["flash_forward"] > 0 and x["flash_dkv"] > 0
                  and x["flash_dq"] > 0 and x["dropout"] > 0
                  for x in hz["launches"]),
              "hybrid b: kernel launches %s" % hz["launches"])
        check(res["flat_max_loss_rel_diff"] <= ZERO_B_RTOL
              and max(v for r in res["state_rel_norm"] for v in r.values())
              <= ZERO_B_RTOL,
              "hybrid b: hierarchical and flat differ by %s (losses), %s "
              "(state)" % (res["flat_max_loss_rel_diff"],
                           res["state_rel_norm"]))
    return res


def phase_hybrid(torch, name):
    """Phase 15: hierarchical data parallelism on a (dcn 2, ici 2) world
    of 4 gloo ranks sharing the card. Leg a: BASELINE config 5; leg b:
    fluid BERT-base with the flash kernels."""
    import shutil
    import tempfile

    from paddle_tpu_torch import distributed

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out_dir = tempfile.mkdtemp(prefix="hybrid_")
    try:
        fleet_spawn(distributed, legs_worker, (hybrid_worker, out_dir, "ab"),
                    HYBRID_RANKS, "gloo")
        legs = {leg: hybrid_leg(distributed, out_dir, leg) for leg in "ab"}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    emit({"phase": "hybrid", "seconds": time.perf_counter() - t0,
          "legs": ["a", "b"], "device": name,
          "nvidia_smi": nvidia_smi_line(),
          "median_step_ms": {k: {v: legs[k][v]["median_step_ms"]
                                 for v, _, _ in HYBRID_VARIANTS[k]}
                             for k in legs}})
    return legs


# -- phase 16 -----------------------------------------------------------------

def ckpt_dir_mb(path):
    """MB of the files under `path`."""
    total = 0
    for root, _, files in os.walk(path):
        total += sum(os.path.getsize(os.path.join(root, f)) for f in files)
    return total / 1e6


def ckpt_equal(a, b):
    """Names of the entries of two {name: value} dicts that differ in
    their bits (or that one of them lacks)."""
    import numpy as np

    names = set(a) | set(b)
    return sorted(n for n in names if n not in a or n not in b
                  or not np.array_equal(host_bits(a[n]), host_bits(b[n])))


def ckpt_pickle(root):
    """The values of the newest checkpoint under `root`."""
    from paddle_tpu_torch.fluid import checkpoint, io

    return io._load_pickle(os.path.join(
        checkpoint.latest_checkpoint_dir(root), "persistables.pkl"))


def ckpt_timed(torch, fn):
    """(fn's result, its ms on the host clock, the card synchronized)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def ckpt_leg_a(torch, fluid, out_dir):
    """Leg a: config 5 in one process (phase 9 leg a's program at batch
    128), captured: 3 steps; `save_checkpoint`; an `AsyncCheckpointer`
    save of the same state with the next 3 steps running meanwhile
    (losses A); the checkpoint loaded into the live scope of the captured
    block, and into a fresh executor and scope, each followed by the
    same 3 steps."""
    from paddle_tpu_torch.fluid import checkpoint

    c = RESNET_A
    main, startup, loss = build_fluid_resnet(fluid, c["img"], c["classes"],
                                             c["lr"], c["amp"])
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = resnet_feed(c["batch"], c["img"], c["classes"])

    def steps(e, s):
        return [float(e.run(main, feed=feed, fetch_list=[loss],
                            scope=s)[0][0]) for _ in range(CKPT_STEPS)]

    first = steps(exe, scope)
    check(exe.last_entry.phase == "captured",
          "ckpt a: the step is %s, not captured" % exe.last_entry.phase)
    sync_root = os.path.join(out_dir, "a_sync")
    async_root = os.path.join(out_dir, "a_async")
    status = checkpoint.TrainStatus(0, CKPT_STEPS)
    _, save_ms = ckpt_timed(torch, lambda: checkpoint.save_checkpoint(
        exe, sync_root, status, main, scope=scope))
    writer = checkpoint.AsyncCheckpointer(async_root, main, scope=scope)
    _, snapshot_ms = ckpt_timed(torch, lambda: writer.save_async(status))
    a = steps(exe, scope)
    _, close_ms = ckpt_timed(torch, writer.close)
    async_differ = ckpt_equal(ckpt_pickle(sync_root),
                              ckpt_pickle(async_root))
    _, load_live_ms = ckpt_timed(torch, lambda: checkpoint.load_checkpoint(
        exe, sync_root, main, scope=scope))
    live = steps(exe, scope)
    live_phase = exe.last_entry.phase
    exe.close()
    del exe, scope
    torch.cuda.empty_cache()
    exe = fluid.Executor()
    scope = fluid.Scope()
    st, load_fresh_ms = ckpt_timed(torch, lambda: checkpoint.load_checkpoint(
        exe, sync_root, main, scope=scope))
    fresh = steps(exe, scope)
    res = {"leg": "a", "config": "BASELINE config 5: ResNet50, 224 x 224, "
           "batch 128, bf16 AMP O2, fused Momentum, captured",
           "first_losses": first, "losses": a, "live_losses": live,
           "fresh_losses": fresh, "live_bit_equal": live == a,
           "live_phase": live_phase, "fresh_bit_equal": fresh == a,
           "async_bit_equal": not async_differ,
           "async_differ": async_differ[:5],
           "status_step": st.step_no, "mb": ckpt_dir_mb(sync_root),
           "save_ms": save_ms, "save_async_ms": snapshot_ms,
           "close_ms": close_ms, "load_live_ms": load_live_ms,
           "load_fresh_ms": load_fresh_ms}
    exe.close()
    emit({"phase": "ckpt_leg", **res})
    check(all(math.isfinite(x) for x in first + a), "ckpt a: losses %s"
          % (first + a))
    check(res["live_bit_equal"] and live_phase == "captured",
          "ckpt a: loaded into the captured block: %s against %s (%s)"
          % (live, a, live_phase))
    check(res["fresh_bit_equal"], "ckpt a: fresh executor: %s against %s"
          % (fresh, a))
    check(res["async_bit_equal"], "ckpt a: the async checkpoint differs "
          "from the sync one in %s" % async_differ[:5])
    check(st.step_no == CKPT_STEPS, "ckpt a: status %s" % st.step_no)
    return res


def ckpt_leg_b(torch, fluid, out_dir):
    """Leg b: fluid BERT-base at S 4096 x 2 (phase 8 leg b's program,
    captured, the flash kernels on every layer) with both dropout
    probabilities 0: `fluid.save` and `fluid.load` of the whole program
    state around 2 steps; then `save_inference_model` and
    `load_inference_model`: the pruned program's loss against the
    for_test clone's on the same feed."""
    import numpy as np

    from paddle_tpu_torch.fluid import io
    from paddle_tpu_torch.models import bert

    cfg = bert_cfg(CKPT_B["seq"])
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    main, startup, total, _ = build_fluid_bert(fluid, cfg, CKPT_B["seq"],
                                               True)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = bert.bert_feed(cfg, CKPT_B["batch"], CKPT_B["seq"])

    def steps():
        return [float(exe.run(main, feed=feed, fetch_list=[total],
                              scope=scope)[0][0])
                for _ in range(CKPT_B_STEPS)]

    zero_attention_launches()
    first = steps()
    path = os.path.join(out_dir, "b", "bert")
    with fluid.scope_guard(scope):
        _, save_ms = ckpt_timed(torch, lambda: io.save(main, path))
    a = steps()
    with fluid.scope_guard(scope):
        _, load_ms = ckpt_timed(torch, lambda: io.load(main, path, exe))
    b = steps()
    phase = exe.last_entry.phase
    test = main.clone(for_test=True)
    want = exe.run(test, feed=feed, fetch_list=[total], scope=scope)[0]
    infer = os.path.join(out_dir, "b_infer")
    with fluid.scope_guard(scope):
        _, infer_save_ms = ckpt_timed(torch, lambda: io.save_inference_model(
            infer, sorted(feed), [total], exe, main))
    other = fluid.Scope()
    with fluid.scope_guard(other):
        (prog, feeds, fetch), infer_load_ms = ckpt_timed(
            torch, lambda: io.load_inference_model(infer, exe))
    got = exe.run(prog, feed=feed, fetch_list=fetch, scope=other)[0]
    launches = attention_launches()
    res = {"leg": "b", "config": "fluid BERT-base pretraining, S 4096 x 2, "
           "bf16 AMP O2, fused Adam, scan remat, dropout 0",
           "first_losses": first, "losses": a, "loaded_losses": b,
           "bit_equal": a == b, "phase_after_load": phase,
           "mb": ckpt_dir_mb(os.path.dirname(path)), "save_ms": save_ms,
           "load_ms": load_ms, "inference_mb": ckpt_dir_mb(infer),
           "inference_save_ms": infer_save_ms,
           "inference_load_ms": infer_load_ms,
           "inference_ops": len(prog.global_block().ops),
           "for_test_ops": len(test.global_block().ops),
           "inference_loss": float(np.ravel(got)[0]),
           "for_test_loss": float(np.ravel(want)[0]),
           "inference_bit_equal": bool(np.array_equal(got, want)),
           "launches": launches}
    exe.close()
    emit({"phase": "ckpt_leg", **res})
    check(all(math.isfinite(x) for x in first + a), "ckpt b: losses %s"
          % (first + a))
    check(res["bit_equal"], "ckpt b: after fluid.load %s against %s"
          % (b, a))
    check(res["inference_bit_equal"], "ckpt b: the inference model gives "
          "%s, the for_test clone %s" % (res["inference_loss"],
                                          res["for_test_loss"]))
    check(all(launches["flash_attention_" + k] > 0
              for k in ("forward", "dkv", "dq")),
          "ckpt b: flash launches %s" % launches)
    return res


def ckpt_worker_c(out_dir):
    """Leg c, one rank: config 5 through fleet with the sharded weight
    update, 1 step; `save_persistables` from every rank (rank 0 writes;
    rank 0 holds each file against `read_logical`); 2 steps (losses A);
    a fresh executor and scope loaded from the files and the same 2
    steps; then two numbered checkpoints in a directory of each rank's,
    rank 1's newest truncated, and `load_checkpoint` under
    ``PADDLE_CKPT_AGREE=1``."""
    import torch

    from paddle_tpu_torch import distributed, fleet, fluid
    from paddle_tpu_torch.fluid import checkpoint, io

    rank = distributed.get_rank()
    fluid.set_flags({"FLAGS_tpu_sharded_weight_update": True})
    c = FLEET_A
    main, startup, loss = build_fluid_resnet(
        fluid, c["img"], c["classes"], c["lr"], True,
        strategy=fleet.DistributedStrategy())
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    feed = resnet_feed(c["batch"], c["img"], c["classes"])

    def steps(e, s, k):
        return [e.run(main, feed=feed, fetch_list=[loss],
                      scope=s)[0].ravel().tolist() for _ in range(k)]

    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    first = steps(exe, scope, 1)
    info = exe.last_entry.info()
    logical = {n: exe.read_logical(n, main, scope) for n in names}
    persist = os.path.join(out_dir, "c_persist")
    with fluid.scope_guard(scope):
        _, save_ms = ckpt_timed(torch, lambda: io.save_persistables(
            exe, persist, main))
    files_differ = None
    if rank == 0:
        files_differ = ckpt_equal(io._load_dict(persist), logical)
    del logical
    a = steps(exe, scope, CKPT_C_STEPS)
    exe2 = fluid.Executor()
    scope2 = fluid.Scope()
    with fluid.scope_guard(scope2):
        _, load_ms = ckpt_timed(torch, lambda: io.load_persistables(
            exe2, persist, main))
    b = steps(exe2, scope2, CKPT_C_STEPS)
    root = os.path.join(out_dir, "c_rank%d" % rank)
    ckpt_ms = []
    for k in (1, 2):
        _, ms = ckpt_timed(torch, lambda: checkpoint.save_checkpoint(
            exe2, root, checkpoint.TrainStatus(0, k), main, scope=scope2))
        ckpt_ms.append(ms)
    distributed.barrier()
    if rank == 1:
        with open(os.path.join(checkpoint.latest_checkpoint_dir(root),
                               "persistables.pkl"), "wb") as f:
            f.write(b"\x00truncated")
    distributed.barrier()
    st, agree_ms = ckpt_timed(torch, lambda: checkpoint.load_checkpoint(
        exe2, root, main, scope=scope2))
    fleet_dump(os.path.join(out_dir, "ckpt_c%d.json" % rank), {
        "first": first, "losses": a, "loaded_losses": b,
        "files_differ": files_differ, "mb": ckpt_dir_mb(persist),
        "save_ms": save_ms, "load_ms": load_ms, "checkpoint_ms": ckpt_ms,
        "checkpoint_mb": ckpt_dir_mb(root), "agreed_step": st.step_no,
        "agree_load_ms": agree_ms,
        "agree_env": os.environ.get("PADDLE_CKPT_AGREE"),
        "opt_state_sharded_vars": info["opt_state_sharded_vars"],
        "mode": info["mode"]})


def ckpt_worker_cd(out_dir):
    """Legs c and d, one rank each, in one spawn of 2 gloo ranks."""
    import torch

    ckpt_worker_c(out_dir)
    torch.cuda.empty_cache()
    ckpt_worker_d(out_dir)


def ckpt_leg_c(out_dir):
    ranks = [fleet_read(out_dir, "ckpt_c%d.json" % r) for r in range(2)]
    r0 = ranks[0]
    res = {"leg": "c", "ranks": 2, "backend": "gloo",
           "config": "BASELINE config 5 through fleet, 128 a rank, "
                     "the sharded weight update (ZeRO-1)",
           "losses": r0["losses"], "loaded_losses": r0["loaded_losses"],
           "bit_equal": all(r["losses"] == r["loaded_losses"]
                            for r in ranks),
           "files_match_read_logical": r0["files_differ"] == [],
           "files_differ": (r0["files_differ"] or [])[:5],
           "mb": r0["mb"], "save_ms": [r["save_ms"] for r in ranks],
           "load_ms": [r["load_ms"] for r in ranks],
           "checkpoint_ms": [r["checkpoint_ms"] for r in ranks],
           "checkpoint_mb": [r["checkpoint_mb"] for r in ranks],
           "agreed_steps": [r["agreed_step"] for r in ranks],
           "agree_load_ms": [r["agree_load_ms"] for r in ranks],
           "agree_env": [r["agree_env"] for r in ranks],
           "opt_state_sharded_vars": r0["opt_state_sharded_vars"],
           "mode": r0["mode"]}
    emit({"phase": "ckpt_leg", **res})
    check(r0["opt_state_sharded_vars"] > 0, "ckpt c: state not sharded")
    check(res["files_match_read_logical"], "ckpt c: files differ from "
          "read_logical in %s" % res["files_differ"])
    check(res["bit_equal"], "ckpt c: reloaded %s against %s"
          % (r0["loaded_losses"], r0["losses"]))
    check(res["agreed_steps"] == [1, 1], "ckpt c: agreed on %s, not on "
          "step 1 everywhere" % res["agreed_steps"])
    return res


def ckpt_worker_d(out_dir):
    """Leg d, one rank: the default SPMDConfig on a tp2 mesh, 2 steps;
    `ShardedCheckpointManager.save` of the params and Adam moments at
    step 2; 2 steps (losses A); the step restored into the same mesh's
    layout and the same 2 steps; the sha256 of every param gathered to
    its global shape at the save."""
    import torch

    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.distributed import ShardedCheckpointManager
    from paddle_tpu_torch.parallel import transformer as tt

    rank = distributed.get_rank()
    cfg = tt.SPMDConfig(tp=2)
    mesh = cfg.mesh(device=DEV)
    params = tt.shard_params(tt.init_params(cfg, seed=0, device=mesh.device),
                             cfg, mesh)
    opt = tt.init_opt_state(params)
    step = tt.make_train_step(cfg, mesh)
    tokens, labels = tt.demo_batch(cfg, SPMD_BATCH, seed=0)
    specs = tt.param_specs(cfg)
    tree_specs = {"params": specs, "opt": (specs, specs)}

    def run(p, o, k0):
        losses = []
        for k in range(CKPT_D_STEPS):
            p, o, loss = step(p, o, tokens, labels, k0 + k)
            losses.append(float(loss))
        return p, o, losses

    params, opt, first = run(params, opt, 0)
    mgr = ShardedCheckpointManager(os.path.join(out_dir, "d_ckpt"))
    state = {"params": params, "opt": opt}
    _, save_ms = ckpt_timed(torch, lambda: mgr.save(
        CKPT_D_STEPS, state, specs=tree_specs, mesh=mesh))
    digests = {k: digest(v) for k, v in
               leaves(tt.params_to_numpy(params, cfg, mesh))}
    _, _, a = run(params, opt, CKPT_D_STEPS)
    template = {"params": tt._tree_map(torch.empty_like, params),
                "opt": tuple(tt._tree_map(torch.empty_like, m)
                             for m in opt)}
    back, restore_ms = ckpt_timed(torch, lambda: mgr.restore(
        template=template, specs=tree_specs, mesh=mesh))
    _, _, b = run(back["params"], tuple(back["opt"]), CKPT_D_STEPS)
    fleet_dump(os.path.join(out_dir, "ckpt_d%d.json" % rank), {
        "first": first, "losses": a, "restored_losses": b,
        "save_ms": save_ms, "restore_ms": restore_ms, "digest": digests,
        "coords": list(mesh.coords)})


def ckpt_leg_d(torch, out_dir):
    from paddle_tpu_torch.distributed import ShardedCheckpointManager

    ranks = [fleet_read(out_dir, "ckpt_d%d.json" % r) for r in range(2)]
    r0 = ranks[0]
    root = os.path.join(out_dir, "d_ckpt")
    mgr = ShardedCheckpointManager(root)
    whole, one_ms = ckpt_timed(torch, mgr.restore)
    got = {k: digest(v) for k, v in leaves(whole["params"])}
    differ = sorted(k for k in r0["digest"] if got.get(k) != r0["digest"][k])
    res = {"leg": "d", "ranks": 2, "backend": "gloo",
           "config": "the default SPMDConfig (Megatron) on dp1 pp1 tp2",
           "losses": r0["losses"], "restored_losses": r0["restored_losses"],
           "bit_equal": all(r["losses"] == r["restored_losses"]
                            for r in ranks),
           "one_process_bit_equal": not differ, "differ": differ[:5],
           "mb": ckpt_dir_mb(root),
           "save_ms": [r["save_ms"] for r in ranks],
           "restore_ms": [r["restore_ms"] for r in ranks],
           "one_process_restore_ms": one_ms,
           "steps": mgr.all_steps()}
    emit({"phase": "ckpt_leg", **res})
    check(all(math.isfinite(x) for x in r0["first"] + r0["losses"]),
          "ckpt d: losses %s" % (r0["first"] + r0["losses"]))
    check(res["bit_equal"], "ckpt d: restored %s against %s"
          % (r0["restored_losses"], r0["losses"]))
    check(res["one_process_bit_equal"], "ckpt d: one process differs from "
          "the gathered tp2 params in %s" % differ[:5])
    return res


def phase_ckpt(torch, name):
    """Phase 16: checkpoints and model io on the card, with
    ``FLAGS_cudnn_deterministic`` on: leg a config 5 in one process, leg
    b BERT-base S 4096, then one spawn of 2 gloo ranks for leg c (config
    5 with ZeRO) and leg d (the mesh trainer, tp2)."""
    import shutil
    import tempfile

    from paddle_tpu_torch import distributed, fluid

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    before = fluid.get_flags("FLAGS_cudnn_deterministic")
    os.environ["FLAGS_cudnn_deterministic"] = "1"
    fluid.set_flags({"FLAGS_cudnn_deterministic": True})
    out_dir = tempfile.mkdtemp(prefix="ckpt_")
    try:
        legs = {"a": ckpt_leg_a(torch, fluid, out_dir),
                "b": ckpt_leg_b(torch, fluid, out_dir)}
        fleet_spawn(distributed, ckpt_worker_cd, (out_dir,), 2, "gloo")
        legs["c"] = ckpt_leg_c(out_dir)
        legs["d"] = ckpt_leg_d(torch, out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        fluid.set_flags(before)
        os.environ.pop("FLAGS_cudnn_deterministic", None)
    emit({"phase": "ckpt", "seconds": time.perf_counter() - t0,
          "legs": ["a", "b", "c", "d"], "device": name,
          "nvidia_smi": nvidia_smi_line(),
          "bit_equal": {"a": legs["a"]["live_bit_equal"]
                        and legs["a"]["fresh_bit_equal"]
                        and legs["a"]["async_bit_equal"],
                        "b": legs["b"]["bit_equal"]
                        and legs["b"]["inference_bit_equal"],
                        "c": legs["c"]["bit_equal"],
                        "d": legs["d"]["bit_equal"]
                        and legs["d"]["one_process_bit_equal"]},
          "agreed_steps": legs["c"]["agreed_steps"]})
    return legs


def leaves(tree, prefix=""):
    """(path, tensor) for every leaf of a nested dict, in order."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from leaves(val, prefix + key + "/")
        else:
            yield prefix + key, val


def kernel_entry(name, replaces, launches, case, prefill):
    """An RPA kernel's line at the decode bucket, with its prefill case's
    times beside."""
    return {"name": name, "route": "cuda", "source": RPA_SOURCE,
            "replaces": replaces, "launches": launches,
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"],
            "library_ms": case["library_ms"], "at_case": case["case"],
            "prefill": {key: prefill[key] for key in (
                "case", "ms", "plain_ms", "library_ms", "bound_ms")}}


def flash_times(kname, case):
    """A flash kernel's numbers in one phase 5 case. library_ms is
    scaled_dot_product_attention's forward for the forward kernel and its
    backward (dq, dk and dv together) for the two backward kernels;
    `design` says how the kernel runs ("wgmma bf16" or "simt ...") and
    `tflops` is its rate on the attending pairs."""
    k = case["kernels"][kname]
    errs = case["max_abs_err"]
    err = {"forward": max(errs["o"], errs["lse"]),
           "dkv": max(errs["dk"], errs["dv"]), "dq": errs["dq"]}[kname]
    lib = case["library_ms"]["forward" if kname == "forward"
                             else "backward"]
    return {"max_abs_err": err, "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": lib, "design": k["route"], "tflops": k["tflops"],
            "at_case": case["case"]}


def flash_entry(kname, replaces, launches, case, bert_launches, bert_case,
                mesh, mesh_cases):
    """A flash kernel's line: its launches on the trainer's path (phase 6)
    and its numbers at the trainer's shape (case a); beside them, its
    launches on the fluid BERT path at S 4096 (phase 8, leg b) and its
    numbers at that shape, and its launches a rank on the mesh trainer's
    timed steps (phase 13, legs a and b) with its numbers at each leg's
    shape and layout (`mesh_cases`: leg -> phase 5 case)."""
    return dict({"name": "flash_attention_" + kname, "route": "cuda",
                 "source": FLASH_SOURCE, "replaces": replaces,
                 "launches": launches}, **flash_times(kname, case),
                fluid_bert=dict(launches=bert_launches,
                                **flash_times(kname, bert_case)),
                spmd_mesh={leg: dict(
                    mesh=SPMD_A if leg == "a" else SPMD_B,
                    launches_per_rank=[r[kname] for r in
                                       mesh[leg]["flash_launches"]],
                    **flash_times(kname, mesh_cases[leg]))
                    for leg in ("a", "b")})


def flash_f16_entry(kname, replaces, launches, case):
    """A float16 flash kernel's line: its launches on phase 17 leg b's
    timed steps (BERT-base S 4096 under float16 AMP) and its numbers at
    that shape (phase 5 case g)."""
    return dict({"name": "flash_attention_%s_f16" % kname, "route": "cuda",
                 "source": FLASH_SOURCE, "replaces": replaces,
                 "launches": launches}, **flash_times(kname, case))


def dropout_entry(launches, cases):
    """The dropout kernel's line: its launches on fluid BERT leg a's timed
    steps and its numbers at the hidden dropout's shape, with the
    attention probabilities' case beside. It stands in for the
    reference's dropout op, which XLA lowers (no Pallas kernel)."""
    main, other = cases["bert_hidden_bf16"], cases["bert_probs_f32"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return dict({"name": "dropout", "route": "cuda",
                 "source": DROPOUT_SOURCE, "replaces": DROPOUT_REF,
                 "launches": launches, "max_abs_err": max(
                     main["max_abs_err"], other["max_abs_err"])},
                **{k: main[k] for k in keys}, at_case=main["case"],
                probs={k: other[k] for k in keys + ("case",)})


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the "
              "card", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "paddle_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(paddle_tpu_torch/ not found beside it)", file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    name = phase_device(torch)
    phase_build()
    timer = Timer(torch)
    cases = phase_kernel_cases(torch, timer)
    flash = phase_flash_cases(torch, timer)
    drop = phase_dropout_cases(torch, timer)

    from paddle_tpu_torch import serving

    model = serving.TinyDecoderLM(serving.TinyLMConfig(**BERT_BASE))
    bf16 = run_main_path(torch, serving, model, "bfloat16",
                         serving.synthetic_trace(**BF16_TRACE))
    int8 = run_main_path(torch, serving, model, "int8",
                         serving.synthetic_trace(**INT8_TRACE))
    phase_forward_kernel_vs_plain(torch, serving, model)
    del model
    torch.cuda.empty_cache()
    train = phase_training(torch)
    phase_fluid(torch, name)
    fluid_bert = phase_fluid_bert(torch, name)
    resnet = phase_fluid_resnet(torch, name)
    phase_fluid_transformer(torch, name)
    phase_graphs(torch, name)
    phase_fleet_dp(torch, name, resnet["leg_a"])
    mesh = phase_spmd_mesh(torch, name, train)
    phase_zero(torch, name)
    phase_hybrid(torch, name)
    phase_ckpt(torch, name)
    f16 = phase_fluid_bert_fp16_lamb(torch, name)
    large = phase_bert_large_batch(torch, name)
    phase_book(torch, name)
    phase_sequences(torch, name)
    phase_detection(torch, name)
    phase_det_extra(torch, name)

    float_err = max(cases[n]["max_abs_err"] for n in cases
                    if "int8" not in n)
    quant_err = max(cases[n]["max_abs_err"] for n in cases if "int8" in n)
    kernels = {"kernels": [
        dict(kernel_entry("ragged_paged_attention", RPA_TPU + ":172",
                          bf16["kernel_launches"], cases["decode_bf16"],
                          cases["prefill_bf16"]),
             max_abs_err=float_err),
        dict(kernel_entry("ragged_paged_attention_int8", RPA_TPU + ":235",
                          int8["int8_kernel_launches"],
                          cases["decode_int8"], cases["prefill_int8"]),
             max_abs_err=quant_err),
    ] + [flash_entry(kname, FLASH_TPU + ":" + line, train["launches"][kname],
                     flash[FLASH_CASES[0]["name"]],
                     fluid_bert["legs"][1]["launches"][kname],
                     flash["bert_s4096_bf16"], mesh,
                     {leg: flash[c] for leg, c in SPMD_FLASH_CASES.items()})
         for kname, line in (("forward", "109"), ("dkv", "235"),
                             ("dq", "298"))]
        + [flash_f16_entry(kname, FLASH_TPU + ":" + line,
                           f16["legs"][1]["float16_launches"][kname],
                           flash["bert_s4096_f16"])
           for kname, line in (("forward", "109"), ("dkv", "235"),
                               ("dq", "298"))]
        + [dropout_entry(fluid_bert["legs"][0]["dropout_launches"], drop)]}
    # phase 18 leg a's launches over its last window (4 micro-steps)
    window = large["leg_a"]["launches_window"]
    for entry in kernels["kernels"]:
        kname = entry["name"].replace("flash_attention_", "")
        if entry["name"] == "dropout" or kname in ("forward", "dkv", "dq"):
            key = "dropout" if entry["name"] == "dropout" else kname
            entry["bert_large_batch"] = {
                "launches_window": window[key],
                "launches_per_micro_step": window[key] / LB_K}
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start,
                                             3)})
    emit(kernels)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print("chip_smoke: FAILED: %s" % e, file=sys.stderr)
        sys.exit(1)
