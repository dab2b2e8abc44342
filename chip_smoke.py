"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) once on one GPU.

Run from the repository root: ``python3 chip_smoke.py``.  It needs a CUDA
device and ``nvcc`` and exits non-zero without them (or outside a
checkout of the repository).  Phases, each fatal on failure:

1. card: ``nvidia-smi`` name and power limit; TF32 switched off for
   matmuls and cuDNN so f32 means f32;
2. build: every ``paddle_tpu_torch/csrc/*.cu``, one ``nvcc`` each, in
   parallel;
3. kernels: the ragged paged-attention kernel against its plain PyTorch
   version at the serving shapes (H=16, D=128, page 128, 8 pages a
   sequence; ``tools/ragged_cases.py``) — decode-only, mixed
   prefill+decode, GQA 4, int8 and bf16 pages, bf16 queries on bf16 pages
   (the tensor-core path, decode and mixed) and on f32 pages, and the
   mixed step at G 3 (12 heads over 4 KV heads), G 16 (one KV head) and
   head dims 16, 32, 64 and 256, and between the compiled widths at 96
   (f32 pages) and 80 (int8 pages) — with error, kernel time, plain time
   and the roofline bound;
4. serve: a full-width DecoderLM (vocab 32768, d 2048, 8 layers, 16
   heads) with random weights from a seed, through the port's
   ServingEngine at the flag defaults with a 129-page pool: 8 requests,
   chunked prefill mixed with decode and a shared 512-token prefix; the
   run must drain with page conservation, launch the kernel once per
   layer per step, and match the port's own greedy reference;
5. int8 serve: a short serve on an int8 pool plus the QUANT-DRIFT check;
   then ``DecoderLM`` at its defaults (2 layers, 2 heads of head_dim 16)
   and its bf16 version, each served briefly and held to the greedy
   oracle;
5a. the serving engine's upper tier (``tools/spec_workload.py``) on the
   same full-width model: verify_kernel, the ragged kernel on the
   widened step of speculation (8 slots of 1 + spec_k rows, spec_k 1, 4
   and 7, rows straddling page boundaries, f32/bf16/int8 pages, bf16
   queries, head dims 128 and 16; ``rc.VERIFY_CASES``) against its plain
   version; serve_spec_ngram, the serve phase's 8 prompts and 4
   repeated-motif prompts without speculation and with n-gram
   speculation (k 4, n 3): every stream token-identical (a difference
   only after a near tie), pages conserved, proposed and accepted
   non-zero, B4 once a layer a step; serve_spec_draft, a 2-layer d-1024
   draft with its own seeded weights and pool, then the target as its
   own draft (acceptance above 0.9), the draft pool conserved, B4 once a
   layer a step of both models; serve_sampled_spec, temperature 0.8 and
   top-p 0.95 with a seed a request, two runs bit-identical;
   obs_trace, the n-gram drive with a ``Tracer``, its events saved,
   read back by ``obs.load_events`` and exported as a Chrome trace, the
   spans present, the registry's exposition holding the spec and
   host-tier series; serve_host_tier, a 12-usable-page pool under a
   32-page host tier, 'stored' (bit-identical K/V, tokens equal to a cold
   re-prefill), 'int8' (K/V within half a quantization step) and one byte
   flipped on the host (caught, a miss, the cold tokens);
5b. the fleet (``tools/fleet_workload.py``) on the same full-width model,
   shared by every replica: serve_fleet, 24 requests of 6 tenants'
   512-token system prompts at 50/s over 4 replicas (41-page f32 pools,
   8 pages a sequence, 4 slots) with replica 0 killed at tick 25, routed
   by prefix affinity and by round robin: every request completed, no
   duplicate completion, conservation on every pool, dead pools
   released, B4 once a layer a step of every replica, each stream equal
   to its result and the two policies' outputs equal (a difference only
   at a near tie of the oracle), affinity's prefix hit rate at least
   round robin's; serve_disagg, 24 requests (70% on one hot 512-token
   prompt) over 4 unified replicas, then 2 prefill + 2 decode replicas
   (chain migrations applied, the migration ledger balanced, outputs
   equal to the unified fleet's), on int8 pools (migration bytes a
   request at most 0.35 of f32's) and with decode replica 3 killed
   (resubmits re-adopt prefix pages); migrate_kernel, one chain moved
   between two engines on f32, bf16 and int8 pools, B4 over the imported
   pages right after the import against its plain version, the pages
   bit-identical to the blob's; fleet_checks, the fleet, migrate,
   control and kv_cache gates and ``obs.cli.seeded_chaos`` on the card;
5b'. serve_tp (``tools/tp_workload.py``): the serve phase's model and
   requests through ``ServingEngine(mesh=make_mesh((2,), ("model",)))``
   in two processes on this card joined by gloo (NCCL takes one rank a
   card; gloo's ``all_reduce`` takes CUDA tensors through host copies),
   each rank building only its shard (8 heads, 4096 FFN columns, a
   [8, 129, 128, 8, 128] f32 K and V pool shard) from the numpy weights:
   the ranks' tokens equal, equal to the serve phase's one-process
   tokens (a parting only at a near tie of the one-process reference,
   replayed and printed), B4 launched 8 x steps on each rank and each
   rank's B4 at step 2 held against its plain version on the shard, 2 x 8
   all-reduces a step with their bytes equal to ``tp_step_comm_bytes``,
   pages conserved; wall time, tokens/s and the all-reduces' share of
   the wall as what they are (two ranks time-sharing one card, the card
   synchronized around each all-reduce); serve_tp_world1: the
   tensor-parallel engine on a one-rank NCCL 'model' mesh against the
   engine without a mesh, every step's logits and every token equal to
   the bit;
5c. cli: ``python -m paddle_tpu_torch train`` on a small config for one
   pass on the card, then ``train --job=test`` over its tar,
   ``dump_config``, ``version`` (exit 0) and a config without a reader
   (exit 2);
6. flash_kernels: the flash-attention forward, dK/dV and dQ kernels
   against their plain PyTorch versions on the same inputs: the training
   path's q/k/v [1, 8192, 16, 128] bf16 with 8 causal segments of 1024,
   ragged segments with padding as the feeder packs them, f32 causal
   segments at a smaller S (head dims 128 and 64), non-causal
   cross-attention with Sq != Sk, causal with Sk > Sq (f32, and bf16 with
   Sq an odd number of 64-row tiles), bf16 causal segments at head dim
   64, and the CUDA-core route at head dims 32 and 256, at Sq 96, and at
   head dims between its compiled widths (96 in bf16, 48 in f32), and the
   translation model's three attentions at [1, 4096, 8, 64] bf16 over one
   batch's packing (encoder segments, cross-attention of the targets'
   packing against the sources', causal decoder segments); with error,
   kernel time, plain time, the roofline bound, the interior and boundary
   tile pairs and, on the training case,
   ``scaled_dot_product_attention`` forward, backward alone and both as
   the library yardsticks (on the translation cases SDPA with the dense
   [Sq, Sk] mask); the kernels line carries ptxas's registers and
   spills of each flash and RNN kernel;
7. train: the full-width transformer LM (vocab 32768, d 2048, 8 layers,
   16 heads) with random weights from a seed, trained through the port's
   v2 surface (``Parameters.from_topology``, ``trainer.SGD.train``,
   ``Momentum(0.9, 1e-3)``) on one batch of 8 x 1024 tokens repeated for
   6 steps: finite costs, the last below the first, each flash kernel
   launched 8 layers x 6 steps times;
8. train_parity: a 2-layer model at the same width, batch 2 x 1024, 3
   steps through the kernels against the same steps through the plain
   flash versions on the card, with the same weights and feeds;
8a. train_lm_levers: the same training with ``fused_head=True`` (the
   blockwise ``lm_head_cost``), then with ``fused_head=True, remat=True,
   dropout=0.1``, 6 steps each beside the unfused run: step ms, tokens/s,
   peak memory, flash launches (B1 twice a block a step under remat);
   the fused run's first 3 costs within the bf16 bound of the unfused
   run's;
8b. train_resume (``tools/resilience_workload.py``): the same
   full-width transformer, one pass of 5 steps with NaN poison at global
   step 1 under ``BadStepGuard("skip")``; a control under the plan's
   control twin, then a chaos run killed at global step 4 with async
   checkpoints every 3 steps (``keep`` 2), resumed by ``run_supervised``
   with a fresh trainer from the same weights: every parameter and
   Momentum slot ``torch.equal`` to the control's, the costs per (pass,
   batch) equal, one step skipped in each run with every tensor left as
   it was, one restart from the step-3 checkpoint, each flash kernel
   launched 8 x the steps run; the checkpoint bytes, the train loop's
   stall per save, the background write and md5 seconds, the resume's
   load and verify seconds, guarded and unguarded step ms, peak memory;
   resilience_chaos: ``resilience.chaos.seeded_chaos`` and
   ``torn_save_probe`` on the card with the reference's default plan (no
   problems); train_elastic: a narrow transformer (vocab 1024, d 256, 2
   blocks, 4 heads, 2 x 256 tokens a task) over 8 recordio tasks from an
   in-process master on an injected clock, killed at step 5 with async
   checkpoints every 2 tasks, the lease lapsed, a replacement trainer:
   params ``torch.equal`` to a straight run's, every task acked once,
   nothing pending, one ``MasterClient`` round trip over a
   ``MasterServer`` on localhost;
8c. train_moe (``tools/parallel_workload.py``): bench.py's MoE LM
   (vocab 32768, d 1024, 8 layers, 16 heads, 8 experts, top-1, batch 4 x
   1024) through ``SGD`` without a mesh (the dense dispatch), bf16
   policy, Momentum 0.9 at 1e-3: a warm-up and 5 timed steps, finite
   costs, B1-B3 launched 8 x 6 times each; its dense twin at the same
   width; tokens/s, ms a step, the MoE/dense step ratio, peak memory;
   then a 2-layer, d 128, 4-expert copy's f32 step on the card against
   the CPU path (cost 1e-4 relative, each weight's update 1e-3);
8d. parallel_world1: a one-rank NCCL process group; the headline
   transformer from one set of weights, 3 steps without a mesh, under
   ``SGD(mesh=data_parallel_mesh(), zero=1)`` (equal to the bit) and
   under ``SGD(pipeline=PipelineConfig(microbatches=4))`` (the GPipe
   schedule's padded microbatches: costs 1e-3 relative, the weights
   within 2e-2 of the no-mesh update in norm, bf16 attention inputs
   tiled otherwise), B1-B3 launched 8 x 3 and 8 x 4 x 3 times; the MoE
   layer on an ``expert`` axis of one rank (its all-to-alls on NCCL)
   against the dense path at d 1024, 4096 tokens, f32 (1e-5); DeepFM's
   33.76 M x 10 factor table through ``sharded_lookup``,
   ``alltoall_lookup`` and ``sharded_row_update`` on a 'model' axis of
   one against the plain gather and ``sgd_update_rows`` (equal to the
   bit); ``LocalSGD(sync_period=1)`` against plain SGD (to the bit); batch
   norm's sums and the MoE dispatch's counts pooled over a 'data' axis of
   one against their unpooled runs (batch norm to the bit, the MoE layer
   and its gradients 1e-5);
9. rnn_kernels: the fused LSTM step (B5), the one-launch GRU step (B6)
   and the two-launch GRU step (B7 then B8) against their plain PyTorch
   versions on the same inputs: B5 at B 64 with H 512 and 1280, acts on
   and off, and a bf16 xp, and at H 128 with B 10 (SRL) and 128
   (quick_start); B6 at H 512 and B7 + B8 at H 1280, acts on and
   off; with error, card time, plain time, the roofline bound, the SM
   clock read after the case's timings and, for B5, cuDNN's ``nn.LSTM``
   forward over T = 128 steps divided by T;
10. train_lstm: bench.py's IMDB text classifier (``models/text_lstm``,
    dict 30000, embedding 128, 2 x LSTM h 512, max pooling, fc(2)) with
    random weights from a seed, trained through ``SGD.train`` with
    ``Momentum(0.9, 0.01)`` on one batch of 64 sequences of 100 tokens
    repeated for 6 steps: finite, falling costs, B5 launched 2 layers x
    128 steps x 6 times (the feeder buckets 100 to 128);
11. train_gru: the same classifier with ``simple_gru`` layers, at h 512
    (2 layers, 6 steps, B6 only) and at h 1280 (1 layer, 3 steps, B7 and
    B8 only), each with finite, falling costs and exact launch counts;
12. rnn_parity: the LSTM and the GRU classifier at full width, batch 16,
    3 steps through the kernels against the same steps through the plain
    versions on the card (``rnn_workload.plain_rnn_path``);
12a. nmt_parity: the attention seq2seq NMT (``tools/nmt_workload``,
    demo/seqToseq's width: dictionaries of 30000, word vectors and GRUs
    of 512) in f32, batch 8 of lengths 10-20: one step on the card (the
    encoder's GRUs through B6) against the same step on the port's CPU
    path, same weights and batch: the cost and each parameter's update;
12b. train_nmt: the NMT at its configuration (batch 50 of lengths 10-80,
    Adam at 5e-4, the bf16 policy) through ``SGD.train`` on one batch, a
    warm-up and 5 timed steps: finite, falling costs, B6 launched 2 x the
    source frames a step; step ms, target tokens/s, peak memory, launches
    a step;
12c. generate_nmt: ``seq2seq.build_generator`` (beam 3, max_length 250)
    through ``Inference`` on the trained weights, shared by name, for 16
    sources, with ``<e>`` banned by a ``candidate_adjust`` until each
    source's drawn target length (outputs of 10-80 words, as the data's)
    and, as the worst case, until step 250: ms a batch, steps taken,
    sentences/s, B6 launched 2 x the source frames a batch; at the target
    lengths every step of the timed runs against the CPU path with the
    same weights, made to follow the card's beams
    (``nmt_workload.Replay``): the same choices, or others only at a near
    tie, the same log-probabilities, the same paths and scores at the
    end; the worst case's two card runs the same bits;
13. image_parity: ResNet-18 at 64 px, batch 8, in f32 (TF32 off): 3
    ``Momentum(0.9, 0.01)`` steps through the port's plain CPU path, and
    before each the same step on the card (cuDNN, channels-last maps) from
    the CPU run's weights and moving statistics: costs and new moving
    statistics within tolerance;
14. train_resnet50: bench.py's headline cell (``tools/image_workload``:
    ResNet-50, 224 px, batch 128, ``Momentum(0.9, 0.01)``, bf16 conv
    operands and maps) with ``SGD.step`` on device-resident [B, H, W, C]
    feeds, one warm-up and 6 timed steps on the repeated batch (finite
    costs, the last below the first, every moving mean moved from 0), then
    one ``SGD.train`` pass over 2 flat CHW batches through the
    ``DataFeeder``'s dense slot; images/s, step ms, peak memory, the
    analytic FLOP rate and launches a step;
15. train_convnets: AlexNet (227 px, batch 128), GoogLeNet (224, 64),
    SmallNet (32, 64) and LeNet (28, 64), 4 steps each with dropout at its
    real rate: finite, falling costs and ms per batch;
16. head_dims: the flash kernels (B1-B3) at head dims 12, 100 and 320
    (``tw.C4_FLASH_CASES``) and, on the wide kernels, 640 and 1024
    (``tw.C4_WIDE_FLASH_CASES``), in f32 and bf16, and the ragged kernel
    (B4) at the same head dims on f32, bf16 (and, up to 320, int8) pages,
    decode and mixed (``rc.C4_CASES``, ``rc.C4_WIDE_CASES``) against
    their plain versions, with error, card time, plain time and bound
    (and for B1-B3 SDPA with the dense mask as the library time); a
    ``DecoderLM`` at head_dim 100 (d_model 400, 4 heads, its pool rows
    padded to 104) serving 4 requests held to the greedy oracle;
    ``multi_head_attention`` at head dims 12, 320 and 640 trained 3 steps
    on the card against the CPU path (f32);
17. reproducible: two NMT training steps (after 12c) and two DeepFM
    steps at full width (after 19) from one state give the same bits
    (``tools/repro.step_twice``), and so do the timed generations of 12c;
18. deepfm_parity: DeepFM in f32 (39 fields, the full tower, V 65,536,
    batch 512), 3 Adam steps on the card against the CPU path: costs and
    every parameter;
19. train_deepfm: DeepFM at Criteo's width (``tools/ctr_workload``: V
    33,763,409, k 10, 400-400-400, batch 4096, Adam 1e-3) through
    ``SGD.train`` on one batch, a warm-up and 6 timed steps: finite,
    falling costs; step ms, examples/s, peak memory, launches a step, the
    idle share and the card time by group (``tools/profile_ctr``);
20. sparse_rows: ``parallel/sparse``'s row updates on the full-width
    ``deepfm.v`` table with one batch's 159,744 ids against the dense
    step, untouched rows bit-identical, and their card ms;
21. train_gan: the GAN (``tools/gan_vae_workload``) at MNIST's width and
    the uniform demo's, 20 alternating step pairs through
    ``MultiTaskTrainer``: each task's first step leaves the other side's
    tensors bit-identical; at MNIST's width ``d_cost`` falls; ms a pair;
22. train_vae, train_traffic: the VAE (784/128/100) and the traffic
    forecaster (24 horizons), 20 steps each: finite, falling costs, ms a
    step;
23. srl_parity: SRL (``tools/srl_workload``) in f32 at depth 3, LSTMs of
    32, vocab 512, batch 10: 3 steps on the card (B5) against the CPU
    path from the same weights, costs and every parameter, then both
    decode the batch: the same paths;
24. train_srl: SRL at the PaddlePaddle book's width (depth 8, LSTMs of
    128, the conll05 dictionaries' sizes), batch 10, ``Momentum(0,
    1e-3)``, a warm-up and 6 timed steps: finite, falling costs, B5
    launched 8 x frames a step; sentences/s, tokens/s, peak memory, the
    card time by group and the idle share of a profiled step; then
    ``crf_decoding`` through ``Inference``: ms a batch, paths equal to
    the CPU path's;
25. train_chunker: the CoNLL-2000 chunker (``models/sequence_tagging``,
    23 tags), batch 64, Adam 1e-3, 6 steps with ``evaluator.chunk`` (IOB,
    11 chunk types) over its decoded tags as an extra layer (F1 a step, in
    [0, 1]), then its decode against the CPU path's;
26. train_quick_start: the seven quick_start classifiers
    (``tools/quick_start_workload``: dict 30000, embedding 128, batch 128
    of 10-100 tokens, Adam 2e-3), 4 steps each: finite, falling costs, B5
    launched layers x frames a step, ms a batch;
27. nested_groups, beam_cost: three hierarchical groups
    (``tools/nested_workload``, width 128, batch 16 through the
    sub-sequence slot), 3 Adam steps on the card against the CPU path;
    ``cross_entropy_over_beam`` on its cases, costs and gradients, card
    against CPU;
28. transformer_nmt_parity: ``transformer.build_seq2seq`` at d 64, 2 + 2
    blocks, 4 heads, vocab 512, in f32, batch 16: 3 Adam steps on the
    card against the CPU path, costs and every parameter;
29. train_transformer_nmt: Transformer-base translation
    (``tools/transformer_nmt_workload``: 6 + 6 blocks, d_model 512, 8
    heads, dictionaries of 30000, batch 80 of lengths 10-80, Adam(0.9,
    0.98, 1e-9) at 5e-4, the bf16 policy), a warm-up and 6 timed steps
    through ``SGD.train``: finite, falling costs, B1-B3 launched 18 times
    a step each; step ms, target tokens/s, peak memory, and one profiled
    step (``tools/profile_transformer_nmt``): idle share, launches, card
    time by group;
30. generate_lm: the training headline's parameters (seed 0) decoded from
    the parameter dict: greedy ``generate`` (64 tokens after 32),
    ``beam_generate`` (beam 4, 32 tokens, a banned token, a stop after
    step 24) and ``beam_generate_batch`` (8 prompts): ms a token,
    tokens/s, launches a step, peak memory; the greedy tokens replayed on
    the CPU path at full width, the batch against per-prompt runs, the
    hooks honoured, two seeded temperature draws equal (the CPU path's
    own full-width beam run was cut for the script's clock);
31. v2_sentiment: IMDB sentiment through the whole v2 loop
    (``tools/v2_loop_workload``: bench.py's text_lstm, embedding 128, 2 x
    LSTM of 512, ``dataset.imdb.word_dict()``'s 5147 words, ``batch(
    reader.shuffle(imdb.train(word_dict), 2048), 64)``, the book's
    ``Adam(2e-3, L2Regularization(8e-4), ModelAverage(0.5))``,
    ``classification_error`` and ``auc`` as extra layers): two passes at
    prefetch 2 with ``imdb.test`` as the test reader, then ``test``; its
    first 8 steps again from the same weights and shuffle at prefetch 0
    with the same cost bits; falling costs, every metric in [0, 1], B5 launched 2 x
    each batch's frames (training and test batches); ms a step and
    sequences/s at prefetch 0 and 2, the test pass's ms, the launches L2
    and model averaging add to Adam's update, a profiled step's idle
    share;
32. v2_resnet50: ResNet-50 (224 px, batch 128, bf16) fed flat CHW samples
    through a reader: a pass of 4 batches at prefetch 0 and one at 2,
    ``Momentum(0.9)`` at 0.01 with ``L2Regularization(1e-4)`` and a
    ``discexp`` schedule, top-1 and top-5 errors as extra layers, ``test``
    on 2 batches (batch norm on its moving statistics): images/s at both
    prefetches beside 14's device-feed step, the card ms L2 adds to the
    optimizer's range;
33. v2_mnist: BASELINE #1, LeNet through ``batch(reader.shuffle(
    dataset.mnist.train(), 8192), 128)`` with the book's
    ``Momentum(0.1 / 128, 0.9, L2Regularization(0.0005 * 128))``, one
    pass, ``test`` on ``mnist.test()`` (error below 0.5), ``infer`` on 16
    test images against the CPU path;
34. optimizers: the nine rules, each with every lever (L1L2, a global clip
    that binds, a per-parameter clip, a static tensor, a rate multiplier,
    a pruning hook, a ``manual`` schedule, ``ModelAverage``), 3 f32 steps
    on LeNet, card against the CPU path: every parameter, slot, average
    and scalar on the same gradients and on each side's own; a pruning
    quantile on a tensor of 16,781,312 > 2^24 elements, card against CPU;
35. evaluators: every case of ``v2_loop_workload.EVALUATOR_CASES``, card
    against CPU: values, metrics, the printers' text;
36. layers_v2: every case of ``tools/layer_cases.py`` with a float output
    (the tenth slice's layers at small widths) and ``nce`` (its draws made
    equal), forward and gradients card against the CPU path in f32;
37. detection: SSD300's VOC shapes (``tools/detection_workload.py``: 8732
    priors, 21 classes, batch 32): ``multibox_loss`` forward and gradient,
    ``detection_output`` (NMS 0.45, confidence 0.01, keep_top_k 200) and
    ``detection_map``, card against the CPU path, and their card ms;
38. vgg16: VGG-16 on Flowers-102's width (``tools/vgg_workload.py``: 224
    px, batch 64, 102 classes, bf16, ``Momentum(0.9)`` at 1e-2 with
    ``L2Regularization(5e-4)``): 6 timed ``SGD.step`` s on device feeds of
    one batch (finite, falling costs), a pass of 20 batches through
    ``SGD.train`` from ``batch(shuffle(map_readers(mapper, images), 128),
    64)`` at prefetch 0 and at 2, ms a step (timed from the end of the
    first batch) and images/s each way, peak memory, a profiled step's
    idle share and card ms by group; then one f32 step at batch 2 on the
    card against the CPU path, dropout masks made equal, cuDNN held to
    its deterministic algorithms (beside it, the same check's reading of
    the card's step with the algorithm search on, and of a bf16 step);
39. fluid_mnist (``tools/fluid_workload.py``): the Paddle book's
    recognize_digits MLP (784-128-64-10, Adam) and convnet (conv 20@5x5,
    pool, conv 50@5x5, pool, fc 10; Momentum 0.9) built with
    ``fluid.layers`` and run by ``fluid.Executor()`` on the card, batch
    64 of the seeded synthetic digits, 20 steps: the first 3 costs equal
    the port's CPU run from the same ``_init_value`` weights within
    ``COST_RTOL``, costs finite and falling, ``verify_program`` clean;
    ms a step (host clock), launches a step and peak memory;
40. fluid_control: StaticRNN, cond and a reverse DynamicRNN at small
    widths, 3 SGD steps card against CPU (costs, outputs, the input's
    gradient);
41. export (``tools/export_workload.py``): ResNet-50 at bench.py's width
    (224 px, 1000 classes, weights from seed 0) merged on the card with a
    symbolic batch (``export.merge_model``), loaded and run at batches 1
    and 8, run again through the port's C ABI (``native/capi.cpp``, an
    embedded CPython) from a C client in a subprocess, and exported as a
    ``.ptnm`` program at batch 1 that ``native/src/aot_runtime.cpp`` runs
    on the host in a client process with no Python (LeNet at 28 px too,
    batch 4): merged and C ABI outputs within ``MERGE_RTOL`` of the eager
    card forward, the ``.ptnm``'s within ``AOT_RTOL`` of the f32 one;
    the export's seconds, the artifact's bytes, the C ABI's load seconds,
    infer ms of merged, eager and the C ABI, the ``.ptnm``'s bytes and the
    C runtime's host ms;
42. native: 512 seeded LeNet samples written to two recordio files by
    the native writer, one training pass on the card through
    ``native.recordio_reader(window=128, seed=3)`` -> ``SGD.train``: the
    costs equal to the bit those of the same samples fed as a list in the
    pool's order (cuDNN held to its deterministic algorithms), the
    records read equal to the records written;
43. analysis: ``python -m paddle_tpu_torch.analysis lint`` and
    ``concurrency --rule guarded-by --rule state-table`` over the tree
    (exit 0), then the kill-partition chaos drive (3 replicas, a kill and
    a heartbeat partition) explored on the card at a budget of 8
    schedules: no divergence, the ragged kernel's launches counted, and
    the drive's engine call with the most real rows (1 layer, 2 heads of
    head dim 4 over pool rows padded to 8, pages of 4 tokens, f32)
    launched again and held against the plain version on the same
    tensors at 1e-4, kernel and plain timed between CUDA events beside
    the bound.

The datasets (31, 33, 39) are their seeded synthetic fallbacks: their
downloads are refused (``v2_loop_workload.offline``), so no phase
reaches the network.  Every line of output is one JSON object; the one before the last lists
the kernels, the last is ``{"ok": true, "device": {...}}``.  The serve
workload lives in ``paddle_tpu_torch/tools/serve_workload.py``, shared
with the profiler ``python -m paddle_tpu_torch.tools.profile_serve``; the
training workload and the flash cases in
``paddle_tpu_torch/tools/train_workload.py``; the recurrent workload and
the RNN cases in ``paddle_tpu_torch/tools/rnn_workload.py``; the NMT
in ``paddle_tpu_torch/tools/nmt_workload.py``, shared with
``python -m paddle_tpu_torch.tools.profile_nmt``; the image
cells in ``paddle_tpu_torch/tools/image_workload.py``, shared with
``python -m paddle_tpu_torch.tools.profile_image``; DeepFM in
``paddle_tpu_torch/tools/ctr_workload.py``, shared with ``python -m
paddle_tpu_torch.tools.profile_ctr``; the GAN, VAE and traffic
forecaster in ``paddle_tpu_torch/tools/gan_vae_workload.py``; the CRF
taggers in ``paddle_tpu_torch/tools/srl_workload.py``, quick_start in
``paddle_tpu_torch/tools/quick_start_workload.py`` and the nested groups
in ``paddle_tpu_torch/tools/nested_workload.py``; the translation
transformer in ``paddle_tpu_torch/tools/transformer_nmt_workload.py``,
shared with ``python -m paddle_tpu_torch.tools.profile_transformer_nmt``;
the v2 loop's in ``paddle_tpu_torch/tools/v2_loop_workload.py``;
the tenth slice's layer cases, SSD300 and VGG-16 in
``paddle_tpu_torch/tools/layer_cases.py``, ``detection_workload.py`` and
``vgg_workload.py``.
The image phases, 18-22, 25, 27, 32-42 and 43's static gates run no
hand-written kernel:
no TPU kernel lies on those paths (the convs and batch norm are cuDNN's through
PyTorch, the CTR and GAN products cuBLAS's).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# the port must come from this checkout; outside it this import fails
from paddle_tpu_torch.convert import parameters_from_numpy, state_from_numpy
from paddle_tpu_torch.tools import ctr_workload as cw
from paddle_tpu_torch.tools import fleet_workload as fw
from paddle_tpu_torch.tools import gan_vae_workload as gw
from paddle_tpu_torch.tools import image_workload as iw
from paddle_tpu_torch.tools import nested_workload as nestw
from paddle_tpu_torch.tools import nmt_workload as nw
from paddle_tpu_torch.tools import parallel_workload as pw
from paddle_tpu_torch.tools import profile_image, profiling
from paddle_tpu_torch.tools import quick_start_workload as qw
from paddle_tpu_torch.tools import ragged_cases as rc
from paddle_tpu_torch.tools import repro
from paddle_tpu_torch.tools import resilience_workload as resw
from paddle_tpu_torch.tools import rnn_workload as rw
from paddle_tpu_torch.tools import spec_workload as spw
from paddle_tpu_torch.tools import profile_transformer_nmt as ptn
from paddle_tpu_torch.tools import srl_workload as sw
from paddle_tpu_torch.tools import train_workload as tw
from paddle_tpu_torch.tools import tp_workload as tpw
from paddle_tpu_torch.tools import transformer_nmt_workload as tnw
from paddle_tpu_torch.tools.compare_flash import card_ms, sm_clock
from paddle_tpu_torch.tools.serve_workload import (MODEL, NEW_TOKENS, NO_EOS,
                                                   PREFIX_LEN, Workload,
                                                   build_model, make_engine,
                                                   warm_up)

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet,
# dense): the roofline bound of a kernel is the larger of bytes / HBM rate
# and, summed over its products, operations / peak rate of their operand
# type (f32 on the CUDA cores; bf16 on the tensor cores)
HBM_BYTES_PER_S = rc.HBM_BYTES_PER_S
F32_FLOPS_PER_S = rc.F32_FLOPS_PER_S
BF16_FLOPS_PER_S = rc.BF16_FLOPS_PER_S

SEED = 0
H = rc.H


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean card time of one call over ``reps`` calls run back to back
    between two CUDA events, after warm-up.  The host enqueues ahead of
    the card, so a wrapper's own host work (argument checks, launching its
    small helper ops) shows only where it outlasts the card's work; a
    synchronize after every call would add it to each reading."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


# ---------------------------------------------------------------------------
# kernel cases
# ---------------------------------------------------------------------------

def run_kernel_cases(dev, cases=None, phase: str = "kernel",
                     profiled: bool = True):
    """Every case of ``ragged_cases`` (``cases``, default its ``CASES``)
    through the kernel and the plain version on the card; raises if any
    case is outside its tolerance.
    ``ms`` is card time (:func:`device_ms`: the kernel's plan, attention
    and merge launches; with ``profiled`` False, the call back to back
    between CUDA events, as ``timer`` says); ``host_ms`` is the call back
    to back between CUDA events (:func:`time_ms`), which also holds the
    wrapper's host work where that outlasts the card's; ``plain_ms`` is
    the plain version's, between CUDA events (milliseconds of card work,
    outlasting its host work)."""
    from paddle_tpu_torch.serving.decode_attention import (
        ragged_paged_attention_kernel, ragged_paged_attention_reference)

    results = []
    for name, case in rc.kernel_cases(dev, cases):
        args, kw = rc.args(case), rc.scales(case)
        got = ragged_paged_attention_kernel(*args, **kw)
        torch.cuda.synchronize()
        real = case["qpos"] >= 0
        host_ms = time_ms(lambda: ragged_paged_attention_kernel(*args, **kw))
        res = {"phase": phase, "case": name,
               "q": str(case["q"].dtype).replace("torch.", ""),
               "pages": str(case["k_pages"].dtype).replace("torch.", ""),
               "rows": int(case["q"].shape[0]),
               "real_rows": int(real.sum()),
               "heads": int(case["q"].shape[1]),
               "kv_heads": int(case["k_pages"].shape[2]),
               "head_dim": int(case["q"].shape[2]),
               **rc.check(case, got),
               "ms": device_ms(lambda: ragged_paged_attention_kernel(
                   *args, **kw), reps=30, what=f"{name} kernel")
               if profiled else host_ms,
               "timer": "profiler" if profiled else "events",
               "host_ms": host_ms,
               "plain_ms": time_ms(
                   lambda: ragged_paged_attention_reference(*args, **kw),
                   reps=3, warmup=1),
               "library_ms": None}
        res.update(rc.roofline(case))
        emit(res)
        if not res["within_tolerance"]:
            raise AssertionError(f"kernel case {name} outside tolerance: "
                                 f"max abs err {res['max_abs_err']}")
        results.append(res)
    return results


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def check_against_reference(model, prompts, outputs,
                            new_tokens: int = NEW_TOKENS,
                            what: str = "serve") -> list:
    """Every request's tokens against the port's non-paged greedy oracle
    on the card.  A mismatch passes only as a near tie: the oracle's
    top-two logit gap at the first differing position under 1e-3 of its
    top logit (f32 sums taken in another order can flip such a tie)."""
    from paddle_tpu_torch.serving import greedy_decode_reference, \
        reference_logits

    ties = []
    for i, (prompt, got) in enumerate(zip(prompts, outputs)):
        want = greedy_decode_reference(model, prompt, new_tokens, NO_EOS)
        if got == want:
            continue
        j = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
        logits = reference_logits(model, prompt + want[:j])
        top2 = np.sort(logits)[-2:]
        gap, top = float(top2[1] - top2[0]), float(top2[1])
        tie = {"phase": what, "request": i, "first_diff": j,
               "top_logit": top, "top2_gap": gap,
               "near_tie": gap < 1e-3 * abs(top)}
        emit(tie)
        if not tie["near_tie"]:
            raise AssertionError(f"request {i} differs from the greedy "
                                 f"reference at token {j} (gap {gap})")
        ties.append(tie)
    return ties


def serve(model, dev) -> dict:
    from paddle_tpu_torch.serving.decode_attention import \
        ragged_paged_attention_kernel as kernel

    warm_up(model, dev)
    eng = make_engine(model, dev)
    step_ms = {True: [], False: []}     # by "carried prefill rows"

    torch.cuda.synchronize()
    kernel.launches = 0
    t0 = time.perf_counter()
    wl = Workload(eng)
    while not wl.done:
        rows, steps = eng.metrics.prefill_rows, eng.metrics.step_dispatches
        t = time.perf_counter()
        wl.step()                       # ends in the logits' host copy
        if eng.metrics.step_dispatches > steps:
            step_ms[eng.metrics.prefill_rows > rows].append(
                1e3 * (time.perf_counter() - t))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.launches
    eng.check_page_conservation()
    m = eng.metrics
    outputs = [eng.result(r) for r in wl.rids]
    done = all(o is not None and len(o) == NEW_TOKENS for o in outputs)
    res = {"phase": "serve", "requests": len(wl.rids),
           "completed": m.completed,
           "drained": not eng.has_work and done,
           "conservation": eng.healthz()["ok"], "ticks": m.ticks,
           "steps": m.step_dispatches, "kernel_launches": launches,
           "launches_expected": MODEL["num_layers"] * m.step_dispatches,
           "tokens_per_s": m.tokens_per_s(), "wall_s": wall,
           "ttft_ms_mean": m.ttft_ms_mean(), "ttft_ms_p95": m.ttft_ms_p95(),
           "prefix_hits": eng.cache.hits,
           "prefill_tokens_saved": m.prefill_tokens_saved,
           "prefill_tokens": m.prefill_tokens,
           "prefill_steps": len(step_ms[True]),
           "prefill_step_ms_mean": float(np.mean(step_ms[True])),
           "decode_steps": len(step_ms[False]),
           "decode_step_ms_median": float(np.median(step_ms[False]))}
    emit(res)
    if not res["drained"] or not res["conservation"]:
        raise AssertionError("serve did not drain cleanly")
    if launches != res["launches_expected"] or launches == 0:
        raise AssertionError(f"kernel launches {launches} != layers x "
                             f"steps {res['launches_expected']}")
    if res["prefix_hits"] < 1 or res["prefill_tokens_saved"] < PREFIX_LEN:
        raise AssertionError("the shared prefix was not served from cache")
    t1 = time.perf_counter()
    ties = check_against_reference(model, wl.prompts, outputs)
    emit({"phase": "serve_reference", "requests": len(wl.prompts),
          "identical": len(wl.prompts) - len(ties), "near_ties": len(ties),
          "seconds": time.perf_counter() - t1})
    # the one-process tokens the tensor-parallel serve is held against
    return dict(res, outputs=outputs, prompts=list(wl.prompts))


def serve_int8(model, dev) -> dict:
    from paddle_tpu_torch.serving import check_quant_drift
    from paddle_tpu_torch.serving.decode_attention import \
        ragged_paged_attention_kernel as kernel

    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(2, MODEL["vocab_size"], n).tolist()
               for n in (100, 300, 520, 64)]
    eng = make_engine(model, dev, kv_dtype="int8")
    kernel.launches = 0
    rids = [eng.submit(p, max_tokens=8) for p in prompts]
    eng.run()
    launches = kernel.launches
    outputs = [eng.result(r) for r in rids]
    case = rc.build_case(np.random.default_rng(SEED), rc.MIXED_SEQS, H, dev)
    drift = check_quant_drift(*rc.args(case))
    res = {"phase": "serve_int8", "requests": len(rids),
           "completed": eng.metrics.completed,
           "drained": not eng.has_work and all(
               o is not None and len(o) == 8 for o in outputs),
           "conservation": eng.healthz()["ok"],
           "kernel_launches": launches,
           "launches_expected": MODEL["num_layers"] *
           eng.metrics.step_dispatches,
           "kv_bytes": eng.kv_cfg.kv_bytes(), "quant_drift": drift}
    emit(res)
    if not (res["drained"] and res["conservation"]) or \
            launches != res["launches_expected"]:
        raise AssertionError("int8 serve failed")
    return res


SMALL_SERVE_TOKENS = 16


def serve_checked(model, dev, prompts, **fields) -> dict:
    """``prompts`` served on the card at the engine's flag defaults
    (``SMALL_SERVE_TOKENS`` new tokens each): the run drains with pages
    conserved, the ragged kernel launched once a layer a step, tokens
    equal to the greedy oracle (near ties as in the full-width serve).
    ``fields`` go into the result line."""
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.decode_attention import \
        ragged_paged_attention_kernel as kernel

    eng = ServingEngine(model, eos_id=NO_EOS, num_pages=33,
                        max_pages_per_seq=8, device=dev)
    kernel.launches = 0
    rids = [eng.submit(p, max_tokens=SMALL_SERVE_TOKENS) for p in prompts]
    eng.run()
    launches = kernel.launches
    outputs = [eng.result(r) for r in rids]
    ties = check_against_reference(model, prompts, outputs,
                                   SMALL_SERVE_TOKENS)
    res = {**fields, "head_dim": model.head_dim, "heads": model.num_heads,
           "layers": model.num_layers,
           "pool_head_dim": int(eng.kv_cfg.pool_head_dim),
           "requests": len(rids),
           "drained": not eng.has_work and all(
               o is not None and len(o) == SMALL_SERVE_TOKENS
               for o in outputs),
           "conservation": eng.healthz()["ok"],
           "kernel_launches": launches,
           "launches_expected": model.num_layers *
           eng.metrics.step_dispatches,
           "identical": len(prompts) - len(ties), "near_ties": len(ties)}
    emit(res)
    if not (res["drained"] and res["conservation"]) or launches == 0 \
            or launches != res["launches_expected"]:
        raise AssertionError(f"the serve of {fields} failed")
    return res


def serve_small(dev) -> list:
    """``DecoderLM`` at its defaults (2 layers, 2 heads of head_dim 16)
    with the serve workload's vocabulary, in f32 and in bf16, each served
    by :func:`serve_checked`: 4 requests of 16 new tokens."""
    from paddle_tpu_torch.convert import decoder_lm_from_numpy, \
        init_numpy_params
    from paddle_tpu_torch.serving import DecoderLM

    rng = np.random.default_rng(SEED + 3)
    prompts = [rng.integers(2, MODEL["vocab_size"], n).tolist()
               for n in (40, 300, 7, 130)]
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        model = DecoderLM(vocab_size=MODEL["vocab_size"], device=dev,
                          dtype=dtype)
        decoder_lm_from_numpy(init_numpy_params(model, SEED), model)
        out.append(serve_checked(model, dev, prompts, phase="serve_small",
                                 dtype=str(dtype).replace("torch.", "")))
    return out


# ---------------------------------------------------------------------------
# the serving engine's upper tier: speculation, the host tier, obs, cli
# ---------------------------------------------------------------------------

def same_streams(model, prompts, got, want, what: str) -> int:
    """``got`` token-identical to ``want`` (the same engine without
    speculation); a stream may differ only after a near tie: the
    oracle's top-two gap at the first differing position under 1e-3 of
    its top logit (f32 sums taken in another order can flip such a
    tie).  Returns the number of near-tie streams."""
    from paddle_tpu_torch.serving import reference_logits

    ties = 0
    for i, (prompt, g, w) in enumerate(zip(prompts, got, want)):
        j = spw.first_difference(g, w)
        if j is None:
            continue
        top2 = np.sort(reference_logits(model, prompt + w[:j]))[-2:]
        gap, top = float(top2[1] - top2[0]), float(top2[1])
        near = gap < 1e-3 * abs(top)
        emit({"phase": what, "request": i, "first_diff": j,
              "top_logit": top, "top2_gap": gap, "near_tie": near})
        if not near:
            raise AssertionError(f"{what}: request {i} differs from the "
                                 f"engine without speculation at token {j}")
        ties += 1
    return ties


def _spec_line(phase: str, r: dict, off: dict, **extra) -> dict:
    snap = r["snapshot"]
    return {"phase": phase, "requests": len(r["outputs"]),
            "completed": r["completed"], "ticks": r["ticks"],
            "ticks_spec_off": off["ticks"], "steps": r["steps"],
            "tokens_per_s": r["tokens_per_s"],
            "tokens_per_s_spec_off": off["tokens_per_s"],
            "wall_s": r["wall_s"], "wall_s_spec_off": off["wall_s"],
            "proposed": snap["spec_tokens_proposed"],
            "accepted": snap["spec_tokens_accepted"],
            "acceptance_rate": snap["spec_acceptance_rate"],
            "rollbacks": snap["spec_rollbacks"],
            "suspended": snap["spec_suspended"],
            "kernel_launches": r["launches"], **extra}


def serve_spec_ngram(model, dev) -> dict:
    """The spec traffic without speculation, then with n-gram speculation
    (k 4, n 3): token-identical streams, pages conserved, proposed and
    accepted non-zero, B4 launched once a layer a step."""
    prompts = spw.spec_prompts()
    off = spw.drive(make_engine(model, dev), prompts)
    eng = make_engine(model, dev, spec_mode="ngram", spec_k=spw.SPEC_K,
                      spec_ngram=spw.SPEC_NGRAM)
    r = spw.drive(eng, prompts)
    eng.check_page_conservation()
    ties = same_streams(model, prompts, r["outputs"], off["outputs"],
                        "serve_spec_ngram")
    res = _spec_line("serve_spec_ngram", r, off, near_ties=ties,
                     launches_expected=MODEL["num_layers"] * r["steps"],
                     conservation=eng.healthz()["ok"])
    emit(res)
    if not (r["completed"] and off["completed"] and res["conservation"]):
        raise AssertionError("serve_spec_ngram did not drain cleanly")
    if res["proposed"] == 0 or res["accepted"] == 0:
        raise AssertionError("serve_spec_ngram: nothing proposed or "
                             "accepted")
    if r["launches"] != res["launches_expected"]:
        raise AssertionError(f"serve_spec_ngram: {r['launches']} launches "
                             f"!= layers x steps {res['launches_expected']}")
    return {"off": off, "ngram": r, "prompts": prompts}


def serve_spec_draft(model, dev, spec: dict) -> list:
    """Draft-model speculation (k 4): the 2-layer d-1024 draft with its own
    seeded weights and pool, then the target itself as the draft.  Gates
    as n-gram's, and the draft pool conserved; B4 launched once a layer a
    step of the target and of the draft."""
    prompts, off = spec["prompts"], spec["off"]
    draft, draft_params = spw.build_draft(dev)
    out = []
    for name, dm, dp in (("own_weights", draft, draft_params),
                         ("target_weights", model, model)):
        eng = make_engine(model, dev, spec_mode="draft", spec_k=spw.SPEC_K,
                          draft_model=dm, draft_params=dp)
        r = spw.drive(eng, prompts)
        eng.check_page_conservation()        # the draft pool's too
        ties = same_streams(model, prompts, r["outputs"], off["outputs"],
                            "serve_spec_draft")
        prop = eng._proposer
        expected = (MODEL["num_layers"] * r["steps"] +
                    dm.num_layers * prop.steps)
        res = _spec_line("serve_spec_draft", r, off, draft=name,
                         draft_layers=dm.num_layers,
                         draft_d=dm.embed_dim, draft_steps=prop.steps,
                         draft_step_time_s=prop.step_time_s,
                         draft_pool_refs=prop.pool.total_refs,
                         near_ties=ties, launches_expected=expected,
                         conservation=eng.healthz()["ok"])
        emit(res)
        if not (r["completed"] and res["conservation"]) or \
                prop.pool.total_refs != 0:
            raise AssertionError(f"serve_spec_draft ({name}) did not "
                                 "drain cleanly")
        if res["proposed"] == 0 or r["launches"] != expected:
            raise AssertionError(f"serve_spec_draft ({name}): proposed "
                                 f"{res['proposed']}, launches "
                                 f"{r['launches']} != {expected}")
        # random, independent weights agree on a token about once in
        # 32768; the target as its own draft accepts what it drafts
        if name == "target_weights" and res["acceptance_rate"] < 0.9:
            raise AssertionError("the target as its own draft accepted "
                                 f"{res['acceptance_rate']}")
        del eng
        out.append(res)
    return out


def serve_sampled_spec(model, dev, spec: dict) -> dict:
    """Sampled decoding (temperature 0.8, top-p 0.95, a seed a request)
    with n-gram speculation, twice: the same tokens bit for bit
    (``spw.SAMPLED_TOKENS`` a request: each emission warps 32768 logits
    on the host in float64)."""
    from paddle_tpu_torch.serving import SamplingParams

    prompts = spec["prompts"]

    def sampling(i):
        return SamplingParams(seed=1000 + i, **spw.SAMPLING)

    runs = [spw.drive(make_engine(model, dev, spec_mode="ngram",
                                  spec_k=spw.SPEC_K,
                                  spec_ngram=spw.SPEC_NGRAM),
                      prompts, spw.SAMPLED_TOKENS, sampling)
            for _ in range(2)]
    res = _spec_line("serve_sampled_spec", runs[0], spec["off"],
                     replays_identical=runs[0]["outputs"] ==
                     runs[1]["outputs"],
                     differs_from_greedy=[o[:spw.SAMPLED_TOKENS] for o in
                                          runs[0]["outputs"]] !=
                     [o[:spw.SAMPLED_TOKENS] for o in
                      spec["ngram"]["outputs"]],
                     wall_s_replay=runs[1]["wall_s"])
    emit(res)
    if not (res["replays_identical"] and res["differs_from_greedy"] and
            all(r["completed"] for r in runs)):
        raise AssertionError("serve_sampled_spec: replays differ, or the "
                             "draws were not sampled")
    return res


def obs_trace(model, dev, spec: dict) -> dict:
    """The n-gram drive again with a Tracer and a registry: the same
    tokens; its Chrome trace written through ``obs.export`` and its
    events read back by ``load_events``; the expected spans present; the
    registry's exposition holds the spec and host-tier series."""
    import os
    import shutil
    import tempfile

    from paddle_tpu_torch import obs

    reg = obs.MetricsRegistry()
    tracer = obs.Tracer(registry=reg)
    eng = make_engine(model, dev, spec_mode="ngram", spec_k=spw.SPEC_K,
                      spec_ngram=spw.SPEC_NGRAM, tracer=tracer,
                      registry=reg)
    r = spw.drive(eng, spec["prompts"])
    hz = eng.healthz()
    tmp = tempfile.mkdtemp(prefix="obs_trace_")
    try:
        raw = tracer.save(os.path.join(tmp, "events.jsonl"))
        back = obs.load_events(raw)
        chrome = os.path.join(tmp, "trace.json")
        obs.save_chrome_trace(back, chrome)
        with open(chrome) as f:
            trace = json.load(f)
        chrome_bytes = os.path.getsize(chrome)
    finally:
        shutil.rmtree(tmp)
    names = {e.name for e in back}
    text = reg.to_text()
    res = {"phase": "obs_trace", "events": len(tracer.events),
           "events_read_back": len(back),
           "chrome_events": len(trace["traceEvents"]),
           "chrome_bytes": chrome_bytes,
           "missing_names": sorted(set(spw.TRACE_NAMES) - names),
           "same_tokens": r["outputs"] == spec["ngram"]["outputs"],
           "wall_s": r["wall_s"],
           "wall_s_untraced": spec["ngram"]["wall_s"],
           "exposition_lines": len(text.splitlines()),
           "series": {k: hz["metrics"].get(k) for k in (
               "serving_spec_tokens_proposed",
               "serving_spec_tokens_accepted", "serving_host_swap_ins",
               "serving_pages_host")}}
    emit(res)
    if res["missing_names"] or len(back) != len(tracer.events) or \
            not res["same_tokens"] or not hz["ok"] or \
            not all(f"serving_{k}" in text for k in (
                "spec_tokens_proposed", "spec_acceptance_rate",
                "host_swap_ins", "host_corrupt")):
        raise AssertionError(f"obs_trace failed: {res}")
    return res


def serve_host_tier(model, dev) -> list:
    """A 12-usable-page pool whose prefix pages are evicted to a host tier
    of 32 pages (512 MiB at this width), under 'stored' and 'int8', and
    once with one byte of the first prefix block flipped on the host after
    its commit: swap-ins > 0, 'stored' token-identical to a cold
    re-prefill and bit-identical K/V, 'int8' K/V within half a
    quantization step of the evicted pages, the corrupted page caught and
    served as a miss with the cold tokens; the tier's ledger clean."""
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.decode_attention import \
        ragged_paged_attention_kernel as kernel

    first, fillers, sharer = spw.host_prompts(MODEL["vocab_size"])

    def engine(**kw):
        return ServingEngine(model, eos_id=NO_EOS,
                             num_pages=spw.HOST_POOL_PAGES,
                             max_pages_per_seq=8, max_slots=2,
                             use_kernel=True, device=dev, **kw)

    cold = engine(prefix_cache=False)
    rc_ = cold.submit(sharer, max_tokens=spw.HOST_NEW_TOKENS)
    cold.run()
    want = cold.result(rc_)
    page_bytes = cold.kv_cfg.bytes_per_page()
    del cold
    out = []
    for fmt, corrupt in (("stored", False), ("int8", False),
                         ("stored", True)):
        eng = engine(host_tier_bytes=spw.HOST_PAGES * page_bytes,
                     host_kv_dtype=fmt)
        kernel.launches = 0
        t0 = time.perf_counter()
        r = spw.host_tier_drive(eng, first, fillers, sharer,
                                corrupt=corrupt)
        torch.cuda.synchronize()
        snap = r["snapshot"]
        eng.host_tier.check()
        res = {"phase": "serve_host_tier", "host_kv_dtype": fmt,
               "corrupted": corrupt,
               "host_tier_bytes": spw.HOST_PAGES * page_bytes,
               "page_bytes": page_bytes, **snap,
               "host_hits": r["host_hits"],
               "swapped_pages": r["swapped_pages"],
               "same_tokens_as_cold": r["sharer"] == want,
               "kernel_launches": kernel.launches,
               "launches_expected": MODEL["num_layers"] *
               eng.metrics.step_dispatches,
               "wall_s": time.perf_counter() - t0}
        if r["after"] is not None and fmt == "stored":
            res["kv_bit_identical"] = all(
                torch.equal(a, b) for a, b in zip(r["before"], r["after"])
                if a is not None)
        elif r["after"] is not None:
            res.update(spw.int8_page_error(r["before"], r["after"]))
        emit(res)
        if res["kernel_launches"] != res["launches_expected"]:
            raise AssertionError("serve_host_tier: launches")
        if corrupt:
            ok = snap["host_corrupt"] >= 1 and res["same_tokens_as_cold"] \
                and r["swapped_pages"] == 0
        elif fmt == "stored":
            ok = snap["host_swap_ins"] > 0 and res["same_tokens_as_cold"] \
                and res.get("kv_bit_identical", False)
        else:
            ok = snap["host_swap_ins"] > 0 and \
                res.get("max_err_in_steps", 1.0) <= spw.INT8_STEP_BOUND
        if not ok:
            raise AssertionError(f"serve_host_tier failed: {res}")
        del eng
        out.append(res)
    return out


# ---------------------------------------------------------------------------
# the fleet: routing, kills, the page-migration plane, the gates
# ---------------------------------------------------------------------------

def _fleet_run(model, dev, traffic, phase: str, drive: str, **kw) -> dict:
    """One drive of ``traffic`` through a fleet of ``fw.REPLICAS``
    engines sharing ``model`` (``fw.build_fleet(**kw)``): every request
    terminal, no duplicate completion, conservation on every pool (the
    drain's check), every dead replica's pool released, B4 once a layer a
    step of every replica, and the drive's ledger (ticks, steps, TTFT p95
    on the injected clock, routing, kill and migration counters) equal to
    ``fw.LEDGERS[drive]``, which the CPU drive holds too.  Each
    ``on_token`` stream is held to its result under the near-tie rule (a
    kill's replay may stitch onto prefix pages cached on the survivor
    where the first attempt prefilled whole)."""
    from paddle_tpu_torch.serving.decode_attention import \
        ragged_paged_attention_kernel as kernel

    fleet = fw.build_fleet(model, dev, **kw)
    torch.cuda.synchronize()
    kernel.launches = 0
    out = fw.run(fleet, traffic)
    torch.cuda.synchronize()
    launches = kernel.launches
    steps = sum(r.engine.metrics.step_dispatches for r in fleet.replicas)
    snap = out["snapshot"]
    dead = [r.idx for r in fleet.replicas if str(r.state) == "dead"]
    res = {"phase": phase, "drive": drive,
           **{k: v for k, v in kw.items() if k != "kill_at"},
           "kill_at": {str(t): i for t, i in (kw.get("kill_at") or {}
                                              ).items()},
           "requests": len(traffic), "ticks": out["ticks"],
           "wall_s": out["wall_s"], "tokens": out["tokens"],
           "tokens_per_s_host": out["tokens"] / out["wall_s"],
           "ttft_ms_p95_clock": 1e3 * float(np.percentile(out["ttft_s"],
                                                           95)),
           "ttft_ms_mean_clock": 1e3 * float(np.mean(out["ttft_s"])),
           "statuses": sorted(set(out["status"])),
           "dead_pools_released": all(fleet.replicas[i].engine._kv is None
                                      for i in dead),
           "kernel_launches": launches,
           "launches_expected": MODEL["num_layers"] * steps,
           **{k.replace("fleet_", ""): snap[k] for k in (
               "fleet_completed", "fleet_resubmits",
               "fleet_duplicate_completions", "fleet_prefix_hit_rate",
               "fleet_affinity_hits", "fleet_replicas_dead",
               "fleet_migrations_started", "fleet_migrations_applied",
               "fleet_migration_fallbacks", "fleet_migrations_aborted",
               "fleet_pages_migrated", "fleet_migration_bytes",
               "fleet_cross_replica_seeds", "fleet_migration_resubmits")}}
    if fleet._disagg:
        from paddle_tpu_torch.serving import check_migration_conservation

        check_migration_conservation(fleet)
        res["migration_conservation"] = True
    res["stream_near_ties"] = same_streams(
        model, out["prompts"], out["streams"], out["results"],
        f"{phase}_stream")
    res["ledger"] = out["ledger"]
    res["ledger_as_expected"] = out["ledger"] == fw.LEDGERS[drive]
    emit(res)
    if res["statuses"] != ["completed"] or res["completed"] != len(traffic) \
            or res["duplicate_completions"] or not res["dead_pools_released"]:
        raise AssertionError(f"{phase}: {res}")
    if not res["ledger_as_expected"]:
        raise AssertionError(f"{phase} {drive}: ledger {out['ledger']}, "
                             f"expected {fw.LEDGERS[drive]}")
    if launches == 0 or launches != res["launches_expected"]:
        raise AssertionError(f"{phase}: B4 launched {launches} times, "
                             f"layers x steps {res['launches_expected']}")
    res["outputs"], res["prompts"] = out["results"], out["prompts"]
    res["resubmitted"] = [i for i, f in enumerate(out["frids"])
                          if fleet._requests[f].resubmits]
    del fleet
    torch.cuda.empty_cache()
    return res


def _line(res: dict) -> dict:
    return {k: v for k, v in res.items()
            if k not in ("outputs", "prompts", "resubmitted")}


def serve_fleet(model, dev) -> dict:
    """``fw.fleet_traffic`` (6 tenants' 512-token system prompts, 24
    requests at 50/s on the fleet clock) over 4 replicas with replica 0
    killed at tick 25, routed by prefix affinity and by round robin:
    each drive as :func:`_fleet_run`, the completed outputs equal across
    the two policies under the near-tie rule, affinity's prefix hit rate
    at least round robin's; and a sample of affinity's outputs (every
    request the kill resubmitted, and every sixth) held against the
    non-paged greedy oracle under the same rule."""
    runs = {r: _fleet_run(model, dev, fw.fleet_traffic(), "serve_fleet",
                          f"fleet_{r}", routing=r, kill_at=fw.KILL_AT)
            for r in ("affinity", "round_robin")}
    a, b = runs["affinity"], runs["round_robin"]
    ties = same_streams(model, a["prompts"], a["outputs"], b["outputs"],
                        "serve_fleet_policies")
    sample = sorted(set(a["resubmitted"]) | set(range(0, len(a["outputs"]),
                                                      6)))
    oracle = check_against_reference(
        model, [a["prompts"][i] for i in sample],
        [a["outputs"][i] for i in sample], fw.NEW_TOKENS,
        "serve_fleet_oracle")
    res = {"phase": "serve_fleet_summary", "policy_near_ties": ties,
           "oracle_requests": sample, "oracle_near_ties": len(oracle),
           "prefix_hit_rate": {k: v["prefix_hit_rate"]
                               for k, v in runs.items()},
           "launches": sum(v["kernel_launches"] for v in runs.values())}
    emit(res)
    if a["prefix_hit_rate"] < b["prefix_hit_rate"] or \
            not a["resubmitted"]:
        raise AssertionError(f"serve_fleet: {res}")
    return {**res, "runs": {k: _line(v) for k, v in runs.items()}}


def serve_disagg(model, dev) -> dict:
    """``fw.disagg_traffic`` (70% on one hot 512-token prompt, 24
    requests at 60/s) over 4 unified replicas, then over 2 prefill + 2
    decode replicas with ``migrate_budget`` 16: chain migrations applied,
    the migration ledger balanced, outputs equal to the unified fleet's
    under the near-tie rule; then the disaggregated drive on int8 pools
    (migration bytes a request at most 0.35 of f32's: (D + 4) / 4D =
    0.2578 at D 128) and with decode replica 3 killed at tick 13 (death
    resubmits re-adopt prefix pages from a surviving replica), whose
    outputs are held to the unified fleet's under the near-tie rule."""
    tr = fw.disagg_traffic()
    uni = _fleet_run(model, dev, tr, "serve_disagg", "disagg_unified",
                     routing="affinity")
    dis = _fleet_run(model, dev, tr, "serve_disagg", "disagg_roles",
                     roles=fw.ROLES)
    ties = same_streams(model, uni["prompts"], dis["outputs"],
                        uni["outputs"], "serve_disagg_vs_unified")
    i8 = _fleet_run(model, dev, tr, "serve_disagg", "disagg_int8",
                    roles=fw.ROLES, kv_dtype="int8")
    kill = _fleet_run(model, dev, tr, "serve_disagg", "disagg_kill",
                      roles=fw.ROLES, kill_at=fw.DISAGG_KILL_AT)
    kill_ties = same_streams(model, uni["prompts"], kill["outputs"],
                             uni["outputs"], "serve_disagg_kill_vs_unified")
    def per_request(r):
        return r["migration_bytes"] / max(1, r["migrations_applied"])

    ratio = per_request(i8) / per_request(dis)
    d = MODEL["head_dim"]
    res = {"phase": "serve_disagg_summary", "unified_near_ties": ties,
           "kill_near_ties": kill_ties,
           "migrations_applied": dis["migrations_applied"],
           "int8_bytes_ratio": ratio,
           "int8_bytes_ratio_expected": (d + 4) / (4 * d),
           "kill_migration_resubmits": kill["migration_resubmits"],
           "launches": sum(r["kernel_launches"]
                           for r in (uni, dis, i8, kill))}
    emit(res)
    if dis["migrations_applied"] == 0 or ratio > 0.35 or \
            kill["migration_resubmits"] == 0:
        raise AssertionError(f"serve_disagg: {res}")
    return {**res, "runs": [_line(r) for r in (uni, dis, i8, kill)]}


def _raw_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(-1).view(torch.uint8)


def migrate_kernel(model, dev) -> dict:
    """One live chain exported from a CUDA engine and imported into a
    second, for f32, bf16 and int8 pools: B4 launched over the imported
    pages right after the import (no synchronize between: the uploads
    are ordered on the stream), held against the plain version on the
    same inputs (``ragged_cases.check``) and timed between CUDA events;
    the pages read back bit-identical to the blob's; the destination
    then finishes the request with pages conserved."""
    from paddle_tpu_torch.serving import (BLOCK_ROWS, ServingEngine,
                                          export_chain, import_chain)
    from paddle_tpu_torch.serving.decode_attention import (
        ragged_paged_attention_kernel as kernel,
        ragged_paged_attention_reference as plain)
    from paddle_tpu_torch.serving.kv_cache import NULL_PAGE, read_pages

    rng = np.random.default_rng(SEED + 72)
    prompt = rng.integers(2, MODEL["vocab_size"], 700).tolist()
    gen = torch.Generator(device=dev).manual_seed(SEED + 72)
    out = {}
    for kv in ("float32", "bfloat16", "int8"):
        def engine():
            return ServingEngine(model, eos_id=NO_EOS, num_pages=17,
                                 max_pages_per_seq=8, max_slots=2,
                                 kv_dtype=kv, use_kernel=True, device=dev)
        src, dst = engine(), engine()
        rid = src.submit(prompt, max_tokens=12)
        while rid not in src.migratable_rids():
            src.step()
        src.step()
        blob = export_chain(src, rid)
        src.cancel(rid)
        rid2 = import_chain(dst, blob)
        req = dst._requests[rid2]
        n = req.cache_len
        table = torch.full((1, 8), NULL_PAGE, dtype=torch.int32)
        table[0, :len(req.pages)] = torch.tensor(req.pages)
        case = {"q": torch.randn((BLOCK_ROWS, MODEL["num_heads"],
                                  MODEL["head_dim"]), generator=gen,
                                 device=dev),
                "k_pages": dst._kv.k[0], "v_pages": dst._kv.v[0],
                "page_table": table.to(dev),
                "kv_lens": torch.tensor([n], dtype=torch.int32, device=dev),
                "row_seq": torch.zeros(BLOCK_ROWS, dtype=torch.int32,
                                       device=dev),
                "qpos": torch.arange(n - BLOCK_ROWS, n, dtype=torch.int32,
                                     device=dev)}
        if dst._kv.quantized:
            case["k_scale"], case["v_scale"] = (dst._kv.k_scale[0],
                                                dst._kv.v_scale[0])
        got = kernel(*rc.args(case), **rc.scales(case))   # right after
        torch.cuda.synchronize()
        res = {"phase": "migrate_kernel", "kv_dtype": kv,
               "pages": blob.num_pages, "tokens": n,
               "blob_bytes": blob.nbytes,
               "pool_head_dim": blob.pool_head_dim,
               **rc.check(case, got), **rc.roofline(case),
               "ms": time_ms(lambda: kernel(*rc.args(case),
                                            **rc.scales(case))),
               "timer": "events",
               "plain_ms": time_ms(lambda: plain(*rc.args(case),
                                                 **rc.scales(case)),
                                   reps=3, warmup=1)}
        back = read_pages(dst._kv, req.pages[:blob.num_pages])
        res["pages_bit_identical"] = all(
            torch.equal(_raw_bytes(a), _raw_bytes(b))
            for a, b in zip(back, (blob.k, blob.v, blob.k_scale,
                                   blob.v_scale)) if b is not None)
        dst.run()
        src.run()
        res["drained"] = dst.result(rid2) is not None and \
            len(dst.result(rid2)) == 12 and dst.healthz()["ok"] and \
            src.healthz()["ok"]
        emit(res)
        if not (res["within_tolerance"] and res["pages_bit_identical"]
                and res["drained"]):
            raise AssertionError(f"migrate_kernel {kv}: {res}")
        out[kv] = res
        del src, dst, case, got, blob
    torch.cuda.empty_cache()
    return out


def fleet_checks(dev) -> list:
    """The fleet slice's standalone gates on the card at the JAX
    package's widths (vocab 64, one layer, two heads of 8, page 4): the
    fleet, migrate, control and kv_cache ``main(["check"])`` and
    ``obs.cli.seeded_chaos``; each exits 0."""
    import contextlib
    import io

    from paddle_tpu_torch.obs.cli import seeded_chaos
    from paddle_tpu_torch.serving import control, fleet, kv_cache, migrate

    out = []
    for mod in (fleet, migrate, control, kv_cache):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc_ = mod.main(["check", "--device", torch.device(dev).type])
        res = {"phase": "fleet_checks", "gate": mod.__name__, "exit": rc_,
               "output": buf.getvalue().strip(),
               "seconds": time.perf_counter() - t0}
        emit(res)
        if rc_ != 0:
            raise AssertionError(f"{mod.__name__} check: {res}")
        out.append(res)
    t0 = time.perf_counter()
    tracer, fl, frids = seeded_chaos(device=dev)
    snap = fl.snapshot()
    res = {"phase": "fleet_checks", "gate": "obs.cli.seeded_chaos",
           "events": len(tracer.events),
           "completed": snap["fleet_completed"], "requests": len(frids),
           "resubmits": snap["fleet_resubmits"],
           "replicas_dead": snap["fleet_replicas_dead"],
           "seconds": time.perf_counter() - t0}
    emit(res)
    if res["completed"] != len(frids) or snap["fleet_duplicate_completions"]:
        raise AssertionError(f"seeded_chaos: {res}")
    out.append(res)
    return out


CLI_CONFIG = """
import numpy as np
import paddle_tpu_torch as paddle
from paddle_tpu_torch import layer, optimizer

x = layer.data(name="x", type=paddle.data_type.dense_vector(8))
y = layer.data(name="y", type=paddle.data_type.integer_value(3))
hidden = layer.fc(x, size=16, act="relu", name="hidden")
logits = layer.fc(hidden, size=3, name="logits")
cost = layer.classification_cost(input=logits, label=y)
optimizer = optimizer.Sgd(learning_rate=0.1)
batch_size = 16

_rng = np.random.RandomState(0)
_data = []
for _ in range(64):
    _y = int(_rng.randint(0, 3))
    _x = (_rng.randn(8) * 0.2).astype(np.float32)
    _x[_y * 2] += 1.0
    _data.append((_x, _y))


def reader():
    return iter(_data)
"""


def cli_phase() -> dict:
    """``python -m paddle_tpu_torch train`` on a small config for one pass
    on the card (its parameters written to a tar), then in this process
    ``train --job=test`` over that tar, ``dump_config`` and ``version``:
    exit codes 0, and 2 for a config without a reader."""
    import contextlib
    import io
    import os
    import pathlib
    import shutil
    import tempfile

    from paddle_tpu_torch import cli

    tmp = tempfile.mkdtemp(prefix="cli_")
    root = str(pathlib.Path(__file__).resolve().parent)
    try:
        conf = os.path.join(tmp, "conf.py")
        with open(conf, "w") as f:
            f.write(CLI_CONFIG)
        noreader = os.path.join(tmp, "noreader.py")
        with open(noreader, "w") as f:
            f.write(CLI_CONFIG.replace("def reader():", "def _unused():"))
        tar = os.path.join(tmp, "model.tar")
        t0 = time.perf_counter()
        env = dict(os.environ,
                   PYTHONPATH=root + os.pathsep +
                   os.environ.get("PYTHONPATH", ""))
        proc = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch", "train", "--config",
             conf, "--num_passes", "1", "--model_tar", tar],
            cwd=root, env=env, capture_output=True, text=True, timeout=300)
        train_s = time.perf_counter() - t0
        codes = {"train": proc.returncode}
        outs = {}
        for name, argv in (
                ("test", ["train", "--config", conf, "--job", "test",
                          "--init_model_tar", tar]),
                ("dump_config", ["dump_config", "--config", conf]),
                ("version", ["version"]),
                ("no_reader", ["train", "--config", noreader])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), \
                    contextlib.redirect_stderr(io.StringIO()):
                codes[name] = cli.main(argv)
            outs[name] = buf.getvalue()
    finally:
        shutil.rmtree(tmp)
    res = {"phase": "cli", "exit_codes": codes, "train_s": train_s,
           "test": outs["test"].strip(), "version": outs["version"].strip(),
           "dump_config_layers": len(json.loads(outs["dump_config"])
                                     ["layers"]),
           "train_stderr_tail": proc.stderr[-400:] if proc.returncode
           else ""}
    emit(res)
    want = {"train": 0, "test": 0, "dump_config": 0, "version": 0,
            "no_reader": 2}
    if codes != want or "Test cost=" not in res["test"] or \
            "CUDA" not in res["version"]:
        raise AssertionError(f"cli failed: {res}")
    return res


# ---------------------------------------------------------------------------
# flash attention kernels
# ---------------------------------------------------------------------------

FLASH_KERNELS = ("flash_fwd", "flash_bwd_kv", "flash_bwd_dq")
# the mangled name of each kernel that case a runs, in ptxas's report
FLASH_PTXAS = {"flash_fwd": "flash_fwd_wgmma_kernelILi128",
               "flash_bwd_kv": "flash_bwd_kv_wgmma_kernelILi128",
               "flash_bwd_dq": "flash_bwd_dq_wgmma_kernelILi128"}
LIBRARY_KEYS = ("library_fwd_ms", "library_bwd_ms", "library_fwd_bwd_ms")


def ptxas_of(source: str, kernel: str):
    """ptxas's registers and spills of the kernel of ``csrc/<source>.cu``
    whose mangled name holds ``kernel``, or None."""
    from paddle_tpu_torch.kernels import build

    found = [v for k, v in build.ptxas_report(source).items() if kernel in k]
    return found[0] if found else None


def flash_bound(case, which: str) -> dict:
    """Least time for one flash function on ``case``: each input read once
    and each output written once (q, k, v, dO in their type; segment ids,
    lse and delta in 4 bytes), and the products of the (query, key) pairs
    the mask keeps, 2 flops a multiply-add — forward QK^T and PV (4 x
    pairs x D), dK/dV the recomputed QK^T, dO V^T, P^T dO and dS^T Q (8 x),
    dQ QK^T, dO V^T and dS K (6 x) — at the peak rate of the inputs' type
    (bf16 tensor cores, or f32)."""
    b, sq, h, d = case.q.shape
    sk = case.k.shape[1]
    es = case.q.element_size()
    qb, kb = b * sq * h * d * es, b * sk * h * d * es
    row = 4 * b * h * sq                       # lse or delta
    seg = 4 * b * (sq + sk)
    pairs = tw.live_pairs(case.q_seg.cpu().numpy(), case.kv_seg.cpu().numpy(),
                          case.causal) * h
    nbytes, mults = {
        "flash_fwd": (qb + 2 * kb + seg + qb + row, 4),
        "flash_bwd_kv": (2 * qb + 2 * kb + 2 * row + seg + 2 * kb, 8),
        "flash_bwd_dq": (2 * qb + 2 * kb + 2 * row + seg + qb, 6),
    }[which]
    flops = mults * pairs * d
    rate = BF16_FLOPS_PER_S if case.q.dtype == torch.bfloat16 \
        else F32_FLOPS_PER_S
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / rate * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": flops, "live_pairs": pairs}


def device_ms(fn, reps: int = 10, what: str = "") -> float:
    """Card time of one call: one call's worth of each CUDA kernel's mean
    record over ``reps`` calls under ``torch.profiler``, after one warm-up
    call (``compare_flash.card_ms``).  It leaves out the host's work
    between kernels, which for a small kernel's wrapper or a call through
    autograd can be longer than the kernels themselves.  Where the trace
    lost kernel records, or caught too little in a few tries (the calls
    are then timed back to back with CUDA events instead), a line naming
    ``what`` says so."""
    ms, timer = card_ms(fn, reps)
    if timer != "profiler":
        emit({"timer": timer, "what": what, "ms": ms})
    return ms


def sdpa_ms(case) -> dict:
    """``scaled_dot_product_attention(is_causal=True)`` on the [B, H, S, D]
    view of the equal-length batch (case a): card time of the forward, of
    the backward alone (through a saved forward, the yardstick of dK/dV
    and dQ), and of forward plus backward (of the three kernels
    together).  Timed here only; the port never calls it."""
    import torch.nn.functional as F

    shape = (tw.BATCH, tw.SEQ) + tuple(case.q.shape[2:])
    q, k, v, do = (x.reshape(shape).transpose(1, 2).contiguous()
                   for x in (case.q, case.k, case.v, case.dout))
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    def fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(o, (qg, kg, vg), do)

    saved = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

    def bwd():
        torch.autograd.grad(saved, (qg, kg, vg), do, retain_graph=True)

    return {"library_fwd_ms": device_ms(fwd, what="sdpa_fwd"),
            "library_bwd_ms": device_ms(bwd, what="sdpa_bwd"),
            "library_fwd_bwd_ms": device_ms(fwd_bwd, what="sdpa_fwd_bwd"),
            "library_out": fwd().transpose(1, 2).reshape(case.q.shape)}


def dense_mask(case) -> torch.Tensor:
    """The flash mask of ``case`` as a dense boolean [Sq, Sk] (batch 1):
    same segment id and, under ``causal``, key index <= query index."""
    mask = case.q_seg[0][:, None] == case.kv_seg[0][None, :]
    if case.causal:
        mask &= torch.ones(mask.shape, dtype=torch.bool,
                           device=mask.device).tril()
    return mask


def sdpa_masked_ms(case, out, events: bool = False) -> dict:
    """``scaled_dot_product_attention`` with :func:`dense_mask` on the
    [B, H, S, D] views of ``case``: card time of the forward and of the
    backward alone (through a saved forward), and its largest difference
    from the kernel's output ``out`` over the rows with a key (SDPA gives
    NaN on a row the mask empties, where the kernel gives 0).  With
    ``events`` the calls are timed back to back between CUDA events
    (:func:`time_ms`), not by the profiler.  Timed here only; the port
    never calls it."""
    import torch.nn.functional as F

    mask = dense_mask(case)
    q, k, v, do = (x.transpose(1, 2).contiguous()
                   for x in (case.q, case.k, case.v, case.dout))
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    saved = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)

    def bwd():
        torch.autograd.grad(saved, (qg, kg, vg), do, retain_graph=True)

    rows = mask.any(dim=1)
    diff = (fwd().transpose(1, 2).float() - out.float())[:, rows]
    if events:
        fwd_ms, bwd_ms = time_ms(fwd, reps=10), time_ms(bwd, reps=10)
    else:
        fwd_ms = device_ms(fwd, what=f"{case.name} sdpa_fwd")
        bwd_ms = device_ms(bwd, what=f"{case.name} sdpa_bwd")
    return {"library_fwd_ms": fwd_ms, "library_bwd_ms": bwd_ms,
            "library_timer": "events" if events else "profiler",
            "library_out_max_abs_diff": float(diff.abs().max())}


def run_flash_cases(dev, names=tuple(tw.FLASH_CASES),
                    phase: str = "flash_kernels",
                    plain_events: bool = False,
                    library=tw.NMT_FLASH_CASES) -> dict:
    """Each flash kernel against its plain version on every case of
    ``names``; raises if any output is outside its tolerance.  Times are
    card time (:func:`device_ms`): the wrapper's kernel with its small
    helper ops, the plain version's kernels, the library call's kernels
    (SDPA on the training case, and SDPA with the dense mask on the cases
    of ``library``).
    With ``plain_events`` the plain version is timed once between CUDA
    events instead (:func:`time_ms`): late in the run the profiler loses
    the records of its hundreds of small kernels and retries three times.
    Returns the results by case name."""
    from paddle_tpu_torch.ops import attention as A

    results = {}
    for name in names:
        case = tw.flash_case(name, dev)
        cfg = dict(causal=case.causal, sm_scale=case.sm_scale)
        fwd_args = (case.q, case.k, case.v, case.q_seg, case.kv_seg)
        o_ref, lse_ref = A.flash_fwd_reference(*fwd_args, **cfg)
        o, lse = A.flash_fwd_kernel(*fwd_args, **cfg)
        bwd_args = fwd_args + (case.dout, lse_ref,
                               A.attention_delta(o_ref, case.dout))
        dk_ref, dv_ref = A.flash_bwd_kv_reference(*bwd_args, **cfg)
        dk, dv = A.flash_bwd_kv_kernel(*bwd_args, **cfg)
        dq_ref = A.flash_bwd_dq_reference(*bwd_args, **cfg)
        dq = A.flash_bwd_dq_kernel(*bwd_args, **cfg)
        torch.cuda.synchronize()
        errs = {"o": tw.flash_error(o, o_ref),
                "lse": tw.flash_error(lse, lse_ref),
                "dk": tw.flash_error(dk, dk_ref),
                "dv": tw.flash_error(dv, dv_ref),
                "dq": tw.flash_error(dq, dq_ref)}
        kernels = {
            "flash_fwd": (A.flash_fwd_kernel, A.flash_fwd_reference,
                          fwd_args, ("o", "lse")),
            "flash_bwd_kv": (A.flash_bwd_kv_kernel, A.flash_bwd_kv_reference,
                             bwd_args, ("dk", "dv")),
            "flash_bwd_dq": (A.flash_bwd_dq_kernel, A.flash_bwd_dq_reference,
                             bwd_args, ("dq",)),
        }
        res = {"phase": phase, "case": case.name,
               "plain_timer": "events" if plain_events else "profiler",
               "dtype": str(case.q.dtype).replace("torch.", ""),
               "route": A.kernel_route(tuple(case.q.shape),
                                       tuple(case.k.shape), case.q.dtype,
                                       False),
               "q": list(case.q.shape), "k": list(case.k.shape),
               "causal": case.causal, "errors": errs}
        for kname, (kern, plain, args, outs) in kernels.items():
            res[kname] = {
                "max_abs_err": max(errs[o]["max_abs_err"] for o in outs),
                "ms": device_ms(lambda: kern(*args, **cfg), reps=20,
                                what=f"{name} {kname}"),
                "plain_ms": (time_ms(lambda: plain(*args, **cfg), reps=1,
                                     warmup=1) if plain_events else
                             device_ms(lambda: plain(*args, **cfg), reps=3,
                                       what=f"{name} {kname} plain")),
                **flash_bound(case, kname)}
        kinds = A.tile_pair_kinds(case.q_seg, case.kv_seg, case.causal,
                                  A.kernel_tile(case.q.shape[3]))
        res["tile_pairs"] = {kind: int((kinds == code).sum()) for kind, code
                             in (("interior", A.PAIR_INTERIOR),
                                 ("boundary", A.PAIR_BOUNDARY))}
        if case.name.startswith("a_"):
            lib = sdpa_ms(case)
            for key in LIBRARY_KEYS:
                res[key] = lib[key]
            res["library_out_max_abs_diff"] = float(
                (lib["library_out"].float() - o.float()).abs().max())
        elif case.name in library:
            res.update(sdpa_masked_ms(case, o, events=plain_events))
        ok = all(e["within_tolerance"] for e in errs.values())
        res["within_tolerance"] = ok
        emit(res)
        if not ok:
            raise AssertionError(f"flash case {case.name} outside tolerance")
        results[case.name] = res
    return results


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN_STEPS = 6          # the first is the untimed warm-up
PARITY_LAYERS, PARITY_BATCH, PARITY_STEPS = 2, 2, 3
# kernel path against the plain flash path, per-step cost, relative:
# both run bf16 flash inputs with P and dS rounded at the same places; the
# kernels sum in another order, so a few bf16 roundings flip (on an H100:
# 1.7e-6 with the CUDA-core kernels, 2.2e-5 with the tensor-core ones)
PARITY_RTOL = 2e-4


def _train_costs(sgd, samples, steps, workload=tw, metrics=None):
    """Train ``steps`` steps on one batch through ``SGD.train``; per step
    the cost and the host time from BeginIteration to the cost on the
    host (feeding, forward, backward, update).  ``workload`` gives the
    reader and the feeding; ``metrics``, a list, gets each step's."""
    from paddle_tpu_torch import event

    costs, step_ms, t = [], [], [0.0]

    def handler(ev):
        if isinstance(ev, event.BeginIteration):
            torch.cuda.synchronize()
            t[0] = time.perf_counter()
        elif isinstance(ev, event.EndIteration):
            costs.append(ev.cost)              # waits for the card
            step_ms.append(1e3 * (time.perf_counter() - t[0]))
            if metrics is not None:
                metrics.append(dict(ev.metrics))

    sgd.train(workload.repeat_reader(samples, steps), num_passes=1,
              event_handler=handler, feeding=workload.FEEDING)
    return costs, step_ms


def train(dev) -> dict:
    t0 = time.perf_counter()
    sgd = tw.build_trainer(dev)
    samples = tw.lm_samples(tw.SEED + 1)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    tw.reset_flash_launches()
    costs, step_ms = _train_costs(sgd, samples, TRAIN_STEPS)
    launches = tw.flash_launches()
    timed = step_ms[1:]
    res = {"phase": "train", "model": tw.MODEL, "batch": tw.BATCH,
           "seq": tw.SEQ, "steps": TRAIN_STEPS, "costs": costs,
           "step_ms": step_ms, "step_ms_median": float(np.median(timed)),
           "tokens_per_s": tw.BATCH * tw.SEQ / (np.median(timed) / 1e3),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
           "parameters": sum(p.numel() for p in sgd.parameters.as_dict()
                             .values()),
           "setup_s": setup_s, "kernel_launches": launches,
           "launches_expected": tw.MODEL["n_layers"] * TRAIN_STEPS}
    emit(res)
    if not all(np.isfinite(costs)) or not costs[-1] < costs[0]:
        raise AssertionError(f"training did not learn: costs {costs}")
    for name, n in launches.items():
        if n != res["launches_expected"]:
            raise AssertionError(f"{name} launched {n} times, expected "
                                 f"{res['launches_expected']}")
    return res


def train_parity(dev) -> dict:
    samples = tw.lm_samples(tw.SEED + 2, bs=PARITY_BATCH)
    sgd = tw.build_trainer(dev, n_layers=PARITY_LAYERS)
    before = tw.flash_launches()
    kernel_costs, _ = _train_costs(sgd, samples, PARITY_STEPS)
    used = {k: v - before[k] for k, v in tw.flash_launches().items()}
    del sgd
    sgd = tw.build_trainer(dev, n_layers=PARITY_LAYERS)
    with tw.plain_flash_path():
        plain_costs, _ = _train_costs(sgd, samples, PARITY_STEPS)
    del sgd
    rel = [abs(a - b) / abs(b) for a, b in zip(kernel_costs, plain_costs)]
    res = {"phase": "train_parity", "layers": PARITY_LAYERS,
           "batch": PARITY_BATCH, "steps": PARITY_STEPS,
           "kernel_costs": kernel_costs, "plain_costs": plain_costs,
           "max_rel_diff": max(rel), "rtol": PARITY_RTOL,
           "kernel_launches": used}
    emit(res)
    if max(rel) > PARITY_RTOL or any(
            n != PARITY_LAYERS * PARITY_STEPS for n in used.values()):
        raise AssertionError("kernel path and plain path disagree")
    return res


# ---------------------------------------------------------------------------
# the parallel slice on one card
# ---------------------------------------------------------------------------

MOE_STEPS = 6            # the first is the untimed warm-up
MOE_PARITY_COST_RTOL, MOE_PARITY_UPDATE_RTOL = 1e-4, 1e-3
WORLD1_COST_RTOL, WORLD1_PARAM_RTOL = 1e-3, 2e-2
MOE_LAYER_RTOL = 1e-5


def _lm_steps(sgd, samples, steps):
    """(costs, step ms) of ``steps`` steps through ``SGD.train``; the
    flash launches they made."""
    torch.cuda.reset_peak_memory_stats()
    tw.reset_flash_launches()
    costs, step_ms = _train_costs(sgd, samples, steps)
    return costs, step_ms, tw.flash_launches()


def train_moe(dev, card: str) -> dict:
    """bench.py's MoE LM and its dense twin through ``SGD.train``."""
    t0 = time.perf_counter()
    samples = pw.moe_samples(tw.SEED + 1)
    out = {}
    for name, experts in (("moe", pw.MOE_EXPERTS), ("dense", 0)):
        sgd = pw.moe_trainer(dev, moe_experts=experts)
        costs, step_ms, launches = _lm_steps(sgd, samples, MOE_STEPS)
        timed = float(np.median(step_ms[1:]))
        out[name] = {
            "costs": costs, "step_ms": step_ms, "step_ms_median": timed,
            "tokens_per_s": pw.MOE_BATCH * pw.MOE_SEQ / (timed / 1e3),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
            "parameters": sum(p.numel() for p in
                              sgd.parameters.as_dict().values()),
            "kernel_launches": launches}
        del sgd
        torch.cuda.empty_cache()
    parity = pw.moe_parity_step(dev)
    moe = out["moe"]
    res = {"phase": "train_moe", "model": pw.MOE_MODEL,
           "experts": pw.MOE_EXPERTS, "top_k": pw.MOE_TOP_K,
           "batch": pw.MOE_BATCH, "seq": pw.MOE_SEQ, "steps": MOE_STEPS,
           **{k: moe[k] for k in ("costs", "step_ms", "step_ms_median",
                                  "tokens_per_s", "peak_memory_gb",
                                  "parameters", "kernel_launches")},
           "launches_expected": pw.MOE_MODEL["n_layers"] * MOE_STEPS,
           "dense_twin": out["dense"],
           "moe_vs_dense_step_ratio": moe["step_ms_median"]
           / out["dense"]["step_ms_median"],
           "parity": {**parity, "cost_rtol": MOE_PARITY_COST_RTOL,
                      "update_rtol": MOE_PARITY_UPDATE_RTOL},
           "seconds": time.perf_counter() - t0, "nvidia_smi": card}
    emit(res)
    problems = []
    if not all(np.isfinite(moe["costs"])):
        problems.append(f"costs {moe['costs']}")
    for k, n in moe["kernel_launches"].items():
        if n != res["launches_expected"]:
            problems.append(f"{k} launched {n} times")
    if parity["cost_rel_diff"] > MOE_PARITY_COST_RTOL or \
            parity["update_rel_diff_max"] > MOE_PARITY_UPDATE_RTOL:
        problems.append(f"card vs CPU: {parity}")
    if problems:
        raise AssertionError(f"train_moe: {problems}")
    return res


# ---------------------------------------------------------------------------
# tensor-parallel serving
# ---------------------------------------------------------------------------

# a parting of the tensor-parallel tokens from the one-process engine's
# passes only at a near tie of the one-process reference: its top-2 logit
# gap under this share of its top logit (f32 sums split over two ranks
# and taken in another order), the two picks its top two
TP_TIE_RTOL = 1e-3


def serve_tp(dev, card: str, served: dict) -> dict:
    """The serve workload at tp 2: two processes on this card joined by
    gloo (``tools/tp_workload.py``), each serving with its shard; gated on
    equal tokens across the ranks, tokens equal to the one-process
    engine's (each parting replayed, a near tie), B4 launched 8 layers x
    steps on each rank and each rank's B4 at one step held against its
    plain version, 2 x 8 all-reduces a step with their bytes equal to
    ``tp_step_comm_bytes``, pages conserved."""
    from paddle_tpu_torch.platform.virtual import start_ranks

    t0 = time.perf_counter()
    ranks = start_ranks("paddle_tpu_torch.tools.tp_workload:serve_tp_rank",
                        tpw.TP, device="cuda",
                        timeout=600).wait()
    seconds = time.perf_counter() - t0
    problems, partings = [], []
    want = served["outputs"]
    model = None
    for i, got in enumerate(ranks[0]["outputs"]):
        if got == want[i]:
            continue
        if model is None:
            model = build_model(dev)
        rep = tpw.replay_parting(model, served["prompts"][i], got, want[i])
        rep.update(request=i, near_tie=rep["picks_are_top2"] and
                   rep["top2_gap"] < TP_TIE_RTOL * abs(rep["top_logit"]))
        emit({"phase": "serve_tp_parting", **rep})
        partings.append(rep)
        if not rep["near_tie"]:
            problems.append(f"request {i} parts from the one-process "
                            f"engine at token {rep['first_diff']}")
    del model
    keep = ("kernel_launches", "launches_expected", "steps", "tp",
            "allreduce_link_bytes", "tp_step_comm_bytes",
            "comm_matches_closed_form", "conservation", "drained",
            "kv_bytes_per_rank", "pool_shard", "wq_shard", "load_s",
            "wall_s", "tokens_per_s", "allreduce_s", "allreduce_share",
            "kernel_check")
    res = {"phase": "serve_tp", "route": ranks[0]["route"],
           "model": MODEL, "ranks": [{k: r[k] for k in keep} for r in ranks],
           "allreduce_calls_per_step": sorted(set(
               c for r in ranks for c in r["allreduce_calls"])),
           "ranks_equal": ranks[0]["outputs"] == ranks[1]["outputs"],
           "identical": sum(a == b for a, b in
                            zip(ranks[0]["outputs"], want)),
           "near_ties": len(partings), "tie_rtol": TP_TIE_RTOL,
           "timing": "two ranks time-sharing one card, all-reduces "
                     "through gloo over host copies, the card "
                     "synchronized around each: not a tensor-parallel "
                     "speed",
           "seconds": seconds, "nvidia_smi": card}
    emit(res)
    if not res["ranks_equal"]:
        problems.append("the two ranks' tokens differ")
    for r in ranks:
        if r["kernel_launches"] != r["launches_expected"] or \
                r["kernel_launches"] == 0:
            problems.append(f"rank {r['rank']}: B4 launched "
                            f"{r['kernel_launches']} times, want "
                            f"{r['launches_expected']}")
        if r["recorded_steps"] != r["steps"]:
            problems.append(f"rank {r['rank']}: {r['recorded_steps']} of "
                            f"{r['steps']} steps recorded")
        if not r["comm_matches_closed_form"]:
            problems.append(f"rank {r['rank']}: all-reduces "
                            f"{sorted(set(r['allreduce_calls']))} a step "
                            "or their bytes off tp_step_comm_bytes")
        if not (r["conservation"] and r["drained"]):
            problems.append(f"rank {r['rank']}: pages not conserved")
        if not r["kernel_check"]["within_tolerance"]:
            problems.append(f"rank {r['rank']}: B4 on the shard off its "
                            "plain version")
    if problems:
        raise AssertionError(f"serve_tp: {problems}")
    return res


def serve_tp_world1(dev, card: str) -> dict:
    """The tensor-parallel engine on a one-rank NCCL 'model' mesh against
    the engine without a mesh, on the serve workload from the same
    weights: every step's logits and every token equal to the bit, B4
    launched 8 x steps, 2 x 8 all-reduces a step (identities on one
    rank)."""
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.serving.decode_attention import \
        ragged_paged_attention_kernel as kernel

    t0 = time.perf_counter()
    model = build_model(dev)
    runs = {}
    with pw.nccl_world1():
        mesh = make_mesh((1,), ("model",))
        for name, kw in (("no_mesh", {}), ("tp1", {"mesh": mesh})):
            eng = make_engine(model, dev, **kw)
            logits = []
            step = eng._step

            def keep(*a, step=step, logits=logits):
                out = step(*a)
                logits.append(out)
                return out

            eng._step = keep
            kernel.launches = 0
            wl = Workload(eng)
            while not wl.done:
                wl.step()
            runs[name] = {"outputs": [eng.result(r) for r in wl.rids],
                          "logits": logits, "launches": kernel.launches,
                          "steps": eng.metrics.step_dispatches,
                          "allreduce_calls": eng.model.allreduce_calls,
                          "conservation": eng.healthz()["ok"]}
            del eng
    a, b = runs["no_mesh"], runs["tp1"]
    same_logits = len(a["logits"]) == len(b["logits"]) and all(
        np.array_equal(x, y) for sa, sb in zip(a["logits"], b["logits"])
        for x, y in zip(sa, sb))
    res = {"phase": "serve_tp_world1", "steps": b["steps"],
           "tokens_equal": a["outputs"] == b["outputs"],
           "logits_equal": same_logits, "kernel_launches": b["launches"],
           "launches_expected": MODEL["num_layers"] * b["steps"],
           "allreduce_calls": b["allreduce_calls"],
           "allreduce_expected": 2 * MODEL["num_layers"] * b["steps"],
           "conservation": b["conservation"],
           "seconds": time.perf_counter() - t0, "nvidia_smi": card}
    emit(res)
    del model
    torch.cuda.empty_cache()
    if not (res["tokens_equal"] and res["logits_equal"]
            and res["conservation"]
            and res["kernel_launches"] == res["launches_expected"]
            and res["allreduce_calls"] == res["allreduce_expected"]):
        raise AssertionError(f"serve_tp_world1: {res}")
    return res


def parallel_world1(dev, card: str) -> dict:
    """One-rank NCCL: the headline under DP + ZeRO-1 and under the
    pipeline against its no-mesh run; the MoE layer on an expert axis of
    one against the dense path; DeepFM's table through the row-sharded
    lookups and update, LocalSGD and the pooled statistics against their
    meshless runs."""
    t0 = time.perf_counter()
    with pw.nccl_world1():
        runs = pw.headline_runs(dev)
        layer = pw.moe_layer_world1(dev)
        sparse = pw.sparse_world1(dev)
        local_sgd = pw.local_sgd_world1(dev)
        pooled = pw.pooled_stats_world1(dev)
    n = tw.MODEL["n_layers"] * pw.WORLD1_STEPS
    expected = {"no_mesh": n, "dp_zero1": n,
                "pipeline": n * pw.WORLD1_MICROBATCHES}
    res = {"phase": "parallel_world1", "model": tw.MODEL,
           "steps": pw.WORLD1_STEPS,
           "microbatches": pw.WORLD1_MICROBATCHES, **runs,
           "launches_expected": expected, "moe_layer": layer,
           "sparse": sparse, "local_sgd": local_sgd, "pooled": pooled,
           "cost_rtol": WORLD1_COST_RTOL, "param_rtol": WORLD1_PARAM_RTOL,
           "moe_layer_rtol": MOE_LAYER_RTOL,
           "seconds": time.perf_counter() - t0, "nvidia_smi": card}
    emit(res)
    problems = []
    if runs["dp_zero1"]["costs"] != runs["no_mesh"]["costs"] or \
            runs["dp_zero1"]["param_rel_diff_max"] != 0.0:
        problems.append("DP + ZeRO-1 on one rank is not the no-mesh run")
    if runs["pipeline"]["cost_rel_diff"] > WORLD1_COST_RTOL or \
            runs["pipeline"]["param_rel_diff_max"] > WORLD1_PARAM_RTOL:
        problems.append("the pipeline run parts from the no-mesh run")
    for name, want in expected.items():
        for k, got in runs[name]["launches"].items():
            if got != want:
                problems.append(f"{name}: {k} launched {got} times")
    if layer["max_rel_err"] > MOE_LAYER_RTOL:
        problems.append(f"expert axis of one vs dense: {layer}")
    if not all(sparse[k] for k in ("lookup_equal", "alltoall_equal",
                                   "row_update_equal")):
        problems.append(f"sharded tables on one rank: {sparse}")
    if not local_sgd["equal"]:
        problems.append(f"LocalSGD at sync_period 1: {local_sgd}")
    if not pooled["bn"]["equal"] or \
            pooled["moe"]["max_rel_err"] > MOE_LAYER_RTOL:
        problems.append(f"pooled statistics on one rank: {pooled}")
    if problems:
        raise AssertionError(f"parallel_world1: {problems}")
    return res


# ---------------------------------------------------------------------------
# fault-tolerant training
# ---------------------------------------------------------------------------


def _fail_on(res: dict) -> dict:
    if res["problems"]:
        raise AssertionError(f"{res['phase']}: {res['problems']}")
    return res


def train_resume(dev, card: str) -> dict:
    """The full-width kill-and-resume run (``resw.resume_run``) and the
    guarded and unguarded step times on its weights."""
    t0 = time.perf_counter()
    r = resw.resume_run(dev)
    init = r.pop("init")
    r.update(resw.step_ms(dev, init))
    del init
    torch.cuda.empty_cache()
    first, resumed = r["attempts"]
    load = resumed["load_io_s"]
    # per save: the train loop's stall (the device->host copy), then on
    # the writer thread the blobs, their md5 and the prune's verify
    res = {"phase": "train_resume", **r,
           "checkpoint_gb": r["checkpoint_bytes"] / 1e9,
           "save_stall_ms": first["snapshot_ms"] + resumed["snapshot_ms"],
           "write_s": [first["io_s"]["write"], resumed["io_s"]["write"]],
           "md5_after_write_s": [first["io_s"]["md5"],
                                 resumed["io_s"]["md5"]],
           "prune_verify_s": [first["io_s"]["verify"],
                              resumed["io_s"]["verify"] - load["verify"]],
           "load_s": resumed["resume_s"], "load_verify_s": load["verify"],
           "load_read_s": load["read"],
           "seconds": time.perf_counter() - t0, "nvidia_smi": card}
    emit(res)
    return _fail_on(res)


def resilience_chaos(dev, card: str) -> dict:
    t0 = time.perf_counter()
    res = {"phase": "resilience_chaos", **resw.chaos_run(dev),
           "seconds": time.perf_counter() - t0, "nvidia_smi": card}
    emit(res)
    return _fail_on(res)


def train_elastic(dev, card: str) -> dict:
    t0 = time.perf_counter()
    res = {"phase": "train_elastic", **resw.elastic_run(dev),
           "seconds": time.perf_counter() - t0, "nvidia_smi": card}
    emit(res)
    return _fail_on(res)


# ---------------------------------------------------------------------------
# recurrent kernels and training
# ---------------------------------------------------------------------------

RNN_REPLACES = {"lstm_step": "paddle_tpu/ops/rnn.py:80",
                "gru_step": "paddle_tpu/ops/rnn.py:212",
                "gru_zr": "paddle_tpu/ops/rnn.py:234",
                "gru_cand": "paddle_tpu/ops/rnn.py:244"}
# the mangled name of each kernel that its main-path case (f32) runs
RNN_PTXAS = {"lstm_step": "lstm_step_kernelIfLb1E",
             "gru_step": "gru_step_kernelIfLb1E",
             "gru_zr": "gru_zr_kernelIfLb1E",
             "gru_cand": "gru_cand_kernelIfLb1E"}
GRU_NO_LIBRARY = ("no PyTorch call computes this function: torch.nn.GRU "
                  "applies the reset gate after the product, r(h W_hn + "
                  "b_hn), Paddle's GRU before it, (r h) W_c")


def rnn_bound(case, kernel: str) -> dict:
    """Least time for one call: bytes (each input read once, each output
    written once) at 3.35 TB/s against the recurrent product's f32
    operations at 67 TFLOP/s."""
    nbytes, flops = rw.case_io(case, kernel)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": flops}


def cudnn_lstm_step_ms(B: int, H: int, dev) -> float:
    """Card time of cuDNN's ``torch.nn.LSTM`` forward (input size H, the
    same gate order and activations, plus the input projection) over
    [B, T = 128, H], divided by T.  Timed here only; the port never
    calls it."""
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    lstm = torch.nn.LSTM(H, H, batch_first=True).to(dev)
    x = torch.randn((B, rw.STEPS_T, H), generator=gen).to(dev)
    with torch.no_grad():
        return device_ms(lambda: lstm(x), reps=5,
                         what=f"cudnn_lstm H {H}") / rw.STEPS_T


def _rnn_case_calls(case):
    """{kernel: (kernel call, plain call, {output: (got, want)})} of one
    case; the two-launch GRU case runs B8 on B7's plain outputs."""
    from paddle_tpu_torch.ops import rnn as R

    kind, save, H = case["kind"], case["save_acts"], case["H"]
    xp, h, w, b = case["xp"], case["h"], case["w_h"], case["bias"]
    if kind == "lstm_step":
        a = (xp, h, case["c"], w, b)
        got = R.lstm_step_kernel(*a, save_acts=save)
        want = R.lstm_step_reference(*a, save_acts=save)
        outs = {"h": (got[0], want[0]), "c": (got[1], want[1])}
        if save:
            outs["acts"] = (got[2], want[2])
        return {kind: (lambda: R.lstm_step_kernel(*a, save_acts=save),
                       lambda: R.lstm_step_reference(*a, save_acts=save),
                       outs)}
    a = (xp, h, w, b)
    if kind == "gru_step":
        got = R.gru_step_kernel(*a, save_acts=save)
        want = R.gru_step_reference(*a, save_acts=save)
        outs = {"h": (got[0], want[0])}
        if save:
            outs["acts"] = (got[1], want[1])
        return {kind: (lambda: R.gru_step_kernel(*a, save_acts=save),
                       lambda: R.gru_step_reference(*a, save_acts=save),
                       outs)}
    zrc_k, rh_k = R.gru_zr_kernel(*a)
    zrc_p, rh_p = R.gru_zr_reference(*a)
    zk, zp = zrc_p.clone(), zrc_p.clone()
    nh_k = R.gru_cand_kernel(rh_p, xp, w, b, zk, h, save_c=save)
    nh_p = R.gru_cand_reference(rh_p, xp, w, b, zp, h, save_c=save)
    cand = {"h": (nh_k, nh_p)}
    if save:
        cand["c"] = (zk[:, 2 * H:], zp[:, 2 * H:])
    return {
        "gru_zr": (lambda: R.gru_zr_kernel(*a), lambda: R.gru_zr_reference(*a),
                   {"zr": (zrc_k[:, :2 * H], zrc_p[:, :2 * H]),
                    "rh": (rh_k, rh_p)}),
        "gru_cand": (lambda: R.gru_cand_kernel(rh_p, xp, w, b, zk, h,
                                               save_c=save),
                     lambda: R.gru_cand_reference(rh_p, xp, w, b, zp, h,
                                                  save_c=save), cand)}


def run_rnn_cases(dev) -> dict:
    """Each RNN kernel against its plain version on every case; raises
    if any output is outside its tolerance.  Card time (:func:`device_ms`)
    of the wrapper's kernel and of the plain version's kernels.  Returns
    {case: {kernel: result}}."""
    results = {}
    lib_ms = {}
    for kind, B, H, _, _ in rw.RNN_CASES.values():
        if kind == "lstm_step" and (B, H) not in lib_ms:
            lib_ms[B, H] = cudnn_lstm_step_ms(B, H, dev)
    for name in rw.RNN_CASES:
        case = rw.rnn_case(name, dev)
        calls = _rnn_case_calls(case)
        torch.cuda.synchronize()
        res = {"phase": "rnn_kernels", "case": name, "B": case["B"],
               "H": case["H"], "xp_dtype": str(case["xp"].dtype).replace(
                   "torch.", ""), "save_acts": case["save_acts"]}
        ok = True
        for kname, (kern, plain, outs) in calls.items():
            errs = {o: rw.rnn_error(g, w) for o, (g, w) in outs.items()}
            ok = ok and all(e["within_tolerance"] for e in errs.values())
            res[kname] = {
                "errors": errs,
                "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
                "ms": device_ms(kern, reps=20, what=f"{name} {kname}"),
                "plain_ms": device_ms(plain, reps=5,
                                      what=f"{name} {kname} plain"),
                "library_ms": (lib_ms[case["B"], case["H"]]
                               if kname == "lstm_step" else None),
                **rnn_bound(case, kname)}
        res["within_tolerance"] = ok
        res["sm_clock"] = sm_clock()   # just after the case's timings
        emit(res)
        if not ok:
            raise AssertionError(f"RNN case {name} outside tolerance")
        results[name] = res
    return results


RNN_TRAIN_STEPS = 6      # the first is the untimed warm-up
GRU_RUNS = (  # (hidden, layers, steps, the kernels that must launch)
    (512, 2, 6, ("gru_step",)),
    (1280, 1, 3, ("gru_zr", "gru_cand")))
RNN_PARITY_BATCH, RNN_PARITY_STEPS = 16, 3
# kernel path against the plain path, per-step cost, relative: both do
# the recurrent products in f32 (the kernels sum in another order); the
# rest of the step is the same torch code
RNN_PARITY_RTOL = 1e-4


def _rnn_train(dev, cell: str, steps: int, kernels, **cfg) -> dict:
    """Train one classifier ``steps`` steps on one batch, counts set to 0
    just before; checks finite, falling costs and that exactly
    ``kernels`` launched, each layers x 128 x steps times."""
    t0 = time.perf_counter()
    sgd = rw.build_trainer(dev, cell, **cfg)
    batch = rw.samples(rw.SEED + 1)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    rw.reset_launches()
    costs, step_ms = _train_costs(sgd, batch, steps, rw)
    used = rw.launches()
    layers = cfg.get("num_layers", rw.MODEL["num_layers"])
    expected = {k: (layers * rw.STEPS_T * steps if k in kernels else 0)
                for k in used}
    med = float(np.median(step_ms[1:]))
    res = {"phase": f"train_{cell}", "model": dict(rw.MODEL, **cfg),
           "batch": rw.BATCH, "seq": rw.SEQ, "time_steps": rw.STEPS_T,
           "steps": steps, "costs": costs, "step_ms": step_ms,
           "ms_per_batch": med, "sequences_per_s": rw.BATCH / (med / 1e3),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
           "parameters": sum(p.numel() for p in sgd.parameters.as_dict()
                             .values()),
           "setup_s": setup_s, "kernel_launches": used,
           "launches_expected": expected}
    emit(res)
    if not all(np.isfinite(costs)) or not costs[-1] < costs[0]:
        raise AssertionError(f"{cell} training did not learn: {costs}")
    if used != expected:
        raise AssertionError(f"{cell} launches {used}, expected {expected}")
    return res


def train_lstm(dev) -> dict:
    return _rnn_train(dev, "lstm", RNN_TRAIN_STEPS, ("lstm_step",))


def train_gru(dev) -> list:
    return [_rnn_train(dev, "gru", steps, kernels, hidden=hidden,
                       num_layers=layers)
            for hidden, layers, steps, kernels in GRU_RUNS]


def rnn_parity(dev) -> list:
    out = []
    batch = rw.samples(rw.SEED + 2, bs=RNN_PARITY_BATCH)
    for cell in ("lstm", "gru"):
        sgd = rw.build_trainer(dev, cell)
        before = rw.launches()
        kernel_costs, _ = _train_costs(sgd, batch, RNN_PARITY_STEPS, rw)
        used = {k: v - before[k] for k, v in rw.launches().items()}
        del sgd
        sgd = rw.build_trainer(dev, cell)
        with rw.plain_rnn_path():
            plain_costs, _ = _train_costs(sgd, batch, RNN_PARITY_STEPS, rw)
        del sgd
        rel = [abs(a - b) / abs(b) for a, b in zip(kernel_costs, plain_costs)]
        # at batch 16 the GRU takes B6 at h 512
        kern = "lstm_step" if cell == "lstm" else "gru_step"
        expected = {k: (rw.MODEL["num_layers"] * rw.STEPS_T *
                        RNN_PARITY_STEPS if k == kern else 0) for k in used}
        res = {"phase": "rnn_parity", "cell": cell,
               "layers": rw.MODEL["num_layers"],
               "hidden": rw.MODEL["hidden"], "batch": RNN_PARITY_BATCH,
               "steps": RNN_PARITY_STEPS, "kernel_costs": kernel_costs,
               "plain_costs": plain_costs, "max_rel_diff": max(rel),
               "rtol": RNN_PARITY_RTOL, "kernel_launches": used,
               "launches_expected": expected}
        emit(res)
        if max(rel) > RNN_PARITY_RTOL or used != expected:
            raise AssertionError(f"{cell}: kernel path and plain path "
                                 "disagree")
        out.append(res)
    return out


# ---------------------------------------------------------------------------
# the attention seq2seq NMT: recurrent_group training and beam search
# ---------------------------------------------------------------------------

NMT_STEPS = 6            # the first is the untimed warm-up
NMT_PARITY = dict(bs=8, min_len=10, max_len=20)
# card against CPU, f32 with TF32 off, one step from the same weights: the
# two sum the same products in other orders, through ~20 decoder frames
# and 32 encoder frames of sigmoid and tanh: the cost within 1e-4
# relative, each parameter's update (-lr g) within 1e-3 in norm
NMT_PARITY_COST_RTOL, NMT_PARITY_UPDATE_RTOL = 1e-4, 1e-3
GEN_RUNS = 2             # timed batches, after one warm-up


def nmt_parity(dev) -> dict:
    batch = nw.samples(nw.SEED + 3, **NMT_PARITY)
    res = {"phase": "nmt_parity", "model": nw.MODEL, **NMT_PARITY,
           "use_bf16": False, **nw.step_parity(dev, batch),
           "cost_rtol": NMT_PARITY_COST_RTOL,
           "update_rtol": NMT_PARITY_UPDATE_RTOL}
    emit(res)
    if res["cost_rel_diff"] > NMT_PARITY_COST_RTOL or \
            res["update_max_rel_diff"] > NMT_PARITY_UPDATE_RTOL or \
            res["b6_launches"] != 2 * res["source_frames"]:
        raise AssertionError("the card's NMT step and the CPU path's "
                             "disagree")
    return res


def train_nmt(dev, card: str):
    """The NMT's training at its configuration; returns (result, trainer)
    for the generation phase."""
    t0 = time.perf_counter()
    sgd = nw.build_trainer(dev)
    batch = nw.samples(nw.SEED + 1)
    frames = nw.source_frames(batch)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    rw.reset_launches()
    costs, step_ms = _train_costs(sgd, batch, NMT_STEPS, nw)
    b6 = rw.launches()["gru_step"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = profile_image.launches_per_step(profile_image.profile_steps(
        sgd, nw.feeds(sgd, batch), steps=1), steps=1)
    med = float(np.median(step_ms[1:]))
    res = {"phase": "train_nmt", "model": nw.MODEL, "batch": nw.BATCH,
           "lengths": [nw.MIN_LEN, nw.MAX_LEN], "source_frames": frames,
           "target_tokens": nw.target_tokens(batch), "steps": NMT_STEPS,
           "costs": costs, "step_ms": step_ms, "step_ms_median": med,
           "target_tokens_per_s": nw.target_tokens(batch) / (med / 1e3),
           "peak_memory_gb": peak, "launches_per_step": launches,
           "b6_launches": b6, "b6_launches_per_step": b6 / NMT_STEPS,
           "b6_expected": 2 * frames * NMT_STEPS,
           "parameters": sum(p.numel() for p in
                             sgd.parameters.as_dict().values()),
           "setup_s": setup_s, "nvidia_smi": card}
    emit(res)
    if not all(np.isfinite(costs)) or not costs[-1] < costs[0]:
        raise AssertionError(f"the NMT did not learn: costs {costs}")
    if b6 != res["b6_expected"]:
        raise AssertionError(f"B6 launched {b6} times, expected "
                             f"{res['b6_expected']}")
    return res, sgd


def generate_nmt(dev, sgd, card: str) -> dict:
    """Each of ``nw.GENERATIONS`` (``<e>`` banned until each source's
    target length, and until step 250): its result, by name.  The timed
    runs (the bf16 policy) keep their beams each step; at the target
    lengths the CPU path follows the first of them step by step from the
    same weights (``nw.replay``, within ``nw.BF16_ATOL``), and the second
    too unless it is the first to the bit, then one run with the policy
    off, held within ``nw.TIE_ATOL`` at every step.  The 250-step worst
    case is not replayed on the CPU (it took ~38 s of the host's CPU):
    its two card runs must be the same bits."""
    seed = nw.SEED + 4
    srcs = nw.sources(seed)
    frames = nw.source_frames(srcs)
    cpu_params = parameters_from_numpy(
        {k: v.detach().cpu().numpy() for k, v in sgd.parameters.items()},
        device="cpu")
    cpu_state = state_from_numpy(
        {ns: {k: v.cpu().numpy() for k, v in slots.items()}
         for ns, slots in sgd.model_state.items()}, device="cpu")
    out = {}
    for variant in nw.GENERATIONS:
        until = nw.eos_until(variant, seed)
        ban = nw.EosBan(until)
        _, inf = nw.generator(sgd.parameters, sgd.model_state, dev,
                              hooks={"candidate_adjust": ban})
        nw.generate(inf, srcs)                           # warm-up
        rw.reset_launches()
        ms, runs = [], []
        for _ in range(GEN_RUNS):
            ban.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outputs = nw.generate(inf, srcs)             # on the host
            ms.append(1e3 * (time.perf_counter() - t0))
            runs.append(ban.run(outputs))
        b6 = rw.launches()["gru_step"]
        same = nw.runs_equal(runs[0], runs[1])
        t0 = time.perf_counter()
        # the worst case is not replayed on the CPU (~38 s of the host):
        # its two card runs must be the same bits instead (C5)
        replayed = runs[:1] if same else runs
        if variant == "eos_banned":
            replayed = []
        checks = [dict(nw.replay(cpu_params, cpu_state, srcs, until, run,
                                 atol=nw.BF16_ATOL), run=i, policy="bf16")
                  for i, run in enumerate(replayed)]
        if variant == "target_lengths":
            with nw.f32_policy():          # a run held at TIE_ATOL
                ban.clear()
                run = ban.run(nw.generate(inf, srcs))
                checks.append(dict(nw.replay(cpu_params, cpu_state, srcs,
                                             until, run), run="f32",
                                   policy="f32"))
        replay_s = time.perf_counter() - t0
        tokens, lengths, scores = runs[-1][0]
        med = float(np.median(ms))
        res = {"phase": "generate_nmt", "variant": variant,
               "sources": len(srcs), "beam": nw.BEAM,
               "max_length": nw.MAX_LENGTH, "source_frames": frames,
               "eos_banned_until": until.tolist(),
               "ms_per_batch": ms, "ms_per_batch_median": med,
               "steps_taken": [len(r[1]) for r in runs],
               "sentences_per_s": len(srcs) / (med / 1e3),
               "generated_tokens_per_s": float(lengths.sum()) /
               (med / 1e3),
               "lengths_mean": float(lengths.mean()),
               "finite_scores": bool(np.isfinite(scores).all()),
               "b6_launches": b6, "b6_expected": 2 * frames * GEN_RUNS,
               "card_runs_equal": same, "cpu_replay": checks,
               "replay_s": replay_s, "nvidia_smi": card}
        emit(res)
        if variant == "eos_banned" and not same:
            raise AssertionError("NMT generation eos_banned: the two card "
                                 "runs differ")
        if not (res["finite_scores"] and all(c["ok"] for c in checks) and
                tokens.shape == (len(srcs), nw.BEAM, nw.MAX_LENGTH) and
                ((tokens >= 0) &
                 (tokens < nw.MODEL["trg_dict_size"])).all() and
                (lengths >= np.minimum(until + 1,
                                       nw.MAX_LENGTH)[:, None]).all()):
            raise AssertionError(f"NMT generation {variant} wrong: {checks}")
        if b6 != res["b6_expected"]:
            raise AssertionError(f"B6 launched {b6} times in generation "
                                 f"{variant}, expected {res['b6_expected']}")
        out[variant] = res
    return out


NMT_CASES = {"train": "nmt_gru_block_f32_b50_acts",
             "generate": "nmt_gru_block_f32_b16"}
# B5's cases at the seventh slice's shapes
SEQ_CASES = {"srl": "lstm_f32_h128_b10_acts",
             "quick_start": "lstm_f32_h128_b128_acts"}


def rnn_kernel_lines(cases, trained_lstm, trained_gru, nmt, seq) -> list:
    """The ``kernels`` entries of B5-B8: launches from the training runs
    of the main path and, for B6, the NMT's training and generation
    (``nmt``: phase -> its result or results), for B5 SRL's and
    quick_start's (``seq``: path -> launches), the rest from their
    main-path case (B6's NMT cases and B5's H 128 cases beside it)."""
    launched = dict(trained_lstm["kernel_launches"])
    launched["lstm_step"] += sum(seq.values())
    for run in trained_gru:
        for k, n in run["kernel_launches"].items():
            launched[k] = launched.get(k, 0) + n
    nmt_launches = {"train_nmt": nmt["train_nmt"]["b6_launches"],
                    **{f"generate_nmt_{v}": r["b6_launches"]
                       for v, r in nmt["generate_nmt"].items()}}
    launched["gru_step"] += sum(nmt_launches.values())
    lines = []
    for kname, cname in rw.MAIN_CASE.items():
        r = cases[cname][kname]
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        extra = {}
        if kname == "gru_step":
            extra = {"launches_nmt": nmt_launches,
                     "nmt_cases": {phase: {k: cases[c][kname][k]
                                           for k in keys[:-1]}
                                   for phase, c in NMT_CASES.items()}}
        elif kname == "lstm_step":
            extra = {**{f"launches_{p}": n for p, n in seq.items()},
                     "h128_cases": {p: {"case": c, **{
                         k: cases[c][kname][k] for k in keys}}
                         for p, c in SEQ_CASES.items()}}
        lines.append({
            "name": kname, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/rnn_cells.cu",
            "replaces": RNN_REPLACES[kname], "launches": launched[kname],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "ptxas": ptxas_of("rnn_cells", RNN_PTXAS[kname]),
            "library": ("torch.nn.LSTM forward (cuDNN) over [B, 128, H] at "
                        "each case's B and H, per step"
                        if kname == "lstm_step" else GRU_NO_LIBRARY),
            "case": cname, **extra})
    return lines


# ---------------------------------------------------------------------------
# image models (no hand-written kernel: cuDNN through PyTorch)
# ---------------------------------------------------------------------------

IMAGE_PARITY = dict(depth=18, img_size=64, batch=8, steps=3)
# f32 with TF32 off, each card step from the CPU run's weights and
# statistics: the two sum the same products in other orders, and batch
# norm over 32 values a channel amplifies it; an update is held looser,
# since one ReLU input within f32 rounding of 0 that the two round to
# opposite sides moves a tensor's gradient by about 1% (the CPU tests'
# float64 runs hold every gradient to 1e-6)
IMAGE_PARITY_COST_RTOL, IMAGE_PARITY_STATS_RTOL = 1e-4, 1e-3
IMAGE_PARITY_UPDATE_RTOL = 1e-1
RESNET50_STEPS = 6           # after one warm-up
CONVNET_STEPS = 3            # after one warm-up: 4 in all


def _rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() /
                 b.double().norm().clamp_min(1e-30))


def image_parity(dev) -> dict:
    """ResNet-18 steps on the card against the port's plain CPU path: the
    CPU run trains 3 steps; before each, the card's trainer takes its
    weights and moving statistics and runs the same step on the same
    batch.  Compared: the cost, the new moving statistics and each
    parameter's update p_new - p_old (the Momentum slots are each
    trainer's own)."""
    from paddle_tpu_torch.platform.flags import FLAGS

    cfg = IMAGE_PARITY
    old = FLAGS.use_bf16
    FLAGS.use_bf16 = False
    try:
        cpu = iw.build_trainer(iw.HEADLINE, torch.device("cpu"),
                               depth=cfg["depth"], img_size=cfg["img_size"])
        card = iw.build_trainer(iw.HEADLINE, dev, depth=cfg["depth"],
                                img_size=cfg["img_size"])
        rows = []
        for i in range(cfg["steps"]):
            feeds = iw.device_feeds(iw.HEADLINE, torch.device("cpu"),
                                    seed=iw.SEED + 10 + i,
                                    batch=cfg["batch"], img=cfg["img_size"])
            old = {k: cpu.parameters[k].detach().clone()
                   for k in cpu._names}
            with torch.no_grad():
                for k in card._names:
                    card.parameters[k].copy_(old[k])
            card.model_state = {
                layer: {s: v.to(dev) for s, v in slots.items()}
                for layer, slots in cpu.model_state.items()}
            card_cost = float(card.step({k: v.to(dev)
                                         for k, v in feeds.items()}))
            cpu_cost = float(cpu.step(feeds))
            stats = max(_rel_norm(card.model_state[layer][s].cpu(), v)
                        for layer, slots in cpu.model_state.items()
                        for s, v in slots.items())
            updates = {k: _rel_norm(card.parameters[k].detach().cpu() -
                                    old[k], cpu.parameters[k].detach() -
                                    old[k]) for k in cpu._names}
            worst = max(updates, key=updates.get)
            rows.append({"cpu_cost": cpu_cost, "card_cost": card_cost,
                         "cost_rel_diff": abs(card_cost - cpu_cost) /
                         abs(cpu_cost), "stats_max_rel_diff": stats,
                         "update_max_rel_diff": updates[worst],
                         "update_worst": worst,
                         "update_median_rel_diff": float(
                             np.median(list(updates.values())))})
    finally:
        FLAGS.use_bf16 = old
    res = {"phase": "image_parity", **cfg, "use_bf16": False,
           "allow_tf32": [torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32],
           "cudnn_benchmark": torch.backends.cudnn.benchmark, "per_step": rows,
           "cost_rtol": IMAGE_PARITY_COST_RTOL,
           "stats_rtol": IMAGE_PARITY_STATS_RTOL,
           "update_rtol": IMAGE_PARITY_UPDATE_RTOL}
    emit(res)
    if any(r["cost_rel_diff"] > IMAGE_PARITY_COST_RTOL or
           r["stats_max_rel_diff"] > IMAGE_PARITY_STATS_RTOL or
           r["update_max_rel_diff"] > IMAGE_PARITY_UPDATE_RTOL or
           not np.isfinite(r["card_cost"]) for r in rows):
        raise AssertionError("the card's image path and the CPU path "
                             "disagree")
    return res


def train_resnet50(dev, card: str, cudnn: dict) -> dict:
    cell = iw.MODELS[iw.HEADLINE]
    t0 = time.perf_counter()
    sgd = iw.build_trainer(iw.HEADLINE, dev)
    feeds = iw.device_feeds(iw.HEADLINE, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    costs, step_ms = iw.time_steps(sgd, feeds, RESNET50_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = float(np.median(step_ms))
    moved = [layer for layer, slots in sgd.model_state.items()
             if torch.count_nonzero(slots["moving_mean"]) > 0]
    launches = profile_image.launches_per_step(
        profile_image.profile_steps(sgd, feeds))
    pass_costs, pass_ms = _image_pass(sgd, iw.HEADLINE)
    flop = 3 * iw.RESNET50_FWD_FLOP_PER_IMAGE * cell["batch"]
    res = {"phase": "train_resnet50", "model": iw.HEADLINE,
           "img": cell["img"], "batch": cell["batch"], **cudnn,
           "steps": RESNET50_STEPS, "costs": costs, "step_ms": step_ms,
           "step_ms_median": med,
           "images_per_s": cell["batch"] / (med / 1e3),
           "analytic_tflop_per_s": flop / (med / 1e3) / 1e12,
           "peak_memory_gb": peak, "launches_per_step": launches,
           "parameters": sum(p.numel() for p in
                             sgd.parameters.as_dict().values()),
           "batch_norm_layers": len(sgd.model_state),
           "moving_means_moved": len(moved), "setup_s": setup_s,
           "feeder_pass_costs": pass_costs, "feeder_pass_ms": pass_ms,
           "nvidia_smi": card}
    emit(res)
    if not all(np.isfinite(costs + pass_costs)) or not costs[-1] < costs[0]:
        raise AssertionError(f"ResNet-50 did not learn: costs {costs}, "
                             f"feeder pass {pass_costs}")
    if len(moved) != len(sgd.model_state):
        raise AssertionError("a batch norm's moving mean stayed at 0")
    return res


def _image_pass(sgd, name: str):
    """One ``SGD.train`` pass over a reader of 2 flat CHW batches through
    the ``DataFeeder``: (costs, host ms per batch)."""
    from paddle_tpu_torch import event

    batches = [iw.flat_samples(name, iw.SEED + 20 + i) for i in range(2)]
    costs, ms, t = [], [], [0.0]

    def handler(ev):
        if isinstance(ev, event.BeginIteration):
            torch.cuda.synchronize()
            t[0] = time.perf_counter()
        elif isinstance(ev, event.EndIteration):
            costs.append(ev.cost)
            ms.append(1e3 * (time.perf_counter() - t[0]))

    sgd.train(lambda: iter(batches), num_passes=1, event_handler=handler)
    return costs, ms


def train_convnets(dev, card: str, cudnn: dict) -> list:
    out = []
    for name in ("alexnet", "googlenet", "smallnet", "lenet"):
        cell = iw.MODELS[name]
        sgd = iw.build_trainer(name, dev)
        feeds = iw.device_feeds(name, dev)
        torch.cuda.reset_peak_memory_stats()
        costs, step_ms = iw.time_steps(sgd, feeds, CONVNET_STEPS)
        med = float(np.median(step_ms))
        res = {"phase": "train_convnets", "model": name, "img": cell["img"],
               "batch": cell["batch"], **cudnn,
               "steps": CONVNET_STEPS + 1, "costs": costs,
               "step_ms": step_ms, "ms_per_batch": med,
               "images_per_s": cell["batch"] / (med / 1e3),
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
               "nvidia_smi": card}
        emit(res)
        if not all(np.isfinite(costs)) or not costs[-1] < costs[0]:
            raise AssertionError(f"{name} did not learn: costs {costs}")
        out.append(res)
        del sgd, feeds
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# head dims (C4): the kernels at 12, 100, 320, 640 and 1024
# ---------------------------------------------------------------------------

HEAD_DIM_SERVE = dict(num_layers=2, num_heads=4, head_dim=100)
HEAD_DIM_TRAIN_STEPS = 3
# card against CPU path, f32 with TF32 off, 3 Momentum steps from the same
# weights: the kernels and the plain versions sum in other orders
HEAD_DIM_COST_RTOL = 1e-4


def head_dims(dev) -> dict:
    """B1-B3 (``tw.C4_FLASH_CASES``, ``tw.C4_WIDE_FLASH_CASES``) and B4
    (``rc.C4_CASES``, ``rc.C4_WIDE_CASES``) against their plain versions
    at head dims 12, 100, 320, 640 and 1024; a ``DecoderLM`` at head_dim
    100 (d_model 400, 4 heads) served on the card, 4 requests, tokens held
    to the greedy oracle; ``multi_head_attention`` trained at head dims
    12, 320 and 640 for 3 steps on the card against the same steps on the
    CPU path."""
    from paddle_tpu_torch.convert import decoder_lm_from_numpy, \
        init_numpy_params
    from paddle_tpu_torch.serving import DecoderLM

    c4 = tuple(tw.C4_FLASH_CASES) + tuple(tw.C4_WIDE_FLASH_CASES)
    flash = run_flash_cases(dev, c4, "head_dims", plain_events=True,
                            library=c4)
    ragged = run_kernel_cases(dev, {**rc.C4_CASES, **rc.C4_WIDE_CASES},
                              "head_dims")

    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(2, MODEL["vocab_size"], n).tolist()
               for n in (40, 300, 7, 130)]
    model = DecoderLM(vocab_size=MODEL["vocab_size"], device=dev,
                      **HEAD_DIM_SERVE)
    decoder_lm_from_numpy(init_numpy_params(model, SEED), model)
    serve_res = serve_checked(model, dev, prompts, phase="head_dims",
                              what="serve", d_model=model.embed_dim)
    del model

    trained = []
    samples = tw.lm_samples(tw.SEED + 3, bs=tw.HEAD_DIM_BATCH,
                            seq=tw.HEAD_DIM_SEQ, vocab=tw.HEAD_DIM_VOCAB)
    for d in tw.HEAD_DIM_MODELS:
        with nw.f32_policy():
            costs = {}
            for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
                sgd = tw.head_dim_trainer(where, d)
                tw.reset_flash_launches()
                costs[side], _ = _train_costs(sgd, samples,
                                              HEAD_DIM_TRAIN_STEPS)
                if side == "card":
                    used = tw.flash_launches()
        rel = [abs(a - b) / abs(b) for a, b in
               zip(costs["card"], costs["cpu"])]
        res = {"phase": "head_dims", "what": "train", "head_dim": d,
               **tw.HEAD_DIM_MODELS[d], "batch": tw.HEAD_DIM_BATCH,
               "seq": tw.HEAD_DIM_SEQ, "use_bf16": False,
               "card_costs": costs["card"], "cpu_costs": costs["cpu"],
               "max_rel_diff": max(rel), "rtol": HEAD_DIM_COST_RTOL,
               "kernel_launches": used}
        emit(res)
        if max(rel) > HEAD_DIM_COST_RTOL or not all(
                n == HEAD_DIM_TRAIN_STEPS for n in used.values()):
            raise AssertionError(f"training at head_dim {d}: the card and "
                                 "the CPU path disagree")
        trained.append(res)
    return {"flash": flash, "ragged": ragged, "serve": serve_res,
            "train": trained}


# ---------------------------------------------------------------------------
# reproducibility (C5)
# ---------------------------------------------------------------------------

def steps_equal(what: str, sgd, feeds) -> dict:
    """Two training steps from the same weights, optimizer state and
    feeds (``repro.step_twice``): the same costs and parameters to the
    bit."""
    cost_equal, differ = repro.step_twice(sgd, feeds)
    res = {"phase": "reproducible", "what": what, "cost_equal": cost_equal,
           "parameters": len(sgd.parameters.as_dict()),
           "parameters_differing": differ,
           "equal": cost_equal and not differ}
    emit(res)
    if not res["equal"]:
        raise AssertionError(f"two {what} steps from one state differ")
    return res


def generations_equal(generated) -> dict:
    """The NMT generation's two timed runs of each variant: equal tokens
    and scores, to the bit."""
    res = {"phase": "reproducible", "what": "nmt_generation",
           "runs_equal": {v: r["card_runs_equal"]
                          for v, r in generated.items()},
           "ms_per_batch_median": {v: r["ms_per_batch_median"]
                                   for v, r in generated.items()}}
    res["equal"] = all(res["runs_equal"].values())
    emit(res)
    if not res["equal"]:
        raise AssertionError("two timed generations differ")
    return res


# ---------------------------------------------------------------------------
# DeepFM at Criteo's width, sparse rows (BASELINE config #4)
# ---------------------------------------------------------------------------

CTR_STEPS = 7                # the first is the untimed warm-up
CTR_PARITY = dict(vocab=65536, batch=512, steps=3)
# card against CPU path, f32 with TF32 off, 3 Adam steps from the same
# weights and batches
CTR_COST_RTOL, CTR_PARAM_RTOL = 1e-5, 1e-4


def deepfm_parity(dev) -> dict:
    """DeepFM's f32 card path against its CPU path: 39 fields, the full
    tower, V cut to 65,536, 3 Adam steps: the costs and every parameter
    after the steps."""
    vocab, batch, steps = (CTR_PARITY[k] for k in ("vocab", "batch",
                                                   "steps"))
    data = cw.CtrData(torch.device("cpu"), steps, batch=batch, vocab=vocab)
    costs, params = {}, {}
    with nw.f32_policy():
        for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
            sgd = cw.build_trainer(where, vocab=vocab)
            costs[side] = [float(sgd.step({k: v.to(where) for k, v in
                                           data.feeds(i).items()}))
                           for i in range(steps)]
            params[side] = {k: v.detach().cpu() for k, v in
                            sgd.parameters.items()}
    rel = {k: nw.rel_norm(v, params["cpu"][k])
           for k, v in params["card"].items()}
    worst = max(rel, key=rel.get)
    cost_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(costs["card"], costs["cpu"]))
    res = {"phase": "deepfm_parity", **CTR_PARITY, "fields": cw.FIELDS,
           "factor": cw.FACTOR, "deep": cw.DEEP, "use_bf16": False,
           "card_costs": costs["card"], "cpu_costs": costs["cpu"],
           "cost_max_rel_diff": cost_rel, "param_max_rel_diff": rel[worst],
           "param_worst": worst, "cost_rtol": CTR_COST_RTOL,
           "param_rtol": CTR_PARAM_RTOL}
    emit(res)
    if cost_rel > CTR_COST_RTOL or rel[worst] > CTR_PARAM_RTOL:
        raise AssertionError("the card's DeepFM steps and the CPU path's "
                             "disagree")
    return res


def train_deepfm(dev, card: str):
    """DeepFM at Criteo's width through ``SGD.train`` on one batch
    repeated: a warm-up and 6 timed steps; finite, falling costs; step ms
    (BeginIteration to the cost on the host), examples/s, peak memory,
    launches a step and the idle share of ``SGD.step`` on device feeds.
    Returns (result, trainer, data)."""
    from paddle_tpu_torch.tools import profile_ctr

    t0 = time.perf_counter()
    sgd = cw.build_trainer(dev)
    data = cw.CtrData(dev, batches=1)
    samples = data.samples(0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    costs, step_ms = _train_costs(sgd, samples, CTR_STEPS, cw)
    peak = torch.cuda.max_memory_allocated() / 2**30
    feeds = data.feeds(0)
    wall = profiling.step_wall_ms(sgd, feeds, 2)
    profiling.ranged_optimizer(sgd)
    prof = profile_image.profile_steps(sgd, feeds, steps=2)
    br = profiling.breakdown(prof, 2, wall, profile_ctr.group,
                             profile_ctr.GROUPS)
    med = float(np.median(step_ms[1:]))
    res = {"phase": "train_deepfm", "vocab": cw.VOCAB, "fields": cw.FIELDS,
           "factor": cw.FACTOR, "deep": cw.DEEP, "batch": cw.BATCH,
           "steps": CTR_STEPS, "costs": costs, "step_ms": step_ms,
           "step_ms_median": med, "examples_per_s": cw.BATCH / (med / 1e3),
           "peak_memory_gb": peak,
           "launches_per_step": br["kernel_launches"],
           "sgd_step_ms": wall, "device_busy_ms": br["device_busy_ms"],
           "idle_share": br["idle_share"],
           "device_ms_by_group": br["device_ms_by_group"],
           "parameters": sum(p.numel() for p in
                             sgd.parameters.as_dict().values()),
           "setup_s": setup_s, "nvidia_smi": card}
    emit(res)
    if not all(np.isfinite(costs)) or not costs[-1] < costs[0]:
        raise AssertionError(f"DeepFM did not learn: costs {costs}")
    return res, sgd, data


SPARSE_LR = 0.05
# the SGD row update against the dense step, absolute: the dense gradient
# sums each id's rows with index_put's atomics, the row update in slot
# order; at up to ~700 rows of one id (the numeric fields' first ids) the
# two f32 sums part by ~1e-5 of a gradient element of ~30
SPARSE_ATOL = 1e-5


def sparse_rows(dev, table, ids) -> dict:
    """``sgd_update_rows``, ``adagrad_update_rows`` and
    ``SparseEmbeddingUpdater.apply`` on copies of the full-width
    ``deepfm.v`` table with one batch's ids and random rows: against the
    dense step (a dense gradient summed with ``index_put``; for Adagrad
    the rows' own combined gradient) on the touched rows, untouched rows
    bit-identical; card ms of each (CUDA events, back to back)."""
    from paddle_tpu_torch.parallel import sparse as sp

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    ids = ids.reshape(-1).long()
    rows = torch.randn((ids.numel(), table.shape[1]), generator=gen,
                       device=dev)
    dense_g = torch.zeros_like(table).index_put_((ids,), rows,
                                                 accumulate=True)
    touched = torch.zeros(table.shape[0], dtype=torch.bool, device=dev)
    touched[ids] = True
    grad = sp.SelectedRows(ids, rows, table.shape[0])

    def held(got, want, name) -> dict:
        err = float((got[touched] - want[touched]).abs().max())
        same = bool(torch.equal(got[~touched], table[~touched]))
        return {f"{name}_max_abs_err": err,
                f"{name}_untouched_identical": same,
                f"{name}_ok": err <= SPARSE_ATOL and same}

    res = {"phase": "sparse_rows", "rows": table.shape[0],
           "dim": table.shape[1], "ids": ids.numel(),
           "distinct_ids": int(touched.sum()), "lr": SPARSE_LR}
    with torch.no_grad():
        t = sp.sgd_update_rows(table.clone(), grad, SPARSE_LR)
        res.update(held(t, table - SPARSE_LR * dense_g, "sgd"))
        # Adagrad's first step, lr g / (|g| + eps), magnifies the sums'
        # rounding where g is near 0: it is held against the dense step on
        # the row update's own combined gradient
        combined = grad.to_dense()
        acc = torch.zeros_like(table)
        t, _ = sp.adagrad_update_rows(table.clone(), acc, grad, SPARSE_LR)
        want = table - SPARSE_LR * combined / (combined.square().sqrt() +
                                               1e-6)
        res.update(held(t, want, "adagrad"))
        upd = sp.SparseEmbeddingUpdater(sparse_params=("deepfm.v",))
        t = upd.apply({"deepfm.v": table.clone()}, {"deepfm.v": dense_g},
                      SPARSE_LR, ids={"deepfm.v": ids})["deepfm.v"]
        res.update(held(t, table - SPARSE_LR * dense_g, "updater"))
        work, acc = table.clone(), torch.zeros_like(table)
        res["sgd_ms"] = time_ms(lambda: sp.sgd_update_rows(
            work, grad, SPARSE_LR), reps=10)
        res["adagrad_ms"] = time_ms(lambda: sp.adagrad_update_rows(
            work, acc, grad, SPARSE_LR), reps=10)
        res["updater_ms"] = time_ms(lambda: upd.apply(
            {"deepfm.v": work}, {"deepfm.v": dense_g}, SPARSE_LR,
            ids={"deepfm.v": ids}), reps=10)
        res["dense_sgd_ms"] = time_ms(lambda: work.sub_(
            SPARSE_LR * dense_g), reps=10)
    emit(res)
    if not all(res[f"{n}_ok"] for n in ("sgd", "adagrad", "updater")):
        raise AssertionError("a sparse row update disagrees with the dense "
                             "step")
    return res


# ---------------------------------------------------------------------------
# GAN, VAE, traffic (BASELINE config #5)
# ---------------------------------------------------------------------------

GAN_PAIRS = 20
SMALL_STEPS = 20


def train_gan(dev, card: str) -> list:
    """Both GAN widths, 20 alternating (d, g) step pairs through
    ``MultiTaskTrainer``: the first d step leaves every ``gen_*`` tensor
    bit-identical and the first g step every ``dis_*`` one; finite costs;
    at MNIST's width ``d_cost``'s last 5 below its first 3; ms a pair."""
    out = []
    for width in gw.GAN_WIDTHS:
        t, params = gw.build_gan(width, dev)
        data = gw.gan_data(width, GAN_PAIRS, dev)
        masked = {}
        d_costs, g_costs, pair_ms = [], [], []
        for i in range(GAN_PAIRS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for task, other in (("d", "gen_"), ("g", "dis_")):
                if i == 0:
                    before = {k: v.detach().clone() for k, v in
                              params.items() if k.startswith(other)}
                cost = t.step(task, gw.gan_feeds(data, i, task))
                (d_costs if task == "d" else g_costs).append(cost)
                if i == 0:
                    masked[task] = all(torch.equal(params[k].detach(), v)
                                       for k, v in before.items())
            pair_ms.append(1e3 * (time.perf_counter() - t0))
        first, last = float(np.mean(d_costs[:3])), float(np.mean(d_costs[-5:]))
        res = {"phase": "train_gan", "width": width,
               **gw.GAN_WIDTHS[width], "batch": gw.BATCH, "pairs": GAN_PAIRS,
               "d_costs": d_costs, "g_costs": g_costs,
               "d_cost_first3_mean": first, "d_cost_last5_mean": last,
               "d_step_leaves_gen_identical": masked["d"],
               "g_step_leaves_dis_identical": masked["g"],
               "pair_ms": pair_ms,
               "pair_ms_median": float(np.median(pair_ms[1:])),
               "steps_run": [t.steps_run("d"), t.steps_run("g")],
               "nvidia_smi": card}
        emit(res)
        if not (masked["d"] and masked["g"]) or not all(
                np.isfinite(d_costs + g_costs)):
            raise AssertionError(f"GAN {width}: masking or costs wrong")
        if width == "mnist" and not last < first:
            raise AssertionError(f"GAN {width}: d_cost did not fall")
        out.append(res)
    return out


def _train_steps(sgd, feeds):
    """A step per feed dict; costs and host ms, each to the cost on the
    host."""
    costs, ms = [], []
    for f in feeds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        costs.append(float(sgd.step(f)))
        ms.append(1e3 * (time.perf_counter() - t0))
    return costs, ms


def train_small(dev, card: str) -> list:
    """The VAE (784/128/100) and traffic_prediction (24 horizons), 20
    steps each: finite costs, the last 5's mean below the first 3's; ms a
    step."""
    out = []
    for name, build, feeds, cfg in (
            ("train_vae", gw.build_vae, gw.vae_feeds, gw.VAE),
            ("train_traffic", gw.build_traffic, gw.traffic_feeds,
             gw.TRAFFIC)):
        sgd = build(dev)
        costs, ms = _train_steps(sgd, feeds(SMALL_STEPS, dev))
        res = {"phase": name, **cfg, "batch": gw.BATCH,
               "steps": SMALL_STEPS, "costs": costs, "step_ms": ms,
               "step_ms_median": float(np.median(ms[1:])),
               "nvidia_smi": card}
        emit(res)
        if not all(np.isfinite(costs)) or \
                not np.mean(costs[-5:]) < np.mean(costs[:3]):
            raise AssertionError(f"{name} did not learn: costs {costs}")
        out.append(res)
    return out


# ---------------------------------------------------------------------------
# the CRF taggers, quick_start and the nested groups (seventh slice)
# ---------------------------------------------------------------------------

SRL_STEPS = 7            # the first is the untimed warm-up
SRL_PROFILED_STEPS = 1   # its events take ~10 s to walk a step
DECODE_RUNS = 3          # timed decodes, after one warm-up
PARITY_STEPS_SEQ = 3
# card against CPU, f32 with TF32 off, 3 steps from the same weights: B5
# and the plain cell sum h W_h in other orders, the rest is the same torch
# code: costs within 1e-4 relative, every parameter within 1e-4 relative
# in norm; decoded paths equal
SEQ_COST_RTOL, SEQ_PARAM_RTOL = 1e-4, 1e-4
TAGGER_STEPS = 6
QUICK_START_STEPS = 4
# the beam cost on the card against the CPU: costs 1e-5 relative,
# gradients 1e-5 relative and 1e-6 absolute
BEAM_RTOL, BEAM_ATOL = 1e-5, 1e-6


def _lstm_launches() -> int:
    return rw.launches()["lstm_step"]


def _data_names(sgd):
    return [n.name for n in sgd.topology.data_nodes]


def _cpu_copy(params):
    return parameters_from_numpy(
        {k: v.detach().cpu().numpy() for k, v in params.as_dict().items()},
        device="cpu")


def _decode_on_both(decoded, sgd, batch, dev):
    """The card's decoded paths, the CPU path's on a copy of the same
    weights, and the card's ms a batch (one warm-up, then
    :data:`DECODE_RUNS` timed runs, each to the paths on the host)."""
    names = _data_names(sgd)
    got = sw.decode(decoded, sgd.parameters, batch, names, dev)
    before = _lstm_launches()
    ms = []
    for _ in range(DECODE_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sw.decode(decoded, sgd.parameters, batch, names, dev)
        ms.append(1e3 * (time.perf_counter() - t0))
    launched = (_lstm_launches() - before) / DECODE_RUNS
    want = sw.decode(decoded, _cpu_copy(sgd.parameters), batch, names,
                     torch.device("cpu"))
    return got, want, ms, launched


def srl_parity(dev) -> dict:
    """SRL at ``sw.PARITY`` (depth 3, hidden 32, vocab 512), f32: 3
    steps on the card against the same steps on the CPU path, from the
    same weights on the same batch; then both decode it."""
    batch = sw.srl_batch(sw.PARITY)
    runs = {}
    with nw.f32_policy():
        for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
            sgd, dec = sw.build_srl(where, sw.PARITY)
            before = _lstm_launches()
            costs = (_train_costs(sgd, batch, PARITY_STEPS_SEQ, sw)[0]
                     if side == "card" else
                     _cpu_steps(sgd, batch, PARITY_STEPS_SEQ, sw))
            paths = sw.decode(dec, sgd.parameters, batch, _data_names(sgd),
                              where)
            runs[side] = (sgd, [float(c) for c in costs], paths,
                          _lstm_launches() - before)
    (csgd, ccosts, cpaths, launched), (psgd, pcosts, ppaths, _) = \
        runs["card"], runs["cpu"]
    rel = [abs(a - b) / abs(b) for a, b in zip(ccosts, pcosts)]
    params = {k: _rel_norm(csgd.parameters[k].detach().cpu(), v.detach())
              for k, v in psgd.parameters.as_dict().items()}
    frames = sw.frames(batch)
    expected = sw.PARITY["depth"] * frames * (PARITY_STEPS_SEQ + 1)
    res = {"phase": "srl_parity", "config": sw.PARITY, "batch": len(batch),
           "frames": frames, "steps": PARITY_STEPS_SEQ,
           "card_costs": ccosts, "cpu_costs": pcosts,
           "max_rel_diff": max(rel), "cost_rtol": SEQ_COST_RTOL,
           "max_param_rel_diff": max(params.values()),
           "param_rtol": SEQ_PARAM_RTOL,
           "paths_equal": bool(np.array_equal(cpaths, ppaths)),
           "b5_launches": launched, "b5_launches_expected": expected}
    emit(res)
    if max(rel) > SEQ_COST_RTOL or max(params.values()) > SEQ_PARAM_RTOL \
            or not res["paths_equal"] or launched != expected:
        raise AssertionError("SRL: the card and the CPU path disagree")
    return res


def train_srl(dev, card: str) -> dict:
    """SRL at the book's width (``sw.BOOK``: depth 8, LSTMs of 128,
    dictionaries 44068/59/3162), batch 10, ``Momentum(0, 1e-3)``: a
    warm-up and 6 timed ``SGD.train`` steps on one batch (finite, falling
    costs; B5 launched 8 x frames a step), a profiled step (the card time
    by group, the idle share), then ``crf_decoding`` through
    ``Inference``: ms a batch, paths equal to the CPU path's."""

    t0 = time.perf_counter()
    sgd, decoded = sw.build_srl(dev)
    batch = sw.srl_batch()
    frames = sw.frames(batch)
    tokens = sum(len(s[0]) for s in batch)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    rw.reset_launches()
    costs, step_ms = _train_costs(sgd, batch, SRL_STEPS, sw)
    used = rw.launches()
    depth = sw.BOOK["depth"]
    expected = {k: (depth * frames * SRL_STEPS if k == "lstm_step" else 0)
                for k in used}
    med = float(np.median(step_ms[1:]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    profiling.ranged_optimizer(sgd)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with sw.ranged_crf(), torch.profiler.profile(activities=acts,
                                                 acc_events=True) as prof:
        _train_costs(sgd, batch, SRL_PROFILED_STEPS, sw)
    breakdown = sw.breakdown(prof, SRL_PROFILED_STEPS, med,
                             "lstm_step_kernel")
    got, want, dec_ms, dec_launches = _decode_on_both(decoded, sgd, batch,
                                                      dev)
    res = {"phase": "train_srl", "config": sw.BOOK, "batch": len(batch),
           "tokens": tokens, "frames": frames,
           "optimizer": {"momentum": sw.SRL_MOMENTUM,
                         "learning_rate": sw.SRL_LEARNING_RATE},
           "steps": SRL_STEPS, "costs": costs, "step_ms": step_ms,
           "ms_per_step": med, "sentences_per_s": len(batch) / (med / 1e3),
           "tokens_per_s": tokens / (med / 1e3), "peak_memory_gb": peak,
           "parameters": sum(p.numel() for p in
                             sgd.parameters.as_dict().values()),
           "setup_s": setup_s, "kernel_launches": used,
           "launches_expected": expected,
           "b5_launches_per_step": used["lstm_step"] / SRL_STEPS,
           "profile": breakdown,
           "decode_ms": dec_ms,
           "decode_ms_median": float(np.median(dec_ms)),
           "decode_b5_launches": dec_launches,
           "decode_paths_equal_cpu": bool(np.array_equal(got, want)),
           "nvidia_smi": card}
    emit(res)
    if not all(np.isfinite(costs)) or not costs[-1] < costs[0]:
        raise AssertionError(f"SRL did not learn: {costs}")
    if used != expected or not res["decode_paths_equal_cpu"]:
        raise AssertionError("SRL: launches or decoded paths wrong")
    return res


def train_chunker(dev, card: str) -> dict:
    """The CoNLL-2000 chunker (23 tags), batch 64, Adam 1e-3, 6 steps on
    one batch with ``evaluator.chunk`` (IOB, 11 types) over its decoded
    tags as an extra layer, then its decode against the CPU path's."""
    sgd, decoded = sw.build_chunker(dev, chunk_f1=True)
    batch = sw.chunk_batch()
    metrics = []
    costs, step_ms = _train_costs(sgd, batch, TAGGER_STEPS, sw, metrics)
    got, want, dec_ms, _ = _decode_on_both(decoded, sgd, batch, dev)
    med = float(np.median(step_ms[1:]))
    res = {"phase": "train_chunker", "config": sw.CHUNK,
           "batch": len(batch), "steps": TAGGER_STEPS, "costs": costs,
           "step_ms": step_ms, "ms_per_step": med,
           "sentences_per_s": len(batch) / (med / 1e3),
           "decode_ms_median": float(np.median(dec_ms)),
           "decode_paths_equal_cpu": bool(np.array_equal(got, want)),
           "chunk_f1": [m["chunk_f1"] for m in metrics],
           "chunk_types": sw.CHUNK_TYPES, "nvidia_smi": card}
    emit(res)
    if not all(np.isfinite(costs)) or not costs[-1] < costs[0] or \
            not res["decode_paths_equal_cpu"] or \
            not all(0.0 <= f <= 1.0 for f in res["chunk_f1"]):
        raise AssertionError("chunker: costs, decoded paths or F1 wrong")
    return res


# LSTM layers of each quick_start architecture
QS_LSTM_LAYERS = {"lstm": 1, "bidi_lstm": 2, "db_lstm": 4, "resnet_lstm": 4}


def train_quick_start(dev, card: str) -> list:
    """Every quick_start architecture at the demo's width (dict 30000,
    embedding 128), batch 128 of reviews of 10-100 tokens, Adam 2e-3, 4
    steps on one batch: finite, falling costs; B5 launched layers x 128
    frames a step; ms a batch and samples/s."""
    out = []
    for arch in qw.quick_start.ARCHS:
        sgd, _ = qw.build_trainer(arch, dev)
        batch = qw.batch(arch)
        rw.reset_launches()
        costs, step_ms = _train_costs(sgd, batch, QUICK_START_STEPS, qw)
        launched = _lstm_launches()
        expected = QS_LSTM_LAYERS.get(arch, 0) * QUICK_START_STEPS * (
            sw.frames(batch) if arch != "lr" else 0)
        med = float(np.median(step_ms[1:]))
        res = {"phase": "train_quick_start", "arch": arch, **qw.DEMO,
               "batch": qw.BATCH, "steps": QUICK_START_STEPS,
               "costs": costs, "step_ms": step_ms, "ms_per_batch": med,
               "samples_per_s": qw.BATCH / (med / 1e3),
               "b5_launches": launched, "b5_launches_expected": expected,
               "nvidia_smi": card}
        emit(res)
        if not all(np.isfinite(costs)) or not costs[-1] < costs[0] or \
                launched != expected:
            raise AssertionError(f"quick_start {arch}: costs or launches "
                                 "wrong")
        out.append(res)
        del sgd
    return out


def nested_groups(dev) -> dict:
    """The hierarchical groups (``tools/nested_workload``) at width 128,
    fed through the sub-sequence slot: 3 Adam steps on the card against
    the CPU path, f32; then ``cross_entropy_over_beam`` on its cases,
    costs and gradients, card against CPU."""
    groups = []
    docs = nestw.documents()
    with nw.f32_policy():
        for config in nestw.CONFIGS:
            costs = {}
            for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
                sgd = nestw.build_trainer(config, where)
                costs[side] = [float(c) for c in (
                    _train_costs(sgd, docs, PARITY_STEPS_SEQ, nestw)[0]
                    if side == "card" else
                    _cpu_steps(sgd, docs, PARITY_STEPS_SEQ, nestw))]
            rel = [abs(a - b) / abs(b) for a, b in
                   zip(costs["card"], costs["cpu"])]
            res = {"phase": "nested_groups", "config": config,
                   "width": nestw.WIDTH, "batch": nestw.BATCH,
                   "card_costs": costs["card"], "cpu_costs": costs["cpu"],
                   "max_rel_diff": max(rel), "rtol": SEQ_COST_RTOL}
            emit(res)
            if max(rel) > SEQ_COST_RTOL or not all(
                    np.isfinite(costs["card"])):
                raise AssertionError(f"nested {config}: the card and the "
                                     "CPU path disagree")
            groups.append(res)
    beams = []
    for name, case in nestw.beam_cases().items():
        card_cost, card_grads = nestw.beam_cost_and_grads(case, dev)
        cpu_cost, cpu_grads = nestw.beam_cost_and_grads(case, "cpu")
        cost_ok = np.allclose(card_cost, cpu_cost, rtol=BEAM_RTOL, atol=0)
        grad_err = max(float(np.abs(a - b).max())
                       for a, b in zip(card_grads, cpu_grads))
        grads_ok = all(np.allclose(a, b, rtol=BEAM_RTOL, atol=BEAM_ATOL)
                       for a, b in zip(card_grads, cpu_grads))
        res = {"phase": "beam_cost", "case": name,
               "card_costs": card_cost.tolist(),
               "cpu_costs": cpu_cost.tolist(),
               "max_grad_abs_diff": grad_err,
               "within_tolerance": bool(cost_ok and grads_ok)}
        emit(res)
        if not res["within_tolerance"]:
            raise AssertionError(f"beam cost {name}: card and CPU differ")
        beams.append(res)
    return {"groups": groups, "beams": beams}


# ---------------------------------------------------------------------------
# the transformer family: the LM's levers, translation, decoding (eighth
# slice)
# ---------------------------------------------------------------------------

LEVERS = (("fused", dict(fused_head=True)),
          ("fused_remat_dropout", dict(fused_head=True, remat=True,
                                       dropout=0.1)))
# the fused head's first costs against the unfused run's: the bf16
# policy's bound for a training cost (tests/test_torch_train.py)
LEVER_COST_RTOL = 2e-3
TNMT_STEPS = 7           # the first is the untimed warm-up
TNMT_PROFILED_STEPS = 1
TNMT_PARITY_STEPS = 3
# card against CPU, f32 with TF32 off, 3 Adam steps from the same weights:
# the flash kernels and cuBLAS sum in other orders; costs within 1e-4
# relative, every parameter within 1e-4 relative in norm
TNMT_COST_RTOL, TNMT_PARAM_RTOL = 1e-4, 1e-4
TEMPERATURE_TOKENS = 16


def train_lm_levers(dev, card: str, unfused: dict) -> list:
    """The training headline (``tw.MODEL``, 8 x 1024 tokens,
    ``Momentum(0.9, 1e-3)``) with ``fused_head=True``, then with
    ``fused_head=True, remat=True, dropout=0.1``, each for
    :data:`TRAIN_STEPS` steps beside the unfused ``train`` run: step ms,
    tokens/s, peak memory, flash launches (the recompute runs each
    block's forward again: B1 twice a block a step under remat).  The
    fused run's first 3 costs lie within :data:`LEVER_COST_RTOL` of the
    unfused run's."""
    samples = tw.lm_samples(tw.SEED + 1)
    out = []
    for name, levers in LEVERS:
        sgd = tw.build_trainer(dev, **levers)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tw.reset_flash_launches()
        costs, step_ms = _train_costs(sgd, samples, TRAIN_STEPS)
        launches = tw.flash_launches()
        del sgd
        torch.cuda.empty_cache()
        med = float(np.median(step_ms[1:]))
        n = tw.MODEL["n_layers"] * TRAIN_STEPS
        expected = {"flash_fwd": n * (2 if levers.get("remat") else 1),
                    "flash_bwd_kv": n, "flash_bwd_dq": n}
        rel = [abs(a - b) / abs(b) for a, b in
               zip(costs[:3], unfused["costs"][:3])]
        res = {"phase": "train_lm_levers", "run": name, **levers,
               "model": tw.MODEL, "batch": tw.BATCH, "seq": tw.SEQ,
               "steps": TRAIN_STEPS, "costs": costs, "step_ms": step_ms,
               "step_ms_median": med,
               "tokens_per_s": tw.BATCH * tw.SEQ / (med / 1e3),
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
               "unfused": {k: unfused[k] for k in
                           ("step_ms_median", "tokens_per_s",
                            "peak_memory_gb")},
               "first_costs_rel_diff_to_unfused": rel,
               "kernel_launches": launches,
               "launches_expected": expected, "nvidia_smi": card}
        emit(res)
        if not all(np.isfinite(costs)) or not costs[-1] < costs[0]:
            raise AssertionError(f"{name}: did not learn: costs {costs}")
        if launches != expected:
            raise AssertionError(f"{name}: flash launches {launches}, "
                                 f"expected {expected}")
        if name == "fused" and max(rel) > LEVER_COST_RTOL:
            raise AssertionError(f"the fused head's costs {costs[:3]} part "
                                 f"from the unfused {unfused['costs'][:3]}")
        out.append(res)
    return out


def transformer_nmt_parity(dev) -> dict:
    """``build_seq2seq`` at ``tnw.PARITY`` (d 64, 2 + 2 blocks, 4 heads,
    vocab 512) in f32, batch 16 of lengths 10-80: 3 Adam steps on the
    card (B1-B3 on the CUDA-core route) against the same steps on the CPU
    path, from the same weights: costs and every parameter."""
    batch = tnw.samples(tnw.SEED + 3, bs=tnw.PARITY_BATCH,
                        dict_size=tnw.PARITY["trg_vocab"])
    runs = {}
    with nw.f32_policy():
        for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
            sgd = tnw.build_trainer(where, config=tnw.PARITY)
            tw.reset_flash_launches()
            runs[side] = (sgd, _cpu_steps(sgd, batch, TNMT_PARITY_STEPS,
                                          tnw), tw.flash_launches())
    (csgd, ccosts, launched), (psgd, pcosts, _) = runs["card"], runs["cpu"]
    rel = [abs(a - b) / abs(b) for a, b in zip(ccosts, pcosts)]
    params = {k: _rel_norm(csgd.parameters[k].detach().cpu(), v.detach())
              for k, v in psgd.parameters.as_dict().items()}
    expected = tnw.flash_calls_per_step(tnw.PARITY) * TNMT_PARITY_STEPS
    res = {"phase": "transformer_nmt_parity", "config": tnw.PARITY,
           "batch": len(batch), "steps": TNMT_PARITY_STEPS,
           "use_bf16": False, "card_costs": ccosts, "cpu_costs": pcosts,
           "max_rel_diff": max(rel), "cost_rtol": TNMT_COST_RTOL,
           "max_param_rel_diff": max(params.values()),
           "worst_param": max(params, key=params.get),
           "param_rtol": TNMT_PARAM_RTOL, "kernel_launches": launched,
           "launches_expected": expected}
    emit(res)
    if max(rel) > TNMT_COST_RTOL or \
            max(params.values()) > TNMT_PARAM_RTOL or \
            any(n != expected for n in launched.values()):
        raise AssertionError("the translation model: the card and the CPU "
                             "path disagree")
    return res


def train_transformer_nmt(dev, card: str) -> dict:
    """Transformer-base translation at its configuration
    (``tnw.MODEL``, batch 80 of lengths 10-80, Adam as in the paper, the
    bf16 policy) through ``SGD.train`` on one batch, a warm-up and 6
    timed steps: finite, falling costs; each flash kernel launched 18
    times a step; step ms, target tokens/s, peak memory; then one step
    profiled (``tools/profile_transformer_nmt``): the idle share,
    launches a step and the card time by group."""
    t0 = time.perf_counter()
    sgd = tnw.build_trainer(dev)
    batch = tnw.samples(tnw.SEED + 1)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    tw.reset_flash_launches()
    costs, step_ms = _train_costs(sgd, batch, TNMT_STEPS, tnw)
    launches = tw.flash_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = float(np.median(step_ms[1:]))
    profile = ptn.profile_steps(sgd, tnw.feeds(sgd, batch),
                                TNMT_PROFILED_STEPS, med)
    expected = tnw.flash_calls_per_step() * TNMT_STEPS
    res = {"phase": "train_transformer_nmt", "model": tnw.MODEL,
           "batch": tnw.BATCH, "source_tokens": tnw.source_tokens(batch),
           "target_tokens": tnw.target_tokens(batch),
           "steps": TNMT_STEPS, "costs": costs, "step_ms": step_ms,
           "step_ms_median": med,
           "target_tokens_per_s": tnw.target_tokens(batch) / (med / 1e3),
           "peak_memory_gb": peak, "flash_launches": launches,
           "flash_launches_expected": expected,
           "parameters": sum(p.numel() for p in
                             sgd.parameters.as_dict().values()),
           "setup_s": setup_s, "profiled_step": profile,
           "nvidia_smi": card}
    emit(res)
    del sgd
    torch.cuda.empty_cache()
    if not all(np.isfinite(costs)) or not costs[-1] < costs[0]:
        raise AssertionError(f"the translation model did not learn: costs "
                             f"{costs}")
    if any(n != expected for n in launches.values()):
        raise AssertionError(f"flash launches {launches}, expected "
                             f"{expected} each")
    return res


def _wall(fn):
    """(fn's result, its wall ms, the peak memory it reached in GB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, 1e3 * (time.perf_counter() - t0),
            torch.cuda.max_memory_allocated() / 2**30)


def _launches_per_step(fn, steps: int) -> float:
    """CUDA kernel launches a decode step of ``fn`` (``steps`` steps)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(c for _, _, c in profile_image._kernels(prof)) / steps


def generate_lm(dev, card: str) -> dict:
    """The training headline's parameters (``tw.MODEL``, max_len 1024,
    seed 0) decoded on the card from the parameter dict: greedy
    ``generate`` of 64 tokens after a 32-token prompt, ``beam_generate``
    at beam 4 over 32 tokens (eos 0, length penalty 1, one token banned by
    ``candidate_adjust``, every beam stopped after step 24 by
    ``stop_condition``) and ``beam_generate_batch`` over 8 prompts:
    ms a token, tokens/s, launches a step, peak memory.  Checks: the
    greedy tokens replayed on the CPU path at full width in one pass
    (argmax or a near tie at each position), the batch against per-prompt
    runs on the card, the beam hooks honoured, and two temperature-1.0
    runs from one seed the same tokens.  (The CPU path's own beam run at
    full width, ~30 s of the host's CPU, was cut for the script's clock;
    ``tests/test_torch_transformer_cuda.py`` holds beam search card
    against CPU at a small width.)"""
    from paddle_tpu_torch.models import transformer as T

    kw = tw.decode_kw()
    params = tw.decode_params(dev)
    prompt = tw.decode_prompts(tw.SEED + 7, 1)[0]
    steps = tw.DECODE_PROMPT + tw.DECODE_NEW - 1
    T.generate(params, prompt[:4], 4, **kw)              # warm-up
    greedy, greedy_ms, greedy_gb = _wall(lambda: T.generate(
        params, prompt, tw.DECODE_NEW, **kw))
    greedy_launches = _launches_per_step(
        lambda: T.generate(params, prompt[:8], 8, **kw), 15)
    hooks = tw.BanAndStop(int(greedy[0]))
    beam_kw = dict(kw, beam_size=tw.BEAM, eos_id=tw.BEAM_EOS,
                   length_penalty=1.0)
    T.beam_generate(params, prompt[:4], 4, **beam_kw, **hooks.hooks())
    (btoks, bscore), beam_ms, beam_gb = _wall(lambda: T.beam_generate(
        params, prompt, tw.BEAM_NEW, **beam_kw, **hooks.hooks()))
    beam_launches = _launches_per_step(lambda: T.beam_generate(
        params, prompt[:8], 8, **beam_kw, **hooks.hooks()), 15)
    prompts = tw.decode_prompts(tw.SEED + 8, tw.BEAM_BATCH)
    (ttoks, tscores), batch_ms, batch_gb = _wall(
        lambda: T.beam_generate_batch(params, prompts, tw.BEAM_NEW,
                                      **beam_kw, **hooks.hooks()))
    batch_check = []
    for i, pr in enumerate(prompts):
        rec = tw.BanAndStop(hooks.banned, record=True)
        single = T.beam_generate(params, pr, tw.BEAM_NEW, **beam_kw,
                                 **rec.hooks())
        batch_check.append(tw.beams_agree((ttoks[i], tscores[i]), single,
                                          rec.gaps))
    draws = [T.generate(params, prompt, TEMPERATURE_TOKENS, **kw,
                        temperature=1.0, rng=tw.SEED + 9).tolist()
             for _ in range(2)]
    # the CPU path at full width, on a copy of the weights
    t0 = time.perf_counter()
    cpu = {k: v.detach().cpu() for k, v in params.items()}
    del params
    torch.cuda.empty_cache()
    greedy_replay = tw.replay_greedy(cpu, prompt, greedy.tolist(), **kw)
    del cpu
    cpu_s = time.perf_counter() - t0
    stopped = btoks[hooks.stop_at + 1:]
    res = {"phase": "generate_lm", "model": tw.MODEL,
           "greedy": {"prompt": tw.DECODE_PROMPT, "new": tw.DECODE_NEW,
                      "ms": greedy_ms, "ms_per_step": greedy_ms / steps,
                      "ms_per_new_token": greedy_ms / tw.DECODE_NEW,
                      "tokens_per_s": tw.DECODE_NEW / (greedy_ms / 1e3),
                      "launches_per_step": greedy_launches,
                      "peak_memory_gb": greedy_gb, "cpu_replay":
                      greedy_replay},
           "beam": {"beam": tw.BEAM, "new": tw.BEAM_NEW, "ms": beam_ms,
                    "ms_per_new_token": beam_ms / tw.BEAM_NEW,
                    "tokens_per_s": tw.BEAM_NEW / (beam_ms / 1e3),
                    "launches_per_step": beam_launches,
                    "peak_memory_gb": beam_gb, "score": bscore,
                    "banned": hooks.banned},
           "batch": {"prompts": tw.BEAM_BATCH, "ms": batch_ms,
                     "ms_per_new_token": batch_ms / tw.BEAM_NEW,
                     "tokens_per_s": tw.BEAM_BATCH * tw.BEAM_NEW /
                     (batch_ms / 1e3), "peak_memory_gb": batch_gb,
                     "against_single": batch_check},
           "temperature_draws_equal": draws[0] == draws[1],
           "cpu_replay_s": cpu_s, "nvidia_smi": card}
    emit(res)
    if not greedy_replay["ok"]:
        raise AssertionError("greedy decoding: the card and the CPU path "
                             "disagree")
    if not all(c["ok"] for c in batch_check):
        raise AssertionError("beam_generate_batch differs from "
                             "beam_generate")
    if hooks.banned in btoks.tolist() or (stopped != tw.BEAM_EOS).any():
        raise AssertionError("the beam hooks were not honoured")
    if draws[0] != draws[1]:
        raise AssertionError("two draws from one seed differ")
    return res


def _cpu_steps(sgd, batch, steps, workload):
    from paddle_tpu_torch import event

    costs = []
    sgd.train(workload.repeat_reader(batch, steps), event_handler=lambda ev:
              costs.append(float(ev.cost))
              if isinstance(ev, event.EndIteration) else None,
              feeding=workload.FEEDING)
    return costs


# ---------------------------------------------------------------------------
# the v2 loop: readers, datasets, evaluators, optimizers, prefetch
# ---------------------------------------------------------------------------

class _PassClock:
    """An event handler that keeps every EndIteration and EndPass event
    (read after the run, so the loop never waits for the card) and times
    each pass on the host clock: from BeginPass to the test reader's first
    call (the card drained first), and the test pass from there to
    EndPass."""

    def __init__(self):
        self.iters, self.passes, self.train_s, self.test_s = [], [], [], []
        self._t = 0.0

    def __call__(self, ev):
        from paddle_tpu_torch import event

        if isinstance(ev, event.BeginPass):
            torch.cuda.synchronize()
            self._t = time.perf_counter()
        elif isinstance(ev, event.EndIteration):
            self.iters.append(ev)
        elif isinstance(ev, event.EndPass):
            now = time.perf_counter()
            if len(self.train_s) == len(self.passes):   # no test reader
                self.train_s.append(now - self._t)
            else:
                self.test_s.append(now - self._t)
            self.passes.append(ev)

    def test_reader(self, reader):
        def timed():
            torch.cuda.synchronize()
            now = time.perf_counter()
            self.train_s.append(now - self._t)
            self._t = now
            return reader()
        return timed

    def costs(self):
        return [ev.cost for ev in self.iters]


def _in_unit(metrics: list) -> bool:
    return all(0.0 <= v <= 1.0 for m in metrics for v in m.values())


def _optimizer_range(sgd, feeds, steps: int = 2):
    """({launches, card_ms} a step inside the optimizer's profiler range,
    the profile) over ``steps`` ``SGD.step`` s after one unprofiled
    step (``profiling.ranged_optimizer``'s range)."""
    apply = sgd.optimizer.apply
    profiling.ranged_optimizer(sgd)
    sgd.step(feeds)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(steps):
            sgd.step(feeds)
        torch.cuda.synchronize()
    sgd.optimizer.apply = apply
    inside = [us for us, chain in profiling.launched(prof)
              if profiling.OPTIMIZER_RANGE in chain]
    return {"launches": len(inside) / steps,
            "card_ms": sum(inside) / 1e3 / steps}, prof


def _levers_off(opt, **off):
    """Set ``opt``'s attributes to ``off`` and return the old values."""
    old = {k: getattr(opt, k) for k in off}
    for k, v in off.items():
        setattr(opt, k, v)
    return old


SENTIMENT_PLAIN_STEPS = 8


def v2_sentiment(dev, card: str) -> dict:
    """IMDB sentiment through the whole v2 loop (``tools/v2_loop_workload``)
    at bench.py's text_lstm width: two passes at prefetch 2 with the test
    reader, then ``test``; the first 8 steps again from the same weights
    and shuffle at prefetch 0 (the same cost bits); B5's launches against
    2 layers x each batch's frames; the launches L2 and model averaging
    add to Adam's update; a profiled step's idle share."""
    import random

    from paddle_tpu_torch import reader
    from paddle_tpu_torch.dataset import imdb
    from paddle_tpu_torch.tools import profile_ctr
    from paddle_tpu_torch.tools import v2_loop_workload as vw

    t0 = time.perf_counter()
    with vw.offline():
        word_dict = imdb.word_dict()
        train_reader, test_reader = vw.sentiment_readers(word_dict)
        one_batch = next(iter(train_reader()))
        runs = {}
        # the main run, then the first SENTIMENT_PLAIN_STEPS steps again
        # from the same weights and shuffle without prefetch
        for prefetch, passes, reader_ in (
                (2, vw.SENTIMENT_PASSES, train_reader),
                (0, 1, reader.firstn(train_reader, SENTIMENT_PLAIN_STEPS))):
            sgd = vw.sentiment_trainer(dev, len(word_dict))
            frames, test_frames = vw.FrameLog(), vw.FrameLog()
            clock = _PassClock()
            random.seed(SEED)
            torch.cuda.synchronize()
            rw.reset_launches()
            sgd.train(frames.wrap(reader_),
                      num_passes=passes, event_handler=clock,
                      feeding=vw.SENTIMENT_FEEDING, prefetch=prefetch,
                      test_reader=clock.test_reader(
                          test_frames.wrap(test_reader)))
            result = sgd.test(test_frames.wrap(test_reader),
                              feeding=vw.SENTIMENT_FEEDING)
            torch.cuda.synchronize()
            runs[prefetch] = dict(sgd=sgd, clock=clock, result=result,
                                  launches=_lstm_launches(),
                                  frames=frames.frames,
                                  test_frames=test_frames.frames)
    setup_s = time.perf_counter() - t0
    main, plain = runs[2], runs[0]
    costs, costs0 = main["clock"].costs(), plain["clock"].costs()
    steps = len(costs) // vw.SENTIMENT_PASSES
    expected = 2 * (sum(main["frames"]) + sum(main["test_frames"]))
    sgd = main["sgd"]
    feeds = sgd._make_feeder(vw.SENTIMENT_FEEDING).feed(one_batch)
    wall = profiling.step_wall_ms(sgd, feeds, 2)
    levered, prof = _optimizer_range(sgd, feeds, steps=1)
    busy = profiling.breakdown(prof, 1, wall, profile_ctr.group,
                               profile_ctr.GROUPS)
    old = _levers_off(sgd.optimizer, regularization=None, model_average=None)
    plain_adam, _ = _optimizer_range(sgd, feeds, steps=1)
    _levers_off(sgd.optimizer, **old)
    iter_metrics = [dict(ev.metrics) for ev in main["clock"].iters]
    pass_metrics = [dict(ev.metrics) for ev in main["clock"].passes]

    def per_step(run, p):
        return 1e3 * run["clock"].train_s[p] / (
            steps if run is main else len(costs0))

    res = {"phase": "v2_sentiment", "model": vw.SENTIMENT,
           "dict_size": len(word_dict), "batch": vw.SENTIMENT_BATCH,
           "passes": vw.SENTIMENT_PASSES, "steps_a_pass": steps,
           "costs_first_last": [costs[0], costs[-1]],
           "pass_mean_costs": [float(np.mean(costs[i * steps:(i + 1) *
                                                   steps]))
                               for i in range(vw.SENTIMENT_PASSES)],
           "end_pass_metrics": pass_metrics,
           "test_result": {"cost": main["result"].cost,
                           **main["result"].metrics},
           "metrics_in_unit_interval": _in_unit(iter_metrics + pass_metrics
                                                + [main["result"].metrics]),
           "ms_a_step": {"prefetch_2": [per_step(main, p) for p in
                                        range(vw.SENTIMENT_PASSES)],
                         "prefetch_0": [per_step(plain, 0)]},
           "sequences_per_s": {
               "prefetch_2": vw.SENTIMENT_BATCH * 1e3 / per_step(main, -1),
               "prefetch_0": vw.SENTIMENT_BATCH * 1e3 / per_step(plain, -1)},
           "test_pass_ms": [1e3 * s for s in main["clock"].test_s],
           "prefetch_0_same_cost_bits": costs0 == costs[:len(costs0)],
           "b5_launches": main["launches"], "b5_expected": expected,
           "frames_a_batch": sorted(set(main["frames"])),
           "optimizer_range": {"adam_l2_model_average": levered,
                               "adam": plain_adam},
           "launches_added_by_l2_and_average":
               levered["launches"] - plain_adam["launches"],
           "step_wall_ms": wall, "idle_share": busy["idle_share"],
           "device_busy_ms": busy["device_busy_ms"],
           "kernel_launches_a_step": busy["kernel_launches"],
           "setup_and_runs_s": setup_s, "nvidia_smi": card}
    emit(res)
    if not all(np.isfinite(costs)) or not \
            np.mean(costs[-8:]) < np.mean(costs[:8]):
        raise AssertionError("v2_sentiment did not learn: pass means "
                             f"{res['pass_mean_costs']}")
    if not res["metrics_in_unit_interval"]:
        raise AssertionError("v2_sentiment: a metric outside [0, 1]")
    if not res["prefetch_0_same_cost_bits"]:
        raise AssertionError("v2_sentiment: prefetch 0 and 2 differ")
    if main["launches"] != expected:
        raise AssertionError(f"v2_sentiment: B5 launched {main['launches']}"
                             f" times, expected {expected}")
    return res



def v2_resnet50(dev, card: str, device_feed: dict) -> dict:
    """ResNet-50 through a reader of flat CHW samples: a pass of 4 batches
    at prefetch 0 and one at 2, ``test`` on 2 batches (batch norm on its
    moving statistics), top-1 and top-5 errors; the card ms L2 adds to the
    optimizer's range; ``device_feed`` is train_resnet50's result (the
    device-feed ``SGD.step`` images/s beside these)."""
    from paddle_tpu_torch.tools import v2_loop_workload as vw

    t0 = time.perf_counter()
    sgd = vw.resnet_trainer(dev)
    train_b = vw.resnet_batches(SEED + 40, vw.RESNET_TRAIN_BATCHES)
    test_b = vw.resnet_batches(SEED + 50, vw.RESNET_TEST_BATCHES)
    feeds = sgd._make_feeder(None).feed(train_b[0])
    sgd.step(feeds)                       # warm-up: the L2 and schedule ops
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    passes = {}
    for prefetch in (0, 2):
        clock = _PassClock()
        sgd.train(lambda: iter(train_b), num_passes=1, event_handler=clock,
                  prefetch=prefetch)
        passes[prefetch] = clock
    result = sgd.test(lambda: iter(test_b))
    peak = torch.cuda.max_memory_allocated() / 2**30
    with_l2, _ = _optimizer_range(sgd, feeds)
    old = _levers_off(sgd.optimizer, regularization=None)
    without, _ = _optimizer_range(sgd, feeds)
    _levers_off(sgd.optimizer, **old)
    batch = iw.MODELS[vw.RESNET]["batch"]
    ips = {f"prefetch_{p}": batch * len(train_b) / c.train_s[0]
           for p, c in passes.items()}
    costs = passes[0].costs() + passes[2].costs()
    iter_metrics = [dict(ev.metrics) for c in passes.values()
                    for ev in c.iters]
    res = {"phase": "v2_resnet50", "model": vw.RESNET, "batch": batch,
           "train_batches": len(train_b), "test_batches": len(test_b),
           "optimizer": {"momentum": vw.RESNET_MOMENTUM,
                         "learning_rate": vw.RESNET_LR, "l2": vw.RESNET_L2,
                         "discexp": [vw.DISCEXP_A, vw.DISCEXP_B]},
           "costs": costs, "iteration_metrics": iter_metrics,
           "images_per_s": ips,
           "images_per_s_device_feed_step": device_feed["images_per_s"],
           "ms_a_step": {p: 1e3 / (v / batch) for p, v in ips.items()},
           "test_result": {"cost": result.cost, **result.metrics},
           "optimizer_range": {"momentum_l2": with_l2, "momentum": without},
           "card_ms_added_by_l2": with_l2["card_ms"] - without["card_ms"],
           "peak_memory_gb": peak, "setup_s": setup_s, "nvidia_smi": card}
    emit(res)
    if not all(np.isfinite(costs + [result.cost])) or not _in_unit(
            iter_metrics + [result.metrics]):
        raise AssertionError("v2_resnet50: a cost not finite or a metric "
                             "outside [0, 1]")
    if not result.metrics["top5_error"] <= result.metrics["top1_error"]:
        raise AssertionError("v2_resnet50: top-5 error above top-1")
    return res


def v2_mnist(dev, card: str) -> dict:
    """BASELINE #1: LeNet through ``batch(reader.shuffle(mnist.train(),
    8192), 128)``, the book's digits optimizer, one pass at prefetch 2,
    ``test`` on ``mnist.test()`` (error below 0.5) and ``infer`` on 16
    test images, held to the CPU path on a copy of the weights."""
    import random

    from paddle_tpu_torch.inference import infer
    from paddle_tpu_torch.dataset import mnist
    from paddle_tpu_torch.tools import v2_loop_workload as vw

    random.seed(SEED)
    with vw.offline():
        sgd, logits = vw.mnist_trainer(dev)
        train_reader, test_reader = vw.mnist_readers()
        images = [(img,) for img, _ in
                  list(mnist.test()())[:vw.MNIST_INFER]]
    clock = _PassClock()
    sgd.train(train_reader, num_passes=1, event_handler=clock, prefetch=2)
    result = sgd.test(test_reader)
    out = infer(output_layer=logits, parameters=sgd.parameters,
                input=images, model_state=sgd.model_state, device=dev)
    want = infer(output_layer=logits, parameters=_cpu_copy(sgd.parameters),
                 input=images, device="cpu")
    costs = clock.costs()
    steps = len(costs)
    res = {"phase": "v2_mnist", "model": "lenet", "batch": vw.MNIST_BATCH,
           "optimizer": {"momentum": vw.MNIST_MOMENTUM,
                         "learning_rate": vw.MNIST_LR, "l2": vw.MNIST_L2},
           "steps": steps, "costs_first_last": [costs[0], costs[-1]],
           "end_pass_metrics": dict(clock.passes[0].metrics),
           "ms_a_step": 1e3 * clock.train_s[0] / steps,
           "test_result": {"cost": result.cost, **result.metrics},
           "infer_shape": list(out.shape),
           "infer_max_abs_diff_cpu": float(np.abs(out - want).max()),
           "infer_argmax_equal_cpu": bool(np.array_equal(
               out.argmax(-1), want.argmax(-1))),
           "nvidia_smi": card}
    emit(res)
    if not result.metrics["error"] < 0.5 or not np.isfinite(out).all() or \
            out.shape != (vw.MNIST_INFER, 10):
        raise AssertionError(f"v2_mnist: test error {result.metrics} or "
                             f"infer {out.shape}")
    return res


def export_native_analysis(dev, card: str) -> dict:
    """export, native and analysis (``tools/export_workload.py``): one
    line each, each fatal on its gates; returns the analysis line (its
    drive's ragged-kernel launches and kernel check)."""
    from paddle_tpu_torch.tools import export_workload as ew

    ew.export_phase(dev, card)
    ew.native_phase(dev, card)
    return ew.analysis_phase(dev, card)[0]


def fluid_phases(dev, card: str) -> None:
    """fluid_mnist and fluid_control (``tools/fluid_workload.py``): one
    line a model and a program, each fatal on its gates."""
    from paddle_tpu_torch.tools import fluid_workload as fw

    for res in fw.fluid_mnist(dev) + fw.fluid_control(dev):
        emit(dict(res, nvidia_smi=card))


# card against the CPU path, f32 with TF32 off, 3 steps from the same
# weights on LeNet, each tensor's error in norm relative to its norm.
# On the same gradients (the CPU optimizer applies the card's) the update's
# arithmetic alone differs, held at 1e-5.  The run on each side's own
# gradients is reported, not held: cuDNN's convolutions (their algorithm
# picked by cudnn.benchmark each run) and cuBLAS's products sum in other
# orders than the CPU's; a ReLU or max-pool input near a tie, or a weight
# near 0 under L1's sign(p), that the two round to opposite sides moves a
# gradient entry, and the Adagrad family and Adam then normalize that
# entry to a full lr step (measured on an H100: 4.2e-7 to 0.114, the
# worst a 500-entry bias under Adagrad, differing from run to run)
OPT_TENSOR_RTOL = 1e-5


def optimizers(dev, card: str) -> dict:
    """Every rule with every lever on LeNet in f32, card against CPU: each
    parameter, slot, average and scalar recursion after 3 steps on the
    same gradients (held) and on each side's own (reported); the prune
    masks equal; then a mask on one tensor above 2^24 elements."""
    from paddle_tpu_torch.optimizer import quantile_f32
    from paddle_tpu_torch.tools import v2_loop_workload as vw

    rules = {}
    with nw.f32_policy():
        for rule in vw.RULES:
            same = vw.state_errors(*vw.on_both(rule, dev))
            full_card, full_cpu = vw.independent(rule, dev)
            full = vw.state_errors(full_card, full_cpu)
            worst, worst_full = max(same, key=same.get), \
                max(full, key=full.get)
            rules[rule] = {
                "tensors": len(same), "same_grads_max_err": same[worst],
                "same_grads_worst": worst,
                "own_grads_max_err": full[worst_full],
                "own_grads_worst": worst_full,
                "avg_count": float(full_card.opt_state["avg_count"])}
        sgd, feeds = vw.lever_trainer("Sgd", "cpu")
        gnorm = vw.grad_norm(sgd, feeds)
    rng = np.random.default_rng(SEED)
    big = rng.standard_normal(vw.BIG_PRUNE_SHAPE, dtype=np.float32)
    t = torch.from_numpy(big)
    thresh_cpu = quantile_f32(t.abs(), 0.6)
    thresh_card = quantile_f32(t.to(dev).abs(), 0.6)
    kept_cpu = int((t.abs() >= thresh_cpu).sum())
    kept_card = int((t.to(dev).abs() >= thresh_card).sum())
    res = {"phase": "optimizers", "model": "lenet", "f32": True,
           "steps": vw.OPT_STEPS, "learning_rate": vw.OPT_LR,
           "levers": vw.LEVERS, "param_levers": vw.PARAM_LEVERS,
           "first_grad_norm": gnorm, "rules": rules,
           "rtol_same_grads": OPT_TENSOR_RTOL,
           "big_prune": {"shape": list(vw.BIG_PRUNE_SHAPE),
                         "elements": big.size,
                         "threshold_bits_equal":
                             thresh_cpu.numpy().tobytes() ==
                             thresh_card.cpu().numpy().tobytes(),
                         "kept_cpu": kept_cpu, "kept_card": kept_card},
           "nvidia_smi": card}
    emit(res)
    bad = {r: v for r, v in rules.items()
           if not v["same_grads_max_err"] <= OPT_TENSOR_RTOL
           or not np.isfinite(v["own_grads_max_err"])}
    if bad or not gnorm > vw.LEVERS["gradient_clipping_threshold"] or \
            not res["big_prune"]["threshold_bits_equal"] or \
            kept_cpu != kept_card:
        raise AssertionError(f"optimizers: card against CPU {bad}, big "
                             f"mask {res['big_prune']}")
    return res


# card against CPU on the same samples: f32, every value within 1e-6
# relative (1e-7 absolute); counts, ranks and edit distances are exact
EVAL_RTOL, EVAL_ATOL = 1e-6, 1e-7


def evaluators(dev, card: str) -> dict:
    """Every case of ``v2_loop_workload.EVALUATOR_CASES`` on the card
    against the CPU path: values, the trainer's metric, the printers'
    text."""
    from paddle_tpu_torch.tools import v2_loop_workload as vw

    cases, bad = {}, []
    for name in sorted(vw.EVALUATOR_CASES):
        got, metric, text = vw.evaluate(name, dev)
        want, want_metric, want_text = vw.evaluate(name, "cpu")
        ok = got.shape == want.shape and np.allclose(
            got, want, rtol=EVAL_RTOL, atol=EVAL_ATOL) and np.isclose(
            metric, want_metric, rtol=EVAL_RTOL, atol=EVAL_ATOL) and \
            text == want_text
        cases[name] = {"metric": metric, "max_abs_err": float(
            np.abs(got.astype(np.float64) - want).max()) if got.size
            else 0.0, "ok": bool(ok)}
        if not ok:
            bad.append(name)
    res = {"phase": "evaluators", "cases": cases, "failed": bad,
           "nvidia_smi": card}
    emit(res)
    if bad:
        raise AssertionError(f"evaluators differ on the card: {bad}")
    return res


# card against CPU at small widths in f32 (TF32 off): outputs and every
# gradient within LAYERS_V2_TOL * (1 + |CPU value|) (``layer_cases.
# max_err``; equal values, infinities included, count no error)
LAYERS_V2_TOL = 1e-4


def layers_v2(dev) -> dict:
    """Every float-output case of ``tools/layer_cases.py`` and ``nce``:
    the port's forward and gradients on the card against its CPU path."""
    from paddle_tpu_torch.tools import layer_cases as lc

    from paddle_tpu_torch.platform.flags import FLAGS

    cases = dict(lc.CASES, nce=lc.NCE)
    errs, skipped = {}, []
    old = FLAGS.use_bf16
    FLAGS.use_bf16 = False
    try:
        with lc.fixed_draws():
            for name in sorted(cases):
                want, wg = lc.run_port(*cases[name], "cpu")
                if not np.issubdtype(want.dtype, np.floating):
                    skipped.append(name)
                    continue
                got, gg = lc.run_port(*cases[name], dev)
                worst = max([lc.max_err(got, want)] +
                            [lc.max_err(gg[k], wg[k]) for k in wg])
                errs[name] = {"max_err": worst, "grads": len(wg)}
    finally:
        FLAGS.use_bf16 = old
    bad = [n for n, e in errs.items() if not e["max_err"] <= LAYERS_V2_TOL]
    res = {"phase": "layers_v2", "cases": errs, "not_float": skipped,
           "tol": LAYERS_V2_TOL, "failed": bad}
    emit(res)
    if bad:
        raise AssertionError(f"layers_v2: card against CPU {bad}")
    return res


# SSD300 card against CPU (f32): the loss and its gradients within
# DET_TOL in norm relative to the CPU's; detections on the first
# DET_CPU_EXAMPLES examples (the CPU path's NMS at 8732 priors takes ~0.4 s
# an example): every valid row's label and box and score within DET_TOL,
# rows listed by (label, box) so an order swap of equal scores counts no
# error; mAP within DET_TOL
DET_TOL = 1e-5
DET_CPU_EXAMPLES = 8


def detection(dev, card: str) -> dict:
    from paddle_tpu_torch.tools import detection_workload as dw

    boxes, var = dw.priors()
    loc, conf, gt = dw.inputs()
    on = {d: (torch.from_numpy(boxes).to(d), torch.from_numpy(var).to(d))
          for d in ("cpu", dev)}
    grads, losses = {}, {}
    for d in ("cpu", dev):
        lt = torch.tensor(loc, device=d, requires_grad=True)
        ct = torch.tensor(conf, device=d, requires_grad=True)
        loss = dw.multibox(lt, ct, torch.from_numpy(gt).to(d), *on[d])
        loss.sum().backward()
        losses[d] = loss.detach().cpu()
        grads[d] = (lt.grad.cpu(), ct.grad.cpu())
    loss_err = _rel_norm(losses[dev], losses["cpu"])
    grad_err = max(_rel_norm(a, b) for a, b in zip(grads[dev],
                                                   grads["cpu"]))
    lt, ct = torch.from_numpy(loc).to(dev), torch.from_numpy(conf).to(dev)
    gt_dev = torch.from_numpy(gt).to(dev)
    dets = dw.detections(lt, ct, *on[dev])
    n = DET_CPU_EXAMPLES
    want = dw.detections(torch.from_numpy(loc[:n]),
                         torch.from_numpy(conf[:n]), *on["cpu"]).numpy()
    got = dets[:n].cpu().numpy()
    row_errs, count_diff = [], 0
    for g, w in zip(got, want):
        g, w = dw.sorted_rows(g), dw.sorted_rows(w)
        if g.shape != w.shape:
            count_diff += 1
            continue
        row_errs.append(float(np.abs(g - w).max()) if len(w) else 0.0)
    topo = dw.map_topology()
    map_card = dw.mean_ap(topo, dets, gt_dev)
    map_cpu = dw.mean_ap(topo, torch.from_numpy(want),
                         torch.from_numpy(gt[:n]))
    map_card_n = dw.mean_ap(topo, dets[:n], gt_dev[:n])

    def fwd_bwd():
        lg = lt.clone().requires_grad_(True)
        cg = ct.clone().requires_grad_(True)
        dw.multibox(lg, cg, gt_dev, *on[dev]).sum().backward()

    ms = {"multibox_loss_fwd_bwd": time_ms(fwd_bwd, reps=5, warmup=1),
          "multibox_loss_fwd": time_ms(lambda: dw.multibox(
              lt, ct, gt_dev, *on[dev]), reps=5, warmup=1),
          "detection_output": time_ms(lambda: dw.detections(
              lt, ct, *on[dev]), reps=3, warmup=1),
          "detection_map": time_ms(lambda: dw.mean_ap(topo, dets, gt_dev),
                                   reps=3, warmup=1)}
    res = {"phase": "detection", "priors": int(boxes.shape[0]),
           "classes": dw.CLASSES, "batch": dw.BATCH,
           "max_boxes": dw.MAX_BOXES, "nms": dw.NMS,
           "confidence": dw.CONFIDENCE, "keep_top_k": dw.KEEP_TOP_K,
           "loss_mean": float(losses[dev].mean()),
           "loss_rel_err": loss_err, "grad_rel_err": grad_err,
           "detections_a_image": float((dets[..., 0] >= 0).sum(1)
                                       .float().mean()),
           "cpu_examples": n, "row_max_err": max(row_errs, default=0.0),
           "examples_with_other_row_counts": count_diff,
           "map_card": map_card, "map_card_first": map_card_n,
           "map_cpu_first": map_cpu, "ms": ms, "tol": DET_TOL,
           "nvidia_smi": card}
    emit(res)
    if not (loss_err <= DET_TOL and grad_err <= DET_TOL and count_diff == 0
            and res["row_max_err"] <= DET_TOL
            and abs(map_card_n - map_cpu) <= DET_TOL
            and np.isfinite(map_card)):
        raise AssertionError("detection: card against CPU")
    return res


# the f32 batch-2 step, card against CPU, TF32 off and cuDNN held to its
# deterministic algorithms without the algorithm search: the cost within
# VGG_COST_RTOL; each parameter's update within VGG_UPDATE_RTOL in norm.
# At 224 px the early convolutions' gradients move by ~3e-3 between any
# two runs that round apart, two float64 runs included
# (``tools/vgg_grad_spread.py``); a bf16 step reads ~0.2 and must fail
VGG_COST_RTOL, VGG_UPDATE_RTOL = 1e-5, 1e-2
VGG_STEPS, VGG_PASS_BATCHES = 6, 20


def _vgg16_step(d, batch, p0, masks):
    """(cost, parameters after) of one ``SGD.step`` of VGG-16 at 224 px on
    ``d`` from the weights ``p0``, the dropout masks drawn afresh by
    ``masks``."""
    from paddle_tpu_torch.tools import vgg_workload as vw

    sgd = vw.trainer(d)
    with torch.no_grad():
        for k in sgd._names:
            sgd.parameters[k].copy_(p0[k])
    masks.reset()
    cost = float(sgd.step(vw.device_feeds(batch, d)))
    return cost, {k: sgd.parameters[k].detach().cpu() for k in sgd._names}


def vgg16_parity(dev) -> dict:
    """One f32 ``SGD.step`` of VGG-16 at 224 px, batch 2, on the card and
    on the CPU from the same weights, feeds and dropout masks; beside it,
    what the same check reads of the card's step with cuDNN's algorithm
    search on (the phase's setting) and of a bf16 step."""
    from paddle_tpu_torch.ops import math as pmath
    from paddle_tpu_torch.platform.flags import FLAGS
    from paddle_tpu_torch.tools import vgg_workload as vw

    cudnn = torch.backends.cudnn
    old = (FLAGS.use_bf16, pmath.dropout, cudnn.benchmark,
           cudnn.deterministic)
    masks = vw.SharedMasks()
    pmath.dropout = masks
    try:
        samples = vw.raw_images(2, SEED + 70)
        batch = [vw.mapper(SEED + 71)(s) for s in samples]
        FLAGS.use_bf16 = False
        cpu = vw.trainer(torch.device("cpu"))
        p0 = {k: cpu.parameters[k].detach().clone() for k in cpu._names}
        del cpu
        t0 = time.perf_counter()
        c_cpu, p_cpu = _vgg16_step(torch.device("cpu"), batch, p0, masks)
        s_cpu = time.perf_counter() - t0
        runs = {}
        for name, bf16, bench, det in (("f32", False, False, True),
                                       ("f32_searched", False, True, False),
                                       ("bf16", True, True, False)):
            FLAGS.use_bf16 = bf16
            cudnn.benchmark, cudnn.deterministic = bench, det
            runs[name] = _vgg16_step(dev, batch, p0, masks)
    finally:
        (FLAGS.use_bf16, pmath.dropout, cudnn.benchmark,
         cudnn.deterministic) = old
    res = {"cpu_cost": c_cpu, "cpu_step_s": s_cpu,
           "cost_rtol": VGG_COST_RTOL, "update_rtol": VGG_UPDATE_RTOL}
    for name, (cost, params) in runs.items():
        updates = {k: _rel_norm(params[k] - p0[k], p_cpu[k] - p0[k])
                   for k in p0}
        worst = max(updates, key=updates.get)
        res[name] = {"card_cost": cost,
                     "cost_rel_diff": abs(cost - c_cpu) / abs(c_cpu),
                     "update_max_rel_diff": updates[worst],
                     "update_worst": worst,
                     "update_median_rel_diff": float(np.median(list(
                         updates.values())))}
    f32 = res["f32"]
    if not (f32["cost_rel_diff"] <= VGG_COST_RTOL and
            f32["update_max_rel_diff"] <= VGG_UPDATE_RTOL and
            np.isfinite(f32["card_cost"]) and
            res["bf16"]["update_median_rel_diff"] > VGG_UPDATE_RTOL):
        emit({"phase": "vgg16_parity", **res})
        raise AssertionError("vgg16: the card's f32 step and the CPU's "
                             "disagree, or the check passes a bf16 step")
    return res


def _decoder_rule() -> str:
    """The decoder ``image.py`` finds here (OpenCV first, then Pillow);
    with neither, ``load_image_bytes`` and ``resize_short`` must raise and
    name both, not guess."""
    from paddle_tpu_torch import image
    from paddle_tpu_torch.platform.enforce import EnforceError

    if image._cv2() is not None:
        return "cv2"
    if image._pil() is not None:
        return "PIL"
    for call in (lambda: image.load_image_bytes(b"\x89PNG"),
                 lambda: image.resize_short(
                     np.zeros((300, 400, 3), np.uint8), 256)):
        try:
            call()
        except EnforceError as e:
            if "cv2" not in str(e) or "PIL" not in str(e):
                raise
        else:
            raise AssertionError("image.py decoded without a decoder")
    return "none (load_image_bytes and resize_short raise)"


def vgg16(dev, card: str) -> dict:
    """VGG-16 at Flowers-102's width through the v2 loop (phase 38)."""
    import random

    from paddle_tpu_torch.tools import vgg_workload as vw

    decoder = _decoder_rule()
    t0 = time.perf_counter()
    random.seed(SEED)
    sgd = vw.trainer(dev)
    profiling.ranged_optimizer(sgd)
    n_images = vw.BATCH * VGG_PASS_BATCHES
    samples = vw.raw_images(n_images, SEED + 60)
    first = next(iter(vw.train_reader(samples, SEED + 61)()))
    feeds = vw.device_feeds(first, dev)
    costs, step_ms = iw.time_steps(sgd, feeds, VGG_STEPS)
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    passes = {}
    for prefetch in (0, 2):
        clock = vw.StepClock()
        sgd.train(vw.train_reader(samples, SEED + 62 + prefetch),
                  num_passes=1, event_handler=clock, prefetch=prefetch)
        passes[prefetch] = clock
    peak = torch.cuda.max_memory_allocated() / 2**30
    wall = profiling.step_wall_ms(sgd, feeds, 2)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        sgd.step(feeds)
        torch.cuda.synchronize()
    busy = vw.breakdown(prof, 1, wall)
    del sgd
    torch.cuda.empty_cache()
    # the fall gate: a fresh trainer's trajectory under fixed dropout
    # masks (vw.fall_costs), not the timed steps (their 7th cost rises
    # after the 6th by a run-to-run amount at the workload's rate)
    fall = vw.fall_costs(dev, feeds)
    del feeds
    torch.cuda.empty_cache()
    parity = vgg16_parity(dev)
    flops = vw.step_flops()
    device_ms = float(np.median(step_ms))
    ms = {"device_feed": device_ms,
          **{f"prefetch_{p}": c.ms_a_step() for p, c in passes.items()}}
    train_costs = [float(c) for p in (0, 2) for c in passes[p].costs()]
    res = {"phase": "vgg16", "img": vw.IMG, "batch": vw.BATCH,
           "classes": vw.CLASSES, "parameters": vw.parameter_count(),
           "bf16": True, "optimizer": {"momentum": vw.MOMENTUM,
                                       "learning_rate": vw.LEARNING_RATE,
                                       "l2": vw.L2},
           "step_tflop": flops / 1e12,
           "bound_ms_bf16": 1e3 * flops / BF16_FLOPS_PER_S,
           "costs_device_feed": costs, "costs_train": train_costs,
           "fall": {"learning_rate": vw.FALL_LR,
                    "momentum": vw.FALL_MOMENTUM, "costs": fall,
                    "min_drop": min(a - b for a, b in zip(fall, fall[1:]))},
           "pass_batches": VGG_PASS_BATCHES, "shuffle_buf": vw.SHUFFLE_BUF,
           "timed_reader_steps": passes[0].steps, "ms_a_step": ms,
           "images_per_s": {k: vw.BATCH * 1e3 / v for k, v in ms.items()},
           "step_ms_each": step_ms, "peak_memory_gb": peak,
           "profiled": busy, "f32_batch2_step": parity,
           "image_decoder": decoder,
           "setup_s": setup_s, "nvidia_smi": card}
    emit(res)
    if not (np.all(np.isfinite(costs + train_costs + fall)) and
            all(b < a for a, b in zip(fall, fall[1:]))):
        raise AssertionError(f"vgg16: costs {costs} not finite, or the "
                             f"fall trajectory {fall} not falling")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on "
              "a GPU", file=sys.stderr)
        return 2
    from paddle_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    laps, last = {}, [t_start]

    def lap(name: str) -> None:
        """Seconds since the last lap, under ``name``."""
        now = time.perf_counter()
        laps[name] = round(now - last[0], 1)
        last[0] = now

    card = card_line()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": [torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32]})

    t0 = time.perf_counter()
    build.build(build.sources())
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {n: round(s, 3) for n, (s, _) in
                      build.BUILD_LOG.items()},
          "ptxas": [line.strip() for _, log in build.BUILD_LOG.values()
                    for line in log.splitlines() if "registers" in line
                    or "spill" in line]})
    lap("build")

    cases = run_kernel_cases(dev)
    model = build_model(dev)
    served = serve(model, dev)
    serve_int8(model, dev)
    serve_small(dev)
    lap("kernel_and_serve")

    # the verify cases are timed between CUDA events (the profiler's
    # windows cost ~1.5 s a case)
    verify = run_kernel_cases(dev, rc.VERIFY_CASES, phase="verify_kernel",
                              profiled=False)
    spec = serve_spec_ngram(model, dev)
    drafts = serve_spec_draft(model, dev, spec)
    serve_sampled_spec(model, dev, spec)
    obs_trace(model, dev, spec)
    launches_spec = {"ngram": spec["ngram"]["launches"],
                     **{f"draft_{d['draft']}": d["kernel_launches"]
                        for d in drafts}}
    serve_host_tier(model, dev)
    lap("upper_tier")

    fleet_served = serve_fleet(model, dev)
    disagg = serve_disagg(model, dev)
    migrated = migrate_kernel(model, dev)
    fleet_checks(dev)
    del model, spec
    torch.cuda.empty_cache()
    lap("fleet")
    served_tp = serve_tp(dev, card, served)
    serve_tp_world1(dev, card)
    lap("serve_tp")
    cli_phase()
    lap("cli")

    # the translation cases' plain versions (thousands of small kernels a
    # call at S 4096) are timed once between CUDA events: profiling them
    # cost ~15 s a case
    flash = run_flash_cases(dev, tuple(
        n for n in tw.FLASH_CASES if n not in tw.NMT_FLASH_CASES))
    flash.update(run_flash_cases(dev, tw.NMT_FLASH_CASES,
                                 plain_events=True))
    trained = train(dev)
    train_parity(dev)
    torch.cuda.empty_cache()
    lap("flash_and_train")
    train_lm_levers(dev, card, trained)
    lap("lm_levers")
    moe_trained = train_moe(dev, card)
    world1 = parallel_world1(dev, card)
    torch.cuda.empty_cache()
    lap("parallel")
    resumed = train_resume(dev, card)
    resilience_chaos(dev, card)
    elastic = train_elastic(dev, card)
    torch.cuda.empty_cache()
    lap("resilience")

    rnn_cases = run_rnn_cases(dev)
    trained_lstm = train_lstm(dev)
    trained_gru = train_gru(dev)
    rnn_parity(dev)
    torch.cuda.empty_cache()
    lap("rnn")

    nmt_parity(dev)
    trained_nmt, nmt_sgd = train_nmt(dev, card)
    generated_nmt = generate_nmt(dev, nmt_sgd, card)
    steps_equal("nmt_step", nmt_sgd,
                nw.feeds(nmt_sgd, nw.samples(nw.SEED + 1)))
    generations_equal(generated_nmt)
    del nmt_sgd
    torch.cuda.empty_cache()
    lap("nmt")

    cudnn = iw.configure_cudnn()
    image_parity(dev)
    trained_resnet = train_resnet50(dev, card, cudnn)
    torch.cuda.empty_cache()
    train_convnets(dev, card, cudnn)
    torch.cuda.empty_cache()
    lap("image")

    head_dims(dev)
    lap("head_dims")
    deepfm_parity(dev)
    _, ctr_sgd, ctr_data = train_deepfm(dev, card)
    steps_equal("deepfm_step", ctr_sgd, ctr_data.feeds(0))
    sparse_rows(dev, ctr_sgd.parameters["deepfm.v"].detach(),
                ctr_data.ids[0])
    del ctr_sgd, ctr_data
    torch.cuda.empty_cache()
    lap("ctr")
    train_gan(dev, card)
    train_small(dev, card)
    torch.cuda.empty_cache()
    lap("gan_vae_traffic")

    srl_parity(dev)
    trained_srl = train_srl(dev, card)
    train_chunker(dev, card)
    lap("taggers")
    trained_qs = train_quick_start(dev, card)
    lap("quick_start")
    nested_groups(dev)
    lap("nested")
    transformer_nmt_parity(dev)
    trained_tnmt = train_transformer_nmt(dev, card)
    lap("transformer_nmt")
    generate_lm(dev, card)
    torch.cuda.empty_cache()
    lap("generate_lm")
    sentiment = v2_sentiment(dev, card)
    torch.cuda.empty_cache()
    lap("v2_sentiment")
    v2_resnet50(dev, card, trained_resnet)
    torch.cuda.empty_cache()
    v2_mnist(dev, card)
    lap("v2_resnet50_mnist")
    fluid_phases(dev, card)
    lap("fluid")
    analysed = export_native_analysis(dev, card)
    torch.cuda.empty_cache()
    lap("export_native_analysis")
    optimizers(dev, card)
    evaluators(dev, card)
    lap("optimizers_evaluators")
    layers_v2(dev)
    lap("layers_v2")
    detection(dev, card)
    torch.cuda.empty_cache()
    lap("detection")
    vgg16(dev, card)
    torch.cuda.empty_cache()
    lap("vgg16")

    main_case = next(c for c in cases if c["case"] == "mixed_f32")
    decode_case = next(c for c in cases if c["case"] == "decode_f32")
    kernels = [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/serving/decode_attention.py:173",
        "launches": served["kernel_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in cases
                           if c["pages"] == c["q"] == "float32"),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": None,
        "case": "mixed_f32",
        "decode_f32": {k: decode_case[k] for k in
                       ("ms", "plain_ms", "bound_ms", "bound_by")},
        # the widened verify step of speculative decoding: launches on
        # the spec drives, and the verify blocks held against the plain
        # version (ms: calls back to back between CUDA events)
        "launches_spec": launches_spec,
        "verify": {c["case"]: {"max_abs_err": c["max_abs_err"],
                               "ms": c["ms"], "timer": c["timer"],
                               "plain_ms": c["plain_ms"],
                               "bound_ms": c["bound_ms"],
                               "bound_by": c["bound_by"],
                               "real_rows": c["real_rows"]}
                   for c in verify},
        # the fleet: B4 on every replica's steps (launches on the main
        # path's fleet drives), and one call over pages a migration
        # imported into a second engine, held against the plain version
        "launches_fleet": {"serve_fleet": fleet_served["launches"],
                           "serve_disagg": disagg["launches"]},
        # the schedule explorer's kill-partition drive on the card, and
        # one of its engine calls held against the plain version
        "launches_analysis": analysed["b4_launches"],
        "analysis_kernel": {k: analysed["kernel_check"][k] for k in (
            "q", "pages", "real_rows", "max_abs_err", "ms", "timer",
            "plain_ms", "bound_ms", "bound_by")},
        # tensor-parallel serving: each rank's launches on its head
        # shard, and its call at one step held against the plain version
        # (the shard's bytes for the bound)
        "launches_serve_tp": [r["kernel_launches"]
                              for r in served_tp["ranks"]],
        "serve_tp_kernel": [{k: r["kernel_check"][k] for k in (
            "q", "pages", "real_rows", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by")} for r in served_tp["ranks"]],
        "migrate_kernel": {kv: {k: r[k] for k in (
            "max_abs_err", "ms", "timer", "plain_ms", "bound_ms",
            "bound_by", "pages", "pages_bit_identical")}
            for kv, r in migrated.items()}}]
    flash_main = flash["a_bf16_8x1024_causal"]
    replaces = {"flash_fwd": "paddle_tpu/ops/attention.py:142",
                "flash_bwd_kv": "paddle_tpu/ops/attention.py:289",
                "flash_bwd_dq": "paddle_tpu/ops/attention.py:353"}
    for name in FLASH_KERNELS:
        r = flash_main[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention_sm90.cu",
            "replaces": replaces[name],
            "launches": trained["kernel_launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            # the forward alone for the forward kernel; the backward alone
            # (dK/dV and dQ together) for the backward ones
            "library_ms": (flash_main["library_fwd_ms"]
                           if name == "flash_fwd"
                           else flash_main["library_bwd_ms"]),
            **{key: flash_main[key] for key in LIBRARY_KEYS},
            "library": "scaled_dot_product_attention(is_causal=True) on "
                       "[8, 16, 1024, 128], " + (
                           "forward" if name == "flash_fwd"
                           else "backward of a saved forward"),
            "ptxas": ptxas_of("flash_attention_sm90", FLASH_PTXAS[name]),
            "case": "a_bf16_8x1024_causal",
            "launches_transformer_nmt":
                trained_tnmt["flash_launches"][name],
            "launches_train_resume": resumed["kernel_launches"][name],
            "launches_train_elastic": elastic["kernel_launches"][name],
            "launches_train_moe": moe_trained["kernel_launches"][name],
            "launches_parallel_world1": {
                run: world1[run]["launches"][name]
                for run in ("no_mesh", "dp_zero1", "pipeline")},
            "transformer_nmt_cases": {
                c: {"max_abs_err": flash[c][name]["max_abs_err"],
                    **{k: flash[c][name][k] for k in
                       ("ms", "plain_ms", "bound_ms", "bound_by")},
                    "library_ms": (flash[c]["library_fwd_ms"]
                                   if name == "flash_fwd"
                                   else flash[c]["library_bwd_ms"]),
                    "library": "scaled_dot_product_attention with the "
                               "dense [Sq, Sk] mask, " + (
                                   "forward" if name == "flash_fwd" else
                                   "backward of a saved forward")}
                for c in tw.NMT_FLASH_CASES}})
    kernels += rnn_kernel_lines(
        rnn_cases, trained_lstm, trained_gru,
        {"train_nmt": trained_nmt, "generate_nmt": generated_nmt},
        {"srl": trained_srl["kernel_launches"]["lstm_step"],
         "quick_start": sum(r["b5_launches"] for r in trained_qs),
         "v2_sentiment": sentiment["b5_launches"]})
    emit({"phase": "done", "seconds_total": time.perf_counter() - t_start,
          "seconds_by_phase": laps})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
