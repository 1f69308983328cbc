#!/usr/bin/env python3
"""Drive bigdl_tpu_torch's serving and training paths on one CUDA card and
check them.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):

1. environment: the card's name and power limit, the torch and CUDA
   versions, and the build of every CUDA kernel from ``bigdl_tpu_torch/csrc``
   (all ``nvcc`` processes at once);
2. kernels: each kernel against its plain PyTorch version on the card, at
   the serving and training paths' shapes, with the tolerances stated
   below; K1's, K2's, K3's, K5's and K6's cases each log the variant they
   took (``mma`` on the tensor cores for bf16; for f32, ``tf32x3`` on the
   tensor cores in K1 and, with both channel counts multiples of 8, in K6;
   ``fma`` for the rest), checked by the ``LAUNCHES*_MMA`` and
   ``LAUNCHES_TF32`` counters; each ``tf32x3`` kernel's control, its plain
   version on tf32-rounded inputs, must land past the tolerance that the
   kernel holds; K1 (f32), K4 and K5/K6 give the same bits on a second
   run; the flash backward (K2, K3) through the
   autograd ``Function`` against ``flash_attention_bwd_plain`` fed the same o, lse and
   cotangents, and against autograd through the plain attention core; the
   fused conv+BN-statistics kernels K5 (1x1 matmul) and K6 (3x3 conv) at
   every distinct fused shape of ResNet-50 at B=32 and the reference
   tests' ragged shapes, f32 and bf16, and at every fused shape of the
   training run (B=256) in bf16, with bit-identical statistics on a second
   run, and their training ``Function``s against autograd through the
   plain composition; the HBM streaming kernels K7 (copy, read and triad,
   the staged copy at every point of the probe's sweep, the direct copy
   over several ranges) at the probe's 1 GiB shape and at ragged sizes,
   K7b at every lag and deal (``check_hbm_roof``); K7c's ranges side by
   side by their %globaltimer stamps; when K7b's blocks end under each
   deal (stamps); and the operation that ``Tensor.copy_`` (the probe's
   library copy) runs; and for phase 3g's models K4 at M in (1, 4, 8, 33,
   65, 128, 160, 256) over every new weight shape (50257x768, the
   Qwen2-0.5B and Llama-3.2-1B projections and heads, the stacked Qwen2
   q/k/v rows and bias slices)
   and K1 at B=4 S=384 D=64 bf16 causal with N = 14 and 32
   (``check_published_kernels``);
3. slice: the 134M Llama-recipe LM (``scripts/int8_decode_bench.py``'s
   ``134m`` config: V=32000, E=768, 12 heads, 4 kv heads, FFN 3072, 12
   layers, RoPE, SwiGLU, RMSNorm, tied embeddings) built from a seed at full
   width; its bf16 (``cast_model``) and int8 (``quantize_model``) twins each
   serve 8 requests from threads through ``LMServer`` (prompts of 384 and
   128 tokens, 32 new tokens, greedy). Every answer must equal a direct
   ``generate`` on the same prompts, and the launch counters, zeroed just
   before serving, must show that the prefill ran kernel K1 (its ``mma``
   variant only) and the int8 decode kernel K4;
3d. continuous serving: the same three models (the f32 model, its bf16
   and int8 twins) served through ``ContinuousLMServer`` (8 slots,
   max_len 512, blocks of 8 steps, chunks of 128, greedy, 32 new tokens).
   First K1 (B=1, S in 64..512, causal, bf16 ``mma`` and f32 ``tf32x3``) and
   K4 (M in 1, 8, 40, 64, 128, 256 at the five weight shapes) against
   their plain versions at the path's shapes. Then per model, with the
   counters zeroed just before each server: round 1, 16 requests from 16
   threads (8 prompts of 384 tokens, 8 of 33-383); round 2, 12 requests (8
   sharing 256 or 200 tokens of round-1 prompts, 4 round-1 prompts again,
   whose answers must equal round 1's); the time to first token of a
   384-token prompt cold and on a 256-token prefix hit; round 3 under the
   profiler (busy share); a bucketed-mode server over 8 round-1 prompts
   (K1 launched num_layers times per admission, ``mma`` for bf16 and
   int8, ``tf32x3`` for f32); and, for the bf16 and int8 targets, a
   speculative server (a second ``cast_model`` or ``quantize_model`` of the
   f32 model as draft, spec_len 4) whose acceptance must reach 0.9. The
   trie's hits and the int8 twin's K4 and dequantize counts must equal
   what the path's structure gives (85 matmuls per forward of at most 256
   rows; a 512-row bucket dequantizes all 85), the other twins launch no
   K4, and every served token's log-prob must lie within 1e-3 (f32) or
   0.1 (bf16, int8) of its position's largest under a teacher-forced plain
   forward of the same model;
3e. the serving plane, on phase 3's twins (its prefix tries dropped): K1
   at B=2 S=128 (bf16 ``mma``, f32 ``tf32x3``) and K4 at M = 5 and 8 over the
   five weight shapes against their plain versions first; per twin
   ``generate(num_beams=4)`` on 2 prompts of 128 tokens, 32 new (K1 12
   launches, the int8 twin's K4 85 x 32; ``num_beams=1`` equal to greedy;
   the best beam's teacher-forced score at least the greedy sequence's
   less 1e-3 / 0.1), and ``generate_speculative`` (a 384-token prompt, 32
   new, spec_len 4) with the target's own twin as draft and with a 2-layer
   untied draft from seed 8 (acceptance about 0: a rewind every round),
   greedy tokens equal to ``generate`` or within the gap bound with the
   position logged, launch counts from the rounds the run reports, and the
   sampled mode once; then two fleets behind ``LMRouter`` (8 slots,
   max_len 512, blocks of 8, chunks of 128, 12 client threads, prompts of
   33-384 tokens, 32 new): the int8 twin over 2 decode replicas with
   ``KillReplicaAfterRequests(4)`` on replica 0 (nothing lost, states
   ``dead``/``ok``, at least one requeue) and the bf16 twin disaggregated
   1:2 with a bucketed prefill replica and ``DropHandoff(2)`` (at least
   one retry, K1 12 launches a shipped partition); every answer equal to
   ``generate`` or within the gap bound, and each drill's ``/metrics``
   text (requests, one TTFT per admission, device memory); last the CLI
   as subprocesses: ``serve --continuous --replicas 2 --int8 --port 0``
   (4 POSTs, ``/health``, ``/metrics``, SIGTERM -> exit 0 within 30 s) and
   ``generate --numBeams 4 --bf16``;
3f. CUDA graphs (one dispatch per decode round and per window of k
   training steps; the serving half after phase 3e, the training half after
   phase 3b). On the card every ``ContinuousLMServer`` round is a replay of
   a CUDA graph captured at the server's first round, so phases 3d and 3e
   already serve through graphs and all their checks hold there. Per model
   (f32, bf16, int8): phase 3d's rounds 1 and 2 again through one server
   with its own registry (answers equal to phase 3d's, round 2's trie hits
   and the K4 and dequantize counts from the structure, and one capture,
   counted by ``bigdl_serving_recompiles_total``, in round 1 and none in
   round 2); then 8 prompts admitted directly and, from one saved state, a
   decode block run eagerly (``_step_body``) and one replayed: equal tokens,
   bit-equal caches, ``decode_pos`` and carried tokens, K4 85 x 8 both ways
   for the int8 twin, and the ms a round each way over 10 rounds. For the
   bf16 and int8 targets the same for a speculative round with phase 3d's
   draft (emitted tokens and counts, both models' rolled-back positions,
   K4 85 x 6), and for the bf16 twin a sampled block (top-k 40) from one
   saved state of the server's step generator too. Training: the update
   from device scalars against the Python-float update, bit for bit
   (AdamW, SGD); then phase 3b's 20
   iterations from seed 7 with ``set_steps_per_dispatch(4)`` (a warm-up
   window, its capture, 4 replays): losses and parameters equal to phase
   3b's k = 1 run to the bit, K1, K2 and K3 each 12 x 20 launches, all
   ``mma``, through the replay accounting; ms an iteration, peak memory
   and the busy share of two replayed windows beside k = 1's. A ``graphs``
   line gathers the captures, replays and both halves' readings;
3g. published checkpoints (after phase 3f's serving half, each model
   freed before the next): (a) the vendored ``tests/resources/
   hf_tiny_gpt2/`` loaded on the card at f32, its log-probs within 5e-5 of
   ``transformers``' golden ones, and ``generate --fromHF`` with a text
   prompt as a subprocess beside (a) and (b), its text equal to a direct
   ``generate``; (b)
   GPT-2 small (``openai-community/gpt2``'s config, 124,439,808
   parameters) from seed 21 through ``save_hf_checkpoint`` and
   ``load_hf_checkpoint`` (every parameter bit-equal), its bf16 and int8
   twins serving phase 3's traffic through ``LMServer``, every answer
   equal to ``generate``, K1 12 launches a prefill (``mma`` for bf16; the
   int8 twin's f32 biases make its q/k/v f32, so ``tf32x3``), K4 73 a decode
   forward; (c) Llama-3.2-1B (``llama3`` rope scaling, GQA 32/8,
   1,235,814,400 parameters) from seed 22 through
   ``export_llama_state_dict`` and ``load_llama``, both twins ``generate``
   on 4 x 384 tokens (K1 16 ``mma``, K4 113 a forward), ms a decode token;
   (d) Qwen2-0.5B (q/k/v biases, 494,032,768 parameters) from HF-named
   arrays made from seed 23, both twins through one ``ContinuousLMServer``
   round of 4 requests (K4 169 a forward, no dequantize, no K1), every
   answer held to ``generate``; (e) the 134m recipe with ``window=128``:
   ``generate`` with the rolling and the linear cache give equal tokens,
   one continuous round held to ``generate``, and K1 never launched.
   Every served token within GAP_TOL of a teacher-forced forward;
3b. training: the same config built on the card from seed 7. Every
   parameter's gradient on one f32 batch (B=1, S=128) of the synthetic
   grammar, through K1/K2/K3 (K1's ``tf32x3``, K2's and K3's ``fma``
   variants, no ``mma`` launch),
   must be finite and within GRAD_RTOL (relative L2, per tensor) of a CPU
   copy carrying the same weights, which takes the plain path. Then
   ``Optimizer`` trains 20 iterations at B=8, S=512 with
   ``set_precision("bf16")``, ``AdamW`` and global-L2 clipping at 1.0: the
   losses must be finite, the mean of the last five below the first, and
   K1, K2 and K3 each launched exactly 12 x 20 times, every launch ``mma``
   (counters zeroed just before the run);
3h. checkpoints and resume (after phase 3b, whose 20-iteration run is its
   yardstick; every snapshot under one temporary directory, the free disk
   space logged first): (a) phase 3b's run with ``set_checkpoint`` every
   8 iterations and ``set_validation`` every 10 (4 held-out batches,
   ``Loss`` and ``Perplexity``): losses and parameters bit-equal to phase
   3b's, pairs ``model.8``/``state.8`` and ``model.16``/``state.16`` that
   validate, Perplexity = exp(Loss); (b) the same run preempted by
   ``KillAtStep(12)`` (a real SIGTERM; marker step 13), resumed by
   ``auto_resume()`` in a fresh process (``--resume-helper``) from a
   model of another seed: iterations 13-20 and the final parameters
   bit-equal to (a), K1-K3 12 x 8 launches each, all ``mma`` (and K1's
   f32 validation forward, ``tf32x3``); again with
   ``set_steps_per_dispatch(4)``, windows stopping at the checkpoints, the
   validation and the kill, its resumed process beside (d) and (e); (c) ``python -m bigdl_tpu_torch.resilience
   chaos corrupt`` on the newest snapshot: ``validate`` reports it
   PARTIAL, ``latest`` names the one before, and a resume from there is
   bit-equal to (a); (d) phase 3c's fused ResNet-50 recipe, 6 iterations
   with a snapshot after 3, against 3 resumed iterations: parameters, BN
   statistics and the momentum bit-equal, K5 36 x 3 and K6 13 x 3; (e)
   ``transformer train --checkpoint`` at a small size, ``generate
   --model`` and ``serve --continuous --model --draft`` (a saved 2-layer
   draft) as subprocesses started before (d) and read after it, each
   answer equal to ``generate``; the 134m's int8 twin saved and loaded:
   K4 85 launches a forward and the same tokens. A ``checkpoints`` line gives snapshot MB, save and load
   seconds, seconds to the first resumed step and the validation's
   records/s;
3c. ResNet-50 (bench.py's resnet50 workload, ``resnet.build(1000, 50)``,
   full width and depth) with both fusion gates set: every gradient and
   updated running statistic of one f32 batch (B=8, 224x224) on the card,
   measured against an f64 CPU copy and held to twice the unfused card
   model's distance from it, with the losses of a CPU f32 copy and of the
   unfused card model on the same weights; then ``Optimizer`` trains 20 iterations at B=256 of bench.py's recipe
   (constant N(0, 1) images, ``ClassNLLCriterion``, SGD 0.1 with momentum
   0.9, bf16 compute over f32 masters): finite, falling losses, K5 and K6
   launched exactly 36 x 20 and 13 x 20 times (every launch ``mma``),
   every running statistic finite and moved, and the trained model's eval forward (BN folded)
   equal to the unfused model's; then the A/B with the gates unset
   (cuDNN convs and ``batch_norm_train``): step time, images/s, device
   busy share, peak memory and the top kernels of both paths;
3i. the classic conv zoo (after phase 3c): K6 and K5 against their plain
   versions at every fused shape of the runs below (VGG-16's 13 convs at
   B=128 in f32, as run (a) feeds them, and in bf16; VGG-CIFAR's at B=128
   in f32 and bf16, down to 2x2 images; Inception
   v2's 27 stride-1 3x3 and 37 1x1 pairs at B=256), their training
   ``Function``s against autograd at Cin = 3, 2x2 images and 224 wide, the
   LRN on the card against the CPU, and VGG-CIFAR's gradients (B=4, gates
   off and the 3x3 gate on) against an f64 CPU copy (the fused model's
   median distance within twice the unfused card model's); then bench.py's
   recipe (constant N(0, 1) images from seed 0, SGD 0.1 momentum 0.9, bf16
   over f32 masters) for 12 steps of (a) VGG-16 at B=128 with the 3x3 gate
   (K6 13 a step, all f32: the first fused module sees the f32 images
   and each keeps its input's dtype, as in the reference; conv1_1, Cin =
   3, ``fma``, the other 12 ``tf32x3``), (b) the same
   unfused (bf16 cuDNN convs), (c) Inception v1 at
   B=256, (d) Inception v2 at B=256 with both gates (K5 37, K6 27 a step)
   and (e) LeNet at B=256 for 100 steps as a ``Sequential`` and as a
   ``Graph`` from one seed, whose losses are equal bit for bit; a run that
   does not fit takes the next rung of bench.py's ladder. Each run logs
   its step time, images/s, busy share and peak memory. Then the apps:
   ``lenet train`` on the vendored MNIST with validation and ``python -m
   bigdl_tpu_torch.apps.lenet test --model`` (the Top-1 of the trained
   model), ``vgg train`` with the 3x3 gate on synthetic CIFAR at B=128
   (K6 13 x 4), ``resnet train --depth 20`` on CIFAR binary files the
   phase writes and ``inception train --synthetic-size 64``;
3j. the perf harness (after phase 3i; ``apps/perf.py``, each run in this
   process through ``perf.run``, cuDNN deterministic): (a) K1, K2 and K3
   (``mma``) against their plain versions at ViT-S/16's shape (B=256
   S=196 N=6 D=64, non-causal) and transformer_1b's (B=8 S=2048 N=16
   D=128, causal); (b) ViT-S/16's f32 gradients on the card (B=4) against
   an f64 CPU copy, each tensor within 2x the plain-core card model's
   distance (phase 3c's rule); (c) ``perf --model vit_s16`` at B=256,
   bf16, 9 iterations after 3 warm-ups, k = 1 and k = 4 through the
   device cache (losses bit-equal over the same 1024 records) and k = 1
   from the host, K1-K3 12 each a step; (d) ``perf --model lstm`` (vocab
   20000, T=500, 128 wide) at B=32, k = 1 and k = 4, bit-equal; (e)
   ``perf --model transformer_1b`` (1,009,727,488 parameters) at B=8,
   S=2048, AdamW with bf16 moments, ``--remat block``, 6 iterations
   after 3, ``--memStats``: K1 40 a step (each block recomputed), K2 and
   K3 20; then a 2-layer cut at full width, whose block-remat gradients
   must equal the plain ones bit for bit; (f) ``perf --model resnet50`` at
   B=256 with both gates, with and without ``--remat conv``: equal
   losses, K5 36 and K6 13 a step both ways, and a lower peak with the
   policy. Each run logs records/s, ms an iteration, peak memory and
   (k = 1) the busy share of two more profiled iterations;
3k. the layer zoo (after phase 3j; no kernel of ours is on its path): (a)
   every layer, container and criterion that the layer-zoo slice ported
   (``nn``'s activations, shapes, tables, linear, normalization, conv,
   pooling and regularization layers, the 22 criteria, the f32 conv twin
   of ``quantize_model``; ``Echo`` only prints) on the card, f32 with
   TF32 off, against the same module (a deep copy) on the CPU: forward,
   input and parameter gradients within 1e-6 of max|CPU| for elementwise
   layers and criteria' gradients, 1e-5 for convolutions,
   normalizations, products, reductions and the criteria's losses (a
   tensor outside it, such as a weight gradient summed over 100,352
   positions, is held instead to an f64 CPU run: the card's distance at
   most twice the CPU f32's or 1e-4; each such tensor is logged, and the
   same 3x3 conv in TF32 must land past 1e-4 from f64), at
   B=32, 56x56, 64 channels (volumetric: N=8, 16^3, 32 channels; 128
   RoIs over the spatial maps; class criteria over 32*56*56 rows of 64);
   ``nms`` over 6000 boxes keeping 300, identical indices and count; (b)
   ``apps/autoencoder.py`` on the vendored MNIST (batches of 8, shuffles
   seeded), 20 iterations each of SGD, RMSprop, Adamax, Adadelta and SGD
   under ``EpochStep``, ``L2Regularizer(1e-4)`` on the weights: every
   step's loss within 1e-5 relative of a CPU run's, and Adamax and the
   ``EpochStep`` SGD with ``set_steps_per_dispatch(4)`` (one window an
   epoch) and ``(3)`` (a window of 3, then a short one of 1 at the
   epoch's end, the rate changing after it) bit-equal to k = 1; (c)
   ``enable_timing`` over two card iterations of the autoencoder: every
   module's forward and backward seconds positive;
3l. text, tokenizers and summaries (after phase 3k; ``--text-only`` runs
   it alone): (a) ``transformer train --textFile F --bpeVocab 1024`` at
   the 134m recipe's width (768 wide, 12 heads, 12 layers, S=512, B=8,
   ``--llamaBlock``, f32, SGD at rate 0.1), one epoch of F, about 1 MB of
   lines drawn from a fixed word list (non-ASCII words too) with a seed:
   the saved tokenizer reloads with the corpus's merges, every line
   decodes to itself, the loss is finite and falls, K1, K2 and K3 launch
   12 times each a step; a 2-layer cut's first-batch f32 loss within 1e-4
   relative of the same cut on the CPU; the busy share of two more
   iterations; (b) ``generate --tokenizer`` from that checkpoint, top-40
   sampling from a seeded generator, prints what ``generate`` gives on
   the encoded prompt with the same generator (K1 12 launches, the
   prefill), and ``serve --tokenizer`` (a subprocess) answers a POST
   ``{"text": ...}`` with the ids and text of ``generate`` drawing from
   the server's first batch's seed; (c) the 134m recipe at
   vocab 32000 as an HF Llama directory with a unigram, byte-fallback
   ``tokenizer.model`` from ``write_model`` (3 specials, 256 byte pieces,
   seeded pieces and scores): ``generate --fromHF DIR --prompt TEXT``
   equals ``generate`` on the tokenizer's ids (K1 12 launches), 100
   seeded strings with characters no piece covers round-trip through the
   unigram and a BPE model, and the host's encode rate; (d) the
   textclassifier at the reference's defaults (T=1000, E=100, B=128,
   ``Adagrad``) for 2 epochs with Top-1 validation, the rnn app with its
   padding pipeline, ``lenet train --summary`` (a subprocess) whose every
   iteration's ``Loss`` and ``Throughput`` the port's ``FileReader``
   reads back with their CRCs, ``DLClassifier``'s predictions equal to
   the model's argmax, and ``Tensor`` ops on the card within 1e-5 of the
   CPU's; a ``text_slice`` line logs the corpus, the BPE seconds, ms an
   iteration, the busy share, launches a step, the encode rate and the
   phase's seconds;
3m. model files and image ingestion (after phase 3l; ``--files-only``
   runs it alone): (a) the host library (``bigdl_tpu_torch/native``, g++
   at first use; its build seconds and whether this run built it logged):
   CRC32C over 64 MiB against the byte-wise table loop (a process of its
   own beside the phase), the bf16 codec on 64 M floats bit for bit,
   quickselect, and the batch decode of 256 x 224x224x3 uint8 records
   within 1e-6 of numpy, each timed; (b) 320 training and 64 validation
   JPEGs (10 classes, sides 256-512, from a seed) packed by ``seqfilegen
   -p 4 -b 64`` (a process of its own beside (a)): every record equal to
   its file's bytes and label, by the native scan and the Python framing
   alike, and the decode rates of the per-record PIL path and the native
   batch path; (c) ``inception train --folder SHARDS`` at full width
   (Inception v1, 1000 classes, 224 crops, B=32, 10 iterations, then
   validation): finite losses, Top-1 and Top-5 over the 64, ms an
   iteration after 2, the busy share (profiler, 4 iterations) and the
   epoch's data-wait share, and the same run on in-memory synthetic images
   as a control; then ``--caffeModel`` (a seeded caffemodel with Inception v1's
   57 layer names) and ``--torchModel`` (VGG-16 of 10 classes saved as
   ``.t7``), each on the validation shards, each file also loaded by a
   direct ``load_caffe`` / ``load_torch`` call (timed): every parameter
   of that load and of the app's model equal to its blob or its saved
   value; (d) ``modelvalidator`` with ``-t torch -m vgg16`` (that
   ``.t7``), ``-t caffe -m alexnet --caffeDefPath`` (a seeded caffemodel
   and a deploy prototxt, 10 classes) and ``-t bigdl -m resnet50`` (a
   ``file_io`` snapshot, 10 classes), each on a copy of the validation
   folder placed by the model's own ranking (of every 4 images, its
   first, its third and twice its last class): Top-1 and Top-5 equal to
   the model's argmax over the same batches on the card and strictly
   between 0 and 64 (16 and 32 as placed), 4 images' log-probs within
   FILES_LOGPROB_RTOL (over the largest) of a CPU copy's with TF32 off,
   and read with TF32 on; ``imageclassifier`` on the snapshot (a process
   of its own beside (c)-(d)): its rows equal the model's argmax; (e)
   ``udfpredictor`` with phase 3l's classifier bundle (``--files-only``
   trains one for one epoch) over 200 seeded texts: classes equal to the
   model's argmax, ``make_udf`` alike, and ``--watch`` classifies a file
   written after its first poll exactly once; every entry point of the
   host library called; a ``model_files`` line logs the shards' MB,
   ``seqfilegen``'s seconds, both decode rates, Inception's ms an
   iteration, busy and data-wait shares, the caffemodel and ``.t7`` load
   seconds, the validators' images/s, the texts/s, the library's call
   counts and the phase's seconds;
3n. the platform planes (after phase 3m; ``--platform-only`` runs it
   alone): (a) ``ingest_bench generate`` writes 4096 seeded raw-BGR
   224x224x3 records (512 a shard, 616 MB), ``read``, ``decode -w 4`` and
   ``pipeline --engine both --workers 2 --prefetch-depth 2`` run through
   ``ingest_bench.main`` in this process (short budgets; the pipelined
   run's Chrome trace validated by ``python -m bigdl_tpu_torch.telemetry
   trace``), then ``train``'s
   ``Optimizer`` (``ingest_bench.optimizer``: ResNet-50 B=256, bf16, SGD
   0.01, ``--deviceNormalize``, both fusion gates) fed by the staged
   engine for 14 iterations: its first 4 batches on the card bit-equal to
   the serial path's host batches (each copied back after its step was
   dispatched), K5 36 and K6 13 launches a step, one
   ``bigdl_compiles_total{site="train.step"}``, ms an iteration after 2,
   busy and data-wait shares, ``bigdl_ingest_stall_seconds_total`` by
   stage, and the same step on one in-memory batch as the control; (b) 8
   more iterations under ``set_profiling(dir, 5, 3)``: the Chrome trace
   holds exactly the ranges ``iteration 5``-``7`` and K5's and K6's
   kernels, ``bigdl_train_mfu`` is set, and the step's counted FLOPs lie
   within PLAT_MFU_FLOPS_RTOL of 3x ResNet-50's forward; (c) phase 3b's
   134m recipe with bf16 AdamW moments, 12 iterations, a sharded snapshot
   tagged 8, resumed by ``auto_resume`` in a fresh optimizer over other
   weights: iterations 8-12 and the final parameters bit-equal to the
   uninterrupted run, K1-K3 counted; ``resilience validate`` and
   ``latest`` accept the pair and refuse it after ``chaos corrupt``;
   (d) ``python -m bigdl_tpu_torch.telemetry scoreboard`` at the 134m
   width (f32; prompts 16-384, chunks of 128, 32 new tokens, 16 requests
   a row): slots 8 and 16, the shared-prefix workload at 8, the int8 twin
   as draft at 8 (K1 launched in every row, K4 in the last), each row's
   compiles against the structure; ``scoreboard diff`` of an artifact
   against itself (exit 0) and against a copy with tok/s cut by 30% (exit
   1); ``scoreboard scrape`` of a live server's ``/metrics``: one row. A
   ``platform_planes`` line logs them and the phase's seconds;
3o. the data-parallel plane (after phase 3n; ``--distributed-only`` runs
   it alone): its ranks are fresh processes of this script with the
   reference's ``BIGDL_*`` environment, awaited with a timeout. (b) world
   2 over the one card (gloo): the 134m recipe of phase 3b (bf16, AdamW,
   L2 clip 1.0; every collective a step and each epoch's agreed
   iteration count) at global B=8 (4 a rank) for 6 iterations in each
   of
   ``DistriOptimizer``'s modes (allreduce, sharded ZeRO-1, fsdp), every
   collective a step held to the mode's structure, the two ranks' weights
   bit-equal, each rank's parameter and optim-state MiB at rest, ms an
   iteration and the collectives' share; the fsdp run writes a sharded
   snapshot after iteration 3; then (c) ResNet-50 at global B=256 (128 a
   rank, bf16, both fusion gates, allreduce: synchronized batch norm), 4
   iterations, K5 36 and K6 13 a step on each rank, the two ranks'
   weights and running statistics bit-equal, and its collectives a step
   held to the structure (an all-reduce of each fused op's sums and an
   all-gather of each plain BN's moments forward, an all-reduce of each
   BN's two sums backward, the buckets, the loss). (a) world 1 on NCCL:
   the same recipe through ``LocalOptimizer`` and each mode (allreduce
   bit-equal to ``LocalOptimizer``, sharded and fsdp within the stated
   tolerance), K1-K3 12 a step; (c)'s world-1 yardstick at B=256; (e) the
   world-2 snapshot resumed by world 1 (elastic, counted): the state just
   restored equal, leaf by leaf and bit for bit, to the full state world
   2 held when it saved (parameters, buffers, AdamW's moments), and the
   run's last iteration resumed again from world 1's own snapshot
   bit-equal to the uninterrupted one. (b), (c) and (e) are held to
   world 1 within the stated tolerances (the relative L2 distance of the
   parameter updates, or of the running statistics, over a sample, and
   of the losses). (d) ``python -m bigdl_tpu_torch.apps.perf --model
   resnet50 --distributed --backend gloo`` at world 2, 3 iterations. A
   ``distributed`` line logs them. ``--distributed-controls`` adds the
   runs that set the tolerances ((b) in f32 at both worlds, (b) with rank
   1's gradients dropped, (c) with per-replica statistics) and holds each
   control to fail the check it sets;
3p. the model-parallel axes (after phase 3o; ``--model-parallel-only``
   runs it alone): fresh rank processes of ``python3 chip_smoke.py
   --model-parallel-rank JOBS``, world 2 over the card (gloo) against
   world 1 (this process), the 134m recipe cut to 4 layers (bf16, AdamW, clip
   1.0). (a) ``Optimizer(topology=MeshTopology(tensor=2))``, B=8 S=512, 4
   iterations, without and with sequence-parallel regions: the
   collectives a step held to the Megatron structure (an all-reduce after
   the out-projection and the FFN down, and their region entries'
   backward; with the regions, a reduce-scatter and an all-gather in
   their place), K1-K3 once a layer a step on each rank, the parameters
   and AdamW's state at rest under 0.6 of world 1's, the updates and
   losses within the tolerances of world 1's ``LocalOptimizer``. (b)
   ``ContextParallelLM`` at cp=2, S=512: ring contiguous, ring zigzag and
   Ulysses, 3 iterations each; the initial log-probs against world 1's
   full attention, the first step's gradients (the ranks' sum), K1-K3
   launches a step by the hops each rank runs (none for a future chunk),
   the ring's shifts (staged through the host: gloo refuses CUDA tensors
   in send/recv) and Ulysses' all-to-alls a step. (c) ``generate(mesh=)``
   of the bf16 model, 4 prompts of 128, 16 greedy tokens: dp-decode
   (data=2) and tp-decode (tensor=2) against world 1's tokens (or within
   the teacher-forced gap), ms a token. (d) ``python -m
   bigdl_tpu_torch.apps.transformer train --tensorParallel 2`` and
   ``--contextParallel ring`` at world 2, 2 iterations each, exiting 0
   with finite losses (the two worlds started together). A
   ``model_parallel`` line logs them;
   ``--model-parallel-controls`` adds (a) in f32 and with the region
   entries' backward all-reduce dropped, which must fail (a)'s check.
   In the whole script 3o's rank processes start before phase 3h and
   3p's (its world 2 and its CLI worlds) before phase 3i, each in a
   thread beside this process's phases; 3o and 3p then read and check
   what they wrote (3p's world-1 yardsticks run in its own slot). No
   check of either side reads the card's time, but the times of 3h-3n
   and of 3o's and 3p's ranks are then shared: ``--distributed-only``
   and ``--model-parallel-only`` give them alone;
3q. the expert and pipeline axes (after phase 3p; ``--expert-pipeline-only``
   runs it alone). (a) in this process: ``perf --model transformer_134m
   --moeExperts 8`` (12 layers, S=1024, about 0.53 B parameters) at B=8,
   3 iterations after 1: ms an iteration, peak MiB, the dispatch counter,
   the first forward's dropped share, K1-K3 12 a step; one 134m-8e layer
   at T=8192 in bf16: sort, scatter and einsum forward and gradients bit
   for bit, each one's ms; greedy decode of 4 prompts of 128 on the
   12-layer MoE LM (bf16), ms a token, the tokens equal with every
   dispatch switched to einsum. Fresh rank processes of ``python3
   chip_smoke.py --expert-pipeline-rank JOBS``, world 2 over the card
   (gloo), against world 1 (a process of its own): (b) the 134m-8e LM
   cut to 4 layers (bf16, AdamW, clip 1.0, B=8 S=512, 3 iterations) at
   ``MeshTopology(expert=2)`` (4 experts a rank) and at
   ``MeshTopology(data=2)`` (global routing): updates and losses within
   the tolerances, the first forward's dropped picks equal to world 1's,
   the MoE collectives by the structure (per layer and step two
   all-gathers over ``expert``, or the counts' all-gather over
   ``data``), K1-K3 once a layer a step, the experts' MiB at rest half of
   world 1's; (c) a ``PipelineStack`` of 4 causal blocks at the 134m
   widths (bf16), GPipe with n_micro 4 at B=8 S=512, with and without
   remat, and the circular schedule (V=2); ``StagePipeline`` of the 4-layer
   LM (embedding + 2 blocks | 2 blocks + norm + head, f32): the loss and
   the first step's gradients against ``scan_apply`` /
   ``sequential_apply`` at world 1, 2 x the schedule length staged
   shifts a step, K1-K3 by the layers and microbatches each stage runs,
   remat's gradients bit-equal; (d) world 4 (data 2 x tensor 2): the
   134m recipe cut to 2 layers, ``sync_mode="fsdp"``, 2 iterations,
   against world 1, and the MiB at rest; (e) ``transformer train
   --moeExperts 4`` and ``perf --model transformer --moeExperts 4
   --moeDispatch einsum`` exit 0. An ``expert_pipeline`` line logs them;
   ``--expert-pipeline-controls`` adds (b) and (c) in f32, (b) routed per
   rank (its dropped picks must differ), (c) with a summing psum backward
   and with no psum forward, ``StagePipeline`` with a summing psum
   backward and (d) with one data coordinate's gradients dropped, each of
   which must fail the check whose limit it sets. In the whole script
   3q's world-2 ranks start before phase 3g, in a thread beside this
   process's phases 3g and 3b, and its world 4, CLIs and world 1 before
   phase 3l, beside 3l-3n;
3r. the static analyser (``bigdl_tpu_torch/analysis``; after phase 3q;
   ``--analysis-only`` runs (a) and (b) alone). (a) ``python -m
   bigdl_tpu_torch.analysis`` on the port tree and this script, as
   processes beside phase 3c (device-bound): cold (a new cache) and
   warm, the exit code, files, findings and suppressions by code, and a
   warm pass that counts the files it parses (none: a cache hit), the
   host CPU's name (as its ``/proc/cpuinfo`` gives it);
   (b) in a process of its own (``--capture-rules``), beside phases 3g
   and 3b: each capture rule's positive and near-miss fixture
   (``analysis/fixtures.py``: JG001, JG002, JG003, JG006, JG007,
   JG013/JG019, JG020) linted, then run under ``GraphedProgram`` on the
   card; the positive must be flagged and show its hazard (the capture
   raises, the side effect counts the capture only, two replays draw
   equal numbers, a held output equals the next replay's, one capture a
   length against the buckets' count, the replay's ``data_ptr`` error),
   the near-miss must not be flagged, must capture and must replay equal
   to eager, one ``capture_rule`` line a rule; (c) the byte model
   (``analysis/commcost.py``) at each run's symbols (the 134m recipe's P
   and A, the 134m-8e's T and n_moe, the ring's K, the pipelines'
   boundaries) against the payload bytes ``COLLECTIVES`` counted by op
   and axis in 3o's world-2 modes, 3p's tp, tp+sp and rings and 3q's
   expert and data axes, GPipe and ``StagePipeline``, on every rank:
   exact (``COMM_RTOL``), and the model with its first term dropped must
   fail. The ranks run gloo over one card, so this holds the payload
   algebra, not NVLink wire time. An ``analysis`` line logs them;
3s. the module surface (``nn/module.py``'s instance API; inside phases 3b
   and 3c, on their trained models, ``--surface-only`` runs it alone on
   freshly trained ones). (a) The 134m LM after 3b's 20 steps:
   ``backward(x, g)`` of its ``TransformerEncoder`` at (8, 512, 768), f32
   from a seed, bit-equal to ``torch.autograd.grad`` of a plain forward in
   the same mode and dropout state, K1, K2 and K3 12 launches each (K1's
   ``tf32x3``, K2's and K3's ``fma`` variants), every ``.grad`` at its
   address with its values;
   ``predict(ids)`` bit-equal to an eval-mode forward under ``no_grad``
   (K1 12), ``predict_class`` its argmax + 1, every ``output`` None after;
   ``get_parameters()`` (128,404,224 elements, equal to the sorted-key
   concatenation, ``unravel`` bit-equal; its ms and added peak MiB);
   ``clone_module()`` (a bit-equal forward from fresh addresses; one
   ``Optimizer`` step on the clone, recording on, leaves no ``output`` and
   the original's flat vector unchanged); ``summary()``'s total against
   ``n_parameters()``. (b) ResNet-50 after 3c's 20 steps (both gates):
   ``backward(images, g)`` at B=256 in training mode (f32: K5's ``fma``,
   K6's ``tf32x3``), K5 36 and K6 13 launches, bit-equal to autograd of the same forward with
   cuDNN held deterministic, every running statistic bit-equal;
   ``evaluate`` over 4 seeded batches of 256 with Top1, Top5 and
   ``Loss(ClassNLLCriterion())`` equal to ``Evaluator(model,
   device="cuda").test``; the trees through numpy into a fresh model, a
   bit-equal eval forward. (c) ``set_mask`` on one ``MultiHeadAttention``
   at the LM's widths (bf16): a static causal mask keeps K1 out and comes
   within SURFACE_MASK_TOL of the unmasked causal K1 output. A
   ``surface`` line logs them; the earlier phases' own direct forwards
   run with output recording off, so that no phase holds the activations
   of another;
4a. HBM roof: the probe ``python -m bigdl_tpu_torch.scripts.roofline_hbm
   --gib 1`` (``main``, every family, one calibration, no waiting), its
   K7 launch counts against the counts its chains predict, and no reading
   above the data sheet's rate; its ``roofline_hbm`` line holds
   ``roof_gbps``, the highest copy or read rate of a hand-written probe;
4. timing: each kernel is checked once more against its plain version at
   the served shape, then it (``ms``), its plain version (``plain_ms``) and
   one PyTorch library call for the same function (``library_ms``) are
   timed, each by CUDA events around CUDA-graph replays (``graph_ms``): K1
   (at the served shape and, as ``train``, at the training shape), K2 and
   K3 (their ``mma`` variants at the training shape, B=8 S=512 N=12 D=64
   bf16 causal; the library time is the forward and backward of
   ``scaled_dot_product_attention`` less its forward), K4 (one int8
   decode token of the 134m config, its 85 weights at their shapes made
   from a seed, and each distinct shape alone, with an empty kernel
   launched as often for the least time of a launch; ``continuous``: the
   85 at phase 3d's M = 8, 40 and 128; ``serving_plane``: at phase 3e's
   verification, M = 5; ``published``: one int8 decode token of each phase
   3g model at M = 4, and its vocab head alone; K1's ``beam_prefill``: B=2
   S=128; ``llama32_1b_prefill``: B=4 S=384 N=32) and K5 and K6 (at
   ResNet-50's stage-1 and stage-4 shapes at B=256, bf16, where the
   library time is the cuBLAS product or the cuDNN conv plus one
   ``torch.var_mean`` of its output; K5 also at each of the training
   step's 15 distinct 1x1 shapes, summed over its 36 launches; and, from
   phase 3i, K6 at VGG-16's 224x224 64->64 and 14x14 512->512 at B=128 and
   K5 at Inception v2's largest 1x1 at B=256; from phase 3l, K1, K2 and K3
   in f32 (K1's ``tf32x3``, K2's and K3's ``fma`` variants) at the text
   LM's causal B=8 S=512 N=12 D=64, with the f32
   ``scaled_dot_product_attention`` as the library; K1's ``f32_prefill``:
   ``tf32x3`` at the f32 bucketed prefills' B=1 S in 64..512; K6's
   ``f32``: ``tf32x3`` at ResNet-50's four 3x3 shapes at B=256, and K5's
   ``f32_step``: its ``fma`` variant at the step's 15 1x1 shapes, as phase
   3s's f32 ``backward`` launches them, with cuBLAS and cuDNN in f32, TF32
   off);
   the bound (``bound_ms``) is the larger of the bytes the function must
   move over 3.35 TB/s and its operations over 989 TFLOP/s (H100 SXM data
   sheet, bf16 dense; for the f32 ``tf32x3`` rows 495 / 3 TFLOP/s, the
   tensor cores' TF32 peak over the three passes, with
   ``bound_f32_fma_ms`` beside it at 67 TFLOP/s, the CUDA cores' f32 FMA
   peak, which bounds the f32 ``fma`` rows), and ``bound_measured_ms`` prices the same bytes at the
   roof measured in phase 4a. Phase 1 logs each kernel's ``-Xptxas -v``
   report (registers, shared memory, spills) and whether this run built it.
   K7's rows come from phase 4a's run: the best
   reading of each sweep per pass over 1 GiB, the eager chain as
   ``plain_ms`` and one PyTorch call as ``library_ms``.

The last three lines of standard output are the card's name and power
limit, the ``{"kernels": [...]}`` line, and ``{"ok": true, "device": ...}``.
A kernel row's ``launches`` sums its main paths' runs: phases 3, 3d, 3e,
3f (the rounds served and the k = 4 training), 3g, 3b, 3h (its resumed
processes included), 3c, 3n, 3o, 3p, 3q (every rank's) and 3s (the
surface's own calls); phase 3i's rows count
phase 3i's runs, and
phase 3j's (K1-K3 at ViT-S/16's and transformer_1b's shapes) its runs
(c) and (e).

``python3 chip_smoke.py --resnet-grad-seeds 11 21 31`` builds the kernels
and runs only phase 3c's gradient check, once per seed, printing each
seed's readings and no result line.

``python3 chip_smoke.py --zoo-only`` builds the kernels and runs only
phase 3i and its kernel rows, printing them and no result line;
``--perf-only`` does the same for phase 3j; ``--layers-only`` runs only
phase 3k, ``--files-only`` only phase 3m, ``--platform-only`` only
phase 3n, ``--distributed-only`` only phase 3o,
``--model-parallel-only`` only phase 3p, ``--expert-pipeline-only``
only phase 3q, ``--analysis-only`` phase 3r's (a) and (b) and
``--surface-only`` phase 3s on a 134m LM and a ResNet-50 it trains
first (none of them prints kernel rows). Phase 3o's ranks are fresh processes of ``python3
chip_smoke.py --distributed-rank JOBS --dist-out DIR --dist-backend B``
with the ``BIGDL_*`` environment.

``python3 chip_smoke.py --resume-helper DIR [--steps-per-dispatch K]`` is
phase 3h's fresh process: it resumes the 134m run from DIR's snapshots
and prints one ``resume_helper`` line.

``python3 chip_smoke.py --time-kernels-of DIR`` imports ``bigdl_tpu_torch``
from DIR (for example an earlier commit unpacked by ``git archive``),
builds its kernels, times K1-K6 as phase 4 does (phase 3l's f32 rows and
phase 3i's VGG-16 rows included) and runs DIR's probe with
only its K7b (``manual``), K7c (``hbm_dma``) and ``library`` families at
1 GiB, printing the rows and no result line: an earlier version's kernels
and this one's on one timer, within one machine.

``python3 chip_smoke.py --gc-trace-of DIR [ARGS...]`` runs DIR's
``chip_smoke.py`` (this tree's with ``.``, or an earlier commit's) with
ARGS in this process and, after its output, prints one ``gc_trace`` line:
every pass of Python's cyclic garbage collector that freed 16 MiB or more
on the card, with the phase it ran in, its generation, the MiB freed and
the MiB allocated before it. A phase's peak reading counts the device
tensors that a reference cycle of an earlier phase still holds; the trace
shows where each such cycle was finally freed.
"""

import argparse
import collections
import contextlib
import gc
import itertools
import json
import os
import runpy
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
BF16_OPS_PER_S = 989e12     # H100 SXM tensor cores, bf16 dense
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
#: H100 SXM tensor cores, TF32 dense, over the three passes of a 3xTF32
#: product: the ceiling of the f32 "tf32x3" kernel variants
TF32X3_OPS_PER_S = 495e12 / 3
CONFIG = dict(embed_dim=768, num_heads=12, num_kv_heads=4, ffn_dim=3072,
              num_layers=12, max_len=512, rope=True, activation="swiglu",
              norm="rms", bias=False, tie_embeddings=True)
VOCAB = 32000
NEW_TOKENS = 32
PROMPT_LENS = (384, 128)
REQUESTS_PER_LEN = 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 20
TRAIN_LR, TRAIN_DECAY, TRAIN_CLIP = 3e-3, 0.01, 1.0


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


#: seconds of each phase of a whole run, by phase (the kernel checks
#: together as "2"), logged with ``total_s``
PHASE_S = collections.defaultdict(float)
#: the wall clock when the script started (phase 3m asks whether the host
#: library was built since, by this process or by an earlier phase's)
RUN_T0 = time.time()


GC_TRACE_MIB = 16   # the least device memory a logged collection freed


def gc_trace(script: str, argv: list) -> int:
    """``--gc-trace-of``: ``script`` run with ``argv`` in this process
    under a ``gc.callbacks`` hook that reads ``memory_allocated`` before
    and after each collection; its exit code. The hook allocates nothing
    on the card, so the script's own readings stand."""
    events, before = [], {}
    t0 = time.perf_counter()

    def phase_of(frame):
        while frame is not None:   # the innermost ``timed(phase, ...)``
            if frame.f_code.co_name == "timed" \
                    and "phase" in frame.f_code.co_varnames:
                return frame.f_locals.get("phase")
            frame = frame.f_back
        return None

    def on_gc(stage, info):
        if not torch.cuda.is_initialized():
            return
        now = torch.cuda.memory_allocated()
        if stage == "start":
            before["mib"] = now / 2 ** 20
            return
        freed = before.pop("mib", now / 2 ** 20) - now / 2 ** 20
        if freed >= GC_TRACE_MIB:
            events.append({"phase": phase_of(sys._getframe(1)),
                           "generation": info["generation"],
                           "freed_mib": freed,
                           "allocated_before_mib": now / 2 ** 20 + freed,
                           "t_s": time.perf_counter() - t0})

    gc.callbacks.append(on_gc)
    sys.argv = [script, *argv]
    rc = 0
    try:
        runpy.run_path(script, run_name="__main__")
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else (e.code is not None)
    finally:
        gc.callbacks.remove(on_gc)
        print(json.dumps({"gc_trace": {"script": script, "argv": argv,
                                       "rc": rc, "events": events}}),
              flush=True)
    return rc


def timed(phase: str, fn, *args):
    """``fn(*args)``, its seconds added to PHASE_S[phase]."""
    t = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_S[phase] += time.perf_counter() - t


PROFILER_TRIES = 3


def profiled(fn, what: str):
    """Runs ``fn`` once under ``torch.profiler`` (CUDA activity) and returns
    ([(kernel name, device us)], wall seconds of the run). An H100 run has
    seen the profiler, after many sessions in one process, come back with
    no device time for work that launched kernels; such a run is logged and
    repeated, at most PROFILER_TRIES times. Returns (None, None) when no
    run recorded device time."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, PROFILER_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [(e.key, e.self_device_time_total)
                for e in prof.key_averages() if e.self_device_time_total > 0]
        if rows:
            return rows, wall
        log({"profiler_recorded_nothing": what, "attempt": attempt})
    return None, None


def graph_ms(fn, what: str, per_graph: int = 20, replays: int = 5) -> float:
    """Device milliseconds per call of ``fn``: CUDA events around
    ``replays`` replays of one CUDA graph that holds ``per_graph`` calls,
    so neither host gaps nor the profiler enter (the profiler's reading of
    one sub-millisecond launch has moved by up to 2x between runs of this
    script, and in one run fell to 0.6x of this timing)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm-up, as capture wants, on a side stream
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * per_graph)
    check(ms > 0, f"{what}: the graph's replays measured no time")
    del graph
    torch.cuda.empty_cache()
    return ms


def bound(nbytes: float, ops: float, ops_per_s: float = BF16_OPS_PER_S
          ) -> dict:
    """The least time of a unit of work on the card by the data sheet
    (``bound_ms``, and which term sets it), with the bytes and operations
    it counts, so that ``add_measured_bound`` can price the bytes at the
    measured HBM roof. ``ops_per_s``: the peak for the operations' type
    (bf16 tensor cores unless given; an f32 row gives F32_OPS_PER_S, or
    TF32X3_OPS_PER_S for a ``tf32x3`` variant, and carries it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    out = {"bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "operations": ops}
    if ops_per_s != BF16_OPS_PER_S:
        out["ops_per_s"] = ops_per_s
    return out


def with_f32_fma_bound(entry: dict) -> dict:
    """``entry`` (a ``tf32x3`` reading, its ``bound_ms`` at
    TF32X3_OPS_PER_S) with ``bound_f32_fma_ms``: the same bytes over the
    HBM rate and the operations at the CUDA cores' f32 FMA peak, the bound
    of the ``fma`` variants that ``tf32x3`` replaced."""
    entry["bound_f32_fma_ms"] = max(entry["bytes"] / HBM_BYTES_PER_S,
                                    entry["operations"] / F32_OPS_PER_S) * 1e3
    return entry


def add_measured_bound(entry: dict, hbm_bytes_per_s: float) -> dict:
    """``bound_measured_ms``: the bytes term over the HBM roof measured in
    phase 4a, the operations term unchanged (the second readings,
    ``stage4`` and ``train``, and K4's ``shapes``, too)."""
    entry["bound_measured_ms"] = max(
        entry["bytes"] / hbm_bytes_per_s,
        entry["operations"] / entry.get("ops_per_s", BF16_OPS_PER_S)) * 1e3
    for second in ("stage4", "train", "beam_prefill", "llama32_1b_prefill",
                   "bf16"):
        if second in entry:
            add_measured_bound(entry[second], hbm_bytes_per_s)
    for key in ("shapes", "continuous", "serving_plane", "published",
                "f32_prefill"):
        for shape in entry.get(key, {}).values():
            add_measured_bound(shape, hbm_bytes_per_s)
    return entry


def ptxas_report(text: str) -> dict:
    """``nvcc -Xptxas -v``'s lines (registers, shared memory, stack and
    spills) by entry function."""
    report, entry = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and ("registers" in line or "spill" in line):
            report.setdefault(entry, []).append(line.split(": ", 1)[-1].strip())
    return report


# ------------------------------------------------------------ 1. environment
def environment():
    from bigdl_tpu_torch.ops import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         "device": torch.cuda.get_device_name(0),
         "capability": list(torch.cuda.get_device_capability(0))})
    cached = {name: _build._target(name).exists() for name in _build.KERNELS}
    build_s = _build.build()
    log({"kernel_build_s": build_s, "kernels": list(_build.KERNELS)})
    for name, text in _build.BUILD_LOGS.items():
        log({"ptxas": name, "built_in_this_run": not cached[name],
             "entries": ptxas_report(text)})
    return card


# ---------------------------------------------------------------- 2. kernels
def _qkv(gen, b, sq, sk, n, d, dtype):
    mk = lambda s: torch.randn((b, s, n, d), generator=gen, device="cuda")
    return mk(sq).to(dtype), mk(sk).to(dtype), mk(sk).to(dtype)


FLASH_ATOL = 5e-5
INT8_RTOL = 1e-4


def flash_o_close(o: torch.Tensor, po: torch.Tensor):
    """K1's O against the plain version's, element by element: within
    FLASH_ATOL in float32 (f32 sums in another order, values of order 1-10);
    in bfloat16 within one bf16 step of the element, 2^-7 * |po|, plus
    FLASH_ATOL (both round nearly the same f32 value, which may sit on a
    rounding boundary). Returns (max |o - po|, whether every element holds)."""
    diff = (o.float() - po.float()).abs()
    tol = (2 ** -7 * po.float().abs() if o.dtype == torch.bfloat16
           else torch.zeros_like(diff)) + FLASH_ATOL
    return diff.max().item(), bool((diff <= tol).all().item())


def launched_variant(counters, variant_of, fn):
    """Runs ``fn`` (one launch of each kernel that ``counters`` lists as
    (``LAUNCHES``, ``LAUNCHES_MMA``) pairs, or (``LAUNCHES``,
    ``LAUNCHES_MMA``, ``LAUNCHES_TF32``) triples for a kernel with a
    "tf32x3" variant) and returns the variant that ``variant_of`` names,
    checked against every entry: one launch, one "mma" launch exactly when
    the variant is "mma" and one "tf32x3" launch exactly when it is
    "tf32x3"."""
    names = ("mma", "tf32x3")
    before = [tuple(c.value for c in entry) for entry in counters]
    out = fn()
    want = variant_of()
    for entry, was in zip(counters, before):
        got = tuple(c.value - v for c, v in zip(entry, was))
        check(got == (1, *(int(want == n) for n in names[:len(entry) - 1])),
              f"{want} call counted {got} (launches, mma launches"
              f"{', tf32x3 launches' if len(entry) > 2 else ''})")
    return want, out


def k1_counters() -> list:
    """K1's entry for ``launched_variant``: its three counters."""
    from bigdl_tpu_torch.ops import flash_attention as fa
    return [(fa.LAUNCHES, fa.LAUNCHES_MMA, fa.LAUNCHES_TF32)]


def k1_variant_of(dtype) -> str:
    """The variant K1 takes for q of ``dtype``: mma for bf16, tf32x3 for
    f32."""
    return "mma" if dtype == torch.bfloat16 else "tf32x3"


def k1_f32_control(q, k, v, causal: bool) -> dict:
    """K1's control: the plain version on tf32-rounded q, k and v
    (``precision.to_tf32``) against the plain version, which must land
    past FLASH_ATOL in O or LSE, so that the tolerance tells K1's
    3xTF32 products from one tf32 pass. Returns both distances."""
    from bigdl_tpu_torch.ops.flash_attention import flash_attention_plain
    from bigdl_tpu_torch.ops.precision import to_tf32
    po, plse = flash_attention_plain(q, k, v, causal=causal)
    to, tlse = flash_attention_plain(to_tf32(q), to_tf32(k), to_tf32(v),
                                     causal=causal)
    out = {"o": (to - po).abs().max().item(),
           "lse": (tlse - plse).abs().max().item(), "tol": FLASH_ATOL}
    check(max(out["o"], out["lse"]) > FLASH_ATOL,
          f"K1's tf32 control landed within FLASH_ATOL: {out}")
    return out


def check_flash():
    """K1 against ``flash_attention_plain`` (O as in ``flash_o_close``, LSE
    within FLASH_ATOL), at the served prefill shapes (B=4, S in {384, 128},
    causal), the training shape (B=8, S=512, causal, bf16) and at ragged,
    full, D=128, Sq != Sk and single-row cases; every bf16 case takes the
    "mma" variant and every f32 case the "tf32x3" one, whose second run
    must give the same bits; then ``k1_f32_control`` at B=2 S=384 causal."""
    from bigdl_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(1)
    dtypes = (torch.float32, torch.bfloat16)
    cases = [(dt, causal, 2, s, s, 12, 64)
             for dt in dtypes for causal in (True, False) for s in (384, 333)]
    cases += [(dt, True, REQUESTS_PER_LEN, s, s, 12, 64)
              for dt in dtypes for s in PROMPT_LENS]
    cases += [(torch.bfloat16, True, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 12, 64),
              (torch.bfloat16, True, 1, 200, 200, 4, 128),
              (torch.float32, False, 2, 100, 333, 3, 128),
              (torch.float32, True, 4, 1, 1, 12, 64)]
    counters = k1_counters()
    worst, variants = 0.0, {}
    for dt, causal, b, sq, sk, n, d in cases:
        q, k, v = _qkv(gen, b, sq, sk, n, d, dt)
        variant, (o, lse) = launched_variant(
            counters, lambda: fa.kernel_variant(q),
            lambda: fa.flash_attention_with_lse(q, k, v, causal=causal))
        po, plse = fa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err_o, ok_o = flash_o_close(o, po)
        err_l = (lse - plse).abs().max().item()
        what = f"{dt} causal={causal} B={b} Sq={sq} Sk={sk} N={n} D={d}"
        check(o.shape == q.shape and lse.shape == (b, n, sq)
              and o.dtype == dt, f"flash output shapes, B={b} Sq={sq}")
        check(ok_o and err_l <= FLASH_ATOL,
              f"flash {what}: |dO|={err_o} |dLSE|={err_l}")
        check(variant == k1_variant_of(dt),
              f"flash {what} took the {variant} variant")
        if dt == torch.float32:
            o2, lse2 = fa.flash_attention_with_lse(q, k, v, causal=causal)
            check(torch.equal(o, o2) and torch.equal(lse, lse2),
                  f"flash {what}: a second run gave other bits")
        variants[what] = variant
        worst = max(worst, err_o)
    for dt in (torch.float32, torch.bfloat16):
        # dead row: every logit of (b=0, s=5, h=0) overflows to -inf
        q, k, v = _qkv(gen, 1, 70, 70, 2, 64, dt)
        q[0, 5, 0] = 0
        q[0, 5, 0, 0] = -3e38
        k[:, :, 0, 0] = 100
        variant, (o, lse) = launched_variant(
            counters, lambda: fa.kernel_variant(q),
            lambda: fa.flash_attention_with_lse(q, k, v, causal=True))
        po, plse = fa.flash_attention_plain(q, k, v, causal=True)
        check(lse[0, 0, 5].item() == fa.NEG and plse[0, 0, 5].item() == fa.NEG,
              f"dead-row LSE sentinel ({dt}, {variant})")
        check(o[0, 5, 0].abs().max().item() == 0.0, f"dead-row O ({dt})")
        check(torch.isfinite(o.float()).all().item()
              and torch.isfinite(lse).all().item(), f"dead-row finite ({dt})")
        variants[f"{dt} dead row"] = variant
    q, k, v = _qkv(gen, 2, 384, 384, 12, 64, torch.float32)
    control = k1_f32_control(q, k, v, True)
    log({"check": "flash_fwd", "cases": len(cases) + 2, "max_abs_err_o": worst,
         "variants": variants, "tf32_control_b2_s384": control})


BWD_F32_RTOL, BWD_F32_ATOL = 1e-4, 1e-5
BWD_BF16_ATOL = 1e-5


def bwd_close(got: torch.Tensor, ref: torch.Tensor):
    """A backward kernel's output against the plain version's, element by
    element. float32: within BWD_F32_RTOL * max|ref| + BWD_F32_ATOL (f32
    sums of up to Sk or Sq products in another order). bfloat16: within one
    bf16 step of the element, 2^-7 * |ref|, plus BWD_BF16_ATOL: both round
    an f32 sum to bf16, and where that sum is near zero its f32 ordering
    error, and in the mma variants the split of p and dS into bf16 pieces,
    is large against the element's own step (on an H100 the largest excess
    over one step measured 4.6e-8 with the f32 FMA kernels; the mma
    variants' reading per gradient, seeds 5-8 at the training shape, is
    ``check_flash_bwd``'s log). Returns (max |got - ref|, the largest
    excess over the one-step part in bf16, or the error over max|ref| in
    f32, whether all hold)."""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    if got.dtype == torch.bfloat16:
        step = 2 ** -7 * r.abs()
        ok = diff <= step + BWD_BF16_ATOL
        excess = (diff - step).clamp_min(0).max().item()
    else:
        ok = diff <= BWD_F32_RTOL * r.abs().max() + BWD_F32_ATOL
        excess = (diff.max() / r.abs().max().clamp_min(1e-30)).item()
    return (diff.max().item(), excess,
            bool(ok.all().item() and torch.isfinite(g).all().item()))


def _function_grads(q, k, v, g_o, g_lse, causal):
    """(o, lse, dq, dk, dv) through ``FlashAttention``: K1, then K2 + K3."""
    from bigdl_tpu_torch.ops.flash_attention import flash_attention_with_lse
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    o, lse = flash_attention_with_lse(q, k, v, causal=causal)
    if g_lse is None:
        o.backward(g_o)
    else:
        torch.autograd.backward((o, lse), (g_o, g_lse))
    return o.detach(), lse.detach(), q.grad, k.grad, v.grad


def check_flash_bwd():
    """K2 and K3 through the autograd Function against
    ``flash_attention_bwd_plain`` fed the same o, lse and cotangents (see
    ``bwd_close``): at the training shape in bf16 (B=8 S=512 N=12 D=64,
    causal, with and without an LSE cotangent, inputs from seeds 5-8, each
    gradient's largest excess over one bf16 step logged), f32 causal and
    full at S in {384, 333}, D=128, Sq != Sk, one row, and the dead row of
    ``check_flash``. Then the Function against autograd through the plain
    attention core at the training shape in f32. Every bf16 case (D=128
    included) must launch K2's and K3's "mma" variants and every f32 case
    their "fma" ones (``bwd_kernel_variant``), by the counters; an f32
    case's forward is K1's "tf32x3", whose LSE they read. Returns the worst
    |error| of dQ (K2)
    and of dK/dV (K3) at the training shape."""
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.ops.attention_core import dot_product_attention
    from bigdl_tpu_torch.ops.flash_attention import flash_attention_bwd_plain
    gen = torch.Generator(device="cuda").manual_seed(6)
    counters = [(fa.LAUNCHES_DQ, fa.LAUNCHES_DQ_MMA),
                (fa.LAUNCHES_DKV, fa.LAUNCHES_DKV_MMA)]
    variants = {}

    def grads_of(q, k, v, g_o, g_lse, causal, what):
        variant, out = launched_variant(
            counters, lambda: fa.bwd_kernel_variant(q),
            lambda: _function_grads(q, k, v, g_o, g_lse, causal))
        check(variant == ("mma" if q.dtype == torch.bfloat16 else "fma"),
              f"flash bwd {what} took the {variant} variant")
        variants[what] = variant
        return out

    bf16, f32 = torch.bfloat16, torch.float32
    n_train = CONFIG["num_heads"]
    # (dtype, causal, B, Sq, Sk, N, D, with an LSE cotangent, input seed:
    # None draws from ``gen``, a number from a generator of its own)
    train = [(bf16, True, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, n_train, 64, g,
              seed) for seed in (5, 6, 7, 8) for g in (False, True)]
    others = [(f32, causal, 2, s, s, n_train, 64, True)
              for causal in (True, False) for s in (384, 333)]
    others += [(bf16, False, 2, 333, 333, n_train, 64, True),
               (bf16, True, 1, 200, 200, 4, 128, True),
               (f32, True, 2, 333, 333, 3, 128, False),
               (f32, False, 2, 100, 333, 3, 64, True),
               (bf16, False, 2, 333, 100, 3, 128, True),
               (f32, True, 4, 1, 1, n_train, 64, True)]
    cases = train + [case + (None,) for case in others]
    worst = {"dq": 0.0, "dkv": 0.0}
    excess = {f32: 0.0, bf16: 0.0}
    train_excess = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    for dt, causal, b, sq, sk, n, d, with_g_lse, seed in cases:
        g = gen if seed is None else torch.Generator(
            device="cuda").manual_seed(seed)
        q, k, v = _qkv(g, b, sq, sk, n, d, dt)
        g_o = torch.randn(q.shape, generator=g, device="cuda").to(dt)
        g_lse = (torch.randn((b, n, sq), generator=g, device="cuda")
                 if with_g_lse else None)
        what = (f"{dt} causal={causal} B={b} Sq={sq} Sk={sk} N={n} D={d} "
                f"g_lse={with_g_lse}")
        if seed is not None:
            what += f" seed={seed}"
        o, lse, *grads = grads_of(q, k, v, g_o, g_lse, causal, what)
        plain = flash_attention_bwd_plain(q, k, v, o, lse, g_o, g_lse,
                                          causal, 1.0 / d ** 0.5)
        torch.cuda.synchronize()
        for name, got, ref in zip(("dq", "dk", "dv"), grads, plain):
            err, ex, ok = bwd_close(got, ref)
            check(ok and got.shape == ref.shape and got.dtype == dt,
                  f"flash bwd {name} {what}: |err| {err} "
                  f"(bf16: excess over one step; f32: over max|ref|: {ex})")
            excess[dt] = max(excess[dt], ex)
            if seed is not None:
                train_excess[name] = max(train_excess[name], ex)
            if (b, sq) == (TRAIN_BATCH, TRAIN_SEQ):
                key = "dq" if name == "dq" else "dkv"
                worst[key] = max(worst[key], err)
    for dt in (f32, bf16):
        # the dead row of check_flash: (b=0, s=5, h=0) sees only -inf logits
        q, k, v = _qkv(gen, 1, 70, 70, 2, 64, dt)
        q[0, 5, 0] = 0
        q[0, 5, 0, 0] = -3e38
        k[:, :, 0, 0] = 100
        g_o = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
        g_lse = torch.randn((1, 2, 70), generator=gen, device="cuda")
        o, lse, *grads = grads_of(q, k, v, g_o, g_lse, True, f"{dt} dead row")
        plain = flash_attention_bwd_plain(q, k, v, o, lse, g_o, g_lse, True,
                                          1.0 / 8)
        for name, got, ref in zip(("dq", "dk", "dv"), grads, plain):
            err, _, ok = bwd_close(got, ref)
            check(ok and torch.isfinite(ref.float()).all().item(),
                  f"dead-row {name} ({dt}): |err| {err}")
        check(grads[0][0, 5, 0].abs().max().item() == 0.0,
              f"dead-row dQ is not 0 ({dt})")
    # the Function against autograd through the plain core, f32, training shape
    q, k, v = _qkv(gen, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, n_train, 64, f32)
    g_o = torch.randn(q.shape, generator=gen, device="cuda")
    _, _, *grads = grads_of(q, k, v, g_o, None, True, "f32 vs plain core")
    ts = [t.detach().requires_grad_() for t in (q, k, v)]
    dot_product_attention(*ts, causal=True).backward(g_o)
    autograd_err = 0.0
    for name, got, t in zip(("dq", "dk", "dv"), grads, ts):
        err, _, ok = bwd_close(got, t.grad)
        check(ok, f"Function vs autograd of the plain core, {name}: {err}")
        autograd_err = max(autograd_err, err)
    log({"check": "flash_bwd", "cases": len(cases) + 3,
         "max_abs_err_dq_train_shape": worst["dq"],
         "max_abs_err_dkv_train_shape": worst["dkv"],
         "bf16_max_excess_over_one_step": excess[bf16],
         "bf16_train_shape_excess_over_one_step_seeds_5_8": train_excess,
         "f32_max_err_over_max_ref": excess[f32],
         "function_vs_plain_core_autograd_f32": autograd_err,
         "variants": variants})
    return worst


def check_int8():
    """K4 against ``int8_matmul_plain`` through the public ``int8_matmul``
    (compute dtype f32, with and without a bias), M in {1, 4 (the served
    decode batch), 8} and the larger M of the rule; two runs give the same
    bits (K4 reduces its split-K partials in a fixed order). Tolerance:
    INT8_RTOL of max|y|: the same exact int8 x bf16 products summed in f32
    in another order (K <= 3072)."""
    from bigdl_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain
    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = [(768, 768), (256, 768), (3072, 768), (768, 3072), (32000, 768),
              (1100, 768)]
    cases = [(m, o, kd) for m in (1, REQUESTS_PER_LEN, 8) for o, kd in shapes]
    cases += [(9, 768, 768), (256, 1100, 768), (256, 768, 3072)]
    worst = 0.0
    for m, o, kd in cases:
        w = torch.randint(-127, 128, (o, kd), generator=gen, device="cuda",
                          dtype=torch.int8)
        s = torch.rand((o, 1), generator=gen, device="cuda") * 1e-2 + 1e-3
        x = torch.randn((m, kd), generator=gen, device="cuda")
        bias = torch.randn((o,), generator=gen, device="cuda")
        for xdt in (torch.float32, torch.bfloat16):
            for b in (None, bias):
                y = int8_matmul(x.to(xdt), w, s, b, torch.float32)
                again = int8_matmul(x.to(xdt), w, s, b, torch.float32)
                ref = int8_matmul_plain(x.to(xdt), w, s.reshape(o))
                if b is not None:
                    ref = ref + b
                torch.cuda.synchronize()
                err = (y - ref).abs().max().item()
                tol = INT8_RTOL * ref.abs().max().item()
                check(y.shape == (m, o) and err <= tol
                      and torch.equal(y, again),
                      f"int8 M={m} O={o} K={kd} x={xdt} bias={b is not None}:"
                      f" err {err} > {tol}, or two runs differ")
                worst = max(worst, err / max(ref.abs().max().item(), 1e-30))
    log({"check": "int8_matmul", "cases": 4 * len(cases),
         "max_rel_err": worst})


CONV_F32_RTOL, CONV_F32_ATOL = 1e-4, 1e-5
CONV_BF16_ATOL = 1e-5
STATS_RTOL = 1e-5
CONV_GRAD_RTOL = 1e-4
RESNET_WIDTHS, RESNET_REPS = (64, 128, 256, 512), (3, 4, 6, 3)


def resnet50_convs(b: int):
    """Every conv of ResNet-50's fused pairs at batch b, in model order:
    1x1 as (N, H, W, Cin, Cout, stride), the stride-2 projections taking
    the full-resolution input that the module subsamples, and stride-1 3x3
    as (N, H, W, Cin, Cout)."""
    ones, threes = [], []
    hw, n_in = 56, 64
    for stage, (width, reps) in enumerate(zip(RESNET_WIDTHS, RESNET_REPS)):
        for i in range(reps):
            stride = 2 if stage > 0 and i == 0 else 1
            out_hw = hw // stride
            ones.append((b, hw, hw, n_in, width, 1))
            if stride == 1:
                threes.append((b, hw, hw, width, width))
            ones.append((b, out_hw, out_hw, width, 4 * width, 1))
            if i == 0:
                ones.append((b, hw, hw, n_in, 4 * width, stride))
            hw, n_in = out_hw, 4 * width
    return ones, threes


def resnet50_conv_shapes(b: int):
    """The distinct shapes of ``resnet50_convs(b)``."""
    ones, threes = resnet50_convs(b)
    return list(dict.fromkeys(ones)), list(dict.fromkeys(threes))


def resnet50_1x1_step(b: int) -> collections.Counter:
    """K5's launches in one training step at batch b: {(M, K, N): count}
    (a stride-2 projection's M after the subsample)."""
    ones, _ = resnet50_convs(b)
    return collections.Counter(
        (n * ((h + s - 1) // s) * ((w + s - 1) // s), cin, cout)
        for n, h, w, cin, cout, s in ones)


def y_close(got: torch.Tensor, ref: torch.Tensor):
    """A fused kernel's y against its plain version's, element by element.
    float32: within CONV_F32_RTOL * max|ref| + CONV_F32_ATOL (f32 sums of up
    to 9 * 512 products in another order). bfloat16: within one bf16 step
    of the element, 2^-7 * |ref|, plus CONV_BF16_ATOL: both round an f32
    sum to bf16, and where that sum is near zero its f32 ordering error can
    exceed the element's own step (on an H100 the largest excess over one
    step measured 1.2e-6, at the training run's B=256 shapes, so the atol
    keeps a margin of 8). Returns (max
    |got - ref|, the largest excess over the one-step part in bf16 or the
    error over max|ref| in f32, whether every element holds)."""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    if got.dtype == torch.bfloat16:
        step = 2 ** -7 * r.abs()
        ok = diff <= step + CONV_BF16_ATOL
        excess = (diff - step).clamp_min(0).max().item()
    else:
        ok = diff <= CONV_F32_RTOL * r.abs().max() + CONV_F32_ATOL
        excess = (diff.max() / r.abs().max().clamp_min(1e-30)).item()
    return (diff.max().item(), excess,
            bool(ok.all().item() and torch.isfinite(g).all().item()))


def stats_close(got, ref, y_ref: torch.Tensor):
    """The kernel's (col_sum, col_sumsq) against the plain version's, per
    channel, within STATS_RTOL of sum|y| and of sum y^2 of that channel
    (f32 sums of up to 802,816 values in another order; an H100 run
    measured at most 6.7e-7, in f32 and bf16 alike, since both sum f32
    products). Returns the largest error over those scales and whether
    both hold."""
    y = y_ref.float().reshape(-1, y_ref.shape[-1])
    worst, ok = 0.0, True
    for g, r, scale in ((got[0], ref[0], y.abs().sum(0)),
                        (got[1], ref[1], (y * y).sum(0))):
        rel = ((g - r).abs() / scale.clamp_min(1e-30)).max().item()
        worst = max(worst, rel)
        ok = ok and rel <= STATS_RTOL and bool(torch.isfinite(g).all().item())
    return worst, ok


def _stats_case(name, fn, plain, x, w, module, worst):
    """One K5 or K6 case (``name`` starts with "K5" or "K6"): two runs of
    ``fn`` against ``plain``, y as in ``y_close``, the statistics as in
    ``stats_close``, y and the statistics bit-identical on the second run,
    and the variant taken (``module.kernel_variant``) the rule's: with both
    channel counts, w's last two dimensions, multiples of 8, ``mma`` for
    bf16 and (K6) ``tf32x3`` for f32, else ``fma``, checked by the mma and
    tf32x3 launches counted. Updates ``worst`` ("f32", "K5", "K6",
    "stats"); returns the variant."""
    variant = module.kernel_variant(x, w)
    aligned = w.shape[-2] % 8 == 0 and w.shape[-1] % 8 == 0
    tf32 = getattr(module, "LAUNCHES_TF32", None)   # K6 only
    want = ("fma" if not aligned else "mma" if x.dtype == torch.bfloat16
            else "tf32x3" if tf32 is not None else "fma")
    mma_before = module.LAUNCHES_MMA.value
    tf32_before = tf32.value if tf32 is not None else 0
    got, again = fn(x, w), fn(x, w)
    ref = plain(x, w)
    torch.cuda.synchronize()
    err, ex, ok = y_close(got[0], ref[0])
    st, st_ok = stats_close(got[1:], ref[1:], ref[0])
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    check(ok and st_ok and same and got[0].shape == ref[0].shape
          and got[0].dtype == x.dtype,
          f"{name} {x.dtype}: |y err| {err} (excess {ex}), stats {st}, "
          f"deterministic {same}")
    check(variant == want, f"{name} {x.dtype} took the {variant} variant")
    check(module.LAUNCHES_MMA.value - mma_before == 2 * (variant == "mma"),
          f"{name} {x.dtype}: mma launches")
    check(tf32 is None
          or tf32.value - tf32_before == 2 * (variant == "tf32x3"),
          f"{name} {x.dtype}: tf32x3 launches")
    key = "f32" if x.dtype == torch.float32 else name.split()[0]
    worst[key] = max(worst.get(key, 0.0), ex)
    worst["stats"] = max(worst.get("stats", 0.0), st)
    return variant


def check_conv_bn():
    """K5 and K6 against ``matmul_with_stats_plain`` and
    ``conv3x3_with_stats_plain`` through the public wrappers, at every
    distinct fused 1x1 and stride-1 3x3 shape of ResNet-50 at B=32 (the
    stride-2 projections through the module's subsample and copy) and at
    the reference tests' ragged shapes (K=3, K=12, odd 5x7 images, Cin=3,
    Cout off the 64-channel tile), each in f32 and bf16, and at every such
    shape of the training run (B=RESNET_BATCH, bf16): y as in ``y_close``,
    the statistics as in ``stats_close``, and two runs of each kernel give
    bit-identical y and statistics. Each case takes the variant its
    kernel's rule names (both channel counts multiples of 8: ``mma`` for
    bf16, K6's ``tf32x3`` for f32), checked by the ``LAUNCHES_MMA`` and
    ``LAUNCHES_TF32`` counters; K5's and K6's bf16 excess over one step is
    logged apart, and K5's must stay within half of CONV_BF16_ATOL. Then
    ``k6_f32_control`` at the B=32 stage-3 and stage-4 shapes."""
    from bigdl_tpu_torch.ops import conv3x3_bn, matmul_bn
    from bigdl_tpu_torch.ops.conv3x3_bn import (conv3x3_with_stats,
                                                conv3x3_with_stats_plain)
    from bigdl_tpu_torch.ops.matmul_bn import (matmul_with_stats,
                                               matmul_with_stats_plain)
    gen = torch.Generator(device="cuda").manual_seed(9)
    f32, bf16 = torch.float32, torch.bfloat16
    ones, threes = resnet50_conv_shapes(32)
    mm_cases = ones + [(1, 1, m, k, n, 1) for m, k, n in
                       ((512, 64, 256), (300, 48, 100), (64, 16, 128),
                        (257, 3, 5), (1000, 12, 70))]
    conv_cases = threes + [(2, 8, 8, 4, 8), (1, 5, 7, 3, 2), (3, 4, 4, 8, 16),
                           (2, 6, 9, 16, 70)]
    train_ones, train_threes = resnet50_conv_shapes(RESNET_BATCH)
    runs = [(f32, mm_cases, conv_cases), (bf16, mm_cases, conv_cases),
            (bf16, train_ones, train_threes)]
    worst = {"f32": 0.0, "K5": 0.0, "K6": 0.0, "stats": 0.0}
    variants = {"K5": {}, "K6": {}}

    def one(kernel, name, fn, plain, x, w, module):
        variants[kernel][f"{name} {str(x.dtype)[6:]}"] = _stats_case(
            name, fn, plain, x, w, module, worst)

    for dt, k5_cases, k6_cases in runs:
        for n, h, w, cin, cout, s in k5_cases:
            x = torch.randn((n, h, w, cin), generator=gen, device="cuda").to(dt)
            wt = (torch.randn((cin, cout), generator=gen, device="cuda")
                  / cin ** 0.5).to(dt)
            x2d = x[:, ::s, ::s, :].reshape(-1, cin)  # as FusedConv1x1BN does
            one("K5", f"K5 M={x2d.shape[0]} K={cin} N={cout} stride={s}",
                matmul_with_stats, matmul_with_stats_plain, x2d, wt, matmul_bn)
        for n, h, w, cin, cout in k6_cases:
            x = torch.randn((n, h, w, cin), generator=gen, device="cuda").to(dt)
            wt = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda")
                  / (9 * cin) ** 0.5).to(dt)
            one("K6", f"K6 N={n} {h}x{w} {cin}->{cout}", conv3x3_with_stats,
                conv3x3_with_stats_plain, x, wt, conv3x3_bn)
    # the mma designs are held to half the bf16 atol (K6 read 1.6e-6)
    check(worst["K5"] <= CONV_BF16_ATOL / 2,
          f"K5 bf16 excess over one step {worst['K5']} > {CONV_BF16_ATOL / 2}")
    control = {f"{h}x{w} {cin}->{cout}": k6_f32_control(gen, n, h, w, cin,
                                                        cout)
               for n, h, w, cin, cout in threes[2:]}
    log({"check": "conv_bn_kernels", "k6_tf32_control_b32": control,
         "cases": sum(len(a) + len(b) for _, a, b in runs),
         "k5_shapes_resnet50_b32": len(ones), "k6_shapes_resnet50_b32":
         len(threes), f"k5_k6_shapes_resnet50_b{RESNET_BATCH}_bf16":
         [len(train_ones), len(train_threes)],
         "f32_max_err_over_max_ref": worst["f32"],
         "bf16_max_excess_over_one_step": max(worst["K5"], worst["K6"]),
         "k5_bf16_max_excess_over_one_step": worst["K5"],
         "k6_bf16_max_excess_over_one_step": worst["K6"],
         "stats_max_err_over_scale": worst["stats"],
         "k5_variants": variants["K5"], "k6_variants": variants["K6"]})


def k6_f32_control(gen, n, h, w, cin, cout) -> dict:
    """K6's control: ``conv3x3_with_stats_plain`` on tf32-rounded x and w
    (``precision.to_tf32``) against the plain version on x and w, which
    must land past ``y_close``'s f32 tolerance (CONV_F32_RTOL of max|y|
    plus CONV_F32_ATOL), so that it tells K6's 3xTF32 products from one
    tf32 pass. Returns the y error over max|y| and the statistics' error
    over their scales (``stats_close``)."""
    from bigdl_tpu_torch.ops.conv3x3_bn import conv3x3_with_stats_plain
    from bigdl_tpu_torch.ops.precision import to_tf32
    x = torch.randn((n, h, w, cin), generator=gen, device="cuda")
    wt = torch.randn((3, 3, cin, cout), generator=gen,
                     device="cuda") / (9 * cin) ** 0.5
    ref = conv3x3_with_stats_plain(x, wt)
    got = conv3x3_with_stats_plain(to_tf32(x), to_tf32(wt))
    _, ex, ok = y_close(got[0], ref[0])
    st, st_ok = stats_close(got[1:], ref[1:], ref[0])
    check(not ok, f"K6's tf32 control at N={n} {h}x{w} {cin}->{cout} landed "
          f"within the f32 tolerance: {ex} of max|y|")
    return {"y_err_over_max": ex, "rtol": CONV_F32_RTOL, "stats": st,
            "stats_within_rtol": st_ok}


def check_conv_bn_autograd():
    """``conv1x1_bn_train`` (K5) and ``conv3x3_bn_train`` (K6) against
    autograd through the plain composition (the f32 product or conv, then
    ``batch_norm_train``), in f32 at ResNet-50 stage-3 shapes (B=32, 14x14:
    1x1 1024 -> 256, 3x3 256 -> 256), with a random cotangent: out, dx,
    dw, dgamma and dbeta within CONV_GRAD_RTOL of max|ref| per tensor."""
    from bigdl_tpu_torch.ops.conv3x3_bn import _conv3x3, conv3x3_bn_train
    from bigdl_tpu_torch.ops.conv_bn import conv1x1_bn_train
    gen = torch.Generator(device="cuda").manual_seed(10)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    cases = {
        "conv1x1_bn_train": (conv1x1_bn_train, lambda x, w: x @ w,
                             rnd(32 * 14 * 14, 1024), rnd(1024, 256) / 32),
        "conv3x3_bn_train": (conv3x3_bn_train, _conv3x3,
                             rnd(32, 14, 14, 256), rnd(3, 3, 256, 256) / 48)}
    _autograd_cases(cases, rnd, "conv_bn_autograd_f32")


def _autograd_cases(cases, rnd, label):
    """Each case {name: (fused Function, plain product, x, w)} in f32 with
    a random gamma, beta and cotangent from ``rnd``: out, dx, dw, dgamma
    and dbeta of the fused Function within CONV_GRAD_RTOL of max|ref|
    against autograd through the product and ``batch_norm_train``."""
    from bigdl_tpu_torch.ops.batch_norm import batch_norm_train
    worst = {}
    for name, (fused, product, x, w) in cases.items():
        cout = w.shape[-1]
        g, b = 1 + 0.1 * rnd(cout), 0.1 * rnd(cout)
        cot = rnd(*x.shape[:-1], cout)
        grads = []
        for path in ("fused", "plain"):
            ts = [t.detach().clone().requires_grad_() for t in (x, w, g, b)]
            if path == "fused":
                out, _, _ = fused(*ts, 1e-5)
            else:
                out, _, _ = batch_norm_train(product(ts[0], ts[1]), ts[2],
                                             ts[3], 1e-5)
            out.backward(cot)
            grads.append([out.detach()] + [t.grad for t in ts])
        torch.cuda.synchronize()
        errs = []
        for what, got, ref in zip(("out", "dx", "dw", "dgamma", "dbeta"),
                                  *grads):
            err = ((got - ref).abs().max() / ref.abs().max()).item()
            check(err <= CONV_GRAD_RTOL and torch.isfinite(got).all().item(),
                  f"{name} {what} against autograd of the plain composition:"
                  f" {err} of max|ref|")
            errs.append(err)
        worst[name] = max(errs)
    log({"check": label, **worst})


HBM_PROBE_BYTES = 1 << 30   # the probe's --gib 1: bytes of each array
STAGED_DEALS_AT = (32768, 4, 0)  # K7b (chunk, slots, lag) read at every deal
READ_RTOL = 1e-6


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in bf16 steps, element by element, from the bit patterns
    (+0 and -0 are one value)."""
    def ordered(t):
        u = t.view(torch.int16).int() & 0xFFFF
        return torch.where(u >= 0x8000, 0x8000 - u, u)
    return (ordered(a) - ordered(b)).abs()


def direct_copy_overlap() -> dict:
    """K7c at every stream count over the probe's 1 GiB shape, once with
    its %globaltimer stamps: each range's first block's start and last
    block's end. The ranges ran side by side when the latest start comes
    before the earliest end, which must hold for two streams or more: one
    launch deals neighbouring blocks to different ranges, so it holds by
    construction unless the launch is serialised."""
    from bigdl_tpu_torch.ops import hbm_roof as hr
    from bigdl_tpu_torch.scripts.roofline_hbm import DMA_STREAMS, hbm_dma_shape
    seen = {}
    for ns in DMA_STREAMS:
        x = torch.ones(hbm_dma_shape(HBM_PROBE_BYTES, ns), dtype=torch.bfloat16,
                       device="cuda")
        out = hr.direct_copy(x, ns)
        stamps = torch.zeros(2 * ns, dtype=torch.int64, device="cuda")
        hr.direct_copy(x, ns, out, stamps=stamps)
        ranges = stamps.view(ns, 2).tolist()
        t0 = min(start for start, _ in ranges)
        together = (min(end for _, end in ranges)
                    - max(start for start, _ in ranges)) / 1e3
        seen[ns] = {"ranges_us": [[(a - t0) / 1e3, (b - t0) / 1e3]
                                  for a, b in ranges],
                    "all_ranges_running_us": together}
        check(ns == 1 or together > 0,
              f"K7c's {ns} ranges did not all run at one time: {ranges}")
    return seen


def staged_block_ends() -> dict:
    """K7b once with %globaltimer stamps at the probe's 1 GiB, at
    STAGED_DEALS_AT (a point the probe times at every deal): for each deal,
    when its blocks end (least, median, 90th percentile, last; us from the
    first start). Every block of a static deal has the same share of the
    chunks, so the spread of its ends is the spread of the blocks' rates,
    which the persistent grid waits out; the dynamic deal hands the faster
    blocks more chunks."""
    from bigdl_tpu_torch.ops import hbm_roof as hr
    chunk, nbuf, lag = STAGED_DEALS_AT
    blocks = hr.staged_blocks(chunk, nbuf)
    x = torch.ones(HBM_PROBE_BYTES // 2, dtype=torch.bfloat16, device="cuda")
    out = torch.empty_like(x)
    stamps = torch.zeros(2 * blocks, dtype=torch.int64, device="cuda")
    q = torch.tensor([0.0, 0.5, 0.9, 1.0], dtype=torch.float64, device="cuda")
    ends = {}
    for deal in hr.DEALS:
        hr.staged_copy(x, chunk, nbuf, out, lag=lag, deal=deal)  # warm-up
        hr.staged_copy(x, chunk, nbuf, out, lag=lag, deal=deal, stamps=stamps)
        se = stamps.view(blocks, 2).double()
        end = (se[:, 1] - se[:, 0].min()) / 1e3
        ends[deal] = [round(v, 3) for v in torch.quantile(end, q).tolist()]
    return {"chunk_nbuf_lag": list(STAGED_DEALS_AT), "blocks": blocks,
            "end_us_min_median_p90_max": ends}


def copy_device_ops():
    """The device operations that ``Tensor.copy_`` of 1 GiB of bf16 runs
    (the probe's library copy), from the profiler; None when it recorded
    nothing."""
    x = torch.ones(HBM_PROBE_BYTES // 2, dtype=torch.bfloat16, device="cuda")
    y = torch.empty_like(x)
    rows, _ = profiled(lambda: y.copy_(x), "Tensor.copy_")
    return None if rows is None else [k for k, _ in rows]


def check_hbm_roof() -> dict:
    """The K7 kernels against their plain versions on seeded N(0, 1) bf16
    inputs, at the probe's timed size (1 GiB an array) and at ragged sizes:
    K7a at every (threads, vecs, grid) of the probe's sweep, with n off the
    16-byte vector and the grid's tile; K7b at every (chunk, nbuf, lag,
    deal) of the sweep, and at every lag and deal on one block with fewer
    chunks than slots, with a chunk count that the slots do not divide, a
    short last chunk and a tail under 16 bytes; K7c at every stream count,
    on the reference's trimmed shapes from a row count that no stream count
    divides. Copies must be bit-identical; triad within one bf16 step of
    ``triad_plain`` (the count of elements one step apart is logged); read
    within READ_RTOL x sum|x| of an f64 sum, and two runs must give the same
    bits. Then K7c's overlap, K7b's block ends and the operations of
    ``Tensor.copy_``. Returns each kernel's largest |kernel - plain| at the
    timed size."""
    from bigdl_tpu_torch.ops import hbm_roof as hr
    from bigdl_tpu_torch.scripts.roofline_hbm import (AUTO_SWEEP, DMA_STREAMS,
                                                      MANUAL_SWEEP,
                                                      hbm_dma_shape)
    gen = torch.Generator(device="cuda").manual_seed(13)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16)
    n_timed = HBM_PROBE_BYTES // 2
    errs = {k: 0.0 for k in hr.COUNTERS}
    tally = {"cases": 0, "triad_elements": 0, "triad_one_step": 0,
             "read_max_err_over_sum_abs": 0.0}

    def copied(name, got, x):
        check(torch.equal(got, x), f"{name}: the copy differs ({x.numel()} "
                                   "values)")
        tally["cases"] += 1

    def k7a(n, timed):
        a, b = rnd(n), rnd(n)
        seed = torch.randn((1, 1), generator=gen, device="cuda")
        ref64 = seed.double() + a.double().sum()
        sum_abs = a.double().abs().sum().item()
        plain_read, plain_triad = hr.read_sum_plain(seed, a), hr.triad_plain(a, b)
        for threads, vecs, grid in AUTO_SWEEP:
            knobs = dict(threads=threads, vecs=vecs, grid=grid)
            what = f"n={n} block {threads}x{vecs} {grid} grid"
            copied(f"hbm copy {what}", hr.copy(a, **knobs), a)
            r1, r2 = hr.read_sum(seed, a, **knobs), hr.read_sum(seed, a, **knobs)
            rel = abs(r1.double() - ref64).item() / sum_abs
            check(rel <= READ_RTOL and torch.equal(r1, r2),
                  f"hbm read {what}: {rel} of sum|x| from the f64 sum, "
                  f"runs equal {torch.equal(r1, r2)}")
            t = hr.triad(a, b, **knobs)
            ulps = bf16_ulps(t, plain_triad)
            worst = ulps.max().item()
            check(worst <= 1, f"hbm triad {what}: {worst} bf16 steps off")
            tally["triad_elements"] += n
            tally["triad_one_step"] += int((ulps == 1).sum().item())
            tally["read_max_err_over_sum_abs"] = max(
                tally["read_max_err_over_sum_abs"], rel)
            tally["cases"] += 2
            if timed:
                errs["hbm_read"] = max(errs["hbm_read"],
                                       (r1 - plain_read).abs().item())
                errs["hbm_triad"] = max(errs["hbm_triad"], (
                    t.float() - plain_triad.float()).abs().max().item())

    k7a(n_timed, True)
    for n in (2 ** 20 + 3, 8 * 1000 + 7, 5):
        k7a(n, False)

    x = rnd(n_timed)
    for chunk, nbuf, lag, deal in MANUAL_SWEEP:
        copied(f"hbm staged copy {chunk}x{nbuf} lag {lag} {deal}",
               hr.staged_copy(x, chunk, nbuf, lag=lag, deal=deal), x)
    # (elements, chunk bytes, slots, blocks; 0 = the persistent grid), each
    # at every lag and deal
    for n, chunk, nbuf, blocks in (
            (3 * 8192 + 5, 16384, 4, 1),      # 3 chunks < 4 slots, 10-byte tail
            (6 * 8192 + 100, 16384, 4, 1),    # 7 chunks, 7 % 4 slots, short last
            (7 * 8192 + 1000, 16384, 3, 1),   # 8 chunks, 8 % 3 slots
            (2 ** 20 + 3, 49152, 4, 0),       # ragged ranges on the whole grid
            (2 ** 20, 16384, 2, 3),           # three blocks, many fills a slot
            (5, 16, 2, 0)):                   # the tail alone
        x = rnd(n)
        for lag in range(nbuf):
            for deal in hr.DEALS:
                copied(f"hbm staged copy n={n} {chunk}x{nbuf} lag {lag} {deal} "
                       f"blocks={blocks}", hr.staged_copy(
                           x, chunk, nbuf, blocks=blocks, lag=lag, deal=deal), x)

    for total in (HBM_PROBE_BYTES, 1001 * 2048 + 1234):
        for ns in DMA_STREAMS:
            x = rnd(*hbm_dma_shape(total, ns))
            copied(f"hbm direct copy {tuple(x.shape)} nstreams={ns}",
                   hr.direct_copy(x, ns), x)
    try:
        hr.direct_copy(rnd(1001, 1024), 8)
        check(False, "hbm direct copy took rows that 8 streams do not split")
    except ValueError:
        pass
    torch.cuda.synchronize()
    log({"check": "hbm_roof", **tally, **{f"max_abs_err_{k}": v
                                          for k, v in errs.items()},
         "direct_copy_overlap": direct_copy_overlap(),
         "staged_block_ends": staged_block_ends(),
         # before any other profiler session: late in a long process the
         # profiler has come back empty
         "copy__device_ops": copy_device_ops()})
    return errs


# ------------------------------------------------------------------ 3. slice
def submit_all(server, prompts, max_new=None):
    """All prompts from one client thread each, started together; returns
    the answers and the wall seconds."""
    results = [None] * len(prompts)
    errors = []
    barrier = threading.Barrier(len(prompts))

    def client(i):
        try:
            barrier.wait(timeout=60)
            results[i] = server.submit(prompts[i], max_new, timeout=600)
        except Exception as e:  # collected and raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    seconds = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a client never returned")
    if errors:
        raise errors[0]
    return results, seconds


def serve(model, prompts):
    """All prompts from threads through one LMServer; returns the answers,
    the batches served and the wall seconds."""
    from bigdl_tpu_torch.models.lm_server import LMServer
    server = LMServer(model, max_batch=REQUESTS_PER_LEN, batch_timeout_ms=2000,
                      max_new_tokens=NEW_TOKENS, greedy=True, device="cuda")
    try:
        results, seconds = submit_all(server, prompts)
    finally:
        server.close()
    return results, server.batches_served, seconds


def time_generate(model, prompts) -> dict:
    """Prefill and decode times of one batch (host clock around work that
    ends in a synchronize), and the share of the decode run in which the
    device was busy (profiler kernel time over wall time)."""
    from bigdl_tpu_torch.models.generation import generate
    batch = torch.as_tensor(prompts, device="cuda")

    def run(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(model, batch, n, greedy=True, device="cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(NEW_TOKENS)  # warm-up
    t1 = min(run(1) for _ in range(3))
    tn = min(run(NEW_TOKENS) for _ in range(3))
    b, s = batch.shape
    rows, _ = profiled(lambda: generate(model, batch, NEW_TOKENS, greedy=True,
                                        device="cuda"), f"decode B={b} S={s}")
    # None ("not measured") when the profiler recorded nothing
    busy = (None if rows is None
            else sum(t for _, t in rows) / 1e6 / tn)
    top = ([] if rows is None else
           [(k[:60], t) for k, t in sorted(rows, key=lambda r: -r[1])[:3]])
    return {"batch": b, "prompt_len": s, "new_tokens": NEW_TOKENS,
            "prefill_ms": t1 * 1e3,
            "decode_ms_per_token": (tn - t1) / (NEW_TOKENS - 1) * 1e3,
            "tokens_per_s": b * NEW_TOKENS / tn,
            "device_busy_share": busy, "top_kernels_us": top}


def run_slice():
    from bigdl_tpu_torch.models.generation import generate
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.nn.quantized import cast_model, quantize_model
    from bigdl_tpu_torch.ops import flash_attention, int8_matmul

    t0 = time.perf_counter()
    base = build_lm(VOCAB, **CONFIG, device="cuda", seed=7).evaluate_mode()
    twins = {"bf16": cast_model(base, torch.bfloat16, device="cuda"),
             "int8": quantize_model(base, torch.bfloat16, device="cuda")}
    n_params = sum(p.numel() for p in base.parameters())
    log({"model": "134m", "params": n_params,
         "build_s": time.perf_counter() - t0})
    rng = np.random.default_rng(0)
    groups = {s: [rng.integers(1, VOCAB + 1, s).tolist()
                  for _ in range(REQUESTS_PER_LEN)] for s in PROMPT_LENS}
    prompts = [p for s in PROMPT_LENS for p in groups[s]]

    counters = (flash_attention.LAUNCHES, flash_attention.LAUNCHES_MMA,
                int8_matmul.LAUNCHES, int8_matmul.DEQUANT_CALLS)
    launches = {"flash_fwd": 0, "flash_fwd_mma": 0, "int8_matmul": 0}
    answers = {}
    for name, model in twins.items():
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.reset()
        results, batches, seconds = serve(model, prompts)
        k1, k1_mma, k4, deq = (c.value for c in counters)
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        launches["flash_fwd"] += k1
        launches["flash_fwd_mma"] += k1_mma
        launches["int8_matmul"] += k4
        answers[name] = results
        layers = CONFIG["num_layers"]
        per_token = 7 * layers + 1  # q, k, v, out, up, gate, down; the head
        # each batch: a prefill of M = 4 * prompt_len > 256 rows takes the
        # dequantize path except the head, which reads the last position
        # only (M = 4), then NEW_TOKENS - 1 single-token steps
        k4_want = (1 + per_token * (NEW_TOKENS - 1)) * batches
        log({"twin": name, "served": len(results), "batches": batches,
             "serve_s": seconds, "k1_launches": k1, "k1_mma_launches": k1_mma,
             "k4_launches": k4, "dequant_calls": deq,
             "peak_allocated_mib": peak_mb})
        check(batches == len(PROMPT_LENS), f"{name}: {batches} batches")
        check(k1_mma == k1 == layers * batches and k1 > 0,
              f"{name}: prefill launched K1 {k1} times, {k1_mma} of them "
              "the mma variant")
        if name == "int8":
            check(k4 == k4_want and k4 > 0 and deq == (per_token - 1) * batches,
                  f"int8 twin launched K4 {k4} times (want {k4_want}), "
                  f"dequantized {deq} times")
        else:
            check(k4 == 0 and deq == 0, "bf16 twin touched the int8 path")

    for name, model in twins.items():
        for s in PROMPT_LENS:
            direct = generate(model, groups[s], NEW_TOKENS, greedy=True,
                              device="cuda")[:, s:].cpu().tolist()
            for p, want in zip(groups[s], direct):
                got = answers[name][prompts.index(p)]
                check(got == want, f"{name}: LMServer answer != generate "
                                   f"(prompt length {s})")
                check(len(got) == NEW_TOKENS
                      and all(1 <= t <= VOCAB for t in got),
                      f"{name}: malformed continuation")
        log({"twin": name, "answers_equal_generate": True})

    # the twins against the f32 model on a small input: finite log-probs of
    # the expected shape whose top-1 token agrees at (nearly) every position
    ids = torch.as_tensor(rng.integers(1, VOCAB + 1, (1, 64)), device="cuda")
    with torch.inference_mode():
        ref = base(ids)
        for name, model in twins.items():
            lp = model(ids).float()
            agree = (lp.argmax(-1) == ref.argmax(-1)).float().mean().item()
            check(lp.shape == (1, 64, VOCAB) and torch.isfinite(lp).all().item(),
                  f"{name}: log-probs")
            log({"twin": name, "top1_agreement_vs_f32": agree})
            check(agree >= 0.9, f"{name}: top-1 agreement {agree}")

    timings = {}
    for name, model in twins.items():
        for s in PROMPT_LENS:
            timings[name, s] = time_generate(model, groups[s])
            log({"twin": name, **timings[name, s]})
    return launches, {"f32": base, **twins}, timings


# ------------------------------------------------- 3d. continuous serving
CONT = dict(slots=8, max_len=512, decode_block=8, greedy=True,
            max_new_tokens=NEW_TOKENS, prefill_chunk=128)
CONT_DEVICE = "cuda"        # the device phase 3d serves on
SPEC_LEN = 4
LONG_PROMPT, SHARED_PREFIX = 384, 256
CONT_PREFIX_MB = 2048       # room for every snapshot of the phase
GAP_TOL = {"f32": 1e-3, "bf16": 0.1, "int8": 0.1}
SPEC_ACCEPT_MIN = 0.9
K1_BUCKETS = (64, 128, 256, 512)
# K4's rows on the path: the last prompt token (and a chunk's head), a step
# at 8 slots, a verification at 8 x (SPEC_LEN + 1), a chunk; and the
# buckets of at most 256 rows
K4_ROWS = (1, 8, 40, 128, 64, 256)


def check_continuous_kernels() -> dict:
    """K1 and K4 at phase 3d's shapes against their plain versions, with
    phase 2's tolerances: K1 at B=1, S in K1_BUCKETS (the bucketed
    prefill's buckets), N=12, D=64, causal, bf16 (the ``mma`` variant) and
    f32 (``tf32x3``); K4 at M in K4_ROWS for the five weight shapes of a
    forward, two runs with the same bits. Returns each kernel's largest
    absolute error."""
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.ops.int8_matmul import (int8_matmul_kernel,
                                                 int8_matmul_plain)
    gen = torch.Generator(device="cuda").manual_seed(31)
    worst = {"flash_fwd": 0.0, "int8_matmul": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        for s in K1_BUCKETS:
            q, k, v = _qkv(gen, 1, s, s, CONFIG["num_heads"], 64, dt)
            variant, (o, lse) = launched_variant(
                k1_counters(), lambda: fa.kernel_variant(q),
                lambda: fa.flash_attention_with_lse(q, k, v, causal=True))
            po, plse = fa.flash_attention_plain(q, k, v, causal=True)
            err_o, ok_o = flash_o_close(o, po)
            err_l = (lse - plse).abs().max().item()
            check(ok_o and err_l <= FLASH_ATOL
                  and variant == k1_variant_of(dt),
                  f"flash {dt} B=1 S={s}: |dO|={err_o} |dLSE|={err_l}, "
                  f"variant {variant}")
            worst["flash_fwd"] = max(worst["flash_fwd"], err_o)
    for m in K4_ROWS:
        for o, kd in sorted(set(int8_decode_shapes())):
            w = torch.randint(-127, 128, (o, kd), generator=gen,
                              device="cuda", dtype=torch.int8)
            sc = torch.rand((o,), generator=gen, device="cuda") * 1e-2 + 1e-3
            x = torch.randn((m, kd), generator=gen,
                            device="cuda").to(torch.bfloat16)
            y, again = (int8_matmul_kernel(x, w, sc) for _ in range(2))
            ref = int8_matmul_plain(x, w, sc)
            err = (y - ref).abs().max().item()
            tol = INT8_RTOL * ref.abs().max().item()
            check(err <= tol and torch.equal(y, again),
                  f"int8 M={m} O={o} K={kd}: err {err} > {tol}, or two runs "
                  "differ")
            worst["int8_matmul"] = max(worst["int8_matmul"], err)
    log({"check": "continuous_kernels", "k1_buckets": K1_BUCKETS,
         "k4_rows": K4_ROWS, "max_abs_err": worst})
    return worst


class TrieModel:
    """What the prefix trie does, for the structural launch counts: the
    chunk-aligned prefixes stored so far, and each admission's hit depth
    and chunk forwards (``_PrefillPipeline._prefill_chunked``)."""

    def __init__(self):
        self.stored = set()

    def admit(self, ids) -> tuple:
        c, n = CONT["prefill_chunk"], len(ids) - 1
        bounds = range(c, n + 1, c)
        hit = max((b for b in bounds if tuple(ids[:b]) in self.stored),
                  default=0)
        self.stored.update(tuple(ids[:b]) for b in bounds)
        return hit, -(-(n - hit) // c)

    def forwards(self, prompts) -> tuple:
        """(b=1 forwards of the admissions: chunks and last-token steps,
        admissions that hit)."""
        got = [self.admit(p) for p in prompts]
        return sum(chunks + 1 for _, chunks in got), sum(h > 0 for h, _ in got)


def continuous_server(model, **kw):
    from bigdl_tpu_torch.models.serving import ContinuousLMServer
    return ContinuousLMServer(model, prefix_cache_mb=CONT_PREFIX_MB,
                              device=CONT_DEVICE, **CONT, **kw)


def timed_rounds(server) -> list:
    """Wraps the server's decode round (``_step``, or ``_spec`` with a draft)
    to record the wall seconds of each; a round ends with its tokens' one
    copy to the host."""
    name = "_spec" if server.draft is not None else "_step"
    inner, times = getattr(server, name), []

    def timed():
        t0 = time.perf_counter()
        out = inner()
        times.append(time.perf_counter() - t0)
        return out

    setattr(server, name, timed)
    return times


def round_numbers(prompts, seconds, blocks) -> dict:
    """A round's wall time, its decode rounds' mean wall (a block of
    ``decode_block`` token steps over all 8 slots, or a speculative round),
    and its aggregate generated tokens per second."""
    out = {"requests": len(prompts), "wall_s": seconds,
           "decode_rounds": len(blocks),
           "tokens_per_s": len(prompts) * NEW_TOKENS / seconds}
    if blocks:
        out["ms_per_round"] = 1e3 * sum(blocks) / len(blocks)
        out["ms_per_token_step"] = out["ms_per_round"] / CONT["decode_block"]
    return out


def profiled_once(fn):
    """(fn's result, device busy share of its run): kernel time over wall
    time, under ``torch.profiler`` once (no repeat: ``fn`` admits requests);
    None when the profiler recorded nothing."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e6
    return out, (busy / wall if busy > 0 else None)


def greedy_gap(model, pairs) -> float:
    """The largest gap, over every served token of every (prompt, answer),
    between the token's log-prob and its position's largest one, with
    ``prompt + answer`` teacher-forced through the model's plain forward."""
    worst = 0.0
    with torch.inference_mode():
        for prompt, answer in pairs:
            ids = torch.as_tensor([prompt + answer], device=CONT_DEVICE)
            lp = model(ids)[0, len(prompt) - 1:-1].float()
            tok = torch.as_tensor(answer, device=CONT_DEVICE)[:, None] - 1
            gap = lp.max(dim=-1).values - lp.gather(1, tok)[:, 0]
            worst = max(worst, gap.max().item())
    return worst


def equal_to_generate(model, prompts, answers) -> int:
    """How many answers equal ``generate`` of their prompt (prompts of one
    length go in one batch)."""
    from bigdl_tpu_torch.models.generation import generate
    want = {}
    for n in sorted({len(p) for p in prompts}):
        group = [p for p in prompts if len(p) == n]
        out = generate(model, group, NEW_TOKENS, greedy=True,
                       device=CONT_DEVICE)
        for p, row in zip(group, out[:, n:].tolist()):
            want[tuple(p)] = row
    return sum(want[tuple(p)] == a for p, a in zip(prompts, answers))


def serve_round(server, prompts, blocks) -> tuple:
    """One round through ``submit_all``: the answers and its numbers."""
    n0 = len(blocks)
    answers, seconds = submit_all(server, prompts, NEW_TOKENS)
    return answers, round_numbers(prompts, seconds, blocks[n0:])


def serve_chunked(model, p: dict) -> dict:
    """Rounds 1 and 2, the time-to-first-token probes and round 3 (under
    the profiler) through one chunked server with the prefix cache."""
    server = continuous_server(model)
    blocks = timed_rounds(server)
    res = {}
    try:
        pc = server._pipeline.prefix
        res["answers1"], res["round1"] = serve_round(server, p["round1"],
                                                     blocks)
        hits0 = pc.hits
        res["answers2"], res["round2"] = serve_round(server, p["round2"],
                                                     blocks)
        res["round2"]["trie_hits"] = pc.hits - hits0
        ttft = {"cold": [], "hit_256": []}
        for cold, hit in p["probes"]:
            for key, prompt in (("cold", cold), ("hit_256", hit)):
                t0 = time.perf_counter()
                server.submit(prompt, 1, timeout=600)
                ttft[key].append(1e3 * (time.perf_counter() - t0))
        res["ttft_ms_384"] = ttft
        (res["answers3"], res["round3"]), busy = profiled_once(
            lambda: serve_round(server, p["round3"], blocks))
        res["round3"]["device_busy_share"] = busy
        res["trie"] = {"hits": pc.hits, "misses": pc.misses,
                       "evictions": pc.evictions, "entries": len(pc),
                       "mib": pc.nbytes / 2 ** 20}
        res["decode_blocks"] = server.decode_blocks
    finally:
        server.close()
    return res


def serve_once(model, prompts, **kw) -> dict:
    """One round through a server of its own (``kw``: bucketed mode, or a
    draft)."""
    server = continuous_server(model, **kw)
    blocks = timed_rounds(server)
    try:
        answers, res = serve_round(server, prompts, blocks)
        res["answers"] = answers
        res["decode_blocks"] = server.decode_blocks
        if server.draft is not None:
            # a round emits 1..SPEC_LEN + 1 tokens per row, not a block's
            del res["ms_per_token_step"]
            res["spec_acceptance"] = (server.spec_accepted_tokens
                                      / server.spec_proposed_tokens)
    finally:
        server.close()
    return res


def run_continuous(models: dict, lm_timings: dict) -> tuple:
    """Phase 3d; returns the K1 and K4 launches of its serving runs, and
    its prompts and each model's round-1 and round-2 answers (phase 3f)."""
    from bigdl_tpu_torch.nn.quantized import cast_model, quantize_model
    from bigdl_tpu_torch.ops import flash_attention, int8_matmul
    from bigdl_tpu_torch.utils.util import pow2_bucket
    t_phase = time.perf_counter()
    errs = check_continuous_kernels()
    rng = np.random.default_rng(9)
    fresh = lambda n: rng.integers(1, VOCAB + 1, int(n)).tolist()
    ragged = lambda k: [fresh(n) for n in rng.integers(33, LONG_PROMPT, k)]
    p = {"round1": [fresh(LONG_PROMPT) for _ in range(8)] + ragged(8)}
    r1 = p["round1"]
    # four prompts sharing 256 tokens of round-1 prompts (hits at 256),
    # four sharing 200 (hits at 128), and four round-1 prompts again
    p["round2"] = ([q[:SHARED_PREFIX] + fresh(rng.integers(1, 128))
                    for q in r1[:4]]
                   + [q[:200] + fresh(rng.integers(1, 128)) for q in r1[4:8]]
                   + [r1[i] for i in (0, 1, 8, 9)])
    p["probes"] = [(q, q[:SHARED_PREFIX]
                    + fresh(LONG_PROMPT - SHARED_PREFIX))
                   for q in (fresh(LONG_PROMPT) for _ in range(3))]
    p["round3"] = [fresh(LONG_PROMPT) for _ in range(4)] + ragged(4)
    bucketed, spec = r1[4:12], ragged(8)

    layers = CONFIG["num_layers"]
    per_forward = 7 * layers + 1    # int8 matmuls of one forward
    block = CONT["decode_block"]
    counters = (flash_attention.LAUNCHES, flash_attention.LAUNCHES_MMA,
                int8_matmul.LAUNCHES, int8_matmul.DEQUANT_CALLS)
    launches = {"flash_fwd": 0, "flash_fwd_mma": 0, "int8_matmul": 0}
    answers = {}

    def driven(fn):
        """Runs one serving path with every count zeroed just before;
        returns its result and its (K1, K1 mma, K4, dequantize) counts,
        every K1 launch checked to be its mma or its tf32x3 variant."""
        for c in (*counters, flash_attention.LAUNCHES_TF32):
            c.reset()
        out = fn()
        got = tuple(c.value for c in counters)
        check(got[0] == got[1] + flash_attention.LAUNCHES_TF32.value,
              f"K1 launched {got[0]} times, {got[1]} mma and "
              f"{flash_attention.LAUNCHES_TF32.value} tf32x3")
        for key, n in zip(launches, got):
            launches[key] += n
        return out, got

    def check_counts(what, got, k1, k1_mma, k4, deq):
        check(got == (k1, k1_mma, k4, deq),
              f"{what}: (K1, K1 mma, K4, dequantize) counted {got}, the "
              f"path's structure gives {(k1, k1_mma, k4, deq)}")

    for name, model in models.items():
        int8, mma = name == "int8", name != "f32"
        k4_of = lambda forwards: per_forward * forwards if int8 else 0
        trie = TrieModel()
        res, got = driven(lambda: serve_chunked(model, p))
        # every b=1 forward of every admission, in admission order, and
        # decode_block steps per round; all of M <= 256 rows
        fwd, hits = 0, {}
        for key in ("round1", "round2"):
            n, hits[key] = trie.forwards(p[key])
            fwd += n
        fwd += trie.forwards([q for pair in p["probes"] for q in pair])[0]
        fwd += trie.forwards(p["round3"])[0]
        check_counts(f"{name} chunked", got, 0, 0,
                     k4_of(fwd + res["decode_blocks"] * block), 0)
        check(res["round2"]["trie_hits"] == hits["round2"] > 0
              and res["trie"]["evictions"] == 0,
              f"{name}: round 2 hit the trie {res['round2']['trie_hits']} "
              f"times, {hits['round2']} expected; trie {res['trie']}")
        again = dict(zip(map(tuple, p["round2"][8:]), res["answers2"][8:]))
        check(all(again[tuple(r1[i])] == res["answers1"][i]
                  for i in (0, 1, 8, 9)),
              f"{name}: a resubmitted prompt's answer differs from round 1")

        resb, got = driven(lambda: serve_once(model, bucketed,
                                              prefill_mode="bucketed"))
        sizes = [pow2_bucket(len(q), 16, CONT["max_len"]) for q in bucketed]
        small = sum(b <= 256 for b in sizes)
        # a bucket over 256 rows dequantizes every matmul, the head's too:
        # in bucketed mode it reads all the bucket's positions
        check_counts(f"{name} bucketed", got, layers * len(bucketed),
                     layers * len(bucketed) if mma else 0,
                     k4_of(small + resb["decode_blocks"] * block),
                     per_forward * (len(sizes) - small) if int8 else 0)
        pairs = list(zip(r1 + p["round2"] + p["round3"] + bucketed,
                         res["answers1"] + res["answers2"] + res["answers3"]
                         + resb["answers"]))

        ress = None
        if name != "f32":
            twin = cast_model if name == "bf16" else quantize_model
            draft = twin(models["f32"], torch.bfloat16, device=CONT_DEVICE)
            ress, got = driven(lambda: serve_once(model, spec, draft=draft,
                                                  spec_len=SPEC_LEN))
            del draft
            rounds = ress["decode_blocks"]
            # the target: admissions (its trie holds rounds 1-3) and one
            # verification per round; the draft: its own admissions and
            # SPEC_LEN + 1 steps per round
            fwd = (trie.forwards(spec)[0] + rounds
                   + TrieModel().forwards(spec)[0] + rounds * (SPEC_LEN + 1))
            check_counts(f"{name} speculative", got, 0, 0, k4_of(fwd), 0)
            check(ress["spec_acceptance"] >= SPEC_ACCEPT_MIN,
                  f"{name}: speculative acceptance "
                  f"{ress['spec_acceptance']} < {SPEC_ACCEPT_MIN}")
            pairs += list(zip(spec, ress["answers"]))
        torch.cuda.empty_cache()

        for prompt, answer in pairs:
            check(len(answer) == NEW_TOKENS
                  and all(1 <= t <= VOCAB for t in answer),
                  f"{name}: malformed continuation")
        gap = greedy_gap(model, pairs)
        exact = equal_to_generate(model, r1, res["answers1"])
        same_bucketed = sum(a == b for a, b in zip(resb["answers"],
                                                   res["answers1"][4:12]))
        row = {"twin": name, "answers_checked": len(pairs),
               "largest_greedy_gap": gap, "gap_tol": GAP_TOL[name],
               "round1_equal_generate": exact,
               "bucketed_equal_chunked": same_bucketed,
               **{k: res[k] for k in ("round1", "round2", "round3",
                                      "ttft_ms_384", "trie")},
               "bucketed": {k: v for k, v in resb.items() if k != "answers"},
               "lm_server_phase3": {s: {k: lm_timings[name, s][k] for k in (
                   "prefill_ms", "decode_ms_per_token", "tokens_per_s",
                   "device_busy_share")}
                   for s in PROMPT_LENS if (name, s) in lm_timings}}
        if ress is not None:
            row["speculative"] = {k: v for k, v in ress.items()
                                  if k != "answers"}
        log({"continuous": row})
        answers[name] = {"round1": res["answers1"],
                         "round2": res["answers2"],
                         "busy_round3": res["round3"]["device_busy_share"]}
        check(gap <= GAP_TOL[name],
              f"{name}: a served token's log-prob is {gap} below its "
              f"position's largest (tolerance {GAP_TOL[name]})")
    log({"continuous_phase_s": time.perf_counter() - t_phase,
         "kernel_max_abs_err": errs, "launches": launches})
    return launches, {"prompts": p, "spec": spec, "answers": answers}


# ------------------------------------------------------ 3e. serving plane
BEAM_WIDTH, BEAM_PROMPT, BEAM_BATCH = 4, 128, 2
SPEC_PROMPT, SPEC_NEW = 384, 32
DRAFT_LAYERS, DRAFT_SEED = 2, 8
FLEET_REQUESTS, FLEET_KILL_AFTER = 12, 4
CLI_TIMEOUT_S = 240
# K4's new rows on the path: a verification chunk (B=1, SPEC_LEN + 1) and
# a beam step (BEAM_BATCH x BEAM_WIDTH)
PLANE_K4_ROWS = (SPEC_LEN + 1, BEAM_BATCH * BEAM_WIDTH)


def check_plane_kernels() -> dict:
    """K1 and K4 at phase 3e's new shapes against their plain versions, with
    phase 2's tolerances: K1 at the beam prefill's B=BEAM_BATCH,
    S=BEAM_PROMPT (N=12, D=64, causal; bf16 ``mma`` and f32 ``tf32x3``); K4
    at M in PLANE_K4_ROWS over the five weight shapes of a forward, two runs
    with the same bits. Returns each kernel's largest absolute error."""
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.ops.int8_matmul import (int8_matmul_kernel,
                                                 int8_matmul_plain)
    gen = torch.Generator(device="cuda").manual_seed(37)
    worst = {"flash_fwd": 0.0, "int8_matmul": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(gen, BEAM_BATCH, BEAM_PROMPT, BEAM_PROMPT,
                       CONFIG["num_heads"], 64, dt)
        variant, (o, lse) = launched_variant(
            k1_counters(), lambda: fa.kernel_variant(q),
            lambda: fa.flash_attention_with_lse(q, k, v, causal=True))
        po, plse = fa.flash_attention_plain(q, k, v, causal=True)
        err_o, ok_o = flash_o_close(o, po)
        err_l = (lse - plse).abs().max().item()
        check(ok_o and err_l <= FLASH_ATOL
              and variant == k1_variant_of(dt),
              f"flash {dt} B={BEAM_BATCH} S={BEAM_PROMPT}: |dO|={err_o} "
              f"|dLSE|={err_l}, variant {variant}")
        worst["flash_fwd"] = max(worst["flash_fwd"], err_o)
    for m in PLANE_K4_ROWS:
        for o, kd in sorted(set(int8_decode_shapes())):
            w = torch.randint(-127, 128, (o, kd), generator=gen,
                              device="cuda", dtype=torch.int8)
            sc = torch.rand((o,), generator=gen, device="cuda") * 1e-2 + 1e-3
            x = torch.randn((m, kd), generator=gen,
                            device="cuda").to(torch.bfloat16)
            y, again = (int8_matmul_kernel(x, w, sc) for _ in range(2))
            ref = int8_matmul_plain(x, w, sc)
            err = (y - ref).abs().max().item()
            tol = INT8_RTOL * ref.abs().max().item()
            check(err <= tol and torch.equal(y, again),
                  f"int8 M={m} O={o} K={kd}: err {err} > {tol}, or two runs "
                  "differ")
            worst["int8_matmul"] = max(worst["int8_matmul"], err)
    log({"check": "serving_plane_kernels", "k1_shape": [BEAM_BATCH,
                                                        BEAM_PROMPT],
         "k4_rows": PLANE_K4_ROWS, "max_abs_err": worst})
    return worst


def synced_s(fn):
    """(fn's result, host seconds of work that ends in a synchronize)."""
    if CONT_DEVICE == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if CONT_DEVICE == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def sequence_logprob(model, seqs, s0: int) -> list:
    """Each row's summed log-prob of its tokens after ``s0`` under a
    teacher-forced plain forward of ``model``."""
    with torch.inference_mode():
        ids = torch.as_tensor(seqs, device=CONT_DEVICE)
        lp = model(ids)[:, s0 - 1:-1].float()
        tok = ids[:, s0:, None] - 1
        return lp.gather(2, tok)[..., 0].sum(dim=1).tolist()


def run_beams(name, model, driven, per_forward) -> dict:
    """Beam search of one twin: ``generate(num_beams=BEAM_WIDTH)`` on
    BEAM_BATCH prompts of BEAM_PROMPT tokens, NEW_TOKENS new. Checks: one
    K1 prefill (num_layers launches, the ``mma`` variant); for the int8
    twin, K4 per_forward times in each of the NEW_TOKENS forwards (the
    prefill's 256 rows and every step's BEAM_BATCH x BEAM_WIDTH);
    ``num_beams=1`` equals greedy ``generate`` exactly; the best beam's
    score under a teacher-forced forward at least the greedy sequence's,
    less GAP_TOL."""
    from bigdl_tpu_torch.models.generation import generate
    rng = np.random.default_rng(21)
    prompts = rng.integers(1, VOCAB + 1, (BEAM_BATCH, BEAM_PROMPT)).tolist()
    layers = CONFIG["num_layers"]
    beam = lambda n: generate(model, prompts, n, num_beams=BEAM_WIDTH,
                              device=CONT_DEVICE)
    (out, seconds), got = driven(lambda: synced_s(lambda: beam(NEW_TOKENS)))
    k4 = per_forward * NEW_TOKENS if name == "int8" else 0
    check(got == (layers, layers, k4, 0),
          f"{name} beams: (K1, K1 mma, K4, dequantize) counted {got}, the "
          f"path's structure gives {(layers, layers, k4, 0)}")
    _, prefill_s = synced_s(lambda: beam(1))
    greedy = generate(model, prompts, NEW_TOKENS, greedy=True,
                      device=CONT_DEVICE)
    width1 = generate(model, prompts, NEW_TOKENS, num_beams=1,
                      device=CONT_DEVICE)
    check(torch.equal(width1, greedy), f"{name}: num_beams=1 != greedy")
    s_beam = sequence_logprob(model, out.tolist(), BEAM_PROMPT)
    s_greedy = sequence_logprob(model, greedy.tolist(), BEAM_PROMPT)
    row = {"beam_width": BEAM_WIDTH, "batch": BEAM_BATCH,
           "prompt_len": BEAM_PROMPT, "new_tokens": NEW_TOKENS,
           "wall_s": seconds, "prefill_s": prefill_s,
           "ms_per_beam_step": 1e3 * (seconds - prefill_s) / (NEW_TOKENS - 1),
           "launches": dict(zip(("k1", "k1_mma", "k4", "dequant"), got)),
           "score_beam": s_beam, "score_greedy": s_greedy,
           "beam_equals_greedy": torch.equal(out, greedy)}
    for sb, sg in zip(s_beam, s_greedy):
        # no eos: every length is NEW_TOKENS, so the length penalty divides
        # both scores alike
        check(sb >= sg - GAP_TOL[name],
              f"{name}: best beam's score {sb} < greedy's {sg} less "
              f"{GAP_TOL[name]}")
    return row


def spec_rounds(target, fn):
    """(fn's result, the target's rewinds as decode positions): each
    speculative round ends with one ``_set_decode_pos`` of the target."""
    from bigdl_tpu_torch.models import generation
    inner, seen = generation._set_decode_pos, []

    def spy(model, value):
        if model is target:
            seen.append(int(value))
        inner(model, value)

    generation._set_decode_pos = spy
    try:
        return fn(), seen
    finally:
        generation._set_decode_pos = inner


def run_speculative(name, target, drafts, driven, per_forward) -> dict:
    """``generate_speculative`` of one target with each draft: a
    SPEC_PROMPT-token prompt, SPEC_NEW new tokens, SPEC_LEN. Greedy output
    must equal greedy ``generate`` of the target; where a token differs
    (the verification chunk and a single-token step round apart in the last
    bits), its teacher-forced gap must stay within GAP_TOL and its position
    is logged. Launch counts follow from the rounds the run reports. The
    sampled mode runs once, with the last draft (the one that disagrees:
    rejections and residual draws)."""
    from bigdl_tpu_torch.models.generation import (generate,
                                                   generate_speculative)
    rng = np.random.default_rng(23)
    prompt = rng.integers(1, VOCAB + 1, SPEC_PROMPT).tolist()
    want = generate(target, [prompt], SPEC_NEW, greedy=True,
                    device=CONT_DEVICE)[0, SPEC_PROMPT:].tolist()
    layers = CONFIG["num_layers"]
    out = {}
    for dname, draft in drafts.items():
        d_layers = sum(1 for m in draft.modules()
                       if type(m).__name__.endswith("MultiHeadAttention"))
        d_forward = 7 * d_layers + 1
        run = lambda n, **kw: generate_speculative(
            target, draft, [prompt], n, spec_len=SPEC_LEN,
            device=CONT_DEVICE, **kw)
        ((res, seconds), pos), got = driven(
            lambda: spec_rounds(target, lambda: synced_s(
                lambda: run(SPEC_NEW))))
        rounds = len(pos)
        emitted = pos[-1] - SPEC_PROMPT
        # target: the prompt's prefill (rows > 256 dequantize, the head
        # reads one position) and one SPEC_LEN + 1 verification per round;
        # draft: the same prefill and SPEC_LEN + 1 single-token steps
        k4 = ((1 + per_forward * rounds)
              + (1 + d_forward * (SPEC_LEN + 1) * rounds)
              if name == "int8" else 0)
        deq = (per_forward - 1) + (d_forward - 1) if name == "int8" else 0
        check(got == (layers + d_layers, layers + d_layers, k4, deq),
              f"{name}/{dname} speculative: (K1, K1 mma, K4, dequantize) "
              f"counted {got}, the rounds give "
              f"{(layers + d_layers, layers + d_layers, k4, deq)}")
        answer = res[0, SPEC_PROMPT:].tolist()
        diff = [i for i, (a, b) in enumerate(zip(answer, want)) if a != b]
        gap = greedy_gap(target, [(prompt, answer)])
        check(len(answer) == SPEC_NEW and (not diff or gap <= GAP_TOL[name]),
              f"{name}/{dname}: speculative output differs from generate at "
              f"{diff} with a teacher-forced gap {gap} > {GAP_TOL[name]}")
        _, prefill_s = synced_s(lambda: run(1))
        out[dname] = {
            "draft_layers": d_layers, "rounds": rounds,
            "tokens_per_round": emitted / rounds,
            "acceptance": (emitted - rounds) / (SPEC_LEN * rounds),
            "wall_s": seconds, "prefill_s": prefill_s,
            "ms_per_round": 1e3 * (seconds - prefill_s) / rounds,
            "equal_to_generate": not diff, "first_differing": diff[:1],
            "greedy_gap": gap,
            "launches": dict(zip(("k1", "k1_mma", "k4", "dequant"), got))}
    dname, draft = list(drafts.items())[-1]
    gen = torch.Generator(device=CONT_DEVICE).manual_seed(3)
    (res, pos), got = driven(lambda: spec_rounds(target, lambda: (
        generate_speculative(target, draft, [prompt], SPEC_NEW,
                             spec_len=SPEC_LEN, generator=gen,
                             device=CONT_DEVICE))))
    emitted = pos[-1] - SPEC_PROMPT
    toks = res[0, SPEC_PROMPT:]
    check(toks.shape[0] == SPEC_NEW and bool(((toks >= 1)
                                              & (toks <= VOCAB)).all()),
          f"{name}: sampled speculative output malformed")
    out["sampled_" + dname] = {"rounds": len(pos),
                               "acceptance": (emitted - len(pos))
                               / (SPEC_LEN * len(pos))}
    return out


def drive_router(router, prompts):
    """Every prompt from a client thread of its own through the router;
    returns the answers (None for a lost request), the errors and the wall
    seconds."""
    results, errors = [None] * len(prompts), {}
    barrier = threading.Barrier(len(prompts))

    def client(i):
        try:
            barrier.wait(timeout=60)
            results[i] = router.submit(prompts[i], NEW_TOKENS, timeout=600)
        except Exception as e:  # a lost request: counted and checked below
            errors[i] = f"{type(e).__name__}: {e}"

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    seconds = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a fleet client never "
          "returned")
    return results, errors, seconds


def metric_value(text: str, name: str) -> float:
    """One unlabeled sample of a Prometheus text exposition."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    raise RuntimeError(f"check failed: {name} missing from /metrics")


def held_to_generate(name, model, prompts, answers, vocab=VOCAB,
                     tol=None) -> dict:
    """Each answer against a direct greedy ``generate`` of its prompt:
    equal, or (a requeue's chunked re-prefill or a bucketed prefill rounds
    apart from the step decode) within GAP_TOL under a teacher-forced
    forward, with its first differing position logged."""
    from bigdl_tpu_torch.models.generation import generate
    differing = []
    for i, (p, a) in enumerate(zip(prompts, answers)):
        want = generate(model, [p], NEW_TOKENS, greedy=True,
                        device=CONT_DEVICE)[0, len(p):].tolist()
        check(len(a) == NEW_TOKENS and all(1 <= t <= vocab for t in a),
              f"{name}: malformed answer {i}")
        if a != want:
            differing.append({"request": i, "position": next(
                j for j, (x, y) in enumerate(zip(a, want)) if x != y)})
    gap = greedy_gap(model, list(zip(prompts, answers)))
    tol = GAP_TOL[name] if tol is None else tol
    check(not differing or gap <= tol,
          f"{name}: answers differ from generate at {differing} with "
          f"a teacher-forced gap {gap} > {tol}")
    return {"equal_to_generate": len(prompts) - len(differing),
            "differing": differing, "greedy_gap": gap}


def fleet_numbers(reg, seconds, n) -> dict:
    """The drill's /metrics text and what it says: every request counted
    once by the router, one TTFT observation per admission, device memory
    sampled."""
    from bigdl_tpu_torch.telemetry import instruments, render_prometheus
    text = render_prometheus(reg)
    tm = instruments(reg)
    admissions = metric_value(text, "bigdl_serving_admissions_total")
    check(metric_value(text, "bigdl_router_requests_total") == n,
          "bigdl_router_requests_total != the requests")
    check(metric_value(text, "bigdl_serving_ttft_seconds_count")
          == admissions > 0, "the TTFT histogram's count != admissions")
    if CONT_DEVICE == "cuda":
        check(metric_value(text, "bigdl_device_memory_bytes") > 0,
              "bigdl_device_memory_bytes not sampled")
    handoff = tm.handoff_seconds.labels().snapshot()
    return {"tokens_per_s": n * NEW_TOKENS / seconds, "wall_s": seconds,
            "admissions": admissions,
            "ttft_s": tm.serving_ttft_seconds.summary(),
            "token_latency_s": tm.serving_token_latency_seconds.summary(),
            "handoff_s": {"count": handoff["count"], "sum": handoff["sum"],
                          "mean": (handoff["sum"] / handoff["count"]
                                   if handoff["count"] else None)},
            "requeues": tm.router_requeues_total.value,
            "retries": tm.router_retries_total.value,
            "device_memory_mib": metric_value(
                text, "bigdl_device_memory_bytes") / 2 ** 20,
            "metrics_lines": len(text.splitlines())}


def bit_equal_copies(models) -> bool:
    """Whether every model's tensors equal the first's, bit for bit."""
    ref = [t for t in models[0].state_dict().values()]
    return all(all(torch.equal(a, b) for a, b in zip(
        ref, m.state_dict().values())) for m in models[1:])


def run_fleet(models, driven) -> dict:
    """The fleet drills: the int8 twin behind ``LMRouter`` over two decode
    replicas with replica 0 killed after FLEET_KILL_AFTER admissions, then
    the bf16 twin disaggregated 1:2 (a bucketed prefill replica, so K1
    runs) with the second shipped handoff dropped. Each replica serves its
    own deep copy of the twin (bit-equal weights)."""
    import copy

    from bigdl_tpu_torch.models.router import LMRouter
    from bigdl_tpu_torch.models.serving import ContinuousLMServer
    from bigdl_tpu_torch.resilience.chaos import (DropHandoff,
                                                  KillReplicaAfterRequests)
    from bigdl_tpu_torch.telemetry import MetricsRegistry
    rng = np.random.default_rng(29)
    prompts = [rng.integers(1, VOCAB + 1, int(n)).tolist()
               for n in rng.integers(33, LONG_PROMPT + 1, FLEET_REQUESTS)]
    server = lambda m, reg, **kw: ContinuousLMServer(
        m, registry=reg, device=CONT_DEVICE, **CONT, **kw)
    layers = CONFIG["num_layers"]
    out = {}

    reg = MetricsRegistry()
    copies = [copy.deepcopy(models["int8"]) for _ in range(2)]
    check(bit_equal_copies([models["int8"]] + copies),
          "int8 replicas' weights differ")
    kill = KillReplicaAfterRequests(FLEET_KILL_AFTER)
    decode = [server(copies[0], reg, chaos=[kill]), server(copies[1], reg)]
    router = LMRouter(decode, registry=reg)
    try:
        (answers, errors, seconds), got = driven(
            lambda: drive_router(router, prompts))
        states = [r["state"] for r in router.health_extra["replicas"]]
        # the killed replica's last round was counted and never ran
        blocks = sum(s.decode_blocks for s in decode) - int(kill.fired)
    finally:
        router.close()
    check(not errors, f"int8 fleet lost requests: {errors}")
    nums = fleet_numbers(reg, seconds, len(prompts))
    check(kill.fired and nums["requeues"] >= 1 and states == ["dead", "ok"],
          f"int8 fleet: kill fired {kill.fired}, requeues "
          f"{nums['requeues']}, states {states}")
    # chunked prefill never runs K1; every step of a decode block runs all
    # 85 matmuls at the slots' rows, so they bound K4 from below
    check(got[0] == 0 and got[2] >= per_forward(layers) * CONT[
        "decode_block"] * blocks > 0,
          f"int8 fleet: (K1, K1 mma, K4, dequantize) counted {got} over "
          f"{blocks} decode blocks")
    out["int8_kill"] = {**nums, "replica_states": states,
                        "decode_blocks": blocks,
                        "launches": dict(zip(("k1", "k1_mma", "k4",
                                              "dequant"), got)),
                        **held_to_generate("int8", models["int8"], prompts,
                                           answers)}
    del copies, decode, router
    torch.cuda.empty_cache() if CONT_DEVICE == "cuda" else None

    reg = MetricsRegistry()
    copies = [copy.deepcopy(models["bf16"]) for _ in range(3)]
    check(bit_equal_copies([models["bf16"]] + copies),
          "bf16 replicas' weights differ")
    decode = [server(copies[0], reg), server(copies[1], reg)]
    prefill = [server(copies[2], reg, prefill_mode="bucketed")]
    drop = DropHandoff(2)
    router = LMRouter(decode, prefill_replicas=prefill, registry=reg,
                      chaos=[drop])
    try:
        (answers, errors, seconds), got = driven(
            lambda: drive_router(router, prompts))
        # one partition alone (the drill's clients queue on the prefill
        # replica's lock): a bucketed prefill of LONG_PROMPT tokens and its
        # npz, timed three times
        solo, blob = [], b""
        for _ in range(3):
            t0 = time.perf_counter()
            blob = prefill[0].prefill_handoff(prompts[0][:1] * LONG_PROMPT)
            solo.append(1e3 * (time.perf_counter() - t0))
    finally:
        router.close()
    check(not errors, f"bf16 fleet lost requests: {errors}")
    nums = fleet_numbers(reg, seconds, len(prompts))
    ships = nums["handoff_s"]["count"]
    check(drop.fired and nums["retries"] >= 1 and ships >= len(prompts),
          f"bf16 fleet: drop fired {drop.fired}, retries {nums['retries']}, "
          f"handoffs {ships}")
    # each shipped partition is one bucketed prefill: num_layers K1 launches,
    # all mma (bf16)
    check(got[:2] == (layers * ships, layers * ships),
          f"bf16 fleet: K1 counted {got[:2]}, {ships} bucketed prefills "
          f"give {layers * ships}")
    out["bf16_disaggregated"] = {
        **nums, "launches": dict(zip(("k1", "k1_mma", "k4", "dequant"),
                                     got)),
        "solo_handoff_ms": solo, "handoff_blob_mib": len(blob) / 2 ** 20,
        **held_to_generate("bf16", models["bf16"], prompts, answers)}
    del copies, decode, prefill, router
    return out


def per_forward(layers: int) -> int:
    """int8 matmuls in one forward of the config: q, k, v, out, up, gate
    and down per layer, and the head."""
    return 7 * layers + 1


def run_cli() -> dict:
    """The command line on the card, as subprocesses: ``serve --continuous
    --replicas 2 --int8 --port 0`` (its default model: the tiny
    synthetic-grammar LM, trained in the subprocess) answers 4 concurrent
    POSTs of its full budget, reports two ``ok`` replicas on ``/health`` and
    the router and serving families on ``/metrics``, and drains on SIGTERM
    with exit code 0 within 30 s; ``generate --numBeams 4 --bf16``, started
    beside ``serve``, prints its two lines."""
    import re
    import signal
    import urllib.request

    cli = [sys.executable, "-m", "bigdl_tpu_torch.apps.transformer"]
    device = ["--device", CONT_DEVICE]
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cli + ["serve", "--continuous", "--replicas", "2",
                                   "--int8", "--port", "0"] + device,
                            cwd=root, stderr=subprocess.PIPE,
                            stdout=subprocess.DEVNULL, text=True)
    gen = subprocess.Popen(cli + ["generate", "--numBeams", "4", "--bf16",
                                  "--maxNewTokens", "16"] + device,
                           cwd=root, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    res = {}
    try:
        port, seen = None, []
        while port is None and time.perf_counter() - t0 < CLI_TIMEOUT_S:
            line = proc.stderr.readline()
            if not line:
                break
            seen.append(line.strip())
            m = re.search(r"serving on http://[\d.]+:(\d+)", line)
            port = int(m.group(1)) if m else None
        check(port is not None, f"serve never reported its port: {seen}")
        res["serve_startup_s"] = time.perf_counter() - t0
        base = f"http://127.0.0.1:{port}"
        rng = np.random.default_rng(31)
        prompts = [rng.integers(1, 65, int(n)).tolist()
                   for n in (3, 17, 40, 100)]
        answers = [None] * len(prompts)

        def post(i):
            req = urllib.request.Request(
                base + "/generate",
                data=json.dumps({"prompt": prompts[i]}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                answers[i] = json.loads(r.read())["ids"]

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(prompts))]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        res["four_posts_s"] = time.perf_counter() - t1
        check(all(a is not None and len(a) == 64
                  and all(1 <= x <= 64 for x in a) for a in answers),
              f"serve answers: {[None if a is None else len(a) for a in answers]}")
        with urllib.request.urlopen(base + "/health", timeout=30) as r:
            health = json.loads(r.read())
            check(r.status == 200 and health["ok"]
                  and [x["state"] for x in health["replicas"]] == ["ok", "ok"],
                  f"serve /health: {health}")
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            text = r.read().decode()
        check(metric_value(text, "bigdl_router_requests_total") == 4
              and metric_value(text, "bigdl_serving_admissions_total") == 4
              and metric_value(text, "bigdl_serving_requests_completed_total")
              == 4, "serve /metrics lacks the router's or the servers' counts")
        t2 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
        res["drain_exit_s"] = time.perf_counter() - t2
        check(rc == 0, f"serve exited {rc} after SIGTERM")
        out, err = gen.communicate(timeout=CLI_TIMEOUT_S)
        res["generate_s"] = time.perf_counter() - t0   # beside serve
    finally:
        for p in (proc, gen):
            if p.poll() is None:
                p.kill()
                p.wait()
    lines = out.strip().splitlines()
    check(gen.returncode == 0 and len(lines) == 2
          and lines[0].startswith("prompt:")
          and len(json.loads(lines[1].split(":", 1)[1])) == 16,
          f"generate --numBeams 4 --bf16: rc {gen.returncode}, stdout "
          f"{out[-500:]!r}, stderr {err[-1500:]!r}")
    return res


def run_serving_plane(models: dict) -> dict:
    """Phase 3e; returns the K1 and K4 launches of its runs (the kernel
    checks' own launches excluded)."""
    from bigdl_tpu_torch.nn.quantized import cast_model, quantize_model
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.ops import flash_attention, int8_matmul
    t_phase = time.perf_counter()
    for m in models.values():   # phase 3d's prefix snapshots
        m.__dict__.pop("_prefix_trie", None)
    if CONT_DEVICE == "cuda":
        torch.cuda.empty_cache()
    errs = check_plane_kernels()
    counters = (flash_attention.LAUNCHES, flash_attention.LAUNCHES_MMA,
                int8_matmul.LAUNCHES, int8_matmul.DEQUANT_CALLS)
    launches = {"flash_fwd": 0, "flash_fwd_mma": 0, "int8_matmul": 0}

    def driven(fn):
        """Runs one path with every count zeroed just before; returns its
        result and its (K1, K1 mma, K4, dequantize) counts."""
        for c in counters:
            c.reset()
        out = fn()
        got = tuple(c.value for c in counters)
        for key, n in zip(launches, got):
            launches[key] += n
        return out, got

    pf = per_forward(CONFIG["num_layers"])
    row = {"beams": {}, "speculative": {}}
    for name in ("bf16", "int8"):
        t = time.perf_counter()
        row["beams"][name] = run_beams(name, models[name], driven, pf)
        row["beams"][name]["phase_s"] = time.perf_counter() - t
    # a random tied model echoes its last token, so a tied draft of any
    # seed proposes what the target says; an untied head disagrees, and the
    # target rewinds nearly every round
    small = build_lm(VOCAB, **dict(CONFIG, num_layers=DRAFT_LAYERS,
                                   tie_embeddings=False, fused_head=True),
                     device=CONT_DEVICE, seed=DRAFT_SEED).evaluate_mode()
    for name, twin in (("bf16", cast_model), ("int8", quantize_model)):
        t = time.perf_counter()
        drafts = {"own_twin": twin(models["f32"], torch.bfloat16,
                                   device=CONT_DEVICE),
                  f"{DRAFT_LAYERS}_layers_untied_seed_{DRAFT_SEED}": twin(
                      small, torch.bfloat16, device=CONT_DEVICE)}
        row["speculative"][name] = run_speculative(name, models[name],
                                                   drafts, driven, pf)
        row["speculative"][name]["phase_s"] = time.perf_counter() - t
        del drafts
    del small
    t = time.perf_counter()
    row["fleet"] = run_fleet(models, driven)
    row["fleet"]["phase_s"] = time.perf_counter() - t
    t = time.perf_counter()
    row["cli"] = run_cli()
    row["cli"]["phase_s"] = time.perf_counter() - t
    log({"serving_plane": row})
    log({"serving_plane_phase_s": time.perf_counter() - t_phase,
         "kernel_max_abs_err": errs, "launches": launches})
    return launches


# ------------------------------------------- 3f. CUDA graphs: serving half
GRAPH_ROUND_REPS = 10     # rounds timed each way, from one restored state
GRAPH_CENSUS = {"captures": 0, "replays": 0}


def graph_census() -> None:
    """Counts every CUDA graph capture and replay of the package's
    ``GraphedProgram`` in this process (the ``graphs`` line)."""
    from bigdl_tpu_torch.utils.cuda_graph import GraphedProgram
    capture, replay = GraphedProgram._warm_up_and_capture, GraphedProgram.replay

    def counted_capture(self):
        GRAPH_CENSUS["captures"] += 1
        return capture(self)

    def counted_replay(self):
        GRAPH_CENSUS["replays"] += 1
        return replay(self)

    GraphedProgram._warm_up_and_capture = counted_capture
    GraphedProgram.replay = counted_replay


def idle(server):
    """The server with its worker stopped (which releases its graphs), so
    that this thread can drive its rounds."""
    server._stop.set()
    server._worker.join(timeout=60)
    check(not server._worker.is_alive(), "the server's worker did not stop")
    return server


def admit_directly(server, prompts) -> None:
    from bigdl_tpu_torch.models.serving import _Request
    with torch.inference_mode():
        for p in prompts:
            check(server._admit(_Request(p, NEW_TOKENS)),
                  "a direct admission failed")
    check(len(server._active) == len(prompts), "not every prompt got a slot")


def eager_against_replay(server, site: str, body, counters) -> dict:
    """One round of ``body`` run eagerly and one replayed from its graph,
    each from the same saved state, the step generator's included (the
    graph captured first, from that state, through ``_round``): the round's
    outputs, every tensor the graph writes (caches, ``decode_pos``,
    ``_last_tok``) and the launch counts must be equal. Then
    GRAPH_ROUND_REPS rounds each way, each series from the saved state, for
    the ms a round (host clock around rounds that end in their one copy to
    the host, as the engine's do)."""
    with torch.inference_mode():
        saved = [t.clone() for t in server._graph_inputs()]
        gen_state = server._step_gen.get_state()

        def restore():
            for t, s in zip(server._graph_inputs(), saved):
                t.copy_(s)
            server._step_gen.set_state(gen_state)
            torch.cuda.synchronize()

        run = {"eager": body, "replay": lambda: server._round(site, body)}
        run["replay"]()                   # the warm-up and the capture
        got = {}
        for how in ("eager", "replay"):
            restore()
            for c in counters:
                c.reset()
            out = run[how]().cpu()
            got[how] = (out, [t.clone() for t in server._graph_inputs()],
                        tuple(c.value for c in counters))
        same_state = all(torch.equal(a, b) for a, b in zip(got["eager"][1],
                                                           got["replay"][1]))
        check(torch.equal(got["eager"][0], got["replay"][0]) and same_state,
              f"{site}: the replayed round's outputs or state differ from "
              "the eager round's")
        check(got["eager"][2] == got["replay"][2],
              f"{site}: launch counts eager {got['eager'][2]} against "
              f"replayed {got['replay'][2]}")
        ms = {}
        for how in ("eager", "replay"):
            restore()
            t0 = time.perf_counter()
            for _ in range(GRAPH_ROUND_REPS):
                run[how]().cpu()
            ms[how] = 1e3 * (time.perf_counter() - t0) / GRAPH_ROUND_REPS
        restore()
    return {"counts": got["replay"][2], "ms_per_round_eager": ms["eager"],
            "ms_per_round_replay": ms["replay"],
            "speedup": ms["eager"] / ms["replay"]}


def check_capture_gc() -> dict:
    """A CUDA graph held only by a reference cycle and never reset is
    destroyed by the cyclic garbage collector in whichever thread happens
    to allocate; inside a capture, that destroy invalidates the capture (a
    run of this script lost a 3f server so). ``GraphedProgram`` keeps the
    collector off while it captures. Here one such graph is left as
    garbage, the collector's threshold is set to 1 (a collection at nearly
    every allocation) and a program whose body allocates is captured and
    replayed: no collection may start on a capturing stream, the replay
    must be right, and the garbage graph must be freed afterwards."""
    import gc
    import weakref
    from bigdl_tpu_torch.utils.cuda_graph import GraphedProgram
    x = torch.zeros(1024, device="cuda")
    leak = GraphedProgram(lambda: x.add_(1), "cuda")
    leak()
    leak()                        # captured and replayed, never closed

    class Cycle:
        pass
    cyc = Cycle()
    cyc.prog, cyc.self = leak, cyc
    gone = weakref.ref(leak)
    del cyc, leak
    in_capture, collections = [], [0]

    def on_gc(phase, info):
        if phase == "start":
            collections[0] += 1
            if torch.cuda.is_current_stream_capturing():
                in_capture.append(info["generation"])

    y = torch.zeros(1024, device="cuda")

    def body():
        junk = [[i] for i in range(1000)]
        return y.add_(len(junk))

    threshold, enabled = gc.get_threshold(), gc.isenabled()
    gc.callbacks.append(on_gc)
    gc.set_threshold(1)
    gc.enable()
    try:
        prog = GraphedProgram(body, "cuda")
        prog()                    # the warm-up (+1000) and the capture
        prog()                    # one replay (+1000)
        torch.cuda.synchronize()
    finally:
        gc.callbacks.remove(on_gc)
        gc.set_threshold(*threshold)
        if not enabled:
            gc.disable()
    gc.collect()
    value = float(y[0])
    prog.close()
    out = {"collections": collections[0], "in_capture": len(in_capture),
           "value": value, "garbage_graph_freed": gone() is None}
    log({"capture_gc": out})
    check(collections[0] > 0, "no collection ran around the capture")
    check(not in_capture, f"{len(in_capture)} collections started inside "
          "a capture")
    check(value == 2000.0, f"the replayed program gave {value}, want 2000")
    check(gone() is None, "the garbage graph was not freed")
    return out


def run_graph_serving(models: dict, cont: dict) -> dict:
    """Phase 3f's serving half (after phase 3e, whose fleets replay graphs
    in every replica): per model, phase 3d's rounds 1 and 2 through one
    graphed server with its own registry (answers equal to phase 3d's,
    round 2's trie hits, K4 and dequantize counts from the structure, one
    capture in round 1 and none in round 2); then 8 of its prompts
    admitted directly and one decode block eager against one replayed; for
    the bf16 and int8 targets the same for a speculative round with phase
    3d's draft. Returns the K4 launches of the served rounds, and the row
    of the ``graphs`` line."""
    from bigdl_tpu_torch.nn.quantized import cast_model, quantize_model
    from bigdl_tpu_torch.ops import flash_attention, int8_matmul
    from bigdl_tpu_torch.telemetry import MetricsRegistry, instruments
    t_phase = time.perf_counter()
    p, answers = cont["prompts"], cont["answers"]
    counters = (flash_attention.LAUNCHES, int8_matmul.LAUNCHES,
                int8_matmul.DEQUANT_CALLS)
    pf, block = per_forward(CONFIG["num_layers"]), CONT["decode_block"]
    row, k4_launches = {}, 0
    for name, model in models.items():
        int8 = name == "int8"
        k4_of = lambda forwards: pf * forwards if int8 else 0
        model.__dict__.pop("_prefix_trie", None)   # a cold trie, as in 3d
        reg = MetricsRegistry()
        recompiles = instruments(reg).serving_recompiles_total
        server = continuous_server(model, registry=reg)
        try:
            for c in counters:
                c.reset()
            got, captures = {}, []
            for key in ("round1", "round2"):
                got[key], _ = submit_all(server, p[key], NEW_TOKENS)
                captures.append(recompiles.value)
            counts = tuple(c.value for c in counters)
            k4_launches += counts[1]
            trie = TrieModel()
            (fwd1, hits1), (fwd2, hits2) = (trie.forwards(p[key])
                                            for key in ("round1", "round2"))
            want = (0, k4_of(fwd1 + fwd2 + server.decode_blocks * block), 0)
            hits = server._pipeline.prefix.hits
            check(got["round1"] == answers[name]["round1"]
                  and got["round2"] == answers[name]["round2"],
                  f"{name}: a graphed round's answer differs from phase 3d's")
            check(counts == want, f"{name}: (K1, K4, dequantize) counted "
                  f"{counts} over rounds 1-2, the structure gives {want}")
            check(hits == hits1 + hits2 and hits2 > 0 and captures == [1, 1],
                  f"{name}: trie hits {hits} (want {hits1 + hits2}), "
                  f"captures after rounds 1 and 2 {captures} (want [1, 1])")
            served = {"decode_blocks": server.decode_blocks,
                      "captures_after_rounds_1_2": captures}
            idle(server)
            admit_directly(server, p["round1"][:CONT["slots"]])
            res = eager_against_replay(server, "serving.step",
                                       server._step_body, counters)
            check(res["counts"] == (0, k4_of(block), 0),
                  f"{name}: a decode block counted {res['counts']}")
            row[name] = {"served_rounds_1_2": served, "block": res,
                         "busy_round3_phase3d": answers[name]["busy_round3"]}
        finally:
            server.close()
        if name == "f32":
            continue
        twin = cast_model if name == "bf16" else quantize_model
        draft = twin(models["f32"], torch.bfloat16, device=CONT_DEVICE)
        server = continuous_server(model, draft=draft, spec_len=SPEC_LEN)
        try:
            idle(server)
            admit_directly(server, cont["spec"][:CONT["slots"]])
            res = eager_against_replay(server, "serving.spec_step",
                                       server._spec_body, counters)
            # the draft's SPEC_LEN + 1 steps at M = 8 and the target's
            # verification at M = 8 x (SPEC_LEN + 1) = 40
            check(res["counts"] == (0, k4_of(SPEC_LEN + 2), 0),
                  f"{name}: a speculative round counted {res['counts']}")
            row[name]["speculative_round"] = res
        finally:
            server.close()
            del draft
        if name == "bf16":
            # a sampled block draws from the server's step generator, which
            # the graph registers: the replay draws what the eager block does
            from bigdl_tpu_torch.models.serving import ContinuousLMServer
            server = ContinuousLMServer(
                model, prefix_cache_mb=CONT_PREFIX_MB, device=CONT_DEVICE,
                **{**CONT, "greedy": False, "top_k": 40}, seed=5)
            try:
                idle(server)
                admit_directly(server, p["round1"][:CONT["slots"]])
                row[name]["sampled_block"] = eager_against_replay(
                    server, "serving.step", server._step_body, counters)
            finally:
                server.close()
        torch.cuda.empty_cache()
    row["phase_s"] = time.perf_counter() - t_phase
    log({"graphs_serving": row})
    return {"int8_matmul": k4_launches}, row


# ------------------------------------------ 3g. published checkpoints
HF_FIXTURE = os.path.join("tests", "resources", "hf_tiny_gpt2")
HF_FIXTURE_BOUND = 5e-5     # tests/test_hf_interop.py's bound on its goldens
FIXTURE_PROMPT, FIXTURE_NEW = "Hello world, this is a test", 8
#: openai-community/gpt2's config.json: the fields the computation reads
GPT2_SMALL = {"model_type": "gpt2", "vocab_size": 50257, "n_positions": 1024,
              "n_ctx": 1024, "n_embd": 768, "n_layer": 12, "n_head": 12,
              "n_inner": None, "activation_function": "gelu_new",
              "layer_norm_epsilon": 1e-05, "scale_attn_weights": True,
              "scale_attn_by_inverse_layer_idx": False,
              "tie_word_embeddings": True}
#: meta-llama/Llama-3.2-1B's config.json
LLAMA32_1B = {"model_type": "llama", "vocab_size": 128256,
              "hidden_size": 2048, "intermediate_size": 8192,
              "num_hidden_layers": 16, "num_attention_heads": 32,
              "num_key_value_heads": 8, "max_position_embeddings": 131072,
              "rope_theta": 500000.0,
              "rope_scaling": {"rope_type": "llama3", "factor": 32.0,
                               "low_freq_factor": 1.0,
                               "high_freq_factor": 4.0,
                               "original_max_position_embeddings": 8192},
              "rms_norm_eps": 1e-05, "hidden_act": "silu",
              "attention_bias": False, "mlp_bias": False,
              "tie_word_embeddings": True}
#: Qwen/Qwen2-0.5B's config.json
QWEN2_05B = {"model_type": "qwen2", "vocab_size": 151936, "hidden_size": 896,
             "intermediate_size": 4864, "num_hidden_layers": 24,
             "num_attention_heads": 14, "num_key_value_heads": 2,
             "max_position_embeddings": 131072, "rope_theta": 1000000.0,
             "rms_norm_eps": 1e-06, "hidden_act": "silu",
             "use_sliding_window": False, "sliding_window": 131072,
             "max_window_layers": 24, "tie_word_embeddings": True}
#: each model's parameters, from its model card
PUBLISHED_PARAMS = {"gpt2": 124_439_808, "llama32_1b": 1_235_814_400,
                    "qwen2_05b": 494_032_768}
PUBLISHED_SEEDS = {"gpt2": 21, "llama32_1b": 22, "qwen2_05b": 23}
LLAMA_PROMPTS = 4
QWEN_REQUESTS = 4     # each answer is held to its own generate
WINDOW, WINDOW_NEW = 128, 64    # (e): the 134m recipe, a window that binds


def published_decode_shapes(name: str) -> list:
    """(O, K) of the K4 launches of one int8 decode token of a phase 3g
    model, in the order it runs them: per layer q, k, v, out and the FFN's
    two (GPT-2) or three (SwiGLU) matmuls, then the tied head."""
    if name == "gpt2":
        e, f = GPT2_SMALL["n_embd"], 4 * GPT2_SMALL["n_embd"]
        layer = [(e, e)] * 4 + [(f, e), (e, f)]
        return layer * GPT2_SMALL["n_layer"] + [(GPT2_SMALL["vocab_size"], e)]
    cfg = LLAMA32_1B if name == "llama32_1b" else QWEN2_05B
    e, f = cfg["hidden_size"], cfg["intermediate_size"]
    e_kv = e // cfg["num_attention_heads"] * cfg["num_key_value_heads"]
    layer = [(e, e), (e_kv, e), (e_kv, e), (e, e), (f, e), (f, e), (e, f)]
    return layer * cfg["num_hidden_layers"] + [(cfg["vocab_size"], e)]


# K4's rows in phase 3g: a decode token at 1, 4 (``LMServer``, ``generate``)
# and 8 slots; a continuous prefill chunk (128); the b=1 ``generate``
# prefills and teacher-forced forwards of ragged prompts (33, 65, 160); and
# the top of K4's rule (256)
PUBLISHED_K4_ROWS = (1, REQUESTS_PER_LEN, 8, 33, 65, 128, 160, 256)


def check_published_kernels() -> dict:
    """Phase 2's cases for phase 3g's shapes: K4 through the public
    ``int8_matmul`` (compute dtype f32; bf16 x, with and without a bias,
    two runs with the same bits) at M in PUBLISHED_K4_ROWS over every
    distinct weight shape of the three models and over the q/k/v rows and
    bias slices of a stacked Qwen2 projection; K1 at B=4 S=384 D=64, bf16,
    causal, with N = 14 (Qwen2-0.5B) and 32 (Llama-3.2-1B), the ``mma``
    variant. Tolerances as phase 2's."""
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain
    gen = torch.Generator(device="cuda").manual_seed(41)
    shapes = sorted({s for name in PUBLISHED_PARAMS
                     for s in published_decode_shapes(name)} - {
        (768, 768), (3072, 768), (768, 3072)})   # phase 2's already
    worst = {"int8_matmul": 0.0, "flash_fwd": 0.0}

    def one(m, w, s, bias, what):
        x = torch.randn((m, w.shape[1]), generator=gen,
                        device="cuda").to(torch.bfloat16)
        for b in (None, bias):
            y = int8_matmul(x, w, s, b, torch.float32)
            again = int8_matmul(x, w, s, b, torch.float32)
            ref = int8_matmul_plain(x, w, s.reshape(-1))
            if b is not None:
                ref = ref + b
            err = (y - ref).abs().max().item()
            tol = INT8_RTOL * ref.abs().max().item()
            check(err <= tol and torch.equal(y, again),
                  f"int8 {what} M={m} bias={b is not None}: err {err} > "
                  f"{tol}, or two runs differ")
            worst["int8_matmul"] = max(worst["int8_matmul"], err)

    cases = 0
    for o, kd in shapes:
        w = torch.randint(-127, 128, (o, kd), generator=gen, device="cuda",
                          dtype=torch.int8)
        s = torch.rand((o, 1), generator=gen, device="cuda") * 1e-2 + 1e-3
        bias = torch.randn((o,), generator=gen, device="cuda")
        for m in PUBLISHED_K4_ROWS:
            one(m, w, s, bias, f"O={o} K={kd}")
            cases += 2
    # Qwen2's stacked q;k;v rows and its bias, sliced as the model slices
    e, e_kv = QWEN2_05B["hidden_size"], 128
    w = torch.randint(-127, 128, (e + 2 * e_kv, e), generator=gen,
                      device="cuda", dtype=torch.int8)
    s = torch.rand((e + 2 * e_kv, 1), generator=gen, device="cuda") * 1e-2
    bias = torch.randn((e + 2 * e_kv,), generator=gen, device="cuda")
    for lo, hi in ((0, e), (e, e + e_kv), (e + e_kv, e + 2 * e_kv)):
        for m in PUBLISHED_K4_ROWS:
            one(m, w[lo:hi], s[lo:hi], bias[lo:hi], f"qwen2 rows {lo}:{hi}")
            cases += 2
    variants = {}
    for n in (QWEN2_05B["num_attention_heads"],
              LLAMA32_1B["num_attention_heads"]):
        q, k, v = _qkv(gen, REQUESTS_PER_LEN, PROMPT_LENS[0], PROMPT_LENS[0],
                       n, 64, torch.bfloat16)
        variant, (o, lse) = launched_variant(
            k1_counters(), lambda: fa.kernel_variant(q),
            lambda: fa.flash_attention_with_lse(q, k, v, causal=True))
        po, plse = fa.flash_attention_plain(q, k, v, causal=True)
        err_o, ok_o = flash_o_close(o, po)
        err_l = (lse - plse).abs().max().item()
        check(ok_o and err_l <= FLASH_ATOL and variant == "mma",
              f"flash bf16 B=4 S=384 N={n}: |dO|={err_o} |dLSE|={err_l}, "
              f"variant {variant}")
        variants[f"N={n}"] = variant
        worst["flash_fwd"] = max(worst["flash_fwd"], err_o)
    log({"check": "published_kernels", "k4_shapes": len(shapes),
         "k4_rows": PUBLISHED_K4_ROWS, "k4_cases": cases, "k1": variants, "max_abs_err": worst})
    return worst


def counted(launches: dict, fn):
    """Runs ``fn`` with every count zeroed just before; returns its result
    and its (K1, K1 mma, K4, dequantize) counts, added to ``launches``,
    every K1 launch checked to be its mma or its tf32x3 variant."""
    from bigdl_tpu_torch.ops import flash_attention, int8_matmul
    counters = (flash_attention.LAUNCHES, flash_attention.LAUNCHES_MMA,
                int8_matmul.LAUNCHES, int8_matmul.DEQUANT_CALLS)
    for c in (*counters, flash_attention.LAUNCHES_TF32):
        c.reset()
    out = fn()
    got = tuple(c.value for c in counters)
    tf32 = flash_attention.LAUNCHES_TF32.value
    check(got[0] == got[1] + tf32, f"K1 launched {got[0]} times, {got[1]} "
          f"mma and {tf32} tf32x3")
    for key, n in zip(("flash_fwd", "flash_fwd_mma", "int8_matmul"), got):
        launches[key] += n
    return out, got


def sync() -> None:
    if CONT_DEVICE != "cpu":
        torch.cuda.synchronize()


def n_params(model) -> int:
    return sum(t.numel() for t in model.parameters())


def fixture_cli() -> tuple:
    """(a)'s ``generate --fromHF`` on the vendored GPT-2 as a subprocess on
    the card: (the process, its start time). ``run_published`` starts it
    first and reads it after (b), so it runs beside (a)'s and (b)'s
    checks."""
    root = os.path.dirname(os.path.abspath(__file__))
    cli = subprocess.Popen(
        [sys.executable, "-m", "bigdl_tpu_torch.apps.transformer", "generate",
         "--fromHF", os.path.join(root, HF_FIXTURE), "--prompt",
         FIXTURE_PROMPT, "--maxNewTokens", str(FIXTURE_NEW), "--greedy",
         "--device", CONT_DEVICE], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return cli, time.perf_counter()


def published_fixture() -> dict:
    """(a) The vendored GPT-2 (``tests/resources/hf_tiny_gpt2/``) loaded on
    the card at f32: its log-probs of the golden ids within
    HF_FIXTURE_BOUND of ``transformers``' golden ones; and the
    continuation that ``fixture_cli``'s text must equal, a direct
    ``generate`` on the tokenizer's ids."""
    from bigdl_tpu_torch.interop.hf import load_hf_checkpoint, to_framework_ids
    from bigdl_tpu_torch.interop.hf_tokenizer import load_checkpoint_tokenizer
    from bigdl_tpu_torch.models.generation import generate
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(root, HF_FIXTURE)
    model = load_hf_checkpoint(path, device=CONT_DEVICE)
    check(next(model.parameters()).device.type == CONT_DEVICE,
          "the fixture loaded off the card")
    ids = np.load(os.path.join(path, "golden_input_ids.npy"))
    gold = np.load(os.path.join(path, "golden_logprobs.npy"))
    with torch.inference_mode():
        lp = model(torch.as_tensor(to_framework_ids(ids),
                                   device=CONT_DEVICE))
    err = float(np.abs(lp.float().cpu().numpy() - gold).max())
    check(lp.shape == gold.shape and err <= HF_FIXTURE_BOUND,
          f"fixture log-probs {err} from transformers' golden ones")
    tok = load_checkpoint_tokenizer(path)
    prompt = tok.encode(FIXTURE_PROMPT)
    direct = generate(model, [prompt], FIXTURE_NEW, greedy=True,
                      eos_id=tok.eos_id, device=CONT_DEVICE)[0].tolist()
    return {"max_abs_err_vs_golden": err, "bound": HF_FIXTURE_BOUND,
            "cli_continuation": repr(tok.decode(direct[len(prompt):]))}


def fixture_cli_result(cli, t0: float, want: str) -> dict:
    """``fixture_cli``'s process waited for: its text must equal
    ``want``."""
    try:
        stdout, stderr = cli.communicate(timeout=CLI_TIMEOUT_S)
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait()
    lines = stdout.strip().splitlines()
    got = lines[-1].split(":", 1)[1].strip() if lines else None
    check(cli.returncode == 0 and got == want,
          f"generate --fromHF printed {stdout[-300:]!r} (rc "
          f"{cli.returncode}, stderr {stderr[-800:]!r}); direct "
          f"generate gives {want}")
    return {"cli_s": time.perf_counter() - t0}


def published_gpt2(launches: dict) -> dict:
    """(b) GPT-2 small at full width from a seed, through the directory:
    ``save_hf_checkpoint`` (f32) and ``load_hf_checkpoint`` on the card,
    every parameter bit-equal; then its bf16 and int8 twins serve phase 3's
    traffic through ``LMServer``, every answer equal to ``generate`` and
    within GAP_TOL of a teacher-forced forward; K1 12 launches a prefill
    (``mma`` for bf16; the int8 twin's biases are f32, so its q/k/v are
    too and K1 takes ``tf32x3``), K4 73 a decode forward."""
    import tempfile

    from bigdl_tpu_torch.interop.hf import (gpt2_lm_kwargs,
                                            load_hf_checkpoint,
                                            save_hf_checkpoint)
    from bigdl_tpu_torch.interop.state_dict import _named_params
    from bigdl_tpu_torch.models.generation import generate
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.nn.quantized import cast_model, quantize_model
    kwargs = gpt2_lm_kwargs(GPT2_SMALL)
    vocab, layers = kwargs["vocab_size"], kwargs["num_layers"]
    res = {"config": "openai-community/gpt2"}
    t0 = time.perf_counter()
    base = build_lm(**kwargs, device=CONT_DEVICE,
                    seed=PUBLISHED_SEEDS["gpt2"]).evaluate_mode()
    res["params"] = n_params(base)
    check(res["params"] == PUBLISHED_PARAMS["gpt2"],
          f"gpt2 has {res['params']} parameters")
    with tempfile.TemporaryDirectory() as d:
        t1 = time.perf_counter()
        save_hf_checkpoint(base, d)
        res["save_s"] = time.perf_counter() - t1
        res["checkpoint_mb"] = sum(os.path.getsize(os.path.join(d, f))
                                   for f in os.listdir(d)) / 1e6
        t1 = time.perf_counter()
        loaded = load_hf_checkpoint(d, device=CONT_DEVICE)
        sync()
        res["load_s"] = time.perf_counter() - t1
    pairs = zip(_named_params(base), _named_params(loaded))
    check(all(torch.equal(a[1]._parameters[a[2]], b[1]._parameters[b[2]])
              for a, b in pairs), "gpt2: a reloaded parameter differs")
    del loaded
    twins = {"bf16": cast_model(base, torch.bfloat16, device=CONT_DEVICE),
             "int8": quantize_model(base, torch.bfloat16, device=CONT_DEVICE)}
    del base
    res["build_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(21)
    groups = {s: [rng.integers(1, vocab + 1, s).tolist()
                  for _ in range(REQUESTS_PER_LEN)] for s in PROMPT_LENS}
    prompts = [p for s in PROMPT_LENS for p in groups[s]]
    per_fwd = 6 * layers + 1      # q, k, v, out, fc, proj; the head
    for name, model in twins.items():
        (results, batches, seconds), got = counted(
            launches, lambda: serve(model, prompts))
        k1, k1_mma, k4, deq = got
        check(batches == len(PROMPT_LENS), f"gpt2 {name}: {batches} batches")
        want = (layers * batches, layers * batches if name == "bf16" else 0,
                (1 + per_fwd * (NEW_TOKENS - 1)) * batches
                if name == "int8" else 0,
                (per_fwd - 1) * batches if name == "int8" else 0)
        check(got == want, f"gpt2 {name}: (K1, K1 mma, K4, dequantize) "
                           f"counted {got}, the structure gives {want}")
        for s in PROMPT_LENS:
            direct = generate(model, groups[s], NEW_TOKENS, greedy=True,
                              device=CONT_DEVICE)[:, s:].cpu().tolist()
            for p, w in zip(groups[s], direct):
                got_a = results[prompts.index(p)]
                check(got_a == w and all(1 <= t <= vocab for t in got_a),
                      f"gpt2 {name}: LMServer answer != generate ({s})")
        gap = greedy_gap(model, list(zip(prompts, results)))
        check(gap <= GAP_TOL[name], f"gpt2 {name}: greedy gap {gap}")
        res[name] = {"serve_s": seconds, "tokens_per_s":
                     len(prompts) * NEW_TOKENS / seconds, "k1": k1,
                     "k1_mma": k1_mma, "k4": k4, "dequant": deq,
                     "greedy_gap": gap, "answers_equal_generate": True}
    del twins
    torch.cuda.empty_cache()
    return res


def timed_generate(model, batch, n: int) -> float:
    """Wall seconds of one greedy ``generate`` (ends in a synchronize)."""
    from bigdl_tpu_torch.models.generation import generate
    sync()
    t0 = time.perf_counter()
    generate(model, batch, n, greedy=True, device=CONT_DEVICE)
    sync()
    return time.perf_counter() - t0


def published_llama(launches: dict) -> dict:
    """(c) Llama-3.2-1B at full width, ``llama3`` rope scaling: HF-named
    weights from a seeded ``build_lm`` (``export_llama_state_dict``) into
    ``load_llama`` on the card; the bf16 and int8 twins each ``generate``
    on 4 prompts of 384 tokens, 32 new, greedy, within GAP_TOL of a
    teacher-forced forward; K1 16 launches (``mma``), K4 113 a decode
    forward; ms per decode token."""
    from bigdl_tpu_torch.interop.hf import (export_llama_state_dict,
                                            llama_lm_kwargs, load_llama)
    from bigdl_tpu_torch.models.generation import generate
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.nn.quantized import cast_model, quantize_model
    kwargs = llama_lm_kwargs(LLAMA32_1B)
    vocab, layers = kwargs["vocab_size"], kwargs["num_layers"]
    res = {"config": "meta-llama/Llama-3.2-1B"}
    t0 = time.perf_counter()
    seeded = build_lm(**kwargs, device=CONT_DEVICE,
                      seed=PUBLISHED_SEEDS["llama32_1b"])
    sd = export_llama_state_dict(seeded)
    del seeded
    res["seed_and_export_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    model = load_llama(LLAMA32_1B, sd, device=CONT_DEVICE)
    del sd
    sync()
    res["load_s"] = time.perf_counter() - t1
    res["params"] = n_params(model)
    check(res["params"] == PUBLISHED_PARAMS["llama32_1b"],
          f"llama32_1b has {res['params']} parameters")
    mha = model[1]._modules["layer0"].self_attn
    check(mha.rope_scaling == LLAMA32_1B["rope_scaling"]
          and mha.num_kv_heads == LLAMA32_1B["num_key_value_heads"],
          "llama32_1b: rope scaling or GQA lost")
    twins = {"bf16": cast_model(model, torch.bfloat16, device=CONT_DEVICE),
             "int8": quantize_model(model, torch.bfloat16, device=CONT_DEVICE)}
    del model
    torch.cuda.empty_cache()
    rng = np.random.default_rng(22)
    prompts = [rng.integers(1, vocab + 1, PROMPT_LENS[0]).tolist()
               for _ in range(LLAMA_PROMPTS)]
    batch = torch.as_tensor(prompts, device=CONT_DEVICE)
    per_fwd = 7 * layers + 1
    for name, twin in twins.items():
        out, got = counted(launches, lambda: generate(
            twin, batch, NEW_TOKENS, greedy=True, device=CONT_DEVICE))
        int8 = name == "int8"
        want = (layers, layers, 1 + per_fwd * (NEW_TOKENS - 1) if int8 else 0,
                per_fwd - 1 if int8 else 0)
        check(got == want, f"llama32_1b {name}: (K1, K1 mma, K4, "
                           f"dequantize) counted {got}, the structure "
                           f"gives {want}")
        answers = out[:, PROMPT_LENS[0]:].cpu().tolist()
        check(all(len(a) == NEW_TOKENS and all(1 <= t <= vocab for t in a)
                  for a in answers), f"llama32_1b {name}: malformed answer")
        gap = greedy_gap(twin, list(zip(prompts, answers)))
        check(gap <= GAP_TOL[name], f"llama32_1b {name}: greedy gap {gap}")
        t_one = min(timed_generate(twin, batch, 1) for _ in range(2))
        t_all = min(timed_generate(twin, batch, NEW_TOKENS) for _ in range(2))
        res[name] = {"k1": got[0], "k1_mma": got[1], "k4": got[2],
                     "dequant": got[3], "greedy_gap": gap,
                     "prefill_ms": t_one * 1e3,
                     "decode_ms_per_token": (t_all - t_one)
                     / (NEW_TOKENS - 1) * 1e3,
                     "tokens_per_s": LLAMA_PROMPTS * NEW_TOKENS / t_all}
    res["phase_s"] = time.perf_counter() - t0
    del twins
    torch.cuda.empty_cache()
    return res


def published_qwen2(launches: dict) -> dict:
    """(d) Qwen2-0.5B at full width, q/k/v biases: HF-named arrays made
    here (a seeded Llama-shaped ``build_lm``'s ``export_llama_state_dict``
    and the q/k/v biases from a seed; the reference exports no Qwen2) into
    ``load_qwen2`` on the card; the bf16 and int8 twins each serve one
    ``ContinuousLMServer`` round (QWEN_REQUESTS of 33-384 tokens, 32 new),
    every answer held to ``generate``; no K1 (chunked prefill), K4 169 a
    forward (M = 1 to 128 rows, K = 896 and 4864, the bias slices) and no
    dequantize."""
    from bigdl_tpu_torch.interop.hf import (export_llama_state_dict,
                                            load_qwen2, qwen2_lm_kwargs)
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.nn.quantized import cast_model, quantize_model
    kwargs = qwen2_lm_kwargs(QWEN2_05B)
    vocab, layers = kwargs["vocab_size"], kwargs["num_layers"]
    res = {"config": "Qwen/Qwen2-0.5B"}
    t0 = time.perf_counter()
    seeded = build_lm(**dict(kwargs, qkv_bias=False), device=CONT_DEVICE,
                      seed=PUBLISHED_SEEDS["qwen2_05b"])
    sd = export_llama_state_dict(seeded)
    del seeded
    rng = np.random.default_rng(PUBLISHED_SEEDS["qwen2_05b"])
    e = kwargs["embed_dim"]
    e_kv = e // kwargs["num_heads"] * kwargs["num_kv_heads"]
    for i in range(layers):
        for x, n in (("q", e), ("k", e_kv), ("v", e_kv)):
            sd[f"model.layers.{i}.self_attn.{x}_proj.bias"] = (
                0.1 * rng.standard_normal(n)).astype(np.float32)
    model = load_qwen2(QWEN2_05B, sd, device=CONT_DEVICE)
    res["build_and_load_s"] = time.perf_counter() - t0
    res["params"] = n_params(model)
    check(res["params"] == PUBLISHED_PARAMS["qwen2_05b"],
          f"qwen2_05b has {res['params']} parameters")
    want_b = np.concatenate([sd[f"model.layers.0.self_attn.{x}_proj.bias"]
                             for x in "qkv"])
    got_b = model[1]._modules["layer0"].self_attn.in_proj_bias
    check(np.array_equal(got_b.detach().cpu().numpy(), want_b),
          "qwen2_05b: the q/k/v biases did not load")
    del sd
    twins = {"bf16": cast_model(model, torch.bfloat16, device=CONT_DEVICE),
             "int8": quantize_model(model, torch.bfloat16, device=CONT_DEVICE)}
    del model
    torch.cuda.empty_cache()
    prompts = [rng.integers(1, vocab + 1, int(n)).tolist()
               for n in rng.integers(33, LONG_PROMPT + 1, QWEN_REQUESTS)]
    per_fwd = 7 * layers + 1
    block = CONT["decode_block"]
    for name, twin in twins.items():
        out, got = counted(launches, lambda: serve_once(twin, prompts))
        fwd = TrieModel().forwards(prompts)[0] + out["decode_blocks"] * block
        want = (0, 0, per_fwd * fwd if name == "int8" else 0, 0)
        check(got == want, f"qwen2_05b {name}: (K1, K1 mma, K4, dequantize)"
                           f" counted {got}, the structure gives {want}")
        held = held_to_generate(f"qwen2_05b {name}", twin, prompts,
                                out["answers"], vocab, GAP_TOL[name])
        res[name] = {**{k: v for k, v in out.items() if k != "answers"},
                     "k4": got[2], **held}
        twin.__dict__.pop("_prefix_trie", None)
    res["phase_s"] = time.perf_counter() - t0
    del twins
    torch.cuda.empty_cache()
    return res


def published_window(launches: dict) -> dict:
    """(e) The window band and the rolling cache, on the 134m recipe with
    ``window=128`` (bf16 twin, seed 7): ``generate`` on 2 prompts of 384
    tokens, 64 new, greedy, with the rolling ring cache and the linear
    one: equal tokens, both within GAP_TOL of a teacher-forced windowed
    forward; one ``ContinuousLMServer`` round held to ``generate``. K1
    must not launch (the band takes the plain core)."""
    from bigdl_tpu_torch.models.generation import generate
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.nn.attention import MultiHeadAttention
    from bigdl_tpu_torch.nn.quantized import cast_model
    t0 = time.perf_counter()
    base = build_lm(VOCAB, **dict(CONFIG, window=WINDOW), device=CONT_DEVICE,
                    seed=7)
    model = cast_model(base, torch.bfloat16, device=CONT_DEVICE)
    del base
    rng = np.random.default_rng(27)
    prompts = [rng.integers(1, VOCAB + 1, LONG_PROMPT).tolist()
               for _ in range(2)]
    batch = torch.as_tensor(prompts, device=CONT_DEVICE)
    res = {"window": WINDOW}
    outs = {}
    for rolling in (False, True):
        key = "rolling" if rolling else "linear"
        sync()
        t1 = time.perf_counter()
        out, got = counted(launches, lambda: generate(
            model, batch, WINDOW_NEW, greedy=True, rolling_cache=rolling,
            device=CONT_DEVICE))
        sync()
        outs[key] = out
        answers = out[:, LONG_PROMPT:].cpu().tolist()
        gap = greedy_gap(model, list(zip(prompts, answers)))
        check(got[0] == 0 and got[2] == 0,
              f"window {key}: K1 or K4 launched {got}")
        check(gap <= GAP_TOL["bf16"], f"window {key}: greedy gap {gap}")
        res[key] = {"generate_s": time.perf_counter() - t1,
                    "greedy_gap": gap}
    check(torch.equal(outs["linear"], outs["rolling"]),
          "window: the rolling cache's tokens differ from the linear one's")
    mha = [m for m in model.modules() if isinstance(m, MultiHeadAttention)][0]
    mha.enable_decode(2, LONG_PROMPT + WINDOW_NEW, rolling=True)
    res["ring_slots"] = mha.k_cache.shape[1]
    mha.disable_decode()
    cont = [rng.integers(1, VOCAB + 1, int(n)).tolist()
            for n in rng.integers(33, LONG_PROMPT + 1, 8)]
    out, got = counted(launches, lambda: serve_once(model, cont))
    check(got[0] == 0, f"window continuous: K1 launched {got[0]} times")
    res["continuous"] = {**{k: v for k, v in out.items() if k != "answers"},
                         **held_to_generate("bf16 windowed", model, cont,
                                            out["answers"],
                                            tol=GAP_TOL["bf16"])}
    res["phase_s"] = time.perf_counter() - t0
    model.__dict__.pop("_prefix_trie", None)
    return res


def run_published() -> dict:
    """Phase 3g; returns the K1 and K4 launches of its runs (the kernel
    checks' own excluded)."""
    t0 = time.perf_counter()
    launches = {"flash_fwd": 0, "flash_fwd_mma": 0, "int8_matmul": 0}
    cli, t_cli = fixture_cli()   # beside (a) and (b)
    try:
        row = {"fixture": published_fixture()}
        row["gpt2"] = published_gpt2(launches)
    except BaseException:
        cli.kill()
        cli.wait()
        raise
    row["fixture"].update(fixture_cli_result(
        cli, t_cli, row["fixture"]["cli_continuation"]))
    log({"published": {"fixture": row["fixture"]}})
    log({"published": {"gpt2": row["gpt2"]}})
    torch.cuda.empty_cache()
    for key, fn in (("llama32_1b", published_llama),
                    ("qwen2_05b", published_qwen2),
                    ("window", published_window)):
        row[key] = fn(launches)
        log({"published": {key: row[key]}})
        torch.cuda.empty_cache()
    log({"published_phase_s": time.perf_counter() - t0,
         "launches": launches})
    return launches


# -------------------------------------------------------------- 3b. training
GRAD_RTOL = 1e-3


def grad_check(model) -> None:
    """Every parameter's gradient of one f32 batch (B=1, S=128) on the card
    (K1, K2, K3) against a CPU copy with the same weights (the plain path):
    finite, and within GRAD_RTOL in relative L2 per tensor (f32 sums in
    other orders; the two paths agree to ~1e-6)."""
    from bigdl_tpu_torch.apps.transformer import synthetic_corpus
    from bigdl_tpu_torch.interop.state_dict import (export_lm_state_dict,
                                                    import_lm_state_dict)
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.nn.criterion import FusedLMHeadCriterion
    from bigdl_tpu_torch.ops import flash_attention as fa
    cpu = build_lm(VOCAB, **CONFIG, device="cpu", seed=0)
    import_lm_state_dict(cpu, export_lm_state_dict(model))
    sample = synthetic_corpus(1, 128, VOCAB, seed=1)[0]
    grads = []   # the card's, then the CPU's
    for m in (model, cpu):
        dev = next(m.parameters()).device
        m.train()
        m.zero_grad(set_to_none=True)
        for c in (fa.LAUNCHES, fa.LAUNCHES_MMA, fa.LAUNCHES_TF32,
                  fa.LAUNCHES_DQ, fa.LAUNCHES_DQ_MMA, fa.LAUNCHES_DKV,
                  fa.LAUNCHES_DKV_MMA):
            c.reset()
        ids = torch.as_tensor(sample.feature[None], device=dev)
        tgt = torch.as_tensor(sample.label[None], device=dev)
        FusedLMHeadCriterion()(m(ids), tgt).backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
        if dev.type == "cuda":
            layers = CONFIG["num_layers"]
            check((fa.LAUNCHES.value, fa.LAUNCHES_DQ.value,
                   fa.LAUNCHES_DKV.value) == (layers,) * 3,
                  "the card's gradient did not run K1, K2 and K3 once a layer")
            check((fa.LAUNCHES_MMA.value, fa.LAUNCHES_DQ_MMA.value,
                   fa.LAUNCHES_DKV_MMA.value) == (0, 0, 0),
                  "the f32 gradient check ran an mma variant of K1, K2 or K3")
            check(fa.LAUNCHES_TF32.value == layers,
                  f"the f32 gradient check ran K1's tf32x3 variant "
                  f"{fa.LAUNCHES_TF32.value} times, want {layers}")
    model.zero_grad(set_to_none=True)
    worst, worst_name = 0.0, ""
    for name, ref in grads[1].items():
        got = grads[0][name]
        check(got is not None and torch.isfinite(got).all().item(),
              f"gradient of {name} on the card is missing or not finite")
        rel = ((got.cpu() - ref).norm() / ref.norm().clamp_min(1e-30)).item()
        check(rel <= GRAD_RTOL, f"gradient of {name}: relative L2 {rel}")
        if rel > worst:
            worst, worst_name = rel, name
    log({"check": "grad_134m_f32_B1_S128", "params": len(grads[1]),
         "max_rel_l2": worst, "worst_param": worst_name})


def _train(model, ds, steps: int, steps_per_dispatch: int = 1):
    from bigdl_tpu_torch.nn.criterion import FusedLMHeadCriterion
    from bigdl_tpu_torch.optim import AdamW, Optimizer, Trigger
    opt = (Optimizer(model, ds, FusedLMHeadCriterion(), device="cuda")
           .set_precision("bf16")
           .set_optim_method(AdamW(learningrate=TRAIN_LR,
                                   weightdecay=TRAIN_DECAY))
           .set_gradient_clipping_by_l2_norm(TRAIN_CLIP)
           .set_end_when(Trigger.max_iteration(steps))
           .set_steps_per_dispatch(steps_per_dispatch))
    opt.optimize()
    torch.cuda.synchronize()
    return opt.history


def lm_head_ce_peak_mib() -> float:
    """Peak device memory of the fused LM-head CE's forward and backward at
    the training shape (N = 8 x 512 rows, V=32000, E=768, bf16, the
    default chunk 16384), above what its inputs hold."""
    from bigdl_tpu_torch.ops.lm_head_ce import fused_lm_head_ce
    gen = torch.Generator(device="cuda").manual_seed(8)
    n, e = TRAIN_BATCH * TRAIN_SEQ, CONFIG["embed_dim"]
    h = torch.randn((n, e), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((VOCAB, e), generator=gen, device="cuda").to(torch.bfloat16)
    tgt = torch.randint(1, VOCAB + 1, (n,), generator=gen, device="cuda")
    h.requires_grad_()
    w.requires_grad_()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fused_lm_head_ce(h, w, None, tgt).backward()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def run_training() -> tuple:
    """Phase 3b; returns the K1, K2, K3 launches of the 20-step run (all,
    and of the "mma" variants), and that run's losses, final parameters,
    median step and busy share for phase 3f."""
    from bigdl_tpu_torch.apps.transformer import synthetic_corpus
    from bigdl_tpu_torch.dataset.base import DataSet, SampleToBatch
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    model = build_lm(VOCAB, **CONFIG, device="cuda", seed=7)
    grad_check(model)
    log({"grad_check_s": time.perf_counter() - t0})
    samples = synthetic_corpus(TRAIN_BATCH * TRAIN_STEPS, TRAIN_SEQ, VOCAB,
                               seed=17)
    ds = DataSet.array(samples, seed=0) >> SampleToBatch(TRAIN_BATCH)
    counters = (fa.LAUNCHES, fa.LAUNCHES_MMA, fa.LAUNCHES_DQ,
                fa.LAUNCHES_DQ_MMA, fa.LAUNCHES_DKV, fa.LAUNCHES_DKV_MMA)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    t1 = time.perf_counter()
    history = _train(model, ds, TRAIN_STEPS)
    train_s = time.perf_counter() - t1
    k1, k1_mma, k2, k2_mma, k3, k3_mma = (c.value for c in counters)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = [h["loss"] for h in history]
    step_s = float(np.median([h["seconds"] for h in history[3:]]))
    want = CONFIG["num_layers"] * TRAIN_STEPS
    log({"train": "134m", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
         "precision": "bf16", "optim": f"AdamW lr={TRAIN_LR} "
         f"decay={TRAIN_DECAY}", "clip_l2": TRAIN_CLIP, "losses": losses})
    log({"train_steps": len(losses), "train_s": train_s,
         "step_ms_median": step_s * 1e3,
         "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
         "peak_allocated_mib": peak_mib, "k1_launches": k1,
         "k1_mma_launches": k1_mma, "k2_launches": k2,
         "k2_mma_launches": k2_mma, "k3_launches": k3,
         "k3_mma_launches": k3_mma})
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"training losses {losses}")
    check(float(np.mean(losses[-5:])) < losses[0],
          f"loss did not fall: first {losses[0]}, last five {losses[-5:]}")
    check(k1 == k1_mma == k2 == k2_mma == k3 == k3_mma == want,
          f"training launched K1/K2/K3 {k1}/{k2}/{k3} times ({k1_mma}/"
          f"{k2_mma}/{k3_mma} of them mma), want {want}, all mma")
    k1_run = {"losses": losses, "step_ms": step_s * 1e3,
              "peak_allocated_mib": peak_mib,
              "params": {n: p.detach().clone()
                         for n, p in model.named_parameters()}}

    # device busy share: kernel time over the wall time of 4 more steps;
    # None ("not measured") when the profiler recorded nothing
    extra = DataSet.array(samples[:4 * TRAIN_BATCH], seed=1) \
        >> SampleToBatch(TRAIN_BATCH)
    rows, wall = profiled(lambda: _train(model, extra, 4), "training steps")
    busy = None if rows is None else sum(t for _, t in rows) / 1e6 / wall
    top = ([] if rows is None else
           sorted(((k[:60], t / 4) for k, t in rows), key=lambda r: -r[1])[:6])
    log({"train_device_busy_share": busy, "profiled_steps": 4,
         "profiled_wall_s": wall, "top_kernels_us_per_step": top,
         "lm_head_ce_peak_mib": lm_head_ce_peak_mib()})
    k1_run["busy"] = busy
    log({"surface": {"lm": timed_within("3b", "3s", surface_lm, model,
                                        samples)}})
    del model
    torch.cuda.empty_cache()
    return {"flash_fwd": k1, "flash_fwd_mma": k1_mma, "flash_bwd_dq": k2,
            "flash_bwd_dq_mma": k2_mma, "flash_bwd_dkv": k3,
            "flash_bwd_dkv_mma": k3_mma}, k1_run


# ------------------------------------------ 3f. CUDA graphs: training half
GRAPH_TRAIN_K = 4
# k = 4 against k = 1: the same losses and parameters to the bit. A
# window's graph runs the kernels of k = 1's eager steps on the same
# inputs in the same order, and the update reads from a device tensor the
# very float32 values that CUDA derives from k = 1's Python floats
# (``optim/methods.py``), which check_update_paths holds bit for bit first
GRAPH_TRAIN_LOSS_TOL = 0.0


def check_update_paths() -> None:
    """AdamW and SGD, 5 updates of a (1000, 257) parameter: the Python-float
    arithmetic against ``update(scalars=...)`` with ``step_scalars`` on the
    card, bit for bit."""
    from bigdl_tpu_torch.optim import SGD, AdamW
    gen = torch.Generator(device="cuda").manual_seed(41)
    for method in (AdamW(learningrate=TRAIN_LR, weightdecay=TRAIN_DECAY),
                   SGD(learningrate=0.1, momentum=0.9, weightdecay=1e-4)):
        w = torch.randn((1000, 257), generator=gen, device="cuda")
        pa, pb = {"w": w.clone()}, {"w": w.clone()}
        sa, sb = method.init_state(pa), method.init_state(pb)
        for _ in range(5):
            g = torch.randn((1000, 257), generator=gen, device="cuda")
            row = torch.tensor(method.step_scalars(sb), dtype=torch.float32,
                               device="cuda")
            method.update({"w": g.clone()}, sa, pa)
            method.update({"w": g.clone()}, sb, pb, row)
        check(torch.equal(pa["w"], pb["w"]),
              f"{type(method).__name__}: the update from device scalars "
              "differs from the Python-float update")


def busy_after_first_capture(fn) -> tuple:
    """(device busy share, wall seconds) of ``fn``'s run from the end of
    its first CUDA graph capture on (the first window's warm-up and capture
    excluded): profiler kernel time over wall time; (None, wall) when the
    profiler recorded nothing."""
    from torch.profiler import ProfilerActivity, profile
    from bigdl_tpu_torch.utils.cuda_graph import GraphedProgram
    prof = profile(activities=[ProfilerActivity.CUDA])
    mark = {}
    capture = GraphedProgram._warm_up_and_capture

    def capture_then_profile(self):
        out = capture(self)
        if not mark:
            torch.cuda.synchronize()
            prof.start()
            mark["t0"] = time.perf_counter()
        return out

    GraphedProgram._warm_up_and_capture = capture_then_profile
    try:
        fn()
        torch.cuda.synchronize()
        check(bool(mark), "the profiled run captured no graph")
        wall = time.perf_counter() - mark["t0"]
        prof.stop()
    finally:
        GraphedProgram._warm_up_and_capture = capture
    busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e6
    return (busy / wall if busy > 0 else None), wall


def run_graph_training(k1_run: dict) -> tuple:
    """Phase 3f's training half: phase 3b's recipe from seed 7 again with
    ``set_steps_per_dispatch(4)`` (5 windows of 4: the first the eager
    warm-up, then its capture, then 4 replays), against phase 3b's k = 1
    run: losses and final parameters to GRAPH_TRAIN_LOSS_TOL, K1, K2 and K3
    each 12 x 20 launches (all ``mma``) through the replay accounting, ms
    per iteration, peak memory, and the busy share of 3 more windows
    after their capture. Returns the K1-K3 launches and the row of the
    ``graphs`` line."""
    from bigdl_tpu_torch.apps.transformer import synthetic_corpus
    from bigdl_tpu_torch.dataset.base import DataSet, SampleToBatch
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.ops import flash_attention as fa
    t_phase = time.perf_counter()
    check_update_paths()
    model = build_lm(VOCAB, **CONFIG, device="cuda", seed=7)
    samples = synthetic_corpus(TRAIN_BATCH * TRAIN_STEPS, TRAIN_SEQ, VOCAB,
                               seed=17)
    ds = DataSet.array(samples, seed=0) >> SampleToBatch(TRAIN_BATCH)
    counters = (fa.LAUNCHES, fa.LAUNCHES_MMA, fa.LAUNCHES_DQ,
                fa.LAUNCHES_DQ_MMA, fa.LAUNCHES_DKV, fa.LAUNCHES_DKV_MMA)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    census0 = dict(GRAPH_CENSUS)
    t1 = time.perf_counter()
    history = _train(model, ds, TRAIN_STEPS, GRAPH_TRAIN_K)
    train_s = time.perf_counter() - t1
    got = tuple(c.value for c in counters)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = [h["loss"] for h in history]
    want = CONFIG["num_layers"] * TRAIN_STEPS
    loss_diff = max(abs(a - b) for a, b in zip(losses, k1_run["losses"]))
    rel_l2 = max(((q - k1_run["params"][n]).float().norm()
                  / k1_run["params"][n].float().norm().clamp_min(1e-30)).item()
                 for n, q in model.named_parameters())
    # each iteration of a window is logged at the window's time over k;
    # the first window (warm-up and capture) is left out
    step_ms = 1e3 * float(np.median([h["seconds"]
                                     for h in history[GRAPH_TRAIN_K:]]))
    row = {"k": GRAPH_TRAIN_K, "iterations": len(losses),
           "captures": GRAPH_CENSUS["captures"] - census0["captures"],
           "replays": GRAPH_CENSUS["replays"] - census0["replays"],
           "train_s": train_s, "losses": losses,
           "largest_loss_difference_to_k1": loss_diff,
           "loss_tol": GRAPH_TRAIN_LOSS_TOL,
           "largest_param_rel_l2_to_k1": rel_l2,
           "ms_per_iteration_k1": k1_run["step_ms"],
           f"ms_per_iteration_k{GRAPH_TRAIN_K}": step_ms,
           "peak_allocated_mib_k1": k1_run["peak_allocated_mib"],
           f"peak_allocated_mib_k{GRAPH_TRAIN_K}": peak_mib,
           "k1_k1mma_k2_k2mma_k3_k3mma": got}
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses))
          and loss_diff <= GRAPH_TRAIN_LOSS_TOL,
          f"k = {GRAPH_TRAIN_K} losses {losses} differ from k = 1's "
          f"{k1_run['losses']} by up to {loss_diff}")
    check(got == (want,) * 6, f"k = {GRAPH_TRAIN_K} training launched "
          f"(K1, K1 mma, K2, K2 mma, K3, K3 mma) {got}, want {want} each")
    check(row["captures"] == 1 and row["replays"] == TRAIN_STEPS
          // GRAPH_TRAIN_K - 1, f"training graphs: {row['captures']} "
          f"captures, {row['replays']} replays")
    extra = DataSet.array(samples[:3 * GRAPH_TRAIN_K * TRAIN_BATCH],
                          seed=1) >> SampleToBatch(TRAIN_BATCH)
    busy, wall = busy_after_first_capture(
        lambda: _train(model, extra, 3 * GRAPH_TRAIN_K, GRAPH_TRAIN_K))
    row.update({"busy_share_k1": k1_run["busy"],
                f"busy_share_k{GRAPH_TRAIN_K}": busy,
                "busy_profiled_windows": 2, "busy_profiled_wall_s": wall,
                "phase_s": time.perf_counter() - t_phase})
    log({"graphs_training": row})
    del model
    torch.cuda.empty_cache()
    return {"flash_fwd": got[0], "flash_fwd_mma": got[1],
            "flash_bwd_dq": got[2], "flash_bwd_dq_mma": got[3],
            "flash_bwd_dkv": got[4], "flash_bwd_dkv_mma": got[5]}, row


# ------------------------------------------- 3h. checkpoints and resume
CKPT_DEVICE = "cuda"        # where phase 3h trains (the CPU for a dry run)
CKPT_EVERY, VAL_EVERY, KILL_AT, VAL_BATCHES = 8, 10, 12, 4
CKPT_K = 4                  # part (b) again with windows of up to 4
RESUME_SEED = 99            # a resumed run's model starts from other weights
RESNET_CKPT_STEPS, RESNET_CKPT_AT = 6, 4   # the snapshot after 3 iterations
CKPT_MIN_FREE_GB = 6        # part (b) holds 3 pairs of 1.54 GB at once
# Perplexity against exp(Loss's mean): one f32 NLL summed in two orders
PPL_RTOL = 1e-5
CKPT_CLI = ["--vocab", "512", "--embedDim", "256", "--numHeads", "4",
            "--numLayers", "2", "--seqLen", "128", "-b", "8",
            "--synthetic-size", "64", "-e", "1", "--llamaBlock"]
CKPT_CLI_VOCAB, CKPT_CLI_EMBED = 512, 256


def all_mma_launches(n: int) -> dict:
    """``flash_counters``' expected counts in a bf16 run with n launches of
    each of K1, K2 and K3: every one ``mma``, none ``tf32x3``."""
    return {k: 0 if k == "flash_fwd_tf32" else n for k in flash_counters()}


def flash_counters() -> dict:
    from bigdl_tpu_torch.ops import flash_attention as fa
    return {"flash_fwd": fa.LAUNCHES, "flash_fwd_mma": fa.LAUNCHES_MMA,
            "flash_fwd_tf32": fa.LAUNCHES_TF32,
            "flash_bwd_dq": fa.LAUNCHES_DQ,
            "flash_bwd_dq_mma": fa.LAUNCHES_DQ_MMA,
            "flash_bwd_dkv": fa.LAUNCHES_DKV,
            "flash_bwd_dkv_mma": fa.LAUNCHES_DKV_MMA}


def ckpt_sync() -> None:
    if CKPT_DEVICE != "cpu":
        torch.cuda.synchronize()


class SaveLoadTimes:
    """Wall seconds of each ``LocalOptimizer._save_checkpoint`` (the copy to
    the host, the pickling, the writes and the marker) and
    ``_resume_state`` (the reads and the copies into the live tensors)
    while installed; the card's queue is drained before and after each."""

    def __enter__(self):
        from bigdl_tpu_torch.optim.optimizer import LocalOptimizer
        self.save, self.load = [], []
        self._orig = (LocalOptimizer._save_checkpoint,
                      LocalOptimizer._resume_state)

        def timed(fn, into):
            def run(*args, **kwargs):
                ckpt_sync()
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    ckpt_sync()
                    into.append(time.perf_counter() - t0)
            return run

        LocalOptimizer._save_checkpoint = timed(self._orig[0], self.save)
        LocalOptimizer._resume_state = timed(self._orig[1], self.load)
        return self

    def __exit__(self, *exc):
        from bigdl_tpu_torch.optim.optimizer import LocalOptimizer
        LocalOptimizer._save_checkpoint, LocalOptimizer._resume_state = \
            self._orig


def first_update_seconds(opt, t0: float, into: dict) -> None:
    """Record in ``into["first_step_s"]`` the seconds from ``t0`` to the end
    of the optimizer's first update (the card drained once, then)."""
    method = opt.optim_method
    update = method.update

    def first(*args, **kwargs):
        out = update(*args, **kwargs)
        if "first_step_s" not in into:
            ckpt_sync()
            into["first_step_s"] = time.perf_counter() - t0
        return out

    method.update = first


def dispatch_windows(fn) -> tuple:
    """(fn's result or its exception, the window lengths of its
    ``train.dispatch`` spans)."""
    from bigdl_tpu_torch.telemetry import tracing
    tracing.clear()
    tracing.enable()
    try:
        try:
            out = fn()
        except Exception as e:  # handed back to the caller, which checks it
            out = e
        return out, [e["args"]["k"] for e in tracing.events()
                     if e["name"] == "train.dispatch"]
    finally:
        tracing.disable()
        tracing.clear()


_CKPT_DATA = {}


def ckpt_lm_optimizer(model, ckpt_dir: str, k: int = 1):
    """Phase 3b's recipe (B=8, S=512, bf16 over f32 masters, AdamW, L2 clip
    1.0, 20 iterations of seed 17's corpus in seed 0's order) with a
    checkpoint every CKPT_EVERY iterations and a validation every VAL_EVERY
    over VAL_BATCHES held-out batches of the grammar (seed 23): Loss (the
    mean token NLL) and Perplexity."""
    from bigdl_tpu_torch.apps.transformer import synthetic_corpus
    from bigdl_tpu_torch.dataset.base import DataSet, SampleToBatch
    from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                              FusedLMHeadCriterion,
                                              TimeDistributedCriterion)
    from bigdl_tpu_torch.optim import (AdamW, Loss, Optimizer, Perplexity,
                                       Trigger)
    if not _CKPT_DATA:
        _CKPT_DATA["train"] = synthetic_corpus(TRAIN_BATCH * TRAIN_STEPS,
                                               TRAIN_SEQ, VOCAB, seed=17)
        _CKPT_DATA["val"] = synthetic_corpus(VAL_BATCHES * TRAIN_BATCH,
                                             TRAIN_SEQ, VOCAB, seed=23)
    ds = DataSet.array(_CKPT_DATA["train"], seed=0) \
        >> SampleToBatch(TRAIN_BATCH)
    val = DataSet.array(_CKPT_DATA["val"]) >> SampleToBatch(TRAIN_BATCH)
    return (Optimizer(model, ds, FusedLMHeadCriterion(), device=CKPT_DEVICE)
            .set_precision("bf16")
            .set_optim_method(AdamW(learningrate=TRAIN_LR,
                                    weightdecay=TRAIN_DECAY))
            .set_gradient_clipping_by_l2_norm(TRAIN_CLIP)
            .set_end_when(Trigger.max_iteration(TRAIN_STEPS))
            .set_steps_per_dispatch(k)
            .set_checkpoint(ckpt_dir, Trigger.several_iteration(CKPT_EVERY))
            .set_validation(Trigger.several_iteration(VAL_EVERY), val, [
                Loss(TimeDistributedCriterion(ClassNLLCriterion())),
                Perplexity()]))


def param_crcs(model) -> dict:
    import zlib
    return {n: zlib.crc32(p.detach().cpu().numpy().tobytes())
            for n, p in model.named_parameters()}


def validation_rows(history) -> list:
    return [{"neval": v["neval"], "records": v["records"],
             "seconds": v["seconds"],
             **{name: list(r.result()) for name, r in v["results"].items()}}
            for v in history]


def resume_helper(ckpt_dir: str, k: int) -> int:
    """``--resume-helper DIR --steps-per-dispatch K``: a fresh process builds
    the model from RESUME_SEED, ``auto_resume()``s from DIR with the phase's
    optimizer and trains to the end; prints one ``resume_helper`` line."""
    from bigdl_tpu_torch.models.transformer import build_lm
    model = build_lm(VOCAB, **CONFIG, device=CKPT_DEVICE, seed=RESUME_SEED)
    opt = ckpt_lm_optimizer(model, ckpt_dir, k).auto_resume()
    counters = flash_counters()
    for c in counters.values():
        c.reset()
    timing = {}
    with SaveLoadTimes() as times:
        t0 = time.perf_counter()
        first_update_seconds(opt, t0, timing)
        out, windows = dispatch_windows(opt.optimize)
        ckpt_sync()
        seconds = time.perf_counter() - t0
    if isinstance(out, Exception):
        raise out
    log({"resume_helper": {
        "k": k, "nevals": [h["neval"] for h in opt.history],
        "losses": [h["loss"] for h in opt.history], "windows": windows,
        "crcs": param_crcs(model), "optimize_s": seconds,
        "load_s": times.load, "save_s": times.save,
        "first_step_s": timing.get("first_step_s"),
        "launches": {n: c.value for n, c in counters.items()},
        "validation": validation_rows(opt.validation_history)}})
    return 0


def run_resume_helper(ckpt_dir: str, k: int) -> dict:
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable,
                             os.path.join(root, "chip_smoke.py"),
                             "--resume-helper", ckpt_dir,
                             "--steps-per-dispatch", str(k)],
                            cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    SPAWNED.append(proc)   # killed at exit if a phase fails beside it
    try:
        stdout, stderr = proc.communicate(timeout=CLI_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    rows = [json.loads(line)["resume_helper"] for line in
            stdout.splitlines() if line.startswith('{"resume_helper"')]
    check(proc.returncode == 0 and len(rows) == 1,
          f"the resumed process (k = {k}): rc {proc.returncode}, stdout "
          f"{stdout[-800:]!r}, stderr {stderr[-2000:]!r}")
    rows[0]["process_s"] = time.perf_counter() - t0
    return rows[0]


def check_validation(rows: list, want_nevals: list, what: str) -> None:
    check([r["neval"] for r in rows] == want_nevals,
          f"{what}: validations at {[r['neval'] for r in rows]}, want "
          f"{want_nevals}")
    for r in rows:
        loss, ppl = r["Loss"][0], r["Perplexity"][0]
        check(np.isfinite(loss) and np.isfinite(ppl)
              and r["records"] == VAL_BATCHES * TRAIN_BATCH
              and r["Perplexity"][1] == VAL_BATCHES * TRAIN_BATCH * TRAIN_SEQ
              and abs(ppl - np.exp(loss)) <= PPL_RTOL * np.exp(loss),
              f"{what}: validation {r}")


def check_resumed_half(got: dict, a: dict, what: str) -> None:
    """A resumed run's iterations KILL_AT+1..20: losses and final
    parameters bit-equal to part (a), K1-K3 12 x 8 times each, all mma,
    plus K1's f32 validation forward (tf32x3) at 20."""
    check(got["nevals"] == list(range(KILL_AT + 1, TRAIN_STEPS + 1)),
          f"{what}: resumed iterations {got['nevals']}")
    check(got["losses"] == a["losses"][KILL_AT:],
          f"{what}: losses {got['losses']} differ from the uninterrupted "
          f"run's {a['losses'][KILL_AT:]}")
    bad = [n for n, c in a["crcs"].items() if got["crcs"].get(n) != c]
    check(not bad, f"{what}: {len(bad)} parameters differ from the "
          f"uninterrupted run's, e.g. {bad[:3]}")
    n = CONFIG["num_layers"] * (TRAIN_STEPS - KILL_AT)
    val = CONFIG["num_layers"] * VAL_BATCHES
    want = {"flash_fwd": n + val, "flash_fwd_mma": n, "flash_fwd_tf32": val,
            "flash_bwd_dq": n, "flash_bwd_dq_mma": n, "flash_bwd_dkv": n,
            "flash_bwd_dkv_mma": n}
    check(CKPT_DEVICE == "cpu" or got["launches"] == want,
          f"{what}: launches {got['launches']}, want {want}")
    check_validation(got["validation"], [20], what)


def ckpt_uninterrupted(k1_run: dict, root: str) -> dict:
    """Part (a): phase 3b's run with the checkpoint and validation hooks,
    bit-equal to phase 3b's."""
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.resilience import coordinator
    d = os.path.join(root, "a")
    model = build_lm(VOCAB, **CONFIG, device=CKPT_DEVICE, seed=7)
    opt = ckpt_lm_optimizer(model, d)
    counters = flash_counters()
    for c in counters.values():
        c.reset()
    with SaveLoadTimes() as times:
        t0 = time.perf_counter()
        opt.optimize()
        ckpt_sync()
        seconds = time.perf_counter() - t0
    launches = {n: c.value for n, c in counters.items()}
    losses = [h["loss"] for h in opt.history]
    check(losses == k1_run["losses"], f"(a): hooks changed the losses: "
          f"{losses} against phase 3b's {k1_run['losses']}")
    check(all(torch.equal(p, k1_run["params"][n].to(p.device))
              for n, p in model.named_parameters()),
          "(a): hooks changed the final parameters")
    pairs = [(p[2], p[3]) for p in coordinator.snapshot_pairs(d)]
    check(pairs == [("model.8", "state.8"), ("model.16", "state.16")],
          f"(a): snapshot pairs {pairs}")
    check(all(coordinator.validate_pair(os.path.join(d, m),
                                        os.path.join(d, s))
              for m, s in pairs), "(a): a snapshot pair does not validate")
    rows = validation_rows(opt.validation_history)
    check_validation(rows, [VAL_EVERY, 2 * VAL_EVERY], "(a)")
    n = CONFIG["num_layers"] * TRAIN_STEPS
    val = CONFIG["num_layers"] * VAL_BATCHES * 2
    want = {"flash_fwd": n + val, "flash_fwd_mma": n, "flash_fwd_tf32": val,
            "flash_bwd_dq": n, "flash_bwd_dq_mma": n, "flash_bwd_dkv": n,
            "flash_bwd_dkv_mma": n}
    check(CKPT_DEVICE == "cpu" or launches == want,
          f"(a): launches {launches}, want {want}")
    val_s = sum(r["seconds"] for r in rows)
    out = {"losses": losses, "crcs": param_crcs(model), "launches": launches,
           "optimize_s": seconds, "save_s": times.save,
           "model_mb": os.path.getsize(os.path.join(d, "model.8")) / 1e6,
           "state_mb": os.path.getsize(os.path.join(d, "state.8")) / 1e6,
           "validation": rows,
           "validation_records_per_s": sum(r["records"] for r in rows) / val_s,
           "validation_ms_per_batch": 1e3 * val_s / (len(rows) * VAL_BATCHES),
           "model": model}
    shutil.rmtree(d)
    return out


def ckpt_preempted(root: str, a: dict, k: int):
    """Part (b): the run of (a) with ``set_preemption_handler()`` and
    ``KillAtStep(KILL_AT)`` (a real SIGTERM), then a fresh process that
    ``auto_resume()``s to the end, started beside what the caller does
    next. Returns the function that waits for it and gives the part's
    row."""
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.resilience import (KillAtStep, TrainingPreempted,
                                            coordinator)
    d = os.path.join(root, f"b{k}")
    model = build_lm(VOCAB, **CONFIG, device=CKPT_DEVICE, seed=7)
    opt = ckpt_lm_optimizer(model, d, k)
    opt.set_preemption_handler().set_chaos([KillAtStep(KILL_AT)])
    counters = flash_counters()
    for c in counters.values():
        c.reset()
    with SaveLoadTimes() as times:
        out, windows = dispatch_windows(opt.optimize)
    check(isinstance(out, TrainingPreempted)
          and out.snapshot == os.path.join(d, f"model.{KILL_AT + 1}"),
          f"(b, k = {k}): the run ended with {out!r}, not preempted")
    launches = {n: c.value for n, c in counters.items()}
    n = CONFIG["num_layers"] * KILL_AT
    val = CONFIG["num_layers"] * VAL_BATCHES
    want = {"flash_fwd": n + val, "flash_fwd_mma": n, "flash_fwd_tf32": val,
            "flash_bwd_dq": n, "flash_bwd_dq_mma": n, "flash_bwd_dkv": n,
            "flash_bwd_dkv_mma": n}
    check(CKPT_DEVICE == "cpu" or launches == want,
          f"(b, k = {k}): launches {launches}, want {want}")
    losses = [h["loss"] for h in opt.history]
    check(losses == a["losses"][:KILL_AT],
          f"(b, k = {k}): the preempted run's losses {losses}")
    point = coordinator.latest_resume_point(d)
    check(point.marker["step"] == KILL_AT + 1 and point.marker["cursor"]
          == {"epoch": 1, "epoch_batches": KILL_AT,
              "epoch_records": KILL_AT * TRAIN_BATCH},
          f"(b, k = {k}): marker {point.marker}")
    # k = 4: [1-4]; the checkpoint at 8 ends [5-7]; the validation at 10
    # ends [8, 9]; the kill after 12 ends [10-12]
    want_windows = [1] * KILL_AT if k == 1 else [4, 3, 2, 3]
    check(windows == want_windows,
          f"(b, k = {k}): windows {windows}, want {want_windows}")
    del model, opt
    if CKPT_DEVICE != "cpu":
        torch.cuda.empty_cache()
    resumed = Beside(run_resume_helper, d, k)

    def finish() -> dict:
        helper = resumed.result()
        check_resumed_half(helper, a, f"(b, k = {k})")
        # the resumed k = 4 windows: the checkpoint at 16 ends [13-15],
        # the validation at 20 ends [16-19]
        want_windows = [1] * (TRAIN_STEPS - KILL_AT) if k == 1 else [3, 4, 1]
        check(helper["windows"] == want_windows,
              f"(b, k = {k}): resumed windows {helper['windows']}")
        return {"windows": windows, "resumed_windows": helper["windows"],
                "preempt_save_s": times.save[-1], "launches": launches,
                "resumed": {key: helper[key] for key in (
                    "process_s", "optimize_s", "load_s", "save_s",
                    "first_step_s", "launches")}}
    return finish


def resilience_cli(*args) -> subprocess.CompletedProcess:
    root = os.path.dirname(os.path.abspath(__file__))
    return subprocess.run([sys.executable, "-m", "bigdl_tpu_torch.resilience",
                           *map(str, args)], cwd=root, capture_output=True,
                          text=True, timeout=120)


def ckpt_corrupted(root: str, a: dict) -> dict:
    """Part (c): the newest snapshot of (b)'s k = 1 directory damaged with
    ``chaos corrupt``; ``validate`` calls it PARTIAL, ``latest`` names the
    one before it, and a resume from there is bit-equal to (a)."""
    from bigdl_tpu_torch.models.transformer import build_lm
    d = os.path.join(root, "b1")
    newest = os.path.join(d, f"model.{2 * CKPT_EVERY}")
    r = resilience_cli("chaos", "corrupt", newest, "--seed", "5")
    check(r.returncode == 0, f"(c): chaos corrupt: {r.stderr[-1000:]}")
    r = resilience_cli("validate", d)
    lines = r.stdout.splitlines()
    check(r.returncode == 0 and lines and lines[0].startswith("PARTIAL")
          and f"model.{2 * CKPT_EVERY} " in lines[0]
          and all(line.startswith("complete") for line in lines[1:]),
          f"(c): validate: {r.stdout!r} {r.stderr[-1000:]!r}")
    r = resilience_cli("latest", d)
    check(r.returncode == 0 and r.stdout.split()[0]
          == os.path.join(d, f"model.{KILL_AT + 1}"),
          f"(c): latest: {r.stdout!r} {r.stderr[-1000:]!r}")
    model = build_lm(VOCAB, **CONFIG, device=CKPT_DEVICE, seed=RESUME_SEED)
    opt = ckpt_lm_optimizer(model, d).auto_resume()
    counters = flash_counters()
    for c in counters.values():
        c.reset()
    timing = {}
    with SaveLoadTimes() as times:
        t0 = time.perf_counter()
        first_update_seconds(opt, t0, timing)
        opt.optimize()
        ckpt_sync()
        seconds = time.perf_counter() - t0
    got = {"nevals": [h["neval"] for h in opt.history],
           "losses": [h["loss"] for h in opt.history],
           "crcs": param_crcs(model),
           "launches": {n: c.value for n, c in counters.items()},
           "validation": validation_rows(opt.validation_history)}
    check_resumed_half(got, a, "(c)")
    del model, opt
    shutil.rmtree(d)
    return {"validate": lines, "optimize_s": seconds, "load_s": times.load,
            "first_step_s": timing["first_step_s"],
            "launches": got["launches"]}


def ckpt_resnet(root: str) -> dict:
    """Part (d): phase 3c's fused ResNet-50 recipe (B=256, bf16 over f32
    masters, SGD 0.1 with momentum 0.9), 6 iterations with snapshots after
    3 and 6, against 3 iterations resumed from the first snapshot in a
    model built from another seed: parameters, BN statistics and the
    final snapshot's optim state (the momentum buffers) bit-equal, K5 and
    K6 36 x 3 and 13 x 3 times in the resumed half. cuDNN is held to its
    deterministic algorithms for the phase (the stem conv is cuDNN's)."""
    from bigdl_tpu_torch.dataset.base import DataSet
    from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    from bigdl_tpu_torch.resilience import coordinator
    batch = imagenet_batch(RESNET_BATCH, 5)

    def resnet_opt(model, d):
        return (Optimizer(model, DataSet.array([batch] * RESNET_CKPT_STEPS,
                                               seed=0),
                          ClassNLLCriterion(), device=CKPT_DEVICE)
                .set_precision("bf16")
                .set_optim_method(SGD(learningrate=RESNET_LR,
                                      momentum=RESNET_MOMENTUM))
                .set_end_when(Trigger.max_iteration(RESNET_CKPT_STEPS))
                .set_checkpoint(d, Trigger.or_(
                    Trigger.several_iteration(RESNET_CKPT_AT),
                    Trigger.max_iteration(RESNET_CKPT_STEPS))))

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        full_dir, half_dir = (os.path.join(root, "r_full"),
                              os.path.join(root, "r_half"))
        full = build_resnet50(True, CKPT_DEVICE, seed=7)
        with SaveLoadTimes() as times:
            resnet_opt(full, full_dir).optimize()
            half = build_resnet50(True, CKPT_DEVICE, seed=8)
            opt = resnet_opt(half, half_dir).resume(
                os.path.join(full_dir, f"model.{RESNET_CKPT_AT}"),
                os.path.join(full_dir, f"state.{RESNET_CKPT_AT}"))
            counters = conv_bn_counters()
            for c in counters:
                c.reset()
            opt.optimize()
            ckpt_sync()
        k5, k5_mma, k6, k6_mma = (c.value for c in counters)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    steps = RESNET_CKPT_STEPS - RESNET_CKPT_AT + 1
    check([h["neval"] for h in opt.history]
          == list(range(RESNET_CKPT_AT, RESNET_CKPT_STEPS + 1)),
          f"(d): resumed iterations {[h['neval'] for h in opt.history]}")
    mismatched = [n for (n, a), (_, b) in zip(
        list(full.named_parameters()) + list(full.named_buffers()),
        list(half.named_parameters()) + list(half.named_buffers()))
        if not torch.equal(a, b)]
    check(not mismatched, f"(d): {len(mismatched)} parameters or buffers "
          f"differ after the resume, e.g. {mismatched[:3]}")
    final = f"state.{RESNET_CKPT_STEPS + 1}"
    check(coordinator._digest(os.path.join(full_dir, final))
          == coordinator._digest(os.path.join(half_dir, final)),
          "(d): the optim state (momentum) after the resume differs")
    want = (K5_PER_STEP * steps,) * 2 + (K6_PER_STEP * steps,) * 2
    check(CKPT_DEVICE == "cpu" or (k5, k5_mma, k6, k6_mma) == want,
          f"(d): resumed K5/K6 launches {(k5, k5_mma, k6, k6_mma)}, want "
          f"{want}")
    out = {"model_mb": os.path.getsize(os.path.join(
               full_dir, f"model.{RESNET_CKPT_AT}")) / 1e6,
           "state_mb": os.path.getsize(os.path.join(
               full_dir, f"state.{RESNET_CKPT_AT}")) / 1e6,
           "save_s": times.save, "load_s": times.load,
           "launches": {"matmul_bn": k5, "matmul_bn_mma": k5_mma,
                        "conv3x3_bn": k6, "conv3x3_bn_mma": k6_mma}}
    del full, half, opt
    shutil.rmtree(full_dir)
    shutil.rmtree(half_dir)
    return out


def read_served_port(proc, deadline: float) -> int:
    import re
    seen = []
    while time.perf_counter() < deadline:
        line = proc.stderr.readline()
        if not line:
            break
        seen.append(line.strip())
        m = re.search(r"serving on http://[\d.]+:(\d+)", line)
        if m:
            return int(m.group(1))
    check(False, f"serve never reported its port: {seen[-20:]}")


def ckpt_cli(root: str):
    """Part (e): ``train --checkpoint DIR`` at a small size on the card,
    ``generate --model DIR/model_final`` and ``serve --continuous --model
    ... --draft`` (a saved 2-layer draft) as subprocesses, started beside
    what the caller does next, each answer equal to ``generate`` on the
    loaded module; the 134m's int8 twin saved and loaded on the card: the
    same K4 launches a forward and the same tokens. Returns the function
    that, given the 134m, waits for the processes, runs the twin and gives
    the part's row."""
    import signal
    import urllib.request

    from bigdl_tpu_torch.apps import transformer as app
    from bigdl_tpu_torch.models.generation import generate
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.nn.quantized import quantize_model
    from bigdl_tpu_torch.ops import int8_matmul
    from bigdl_tpu_torch.utils import file_io
    d = os.path.join(root, "cli")
    counters = {**flash_counters(), "int8_matmul": int8_matmul.LAUNCHES}
    for c in counters.values():
        c.reset()
    cli = [sys.executable, "-m", "bigdl_tpu_torch.apps.transformer"]
    device = ["--device", CKPT_DEVICE]
    src = os.path.dirname(os.path.abspath(__file__))
    res = {}
    t0 = time.perf_counter()
    app.main(["train", "--checkpoint", d, *CKPT_CLI, *device])
    res["train_s"] = time.perf_counter() - t0
    target = os.path.join(d, "model_final")
    check(os.path.exists(target) and os.path.exists(os.path.join(d, "state.9")),
          f"(e): train --checkpoint wrote {sorted(os.listdir(d))}")
    loaded = file_io.load(target, device=CKPT_DEVICE).evaluate_mode()
    prompt = [5, 17, 3, 250, 9]
    want = generate(loaded, [prompt], 16, greedy=True,
                    device=CKPT_DEVICE)[0, len(prompt):].tolist()
    draft_path = os.path.join(d, "draft_final")
    file_io.save(build_lm(CKPT_CLI_VOCAB, CKPT_CLI_EMBED, 4,
                          ffn_dim=4 * CKPT_CLI_EMBED, num_layers=2,
                          max_len=1024, rope=True, norm="rms",
                          activation="swiglu", bias=False,
                          device=CKPT_DEVICE, seed=31), draft_path)
    t2 = time.perf_counter()   # the two processes run side by side
    gen = subprocess.Popen(cli + ["generate", "--model", target, "--greedy",
                                  "--prompt", ",".join(map(str, prompt)),
                                  "--maxNewTokens", "16"] + device,
                           cwd=src, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    proc = subprocess.Popen(cli + ["serve", "--continuous", "--model", target,
                                   "--draft", draft_path, "--specLen", "4",
                                   "--greedy", "--maxNewTokens", "16",
                                   "--port", "0"] + device,
                            cwd=src, stderr=subprocess.PIPE,
                            stdout=subprocess.DEVNULL, text=True)
    SPAWNED.extend((gen, proc))   # killed at exit if a part fails beside

    def finish(model) -> dict:
        try:
            out, err = gen.communicate(timeout=CLI_TIMEOUT_S)
            res["generate_s"] = time.perf_counter() - t2
            lines = out.strip().splitlines()
            check(gen.returncode == 0 and len(lines) == 2
                  and json.loads(lines[1].split(":", 1)[1]) == want,
                  f"(e): generate --model printed {out[-400:]!r} (want "
                  f"{want}), stderr {err[-1500:]!r}")
            port = read_served_port(proc, time.perf_counter()
                                    + CLI_TIMEOUT_S)
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/generate",
                data=json.dumps({"prompt": prompt}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                served = json.loads(r.read())["ids"]
            check(served == want, f"(e): serve --draft answered {served}, "
                  f"generate {want}")
            proc.send_signal(signal.SIGTERM)
            check(proc.wait(timeout=30) == 0, "(e): serve did not exit 0")
        finally:
            for p in (gen, proc):
                if p.poll() is None:
                    p.kill()
                    p.wait()
        res["serve_draft_s"] = time.perf_counter() - t2

        # the 134m's int8 twin through file_io on the card
        twin = quantize_model(model, torch.bfloat16, device=CKPT_DEVICE)
        t3 = time.perf_counter()
        file_io.save(twin, os.path.join(d, "int8_twin"))
        res["int8_save_s"] = time.perf_counter() - t3
        t4 = time.perf_counter()
        back = file_io.load(os.path.join(d, "int8_twin"), device=CKPT_DEVICE)
        ckpt_sync()
        res["int8_load_s"] = time.perf_counter() - t4
        res["int8_mb"] = os.path.getsize(os.path.join(d, "int8_twin")) / 1e6
        ids = torch.as_tensor(np.random.default_rng(37).integers(
            1, VOCAB + 1, (4, 64)), device=CKPT_DEVICE)
        per = []
        for m in (twin, back):
            before = int8_matmul.LAUNCHES.value
            with torch.no_grad():
                m(ids)
            per.append(int8_matmul.LAUNCHES.value - before)
        toks = [generate(m, ids[:, :16], 8, greedy=True, device=CKPT_DEVICE)
                for m in (twin, back)]
        check(CKPT_DEVICE == "cpu"
              or per == [per_forward(CONFIG["num_layers"])] * 2,
              f"(e): K4 launches a forward {per}")
        check(torch.equal(toks[0], toks[1]),
              "(e): the loaded int8 twin's tokens differ")
        res["k4_per_forward"] = per
        res["launches"] = {n: c.value for n, c in counters.items()}
        del twin, back
        shutil.rmtree(d)
        return res
    return finish


def run_checkpoints(k1_run: dict) -> dict:
    """Phase 3h (after phase 3b, whose 20-iteration run it holds (a) and
    every resume to): (a) hooks, (b) preempt and resume in a fresh
    process at k = 1 and k = CKPT_K, (c) a corrupted snapshot skipped, (d)
    ResNet-50 resumed, (e) the ``--model``/``--draft`` command line. Every
    snapshot goes under one temporary directory, removed at the end.
    Returns the launches of K1-K6 for the ``kernels`` line."""
    import tempfile
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="bigdl_ckpt_")
    try:
        free_gb = shutil.disk_usage(root).free / 1e9
        log({"checkpoints_free_disk_gb": free_gb, "dir": root})
        check(free_gb >= CKPT_MIN_FREE_GB, f"phase 3h needs "
              f"{CKPT_MIN_FREE_GB} GB free under {root}, has {free_gb}")
        a = ckpt_uninterrupted(k1_run, root)
        model = a.pop("model")
        t = time.perf_counter()
        # (c) damages the newest snapshot of k = 1's resumed half, so that
        # half ends first; k = 4's resumed process runs beside (d) and (e)
        b1 = ckpt_preempted(root, a, 1)()
        c = ckpt_corrupted(root, a)
        b4_resumed = ckpt_preempted(root, a, CKPT_K)
        lm_s = time.perf_counter() - t
        e_served = ckpt_cli(root)   # its processes beside (d)
        d = ckpt_resnet(root)
        e = e_served(model)
        del model
        b4 = b4_resumed()
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if CKPT_DEVICE != "cpu":
            torch.cuda.empty_cache()
    log({"checkpoints": {
        "lm_134m": {"model_mb": a["model_mb"], "state_mb": a["state_mb"],
                    "save_s": a["save_s"], "optimize_with_hooks_s":
                    a["optimize_s"], "validation": a["validation"],
                    "validation_records_per_s":
                    a["validation_records_per_s"],
                    "validation_ms_per_batch": a["validation_ms_per_batch"],
                    "preempt_resume_corrupt_s": lm_s},   # k = 4's
                    # resumed process excluded (it runs beside (d), (e))
        "preempted_k1": b1, f"preempted_k{CKPT_K}": b4, "corrupted": c,
        "resnet50": d, "cli": e, "phase_s": time.perf_counter() - t_phase}})
    PLAIN_SNAPSHOT.update(model_mb=a["model_mb"], state_mb=a["state_mb"],
                          save_s=a["save_s"], load_s=c["load_s"])
    launches = {key: a["launches"][key] + c["launches"][key]
                + b1["launches"][key] + b1["resumed"]["launches"][key]
                + b4["launches"][key] + b4["resumed"]["launches"][key]
                + e["launches"][key] for key in a["launches"]}
    launches.update(d["launches"])
    launches["int8_matmul"] = e["launches"]["int8_matmul"]
    return launches


# -------------------------------------------------------------- 3c. ResNet-50
RESNET_BATCH, RESNET_STEPS, AB_STEPS = 256, 20, 5
RESNET_LR, RESNET_MOMENTUM = 0.1, 0.9
RESNET_GRAD_BATCH = 8
RESNET_GRAD_SEED = 11
RESNET_LOSS_RTOL = 1e-5
GRAD_TRUTH_FACTOR = 2
EVAL_RTOL = 1e-4
FUSION_GATES = ("BIGDL_TPU_FUSED_1X1", "BIGDL_TPU_FUSED_3X3")
K5_PER_STEP, K6_PER_STEP = 36, 13
_CONV_BN_FIELDS = ("weight", "bias", "gamma", "beta", "running_mean",
                   "running_var")


def build_resnet50(fused: bool, device: str, seed: int):
    """``resnet.build(1000, 50)``, bench.py's resnet50 workload, with both
    fusion gates set (``fused``) or unset; the environment is restored."""
    from bigdl_tpu_torch.models import resnet
    return _with_gates(FUSION_GATES if fused else (), lambda: resnet.build(
        1000, 50, device=device, seed=seed))


def _with_gates(gates, build):
    """``build()`` with exactly the fusion gates in ``gates`` set; the
    environment is restored."""
    saved = {g: os.environ.get(g) for g in FUSION_GATES}
    try:
        for g in FUSION_GATES:
            if g in gates:
                os.environ[g] = "1"
            else:
                os.environ.pop(g, None)
        return build()
    finally:
        for g, v in saved.items():
            if v is None:
                os.environ.pop(g, None)
            else:
                os.environ[g] = v


def state_units(model):
    """The model's state as ``(kind, {field: tensor})`` units in forward
    order, named alike whether or not conv+BN pairs are fused: every pair
    (a fused module, or a conv followed by a ``BatchNormalization``) is one
    ``"conv_bn"`` unit of ``_CONV_BN_FIELDS``; every other leaf module with
    parameters or buffers is a unit of its own, named by its class. Pairs
    are found by registration order, which is forward order in the ResNet
    builders."""
    from bigdl_tpu_torch.nn.fused import _FusedConvBN
    from bigdl_tpu_torch.nn.normalization import BatchNormalization
    leaves = [m for m in model.modules()
              if not m._modules and (m._parameters or m._buffers)]
    units, i = [], 0
    while i < len(leaves):
        m = leaves[i]
        nxt = leaves[i + 1] if i + 1 < len(leaves) else None
        if isinstance(m, _FusedConvBN):
            units.append(("conv_bn", {f: getattr(m, f) for f in _CONV_BN_FIELDS
                                      if hasattr(m, f)}))
            i += 1
        elif (not isinstance(m, BatchNormalization)
              and isinstance(nxt, BatchNormalization) and nxt.affine):
            unit = {"weight": m.weight, "gamma": nxt.weight, "beta": nxt.bias,
                    "running_mean": nxt.running_mean,
                    "running_var": nxt.running_var}
            if getattr(m, "with_bias", False):
                unit["bias"] = m.bias
            units.append(("conv_bn", unit))
            i += 2
        else:
            units.append((type(m).__name__,
                          {**dict(m.named_parameters()),
                           **dict(m.named_buffers())}))
            i += 1
    return units


def transfer_state(src, dst):
    """Copy every parameter and buffer of ``src`` into ``dst`` where the two
    models are the same network but one fuses conv+BN pairs that the other
    keeps apart (a ResNet built with and without the fusion gates): a
    ``FusedConv1x1BN``/``FusedConv3x3BN`` carries its conv weight (HWIO,
    the same layout), ``gamma``, ``beta`` and running statistics to and
    from a conv and the ``BatchNormalization`` after it. Shapes are checked
    before anything is written."""
    a, b = state_units(src), state_units(dst)
    if len(a) != len(b):
        raise ValueError(f"the models differ: {len(a)} and {len(b)} units "
                         "with state")
    pairs = []
    for (kind_a, ta), (kind_b, tb) in zip(a, b):
        if kind_a != kind_b or sorted(ta) != sorted(tb):
            raise ValueError(f"the models differ: {kind_a}{sorted(ta)} vs "
                             f"{kind_b}{sorted(tb)}")
        for f, t in ta.items():
            if t.shape != tb[f].shape:
                raise ValueError(f"{kind_a}.{f}: shape {tuple(t.shape)} vs "
                                 f"{tuple(tb[f].shape)}")
            pairs.append((tb[f], t))
    with torch.no_grad():
        for dst_t, src_t in pairs:
            dst_t.copy_(src_t)
    return dst


def imagenet_batch(b: int, seed: int):
    """bench.py's constant data: N(0, 1) NHWC images and 1-based labels."""
    return zoo_batch(b, 224, 3, 1000, seed)


def conv_bn_counters():
    """K5's and K6's launch counters, each with its "mma" variant's."""
    from bigdl_tpu_torch.ops import conv3x3_bn, matmul_bn
    return (matmul_bn.LAUNCHES, matmul_bn.LAUNCHES_MMA, conv3x3_bn.LAUNCHES,
            conv3x3_bn.LAUNCHES_MMA)


def _unit_state(model):
    """{name: gradient of a parameter, or a buffer} over every parameter
    and buffer, named by ``state_units`` so that a fused and an unfused
    model agree."""
    return {f"{i}:{kind}.{field}": (t.grad if t.requires_grad else t)
            for i, (kind, unit) in enumerate(state_units(model))
            for field, t in sorted(unit.items())}


def _rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.detach().cpu().double(), ref.detach().cpu().double()
    return ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def resnet_grad_check(seed: int = RESNET_GRAD_SEED) -> dict:
    """ResNet-50, one f32 batch of RESNET_GRAD_BATCH images at 224x224,
    through four models that carry the same weights (built from ``seed``):
    the fused model on the card (K5 and K6); its CPU copy
    (``export_tree_state`` -> ``import_tree_state``), which takes the
    kernels' plain versions; the unfused model (gates unset, weights
    through ``transfer_state``) on the card, cuDNN convs and
    ``batch_norm_train``; and the unfused model on the CPU in f64, the
    reference that each f32 path is measured against. The f32 losses agree
    with the f64 one within RESNET_LOSS_RTOL; the card launches K5 and K6
    once per fused pair and the unfused model neither. Every gradient and
    updated running statistic of the fused model on the card is finite,
    and its relative L2 distance to the f64 reference is within GRAD_RTOL
    or within GRAD_TRUTH_FACTOR times the unfused card model's distance for
    the same tensor, whichever is larger: ResNet-50 at random init turns
    f32 rounding into percent-level gradient differences on every f32 path,
    so the library path's own distance to the truth is the scale the
    kernels' path is held to. Returns the readings."""
    from bigdl_tpu_torch.interop.state_dict import (export_tree_state,
                                                    import_tree_state)
    from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
    card = build_resnet50(True, "cuda", seed=seed)
    cpu = build_resnet50(True, "cpu", seed=seed + 1)
    import_tree_state(cpu, *export_tree_state(card))
    plain_card = build_resnet50(False, "cuda", seed=seed + 2)
    truth = build_resnet50(False, "cpu", seed=seed + 3)
    for m in (plain_card, truth):
        transfer_state(card, m)
    truth.double()
    batch = imagenet_batch(RESNET_GRAD_BATCH, seed + 4)
    k5, _, k6, _ = conv_bn_counters()
    losses, states = [], []
    for m in (card, cpu, plain_card, truth):
        p = next(m.parameters())
        m.train()
        k5.reset()
        k6.reset()
        x = torch.as_tensor(batch.data, device=p.device).to(p.dtype)
        loss = ClassNLLCriterion()(m(x), torch.as_tensor(batch.labels,
                                                         device=p.device))
        loss.backward()
        losses.append(loss.item())
        states.append(_unit_state(m))
        want = ((K5_PER_STEP, K6_PER_STEP) if m is card else (0, 0))
        check((k5.value, k6.value) == want,
              f"the gradient run launched K5/K6 {k5.value}/{k6.value} times,"
              f" want {want}")
    for got in losses[:3]:
        rel = abs(got - losses[3]) / abs(losses[3])
        check(rel <= RESNET_LOSS_RTOL,
              f"ResNet-50 losses {losses} (fused card, fused CPU, unfused "
              f"card, f64): {rel}")
    fused, fused_cpu, lib, ref = states
    dist = {f"{path}_{kind}": [] for path in ("fused_card", "fused_cpu_f32",
                                              "unfused_card")
            for kind in ("grads", "running_stats")}
    over, worst, by_depth = [], {"ratio": 0.0, "name": ""}, []
    for name, want in ref.items():
        got = fused[name]
        check(got is not None and torch.isfinite(got).all().item(),
              f"{name} on the card is missing or not finite")
        d_f, d_u = _rel_l2(got, want), _rel_l2(lib[name], want)
        kind = "running_stats" if "running_" in name else "grads"
        dist[f"fused_card_{kind}"].append(d_f)
        dist[f"fused_cpu_f32_{kind}"].append(_rel_l2(fused_cpu[name], want))
        dist[f"unfused_card_{kind}"].append(d_u)
        if name.endswith("conv_bn.weight") or "Linear" in name:
            by_depth.append((name, d_u))
        if d_f > max(GRAD_RTOL, GRAD_TRUTH_FACTOR * d_u):
            over.append((name, d_f, d_u))
        ratio = d_f / max(d_u, GRAD_RTOL)
        if ratio > worst["ratio"]:
            worst.update(ratio=ratio, name=name)
    readings = {"check": f"grad_resnet50_f32_B{RESNET_GRAD_BATCH}_vs_f64",
                "seed": seed, "tensors": len(ref),
                "losses_fused_card_fused_cpu_unfused_card_f64": losses,
                **{f"{k}_rel_l2_median": float(np.median(v))
                   for k, v in dist.items()},
                **{f"{k}_rel_l2_max": max(v) for k, v in dist.items()},
                "max_ratio_fused_over_unfused_card": worst["ratio"],
                "worst_ratio_tensor": worst["name"],
                # the unfused card model's weight-gradient distance from the
                # stem (first) to the head (last): every eighth conv, the
                # last conv and the head's Linear
                "unfused_card_weight_grad_by_depth":
                    by_depth[::8] + by_depth[-3:],
                "fused_card_vs_fused_cpu_rel_l2_median": float(np.median(
                    [_rel_l2(fused[n], fused_cpu[n]) for n in ref]))}
    log(readings)
    check(not over, f"{len(over)} tensors of the fused card model are further"
          f" than {GRAD_TRUTH_FACTOR}x the unfused card model from the f64 "
          f"reference, e.g. (name, fused, unfused): {over[:3]}")
    return readings


def train_resnet(model, batch, steps: int):
    """bench.py's recipe (bench.py:270-272) through ``Optimizer``:
    ``ClassNLLCriterion``, SGD(0.1, momentum 0.9), bf16 compute over f32
    masters; the dataset is the one constant batch, ``steps`` times."""
    from bigdl_tpu_torch.dataset.base import DataSet
    from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    opt = (Optimizer(model, DataSet.array([batch] * steps, seed=0),
                     ClassNLLCriterion(), device="cuda")
           .set_precision("bf16")
           .set_optim_method(SGD(learningrate=RESNET_LR,
                                 momentum=RESNET_MOMENTUM))
           .set_end_when(Trigger.max_iteration(steps)))
    opt.optimize()
    torch.cuda.synchronize()
    return opt.history


def profile_steps(model, batch, what: str) -> dict:
    """Device busy share, the top five kernels and the fused kernels' time
    (K6: ``conv3x3_stats``, K5: ``matmul_stats``, and the statistics pass
    both share, ``column_reduce``) over two more steps; None ("not
    measured") when the profiler recorded nothing."""
    rows, wall = profiled(lambda: train_resnet(model, batch, 2), what)
    if rows is None:
        return {"device_busy_share": None, "top_kernels_ms_per_step": []}
    per_step = sorted(((k[:70], t / 2e3) for k, t in rows),
                      key=lambda r: -r[1])
    layout = [(k, ms) for k, ms in per_step
              if any(w in k.lower() for w in ("copy", "nchw", "nhwc",
                                               "transpose"))]
    fused = {part: sum(t for k, t in rows if part in k) / 2e3
             for part in ("conv3x3_stats", "matmul_stats", "column_reduce")}
    return {"device_busy_share": sum(t for _, t in rows) / 1e6 / wall,
            "kernel_ms_per_step": sum(t for _, t in rows) / 2e3,
            "top_kernels_ms_per_step": per_step[:5],
            "fused_kernels_ms_per_step": fused,
            "copy_and_layout_kernels_ms_per_step": layout[:6]}


def run_resnet() -> dict:
    """Phase 3c; returns the K5 and K6 launches of the 20-step run."""
    from bigdl_tpu_torch.nn.conv import SpatialConvolution
    t0 = time.perf_counter()
    resnet_grad_check()
    log({"resnet_grad_check_s": time.perf_counter() - t0})
    batch = imagenet_batch(RESNET_BATCH, 5)
    t1 = time.perf_counter()
    torch.as_tensor(batch.data).pin_memory().to("cuda", non_blocking=True)
    torch.cuda.synchronize()
    log({"batch_mib": batch.data.nbytes / 2 ** 20,
         "pin_and_copy_ms": (time.perf_counter() - t1) * 1e3})

    model = build_resnet50(True, "cuda", seed=7)
    k5, k5_mma, k6, k6_mma = conv_bn_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in (k5, k5_mma, k6, k6_mma):
        c.reset()
    history = train_resnet(model, batch, RESNET_STEPS)
    launches = {"matmul_bn": k5.value, "matmul_bn_mma": k5_mma.value,
                "conv3x3_bn": k6.value, "conv3x3_bn_mma": k6_mma.value}
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = [h["loss"] for h in history]
    # the last iteration's interval is cut short: its loss is fetched right
    # after the one before it
    step_s = float(np.median([h["seconds"] for h in history[5:-1]]))
    log({"train": "resnet50", "batch": RESNET_BATCH, "precision": "bf16",
         "optim": f"SGD lr={RESNET_LR} momentum={RESNET_MOMENTUM}",
         "fused": True, "losses": losses})
    fused = {"step_ms_median": step_s * 1e3,
             "images_per_s": RESNET_BATCH / step_s,
             "peak_allocated_mib": peak_mib}
    check(len(losses) == RESNET_STEPS and all(np.isfinite(losses)),
          f"ResNet-50 losses {losses}")
    check(float(np.mean(losses[-5:])) < losses[0],
          f"ResNet-50 loss did not fall: first {losses[0]}, last five "
          f"{losses[-5:]}")
    want = {"matmul_bn": K5_PER_STEP * RESNET_STEPS,
            "matmul_bn_mma": K5_PER_STEP * RESNET_STEPS,
            "conv3x3_bn": K6_PER_STEP * RESNET_STEPS,
            "conv3x3_bn_mma": K6_PER_STEP * RESNET_STEPS}
    check(launches == want, f"training launched {launches}, want {want}")
    for name, buf in model.named_buffers():
        start = 0.0 if name.endswith("running_mean") else 1.0
        check(torch.isfinite(buf).all().item()
              and (buf - start).abs().max().item() > 0,
              f"running statistic {name} is not finite or did not move")

    # the trained fused model in eval mode (BN folded, no kernel) against
    # the unfused model carrying the same weights and buffers, within
    # EVAL_RTOL of max(1, max|log-prob|): f32 convs of folded or unfolded
    # weights (an H100 run measured 4.3e-5 at max|log-prob| 17.3)
    plain = build_resnet50(False, "cuda", seed=8)
    transfer_state(model, plain)
    x = torch.as_tensor(batch.data[:8], device="cuda")
    model.eval()
    plain.eval()
    with torch.no_grad():
        got, ref = model(x), plain(x)
    eval_err = (got - ref).abs().max().item()
    check(got.shape == (x.shape[0], 1000) and torch.isfinite(got).all().item()
          and eval_err <= EVAL_RTOL * max(1.0, ref.abs().max().item()),
          f"eval: fused vs unfused log-probs differ by {eval_err}")
    log({"check": "resnet50_eval_fused_vs_unfused_f32",
         "max_abs_err": eval_err, "max_abs_ref": ref.abs().max().item()})
    model.train()
    plain.train()
    fused.update(profile_steps(model, batch, "resnet50 fused steps"))
    log({"surface": {"resnet50": timed_within("3c", "3s", surface_resnet,
                                              model, batch)}})
    del model
    torch.cuda.empty_cache()

    # the A/B: the reference's default path (cuDNN convs + batch_norm_train)
    torch.cuda.reset_peak_memory_stats()
    k5.reset()
    k6.reset()
    hist = train_resnet(plain, batch, AB_STEPS + 4)
    check((k5.value, k6.value) == (0, 0), "the unfused path launched K5/K6")
    step_u = float(np.median([h["seconds"] for h in hist[3:-1]]))
    unfused = {"step_ms_median": step_u * 1e3,
               "images_per_s": RESNET_BATCH / step_u,
               "peak_allocated_mib": torch.cuda.max_memory_allocated()
               / 2 ** 20,
               "losses": [h["loss"] for h in hist]}
    unfused.update(profile_steps(plain, batch, "resnet50 unfused steps"))
    # a plain conv's NHWC input is a channels-last view and its output
    # comes back NHWC-contiguous: no copy around cuDNN
    conv = next(m for m in plain.modules()
                if isinstance(m, SpatialConvolution) and m.kernel_h == 3)
    xin = torch.randn(32, 56, 56, conv.n_input_plane, device="cuda")
    with torch.no_grad():
        out = conv(xin)
    layout = {"input_view_channels_last": xin.permute(0, 3, 1, 2)
              .is_contiguous(memory_format=torch.channels_last),
              "output_nhwc_contiguous": out.is_contiguous()}
    log({"ab": "resnet50_train_bf16_B256", "fused_k5_k6": fused,
         "unfused_cudnn": unfused, "plain_conv_layout": layout})
    del plain
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------ 3s. the module surface
SURFACE_SEED = 24
#: the masked bf16 core against K1's unmasked causal output: both round
#: to bf16 after f32 sums in other orders
SURFACE_MASK_TOL = 2e-2
RESNET_EVAL_BATCHES = 4
#: phase 3s's launches by counter (the surface's own calls), added to the
#: kernel rows' counts
SURFACE_LAUNCHES = collections.Counter()


def timed_within(outer: str, phase: str, fn, *args):
    """``fn(*args)`` run inside ``outer``'s ``timed``: its seconds move from
    PHASE_S[outer] to PHASE_S[phase]."""
    t = time.perf_counter()
    try:
        return fn(*args)
    finally:
        dt = time.perf_counter() - t
        PHASE_S[phase] += dt
        PHASE_S[outer] -= dt


def quiet_outputs():
    """Output recording off (``nn.module.record_outputs``); a package
    without it (an earlier commit's, ``--time-kernels-of``) records
    nothing anyway."""
    from bigdl_tpu_torch.nn import module
    rec = getattr(module, "record_outputs", None)
    return rec(False) if rec is not None else contextlib.nullcontext()


def _flash_counts() -> tuple:
    from bigdl_tpu_torch.ops import flash_attention as fa
    return tuple(c.value for c in (
        fa.LAUNCHES, fa.LAUNCHES_MMA, fa.LAUNCHES_TF32, fa.LAUNCHES_DQ,
        fa.LAUNCHES_DQ_MMA, fa.LAUNCHES_DKV, fa.LAUNCHES_DKV_MMA))


_FLASH_KEYS = ("flash_fwd", "flash_fwd_mma", "flash_fwd_tf32", "flash_bwd_dq",
               "flash_bwd_dq_mma", "flash_bwd_dkv", "flash_bwd_dkv_mma")


def _count_flash(fn):
    """``fn()`` and K1-K3's launches in it, by ``_FLASH_KEYS``."""
    before = _flash_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(zip(_FLASH_KEYS, (b - a for a, b in zip(
        before, _flash_counts()))))


def _sorted_concat(tree) -> torch.Tensor:
    """JAX's ravel order, written out apart from the package's: keys
    sorted as strings at every level."""
    parts = []

    def walk(node):
        for key in sorted(node):
            v = node[key]
            if isinstance(v, dict):
                walk(v)
            else:
                parts.append(v.detach().reshape(-1).float())
    walk(tree)
    return torch.cat(parts)


def _dropout_states(model) -> list:
    from bigdl_tpu_torch.nn.regularization import Dropout
    return [(m, m._generator.get_state()) for m in model.modules()
            if isinstance(m, Dropout) and m._generator is not None]


def _no_outputs(model) -> bool:
    return all(getattr(m, "output", None) is None for m in model.modules())


def surface_lm(model, samples) -> dict:
    """Phase 3s (a) on 3b's trained 134m LM; (c) at its widths."""
    from bigdl_tpu_torch.dataset.base import DataSet, SampleToBatch
    from bigdl_tpu_torch.nn.attention import TransformerEncoder
    from bigdl_tpu_torch.nn.module import record_outputs
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(SURFACE_SEED)
    enc = next(m for m in model.modules() if isinstance(m, TransformerEncoder))
    shape = (TRAIN_BATCH, TRAIN_SEQ, CONFIG["embed_dim"])
    x = torch.randn(shape, generator=gen, device="cuda")
    g = torch.randn(shape, generator=gen, device="cuda")
    grads = [(p, None if p.grad is None else (p.grad.data_ptr(),
                                               p.grad.clone()))
             for p in model.parameters()]
    drops = _dropout_states(model)
    with record_outputs(True):
        t0 = time.perf_counter()
        got, n = _count_flash(lambda: enc.backward(x, g))
        out["backward_ms"] = (time.perf_counter() - t0) * 1e3
    for m, state in drops:
        m._generator.set_state(state)
    leaf = x.clone().requires_grad_()
    with quiet_outputs():
        (want,) = torch.autograd.grad(enc(leaf), leaf, g)
    check(torch.equal(got, want) and enc.grad_input is got,
          "encoder.backward differs from autograd of a plain forward: "
          f"max {(got - want).abs().max().item()}")
    check([n[k] for k in ("flash_fwd", "flash_fwd_tf32", "flash_bwd_dq",
                          "flash_bwd_dkv")] == [CONFIG["num_layers"]] * 4,
          f"encoder.backward launched K1/K2/K3 {n}, want 12 each, K1 "
          "tf32x3")
    check(all(e is None if p.grad is None else
              (p.grad.data_ptr() == e[0] and torch.equal(p.grad, e[1]))
              for p, e in grads),
          "backward moved or changed a parameter's .grad")
    SURFACE_LAUNCHES.update(n)
    out["backward_launches"] = n
    del got, want, leaf, grads

    ids = torch.randint(1, VOCAB + 1, (TRAIN_BATCH, TRAIN_SEQ),
                        generator=gen, device="cuda")
    with record_outputs(True):
        pred, n = _count_flash(lambda: model.predict(ids))
        check(model.training and _no_outputs(model),
              "predict left the mode or an output behind")
    model.eval()
    with torch.no_grad(), quiet_outputs():
        plain = model(ids)
    model.train()
    check(torch.equal(pred, plain), "predict differs from the eval forward")
    check(n["flash_fwd"] == n["flash_fwd_tf32"] == CONFIG["num_layers"],
          f"predict launched K1 {n['flash_fwd']} times, "
          f"{n['flash_fwd_tf32']} tf32x3, want 12")
    check(torch.equal(model.predict_class(ids), plain.argmax(-1) + 1),
          "predict_class is not argmax + 1")
    SURFACE_LAUNCHES.update({k: n[k] for k in ("flash_fwd", "flash_fwd_mma",
                                               "flash_fwd_tf32")})
    out["predict_k1"] = n["flash_fwd"]
    del pred, plain

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    flat, unravel = model.get_parameters()
    torch.cuda.synchronize()
    out["get_parameters_ms"] = (time.perf_counter() - t0) * 1e3
    out["get_parameters_added_peak_mib"] = (
        torch.cuda.max_memory_allocated() - base) / 2 ** 20
    out["n_parameters"] = model.n_parameters()
    check(flat.numel() == out["n_parameters"] == LM_134M_PARAMS,
          f"get_parameters gave {flat.numel()} elements, n_parameters "
          f"{out['n_parameters']}, want {LM_134M_PARAMS}")
    check(torch.equal(flat, _sorted_concat(model.parameter_tree())),
          "the flat vector is not the sorted-key concatenation")
    check(torch.equal(_sorted_concat(unravel(flat)), flat),
          "unravel(flat) does not give the parameters back")
    total = int(model.summary().splitlines()[-1].split(":")[1]
                .replace(",", ""))
    check(total == out["n_parameters"], f"summary's total {total}")

    clone = model.clone_module()
    check(not {p.data_ptr() for p in clone.parameters()}
          & {p.data_ptr() for p in model.parameters()},
          "the clone shares a parameter's storage")
    clone.eval()
    model.eval()
    with torch.no_grad(), quiet_outputs():
        check(torch.equal(clone(ids), model(ids)),
              "the clone's forward differs")
    model.train()
    clone.train()
    one = DataSet.array(samples[:TRAIN_BATCH], seed=2) \
        >> SampleToBatch(TRAIN_BATCH)
    with record_outputs(True):
        _train(clone, one, 1)
        check(_no_outputs(clone), "the Optimizer's step recorded an output")
    check(torch.equal(model.get_parameters()[0], flat),
          "a step on the clone changed the original")
    check(not torch.equal(clone.get_parameters()[0], flat),
          "the step on the clone moved nothing")
    del clone, flat, unravel
    torch.cuda.empty_cache()
    out["mask"] = surface_mask()
    return out


#: the 134m recipe's parameters (PERF.md, the tied table once)
LM_134M_PARAMS = 128_404_224


def surface_mask() -> dict:
    """Phase 3s (c): a static causal mask through ``set_mask`` on one
    bf16 ``MultiHeadAttention`` at the 134m's widths."""
    from bigdl_tpu_torch.nn.attention import MultiHeadAttention
    from bigdl_tpu_torch.nn.module import record_outputs
    torch.manual_seed(SURFACE_SEED)
    mha = MultiHeadAttention(CONFIG["embed_dim"], CONFIG["num_heads"],
                             with_bias=False, causal=True, rope=True,
                             num_kv_heads=CONFIG["num_kv_heads"]).to(
        "cuda", torch.bfloat16).eval()
    gen = torch.Generator(device="cuda").manual_seed(SURFACE_SEED + 1)
    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, CONFIG["embed_dim"]),
                    generator=gen, device="cuda").to(torch.bfloat16)
    with torch.no_grad(), record_outputs(False):
        ref, n_ref = _count_flash(lambda: mha(x))
        mask = torch.ones((TRAIN_SEQ, TRAIN_SEQ), dtype=torch.bool,
                          device="cuda").tril()
        check(mha.set_mask(mask) is mha, "set_mask does not return the module")
        got, n = _count_flash(lambda: mha(x))
    check(n_ref["flash_fwd_mma"] == 1, f"the unmasked forward ran {n_ref}")
    check(n["flash_fwd"] == 0, "a masked attention launched K1")
    err = (got.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    check(torch.isfinite(got).all().item() and err <= SURFACE_MASK_TOL * scale,
          f"masked attention differs from K1's causal output by {err}")
    return {"max_abs_err": err, "max_abs_ref": scale, "k1_masked": 0}


def surface_resnet(model, batch) -> dict:
    """Phase 3s (b) on 3c's trained ResNet-50 (both gates)."""
    from bigdl_tpu_torch.dataset.base import DataSet, MiniBatch
    from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
    from bigdl_tpu_torch.nn.module import record_outputs
    from bigdl_tpu_torch.optim import (Evaluator, Loss, Top1Accuracy,
                                       Top5Accuracy)
    from bigdl_tpu_torch.ops import conv3x3_bn
    out = {}
    k5, _, k6, _ = conv_bn_counters()
    k6_tf32 = conv3x3_bn.LAUNCHES_TF32
    deterministic = (torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        model.train()
        x = torch.as_tensor(batch.data, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(SURFACE_SEED)
        g = torch.randn((x.shape[0], 1000), generator=gen, device="cuda")
        stats = {n: b.clone() for n, b in model.named_buffers()}
        before = (k5.value, k6.value, k6_tf32.value)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_outputs(True):
            got = model.backward(x, g)
        torch.cuda.synchronize()
        out["backward_ms"] = (time.perf_counter() - t0) * 1e3
        n = (k5.value - before[0], k6.value - before[1],
             k6_tf32.value - before[2])
        check(n == (K5_PER_STEP, K6_PER_STEP, K6_PER_STEP),
              f"ResNet-50 backward launched K5/K6/K6 tf32x3 {n}, want "
              f"{(K5_PER_STEP, K6_PER_STEP, K6_PER_STEP)}")
        check(all(torch.equal(b, stats[k]) for k, b in
                  model.named_buffers()),
              "backward changed a running statistic")
        check(_no_outputs(model), "backward left an output behind")
        leaf = x.clone().requires_grad_()
        with quiet_outputs():
            (want,) = torch.autograd.grad(model(leaf), leaf, g)
        with torch.no_grad():
            for k, b in model.named_buffers():
                b.copy_(stats[k])
        check(torch.equal(got, want),
              "ResNet-50 backward differs from autograd of its forward: "
              f"max {(got - want).abs().max().item()}")
        SURFACE_LAUNCHES.update({"matmul_bn": n[0], "conv3x3_bn": n[1],
                                 "conv3x3_bn_tf32": n[2]})
        out["backward_k5_k6_k6_tf32x3"] = list(n)
        del got, want, leaf, g, stats
        torch.cuda.empty_cache()

        rng = np.random.default_rng(SURFACE_SEED)
        batches = [MiniBatch(rng.standard_normal(
            batch.data.shape, dtype=np.float32),
            (rng.integers(0, 1000, batch.data.shape[0]) + 1)
            .astype(np.float32)) for _ in range(RESNET_EVAL_BATCHES)]
        methods = lambda: [Top1Accuracy(), Top5Accuracy(),  # noqa: E731
                           Loss(ClassNLLCriterion())]
        t0 = time.perf_counter()
        with record_outputs(True):
            res = model.evaluate(DataSet.array(batches), methods())
            check(_no_outputs(model), "evaluate left an output behind")
        out["evaluate_s"] = time.perf_counter() - t0
        ref = Evaluator(model, device="cuda").test(DataSet.array(batches),
                                                   methods())
        got_r = [r.result() for r, _ in res]
        check(got_r == [r.result() for r, _ in ref],
              f"evaluate {got_r} differs from Evaluator's")
        out["evaluate"] = {m.name: r.result() for r, m in res}

        model.eval()
        xe = x[:32]
        with torch.no_grad(), quiet_outputs():
            y0 = model(xe)
            fresh = build_resnet50(True, "cuda", seed=SURFACE_SEED)
            fresh.load_parameter_tree(_host_tree(model.parameter_tree()))
            fresh.load_buffer_tree(_host_tree(model.buffer_tree()))
            fresh.eval()
            y1 = fresh(xe)
        check(torch.equal(y0, y1), "the numpy trees gave another forward")
        model.train()
        del fresh, x, xe
        torch.cuda.empty_cache()
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = deterministic
    return out


def _host_tree(tree):
    return {k: _host_tree(v) if isinstance(v, dict)
            else v.detach().cpu().numpy() for k, v in tree.items()}


def run_surface_only(card: dict, t0: float) -> None:
    """``--surface-only``: phase 3s on a 134m LM and a fused ResNet-50,
    each trained first as phases 3b and 3c train theirs."""
    from bigdl_tpu_torch.apps.transformer import synthetic_corpus
    from bigdl_tpu_torch.dataset.base import DataSet, SampleToBatch
    from bigdl_tpu_torch.models.transformer import build_lm
    model = build_lm(VOCAB, **CONFIG, device="cuda", seed=7)
    samples = synthetic_corpus(TRAIN_BATCH * TRAIN_STEPS, TRAIN_SEQ, VOCAB,
                               seed=17)
    _train(model, DataSet.array(samples, seed=0)
           >> SampleToBatch(TRAIN_BATCH), TRAIN_STEPS)
    lm = timed("3s", surface_lm, model, samples)
    del model
    torch.cuda.empty_cache()
    batch = imagenet_batch(RESNET_BATCH, 5)
    resnet = build_resnet50(True, "cuda", seed=7)
    train_resnet(resnet, batch, RESNET_STEPS)
    rn = timed("3s", surface_resnet, resnet, batch)
    log({"surface": {"lm": lm, "resnet50": rn,
                     "launches": dict(SURFACE_LAUNCHES)},
         "total_s": time.perf_counter() - t0, "phase_s": PHASE_S,
         "card": card})


# ------------------------------------------------------- 3i. the conv zoo
ZOO_STEPS, LENET_STEPS = 12, 100
#: bench.py's ladders (``_LADDERS``, bench.py:521-531), largest first;
#: Inception v2 is not in bench.py and takes v1's
ZOO_LADDER = {"vgg16": (128, 32), "inception_v1": (256, 64),
              "inception_v2": (256, 64), "lenet": (256,)}
ZOO_GRAD_BATCH, ZOO_GRAD_SEED = 4, 11
ZOO_LOSS_RTOL = 1e-4
LRN_F32_RTOL = 1e-5
CIFAR_APP_BATCH = 128
INCEPTION_APP_RECORDS, INCEPTION_APP_BATCH = 64, 32
MNIST_DIR = os.path.join("tests", "resources", "mnist")


def vgg_conv_shapes(b: int, hw: int) -> list:
    """(N, H, W, Cin, Cout) of every 3x3 conv of VGG-16, or of VGG-CIFAR
    (the same plan of convs and pools) at ``hw`` = 32, at batch b."""
    from bigdl_tpu_torch.models.vgg import _IMAGENET_CFG
    shapes, n_in = [], 3
    for v in _IMAGENET_CFG[16]:
        if v == "M":
            hw = (hw + 1) // 2
        else:
            shapes.append((b, hw, hw, n_in, v))
            n_in = v
    return shapes


def inception_v2_fused_shapes(b: int) -> tuple:
    """Every fused pair of Inception v2 with both gates set, at batch b, in
    model order: 1x1 as (M, K, N) after the subsample, stride-1 3x3 as (N,
    H, W, Cin, Cout), read by hooks from an eval forward of one 224x224
    image on the CPU."""
    from bigdl_tpu_torch.models import inception
    from bigdl_tpu_torch.nn.fused import FusedConv1x1BN, FusedConv3x3BN
    model = _with_gates(FUSION_GATES, lambda: inception.build_v2(
        1000, device="cpu").eval())
    ones, threes = [], []

    def hook(m, args):
        _, h, w, c = args[0].shape
        if isinstance(m, FusedConv1x1BN):
            s = m.stride
            ones.append((b * ((h + s - 1) // s) * ((w + s - 1) // s), c,
                         m.n_output_plane))
        else:
            threes.append((b, h, w, c, m.n_output_plane))
    for m in model.modules():
        if isinstance(m, (FusedConv1x1BN, FusedConv3x3BN)):
            m.register_forward_pre_hook(hook)
    with torch.no_grad():
        model(torch.zeros(1, 224, 224, 3))
    return ones, threes


def check_zoo_kernels() -> dict:
    """K5 and K6 against their plain versions at every fused shape of phase
    3i's runs, with phase 2's tolerances: K6 at each of VGG-16's 13 convs
    at B=128 (224x224 down to 14x14) in f32, as run (a) feeds them (its
    first fused module sees the f32 images, and a fused module's output
    keeps its input's dtype, as in the reference: the ``tf32x3`` variant,
    but conv1_1's Cin = 3: ``fma``), and in bf16 (``mma``, conv1_1
    ``fma``); at each of
    VGG-CIFAR's at B=128 in f32 (``apps.vgg``) and bf16, down to 2x2
    images, where a 128-row tile spans 32 images; and at each of Inception
    v2's 27 stride-1 3x3 pairs at B=256 in bf16 (its stem casts to bf16);
    K5 at each of its 37 fused 1x1 pairs at B=256 in bf16. Distinct shapes
    once each. Returns the shape lists."""
    from bigdl_tpu_torch.ops import conv3x3_bn, matmul_bn
    from bigdl_tpu_torch.ops.conv3x3_bn import (conv3x3_with_stats,
                                                conv3x3_with_stats_plain)
    from bigdl_tpu_torch.ops.matmul_bn import (matmul_with_stats,
                                               matmul_with_stats_plain)
    gen = torch.Generator(device="cuda").manual_seed(13)
    f32, bf16 = torch.float32, torch.bfloat16
    vgg16 = vgg_conv_shapes(ZOO_LADDER["vgg16"][0], 224)
    cifar = vgg_conv_shapes(CIFAR_APP_BATCH, 32)
    v2_ones, v2_threes = inception_v2_fused_shapes(
        ZOO_LADDER["inception_v2"][0])
    k6_cases = ([(s, dt) for s in dict.fromkeys(vgg16) for dt in (f32, bf16)]
                + [(s, dt) for s in dict.fromkeys(cifar) for dt in (bf16, f32)]
                + [(s, bf16) for s in dict.fromkeys(v2_threes)])
    worst, variants = {}, collections.Counter()
    t0 = time.perf_counter()
    for (n, h, w, cin, cout), dt in k6_cases:
        x = torch.randn((n, h, w, cin), generator=gen, device="cuda").to(dt)
        wt = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda")
              / (9 * cin) ** 0.5).to(dt)
        variants["K6 " + _stats_case(
            f"K6 N={n} {h}x{w} {cin}->{cout}", conv3x3_with_stats,
            conv3x3_with_stats_plain, x, wt, conv3x3_bn, worst)] += 1
        del x, wt
        torch.cuda.empty_cache()
    for m, k, nn_ in dict.fromkeys(v2_ones):
        x = torch.randn((m, k), generator=gen, device="cuda").to(bf16)
        wt = (torch.randn((k, nn_), generator=gen, device="cuda")
              / k ** 0.5).to(bf16)
        variants["K5 " + _stats_case(
            f"K5 M={m} K={k} N={nn_}", matmul_with_stats,
            matmul_with_stats_plain, x, wt, matmul_bn, worst)] += 1
    check(worst.get("K5", 0.0) <= CONV_BF16_ATOL / 2,
          f"K5 bf16 excess over one step {worst.get('K5')}")
    log({"check": "zoo_conv_bn_kernels", "k6_cases": len(k6_cases),
         "k5_cases": len(dict.fromkeys(v2_ones)),
         "vgg16_convs": len(vgg16), "inception_v2_fused_1x1_3x3":
         [len(v2_ones), len(v2_threes)], "variants": dict(variants),
         "f32_max_err_over_max_ref": worst.get("f32", 0.0),
         "k5_bf16_max_excess_over_one_step": worst.get("K5", 0.0),
         "k6_bf16_max_excess_over_one_step": worst.get("K6", 0.0),
         "stats_max_err_over_scale": worst.get("stats", 0.0),
         "seconds": time.perf_counter() - t0})
    return {"vgg16": vgg16, "cifar": cifar, "v2_ones": v2_ones,
            "v2_threes": v2_threes}


def check_zoo_autograd():
    """``conv3x3_bn_train`` (K6) against autograd through the plain
    composition, as phase 2's ``check_conv_bn_autograd`` in f32, at one
    small shape of each geometry phase 3i adds: Cin = 3 (VGG's conv1_1),
    2x2 images (VGG-CIFAR's last stage) and 224 wide (VGG-16's first
    block); and ``conv1x1_bn_train`` (K5) at an Inception v2 shape."""
    from bigdl_tpu_torch.ops.conv3x3_bn import _conv3x3, conv3x3_bn_train
    from bigdl_tpu_torch.ops.conv_bn import conv1x1_bn_train
    gen = torch.Generator(device="cuda").manual_seed(14)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    cases = {
        "cin3_4x32x32_3to64": (conv3x3_bn_train, _conv3x3, rnd(4, 32, 32, 3),
                               rnd(3, 3, 3, 64) / 5),
        "2x2_32x2x2_64to64": (conv3x3_bn_train, _conv3x3, rnd(32, 2, 2, 64),
                              rnd(3, 3, 64, 64) / 24),
        "224_1x224x224_16to16": (conv3x3_bn_train, _conv3x3,
                                 rnd(1, 224, 224, 16), rnd(3, 3, 16, 16) / 12),
        "1x1_8x28x28_192to64": (conv1x1_bn_train, lambda x, w: x @ w,
                                rnd(8 * 28 * 28, 192), rnd(192, 64) / 14)}
    _autograd_cases(cases, rnd, "zoo_conv_bn_autograd_f32")


def check_lrn():
    """``SpatialCrossMapLRN`` (Inception v1's and AlexNet's, size 5) on the
    card against the CPU on the same input (a stage-2 activation, 8 x 56 x
    56 x 192): f32 within LRN_F32_RTOL of max|ref| (the two devices' pow
    differ in the last bits), bf16 within two bf16 steps of each element
    (2^-6 |ref|, the bound the CPU tests hold the port to against the
    reference)."""
    from bigdl_tpu_torch.nn.normalization import SpatialCrossMapLRN
    lrn = SpatialCrossMapLRN(5, 0.0001, 0.75)
    gen = torch.Generator().manual_seed(15)
    x = torch.randn((8, 56, 56, 192), generator=gen) * 20
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        got = lrn(xd.to("cuda")).float().cpu()
        ref = lrn(xd).float()
        if dt == torch.float32:
            err = ((got - ref).abs().max() / ref.abs().max()).item()
            check(err <= LRN_F32_RTOL, f"LRN f32 on the card: {err}")
        else:
            err = ((got - ref).abs() / ref.abs().clamp_min(1e-30)).max().item()
            check(bool(((got - ref).abs() <= 2 ** -6 * ref.abs()).all()),
                  f"LRN bf16 on the card: {err} of |ref|")
        out[str(dt)[6:]] = err
    log({"check": "lrn_card_vs_cpu", **out})


def vgg_cifar_grad_check(seed: int = ZOO_GRAD_SEED) -> dict:
    """VGG-CIFAR, one f32 batch of ZOO_GRAD_BATCH images, dropout 0, three
    models with the same weights: unfused on the card (cuDNN convs,
    ``batch_norm_train``), fused on the card with the 3x3 gate (K6 in f32:
    ``tf32x3``, ``fma`` for the first conv's Cin = 3), and unfused on the CPU in f64, the reference
    each is measured against (phase 3c's plan). The f32 losses agree with
    the f64 one within ZOO_LOSS_RTOL. By phase 3c's rule, every gradient
    and running statistic of the fused model lies within twice the
    unfused card model's distance from f64 (or GRAD_RTOL), tensor by
    tensor, and is finite. A fused conv's pre-BN bias has no gradient
    (the f64 one is 0)."""
    from bigdl_tpu_torch.models import vgg
    from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
    from bigdl_tpu_torch.nn.regularization import Dropout
    from bigdl_tpu_torch.ops import conv3x3_bn
    plain_card, truth = _with_gates((), lambda: (
        vgg.build(10, device="cuda", seed=seed),
        vgg.build(10, device="cpu", seed=seed + 1)))
    fused = _with_gates(FUSION_GATES[1:], lambda: vgg.build(
        10, device="cuda", seed=seed + 2))
    for m in (truth, fused):
        transfer_state(plain_card, m)
    truth.double()
    for model in (plain_card, fused, truth):
        for m in model.modules():
            if isinstance(m, Dropout):
                m.set_p(0.0)
    rng = np.random.default_rng(seed + 3)
    x = rng.normal(0, 1, (ZOO_GRAD_BATCH, 32, 32, 3)).astype(np.float32)
    y = rng.integers(1, 11, (ZOO_GRAD_BATCH,)).astype(np.float32)
    losses, states = [], []
    for m in (fused, plain_card, truth):
        p = next(m.parameters())
        m.train()
        conv3x3_bn.LAUNCHES.reset()
        loss = ClassNLLCriterion()(
            m(torch.as_tensor(x, device=p.device).to(p.dtype)),
            torch.as_tensor(y, device=p.device))
        loss.backward()
        losses.append(loss.item())
        states.append(_unit_state(m))
        check(conv3x3_bn.LAUNCHES.value == (13 if m is fused else 0),
              f"VGG-CIFAR gradient run launched K6 "
              f"{conv3x3_bn.LAUNCHES.value} times")
    for got in losses[:2]:
        check(abs(got - losses[2]) <= ZOO_LOSS_RTOL * abs(losses[2]),
              f"VGG-CIFAR losses {losses} (fused card, unfused card, f64)")
    fused_s, lib_s, ref_s = states
    scale = 1e-3 * max(t.double().norm().item() for n, t in ref_s.items()
                       if "running_" not in n)
    d_f, d_u, over = [], [], []
    for name, want in ref_s.items():
        got = fused_s[name]
        if got is None:   # a fused conv's pre-BN bias: exact gradient 0
            check(want.abs().max().item() <= 1e-6 * scale,
                  f"{name}: the f64 gradient of a pre-BN bias is not 0")
            continue
        check(torch.isfinite(got).all().item(),
              f"{name} of the fused card model is not finite")
        den = max(want.double().norm().item(), scale)
        a = (got.detach().cpu().double() - want.detach().double()).norm() \
            .item() / den
        b = (lib_s[name].detach().cpu().double() - want.detach().double()) \
            .norm().item() / den
        d_f.append(a)
        d_u.append(b)
        if a > max(GRAD_RTOL, GRAD_TRUTH_FACTOR * b):
            over.append((name, a, b))
    med_f, med_u = float(np.median(d_f)), float(np.median(d_u))
    readings = {"check": f"grad_vgg_cifar_f32_B{ZOO_GRAD_BATCH}_vs_f64",
                "seed": seed, "tensors": len(d_f),
                "losses_fused_card_unfused_card_f64": losses,
                "fused_card_rel_l2_median": med_f,
                "unfused_card_rel_l2_median": med_u,
                "fused_card_rel_l2_max": max(d_f),
                "unfused_card_rel_l2_max": max(d_u),
                "tensors_over_2x_unfused": len(over),
                "over_2x_first": over[:3]}
    log(readings)
    check(not over, f"{len(over)} tensors of the fused VGG-CIFAR card model "
          f"are further than {GRAD_TRUTH_FACTOR}x the unfused card model "
          f"from f64, e.g. (name, fused, unfused): {over[:3]}")
    return readings


def zoo_batch(b: int, hw: int, c: int, classes: int, seed: int = 0):
    """bench.py's constant data (``_build_workload``): N(0, 1) NHWC images
    and uniform 1-based labels, from ``seed``."""
    from bigdl_tpu_torch.dataset.base import MiniBatch
    rng = np.random.default_rng(seed)
    return MiniBatch(rng.normal(0, 1, (b, hw, hw, c)).astype(np.float32),
                     rng.integers(1, classes + 1, (b,)).astype(np.float32))


def zoo_f32_loss(model, batch) -> float:
    """The loss of ``batch`` under ``model``'s f32 master weights, computed
    in f32 in training mode (batch statistics) with every dropout off; the
    running statistics are put back. bf16 resolves a loss near ln(1000)
    only to 2^-5, so a run's bf16 losses cannot show a small fall: this
    reading can."""
    from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
    from bigdl_tpu_torch.nn.regularization import Dropout
    drops = [(m, m.p) for m in model.modules() if isinstance(m, Dropout)]
    buffers = [(b, b.clone()) for b in model.buffers()]
    for m, _ in drops:
        m.set_p(0.0)
    try:
        with torch.no_grad():
            out = model(torch.as_tensor(batch.data, device="cuda"))
            return ClassNLLCriterion()(
                out.float(), torch.as_tensor(batch.labels, device="cuda")
            ).item()
    finally:
        for m, p in drops:
            m.set_p(p)
        for b, kept in buffers:
            b.copy_(kept)


def zoo_run(name: str, build, gates, data, per_step: dict,
            steps: int = ZOO_STEPS) -> tuple:
    """One training run of phase 3i: the model built with ``gates`` at the
    first rung of ZOO_LADDER[name] that fits (an out-of-memory rung is
    logged with the peak it reached, then the next is taken), ``steps``
    steps of ``train_resnet`` (bench.py's recipe); finite losses, K5/K6
    launches equal to ``per_step`` x steps (every one ``mma`` unless
    ``per_step`` says otherwise; K6's ``tf32x3`` ones as its "K6_tf32"
    says), f32 master weights that moved, and an
    f32 loss of the batch (``zoo_f32_loss``) lower after the steps than
    before them; then a profiled window of two more steps for the busy
    share. Returns (the row, the launches, the model, the batch, the
    losses)."""
    from bigdl_tpu_torch.nn.fused import FusedConv1x1BN, FusedConv3x3BN
    from bigdl_tpu_torch.ops import conv3x3_bn
    k5, k5_mma, k6, k6_mma = conv_bn_counters()
    k6_tf32 = conv3x3_bn.LAUNCHES_TF32
    for b in ZOO_LADDER[name.split(":")[0]]:
        model = batch = None
        try:
            model = _with_gates(gates, lambda: build(b))
            batch = data(b)
            # kept on the host, out of the run's peak
            start = {n: p.detach().to("cpu", copy=True)
                     for n, p in model.named_parameters()}
            f32_before = zoo_f32_loss(model, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before_mib = torch.cuda.memory_allocated() / 2 ** 20
            for c in (k5, k5_mma, k6, k6_mma, k6_tf32):
                c.reset()
            history = train_resnet(model, batch, steps)
            break
        except torch.cuda.OutOfMemoryError:
            pass
        # out of the handler, its traceback no longer holds the step's
        # tensors
        log({"zoo_out_of_memory": name, "batch": b, "peak_mib":
             torch.cuda.max_memory_allocated() / 2 ** 20})
        model = batch = start = None
        import gc
        gc.collect()
        torch.cuda.empty_cache()
    else:
        raise RuntimeError(f"{name}: no rung of {ZOO_LADDER} fits")
    launches = {"matmul_bn": k5.value, "matmul_bn_mma": k5_mma.value,
                "conv3x3_bn": k6.value, "conv3x3_bn_mma": k6_mma.value,
                "conv3x3_bn_tf32": k6_tf32.value}
    losses = [h["loss"] for h in history]
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"{name}: losses {losses}")
    want = {"matmul_bn": per_step.get("K5", 0) * steps,
            "matmul_bn_mma": per_step.get("K5", 0) * steps,
            "conv3x3_bn": per_step.get("K6", 0) * steps,
            "conv3x3_bn_mma": per_step.get("K6_mma", per_step.get("K6", 0))
            * steps, "conv3x3_bn_tf32": per_step.get("K6_tf32", 0) * steps}
    check(launches == want, f"{name}: launched {launches}, want {want}")
    # a fused conv's pre-BN bias is off the training path: its gradient is
    # 0 and, without weight decay, it stays where it was
    idle = {id(m.bias) for m in model.modules()
            if isinstance(m, (FusedConv1x1BN, FusedConv3x3BN)) and m.with_bias}
    moved = {n: (p.detach().cpu() - start[n]).norm().item()
             for n, p in model.named_parameters() if id(p) not in idle}
    del start
    f32_after = zoo_f32_loss(model, batch)
    warm = min(5, steps // 4)
    step_s = float(np.median([h["seconds"] for h in history[warm:-1]]))
    row = {"batch": b, "gates": list(gates), "steps": steps,
           "step_ms_median": step_s * 1e3, "images_per_s": b / step_s,
           "first_loss": losses[0], "last5_mean_loss":
           float(np.mean(losses[-5:])), "f32_loss_before_after":
           [f32_before, f32_after], "params_moved":
           [sum(d > 0 for d in moved.values()), len(moved)],
           "params_change_l2": float(np.sqrt(sum(d * d for d in
                                                 moved.values()))),
           "launches": launches}
    check(row["params_change_l2"] > 0 and np.isfinite(f32_after)
          and f32_after < f32_before,
          f"{name}: the f32 masters moved by {row['params_change_l2']} "
          f"({row['params_moved']} tensors) and the f32 loss went "
          f"{f32_before} -> {f32_after}")
    # the peak counts all that is allocated: the model and batch (made
    # before the reset) and what earlier phases still hold, logged apart
    # as allocated_before_mib
    row["peak_allocated_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    row["allocated_before_mib"] = before_mib
    rows, wall = profiled(lambda: train_resnet(model, batch, 2), name)
    row["device_busy_share"] = (None if rows is None else
                                sum(t for _, t in rows) / 1e6 / wall)
    log({"zoo_run": name, **row, "losses": losses})
    return row, launches, model, batch, losses


def run_zoo_apps() -> dict:
    """The four apps on the card, as their CLI runs them: ``lenet train``
    on the vendored MNIST with per-epoch validation, then ``python -m
    bigdl_tpu_torch.apps.lenet test --model`` as a subprocess, whose Top-1
    must equal the trained model's; ``vgg train`` with the 3x3 gate on
    synthetic CIFAR at B=128 (K6 13 a step, f32: conv1_1 ``fma``, the
    other 12 ``tf32x3``); ``resnet train
    --depth 20`` on CIFAR binary files the phase writes; ``inception
    train --synthetic-size``. Returns the K5/K6 launches."""
    import tempfile

    from bigdl_tpu_torch.apps import inception as inception_app
    from bigdl_tpu_torch.apps import lenet as lenet_app
    from bigdl_tpu_torch.apps import resnet as resnet_app
    from bigdl_tpu_torch.apps import vgg as vgg_app
    from bigdl_tpu_torch.optim import Evaluator, Top1Accuracy
    root = tempfile.mkdtemp(prefix="bigdl_zoo_")
    res = {}
    from bigdl_tpu_torch.ops import conv3x3_bn
    k5, k5_mma, k6, k6_mma = conv_bn_counters()
    k6_tf32 = conv3x3_bn.LAUNCHES_TF32
    for c in (k5, k5_mma, k6, k6_mma, k6_tf32):
        c.reset()
    try:
        t0 = time.perf_counter()
        ck = os.path.join(root, "lenet")
        trained = lenet_app.train(["--folder", MNIST_DIR, "-b", "8", "-e", "2",
                                   "--checkpoint", ck])
        (top1, _), = Evaluator(trained).test(
            lenet_app._dataset(MNIST_DIR, 8, False, 0), [Top1Accuracy()])
        out = subprocess.run(
            [sys.executable, "-m", "bigdl_tpu_torch.apps.lenet", "test",
             "--model", os.path.join(ck, "model_final"), "--folder",
             MNIST_DIR, "-b", "8"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
        check(out.returncode == 0, f"lenet test: {out.stderr[-2000:]}")
        line = [ln for ln in out.stdout.splitlines()
                if ln.startswith("Top1Accuracy:")]
        check(line == [f"Top1Accuracy: {top1}"],
              f"lenet test printed {line}, the trained model gives {top1}")
        res["lenet"] = {"top1": top1.result(), "records": top1.count,
                        "s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        k6_before, tf32_before = k6.value, k6_tf32.value
        m = _with_gates(("BIGDL_TPU_FUSED_3X3",), lambda: vgg_app.train(
            ["--synthetic-size", str(2 * CIFAR_APP_BATCH), "-b",
             str(CIFAR_APP_BATCH), "-e", "2"]))
        n6 = (k6.value - k6_before, k6_tf32.value - tf32_before)
        res["vgg"] = {"k6_launches": n6[0], "k6_tf32x3_launches": n6[1],
                      "s": time.perf_counter() - t0}
        check(n6 == (13 * 4, 12 * 4), f"apps.vgg launched K6 {n6[0]} times, "
              f"{n6[1]} tf32x3, want 13 x 4 iterations, 12 x 4 tf32x3")
        del m
        t0 = time.perf_counter()
        data = os.path.join(root, "cifar")
        os.makedirs(data)
        rng = np.random.default_rng(16)
        for f in [f"data_batch_{i}.bin" for i in range(1, 6)] + [
                "test_batch.bin"]:
            with open(os.path.join(data, f), "wb") as fh:
                for _ in range(CIFAR_APP_BATCH):
                    fh.write(bytes([int(rng.integers(0, 10))]))
                    fh.write(rng.integers(0, 256, 3072, np.uint8).tobytes())
        m = _with_gates((), lambda: resnet_app.train(
            ["--folder", data, "--depth", "20", "-b", str(CIFAR_APP_BATCH),
             "-e", "1"]))
        res["resnet"] = {"s": time.perf_counter() - t0}
        del m
        t0 = time.perf_counter()
        m = _with_gates((), lambda: inception_app.train(
            ["--synthetic-size", str(INCEPTION_APP_RECORDS), "-b",
             str(INCEPTION_APP_BATCH), "-e", "1"]))
        res["inception"] = {"s": time.perf_counter() - t0}
        del m
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log({"zoo_apps": res})
    return {"matmul_bn": k5.value, "matmul_bn_mma": k5_mma.value,
            "conv3x3_bn": k6.value, "conv3x3_bn_mma": k6_mma.value,
            "conv3x3_bn_tf32": k6_tf32.value}


def run_zoo() -> tuple:
    """Phase 3i: the kernel checks at the new shapes, the card's LRN, the
    VGG-CIFAR gradient check, then runs a-e (bench.py's recipe, 12 steps;
    LeNet 100) and the apps. Returns (the K5/K6 launches of the runs and
    the apps, the shapes checked)."""
    from bigdl_tpu_torch.models import inception, lenet, vgg
    t0 = time.perf_counter()
    shapes = check_zoo_kernels()
    check_zoo_autograd()
    check_lrn()
    vgg_cifar_grad_check()
    log({"zoo_checks_s": time.perf_counter() - t0})
    img = lambda b: zoo_batch(b, 224, 3, 1000)
    runs = [
        ("vgg16", lambda b: vgg.build_imagenet(1000, 16, device="cuda",
                                               seed=21),
         FUSION_GATES[1:], img, {"K6": 13, "K6_mma": 0, "K6_tf32": 12}),
        ("vgg16:unfused", lambda b: vgg.build_imagenet(
            1000, 16, device="cuda", seed=21), (), img, {}),
        ("inception_v1", lambda b: inception.build(1000, device="cuda",
                                                   seed=22),
         (), img, {}),
        ("inception_v2", lambda b: inception.build_v2(1000, device="cuda",
                                                      seed=23),
         FUSION_GATES, img, {"K5": 37, "K6": 27})]
    rows, total = {}, collections.Counter()
    for name, build, gates, data, per_step in runs:
        row, launches, model, batch, _ = zoo_run(name, build, gates, data,
                                                 per_step)
        rows[name] = row
        total.update(launches)
        del model, batch
        torch.cuda.empty_cache()
    # (e) LeNet as a Sequential and as a Graph from one seed: one net, so
    # the two runs' losses are equal bit for bit (deterministic cuDNN)
    lenet_data = lambda b: zoo_batch(b, 28, 1, 10)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        seq_row, _, seq, _, seq_losses = zoo_run(
            "lenet", lambda b: lenet.build(10, device="cuda", seed=24),
            (), lenet_data, {}, LENET_STEPS)
        graph_row, _, graph, _, graph_losses = zoo_run(
            "lenet:graph", lambda b: lenet.graph(10, device="cuda",
                                                 seed=24),
            (), lenet_data, {}, LENET_STEPS)
    finally:
        torch.backends.cudnn.deterministic = det
    check(seq_losses == graph_losses,
          f"LeNet's Graph losses differ from its Sequential's: "
          f"{[(a, b) for a, b in zip(seq_losses, graph_losses) if a != b][:3]}")
    check(seq_losses[-1] < seq_losses[0],
          f"LeNet's loss did not fall: {seq_losses[0]} -> {seq_losses[-1]}")
    rows["lenet"], rows["lenet:graph"] = seq_row, graph_row
    log({"check": "lenet_graph_equals_sequential", "steps": LENET_STEPS,
         "bit_equal": True, "graph_children": list(graph._modules)[:3]})
    total.update(run_zoo_apps())
    log({"zoo": {k: {f: v for f, v in r.items() if f != "launches"}
                 for k, r in rows.items()},
         "zoo_s": time.perf_counter() - t0})
    return dict(total), shapes


def time_zoo_kernels(launches: dict, shapes: dict) -> list:
    """The ``kernels`` line's phase 3i rows: K6 at VGG-16's 224x224 64->64
    (conv1_2) and 14x14 512->512 (block 5) at B=128 in f32, the dtype run
    (a) gives it (the ``tf32x3`` variant; ``bound_ms`` prices the
    operations at the 3xTF32 ceiling, ``bound_f32_fma_ms`` at the f32 FMA
    peak), each with a ``bf16`` reading beside it (the ``mma`` variant
    at the same shape); K5 at Inception v2's largest fused 1x1 (by M*K*N) at
    B=256 in bf16; each as phase 4's ``_time_stats_kernel`` times K5 and
    K6 (``graph_ms``; the bound counts x, w and y in the row's dtype and
    the two f32 sums; the library's product and ``torch.var_mean``).
    ``launches``: the kernel's launches in phase 3i's runs and apps (all
    shapes); the ``work`` text says how many of a run's convs have this
    shape, by the structure; ``launches_tf32x3``: those of the tf32x3
    variant (12 of 13 a step; conv1_1's Cin = 3 takes ``fma``)."""
    from bigdl_tpu_torch.ops.conv3x3_bn import (_conv3x3,
                                                conv3x3_with_stats_kernel,
                                                conv3x3_with_stats_plain)
    from bigdl_tpu_torch.ops.matmul_bn import (matmul_with_stats_kernel,
                                               matmul_with_stats_plain)
    gen = torch.Generator(device="cuda").manual_seed(17)
    f32, bf16 = torch.float32, torch.bfloat16
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    entries = []
    vgg16 = shapes["vgg16"]
    for shape in (vgg16[1], vgg16[-1]):
        b, h, _, c, co = shape
        name = f"conv3x3_bn vgg16 {h}x{h} {c}->{co}"
        readings = {}
        for dt, size, peak in ((f32, 4, TF32X3_OPS_PER_S),
                               (bf16, 2, BF16_OPS_PER_S)):
            x = rnd(b, h, h, c).to(dt)
            w = (rnd(3, 3, c, co) / (3 * c ** 0.5)).to(dt)
            readings[dt] = _time_stats_kernel(
                f"{name} {dt}", conv3x3_with_stats_kernel,
                conv3x3_with_stats_plain, _conv3x3, x, w,
                size * (b * h * h * c + 9 * c * co + b * h * h * co) + 8 * co,
                2 * b * h * h * 9 * c * co, time_plain=dt == f32,
                ops_per_s=peak)
            del x, w
            torch.cuda.empty_cache()
        entries.append({
            "name": name, "route": "cuda",
            "source": "bigdl_tpu_torch/csrc/conv3x3_bn.cu",
            "replaces": "bigdl_tpu/ops/conv3x3_bn.py:68",
            "launches": launches["conv3x3_bn"],
            "launches_tf32x3": launches.get("conv3x3_bn_tf32", 0),
            "variant": "tf32x3", **with_f32_fma_bound(readings[f32]),
            "bf16": {"variant": "mma", **readings[bf16]},
            "work": f"one launch, N={b} {h}x{h} {c}->{co} f32 as run (a) "
                    "feeds it (bf16: the mma variant at this shape); "
                    "convs of this shape a step, by the structure: "
                    f"{vgg16.count(shape)} of VGG-16's 13; "
                    "library_ms: F.conv2d (cuDNN, no TF32) + torch.var_mean "
                    "of y; launches: phase 3i's runs and apps"})
    ones = shapes["v2_ones"]
    m, k, n = max(ones, key=lambda s: s[0] * s[1] * s[2])
    x, w = rnd(m, k).to(bf16), (rnd(k, n) / k ** 0.5).to(bf16)
    row = _time_stats_kernel(
        f"matmul_bn inception_v2 M={m} K={k} N={n}", matmul_with_stats_kernel,
        matmul_with_stats_plain, lambda x, w: x @ w, x, w,
        2 * (m * k + k * n + m * n) + 8 * n, 2 * m * k * n)
    del x, w
    torch.cuda.empty_cache()
    entries.append({
        "name": f"matmul_bn inception_v2 M={m} K={k} N={n}", "route": "cuda",
        "source": "bigdl_tpu_torch/csrc/matmul_bn.cu",
        "replaces": "bigdl_tpu/ops/matmul_bn.py:67",
        "launches": launches["matmul_bn"],
        "variant": "mma", **row,
        "work": f"one launch, M={m} K={k} N={n} bf16 (Inception v2's largest "
                "fused 1x1 at B=256; of this shape a step, by the "
                f"structure: {ones.count((m, k, n))} of its 37); "
                "library_ms: x @ w (cuBLAS) + "
                "torch.var_mean of y; launches: phase 3i's runs and apps"})
    log({"zoo_kernel_timing": [{k: e[k] for k in ("name", "ms", "plain_ms",
                                                   "bound_ms", "library_ms")}
                               for e in entries]})
    return entries


# ------------------------------------------------------------- 3j. perf
#: 9 iterations after 3 warm-ups: 12 in all, whole windows of PERF_K, so
#: that no window of another length (a new graph, captured on its first
#: run) falls in a k = 4 run's steady iterations
PERF_ITERS, PERF_WARMUP = 9, 3
VIT_BATCH, LSTM_BATCH = 256, 32
LM1B_BATCH, LM1B_ITERS = 8, 6
RESNET_PERF_BATCH, RESNET_PERF_ITERS = 256, 6
PERF_K = 4
VIT_GRAD_BATCH = 4
VIT_LAYERS, LM1B_LAYERS = 12, 20
#: (name, B, S, N, D, causal) of K1-K3 on phase 3j's path: ViT-S/16's 196
#: tokens of 6 heads, transformer_1b's 2048 of 16 (its 8 kv heads expanded)
PERF_FLASH_SHAPES = (("vit_s16", VIT_BATCH, 196, 6, 64, False),
                     ("transformer_1b", LM1B_BATCH, 2048, 16, 128, True))


def check_perf_kernels() -> dict:
    """Phase 3j (a): K1, K2 and K3 against their plain versions at
    ViT-S/16's and transformer_1b's shapes in bf16 (the ``mma`` variant,
    checked by the counters): O and LSE as ``check_flash`` holds them;
    dQ, dK and dV as ``check_flash_bwd`` (through the ``FlashAttention``
    Function, with an LSE cotangent, against ``flash_attention_bwd_plain``
    fed the same o, lse and cotangents). Returns each shape's errors."""
    from bigdl_tpu_torch.ops import flash_attention as fa
    errs = {}
    for name, b, s, n, d, causal in PERF_FLASH_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(31)
        q, k, v = _qkv(gen, b, s, s, n, d, torch.bfloat16)
        variant, (o, lse) = launched_variant(
            k1_counters(), lambda: fa.kernel_variant(q),
            lambda: fa.flash_attention_with_lse(q, k, v, causal=causal))
        check(variant == "mma", f"K1 at {name}'s shape took {variant}")
        po, plse = fa.flash_attention_plain(q, k, v, causal=causal)
        err_o, ok_o = flash_o_close(o, po)
        err_l = (lse - plse).abs().max().item()
        check(ok_o and err_l <= FLASH_ATOL,
              f"K1 at {name}'s shape: |dO| {err_o} |dLSE| {err_l}")
        del po, plse
        g_o = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        g_lse = torch.randn((b, n, s), generator=gen, device="cuda")
        variant, (o, lse, *grads) = launched_variant(
            [(fa.LAUNCHES_DQ, fa.LAUNCHES_DQ_MMA),
             (fa.LAUNCHES_DKV, fa.LAUNCHES_DKV_MMA)],
            lambda: fa.bwd_kernel_variant(q),
            lambda: _function_grads(q, k, v, g_o, g_lse, causal))
        check(variant == "mma", f"K2/K3 at {name}'s shape took {variant}")
        plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, g_o, g_lse,
                                             causal, 1.0 / d ** 0.5)
        torch.cuda.synchronize()
        row = {"o": err_o, "lse": err_l}
        for gname, got, ref in zip(("dq", "dk", "dv"), grads, plain):
            err, excess, ok = bwd_close(got, ref)
            check(ok, f"K2/K3 {gname} at {name}'s shape: |err| {err}, "
                  f"excess over one bf16 step {excess}")
            row[gname] = err
            row[f"{gname}_excess_over_one_step"] = excess
        errs[name] = row
        del q, k, v, o, lse, grads, plain, g_o, g_lse
        torch.cuda.empty_cache()
    log({"check": "perf_flash_shapes", "variant": "mma", "errors": errs})
    return errs


def vit_grad_check(seed: int = 41) -> dict:
    """Phase 3j (b): ViT-S/16, one f32 batch of VIT_GRAD_BATCH images,
    through the card model (K1-K3 in f32, 12 launches each: K1's
    ``tf32x3``, K2's and K3's ``fma`` variants), the same model on the card with its attention on the
    plain core (no kernel launched), and an f64 CPU copy, the reference;
    all carry the same weights. Every card gradient is finite and within
    GRAD_RTOL or GRAD_TRUTH_FACTOR times the plain card model's distance
    from the f64 one, per tensor (phase 3c's rule)."""
    from bigdl_tpu_torch.interop.state_dict import (export_tree_state,
                                                    import_tree_state)
    from bigdl_tpu_torch.models import vit
    from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
    from bigdl_tpu_torch.ops import flash_attention as fa
    card = vit.build(1000, device="cuda", seed=seed)
    truth = vit.build(1000, device="cpu", seed=seed + 1)
    import_tree_state(truth, *export_tree_state(card))
    truth.double()
    rng = np.random.default_rng(seed + 2)
    x = rng.standard_normal((VIT_GRAD_BATCH, 224, 224, 3)).astype(np.float32)
    y = rng.integers(1, 1001, (VIT_GRAD_BATCH,)).astype(np.float32)
    counters = flash_counters()

    def grads(model, dev, flash: bool):
        model.zero_grad(set_to_none=True)
        model.train()
        p = next(model.parameters())
        for c in counters.values():
            c.reset()
        use = fa.use_flash
        if not flash:
            fa.use_flash = lambda q, mask: False
        try:
            loss = ClassNLLCriterion()(
                model(torch.as_tensor(x, device=dev).to(p.dtype)),
                torch.as_tensor(y, device=dev))
            loss.backward()
        finally:
            fa.use_flash = use
        if dev == "cuda":
            torch.cuda.synchronize()
        launched = {k: c.value for k, c in counters.items()}
        return (loss.item(), {n: q.grad for n, q in model.named_parameters()},
                launched)

    loss_k, g_k, launched = grads(card, "cuda", True)
    want = {"flash_fwd": VIT_LAYERS, "flash_fwd_mma": 0,
            "flash_fwd_tf32": VIT_LAYERS,
            "flash_bwd_dq": VIT_LAYERS, "flash_bwd_dq_mma": 0,
            "flash_bwd_dkv": VIT_LAYERS, "flash_bwd_dkv_mma": 0}
    check(launched == want, f"ViT's f32 gradient launched {launched}, "
          f"want {want}")
    g_k = {n: g.clone() for n, g in g_k.items()}
    loss_p, g_p, launched = grads(card, "cuda", False)
    check(not any(launched.values()), f"the plain core launched {launched}")
    loss_t, g_t, _ = grads(truth, "cpu", True)
    for got in (loss_k, loss_p):
        check(abs(got - loss_t) <= RESNET_LOSS_RTOL * abs(loss_t),
              f"ViT losses {loss_k} (kernels) {loss_p} (plain) {loss_t} (f64)")
    over, worst, dists = [], {"ratio": 0.0, "name": ""}, []
    for name, want_g in g_t.items():
        got = g_k[name]
        check(got is not None and torch.isfinite(got).all().item(),
              f"ViT {name} on the card is missing or not finite")
        d_k, d_p = _rel_l2(got, want_g), _rel_l2(g_p[name], want_g)
        dists.append((d_k, d_p))
        if d_k > max(GRAD_RTOL, GRAD_TRUTH_FACTOR * d_p):
            over.append((name, d_k, d_p))
        ratio = d_k / max(d_p, GRAD_RTOL)
        if ratio > worst["ratio"]:
            worst.update(ratio=ratio, name=name)
    readings = {"check": f"grad_vit_s16_f32_B{VIT_GRAD_BATCH}_vs_f64",
                "tensors": len(g_t),
                "losses_kernels_plain_f64": [loss_k, loss_p, loss_t],
                "kernels_rel_l2_median": float(np.median(
                    [d for d, _ in dists])),
                "kernels_rel_l2_max": max(d for d, _ in dists),
                "plain_core_rel_l2_median": float(np.median(
                    [d for _, d in dists])),
                "max_ratio_kernels_over_plain": worst["ratio"],
                "worst_ratio_tensor": worst["name"]}
    log(readings)
    check(not over, f"{len(over)} ViT gradients on the card are further than "
          f"{GRAD_TRUTH_FACTOR}x the plain core's from f64: {over[:3]}")
    del card, truth
    torch.cuda.empty_cache()
    return readings


def perf_run(args: list, counters: dict, gates=()) -> tuple:
    """``python -m bigdl_tpu_torch.apps.perf ARGS`` in this process
    (``perf.run``) with the launch ``counters`` zeroed just before it and
    read just after and the peak memory reset before it; the fusion gates
    in ``gates`` set while the model is built. Returns (its JSON line with
    the launches, the mean step ms after the warm-up (consistent with
    ``records_per_sec``: where the host sets the pace the one-late loss
    fetch splits an epoch's last two iterations' time unevenly, so a median
    misleads), the peak MiB and the cache's materialisation seconds; the
    losses; the Optimizer)."""
    import gc
    from bigdl_tpu_torch.apps import perf
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    result, opt = _with_gates(gates, lambda: perf.run(args))
    torch.cuda.synchronize()
    launched = {k: c.value for k, c in counters.items()}
    losses = [h["loss"] for h in opt.history]
    k = int(args[args.index("-k") + 1]) if "-k" in args else 1
    warm = max(PERF_WARMUP, 2 * k)
    row = {**result, "args": " ".join(args), "launches": launched,
           "iteration_ms": [round(h["seconds"] * 1e3, 2)
                            for h in opt.history],
           "step_ms": float(np.mean(
               [h["seconds"] for h in opt.history[warm:]])) * 1e3,
           "peak_allocated_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
           "cache_materialize_s": getattr(opt.dataset, "materialize_seconds",
                                          None)}
    check(all(np.isfinite(losses)), f"perf {row['args']}: losses {losses}")
    return row, losses, opt


def busy_share(opt, extra: int = 2):
    """The device's busy share over ``extra`` more k = 1 iterations of a
    finished perf run's ``Optimizer``, under the profiler."""
    from bigdl_tpu_torch.optim import Trigger
    done = len(opt.history)
    opt.set_steps_per_dispatch(1).set_state({"neval": done + 1})
    opt.set_end_when(Trigger.max_iteration(done + extra))
    rows, wall = profiled(opt.optimize, "perf busy share")
    return None if rows is None else sum(t for _, t in rows) / 1e6 / wall


def _per_step(row, counters, n: int, per: dict) -> None:
    want = {k: per.get(k, 0) * n for k in counters}
    check(row["launches"] == want,
          f"perf {row['args']}: launched {row['launches']}, want {want}")


def lm_block_grad_check(seed: int = 43) -> dict:
    """Phase 3j (e): every parameter gradient of one bf16 step of a 2-layer
    cut of transformer_1b (full width, S=2048, B=2) with ``"block"``
    recomputation equals the one without bit for bit (the recomputed
    forward runs the same kernels on the same inputs); K1 launches 2 times
    without it and 4 with it."""
    from bigdl_tpu_torch.apps.perf import _TRANSFORMER_VOCAB
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.nn.attention import TransformerEncoder
    from bigdl_tpu_torch.nn.criterion import FusedLMHeadCriterion
    from bigdl_tpu_torch.ops.precision import DtypePolicy
    model = build_lm(_TRANSFORMER_VOCAB, 2048, 16, 5632, num_layers=2,
                     max_len=2048, num_kv_heads=8, rope=True,
                     activation="swiglu", norm="rms", tie_embeddings=True,
                     device="cuda", seed=seed)
    enc = next(m for m in model.modules()
               if isinstance(m, TransformerEncoder))
    rng = np.random.default_rng(seed)
    ids = torch.as_tensor(rng.integers(1, _TRANSFORMER_VOCAB + 1, (2, 2048)),
                          dtype=torch.float32, device="cuda")
    params = dict(model.named_parameters())
    counters = flash_counters()
    out = {}
    model.train()
    for block in (False, True):
        enc.remat_blocks = block
        for c in counters.values():
            c.reset()
        for p in params.values():
            p.grad = None
        y = torch.func.functional_call(
            model, DtypePolicy.bf16().cast_params_for_compute(params), (ids,))
        FusedLMHeadCriterion()(y, ids).float().backward()
        torch.cuda.synchronize()
        out[block] = ({n: p.grad.clone() for n, p in params.items()},
                      counters["flash_fwd"].value)
    enc.remat_blocks = False
    (plain, k1_plain), (remat, k1_remat) = out[False], out[True]
    differ = [n for n in plain if not torch.equal(plain[n], remat[n])]
    readings = {"check": "lm_block_remat_grads_bit_equal",
                "tensors": len(plain), "differ": differ[:4],
                "max_rel_l2": max(_rel_l2(remat[n], plain[n]) for n in plain),
                "k1_launches_without_with": [k1_plain, k1_remat]}
    log(readings)
    check(not differ, f"block remat changed {len(differ)} gradients: "
          f"{readings}")
    check((k1_plain, k1_remat) == (2, 4),
          f"K1 launched {k1_plain} / {k1_remat} times, want 2 / 4")
    del model, out, plain, remat
    torch.cuda.empty_cache()
    return readings


def run_perf() -> tuple:
    """Phase 3j: (a) the kernel checks at the new shapes; (b) ViT-S/16's
    card gradients; (c) ``perf --model vit_s16`` at B=256, bf16, 13
    iterations after 3 warm-ups, k = 1 and k = 4 through the device cache
    and k = 1 from the host (K1-K3 12 each a step; k = 4's losses
    bit-equal to k = 1's over the same 1024 records); (d) ``perf --model
    lstm`` at B=32, k = 1 and k = 4 (bit-equal); (e) ``perf --model transformer_1b`` at B=8, S=2048 with
    AdamW, bf16 moments and ``--remat block`` (K1 20 x 2 a step, K2 and K3
    20), its memory statistics, and the block-remat gradient check on a
    2-layer cut; (f) ``perf --model resnet50`` at B=256 with both fusion
    gates, with and without ``--remat conv``: equal losses, K5 36 and K6
    13 a step both ways, a lower peak with the policy. cuDNN is held
    deterministic for the runs. Returns (the flash launches of runs (c)
    and (e), the runs' rows)."""
    t0 = time.perf_counter()
    check_perf_kernels()
    vit_grad_check()
    log({"perf_checks_s": time.perf_counter() - t0})
    flash = flash_counters()
    k5, k5_mma, k6, k6_mma = conv_bn_counters()
    convs = {"matmul_bn": k5, "matmul_bn_mma": k5_mma, "conv3x3_bn": k6,
             "conv3x3_bn_mma": k6_mma}
    iters = PERF_ITERS + PERF_WARMUP
    total, rows, runs = collections.Counter(), {}, {}

    def record(name, row, losses, opt, busy=True):
        if busy:
            row["device_busy_share"] = busy_share(opt)
        rows[name], runs[name] = row, losses
        log({"perf_run": name, **row, "losses": losses})

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # (c) ViT-S/16, the same 1024 records for every run
        vit = ["--model", "vit_s16", "-b", str(VIT_BATCH), "-i",
               str(PERF_ITERS), "--warmup", str(PERF_WARMUP), "--records",
               str(VIT_BATCH * PERF_K)]
        for name, extra in (("vit_s16:k1", []),
                            ("vit_s16:k4", ["-k", str(PERF_K)]),
                            ("vit_s16:host", ["--no-device-cache"])):
            row, losses, opt = perf_run(vit + extra, flash)
            _per_step(row, flash, iters, {k: VIT_LAYERS for k in flash
                                          if k != "flash_fwd_tf32"})
            total.update(row["launches"])
            record(name, row, losses, opt, busy=name != "vit_s16:k4")
            del opt
        check(runs["vit_s16:k4"] == runs["vit_s16:k1"],
              "ViT's k = 4 losses differ from k = 1's: "
              f"{runs['vit_s16:k4'][:3]} vs {runs['vit_s16:k1'][:3]}")
        # (d) the LSTM: T=500 steps of a 128-wide LSTM, no kernel of ours
        lstm = ["--model", "lstm", "-b", str(LSTM_BATCH), "-i",
                str(PERF_ITERS), "--warmup", str(PERF_WARMUP), "--records",
                str(LSTM_BATCH * PERF_K)]
        for name, extra in (("lstm:k1", []),
                            ("lstm:k4", ["-k", str(PERF_K)])):
            row, losses, opt = perf_run(lstm + extra, flash)
            _per_step(row, flash, iters, {})
            record(name, row, losses, opt, busy=name == "lstm:k1")
            del opt
        check(runs["lstm:k4"] == runs["lstm:k1"],
              "the LSTM's k = 4 losses differ from k = 1's: "
              f"{runs['lstm:k4'][:3]} vs {runs['lstm:k1'][:3]}")
        # (e) transformer_1b, the reference's one-chip capacity recipe
        from bigdl_tpu_torch.apps.perf import memory_stats
        row, losses, opt = perf_run(
            ["--model", "transformer_1b", "-b", str(LM1B_BATCH), "-i",
             str(LM1B_ITERS), "--warmup", str(PERF_WARMUP), "--optim",
             "adamw", "--optStateDtype", "bf16", "--remat", "block",
             "--memStats"], flash)
        n = LM1B_LAYERS
        _per_step(row, flash, LM1B_ITERS + PERF_WARMUP,
                  {"flash_fwd": 2 * n, "flash_fwd_mma": 2 * n,
                   "flash_bwd_dq": n, "flash_bwd_dq_mma": n,
                   "flash_bwd_dkv": n, "flash_bwd_dkv_mma": n})
        total.update(row["launches"])
        row.update(memory_stats=memory_stats(torch.device("cuda")),
                   tokens_per_sec=row["records_per_sec"] * 2048,
                   n_params=n_params(opt.model))
        record("transformer_1b", row, losses, opt)
        del opt
        lm_block_grad_check()
        # (f) ResNet-50 with both gates, without and with "conv" remat
        res = ["--model", "resnet50", "-b", str(RESNET_PERF_BATCH), "-i",
               str(RESNET_PERF_ITERS), "--warmup", str(PERF_WARMUP)]
        for name, extra in (("resnet50", []),
                            ("resnet50:remat_conv", ["--remat", "conv"])):
            row, losses, opt = perf_run(res + extra, convs, FUSION_GATES)
            _per_step(row, convs, RESNET_PERF_ITERS + PERF_WARMUP,
                      {"matmul_bn": K5_PER_STEP, "matmul_bn_mma": K5_PER_STEP,
                       "conv3x3_bn": K6_PER_STEP,
                       "conv3x3_bn_mma": K6_PER_STEP})
            record(name, row, losses, opt)
            del opt
    finally:
        torch.backends.cudnn.deterministic = det
    check(runs["resnet50:remat_conv"] == runs["resnet50"],
          "ResNet-50's losses under remat conv differ: "
          f"{runs['resnet50:remat_conv'][:3]} vs {runs['resnet50'][:3]}")
    peaks = [rows[k]["peak_allocated_mib"]
             for k in ("resnet50", "resnet50:remat_conv")]
    check(peaks[1] < peaks[0], f"remat conv did not lower ResNet-50's peak: "
          f"{peaks} MiB (without, with)")
    log({"perf": {k: {f: v for f, v in r.items() if f != "launches"}
                  for k, r in rows.items()},
         "perf_s": time.perf_counter() - t0})
    return dict(total), rows


def flash_rows(name: str, b: int, s: int, n: int, d: int, causal: bool,
               dtype, launches: dict, per_step: str, launched_by: str,
               seed: int = 37) -> list:
    """K1, K2 and K3 at one shape and dtype (bf16: their ``mma`` variants;
    f32: K1's ``tf32x3``, bound at the 3xTF32 ceiling with
    ``bound_f32_fma_ms`` beside it, and K2's and K3's ``fma``), each checked once more against its plain
    version, then
    timed by ``graph_ms`` beside its plain version and
    ``scaled_dot_product_attention`` (forward; for K2 and K3 its backward:
    forward and backward less forward, one call for dQ, dK and dV); the
    bound prices the operations at the dtype's peak. ``launches``: the
    counts of the runs ``launched_by`` names; ``per_step``: how many a
    step the structure gives."""
    from bigdl_tpu_torch.ops.flash_attention import (
        bwd_delta, flash_attention_plain, flash_attention_with_lse,
        flash_bwd_dkv, flash_bwd_dkv_plain, flash_bwd_dq, flash_bwd_dq_plain)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = _qkv(gen, b, s, s, n, d, dtype)
    g_o = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    o, lse = flash_attention_with_lse(q, k, v, causal=causal)
    po, _ = flash_attention_plain(q, k, v, causal=causal)
    err_o, ok = flash_o_close(o, po)
    check(ok, f"K1 at {name}'s timed shape: {err_o}")
    del po
    args = (q, k, v, g_o, lse, bwd_delta(o, g_o, None), causal,
            1.0 / d ** 0.5)
    errs = {}
    for gname, got, ref in (
            ("dq", (flash_bwd_dq(*args),), (flash_bwd_dq_plain(*args),)),
            ("dkv", flash_bwd_dkv(*args), flash_bwd_dkv_plain(*args))):
        errs[gname] = 0.0
        for g1, r1 in zip(got, ref):
            e, _, ok = bwd_close(g1, r1)
            check(ok, f"{gname} at {name}'s timed shape: {e}")
            errs[gname] = max(errs[gname], e)
    what = f"{name} B={b} S={s} N={n} D={d}"
    ms = graph_ms(lambda: flash_attention_with_lse(q, k, v, causal=causal),
                  f"flash_fwd {what}")
    plain_ms = graph_ms(lambda: flash_attention_plain(q, k, v,
                                                      causal=causal),
                        f"flash_fwd plain {what}", per_graph=3, replays=3)
    ms_dq = graph_ms(lambda: flash_bwd_dq(*args), f"flash_bwd_dq {what}")
    ms_dkv = graph_ms(lambda: flash_bwd_dkv(*args), f"flash_bwd_dkv {what}")
    plain_dq = graph_ms(lambda: flash_bwd_dq_plain(*args),
                        f"flash_bwd_dq plain {what}", per_graph=3, replays=3)
    plain_dkv = graph_ms(lambda: flash_bwd_dkv_plain(*args),
                         f"flash_bwd_dkv plain {what}", per_graph=3,
                         replays=3)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    g_t = g_o.transpose(1, 2)
    lib = lambda: sdpa(qt, kt, vt, is_causal=causal)
    fwd_ms = graph_ms(lib, f"sdpa {what}")
    fwd_bwd_ms = graph_ms(
        lambda: torch.autograd.grad(lib(), (qt, kt, vt), g_t),
        f"sdpa forward and backward {what}")
    esize = torch.finfo(dtype).bits // 8
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    pairs = b * n * (s * (s + 1) // 2 if causal else s * s)
    bsnd, bns = b * s * n * d, b * n * s
    reads = 4 * bsnd * esize + 2 * bns * 4        # q, k, v, dO; lse, delta
    dname = "bf16" if dtype == torch.bfloat16 else "f32"
    shape = (f"{'causal' if causal else 'non-causal'} {dname} B={b} S={s} "
             f"N={n} D={d}")
    f32 = dtype == torch.float32
    base = {"route": "cuda",
            "variant": "fma" if f32 else "mma",
            "shape": shape, "sdpa_forward_ms": fwd_ms,
            "sdpa_forward_and_backward_ms": fwd_bwd_ms}
    k1_bound = bound(4 * bsnd * esize + bns * 4, 4 * d * pairs,
                     TF32X3_OPS_PER_S if f32 else peak)
    launches_note = (f"launches: {launched_by} (by the structure, "
                     f"{per_step})")
    rows = [
        {"name": f"flash_fwd {name}", **base,
         "variant": "tf32x3" if f32 else "mma",
         "source": "bigdl_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "bigdl_tpu/ops/flash_attention.py:104",
         "launches": launches.get("flash_fwd", 0),
         "max_abs_err": err_o, "ms": ms, "plain_ms": plain_ms,
         **(with_f32_fma_bound(k1_bound) if f32 else k1_bound),
         "library_ms": fwd_ms,
         "work": f"one forward launch, {shape}; {launches_note}; "
                 "library_ms: scaled_dot_product_attention"},
        {"name": f"flash_bwd_dq {name}", **base,
         "source": "bigdl_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "bigdl_tpu/ops/flash_attention.py:146",
         "launches": launches.get("flash_bwd_dq", 0),
         "max_abs_err": errs["dq"], "ms": ms_dq, "plain_ms": plain_dq,
         **bound(reads + bsnd * esize, 3 * 2 * d * pairs, peak),
         "library_ms": fwd_bwd_ms - fwd_ms,
         "work": f"one backward launch, {shape}; {launches_note}; "
                 "library_ms: the backward of "
                 "scaled_dot_product_attention (forward and backward "
                 "less forward; dQ, dK and dV in one call)"},
        {"name": f"flash_bwd_dkv {name}", **base,
         "source": "bigdl_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "bigdl_tpu/ops/flash_attention.py:186",
         "launches": launches.get("flash_bwd_dkv", 0),
         "max_abs_err": errs["dkv"], "ms": ms_dkv, "plain_ms": plain_dkv,
         **bound(reads + 2 * bsnd * esize, 4 * 2 * d * pairs, peak),
         "library_ms": fwd_bwd_ms - fwd_ms,
         "work": f"one backward launch, {shape}; {launches_note}; "
                 "library_ms as the dQ row's"}]
    del q, k, v, g_o, o, lse, args, qt, kt, vt
    torch.cuda.empty_cache()
    return rows


def time_perf_kernels(launches: dict) -> list:
    """The ``kernels`` line's phase 3j rows: K1, K2 and K3 at ViT-S/16's
    shape (B=256 S=196 N=6 D=64, non-causal) and transformer_1b's (B=8
    S=2048 N=16 D=128, causal), bf16 (``mma``), by ``flash_rows``.
    ``launches``: phase 3j's runs (c) and (e) together."""
    rows = []
    for name, b, s, n, d, causal in PERF_FLASH_SHAPES:
        per_step = ({"vit_s16": f"{VIT_LAYERS} of each a step (12 layers)",
                     "transformer_1b": f"K1 {2 * LM1B_LAYERS} a step (20 "
                     "layers, each recomputed under --remat block), K2 and "
                     f"K3 {LM1B_LAYERS}"})[name]
        rows += flash_rows(name, b, s, n, d, causal, torch.bfloat16,
                           launches, per_step,
                           "phase 3j's vit_s16 and transformer_1b runs "
                           "together")
    log({"perf_kernel_timing": [{k: r[k] for k in ("name", "ms", "plain_ms",
                                                   "bound_ms", "library_ms")}
                                for r in rows]})
    return rows


def time_text_kernels(launches: dict) -> list:
    """The ``kernels`` line's phase 3l rows: K1, K2 and K3 in f32 (K1's
    ``tf32x3``, K2's and K3's ``fma`` variants) at the text LM's training
    shape (causal, B=8 S=512 N=12 D=64), by ``flash_rows``. ``launches``:
    phase 3l's counts, K1's by its tf32x3 counter and K2's and K3's their
    non-mma launches, all ``fma`` (they are in the K1, K2 and K3 rows'
    counts too)."""
    f32 = {"flash_fwd": launches.get("flash_fwd_tf32", 0),
           **{name: launches[name] - launches[f"{name}_mma"]
              for name in ("flash_bwd_dq", "flash_bwd_dkv")}}
    rows = flash_rows("text_f32", TRAIN_BATCH, TRAIN_SEQ,
                      CONFIG["num_heads"], 64, True, torch.float32, f32,
                      "12 of each a training step (12 layers), K1 12 a "
                      "prefill", "phase 3l's text LM training and its "
                      "prefills", seed=41)
    log({"text_kernel_timing": [{k: r[k] for k in ("name", "ms", "plain_ms",
                                                   "bound_ms", "library_ms")}
                                for r in rows]})
    return rows


# ------------------------------------------------------------ 4a. HBM roof
def run_roofline():
    """Phase 4a: the probe's ``main`` at 1 GiB with every family and one
    calibration, its K7 launch counts against the counts its chains
    predict, and every rate within the data sheet's. Returns (the probe's
    result, the launches)."""
    from bigdl_tpu_torch.ops import hbm_roof as hr
    from bigdl_tpu_torch.scripts import roofline_hbm as probe
    torch.cuda.empty_cache()
    for c in hr.COUNTERS.values():
        c.reset()
    t0 = time.perf_counter()
    res = probe.main(["--gib", str(HBM_PROBE_BYTES / 2 ** 30),
                      "--calibration-tries", "1"])
    seconds = time.perf_counter() - t0
    launches = {name: c.value for name, c in hr.COUNTERS.items()}
    p = probe.PASSES_PER_READING
    want = {"hbm_copy": p * len(probe.AUTO_SWEEP),
            "hbm_read": p * len(probe.AUTO_SWEEP),
            "hbm_triad": p * len(probe.AUTO_SWEEP),
            "hbm_staged_copy": p * len(probe.MANUAL_SWEEP),
            "hbm_direct_copy": p * len(probe.DMA_STREAMS)}
    check(launches == want, f"the probe launched {launches}, want {want}")
    rates = [r[k] for fam in ("auto", "manual", "hbm_dma", "eager", "library")
             for r in (res[fam] if isinstance(res[fam], list) else [res[fam]])
             for k in r if k.endswith("_gbps")]
    # no stream can beat the memory's own rate: a reading above it is a
    # fault of the timing
    check(all(r is not None and 0 < r <= 1.01 * HBM_BYTES_PER_S / 1e9
              for r in rates),
          f"the probe read a rate that is not positive or is above the data "
          f"sheet's {HBM_BYTES_PER_S / 1e9} GB/s: {rates}")
    log({"roofline": {"probe_s": seconds, "launches": launches,
                      "roof_gbps": res["roof_gbps"], "roof_from": res["roof_from"],
                      "library_copy_gbps": res["library_copy_gbps"]}})
    torch.cuda.empty_cache()
    return res, launches


LIBRARY_CALLS = {"copy": "Tensor.copy_",
                 "read": "torch.sum(x, dtype=float32), the seed's add left out",
                 "triad": "torch.add(a, b, alpha=2)"}


def hbm_roof_rows(res: dict, launches: dict, errs: dict) -> list:
    """K7's rows of the ``kernels`` line from the probe's run: for each
    kernel the best reading of its sweep as ``ms`` (one pass over 1 GiB),
    the eager chain as ``plain_ms`` and one PyTorch call as
    ``library_ms``."""
    from bigdl_tpu_torch.scripts.roofline_hbm import hbm_dma_shape
    total = res["total_bytes"]
    n = total // 2
    ref = "scripts/roofline_pallas.py"
    best = lambda readings, key: max(readings, key=lambda r: r[f"{key}_gbps"])
    dma = best(res["hbm_dma"], "copy")
    dma_rows, lanes = hbm_dma_shape(total, dma["nstreams"])  # trimmed
    entries = []
    for name, reading, key, replaces, nbytes, ops, how in (
            ("hbm_copy", best(res["auto"], "copy"), "copy", f"{ref}:108",
             2 * n * 2, 0,
             "block (threads x 16-byte vectors) {block}, {grid} grid"),
            ("hbm_read", best(res["auto"], "read"), "read", f"{ref}:108",
             n * 2, n, "block {block}, {grid} grid"),
            ("hbm_triad", best(res["auto"], "triad"), "triad", f"{ref}:108",
             3 * n * 2, 2 * n, "block {block}, {grid} grid"),
            ("hbm_staged_copy", best(res["manual"], "copy"), "copy",
             f"{ref}:205", 2 * n * 2, 0,
             "chunk {block}, nbuf {nbuf}, lag {lag}, {deal} deal, "
             "{blocks_per_sm} blocks an SM"),
            ("hbm_direct_copy", dma, "copy", f"{ref}:243",
             2 * dma_rows * lanes * 2, 0,
             "nstreams {nstreams}, one launch, a full grid a range")):
        entries.append({
            "name": name, "route": "cuda",
            "source": "bigdl_tpu_torch/csrc/hbm_roof.cu", "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": reading[f"{key}_ms"], "plain_ms": res["eager"][f"{key}_ms"],
            **bound(nbytes, ops), "library_ms": res["library"][f"{key}_ms"],
            "gbps": reading[f"{key}_gbps"],
            "work": f"one {key} pass over {total / 2 ** 30:g} GiB of bf16 "
                    f"(n = {n}), the best of the probe's sweep: "
                    + how.format(**reading) + "; plain_ms: eager PyTorch; "
                    "library_ms: " + LIBRARY_CALLS[key]})
    return entries


def time_probe_families() -> dict:
    """The probe of the imported package at 1 GiB with only its
    ``manual`` (K7b), ``hbm_dma`` (K7c) and ``library`` families, one
    calibration: each family's readings and the best K7b and K7c pass
    beside ``copy_``'s, so that ``--time-kernels-of`` puts an earlier
    tree's K7b and K7c on this run's timer."""
    from bigdl_tpu_torch.scripts import roofline_hbm as probe
    res = probe.main(["--gib", str(HBM_PROBE_BYTES / 2 ** 30), "--skip",
                      "auto,eager", "--calibration-tries", "1"])
    best = lambda fam: min(r["copy_ms"] for r in res[fam])
    return {"manual": res["manual"], "hbm_dma": res["hbm_dma"],
            "library": res["library"], "best_manual_copy_ms": best("manual"),
            "best_hbm_dma_copy_ms": best("hbm_dma"),
            "library_copy_ms": res["library"]["copy_ms"]}


# ----------------------------------------------------------------- 4. timing
def _time_flash_shape(b: int, s: int, seed: int, n: int = 0,
                      dtype=torch.bfloat16) -> dict:
    """K1 at one causal shape (N heads, the 134m's 12 by default, D=64;
    bf16 unless ``dtype`` says f32): checked once more against its plain
    version, then its device time, its plain version's and
    ``scaled_dot_product_attention``'s, and its bound (for f32, the
    3xTF32 ceiling's, with ``bound_f32_fma_ms``)."""
    from bigdl_tpu_torch.ops.flash_attention import (flash_attention_plain,
                                                     flash_attention_with_lse)
    n, d = n or CONFIG["num_heads"], 64
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = _qkv(gen, b, s, s, n, d, dtype)
    o, lse = flash_attention_with_lse(q, k, v, causal=True)
    po, plse = flash_attention_plain(q, k, v, causal=True)
    err, ok = flash_o_close(o, po)
    err_l = (lse - plse).abs().max().item()
    check(ok and err_l <= FLASH_ATOL,
          f"flash at the timed shape B={b} S={s}: |dO|={err} |dLSE|={err_l}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kernel = lambda: flash_attention_with_lse(q, k, v, causal=True)
    what = f"flash_fwd B={b} S={s}"
    ms = graph_ms(kernel, what, per_graph=50)
    plain_ms = graph_ms(lambda: flash_attention_plain(q, k, v, causal=True),
                        f"{what} plain", per_graph=5)
    library_ms = graph_ms(lambda: sdpa(qt, kt, vt, is_causal=True),
                          f"{what} library", per_graph=50)
    esize = torch.finfo(dtype).bits // 8
    nbytes = 4 * b * s * n * d * esize + b * n * s * 4   # q, k, v, o; lse f32
    ops = 4 * b * n * d * (s * (s + 1) // 2)         # causal (q, k) pairs
    dname = "bf16"
    if dtype == torch.float32:
        dname, limit = "f32", with_f32_fma_bound(bound(nbytes, ops,
                                                       TF32X3_OPS_PER_S))
    else:
        limit = bound(nbytes, ops)
    return {"ms": ms, "plain_ms": plain_ms, **limit,
            "library_ms": library_ms, "max_abs_err": err,
            "shape": f"causal {dname} B={b} S={s} N={n} D={d}"}


def time_flash(launches: dict) -> dict:
    """K1's row: the served prefill shape (B=4, S=384) as the row's numbers
    and the training shape (B=8, S=512) beside them as ``train``."""
    served = _time_flash_shape(REQUESTS_PER_LEN, PROMPT_LENS[0], 3)
    train = _time_flash_shape(TRAIN_BATCH, TRAIN_SEQ, 13)
    beam = _time_flash_shape(BEAM_BATCH, BEAM_PROMPT, 17)
    llama = _time_flash_shape(LLAMA_PROMPTS, PROMPT_LENS[0], 19,
                              LLAMA32_1B["num_attention_heads"])
    prefill = {f"B=1 S={s}": _time_flash_shape(1, s, 23 + i,
                                               dtype=torch.float32)
               for i, s in enumerate(K1_BUCKETS)}
    return {"name": "flash_fwd", "route": "cuda",
            "source": "bigdl_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "bigdl_tpu/ops/flash_attention.py:104",
            "launches": launches["flash_fwd"],
            "launches_mma": launches["flash_fwd_mma"],
            # each phase checks that every K1 launch of its runs was mma or
            # tf32x3, the only variants
            "launches_tf32x3": launches["flash_fwd"] - launches["flash_fwd_mma"],
            "max_abs_err": served["max_abs_err"], "ms": served["ms"],
            "plain_ms": served["plain_ms"],
            **{k: served[k] for k in ("bound_ms", "bound_by", "bytes",
                                      "operations")},
            "library_ms": served["library_ms"], "variant": "mma",
            "work": f"one prefill launch, {served['shape']}; library_ms: "
                    "scaled_dot_product_attention; launches: the serving "
                    "runs (phases 3, 3d and 3e) and training together; "
                    f"train: {train['shape']}; beam_prefill: phase 3e's "
                    f"{beam['shape']}; llama32_1b_prefill: phase 3g's "
                    f"{llama['shape']}; f32_prefill: the tf32x3 variant at "
                    "the f32 bucketed prefills' shapes (phases 3d and 3n)",
            "train": train, "beam_prefill": beam,
            "llama32_1b_prefill": llama, "f32_prefill": prefill}


def time_flash_bwd(launches: dict) -> list:
    """K2 and K3 at the training shape (bf16, causal, so their "mma"
    variants, which phase 3b counts): one launch each, its plain version,
    and the backward of ``scaled_dot_product_attention``
    (one call for dQ, dK and dV, so the same number on both rows), timed
    as its forward and backward in one graph less its forward alone."""
    from bigdl_tpu_torch.ops.flash_attention import (
        bwd_delta, flash_attention_with_lse, flash_bwd_dkv,
        flash_bwd_dkv_plain, flash_bwd_dq, flash_bwd_dq_plain)
    b, s, n, d = TRAIN_BATCH, TRAIN_SEQ, CONFIG["num_heads"], 64
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = _qkv(gen, b, s, s, n, d, torch.bfloat16)
    g_o = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        o, lse = flash_attention_with_lse(q, k, v, causal=True)
    args = (q, k, v, g_o, lse, bwd_delta(o, g_o, None), True, 1.0 / d ** 0.5)
    dq, (dk, dv) = flash_bwd_dq(*args), flash_bwd_dkv(*args)
    pdq, (pdk, pdv) = flash_bwd_dq_plain(*args), flash_bwd_dkv_plain(*args)
    errs = {}
    for name, got, ref in (("dq", dq, pdq), ("dk", dk, pdk), ("dv", dv, pdv)):
        errs[name], _, ok = bwd_close(got, ref)
        check(ok, f"flash bwd {name} at the timed shape: |err| {errs[name]}")
    ms_dq = graph_ms(lambda: flash_bwd_dq(*args), "flash_bwd_dq")
    ms_dkv = graph_ms(lambda: flash_bwd_dkv(*args), "flash_bwd_dkv")
    plain_dq = graph_ms(lambda: flash_bwd_dq_plain(*args),
                        "flash_bwd_dq plain", per_graph=3, replays=3)
    plain_dkv = graph_ms(lambda: flash_bwd_dkv_plain(*args),
                         "flash_bwd_dkv plain", per_graph=3, replays=3)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    g_t = g_o.transpose(1, 2)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)
    fwd_ms = graph_ms(sdpa, "flash_bwd library forward")
    fwd_bwd_ms = graph_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt),
                                                      g_t),
                          "flash_bwd library forward and backward")
    library_ms = fwd_bwd_ms - fwd_ms
    log({"flash_bwd_library_ms": {"forward": fwd_ms,
                                  "forward_and_backward": fwd_bwd_ms}})
    bsnd, bns = b * s * n * d, b * n * s
    pairs = b * n * s * (s + 1) // 2                 # causal (q, k) pairs
    reads = 4 * bsnd * 2 + 2 * bns * 4               # q, k, v, dO; lse, delta
    dq_bound = bound(reads + bsnd * 2, 3 * 2 * d * pairs)
    dkv_bound = bound(reads + 2 * bsnd * 2, 4 * 2 * d * pairs)
    work = f"one causal backward launch, bf16 B={b} S={s} N={n} D={d}"
    lib_note = ("library_ms: the backward of scaled_dot_product_attention, "
                "one call for dQ, dK and dV (its forward and backward "
                "less its forward)")
    return [{"name": "flash_bwd_dq", "route": "cuda",
             "source": "bigdl_tpu_torch/csrc/flash_bwd.cu",
             "replaces": "bigdl_tpu/ops/flash_attention.py:146",
             "launches": launches["flash_bwd_dq"],
             "launches_mma": launches["flash_bwd_dq_mma"],
             "max_abs_err": errs["dq"],
             "ms": ms_dq, "plain_ms": plain_dq, **dq_bound,
             "library_ms": library_ms, "variant": "mma",
             "work": f"{work}; {lib_note}"},
            {"name": "flash_bwd_dkv", "route": "cuda",
             "source": "bigdl_tpu_torch/csrc/flash_bwd.cu",
             "replaces": "bigdl_tpu/ops/flash_attention.py:186",
             "launches": launches["flash_bwd_dkv"],
             "launches_mma": launches["flash_bwd_dkv_mma"],
             "max_abs_err": max(errs["dk"], errs["dv"]),
             "ms": ms_dkv, "plain_ms": plain_dkv, **dkv_bound,
             "library_ms": library_ms, "variant": "mma",
             "work": f"{work}; {lib_note}"}]


def int8_decode_shapes():
    """(O, K) of the 85 K4 launches of one int8 decode token of the 134m
    config, in the order the model runs them: per layer q, k, v, out, up,
    gate, down, then the tied LM head."""
    e, f = CONFIG["embed_dim"], CONFIG["ffn_dim"]
    e_kv = e // CONFIG["num_heads"] * CONFIG["num_kv_heads"]
    layer = [(e, e), (e_kv, e), (e_kv, e), (e, e), (f, e), (f, e), (e, f)]
    return layer * CONFIG["num_layers"] + [(VOCAB, e)]


def int8_bytes_ops(x, w, s):
    """The bytes one K4 call must move (x bf16, w int8, the scale and y f32)
    and its operations."""
    return (x.numel() * 2 + w.numel() + s.numel() * 4
            + x.shape[0] * w.shape[0] * 4, 2 * x.shape[0] * w.numel())


def int8_chain(m: int, shapes=None, seed: int = 4):
    """The K4 calls of one int8 forward at M rows (``shapes``, default the
    134m config's 85): weights, scales and x from ``seed`` (the same weights
    at every M, and in an earlier tree), each checked against its plain
    version. Returns the calls, the dequantized bf16 weights (the library's
    operand) and the largest absolute error."""
    from bigdl_tpu_torch.ops.int8_matmul import (int8_matmul_kernel,
                                                 int8_matmul_plain)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    calls = []
    for o, k in shapes or int8_decode_shapes():
        w = torch.randint(-128, 128, (o, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        sc = torch.rand((o,), generator=gen, device="cuda") * 1e-2 + 1e-3
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        calls.append((x, w, sc))
    deq = [(w.float() * s[:, None]).to(torch.bfloat16) for _, w, s in calls]
    err = 0.0
    for x, w, s in calls:
        y, ref = int8_matmul_kernel(x, w, s), int8_matmul_plain(x, w, s)
        e, tol = (y - ref).abs().max().item(), INT8_RTOL * ref.abs().max().item()
        check(e <= tol, f"int8 at M={x.shape[0]} O={w.shape[0]} "
                        f"K={w.shape[1]}: err {e} > {tol}")
        err = max(err, e)
    return calls, deq, err


def time_int8_rows(rows=(8, 40, 128)) -> dict:
    """K4 over one forward's 85 int8 matmuls at phase 3d's row counts (a
    step at 8 slots, a verification of 8 x (SPEC_LEN + 1) rows, a prefill
    chunk): its time, its plain version's, the bound, and ``x @ w_bf16.T``
    on the dequantized weights (cuBLAS) as the library time."""
    from bigdl_tpu_torch.ops.int8_matmul import (int8_matmul_kernel,
                                                 int8_matmul_plain)
    out = {}
    for m in rows:
        calls, deq, err = int8_chain(m)

        def kernel():
            for x, w, sc in calls:
                int8_matmul_kernel(x, w, sc)

        def plain():
            for x, w, sc in calls:
                int8_matmul_plain(x, w, sc)

        def library():
            for (x, _, _), wd in zip(calls, deq):
                x @ wd.T

        cost = [int8_bytes_ops(*c) for c in calls]
        out[f"M={m}"] = {
            "ms": graph_ms(kernel, f"int8_matmul M={m}", per_graph=5),
            "plain_ms": graph_ms(plain, f"int8_matmul M={m} plain",
                                 per_graph=3, replays=3),
            "library_ms": graph_ms(library, f"int8_matmul M={m} library",
                                   per_graph=5),
            **bound(sum(b for b, _ in cost), sum(o for _, o in cost)),
            "max_abs_err": err}
        del calls, deq
        torch.cuda.empty_cache()
    return out


def time_int8_published() -> dict:
    """K4 over one int8 decode token of each phase 3g model at M=4 (its
    weights at their shapes, random int8 and scales from a seed): the
    token's time, its plain version's, ``x @ w_bf16.T`` on the dequantized
    weights as the library time, and the bound; ``head``: the tied vocab
    head alone, K4's largest O."""
    from bigdl_tpu_torch.ops.int8_matmul import (int8_matmul_kernel,
                                                 int8_matmul_plain)
    out = {}
    for name in PUBLISHED_PARAMS:
        shapes = published_decode_shapes(name)
        calls, deq, err = int8_chain(REQUESTS_PER_LEN, shapes,
                                     PUBLISHED_SEEDS[name])

        def kernel():
            for x, w, sc in calls:
                int8_matmul_kernel(x, w, sc)

        def plain():
            for x, w, sc in calls:
                int8_matmul_plain(x, w, sc)

        def library():
            for (x, _, _), wd in zip(calls, deq):
                x @ wd.T

        cost = [int8_bytes_ops(*c) for c in calls]
        (x, w, sc), wd = calls[-1], deq[-1]
        out[name] = {
            "launches_per_token": len(calls),
            "weight_bytes": sum(w.numel() for _, w, _ in calls),
            "ms": graph_ms(kernel, f"int8_matmul {name}", per_graph=3),
            "plain_ms": graph_ms(plain, f"int8_matmul {name} plain",
                                 per_graph=1, replays=3),
            "library_ms": graph_ms(library, f"int8_matmul {name} library",
                                   per_graph=3),
            **bound(sum(b for b, _ in cost), sum(o for _, o in cost)),
            "max_abs_err": err,
            "head": {"shape": f"{w.shape[0]}x{w.shape[1]}",
                     "ms": graph_ms(lambda: int8_matmul_kernel(x, w, sc),
                                    f"int8_matmul {name} head"),
                     "library_ms": graph_ms(lambda: x @ wd.T,
                                            f"int8_matmul {name} head "
                                            "library"),
                     **bound(*int8_bytes_ops(x, w, sc))}}
        del calls, deq, x, w, sc, wd
        torch.cuda.empty_cache()
    return out


def time_int8(launches: int) -> dict:
    """K4 over one int8 decode token at M=REQUESTS_PER_LEN: the 85 weights
    at their shapes, random int8 and scales from a seed (so an earlier
    tree's K4 is timed on the same inputs); the token, each distinct shape
    (``shapes``, with its bound and library time) and, where the tree has
    it, an empty kernel launched as often (``empty_launch_ms``: the least
    time of a launch in the same graph)."""
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops.int8_matmul import (int8_matmul_kernel,
                                                 int8_matmul_plain)
    m = REQUESTS_PER_LEN
    calls, deq, err = int8_chain(m)

    def kernel():
        for x, w, s in calls:
            int8_matmul_kernel(x, w, s)

    def plain():
        for x, w, s in calls:
            int8_matmul_plain(x, w, s)

    def library():
        for (x, _, _), wd in zip(calls, deq):
            x @ wd.T

    ms = graph_ms(kernel, "int8_matmul")
    plain_ms = graph_ms(plain, "int8_matmul plain", per_graph=3, replays=3)
    library_ms = graph_ms(library, "int8_matmul library")
    extra = {}
    if "bt_int8_empty_launch" in _build.ENTRIES["int8_matmul"]:
        lib = _build.load("int8_matmul")

        def empty():
            for _ in calls:
                lib.bt_int8_empty_launch(torch.cuda.current_stream().cuda_stream)
        extra["empty_launch_ms"] = graph_ms(empty, "empty launches") / len(calls)
    nbytes = sum(int8_bytes_ops(*c)[0] for c in calls)
    ops = sum(int8_bytes_ops(*c)[1] for c in calls)
    shapes = {}
    for (x, w, s), wd in zip(calls, deq):
        key = f"{w.shape[0]}x{w.shape[1]}"
        if key in shapes:
            shapes[key]["count"] += 1
            continue
        one = graph_ms(lambda: int8_matmul_kernel(x, w, s),
                       f"int8_matmul {key}", per_graph=50)
        lib_one = graph_ms(lambda: x @ wd.T, f"int8_matmul {key} library",
                           per_graph=50)
        shapes[key] = {"count": 1, "ms": one, "library_ms": lib_one,
                       **bound(*int8_bytes_ops(x, w, s))}
    return {"name": "int8_matmul", "route": "cuda",
            "source": "bigdl_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "bigdl_tpu/ops/int8_matmul.py:92",
            "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, **bound(nbytes, ops),
            "library_ms": library_ms, **extra, "shapes": shapes,
            "work": f"one int8 decode token: {len(calls)} launches at M={m}, "
                    f"{sum(w.numel() for _, w, _ in calls)} weight bytes; "
                    "library_ms: x @ w_bf16.T (cuBLAS, twice the bytes)"}


def _time_stats_kernel(name, kernel, plain, library, x, w, nbytes, ops,
                       time_plain=True, ops_per_s=BF16_OPS_PER_S,
                       per_graph=20):
    """One fused-statistics kernel at one shape: checked once more against
    its plain version, then its device time, its plain version's (unless
    ``time_plain`` is false), and the library's product and one fused
    reduction of the product's two sums (``torch.var_mean``: one read of y,
    the same information), each by ``graph_ms``."""
    got, ref = kernel(x, w), plain(x, w)
    torch.cuda.synchronize()
    err, _, ok = y_close(got[0], ref[0])
    _, st_ok = stats_close(got[1:], ref[1:], ref[0])
    check(ok and st_ok, f"{name} at the timed shape: |y err| {err}")
    del got, ref
    y = library(x, w)
    y2d = y.reshape(-1, y.shape[-1])
    ms = graph_ms(lambda: kernel(x, w), name, per_graph=per_graph)
    out = {"ms": ms}
    if time_plain:
        out["plain_ms"] = graph_ms(lambda: plain(x, w), f"{name} plain",
                                   per_graph=3, replays=3)
    product_ms = graph_ms(lambda: library(x, w), f"{name} library",
                          per_graph=per_graph)
    reduce_ms = graph_ms(lambda: torch.var_mean(y2d, dim=0, correction=0),
                         f"{name} library reduction", per_graph=per_graph)
    return {**out, **bound(nbytes, ops, ops_per_s),
            "library_ms": product_ms + reduce_ms,
            "library_product_ms": product_ms,
            "library_reduction_ms": reduce_ms, "max_abs_err": err}


K5_STAGE_SHAPES = {"stage1": (RESNET_BATCH * 56 * 56, 64, 256),
                   "stage4": (RESNET_BATCH * 7 * 7, 512, 2048)}


def time_conv_bn(launches: dict) -> list:
    """K5 and K6 in bf16 at B=256: the largest-M shape (stage 1) as the
    entry's numbers and the deepest one (stage 4) beside them; K5 also at
    every distinct 1x1 shape of the training step (``step``: each shape's
    time, bound and library time, and their sums over the step's 36
    launches). The bound counts x, w and y in bf16 and the two f32 sums
    once each, and 2 * M * K * N (K6: 2 * N * H * W * 9 * Cin * Cout)
    operations. Then the f32 path of phase 3s's ResNet-50 ``backward`` at
    B=256 (cuBLAS and cuDNN in f32, TF32 off): K6's ``f32``, its
    ``tf32x3`` variant at each of the four 3x3 shapes (``bound_ms`` at the
    3xTF32 ceiling, ``bound_f32_fma_ms`` at the f32 FMA peak), and K5's
    ``f32_step``, its ``fma`` variant at the step's 15 1x1 shapes, summed
    over the 36 launches; their launches are phase 3s's."""
    from bigdl_tpu_torch.ops.conv3x3_bn import (_conv3x3,
                                                conv3x3_with_stats_kernel,
                                                conv3x3_with_stats_plain)
    from bigdl_tpu_torch.ops.matmul_bn import (matmul_with_stats_kernel,
                                               matmul_with_stats_plain)
    gen = torch.Generator(device="cuda").manual_seed(12)
    bf16 = torch.bfloat16
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    b = RESNET_BATCH
    k5, step = {}, {}
    stage_of = {shape: stage for stage, shape in K5_STAGE_SHAPES.items()}
    for (m, k, n), count in resnet50_1x1_step(b).items():
        x, w = rnd(m, k).to(bf16), (rnd(k, n) / k ** 0.5).to(bf16)
        stage = stage_of.get((m, k, n))
        row = _time_stats_kernel(
            f"matmul_bn M={m} K={k} N={n}", matmul_with_stats_kernel,
            matmul_with_stats_plain, lambda x, w: x @ w, x, w,
            2 * (m * k + k * n + m * n) + 8 * n, 2 * m * k * n,
            time_plain=stage is not None)
        del x, w
        if stage:
            k5[stage] = {**row, "shape": f"M={m} K={k} N={n} bf16"}
        step[f"M={m} K={k} N={n}"] = {"count": count, **{
            key: row[key] for key in ("ms", "bound_ms", "bound_by",
                                      "library_ms")}}
    check(sum(r["count"] for r in step.values()) == K5_PER_STEP,
          f"the step's 1x1 shapes count {len(step)}")
    k5_step = {key: sum(r["count"] * r[src] for r in step.values())
               for key, src in (("step_ms", "ms"),
                                ("library_step_ms", "library_ms"),
                                ("bound_step_ms", "bound_ms"))}
    k6 = {}
    for stage, (h, c) in (("stage1", (56, 64)), ("stage4", (7, 512))):
        x, w = rnd(b, h, h, c).to(bf16), (rnd(3, 3, c, c) / (3 * c ** 0.5)
                                          ).to(bf16)
        k6[stage] = _time_stats_kernel(
            f"conv3x3_bn {stage}", conv3x3_with_stats_kernel,
            conv3x3_with_stats_plain, _conv3x3, x, w,
            2 * (2 * b * h * h * c + 9 * c * c) + 8 * c,
            2 * b * h * h * 9 * c * c)
        k6[stage]["shape"] = f"N={b} {h}x{h} {c}->{c} bf16"
    k6_f32 = {}
    for _, h, _, c, _ in resnet50_conv_shapes(b)[1]:
        x, w = rnd(b, h, h, c), rnd(3, 3, c, c) / (3 * c ** 0.5)
        k6_f32[f"{h}x{h} {c}->{c}"] = with_f32_fma_bound(_time_stats_kernel(
            f"conv3x3_bn f32 {h}x{h}", conv3x3_with_stats_kernel,
            conv3x3_with_stats_plain, _conv3x3, x, w,
            4 * (2 * b * h * h * c + 9 * c * c) + 8 * c,
            2 * b * h * h * 9 * c * c, ops_per_s=TF32X3_OPS_PER_S,
            per_graph=5))
        del x, w
    k5_f32 = {}
    for (m, k, n), count in resnet50_1x1_step(b).items():
        x, w = rnd(m, k), rnd(k, n) / k ** 0.5
        row = _time_stats_kernel(
            f"matmul_bn f32 M={m} K={k} N={n}", matmul_with_stats_kernel,
            matmul_with_stats_plain, lambda x, w: x @ w, x, w,
            4 * (m * k + k * n + m * n) + 8 * n, 2 * m * k * n,
            time_plain=False, ops_per_s=F32_OPS_PER_S, per_graph=3)
        del x, w
        k5_f32[f"M={m} K={k} N={n}"] = {"count": count, **{
            key: row[key] for key in ("ms", "bound_ms", "bound_by",
                                      "library_ms")}}
    torch.cuda.empty_cache()
    k5_f32_step = {key: sum(r["count"] * r[src] for r in k5_f32.values())
                   for key, src in (("step_ms", "ms"),
                                    ("library_step_ms", "library_ms"),
                                    ("bound_step_ms", "bound_ms"))}
    entries = []
    for name, src, ref, per, lib in (
            ("matmul_bn", "matmul_bn.cu", "bigdl_tpu/ops/matmul_bn.py:67", k5,
             "x @ w (cuBLAS) + torch.var_mean of y"),
            ("conv3x3_bn", "conv3x3_bn.cu", "bigdl_tpu/ops/conv3x3_bn.py:68",
             k6, "F.conv2d (cuDNN) + torch.var_mean of y")):
        main = per["stage1"]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"bigdl_tpu_torch/csrc/{src}", "replaces": ref,
            "launches": launches[name],
            "launches_mma": launches[f"{name}_mma"], "variant": "mma",
            "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            **{k: main[k] for k in ("bound_ms", "bound_by", "bytes",
                                    "operations")},
            "library_ms": main["library_ms"],
            "library_product_ms": main["library_product_ms"],
            "library_reduction_ms": main["library_reduction_ms"],
            "work": f"one launch at the stage-1 shape, {main['shape']}; "
                    f"library_ms: {lib}; launches: the 20-step ResNet-50 "
                    "training run",
            "stage4": per["stage4"]})
    entries[0].update({**k5_step, "step": step})
    entries[0]["f32_step"] = {
        "variant": "fma", **k5_f32_step, "step": k5_f32,
        "launches": SURFACE_LAUNCHES["matmul_bn"],
        "work": "the 36 launches of ResNet-50's f32 backward at B=256 (phase "
                "3s), 15 shapes; library: x @ w (cuBLAS, f32) + "
                "torch.var_mean of y; launches: phase 3s's"}
    entries[1]["f32"] = {
        "variant": "tf32x3", "shapes": k6_f32,
        "launches": SURFACE_LAUNCHES["conv3x3_bn_tf32"],
        "work": "one launch at each of ResNet-50's four stride-1 3x3 "
                "shapes at B=256 in f32 (phase 3s's backward: 3, 3, 5 and 2 "
                "of them, 13 in all); library: F.conv2d (cuDNN, f32) + "
                "torch.var_mean of y; launches: phase 3s's"}
    log({"conv_bn_timing": {"matmul_bn": k5, "matmul_bn_step": k5_step,
                            "conv3x3_bn": k6, "conv3x3_bn_f32": k6_f32,
                            "matmul_bn_f32_step": k5_f32_step}})
    return entries


# -------------------------------------------------------- 3k. the layer zoo
#: phase 3k's shapes: B x HW x HW x C for the spatial layers, N x D^3 x C
#: for the volumetric ones, ROIS boxes and NMS_BOXES candidates with
#: NMS_OUT kept
LAYER_B, LAYER_HW, LAYER_C = 32, 56, 64
VOL_N, VOL_D, VOL_C = 8, 16, 32
ROIS, NMS_BOXES, NMS_OUT = 128, 6000, 300
#: phase 3k (a)'s tolerances (of max|CPU|): the CPU tests' for elementwise
#: layers and criteria, and for convolutions, normalizations and reductions
LAYER_TOL, LAYER_REDUCE_TOL = 1e-6, 1e-5
#: a tensor of a LAYER_REDUCE_TOL case outside it is held instead to an
#: f64 CPU run: at most twice the CPU f32's distance, or LAYER_F64_FACTOR
#: times the case's tolerance (1e-4). cuDNN's f32 weight gradient of a 3x3
#: conv at B=32 56x56 64->64 (a sum over 100,352 positions) lands 4.6e-5
#: of max from f64 where oneDNN's lands 4.3e-7 (NVIDIA H100, 700 W): a
#: long f32 sum is off by up to about sqrt(n) x 2^-24 x a few. The same
#: conv in TF32 must land past the floor (``tf32_control``). Elementwise
#: cases (LAYER_TOL) get no f64 hold.
LAYER_F64_FACTOR = 10.0
#: phase 3k (b): iterations of the autoencoder app per optim method, its
#: batch (32 vendored images: 4 iterations an epoch), the weights' L2, and
#: the window lengths held bit-equal to k = 1 (a window ends at its
#: epoch's end: 4 makes one window an epoch, 3 a full window then a short
#: one of 1)
AE_ITERS, AE_BATCH, AE_L2 = 20, 8, 1e-4
AE_WINDOWS = (3, 4)
AE_LOSS_RTOL = 1e-5
MNIST_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                         "resources", "mnist")


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    if got.shape != ref.shape:
        raise RuntimeError(f"shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not ref.numel():
        return 0.0
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _layer_pass(module, inputs, table: bool, cots):
    """Forward and backward of ``module`` on ``inputs`` (each float one
    made a leaf that requires grad) with cotangents ``cots`` (made from the
    outputs' shapes when None): ({label: tensor} of the outputs, the input
    gradients and the parameter gradients, the cotangents)."""
    xs = [t.clone().requires_grad_() if t.is_floating_point() else t
          for t in inputs]
    out = module(xs) if table else module(*xs)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    if cots is None:
        gen = torch.Generator().manual_seed(1)
        cots = [torch.randn(o.shape, generator=gen) if o.is_floating_point()
                else None for o in outs]
    loss = sum((o * c.to(device=o.device, dtype=o.dtype)).sum()
               for o, c in zip(outs, cots)
               if c is not None and o.requires_grad)
    if torch.is_tensor(loss):
        loss.backward()
    got = {f"out{i}": o.detach() for i, o in enumerate(outs)}
    got.update({f"d_input{i}": x.grad for i, x in enumerate(xs)
                if x.is_floating_point() and x.grad is not None})
    got.update({f"d_{n}": (p.grad if p.grad is not None
                           else torch.zeros_like(p))
                for n, p in module.named_parameters()})
    return got, cots


def _held(name: str, got: dict, ref: dict, tol: float, f64) -> dict:
    """Each of ``got`` (the card's) within ``tol`` of max|``ref``| (the
    CPU's). Where ``tol`` is LAYER_REDUCE_TOL, a tensor that is not is held
    instead to the f64 CPU run (``f64()``, made only then): the card's
    distance from it at most twice the CPU f32's (phase 3c's rule) or
    LAYER_F64_FACTOR x ``tol`` (a sum over 10^5 terms, such as a weight
    gradient at B*H*W = 100,352 positions, lands further than 1e-5 from
    exact in cuDNN's f32 order). Returns the worst direct error and the
    tensors held to f64."""
    errs = {k: _rel_err(got[k], ref[k]) for k in ref}
    bad = [k for k, e in errs.items() if e > tol]
    held = {}
    if bad:
        check(tol >= LAYER_REDUCE_TOL,
              f"phase 3k {name}: " + ", ".join(
                  f"{k} {errs[k]:.3g}" for k in bad)
              + f" from the CPU (tol {tol:g})")
        exact = f64()
        for k in bad:
            card = _rel_err(got[k], exact[k])
            cpu = _rel_err(ref[k], exact[k])
            check(card <= max(2.0 * cpu, LAYER_F64_FACTOR * tol),
                  f"phase 3k {name} {k}: card {errs[k]:.3g} from the CPU "
                  f"(tol {tol:g}); from f64 the card {card:.3g}, the CPU "
                  f"{cpu:.3g}")
            held[k] = {"card_vs_cpu": errs[k], "card_vs_f64": card,
                       "cpu_vs_f64": cpu}
    return {"max_rel_err": max(errs.values()) if errs else 0.0,
            "held_to_f64": held}


def layer_case(name: str, module, inputs, tol: float, table: bool = False,
               train: bool = False) -> dict:
    """Phase 3k (a): ``module`` on the card against the same module (a
    deep copy of its weights) on the CPU: outputs, input gradients and
    parameter gradients within ``tol`` of max|CPU| (or, for a tensor that
    is not, ``_held``'s f64 rule)."""
    import copy
    dev = torch.device("cuda")
    cpu = module.train(train)
    card = copy.deepcopy(module).to(dev).train(train)
    t0 = time.perf_counter()
    ref, cots = _layer_pass(cpu, inputs, table, None)
    got, _ = _layer_pass(card, [t.to(dev) for t in inputs], table, cots)
    torch.cuda.synchronize()

    def f64():
        exact = copy.deepcopy(cpu).double()
        return _layer_pass(exact, [t.double() if t.is_floating_point()
                                   else t for t in inputs], table,
                           [c.double() if c is not None else None
                            for c in cots])[0]

    row = _held(name, got, ref, tol, f64)
    return {"case": name, **row, "tol": tol, "s": time.perf_counter() - t0}


def criterion_case(name: str, crit, x, t,
                   grad_tol: float = LAYER_TOL) -> dict:
    """Phase 3k (a): a criterion's loss and input gradients on the card
    against the CPU (``x`` a tensor or a list: a table). The loss sums
    millions of terms, a reduction, so it is held to LAYER_REDUCE_TOL; the
    gradients, elementwise, to ``grad_tol`` (each by ``_held``'s rule)."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()

    def run(xs, tgt):
        leaves = [a.clone().requires_grad_() for a in xs]
        loss = crit(leaves if isinstance(x, list) else leaves[0], tgt)
        loss.backward()
        return {"loss": loss.detach(),
                **{f"d_input{i}": a.grad for i, a in enumerate(leaves)}}

    def on(v, d, dtype=None):
        if isinstance(v, list):
            return [on(a, d, dtype) for a in v]
        if not torch.is_tensor(v):
            return v
        return v.to(d, dtype) if dtype and v.is_floating_point() else v.to(d)

    xs = x if isinstance(x, list) else [x]
    ref = run(xs, t)
    got = run(on(xs, dev), on(t, dev))
    f64 = lambda: run(on(xs, "cpu", torch.float64),            # noqa: E731
                      on(t, "cpu", torch.float64))
    loss = _held(name, {"loss": got["loss"]}, {"loss": ref["loss"]},
                 LAYER_REDUCE_TOL, f64)
    grads = _held(name, {k: v for k, v in got.items() if k != "loss"},
                  {k: v for k, v in ref.items() if k != "loss"}, grad_tol,
                  f64)
    return {"case": name, "max_rel_err": max(loss["max_rel_err"],
                                             grads["max_rel_err"]),
            "loss_rel_err": loss["max_rel_err"],
            "held_to_f64": {**loss["held_to_f64"], **grads["held_to_f64"]},
            "tol": grad_tol, "s": time.perf_counter() - t0}


def layer_zoo_cases():
    """Phase 3k (a)'s cases: (name, module factory, input factory, tol,
    table) at the spatial, volumetric and RoI shapes; every new layer of
    ``nn``'s activation, shape, container, linear, normalization, conv,
    pooling and regularization files, and the f32 conv twin."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.nn.quantized import quantize_model
    b, hw, c = LAYER_B, LAYER_HW, LAYER_C
    spatial = (b, hw, hw, c)
    rows = b * hw                               # the linear layers' rows
    gen = torch.Generator().manual_seed(0)

    def x(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen) * scale + shift

    x.gen = gen

    def ids(n, *shape):
        return torch.randint(1, n + 1, shape, generator=gen).float()

    E, R = LAYER_TOL, LAYER_REDUCE_TOL
    act = [("ReLU", ()), ("ReLU6", ()), ("Threshold", (0.2, -0.5)),
           ("PReLU", (0,)), ("PReLU", (c,)), ("RReLU", ()),
           ("LeakyReLU", (0.1,)), ("ELU", (0.7,)), ("Sigmoid", ()),
           ("LogSigmoid", ()), ("Tanh", ()), ("TanhShrink", ()),
           ("HardTanh", (-0.5, 0.7)), ("HardShrink", (0.4,)),
           ("SoftShrink", (0.4,)), ("SoftPlus", (1.5,)), ("SoftSign", ()),
           ("SoftMax", ()), ("SoftMin", ()), ("LogSoftMax", ()),
           ("Clamp", (-0.3, 0.6)), ("Power", (2, 1.5, -0.2)),
           ("Square", ()), ("Abs", ()), ("Exp", ()),
           ("AddConstant", (1.25,)), ("MulConstant", (-0.75,)),
           ("GradientReversal", (0.3,))]
    cases = [(f"{n}{a}", lambda n=n, a=a: getattr(nn, n)(*a),
              lambda: [x(*spatial)], E, False) for n, a in act]
    cases += [("Sqrt", lambda: nn.Sqrt(), lambda: [x(*spatial).abs() + 0.5],
               E, False),
              ("Log", lambda: nn.Log(), lambda: [x(*spatial).abs() + 0.5],
               E, False),
              ("Power(2.5)", lambda: nn.Power(2.5, 0.5, 2.0),
               lambda: [x(*spatial, scale=0.5)], E, False),
              ("L1Penalty", lambda: nn.L1Penalty(0.1, True),
               lambda: [x(*spatial)], E, False)]
    shapes = [("View", (hw * hw * c,)), ("InferReshape", ((0, -1), True)),
              ("Squeeze", ()), ("Unsqueeze", (2,)), ("Replicate", (2, 2)),
              ("SpatialZeroPadding", (1, 2, -1, 3)), ("Narrow", (2, 3, hw // 2)),
              ("Select", (-1, 3)), ("Reverse", (2,)), ("Contiguous", ())]
    cases += [(n, lambda n=n, a=a: getattr(nn, n)(*a),
               lambda: [x(*spatial)], E, False) for n, a in shapes]
    pair = lambda: [x(*spatial), x(*spatial)]          # noqa: E731
    three = lambda: [x(*spatial) for _ in range(3)]    # noqa: E731
    cases += [(n, lambda n=n: getattr(nn, n)(), three, E, True)
              for n in ("CSubTable", "CMulTable", "CMaxTable", "CMinTable",
                        "FlattenTable")]
    cases += [
        ("CDivTable", lambda: nn.CDivTable(),
         lambda: [x(*spatial), x(*spatial).abs() + 1.0], E, True),
        ("JoinTable", lambda: nn.JoinTable(3, 3), three, E, True),
        ("SplitTable", lambda: nn.SplitTable(1, 3),
         lambda: [x(b, 8, hw, c)], E, False),
        ("SelectTable", lambda: nn.SelectTable(2), three, E, True),
        ("NarrowTable", lambda: nn.NarrowTable(2, 2), three, E, True),
        ("MixtureTable", lambda: nn.MixtureTable(),
         lambda: [x(rows, 4), x(rows, 4, c)], R, True),
        ("MaskedSelect", lambda: nn.MaskedSelect(),
         lambda: [x(*spatial), (x(*spatial) > 0).float()], E, True),
        ("Index", lambda: nn.Index(2),
         lambda: [x(*spatial), ids(hw, 17)], E, True),
        ("Bottle", lambda: nn.Bottle(nn.Linear(c, c)),
         lambda: [x(*spatial)], R, False),
        ("MapTable", lambda: nn.MapTable(nn.Linear(c, c)),
         lambda: [x(rows, c), x(rows, c)], R, True),
        ("ParallelTable", lambda: nn.ParallelTable().add(nn.Linear(c, c))
         .add(nn.Tanh()), lambda: [x(rows, c), x(rows, c)], R, True),
        ("Add", lambda: nn.Add(c), lambda: [x(*spatial)], E, False),
        ("Scale", lambda: nn.Scale((c,)), lambda: [x(*spatial)], R, False),
        ("Bilinear", lambda: nn.Bilinear(c, c, c),
         lambda: [x(rows, c), x(rows, c)], R, True),
        ("Cosine", lambda: nn.Cosine(c, c), lambda: [x(rows, c)], R, False),
        ("Euclidean", lambda: nn.Euclidean(c, c), lambda: [x(rows, c)], R,
         False),
        ("MM", lambda: nn.MM(False, True),
         lambda: [x(b, hw, c), x(b, hw, c)], R, True),
        ("MV", lambda: nn.MV(), lambda: [x(b, hw, c), x(b, c)], R, True),
        ("DotProduct", lambda: nn.DotProduct(),
         lambda: [x(rows, c), x(rows, c)], R, True),
        ("LookupTable", lambda: nn.LookupTable(10000, c, 7.0, 1.0),
         lambda: [ids(10000, b, hw)], R, False),
        ("InputNormalize", lambda: nn.InputNormalize([0.5] * c, [0.25] * c),
         lambda: [x(*spatial)], E, False),
        ("Normalize", lambda: nn.Normalize(2.0), lambda: [x(*spatial)], R,
         False),
        ("SpatialSubtractiveNormalization",
         lambda: nn.SpatialSubtractiveNormalization(c),
         lambda: [x(*spatial)], R, False),
        ("SpatialDivisiveNormalization",
         lambda: nn.SpatialDivisiveNormalization(c),
         lambda: [x(*spatial)], R, False),
        ("SpatialContrastiveNormalization",
         lambda: nn.SpatialContrastiveNormalization(c),
         lambda: [x(*spatial)], R, False),
        ("SpatialShareConvolution",
         lambda: nn.SpatialShareConvolution(c, c, 3, 3, 1, 1, 1, 1),
         lambda: [x(*spatial)], R, False),
        ("SpatialDilatedConvolution",
         lambda: nn.SpatialDilatedConvolution(c, c, 3, 3, 1, 1, 2, 2, 2, 2),
         lambda: [x(*spatial)], R, False),
        ("SpatialFullConvolution",
         lambda: nn.SpatialFullConvolution(c, c // 2, 3, 3, 2, 2, 1, 1, 1, 1,
                                           2),
         lambda: [x(*spatial)], R, False),
        ("SpatialConvolutionMap",
         lambda: nn.SpatialConvolutionMap(
             nn.SpatialConvolutionMap.full(c, c), 3, 3, 1, 1, 1, 1),
         lambda: [x(*spatial)], R, False),
        ("VolumetricConvolution",
         lambda: nn.VolumetricConvolution(VOL_C, VOL_C, 3, 3, 3, 1, 1, 1,
                                          1, 1, 1),
         lambda: [x(VOL_N, VOL_D, VOL_D, VOL_D, VOL_C)], R, False),
        ("VolumetricMaxPooling", lambda: nn.VolumetricMaxPooling(2, 2, 2),
         lambda: [x(VOL_N, VOL_D, VOL_D, VOL_D, VOL_C)], E, False),
        ("RoiPooling", lambda: nn.RoiPooling(7, 7, 1.0),
         lambda: [x(*spatial), roi_boxes(gen)], E, True),
        ("QuantizedSpatialConvolution",
         lambda: quantize_model(nn.Sequential().add(
             nn.SpatialConvolution(c, c, 3, 3, 1, 1, 1, 1)), torch.float32,
             device="cpu"), lambda: [x(*spatial)], R, False),
    ]
    return cases, x, ids


def roi_boxes(gen) -> torch.Tensor:
    """ROIS boxes ``[batch, x1, y1, x2, y2]`` over LAYER_B feature maps of
    LAYER_HW, some reaching past the borders."""
    hw = LAYER_HW
    xy = torch.rand((ROIS, 2), generator=gen) * (hw + 8) - 4
    wh = torch.rand((ROIS, 2), generator=gen) * hw
    batch = torch.randint(0, LAYER_B, (ROIS, 1), generator=gen).float()
    return torch.cat([batch, xy, xy + wh], 1)


def criterion_cases(x, ids) -> list:
    """Phase 3k (a)'s criteria: elementwise ones over the spatial shape,
    class ones over B*HW*HW rows of C classes; (name, criterion, input,
    target[, gradient tolerance]). Dice's gradient divides by sums over
    each row's HW*HW*C elements, so it is held as a reduction."""
    from bigdl_tpu_torch import nn
    b, hw, c = LAYER_B, LAYER_HW, LAYER_C
    flat = (b, hw * hw * c)
    n = b * hw * hw
    pm = lambda *s: torch.where(x(*s) >= 0, 1.0, -1.0)      # noqa: E731
    prob = lambda *s: torch.sigmoid(x(*s))                    # noqa: E731
    bits = lambda *s: (x(*s) > 0).float()                     # noqa: E731
    logp = lambda: torch.log_softmax(x(n, c), -1)              # noqa: E731
    labels = torch.stack([torch.randperm(c, generator=x.gen)[:4] + 1.0
                          for _ in range(n)])
    return [
        ("ClassNLLCriterion", nn.ClassNLLCriterion(), logp(), ids(c, n)),
        ("CrossEntropyCriterion", nn.CrossEntropyCriterion(), x(n, c),
         ids(c, n)),
        ("MSECriterion", nn.MSECriterion(), x(*flat), x(*flat)),
        ("AbsCriterion", nn.AbsCriterion(), x(*flat), x(*flat)),
        ("BCECriterion", nn.BCECriterion(), prob(*flat), bits(*flat)),
        ("SmoothL1Criterion", nn.SmoothL1Criterion(), x(*flat, scale=2),
         x(*flat)),
        ("SmoothL1CriterionWithWeights",
         nn.SmoothL1CriterionWithWeights(2.0, n), x(*flat),
         [x(*flat), prob(*flat), prob(*flat)]),
        ("MarginCriterion", nn.MarginCriterion(0.5), x(*flat), pm(*flat)),
        ("MarginRankingCriterion", nn.MarginRankingCriterion(0.3),
         [x(n), x(n)], pm(n)),
        ("HingeEmbeddingCriterion", nn.HingeEmbeddingCriterion(1.5),
         x(*flat), pm(*flat)),
        ("L1HingeEmbeddingCriterion", nn.L1HingeEmbeddingCriterion(2.0),
         [x(n, c), x(n, c)], torch.tensor(1.0)),
        ("CosineEmbeddingCriterion", nn.CosineEmbeddingCriterion(0.1),
         [x(n, c), x(n, c)], pm(n)),
        ("DistKLDivCriterion", nn.DistKLDivCriterion(), logp(),
         torch.softmax(x(n, c), -1)),
        ("SoftMarginCriterion", nn.SoftMarginCriterion(), x(*flat),
         pm(*flat)),
        ("MultiLabelSoftMarginCriterion",
         nn.MultiLabelSoftMarginCriterion(), x(n, c), bits(n, c)),
        ("MultiMarginCriterion", nn.MultiMarginCriterion(2), x(n, c),
         ids(c, n)),
        ("MultiLabelMarginCriterion", nn.MultiLabelMarginCriterion(),
         x(n, c), labels),
        ("ClassSimplexCriterion", nn.ClassSimplexCriterion(c), x(n, c),
         ids(c, n)),
        ("DiceCoefficientCriterion", nn.DiceCoefficientCriterion(),
         prob(*flat), bits(*flat), LAYER_REDUCE_TOL),
        ("L1Cost", nn.L1Cost(), x(*flat), None),
        ("SoftmaxWithCriterion", nn.SoftmaxWithCriterion(3, "VALID"),
         x(b, c, hw, hw), ids(c, b, hw, hw)),
        ("ParallelCriterion", nn.ParallelCriterion().add(nn.MSECriterion(),
                                                         0.5)
         .add(nn.AbsCriterion(), 2.0), [x(*flat), x(*flat)],
         [x(*flat), x(*flat)]),
        ("MultiCriterion", nn.MultiCriterion().add(nn.MSECriterion(), 0.3)
         .add(nn.SmoothL1Criterion(), 1.7), x(*flat), x(*flat)),
        ("CriterionTable", nn.CriterionTable(nn.MSECriterion()),
         [x(*flat), x(*flat)], None),
    ]


def check_nms_on_card() -> dict:
    """Phase 3k (a): ``nms`` over NMS_BOXES boxes keeping NMS_OUT, on the
    card against the CPU: identical indices and count."""
    from bigdl_tpu_torch.nn.detection import nms
    gen = torch.Generator().manual_seed(3)
    xy = torch.rand((NMS_BOXES, 2), generator=gen) * 600
    boxes = torch.cat([xy, xy + 10 + torch.rand((NMS_BOXES, 2),
                                                generator=gen) * 90], 1)
    scores = torch.rand(NMS_BOXES, generator=gen)
    t0 = time.perf_counter()
    ref = nms(boxes, scores, 0.7, NMS_OUT)
    dev = torch.device("cuda")
    t1 = time.perf_counter()
    got = nms(boxes.to(dev), scores.to(dev), 0.7, NMS_OUT)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t1
    check(torch.equal(got[0].cpu(), ref[0]) and int(got[1]) == int(ref[1]),
          "phase 3k nms: the card's indices or count differ from the CPU's")
    row = {"case": "nms", "kept": int(ref[1]), "boxes": NMS_BOXES,
           "card_s": card_s, "s": time.perf_counter() - t0}
    log({"layer_zoo_nms": row})
    return row


def autoencoder_optimizer(device: str, method=None, l2: float = 0.0):
    """Phase 3k (b)/(c): the autoencoder app's run composed from its parts
    (``dataset`` with seeded shuffles, ``models/autoencoder.build``,
    ``build_optimizer`` from the app's parsed defaults) on the vendored
    MNIST in batches of AE_BATCH, ``method`` in place of the app's SGD and
    ``L2Regularizer(l2)`` registered on both weights when ``l2``."""
    from bigdl_tpu_torch.apps import autoencoder as app
    from bigdl_tpu_torch.apps.common import build_optimizer
    from bigdl_tpu_torch.models import autoencoder
    from bigdl_tpu_torch.nn.criterion import MSECriterion
    from bigdl_tpu_torch.nn.regularization import L2Regularizer
    from bigdl_tpu_torch.optim import Loss
    args = app.parser().parse_args(["-f", MNIST_DIR, "-b", str(AE_BATCH),
                                    "--device", device])
    model = autoencoder.build(32, device=device)
    if l2:
        for linear in (model[1], model[3]):
            linear.register_parameter("weight", linear.weight,
                                      L2Regularizer(l2))
    ds = app.dataset(MNIST_DIR, AE_BATCH, seed=0)
    return build_optimizer(model, ds, MSECriterion(), args,
                           validation_set=ds, methods=[Loss(MSECriterion())],
                           optim_method=method)


def autoencoder_run(method, device: str, k: int = 1):
    """Phase 3k (b): AE_ITERS iterations of the autoencoder under
    ``method`` with ``L2Regularizer(AE_L2)`` on the weights, windows of
    ``k`` on the card: (per-iteration losses, parameters)."""
    from bigdl_tpu_torch.optim import Trigger
    opt = autoencoder_optimizer(device, method, AE_L2)
    opt.set_end_when(Trigger.max_iteration(AE_ITERS))
    if k > 1:
        opt.set_steps_per_dispatch(k)
    model = opt.optimize()
    return ([h["loss"] for h in opt.history],
            {n: p.detach().cpu().clone() for n, p in model.named_parameters()})


def run_autoencoder() -> dict:
    """Phase 3k (b): the autoencoder app with SGD (the app's), RMSprop,
    Adamax and Adadelta, each step's loss on the card within AE_LOSS_RTOL
    of the CPU's; then SGD under ``EpochStep`` and Adamax with windows of
    each of AE_WINDOWS against k = 1 on the card, bit for bit, regularizer
    included. A window ends at its epoch's end, so no window spans an
    epoch boundary: k = 4 makes each window a whole epoch, and k = 3 a
    window of 3 then a short one of 1, the rate changing after it."""
    from bigdl_tpu_torch.optim import methods as m
    makers = {
        "sgd": lambda: m.SGD(learningrate=0.01, momentum=0.9),
        "rmsprop": lambda: m.RMSprop(0.01, 0.0, 0.99, 1e-3),
        "adamax": lambda: m.Adamax(0.01, 0.9, 0.999, 1e-3),
        "adadelta": lambda: m.Adadelta(),
        "sgd_epoch_step": lambda: m.SGD(
            learningrate=0.5, momentum=0.9,
            learningrate_schedule=m.EpochStep(1, 0.5)),
    }
    out = {}
    for name, make in makers.items():
        t0 = time.perf_counter()
        cpu_losses, _ = autoencoder_run(make(), "cpu")
        card_losses, card_params = autoencoder_run(make(), "cuda")
        worst = max(abs(g - r) / abs(r) for g, r in zip(card_losses,
                                                         cpu_losses))
        check(len(card_losses) == len(cpu_losses) == AE_ITERS
              and worst <= AE_LOSS_RTOL,
              f"phase 3k autoencoder {name}: card loss {worst:.3g} from the "
              f"CPU's (> {AE_LOSS_RTOL:g})")
        row = {"loss_rel_err": worst, "first_loss": card_losses[0],
               "last_loss": card_losses[-1]}
        if name in ("sgd_epoch_step", "adamax"):
            for k in AE_WINDOWS:
                k_losses, k_params = autoencoder_run(make(), "cuda", k)
                same = k_losses == card_losses and all(
                    torch.equal(k_params[n], p)
                    for n, p in card_params.items())
                check(same, f"phase 3k autoencoder {name}: k = {k} is not "
                            "bit-equal to k = 1")
                row[f"k{k}_bit_equal"] = same
        row["s"] = time.perf_counter() - t0
        out[name] = row
        log({"layer_zoo_app": name, **row})
    return out


def autoencoder_timing() -> dict:
    """Phase 3k (c): ``enable_timing`` over two card iterations of the
    autoencoder; every module's forward and backward time is positive."""
    from bigdl_tpu_torch.nn.module import enable_timing
    from bigdl_tpu_torch.optim import Trigger
    opt = autoencoder_optimizer("cuda")
    opt.set_end_when(Trigger.max_iteration(2))
    enable_timing()
    try:
        model = opt.optimize()
    finally:
        enable_timing(False)
    times = [(m.name, f, b) for m, f, b in model.get_times()]
    check(len(times) == 6 and all(f > 0 and b > 0 for _, f, b in times),
          f"phase 3k timing: a module without positive times: {times}")
    return {"modules": [{"module": n, "forward_s": f, "backward_s": b}
                        for n, f, b in times]}


def tf32_control(cases) -> dict:
    """Phase 3k (a)'s control of the f64 floor: SpatialShareConvolution's
    case with TF32 on in cuDNN and cuBLAS. Its card gradients' worst
    distance from the f64 CPU run must lie past LAYER_F64_FACTOR x
    LAYER_REDUCE_TOL, so that the floor tells a TF32 conv from cuDNN's f32
    one."""
    import copy
    name, make, inputs, tol, table = next(c for c in cases
                                          if c[0] == "SpatialShareConvolution")
    t0 = time.perf_counter()
    module, xs = make(), inputs()
    cpu = copy.deepcopy(module).double()
    exact, cots = _layer_pass(cpu, [t.double() for t in xs], table, None)
    card = module.to("cuda")
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got, _ = _layer_pass(card, [t.to("cuda") for t in xs], table, cots)
        torch.cuda.synchronize()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    errs = {k: _rel_err(got[k], exact[k]) for k in exact}
    floor = LAYER_F64_FACTOR * tol
    worst = max(errs, key=errs.get)
    check(errs[worst] > floor,
          f"phase 3k TF32 control: {name} in TF32 lands {errs[worst]:.3g} "
          f"from f64, inside the floor {floor:g}")
    row = {"case": name, "tf32_vs_f64": errs, "floor": floor,
           "s": time.perf_counter() - t0}
    log({"layer_zoo_tf32_control": row})
    return row


def run_layer_zoo() -> dict:
    """Phase 3k: (a) every new layer and criterion on the card against the
    same module on the CPU, f32 with TF32 off (``main`` sets it), forward
    and input and parameter gradients, at B=LAYER_B, HW=LAYER_HW,
    C=LAYER_C (volumetric N=VOL_N, D=VOL_D, C=VOL_C; ROIS RoIs; ``nms``
    over NMS_BOXES keeping NMS_OUT); (b) the autoencoder app; (c)
    ``enable_timing`` on the card."""
    t0 = time.perf_counter()
    cases, x, ids = layer_zoo_cases()
    rows = []
    for name, make, inputs, tol, table in cases:
        rows.append(layer_case(name, make(), inputs(), tol, table))
    for name, crit, xin, tgt, *tol in criterion_cases(x, ids):
        rows.append(criterion_case(name, crit, xin, tgt, *tol))
    rows.append(check_nms_on_card())
    control = tf32_control(cases)
    direct = [r for r in rows if not r.get("held_to_f64")]
    worst = max(direct, key=lambda r: r.get("max_rel_err", 0.0) / r.get(
        "tol", 1.0))
    layers_s = time.perf_counter() - t0
    log({"layer_zoo_cases": len(rows), "layer_zoo_layers_s": layers_s,
         "worst_direct": worst,
         "held_to_f64": {r["case"]: r["held_to_f64"] for r in rows
                         if r.get("held_to_f64")},
         "slowest": sorted(rows, key=lambda r: -r["s"])[:5]})
    app = run_autoencoder()
    timing = autoencoder_timing()
    log({"layer_zoo_timing": timing})
    result = {"cases": len(rows), "layers_s": layers_s, "app": app,
              "tf32_control": control, "timing": timing, "layer_zoo_s": time.perf_counter() - t0}
    log({"layer_zoo": {k: v for k, v in result.items() if k != "timing"}})
    return result


# ------------------------------------ 3l. text, tokenizers and summaries
TEXT_SEED = 71
TEXT_CORPUS_BYTES = 1 << 20
TEXT_BPE_VOCAB = 1024
TEXT_LR = 0.1              # SGD's rate (momentum 0.9): the loss falls in one
                           # epoch (3e-3, the CLI's default, barely moves it)
TEXT_WIDTH = ["--embedDim", "768", "--numHeads", "12", "--numLayers", "12",
              "--seqLen", "512", "-b", "8", "--llamaBlock", "-r", str(TEXT_LR)]
TEXT_LAYERS, TEXT_SEQ, TEXT_BATCH = 12, 512, 8
TEXT_CUT_LAYERS = 2
TEXT_LOSS_RTOL = 1e-4
TEXT_NEW_TOKENS = 16
#: (b) samples (top-k, seeded): the text LM, near its unigram after one
#: epoch, puts most mass on eos, so greedy answers eos at once
TEXT_TOP_K, TEXT_SAMPLE_SEED = 40, 5
#: (a)'s busy share: iterations of the trained model after a warm-up
TEXT_BUSY_WARM, TEXT_BUSY_ITERS = 2, 10
#: (d)'s textclassifier: epochs of the synthetic corpus (3 iterations each)
TC_EPOCHS = 4
SP_STRINGS = 100
SP_RATE_STRINGS = 2000
TENSOR_RTOL = 1e-5
#: the corpus's words: ASCII, Latin-1 and wider scripts, so that byte
#: merges cross UTF-8 boundaries
TEXT_WORDS = (
    "the of and to in is was for on that with as by at from it an be this "
    "which or are his her they not had have one all were we can their "
    "there been has more if will would who so no out up into about than "
    "them its only other new some time could these two may first then do "
    "any like my now over such our man me even most made after also did "
    "many before must through back years where much your way well down "
    "should because each just those people how too little state good very "
    "make world still own see men work long get here between both life "
    "being under never day same another know while last might us great "
    "old year off come since against go came right used take three "
    "café naïve über straße façade résumé jalapeño smörgåsbord crème "
    "déjà fjörður þorp łódź čeština ελληνικά μήλο русский язык "
    "中文 日本語 한국어 עברית العربية हिन्दी 🙂 🚀").split()


def write_text_corpus(path: str) -> list:
    """About TEXT_CORPUS_BYTES of lines of 4-19 words drawn from
    TEXT_WORDS with seed TEXT_SEED; returns the lines."""
    rng = np.random.default_rng(TEXT_SEED)
    lines, size = [], 0
    while size < TEXT_CORPUS_BYTES:
        line = " ".join(rng.choice(TEXT_WORDS, int(rng.integers(4, 20))))
        lines.append(line)
        size += len(line.encode("utf-8")) + 1
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return lines


def printed_continuation(argv: list) -> tuple:
    """Runs ``apps.transformer``'s ``main(argv)`` in this process and
    returns the (prompt, continuation) it prints, as Python values."""
    import ast
    import contextlib
    import io
    from bigdl_tpu_torch.apps import transformer as app
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        app.main(argv)
    lines = buf.getvalue().strip().splitlines()
    check(len(lines) == 2 and lines[0].startswith("prompt:")
          and lines[1].startswith("continuation:"),
          f"generate printed {lines}")
    return tuple(ast.literal_eval(x.split(":", 1)[1].strip()) for x in lines)


def text_generated(model, tok, prompt: str, seed=None) -> tuple:
    """(prompt ids, continuation ids up to and with the first eos, the
    continuation's text as the CLI prints it) of ``generate``: greedy, or
    with ``seed`` top-TEXT_TOP_K sampling from a generator seeded so."""
    from bigdl_tpu_torch.models.generation import generate
    ids = tok.encode(prompt)
    kw = (dict(greedy=True) if seed is None else dict(
        top_k=TEXT_TOP_K, generator=torch.Generator(
            device="cuda").manual_seed(seed)))
    out = generate(model.evaluate_mode(), [ids], TEXT_NEW_TOKENS,
                   eos_id=tok.eos_id, device="cuda", **kw)[0].tolist()
    cont = out[len(ids):]
    text = tok.decode(cont)
    if tok.eos_id in cont:
        cont = cont[:cont.index(tok.eos_id) + 1]
    return ids, cont, text


def text_train(root: str, launches: dict) -> dict:
    """(a) ``transformer train --textFile --bpeVocab 1024`` at the 134m
    recipe's width (f32, the CLI's SGD), one epoch of the corpus."""
    import argparse
    from bigdl_tpu_torch.apps import transformer as app
    from bigdl_tpu_torch.dataset.bpe import BPETokenizer
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                              TimeDistributedCriterion)
    from bigdl_tpu_torch.utils import file_io
    res = {}
    corpus = os.path.join(root, "corpus.txt")
    lines = write_text_corpus(corpus)
    t0 = time.perf_counter()
    tok = BPETokenizer.train(lines, vocab_size=TEXT_BPE_VOCAB)
    res["bpe_train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    encoded = [tok.encode(line) for line in lines]
    res["bpe_encode_s"] = time.perf_counter() - t0
    bad = [ln for ln, ids in zip(lines, encoded) if tok.decode(ids) != ln]
    check(not bad, f"BPE round trip failed on {len(bad)} lines: {bad[:2]}")
    res["corpus_bytes"] = os.path.getsize(corpus)
    res["corpus_tokens"] = sum(len(ids) + 1 for ids in encoded)
    ckpt = os.path.join(root, "text_ckpt")
    counters = flash_counters()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    opt, _ = app.optimizer([
        "--textFile", corpus, "--bpeVocab", str(TEXT_BPE_VOCAB), *TEXT_WIDTH,
        "-e", "1", "--checkpoint", ckpt, "--device", "cuda"])
    file_io.save(opt.optimize(), file_io.join(ckpt, "model_final"))
    res["train_s"] = time.perf_counter() - t0
    got = {k: c.value for k, c in counters.items()}
    for k, n in got.items():
        launches[k] += n
    losses = [h["loss"] for h in opt.history]
    steps = len(losses)
    res.update(iterations=steps, samples=steps * TEXT_BATCH,
               losses=losses[:3] + losses[-3:],
               ms_per_iteration=float(np.median(
                   [h["seconds"] for h in opt.history[2:]] or [np.nan]))
               * 1e3,
               launches_per_step={k: n / max(steps, 1)
                                  for k, n in got.items()})
    saved = BPETokenizer.load(os.path.join(ckpt, "tokenizer.bigdl"))
    check(saved.merges == tok.merges and saved.eos_id == tok.eos_id,
          "the saved tokenizer's merges differ from the corpus's BPE")
    check(steps >= 20 and all(np.isfinite(losses)),
          f"text training: {steps} iterations, losses {losses[:5]}")
    check(float(np.mean(losses[-5:])) < losses[0],
          f"text loss did not fall: first {losses[0]}, last {losses[-5:]}")
    want = TEXT_LAYERS * steps
    check(got["flash_fwd"] == got["flash_bwd_dq"] == got["flash_bwd_dkv"]
          == got["flash_fwd_tf32"] == want, f"text training launched "
          f"K1/K2/K3 {got}, want {want} each (12 a step), K1 all tf32x3")

    # a 2-layer cut at full width: the first batch's f32 loss on the card
    # against the same cut on the CPU
    samples, vocab = app.text_corpus(argparse.Namespace(
        textFile=corpus, bpeVocab=TEXT_BPE_VOCAB, seqLen=TEXT_SEQ,
        checkpoint=None))
    x = torch.from_numpy(np.stack([s.feature for s in samples[:TEXT_BATCH]]))
    y = torch.from_numpy(np.stack([s.label for s in samples[:TEXT_BATCH]]))
    cut = dict(ffn_dim=4 * 768, num_layers=TEXT_CUT_LAYERS, max_len=1024,
               rope=True, norm="rms", activation="swiglu", bias=False,
               seed=TEXT_SEED)
    crit = TimeDistributedCriterion(ClassNLLCriterion())
    with torch.no_grad():
        on_cpu = build_lm(vocab, 768, 12, device="cpu", **cut)
        cpu_loss = crit(on_cpu(x), y).item()
        del on_cpu
        card = build_lm(vocab, 768, 12, device="cuda", **cut)
        card_loss = crit(card(x.to("cuda")), y.to("cuda")).item()
    res["cut_loss_card_cpu"] = [card_loss, cpu_loss]
    check(abs(card_loss - cpu_loss) <= TEXT_LOSS_RTOL * abs(cpu_loss),
          f"2-layer cut: loss {card_loss} on the card, {cpu_loss} on the CPU")

    # the busy share over TEXT_BUSY_ITERS iterations of the trained model,
    # after TEXT_BUSY_WARM of another run on it
    from bigdl_tpu_torch.dataset.base import DataSet, SampleToBatch
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    model = file_io.load(os.path.join(ckpt, "model_final"), device="cuda")
    ds = DataSet.array(samples[:TEXT_BUSY_ITERS * TEXT_BATCH], seed=0) \
        >> SampleToBatch(TEXT_BATCH)
    runs = [Optimizer(model, ds, crit, device="cuda")
            .set_optim_method(SGD(learningrate=TEXT_LR, momentum=0.9))
            .set_end_when(Trigger.max_iteration(n))
            for n in (TEXT_BUSY_WARM, TEXT_BUSY_ITERS)]
    runs[0].optimize()
    rows, wall = profiled(runs[1].optimize, "text training steps")
    res["busy_share"] = (None if rows is None else
                         sum(t for _, t in rows) / 1e6 / wall)
    res["busy_iterations"] = TEXT_BUSY_ITERS
    for k, c in counters.items():   # not the main path's launches
        c.reset()
    return res


TEXT_PROMPT = "the café on the über straße was 🙂 and"
TEXT_SAMPLING = ["--topK", str(TEXT_TOP_K), "--seed", str(TEXT_SAMPLE_SEED)]


def text_cli(argv: list, **kw) -> subprocess.Popen:
    """``python -m bigdl_tpu_torch.apps.<argv>`` started from the
    repository's root (phases 3l and 3m run their CLI processes beside
    their own work)."""
    return subprocess.Popen(
        [sys.executable, "-m", *argv],
        cwd=os.path.dirname(os.path.abspath(__file__)), **kw)


def text_server(root: str) -> subprocess.Popen:
    """``serve --tokenizer`` on (a)'s checkpoint, sampling as (b) does."""
    ckpt = os.path.join(root, "text_ckpt")
    return text_cli([
        "bigdl_tpu_torch.apps.transformer", "serve", "--model",
        os.path.join(ckpt, "model_final"), "--tokenizer",
        os.path.join(ckpt, "tokenizer.bigdl"), "--port", "0",
        "--maxNewTokens", str(TEXT_NEW_TOKENS), "--device", "cuda",
        *TEXT_SAMPLING], stderr=subprocess.PIPE, stdout=subprocess.DEVNULL,
        text=True)


def text_serve(root: str, launches: dict, proc, t_start: float) -> dict:
    """(b) ``generate --tokenizer`` and ``serve --tokenizer`` (``proc``,
    started at ``t_start``) from (a)'s checkpoint, sampling top-TEXT_TOP_K
    from seeded generators: text in, the same answer as ``generate`` on
    the encoded ids with the same generator (the CLI's ``--seed``; the
    server's first batch draws from ``SeedSequence([seed, 0])``); K1
    launches num_layers times in the CLI's prefill."""
    import signal
    import urllib.request
    from bigdl_tpu_torch.dataset.bpe import BPETokenizer
    from bigdl_tpu_torch.utils import file_io
    ckpt = os.path.join(root, "text_ckpt")
    model_path = os.path.join(ckpt, "model_final")
    tok_path = os.path.join(ckpt, "tokenizer.bigdl")
    prompt = TEXT_PROMPT
    res = {}
    counters = flash_counters()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    sampling = TEXT_SAMPLING
    _, printed = printed_continuation(
        ["generate", "--model", model_path, "--tokenizer", tok_path,
         "--prompt", prompt, "--maxNewTokens", str(TEXT_NEW_TOKENS),
         "--device", "cuda", *sampling])
    res["generate_cli_s"] = time.perf_counter() - t0
    k1 = counters["flash_fwd"].value
    for key in ("flash_fwd", "flash_fwd_mma", "flash_fwd_tf32"):
        launches[key] += counters[key].value
    check(k1 == TEXT_LAYERS == counters["flash_fwd_tf32"].value,
          f"generate --tokenizer launched K1 {k1} times, "
          f"{counters['flash_fwd_tf32'].value} tf32x3, want {TEXT_LAYERS} "
          "f32 (one prefill)")
    tok = BPETokenizer.load(tok_path)
    model = file_io.load(model_path, device="cuda")
    ids, _, text = text_generated(model, tok, prompt, TEXT_SAMPLE_SEED)
    served_seed = int(np.random.SeedSequence([TEXT_SAMPLE_SEED, 0])
                      .generate_state(1)[0])
    _, cont, _ = text_generated(model, tok, prompt, served_seed)
    del model
    for c in counters.values():
        c.reset()
    check(printed == text, f"generate --tokenizer printed {printed!r}, "
          f"generate on the encoded ids gives {text!r}")
    res.update(prompt_tokens=len(ids), continuation=text, served_ids=cont)
    try:
        port = read_served_port(proc, time.perf_counter() + CLI_TIMEOUT_S)
        res["serve_startup_s"] = time.perf_counter() - t_start
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps({"text": prompt}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            answer = json.loads(r.read())
        check(answer["ids"] == cont and answer["text"] == tok.decode(cont),
              f"serve --tokenizer answered {answer}, generate gives {cont}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
        check(rc == 0, f"serve --tokenizer exited {rc} after SIGTERM")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return res


def sp_pieces(vocab: int, seed: int) -> list:
    """A unigram vocabulary of ``vocab`` pieces: the 3 specials, the 256
    ``<0xNN>`` byte pieces, then seeded distinct pieces over lower-case
    Latin, a few accented letters and the word mark, with seeded scores."""
    from bigdl_tpu_torch.interop.sentencepiece import (BYTE, CONTROL, NORMAL,
                                                       UNKNOWN)
    rng = np.random.default_rng(seed)
    pieces = [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL),
              ("</s>", 0.0, CONTROL)]
    pieces += [(f"<0x{b:02X}>", 0.0, BYTE) for b in range(256)]
    letters = list("abcdefghijklmnopqrstuvwxyz") + list("éüöñç") + ["▁"]
    seen = set()
    for ch in letters:
        seen.add(ch)
        pieces.append((ch, float(rng.uniform(-14, -10)), NORMAL))
    while len(pieces) < vocab:
        p = "".join(rng.choice(letters, int(rng.integers(2, 8))))
        if p not in seen:
            seen.add(p)
            pieces.append((p, float(rng.uniform(-13, -2)), NORMAL))
    return pieces


def sp_strings(n: int, seed: int) -> list:
    """Seeded strings over the pieces' letters, spaces and characters no
    piece covers (byte fallback)."""
    rng = np.random.default_rng(seed)
    chars = list("abcdefghijklmnopqrstuvwxyz     ") + ["é", "ü", "ж", "Ω",
                                                      "中", "🙂", "  "]
    return ["".join(rng.choice(chars, int(rng.integers(1, 60))))
            for _ in range(n)]


def text_sentencepiece(root: str, launches: dict) -> dict:
    """(c) The 134m recipe at vocab 32000 as an HF Llama directory with a
    unigram ``tokenizer.model`` (byte fallback) written by ``write_model``:
    ``generate --fromHF DIR --prompt TEXT`` on the card equals ``generate``
    on the tokenizer's ids; unigram and BPE models round-trip
    SP_STRINGS seeded strings exactly; the host's encode rate."""
    from bigdl_tpu_torch.interop.hf import (load_hf_checkpoint,
                                            save_hf_checkpoint)
    from bigdl_tpu_torch.interop.sentencepiece import (SentencePieceTokenizer,
                                                       write_model)
    from bigdl_tpu_torch.models.transformer import build_lm
    res = {}
    d = os.path.join(root, "llama_sp")
    base = build_lm(VOCAB, **CONFIG, device="cuda", seed=TEXT_SEED + 1)
    save_hf_checkpoint(base, d)
    del base
    pieces = sp_pieces(VOCAB, TEXT_SEED + 2)
    write_model(os.path.join(d, "tokenizer.model"), pieces,
                model_type="unigram", byte_fallback=True)
    tok = SentencePieceTokenizer.from_dir(d)
    check(tok.vocab_size == VOCAB, f"tokenizer.model holds {tok.vocab_size}")
    strings = sp_strings(SP_STRINGS, TEXT_SEED + 3)
    for kind in ("unigram", "bpe"):
        t = tok if kind == "unigram" else SentencePieceTokenizer.from_file(
            write_model(os.path.join(root, "bpe.model"), pieces,
                        model_type="bpe", byte_fallback=True))
        bad = [s for s in strings if t.decode(t.encode(s)) != s]
        check(not bad, f"sentencepiece {kind} round trip failed on "
              f"{len(bad)} strings: {bad[:2]}")
    many = sp_strings(SP_RATE_STRINGS, TEXT_SEED + 4)
    t0 = time.perf_counter()
    for s in many:
        tok.encode(s)
    res["sp_encode_strings_per_s"] = SP_RATE_STRINGS / (
        time.perf_counter() - t0)
    prompt = "the quick brown fox ж 🙂 jumps"
    counters = flash_counters()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    _, printed = printed_continuation(
        ["generate", "--fromHF", d, "--prompt", prompt, "--greedy",
         "--maxNewTokens", str(TEXT_NEW_TOKENS), "--device", "cuda"])
    res["generate_fromhf_s"] = time.perf_counter() - t0
    k1 = counters["flash_fwd"].value
    for key in ("flash_fwd", "flash_fwd_mma", "flash_fwd_tf32"):
        launches[key] += counters[key].value
    check(k1 == CONFIG["num_layers"] == counters["flash_fwd_tf32"].value,
          f"generate --fromHF launched K1 {k1} times, "
          f"{counters['flash_fwd_tf32'].value} tf32x3, want "
          f"{CONFIG['num_layers']} f32")
    model = load_hf_checkpoint(d, device="cuda")
    ids, _, text = text_generated(model, tok, prompt)
    del model
    for c in counters.values():
        c.reset()
    check(printed == text, f"generate --fromHF printed {printed!r}, "
          f"generate on the tokenizer's ids gives {text!r}")
    res.update(sp_prompt_tokens=len(ids), sp_continuation=text)
    return res


def text_summary_run(root: str) -> tuple:
    """``lenet train --summary`` for (d), as a process of its own:
    (process, its log file)."""
    log_file = open(os.path.join(root, "lenet.log"), "w")
    return text_cli([
        "bigdl_tpu_torch.apps.lenet", "train", "-b", "64", "-e", "1",
        "--synthetic-size", "256", "--summary",
        os.path.join(root, "summary"), "--appName", "lenet", "--device",
        "cuda"], stdout=log_file, stderr=subprocess.STDOUT), log_file


def text_summary(root: str, proc, log_file, t_start: float) -> dict:
    """(d) ``lenet train --summary``'s event files: the port's
    ``FileReader`` reads back every iteration's ``Loss`` and
    ``Throughput``, each record's CRC32C checked."""
    from bigdl_tpu_torch.visualization import FileReader
    rc = proc.wait(timeout=CLI_TIMEOUT_S)
    log_file.close()
    res = {"lenet_summary_s": time.perf_counter() - t_start}
    with open(log_file.name) as f:
        tail = f.read()[-1500:]
    check(rc == 0, f"lenet --summary: rc {rc}, {tail}")
    folder = os.path.join(root, "summary", "lenet", "train")
    for tag in ("Loss", "Throughput"):
        rows = FileReader.read_scalar(folder, tag)   # every CRC checked
        check([s for s, _, _ in rows] == [1, 2, 3, 4]
              and all(np.isfinite(v) for _, v, _ in rows),
              f"lenet --summary {tag}: {rows}")
    return res


#: phase 3l's textclassifier bundle (the model, vocabulary, embeddings and
#: sequence length, as ``apps.textclassifier train --checkpoint`` saves
#: it), which phase 3m's udfpredictor reads; {"dir", "path"}, removed by 3m
TEXT_BUNDLE = {}


def save_classifier_bundle(model, prepared, seq_len: int = 1000) -> str:
    """Save ``model`` with ``textclassifier.prepare``'s vocabulary and
    embeddings as a classifier bundle in a directory of its own."""
    import tempfile

    from bigdl_tpu_torch.utils import file_io
    folder = tempfile.mkdtemp(prefix="bigdl_bundle_")
    path = os.path.join(folder, "classifier_bundle")
    file_io.save({"model": model, "word2index": prepared[4],
                  "embeddings": prepared[3], "seq_len": seq_len}, path)
    TEXT_BUNDLE.update(dir=folder, path=path)
    return path


def text_apps(root: str) -> dict:
    """(d) The textclassifier at the reference's defaults, the rnn app,
    ``DLClassifier`` and ``Tensor`` on the card."""
    from bigdl_tpu_torch.apps import rnn as rnn_app
    from bigdl_tpu_torch.apps import textclassifier as tc_app
    from bigdl_tpu_torch.ml import DLClassifier
    from bigdl_tpu_torch.models import lenet
    from bigdl_tpu_torch.tensor import Tensor
    res = {}
    opt, _, prepared = tc_app.optimizer([
        "--maxSequenceLength", "1000", "--embeddingDim", "100", "-b", "128",
        "-e", str(TC_EPOCHS), "--device", "cuda"])
    opt.optimize()
    save_classifier_bundle(opt.model, prepared)
    tc_losses = [h["loss"] for h in opt.history]
    top1 = [v["results"]["Top1Accuracy"].result()[0]
            for v in opt.validation_history]
    res.update(textclassifier_iterations=len(tc_losses),
               textclassifier_losses=tc_losses,
               textclassifier_ms_per_iteration=float(np.median(
                   [h["seconds"] for h in opt.history[1:]])) * 1e3,
               textclassifier_top1=top1)
    chance = 1.0 / prepared[2]
    check(len(tc_losses) == 3 * TC_EPOCHS and np.isfinite(tc_losses).all()
          and np.mean(tc_losses[-3:]) < tc_losses[0]
          and len(top1) == TC_EPOCHS and top1[-1] > chance,
          f"textclassifier: losses {tc_losses}, Top1 {top1} (chance "
          f"{chance})")
    opt = rnn_app.optimizer(["-e", "2", "--device", "cuda"])
    opt.optimize()
    rnn_losses = [h["loss"] for h in opt.history]
    res["rnn_losses"] = rnn_losses[:2] + rnn_losses[-2:]
    check(np.isfinite(rnn_losses).all() and np.mean(rnn_losses[-3:])
          < rnn_losses[0], f"rnn app losses {rnn_losses}")


    rng = np.random.default_rng(TEXT_SEED)
    x = rng.normal(size=(300, 28, 28, 1)).astype(np.float32)
    y = rng.integers(1, 11, 300).astype(np.float32)
    model = lenet.build(10, device="cuda", seed=3)
    fitted = DLClassifier(model, batch_size=100, max_epoch=1,
                          device="cuda").fit(x, y)
    with torch.no_grad():   # the model's own forward, in the same batches
        direct = torch.cat([model.eval()(torch.from_numpy(
            x[i:i + 100]).to("cuda")) for i in range(0, 300, 100)])
    check(np.array_equal(fitted.predict(x),
                         direct.argmax(-1).cpu().numpy() + 1),
          "DLClassifier's predictions differ from the model's argmax")

    a = rng.normal(size=(64, 48)).astype(np.float32)
    b = rng.normal(size=(48, 32)).astype(np.float32)
    k = rng.normal(size=(3, 5)).astype(np.float32)
    worst = 0.0
    outs = {}
    for dev in ("cuda", "cpu"):
        t = Tensor(a, device=dev)
        t.narrow(2, 3, 4).mul(2.0)
        t.select(1, 5).fill(1.5)
        outs[dev] = [Tensor(64, 32, device=dev).mm(t, b), t.sum(2),
                     t.sort(2, True)[0], t.topk(3, 1, False)[1],
                     t.conv2(k, "F"), t]
    for got, want in zip(outs["cuda"], outs["cpu"]):
        g, w = got.numpy().astype(np.float64), want.numpy().astype(np.float64)
        err = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
        worst = max(worst, err)
    res["tensor_max_rel_err"] = worst
    check(worst <= TENSOR_RTOL, f"Tensor on the card against the CPU: {worst}")
    return res


def run_text() -> dict:
    """Phase 3l; returns its K1, K2 and K3 launches for the kernel rows."""
    import tempfile
    t0 = time.perf_counter()
    launches = collections.defaultdict(int)
    with tempfile.TemporaryDirectory() as root:
        row = {"train": text_train(root, launches)}
        # the two CLI processes start now and run beside (b) and (c)
        t_cli = time.perf_counter()
        server = text_server(root)
        lenet, lenet_log = text_summary_run(root)
        try:
            row["serve"] = text_serve(root, launches, server, t_cli)
            summary = text_summary(root, lenet, lenet_log, t_cli)
            row["sentencepiece"] = text_sentencepiece(root, launches)
            row["apps"] = dict(text_apps(root), **summary)
        finally:
            for proc in (server, lenet):
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            lenet_log.close()
    train = row["train"]
    log({"text_slice": {
        "corpus_tokens": train["corpus_tokens"],
        "corpus_bytes": train["corpus_bytes"],
        "bpe_train_s": train["bpe_train_s"], "samples": train["samples"],
        "iterations": train["iterations"],
        "ms_per_iteration": train["ms_per_iteration"],
        "busy_share": train["busy_share"],
        "launches_per_step": train["launches_per_step"],
        "sp_encode_strings_per_s":
            row["sentencepiece"]["sp_encode_strings_per_s"],
        "textclassifier_ms_per_iteration":
            row["apps"]["textclassifier_ms_per_iteration"],
        "phase_s": time.perf_counter() - t0}})
    log({"text_details": row})
    return {k: launches[k] for k in flash_counters()}


# ------------------------------------------------- 3m. model files, images
FILES_SEED = 83
FILES_CLASSES = 10
FILES_TRAIN, FILES_VAL = 320, 64      # JPEGs; each side drawn from FILES_SIDES
FILES_SIDES = (256, 512)
FILES_BATCH = 32
FILES_WARMUP = 2                      # iterations before the timed ones
FILES_BUSY_ITERATIONS = 4             # iterations the profiler reads
FILES_CRC_BYTES = 64 << 20
FILES_CODEC_FLOATS = 64 << 20
FILES_DECODE = (256, 224, 224, 3)     # the native batch decode's batch
FILES_DECODE_ATOL = 1e-6
FILES_PIL_RECORDS = 64                # records the per-record PIL rate reads
FILES_TEXTS = 200
#: card against CPU log-probs (f32, TF32 off), over the largest |log-prob|;
#: on an NVIDIA H100 80GB HBM3 (700 W) the three validators' models read
#: 1.2e-6 to 3.1e-6 with TF32 off and 4.6e-4 to 1.1e-3 with it on, so the
#: limit lies between the two, and a reading with TF32 on must exceed it
FILES_LOGPROB_RTOL = 3e-5
#: of every 4 validation images (in path order), the rank in the model's
#: own ordering of the class whose folder it is placed in for (d): one
#: first, one third, two last, so Top-1 reads 16 and Top-5 32 of 64
FILES_PLACED_RANKS = (0, 2, -1, -1)
FILES_MEAN_BGR = (0.406 * 255, 0.456 * 255, 0.485 * 255)
FILES_STD_BGR = (0.225 * 255, 0.224 * 255, 0.229 * 255)


def files_tree(root: str) -> str:
    """FILES_TRAIN + FILES_VAL seeded JPEGs under ``root/tree/{train,val}``
    in FILES_CLASSES class directories, each a bilinear upscale of 8x8
    random pixels to sides drawn from FILES_SIDES (quality 90), written on
    8 threads."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image
    rng = np.random.default_rng(FILES_SEED)
    tree = os.path.join(root, "tree")
    jobs = []
    for split, n in (("train", FILES_TRAIN), ("val", FILES_VAL)):
        for i in range(n):
            w, h = (int(v) for v in rng.integers(FILES_SIDES[0],
                                                 FILES_SIDES[1] + 1, 2))
            low = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
            path = os.path.join(tree, split, f"class_{i % FILES_CLASSES:02d}",
                                f"{i:04d}.jpg")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            jobs.append((path, low, w, h))

    def write(job):
        path, low, w, h = job
        Image.fromarray(low).resize((w, h), Image.BILINEAR).save(
            path, "JPEG", quality=90)
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(write, jobs))
    return tree


def files_native(root: str, crc_path: str, crc_data: bytes) -> dict:
    """(a) The host library: built from the port's sources (or loaded, if
    an earlier phase of this process built it), each entry point against
    its numpy plain version on seeded inputs (CRC32C over 64 MiB, the bf16
    codec on 64 M floats bit for bit, quickselect, the batch decode within
    FILES_DECODE_ATOL), with their times."""
    from bigdl_tpu_torch import native
    from bigdl_tpu_torch.visualization import tensorboard
    t = time.perf_counter()
    check(native.is_loaded(), "the host library did not load")
    res = {"library": dict(native.BUILD_INFO),
           "first_use_s": time.perf_counter() - t}
    rng = np.random.default_rng(FILES_SEED + 1)
    t = time.perf_counter()
    crc = native.crc32c(crc_data)
    res["crc32c_gb_per_s"] = len(crc_data) / (time.perf_counter() - t) / 1e9
    check(tensorboard.crc32c(crc_data) == crc, "visualization's CRC32C")
    res["crc32c"] = crc

    x = rng.standard_normal(FILES_CODEC_FLOATS, dtype=np.float32)
    t = time.perf_counter()
    v = native.fp32_to_bf16(x)
    res["codec_compress_gb_per_s"] = x.nbytes / (time.perf_counter() - t) / 1e9
    check(np.array_equal(v, native.fp32_to_bf16_plain(x)), "fp32_to_bf16")
    w = native.bf16_to_fp32(v)
    check(np.array_equal(w.view(np.uint32),
                         native.bf16_to_fp32_plain(v).view(np.uint32)),
          "bf16_to_fp32")
    other = native.fp32_to_bf16(x[::-1].copy())
    a, b = v.copy(), v.copy()
    native.bf16_add(a, other)
    native.bf16_add_plain(b, other)
    check(np.array_equal(a, b), "bf16_add")
    a, b = w.copy(), w.copy()
    native.bf16_accumulate(a, other)
    native.bf16_accumulate_plain(b, other)
    check(np.array_equal(a.view(np.uint32), b.view(np.uint32)),
          "bf16_accumulate")
    del x, v, w, other, a, b
    vals = rng.standard_normal(1 << 20)
    for k in (1, 1000, 1 << 20):
        check(native.kth_largest(vals, k) == native.kth_largest_plain(vals, k),
              f"kth_largest k={k}")

    n, h, wd, c = FILES_DECODE
    raw = rng.integers(0, 256, (n, h * wd * c), dtype=np.uint8)
    mean = np.asarray(FILES_MEAN_BGR, np.float32)
    rstd = (1.0 / np.asarray(FILES_STD_BGR, np.float32)).astype(np.float32)
    t = time.perf_counter()
    out = native.decode_normalize(raw, mean, rstd, c, 8)
    native_s = time.perf_counter() - t
    t = time.perf_counter()
    plain = native.decode_normalize_plain(raw, mean, rstd, c)
    plain_s = time.perf_counter() - t
    err = float(np.abs(out - plain).max())
    check(err <= FILES_DECODE_ATOL, f"decode_normalize: {err}")
    res.update(decode_max_abs_err=err,
               decode_native_images_per_s=n / native_s,
               decode_numpy_images_per_s=n / plain_s)
    res["raw"] = raw   # (b) decodes these records again, as a transformer
    return res


def files_records(tree: str, shards: str, raw: np.ndarray) -> dict:
    """(b) Every record of ``seqfilegen``'s shards equals its file's bytes
    and label, by the host library's scan and by the Python framing alike;
    the decode rates of the per-record PIL path and the native batch
    path."""
    from bigdl_tpu_torch.dataset.base import ByteRecord
    from bigdl_tpu_torch.dataset.image import (EncodedBytesToBGRImg,
                                               NativeBGRBatchDecoder,
                                               image_folder_paths)
    from bigdl_tpu_torch.dataset.shards import (list_shards, read_shard,
                                                read_shard_plain)
    res = {"shard_files": 0, "shards_mb": 0.0}
    for split in ("train", "val"):
        paths = list_shards(os.path.join(shards, split))
        res["shard_files"] += len(paths)
        res["shards_mb"] += sum(os.path.getsize(p) for p in paths) / 2 ** 20
        scanned = [(r.label, r.data) for p in paths for r in read_shard(p)]
        framed = [(r.label, r.data) for p in paths
                  for r in read_shard_plain(p)]
        check(scanned == framed, f"{split}: the native scan and the Python "
                                 "framing disagree")
        files = []
        for path, label in image_folder_paths(os.path.join(tree, split)):
            with open(path, "rb") as f:
                files.append((label, f.read()))
        check(sorted(scanned) == sorted(files),
              f"{split}: the shards' records are not the files")
        res[f"{split}_records"] = len(scanned)
    records = [ByteRecord(d, lbl) for lbl, d in scanned[:FILES_PIL_RECORDS]]
    t = time.perf_counter()
    imgs = list(EncodedBytesToBGRImg(256)(iter(records)))
    res["decode_pil_images_per_s"] = len(imgs) / (time.perf_counter() - t)
    n, h, w, c = FILES_DECODE
    batch = [ByteRecord(row.tobytes(), 1.0) for row in raw]
    t = time.perf_counter()
    (out,) = NativeBGRBatchDecoder(h, w, n, FILES_MEAN_BGR, FILES_STD_BGR,
                                   workers=8)(iter(batch))
    res["decode_native_batch_images_per_s"] = n / (time.perf_counter() - t)
    check(out.data.shape == (n, h, w, c), f"native batch {out.data.shape}")
    return res


class WaitTimed:
    """A training dataset whose ``data(train=True)`` iterator is timed:
    the seconds spent waiting in ``next`` (for the pipeline's batches)
    over the epoch's wall time, and the card's busy share under
    ``torch.profiler`` over FILES_BUSY_ITERATIONS iterations after
    FILES_WARMUP (a synchronize at each end; the profiler's processing
    stays outside the windows)."""

    def __init__(self, base):
        self.base = base
        self.stats = {"wait_s": 0.0, "wall_s": 0.0, "busy_s": 0.0,
                      "busy_wall_s": 0.0}

    def __getattr__(self, name):
        return getattr(self.base, name)

    def data(self, train: bool):
        if not train:
            return self.base.data(train)
        return self._timed(self.base.data(train))

    def _timed(self, it):
        from torch.profiler import ProfilerActivity, profile
        prof, t_prof, outside = None, 0.0, 0.0
        t0 = time.perf_counter()
        try:
            for i in itertools.count():
                if i == FILES_WARMUP:
                    t = time.perf_counter()
                    torch.cuda.synchronize()
                    prof = profile(activities=[ProfilerActivity.CUDA])
                    prof.start()
                    t_prof = time.perf_counter()
                    outside += t_prof - t
                elif prof is not None and i == FILES_WARMUP + \
                        FILES_BUSY_ITERATIONS:
                    t = time.perf_counter()
                    torch.cuda.synchronize()
                    self.stats["busy_wall_s"] = time.perf_counter() - t_prof
                    prof.stop()
                    self.stats["busy_s"] = sum(
                        e.self_device_time_total for e in prof.key_averages()
                        if e.self_device_time_total > 0) / 1e6
                    prof = None
                    outside += time.perf_counter() - t
                t = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                finally:
                    self.stats["wait_s"] += time.perf_counter() - t
                yield item
        finally:
            torch.cuda.synchronize()
            if prof is not None:
                prof.stop()
            self.stats["wall_s"] = time.perf_counter() - t0 - outside
            close = getattr(it, "close", None)   # an engine's threads
            if close is not None:
                close()


def files_inception_opt(argv: list):
    """``inception train ARGV --device cuda`` as the app builds it: its
    ``Optimizer``, not yet started."""
    from bigdl_tpu_torch.apps import inception as app
    return app.optimizer([*argv, "--device", "cuda"])[0]


def files_check_train(opt, what: str, iterations: int, val_count: int):
    losses = [h["loss"] for h in opt.history]
    check(len(losses) == iterations and np.isfinite(losses).all(),
          f"{what}: losses {losses}")
    (val,) = opt.validation_history
    got = {k: (r.correct, r.count) for k, r in val["results"].items()}
    check(set(got) == {"Top1Accuracy", "Top5Accuracy"}
          and all(c == val_count for _, c in got.values()),
          f"{what}: validation {got}")
    return losses, got


def files_check_blobs(model, blobs: dict) -> int:
    """The number of ``model``'s modules named in ``blobs`` whose weight
    (conv blobs OIHW, stored HWIO) and bias equal their blobs; raises at
    the first that does not."""
    n = 0
    for m in model.modules():
        b = blobs.get(m.get_name())
        if b is None or not hasattr(m, "weight"):
            continue
        w = b[0] if b[0].ndim == 2 else np.transpose(b[0], (2, 3, 1, 0))
        check(np.array_equal(m.weight.detach().cpu().numpy(), w)
              and np.array_equal(m.bias.detach().cpu().numpy(), b[1]),
              f"caffe layer {m.get_name()} is not its blob")
        n += 1
    return n


def files_check_state(model, saved: dict, what: str) -> None:
    state = model.state_dict()
    check(state.keys() == saved.keys()
          and all(torch.equal(state[k], saved[k]) for k in saved),
          f"{what}: the .t7 reloaded with other values")


def kaiming_blobs(model, rng) -> list:
    """Caffe layers for every named conv and linear of a port model, blobs
    drawn N(0, 2 / fan_in) (weights) and N(0, 0.01) (biases): conv
    (O, I/g, kH, kW), linear (out, in)."""
    from bigdl_tpu_torch import nn as tnn
    layers = []
    for m in model.modules():
        if isinstance(m, (tnn.SpatialConvolution, tnn.SpaceToDepthConv7)):
            fan_in = m.n_input_plane // m.n_group * m.kernel_h * m.kernel_w
            w = rng.normal(0, (2 / fan_in) ** 0.5,
                           (m.n_output_plane, m.n_input_plane // m.n_group,
                            m.kernel_h, m.kernel_w)).astype(np.float32)
            layers.append((m.get_name(), "Convolution", m, [
                w, rng.normal(0, 0.01, m.n_output_plane).astype(np.float32)]))
        elif isinstance(m, tnn.Linear):
            w = rng.normal(0, (2 / m.input_size) ** 0.5,
                           (m.output_size, m.input_size)).astype(np.float32)
            layers.append((m.get_name(), "InnerProduct", m, [
                w, rng.normal(0, 0.01, m.output_size).astype(np.float32)]))
    return layers


def write_caffemodel(path: str, layers: list) -> int:
    """A binary NetParameter (``layer`` = 100: name 1, type 2, blobs 7;
    BlobProto: shape 7 with packed dims, packed float data 5), written by
    hand; returns its bytes."""
    def varint(n):
        out = bytearray()
        while True:
            b, n = n & 0x7F, n >> 7
            out.append(b | (0x80 if n else 0))
            if not n:
                return bytes(out)

    def field(num, payload):
        return varint((num << 3) | 2) + varint(len(payload)) + payload
    with open(path, "wb") as f:
        for name, type_, _, blobs in layers:
            body = field(1, name.encode()) + field(2, type_.encode())
            for b in blobs:
                dims = b"".join(varint(d) for d in b.shape)
                body += field(7, field(7, field(1, dims))
                              + field(5, np.ascontiguousarray(
                                  b, "<f4").tobytes()))
            f.write(field(100, body))
    return os.path.getsize(path)


def deploy_prototxt(path: str, name: str, layers: list) -> None:
    """A deploy definition naming ``layers``' convs and linears."""
    lines = [f'name: "{name}"', 'input: "data"',
             "input_shape { dim: [1, 3, 227, 227] }"]
    for lname, type_, m, _ in layers:
        if type_ == "Convolution":
            param = (f"convolution_param {{ num_output: {m.n_output_plane} "
                     f"kernel_size: {m.kernel_h} stride: {m.stride_h} "
                     f"pad: {m.pad_h} group: {m.n_group} }}")
        else:
            param = f"inner_product_param {{ num_output: {m.output_size} }}"
        lines.append(f'layer {{ name: "{lname}" type: "{type_}" {param} }}')
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def files_inception(root: str, shards: str) -> dict:
    """(c) ``inception train --folder`` at full width (Inception v1, 1000
    classes, 224 crops, B=FILES_BATCH, one epoch of FILES_TRAIN images,
    then validation): ms an iteration after FILES_WARMUP, the busy and
    data-wait shares of the epoch; the same run on in-memory synthetic
    images as the control; then ``--caffeModel`` (a seeded caffemodel
    with Inception v1's layer names) and ``--torchModel`` (VGG-16 with
    FILES_CLASSES classes saved as ``.t7``), each on a small folder (the
    validation shards for both splits). Each file is also loaded by a
    direct ``load_caffe`` / ``load_torch`` call, timed; every parameter
    of that load and of the app's model equals its blob or its saved
    value."""
    import bigdl_tpu_torch.interop as interop
    from bigdl_tpu_torch.models import inception, vgg
    res = {}
    t = time.perf_counter()
    opt = files_inception_opt(["-f", shards, "-b", str(FILES_BATCH),
                               "-e", "1"])
    timed = opt.dataset = WaitTimed(opt.dataset)
    opt.optimize()
    res["folder_run_s"] = time.perf_counter() - t
    iterations = FILES_TRAIN // FILES_BATCH
    losses, top = files_check_train(opt, "inception --folder", iterations,
                                    FILES_VAL)
    seconds = [h["seconds"] for h in opt.history[FILES_WARMUP:]]
    st = timed.stats
    res.update(losses=losses, validation=top,
               ms_per_iteration=float(np.median(seconds)) * 1e3,
               busy_share=st["busy_s"] / max(st["busy_wall_s"], 1e-9),
               data_wait_share=st["wait_s"] / st["wall_s"],
               epoch_wall_s=st["wall_s"])
    # the control: the same step on in-memory synthetic images (no decode
    # threads, no prefetch)
    t = time.perf_counter()
    opt = files_inception_opt(["--synthetic-size", str(FILES_TRAIN), "-b",
                               str(FILES_BATCH), "-e", "1"])
    opt.optimize()
    res["synthetic_run_s"] = time.perf_counter() - t
    files_check_train(opt, "inception on synthetic images", iterations,
                      FILES_TRAIN)
    res["synthetic_ms_per_iteration"] = float(np.median(
        [h["seconds"] for h in opt.history[FILES_WARMUP:]])) * 1e3

    small = os.path.join(root, "small_shards")
    os.makedirs(small)
    for split in ("train", "val"):
        os.symlink(os.path.join(shards, "val"), os.path.join(small, split))
    small_argv = ["-f", small, "-b", str(FILES_BATCH), "-e", "1"]
    small_iters = FILES_VAL // FILES_BATCH

    rng = np.random.default_rng(FILES_SEED + 2)
    layers = kaiming_blobs(inception.build(1000, device="cpu"), rng)
    caffemodel = os.path.join(root, "inception.caffemodel")
    res["caffemodel_mb"] = write_caffemodel(caffemodel, layers) / 2 ** 20
    blobs = {name: b for name, _, _, b in layers}
    model = inception.build(1000, device="cuda")
    t = time.perf_counter()
    model = interop.load_caffe(model, caffemodel, match_all=False)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    n = files_check_blobs(model, blobs)
    del model
    opt = files_inception_opt([*small_argv, "--caffeModel", caffemodel])
    n_app = files_check_blobs(opt.model, blobs)
    check(n == n_app == len(layers),
          f"caffe: {n} (direct) and {n_app} (app) of {len(layers)} layers "
          "loaded")
    opt.optimize()
    res["caffe"] = {"layers": n, "load_s": load_s,
                    "losses": files_check_train(
                        opt, "inception --caffeModel", small_iters,
                        FILES_VAL)[0]}

    vgg16 = vgg.build_imagenet(FILES_CLASSES, depth=16, device="cuda",
                               seed=5)
    saved = {k: v.detach().clone() for k, v in vgg16.state_dict().items()}
    t7 = os.path.join(root, "vgg16.t7")
    t = time.perf_counter()
    interop.save_torch(vgg16, t7)
    res["t7_save_s"] = time.perf_counter() - t
    res["t7_mb"] = os.path.getsize(t7) / 2 ** 20
    del vgg16
    t = time.perf_counter()
    model = interop.load_torch(t7, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    files_check_state(model, saved, "load_torch")
    del model
    opt = files_inception_opt([*small_argv, "--torchModel", t7])
    files_check_state(opt.model, saved, "inception --torchModel")
    del saved
    opt.optimize()
    res["torch"] = {"load_s": load_s, "losses": files_check_train(
        opt, "inception --torchModel", small_iters, FILES_VAL)[0]}
    del opt
    torch.cuda.empty_cache()
    res["t7"] = t7
    return res


def files_logprob_err(model, x: np.ndarray) -> dict:
    """The card's log-probs of ``x`` against a CPU copy's (f32), over the
    largest |log-prob|: with TF32 off, as the phase runs, and on (the
    reading the limit must tell apart)."""
    import copy
    with torch.no_grad():
        want = copy.deepcopy(model).cpu()(torch.from_numpy(x))
        xc = torch.from_numpy(x).cuda()
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        res = {}
        try:
            for name, on in (("tf32_off", False), ("tf32_on", True)):
                torch.backends.cudnn.allow_tf32 = on
                torch.backends.cuda.matmul.allow_tf32 = on
                got = model(xc).cpu()
                res[name] = float((got - want).abs().max()
                                  / want.abs().max())
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
    return res


def files_validate(root: str, argv: list) -> dict:
    """``modelvalidator ARGV --device cuda`` in this process (its
    ``validator`` and ``evaluate``), on a copy of the validation folder
    arranged by the model's own ranking of each image: of every 4 (in path
    order), FILES_PLACED_RANKS name the class folder it is linked into, so
    Top-1 and Top-5 lie strictly between 0 and 64 (16 and 32 as placed).
    Both are held to the same model's argmax over the same batches on the
    card; one batch of 4 images on the card against a CPU copy (f32)."""
    import contextlib
    import io

    from bigdl_tpu_torch.apps import modelvalidator as mv
    t = time.perf_counter()
    args, model, ds = mv.validator([*argv, "--device", "cuda"])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    paths = [p for p, _ in mv.image_folder_paths(args.folder)]
    ranks, first = [], None
    model.eval()
    with torch.no_grad():
        for batch in ds.data(train=False):
            o = model(torch.from_numpy(batch.data).cuda())
            ranks.append(o.argsort(-1, descending=True).cpu() + 1)
            if first is None:
                first = batch.data[:4]
    ranks = torch.cat(ranks).tolist()
    check(len(ranks) == len(paths) == FILES_VAL
          and len(ranks[0]) == FILES_CLASSES,
          f"modelvalidator {argv}: {len(ranks)} rankings of "
          f"{len(ranks[0])} classes for {len(paths)} images")
    err = files_logprob_err(model, first)

    arranged = os.path.join(root, f"val_{args.modelName}")
    for c in range(FILES_CLASSES):
        os.makedirs(os.path.join(arranged, f"class_{c:02d}"))
    for i, (p, r) in enumerate(zip(paths, ranks)):
        cls = r[FILES_PLACED_RANKS[i % len(FILES_PLACED_RANKS)]]
        os.link(p, os.path.join(arranged, f"class_{cls - 1:02d}",
                                os.path.basename(p)))
    args.folder = arranged
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        results = mv.evaluate(args, model, mv.build_dataset(args))
    seconds = time.perf_counter() - t
    top1 = top5 = count = 0
    with torch.no_grad():
        for batch in mv.build_dataset(args).data(train=False):
            o = model(torch.from_numpy(batch.data).cuda())
            y = torch.from_numpy(batch.labels).cuda().long()
            top1 += int((o.argmax(-1) + 1 == y).sum())
            top5 += int((o.topk(5, -1).indices + 1 == y[:, None])
                        .any(-1).sum())
            count += len(y)
    res = {"printed": out.getvalue().strip().splitlines(),
           "top1": (results[0][0].correct, results[0][0].count),
           "top5": (results[1][0].correct, results[1][0].count),
           "load_s": load_s, "images_per_s": count / seconds,
           "card_cpu_logprob_rel_err": err["tf32_off"],
           "card_cpu_logprob_rel_err_tf32": err["tf32_on"]}
    check(res["top1"] == (top1, count) and res["top5"] == (top5, count)
          and count == FILES_VAL and 0 < top1 < count and 0 < top5 < count,
          f"modelvalidator {argv}: {res['top1']}, {res['top5']} against "
          f"argmax {top1}, {top5} of {count}")
    check(err["tf32_off"] <= FILES_LOGPROB_RTOL < err["tf32_on"],
          f"{argv}: card against CPU {err}, limit {FILES_LOGPROB_RTOL}")
    res["classes"] = {p: r[0] for p, r in zip(paths, ranks)}
    return res


def files_validators(root: str, tree: str, t7: str) -> dict:
    """(d) ``modelvalidator`` on the validation folder: ``-t torch -m
    vgg16`` (the .t7 of (c)), ``-t caffe -m alexnet --caffeDefPath`` (a
    seeded caffemodel with AlexNet's layer names and a deploy prototxt),
    ``-t bigdl -m resnet50`` (a ``file_io`` snapshot); and
    ``imageclassifier`` on the snapshot as a process of its own (started
    first, running beside the rest): its rows equal the validator's
    argmax."""
    from bigdl_tpu_torch.models import alexnet, resnet
    from bigdl_tpu_torch.utils import file_io
    val = os.path.join(tree, "val")
    res = {}
    snap = os.path.join(root, "resnet50_snapshot")
    file_io.save(_with_gates((), lambda: resnet.build(
        FILES_CLASSES, 50, device="cuda", seed=9)), snap)
    cls_log = open(os.path.join(root, "imageclassifier.log"), "w")
    t_cls = time.perf_counter()
    proc = text_cli(["bigdl_tpu_torch.apps.imageclassifier", "-f", val,
                     "-m", "resnet50", "-t", "bigdl", "--modelPath", snap,
                     "-b", str(FILES_BATCH), "--device", "cuda"],
                    stdout=subprocess.PIPE, stderr=cls_log, text=True)
    try:
        res["vgg16_torch"] = files_validate(
            root, ["-f", val, "-m", "vgg16", "-t", "torch", "--modelPath",
                   t7, "-b", str(FILES_BATCH)])
        rng = np.random.default_rng(FILES_SEED + 3)
        layers = kaiming_blobs(alexnet.build(FILES_CLASSES, device="cpu"),
                               rng)
        model_path = os.path.join(root, "alexnet.caffemodel")
        res["alexnet_caffemodel_mb"] = write_caffemodel(
            model_path, layers) / 2 ** 20
        deploy = os.path.join(root, "deploy.prototxt")
        deploy_prototxt(deploy, "AlexNet", layers)
        res["alexnet_caffe"] = files_validate(
            root, ["-f", val, "-m", "alexnet", "-t", "caffe",
                   "--caffeDefPath", deploy, "--modelPath", model_path,
                   "--classNum", str(FILES_CLASSES), "-b", str(FILES_BATCH)])
        res["resnet50_bigdl"] = files_validate(
            root, ["-f", val, "-m", "resnet50", "-t", "bigdl", "--modelPath",
                   snap, "-b", str(FILES_BATCH)])
        out, _ = proc.communicate(timeout=CLI_TIMEOUT_S)
        res["imageclassifier_s"] = time.perf_counter() - t_cls
        check(proc.returncode == 0, f"imageclassifier: rc {proc.returncode}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        cls_log.close()
    rows = dict(line.split("\t") for line in out.strip().splitlines())
    want = res["resnet50_bigdl"]["classes"]
    check(rows.keys() == want.keys()
          and all(int(rows[p]) == want[p] for p in want),
          "imageclassifier's rows differ from the validator's argmax")
    res["imageclassifier_rows"] = len(rows)
    for r in res.values():
        if isinstance(r, dict):
            r.pop("classes", None)
    return res


def files_texts(root: str, bundle: str) -> dict:
    """(e) ``udfpredictor`` over FILES_TEXTS seeded text files with the
    classifier bundle: its classes equal the model's argmax computed
    directly, ``make_udf`` agrees, and ``--watch`` classifies a file
    written after its first poll exactly once."""
    import contextlib
    import io

    from bigdl_tpu_torch.apps import udfpredictor as udf
    from bigdl_tpu_torch.apps.textclassifier import tokenize
    from bigdl_tpu_torch.utils import file_io
    loaded = file_io.load(bundle, device="cuda")
    words = sorted(loaded["word2index"])
    rng = np.random.default_rng(FILES_SEED + 4)
    folder = os.path.join(root, "texts")
    os.makedirs(folder)
    texts = []
    for i in range(FILES_TEXTS):
        text = " ".join(rng.choice(words, size=int(rng.integers(50, 400))))
        texts.append(text)
        with open(os.path.join(folder, f"t{i:03d}.txt"), "w") as f:
            f.write(text)
    to_indexed, embed = udf._bundle_pipeline(loaded)
    feats = np.stack([s.feature for s in embed(to_indexed(
        (tokenize(t), 0.0) for t in texts))])
    model = loaded["model"].eval()
    with torch.no_grad():
        direct = torch.cat([
            model(torch.from_numpy(feats[i:i + 32]).cuda())
            .argmax(-1) + 1 for i in range(0, len(feats), 32)]).tolist()
    t = time.perf_counter()
    predicted = udf.predict_texts(loaded, texts, 32, "cuda")
    res = {"texts_per_s": len(texts) / (time.perf_counter() - t)}
    check(predicted == direct, "predict_texts differs from the argmax")
    fn = udf.make_udf(loaded, "cuda")
    check([fn(t) for t in texts[:8]] == direct[:8], "make_udf")

    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rows = udf.run(["--modelPath", bundle, "-f", folder, "-b", "32",
                        "--device", "cuda"])
    res["run_s"] = time.perf_counter() - t
    check([c for _, c in rows] == direct
          and len(out.getvalue().splitlines()) == FILES_TEXTS,
          "udfpredictor run: classes differ from the argmax")

    watch_dir = os.path.join(root, "watched")
    os.makedirs(watch_dir)
    for i in range(3):
        with open(os.path.join(watch_dir, f"t{i}.txt"), "w") as f:
            f.write(texts[i])
    first_poll = threading.Event()
    watched = {}

    def watch():
        with contextlib.redirect_stdout(io.StringIO()):
            watched["rows"] = udf.run(
                ["--modelPath", bundle, "-f", watch_dir, "--watch",
                 "--pollSeconds", "0.2", "--device", "cuda"],
                max_polls=4, on_poll=lambda rows: first_poll.set())
    thread = threading.Thread(target=watch)
    thread.start()
    check(first_poll.wait(120), "udfpredictor --watch: no first poll")
    with open(os.path.join(watch_dir, "late.txt"), "w") as f:
        f.write(texts[3])
    thread.join(120)
    names = [os.path.basename(p) for p, _ in watched.get("rows", [])]
    check(names == ["t0.txt", "t1.txt", "t2.txt", "late.txt"]
          and watched["rows"][-1][1] == direct[3],
          f"udfpredictor --watch: {watched.get('rows')}")
    return res


def files_bundle(root: str) -> str:
    """Phase 3l's classifier bundle, or (alone, ``--files-only``) one
    trained here at the textclassifier's defaults for one epoch."""
    if TEXT_BUNDLE.get("path"):
        return TEXT_BUNDLE["path"]
    from bigdl_tpu_torch.apps import textclassifier as tc_app
    opt, _, prepared = tc_app.optimizer([
        "--maxSequenceLength", "1000", "--embeddingDim", "100", "-b", "128",
        "-e", "1", "--device", "cuda"])
    opt.optimize()
    return save_classifier_bundle(opt.model, prepared)


def run_files() -> dict:
    """Phase 3m: model files and image ingestion; logs one
    ``model_files`` line and a ``model_files_details`` line."""
    import tempfile

    from bigdl_tpu_torch import native
    t0 = time.perf_counter()
    native.reset_counts()
    row = {}
    try:
        with tempfile.TemporaryDirectory() as root:
            tree = files_tree(root)
            crc_data = np.random.default_rng(FILES_SEED + 5).bytes(
                FILES_CRC_BYTES)
            crc_path = os.path.join(root, "crc.bin")
            with open(crc_path, "wb") as f:
                f.write(crc_data)
            shards = os.path.join(root, "shards")
            # two processes beside (a): the shard generator and the
            # byte-wise CRC32C over the same 64 MiB
            t_gen = time.perf_counter()
            gen = text_cli(["bigdl_tpu_torch.apps.seqfilegen", "-f", tree,
                            "-o", shards, "-p", "4", "-b", "64"],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
            crc_proc = subprocess.Popen(
                [sys.executable, "-c", "import sys; from bigdl_tpu_torch."
                 "native import crc32c_plain; print(crc32c_plain(open("
                 "sys.argv[1], 'rb').read()))", crc_path],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            try:
                row["native"] = files_native(root, crc_path, crc_data)
                gen_out, _ = gen.communicate(timeout=CLI_TIMEOUT_S)
                row["seqfilegen_s"] = time.perf_counter() - t_gen
                check(gen.returncode == 0
                      and f"packed {FILES_TRAIN + FILES_VAL} records"
                      in gen_out, f"seqfilegen: {gen_out[-1500:]}")
                raw = row["native"].pop("raw")
                row["records"] = files_records(tree, shards, raw)
                del raw
                row["inception"] = files_inception(root, shards)
                t7 = row["inception"].pop("t7")
                row["validators"] = files_validators(root, tree, t7)
                row["udf"] = files_texts(root, files_bundle(root))
                crc_out, _ = crc_proc.communicate(timeout=CLI_TIMEOUT_S)
                check(crc_proc.returncode == 0 and int(crc_out.strip())
                      == row["native"]["crc32c"],
                      f"the byte-wise CRC32C: {crc_out[-500:]}")
            finally:
                for proc in (gen, crc_proc):
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
    finally:
        if TEXT_BUNDLE.get("dir"):
            shutil.rmtree(TEXT_BUNDLE.pop("dir"), ignore_errors=True)
            TEXT_BUNDLE.clear()
    counts = native.counts()
    check(all(n > 0 for n in counts.values()),
          f"an entry point of the host library was not called: {counts}")
    inc, val = row["inception"], row["validators"]
    log({"model_files": {
        "library_built_in_this_run":
            os.path.getmtime(row["native"]["library"]["path"]) >= RUN_T0,
        "library_built_by_this_process": row["native"]["library"]["built"],
        "library_build_s": row["native"]["library"]["seconds"],
        "shards_mb": row["records"]["shards_mb"],
        "seqfilegen_s": row["seqfilegen_s"],
        "decode_pil_images_per_s": row["records"]["decode_pil_images_per_s"],
        "decode_native_batch_images_per_s":
            row["records"]["decode_native_batch_images_per_s"],
        "inception_ms_per_iteration": inc["ms_per_iteration"],
        "inception_busy_share": inc["busy_share"],
        "inception_data_wait_share": inc["data_wait_share"],
        "inception_synthetic_ms_per_iteration":
            inc["synthetic_ms_per_iteration"],
        "caffemodel_load_s": inc["caffe"]["load_s"],
        "t7_load_s": inc["torch"]["load_s"],
        "validator_images_per_s": {k: v["images_per_s"]
                                   for k, v in val.items()
                                   if isinstance(v, dict)},
        "udf_texts_per_s": row["udf"]["texts_per_s"],
        "native_calls": counts,
        "phase_s": time.perf_counter() - t0}})
    log({"model_files_details": row})
    return row



# ------------------------------------------------------- 3n. platform planes
PLAT_SEED = 61
PLAT_RECORDS, PLAT_PER_SHARD, PLAT_BATCH = 4096, 512, 256
PLAT_ITERS, PLAT_WARMUP = 14, 2       # 12 timed iterations after 2
PLAT_FIRST = 4                        # batches held against the serial path
PLAT_PROFILE = (5, 3)                 # set_profiling's first iteration, count
PLAT_PROFILE_ITERS = 8
PLAT_BUDGET_S = 2.0                   # each ingest_bench measuring mode
PLAT_CKPT_STEPS, PLAT_CKPT_AT = 12, 8
PLAT_SB_REQUESTS = 16                 # requests a scoreboard row
PLAT_SB_MODEL = ["--vocab", str(VOCAB), "--embed", "768", "--heads", "12",
                 "--ffn", "3072", "--layers", "12", "--prefill-chunk", "128",
                 "--max-new", "32", "--lmin", "16", "--lmax", "384"]
PLAT_MFU_FLOPS_RTOL = 0.15            # counted step FLOPs against 3x forward
#: phase 3h's plain 134m snapshot (MB, save and load seconds), for 3n's line
PLAIN_SNAPSHOT = {}


#: seconds of each CLI call of phase 3n, by its first arguments
PLAT_CLI_S = {}


def plat_cli(module: str, *args, timeout: float = CLI_TIMEOUT_S) -> str:
    """``python -m MODULE ARGS`` from the repository's root; raises on a
    non-zero exit; returns its standard output."""
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", module, *map(str, args)],
                       cwd=os.path.dirname(os.path.abspath(__file__)),
                       capture_output=True, text=True, timeout=timeout)
    PLAT_CLI_S[f"{module.split('.')[-1]} {args[0]}"] = time.perf_counter() - t
    check(r.returncode == 0, f"{module} {' '.join(map(str, args))}: "
          f"exit {r.returncode}: {r.stdout[-800:]} {r.stderr[-1500:]}")
    return r.stdout


def plat_bench(*args) -> dict:
    """``ingest_bench.main(ARGS)`` in this process (its CLI without a
    process's start-up); its JSON line."""
    import contextlib
    import io

    from bigdl_tpu_torch.apps import ingest_bench
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        ingest_bench.main([str(a) for a in args])
    PLAT_CLI_S[f"ingest_bench {args[0]}"] = time.perf_counter() - t
    return json.loads(out.getvalue().strip().splitlines()[-1])


class FirstBatches:
    """A training dataset that keeps host copies of the first ``n`` batches
    its ``data(train=True)`` hands out, each copied when the next one is
    asked for (the step that read it dispatched by then), so a batch the
    feed's copy or the allocator damaged while the step used it shows."""

    def __init__(self, base, n: int):
        self.base, self.n, self.host = base, n, []

    def __getattr__(self, name):
        return getattr(self.base, name)

    def data(self, train: bool):
        if not train:
            return self.base.data(train)
        return self._kept(self.base.data(train))

    def _kept(self, it):
        held = None
        try:
            for batch in it:
                if held is not None:
                    self.host.append(held)
                    held = None
                if len(self.host) < self.n:
                    held = (batch.data, batch.labels)
                yield batch
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def host_arrays(self) -> list:
        return [tuple(t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
                      for t in pair) for pair in self.host]


def plat_registry():
    from bigdl_tpu_torch.telemetry import (MetricsRegistry, get_registry,
                                           set_registry)
    reg, prev = MetricsRegistry(), get_registry()
    set_registry(reg)
    return reg, lambda: set_registry(prev)


def plat_optimizer(shards: str, iterations: int):
    """``ingest_bench train``'s run, fed by the staged engine (both fusion
    gates, ``--deviceNormalize``, bf16, SGD 0.01), before it starts."""
    from bigdl_tpu_torch.apps import ingest_bench
    return _with_gates(FUSION_GATES, lambda: ingest_bench.optimizer([
        "-s", shards, "-b", str(PLAT_BATCH), "-w", "4", "--engine",
        "pipelined", "--workers", "2", "--prefetch-depth", "2",
        "--deviceNormalize", "-i", str(iterations), "--warmup",
        str(PLAT_WARMUP), "--device", "cuda"]))


def resnet50_train_flops(b: int) -> float:
    """Three times ResNet-50's forward operations at batch b (2 per
    multiply-add of every conv and the classifier): the usual count of one
    training step, forward, data gradient and weight gradient."""
    ones, threes = resnet50_convs(b)
    fwd = 2 * b * 112 * 112 * 7 * 7 * 3 * 64                  # the stem
    fwd += sum(2 * n * ((h + s - 1) // s) * ((w + s - 1) // s) * ci * co
               for n, h, w, ci, co, s in ones)
    fwd += sum(2 * n * h * w * 9 * ci * co for n, h, w, ci, co in threes)
    hw = 56
    for stage, width in enumerate(RESNET_WIDTHS[1:]):         # stride-2 3x3s
        hw //= 2
        fwd += 2 * b * hw * hw * 9 * width * width
    fwd += 2 * b * 2048 * 1000
    return 3.0 * fwd


def plat_ingest(root: str) -> tuple:
    """(a), first half: the corpus and ``ingest_bench``'s measuring modes
    through its ``main``; the pipelined run's Chrome trace is validated by
    ``python -m bigdl_tpu_torch.telemetry trace``."""
    shards = os.path.join(root, "shards")
    res = {"generate": plat_bench("generate", "-o", shards, "-n",
                                  PLAT_RECORDS, "--perShard", PLAT_PER_SHARD)}
    res["shards_mb"] = sum(os.path.getsize(os.path.join(shards, f))
                           for f in os.listdir(shards)) / 1e6
    res["read"] = plat_bench("read", "-s", shards, "--budget",
                             PLAT_BUDGET_S)
    res["decode"] = plat_bench("decode", "-s", shards, "-w", 4,
                               "--budget", PLAT_BUDGET_S)
    art, trace = (os.path.join(root, f) for f in ("ingest.json",
                                                  "ingest_trace.json"))
    plat_bench("pipeline", "-s", shards, "--engine", "both",
               "--workers", 2, "--prefetch-depth", 2, "--budget",
               PLAT_BUDGET_S, "--jsonOut", art, "--traceOut", trace)
    with open(art) as f:
        pipe = json.load(f)
    res["pipeline"] = {k: pipe.get(k) for k in ("serial", "pipelined",
                                                "speedup")}
    out = plat_cli("bigdl_tpu_torch.telemetry", "trace", trace)
    check("valid Chrome trace" in out and "ingest.read_shard" in out
          and "ingest.decode" in out and "ingest.device_put" in out,
          f"the pipeline's trace: {out[-800:]}")
    check(all(res[m]["records_per_sec"] > 0 for m in ("read", "decode"))
          and pipe["pipelined"]["records_per_sec"] > 0
          and pipe["serial"]["records_per_sec"] > 0,
          f"ingest_bench rates: {res}")
    return shards, res


def plat_train(shards: str) -> dict:
    """(a), second half: ``train`` fed by the pipelined engine (ResNet-50
    B=256, both gates, PLAT_ITERS iterations), its first PLAT_FIRST batches
    held bit for bit against the serial path's, launch and compile counts,
    busy and data-wait shares, stalls by stage; then the same step on one
    in-memory batch; (b) a run under ``set_profiling``."""
    from bigdl_tpu_torch.dataset.base import DataSet, MiniBatch
    from bigdl_tpu_torch.dataset.image import NativeBGRBatchDecoder
    from bigdl_tpu_torch.dataset.ingest import PrefetchingDataSet
    from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    from bigdl_tpu_torch.telemetry import instruments
    from bigdl_tpu_torch.telemetry.profiling import peak_flops
    from bigdl_tpu_torch.utils.rng import RandomGenerator
    counters = conv_bn_counters()
    res = {}
    reg, restore = plat_registry()
    try:
        RandomGenerator.RNG().set_seed(PLAT_SEED)
        opt, args = plat_optimizer(shards, PLAT_ITERS)
        first = FirstBatches(opt.dataset, PLAT_FIRST)
        waits = opt.dataset = WaitTimed(first)
        for c in counters:
            c.reset()
        t = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize()
        res["run_s"] = time.perf_counter() - t
        got = [c.value for c in counters]
        tm = instruments(reg)
        stalls = {lv[0]: c.value
                  for lv, c in tm.ingest_stall_seconds_total.children()}
        step_compiles = tm.compiles_total.labels(site="train.step").value
        mfu_a = tm.train_mfu.labels(mode="local").value
        flops_a = tm.program_flops.labels(site="train.step").value
    finally:
        restore()
    # the gauge holds the last window's: its program FLOPs over its time
    want = flops_a / opt.history[-1]["seconds"] / peak_flops()
    check(abs(mfu_a - want) <= 1e-9 * want,
          f"(a) bigdl_train_mfu {mfu_a} against the last iteration's {want}")
    n = PLAT_ITERS
    want = [K5_PER_STEP * n] * 2 + [K6_PER_STEP * n] * 2
    check(got == want, f"(a) launches K5, K5 mma, K6, K6 mma {got}, want "
          f"{want}")
    total = list(got)
    check(step_compiles == 1, f"(a) train.step compiled {step_compiles} "
          "times")
    losses = [h["loss"] for h in opt.history]
    check(len(losses) == n and np.isfinite(losses).all(),
          f"(a) losses {losses}")
    RandomGenerator.RNG().set_seed(PLAT_SEED)
    serial = PrefetchingDataSet.from_folder(
        shards, transformer=NativeBGRBatchDecoder(
            224, 224, PLAT_BATCH, mean=(127.5,) * 3, std=(73.0,) * 3,
            workers=4, device_normalize=True), serial=True)
    serial.shuffle()
    it = iter(serial.data(train=True))
    host = [next(it) for _ in range(PLAT_FIRST)]
    fed = first.host_arrays()
    check(len(fed) == PLAT_FIRST and all(
        np.array_equal(d, h.data) and np.array_equal(y, h.labels)
        for (d, y), h in zip(fed, host)),
        "(a) the engine's first batches on the card differ from the serial "
        "path's")
    seconds = [h["seconds"] for h in opt.history[PLAT_WARMUP:]]
    st = waits.stats
    res.update(
        losses=losses, first_batches_bit_equal=PLAT_FIRST,
        launches_per_step={"K5": got[0] / n, "K6": got[2] / n},
        train_step_compiles=step_compiles,
        ms_per_iteration=float(np.median(seconds)) * 1e3,
        records_per_s=PLAT_BATCH / float(np.median(seconds)),
        busy_share=st["busy_s"] / max(st["busy_wall_s"], 1e-9),
        data_wait_share=st["wait_s"] / st["wall_s"],
        stall_s=stalls, mfu=mfu_a, step_flops=flops_a)
    # the control: the same step on one in-memory batch (no engine threads)
    batch = MiniBatch(host[0].data, host[0].labels)
    control = (Optimizer(opt.model, DataSet.array([batch] * n, seed=0),
                         ClassNLLCriterion(), device="cuda")
               .set_precision("bf16").set_optim_method(SGD(learningrate=0.01))
               .set_end_when(Trigger.max_iteration(n)))
    for c in counters:
        c.reset()
    control.optimize()
    torch.cuda.synchronize()
    got = [c.value for c in counters]
    check(got == want, f"the control's launches {got}, want {want}")
    total = [a + b for a, b in zip(total, got)]
    res["in_memory_ms_per_iteration"] = float(np.median(
        [h["seconds"] for h in control.history[PLAT_WARMUP:]])) * 1e3
    del control, opt, first, waits
    torch.cuda.empty_cache()

    # (b) set_profiling over iterations 5-7 of a short engine-fed run
    pdir = os.path.join(os.path.dirname(shards), "profile")
    reg, restore = plat_registry()
    try:
        opt, _ = plat_optimizer(shards, PLAT_PROFILE_ITERS)
        opt.set_profiling(pdir, *PLAT_PROFILE)
        for c in counters:
            c.reset()
        opt.optimize()
        torch.cuda.synchronize()
        got = [c.value for c in counters]
        tm = instruments(reg)
        mfu = tm.train_mfu.labels(mode="local").value
        flops = tm.program_flops.labels(site="train.step").value
    finally:
        restore()
    with open(os.path.join(pdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    ranges = sorted({e["name"] for e in events
                     if str(e.get("name", "")).startswith("iteration")})
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    want_ranges = sorted(f"iteration {i}" for i in range(
        PLAT_PROFILE[0], PLAT_PROFILE[0] + PLAT_PROFILE[1]))
    check(ranges == want_ranges, f"(b) the trace's iterations {ranges}, "
          f"want {want_ranges}")
    check(any("matmul_stats" in k for k in kernels)
          and any("conv3x3_stats" in k for k in kernels),
          "(b) K5's or K6's kernels are not in the trace")
    want = [K5_PER_STEP * PLAT_PROFILE_ITERS] * 2 + \
        [K6_PER_STEP * PLAT_PROFILE_ITERS] * 2
    check(got == want, f"(b) launches {got}, want {want}")
    total = [a + b for a, b in zip(total, got)]
    res["conv_launches"] = dict(zip(("matmul_bn", "matmul_bn_mma",
                                     "conv3x3_bn", "conv3x3_bn_mma"), total))
    formula = resnet50_train_flops(PLAT_BATCH)
    check(mfu > 0 and flops > 0, f"(b) bigdl_train_mfu {mfu}, flops {flops}")
    check(abs(flops / formula - 1) <= PLAT_MFU_FLOPS_RTOL,
          f"(b) the step's counted FLOPs {flops} against 3x forward "
          f"{formula}")
    modules = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    res["profile"] = {
        "iterations": ranges, "trace_mb":
            os.path.getsize(os.path.join(pdir, "trace.json")) / 1e6,
        "module_ranges": len(modules - set(ranges)),
        # the last window's: its interval holds the profiler's export
        "mfu_last_window": mfu, "step_flops": flops,
        "step_flops_formula": formula,
        "formula": "3 x forward; forward = 2 x the multiply-adds of the "
                   "stem, every 1x1 and 3x3 conv and the classifier at B=256",
        "peak_flops": peak_flops()}
    shutil.rmtree(pdir, ignore_errors=True)
    del opt
    torch.cuda.empty_cache()
    return res


def plat_lm_optimizer(model, d: str):
    """Phase 3b's recipe (B=8, S=512, bf16, AdamW, L2 clip 1.0) with the
    moments in bf16, PLAT_CKPT_STEPS iterations, a sharded snapshot every
    PLAT_CKPT_AT."""
    from bigdl_tpu_torch.apps.transformer import synthetic_corpus
    from bigdl_tpu_torch.dataset.base import DataSet, SampleToBatch
    from bigdl_tpu_torch.nn.criterion import FusedLMHeadCriterion
    from bigdl_tpu_torch.optim import AdamW, Optimizer, Trigger
    if "train" not in _CKPT_DATA:
        _CKPT_DATA["train"] = synthetic_corpus(TRAIN_BATCH * TRAIN_STEPS,
                                               TRAIN_SEQ, VOCAB, seed=17)
    ds = DataSet.array(_CKPT_DATA["train"], seed=0) \
        >> SampleToBatch(TRAIN_BATCH)
    return (Optimizer(model, ds, FusedLMHeadCriterion(), device="cuda")
            .set_precision("bf16")
            .set_optim_method(AdamW(learningrate=TRAIN_LR,
                                    weightdecay=TRAIN_DECAY,
                                    state_dtype="bfloat16"))
            .set_gradient_clipping_by_l2_norm(TRAIN_CLIP)
            .set_end_when(Trigger.max_iteration(PLAT_CKPT_STEPS))
            .set_checkpoint(d, Trigger.several_iteration(PLAT_CKPT_AT),
                            sharded=True))


def plat_sharded(root: str) -> tuple:
    """(c) The 134m run snapshotted sharded at PLAT_CKPT_AT of
    PLAT_CKPT_STEPS, resumed in a fresh optimizer over other initial
    weights: the resumed iterations bit-equal to the uninterrupted run;
    ``resilience validate`` and ``latest`` accept the pair and refuse it
    after ``chaos corrupt``."""
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.utils.sharded_checkpoint import read_manifest
    d = os.path.join(root, "sharded")
    counters = flash_counters()
    for c in counters.values():
        c.reset()
    model = build_lm(VOCAB, **CONFIG, device="cuda", seed=7)
    opt = plat_lm_optimizer(model, d)
    with SaveLoadTimes() as times:
        opt.optimize()
        torch.cuda.synchronize()
    full = [h["loss"] for h in opt.history]
    crcs = param_crcs(model)
    save_s = list(times.save)
    del model, opt
    model8, state8 = (os.path.join(d, f"{k}.{PLAT_CKPT_AT}")
                      for k in ("model", "state"))
    mb = sum(os.path.getsize(os.path.join(p, f)) for p in (model8, state8)
             for f in os.listdir(p)) / 1e6
    bf16_leaves = sum(v["dtype"] == "bfloat16"
                      for v in read_manifest(state8)[0].values())
    check(bf16_leaves > 0, "(c) the snapshot holds no bf16 moment")
    model = build_lm(VOCAB, **CONFIG, device="cuda", seed=RESUME_SEED)
    opt = plat_lm_optimizer(model, d).auto_resume()
    with SaveLoadTimes() as times:
        opt.optimize()
        torch.cuda.synchronize()
    load_s = list(times.load)
    nevals = [h["neval"] for h in opt.history]
    resumed = [h["loss"] for h in opt.history]
    # the snapshot tagged N holds the state after iteration N - 1 (the
    # trigger sees the next iteration's neval), so the resumed run trains
    # iterations N..PLAT_CKPT_STEPS
    check(nevals == list(range(PLAT_CKPT_AT, PLAT_CKPT_STEPS + 1))
          and resumed == full[PLAT_CKPT_AT - 1:],
          f"(c) resumed iterations {nevals} losses {resumed}, the "
          f"uninterrupted run's {full[PLAT_CKPT_AT - 1:]}")
    check(param_crcs(model) == crcs, "(c) the resumed run's final "
          "parameters differ from the uninterrupted run's")
    del model, opt
    launches = {k: c.value for k, c in counters.items()}
    n = CONFIG["num_layers"] * (len(full) + len(resumed))
    check(launches == all_mma_launches(n),
          f"(c) K1-K3 launches {launches}, want {n} each, all mma")
    # the CLI: validate and latest accept the pair, refuse it once damaged
    lines = resilience_cli("validate", d).stdout.splitlines()
    check(len(lines) == 1 and lines[0].startswith("complete")
          and f"model.{PLAT_CKPT_AT} / state.{PLAT_CKPT_AT}" in lines[0]
          and "sharded" in lines[0], f"(c) validate: {lines}")
    latest = resilience_cli("latest", d)
    check(latest.returncode == 0 and latest.stdout.split() == [model8, state8],
          f"(c) latest: {latest.stdout!r} {latest.stderr[-500:]}")
    r = resilience_cli("chaos", "corrupt", model8, "--seed", "5")
    check(r.returncode == 0, f"(c) chaos corrupt: {r.stderr[-800:]}")
    r = resilience_cli("validate", d)
    after = r.stdout.splitlines()
    check(r.returncode == 1 and after and after[0].startswith("PARTIAL")
          and resilience_cli("latest", d).returncode == 1,
          f"(c) validate and latest after the corruption: {after}")
    shutil.rmtree(d)
    return {"snapshot_mb": mb, "bf16_leaves": bf16_leaves, "save_s": save_s,
            "load_s": load_s, "resumed_bit_equal": len(resumed),
            "validate": lines, "latest": latest.stdout.split(),
            "validate_after_corrupt": after,
            "plain_3h": dict(PLAIN_SNAPSHOT) or None}, launches


def plat_scoreboard(root: str) -> tuple:
    """(d) ``python -m bigdl_tpu_torch.telemetry scoreboard`` at the 134m
    width (no GQA or SwiGLU in its builder, f32): slots 8 and 16 on the
    Zipf workload, the shared-prefix workload at 8, the int8 twin as
    draft at 8; each row's compile counts against the structure; ``diff``
    against the artifact itself (exit 0) and against a copy with tok/s cut
    by 30% (exit 1); ``scrape`` of a live server's ``/metrics``."""
    import threading

    from bigdl_tpu_torch.models.lm_server import make_http_server
    from bigdl_tpu_torch.models.serving import ContinuousLMServer
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.telemetry import MetricsRegistry
    from bigdl_tpu_torch.telemetry import __main__ as telemetry_cli
    from bigdl_tpu_torch.telemetry import scoreboard
    from bigdl_tpu_torch.models.serving import _PREFILL_BUCKET_LO
    from bigdl_tpu_torch.utils.util import pow2_bucket
    base = ["scoreboard", *PLAT_SB_MODEL, "--requests",
            str(PLAT_SB_REQUESTS), "--clients", "8", "--device", "cuda"]
    # the Zipf rows prefill bucketed: a cold causal prefill of each prompt
    # padded to its power-of-two bucket, which is K1's; the chunked prefill
    # (the prefix cache's mode) runs the masked warm-cache attention
    runs = {"zipf": ["--slots", "8,16", "--prefill-mode", "bucketed"],
            "shared_prefix": ["--workload", "shared-prefix", "--templates",
                              "4", "--template-len", "256", "--slots", "8"],
            "int8_draft": ["--draft", "int8", "--slots", "8"]}
    # the structure of a row's compiles: per model served (the target, and
    # the draft) the chunked prefill's two programs, or one a bucket the
    # prompts reach, and its slot insert; then the server's one round
    # program (serving.step or serving.spec_step)
    zipf = scoreboard.ScoreboardConfig(requests=PLAT_SB_REQUESTS, lmin=16,
                                       lmax=384, max_new=32)
    buckets = {pow2_bucket(len(p), min(_PREFILL_BUCKET_LO, zipf.max_len),
                           zipf.max_len)
               for p in scoreboard.make_prompts(zipf)}
    want_compiles = {"zipf": len(buckets) + 2, "shared_prefix": 4,
                     "int8_draft": 7}
    launches = collections.defaultdict(int)
    res, paths = {}, {}
    for name, extra in runs.items():
        paths[name] = os.path.join(root, f"scoreboard_{name}.json")
        rc, (k1, k1_mma, k4, _) = counted(launches, lambda: telemetry_cli.main(
            [*base, *extra, "--out", paths[name]]))
        check(rc == 0, f"(d) scoreboard {name} exited {rc}")
        art = scoreboard.load_artifact(paths[name])
        want = want_compiles[name]
        for row in art["rows"]:
            check(row["failed"] == 0 and row["requests"] == PLAT_SB_REQUESTS
                  and row["compiles"] == want and row["tok_s"] > 0,
                  f"(d) {name} row {row}, want {want} compiles")
        check((k1 > 0) == (name == "zipf")
              and (k4 > 0) == (name == "int8_draft"),
              f"(d) {name}: K1 {k1}, K4 {k4} launches")
        res[name] = {"rows": art["rows"], "k1": k1, "k1_mma": k1_mma,
                     "k4": k4, "compiles_structure": want}
        log({"scoreboard_markdown": name,
             "table": scoreboard.render_markdown(art)})
    cli = "bigdl_tpu_torch.telemetry"
    zipf = paths["zipf"]
    plat_cli(cli, "scoreboard", "diff", zipf, zipf)
    with open(zipf) as f:
        slower = json.load(f)
    for row in slower["rows"]:
        row["tok_s"] *= 0.7
    slow_path = os.path.join(root, "scoreboard_slower.json")
    with open(slow_path, "w") as f:
        json.dump(slower, f)
    r = subprocess.run([sys.executable, "-m", cli, "scoreboard", "diff",
                        zipf, slow_path],
                       cwd=os.path.dirname(os.path.abspath(__file__)),
                       capture_output=True, text=True, timeout=120)
    check(r.returncode == 1 and "tok/s" in r.stderr,
          f"(d) diff against a 30% slower copy: exit {r.returncode} "
          f"{r.stderr[-500:]}")
    res["diff_exit_codes"] = [0, r.returncode]
    # scrape: a live server's /metrics into a one-row artifact
    model = build_lm(512, embed_dim=768, num_heads=12, ffn_dim=3072,
                     num_layers=2, max_len=128, rope=True, norm="rms",
                     device="cuda", seed=3)
    server = ContinuousLMServer(model, slots=2, max_len=128, greedy=True,
                                max_new_tokens=4, registry=MetricsRegistry(),
                                device="cuda")
    http = make_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=http.serve_forever, daemon=True)
    thread.start()
    try:
        for i in range(3):
            server.submit([1 + i, 2, 3, 4], 4, timeout=120)
        scraped = os.path.join(root, "scraped.json")
        plat_cli(cli, "scoreboard", "scrape",
                 f"http://127.0.0.1:{http.server_address[1]}", "--out",
                 scraped)
        with open(scraped) as f:
            art = json.load(f)
    finally:
        http.shutdown()
        http.server_close()
        thread.join(timeout=30)
        server.close()
    (row,) = art["rows"]
    check(row["requests"] == 3 and row["slots"] == 2 and row["tokens"] > 0,
          f"(d) the scraped row {row}")
    res["scrape"] = {k: row[k] for k in ("slots", "requests", "tokens",
                                         "compiles", "ttft_p50_s")}
    del model
    torch.cuda.empty_cache()
    return res, launches


def run_platform() -> dict:
    """Phase 3n: the platform planes (ingest, tracked programs and
    profiling, sharded snapshots, the scoreboard); logs one
    ``platform_planes`` line and returns the launches of K1-K6 for the
    ``kernels`` line."""
    import tempfile
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="bigdl_platform_")
    stamps = {}
    try:
        shards, ingest = plat_ingest(root)
        stamps["a_cli"] = time.perf_counter() - t0
        log({"platform_ingest_cli": ingest, "at_s": stamps["a_cli"]})
        train = plat_train(shards)
        stamps["a_b_train"] = time.perf_counter() - t0
        log({"platform_train": {k: v for k, v in train.items()
                                if k != "losses"},
             "at_s": stamps["a_b_train"]})
        shutil.rmtree(shards)
        sharded, flash = plat_sharded(root)
        stamps["c"] = time.perf_counter() - t0
        log({"platform_sharded": sharded, "at_s": stamps["c"]})
        sb, sb_launches = plat_scoreboard(root)
        stamps["d"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    prof = train.pop("profile")
    conv = train.pop("conv_launches")
    log({"platform_planes": {
        "ingest": {**ingest, "train": {
            k: train[k] for k in ("ms_per_iteration", "records_per_s",
                                  "in_memory_ms_per_iteration", "busy_share",
                                  "data_wait_share", "stall_s", "mfu",
                                  "step_flops",
                                  "launches_per_step", "train_step_compiles",
                                  "first_batches_bit_equal")}},
        "profiling": prof,
        "sharded": sharded,
        "scoreboard": {name: (v if not isinstance(v, dict) or "rows" not in v
                              else {"rows": [{k: r[k] for k in (
                                  "slots", "tok_s", "ttft_p50_s",
                                  "ttft_p95_s", "token_latency_s",
                                  "prefix_hit_rate", "spec_accept_rate",
                                  "compiles", "compile_seconds",
                                  "peak_memory_bytes")} for r in v["rows"]],
                                  "k1": v["k1"], "k4": v["k4"]})
                       for name, v in sb.items()},
        "stamps_s": stamps, "cli_s": PLAT_CLI_S,
        "phase_s": time.perf_counter() - t0}})
    log({"platform_planes_details": {"train_losses": train["losses"]}})
    launches = {**flash, **conv}
    launches["flash_fwd"] += sb_launches["flash_fwd"]
    launches["flash_fwd_mma"] += sb_launches["flash_fwd_mma"]
    launches["int8_matmul"] = sb_launches["int8_matmul"]
    return launches


# ------------------------------------------- 3o. the data-parallel plane
DIST_ITERS = 6            # (a), (b): iterations of the 134m recipe a mode
DIST_SAVE_AT = 3          # (e): the sharded snapshot after this iteration
DIST_RESNET_ITERS = 4     # (c)
DIST_PERF_ITERS = 3       # (d)
DIST_PERF_MODEL = "resnet50"
DIST_TIMEOUT_S = 300      # one spawn's ranks, start to exit
DIST_STRIDE = 61          # the parameter sample: every 61st element
#: the checkout's root: the ranks' working directory
DIST_ROOT = os.path.dirname(os.path.abspath(__file__))
# the tolerances, set from sound readings and, where a control exists
# (``--distributed-controls``), between those and the control's (NVIDIA
# H100 80GB HBM3, 700 W; PERF.md §6): the relative L2 distance of two
# runs' parameter updates over the sample, ||(p_a - p_0) - (p_b - p_0)||
# / ||p_b - p_0||, or of their running statistics after the first
# iteration's forward, and the largest relative distance of their losses.
# (a) world 1's sharded and fsdp against allreduce (the clipping norm
# sums in another order): 0.0149 and 5.6e-4. (b) the 134m's AdamW at
# world 2 against world 1: 0.140-0.157 and 0.049-0.050 in bf16, 0.0016
# and 6.9e-4 in f32 (each rank's products round half the rows in bf16,
# and AdamW's near-sign first steps turn that into whole steps of some
# weights); with rank 1's gradients dropped 1.12 and 0.073: the update
# distance tells them apart, the loss bound is a sanity bound. (c)
# ResNet-50 at world 2: the running statistics 0.0031 from world 1's
# synchronized, 0.0129 per replica; the bf16 losses 0.0046 apart (one
# bf16 step), 0.038 with rank 1's gradients dropped. Its parameter
# updates are logged, not held: at init batch norm's backward cancels so
# far that an f32 gradient sits about 2% from f64 (phase 3c): world 2's
# updates read 1.10 from world 1's after the first step and 1.22 after
# 4 in bf16 (0.026 and 0.67 in f32), and the controls' 1.13-1.27. (e) world
# 1 resumed from world 2's snapshot against world 2's own continuation:
# 0.0018.
DIST_W1_UPDATE_TOL, DIST_W1_LOSS_TOL = 0.05, 2e-3
DIST_W2_UPDATE_TOL, DIST_W2_LOSS_TOL = 0.3, 0.1
DIST_RESNET_LOSS_TOL = 1e-2
DIST_RESNET_BUFFER_TOL = 6e-3
DIST_RESUME_UPDATE_TOL = 0.01


def dist_free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: every rank process a spawn started, killed at the script's exit if it
#: is still running (a phase's ranks run beside other phases)
SPAWNED = []


def dist_spawn(world: int, backend: str, jobs, out: str,
               argv=None, timeout: float = None, env: dict = None) -> float:
    """``world`` fresh ranks of ``chip_smoke.py --distributed-rank JOBS``
    (or of ``argv``) with the reference's environment, awaited with a
    timeout; a rank that fails fails the phase (its log's tail in the
    error). Returns the spawn's seconds."""
    port = dist_free_port()
    procs, logs = [], []
    t0 = time.perf_counter()
    for r in range(world):
        rank_env = {**os.environ, **(env or {}),
                    "BIGDL_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                    "BIGDL_NUM_PROCESSES": str(world),
                    "BIGDL_PROCESS_ID": str(r)}
        cmd = argv or [sys.executable, os.path.abspath(__file__),
                       "--distributed-rank", ",".join(jobs), "--dist-out",
                       out, "--dist-backend", backend]
        path = os.path.join(out, f"{'_'.join(jobs) if argv is None else 'perf'}"
                                 f".w{world}.rank{r}.log")
        logs.append(path)
        with open(path, "wb") as f:
            procs.append(subprocess.Popen(cmd, env=rank_env, stdout=f,
                                          stderr=subprocess.STDOUT,
                                          cwd=DIST_ROOT))
            SPAWNED.append(procs[-1])
    deadline = time.time() + (timeout or DIST_TIMEOUT_S)
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, path) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            with open(path, "rb") as f:
                tail = f.read()[-3000:].decode(errors="replace")
            raise RuntimeError(f"check failed: rank {r} of {world} "
                               f"({jobs}) exited {p.returncode}:\n{tail}")
    return time.perf_counter() - t0


def dist_lm_batches(world: int, rank: int):
    """The 134m recipe's batches (global B=8, S=512, from seed 17): this
    rank's rows of each."""
    from bigdl_tpu_torch.apps.transformer import synthetic_corpus
    from bigdl_tpu_torch.dataset.base import MiniBatch, SampleToBatch
    samples = synthetic_corpus(TRAIN_BATCH * DIST_ITERS, TRAIN_SEQ, VOCAB,
                               seed=17)
    per = TRAIN_BATCH // world
    out = []
    for b in SampleToBatch(TRAIN_BATCH)(iter(samples)):
        lo = rank * per
        out.append(MiniBatch(b.data[lo:lo + per], b.labels[lo:lo + per]))
    return out


def dist_sample(model) -> np.ndarray:
    """Every DIST_STRIDE-th element of the parameters, in order, as f32
    numpy (the running statistics are ``dist_buffers``': ResNet-50's
    move far more than its weights in 4 iterations and would drown a
    gradient fault)."""
    with torch.no_grad():
        flat = torch.cat([t.detach().float().reshape(-1)
                          for t in model.parameters()])
        return flat[::DIST_STRIDE].cpu().numpy()


def dist_digest(model, buffers: bool = False) -> str:
    """sha256 of the parameters' (or the buffers') bytes."""
    import hashlib
    h = hashlib.sha256()
    for p in (model.buffers() if buffers else model.parameters()):
        h.update(p.detach().cpu().reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def dist_buffers(model) -> np.ndarray:
    """Every float buffer (the running statistics), in order, as f32
    numpy."""
    with torch.no_grad():
        return torch.cat([b.detach().float().reshape(-1)
                          for b in model.buffers()
                          if b.is_floating_point()]).cpu().numpy()


def dist_counters() -> dict:
    """K1-K3 and K5/K6 counters of this process, by ``kernels`` key."""
    k5, k5m, k6, k6m = conv_bn_counters()
    return {**flash_counters(), "matmul_bn": k5, "matmul_bn_mma": k5m,
            "conv3x3_bn": k6, "conv3x3_bn_mma": k6m}


def dist_run(opt, iters: int = None) -> dict:
    """``opt.optimize()`` with every counter zeroed just before it; its
    losses, launches, collectives a step (over ``iters``, by default the
    iterations it ran) and timings."""
    from bigdl_tpu_torch.parallel import mesh as pmesh
    from bigdl_tpu_torch.utils.engine import Engine
    counters = dist_counters()
    for c in counters.values():
        c.reset()
    pmesh.COLLECTIVES.reset()
    # gloo's collectives block the host anyway, so timing each one alone
    # costs nothing there; NCCL's would lose their overlap with the device
    pmesh.COLLECTIVES.sync_timing = Engine.backend() == "gloo"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pmesh.COLLECTIVES.sync_timing = False
    snap = pmesh.COLLECTIVES.snapshot()
    iters = iters or len(opt.history)
    res = {"losses": [h["loss"] for h in opt.history],
           "launches": {k: c.value for k, c in counters.items()},
           "collectives_per_step": {op: n / iters
                                    for op, n in snap["calls"].items()},
           "collective_mib_per_step": {op: b / iters / 2 ** 20
                                       for op, b in snap["bytes"].items()},
           "collective_s": sum(snap["seconds"].values()), "wall_s": wall,
           "bytes_by_axis": dict(snap.get("bytes_by_axis", {})),
           "ms_per_iteration": float(np.median(
               [h["seconds"] for h in opt.history[2:]])) * 1e3}
    res["collective_share"] = res["collective_s"] / wall
    if hasattr(opt, "resident_mib"):
        res["resident_mib"] = opt.resident_mib()
    return res


#: each pristine model a rank process built, copied for every run
DIST_MODELS = {}


def dist_model(kind: str):
    """A fresh copy of the 134m recipe's model (seed 7) or ResNet-50 with
    both gates (seed 3), built once a process."""
    import copy
    if kind not in DIST_MODELS:
        if kind == "lm":
            from bigdl_tpu_torch.models.transformer import build_lm
            DIST_MODELS[kind] = build_lm(VOCAB, **CONFIG, device="cuda",
                                         seed=7)
        else:
            DIST_MODELS[kind] = build_resnet50(True, "cuda", seed=3)
    return copy.deepcopy(DIST_MODELS[kind])


def dist_full_state(opt, opt_state) -> dict:
    """The parameters, buffers and optim state in full shapes, on the host,
    keyed by path (collective: every rank calls it; its gathers are left
    out of ``COLLECTIVES``, which the run's structure check reads)."""
    from bigdl_tpu_torch.parallel.mesh import COLLECTIVES
    host = lambda t: t.detach().cpu().clone() if torch.is_tensor(t) else t
    counts = COLLECTIVES.snapshot()
    with opt._full_weights():
        params = {n: host(p) for n, p in opt.model.named_parameters()}
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        else:
            flat[path] = host(node)
    walk(opt._full_state(opt_state), "optim")
    for k, v in counts.items():
        setattr(COLLECTIVES, k, collections.Counter(v))
    return {**{f"params/{n}": t for n, t in params.items()},
            **{f"buffers/{n}": host(t) for n, t in opt.model.named_buffers()},
            **flat}


def dist_dump_at(opt, method: str, rank: int, path: str) -> None:
    """Wrap ``opt``'s ``_checkpoint_trees`` (the snapshot) or
    ``_resume_state`` (the restore) so that, after it, rank 0 writes
    ``dist_full_state`` to ``path``."""
    inner = getattr(opt, method)

    def dumped(*args):
        res = inner(*args)
        state = dist_full_state(opt, args[-2 if method == "_resume_state"
                                          else 0])
        if rank == 0:
            torch.save(state, path)
        return res
    setattr(opt, method, dumped)


def dist_drop_rank(opt, rank: int, dropped: int) -> None:
    """A planted fault for a control: rank ``dropped`` all-reduces zeros
    in place of its gradients (the global gradient is the other ranks'
    rows alone)."""
    if rank == dropped:
        inner = opt._all_reduce_mean
        opt._all_reduce_mean = lambda ts: inner([torch.zeros_like(t)
                                                 for t in ts])


def dist_lm_run(mode: str, world: int, rank: int, out: str,
                save_at: int = None, resume_dir: str = None,
                tag: str = None, digest: bool = True,
                precision: str = "bf16", drop_rank: int = None,
                dump: str = None) -> dict:
    """The 134m recipe (bf16 unless ``precision="fp32"``, AdamW, L2 clip
    1.0) to iteration DIST_ITERS: ``"local"`` through ``LocalOptimizer`` on
    the whole batches, else ``DistriOptimizer`` in that sync mode on this
    rank's rows. ``resume_dir``: ``auto_resume`` from the newest snapshot
    there; ``save_at``: a sharded snapshot there (or in
    ``out/fsdp_snapshot``) after that iteration; ``dump``: the full state
    as saved (with ``save_at``) or as restored (with ``resume_dir``) to
    that file; ``drop_rank``: that rank's gradients dropped (a control)."""
    from bigdl_tpu_torch.dataset.base import DataSet, DistributedDataSet
    from bigdl_tpu_torch.nn.criterion import FusedLMHeadCriterion
    from bigdl_tpu_torch.optim import AdamW, Optimizer, Trigger
    t0 = time.perf_counter()
    model = dist_model("lm")
    p0 = dist_sample(model)
    batches = dist_lm_batches(world, rank)
    if mode == "local":
        opt = Optimizer(model, DataSet.array(batches, seed=0),
                        FusedLMHeadCriterion(), device="cuda")
    else:   # the same shuffles on every rank: seed 0
        opt = Optimizer(model, DistributedDataSet(
            batches, shard_by_process=False, seed=0),
            FusedLMHeadCriterion(), device="cuda", sync_mode=mode)
    (opt.set_precision(precision)
        .set_optim_method(AdamW(learningrate=TRAIN_LR,
                                weightdecay=TRAIN_DECAY))
        .set_gradient_clipping_by_l2_norm(TRAIN_CLIP)
        .set_end_when(Trigger.max_iteration(DIST_ITERS)))
    ckpt = resume_dir or os.path.join(out, "fsdp_snapshot")
    if save_at is not None or resume_dir is not None:
        at = -1 if save_at is None else save_at + 1   # -1: never
        opt.set_checkpoint(ckpt, Trigger(lambda s: int(s["neval"]) == at,
                                         "snapshot"), sharded=True)
    if resume_dir is not None:
        opt.auto_resume()
    if dump is not None:
        dist_dump_at(opt, "_resume_state" if resume_dir is not None
                     else "_checkpoint_trees", rank, dump)
    if drop_rank is not None:
        dist_drop_rank(opt, rank, drop_rank)
    res = dist_run(opt, None)
    if world > 1 and mode != "local" and drop_rank is None:
        from bigdl_tpu_torch.parallel import comm_symbols as cs
        res["comm_model"] = comm_held(
            {"allreduce": "dp-allreduce", "sharded": "dp-sharded",
             "fsdp": "fsdp"}[mode], {"bytes_by_axis": res["bytes_by_axis"]},
            len(opt.history), cs.dp_symbols(opt))
    if digest:
        res["digest"] = dist_digest(model)
    res["param_shapes"] = [list(p.shape) for p in model.parameters()]
    res["float_buffers"] = any(t.is_floating_point()
                               for t in model.buffers())
    np.savez(os.path.join(out, f"{tag or f'lm_{mode}_w{world}'}.{rank}.npz"),
             p0=p0, p=dist_sample(model))
    res["run_s"] = time.perf_counter() - t0
    del opt, model
    torch.cuda.empty_cache()
    return res


def dist_resnet_run(world: int, rank: int, out: str,
                    synchronized: bool = True, drop_rank: int = None,
                    precision: str = "bf16", tag: str = "resnet") -> dict:
    """ResNet-50, both fusion gates, bf16 (or ``precision``), SGD(0.1,
    momentum 0.9), allreduce: one constant global batch of RESNET_BATCH
    from seed 5, this rank's rows, DIST_RESNET_ITERS iterations; the
    running statistics after the first iteration's forward and the
    parameters after its update are kept too (from equal weights: no
    earlier step's rounding in them). The controls: ``synchronized=False``
    keeps each rank's batch statistics its own, ``drop_rank`` drops that
    rank's gradients."""
    import contextlib
    from bigdl_tpu_torch.dataset.base import DistributedDataSet, MiniBatch
    from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
    from bigdl_tpu_torch.nn.fused import _FusedConvBN
    from bigdl_tpu_torch.nn.normalization import BatchNormalization
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    from bigdl_tpu_torch.parallel import distri_optimizer
    t0 = time.perf_counter()
    model = dist_model("resnet")
    p0 = dist_sample(model)
    b0 = dist_buffers(model)
    x, y = imagenet_batch(RESNET_BATCH, seed=5)
    per = RESNET_BATCH // world
    mine = MiniBatch(x[rank * per:(rank + 1) * per],
                     y[rank * per:(rank + 1) * per])
    opt = (Optimizer(model, DistributedDataSet(
        [mine] * DIST_RESNET_ITERS, shard_by_process=False, seed=0),
        ClassNLLCriterion(), device="cuda", sync_mode="allreduce")
        .set_precision(precision)
        .set_optim_method(SGD(learningrate=RESNET_LR,
                              momentum=RESNET_MOMENTUM))
        .set_end_when(Trigger.max_iteration(DIST_RESNET_ITERS)))
    t1 = time.perf_counter()
    first = []
    apply_grads = opt._apply_grads

    def apply_first(*args, **kwargs):
        now = not first
        if now:   # the first forward's statistics, weights still equal
            first.append(dist_buffers(model))
        res = apply_grads(*args, **kwargs)
        if now:   # the first update
            first.append(dist_sample(model))
        return res
    opt._apply_grads = apply_first
    if drop_rank is not None:
        dist_drop_rank(opt, rank, drop_rank)
    sync = distri_optimizer.synchronized
    if not synchronized:
        distri_optimizer.synchronized = lambda mesh: contextlib.nullcontext()
    try:
        res = dist_run(opt, DIST_RESNET_ITERS)
    finally:
        distri_optimizer.synchronized = sync
    res["setup_s"] = t1 - t0
    res["first_iteration_s"] = opt.history[0]["seconds"]
    res["fused_bn"] = sum(isinstance(m, _FusedConvBN)
                          for m in model.modules())
    res["plain_bn"] = sum(isinstance(m, BatchNormalization)
                          for m in model.modules())
    res["param_shapes"] = [list(p.shape) for p in model.parameters()]
    res["digest"] = dist_digest(model)
    res["buffers_digest"] = dist_digest(model, buffers=True)
    np.savez(os.path.join(out, f"{tag}_w{world}.{rank}.npz"), p0=p0,
             p=dist_sample(model), p1=first[1], b0=b0, b1=first[0],
             b=dist_buffers(model))
    del opt, model
    torch.cuda.empty_cache()
    return res


def dist_resume_runs(world: int, rank: int, out: str) -> dict:
    """(e): the world-2 fsdp snapshot resumed by this world to DIST_ITERS
    (its restored state written for the bit-for-bit check against the
    state world 2 saved), uninterrupted but for a snapshot after
    iteration DIST_ITERS - 1; then that snapshot resumed for the last
    iteration; the resumes counted by ``elastic``."""
    from bigdl_tpu_torch.resilience import coordinator
    from bigdl_tpu_torch.telemetry import get_registry, instruments
    snap = os.path.join(out, "fsdp_snapshot")
    point = coordinator.latest_resume_point(snap)
    family = instruments(get_registry()).resilience_resumes_total
    before = {e: family.labels(elastic=e).value for e in ("true", "false")}
    whole = dist_lm_run("fsdp", world, rank, out, resume_dir=snap,
                        save_at=DIST_ITERS - 1, tag="lm_fsdp_w1_resumed",
                        dump=os.path.join(out, "restored_w1.pt"))
    last = dist_lm_run("fsdp", world, rank, os.path.join(out, "again"),
                       resume_dir=snap, tag="lm_fsdp_w1_resumed_last")
    return {"whole": whole, "last": last, "snapshot_neval": point.neval,
            "marker_mesh": point.marker["mesh"], "elastic": {
                e: family.labels(elastic=e).value - n
                for e, n in before.items()}}


DIST_JOBS = {
    # world 2: (b) every mode, fsdp saving (e)'s snapshot and its full
    # state; (c)
    "lm_w2": lambda w, r, out: {mode: dist_lm_run(
        mode, w, r, out, save_at=DIST_SAVE_AT if mode == "fsdp" else None,
        dump=os.path.join(out, "saved_w2.pt") if mode == "fsdp" else None)
        for mode in ("allreduce", "sharded", "fsdp")},
    "resnet": lambda w, r, out: dist_resnet_run(w, r, out),
    # world 1: (a) LocalOptimizer and every mode; (e)'s resumes
    "lm_w1": lambda w, r, out: {mode: dist_lm_run(
        mode, w, r, out, digest=mode in ("local", "allreduce"))
        for mode in ("local", "allreduce", "sharded", "fsdp")},
    "resume": dist_resume_runs,
    # --distributed-controls: (b) in f32 at both worlds, (b) with rank 1's
    # gradients dropped, (c) with per-replica statistics
    "lm_w1_controls": lambda w, r, out: {"fp32": dist_lm_run(
        "allreduce", w, r, out, precision="fp32",
        tag="lm_allreduce_w1_fp32")},
    "lm_w2_controls": lambda w, r, out: {
        "fp32": dist_lm_run("allreduce", w, r, out, precision="fp32",
                            tag="lm_allreduce_w2_fp32"),
        "drop_rank1": dist_lm_run("allreduce", w, r, out, drop_rank=1,
                                  tag="lm_allreduce_w2_drop_rank1")},
    "resnet_controls": lambda w, r, out: {
        "per_replica": dist_resnet_run(w, r, out, synchronized=False,
                                       tag="resnet_per_replica"),
        "drop_rank1": dist_resnet_run(w, r, out, drop_rank=1,
                                      tag="resnet_drop_rank1"),
        "fp32": dist_resnet_run(w, r, out, precision="fp32",
                                tag="resnet_fp32")},
    # world 1: (c) again (run-to-run) and in f32
    "resnet_w1_controls": lambda w, r, out: {
        "again": dist_resnet_run(w, r, out, tag="resnet_again"),
        "fp32": dist_resnet_run(w, r, out, precision="fp32",
                                tag="resnet_fp32")},
}


def run_distributed_rank(jobs: str, out: str, backend: str) -> int:
    """One rank of phase 3o: joins the group from the BIGDL_* environment
    and writes each job's readings to ``out/<job>.<rank>.json``."""
    from bigdl_tpu_torch.utils.engine import Engine
    Engine.init_distributed(backend=backend)
    rank, world = Engine.process_index(), Engine.process_count()
    os.makedirs(os.path.join(out, "again"), exist_ok=True)
    try:
        for job in jobs.split(","):
            t0 = time.perf_counter()
            res = DIST_JOBS[job](world, rank, out)
            res["job_s"] = time.perf_counter() - t0
            with open(os.path.join(out, f"{job}.w{world}.{rank}.json"),
                      "w") as f:
                json.dump(res, f)
    finally:
        Engine.shutdown_distributed()
    return 0


#: each rank job's seconds, by job and world (rank 0's)
DIST_JOB_S = {}


def dist_read(out: str, job: str, world: int, rank: int = 0) -> dict:
    """A job's readings (its seconds go to DIST_JOB_S)."""
    with open(os.path.join(out, f"{job}.w{world}.{rank}.json")) as f:
        res = json.load(f)
    seconds = res.pop("job_s")
    if rank == 0:
        DIST_JOB_S[f"{job}_w{world}"] = seconds
    return res


def dist_update_distance(out: str, a: str, b: str, at: str = "p") -> float:
    """Relative L2 distance of two runs' updates over the sample (rank 0's
    files): ||(p_a - p0) - (p_b - p0)|| / ||p_b - p0||, at the end
    (``at="p"``) or after the first update (``"p1"``)."""
    za, zb = (np.load(os.path.join(out, f"{t}.0.npz")) for t in (a, b))
    check(np.array_equal(za["p0"], zb["p0"]), f"{a} and {b} started apart")
    upd = zb[at].astype(np.float64) - zb["p0"]
    return float(np.linalg.norm(za[at].astype(np.float64) - zb[at])
                 / max(np.linalg.norm(upd), 1e-30))


def dist_buffer_distance(out: str, a: str, b: str, at: str = "b") -> float:
    """The same distance over the running statistics (every float
    buffer) at the end (``at="b"``) or after the first iteration's forward
    (``"b1"``), rank 0's files."""
    za, zb = (np.load(os.path.join(out, f"{t}.0.npz")) for t in (a, b))
    check(np.array_equal(za["b0"], zb["b0"]), f"{a} and {b} started apart")
    upd = zb[at].astype(np.float64) - zb["b0"]
    return float(np.linalg.norm(za[at].astype(np.float64) - zb[at])
                 / max(np.linalg.norm(upd), 1e-30))


def dist_same_state(out: str, a: str, b: str) -> dict:
    """Two ``dist_full_state`` files compared leaf by leaf, bit for bit
    (a tensor's dtype, shape and values; any other leaf by ``==``)."""
    sa, sb = (torch.load(os.path.join(out, f), weights_only=False)
              for f in (a, b))

    def same(x, y):
        if torch.is_tensor(x) or torch.is_tensor(y):
            return (torch.is_tensor(x) and torch.is_tensor(y)
                    and x.dtype == y.dtype and x.shape == y.shape
                    and torch.equal(x, y))
        return type(x) is type(y) and x == y
    differ = sorted(k for k in set(sa) | set(sb)
                    if k not in sa or k not in sb or not same(sa[k], sb[k]))
    return {"leaves": len(sa),
            "tensors": sum(torch.is_tensor(v) for v in sa.values()),
            "differ": differ[:8], "n_differ": len(differ)}


def dist_loss_gap(a: list, b: list) -> float:
    check(len(a) == len(b), f"{len(a)} losses against {len(b)}")
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def dist_lm_structure(model_sizes) -> dict:
    """Each mode's collectives a step by the path's structure (and the
    epoch's agreement, one all-reduce a run): the allreduce mode's
    gradient buckets and the loss; ZeRO-1's flat
    reduce-scatter and all-gather, the clip's and the buffers' all-reduce
    and the loss; fsdp's gather and reduce-scatter a sharded leaf, the
    replicated leaves' buckets, the clip and the loss."""
    from bigdl_tpu_torch.parallel.distri_optimizer import (BUCKET_BYTES,
                                                           _buckets)
    from bigdl_tpu_torch.parallel.fsdp import shard_dim
    params, has_float_buffers, world = model_sizes
    like = [torch.empty(s, dtype=torch.float32, device="meta")
            for s in params]
    ar = len(_buckets(like, BUCKET_BYTES)) + 1
    sharded = [s for s in params if shard_dim(s, world) is not None]
    rep = [t for t, s in zip(like, params) if shard_dim(s, world) is None]
    # and once a run, the epoch's agreed iteration count (one all-reduce)
    agree = lambda n: (n * DIST_ITERS + 1) / DIST_ITERS
    return {"allreduce": {"all_reduce": agree(ar)},
            "sharded": {"reduce_scatter": 1, "all_gather": 1,
                        "all_reduce": agree(2 + int(has_float_buffers))},
            "fsdp": {"all_gather": len(sharded),
                     "reduce_scatter": len(sharded),
                     "all_reduce": agree(len(_buckets(rep, BUCKET_BYTES))
                                         + 2)}}


def dist_resnet_structure(run: dict, world: int) -> dict:
    """ResNet-50's collectives a step in allreduce mode with synchronized
    batch norm: forward, an all-reduce of each fused op's sums and an
    all-gather of each plain BN's moments; backward, an all-reduce of
    each BN's two sums; the gradient buckets and the loss; and once a run
    the epoch's agreed iteration count."""
    from bigdl_tpu_torch.parallel.distri_optimizer import (BUCKET_BYTES,
                                                           _buckets)
    like = [torch.empty(s, dtype=torch.float32, device="meta")
            for s in run["param_shapes"]]
    fused, plain = run["fused_bn"], run["plain_bn"]
    per_step = (fused + (fused + plain) + len(_buckets(like, BUCKET_BYTES))
                + 1)
    # and once a run, the epoch's agreed iteration count
    return {"all_reduce": (per_step * DIST_RESNET_ITERS + 1)
            / DIST_RESNET_ITERS, "all_gather": plain}


def dist_controls(out: str, w1: dict, b: dict, c: dict) -> dict:
    """The controls' readings beside the sound ones, and the checks they
    fail (``failed``): each control must fall outside the tolerance it
    sets, or that tolerance cannot tell a fault from rounding."""
    cw1 = dist_read(out, "lm_w1_controls", 1)
    cw2 = dist_read(out, "lm_w2_controls", 2)
    cres = [dist_read(out, "resnet_controls", 2, r) for r in range(2)]
    rep = [r["per_replica"] for r in cres]
    fp32 = {"update_distance": dist_update_distance(
                out, "lm_allreduce_w2_fp32", "lm_allreduce_w1_fp32"),
            "loss_gap": dist_loss_gap(cw2["fp32"]["losses"],
                                      cw1["fp32"]["losses"]),
            "losses_w2": cw2["fp32"]["losses"],
            "losses_w1": cw1["fp32"]["losses"],
            "bf16_update_distance": b["allreduce"]["update_distance"],
            "bf16_loss_gap": b["allreduce"]["loss_gap"]}
    drop = {"update_distance": dist_update_distance(
                out, "lm_allreduce_w2_drop_rank1", "lm_allreduce_w1"),
            "loss_gap": dist_loss_gap(cw2["drop_rank1"]["losses"],
                                      w1["allreduce"]["losses"]),
            "losses": cw2["drop_rank1"]["losses"]}
    cres1 = dist_read(out, "resnet_w1_controls", 1)
    resnet = {}
    for name, tag, run in (
            ("per_replica", "resnet_per_replica_w2", rep[0]),
            ("drop_rank1", "resnet_drop_rank1_w2", cres[0]["drop_rank1"]),
            ("again_w1", "resnet_again_w1", cres1["again"]),
            ("fp32", "resnet_fp32_w2", cres[0]["fp32"])):
        yard = "resnet_fp32_w1" if name == "fp32" else "resnet_w1"
        w1_losses = (cres1["fp32"]["losses"] if name == "fp32"
                     else c["losses_w1"])
        resnet[name] = {
            "first_update_distance": dist_update_distance(out, tag, yard,
                                                          at="p1"),
            "update_distance": dist_update_distance(out, tag, yard),
            "first_buffer_distance": dist_buffer_distance(out, tag, yard,
                                                          at="b1"),
            "buffer_distance": dist_buffer_distance(out, tag, yard),
            "loss_gap": dist_loss_gap(run["losses"], w1_losses),
            "losses": run["losses"],
            "collectives_per_step": run["collectives_per_step"]}
    per_replica, resnet_drop = resnet["per_replica"], resnet["drop_rank1"]
    per_replica["ranks_buffers_bit_equal"] = (rep[0]["buffers_digest"]
                                              == rep[1]["buffers_digest"])
    failed = []
    if (drop["update_distance"] <= DIST_W2_UPDATE_TOL
            and drop["loss_gap"] <= DIST_W2_LOSS_TOL):
        failed.append(f"control: (b) with rank 1's gradients dropped passes "
                      f"(b)'s tolerance: {drop}")
    # per-replica statistics must fail both the statistics' distance and
    # the ranks' equal statistics
    if (per_replica["first_buffer_distance"] <= DIST_RESNET_BUFFER_TOL
            or per_replica["ranks_buffers_bit_equal"]):
        failed.append(f"control: (c) with per-replica statistics passes "
                      f"(c)'s statistics checks: {per_replica}")
    if resnet_drop["loss_gap"] <= DIST_RESNET_LOSS_TOL:
        failed.append(f"control: (c) with rank 1's gradients dropped passes "
                      f"(c)'s loss tolerance: {resnet_drop}")
    return {"b_fp32": fp32, "b_drop_rank1": drop,
            **{f"c_{k}": v for k, v in resnet.items()}, "failed": failed}


class Beside:
    """``fn(*args)`` in a thread beside the script's own work: a phase's
    rank processes run while earlier phases run in this process (their
    checks do not depend on the card's time). ``result()`` joins it and
    returns its value, or raises its error."""

    def __init__(self, fn, *args):
        self._box = {}

        def run():
            try:
                self._box["value"] = fn(*args)
            except BaseException as e:   # noqa: BLE001 - raised in result()
                self._box["error"] = e
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def result(self):
        self._thread.join()
        if "error" in self._box:
            raise self._box["error"]
        return self._box["value"]


def dist_ranks(controls: bool = False) -> tuple:
    """Phase 3o's rank processes, in a new folder: world 2 over the card
    (gloo; (b), (c), (e)'s snapshot), then world 1 (NCCL; (a), (c)'s
    yardstick, (e)'s resumes), then (d) the perf harness at world 2.
    Returns (the folder, the spawns' seconds)."""
    import tempfile
    out = tempfile.mkdtemp(prefix="bigdl_dist_")
    spawn_s = {}
    try:
        spawn_s["w2"] = dist_spawn(2, "gloo", ["lm_w2", "resnet"] + (
            ["lm_w2_controls", "resnet_controls"] if controls else []), out)
        spawn_s["w1"] = dist_spawn(1, "nccl", ["lm_w1", "resnet", "resume"]
                                   + (["lm_w1_controls", "resnet_w1_controls"]
                                      if controls else []), out)
        perf_argv = [sys.executable, "-m", "bigdl_tpu_torch.apps.perf",
                     "--model", DIST_PERF_MODEL, "--distributed",
                     "--backend", "gloo", "-b", str(RESNET_BATCH), "-i",
                     str(DIST_PERF_ITERS), "--warmup", "1", "--records",
                     str(RESNET_BATCH)]
        spawn_s["perf"] = dist_spawn(2, "gloo", ["perf"], out,
                                     argv=perf_argv,
                                     env={g: "1" for g in FUSION_GATES})
    except BaseException:
        shutil.rmtree(out, ignore_errors=True)
        raise
    return out, spawn_s


def run_distributed(controls: bool = False, ranks: "Beside" = None) -> dict:
    """Phase 3o; returns its K1-K3 and K5/K6 launches, every rank's.
    ``controls``: also the runs that set its tolerances (PERF.md §6): (b)
    in f32 at both worlds, (b) with rank 1's gradients dropped, and (c)
    with per-replica batch statistics, each control held to fail the
    check it sets. ``ranks``: ``dist_ranks`` already running beside
    earlier phases (the whole script starts it before phase 3h); None:
    they run here."""
    t_phase = time.perf_counter()
    if ranks is None:
        ranks = Beside(dist_ranks, controls)
    out, spawn_s = ranks.result()
    failed = []   # every check's verdict, raised after the line is logged

    def defer(cond, what):
        if not cond:
            failed.append(what)
    try:
        perf_lines = []
        for r in range(2):
            with open(os.path.join(out, f"perf.w2.rank{r}.log")) as f:
                lines = [ln for ln in f.read().splitlines()
                         if ln.startswith("{") and '"harness"' in ln]
            check(lines, f"(d) rank {r} printed no perf line")
            perf_lines.append(json.loads(lines[-1]))

        w1, w2 = dist_read(out, "lm_w1", 1), [dist_read(out, "lm_w2", 2, r)
                                              for r in range(2)]
        res2 = [dist_read(out, "resnet", 2, r) for r in range(2)]
        res1 = dist_read(out, "resnet", 1)
        resumed = dist_read(out, "resume", 1)
        # (a) world 1 on NCCL
        a = {"allreduce_bit_equal": w1["allreduce"]["digest"]
             == w1["local"]["digest"]
             and w1["allreduce"]["losses"] == w1["local"]["losses"],
             "losses": {m: r["losses"] for m, r in w1.items()},
             "ms_per_iteration": {m: r["ms_per_iteration"]
                                  for m, r in w1.items()}}
        defer(a["allreduce_bit_equal"], "(a) allreduce at world 1 differs "
              "from LocalOptimizer's run")
        for mode in ("sharded", "fsdp"):
            a[mode] = {"update_distance": dist_update_distance(
                out, f"lm_{mode}_w1", "lm_allreduce_w1"),
                "loss_gap": dist_loss_gap(w1[mode]["losses"],
                                          w1["allreduce"]["losses"])}
            defer(a[mode]["update_distance"] <= DIST_W1_UPDATE_TOL
                  and a[mode]["loss_gap"] <= DIST_W1_LOSS_TOL,
                  f"(a) {mode} at world 1 against allreduce: {a[mode]}")
        layers = CONFIG["num_layers"]
        flash_want = all_mma_launches(layers * DIST_ITERS)
        for mode, run in w1.items():
            got = {k: run["launches"][k] for k in flash_want}
            defer(got == flash_want, f"(a) {mode}: K1-K3 launches {got}, "
                  f"want {flash_want}")
        # (b) world 2 over the one card
        structure = dist_lm_structure((
            [tuple(s) for s in w1["local"]["param_shapes"]],
            w1["local"]["float_buffers"], 2))
        b = {}
        for mode in ("allreduce", "sharded", "fsdp"):
            r0 = w2[0][mode]
            b[mode] = {
                "update_distance": dist_update_distance(
                    out, f"lm_{mode}_w2", f"lm_{mode}_w1"),
                "loss_gap": dist_loss_gap(r0["losses"], w1[mode]["losses"]),
                "ranks_bit_equal": w2[0][mode]["digest"]
                == w2[1][mode]["digest"],
                "collectives_per_step": r0["collectives_per_step"],
                "collective_mib_per_step": r0["collective_mib_per_step"],
                "resident_mib": r0["resident_mib"],
                "ms_per_iteration": r0["ms_per_iteration"],
                "collective_share": r0["collective_share"],
                "losses": r0["losses"], "run_s": r0["run_s"]}
            if mode != "allreduce":   # logged, not held
                b[mode]["update_distance_to_allreduce"] = \
                    dist_update_distance(out, f"lm_{mode}_w2",
                                         "lm_allreduce_w2")
            defer(b[mode]["ranks_bit_equal"],
                  f"(b) {mode}: the two ranks' parameters differ")
            defer(b[mode]["update_distance"] <= DIST_W2_UPDATE_TOL
                  and b[mode]["loss_gap"] <= DIST_W2_LOSS_TOL,
                  f"(b) {mode} at world 2 against world 1: {b[mode]}")
            defer(r0["collectives_per_step"] == structure[mode],
                  f"(b) {mode}: collectives a step "
                  f"{r0['collectives_per_step']}, want {structure[mode]}")
            b[mode]["comm_model"] = [comm_verdict(
                "3o", f"{mode}.rank{rank}", w2[rank][mode]["comm_model"],
                defer) for rank in range(2)]
            for rank in range(2):
                got = {k: w2[rank][mode]["launches"][k] for k in flash_want}
                defer(got == flash_want, f"(b) {mode} rank {rank}: K1-K3 "
                      f"{got}, want {flash_want}")
        for mode in ("sharded", "fsdp"):
            defer(b[mode]["resident_mib"]["optim"]
                  < 0.6 * b["allreduce"]["resident_mib"]["optim"],
                  f"(b) {mode}'s optim state is not split: {b[mode]}")
        defer(b["fsdp"]["resident_mib"]["params"]
              < 0.6 * b["allreduce"]["resident_mib"]["params"],
              f"(b) fsdp's parameters are not split: {b['fsdp']}")
        # (c) ResNet-50 at global B=256 with synchronized batch norm
        c = {"update_distance": dist_update_distance(out, "resnet_w2",
                                                     "resnet_w1"),
             "first_update_distance": dist_update_distance(
                 out, "resnet_w2", "resnet_w1", at="p1"),
             "loss_gap": dist_loss_gap(res2[0]["losses"], res1["losses"]),
             "losses_w2": res2[0]["losses"], "losses_w1": res1["losses"],
             "ms_per_iteration_w2": res2[0]["ms_per_iteration"],
             "ms_per_iteration_w1": res1["ms_per_iteration"],
             "setup_s": [res2[0]["setup_s"], res1["setup_s"]],
             "first_iteration_s": [res2[0]["first_iteration_s"],
                                   res1["first_iteration_s"]],
             "collective_share_w2": res2[0]["collective_share"],
             "collectives_per_step": res2[0]["collectives_per_step"],
             "structure": dist_resnet_structure(res2[0], 2),
             "buffer_distance": dist_buffer_distance(out, "resnet_w2",
                                                     "resnet_w1"),
             "first_buffer_distance": dist_buffer_distance(
                 out, "resnet_w2", "resnet_w1", at="b1"),
             "ranks_buffers_bit_equal": res2[0]["buffers_digest"]
             == res2[1]["buffers_digest"],
             "ranks_bit_equal": res2[0]["digest"] == res2[1]["digest"]}
        defer(c["first_buffer_distance"] <= DIST_RESNET_BUFFER_TOL
              and c["loss_gap"] <= DIST_RESNET_LOSS_TOL,
              f"(c) ResNet-50 at world 2 against world 1: {c}")
        # the ranks' statistics are the global batch's: bit-equal buffers
        defer(c["ranks_buffers_bit_equal"] and c["ranks_bit_equal"],
              "(c) the two ranks' parameters or running statistics differ")
        for rank in range(2):
            got = res2[rank]["collectives_per_step"]
            defer(got == c["structure"], f"(c) rank {rank}: collectives a "
                  f"step {got}, want {c['structure']}")
        conv_want = {"matmul_bn": K5_PER_STEP * DIST_RESNET_ITERS,
                     "matmul_bn_mma": K5_PER_STEP * DIST_RESNET_ITERS,
                     "conv3x3_bn": K6_PER_STEP * DIST_RESNET_ITERS,
                     "conv3x3_bn_mma": K6_PER_STEP * DIST_RESNET_ITERS}
        for name, run in (("w1", res1), ("w2 rank 0", res2[0]),
                          ("w2 rank 1", res2[1])):
            got = {k: run["launches"][k] for k in conv_want}
            defer(got == conv_want, f"(c) {name}: K5/K6 {got}, want "
                  f"{conv_want}")
        # (d) perf --distributed
        d = perf_lines[0]
        defer(d["distributed"] is True and d["records_per_sec"] > 0,
              f"(d) perf line {d}")
        # (e) the world-2 fsdp snapshot resumed by world 1
        whole, last = resumed["whole"], resumed["last"]
        e = {"snapshot_neval": resumed["snapshot_neval"],
             "marker_mesh": resumed["marker_mesh"],
             "elastic_resumes": resumed["elastic"],
             "restore": dist_same_state(out, "saved_w2.pt",
                                        "restored_w1.pt"),
             "last_iteration_bit_equal": last["digest"] == whole["digest"]
             and last["losses"] == whole["losses"][-1:],
             "losses": whole["losses"],
             "update_distance_to_w2": dist_update_distance(
                 out, "lm_fsdp_w1_resumed", "lm_fsdp_w2"),
             "run_s": [whole["run_s"], last["run_s"]]}
        # the elastic restore: world 1's state right after loading world
        # 2's fsdp slabs is, leaf by leaf, the full state world 2 held
        # when it saved them (parameters, buffers, AdamW's moments)
        defer(e["restore"]["n_differ"] == 0 and e["restore"]["tensors"]
              >= 3 * len(w1["local"]["param_shapes"]),
              f"(e) the elastic restore differs from the state world 2 "
              f"saved: {e['restore']}")
        defer(e["last_iteration_bit_equal"], f"(e) the resumed last "
              f"iteration differs from the uninterrupted run's: {e}")
        defer(e["elastic_resumes"] == {"true": 1, "false": 1},
              f"(e) resumes counted {e['elastic_resumes']}, want one "
              "elastic (world 2 -> 1) and one not")
        defer(e["snapshot_neval"] == DIST_SAVE_AT + 1
              and e["marker_mesh"] == {"process_count": 2, "device_count": 2,
                                       "mesh_shape": {"data": 2},
                                       "sync_mode": "fsdp"},
              f"(e) the world-2 snapshot's record: {e}")
        defer(len(e["losses"]) == DIST_ITERS - DIST_SAVE_AT
              and len(last["losses"]) == 1,
              f"(e) resumed iterations {e['losses']}, {last['losses']}")
        defer(e["update_distance_to_w2"] <= DIST_RESUME_UPDATE_TOL,
              f"(e) the resumed run against world 2's: {e}")
        if controls:
            ctl = dist_controls(out, w1, b, c)
            for what in ctl.pop("failed"):
                defer(False, what)
        launches = collections.Counter()
        runs = [*w1.values(), res1, whole, last,
                *(w[m] for w in w2 for m in w), *res2]
        for run in runs:
            launches.update(run["launches"])
    finally:
        shutil.rmtree(out, ignore_errors=True)
    log({"distributed": {
        "a_world1_nccl": a, "b_world2_gloo": b, "c_resnet50_b256": c,
        "d_perf": d, "e_elastic_resume": e,
        **({"controls": ctl} if controls else {}),
        "tolerances": {"w1_update": DIST_W1_UPDATE_TOL,
                       "w1_loss": DIST_W1_LOSS_TOL,
                       "w2_update": DIST_W2_UPDATE_TOL,
                       "w2_loss": DIST_W2_LOSS_TOL,
                       "resnet_buffer": DIST_RESNET_BUFFER_TOL,
                       "resnet_loss": DIST_RESNET_LOSS_TOL,
                       "resume_update": DIST_RESUME_UPDATE_TOL},
        "staged_collectives": "none (gloo takes CUDA tensors)",
        "launches": dict(launches), "spawn_s": spawn_s,
        "job_s": DIST_JOB_S,
        "phase_s": time.perf_counter() - t_phase}})
    check(not failed, "3o: " + " | ".join(failed))
    return dict(launches)


# ------------------------------------------ 3p. the model-parallel axes
MP_LAYERS = 4             # the 134m recipe cut to 4 layers (PERF.md §4)
MP_ITERS = 4              # (a): iterations a tensor-parallel run
MP_CP_ITERS = 3           # (b): iterations a context-parallel mode
MP_PROMPTS, MP_PROMPT_LEN, MP_NEW = 4, 128, 16   # (c)
MP_CLI_ITERS = 2          # (d)
MP_CP_MODES = (("ring", "contiguous"), ("ring", "zigzag"),
               ("ulysses", "contiguous"))
MP_SAMPLE_V = 64          # (b): log-probs held over the first 64 words
MP_TIMEOUT_S = 600        # one spawn's ranks, start to exit
# the tolerances (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): (a)
# the relative L2 distance of tp=2's parameter updates from world 1's
# LocalOptimizer, and the largest relative gap of their losses, set between
# the bf16 readings (0.0407-0.0409 and 0.0016-0.0020; in f32 1.8e-5 and
# 1.3e-6, so bf16 rounding is the cause) and the control with the region
# entries' backward all-reduce dropped (0.713 and 0.308;
# ``--model-parallel-controls``); (b) the
# gathered log-probs' largest gap from world 1's full attention, in bf16
# steps of each value (each rank's partials round apart), and the
# relative L2 distance of the first step's gradients (the ranks' sum)
# over a sample; (c) a greedy
# token that differs must sit within GAP_TOL's bf16 bound under a
# teacher-forced forward.
MP_UPDATE_TOL, MP_LOSS_TOL = 0.2, 0.05
MP_LOGP_TOL, MP_GRAD_TOL = 4.0, 0.05
MP_GAP_TOL = 0.1


def mp_model(dtype=None):
    """A fresh copy of the 134m recipe cut to MP_LAYERS layers (seed 7),
    built once a process; ``dtype``: cast (bf16 for (c))."""
    import copy
    if "mp" not in DIST_MODELS:
        from bigdl_tpu_torch.models.transformer import build_lm
        DIST_MODELS["mp"] = build_lm(VOCAB, **dict(CONFIG,
                                                   num_layers=MP_LAYERS),
                                     device="cuda", seed=7)
    model = copy.deepcopy(DIST_MODELS["mp"])
    return model if dtype is None else model.to(dtype)


def mp_sample(model) -> np.ndarray:
    """``dist_sample`` of the full leaves: a tensor-parallel model's are
    reassembled over its axis first (collective)."""
    if getattr(model, "_tp_mesh", None) is None:
        return dist_sample(model)
    from bigdl_tpu_torch.parallel.tensor_parallel import gather_full
    named = {n: p.detach() for n, p in model.named_parameters()}
    full = gather_full(model, named)
    with torch.no_grad():
        flat = torch.cat([full[n].float().reshape(-1) for n in named])
        return flat[::DIST_STRIDE].cpu().numpy()


def mp_mib(tensors) -> float:
    return sum(t.numel() * t.element_size() for t in tensors) / 2 ** 20


def mp_collectives(iters: int) -> dict:
    """COLLECTIVES' calls a step by ``op/axis``, MiB a step by op, and
    their share of the host clock."""
    from bigdl_tpu_torch.parallel import mesh as pmesh
    snap = pmesh.COLLECTIVES.snapshot()
    return {"per_step": {k: n / iters for k, n in snap["by_axis"].items()},
            "mib_per_step": {k: b / iters / 2 ** 20
                             for k, b in snap["bytes"].items()},
            "seconds": sum(snap["seconds"].values())}


def mp_reset() -> dict:
    from bigdl_tpu_torch.parallel import mesh as pmesh
    counters = flash_counters()
    for c in counters.values():
        c.reset()
    pmesh.COLLECTIVES.reset()
    return counters


def mp_tp_run(world: int, rank: int, out: str, sp: bool,
              precision: str = "bf16", tag: str = None,
              drop_entry_reduce: bool = False) -> dict:
    """(a): the cut 134m recipe (bf16 unless ``precision``, AdamW, clip
    1.0) on the whole batches (B=8, S=512, seed 17) for MP_ITERS
    iterations: at world 1 through ``LocalOptimizer``, at world 2 through
    ``Optimizer(topology=MeshTopology(tensor=2))`` with (``sp``) or without
    sequence-parallel regions. ``drop_entry_reduce``: the region entries'
    backward all-reduce left out (a control)."""
    import contextlib
    from unittest import mock
    from bigdl_tpu_torch.dataset.base import DataSet, DistributedDataSet
    from bigdl_tpu_torch.nn.criterion import FusedLMHeadCriterion
    from bigdl_tpu_torch.optim import AdamW, Optimizer, Trigger
    from bigdl_tpu_torch.parallel import tensor_parallel as tp
    from bigdl_tpu_torch.parallel.mesh import MeshTopology
    from bigdl_tpu_torch.utils.engine import Engine
    from bigdl_tpu_torch.parallel import mesh as pmesh
    t0 = time.perf_counter()
    model = mp_model()
    p0 = dist_sample(model)
    batches = dist_lm_batches(1, 0)[:MP_ITERS]
    if world == 1:
        opt = Optimizer(model, DataSet.array(batches, seed=0),
                        FusedLMHeadCriterion(), device="cuda")
    else:
        opt = Optimizer(model, DistributedDataSet(
            batches, shard_by_process=False, seed=0),
            FusedLMHeadCriterion(), device="cuda",
            topology=MeshTopology(tensor=world))
        if sp:
            check(tp.enable_sequence_parallel(model, opt.mesh) == MP_LAYERS,
                  "(a) enable_sequence_parallel tagged another count")
    box = []
    init = opt._init_opt_state
    opt._init_opt_state = lambda params: box.append(init(params)) or box[-1]
    (opt.set_precision(precision)
        .set_optim_method(AdamW(learningrate=TRAIN_LR,
                                weightdecay=TRAIN_DECAY))
        .set_gradient_clipping_by_l2_norm(TRAIN_CLIP)
        .set_end_when(Trigger.max_iteration(MP_ITERS)))
    dropped = (mock.patch.object(tp._CopyToRegion, "backward",
                                 staticmethod(lambda ctx, g: (g, None, None)))
               if drop_entry_reduce else contextlib.nullcontext())
    counters = mp_reset()
    pmesh.COLLECTIVES.sync_timing = Engine.backend() == "gloo"
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with dropped:
        opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    pmesh.COLLECTIVES.sync_timing = False
    res = {"losses": [h["loss"] for h in opt.history],
           "launches": {k: c.value for k, c in counters.items()},
           "collectives": mp_collectives(MP_ITERS), "wall_s": wall,
           "ms_per_iteration": float(np.median(
               [h["seconds"] for h in opt.history[1:]])) * 1e3,
           "resident_mib": {"params": mp_mib(model.parameters()),
                            "optim": mp_mib(
                                [t for t in _state_tensors(box[0])])}}
    res["collective_share"] = res["collectives"]["seconds"] / wall
    if world > 1 and not drop_entry_reduce:
        from bigdl_tpu_torch.parallel import comm_symbols as cs
        res["comm_model"] = comm_held(
            "tp-sp" if sp else "tp-megatron", pmesh.COLLECTIVES.snapshot(),
            MP_ITERS, cs.tp_symbols(model, opt.mesh, TRAIN_BATCH, TRAIN_SEQ,
                                    2 if precision == "bf16" else 4, True))
    name = tag or f"mp_tp{'_sp' if sp else ''}_w{world}"
    p = mp_sample(model)
    np.savez(os.path.join(out, f"{name}.{rank}.npz"), p0=p0, p=p)
    res["run_s"] = time.perf_counter() - t0
    del opt, model
    torch.cuda.empty_cache()
    return res


def _state_tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _state_tensors(v)]
    return [tree] if torch.is_tensor(tree) else []


def mp_tp_structure(sp: bool) -> dict:
    """(a)'s collectives a step at tp=2 by the path's structure: per layer
    the attention's and the FFN's region entry (backward: an all-reduce)
    and exit (forward: an all-reduce) or, with sequence-parallel regions,
    an all-gather in and a reduce-scatter out each way; the embedding's
    gathered rows and the tied head's gathered table (forward); the
    clip's squared norm; with sequence-parallel regions the stack's split
    (backward: a gather) and exit gather (forward) and the sequence
    blocks' replicated leaves summed."""
    n = MP_LAYERS
    if not sp:
        return {"all_reduce/tensor": 4 * n + 1, "all_gather/tensor": 2}
    return {"all_gather/tensor": 4 * n + 4, "reduce_scatter/tensor": 4 * n,
            "all_reduce/tensor": 2}


class _FirstGrads:
    """An optim method that records a sample of the first update's
    gradients (by parameter order) before delegating."""

    def __init__(self, inner, names):
        self.inner, self.names, self.sample = inner, names, None

    def update(self, grads, state, params, *rest):
        if self.sample is None:
            with torch.no_grad():
                flat = torch.cat([grads[n].float().reshape(-1)
                                  for n in self.names])
                self.sample = flat[::DIST_STRIDE].cpu().numpy()
        return self.inner.update(grads, state, params, *rest)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def mp_cp_logp(logp: torch.Tensor, targets: torch.Tensor) -> dict:
    """(b)'s view of a (B, S, V) log-prob tensor: each position's target
    log-prob and the first MP_SAMPLE_V words'."""
    tgt = (targets.to(torch.int64) - 1).clamp(0, VOCAB - 1)
    return {"target": logp.float().gather(-1, tgt[..., None])[..., 0]
            .cpu().numpy(),
            "head": logp[..., :MP_SAMPLE_V].float().cpu().numpy()}


def mp_cp_run(world: int, rank: int, out: str, mode: str,
              layout: str) -> dict:
    """(b): the cut 134m recipe with its attention over the ``seq`` axis
    (world 2: ``ContextParallelLM``; world 1: the whole model, kernel K1's
    full attention), bf16, AdamW, clip 1.0, on the first batch (B=8,
    S=512) for MP_CP_ITERS iterations; the initial log-probs (eval) and
    the first step's gradients sampled."""
    from bigdl_tpu_torch.nn import MultiHeadAttention
    from bigdl_tpu_torch.nn.criterion import FusedLMHeadCriterion
    from bigdl_tpu_torch.ops.precision import DtypePolicy
    from bigdl_tpu_torch.optim import AdamW
    from bigdl_tpu_torch.parallel.context import ContextParallelLM
    from bigdl_tpu_torch.parallel.mesh import MeshTopology
    from bigdl_tpu_torch.utils.engine import Engine
    from bigdl_tpu_torch.parallel import mesh as pmesh
    t0 = time.perf_counter()
    model = mp_model()
    batch = dist_lm_batches(1, 0)[0]
    tokens = torch.as_tensor(batch.data).cuda()
    targets = torch.as_tensor(batch.labels).cuda()
    crit, policy = FusedLMHeadCriterion(), DtypePolicy.bf16()
    params = {n: p for n, p in model.named_parameters()}
    method = _FirstGrads(AdamW(learningrate=TRAIN_LR,
                               weightdecay=TRAIN_DECAY), list(params))
    state = method.init_state(params)
    if world > 1:
        for m in model.modules():
            if isinstance(m, MultiHeadAttention):
                m.seq_axis, m.seq_mode, m.seq_layout = "seq", mode, layout
        lm = ContextParallelLM(model, MeshTopology(sequence=world).build(),
                               layout=layout)
        model.eval()
        with torch.no_grad():
            logp = lm.unshard(torch.func.functional_call(
                lm, {f"model.{n}": t for n, t in
                     policy.cast_params_for_compute(params).items()},
                (tokens,)))
        model.train()
        step = lambda: lm.train_step(tokens, targets, crit, method, state,
                                     params, precision=policy,
                                     clip_norm=TRAIN_CLIP)
    else:
        from bigdl_tpu_torch.optim.optimizer import make_grad_clipper
        clip = make_grad_clipper({"l2": TRAIN_CLIP})
        model.eval()
        with torch.no_grad():
            logp = torch.func.functional_call(
                model, policy.cast_params_for_compute(params), (tokens,))
        model.train()

        def step():
            for t in params.values():
                t.grad = None
            out = torch.func.functional_call(
                model, policy.cast_params_for_compute(params), (tokens,))
            loss = crit.forward(out, targets).float()
            loss.backward()
            with torch.no_grad():
                grads = clip({n: t.grad for n, t in params.items()})
                method.update(grads, state, params)
            return float(loss)
    view = mp_cp_logp(logp, targets)
    del logp
    counters = mp_reset()
    pmesh.COLLECTIVES.sync_timing = (world > 1
                                     and Engine.backend() == "gloo")
    losses, seconds = [], []
    for _ in range(MP_CP_ITERS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t1)
    pmesh.COLLECTIVES.sync_timing = False
    held = None
    if world > 1 and mode == "ring":
        from bigdl_tpu_torch.parallel import comm_symbols as cs
        held = comm_held("sp-ring", pmesh.COLLECTIVES.snapshot(), MP_CP_ITERS,
                         cs.ring_symbols(model, lm.mesh, TRAIN_BATCH,
                                         TRAIN_SEQ, 2))
    tag = f"mp_cp_{mode}_{layout}_w{world}" if world > 1 else "mp_cp_w1"
    np.savez(os.path.join(out, f"{tag}.{rank}.npz"), grads=method.sample,
             **{f"logp_{k}": v for k, v in view.items()})
    res = {"losses": losses,
           "launches": {k: c.value for k, c in counters.items()},
           "collectives": mp_collectives(MP_CP_ITERS),
           "ms_per_iteration": float(np.median(seconds[1:])) * 1e3,
           "run_s": time.perf_counter() - t0}
    if held is not None:
        res["comm_model"] = held
    del model, params, state
    torch.cuda.empty_cache()
    return res


def mp_cp_k1_structure(mode: str, layout: str, rank: int, p: int) -> int:
    """K1 launches a layer a step on ``rank`` of ``p`` (causal): a ring
    hop launches for a past chunk and the diagonal, none for a future
    one; a zigzag hop launches each live half-pair of its 4; Ulysses one
    launch of the whole sequence on the local heads."""
    if mode == "ulysses":
        return 1
    n = 0
    for t in range(p):
        src = (rank - t) % p
        if layout == "contiguous":
            n += src <= rank
        else:
            for q in (rank, 2 * p - 1 - rank):
                for k in (src, 2 * p - 1 - src):
                    n += k <= q
    return n


def mp_cp_structure(mode: str) -> dict:
    """(b)'s collectives a step at cp=2: per layer the ring's k and v
    shifts (P - 1 = 1 each way, staged through the host: gloo refuses CUDA
    tensors in send/recv) or Ulysses' 4 all-to-alls each way; the
    gradients' sum and the loss's mean."""
    n = MP_LAYERS
    core = ({"shift_staged/seq": 4 * n} if mode == "ring"
            else {"all_to_all/seq": 8 * n})
    return {**core, "all_reduce/seq": 2}


def mp_decode_run(world: int, rank: int, out: str) -> dict:
    """(c): the cut 134m recipe in bf16, MP_PROMPTS prompts of
    MP_PROMPT_LEN (seed 23), MP_NEW greedy tokens: at world 1 ``generate``;
    at world 2 dp-decode (``mesh=MeshTopology(data=2)``) and tp-decode
    (``MeshTopology(tensor=2)``, ``tensor_axis="tensor"``), each timed on
    a second call."""
    from bigdl_tpu_torch.models.generation import generate
    from bigdl_tpu_torch.parallel.mesh import MeshTopology
    model = mp_model(torch.bfloat16).eval()
    prompts = torch.as_tensor(np.random.default_rng(23).integers(
        1, VOCAB + 1, (MP_PROMPTS, MP_PROMPT_LEN)), device="cuda")
    runs = ({"w1": {}} if world == 1 else
            {"dp": {"mesh": MeshTopology(data=world).build()},
             "tp": {"mesh": MeshTopology(tensor=world).build(),
                    "tensor_axis": "tensor"}})
    res = {}
    for name, kw in runs.items():
        if "tensor_axis" in kw:   # sharded once, not each call
            from bigdl_tpu_torch.parallel import tensor_parallel as tp
            tp.shard_parameters(model, kw["mesh"])
            res["tp_resident_mib"] = mp_mib(model.parameters())
        generate(model, prompts, 2, greedy=True, **kw)   # warm
        counters = mp_reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate(model, prompts, MP_NEW, greedy=True, **kw)
        torch.cuda.synchronize()
        res[name] = {"tokens": toks[:, MP_PROMPT_LEN:].tolist(),
                     "ms_per_token": (time.perf_counter() - t0) * 1e3
                     / MP_NEW,
                     "launches": {k: c.value for k, c in counters.items()},
                     "collectives": mp_collectives(1)["per_step"]}
    if world == 1:
        res["prompts"] = prompts.tolist()
    return res


MP_JOBS = {
    "tp": lambda w, r, out: {
        "tp": mp_tp_run(w, r, out, sp=False),
        **({"sp": mp_tp_run(w, r, out, sp=True)} if w > 1 else {})},
    "cp": lambda w, r, out: {f"{m}_{l}": mp_cp_run(w, r, out, m, l)
                             for m, l in MP_CP_MODES},
    "cp_w1": lambda w, r, out: {"w1": mp_cp_run(w, r, out, "ring",
                                                "contiguous")},
    "decode": mp_decode_run,
    # --model-parallel-controls: (a) in f32, and with the region entries'
    # backward all-reduce dropped
    "tp_controls": lambda w, r, out: {
        "fp32": mp_tp_run(w, r, out, sp=False, precision="fp32",
                          tag=f"mp_tp_fp32_w{w}"),
        **({"dropped": mp_tp_run(w, r, out, sp=False, tag="mp_tp_dropped",
                                 drop_entry_reduce=True)} if w > 1 else {})},
}


def run_model_parallel_rank(jobs: str, out: str, backend: str) -> int:
    """One rank of phase 3p's world 2: joins the group from the BIGDL_*
    environment and writes each job's readings to
    ``out/<job>.w<world>.<rank>.json``."""
    from bigdl_tpu_torch.utils.engine import Engine
    Engine.init_distributed(backend=backend)
    rank, world = Engine.process_index(), Engine.process_count()
    try:
        for job in jobs.split(","):
            t0 = time.perf_counter()
            res = MP_JOBS[job](world, rank, out)
            res["job_s"] = time.perf_counter() - t0
            with open(os.path.join(out, f"{job}.w{world}.{rank}.json"),
                      "w") as f:
                json.dump(res, f)
    finally:
        Engine.shutdown_distributed()
    return 0


def mp_world1(jobs, out: str) -> float:
    """Phase 3p's world-1 yardsticks in this process (no group: a mesh of
    one needs none), written as a rank's would be; returns the seconds."""
    t = time.perf_counter()
    try:
        for job in jobs:
            t0 = time.perf_counter()
            res = MP_JOBS[job](1, 0, out)
            res["job_s"] = time.perf_counter() - t0
            with open(os.path.join(out, f"{job}.w1.0.json"), "w") as f:
                json.dump(res, f)
    finally:
        DIST_MODELS.pop("mp", None)
        torch.cuda.empty_cache()
    return time.perf_counter() - t


def mp_spawn(jobs, out: str) -> float:
    """Phase 3p's world-2 rank processes over the card (gloo), awaited."""
    argv = [sys.executable, os.path.abspath(__file__),
            "--model-parallel-rank", ",".join(jobs), "--dist-out", out,
            "--dist-backend", "gloo"]
    return dist_spawn(2, "gloo", jobs, out, argv=argv, timeout=MP_TIMEOUT_S)


def mp_cli(out: str) -> dict:
    """(d): ``python -m bigdl_tpu_torch.apps.transformer train`` with
    ``--tensorParallel 2`` and with ``--contextParallel ring``, each at
    world 2 over the card (gloo), MP_CLI_ITERS iterations, the two worlds
    started together; each one's exit, losses and seconds."""
    import re
    import threading
    base = [sys.executable, "-m", "bigdl_tpu_torch.apps.transformer",
            "train", "--vocab", str(VOCAB), "--embedDim",
            str(CONFIG["embed_dim"]), "--numHeads", str(CONFIG["num_heads"]),
            "--numLayers", "2", "--seqLen", str(TRAIN_SEQ), "-b",
            str(TRAIN_BATCH), "--synthetic-size",
            str(TRAIN_BATCH * MP_CLI_ITERS), "-e", "1", "--llamaBlock",
            "--backend", "gloo"]
    runs = {"tp": ["--tensorParallel", "2"],
            "cp": ["--contextParallel", "ring"]}
    res, errors = {}, []

    def one(name):
        sub = os.path.join(out, f"cli_{name}")
        os.makedirs(sub, exist_ok=True)
        try:
            res[name] = {"spawn_s": dist_spawn(
                2, "gloo", [name], sub, argv=base + runs[name],
                timeout=MP_TIMEOUT_S)}
        except RuntimeError as e:   # read after both have ended
            errors.append(f"(d) {name}: {e}")
            return
        with open(os.path.join(sub, "perf.w2.rank0.log")) as f:
            text = f.read()
        losses = [float(m.group(1)) for ln in text.splitlines()
                  if "Iteration" in ln for m in [re.search(
                      r"[Ll]oss (?:is )?([-+0-9.eEinaf]+?)\.?(?:\s|$)", ln)]
                  if m]
        res[name]["losses"] = losses
        if len(losses) != MP_CLI_ITERS or not np.isfinite(losses).all():
            errors.append(f"(d) {name}: losses {losses} in its log:\n"
                          f"{text[-2000:]}")
    threads = [threading.Thread(target=one, args=(n,)) for n in runs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errors, " | ".join(errors))
    return res


def mp_ranks(controls: bool = False) -> tuple:
    """Phase 3p's processes, in a new folder: the world-2 ranks, then (d)'s
    two CLI worlds. Returns (the folder, the spawns' seconds, (d)'s
    readings)."""
    import tempfile
    out = tempfile.mkdtemp(prefix="bigdl_mp_")
    try:
        spawn_s = {"w2": mp_spawn(["tp", "cp", "decode"] + (
            ["tp_controls"] if controls else []), out)}
        return out, spawn_s, mp_cli(out)
    except BaseException:
        shutil.rmtree(out, ignore_errors=True)
        raise


def run_model_parallel(controls: bool = False, ranks: Beside = None) -> dict:
    """Phase 3p; returns its K1-K3 launches, every rank's. ``controls``:
    also (a) in f32 at both worlds and with the region entries' backward
    all-reduce dropped, each held to its side of the tolerance.
    ``ranks``: ``mp_ranks`` already running beside earlier phases (the
    whole script starts it before phase 3i); None: they run here."""
    t_phase = time.perf_counter()
    if ranks is None:
        ranks = Beside(mp_ranks, controls)
    out, spawn_s, d = ranks.result()
    failed = []

    def defer(cond, what):
        if not cond:
            failed.append(what)
    launches = collections.Counter()
    try:
        spawn_s["w1_in_process"] = mp_world1(["tp", "cp_w1", "decode"] + (
            ["tp_controls"] if controls else []), out)
        w1 = dist_read(out, "tp", 1)
        w2 = [dist_read(out, "tp", 2, r) for r in range(2)]
        flash_want = all_mma_launches(MP_LAYERS * MP_ITERS)
        # (a) tensor parallelism
        a = {"w1": {"losses": w1["tp"]["losses"],
                    "ms_per_iteration": w1["tp"]["ms_per_iteration"],
                    "resident_mib": w1["tp"]["resident_mib"]}}
        for mode in ("tp", "sp"):
            r0 = w2[0][mode]
            a[mode] = {
                "update_distance": dist_update_distance(
                    out, f"mp_{'tp_sp' if mode == 'sp' else 'tp'}_w2",
                    "mp_tp_w1"),
                "loss_gap": dist_loss_gap(r0["losses"], w1["tp"]["losses"]),
                "losses": r0["losses"],
                "ms_per_iteration": r0["ms_per_iteration"],
                "collectives_per_step": r0["collectives"]["per_step"],
                "collective_mib_per_step": r0["collectives"]["mib_per_step"],
                "collective_share": r0["collective_share"],
                "resident_mib": r0["resident_mib"], "run_s": r0["run_s"]}
            a[mode]["comm_model"] = [comm_verdict(
                "3p", f"{mode}.rank{rank}", w2[rank][mode]["comm_model"],
                defer) for rank in range(2)]
            want = mp_tp_structure(mode == "sp")
            for rank in range(2):
                got = w2[rank][mode]["collectives"]["per_step"]
                defer(got == want, f"(a) {mode} rank {rank}: collectives a "
                      f"step {got}, want {want}")
                got = {k: w2[rank][mode]["launches"][k] for k in flash_want}
                defer(got == flash_want, f"(a) {mode} rank {rank}: K1-K3 "
                      f"{got}, want {flash_want}")
            defer(a[mode]["update_distance"] <= MP_UPDATE_TOL
                  and a[mode]["loss_gap"] <= MP_LOSS_TOL,
                  f"(a) {mode} at tp=2 against world 1: {a[mode]}")
            for part in ("params", "optim"):
                defer(r0["resident_mib"][part]
                      < 0.6 * w1["tp"]["resident_mib"][part],
                      f"(a) {mode}'s {part} are not split: "
                      f"{r0['resident_mib']} against {w1['tp']}")
        got = {k: w1["tp"]["launches"][k] for k in flash_want}
        defer(got == flash_want, f"(a) world 1: K1-K3 {got}")
        if controls:
            c1 = dist_read(out, "tp_controls", 1)
            c2 = dist_read(out, "tp_controls", 2)
            a["controls"] = {
                "fp32": {"update_distance": dist_update_distance(
                    out, "mp_tp_fp32_w2", "mp_tp_fp32_w1"),
                    "loss_gap": dist_loss_gap(c2["fp32"]["losses"],
                                              c1["fp32"]["losses"])},
                "dropped": {"update_distance": dist_update_distance(
                    out, "mp_tp_dropped", "mp_tp_w1"),
                    "loss_gap": dist_loss_gap(c2["dropped"]["losses"],
                                              w1["tp"]["losses"])}}
            drop = a["controls"]["dropped"]
            defer(drop["update_distance"] > MP_UPDATE_TOL,
                  f"control: (a) with the entries' backward all-reduce "
                  f"dropped passes (a)'s tolerance: {drop}")
        # (b) context parallelism
        cw1 = dist_read(out, "cp_w1", 1)["w1"]
        cw2 = [dist_read(out, "cp", 2, r) for r in range(2)]
        z1 = np.load(os.path.join(out, "mp_cp_w1.0.npz"))
        b = {"w1": {"losses": cw1["losses"],
                    "ms_per_iteration": cw1["ms_per_iteration"]}}
        for mode, layout in MP_CP_MODES:
            key = f"{mode}_{layout}"
            z2 = np.load(os.path.join(out, f"mp_cp_{key}_w2.0.npz"))
            # in units of the bf16 step at each value (2^-7 |x|, and 2^-7
            # below 1): the log-probs are bf16
            gap = max(float((np.abs(z2[f"logp_{v}"] - z1[f"logp_{v}"])
                             / (2 ** -7 * np.maximum(np.abs(z1[f"logp_{v}"]),
                                                     1.0))).max())
                      for v in ("target", "head"))
            g1, g2 = z1["grads"].astype(np.float64), z2["grads"]
            gdist = float(np.linalg.norm(g2 - g1) / np.linalg.norm(g1))
            r0 = cw2[0][key]
            b[key] = {"logp_gap": gap, "grad_distance": gdist,
                      "losses": r0["losses"],
                      "loss_gap": dist_loss_gap(r0["losses"][:1],
                                                cw1["losses"][:1]),
                      "ms_per_iteration": r0["ms_per_iteration"],
                      "collectives_per_step": r0["collectives"]["per_step"],
                      "collective_mib_per_step":
                          r0["collectives"]["mib_per_step"],
                      "run_s": r0["run_s"]}
            defer(gap <= MP_LOGP_TOL and gdist <= MP_GRAD_TOL,
                  f"(b) {key} against world 1's full attention: {b[key]}")
            if mode == "ring":
                b[key]["comm_model"] = [comm_verdict(
                    "3p", f"{key}.rank{rank}", cw2[rank][key]["comm_model"],
                    defer) for rank in range(2)]
            want = mp_cp_structure(mode)
            for rank in range(2):
                run = cw2[rank][key]
                defer(run["collectives"]["per_step"] == want,
                      f"(b) {key} rank {rank}: collectives a step "
                      f"{run['collectives']['per_step']}, want {want}")
                k1 = MP_LAYERS * MP_CP_ITERS * mp_cp_k1_structure(
                    mode, layout, rank, 2)
                kw = all_mma_launches(k1)
                got = {k: run["launches"][k] for k in kw}
                defer(got == kw, f"(b) {key} rank {rank}: K1-K3 {got}, "
                      f"want {kw}")
                b[key][f"k1_per_layer_step_rank{rank}"] = \
                    mp_cp_k1_structure(mode, layout, rank, 2)
        # (c) decoding over the mesh
        d1 = dist_read(out, "decode", 1)
        d2 = [dist_read(out, "decode", 2, r) for r in range(2)]
        c = {"w1_ms_per_token": d1["w1"]["ms_per_token"]}
        twin = mp_model(torch.bfloat16).eval()
        prompts = d1["prompts"]
        for name in ("dp", "tp"):
            got = d2[0][name]["tokens"]
            defer(got == d2[1][name]["tokens"],
                  f"(c) {name}: the ranks returned other tokens")
            differ = sum(g != w for g, w in zip(got, d1["w1"]["tokens"]))
            gap = greedy_gap(twin, list(zip(prompts, got))) if differ else 0.0
            c[name] = {"ms_per_token": d2[0][name]["ms_per_token"],
                       "rows_differing": differ, "greedy_gap": gap,
                       "collectives": d2[0][name]["collectives"]}
            defer(not differ or gap <= MP_GAP_TOL,
                  f"(c) {name}-decode's tokens differ from world 1's with a "
                  f"teacher-forced gap {gap} > {MP_GAP_TOL}")
        del twin
        torch.cuda.empty_cache()
        by_run = {}   # K1 launches of each run, every rank's
        for tag, runs in (("w2", w2), ("w2", cw2), ("w2", d2),
                          ("w1", [w1, {"cp": cw1}, d1])):
            for run in runs:
                for name, part in run.items():
                    if isinstance(part, dict) and "launches" in part:
                        launches.update(part["launches"])
                        key = f"{tag}:{name}"
                        by_run[key] = (by_run.get(key, 0)
                                       + part["launches"]["flash_fwd"])
    finally:
        shutil.rmtree(out, ignore_errors=True)
    log({"model_parallel": {
        "a_tensor_parallel": a, "b_context_parallel": b,
        "c_mesh_decode": c, "d_cli": d,
        "tolerances": {"update": MP_UPDATE_TOL, "loss": MP_LOSS_TOL,
                       "logp": MP_LOGP_TOL, "grad": MP_GRAD_TOL,
                       "gap": MP_GAP_TOL},
        "staged_collectives": "shift (gloo refuses CUDA tensors in "
                              "send/recv); all_to_all takes them",
        "layers": MP_LAYERS, "launches": dict(launches),
        "k1_by_run": by_run,
        "spawn_s": spawn_s, "job_s": DIST_JOB_S,
        "phase_s": time.perf_counter() - t_phase}})
    check(not failed, "3p: " + " | ".join(failed))
    return dict(launches)


# ------------------------------------------ 3q. the expert and pipeline axes
EP_EXPERTS = 8            # the 134m-8e configuration (scripts/moe_ablate.py)
EP_WIDTHS = dict(embed_dim=768, num_heads=12, ffn_dim=3072, max_len=1024)
EP_PERF_ITERS = 3         # (a): perf iterations after one warm-up
EP_LAYER_TOKENS = 8192    # (a): one 134m-8e layer's tokens (moe_ablate's)
EP_DECODE = (4, 128, 32)  # (a): prompts, prompt length, greedy tokens
EP_LAYERS = 4             # (b), (c): the 134m-8e LM cut to 4 layers
EP_ITERS = 3              # (b)
PP_MICRO = 4              # (c): GPipe's and the circular schedule's n_micro
PP_INTERLEAVE = 2         # (c): the circular schedule's V
FT_LAYERS, FT_ITERS = 2, 2   # (d): the 134m recipe cut to 2 layers
EP_TIMEOUT_S = 600        # one spawn's ranks, start to exit
# the tolerances (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6), each
# between the sound readings and the control that breaks its check
# (``--expert-pipeline-controls``; "sound / control"): (b) the relative
# L2 distance of world 2's parameter updates from world 1's (bf16:
# expert=2 0.0, data=2 0.068, f32 2.6e-6 and 1.5e-5, so bf16 rounding is
# the cause / routed per rank 0.589, which also moves 2,946 of the first
# forward's picks) and the largest relative gap of their losses (1.9e-5,
# f32 0.0 / routed per rank 1.5e-4); (c) the relative L2 distance of the
# first step's gradients from world 1's (GPipe bf16 0.0034, f32 6.8e-7 /
# a summing psum backward 0.99993), StagePipeline's in f32 (1.3e-6 / a
# summing psum backward 1.0) and the relative gap of the losses (bf16
# 0.0, f32 9.8e-8 / no psum forward 0.59); (d) the update distance (bf16
# 0.0498 / one data coordinate's gradients dropped 0.90) and the loss
# gap (2.9e-5 / dropped 2.2e-4).
EP_UPDATE_TOL, EP_LOSS_TOL = 0.2, 5e-5
PP_GRAD_TOL, PP_LOSS_TOL = 0.1, 1e-4
PP_STAGE_TOL = 1e-4
FT_UPDATE_TOL, FT_LOSS_TOL = 0.3, 8e-5


def ep_model(layers: int = EP_LAYERS, dtype=None):
    """The 134m-8e LM (the perf harness's transformer_134m widths, fused
    head, 8 experts, top-2) cut to ``layers`` layers, seed 7, a fresh copy
    of one built once a process."""
    import copy
    key = f"ep{layers}"
    if key not in DIST_MODELS:
        from bigdl_tpu_torch.models.transformer import build_lm
        DIST_MODELS[key] = build_lm(VOCAB, **EP_WIDTHS, num_layers=layers,
                                    fused_head=True, moe_experts=EP_EXPERTS,
                                    device="cuda", seed=7)
    model = copy.deepcopy(DIST_MODELS[key])
    return model if dtype is None else model.to(dtype)


def ep_moes(model) -> list:
    from bigdl_tpu_torch.parallel.expert import MoE
    return [m for m in model.modules() if isinstance(m, MoE)]


def ep_sample(model) -> np.ndarray:
    """``mp_sample`` of the full leaves, experts gathered over their axis
    (collective)."""
    if getattr(model, "_ep_mesh", None) is None:
        return mp_sample(model)
    from bigdl_tpu_torch.parallel.expert import gather_experts
    named = gather_experts(model, {n: p.detach()
                                   for n, p in model.named_parameters()})
    with torch.no_grad():
        flat = torch.cat([t.float().reshape(-1) for t in named.values()])
        return flat[::DIST_STRIDE].cpu().numpy()


class _FirstRouting:
    """Forward hooks keeping each MoE layer's routing of its first call."""

    def __init__(self, model):
        self.keep, self.handles = {}, []
        for i, m in enumerate(ep_moes(model)):
            m.record_routing = True
            self.handles.append(m.register_forward_hook(self._hook(i)))

    def _hook(self, i):
        def hook(mod, inp, out):   # returns None: the output stays
            if i not in self.keep:
                self.keep[i] = mod.routing["keep"].cpu().numpy()
        return hook

    def close(self):
        for h in self.handles:
            h.remove()


def ep_run(world: int, rank: int, out: str, mode: str,
           precision: str = "bf16", tag: str = None,
           local_routing: bool = False) -> dict:
    """(b): the 134m-8e LM cut to EP_LAYERS layers (bf16 unless
    ``precision``, AdamW, clip 1.0) on the recipe's first EP_ITERS batches
    (B=8, S=512, seed 17): at world 1 ``LocalOptimizer`` on the whole
    batches; at world 2 ``mode`` ``"expert"`` (``MeshTopology(expert=2)``,
    4 experts a rank, the batches on both ranks) or ``"data"``
    (``MeshTopology(data=2)``, each rank its half of the rows, global
    routing). The first forward's kept picks of every layer, the
    collectives, the launches and the experts' MiB at rest.
    ``local_routing``: each rank routes its tokens alone (a control)."""
    from unittest import mock
    from bigdl_tpu_torch.dataset.base import DataSet, DistributedDataSet
    from bigdl_tpu_torch.nn.criterion import FusedLMHeadCriterion
    from bigdl_tpu_torch.optim import AdamW, Optimizer, Trigger
    from bigdl_tpu_torch.parallel import distri_optimizer as dopt
    from bigdl_tpu_torch.parallel import mesh as pmesh
    from bigdl_tpu_torch.parallel.expert import MoE
    from bigdl_tpu_torch.parallel.mesh import MeshTopology
    from bigdl_tpu_torch.utils.engine import Engine
    t0 = time.perf_counter()
    model = ep_model()
    p0 = dist_sample(model)
    if world == 1:
        opt = Optimizer(model, DataSet.array(
            dist_lm_batches(1, 0)[:EP_ITERS], seed=0),
            FusedLMHeadCriterion(), device="cuda")
    else:
        n_data = world if mode == "data" else 1
        batches = dist_lm_batches(n_data, rank % n_data)[:EP_ITERS]
        opt = Optimizer(model, DistributedDataSet(
            batches, shard_by_process=False, seed=0),
            FusedLMHeadCriterion(), device="cuda",
            topology=MeshTopology(**{mode: world}))
    (opt.set_precision(precision)
        .set_optim_method(AdamW(learningrate=TRAIN_LR,
                                weightdecay=TRAIN_DECAY))
        .set_gradient_clipping_by_l2_norm(TRAIN_CLIP)
        .set_end_when(Trigger.max_iteration(EP_ITERS)))
    routing = _FirstRouting(model)
    local = (mock.patch.object(MoE, "_data_ranks", lambda self: (1, 0))
             if local_routing else contextlib.nullcontext())
    counters = mp_reset()
    pmesh.COLLECTIVES.sync_timing = Engine.backend() == "gloo"
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with local:
        opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    pmesh.COLLECTIVES.sync_timing = False
    routing.close()
    snap = pmesh.COLLECTIVES.snapshot()
    held = None
    if world > 1 and not local_routing:
        from bigdl_tpu_torch.parallel import comm_symbols as cs
        n_data = world if mode == "data" else 1
        sym = cs.moe_symbols(model, TRAIN_BATCH // n_data * TRAIN_SEQ,
                             2 if precision == "bf16" else 4, n_data, True)
        sym.update(P=cs.nbytes(model.parameters()), S_expert=world)
        held = comm_held("dp x ep" if mode == "data" else "ep", snap,
                         EP_ITERS, sym)
    experts = [getattr(m, n) for m in ep_moes(model)
               for n in ("w1", "b1", "w2", "b2")]
    res = {"losses": [h["loss"] for h in opt.history],
           "launches": {k: c.value for k, c in counters.items()},
           "collectives": dict(snap["by_axis"]),
           "collective_share": sum(snap["seconds"].values()) / wall,
           "wall_s": wall,
           "ms_per_iteration": float(np.median(
               [h["seconds"] for h in opt.history[1:]])) * 1e3,
           "expert_mib": mp_mib(experts),
           "params_mib": mp_mib(model.parameters()),
           "grad_buckets": len(dopt._buckets(
               [p for p in model.parameters() if p.requires_grad],
               dopt.BUCKET_BYTES))}
    if held is not None:
        res["comm_model"] = held
    name = tag or f"ep_{mode}_w{world}"
    keep = np.stack([routing.keep[i] for i in sorted(routing.keep)])
    np.savez(os.path.join(out, f"{name}.{rank}.npz"), p0=p0,
             p=ep_sample(model), keep=keep)
    res["run_s"] = time.perf_counter() - t0
    del opt, model
    torch.cuda.empty_cache()
    return res


def ep_structure(mode: str, buckets: int, layers: int = EP_LAYERS,
                 iters: int = EP_ITERS) -> dict:
    """(b)'s collectives over a run by the path's structure: under an
    expert axis, per layer and step, the experts' outputs all-gathered
    (forward) and the buffer's gradient all-gathered (the split's
    backward), and a step's clip of the expert leaves' squared norm;
    under a data axis, per layer and step, the counts all-gathered and
    ``frac`` all-reduced, and the data plane's ``buckets`` gradient
    all-reduces and the loss's a step and the epoch's agreement once."""
    if mode == "expert":
        return {"all_gather/expert": 2 * layers * iters,
                "all_reduce/expert": iters}
    return {"all_gather/data": layers * iters,
            "all_reduce/data": (layers + buckets + 1) * iters + 1}


PP_BLOCK = dict(embed_dim=768, num_heads=12, ffn_dim=3072)


def pp_stack(dtype):
    """(c)'s ``PipelineStack`` of 4 causal blocks at the 134m widths
    (seed 7), in ``dtype``."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.parallel.pipeline import PipelineStack
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(7)
        stack = PipelineStack(lambda: nn.TransformerEncoderLayer(
            PP_BLOCK["embed_dim"], PP_BLOCK["num_heads"], PP_BLOCK["ffn_dim"],
            causal=True), EP_LAYERS, device="cuda")
    return stack.to(dtype)


def pp_batch(dtype):
    gen = torch.Generator().manual_seed(29)
    x = torch.randn(TRAIN_BATCH, TRAIN_SEQ, PP_BLOCK["embed_dim"],
                    generator=gen)
    y = torch.randn(x.shape, generator=gen)
    return x.to("cuda", dtype), y.cuda()


def _grad_sample(grads) -> np.ndarray:
    with torch.no_grad():
        flat = torch.cat([g.float().reshape(-1) for g in grads])
        return flat[::DIST_STRIDE].cpu().numpy()


def pp_fault(mesh, fault: str = None):
    """A planted fault in the pipelines' closing psum, for a control:
    ``"summing"``, its backward all-reduces (P times the gradients);
    ``"no_psum"``, its forward leaves each rank its own outputs (a stage
    before the last keeps zeros); None, no fault."""
    from unittest import mock
    from bigdl_tpu_torch.parallel import tensor_parallel as tpmod
    if fault is None:
        return contextlib.nullcontext()
    if fault == "summing":
        return mock.patch.object(
            tpmod._ReduceFromRegion, "backward", staticmethod(
                lambda ctx, g: (mesh.all_reduce(g.contiguous().clone(),
                                                axis="pipe"), None, None)))
    return mock.patch.object(tpmod._ReduceFromRegion, "forward", staticmethod(
        lambda ctx, x, m, axis: x.contiguous().clone()))


def pp_run(world: int, rank: int, out: str, kind: str,
           precision: str = "bf16", remat: bool = False, tag: str = None,
           fault: str = None) -> dict:
    """(c): one loss and backward of the 4-block stack (``kind``
    ``"gpipe"`` or ``"circular"``, V=2) over ``MeshTopology(pipeline=2)``,
    MSE against a random target, B=8 S=512 in PP_MICRO microbatches; at
    world 1 ``scan_apply`` on the whole batch. The loss, a sample of the
    first step's gradients (the ranks' rows summed), the shifts and the
    launches. ``fault``: ``pp_fault``'s (a control)."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.parallel import mesh as pmesh
    from bigdl_tpu_torch.parallel.mesh import MeshTopology
    from bigdl_tpu_torch.parallel.pipeline import (circular_permutation,
                                                   gpipe_loss_fn)
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    stack = pp_stack(dtype)
    x, y = pp_batch(dtype)
    crit = nn.MSECriterion()
    head = lambda _, f: f.float()   # noqa: E731
    names = list(stack.parameter_tree())
    perm = None
    if world > 1 and kind == "circular":
        perm = torch.from_numpy(circular_permutation(
            EP_LAYERS, world, PP_INTERLEAVE)).long().cuda()
    leaves = {n: (p.detach()[perm] if perm is not None else p.detach())
              .clone().requires_grad_()
              for n, p in stack.parameter_tree().items()}
    if remat:   # the first checkpoint of a process sets itself up
        from bigdl_tpu_torch.ops import remat as remat_ops
        remat_ops.checkpoint(lambda t: t * 2, torch.ones(
            1, device="cuda", requires_grad=True)).sum().backward()
    counters = mp_reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if world == 1:
        loss = crit.forward(head(None, stack.scan_apply(leaves, x,
                                                        training=True)), y)
        loss.backward()
    else:
        mesh = MeshTopology(pipeline=world).build()
        fn = gpipe_loss_fn(stack, crit, mesh, PP_MICRO, head=head,
                           remat=remat, interleave=(PP_INTERLEAVE if
                                                    kind == "circular" else 1))
        with pp_fault(mesh, fault):
            loss = fn(leaves, None, x, y)
            loss.backward()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.value for k, c in counters.items()}
    shifts = dict(pmesh.COLLECTIVES.by_axis)
    held = None
    if world > 1 and kind == "gpipe" and not remat and fault is None:
        from bigdl_tpu_torch.parallel import comm_symbols as cs
        held = comm_held("pp-gpipe", pmesh.COLLECTIVES.snapshot(), 1,
                         cs.gpipe_symbols(x, PP_MICRO, mesh))
    grads = [leaves[n].grad for n in names]
    if world > 1:
        for g in grads:
            mesh.all_reduce(g, axis="pipe")
        if perm is not None:
            inv = torch.argsort(perm)
            grads = [g[inv] for g in grads]
    name = tag or f"pp_{kind}{'_remat' if remat else ''}_w{world}"
    np.savez(os.path.join(out, f"{name}.{rank}.npz"), g=_grad_sample(grads))
    res = {"loss": float(loss.detach()), "launches": launches,
           "collectives": shifts, "ms": wall * 1e3,
           "stage_mib": mp_mib([t for t in leaves.values()]) / max(
               1, world)}
    if held is not None:
        res["comm_model"] = held
    del stack, leaves, grads
    torch.cuda.empty_cache()
    return res


def stage_lm():
    """(c)'s heterogeneous LM: the 134m widths (gelu, unfused log-prob
    tail) cut to EP_LAYERS layers (seed 7), as 2 stages: embedding,
    position and 2 blocks | 2 blocks, final norm and head."""
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.nn.containers import Sequential
    lm = build_lm(VOCAB, **EP_WIDTHS, num_layers=EP_LAYERS, device="cuda",
                  seed=7)
    parts = list(lm._modules.values())
    enc = parts[2]
    layers = [enc._modules[f"layer{i}"] for i in range(EP_LAYERS)]
    s0 = Sequential().add(parts[0]).add(parts[1])
    for layer in layers[:EP_LAYERS // 2]:
        s0.add(layer)
    s1 = Sequential()
    for layer in layers[EP_LAYERS // 2:]:
        s1.add(layer)
    s1.add(enc.final_norm)
    for part in parts[3:]:
        s1.add(part)
    return [s0, s1]


def stage_run(world: int, rank: int, out: str, tag: str = None,
              fault: str = None) -> dict:
    """(c): one loss and backward of ``StagePipeline`` over
    ``MeshTopology(pipeline=2)`` (f32, PP_MICRO microbatches of 2) on the
    recipe's first batch; at world 1 ``sequential_apply``. The loss, a
    sample of the (P, L) gradient, the shifts and the launches.
    ``fault``: ``pp_fault``'s (a control)."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.parallel import mesh as pmesh
    from bigdl_tpu_torch.parallel.mesh import MeshTopology
    from bigdl_tpu_torch.parallel.pipeline import (StagePipeline,
                                                   stage_pipeline_loss_fn)
    batch = dist_lm_batches(1, 0)[0]
    ids = torch.as_tensor(batch.data).cuda()
    tgt = torch.as_tensor(batch.labels).cuda()
    pipe = StagePipeline(stage_lm(), ids[:TRAIN_BATCH // PP_MICRO].cpu()
                         .numpy(), device="cuda")
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion())
    stacked = torch.from_numpy(pipe.parameter_tree()).cuda()
    counters = mp_reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if world == 1:
        full = stacked.clone().requires_grad_()
        loss = crit.forward(pipe.sequential_apply(full, ids), tgt)
        loss.backward()
        grad = full.grad
    else:
        mesh = MeshTopology(pipeline=world).build()
        row = stacked[rank].clone().requires_grad_()
        with pp_fault(mesh, fault):
            loss = stage_pipeline_loss_fn(pipe, crit, mesh, PP_MICRO)(
                row, ids, tgt)
            loss.backward()
        snap = pmesh.COLLECTIVES.snapshot()
        grad = mesh.all_gather(row.grad.contiguous(), "pipe", dim=0).view(
            stacked.shape)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    np.savez(os.path.join(out, f"{tag or f'pp_stage_w{world}'}.{rank}.npz"),
             g=_grad_sample([grad]))
    res = {"loss": float(loss.detach()),
           "launches": {k: c.value for k, c in counters.items()},
           "collectives": dict(pmesh.COLLECTIVES.by_axis), "ms": wall * 1e3,
           "max_param_len": pipe.max_param_len}
    if world > 1 and fault is None:
        from bigdl_tpu_torch.parallel import comm_symbols as cs
        res["comm_model"] = comm_held("pp-stage", snap, 1,
                                      cs.stage_symbols(pipe, PP_MICRO, mesh))
    del pipe, stacked, grad
    torch.cuda.empty_cache()
    return res


def ft_drop_data(opt, dropped: int) -> None:
    """A planted fault for a control: the ranks of data coordinate
    ``dropped`` send zeros in place of their gradients (fsdp's
    reduce-scatters and the replicated leaves' all-reduce then carry the
    other coordinate's alone)."""
    if opt.mesh.axis_index("data") == dropped:
        inner = opt._apply_grads
        opt._apply_grads = lambda grads, *a, **k: inner(
            {n: torch.zeros_like(g) for n, g in grads.items()}, *a, **k)


def ft_run(world: int, rank: int, out: str, precision: str = "bf16",
           tag: str = None, drop_data: int = None) -> dict:
    """(d): the 134m recipe cut to FT_LAYERS layers (bf16, AdamW, clip
    1.0) for FT_ITERS iterations: at world 1 ``LocalOptimizer`` on the
    whole batches; at world 4 ``sync_mode="fsdp"`` over
    ``MeshTopology(data=2, tensor=2)``, each data coordinate its half of
    the rows. The losses, the update sample, the MiB at rest.
    ``drop_data``: ``ft_drop_data``'s fault (a control)."""
    import copy
    from bigdl_tpu_torch.dataset.base import DataSet, DistributedDataSet
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.nn.criterion import FusedLMHeadCriterion
    from bigdl_tpu_torch.optim import AdamW, Optimizer, Trigger
    from bigdl_tpu_torch.parallel import mesh as pmesh
    from bigdl_tpu_torch.parallel.mesh import MeshTopology
    from bigdl_tpu_torch.utils.engine import Engine
    t0 = time.perf_counter()
    if "ft" not in DIST_MODELS:
        DIST_MODELS["ft"] = build_lm(VOCAB, **dict(CONFIG,
                                                   num_layers=FT_LAYERS),
                                     device="cuda", seed=7)
    model = copy.deepcopy(DIST_MODELS["ft"])
    p0 = dist_sample(model)
    if world == 1:
        opt = Optimizer(model, DataSet.array(
            dist_lm_batches(1, 0)[:FT_ITERS], seed=0),
            FusedLMHeadCriterion(), device="cuda")
    else:
        data = rank // 2
        opt = Optimizer(model, DistributedDataSet(
            dist_lm_batches(2, data)[:FT_ITERS], shard_by_process=False,
            seed=0), FusedLMHeadCriterion(), device="cuda",
            topology=MeshTopology(data=2, tensor=2), sync_mode="fsdp")
        if drop_data is not None:
            ft_drop_data(opt, drop_data)
    (opt.set_precision(precision)
        .set_optim_method(AdamW(learningrate=TRAIN_LR,
                                weightdecay=TRAIN_DECAY))
        .set_gradient_clipping_by_l2_norm(TRAIN_CLIP)
        .set_end_when(Trigger.max_iteration(FT_ITERS)))
    box = []
    init = opt._init_opt_state
    opt._init_opt_state = lambda params: box.append(init(params)) or box[-1]
    counters = mp_reset()
    pmesh.COLLECTIVES.sync_timing = Engine.backend() == "gloo"
    opt.optimize()
    torch.cuda.synchronize()
    pmesh.COLLECTIVES.sync_timing = False
    resident = (opt.resident_mib() if hasattr(opt, "resident_mib") else
                {"params": mp_mib(model.parameters()),
                 "optim": mp_mib(_state_tensors(box[0]))})
    res = {"losses": [h["loss"] for h in opt.history],
           "launches": {k: c.value for k, c in counters.items()},
           "collectives": dict(pmesh.COLLECTIVES.by_axis),
           "ms_per_iteration": float(np.median(
               [h["seconds"] for h in opt.history])) * 1e3,
           "resident_mib": resident}
    np.savez(os.path.join(out, f"{tag or f'ft_w{world}'}.{rank}.npz"), p0=p0,
             p=mp_sample(model))
    res["run_s"] = time.perf_counter() - t0
    del opt, model
    torch.cuda.empty_cache()
    return res


EP_JOBS = {
    "ep": lambda w, r, out: ({"w1": ep_run(w, r, out, "w1")} if w == 1 else
                             {m: ep_run(w, r, out, m)
                              for m in ("expert", "data")}),
    "pp": lambda w, r, out: {
        "gpipe": pp_run(w, r, out, "gpipe"),
        **({"gpipe_remat": pp_run(w, r, out, "gpipe", remat=True),
            "circular": pp_run(w, r, out, "circular")} if w > 1 else {}),
        "stage": stage_run(w, r, out)},
    "ft": lambda w, r, out: {"ft": ft_run(w, r, out)},
    # --expert-pipeline-controls: (b) and (c) in f32, (b) routed per rank,
    # (c) with a summing psum backward and with no psum forward,
    # StagePipeline with a summing psum backward, (d) with one data
    # coordinate's gradients dropped
    "ep_controls": lambda w, r, out: (
        {"fp32": ep_run(w, r, out, "w1", "fp32", "ep_fp32_w1")} if w == 1
        else {"fp32_expert": ep_run(w, r, out, "expert", "fp32",
                                    "ep_fp32_expert_w2"),
              "fp32_data": ep_run(w, r, out, "data", "fp32",
                                  "ep_fp32_data_w2"),
              "local": ep_run(w, r, out, "data", tag="ep_local_w2",
                              local_routing=True)}),
    "pp_controls": lambda w, r, out: {
        "fp32": pp_run(w, r, out, "gpipe", "fp32",
                       tag=f"pp_fp32_w{w}"),
        **({"summing": pp_run(w, r, out, "gpipe", tag="pp_summing_w2",
                              fault="summing"),
            "no_psum": pp_run(w, r, out, "gpipe", tag="pp_no_psum_w2",
                              fault="no_psum"),
            "stage_summing": stage_run(w, r, out, "pp_stage_summing_w2",
                                       fault="summing")} if w > 1 else {})},
    "ft_controls": lambda w, r, out: {
        "drop_data1": ft_run(w, r, out, tag="ft_drop_data1_w4",
                             drop_data=1)},
}


def run_expert_pipeline_rank(jobs: str, out: str, backend: str) -> int:
    """One rank of phase 3q's worlds: joins the group from the BIGDL_*
    environment and writes each job's readings to
    ``out/<job>.w<world>.<rank>.json``."""
    from bigdl_tpu_torch.utils.engine import Engine
    Engine.init_distributed(backend=backend)
    rank, world = Engine.process_index(), Engine.process_count()
    try:
        for job in jobs.split(","):
            t0 = time.perf_counter()
            res = EP_JOBS[job](world, rank, out)
            res["job_s"] = time.perf_counter() - t0
            with open(os.path.join(out, f"{job}.w{world}.{rank}.json"),
                      "w") as f:
                json.dump(res, f)
    finally:
        Engine.shutdown_distributed()
    return 0


def ep_spawn(world: int, jobs, out: str) -> float:
    argv = [sys.executable, os.path.abspath(__file__),
            "--expert-pipeline-rank", ",".join(jobs), "--dist-out", out,
            "--dist-backend", "gloo"]
    return dist_spawn(world, "gloo", jobs, out, argv=argv,
                      timeout=EP_TIMEOUT_S)


def ep_cli(out: str) -> dict:
    """(e): ``transformer train --moeExperts 4`` (2 layers, 2 iterations)
    and ``perf --model transformer --moeExperts 4 --moeDispatch einsum``,
    two processes on the card at once; each one's exit and seconds."""
    runs = {"transformer": [
                "-m", "bigdl_tpu_torch.apps.transformer", "train",
                "--moeExperts", "4", "--vocab", str(VOCAB), "--embedDim",
                "768", "--numHeads", "12", "--numLayers", "2", "--seqLen",
                str(TRAIN_SEQ), "-b", str(TRAIN_BATCH), "--synthetic-size",
                str(2 * TRAIN_BATCH), "-e", "1"],
            "perf": ["-m", "bigdl_tpu_torch.apps.perf", "--model",
                     "transformer", "--moeExperts", "4", "--moeDispatch",
                     "einsum", "-b", str(TRAIN_BATCH), "-i", "2",
                     "--warmup", "1"]}
    res, errors = {}, []
    t0 = time.perf_counter()
    procs = {}
    for name, args in runs.items():   # both at once
        procs[name] = subprocess.Popen(
            [sys.executable, *args], cwd=DIST_ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        SPAWNED.append(procs[name])
    for name, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=CLI_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        res[name] = {"exit": proc.returncode,
                     "s": time.perf_counter() - t0}
        if proc.returncode != 0:
            errors.append(f"(e) {name} exited {proc.returncode}: "
                          f"{stderr[-2000:]}")
        elif name == "perf":
            res[name]["line"] = json.loads(stdout.strip().splitlines()[-1])
    check(not errors, " | ".join(errors))
    return res


def ep_ranks(out: str, parts=("w2", "w4"), controls: bool = False) -> dict:
    """Phase 3q's processes writing to ``out``, ``parts`` in turn:
    ``"w2"`` the world-2 ranks ((b), (c)), ``"w4"`` the world-4 ranks
    ((d)) beside (e)'s CLIs, then the world-1 yardsticks in a process of
    their own. Returns the spawns' seconds by world and (e)'s readings
    as ``"cli"``."""
    res = {}
    if "w2" in parts:
        res["w2"] = ep_spawn(2, ["ep", "pp"] + (
            ["ep_controls", "pp_controls"] if controls else []), out)
    if "w4" in parts:
        w4 = Beside(ep_spawn, 4, ["ft"] + (
            ["ft_controls"] if controls else []), out)
        res["cli"] = ep_cli(out)
        res["w4"] = w4.result()
        res["w1"] = ep_spawn(1, ["ep", "pp", "ft"] + (
            ["ep_controls", "pp_controls"] if controls else []), out)
    return res


def ep_perf_full() -> dict:
    """(a): ``perf --model transformer_134m --moeExperts 8`` (12 layers,
    S=1024) at B=8, EP_PERF_ITERS iterations after one: ms an iteration,
    peak MiB, the dispatch counter, the share of picks dropped (the first
    forward) and K1-K3 launches a step."""
    from bigdl_tpu_torch.telemetry import get_registry, instruments
    fam = instruments(get_registry()).moe_dispatch_total
    before = fam.labels(path="scatter").value
    counters = flash_counters()
    dropped = {}

    def record(opt_model):
        def hook_of(i):
            def hook(mod, inp, o):   # returns None: the output stays
                if i not in dropped:
                    dropped[i] = float(1.0 - mod.routing["keep"].float()
                                       .mean())
            return hook
        for i, m in enumerate(ep_moes(opt_model)):
            m.record_routing = True
            m.register_forward_hook(hook_of(i))
    from bigdl_tpu_torch.apps import perf as perf_app
    build = perf_app._build_model

    def built(*a, **k):
        out = build(*a, **k)
        record(out[0])
        return out
    perf_app._build_model = built
    try:
        row, losses, opt = perf_run(
            ["--model", "transformer_134m", "--moeExperts", str(EP_EXPERTS),
             "-b", str(TRAIN_BATCH), "-i", str(EP_PERF_ITERS), "--warmup",
             "1"], counters)
    finally:
        perf_app._build_model = build
    n = EP_PERF_ITERS + 1
    per_step = {k: v / n for k, v in row["launches"].items()}
    check(all(per_step[k] == 12 for k in ("flash_fwd", "flash_bwd_dq",
                                          "flash_bwd_dkv")),
          f"(a) perf 134m-8e: K1-K3 launches a step {per_step}, want 12")
    res = {"ms_per_iteration": float(np.mean(
               [h["seconds"] for h in opt.history[1:]])) * 1e3,
           "peak_allocated_mib": row["peak_allocated_mib"],
           "records_per_sec": row.get("records_per_sec"),
           "dispatch_counted": fam.labels(path="scatter").value - before,
           "dropped_share_first_forward": dropped,
           "launches_per_step": per_step, "losses": losses,
           "params": sum(p.numel() for p in opt.model.parameters()),
           "launches": row["launches"]}
    check(res["dispatch_counted"] >= 12 * n,
          f"(a) the dispatch counter read {res['dispatch_counted']}")
    del opt
    torch.cuda.empty_cache()
    return res


def ep_dispatch_layer() -> dict:
    """(a): one 134m-8e layer's MoE at T=8192 (bf16, training mode, the
    aux loss in): sort, scatter and einsum forward, input and parameter
    gradients bit for bit, and each one's forward + backward ms."""
    import copy
    from bigdl_tpu_torch.parallel.expert import MoE
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(7)
        base = MoE(768, 3072, EP_EXPERTS).cuda().to(torch.bfloat16)
    gen = torch.Generator().manual_seed(31)
    x = torch.randn(EP_LAYER_TOKENS, 768, generator=gen).cuda().to(
        torch.bfloat16)
    cot = torch.randn(x.shape, generator=gen).cuda().to(torch.bfloat16)
    runs, res = {}, {}
    for dispatch in ("sort", "scatter", "einsum"):
        m = copy.deepcopy(base)
        m.dispatch = dispatch
        m.train()

        def step():
            xx = x.clone().requires_grad_()
            m.zero_grad()
            (m(xx).float() * cot.float()).sum().backward()
            return xx
        step()   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            xx = step()
        torch.cuda.synchronize()
        res[f"{dispatch}_ms"] = (time.perf_counter() - t0) / 3 * 1e3
        with torch.no_grad():
            y = m(x)
        runs[dispatch] = (y, xx.grad, {n: p.grad.clone()
                                       for n, p in m.named_parameters()})
    y0, dx0, g0 = runs["sort"]
    for dispatch in ("scatter", "einsum"):
        y, dx, g = runs[dispatch]
        same = (torch.equal(y, y0) and torch.equal(dx, dx0)
                and all(torch.equal(g[n], g0[n]) for n in g0))
        res[f"{dispatch}_bit_equal"] = same
        check(same, f"(a) {dispatch} differs from sort on the card")
    del runs, base
    torch.cuda.empty_cache()
    return res


def ep_decode() -> dict:
    """(a): greedy decode of 4 prompts of 128 (seed 23), 32 tokens, on the
    12-layer 134m-8e LM in bf16: ms a token, and the same tokens with
    every layer's dispatch switched to einsum (the dispatches agree bit
    for bit)."""
    from bigdl_tpu_torch.models.generation import generate
    model = ep_model(12, torch.bfloat16).eval()
    n, s, new = EP_DECODE
    prompts = torch.as_tensor(np.random.default_rng(23).integers(
        1, VOCAB + 1, (n, s)), device="cuda")
    generate(model, prompts, 2, greedy=True, device="cuda")   # warm
    counters = mp_reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = generate(model, prompts, new, greedy=True, device="cuda")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / new
    launches = {k: c.value for k, c in counters.items()}
    for m in ep_moes(model):
        m.dispatch = "einsum"
    again = generate(model, prompts, new, greedy=True, device="cuda")
    same = bool(torch.equal(toks, again))
    check(same, "(a) decode: the einsum dispatch's tokens differ")
    del model
    DIST_MODELS.pop("ep12", None)
    torch.cuda.empty_cache()
    return {"ms_per_token": ms, "tokens_equal_einsum": same,
            "launches": launches}


def ep_dropped_equal(out: str, a: str, b: str, world_a: int) -> dict:
    """The first forward's kept picks of run ``a`` (every data rank's,
    rank-major) against run ``b``'s (world 1): whether every layer's
    picks are kept alike, the picks that differ and the share dropped."""
    ka = [np.load(os.path.join(out, f"{a}.{r}.npz"))["keep"]
          for r in range(world_a)]
    kb = np.load(os.path.join(out, f"{b}.0.npz"))["keep"]
    kept = np.concatenate(ka, axis=-1) if a.startswith(("ep_data",
                                                        "ep_local",
                                                        "ep_fp32_data")) \
        else ka[0]
    differ = int((kept != kb).sum())
    return {"equal": differ == 0 and kept.shape == kb.shape,
            "picks_differing": differ,
            "dropped_share": float(1.0 - kb.mean())}


def ep_controls(out: str, w1: dict, p1: dict, f1: dict, z_w1: dict, gdist,
                defer) -> dict:
    """Phase 3q's controls against world 1's sound runs: each planted
    fault must fail the check its limit sets (``defer`` records it)."""
    def rel(a, b):
        return abs(a - b) / abs(b)
    ctl = {}
    b1 = dist_read(out, "ep_controls", 1)
    b2 = dist_read(out, "ep_controls", 2)
    for mode in ("expert", "data"):
        ctl[f"b_fp32_{mode}"] = {
            "update_distance": dist_update_distance(
                out, f"ep_fp32_{mode}_w2", "ep_fp32_w1"),
            "loss_gap": dist_loss_gap(b2[f"fp32_{mode}"]["losses"],
                                      b1["fp32"]["losses"]),
            "dropped": ep_dropped_equal(out, f"ep_fp32_{mode}_w2",
                                        "ep_fp32_w1", 2)}
    local = ctl["b_local_routing"] = {
        "update_distance": dist_update_distance(out, "ep_local_w2",
                                                "ep_w1_w1"),
        "loss_gap": dist_loss_gap(b2["local"]["losses"], w1["losses"]),
        "dropped": ep_dropped_equal(out, "ep_local_w2", "ep_w1_w1", 2)}
    defer(not local["dropped"]["equal"], "control: (b) routed per rank "
          "keeps world 1's dropped picks")
    defer(local["update_distance"] > EP_UPDATE_TOL, f"control: (b) routed "
          f"per rank within the update limit: {local}")
    defer(local["loss_gap"] > EP_LOSS_TOL, f"control: (b) routed per rank "
          f"within the loss limit: {local}")
    q1 = dist_read(out, "pp_controls", 1)
    q2 = dist_read(out, "pp_controls", 2)
    z32 = np.load(os.path.join(out, "pp_fp32_w1.0.npz"))["g"]
    ctl["c_fp32"] = {"grad_distance": gdist("pp_fp32_w2", z32),
                     "loss_gap": rel(q2["fp32"]["loss"], q1["fp32"]["loss"])}
    for name, ref, tol, what in (
            ("summing", "gpipe", PP_GRAD_TOL, "grad_distance"),
            ("no_psum", "gpipe", PP_LOSS_TOL, "loss_gap"),
            ("stage_summing", "stage", PP_STAGE_TOL, "grad_distance")):
        got = ctl[f"c_{name}"] = {
            "grad_distance": gdist(f"pp_{name}_w2", z_w1[ref]),
            "loss_gap": rel(q2[name]["loss"], p1[ref]["loss"])}
        defer(got[what] > tol, f"control: (c) {name} within its "
              f"{what} limit {tol}: {got}")
    f4 = dist_read(out, "ft_controls", 4)
    drop = ctl["d_drop_data1"] = {
        "update_distance": dist_update_distance(out, "ft_drop_data1_w4",
                                                "ft_w1"),
        "loss_gap": dist_loss_gap(f4["drop_data1"]["losses"],
                                  f1["losses"])}
    defer(drop["update_distance"] > FT_UPDATE_TOL, f"control: (d) with a "
          f"data coordinate dropped within the update limit: {drop}")
    defer(drop["loss_gap"] > FT_LOSS_TOL, f"control: (d) with a data "
          f"coordinate dropped within the loss limit: {drop}")
    ctl["w1"] = {k: v["losses"] if "losses" in v else v["loss"]
                 for k, v in {**b1, **q1}.items()}
    return ctl


def run_expert_pipeline(controls: bool = False, ranks: tuple = None) -> dict:
    """Phase 3q; returns its K1-K3 launches, every process's. ``controls``:
    also (b) and (c) in f32 at both worlds, (b) routed per rank, (c) with
    a summing psum backward and with no psum forward, ``StagePipeline``
    with a summing psum backward and (d) with a data coordinate's
    gradients dropped, each held to its side of the tolerance. ``ranks``:
    (the folder, the ``ep_ranks`` already running beside earlier phases;
    the whole script starts the world-2 ranks before phase 3g and the
    world-4 ranks, the CLIs and world 1 before phase 3l); None: they run
    here."""
    from bigdl_tpu_torch.parallel.pipeline import schedule_length
    t_phase = time.perf_counter()
    if ranks is None:
        out = tempfile.mkdtemp(prefix="bigdl_ep_")
        ranks = (out, [Beside(ep_ranks, out, ("w2", "w4"), controls)])
    out, besides = ranks
    failed = []

    def defer(cond, what):
        if not cond:
            failed.append(what)
    launches = collections.Counter()
    a = {}
    try:
        a["perf"] = ep_perf_full()
        launches.update(a["perf"].pop("launches"))
        a["layer"] = ep_dispatch_layer()
        a["decode"] = ep_decode()
        launches.update(a["decode"].pop("launches"))
        spawn_s = {}
        for part in besides:
            spawn_s.update(part.result())
        e = spawn_s.pop("cli")
        flash3 = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
        # (b) the expert axis and global routing
        w1 = dist_read(out, "ep", 1)["w1"]
        w2 = [dist_read(out, "ep", 2, r) for r in range(2)]
        b = {"w1": {k: w1[k] for k in ("losses", "ms_per_iteration",
                                       "expert_mib", "params_mib")}}
        for mode in ("expert", "data"):
            r0 = w2[0][mode]
            b[mode] = {
                "update_distance": dist_update_distance(
                    out, f"ep_{mode}_w2", "ep_w1_w1"),
                "loss_gap": dist_loss_gap(r0["losses"], w1["losses"]),
                "dropped": ep_dropped_equal(out, f"ep_{mode}_w2",
                                            "ep_w1_w1", 2),
                **{k: r0[k] for k in ("losses", "ms_per_iteration",
                                      "expert_mib", "collective_share",
                                      "run_s")},
                "collectives": r0["collectives"]}
            defer(b[mode]["update_distance"] <= EP_UPDATE_TOL
                  and b[mode]["loss_gap"] <= EP_LOSS_TOL,
                  f"(b) {mode} against world 1: {b[mode]}")
            defer(b[mode]["dropped"]["equal"],
                  f"(b) {mode}: the first forward's dropped picks differ "
                  f"from world 1's: {b[mode]['dropped']}")
            b[mode]["comm_model"] = [comm_verdict(
                "3q", f"ep_{mode}.rank{rank}", w2[rank][mode]["comm_model"],
                defer) for rank in range(2)]
            want = ep_structure(mode, r0["grad_buckets"])
            for rank in range(2):
                got = w2[rank][mode]["collectives"]
                sub = {k: got.get(k, 0) for k in want}
                defer(sub == want, f"(b) {mode} rank {rank}: collectives "
                      f"{sub}, want {want}")
                got = {k: w2[rank][mode]["launches"][k] for k in flash3}
                want_k = {k: EP_LAYERS * EP_ITERS for k in flash3}
                defer(got == want_k, f"(b) {mode} rank {rank}: K1-K3 {got}")
            if mode == "expert":
                ratio = r0["expert_mib"] / w1["expert_mib"]
                b[mode]["expert_mib_ratio"] = ratio
                defer(0.45 < ratio < 0.55, f"(b) expert MiB at rest "
                      f"{r0['expert_mib']} against {w1['expert_mib']}")
        # (c) pipelines
        p1 = dist_read(out, "pp", 1)
        p2 = [dist_read(out, "pp", 2, r) for r in range(2)]
        c = {"w1": {k: {"loss": v["loss"], "ms": v["ms"]}
                    for k, v in p1.items()}}
        z_w1 = {k: np.load(os.path.join(out, f"pp_{k}_w1.0.npz"))["g"]
                for k in ("gpipe", "stage")}

        def gdist(name, ref):
            g = np.load(os.path.join(out, f"{name}.0.npz"))["g"]
            r = ref.astype(np.float64)
            return float(np.linalg.norm(g - r) / np.linalg.norm(r))
        for kind in ("gpipe", "gpipe_remat", "circular", "stage"):
            run = p2[0][kind]
            ref_key = "stage" if kind == "stage" else "gpipe"
            name = ("pp_stage_w2" if kind == "stage"
                    else f"pp_{kind}_w2")
            c[kind] = {"loss": run["loss"],
                       "loss_gap": abs(run["loss"] - p1[ref_key]["loss"])
                       / abs(p1[ref_key]["loss"]),
                       "grad_distance": gdist(name, z_w1[ref_key]),
                       "ms": run["ms"], "collectives": run["collectives"]}
            if kind in ("gpipe", "stage"):
                c[kind]["comm_model"] = [comm_verdict(
                    "3q", f"{kind}.rank{rank}", p2[rank][kind]["comm_model"],
                    defer) for rank in range(2)]
            tol = PP_STAGE_TOL if kind == "stage" else PP_GRAD_TOL
            defer(c[kind]["grad_distance"] <= tol
                  and c[kind]["loss_gap"] <= PP_LOSS_TOL,
                  f"(c) {kind} against world 1: {c[kind]}")
            steps = (schedule_length(PP_MICRO, 2, PP_INTERLEAVE)
                     if kind == "circular" else schedule_length(PP_MICRO, 2))
            for rank in range(2):
                got = p2[rank][kind]["collectives"].get("shift_staged/pipe",
                                                        0)
                defer(got == 2 * steps, f"(c) {kind} rank {rank}: "
                      f"{got} staged shifts, want {2 * steps}")
                # each stage holds EP_LAYERS / 2 layers; every microbatch
                # crosses each (remat: the forward once more)
                k1 = EP_LAYERS // 2 * PP_MICRO
                want_k = {"flash_fwd": k1 * (2 if kind == "gpipe_remat"
                                             else 1),
                          "flash_bwd_dq": k1, "flash_bwd_dkv": k1}
                got = {k: p2[rank][kind]["launches"][k] for k in want_k}
                defer(got == want_k, f"(c) {kind} rank {rank}: K1-K3 "
                      f"{got}, want {want_k}")
        # remat changes no gradient
        ga, gb = (np.load(os.path.join(out, f"pp_{k}_w2.0.npz"))["g"]
                  for k in ("gpipe", "gpipe_remat"))
        c["remat_grads_equal"] = bool(np.array_equal(ga, gb))
        defer(c["remat_grads_equal"], "(c) remat moved the gradients")
        # (d) fsdp x tensor
        f1 = dist_read(out, "ft", 1)["ft"]
        f4 = [dist_read(out, "ft", 4, r) for r in range(4)]
        d = {"w1": {k: f1[k] for k in ("losses", "ms_per_iteration",
                                       "resident_mib")},
             "w4": {"update_distance": dist_update_distance(
                 out, "ft_w4", "ft_w1"),
                 "loss_gap": dist_loss_gap(f4[0]["ft"]["losses"],
                                           f1["losses"]),
                 **{k: f4[0]["ft"][k] for k in ("losses", "ms_per_iteration",
                                                "resident_mib")}}}
        defer(d["w4"]["update_distance"] <= FT_UPDATE_TOL
              and d["w4"]["loss_gap"] <= FT_LOSS_TOL,
              f"(d) fsdp x tensor against world 1: {d['w4']}")
        for rank in range(4):
            mib = f4[rank]["ft"]["resident_mib"]
            for part in ("params", "optim"):
                defer(mib[part] < 0.35 * f1["resident_mib"][part],
                      f"(d) rank {rank}'s {part} at rest {mib[part]} "
                      f"against world 1's {f1['resident_mib'][part]}")
            got = {k: f4[rank]["ft"]["launches"][k] for k in flash3}
            want_k = {k: FT_LAYERS * FT_ITERS for k in flash3}
            defer(got == want_k, f"(d) rank {rank}: K1-K3 {got}")
        if controls:
            c["controls"] = ep_controls(out, w1, p1, f1, z_w1, gdist, defer)
        for runs in (w2, p2, f4, [dist_read(out, "ep", 1),
                                  dist_read(out, "pp", 1),
                                  dist_read(out, "ft", 1)]):
            for run in runs:
                for part in run.values():
                    if isinstance(part, dict) and "launches" in part:
                        launches.update(part["launches"])
    finally:
        shutil.rmtree(out, ignore_errors=True)
    log({"expert_pipeline": {
        "a_moe_full": a, "b_expert_axis": b, "c_pipeline": c,
        "d_fsdp_tensor": d, "e_cli": e,
        "tolerances": {"update": EP_UPDATE_TOL, "loss": EP_LOSS_TOL,
                       "pp_grad": PP_GRAD_TOL, "pp_stage": PP_STAGE_TOL,
                       "pp_loss": PP_LOSS_TOL,
                       "ft_update": FT_UPDATE_TOL, "ft_loss": FT_LOSS_TOL},
        "launches": dict(launches), "spawn_s": spawn_s,
        "job_s": DIST_JOB_S, "phase_s": time.perf_counter() - t_phase}})
    check(not failed, "3q: " + " | ".join(failed))
    return dict(launches)


# ------------------------------------------------------- 3r. the analyser
COMM_RTOL = 0.0           # (c): the byte model against the counted bytes
COMM_HELD = []            # (c): every rank's verdict, gathered by 3o-3q
COMM_EXPECTED = 22        # 3o 3 modes, 3p tp/sp and 2 rings, 3q 2 + 2; x2
ANALYSIS_TIMEOUT_S = 600  # (a) each lint process; (b) the rules' process

_LINT_WARM = r"""
import collections, json, os, sys, time
sys.path.insert(0, os.getcwd())
from bigdl_tpu_torch.analysis import core
from bigdl_tpu_torch.analysis.__main__ import default_paths
parsed = [0]
parse = core.FileContext.parse.__func__
def counted(cls, *a, **k):
    parsed[0] += 1
    return parse(cls, *a, **k)
core.FileContext.parse = classmethod(counted)
t0 = time.perf_counter()
warm = core.lint_paths(default_paths())
print(json.dumps({"warm_s": time.perf_counter() - t0,
                  "warm_parsed": parsed[0], "files": len(warm),
                  "json": core.render_json(warm)}))
"""


def comm_held(mode: str, snapshot: dict, steps: int, symbols: dict) -> dict:
    """(c) of phase 3r in a rank process: the port's byte model for
    ``mode`` at this run's symbols against the run's ``COLLECTIVES``
    snapshot (payload bytes by op and axis), and its control, the model
    with its first term dropped, which must fail the same tolerance."""
    from bigdl_tpu_torch.parallel import comm_symbols as cs
    sound = cs.held(mode, snapshot, steps, symbols, rtol=COMM_RTOL)
    ctl = cs.held(mode, snapshot, steps, symbols, rtol=COMM_RTOL, drop=0)
    return {"mode": mode, "steps": steps, "ok": sound["ok"],
            "control_fails": not ctl["ok"],
            "rows": {r["key"]: [r["model"], r["counted"]]
                     for r in sound["rows"]},
            "max_rel_err": max((r["rel_err"] for r in sound["rows"]),
                               default=0.0)}


def comm_verdict(phase: str, run: str, held: dict, defer) -> dict:
    """Record a rank's (c) verdict for phase 3r and defer its check."""
    COMM_HELD.append({"phase": phase, "run": run, **held})
    defer(held["ok"] and held["control_fails"],
          f"(3r c) {phase} {run}: the byte model against the counted "
          f"bytes: {held}")
    return held["rows"]


def self_lint() -> dict:
    """(a): ``python -m bigdl_tpu_torch.analysis`` cold (a new cache) and
    warm (its hit) as processes, and a warm pass that counts the files it
    parses; the host CPU's name."""
    cache_dir = tempfile.mkdtemp(prefix="graftlint_")
    env = dict(os.environ, GRAFTLINT_CACHE=cache_dir)
    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    try:
        for kind in ("cold", "warm"):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m",
                                "bigdl_tpu_torch.analysis", "--format",
                                "json"], cwd=root, env=env,
                               capture_output=True, text=True,
                               timeout=ANALYSIS_TIMEOUT_S)
            out[f"{kind}_s"] = time.perf_counter() - t0
            out[f"{kind}_exit"] = r.returncode
            report = json.loads(r.stdout)
            out[f"{kind}_report"] = report
        probe = subprocess.run([sys.executable, "-c", _LINT_WARM], cwd=root,
                               env=env, capture_output=True, text=True,
                               timeout=ANALYSIS_TIMEOUT_S)
        check(probe.returncode == 0, f"(3r a) the warm probe failed: "
              f"{probe.stderr[-2000:]}")
        warm = json.loads(probe.stdout.strip().splitlines()[-1])
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    cold = out.pop("cold_report")
    same = out.pop("warm_report") == cold == json.loads(warm.pop("json"))
    cpu = host_cpu()
    return {**out, "exit": out["cold_exit"], "files": cold["files"],
            "findings": collections.Counter(
                f["code"] for f in cold["findings"]),
            "suppressed": collections.Counter(
                f["code"] for f in cold["suppressed"]),
            "warm_in_process_s": warm["warm_s"],
            "warm_parsed": warm["warm_parsed"], "warm_equal": same,
            "host_cpu": cpu, "cpus": os.cpu_count()}


def host_cpu() -> str:
    """The host CPU as ``/proc/cpuinfo`` names it: its model name, vendor,
    family and model (a sandboxed host may report the name "unknown")."""
    import platform
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if not ln.strip():
                    break          # the first processor's block
                key, _, value = ln.partition(":")
                fields[key.strip().lower()] = value.strip()
    except OSError:
        pass
    parts = [fields.get(k) for k in ("model name", "vendor_id",
                                     "cpu family", "model")]
    named = [p for p in parts if p]
    return ", ".join(named) or platform.machine()


def _run_fixture(src: str, name: str) -> dict:
    """Execute a fixture's source and call its ``run("cuda")``."""
    ns = {"__name__": f"graftlint_fixture_{name}"}
    t0 = time.perf_counter()
    try:
        exec(compile(src, f"<{name}>", "exec"), ns)
        res = ns["run"]("cuda")
    except Exception as e:   # noqa: BLE001 - a fixture that fails is read
        res = {"error": f"{type(e).__name__}: {e}"[:300]}
    torch.cuda.synchronize()
    res["s"] = time.perf_counter() - t0
    return {k: v for k, v in res.items()
            if isinstance(v, (bool, int, float, str, type(None)))}


def capture_rules() -> dict:
    """(b): each capture rule's positive and near-miss fixture linted,
    then run under ``GraphedProgram`` on the card. A row holds when the
    analyser flags the positive and not the near-miss, the positive shows
    its hazard, and the near-miss captures and replays equal to eager."""
    from bigdl_tpu_torch.analysis import lint_source
    from bigdl_tpu_torch.analysis.fixtures import FIXTURES, RUNNABLE
    rows = {}
    for row, codes in RUNNABLE.items():
        fire, ok = FIXTURES[codes[0]]
        tag = row.replace("/", "_").lower()
        got_fire = {f.code for f in lint_source(f"{tag}_fire.py", fire)
                    .findings}
        got_ok = {f.code for f in lint_source(f"{tag}_ok.py", ok).findings}
        near = _run_fixture(ok, f"{tag}_ok")
        pos = _run_fixture(fire, f"{tag}_fire")
        r = {"flags_positive": set(codes) <= got_fire,
             "flags_near_miss": sorted(got_ok & set(codes)),
             "hazard_shown": pos.get("hazard") is True,
             "near_miss_replays_equal_eager": bool(
                 near.get("captured") and near.get("equal_to_eager")),
             "positive": pos, "near_miss": near}
        r["ok"] = (r["flags_positive"] and not r["flags_near_miss"]
                   and r["hazard_shown"]
                   and r["near_miss_replays_equal_eager"])
        rows[row] = r
    return rows


def capture_rules_process() -> dict:
    """(b) in a process of its own (``python3 chip_smoke.py
    --capture-rules``): a capture the positives make fail stays out of
    this process's CUDA context."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--capture-rules"], capture_output=True, text=True,
                       timeout=ANALYSIS_TIMEOUT_S)
    lines = [ln for ln in r.stdout.splitlines()
             if ln.startswith('{"capture_rules"')]
    check(r.returncode == 0 and lines, f"(3r b) the capture-rules process "
          f"exited {r.returncode}: {r.stderr[-3000:]}")
    return json.loads(lines[-1])["capture_rules"]


def run_analysis(lint: "Beside", rules: "Beside",
                 comm_required: bool = True) -> None:
    """Phase 3r: (a) the self-lint's reading, (b) the capture rules held
    to the card, one row a rule, (c) the byte model's verdicts that
    phases 3o-3q gathered."""
    t_phase = time.perf_counter()
    failed = []

    def defer(cond, what):
        if not cond:
            failed.append(what)
    a = lint.result()
    defer(a["exit"] == 0 and a["warm_exit"] == 0 and not a["findings"],
          f"(3r a) the self-lint reports findings: {a}")
    defer(a["warm_parsed"] == 0 and a["warm_equal"],
          f"(3r a) the warm pass parsed files or differs: {a}")
    b = rules.result()
    for row, r in b.items():
        log({"capture_rule": row, **r})
        defer(r["ok"], f"(3r b) {row}: {r}")
    c = {"held": len(COMM_HELD),
         "ok": sum(1 for h in COMM_HELD if h["ok"] and h["control_fails"]),
         "rtol": COMM_RTOL,
         "runs": {f"{h['phase']}:{h['run']}": {
             "mode": h["mode"], "ok": h["ok"],
             "control_fails": h["control_fails"],
             "max_rel_err": h["max_rel_err"], "rows": h["rows"]}
             for h in COMM_HELD},
         "note": "payload algebra over gloo on one card, not NVLink wire "
                 "time",
         "hbm_bound": "not held: no tracked_jit site of the port records "
                      "bytes_accessed (CompileEvent.bytes_accessed is None)"}
    if comm_required:
        defer(c["held"] >= COMM_EXPECTED and c["ok"] == c["held"],
              f"(3r c) {c['ok']} of {c['held']} byte-model verdicts hold "
              f"(want {COMM_EXPECTED})")
    log({"analysis": {"a_self_lint": a,
                      "b_capture_rules": {k: v["ok"] for k, v in b.items()},
                      "c_comm_model": c,
                      "phase_s": time.perf_counter() - t_phase}})
    check(not failed, "3r: " + " | ".join(failed))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--resnet-grad-seeds", type=int, nargs="+", metavar="SEED",
        help="run only the kernels' build and phase 3c's ResNet-50 gradient "
             "check against the f64 reference, once per seed, and print "
             "each seed's readings (no result line)")
    parser.add_argument(
        "--time-kernels-of", metavar="DIR",
        help="import bigdl_tpu_torch from DIR (e.g. an unpacked earlier "
             "commit), build its kernels, time K1-K6 as phase 4 does and "
             "K7b, K7c and copy_ with DIR's probe, and print the rows (no "
             "result line)")
    parser.add_argument(
        "--gc-trace-of", nargs=argparse.REMAINDER, metavar="DIR",
        help="run DIR's chip_smoke.py (with the arguments that follow) in "
             "this process and print one gc_trace line after its output: "
             "the cyclic collections that freed device memory, by phase")
    parser.add_argument(
        "--resume-helper", metavar="DIR",
        help="phase 3h's fresh process: auto_resume the 134m run from the "
             "snapshots in DIR, train to its end and print one "
             "resume_helper line (no result line)")
    parser.add_argument("--steps-per-dispatch", type=int, default=1,
                        help="with --resume-helper: the windows' k")
    parser.add_argument(
        "--zoo-only", action="store_true",
        help="run only the kernels' build, phase 3i (the conv zoo) and its "
             "kernel rows, and print them (no result line)")
    parser.add_argument(
        "--perf-only", action="store_true",
        help="run only the kernels' build, phase 3j (the perf harness) and "
             "its kernel rows, and print them (no result line)")
    parser.add_argument(
        "--text-only", action="store_true",
        help="run only the kernels' build and phase 3l (text, tokenizers, "
             "summaries and the text apps on the card) and print its lines "
             "(no result line)")
    parser.add_argument(
        "--files-only", action="store_true",
        help="run only the kernels' build and phase 3m (model files, image "
             "ingestion and their apps on the card) and print its lines (no "
             "result line)")
    parser.add_argument(
        "--platform-only", action="store_true",
        help="run only the kernels' build and phase 3n (the platform "
             "planes: the ingest engine feeding ResNet-50, profiling and "
             "MFU, sharded snapshots, the scoreboard) and print its lines "
             "(no result line)")
    parser.add_argument(
        "--distributed-only", action="store_true",
        help="run only the kernels' build and phase 3o (the data-parallel "
             "plane: DistriOptimizer's modes at world 1 and 2, ResNet-50 "
             "with synchronized batch norm, perf --distributed, an elastic "
             "resume) and print its lines (no result line)")
    parser.add_argument(
        "--distributed-controls", action="store_true",
        help="with --distributed-only: also run the controls that set phase "
             "3o's tolerances ((b) in f32 at both worlds, (b) with rank 1's "
             "gradients dropped, (c) with per-replica batch statistics), "
             "each held to fail the check it sets")
    parser.add_argument(
        "--distributed-rank", metavar="JOBS",
        help="phase 3o's rank process: run JOBS (comma-separated) in the "
             "process group of the BIGDL_* environment")
    parser.add_argument(
        "--model-parallel-only", action="store_true",
        help="run only the kernels' build and phase 3p (the tensor and "
             "sequence axes: tp=2 with and without sequence-parallel "
             "regions, ring, zigzag and Ulysses context parallelism, dp- "
             "and tp-decode, the CLI's --tensorParallel/--contextParallel) "
             "and print its lines (no result line)")
    parser.add_argument(
        "--model-parallel-controls", action="store_true",
        help="with --model-parallel-only: also run the controls that set "
             "phase 3p's tolerances ((a) in f32 at both worlds, (a) with "
             "the region entries' backward all-reduce dropped)")
    parser.add_argument(
        "--model-parallel-rank", metavar="JOBS",
        help="phase 3p's rank process: run JOBS (comma-separated) in the "
             "process group of the BIGDL_* environment")
    parser.add_argument(
        "--expert-pipeline-only", action="store_true",
        help="run only the kernels' build and phase 3q (the expert and "
             "pipeline axes: the 134m-8e MoE LM at full width, expert=2 and "
             "data=2 with global routing, GPipe, circular and StagePipeline "
             "at pipe=2, fsdp x tensor at world 4, the CLIs' --moeExperts) "
             "and print its lines (no result line)")
    parser.add_argument(
        "--expert-pipeline-controls", action="store_true",
        help="with --expert-pipeline-only: also run the controls that set "
             "phase 3q's tolerances ((b) and (c) in f32, (b) routed per "
             "rank, (c) with a summing psum backward)")
    parser.add_argument(
        "--expert-pipeline-rank", metavar="JOBS",
        help="phase 3q's rank process: run JOBS (comma-separated) in the "
             "process group of the BIGDL_* environment")
    parser.add_argument("--dist-out", help="with --distributed-rank, "
                        "--model-parallel-rank or --expert-pipeline-rank: "
                        "the folder for the readings")
    parser.add_argument("--dist-backend", default="nccl",
                        help="with --distributed-rank: the group's backend")
    parser.add_argument(
        "--analysis-only", action="store_true",
        help="run only phase 3r's (a) self-lint and (b) capture rules on "
             "the card (no kernel build; no result line)")
    parser.add_argument(
        "--capture-rules", action="store_true",
        help="phase 3r (b)'s process: lint and run each capture rule's "
             "fixtures on the card and print one capture_rules line")
    parser.add_argument(
        "--surface-only", action="store_true",
        help="run only the kernels' build and phase 3s (the module surface "
             "on a 134m LM and a fused ResNet-50 trained first) and print "
             "its line (no result line)")
    parser.add_argument(
        "--layers-only", action="store_true",
        help="run only the kernels' build and phase 3k (the layer zoo, the "
             "autoencoder app and module timing on the card) and print its "
             "lines (no result line)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if args.gc_trace_of:    # before this tree's package is imported
        script_dir, *rest = args.gc_trace_of
        return gc_trace(os.path.join(os.path.abspath(script_dir),
                                     "chip_smoke.py"), rest)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.time_kernels_of:
        sys.path.insert(0, os.path.abspath(args.time_kernels_of))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the script's own direct forwards (its plain versions and checks)
    # record no output; the port's entry points record none whatever the
    # switch says (``nn.module``), which phase 3s holds with it on
    with quiet_outputs():
        return run_phases(args)


def run_phases(args) -> int:
    """``main``'s phases, as its arguments select them."""
    if args.resume_helper:
        return resume_helper(args.resume_helper, args.steps_per_dispatch)
    if args.distributed_rank:
        return run_distributed_rank(args.distributed_rank, args.dist_out,
                                    args.dist_backend)
    if args.model_parallel_rank:
        return run_model_parallel_rank(args.model_parallel_rank,
                                       args.dist_out, args.dist_backend)
    if args.expert_pipeline_rank:
        return run_expert_pipeline_rank(args.expert_pipeline_rank,
                                        args.dist_out, args.dist_backend)
    if args.capture_rules:
        log({"capture_rules": capture_rules()})
        return 0
    if args.analysis_only:
        t0 = time.perf_counter()
        timed("3r", run_analysis, Beside(self_lint),
              Beside(capture_rules_process), False)
        log({"total_s": time.perf_counter() - t0, "phase_s": PHASE_S})
        return 0
    t0 = time.perf_counter()
    card = environment()
    graph_census()
    if args.time_kernels_of:
        import bigdl_tpu_torch
        none = collections.defaultdict(int)
        rows = [time_flash(none), *time_flash_bwd(none),
                dict(time_int8(0), continuous=time_int8_rows()),
                *time_conv_bn(none), *time_text_kernels(none),
                *time_zoo_kernels(none, {
                    "vgg16": vgg_conv_shapes(ZOO_LADDER["vgg16"][0], 224),
                    "v2_ones": inception_v2_fused_shapes(
                        ZOO_LADDER["inception_v2"][0])[0]})]
        # the counts and the variant describe this tree's main path
        for row in rows:
            for part in (row, *(v for v in row.values()
                                if isinstance(v, dict))):
                for key in ("launches", "launches_mma", "launches_tf32x3",
                            "variant"):
                    part.pop(key, None)
        log({"timed_package": os.path.dirname(bigdl_tpu_torch.__file__),
             "card": card, "total_s": time.perf_counter() - t0,
             "kernels_timed": rows, "k7_timed": time_probe_families()})
        return 0
    if args.zoo_only:
        zoo_launches, zoo_shapes = run_zoo()
        log({"zoo_kernels": time_zoo_kernels(zoo_launches, zoo_shapes),
             "total_s": time.perf_counter() - t0, "card": card})
        return 0
    if args.perf_only:
        perf_launches, _ = run_perf()
        log({"perf_kernels": time_perf_kernels(perf_launches),
             "total_s": time.perf_counter() - t0, "card": card})
        return 0
    if args.layers_only:
        run_layer_zoo()
        log({"total_s": time.perf_counter() - t0, "card": card})
        return 0
    if args.files_only:
        run_files()
        log({"total_s": time.perf_counter() - t0, "card": card})
        return 0
    if args.platform_only:
        platform_launches = run_platform()
        log({"platform_launches": platform_launches,
             "total_s": time.perf_counter() - t0, "card": card})
        return 0
    if args.distributed_only:
        dist_launches = run_distributed(args.distributed_controls)
        log({"distributed_launches": dist_launches,
             "total_s": time.perf_counter() - t0, "card": card})
        return 0
    if args.model_parallel_only:
        mp_launches = run_model_parallel(args.model_parallel_controls)
        log({"model_parallel_launches": mp_launches,
             "total_s": time.perf_counter() - t0, "card": card})
        return 0
    if args.expert_pipeline_only:
        ep_launches = run_expert_pipeline(args.expert_pipeline_controls)
        log({"expert_pipeline_launches": ep_launches,
             "total_s": time.perf_counter() - t0, "card": card})
        return 0
    if args.surface_only:
        run_surface_only(card, t0)
        return 0
    if args.text_only:
        text_launches = run_text()
        log({"text_launches": text_launches,
             "total_s": time.perf_counter() - t0, "card": card})
        return 0
    if args.resnet_grad_seeds:
        failed = []
        for seed in args.resnet_grad_seeds:
            try:
                resnet_grad_check(seed)
            except RuntimeError as e:  # every seed is read; raised below
                log({"seed": seed, "failed": str(e)})
                failed.append(seed)
        log({"total_s": time.perf_counter() - t0, "card": card})
        check(not failed, f"the gradient check failed for seeds {failed}")
        return 0
    timed("2", check_flash)
    timed("2", check_flash_bwd)
    timed("2", check_int8)
    timed("2", check_published_kernels)
    timed("2", check_conv_bn)
    timed("2", check_conv_bn_autograd)
    hbm_errs = timed("2", check_hbm_roof)
    launches, models, lm_timings = timed("3", run_slice)
    cont_launches, cont = timed("3d", run_continuous, models, lm_timings)
    plane_launches = timed("3e", run_serving_plane, models)
    timed("3f serving", check_capture_gc)
    graph_serve_launches, graph_serve_row = timed(
        "3f serving", run_graph_serving, models, cont)
    del models
    torch.cuda.empty_cache()
    # phase 3q's world-2 ranks beside phases 3g and 3b
    ep_out = tempfile.mkdtemp(prefix="bigdl_ep_")
    ep_beside = [Beside(ep_ranks, ep_out, ("w2",))]
    # phase 3r's (b) capture-rules process beside phases 3g and 3b
    rules_beside = Beside(capture_rules_process)
    published_launches = timed("3g", run_published)
    train_launches, k1_run = timed("3b", run_training)
    # phase 3o's rank processes run beside phases 3h-3n (PERF.md §6)
    dist_ranks_beside = Beside(dist_ranks)
    ckpt_launches = timed("3h", run_checkpoints, k1_run)
    graph_train_launches, graph_train_row = timed(
        "3f training", run_graph_training, k1_run)
    del k1_run
    log({"graphs": {**GRAPH_CENSUS, "serving": graph_serve_row,
                    "training": {k: v for k, v in graph_train_row.items()
                                 if k != "losses"}}})
    train_launches = {k: n + graph_train_launches[k] + ckpt_launches[k]
                      for k, n in train_launches.items()}
    # phase 3r's (a) self-lint processes (host CPU only) beside phase 3c,
    # whose ResNet-50 steps keep the card busy
    lint_beside = Beside(self_lint)
    resnet_launches = timed("3c", run_resnet)
    resnet_launches = {k: n + ckpt_launches[k]
                       for k, n in resnet_launches.items()}
    # phase 3p's rank processes and CLI worlds beside phases 3i-3n
    mp_ranks_beside = Beside(mp_ranks)
    zoo_launches, zoo_shapes = timed("3i", run_zoo)
    perf_launches, _ = timed("3j", run_perf)
    timed("3k", run_layer_zoo)
    # its world-4 ranks and CLIs, then its world-1 yardsticks, beside
    # phases 3l-3n (3p's ranks have ended by then)
    ep_beside.append(Beside(ep_ranks, ep_out, ("w4",)))
    text_launches = timed("3l", run_text)
    timed("3m", run_files)
    plat_launches = timed("3n", run_platform)
    dist_launches = timed("3o", run_distributed, False, dist_ranks_beside)
    mp_launches = collections.Counter(timed("3p", run_model_parallel, False,
                                            mp_ranks_beside))
    mp_launches.update(timed("3q", run_expert_pipeline, False,
                             (ep_out, ep_beside)))
    timed("3r", run_analysis, lint_beside, rules_beside)
    resnet_launches = {k: n + plat_launches[k] + dist_launches[k]
                       + SURFACE_LAUNCHES[k]
                       for k, n in resnet_launches.items()}
    roof, roof_launches = timed("4a", run_roofline)
    t_timing = time.perf_counter()
    kernels = [time_flash({k: launches[k] + cont_launches[k]
                           + plane_launches[k] + train_launches[k]
                           + published_launches[k] + text_launches[k]
                           + plat_launches[k] + dist_launches[k]
                           + mp_launches[k] + SURFACE_LAUNCHES[k]
                           for k in ("flash_fwd", "flash_fwd_mma")}),
               *time_flash_bwd({k: n + text_launches[k] + plat_launches[k]
                                + dist_launches[k] + mp_launches[k]
                                + SURFACE_LAUNCHES[k]
                                for k, n in train_launches.items()}),
               dict(time_int8(launches["int8_matmul"]
                              + cont_launches["int8_matmul"]
                              + plane_launches["int8_matmul"]
                              + graph_serve_launches["int8_matmul"]
                              + published_launches["int8_matmul"]
                              + ckpt_launches["int8_matmul"]
                              + plat_launches["int8_matmul"]),
                    continuous=time_int8_rows(),
                    serving_plane=time_int8_rows(PLANE_K4_ROWS[:1]),
                    published=time_int8_published()),
               *time_conv_bn(resnet_launches),
               *time_zoo_kernels(zoo_launches, zoo_shapes),
               *time_perf_kernels(perf_launches),
               *time_text_kernels(text_launches),
               *hbm_roof_rows(roof, roof_launches, hbm_errs)]
    for entry in kernels:
        add_measured_bound(entry, roof["roof_gbps"] * 1e9)
    PHASE_S["kernel timing"] = time.perf_counter() - t_timing
    log({"total_s": time.perf_counter() - t0, "phase_s": PHASE_S})
    print(card, flush=True)
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


def stop_spawned() -> None:
    """Kill every rank process still running (a phase failed while
    another phase's ranks ran beside it)."""
    for p in SPAWNED:
        if p.poll() is None:
            p.kill()
            p.wait()


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        stop_spawned()
