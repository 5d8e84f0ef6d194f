#!/usr/bin/env python3
"""Build the CUDA kernels of ``audiotokenization_tpu_torch`` and drive its
serving and training paths on one GPU.

    python3 chip_smoke.py        # from the repo root, on a machine with a card

Phases, each fatal on failure:
 1. the card's name and power limit (nvidia-smi);
 2. build every kernel (one nvcc per source, started together), while the
    CPU runs its side of phase 8b' (``bf16_cpu_reference``);
 3. K1 (vq_argmin) against its plain version at the flagship shape, the
    semantic codec's (1,600 x 8 against 8192 x 8), the cases of
    tests/test_pallas_vq.py and the edges of its cluster layout;
 4. K2 (fused_residual_unit) at the 15 (C, T, d) shapes of the flagship's
    units and the 15 of configs/bigcodec_semantic.yaml's (C 16-256, T
    16000-250), batch 32: within rtol/atol 1e-4 of its fp32 plain version (cuDNN,
    TF32 off), and against the plain version in float64 no more than 4x as
    far off as the fp32 plain version is; the count of tensor-core (HMMA)
    instructions in its library, which must not be 0;
 4b. both at a few small ragged shapes (4-byte copies, masked edges);
 4c. P1 (probe_unit, the probe of scripts/probe_v5.py) driven at the probe's
    three shapes (C 48/96/192, T 16000/8000/4000, d 3, B 32) with its launch
    count, then held to the same two checks;
 5. the main path on the flagship Config(): tokenize 32 requests x 1 s, then
    codes_to_emb -> decode, checked against the same weights on the CPU;
 6. launch counts of that run: K1 once and K2 15 times per tokenize, K2 15
    times per decode;
 7. times (CUDA events): tokenize/decode audio-s/s, a torch.profiler split of
    one call of each by kernel with the card's idle share, and per kernel its
    time, its plain version's, a library yardstick's and its bound (K2 and
    P1 both for their split-TF32 route and for fp32 on the SIMT pipes); for
    K1 also its device time alone (torch.profiler), and a check that one K1
    call runs exactly one device kernel;
 8. the training path: (a) K2's autograd Function at phase 4's 30 unit
    shapes (B = 2): its gradients for all nine inputs against autograd through the
    plain version in fp32 (TF32 off), rtol 1e-4 / atol 1e-4 x the
    gradient's max magnitude, none all zero; (b) one fp32_strict flagship
    step on 2 x 8000 samples on the card against the same step on the CPU
    from the same weights (AdamW eps 1, no warmup, so an update is close to
    lr·g): metrics within rtol 1e-3, each leaf's update within 1e-2 x its
    max |update| plus twice the parameters' fp32 spacing (AdamW rounds a
    parameter twice an update); (b') the same step in bf16 (Config()'s
    precision) at 2 x 4000 on the card against the CPU's with oneDNN off:
    every metric within rtol 5e-2, the codebook histograms compared and printed
    (train_step_bf16_vs_cpu line); (c) Config() in bf16 at
    32 x 1 s: 2 warm-up steps, 5 timed (CUDA events), finite losses, fp32
    masters, exactly K1 1 and K2 30 launches a step, then the train_step
    and train_profile lines;
 9. the training loop (train_loop_path) on Config() in bf16 at full width:
    a seeded synthetic corpus under build/ (72 training WAVs of 1-3 s, 8 of
    them at 24 kHz so that the loader resamples; 32 validation files; 4
    test files of 1.3-2.7 s); train.loop.train for 8 steps (batch 32 x 1 s,
    logs every 2, validation and checkpoints every 4, one sanity batch,
    STOI/PESQ on 2 items a batch, the test pass at the end), then a resume
    through cli.train.main to step 10. Fatal unless: metrics.jsonl
    continues at step 10; every leaf of the step-8 checkpoint, restored
    into a fresh state, equals the state train returned, bit for bit; K1
    launches once and K2 30 times per train step, per validation batch and
    per test file, and nowhere else in the loop; every logged loss is
    finite; both test passes log test_si_snr and test_codebook_perplexity;
    the 4 test files through make_ragged_codec equal each file's own
    forward (both fp32_strict): tokens except at frames whose top-2 gap is
    under 1e-5, waveforms within rtol 1e-3 / atol 2e-5. Prints the loop's
    audio-s/s (windows without validation or checkpoint) beside the bare
    step's, the stall and bytes per checkpoint save, the validation split
    (device forward, host STOI/PESQ) and the test pass's audio-s/s (the
    train_loop line), then deletes the corpus and the run dir; then the
    bare step once more (bare, loop, bare: the train_loop_vs_bare line);
10. the offline paths on Config() (extract_path): a seeded corpus under
    build/ in the LibriSpeech layout (64 WAVs of 0.7-6.3 s, no length a
    whole number of hops, 8 at 24 kHz) and a port run dir of random weights
    from seed 0 (CheckpointManager). cli.extract_indices at batch 16: 64
    int16 .npy files of ceil(len / 200) frames, K1 once and K2 15 times per
    device batch and nowhere else, and the tokens of 6 files (the shortest,
    the longest, two at 24 kHz) equal to the CPU plain path's per-file
    tokenize except at frames whose top-2 gap is under 1e-5; --exact on 4
    files, the same check, one call a file; cli.inference_full on whole
    files at batch 16: finite SI-SNR, SI-SDR and STOI, frames equal to the
    files', K1 once and K2 30 times per device batch; cli.synthesize of
    4 x 1 s of random tokens: K2 15 launches, the waveform within rtol 1e-3
    / atol 2e-5 of the CPU's decode of its tokens.npy. Prints the extract
    line (audio-s/s and where the time goes), then deletes the corpus and
    the run dir;
11. the tokenize modes on Config() (modes_path), phase 5's weights and
    first batch: for conformant, high, balanced and fast at 32 x 1 s, K1 1
    and K2 15 launches a call (K2 stays the fp32-grade kernel, with a bf16
    cast around it in balanced and fast), codes in range, audio-s/s (CUDA
    events, 5 calls after 2 warm-ups), a torch.profiler split (K2's share,
    the share of the ResLSTM timed alone, idle), token flips and codes used
    against conformant over 4 batches, and the latents' max |d| / max
    |latent| against conformant, fatal over 1e-2 (high) or 5e-2 (balanced,
    fast) (tokenize_mode lines). Inside phase 10, before its corpus goes,
    cli.extract_indices --mode fast on it: K1 1 / K2 15 per device batch,
    its audio-s/s and its flips against the conformant files (extract_fast
    in the extract line);
12. configs/bigcodec_causal.yaml at full width (causal_path), seed 0:
    tokenize and decode of 32 x 1 s, K1 1 / K2 0 and no launch, the first
    2 requests against the CPU as in phase 5; a StreamingTokenizer over
    8 streams x 10 s in 3200-sample steps, K1 1 and K2 0 a step, tokens
    equal to the card's offline tokenize of the whole streams but at top-2
    gaps under 1e-5, step latency p50/p99 (CUDA events, a synchronise a
    step) and the real-time factor; stream_decode of those codes in 16-frame
    chunks within rtol 1e-3 / atol 2e-5 of the offline decode, no launch,
    with the synthesizer's step latency; cli.synthesize --streaming 16 on a
    causal run dir against the decode of its tokens; the tests' tiny causal
    + anti-aliased codec streamed (delay_frames, flush) against the card's
    offline tokenize and decode (the causal line);
13. configs/bigcodec_antialias.yaml (non-causal, full width) as the first
    part of 12 (K1 1 / K2 0); make_ragged_tokenizer on 4 files of 0.7-2.6 s
    in one call against each file's own tokenize, K1 1 / K2 0, audio-s/s;
    tokenize_chunked on Config(): one 30 s file in 10 s windows, K1 1 and
    K2 15 a window, tokens equal to the offline tokenize but at top-2 gaps
    under 1e-5, away from the file's edges (the first ceil(RF / hop) frames
    and the last, where the windows' zero context reaches the ResLSTM's
    start state and conv_out; counted apart) (the antialias_chunked line).
14. configs/conformer.yaml (the Conformer STFT/ISTFT codec) at full width
    and depth, random weights from seed 0 (conformer_path): (a) conformant
    tokenize of 32 x 1 s and codes_to_emb -> decode, K1 1 / K2 0 a tokenize
    and no launch a decode, the first 2 requests against the CPU as in phase
    5 (waveform errors in the first and last 300 samples reported apart),
    audio-s/s and a torch.profiler split (attention, GEMMs, FFTs, K1, idle);
    (b) one long input, 4 x 30 s (2400 frames), against the CPU on its
    first request, timed; the first attention's output at (32, 80) and
    (4, 2400) frames (the latter on six inputs, seeds 2-7) against the
    same attention in float64, fatal unless the conformant one (plain fp32
    ops, no SDPA) is within 4x the CPU fp32 one's error, the high and fast
    modes' errors and SDPA backends printed; (c) the high and fast modes over 4 batches: launches,
    audio-s/s, flips and codes used against conformant, latent error fatal
    over 1e-2 (high) / 5e-2 (fast); balanced must raise; (d)
    make_ragged_tokenizer on 8 files of 0.7-6.3 s against each file's own
    tokenize, make_ragged_codec (fp32_strict) on 4 of them against each
    file's decode of its tokens, K1 1 / K2 0 a call; (e) cli.extract_indices
    at batch 16 on 32 files from a Conformer run dir: ceil(len / 200)
    frames, K1 1 / K2 0 per device batch, 4 files against the CPU; then
    cli.synthesize of 4 x 1 s against the CPU; (f) causal on both sides:
    8 streams x 10 s through StreamingConformerTokenizer in 3200-sample
    steps (K1 1 / K2 0 a step, tokens equal to the offline causal tokens
    but at top-2 gaps under 1e-5, p50/p99 step latency and the real-time
    factor); stream_decode at 16 frames against the offline decode, the
    synthesizer's step latency; cli.synthesize --streaming 16 on
    a causal run dir (the conformer line).
15. configs/conformer_moe.yaml (the Conformer with 8-expert top-2 MoE FFNs in
    its encoder; the decoder dense, as the JAX package builds it) and
    configs/bigcodec_fsq.yaml (the flagship BigCodec with FSQ), full width
    and depth, random weights from seed 0: (a) MoE tokenize of 32 x 1 s and
    codes_to_emb -> decode, K1 1 / K2 0 a tokenize and no launch a decode;
    the whole batch encoded on the CPU too (capacity is batch-global), the
    routing compared layer by layer (tokens whose expert choice or
    kept/dropped status differs; fatal where a choice differs at a router
    gap of 1e-5 or more in a request no earlier difference reached), the
    first 2 requests' tokens and latents where no routing difference reached
    them, their waveforms; audio-s/s, dropped_frac, a torch.profiler split
    (router, dispatch, expert GEMMs, combine, attention, other GEMMs, K1,
    idle); (b) 4 x 30 s against the CPU on its first request, timed, peak
    memory; (c) high and fast over 4 batches (flips, codes used, latent
    error over the requests no routing difference reached, fatal over 1e-2
    / 5e-2), balanced raising; (d) from an MoE run dir, cli.extract_indices
    at batch 16 on 16 files (the per-file route: K1 once a file, ceil(len /
    200) int16 frames, 4 files against the card's own tokenize and the
    CPU's), make_ragged_tokenizer raising, cli.inference_full on 4 whole
    files (one forward a file); (e) one fp32_strict MoE step at 2 x 8000
    against the CPU's (phase 8b's tolerances, moe_* metrics included), then
    bf16 steps of conformer_moe.yaml and conformer.yaml at 32 x 1 s (2
    warm-ups, 5 timed, K1 1 / K2 0 a step, finite, routers moved, audio-s/s,
    peak memory) (the conformer_moe line); (f) the FSQ BigCodec: tokenize and
    decode of 32 x 1 s (K1 0, K2 15 each), the first 2 requests against the
    CPU (tokens but where a bounded value lies within 1e-5 of a rounding
    boundary, counted), high and fast, make_ragged_tokenizer on 8 files
    against each file's tokenize, cli.extract_indices on 16 files ((T,)
    int16 < 512, K2 15 a device batch), one bf16 step timed (K1 0 / K2 30)
    (the bigcodec_fsq line), and the phase's seconds (phase_15_s).
16. the quantizer zoo, full width and depth, random weights from seed 0:
    (a) the flagship with ``quantizer: ema_vq`` (8192 codes of 1024 dims;
    its codebook set to frames of its own latents on seeded noise, as a
    kmeans init would seed it): tokenize and decode of 32 x 1 s, K1 0 and
    K2 15 each, the first 2 requests against the CPU (tokens but where the
    top-2 distance gap is under 1e-5 x (|x|² + |e_best|²), counted; latents
    and waveforms as in phase 5), audio-s/s, a torch.profiler split
    (quantizer: the distance GEMM and argmin; K2; ResLSTM; other kernels;
    idle); high and fast over 4 batches; the cosine codebook's tokenize and
    decode against the CPU the same way; (b) one fp32_strict EMA step at
    2 x 8000 against the CPU's (phase 8b's tolerances; the EMA buffers within
    rtol 1e-4 / atol 1e-5, the same codes expired); (c) bf16 steps at
    32 x 1 s (2 warm-ups, 5 timed, K1 0 / K2 30 a step, finite, the EMA
    codebook moved and finite, audio-s/s, peak memory); (d) the flagship
    with a 13-bit LFQ bottleneck: tokenize and decode as in (a) (tokens but
    where a bit's latent lies within atol 2e-4 of 0), one fp32_strict step
    against the CPU, bf16 steps timed; (e) make_ragged_tokenizer on 8 files
    against each file's tokenize, cli.extract_indices on 16 files from an
    EMA run dir whose buffers restore bit for bit; (f) SimVQ, BEST-RQ's
    random projection, NSVQ (eval), latent quantize, residual FSQ and QINCo
    (2560 positions, 256 codes of 8 dims, 2 stages, chunks of 640) once on
    the card against the CPU (indices but at relative top-2 gaps under
    1e-5; outputs within the latents' tolerance). Prints the
    bigcodec_ema_vq, bigcodec_lfq and quantizer_zoo lines and phase_16_s.
17. configs/bigcodec_semantic.yaml (semantic distillation, concat_semantic)
    at full width and depth, the codec from seed 0 and the w2v-bert teacher
    (24 layers, 1024 wide, 16 heads, intermediate 4096) random from its own
    seed, tapped at layer 16 (semantic_path): (a) 32 requests x 1 s: the
    features on the card (w2v_bert_features_torch), the teacher (50
    frames), tokenize with its output, codes_to_emb -> apply_fc_post_a ->
    decode; K1 1 / K2 15 a tokenize, K2 15 a decode; the first 2 requests
    against the CPU (the features within 3e-3, the teacher on the same
    features within the latents' tolerance, the quantizer's input and the
    tokens on the card's teacher output: tokens but at top-2 gaps under
    1e-5, the waveforms); audio-s/s with and without the teacher and for
    decode; a torch.profiler split (teacher, bottleneck and fc_prior, K1,
    K2, the rest, idle); (b) the teacher at 1 x 30 s (1,500 frames) and a
    20 s row padded to it under valid_frames, against the teacher in
    float64 on the card: fatal over 4x the CPU fp32's error; the padded
    row's frames against that row alone; (c) on 16 files: a snapshot of the
    teacher (config.json, pytorch_model.bin), cli.precompute_semantic
    (float16 (1024, Tf), 2 files against the CPU's teacher),
    cli.extract_indices --semantic_dir at batch 16 ((T,) int16, ceil(len /
    320) frames, K1 1 / K2 15 a device batch, 4 files against the CPU),
    cli.inference_full --w2v_bert_init random on 4 whole files (K1 1 / K2
    30 a device batch); (d) one fp32_strict step at 2 x 8000 with the
    teacher against the CPU's (phase 8b's tolerances, semantic_recon_loss
    among the metrics, both teachers unchanged bit for bit), then bf16
    steps at 32 x 1 s with the teacher (2 warm-ups, 5 timed, K1 1 / K2 30
    a step, finite, audio-s/s, peak memory) and a torch.profiler split of
    one more step (teacher, bottleneck and fc_prior forward, K1, K2, the
    rest, idle). Prints the bigcodec_semantic line and phase_17_s.
18. the stage-2 token LM at the reference's full width (vocabulary 8194,
    hidden 256, intermediate 1024, 4 layers of 4 heads, 1,024 positions,
    8.39 M parameters), random from seed 0, on phase 5's flagship codec,
    and the causal training step (token_lm_path, causal_train_path): (a)
    token_lm_apply at 2 x 1,024 positions against the CPU (rtol / atol 1e-4
    x max |logit|) and against a float64 forward on the card (no more than
    4x the CPU fp32 forward's error), token_lm_loss at 16 x 81 positions
    within 1e-5 relative of the CPU's; (b) greedy and temperature-1
    sampling (the same Gumbel draws on both sides) of 160 tokens at B 2:
    the KV sampler against the full re-forward and the CPU's KV sampler,
    token for token up to the first step whose top-2 gap is under 1e-5
    (reported); both samplers timed at B 2 and 32 (ms a token, tokens/s),
    one KV run profiled (busy, idle share, kernels a token); (c) one LM step
    at 16 x 1 s against the CPU's, with phase 8b's AdamW eps 1 and no
    warmup: the frozen tokens but at top-2 gaps under 1e-5, the loss
    within 1e-5 relative, each leaf's update within 1e-2 x its max |update|
    (phase 8b's rule); then 2 warm-ups and 5 timed steps with the CLI's
    optimizer (ms, audio-s/s, peak memory, the tokenize / LM split by CUDA
    events), K1 1 / K2 15 a step; (d) on 16 WAVs under
    build/: cli.train_token_lm for 3 steps at batch 16 from a port run dir
    of phase 5's codec (K1 1 / K2 15 a step, a finite loss each step, the
    checkpoint), then cli.synthesize --lm_ckpt of 2 x 2 s (2 WAVs,
    tokens.npy (2, 160) int16 in [0, 8192), K1 0 / K2 15), their wall
    times (the token_lm line); (e) one fp32_strict step of
    configs/bigcodec_causal.yaml and of its causal + anti-aliased variant
    at 2 x 8000 against the CPU's (phase 8b's tolerances), then bf16 steps
    of bigcodec_causal.yaml at 32 x 1 s (2 warm-ups, 5 timed, K1 1 / K2 0
    a step, finite, audio-s/s, peak memory) (the causal_train line), and
    the phase's seconds (phase_18_s).
19. speaker verification at full width on random weights from seed 0
    (speaker_verification_path): (a) ECAPA-TDNN at init_ecapa_tdnn's
    defaults (channels 512, emb 192, scale 8, attention 128) on fbank (80)
    and MFCC (40), 4 x 3 s: embeddings within rtol / atol 1e-4 x max |emb|
    of the CPU's, and against a float64 forward on the card (its frontend
    in float64 too) no more than 4x as far off as the CPU fp32's; ms per
    utterance; (b) WavLM-Large (microsoft/wavlm-large's config: 1024 wide,
    24 layers, 16 heads, layer-norm extractor, stable pre-LN, 320 buckets)
    and a HuBERT base layout (768 / 12 / 12, group norm, post-LN) as
    transformers state dicts of numpy draws, written and loaded through
    load_ssl_upstream (the inferred config checked): every hidden state
    within rtol 2e-3 / atol 3e-4 x max |h| of the CPU's at 1 x 4 s, and at
    1 x 10 s against float64 on the card by the 4x rule; ms per 10 s
    utterance and a torch.profiler split (conv encoder, pos conv,
    attention, FFN, GEMMs, idle), the conv encoder also timed alone by CUDA
    events; ECAPA over the WavLM-Large frontend (1024
    mels, 25 layer weights) against the CPU; (c) phase 5's flagship codec
    tokenizes and decodes 4 x 3 s (K1 1 / K2 15, K2 15), (a)'s fbank ECAPA
    scores each original against its reconstruction (no launch), within
    1e-4 of the CPU's on the same waveforms; (d) cli.verification --smoke
    on WAVs under build/ (fbank at 16 and 22.05 kHz, MFCC at 22.05 kHz,
    --feat_type ssl --ssl_family wavlm_large on (b)'s file), each within
    1e-4 of the same run with --device cpu, no launch, wall times. Prints
    the speaker_verification line and phase_19_s.
20. the parallel serving paths (parallel_path), their devices the one card
    listed several times ([cuda:0] * n: one codec copy, each shard queued
    on it in turn, no speedup to show): (a) on phase 5's flagship weights,
    one seeded 60 s file through parallel/sp.py's exact tokenizer over 4
    shards and over 1, each against one-device tokenize (tokens but at
    top-2 gaps under 1e-5), K1 1 / K2 15 a shard; lstm="reset" and
    mode="fast" over 4, their agreement with the conformant tokens printed
    and held above 0.9 (the CPU tests' rule); ms a call beside one-device
    tokenize and tokenize_chunked at 10 s; K1 at a shard's 1,200 frames
    against its plain version, K2 at the 15 encoder and 15 decoder window
    shapes (B = 1, C 48-768) against its plain version and float64 as in
    phase 4; (b) make_sp_synthesizer of those 4,800 frames over 4 shards
    (K2 60) against one-device decode (rtol 1e-3 / atol 2e-5); (c)
    configs/bigcodec_antialias.yaml: SP tokenize and synthesize of 10 s
    against one-device (K1 4, K2 0); (d) configs/conformer.yaml at 4 x
    10 s: tp_tokenize over 2 and 4 model shards, pp_tokenize and
    pp_synthesize over 2 and 3 stages with 4 microbatches, against
    one-device tokenize and decode (K1 1 / K2 0 a tokenize, none a
    synthesize), ms beside one-device; configs/conformer_moe.yaml under TP
    2, its routing compared layer by layer with one device's
    (routing_differences) and its tokens where no difference reached the
    request; (e) on 4 WAVs under build/ from port run dirs of random
    weights, cli.extract_indices --sequence_parallel (flagship) and
    --tensor_parallel 2 (Conformer) against the plain CLI's .npy (tokens
    but at top-2 gaps under 1e-5), cli.synthesize --sequence_parallel and
    --pipeline_parallel 2 against the plain CLI's waveforms, with
    parallel/mesh.py's card enumeration listing the card 4 times. Prints
    the parallel line and phase_20_s.
21. data parallelism and FSDP (dp_path) on Config() at full width, random
    weights from seed 0, one global batch of 32 x 1 s: (a) one rank under
    NCCL: the bf16 DP step against the step without a group (cuDNN
    deterministic): its reduction leaves every gradient and metric bit for
    bit (the identity at world size 1), its metrics and update hold the
    bare step's by phase 8b's rule (AdamW eps 1, no warmup); then bare and DP
    steps in turns (bare, DP, DP, bare; 3 timed each) with the reduction's
    share of the DP step (CUDA events around the gradient buckets and the
    metrics); the fp32_strict one-process step (phase 8b's setting, no
    recomputation) and FSDP over the one NCCL rank against it by phase
    8b's rule; (b)-(d) in one torchrun launch of two rank processes on the
    one card, under gloo on CUDA tensors (NCCL refuses two ranks on one
    device): (b) each rank on its 16 rows, over a group of its own:
    the DP step's metrics and update against the one-process step by phase
    8b's rule, K1 1 and K2 30 launches per rank; (c) FSDP over those ranks
    (leaves of 2^14 elements or more cut in two): against the one-process
    step and against (b)'s update, each rank's memory at rest and peak
    beside (b)'s; (d) then, in the same rank processes, cli.train
    (--dist_backend gloo, its own group from torchrun's environment), 2
    bf16 steps at 2 x 1 s a rank on 8 WAVs under build/ with a sanity
    batch, validation and a checkpoint (K1 1 / K2 30
    per step and per validation batch on each rank, one validation line, no
    non-finite value), then a resume on one process to step 3. (c) fails
    unless FSDP's peak a rank is below DP's (it gathers one block at a
    time). Prints the data_parallel line and phase_21_s.
22. tensor-, expert- and pipeline-parallel training (model_parallel_path)
    on configs/conformer.yaml at full width (dim 256, 6 + 6 layers, 8
    heads, VQ 8192 x 8, hop 200), random weights from seed 0, one global
    batch of 12 x 1 s, fp32_strict, AdamW eps 1 and no warmup: (a) the
    one-device step, and the same step with each Conformer layer
    recomputed in the backward (train.remat on) held against it by phase
    8b's rule, its peak memory and ms a step beside (a)'s (the remat
    line; the same for the one-device step at 8 x 10 s, where the
    attention's scores are a large share of the activations, and for
    (d)'s MoE step); (b) TP 2 and TP 4 (the card listed 2 and 4 times),
    (c) PP 2 and PP 3 with 6 microbatches, each held against (a) by phase
    8b's rule; (d) configs/conformer_moe.yaml's one-device step and its
    step under TP 2 (the experts split) held against it; each case's K1
    launches (1 a step: one generator forward; K2 0, the Conformer has no
    ResidualUnit), memory at rest and peak, ms a step over 3 timed steps
    beside (a)'s; (e) cli.train under torchrun, two gloo ranks on the card
    with TP 2 and FSDP (--override train.tensor_parallel=2 train.fsdp=true):
    2 bf16 steps at 2 x 1 s a rank on 8 WAVs under build/ with a sanity
    batch, validation and a checkpoint (K1 1 / K2 0 per forward on each
    rank), then a resume in one process on one device to step 3; (f)
    parallel/dryrun.py's dry run over two gloo ranks on the card (every
    leg: the plain, FSDP, EMA, bf16 semantic, accumulated, TP, EP and PP
    steps, validation, SP, anti-aliased SP, TP and PP tokenize, the ragged
    Conformer against per-file; each raises on a broken promise). Prints
    the model_parallel line and phase_22_s.
23. the soak scripts' resume check (soak_path), in a process of its own
    (this script with --soak) under CUBLAS_WORKSPACE_CONFIG=:4096:8, so
    that neither that setting nor deterministic algorithms touch another
    phase: (a) audiotokenization_tpu_torch/scripts/soak_matrix.py's
    resume_determinism on configs/bigcodec.yaml (the flagship at full
    width, bf16) over a 16-file build_corpus under build/: a base run of
    8 steps through cli.train (16 x 1 s, a sanity batch, the test pass),
    two copies of its run dir each resumed to step 12 under
    torch.use_deterministic_algorithms(True) (validation and a checkpoint
    at 12) and extracted through cli.extract_indices at batch 8; fatal
    unless the branches' metric rows (wall-clock keys dropped) and token
    files are byte-identical, every training step launches K1 once and K2
    30 times and every extraction batch K1 once and K2 15 times; the run
    dirs are deleted; (b) K1 at 2560 x 8192 x 8 and K2 at phase 4's 30
    unit shapes (B 32), each launched twice on the same inputs: the
    outputs must be bitwise equal (no float atomics, a fixed order of
    reduction). Prints the soak line (with phase_23_s).
24. the installed port (installed_port_path): pip install --no-deps
    --no-build-isolation --no-index --no-compile --target of a copy of the
    tree's packaging files; then, from a working directory outside the
    repo with a fresh ATT_TORCH_CACHE, the installed package builds K1 and
    K2 there from its own sources (both nvcc at once); these two steps run
    in a process of their own started beside the repo's build at the top
    (they need the CPU, not the card). Then examples/quickstart_torch.py's
    steps run through the installed
    audiotok-torch-* scripts on the card (preprocess, train 5 fp32 steps
    of the JAX quickstart's tiny BigCodec, extract, evaluate). Fatal
    unless the build read the installed sources, the fresh cache holds
    vq_argmin-*.so and residual_unit-*.so (the same hash as the repo's),
    the repo's extraction of the same run dir (K1 1 / K2 6
    a batch: one 0.2 s file, the tiny encoder's 6 units) gives the
    installed one's token files byte for byte, the evaluation wrote its
    summary, and K2 holds to phase 4's two checks at the tiny codec's unit
    widths (C 4 and 8). Prints the installed_port line (with phase_24_s,
    and phase_24_whole_s: the install and the build counted in turn).
The kernels line gives K1's and K2's launches on each of these paths
(path_launches). The last line is {"ok": true, "device": {...}}. Without
a card, or without the package beside it, the script exits non-zero and
prints no result.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# Published H100 SXM peaks at 700 W (NVIDIA data sheet): fp32 outside the
# tensor cores, dense TF32 in them, and HBM3 bandwidth. K2 and P1 run each
# fp32 product as three TF32 products (split-TF32).
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
SPLIT_TF32_PASSES = 3
PEAK_HBM_BYTES = 3.35e12

B, SR = 32, 16000          # 32 requests x 1 s at 16 kHz, as bench.py
GAP = 1e-5                 # near-tie threshold for token comparisons
K2_RTOL = K2_ATOL = 1e-4   # fp32 sums over up to 7*768 terms in another order
F64_RATIO = 4.0            # kernel's error vs float64 <= 4x the fp32 plain version's
PROBE_SHAPES = [(48, 16000, 3), (96, 8000, 3), (192, 4000, 3)]  # scripts/probe_v5.py
LAT_RTOL, LAT_ATOL = 1e-3, 2e-4   # the repo's latent tolerance
WAV_RTOL, WAV_ATOL = 1e-3, 2e-5   # the repo's waveform tolerance
GRAD_RTOL = 1e-4           # K2's gradients against autograd of its plain version
REF_B, REF_T = 2, 8000     # the fp32_strict step held against the CPU: 2 x 0.5 s
BF16_REF_T = 4000          # the bf16 one's 2 x 0.25 s (the CPU's bf16 step, oneDNN off, is slow)
STEP_RTOL = 1e-3           # that step's metrics, card against CPU
BF16_RTOL = 5e-2           # the bf16 step's metrics, card against CPU (the CPU test's)
UPDATE_TOL = 1e-2          # its updates, x each leaf's max |update|
TRAIN_STEPS, TRAIN_WARMUP = 5, 2
LOOP_STEPS, LOOP_RESUME_STEPS = 8, 10  # the loop's first run, then its resume
LOOP_TEST_SECONDS = (1.3, 1.8, 2.2, 2.7)
HOP = 200                  # Config()'s samples per frame
EDGE = 300                 # samples at each end of a waveform reported apart (ISTFT's trim)
EXTRACT_FILES, EXTRACT_BATCH, EXACT_FILES = 64, 16, 4  # the extraction phase's corpus


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def plain_dist(enc, codebook):
    """The plain version's distance matrix (M, N)."""
    import torch
    from audiotokenization_tpu_torch.ops.cuda.vq_kernel import l2_normalize

    e, c = l2_normalize(enc.float()), l2_normalize(codebook.float())
    return (torch.sum(e * e, dim=1, keepdim=True) - 2.0 * (e @ c.T)
            + torch.sum(c * c, dim=1)[None, :])


def top2_gap(dist):
    v = dist.topk(2, dim=1, largest=False).values
    return v[:, 1] - v[:, 0]


def check_k1():
    """K1 against its plain version: the flagship shape, the cases of
    tests/test_pallas_vq.py, and the edges of the cluster layout (one row,
    fewer codes than a cluster, a ragged last share and tile, D = 32 and
    the padded widths 16 and 24, 32 tiles a share, a book at a 4-byte offset
    for the 4-byte copies, rows equal to codes, duplicates in different
    shares), and the semantic codec's 32 x 50 positions after fc_prior."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.ops.cuda.vq_kernel import (k1_geometry, k1_shares,
                                                               vq_argmin, vq_argmin_plain)

    def rand(seed, m, n, d):
        rng = np.random.RandomState(seed)
        return rng.randn(m, d).astype(np.float32), rng.randn(n, d).astype(np.float32)

    rng = np.random.RandomState(2)
    half = rng.randn(64, 8).astype(np.float32)
    dup = (rng.randn(50, 8).astype(np.float32), np.concatenate([half, half]))
    rng = np.random.RandomState(4)
    book = rng.randn(8192, 8).astype(np.float32)
    picked = rng.choice(len(book), 512, replace=False)
    # code i and code i + 4096 are equal and lie in shares i // 1024 and i // 1024 + 4
    across = (rng.randn(700, 8).astype(np.float32), np.concatenate([book[:4096], book[:4096]]))
    shares = k1_shares(k1_geometry(700, 8192, 8), 8192)
    share_of = [k for k, (lo, hi) in enumerate(shares) for _ in range(lo, hi)]
    if share_of[0] == share_of[4096]:
        fail("K1: the duplicates-across-shares case does not cross shares")
    cases = {"flagship 2560x8 vs 8192x8": rand(10, 2560, 8192, 8),
             "700x8 vs 8192x8": rand(0, 700, 8192, 8),
             "37x8 vs 128x8": rand(1, 37, 128, 8),
             "duplicated codes 50x8 vs 2x64x8": dup,
             "ragged 1000x5 vs 1000x5": rand(3, 1000, 1000, 5),
             "one row 1x8 vs 8192x8": rand(5, 1, 8192, 8),
             "fewer codes than a cluster 300x8 vs 5x8": rand(6, 300, 5, 8),
             "ragged shares 2560x8 vs 8193x8": rand(7, 2560, 8193, 8),
             "D=32 700x32 vs 8192x32": rand(8, 700, 8192, 32),
             "D=12 (padded to 16) 300x12 vs 1000x12": rand(12, 300, 1000, 12),
             "D=20 (padded to 24) 300x20 vs 1000x20": rand(13, 300, 1000, 20),
             "65536 codes 2560x8 vs 65536x8": rand(9, 2560, 65536, 8),
             "book at a 4-byte offset 700x8 vs 8192x8": rand(11, 700, 8192, 8),
             "rows equal to codes 512x8 vs 8192x8": (book[picked], book),
             "duplicates across shares 700x8 vs 2x4096x8": across,
             "semantic 1600x8 vs 8192x8": rand(14, 1600, 8192, 8)}
    worst = 0.0
    for name, (e, c) in cases.items():
        enc = torch.from_numpy(e).cuda()
        if "offset" in name:  # a contiguous view 4 bytes past a 16-byte boundary
            cb = torch.empty(c.size + 1, device="cuda")[1:].view(c.shape).copy_(torch.from_numpy(c))
            if cb.data_ptr() % 16 == 0:
                fail("K1: the offset book is 16-byte aligned")
        else:
            cb = torch.from_numpy(c).cuda()
        got = vq_argmin(enc, cb).long()
        want = vq_argmin_plain(enc, cb).long()
        torch.cuda.synchronize()
        dist = plain_dist(enc, cb)
        gap = top2_gap(dist)
        near = gap < GAP
        bad = (got != want) & ~near
        rows = torch.arange(len(enc), device=enc.device)
        err = (dist[rows, got] - dist[rows, want]).abs().max().item()
        worst = max(worst, err)
        print(f"K1 {name}: {int((got != want).sum())} of {len(enc)} rows differ, "
              f"{int(near.sum())} rows under the {GAP:g} top-2 gap, "
              f"max |dist(kernel) - dist(plain)| = {err:.3g}, min dist {dist.min().item():.3g}")
        if bad.any():
            fail(f"K1 {name}: {int(bad.sum())} rows differ with a top-2 gap >= {GAP:g}")
        if name.startswith("duplicated") and not bool((got < 64).all()):
            fail("K1 duplicated codes: a tie did not resolve to the lowest index")
        if name.startswith("duplicates across") and not bool((got < 4096).all()):
            fail("K1 duplicates across shares: a tie did not resolve to the lowest index")
        if name.startswith("rows equal") and bool(
                ((got != torch.from_numpy(picked).cuda()) & ~near).any()):
            fail("K1 rows equal to codes: a row did not find its own code")
    return worst


def unit_inputs(C, T, d, seed=0, batch=B):
    """A ResidualUnit's tensors as the main path feeds K2, on the card:
    torch-default conv init and non-trivial snake parameters."""
    import torch
    from audiotokenization_tpu_torch.ops.conv import kaiming_uniform_fan_in, uniform_fan_in_bias

    g = torch.Generator().manual_seed(seed + 1000 * d + C)
    x = torch.randn((batch, C, T), generator=g)
    w7 = kaiming_uniform_fan_in((C, C, 7), generator=g)
    w1 = kaiming_uniform_fan_in((C, C, 1), generator=g)
    b7 = uniform_fan_in_bias((C,), 7 * C, generator=g)
    b1 = uniform_fan_in_bias((C,), C, generator=g)
    snakes = [0.1 * torch.randn((C,), generator=g) for _ in range(4)]
    return [t.cuda() for t in (x, w7, b7, w1, b1, *snakes)]


def unit_shapes(cfg):
    """(C, T, d) of the encoder's ResidualUnits for 1 s; the decoder runs the
    same 15 shapes in the mirror order."""
    e = cfg.model.codec_encoder
    shapes, c, t = [], e.ngf, SR
    for stride in e.up_ratios:
        shapes += [(c, t, d) for d in e.dilations]
        c, t = 2 * c, t // stride
    return shapes


def hold(name, got, plain, plain64):
    """Fail unless ``got`` is finite, within rtol/atol 1e-4 of the fp32 plain
    version, and no more than F64_RATIO times as far from the float64 plain
    version as the fp32 plain version is. Returns max |got - plain|."""
    import torch

    torch.cuda.synchronize()
    diff = (got - plain).abs()
    err = diff.max().item()
    err64 = (got.double() - plain64).abs().max().item()
    plain_err64 = (plain.double() - plain64).abs().max().item()
    print(f"{name}: max |kernel - plain32| = {err:.3g}, max |kernel - plain64| = "
          f"{err64:.3g}, max |plain32 - plain64| = {plain_err64:.3g}")
    if not torch.isfinite(got).all() or not bool((diff <= K2_ATOL + K2_RTOL * plain.abs()).all()):
        fail(f"{name} outside rtol {K2_RTOL:g} / atol {K2_ATOL:g} of its plain version")
    if err64 > F64_RATIO * plain_err64:
        fail(f"{name}: error against float64 {err64:.3g} is more than {F64_RATIO:g}x the "
             f"fp32 plain version's {plain_err64:.3g}")
    return err


def check_k2(shapes, *, batch=B, what="K2"):
    from audiotokenization_tpu_torch.ops.cuda.residual_unit_kernel import (
        fused_residual_unit, residual_unit_plain)

    worst = 0.0
    for C, T, d in shapes:
        args = unit_inputs(C, T, d, batch=batch)
        got = fused_residual_unit(*args, dilation=d)
        want = residual_unit_plain(*args, dilation=d)
        want64 = residual_unit_plain(*(a.double() for a in args), dilation=d)
        worst = max(worst, hold(f"{what} C={C} T={T} d={d}", got, want, want64))
        del want64
    return worst


def check_ragged():
    """K2 and P1 at small shapes whose C or T are not multiples of 4, 8 or
    the tiles: the 4-byte copies and the masked edges, which the codec's
    widths never reach. Held to the same two checks; B = 2."""
    from audiotokenization_tpu_torch.ops.cuda.probe_unit_kernel import (probe_unit,
                                                                       probe_unit_plain)
    from audiotokenization_tpu_torch.ops.cuda.residual_unit_kernel import (
        fused_residual_unit, residual_unit_plain)

    for C, T, d in [(20, 333, 3), (100, 250, 9), (192, 402, 1), (96, 404, 3)]:
        args = unit_inputs(C, T, d)
        args[0] = args[0][:2].contiguous()
        hold(f"K2 ragged C={C} T={T} d={d}", fused_residual_unit(*args, dilation=d),
             residual_unit_plain(*args, dilation=d),
             residual_unit_plain(*(a.double() for a in args), dilation=d))
    for C, T, d in [(20, 333, 3), (18, 101, 2)]:
        args = probe_inputs(C, T, d)
        args[0] = args[0][:2].contiguous()
        hold(f"P1 ragged C={C} T={T} d={d}", probe_unit(*args, dilation=d),
             probe_unit_plain(*args, dilation=d),
             probe_unit_plain(*(a.double() for a in args), dilation=d))


def hmma_count(name: str) -> int:
    """Tensor-core (HMMA) instructions in the SASS of a built library."""
    from audiotokenization_tpu_torch.ops.cuda import build

    tool = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    return sum("HMMA" in line for line in sass.splitlines())


def probe_inputs(C, T, d, seed=0):
    """The probe's inputs as scripts/probe_v5.py makes them, on the card:
    x (B, T, C) * 0.1, W7 and W1 * 0.05 in its layouts w7t (7C, C), w1t (C, C)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed + C)
    x = rng.randn(B, T, C).astype(np.float32) * 0.1
    w7 = rng.randn(C, C, 7).astype(np.float32) * 0.05
    w1 = rng.randn(C, C, 1).astype(np.float32) * 0.05
    w7t = np.ascontiguousarray(np.transpose(w7, (2, 1, 0)).reshape(7 * C, C))
    w1t = np.ascontiguousarray(w1[:, :, 0].T)
    return [torch.from_numpy(a).cuda() for a in (x, w7t, w1t)]


def probe_path():
    """P1's own path: one probe_unit call per probe shape, counted, then each
    output held against the plain version in fp32 and float64."""
    import torch
    from audiotokenization_tpu_torch.ops.cuda.probe_unit_kernel import (probe_unit,
                                                                       probe_unit_plain)

    probe_unit.launches = 0
    outs = [probe_unit(*probe_inputs(C, T, d), dilation=d) for C, T, d in PROBE_SHAPES]
    torch.cuda.synchronize()
    launches = probe_unit.launches
    print(f"probe path launches: P1 {launches}")
    if launches != len(PROBE_SHAPES):
        fail(f"expected {len(PROBE_SHAPES)} P1 launches on the probe path, got {launches}")
    worst = 0.0
    for (C, T, d), got in zip(PROBE_SHAPES, outs):
        args = probe_inputs(C, T, d)
        want = probe_unit_plain(*args, dilation=d)
        want64 = probe_unit_plain(*(a.double() for a in args), dilation=d)
        worst = max(worst, hold(f"P1 C={C} T={T} d={d}", got, want, want64))
    return launches, worst


def seeded_codec(cfg, seed: int = 0):
    """A codec of ``cfg`` with random weights from ``seed``, on the card, its
    weight norm folded as for inference."""
    import torch
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.ops.conv import fold_weight_norm

    return fold_weight_norm(C.init_codec(cfg, generator=torch.Generator().manual_seed(seed),
                                         device="cuda"))


def offline_decode(codec, codes):
    """codes (Nq, B, Tf) -> waveforms (B, 1, Tf · hop): codes_to_emb ->
    apply_fc_post_a -> decode, fp32 with TF32 off."""
    import torch
    from audiotokenization_tpu_torch.models import codec as C

    with C.full_fp32(), torch.no_grad():
        emb = C.apply_fc_post_a(codec, C.codes_to_emb(codec, codes.permute(1, 2, 0)))
        return C.decode(codec, emb)


def hold_against_cpu(name, codec, wav_np, codes, out, n_ref: int = 2):
    """The card's tokens ``codes`` (Nq, B, Tf) and waveforms ``out`` of
    ``wav_np`` against the same weights on the CPU, where the wrappers take
    the plain versions, for the first ``n_ref`` requests: tokens except at
    frames whose margin (``frame_gaps``) is under GAP, latents within
    LAT_RTOL / LAT_ATOL, waveforms within WAV_RTOL / WAV_ATOL."""
    import torch
    from audiotokenization_tpu_torch.models import codec as C

    cpu = copy.deepcopy(codec).cpu()
    with C.full_fp32(), torch.no_grad():
        lat_gpu = C.encode(codec, torch.from_numpy(wav_np[:n_ref]).cuda()).cpu()
        lat_cpu = C.encode(cpu, torch.from_numpy(wav_np[:n_ref]))
        _, codes_cpu, _ = C.quantize(cpu, lat_cpu)
    gap = frame_gaps(cpu, lat_cpu).reshape(-1)
    wav_cpu = offline_decode(cpu, codes[:, :n_ref].cpu())
    tok_gpu = codes[:, :n_ref].cpu()
    flips = (tok_gpu != codes_cpu).reshape(-1)
    near = gap < GAP
    lat_err = (lat_gpu - lat_cpu).abs().max().item()
    wav_d = (out[:n_ref].cpu() - wav_cpu).abs()
    wav_err = wav_d.max().item()
    edge_err = max(wav_d[..., :EDGE].max().item(), wav_d[..., -EDGE:].max().item())
    print(f"{name} vs CPU ({n_ref} requests): {int(flips.sum())} of {flips.numel()} "
          f"tokens differ, {int(near.sum())} frames under the {GAP:g} margin; "
          f"max |dlatent| = {lat_err:.3g}, max |dwav| = {wav_err:.3g}")
    if (flips & ~near).any():
        fail(f"{name}: tokens differ from the CPU at frames with a margin >= 1e-5")
    if not torch.allclose(lat_gpu, lat_cpu, rtol=LAT_RTOL, atol=LAT_ATOL):
        fail(f"{name}: latents outside rtol 1e-3 / atol 2e-4 of the CPU")
    if not torch.allclose(out[:n_ref].cpu(), wav_cpu, rtol=WAV_RTOL, atol=WAV_ATOL):
        fail(f"{name}: waveforms outside rtol 1e-3 / atol 2e-5 of the CPU")
    return {"max_abs_err_latent": lat_err, "max_abs_err_wav": wav_err,
            "max_abs_err_wav_edges": edge_err,
            "token_flips": int(flips.sum()), "near_ties": int(near.sum())}


def main_path(cfg):
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.ops.cuda.residual_unit_kernel import fused_residual_unit
    from audiotokenization_tpu_torch.ops.cuda.vq_kernel import vq_argmin

    codec = seeded_codec(cfg)
    wav_np = (np.random.RandomState(0).randn(B, SR) * 0.1).astype(np.float32)
    wav = torch.from_numpy(wav_np).cuda()
    nq = cfg.model.codec_decoder.vq_num_quantizers
    n_units = len(cfg.model.codec_encoder.up_ratios) * len(cfg.model.codec_encoder.dilations)

    vq_argmin.launches = fused_residual_unit.launches = 0
    codes = C.tokenize(codec, wav, mode="conformant")
    torch.cuda.synchronize()
    tok_launches = (vq_argmin.launches, fused_residual_unit.launches)
    vq_argmin.launches = fused_residual_unit.launches = 0
    out = offline_decode(codec, codes)
    torch.cuda.synchronize()
    dec_launches = (vq_argmin.launches, fused_residual_unit.launches)
    print(f"main path launches: tokenize K1 {tok_launches[0]} K2 {tok_launches[1]}; "
          f"decode K1 {dec_launches[0]} K2 {dec_launches[1]}")
    if tok_launches != (nq, n_units) or dec_launches != (0, n_units):
        fail(f"expected K1 {nq} and K2 {n_units} launches per tokenize and K2 "
             f"{n_units} per decode")
    tf = SR // int(np.prod(cfg.model.codec_encoder.up_ratios))
    if tuple(codes.shape) != (nq, B, tf) or tuple(out.shape) != (B, 1, SR):
        fail(f"shapes: codes {tuple(codes.shape)}, wav {tuple(out.shape)}")
    if not torch.isfinite(out).all():
        fail("decoded waveform has non-finite values")

    cmp = hold_against_cpu("main path", codec, wav_np, codes, out)

    tok_ms = cuda_ms(lambda: C.tokenize(codec, wav), iters=5)
    dec_ms = cuda_ms(lambda: offline_decode(codec, codes), iters=5)
    print(json.dumps({"tokenize_profile": device_profile(lambda: C.tokenize(codec, wav))}))
    print(json.dumps({"decode_profile": device_profile(lambda: offline_decode(codec, codes))}))
    return {"tokenize_ms": tok_ms, "tokenize_audio_s_per_s": B / (tok_ms / 1e3),
            "decode_ms": dec_ms, "decode_audio_s_per_s": B / (dec_ms / 1e3),
            "launches": {"vq_argmin": tok_launches[0] + dec_launches[0],
                         "residual_unit": tok_launches[1] + dec_launches[1]},
            **cmp}


def device_events(fn):
    """Every device event (kernel or copy) of one call of ``fn``, as
    torch.profiler saw it: (name, start us, end us); and the call's wall time
    (host clock, ending in a synchronize, profiler overhead included)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == DeviceType.CUDA]  # as the card ran them
    return events, wall_ms


def complete_events(fn, kernels: int, tries: int = 3):
    """``device_events(fn)``, captured again, at most ``tries`` times, while
    the profiler reports fewer than ``kernels`` device events: torch.profiler
    has dropped kernel records on that card (21 of 50 K1 calls in one run).
    A capture of ``kernels`` or more events is returned as it is, so the
    callers' exact counts still fail on an extra kernel."""
    for attempt in range(1, tries + 1):
        events, wall_ms = device_events(fn)
        if len(events) >= kernels:
            break
        print(f"the profiler reported {len(events)} of at least {kernels} device kernels "
              f"(capture {attempt} of {tries})")
    return events, wall_ms


def device_profile(fn, top: int = 8):
    """Device time of one call by kernel, and the share of the call's wall
    time in which the card ran nothing."""
    events, wall_ms = device_events(fn)
    by_name, spans = {}, []
    for name, start, stop in events:
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (stop - start) / 1e3, n + 1)
        spans.append((start, stop))
    busy_us, end = 0.0, float("-inf")  # the union of the spans: streams may overlap
    for start, stop in sorted(spans):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    kernels = sorted(((name[:90], ms, n) for name, (ms, n) in by_name.items()),
                     key=lambda k: -k[1])
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "kernel_ms_sum": sum(k[1] for k in kernels),
            "idle_share": 1 - busy_us / 1e3 / wall_ms if spans else None,
            "top_kernels": [{"name": n, "ms": ms, "count": c} for n, ms, c in kernels[:top]]}


def bound_ms(ops: float, nbytes: float, flops_per_s: float = PEAK_FP32_FLOPS):
    t_ops, t_bytes = ops / flops_per_s, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def unit_bounds(ops: float, nbytes: float) -> dict:
    """A unit's bound on the split-TF32 route (three TF32 products per fp32
    product) and, for comparison, in fp32 on the SIMT pipes."""
    bnd, by = bound_ms(ops, nbytes, PEAK_TF32_FLOPS / SPLIT_TF32_PASSES)
    return {"bound_ms": bnd, "bound_by": by, "bound_simt_ms": bound_ms(ops, nbytes)[0]}


def time_k1(cfg):
    """K1 at the main path's shape: ``ms`` per wrapper call (CUDA events over
    50 back-to-back calls, so the host's pace), ``host_ms`` the host's time per
    call (host clock, no synchronize inside), ``device_ms`` the
    kernel's own time per call (torch.profiler's device events over 50
    calls), and every device kernel one call runs, which must be one."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.ops.cuda.vq_kernel import (l2_normalize, vq_argmin,
                                                               vq_argmin_plain)

    d = cfg.model.codec_decoder
    m, n, dim = B * SR // int(np.prod(cfg.model.codec_encoder.up_ratios)), d.codebook_size, d.codebook_dim
    rng = np.random.RandomState(10)
    enc = torch.from_numpy(rng.randn(m, dim).astype(np.float32)).cuda()
    cb = torch.from_numpy(rng.randn(n, dim).astype(np.float32)).cuda()
    enc_n, cb_n = l2_normalize(enc), l2_normalize(cb)
    ms = cuda_ms(lambda: vq_argmin(enc, cb), iters=50)
    calls = 50
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        vq_argmin(enc, cb)
    host_ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    many, _ = complete_events(lambda: [vq_argmin(enc, cb) for _ in range(calls)], calls)
    if len(many) != calls:
        fail(f"the profiler saw {len(many)} device kernels in {calls} K1 calls")
    device_ms = sum(stop - start for _, start, stop in many) / 1e3 / calls
    one, _ = complete_events(lambda: vq_argmin(enc, cb), 1)
    print(json.dumps({"k1_call_device_kernels": [name for name, _, _ in one]}))
    if len(one) != 1:
        fail(f"a K1 call at {m}x{n}x{dim} ran {len(one)} device kernels, not 1")
    plain = cuda_ms(lambda: vq_argmin_plain(enc, cb), iters=50)
    # yardstick: the cross-term matmul and the reduction, as two library calls
    library = cuda_ms(lambda: torch.argmax(torch.mm(enc_n, cb_n.T), dim=1), iters=50)
    ops = m * n * (2 * dim + 3)  # dot, two adds, one compare per (row, code)
    bnd, by = bound_ms(ops, 4 * (m * dim + n * dim + m))
    return {"ms": ms, "host_ms": host_ms, "device_ms": device_ms,
            "device_kernels_per_call": len(one),
            "plain_ms": plain, "library_ms": library, "bound_ms": bnd, "bound_by": by}


def time_k2(shapes):
    import torch
    import torch.nn.functional as F
    from audiotokenization_tpu_torch.ops.cuda.residual_unit_kernel import (
        fused_residual_unit, residual_unit_plain)

    rows = []
    for C, T, d in shapes:
        args = unit_inputs(C, T, d)
        x, w7, b7, w1, b1 = args[:5]
        ms = cuda_ms(lambda: fused_residual_unit(*args, dilation=d), iters=10)
        plain = cuda_ms(lambda: residual_unit_plain(*args, dilation=d), iters=10)
        library = cuda_ms(lambda: (F.conv1d(x, w7, b7, padding=3 * d, dilation=d),
                                   F.conv1d(x, w1, b1)), iters=10)
        rows.append({"C": C, "T": T, "d": d, "ms": ms, "plain_ms": plain,
                     "library_ms": library,
                     **unit_bounds(16 * C * C * T * B, 4 * (2 * B * C * T + 8 * C * C + 6 * C))})
        print(json.dumps({"k2_shape": rows[-1]}))
    return rows


def time_p1():
    import torch
    import torch.nn.functional as F
    from audiotokenization_tpu_torch.ops.cuda.probe_unit_kernel import (probe_unit,
                                                                       probe_unit_plain)

    rows = []
    for C, T, d in PROBE_SHAPES:
        x, w7t, w1t = probe_inputs(C, T, d)
        # yardstick: the probe's XLA comparison, two convolutions on the same data
        xc = x.transpose(1, 2).contiguous()
        w7 = w7t.reshape(7, C, C).permute(2, 1, 0).contiguous()
        w1 = w1t.t().contiguous()[:, :, None]
        ms = cuda_ms(lambda: probe_unit(x, w7t, w1t, dilation=d), iters=10)
        plain = cuda_ms(lambda: probe_unit_plain(x, w7t, w1t, dilation=d), iters=10)
        library = cuda_ms(lambda: (F.conv1d(xc, w7, padding=3 * d, dilation=d),
                                   F.conv1d(xc, w1)), iters=10)
        rows.append({"C": C, "T": T, "d": d, "ms": ms, "plain_ms": plain,
                     "library_ms": library,
                     **unit_bounds(16 * C * C * T * B, 4 * (2 * B * C * T + 8 * C * C))})
        print(json.dumps({"p1_shape": rows[-1]}))
    return rows


def check_k2_grads(shapes):
    """(a) K2's Function on the card: the gradients of all nine inputs against
    autograd through residual_unit_plain (fp32, TF32 off) at each unit shape,
    B = 2. Returns the worst error relative to the gradient's max magnitude."""
    import torch
    from audiotokenization_tpu_torch.ops.cuda.residual_unit_kernel import (
        fused_residual_unit, residual_unit_plain)

    names = ("x", "w7", "b7", "w1", "b1", "alpha1", "beta1", "alpha2", "beta2")
    worst, worst_at = 0.0, ""
    for C, T, d in shapes:
        args = unit_inputs(C, T, d)
        args = [(a[:2] if i == 0 else a).detach().clone().requires_grad_(True)
                for i, a in enumerate(args)]
        g_out = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(C + d)).cuda()
        got = torch.autograd.grad(fused_residual_unit(*args, dilation=d), args, g_out)
        want = torch.autograd.grad(residual_unit_plain(*args, dilation=d), args, g_out)
        for name, g, w in zip(names, got, want):
            scale = w.abs().max().item()
            err = (g - w).abs().max().item()
            if not bool(g.abs().max() > 0):
                fail(f"K2 gradient of {name} at C={C} T={T} d={d} is all zero")
            if not (torch.isfinite(g).all() and bool(
                    ((g - w).abs() <= GRAD_RTOL * w.abs() + GRAD_RTOL * scale).all())):
                fail(f"K2 gradient of {name} at C={C} T={T} d={d} outside rtol {GRAD_RTOL:g} / "
                     f"atol {GRAD_RTOL:g} x max |grad| ({err:.3g} against {scale:.3g})")
            if err / scale > worst:
                worst, worst_at = err / scale, f"{name} at C={C} T={T} d={d}"
    print(f"K2 gradients ({len(shapes)} shapes, 9 inputs each): worst |grad - plain| / max |plain| = "
          f"{worst:.3g} ({worst_at})")
    return worst


def _leaves(state):
    return {**{"gen." + k: v.detach().cpu().clone() for k, v in state.gen.state_dict().items()},
            **{"disc." + k: v.detach().cpu().clone() for k, v in state.disc.state_dict().items()}}


def hold_updates(what, before, after_cpu, after_card, *, every_leaf_moves=False):
    """Each leaf's update on the card (after - before) within UPDATE_TOL x
    the CPU's max |update| of that leaf, plus twice the parameters' fp32
    spacing: AdamW rounds each parameter twice an update (the decay, then
    the step), so each side's update is good to 1 spacing. An update may
    round to 0 unless ``every_leaf_moves``. Returns (worst error over max
    |update|, its leaf)."""
    import numpy as np
    import torch

    worst, worst_at = 0.0, ""
    for name, b in before.items():
        want, got = after_cpu[name] - b, after_card[name] - b
        scale = want.abs().max().item()
        spacing = torch.from_numpy(np.asarray(2 * np.spacing(np.maximum(
            b.abs().numpy(), after_cpu[name].abs().numpy()))))  # 0-d leaves too
        err = (got - want).abs()
        if (every_leaf_moves and scale == 0) or bool((err > UPDATE_TOL * scale + spacing).any()):
            fail(f"{what}: update of {name} off by {err.max().item():.3g} against "
                 f"max |update| {scale:.3g}")
        if scale > 0 and err.max().item() / scale > worst:
            worst, worst_at = err.max().item() / scale, name
    return worst, worst_at


def train_step_vs_cpu(cfg, line: str = "train_step_vs_cpu", teacher=None):
    """(b) One fp32_strict step at full width on the card against the same
    step on the CPU, from the same weights and batch; prints the ``line``
    line. The EMA quantizer's buffers (their draws made on the CPU from the
    step, the same for both) are held within EMA_RTOL / EMA_ATOL, and its
    expired codes (cluster size at the threshold) must be the same ones.
    ``teacher`` (on the CPU): a semantic codec's, run in both steps on the
    batch's features (the loader's numpy ones), which must come out of
    them bit for bit unchanged."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.train.state import init_train_state, train_state
    from audiotokenization_tpu_torch.train.step import make_train_step

    cfg = copy.deepcopy(cfg)
    t = cfg.train
    t.precision = "fp32_strict"
    for o in (t.gen_optim_params, t.disc_optim_params):
        o.eps = 1.0  # an update close to lr·g, not lr·sign(g)
    for sp in (t.gen_schedule_params, t.disc_schedule_params):
        sp.warmup_step = 0
    ref = init_train_state(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    card = train_state(cfg, copy.deepcopy(ref.gen).cuda(), copy.deepcopy(ref.disc).cuda())
    wav = (np.random.RandomState(1).randn(REF_B, REF_T) * 0.1).astype(np.float32)
    batch = {"wav": torch.from_numpy(wav)}
    teachers = {}
    if teacher is not None:
        from audiotokenization_tpu_torch.ops.fbank import w2v_bert_features_from_clip

        batch["feats"] = torch.from_numpy(np.stack([w2v_bert_features_from_clip(w) for w in wav]))
        teachers = {"cpu": teacher, "card": copy.deepcopy(teacher).cuda()}
        teacher_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    before = _leaves(ref)
    t0 = time.perf_counter()
    m_card = make_train_step(cfg)(card, {k: v.cuda() for k, v in batch.items()},
                                  teachers.get("card"))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    m_cpu = make_train_step(cfg, device="cpu")(ref, batch, teachers.get("cpu"))
    t2 = time.perf_counter()
    for side, t in teachers.items():
        for k, v in t.state_dict().items():
            if not torch.equal(v.cpu(), teacher_before[k]):
                fail(f"fp32_strict step: the {side}'s teacher changed at {k}")
    worst_metric = 0.0
    for key, want in m_cpu.items():
        got = m_card[key]
        if key == "codebook_hist":
            flips = int((got.cpu() != want).sum())
            if float(got.sum()) != float(want.sum()):
                fail("fp32_strict step: the codebook histograms count different totals")
            continue
        got, want = float(got), float(want)
        worst_metric = max(worst_metric, abs(got - want) / max(abs(want), 1e-30))
        if not (np.isfinite(got) and abs(got - want) <= STEP_RTOL * abs(want)):
            fail(f"fp32_strict step: {key} {got!r} on the card against {want!r} on the CPU")
    after_card, after_cpu = _leaves(card), _leaves(ref)
    worst_update, worst_at = hold_updates("fp32_strict step", before, after_cpu, after_card)
    out = {"card_s": t1 - t0, "cpu_s": t2 - t1, "worst_metric_rel": worst_metric,
           "worst_update_rel": worst_update, "worst_update_leaf": worst_at,
           "hist_bins_differing": flips, "leaves": len(before)}
    buffers = dict(ref.gen.quantizer.named_buffers())
    if buffers:
        errs = {}
        for name, want in buffers.items():
            got = after_card["gen.quantizer." + name]
            errs[name] = (got - want).abs().max().item()
            if not torch.allclose(got, want, rtol=EMA_RTOL, atol=EMA_ATOL):
                fail(f"fp32_strict step: EMA buffer {name} off by {errs[name]:.3g} "
                     f"(rtol {EMA_RTOL:g} / atol {EMA_ATOL:g})")
        dead = {k: after["gen.quantizer.cluster_size"] == EMA_THRESHOLD
                for k, after in (("card", after_card), ("cpu", after_cpu))}
        if not torch.equal(dead["card"], dead["cpu"]):
            fail("fp32_strict step: the card and the CPU expired other EMA codes")
        out["ema_buffers"] = {"max_abs_err": errs, "expired": int(dead["cpu"].sum()),
                              "codes": int(dead["cpu"].numel())}
    print(json.dumps({line: out}))
    return out


def bf16_cpu_reference(cfg):
    """The CPU side of (b'): the bf16 step at 2 x 4000 samples (BF16_REF_T)
    on the CPU with oneDNN off, from seed 0. It needs no kernel, so ``main``
    runs it while nvcc builds them. Returns (the initial generator and
    discriminators, the step's metrics, its seconds)."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.train.state import init_train_state
    from audiotokenization_tpu_torch.train.step import make_train_step

    if cfg.train.precision != "bf16":
        fail(f"the bf16 comparison runs Config()'s bf16, got {cfg.train.precision}")
    ref = init_train_state(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    start = (copy.deepcopy(ref.gen), copy.deepcopy(ref.disc))
    wav = (np.random.RandomState(1).randn(REF_B, BF16_REF_T) * 0.1).astype(np.float32)
    t0 = time.perf_counter()
    with torch.backends.mkldnn.flags(enabled=False):
        m_cpu = make_train_step(cfg, device="cpu")(ref, {"wav": torch.from_numpy(wav)})
    return start, m_cpu, time.perf_counter() - t0


def train_step_bf16_vs_cpu(cfg, cpu_ref):
    """(b') One bf16 step at 2 x 4000 samples (BF16_REF_T: half (b)'s, the
    CPU's bf16 step being slow) on the card against the same step on the
    CPU (``cpu_ref``, from ``bf16_cpu_reference``; oneDNN off: this CPU
    build's bf16 conv2d is wrong where the kernel is wider than the padded
    input), from the same weights and batch: every metric within rtol 5e-2,
    the CPU test's bf16 tolerance; the two codebook histograms compared
    (codes used, total count)."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.train.state import train_state
    from audiotokenization_tpu_torch.train.step import make_train_step

    (gen, disc), m_cpu, cpu_s = cpu_ref
    m_cpu = dict(m_cpu)
    card = train_state(cfg, copy.deepcopy(gen).cuda(), copy.deepcopy(disc).cuda())
    wav = (np.random.RandomState(1).randn(REF_B, BF16_REF_T) * 0.1).astype(np.float32)
    t0 = time.perf_counter()
    m_card = make_train_step(cfg)(card, {"wav": torch.from_numpy(wav).cuda()})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hists = {"card": m_card.pop("codebook_hist").cpu(), "cpu": m_cpu.pop("codebook_hist")}
    hist = {k: {"codes_used": int((h > 0).sum()), "count": float(h.sum()),
                "top": [[int(i), float(h[i])] for i in torch.argsort(h, descending=True)[:4]
                        if h[i] > 0]} for k, h in hists.items()}
    rel = {}
    for key, want in m_cpu.items():
        got, want = float(m_card[key]), float(want)
        rel[key] = abs(got - want) / max(abs(want), 1e-30)
        if not (np.isfinite(got) and abs(got - want) <= BF16_RTOL * abs(want)):
            fail(f"bf16 step: {key} {got!r} on the card against {want!r} on the CPU "
                 f"(rtol {BF16_RTOL:g})")
    if hist["card"]["count"] != hist["cpu"]["count"]:
        fail("bf16 step: the codebook histograms count different totals")
    out = {"card_s": t1 - t0, "cpu_s_beside_nvcc": cpu_s, "batch": [REF_B, BF16_REF_T],
           "metrics_card": {k: float(v) for k, v in m_card.items()},
           "metrics_cpu": {k: float(v) for k, v in m_cpu.items()},
           "rel_diff": rel, "worst_metric_rel": max(rel.values()), "codebook_hist": hist,
           "hist_bins_differing": int((hists["card"] != hists["cpu"]).sum())}
    print(json.dumps({"train_step_bf16_vs_cpu": out}))
    return out


def timed_steps(step, state, wav, teacher=None, extra=None, n=TRAIN_STEPS):
    """ms per step over ``n`` steps (CUDA events), and the last metrics;
    ``extra``: more keys of the batch, ``teacher``: the step's."""
    import torch

    batch = {"wav": wav, **(extra or {})}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        metrics = step(state, batch, teacher)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, metrics


def bare_step_again(cfg) -> float:
    """The bare bf16 step's audio-s/s once more, after the loop, as
    train_path times it: bare, loop, bare in one run, since a host-bound
    step's rate moves with its host."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.train.state import init_train_state
    from audiotokenization_tpu_torch.train.step import make_train_step

    state = init_train_state(cfg, generator=torch.Generator().manual_seed(0))
    step = make_train_step(cfg)
    wav = torch.from_numpy((np.random.RandomState(2).randn(B, SR) * 0.1).astype(np.float32)).cuda()
    for _ in range(TRAIN_WARMUP):
        step(state, {"wav": wav})
    torch.cuda.synchronize()
    ms, _ = timed_steps(step, state, wav)
    return B * SR / cfg.dataset.sample_rate / (ms / 1e3)


def train_path(cfg, card):
    """(c) Config() in bf16 at 32 x 1 s: 2 warm-up steps, then 5 steps timed
    with CUDA events and counted; one more step under torch.profiler."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.ops.cuda.residual_unit_kernel import fused_residual_unit
    from audiotokenization_tpu_torch.ops.cuda.vq_kernel import vq_argmin
    from audiotokenization_tpu_torch.train.state import init_train_state
    from audiotokenization_tpu_torch.train.step import make_train_step

    if cfg.train.precision != "bf16":
        fail(f"the timed training step runs Config()'s bf16, got {cfg.train.precision}")
    state = init_train_state(cfg, generator=torch.Generator().manual_seed(0))
    step = make_train_step(cfg)
    wav = torch.from_numpy((np.random.RandomState(2).randn(B, SR) * 0.1).astype(np.float32)).cuda()
    for _ in range(TRAIN_WARMUP):
        step(state, {"wav": wav})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    vq_argmin.launches = fused_residual_unit.launches = 0
    ms, metrics = timed_steps(step, state, wav)
    launches = {"vq_argmin": vq_argmin.launches / TRAIN_STEPS,
                "residual_unit": fused_residual_unit.launches / TRAIN_STEPS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_units = 2 * len(cfg.model.codec_encoder.up_ratios) * len(cfg.model.codec_encoder.dilations)
    nq = cfg.model.codec_decoder.vq_num_quantizers
    print(f"train path launches per step: K1 {launches['vq_argmin']:g} "
          f"K2 {launches['residual_unit']:g}")
    if launches != {"vq_argmin": nq, "residual_unit": n_units}:
        fail(f"expected K1 {nq} and K2 {n_units} launches per training step")
    last = {k: float(v) for k, v in metrics.items() if k != "codebook_hist"}
    bad = [k for k, v in last.items() if not np.isfinite(v)]
    if bad:
        fail(f"non-finite training metrics: {bad}")
    dtypes = {p.dtype for m in (state.gen, state.disc) for p in m.parameters()}
    if dtypes != {torch.float32}:
        fail(f"master parameters are {dtypes}, not fp32")
    last["codes_used"] = int((metrics["codebook_hist"] > 0).sum())
    out = {"ms_per_step": ms, "audio_s_per_s": B * SR / cfg.dataset.sample_rate / (ms / 1e3),
           "peak_memory_gb": peak_gb, "launches_per_step": launches, "batch": [B, SR],
           "precision": cfg.train.precision, "steps_timed": TRAIN_STEPS, "metrics": last}
    print(json.dumps({"train_step": out, "card": card}))
    print(json.dumps({"train_profile": device_profile(lambda: step(state, {"wav": wav}), top=12)}))
    return out


def write_corpus(root: Path, sr: int = SR):
    """A seeded synthetic corpus: noise and a pitch under a syllable-rate
    envelope with pauses, as PCM16 WAVs. 72 training files of 1-3 s (8 of
    them at 24 kHz), 32 validation files of 1-1.5 s and the test files of
    LOOP_TEST_SECONDS; returns the three filelists."""
    import numpy as np
    from audiotokenization_tpu_torch.data.audio_io import write_wav

    rng = np.random.RandomState(5)

    def clip(path, seconds, rate):
        t = np.arange(int(seconds * rate)) / rate
        env = np.clip(np.sin(2 * np.pi * rng.uniform(2, 5) * t + rng.uniform(0, 6)), 0, None) ** 2
        pitch = np.sin(2 * np.pi * rng.uniform(100, 250) * t)
        w = env * (0.5 * pitch + 0.5 * rng.randn(len(t))) * 0.3 + 0.003 * rng.randn(len(t))
        write_wav(path, w.astype(np.float32), rate)
        return str(path)

    train = [clip(root / f"train{i}.wav", rng.uniform(1.0, 3.0), 24000 if i % 9 == 4 else sr)
             for i in range(72)]
    val = [clip(root / f"val{i}.wav", rng.uniform(1.0, 1.5), sr) for i in range(32)]
    test = [clip(root / f"test{i}.wav", s, sr) for i, s in enumerate(LOOP_TEST_SECONDS)]
    lists = {}
    for name, files in (("train", train), ("val", val), ("test", test)):
        lists[name] = root / f"{name}.txt"
        lists[name].write_text("\n".join(files))
    return lists


class LaunchLedger:
    """K1 and K2 launches per call of the functions that factories make:
    wraps each ``(module, name)`` factory (and restores it), reading the
    host-side counters only, so nothing syncs the card. ``calls[kind]``
    lists (K1, K2) per call; ``timed``'s calls are timed into ``timed_s``."""

    def __init__(self, factories: dict, timed=None):
        self.calls = {kind: [] for kind in factories}
        self.timed_s = []
        self._patched = list(factories.values()) + ([timed] if timed else [])
        self._orig = [getattr(m, n) for m, n in self._patched]
        for kind, (module, name) in factories.items():
            setattr(module, name, self._factory(getattr(module, name), self.calls[kind]))
        if timed:
            setattr(timed[0], timed[1], self._timed(getattr(*timed)))

    @staticmethod
    def _counts():
        from audiotokenization_tpu_torch.ops.cuda.residual_unit_kernel import fused_residual_unit
        from audiotokenization_tpu_torch.ops.cuda.vq_kernel import vq_argmin

        return vq_argmin.launches, fused_residual_unit.launches

    def _factory(self, make, record):
        def wrapped_make(*args, **kwargs):
            fn = make(*args, **kwargs)

            def counted(*a, **kw):
                before = self._counts()
                out = fn(*a, **kw)
                after = self._counts()
                record.append((after[0] - before[0], after[1] - before[1]))
                return out

            return counted

        return wrapped_make

    def _timed(self, fn):
        import torch

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.timed_s.append(time.perf_counter() - t0)
            return out

        return timed

    def close(self):
        for (module, name), orig in zip(self._patched, self._orig):
            setattr(module, name, orig)


def _state_leaves(state):
    """name -> tensor (or other leaf) of a train state's state dict."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}.{i}")
        else:
            out[path] = node

    walk(state.state_dict(), "state")
    return out


def ragged_vs_per_file(cfg, codec, test_list):
    """The test files through make_ragged_codec as one batch against each
    file's own forward, both fp32_strict (full fp32, TF32 off)."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.data.dataset import load_clip, read_filelist
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.ops.conv import linear
    from audiotokenization_tpu_torch.utils.ragged import make_ragged_codec

    strict = copy.deepcopy(cfg)
    strict.train.precision = "fp32_strict"
    hop = int(np.prod(cfg.model.codec_encoder.up_ratios))
    wavs = [load_clip(f, sample_rate=SR, min_audio_length=-1, pad_to_multiple_of=hop, train=False)
            for f in read_filelist(test_list)]
    lengths = [len(w) for w in wavs]
    batch = torch.zeros((len(wavs), max(lengths)))
    for i, w in enumerate(wavs):
        batch[i, :len(w)] = torch.from_numpy(w)
    own_cfg, codec.cfg = codec.cfg, strict
    try:
        recon, codes = make_ragged_codec(strict)(codec, batch.cuda(), torch.tensor(lengths))
        flips = near = 0
        wav_err = 0.0
        layer = codec.quantizer.layers[0]
        for i, w in enumerate(wavs):
            x = torch.from_numpy(w)[None].cuda()
            with torch.no_grad():
                out = C.forward(codec, {"wav": x})
                with C.full_fp32():
                    z_e = linear(C.encode(codec, x).transpose(1, 2), layer.in_proj)
                    gap = top2_gap(plain_dist(z_e.reshape(-1, z_e.shape[-1]), layer.codebook))
            n = len(w) // hop
            differ = (codes[0, i, :n] != out.vq_code[0, 0]).cpu()
            flips += int(differ.sum())
            near += int((gap.cpu() < GAP).sum())
            if (differ & (gap.cpu() >= GAP)).any():
                fail(f"ragged codec: tokens of test file {i} differ from its own forward "
                     "at frames with a top-2 gap >= 1e-5")
            got, want = recon[i, :len(w)], out.gen_wav[0, 0]
            wav_err = max(wav_err, (got - want).abs().max().item())
            if not torch.allclose(got, want, rtol=WAV_RTOL, atol=WAV_ATOL):
                fail(f"ragged codec: waveform of test file {i} outside rtol 1e-3 / atol 2e-5 "
                     "of its own forward")
    finally:
        codec.cfg = own_cfg
    out = {"files": len(wavs), "lengths": lengths, "token_flips": flips,
           "near_ties": near, "max_abs_err_wav": wav_err}
    print(f"ragged codec vs per-file forward (fp32_strict, {len(wavs)} files): {flips} tokens "
          f"differ, {near} frames under the {GAP:g} top-2 gap, max |dwav| = {wav_err:.3g}")
    return out


def train_loop_path(cfg, card, bare):
    """9. The training loop at full width (module docstring); ``bare`` is
    train_path's result, the bare step's rate in the same run."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from audiotokenization_tpu_torch.cli import train as cli
    from audiotokenization_tpu_torch.config import save_config
    from audiotokenization_tpu_torch.ops.cuda.residual_unit_kernel import fused_residual_unit
    from audiotokenization_tpu_torch.ops.cuda.vq_kernel import vq_argmin
    from audiotokenization_tpu_torch.train import loop
    from audiotokenization_tpu_torch.train.checkpoint import restore_train_state
    from audiotokenization_tpu_torch.train.state import init_train_state
    from audiotokenization_tpu_torch.utils import ragged as ragged_module
    from audiotokenization_tpu_torch.utils.logging import MetricsLogger

    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_loop_", dir=build_dir))
    ledger = None
    try:
        lists = write_corpus(root)
        cfg = copy.deepcopy(cfg)
        d, t = cfg.dataset, cfg.train
        d.train.filelist, d.val.filelist, d.test.filelist = (str(lists[k]) for k in ("train", "val", "test"))
        d.train.batch_size = d.val.batch_size = B
        d.train.min_audio_length = d.val.min_audio_length = SR
        d.val.quality_metric_items = 2
        t.max_steps = LOOP_STEPS
        t.log_every_n_steps, t.val_every_n_steps, t.checkpoint_every_n_steps = 2, 4, 4
        t.num_sanity_val_steps = 1
        if t.precision != "bf16":
            fail(f"the loop runs Config()'s bf16, got {t.precision}")
        run_dir = root / "run"
        cfg_file = root / "config.json"
        save_config(cfg, cfg_file)

        ledger = LaunchLedger({"train_step": (loop, "make_train_step"),
                               "val_batch": (loop, "make_eval_step"),
                               "test_file": (ragged_module, "make_ragged_codec")},
                              timed=(loop, "run_test"))
        vq_argmin.launches = fused_residual_unit.launches = 0
        train_loader, val_loader, test_loader = cli.make_loaders(cfg, pin_memory=True)
        logger = MetricsLogger(run_dir, run_name=cfg.name, use_wandb=False)
        t0 = time.perf_counter()
        state = loop.train(cfg, train_loader=train_loader, val_loader=val_loader,
                           test_loader=test_loader, run_dir=str(run_dir), logger=logger)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        logger.close()
        if state.step != LOOP_STEPS:
            fail(f"the loop stopped at step {state.step}, not {LOOP_STEPS}")

        fresh = init_train_state(cfg, generator=torch.Generator().manual_seed(1))
        restore_train_state(run_dir, fresh, step=LOOP_STEPS)
        want, got = _state_leaves(state), _state_leaves(fresh)
        if want.keys() != got.keys():
            fail("the restored state's leaves differ from the saved state's")
        differ = [k for k in want if not (torch.equal(want[k], got[k]) if torch.is_tensor(want[k])
                                          else want[k] == got[k])]
        if differ:
            fail(f"{len(differ)} leaves of the step-{LOOP_STEPS} checkpoint differ from the "
                 f"state train returned, e.g. {differ[:3]}")
        n_tensors = sum(torch.is_tensor(v) for v in want.values())
        print(f"train loop: the step-{LOOP_STEPS} checkpoint restores all {len(want)} leaves "
              f"({n_tensors} tensors) bit for bit")
        del fresh, state, want, got
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        state = cli.main(["--config", str(cfg_file), "--run_dir", str(run_dir),
                          "--max_steps", str(LOOP_RESUME_STEPS), "--no_wandb"])
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        launches = (vq_argmin.launches, fused_residual_unit.launches)
        ledger.close()
        if state.step != LOOP_RESUME_STEPS:
            fail(f"the resumed loop stopped at step {state.step}, not {LOOP_RESUME_STEPS}")

        logs = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
        step_logs = [r for r in logs if "gen_loss" in r]
        want_steps = list(range(t.log_every_n_steps, LOOP_RESUME_STEPS + 1, t.log_every_n_steps))
        if [r["step"] for r in step_logs] != want_steps:
            fail(f"metrics.jsonl logs steps {[r['step'] for r in step_logs]}, not {want_steps}")
        losses = {k: v for r in step_logs for k, v in r.items() if k.endswith("_loss")}
        bad = [(r["step"], k) for r in step_logs for k, v in r.items()
               if k.endswith("_loss") and not np.isfinite(v)]
        if bad or not losses:
            fail(f"non-finite logged losses: {bad}")
        tests = [r for r in logs if "test_si_snr" in r]
        if len(tests) != 2 or not all("test_codebook_perplexity" in r for r in tests):
            fail("the test passes did not log test_si_snr and test_codebook_perplexity")

        nq = cfg.model.codec_decoder.vq_num_quantizers
        n_units = 2 * len(cfg.model.codec_encoder.up_ratios) * len(cfg.model.codec_encoder.dilations)
        n_val = sum(1 for r in logs if "sanity_val_ok" in r) + sum(1 for r in logs if "val_si_snr" in r)
        expect = {"train_step": LOOP_RESUME_STEPS, "val_batch": n_val,
                  "test_file": 2 * len(LOOP_TEST_SECONDS)}
        per_call = {}
        for kind, calls in ledger.calls.items():
            if len(calls) != expect[kind] or set(calls) != {(nq, n_units)}:
                fail(f"loop launches per {kind}: {calls}, expected {expect[kind]} calls of "
                     f"K1 {nq} / K2 {n_units}")
            per_call[kind] = {"vq_argmin": nq, "residual_unit": n_units, "calls": len(calls)}
        total = tuple(sum(c[i] for calls in ledger.calls.values() for c in calls) for i in (0, 1))
        if launches != total:
            fail(f"the loop launched K1/K2 {launches} times, its steps, validation batches "
                 f"and test files {total}")
        print(f"train loop launches: K1 {launches[0]}, K2 {launches[1]} over "
              f"{expect['train_step']} steps, {n_val} validation batches and "
              f"{expect['test_file']} test files (K1 {nq} / K2 {n_units} each)")

        # the rate of log windows that hold no validation, checkpoint or the first steps
        audio_per_step = B * SR / cfg.dataset.sample_rate
        clean = [r for r in step_logs if r["step"] > t.log_every_n_steps
                 and (r["step"] - t.log_every_n_steps) % t.val_every_n_steps != 0
                 and (r["step"] - t.log_every_n_steps) % t.checkpoint_every_n_steps != 0]
        windows = {r["step"]: r["steps_per_sec"] * audio_per_step for r in clean}
        loop_rate = float(np.mean(list(windows.values())))
        saves = [{"step": r["step"], "stall_ms": r["ckpt_stall_ms"], "bytes": r["ckpt_bytes"]}
                 for r in logs if "ckpt_stall_ms" in r]
        vals = [{"step": r["step"], "forward_s": r["val_forward_s"],
                 "quality_s": r["val_quality_s"], "stoi": r.get("val_stoi"),
                 "pesq": r.get("val_pesq"), "si_snr": r["val_si_snr"]}
                for r in logs if "val_forward_s" in r]
        test_audio = sum(LOOP_TEST_SECONDS)
        ragged = ragged_vs_per_file(cfg, state.gen, lists["test"])
        out = {"audio_s_per_s_by_window": windows, "audio_s_per_s": loop_rate,
               "bare_step_audio_s_per_s": bare["audio_s_per_s"],
               "loop_over_bare": loop_rate / bare["audio_s_per_s"],
               "checkpoint_saves": saves, "validation": vals,
               "test_pass_s": ledger.timed_s, "test_audio_s": test_audio,
               "test_audio_s_per_s": [test_audio / s for s in ledger.timed_s],
               "first_run_s": first_s, "resume_run_s": resume_s,
               "launches": {"vq_argmin": launches[0], "residual_unit": launches[1]},
               "launches_per_call": per_call, "ragged_vs_per_file": ragged,
               "last_losses": {k: v for k, v in step_logs[-1].items() if k.endswith("_loss")},
               "test_metrics": {k: v for k, v in tests[-1].items() if k.startswith("test_")}}
        print(json.dumps({"train_loop": out, "card": card}))
        return out
    finally:
        if ledger is not None:
            ledger.close()
        shutil.rmtree(root, ignore_errors=True)


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def write_extract_corpus(root: Path, count: int = EXTRACT_FILES):
    """``count`` seeded WAVs in the LibriSpeech layout under
    ``root/LibriSpeech/test-clean/<spk>/<chap>/<spk>-<chap>-<nnnn>.wav``, of
    0.7-6.3 s, none a whole number of hops long (also after resampling),
    every eighth at 24 kHz; the first EXACT_FILES of them again under
    ``test-exact`` for the --exact run. Returns [(path, rate, samples)] and
    writes ``filelist.txt``."""
    import shutil

    import numpy as np
    from audiotokenization_tpu_torch.data.audio_io import write_wav

    rng = np.random.RandomState(7)
    seconds = rng.permutation(np.linspace(0.7, 6.3, count))
    files = []
    for i, sec in enumerate(seconds):
        rate = 24000 if i % 8 == 3 else SR
        n = int(sec * rate)
        while ceil_div(n * SR, rate) % HOP == 0:  # the length once resampled to 16 kHz
            n += 7
        spk, chap = 100 + i % 4, 200 + i % 3
        path = root / "LibriSpeech" / "test-clean" / str(spk) / str(chap) / f"{spk}-{chap}-{i:04d}.wav"
        path.parent.mkdir(parents=True, exist_ok=True)
        t = np.arange(n) / rate
        env = np.clip(np.sin(2 * np.pi * rng.uniform(2, 5) * t + rng.uniform(0, 6)), 0, None) ** 2
        w = env * (0.5 * np.sin(2 * np.pi * rng.uniform(100, 250) * t) + 0.5 * rng.randn(n)) * 0.3
        write_wav(path, (w + 0.003 * rng.randn(n)).astype(np.float32), rate)
        files.append((path, rate, n))
    for path, _, _ in files[:EXACT_FILES]:
        dst = root / "LibriSpeech" / "test-exact" / path.relative_to(
            root / "LibriSpeech" / "test-clean")
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(path, dst)
    (root / "filelist.txt").write_text("\n".join(str(p) for p, _, _ in files))
    return files


def cpu_tokens(codec_cpu, path, *, hop_pad: bool):
    """The CPU plain path's per-file tokens of one corpus file, as the CLI
    prepares it (resampled on the host, zero-padded to a whole hop unless
    --exact), and each frame's margin (``frame_gaps``)."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.data.audio_io import read_audio
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.ops.resample import resample

    wav, rate = read_audio(path)
    wav = wav[0]
    if rate != SR:
        wav = resample(torch.from_numpy(wav), rate, SR).numpy()
    if hop_pad and len(wav) % HOP:
        wav = np.pad(wav, (0, HOP - len(wav) % HOP))
    with torch.no_grad(), C.full_fp32():
        lat = C.encode(codec_cpu, torch.from_numpy(np.asarray(wav, np.float32))[None])
        _, codes, _ = C.quantize(codec_cpu, lat)
    return codes[0, 0].numpy(), frame_gaps(codec_cpu, lat)[0].numpy()


def hold_tokens(name, got, want, gap):
    """Fail unless the tokens agree except at frames whose top-2 gap is under
    GAP. Returns (frames that differ, frames under the gap)."""
    import numpy as np

    if got.shape != want.shape:
        fail(f"{name}: {got.shape[0]} frames against {want.shape[0]} on the CPU")
    differ = got != want
    if (differ & (gap >= GAP)).any():
        fail(f"{name}: {int(differ.sum())} tokens differ from the CPU's, some at a top-2 "
             f"gap >= {GAP:g}")
    return int(differ.sum()), int(np.sum(gap < GAP))


def extract_path(cfg, card):
    """10. Corpus extraction, evaluation and synthesis on Config() (module
    docstring). Returns the numbers of the extract line."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from audiotokenization_tpu_torch.cli import extract_indices, inference_full, synthesize
    from audiotokenization_tpu_torch.ops.cuda.residual_unit_kernel import fused_residual_unit
    from audiotokenization_tpu_torch.ops.cuda.vq_kernel import vq_argmin
    from audiotokenization_tpu_torch.train.checkpoint import CheckpointManager
    from audiotokenization_tpu_torch.train.state import init_train_state
    from audiotokenization_tpu_torch.utils import ragged

    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_extract_", dir=build_dir))
    nq = cfg.model.codec_decoder.vq_num_quantizers
    n_enc = len(cfg.model.codec_encoder.up_ratios) * len(cfg.model.codec_encoder.dilations)
    n_dec = len(cfg.model.codec_decoder.up_ratios) * len(cfg.model.codec_decoder.dilations)
    ledger = None
    try:
        files = write_extract_corpus(root)
        run = root / "run"
        t0 = time.perf_counter()
        mngr = CheckpointManager(run, cfg)
        mngr.save(init_train_state(cfg, generator=torch.Generator().manual_seed(0), device="cpu"))
        mngr.wait()
        setup_s = time.perf_counter() - t0
        codec_cpu = extract_indices.load_model(run, device="cpu")[1]
        # frames of each file resampled to 16 kHz and padded to a whole hop
        frames_of = {p.stem: ceil_div(ceil_div(n * SR, rate), HOP) for p, rate, n in files}
        common = ["--dataset_root", str(root), "--save_path", str(run), "--dataset_path",
                  "LibriSpeech", "--ext_audio", ".wav"]

        # extraction: buckets of 1 s, 16 rows a device batch
        ledger = LaunchLedger({"batch": (ragged, "make_ragged_tokenizer")})
        vq_argmin.launches = fused_residual_unit.launches = 0
        ext = extract_indices.main(common + ["--subsets", "test-clean", "--batch_size",
                                             str(EXTRACT_BATCH)])
        ext_launches = (vq_argmin.launches, fused_residual_unit.launches)
        ledger.close()
        calls = ledger.calls["batch"]
        if ext["saved"] != EXTRACT_FILES or ext["errors"]:
            fail(f"extraction saved {ext['saved']} files with {ext['errors']} errors")
        if len(calls) != ext["device_batches"] or set(calls) != {(nq, n_enc)} \
                or ext_launches != (nq * len(calls), n_enc * len(calls)):
            fail(f"extraction launches {ext_launches} over batches {calls}: expected K1 {nq} "
                 f"and K2 {n_enc} per device batch and nowhere else")
        out = run / "extracted_indices"
        npys = {p.stem: p for p in out.rglob("*.npy")}
        if len(npys) != EXTRACT_FILES:
            fail(f"extraction wrote {len(npys)} .npy files, not {EXTRACT_FILES}")
        for stem, p in npys.items():
            a = np.load(p)
            if a.dtype != np.int16 or a.shape != (frames_of[stem],):
                fail(f"{p.name}: {a.dtype} {a.shape}, expected int16 ({frames_of[stem]},)")
        by_len = sorted(files, key=lambda f: f[2] * SR // f[1])
        at24 = [f for f in files if f[1] != SR][:2]
        picked = list(dict.fromkeys([by_len[0], by_len[-1], *at24, files[5], files[9]]))
        flips = near = 0
        for path, _, _ in picked:
            want, gap = cpu_tokens(codec_cpu, path, hop_pad=True)
            f, n = hold_tokens(f"extraction of {path.name}", np.load(npys[path.stem]), want, gap)
            flips, near = flips + f, near + n

        # the same corpus in fast mode (phase 11), against the conformant files
        ledger = LaunchLedger({"batch": (ragged, "make_ragged_tokenizer")})
        vq_argmin.launches = fused_residual_unit.launches = 0
        fast = extract_indices.main(common + ["--subsets", "test-clean", "--batch_size",
                                              str(EXTRACT_BATCH), "--mode", "fast",
                                              "--output_folder", "fast"])
        fast_launches = (vq_argmin.launches, fused_residual_unit.launches)
        ledger.close()
        calls = ledger.calls["batch"]
        if fast["saved"] != EXTRACT_FILES or fast["errors"] or set(calls) != {(nq, n_enc)} \
                or fast_launches != (nq * len(calls), n_enc * len(calls)):
            fail(f"--mode fast extraction: {fast['saved']} saved, {fast['errors']} errors, "
                 f"launches {fast_launches} over batches {calls}")
        fast_differ = fast_tokens = 0
        d_cfg = cfg.model.codec_decoder
        for stem, p in npys.items():
            a, b = np.load(p), np.load(next((run / "fast").rglob(f"{stem}.npy")))
            if a.shape != b.shape or not 0 <= b.min() <= b.max() < d_cfg.codebook_size:
                fail(f"--mode fast: {stem}.npy {b.shape}, codes {b.min()}..{b.max()}")
            fast_differ, fast_tokens = fast_differ + int((a != b).sum()), fast_tokens + a.size
        print(f"--mode fast extraction: {fast['audio_s_per_s']} audio-s/s, {fast_differ} of "
              f"{fast_tokens} tokens differ from the conformant files")

        # --exact: one call a file at its raw length
        vq_argmin.launches = fused_residual_unit.launches = 0
        exact = extract_indices.main(common + ["--subsets", "test-exact", "--exact",
                                               "--output_folder", "exact"])
        exact_launches = (vq_argmin.launches, fused_residual_unit.launches)
        if exact_launches != (nq * EXACT_FILES, n_enc * EXACT_FILES):
            fail(f"--exact launched K1/K2 {exact_launches} for {EXACT_FILES} files")
        exact_flips = exact_near = 0
        for path, _, _ in files[:EXACT_FILES]:
            want, gap = cpu_tokens(codec_cpu, path, hop_pad=False)
            got = np.load(next((run / "exact").rglob(f"{path.stem}.npy")))
            f, n = hold_tokens(f"--exact extraction of {path.name}", got, want, gap)
            exact_flips, exact_near = exact_flips + f, exact_near + n

        # evaluation: whole files through the ragged codec, 16 rows a batch
        ledger = LaunchLedger({"batch": (ragged, "make_ragged_codec")})
        vq_argmin.launches = fused_residual_unit.launches = 0
        summary = inference_full.main(["--save_path", str(run), "--filelist",
                                       str(root / "filelist.txt"), "--duration", "0",
                                       "--batch_size", str(EXTRACT_BATCH), "--num_examples", "2"])
        eval_launches = (vq_argmin.launches, fused_residual_unit.launches)
        ledger.close()
        calls = ledger.calls["batch"]
        if not calls or set(calls) != {(nq, n_enc + n_dec)} \
                or eval_launches != (nq * len(calls), (n_enc + n_dec) * len(calls)):
            fail(f"evaluation launches {eval_launches} over batches {calls}: expected K1 {nq} "
                 f"and K2 {n_enc + n_dec} per device batch and nowhere else")
        bad = [k for k in ("si_snr", "si_sdr", "stoi")
               if summary[k] is None or not np.isfinite(summary[k])]
        if bad:
            fail(f"evaluation summary without finite {bad}")
        if summary["frames"] != sum(frames_of.values()):
            fail(f"evaluation counted {summary['frames']} frames, the files hold "
                 f"{sum(frames_of.values())}")
        eval_batches = len(calls)

        # synthesis from random tokens, against the CPU's decode of its tokens.npy
        vq_argmin.launches = fused_residual_unit.launches = 0
        t0 = time.perf_counter()
        wav = synthesize.main(["--codec_ckpt", str(run), "--random", "--seconds", "1",
                               "--num_samples", "4", "--out_dir", str(root / "synth")])
        synth_ms = (time.perf_counter() - t0) * 1e3
        synth_launches = (vq_argmin.launches, fused_residual_unit.launches)
        if synth_launches != (0, n_dec):
            fail(f"synthesize launched K1/K2 {synth_launches}, expected 0 / {n_dec}")
        tokens = torch.from_numpy(np.load(root / "synth" / "tokens.npy").astype(np.int64))
        want = synthesize.decode_tokens(codec_cpu, tokens).numpy()
        wav_err = float(np.abs(wav - want).max())
        if wav.shape != want.shape or not np.allclose(wav, want, rtol=WAV_RTOL, atol=WAV_ATOL):
            fail(f"synthesize: waveform outside rtol 1e-3 / atol 2e-5 of the CPU's decode "
                 f"(max |d| {wav_err:.3g})")
        codec = extract_indices.load_model(run)[1]
        decode_ms = cuda_ms(lambda: synthesize.decode_tokens(codec, tokens.cuda()), iters=5)

        audio_s = summary["audio_seconds"]
        result = {
            "files": EXTRACT_FILES, "audio_seconds": ext["audio_seconds"],
            "batch_size": EXTRACT_BATCH, "run_dir_write_s": setup_s,
            "extract": {k: ext[k] for k in ("audio_s_per_s", "wall_seconds", "device_batches",
                                            "read_s", "resample_s", "device_s", "save_s")},
            "extract_launches": {"vq_argmin": ext_launches[0], "residual_unit": ext_launches[1]},
            "flips_vs_cpu": {"files": len(picked), "tokens_differ": flips, "near_ties": near,
                             "exact_files": EXACT_FILES, "exact_tokens_differ": exact_flips,
                             "exact_near_ties": exact_near},
            "exact": {k: exact[k] for k in ("audio_s_per_s", "device_batches", "device_s")},
            "extract_fast": {**{k: fast[k] for k in ("audio_s_per_s", "wall_seconds",
                                                     "device_batches", "device_s")},
                             "launches": {"vq_argmin": fast_launches[0],
                                          "residual_unit": fast_launches[1]},
                             "tokens_differ": fast_differ, "tokens": fast_tokens,
                             "flip_rate": fast_differ / fast_tokens},
            "eval": {"audio_s_per_s": summary["audio_s_per_s"], "wall_seconds":
                     summary["wall_seconds"], "forward_s": summary["forward_s"],
                     "quality_s": summary["quality_s"], "device_batches": eval_batches,
                     "forward_audio_s_per_s": audio_s / summary["forward_s"],
                     **{k: summary[k] for k in ("si_snr", "si_sdr", "stoi", "pesq", "frames",
                                                "codebook_used", "perplexity_raw")}},
            "eval_launches": {"vq_argmin": eval_launches[0], "residual_unit": eval_launches[1]},
            "synthesize": {"ms": synth_ms, "decode_ms": decode_ms, "samples": 4, "seconds": 1,
                           "max_abs_err_wav_vs_cpu": wav_err}}
        print(json.dumps({"extract": result, "card": card}))
        return result
    finally:
        if ledger is not None:
            ledger.close()
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# 11-13: the tokenize modes, the causal and streaming codec, anti-aliasing
# and chunked tokenization
# ---------------------------------------------------------------------------

# configs/*.yaml as overlays of Config(), so that a machine without PyYAML
# builds them too; where PyYAML is present, repo_config checks they agree
REPO_CONFIGS = {
    "bigcodec_causal.yaml": {"name": "bigcodec-causal", "model": {
        "codec_encoder": {"type": "bigcodec", "out_channels": 1024, "ngf": 48, "causal": True,
                          "rnn_bidirectional": False},
        "codec_decoder": {"type": "bigcodec", "in_channels": 1024, "causal": True,
                          "codebook_size": 8192, "codebook_dim": 8}}},
    "bigcodec_antialias.yaml": {
        "name": "bigcodec-base512-1p2M-antialias",
        "model": {
            "codec_encoder": {"type": "bigcodec", "out_channels": 512, "ngf": 32, "use_rnn": True,
                              "rnn_num_layers": 2, "up_ratios": [2, 4, 5, 5],
                              "antialias": True},
            "codec_decoder": {"type": "bigcodec", "in_channels": 512,
                              "upsample_initial_channel": 512, "ngf": 32, "use_rnn": True,
                              "rnn_num_layers": 2, "up_ratios": [5, 5, 4, 2],
                              "codebook_size": 8192, "codebook_dim": 8, "antialias": True}},
        "train": {"max_steps": 1200000, "precision": "bf16"}},
    "conformer.yaml": {
        "name": "conformer-stft-istft-vq8192-80hz",
        "model": {
            "codec_encoder": {"type": "conformer_stft", "hop_length": 200, "n_fft": 800,
                              "window_size": 800, "dim": 256, "n_layers": 6, "n_head": 8,
                              "rope_theta": 500, "out_channels": 256},
            "codec_decoder": {"type": "conformer_istft", "in_channels": 256, "hop_length": 200,
                              "n_fft": 800, "window_size": 800, "dim": 256, "n_layers": 6,
                              "n_head": 8, "rope_theta": 500, "codebook_size": 8192,
                              "codebook_dim": 8}},
        "train": {"max_steps": 180000, "precision": "bf16"},
        "dataset": {"sample_rate": 16000, "pad_to_multiple_of": 200}},
    "conformer_moe.yaml": {
        "name": "conformer-moe8-vq8192-80hz",
        "model": {
            "codec_encoder": {"type": "conformer_stft", "hop_length": 200, "n_fft": 800,
                              "window_size": 800, "dim": 256, "n_layers": 6, "n_head": 8,
                              "rope_theta": 500, "out_channels": 256, "ffn_type": "moe",
                              "moe_experts": 8, "moe_top_k": 2, "moe_capacity_factor": 1.25},
            "codec_decoder": {"type": "conformer_istft", "in_channels": 256, "hop_length": 200,
                              "n_fft": 800, "window_size": 800, "dim": 256, "n_layers": 6,
                              "n_head": 8, "rope_theta": 500, "codebook_size": 8192,
                              "codebook_dim": 8, "ffn_type": "moe", "moe_experts": 8,
                              "moe_top_k": 2, "moe_capacity_factor": 1.25}},
        "train": {"max_steps": 180000, "precision": "bf16"},
        "dataset": {"sample_rate": 16000, "pad_to_multiple_of": 200}},
    "bigcodec_semantic.yaml": {
        "name": "bigcodec512-semantic-vq8192",
        "model": {
            "codec_encoder": {"type": "bigcodec", "out_channels": 512, "ngf": 16,
                              "use_rnn": False, "rnn_num_layers": 1, "up_ratios": [2, 2, 4, 4, 5]},
            "codec_decoder": {"type": "bigcodec", "in_channels": 512,
                              "upsample_initial_channel": 512, "ngf": 16, "use_rnn": True,
                              "rnn_num_layers": 1, "up_ratios": [5, 4, 4, 2, 2],
                              "codebook_size": 8192, "codebook_dim": 8},
            "mpd": {"periods": [2, 3, 5], "channels": 8, "max_downsample_channels": 256},
            "mstft": {"stft_params": {"fft_sizes": [256, 512, 1024], "hop_sizes": [64, 128, 256],
                                      "win_lengths": [256, 512, 1024]},
                      "channels": 8, "max_downsample_channels": 256}},
        "train": {"use_semantic": True, "concat_semantic": True, "precision": "bf16"},
        "dataset": {"pad_to_multiple_of": 320}},
    "bigcodec_fsq.yaml": {
        "name": "bigcodec-fsq",
        "model": {
            "codec_encoder": {"type": "bigcodec", "out_channels": 1024, "ngf": 48},
            "codec_decoder": {"type": "bigcodec", "in_channels": 1024, "fsq": True,
                              "fsq_levels": [4, 4, 4, 8], "codebook_size": 512}}},
}
# the tests' tiny codec (hop 10, 64 codes), causal and anti-aliased
TINY_CAUSAL_AA = {"model": {
    "codec_encoder": {"ngf": 4, "out_channels": 32, "up_ratios": [2, 5], "rnn_num_layers": 1,
                      "causal": True, "antialias": True},
    "codec_decoder": {"in_channels": 32, "upsample_initial_channel": 16, "up_ratios": [5, 2],
                      "rnn_num_layers": 1, "codebook_size": 64, "codebook_dim": 8,
                      "causal": True, "antialias": True}}}
MODE_BATCHES = 4           # batches of B x 1 s behind each mode's flip rate
MODE_LAT_REL = {"high": 1e-2, "balanced": 5e-2, "fast": 5e-2}  # max |dlatent| / max |latent|
STREAMS, STREAM_SECONDS, STREAM_CHUNK = 8, 10, 3200  # live streams, 0.2 s chunks
SYNTH_CHUNK_FRAMES = 16    # stream_decode's chunk (0.2 s)
CHUNKED_SECONDS, CHUNK_SECONDS = 30, 10.0
AA_RAGGED_SAMPLES = (11400, 20800, 30200, 41600)  # 4 files of unequal length, whole hops


def repo_config(name: str):
    from audiotokenization_tpu_torch import config as PC

    cfg = PC.from_dict(copy.deepcopy(REPO_CONFIGS[name]))
    try:
        import yaml  # noqa: F401
    except ImportError:
        print(f"{name}: PyYAML is missing here; built from chip_smoke.REPO_CONFIGS")
        return cfg
    if PC.to_dict(PC.load_config(Path(__file__).resolve().parent / "configs" / name)) \
            != PC.to_dict(cfg):
        fail(f"chip_smoke.REPO_CONFIGS[{name!r}] differs from configs/{name}")
    return cfg


def counted(fn):
    """(fn(), (K1, K2) launches of the call); the card synchronised after."""
    import torch
    from audiotokenization_tpu_torch.ops.cuda.residual_unit_kernel import fused_residual_unit
    from audiotokenization_tpu_torch.ops.cuda.vq_kernel import vq_argmin

    vq_argmin.launches = fused_residual_unit.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, (vq_argmin.launches, fused_residual_unit.launches)


def expect_launches(name, got, want):
    print(f"{name}: K1 {got[0]}, K2 {got[1]} launches")
    if tuple(got) != tuple(want):
        fail(f"{name}: expected K1 {want[0]} and K2 {want[1]} launches, got {tuple(got)}")


def frame_gaps(codec, lat):
    """Each frame's margin of latents (B, C, T) -> (B, T), under GAP where
    its token may flip: the VQ's top-2 distance gap; FSQ's distance of its
    bounded values from the nearest .5 rounding boundary (the smallest over
    the dims), where a few ulps of tanh may round the other way; the EMA
    VQ's top-2 gap over |x|² + |e_best|² (``ema_margins``: its distances
    cancel); LFQ's smallest |latent| over the bits, scaled so that it is
    under GAP where a bit lies within the latents' LAT_ATOL of 0."""
    import torch
    from audiotokenization_tpu_torch.config import quantizer_kind
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.models.quantizers import fsq
    from audiotokenization_tpu_torch.ops.conv import linear

    q = codec.quantizer
    kind = quantizer_kind(codec.cfg)
    if kind == "ema_vq":
        flat = lat.float().transpose(1, 2).reshape(-1, lat.shape[1])
        return ema_margins(flat, q.embed, codec.cfg.model.codec_decoder.vq_cosine_sim).reshape(
            lat.shape[0], lat.shape[-1])
    if kind == "lfq":
        return lat.float().abs().amin(1) * (GAP / LAT_ATOL)
    if isinstance(q, fsq.FSQ):
        with C.full_fp32(), torch.no_grad():
            z = lat.float().transpose(1, 2)
            z = linear(z, q.project_in) if hasattr(q, "project_in") else z
            b = fsq.fsq_bounded(z, q.levels)
            return ((b - torch.floor(b)) - 0.5).abs().amin(-1)
    layer = q.layers[0]
    with C.full_fp32(), torch.no_grad():
        z_e = linear(lat.transpose(1, 2), layer.in_proj)
        return top2_gap(plain_dist(z_e.reshape(-1, z_e.shape[-1]), layer.codebook)).reshape(
            lat.shape[0], lat.shape[-1])


def hold_codes(name, got, want, gap):
    """Fail unless the codes (1, B, T) agree but at frames whose top-2 gap
    (B, T) is under GAP. Returns (frames that differ, frames under GAP)."""
    if tuple(got.shape) != tuple(want.shape):
        fail(f"{name}: codes {tuple(got.shape)} against {tuple(want.shape)}")
    differ = (got != want).reshape(gap.shape)
    if (differ & (gap >= GAP)).any():
        fail(f"{name}: {int(differ.sum())} tokens differ, some at a top-2 gap >= {GAP:g}")
    return int(differ.sum()), int((gap < GAP).sum())


def hold_wav(name, got, want):
    import torch

    err = (got - want).abs().max().item()
    if got.shape != want.shape or not torch.allclose(got, want, rtol=WAV_RTOL, atol=WAV_ATOL):
        fail(f"{name}: waveform {tuple(got.shape)} outside rtol 1e-3 / atol 2e-5 of "
             f"{tuple(want.shape)} (max |d| {err:.3g})")
    return err


def _busy_ms(events) -> float:
    """The union of the device spans (us) of ``events``, in ms."""
    busy_us, end = 0.0, float("-inf")
    for _, start, stop in sorted(events, key=lambda e: e[1]):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return busy_us / 1e3


def step_ms(fn, steps):
    """Latency of each of ``steps`` calls, each on an idle card (CUDA events
    around the call, a synchronise after it, as a live stream's chunk
    finds it); returns the outputs and the latencies in ms."""
    import torch

    outs, times = [], []
    for args in steps:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        outs.append(fn(*args))
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return outs, times


def percentiles(times):
    import numpy as np

    return {"p50_ms": float(np.percentile(times, 50)), "p99_ms": float(np.percentile(times, 99)),
            "steps": len(times)}


def modes_path(cfg, codec, card):
    """11. Each tokenize mode on the flagship at B x 1 s (phase 5's weights
    and first batch): launches, audio-s/s, the profiler's split, token flips
    and code count against conformant over MODE_BATCHES batches, and the
    latents' max |d| / max |latent|."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.ops.lstm import res_lstm
    from audiotokenization_tpu_torch.ops.params import parameters_as

    enc = codec.encoder
    d = cfg.model.codec_decoder
    nq, n_units = d.vq_num_quantizers, len(enc.up_ratios) * len(enc.dilations)
    wavs = [torch.from_numpy((np.random.RandomState(i).randn(B, SR) * 0.1).astype(np.float32))
            .cuda() for i in range(MODE_BATCHES)]

    def latents(wav, mode):
        return C.encode_in_mode(enc, wav[:, None, :], mode)

    lstm_in = torch.randn(B, enc.conv_out.weight().shape[1], SR // HOP).cuda()

    def lstm_alone(mode):
        """The encoder's ResLSTM alone, as ``mode`` runs it."""
        with torch.no_grad():
            if mode == "fast":
                bf16 = {n: p.detach().to(torch.bfloat16) for n, p in enc.lstm.named_parameters()}
                with C.full_fp32(), parameters_as(enc.lstm, bf16):
                    return res_lstm(lstm_in.to(torch.bfloat16), enc.lstm)
            with C.allow_tf32() if mode == "high" else C.full_fp32():
                return res_lstm(lstm_in, enc.lstm)

    ref_codes = [C.tokenize(codec, w) for w in wavs]
    ref_lat = [latents(w, "conformant") for w in wavs]
    rows = {}
    for mode in C.MODES:
        codes, launches = counted(lambda: C.tokenize(codec, wavs[0], mode=mode))
        expect_launches(f"tokenize mode {mode}", launches, (nq, n_units))
        all_codes = [codes] + [C.tokenize(codec, w, mode=mode) for w in wavs[1:]]
        for c in all_codes:
            if tuple(c.shape) != (nq, B, SR // HOP) or int(c.min()) < 0 \
                    or int(c.max()) >= d.codebook_size:
                fail(f"tokenize mode {mode}: codes {tuple(c.shape)} in "
                     f"{int(c.min())}..{int(c.max())}")
        flips = sum(int((c != r).sum()) for c, r in zip(all_codes, ref_codes))
        used = int(torch.unique(torch.cat([c.reshape(-1) for c in all_codes])).numel())
        lat_rel = max(((latents(w, mode) - r).abs().max() / r.abs().max()).item()
                      for w, r in zip(wavs, ref_lat))
        if mode in MODE_LAT_REL and not lat_rel <= MODE_LAT_REL[mode]:
            fail(f"tokenize mode {mode}: max |dlatent| / max |latent| = {lat_rel:.3g} against "
                 f"conformant, over {MODE_LAT_REL[mode]:g}")
        ms = cuda_ms(lambda: C.tokenize(codec, wavs[0], mode=mode), iters=5)
        events, wall_ms = device_events(lambda: C.tokenize(codec, wavs[0], mode=mode))
        busy = _busy_ms(events)
        k2_ms = _busy_ms([e for e in events if "tf32unit" in e[0]])
        lstm_ms = _busy_ms(device_events(lambda: lstm_alone(mode))[0])
        rows[mode] = {
            "ms": ms, "audio_s_per_s": B / (ms / 1e3),
            "launches": {"vq_argmin": launches[0], "residual_unit": launches[1]},
            "token_flips": flips, "tokens": MODE_BATCHES * nq * B * (SR // HOP),
            "flip_rate": flips / (MODE_BATCHES * nq * B * (SR // HOP)), "codes_used": used,
            "max_abs_dlatent_over_max_latent": lat_rel,
            "profile": {"wall_ms": wall_ms, "device_busy_ms": busy, "k2_ms": k2_ms,
                        "k2_share": k2_ms / busy, "lstm_alone_ms": lstm_ms,
                        "lstm_share": lstm_ms / busy, "idle_share": 1 - busy / wall_ms}}
        print(json.dumps({"tokenize_mode": {"mode": mode, **rows[mode]}, "card": card}))
    return rows


def offline_vs_cpu(name, cfg, codec):
    """tokenize and decode of B x 1 s on the card: launches (K1 1 and K2 0
    a tokenize, none a decode: these units are not K2's), the first 2
    requests against the CPU, audio-s/s. Returns the numbers."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.models import codec as C

    from audiotokenization_tpu_torch.config import codec_hop

    nq = cfg.model.codec_decoder.vq_num_quantizers
    hop = codec_hop(cfg)
    wav_np = (np.random.RandomState(0).randn(B, SR) * 0.1).astype(np.float32)
    wav = torch.from_numpy(wav_np).cuda()
    codes, tok_launches = counted(lambda: C.tokenize(codec, wav))
    out, dec_launches = counted(lambda: offline_decode(codec, codes))
    expect_launches(f"{name} tokenize", tok_launches, (nq, 0))
    expect_launches(f"{name} decode", dec_launches, (0, 0))
    if tuple(codes.shape) != (nq, B, SR // hop) or tuple(out.shape) != (B, 1, SR) \
            or not torch.isfinite(out).all():
        fail(f"{name}: codes {tuple(codes.shape)}, waveform {tuple(out.shape)}")
    cmp = hold_against_cpu(name, codec, wav_np, codes, out)
    tok_ms = cuda_ms(lambda: C.tokenize(codec, wav), iters=5)
    dec_ms = cuda_ms(lambda: offline_decode(codec, codes), iters=5)
    return {"tokenize_ms": tok_ms, "tokenize_audio_s_per_s": B / (tok_ms / 1e3),
            "decode_ms": dec_ms, "decode_audio_s_per_s": B / (dec_ms / 1e3),
            "launches_per_tokenize": {"vq_argmin": tok_launches[0],
                                      "residual_unit": tok_launches[1]}, **cmp}


def stream_tokens(codec, streams, chunk, *, timed: bool, tok=None):
    """``streams`` (S, T) through a StreamingTokenizer (or ``tok``) in
    ``chunk``-sample steps, flushed: (codes (Nq, S, T / hop) with the
    latency's warm-up dropped, per-step (K1, K2) launches, per-step
    latencies or None)."""
    import torch
    from audiotokenization_tpu_torch.models.streaming import StreamingTokenizer
    from audiotokenization_tpu_torch.ops.cuda.residual_unit_kernel import fused_residual_unit
    from audiotokenization_tpu_torch.ops.cuda.vq_kernel import vq_argmin

    tok = tok or StreamingTokenizer(codec, chunk_samples=chunk)
    state = [tok.init_state(batch_size=streams.shape[0])]
    launches = []

    def one(x):
        vq_argmin.launches = fused_residual_unit.launches = 0
        codes, state[0] = tok.step(state[0], x)
        launches.append((vq_argmin.launches, fused_residual_unit.launches))
        return codes

    steps = [(streams[:, i:i + chunk],) for i in range(0, streams.shape[1], chunk)]
    if timed:
        pieces, times = step_ms(one, steps)
    else:
        pieces, times = [one(*a) for a in steps], None
    tail, _ = tok.flush(state[0])
    codes = torch.cat(pieces + [tail], dim=2)[:, :, tok.delay_frames:]
    return codes, launches, times


def synth_steps(codec, codes, chunk_frames, syn=None):
    """Per-step latencies of a StreamingSynthesizer (or ``syn``) over whole
    chunks of ``codes`` (Nq, S, T)."""
    from audiotokenization_tpu_torch.models.streaming import StreamingSynthesizer

    syn = syn or StreamingSynthesizer(codec, chunk_frames=chunk_frames)
    state = [syn.init_state(batch_size=codes.shape[1])]

    def one(c):
        wav, state[0] = syn.step(state[0], c)
        return wav

    steps = [(codes[:, :, t:t + chunk_frames],)
             for t in range(0, codes.shape[-1] - chunk_frames + 1, chunk_frames)]
    return step_ms(one, steps)[1]


def causal_path(card):
    """12. configs/bigcodec_causal.yaml at full width (module docstring)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from audiotokenization_tpu_torch import config as PC
    from audiotokenization_tpu_torch.cli import extract_indices, synthesize
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.models.streaming import stream_decode
    from audiotokenization_tpu_torch.train.checkpoint import CheckpointManager
    from audiotokenization_tpu_torch.train.state import init_train_state

    cfg = repo_config("bigcodec_causal.yaml")
    codec = seeded_codec(cfg)
    nq = cfg.model.codec_decoder.vq_num_quantizers
    hop = int(np.prod(cfg.model.codec_encoder.up_ratios))
    result = {"offline": offline_vs_cpu("causal", cfg, codec)}

    # live streams against the card's offline tokenize of the whole streams
    streams = torch.from_numpy((np.random.RandomState(1).randn(STREAMS, STREAM_SECONDS * SR)
                                * 0.1).astype(np.float32)).cuda()
    with C.full_fp32(), torch.no_grad():
        lat = C.encode(codec, streams)
        _, off_codes, _ = C.quantize(codec, lat)
    gap = frame_gaps(codec, lat)
    stream_tokens(codec, streams[:, :2 * STREAM_CHUNK], STREAM_CHUNK, timed=False)  # warm-up
    codes, launches, times = stream_tokens(codec, streams, STREAM_CHUNK, timed=True)
    if set(launches) != {(nq, 0)}:
        fail(f"streaming tokenizer: per-step launches {sorted(set(launches))}, expected "
             f"K1 {nq} and K2 0 each step")
    differ, near = hold_codes("streaming tokenizer vs offline tokenize", codes, off_codes, gap)
    lat_s = percentiles(times)
    result["stream_tokenize"] = {
        "streams": STREAMS, "seconds": STREAM_SECONDS, "chunk_samples": STREAM_CHUNK,
        **lat_s, "real_time_factor": STREAM_CHUNK / SR / (lat_s["p50_ms"] / 1e3),
        "launches_per_step": {"vq_argmin": launches[0][0], "residual_unit": launches[0][1]},
        "tokens_differ": differ, "near_ties": near}

    # stream_decode of those codes against the card's offline decode
    want = offline_decode(codec, off_codes)[:, 0]
    got, launches = counted(lambda: stream_decode(codec, off_codes,
                                                  chunk_frames=SYNTH_CHUNK_FRAMES))
    expect_launches("stream_decode", launches, (0, 0))
    err = hold_wav("stream_decode vs offline decode", got, want)
    lat_d = percentiles(synth_steps(codec, off_codes, SYNTH_CHUNK_FRAMES))
    result["stream_decode"] = {
        "chunk_frames": SYNTH_CHUNK_FRAMES, **lat_d,
        "real_time_factor": SYNTH_CHUNK_FRAMES * hop / SR / (lat_d["p50_ms"] / 1e3),
        "max_abs_err_wav_vs_offline": err}

    # cli.synthesize --streaming on a causal run dir
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_causal_", dir=build_dir))
    try:
        mngr = CheckpointManager(root / "run", cfg)
        mngr.save(init_train_state(cfg, generator=torch.Generator().manual_seed(0), device="cpu"))
        mngr.wait()
        wav, launches = counted(lambda: synthesize.main(
            ["--codec_ckpt", str(root / "run"), "--random", "--seconds", "1", "--num_samples",
             "4", "--streaming", str(SYNTH_CHUNK_FRAMES), "--out_dir", str(root / "synth")]))
        expect_launches("synthesize --streaming", launches, (0, 0))
        tokens = torch.from_numpy(np.load(root / "synth" / "tokens.npy").astype(np.int64)).cuda()
        loaded = extract_indices.load_model(root / "run")[1]
        err = hold_wav("synthesize --streaming vs decode", torch.from_numpy(wav).cuda(),
                       synthesize.decode_tokens(loaded, tokens))
        result["synthesize_streaming"] = {"samples": 4, "seconds": 1,
                                          "max_abs_err_wav_vs_decode": err}
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the tests' tiny causal + anti-aliased codec: latency, delay_frames, flush
    tiny = PC.from_dict(copy.deepcopy(TINY_CAUSAL_AA))
    codec_t = seeded_codec(tiny)
    wav_t = torch.from_numpy((np.random.RandomState(2).randn(2, 2000) * 0.1)
                             .astype(np.float32)).cuda()
    with C.full_fp32(), torch.no_grad():
        lat_t = C.encode(codec_t, wav_t)
        _, off_t, _ = C.quantize(codec_t, lat_t)
    codes_t, launches, _ = stream_tokens(codec_t, wav_t, 200, timed=False)
    if set(launches) != {(1, 0)}:
        fail(f"tiny causal+AA streaming: per-step launches {sorted(set(launches))}")
    differ_t, _ = hold_codes("tiny causal+AA streaming tokenizer vs offline",
                             codes_t[:, :, :off_t.shape[-1]], off_t, frame_gaps(codec_t, lat_t))
    rand = torch.from_numpy(np.random.RandomState(3).randint(0, 64, (1, 2, 57))).cuda()
    err_t = hold_wav("tiny causal+AA stream_decode vs offline decode",
                     stream_decode(codec_t, rand, chunk_frames=20),
                     offline_decode(codec_t, rand)[:, 0])
    result["tiny_causal_aa"] = {"tokens_differ": differ_t, "max_abs_err_wav": err_t,
                                "frames": int(off_t.shape[-1])}
    print(json.dumps({"causal": result, "card": card}))
    return result


def aa_chunked_path(cfg, codec, card):
    """13. configs/bigcodec_antialias.yaml and tokenize_chunked on Config()
    (module docstring)."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.utils.chunked import (make_chunked_tokenizer,
                                                           receptive_field_samples)
    from audiotokenization_tpu_torch.utils.ragged import make_ragged_tokenizer

    aa_cfg = repo_config("bigcodec_antialias.yaml")
    aa = seeded_codec(aa_cfg)
    nq = aa_cfg.model.codec_decoder.vq_num_quantizers
    aa_hop = int(np.prod(aa_cfg.model.codec_encoder.up_ratios))
    result = {"antialias_offline": offline_vs_cpu("antialias", aa_cfg, aa)}

    # ragged: 4 files of unequal length in one call against each file alone
    rng = np.random.RandomState(4)
    files = [(rng.randn(n) * 0.1).astype(np.float32) for n in AA_RAGGED_SAMPLES]
    batch = np.zeros((len(files), max(AA_RAGGED_SAMPLES)), np.float32)
    for i, w in enumerate(files):
        batch[i, :len(w)] = w
    batch, lens = torch.from_numpy(batch).cuda(), torch.tensor(AA_RAGGED_SAMPLES).cuda()
    run = make_ragged_tokenizer(aa_cfg)
    codes, launches = counted(lambda: run(aa, batch, lens))
    expect_launches("antialias ragged tokenizer", launches, (nq, 0))
    differ = near = 0
    for i, w in enumerate(files):
        x = torch.from_numpy(w)[None].cuda()
        with C.full_fp32(), torch.no_grad():
            lat = C.encode(aa, x)
            _, own, _ = C.quantize(aa, lat)
        f, n = hold_codes(f"antialias ragged row {i} vs its own tokenize",
                          codes[:, i:i + 1, :len(w) // aa_hop], own, frame_gaps(aa, lat))
        differ, near = differ + f, near + n
    ms = cuda_ms(lambda: run(aa, batch, lens), iters=5)
    audio_s = sum(AA_RAGGED_SAMPLES) / SR
    result["antialias_ragged"] = {"files": len(files), "audio_seconds": audio_s,
                                  "ms": ms, "audio_s_per_s": audio_s / (ms / 1e3),
                                  "launches_per_call": {"vq_argmin": launches[0],
                                                        "residual_unit": launches[1]},
                                  "tokens_differ": differ, "near_ties": near}

    # tokenize_chunked on Config(): one long file in windows
    d = cfg.model.codec_decoder
    n_units = len(cfg.model.codec_encoder.up_ratios) * len(cfg.model.codec_encoder.dilations)
    wav = torch.from_numpy((np.random.RandomState(5).randn(CHUNKED_SECONDS * SR) * 0.1)
                           .astype(np.float32)).cuda()
    with C.full_fp32(), torch.no_grad():
        lat = C.encode(codec, wav[None])
        _, off, _ = C.quantize(codec, lat)
    chunked = make_chunked_tokenizer(codec, chunk_seconds=CHUNK_SECONDS)
    got, launches = counted(lambda: chunked(wav))
    windows = int(np.ceil(CHUNKED_SECONDS / CHUNK_SECONDS))
    expect_launches("tokenize_chunked", launches, (windows * d.vq_num_quantizers,
                                                   windows * n_units))
    # away from the file's edges, where the chunks' zero context reaches the
    # ResLSTM's start state and conv_out
    edge = -(-receptive_field_samples(cfg) // HOP)
    gap = frame_gaps(codec, lat)
    inner = hold_codes("tokenize_chunked vs offline tokenize", got[None, :, edge:-1],
                       off[:, :, edge:-1], gap[:, edge:-1])
    edges = int((got[:, :edge] != off[0, :, :edge]).sum() + (got[:, -1] != off[0, :, -1]).sum())
    ms = cuda_ms(lambda: chunked(wav), iters=3, warmup=1)
    result["chunked"] = {"seconds": CHUNKED_SECONDS, "chunk_seconds": CHUNK_SECONDS,
                         "windows": windows, "ms": ms,
                         "audio_s_per_s": CHUNKED_SECONDS / (ms / 1e3),
                         "launches_per_window": {"vq_argmin": launches[0] // windows,
                                                 "residual_unit": launches[1] // windows},
                         "tokens_differ_inside": inner[0], "near_ties_inside": inner[1],
                         "edge_frames": edge + 1, "tokens_differ_at_edges": edges}
    print(json.dumps({"antialias_chunked": result, "card": card}))
    return result



# ---------------------------------------------------------------------------
# 14: the Conformer STFT/ISTFT codec (configs/conformer.yaml)
# ---------------------------------------------------------------------------

LONG_REQUESTS, LONG_SECONDS = 4, 30   # one long input: 2400 frames a request
LONG_ATTENTION_SEEDS = (3, 4, 5, 6, 7)  # further inputs of the long attention check (it: seed 2)
CONFORMER_RAGGED_FILES, CONFORMER_CODEC_FILES, CONFORMER_EXTRACT_FILES = 8, 4, 32
CONFORMER_MODE_LAT_REL = {"high": 1e-2, "fast": 5e-2}  # max |dlatent| / max |latent|


def sdpa_dispatched(q, k, v) -> str:
    """The route ``attend`` takes for q, k, v (B, T, H, D) under the current
    TF32 flag: ``plain_fp32`` (no SDPA), or the backend SDPA's dispatcher
    picks."""
    import torch
    from audiotokenization_tpu_torch.ops.transformer import plain_fp32
    from torch.nn.attention import SDPBackend

    if plain_fp32(q.dtype):
        return "plain_fp32"
    names = {int(b): name.lower() for name, b in SDPBackend.__members__.items()}
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    return names[int(torch._fused_sdp_choice(q, k, v))]


def sdpa_backend(kernels) -> str:
    """The attention route a call's device kernel names show (``plain``:
    softmax and GEMM kernels, no fused attention)."""
    names = " ".join(kernels).lower()
    for key, backend in (("flash_fwd", "flash"), ("fmha", "efficient"), ("cudnn", "cudnn"),
                         ("softmax", "plain")):
        if key in names:
            return backend
    return "unknown"


def conformer_split(fn):
    """torch.profiler split of one call of ``fn``: device ms of the
    attention (SDPA, or the plain path's bmm and softmax ops), of every
    GEMM kernel (attention's matmuls included), of the FFTs and of K1; the
    device's busy time, the idle share of the call's wall time, the kernel
    count and the attention route seen."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    captures = []
    for _ in range(3):  # the profiler has dropped kernel records on that card: keep the fullest
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        events = prof.events()
        captures.append(([(e.name, e.time_range.start, e.time_range.end) for e in events
                          if e.device_type == DeviceType.CUDA], events, ms))
    dev, events, wall_ms = max(captures, key=lambda c: len(c[0]))

    def busy(*keys):
        return _busy_ms([e for e in dev if any(k in e[0].lower() for k in keys)
                         and "fmha" not in e[0].lower()])

    # SDPA, or the plain path's attention GEMMs (bmm: the linears are mm) and softmax
    attn_us = sum(e.device_time_total for e in events if e.device_type == DeviceType.CPU
                  and e.name in ("aten::scaled_dot_product_attention", "aten::bmm",
                                 "aten::softmax"))
    total = _busy_ms(dev)
    return {"wall_ms": wall_ms, "device_busy_ms": total, "attention_ms": attn_us / 1e3,
            "gemm_ms": busy("gemm", "gemv", "xmma"), "fft_ms": busy("fft"),
            "k1_ms": busy("vq_argmin"), "idle_share": 1 - total / wall_ms,
            "device_kernels": len(dev), "attention_route": sdpa_backend(n for n, _, _ in dev)}


def conformer_attention_inputs(codec, wav):
    """q, k, v (B, T, H, D) of the encoder's first attention over ``wav``
    (B, samples) on the card: its STFT features, RMS-normed, projected and
    rotated."""
    import torch
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.models.conformer import encode_features
    from audiotokenization_tpu_torch.ops.stft import stft_same_constant_pad
    from audiotokenization_tpu_torch.ops.transformer import qkv_heads, rms_norm

    enc = codec.encoder
    bb, layer = enc.backbone, enc.backbone.layers[0]
    with C.full_fp32(), torch.no_grad():
        spec = stft_same_constant_pad(wav, n_fft=enc.n_fft, hop_length=enc.hop_length,
                                      win_length=enc.window_size)
        h = encode_features(enc, spec)
        cos, sin = (t[:h.shape[1]] for t in bb.rope(h.device))
        return qkv_heads(rms_norm(h, layer.attn_norm), layer.attn, cos, sin, bb.n_head)


def hold_attention(name, q, k, v, *, modes: bool = True):
    """The conformant attention (fp32, TF32 off) on the card against the same
    attention in float64: fatal unless its error is at most F64_RATIO x the
    CPU fp32 one's. Reports beside it the error of one fp32 GEMM over the
    whole key axis (SDPA's math backend, which the conformant path ran
    before its value sum was blocked) and, with ``modes``, the high mode's
    (TF32 allowed) and fast mode's (bf16) errors, the route each takes
    (``sdpa_dispatched``) and the kernels each runs (the profiler's,
    captured again while it reports none)."""
    import torch
    import torch.nn.functional as F
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.ops.transformer import attend
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def run(scope, dtype=torch.float32):
        with scope(), torch.no_grad():
            return attend(q.to(dtype), k.to(dtype), v.to(dtype))

    with torch.no_grad():
        ref64 = attend(q.double(), k.double(), v.double())
        with C.full_fp32():
            plain = attend(q.cpu(), k.cpu(), v.cpu())
        with C.full_fp32(), sdpa_kernel(SDPBackend.MATH):
            chain = F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in (q, k, v)))
    err_plain = (plain.double() - ref64.cpu()).abs().max().item()
    err_chain = (chain.transpose(1, 2).double() - ref64).abs().max().item()
    out = {"shape": list(q.shape), "plain_fp32_cpu_err_vs_f64": err_plain,
           "one_gemm_chain": {"err_vs_f64": err_chain, "ratio_to_plain": err_chain / err_plain}}
    for mode, scope, dtype in (("conformant", C.full_fp32, torch.float32),
                               ("high", C.allow_tf32, torch.float32),
                               ("fast", C.full_fp32, torch.bfloat16))[:3 if modes else 1]:
        err = (run(scope, dtype).double() - ref64).abs().max().item()
        with scope():
            backend = sdpa_dispatched(q.to(dtype), k.to(dtype), v.to(dtype))
        out[mode] = {"err_vs_f64": err, "ratio_to_plain": err / err_plain, "backend": backend}
        if modes:
            kernels = sorted({n for n, _, _ in complete_events(lambda: run(scope, dtype), 1)[0]})
            out[mode].update(kernels_show=sdpa_backend(kernels),
                             kernels=[n[:80] for n in kernels])
    others = "".join(f", {m} {out[m]['err_vs_f64']:.3g} ({out[m]['backend']})"
                     for m in ("high", "fast") if m in out)
    print(f"{name}: attention {tuple(q.shape)} vs float64: conformant "
          f"{out['conformant']['err_vs_f64']:.3g} ({out['conformant']['ratio_to_plain']:.3g}x, "
          f"{out['conformant']['backend']}), CPU fp32 {err_plain:.3g}, one GEMM chain "
          f"{err_chain:.3g} ({err_chain / err_plain:.3g}x){others}")
    if not out["conformant"]["err_vs_f64"] <= F64_RATIO * err_plain:
        fail(f"{name}: the conformant attention is {out['conformant']['ratio_to_plain']:.3g}x "
             f"as far from float64 as the CPU's fp32 one (limit {F64_RATIO:g}x)")
    return out


def conformer_modes(codec, wavs, ref_codes, ref_lat):
    """high and fast on B x 1 s (the offline batches): launches, audio-s/s,
    flips and codes used against conformant, latent error (fatal over
    CONFORMER_MODE_LAT_REL), the SDPA backend; balanced must raise."""
    import torch
    from audiotokenization_tpu_torch.models import codec as C

    rows = {}
    for mode, limit in CONFORMER_MODE_LAT_REL.items():
        codes, launches = counted(lambda: C.tokenize(codec, wavs[0], mode=mode))
        expect_launches(f"conformer tokenize mode {mode}", launches, (1, 0))
        all_codes = [codes] + [C.tokenize(codec, w, mode=mode) for w in wavs[1:]]
        flips = sum(int((c != r).sum()) for c, r in zip(all_codes, ref_codes))
        used = int(torch.unique(torch.cat([c.reshape(-1) for c in all_codes])).numel())
        lat_rel = max(((C.encode_in_mode(codec.encoder, w[:, None], mode) - r).abs().max()
                       / r.abs().max()).item() for w, r in zip(wavs, ref_lat))
        if not lat_rel <= limit:
            fail(f"conformer tokenize mode {mode}: max |dlatent| / max |latent| = {lat_rel:.3g} "
                 f"against conformant, over {limit:g}")
        ms = cuda_ms(lambda: C.tokenize(codec, wavs[0], mode=mode), iters=5)
        tokens = sum(c.numel() for c in all_codes)
        rows[mode] = {"ms": ms, "audio_s_per_s": B / (ms / 1e3),
                      "launches": {"vq_argmin": launches[0], "residual_unit": launches[1]},
                      "token_flips": flips, "tokens": tokens, "flip_rate": flips / tokens,
                      "codes_used": used, "max_abs_dlatent_over_max_latent": lat_rel,
                      "profile": conformer_split(lambda: C.tokenize(codec, wavs[0], mode=mode))}
    try:
        C.tokenize(codec, wavs[0], mode="balanced")
    except ValueError as e:
        rows["balanced"] = f"raises ValueError: {e}"
    else:
        fail("conformer tokenize mode balanced did not raise")
    return rows


def conformer_ragged(cfg, codec):
    """make_ragged_tokenizer on CONFORMER_RAGGED_FILES files of 0.7-6.3 s in
    one call against each file's own tokenize, and make_ragged_codec
    (fp32_strict) on the first CONFORMER_CODEC_FILES against each file's
    own decode of its tokens."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.config import codec_hop
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.utils.ragged import make_ragged_codec, make_ragged_tokenizer

    hop = codec_hop(cfg)
    lens = [int(sec * SR) // hop * hop for sec in np.linspace(0.7, 6.3, CONFORMER_RAGGED_FILES)]
    rng = np.random.RandomState(6)
    batch = np.zeros((len(lens), max(lens)), np.float32)
    for i, n in enumerate(lens):
        batch[i, :n] = rng.randn(n) * 0.1
    batch, lengths = torch.from_numpy(batch).cuda(), torch.tensor(lens).cuda()
    run = make_ragged_tokenizer(cfg)
    codes, launches = counted(lambda: run(codec, batch, lengths))
    expect_launches("conformer ragged tokenizer", launches, (1, 0))
    own, gaps = [], []
    differ = near = 0
    for i, n in enumerate(lens):
        with C.full_fp32(), torch.no_grad():
            lat = C.encode(codec, batch[i:i + 1, :n])
            own.append(C.quantize(codec, lat)[1])
        gaps.append(frame_gaps(codec, lat))
        f, m = hold_codes(f"conformer ragged row {i} vs its own tokenize",
                          codes[:, i:i + 1, :n // hop], own[i], gaps[i])
        differ, near = differ + f, near + m
    ms = cuda_ms(lambda: run(codec, batch, lengths), iters=5)
    audio_s = sum(lens) / SR
    out = {"tokenizer": {"files": len(lens), "audio_seconds": audio_s, "ms": ms,
                         "audio_s_per_s": audio_s / (ms / 1e3),
                         "launches_per_call": {"vq_argmin": launches[0],
                                               "residual_unit": launches[1]},
                         "tokens_differ": differ, "near_ties": near}}

    strict = copy.deepcopy(cfg)
    strict.train.precision = "fp32_strict"
    rc = make_ragged_codec(strict)
    k = CONFORMER_CODEC_FILES
    (recon, rcodes), launches = counted(lambda: rc(codec, batch[:k], lengths[:k]))
    expect_launches("conformer ragged codec", launches, (1, 0))
    err = 0.0
    for i, n in enumerate(lens[:k]):
        hold_codes(f"conformer ragged codec row {i} vs its own tokenize",
                   rcodes[:, i:i + 1, :n // hop], own[i], gaps[i])
        want = offline_decode(codec, rcodes[:, i:i + 1, :n // hop])[:, 0]
        err = max(err, hold_wav(f"conformer ragged codec row {i} vs its own decode",
                                recon[i:i + 1, :n], want))
    out["codec"] = {"files": k, "launches_per_call": {"vq_argmin": launches[0],
                                                      "residual_unit": launches[1]},
                    "max_abs_err_wav_vs_per_file": err}
    return out


def conformer_extract(cfg):
    """cli.extract_indices at batch EXTRACT_BATCH on CONFORMER_EXTRACT_FILES
    files from a Conformer run dir (ceil(len / hop) int16 frames, K1 once
    and K2 never per device batch, 4 files against the CPU's tokens), then
    cli.synthesize of 4 x 1 s against the CPU's decode of its tokens."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from audiotokenization_tpu_torch.cli import extract_indices, synthesize
    from audiotokenization_tpu_torch.config import codec_hop, save_config
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.utils import ragged

    hop = codec_hop(cfg)
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_conformer_", dir=build_dir))
    ledger = None
    try:
        files = write_extract_corpus(root, CONFORMER_EXTRACT_FILES)
        run = root / "run"  # a generator-only port run dir (scripts/jax_run_to_torch.py's form)
        (run / "ckpt" / "0").mkdir(parents=True)
        save_config(cfg, run / "config.json")
        gen = C.init_codec(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        torch.save({"step": 0, "gen": gen.state_dict()}, run / "ckpt" / "0" / "state.pt")
        codec_cpu = extract_indices.load_model(run, device="cpu")[1]
        frames_of = {p.stem: ceil_div(ceil_div(n * SR, rate), hop) for p, rate, n in files}
        ledger = LaunchLedger({"batch": (ragged, "make_ragged_tokenizer")})
        counts, launches = counted(lambda: extract_indices.main(
            ["--dataset_root", str(root), "--save_path", str(run), "--dataset_path",
             "LibriSpeech", "--ext_audio", ".wav", "--subsets", "test-clean",
             "--batch_size", str(EXTRACT_BATCH)]))
        ledger.close()
        calls = ledger.calls["batch"]
        if counts["saved"] != CONFORMER_EXTRACT_FILES or counts["errors"]:
            fail(f"conformer extraction saved {counts['saved']} files with "
                 f"{counts['errors']} errors")
        if len(calls) != counts["device_batches"] or set(calls) != {(1, 0)} \
                or tuple(launches) != (len(calls), 0):
            fail(f"conformer extraction launches {launches} over batches {calls}: expected "
                 "K1 1 and K2 0 per device batch and nowhere else")
        npys = {p.stem: p for p in (run / "extracted_indices").rglob("*.npy")}
        for stem, p in npys.items():
            a = np.load(p)
            if a.dtype != np.int16 or a.shape != (frames_of[stem],):
                fail(f"conformer extraction {p.name}: {a.dtype} {a.shape}, expected int16 "
                     f"({frames_of[stem]},) = ceil(len / {hop})")
        if len(npys) != CONFORMER_EXTRACT_FILES:
            fail(f"conformer extraction wrote {len(npys)} .npy files")
        by_len = sorted(files, key=lambda f: f[2] * SR // f[1])
        at24 = [f for f in files if f[1] != SR][:1]
        flips = near = 0
        for path, _, _ in dict.fromkeys([by_len[0], by_len[-1], *at24, files[5]]):
            want, gap = cpu_tokens(codec_cpu, path, hop_pad=True)
            f, m = hold_tokens(f"conformer extraction of {path.name}", np.load(npys[path.stem]),
                               want, gap)
            flips, near = flips + f, near + m

        wav, launches = counted(lambda: synthesize.main(
            ["--codec_ckpt", str(run), "--random", "--seconds", "1", "--num_samples", "4",
             "--out_dir", str(root / "synth")]))
        expect_launches("conformer synthesize", launches, (0, 0))
        tokens = torch.from_numpy(np.load(root / "synth" / "tokens.npy").astype(np.int64))
        want = synthesize.decode_tokens(codec_cpu, tokens).numpy()
        wav_err = float(np.abs(wav - want).max())
        if wav.shape != (4, SR) or not np.allclose(wav, want, rtol=WAV_RTOL, atol=WAV_ATOL):
            fail(f"conformer synthesize: waveform {wav.shape} outside rtol 1e-3 / atol 2e-5 of "
                 f"the CPU's decode (max |d| {wav_err:.3g})")
        return {"files": CONFORMER_EXTRACT_FILES, "batch_size": EXTRACT_BATCH,
                **{k: counts[k] for k in ("audio_seconds", "audio_s_per_s", "wall_seconds",
                                          "device_batches", "read_s", "resample_s", "device_s",
                                          "save_s")},
                "launches_per_batch": {"vq_argmin": calls[0][0], "residual_unit": calls[0][1]},
                "tokens_differ_vs_cpu": flips, "near_ties": near,
                "synthesize_max_abs_err_wav_vs_cpu": wav_err}
    finally:
        if ledger is not None:
            ledger.close()
        shutil.rmtree(root, ignore_errors=True)


def conformer_streaming(cfg):
    """configs/conformer.yaml with causal on both sides (module docstring,
    phase 14 f)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from audiotokenization_tpu_torch.cli import extract_indices, synthesize
    from audiotokenization_tpu_torch.config import codec_hop, save_config
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.models.streaming import (StreamingConformerSynthesizer,
                                                              StreamingConformerTokenizer,
                                                              stream_decode)

    causal = copy.deepcopy(cfg)
    causal.model.codec_encoder.causal = causal.model.codec_decoder.causal = True
    codec = seeded_codec(causal)
    hop = codec_hop(causal)
    streams = torch.from_numpy((np.random.RandomState(1).randn(STREAMS, STREAM_SECONDS * SR)
                                * 0.1).astype(np.float32)).cuda()
    with C.full_fp32(), torch.no_grad():
        lat = C.encode(codec, streams)
        _, off_codes, _ = C.quantize(codec, lat)
    gap = frame_gaps(codec, lat)
    tok = StreamingConformerTokenizer(codec, chunk_samples=STREAM_CHUNK)
    stream_tokens(codec, streams[:, :2 * STREAM_CHUNK], STREAM_CHUNK, timed=False, tok=tok)
    codes, launches, times = stream_tokens(codec, streams, STREAM_CHUNK, timed=True, tok=tok)
    if set(launches) != {(1, 0)}:
        fail(f"conformer streaming tokenizer: per-step launches {sorted(set(launches))}, "
             "expected K1 1 and K2 0 each step")
    differ, near = hold_codes("conformer streaming tokenizer vs offline", codes, off_codes, gap)
    lat_s = percentiles(times)
    out = {"stream_tokenize": {
        "streams": STREAMS, "seconds": STREAM_SECONDS, "chunk_samples": STREAM_CHUNK,
        "delay_frames": tok.delay_frames, **lat_s,
        "real_time_factor": STREAM_CHUNK / SR / (lat_s["p50_ms"] / 1e3),
        "launches_per_step": {"vq_argmin": launches[0][0], "residual_unit": launches[0][1]},
        "tokens_differ": differ, "near_ties": near}}

    want = offline_decode(codec, off_codes)[:, 0]
    got, launches = counted(lambda: stream_decode(codec, off_codes,
                                                  chunk_frames=SYNTH_CHUNK_FRAMES))
    expect_launches("conformer stream_decode", launches, (0, 0))
    err = hold_wav("conformer stream_decode vs offline decode", got, want)
    syn = StreamingConformerSynthesizer(codec, chunk_frames=SYNTH_CHUNK_FRAMES)
    lat_d = percentiles(synth_steps(codec, off_codes, SYNTH_CHUNK_FRAMES, syn=syn))
    out["stream_decode"] = {
        "chunk_frames": SYNTH_CHUNK_FRAMES, **lat_d,
        "real_time_factor": SYNTH_CHUNK_FRAMES * hop / SR / (lat_d["p50_ms"] / 1e3)}
    out["stream_decode_max_abs_err_wav_vs_offline"] = err

    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_conformer_causal_", dir=build_dir))
    try:
        (root / "run" / "ckpt" / "0").mkdir(parents=True)
        save_config(causal, root / "run" / "config.json")
        gen = C.init_codec(causal, generator=torch.Generator().manual_seed(0), device="cpu")
        torch.save({"step": 0, "gen": gen.state_dict()}, root / "run" / "ckpt" / "0" / "state.pt")
        wav, launches = counted(lambda: synthesize.main(
            ["--codec_ckpt", str(root / "run"), "--random", "--seconds", "1", "--num_samples",
             "4", "--streaming", str(SYNTH_CHUNK_FRAMES), "--out_dir", str(root / "synth")]))
        expect_launches("conformer synthesize --streaming", launches, (0, 0))
        tokens = torch.from_numpy(np.load(root / "synth" / "tokens.npy").astype(np.int64)).cuda()
        loaded = extract_indices.load_model(root / "run")[1]
        out["synthesize_streaming_max_abs_err_wav_vs_decode"] = hold_wav(
            "conformer synthesize --streaming vs decode", torch.from_numpy(wav).cuda(),
            synthesize.decode_tokens(loaded, tokens))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def conformer_path(card):
    """14. configs/conformer.yaml at full width and depth, random weights from
    seed 0 (module docstring). Prints the conformer line."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.models.conformer import conformer_encode

    cfg = repo_config("conformer.yaml")
    codec = seeded_codec(cfg)
    result = {"offline": offline_vs_cpu("conformer", cfg, codec)}
    wavs = [torch.from_numpy((np.random.RandomState(i).randn(B, SR) * 0.1).astype(np.float32))
            .cuda() for i in range(MODE_BATCHES)]
    ref_codes = [C.tokenize(codec, w) for w in wavs]
    codes = ref_codes[0]
    result["profile"] = {"tokenize": conformer_split(lambda: C.tokenize(codec, wavs[0])),
                         "decode": conformer_split(lambda: offline_decode(codec, codes))}
    print(json.dumps({"conformer_profile": result["profile"]}))

    # one long input against the CPU, and the attention against float64
    long_np = (np.random.RandomState(2).randn(LONG_REQUESTS, LONG_SECONDS * SR) * 0.1
               ).astype(np.float32)
    long = torch.from_numpy(long_np).cuda()
    long_codes, launches = counted(lambda: C.tokenize(codec, long))
    expect_launches("conformer long tokenize", launches, (1, 0))
    long_out = offline_decode(codec, long_codes)
    if not torch.isfinite(long_out).all() or tuple(long_out.shape) != (
            LONG_REQUESTS, 1, LONG_SECONDS * SR):
        fail(f"conformer long decode: {tuple(long_out.shape)}, finite "
             f"{bool(torch.isfinite(long_out).all())}")
    cmp = hold_against_cpu("conformer long input", codec, long_np, long_codes, long_out, n_ref=1)
    tok_ms = cuda_ms(lambda: C.tokenize(codec, long), iters=3, warmup=1)
    dec_ms = cuda_ms(lambda: offline_decode(codec, long_codes), iters=3, warmup=1)
    audio_s = LONG_REQUESTS * LONG_SECONDS
    result["long"] = {"requests": LONG_REQUESTS, "seconds": LONG_SECONDS,
                      "frames": int(long_codes.shape[-1]), "tokenize_ms": tok_ms,
                      "tokenize_audio_s_per_s": audio_s / (tok_ms / 1e3), "decode_ms": dec_ms,
                      "decode_audio_s_per_s": audio_s / (dec_ms / 1e3),
                      "launches_per_tokenize": {"vq_argmin": launches[0],
                                                "residual_unit": launches[1]}, **cmp}
    result["attention_vs_float64"] = {
        "main": hold_attention("conformer main path", *conformer_attention_inputs(codec, wavs[0])),
        "long": hold_attention("conformer long input", *conformer_attention_inputs(codec, long))}
    del long, long_out
    for seed in LONG_ATTENTION_SEEDS:  # more inputs at the long shape: the margin to the rule
        other = torch.from_numpy((np.random.RandomState(seed).randn(
            LONG_REQUESTS, LONG_SECONDS * SR) * 0.1).astype(np.float32)).cuda()
        result["attention_vs_float64"][f"long_seed{seed}"] = hold_attention(
            f"conformer long input, seed {seed}", *conformer_attention_inputs(codec, other),
            modes=False)

    with C.full_fp32(), torch.no_grad():
        ref_lat = [conformer_encode(codec.encoder, w[:, None]) for w in wavs]
    result["modes"] = conformer_modes(codec, wavs, ref_codes, ref_lat)
    result["ragged"] = conformer_ragged(cfg, codec)
    result["extract"] = conformer_extract(cfg)
    del codec
    result.update(conformer_streaming(cfg))
    off = result["offline"]
    line = {
        "tokenize_audio_s_per_s": off["tokenize_audio_s_per_s"],
        "decode_audio_s_per_s": off["decode_audio_s_per_s"],
        "attention_route": {m: result["attention_vs_float64"]["main"][m]["backend"]
                         for m in ("conformant", "high", "fast")},
        "stream_p50_ms": result["stream_tokenize"]["p50_ms"],
        "stream_p99_ms": result["stream_tokenize"]["p99_ms"],
        "launches": {
            "tokenize": off["launches_per_tokenize"],
            "long_tokenize": result["long"]["launches_per_tokenize"],
            "modes_per_call": {m: result["modes"][m]["launches"] for m in CONFORMER_MODE_LAT_REL},
            "ragged_per_call": result["ragged"]["tokenizer"]["launches_per_call"],
            "ragged_codec_per_call": result["ragged"]["codec"]["launches_per_call"],
            "extract_per_batch": result["extract"]["launches_per_batch"],
            "stream_per_step": result["stream_tokenize"]["launches_per_step"]},
        **result}
    print(json.dumps({"conformer": line, "card": card}))
    return line


# -- 15. configs/conformer_moe.yaml and configs/bigcodec_fsq.yaml ---------------------

MOE_EXTRACT_FILES, MOE_HOLD_FILES, MOE_EVAL_FILES = 16, 4, 4
RAGGED_FILES, QUANTIZER_EXTRACT_FILES = 8, 16  # the FSQ and EMA BigCodecs' ragged and CLI runs


class RouteRecorder:
    """While open, keeps the routing of every MoE layer call
    (``ops.moe.route``), in call order (the encoder's layers, ffn1 then
    ffn2 of each)."""

    def __enter__(self):
        from audiotokenization_tpu_torch.ops import moe

        self.moe, self.orig, self.routes = moe, moe.route, []

        def recorded(*args, **kwargs):
            r = self.orig(*args, **kwargs)
            self.routes.append(r)
            return r

        moe.route = recorded
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig


def routing_differences(name, card_routes, cpu_routes, frames: int, *, strict: bool = True):
    """Layer by layer, the tokens whose expert choice (or its order) or
    kept/dropped status differs between two runs of one batch, with the
    reference's smallest gap between neighbouring probabilities among the
    first top_k + 1. With ``strict`` a choice that differs at a gap of GAP
    or more, in a request (``frames`` tokens) no earlier difference reached,
    is fatal; a kept-only difference always follows an earlier claim that
    differs (capacity is claimed in order), and every difference reaches its
    request for the later layers. Returns (rows, the requests reached)."""
    import torch

    reached, rows = set(), []
    for layer, (g, c) in enumerate(zip(card_routes, cpu_routes)):
        ge, gk = g.experts.cpu(), g.keep.cpu()
        ce, ck, k = c.experts.cpu(), c.keep.cpu(), c.experts.shape[1]
        p = torch.sort(c.probs.cpu(), dim=-1, descending=True).values[:, :k + 1]
        gap = (p[:, :-1] - p[:, 1:]).amin(-1)
        choice = (ge != ce).any(-1)
        kept = (gk != ck).any(-1) & ~choice
        req = torch.arange(len(ge)) // frames
        fresh = torch.tensor([int(r) not in reached for r in req])
        if strict and (choice & (gap >= GAP) & fresh).any():
            fail(f"{name}: layer {layer}: {int((choice & (gap >= GAP) & fresh).sum())} tokens "
                 f"route to other experts at a router gap >= {GAP:g}")
        if strict and choice.any():
            print(f"{name}: layer {layer}: {int(choice.sum())} tokens route differently "
                  f"(router gap {float(gap[choice].min()):.3g} at the least), "
                  f"{int(kept.sum())} more kept/dropped differently")
        rows.append({"layer": layer, "choice_differs": int(choice.sum()),
                     "kept_differs": int(kept.sum()), "min_router_gap": float(gap.min()),
                     "tokens_under_gap": int((gap < GAP).sum()),
                     "dropped_frac": float(1 - gk.float().mean()),
                     "dropped_frac_ref": float(1 - ck.float().mean())})
        reached |= {int(r) for r in req[choice | kept]}
    return rows, reached


def moe_vs_cpu(name, codec, wav_np, codes, out, n_ref: int = 2):
    """The MoE Conformer's tokens ``codes`` and waveforms ``out`` of
    ``wav_np`` against the CPU: the whole batch encoded on both (expert
    capacity is batch-global), the routing compared layer by layer
    (``routing_differences``), then the first ``n_ref`` requests' tokens
    (but at top-2 gaps under GAP) and latents where no routing difference
    reached the request, and their waveforms (the decoder is dense)."""
    import torch
    from audiotokenization_tpu_torch.models import codec as C

    cpu = copy.deepcopy(codec).cpu()
    frames = wav_np.shape[1] // HOP
    t0 = time.perf_counter()
    with C.full_fp32(), torch.no_grad():
        with RouteRecorder() as on_card:
            lat_gpu = C.encode(codec, torch.from_numpy(wav_np).cuda())[:n_ref].cpu()
        with RouteRecorder() as on_cpu:
            lat_cpu = C.encode(cpu, torch.from_numpy(wav_np))[:n_ref]
        _, codes_cpu, _ = C.quantize(cpu, lat_cpu)
    cpu_s = time.perf_counter() - t0
    layers, reached = routing_differences(name, on_card.routes, on_cpu.routes, frames)
    ref = [i for i in range(n_ref) if i not in reached]
    flips = near = 0
    lat_err = 0.0
    if ref:
        gap = frame_gaps(cpu, lat_cpu[ref])
        flips, near = hold_codes(f"{name} tokens", codes[:, ref].cpu(), codes_cpu[:, ref], gap)
        lat_err = (lat_gpu[ref] - lat_cpu[ref]).abs().max().item()
        if not torch.allclose(lat_gpu[ref], lat_cpu[ref], rtol=LAT_RTOL, atol=LAT_ATOL):
            fail(f"{name}: latents outside rtol 1e-3 / atol 2e-4 of the CPU")
    wav_cpu = offline_decode(cpu, codes[:, :n_ref].cpu())
    wav_err = (out[:n_ref].cpu() - wav_cpu).abs().max().item()
    if not torch.allclose(out[:n_ref].cpu(), wav_cpu, rtol=WAV_RTOL, atol=WAV_ATOL):
        fail(f"{name}: waveforms outside rtol 1e-3 / atol 2e-5 of the CPU's decode")
    dropped = [r["dropped_frac"] for r in layers]
    print(f"{name} vs CPU: {len(reached)} of {wav_np.shape[0]} requests reached by a routing "
          f"difference; of the first {n_ref}, {len(ref)} compared: {flips} tokens differ, "
          f"{near} frames under the {GAP:g} gap; max |dlatent| {lat_err:.3g}, "
          f"max |dwav| {wav_err:.3g}")
    return {"requests_reached_by_routing": len(reached), "requests_compared": len(ref),
            "token_flips": flips, "near_ties": near, "max_abs_err_latent": lat_err,
            "max_abs_err_wav": wav_err, "cpu_s": cpu_s,
            "routing_differs": sum(r["choice_differs"] + r["kept_differs"] for r in layers),
            "min_router_gap": min(r["min_router_gap"] for r in layers),
            "dropped_frac_encoder": sum(dropped) / len(dropped),
            "dropped_frac_per_layer": dropped, "dropped_frac_decoder": None}


def annotated(patches):
    """Context: each (module, function name) of ``patches`` wrapped in a
    torch.profiler range of its name, restored after."""
    import contextlib

    import torch

    @contextlib.contextmanager
    def ctx():
        orig = [(m, n, getattr(m, n)) for m, n in patches]

        def wrap(n, fn):
            def inner(*args, **kwargs):
                with torch.profiler.record_function(f"cs.{n}"):
                    return fn(*args, **kwargs)
            return inner

        for m, n, fn in orig:
            setattr(m, n, wrap(n, fn))
        try:
            yield
        finally:
            for m, n, fn in orig:
                setattr(m, n, fn)

    return ctx()


def moe_split(fn):
    """torch.profiler split of one call of ``fn`` on the MoE Conformer:
    device ms of the router, dispatch, expert GEMMs and combine (the
    ops.moe functions), of attention (ops.transformer.attend), of the other
    GEMM kernels and of K1; busy time and the idle share of the call's
    wall time."""
    import torch
    from audiotokenization_tpu_torch.ops import moe, transformer
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    parts = ("route", "dispatch", "experts_apply", "combine", "attend")
    with annotated([(moe, n) for n in parts[:4]] + [(transformer, "attend")]):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    # the ranges' own spans on the device timeline are not kernels: left out
    dev = [(e.name, e.time_range.start, e.time_range.end) for e in events
           if e.device_type == DeviceType.CUDA and not e.name.startswith("cs.")]

    def kernels_under(e):
        out = [(k.name, k.duration) for k in getattr(e, "kernels", [])]
        for c in e.cpu_children:
            out += kernels_under(c)
        return out

    split, ranged_gemm = {}, 0.0
    for n in parts:
        ks = [k for e in events if e.name == f"cs.{n}" for k in kernels_under(e)]
        split[f"{n}_ms"] = sum(d for _, d in ks) / 1e3
        ranged_gemm += sum(d for name, d in ks if "gemm" in name.lower() or "xmma" in name.lower())
    gemm = _busy_ms([e for e in dev if "gemm" in e[0].lower() or "xmma" in e[0].lower()])
    busy = _busy_ms(dev)
    by_name: dict = {}
    for n, start, stop in dev:
        ms, count = by_name.get(n[:80], (0.0, 0))
        by_name[n[:80]] = (ms + (stop - start) / 1e3, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy, **split,
            "other_gemm_ms": max(gemm - ranged_gemm / 1e3, 0.0),
            "k1_ms": _busy_ms([e for e in dev if "vq_argmin" in e[0]]),
            "idle_share": 1 - busy / wall_ms, "device_kernels": len(dev),
            "top_kernels": [{"name": n, "ms": ms, "count": c} for n, (ms, c) in top]}


def mode_rows(name, codec, wavs, limits, want, *, routed: bool = False):
    """Each tokenize mode of ``limits`` on ``wavs`` (B x 1 s batches)
    against conformant: launches of the first call (``want``), audio-s/s,
    token flips and codes used over the batches, and the latents' max |d|
    / max |latent|, fatal over the mode's limit. ``routed`` (an MoE
    encoder): routing differences against conformant are counted, and the
    latent error is taken over the requests no routing difference reached
    (the rest counted); ``balanced``, which the Conformer lacks, must raise."""
    import torch
    from audiotokenization_tpu_torch.models import codec as C

    def run(w, mode):
        with RouteRecorder() as rec:
            lat = C.encode_in_mode(codec.encoder, w[:, None], mode)
        with C.full_fp32(), torch.no_grad():
            codes = C.quantize(codec, lat)[1]
        return lat, codes, rec.routes

    refs = [run(w, "conformant") for w in wavs]
    rows = {}
    for mode, limit in limits.items():
        _, launches = counted(lambda: C.tokenize(codec, wavs[0], mode=mode))
        expect_launches(f"{name} tokenize mode {mode}", launches, want)
        flips, used, lat_rel, lat_rel_all, reached_n = 0, set(), 0.0, 0.0, 0
        for w, (ref_lat, ref_codes, ref_routes) in zip(wavs, refs):
            lat, codes, routes = run(w, mode)
            flips += int((codes != ref_codes).sum())
            used |= set(torch.unique(codes).tolist())
            lat_rel_all = max(lat_rel_all, ((lat - ref_lat).abs().max()
                                            / ref_lat.abs().max()).item())
            keep = list(range(w.shape[0]))
            if routed:
                _, reached = routing_differences(f"{name} {mode}", routes, ref_routes,
                                                 w.shape[1] // HOP, strict=False)
                keep = [i for i in keep if i not in reached]
                reached_n += len(reached)
            if keep:
                lat_rel = max(lat_rel, ((lat[keep] - ref_lat[keep]).abs().max()
                                        / ref_lat[keep].abs().max()).item())
        if not lat_rel <= limit:
            fail(f"{name} tokenize mode {mode}: max |dlatent| / max |latent| = {lat_rel:.3g} "
                 f"against conformant, over {limit:g}")
        ms = cuda_ms(lambda: C.tokenize(codec, wavs[0], mode=mode), iters=3)
        tokens = sum(int(c.numel()) for _, c, _ in refs)
        rows[mode] = {"ms": ms, "audio_s_per_s": wavs[0].shape[0] / (ms / 1e3),
                      "launches": {"vq_argmin": launches[0], "residual_unit": launches[1]},
                      "token_flips": flips, "tokens": tokens, "flip_rate": flips / tokens,
                      "codes_used": len(used), "max_abs_dlatent_over_max_latent": lat_rel,
                      **({"requests_reached_by_routing": reached_n,
                          "requests": len(wavs) * wavs[0].shape[0],
                          "max_abs_dlatent_over_max_latent_all_requests": lat_rel_all}
                         if routed else {})}
        print(json.dumps({f"{name}_mode": {"mode": mode, **rows[mode]}}))
    if routed:
        try:
            C.tokenize(codec, wavs[0], mode="balanced")
        except ValueError as e:
            rows["balanced"] = f"raises ValueError: {e}"
        else:
            fail(f"{name} tokenize mode balanced did not raise")
    return rows


def write_gen_run(run: Path, cfg):
    """A generator-only port run dir of ``cfg``, random weights from seed 0
    (scripts/jax_run_to_torch.py's form); returns its codec on the CPU."""
    import torch
    from audiotokenization_tpu_torch.cli import extract_indices
    from audiotokenization_tpu_torch.config import save_config
    from audiotokenization_tpu_torch.models import codec as C

    (run / "ckpt" / "0").mkdir(parents=True)
    save_config(cfg, run / "config.json")
    gen = C.init_codec(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    torch.save({"step": 0, "gen": gen.state_dict()}, run / "ckpt" / "0" / "state.pt")
    return extract_indices.load_model(run, device="cpu")[1]


def moe_offline(cfg):
    """15d: from an MoE run dir, cli.extract_indices at batch EXTRACT_BATCH
    (the per-file route: K1 once a file, ceil(len / hop) int16 frames, the
    first MOE_HOLD_FILES files equal to the card's own tokenize of each and
    to the CPU's where no routing difference reached them),
    make_ragged_tokenizer refusing, cli.inference_full on whole files
    (per file, K1 once a file)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from audiotokenization_tpu_torch.cli import extract_indices, inference_full
    from audiotokenization_tpu_torch.data.audio_io import read_audio
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.ops.resample import resample
    from audiotokenization_tpu_torch.utils.ragged import make_ragged_tokenizer

    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_moe_", dir=build_dir))
    try:
        files = write_extract_corpus(root, MOE_EXTRACT_FILES)
        run = root / "run"
        codec_cpu = write_gen_run(run, cfg)
        counts, launches = counted(lambda: extract_indices.main(
            ["--dataset_root", str(root), "--save_path", str(run), "--dataset_path",
             "LibriSpeech", "--ext_audio", ".wav", "--subsets", "test-clean",
             "--batch_size", str(EXTRACT_BATCH)]))
        if counts["saved"] != MOE_EXTRACT_FILES or counts["errors"] \
                or counts["device_batches"] != MOE_EXTRACT_FILES:
            fail(f"MoE extraction: {counts['saved']} saved, {counts['errors']} errors, "
                 f"{counts['device_batches']} device calls for {MOE_EXTRACT_FILES} files")
        expect_launches("MoE extraction (one tokenize a file)", launches,
                        (MOE_EXTRACT_FILES, 0))
        npys = {p.stem: p for p in (run / "extracted_indices").rglob("*.npy")}
        for path, rate, n in files:
            a = np.load(npys[path.stem])
            if a.dtype != np.int16 or a.shape != (ceil_div(ceil_div(n * SR, rate), HOP),):
                fail(f"MoE extraction {path.name}: {a.dtype} {a.shape}")
        codec = extract_indices.load_model(run)[1]
        flips = near = reached_n = 0
        for path, rate, _ in files[:MOE_HOLD_FILES]:
            wav, r = read_audio(path)
            wav = wav[0] if r == SR else resample(torch.from_numpy(wav[0]), r, SR).numpy()
            wav = np.pad(wav, (0, -len(wav) % HOP)).astype(np.float32)[None]
            with C.full_fp32(), torch.no_grad():
                with RouteRecorder() as on_card:
                    lat = C.encode(codec, torch.from_numpy(wav).cuda())
                    own = C.quantize(codec, lat)[1][0, 0].cpu().numpy()
                with RouteRecorder() as on_cpu:
                    lat_cpu = C.encode(codec_cpu, torch.from_numpy(wav))
                    want = C.quantize(codec_cpu, lat_cpu)[1][0, 0].numpy()
            if not np.array_equal(np.load(npys[path.stem]), own):
                fail(f"MoE extraction {path.name}: the file differs from the card's tokenize")
            _, reached = routing_differences(f"MoE extraction {path.name}", on_card.routes,
                                             on_cpu.routes, wav.shape[1] // HOP)
            if reached:
                reached_n += 1
                continue
            f, m = hold_tokens(f"MoE extraction {path.name}", own, want,
                               frame_gaps(codec_cpu, lat_cpu)[0].numpy())
            flips, near = flips + f, near + m
        try:
            make_ragged_tokenizer(cfg)
        except NotImplementedError as e:
            ragged = f"raises NotImplementedError: {e}"
        else:
            fail("make_ragged_tokenizer took an MoE Conformer")
        (root / "eval.txt").write_text("\n".join(str(p) for p, _, _ in files[:MOE_EVAL_FILES]))
        summary, eval_launches = counted(lambda: inference_full.main(
            ["--save_path", str(run), "--filelist", str(root / "eval.txt"), "--duration", "0",
             "--batch_size", str(MOE_EVAL_FILES), "--num_examples", "0"]))
        expect_launches("MoE inference_full (one forward a file)", eval_launches,
                        (MOE_EVAL_FILES, 0))
        if not (np.isfinite(summary["si_snr"]) and np.isfinite(summary["stoi"])):
            fail(f"MoE inference_full: {summary}")
        return {"files": MOE_EXTRACT_FILES, "batch_size": EXTRACT_BATCH,
                **{k: counts[k] for k in ("audio_seconds", "audio_s_per_s", "device_batches",
                                          "device_s")},
                "launches": {"vq_argmin": launches[0], "residual_unit": launches[1]},
                "launches_per_file": {"vq_argmin": 1, "residual_unit": 0},
                "tokens_differ_vs_cpu": flips, "near_ties": near,
                "files_reached_by_routing": reached_n, "ragged_tokenizer": ragged,
                "eval": {k: summary[k] for k in ("si_snr", "stoi", "frames", "audio_s_per_s")}}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def timed_training(name, cfg, card, want, teacher=None, split=None):
    """A bf16 training step of ``cfg`` at B x 1 s: 2 warm-ups, TRAIN_STEPS
    timed (CUDA events) with K1 / K2 launches ``want`` a step, finite losses,
    fp32 masters, every MoE router moved; audio-s/s and peak memory.
    ``teacher`` (on the card): a semantic codec's, run in the step on the
    batch's features (the loader's numpy ones), unchanged after. ``split``:
    a profiler split (``semantic_split``) of one more step, after the checks."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.ops.moe import MoEFeedForward
    from audiotokenization_tpu_torch.train.state import init_train_state
    from audiotokenization_tpu_torch.train.step import make_train_step

    state = init_train_state(cfg, generator=torch.Generator().manual_seed(0))
    routers = {n: m.router.w.detach().clone() for n, m in state.gen.named_modules()
               if isinstance(m, MoEFeedForward)}
    ema = {n: b.clone() for n, b in state.gen.quantizer.named_buffers()}
    step = make_train_step(cfg)
    wav_np = (np.random.RandomState(2).randn(B, SR) * 0.1).astype(np.float32)
    wav = torch.from_numpy(wav_np).cuda()
    extra = None
    if teacher is not None:
        from audiotokenization_tpu_torch.ops.fbank import w2v_bert_features_from_clip

        extra = {"feats": torch.from_numpy(
            np.stack([w2v_bert_features_from_clip(w) for w in wav_np])).cuda()}
        teacher_before = {k: v.cpu() for k, v in teacher.state_dict().items()}  # off the card
    for _ in range(TRAIN_WARMUP):
        step(state, {"wav": wav, **(extra or {})}, teacher)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (ms, metrics), launches = counted(lambda: timed_steps(step, state, wav, teacher, extra))
    if teacher is not None and any(not torch.equal(v.cpu(), teacher_before[k])
                                   for k, v in teacher.state_dict().items()):
        fail(f"{name} training: the teacher changed")
    per_step = (launches[0] / TRAIN_STEPS, launches[1] / TRAIN_STEPS)
    expect_launches(f"{name} training step", per_step, want)
    last = {k: float(v) for k, v in metrics.items() if k != "codebook_hist"}
    bad = [k for k, v in last.items() if not np.isfinite(v)]
    if bad:
        fail(f"{name} training: non-finite metrics {bad}")
    if {p.dtype for p in state.gen.parameters()} != {torch.float32}:
        fail(f"{name} training: the master parameters are not fp32")
    modules = dict(state.gen.named_modules())
    still = [n for n, w in routers.items() if torch.equal(modules[n].router.w.detach(), w)]
    if still:
        fail(f"{name} training: routers that did not move: {still}")
    now = dict(state.gen.quantizer.named_buffers())
    if ema and (torch.equal(now["embed"], ema["embed"])
                or not all(torch.isfinite(b).all() for b in now.values())):
        fail(f"{name} training: the EMA codebook did not move or is not finite")
    out = {"ms_per_step": ms, "audio_s_per_s": B / (ms / 1e3),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_per_step": {"vq_argmin": per_step[0], "residual_unit": per_step[1]},
           "routers_moved": len(routers), "ema_buffers_moved": sorted(
               n for n, b in ema.items() if not torch.equal(now[n], b)),
           "precision": cfg.train.precision,
           "steps_timed": TRAIN_STEPS, "metrics": last}
    if split is not None:
        out["profile"] = split(lambda: step(state, {"wav": wav, **(extra or {})}, teacher))
    print(json.dumps({f"{name}_train_step": out, "card": card}))
    return out


def moe_path(card):
    """15a-e. configs/conformer_moe.yaml at full width and depth, random
    weights from seed 0 (module docstring). Prints the conformer_moe line."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.models import codec as C

    cfg = repo_config("conformer_moe.yaml")
    codec = seeded_codec(cfg)
    t0 = time.perf_counter()
    wav_np = (np.random.RandomState(0).randn(B, SR) * 0.1).astype(np.float32)
    wav = torch.from_numpy(wav_np).cuda()
    codes, tok = counted(lambda: C.tokenize(codec, wav))
    out, dec = counted(lambda: offline_decode(codec, codes))
    expect_launches("MoE tokenize", tok, (1, 0))
    expect_launches("MoE decode", dec, (0, 0))
    if tuple(codes.shape) != (1, B, SR // HOP) or tuple(out.shape) != (B, 1, SR) \
            or not torch.isfinite(out).all():
        fail(f"MoE: codes {tuple(codes.shape)}, waveform {tuple(out.shape)}")
    result = {"offline": moe_vs_cpu("MoE main path", codec, wav_np, codes, out)}
    tok_ms = cuda_ms(lambda: C.tokenize(codec, wav), iters=5)
    dec_ms = cuda_ms(lambda: offline_decode(codec, codes), iters=5)
    result["offline"].update(
        tokenize_ms=tok_ms, tokenize_audio_s_per_s=B / (tok_ms / 1e3), decode_ms=dec_ms,
        decode_audio_s_per_s=B / (dec_ms / 1e3),
        launches_per_tokenize={"vq_argmin": tok[0], "residual_unit": tok[1]})
    result["profile"] = {"tokenize": moe_split(lambda: C.tokenize(codec, wav)),
                         "decode": moe_split(lambda: offline_decode(codec, codes))}
    print(json.dumps({"conformer_moe_profile": result["profile"]}))
    result["phase_s"] = {"a": time.perf_counter() - t0}

    t0 = time.perf_counter()  # 15b: one long input
    long_np = (np.random.RandomState(2).randn(LONG_REQUESTS, LONG_SECONDS * SR) * 0.1
               ).astype(np.float32)
    long = torch.from_numpy(long_np).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    long_codes, launches = counted(lambda: C.tokenize(codec, long))
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    expect_launches("MoE long tokenize", launches, (1, 0))
    long_out = offline_decode(codec, long_codes[:, :1])
    cmp = moe_vs_cpu("MoE long input", codec, long_np, long_codes, long_out, n_ref=1)
    ms = cuda_ms(lambda: C.tokenize(codec, long), iters=3, warmup=1)
    result["long"] = {"requests": LONG_REQUESTS, "seconds": LONG_SECONDS,
                      "frames": int(long_codes.shape[-1]), "tokenize_ms": ms,
                      "tokenize_audio_s_per_s": LONG_REQUESTS * LONG_SECONDS / (ms / 1e3),
                      "tokenize_peak_memory_gb_over_weights": peak,
                      "launches_per_tokenize": {"vq_argmin": launches[0],
                                                "residual_unit": launches[1]}, **cmp}
    print(f"MoE long input: {ms:.1f} ms a tokenize, peak {peak:.2f} GB over the weights")
    del long, long_out
    result["phase_s"]["b"] = time.perf_counter() - t0

    t0 = time.perf_counter()  # 15c: the modes
    wavs = [wav] + [torch.from_numpy((np.random.RandomState(i).randn(B, SR) * 0.1)
                                     .astype(np.float32)).cuda() for i in range(1, MODE_BATCHES)]
    result["modes"] = mode_rows("conformer_moe", codec, wavs, CONFORMER_MODE_LAT_REL, (1, 0),
                                routed=True)
    del codec
    result["phase_s"]["c"] = time.perf_counter() - t0

    t0 = time.perf_counter()  # 15d: offline from a run dir
    result["offline_cli"] = moe_offline(cfg)
    result["phase_s"]["d"] = time.perf_counter() - t0

    t0 = time.perf_counter()  # 15e: training
    result["step_vs_cpu"] = train_step_vs_cpu(cfg, line="moe_train_step_vs_cpu")
    result["train"] = {"conformer_moe": timed_training("conformer_moe", cfg, card, (1, 0)),
                       "conformer": timed_training("conformer", repo_config("conformer.yaml"),
                                                   card, (1, 0))}
    result["phase_s"]["e"] = time.perf_counter() - t0
    off = result["offline"]
    line = {"tokenize_audio_s_per_s": off["tokenize_audio_s_per_s"],
            "decode_audio_s_per_s": off["decode_audio_s_per_s"],
            "dropped_frac_encoder": off["dropped_frac_encoder"],
            "launches": {
                "tokenize": off["launches_per_tokenize"],
                "long_tokenize": result["long"]["launches_per_tokenize"],
                "modes_per_call": {m: result["modes"][m]["launches"]
                                   for m in CONFORMER_MODE_LAT_REL},
                "extract_per_file": result["offline_cli"]["launches_per_file"],
                "train_per_step": result["train"]["conformer_moe"]["launches_per_step"]},
            **result}
    print(json.dumps({"conformer_moe": line, "card": card}))
    return line


def fsq_bounded_vs_cpu(codec, wav_np):
    """The values FSQ rounds (project_in, then the shifted tanh) of
    ``wav_np`` on the card against the CPU's: fatal outside the latents'
    tolerance (LAT_RTOL / LAT_ATOL); with their spread, since on random
    weights every frame may take one code and the tokens then say little."""
    import torch
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.models.quantizers import fsq
    from audiotokenization_tpu_torch.ops.conv import linear

    def bounded(c, w):
        with C.full_fp32(), torch.no_grad():
            z = linear(C.encode(c, w).transpose(1, 2), c.quantizer.project_in)
            return fsq.fsq_bounded(z, c.quantizer.levels).cpu()

    got = bounded(codec, torch.from_numpy(wav_np).cuda())
    want = bounded(copy.deepcopy(codec).cpu(), torch.from_numpy(wav_np))
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=LAT_RTOL, atol=LAT_ATOL):
        fail(f"FSQ bounded values outside rtol 1e-3 / atol 2e-4 of the CPU (max |d| {err:.3g})")
    out = {"max_abs_err": err, "min": want.amin((0, 1)).tolist(),
           "max": want.amax((0, 1)).tolist(), "std": want.std((0, 1)).tolist()}
    print(f"FSQ bounded values vs CPU: max |d| {err:.3g}; per dim min {out['min']}, "
          f"max {out['max']}")
    return out


def ragged_and_extract(name, cfg, codec, n_units, write_run):
    """make_ragged_tokenizer on RAGGED_FILES files of 0.7-6.3 s against
    each file's own tokenize (but at frames under GAP, ``frame_gaps``), and
    cli.extract_indices at batch EXTRACT_BATCH on QUANTIZER_EXTRACT_FILES
    files from the run dir ``write_run(run)`` writes (it returns the run
    dir's CPU codec): int16 in [0, codebook_size), ceil(len / hop) frames,
    K1 0 / K2 n_units a device batch, 4 files against the CPU. For the
    BigCodecs without K1 (FSQ, the EMA VQ)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from audiotokenization_tpu_torch.cli import extract_indices
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.utils import ragged
    from audiotokenization_tpu_torch.utils.ragged import make_ragged_tokenizer

    out = {}
    lens = [int(sec * SR) // HOP * HOP for sec in np.linspace(0.7, 6.3, RAGGED_FILES)]
    rng = np.random.RandomState(6)
    batch = np.zeros((len(lens), max(lens)), np.float32)
    for i, n in enumerate(lens):
        batch[i, :n] = rng.randn(n) * 0.1
    batch_t = torch.from_numpy(batch).cuda()
    rcodes, launches = counted(lambda: make_ragged_tokenizer(cfg)(
        codec, batch_t, torch.tensor(lens).cuda()))
    expect_launches(f"{name} ragged tokenizer", launches, (0, n_units))
    differ = near = 0
    for i, n in enumerate(lens):
        with C.full_fp32(), torch.no_grad():
            lat = C.encode(codec, batch_t[i:i + 1, :n])
            own = C.quantize(codec, lat)[1]
        f, m = hold_codes(f"{name} ragged row {i} vs its own tokenize",
                          rcodes[:, i:i + 1, :n // HOP], own, frame_gaps(codec, lat))
        differ, near = differ + f, near + m
    out["ragged"] = {"files": len(lens), "tokens_differ": differ, "near_ties": near,
                     "launches_per_call": {"vq_argmin": launches[0],
                                           "residual_unit": launches[1]}}

    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix=f"chip_smoke_{name.lower()}_", dir=build_dir))
    ledger = None
    try:
        files = write_extract_corpus(root, QUANTIZER_EXTRACT_FILES)
        run = root / "run"
        codec_cpu = write_run(run)
        ledger = LaunchLedger({"batch": (ragged, "make_ragged_tokenizer")})
        counts, launches = counted(lambda: extract_indices.main(
            ["--dataset_root", str(root), "--save_path", str(run), "--dataset_path",
             "LibriSpeech", "--ext_audio", ".wav", "--subsets", "test-clean",
             "--batch_size", str(EXTRACT_BATCH)]))
        ledger.close()
        calls = ledger.calls["batch"]
        if counts["saved"] != QUANTIZER_EXTRACT_FILES or counts["errors"] \
                or set(calls) != {(0, n_units)} or tuple(launches) != (0, n_units * len(calls)):
            fail(f"{name} extraction: {counts['saved']} saved, {counts['errors']} errors, "
                 f"launches {launches} over batches {calls}")
        npys = {p.stem: p for p in (run / "extracted_indices").rglob("*.npy")}
        codebook = cfg.model.codec_decoder.codebook_size
        for path, rate, n in files:
            a = np.load(npys[path.stem])
            if a.dtype != np.int16 or a.shape != (ceil_div(ceil_div(n * SR, rate), HOP),) \
                    or a.min() < 0 or a.max() >= codebook:
                fail(f"{name} extraction {path.name}: {a.dtype} {a.shape} in {a.min()}..{a.max()}")
        flips = near_x = 0
        for path, _, _ in files[:4]:
            want, gap = cpu_tokens(codec_cpu, path, hop_pad=True)
            f, m = hold_tokens(f"{name} extraction of {path.name}", np.load(npys[path.stem]),
                               want, gap)
            flips, near_x = flips + f, near_x + m
        out["extract"] = {"files": QUANTIZER_EXTRACT_FILES, "batch_size": EXTRACT_BATCH,
                          **{k: counts[k] for k in ("audio_seconds", "audio_s_per_s",
                                                    "device_batches", "device_s")},
                          "launches_per_batch": {"vq_argmin": calls[0][0],
                                                 "residual_unit": calls[0][1]},
                          "tokens_differ_vs_cpu": flips, "near_ties": near_x}
    finally:
        if ledger is not None:
            ledger.close()
        shutil.rmtree(root, ignore_errors=True)
    return out


def fsq_path(card):
    """15f. configs/bigcodec_fsq.yaml at full width, random weights from
    seed 0 (module docstring). Prints the bigcodec_fsq line."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    cfg = repo_config("bigcodec_fsq.yaml")
    codec = seeded_codec(cfg)
    n_units = len(cfg.model.codec_encoder.up_ratios) * len(cfg.model.codec_encoder.dilations)
    wav_np = (np.random.RandomState(0).randn(B, SR) * 0.1).astype(np.float32)
    result = {}
    result["offline"], _ = offline_rows("FSQ", codec, wav_np, n_units,
                                        cfg.model.codec_decoder.codebook_size)
    result["offline"]["bounded"] = fsq_bounded_vs_cpu(codec, wav_np[:2])
    wavs = [torch.from_numpy((np.random.RandomState(i).randn(B, SR) * 0.1).astype(np.float32))
            .cuda() for i in range(MODE_BATCHES)]
    result["modes"] = mode_rows("bigcodec_fsq", codec, wavs,
                                {m: MODE_LAT_REL[m] for m in ("high", "fast")}, (0, n_units))
    result.update(ragged_and_extract("FSQ", cfg, codec, n_units,
                                     lambda run: write_gen_run(run, cfg)))
    del codec, wavs
    result["train"] = timed_training("bigcodec_fsq", cfg, card, (0, 2 * n_units))
    result["phase_s"] = time.perf_counter() - t0
    line = quantizer_line(result)
    print(json.dumps({"bigcodec_fsq": line, "card": card}))
    return line


# ---------------------------------------------------------------------------
# Phase 16: the quantizer zoo
# ---------------------------------------------------------------------------

LFQ_BITS = 13              # the LFQ bottleneck: 2^13 = 8192 codes, the flagship VQ's count
EMA_CALIB_BATCHES = 6      # B x 1 s noise batches whose frames seed the EMA codebook
EMA_RTOL, EMA_ATOL = 1e-4, 1e-5   # the EMA buffers after a step, card against CPU
EMA_THRESHOLD = 2.0        # the codec's dead-code threshold (models/codec.py: JAX's default)
ZOO_M = 2560               # positions of the library quantizers' inputs (K1's flagship M)


def zoo_config(kind: str, *, cosine: bool = False):
    """Config() with ``quantizer: ema_vq`` (8192 codes of 1024 dims; the
    cosine codebook with ``cosine``) or ``lfq`` (a 13-bit bottleneck:
    encoder out_channels = decoder in_channels = 13, 8192 implicit codes);
    every other field the flagship's."""
    from audiotokenization_tpu_torch.config import Config

    cfg = Config()
    d = cfg.model.codec_decoder
    d.quantizer = kind
    if kind == "ema_vq":
        d.vq_cosine_sim = cosine
    else:
        d.in_channels = cfg.model.codec_encoder.out_channels = LFQ_BITS
        d.codebook_size = 2 ** LFQ_BITS
    return cfg


def ema_margins(flat, embed, cosine: bool):
    """Each row's top-2 distance gap to ``embed`` over |x|² + |e_best|² (the
    EMA distance |x|² - 2x·e + |e|² cancels to that scale; 2 for the cosine
    codebook's unit vectors), fp32 with TF32 off."""
    import torch
    from audiotokenization_tpu_torch.models import codec as C

    with C.full_fp32(), torch.no_grad():
        x = flat.float()
        if cosine:
            x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-12)
            dist = -(x @ embed.T)
        else:
            dist = (x * x).sum(1, keepdim=True) - 2 * x @ embed.T + (embed * embed).sum(1)[None]
        v, i = dist.topk(2, dim=1, largest=False)
        scale = (x * x).sum(1) + (embed[i[:, 0]] ** 2).sum(1)
        return (v[:, 1] - v[:, 0]) / scale


def spread_ema(codec):
    """The EMA codebook (``embed``, ``embed_avg``) set to frames of the
    codec's own latents on seeded noise (8192 of the 9600 frames of
    EMA_CALIB_BATCHES batches of B x 1 s; unit-norm for the cosine
    codebook), as a kmeans init from data would seed it: at its N(0, 1)
    init every frame takes the same code. In place; returns the codec."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.models import codec as C

    q = codec.quantizer
    with C.full_fp32(), torch.no_grad():
        lat = torch.cat([C.encode(codec, torch.from_numpy(
            (np.random.RandomState(100 + i).randn(B, SR) * 0.1).astype(np.float32)).cuda())
            .transpose(1, 2).reshape(-1, q.embed.shape[1]) for i in range(EMA_CALIB_BATCHES)])
        rows = lat[torch.randperm(lat.shape[0], generator=torch.Generator().manual_seed(0))
                   [:q.embed.shape[0]].cuda()]
        if codec.cfg.model.codec_decoder.vq_cosine_sim:
            rows = rows / torch.linalg.vector_norm(rows, dim=1, keepdim=True).clamp_min(1e-12)
        q.embed.copy_(rows)
        q.embed_avg.copy_(rows)
    return codec


def quantizer_split(fn):
    """torch.profiler split of one tokenize or decode call of a BigCodec:
    device ms of the quantizer (the EMA's distance GEMM and argmin, LFQ's
    sign bits: kernels under ``quantize``), of K2, of the ResLSTMs, of the
    other kernels (cuDNN's convs and the rest), and the idle share of the
    call's wall time."""
    import torch
    from audiotokenization_tpu_torch.models import bigcodec
    from audiotokenization_tpu_torch.models import codec as C
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with annotated([(C, "quantize"), (bigcodec, "res_lstm")]):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    dev = [(e.name, e.time_range.start, e.time_range.end) for e in events
           if e.device_type == DeviceType.CUDA and not e.name.startswith("cs.")]

    def kernels_under(e):
        out = [(k.name, k.duration) for k in getattr(e, "kernels", [])]
        for c in e.cpu_children:
            out += kernels_under(c)
        return out

    ranged = {n: sum(d for e in events if e.name == f"cs.{n}" for _, d in kernels_under(e)) / 1e3
              for n in ("quantize", "res_lstm")}
    busy = _busy_ms(dev)
    k2 = _busy_ms([e for e in dev if "tf32unit" in e[0]])  # K2's kernel (split_tf32_unit.cuh)
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "quantizer_ms": ranged["quantize"],
            "k2_ms": k2, "lstm_ms": ranged["res_lstm"],
            "other_ms": max(busy - k2 - ranged["quantize"] - ranged["res_lstm"], 0.0),
            "idle_share": 1 - busy / wall_ms, "device_kernels": len(dev)}


def offline_rows(name, codec, wav_np, n_units, codebook: int):
    """Tokenize and decode of ``wav_np`` (B x 1 s) on the card: K1 0 and K2
    ``n_units`` each, codes in [0, codebook), the first 2 requests against
    the CPU (``hold_against_cpu``), audio-s/s (CUDA events) and the
    quantizer's profiler split."""
    import torch
    from audiotokenization_tpu_torch.models import codec as C

    wav = torch.from_numpy(wav_np).cuda()
    codes, tok = counted(lambda: C.tokenize(codec, wav))
    out, dec = counted(lambda: offline_decode(codec, codes))
    expect_launches(f"{name} tokenize", tok, (0, n_units))
    expect_launches(f"{name} decode", dec, (0, n_units))
    if tuple(codes.shape) != (1, B, SR // HOP) or tuple(out.shape) != (B, 1, SR) \
            or not torch.isfinite(out).all() or int(codes.max()) >= codebook \
            or int(codes.min()) < 0:
        fail(f"{name}: codes {tuple(codes.shape)} in {int(codes.min())}..{int(codes.max())}, "
             f"waveform {tuple(out.shape)}")
    row = hold_against_cpu(f"{name} main path", codec, wav_np, codes, out)
    tok_ms = cuda_ms(lambda: C.tokenize(codec, wav), iters=5)
    dec_ms = cuda_ms(lambda: offline_decode(codec, codes), iters=5)
    row.update(tokenize_ms=tok_ms, tokenize_audio_s_per_s=B / (tok_ms / 1e3), decode_ms=dec_ms,
               decode_audio_s_per_s=B / (dec_ms / 1e3),
               codes_used=int(torch.unique(codes).numel()),
               launches_per_tokenize={"vq_argmin": tok[0], "residual_unit": tok[1]},
               launches_per_decode={"vq_argmin": dec[0], "residual_unit": dec[1]},
               tokenize_profile=quantizer_split(lambda: C.tokenize(codec, wav)),
               decode_profile=quantizer_split(lambda: offline_decode(codec, codes)))
    print(json.dumps({f"{name}_offline": row}))
    return row, codes


def ema_run_dir(run: Path, cfg, codec):
    """A generator-only port run dir of ``cfg``: random weights from seed 0
    and ``codec``'s (the card's, spread) EMA buffers; the buffers that
    ``load_checkpoint_params`` reads back must equal them bit for bit.
    Returns the CLI's CPU codec of the run dir."""
    import torch
    from audiotokenization_tpu_torch.cli import extract_indices
    from audiotokenization_tpu_torch.config import save_config
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.train.checkpoint import load_checkpoint_params

    (run / "ckpt" / "0").mkdir(parents=True)
    save_config(cfg, run / "config.json")
    gen = C.init_codec(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    gen.quantizer.load_state({n: b.cpu() for n, b in codec.quantizer.named_buffers()})
    torch.save({"step": 0, "gen": gen.state_dict()}, run / "ckpt" / "0" / "state.pt")
    _, back = load_checkpoint_params(run, device="cpu")
    for n, b in gen.quantizer.named_buffers():
        if not torch.equal(back.quantizer.get_buffer(n), b):
            fail(f"EMA run dir: buffer {n} did not restore bit for bit")
    return extract_indices.load_model(run, device="cpu")[1]


def ema_path(card):
    """16a-c, e: the EMA-VQ flagship (zoo_config("ema_vq")), random weights
    from seed 0, the codebook spread (``spread_ema``). Prints the
    bigcodec_ema_vq line."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    cfg = zoo_config("ema_vq")
    n_units = len(cfg.model.codec_encoder.up_ratios) * len(cfg.model.codec_encoder.dilations)
    codebook = cfg.model.codec_decoder.codebook_size
    codec = spread_ema(seeded_codec(cfg))
    wav_np = (np.random.RandomState(0).randn(B, SR) * 0.1).astype(np.float32)
    result = {}
    result["offline"], _ = offline_rows("EMA", codec, wav_np, n_units, codebook)
    wavs = [torch.from_numpy(wav_np).cuda()] + [
        torch.from_numpy((np.random.RandomState(i).randn(B, SR) * 0.1).astype(np.float32)).cuda()
        for i in range(1, MODE_BATCHES)]
    result["modes"] = mode_rows("bigcodec_ema_vq", codec, wavs,
                                {m: MODE_LAT_REL[m] for m in ("high", "fast")}, (0, n_units))
    result.update(ragged_and_extract("EMA", cfg, codec, n_units,
                                     lambda run: ema_run_dir(run, cfg, codec)))
    del codec, wavs
    cos_cfg = zoo_config("ema_vq", cosine=True)
    cos = spread_ema(seeded_codec(cos_cfg, seed=1))
    result["cosine_offline"], _ = offline_rows("EMA cosine", cos, wav_np, n_units, codebook)
    del cos
    result["train_vs_cpu"] = train_step_vs_cpu(cfg, line="ema_train_step_vs_cpu")
    result["train"] = timed_training("bigcodec_ema_vq", cfg, card, (0, 2 * n_units))
    result["phase_s"] = time.perf_counter() - t0
    line = quantizer_line(result)
    print(json.dumps({"bigcodec_ema_vq": line, "card": card}))
    return line


def lfq_path(card):
    """16d: the 13-bit LFQ flagship (zoo_config("lfq")), random weights from
    seed 0. Prints the bigcodec_lfq line."""
    import numpy as np

    t0 = time.perf_counter()
    cfg = zoo_config("lfq")
    n_units = len(cfg.model.codec_encoder.up_ratios) * len(cfg.model.codec_encoder.dilations)
    codec = seeded_codec(cfg)
    wav_np = (np.random.RandomState(0).randn(B, SR) * 0.1).astype(np.float32)
    result = {}
    result["offline"], _ = offline_rows("LFQ", codec, wav_np, n_units, 2 ** LFQ_BITS)
    del codec
    result["train_vs_cpu"] = train_step_vs_cpu(cfg, line="lfq_train_step_vs_cpu")
    result["train"] = timed_training("bigcodec_lfq", cfg, card, (0, 2 * n_units))
    result["phase_s"] = time.perf_counter() - t0
    line = quantizer_line(result)
    print(json.dumps({"bigcodec_lfq": line, "card": card}))
    return line


def quantizer_line(result):
    """The bigcodec_fsq / _ema_vq / _lfq line: throughputs, launches per
    call on each path, then every result."""
    off = result["offline"]
    launches = {"tokenize": off["launches_per_tokenize"], "decode": off["launches_per_decode"],
                "train_per_step": result["train"]["launches_per_step"]}
    if "modes" in result:
        launches.update(modes_per_call={m: r["launches"] for m, r in result["modes"].items()},
                        ragged_per_call=result["ragged"]["launches_per_call"],
                        extract_per_batch=result["extract"]["launches_per_batch"])
    return {"tokenize_audio_s_per_s": off["tokenize_audio_s_per_s"],
            "decode_audio_s_per_s": off["decode_audio_s_per_s"],
            "train_audio_s_per_s": result["train"]["audio_s_per_s"],
            "train_peak_memory_gb": result["train"]["peak_memory_gb"],
            "launches": launches, **result}


def hold_indices(name, got, want, margin):
    """Indices of a library quantizer on the card against the CPU's, (Nq,)
    + positions or positions: equal at every position (all levels) but
    where its margin (a relative top-2 gap; FSQ's rounding margin) is under
    GAP. Returns (positions that differ, positions under GAP, the mask of
    those that differ)."""
    got, want = got.cpu(), want
    if got.shape != want.shape:
        fail(f"{name}: {tuple(got.shape)} indices against {tuple(want.shape)}")
    differ = (got != want).reshape(-1, margin.numel()).any(0)
    margin = margin.reshape(-1)
    if (differ & (margin >= GAP)).any():
        fail(f"{name}: {int(differ.sum())} indices differ from the CPU's, some at a margin "
             f">= {GAP:g}")
    return int(differ.sum()), int((margin < GAP).sum()), differ


def hold_close(name, got, want, keep=None):
    """Floats of the card against the CPU's within LAT_RTOL / LAT_ATOL (over
    the rows ``keep`` whose indices agree, when given)."""
    import torch

    got = got.detach().cpu()
    want = want.detach()
    if keep is not None:
        got, want = got[keep], want[keep]
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if not torch.allclose(got, want, rtol=LAT_RTOL, atol=LAT_ATOL):
        fail(f"{name}: outside rtol 1e-3 / atol 2e-4 of the CPU (max |d| {err:.3g})")
    return err


def zoo_library(card):
    """16f: each library quantizer once on the card against its CPU result,
    at widths their users pick, on inputs of ZOO_M positions, random weights
    from seed 0: indices equal but at near ties (relative top-2 gap under
    GAP), outputs within the latents' tolerance where the indices agree.
    Prints the quantizer_zoo line."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.models.quantizers import fsq, latent_quantize, misc, qinco

    t0 = time.perf_counter()
    g = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    T = ZOO_M // 2
    rows = {}

    def run(fn, module, x):
        """(card result, CPU result, card ms) of fn(module, x) without gradients."""
        cpu_m = copy.deepcopy(module)
        card_m = copy.deepcopy(module).cuda()
        with C.full_fp32(), torch.no_grad():
            want = fn(cpu_m, x)
            got = fn(card_m, x.cuda())
            ms = cuda_ms(lambda: fn(card_m, x.cuda()), iters=5)
        return got, want, ms, cpu_m

    def euclid_margin(flat, codebook):
        return ema_margins(flat, codebook, False)

    def flat(x):
        return x.transpose(1, 2).reshape(-1, x.shape[1])

    # SimVQ: 8192 codes of 8 dims (the flagship VQ's book) through its transform
    x8 = torch.from_numpy(np.random.RandomState(1).randn(2, 8, T).astype(np.float32))
    m = misc.SimVQ(codebook_size=8192, dim=8, generator=g())
    got, want, ms, cpu_m = run(lambda p, x: misc.sim_vq_apply(p, x), m, x8)
    from audiotokenization_tpu_torch.ops.conv import linear
    with torch.no_grad():
        book = linear(cpu_m.frozen_codebook, cpu_m.transform)
    f, n, differ = hold_indices("SimVQ", got[1], want[1], euclid_margin(flat(x8), book))
    rows["sim_vq"] = {"ms": ms, "indices_differ": f, "near_ties": n,
                      "max_abs_err": hold_close("SimVQ", flat(got[0]), flat(want[0]), ~differ)}
    # BEST-RQ: a 1024-dim latent projected to 16 dims, 8192 codes
    x1024 = torch.from_numpy(np.random.RandomState(2).randn(2, 1024, T).astype(np.float32))
    m = misc.RandomProjectionQuantizer(dim=1024, codebook_dim=16, codebook_size=8192,
                                       generator=g())
    got, want, ms, cpu_m = run(misc.random_projection_quantize, m, x1024)
    z = flat(x1024) @ cpu_m.projection.T
    f, n, _ = hold_indices("random projection", got, want,
                           ema_margins(z, cpu_m.codebook, True))
    rows["random_projection"] = {"ms": ms, "indices_differ": f, "near_ties": n}
    # NSVQ (eval): 8192 codes of 8 dims
    m = misc.NSVQ(codebook_size=8192, dim=8, generator=g())
    got, want, ms, cpu_m = run(lambda p, x: misc.nsvq_apply(p, x), m, x8)
    f, n, differ = hold_indices("NSVQ", got[1], want[1],
                                euclid_margin(flat(x8), cpu_m.codebook.detach()))
    rows["nsvq"] = {"ms": ms, "indices_differ": f, "near_ties": n,
                    "max_abs_err": hold_close("NSVQ", flat(got[0]), flat(want[0]), ~differ)}
    # latent quantize: 1024 -> 8 dims of 5 levels each
    m = latent_quantize.LatentQuantize(levels_per_dim=5, codebook_dim=8, dim=1024,
                                       generator=g())
    got, want, ms, cpu_m = run(lambda p, x: latent_quantize.latent_quantize_apply(p, x), m,
                               x1024 * 0.05)
    with torch.no_grad():
        lx = linear(flat(x1024 * 0.05), cpu_m.project_in)
        d = (lx[..., None] - cpu_m.values).abs().topk(2, dim=-1, largest=False).values
        margin = ((d[..., 1] - d[..., 0]) / (lx.abs() + cpu_m.values.abs().amax(-1) + 1e-12)
                  ).amin(-1)
    f, n, differ = hold_indices("latent quantize", got[1], want[1], margin)
    rows["latent_quantize"] = {"ms": ms, "indices_differ": f, "near_ties": n,
                               "max_abs_err": hold_close("latent quantize", flat(got[0]),
                                                         flat(want[0]), ~differ)}
    # residual FSQ: 1024 -> levels (8, 5, 5, 5), 4 levels of residual
    levels = (8, 5, 5, 5)
    m = fsq.FSQ(dim=1024, levels=levels, generator=g())
    got, want, ms, cpu_m = run(lambda p, x: fsq.residual_fsq_apply(p, x, num_quantizers=4), m,
                               x1024)
    with torch.no_grad():  # the CPU's bounded values of every level, their rounding margin
        res = linear(flat(x1024), cpu_m.project_in)
        margins = []
        for i in range(4):
            scale = fsq._residual_scale(levels, i, res.device)
            b = fsq.fsq_bounded(res / scale, levels)
            margins.append(((b - torch.floor(b)) - 0.5).abs().amin(-1))
            res = res - fsq.fsq_quantize_codes(res / scale, levels) * scale
        margin = torch.stack(margins).amin(0)
    f, n, differ = hold_indices("residual FSQ", got[1], want[1], margin)
    rows["residual_fsq"] = {"ms": ms, "frames_differ": f, "near_boundary": n,
                            "max_abs_err": hold_close("residual FSQ", flat(got[0]),
                                                      flat(want[0]), ~differ)}
    # QINCo: 256 codes of 8 dims, 2 stages, positions in chunks of 640
    m = qinco.Qinco(num_quantizers=2, codebook_size=256, dim=8, generator=g())
    got, want, ms, cpu_m = run(lambda p, x: qinco.qinco_apply(p, x, chunk_size=640), m, x8)
    with torch.no_grad():  # each stage's relative top-2 gap on the CPU
        fx = flat(x8)
        q0 = cpu_m.codebooks[0]
        m0 = euclid_margin(fx, q0)
        cond = q0[want.indices[0].reshape(-1).long()]
        tcb = qinco.qinco_mlp_apply(cpu_m.mlps[0], cpu_m.codebooks[1], cond)
        r = fx - cond
        dist = ((r[:, None, :] - tcb) ** 2).sum(-1)
        v, i = dist.topk(2, dim=1, largest=False)
        best = tcb[torch.arange(len(i)), i[:, 0]]
        m1 = (v[:, 1] - v[:, 0]) / ((r * r).sum(1) + (best * best).sum(1))
        margin = torch.minimum(m0, m1)
    f, n, differ = hold_indices("QINCo", got.indices, want.indices, margin)
    rows["qinco"] = {"ms": ms, "positions": ZOO_M, "codes": 256, "dim": 8, "stages": 2,
                     "chunk_size": 640, "positions_differ": f, "near_ties": n,
                     "max_abs_err": hold_close("QINCo", flat(got.quantized),
                                               flat(want.quantized), ~differ)}
    out = {"positions": ZOO_M, **rows, "phase_s": time.perf_counter() - t0}
    print(json.dumps({"quantizer_zoo": out, "card": card}))
    return out


# ---------------------------------------------------------------------------
# Phase 17: the semantic-distillation codec (configs/bigcodec_semantic.yaml)
# ---------------------------------------------------------------------------

SEM_HOP = 320              # configs/bigcodec_semantic.yaml's samples per frame
SEM_TEACHER_SEED = 1       # the random teacher's generator (phases 17a-b, d)
SEM_FILES, SEM_EVAL_FILES = 16, 4
LONG_SECONDS, LONG_PAD_SECONDS = 30, 20  # 17b: a 30 s row and a 20 s row padded to it


def seeded_teacher(cfg, device="cuda"):
    """The teacher of ``cfg.train`` (24 layers, 1024 wide, 16 heads), random
    from SEM_TEACHER_SEED, frozen, on ``device``."""
    import torch
    from audiotokenization_tpu_torch.models.w2v_bert import init_w2v_bert, teacher_config

    return init_w2v_bert(teacher_config(cfg),
                         generator=torch.Generator().manual_seed(SEM_TEACHER_SEED), device=device)


def teacher_layer(teacher, cfg, feats, valid=None):
    """The teacher's tapped layer of feats (B, T, 160) as (B, 1024, T), fp32
    with TF32 off, without gradients."""
    import torch
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.models.semantic import teacher_target

    with torch.no_grad(), C.full_fp32():
        return teacher_target(teacher, feats, feats.shape[1], cfg.train.teacher_layer,
                              valid_frames=valid)


def serve_semantic(codec, teacher, wav):
    """A request batch wav (B, T) on the card: features, the teacher, then
    tokenize with its output -> codes (1, B, T / hop)."""
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.ops.fbank import w2v_bert_features_torch

    target = teacher_layer(teacher, codec.cfg, w2v_bert_features_torch(wav))
    return C.tokenize(codec, wav, semantic_target=target)


def semantic_split(fn):
    """torch.profiler split of one call of ``fn``: device ms of the teacher
    (kernels launched under ``w2v_bert_apply``), of the semantic bottleneck
    and fc_prior (under ``semantic_vq_in``; in a training step, the forward's
    only), of the bf16 casts of ``bf16_copies`` (a bf16 training step's
    copies of the teacher), of K1 and K2, of the other kernels, and the idle
    share of the call's wall time."""
    import torch
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.models import semantic as S
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with annotated([(S, "w2v_bert_apply"), (C, "semantic_vq_in"), (C, "bf16_copies")]):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    dev = [(e.name, e.time_range.start, e.time_range.end) for e in events
           if e.device_type == DeviceType.CUDA and not e.name.startswith("cs.")]

    def kernels_under(e):
        out = [(k.name, k.duration) for k in getattr(e, "kernels", [])]
        for c in e.cpu_children:
            out += kernels_under(c)
        return out

    ranged = {n: sum(d for e in events if e.name == f"cs.{n}" for _, d in kernels_under(e)) / 1e3
              for n in ("w2v_bert_apply", "semantic_vq_in", "bf16_copies")}
    busy = _busy_ms(dev)
    k1 = _busy_ms([e for e in dev if "vq_argmin" in e[0]])
    k2 = _busy_ms([e for e in dev if "tf32unit" in e[0]])
    named = sum(ranged.values()) + k1 + k2
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "teacher_ms": ranged["w2v_bert_apply"],
            "bottleneck_fc_prior_ms": ranged["semantic_vq_in"],
            "bf16_cast_ms": ranged["bf16_copies"], "k1_ms": k1, "k2_ms": k2,
            "other_ms": max(busy - named, 0.0), "idle_share": 1 - busy / wall_ms,
            "device_kernels": len(dev)}


def semantic_serving(cfg, codec, teacher, card):
    """17a. 32 requests x 1 s through features -> teacher -> tokenize, then
    codes_to_emb -> apply_fc_post_a -> decode; the first 2 requests against
    the CPU; audio-s/s; the profiler's split."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.ops.fbank import w2v_bert_features_torch

    n_units = len(cfg.model.codec_encoder.up_ratios) * len(cfg.model.codec_encoder.dilations)
    wav_np = (np.random.RandomState(0).randn(B, SR) * 0.1).astype(np.float32)
    wav = torch.from_numpy(wav_np).cuda()
    codes, tok = counted(lambda: serve_semantic(codec, teacher, wav))
    out, dec = counted(lambda: offline_decode(codec, codes))
    expect_launches("semantic tokenize", tok, (1, n_units))
    expect_launches("semantic decode", dec, (0, n_units))
    if tuple(codes.shape) != (1, B, SR // SEM_HOP) or tuple(out.shape) != (B, 1, SR) \
            or not torch.isfinite(out).all():
        fail(f"semantic serving: codes {tuple(codes.shape)}, waveform {tuple(out.shape)}")

    # the first 2 requests on the CPU: the features, the teacher on the same
    # features, the codec on the card's teacher output
    n = 2
    cpu, tcpu = copy.deepcopy(codec).cpu(), copy.deepcopy(teacher).cpu()
    feats_cpu = w2v_bert_features_torch(torch.from_numpy(wav_np[:n]))
    feat_err = (w2v_bert_features_torch(wav[:n]).cpu() - feats_cpu).abs().max().item()
    if not torch.allclose(w2v_bert_features_torch(wav[:n]).cpu(), feats_cpu, rtol=3e-3, atol=3e-3):
        fail(f"semantic serving: the card's features off the CPU's by {feat_err:.3g}")
    t_gpu = teacher_layer(teacher, cfg, feats_cpu.cuda()).cpu()
    t_cpu = teacher_layer(tcpu, cfg, feats_cpu)
    teacher_err = (t_gpu - t_cpu).abs().max().item()
    if not torch.allclose(t_gpu, t_cpu, rtol=LAT_RTOL, atol=LAT_ATOL):
        fail(f"semantic serving: the teacher's layer off the CPU's by {teacher_err:.3g}")
    target = teacher_layer(teacher, cfg, w2v_bert_features_torch(wav))
    with C.full_fp32(), torch.no_grad():
        lat_gpu = C.semantic_vq_in(codec, C.encode(codec, wav[:n]), target[:n]).cpu()
        lat_cpu = C.semantic_vq_in(cpu, C.encode(cpu, torch.from_numpy(wav_np[:n])),
                                   target[:n].cpu())
        _, codes_cpu, _ = C.quantize(cpu, lat_cpu)
    differ, near = hold_codes("semantic tokens vs the CPU", codes[:, :n].cpu(), codes_cpu,
                              frame_gaps(cpu, lat_cpu))
    lat_err = (lat_gpu - lat_cpu).abs().max().item()
    if not torch.allclose(lat_gpu, lat_cpu, rtol=LAT_RTOL, atol=LAT_ATOL):
        fail(f"semantic serving: the quantizer's input off the CPU's by {lat_err:.3g}")
    wav_err = hold_wav("semantic decode vs the CPU", out[:n].cpu(),
                       offline_decode(cpu, codes[:, :n].cpu()))
    del cpu, tcpu

    serve_ms = cuda_ms(lambda: serve_semantic(codec, teacher, wav), iters=5)
    tok_ms = cuda_ms(lambda: C.tokenize(codec, wav, semantic_target=target), iters=5)
    teacher_ms = cuda_ms(lambda: teacher_layer(teacher, cfg, w2v_bert_features_torch(wav)),
                         iters=5)
    dec_ms = cuda_ms(lambda: offline_decode(codec, codes), iters=5)
    row = {"tokenize_with_teacher_ms": serve_ms,
           "tokenize_with_teacher_audio_s_per_s": B / (serve_ms / 1e3),
           "tokenize_given_target_ms": tok_ms,
           "tokenize_given_target_audio_s_per_s": B / (tok_ms / 1e3),
           "features_and_teacher_ms": teacher_ms,
           "decode_ms": dec_ms, "decode_audio_s_per_s": B / (dec_ms / 1e3),
           "codes_used": int(torch.unique(codes).numel()),
           "vs_cpu": {"requests": n, "tokens_differ": differ, "near_ties": near,
                      "max_abs_err_features": feat_err, "max_abs_err_teacher": teacher_err,
                      "max_abs_err_vq_input": lat_err, "max_abs_err_wav": wav_err},
           "launches_per_tokenize": {"vq_argmin": tok[0], "residual_unit": tok[1]},
           "launches_per_decode": {"vq_argmin": dec[0], "residual_unit": dec[1]},
           "tokenize_profile": semantic_split(lambda: serve_semantic(codec, teacher, wav)),
           "decode_profile": semantic_split(lambda: offline_decode(codec, codes))}
    print(json.dumps({"bigcodec_semantic_offline": row, "card": card}))
    return row


def semantic_long_precision(cfg, teacher, card):
    """17b. The teacher's tapped layer at 1 x 30 s (1,500 frames) and a
    20 s row zero-padded to it under ``valid_frames``: the card's fp32 (TF32
    off) against the same teacher in float64 on the card, no more than
    F64_RATIO times as far off as the CPU's fp32 is (fatal); the padded
    row's valid frames against that row alone."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.ops.fbank import w2v_bert_features_torch

    rng = np.random.RandomState(3)
    rows = [w2v_bert_features_torch(torch.from_numpy(
        (rng.randn(1, sec * SR) * 0.1).astype(np.float32)))[0]
        for sec in (LONG_SECONDS, LONG_PAD_SECONDS)]
    T, n = rows[0].shape[0], rows[1].shape[0]
    feats = torch.zeros((2, T, 160))
    feats[0], feats[1, :n] = rows[0], rows[1]
    valid = torch.tensor([T, n])
    t0 = time.perf_counter()
    got = teacher_layer(teacher, cfg, feats.cuda(), valid.cuda()).cpu()
    alone = teacher_layer(teacher, cfg, feats[1:, :n].cuda()).cpu()
    card_s = time.perf_counter() - t0
    t64 = copy.deepcopy(teacher).double()
    with torch.no_grad():
        ref = teacher_layer(t64, cfg, feats.double().cuda(), valid.cuda()).cpu()
    del t64
    t0 = time.perf_counter()
    cpu32 = teacher_layer(copy.deepcopy(teacher).cpu(), cfg, feats, valid)
    cpu_s = time.perf_counter() - t0

    def err(x):
        return max((x[0] - ref[0]).abs().max().item(),
                   (x[1, :, :n] - ref[1, :, :n]).abs().max().item())

    card_err, cpu_err = err(got.double()), err(cpu32.double())
    alone_err = (got[1, :, :n] - alone[0]).abs().max().item()
    out = {"frames": [T, n], "max_abs_err_card_vs_f64": card_err,
           "max_abs_err_cpu32_vs_f64": cpu_err, "ratio": card_err / cpu_err,
           "max_abs_err_padded_row_vs_alone": alone_err, "card_s": card_s, "cpu_s": cpu_s}
    print(json.dumps({"semantic_long_precision": out, "card": card}))
    if card_err > F64_RATIO * cpu_err:
        fail(f"the teacher at {T} frames: {card_err:.3g} off float64 on the card, more than "
             f"{F64_RATIO:g}x the CPU fp32's {cpu_err:.3g}")
    if not torch.allclose(got[1, :, :n], alone[0], rtol=LAT_RTOL, atol=LAT_ATOL):
        fail(f"the padded row's valid frames off its own forward by {alone_err:.3g}")
    return out


def hf_state_dict(teacher) -> dict:
    """The teacher's weights under the HF Wav2Vec2BertModel names (the inverse
    of ``models/w2v_bert.py::convert_w2v_bert``), on the CPU."""
    sd = {}
    names = {"ffn1.norm": "ffn1_layer_norm", "ffn2.norm": "ffn2_layer_norm",
             "ffn1.inter": "ffn1.intermediate_dense", "ffn1.out": "ffn1.output_dense",
             "ffn2.inter": "ffn2.intermediate_dense", "ffn2.out": "ffn2.output_dense",
             "attn.norm": "self_attn_layer_norm", "attn.q": "self_attn.linear_q",
             "attn.k": "self_attn.linear_k", "attn.v": "self_attn.linear_v",
             "attn.out": "self_attn.linear_out",
             "attn.distance_embedding": "self_attn.distance_embedding.weight",
             "conv.norm": "conv_module.layer_norm", "conv.pw1": "conv_module.pointwise_conv1",
             "conv.dw": "conv_module.depthwise_conv",
             "conv.dw_norm": "conv_module.depthwise_layer_norm",
             "conv.pw2": "conv_module.pointwise_conv2", "final_norm": "final_layer_norm",
             "feat_norm": "feature_projection.layer_norm",
             "feat_proj": "feature_projection.projection"}
    for key, v in teacher.state_dict().items():
        v = v.detach().cpu().clone()
        if key.startswith("layers."):
            _, i, rest = key.split(".", 2)
            prefix = f"encoder.layers.{i}."
        else:
            prefix, rest = "", key
        if rest == "attn.distance_embedding":
            sd[prefix + names[rest]] = v
            continue
        module, leaf = rest.rsplit(".", 1)
        if module in ("conv.pw1", "conv.pw2"):
            v = v[:, :, None]
        sd[f"{prefix}{names[module]}.{'weight' if leaf == 'w' else 'bias'}"] = v
    return sd


def write_snapshot(path: Path, teacher):
    """A local w2v-bert snapshot of ``teacher``: config.json and
    pytorch_model.bin."""
    path.mkdir(parents=True)
    c = teacher.cfg
    (path / "config.json").write_text(json.dumps(
        {"model_type": "wav2vec2-bert", "hidden_size": c.hidden_size,
         "num_hidden_layers": c.num_hidden_layers,
         "num_attention_heads": c.num_attention_heads,
         "intermediate_size": c.intermediate_size,
         "feature_projection_input_dim": c.feature_projection_input_dim,
         "left_max_position_embeddings": c.left_max_position_embeddings,
         "right_max_position_embeddings": c.right_max_position_embeddings,
         "conv_depthwise_kernel_size": c.conv_depthwise_kernel_size,
         "layer_norm_eps": c.layer_norm_eps, "position_embeddings_type": "relative_key"}))
    import torch

    torch.save(hf_state_dict(teacher), path / "pytorch_model.bin")


def semantic_cli_path(cfg, teacher, card):
    """17c. On a small corpus: cli.precompute_semantic from a snapshot of
    the teacher, cli.extract_indices --semantic_dir, cli.inference_full
    --w2v_bert_init random on whole files."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from audiotokenization_tpu_torch.cli import extract_indices, inference_full, precompute_semantic
    from audiotokenization_tpu_torch.data.audio_io import read_audio
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.ops.fbank import feature_frames, w2v_bert_features_from_clip
    from audiotokenization_tpu_torch.ops.resample import resample
    from audiotokenization_tpu_torch.utils import ragged

    n_units = len(cfg.model.codec_encoder.up_ratios) * len(cfg.model.codec_encoder.dilations)
    codebook = cfg.model.codec_decoder.codebook_size
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_semantic_", dir=build_dir))
    out = {}
    ledger = None
    try:
        files = write_extract_corpus(root, SEM_FILES)
        snap, sem_dir, run = root / "w2v-bert", root / "semantic", root / "run"
        t0 = time.perf_counter()
        write_snapshot(snap, teacher)
        snapshot_s = time.perf_counter() - t0

        def wav16(path):
            w, rate = read_audio(path)
            w = w[0]
            return w if rate == SR else resample(torch.from_numpy(w), rate, SR).numpy()

        # precompute: float16 (1024, Tf), two files against the CPU's teacher
        t0 = time.perf_counter()
        counted(lambda: precompute_semantic.main(
            ["--filelist", str(root / "filelist.txt"), "--out_dir", str(sem_dir),
             "--model_path", str(snap), "--layer", str(cfg.train.teacher_layer)]))
        pre_s = time.perf_counter() - t0
        tcpu = copy.deepcopy(teacher).cpu()
        pre_err = 0.0
        for i, (path, _, _) in enumerate(files):
            a = np.load(sem_dir / f"{path.stem}.npy")
            w = wav16(path)
            if a.dtype != np.float16 or a.shape != (1024, feature_frames(len(w))) \
                    or not np.isfinite(a).all():
                fail(f"precompute {path.name}: {a.dtype} {a.shape}")
            if i < 2:
                want = teacher_layer(tcpu, cfg, torch.from_numpy(
                    w2v_bert_features_from_clip(w))[None])[0].numpy()
                d = np.abs(a.astype(np.float32) - want)
                tol = np.spacing(np.abs(want).astype(np.float16)).astype(np.float32) \
                    + LAT_ATOL + LAT_RTOL * np.abs(want)
                pre_err = max(pre_err, float(d.max()))
                if (d > tol).any():
                    fail(f"precompute {path.name}: off the CPU's teacher by {d.max():.3g}")
        del tcpu
        out["precompute"] = {"files": len(files), "seconds": pre_s, "snapshot_write_s": snapshot_s,
                             "max_abs_err_vs_cpu": pre_err}

        # extraction at batch EXTRACT_BATCH with the targets
        codec_cpu = write_gen_run(run, cfg)
        ledger = LaunchLedger({"batch": (ragged, "make_ragged_tokenizer")})
        counts, launches = counted(lambda: extract_indices.main(
            ["--dataset_root", str(root), "--save_path", str(run), "--dataset_path",
             "LibriSpeech", "--ext_audio", ".wav", "--subsets", "test-clean", "--batch_size",
             str(EXTRACT_BATCH), "--semantic_dir", str(sem_dir)]))
        ledger.close()
        calls = ledger.calls["batch"]
        if counts["saved"] != len(files) or counts["errors"] or set(calls) != {(1, n_units)} \
                or tuple(launches) != (len(calls), n_units * len(calls)):
            fail(f"semantic extraction: {counts['saved']} saved, {counts['errors']} errors, "
                 f"launches {launches} over batches {calls}")
        npys = {p.stem: p for p in (run / "extracted_indices").rglob("*.npy")}
        flips = near = 0
        for i, (path, _, _) in enumerate(files):
            a = np.load(npys[path.stem])
            w = wav16(path)
            frames = ceil_div(len(w), SEM_HOP)
            if a.dtype != np.int16 or a.shape != (frames,) or a.min() < 0 or a.max() >= codebook:
                fail(f"semantic extraction {path.name}: {a.dtype} {a.shape}")
            if i < 4:  # against the CPU's tokenize of the hop-padded file with its target
                x = torch.from_numpy(np.pad(w, (0, frames * SEM_HOP - len(w))))[None]
                t = torch.from_numpy(extract_indices.load_semantic_target(sem_dir, path.stem,
                                                                          frames))[None]
                with torch.no_grad(), C.full_fp32():
                    lat = C.semantic_vq_in(codec_cpu, C.encode(codec_cpu, x), t)
                    want = C.quantize(codec_cpu, lat)[1][0, 0].numpy()
                f, m = hold_tokens(f"semantic extraction of {path.name}", a, want,
                                   frame_gaps(codec_cpu, lat)[0].numpy())
                flips, near = flips + f, near + m
        out["extract"] = {"files": len(files), "batch_size": EXTRACT_BATCH,
                          **{k: counts[k] for k in ("audio_seconds", "audio_s_per_s",
                                                    "device_batches", "device_s")},
                          "launches_per_batch": {"vq_argmin": calls[0][0],
                                                 "residual_unit": calls[0][1]},
                          "tokens_differ_vs_cpu": flips, "near_ties": near}

        # evaluation of whole files with a random teacher, per file on the ragged codec
        (root / "eval.txt").write_text("\n".join(str(p) for p, _, _ in files[:SEM_EVAL_FILES]))
        ledger = LaunchLedger({"eval": (ragged, "make_ragged_codec")})
        summary, launches = counted(lambda: inference_full.main(
            ["--save_path", str(run), "--filelist", str(root / "eval.txt"), "--duration", "0",
             "--batch_size", str(SEM_EVAL_FILES), "--num_examples", "0",
             "--w2v_bert_init", "random"]))
        ledger.close()
        calls = ledger.calls["eval"]
        frames = sum(ceil_div(len(wav16(p)), SEM_HOP) for p, _, _ in files[:SEM_EVAL_FILES])
        if summary["frames"] != frames or not all(np.isfinite(summary[k])
                                                   for k in ("si_snr", "si_sdr")) \
                or set(calls) != {(1, 2 * n_units)} \
                or tuple(launches) != (len(calls), 2 * n_units * len(calls)):
            fail(f"semantic evaluation: {summary['frames']} frames (want {frames}), "
                 f"launches {launches} over batches {calls}")
        out["eval"] = {"files": SEM_EVAL_FILES, "device_batches": len(calls),
                       "launches_per_batch": {"vq_argmin": calls[0][0],
                                              "residual_unit": calls[0][1]},
                       **{k: summary[k] for k in ("si_snr", "si_sdr", "frames", "audio_s_per_s",
                                                  "forward_s", "wall_seconds")}}
    finally:
        if ledger is not None:
            ledger.close()
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"bigcodec_semantic_cli": out, "card": card}))
    return out


def semantic_path(card):
    """17. configs/bigcodec_semantic.yaml at full width and depth, the codec
    from seed 0 and the 24-layer teacher random from SEM_TEACHER_SEED,
    tapped at layer 16 (module docstring). Prints the bigcodec_semantic line."""
    import torch

    t0 = time.perf_counter()
    cfg = repo_config("bigcodec_semantic.yaml")
    n_units = len(cfg.model.codec_encoder.up_ratios) * len(cfg.model.codec_encoder.dilations)
    codec = seeded_codec(cfg)
    teacher = seeded_teacher(cfg)
    result = {"teacher": {"layers": teacher.cfg.num_hidden_layers,
                          "hidden": teacher.cfg.hidden_size,
                          "heads": teacher.cfg.num_attention_heads,
                          "intermediate": teacher.cfg.intermediate_size,
                          "tapped_layer": cfg.train.teacher_layer,
                          "parameters": sum(p.numel() for p in teacher.parameters())}}
    result["offline"] = semantic_serving(cfg, codec, teacher, card)
    result["long_precision"] = semantic_long_precision(cfg, teacher, card)
    del codec
    result.update(semantic_cli_path(cfg, teacher, card))
    result["train_vs_cpu"] = train_step_vs_cpu(cfg, line="semantic_train_step_vs_cpu",
                                               teacher=copy.deepcopy(teacher).cpu())
    result["train"] = timed_training("bigcodec_semantic", cfg, card, (1, 2 * n_units),
                                     teacher=teacher, split=semantic_split)
    del teacher
    torch.cuda.empty_cache()
    result["phase_s"] = time.perf_counter() - t0
    off = result["offline"]
    line = {"tokenize_with_teacher_audio_s_per_s": off["tokenize_with_teacher_audio_s_per_s"],
            "tokenize_given_target_audio_s_per_s": off["tokenize_given_target_audio_s_per_s"],
            "decode_audio_s_per_s": off["decode_audio_s_per_s"],
            "tokens_differ_vs_cpu": off["vs_cpu"]["tokens_differ"],
            "long_precision_ratio": result["long_precision"]["ratio"],
            "train_audio_s_per_s": result["train"]["audio_s_per_s"],
            "train_peak_memory_gb": result["train"]["peak_memory_gb"],
            "launches": {"tokenize": off["launches_per_tokenize"],
                         "decode": off["launches_per_decode"],
                         "extract_per_batch": result["extract"]["launches_per_batch"],
                         "eval_per_batch": result["eval"]["launches_per_batch"],
                         "train_per_step": result["train"]["launches_per_step"]},
            **result}
    print(json.dumps({"bigcodec_semantic": line, "card": card}))
    return line


# ---------------------------------------------------------------------------
# 18. the stage-2 token LM on the flagship's tokens, and the causal step
# ---------------------------------------------------------------------------

LM_VOCAB = 8192 + 2                # Config()'s codebook + BOS, EOS
LM_FWD_B, LM_FWD_T = 2, 1024       # the forward at the LM's whole context
LM_FWD_TOL = 1e-4                  # card against CPU logits: rtol and atol x max |logit|
LM_LOSS_B, LM_LOSS_T = 16, 80      # 16 x 81 positions: a 1 s crop's 80 frames + BOS
LM_LOSS_RTOL = 1e-5
LM_TOKENS = 160                    # 2 s of audio at hop 200
LM_SAMPLE_B = (2, 32)
LM_TRAIN_B = 16                    # cli/train_token_lm.py's default batch of 1 s crops
LM_CLI_FILES, LM_CLI_STEPS = 16, 3


def lm_logits64(lm, tokens):
    """The LM's logits in float64 on ``tokens``' device, written out from the
    JAX package's token_lm_apply (RMS norm, interleaved RoPE from float64
    angles, causal softmax attention, SwiGLU, untied head): the reference
    of the precision rule."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    c = lm.cfg
    B, T = tokens.shape
    nh, D = c.num_heads, c.head_dim
    p = {k: v.detach().to(tokens.device, torch.float64) for k, v in lm.state_dict().items()}
    ang = torch.tensor(np.outer(np.arange(T), 1.0 / c.rope_theta ** (np.arange(0, D, 2) / D)),
                       dtype=torch.float64, device=tokens.device)
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]

    def rope(x):
        xe, xo = x[..., 0::2], x[..., 1::2]
        return torch.stack([xe * cos - xo * sin, xe * sin + xo * cos], -1).reshape(x.shape)

    def norm(x, w):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * w

    future = ~torch.ones(T, T, dtype=torch.bool, device=tokens.device).tril()
    h = p["embed"][tokens]
    for i in range(c.num_layers):
        w = {k[len(f"layers.{i}."):]: v for k, v in p.items() if k.startswith(f"layers.{i}.")}
        x = norm(h, w["attn_norm"])
        q, k, v = ((x @ w[f"{n}.w"].T).reshape(B, T, nh, D) for n in "qkv")
        s = torch.einsum("bqhd,bkhd->bhqk", rope(q), rope(k)) / D ** 0.5
        a = torch.softmax(s.masked_fill(future, float("-inf")), -1)
        h = h + torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, T, -1) @ w["o.w"].T
        x = norm(h, w["mlp_norm"])
        h = h + (F.silu(x @ w["gate.w"].T) * (x @ w["up.w"].T)) @ w["down.w"].T
    return norm(h, p["norm"]) @ p["lm_head.w"].T


def lm_forward(lm_cpu, lm_card):
    """18a. token_lm_apply at 2 x 1,024 positions on the card against the CPU
    (rtol / atol 1e-4 x max |logit|) and against a float64 forward on the
    card (no more than 4x the CPU fp32 forward's error); token_lm_loss at
    16 x 81 positions within 1e-5 relative of the CPU's; the forward's time."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.models import token_lm as TL

    rng = np.random.RandomState(20)
    tokens = torch.from_numpy(rng.randint(0, LM_VOCAB - 2, (LM_FWD_B, LM_FWD_T)))
    with torch.no_grad():
        got = TL.token_lm_apply(lm_card, tokens.cuda())
        want = TL.token_lm_apply(lm_cpu, tokens)
        ref = lm_logits64(lm_card, tokens.cuda())
    scale = want.abs().max().item()
    err = (got.cpu() - want).abs()
    if not bool((err <= LM_FWD_TOL * want.abs() + LM_FWD_TOL * scale).all()):
        fail(f"token LM forward: logits off the CPU's by {err.max().item():.3g} "
             f"(max |logit| {scale:.3g}; rtol / atol {LM_FWD_TOL:g} x max |logit|)")
    card64 = (got.double() - ref).abs().max().item()
    cpu64 = (want.cuda().double() - ref).abs().max().item()
    if card64 > F64_RATIO * cpu64:
        fail(f"token LM forward: {card64:.3g} off float64 on the card, the CPU fp32 {cpu64:.3g} "
             f"(rule {F64_RATIO:g}x)")
    idx = torch.from_numpy(rng.randint(0, LM_VOCAB - 2, (LM_LOSS_B, LM_LOSS_T)))
    with torch.no_grad():
        loss_card = TL.token_lm_loss(lm_card, idx.cuda()).item()
        loss_cpu = TL.token_lm_loss(lm_cpu, idx).item()
    if not abs(loss_card - loss_cpu) <= LM_LOSS_RTOL * abs(loss_cpu):
        fail(f"token LM loss {loss_card!r} on the card against {loss_cpu!r} on the CPU")
    with torch.no_grad():
        ms = cuda_ms(lambda: TL.token_lm_apply(lm_card, tokens.cuda()), iters=5)
    return {"positions": [LM_FWD_B, LM_FWD_T], "max_abs_err_vs_cpu": err.max().item(),
            "max_abs_logit": scale, "err_vs_float64_card": card64, "err_vs_float64_cpu": cpu64,
            "float64_ratio": card64 / cpu64, "loss_card": loss_card, "loss_cpu": loss_cpu,
            "loss_rel_diff": abs(loss_card - loss_cpu) / abs(loss_cpu), "forward_ms": ms}


def sample_gaps(lm, tokens, temperature: float, gumbel=None):
    """(L,) the smallest top-2 gap over the batch of each step's selection
    score (the logits, or gumbel + logits / T) along ``tokens`` (B, L)."""
    import torch
    from audiotokenization_tpu_torch.models import token_lm as TL

    bos = torch.full((tokens.shape[0], 1), lm.cfg.bos_token_id, dtype=torch.long,
                     device=tokens.device)
    with torch.no_grad():
        score = TL.token_lm_apply(lm, torch.cat([bos, tokens[:, :-1]], dim=1))
    if temperature != 0.0:
        score = gumbel.to(score.device).transpose(0, 1) + score / temperature
    top = score.topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]).amin(0).cpu()


def hold_samples(name, got, want, gaps):
    """Fail unless ``got`` equals ``want`` (B, L) token for token up to the
    first step whose top-2 gap is under GAP. Returns (the first step that
    differs, the first near tie), None where there is none."""
    differ = (got.cpu() != want.cpu()).any(0).nonzero()
    first = int(differ[0]) if len(differ) else None
    near = (gaps < GAP).nonzero()
    tie = int(near[0]) if len(near) else None
    if first is not None and (tie is None or tie > first):
        fail(f"{name}: tokens differ from step {first} on, no top-2 gap under {GAP:g} before it")
    return first, tie


def lm_sampling(lm_cpu, lm_card):
    """18b. Greedy and temperature-1 sampling (the same Gumbel draws on both
    sides) from BOS for LM_TOKENS tokens at B 2: the card's KV sampler
    against its full re-forward and the CPU's KV sampler; then both
    samplers timed at B 2 and 32, and one KV run profiled (device busy,
    idle share)."""
    import torch
    from audiotokenization_tpu_torch.models import token_lm as TL

    b = LM_SAMPLE_B[0]
    out = {"tokens": LM_TOKENS}
    gumbel = TL.gumbel_noise((LM_TOKENS, b, LM_VOCAB), generator=torch.Generator().manual_seed(1),
                             device="cpu")
    for temperature, draws in ((0.0, None), (1.0, gumbel)):
        kw = dict(batch_size=b, length=LM_TOKENS, temperature=temperature)
        card_kv = TL.token_lm_generate_kv(lm_card, gumbel=None if draws is None else draws.cuda(),
                                          **kw)
        card_full = TL.token_lm_generate(lm_card, gumbel=None if draws is None else draws.cuda(),
                                         **kw)
        cpu_kv = TL.token_lm_generate_kv(lm_cpu, gumbel=draws, **kw)
        gaps = sample_gaps(lm_card, card_kv, temperature, draws)
        label = "greedy" if temperature == 0.0 else "temperature_1"
        first_full, tie = hold_samples(f"{label} KV against full re-forward", card_kv, card_full,
                                       gaps)
        first_cpu, _ = hold_samples(f"{label} card KV against CPU KV", card_kv, cpu_kv, gaps)
        if not ((card_kv >= 0) & (card_kv < LM_VOCAB)).all():
            fail(f"{label} sampling: tokens outside the vocabulary")
        out[label] = {"first_differing_step_vs_full": first_full,
                      "first_differing_step_vs_cpu": first_cpu, "first_near_tie_step": tie,
                      "smallest_gap": gaps.min().item()}
    for batch in LM_SAMPLE_B:
        g = torch.Generator(device="cuda").manual_seed(2)
        times = {}
        for name, fn in (("kv", TL.token_lm_generate_kv), ("full", TL.token_lm_generate)):
            fn(lm_card, batch_size=batch, length=8, temperature=1.0, generator=g)  # warm-up
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn(lm_card, batch_size=batch, length=LM_TOKENS, temperature=1.0, generator=g)
            end.record()
            torch.cuda.synchronize()
            times[name] = start.elapsed_time(end)
        out[f"B{batch}"] = {"kv_ms_per_token": times["kv"] / LM_TOKENS,
                            "kv_tokens_per_s": batch * LM_TOKENS / (times["kv"] / 1e3),
                            "full_ms_per_token": times["full"] / LM_TOKENS,
                            "full_tokens_per_s": batch * LM_TOKENS / (times["full"] / 1e3)}
    events, wall_ms = device_events(lambda: TL.token_lm_generate_kv(
        lm_card, batch_size=b, length=LM_TOKENS, temperature=1.0,
        generator=torch.Generator(device="cuda").manual_seed(3)))
    busy = _busy_ms(events)
    out["kv_profile"] = {"batch": b, "wall_ms": wall_ms, "busy_ms": busy,
                         "idle_share": 1 - busy / wall_ms, "kernels": len(events),
                         "kernels_per_token": len(events) / LM_TOKENS}
    return out


def lm_train(cfg, codec, lm_cpu):
    """18c. One LM step at 16 x 1 s over the frozen flagship's tokens on the
    card against the CPU's from the same weights and batch, with phase 8b's
    optimizer setting (AdamW eps 1, no warmup: an update close to lr·g, not
    lr·sign(g), whose sign flips where |g| is near eps): tokens but at top-2
    gaps under GAP, loss within 1e-5 relative, each leaf's update within
    UPDATE_TOL x its max |update| plus twice the parameters' fp32 spacing;
    then TRAIN_WARMUP + TRAIN_STEPS steps with the CLI's optimizer, the
    first one's loss and ppl against the CPU's, the last TRAIN_STEPS timed,
    K1 1 / K2 15 launches a step, the tokenize / LM split by CUDA events,
    peak memory."""
    import math

    import numpy as np
    import torch
    from audiotokenization_tpu_torch.config import OptimParams
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.models import token_lm as TL
    from audiotokenization_tpu_torch.train.state import ClippedAdamW

    codec_cpu = copy.deepcopy(codec).cpu()
    lm_card = copy.deepcopy(lm_cpu).cuda()
    wav_np = (np.random.RandomState(21).randn(LM_TRAIN_B, SR) * 0.1).astype(np.float32)
    wav = torch.from_numpy(wav_np)
    with C.full_fp32(), torch.no_grad():
        lat = C.encode(codec, wav.cuda())
    tok_card = C.tokenize(codec, wav.cuda()).cpu()
    tok_cpu = C.tokenize(codec_cpu, wav)
    flips, near = hold_codes("token LM step tokens", tok_card, tok_cpu, frame_gaps(codec, lat).cpu())
    lm_cfg = lm_cpu.cfg
    steps = {}
    for side, lm, cdc, w in (("card", lm_card, codec, wav.cuda()), ("cpu", lm_cpu, codec_cpu, wav)):
        before = {k: v.detach().cpu().clone() for k, v in lm.state_dict().items()}
        smooth = ClippedAdamW(lm, OptimParams(betas=(0.8, 0.9), eps=1.0,
                                              weight_decay=TL.LM_WEIGHT_DECAY),
                              dataclasses.replace(cfg.train.gen_schedule_params, warmup_step=0),
                              cfg.train.gen_grad_clip)
        step = TL.make_token_lm_train_step(cfg, lm_cfg, cdc, smooth)
        t0 = time.perf_counter()
        logs = step(lm, {"wav": w})
        loss = logs["loss"].item()
        steps[side] = (loss, before, {k: v.detach().cpu() for k, v in lm.state_dict().items()},
                       time.perf_counter() - t0)
    (loss_card, b, after_card, card_s), (loss_cpu, _, after_cpu, cpu_s) = steps["card"], steps["cpu"]
    if not abs(loss_card - loss_cpu) <= LM_LOSS_RTOL * abs(loss_cpu):
        fail(f"token LM step: loss {loss_card!r} on the card against {loss_cpu!r} on the CPU")
    worst, worst_at = hold_updates("token LM step", b, after_cpu, after_card,
                                   every_leaf_moves=True)
    vs_cpu = {"loss_card": loss_card, "loss_cpu": loss_cpu,
              "loss_rel_diff": abs(loss_card - loss_cpu) / abs(loss_cpu),
              "worst_update_rel": worst, "worst_update_leaf": worst_at,
              "tokens_differ": flips, "near_ties": near, "card_s": card_s, "cpu_s": cpu_s}

    # the CLI's optimizer from here on: its first step's loss and ppl against the
    # CPU's (they precede its update, so eps 1e-8's sign-like updates do not reach
    # them), then the warm-ups and the timed steps, the tokenize / LM split by CUDA
    # events around the codec's part
    step = TL.make_token_lm_train_step(cfg, lm_cfg, codec, TL.make_token_lm_optimizer(cfg, lm_card))
    w = wav.cuda()
    first = {k: v.item() for k, v in step(lm_card, {"wav": w}).items()}
    first_cpu = {k: v.item() for k, v in TL.make_token_lm_train_step(
        cfg, lm_cfg, codec_cpu, TL.make_token_lm_optimizer(cfg, lm_cpu))(lm_cpu, {"wav": wav}).items()}
    ppl_rtol = math.expm1(LM_LOSS_RTOL * abs(first_cpu["loss"]))  # what the loss's bound allows
    for key, rtol in (("loss", LM_LOSS_RTOL), ("ppl", ppl_rtol)):
        if not abs(first[key] - first_cpu[key]) <= rtol * abs(first_cpu[key]):
            fail(f"token LM step at the CLI's optimizer: {key} {first[key]!r} on the card "
                 f"against {first_cpu[key]!r} on the CPU")
    vs_cpu["cli_optimizer_first_step"] = {
        **{f"{k}_card": v for k, v in first.items()}, **{f"{k}_cpu": v for k, v in first_cpu.items()},
        "loss_rel_diff": abs(first["loss"] - first_cpu["loss"]) / abs(first_cpu["loss"])}
    for _ in range(TRAIN_WARMUP - 1):
        step(lm_card, {"wav": w})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spans, tokenize = [], TL.tokenize

    def timed_tokenize(*a, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = tokenize(*a, **kw)
        end.record()
        spans.append((start, end))
        return out

    TL.tokenize = timed_tokenize
    try:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

        def run():
            start.record()
            for _ in range(TRAIN_STEPS):
                logs = step(lm_card, {"wav": w})
            end.record()
            return logs

        logs, launches = counted(run)
    finally:
        TL.tokenize = tokenize
    ms = start.elapsed_time(end) / TRAIN_STEPS
    tok_ms = sum(s.elapsed_time(e) for s, e in spans) / TRAIN_STEPS
    per_step = (launches[0] / TRAIN_STEPS, launches[1] / TRAIN_STEPS)
    expect_launches("token LM training step", per_step, (1, 15))
    if not np.isfinite(logs["loss"].item()):
        fail("token LM training: the loss is not finite")
    return {"vs_cpu": vs_cpu, "batch": [LM_TRAIN_B, SR], "ms_per_step": ms,
            "audio_s_per_s": LM_TRAIN_B / (ms / 1e3), "tokenize_ms": tok_ms,
            "lm_ms": ms - tok_ms, "tokenize_share": tok_ms / ms,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches_per_step": {"vq_argmin": per_step[0], "residual_unit": per_step[1]},
            "steps_timed": TRAIN_STEPS, "loss": logs["loss"].item(), "ppl": logs["ppl"].item()}


def lm_clis(cfg):
    """18d. On LM_CLI_FILES synthetic WAVs under build/ (deleted after):
    cli.train_token_lm for LM_CLI_STEPS steps at batch 16 from a port run dir
    of phase 5's codec (K1 1 / K2 15 a step, a finite loss logged every
    step, the checkpoint), then cli.synthesize --lm_ckpt of 2 x 2 s (2 WAVs,
    tokens.npy (2, 160) int16 in [0, 8192), K1 0 / K2 15, the waveforms
    within WAV_RTOL / WAV_ATOL of the CPU's decode of tokens.npy); wall
    times."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from audiotokenization_tpu_torch.cli import synthesize, train_token_lm
    from audiotokenization_tpu_torch.data.audio_io import write_wav

    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_token_lm_", dir=build_dir))
    try:
        rng = np.random.RandomState(22)
        files = []
        for i in range(LM_CLI_FILES):
            n = int(rng.uniform(1.1, 3.0) * SR)
            t = np.arange(n) / SR
            w = np.sin(2 * np.pi * rng.uniform(100, 250) * t) * 0.15 + rng.randn(n) * 0.05
            write_wav(root / f"u{i}.wav", w.astype(np.float32), SR)
            files.append(str(root / f"u{i}.wav"))
        (root / "filelist.txt").write_text("\n".join(files))
        run = root / "codec"
        codec_cpu = write_gen_run(run, cfg)
        lm_dir, out_dir = root / "lm", root / "synth"
        t0 = time.perf_counter()
        _, train_launches = counted(lambda: train_token_lm.main(
            ["--codec_ckpt", str(run), "--filelist", str(root / "filelist.txt"), "--run_dir",
             str(lm_dir), "--max_steps", str(LM_CLI_STEPS), "--batch_size", "16",
             "--log_every", "1"]))
        train_s = time.perf_counter() - t0
        expect_launches("cli.train_token_lm", train_launches, (LM_CLI_STEPS, 15 * LM_CLI_STEPS))
        logs = [json.loads(line) for line in (lm_dir / "metrics.jsonl").read_text().splitlines()]
        if [r["step"] for r in logs] != list(range(1, LM_CLI_STEPS + 1)) \
                or not all(np.isfinite(r["loss"]) for r in logs) \
                or not (lm_dir / "ckpt" / str(LM_CLI_STEPS) / "state.pt").exists():
            fail(f"cli.train_token_lm: metrics {logs}, checkpoints "
                 f"{sorted(p.name for p in (lm_dir / 'ckpt').iterdir())}")
        t0 = time.perf_counter()
        wav, synth_launches = counted(lambda: synthesize.main(
            ["--codec_ckpt", str(run), "--lm_ckpt", str(lm_dir), "--seconds", "2",
             "--num_samples", "2", "--out_dir", str(out_dir)]))
        synth_s = time.perf_counter() - t0
        expect_launches("cli.synthesize --lm_ckpt", synth_launches, (0, 15))
        tokens = np.load(out_dir / "tokens.npy")
        if tokens.dtype != np.int16 or tokens.shape != (2, LM_TOKENS) or tokens.min() < 0 \
                or tokens.max() >= LM_VOCAB - 2 or len(list(out_dir.glob("sample_*.wav"))) != 2 \
                or not np.isfinite(wav).all():
            fail(f"cli.synthesize --lm_ckpt: tokens {tokens.dtype} {tokens.shape} in "
                 f"[{tokens.min()}, {tokens.max()}], wavs {sorted(out_dir.glob('*.wav'))}")
        want = synthesize.decode_tokens(codec_cpu, torch.from_numpy(tokens.astype(np.int64)))
        want = want.numpy()
        wav_err = float(np.abs(wav - want).max())
        if wav.shape != want.shape or not np.allclose(wav, want, rtol=WAV_RTOL, atol=WAV_ATOL):
            fail(f"cli.synthesize --lm_ckpt: waveform outside rtol {WAV_RTOL:g} / atol "
                 f"{WAV_ATOL:g} of the CPU's decode of its tokens.npy (max |d| {wav_err:.3g})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"train_token_lm_s": train_s, "train_steps": LM_CLI_STEPS,
            "train_launches": {"vq_argmin": train_launches[0],
                               "residual_unit": train_launches[1]},
            "losses": [r["loss"] for r in logs], "synthesize_s": synth_s,
            "synthesize_launches": {"vq_argmin": synth_launches[0],
                                    "residual_unit": synth_launches[1]},
            "synthesized_tokens": list(tokens.shape), "codes_used": int(len(np.unique(tokens))),
            "synthesize_wav_max_abs_err_vs_cpu": wav_err}


def token_lm_path(cfg, card):
    """18a-d. The token LM at the reference's full width (vocabulary 8194,
    hidden 256, 4 layers of 4 heads, 1,024 positions), random from seed 0,
    on phase 5's flagship codec. Prints the token_lm line."""
    import torch
    from audiotokenization_tpu_torch.models import token_lm as TL

    lm_cpu = TL.init_token_lm(TL.token_lm_config(cfg), generator=torch.Generator().manual_seed(0),
                              device="cpu")
    if lm_cpu.cfg.vocab_size != LM_VOCAB:
        fail(f"the flagship's LM vocabulary is {lm_cpu.cfg.vocab_size}, not {LM_VOCAB}")
    lm_card = copy.deepcopy(lm_cpu).cuda()
    out = {"parameters": sum(p.numel() for p in lm_cpu.parameters())}
    out["forward"] = lm_forward(lm_cpu, lm_card)
    print(json.dumps({"token_lm_forward": out["forward"]}))
    out["sampling"] = lm_sampling(lm_cpu, lm_card)
    print(json.dumps({"token_lm_sampling": out["sampling"]}))
    codec = seeded_codec(cfg)
    out["train"] = lm_train(cfg, codec, lm_cpu)
    del codec
    torch.cuda.empty_cache()
    out["cli"] = lm_clis(cfg)
    print(json.dumps({"token_lm": out, "card": card}))
    return out


def causal_train_path(card):
    """18e. One fp32_strict step of configs/bigcodec_causal.yaml and of its
    causal + anti-aliased variant at 2 x 8000 against the CPU's (phase 8b's
    tolerances), then bf16 steps of bigcodec_causal.yaml at 32 x 1 s (2
    warm-ups, 5 timed, K1 1 / K2 0 a step, finite). Prints the causal_train
    line."""
    import torch

    cfg = repo_config("bigcodec_causal.yaml")
    aa = copy.deepcopy(cfg)
    aa.model.codec_encoder.antialias = aa.model.codec_decoder.antialias = True
    out = {"causal_vs_cpu": train_step_vs_cpu(cfg, line="causal_train_step_vs_cpu"),
           "causal_antialias_vs_cpu": train_step_vs_cpu(
               aa, line="causal_antialias_train_step_vs_cpu")}
    out["train"] = timed_training("bigcodec_causal", cfg, card, (1, 0))
    torch.cuda.empty_cache()
    print(json.dumps({"causal_train": out, "card": card}))
    return out


SV_B, SV_SECONDS = 4, 3            # phase 19's utterances: 4 x 3 s
SV_TOL = 1e-4                      # ECAPA embeddings, card against CPU: rtol, atol x max |emb|;
                                   # similarities: atol (card against CPU, CLI card against cpu)
SSL_RTOL, SSL_ATOL = 2e-3, 3e-4    # SSL hidden states, card against CPU (atol x max |h|): the
                                   # tests' tolerance (tests/test_wavlm.py), scaled to the state
SSL_CPU_SECONDS, SSL_F64_SECONDS = 4, 10
# microsoft/wavlm-large's config.json (conv stages, pos conv and the rest at
# WavLMConfig's defaults: seven 512-channel stages, k 128 in 16 groups)
WAVLM_LARGE = dict(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
                   intermediate_size=4096, feat_extract_norm="layer", conv_bias=True,
                   do_stable_layer_norm=True, num_buckets=320, max_bucket_distance=800)
# a base layout (facebook/hubert-base-ls960's config.json)
HUBERT_BASE = dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                   intermediate_size=3072, feat_extract_norm="group", conv_bias=False,
                   do_stable_layer_norm=False)


def sv_features64(wav, feat_type: str):
    """ECAPA's fbank / MFCC frontend in float64 on ``wav``'s device, the
    reference of the precision rule: models/ecapa_tdnn.py's framing
    (reflection padding, a 25 ms Hann window centred in 512, 10 ms hop) with
    torch.stft in float64, and its fp32 mel and DCT matrices as constants
    (ops/stft.py::stft computes in fp32 whatever the input)."""
    import torch
    import torch.nn.functional as F
    from audiotokenization_tpu_torch.models import ecapa_tdnn as E
    from audiotokenization_tpu_torch.ops.stft import hann_window, reflect_pad

    dev = wav.device
    window = F.pad(hann_window(400, device=dev).double(), (56, 56))
    s = torch.stft(reflect_pad(wav.double(), 256), 512, hop_length=160, win_length=512,
                   window=window, center=False, return_complex=True)
    power = s.real ** 2 + s.imag ** 2
    if feat_type == "fbank":
        mel = torch.einsum("mf,bft->bmt", E._htk_mels(SR, 512, 80, float(SR // 2), dev).double(),
                           power)
        return torch.log(mel + 1e-6)
    mel = torch.einsum("mf,bft->bmt", E._htk_mels(SR, 512, 128, SR / 2.0, dev).double(), power)
    db = 10.0 * torch.log10(mel.clamp_min(1e-10))
    db = torch.maximum(db, db.amax(dim=(-2, -1), keepdim=True) - 80.0)
    return torch.einsum("km,bmt->bkt", E._dct_ortho(40, 128, dev).double(), db) + 1e-6


def sv_wavs(seed: int = 19):
    """Seeded speech-like waveforms (SV_B, SV_SECONDS x 16 kHz): a voiced
    tone under a syllable-rate envelope, in noise."""
    import numpy as np

    rng = np.random.RandomState(seed)
    t = np.arange(SV_SECONDS * SR) / SR
    rows = []
    for _ in range(SV_B):
        env = np.clip(np.sin(2 * np.pi * rng.uniform(2, 5) * t + rng.uniform(0, 6)), 0, None) ** 2
        rows.append(env * (0.5 * np.sin(2 * np.pi * rng.uniform(100, 250) * t)
                           + 0.5 * rng.randn(t.size)) * 0.3 + 0.003 * rng.randn(t.size))
    return np.asarray(rows, np.float32)


def ecapa_embed(model, wav, feat_type: str, **kw):
    """Embeddings of ``wav`` through the frontend, fp32 with TF32 off."""
    import torch
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.models import ecapa_tdnn as E

    with torch.no_grad(), C.full_fp32():
        return E.ecapa_tdnn_embed(model, E.extract_features(wav, feat_type=feat_type, **kw))


def hold_embeddings(name, got, want):
    """Fatal unless ``got`` is finite and within rtol / atol SV_TOL x max
    |want| of ``want``; returns max |got - want|."""
    import torch

    err = (got - want).abs().max().item()
    if not torch.isfinite(got).all() or not torch.allclose(
            got, want, rtol=SV_TOL, atol=SV_TOL * want.abs().max().item()):
        fail(f"{name}: embeddings off the CPU's by {err:.3g} (rtol / atol {SV_TOL:g} x max |emb|)")
    return err


def sv_ecapa(wav_np):
    """19a. ECAPA-TDNN at init_ecapa_tdnn's defaults (channels 512, emb 192,
    scale 8, attention 128) from seed 0 on fbank (80) and MFCC (40): the
    card's embeddings against the CPU's, and against a float64 forward on
    the card (frontend included) no more than F64_RATIO times as far off as
    the CPU's fp32; ms per utterance. Returns (rows, {feat: (cpu, card)})."""
    import torch
    from audiotokenization_tpu_torch.models import ecapa_tdnn as E

    wav_cpu = torch.from_numpy(wav_np)
    wav = wav_cpu.cuda()
    rows, models = {}, {}
    for feat, n_mels in (("fbank", 80), ("mfcc", 40)):
        cpu = E.init_ecapa_tdnn(torch.Generator().manual_seed(0), n_mels=n_mels, device="cpu")
        card_model = copy.deepcopy(cpu).cuda()
        got = ecapa_embed(card_model, wav, feat).cpu()
        want = ecapa_embed(cpu, wav_cpu, feat)
        err = hold_embeddings(f"ECAPA {feat}", got, want)
        m64 = copy.deepcopy(cpu).double().cuda()
        with torch.no_grad():
            ref = E.ecapa_tdnn_embed(m64, sv_features64(wav, feat)).cpu()
        del m64
        card_err = (got.double() - ref).abs().max().item()
        cpu_err = (want.double() - ref).abs().max().item()
        print(f"ECAPA {feat}: max |card - cpu| = {err:.3g}, max |card - f64| = {card_err:.3g}, "
              f"max |cpu32 - f64| = {cpu_err:.3g}")
        if card_err > F64_RATIO * cpu_err:
            fail(f"ECAPA {feat}: {card_err:.3g} off float64 on the card, more than "
                 f"{F64_RATIO:g}x the CPU fp32's {cpu_err:.3g}")
        ms = cuda_ms(lambda: ecapa_embed(card_model, wav, feat), iters=5)
        rows[feat] = {"n_mels": n_mels, "parameters": sum(p.numel() for p in cpu.parameters()),
                      "max_abs_err_vs_cpu": err, "max_abs_emb": want.abs().max().item(),
                      "max_abs_err_card_vs_f64": card_err, "max_abs_err_cpu32_vs_f64": cpu_err,
                      "ratio": card_err / cpu_err, "ms_per_utterance": ms / SV_B,
                      "batch_ms": ms}
        models[feat] = (cpu, card_model)
    return rows, models


def ssl_hf_state_dict(family: str, shape: dict, seed: int) -> dict:
    """Random weights of ``family`` (wavlm | wav2vec2 | hubert |
    unispeech_sat) at ``shape`` under the transformers names (the pos conv's
    weight norm as ``parametrizations.weight.original0/1``), CPU tensors
    from numpy draws of ``seed``: linear and conv weights N(0, 1 / fan_in),
    biases N(0, 0.02²), norms 1 + N(0, 0.1²) / N(0, 0.1²), the relative
    position embedding N(0, 0.1²)."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    from audiotokenization_tpu_torch.models.wavlm import WavLMConfig

    cfg = (WavLMConfig if family == "wavlm" else Wav2Vec2Config)(**shape)
    rng = np.random.default_rng(seed)
    sd = {}

    def normal(*shape, std):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * np.float32(std))

    def lin(name, n_out, n_in):
        sd[name + ".weight"] = normal(n_out, n_in, std=n_in ** -0.5)
        sd[name + ".bias"] = normal(n_out, std=0.02)

    def ln(name, n):
        sd[name + ".weight"] = 1 + normal(n, std=0.1)
        sd[name + ".bias"] = normal(n, std=0.1)

    cin = 1
    for i, (c, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        pre = f"feature_extractor.conv_layers.{i}"
        sd[pre + ".conv.weight"] = normal(c, cin, k, std=(cin * k) ** -0.5)
        if cfg.conv_bias:
            sd[pre + ".conv.bias"] = normal(c, std=0.02)
        if cfg.feat_extract_norm == "layer" or i == 0:
            ln(pre + ".layer_norm", c)
        cin = c
    H, heads = cfg.hidden_size, cfg.num_attention_heads
    ln("feature_projection.layer_norm", cin)
    lin("feature_projection.projection", H, cin)
    pc = "encoder.pos_conv_embed.conv"
    k, groups = cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups
    sd[pc + ".parametrizations.weight.original0"] = torch.from_numpy(
        rng.uniform(0.5, 1.5, (1, 1, k)).astype(np.float32))
    sd[pc + ".parametrizations.weight.original1"] = normal(H, H // groups, k, std=1.0)
    sd[pc + ".bias"] = normal(H, std=0.02)
    ln("encoder.layer_norm", H)
    for i in range(cfg.num_hidden_layers):
        pre = f"encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(f"{pre}.attention.{n}", H, H)
        if family == "wavlm":
            lin(f"{pre}.attention.gru_rel_pos_linear", 8, H // heads)
            sd[f"{pre}.attention.gru_rel_pos_const"] = 1 + normal(1, heads, 1, 1, std=0.1)
            if i == 0:
                sd[f"{pre}.attention.rel_attn_embed.weight"] = normal(cfg.num_buckets, heads,
                                                                      std=0.1)
        ln(f"{pre}.layer_norm", H)
        lin(f"{pre}.feed_forward.intermediate_dense", cfg.intermediate_size, H)
        lin(f"{pre}.feed_forward.output_dense", H, cfg.intermediate_size)
        ln(f"{pre}.final_layer_norm", H)
    return sd


def ssl_split(fn):
    """torch.profiler split of one call of ``fn`` through an SSL upstream:
    device ms of the kernels inside the device-side spans of the conv
    feature encoder, the positional conv, the attention (projections, gate,
    softmax) and the FFN (models/wavlm.py's functions), of every GEMM
    kernel, the rest, and the idle share of the call's wall time (the
    profiler's overhead included). Late in the whole script the profiler
    has shown none of the conv encoder's kernels: sv_ssl also times the
    encoder alone with CUDA events."""
    import torch
    from audiotokenization_tpu_torch.models import wavlm as W
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    parts = ("feature_encoder", "_pos_conv_embed", "_attention", "_feed_forward")
    with annotated([(W, n) for n in parts]):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    dev = [e for e in events if not e[0].startswith("cs.")]

    def inside(n):
        """The kernels whose midpoint lies in a device-side span of range n."""
        spans = [(a, b) for name, a, b in events if name == f"cs.{n}"]
        return [e for e in dev if any(a <= (e[1] + e[2]) / 2 <= b for a, b in spans)]

    ranged = {n: _busy_ms(inside(n)) for n in parts}
    busy = _busy_ms(dev)
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "conv_encoder_ms": ranged["feature_encoder"], "pos_conv_ms": ranged["_pos_conv_embed"],
            "attention_ms": ranged["_attention"], "ffn_ms": ranged["_feed_forward"],
            "gemm_ms": _busy_ms([e for e in dev if "gemm" in e[0].lower()
                                 or "xmma" in e[0].lower()]),
            "other_ms": max(busy - sum(ranged.values()), 0.0), "idle_share": 1 - busy / wall_ms,
            "device_kernels": len(dev)}


def hold_hiddens(name, got, want):
    """Each hidden state of ``got`` within rtol SSL_RTOL / atol SSL_ATOL x
    max |h| of ``want``'s (fatal); returns the largest error relative to
    that state's max |h|."""
    import torch

    worst = 0.0
    if len(got) != len(want):
        fail(f"{name}: {len(got)} hidden states, the CPU {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        scale = w.abs().max().item()
        worst = max(worst, (g - w).abs().max().item() / scale)
        if g.shape != w.shape or not torch.isfinite(g).all() or not torch.allclose(
                g, w, rtol=SSL_RTOL, atol=SSL_ATOL * scale):
            fail(f"{name}: hidden state {i} off the CPU's ({tuple(g.shape)}, "
                 f"max |d| / max |h| = {(g - w).abs().max().item() / scale:.3g})")
    return worst


def sv_ssl(root: Path, wav_np):
    """19b. WavLM-Large and a HuBERT base layout at published widths from
    numpy draws, written as transformers state dicts and loaded through
    load_ssl_upstream: every hidden state on the card against the CPU's
    (1 x 4 s) and against float64 on the card (1 x 10 s, no more than
    F64_RATIO x the CPU fp32's error); ms per 10 s utterance and a
    torch.profiler split; then ECAPA over the WavLM-Large frontend (1024
    mels, 25 layer weights) on 4 x 3 s against the CPU. Returns (rows, the
    WavLM-Large file)."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.models import ecapa_tdnn as E
    from audiotokenization_tpu_torch.models import wav2vec2 as V
    from audiotokenization_tpu_torch.models import wavlm as W

    rows, large_file = {}, None
    rng = np.random.RandomState(23)
    x4 = torch.from_numpy((rng.randn(1, SSL_CPU_SECONDS * SR) * 0.1).astype(np.float32))
    x10 = torch.from_numpy((rng.randn(1, SSL_F64_SECONDS * SR) * 0.1).astype(np.float32))
    for name, family, shape, seed in (("wavlm_large", "wavlm", WAVLM_LARGE, 1),
                                      ("hubert_base", "hubert", HUBERT_BASE, 2)):
        sd = ssl_hf_state_dict(family, shape, seed)
        path = root / f"{name}.bin"
        t0 = time.perf_counter()
        torch.save(sd, path)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fn, cfg = V.load_ssl_upstream(torch.load(path, map_location="cpu", weights_only=True),
                                      family)
        load_s = time.perf_counter() - t0
        fn_cpu, _ = V.load_ssl_upstream(sd, family, device="cpu")
        del sd
        if any(getattr(cfg, k) != v for k, v in shape.items()):
            fail(f"{name}: the config inferred from its state dict, {cfg}, is not {shape}")
        with torch.no_grad(), C.full_fp32():
            got = [h.cpu() for h in fn(x4.cuda())]
            want = fn_cpu(x4)
            err4 = hold_hiddens(f"{name} 1 x {SSL_CPU_SECONDS} s", got, want)
            got10 = [h.cpu() for h in fn(x10.cuda())]
            cpu10 = fn_cpu(x10)
            conv_card = W.feature_encoder(fn.model, x10.cuda()).cpu()
            conv_cpu = W.feature_encoder(fn_cpu.model, x10)
        m64 = copy.deepcopy(fn_cpu.model).double().cuda()
        with torch.no_grad():
            ref = [h.cpu() for h in W.encoder_apply(m64, x10.double().cuda())]
            conv_ref = W.feature_encoder(m64, x10.double().cuda()).cpu()
        del m64
        card_errs = [(g.double() - r).abs().max().item() for g, r in zip(got10, ref)]
        cpu_errs = [(c.double() - r).abs().max().item() for c, r in zip(cpu10, ref)]
        card_err, cpu_err = max(card_errs), max(cpu_errs)
        conv_ratio = ((conv_card.double() - conv_ref).abs().max().item()
                      / (conv_cpu.double() - conv_ref).abs().max().item())
        print(f"{name}: max |card - cpu| / max |h| = {err4:.3g} at {SSL_CPU_SECONDS} s; at "
              f"{SSL_F64_SECONDS} s max |card - f64| = {card_err:.3g}, max |cpu32 - f64| = "
              f"{cpu_err:.3g}")
        if card_err > F64_RATIO * cpu_err:
            fail(f"{name} at {SSL_F64_SECONDS} s: {card_err:.3g} off float64 on the card, more "
                 f"than {F64_RATIO:g}x the CPU fp32's {cpu_err:.3g}")
        x10c = x10.cuda()

        def run():
            with torch.no_grad(), C.full_fp32():
                return fn(x10c)

        def conv_encoder():
            with torch.no_grad(), C.full_fp32():
                return W.feature_encoder(fn.model, x10c)

        row = {"family": family, "config": {k: getattr(cfg, k) for k in shape},
               "parameters": sum(p.numel() for p in fn.model.parameters()),
               "frames_10s": got10[0].shape[1], "hidden_states": len(got10),
               "max_rel_err_vs_cpu": err4, "max_abs_err_card_vs_f64": card_err,
               "max_abs_err_cpu32_vs_f64": cpu_err, "ratio": card_err / cpu_err,
               "ratio_by_hidden_state": [a / b for a, b in zip(card_errs, cpu_errs)],
               "conv_encoder_ratio": conv_ratio,
               "ms_per_10s_utterance": cuda_ms(run, iters=3),
               "conv_encoder_event_ms": cuda_ms(conv_encoder, iters=3),
               "state_dict_write_s": write_s, "load_s": load_s, "profile": ssl_split(run)}
        if family == "wavlm":
            large_file = path
            layers = cfg.num_hidden_layers + 1
            ecapa_cpu = E.init_ecapa_tdnn(torch.Generator().manual_seed(0),
                                          n_mels=cfg.hidden_size, device="cpu")
            ecapa_card = copy.deepcopy(ecapa_cpu).cuda()
            fw = torch.from_numpy(np.random.RandomState(29).randn(layers).astype(np.float32))
            wav_cpu = torch.from_numpy(wav_np)
            wav = wav_cpu.cuda()
            got = ecapa_embed(ecapa_card, wav, "ssl", ssl_fn=fn, feature_weight=fw.cuda()).cpu()
            want = ecapa_embed(ecapa_cpu, wav_cpu, "ssl", ssl_fn=fn_cpu, feature_weight=fw)
            ms = cuda_ms(lambda: ecapa_embed(ecapa_card, wav, "ssl", ssl_fn=fn,
                                             feature_weight=fw.cuda()), iters=3)
            row["ecapa"] = {"n_mels": cfg.hidden_size, "layer_weights": layers,
                            "max_abs_err_vs_cpu": hold_embeddings(f"ECAPA over {name}", got, want),
                            "max_abs_emb": want.abs().max().item(),
                            "ms_per_utterance": ms / SV_B, "batch_ms": ms}
            del ecapa_card
        rows[name] = row
        del fn, fn_cpu
        torch.cuda.empty_cache()
    return rows, large_file


def sv_codec_leg(cfg, wav_np, models):
    """19c. Phase 5's flagship codec tokenizes and decodes 4 x 3 s (K1 1 /
    K2 15 a tokenize, K2 15 a decode); the fbank ECAPA of 19a scores each
    original against its reconstruction on the card, no launch, within
    SV_TOL of the CPU's on the same waveforms."""
    import torch
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.models import ecapa_tdnn as E

    nq = cfg.model.codec_decoder.vq_num_quantizers
    n_units = len(cfg.model.codec_encoder.up_ratios) * len(cfg.model.codec_encoder.dilations)
    codec = seeded_codec(cfg)
    wav = torch.from_numpy(wav_np).cuda()
    t0 = time.perf_counter()
    codes, tok = counted(lambda: C.tokenize(codec, wav, mode="conformant"))
    recon, dec = counted(lambda: offline_decode(codec, codes))
    cpu_model, card_model = models["fbank"]
    sim, score = counted(lambda: E.speaker_similarity(card_model, wav, recon[:, 0]))
    wall_s = time.perf_counter() - t0
    expect_launches("phase 19 codec leg: tokenize", tok, (nq, n_units))
    expect_launches("phase 19 codec leg: decode", dec, (0, n_units))
    expect_launches("phase 19 codec leg: scoring", score, (0, 0))
    if tuple(recon.shape) != (SV_B, 1, SV_SECONDS * SR) or not torch.isfinite(recon).all():
        fail(f"phase 19 codec leg: reconstruction {tuple(recon.shape)}")
    sim = sim.cpu()
    want = E.speaker_similarity(cpu_model, wav.cpu(), recon[:, 0].cpu())
    err = (sim - want).abs().max().item()
    print(f"codec leg similarities {sim.tolist()}, the CPU's {want.tolist()}")
    if not torch.isfinite(sim).all() or err > SV_TOL:
        fail(f"phase 19 codec leg: similarities off the CPU's by {err:.3g}")
    score_ms = cuda_ms(lambda: E.speaker_similarity(card_model, wav, recon[:, 0]), iters=5)
    del codec
    torch.cuda.empty_cache()
    return {"similarity": sim.tolist(), "similarity_cpu": want.tolist(),
            "max_abs_err_vs_cpu": err, "score_ms": score_ms, "wall_s": wall_s,
            "launches": {"vq_argmin": tok[0] + dec[0], "residual_unit": tok[1] + dec[1]},
            "launches_per_tokenize": {"vq_argmin": tok[0], "residual_unit": tok[1]},
            "launches_per_decode": {"vq_argmin": dec[0], "residual_unit": dec[1]}}, recon


def sv_cli(root: Path, wav_np, recon, large_file):
    """19d. cli.verification --smoke on WAVs of an original and its
    reconstruction (16 kHz, and both resampled to 22.05 kHz): fbank on both
    pairs, MFCC at 22.05 kHz, and --feat_type ssl --ssl_family wavlm_large
    on 19b's file, each within SV_TOL of the same run with --device cpu, no
    launch; wall times."""
    import torch
    from audiotokenization_tpu_torch.cli import verification
    from audiotokenization_tpu_torch.data.audio_io import write_wav
    from audiotokenization_tpu_torch.ops.resample import resample

    orig, rec = wav_np[0], recon[0, 0].cpu().numpy()
    pairs = {}
    for rate in (SR, 22050):
        paths = []
        for tag, x in (("orig", orig), ("recon", rec)):
            p = root / f"{tag}_{rate}.wav"
            write_wav(p, x if rate == SR else resample(torch.from_numpy(x), SR, rate).numpy(),
                      rate)
            paths.append(str(p))
        pairs[rate] = paths
    runs = (("fbank", SR, []), ("fbank", 22050, []), ("mfcc", 22050, ["--feat_type", "mfcc"]),
            ("ssl_wavlm_large", SR, ["--feat_type", "ssl", "--ssl_family", "wavlm_large",
                                     "--ssl_checkpoint", str(large_file)]))
    rows = []
    for name, rate, extra in runs:
        argv = ["--wav1", pairs[rate][0], "--wav2", pairs[rate][1], "--smoke", *extra]
        t0 = time.perf_counter()
        got, launches = counted(lambda: verification.main(argv))
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = verification.main(argv + ["--device", "cpu"])
        cpu_s = time.perf_counter() - t0
        expect_launches(f"cli.verification {name} at {rate} Hz", launches, (0, 0))
        err = abs(got["similarity"] - want["similarity"])
        if got["trained_weights"] or err > SV_TOL or not -1.0 <= got["similarity"] <= 1.0:
            fail(f"cli.verification {name} at {rate} Hz: {got} on the card, {want} on the CPU")
        rows.append({"feat": name, "rate": rate, "similarity": got["similarity"],
                     "similarity_cpu": want["similarity"], "abs_err_vs_cpu": err,
                     "card_wall_s": card_s, "cpu_wall_s": cpu_s})
    return {"runs": rows, "launches": {"vq_argmin": 0, "residual_unit": 0}}


def speaker_verification_path(cfg, card):
    """19. Speaker verification (models/ecapa_tdnn.py, models/wavlm.py,
    models/wav2vec2.py, cli/verification.py) at full width on random weights
    from seed 0: 19a-d. Prints the speaker_verification line."""
    import shutil
    import tempfile

    import torch

    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_sv_", dir=build_dir))
    wav_np = sv_wavs()
    out = {"utterances": SV_B, "seconds": SV_SECONDS}
    try:
        out["ecapa"], models = sv_ecapa(wav_np)
        out["ssl"], large_file = sv_ssl(root, wav_np)
        out["codec_leg"], recon = sv_codec_leg(cfg, wav_np, models)
        out["cli"] = sv_cli(root, wav_np, recon, large_file)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    print(json.dumps({"speaker_verification": out, "card": card}))
    return out


# ---------------------------------------------------------------------------
# 20: the parallel serving paths (sequence, tensor and pipeline parallelism)
# ---------------------------------------------------------------------------

SP_SECONDS, SP_SHARDS = 60, 4        # one long file, shards on the one card
SP_AA_SECONDS = 10                   # configs/bigcodec_antialias.yaml's file
PAR_REQUESTS, PAR_SECONDS = 4, 10    # the Conformer's TP / PP batch
PAR_MICRO = 4                        # PP's microbatches
PARALLEL_FILES = (2.3, 3.7, 5.15, 6.05)  # the CLIs' WAVs, seconds
SP_AGREEMENT = 0.9                   # reset / fast against the exact tokens (JAX's tests' rule)


def sp_window_shapes(length: int, strides, dilations, widths, *, up: bool = False):
    """(C, T, d) of K2's calls in one SP shard's window: the encoder's units
    at the window's length ``length`` per stride scale, or (``up``) the
    decoder's, whose window at each block is its chunk times the stride plus
    the units' margin (``parallel/sp.py::_sp_block_margins``)."""
    from audiotokenization_tpu_torch.parallel.sp import _sp_block_margins

    shapes = []
    for c, s in zip(widths, strides):
        if up:
            M, _ = _sp_block_margins(s, dilations, False)
            length *= s
            shapes += [(c, length + 2 * M, d) for d in dilations]
        else:
            shapes += [(c, length, d) for d in dilations]
            length //= s
    return shapes


def hold_k1_shard(codec, lat, m: int):
    """K1 against its plain version on one shard's ``m`` frames of the
    quantizer's input (the codec's own book): equal but at top-2 gaps under
    GAP."""
    import torch
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.ops.conv import linear
    from audiotokenization_tpu_torch.ops.cuda.vq_kernel import vq_argmin, vq_argmin_plain

    layer = codec.quantizer.layers[0]
    with C.full_fp32(), torch.no_grad():
        z = linear(lat[0, :, :m].t(), layer.in_proj).contiguous()
        book = layer.codebook.contiguous()
        got, want = vq_argmin(z, book).long(), vq_argmin_plain(z, book).long()
        gap = top2_gap(plain_dist(z, book))
    if ((got != want) & (gap >= GAP)).any():
        fail(f"K1 at the SP shard's {m} x 8192: rows differ at a top-2 gap >= {GAP:g}")
    return int((got != want).sum())


def timed(fn, iters: int = 3):
    return cuda_ms(fn, iters=iters, warmup=1)


def sp_flagship(cfg, dev):
    """20a-b: the flagship's SP tokenize of one SP_SECONDS file over
    SP_SHARDS and over 1 shard on the card, its reset and fast modes, and
    SP synthesize of its codes, against one-device tokenize and decode."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.config import codec_hop
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.parallel.sp import make_sp_synthesizer, make_sp_tokenizer
    from audiotokenization_tpu_torch.utils.chunked import (make_chunked_tokenizer,
                                                           receptive_field_samples)

    codec = seeded_codec(cfg)  # phase 5's weights
    nq = cfg.model.codec_decoder.vq_num_quantizers
    n_units = len(cfg.model.codec_encoder.up_ratios) * len(cfg.model.codec_encoder.dilations)
    wav = torch.from_numpy((np.random.RandomState(20).randn(SP_SECONDS * SR) * 0.1)
                           .astype(np.float32)).cuda()
    with C.full_fp32(), torch.no_grad():
        lat = C.encode(codec, wav[None])
        _, ref, _ = C.quantize(codec, lat)
    gap = frame_gaps(codec, lat)
    out = {"seconds": SP_SECONDS, "shards": SP_SHARDS, "frames": int(ref.shape[-1])}
    for n in (SP_SHARDS, 1):
        tok = make_sp_tokenizer(cfg, [dev] * n)
        codes, launches = counted(lambda: tok(codec, wav))
        expect_launches(f"SP tokenize {SP_SECONDS} s over {n} shard(s)", launches,
                        (n * nq, n * n_units))
        differ, near = hold_codes(f"SP tokenize over {n} shard(s) vs one-device tokenize",
                                  codes[:, None], ref, gap)
        out[f"tokenize_{n}_shards"] = {
            "ms": timed(lambda: tok(codec, wav)), "tokens_differ": differ, "near_ties": near,
            "launches": {"vq_argmin": launches[0], "residual_unit": launches[1]},
            "chunk_samples": sorted(tok.buckets)[0]}
    out["one_device_tokenize_ms"] = timed(lambda: C.tokenize(codec, wav[None]))
    chunked = make_chunked_tokenizer(codec, chunk_seconds=CHUNK_SECONDS)
    out["chunked_10s_ms"] = timed(lambda: chunked(wav))
    for lstm, mode in (("reset", "conformant"), ("exact", "fast")):
        tok = make_sp_tokenizer(cfg, [dev] * SP_SHARDS, lstm=lstm, mode=mode)
        codes, launches = counted(lambda: tok(codec, wav))
        expect_launches(f"SP tokenize {lstm} {mode}", launches,
                        (SP_SHARDS * nq, SP_SHARDS * n_units))
        agree = float((codes == ref[:, 0]).float().mean())
        print(f"SP tokenize lstm={lstm} mode={mode}: {agree:.4f} of the tokens agree with "
              "one-device conformant")
        if agree <= SP_AGREEMENT:
            fail(f"SP tokenize lstm={lstm} mode={mode}: agreement {agree:.4f} <= {SP_AGREEMENT}")
        out[f"{lstm}_{mode}"] = {"agreement": agree, "ms": timed(lambda: tok(codec, wav))}

    # K1 at a shard's frames; K2 at the windows' shapes (B = 1)
    chunk = out[f"tokenize_{SP_SHARDS}_shards"]["chunk_samples"]
    hop = codec_hop(cfg)
    ctx = -(-receptive_field_samples(cfg) // hop) * hop
    e, d = cfg.model.codec_encoder, cfg.model.codec_decoder
    widths = [e.ngf * 2 ** i for i in range(len(e.up_ratios))]
    enc_shapes = sp_window_shapes(chunk + 2 * ctx, e.up_ratios, e.dilations, widths)
    out["k1_shard_rows_differ"] = hold_k1_shard(codec, lat, chunk // hop)

    # 20b: SP synthesize of the codes
    syn = make_sp_synthesizer(cfg, [dev] * SP_SHARDS)
    codes = ref[:, 0]
    got, launches = counted(lambda: syn(codec, codes))
    expect_launches(f"SP synthesize {out['frames']} frames over {SP_SHARDS} shards", launches,
                    (0, SP_SHARDS * n_units))
    want = offline_decode(codec, ref)[0, 0]
    err = hold_wav("SP synthesize vs one-device decode", got, want)
    L = sorted(syn.buckets)[0]
    dec_widths = [d.upsample_initial_channel // 2 ** (i + 1) for i in range(len(d.up_ratios))]
    dec_shapes = sp_window_shapes(L, d.up_ratios, d.dilations, dec_widths, up=True)
    out["synthesize"] = {"ms": timed(lambda: syn(codec, codes)),
                         "one_device_decode_ms": timed(lambda: offline_decode(codec, ref)),
                         "max_abs_err_wav": err, "chunk_frames": L,
                         "launches": {"vq_argmin": launches[0], "residual_unit": launches[1]}}
    del codec, lat, wav
    torch.cuda.empty_cache()
    out["k2_window_max_abs_err"] = check_k2(enc_shapes + dec_shapes, batch=1,
                                            what="K2 at an SP window, B=1,")
    out["k2_window_shapes"] = {"tokenize": enc_shapes, "synthesize": dec_shapes}
    return out


def sp_antialias(dev):
    """20c: configs/bigcodec_antialias.yaml, SP tokenize and synthesize of
    SP_AA_SECONDS (no K2: its units are anti-aliased)."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.parallel.sp import make_sp_synthesizer, make_sp_tokenizer

    cfg = repo_config("bigcodec_antialias.yaml")
    codec = seeded_codec(cfg)
    wav = torch.from_numpy((np.random.RandomState(21).randn(SP_AA_SECONDS * SR) * 0.1)
                           .astype(np.float32)).cuda()
    with C.full_fp32(), torch.no_grad():
        lat = C.encode(codec, wav[None])
        _, ref, _ = C.quantize(codec, lat)
    tok = make_sp_tokenizer(cfg, [dev] * SP_SHARDS)
    codes, launches = counted(lambda: tok(codec, wav))
    expect_launches("antialias SP tokenize", launches, (SP_SHARDS, 0))
    differ, near = hold_codes("antialias SP tokenize vs one-device tokenize", codes[:, None],
                              ref, frame_gaps(codec, lat))
    syn = make_sp_synthesizer(cfg, [dev] * SP_SHARDS)
    got, syn_launches = counted(lambda: syn(codec, ref[:, 0]))
    expect_launches("antialias SP synthesize", syn_launches, (0, 0))
    err = hold_wav("antialias SP synthesize vs one-device decode", got,
                   offline_decode(codec, ref)[0, 0])
    return {"seconds": SP_AA_SECONDS, "tokens_differ": differ, "near_ties": near,
            "tokenize_ms": timed(lambda: tok(codec, wav)),
            "synthesize_ms": timed(lambda: syn(codec, ref[:, 0])), "max_abs_err_wav": err,
            "launches": {"tokenize": list(launches), "synthesize": list(syn_launches)}}


def tp_pp_conformer(dev):
    """20d: configs/conformer.yaml under TP at 2 and 4 model shards and PP
    at 2 and 3 stages (PAR_MICRO microbatches), configs/conformer_moe.yaml
    under TP 2, against one-device tokenize and decode on the card."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.config import codec_hop
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.parallel.pp import make_pipe_mesh, pp_synthesize, pp_tokenize
    from audiotokenization_tpu_torch.parallel.tp import make_dp_tp_mesh, tp_tokenize

    cfg = repo_config("conformer.yaml")
    codec = seeded_codec(cfg)
    wav = torch.from_numpy((np.random.RandomState(22).randn(PAR_REQUESTS, PAR_SECONDS * SR) * 0.1)
                           .astype(np.float32)).cuda()
    with C.full_fp32(), torch.no_grad():
        lat = C.encode(codec, wav)
        _, ref, _ = C.quantize(codec, lat)
    gap = frame_gaps(codec, lat)
    want = offline_decode(codec, ref)[:, 0]
    out = {"requests": PAR_REQUESTS, "seconds": PAR_SECONDS,
           "one_device_tokenize_ms": timed(lambda: C.tokenize(codec, wav)),
           "one_device_decode_ms": timed(lambda: offline_decode(codec, ref))}
    for n in (2, 4):
        run = tp_tokenize(codec, cfg, make_dp_tp_mesh(n, [dev] * n))
        codes, launches = counted(lambda: run(wav))
        expect_launches(f"TP {n} tokenize", launches, (1, 0))
        differ, near = hold_codes(f"TP {n} tokenize vs one-device tokenize", codes, ref, gap)
        out[f"tp{n}_tokenize"] = {"ms": timed(lambda: run(wav)), "tokens_differ": differ,
                                  "near_ties": near, "launches": list(launches)}
    for n in (2, 3):
        devices = make_pipe_mesh(n, [dev] * n)
        run = pp_tokenize(codec, cfg, devices, n_micro=PAR_MICRO)
        codes, launches = counted(lambda: run(wav))
        expect_launches(f"PP {n} tokenize", launches, (1, 0))
        differ, near = hold_codes(f"PP {n} tokenize vs one-device tokenize", codes, ref, gap)
        syn = pp_synthesize(codec, cfg, devices, n_micro=PAR_MICRO)
        got, syn_launches = counted(lambda: syn(ref))
        expect_launches(f"PP {n} synthesize", syn_launches, (0, 0))
        err = hold_wav(f"PP {n} synthesize vs one-device decode", got, want)
        out[f"pp{n}"] = {"tokenize_ms": timed(lambda: run(wav)), "tokens_differ": differ,
                         "near_ties": near, "synthesize_ms": timed(lambda: syn(ref)),
                         "max_abs_err_wav": err, "launches": {"tokenize": list(launches),
                                                              "synthesize": list(syn_launches)}}
    del codec
    # the MoE Conformer under TP 2: routing against one device, tokens where
    # no routing difference reached the request
    moe_cfg = repo_config("conformer_moe.yaml")
    moe = seeded_codec(moe_cfg)
    run = tp_tokenize(moe, moe_cfg, make_dp_tp_mesh(2, [dev] * 2))
    with C.full_fp32(), torch.no_grad():
        with RouteRecorder() as one:
            lat = C.encode(moe, wav)
            _, ref, _ = C.quantize(moe, lat)
    with RouteRecorder() as split:
        codes, launches = counted(lambda: run(wav))
    expect_launches("MoE TP 2 tokenize", launches, (1, 0))
    layers, reached = routing_differences("MoE TP 2 tokenize", split.routes, one.routes,
                                          PAR_SECONDS * SR // codec_hop(moe_cfg))
    keep = [i for i in range(PAR_REQUESTS) if i not in reached]
    differ = near = 0
    if keep:
        differ, near = hold_codes("MoE TP 2 tokenize vs one-device tokenize", codes[:, keep],
                                  ref[:, keep], frame_gaps(moe, lat[keep]))
    out["moe_tp2_tokenize"] = {
        "ms": timed(lambda: run(wav)), "requests_reached_by_routing": len(reached),
        "routing_differs": sum(r["choice_differs"] + r["kept_differs"] for r in layers),
        "tokens_differ": differ, "near_ties": near, "launches": list(launches)}
    return out


def parallel_clis(cfg, dev):
    """20e: the CLIs' parallel flags on PARALLEL_FILES WAVs under build/,
    with the card listed SP_SHARDS times (``mesh.visible_devices``), against
    the plain CLIs: extract_indices --sequence_parallel (flagship) and
    --tensor_parallel 2 (configs/conformer.yaml), tokens but at top-2 gaps
    under GAP; synthesize --sequence_parallel and --pipeline_parallel 2,
    waveforms within the repo's tolerance."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from audiotokenization_tpu_torch.cli import extract_indices, synthesize
    from audiotokenization_tpu_torch.config import codec_hop
    from audiotokenization_tpu_torch.data.audio_io import read_audio, write_wav
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.parallel import mesh

    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_parallel_", dir=build_dir))
    listed, mesh.visible_devices = mesh.visible_devices, lambda device="cuda": [dev] * SP_SHARDS
    out = {}
    try:
        d = root / "LibriSpeech" / "test-clean" / "19" / "198"
        d.mkdir(parents=True)
        rng = np.random.RandomState(23)
        for i, s in enumerate(PARALLEL_FILES):
            write_wav(d / f"19-198-{i:04d}.wav",
                      (rng.randn(int(s * SR)) * 0.1).astype(np.float32), SR)
        for name, run_cfg, flag in (("flagship", cfg, ["--sequence_parallel"]),
                                    ("conformer", repo_config("conformer.yaml"),
                                     ["--tensor_parallel", "2"])):
            run = root / name
            write_gen_run(run, run_cfg)
            codec = extract_indices.load_model(run, device="cuda")[1]
            common = ["--dataset_root", str(root), "--save_path", str(run), "--dataset_path",
                      "LibriSpeech", "--ext_audio", ".wav", "--subsets", "test-clean"]
            t0 = time.perf_counter()
            extract_indices.main(common + ["--output_folder", "plain"])
            plain_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            _, launches = counted(lambda: extract_indices.main(
                common + ["--output_folder", "parallel", *flag]))
            par_s = time.perf_counter() - t0
            differ = near = 0
            for p in sorted((run / "plain").rglob("*.npy")):
                w = read_audio(d / f"{p.stem}.wav")[0][0]
                w = np.pad(w, (0, -len(w) % codec_hop(run_cfg)))  # as the CLI pads
                with C.full_fp32(), torch.no_grad():
                    lat = C.encode(codec, torch.from_numpy(w)[None].cuda())
                f, n_ = hold_tokens(f"extract {' '.join(flag)} {p.stem} vs plain",
                                    np.load(run / "parallel" / p.relative_to(run / "plain")),
                                    np.load(p), frame_gaps(codec, lat)[0].cpu().numpy())
                differ, near = differ + f, near + n_
            out[f"extract_{name}"] = {"flag": " ".join(flag), "wall_s": par_s,
                                      "plain_wall_s": plain_s, "tokens_differ": differ,
                                      "near_ties": near, "launches": list(launches)}
            flag = ["--sequence_parallel"] if name == "flagship" else ["--pipeline_parallel", "2"]
            args = ["--codec_ckpt", str(run), "--random", "--seconds", "2", "--num_samples", "2",
                    "--seed", "7"]
            plain = synthesize.main(args + ["--out_dir", str(root / f"{name}_synth_plain")])
            t0 = time.perf_counter()
            got, launches = counted(lambda: synthesize.main(
                args + ["--out_dir", str(root / f"{name}_synth_parallel"), *flag]))
            par_s = time.perf_counter() - t0
            err = hold_wav(f"synthesize {' '.join(flag)} vs plain", torch.from_numpy(got),
                           torch.from_numpy(plain))
            out[f"synthesize_{name}"] = {"flag": " ".join(flag), "wall_s": par_s,
                                         "max_abs_err_wav": err, "launches": list(launches)}
            del codec
    finally:
        mesh.visible_devices = listed
        shutil.rmtree(root, ignore_errors=True)
    return out


def parallel_path(cfg, card, dev=None):
    """20. The parallel serving paths on the one card (``dev``, by default
    cuda:0), listed several times (module docstring). Prints the parallel
    line."""
    import torch

    dev = torch.device("cuda", 0) if dev is None else dev
    out = {"sp_flagship": sp_flagship(cfg, dev)}
    out["sp_antialias"] = sp_antialias(dev)
    out["conformer"] = tp_pp_conformer(dev)
    out["clis"] = parallel_clis(cfg, dev)
    print(json.dumps({"parallel": out, "card": card}))
    return out


# -- 21. data parallelism and FSDP ---------------------------------------------------

DP_RANKS = 2                # (b)-(d): ranks on the one card, under gloo on CUDA tensors
DP_SEED = 21                # the global batch's draws
DP_CLI_SECONDS = (1.2, 1.4, 1.6, 1.8, 1.3, 1.5, 1.7, 1.9)  # (d)'s training WAVs
DP_CLI_VAL = 4              # (d)'s validation WAVs (the first four)
DP_CLI_STEPS = 2
DP_TIMED_STEPS = 3          # (a)'s timed steps a turn (bare, DP, DP, bare)


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def smooth_adamw(cfg):
    """A copy of ``cfg`` with phase 8b's optimizer: AdamW eps 1 (an update
    close to lr·g; at eps 1e-8 it is lr·sign(g), and a gradient near eps
    moves it by ~1e-2 x max |update| run to run), no warmup."""
    cfg = copy.deepcopy(cfg)
    t = cfg.train
    for o in (t.gen_optim_params, t.disc_optim_params):
        o.eps = 1.0
    for s in (t.gen_schedule_params, t.disc_schedule_params):
        s.warmup_step = 0
    return cfg


def strict_smooth(cfg):
    """Phase 8b's setting (``smooth_adamw``, fp32_strict), and no
    recomputation, so that K2 launches once a unit and a step (a
    checkpoint's recompute would launch it again)."""
    cfg = smooth_adamw(cfg)
    cfg.train.precision, cfg.train.remat = "fp32_strict", False
    return cfg


_STEP_ONLY = ("precision", "remat", "gen_optim_params", "disc_optim_params",
              "gen_schedule_params", "disc_schedule_params", "tensor_parallel",
              "pipeline_parallel", "pipeline_microbatches")  # read by the step, not the init


def seed0_modules(cfg):
    """The flagship's generator and discriminators from seed 0 on the CPU,
    drawn once a process for configs that differ only in ``_STEP_ONLY``
    (``init_train_state``'s draws) and copied to the card for each state
    (``seed0_state``, which gives the codec ``cfg``: its forward reads the
    precision there)."""
    import torch
    from audiotokenization_tpu_torch.models.codec import Codec
    from audiotokenization_tpu_torch.models.discriminators import Discriminator

    key = dataclasses.asdict(cfg)
    key["train"] = {k: v for k, v in key["train"].items() if k not in _STEP_ONLY}
    key = json.dumps(key, sort_keys=True, default=str)
    if key not in _SEED0:
        g = torch.Generator().manual_seed(0)
        _SEED0.clear()
        _SEED0[key] = (Codec(cfg, generator=g), Discriminator(cfg, generator=g))
    return _SEED0[key]


_SEED0: dict = {}


def seed0_state(cfg, group=None, fsdp=False, model_devices=None):
    """A train state on the card holding ``seed0_modules``' weights
    (``model_devices``: TP's or PP's, ``train.state.train_state``)."""
    from audiotokenization_tpu_torch.train.state import train_state

    gen, disc = seed0_modules(cfg)
    gen = copy.deepcopy(gen).cuda()
    gen.cfg = cfg
    return train_state(cfg, gen, copy.deepcopy(disc).cuda(), group=group, fsdp=fsdp,
                       model_devices=model_devices)


def dp_wav(b: int):
    import numpy as np

    return (np.random.RandomState(DP_SEED).randn(b, SR) * 0.1).astype(np.float32)


def full_leaves(state):
    """Every parameter and buffer of both modules on the CPU, from the
    one-card state dict (FSDP gathers its cuts)."""
    sd = state.state_dict()
    return {f"{side}.{k}": v.detach().cpu().clone() for side in ("gen", "disc")
            for k, v in sd[side].items()}


def hold_metrics(what, got, want, rtol=STEP_RTOL):
    import numpy as np

    worst = 0.0
    for key, w in want.items():
        g = got[key]
        if key == "codebook_hist":
            if float(g.sum()) != float(w.sum()):
                fail(f"{what}: the codebook histograms count different totals")
            continue
        g, w = float(g), float(w)
        worst = max(worst, abs(g - w) / max(abs(w), 1e-30))
        if not (np.isfinite(g) and abs(g - w) <= rtol * abs(w)):
            fail(f"{what}: {key} {g!r} against {w!r}")
    return worst


def dp_world1(cfg, group):
    """(a) One rank under NCCL (``group``): the bf16 DP step at 32 x 1 s
    against the step without a group, both from seed 0 (cuDNN
    deterministic): the reduction must leave every gradient and metric bit
    for bit as it found them (at world size 1 it is the identity), and the
    step's metrics and update hold the bare step's by phase 8b's rule (the
    rest of the step's atomics order its sums run to run); then DP and bare
    steps in turns (bare, DP, DP, bare; DP_TIMED_STEPS timed each after 2
    warm-ups), the reduction (the
    gradient buckets and the metrics) timed by CUDA events inside the DP
    steps. AdamW at eps 1 and no warmup (``smooth_adamw``: the same work a
    step)."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.parallel import dp
    from audiotokenization_tpu_torch.parallel.fsdp import ShardedParams
    from audiotokenization_tpu_torch.train.step import make_train_step

    t0 = time.perf_counter()
    cfg = smooth_adamw(cfg)
    wav = torch.from_numpy(dp_wav(B)).cuda()
    steps, before = {}, {}
    moved = {"grads": 0.0, "metrics": 0.0}
    reduce_orig, metrics_orig = ShardedParams.reduce, dp.reduce_metrics

    def checked_reduce(sync):
        grads = [p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                 for p in sync.params]
        reduce_orig(sync)
        moved["grads"] = max([moved["grads"]] + [(p.grad - g).abs().max().item()
                                                 for p, g in zip(sync.params, grads)])

    def checked_metrics(metrics, grp):
        out = metrics_orig(metrics, grp)
        moved["metrics"] = max([moved["metrics"]] + [
            (out[k].float() - metrics[k].float()).abs().max().item()
            for k in metrics if torch.is_tensor(metrics[k])])
        return out

    def one(grp, name):
        state = seed0_state(cfg, group=grp)
        if not before:
            before.update(full_leaves(state))
        step = make_train_step(cfg, group=grp)
        m = step(state, {"wav": wav})
        torch.cuda.synchronize()
        steps[name] = (step, state)  # timed below, from this step on
        return ({k: (v.cpu() if torch.is_tensor(v) else v) for k, v in m.items()},
                full_leaves(state))

    ShardedParams.reduce, dp.reduce_metrics = checked_reduce, checked_metrics
    try:
        with torch.backends.cudnn.flags(deterministic=True, benchmark=False):
            (m1, l1), (m_dp, l_dp) = one(None, "bare"), one(group, "dp")
    finally:
        ShardedParams.reduce, dp.reduce_metrics = reduce_orig, metrics_orig
    if moved["grads"] or moved["metrics"]:
        fail(f"(a) the reduction at world size 1 moved a gradient by {moved['grads']:.3g} or a "
             f"metric by {moved['metrics']:.3g}: it must be the identity")
    worst_metric = hold_metrics("(a) DP at world size 1", m_dp, m1)
    w, leaf = hold_updates("(a) DP at world size 1", before, l1, l_dp)
    out = {"batch": [B, SR], "precision": cfg.train.precision, "backend": "nccl",
           "adamw_eps": 1.0, "reduction_moved": moved, "worst_metric_rel": worst_metric,
           "worst_update_rel": w, "worst_update_leaf": leaf,
           "compare_s": time.perf_counter() - t0}
    del l1, l_dp, before
    t0 = time.perf_counter()

    events = []

    def timed(fn):
        def run(*a, **kw):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            res = fn(*a, **kw)
            e.record()
            events.append((s, e))
            return res
        return run

    for step, state in steps.values():
        for _ in range(TRAIN_WARMUP - 1):  # the compared step was the first
            step(state, {"wav": wav})
    torch.cuda.synchronize()
    ms = {"bare": [], "dp": []}
    reduce_ms = []
    for name in ("bare", "dp", "dp", "bare"):
        step, state = steps[name]
        if name == "dp":
            ShardedParams.reduce, dp.reduce_metrics = timed(reduce_orig), timed(metrics_orig)
        try:
            ms[name].append(timed_steps(step, state, wav, n=DP_TIMED_STEPS)[0])
        finally:
            ShardedParams.reduce, dp.reduce_metrics = reduce_orig, metrics_orig
        if name == "dp":
            reduce_ms.append(sum(s.elapsed_time(e) for s, e in events) / DP_TIMED_STEPS)
            events.clear()
    del steps
    torch.cuda.empty_cache()
    dp_ms = float(np.mean(ms["dp"]))
    return {**out, "bare_ms_per_step": ms["bare"], "dp_ms_per_step": ms["dp"],
            "reduce_ms_per_step": reduce_ms, "reduce_share": float(np.mean(reduce_ms)) / dp_ms,
            "dp_over_bare": dp_ms / float(np.mean(ms["bare"])),
            "timed_s": time.perf_counter() - t0}


def strict_reference(cfg_base, group):
    """The one-process fp32_strict step (phase 8b's setting) on the 32 x 1 s
    batch from seed 0: (metrics, leaves before, after); and FSDP over
    ``group``'s one NCCL rank from the same weights held against it by
    phase 8b's rule (its clip sums the squares another way)."""
    import torch
    from audiotokenization_tpu_torch.train.step import make_train_step

    t_all = time.perf_counter()
    cfg = strict_smooth(cfg_base)
    wav = torch.from_numpy(dp_wav(B)).cuda()
    out = {}
    for name, grp in (("one_process", None), ("fsdp_world_1", group)):
        state = seed0_state(cfg, group=grp, fsdp=grp is not None)
        if grp is None:
            before = full_leaves(state)
        t0 = time.perf_counter()
        m = make_train_step(cfg, group=grp)(state, {"wav": wav})
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        out[name] = ({k: (v.cpu() if torch.is_tensor(v) else v) for k, v in m.items()},
                     full_leaves(state), step_s)
        del state
        torch.cuda.empty_cache()
    (m_ref, after, ref_s), (m_fs, l_fs, fs_s) = out["one_process"], out["fsdp_world_1"]
    w, leaf = hold_updates("(a) FSDP at world size 1", before, after, l_fs)
    fsdp1 = {"worst_metric_rel": hold_metrics("(a) FSDP at world size 1", m_fs, m_ref),
             "worst_update_rel": w, "worst_update_leaf": leaf, "s": fs_s,
             "with_the_one_process_step_s": time.perf_counter() - t_all}
    return (m_ref, before, after, ref_s), fsdp1


def dp_rank(rank: int, out_dir: str):
    """(b)-(c) on one rank (a torchrun process of its own): the fp32_strict
    DP step, then the FSDP one, each on this rank's 16 rows of the 32 x 1 s
    batch from seed 0, under gloo on CUDA tensors, over a group of its own
    (a file rendezvous under <out_dir>, apart from torchrun's store, which
    (d)'s CLI takes next); their launches, times and memory (less what was
    allocated before the state: ``base_gb``) to <out_dir>/rank<r>.json,
    rank 0's metrics and state to <out_dir>/<kind>.pt."""
    import gc

    import torch
    import torch.distributed as dist
    from audiotokenization_tpu_torch.config import Config
    from audiotokenization_tpu_torch.ops.cuda.residual_unit_kernel import fused_residual_unit
    from audiotokenization_tpu_torch.ops.cuda.vq_kernel import vq_argmin
    from audiotokenization_tpu_torch.parallel.mesh import shard_batch
    from audiotokenization_tpu_torch.train.step import make_train_step

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{Path(out_dir) / 'rendezvous'}",
                            rank=rank, world_size=DP_RANKS)
    group = dist.group.WORLD
    cfg = strict_smooth(Config())
    local = shard_batch({"wav": torch.from_numpy(dp_wav(B))}, group)["wav"].cuda()
    out = {"rank": rank, "rows": int(local.shape[0])}
    seed0_modules(cfg)
    out["init_s"] = time.perf_counter() - t0
    for kind in ("dp", "fsdp"):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()  # what the previous kind left behind
        state = seed0_state(cfg, group=group, fsdp=kind == "fsdp")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rest = torch.cuda.memory_allocated() - base
        step = make_train_step(cfg, group=group)
        vq_argmin.launches = fused_residual_unit.launches = 0
        t1 = time.perf_counter()
        metrics = step(state, {"wav": local})
        torch.cuda.synchronize()
        out[kind] = {"s": time.perf_counter() - t1,
                     "launches": [vq_argmin.launches, fused_residual_unit.launches],
                     "base_gb": base / 1e9, "before_step_gb": rest / 1e9,
                     "after_step_gb": (torch.cuda.memory_allocated() - base) / 1e9,
                     "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
                     "sharded_leaves": (len(state.gen_opt.sync.sharded())
                                        + len(state.disc_opt.sync.sharded())
                                        if kind == "fsdp" else 0)}
        leaves = full_leaves(state)  # a collective under FSDP: every rank
        if rank == 0:
            torch.save({"metrics": {k: (v.cpu() if torch.is_tensor(v) else v)
                                    for k, v in metrics.items()}, "leaves": leaves},
                       Path(out_dir) / f"{kind}.pt")
        del state, leaves, metrics
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    out["s"] = time.perf_counter() - t0
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))


def dp_check_ranks(cfg, reference, out_dir: Path):
    """(b) and (c): the rank processes' results (``dp_rank``) held against
    ``reference``, the one-process step (``strict_reference``)."""
    import torch

    m_ref, before, after, ref_s = reference
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(DP_RANKS)]
    res = {"ranks": ranks, "one_process_s": ref_s,
           "backend": "gloo (CUDA tensors; two ranks on one card)"}
    nq = cfg.model.codec_decoder.vq_num_quantizers
    n_units = 2 * len(cfg.model.codec_encoder.up_ratios) * len(cfg.model.codec_encoder.dilations)
    for kind in ("dp", "fsdp"):
        for r in ranks:
            if r[kind]["launches"] != [nq, n_units]:
                fail(f"({'b' if kind == 'dp' else 'c'}) rank {r['rank']} launched K1 / K2 "
                     f"{r[kind]['launches']} times in one step, not {[nq, n_units]}")
        got = torch.load(out_dir / f"{kind}.pt", weights_only=False)
        res[kind] = {"worst_metric_rel": hold_metrics(f"({kind}) against one process",
                                                      got["metrics"], m_ref)}
        w, leaf = hold_updates(f"({kind}) against one process", before, after, got["leaves"])
        res[kind].update(worst_update_rel=w, worst_update_leaf=leaf)
        if kind == "fsdp":  # FSDP against (b)'s DP update, the same rule
            dp_leaves = torch.load(out_dir / "dp.pt", weights_only=False)["leaves"]
            w, leaf = hold_updates("(c) FSDP against DP", before, dp_leaves, got["leaves"])
            res[kind].update(worst_update_rel_vs_dp=w, worst_update_leaf_vs_dp=leaf)
            if not all(r["fsdp"]["sharded_leaves"] > 0 for r in ranks):
                fail("(c) FSDP sharded no leaf")
            for r in ranks:  # one block's cuts gathered at a time
                if r["fsdp"]["peak_gb"] >= r["dp"]["peak_gb"]:
                    fail(f"(c) rank {r['rank']}: FSDP's peak {r['fsdp']['peak_gb']:.3f} GB is "
                         f"not below DP's {r['dp']['peak_gb']:.3f} GB")
            res[kind]["peak_gb_vs_dp"] = [[r["fsdp"]["peak_gb"], r["dp"]["peak_gb"]]
                                          for r in ranks]
            res[kind]["rest_gb_vs_dp"] = [[r["fsdp"]["before_step_gb"], r["dp"]["before_step_gb"]]
                                          for r in ranks]
    return res


def dp_rank_then_cli(out_dir: str, argv):
    """A torchrun rank of phase 21: (b)-(c) (``dp_rank``), then (d):
    cli.train.main on ``argv``, whose K1 / K2 launches go to
    <out_dir>/cli_rank<LOCAL_RANK>.json."""
    import os

    import torch
    from audiotokenization_tpu_torch.cli import train as cli
    from audiotokenization_tpu_torch.ops.cuda.residual_unit_kernel import fused_residual_unit
    from audiotokenization_tpu_torch.ops.cuda.vq_kernel import vq_argmin

    dp_rank(int(os.environ["RANK"]), out_dir)
    _SEED0.clear()
    torch.cuda.empty_cache()
    vq_argmin.launches = fused_residual_unit.launches = 0
    t0 = time.perf_counter()
    cli.main(argv)
    (Path(out_dir) / f"cli_rank{os.environ['LOCAL_RANK']}.json").write_text(json.dumps(
        {"launches": [vq_argmin.launches, fused_residual_unit.launches],
         "s": time.perf_counter() - t0}))


def cli_run(name: str, cfg_base, seed: int, steps: int):
    """A cli.train run of phases 21d / 22e: DP_CLI_SECONDS's WAVs from
    ``seed`` under build/chip_smoke_<name>_*, the first DP_CLI_VAL for
    validation, ``cfg_base`` at 2 x 1 s a rank with a sanity batch,
    validation and a checkpoint at ``steps`` (SI-SNR and the histogram:
    STOI / PESQ are phase 9's). Returns (root, cfg, the CLI's arguments)."""
    import numpy as np
    from audiotokenization_tpu_torch.config import save_config
    from audiotokenization_tpu_torch.data.audio_io import write_wav

    root = Path(__file__).resolve().parent / "build" / f"chip_smoke_{name}_{int(time.time())}"
    root.mkdir(parents=True)
    rng = np.random.RandomState(seed)
    files = []
    for i, sec in enumerate(DP_CLI_SECONDS):
        files.append(root / f"clip{i}.wav")
        write_wav(files[-1], (rng.randn(int(sec * SR)) * 0.1).astype(np.float32), SR)
    (root / "train.txt").write_text("\n".join(map(str, files)))
    (root / "val.txt").write_text("\n".join(map(str, files[:DP_CLI_VAL])))
    cfg = copy.deepcopy(cfg_base)
    t, d = cfg.train, cfg.dataset
    t.log_every_n_steps, t.num_sanity_val_steps = 1, 1
    t.val_every_n_steps = t.checkpoint_every_n_steps = steps
    d.train.filelist, d.val.filelist, d.test.filelist = str(root / "train.txt"), str(
        root / "val.txt"), None
    d.train.batch_size = d.val.batch_size = 2
    d.train.min_audio_length = d.val.min_audio_length = SR
    d.val.quality_metric_items = 0
    save_config(cfg, root / "cfg.json")
    return root, cfg, ["--config", str(root / "cfg.json"), "--run_dir", str(root / "run"),
                       "--no_wandb", "--skip_test"]


def torchrun_ranks(flag: str, root: Path, args) -> float:
    """This script as DP_RANKS torchrun ranks (``flag``: the rank's entry,
    ``root``: its output dir, ``args``: its CLI arguments) on the card;
    returns the launch's seconds, failing on a rank's error."""
    import os

    script = Path(__file__).resolve()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", f"--nproc_per_node={DP_RANKS}",
         f"--master_port={free_port()}", str(script), flag, str(root), *args],
        cwd=str(script.parent), env={**os.environ, "OMP_NUM_THREADS": "1"}, timeout=600)
    if proc.returncode:
        fail(f"{flag} torchrun exited {proc.returncode}")
    return time.perf_counter() - t0


def hold_cli_run(what: str, cfg, run: Path, ranks, want_per_forward, steps: int):
    """A torchrun cli.train run: each rank's K1 / K2 launches
    ``want_per_forward`` a forward (its steps, sanity and validation
    batches), one validation line, the checkpoint at ``steps``, no
    non-finite value. Returns the forwards a rank ran."""
    import numpy as np

    t, d = cfg.train, cfg.dataset
    forwards = steps + t.num_sanity_val_steps + DP_CLI_VAL // DP_RANKS // d.val.batch_size
    want = [w * forwards for w in want_per_forward]
    for r in ranks:
        if r["launches"] != want:
            fail(f"{what} a torchrun rank launched K1 / K2 {r['launches']} times, not {want} "
                 f"({steps} steps and {forwards - steps} validation batches)")
    logs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    if sum("val_si_snr" in rec for rec in logs) != 1 or not (run / "ckpt" / str(steps)
                                                            / "state.pt").is_file():
        fail(f"{what} the torchrun run logged no single validation or wrote no checkpoint")
    bad = [k for rec in logs for k, v in rec.items() if isinstance(v, float)
           and not np.isfinite(v)]
    if bad:
        fail(f"{what} non-finite logged values: {bad}")
    return forwards


def resume_cli(what: str, args, run: Path, steps: int) -> float:
    """cli.train on ``args`` in this process to one step past ``steps``;
    fails unless metrics.jsonl then logs steps 1 to steps + 1. Returns its
    seconds."""
    import torch
    from audiotokenization_tpu_torch.cli import train as cli

    t0 = time.perf_counter()
    cli.main(args + ["--max_steps", str(steps + 1)])
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    logged = [json.loads(line)["step"] for line in (run / "metrics.jsonl").read_text()
              .splitlines() if "gen_loss" in line]
    if logged != list(range(1, steps + 2)):
        fail(f"{what} the resume in one process logged steps {logged}")
    return resume_s


def dp_ranks_and_cli(cfg_base, reference):
    """(b)-(d) in one torchrun launch of two ranks on the card: each rank
    runs (b)-(c) (``dp_rank``), checked here against ``reference``, then
    cli.train (--dist_backend gloo): DP_CLI_STEPS bf16 steps of the flagship
    at 2 x 1 s a rank on DP_CLI_SECONDS's WAVs with a sanity batch,
    validation and a checkpoint at the last step; then a resume in one
    process to one more step."""
    root, cfg, args = cli_run("dp", cfg_base, DP_SEED, DP_CLI_STEPS)
    run = root / "run"
    torchrun_s = torchrun_ranks("--dp-ranks", root, args + [
        "--dist_backend", "gloo", "--max_steps", str(DP_CLI_STEPS)])
    two_ranks = dp_check_ranks(cfg_base, reference, root)
    ranks = [json.loads((root / f"cli_rank{r}.json").read_text()) for r in range(DP_RANKS)]
    nq = cfg.model.codec_decoder.vq_num_quantizers
    n_units = 2 * len(cfg.model.codec_encoder.up_ratios) * len(cfg.model.codec_encoder.dilations)
    forwards = hold_cli_run("(d)", cfg, run, ranks, [nq, n_units], DP_CLI_STEPS)
    resume_s = resume_cli("(d)", args, run, DP_CLI_STEPS)
    cli_out = {"resume_one_process_s": resume_s, "ranks": ranks,
               "launches_per_rank_step": [ranks[0]["launches"][0] / forwards,
                                          ranks[0]["launches"][1] / forwards],
               "logged_steps": list(range(1, DP_CLI_STEPS + 2)),
               "ckpt_gb": (run / "ckpt" / str(DP_CLI_STEPS) / "state.pt").stat().st_size / 1e9}
    shutil.rmtree(root, ignore_errors=True)
    return {**two_ranks, "torchrun_wall_s": torchrun_s}, cli_out


def dp_path(cfg, card):
    """21. Data parallelism and FSDP on the one card (module docstring);
    prints the data_parallel line."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    try:
        out = {"world_size_1": dp_world1(cfg, dist.group.WORLD)}
        reference, out["world_size_1"]["fsdp"] = strict_reference(cfg, dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    out["world_size_1_s"] = time.perf_counter() - t0
    out["two_ranks"], out["cli"] = dp_ranks_and_cli(cfg, reference)
    del reference
    out["phase_21_s"] = time.perf_counter() - t0
    print(json.dumps({"data_parallel": out, "card": card}))
    return out


# -- 22. tensor-, expert- and pipeline-parallel training ---------------------------

MP_B = 12                   # the global batch: 12 x 1 s
MP_MICRO = 6                # PP's microbatches
MP_TIMED = 3                # timed steps a case
MP_SEED = 23                # the batch's draws
MP_LONG = (8, 10 * SR)      # the long crop of the remat cells: 8 x 10 s
MP_CLI_STEPS = 2


def mp_case(name, cfg, wav, ref=None, model_devices=None):
    """One step of ``cfg`` from seed 0 on ``wav`` (on ``model_devices``),
    its K1 / K2 launches (1 / 0), memory at rest and peak (less what was
    allocated before the state), then MP_TIMED timed steps; held against
    ``ref`` (the one-device case's result) by phase 8b's rule. Returns the
    case's numbers, and (metrics, leaves before, after) for a reference."""
    import torch
    from audiotokenization_tpu_torch.train.step import make_train_step

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state = seed0_state(cfg, model_devices=model_devices)
    torch.cuda.synchronize()
    rest = torch.cuda.memory_allocated() - base
    before = full_leaves(state) if ref is None else None
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(cfg)
    m, launches = counted(lambda: step(state, {"wav": wav}))
    expect_launches(f"22 {name} step", launches, (1, 0))
    out = {"rest_gb": rest / 1e9, "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "launches": list(launches)}
    m = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in m.items()}
    after = full_leaves(state)
    if ref is not None:
        out["worst_metric_rel"] = hold_metrics(f"22 {name} against one device", m, ref[0])
        out["worst_update_rel"], out["worst_update_leaf"] = hold_updates(
            f"22 {name} against one device", ref[1], ref[2], after)
    (ms, _), timed = counted(lambda: timed_steps(step, state, wav, n=MP_TIMED))
    out["ms_per_step"] = ms
    out["launches_per_step"] = [timed[0] / MP_TIMED, timed[1] / MP_TIMED]
    if out["launches_per_step"] != [1.0, 0.0]:
        fail(f"22 {name}: K1 / K2 {out['launches_per_step']} a timed step, not [1, 0]")
    del state, step
    return out, ((m, before, after) if ref is None else None)


def with_remat(cfg):
    """``cfg`` with the Conformer's layers recomputed in the backward
    (``train.remat``; ``strict_smooth`` turns it off)."""
    cfg = copy.deepcopy(cfg)
    cfg.train.remat = True
    return cfg


def mp_cli_rank(out_dir: str, argv):
    """A torchrun rank of 22e: cli.train.main on ``argv``, its K1 / K2
    launches to <out_dir>/mp_cli_rank<LOCAL_RANK>.json."""
    import os

    from audiotokenization_tpu_torch.cli import train as cli
    from audiotokenization_tpu_torch.ops.cuda.residual_unit_kernel import fused_residual_unit
    from audiotokenization_tpu_torch.ops.cuda.vq_kernel import vq_argmin

    vq_argmin.launches = fused_residual_unit.launches = 0
    t0 = time.perf_counter()
    state = cli.main(argv)
    sync = state.gen_opt.sync
    (Path(out_dir) / f"mp_cli_rank{os.environ['LOCAL_RANK']}.json").write_text(json.dumps(
        {"launches": [vq_argmin.launches, fused_residual_unit.launches],
         "tp_leaves": len(sync.tp_leaves()), "fsdp_leaves": len(sync.sharded()),
         "s": time.perf_counter() - t0}))


def mp_cli(cfg_base):
    """22e: cli.train under torchrun with TP 2 and FSDP over two gloo ranks
    on the card, then a resume in one process on one device."""
    root, cfg, args = cli_run("mp", cfg_base, MP_SEED, MP_CLI_STEPS)
    run = root / "run"
    torchrun_s = torchrun_ranks("--mp-cli", root, args + [
        "--dist_backend", "gloo", "--max_steps", str(MP_CLI_STEPS),
        "--override", "train.tensor_parallel=2", "train.fsdp=true"])
    ranks = [json.loads((root / f"mp_cli_rank{r}.json").read_text()) for r in range(DP_RANKS)]
    if not all(r["tp_leaves"] and r["fsdp_leaves"] for r in ranks):
        fail(f"22e a torchrun rank cut no TP or FSDP leaf: {ranks}")
    forwards = hold_cli_run("22e", cfg, run, ranks, [1, 0], MP_CLI_STEPS)
    out = {"torchrun_wall_s": torchrun_s,
           "resume_one_device_s": resume_cli("22e", args, run, MP_CLI_STEPS), "ranks": ranks,
           "launches_per_rank_step": [ranks[0]["launches"][0] / forwards,
                                      ranks[0]["launches"][1] / forwards],
           "logged_steps": list(range(1, MP_CLI_STEPS + 2)), "precision": cfg.train.precision}
    shutil.rmtree(root, ignore_errors=True)
    return out


def model_parallel_path(card, dev=None):
    """22. TP, EP and PP training on the card (module docstring); prints the
    model_parallel line. ``dev``: the model devices' device (the card)."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0) if dev is None else dev
    wav = torch.from_numpy((np.random.RandomState(MP_SEED).randn(MP_B, SR) * 0.1)
                           .astype(np.float32)).cuda()
    out = {"batch": [MP_B, SR], "precision": "fp32_strict", "adamw_eps": 1.0}
    base = strict_smooth(repo_config("conformer.yaml"))
    out["one_device"], ref = mp_case("one device", base, wav)
    out["one_device_remat"] = mp_case("one device, remat", with_remat(base), wav, ref)[0]
    long_wav = torch.from_numpy((np.random.RandomState(MP_SEED).randn(*MP_LONG) * 0.1)
                                .astype(np.float32)).cuda()
    out["long"], long_ref = mp_case("8 x 10 s", base, long_wav)
    out["long_remat"] = mp_case("8 x 10 s, remat", with_remat(base), long_wav, long_ref)[0]
    del long_wav, long_ref
    for n in (2, 4):
        cfg = copy.deepcopy(base)
        cfg.train.tensor_parallel = n
        out[f"tp{n}"] = mp_case(f"TP {n}", cfg, wav, ref, [dev] * n)[0]
    for n in (2, 3):
        cfg = copy.deepcopy(base)
        cfg.train.pipeline_parallel, cfg.train.pipeline_microbatches = n, MP_MICRO
        out[f"pp{n}"] = mp_case(f"PP {n}", cfg, wav, ref, [dev] * n)[0]
    del ref
    _SEED0.clear()
    moe = strict_smooth(repo_config("conformer_moe.yaml"))
    out["moe_one_device"], ref = mp_case("MoE one device", moe, wav)
    out["moe_one_device_remat"] = mp_case("MoE one device, remat", with_remat(moe), wav, ref)[0]
    cfg = copy.deepcopy(moe)
    cfg.train.tensor_parallel = 2
    out["moe_tp2"] = mp_case("MoE TP 2", cfg, wav, ref, [dev] * 2)[0]
    del ref
    _SEED0.clear()
    torch.cuda.empty_cache()
    out["remat"] = {name: {"peak_gb": [out[name]["peak_gb"], out[f"{name}_remat"]["peak_gb"]],
                           "ms_per_step": [out[name]["ms_per_step"],
                                           out[f"{name}_remat"]["ms_per_step"]]}
                    for name in ("one_device", "long", "moe_one_device")}  # [off, on]
    print(json.dumps({"remat": out["remat"], "card": card}))
    out["cases_s"] = time.perf_counter() - t0
    out["cli"] = mp_cli(repo_config("conformer.yaml"))
    t1 = time.perf_counter()
    out["dry_run"] = {**dryrun_multichip(DP_RANKS, "cuda"), "s": time.perf_counter() - t1}
    out["phase_22_s"] = time.perf_counter() - t0
    print(json.dumps({"model_parallel": out, "card": card}))
    return out


SOAK_FILES = 16             # build_corpus's files (2 s plus 0-7 x 160 samples)
SOAK_BASE, SOAK_EXTRA = 8, 4
SOAK_B = 16                 # the batch of 1 s crops (the corpus holds 16 files)
SOAK_OVERRIDES = (f"dataset.train.batch_size={SOAK_B}", f"dataset.val.batch_size={SOAK_B}",
                  "train.log_every_n_steps=4")
SOAK_CONFIG = "configs/bigcodec.yaml"


def per_call_launches(record):
    """A wrapper for a factory of step functions: each call of a function
    it makes appends that call's (K1, K2) launches to ``record``."""
    from audiotokenization_tpu_torch.ops.cuda.residual_unit_kernel import fused_residual_unit
    from audiotokenization_tpu_torch.ops.cuda.vq_kernel import vq_argmin

    def wrap(factory):
        def make(*a, **k):
            fn = factory(*a, **k)

            def counted_call(*ca, **ck):
                k1, k2 = vq_argmin.launches, fused_residual_unit.launches
                out = fn(*ca, **ck)
                record.append((vq_argmin.launches - k1, fused_residual_unit.launches - k2))
                return out

            return counted_call

        return make

    return wrap


def soak_resume(device="cuda"):
    """23 (a): soak_matrix.resume_determinism at SOAK_BASE + SOAK_EXTRA
    steps on SOAK_FILES files under build/, each training step's and
    extraction batch's (K1, K2) launches recorded. Returns its result with
    ``launches`` (the whole check's), ``per_step`` and ``per_batch``."""
    from audiotokenization_tpu_torch.ops.cuda.residual_unit_kernel import fused_residual_unit
    from audiotokenization_tpu_torch.ops.cuda.vq_kernel import vq_argmin
    from audiotokenization_tpu_torch.scripts import soak_matrix as sm
    from audiotokenization_tpu_torch.train import loop
    from audiotokenization_tpu_torch.utils import ragged

    work = Path(__file__).resolve().parent / "build" / f"chip_smoke_soak_{int(time.time())}"
    per_step, per_batch = [], []
    saved = (sm.WORK, loop.make_train_step, ragged.make_ragged_tokenizer)
    sm.WORK = work
    loop.make_train_step = per_call_launches(per_step)(saved[1])
    ragged.make_ragged_tokenizer = per_call_launches(per_batch)(saved[2])
    try:
        work.mkdir(parents=True)
        sm.build_corpus(n_files=SOAK_FILES)
        vq_argmin.launches = fused_residual_unit.launches = 0
        res = sm.resume_determinism(SOAK_CONFIG, base_steps=SOAK_BASE, extra_steps=SOAK_EXTRA,
                                    overrides=SOAK_OVERRIDES, device=device,
                                    deterministic=True)
        res["launches"] = [vq_argmin.launches, fused_residual_unit.launches]
    finally:
        sm.WORK, loop.make_train_step, ragged.make_ragged_tokenizer = saved
        shutil.rmtree(work, ignore_errors=True)
    res["per_step"], res["per_batch"] = per_step, per_batch
    return res


def soak_repeatable():
    """23 (b): K1 at the flagship's 2560 x 8192 x 8 and K2 at phase 4's 30
    unit shapes (B 32), each launched twice on the same inputs; fails
    unless the outputs are bitwise equal. Returns the shapes checked."""
    import numpy as np
    import torch
    from audiotokenization_tpu_torch.config import Config
    from audiotokenization_tpu_torch.ops.cuda.residual_unit_kernel import fused_residual_unit
    from audiotokenization_tpu_torch.ops.cuda.vq_kernel import vq_argmin

    rng = np.random.RandomState(10)
    z = torch.from_numpy(rng.randn(2560, 8).astype(np.float32)).cuda()
    book = torch.from_numpy(rng.randn(8192, 8).astype(np.float32)).cuda()
    if not torch.equal(vq_argmin(z, book), vq_argmin(z, book)):
        fail("soak: K1 gave different indices on two launches over the same inputs")
    shapes = unit_shapes(Config()) + unit_shapes(repo_config("bigcodec_semantic.yaml"))
    for C, T, d in shapes:
        args = unit_inputs(C, T, d)
        a = fused_residual_unit(*args, dilation=d)
        b = fused_residual_unit(*args, dilation=d)
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            fail(f"soak: K2 at C={C} T={T} d={d} gave different bits on two launches")
    torch.cuda.synchronize()
    return {"k1": [2560, 8192, 8], "k2_shapes": len(shapes), "batch": B}


def soak_child(out_dir: str):
    """Phase 23 in its own process (``--soak``): (b), then (a); writes
    <out_dir>/soak.json."""
    t0 = time.perf_counter()
    out = {"repeatable": soak_repeatable()}
    t1 = time.perf_counter()
    out["resume"] = soak_resume()
    out["resume_s"] = time.perf_counter() - t1
    out["child_s"] = time.perf_counter() - t0
    (Path(out_dir) / "soak.json").write_text(json.dumps(out))


def hold_soak(res):
    """Fail unless phase 23 (a)'s branches were byte-identical and every
    step and extraction batch launched K1 1 / K2 30 and K1 1 / K2 15."""
    steps = SOAK_BASE + 2 * SOAK_EXTRA
    if not (res["ok"] and res["metrics_identical"] and res["tokens_identical"]):
        fail(f"soak: the resumed branches differ: {json.dumps(res)}")
    if len(res["per_step"]) != steps or any(tuple(p) != (1, 30) for p in res["per_step"]):
        fail(f"soak: the {steps} training steps launched K1 / K2 {res['per_step']}, "
             "not 1 / 30 each")
    if not res["per_batch"] or any(tuple(p) != (1, 15) for p in res["per_batch"]):
        fail(f"soak: the extraction batches launched K1 / K2 {res['per_batch']}, "
             "not 1 / 15 each")
    if res["files_compared"] != SOAK_FILES:
        fail(f"soak: {res['files_compared']} token files compared, not {SOAK_FILES}")


def soak_path(card):
    """23. The resume check and the kernels' repeatability (module
    docstring) in a process of its own; prints the soak line."""
    import os
    import tempfile

    t0 = time.perf_counter()
    script = Path(__file__).resolve()
    with tempfile.TemporaryDirectory(dir=script.parent / "build") as out_dir:
        proc = subprocess.run(
            [sys.executable, str(script), "--soak", out_dir], cwd=str(script.parent),
            env={**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}, timeout=600)
        if proc.returncode:
            fail(f"soak: the phase's process exited {proc.returncode}")
        out = json.loads((Path(out_dir) / "soak.json").read_text())
    res = out["resume"]
    hold_soak(res)
    line = {"steps": [SOAK_BASE, SOAK_EXTRA], "files": SOAK_FILES,
            "batch": [SOAK_B, SR], "config": SOAK_CONFIG,
            "deterministic_algorithms": res["deterministic_algorithms"],
            "metrics_identical": res["metrics_identical"],
            "tokens_identical": res["tokens_identical"],
            "branch_rows": res["branch_steps"], "files_compared": res["files_compared"],
            "launches": res["launches"], "per_step": res["per_step"][0],
            "per_extract_batch": res["per_batch"][0],
            "extract_batches": len(res["per_batch"]), "repeatable": out["repeatable"],
            "resume_s": out["resume_s"], "child_s": out["child_s"],
            "phase_23_s": time.perf_counter() - t0}
    print(json.dumps({"soak": line, "card": card}))
    return line


# -- 24. the installed port -------------------------------------------------------

INSTALLED_SCRIPTS = {"preprocess": "audiotok-torch-preprocess", "train": "audiotok-torch-train",
                     "extract_indices": "audiotok-torch-extract",
                     "inference_full": "audiotok-torch-inference-full"}
QUICKSTART_SAMPLES = 3200   # examples/quickstart_torch.py's files: 0.2 s


def quickstart_module():
    """examples/quickstart_torch.py, loaded by path."""
    import importlib.util

    path = Path(__file__).resolve().parent / "examples" / "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def pip_install(target: Path) -> float:
    """``pip install --target`` of the tree's packaging files (pyproject.toml,
    README.md, both packages) copied beside ``target``, so that the build
    writes nothing into the tree; returns its seconds."""
    root = Path(__file__).resolve().parent
    src = target.parent / "src"
    src.mkdir(parents=True)
    for name in ("pyproject.toml", "README.md"):
        shutil.copy2(root / name, src / name)
    for pkg in ("audiotokenization_tpu", "audiotokenization_tpu_torch"):
        shutil.copytree(root / pkg, src / pkg,
                        ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "pip", "install", "--no-deps",
                          "--no-build-isolation", "--no-index", "--no-cache-dir",
                          "--no-compile", "-q", "--target", str(target), str(src)],
                         capture_output=True, text=True)
    if res.returncode:
        fail(f"24 pip install exited {res.returncode}:\n{res.stdout[-3000:]}\n"
             f"{res.stderr[-3000:]}")
    return time.perf_counter() - t0


def bigcodec_unit_shapes(cfg, samples: int):
    """(C, T, d) of a BigCodec's encoder and decoder ResidualUnits on inputs
    of ``samples``."""
    e, d = cfg.model.codec_encoder, cfg.model.codec_decoder
    shapes, c, t = [], e.ngf, samples
    for stride in e.up_ratios:
        shapes += [(c, t, dil) for dil in e.dilations]
        c, t = 2 * c, t // stride
    c = d.upsample_initial_channel
    for stride in d.up_ratios:
        c, t = c // 2, t * stride
        shapes += [(c, t, dil) for dil in d.dilations]
    return shapes


def installed_job(tmp: Path) -> dict:
    """Phase 24's places under ``tmp`` (the site dir pip installs into, the
    quickstart's work dir outside the repo, the fresh ATT_TORCH_CACHE), the
    installed scripts and the environment of the processes it starts."""
    import os

    job = {"tmp": tmp, "qs": quickstart_module(), "site": tmp / "site", "work": tmp / "work",
           "cache": tmp / "cache"}
    job["env"] = {**os.environ, "ATT_TORCH_CACHE": str(job["cache"]),
                  "PYTHONPATH": os.pathsep.join([str(job["site"])] + [
                      p for p in [os.environ.get("PYTHONPATH")] if p])}
    job["scripts"] = {m: job["site"] / "bin" / name for m, name in INSTALLED_SCRIPTS.items()}
    return job


def installed_build(job) -> dict:
    """24 (b): the installed package builds K1 and K2 into the fresh
    ATT_TORCH_CACHE (``ops/cuda/build.py::build_all``, the two nvcc
    processes started together), in a process of its own outside the repo;
    fatal unless it built from the installed sources. Returns its seconds
    and the sources' directory."""
    code = ("import json; from audiotokenization_tpu_torch.ops.cuda import build; "
            "build.build_all(('vq_argmin', 'residual_unit')); "
            "print(json.dumps({'csrc': str(build.CSRC_DIR), 'dir': str(build.build_dir())}))")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", code], cwd=job["work"], env=job["env"],
                         capture_output=True, text=True)
    if res.returncode:
        fail(f"24 the installed package's build exited {res.returncode}:\n"
             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    info = json.loads(res.stdout.strip().splitlines()[-1])
    if not Path(info["csrc"]).resolve().is_relative_to(job["site"]) or \
            Path(info["dir"]).resolve() != job["cache"] / "kernels":
        fail(f"24 the installed package built from {info['csrc']} into {info['dir']}, not "
             f"from under {job['site']} into {job['cache'] / 'kernels'}")
    return {"build_s": time.perf_counter() - t0, "csrc_dir": info["csrc"]}


def installed_prepare_child(tmp: str):
    """24 (a) and (b) in a process of its own (this script with
    --installed-prepare): pip install, the quickstart's corpus, the
    installed package's build; writes prepare.json with their seconds."""
    job = installed_job(Path(tmp))
    t0 = time.perf_counter()
    out = {"pip_install_s": pip_install(job["site"])}
    missing = [p.name for p in job["scripts"].values() if not p.is_file()]
    if missing:
        fail(f"24 pip installed no {missing} under {job['site'] / 'bin'}")
    job["qs"].prepare(job["work"])
    out.update(installed_build(job))
    out["prepare_s"] = time.perf_counter() - t0
    (job["tmp"] / "prepare.json").write_text(json.dumps(out))


def installed_port_prepare():
    """Start 24 (a) and (b) (``installed_prepare_child``) in a process
    group of its own; ``main`` starts it beside the repo's own build, since
    it needs the CPU and not the card. Returns (its temp dir, the process);
    the process group is killed and the dir removed at exit."""
    import atexit
    import os
    import signal
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_installed_")).resolve()
    with (tmp / "prepare.log").open("w") as log:
        proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                 "--installed-prepare", str(tmp)], stdout=log,
                                stderr=subprocess.STDOUT, start_new_session=True)

    def stop():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)

    atexit.register(stop)
    return tmp, proc


def installed_steps(job, modules) -> dict:
    """The quickstart steps of ``modules`` through the installed scripts:
    preprocess and train in turn (the next step reads what they write),
    extract and evaluate together; fatal unless each exits 0. Returns each
    one's seconds, from its start until it was seen to end."""
    steps = [(m, argv) for m, argv in job["qs"].steps(job["work"], "cuda") if m in modules]
    procs, seconds = {}, {}

    def finish(module):
        proc, log, start = procs[module]
        proc.wait()
        log.close()
        seconds.setdefault(module, time.perf_counter() - start)

    try:
        for module, argv in steps:
            log = (job["tmp"] / f"{module}.log").open("w")
            procs[module] = (subprocess.Popen([str(job["scripts"][module]), *argv],
                                              cwd=job["work"], env=job["env"], stdout=log,
                                              stderr=subprocess.STDOUT), log,
                             time.perf_counter())
            if module in ("preprocess", "train"):
                finish(module)
    finally:
        for module in procs:
            finish(module)
    for module, (proc, _, _) in procs.items():
        if proc.returncode:
            text = (job["tmp"] / f"{module}.log").read_text()
            fail(f"24 {job['scripts'][module].name} exited {proc.returncode}:\n{text[-4000:]}")
    return seconds


def installed_port_path(card, prepared=None):
    """24. The quickstart through the installed port (module docstring):
    (a) pip install into a temp dir outside the repo and the quickstart's
    corpus, (b) K1 and K2 built by the installed package into a fresh
    ATT_TORCH_CACHE, both in ``prepared``'s process (started here when
    none was), (c) preprocess and train, then extract and evaluate
    together, through the installed scripts, and the checks; prints the
    installed_port line: ``phase_24_s`` from this call's start, and
    ``phase_24_whole_s``, (a) and (b)'s seconds plus those after them, the
    phase's time when run in turn."""
    from audiotokenization_tpu_torch import config as PC
    from audiotokenization_tpu_torch.cli import extract_indices
    from audiotokenization_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    tmp, proc = installed_port_prepare() if prepared is None else prepared
    try:
        proc.wait()
        if proc.returncode:
            fail(f"24 (a, b) exited {proc.returncode}:\n"
                 f"{(tmp / 'prepare.log').read_text()[-4000:]}")
        job = installed_job(tmp)
        qs, work, cache = job["qs"], job["work"], job["cache"]
        out = json.loads((tmp / "prepare.json").read_text())
        out["waited_s"] = time.perf_counter() - t0
        out["steps_s"] = installed_steps(job, ("preprocess", "train"))
        out["steps_s"].update(installed_steps(job, ("extract_indices", "inference_full")))
        built = sorted(p.name for p in (cache / "kernels").glob("*.so"))
        want = [build.library_path(n).name for n in ("vq_argmin", "residual_unit")]
        out["cache_libraries"] = built
        if not set(want) <= set(built):
            fail(f"24 the fresh ATT_TORCH_CACHE holds {built}, not {want} (the installed "
                 "sources' hash)")
        run = work / "run"
        (extract_argv,) = [argv for module, argv in qs.steps(work, "cuda")
                           if module == "extract_indices"]
        _, launches = counted(lambda: extract_indices.main(
            extract_argv + ["--output_folder", "extracted_indices_repo"]))
        installed = {p.relative_to(run / "extracted_indices"): p.read_bytes()
                     for p in sorted((run / "extracted_indices").rglob("*.npy"))}
        repo = {p.relative_to(run / "extracted_indices_repo"): p.read_bytes()
                for p in sorted((run / "extracted_indices_repo").rglob("*.npy"))}
        n_files = sum(n for _, _, n in qs.SPEAKERS)
        if len(installed) != n_files or installed != repo:
            fail(f"24 the installed port's {len(installed)} token files differ from the "
                 f"repo's extraction of the same run dir ({len(repo)} files, "
                 f"{sum(installed.get(k) != v for k, v in repo.items())} differ)")
        cfg = PC.load_config(run / "config.json")
        units = len(cfg.model.codec_encoder.up_ratios) * len(cfg.model.codec_encoder.dilations)
        expect_launches("24 the repo's extraction", launches, (n_files, units * n_files))
        summary = json.loads((run / "inference_full" / "summary.json").read_text())
        shapes = bigcodec_unit_shapes(cfg, QUICKSTART_SAMPLES)
        out.update({
            "token_files": len(installed), "token_files_equal": True,
            "repo_extract_launches": list(launches),
            "repo_extract_per_batch": [launches[0] / n_files, launches[1] / n_files],
            "summary_keys": sorted(summary)[:12],
            "k2_widths": sorted({c for c, _, _ in shapes}),
            "k2_max_abs_err": check_k2(shapes, batch=2, what="24 K2")})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_24_s"] = time.perf_counter() - t0
    out["phase_24_whole_s"] = out["prepare_s"] + out["phase_24_s"] - out["waited_s"]
    print(json.dumps({"installed_port": out, "card": card}))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from audiotokenization_tpu_torch.config import Config
    from audiotokenization_tpu_torch.ops.cuda import build

    card = card_line()
    print(card)  # name and power limit, as nvidia-smi gives them
    kind = torch.cuda.get_device_name(0)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config()
    t0 = time.perf_counter()
    prepared = installed_port_prepare()  # 24 (a, b): pip and two nvcc beside the build
    with ThreadPoolExecutor(1) as pool:  # the kernels build while the CPU runs (b')'s step
        built = pool.submit(build.build_all)
        threads = torch.get_num_threads()
        torch.set_num_threads(max(1, threads - len(build.KERNELS) - 2))
        try:
            bf16_ref = bf16_cpu_reference(cfg)
        finally:
            torch.set_num_threads(threads)
        reports = built.result()
    print(f"built {', '.join(build.KERNELS)} in {time.perf_counter() - t0:.1f} s "
          f"(the CPU's bf16 step beside it: {bf16_ref[2]:.1f} s)")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {name}: {line.strip()}")
    hmma = hmma_count("residual_unit")
    print(f"residual_unit: {hmma} HMMA instructions")
    if hmma == 0:
        fail("the residual_unit library has no tensor-core (HMMA) instructions")

    shapes = unit_shapes(cfg)
    sem_shapes = unit_shapes(repo_config("bigcodec_semantic.yaml"))  # C 16-256: phase 17's
    k1_err = check_k1()
    k2_err = check_k2(shapes + sem_shapes)
    check_ragged()
    p1_launches, p1_err = probe_path()
    e2e = main_path(cfg)
    print(json.dumps({"end_to_end": e2e, "card": card}))

    k1 = time_k1(cfg)
    rows = time_k2(shapes)
    sem_rows = time_k2(sem_shapes)
    p1_rows = time_p1()

    check_k2_grads(shapes + sem_shapes)
    train_step_vs_cpu(cfg)
    train_step_bf16_vs_cpu(cfg, bf16_ref)
    del bf16_ref
    train = train_path(cfg, card)
    loop = train_loop_path(cfg, card, train)
    ext = extract_path(cfg, card)
    bare = [train["audio_s_per_s"], bare_step_again(cfg)]
    print(json.dumps({"train_loop_vs_bare": {
        "bare_before_audio_s_per_s": bare[0], "loop_audio_s_per_s": loop["audio_s_per_s"],
        "bare_after_audio_s_per_s": bare[1],
        "loop_over_bare_mean": loop["audio_s_per_s"] / (sum(bare) / 2)}, "card": card}))
    flagship = seeded_codec(cfg)
    modes = modes_path(cfg, flagship, card)
    causal = causal_path(card)
    aa = aa_chunked_path(cfg, flagship, card)
    del flagship
    conformer = conformer_path(card)
    t0 = time.perf_counter()
    moe = moe_path(card)
    fsq = fsq_path(card)
    print(json.dumps({"phase_15_s": time.perf_counter() - t0, "card": card}))
    t0 = time.perf_counter()
    ema = ema_path(card)
    lfq = lfq_path(card)
    zoo_library(card)
    print(json.dumps({"phase_16_s": time.perf_counter() - t0, "card": card}))
    t0 = time.perf_counter()
    semantic = semantic_path(card)
    print(json.dumps({"phase_17_s": time.perf_counter() - t0, "card": card}))
    t0 = time.perf_counter()
    token_lm = token_lm_path(cfg, card)
    causal_train = causal_train_path(card)
    print(json.dumps({"phase_18_s": time.perf_counter() - t0, "card": card}))
    t0 = time.perf_counter()
    sv = speaker_verification_path(cfg, card)
    print(json.dumps({"phase_19_s": time.perf_counter() - t0, "card": card}))
    t0 = time.perf_counter()
    par = parallel_path(cfg, card)
    print(json.dumps({"phase_20_s": time.perf_counter() - t0, "card": card}))
    dpp = dp_path(cfg, card)
    print(json.dumps({"phase_21_s": dpp["phase_21_s"], "card": card}))
    mpp = model_parallel_path(card)
    print(json.dumps({"phase_22_s": mpp["phase_22_s"], "card": card}))
    soak = soak_path(card)
    installed = installed_port_path(card, prepared)
    sp, tp_pp = par["sp_flagship"], par["conformer"]

    def path_launches(kernel):
        """A kernel's launches per call on the paths of phases 10-24."""
        k = ("vq_argmin", "residual_unit").index(kernel)
        return {
            f"sp_tokenize_{SP_SECONDS}s_{SP_SHARDS}_shards":
                sp[f"tokenize_{SP_SHARDS}_shards"]["launches"][kernel],
            f"sp_tokenize_{SP_SECONDS}s_1_shard": sp["tokenize_1_shards"]["launches"][kernel],
            f"sp_synthesize_{sp['frames']}_frames_{SP_SHARDS}_shards":
                sp["synthesize"]["launches"][kernel],
            "tp_tokenize": {n: tp_pp[f"tp{n}_tokenize"]["launches"][k] for n in (2, 4)},
            "moe_tp2_tokenize": tp_pp["moe_tp2_tokenize"]["launches"][k],
            "pp_tokenize": {n: tp_pp[f"pp{n}"]["launches"]["tokenize"][k] for n in (2, 3)},
            "pp_synthesize": {n: tp_pp[f"pp{n}"]["launches"]["synthesize"][k] for n in (2, 3)},
            "dp_per_rank_step": dpp["two_ranks"]["ranks"][0]["dp"]["launches"][k],
            "fsdp_per_rank_step": dpp["two_ranks"]["ranks"][0]["fsdp"]["launches"][k],
            "cli_torchrun_per_rank_step": dpp["cli"]["launches_per_rank_step"][k],
            "tp_train_per_step": {**{n: mpp[f"tp{n}"]["launches_per_step"][k] for n in (2, 4)},
                                  "moe_2": mpp["moe_tp2"]["launches_per_step"][k]},
            "pp_train_per_step": {n: mpp[f"pp{n}"]["launches_per_step"][k] for n in (2, 3)},
            "tp_fsdp_cli_per_rank_step": mpp["cli"]["launches_per_rank_step"][k],
            "soak_resume_per_step": soak["per_step"][k],
            "soak_extract_per_batch": soak["per_extract_batch"][k],
            "remat_train_per_step": {"conformer": mpp["one_device_remat"]["launches_per_step"][k],
                                     "moe": mpp["moe_one_device_remat"]["launches_per_step"][k]},
            "installed_quickstart_repo_extract_per_batch": installed["repo_extract_per_batch"][k],
            "speaker_verification_cli_per_call": sv["cli"]["launches"][kernel],
            "speaker_verification_codec_leg": sv["codec_leg"]["launches"][kernel],
            "token_lm_train_per_step": token_lm["train"]["launches_per_step"][kernel],
            "token_lm_synthesize_per_call": token_lm["cli"]["synthesize_launches"][kernel],
            "causal_train_per_step": causal_train["train"]["launches_per_step"][kernel],
            "modes_per_call": {m: r["launches"][kernel] for m, r in modes.items()},
            "extract_fast": ext["extract_fast"]["launches"][kernel],
            "causal_per_tokenize": causal["offline"]["launches_per_tokenize"][kernel],
            "stream_per_step": causal["stream_tokenize"]["launches_per_step"][kernel],
            "antialias_per_tokenize": aa["antialias_offline"]["launches_per_tokenize"][kernel],
            "antialias_ragged_per_call": aa["antialias_ragged"]["launches_per_call"][kernel],
            "chunked_per_window": aa["chunked"]["launches_per_window"][kernel],
            **{name: {path: ({m: r[kernel] for m, r in got.items()}
                             if path == "modes_per_call" else got[kernel])
                      for path, got in line["launches"].items()}
               for name, line in (("conformer", conformer), ("conformer_moe", moe),
                                  ("bigcodec_fsq", fsq), ("bigcodec_ema_vq", ema),
                                  ("bigcodec_lfq", lfq), ("bigcodec_semantic", semantic))}}

    # K2's main-path work: the encoder's 15 units (tokenize) and the decoder's
    # 15 at the same shapes (decode), so twice the per-shape sums. P1: one
    # launch per probe shape.
    per_path = e2e["launches"]["residual_unit"] // len(shapes)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_simt_ms")
    tot = {k: per_path * sum(r[k] for r in rows) for k in keys}
    # phase 17's units: its tokenize's 15 and its decode's 15 at C 16-256
    sem_tot = {k: 2 * sum(r[k] for r in sem_rows) for k in keys}
    p1 = {k: sum(r[k] for r in p1_rows) for k in keys}

    def bound_by(rs):
        return "operations" if all(r["bound_by"] == "operations" for r in rs) else "bytes"

    kernels = [
        {"name": "vq_argmin", "route": "cuda",
         "source": "audiotokenization_tpu_torch/csrc/vq_argmin.cu",
         "replaces": "audiotokenization_tpu/ops/pallas/vq_kernel.py:33",
         "launches": e2e["launches"]["vq_argmin"], "max_abs_err": k1_err,
         "train_launches_per_step": train["launches_per_step"]["vq_argmin"],
         "loop_launches": loop["launches"]["vq_argmin"],
         "extract_launches": ext["extract_launches"]["vq_argmin"],
         "eval_launches": ext["eval_launches"]["vq_argmin"],
         "path_launches": path_launches("vq_argmin"), **k1},
        {"name": "fused_residual_unit", "route": "cuda",
         "source": "audiotokenization_tpu_torch/csrc/residual_unit.cu",
         "replaces": "audiotokenization_tpu/ops/pallas/residual_unit_kernel.py:46",
         "launches": e2e["launches"]["residual_unit"], "max_abs_err": k2_err,
         "train_launches_per_step": train["launches_per_step"]["residual_unit"],
         "loop_launches": loop["launches"]["residual_unit"],
         "extract_launches": ext["extract_launches"]["residual_unit"],
         "eval_launches": ext["eval_launches"]["residual_unit"],
         "path_launches": path_launches("residual_unit"),
         "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
         "bound_by": bound_by(rows), "bound_simt_ms": tot["bound_simt_ms"],
         "library_ms": tot["library_ms"],
         "semantic_path": {**sem_tot, "bound_by": bound_by(sem_rows),
                           "launches": 2 * len(sem_rows)}},
        {"name": "probe_unit", "route": "cuda",
         "source": "audiotokenization_tpu_torch/csrc/probe_unit.cu",
         "replaces": "scripts/probe_v5.py:33",
         "launches": p1_launches, "max_abs_err": p1_err,
         "ms": p1["ms"], "plain_ms": p1["plain_ms"], "bound_ms": p1["bound_ms"],
         "bound_by": bound_by(p1_rows), "bound_simt_ms": p1["bound_simt_ms"],
         "library_ms": p1["library_ms"]},
    ]
    print(json.dumps({"kernels": kernels, "card": card,
                      "note": "K1 per call (ms: wrapper calls back to back; host_ms: "
                              "the host's time per call; device_ms: the kernel alone); K2 summed over the main path's "
                              f"{e2e['launches']['residual_unit']} unit launches; P1 "
                              f"summed over its path's {p1_launches} launches (probe shapes); "
                              "train_launches_per_step: the bf16 training step's; "
                              "loop_launches: the training loop's (K1 1 / K2 30 per train "
                              "step, validation batch and test file); extract_launches / "
                              "eval_launches: corpus extraction's (K1 1 / K2 15 per device "
                              "batch) and full-length evaluation's (K1 1 / K2 30 per device "
                              "batch); path_launches: per call of each tokenize mode, per "
                              "device batch of --mode fast extraction, per causal or "
                              "anti-aliased tokenize and ragged call, per streaming step, per "
                              "chunked window; conformer: per Conformer tokenize (32 x 1 s and "
                              "4 x 30 s), tokenize mode call, ragged tokenizer and codec call, "
                              "extraction device batch and streaming step; conformer_moe: per "
                              "MoE Conformer tokenize (32 x 1 s and 4 x 30 s), mode call, "
                              "extracted file (per-file route) and bf16 training step; "
                              "bigcodec_fsq: per FSQ BigCodec tokenize, decode, mode call, "
                              "ragged call, extraction device batch and bf16 training step; "
                              "bigcodec_ema_vq: the same for the EMA-VQ BigCodec; "
                              "bigcodec_lfq: per LFQ BigCodec tokenize, decode and bf16 "
                              "training step; bigcodec_semantic: per semantic codec tokenize "
                              "(the teacher's output given), decode, extraction device batch, "
                              "evaluation device batch and bf16 training step; token_lm_train_per_step: "
                              "the token LM's step over the frozen flagship's tokens (16 x 1 "
                              "s); token_lm_synthesize_per_call: cli.synthesize --lm_ckpt "
                              "(2 x 2 s); causal_train_per_step: the causal flagship's bf16 "
                              "step; speaker_verification_cli_per_call: cli.verification (fbank, "
                              "MFCC, WavLM-Large); speaker_verification_codec_leg: phase 19's "
                              "tokenize + decode of 4 x 3 s before the ECAPA scoring; K2's "
                              "semantic_path: summed over the semantic codec's 30 units "
                              "(C 16-256) at 32 x 1 s; sp_*: per SP tokenize of one "
                              f"{SP_SECONDS} s file and SP synthesize of its codes, the shards "
                              "on the one card; tp_tokenize / pp_*: per Conformer call of "
                              f"{PAR_REQUESTS} x {PAR_SECONDS} s at 2 / 4 model shards and 2 / "
                              "3 stages; dp_per_rank_step / fsdp_per_rank_step: a rank's "
                              "fp32_strict step of 16 x 1 s, two ranks on the card; "
                              "cli_torchrun_per_rank_step: cli.train under torchrun, a rank's "
                              "launches over its steps and validation batches, per forward; "
                              "tp_train_per_step / pp_train_per_step: the Conformer's "
                              "fp32_strict step of 12 x 1 s at 2 / 4 model devices (moe_2: "
                              "the MoE Conformer at 2) and 2 / 3 stages; "
                              "tp_fsdp_cli_per_rank_step: cli.train under torchrun with TP 2 "
                              "and FSDP, a rank's launches per forward; "
                              "soak_resume_per_step / soak_extract_per_batch: phase 23's "
                              "resume check (scripts/soak_matrix.py), a bf16 step of 16 x 1 s "
                              "through cli.train and a batch of cli.extract_indices; "
                              "remat_train_per_step: phase 22's one-device fp32_strict "
                              "step of 12 x 1 s with each Conformer layer recomputed "
                              "(train.remat on); installed_quickstart_repo_extract_per_batch: "
                              "phase 24's extraction, by the repo's port, of the run dir "
                              "the installed audiotok-torch-* scripts trained (the tiny "
                              "BigCodec, one 0.2 s file a batch)"}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-ranks"]:  # a torchrun rank of phase 21
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        dp_rank_then_cli(sys.argv[2], sys.argv[3:])
        sys.exit(0)
    if sys.argv[1:2] == ["--mp-cli"]:  # a torchrun rank of phase 22
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        mp_cli_rank(sys.argv[2], sys.argv[3:])
        sys.exit(0)
    if sys.argv[1:2] == ["--installed-prepare"]:  # phase 24's install and build
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        installed_prepare_child(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--soak"]:  # phase 23's process
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        soak_child(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
