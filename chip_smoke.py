"""Chip smoke test of the PyTorch/CUDA port: builds the hand-written CUDA
kernels from ``src/repro_torch/kernels/csrc``, holds each against its plain
PyTorch version on the card, drives the serving path (``serve()`` and
streaming sessions) and the online-learning path (END_B and END_S e-prop
training on Braille, then serving the learned weights) at the Braille
network's full width through the kernels, drives the dense LM's serving
path (prefill, decode, greedy ``generate``) at llama3-8b's full width and
depth through the flash-attention kernel, trains the dense LM
(qwen3-1.7b at full width and depth) through the forward and backward
flash-attention kernels, serves and trains the MoE family (deepseek-v2's
MLA through both kernels at q/k width 192 and v width 128, phi3.5-moe's
GQA), serves and trains Mamba2 (mamba2-1.3b at full width and depth; its
SSD runs no kernel of ours), serves the Jamba hybrid (one period of
jamba-v0.1-52b through the forward kernel), serves cross-attention
(llama-3.2-vision-90b at 2 periods over media embeddings) and the
encoder-decoder (seamless-m4t-large-v2 at full size, which it also
trains), trains qwen3-1.7b with int8 error-feedback gradient compression
over a pod axis, runs GPipe over its layers and deepseek-v2-lite-16b's
grouped MoE dispatch on a one-rank NCCL world, kills and resumes a
checkpointed learner on the card, learns Braille in exact-mode e-prop
(per-synapse traces) through its own kernel and under the triangular
surrogate, and times the kernels.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-tree CHECKOUT   # time another tree's kernels
    python3 chip_smoke.py --learn-walls CHECKOUT # another tree's learning walls

Needs one NVIDIA GPU (Hopper: the kernels build for ``sm_90a``) and the
CUDA toolkit's ``nvcc``.  Exits non-zero, printing no result, when CUDA is
unavailable, when run outside a checkout, or when any phase fails.  The
last line of standard output is one JSON object with the device; the line
before it lists every kernel with its launches on the main path, its error
against the plain version, its time, the plain version's time and its
bound on this card.

Phases, in this order but for (f), which runs after (h) with (i) (the
timing phases use torch.profiler, and the learning run's wall is taken
before any profiler session):
  (a) build the kernel library (one nvcc) and print the build seconds;
  (b) kernel == plain version on the card: bitwise in quantized mode, and in
      float mode within FLOAT_TOL, at the Braille shape (T=256, one full
      serving tile, a ragged tile, B=1; T=1100, longer than one chunk of the
      serving plan, at B=1 and a full tile), the cue shape 40/100/2 and the
      chip-maximum 256/256/16 shape, with live holes, infer_window="all",
      and sessions in chained ragged tiles (one of a single tick) from the
      carries of the tile before; two rsnn_infer launches, and
      rsnn_step_sessions from zero carries with every tick live, give
      rsnn_infer's bits;
  (c) BatchedEngine(CONFIG_QUANT, device="cuda").serve() on a few hundred
      Braille requests, bitwise equal to the same requests through the
      plain version (an engine on device="cpu"); run_tile drives rsnn_infer;
  (d) a few hundred streaming sessions fed in ragged and word-sized chunks
      (with pool evictions), results bitwise equal to (c);
  (e) each serving kernel's launch count over (c) + (d) is > 0;
  (f) each serving kernel timed at T=256 over B=1, the main path's tile and
      the 2,048-row admission: the card's time from torch.profiler beside
      CUDA events a call, its plain version's time, and its bound from this
      run's input events and spikes (traffic.serve_event_flops);
  (g) the training kernels (rsnn_train, rsnn_forward, eprop_update) ==
      their plain versions on the card at Braille T=128 (the END_B tile
      B=70, B=1, B=2048, a ragged B, label_delay>0, random feedback,
      quantized and float), at Braille T=512 (rsnn_train's trace set in the
      device scratch; quantized and float) and at 256/256/16 (quantized and
      float): rsnn_forward's seven streams, acc_y, n_spk and
      rsnn_train's h, xbar, pbar, zbar traces bitwise when quantized, its
      readout error within TRAIN_ERR_TOL, dw within TRAIN_DW_TOL; two
      launches of rsnn_forward, and of rsnn_train, give identical bits;
      forward_traces +
      eprop_update give train_tile's dw;
  (h) the learning run: OnlineLearner (quantized Braille at the dataset's
      T=128, the quantized bench optimizer) trains 12 epochs END_B and END_S
      on the AEU surrogate for each of the fixed LEARN_SEEDS; the median
      END_S test accuracy is at least the JAX reference's median over the
      same seeds less END_S_MARGIN, and END_B's median within 0.10 of it;
      BatchedEngine.from_learner serves the first seed's END_S weights on the
      test split, bitwise equal to the learner backend's inference; the
      split pipeline and the dynamics probe run on the learned weights; all
      five kernels are launched on this path;
  (i) the training kernels timed at the main path's shape (T=128, B=70),
      rsnn_train also at END_S's (T=128, B=1) and rsnn_forward at B=1 and
      B=2048, each bound by this run's events (traffic.train_event_flops,
      traffic.forward_event_flops);
  (j) flash_attention == its plain version on the card: llama3-8b's
      attention shape (B=4, S=2048, H=32, Hkv=8, D=128, bf16, causal), a
      ragged causal length, a non-causal case on strided (B, H, S, D) views
      with NaN past kv_len, and f32 at qwen3-1.7b's heads; within
      FLASH_F32_TOL of max|o| (f32) or BF16_ROW_TOL of each row's max|o|
      (bf16), two launches give identical bits, and the gate rejects two
      planted faults (output x 0.9, a key tile lost from the later rows);
  (k) the LM serving path at llama3-8b's full width and depth (32 layers,
      random bf16 weights from a seed): generate() of 32 greedy tokens after
      B=4 prompts of 2048 tokens, launching flash_attention once per layer of
      the prefill; every logit finite, two prefills bitwise alike (as (t)
      and (v), through the same code); the teacher-forcing identity (decode
      at position L on the cache of L tokens == the last logits of a prefill
      of L+1) within LM_TF_TOL; prefill logits within LM_PLAIN_TOL of a
      prefill whose attention runs the plain version; prefill and decode
      tokens/s;
  (l) flash_attention timed at the (j) llama shape beside its plain version,
      one library call (scaled_dot_product_attention) and its bound;
  (m) learning while serving, hardened (runs after (h), before (f)): an
      END_B OnlineLearner (CONFIG_QUANT, QUANT_OPT) publishes every commit
      into a ModelRegistry while a hardened BatchedEngine on that registry
      answers an EventStream's requests between commits
      (interleave_train_serve), through run_tile (rsnn_infer) and one
      session per request fed in two halves (rsnn_step_sessions); every
      answer OK and bitwise equal to an engine on the CPU given the same
      images, no lane restart; then an injected whole-sample and streaming
      launch fault each recover bitwise through one lane restart on the
      card with the kernel launched after it, a NaN planted in one
      session's readout quarantines it alone, and a scripted overload /
      deadline run drops the same rids as on the CPU.  The kernels line's
      launches of rsnn_train, rsnn_infer and rsnn_step_sessions are (m)'s;
  (n) kill and resume (after (m), before (f)): at the Braille shape (12/38/3
      quantized, stochastic commits, T=128, the AEU split's 420 training
      samples, END_B at 70 a batch for 2 epochs: 12 commits, a checkpoint at
      each), an in-process golden OnlineLearner run on the card, then three
      chaos workers (python -m repro_torch.train.chaos, one process each,
      loading the library (a) built): SIGKILL at a seeded commit in
      [2, 10], SIGKILL at step 3's rename (the torn .tmp must be swept),
      SIGTERM at commit 4 (STOPPED_RC, then a clean restart); then a Trainer
      over make_eprop_commit_step (round-nearest commits) stopped by SIGTERM
      and resumed in-process.  Every run ends bitwise on its golden run,
      both golden runs move every weight leaf from its initial bits (so the
      drills cannot pass on weights that never changed), the Trainer logs
      every step, every worker reports the card and rsnn_train launches;
      prints each
      spawn's seconds, each worker's recovery_s, a blocking save's and
      save_async's enqueue seconds and (n)'s total.  (n)'s in-process and
      worker rsnn_train launches are in the kernels line's launches_by_path;
  (o) data-parallel END_B learning and serving and the integer commit grid
      (after (n), before (f)): rsnn_train(..., commit_grid=DW_COMMIT_SPEC)
      at Braille T=128 (B=70, B=1, a ragged B=11, quantized and float) and at
      256/256/16 (the device-scratch dw path, B=8): the int32 codes of
      rsnn_dw_codes_reduce_kernel equal its plain version (the rows'
      partials snapped and summed) bitwise, the partials, acc_y and n_spk
      equal the float launch's, and the codes agree with the plain B=1 loop
      within TRAIN_DW_TOL of max|dw| plus B lsb; the codes of one launch
      equal the int32 sums of its 8-way and 4-way padded shard launches and
      of B one-row launches, bitwise; then on a one-rank NCCL world the
      backend's sharded launches (pad, slice, collectives) of _train (float
      and commit grid), _inference and _step_sessions, each bitwise equal
      to its unsharded launch (their launches are the kernels line's
      launches_by_path "data_parallel"); the codes reduce's profiler time
      beside the float reduce's, one END_B commit's wall with and without
      the grid, the NCCL all_reduce of the three dw; then the deterministic
      chaos drill on the card (--deterministic --mesh-devices 1, SIGKILL at
      a seeded commit), bitwise on its golden run, with every rsnn_train
      launch of the golden run and of every worker reduced onto the grid
      (the workers report commit_grid and their grid launches);
  (p) flash_attention_bwd == its plain version on the card (after (l)):
      qwen3-1.7b's training attention (B=4, S=2048, H=16, Hkv=8, D=128,
      bf16, causal), llama3-8b's heads (H=32), a ragged causal length, a
      non-causal case on strided views with a non-contiguous dO, and f32
      at D=128; the forward's lse against the plain forward's within
      BWD_LSE_TOL, the forward with lse bitwise the forward without, dq,
      dk, dv within FLASH_F32_TOL of each tensor's max |.| (f32) or
      BWD_BF16_ROW_TOL per row (bf16), two launches bitwise equal, and the
      gate rejects dk x 0.9 and q tile 1 dropped from dk and dv;
  (q) LM training at qwen3-1.7b's full width and depth (28 layers, bf16,
      remat="full", random weights from seed 0): TRAIN_STEPS steps of the
      step launch/train.py builds on B=4 x S=2048 tokens of
      TokenStream(seed=0), no checkpoints; every loss and grad norm
      finite, step 0's loss within TRAIN_LOSS0_TOL of ln(vocab), the last
      below the first, flash_attention launched twice and
      flash_attention_bwd once per layer a step; step wall, tokens/s, peak
      memory, one profiled step; then one step's gradients at the arch's
      widths and TRAIN_GRAD_LAYERS layers through the kernels against the
      same step through their plain versions, per leaf within LM_GRAD_TOL;
      launch/train.py --reduced on the card, 6 steps against a run stopped
      by SIGTERM after 4 and resumed to 6 (bitwise), and a bf16 reduced
      run through the Trainer
      saved and restored (bitwise).  (q)'s launches are the kernels line's
      launches_by_path "lm_train";
  (r) flash_attention_bwd timed at qwen3-1.7b's and llama3-8b's shapes
      (torch.profiler device time, CUDA events beside; the pre-pass and
      the wgmma kernel apart; TFLOP/s of the five products) beside its plain
      version, SDPA's backward and its bound (the five products at the
      bf16 tensor-core peak); the registers and spills ptxas reports for
      its bf16 kernels; the forward with and without lse;
  (s) after (r): the forward (with and without lse) and the backward at
      MLA's (q/k, v) widths (192, 128) against their plain versions at
      deepseek-v2-lite's prefill and training shape (B=4, S=2048, H=16,
      bf16, causal), a ragged length and a non-causal case on strided
      views with a non-contiguous dO: per row within BF16_ROW_TOL and
      BWD_BF16_ROW_TOL, the backward bitwise across two launches, the
      four planted faults rejected, an f32 call at the pair refused; at
      the end of the run, both timed (torch.profiler per kernel) beside
      SDPA's forward and backward at the same shape (its kernels named),
      with their bounds and ptxas's registers and spills;
  (t) MoE and MLA serving: deepseek-v2-lite-16b at full width and depth
      (27 layers, random bf16 weights from seed 11), generate() of 32
      greedy tokens after 4 prompts of 2048 tokens: 27 flash_attention
      launches, none in decode, two prefills bitwise alike; prefill and
      decode tokens/s, peak memory, idle shares; at a capacity where
      nothing drops, the teacher-forcing identity and a plain-attention
      prefill within MOE_TOL, each with the routing of the run compared
      with replayed, each run's own routing and its flips reported, and
      two planted faults (a wrong cache slot, the kernel's output x 0.9 in
      every layer) rejected; then phi3.5-moe at full width and 4 layers
      (GQA at D=128), 8 greedy tokens, the same gates at the dense
      family's LM_TF_TOL and LM_PLAIN_TOL, and at the GQA layers' outputs
      within MOE_PHI_MIXER_TOL, a fault rejected at either point;
  (u) MoE and MLA training: deepseek-v2-lite-16b at full width with 3
      layers (the dense prefix and two MoE layers), bf16, remat="full",
      B=4 x S=2048 tokens of TokenStream(seed=0), AdamW lr 3e-4, 8 steps:
      losses, aux losses and grad norms finite, step 0's loss within
      TRAIN_LOSS0_TOL of ln V + sigma^2 / 2 with sigma, the initial logits'
      std, within TRAIN_SIGMA_TOL of 1, the last below the first, aux
      positive, 6 forward and 3 backward flash launches a step; step
      wall, tokens/s, peak memory, idle share; one step's gradients of a
      2-layer slice through the kernels within LM_GRAD_TOL of the plain
      versions' under the same routing, with the plain run's own flips;
  (v) Mamba2 serving, after (u): mamba2-1.3b at full width and depth (48
      layers, random bf16 weights from seed 11), generate() of 32 greedy
      tokens after 4 prompts of 2,048 tokens: no launch of any kernel of
      ours (the kernels line's launches_by_path "mamba_serve"), two
      prefills bitwise alike; the teacher-forcing identity within
      MAMBA_TF_TOL, with layer 24's state zeroed and its conv tails rolled
      by one position each rejected; layer 0's chunked SSD on its own
      inputs against the per-step recurrence (f32 and compute_dtype bf16);
      prefill and decode ms, tokens/s, busy and idle shares, kernels a
      step, the busiest kernels and aten ops, peak memory;
  (w) Mamba2 training: mamba2-1.3b at full width and depth, (q)'s settings
      (bf16, remat="full", B=4 x S=2048 of TokenStream(seed=0), AdamW lr
      3e-4), 8 steps: losses and grad norms finite, step 0's loss within
      TRAIN_LOSS0_TOL of ln V + sigma^2 / 2 with sigma within
      TRAIN_SIGMA_TOL of the 0.02 sqrt(d_model) the tied embedding gives,
      the last below the first, no kernel launched; step wall, tokens/s,
      idle share, the busiest kernels and ops, peak memory (backward and
      update apart); a 2-layer slice's bf16 gradients within
      MAMBA_GRAD_TOL of f32's per leaf; one backward with dt planted past
      the f32 exp's range, every gradient finite;
  (x) Jamba serving: jamba-v0.1-52b at full width cut to one period (8
      layers: 7 Mamba, 1 attention, 4 MoE FFNs), (t)'s case: 1
      flash_attention launch a prefill, none in decode; the teacher-forcing
      and plain-attention identities under the replayed routing, at the
      logits (JAMBA_TF_TOL, JAMBA_PLAIN_TOL) and at the attention layer's
      output (JAMBA_MIXER_TOL), a wrong cache slot and the kernel's output
      x 0.9 each rejected.
  (y) cross-attention serving, after (x): llama-3.2-vision-90b at full
      width cut to VLM_PERIODS periods (10 layers: 2 cross-attention, 8
      self-attention; random bf16 weights from seed 11), generate() of 32
      greedy tokens after 4 prompts of 2,048 tokens over (4, 1,600, 8,192)
      bf16 media: 72 flash_attention launches (10 in the prefill, 2 a
      decode step: one query row over the cached media), two prefills
      bitwise alike; the teacher-forcing and plain-attention identities at
      the logits (LM_TF_TOL, LM_PLAIN_TOL) and at the cross-attention
      layers' outputs (XATTN_MIXER_TOL), the cached media rolled by one row
      across the batch and the kernel's output x 0.9 in the cross-attention
      layers each rejected; prefill and decode ms, tokens/s, idle shares,
      busiest kernels, peak memory;
  (z) the encoder-decoder: seamless-m4t-large-v2 at full width and depth
      (24 encoder and 24 decoder layers) served as (y) over 4 sources of
      4,096 frames with a 1-token prompt: 816 launches (24 encoder, 48
      decoder in the prefill, 24 a decode step), the kernel's output x 0.9
      in the encoder the second fault, a 2,000-frame source refused by a
      4,096-slot cache; then trained at (q)'s settings for
      AUDIO_TRAIN_STEPS steps: losses and grad norms finite, step 0 near
      ln V + sigma^2 / 2, falling, 144 forward and 72 backward launches a
      step; step wall, tokens/s, idle share, peak memory (backward and
      update apart); a slice of 2 encoder and 2 decoder layers' bf16
      gradients through the kernels and through their plain versions
      against f32's (XATTN_GRAD_RATIO), the backward kernel's dk x 0.9
      rejected; at the end of the run, the forward timed at the vlm's
      cross-attention shape, seamless's encoder shape and both decode
      rows beside SDPA and the bound;
  (aa) the compressed step, after (z), on a one-rank NCCL world: its
      (pod, data, model) = (1, 1, 1) mesh, qwen3-1.7b at (q)'s settings:
      make_train_step_parts' gradients bitwise make_train_step's backward
      (n_micro 1 at full size, 2 at TRAIN_GRAD_LAYERS layers); every
      leaf's compressed mean of step 0's gradients bitwise
      deq(quant(g + r)) in the gradient's dtype and its residual g + r -
      deq, |r| <= scale / 2 (+ RESIDUAL_SLACK), each leaf's share of zero
      codes printed (under its scale, under one scale a layer) beside its
      share of zero gradients; COMPRESSED_STEPS steps of
      make_train_step_compressed (the kernels line's launches_by_path
      "lm_train_compressed"): step 0's residual the one just checked,
      (q)'s loss gates and launches (56 + 28 a step); step wall, tokens/s,
      idle share, peak memory, compressed_psum_mean's device ms; one
      step's torch.profiler trace read by launch/trace_analysis.py: an
      all-gather payload of the parameters' count plus 4 bytes a leaf, 0
      wire bytes at one rank; then the same steps uncompressed and the
      loss gaps; EF_STEPS compressed means of a fixed (151,936, 2,048) f32
      gradient average within scale / EF_STEPS + 1e-4 of it, and a mean
      that drops the residual is rejected by that bound;
  (ab) GPipe at one stage of qwen3-1.7b's 28 layers over GPIPE_MICRO
      microbatches of (1, 2,048, 2,048) bf16 hidden states: bitwise
      reference_pipeline and the stack forward, 112 flash launches
      ("gpipe");
  (ac) deepseek-v2-lite-16b's prefill at full width and depth with
      dispatch_groups = MOE_GROUPS against the global dispatch at a
      capacity where nothing drops, under the global run's routing
      replayed group by group: logits within MOE_TOL, the MoE layers'
      outputs end to end within MOE_E2E_TOL of their max, each MoE layer
      alone on the global run's input within MOE_GROUPED_TOL, 27 flash
      launches ("moe_grouped"); dispatch_groups=3 refused; the drift's
      witnesses printed: the global dispatch at MOE_WIDE times the slots,
      the global run with its first MoE layer grouped, and each layer's
      router logits over a group's rows against the whole call's;
  (ad) after (ac), on a one-rank NCCL world: qwen3-1.7b at (q)'s settings,
      SHARDED_STEPS steps of the sharded (FSDP x TP) step over a (data,
      model) = 1 x 1 mesh under use_mesh (DTensor state, the flash
      kernels on the local shards; "lm_train_sharded", 56 + 28 launches
      a step) against the same steps unsharded from the same parameters
      and batches: losses and parameters bitwise (where they are not, the
      largest difference printed and held at LM_GRAD_TOL and
      SHARDED_LOSS_TOL); the step wall beside the unsharded one and
      (q)'s; launch/train.py --reduced --mesh 1x1 bitwise the unsharded
      CLI, and stopped by SIGTERM after 4 steps and resumed to 6 bitwise;
  (ae) (aa)'s steps again through the sharded inner step over (pod, data,
      model) = 1 x 1 x 1 ("lm_train_compressed_sharded"): losses and
      parameters bitwise (aa)'s;
  (af) deepseek-v2-lite-16b's prefill at full width and depth with
      use_shard_map over a (data, model) = 1 x 1 mesh (expert parallelism
      in every MoE layer, "moe_expert_parallel"), at the no-drop
      capacity: the logits and every MoE layer's output bitwise the plain
      path's, 27 flash launches;
  (ag) qwen3-1.7b at full width, one training step with
      scan_layers=False from the scanned parameters unstacked
      ("lm_train_unscanned"): the loss and every gradient bitwise the
      scanned step's, the parameters after AdamW within a bf16 ulp of the
      larger of their old and new values (the clip norm sums the leaves
      in another grouping).
  (ah) after (o), on a one-rank NCCL world: the hardened engine over
      make_data_mesh(device="cuda") (its lane's backend has the mesh's
      gloo control group, so every decision and launch outcome goes
      through an exchange) against the engine without a mesh on the card,
      on CONFIG_QUANT and the AEU test requests: a clean serve() and
      sessions fed in halves; an injected tile and stream launch fault
      (_flaky_hook) each recovered through one lane restart; (m)'s
      scripted overload and deadlines; session deadlines and an
      idle_timeout sweep with readmission on scripted clocks.  Every
      answer, status and counter bitwise the engine without a mesh; the
      rsnn_infer and rsnn_step_sessions launches of the engines over the
      mesh are the kernels line's launches_by_path "engine_over_mesh";
      the exchanges a launch makes and one exchange's host time printed;
  (ai) after (ah): each example counterpart (examples/*_torch.py) in a
      subprocess on the card at small flags (EXAMPLE_RUNS), all started
      together, each under EXAMPLE_TIMEOUT_S; the run fails on a nonzero
      exit or a story that does not reach its last line.
  (aj) after (ai): the production-mesh dry run (repro_torch.launch.dryrun).
      Its cells run in subprocesses started at the beginning of the run
      (CPU work beside the card's phases, each a fake world whose cuda
      ranks hold fake tensors): (q)'s qwen3-1.7b step at B=4 x S=2,048 on
      one fake rank (a (data, model) = 1 x 1 mesh), and llama3-8b's
      train_4k and decode_32k cells on the 16 x 16 production mesh (256
      fake ranks), each cell's record and wall seconds logged.  Then the
      same qwen3 step for real on the card (the dry run's cell_step on a
      one-rank NCCL world, random weights): FlopCounterMode's count of the
      real step must equal the fake run's per-rank flops exactly, and the
      fake run's predicted peak (argument_bytes + temp_bytes) must lie
      within DRYRUN_PEAK_TOL of the bytes the step adds to
      torch.cuda.max_memory_allocated over what it started with.  The
      real step's launches are the kernels line's launches_by_path
      "dryrun_real_step".
  (ak) after (aj), on a one-rank NCCL world: deepseek-v2-lite-16b at
      (u)'s 3 layers with dispatch_groups = MESH_LOCAL_GROUPS, its MoE
      layers on the mesh's own-rows path (each rank its own groups and
      experts, models/moe.py:_moe_on_mesh): MESH_LOCAL_STEPS sharded
      steps over (data, model) = 1 x 1 against the same steps unsharded
      (losses and parameters bitwise, else held as (ad)'s), and a prefill
      under use_mesh bitwise the unsharded prefill (logits and caches);
      llama3-8b at MESH_LOCAL_DECODE_LAYERS layers prefilled and decoded
      over a cache whose slots split over model (kv_shard="seq": each
      rank attends to its own slots, the partials merged by their
      log-sum-exp), every logit bitwise the unsharded run's; then the dry
      run of deepseek's train_4k on the 16 x 16 mesh with 16 dispatch
      groups (started with (aj)'s cells), its per-rank peak printed.  The
      flash launches of its train steps, prefills and the decode run's
      prefill are the kernels line's launches_by_path "mesh_local".
  (al) after (ak): exact-mode e-prop (EpropConfig(mode="exact")).
      rsnn_train_exact against its plain version at Braille T=256 B=1
      (quantized and float), the END_B tile (T=128, B=70), the cue net
      (40/100/2, T=150), the 256/256/16 net (T=128, B=4: a row on three
      clusters of eight blocks) and a per-neuron alpha (T=256, B=8, float
      and quantized):
      dw within TRAIN_DW_TOL of max|dw|, acc_y and n_spk bitwise when
      quantized, two launches bitwise; on the commit grid at the END_B
      tile the codes bitwise the plain reduce of the launch's partials and
      within TRAIN_DW_TOL of max|dw| plus B lsb of the plain B=1 loop, the
      count that differ printed.  Then one epoch of quantized END_S
      learning on Braille AEU (seed 1) in exact mode (420 rsnn_train_exact
      launches, none of rsnn_train) and in factored mode, in turns (exact,
      factored, factored, exact), test accuracy and walls printed; the
      exact-trained weights served by BatchedEngine.from_learner bitwise
      the backend's inference (launches_by_path "exact_learning"); at the
      end of the run rsnn_train_exact timed at T=256 B=1 (the kernels
      line), at the learning run's T=128 B=1 and at the END_B tile, with
      rsnn_train beside.
  (am) after (al): the surrogate (cfg.neuron.surrogate).  rsnn_forward,
      rsnn_train and rsnn_train_exact under the triangular
      pseudo-derivative (gamma 0.3) and a boxcar of half-width 0.25,
      against their plain versions at Braille T=256 B=1 and the END_B
      tile (T=128, B=70), quantized and float, and the cue net (40/100/2,
      T=150, quantized): dw within TRAIN_DW_TOL of max|dw|, acc_y, n_spk,
      rsnn_forward's streams (h among them) and rsnn_train's traces
      bitwise when quantized, each kernel's h another than the default
      boxcar's.  Then one epoch of factored END_S learning on Braille AEU
      (seed 1, quantized) under the triangular surrogate, 420 rsnn_train
      launches (launches_by_path "surrogate"), its test accuracy beside
      (al)'s boxcar epoch, gated on finite weights that moved; the phase's
      own seconds printed.  At the end of the run the three kernels timed
      under the triangular surrogate beside the boxcar at T=256 B=1 and
      the END_B tile (the kernels line's "triangular").
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# Float-mode tolerance, kernel vs plain version: the weights are taken on
# the Q(8,4) SRAM grid, so every product and partial sum is exact in f32
# and only the (identically ordered) leak roundings remain; 1e-4 relative
# absorbs any difference in the order of the accumulator sums.
FLOAT_TOL = 1e-4
# Training kernels: max|Δdw| <= TRAIN_DW_TOL * max|dw| per matrix, kernel
# vs plain version, in both modes — the readout error goes through expf and
# the kernel sums the products in another order than torch.matmul.
TRAIN_DW_TOL = 1e-4
# rsnn_train's readout error trace, kernel vs plain version: expf against
# torch.softmax, on the same y (bitwise when quantized): a few f32 ulps of
# values below 1 (tests/test_torch_train.py holds the JAX reference to the
# plain version at the same limit).  In float mode y is held to FLOAT_TOL.
TRAIN_ERR_TOL = 1e-6
# Learning gates.  One 12-epoch run's test accuracy is a noisy draw of its
# seed (initial weights and stochastic commits): the JAX reference's
# quantized END_S spans 0.35-0.92 over seeds 1-40.  So the gates read the
# median over LEARN_SEEDS, a fixed range never chosen by its outcome:
# END_S's median is at least the JAX reference's median over the same
# seeds less END_S_MARGIN, and END_B's median is within END_B_MAX_GAP of
# END_S's (bench_braille.quant_smoke's gap between the commit modes, taken
# for the margin too; chance is 1/3).  JAX_END_S_MEDIAN is the median of
#   benchmarks/bench_braille.py:run("AEU", epochs=12, seed=s, eval_every=12,
#       commit="sample", backend="scan", quantized=True)["test_acc"]
# for s in LEARN_SEEDS, run on a CPU.
LEARN_EPOCHS = 12
LEARN_SEEDS = tuple(range(1, 17))
JAX_END_S_MEDIAN = 0.7167
END_S_MARGIN = 0.10
END_S_MIN_MEDIAN = JAX_END_S_MEDIAN - END_S_MARGIN
END_B_MAX_GAP = 0.10
# flash_attention, kernel vs plain version (j).  f32: both sum each score
# (D = 128 products) and each output (up to 2,048 terms, tile by tile) in
# f32, in different orders and with different tile boundaries for the
# running max, so they differ by a few f32 ulps of max|o|; 1e-5 of max|o|
# leaves room for a 2,048-term sum.  bf16: per query row, within
# kernels/flash_attention.py:BF16_ROW_TOL of the row's largest output (see
# the justification there).  Each case also plants two faults (the output
# scaled by 0.9, and one key tile lost from the later rows) and fails
# unless the gate rejects both.
FLASH_F32_TOL = 1e-5
# The LM path (k): llama3-8b at full width and depth, B prompts of LM_PROMPT
# tokens, LM_STEPS greedy tokens.
LM_ARCH = "llama3-8b"
LM_BATCH = 4
LM_PROMPT = 2048
LM_STEPS = 32
# bf16 logits, max |Δ| over the (B, vocab) last-token logits, whose scale
# is about 1 (ln_f's output has unit rms, lm_head is fan-in scaled; the
# largest of the 4 x 128,256 lie in [4, 8), where a bf16 ulp is 2^-5).
# Both comparisons run the same weights through paths that differ only in
# where f32 sums round to bf16: the decode path's M=B matmuls and f32
# softmax against the prefill's M=B·L matmuls and the flash kernel
# (LM_TF_TOL), or the kernel against the plain version (LM_PLAIN_TOL).
# Each of the 32 layers rounds its residual stream and sublayer outputs to
# bf16, so a rounding that lands apart in one layer is carried to the
# logits.  Measured on an H100 80GB HBM3 (700 W): 0.033 for both, one ulp
# of the largest logits.  The tolerance is 4 such ulps, 0.125: room for
# roundings to compound on other weights, far below what a wrong mask,
# position or cache slot does (it moves logits by their own scale, ~1).
LM_TF_TOL = 0.125
LM_PLAIN_TOL = 0.125
# flash_attention_bwd vs its plain version (p): dq, dk, dv within
# FLASH_F32_TOL of each tensor's max |.| in f32, and in bf16 per row within
# kernels/flash_attention.py:BWD_BF16_ROW_TOL of the row's scale
# (grad_row_error, justified there); each case plants dk x 0.9 and q tile
# 1 dropped from dk and dv, and fails unless the gate rejects both.  The
# forward's lse, kernel vs plain: both take m + log(l) in f32 from scores
# summed in another order (a few f32 ulps of values below 16); 1e-4
# absolute.
BWD_LSE_TOL = 1e-4
BWD_CASES = [   # name, B, S, H, Hkv, D, dtype, causal, strided
    ("qwen3-1.7b training", 4, 2048, 16, 8, 128, torch.bfloat16, True, False),
    ("llama3-8b heads", 4, 2048, 32, 8, 128, torch.bfloat16, True, False),
    ("ragged causal", 2, 1000, 16, 8, 128, torch.bfloat16, True, False),
    ("non-causal, strided views, non-contiguous dO", 2, 700, 16, 8, 128,
     torch.bfloat16, False, True),
    ("qwen3-1.7b heads, f32", 2, 1000, 16, 8, 128, torch.float32, True, False),
]
# LM training (q): qwen3-1.7b at full width and depth in bf16 with
# remat="full", B=4 x S=2,048 tokens from TokenStream(seed=0), the step
# launch/train.py builds (AdamW lr 3e-4, 10 warm-up steps), TRAIN_STEPS
# steps without checkpoints (one is about 17 GB at this size).  Step 0's
# loss is within TRAIN_LOSS0_TOL of ln(vocab): the random weights' logits
# have a scale near 0.2.  The gradients of one step at the arch's widths
# and TRAIN_GRAD_LAYERS layers, through the kernels and through their
# plain versions, agree per leaf within LM_GRAD_TOL of the leaf's max |g|:
# the two differ only in where attention's f32 sums round to bf16; the
# plain version at two tile sizes differs by at most 0.0075 of a leaf's
# max |g| (reduced qwen3, bf16, S=512: tests/_torch_lm_bf16_spread.py on
# a CPU), and 2^-5 leaves four times that.
TRAIN_ARCH = "qwen3-1.7b"
TRAIN_BATCH = 4
TRAIN_SEQ = 2048
TRAIN_STEPS = 8
TRAIN_LR = 3e-4
TRAIN_LOSS0_TOL = 0.5
# (u)'s untied lm_head is drawn at d_model^-0.5 and ln_f's output has unit
# rms, so the initial logits' std is 1 (measured 0.9997); a scale fault in
# the logits would move ln V + sigma^2 / 2 with them, so sigma itself is
# held within this of 1.
TRAIN_SIGMA_TOL = 0.05
TRAIN_GRAD_LAYERS = 2
LM_GRAD_TOL = 2 ** -5
# MLA's attention widths in deepseek-v2 (q and k 128 + 64 rope wide, v 128
# wide, 16 heads, as many KV heads) and (s)'s cases of the pair: the
# prefill and training shape (B=4, S=2,048), a ragged causal length, a
# non-causal case on strided views with a non-contiguous dO.
MLA_DK, MLA_DV, MLA_HEADS = 192, 128, 16
MLA_CASES = [   # name, B, Sq, Skv, H, causal, strided
    ("deepseek-v2-lite training", 4, 2048, 2048, MLA_HEADS, True, False),
    ("ragged causal", 2, 1000, 1000, MLA_HEADS, True, False),
    ("non-causal, strided views, non-contiguous dO", 2, 700, 700, MLA_HEADS, False, True),
]
# MoE and MLA serving (t): deepseek-v2-lite-16b at full width and depth, B
# prompts of MOE_PROMPT tokens, MOE_STEPS greedy tokens; phi3.5-moe at full
# width and MOE_PHI_LAYERS layers (41.9 B parameters do not fit 80 GB),
# MOE_PHI_STEPS greedy tokens.  The served runs keep the configs' capacity
# factor (1.25); the two logit identities run where nothing drops, with
# the routing of the run compared with replayed.  Each run's own routing
# is measured and reported, not gated: with their own routings the two
# runs of deepseek differed in 58 of 104 and 116,440 of 212,992 (token,
# MoE layer) top-6 sets, their logits by 2.48 and 3.0 (std 1.0).  A token
# whose router probabilities nearly tie picks another expert when a
# rounding lands apart, and such flips compound through the layers until
# the logits decorrelate.  Under the replayed routing the two identities
# measured 0.203 and 0.178 for deepseek and 0.109 and 0.070 for
# phi3.5-moe (NVIDIA H100 80GB HBM3, 700.00 W).  phi3.5-moe fits the
# dense family's LM_TF_TOL and LM_PLAIN_TOL (0.125, from 0.033 at
# llama3-8b) and is held to them.  deepseek is not: its routed experts'
# w_gate and w_up are drawn at n_experts^-0.5 (1/8 at 64 experts;
# make_param's fan-in is their first axis, the experts, in both packages)
# where a dense FFN's are at d_model^-0.5 (1/45), so each of its 26 MoE
# layers amplifies a rounding that lands apart.  Its tolerance, MOE_TOL, is
# 0.375 for both identities, 1.8 times the larger measured spread.  Every
# run plants two faults under the same replayed routing and fails unless
# each moves the logits by more than the arch's tolerance: decode at slot
# L - 1 (measured 0.5625 deepseek, 3.93 phi3.5-moe) and the kernel's
# output x 0.9 in every layer (1.95 deepseek, 0.142 phi3.5-moe).
MOE_TOL = 0.375
MOE_ARCH = "deepseek-v2-lite-16b"
MOE_BATCH = 4
MOE_PROMPT = 2048
MOE_STEPS = 32
MOE_PHI_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_PHI_LAYERS = 4
MOE_PHI_STEPS = 8
# phi3.5-moe's identities are also held at its four GQA layers' outputs
# (after wo), relative to their max, within MOE_PHI_MIXER_TOL, as (x)
# holds jamba's: at the last position's logits, under the kernel run's
# routing, the kernel's output x 0.9 moved them by 0.1418 with an earlier
# mma.sync forward and 0.1094 with the Hopper forward (its logits 0.0625
# from the plain version's: roundings reach half the fault there),
# against LM_PLAIN_TOL 0.125, so the logits alone cannot tell that fault
# from roundings.  At the GQA outputs the identities measured 0.0062
# (teacher forcing) and 0.0066 (plain attention) and the faults 0.1071
# (x 0.9) and 0.2344 (wrong slot); 2^-5 is the flash kernel's own bf16
# row tolerance.
MOE_PHI_MIXER_TOL = 2 ** -5
# MoE and MLA training (u): deepseek-v2-lite-16b at full width with the
# dense prefix layer and two MoE layers (1.67 B parameters), the (q)
# settings otherwise.
MOE_TRAIN_LAYERS = 3
MOE_TRAIN_STEPS = 8
# Mamba2 serving (v): mamba2-1.3b at full width and depth, B prompts of
# MAMBA_PROMPT tokens, MAMBA_STEPS greedy tokens.  The teacher-forcing
# identity (decode at L on the prefill state of L == prefill(L+1)'s last
# logits) differs only in where bf16 roundings land: the one-step
# recurrence against the chunked SSD, M=B against M=B.L projections,
# through 48 layers.  Measured 0.0835 on an H100 80GB HBM3 (700 W), 2.7
# bf16 ulps of the largest logits (in [2, 4), logits std 0.906); the
# planted faults moved the logits by 0.805 (layer MAMBA_FAULT_LAYER's
# state zeroed) and 0.355 (its conv tails rolled by one position).
# MAMBA_TF_TOL is 6 such ulps, 2.2 times the spread and half the smaller
# fault.  Layer 0's chunked SSD against its per-step recurrence on the
# layer's own inputs, per max |y| and max |final state|: f32 within
# MAMBA_SSD_F32_TOL (measured 5.3e-7); with compute_dtype bf16 within
# MAMBA_SSD_BF16_TOL (measured 0.0302): the within-chunk cumulative decays
# are cast to bf16, whose ulp is 2^-4 where they reach 8-16 (this run's
# chunk decay sums reach 12.7), so each exp(cum_i - cum_j) carries up to
# 2^-5 of its size; the tolerance is one such ulp.
MAMBA_ARCH = "mamba2-1.3b"
MAMBA_BATCH = 4
MAMBA_PROMPT = 2048
MAMBA_STEPS = 32
MAMBA_TF_TOL = 0.1875
MAMBA_FAULT_LAYER = 24
MAMBA_SSD_F32_TOL = 1e-4
MAMBA_SSD_BF16_TOL = 2 ** -4
# Mamba2 training (w): the (q) settings at mamba2-1.3b's full width and
# depth, MAMBA_TRAIN_STEPS steps.  The bf16 gradients of TRAIN_GRAD_LAYERS
# layers against the same weights' f32 gradients per leaf, within
# MAMBA_GRAD_TOL of the leaf's max |g|: measured 0.0123 (median 0.0053),
# bf16 roundings of every activation and product; 2^-5 leaves 2.5 times
# that.  One backward with every dt_bias of that slice at
# MAMBA_PLANTED_DT_BIAS (dt near 4: a 64-step chunk's decay sum near 256,
# measured 306.7, past the f32 exp's 88.7) gives finite gradients.
MAMBA_TRAIN_STEPS = 8
MAMBA_GRAD_TOL = 2 ** -5
MAMBA_PLANTED_DT_BIAS = 4.0
# Jamba serving (x): jamba-v0.1-52b at full width cut to JAMBA_LAYERS
# layers (one period; 51.5 B parameters do not fit 80 GB), the (t)
# prompts, JAMBA_STEPS greedy tokens.  Under the replayed routing the
# logits' identities measured 0.1133 (teacher forcing) and 0.0469 (plain
# attention) on an H100 80GB HBM3 (700 W): like phi3.5-moe (0.109), its 16
# experts' w_gate and w_up are drawn at n_experts^-0.5 = 1/4, so the four
# MoE layers amplify the roundings of the seven Mamba layers.
# JAMBA_TF_TOL and JAMBA_PLAIN_TOL, 0.25, are 2.2 times the larger.  At
# the logits the one attention layer of eight is diluted: the kernel's
# output x 0.9 moved them by 0.0547 and a wrong cache slot by 0.125, inside
# those tolerances.  So each identity is also held at the attention
# layer's output (after wo), relative to its max, within JAMBA_MIXER_TOL:
# measured 0.0079 (teacher forcing: the layers before it differ by
# roundings) and 0.0014 (plain attention: the same inputs), while the
# faults moved it by 0.103 (x 0.9) and 0.143 (wrong slot).  2^-5, the
# flash kernel's own bf16 row tolerance, is 4 times the larger spread and
# a third of the smaller fault.
JAMBA_ARCH = "jamba-v0.1-52b"
JAMBA_LAYERS = 8
JAMBA_STEPS = 32
JAMBA_TF_TOL = 0.25
JAMBA_PLAIN_TOL = 0.25
JAMBA_MIXER_TOL = 2 ** -5
# Cross-attention serving, (y) and (z): llama-3.2-vision-90b at full width
# cut to VLM_PERIODS periods (10 layers: 2 cross-attention, 8
# self-attention; 87.7 B parameters, 175 GB in bf16, do not fit 80 GB,
# and one period would not stack the cross caches across repeats), B
# prompts of VLM_PROMPT tokens over n_media_tokens (1,600) media
# embeddings, VLM_STEPS greedy tokens; seamless-m4t-large-v2 at full width
# and depth (24 encoder and 24 decoder layers), B sources of enc_seq
# (4,096) frames and a prompt of AUDIO_PROMPT token (the JAX package's
# prefill shape for the encoder-decoder), AUDIO_STEPS greedy tokens.  The
# media and the frames are bf16, STUB_SCALE * N(0, 1), from a seeded
# generator.  Both hold the dense family's identities at the logits
# (LM_TF_TOL, LM_PLAIN_TOL: their logits' scale is llama3-8b's, an untied
# fan-in scaled lm_head after a unit-rms ln_f) and, as (x) does for its
# one attention layer, at the cross-attention layers' outputs (after wo)
# relative to their max within XATTN_MIXER_TOL, the flash kernel's own
# bf16 row tolerance: 2 of the vlm's 10 layers are cross-attention, so
# the logits dilute what they do.  A planted fault must move one of the
# two points past its tolerance.  AUDIO_SHORT_SOURCE frames into a cache
# of enc_seq slots must be refused.
VLM_ARCH = "llama-3.2-vision-90b"
VLM_PERIODS = 2
VLM_BATCH = 4
VLM_PROMPT = 2048
VLM_STEPS = 32
STUB_SCALE = 0.02
XATTN_MIXER_TOL = 2 ** -5
AUDIO_ARCH = "seamless-m4t-large-v2"
AUDIO_BATCH = 4
AUDIO_PROMPT = 1
AUDIO_STEPS = 32
AUDIO_SHORT_SOURCE = 2000
# Encoder-decoder training (z): seamless-m4t-large-v2 at full width and
# depth, (q)'s settings (bf16, remat="full", B=4 x S=2,048 tokens and as
# many source frames from TokenStream(seed=0, family="audio"), AdamW lr
# 3e-4), AUDIO_TRAIN_STEPS steps.  Then one step's gradients of a slice
# of TRAIN_GRAD_LAYERS encoder and as many decoder layers, in bf16
# through the kernels and through their plain versions, held per leaf to
# each other within LM_GRAD_TOL, as (q) and (u) hold theirs, and each
# against the same weights' f32 gradients through the plain versions
# (full f32 matmuls): the kernels' distance from f32 within the larger of
# LM_GRAD_TOL and XATTN_GRAD_RATIO times the plain versions' own.  The
# second gate sees what the first cannot, a fault both share: with the
# backward's δ taken from the bf16-rounded output, the cross-attention's
# wq, wk and ln_x gradients (which cancel over keys that share a large
# part) lay 0.49-0.67 of their max from f32, kernels and plain versions
# alike, 0.20 apart (an H100 80GB HBM3 at 700 W); JAX's bf16 gradient lies
# 0.02-0.03 from f32 there (a CPU at 2 + 2 layers, S=512).  With δ from
# the forward's f32 output they measured 0.011-0.014 from f32 and 0.010
# apart.
AUDIO_TRAIN_STEPS = 8
XATTN_GRAD_RATIO = 2
# (aa)-(ac): the compressed step at (q)'s settings, the error-feedback
# drill's steps (the bound of tests/test_runtime.py's convergence test),
# GPipe's microbatches and deepseek's dispatch groups; each MoE layer
# alone, grouped, on the global run's input to it and under the same
# routing, is held to the global dispatch's output within (q)'s gradient
# tolerance, MOE_GROUPED_TOL (measured at most 0.0056 of its max, a bf16
# ulp: the f32 router logits over a group's 2,048 rows differ from the
# whole call's by ~7e-7 of their max, while the global dispatch at
# MOE_WIDE times the slots is bitwise).  End to end the MoE outputs drift
# further as that rounding compounds through 26 MoE layers: 0.058 of
# their max, and 0.052 for the global run with only its first MoE layer
# grouped (NVIDIA H100 80GB HBM3, 700.00 W), so no bound near 2^-5 holds.
# MOE_E2E_TOL is 2^-3, 2.2 times the grouped reading.
COMPRESSED_STEPS = 8
EF_STEPS = 50
# |g32 - deq| <= scale / 2 in exact arithmetic; the f32 difference may
# round past it by an ulp of the largest |g32| (127 scales)
RESIDUAL_SLACK = 127 * 2 ** -23
GPIPE_MICRO = 4
MOE_GROUPS = 4
MOE_GROUPED_TOL = 2 ** -5
MOE_E2E_TOL = 2 ** -3
MOE_WIDE = 2
# (ad)-(ag): the sharded step's steps; where one rank's DTensor dispatch is
# not bitwise, its losses are held within this of the unsharded run's.
SHARDED_STEPS = 3
SHARDED_LOSS_TOL = 2 ** -5
# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, non-tensor f32 and
# dense bf16 tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_TENSOR_FLOPS_PER_S = 989e12
SEED = 11
# Learning while serving (m): one END_B epoch on Braille AEU (6 commits of
# 70 samples), LWS_SERVE_PER_BATCH requests answered after each commit from
# an EventStream over LWS_REPEAT shuffled passes of the test split (60
# samples each), the rest after the epoch.
LWS_REPEAT = 5
LWS_SERVE_PER_BATCH = 16
# Kill and resume (n): the Braille drill at the paper's shape, 12/38/3
# quantized with stochastic commits, T=128, the dataset's default AEU split
# (420 training samples), END_B at 70 a batch for 2 epochs (12 commits),
# a checkpoint at every commit.  The SIGKILL commit is drawn from
# FT_KILL_RANGE by a generator seeded with SEED.
FT_EPOCHS = 2
FT_SPB = 70
FT_TICKS = 128
FT_SAMPLES_PER_CLASS = 200
FT_KILL_RANGE = (2, 11)
FT_MID_SAVE_STEP = 3
FT_SIGTERM_AT = 4
FT_TRAINER_STOP = 5
FT_SPAWN_TIMEOUT_S = 300.0
# (ai): each example counterpart's flags after --device cuda (or a call of
# its run function) and the line its story ends on
EXAMPLE_TIMEOUT_S = 300
EXAMPLE_RUNS = {
    "quickstart_torch": ("run('cuda', n_train=10, n_val=10, epochs=1)", "epoch    0"),
    "braille_online_learning_torch": (["--epochs", "1", "--commit", "batch"],
                                      "AEU test accuracy"),
    "streaming_sessions_torch": (["--epochs", "0", "--users", "8", "--bursts", "2"],
                                 "8 sessions closed"),
    "multi_model_serving_torch": (["--braille-epochs", "0", "--cue-epochs", "1",
                                   "--batch", "8"], "one engine, two SRAM programs"),
    "lm_serve_torch": (["--steps", "4", "--batch", "2", "--prompt-len", "16"],
                       "generated (2, 4) tokens"),
    "fault_tolerant_train_torch": (
        "run('cuda', ckpt_dir={ckpt!r}, steps=(4, 6), ckpt_every=2, batch=2, seq=32)",
        "fault-tolerance drill complete"),
    "serve_braille_torch": (["--epochs", "1", "--batch", "8"],
                            "interleaved train+serve epoch"),
}


# (aj): the dry run's cells, where their records go, and how far the fake
# run's predicted peak may lie from the real step's measured one.
DRYRUN_DIR = "build/dryrun_aj"
DRYRUN_ONE_RANK = ["--arch", "qwen3-1.7b", "--shape", "train_4k", "--mesh", "1x1",
                   "--batch", "4", "--seq", "2048", "--no-calibrate", "--tag", "aj"]
DRYRUN_PRODUCTION = ["--arch", "llama3-8b", "--shape", "train_4k,decode_32k",
                     "--jobs", "2", "--tag", "aj"]
DRYRUN_TIMEOUT_S = 900
DRYRUN_PEAK_TOL = 0.10
# (ak): deepseek at (u)'s depth with its dispatch in MESH_LOCAL_GROUPS
# groups, trained MESH_LOCAL_STEPS steps and prefilled over a one-rank
# (data, model) mesh; llama3-8b at MESH_LOCAL_DECODE_LAYERS layers
# prefilled with MESH_LOCAL_PROMPT tokens and decoded MESH_LOCAL_DECODE_STEPS
# steps over a cache whose slots split over model; the dry run of
# deepseek's train_4k on the 16 x 16 mesh with 16 dispatch groups (one a
# data rank), started with (aj)'s.
MESH_LOCAL_GROUPS = 2
MESH_LOCAL_STEPS = 2
MESH_LOCAL_DECODE_ARCH = "llama3-8b"
MESH_LOCAL_DECODE_LAYERS = 4
MESH_LOCAL_PROMPT = 512
MESH_LOCAL_DECODE_STEPS = 4
DRYRUN_GROUPED = ["--arch", "deepseek-v2-lite-16b", "--shape", "train_4k", "--moe-groups",
                  "16", "--no-calibrate", "--tag", "ak"]


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def setup(root: Path):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false — the port runs on the card")
    src = root / "src"
    if not (src / "repro_torch").is_dir():
        fail(f"no repro_torch package under {src}: run from a checkout")
    sys.path.insert(0, str(src))
    # The quantized plain version relies on full-f32 matmuls.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# (a) build
# ---------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    secs = time.perf_counter() - t0
    regs = [ln.strip() for ln in str(build.build_log.get("ptxas", "")).splitlines()
            if "registers" in ln or "spill" in ln]
    log(f"(a) ok: kernels built and loaded in {secs:.1f} s: {' | '.join(regs)}")


# ---------------------------------------------------------------------------
# (b) kernel vs plain version
# ---------------------------------------------------------------------------


def _inputs(gen, T, B, n_in, density, dev):
    raster = (torch.rand((T, B, n_in), generator=gen) < density).float()
    label_tick = torch.randint(0, T // 2, (B,), generator=gen)
    end_tick = torch.randint(T // 2, T, (B,), generator=gen)
    t = torch.arange(T)[:, None]
    valid = ((t >= label_tick) & (t <= end_tick)).float()
    n_live = torch.randint(T // 2, T + 1, (B,), generator=gen)
    live = (t < n_live).float()
    live[T // 4: T // 4 + 5, ::3] = 0.0           # holes mid-chunk
    return raster.to(dev), valid.to(dev), live.to(dev)


def _err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _compare(name, got, want, quantized, errs):
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.isfinite(g).all():
            fail(f"{name}: kernel output shape {tuple(g.shape)} / non-finite")
        e = _err(g, w)
        errs.append(e)
        if quantized:
            if not torch.equal(g, w):
                fail(f"{name}: kernel differs from plain version (max {e})")
        elif not torch.allclose(g, w, rtol=FLOAT_TOL, atol=FLOAT_TOL):
            fail(f"{name}: float kernel off by {e} (> {FLOAT_TOL})")


def _check_equal(name, got, want):
    """Two kernel results that must agree bit for bit."""
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            fail(f"{name}: differs (max {_err(g, w)})")


def phase_kernels_vs_plain(dev):
    from repro_torch.core.backend import ExecutionBackend
    from repro_torch.core.rsnn import Presets, init_params
    from repro_torch.kernels import rsnn_step as K
    from repro_torch.serve import batching

    gen = torch.Generator().manual_seed(SEED)
    braille_q = Presets.braille(quantized=True)
    braille_f = Presets.braille(quantized=False)
    cue_q = Presets.cue_accumulation(quantized=True)
    cue_f = Presets.cue_accumulation(quantized=False)
    chipmax_q = Presets.braille(quantized=True, n_in=256, n_hid=256, n_out=16)
    chipmax_q = dataclasses.replace(
        chipmax_q, neuron=dataclasses.replace(chipmax_q.neuron, reset="sub"))
    chipmax_f = dataclasses.replace(chipmax_q, neuron=dataclasses.replace(
        chipmax_q.neuron, quant=None))
    tile = batching.max_batch_for(braille_q)
    cases = [   # name, config, B, infer window, input density, T
        ("braille quant full tile", braille_q, tile, "valid", 0.12, 256),
        ("braille quant B=1", braille_q, 1, "valid", 0.12, 256),
        ("braille quant ragged all-window", braille_q, 335, "all", 0.12, 256),
        ("braille float full tile", braille_f, tile, "valid", 0.12, 256),
        # longer than one chunk of the serving plan
        ("braille quant B=1, T=1100", braille_q, 1, "valid", 0.12, 1100),
        ("braille quant full tile, T=1100", braille_q, tile, "valid", 0.12, 1100),
        ("cue quant full tile", cue_q, batching.max_batch_for(cue_q), "valid", 0.1, 256),
        ("cue float ragged all-window", cue_f, 77, "all", 0.1, 256),
        ("chip-max quant", chipmax_q, batching.max_batch_for(chipmax_q), "valid", 0.05, 256),
        ("chip-max quant B=1", chipmax_q, 1, "all", 0.05, 256),
        ("chip-max float", chipmax_f, 64, "valid", 0.05, 256),
    ]
    errs = {"rsnn_infer": [], "rsnn_step_sessions": []}
    for name, cfg, B, window, density, T in cases:
        cfg = dataclasses.replace(cfg, eprop=dataclasses.replace(
            cfg.eprop, infer_window=window))
        quantized = cfg.neuron.quant is not None
        be = ExecutionBackend(cfg, device=dev)
        params = init_params(gen, cfg, device=dev)
        # weights on the SRAM grid in both modes (see FLOAT_TOL)
        params = {k: (torch.round(v * 16) / 16).clamp(-8, 127 / 16)
                  if k != "alpha" else v for k, v in params.items()}
        w_in, w_rec, w_out = be.datapath_weights(params)
        w = (w_in, w_rec, w_out)
        raster, valid, live = _inputs(gen, T, B, cfg.n_in, density, dev)
        kw = dict(alpha=be.alpha, kappa=cfg.neuron.kappa, v_th=cfg.neuron.v_th,
                  reset=cfg.neuron.reset, quant=be.quant, infer_window=window)
        got = K.rsnn_infer_cuda(raster, valid, *w, **kw)
        again = K.rsnn_infer_cuda(raster, valid, *w, **kw)
        want = K.rsnn_infer_plain(raster, valid, *w, **kw)
        torch.cuda.synchronize()
        _compare(f"{name} rsnn_infer", got, want, quantized, errs["rsnn_infer"])
        _check_equal(f"{name}: two rsnn_infer launches", got, again)
        spikes = float(want[1].sum())
        st = be.init_session_state(B)
        zero = [st[k] for k in ("v", "z", "y", "acc_y", "n_spk")]
        # a session tile from zero carries, every tick live, is rsnn_infer
        ses = K.rsnn_step_sessions_cuda(raster, torch.ones_like(live), valid, *zero, *w,
                                        **kw)
        _check_equal(f"{name}: rsnn_step_sessions from zero carries vs rsnn_infer",
                     ses[3:], got)
        # chained ragged tiles, one of a single tick: each starts from the
        # carries of the one before
        carries = zero
        for lo, hi in ((0, 1), (1, T // 2), (T // 2, T)):
            args = (raster[lo:hi].contiguous(), live[lo:hi].contiguous(),
                    (valid[lo:hi] * live[lo:hi]).contiguous(), *carries, *w)
            got = K.rsnn_step_sessions_cuda(*args, **kw)
            want = K.rsnn_step_sessions_plain(*args, **kw)
            torch.cuda.synchronize()
            _compare(f"{name} rsnn_step_sessions [{lo}:{hi}]", got, want,
                     quantized, errs["rsnn_step_sessions"])
            carries = list(want)
        plan = K.serve_plan(T, B, cfg.n_in, cfg.n_hid, cfg.n_out)
        chunks = -(-T // plan.Tc)
        if T > 256 and chunks < 2:
            fail(f"{name}: T={T} ran in one chunk of {plan.Tc} ticks")
        log(f"(b) ok: {name} (T={T}, B={B}, {cfg.n_in}/{cfg.n_hid}/{cfg.n_out}, "
            f"window={window}, spikes={spikes:.0f}; plan {plan.rows} rows a block, "
            f"{chunks} chunk(s) of {plan.Tc} ticks, weights in "
            f"{'shared' if plan.weights_smem else 'global'} memory); two launches "
            f"and sessions from zero carries equal rsnn_infer bitwise")
    return {k: max(v) for k, v in errs.items()}


# ---------------------------------------------------------------------------
# (c) serve(), (d) sessions, (e) launch counts
# ---------------------------------------------------------------------------


def _requests():
    from repro_torch.data.braille import BrailleConfig, make_braille_dataset
    from repro_torch.serve import batching

    data = make_braille_dataset("AEU", BrailleConfig(num_ticks=256,
                                                     samples_per_class=100))
    reqs = [batching.trim_padding(row) for split in ("train", "val", "test")
            for row in data[split]["events"]]
    return reqs, data["train"]["event_density"]


def phase_serve(dev, params, reqs):
    from repro_torch.configs.reckon_braille import CONFIG_QUANT
    from repro_torch.serve import BatchedEngine

    eng = BatchedEngine(CONFIG_QUANT, params, device=dev)
    t0 = time.perf_counter()
    res, stats = eng.serve(iter(reqs))
    wall = time.perf_counter() - t0
    # the same requests through the plain version
    ref_eng = BatchedEngine(CONFIG_QUANT, {k: v.cpu() for k, v in params.items()},
                            device="cpu")
    ref, _ = ref_eng.serve(iter(reqs))
    if len(res) != len(reqs) or len(ref) != len(reqs):
        fail("serve() returned a result count unlike the request count")
    for r, g in zip(res, ref):
        if r.logits.shape != (CONFIG_QUANT.n_out,) or not np.isfinite(r.logits).all():
            fail(f"request {r.rid}: bad logits {r.logits}")
        if r.pred != g.pred or not np.array_equal(r.logits, g.logits):
            fail(f"request {r.rid}: card {r.logits} != plain {g.logits}")
    # the inference op through run_tile on the same requests
    for ev in reqs:
        eng.submit(ev)
    tiles = list(eng.scheduler.drain())
    got = [r for t in tiles for r in eng.run_tile(t)]
    for r, g in zip(got, ref):
        if r.pred != g.pred or not np.array_equal(r.logits, g.logits):
            fail(f"run_tile request: card {r.logits} != plain {g.logits}")
    acc = float(np.mean([r.pred == r.label for r in res]))
    log(f"(c) ok: serve() {len(res)} requests in {stats.batches} tile(s), "
        f"{wall * 1e3:.1f} ms wall, {stats.samples_per_sec:.0f} samples/s, "
        f"bitwise equal to the plain version; run_tile {len(tiles)} tile(s) "
        f"equal too; accuracy of the random-weight net {acc:.3f}")
    return res, stats


def phase_sessions(dev, params, reqs, served):
    from repro_torch.configs.reckon_braille import CONFIG_QUANT
    from repro_torch.serve import BatchedEngine

    eng = BatchedEngine(CONFIG_QUANT, params, device=dev, max_batch=128,
                        max_sessions=128, tick_tile=32)
    rng = np.random.default_rng(SEED)
    handles = [eng.open_session() for _ in reqs]
    feeds = []
    for i, ev in enumerate(reqs):
        if i % 2:
            feeds.append([ev[j:j + 1] for j in range(len(ev))])
        else:
            cuts = np.sort(rng.integers(0, len(ev) + 1, size=12))
            feeds.append([ev[a:b] for a, b in zip([0, *cuts], [*cuts, len(ev)])])
    t0 = time.perf_counter()
    for step in range(max(len(f) for f in feeds)):
        for h, f in zip(handles, feeds):
            if step < len(f):
                h.feed(f[step])
        if step % 24 == 0:
            eng.pump()
    snaps = [h.result() for h in handles]
    wall = time.perf_counter() - t0
    for s, r in zip(snaps, served):
        if not s.final or s.pred != r.pred or not np.array_equal(s.logits, r.logits):
            fail(f"session {s.sid}: {s.logits} != serve() {r.logits}")
    ev = eng.pool.evictions
    if ev == 0:
        fail("the session pool never evicted: readmission went untested")
    log(f"(d) ok: {len(snaps)} sessions fed ragged/word-sized chunks, "
        f"{ev} evictions / {eng.pool.readmissions} readmissions, "
        f"{wall:.1f} s wall, results bitwise equal to serve()")


# ---------------------------------------------------------------------------
# (f) timing
# ---------------------------------------------------------------------------


def _time(fn, iters=20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _session_events(raster, live, w, kw, carries):
    """(spikes, spikes fed back) of one session tile: every tick's spikes
    before the live select, and the spikes of the carry z that enters each
    tick — the plain version run one tick at a time, valid = 1 so that its
    n_spk counts every spike."""
    from repro_torch.kernels import rsnn_step as K

    spikes = fed = 0
    ones = torch.ones_like(live[:1])
    v, z, y, acc, nspk = carries
    for t in range(raster.shape[0]):
        fed += int(z.count_nonzero())
        v, z, y, acc, nspk = K.rsnn_step_sessions_plain(
            raster[t:t + 1], live[t:t + 1], ones, v, z, y, acc, torch.zeros_like(nspk),
            *w, **kw)
        spikes += int(nspk.sum())
    return spikes, fed


def phase_timing(dev, params, b_tile):
    """Both serving kernels at T=256 over B=1, the main path's tile and
    the 2,048-row admission: the card's time from torch.profiler beside
    CUDA events a call, the plain version's, and the bound from this run's
    events (traffic.serve_event_flops; the dense count is logged beside)."""
    from repro_torch.configs.reckon_braille import CONFIG_QUANT as cfg
    from repro_torch.core.backend import ExecutionBackend
    from repro_torch.kernels import rsnn_step as K
    from repro_torch.kernels import traffic
    from repro_torch.serve.batching import max_batch_for

    T, N, H, O = 256, cfg.n_in, cfg.n_hid, cfg.n_out
    be = ExecutionBackend(cfg, device=dev)
    w = be.datapath_weights(params)
    gen = torch.Generator().manual_seed(SEED + 1)
    kw = dict(alpha=be.alpha, kappa=cfg.neuron.kappa, v_th=cfg.neuron.v_th,
              reset=cfg.neuron.reset, quant=be.quant)
    rows = {}
    for B in sorted({1, b_tile, max_batch_for(cfg)}):
        raster, valid, live = _inputs(gen, T, B, N, 0.12, dev)
        st = be.init_session_state(B)
        c = [st[k] for k in ("v", "z", "y", "acc_y", "n_spk")]
        events = int(raster.count_nonzero())
        dense = T * B * 2 * K.weight_elems(N, H, O)     # the tile loop's f32 multiply-adds
        shape = f"T={T} B={B} {N}/{H}/{O}"
        for name, kern, plain, nbytes, lv in (
            ("rsnn_infer",
             lambda: K.rsnn_infer_cuda(raster, valid, *w, **kw),
             lambda: K.rsnn_infer_plain(raster, valid, *w, **kw),
             traffic.infer_fused_tiled_bytes(T, B, N, H, O), torch.ones_like(live)),
            ("rsnn_step_sessions",
             lambda: K.rsnn_step_sessions_cuda(raster, live, valid, *c, *w, **kw),
             lambda: K.rsnn_step_sessions_plain(raster, live, valid, *c, *w, **kw),
             traffic.stream_step_tiled_bytes(T, B, N, H, O), live),
        ):
            spikes, fed = _session_events(raster, lv, w, kw, c)
            flops = traffic.serve_event_flops(T, B, N, H, O, events, spikes, fed)
            row = _timed_row("(f)", name, kern, plain, nbytes, flops, shape)
            log(f"(f) {name} at {shape}: {events} input events, {spikes} spikes, {fed} "
                f"fed back: {flops} operations (dense {dense}, "
                f"{dense / F32_FLOPS_PER_S * 1e3:.6f} ms); plan "
                f"{K.serve_plan(T, B, N, H, O)}")
            if B == b_tile:
                rows[name] = row
    return rows


# ---------------------------------------------------------------------------
# (g) training kernels vs plain, (h) learning run, (i) training timing
# ---------------------------------------------------------------------------


def _train_inputs(gen, T, B, cfg, density, dev, label_delay=0):
    raster = (torch.rand((T, B, cfg.n_in), generator=gen) < density).float()
    label_tick = torch.randint(0, T // 2, (B,), generator=gen)
    end_tick = torch.randint(T // 2, T, (B,), generator=gen)
    t = torch.arange(T)[:, None]
    valid = ((t >= label_tick + label_delay) & (t <= end_tick)).float()
    labels = torch.randint(0, cfg.n_out, (B,), generator=gen)
    y_star = torch.nn.functional.one_hot(labels, cfg.n_out).float()
    return raster.to(dev), y_star.to(dev), valid.to(dev)


def _dw_err(name, got, want) -> float:
    """max |Δdw| over the three matrices; fails beyond TRAIN_DW_TOL."""
    worst = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.isfinite(g).all():
            fail(f"{name}: dw shape {tuple(g.shape)} / non-finite")
        e = _err(g, w)
        scale = float(w.abs().max())
        if e > TRAIN_DW_TOL * max(scale, 1e-30):
            fail(f"{name}: dw off by {e} (> {TRAIN_DW_TOL} x {scale})")
        worst = max(worst, e)
    return worst


def _train_cfg(cfg, feedback, label_delay):
    return dataclasses.replace(cfg, label_delay=label_delay, eprop=dataclasses.replace(
        cfg.eprop, feedback=feedback))


def phase_train_kernels_vs_plain(dev):
    from repro_torch.core.backend import ExecutionBackend
    from repro_torch.core.rsnn import Presets, init_params
    from repro_torch.kernels import eprop_update as E
    from repro_torch.kernels import rsnn_step as K

    gen = torch.Generator().manual_seed(SEED + 2)
    T = 128
    braille_q = Presets.braille(num_ticks=T, quantized=True)
    braille_f = Presets.braille(num_ticks=T, quantized=False)
    chipmax_q = Presets.braille(num_ticks=T, quantized=True, n_in=256, n_hid=256,
                                n_out=16)
    chipmax_q = dataclasses.replace(
        chipmax_q, neuron=dataclasses.replace(chipmax_q.neuron, reset="sub"))
    chipmax_f = dataclasses.replace(chipmax_q, neuron=dataclasses.replace(
        chipmax_q.neuron, quant=None))
    cases = [   # name, config, B, feedback, label_delay, input density, T
        ("braille quant END_B tile", braille_q, 70, "symmetric", 0, 0.12, T),
        ("braille quant B=1", braille_q, 1, "symmetric", 0, 0.12, T),
        # two rows a block in rsnn_forward; 2,048 one-row blocks of
        # rsnn_train, several waves
        ("braille quant B=2048", braille_q, 2048, "symmetric", 0, 0.12, T),
        ("braille quant ragged, label_delay=5, random feedback", braille_q, 37,
         "random", 5, 0.12, T),
        ("braille float END_B tile, random feedback", braille_f, 70, "random", 0, 0.12, T),
        ("braille float B=2048", braille_f, 2048, "symmetric", 0, 0.12, T),
        ("braille float ragged, label_delay=5", braille_f, 37, "symmetric", 5, 0.12, T),
        # rsnn_train's trace set in the device scratch: too long for a block;
        # rsnn_forward's row buffers still in shared memory
        ("braille quant END_B tile, T=512", braille_q, 70, "random", 3, 0.12, 512),
        ("braille float T=512", braille_f, 37, "symmetric", 0, 0.12, 512),
        ("chip-max quant, random feedback", chipmax_q, 8, "random", 3, 0.05, T),
        ("chip-max float", chipmax_f, 8, "symmetric", 0, 0.05, T),
    ]
    errs = {"rsnn_forward": [], "rsnn_train": [], "eprop_update": []}
    for name, cfg, B, feedback, delay, density, T in cases:
        cfg = _train_cfg(dataclasses.replace(cfg, num_ticks=T), feedback, delay)
        quantized = cfg.neuron.quant is not None
        be = ExecutionBackend(cfg, device=dev)
        params = init_params(gen, cfg, device=dev)
        # weights on the SRAM grid in both modes (see FLOAT_TOL)
        params = {k: (torch.round(v * 16) / 16).clamp(-8, 127 / 16)
                  if k in ("w_in", "w_rec", "w_out") else v for k, v in params.items()}
        w_in, w_rec, w_out = be.datapath_weights(params)
        b_fb = be._feedback(params)
        raster, y_star, valid = _train_inputs(gen, T, B, cfg, density, dev, delay)
        kw = dict(alpha=be.alpha, kappa=cfg.neuron.kappa, v_th=cfg.neuron.v_th,
                  reset=cfg.neuron.reset, boxcar_width=cfg.neuron.boxcar_width,
                  quant=be.quant)
        got = K.rsnn_forward_cuda(raster, w_in, w_rec, w_out, **kw)
        again = K.rsnn_forward_cuda(raster, w_in, w_rec, w_out, **kw)
        want = K.rsnn_forward_plain(raster, w_in, w_rec, w_out, **kw)
        torch.cuda.synchronize()
        _compare(f"{name} rsnn_forward", [got[k] for k in K.FORWARD_KEYS],
                 [want[k] for k in K.FORWARD_KEYS], quantized, errs["rsnn_forward"])
        _check_equal(f"{name}: two rsnn_forward launches",
                     [got[k] for k in K.FORWARD_KEYS], [again[k] for k in K.FORWARD_KEYS])
        tkw = dict(kw, error=cfg.eprop.error, infer_window=cfg.eprop.infer_window)
        args = (raster, y_star, valid, w_in, w_rec, w_out, b_fb)
        got = E.rsnn_train_cuda(*args, **tkw, return_traces=True)
        again = E.rsnn_train_cuda(*args, **tkw)
        want = E.rsnn_train_plain(*args, **tkw, return_traces=True)
        torch.cuda.synchronize()
        errs["rsnn_train"].append(_dw_err(f"{name} rsnn_train", got[:3], want[:3]))
        _compare(f"{name} rsnn_train acc_y/n_spk", got[3:5], want[3:5], quantized,
                 errs["rsnn_train"])
        keys = ("h", "xbar", "pbar", "zbar")
        _compare(f"{name} rsnn_train traces", [got[5][k] for k in keys],
                 [want[5][k] for k in keys], quantized, errs["rsnn_train"])
        err_e = _err(got[5]["err"], want[5]["err"])
        if not torch.isfinite(got[5]["err"]).all() or err_e > (
                TRAIN_ERR_TOL if quantized else FLOAT_TOL):
            fail(f"{name}: rsnn_train's readout error off by {err_e}")
        if not all(torch.equal(a, b) for a, b in zip(got[:5], again)):
            fail(f"{name}: two rsnn_train launches gave different bits")
        tr = be.forward_traces(params, raster, y_star, valid)
        trs = [tr[k] for k in ("h", "xbar", "pbar", "zbar", "err")]
        got_u = E.eprop_update_cuda(*trs, b_fb, kappa=cfg.neuron.kappa)
        want_u = E.eprop_update_plain(*trs, b_fb, kappa=cfg.neuron.kappa)
        torch.cuda.synchronize()
        errs["eprop_update"].append(_dw_err(f"{name} eprop_update", got_u, want_u))
        # the split pipeline gives the fused train_tile's dw
        _dw_err(f"{name} forward_traces + eprop_update vs train_tile", got_u, got[:3])
        spikes = float(want[4].sum())
        tplan = K.train_plan(T, cfg.n_in, cfg.n_hid, cfg.n_out, B)
        fplan = K.forward_plan(T, B, cfg.n_in, cfg.n_hid, cfg.n_out)
        log(f"(g) ok: {name} (T={T}, B={B}, {cfg.n_in}/{cfg.n_hid}/{cfg.n_out}, "
            f"rsnn_train traces in {'shared' if tplan.traces_smem else 'device'} "
            f"memory on {tplan.cluster} block(s) a row, "
            f"rsnn_forward plan {fplan}, "
            f"spikes in window={spikes:.0f}, max|dw|="
            f"{max(float(w.abs().max()) for w in want[:3]):.4g}, readout error "
            f"{err_e:.3g})")
    return {k: max(v) for k, v in errs.items()}


def phase_learning(dev):
    from repro_torch.configs.reckon_braille import QUANT_OPT
    from repro_torch.core.controller import ControllerConfig, OnlineLearner
    from repro_torch.core.rsnn import Presets
    from repro_torch.data.braille import make_braille_dataset
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.serve import BatchedEngine
    from repro_torch.serve.batching import decode_events_host, trim_padding

    data = make_braille_dataset("AEU")
    T = data["train"]["num_ticks"]
    n_train = data["train"]["events"].shape[0]
    sizes = "/".join(str(data[s]["events"].shape[0]) for s in ("train", "val", "test"))
    cfg = Presets.braille(n_classes=3, num_ticks=T, quantized=True)
    # benchmarks/bench_braille.py:_opt_cfg(quantized=True): QUANT_OPT with a
    # 1/(1 + t/tau) decay over 25 epochs of samples, lr 0.01 in both modes
    opt = dataclasses.replace(QUANT_OPT, decay_tau=25.0 * n_train)
    pipe = make_pipeline("arm", data, samples_per_batch=70, device=dev)
    acc, learners, walls = {}, {}, {}
    for seed in LEARN_SEEDS:
        for mode, commit in (("END_B", "batch"), ("END_S", "sample")):
            learner = OnlineLearner(
                cfg, ControllerConfig(num_epochs=LEARN_EPOCHS,
                                      eval_every=LEARN_EPOCHS, commit=commit),
                opt, seed, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            log_ = learner.fit(pipe)
            test = learner.eval_epoch(pipe, 0, "test")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            acc[seed, mode], learners[seed, mode] = test, learner
            walls[seed, mode] = wall
            log(f"(h) seed {seed} {mode}: {LEARN_EPOCHS} epochs on Braille AEU "
                f"({sizes} samples, T={T}), {learner.commits} train batches: test "
                f"{test:.4f}, val {log_.val_acc[-1]:.4f}, last train epoch "
                f"{log_.train_acc[-1]:.4f}, {wall:.2f} s wall")
    median = {}
    for mode in ("END_B", "END_S"):
        accs = [acc[s, mode] for s in LEARN_SEEDS]
        median[mode] = float(np.median(accs))
        ws = [walls[s, mode] for s in LEARN_SEEDS]
        log(f"(h) {mode} test accuracy over seeds {LEARN_SEEDS[0]}-{LEARN_SEEDS[-1]}: "
            f"median {median[mode]:.4f}, mean {float(np.mean(accs)):.4f}, "
            f"min {min(accs):.4f}, max {max(accs):.4f}; wall median "
            f"{float(np.median(ws)):.2f} s, min {min(ws):.2f}, max {max(ws):.2f}")
    end_s, end_b = median["END_S"], median["END_B"]
    if end_s < END_S_MIN_MEDIAN:
        fail(f"median END_S test accuracy {end_s:.4f} < {END_S_MIN_MEDIAN:.4f} "
             f"(the JAX reference's {JAX_END_S_MEDIAN:.4f} - {END_S_MARGIN})")
    gap = abs(end_b - end_s)
    if gap > END_B_MAX_GAP:
        fail(f"median END_B test accuracy {end_b:.4f} is {gap:.4f} from END_S's")
    learner = learners[LEARN_SEEDS[0], "END_S"]

    # serve the learned (END_S) weights; each served answer equals the
    # learner backend's inference of the same sample, bitwise
    eng = BatchedEngine.from_learner(learner)
    reqs = [trim_padding(r) for r in data["test"]["events"]]
    res, stats = eng.serve(iter(reqs))
    be = learner.backend
    for r, ev in zip(res, reqs):
        raster, valid, _ = decode_events_host([ev], cfg.n_in, r.bucket_ticks,
                                              cfg.label_delay)
        out = be.inference(learner.weights, torch.from_numpy(raster).to(dev),
                           torch.from_numpy(valid).to(dev))
        want = out["acc_y"][0].cpu().numpy()
        if r.pred != int(out["pred"][0]) or not np.array_equal(r.logits, want):
            fail(f"served request {r.rid}: {r.logits} != inference {want}")
    served_acc = float(np.mean([r.pred == r.label for r in res]))
    log(f"(h) ok: from_learner served the {len(res)} test samples in "
        f"{stats.batches} tile(s), bitwise equal to the backend's inference; "
        f"accuracy {served_acc:.4f}; END_B gap {gap:.4f}")

    # the split pipeline and the bit-true dynamics probe on the learned weights
    batch = next(iter(pipe.batches("train", 0)))
    raster = batch["raster"].transpose(0, 1).contiguous()
    valid = batch["valid"].transpose(0, 1).contiguous()
    y_star = torch.nn.functional.one_hot(batch["label"], cfg.n_out).float()
    dw, m = be.train_tile(learner.weights, raster, y_star, valid)
    tr = be.forward_traces(learner.weights, raster, y_star, valid)
    dw_split = be.eprop_update(learner.weights, tr)
    _dw_err("learned END_B tile: split pipeline vs train_tile",
            [dw_split[k] for k in dw], [dw[k] for k in dw])
    if not torch.equal(tr["y_inf"].sum(dim=0), m["acc_y"]):
        fail("forward_traces' readout differs from train_tile's acc_y")
    dyn = be.dynamics(learner.weights, raster)
    if not torch.equal((dyn["y"] * valid[..., None]).sum(dim=0),
                       be.inference(learner.weights, raster, valid)["acc_y"]):
        fail("the dynamics probe's readout differs from inference")
    log("(h) ok: forward_traces + eprop_update give train_tile's dw on the "
        "learned weights; forward_traces and dynamics readouts equal "
        "train_tile's and inference's acc_y bitwise")
    return acc


def _device_ms_by_kernel(fn, iters=20):
    """The card's time for one call of ``fn`` from ``torch.profiler``, per
    kernel it launches (by name): the median of that kernel's durations
    over ``iters`` calls times its launches a call, in ms.  A trace may
    miss some records, and a sum over them then reads low; the median of
    the rest is not moved.  Empty when the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return {name: float(np.median(us)) * max(1, round(len(us) / iters)) / 1e3
            for name, us in by_name.items()}


def _median_reading(fn, n=3, iters=10):
    """The median of ``n`` readings of :func:`_device_ms_by_kernel`'s total →
    (ms, that reading's ms by kernel label), or (None, None) when a trace
    holds no device time.  A reading whose trace lost or cut records reads
    low (one of two read 0.25 ms for a 0.52 ms kernel), so the minimum of
    two is no estimate and the median of three is."""
    readings = [_device_ms_by_kernel(fn, iters) for _ in range(n)]
    if not all(readings):
        return None, None
    mid = sorted(readings, key=lambda r: sum(r.values()))[n // 2]
    return sum(mid.values()), {_kernel_label(k)[:60]: round(v, 4) for k, v in mid.items()}


def _device_ms(fn, iters=20):
    """The card's time for one call of ``fn`` (the sum over its kernels of
    :func:`_device_ms_by_kernel`); None when the trace holds no device
    time."""
    by_kernel = _device_ms_by_kernel(fn, iters)
    return sum(by_kernel.values()) if by_kernel else None


def _timed_row(tag, name, kern, plain, nbytes, flops, shape):
    """Kernel time on the card from the profiler (a kernel that takes less
    than the host needs to enqueue a call would be timed by the host with
    CUDA events over back-to-back calls), the per-call time by CUDA events
    beside it, the plain version's, and the bound."""
    t_plain_a = _time(plain, iters=3)
    t_kern_a = _time(kern)
    d_a, d_b = _device_ms(kern), _device_ms(kern)
    t_kern_b = _time(kern)
    t_plain_b = _time(plain, iters=3)
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOPS_PER_S * 1e3
    if d_a is None or d_b is None:
        log(f"{tag} {name}: torch.profiler saw no device time; kernel ms by CUDA events")
        ms, dev = min(t_kern_a, t_kern_b), "not measured"
    else:
        ms, dev = min(d_a, d_b), f"{d_a:.4f} / {d_b:.4f}"
    log(f"{tag} {name} at {shape}: kernel {dev} ms on the card (profiler), "
        f"{t_kern_a:.4f} / {t_kern_b:.4f} ms a call (CUDA events, host enqueue "
        f"included), plain {t_plain_a:.3f} / {t_plain_b:.3f} ms, bound "
        f"{max(t_b, t_f):.6f} ms (bytes {nbytes}, flops {flops})")
    return dict(ms=ms, call_ms=min(t_kern_a, t_kern_b),
                plain_ms=min(t_plain_a, t_plain_b), bound_ms=max(t_b, t_f),
                bound_by="bytes" if t_b >= t_f else "operations", shape=shape)


def phase_train_timing(dev):
    from repro_torch.configs.reckon_braille import CONFIG_QUANT
    from repro_torch.core.backend import ExecutionBackend
    from repro_torch.core.rsnn import init_params
    from repro_torch.kernels import eprop_update as E
    from repro_torch.kernels import rsnn_step as K
    from repro_torch.kernels import traffic

    T, B = 128, 70
    cfg = dataclasses.replace(CONFIG_QUANT, num_ticks=T)
    N, H, O = cfg.n_in, cfg.n_hid, cfg.n_out
    be = ExecutionBackend(cfg, device=dev)
    gen = torch.Generator().manual_seed(SEED + 3)
    params = init_params(gen, cfg, device=dev)
    params = {k: (torch.round(v * 16) / 16).clamp(-8, 127 / 16)
              if k != "alpha" else v for k, v in params.items()}
    w = be.datapath_weights(params)
    b_fb = be._feedback(params)
    kw = dict(alpha=be.alpha, kappa=cfg.neuron.kappa, v_th=cfg.neuron.v_th,
              reset=cfg.neuron.reset, boxcar_width=cfg.neuron.boxcar_width,
              quant=be.quant)
    tkw = dict(kw, error=cfg.eprop.error, infer_window=cfg.eprop.infer_window)
    E_ = K.weight_elems(N, H, O)
    rev_flops = T * B * 2 * (E_ + H * O)       # learning signal + three products
    rows = {}
    # rsnn_train at the END_B tile (B=70, the kernels line) and at END_S's
    # one-row commit (B=1, 80,640 of its launches on the learning path)
    for b, key in ((B, "rsnn_train"), (1, "rsnn_train END_S")):
        ins = _train_inputs(gen, T, b, cfg, 0.12, dev)
        targs = (*ins, *w, b_fb)
        # its forward is event-driven: count this run's input events and
        # spikes (the forward kernel's z)
        z = K.rsnn_forward_cuda(ins[0], *w, **kw)["z"]
        flops = traffic.train_event_flops(
            T, b, N, H, O, int(ins[0].count_nonzero()), int(z.count_nonzero()),
            int(z[:-1].count_nonzero()))
        rows[key] = _timed_row(
            "(i)", "rsnn_train", lambda: E.rsnn_train_cuda(*targs, **tkw),
            lambda: E.rsnn_train_plain(*targs, **tkw),
            traffic.train_fused_tiled_bytes(T, b, N, H, O), flops,
            f"T={T} B={b} {N}/{H}/{O}")
        if b == B:
            raster, y_star, valid = ins
    tr = be.forward_traces(params, raster, y_star, valid)
    trs = [tr[k] for k in ("h", "xbar", "pbar", "zbar", "err")]
    shape = f"T={T} B={B} {N}/{H}/{O}"
    # rsnn_forward at the END_B tile (the kernels line), one row and 2,048
    # rows (two rows a block); bound by this run's events
    # (traffic.forward_event_flops; the dense count is logged beside)
    for b in (B, 1, 2048):
        r = raster if b == B else _train_inputs(gen, T, b, cfg, 0.12, dev)[0]
        z = K.rsnn_forward_cuda(r, *w, **kw)["z"]
        events, spikes, fed = (int(r.count_nonzero()), int(z.count_nonzero()),
                               int(z[:-1].count_nonzero()))
        flops = traffic.forward_event_flops(T, b, N, H, O, events, spikes, fed)
        dense = T * b * 2 * E_                 # every weight, every tick
        row = _timed_row(
            "(i)", "rsnn_forward", lambda: K.rsnn_forward_cuda(r, *w, **kw),
            lambda: K.rsnn_forward_plain(r, *w, **kw),
            traffic.forward_traces_bytes(T, b, N, H, O), flops, f"T={T} B={b} {N}/{H}/{O}")
        log(f"(i) rsnn_forward at B={b}: {events} input events, {spikes} spikes, {fed} "
            f"fed back: {flops} operations (dense {dense}, "
            f"{dense / F32_FLOPS_PER_S * 1e3:.6f} ms); plan {K.forward_plan(T, b, N, H, O)}")
        rows["rsnn_forward" if b == B else f"rsnn_forward B={b}"] = row
    rows["eprop_update"] = _timed_row(
        "(i)", "eprop_update", lambda: E.eprop_update_cuda(*trs, b_fb, kappa=cfg.neuron.kappa),
        lambda: E.eprop_update_plain(*trs, b_fb, kappa=cfg.neuron.kappa),
        traffic.eprop_update_bytes(T, B, N, H, O), rev_flops, shape)
    for b in (B, 1):
        plan = K.train_plan(T, N, H, O, b)
        log(f"(i) rsnn_train's plan at T={T} B={b}: {plan.cluster} block(s) of "
            f"{plan.threads} threads a row, trace set in "
            f"{'shared' if plan.traces_smem else 'device'} memory, "
            f"{plan.smem_bytes} bytes of shared memory a block")
    return rows


# ---------------------------------------------------------------------------
# (j) flash_attention vs plain, (k) the LM serving path, (l) flash timing
# ---------------------------------------------------------------------------


def _flash_inputs(gen, B, Sq, Skv, H, Hkv, D, dtype, dev, strided=False, DV=None):
    """q (B, Sq, H, D), k (B, Skv, Hkv, D), v (B, Skv, Hkv, DV) (DV default
    D) from N(0, 0.3²); ``strided`` makes them (B, S, H, D) views of (B, H,
    S, D) tensors."""
    def one(S, heads, width):
        shape = (B, heads, S, width) if strided else (B, S, heads, width)
        x = (torch.randn(shape, generator=gen, device=dev) * 0.3).to(dtype)
        return x.transpose(1, 2) if strided else x
    return one(Sq, H, D), one(Skv, Hkv, D), one(Skv, Hkv, D if DV is None else DV)


def _flash_gate(got, want):
    """(error, tolerance) of the (j) gate: f32 max |Δ| over max |o|, bf16
    the largest per-row error over the row's max |o|."""
    from repro_torch.kernels import flash_attention as FA

    if want.dtype == torch.float32:
        if not torch.isfinite(got).all():
            return float("inf"), FLASH_F32_TOL
        return _err(got, want) / float(want.abs().max()), FLASH_F32_TOL
    return FA.row_error(got, want), FA.BF16_ROW_TOL


def phase_flash_vs_plain(dev):
    from repro_torch.kernels import flash_attention as FA

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [   # name, B, Sq, Skv, H, Hkv, D, dtype, causal, kv_len, strided
        ("llama3-8b prefill", 4, 2048, 2048, 32, 8, 128, bf16, True, None, False),
        ("ragged causal", 2, 1000, 1000, 32, 8, 128, bf16, True, None, False),
        ("non-causal, strided views, NaN past kv_len", 2, 300, 1024, 32, 8, 128,
         bf16, False, 1000, True),
        ("qwen3-1.7b heads, f32", 2, 1000, 1000, 16, 8, 128, f32, True, None, False),
    ]
    worst = 0.0
    for name, B, Sq, Skv, H, Hkv, D, dtype, causal, kv_len, strided in cases:
        q, k, v = _flash_inputs(gen, B, Sq, Skv, H, Hkv, D, dtype, dev, strided)
        if kv_len is not None:
            k[:, kv_len:] = float("nan")
            v[:, kv_len:] = float("nan")
        kw = dict(causal=causal, kv_len=kv_len)
        got = FA.flash_attention_cuda(q, k, v, **kw)
        again = FA.flash_attention_cuda(q, k, v, **kw)
        want = FA.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"flash_attention {name}: shape {tuple(got.shape)} / non-finite")
        e, tol = _flash_gate(got, want)
        if e > tol:
            fail(f"flash_attention {name}: kernel off by {e} (> {tol})")
        if not torch.equal(got, again):
            fail(f"flash_attention {name}: two launches gave different bits")
        # planted faults the gate must reject: a wrong output scale, and
        # key tile 64-127 lost from the rows past Sq/2
        lost = v.clone()
        lost[:, 64:128] = 0
        late = q.shape[1] // 2
        tile_fault = got.clone()
        tile_fault[:, late:] = FA.flash_attention_cuda(q, k, lost, **kw)[:, late:]
        faults = {"output x 0.9": _flash_gate((got.float() * 0.9).to(dtype), want)[0],
                  "key tile lost in late rows": _flash_gate(tile_fault, want)[0]}
        for fault, fe in faults.items():
            if not fe > tol:
                fail(f"flash_attention {name}: the gate accepts a planted fault "
                     f"({fault}: {fe} <= {tol})")
        abs_e = _err(got, want)
        worst = max(worst, abs_e)
        log(f"(j) ok: flash_attention {name} (B={B}, Sq={Sq}, Skv={Skv}, H={H}, "
            f"Hkv={Hkv}, D={D}, {str(dtype)[6:]}, causal={causal}, kv_len={kv_len}): "
            f"{'max |Δ| / max|o|' if dtype == f32 else 'worst row max |Δ| / max|o_row|'} "
            f"{e:.4g} (tol {tol:.4g}; max |kernel - plain| {abs_e:.3g}, max|o| "
            f"{float(want.float().abs().max()):.3g}), two launches bitwise equal; "
            f"planted faults rejected: "
            + ", ".join(f"{f} {fe:.4g}" for f, fe in faults.items()))
    return worst


def _logit_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _device_profile(fn):
    """Run ``fn`` under ``torch.profiler`` → (device busy ms, kernels, the
    busiest kernel names with their ms, the aten ops with the most device
    time of their own and their ms), or None when the trace holds no
    device time.  Busy time is the sum of the kernels' own durations (one
    stream, so they do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    by_op = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
             if e.key.startswith("aten::") and e.self_device_time_total > 0}
    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:6]
    return sum(by_name.values()), len(kernels), top, top_ops


def phase_lm(dev):
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.models import attention
    from repro_torch.models.model import build

    cfg = get_config(LM_ARCH)
    model = build(cfg)
    B, L, steps = LM_BATCH, LM_PROMPT, LM_STEPS
    t0 = time.perf_counter()
    params = model.init(SEED, device=dev)
    torch.cuda.synchronize()
    log(f"(k) {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, d_head {cfg.d_head}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, {cfg.dtype}: {cfg.param_count() / 1e9:.3f} B random weights "
        f"drawn on the card in {time.perf_counter() - t0:.1f} s (peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB: the f32 draws)")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    tokens = torch.randint(0, cfg.vocab, (B, L + 1), generator=gen, device=dev)
    prompt = {"tokens": tokens[:, :L]}
    # the main path: one generate() call, counted, then prefill and decode
    # timed apart and profiled
    launches, _ = _serve_and_time(dev, model, params, tokens, steps, "k")

    # teacher forcing: decode at L on the prefill cache of L tokens (its
    # first L slots are the prefill's own) == the last logits of a prefill
    # of L + 1 (a ragged length for the kernel)
    logits, caches = model.prefill(params, prompt, model.init_cache(B, L + 1, dev))
    dec, _ = model.decode_step(params, caches, tokens[:, L:], L)
    full, _ = model.prefill(params, {"tokens": tokens})
    if not (torch.isfinite(dec).all() and torch.isfinite(full).all()):
        fail("teacher-forcing logits not finite")
    tf_err = _logit_diff(dec[:, 0], full[:, -1])
    agree = float((dec[:, 0].argmax(-1) == full[:, -1].argmax(-1)).float().mean())
    log(f"(k) teacher forcing: max |decode(L) - prefill(L+1)[-1]| {tf_err:.4g} "
        f"(tol {LM_TF_TOL}), logits std {float(full.float().std()):.4g}, "
        f"top-1 agreement {agree:.2f}")
    if tf_err > LM_TF_TOL:
        fail(f"teacher-forcing logits differ by {tf_err} (> {LM_TF_TOL})")

    # the same prefill with its attention through the plain version
    kernel_attention = attention.blocked_attention
    n_before = ops.launches["flash_attention"]
    attention.blocked_attention = (
        lambda q, k, v, *, causal=True: FA.flash_attention_plain(q, k, v, causal=causal))
    try:
        plain_logits, _ = model.prefill(params, prompt)
    finally:
        attention.blocked_attention = kernel_attention
    torch.cuda.synchronize()
    if ops.launches["flash_attention"] != n_before:
        fail("the plain-attention prefill launched the kernel")
    plain_err = _logit_diff(logits, plain_logits)
    log(f"(k) prefill with plain attention: max |Δ logits| {plain_err:.4g} "
        f"(tol {LM_PLAIN_TOL}), top-1 agreement "
        f"{float((logits.argmax(-1) == plain_logits.argmax(-1)).float().mean()):.2f}")
    if plain_err > LM_PLAIN_TOL:
        fail(f"prefill logits differ from the plain-attention prefill by {plain_err}")
    weights = cfg.param_count() * cfg.torch_dtype.itemsize
    log(f"(k) ok: peak device memory over generate() and the checks "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the weights "
        f"{weights / 2**30:.2f} GiB)")
    return launches


def phase_flash_timing(dev):
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import traffic

    B, S, H, Hkv, D = LM_BATCH, LM_PROMPT, 32, 8, 128
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    q, k, v = _flash_inputs(gen, B, S, S, H, Hkv, D, torch.bfloat16, dev)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def kern():
        return FA.flash_attention_cuda(q, k, v, causal=True)

    def plain():
        return FA.flash_attention_plain(q, k, v, causal=True)

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, enable_gqa=True)

    lib_err = FA.row_error(library().transpose(1, 2), kern())
    if lib_err > FA.BF16_ROW_TOL:
        fail(f"scaled_dot_product_attention differs from the kernel by {lib_err} "
             f"of a row's max |o| (> {FA.BF16_ROW_TOL})")
    t_plain_a = _time(plain, iters=3)
    t_kern_a = _time(kern)
    t_lib_a = _time(library)
    t_lib_b = _time(library)
    t_kern_b = _time(kern)
    t_plain_b = _time(plain, iters=3)
    d_kern = _device_ms(kern, iters=10)
    nbytes = traffic.flash_attention_bytes(B, S, S, H, Hkv, D, 2)
    flops = traffic.flash_attention_flops(B, S, H, D, S, True)
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / BF16_TENSOR_FLOPS_PER_S * 1e3
    ms = min(t_kern_a, t_kern_b)
    log(f"(l) flash_attention at B={B}, S={S}, H={H}, Hkv={Hkv}, D={D}, bf16, causal: "
        f"kernel {t_kern_a:.4f} / {t_kern_b:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s; "
        f"{'not measured' if d_kern is None else f'{d_kern:.4f} ms'} on the card by "
        f"torch.profiler), "
        f"plain {t_plain_a:.3f} / {t_plain_b:.3f} ms, scaled_dot_product_attention "
        f"{t_lib_a:.4f} / {t_lib_b:.4f} ms (worst row max |Δ| / max|o_row| to the "
        f"kernel {lib_err:.4g}), "
        f"bound {max(t_b, t_f):.4f} ms (bytes {nbytes}, flops {flops})")
    return dict(ms=ms, plain_ms=min(t_plain_a, t_plain_b),
                library_ms=min(t_lib_a, t_lib_b), bound_ms=max(t_b, t_f),
                bound_by="bytes" if t_b >= t_f else "operations",
                shape=f"B={B} S={S} H={H} Hkv={Hkv} D={D} bf16 causal")


# ---------------------------------------------------------------------------
# (p) flash_attention_bwd vs plain, (q) LM training, (r) backward timing
# ---------------------------------------------------------------------------


def _bwd_gate(got, want):
    """(error, tolerance) of the (p) gate over (dq, dk, dv): f32 the largest
    max |Δ| over the tensor's max |.| (a tensor zero in theory against the
    largest of the three), bf16 the largest ``grad_row_error``."""
    from repro_torch.kernels import flash_attention as FA

    if want[0].dtype == torch.float32:
        scale = max(float(w.abs().max()) for w in want)
        errs = []
        for g, w in zip(got, want):
            if not torch.isfinite(g).all():
                return float("inf"), FLASH_F32_TOL
            ref = float(w.abs().max())
            errs.append(_err(g, w) / (ref if ref >= 1e-4 * scale else scale))
        return max(errs), FLASH_F32_TOL
    return max(FA.grad_row_error(g, w) for g, w in zip(got, want)), FA.BWD_BF16_ROW_TOL


def phase_flash_bwd_vs_plain(dev):
    from repro_torch.kernels import flash_attention as FA

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    f32 = torch.float32
    worst = 0.0
    for name, B, S, H, Hkv, D, dtype, causal, strided in BWD_CASES:
        q, k, v = _flash_inputs(gen, B, S, S, H, Hkv, D, dtype, dev, strided)
        do = torch.randn((B, H, S, D), generator=gen, device=dev).to(dtype).transpose(1, 2)
        if not strided:
            do = do.contiguous()
        o, lse, o32 = FA.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
        same_o = torch.equal(o, FA.flash_attention_cuda(q, k, v, causal=causal))
        _, plain_lse, _ = FA.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
        got = FA.flash_attention_bwd_cuda(q, k, v, o32, lse, do, causal=causal)
        again = FA.flash_attention_bwd_cuda(q, k, v, o32, lse, do, causal=causal)
        want = FA.flash_attention_bwd_plain(q, k, v, o32, lse, do, causal=causal)
        torch.cuda.synchronize()
        if not (same_o and torch.equal(o32.to(dtype), o)):
            fail(f"flash_attention {name}: the forward with lse gave other bits, or its f32 "
                 f"output does not round to its output")
        lse_err = _err(lse, plain_lse)
        if not lse_err <= BWD_LSE_TOL:
            fail(f"flash_attention {name}: lse off by {lse_err} (> {BWD_LSE_TOL})")
        if any(g.shape != w.shape for g, w in zip(got, want)):
            fail(f"flash_attention_bwd {name}: shapes {[tuple(g.shape) for g in got]}")
        e, tol = _bwd_gate(got, want)
        if not e <= tol:
            fail(f"flash_attention_bwd {name}: kernel off by {e} (> {tol})")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"flash_attention_bwd {name}: two launches gave different bits")
        # planted faults the gate must reject: dk scaled by 0.9, and q tile 1
        # (rows 64-127) dropped from dk and dv
        cut = do.clone()
        cut[:, 64:128] = 0
        _, dk_cut, dv_cut = FA.flash_attention_bwd_cuda(q, k, v, o32, lse, cut,
                                                        causal=causal)
        faults = {"dk x 0.9": _bwd_gate((got[0], (got[1].float() * 0.9).to(dtype), got[2]),
                                        want)[0],
                  "q tile 1 dropped from dk, dv": _bwd_gate((got[0], dk_cut, dv_cut),
                                                            want)[0]}
        for fault, fe in faults.items():
            if not fe > tol:
                fail(f"flash_attention_bwd {name}: the gate accepts a planted fault "
                     f"({fault}: {fe} <= {tol})")
        abs_e = max(_err(g, w) for g, w in zip(got, want))
        worst = max(worst, abs_e)
        log(f"(p) ok: flash_attention_bwd {name} (B={B}, S={S}, H={H}, Hkv={Hkv}, D={D}, "
            f"{str(dtype)[6:]}, causal={causal}): "
            f"{'max |Δ| / max|g|' if dtype == f32 else 'worst row max |Δ| / row scale'} "
            f"{e:.4g} (tol {tol:.4g}; max |kernel - plain| {abs_e:.3g}); lse max |Δ| "
            f"{lse_err:.3g} (tol {BWD_LSE_TOL}); forward with lse bitwise the forward "
            f"without; two launches bitwise equal; planted faults rejected: "
            + ", ".join(f"{f} {fe:.4g}" for f, fe in faults.items()))
    return worst


def _same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
        b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


def _tree_bitwise(what, ours, theirs):
    from repro_torch.models.transformer import tree_leaves

    a, b = tree_leaves(ours), tree_leaves(theirs)
    if len(a) != len(b) or not all(_same_bits(x, y) for x, y in zip(a, b)):
        fail(f"{what}: not bitwise equal")


def phase_lm_train(dev):
    import math

    from repro_torch.configs.base import get_config, get_reduced
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import build
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.train.train_step import grads_of
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config(TRAIN_ARCH)
    B, S, n = TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = launch_train.build_run(cfg, steps=n, batch=B, seq=S, lr=TRAIN_LR, device=dev)
    torch.cuda.synchronize()
    log(f"(q) {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, d_head {cfg.d_head}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, {cfg.dtype}, remat={cfg.remat} ({cfg.remat_policy}): "
        f"{cfg.param_count() / 1e9:.3f} B random weights and AdamW state on the card "
        f"in {time.perf_counter() - t0:.1f} s")

    # the main path: TRAIN_STEPS steps of launch/train.py's step, counted
    params, state = run.init_state()
    losses, gnorms, walls, per_step = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    for i in range(n):
        batch = next(run.stream)
        before = dict(ops.launches)
        t0 = time.perf_counter()
        params, state, metrics = run.step_fn(params, state, batch)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        per_step.append({k: ops.launches[k] - before[k]
                         for k in ("flash_attention", "flash_attention_bwd")})
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    log(f"(q) losses {[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 4) for x in gnorms]}, step walls (s) {[round(w, 3) for w in walls]}")
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail("(q) a loss or grad norm is not finite")
    ln_v = math.log(cfg.vocab)
    if not abs(losses[0] - ln_v) <= TRAIN_LOSS0_TOL:
        fail(f"(q) step 0's loss {losses[0]} is not within {TRAIN_LOSS0_TOL} of "
             f"ln({cfg.vocab}) = {ln_v:.4f}")
    if not losses[-1] < losses[0]:
        fail(f"(q) the loss did not fall: {losses[0]} -> {losses[-1]}")
    want = {"flash_attention": 2 * cfg.n_layers, "flash_attention_bwd": cfg.n_layers}
    if any(s != want for s in per_step):
        fail(f"(q) launches a step {per_step}, expected {want} (remat runs the forward "
             f"twice a layer)")
    step_s = float(np.median(walls[1:]))
    log(f"(q) ok: {n} steps of B={B} x S={S} tokens, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (ln V = {ln_v:.4f}); step wall {step_s:.3f} s (median of "
        f"steps 1-{n - 1}; step 0 {walls[0]:.3f} s), {B * S / step_s:.0f} tokens/s; peak "
        f"device memory {peak / 2**30:.2f} GiB; launches {launches}")
    # where a step's time goes: one more step under the profiler, after the
    # counted window
    batch = next(run.stream)
    prof = _device_profile(lambda: run.step_fn(params, state, batch))
    if prof is None:
        log("(q) torch.profiler saw no device time: busy share not measured")
    else:
        log(f"(q) one step: device busy {prof[0]:.1f} ms of {step_s * 1e3:.1f} ms wall "
            f"(idle share {1 - prof[0] / (step_s * 1e3):.2f}), {prof[1]} kernels; busiest: "
            + ", ".join(f"{nm[:60]} {ms:.1f} ms" for nm, ms in prof[2]))
    # where the peak memory is: the backward and the AdamW update apart
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads, _ = grads_of(run.model, params, batch)
    torch.cuda.synchronize()
    peak_bwd = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run.opt.update(params, grads, state)
    torch.cuda.synchronize()
    peak_upd = torch.cuda.max_memory_allocated()
    log(f"(q) device memory: {resident / 2**30:.2f} GiB held between steps (weights, "
        f"AdamW moments), peak {peak_bwd / 2**30:.2f} GiB in the backward, "
        f"{peak_upd / 2**30:.2f} GiB in AdamW.update (functional: new moments beside "
        f"the old)")
    del run, params, state, metrics, batch, grads
    torch.cuda.empty_cache()

    # one step's gradients at the arch's widths and TRAIN_GRAD_LAYERS layers,
    # through the kernels and through their plain versions
    small = cfg.replace(n_layers=TRAIN_GRAD_LAYERS)
    model = build(small)
    p2 = model.init(SEED, device=dev)
    batch = next(TokenStream(TokenStreamConfig(vocab=cfg.vocab, batch=B, seq_len=S,
                                               seed=SEED), device=dev))
    ops.reset_launch_counts()
    kern, _ = grads_of(model, p2, batch)
    n_kern = dict(ops.launches)
    real = FA.flash_attention_cuda, FA.flash_attention_bwd_cuda
    FA.flash_attention_cuda, FA.flash_attention_bwd_cuda = (
        FA.flash_attention_plain, FA.flash_attention_bwd_plain)
    try:
        plain, _ = grads_of(model, p2, batch)
    finally:
        FA.flash_attention_cuda, FA.flash_attention_bwd_cuda = real
    torch.cuda.synchronize()
    if ops.launches != n_kern or n_kern["flash_attention_bwd"] != TRAIN_GRAD_LAYERS:
        fail(f"(q) the kernel step launched {n_kern}, the plain step {dict(ops.launches)}")
    errs = [_err(a, b) / float(b.float().abs().max())
            for a, b in zip(tree_leaves(kern), tree_leaves(plain))]
    if not max(errs) <= LM_GRAD_TOL:
        fail(f"(q) gradients through the kernels differ from the plain versions' by "
             f"{max(errs)} of a leaf's max |g| (> {LM_GRAD_TOL})")
    log(f"(q) ok: one step at {cfg.name}'s widths, {TRAIN_GRAD_LAYERS} layers, B={B}, "
        f"S={S}: gradients through the kernels vs their plain versions, per leaf max "
        f"|Δg| / max|g| worst {max(errs):.4g} (tol {LM_GRAD_TOL}), median "
        f"{float(np.median(errs)):.4g}")
    del model, p2, kern, plain, batch
    torch.cuda.empty_cache()

    # launch/train.py on the card with --reduced and checkpoints: 6 steps,
    # and 4 steps resumed to 6, bitwise
    root = Path(__file__).resolve().parent / "build" / "chip_lm_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    argv = ["--arch", TRAIN_ARCH, "--reduced", "--steps", "6", "--device", dev.type,
            "--ckpt-every", "2"]
    whole = launch_train.run(argv + ["--ckpt-dir", str(root / "whole")])
    fetch = TokenStream.__next__

    def sigterm_at_batch_3(stream):   # a preemption: step 4 ends, then a save
        if stream.position == 3:
            signal.raise_signal(signal.SIGTERM)
        return fetch(stream)

    TokenStream.__next__ = sigterm_at_batch_3
    try:
        cut = launch_train.run(argv + ["--ckpt-dir", str(root / "cut")])
    finally:
        TokenStream.__next__ = fetch
    resumed = launch_train.run(argv + ["--ckpt-dir", str(root / "cut"), "--resume"])
    if (cut.summary["step"], resumed.summary["step"], whole.summary["step"]) != (4, 6, 6):
        fail(f"(q) CLI runs ended at {cut.summary}, {resumed.summary}, {whole.summary}")
    if cut.losses + resumed.losses != whole.losses:
        fail(f"(q) resumed losses {cut.losses + resumed.losses} != {whole.losses}")
    _tree_bitwise("(q) the resumed CLI run's params", resumed.trainer.params,
                  whole.trainer.params)
    _tree_bitwise("(q) the resumed CLI run's AdamW state", resumed.trainer.opt_state,
                  whole.trainer.opt_state)
    log(f"(q) ok: launch/train.py --reduced on the card: 6 steps, loss "
        f"{whole.losses[0]:.4f} -> {whole.losses[-1]:.4f}; stopped by SIGTERM at 4 and "
        f"resumed to 6, params and AdamW state bitwise the uninterrupted run's")

    # a bf16 copy of the reduced config through the Trainer: save, restore
    bf = get_reduced(TRAIN_ARCH).replace(dtype="bfloat16")
    tcfg = TrainerConfig(total_steps=3, ckpt_every=2, ckpt_dir=str(root / "bf16"))
    r1 = launch_train.build_run(bf, steps=3, batch=4, seq=128, device=dev)
    t1 = Trainer(r1.step_fn, *r1.init_state(), r1.stream, tcfg)
    t1.run()
    r2 = launch_train.build_run(bf, steps=3, batch=4, seq=128, device=dev)
    t2 = Trainer(r2.step_fn, *r2.init_state(), r2.stream, tcfg)
    if not t2.restore() or t2.step != 3:
        fail("(q) the bf16 Trainer checkpoint did not restore at step 3")
    if tree_leaves(t2.params)[0].dtype != torch.bfloat16:
        fail("(q) the bf16 checkpoint restored another dtype")
    _tree_bitwise("(q) bf16 params restored", t2.params, t1.params)
    _tree_bitwise("(q) AdamW state restored", t2.opt_state, t1.opt_state)
    shutil.rmtree(root, ignore_errors=True)
    log("(q) ok: a bf16 reduced run through the Trainer saved and restored bitwise "
        "(params and AdamW state)")
    return launches, dict(step_s=step_s, tokens_per_s=B * S / step_s, peak_gib=peak / 2**30,
                          losses=losses)


def phase_flash_bwd_timing(dev):
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import traffic

    rows = []
    fwd_lse = None
    for name, (B, S, H, Hkv, D) in (("qwen3-1.7b", (TRAIN_BATCH, TRAIN_SEQ, 16, 8, 128)),
                                    ("llama3-8b", (LM_BATCH, LM_PROMPT, 32, 8, 128))):
        gen = torch.Generator(device=dev).manual_seed(SEED + 9)
        q, k, v = _flash_inputs(gen, B, S, S, H, Hkv, D, torch.bfloat16, dev)
        do = torch.randn((B, S, H, D), generator=gen, device=dev).to(torch.bfloat16)
        o, lse, o32 = FA.flash_attention_cuda(q, k, v, causal=True, return_lse=True)

        def kern():
            return FA.flash_attention_bwd_cuda(q, k, v, o32, lse, do, causal=True)

        def plain():
            return FA.flash_attention_bwd_plain(q, k, v, o32, lse, do, causal=True)

        qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        oh = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, enable_gqa=True)
        doh = do.transpose(1, 2).contiguous()

        def library():
            return torch.autograd.grad(oh, (qh, kh, vh), doh, retain_graph=True)

        # logged, not gated: SDPA is a yardstick of time, and (p) holds the
        # kernel to its plain version
        lib_err = max(FA.grad_row_error(g, w.transpose(1, 2))
                      for g, w in zip(kern(), library()))
        t_plain_a = _time(plain, iters=2)
        t_kern_a = _time(kern)
        t_lib_a = _time(library)
        d_ms, d_split = _median_reading(kern)
        t_lib_b = _time(library)
        t_kern_b = _time(kern)
        t_plain_b = _time(plain, iters=2)
        flops = traffic.flash_attention_bwd_flops(B, S, H, D, S, True)
        nbytes = traffic.flash_attention_bwd_bytes(B, S, S, H, Hkv, D, 2)
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_f = flops / BF16_TENSOR_FLOPS_PER_S * 1e3
        if d_ms is None:
            ms, dev_ms, split = min(t_kern_a, t_kern_b), "not measured", {}
        else:
            ms, dev_ms, split = d_ms, f"{d_ms:.4f}", d_split
        shape = f"B={B} S={S} H={H} Hkv={Hkv} D={D} bf16 causal"
        log(f"(r) flash_attention_bwd at {name}'s {shape}: kernel {dev_ms} ms on the card "
            f"(profiler, the median of three readings; the delta pre-pass, then dK/dV and "
            f"dQ: {split}), {t_kern_a:.4f} / "
            f"{t_kern_b:.4f} ms a call (CUDA events), {flops / ms / 1e9:.1f} TFLOP/s; "
            f"plain {t_plain_a:.3f} / {t_plain_b:.3f} ms; SDPA backward {t_lib_a:.4f} / "
            f"{t_lib_b:.4f} ms (worst row error to the kernel {lib_err:.4g}); bound "
            f"{max(t_b, t_f):.4f} ms (flops {flops}, bytes {nbytes})")
        rows.append(dict(ms=ms, call_ms=min(t_kern_a, t_kern_b),
                         plain_ms=min(t_plain_a, t_plain_b),
                         library_ms=min(t_lib_a, t_lib_b), bound_ms=max(t_b, t_f),
                         bound_by="bytes" if t_b >= t_f else "operations", shape=shape,
                         tflop_s=flops / ms / 1e9, kernels_ms=split))
        if fwd_lse is None:   # the forward at the training shape, with and without lse
            with_lse = lambda: FA.flash_attention_cuda(q, k, v, causal=True, return_lse=True)
            without = lambda: FA.flash_attention_cuda(q, k, v, causal=True)
            a, b = _time(without), _time(with_lse)
            c, d = _time(with_lse), _time(without)
            fwd_lse = dict(shape=shape, ms_with_lse=min(b, c), ms_without=min(a, d))
            log(f"(r) flash_attention at {shape}: {a:.4f} / {d:.4f} ms without lse, "
                f"{b:.4f} / {c:.4f} ms with lse and the f32 output (CUDA events)")
        del qh, kh, vh, oh
    row = rows[0]
    row["other_shapes"] = rows[1:]
    row["ptxas"] = _bwd_ptxas()
    log(f"(r) flash_attention_bwd's bf16 kernels (ptxas -v): {row['ptxas']}")
    return row, fwd_lse


# ---------------------------------------------------------------------------
# (s) the kernels at MLA's (192, 128), (t) MoE and MLA serving, (u) MoE and
# MLA training
# ---------------------------------------------------------------------------


def _mla_inputs(gen, B, S, H, dev, strided=False):
    """q, k (B, S, H, 192) and v (B, S, H, 128) in bf16 from N(0, 0.3²);
    ``strided`` makes them views of head-major tensors."""
    def one(D):
        shape = (B, H, S, D) if strided else (B, S, H, D)
        x = (torch.randn(shape, generator=gen, device=dev) * 0.3).to(torch.bfloat16)
        return x.transpose(1, 2) if strided else x
    return one(MLA_DK), one(MLA_DK), one(MLA_DV)


def phase_mla_flash_vs_plain(dev):
    """(s): the forward (with and without lse) and the backward at (192, 128)
    against their plain versions, each planted fault rejected, an f32 call
    refused.  Returns the worst max |kernel - plain| of the forward and of
    the backward."""
    from repro_torch.kernels import flash_attention as FA

    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    worst_f = worst_b = 0.0
    for name, B, Sq, Skv, H, causal, strided in MLA_CASES:
        q, k, v = _mla_inputs(gen, B, max(Sq, Skv), H, dev, strided)
        q, k, v = q[:, :Sq], k[:, :Skv], v[:, :Skv]
        do = torch.randn((B, H, Sq, MLA_DV), generator=gen, device=dev).to(
            torch.bfloat16).transpose(1, 2)
        if not strided:
            do = do.contiguous()
        o, lse, o32 = FA.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
        same_o = torch.equal(o, FA.flash_attention_cuda(q, k, v, causal=causal))
        want_o, plain_lse, _ = FA.flash_attention_plain(q, k, v, causal=causal,
                                                        return_lse=True)
        torch.cuda.synchronize()
        if o.shape != (B, Sq, H, MLA_DV) or not same_o or not torch.equal(
                o32.to(torch.bfloat16), o):
            fail(f"(s) flash_attention {name}: shape {tuple(o.shape)}, or the forward "
                 f"with lse gave other bits than without, or its f32 output does not "
                 f"round to its output")
        fe = FA.row_error(o, want_o)
        lse_err = _err(lse, plain_lse)
        if not (fe <= FA.BF16_ROW_TOL and lse_err <= BWD_LSE_TOL):
            fail(f"(s) flash_attention {name}: row error {fe} (> {FA.BF16_ROW_TOL}) or "
                 f"lse off by {lse_err} (> {BWD_LSE_TOL})")
        lost = v.clone()
        lost[:, 64:128] = 0
        late = Sq // 2
        tile_fault = o.clone()
        tile_fault[:, late:] = FA.flash_attention_cuda(q, k, lost, causal=causal)[:, late:]
        f_faults = {"output x 0.9": FA.row_error((o.float() * 0.9).to(torch.bfloat16),
                                                 want_o),
                    "key tile lost in late rows": FA.row_error(tile_fault, want_o)}
        worst_f = max(worst_f, _err(o, want_o))
        msg = (f"(s) ok: flash_attention {name} (B={B}, Sq={Sq}, Skv={Skv}, H={H}, "
               f"(DK, DV)=({MLA_DK}, {MLA_DV}), bf16, causal={causal}): worst row error "
               f"{fe:.4g} (tol {FA.BF16_ROW_TOL:.4g}), lse max |Δ| {lse_err:.3g}; with lse "
               f"bitwise without")
        if Sq == Skv:
            got = FA.flash_attention_bwd_cuda(q, k, v, o32, lse, do, causal=causal)
            again = FA.flash_attention_bwd_cuda(q, k, v, o32, lse, do, causal=causal)
            want = FA.flash_attention_bwd_plain(q, k, v, o32, lse, do, causal=causal)
            torch.cuda.synchronize()
            if any(g.shape != w.shape for g, w in zip(got, want)):
                fail(f"(s) flash_attention_bwd {name}: shapes "
                     f"{[tuple(g.shape) for g in got]}")
            be, tol = _bwd_gate(got, want)
            if not be <= tol:
                fail(f"(s) flash_attention_bwd {name}: kernel off by {be} (> {tol})")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"(s) flash_attention_bwd {name}: two launches gave different bits")
            cut = do.clone()
            cut[:, 64:128] = 0
            _, dk_cut, dv_cut = FA.flash_attention_bwd_cuda(q, k, v, o32, lse, cut,
                                                            causal=causal)
            f_faults["dk x 0.9"] = _bwd_gate(
                (got[0], (got[1].float() * 0.9).to(torch.bfloat16), got[2]), want)[0]
            f_faults["q tile 1 dropped from dk, dv"] = _bwd_gate((got[0], dk_cut, dv_cut),
                                                                 want)[0]
            worst_b = max(worst_b, max(_err(g, w) for g, w in zip(got, want)))
            msg += (f"; backward worst row error {be:.4g} (tol {tol:.4g}), two launches "
                    f"bitwise equal")
        for fault, e in f_faults.items():
            tol = FA.BWD_BF16_ROW_TOL if fault.startswith(("dk", "q tile")) else \
                FA.BF16_ROW_TOL
            if not e > tol:
                fail(f"(s) {name}: the gate accepts a planted fault ({fault}: {e} <= {tol})")
        log(msg + "; planted faults rejected: "
            + ", ".join(f"{f} {e:.4g}" for f, e in f_faults.items()))
    q, k, v = _mla_inputs(gen, 1, 128, 2, dev)
    try:
        FA.flash_attention_cuda(q.float(), k.float(), v.float(), causal=True)
    except ValueError as e:
        if f"({MLA_DK}, {MLA_DV})" not in str(e):
            fail(f"(s) the f32 call at the pair raised without naming it: {e}")
        log(f"(s) ok: an f32 call at ({MLA_DK}, {MLA_DV}) raises: {e}")
    else:
        fail(f"(s) an f32 call at ({MLA_DK}, {MLA_DV}) did not raise")
    return worst_f, worst_b


def phase_mla_flash_timing(dev):
    """(s) timing: the forward (with and without lse) and the backward at
    deepseek's training shape, per kernel from torch.profiler, beside their
    plain versions, SDPA's forward and backward at the same shape (the
    backend SDPA chose named by its kernels) and their bounds; ptxas's
    registers and spills of the pair's kernels."""
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import traffic

    B, S, H = TRAIN_BATCH, TRAIN_SEQ, MLA_HEADS
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    q, k, v = _mla_inputs(gen, B, S, H, dev)
    do = torch.randn((B, S, H, MLA_DV), generator=gen, device=dev).to(torch.bfloat16)
    o, lse, o32 = FA.flash_attention_cuda(q, k, v, causal=True, return_lse=True)
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    oh = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    doh = do.transpose(1, 2).contiguous()
    calls = {
        "forward": lambda: FA.flash_attention_cuda(q, k, v, causal=True),
        "forward with lse": lambda: FA.flash_attention_cuda(q, k, v, causal=True,
                                                            return_lse=True),
        "backward": lambda: FA.flash_attention_bwd_cuda(q, k, v, o32, lse, do, causal=True),
        "SDPA forward": lambda: F.scaled_dot_product_attention(
            qh.detach(), kh.detach(), vh.detach(), is_causal=True),
        "SDPA backward": lambda: torch.autograd.grad(oh, (qh, kh, vh), doh,
                                                     retain_graph=True),
        "plain forward": lambda: FA.flash_attention_plain(q, k, v, causal=True),
        "plain backward": lambda: FA.flash_attention_bwd_plain(q, k, v, o32, lse, do,
                                                               causal=True),
    }
    lib_err = FA.row_error(calls["SDPA forward"]().transpose(1, 2), o)
    ms, split = {}, {}
    for label in ("forward", "forward with lse", "backward", "SDPA forward",
                  "SDPA backward"):
        ms[label], split[label] = _median_reading(calls[label])
        if ms[label] is None:
            ms[label] = _time(calls[label])
            split[label] = "not measured (profiler saw no device time; CUDA events)"
    for label in ("plain forward", "plain backward"):
        ms[label] = _time(calls[label], iters=2)
    f_flops = traffic.flash_attention_flops(B, S, H, MLA_DK, S, True, MLA_DV)
    b_flops = traffic.flash_attention_bwd_flops(B, S, H, MLA_DK, S, True, MLA_DV)
    f_bytes = traffic.flash_attention_bytes(B, S, S, H, H, MLA_DK, 2, MLA_DV)
    b_bytes = traffic.flash_attention_bwd_bytes(B, S, S, H, H, MLA_DK, 2, MLA_DV)
    bound = lambda nb, fl: (max(nb / HBM_BYTES_PER_S, fl / BF16_TENSOR_FLOPS_PER_S) * 1e3,
                            "bytes" if nb / HBM_BYTES_PER_S >= fl / BF16_TENSOR_FLOPS_PER_S
                            else "operations")
    (f_bound, f_by), (b_bound, b_by) = bound(f_bytes, f_flops), bound(b_bytes, b_flops)
    report = build.ptxas_report(build.ptxas_log())
    regs = {_kernel_label(k)[-60:]: v for k, v in report.items()
            if f"ILi{MLA_DK}ELi{MLA_DV}E" in k}
    shape = (f"B={B} S={S} H={H} Hkv={H} (DK, DV)=({MLA_DK}, {MLA_DV}) bf16 causal")
    log(f"(s) at deepseek-v2-lite's training shape {shape}: forward {ms['forward']:.4f} ms "
        f"({f_flops / ms['forward'] / 1e9:.1f} TFLOP/s), with lse "
        f"{ms['forward with lse']:.4f} ms, SDPA forward {ms['SDPA forward']:.4f} ms "
        f"(kernels {split['SDPA forward']}; worst row error to ours {lib_err:.4g}), plain "
        f"{ms['plain forward']:.3f} ms, bound {f_bound:.4f} ms ({f_by}); backward "
        f"{ms['backward']:.4f} ms ({b_flops / ms['backward'] / 1e9:.1f} TFLOP/s; "
        f"{split['backward']}), SDPA backward {ms['SDPA backward']:.4f} ms (kernels "
        f"{split['SDPA backward']}), plain {ms['plain backward']:.3f} ms, bound "
        f"{b_bound:.4f} ms ({b_by}); ptxas {regs}")
    del qh, kh, vh, oh
    fwd = dict(ms=ms["forward"], ms_with_lse=ms["forward with lse"],
               plain_ms=ms["plain forward"], library_ms=ms["SDPA forward"],
               bound_ms=f_bound, bound_by=f_by, shape=shape, kernels_ms=split["forward"],
               library_kernels=split["SDPA forward"])
    bwd = dict(ms=ms["backward"], plain_ms=ms["plain backward"],
               library_ms=ms["SDPA backward"], bound_ms=b_bound, bound_by=b_by,
               shape=shape, kernels_ms=split["backward"],
               library_kernels=split["SDPA backward"], ptxas=regs)
    return fwd, bwd


def _route_sets(log_calls, rows=None):
    """Each routing call's top-k sets (sorted), the rows ``rows`` of each
    call when given."""
    return [(c if rows is None else c[rows]).sort(-1).values for c in log_calls]


def _flips(a, b) -> int:
    """(token, MoE layer) top-k sets that differ between two runs' calls."""
    return sum(int((x != y).any(-1).sum()) for x, y in zip(a, b))


def _no_drop(cfg):
    """``cfg`` with the capacity factor raised until no token drops: an
    expert's capacity is then at least the tokens of the call, each of
    which picks it at most once."""
    m = cfg.moe
    return cfg.replace(moe=dataclasses.replace(
        m, capacity_factor=(m.n_experts + 1) / m.top_k))


def _plan_count(plan, pred) -> int:
    """Layers of ``plan`` whose kind satisfies ``pred``."""
    return (sum(pred(k) for k in plan.prefix)
            + plan.repeats * sum(pred(k) for k in plan.period))


def _serve_and_time(dev, model, params, tokens, steps, tag, memory=None):
    """``generate()`` of ``steps`` greedy tokens after the prompts
    ``tokens[:, :-1]`` (with ``memory``, the batch's ``media`` or
    ``src_embeds``, when given), counted: the prefill launches
    flash_attention once an attention (the encoder's, a self-attention's
    and a cross-attention's), and each decode step once a cross-attention
    (one query row over the cached memory); nothing else.  Then the
    prefill and the decode steps timed apart, two prefills bitwise alike
    (logits and caches), prefill + decode_step giving generate()'s tokens,
    and the device's busy share and busiest kernels under torch.profiler.
    Returns the counted launches and a summary."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.train import serve_step

    cfg = model.cfg
    memory = memory or {}
    B, L = tokens.shape[0], tokens.shape[1] - 1
    prompt = dict(memory, tokens=tokens[:, :L])
    mem_len = model.memory_len(prompt)
    cache_len = L + steps + 8
    n_cross = _plan_count(model.plan, lambda k: k[0] in ("xattn", "attn_xattn"))
    n_prefill = (_plan_count(model.plan, lambda k: k[0] in ("attn", "attn_xattn")) + n_cross
                 + (0 if model.enc_plan is None else model.enc_plan.n_layers))
    want = n_prefill + (steps - 1) * n_cross
    serve_step.generate(model, params, dict({k: m[:1] for k, m in memory.items()},
                                            tokens=tokens[:1, :64]), 2, 72)  # warm-up

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = serve_step.generate(model, params, prompt, steps, cache_len)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_peak = torch.cuda.max_memory_allocated()
    launches = dict(ops.launches)
    if launches["flash_attention"] != want or any(
            n for k, n in launches.items() if k != "flash_attention"):
        fail(f"({tag}) generate launched {launches}: the forward kernel not {want} times "
             f"(once an attention of the prefill, {n_prefill}, and once a cross-attention "
             f"of each of {steps - 1} decode steps, {n_cross}), or another kernel")
    if out.shape != (B, steps) or int(out.min()) < 0 or int(out.max()) >= cfg.vocab:
        fail(f"({tag}) generate gave tokens of shape {tuple(out.shape)} outside the vocab")
    log(f"({tag}) ok: generate() {B} x {L} prompt tokens"
        + (f" over {mem_len} memory positions" if mem_len else "")
        + f" + {steps} greedy tokens in {gen_s:.2f} s, peak device memory "
        f"{gen_peak / 2**30:.2f} GiB; launches {launches} ({n_prefill} attentions in the "
        f"prefill, {n_cross} a decode step)")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, prompt, model.init_cache(B, cache_len, dev,
                                                                    mem_len=mem_len))
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if not torch.isfinite(logits).all():
        fail(f"({tag}) prefill logits not finite")
    again, caches2 = model.prefill(params, prompt, model.init_cache(B, cache_len, dev,
                                                                    mem_len=mem_len))
    if not (_same_bits(logits, again) and all(
            _same_bits(a, b) for a, b in zip(tree_leaves(caches), tree_leaves(caches2)))):
        fail(f"({tag}) two prefills gave other bits (logits or caches)")
    del caches2, again
    decode = serve_step.make_decode_step(model, sample="greedy")
    nxt = logits[:, -1, :].argmax(dim=-1, keepdim=True)
    toks = [nxt]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps - 1):
        nxt, caches = decode(params, caches, nxt, L + i)
        toks.append(nxt)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if not torch.equal(torch.cat(toks, dim=1), out):
        fail(f"({tag}) prefill + decode_step gave other tokens than generate()")
    step_ms = decode_s / (steps - 1) * 1e3
    summary = dict(prefill_tokens_per_s=B * L / prefill_s, prefill_ms=prefill_s * 1e3,
                   decode_tokens_per_s=B * (steps - 1) / decode_s, decode_step_ms=step_ms,
                   peak_gib=gen_peak / 2**30)
    if mem_len:
        summary["prefill_memory_positions_per_s"] = B * mem_len / prefill_s
    log(f"({tag}) ok: prefill {B} x {L} tokens in {prefill_s * 1e3:.1f} ms "
        f"({B * L / prefill_s:.0f} tokens/s"
        + (f"; {B} x {mem_len} memory positions, {B * mem_len / prefill_s:.0f} a second"
           if mem_len else "")
        + f"), two prefills bitwise alike; {steps - 1} decode "
        f"steps of {B} tokens in {decode_s * 1e3:.1f} ms ({B * (steps - 1) / decode_s:.1f} "
        f"tokens/s, {step_ms:.2f} ms a step)")
    pre = _device_profile(lambda: model.prefill(params, prompt))
    n_dec = 4
    dec = _device_profile(lambda: [decode(params, caches, nxt, L + steps - 1 + i)
                                   for i in range(n_dec)])
    if pre is None or dec is None:
        log(f"({tag}) torch.profiler saw no device time: busy share not measured")
    else:
        summary.update(prefill_idle_share=1 - pre[0] / (prefill_s * 1e3),
                       decode_idle_share=1 - dec[0] / n_dec / step_ms)
        summary.update(prefill_ops_ms=dict(pre[3]),
                       decode_ops_ms={k: v / n_dec for k, v in dec[3]})
        log(f"({tag}) prefill device busy {pre[0]:.1f} ms of {prefill_s * 1e3:.1f} ms wall "
            f"(idle share {summary['prefill_idle_share']:.2f}, {pre[1]} kernels); busiest: "
            + ", ".join(f"{n[:60]} {ms:.1f} ms" for n, ms in pre[2])
            + "; by op: " + ", ".join(f"{n} {ms:.1f} ms" for n, ms in pre[3]))
        log(f"({tag}) decode device busy {dec[0] / n_dec:.2f} ms a step of {step_ms:.2f} ms "
            f"wall (idle share {summary['decode_idle_share']:.2f}), {dec[1] / n_dec:.0f} "
            f"kernels a step; busiest: "
            + ", ".join(f"{n[:60]} {ms / n_dec:.2f} ms" for n, ms in dec[2])
            + "; by op: " + ", ".join(f"{n} {ms / n_dec:.2f} ms" for n, ms in dec[3]))
    return launches, summary


def _moe_serve_case(dev, cfg, steps, tag, tf_tol, plain_tol, mixer_tol=None):
    """One MoE arch served on the card: :func:`_serve_and_time`, then the
    teacher-forcing identity and a plain-attention prefill at a capacity
    where nothing drops, each with the routing flips between its two runs,
    within ``tf_tol`` and ``plain_tol``, and two planted faults each
    outside them.  With ``mixer_tol``, each identity is also held at the
    outputs of the GQA layers (:func:`_gqa_outputs`), within ``mixer_tol``
    of their max, and a fault is rejected by either point.  Returns the
    counted launches and a summary."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.models import attention
    from repro_torch.models.model import build
    from repro_torch.models.moe import pinned_routing

    B, L = MOE_BATCH, MOE_PROMPT
    model = build(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED, device=dev)
    torch.cuda.synchronize()
    mixers = (f"MLA {cfg.mla}" if cfg.mla else "GQA") + (f", {cfg.ssm}" if cfg.ssm else "")
    log(f"({tag}) {cfg.name}: {cfg.n_layers} layers (plan {model.plan}), d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, {mixers}, {cfg.moe}, vocab "
        f"{cfg.vocab}, {cfg.dtype}: {cfg.param_count() / 1e9:.3f} B random weights "
        f"({cfg.active_param_count() / 1e9:.3f} B active) drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    tokens = torch.randint(0, cfg.vocab, (B, L + 1), generator=gen, device=dev)
    prompt = {"tokens": tokens[:, :L]}
    launches, summary = _serve_and_time(dev, model, params, tokens, steps, tag)
    n_attn = _plan_count(model.plan, lambda k: k[0] == "attn")

    # the identities, at a capacity where nothing drops (drops depend on how
    # many tokens a call routes), each run first with its own routing, which
    # is reported, then gated with the routing of the run it is compared
    # with replayed (pinned_routing): a token whose router probabilities
    # nearly tie picks another expert when a rounding lands apart, and with
    # random weights such flips compound through the layers until the
    # logits decorrelate, so a comparison of two routings measures the
    # flips and not the kernels or the cache
    nd = build(_no_drop(cfg))
    n_moe = _plan_count(nd.plan, lambda k: k[1] == "moe")
    rows = torch.arange(B * (L + 1), device=dev).reshape(B, L + 1)

    def decode_on_prompt_cache(pos, replay=None):
        """Decode at ``pos`` on the prompt's cache → (logits, pin, the
        decode step's GQA outputs)."""
        with pinned_routing() as pin, _gqa_outputs() as mix:
            if replay is not None:
                pin.replay(replay)
            _, c = nd.prefill(params, prompt, nd.init_cache(B, L + 1, dev))
            out, _ = nd.decode_step(params, c, tokens[:, L:], pos)
        return out, pin, mix[len(mix) // 2:]

    with pinned_routing() as full_pin, _gqa_outputs() as full_mix:
        full, _ = nd.prefill(params, {"tokens": tokens})
    own_dec, own_pin, _ = decode_on_prompt_cache(L)
    tf_flips = _flips(_route_sets(full_pin.log, rows[:, L]),
                      _route_sets(own_pin.log[n_moe:]))
    mapped = ([c[rows[:, :L].reshape(-1)] for c in full_pin.log]
              + [c[rows[:, L]] for c in full_pin.log])
    dlog, tf_pin, dec_mix = decode_on_prompt_cache(L, mapped)
    if not (torch.isfinite(dlog).all() and torch.isfinite(full).all()):
        fail(f"({tag}) teacher-forcing logits not finite")
    tf_err, tf_own = _logit_diff(dlog[:, 0], full[:, -1]), _logit_diff(own_dec[:, 0],
                                                                       full[:, -1])
    last_row = [m[:, -1:] for m in full_mix]
    kernel_attention = attention.blocked_attention
    n_before = ops.launches["flash_attention"]
    with pinned_routing() as k_pin, _gqa_outputs() as k_mix:
        k_logits, _ = nd.prefill(params, prompt)
    attention.blocked_attention = (
        lambda q, k, v, *, causal=True: FA.flash_attention_plain(q, k, v, causal=causal))
    try:
        with pinned_routing() as own_p:
            own_plain, _ = nd.prefill(params, prompt)
        with pinned_routing() as p_pin, _gqa_outputs() as p_mix:
            p_pin.replay(k_pin.log)
            p_logits, _ = nd.prefill(params, prompt)
    finally:
        attention.blocked_attention = kernel_attention
    torch.cuda.synchronize()
    if ops.launches["flash_attention"] != n_before + n_attn:
        fail(f"({tag}) the plain-attention prefill launched the kernel")
    plain_flips = _flips(_route_sets(k_pin.log), _route_sets(own_p.log))
    plain_err, plain_own = _logit_diff(k_logits, p_logits), _logit_diff(k_logits, own_plain)
    summary.update(tf_err=tf_err, tf_flips=tf_flips, tf_err_own_routing=tf_own,
                   plain_err=plain_err, plain_flips=plain_flips,
                   plain_err_own_routing=plain_own, moe_layers=n_moe)
    log(f"({tag}) teacher forcing (capacity factor {nd.cfg.moe.capacity_factor}: nothing "
        f"drops): each with its own routing, max |decode(L) - prefill(L+1)[-1]| "
        f"{tf_own:.4g}, {tf_flips} of {B * n_moe} (token, MoE layer) top-{cfg.moe.top_k} "
        f"sets differ; the prefill's routing replayed: {tf_err:.4g} (tol {tf_tol}). "
        f"Kernel prefill vs plain-attention prefill: each with its own routing, max "
        f"|Δ logits| {plain_own:.4g}, {plain_flips} of {B * L * n_moe} sets differ; the "
        f"kernel run's routing replayed: {plain_err:.4g} (tol {plain_tol}); logits "
        f"std {float(full.float().std()):.4g}")
    gates = {"teacher forcing": (tf_err, tf_tol), "plain-attention prefill":
             (plain_err, plain_tol)}
    if mixer_tol is not None:
        tf_mix, plain_mix = _mix_err(dec_mix, last_row), _mix_err(k_mix, p_mix)
        summary.update(tf_mixer_err=tf_mix, plain_mixer_err=plain_mix)
        log(f"({tag}) at the {len(k_mix)} GQA layers' outputs, max |Δ| / max |out|: "
            f"teacher forcing {tf_mix:.4g}, plain-attention prefill {plain_mix:.4g} (tol "
            f"{mixer_tol})")
        gates.update({"teacher forcing at the GQA outputs": (tf_mix, mixer_tol),
                      "plain-attention prefill at the GQA outputs": (plain_mix, mixer_tol)})
    for g, (e, tol) in gates.items():
        if e > tol:
            fail(f"({tag}) {g} differs by {e} (> {tol})")
    # planted faults the two gates must reject, under the same replayed
    # routing: a wrong cache slot (decode at slot L - 1, over the prompt's
    # last entry) and the kernel's output x 0.9 in every layer
    wrong_slot, _, slot_mix = decode_on_prompt_cache(L - 1, mapped)
    attention.blocked_attention = (
        lambda q, k, v, *, causal=True: kernel_attention(q, k, v, causal=causal) * 0.9)
    try:
        with pinned_routing() as f_pin, _gqa_outputs() as scaled_mix:
            f_pin.replay(k_pin.log)
            scaled, _ = nd.prefill(params, prompt)
    finally:
        attention.blocked_attention = kernel_attention
    faults = {"wrong cache slot": [(_logit_diff(wrong_slot[:, 0], full[:, -1]), tf_tol)],
              "kernel output x 0.9": [(_logit_diff(scaled, k_logits), plain_tol)]}
    if mixer_tol is not None:
        faults["wrong cache slot"].append((_mix_err(slot_mix, last_row), mixer_tol))
        faults["kernel output x 0.9"].append((_mix_err(scaled_mix, k_mix), mixer_tol))
    for f, pts in faults.items():
        if not any(e > tol for e, tol in pts):
            fail(f"({tag}) the gates accept a planted fault ({f}: {pts}, each (moved, tol))")
    summary["faults"] = {f: [e for e, _ in pts] for f, pts in faults.items()}
    log(f"({tag}) ok: planted faults rejected, (logits"
        + (", GQA outputs" if mixer_tol is not None else "") + "): "
        + ", ".join(f"{f} " + " / ".join(f"{e:.4g} (tol {tol})" for e, tol in pts)
                    for f, pts in faults.items())
        + f"; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params, nd, model
    torch.cuda.empty_cache()
    return launches, summary


@contextlib.contextmanager
def _gqa_outputs(name="gqa_forward"):
    """Record the output of every GQA layer (``attention.gqa_forward``, the
    mixer's output after ``wo``), or of every call of the attention
    module's function ``name`` (``"cross_attn_forward"``: every
    cross-attention's output after ``wo``), run inside the context, in
    order."""
    from repro_torch.models import attention

    real, seen = getattr(attention, name), []

    def record(*args, **kw):
        out = real(*args, **kw)
        seen.append(out)
        return out

    setattr(attention, name, record)
    try:
        yield seen
    finally:
        setattr(attention, name, real)


def _mix_err(got, want) -> float:
    """The largest over layers of max |got - want| / max |want|."""
    if len(got) != len(want) or not want:
        fail(f"layer outputs of {len(got)} and {len(want)} layers to compare")
    return max(_err(a, b) / float(b.float().abs().max()) for a, b in zip(got, want))


def phase_moe_serve(dev):
    """(t): deepseek-v2-lite-16b at full width and depth, then phi3.5-moe at
    full width and MOE_PHI_LAYERS layers."""
    from repro_torch.configs.base import get_config

    ds_launches, ds = _moe_serve_case(dev, get_config(MOE_ARCH), MOE_STEPS, "t",
                                      MOE_TOL, MOE_TOL)
    phi_cfg = get_config(MOE_PHI_ARCH).replace(n_layers=MOE_PHI_LAYERS)
    _, phi = _moe_serve_case(dev, phi_cfg, MOE_PHI_STEPS, "t phi", LM_TF_TOL, LM_PLAIN_TOL,
                             mixer_tol=MOE_PHI_MIXER_TOL)
    return ds_launches, dict(deepseek=ds, phi=phi)


def phase_moe_train(dev):
    """(u): deepseek-v2-lite-16b at full width with MOE_TRAIN_LAYERS layers
    (the dense prefix layer and two MoE layers) trained MOE_TRAIN_STEPS
    steps; then one step's gradients of a two-layer slice through the
    kernels against their plain versions under the same routing."""
    import math

    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import build
    from repro_torch.models.moe import pinned_routing
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.train.train_step import grads_of

    cfg = get_config(MOE_ARCH).replace(n_layers=MOE_TRAIN_LAYERS)
    B, S, n = TRAIN_BATCH, TRAIN_SEQ, MOE_TRAIN_STEPS
    torch.cuda.reset_peak_memory_stats()
    run = launch_train.build_run(cfg, steps=n, batch=B, seq=S, lr=TRAIN_LR, device=dev)
    params, state = run.init_state()
    with torch.no_grad():   # the initial weights' logits of the first batch's rows
        first_logits, _ = run.model.prefill(
            params, {"tokens": next(TokenStream(run.stream.cfg, device=dev))["tokens"]})
    torch.cuda.synchronize()
    log(f"(u) {cfg.name} at {cfg.n_layers} layers (plan {run.model.plan}), {cfg.dtype}, "
        f"remat={cfg.remat} ({cfg.remat_policy}): {cfg.param_count() / 1e9:.3f} B random "
        f"weights and AdamW state on the card")
    losses, auxes, gnorms, walls, per_step = [], [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    for i in range(n):
        batch = next(run.stream)
        before = dict(ops.launches)
        t0 = time.perf_counter()
        params, state, metrics = run.step_fn(params, state, batch)
        losses.append(float(metrics["loss"]))
        auxes.append(float(metrics["aux_loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        per_step.append({k: ops.launches[k] - before[k]
                         for k in ("flash_attention", "flash_attention_bwd")})
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    log(f"(u) losses (without aux) {[round(x, 4) for x in losses]}, aux losses "
        f"{[round(x, 5) for x in auxes]}, grad norms {[round(x, 4) for x in gnorms]}, "
        f"step walls (s) {[round(w, 3) for w in walls]}")
    if not all(math.isfinite(x) for x in losses + auxes + gnorms):
        fail("(u) a loss, aux loss or grad norm is not finite")
    # the random weights' logits have a scale near 1 here (an untied,
    # fan-in scaled lm_head), so step 0's loss sits near ln V + sigma^2 / 2
    # (log-sum-exp of V Gaussian logits), not ln V
    ln_v = math.log(cfg.vocab)
    sigma = float(first_logits.float().std())
    want0 = ln_v + sigma ** 2 / 2
    if cfg.tie_embeddings or not abs(sigma - 1.0) <= TRAIN_SIGMA_TOL:
        fail(f"(u) the initial logits' std {sigma} is not within {TRAIN_SIGMA_TOL} of the "
             f"1 that an untied, fan-in scaled lm_head gives (tied: {cfg.tie_embeddings})")
    if not abs(losses[0] - want0) <= TRAIN_LOSS0_TOL:
        fail(f"(u) step 0's loss {losses[0]} is not within {TRAIN_LOSS0_TOL} of "
             f"ln({cfg.vocab}) + sigma^2 / 2 = {want0:.4f} (sigma {sigma:.4f}, the std of "
             f"the initial weights' logits)")
    if not losses[-1] < losses[0]:
        fail(f"(u) the loss did not fall: {losses[0]} -> {losses[-1]}")
    if not all(a > 0 for a in auxes):
        fail(f"(u) an aux loss is not positive: {auxes}")
    want = {"flash_attention": 2 * cfg.n_layers, "flash_attention_bwd": cfg.n_layers}
    if any(s != want for s in per_step):
        fail(f"(u) launches a step {per_step}, expected {want}")
    step_s = float(np.median(walls[1:]))
    summary = dict(step_s=step_s, tokens_per_s=B * S / step_s, peak_gib=peak / 2**30,
                   losses=losses, aux=auxes)
    log(f"(u) ok: {n} steps of B={B} x S={S} tokens, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (ln V + sigma^2 / 2 = {want0:.4f}, sigma {sigma:.4f}), aux {auxes[0]:.5f} -> {auxes[-1]:.5f}; step "
        f"wall {step_s:.3f} s (median of steps 1-{n - 1}), {B * S / step_s:.0f} tokens/s; "
        f"peak device memory {peak / 2**30:.2f} GiB; launches {launches}")
    batch = next(run.stream)
    prof = _device_profile(lambda: run.step_fn(params, state, batch))
    if prof is None:
        log("(u) torch.profiler saw no device time: busy share not measured")
    else:
        summary["idle_share"] = 1 - prof[0] / (step_s * 1e3)
        log(f"(u) one step: device busy {prof[0]:.1f} ms of {step_s * 1e3:.1f} ms wall "
            f"(idle share {summary['idle_share']:.2f}), {prof[1]} kernels; busiest: "
            + ", ".join(f"{nm[:60]} {ms:.1f} ms" for nm, ms in prof[2]))
    del run, params, state, metrics, batch
    torch.cuda.empty_cache()

    small = cfg.replace(n_layers=TRAIN_GRAD_LAYERS)
    model = build(small)
    p2 = model.init(SEED, device=dev)
    batch = next(TokenStream(TokenStreamConfig(vocab=cfg.vocab, batch=B, seq_len=S,
                                               seed=SEED), device=dev))
    with pinned_routing() as pin:
        ops.reset_launch_counts()
        kern, _ = grads_of(model, p2, batch)
        n_kern = dict(ops.launches)
        real = FA.flash_attention_cuda, FA.flash_attention_bwd_cuda
        FA.flash_attention_cuda, FA.flash_attention_bwd_cuda = (
            FA.flash_attention_plain, FA.flash_attention_bwd_plain)
        pin.replay()
        try:
            plain, _ = grads_of(model, p2, batch)
        finally:
            FA.flash_attention_cuda, FA.flash_attention_bwd_cuda = real
    torch.cuda.synchronize()
    if ops.launches != n_kern or n_kern["flash_attention_bwd"] != TRAIN_GRAD_LAYERS:
        fail(f"(u) the kernel step launched {n_kern}, the plain step {dict(ops.launches)}")
    errs = [_err(a, b) / float(b.float().abs().max())
            for a, b in zip(tree_leaves(kern), tree_leaves(plain))]
    if not max(errs) <= LM_GRAD_TOL:
        fail(f"(u) gradients through the kernels differ from the plain versions' by "
             f"{max(errs)} of a leaf's max |g| (> {LM_GRAD_TOL})")
    summary["grad_err"], summary["grad_flips"] = max(errs), pin.flips
    log(f"(u) ok: one step at {cfg.name}'s widths, {TRAIN_GRAD_LAYERS} layers (the dense "
        f"prefix and one MoE layer), B={B}, S={S}: gradients through the kernels vs their "
        f"plain versions under the same routing, per leaf max |Δg| / max|g| worst "
        f"{max(errs):.4g} (tol {LM_GRAD_TOL}), median {float(np.median(errs)):.4g}; the "
        f"plain run's own routing differed for {pin.flips} (token, call) top-"
        f"{cfg.moe.top_k} sets of {len(pin.log)} calls x {B * S} tokens")
    del model, p2, kern, plain, batch
    torch.cuda.empty_cache()
    return launches, summary


def _naive_ssd(xh, dt, a, B_, C_):
    """The SSD as its token-by-token recurrence in f32
    (``tests/test_mamba.py:naive_ssd``'s arithmetic) → (y, final state)."""
    B, S, H, P = xh.shape
    G, N = B_.shape[2], B_.shape[3]
    state = torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device)
    ys = []
    for t in range(S):
        da = torch.exp(dt[:, t] * a)
        b_h = B_[:, t].repeat_interleave(H // G, dim=1).float()
        c_h = C_[:, t].repeat_interleave(H // G, dim=1).float()
        inc = torch.einsum("bhp,bhn->bhpn", dt[:, t][:, :, None] * xh[:, t].float(), b_h)
        state = state * da[:, :, None, None] + inc
        ys.append(torch.einsum("bhpn,bhn->bhp", state, c_h))
    return torch.stack(ys, dim=1), state


def _first_ssd_call(fn):
    """Run ``fn`` and return the arguments of the first ``_ssd_chunked``
    call it makes (layer 0's SSD inputs)."""
    from repro_torch.models import mamba as mb

    seen = []
    real = mb._ssd_chunked

    def grab(*args, **kw):
        if not seen:
            seen.append((args, kw))
        return real(*args, **kw)

    mb._ssd_chunked = grab
    try:
        fn()
    finally:
        mb._ssd_chunked = real
    return seen[0]


def _chunk_decay_sums(dt, a, chunk):
    """Each chunk's decay sum ``Σ dt·|a|`` over its steps, per head."""
    B, S, H = dt.shape
    S_pad = -(-S // chunk) * chunk
    d = torch.nn.functional.pad(dt.float() * a.abs(), (0, 0, 0, S_pad - S))
    return d.reshape(B, S_pad // chunk, chunk, H).sum(dim=2)


def phase_mamba_serve(dev):
    """(v): mamba2-1.3b at full width and depth served (no kernel of ours on
    this path); the teacher-forcing identity and two planted cache faults;
    layer 0's chunked SSD against its per-step recurrence."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import mamba as mb
    from repro_torch.models.model import build
    from repro_torch.models.transformer import tree_map

    cfg = get_config(MAMBA_ARCH)
    model = build(cfg)
    B, L, steps = MAMBA_BATCH, MAMBA_PROMPT, MAMBA_STEPS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED, device=dev)
    torch.cuda.synchronize()
    log(f"(v) {cfg.name}: {cfg.n_layers} layers (plan {model.plan}), d_model "
        f"{cfg.d_model}, {cfg.ssm}, vocab {cfg.vocab}, tied embeddings "
        f"{cfg.tie_embeddings}, {cfg.dtype}: {cfg.param_count() / 1e9:.3f} B random weights "
        f"drawn on the card in {time.perf_counter() - t0:.1f} s; nothing cut")
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    tokens = torch.randint(0, cfg.vocab, (B, L + 1), generator=gen, device=dev)
    prompt = {"tokens": tokens[:, :L]}
    launches, summary = _serve_and_time(dev, model, params, tokens, steps, "v")
    if any(launches.values()):
        fail(f"(v) the Mamba path launched {launches}: it has no kernel of ours")

    # teacher forcing: decode at L on the prefill state of L tokens == the
    # last logits of a prefill of L + 1; then the same decode from a cache
    # with one layer's state zeroed, and with its conv tails rolled by one
    # position, each of which the tolerance must reject
    _, caches = model.prefill(params, prompt, model.init_cache(B, L + 1, dev))
    full, _ = model.prefill(params, {"tokens": tokens})

    def decode_err(c):
        out, _ = model.decode_step(params, c, tokens[:, L:], L)
        if not torch.isfinite(out).all():
            fail("(v) decode logits not finite")
        return _logit_diff(out[:, 0], full[:, -1]), out

    tf_err, dec = decode_err(tree_map(torch.clone, caches))
    j = MAMBA_FAULT_LAYER
    zeroed = tree_map(torch.clone, caches)
    zeroed["scan"]["0"]["mixer"]["state"][j].zero_()
    rolled = tree_map(torch.clone, caches)
    for k in ("conv_x", "conv_bc"):
        t = rolled["scan"]["0"]["mixer"][k][j]
        t.copy_(t.roll(1, dims=1))
    faults = {f"layer {j}'s state zeroed": decode_err(zeroed)[0],
              f"layer {j}'s conv tails rolled by one": decode_err(rolled)[0]}
    del zeroed, rolled, caches
    agree = float((dec[:, 0].argmax(-1) == full[:, -1].argmax(-1)).float().mean())
    log(f"(v) teacher forcing: max |decode(L) - prefill(L+1)[-1]| {tf_err:.4g} "
        f"(tol {MAMBA_TF_TOL}), logits std {float(full.float().std()):.4g}, top-1 agreement "
        f"{agree:.2f}; planted faults: "
        + ", ".join(f"{f} {e:.4g}" for f, e in faults.items()))
    if tf_err > MAMBA_TF_TOL:
        fail(f"(v) teacher-forcing logits differ by {tf_err} (> {MAMBA_TF_TOL})")
    for f, e in faults.items():
        if not e > MAMBA_TF_TOL:
            fail(f"(v) the gate accepts a planted fault ({f}: {e} <= "
                 f"{MAMBA_TF_TOL})")

    # layer 0's own SSD inputs at full width (B=4, S=2,048, 64 heads of
    # 64, d_state 128): the chunked SSD in f32 and with compute_dtype bf16
    # against the per-step recurrence
    args, _ = _first_ssd_call(lambda: model.prefill(params, prompt))
    xh, dt, a, B_, C_, chunk = args
    ref_y, ref_s = _naive_ssd(xh, dt, a, B_, C_)
    scale, s_scale = float(ref_y.abs().max()), float(ref_s.abs().max())
    errs = {}
    for cdt, tol in (("float32", MAMBA_SSD_F32_TOL), ("bfloat16", MAMBA_SSD_BF16_TOL)):
        y, s = mb._ssd_chunked(xh, dt, a, B_, C_, chunk, compute_dtype=cdt)
        errs[cdt] = (_err(y, ref_y) / scale, _err(s, ref_s) / s_scale, tol)
    decay = _chunk_decay_sums(dt, a, chunk)
    log(f"(v) layer 0's SSD at {tuple(xh.shape)} (chunk {chunk}, chunk decay sums "
        f"{float(decay.min()):.3g}-{float(decay.max()):.3g}), chunked vs per-step "
        f"recurrence, max |Δ| / max|y| and of the final state: "
        + ", ".join(f"{c} {ey:.3g}, {es:.3g} (tol {tol})" for c, (ey, es, tol) in errs.items()))
    for cdt, (ey, es, tol) in errs.items():
        if not max(ey, es) <= tol:
            fail(f"(v) the chunked SSD ({cdt}) differs from the recurrence by "
                 f"{max(ey, es)} (> {tol})")
    summary.update(tf_err=tf_err, faults=faults,
                   ssd_err={c: e[:2] for c, e in errs.items()},
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"(v) ok: peak device memory over generate() and the checks "
        f"{summary['peak_gib']:.2f} GiB (the weights "
        f"{cfg.param_count() * cfg.torch_dtype.itemsize / 2**30:.2f} GiB)")
    del params, model, args, xh, dt, B_, C_, ref_y, ref_s
    torch.cuda.empty_cache()
    return launches, summary


def phase_mamba_train(dev):
    """(w): mamba2-1.3b at full width and depth trained MAMBA_TRAIN_STEPS
    steps; a 2-layer slice's bf16 gradients against f32; one backward with
    dt planted past the f32 exp's range."""
    import math

    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import build
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.train.train_step import grads_of

    cfg = get_config(MAMBA_ARCH)
    B, S, n = TRAIN_BATCH, TRAIN_SEQ, MAMBA_TRAIN_STEPS
    torch.cuda.reset_peak_memory_stats()
    run = launch_train.build_run(cfg, steps=n, batch=B, seq=S, lr=TRAIN_LR, device=dev)
    params, state = run.init_state()
    with torch.no_grad():   # the initial weights' logits of the first batch's rows
        first_logits, _ = run.model.prefill(
            params, {"tokens": next(TokenStream(run.stream.cfg, device=dev))["tokens"]})
    torch.cuda.synchronize()
    log(f"(w) {cfg.name}: {cfg.n_layers} layers, {cfg.dtype}, remat={cfg.remat} "
        f"({cfg.remat_policy}): {cfg.param_count() / 1e9:.3f} B random weights and AdamW "
        f"state on the card; nothing cut")
    losses, gnorms, walls = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    for _ in range(n):
        batch = next(run.stream)
        t0 = time.perf_counter()
        params, state, metrics = run.step_fn(params, state, batch)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    log(f"(w) losses {[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 4) for x in gnorms]}, step walls (s) {[round(w, 3) for w in walls]}")
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail(f"(w) a loss or grad norm is not finite")
    if any(launches.values()):
        fail(f"(w) the Mamba training path launched {launches}: it has no kernel of ours")
    # the tied embedding is drawn at 0.02 and ln_f's output has unit rms, so
    # the initial logits' std is 0.02 sqrt(d_model), and step 0's loss sits
    # near ln V + sigma^2 / 2 (log-sum-exp of V Gaussian logits)
    ln_v, want_sigma = math.log(cfg.vocab), 0.02 * math.sqrt(cfg.d_model)
    sigma = float(first_logits.float().std())
    want0 = ln_v + sigma ** 2 / 2
    if not (cfg.tie_embeddings and abs(sigma - want_sigma) <= TRAIN_SIGMA_TOL):
        fail(f"(w) the initial logits' std {sigma} is not within {TRAIN_SIGMA_TOL} of "
             f"the {want_sigma:.4f} that the tied embedding gives (tied: "
             f"{cfg.tie_embeddings})")
    if not abs(losses[0] - want0) <= TRAIN_LOSS0_TOL:
        fail(f"(w) step 0's loss {losses[0]} is not within {TRAIN_LOSS0_TOL} of "
             f"ln({cfg.vocab}) + sigma^2 / 2 = {want0:.4f} (sigma {sigma:.4f})")
    if not losses[-1] < losses[0]:
        fail(f"(w) the loss did not fall: {losses[0]} -> {losses[-1]}")
    step_s = float(np.median(walls[1:]))
    summary = dict(step_s=step_s, tokens_per_s=B * S / step_s, peak_gib=peak / 2**30,
                   losses=losses)
    log(f"(w) ok: {n} steps of B={B} x S={S} tokens, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (ln V + sigma^2 / 2 = {want0:.4f}, sigma {sigma:.4f}, 0.02 "
        f"sqrt(d_model) = {want_sigma:.4f}); step wall {step_s:.3f} s (median of steps "
        f"1-{n - 1}; step 0 {walls[0]:.3f} s), {B * S / step_s:.0f} tokens/s; peak device "
        f"memory {peak / 2**30:.2f} GiB; launches {launches}")
    batch = next(run.stream)
    prof = _device_profile(lambda: run.step_fn(params, state, batch))
    if prof is None:
        log(f"(w) torch.profiler saw no device time: busy share not measured")
    else:
        summary.update(idle_share=1 - prof[0] / (step_s * 1e3), ops_ms=dict(prof[3]))
        log(f"(w) one step: device busy {prof[0]:.1f} ms of {step_s * 1e3:.1f} ms wall "
            f"(idle share {summary['idle_share']:.2f}), {prof[1]} kernels; busiest: "
            + ", ".join(f"{nm[:60]} {ms:.1f} ms" for nm, ms in prof[2])
            + "; by op: " + ", ".join(f"{nm} {ms:.1f} ms" for nm, ms in prof[3]))
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads, _ = grads_of(run.model, params, batch)
    torch.cuda.synchronize()
    peak_bwd = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run.opt.update(params, grads, state)
    torch.cuda.synchronize()
    peak_upd = torch.cuda.max_memory_allocated()
    summary.update(peak_bwd_gib=peak_bwd / 2**30, peak_update_gib=peak_upd / 2**30)
    log(f"(w) device memory: {resident / 2**30:.2f} GiB held between steps (weights, "
        f"AdamW moments), peak {peak_bwd / 2**30:.2f} GiB in the backward, "
        f"{peak_upd / 2**30:.2f} GiB in AdamW.update")
    del run, params, state, metrics, batch, grads
    torch.cuda.empty_cache()

    # a 2-layer slice at full width: bf16 gradients against the same
    # weights' f32 gradients (the f32 model holds the bf16 values exactly,
    # its f32 leaves are shared), one batch
    small = cfg.replace(n_layers=TRAIN_GRAD_LAYERS)
    m16, m32 = build(small), build(small.replace(dtype="float32"))
    p16 = m16.init(SEED, device=dev)
    p32 = tree_map(lambda t: t.float(), p16)
    batch = next(TokenStream(TokenStreamConfig(vocab=cfg.vocab, batch=B, seq_len=S,
                                               seed=SEED), device=dev))
    g16, _ = grads_of(m16, p16, batch)
    g32, _ = grads_of(m32, p32, batch)
    errs = [_err(a.float(), b) / float(b.abs().max())
            for a, b in zip(tree_leaves(g16), tree_leaves(g32))]
    summary["grad_err"] = max(errs)
    log(f"(w) one step at {cfg.name}'s widths, {TRAIN_GRAD_LAYERS} layers, B={B}, "
        f"S={S}: bf16 gradients vs f32 per leaf max |Δg| / max|g| worst {max(errs):.4g} "
        f"(tol {MAMBA_GRAD_TOL}), median {float(np.median(errs)):.4g}")
    if not max(errs) <= MAMBA_GRAD_TOL:
        fail(f"(w) bf16 gradients differ from f32 by {max(errs)} of a leaf's max |g| "
             f"(> {MAMBA_GRAD_TOL})")
    del m32, p32, g16, g32

    # the hazard: dt_bias planted so that a chunk's decay sum passes the
    # f32 exp's 88.7 (the reference's within-chunk exp would overflow)
    planted = tree_map(lambda t: t, p16)
    mixer = planted["layers"]["scan"]["0"]["mixer"]
    mixer["dt_bias"] = torch.full_like(mixer["dt_bias"], MAMBA_PLANTED_DT_BIAS)
    args, _ = _first_ssd_call(lambda: m16.prefill(planted, {"tokens": batch["tokens"]}))
    decay = float(_chunk_decay_sums(args[1], args[2], args[5]).max())
    g, metrics = grads_of(m16, planted, batch)
    finite = all(bool(torch.isfinite(t).all()) for t in tree_leaves(g))
    log(f"(w) dt_bias planted at {MAMBA_PLANTED_DT_BIAS}: largest chunk decay sum "
        f"{decay:.1f} (the f32 exp overflows past 88.7), loss "
        f"{float(metrics['loss']):.4f}, every gradient finite: {finite}")
    if not decay > 88.7:
        fail(f"(w) the planted dt did not pass the exp's range ({decay})")
    if not (finite and math.isfinite(float(metrics["loss"]))):
        fail(f"(w) a large dt gave a non-finite loss or gradient")
    summary["planted_decay_sum"] = decay
    del m16, p16, planted, g, batch, args
    torch.cuda.empty_cache()
    return launches, summary


def phase_jamba_serve(dev):
    """(x): jamba-v0.1-52b at full width cut to JAMBA_LAYERS layers (one
    period), served as (t) serves the MoE archs."""
    from repro_torch.configs.base import get_config

    full = get_config(JAMBA_ARCH)
    cfg = full.replace(n_layers=JAMBA_LAYERS)
    log(f"(x) {full.name} cut from {full.n_layers} to {cfg.n_layers} layers (one period: 7 "
        f"Mamba, 1 attention, 4 MoE FFNs) at full width: {full.param_count() / 1e9:.2f} B "
        f"parameters ({full.param_count() * 2 / 1e9:.0f} GB in bf16) do not fit 80 GB")
    return _moe_serve_case(dev, cfg, JAMBA_STEPS, "x", JAMBA_TF_TOL, JAMBA_PLAIN_TOL,
                           mixer_tol=JAMBA_MIXER_TOL)


@contextlib.contextmanager
def _scaled_kernel(name, when=lambda kw: True):
    """The planted fault "the kernel's output x 0.9", in the calls of the
    attention module's function ``name`` whose keyword arguments satisfy
    ``when`` only: ``blocked_attention`` is scaled while such a call
    runs."""
    from repro_torch.models import attention

    real_fn, real_attention = getattr(attention, name), attention.blocked_attention
    scaled = lambda q, k, v, *, causal=True: real_attention(q, k, v, causal=causal) * 0.9

    def call(*args, **kw):
        if not when(kw):
            return real_fn(*args, **kw)
        attention.blocked_attention = scaled
        try:
            return real_fn(*args, **kw)
        finally:
            attention.blocked_attention = real_attention

    setattr(attention, name, call)
    try:
        yield
    finally:
        setattr(attention, name, real_fn)


def _cross_cache_leaves(tree):
    """The cross-attention caches' ``mk`` and ``mv`` leaves of a cache tree."""
    if isinstance(tree, list):
        return [t for v in tree for t in _cross_cache_leaves(v)]
    if not isinstance(tree, dict):
        return []
    return [t for k, v in tree.items()
            for t in ([v] if k in ("mk", "mv") else _cross_cache_leaves(v))]


def _xattn_serve_case(dev, model, params, tokens, memory, steps, tag, fault, fault_ctx):
    """A model with cross-attention served on the card:
    :func:`_serve_and_time` over ``memory`` (the batch's ``media`` or
    ``src_embeds``), then the teacher-forcing identity and a
    plain-attention prefill, each at the logits (LM_TF_TOL, LM_PLAIN_TOL)
    and at the cross-attention layers' outputs (XATTN_MIXER_TOL of their
    max), and two planted faults each of which one of the two points must
    reject: the cached memory keys and values rolled by one row across the
    batch before the decode (each row attends another row's memory), and
    ``fault`` (the context ``fault_ctx()``) in the kernel prefill.
    Returns the counted launches and a summary."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.models import attention

    B, L = tokens.shape[0], tokens.shape[1] - 1
    prompt = dict(memory, tokens=tokens[:, :L])
    launches, summary = _serve_and_time(dev, model, params, tokens, steps, tag, memory)
    n_cross = _plan_count(model.plan, lambda k: k[0] in ("xattn", "attn_xattn"))

    def decode_on_prompt_cache(roll=False):
        """Decode at L on the prompt's cache → (logits, the decode step's
        cross-attention outputs); ``roll`` rolls the cached memory by one
        row across the batch first (the stacked caches' axis 1)."""
        with _gqa_outputs("cross_attn_forward") as mix:
            _, c = model.prefill(params, prompt, model.init_cache(B, L + 1, dev))
            if roll:
                for t in _cross_cache_leaves(c):
                    t.copy_(t.roll(1, dims=1))
            out, _ = model.decode_step(params, c, tokens[:, L:], L)
        if len(mix) != 2 * n_cross:
            fail(f"({tag}) {len(mix)} cross-attention calls in a prefill and a decode step, "
                 f"expected {2 * n_cross}")
        return out, mix[n_cross:]

    with _gqa_outputs("cross_attn_forward") as full_mix:
        full, _ = model.prefill(params, dict(memory, tokens=tokens))
    last_row = [m[:, -1:] for m in full_mix]
    dec, dec_mix = decode_on_prompt_cache()
    if not (torch.isfinite(dec).all() and torch.isfinite(full).all()):
        fail(f"({tag}) teacher-forcing logits not finite")
    tf_err, tf_mix = _logit_diff(dec[:, 0], full[:, -1]), _mix_err(dec_mix, last_row)

    kernel_attention = attention.blocked_attention
    with _gqa_outputs("cross_attn_forward") as k_mix:
        k_logits, _ = model.prefill(params, prompt)
    n_before = ops.launches["flash_attention"]
    attention.blocked_attention = (
        lambda q, k, v, *, causal=True: FA.flash_attention_plain(q, k, v, causal=causal))
    try:
        with _gqa_outputs("cross_attn_forward") as p_mix:
            p_logits, _ = model.prefill(params, prompt)
    finally:
        attention.blocked_attention = kernel_attention
    torch.cuda.synchronize()
    if ops.launches["flash_attention"] != n_before:
        fail(f"({tag}) the plain-attention prefill launched the kernel")
    plain_err, plain_mix = _logit_diff(k_logits, p_logits), _mix_err(k_mix, p_mix)
    agree = float((dec[:, 0].argmax(-1) == full[:, -1].argmax(-1)).float().mean())
    summary.update(tf_err=tf_err, tf_mixer_err=tf_mix, plain_err=plain_err,
                   plain_mixer_err=plain_mix)
    log(f"({tag}) teacher forcing: max |decode(L) - prefill(L+1)[-1]| {tf_err:.4g} (tol "
        f"{LM_TF_TOL}), at the {n_cross} cross-attention outputs max |Δ| / max |out| "
        f"{tf_mix:.4g} (tol {XATTN_MIXER_TOL}), top-1 agreement {agree:.2f}; kernel "
        f"prefill vs plain-attention prefill: max |Δ logits| {plain_err:.4g} (tol "
        f"{LM_PLAIN_TOL}), at the cross-attention outputs {plain_mix:.4g}; logits std "
        f"{float(full.float().std()):.4g}")
    gates = {"teacher forcing": (tf_err, LM_TF_TOL),
             "teacher forcing at the cross-attention outputs": (tf_mix, XATTN_MIXER_TOL),
             "plain-attention prefill": (plain_err, LM_PLAIN_TOL),
             "plain-attention prefill at the cross-attention outputs":
                 (plain_mix, XATTN_MIXER_TOL)}
    for g, (e, tol) in gates.items():
        if not e <= tol:
            fail(f"({tag}) {g} differs by {e} (> {tol})")

    rolled, rolled_mix = decode_on_prompt_cache(roll=True)
    with fault_ctx(), _gqa_outputs("cross_attn_forward") as f_mix:
        scaled, _ = model.prefill(params, prompt)
    faults = {"memory rolled by one row in the cross caches": [
                  (_logit_diff(rolled[:, 0], full[:, -1]), LM_TF_TOL),
                  (_mix_err(rolled_mix, last_row), XATTN_MIXER_TOL)],
              fault: [(_logit_diff(scaled, p_logits), LM_PLAIN_TOL),
                      (_mix_err(f_mix, p_mix), XATTN_MIXER_TOL)]}
    for f, pts in faults.items():
        if not any(e > tol for e, tol in pts):
            fail(f"({tag}) the gates accept a planted fault ({f}: {pts}, each (moved, tol))")
    summary["faults"] = {f: [e for e, _ in pts] for f, pts in faults.items()}
    log(f"({tag}) ok: planted faults rejected, (logits, cross-attention outputs): "
        + ", ".join(f"{f} " + " / ".join(f"{e:.4g} (tol {tol})" for e, tol in pts)
                    for f, pts in faults.items())
        + f"; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, summary


def phase_vlm_serve(dev):
    """(y): llama-3.2-vision-90b at full width cut to VLM_PERIODS periods,
    served over media embeddings: 10 forward launches a prefill (2
    cross-attention, 8 self-attention layers) and 2 a decode step."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build

    full = get_config(VLM_ARCH)
    cfg = full.replace(n_layers=VLM_PERIODS * full.cross_attn_every)
    B, L = VLM_BATCH, VLM_PROMPT
    model = build(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED, device=dev)
    torch.cuda.synchronize()
    log(f"(y) {full.name} cut from {full.n_layers} to {cfg.n_layers} layers ({VLM_PERIODS} "
        f"periods of plan {model.plan.period}) at full width: {full.param_count() / 1e9:.2f} "
        f"B parameters ({full.param_count() * 2 / 1e9:.0f} GB in bf16) do not fit 80 GB; "
        f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, d_head {cfg.d_head}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.n_media_tokens} media tokens, "
        f"{cfg.dtype}: {cfg.param_count() / 1e9:.3f} B random weights drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    tokens = torch.randint(0, cfg.vocab, (B, L + 1), generator=gen, device=dev)
    media = (torch.randn((B, cfg.n_media_tokens, cfg.d_model), generator=gen, device=dev)
             * STUB_SCALE).to(cfg.torch_dtype)
    out = _xattn_serve_case(dev, model, params, tokens, {"media": media}, VLM_STEPS, "y",
                            "kernel output x 0.9 in the cross-attention layers",
                            lambda: _scaled_kernel("cross_attn_forward"))
    del params, model, media
    torch.cuda.empty_cache()
    return out


def phase_audio_serve(dev):
    """(z) serving: seamless-m4t-large-v2 at full width and depth over
    sources of enc_seq frames: 24 encoder and 48 decoder forward launches a
    prefill, 24 a decode step; a shorter source refused by a cache of
    enc_seq slots."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build

    cfg = get_config(AUDIO_ARCH)
    B, L = AUDIO_BATCH, AUDIO_PROMPT
    model = build(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED, device=dev)
    torch.cuda.synchronize()
    log(f"(z) {cfg.name}: {cfg.n_enc_layers} encoder and {cfg.n_layers} decoder layers, "
        f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, d_head {cfg.d_head}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, sources of {cfg.enc_seq} frames, {cfg.dtype}: "
        f"{cfg.param_count() / 1e9:.3f} B random weights drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s; nothing cut")
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    tokens = torch.randint(0, cfg.vocab, (B, L + 1), generator=gen, device=dev)
    src = (torch.randn((B, cfg.enc_seq, cfg.d_model), generator=gen, device=dev)
           * STUB_SCALE).to(cfg.torch_dtype)
    launches, summary = _xattn_serve_case(
        dev, model, params, tokens, {"src_embeds": src}, AUDIO_STEPS, "z",
        "kernel output x 0.9 in the encoder",
        lambda: _scaled_kernel("gqa_forward", lambda kw: kw.get("causal") is False))
    short = {"tokens": tokens[:, :L], "src_embeds": src[:, :AUDIO_SHORT_SOURCE]}
    try:
        model.prefill(params, short, model.init_cache(B, L + 1, dev))
    except ValueError as e:
        log(f"(z) ok: a {AUDIO_SHORT_SOURCE}-frame source into a {cfg.enc_seq}-slot cache "
            f"refused: {e}")
    else:
        fail(f"(z) a {AUDIO_SHORT_SOURCE}-frame source went into a {cfg.enc_seq}-slot "
             f"cross cache")
    del params, model, src
    torch.cuda.empty_cache()
    return launches, summary


def phase_audio_train(dev):
    """(z) training: seamless-m4t-large-v2 at full width and depth trained
    AUDIO_TRAIN_STEPS steps; then one step's bf16 gradients of a slice of
    TRAIN_GRAD_LAYERS encoder and decoder layers, through the kernels and
    through their plain versions, each against f32's."""
    import math

    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import build
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.train.train_step import grads_of

    cfg = get_config(AUDIO_ARCH)
    B, S, n = TRAIN_BATCH, TRAIN_SEQ, AUDIO_TRAIN_STEPS
    n_attn = cfg.n_enc_layers + 2 * cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    run = launch_train.build_run(cfg, steps=n, batch=B, seq=S, lr=TRAIN_LR, device=dev)
    params, state = run.init_state()
    first = next(TokenStream(run.stream.cfg, device=dev))
    with torch.no_grad():   # the initial weights' logits of the first batch's rows
        first_logits, _ = run.model.prefill(params, first)
    torch.cuda.synchronize()
    log(f"(z) training {cfg.name}, {cfg.dtype}, remat={cfg.remat} ({cfg.remat_policy}): "
        f"{cfg.param_count() / 1e9:.3f} B random weights and AdamW state on the card; "
        f"B={B} x S={S} tokens and {S} source frames a step; nothing cut")
    losses, gnorms, walls, per_step = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    for _ in range(n):
        batch = next(run.stream)
        before = dict(ops.launches)
        t0 = time.perf_counter()
        params, state, metrics = run.step_fn(params, state, batch)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        per_step.append({k: ops.launches[k] - before[k]
                         for k in ("flash_attention", "flash_attention_bwd")})
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    log(f"(z) losses {[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 4) for x in gnorms]}, step walls (s) {[round(w, 3) for w in walls]}")
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail("(z) a loss or grad norm is not finite")
    # an untied, fan-in scaled lm_head after a unit-rms ln_f: the initial
    # logits' std is 1, and step 0's loss sits near ln V + sigma^2 / 2
    ln_v = math.log(cfg.vocab)
    sigma = float(first_logits.float().std())
    want0 = ln_v + sigma ** 2 / 2
    if cfg.tie_embeddings or not abs(sigma - 1.0) <= TRAIN_SIGMA_TOL:
        fail(f"(z) the initial logits' std {sigma} is not within {TRAIN_SIGMA_TOL} of the "
             f"1 that an untied, fan-in scaled lm_head gives (tied: {cfg.tie_embeddings})")
    if not abs(losses[0] - want0) <= TRAIN_LOSS0_TOL:
        fail(f"(z) step 0's loss {losses[0]} is not within {TRAIN_LOSS0_TOL} of "
             f"ln({cfg.vocab}) + sigma^2 / 2 = {want0:.4f} (sigma {sigma:.4f})")
    if not losses[-1] < losses[0]:
        fail(f"(z) the loss did not fall: {losses[0]} -> {losses[-1]}")
    want = {"flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn}
    if any(s != want for s in per_step):
        fail(f"(z) launches a step {per_step}, expected {want} ({cfg.n_enc_layers} encoder, "
             f"{cfg.n_layers} self- and {cfg.n_layers} cross-attentions, forward twice "
             f"under remat)")
    step_s = float(np.median(walls[1:]))
    summary = dict(step_s=step_s, tokens_per_s=B * S / step_s, peak_gib=peak / 2**30,
                   losses=losses)
    log(f"(z) ok: {n} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f} (ln V + sigma^2 / 2 "
        f"= {want0:.4f}, sigma {sigma:.4f}); step wall {step_s:.3f} s (median of steps "
        f"1-{n - 1}; step 0 {walls[0]:.3f} s), {B * S / step_s:.0f} tokens/s; peak device "
        f"memory {peak / 2**30:.2f} GiB; launches {launches}, {per_step[0]} a step")
    batch = next(run.stream)
    prof = _device_profile(lambda: run.step_fn(params, state, batch))
    if prof is None:
        log("(z) torch.profiler saw no device time: busy share not measured")
    else:
        summary.update(idle_share=1 - prof[0] / (step_s * 1e3), ops_ms=dict(prof[3]))
        log(f"(z) one step: device busy {prof[0]:.1f} ms of {step_s * 1e3:.1f} ms wall "
            f"(idle share {summary['idle_share']:.2f}), {prof[1]} kernels; busiest: "
            + ", ".join(f"{nm[:60]} {ms:.1f} ms" for nm, ms in prof[2])
            + "; by op: " + ", ".join(f"{nm} {ms:.1f} ms" for nm, ms in prof[3]))
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads, _ = grads_of(run.model, params, batch)
    torch.cuda.synchronize()
    peak_bwd = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run.opt.update(params, grads, state)
    torch.cuda.synchronize()
    peak_upd = torch.cuda.max_memory_allocated()
    summary.update(peak_bwd_gib=peak_bwd / 2**30, peak_update_gib=peak_upd / 2**30)
    log(f"(z) device memory: {resident / 2**30:.2f} GiB held between steps (weights, "
        f"AdamW moments), peak {peak_bwd / 2**30:.2f} GiB in the backward, "
        f"{peak_upd / 2**30:.2f} GiB in AdamW.update")
    del run, params, state, metrics, batch, grads
    torch.cuda.empty_cache()

    small = cfg.replace(n_layers=TRAIN_GRAD_LAYERS, n_enc_layers=TRAIN_GRAD_LAYERS)
    model, m32 = build(small), build(small.replace(dtype="float32"))
    p2 = model.init(SEED, device=dev)
    p32 = tree_map(lambda t: t.float(), p2)
    batch = next(TokenStream(TokenStreamConfig(vocab=cfg.vocab, batch=B, seq_len=S,
                                               seed=SEED, d_model=cfg.d_model,
                                               family=cfg.family), device=dev))
    ops.reset_launch_counts()
    kern, _ = grads_of(model, p2, batch)
    n_kern = dict(ops.launches)
    real = FA.flash_attention_cuda, FA.flash_attention_bwd_cuda
    FA.flash_attention_cuda, FA.flash_attention_bwd_cuda = (
        FA.flash_attention_plain, FA.flash_attention_bwd_plain)
    try:
        plain, _ = grads_of(model, p2, batch)
        g32, _ = grads_of(m32, p32, batch)
    finally:
        FA.flash_attention_cuda, FA.flash_attention_bwd_cuda = real
    torch.cuda.synchronize()
    if ops.launches != n_kern or n_kern["flash_attention_bwd"] != 3 * TRAIN_GRAD_LAYERS:
        fail(f"(z) the kernel step launched {n_kern}, the plain steps {dict(ops.launches)}")
    rel = lambda a, b: _err(a.float(), b.float()) / float(b.float().abs().max())
    errs = {k: (rel(a, w), rel(b, w), rel(a, b))   # kernels, plain from f32; apart
            for (k, a), b, w in zip(_named_leaves(kern), tree_leaves(plain),
                                    tree_leaves(g32))}
    bound = {k: max(LM_GRAD_TOL, XATTN_GRAD_RATIO * e[1]) for k, e in errs.items()}
    worst = max(errs, key=lambda k: errs[k][0] / bound[k])
    apart_worst = max(errs, key=lambda k: errs[k][2])
    apart = sorted(errs, key=lambda k: -errs[k][2])[:4]
    summary["grad_err"] = {k: errs[k] for k in apart}
    log(f"(z) one step at {cfg.name}'s widths, {TRAIN_GRAD_LAYERS} encoder and "
        f"{TRAIN_GRAD_LAYERS} decoder layers, B={B}, S={S}, per leaf max |Δg| / max|g| "
        f"(kernels from f32, plain from f32, kernels from plain): the leaves farthest "
        f"apart " + ", ".join(f"{k} {errs[k][0]:.4g} / {errs[k][1]:.4g} / {errs[k][2]:.4g}"
                              for k in apart)
        + f"; median kernels from plain {float(np.median([e[2] for e in errs.values()])):.4g}"
        f"; closest to its bound {worst} {errs[worst][0]:.4g} (bound {bound[worst]:.4g}: "
        f"the larger of {LM_GRAD_TOL} and {XATTN_GRAD_RATIO} x the plain versions' own)")
    if not errs[worst][0] <= bound[worst]:
        fail(f"(z) {worst}'s gradient through the kernels is {errs[worst][0]} of its max "
             f"|g| from f32's (> {bound[worst]}; the plain versions' {errs[worst][1]})")
    if not errs[apart_worst][2] <= LM_GRAD_TOL:
        fail(f"(z) {apart_worst}'s gradients through the kernels and through the plain "
             f"versions are {errs[apart_worst][2]} of its max |g| apart (> {LM_GRAD_TOL})")
    # the planted fault the gate must reject: the backward kernel's dk x 0.9
    def scaled_dk(*args, **kw):
        dq, dk, dv = real[1](*args, **kw)
        return dq, (dk.float() * 0.9).to(dk.dtype), dv

    FA.flash_attention_bwd_cuda = scaled_dk
    try:
        faulty, _ = grads_of(model, p2, batch)
    finally:
        FA.flash_attention_bwd_cuda = real[1]
    moved = {k: rel(a, w) / bound[k]
             for (k, a), w in zip(_named_leaves(faulty), tree_leaves(g32))}
    far = max(moved, key=moved.get)
    summary["fault_dk_scaled"] = (far, moved[far])
    log(f"(z) the backward kernel's dk x 0.9 moves {far} to {moved[far]:.3g} times its "
        f"bound")
    if not moved[far] > 1:
        fail("(z) the gradient gate accepts the backward kernel's dk x 0.9")
    del faulty
    del model, m32, p2, p32, kern, plain, g32, batch
    torch.cuda.empty_cache()
    return launches, summary


def _world_on_card(dev):
    """Join a one-rank world on ``dev`` (NCCL on the card; a ``file://``
    rendezvous under ``build/``); returns the rendezvous directory to
    remove after ``leave_world``."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch import mesh as meshlib

    rdv = Path(tempfile.mkdtemp(prefix="world-", dir=Path(__file__).resolve().parent / "build"))
    meshlib.join_world(0, 1, f"file://{rdv / 'rendezvous'}", device=dev.type)
    if dev.type == "cuda" and dist.get_backend() != "nccl":
        fail(f"the one-rank world runs {dist.get_backend()}, not nccl")
    return rdv


def _leave_world(rdv):
    from repro_torch.launch import mesh as meshlib

    meshlib.leave_world()
    shutil.rmtree(rdv, ignore_errors=True)


def _ef_average(g, steps, group, feedback=True):
    """The average of ``steps`` compressed means of the fixed gradient
    ``g`` over ``group``, with error feedback (or, the planted fault,
    without: the residual dropped every step) → (average, last scale)."""
    from repro_torch.optim.compression import compressed_psum_mean, quantize_int8

    r = torch.zeros_like(g)
    acc = torch.zeros_like(g)
    for _ in range(steps):
        mean, new_r = compressed_psum_mean({"g": g}, {"g": r}, group)
        acc += mean["g"]
        scale = quantize_int8(g + r)[1]
        r = new_r["g"] if feedback else torch.zeros_like(g)
    return acc / steps, float(scale)


def phase_compressed_train(dev):
    """(aa): qwen3-1.7b at (q)'s settings trained COMPRESSED_STEPS steps
    with make_train_step_compressed over a (pod, data, model) = (1, 1, 1)
    mesh of a one-rank NCCL world, then the same steps uncompressed."""
    import math

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.trace_analysis import collective_bytes, load_trace, op_histogram
    from repro_torch.models.model import build
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.optim import compression as C
    from repro_torch.train.train_step import (
        grads_of,
        make_train_step_compressed,
        make_train_step_parts,
    )

    cfg = get_config(TRAIN_ARCH)
    B, S, n = TRAIN_BATCH, TRAIN_SEQ, COMPRESSED_STEPS
    rdv = _world_on_card(dev)
    mesh = meshlib.make_debug_mesh(1, 1, n_pod=1)
    group = mesh.get_group("pod")
    run = launch_train.build_run(cfg, steps=n, batch=B, seq=S, lr=TRAIN_LR, device=dev)
    batches = [next(run.stream) for _ in range(n + 1)]    # the last one is profiled
    params, state = run.init_state()
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_leaves = len(tree_leaves(params))

    # make_train_step_parts: its gradients are make_train_step's backward's,
    # bitwise, at full size (n_micro 1) and at 2 layers (n_micro 2 against
    # the f32 mean of the two halves' backward)
    parts, _ = make_train_step_parts(run.model, 1)(params, batches[0])
    plain, _ = grads_of(run.model, params, batches[0])
    _tree_bitwise("(aa) make_train_step_parts' gradients (n_micro 1)", parts, plain)
    del plain
    small = build(cfg.replace(n_layers=TRAIN_GRAD_LAYERS))
    p2 = small.init(SEED, device=dev)
    g2, _ = make_train_step_parts(small, 2)(p2, batches[0])
    halves = [grads_of(small, p2, {k: v.reshape(2, B // 2, *v.shape[1:])[i]
                                   for k, v in batches[0].items()})[0] for i in (0, 1)]
    want2 = tree_map(lambda a, b: (torch.zeros(a.shape, dtype=torch.float32, device=dev)
                                   .add_(a.float()).add_(b.float())) / 2, *halves)
    _tree_bitwise("(aa) make_train_step_parts' gradients (n_micro 2, 2 layers)", g2, want2)
    del small, p2, g2, halves, want2

    # every leaf's compressed mean is deq(quant(g32 + r)) in the gradient's
    # dtype, every residual g32 - deq, |r| <= scale / 2 (step 0's gradients)
    zeros = C.init_residual(parts)
    mean, res = C.compressed_psum_mean(parts, zeros, group)
    worst, zero_codes = 0.0, {}
    names = [path for path, _ in _named_leaves(parts)]
    for name, g, r0, m, r in zip(names, *(tree_leaves(t) for t in (parts, zeros, mean, res))):
        g32 = g.float() + r0
        q, s = C.quantize_int8(g32)
        deq = C.dequantize_int8(q, s)
        # the share of zero codes: under the leaf's one scale, and under
        # one scale a layer where the leaf stacks the layers; beside it
        # the share of gradients that are exactly 0
        per_layer = None
        if name.startswith("/layers/"):
            amax = g32.abs().amax(dim=tuple(range(1, g32.dim())), keepdim=True)
            s_l = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
            per_layer = round(float((torch.round(g32 / s_l) == 0).float().mean()), 4)
        zero_codes[name] = (round(float((q == 0).float().mean()), 4), per_layer,
                            round(float((g32 == 0).float().mean()), 4))
        if not (_same_bits(m, deq.to(g.dtype)) and _same_bits(r, g32 - deq)):
            fail(f"(aa) a leaf {tuple(g.shape)}: the compressed mean or residual is not "
                 f"deq(quant(g + r)) / g + r - deq bitwise")
        ratio = float(r.abs().max()) / float(s)
        if ratio > 0.5 + RESIDUAL_SLACK:
            fail(f"(aa) a residual of {tuple(g.shape)} reaches {ratio} of its scale "
                 f"(> 1/2 + {RESIDUAL_SLACK:.3g})")
        worst = max(worst, ratio)
    step0_res = [t.cpu() for t in tree_leaves(res)]
    del parts, zeros, mean, res
    log(f"(aa) ok: make_train_step_parts bitwise make_train_step's backward (n_micro 1 at "
        f"{cfg.n_layers} layers, n_micro 2 at {TRAIN_GRAD_LAYERS}); all {n_leaves} leaves' "
        f"compressed means bitwise deq(quant(g + r)) and residuals g + r - deq, max |r| / "
        f"scale {worst:.4f}")
    n_zero = sum(zero_codes[k][0] * t.numel() for k, t in zip(names, tree_leaves(params)))
    log(f"(aa) step 0's share of zero int8 codes a leaf (under the leaf's scale, under one "
        f"scale a layer; the share of exactly zero gradients): {zero_codes}; zero codes "
        f"{n_zero / n_params:.4f} of all elements")

    # the main path: n steps compressed, counted
    step = make_train_step_compressed(run.model, run.opt, mesh)
    residual = C.init_residual(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, walls, per_step = [], [], [], []
    ops.reset_launch_counts()
    for i in range(n):
        before = dict(ops.launches)
        t0 = time.perf_counter()
        params, state, residual, metrics = step(params, state, residual, batches[i])
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        per_step.append({k: ops.launches[k] - before[k]
                         for k in ("flash_attention", "flash_attention_bwd")})
        if i == 0 and not all(_same_bits(a, b.to(dev))
                              for a, b in zip(tree_leaves(residual), step0_res)):
            fail("(aa) step 0's residual is not the one compressed_psum_mean gave its "
                 "gradients")
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    final = _host_leaves(params)         # (ae) holds its sharded run to these
    del step0_res
    want = {"flash_attention": 2 * cfg.n_layers, "flash_attention_bwd": cfg.n_layers}
    if any(s != want for s in per_step):
        fail(f"(aa) launches a step {per_step}, expected {want}")
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail(f"(aa) a loss or grad norm is not finite: {losses}, {gnorms}")
    ln_v = math.log(cfg.vocab)
    if not abs(losses[0] - ln_v) <= TRAIN_LOSS0_TOL:
        fail(f"(aa) step 0's loss {losses[0]} is not within {TRAIN_LOSS0_TOL} of ln V")
    if not losses[-1] < losses[0]:
        fail(f"(aa) the loss did not fall: {losses[0]} -> {losses[-1]}")
    step_s = float(np.median(walls[1:]))

    # one more step under the profiler: busy share, the compression's
    # device time, and the collectives read from the trace
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        params, state, residual, _ = step(params, state, residual, batches[n])
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3
    trace = load_trace(prof)
    stats = collective_bytes(trace, dist.get_world_size())
    top = op_histogram(trace, top=3)
    payload = stats.payload_by_op.get("all_gather", 0)
    if payload != n_params + 4 * n_leaves or stats.total_wire_bytes != 0:
        fail(f"(aa) the step's trace reads an all-gather payload of {payload} bytes and "
             f"{stats.total_wire_bytes} wire bytes; expected {n_params + 4 * n_leaves} "
             f"(int8 parameters and an f32 scale a leaf) and 0 at one rank: {stats.count_by_op}")
    comp_ms = _device_ms(lambda: C.compressed_psum_mean(params, residual, group), iters=3)
    comp_txt = "not measured" if comp_ms is None else f"{comp_ms:.2f} ms"
    log(f"(aa) ok: {n} compressed steps of B={B} x S={S}, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (ln V = {ln_v:.4f}), grad norms {[round(x, 4) for x in gnorms]}; "
        f"step wall {step_s:.3f} s (median of steps 1-{n - 1}; step 0 {walls[0]:.3f} s), "
        f"{B * S / step_s:.0f} tokens/s; one step's device busy {busy:.1f} ms (idle share "
        f"{1 - busy / (step_s * 1e3):.2f}); compressed_psum_mean {comp_txt} of device "
        f"time over the {n_leaves} leaves ({n_params / 1e9:.3f} B elements); peak device "
        f"memory {peak / 2**30:.2f} GiB (f32 residual {4 * n_params / 2**30:.2f} GiB); "
        f"launches {launches}")
    log(f"(aa) the trace's collectives: {stats.count_by_op}, payload {stats.payload_by_op} "
        f"bytes, wire {stats.bytes_by_op} at one rank; at pod = 2 the same tree would move "
        f"{C.wire_bytes_int8_allgather(n_params, 2)} bytes (int8 all-gather) against "
        f"{C.wire_bytes_f32_allreduce(n_params, 2)} (f32 ring all-reduce) a device; most "
        f"frequent kernels {top}")
    del params, state, residual, metrics, step, prof, trace
    torch.cuda.empty_cache()

    # the same steps uncompressed, from the same init and batches
    params, state = run.init_state()
    plain_losses, plain_walls = [], []
    for i in range(n):
        t0 = time.perf_counter()
        params, state, metrics = run.step_fn(params, state, batches[i])
        plain_losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        plain_walls.append(time.perf_counter() - t0)
    plain_s = float(np.median(plain_walls[1:]))
    gaps = [a - b for a, b in zip(losses, plain_losses)]
    log(f"(aa) uncompressed: loss {plain_losses[0]:.4f} -> {plain_losses[-1]:.4f}, step wall "
        f"{plain_s:.3f} s; compressed - uncompressed loss a step "
        f"{[round(x, 5) for x in gaps]}; the compressed step {step_s / plain_s:.3f}x the "
        f"uncompressed wall")
    del params, state, metrics, run
    torch.cuda.empty_cache()

    # error feedback at full width: a fixed gradient of the embedding's
    # shape, 50 compressed means averaged, within scale / 50 + 1e-4 of it
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    g = torch.randn((cfg.vocab, cfg.d_model), generator=gen, device=dev)
    avg, scale = _ef_average(g, EF_STEPS, group)
    err = float((avg - g).abs().max())
    bound = scale / EF_STEPS + 1e-4
    if not err <= bound:
        fail(f"(aa) error feedback: the average of {EF_STEPS} compressed means lies "
             f"{err} from the gradient (> scale / {EF_STEPS} + 1e-4 = {bound})")
    avg, _ = _ef_average(g, EF_STEPS, group, feedback=False)
    dropped = float((avg - g).abs().max())
    if dropped <= bound:
        fail(f"(aa) the bound accepts a mean that drops the residual ({dropped} <= {bound})")
    log(f"(aa) ok: error feedback at {tuple(g.shape)}: {EF_STEPS} compressed means average "
        f"{err:.3g} from the gradient (bound {bound:.3g}); without the residual {dropped:.3g}, "
        f"rejected")
    del g, avg
    _leave_world(rdv)
    torch.cuda.empty_cache()
    return {k: launches.get(k, 0) for k in ops.KERNELS}, dict(
        step_s=step_s, plain_step_s=plain_s, peak_gib=peak / 2**30, losses=losses,
        loss_gaps=gaps, compress_ms=comp_ms, payload=payload, params=final)


def phase_gpipe(dev):
    """(ab): GPipe at one stage over qwen3-1.7b's 28 layers (the stage's
    leaves with a leading stage axis of 1) on GPIPE_MICRO microbatches of
    (1, TRAIN_SEQ, d_model) bf16 hidden states, in a one-rank NCCL world."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.pipeline import gpipe, reference_pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import embed_lookup
    from repro_torch.models.model import build

    cfg = get_config(TRAIN_ARCH)
    model = build(cfg)
    params = model.init(SEED, device=dev)
    rdv = _world_on_card(dev)
    mesh = meshlib.make_debug_mesh(1, 1, n_pod=1)
    stage_params = tf.tree_map(lambda t: t[None], params["layers"])
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    tokens = torch.randint(0, cfg.vocab, (GPIPE_MICRO, 1, TRAIN_SEQ), generator=gen, device=dev)
    x = embed_lookup(params["embed"], tokens)

    def stage_fn(p, xb):
        return tf.stack_forward(p, xb, cfg, model.plan)[0]

    with torch.no_grad():
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = gpipe(stage_fn, stage_params, x, mesh=mesh, axis="pod")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
        ref = reference_pipeline(stage_fn, stage_params, x)
        direct = torch.stack([stage_fn(params["layers"], x[m]) for m in range(GPIPE_MICRO)])
    _leave_world(rdv)
    if not (torch.isfinite(out).all() and out.shape == x.shape):
        fail(f"(ab) gpipe's output {tuple(out.shape)} is not finite of the input's shape")
    if not (_same_bits(out, ref) and _same_bits(out, direct)):
        fail("(ab) gpipe's output is not bitwise reference_pipeline's and the stack's")
    want = GPIPE_MICRO * cfg.n_layers
    if launches["flash_attention"] != want:
        fail(f"(ab) gpipe launched flash_attention {launches['flash_attention']} times, "
             f"expected {want}")
    log(f"(ab) ok: gpipe at one stage of {cfg.n_layers} layers, {GPIPE_MICRO} microbatches "
        f"of (1, {TRAIN_SEQ}, {cfg.d_model}) {cfg.dtype}: bitwise reference_pipeline and the "
        f"stack forward, {launches['flash_attention']} flash launches, {wall * 1e3:.1f} ms")
    del params, stage_params, x, out, ref, direct
    torch.cuda.empty_cache()
    return {k: launches.get(k, 0) for k in ops.KERNELS}, dict(wall_ms=wall * 1e3)


@contextlib.contextmanager
def _moe_calls(cfg_of=None):
    """Record every MoE layer run inside: its params, its input and its
    routed output (``moe_forward``'s ``y``), in order; the i-th layer runs
    with ``cfg_of(i, cfg)`` where that is given."""
    from repro_torch.models import moe

    real, seen = moe.moe_forward, []

    def record(p, x, cfg):
        y, aux = real(p, x, cfg if cfg_of is None else cfg_of(len(seen), cfg))
        seen.append((p, x, y))
        return y, aux

    moe.moe_forward = record
    try:
        yield seen
    finally:
        moe.moe_forward = real


def _moe_drift(calls, ref_calls):
    """Each MoE layer's output of one run against another's, as a share of
    the reference output's max, in layer order."""
    return [_err(y, y0) / float(y0.float().abs().max())
            for (_, _, y), (_, _, y0) in zip(calls, ref_calls)]


def phase_moe_grouped(dev):
    """(ac): deepseek-v2-lite-16b at full width and depth, prefill of
    MOE_BATCH x MOE_PROMPT tokens with dispatch_groups = MOE_GROUPS against
    the global dispatch, at a capacity where nothing drops and under the
    global run's routing replayed group by group: the logits, the MoE
    layers' outputs end to end, and each MoE layer's output on the global
    run's input to that layer.  Two witnesses of where the end-to-end
    drift comes from, held to the global run the same ways: the global
    dispatch at MOE_WIDE times the slots (only the expert products' row
    count changes), and the global run with its first MoE layer alone
    grouped (that layer's rounding carried through the global path); and
    each layer's router logits over a group's rows against the whole
    call's."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.model import build
    from repro_torch.models.moe import pinned_routing

    cfg = _no_drop(get_config(MOE_ARCH))
    grouped_cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_groups=MOE_GROUPS))
    wide_cfg = cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_WIDE * cfg.moe.capacity_factor))
    model, grouped, wide = build(cfg), build(grouped_cfg), build(wide_cfg)
    params = model.init(SEED, device=dev)
    B, L = MOE_BATCH, MOE_PROMPT
    slots = [moe.capacity_of(B * L // g, c.moe)
             for g, c in ((1, cfg), (MOE_GROUPS, cfg), (1, wide_cfg))]
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    prompt = {"tokens": torch.randint(0, cfg.vocab, (B, L), generator=gen, device=dev)}
    with pinned_routing() as pin, _moe_calls() as calls:
        logits0, _ = model.prefill(params, prompt)
    if not torch.isfinite(logits0).all():
        fail("(ac) the global prefill's logits are not finite")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(params, prompt)
    torch.cuda.synchronize()
    wall0 = time.perf_counter() - t0
    chunks = [list(call.chunk(MOE_GROUPS)) for call in pin.log]

    def against_global(run, routing, cfg_of=None):
        """Prefill ``run`` under ``routing`` replayed: its logits' and MoE
        layers' distance from the global run's, and the run's pin."""
        with pinned_routing() as rpin, _moe_calls(cfg_of) as rcalls:
            rpin.replay(routing)
            logits, _ = run.prefill(params, prompt)
        if not torch.isfinite(logits).all():
            fail("(ac) prefill logits not finite")
        return _logit_diff(logits, logits0), _moe_drift(rcalls, calls), rpin

    err_w, e2e_w, _ = against_global(wide, pin.log)
    err_s, e2e_s, _ = against_global(model, chunks[0] + pin.log[1:],
                                     lambda i, c: grouped_cfg if i == 0 else c)
    grouped_routing = [c for cs in chunks for c in cs]
    ops.reset_launch_counts()
    err, e2e_g, gpin = against_global(grouped, grouped_routing)
    launches = dict(ops.launches)
    with pinned_routing() as tpin:
        tpin.replay(grouped_routing)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grouped.prefill(params, prompt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # each MoE layer alone, on the global run's input to it and under its
    # routing: only the expert products' shapes differ; and its router
    # logits (f32) over each group's rows against the whole call's
    alone_g, alone_w, router = [], [], []
    with torch.no_grad():
        for (p, x, y), experts in zip(calls, pin.log):
            for run_cfg, routing, out in ((grouped_cfg, experts.chunk(MOE_GROUPS), alone_g),
                                          (wide_cfg, [experts], alone_w)):
                with pinned_routing() as lpin:
                    lpin.replay(list(routing))
                    yr, _ = moe.moe_forward(p, x, run_cfg)
                out.append(_err(yr, y) / float(y.float().abs().max()))
            xf = x.reshape(-1, x.shape[-1]).float()
            whole = xf @ p["w_router"]
            router.append(_err(torch.cat([xg @ p["w_router"] for xg in
                                          xf.chunk(MOE_GROUPS)]), whole)
                          / float(whole.abs().max()))
    fmt = lambda xs: [round(v, 5) for v in xs]
    log(f"(ac) {len(calls)} MoE layers' outputs against the global dispatch ({slots[0]} slots "
        f"an expert), as a share of their max, layer by layer: end to end grouped "
        f"({MOE_GROUPS} x {slots[1]} slots) {fmt(e2e_g)}; the first layer alone grouped "
        f"{fmt(e2e_s)}; wide ({slots[2]} slots) {fmt(e2e_w)}; alone on the global run's "
        f"inputs grouped {fmt(alone_g)}, wide {fmt(alone_w)}; router logits over "
        f"{B * L // MOE_GROUPS} rows against {B * L}, a share of their max, "
        f"{[float(f'{v:.3g}') for v in router]}; logits grouped {err:.4g}, first layer "
        f"grouped {err_s:.4g}, wide {err_w:.4g}")
    if err > MOE_TOL or max(e2e_g) > MOE_E2E_TOL or max(alone_g) > MOE_GROUPED_TOL:
        fail(f"(ac) grouped dispatch against global: logits {err} (tol {MOE_TOL}), MoE "
             f"outputs end to end {max(e2e_g)} (tol {MOE_E2E_TOL}), each layer alone "
             f"{max(alone_g)} (tol {MOE_GROUPED_TOL}) of their max")
    n_attn = _plan_count(model.plan, lambda k: k[0] == "attn")
    if launches["flash_attention"] != n_attn:
        fail(f"(ac) the grouped prefill launched {launches}, expected {n_attn} flash")
    bad = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_groups=3))
    try:
        build(bad).prefill(params, prompt)
        fail("(ac) dispatch_groups=3 over 8,192 tokens did not raise")
    except ValueError as e:
        refused = str(e)
    log(f"(ac) ok: {cfg.name} prefill ({B} x {L}) with dispatch_groups={MOE_GROUPS} "
        f"(capacity factor {cfg.moe.capacity_factor:.4g}: nothing drops) against the global "
        f"dispatch under its replayed routing ({gpin.flips} of {B * L * len(calls)} (token, "
        f"layer) sets of the grouped run's own differ): logits {err:.4g} (tol {MOE_TOL}); "
        f"MoE outputs end to end {max(e2e_g):.4g} of their max (tol {MOE_E2E_TOL}; the "
        f"first layer alone grouped {max(e2e_s):.4g}, the {MOE_WIDE}x-slot witness "
        f"{max(e2e_w):.4g}); each alone on the global run's input {max(alone_g):.4g} (tol "
        f"{MOE_GROUPED_TOL}); {launches['flash_attention']} flash launches; prefill "
        f"{wall * 1e3:.1f} ms grouped, {wall0 * 1e3:.1f} ms global (both at the no-drop "
        f"capacity); refused: {refused!r}")
    del params, logits0, calls
    torch.cuda.empty_cache()
    return {k: launches.get(k, 0) for k in ops.KERNELS}, dict(
        logit_err=err, e2e_err=max(e2e_g), mixer_err=max(alone_g), wall_ms=wall * 1e3,
        global_wall_ms=wall0 * 1e3)


def _named_leaves(tree, path=""):
    """``(path, leaf)`` of every leaf of a tree of dicts and lists, in
    ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _named_leaves(v, f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _named_leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def _host_leaves(tree):
    """Every leaf of a tree (DTensors whole) copied to the host, in
    ``tree_leaves``' order."""
    from repro_torch.models.transformer import tree_leaves

    return [(t.full_tensor() if hasattr(t, "full_tensor") else t).detach().cpu()
            for t in tree_leaves(tree)]


def _host_compare(got, want):
    """Two lists of host leaves: (all bitwise, the largest difference as a
    share of its leaf's max)."""
    same = len(got) == len(want) and all(_same_bits(a, b) for a, b in zip(got, want))
    worst = max(_err(a, b) / max(float(b.float().abs().max()), 1e-30)
                for a, b in zip(got, want))
    return same, worst


def phase_sharded_train(dev, q_step_s):
    """(ad): qwen3-1.7b at (q)'s settings, SHARDED_STEPS steps of the
    sharded (FSDP x TP) step over a (data, model) = 1 x 1 mesh of a
    one-rank NCCL world under use_mesh (parameters and AdamW moments
    DTensors, the flash kernels on the local shards), against the same
    steps unsharded from the same parameters and batches; then
    launch/train.py --mesh 1x1 --reduced stopped and resumed."""
    import math

    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import train as launch_train
    from repro_torch.models.transformer import tree_leaves

    cfg = get_config(TRAIN_ARCH)
    B, S, n = TRAIN_BATCH, TRAIN_SEQ, SHARDED_STEPS
    rdv = _world_on_card(dev)
    mesh = meshlib.make_debug_mesh(1, 1)
    run = launch_train.build_run(cfg, steps=n, batch=B, seq=S, lr=TRAIN_LR, device=dev)
    srun = launch_train.build_run(cfg, steps=n, batch=B, seq=S, lr=TRAIN_LR, device=dev,
                                  mesh=mesh)
    batches = [next(run.stream) for _ in range(n)]

    params, state = run.init_state()
    plain_losses, plain_walls = [], []
    for i in range(n):
        t0 = time.perf_counter()
        params, state, metrics = run.step_fn(params, state, batches[i])
        plain_losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        plain_walls.append(time.perf_counter() - t0)
    want = _host_leaves(params)
    del params, state, metrics
    torch.cuda.empty_cache()

    params, state = srun.init_state()
    placed = all(type(t).__name__ == "DTensor" for t in tree_leaves(params))
    losses, gnorms, walls, per_step = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    for i in range(n):
        before = dict(ops.launches)
        t0 = time.perf_counter()
        params, state, metrics = srun.step_fn(params, state, batches[i])
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        per_step.append({k: ops.launches[k] - before[k]
                         for k in ("flash_attention", "flash_attention_bwd")})
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    if not placed or not all(type(t).__name__ == "DTensor" for t in tree_leaves(params)):
        fail("(ad) the sharded step's state is not DTensors")
    want_l = {"flash_attention": 2 * cfg.n_layers, "flash_attention_bwd": cfg.n_layers}
    if any(s != want_l for s in per_step):
        fail(f"(ad) launches a step {per_step}, expected {want_l}")
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail(f"(ad) a loss or grad norm is not finite: {losses}, {gnorms}")
    same, worst = _host_compare(_host_leaves(params), want)
    loss_gap = max(abs(a - b) for a, b in zip(losses, plain_losses))
    if not same or losses != plain_losses:
        log(f"(ad) the sharded run is not bitwise the unsharded one: losses {losses} against "
            f"{plain_losses}, parameters up to {worst:.4g} of a leaf's max")
        if worst > LM_GRAD_TOL or loss_gap > SHARDED_LOSS_TOL:
            fail(f"(ad) sharded against unsharded: parameters {worst} of a leaf's max (tol "
                 f"{LM_GRAD_TOL}), losses {loss_gap} apart (tol {SHARDED_LOSS_TOL})")
    step_s, plain_s = float(np.median(walls[1:])), float(np.median(plain_walls[1:]))
    log(f"(ad) ok: {n} sharded steps of {cfg.name} (B={B} x S={S}, bf16) over (data, model) "
        f"= 1 x 1 under use_mesh, {'bitwise' if same and losses == plain_losses else 'within tolerance of'} "
        f"the unsharded steps: losses {[round(x, 4) for x in losses]}, parameters after "
        f"{n} steps (worst {worst:.3g} of a leaf's max); step wall {step_s:.3f} s sharded "
        f"(median of steps 1-{n - 1}; step 0 {walls[0]:.3f} s), {plain_s:.3f} s unsharded "
        f"here, (q) {q_step_s:.3f} s: {step_s / plain_s:.3f}x the unsharded; peak device "
        f"memory {peak / 2**30:.2f} GiB; launches {launches}")
    del params, state, metrics, want, run, srun
    torch.cuda.empty_cache()

    # launch/train.py --mesh 1x1 on the card: 6 steps against the unsharded
    # CLI, and a run stopped by SIGTERM after 4 and resumed to 6, bitwise
    root = Path(__file__).resolve().parent / "build" / "chip_mesh_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    argv = ["--arch", TRAIN_ARCH, "--reduced", "--steps", "6", "--device", dev.type,
            "--ckpt-every", "2"]
    plain = launch_train.run(argv + ["--ckpt-dir", str(root / "plain")])
    argv += ["--mesh", "1x1"]
    whole = launch_train.run(argv + ["--ckpt-dir", str(root / "whole")])
    fetch = TokenStream.__next__

    def sigterm_at_batch_3(stream):   # a preemption: step 4 ends, then a save
        if stream.position == 3:
            signal.raise_signal(signal.SIGTERM)
        return fetch(stream)

    TokenStream.__next__ = sigterm_at_batch_3
    try:
        cut = launch_train.run(argv + ["--ckpt-dir", str(root / "cut")])
    finally:
        TokenStream.__next__ = fetch
    resumed = launch_train.run(argv + ["--ckpt-dir", str(root / "cut"), "--resume"])
    if (cut.summary["step"], resumed.summary["step"], whole.summary["step"]) != (4, 6, 6):
        fail(f"(ad) CLI runs ended at {cut.summary}, {resumed.summary}, {whole.summary}")
    if whole.losses != plain.losses or cut.losses + resumed.losses != whole.losses:
        fail(f"(ad) --mesh 1x1 losses {whole.losses}, unsharded {plain.losses}, resumed "
             f"{cut.losses + resumed.losses}")
    for what, a, b in (("params", resumed.trainer.params, whole.trainer.params),
                       ("AdamW state", resumed.trainer.opt_state, whole.trainer.opt_state),
                       ("params against the unsharded CLI's", whole.trainer.params,
                        plain.trainer.params)):
        if not _host_compare(_host_leaves(a), _host_leaves(b))[0]:
            fail(f"(ad) the --mesh 1x1 CLI's {what}: not bitwise equal")
    shutil.rmtree(root, ignore_errors=True)
    log(f"(ad) ok: launch/train.py --reduced --mesh 1x1 on the card: 6 steps bitwise the "
        f"unsharded CLI's (loss {whole.losses[0]:.4f} -> {whole.losses[-1]:.4f}); stopped by "
        f"SIGTERM at 4 and resumed to 6 from its checkpoint, params and AdamW state bitwise "
        f"the uninterrupted run's")
    _leave_world(rdv)
    torch.cuda.empty_cache()
    return {k: launches.get(k, 0) for k in ops.KERNELS}, dict(
        step_s=step_s, plain_step_s=plain_s, peak_gib=peak / 2**30, bitwise=same,
        worst=worst)


def phase_compressed_sharded(dev, aa):
    """(ae): (aa)'s COMPRESSED_STEPS compressed steps again, each pod's
    gradients through the sharded step on the pod's (data, model) = 1 x 1
    mesh of a (pod, data, model) = 1 x 1 x 1 mesh (the state placed there
    first, so the step takes its sharded inner step; state and residual
    DTensors), from the same parameters and batches: losses and the
    parameters after the steps bitwise (aa)'s."""
    import math

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import train as launch_train
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.distributed.sharding import BASE_RULES, ShardingRules
    from repro_torch.optim import compression as C
    from repro_torch.train.train_step import make_sharded_parts, make_train_step_compressed

    cfg = get_config(TRAIN_ARCH)
    B, S, n = TRAIN_BATCH, TRAIN_SEQ, COMPRESSED_STEPS
    rdv = _world_on_card(dev)
    mesh = meshlib.make_debug_mesh(1, 1, n_pod=1)
    run = launch_train.build_run(cfg, steps=n, batch=B, seq=S, lr=TRAIN_LR, device=dev)
    batches = [next(run.stream) for _ in range(n)]
    params, state = run.init_state()
    residual = C.init_residual(params)
    # placed on the pod's mesh, the state takes the sharded inner step
    place = make_sharded_parts(run.model, run.opt, mesh["data", "model"],
                               ShardingRules(BASE_RULES).strip("pod"))[0]
    params, state = place(params, state)
    step = make_train_step_compressed(run.model, run.opt, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    ops.reset_launch_counts()
    for i in range(n):
        t0 = time.perf_counter()
        params, state, residual, metrics = step(params, state, residual, batches[i])
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    want_l = {"flash_attention": 2 * cfg.n_layers * n, "flash_attention_bwd": cfg.n_layers * n}
    if {k: launches[k] for k in want_l} != want_l:
        fail(f"(ae) launches {launches}, expected {want_l}")
    if not all(type(t).__name__ == "DTensor" for t in tree_leaves(residual)):
        fail("(ae) the sharded compressed step's residual is not DTensors")
    if not all(math.isfinite(x) for x in losses):
        fail(f"(ae) a loss is not finite: {losses}")
    same, worst = _host_compare(_host_leaves(params), aa["params"])
    if losses != aa["losses"] or not same:
        fail(f"(ae) the sharded compressed run is not bitwise (aa)'s: losses {losses} against "
             f"{aa['losses']}, parameters up to {worst:.4g} of a leaf's max")
    step_s = float(np.median(walls[1:]))
    log(f"(ae) ok: {n} compressed steps through the sharded inner step over (pod, data, "
        f"model) = 1 x 1 x 1, bitwise (aa) (losses {[round(x, 4) for x in losses]}, "
        f"parameters after {n} steps); step wall {step_s:.3f} s (median of steps 1-{n - 1}; "
        f"(aa) {aa['step_s']:.3f} s), peak device memory {peak / 2**30:.2f} GiB; launches "
        f"{launches}")
    del params, state, residual, metrics, step, run
    _leave_world(rdv)
    torch.cuda.empty_cache()
    return {k: launches.get(k, 0) for k in ops.KERNELS}, dict(step_s=step_s,
                                                              peak_gib=peak / 2**30)


def phase_moe_expert_parallel(dev):
    """(af): deepseek-v2-lite-16b at full width and depth, prefill of
    MOE_BATCH x MOE_PROMPT tokens at the no-drop capacity with
    use_shard_map over a (data, model) = 1 x 1 mesh of a one-rank NCCL
    world (expert parallelism: the rank's experts, the parts summed over
    model in f32), against the plain path: the logits and every MoE
    layer's output bitwise."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import moe
    from repro_torch.models.model import build

    cfg = _no_drop(get_config(MOE_ARCH))
    ep_cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, use_shard_map=True))
    rdv = _world_on_card(dev)
    mesh = meshlib.make_debug_mesh(1, 1)
    model, ep = build(cfg), build(ep_cfg)
    params = model.init(SEED, device=dev)
    B, L = MOE_BATCH, MOE_PROMPT
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    prompt = {"tokens": torch.randint(0, cfg.vocab, (B, L), generator=gen, device=dev)}
    with _moe_calls() as calls:
        logits0, _ = model.prefill(params, prompt)
    taken = []
    real = moe._moe_expert_parallel

    def spy(*a):
        taken.append(1)
        return real(*a)

    moe._moe_expert_parallel = spy
    try:
        ops.reset_launch_counts()
        with use_mesh(mesh), _moe_calls() as ep_calls:
            logits, _ = ep.prefill(params, prompt)
        launches = dict(ops.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with use_mesh(mesh):
            ep.prefill(params, prompt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        moe._moe_expert_parallel = real
    n_moe = _plan_count(model.plan, lambda k: k[1] == "moe")
    if len(taken) != 2 * n_moe:
        fail(f"(af) expert parallelism ran {len(taken)} times over two prefills, expected "
             f"{2 * n_moe}")
    if not torch.isfinite(logits).all() or not _same_bits(logits, logits0):
        fail(f"(af) the expert-parallel prefill's logits are not bitwise the plain path's "
             f"({_logit_diff(logits, logits0):.4g} apart)")
    bad = [i for i, ((_, _, y), (_, _, y0)) in enumerate(zip(ep_calls, calls))
           if not _same_bits(y, y0)]
    if len(ep_calls) != n_moe or bad:
        fail(f"(af) MoE layers not bitwise the plain path's: {bad} of {len(ep_calls)}")
    n_attn = _plan_count(model.plan, lambda k: k[0] == "attn")
    if launches["flash_attention"] != n_attn:
        fail(f"(af) the expert-parallel prefill launched {launches}, expected {n_attn} flash")
    log(f"(af) ok: {cfg.name} prefill ({B} x {L}) with use_shard_map over (data, model) = "
        f"1 x 1: the logits and all {n_moe} MoE layers' outputs bitwise the plain path's; "
        f"{launches['flash_attention']} flash launches; prefill {wall * 1e3:.1f} ms")
    del params, logits0, logits, calls, ep_calls
    _leave_world(rdv)
    torch.cuda.empty_cache()
    return {k: launches.get(k, 0) for k in ops.KERNELS}, dict(wall_ms=wall * 1e3)


def phase_unscanned_train(dev):
    """(ag): qwen3-1.7b at full width, one training step with
    scan_layers=False from the scanned parameters unstacked (views of the
    stacked leaves), against the scanned step: the loss and every
    gradient bitwise; the parameters after AdamW within one bf16 ulp
    of the larger of the old and the new value (its clip norm sums the
    leaves in another grouping: bitwise where the norms' bits agree)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import build
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.optim.adamw import AdamW, AdamWConfig
    from repro_torch.train.train_step import grads_of

    cfg = get_config(TRAIN_ARCH)
    ucfg = cfg.replace(scan_layers=False)
    model, umodel = build(cfg), build(ucfg)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    params = model.init(SEED, device=dev)
    uparams = tf.unscan_params(params, cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen, device=dev)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    opt = AdamW(AdamWConfig(lr=TRAIN_LR, warmup_steps=1, decay_steps=2))
    old_p = _host_leaves(uparams)
    grads, metrics = grads_of(model, params, batch)
    new, _, om = opt.update(params, grads, opt.init(params))
    want_g = _host_leaves(tf.unscan_params(grads, cfg))
    want_p = _host_leaves(tf.unscan_params(new, cfg))
    del grads, new
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ugrads, umetrics = grads_of(umodel, uparams, batch)
    unew, _, uom = opt.update(uparams, ugrads, opt.init(uparams))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    if umodel.plan.repeats or len(uparams["layers"]["prefix"]) != cfg.n_layers:
        fail(f"(ag) the unscanned plan {umodel.plan}")
    if float(umetrics["loss"]) != float(metrics["loss"]):
        fail(f"(ag) the unscanned loss {float(umetrics['loss'])} is not the scanned "
             f"{float(metrics['loss'])}")
    if not _host_compare(_host_leaves(ugrads), want_g)[0]:
        fail("(ag) the unscanned gradients are not bitwise the scanned ones")
    # one bf16 ulp of the larger of the old and the new value: where an
    # update cancels a parameter, the f32 difference of the two runs'
    # updates survives the rounding to bf16 at the old value's scale
    got_p = _host_leaves(unew)
    ulp = max(float(((a.float() - b.float()).abs() / torch.maximum(
        torch.maximum(a.float().abs(), b.float().abs()), o.float().abs()).clamp_min(
        2 ** -126)).max()) for a, b, o in zip(got_p, want_p, old_p))
    differ = sum(int((a.view(torch.int16) != b.view(torch.int16)).sum())
                 for a, b in zip(got_p, want_p))
    norms = (float(uom["grad_norm"]), float(om["grad_norm"]))
    if ulp > 2 ** -7 or (norms[0] == norms[1] and differ):
        fail(f"(ag) parameters after AdamW: {differ} elements differ, up to {ulp:.3g} of "
             f"their size; grad norms {norms}")
    want_l = {"flash_attention": 2 * cfg.n_layers, "flash_attention_bwd": cfg.n_layers}
    if {k: launches[k] for k in want_l} != want_l:
        fail(f"(ag) launches {launches}, expected {want_l}")
    n_params = sum(t.numel() for t in got_p)
    log(f"(ag) ok: {cfg.name} with scan_layers=False ({cfg.n_layers} prefix layers, the "
        f"scanned parameters unstacked), one step of B={B} x S={S}: loss "
        f"{float(umetrics['loss']):.4f} and every gradient bitwise the scanned step's; "
        f"grad norms {norms[0]!r} / {norms[1]!r}; parameters after AdamW: {differ} of "
        f"{n_params} elements differ (at most {ulp:.3g} of the larger of their old and new "
        f"values, tol 2^-7); step {wall:.3f} s, peak device memory {peak / 2**30:.2f} GiB; "
        f"launches {launches}")
    del params, uparams, ugrads, unew, want_g, want_p, got_p, old_p
    torch.cuda.empty_cache()
    return {k: launches.get(k, 0) for k in ops.KERNELS}, dict(step_s=wall,
                                                              peak_gib=peak / 2**30)


def phase_xattn_flash_timing(dev):
    """(y)/(z) timing: the forward kernel at llama-3.2-vision's
    cross-attention shape (B=4, Sq=2,048 over 1,600 media keys, H=64,
    Hkv=8, D=128) and at seamless's encoder shape (B=4, S=4,096, H=Hkv=16,
    D=64), non-causal, per kernel from torch.profiler beside the plain
    version, SDPA and the bound; and its decode rows (one query row over
    the 1,600 media keys, and over the 4,096 encoded frames), whose
    128-query tiles hold one live row (one consumer warpgroup runs), with
    the host µs a call (the wrapper's checks, the launcher's three tensor
    maps and the launch: 744 such calls a seamless ``generate()``)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import traffic

    gen = torch.Generator(device=dev).manual_seed(SEED + 33)
    rows = {}
    for label, (B, Sq, Skv, H, Hkv, D) in (
            ("vlm cross-attention", (VLM_BATCH, VLM_PROMPT, 1600, 64, 8, 128)),
            ("seamless encoder", (AUDIO_BATCH, 4096, 4096, 16, 16, 64)),
            ("vlm decode row", (VLM_BATCH, 1, 1600, 64, 8, 128)),
            ("seamless decode row", (AUDIO_BATCH, 1, 4096, 16, 16, 64))):
        q, k, v = _flash_inputs(gen, B, Sq, Skv, H, Hkv, D, torch.bfloat16, dev)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        calls = {
            "kernel": lambda: FA.flash_attention_cuda(q, k, v, causal=False),
            "SDPA": lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=False,
                                                           enable_gqa=Hkv != H),
        }
        o = calls["kernel"]()
        err = FA.row_error(o, FA.flash_attention_plain(q, k, v, causal=False))
        lib_err = FA.row_error(calls["SDPA"]().transpose(1, 2), o)
        if not max(err, lib_err) <= FA.BF16_ROW_TOL:
            fail(f"(y/z) at the {label} shape the kernel is {err} from its plain version "
                 f"and SDPA {lib_err} from the kernel (> {FA.BF16_ROW_TOL})")
        ms, split = {}, {}
        for name, fn in calls.items():
            ms[name], split[name] = _median_reading(fn)
            if ms[name] is None:
                ms[name] = _time(fn)
                split[name] = "not measured (profiler saw no device time; CUDA events)"
        ms["plain"] = _time(lambda: FA.flash_attention_plain(q, k, v, causal=False), iters=2)
        host = _host_us(calls["kernel"]) if Sq == 1 else None
        flops = traffic.flash_attention_flops(B, Sq, H, D, Skv, False)
        nbytes = traffic.flash_attention_bytes(B, Sq, Skv, H, Hkv, D, 2)
        t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_TENSOR_FLOPS_PER_S * 1e3
        shape = f"B={B} Sq={Sq} Skv={Skv} H={H} Hkv={Hkv} D={D} bf16 non-causal"
        rows[label] = dict(ms=ms["kernel"], plain_ms=ms["plain"], library_ms=ms["SDPA"],
                           bound_ms=max(t_b, t_f),
                           bound_by="bytes" if t_b >= t_f else "operations", shape=shape,
                           max_row_err=err, library_kernels=split["SDPA"],
                           kernel_split=split["kernel"], host_us_a_call=host)
        log(f"(y/z) flash_attention at the {label} shape {shape}: kernel {ms['kernel']:.4f} "
            f"ms ({split['kernel']}; {flops / ms['kernel'] / 1e9:.1f} TFLOP/s), SDPA "
            f"{ms['SDPA']:.4f} ms (kernels {split['SDPA']}; worst row error to ours "
            f"{lib_err:.4g}), plain {ms['plain']:.3f} ms, bound {max(t_b, t_f):.4f} ms (bytes "
            f"{nbytes}, flops {flops}); worst row error to the plain version {err:.4g}"
            + ("" if host is None else f"; {host:.1f} µs of host time a call"))
        del q, k, v, qh, kh, vh, o
    return rows


def _kernel_label(name: str) -> str:
    """A kernel's name without its namespace and parameter list."""
    return name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]


def _bwd_ptxas():
    """Registers and spill bytes of the backward's bf16 kernels at D=128
    (the pre-pass; the dK/dV and dQ walks, with one and with two heads a dQ
    block), from the build's ptxas report."""
    from repro_torch.kernels import build

    report = build.ptxas_report(build.ptxas_log())
    names = {"flash_bwd_delta_bf16_kernelILi128E": "delta",
             "flash_bwd_kernelILi128ELi128ELi1E": "dkdv + dq (1 head)",
             "flash_bwd_kernelILi128ELi128ELi2E": "dkdv + dq (2 heads)"}
    return {label: report[k] for k in report for key, label in names.items() if key in k}


# ---------------------------------------------------------------------------
# (m) learning while serving, hardened
# ---------------------------------------------------------------------------


def _halves(ev):
    mid = len(ev) // 2
    return ev[:mid], ev[mid:]


def _host_image(weights):
    return {k: v.detach().cpu() for k, v in weights.items()}


def _hardened_engine(image, dev, **kw):
    """A one-model hardened engine on ``dev`` serving ``image`` (a host
    copy of a published image)."""
    from repro_torch.configs.reckon_braille import CONFIG_QUANT
    from repro_torch.serve import BatchedEngine, GuardConfig

    return BatchedEngine(CONFIG_QUANT, {k: v.to(dev) for k, v in image.items()},
                         device=dev, guard=GuardConfig(), **kw)


def _same_answers(what, got, want):
    """Equal request (or session) ids, statuses, preds and logits, bitwise."""
    if len(got) != len(want):
        fail(f"{what}: {len(got)} answers against {len(want)}")
    for g, w in zip(got, want):
        gid = g.rid if hasattr(g, "rid") else g.sid
        wid = w.rid if hasattr(w, "rid") else w.sid
        if (gid, g.status, g.pred) != (wid, w.status, w.pred) or not np.array_equal(
                g.logits, w.logits):
            fail(f"{what}: {gid} {g.status} {g.pred} {g.logits} != "
                 f"{wid} {w.status} {w.pred} {w.logits}")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _flaky_hook(fail_on, kind, seen):
    """A fault_hook failing the scripted launches of one kind; ``seen``
    records each failure with the kernel launch counts at that moment."""
    from repro_torch.kernels import ops

    count = [0]

    def hook(model_id, k):
        if k != kind:
            return
        count[0] += 1
        if count[0] in fail_on:
            seen.append(dict(ops.launches))
            raise RuntimeError(f"injected {k} launch fault #{count[0]}")

    return hook


def _sessions(eng, reqs):
    """One session per request, fed in two halves with a pump after each
    (so every session runs at least two tiles, the second from carries)."""
    from repro_torch.serve import ServeStatus

    hs = [eng.open_session() for _ in reqs]
    for part in (0, 1):
        for h, ev in zip(hs, reqs):
            if h.status is ServeStatus.OK:    # a quarantined stream takes no feed
                h.feed(_halves(ev)[part])
        eng.pump()
    return [h.result() for h in hs]


def phase_learn_while_serve(dev):
    """The paper's second experiment on the port: an END_B OnlineLearner
    publishes every commit into a ModelRegistry while a hardened engine on
    the same registry answers an EventStream's requests between commits
    (interleave_train_serve), through run_tile and through one session per
    request fed in two chunks.  Every answer is held bitwise against an
    engine on the CPU (the plain versions) that gets the same published
    image, copied to the host, at the same points.  Then the hardening on
    the card: a whole-sample and a streaming launch fault recover bitwise
    through one lane restart each (the rebuilt backend on the card, the
    kernel launched after it), one poisoned session is quarantined alone,
    and a scripted overload / deadline run drops the same rids as on the
    CPU."""
    from repro_torch.configs.reckon_braille import CONFIG_QUANT, QUANT_OPT
    from repro_torch.core.controller import ControllerConfig, OnlineLearner
    from repro_torch.data.braille import make_braille_dataset
    from repro_torch.data.pipeline import EventStream, interleave_train_serve, make_pipeline
    from repro_torch.kernels import ops
    from repro_torch.serve import BatchedEngine, GuardConfig, ModelRegistry, ServeStatus

    data = make_braille_dataset("AEU")
    sizes = "/".join(str(data[s]["events"].shape[0]) for s in ("train", "val", "test"))
    reg = ModelRegistry()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    learner = OnlineLearner(CONFIG_QUANT, ControllerConfig(commit="batch"), QUANT_OPT,
                            SEED, registry=reg, model_id="live", device=dev)
    eng = BatchedEngine(registry=reg, device=dev, guard=GuardConfig())
    ref_reg = ModelRegistry()
    ref_reg.register("live", CONFIG_QUANT, _host_image(reg.get("live").weights),
                     device="cpu")
    ref = BatchedEngine(registry=ref_reg, device="cpu", guard=GuardConfig())
    stream = EventStream(data, "test", repeat=LWS_REPEAT, shuffle=True, seed=SEED,
                         guard=GuardConfig(n_in=CONFIG_QUANT.n_in))
    feed = interleave_train_serve(make_pipeline("arm", data, 70, device=dev), stream,
                                  serve_per_batch=LWS_SERVE_PER_BATCH)
    tiles, sess, burst = [[], []], [[], []], []
    plain_s = [0.0]     # host seconds spent on the CPU reference's side

    def both(fn):
        """``fn(engine, side)`` on the card's engine, then (timed apart) on
        the CPU reference."""
        fn(eng, 0)
        t = time.perf_counter()
        fn(ref, 1)
        plain_s[0] += time.perf_counter() - t

    def drain(e, i):
        for tile in e.scheduler.drain():
            tiles[i].extend(e.run_tile(tile))

    def answer_burst():
        """Answer the requests since the last commit on both engines: the
        whole-sample tiles through run_tile, then the sessions."""
        both(drain)
        if burst:
            both(lambda e, i: sess[i].extend(_sessions(e, burst)))
        burst.clear()

    def submit(e, i, item):
        e.submit(item)
        for tile in e.scheduler.ready_tiles():
            tiles[i].extend(e.run_tile(tile))

    for kind, item in feed:
        if kind == "train":
            answer_burst()
            learner.train_batch(item)     # one rsnn_train launch, then publish
            t = time.perf_counter()
            ref_reg.update_weights("live", _host_image(reg.get("live").weights))
            plain_s[0] += time.perf_counter() - t
            continue
        burst.append(item)
        both(lambda e, i: submit(e, i, item))
    answer_burst()
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = {k: ops.launches[k] for k in ("rsnn_train", "rsnn_infer",
                                             "rsnn_step_sessions")}
    if dev.type == "cuda":
        for name, n in launches.items():
            if n <= 0:
                fail(f"(m): kernel {name} was never launched while learning and serving")
    dead = eng.take_dead_results() + ref.take_dead_results()
    answers = tiles[0] + sess[0]
    ok = sum(a.status is ServeStatus.OK for a in answers) / max(len(answers), 1)
    stats = eng.stream_stats(wall)
    if (len(tiles[0]) != len(stream) or len(sess[0]) != len(stream) or dead
            or ok != 1.0 or stats.lane_restarts):
        fail(f"(m): {len(tiles[0])} tile answers and {len(sess[0])} session answers "
             f"for {len(stream)} requests, {len(dead)} dropped, OK share {ok}, "
             f"{stats.lane_restarts} lane restarts, in a run without faults")
    _same_answers("(m) run_tile", tiles[0], tiles[1])
    _same_answers("(m) sessions", sess[0], sess[1])
    for t, s in zip(sorted(tiles[0], key=lambda r: r.rid), sess[0]):
        if not np.array_equal(t.logits, s.logits):
            fail(f"(m): a session fed in halves {s.logits} != run_tile {t.logits}")
    acc = float(np.mean([r.pred == r.label for r in tiles[0]]))
    log(f"(m) ok: learning while serving on Braille AEU ({sizes} samples): "
        f"{learner.commits} END_B commits, {reg.get('live').swaps} publishes, {len(stream)} "
        f"requests ({LWS_SERVE_PER_BATCH} after each commit, the rest after the "
        f"epoch) answered by run_tile and by sessions fed in two chunks, "
        f"{wall:.3f} s wall, of which {plain_s[0]:.3f} s the CPU reference's side "
        f"and {wall - plain_s[0]:.3f} s the learner and engine on {dev}; OK share "
        f"{ok:.1f}; every answer bitwise equal to the plain version with the same "
        f"published image, and sessions equal run_tile; accuracy {acc:.4f}; "
        f"launches {launches}")

    image = _host_image(reg.get("live").weights)
    reqs = [r for r in EventStream(data, "test")]
    phase_faults(dev, image, reqs)
    return launches, wall - plain_s[0], image


def _scripted_overload(image, where, reqs, **kw):
    """(m)'s overload and deadlines on a scripted clock: a bounded queue
    under admission="shed", every third request on a 5 s default deadline,
    the clock 4 s on every 10 requests, full tiles through run_tile every
    30, then serve() with a 1 s deadline."""
    now = [0.0]
    e = _hardened_engine(image, where, max_batch=16, max_pending=24,
                         admission="shed", default_deadline_s=5.0,
                         clock=lambda: now[0], **kw)
    out = []
    for i, ev in enumerate(reqs):
        e.submit(ev, deadline_s=None if i % 3 == 0 else 50.0)
        if i % 10 == 9:
            now[0] += 4.0
        if i % 30 == 29:
            for tile in e.scheduler.ready_tiles():
                out.extend(e.run_tile(tile))
    out.extend(e.take_dead_results())
    for tile in e.scheduler.drain():
        out.extend(e.run_tile(tile))
    res, stats = e.serve(iter(reqs[:20]), deadline_s=1.0)
    return sorted(out, key=lambda r: r.rid) + res, stats


def phase_faults(dev, image, reqs):
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeStatus

    clean, _ = _hardened_engine(image, dev).serve(iter(reqs))
    clean_sess = _sessions(_hardened_engine(image, dev, tick_tile=32), reqs)
    for kind, fail_on in (("tile", {1}), ("stream", {2})):
        seen = []
        eng = _hardened_engine(image, dev, tick_tile=32,
                               fault_hook=_flaky_hook(fail_on, kind, seen))
        old = eng.engine
        if kind == "tile":
            got, _ = eng.serve(iter(reqs))
            want, kernel = clean, "rsnn_step_sessions"
        else:
            got, want, kernel = _sessions(eng, reqs), clean_sess, "rsnn_step_sessions"
        _sync(dev)
        restarts = eng.stream_stats(1.0).lane_restarts
        rebuilt = eng.engine
        if restarts != 1 or len(seen) != 1 or rebuilt is old:
            fail(f"(m) {kind} fault: {restarts} lane restarts, {len(seen)} faults")
        if rebuilt.device != old.device or rebuilt.device.type != dev.type:
            fail(f"(m) {kind} fault: the lane restarted on {rebuilt.device}")
        if dev.type == "cuda" and ops.launches[kernel] <= seen[0][kernel]:
            fail(f"(m) {kind} fault: {kernel} was not launched after the restart")
        if any(a.status is not ServeStatus.OK for a in got):
            fail(f"(m) {kind} fault: not every answer is OK after the restart")
        _same_answers(f"(m) {kind} fault vs an undisturbed run", got, want)
        log(f"(m) ok: injected {kind} launch fault #{min(fail_on)}: one lane restart "
            f"on {rebuilt.device}, {kernel} launched after it "
            f"({seen[0][kernel]} -> {ops.launches[kernel]}), {len(got)} answers "
            f"bitwise equal to an undisturbed run")

    # one poisoned session: NaN planted in its harvested readout
    eng = _hardened_engine(image, dev, tick_tile=32)
    victim = 1
    orig = eng._launch_chunks

    def poisoned(lane, sessions, chunks, num_ticks):
        out = orig(lane, sessions, chunks, num_ticks)
        for i, s in enumerate(sessions):
            if s.sid == victim:
                acc = out["acc_y"].clone()
                acc[i] = float("nan")
                out = dict(out, acc_y=acc)
        return out

    eng._launch_chunks = poisoned
    got = _sessions(eng, reqs)
    bad = [s.sid for s in got if s.status is not ServeStatus.OK]
    if bad != [victim] or got[victim].status is not ServeStatus.FAULT:
        fail(f"(m) poisoned session: sessions {bad} dropped, expected [{victim}]")
    if eng.stream_stats(1.0).quarantined != 1:
        fail("(m) poisoned session: quarantine count is not 1")
    _same_answers("(m) tile-mates of the poisoned session",
                  [s for s in got if s.sid != victim],
                  [s for s in clean_sess if s.sid != victim])
    log(f"(m) ok: a NaN in session {victim}'s harvested readout quarantined it "
        f"alone; its {len(got) - 1} tile-mates bitwise unchanged")

    # overload and deadlines on a scripted clock, card against the CPU
    got, gstats = _scripted_overload(image, dev, reqs)
    want, _ = _scripted_overload(image, torch.device("cpu"), reqs)
    _same_answers("(m) scripted overload and deadlines", got, want)
    by = {s: sum(1 for r in got if r.status is s) for s in ServeStatus}
    if not (by[ServeStatus.REJECTED] and by[ServeStatus.EXPIRED] and by[ServeStatus.OK]):
        fail(f"(m) scripted overload: statuses {by} lack a drop kind")
    log(f"(m) ok: scripted overload (max_pending 24, shed) and deadlines: "
        f"{by[ServeStatus.OK]} OK, {by[ServeStatus.REJECTED]} REJECTED, "
        f"{by[ServeStatus.EXPIRED]} EXPIRED, the same rids and answers as on the CPU")



def _bitwise(what, got, want):
    """Fail unless two weight dicts hold the same keys and bits."""
    if sorted(got) != sorted(want):
        fail(f"{what}: weights {sorted(got)} != {sorted(want)}")
    for k in want:
        if not np.array_equal(got[k], want[k]):
            diff = int(np.sum(got[k] != want[k]))
            fail(f"{what}: {k} differs from the uninterrupted run in {diff} entries")


def _moved(what, got, start):
    """Fail unless every leaf of ``got`` left its initial bits ``start``
    (a commit path that changed nothing would pass every bitwise drill);
    returns the changed entries by leaf."""
    changed = {k: int(np.sum(got[k] != start[k])) for k in sorted(start)}
    if sorted(got) != sorted(start) or not all(changed.values()):
        fail(f"{what}: the run left weights where they started ({changed} entries "
             "changed by leaf)")
    return changed


def phase_fault_tolerance(dev):
    """(n) kill and resume at the Braille shape: an in-process golden run,
    three subprocess drills on the card (SIGKILL at a seeded commit,
    SIGKILL at a checkpoint's rename, SIGTERM), and a Trainer over
    make_eprop_commit_step interrupted and resumed in-process; every run
    ends bitwise on its golden run.  Returns the in-process rsnn_train
    launches and the workers' sum."""
    import shutil
    import signal

    from repro_torch.configs.reckon_braille import QUANT_OPT
    from repro_torch.core.rsnn import init_params, trainable
    from repro_torch.distributed.checkpoint import CheckpointPolicy, ReplayCursor
    from repro_torch.kernels import ops
    from repro_torch.optim.eprop_opt import EpropSGD
    from repro_torch.train import chaos
    from repro_torch.train.eprop_step import epoch_batches, make_eprop_commit_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    root = Path(__file__).resolve().parent / "build" / "fault_tolerance"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    shape = dict(epochs=FT_EPOCHS, spb=FT_SPB, samples_per_class=FT_SAMPLES_PER_CLASS,
                 num_ticks=FT_TICKS)
    wargs = ["--epochs", FT_EPOCHS, "--spb", FT_SPB, "--samples-per-class",
             FT_SAMPLES_PER_CLASS, "--ticks", FT_TICKS, "--device", dev.type]
    learner, pipe = chaos.build_learner(None, device=dev, **shape)
    w_start = {k: v.cpu().numpy() for k, v in learner.weights.items()}   # never fit
    n_train = pipe.dataset["train"]["events"].shape[0]
    commits = FT_EPOCHS * -(-n_train // FT_SPB)
    ops.reset_launch_counts()
    t_start = time.perf_counter()
    t0 = time.perf_counter()
    gold = chaos.golden_run(device=dev, **shape)
    golden_s = time.perf_counter() - t0
    gold_launches = ops.launches["rsnn_train"]
    if dev.type == "cuda" and gold_launches != commits:
        fail(f"(n): the golden run launched rsnn_train {gold_launches} times, "
             f"not once for each of its {commits} commits")
    moved = _moved("(n) golden learner", gold, w_start)
    log(f"(n) golden: {commits} END_B commits over {n_train} training samples, "
        f"{FT_SPB} a batch (T={FT_TICKS}, "
        f"quantized, stochastic commits) in {golden_s:.3f} s, in-process on {dev}; "
        f"weight codes changed from the initial image {moved}")

    kill_at = int(np.random.default_rng(SEED).integers(*FT_KILL_RANGE))
    drills = [(f"SIGKILL at commit {kill_at}", ["--kill-at-commit", kill_at]),
              (f"SIGKILL at step {FT_MID_SAVE_STEP}'s rename",
               ["--kill-mid-save-step", FT_MID_SAVE_STEP]),
              (f"SIGTERM at commit {FT_SIGTERM_AT}", ["--sigterm-at-commit", FT_SIGTERM_AT])]
    worker_launches = 0
    for i, (name, kill) in enumerate(drills):
        ck, out = root / f"ck{i}", root / f"out{i}"
        res = chaos.run_chaos(str(ck), str(out), kill, wargs, timeout=FT_SPAWN_TIMEOUT_S)
        _bitwise(f"(n) {name}", chaos.load_result_weights(str(out)), gold)
        for sp in res["spawns"]:
            st = sp["status"]
            if st is None or st["device"] != dev.type or st["built"]:
                fail(f"(n) {name}: a worker reported {st} (rc {sp['rc']}): each must run "
                     f"on {dev.type} and load the library (a) built")
            if dev.type == "cuda" and st["rsnn_train"] <= 0:
                fail(f"(n) {name}: a worker launched rsnn_train {st['rsnn_train']} times")
            worker_launches += st["rsnn_train"]
        first_rc = res["spawns"][0]["rc"]
        if i < 2 and first_rc != -signal.SIGKILL:
            fail(f"(n) {name}: the doomed worker exited {first_rc}, not by SIGKILL")
        if i == 1 and (list(ck.glob("*.tmp")) or res["resumed_from"] is None
                       or res["resumed_from"] >= FT_MID_SAVE_STEP):
            fail(f"(n) {name}: resumed from {res['resumed_from']}, torn saves "
                 f"{[p.name for p in ck.glob('*.tmp')]}")
        if i == 2 and (first_rc != chaos.STOPPED_RC or res["resumed_from"] != FT_SIGTERM_AT):
            fail(f"(n) {name}: first worker rc {first_rc}, resumed from {res['resumed_from']}")
        if res["resumed_from"] is None or res["commits"] != commits:
            fail(f"(n) {name}: resumed from {res['resumed_from']}, {res['commits']} commits")
        log(f"(n) ok: {name}: {res['restarts']} restart(s), resumed from commit "
            f"{res['resumed_from']}, bitwise equal to the golden run; spawns "
            f"{[round(sp['seconds'], 3) for sp in res['spawns']]} s (rc "
            f"{[sp['rc'] for sp in res['spawns']]}), recovery_s by worker "
            f"{[round(sp['status']['recovery_s'], 3) for sp in res['spawns']]}, the last "
            f"worker's wall_s {res['wall_s']:.3f}; rsnn_train launches by worker "
            f"{[sp['status']['rsnn_train'] for sp in res['spawns']]}")

    # the Trainer over make_eprop_commit_step, round-nearest commits:
    # golden, then stopped by SIGTERM at step FT_TRAINER_STOP and resumed
    opt = EpropSGD(dataclasses.replace(QUANT_OPT, stochastic_round=False))
    w0 = opt.quantize_init(trainable(init_params(torch.Generator().manual_seed(SEED),
                                                 learner.cfg, device=dev)))
    steps = commits

    def trainer(directory, stop_at=None):
        fn = make_eprop_commit_step(learner.cfg, opt, learner.backend)
        calls = [0]

        def step(params, opt_state, batch):
            out = fn(params, opt_state, batch)
            calls[0] += 1
            if calls[0] == stop_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        cur = ReplayCursor()
        return Trainer(step, dict(w0), opt.init(w0), epoch_batches(pipe, cursor=cur),
                       TrainerConfig(total_steps=steps, log_every=1),
                       checkpoint=CheckpointPolicy(directory=directory, every=1, keep=0),
                       cursor=cur)

    gold_tr = trainer(root / "trainer_gold")
    gold_tr.run()
    a = trainer(root / "trainer", stop_at=FT_TRAINER_STOP)
    a.install_signal_handlers()
    try:
        out_a = a.run()
    finally:
        a.restore_signal_handlers()
    b = trainer(root / "trainer")
    if not (out_a["stopped_by_signal"] and b.restore() and b.step == FT_TRAINER_STOP):
        fail(f"(n) Trainer: stopped {out_a}, restored at step {b.step}")
    out_b = b.run()
    host = {k: v.cpu().numpy() for k, v in b.params.items()}
    _bitwise("(n) Trainer resumed after SIGTERM", host,
             {k: v.cpu().numpy() for k, v in gold_tr.params.items()})
    moved = _moved("(n) golden Trainer", {k: v.cpu().numpy() for k, v in gold_tr.params.items()},
                   {k: v.cpu().numpy() for k, v in w0.items()})
    # every step's log entry (the straggler watchdog's extra entries come
    # from the host's wall clock)
    hist = [h.metrics for h in gold_tr.metrics.history if "straggler" not in h.metrics]
    losses = [m["loss"] for m in hist]
    if (out_b["step"] != steps or out_b["rejected_steps"] or len(hist) != steps
            or not np.all(np.isfinite(losses))):
        fail(f"(n) Trainer: {out_b}, {len(hist)} logged steps, losses {losses}")
    log(f"(n) ok: Trainer over make_eprop_commit_step (round-nearest commits): stopped "
        f"by SIGTERM at step {FT_TRAINER_STOP}, resumed from its checkpoint, "
        f"{steps} steps bitwise equal to the uninterrupted run; weight codes changed "
        f"{moved}; loss by step {[round(x, 1) for x in losses]}, accuracy by step "
        f"{[round(m['accuracy'], 3) for m in hist]}")

    # what a checkpoint of the learner costs on the commit path
    timed, _ = chaos.build_learner(str(root / "timed"), device=dev, **shape)
    _sync(dev)
    t0 = time.perf_counter()
    timed.save_checkpoint(blocking=True)
    blocking_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    timed.save_checkpoint(blocking=False)
    enqueue_s = time.perf_counter() - t0
    timed.ckpt.wait()
    launches = ops.launches["rsnn_train"]
    log(f"(n) ok: a blocking save of the learner's state {blocking_s:.5f} s, "
        f"save_async's enqueue {enqueue_s:.5f} s; rsnn_train launches in-process "
        f"{launches}, in the workers {worker_launches}; (n) took "
        f"{time.perf_counter() - t_start:.1f} s")
    return launches, worker_launches

# ---------------------------------------------------------------------------
# (o) data-parallel END_B learning and serving, the integer commit grid
# ---------------------------------------------------------------------------


def _kernel_ms(fn, prefix, iters=20):
    """Median device time of the kernel whose name starts with ``prefix``
    over ``iters`` calls of ``fn``, from torch.profiler; None when the trace
    holds no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and e.name.startswith(prefix)]
    return float(np.median(us)) / 1e3 if us else None


def _leaves(result):
    """The tensors of an op's result (a dict, or a tuple of dicts)."""
    dicts = result if isinstance(result, tuple) else (result,)
    return [t for d in dicts for t in d.values()]


def _codes_flat(out):
    return torch.cat([c.reshape(-1) for c in out[:3]])


def _shard_codes(E, args, kw, grid, shards):
    """The int32 sum of the codes of ``shards`` launches over a padded
    split of the batch (zero rows: zero raster, y* and valid)."""
    raster, y_star, valid, *w = args
    B = raster.shape[1]
    per = -(-B // shards)
    pad = per * shards - B
    raster = torch.cat([raster, raster.new_zeros((raster.shape[0], pad, raster.shape[2]))], 1)
    y_star = torch.cat([y_star, y_star.new_zeros((pad, y_star.shape[1]))], 0)
    valid = torch.cat([valid, valid.new_zeros((valid.shape[0], pad))], 1)
    total = None
    for i in range(shards):
        sl = slice(i * per, (i + 1) * per)
        c = _codes_flat(E.rsnn_train_cuda(
            raster[:, sl].contiguous(), y_star[sl].contiguous(), valid[:, sl].contiguous(),
            *w, **kw, commit_grid=grid))
        total = c if total is None else total + c
    return total


def phase_data_parallel(dev):
    """(o) the data-parallel slice: rsnn_train's codes reduction against
    its plain version and the partition invariance of the codes, the
    sharded backend methods on a one-rank NCCL world against the unsharded
    backend, and the deterministic chaos drill on the card.  Returns the
    launches of the sharded methods by kernel and the commit grid's
    numbers for the kernels line."""
    import shutil
    import signal
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs.reckon_braille import CONFIG_QUANT, QUANT_OPT
    from repro_torch.core.backend import ExecutionBackend, RuntimeConfig
    from repro_torch.core.controller import batch_commit_update
    from repro_torch.core.quant import DW_COMMIT_SPEC as GRID
    from repro_torch.core.rsnn import Presets, init_params, trainable
    from repro_torch.kernels import eprop_update as E
    from repro_torch.kernels import ops
    from repro_torch.kernels import rsnn_step as K
    from repro_torch.launch import mesh as meshlib
    from repro_torch.optim.eprop_opt import EpropSGD
    from repro_torch.train import chaos

    t_start = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 5)
    T = 128
    braille_q = Presets.braille(num_ticks=T, quantized=True)
    braille_f = Presets.braille(num_ticks=T, quantized=False)
    chipmax_q = Presets.braille(num_ticks=T, quantized=True, n_in=256, n_hid=256, n_out=16)
    chipmax_q = dataclasses.replace(
        chipmax_q, neuron=dataclasses.replace(chipmax_q.neuron, reset="sub"))
    chipmax_f = dataclasses.replace(chipmax_q, neuron=dataclasses.replace(
        chipmax_q.neuron, quant=None))
    cases = [("braille quant END_B tile", braille_q, 70), ("braille quant B=1", braille_q, 1),
             ("braille quant ragged", braille_q, 11), ("braille float END_B tile", braille_f, 70),
             ("braille float B=1", braille_f, 1), ("braille float ragged", braille_f, 11),
             ("chip-max quant (device scratch)", chipmax_q, 8),
             ("chip-max float (device scratch)", chipmax_f, 8)]
    for name, cfg, B in cases:
        be = ExecutionBackend(cfg, device=dev)
        params = init_params(gen, cfg, device=dev)
        params = {k: (torch.round(v * 16) / 16).clamp(-8, 127 / 16)
                  if k in ("w_in", "w_rec", "w_out") else v for k, v in params.items()}
        args = (*_train_inputs(gen, T, B, cfg, 0.12 if cfg.n_in == 12 else 0.05, dev),
                *be.datapath_weights(params), be._feedback(params))
        kw = dict(alpha=be.alpha, kappa=cfg.neuron.kappa, v_th=cfg.neuron.v_th,
                  reset=cfg.neuron.reset, boxcar_width=cfg.neuron.boxcar_width,
                  quant=be.quant, error=cfg.eprop.error, infer_window=cfg.eprop.infer_window)
        got = E.rsnn_train_cuda(*args, **kw, commit_grid=GRID, return_partials=True)
        flt = E.rsnn_train_cuda(*args, **kw, return_partials=True)
        torch.cuda.synchronize()
        codes, part = _codes_flat(got), got[5]
        if codes.dtype != torch.int32 or not torch.equal(
                codes, E.dw_codes_reduce_plain(part, GRID)):
            fail(f"(o) {name}: rsnn_dw_codes_reduce_kernel differs from its plain version "
                 "over the same per-row partials")
        if not torch.equal(part, flt[5]) or not all(torch.equal(a, b) for a, b in
                                                     zip(got[3:5], flt[3:5])):
            fail(f"(o) {name}: the grid launch's partials, acc_y or n_spk differ from the "
                 "float launch's")
        # end to end against the plain B=1 loop: the float dw tolerance,
        # plus one lsb a row for a code that rounds the other way
        plain = E.rsnn_train_plain(*args, **kw, commit_grid=GRID)
        torch.cuda.synchronize()
        worst_codes = 0
        for g_, p_, f_ in zip(got[:3], plain[:3], flt[:3]):
            err = _err(g_.double() * GRID.lsb, p_.double() * GRID.lsb)
            lim = TRAIN_DW_TOL * float(f_.abs().max()) + B * GRID.lsb
            if err > lim:
                fail(f"(o) {name}: grid commit off the plain B=1 loop by {err} (> {lim})")
            worst_codes = max(worst_codes, int((g_ - p_).abs().max()))
        _compare(f"(o) {name} acc_y/n_spk", got[3:5], plain[3:5], cfg.neuron.quant is not None,
                 [])
        # partition invariance: one launch == 8-way and 4-way padded shards
        # == one launch a row
        one_a_row = _shard_codes(E, args, kw, GRID, B)
        for shards in (8, 4):
            if not torch.equal(_shard_codes(E, args, kw, GRID, shards), codes):
                fail(f"(o) {name}: the codes of {shards} shard launches differ from one launch")
        if not torch.equal(one_a_row, codes):
            fail(f"(o) {name}: the codes of {B} one-row launches differ from one launch")
        log(f"(o) ok: {name} (T={T}, B={B}, {cfg.n_in}/{cfg.n_hid}/{cfg.n_out}): codes == "
            f"plain reduce of the partials bitwise; vs the plain B=1 loop max |Δcode| "
            f"{worst_codes}; one launch == 8 and 4 padded shards == {B} one-row launches, "
            f"bitwise; max |code| {int(codes.abs().max())}")

    # the sharded methods themselves on a one-rank NCCL world, against the
    # unsharded backend, bitwise
    rdv = Path(tempfile.mkdtemp(prefix="world-", dir=Path(__file__).resolve().parent / "build"))
    meshlib.join_world(0, 1, f"file://{rdv / 'rendezvous'}", device="cuda")
    if dist.get_backend() != "nccl":
        fail(f"(o): the one-rank world runs {dist.get_backend()}, not nccl")
    mesh = meshlib.make_data_mesh(device="cuda")
    cfg = dataclasses.replace(CONFIG_QUANT, num_ticks=T)
    params = init_params(torch.Generator().manual_seed(SEED), cfg, device=dev)
    one = ExecutionBackend(cfg, device=dev)
    one_grid = ExecutionBackend(cfg, device=dev, runtime=RuntimeConfig(commit_grid=GRID))
    sh = ExecutionBackend(cfg, device=dev, runtime=RuntimeConfig(mesh=mesh))
    sh_grid = ExecutionBackend(cfg, device=dev, runtime=RuntimeConfig(mesh=mesh, commit_grid=GRID))
    if sh.num_devices != 1 or sh._group is None:
        fail(f"(o): a one-rank mesh gave num_devices {sh.num_devices}, group {sh._group}")
    raster, y_star, valid = _train_inputs(gen, T, 70, cfg, 0.12, dev)
    s_raster, s_valid, s_live = _inputs(gen, 256, 512, cfg.n_in, 0.12, dev)
    carries = [c for c in one.init_session_state(512).values()]
    # each op's sharded launch (pad, slice, collectives) against its
    # unsharded one; training on the float sum and on the commit grid
    calls = [("_train", sh, one, (raster, y_star, valid)),
             ("_train (commit grid)", sh_grid, one_grid, (raster, y_star, valid)),
             ("_inference", sh, one, (s_raster, s_valid)),
             ("_step_sessions", sh, one, (s_raster, s_live, s_valid, carries))]
    ops.reset_launch_counts()
    results = [getattr(b, m.split()[0])(params, *a, sharded=True) for m, b, _, a in calls]
    torch.cuda.synchronize()
    dp_launches = {k: ops.launches[k] for k in ("rsnn_train", "rsnn_infer",
                                                "rsnn_step_sessions")}
    dp_grid = ops.grid_launches["rsnn_train"]
    for (m, _, ref_be, a), got in zip(calls, results):
        want = getattr(ref_be, m.split()[0])(params, *a, sharded=False)
        if not all(torch.equal(x, y) for x, y in zip(_leaves(got), _leaves(want))):
            fail(f"(o) {m} sharded on a one-rank NCCL world differs from the unsharded launch")
    if min(dp_launches.values()) <= 0 or dp_launches["rsnn_train"] != 2 or dp_grid != 1:
        fail(f"(o): the sharded methods launched {dp_launches}, {dp_grid} on the grid")
    log(f"(o) ok: _train (float and commit grid), _inference and _step_sessions sharded on "
        f"a one-rank nccl world (T={T} B=70 training, T=256 B=512 serving) bitwise equal "
        f"to their unsharded launches; launches {dp_launches}, {dp_grid} on the grid")

    # times: the codes reduce beside the float reduce, one END_B commit with
    # and without the grid, the NCCL all_reduce of the three dw
    w = one.datapath_weights(params)
    targs = (raster, y_star, valid, *w, one._feedback(params))
    tkw = dict(alpha=one.alpha, kappa=cfg.neuron.kappa, v_th=cfg.neuron.v_th,
               reset=cfg.neuron.reset, boxcar_width=cfg.neuron.boxcar_width,
               quant=one.quant, error=cfg.eprop.error, infer_window=cfg.eprop.infer_window)
    E_ = K.weight_elems(cfg.n_in, cfg.n_hid, cfg.n_out)
    red = {"codes": [], "float": []}
    for _ in range(2):
        red["codes"].append(_kernel_ms(lambda: E.rsnn_train_cuda(
            *targs, **tkw, commit_grid=GRID), "rsnn_dw_codes_reduce_kernel"))
        red["float"].append(_kernel_ms(lambda: E.rsnn_train_cuda(*targs, **tkw),
                                       "rsnn_dw_reduce_kernel"))
    codes_ms = None if None in red["codes"] else min(red["codes"])
    float_ms = None if None in red["float"] else min(red["float"])
    part = E.rsnn_train_cuda(*targs, **tkw, return_partials=True)[5]
    plain_ms = _time(lambda: E.dw_codes_reduce_plain(part, GRID))
    red_bytes = 70 * E_ * 4 + E_ * 4
    bound_ms = red_bytes / HBM_BYTES_PER_S * 1e3
    opt = EpropSGD(QUANT_OPT)
    batch = {"raster": raster.transpose(0, 1).contiguous(), "valid": valid.transpose(0, 1)
             .contiguous(), "label": y_star.argmax(dim=1)}
    walls = {}
    w0 = opt.quantize_init(trainable(params))
    for tag, be in (("float", one), ("grid", one_grid), ("float", one), ("grid", one_grid)):
        st = opt.init(w0)
        cgen = torch.Generator(device=dev).manual_seed(SEED)
        batch_commit_update(cfg, opt, be, w0, st, batch, cgen)
        torch.cuda.synchronize()
        ts = []
        for _ in range(20):
            t0 = time.perf_counter()
            batch_commit_update(cfg, opt, be, w0, st, batch, cgen)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        walls.setdefault(tag, []).append(float(np.median(ts)))
    dw_flat = torch.zeros(E_, dtype=torch.float32, device=dev)
    group = mesh.get_group("data")
    ar_call_ms = _time(lambda: dist.all_reduce(dw_flat, group=group), iters=100)
    ar_dev_ms = _device_ms(lambda: dist.all_reduce(dw_flat, group=group))
    meshlib.leave_world()
    shutil.rmtree(rdv, ignore_errors=True)
    log(f"(o) rsnn_dw_codes_reduce_kernel {red['codes']} ms (profiler median, two "
        f"readings) beside rsnn_dw_reduce_kernel {red['float']} ms at T={T} B=70 "
        f"{cfg.n_in}/{cfg.n_hid}/{cfg.n_out} (E={E_}); plain {plain_ms:.4f} ms; bound "
        f"{bound_ms:.6f} ms ({red_bytes} bytes); one END_B commit's wall (median of 20, "
        f"host clock) float {walls['float']} ms, grid {walls['grid']} ms; NCCL all_reduce "
        f"of the three dw ({E_ * 4} bytes, one rank) {ar_call_ms:.4f} ms a call (CUDA "
        f"events), {ar_dev_ms} ms on the card (profiler)")

    # the deterministic chaos drill on the card, one process
    root = Path(__file__).resolve().parent / "build" / "data_parallel"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    shape = dict(epochs=FT_EPOCHS, spb=FT_SPB, samples_per_class=FT_SAMPLES_PER_CLASS,
                 num_ticks=FT_TICKS)
    wargs = ["--epochs", FT_EPOCHS, "--spb", FT_SPB, "--samples-per-class",
             FT_SAMPLES_PER_CLASS, "--ticks", FT_TICKS, "--device", dev.type,
             "--deterministic"]
    start, _ = chaos.build_learner(None, device=dev, deterministic=True, **shape)
    w_start = {k: v.cpu().numpy() for k, v in start.weights.items()}
    ops.reset_launch_counts()
    gold = chaos.golden_run(device=dev, deterministic=True, **shape)
    gold_grid = (ops.launches["rsnn_train"], ops.grid_launches["rsnn_train"])
    if gold_grid[0] <= 0 or gold_grid[1] != gold_grid[0]:
        fail(f"(o) deterministic golden learner: {gold_grid[1]} of its {gold_grid[0]} "
             "rsnn_train launches reduced onto the commit grid")
    moved = _moved("(o) deterministic golden learner", gold, w_start)
    kill_at = int(np.random.default_rng(SEED + 1).integers(*FT_KILL_RANGE))
    res = chaos.run_chaos(str(root / "ck"), str(root / "out"), ["--kill-at-commit", kill_at],
                          wargs, mesh_devices=1, timeout=FT_SPAWN_TIMEOUT_S)
    _bitwise(f"(o) deterministic drill, SIGKILL at commit {kill_at}",
             chaos.load_result_weights(str(root / "out")), gold)
    first = res["spawns"][0]
    if first["rc"] != -signal.SIGKILL or res["resumed_from"] is None:
        fail(f"(o) deterministic drill: first worker rc {first['rc']}, resumed from "
             f"{res['resumed_from']}")
    worker_launches = 0
    for sp in res["spawns"]:
        st = sp["status"]
        if (st is None or st["device"] != "cuda" or st["rsnn_train"] <= 0
                or st["commit_grid"] is not True or st["rsnn_train_grid"] != st["rsnn_train"]):
            fail(f"(o) deterministic drill: a worker reported {st} (every rsnn_train launch "
                 "must reduce onto the commit grid)")
        worker_launches += st["rsnn_train"]
    log(f"(o) ok: deterministic drill on the card (--deterministic --mesh-devices 1, "
        f"SIGKILL at commit {kill_at}): resumed from commit {res['resumed_from']}, bitwise "
        f"equal to the golden run (weight codes changed {moved}); every rsnn_train launch "
        f"of the golden run ({gold_grid[0]}) and of each worker reduced onto the commit "
        f"grid; spawns "
        f"{[round(sp['seconds'], 3) for sp in res['spawns']]} s; (o) took "
        f"{time.perf_counter() - t_start:.1f} s")
    grid_row = {"codes_reduce_ms": codes_ms, "float_reduce_ms": float_ms,
                "codes_reduce_plain_ms": plain_ms, "codes_reduce_bound_ms": bound_ms,
                "codes_reduce_bound_by": "bytes",
                "commit_wall_ms": {k: min(v) for k, v in walls.items()},
                "nccl_all_reduce_call_ms": ar_call_ms, "nccl_all_reduce_device_ms": ar_dev_ms,
                "shape": f"T={T} B=70 {cfg.n_in}/{cfg.n_hid}/{cfg.n_out}",
                "drill_worker_launches": worker_launches}
    return dp_launches, grid_row


# ---------------------------------------------------------------------------
# (ah) the engine over a data mesh, (ai) the example counterparts
# ---------------------------------------------------------------------------

MESH_STREAM_KEYS = ("tiles", "events", "ticks", "evictions", "readmissions", "expired",
                    "quarantined", "lane_restarts", "rejected", "shed")


def _stream_counters(eng):
    st = eng.stream_stats(1.0)
    return {k: getattr(st, k) for k in MESH_STREAM_KEYS}


def _mesh_runs(image, dev, reqs, **kw):
    """(ah)'s runs of one engine setting (``kw`` carries the mesh's runtime,
    or nothing): {run: (answers, counters)}."""
    from repro_torch.serve import ServeStatus

    out = {}
    res, stats = _hardened_engine(image, dev, **kw).serve(iter(reqs))
    out["serve"] = (res, {"batches": stats.batches, "lane_restarts": stats.lane_restarts})
    eng = _hardened_engine(image, dev, tick_tile=32, **kw)
    out["sessions"] = (_sessions(eng, reqs), _stream_counters(eng))
    for kind, fail_on in (("tile", {1}), ("stream", {2})):
        seen = []
        eng = _hardened_engine(image, dev, tick_tile=32,
                               fault_hook=_flaky_hook(fail_on, kind, seen), **kw)
        got = eng.serve(iter(reqs))[0] if kind == "tile" else _sessions(eng, reqs)
        out[f"{kind} fault"] = (got, {**_stream_counters(eng), "faults": len(seen)})
    res, _ = _scripted_overload(image, dev, reqs, **kw)
    out["overload and deadlines"] = (res, {s.value: sum(r.status is s for r in res)
                                           for s in ServeStatus})
    # session deadlines: every third session on a 5 s deadline, the clock
    # at 10 s before the second halves are fed
    now = [0.0]
    eng = _hardened_engine(image, dev, tick_tile=32, clock=lambda: now[0], **kw)
    hs = [eng.open_session(deadline_s=5.0 if i % 3 == 0 else None) for i in range(len(reqs))]
    for h, ev in zip(hs, reqs):
        h.feed(_halves(ev)[0])
    eng.pump()
    now[0] = 10.0
    for h, ev in zip(hs, reqs):
        if h.status is ServeStatus.OK:
            h.feed(_halves(ev)[1])
    eng.pump(drain=True)
    out["session deadlines"] = ([h.result() for h in hs], _stream_counters(eng))
    # the idle sweep: every session runs its first half at t=0, the even
    # ones their second at t=5; at t=10 the odd ones (idle 10 s > 8 s) are
    # offloaded, then fed and readmitted
    now = [0.0]
    eng = _hardened_engine(image, dev, tick_tile=32, clock=lambda: now[0],
                           idle_timeout=8.0, **kw)
    hs = [eng.open_session() for _ in reqs]
    for h, ev in zip(hs, reqs):
        h.feed(_halves(ev)[0])
    eng.pump()
    now[0] = 5.0
    for h, ev in zip(hs[::2], reqs[::2]):
        h.feed(_halves(ev)[1])
    eng.pump()
    now[0] = 10.0
    eng.pump()
    for h, ev in zip(hs[1::2], reqs[1::2]):
        h.feed(_halves(ev)[1])
    eng.pump(drain=True)
    out["idle sweep"] = ([h.result() for h in hs], _stream_counters(eng))
    return out


def phase_engine_over_mesh(dev, image):
    """(ah) the hardened engine over a one-rank data mesh (its decisions and
    launch outcomes through the mesh's control group) against the engine
    without a mesh on the same device: every answer and counter bitwise.
    Returns the mesh engines' serving launches and the exchange's numbers
    for the kernels line."""
    from repro_torch.configs.reckon_braille import CONFIG_QUANT
    from repro_torch.core.backend import ExecutionBackend, RuntimeConfig
    from repro_torch.data.braille import make_braille_dataset
    from repro_torch.data.pipeline import EventStream
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as meshlib

    t_start = time.perf_counter()
    reqs = list(EventStream(make_braille_dataset("AEU"), "test"))
    want = _mesh_runs(image, dev, reqs)
    rdv = _world_on_card(dev)
    try:
        rt = RuntimeConfig(mesh=meshlib.make_data_mesh(device=dev.type))
        ctl = ExecutionBackend(CONFIG_QUANT, device=dev, runtime=rt).control
        if ctl is None or ctl.ranks != [0]:
            fail(f"(ah): a one-rank mesh's backend has control group {ctl}")
        ops.reset_launch_counts()
        got = _mesh_runs(image, dev, reqs, runtime=rt)
        _sync(dev)
        launches = {k: ops.launches[k] for k in ("rsnn_infer", "rsnn_step_sessions")}
        exchanges = ctl.exchanges
        # one exchange's host time: the launch outcome (codes only), and a
        # decision of 16 ids (all_reduce, then a broadcast)
        times = {}
        for tag, fn in (("settle", ctl.settle), ("decide 16 ids",
                                                  lambda: ctl.decide(range(16), range(16)))):
            for _ in range(50):
                fn()
            t0 = time.perf_counter()
            for _ in range(2000):
                fn()
            times[tag] = (time.perf_counter() - t0) / 2000 * 1e6
    finally:
        _leave_world(rdv)
    for name, (w_ans, w_cnt) in want.items():
        g_ans, g_cnt = got[name]
        _same_answers(f"(ah) {name} over the mesh vs without", g_ans, w_ans)
        if g_cnt != w_cnt:
            fail(f"(ah) {name}: counters over the mesh {g_cnt} != without {w_cnt}")
    odd = len(reqs[1::2])
    checks = {"tile fault restarts": got["tile fault"][1]["lane_restarts"] == 1,
              "stream fault restarts": got["stream fault"][1]["lane_restarts"] == 1,
              "session deadlines": got["session deadlines"][1]["expired"]
              == len(reqs[::3]),
              "idle evictions": got["idle sweep"][1]["evictions"] == odd,
              "idle readmissions": got["idle sweep"][1]["readmissions"] == odd,
              "overload drops": all(got["overload and deadlines"][1][k] > 0
                                    for k in ("ok", "expired", "rejected"))}
    if not all(checks.values()):
        fail(f"(ah): {checks}")
    if dev.type == "cuda" and min(launches.values()) <= 0:
        fail(f"(ah): the engines over the mesh launched {launches}")
    n_launch = sum(launches.values())
    log(f"(ah) ok: the hardened engine over a one-rank {dev.type} data mesh bitwise the "
        f"engine without a mesh on {dev} ({len(reqs)} AEU test requests): "
        f"{', '.join(want)}; {checks}; launches {launches}; {exchanges} control "
        f"exchanges ({exchanges / max(n_launch, 1):.2f} a launch); one exchange "
        + ", ".join(f"{k} {v:.2f} us" for k, v in times.items())
        + f" (host clock, a one-rank gloo group); (ah) took "
        f"{time.perf_counter() - t_start:.1f} s")
    return launches, {"exchanges": exchanges, "exchange_us": times}


def phase_examples():
    """(ai) each example counterpart in a subprocess on the card at small
    flags, all started together; fails on a nonzero exit or a story that
    does not reach its last line."""
    import tempfile

    root = Path(__file__).resolve().parent
    src, examples = str(root / "src"), str(root / "examples")
    ckpt = tempfile.mkdtemp(prefix="ft-ckpt-", dir=root / "build")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    t0 = time.perf_counter()
    procs = {}
    for name, (how, _) in EXAMPLE_RUNS.items():
        if isinstance(how, list):
            cmd = [sys.executable, str(root / "examples" / f"{name}.py"), "--device", "cuda",
                   *how]
        else:
            cmd = [sys.executable, "-c", f"import sys; sys.path[:0] = [{src!r}, {examples!r}]; "
                   f"import {name}; {name}.{how.format(ckpt=ckpt)}"]
        procs[name] = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    bad, walls = [], {}
    for name, p in procs.items():
        try:
            text, _ = p.communicate(
                timeout=max(1.0, EXAMPLE_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
        walls[name] = round(time.perf_counter() - t0, 1)
        last = EXAMPLE_RUNS[name][1]
        lines = [ln for ln in text.splitlines() if ln.strip()]
        if p.returncode != 0 or last not in text:
            bad.append(name)
            log(f"(ai) {name} exited {p.returncode}:\n" + "\n".join(lines[-25:]))
        else:
            log(f"(ai) {name}: " + next(ln for ln in lines if last in ln))
    shutil.rmtree(ckpt, ignore_errors=True)
    if bad:
        fail(f"(ai): examples {bad} failed on the card")
    log(f"(ai) ok: {len(procs)} example counterparts ran on the card, all started "
        f"together; done after {walls} s")


def start_dryruns(root: Path):
    """(aj)'s and (ak)'s dry-run processes, started at once (they use the
    CPU, and the card only for the device queries of its fake tensors):
    the one-rank qwen3 cell, the two llama3-8b production cells, one
    process a cell, and deepseek's grouped train cell.  Returns ``[(name,
    Popen, log path)]``."""
    out = root / DRYRUN_DIR
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    procs = []
    for name, args in (("one_rank", DRYRUN_ONE_RANK), ("production", DRYRUN_PRODUCTION),
                       ("grouped", DRYRUN_GROUPED)):
        path = out / f"{name}.log"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out-dir", str(out)]
        procs.append((name, subprocess.Popen(cmd, cwd=str(root), env=env,
                                             stdout=open(path, "w"),
                                             stderr=subprocess.STDOUT), path))
    return procs


def _dryrun_record(root: Path, name: str) -> dict:
    path = root / DRYRUN_DIR / f"{name}.json"
    if not path.exists():
        fail(f"(aj) no dry-run record {path.name}")
    rec = json.loads(path.read_text())
    if "error" in rec:
        fail(f"(aj) dry-run cell {name} failed: {rec['error']}\n{rec.get('traceback', '')[-3000:]}")
    return rec


def _wait_dryruns(procs, phase: str) -> None:
    """Wait for dry-run processes (each within DRYRUN_TIMEOUT_S of the
    call); any that fails or outlasts it fails ``phase``."""
    t0 = time.perf_counter()
    for name, proc, path in procs:
        try:
            rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            fail(f"{phase} the dry-run process {name} did not end in {DRYRUN_TIMEOUT_S} s")
        if rc != 0:
            fail(f"{phase} the dry-run process {name} exited {rc}:\n"
                 + path.read_text()[-4000:])


def phase_dryrun(dev, root: Path, procs):
    """(aj): wait for the dry-run processes, then run the one-rank cell's
    step for real on the card and hold it to the fake run's counts."""
    import math

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models.model import build

    t0 = time.perf_counter()
    _wait_dryruns([p for p in procs if p[0] != "grouped"], "(aj)")
    fake = _dryrun_record(root, "qwen3-1.7b__train_4k__1x1__aj")
    prod = {sh: _dryrun_record(root, f"llama3-8b__{sh}__16x16__aj")
            for sh in ("train_4k", "decode_32k")}
    for sh, rec in prod.items():
        m, c = rec["memory"], rec["collectives"]
        log(f"(aj) dry run llama3-8b {sh} on the 16x16 mesh (256 fake cuda ranks; counts on "
            f"one rank, not measurements): {rec['wall_s']} s wall, argument "
            f"{m['argument_bytes'] / 2**30:.2f} GiB + temp {m['temp_bytes'] / 2**30:.2f} GiB "
            f"a rank, {rec['cost']['flops']:.4g} flops a rank, wire bytes by op "
            f"{ {k: round(v) for k, v in c['bytes_by_op'].items()} }, counts "
            f"{c['count_by_op']}")

    # the same step for real on the card, over a one-rank NCCL world
    opts = dryrun.parser().parse_args(DRYRUN_ONE_RANK)
    shape = dryrun.cell_shape("train_4k", opts)
    cfg = dryrun.tune_cfg(get_config("qwen3-1.7b"), shape, opts)
    rdv = _world_on_card(dev)
    try:
        mesh = meshlib.make_debug_mesh(1, 1)
        rules = dryrun.make_rules(shape, mesh, opts)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        gen = torch.Generator(device=dev).manual_seed(SEED + 29)
        toks = torch.randint(0, cfg.vocab, (shape.global_batch, shape.seq_len + 1),
                             generator=gen, device=dev, dtype=torch.int32)
        inputs = {"tokens": toks[:, :-1].contiguous(), "targets": toks[:, 1:].contiguous()}
        del toks
        step, args, _ = dryrun.cell_step(cfg, shape, mesh, rules, opts, device=dev,
                                         params=build(cfg).init(SEED + 29, device=dev),
                                         inputs=inputs)
        del inputs
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        with FlopCounterMode(display=False) as fc:
            out = step(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = dict(ops.launches)
        measured = torch.cuda.max_memory_allocated() - base
        real_flops = int(fc.get_total_flops())
        loss = float(out[2]["loss"])
        del out, args, step
    finally:
        _leave_world(rdv)
    torch.cuda.empty_cache()
    fm = fake["memory"]
    predicted = fm["argument_bytes"] + fm["temp_bytes"]
    fake_flops = int(fake["cost"]["flops"])
    card = card_line()
    log(f"(aj) qwen3-1.7b train step B={shape.global_batch} x S={shape.seq_len} on one rank "
        f"[{card}]: flops fake {fake_flops} vs real {real_flops} (FlopCounterMode); peak "
        f"predicted {predicted / 2**30:.3f} GiB (argument {fm['argument_bytes'] / 2**30:.3f} "
        f"+ temp {fm['temp_bytes'] / 2**30:.3f}) vs measured {measured / 2**30:.3f} GiB "
        f"(arguments resident {resident / 2**30:.3f}), {(predicted - measured) / measured:+.4f}"
        f"; real step {wall:.2f} s, loss {loss:.4f}, launches {launches}; the dry run's "
        f"wall {fake['wall_s']} s")
    if not math.isfinite(loss):
        fail(f"(aj) the real step's loss is {loss}")
    if fake_flops != real_flops:
        fail(f"(aj) the fake run's flops {fake_flops} != the real step's {real_flops}")
    if abs(predicted - measured) > DRYRUN_PEAK_TOL * measured:
        fail(f"(aj) predicted peak {predicted} B is not within {DRYRUN_PEAK_TOL} of the "
             f"measured {measured} B")
    if launches["flash_attention"] <= 0 or launches["flash_attention_bwd"] <= 0:
        fail(f"(aj) the real step launched {launches}")
    log(f"(aj) ok in {time.perf_counter() - t0:.1f} s after (ai)")
    return launches, {"flops": fake_flops, "predicted_peak_bytes": predicted,
                      "measured_peak_bytes": measured, "card": card,
                      "production_wall_s": {sh: r["wall_s"] for sh, r in prod.items()}}


@contextlib.contextmanager
def _counting(module, name: str):
    """Count the calls of ``module.name`` inside (a list, one entry a call)."""
    real, calls = getattr(module, name), []

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def phase_mesh_local(dev, root: Path, procs):
    """(ak): on a one-rank NCCL world, deepseek-v2-lite-16b at (u)'s depth
    with its dispatch in MESH_LOCAL_GROUPS groups: MESH_LOCAL_STEPS steps of
    the sharded step over a (data, model) = 1 x 1 mesh against the same
    steps unsharded, and a prefill under use_mesh against the unsharded
    prefill; llama3-8b at MESH_LOCAL_DECODE_LAYERS layers decoded over a
    cache whose slots split over model (kv_shard="seq": each rank attends
    to its own slots and the partials merge by their log-sum-exp) against
    the unsharded decode; then the dry run of deepseek's train_4k on the
    16 x 16 mesh with 16 dispatch groups."""
    import math

    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import train as launch_train
    from torch.distributed.tensor import Shard

    from repro_torch.models import attention, moe
    from repro_torch.models.model import build
    from repro_torch.models.transformer import tree_leaves

    t_phase = time.perf_counter()
    cfg = get_config(MOE_ARCH).replace(n_layers=MOE_TRAIN_LAYERS)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_groups=MESH_LOCAL_GROUPS))
    B, S, n = TRAIN_BATCH, TRAIN_SEQ, MESH_LOCAL_STEPS
    n_moe = _plan_count(build(cfg).plan, lambda k: k[1] == "moe")
    n_attn = _plan_count(build(cfg).plan, lambda k: k[0] == "attn")
    rdv = _world_on_card(dev)
    mesh = meshlib.make_debug_mesh(1, 1)

    # the train step, unsharded and over the mesh, from the same weights and batches
    run = launch_train.build_run(cfg, steps=n, batch=B, seq=S, lr=TRAIN_LR, device=dev)
    srun = launch_train.build_run(cfg, steps=n, batch=B, seq=S, lr=TRAIN_LR, device=dev,
                                  mesh=mesh)
    batches = [next(run.stream) for _ in range(n)]
    params, state = run.init_state()
    plain_losses = []
    for b in batches:
        params, state, metrics = run.step_fn(params, state, b)
        plain_losses.append(float(metrics["loss"]))
    want = _host_leaves(params)
    del params, state, metrics
    torch.cuda.empty_cache()
    params, state = srun.init_state()
    losses, walls = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _counting(moe, "_moe_on_mesh") as on_mesh_calls:
        ops.reset_launch_counts()
        for b in batches:
            t0 = time.perf_counter()
            params, state, metrics = srun.step_fn(params, state, b)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        train_launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    same, worst = _host_compare(_host_leaves(params), want)
    del params, state, metrics, want, run, srun
    torch.cuda.empty_cache()
    if len(on_mesh_calls) < n * n_moe:
        fail(f"(ak) the mesh's MoE path ran {len(on_mesh_calls)} times in {n} steps of "
             f"{n_moe} MoE layers")
    want_l = {"flash_attention": 2 * n * cfg.n_layers, "flash_attention_bwd": n * cfg.n_layers}
    if {k: train_launches[k] for k in want_l} != want_l:
        fail(f"(ak) the sharded steps launched {train_launches}, expected {want_l}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"(ak) a loss is not finite: {losses}")
    loss_gap = max(abs(a - b) for a, b in zip(losses, plain_losses))
    if not same or losses != plain_losses:
        log(f"(ak) the grouped sharded steps are not bitwise the unsharded ones: losses "
            f"{losses} against {plain_losses}, parameters up to {worst:.4g} of a leaf's max")
        if worst > LM_GRAD_TOL or loss_gap > SHARDED_LOSS_TOL:
            fail(f"(ak) sharded against unsharded: parameters {worst} of a leaf's max (tol "
                 f"{LM_GRAD_TOL}), losses {loss_gap} apart (tol {SHARDED_LOSS_TOL})")
    log(f"(ak) ok: {n} sharded steps of {cfg.name} at {cfg.n_layers} layers (B={B} x S={S}, "
        f"bf16) with dispatch_groups={MESH_LOCAL_GROUPS} over (data, model) = 1 x 1, "
        f"{'bitwise' if same and losses == plain_losses else 'within tolerance of'} the "
        f"unsharded steps: losses {[round(x, 4) for x in losses]}, the MoE layers on the "
        f"mesh's own-rows path {len(on_mesh_calls)} times; step walls "
        f"{[round(w, 3) for w in walls]} s; peak device memory {peak / 2**30:.2f} GiB; "
        f"launches {train_launches}")

    # the prefill, unsharded and over the mesh
    model = build(cfg)
    params = model.init(SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    logits0, caches0 = model.prefill(params, {"tokens": tokens})
    rules = sharding.ShardingRules(sharding.BASE_RULES)
    _, specs = model.abstract()
    with sharding.on_mesh(mesh, rules), _counting(moe, "_moe_on_mesh") as on_mesh_calls:
        p = sharding.place_state(params, sharding.param_shardings(specs, mesh, rules), mesh)
        pl = sharding.batch_shardings({"tokens": None}, mesh, rules)["tokens"]
        ops.reset_launch_counts()
        logits, caches = model.prefill(p, {"tokens": sharding.from_global(tokens, mesh, pl)})
        prefill_launches = dict(ops.launches)
    logits = logits.full_tensor()
    if len(on_mesh_calls) != n_moe or prefill_launches["flash_attention"] != n_attn:
        fail(f"(ak) the mesh prefill ran the mesh's MoE path {len(on_mesh_calls)} times "
             f"(expected {n_moe}) and launched {prefill_launches} (expected {n_attn} flash)")
    if not torch.isfinite(logits).all() or not _same_bits(logits, logits0):
        fail(f"(ak) the grouped mesh prefill's logits are not bitwise the unsharded "
             f"prefill's ({_logit_diff(logits, logits0):.4g} apart)")
    cache_same, _ = _host_compare(_host_leaves(caches), _host_leaves(caches0))
    if not cache_same:
        fail("(ak) the grouped mesh prefill's caches are not bitwise the unsharded prefill's")
    log(f"(ak) ok: {cfg.name} prefill ({B} x {S}) with dispatch_groups={MESH_LOCAL_GROUPS} "
        f"under use_mesh over 1 x 1: logits and caches bitwise the unsharded prefill's; "
        f"{prefill_launches['flash_attention']} flash launches")
    del model, params, p, logits0, caches0, logits, caches
    torch.cuda.empty_cache()

    # a decode over a cache whose slots split over model
    dcfg = get_config(MESH_LOCAL_DECODE_ARCH).replace(n_layers=MESH_LOCAL_DECODE_LAYERS)
    model = build(dcfg)
    params = model.init(SEED, device=dev)
    L, steps = MESH_LOCAL_PROMPT, MESH_LOCAL_DECODE_STEPS
    toks = torch.randint(0, dcfg.vocab, (B, L + steps), generator=gen, device=dev)
    caches = model.init_cache(B, L + steps, device=dev)
    want, caches = model.prefill(params, {"tokens": toks[:, :L]}, caches)
    want = [want]
    for i in range(steps):
        want.append(model.decode_step(params, caches, toks[:, L + i:L + i + 1], L + i)[0])
    del caches
    shape = dataclasses.replace(SHAPES["decode_32k"], global_batch=B, seq_len=L + steps)
    rules = dryrun.make_rules(shape, mesh, dryrun.parser().parse_args(["--kv-shard", "seq"]))
    _, specs = model.abstract()
    got = []
    with sharding.on_mesh(mesh, rules), _counting(attention, "_split_slot_decode") as split:
        p = sharding.place_state(params, sharding.param_shardings(specs, mesh, rules), mesh)
        pl = sharding.batch_shardings({"tokens": None}, mesh, rules)["tokens"]
        caches = model.init_cache(B, L + steps, device=dev)
        placed = all(Shard(1) in t.placements for t in tree_leaves(caches))
        ops.reset_launch_counts()
        lp, caches = model.prefill(p, {"tokens": sharding.from_global(toks[:, :L], mesh, pl)},
                                   caches)
        decode_launches = dict(ops.launches)
        got.append(lp.full_tensor())
        t0 = time.perf_counter()
        for i in range(steps):
            t = sharding.from_global(toks[:, L + i:L + i + 1], mesh, pl)
            got.append(model.decode_step(p, caches, t, L + i)[0].full_tensor())
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / steps
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if not _same_bits(a, b)]
    if not placed or len(split) != steps * dcfg.n_layers:
        fail(f"(ak) the seq-split decode: caches split over their slots {placed}, the split "
             f"decode ran {len(split)} times (expected {steps * dcfg.n_layers})")
    if bad or not all(torch.isfinite(g).all() for g in got):
        fail(f"(ak) the seq-split decode's logits are not bitwise the unsharded decode's at "
             f"{bad} (0 the prefill): {[_logit_diff(got[i], want[i]) for i in bad]}")
    if decode_launches["flash_attention"] != dcfg.n_layers:
        fail(f"(ak) the seq-split run's prefill launched {decode_launches}")
    log(f"(ak) ok: {dcfg.name} at {dcfg.n_layers} layers, prefill {B} x {L} then {steps} "
        f"decode steps over a cache whose slots split over model (kv_shard=seq, 1 x 1): every "
        f"logit bitwise the unsharded run's; the split decode {len(split)} times, "
        f"{decode_ms:.2f} ms a step")
    del model, params, p, caches, got, want
    _leave_world(rdv)
    torch.cuda.empty_cache()

    # the grouped dry run of deepseek's train_4k on the 16 x 16 mesh
    _wait_dryruns(procs, "(ak)")
    flag = lambda f, default: (DRYRUN_GROUPED[DRYRUN_GROUPED.index(f) + 1]
                               if f in DRYRUN_GROUPED else default)
    rec = _dryrun_record(root, f"deepseek-v2-lite-16b__train_4k__{flag('--mesh', '16x16')}__ak")
    m = rec["memory"]
    peak_rank = m["argument_bytes"] + m["temp_bytes"]
    log(f"(ak) dry run deepseek-v2-lite-16b train_4k on the {rec['mesh']} mesh with "
        f"--moe-groups {rec['opts']['moe_groups']} ({rec['n_devices']} fake {rec['device']} "
        f"ranks; counts on one rank, not measurements): peak {peak_rank / 1e9:.2f} GB a rank (argument "
        f"{m['argument_bytes'] / 1e9:.2f} + temp {m['temp_bytes'] / 1e9:.2f}), "
        f"{rec['cost']['flops']:.4g} flops a rank, wire bytes by op "
        f"{ {k: round(v) for k, v in rec['collectives']['bytes_by_op'].items()} }, "
        f"{rec['wall_s']} s wall")
    if rec["opts"]["moe_groups"] != int(flag("--moe-groups", 0)) or not rec["cost"]["flops"] > 0:
        fail(f"(ak) the grouped dry run's record: {rec['opts']}, {rec['cost']}")
    log(f"(ak) ok in {time.perf_counter() - t_phase:.1f} s after (aj)")
    launches = {k: train_launches.get(k, 0) + prefill_launches.get(k, 0)
                + decode_launches.get(k, 0) for k in ops.KERNELS}
    return launches, dict(train_bitwise=same and losses == plain_losses, worst=worst,
                          dryrun_peak_bytes=peak_rank, decode_ms=decode_ms)


# ---------------------------------------------------------------------------
# (al) exact-mode e-prop: rsnn_train_exact against its plain version, an
# exact END_S epoch through the learner, served through rsnn_infer
# ---------------------------------------------------------------------------


def _exact_configs():
    """(al)'s cases: name, config, T, B, and the decays (the backend's, or
    one a neuron drawn in [0.85, 1))."""
    from repro_torch.configs.reckon_braille import CONFIG, CONFIG_QUANT
    from repro_torch.core.rsnn import Presets

    chip_max = Presets.braille(n_in=256, n_hid=256, n_out=16, quantized=True)
    return [
        ("Braille T=256 B=1 quantized", CONFIG_QUANT, 256, 1, "backend"),
        ("Braille T=256 B=1 float", CONFIG, 256, 1, "backend"),
        ("END_B T=128 B=70 quantized", CONFIG_QUANT, 128, 70, "backend"),
        ("cue 40/100/2 T=150 B=8 quantized", Presets.cue_accumulation(quantized=True),
         150, 8, "backend"),
        ("256/256/16 T=128 B=4 quantized", chip_max, 128, 4, "backend"),
        ("Braille T=256 B=8 float, alpha (H,)", CONFIG, 256, 8, "per_neuron"),
        ("Braille T=256 B=8 quantized, alpha (H,)", CONFIG_QUANT, 256, 8, "per_neuron"),
    ]


def _span(plan) -> str:
    """What of rsnn_train_exact's plan a log line shows."""
    return (f"a row on {plan.groups} cluster(s) of {plan.cluster} block(s), "
            f"{plan.slots} ring slots, {plan.lines} line(s) a walker")


def _exact_case(gen, cfg, T, B, dev, alpha, density=0.12):
    """An exact-mode tile of ``cfg`` at (T, B): weights from ``init_params``
    snapped onto the SRAM grid, the ``rsnn_train_exact`` arguments and
    keywords as the backend passes them."""
    from repro_torch.core.backend import ExecutionBackend
    from repro_torch.core.rsnn import init_params

    cfg = dataclasses.replace(cfg, num_ticks=T,
                              eprop=dataclasses.replace(cfg.eprop, mode="exact"))
    be = ExecutionBackend(cfg, device=dev)
    params = {k: (torch.round(v * 16) / 16).clamp(-8, 127 / 16) if k != "alpha" else v
              for k, v in init_params(gen, cfg, device=dev).items()}
    a = (be.alpha if alpha == "backend"
         else (0.85 + 0.15 * torch.rand(cfg.n_hid, generator=gen)).to(dev))
    ins = _train_inputs(gen, T, B, cfg, density, dev)
    args = (*ins, *be.datapath_weights(params), be._feedback(params))
    kw = dict(alpha=a, kappa=cfg.neuron.kappa, v_th=cfg.neuron.v_th,
              reset=cfg.neuron.reset, boxcar_width=cfg.neuron.boxcar_width,
              surrogate=cfg.neuron.surrogate, gamma=cfg.neuron.gamma,
              quant=be.quant, error=cfg.eprop.error, infer_window=cfg.eprop.infer_window)
    return cfg, args, kw


def phase_exact_vs_plain(dev):
    """(al), first half: ``rsnn_train_exact`` against its plain version at
    every case of :func:`_exact_configs` (dw within TRAIN_DW_TOL of max|dw|,
    acc_y and n_spk bitwise when quantized, else within FLOAT_TOL; two
    launches bitwise), and on the commit grid at the END_B tile (the codes
    equal their plain reduce over the launch's own partials bitwise, and the
    plain B=1 loop's codes within TRAIN_DW_TOL of max|dw| plus B lsb, the
    count of codes that differ printed).  Returns the largest dw error."""
    from repro_torch.core.quant import DW_COMMIT_SPEC as G
    from repro_torch.kernels import eprop_update as E
    from repro_torch.kernels import rsnn_step as K

    gen = torch.Generator().manual_seed(SEED + 30)
    worst, errs = 0.0, []
    for name, cfg, T, B, alpha in _exact_configs():
        cfg, args, kw = _exact_case(gen, cfg, T, B, dev, alpha)
        quantized = cfg.neuron.quant is not None
        t0 = time.perf_counter()
        got = E.rsnn_train_exact_cuda(*args, **kw)
        again = E.rsnn_train_exact_cuda(*args, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = E.rsnn_train_exact_plain(*args, **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        e = _dw_err(f"(al) {name}", got[:3], want[:3])
        worst = max(worst, e)
        _compare(f"(al) {name}", got[3:], want[3:], quantized, errs)
        _check_equal(f"(al) {name}: two launches", got, again)
        plan = K.train_exact_plan(T, cfg.n_in, cfg.n_hid, cfg.n_out, B)
        log(f"(al) ok: {name}: dw within {TRAIN_DW_TOL} of max|dw| (max |Δdw| "
            f"{e:.3g}), acc_y and n_spk "
            f"{'bitwise' if quantized else f'within {FLOAT_TOL}'}, two launches bitwise; "
            f"{_span(plan)}; two launches {t1 - t0:.3f} s, plain {t2 - t1:.3f} s")
        if name.startswith("END_B"):
            codes = E.rsnn_train_exact_cuda(*args, **kw, commit_grid=G, return_partials=True)
            flat = torch.cat([c.reshape(-1) for c in codes[:3]])
            if not torch.equal(flat, E.dw_codes_reduce_plain(codes[5], G)):
                fail("(al) commit grid: codes differ from the plain reduce of the partials")
            plain = E.rsnn_train_exact_plain(*args, **kw, commit_grid=G)
            n_diff = sum(int((c != p).sum()) for c, p in zip(codes[:3], plain[:3]))
            top = max(int((c - p).abs().max()) for c, p in zip(codes[:3], plain[:3]))
            for c, p, f in zip(codes[:3], plain[:3], got[:3]):
                lim = TRAIN_DW_TOL * float(f.abs().max()) + B * G.lsb
                if float((c - p).abs().max()) * G.lsb > lim:
                    fail(f"(al) commit grid: codes off the plain B=1 loop by more than {lim}")
            n_codes = sum(c.numel() for c in codes[:3])
            log(f"(al) ok: commit grid at {name}: codes bitwise the plain reduce of the "
                f"launch's partials; against the plain B=1 loop {n_diff} of {n_codes} "
                f"codes differ, by at most {top} (limit: {TRAIN_DW_TOL} of max|dw| plus "
                f"{B} lsb; expf against torch.softmax moves values across a half step)")
    return worst


def phase_exact_learning(dev):
    """(al), second half: one epoch of END_S learning on Braille AEU
    (quantized, the dataset's T=128, (h)'s optimizer, seed LEARN_SEEDS[0])
    in exact mode, every commit one rsnn_train_exact launch and none of
    rsnn_train; its test accuracy and wall beside the factored run's in
    this call; then BatchedEngine.from_learner serves the exact-trained
    weights (rsnn_infer) on the test split, bitwise the backend's
    inference.  Returns the exact path's launches and a summary."""
    from repro_torch.configs.reckon_braille import QUANT_OPT
    from repro_torch.core.controller import ControllerConfig, OnlineLearner
    from repro_torch.core.rsnn import Presets
    from repro_torch.data.braille import make_braille_dataset
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.kernels import ops
    from repro_torch.serve import BatchedEngine
    from repro_torch.serve.batching import decode_events_host, trim_padding

    data = make_braille_dataset("AEU")
    T = data["train"]["num_ticks"]
    n_train = data["train"]["events"].shape[0]
    base = Presets.braille(n_classes=3, num_ticks=T, quantized=True)
    opt = dataclasses.replace(QUANT_OPT, decay_tau=25.0 * n_train)
    pipe = make_pipeline("arm", data, samples_per_batch=70, device=dev)
    out, launches = {}, None
    # in turns, so that neither mode's wall carries the first run's warm-up
    for mode in ("exact", "factored", "factored", "exact"):
        cfg = dataclasses.replace(base, eprop=dataclasses.replace(base.eprop, mode=mode))
        learner = OnlineLearner(cfg, ControllerConfig(num_epochs=1, eval_every=1,
                                                      commit="sample"),
                                opt, LEARN_SEEDS[0], device=dev)
        start = {k: v.clone() for k, v in learner.weights.items()}
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        log_ = learner.fit(pipe)
        test = learner.eval_epoch(pipe, 0, "test")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        seen = dict(ops.launches)
        ran, other = (("rsnn_train_exact", "rsnn_train") if mode == "exact"
                      else ("rsnn_train", "rsnn_train_exact"))
        if seen[ran] != n_train or seen[other] != 0:
            fail(f"(al) {mode} END_S epoch: {seen[ran]} {ran} launches for {n_train} "
                 f"samples, {seen[other]} of {other}")
        if all(torch.equal(learner.weights[k], v) for k, v in start.items()):
            fail(f"(al) {mode} END_S epoch moved no weight")
        log(f"(al) {mode} END_S: 1 epoch on Braille AEU (T={T}, seed {LEARN_SEEDS[0]}), "
            f"{n_train} commits: test {test:.4f}, val {log_.val_acc[-1]:.4f}, train "
            f"{log_.train_acc[-1]:.4f}, {wall:.3f} s wall; launches {seen}")
        if mode in out:
            if out[mode]["test_acc"] != test:
                fail(f"(al) two {mode} END_S epochs from seed {LEARN_SEEDS[0]} reach "
                     f"{out[mode]['test_acc']} and {test}")
            out[mode]["wall_s"].append(wall)
            continue
        out[mode] = dict(test_acc=test, val_acc=log_.val_acc[-1], wall_s=[wall])
        if mode != "exact":
            continue
        eng = BatchedEngine.from_learner(learner)
        reqs = [trim_padding(r) for r in data["test"]["events"]]
        res, _ = eng.serve(iter(reqs))
        for r, ev in zip(res, reqs):
            raster, valid, _ = decode_events_host([ev], cfg.n_in, r.bucket_ticks,
                                                  cfg.label_delay)
            got = learner.backend.inference(learner.weights, torch.from_numpy(raster).to(dev),
                                            torch.from_numpy(valid).to(dev))
            if r.pred != int(got["pred"][0]) or not np.array_equal(
                    r.logits, got["acc_y"][0].cpu().numpy()):
                fail(f"(al) served request {r.rid} differs from the backend's inference")
        launches = dict(ops.launches)
        if launches["rsnn_infer"] <= 0 or launches["rsnn_train_exact"] != n_train:
            fail("(al) the exact-trained weights were not served through rsnn_infer")
        out["served_acc"] = float(np.mean([r.pred == r.label for r in res]))
        log(f"(al) ok: the exact-trained weights served {len(res)} test samples bitwise "
            f"the backend's inference, accuracy {out['served_acc']:.4f}; launches {launches}")
    walls = {m: " and ".join(f"{w:.3f}" for w in out[m]["wall_s"])
             for m in ("exact", "factored")}
    log(f"(al) ok: exact against factored END_S, one epoch, seed {LEARN_SEEDS[0]}: test "
        f"{out['exact']['test_acc']:.4f} / {out['factored']['test_acc']:.4f}, walls "
        f"{walls['exact']} s / {walls['factored']} s (run in turns: exact, factored, "
        f"factored, exact)")
    return launches, out


def phase_exact_timing(dev):
    """(al)'s kernel timed: rsnn_train_exact at Braille T=256, B=1
    (quantized; the kernels line), at the learning run's END_S commit
    (T=128, B=1) and at the END_B tile (T=128, B=70), each beside its plain
    version and its bound from this run's events
    (traffic.train_exact_event_flops), rsnn_train at the same shapes
    logged beside it."""
    from repro_torch.configs.reckon_braille import CONFIG_QUANT
    from repro_torch.kernels import eprop_update as E
    from repro_torch.kernels import rsnn_step as K
    from repro_torch.kernels import traffic

    gen = torch.Generator().manual_seed(SEED + 31)
    rows = {}
    for T, B, key in ((256, 1, "rsnn_train_exact"), (128, 1, "rsnn_train_exact END_S"),
                      (128, 70, "rsnn_train_exact END_B")):
        cfg, args, kw = _exact_case(gen, CONFIG_QUANT, T, B, dev, "backend")
        N, H, O = cfg.n_in, cfg.n_hid, cfg.n_out
        fkw = {k: kw[k] for k in ("kappa", "v_th", "reset", "boxcar_width", "quant")}
        z = K.rsnn_forward_cuda(args[0], *args[3:6], alpha=kw["alpha"], **fkw)["z"]
        flops = traffic.train_exact_event_flops(
            T, B, N, H, O, int(args[0].count_nonzero()), int(z.count_nonzero()),
            int(z[:-1].count_nonzero()))
        shape = f"T={T} B={B} {N}/{H}/{O} quantized"
        rows[key] = _timed_row("(al)", "rsnn_train_exact",
                               lambda: E.rsnn_train_exact_cuda(*args, **kw),
                               lambda: E.rsnn_train_exact_plain(*args, **kw),
                               traffic.train_exact_bytes(T, B, N, H, O), flops, shape)
        fact = _median_reading(lambda: E.rsnn_train_cuda(*args, **kw))[0]
        log(f"(al) rsnn_train (factored) at {shape}: {fact} ms on the card (profiler); "
            f"rsnn_train_exact's plan {K.train_exact_plan(T, N, H, O, B)}")
        rows[key]["factored_ms"] = fact
    return rows


# ---------------------------------------------------------------------------
# (am) the surrogate: rsnn_forward, rsnn_train and rsnn_train_exact under the
# triangular pseudo-derivative and a boxcar of another width, against their
# plain versions; one triangular END_S epoch
# ---------------------------------------------------------------------------

# (am)'s surrogates: a name and the NeuronConfig fields that set it
SURROGATE_CASES = (("triangular", dict(surrogate="triangular", gamma=0.3)),
                   ("boxcar 0.25", dict(surrogate="boxcar", boxcar_width=0.25)))
FORWARD_KW = ("alpha", "kappa", "v_th", "reset", "boxcar_width", "surrogate", "gamma",
              "quant")


def _surrogate_shapes():
    """(am)'s shapes: name, config, T, B."""
    from repro_torch.configs.reckon_braille import CONFIG, CONFIG_QUANT
    from repro_torch.core.rsnn import Presets

    return [("Braille T=256 B=1 quantized", CONFIG_QUANT, 256, 1),
            ("Braille T=256 B=1 float", CONFIG, 256, 1),
            ("END_B T=128 B=70 quantized", CONFIG_QUANT, 128, 70),
            ("END_B T=128 B=70 float", CONFIG, 128, 70),
            ("cue 40/100/2 T=150 B=8 quantized", Presets.cue_accumulation(quantized=True),
             150, 8)]


def _with_surrogate(cfg, fields):
    return dataclasses.replace(cfg, neuron=dataclasses.replace(cfg.neuron, **fields))


def phase_surrogate_vs_plain(dev):
    """(am), first half: at each of :func:`_surrogate_shapes` under each of
    SURROGATE_CASES, ``rsnn_forward``, ``rsnn_train`` and
    ``rsnn_train_exact`` against their plain versions (the gates of (g) and
    (al): dw within TRAIN_DW_TOL of max|dw|; acc_y, n_spk, rsnn_forward's
    streams and rsnn_train's traces bitwise when quantized, else within
    FLOAT_TOL); each kernel's ``h`` another than the default boxcar's.
    Returns the largest error of each kernel."""
    from repro_torch.kernels import eprop_update as E
    from repro_torch.kernels import rsnn_step as K

    gen = torch.Generator().manual_seed(SEED + 32)
    errs = {k: [0.0] for k in ("rsnn_forward", "rsnn_train", "rsnn_train_exact")}
    for name, base, T, B in _surrogate_shapes():
        quantized = base.neuron.quant is not None
        for sname, fields in SURROGATE_CASES:
            tag = f"(am) {name}, {sname}"
            cfg, args, kw = _exact_case(gen, _with_surrogate(base, fields), T, B, dev,
                                        "backend")
            raster, w = args[0], args[3:6]
            fkw = {k: kw[k] for k in FORWARD_KW}
            got = K.rsnn_forward_cuda(raster, *w, **fkw)
            boxcar = K.rsnn_forward_cuda(raster, *w, **dict(
                fkw, surrogate="boxcar", boxcar_width=base.neuron.boxcar_width))["h"]
            want = K.rsnn_forward_plain(raster, *w, **fkw)
            torch.cuda.synchronize()
            _compare(f"{tag} rsnn_forward", [got[k] for k in K.FORWARD_KEYS],
                     [want[k] for k in K.FORWARD_KEYS], quantized, errs["rsnn_forward"])
            if torch.equal(got["h"], boxcar):
                fail(f"{tag}: rsnn_forward's h is the default boxcar's")
            inner = int(((got["h"] > 0) & (got["h"] < 1)).sum())
            got = E.rsnn_train_cuda(*args, **kw, return_traces=True)
            want = E.rsnn_train_plain(*args, **kw, return_traces=True)
            torch.cuda.synchronize()
            errs["rsnn_train"].append(_dw_err(f"{tag} rsnn_train", got[:3], want[:3]))
            _compare(f"{tag} rsnn_train acc_y/n_spk", got[3:5], want[3:5], quantized,
                     errs["rsnn_train"])
            keys = ("h", "xbar", "pbar", "zbar")
            _compare(f"{tag} rsnn_train traces", [got[5][k] for k in keys],
                     [want[5][k] for k in keys], quantized, errs["rsnn_train"])
            ex = E.rsnn_train_exact_cuda(*args, **kw)
            want_x = E.rsnn_train_exact_plain(*args, **kw)
            torch.cuda.synchronize()
            errs["rsnn_train_exact"].append(_dw_err(f"{tag} rsnn_train_exact", ex[:3],
                                                    want_x[:3]))
            _compare(f"{tag} rsnn_train_exact acc_y/n_spk", ex[3:], want_x[3:], quantized,
                     errs["rsnn_train_exact"])
            plan = K.train_exact_plan(T, cfg.n_in, cfg.n_hid, cfg.n_out, B)
            log(f"{tag}: the three kernels hold their plain versions (dw within "
                f"{TRAIN_DW_TOL} of max|dw|, the rest "
                f"{'bitwise' if quantized else f'within {FLOAT_TOL}'}); h strictly "
                f"between 0 and 1 at {inner} of {got[5]['h'].numel()} (t, b, neuron), "
                f"another h than the default boxcar's; rsnn_train_exact {_span(plan)}")
    return {k: max(v) for k, v in errs.items()}


def phase_surrogate_learning(dev, boxcar_test_acc):
    """(am), second half: one epoch of factored END_S learning on Braille
    AEU (quantized, seed LEARN_SEEDS[0], (al)'s optimizer) under the
    triangular surrogate, every commit one rsnn_train launch; its test
    accuracy beside (al)'s boxcar epoch (no gate on it: the surrogate is
    another rule), gated on finite weights that moved.  Returns the
    launches and a summary."""
    from repro_torch.configs.reckon_braille import QUANT_OPT
    from repro_torch.core.controller import ControllerConfig, OnlineLearner
    from repro_torch.core.rsnn import Presets
    from repro_torch.data.braille import make_braille_dataset
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.kernels import ops

    data = make_braille_dataset("AEU")
    T = data["train"]["num_ticks"]
    n_train = data["train"]["events"].shape[0]
    cfg = _with_surrogate(Presets.braille(n_classes=3, num_ticks=T, quantized=True),
                          SURROGATE_CASES[0][1])
    opt = dataclasses.replace(QUANT_OPT, decay_tau=25.0 * n_train)
    pipe = make_pipeline("arm", data, samples_per_batch=70, device=dev)
    learner = OnlineLearner(cfg, ControllerConfig(num_epochs=1, eval_every=1,
                                                  commit="sample"),
                            opt, LEARN_SEEDS[0], device=dev)
    start = {k: v.clone() for k, v in learner.weights.items()}
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    log_ = learner.fit(pipe)
    test = learner.eval_epoch(pipe, 0, "test")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    if launches["rsnn_train"] != n_train or launches["rsnn_train_exact"] != 0:
        fail(f"(am) triangular END_S epoch: {launches['rsnn_train']} rsnn_train launches "
             f"for {n_train} samples, {launches['rsnn_train_exact']} of rsnn_train_exact")
    if not all(torch.isfinite(v).all() for v in learner.weights.values()):
        fail("(am) triangular END_S epoch: non-finite weights")
    if all(torch.equal(learner.weights[k], v) for k, v in start.items()):
        fail("(am) triangular END_S epoch moved no weight")
    log(f"(am) ok: triangular END_S: 1 epoch on Braille AEU (T={T}, seed {LEARN_SEEDS[0]}), "
        f"{n_train} commits: test {test:.4f} (the boxcar's in (al): {boxcar_test_acc:.4f}), "
        f"val {log_.val_acc[-1]:.4f}, train {log_.train_acc[-1]:.4f}, {wall:.3f} s wall; "
        f"launches {launches}")
    return launches, dict(test_acc=test, boxcar_test_acc=boxcar_test_acc,
                          val_acc=log_.val_acc[-1], wall_s=wall)


def phase_surrogate_timing(dev):
    """(am)'s kernels timed under the triangular surrogate beside the
    default boxcar on the same inputs, at END_S's Braille commit (T=256,
    B=1) and the END_B tile (T=128, B=70), quantized: the median of three
    profiler readings each, the two surrogates in turns.  Returns
    ``{kernel: [row a shape]}``."""
    from repro_torch.configs.reckon_braille import CONFIG_QUANT
    from repro_torch.kernels import eprop_update as E
    from repro_torch.kernels import rsnn_step as K

    gen = torch.Generator().manual_seed(SEED + 33)
    rows = {k: [] for k in ("rsnn_forward", "rsnn_train", "rsnn_train_exact")}
    for T, B in ((256, 1), (128, 70)):
        cfg, args, kw = _exact_case(gen, CONFIG_QUANT, T, B, dev, "backend")
        tri = dict(kw, **SURROGATE_CASES[0][1])
        calls = {"rsnn_forward": lambda k: K.rsnn_forward_cuda(
                     args[0], *args[3:6], **{n: k[n] for n in FORWARD_KW}),
                 "rsnn_train": lambda k: E.rsnn_train_cuda(*args, **k),
                 "rsnn_train_exact": lambda k: E.rsnn_train_exact_cuda(*args, **k)}
        shape = f"T={T} B={B} {cfg.n_in}/{cfg.n_hid}/{cfg.n_out} quantized"
        for name, call in calls.items():
            ms = {}
            for which, k in (("boxcar", kw), ("triangular", tri), ("triangular", tri),
                             ("boxcar", kw)):
                ms.setdefault(which, []).append(_median_reading(lambda: call(k))[0])
            row = dict(shape=shape, ms=ms["triangular"], boxcar_ms=ms["boxcar"])
            rows[name].append(row)
            log(f"(am) {name} at {shape}: triangular {ms['triangular']} ms, boxcar "
                f"{ms['boxcar']} ms on the card (profiler, in turns: boxcar, triangular, "
                f"triangular, boxcar)")
    return rows


def tree_times(root: Path, dev) -> None:
    """``--time-tree ROOT``: the RSNN kernels of the checkout at ``ROOT``
    (its ``src/repro_torch``, built from its own sources) at the shapes
    (f) and (i) time them and at the 256/256/16 net (the event loop's widest
    instantiations), its rsnn_train_exact at five shapes under both
    surrogates with a digest of each launch's outputs (:func:`_tree_exact`),
    its flash_attention forward at (l)'s shape (without and with lse) and at
    :data:`FWD_TREE_SHAPES` (qwen3-1.7b's with lse, (192, 128), cross, enc
    and the two decode rows), each beside ``scaled_dot_product_attention``
    at the same shape, with the host µs a call of the decode rows (the
    wrapper's checks and the launcher's tensor maps), and its
    flash_attention_bwd at (r)'s two shapes (null for a tree without that
    wrapper), through wrappers that every slice of the port has, so that
    two trees compare on one card in one call.  Each time is the median of
    three ``torch.profiler`` readings (:func:`_median_reading`); where the
    profiler saw no device time the row is null and a CUDA-event reading
    stands beside it under its name with `` [events]``.  Beside the times,
    a digest of each kernel's SASS and its counts of :data:`SASS_OPS`
    (:func:`_sass_digests`), so that two trees' kernels compare function by
    function; and its rsnn_train at :func:`_train_tree_shapes` under both
    surrogates, each with a digest of its outputs and its roles' clocks
    (:func:`_tree_train`).  Prints one JSON line."""
    import torch.nn.functional as F

    from repro_torch.configs.reckon_braille import CONFIG_QUANT
    from repro_torch.core.backend import ExecutionBackend
    from repro_torch.core.rsnn import Presets, init_params
    from repro_torch.kernels import build
    from repro_torch.kernels import eprop_update as E
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rsnn_step as K

    build.library()
    gen = torch.Generator().manual_seed(SEED + 3)
    ms = {}

    def best(name, fn):
        ms[name] = _median_reading(fn, iters=20)[0]
        if ms[name] is None:
            ms[f"{name} [events]"] = _time(fn)

    fgen = torch.Generator(device=dev).manual_seed(SEED + 7)
    q, k, v = _flash_inputs(fgen, LM_BATCH, LM_PROMPT, LM_PROMPT, 32, 8, 128,
                            torch.bfloat16, dev)
    best("flash_attention llama3-8b", lambda: FA.flash_attention_cuda(q, k, v, causal=True))
    best("flash_attention with lse llama3-8b",
         lambda: FA.flash_attention_cuda(q, k, v, causal=True, return_lse=True))
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    best("SDPA llama3-8b", lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True, enable_gqa=True))
    del q, k, v, qh, kh, vh
    host_us = {}
    for label, (B, Sq, Skv, H, Hkv, D, DV, causal, lse) in FWD_TREE_SHAPES:
        q, k, v = _flash_inputs(fgen, B, Sq, Skv, H, Hkv, D, torch.bfloat16, dev, DV=DV)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        kern = lambda: FA.flash_attention_cuda(q, k, v, causal=causal, return_lse=lse)
        best(f"flash_attention {label}", kern)
        best(f"SDPA {label}", lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal, enable_gqa=H != Hkv))
        if Sq == 1:
            host_us[label] = _host_us(kern)
        del q, k, v, qh, kh, vh
    for name, (B, S, H, Hkv, D) in (("qwen3-1.7b", (TRAIN_BATCH, TRAIN_SEQ, 16, 8, 128)),
                                    ("llama3-8b", (LM_BATCH, LM_PROMPT, 32, 8, 128))):
        if not hasattr(FA, "flash_attention_bwd_cuda"):
            ms[f"flash_attention_bwd {name}"] = None
            continue
        q, k, v = _flash_inputs(fgen, B, S, S, H, Hkv, D, torch.bfloat16, dev)
        do = torch.randn((B, S, H, D), generator=fgen, device=dev).to(torch.bfloat16)
        # (o, lse), or (o, lse, the f32 output) from a tree whose backward
        # takes δ from that
        out = FA.flash_attention_cuda(q, k, v, causal=True, return_lse=True)
        o, lse = out[2] if len(out) == 3 else out[0], out[1]
        best(f"flash_attention_bwd {name}",
             lambda: FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True))
        del q, k, v, do, o, lse, out

    # the chip-maximum net (the event loop's widest instantiations) at T=128
    wide = Presets.braille(n_in=256, n_hid=256, n_out=16, num_ticks=128, quantized=True)
    be = ExecutionBackend(wide, device=dev)
    params = init_params(gen, wide, device=dev)
    params = {k: (torch.round(v * 16) / 16).clamp(-8, 127 / 16)
              if k != "alpha" else v for k, v in params.items()}
    w = be.datapath_weights(params)
    kw = dict(alpha=be.alpha, kappa=wide.neuron.kappa, v_th=wide.neuron.v_th,
              reset=wide.neuron.reset, quant=be.quant)
    r, y_star, valid = _train_inputs(gen, 128, 8, wide, 0.05, dev)
    best("rsnn_forward 256/256/16 B=8", lambda: K.rsnn_forward_cuda(
        r, *w, **kw, boxcar_width=wide.neuron.boxcar_width))
    best("rsnn_train 256/256/16 B=8", lambda: E.rsnn_train_cuda(
        r, y_star, valid, *w, be._feedback(params), **kw,
        boxcar_width=wide.neuron.boxcar_width, error=wide.eprop.error,
        infer_window=wide.eprop.infer_window))
    best("rsnn_infer 256/256/16 B=8", lambda: K.rsnn_infer_cuda(r, valid, *w, **kw))
    for T in (128, 256):
        cfg = dataclasses.replace(CONFIG_QUANT, num_ticks=T)
        be = ExecutionBackend(cfg, device=dev)
        params = init_params(gen, cfg, device=dev)
        params = {k: (torch.round(v * 16) / 16).clamp(-8, 127 / 16)
                  if k != "alpha" else v for k, v in params.items()}
        w = be.datapath_weights(params)
        kw = dict(alpha=be.alpha, kappa=cfg.neuron.kappa, v_th=cfg.neuron.v_th,
                  reset=cfg.neuron.reset, quant=be.quant)
        if T == 128:    # (i): the training kernels
            tkw = dict(kw, boxcar_width=cfg.neuron.boxcar_width,
                       error=cfg.eprop.error, infer_window=cfg.eprop.infer_window)
            for b in (1, 70, 2048):
                r, y_star, valid = _train_inputs(gen, T, b, cfg, 0.12, dev)
                best(f"rsnn_forward B={b}", lambda: K.rsnn_forward_cuda(
                    r, *w, **kw, boxcar_width=cfg.neuron.boxcar_width))
                if b != 2048:
                    targs = (r, y_star, valid, *w, be._feedback(params))
                    best(f"rsnn_train B={b}", lambda: E.rsnn_train_cuda(*targs, **tkw))
            continue
        for b in (1, 512, 2048):     # (f): the serving kernels
            r, valid, live = _inputs(gen, T, b, cfg.n_in, 0.12, dev)
            st = be.init_session_state(b)
            c = [st[k] for k in ("v", "z", "y", "acc_y", "n_spk")]
            best(f"rsnn_infer B={b}", lambda: K.rsnn_infer_cuda(r, valid, *w, **kw))
            best(f"rsnn_step_sessions B={b}", lambda: K.rsnn_step_sessions_cuda(
                r, live, valid, *c, *w, **kw))
    train = _tree_train(dev)
    exact = {}
    if hasattr(E, "rsnn_train_exact_cuda"):
        exact = _tree_exact(dev)
        exact["END_S epoch"] = _tree_exact_epoch(dev)
    digests, ops = _sass_digests(build)
    log("flash forward SASS (" + ", ".join(SASS_OPS) + "): " + "; ".join(
        f"{_kernel_label(n).split('flash_')[-1][:60]} {list(c.values())}"
        for n, c in ops.items() if "flash_fwd_kernel" in n or "flash_attention_mma" in n))
    print(json.dumps({"tree": str(root), "card": card_line(), "ms": ms,
                      "host_us_a_call": host_us, "train": train, "exact": exact,
                      "sass": digests,
                      "sass_ops": ops}), flush=True)


# The forward's shapes beside (l)'s in --time-tree: label, (B, Sq, Skv, H,
# Hkv, DK, DV, causal, lse) — (q)'s qwen3-1.7b training forward, (s)'s MLA
# pair, (y)'s cross-attention and (z)'s encoder, and one decode row over
# each memory.
FWD_TREE_SHAPES = (
    ("qwen3-1.7b with lse", (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 16, 8, 128, 128, True, True)),
    ("(192, 128)", (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, MLA_HEADS, MLA_HEADS, MLA_DK, MLA_DV,
                    True, False)),
    ("cross", (VLM_BATCH, VLM_PROMPT, 1600, 64, 8, 128, 128, False, False)),
    ("enc", (AUDIO_BATCH, 4096, 4096, 16, 16, 64, 64, False, False)),
    ("vlm decode row", (VLM_BATCH, 1, 1600, 64, 8, 128, 128, False, False)),
    ("seamless decode row", (AUDIO_BATCH, 1, 4096, 16, 16, 64, 64, False, False)),
)


def _host_us(fn, n=200) -> float:
    """The host's µs a call of ``fn`` over ``n`` calls back to back, the
    card idle at the start (the enqueue: checks, plan, tensor maps,
    launch)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def _exact_tree_shapes():
    """The shapes ``--time-tree`` times rsnn_train_exact at: name, config,
    T, B (quantized; the learning run's END_S commit, (al)'s Braille
    commit, the END_B tile, the cue net, the chip-maximum net)."""
    from repro_torch.configs.reckon_braille import CONFIG_QUANT
    from repro_torch.core.rsnn import Presets

    chip_max = Presets.braille(n_in=256, n_hid=256, n_out=16, quantized=True)
    return [("T=128 B=1", CONFIG_QUANT, 128, 1), ("T=256 B=1", CONFIG_QUANT, 256, 1),
            ("END_B T=128 B=70", CONFIG_QUANT, 128, 70),
            ("cue 40/100/2 T=150 B=8", Presets.cue_accumulation(quantized=True), 150, 8),
            ("256/256/16 T=128 B=4", chip_max, 128, 4)]


def _digest(tensors) -> str:
    """sha1 of the tensors' bytes, in order: two trees' outputs compare bit
    for bit by this string."""
    import hashlib

    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _tree_exact(dev):
    """``--time-tree``'s rsnn_train_exact rows: at each of
    :func:`_exact_tree_shapes`, under the boxcar and the triangular
    surrogate, on inputs made from a seed (the same on every tree), the
    median of three profiler readings with its time by kernel, rsnn_forward
    at the same shape and surrogate (the LIF chain's yardstick: the same
    input sums, chain and readout, no walks), and the digest of the
    launch's dw, acc_y and n_spk (at the END_B tile also of its codes on
    the commit grid), so that two trees' kernels compare bit for bit."""
    from repro_torch.core.quant import DW_COMMIT_SPEC as G
    from repro_torch.kernels import eprop_update as E
    from repro_torch.kernels import rsnn_step as K
    from repro_torch.kernels import traffic

    out = {}
    for i, (name, base, T, B) in enumerate(_exact_tree_shapes()):
        gen = torch.Generator().manual_seed(SEED + 40 + i)
        cfg, args, kw = _exact_case(gen, base, T, B, dev, "backend")
        N, H, O = cfg.n_in, cfg.n_hid, cfg.n_out
        for sname, fields in (("boxcar", {}), SURROGATE_CASES[0]):
            k = dict(kw, **fields)
            got = E.rsnn_train_exact_cuda(*args, **k)
            z = K.rsnn_forward_cuda(args[0], *args[3:6], **{n: k[n] for n in FORWARD_KW})["z"]
            flops = traffic.train_exact_event_flops(
                T, B, N, H, O, int(args[0].count_nonzero()), int(z.count_nonzero()),
                int(z[:-1].count_nonzero()))
            nbytes = traffic.train_exact_bytes(T, B, N, H, O)
            row = {"digest": _digest(got),
                   "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3}
            if name.startswith("END_B"):
                row["codes_digest"] = _digest(E.rsnn_train_exact_cuda(*args, **k,
                                                                      commit_grid=G)[:3])
            row["ms"], row["by_kernel"] = _median_reading(
                lambda: E.rsnn_train_exact_cuda(*args, **k), iters=20)
            row["forward_ms"] = _median_reading(lambda: K.rsnn_forward_cuda(
                args[0], *args[3:6], **{n: k[n] for n in FORWARD_KW}), iters=20)[0]
            if hasattr(E, "exact_clock_shape"):
                row["roles"] = _exact_roles(E, K, args, k)
            out[f"{name} {sname}"] = row
    return out


def _train_tree_shapes():
    """The shapes ``--time-tree`` times rsnn_train at: name, config, T, B
    (quantized; END_S's commit at T=128 and (am)'s at T=256, the END_B
    tile, the chip-maximum net and a Braille row past T=424, both on the
    device-scratch route)."""
    from repro_torch.configs.reckon_braille import CONFIG_QUANT
    from repro_torch.core.rsnn import Presets

    chip_max = Presets.braille(n_in=256, n_hid=256, n_out=16, quantized=True)
    return [("T=128 B=1", CONFIG_QUANT, 128, 1), ("T=256 B=1", CONFIG_QUANT, 256, 1),
            ("END_B T=128 B=70", CONFIG_QUANT, 128, 70),
            ("256/256/16 T=128 B=8", chip_max, 128, 8),
            ("T=512 B=1", CONFIG_QUANT, 512, 1)]


def _tree_train(dev):
    """``--time-tree``'s rsnn_train rows: at each of
    :func:`_train_tree_shapes`, under the boxcar and the triangular
    surrogate, on inputs made from a seed (the same on every tree), the
    median of three profiler readings with its time by kernel, the digest
    of the launch's dw, acc_y and n_spk (at the END_B tile also of its
    codes on the commit grid), so that two trees' kernels compare bit for
    bit, and the role split of :func:`_train_roles` (null for a tree whose
    wrapper takes no ``clocks=``)."""
    import inspect

    from repro_torch.core.quant import DW_COMMIT_SPEC as G
    from repro_torch.kernels import eprop_update as E
    from repro_torch.kernels import rsnn_step as K

    clocked = "clocks" in inspect.signature(E.rsnn_train_cuda).parameters
    out = {}
    for i, (name, base, T, B) in enumerate(_train_tree_shapes()):
        gen = torch.Generator().manual_seed(SEED + 60 + i)
        cfg, args, kw = _exact_case(gen, base, T, B, dev, "backend")
        for sname, fields in (("boxcar", {}), SURROGATE_CASES[0]):
            k = dict(kw, **fields)
            row = {"digest": _digest(E.rsnn_train_cuda(*args, **k))}
            if name.startswith("END_B"):
                row["codes_digest"] = _digest(E.rsnn_train_cuda(*args, **k, commit_grid=G)[:3])
            row["ms"], row["by_kernel"] = _median_reading(
                lambda: E.rsnn_train_cuda(*args, **k), iters=20)
            row["plan"] = str(K.train_plan(T, cfg.n_in, cfg.n_hid, cfg.n_out,
                                           **({"B": B} if "B" in inspect.signature(
                                               K.train_plan).parameters else {})))
            row["roles"] = _train_roles(E, args, k) if clocked else None
            out[f"{name} {sname}"] = row
            log(f"--time-tree rsnn_train {name} {sname}: {row['ms']} ms, roles "
                f"{row['roles']}")
    return out


def _train_roles(E, args, kw):
    """How one rsnn_train launch's time splits by role, from the kernel's
    clock64() readings for row 0: the leader block's setup (staging, the
    barriers and the input currents), chain, xbar filter, pbar/zbar filters and readout, each with its cycles and its
    start after the setup's start; the F walk and the dw sums of the first
    block that runs them (the leader where a row is one block, else block
    1, whose starts count from its mirror's start on its own SM's clock);
    block 1's mirror; the span from the setup's start to the last end on
    the leader's clock; the SM clock in MHz beside them."""
    clocks = torch.zeros((len(E.TRAIN_CLOCK_ROLES), 2), dtype=torch.int64,
                         device=args[0].device)
    E.rsnn_train_cuda(*args, **kw)
    E.rsnn_train_cuda(*args, **kw, clocks=clocks)
    torch.cuda.synchronize()
    c = clocks.cpu().double()
    on_leader = not bool(c[7].gt(0).all())     # no block 1: one block a row
    t0 = {True: float(c[0, 0]), False: float(c[7, 0])}
    out, last = {}, float(c[0, 0])
    for r, role in enumerate(E.TRAIN_CLOCK_ROLES):
        start, end = float(c[r, 0]), float(c[r, 1])
        if start <= 0 or end <= 0:
            continue     # a role this launch does not run
        leader = r < 5 or (r < 7 and on_leader)
        out[role] = {"cycles": end - start, "start": start - t0[leader]}
        if leader:
            last = max(last, end)
    out["span_cycles"] = last - float(c[0, 0])
    sm = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                        capture_output=True, text=True, timeout=60).stdout.strip()
    out["sm_clock"] = sm
    return out


def _tree_exact_epoch(dev):
    """``--time-tree``'s exact END_S epoch: (al)'s one epoch of quantized
    END_S learning on Braille AEU (seed LEARN_SEEDS[0]) in exact mode →
    the digest of the learned weights, the test accuracy and the
    rsnn_train_exact launches, so that two trees' learning compares bit for
    bit."""
    from repro_torch.configs.reckon_braille import QUANT_OPT
    from repro_torch.core.controller import ControllerConfig, OnlineLearner
    from repro_torch.core.rsnn import Presets
    from repro_torch.data.braille import make_braille_dataset
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.kernels import ops

    data = make_braille_dataset("AEU")
    T = data["train"]["num_ticks"]
    base = Presets.braille(n_classes=3, num_ticks=T, quantized=True)
    cfg = dataclasses.replace(base, eprop=dataclasses.replace(base.eprop, mode="exact"))
    opt = dataclasses.replace(QUANT_OPT, decay_tau=25.0 * data["train"]["events"].shape[0])
    pipe = make_pipeline("arm", data, samples_per_batch=70, device=dev)
    learner = OnlineLearner(cfg, ControllerConfig(num_epochs=1, eval_every=1, commit="sample"),
                            opt, LEARN_SEEDS[0], device=dev)
    ops.reset_launch_counts()
    learner.fit(pipe)
    test = learner.eval_epoch(pipe, 0, "test")
    return {"weights_digest": _digest([learner.weights[k] for k in sorted(learner.weights)]),
            "test_acc": test, "launches": ops.launches["rsnn_train_exact"]}


def _exact_roles(E, K, args, kw):
    """How one rsnn_train_exact launch's time splits by role (the first
    cluster's chain, input warp, readout warp, leader walker warp and block
    1's warp, from the kernel's clock64() readings): per role the mean
    cycles of work a tick block and the mean cycles it waited between two
    blocks, and the chain's cycles from its first block's start to its last
    block's end; the SM clock in MHz beside them."""
    T, B, N = args[0].shape
    H, O = args[4].shape[0], args[5].shape[1]
    plan = K.train_exact_plan(T, N, H, O, B)
    clocks = torch.zeros(E.exact_clock_shape(T, plan), dtype=torch.int64,
                         device=args[0].device)
    E.rsnn_train_exact_cuda(*args, **kw)
    E.rsnn_train_exact_cuda(*args, **kw, clocks=clocks)
    torch.cuda.synchronize()
    c = clocks.cpu().double()
    out = {}
    for r, role in enumerate(E.EXACT_CLOCK_ROLES):
        start, end = c[r, :, 0], c[r, :, 1]
        if not bool((end > 0).all()):
            continue     # block 1 only where a row spans a cluster
        out[role] = {"work_cycles": float((end - start).mean()),
                     "wait_cycles": float((start[1:] - end[:-1]).mean()) if T > plan.ticks
                     else 0.0}
    out["chain_cycles"] = float(c[0, -1, 1] - c[0, 0, 0])
    sm = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                        capture_output=True, text=True, timeout=60).stdout.strip()
    out["sm_clock"] = sm
    return out


# Tensor-core and copy instructions whose counts --time-tree reports per
# kernel: wgmma, mma.sync, TMA tensor loads, bulk copies.
SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "UBLKCP")


def _sass_digests(build):
    """A digest of each kernel's SASS instructions in the library that
    ``build`` (a tree's kernels.build module) loaded, by kernel name with
    the anonymous namespace's per-file hashes taken out, and the counts of
    ``SASS_OPS`` in each kernel that has any; empty when no ``cuobjdump``
    is found."""
    import hashlib
    import re

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    libs = sorted(build.BUILD_DIR.glob("librsnn_kernels-*.so"), key=lambda p: p.stat().st_mtime)
    if not libs or not Path(tool).exists():
        return {}, {}
    sass = subprocess.run([tool, "-sass", str(libs[-1])], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    code, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_(\d+_\w+?_cu)_[0-9a-f]{8}", r"_GLOBAL__N__\1",
                          m.group(1))
            code[name] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(.*?;)", line)
        if name and m:
            code[name].append(m.group(1))
    digests = {n: hashlib.sha1("\n".join(ins).encode()).hexdigest()[:16]
               for n, ins in code.items()}
    def opcode(ins):   # the instruction's name, past a predicate such as @P0
        words = ins.split()
        return words[words[0].startswith("@")].split(".")[0]

    ops = {n: {op: sum(opcode(i) == op for i in ins) for op in SASS_OPS}
           for n, ins in code.items()}
    return digests, {n: c for n, c in ops.items() if any(c.values())}


def learn_walls(root: Path, dev) -> None:
    """``--learn-walls ROOT``: (h)'s learning runs through the learner of
    the checkout at ``ROOT``, in a process that runs nothing else: every
    seed of :data:`LEARN_SEEDS`, a 12-epoch END_B run and an END_S run in
    (h)'s order, each with its wall, its test accuracy and the digest of
    its learned weights, so that two trees' learning compares on one card
    in one call, bit for bit; and the host's µs a call of the tree's
    rsnn_train at END_S's commit and the END_B tile (:func:`_host_us`: the
    wrapper, the plan and the launch, the card idle at the start).  Prints
    one JSON line: the first seed's walls (``wall_s``), the median walls
    and accuracies, every run and the host µs."""
    from repro_torch.configs.reckon_braille import QUANT_OPT
    from repro_torch.core.controller import ControllerConfig, OnlineLearner
    from repro_torch.core.rsnn import Presets
    from repro_torch.data.braille import make_braille_dataset
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.kernels import build

    build.library()
    data = make_braille_dataset("AEU")
    T = data["train"]["num_ticks"]
    cfg = Presets.braille(n_classes=3, num_ticks=T, quantized=True)
    opt = dataclasses.replace(QUANT_OPT, decay_tau=25.0 * data["train"]["events"].shape[0])
    pipe = make_pipeline("arm", data, samples_per_batch=70, device=dev)
    runs = {}
    for seed in LEARN_SEEDS:
        for mode, commit in (("END_B", "batch"), ("END_S", "sample")):
            learner = OnlineLearner(cfg, ControllerConfig(
                num_epochs=LEARN_EPOCHS, eval_every=LEARN_EPOCHS, commit=commit),
                opt, seed, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            learner.fit(pipe)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[f"{seed} {mode}"] = {
                "wall_s": wall, "test_acc": learner.eval_epoch(pipe, 0, "test"),
                "weights_digest": _digest([learner.weights[k]
                                           for k in sorted(learner.weights)])}
    from repro_torch.configs.reckon_braille import CONFIG_QUANT
    from repro_torch.kernels import eprop_update as E

    host_us = {}
    for B in (1, 70):
        _, args, kw = _exact_case(torch.Generator().manual_seed(SEED + 60), CONFIG_QUANT, 128,
                                  B, dev, "backend")
        host_us[f"rsnn_train B={B}"] = _host_us(lambda: E.rsnn_train_cuda(*args, **kw))
    modes = ("END_S", "END_B")
    print(json.dumps({
        "tree": str(root), "card": card_line(), "host_us_a_call": host_us,
        "wall_s": {m: runs[f"{LEARN_SEEDS[0]} {m}"]["wall_s"] for m in modes},
        "median_wall_s": {m: float(np.median([runs[f"{s} {m}"]["wall_s"]
                                               for s in LEARN_SEEDS])) for m in modes},
        "median_test_acc": {m: float(np.median([runs[f"{s} {m}"]["test_acc"]
                                                 for s in LEARN_SEEDS])) for m in modes},
        "runs": runs}), flush=True)


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] in ("--time-tree", "--learn-walls"):
        root = Path(sys.argv[2]).resolve()
        setup(root)
        run = tree_times if sys.argv[1] == "--time-tree" else learn_walls
        run(root, torch.device("cuda", 0))
        return
    if len(sys.argv) != 1:
        fail("usage: python3 chip_smoke.py [--time-tree CHECKOUT | "
             "--learn-walls CHECKOUT]")
    root = Path(__file__).resolve().parent
    setup(root)
    dryruns = start_dryruns(root)     # (aj)'s fake worlds, on the CPU meanwhile
    from repro_torch.configs.reckon_braille import CONFIG_QUANT
    from repro_torch.core.rsnn import init_params
    from repro_torch.kernels import ops
    from repro_torch.serve import batching

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    phase_build()
    errs = phase_kernels_vs_plain(dev)

    params = init_params(torch.Generator().manual_seed(SEED), CONFIG_QUANT,
                         device=dev)
    reqs, density = _requests()
    log(f"requests: {len(reqs)} Braille samples, event density {density:.4f}")
    serving = ("rsnn_infer", "rsnn_step_sessions")
    ops.reset_launch_counts()
    served, stats = phase_serve(dev, params, reqs)
    phase_sessions(dev, params, reqs, served)
    launches = {k: ops.launches[k] for k in serving}
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was never launched on the serving path")
    log(f"(e) ok: launches on the serving path {dict(ops.launches)}")

    errs.update(phase_train_kernels_vs_plain(dev))
    learning = ("rsnn_infer", "rsnn_step_sessions", "rsnn_forward", "rsnn_train",
                "eprop_update")
    ops.reset_launch_counts()
    phase_learning(dev)
    learn_launches = dict(ops.launches)
    for name in learning:
        if learn_launches[name] <= 0:
            fail(f"kernel {name} was never launched on the learning path")
    log(f"(h) ok: launches on the learning path {learn_launches}")
    launches.update({k: learn_launches[k] for k in learning if k not in serving})
    by_path = {k: {"serve": launches.get(k, 0) if k in serving else 0,
                   "learning": learn_launches[k]} for k in ops.KERNELS}
    lws_launches, _, lws_image = phase_learn_while_serve(dev)   # resets the counts itself
    for k in lws_launches:
        by_path[k]["learn_while_serve"] = launches[k] = lws_launches[k]
    ft_launches, ft_worker_launches = phase_fault_tolerance(dev)   # resets them too
    by_path["rsnn_train"]["fault_tolerance"] = ft_launches
    by_path["rsnn_train"]["fault_tolerance_workers"] = ft_worker_launches
    dp_launches, grid_row = phase_data_parallel(dev)     # resets them too
    for k, n in dp_launches.items():
        by_path[k]["data_parallel"] = n
    mesh_launches, mesh_row = phase_engine_over_mesh(dev, lws_image)   # resets them too
    for k, n in mesh_launches.items():
        by_path[k]["engine_over_mesh"] = n
    phase_examples()
    dry_launches, dry_row = phase_dryrun(dev, root, dryruns)
    for k, n in dry_launches.items():
        by_path[k]["dryrun_real_step"] = n
    local_launches, _ = phase_mesh_local(dev, root, [p for p in dryruns if p[0] == "grouped"])
    for k, n in local_launches.items():
        by_path[k]["mesh_local"] = n
    errs["rsnn_train_exact"] = phase_exact_vs_plain(dev)
    exact_launches, exact_summary = phase_exact_learning(dev)   # resets the counts itself
    for k, n in exact_launches.items():
        by_path[k]["exact_learning"] = n
    launches["rsnn_train_exact"] = exact_launches["rsnn_train_exact"]
    t_am = time.perf_counter()
    for k, e in phase_surrogate_vs_plain(dev).items():
        errs[k] = max(errs[k], e)
    sur_launches, sur_summary = phase_surrogate_learning(     # resets the counts itself
        dev, exact_summary["factored"]["test_acc"])
    for k, n in sur_launches.items():
        by_path[k]["surrogate"] = n
    log(f"(am) ok in {time.perf_counter() - t_am:.1f} s")
    # the timing phases use torch.profiler: they run after the learning
    # run, so that its wall is taken before any profiler session
    b_tile = batching.padded_batch_size(len(reqs), batching.max_batch_for(CONFIG_QUANT))
    rows = phase_timing(dev, params, b_tile)
    rows.update(phase_train_timing(dev))
    rows.update(phase_exact_timing(dev))
    sur_rows = phase_surrogate_timing(dev)

    errs["flash_attention"] = phase_flash_vs_plain(dev)
    lm_launches = phase_lm(dev)     # resets and reads the counts itself
    launches["flash_attention"] = lm_launches["flash_attention"]
    by_path["flash_attention"]["lm"] = lm_launches["flash_attention"]
    torch.cuda.empty_cache()
    rows["flash_attention"] = phase_flash_timing(dev)

    errs["flash_attention_bwd"] = phase_flash_bwd_vs_plain(dev)
    torch.cuda.empty_cache()
    train_launches, q_summary = phase_lm_train(dev)     # resets and reads the counts
    for k in ("flash_attention", "flash_attention_bwd"):
        by_path[k]["lm_train"] = train_launches[k]
    launches["flash_attention_bwd"] = train_launches["flash_attention_bwd"]
    torch.cuda.empty_cache()
    rows["flash_attention_bwd"], fwd_lse = phase_flash_bwd_timing(dev)
    rows["flash_attention"]["with_lse"] = fwd_lse
    torch.cuda.empty_cache()

    mla_f_err, mla_b_err = phase_mla_flash_vs_plain(dev)
    errs["flash_attention"] = max(errs["flash_attention"], mla_f_err)
    errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], mla_b_err)
    torch.cuda.empty_cache()
    moe_launches, _ = phase_moe_serve(dev)       # resets and reads the counts itself
    by_path["flash_attention"]["moe_serve"] = moe_launches["flash_attention"]
    moe_train_launches, _ = phase_moe_train(dev)     # resets them too
    for k in ("flash_attention", "flash_attention_bwd"):
        by_path[k]["moe_train"] = moe_train_launches[k]
    torch.cuda.empty_cache()
    summaries = {}
    for path, phase in (("mamba_serve", phase_mamba_serve),
                        ("mamba_train", phase_mamba_train),
                        ("jamba_serve", phase_jamba_serve),
                        ("vlm_serve", phase_vlm_serve),
                        ("audio_serve", phase_audio_serve),
                        ("audio_train", phase_audio_train),
                        ("lm_train_compressed", phase_compressed_train),
                        ("gpipe", phase_gpipe),
                        ("moe_grouped", phase_moe_grouped)):
        path_launches, summaries[path] = phase(dev)    # each resets and reads the counts
        for k in ops.KERNELS:
            by_path[k][path] = path_launches[k]
        torch.cuda.empty_cache()
    aa = summaries.pop("lm_train_compressed")
    for path, phase in (("lm_train_sharded", lambda d: phase_sharded_train(
                            d, q_summary["step_s"])),
                        ("lm_train_compressed_sharded", lambda d: phase_compressed_sharded(d, aa)),
                        ("moe_expert_parallel", phase_moe_expert_parallel),
                        ("lm_train_unscanned", phase_unscanned_train)):
        path_launches, summaries[path] = phase(dev)
        for k in ops.KERNELS:
            by_path[k][path] = path_launches[k]
        torch.cuda.empty_cache()
    del aa
    rows["flash_attention"]["mla"], rows["flash_attention_bwd"]["mla"] = (
        phase_mla_flash_timing(dev))
    rows["flash_attention"]["xattn"] = phase_xattn_flash_timing(dev)

    card = card_line()
    sources = {"rsnn_infer": "rsnn_serve.cu", "rsnn_step_sessions": "rsnn_serve.cu",
               "rsnn_forward": "rsnn_train.cu", "rsnn_train": "rsnn_train.cu",
               "eprop_update": "rsnn_train.cu", "rsnn_train_exact": "rsnn_train.cu",
               "flash_attention": "flash_attention.cu",
               "flash_attention_bwd": "flash_attention_bwd.cu"}
    replaces = {"rsnn_infer": "src/repro/kernels/rsnn_step.py:703",
                "rsnn_step_sessions": "src/repro/kernels/rsnn_step.py:963",
                "rsnn_forward": "src/repro/kernels/rsnn_step.py:399",
                "rsnn_train": "src/repro/kernels/eprop_update.py:202",
                "eprop_update": "src/repro/kernels/eprop_update.py:96",
                "rsnn_train_exact": "src/repro/core/eprop.py:150 (run_sample_exact under "
                                    "the scan backend; no Pallas kernel)",
                "flash_attention": "src/repro/kernels/flash_attention.py:30",
                "flash_attention_bwd":
                    "src/repro/models/attention.py:49 (jax.grad of blocked_attention)"}
    kernels = []
    for name in ops.KERNELS:
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{sources[name]}",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "shape": r["shape"],
            "launches_by_path": by_path[name],
        })
        if name == "rsnn_step_sessions":
            kernels[-1]["engine_over_mesh"] = mesh_row
        if name == "rsnn_train":
            kernels[-1]["end_s"] = rows["rsnn_train END_S"]
            kernels[-1]["commit_grid"] = grid_row
        if name == "rsnn_train_exact":
            kernels[-1]["end_s"] = rows["rsnn_train_exact END_S"]
            kernels[-1]["end_b"] = rows["rsnn_train_exact END_B"]
            kernels[-1]["learning"] = exact_summary
        if name == "rsnn_forward":
            kernels[-1]["other_batches"] = [rows["rsnn_forward B=1"],
                                            rows["rsnn_forward B=2048"]]
        if name in sur_rows:
            kernels[-1]["triangular"] = {
                "source": "src/repro_torch/kernels/csrc/rsnn_train_tri.cu",
                "timing": sur_rows[name]}
            if name == "rsnn_train":
                kernels[-1]["triangular"]["learning"] = sur_summary
        if name == "flash_attention":
            kernels[-1]["with_lse"] = r["with_lse"]
            kernels[-1]["xattn"] = r["xattn"]
        if name == "flash_attention_bwd":
            kernels[-1]["other_shapes"] = r["other_shapes"]
        if name in ("flash_attention", "flash_attention_bwd"):
            kernels[-1]["mla"] = r["mla"]
            kernels[-1]["dryrun"] = dry_row
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
