#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # from the repository root

Phases (any failure raises and the script exits non-zero):

  1. the card (``nvidia-smi``), torch and CUDA versions;
  2. build every CUDA source under ``src/repro_torch/kernels/csrc`` with
     ``nvcc`` (all sources at once), print the seconds and the ptxas report
     (for the flash forward and backward sources, each instantiation's
     registers and spills; none may spill in the wgmma sources, *_sm90);
  3. hold each kernel against its plain PyTorch version on the card, time
     both with CUDA events, compute the least time the card could take
     (``bound_ms``) and time one PyTorch call computing the same function
     where there is one (``library_ms``):
       - fused_stats / fused_apply at the ResNet-18 slab shape (22,016 x
         512, 11 layers, f32), at EfficientNet-B0's (7,936 x 512, 21
         layers, f32), at the LM training slab (smollm-135m's 134.5 M
         parameters under ``lm_grouping``, 32 layers, the bf16 gradient
         and copy of that path) and over every fused_apply variant,
         bitwise;
       - qdq_cast, both forms (two-pass: the absmax found in the call;
         one-pass: given), over every variant and edge case (offsets 0-7
         elements, sizes 0-17 and 1,048,579, f32/bf16 in and out, NaN
         and inf, ten repeats) and over all of smollm-135m's leaves (the
         serving path's tier-0 cast), bitwise; each form one device
         operation a call; timed f32 and bf16 out, beside the cast then
         ``.to(bf16)`` and a copy;
       - flash_attention, the three routes (``flash_attention.fwd_route``):
         the tensor-core kernel (bf16) over every variant (causal, not
         causal, window, segments; GQA rep 1 and 3; (D, Dv) in (16, 16),
         (64, 64), (128, 128), (192, 192), (256, 256), (192, 128)) and at
         the main paths' shapes (B 1, 2, 4, 8, S 1024, 9/3 heads, head_dim
         64, with the LSE); the split-TF32 kernel (f32) over every variant,
         GQA rep 1-3 and (D, Dv) in (16, 16), (64, 64), (64, 32), (32, 64),
         (8, 8), (128, 128), (192, 128), (256, 256), its shared memory
         against the source's; the SIMT kernel (bf16 at 24 and 40, which
         its route takes; f32 at head dims 16 and 64 through its raw entry)
         over every variant at the test shapes; the tensor-core and SIMT
         kernels timed at the serving prefill's shape (B 1, S 1024) beside
         SDPA; in f32 at B 1 and B 8 the split-TF32 and SIMT kernels in
         turns beside SDPA's f32 forward and both bounds (3xTF32,
         f32-FMA), and at B 8 the f32 forward + backward through
         ``ops.flash_attention`` beside SDPA's;
       - flash_decode (the split-key kernel, a cluster of
         ``DECODE_CLUSTER`` blocks a row and kv head) over ragged lengths
         (0, 1, L, between, and the split's edges), head dims (16, 64,
         (64, 32), (256, 256), (20, 36)), rep 1 and rep * Dv 2048, B 1, 2,
         4 at L 2048, f32 and bf16, and at the main path's decode (4 rows
         against a 2048-slot cache; a bitwise repeat; cluster sizes 4, 8,
         16 timed, log only);
       - delta over Dv 16, 36, 40, 64, 128, 256 (f32 and bf16) and at the
         LM rungs, each call repeated bitwise;
       - the three flash backward kernels (delta, dQ, dK/dV), all three
         routes (``flash_attention.bwd_route``: bf16 takes the tensor-core
         dQ and dK/dV, f32 the split-TF32 ones, bf16 at head dims 24/64
         and 64/40 the SIMT ones; every f32 variant also runs the SIMT
         kernels through their raw entry) over every variant, at the wide
         head dims (192, 192), (256, 256), (192, 128) (the SIMT and
         split-TF32 kernels on 32-row tiles; every mask, f32 and bf16; the
         bf16 routes timed at head dim 256, B 1, S 1024 beside SDPA, log
         only), and with the forward kernel (LSE output on) at the LM
         training shapes (B 2, 4 and 8, S 1024, 9/3 heads, head_dim 64,
         bf16, causal), timed at B 8 against the forward and the backward
         of ``scaled_dot_product_attention`` (the forward's SIMT kernel,
         and the SIMT dQ and dK/dV on the same bf16 inputs, beside them;
         then in f32 the split-TF32 and the SIMT dQ and dK/dV in turns,
         beside SDPA's f32 backward); the differentiable
         ``ops.flash_attention`` against autograd through the plain
         forward in f32 and in bf16, head dim 256 included, its launches
         counted by route (the f32 runs' split-TF32 forward, dQ and dK/dV
         launches go into the ``_tf32`` rows as
         ``f32_function_launches``);
       - grad_stats over the reference's test shapes (f32, bf16), its
         benchmark's (1024, 1024) and its registry's (1,000,000,) f32, an
         empty tensor and tensors holding NaN, +inf, -inf; absmax bitwise,
         sums within 2^-20 of the sum of |terms| of an f64 sum, two
         launches bitwise equal; timed at (1024, 1024) f32;
  4. correctness of whole steps: one slab-resident train step of each of
     ResNet-18 and EfficientNet-B0 at batch 4, one §3.2 ``hutchinson``
     refresh of EfficientNet-B0 (b_curv 4, the same probe), one prefill
     plus 4 teacher-forced decode steps of smollm-135m at full width and 2
     layers, and one slab-resident LM train step of smollm-135m at full
     width and 2 layers (S 1024, B 2), and one reference step (tree-form,
     unfused) of each of ResNet-18 and EfficientNet-B0 at batch 2 and
     smollm-135m at 2 layers, each on the card against the same on the
     CPU (plain versions), from the same weights;
  5. the main paths, with the kernels' launch counts read around each:
       - ``run_method("triaccel", "resnet18", steps=50, batch0=32)`` and
         the same for ``"efficientnet_b0"`` (``EFF_STEPS``); then a
         ``Trainer`` of EfficientNet-B0 with ``TriAccelConfig()``'s
         default ``hutchinson`` curvature (``t_curv`` lowered to 5) for 6
         steps, whose refresh must set a finite, non-zero curvature;
       - serving: ``ServeSession`` over smollm-135m at full width (30
         layers), prompt 1024, cache 2048, rungs 1/2/4, tiers 1 then 0,
         eight requests of 64 tokens in two waves; the launch counts must
         equal 30 x prefills (flash_attention, every one on the
         tensor-core route), 30 x decode steps (flash_decode) and the
         tier-0 leaves (qdq_cast, two-pass), and no attention gate may
         fall back;
       - LM training: ``repro_torch.launch.train.main`` for smollm-135m at
         30 layers, S 1024, rungs 2/4/8, 20 steps (``LM_TRAIN_ARGS``,
         t_ctrl / t_curv lowered to 5 / 10 so both controls fire); the
         counts must equal 2 x 30 forward launches (forward and remat
         recompute, all on the tensor-core route, none on the split-TF32
         or SIMT ones) and 30 of each backward
         kernel a step (dQ and dK/dV all on the tensor-core route); then
         the tier-0 serving set of the trained masters from
         ``Trainer.serving_amax_tree`` (qdq_cast, one-pass, one launch a
         leaf, bitwise against the plain version);
  6. where the time goes: ``torch.profiler`` over a few ResNet-18 and
     EfficientNet-B0 train steps (Tri-Accel and FP32), over one serving
     step that admits four prompts (the prefill),
     over a few decode steps at rung 4 and over one LM train step at rung
     8; the LM step time per rung;
  7. the reference step's main paths, with the launch counts read around
     each: ``run_method("fp32", "resnet18" | "efficientnet_b0", steps=20,
     batch0=32)`` (no fused-update launch, codes reported fp32, the rung
     fixed at 32; EfficientNet-B0's step time and peak printed beside its
     Tri-Accel ones and the paper's 0.301 GB FP32 point) and
     ``launch.train.main`` with ``--no-triaccel`` for smollm-135m at 30
     layers, S 1024, rung 8, 10 steps (2 x 30 forward, on the tensor-core
     route, and 30 of each backward kernel a step, dQ and dK/dV on the
     tensor-core route, no fused update); then
     grad_stats' path, its
     public op over every leaf of each path's reference-step gradient
     tree (f32, after the loss-scale division), counted around those calls
     and held against the plain version, timed on the largest leaf
     (smollm-135m's (49152, 576) embedding) and, for EfficientNet-B0,
     over all 181 leaves in turn;
  8. checkpoint, resume and preemption (``repro_torch.checkpoint``, the
     reference's on-disk format): the Tri-Accel ResNet-18 trainer with a
     checkpoint directory for 20 steps (a generation every 10, 2 kept);
     a fresh trainer restores on the card bitwise (every slab, padding
     included, the control and BatchNorm state, the serving absmax table),
     and a CPU trainer too; both card trainers take 5 more steps (the
     restored one launching fused_stats and fused_apply once a step) and
     their losses agree (bitwise where the card's step is deterministic,
     else within rtol 1e-3); the keep-2 collection; a CPU-written
     generation restored on the card bitwise. Then smollm-135m through
     ``launch.train.main(LM_TRAIN_ARGS + ["--ckpt", dir])``: SIGTERM in
     step 9 makes the first call checkpoint and exit with 143, the same
     call again prints ``resumed at step 10`` and takes the last 10 steps
     (the flash forward, its three backward kernels and the fused update
     counted around it). For each model: the bytes of one generation, the
     host stall of ``save()``, the background write and ``maybe_restore``
     on the card, printed beside the card's name and power limit. The
     checkpoints go to a temporary directory that the phase removes;
  9. faults and recovery (``repro_torch.resilience``, the ``Trainer``'s
     recovery loop): fused_stats and fused_apply on a burst step's input
     at the ResNet-18 slab (a gradient of +-inf and NaN only, the finite
     flag 0), bitwise against the plain versions; the reference soak's
     trainer plan (``fault_plan``) through the harness's Tri-Accel
     ResNet-18 trainer at rungs (16, 32) from 32, 24 steps, a generation
     every 4, the watchdog on (3 non-finite steps, 2 rollbacks): an
     injected OOM at step 3 steps rung 32 down, a burst at steps 9-11 is
     skipped with the master and momentum slabs and BatchNorm state
     bitwise and rolled back with ``lr_demote`` 0.5 and a finite loss
     scale, SIGTERM at step 21 exits with 143 and its generation is torn;
     a restart falls back past it ("failed verification") and ends at
     step 24 with the demotion kept; fused_stats and fused_apply launch
     once for each dispatch that reached the step; the same plan on the
     CPU must give the same ``oom_events``, ``rollback_events``, fault
     log and restart. Then a real OOM, in a process of its own: the
     allocator capped
     (``set_per_process_memory_fraction``) halfway between the peaks that
     rungs 32 and 64 measure, a trainer at rungs (32, 64) from 64 with no
     plan catches the allocator's ``torch.OutOfMemoryError``, poisons 64
     and re-runs the batch at 32, and a trainer whose first step at 64
     the ``train.step_oom`` fault fails takes the same recovery uncapped;
     with cuDNN's deterministic algorithms for all of them, both recovered
     trainers' masters after 6 steps equal two fault-free oracles' at 32
     (bitwise where the oracles are, else within twice their spread).
     Printed beside the card's name and power limit:
     a rollback's cost (the writer's wait, the restore, the replayed
     steps), the injected and the real OOM step-down, and the step time
     at rung 32 with the watchdog off and on (medians of 10-step blocks
     in turns);
 10. serving faults and recovery (``ServeSession``'s OOM recovery, the
     soak): the reference soak's serving plan (``soak.serve_plan``: an
     OOM on rung 2 from step 4, one on rung 1 at tier 1 at step 10,
     latency spikes at 14 and 15) and ``ServeConfig`` (rungs 1/2, tiers
     0/1, 4 tokens) through a ``ServeSession`` over smollm-135m at full
     width and depth, prompt 1024, cache 2048, six requests: every
     request done or failed, the trail (steps, oom_events, poisoned,
     rung and tier history, fault log) equal to
     ``soak.serve_soak(device="cpu")`` run in the phase, no path run
     that ``warm()`` did not, and the launches exact (30
     ``flash_attention`` a prefill and 30 ``flash_decode`` a decode that
     reached the engine, the tier-0 leaves' two-pass ``qdq_cast``);
     ``soak.main`` on the card (both legs) exits 0; then a real OOM, in
     a process of its own with the allocator's expandable segments: a
     session at rungs (1, 2), prompt 1792, cache 2048, warmed uncapped,
     the allocator capped between what every rung-1 path needs (admit,
     decode, both repacks; from ``engine.measured``) and what a rung-2
     admit needs, eight requests of 16 tokens: the first decodes alone at
     rung 1, the other seven arrive, the climb to rung 2 moves its row,
     and the rung-2 admit fails: the allocator's
     ``torch.OutOfMemoryError`` is caught, (2, 1) poisoned, the rung
     stepped down through the repack that moves the live row back, the
     shed request requeued, all eight done with the tokens of two
     fault-free sessions at rung 1 (bitwise where they agree), the live
     one's included. Printed beside the card's name
     and power limit: the injected step-down, the tier demotion, a shed
     request's TTFT against an unshed one's, the real OOM's failed admit,
     its recovery and the retry, the phase's seconds;
 11. the rest of serving, its seconds printed against a 90 s target:
     (a) chunked prefill over smollm-135m at full width, 8 of its 30
     layers (``SERVE_REST_DEPTH``; ``CH_*``): four prompts of 17, 64,
     100 and 128 tokens in chunks of 16 through a session at rungs 1/2, tiers 0/1, an injected
     ``serve.step_oom`` failing a chunk at rung 2 (poison, step-down, the
     youngest shed and replayed), every request done, no path run after
     ``warm()``, no flash forward and one ``flash_decode`` launch a layer
     a decode step and a prompt token; the 128-token request's tokens
     against a whole-prompt session's (equal or a near-tie), and the
     first-token logits and cache rows of whole-prompt against chunked
     prefill within ``CH_TOL``; two chunk tokens profiled; (b) SLO
     traffic at the same depth: ``drive`` over a ``poisson_trace`` of two
     classes (``SLO_*``) through ``schedule="slo"``, chunk 16, rungs 1/2/4: no
     path run after ``warm()``, done plus rejected equal to the offered,
     the launches exact; the class report, TTFT p50/p99 by class, tok/s,
     the decode step by rung; (c) vision inference: ResNet-18 and
     EfficientNet-B0 sessions (``VIS_*``: rungs 16/32/64, tiers 2/1/0,
     gpu ladder, 96 eval images a tier in waves, an injected OOM at
     "infer") on the card and on the CPU from the same weights and
     BatchNorm statistics: the same trail, logits within ``VIS_TOL`` by
     tier, predictions equal but near ties, one one-pass ``qdq_cast`` a
     floating leaf of the tier-0 set; images/s and the peak bytes by
     (rung, tier);
 12. the dense GQA architectures (``DENSE``: stablelm-1.6b, minitron-4b,
     gemma3-4b), each in turn, its seconds and the phase's printed:
     first its kernels at its shapes against their plain versions, timed
     beside them, SDPA and the bounds: the tensor-core forward and the
     three backward kernels at B 2 and its training S (32/32 heads of 64,
     24/8 of 128, 8/4 of 256; gemma3-4b global and with its window of
     1024), flash_decode at B 4 against its full-length serving cache
     (rep 1 / D 64, rep 3 / D 128, rep 2 / D 256; gemma3-4b's local
     layers' plain decode attention on its 1024-slot ring timed too), and
     fused_stats / fused_apply on the training slab of the depth below
     (0.72-1.9 B elements; the plain versions chunk by chunk, the apply
     donated, bitwise); then training at full width through
     ``launch.train.main --arch ... --mem-cap-gb 80`` at the depth of
     ``DENSE_DEPTH`` (stablelm-1.6b 6 layers, minitron-4b 4, gemma3-4b
     one period and its 4 local, 10; their full-depth numbers are in
     PERF.md section 6) (``DENSE_STEPS`` steps, rungs 1/2, S 1024,
     gemma3-4b S 2048; the seconds of
     ``task.init``, the peak), its launches exact (the forward 2 x L a
     step on the tensor cores, delta, dQ and dK/dV L a step, one fused
     update a step); the two-pass qdq_cast on the trained model's largest
     leaf (786 M elements for minitron-4b) bitwise; serving the trained
     weights (``ServeSession(params=...)``, the trainer freed first) at
     full width and that depth, rungs 1/2/4, tiers 1 then 0, six requests
     of 32 tokens, prompt 1024 and cache 2048 (gemma3-4b 2048 and 4096: its
     local layers' rings wrap at prefill and again while decoding), its
     launches exact (the forward L a prefill on the tensor cores,
     flash_decode once a decode step for each unwindowed layer: 6, 4,
     1; a two-pass cast a leaf), a decode step profiled (gemma3-4b: the
     9 local layers' share of its device time); then a prefill and 4
     teacher-forced decode steps of the trained weights' first layers
     (2; gemma3-4b one period, 5 local and 1 global, prompt 1280) on the
     card against the CPU, logits within 4 %;
 13. MLA and MoE: deepseek-v2-lite-16b (``MOE``), its seconds and the
     phase's printed: first its kernels at its shapes against their plain
     versions, timed beside them, SDPA and the bounds: the tensor-core
     forward with the LSE and the three backward kernels at B 2, S 1024,
     16 heads, D 192 (128 nope + 64 rope) and Dv 128, and fused_stats /
     fused_apply on the slab of the dense layer and
     ``MOE_FUSED_MOE_LAYERS`` MoE layers (7: 4.6 B elements, past 2^32,
     bitwise, donated; untrained); then training at full width, cut in
     depth to the dense layer and ``MOE_TRAIN_MOE_LAYERS`` MoE layers (1; 7 is the
     most whose peak fits), through ``launch.train.main``
     with the cut config (``_registry_config``; the launcher has no depth
     flag): ten steps at
     rungs 1/2, S 1024, ``task.init`` seconds, the step time and the peak,
     launches exact (the forward 2 x L a step and delta, dQ and dK/dV L a
     step on the tensor cores, one fused update a step), the MoE aux
     terms finite and non-zero, one step profiled; then the full model's
     f32 masters (15.7 B parameters, 62.8 GB) drawn on the card's
     generator into host memory; the two-pass qdq_cast of one stacked
     expert leaf (26, 64, 2048, 1408), 4.8 G elements, bitwise against
     the plain version layer by layer under the leaf's one absmax;
     serving at full width and depth, 27 layers, one session a tier (tier
     1, then tier 0: two bf16 sets and a cast's f32 leaf do not fit the
     card together), each set built leaf by leaf from the host masters,
     rungs 1/2/4, six requests of 32 tokens, prompt 1024, cache 2048, its
     launches exact (the forward L a prefill on the tensor cores, no
     flash_decode: MLA decodes in the absorbed form, a two-pass cast a
     leaf of the tier-0 set), a decode step profiled and the MoE layer's
     and its dispatch's share of it; then a prefill and 4 teacher-forced
     decode steps through layers 0 (dense) and 1 (MoE) on the card
     against the CPU: the chosen experts equal except at near-ties
     (counted), logits within 4 %;
 14. the recurrent architectures (``recurrent_phase``, ``RECURRENT``):
     mamba2-370m (48 Mamba-2 SSD layers, no attention) and
     recurrentgemma-2b (8 x (RG-LRU, RG-LRU, local MQA at 10 / 1 heads of
     256, window 2048) + 2 RG-LRU). For each: its kernels against their
     plain versions at its shapes (the fused update on its whole slab;
     for recurrentgemma the tensor-core forward and the three backward
     kernels at B 2, S 4096, rep 10, D 256, window 2048, and the forward
     at the prefill's B 1, S 2048); training at full width through
     ``launch.train.main`` at full depth (mamba2 S 1024, rungs 2/4/8;
     recurrentgemma S 4096, rungs 1/2), ten steps, launches exact (the forward 2 x A a step and delta,
     dQ and dK/dV A a step for its A attention layers, one fused update a
     step), three more steps timed and one profiled; the trained weights
     served at full width and depth through ``ServeSession(params=...)``
     (mamba2: prompt 1024, cache 2048; recurrentgemma: prompt 2048, cache
     4096, so the 2048-slot rings wrap), rungs 1/2/4, tiers 1 then 0, six
     requests of 32 tokens, launches exact (the forward A a prefill, no
     flash_decode: no unwindowed attention cache, a two-pass cast a leaf
     of the tier-0 set), three decode steps profiled (device busy, host
     gaps, device operations a step); then a prefill and 4 teacher-forced
     decode steps through the first layers (mamba2's first 2,
     recurrentgemma's first period) on the card against the CPU, logits
     within 4 %.

A kernel that runs on several main paths at different shapes
(fused_stats and fused_apply: ResNet-18, EfficientNet-B0 and LM training;
flash_attention: serving and LM training; grad_stats: the gradient trees
of ResNet-18, EfficientNet-B0 and smollm-135m) has a row for each in the
``kernels`` line, the others named ``<kernel>@efficientnet_b0``,
``<kernel>@lm_train``, ``grad_stats@efficientnet_b0_reference`` and
``grad_stats@lm_reference``: its launches on that path beside its time at
that path's shape (``grad_stats@efficientnet_b0_reference``: one pass over
the 181 leaves, 181 launches). The reference paths make no
grad_stats launch themselves, as in the reference. The flash forward's
rows carry ``fwd_route``: ``flash_attention`` and
``flash_attention@lm_train`` are the tensor-core kernel, which the main
paths run; ``flash_attention_tf32`` the split-TF32 kernel of f32 callers
(no main path launches it; its ``f32_function_launches`` come from the
f32 autograd check), timed in f32 at B 1 with the TF32 bound
(``f32_fma_bound_ms`` beside it; ``simt_ms`` the SIMT kernel in the same
turns; the ``b8_*`` keys the same at B 8, ``b8_fwd_bwd_ms`` the f32
forward + backward and ``b8_library_fwd_bwd_ms`` SDPA's);
``flash_attention_simt`` the SIMT kernel (head dims the tensor-core
kernels refuse), timed in f32 through its raw entry in those turns. The
backward's dQ and dK/dV rows carry ``bwd_route`` (the same rule) the same
way: ``flash_attention_bwd_dq`` and
``flash_attention_bwd_dkv`` are the tensor-core kernels the LM paths run;
``flash_attention_bwd_dq_tf32`` and ``flash_attention_bwd_dkv_tf32`` the
split-TF32 kernels of f32 callers (no main path launches them; their
``f32_function_launches`` come from the f32 autograd check), timed in f32
with the TF32 bound (``f32_fma_bound_ms`` beside it);
``flash_attention_bwd_dq_simt`` and ``flash_attention_bwd_dkv_simt`` the
SIMT kernels (bf16 head dims the tensor-core kernels refuse), timed in
f32 as before. The ``fused_stats`` and ``fused_apply`` rows carry
``fault_path_launches``, their launches on phase 9's fault plan path;
the ``flash_attention``, ``flash_decode`` and ``qdq_cast`` rows theirs
on phase 10's serving plan path. ``flash_decode@chunked_prefill`` is the
decode kernel on phase 11's chunk paths (11a and 11b: B 1 a prompt
token, and their decode steps), timed at B 1 against a 128-slot cache;
``qdq_cast_one_pass@vision_serve`` the one-pass cast of phase 11c's
tier-0 vision weight sets, timed over both models' leaves. Phase 12 adds
``<kernel>@<arch>`` for each dense GQA architecture and each of
``DENSE_ROWS``: the launches of that model's training and serving paths
(the forward: both), the times at that model's shapes
(``window_1024_ms``: gemma3-4b's windowed shape; ``flash_decode`` with
``local_layer_device_ms`` and ``local_layers_share``). Phase 13 adds
``<kernel>@deepseek-v2-lite-16b`` for each of ``MOE_ROWS`` the same way
(no ``flash_decode``: MLA's decode launches none). Phase 14 adds
``<kernel>@mamba2-370m`` (the fused update and the tier-0 cast: no
attention runs on the model) and ``<kernel>@recurrentgemma-2b`` (those
and the flash forward and backward, ``prefill_ms`` the forward at the
prefill's shape).
``qdq_cast`` is the two-pass form the serving path launches,
``qdq_cast_one_pass`` the one-pass form the LM path's tier-0 set launches, both timed over the 11 leaves, f32 in
and bf16 out as those paths cast (``f32_out_*``: the same with f32 out).
The ``flash_decode``, ``flash_attention_bwd_delta``, both ``qdq_cast``,
every ``fused_stats`` and ``fused_apply`` and the
``grad_stats@efficientnet_b0_reference`` rows also carry ``device_ms``, the
kernel's device time from the profiler
(``flash_decode`` also SDPA's, ``library_device_ms``): their ``ms``, from
CUDA events over back-to-back launches, can include the card's waits for
the host's launches.

The whole script's seconds are printed before the last three lines,
which are the ``kernels`` JSON line, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Without a card (or
outside a checkout of the repository) it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
import json
import math
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CSRC = "src/repro_torch/kernels/csrc"
# (name, CUDA source, the Pallas call it replaces)
KERNELS = {
    "fused_stats": (f"{CSRC}/fused_update.cu",
                    "src/repro/kernels/fused_update.py:122"),
    "fused_apply": (f"{CSRC}/fused_update.cu",
                    "src/repro/kernels/fused_update.py:317"),
    "qdq_cast": (f"{CSRC}/qdq_cast.cu",
                 "src/repro/kernels/qdq_cast.py:98"),
    "qdq_cast_one_pass": (f"{CSRC}/qdq_cast.cu",
                          "src/repro/kernels/qdq_cast.py:116"),
    "flash_attention": (f"{CSRC}/flash_fwd_sm90.cu",
                        "src/repro/kernels/flash_attention.py:222"),
    "flash_attention_tf32": (f"{CSRC}/flash_fwd_tf32.cu",
                             "src/repro/kernels/flash_attention.py:222"),
    "flash_attention_simt": (f"{CSRC}/flash_attention.cu",
                             "src/repro/kernels/flash_attention.py:222"),
    "flash_attention_bwd_delta": (
        f"{CSRC}/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:379"),
    "flash_attention_bwd_dq": (f"{CSRC}/flash_bwd_sm90.cu",
                               "src/repro/kernels/flash_attention.py:405"),
    "flash_attention_bwd_dq_tf32": (
        f"{CSRC}/flash_bwd_tf32.cu",
        "src/repro/kernels/flash_attention.py:405"),
    "flash_attention_bwd_dq_simt": (
        f"{CSRC}/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:405"),
    "flash_attention_bwd_dkv": (f"{CSRC}/flash_bwd_sm90.cu",
                                "src/repro/kernels/flash_attention.py:441"),
    "flash_attention_bwd_dkv_tf32": (
        f"{CSRC}/flash_bwd_tf32.cu",
        "src/repro/kernels/flash_attention.py:441"),
    "flash_attention_bwd_dkv_simt": (
        f"{CSRC}/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:441"),
    "flash_decode": (f"{CSRC}/flash_decode_sm90.cu",
                     "src/repro/kernels/flash_attention.py:546"),
    "grad_stats": (f"{CSRC}/grad_stats.cu",
                   "src/repro/kernels/grad_stats.py:52"),
}
# the LM training main path (phase 5c): launcher arguments and the rung
# controller / fisher refresh periods, lowered from the launcher's 20 / 100
# so both fire within the run
LM_TRAIN_ARGS = ["--arch", "smollm-135m", "--seq", "1024", "--rungs",
                 "2,4,8", "--steps", "20", "--ladder", "gpu"]
LM_T_CTRL, LM_T_CURV = 5, 10
# the EfficientNet-B0 Tri-Accel main path's steps (phase 5; ``--batch0``
# its rung, as ResNet-18's)
EFF_STEPS = 50
# published peaks of the H100 SXM (NVIDIA's data sheet): device memory
# bytes/s, f32 operations/s outside the tensor cores, bf16 tensor-core
# operations/s (dense) and TF32 tensor-core operations/s (dense)
PEAKS = {"H100": (3.35e12, 67e12, 989e12, 495e12)}


def log(*a):
    print(*a, flush=True)


def check(ok, what) -> None:
    """Fail the run (``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def signals_kept():
    """Put back the SIGTERM and SIGINT handlers after a call that installs
    the launcher's preemption handler (which chains neither SIG_DFL nor
    Python's SIGINT handler): this script must stay killable."""
    prev = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        yield
    finally:
        for s, h in prev.items():
            signal.signal(s, h)


def ptxas_kernels(text: str):
    """-> [(kernel, registers, bytes of spill stores)] from an nvcc -Xptxas
    -v log, names demangled with the toolkit's cu++filt where it has one."""
    out, name, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    filt = Path("/usr/local/cuda/bin/cu++filt")
    if out and filt.exists():
        names = subprocess.run(
            [str(filt)], input="\n".join(n for n, _, _ in out),
            capture_output=True, text=True, timeout=60).stdout.splitlines()
        if len(names) == len(out):
            bare = [d.replace("(int)", "").replace("(bool)1", "true")
                    .replace("(bool)0", "false") for d in names]
            out = [(re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::",
                           "", re.sub(r"\(.*", "", d)),
                    r, sp) for d, (_, r, sp) in zip(bare, out)]
    return out


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise RuntimeError(f"no published peaks for {name!r}")


def bound(nbytes: float, nops: float, bw: float, ops_rate: float):
    """-> (least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / bw, nops / ops_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------------------------------------- timing ---
def time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the mean device time of ``iters`` back-to-
    back calls, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / iters)
    return statistics.median(out)


def device_ms(fn, iters: int = 50) -> float:
    """Device time of one ``fn()`` call: the summed durations of the
    kernels (and copies) that ``torch.profiler`` records on the card over
    ``iters`` calls, after a warm-up, over ``iters``. Unlike ``time_ms``
    it leaves out the gaps where the card waits for the host's launches,
    which a kernel of a few microseconds can be shorter than."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):      # a trace that came back empty is taken again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.end - e.time_range.start
                 for e in prof.events() if e.device_type == cuda)
        if us > 0:
            return us / iters / 1e3
    raise RuntimeError("check failed: the profiler recorded no device time")


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal after widening to f32, NaN equal to NaN (the NaN
    payload of a cast is not part of the contract)."""
    a, b = a.float(), b.float()
    nan = torch.isnan(a) & torch.isnan(b)
    bits = a.view(torch.int32) == b.view(torch.int32)
    return bool((bits | nan).all())


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    both = (torch.isnan(a) & torch.isnan(b)) | (a == b)
    d = torch.where(both, torch.zeros_like(a), (a - b).abs())
    return float(torch.nan_to_num(d, nan=float("inf")).max())


# ------------------------------------------------ phase 3: the kernels ---
def vision_view(arch: str = "resnet18"):
    """The slab view of a vision testbed's parameters (ResNet-18: 22,016
    rows, 11 layers; EfficientNet-B0: 7,936 rows, 21 layers)."""
    from repro_torch.core.grouping import flat_grouping
    from repro_torch.kernels.layout import slab_view
    from repro_torch.models.vision import VisionConfig, vision_init
    params, _ = vision_init(torch.Generator(), VisionConfig(arch),
                            device="meta")
    return slab_view(params, flat_grouping(params))


def lm_train_view():
    """The slab view of smollm-135m's parameters under ``lm_grouping``
    (30 layers + embed + head), as the LM training path builds it."""
    from repro_torch.configs import smollm_135m
    from repro_torch.kernels.layout import slab_view
    from repro_torch.train.task import LMTask
    task = LMTask(smollm_135m.config(), device="cpu")
    params, _ = task.init(torch.Generator(), device="meta")
    return slab_view(params, task.grouping(params))


def lm_train_variant():
    """The fused update's variant on the LM training path: the launcher's
    default optimizer (the trainer's sgdm defaults), the gradient slab and
    compute copy in the LM's compute dtype; ``lm_train_main_path`` asserts
    that its trainer ran exactly this."""
    from repro_torch.configs import smollm_135m
    from repro_torch.optim.optimizers import sgdm
    from repro_torch.train.trainer import TrainerConfig
    tc = TrainerConfig()
    cd = smollm_135m.config().compute_dtype
    return dict(spec=sgdm(tc.momentum, tc.weight_decay).spec, g_dtype=cd,
                cp_dtype=cd, ladder=LM_TRAIN_ARGS[
                    LM_TRAIN_ARGS.index("--ladder") + 1], sr=False)


def check_stats(view, dev, bw, f32_ops, g_dtype=torch.float32,
                what="ResNet-18"):
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import ops
    rows, L = view.rows, view.num_layers
    gen = torch.Generator(device=dev).manual_seed(1)
    # at least three gradient slabs and 120 MB (ResNet-18: three, 135 MB;
    # EfficientNet-B0: eight of 16 MB), so each timed launch finds its
    # input out of the 50 MB L2 cache, as after a backward
    nbuf = max(3, -(-120_000_000 // (rows * 512 * torch.finfo(g_dtype).bits
                                     // 8)))
    gs = [(torch.randn((rows, 512), generator=gen, device=dev) * 1e-3
           ).to(g_dtype) for _ in range(nbuf)]
    g = gs[0]
    g[5, 7], g[300, 0], g[301, 511] = float("inf"), -float("inf"), float("nan")
    g[min(9000, rows - 7), 100:110] = float("nan")
    rl = view.row_blocks(dev)
    got = ops.fused_stats(g, rl, L)
    want = fu.fused_stats_ref(g, rl, L)
    torch.cuda.synchronize()
    names = ("sum", "sum_sq", "absmax", "nonfinite")
    for n, a, b in zip(names, got, want):
        if n in ("absmax", "nonfinite"):
            check(same(a, b), f"fused_stats {n}: {a} vs {b}")
        elif n == "sum_sq":  # another order of non-negative terms: rtol 1e-5
            check(torch.allclose(a, b, rtol=1e-5, atol=1e-6),
                  f"fused_stats {n}: {a} vs {b}")
    # A layer's sum of random-signed gradients cancels: a layer of ~1e6
    # terms of 1e-3 sums to O(1) or less while any f32 summation order is
    # off by O(1e-7) of the summed magnitudes. So each f32 sum (the kernel's
    # and the plain version's) is held to an f64 sum of the same finite
    # lanes within 2^-20 of the layer's sum of |g|, the conditioning of the
    # sum, not of its (possibly near-zero) value.
    fin = torch.where(torch.isfinite(g), g, 0.0).double()
    ids = rl.reshape(-1).long()
    truth = torch.zeros(L, dtype=torch.float64, device=dev).index_add_(
        0, ids, fin.sum(dim=1))
    mass = torch.zeros(L, dtype=torch.float64, device=dev).index_add_(
        0, ids, fin.abs().sum(dim=1))
    for who, v in (("kernel", got[0]), ("plain", want[0])):
        off = (v.double() - truth).abs()
        check(bool((off <= 2.0 ** -20 * mass).all()),
              f"fused_stats sum ({who}): off the f64 sum by "
              f"{off.tolist()} against sum|g| {mass.tolist()}")
    log(f"fused_stats ({what}) sum: kernel and plain off the f64 sum by "
        f"at most "
        f"{float((got[0].double() - truth).abs().max()):.3g} / "
        f"{float((want[0].double() - truth).abs().max()):.3g} (sum|g| per "
        f"layer {float(mass.min()):.3g}..{float(mass.max()):.3g}); kernel vs "
        f"plain {float((got[0] - want[0]).abs().max()):.3g}")
    check(float(got[3].sum()) == 13.0, "fused_stats counts 13 non-finite")
    err = max(abs_err(a, b) for a, b in zip(got, want))
    lib = fu._lib()
    part = torch.empty((rows // lib.tri_rows_per_block()) * L * 4,
                       device=dev)
    out = torch.empty((4, L), device=dev)
    k = [0]

    def raw():          # the kernel alone: no checks, no allocation
        k[0] = (k[0] + 1) % nbuf
        lib.tri_fused_stats(gs[k[0]].data_ptr(), fu._DTYPE_CODE[g_dtype],
                            rl.data_ptr(), rows, L, part.data_ptr(),
                            out.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)

    ms = time_ms(raw, iters=30)
    dev_ms = device_ms(raw)
    plain_ms = time_ms(lambda: fu.fused_stats_ref(g, rl, L), iters=5)
    nbytes = rows * 512 * g.element_size() + rows * 4 + 4 * L * 4
    nops = rows * 512 * 8      # isfinite, select, add, mul+add, add, abs+max
    b_ms, by = bound(nbytes, nops, bw, f32_ops)
    log(f"fused_stats ({what}) {rows}x512 {g_dtype} L={L}: kernel {ms:.4f} "
        f"ms (device {dev_ms:.4f} ms, both kernels), plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}), max|err| {err:.3g}")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None}


def _apply_inputs(rows, L, dev, adam, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda: torch.randn((rows, 512), generator=gen, device=dev)
    g, p, m = r(), r() * 2.0, r() * 0.1
    v = r().abs() * 0.01 if adam else None
    meta = (rows // 256, 256)
    ids = torch.randint(0, L, meta, generator=gen, device=dev,
                        dtype=torch.int32)
    lr = torch.full(meta, 1e-2, device=dev)
    lr.view(-1)[::7] = 0.0
    code = torch.randint(0, 3, meta, generator=gen, device=dev,
                         dtype=torch.int32)
    qs = 448.0 / (1.0 + 7.0 * torch.rand(meta, generator=gen, device=dev))
    # tpu-ladder overflow probes: qs = 1 on row 3, |p| past 464 -> NaN
    p[3, :6] = torch.tensor([500.0, -470.0, 464.0, 463.9, 448.0, -1000.0],
                            device=dev)
    code.view(-1)[3], qs.view(-1)[3], lr.view(-1)[3] = 0, 1.0, 0.0
    return g, p, m, v, ids, lr, code, qs


def _apply_pair(ops, fu, args, kw):
    got = ops.fused_apply(*args, **kw)
    want = fu.fused_apply_ref(*args, **kw)
    torch.cuda.synchronize()
    for n, a, b in zip(("p", "m", "v", "cp", "p_amax"), got, want):
        check((a is None) == (b is None), n)
        if a is not None:
            check(a.dtype == b.dtype and a.shape == b.shape, n)
            check(same(a, b), f"fused_apply {n} differs ({kw})")
    return max(abs_err(a, b) for a, b in zip(got, want) if a is not None)


def check_apply_variants(dev):
    """Every variant the kernel is templated on, bitwise, on a small slab."""
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import ops
    opts = [fu.OptSpec("sgdm", momentum=0.9, weight_decay=5e-4),
            fu.OptSpec("sgdm", momentum=0.9, nesterov=True,
                       weight_decay=1e-4),
            fu.OptSpec("adamw", b1=0.9, b2=0.95, eps=1e-8,
                       weight_decay=1e-2)]
    casts = [(torch.float32, False), (torch.bfloat16, False),
             (torch.bfloat16, True), (torch.float16, False)]
    n, err = 0, 0.0
    for spec in opts:
        adam = spec.kind == "adamw"
        g, p, m, v, ids, lr, code, qs = _apply_inputs(512, 3, dev, adam, 2)
        for ladder in ("gpu", "tpu"):
            for cp_dtype, sr in casts:
                for g_dtype in (torch.float32, torch.bfloat16, torch.float16):
                    if g_dtype != torch.float32 and cp_dtype != g_dtype:
                        continue
                    for keep in (1.0, 0.0):
                        gk = g.to(g_dtype).clone()
                        if not keep:
                            gk[9, 9] = float("inf")
                        scal = torch.tensor([0.5, keep, 0.19, 0.0975,
                                             12345.0], device=dev)
                        kw = dict(spec=spec, ladder=ladder,
                                  cp_dtype=cp_dtype, num_layers=3, sr=sr)
                        err = max(err, _apply_pair(
                            ops, fu, (gk, p, m, v, scal, ids, lr, code, qs),
                            kw))
                        n += 1
    log(f"fused_apply: {n} variants bitwise equal to the plain version")
    return err


def check_apply_main(view, dev, bw, f32_ops, spec=None,
                     g_dtype=torch.float32, cp_dtype=torch.float32,
                     ladder="gpu", sr=False, what="ResNet-18"):
    """fused_apply at a main path's shape and variant (ResNet-18's: sgdm
    with weight decay, gpu ladder, f32 gradient and copy) — bitwise
    against the plain version, then timed."""
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import ops
    rows, L = view.rows, view.num_layers
    g, p, m, _, _, lr, _, qs = _apply_inputs(rows, L, dev, False, 3)
    g = g.to(g_dtype)
    rl = view.row_blocks(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    code = torch.randint(0, 3, rl.shape, generator=gen, device=dev,
                         dtype=torch.int32)
    if spec is None:
        spec = fu.OptSpec("sgdm", momentum=0.9, weight_decay=5e-4)
    check(spec.kind == "sgdm", "check_apply_main times the sgdm form")
    kw = dict(spec=spec, ladder=ladder, cp_dtype=cp_dtype, num_layers=L,
              sr=sr)
    scal = torch.tensor([0.5, 1.0, 1.0, 1.0, 7.0], device=dev)
    err = _apply_pair(ops, fu, (g, p, m, None, scal, rl, lr, code, qs), kw)
    lib = fu._lib()
    outs = [torch.empty_like(p), torch.empty_like(p),
            torch.empty(p.shape, dtype=cp_dtype, device=dev)]
    part = torch.empty((rows // lib.tri_rows_per_block()) * L, device=dev)
    pmax = torch.empty((L,), device=dev)
    ptrs = [t.data_ptr() for t in (g, p, m)] + [None] + \
        [t.data_ptr() for t in (scal, rl, lr, code, qs)] + \
        [t.data_ptr() for t in outs[:2]] + [None, outs[2].data_ptr(),
                                            part.data_ptr(), pmax.data_ptr()]

    def raw():          # the kernel alone: no checks, no allocation
        lib.tri_fused_apply(0, int(ladder == "tpu"),
                            fu._DTYPE_CODE[g_dtype], fu._DTYPE_CODE[cp_dtype],
                            int(sr), int(spec.nesterov), spec.momentum,
                            spec.b1, 1.0 - spec.b1, spec.b2, 1.0 - spec.b2,
                            spec.eps, spec.weight_decay, *ptrs, rows, L,
                            torch.cuda.current_stream().cuda_stream)

    ms = time_ms(raw, iters=20)
    dev_ms = device_ms(raw)
    plain_ms = time_ms(lambda: fu.fused_apply_ref(
        g, p, m, None, scal, rl, lr, code, qs, **kw), iters=3)
    elems = rows * 512          # g, p, m in; p, m, copy out
    nbytes = elems * (g.element_size() + 4 * 4 + outs[2].element_size()) \
        + 4 * rows * 4 + 5 * 4 + L * 4
    nops = elems * 16           # scale, wd, momentum, lr step, casts, absmax
    b_ms, by = bound(nbytes, nops, bw, f32_ops)
    log(f"fused_apply ({what}) {rows}x512 sgdm/{ladder}, g {g_dtype}, copy "
        f"{cp_dtype}: kernel {ms:.4f} ms (device {dev_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}), max|err| {err:.3g}")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None}


# --------------------------------------------- phase 3d: grad_stats ---
#: the reference's test shapes, then its benchmark's and its registry's
GS_SHAPES = [(64,), (513, 129), (1024, 512), (7, 3, 5), (8,), (300,),
             (1000,)]


def _cls(t) -> str:
    v = float(t)
    return "nan" if math.isnan(v) else (str(v) if math.isinf(v)
                                        else "finite")


def _gs_check(got, x, what, again=None) -> float:
    """One ``grad_stats`` result against the plain version on the same
    tensor: absmax bitwise (NaN equal to NaN), each sum within 2^-20 of
    the sum of its terms' magnitudes of an f64 sum (an f32 sum in another
    order), non-finite statistics in the same class, and a second launch
    bitwise equal (``again``). Returns max |kernel - plain|."""
    from repro_torch.kernels import grad_stats as gs
    want = gs.grad_stats_ref(x)
    check(same(got[2], want[2]), f"grad_stats absmax {what}: {got[2]} vs "
          f"{want[2]}")
    v = x.detach().double().reshape(-1)
    fin = bool(torch.isfinite(v).all())
    for k, (truth, mass) in enumerate(((v.sum(), v.abs().sum()),
                                       ((v * v).sum(), (v * v).sum()))):
        g = got[k].double()
        if fin:
            check(float((g - truth).abs()) <= 2.0 ** -20 * float(mass),
                  f"grad_stats {('sum', 'sum_sq')[k]} {what}: {float(g)!r} "
                  f"vs f64 {float(truth)!r} (sum of |terms| "
                  f"{float(mass)!r})")
        else:
            check(_cls(g) == _cls(want[k]),
                  f"grad_stats {what}: {float(g)} vs {float(want[k])}")
    if again is not None:
        check(all(same(a, b) for a, b in zip(got, again)),
              f"grad_stats {what}: two launches differ")
    return max(abs_err(a, b) for a, b in zip(got, want))


def _time_grad_stats(xs, bw, f32_ops, what):
    """CUDA-event time of the kernel alone over the tensors ``xs`` in turn
    (enough of them that each launch reads its input from device memory,
    not from the 50 MB L2), the plain version's time, and the bound."""
    from repro_torch.kernels import grad_stats as gs
    lib = gs._lib()
    x = xs[0]
    code, n = gs._DTYPE_CODE[x.dtype], x.numel()
    nblk = lib.tri_grad_stats_blocks(n, code)
    part = torch.empty((3 * nblk,), device=x.device)
    out = torch.empty((3,), device=x.device)
    k = [0]

    def raw():          # the kernel alone: no checks, no allocation
        k[0] = (k[0] + 1) % len(xs)
        lib.tri_grad_stats(xs[k[0]].data_ptr(), code, n, part.data_ptr(),
                           nblk, out.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)

    ms = time_ms(raw, iters=30)
    plain_ms = time_ms(lambda: gs.grad_stats_ref(x), iters=10)
    # each input byte read once, 3 f32 written; 4 operations an element
    # (add, multiply-add, abs, max)
    b_ms, by = bound(n * x.element_size() + 12, 4 * n, bw, f32_ops)
    log(f"grad_stats {what} {tuple(x.shape)} {x.dtype}: kernel {ms:.5f} ms, "
        f"plain {plain_ms:.5f} ms, bound {b_ms:.5f} ms ({by}), {nblk} "
        "blocks; no single PyTorch call computes the three moments (no "
        "library time)")
    return ms, plain_ms, b_ms, by


def check_grad_stats(dev, bw, f32_ops):
    """``grad_stats`` against its plain version on the card: the
    reference's test shapes (f32, bf16), its benchmark's (1024, 1024) f32
    and its registry's (1,000,000,) f32, an empty tensor, tensors holding
    NaN, +inf, -inf (and a strided view); timed at (1024, 1024) f32."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(5)
    err, n = 0.0, 0
    cases = [(s, d) for s in GS_SHAPES
             for d in (torch.float32, torch.bfloat16)]
    cases += [((1024, 1024), torch.float32), ((1_000_000,), torch.float32)]
    for shape, dtype in cases:
        x = (torch.randn(shape, generator=gen, device=dev) * 2).to(dtype)
        err = max(err, _gs_check(ops.grad_stats(x), x, f"{shape} {dtype}",
                                 ops.grad_stats(x)))
        n += 1
    empty = ops.grad_stats(torch.empty((0,), device=dev))
    check([float(t) for t in empty] == [0.0] * 3, "grad_stats of nothing")
    for bad in (float("nan"), float("inf"), -float("inf")):
        x = torch.randn((513, 129), generator=gen, device=dev)
        x[7, 100] = bad
        _gs_check(ops.grad_stats(x), x, f"holding {bad}")
        _gs_check(ops.grad_stats(x.T), x.T, f"holding {bad}, transposed")
    both = torch.randn((513, 129), generator=gen, device=dev)
    both[1, 1], both[2, 2] = float("inf"), -float("inf")
    got = ops.grad_stats(both)
    _gs_check(got, both, "holding +inf and -inf")
    check(bool(torch.isnan(got[0])) and float(got[2]) == float("inf"),
          "grad_stats: inf - inf sums to NaN, absmax inf")
    torch.cuda.synchronize()
    log(f"grad_stats: {n} shapes x 2 launches, empty, NaN/+inf/-inf and "
        f"strided inputs held against the plain version; max|kernel - "
        f"plain| {err:.3g}")
    # 16 x 4 MB: each timed launch finds its input out of the L2
    xs = [torch.randn((1024, 1024), generator=gen, device=dev)
          for _ in range(16)]
    ms, plain_ms, b_ms, by = _time_grad_stats(xs, bw, f32_ops,
                                              "(the reference benchmark's)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


def grad_stats_over_gradients(name, task, params, aux, batch, tac,
                              control, bw=None, f32_ops=None,
                              whole_tree=False):
    """The port's path to ``grad_stats``: its public op over every leaf of
    the gradient tree of one reference step (``train_step.reference_grads``:
    the main path's loss and batch, f32 after the loss-scale division).
    The launch count is read around the op's calls alone; the results are
    then held against the plain version (no kernel launch). With ``bw``
    given, timed on the largest leaf, or with ``whole_tree`` over every
    leaf in turn (the path's own work: one launch a leaf)."""
    from repro_torch import tree as tu
    from repro_torch.core.precision import make_qdq_fn
    from repro_torch.kernels import ops
    from repro_torch.train.train_step import reference_grads
    grads, _, metrics = reference_grads(task, make_qdq_fn(tac), params, aux,
                                        batch, task.loss_codes(control.codes),
                                        control.loss_scale)
    leaves = tu.leaves(grads)
    torch.cuda.synchronize()
    ops.reset_launches()
    stats = [ops.grad_stats(g) for g in leaves]
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check(launches["grad_stats"] == len(leaves) and sum(
        launches.values()) == len(leaves),
        f"grad_stats over {name}'s gradient leaves: {launches}")
    err = max(_gs_check(st, g, f"{name} leaf {tuple(g.shape)}")
              for st, g in zip(stats, leaves))
    big = max(leaves, key=lambda g: g.numel())
    log(f"grad_stats over the {len(leaves)} gradient leaves of one "
        f"reference step of {name} ({sum(g.numel() for g in leaves)} "
        f"elements, largest {tuple(big.shape)} {big.dtype}): "
        f"{launches['grad_stats']} launches, all held against the plain "
        f"version, max|kernel - plain| {err:.3g}; that step's loss "
        f"{float(metrics['loss']):.5f}")
    out = {"launches": launches["grad_stats"], "max_abs_err": err}
    if bw is not None and whole_tree:
        out.update(_time_grad_stats_tree(leaves, bw, f32_ops, name))
    elif bw is not None:        # time the largest leaf (113 MB: out of L2)
        ms, plain_ms, b_ms, by = _time_grad_stats(
            [big], bw, f32_ops, f"{name}'s largest gradient leaf")
        out.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                   library_ms=None)
    return out


def _time_grad_stats_tree(leaves, bw, f32_ops, name) -> dict:
    """One pass of the kernel over every leaf in turn (one launch a leaf,
    buffers allocated beforehand), by CUDA events and by the profiler's
    device time; the plain version over the same leaves; the bound: every
    leaf's bytes read once, 3 f32 written a leaf."""
    from repro_torch.kernels import grad_stats as gs
    lib = gs._lib()
    stream = torch.cuda.current_stream().cuda_stream
    calls = []
    for x in leaves:
        code, n = gs._DTYPE_CODE[x.dtype], x.numel()
        nblk = lib.tri_grad_stats_blocks(n, code)
        calls.append((x.contiguous(), code, n,
                      torch.empty((3 * nblk,), device=x.device), nblk,
                      torch.empty((3,), device=x.device)))

    def raw():          # the kernel alone: no checks, no allocation
        for x, code, n, part, nblk, out in calls:
            lib.tri_grad_stats(x.data_ptr(), code, n, part.data_ptr(), nblk,
                               out.data_ptr(), stream)

    ms = time_ms(raw, iters=5)
    dev_ms = device_ms(raw, iters=5)
    plain_ms = time_ms(lambda: [gs.grad_stats_ref(x) for x in leaves],
                       iters=3)
    n = sum(x.numel() for x in leaves)
    b_ms, by = bound(sum(x.numel() * x.element_size() for x in leaves)
                     + 12 * len(leaves), 4 * n, bw, f32_ops)
    small = sum(x.numel() <= 1280 for x in leaves)
    log(f"grad_stats over {name}'s {len(leaves)} gradient leaves in turn "
        f"({n} elements; {small} leaves of at most 1,280): kernel "
        f"{ms:.5f} ms by events, device {dev_ms:.5f} ms "
        f"({dev_ms / len(leaves) * 1e3:.2f} us a launch), plain "
        f"{plain_ms:.5f} ms, bound {b_ms:.5f} ms ({by}); no single PyTorch "
        "call computes the three moments (no library time)")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


# ------------------------------------------ phase 4: one step, two devices ---
def check_step_against_cpu(arch: str = "resnet18", floor: float = 0.0):
    """One resident step of ``arch`` at batch 4 on the card (kernels) and
    on the CPU (plain versions), from the same weights, state and batch.
    cuDNN and the CPU convolve in other summation orders (both full f32,
    TF32 off), so the gradient is held leaf by leaf within 3e-2 of the
    leaf's largest magnitude (the spread the reference's own CPU gradient
    shows against f64 in ResNet-18's first block; see
    tests/test_torch_vision.py) plus ``floor`` of the slab's largest
    magnitude (EfficientNet-B0: 1e-5, for the projections' BatchNorm
    biases, whose exact gradient is zero and whose f32 noise is all either
    side computes; tests/test_torch_vision_effnet.py), and everything
    downstream of it follows from the gradient by the update's
    arithmetic:
      master   p_card - p_cpu = -lr * (m_card - m_cpu), up to one f32
               rounding on each side, each relative to its own values,
               2^-21 (|p| + |p'_card| + |p'_cpu|), as the reference step's
               check (where p is 0 and m noise, p'_card and p'_cpu differ
               wholly)
      copy     within one grid step of its tier (2^-7) of the master's gap
    loss and BN statistics within rtol 1e-4, codes equal."""
    from repro_torch import tree as tu
    from repro_torch.core.precision import TriAccelConfig
    from repro_torch.data.synthetic import CIFARLikeStream
    from repro_torch.models.vision import VisionConfig
    from repro_torch.train.task import VisionTask
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tac = TriAccelConfig(ladder="gpu", t_ctrl=1, curvature_method="fisher",
                         tau_low=3e-9, tau_high=1e-5)
    tcfg = TrainerConfig(total_steps=10, base_lr=0.05, warmup_steps=2,
                         weight_decay=5e-4, grad_clip=5.0, rungs=(4,),
                         seq_len=1)
    batch = CIFARLikeStream(global_batch=4, seed=3).batch(0)
    out = {}
    for dev in ("cpu", "cuda"):
        tr = Trainer(VisionTask(VisionConfig(arch), device=dev), tac,
                     tcfg, device=dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        p0 = tr.state.params.detach().clone().cpu()  # the step donates
        st, met = tr._step_fn(tr.state, b)
        out[dev] = (p0, st, met)
    view = tr.view
    (p0, sc, mc), (_, sg, mg) = out["cpu"], out["cuda"]
    cpu = lambda t: t.detach().cpu().float()
    check(bool(mg["grads_finite"]) and bool(torch.isfinite(mg["loss"])),
          "finite step on the card")
    torch.testing.assert_close(cpu(mg["loss"]), mc["loss"], rtol=1e-4,
                               atol=0)
    mo_g, mo_c = cpu(sg.opt_state["mu"]), sc.opt_state["mu"]
    worst, top = 0.0, float(mo_c.abs().max())
    for slot in view.slots:
        rows = slice(slot.row_off, slot.row_off + slot.stack * slot.rows_per)
        gap = float((mo_g[rows] - mo_c[rows]).abs().max())
        worst = max(worst, gap / (float(mo_c[rows].abs().max())
                                  + floor / 3e-2 * top))
    check(worst <= 3e-2, f"{arch} card vs CPU clipped gradient: {worst}")
    lr = float(mc["lr"])
    check(float(mg["lr"]) == lr, "learning rate")
    p_g, p_c = cpu(sg.params), sc.params
    dev_p = ((p_g - p_c) + lr * (mo_g - mo_c)).abs()
    check(bool((dev_p <= 2.0 ** -21 * (p0.abs() + p_c.abs()
                                       + p_g.abs())).all()),
          "master = p - lr * m on both devices")
    gap_p = float((p_g - p_c).abs().max())
    cp_g, cp_c = cpu(sg.compute["slab"]), sc.compute["slab"].float()
    check(bool(((cp_g - cp_c).abs() <= 2.0 ** -7 * cp_c.abs() + 2 * gap_p
                + 2.0 ** -24).all()), "compute copy")
    check(torch.equal(sg.control.codes.cpu(), sc.control.codes), "codes")
    for a, b in zip(tu.leaves(sg.aux_state), tu.leaves(sc.aux_state)):
        torch.testing.assert_close(cpu(a), b, rtol=1e-4, atol=1e-5)
    log(f"{arch}, one step, card vs CPU: loss {float(mg['loss']):.7f} vs "
        f"{float(mc['loss']):.7f}; momentum (the clipped gradient) within "
        f"{worst:.3g} of each leaf's max; max|dmaster| {gap_p:.3g}; codes "
        f"{sg.control.codes.tolist()}")


def check_curvature_against_cpu(arch: str = "efficientnet_b0",
                                b_curv: int = 4, step: int = 40) -> None:
    """One §3.2 ``hutchinson`` refresh as ``Trainer._curvature`` takes it
    (``curvature.hutchinson_layer_traces``, one probe from a generator
    seeded with ``step``, the task's ``curvature_loss`` over ``b_curv``
    images) on the card and on the CPU, from the same weights, BatchNorm
    state, batch and probe. Each layer's trace estimate is a sum of
    z * (Hz) terms of both signs, so it is held within 1e-3 of the layer's
    mean |z * (Hz)| (the sum's conditioning), computed on the CPU."""
    from repro_torch import tree as tu
    from repro_torch.core import curvature as curv
    from repro_torch.core.grouping import flat_grouping
    from repro_torch.data.synthetic import CIFARLikeStream
    from repro_torch.models.vision import VisionConfig
    from repro_torch.train.task import VisionTask
    batch = CIFARLikeStream(global_batch=b_curv, seed=3).batch(step)
    params, aux = VisionTask(VisionConfig(arch), device="cpu").init(
        torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", "cuda"):
        task = VisionTask(VisionConfig(arch), device=dev)
        p = tu.tree_map(lambda t: t.to(dev), params)
        a = tu.tree_map(lambda t: t.to(dev), aux)
        b = {k: v.to(dev) for k, v in batch.items()}
        loss_fn = lambda q, bb: task.curvature_loss(q, a, bb)  # noqa: E731
        grp = flat_grouping(p)
        t0 = time.perf_counter()
        lam = curv.hutchinson_layer_traces(
            loss_fn, p, grp.mean, torch.Generator().manual_seed(step), 1, b)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = (lam.cpu(), (time.perf_counter() - t0) * 1e3)
        if dev == "cpu":
            z = curv._rademacher_tree(p, torch.Generator().manual_seed(step))
            hz = curv.hvp(loss_fn, p, z, b)
            mass = grp.mean(tu.tree_map(lambda x, y: (x * y).abs(), z, hz))
    (lc, ms_c), (lg, ms_g) = out["cpu"], out["cuda"]
    check(bool(torch.isfinite(lg).all()) and float(lg.abs().sum()) > 0,
          f"hutchinson on the card: {lg.tolist()}")
    worst = float(((lg - lc).abs() / mass).max())
    check(worst <= 1e-3, f"{arch} hutchinson card vs CPU: {worst} of the "
          "layers' mean |z Hz|")
    log(f"{arch}, one hutchinson refresh (b_curv {b_curv}, one probe), card "
        f"vs CPU: per-layer traces within {worst:.3g} of each layer's mean "
        f"|z Hz| (limit 1e-3); card {ms_g:.1f} ms, CPU {ms_c:.1f} ms; "
        f"lambda {[float(f'{x:.3g}') for x in lg.tolist()]}")


# ------------------------------------------------- phase 5: main path ---
def main_path(steps: int, batch0: int, arch: str = "resnet18"):
    """``run_method("triaccel", arch, steps, batch0)`` with the launch
    counts read around it -> (launches, median step ms, peak bytes, rung
    history)."""
    from repro_torch.kernels import ops
    from repro_torch.train.paper_harness import run_method
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = run_method("triaccel", arch, steps=steps, batch0=batch0,
                     device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in res.log]
    check(len(res.log) == steps, f"{len(res.log)} logged steps")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    for k in ("fused_stats", "fused_apply"):
        check(launches[k] == steps, f"{k}: {launches[k]} launches in "
              f"{steps} steps")
    if steps > 40:      # t_ctrl = 10, t_curv = 40: each control fired
        check(len(res.batch_history) == (steps - 1) // 10,
              "rung controller every 10 steps")
        check(res.codes != [1] * len(res.codes), "precision codes refreshed")
        check(max(res.curvature) > 0, "fisher curvature refreshed")
    walls = [m["wall_s"] for m in res.log]
    dts = [b - a for a, b in zip(walls, walls[1:])]
    step_ms = statistics.median(dts[4:]) * 1e3
    hist = {c: res.codes.count(c) for c in (0, 1, 2)}
    log(f"main path: run_method('triaccel', '{arch}', steps={steps}, "
        f"batch0={batch0}) in {wall:.2f} s (eval included)")
    log(f"  median step {step_ms:.3f} ms (steps 5..{steps - 1}), "
        f"peak allocated {peak / 1e9:.3f} GB")
    log(f"  loss {losses[0]:.4f} -> {losses[-1]:.4f}, finite steps "
        f"{sum(int(m['grads_finite']) for m in res.log)}/{steps}, "
        f"held-out accuracy {res.accuracy:.2f} %")
    log(f"  rung history {res.batch_history}, final rung "
        f"{res.final_batch}, measured peak bytes per rung "
        f"{ {k: int(v) for k, v in res.measured_bytes.items()} }")
    log(f"  codes {res.codes} histogram {hist}, loss scale "
        f"{res.log[-1]['loss_scale']:.0f}, fisher curvature per layer "
        f"{[float(f'{x:.3g}') for x in res.curvature]}")
    log(f"  launches {launches}")
    return launches, step_ms, peak, res.batch_history


def hutchinson_main_path(arch: str = "efficientnet_b0", t_curv: int = 5,
                         rung: int = 32) -> None:
    """A ``Trainer`` with ``TriAccelConfig()``'s defaults (the
    ``hutchinson`` method; only ``t_curv`` lowered so the refresh fires)
    for ``t_curv + 1`` steps on the card: the refresh at step ``t_curv``
    sets a finite, non-zero per-layer curvature. Then the time of one more
    refresh (one probe, double backward over ``b_curv`` images)."""
    from repro_torch.core.precision import TriAccelConfig
    from repro_torch.kernels import ops
    from repro_torch.models.vision import VisionConfig
    from repro_torch.train.task import VisionTask
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tac = TriAccelConfig(t_curv=t_curv)
    check(tac.curvature_method == "hutchinson", "the default method")
    tr = Trainer(VisionTask(VisionConfig(arch), device="cuda"), tac,
                 TrainerConfig(total_steps=t_curv + 1, seq_len=1,
                               rungs=(rung,), log_every=1), device="cuda")
    ops.reset_launches()
    tr.run(t_curv)
    check(float(tr.state.control.lam.abs().sum()) == 0.0,
          "no curvature before the first refresh")
    tr.run(1)
    torch.cuda.synchronize()
    lam = tr.state.control.lam.cpu()
    launches = dict(ops.LAUNCHES)
    check(bool(torch.isfinite(lam).all()) and float(lam.abs().sum()) > 0,
          f"hutchinson refresh on the card: {lam.tolist()}")
    check(launches["fused_stats"] == launches["fused_apply"] == t_curv + 1,
          f"hutchinson trainer launches {launches}")
    check(all(math.isfinite(m["loss"]) for m in tr.metrics_log),
          "hutchinson trainer losses")
    t0 = time.perf_counter()
    tr._curvature(t_curv)
    torch.cuda.synchronize()
    log(f"hutchinson main path: Trainer(VisionTask({arch!r}), "
        f"TriAccelConfig(t_curv={t_curv})) {t_curv + 1} steps at rung "
        f"{rung}, b_curv {tr.tcfg.b_curv}: lambda per layer "
        f"{[float(f'{x:.3g}') for x in lam.tolist()]}; one more refresh "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms; launches "
        f"{ {k: v for k, v in launches.items() if v} }")


def _profile(run, steps: int, family, what: str) -> dict:
    """``torch.profiler`` over ``run()`` (``steps`` steps): device time by
    ``family(kernel name)``, the union of the device intervals (busy), the
    host gaps and the idle share of the host's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.events() if e.device_type == cuda]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, end = 0.0, -1.0
    for a, b in spans:                   # union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    fam, top = {}, {}
    for e in kern:
        us = e.time_range.end - e.time_range.start
        key = family(e.name.lower())
        fam[key] = fam.get(key, 0.0) + us
        top[e.name] = top.get(e.name, 0.0) + us
    log(f"profile, {what}: host {wall_us / steps / 1e3:.3f} ms a step, "
        f"device busy {busy / steps / 1e3:.3f} ms a step, host gaps "
        f"{(wall_us - busy) / steps / 1e3:.3f} ms a step, idle share "
        f"{1 - busy / wall_us:.3f}; {len(kern) / steps:.0f} device ops a "
        "step")
    for k, v in sorted(fam.items(), key=lambda kv: -kv[1]):
        log(f"  {k}: {v / steps / 1e3:.4f} ms a step")
    for n, v in sorted(top.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {v / steps / 1e3:8.4f} ms  {n[:100]}")
    return {"busy_ms": busy / steps / 1e3, "ops": len(kern) / steps,
            "host_ms": wall_us / steps / 1e3,
            "families": {k: v / steps / 1e3 for k, v in fam.items()}}


def profile_steps(batch0: int, warm: int = 6, steps: int = 5,
                  method: str = "triaccel", arch: str = "resnet18") -> None:
    """Where a train step's time goes: ``steps`` steps of the ``method``
    main path's trainer for ``arch`` after ``warm`` steps."""
    from repro_torch.train.paper_harness import make_trainer
    trainer = make_trainer(method, arch, steps=50, batch0=batch0,
                           device="cuda")[0]
    trainer.run(warm)

    def family(n):
        if "stats_partials" in n or "apply_kernel" in n \
                or "reduce_partials" in n:
            return "fused update (this port's kernels)"
        if any(w in n for w in ("conv", "gemm", "xmma", "cudnn", "wgrad",
                                "dgrad", "cutlass", "sm90")):
            return "convolution / matmul"
        if "memcpy" in n or "memset" in n:
            return "memcpy / memset"
        return "reduction" if "reduce" in n else "elementwise / other"

    _profile(lambda: trainer.run(steps), steps, family,
             f"{steps} {method} train steps of {arch} at rung "
             f"{trainer.scaler.microbatch}")


# ------------------------------------ phase 3b: the serving kernels ---
def close(got, want, what) -> float:
    """An attention kernel's output against its plain version's, within
    ``flash_attention.tolerance`` (the source's stated tolerance); returns
    max |err|."""
    from repro_torch.kernels.flash_attention import tolerance
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    d = (g - w).abs()
    lim = tolerance(got, want)
    worst = int(torch.argmax(d / lim))
    check(bool((d <= lim).all()),
          f"{what}: max|err| {float(d.max())}; worst against its limit "
          f"{float(g.flatten()[worst])} vs {float(w.flatten()[worst])}")
    return float(d.max())


def close_lse(got, want, what) -> None:
    """The forward kernel's LSE against the plain forward's: within 1e-5
    of 1 + the largest |lse| (f32 sums of exp in another order)."""
    check(bool((got - want).abs().max() <= 1e-5 * (1 + want.abs().max())),
          what + " lse")


def _lm_leaves():
    """The floating leaves of smollm-135m's parameters, as shapes."""
    from repro_torch import tree as tu
    from repro_torch.configs import smollm_135m
    from repro_torch.models.lm import lm_init
    params = lm_init(torch.Generator(), smollm_135m.config(), device="meta")
    return [tuple(x.shape) for x in tu.leaves(params)]


def _device_ops(fn):
    """Names of the operations one ``fn()`` call puts on the card
    (``torch.profiler``, after a warm-up call; a trace that came back
    empty is taken again, as in ``device_ms``)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
    return []


def _qdq_edges(dev, ops, qc) -> int:
    """The kernel against its plain version at offsets 0-7 elements into a
    buffer (every alignment of x against the fresh output), sizes around
    the 8-element unit, f32 and bf16 in and out, NaN and +-inf in x, both
    ladders, no / given / too-small amax, codes 0/1/2; ten repeated calls
    of each form bitwise equal. Returns the cases checked."""
    gen = torch.Generator(device=dev).manual_seed(6)
    edges = torch.tensor([float("nan"), float("inf"), -float("inf"), 7e4,
                          -1e-30, 448.0, 12.0], device=dev)
    amaxes = (None, torch.tensor(9.5, device=dev),
              torch.tensor(0.5, device=dev))
    n_cases = 0
    for n in (0, 1, 7, 8, 9, 15, 16, 17, 1_048_579):
        buf32 = torch.randn((n + 8,), generator=gen, device=dev) * 3.0
        if n > 64:
            buf32[n // 2:n // 2 + len(edges)] = edges
        for dtype in (torch.float32, torch.bfloat16):
            buf = buf32.to(dtype)
            for off in range(8):
                x = buf[off:off + n]
                for out_dtype in (torch.float32, torch.bfloat16):
                    for ladder in ("tpu", "gpu"):
                        for amax in amaxes:
                            for code in (0, 1, 2):
                                got = ops.qdq_cast(x, code, ladder, amax,
                                                   out_dtype=out_dtype)
                                want = qc.qdq_cast_ref(x, code, ladder, amax,
                                                       out_dtype=out_dtype)
                                check(got.dtype == out_dtype
                                      and got.shape == x.shape
                                      and same(got, want),
                                      f"qdq_cast n={n} off={off} {dtype} -> "
                                      f"{out_dtype} {ladder} amax={amax} "
                                      f"code={code}")
                                n_cases += 1
    x = (torch.randn((1_048_582,), generator=gen, device=dev) * 3.0)[3:]
    for amax in (None, x.abs().amax()):
        first = ops.qdq_cast(x, 0, "tpu", amax, out_dtype=torch.bfloat16)
        for _ in range(9):
            again = ops.qdq_cast(x, 0, "tpu", amax, out_dtype=torch.bfloat16)
            check(torch.equal(again.view(torch.int16),
                              first.view(torch.int16)),
                  f"qdq_cast repeats bitwise (amax={amax is not None})")
    return n_cases


def check_qdq(dev, bw, ops_rate):
    """qdq_cast bitwise against its plain version over every variant
    (ladders, codes, f32/bf16, tile-filling and ragged sizes, no / given /
    too-small amax with the NaN rule) and the edge cases (``_qdq_edges``),
    each form's device operations per call, then at the main paths'
    shapes: the tier-0 cast of all of smollm-135m's leaves, timed whole by
    CUDA events and by the profiler's device time. Rows 3 and 4 of
    ``PERF.md`` (f32 in and out): the two-pass form, and the one-pass form
    with each leaf's absmax given. Row 3b, the serving tier-0 weight set
    (f32 in, bf16 out): the cast then ``.to(bf16)`` against the bf16
    output written directly, timed in turns. Yardsticks: the kernel as a
    copy (code 2) beside ``torch.clone``. -> the ``kernels`` line's rows
    ``qdq_cast`` (the serving path's two-pass cast, bf16 out) and
    ``qdq_cast_one_pass`` (the LM path's cast from the trainer's table)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import qdq_cast as qc
    gen = torch.Generator(device=dev).manual_seed(5)
    n = 0
    for shape in ((512, 512), (37, 53), (30, 576, 9, 64)):
        x32 = torch.randn(shape, generator=gen, device=dev) * 3.0
        x32.view(-1)[:4] = torch.tensor([7e4, -1e-30, 448.0, 12.0])
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            for ladder in ("tpu", "gpu"):
                for amax in (None, torch.tensor(9.5, device=dev),
                             torch.tensor(0.5, device=dev)):
                    for code in (0, 1, 2):
                        got = ops.qdq_cast(x, code, ladder, amax)
                        want = qc.qdq_cast_ref(x, code, ladder, amax)
                        check(got.dtype == x.dtype, "qdq dtype")
                        check(same(got, want), f"qdq_cast {shape} {dtype} "
                              f"{ladder} amax={amax} code={code}")
                        n += 1
    small = torch.tensor([4.2, -5.0, 0.5], device=dev)
    nan = ops.qdq_cast(small, 0, "tpu", torch.tensor(4.0, device=dev))
    check(bool(torch.isnan(nan[:2]).all()) and not bool(torch.isnan(nan[2])),
          "qdq_cast: NaN past 464 on the tpu ladder")
    edges = _qdq_edges(dev, ops, qc)
    log(f"qdq_cast: {n} variants and {edges} edge cases (offsets 0-7, sizes "
        "0-17 and 1,048,579, f32/bf16 in and out, NaN/inf, ten repeats) "
        "bitwise equal to the plain version")

    # main path: every leaf of the full-width model, f32 in
    xs = [torch.randn(s, generator=gen, device=dev) * 0.05
          for s in _lm_leaves()]
    amaxes = [x.abs().amax() for x in xs]
    big = max(xs, key=lambda t: t.numel())
    norm = min(xs, key=lambda t: t.numel())
    for x in (big, norm):
        for form, amax in (("two_pass", None), ("one_pass", x.abs().amax())):
            names = _device_ops(lambda: ops.qdq_cast(
                x, 0, "tpu", amax, out_dtype=torch.bfloat16))
            log(f"qdq_cast {form} call on {tuple(x.shape)}: {len(names)} "
                f"device operation(s) {names}")
            check(len(names) == 1 and "qdq_kernel" in names[0],
                  f"qdq_cast {form}: one device operation a call")
            # the kernel's TWO_PASS template argument is the form counted
            check(f"{str(form == 'two_pass').lower()}>" in names[0],
                  f"qdq_cast {form}: the launched kernel is that form")
    err = 0.0
    for x, a in zip(xs, amaxes):
        for amax in (None, a):
            for out_dtype in (torch.float32, torch.bfloat16):
                got = ops.qdq_cast(x, 0, "tpu", amax, out_dtype=out_dtype)
                want = qc.qdq_cast_ref(x, 0, "tpu", amax, out_dtype=out_dtype)
                check(same(got, want), f"qdq_cast leaf {tuple(x.shape)} "
                      f"amax={amax is not None} {out_dtype}")
                err = max(err, abs_err(got, want))
    lib = qc._lib()
    grid = lib.tri_qdq_cast_max_grid()
    partials = torch.empty((grid,), dtype=torch.int32, device=dev)
    outs = {d: [torch.empty(x.shape, dtype=d, device=dev) for x in xs]
            for d in (torch.float32, torch.bfloat16)}
    stream = torch.cuda.current_stream().cuda_stream
    bf = torch.bfloat16

    def raw(out_dtype, code=0, given=False):
        """The kernel alone, no checks, no allocation: one call a leaf."""
        oc = qc._DTYPE_CODE[out_dtype]

        def run():
            for x, o, a in zip(xs, outs[out_dtype], amaxes):
                lib.tri_qdq_cast(x.data_ptr(), 0, o.data_ptr(), oc,
                                 x.numel(), code, 1,
                                 a.data_ptr() if given else None,
                                 int(qc.form(code, "tpu", a if given
                                             else None) == "two_pass"),
                                 partials.data_ptr(), grid, stream)
        return run

    def plain(out_dtype, given=False):
        return lambda: [qc.qdq_cast_ref(x, 0, "tpu", a if given else None,
                                        out_dtype=out_dtype)
                        for x, a in zip(xs, amaxes)]

    elems = sum(x.numel() for x in xs)

    def bnd(per_elem):
        return bound(per_elem * elems, 6.0 * elems, bw, ops_rate)

    t = {}
    for key, fn in (("two", raw(torch.float32)),
                    ("one", raw(torch.float32, given=True)),
                    ("two_bf", raw(bf)), ("one_bf", raw(bf, given=True)),
                    ("copy", raw(torch.float32, code=2))):
        t[key] = (time_ms(fn, iters=10), device_ms(fn, iters=10))
    t["clone"] = (time_ms(lambda: [x.clone() for x in xs], iters=10),
                  device_ms(lambda: [x.clone() for x in xs], iters=10))
    # row 3b: the serving set as the cast then .to(bf16), against the bf16
    # output written directly, in turns (chain, direct, direct, chain)
    chain = lambda: [ops.qdq_cast(x, 0, "tpu").to(bf) for x in xs]  # noqa
    direct = lambda: [ops.qdq_cast(x, 0, "tpu", out_dtype=bf)  # noqa
                      for x in xs]
    turns = [time_ms(f, iters=5, reps=3) for f in (chain, direct, direct,
                                                   chain)]
    dev_chain, dev_direct = device_ms(chain, 5), device_ms(direct, 5)
    p = {"two": time_ms(plain(torch.float32), iters=2, reps=3),
         "one": time_ms(plain(torch.float32, True), iters=2, reps=3),
         "two_bf": time_ms(plain(bf), iters=2, reps=3),
         "one_bf": time_ms(plain(bf, True), iters=2, reps=3)}
    b8, b12, b10, b6 = bnd(8.0), bnd(12.0), bnd(10.0), bnd(6.0)
    log(f"qdq_cast, tier-0 cast of {len(xs)} leaves ({elems} f32 weights), "
        f"ms by events (device ms by the profiler), plain version beside:")
    log(f"  row 3, two-pass, f32 out: {t['two'][0]:.4f} ({t['two'][1]:.4f}),"
        f" plain {p['two']:.4f}; bound {b8[0]:.4f} (8 B an element), "
        f"{b12[0]:.4f} for a design that reads x twice (12 B)")
    log(f"  row 4, one-pass (each leaf's amax given), f32 out: "
        f"{t['one'][0]:.4f} ({t['one'][1]:.4f}), plain {p['one']:.4f}; "
        f"bound {b8[0]:.4f} (8 B)")
    log(f"  row 3b, bf16 out: two-pass {t['two_bf'][0]:.4f} "
        f"({t['two_bf'][1]:.4f}), plain {p['two_bf']:.4f}; one-pass "
        f"{t['one_bf'][0]:.4f} ({t['one_bf'][1]:.4f}), plain "
        f"{p['one_bf']:.4f}; bound {b6[0]:.4f} (6 B an element), "
        f"{b10[0]:.4f} for a design that reads x twice (10 B)")
    log(f"  row 3b, the serving set through ops.qdq_cast, in turns: cast + "
        f".to(bf16) {turns[0]:.4f} / {turns[3]:.4f} (device "
        f"{dev_chain:.4f}), bf16 written directly {turns[1]:.4f} / "
        f"{turns[2]:.4f} (device {dev_direct:.4f})")
    log(f"  yardsticks: the kernel as a copy (code 2, f32) {t['copy'][0]:.4f}"
        f" ({t['copy'][1]:.4f}), torch's clone {t['clone'][0]:.4f} "
        f"({t['clone'][1]:.4f})")
    common = {"max_abs_err": err, "library_ms": None}
    rows = {
        "qdq_cast": {"ms": t["two_bf"][0], "plain_ms": p["two_bf"],
                     "bound_ms": b6[0], "bound_by": b6[1],
                     "reread_bound_ms": b10[0],
                     "device_ms": t["two_bf"][1],
                     "f32_out_ms": t["two"][0],
                     "f32_out_device_ms": t["two"][1],
                     "f32_out_plain_ms": p["two"],
                     "f32_out_bound_ms": b8[0],
                     "f32_out_reread_bound_ms": b12[0],
                     "chain_ms": [turns[0], turns[3]],
                     "direct_ms": [turns[1], turns[2]],
                     "copy_ms": t["copy"][0], "clone_ms": t["clone"][0]},
        "qdq_cast_one_pass": {"ms": t["one_bf"][0], "plain_ms": p["one_bf"],
                              "bound_ms": b6[0], "bound_by": b6[1],
                              "device_ms": t["one_bf"][1],
                              "f32_out_ms": t["one"][0],
                              "f32_out_device_ms": t["one"][1],
                              "f32_out_plain_ms": p["one"],
                              "f32_out_bound_ms": b8[0]}}
    return {k: {**common, **v} for k, v in rows.items()}


def _segments(B, S, dev, seed):
    g = torch.Generator().manual_seed(seed)
    seg = torch.zeros((B, S), dtype=torch.int32)
    for b in range(B):
        for c in torch.randperm(S - 1, generator=g)[:3] + 1:
            seg[b, int(c):] += 1
    return seg.to(dev)


def _sdpa(q, k, v, **kw):
    """torch's own attention on (B, S, H, D) tensors: the yardstick, timed
    here and used nowhere in the port. Grouped heads through
    ``enable_gqa`` where this torch has it, else K/V repeated per head."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    try:
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                              **kw)
    except TypeError:
        rep = q.shape[2] // k.shape[2]
        return F.scaled_dot_product_attention(
            qt, kt.repeat_interleave(rep, 1), vt.repeat_interleave(rep, 1),
            **kw)


#: (D, Dv) at which the tensor-core forward is held to the plain version:
#: the test and LM head dims, the wide heads, and a Dv != D
TC_HEAD_DIMS = ((16, 16), (64, 64), (128, 128), (192, 192), (256, 256),
                (192, 128))
#: (D, Dv) at which the split-TF32 forward is held to the plain version:
#: the test and LM head dims, both Dv != D orders, the narrowest, and the
#: wide heads
TF32_HEAD_DIMS = ((16, 16), (64, 64), (64, 32), (32, 64), (8, 8), (128, 128),
                  (192, 128), (256, 256))


def _flash_pair(q, k, v, seg, kw, what, route):
    """The forward kernel of ``route`` (checked against ``fwd_route``)
    against the plain forward, o within ``tolerance`` and the LSE within
    ``close_lse``."""
    from repro_torch.kernels import flash_attention as fa
    check(fa.fwd_route(q.dtype, q.shape[-1], v.shape[-1]) == route,
          f"{what}: the {route} route")
    o, lse = fa.flash_attention_cuda(q, k, v, seg, with_lse=True, **kw)
    o_r, lse_r = fa.flash_attention_ref(q, k, v, seg, with_lse=True, **kw)
    err = close(o, o_r, what)
    close_lse(lse, lse_r, what)
    return err


def _simt_fwd_args(q, k, v, seg, o, lse, causal, window):
    """``tri_flash_fwd``'s arguments (the SIMT forward's raw entry), from
    tensors on the card."""
    from repro_torch.kernels import flash_attention as fa
    B, S, H, D = q.shape
    K, Dv = k.shape[2], v.shape[-1]
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if seg is None else seg.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), fa._DTYPE_CODE[q.dtype],
            B, S, H, K, D, Dv, int(causal), int(window), D ** -0.5,
            torch.cuda.current_stream().cuda_stream)


def _simt_fwd_raw(q, k, v, seg, kw, what):
    """The SIMT forward through its raw entry (``tri_flash_fwd``, whatever
    ``fwd_route`` picks for these inputs: f32 at head dims that are
    multiples of 8 now takes the split-TF32 kernel) against the plain
    forward: o within ``tolerance``, the LSE within ``close_lse`` -> max
    |err|."""
    from repro_torch.kernels import flash_attention as fa
    o = torch.empty(q.shape[:3] + v.shape[-1:], dtype=q.dtype,
                    device=q.device)
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]), device=q.device)
    check(fa._lib().tri_flash_fwd(*_simt_fwd_args(q, k, v, seg, o, lse,
                                                  **kw)) == 0,
          f"{what}: SIMT forward launched")
    torch.cuda.synchronize()
    o_r, lse_r = fa.flash_attention_ref(q, k, v, seg, with_lse=True, **kw)
    err = close(o, o_r, what + " simt")
    close_lse(lse, lse_r, what + " simt")
    return err


def _time_f32_forward(q, k, v, bw, f32_ops, tf32_rate, what):
    """The f32 forward at one causal shape (no LSE): the split-TF32 kernel
    (f32's route) and the SIMT kernel through its raw entry, each held to
    the plain version here first, then timed in turns in both orders; the
    plain version, SDPA's f32 forward, the 3xTF32 bound and the f32-FMA
    bound -> {key: ms, and each kernel's max |err|}."""
    from repro_torch.kernels import flash_attention as fa
    B, S, H, D = q.shape
    K = k.shape[2]
    err = {"err_tf32": close(fa.flash_attention_cuda(q, k, v, causal=True),
                             fa.flash_attention_ref(q, k, v, causal=True),
                             f"{what} B{B} tf32"),
           "err_simt": _simt_fwd_raw(q, k, v, None, dict(causal=True,
                                                         window=0),
                                     f"{what} B{B}")}
    o = torch.empty_like(q)
    tf32, simt = fa._tf32_fwd_lib(), fa._lib()
    args = _simt_fwd_args(q, k, v, None, o, None, True, 0)
    raw = {"tf32": lambda: tf32.tri_flash_fwd_tf32(*args),
           "simt": lambda: simt.tri_flash_fwd(*args)}
    turns = {r: [] for r in raw}
    for order in (("tf32", "simt"), ("simt", "tf32")):
        for r in order:
            turns[r].append(time_ms(raw[r], iters=10 if r == "tf32" else 4))
    pairs = B * H * S * (S + 1) / 2            # causal pairs this run needs
    nbytes = 4 * (2 * B * S * H * D + 2 * B * S * K * D)
    nops = pairs * 4 * D
    t = {"tf32": statistics.median(turns["tf32"]),
         "simt": statistics.median(turns["simt"]),
         "plain": time_ms(lambda: fa.flash_attention_ref(q, k, v), iters=2,
                          reps=3),
         "sdpa": time_ms(lambda: _sdpa(q, k, v, is_causal=True), iters=5),
         "tf32_bound": bound(nbytes, 3 * nops, bw, tf32_rate),
         "fma_bound": bound(nbytes, nops, bw, f32_ops), **err}
    log(f"{what} B{B} S{S} H{H}/K{K} D{D} f32 causal: split-TF32 kernel "
        f"{t['tf32']:.5f} ms (turns "
        f"{', '.join(f'{x:.5f}' for x in turns['tf32'])}), SIMT kernel "
        f"{t['simt']:.5f} ms (turns "
        f"{', '.join(f'{x:.5f}' for x in turns['simt'])}), plain "
        f"{t['plain']:.4f} ms, sdpa (f32) {t['sdpa']:.4f} ms, bound "
        f"{t['tf32_bound'][0]:.5f} ms ({t['tf32_bound'][1]}, three TF32 "
        f"products a product at the tensor cores' dense rate; the f32-FMA "
        f"bound {t['fma_bound'][0]:.5f} ms)")
    return t


def _time_f32_fwd_bwd(q, k, v, gen) -> dict:
    """The f32 forward and backward pair at one causal shape: through
    ``ops.flash_attention`` and ``torch.autograd.grad`` (the split-TF32
    forward with LSE, delta, the split-TF32 dQ and dK/dV) beside SDPA's f32
    forward and backward, in turns -> {"kernels": ms, "sdpa": ms}."""
    from repro_torch.kernels import ops
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    do = torch.randn(q.shape, generator=gen, device=q.device)
    do_t = do.transpose(1, 2)

    def ours():
        torch.autograd.grad(ops.flash_attention(qg, kg, vg, causal=True),
                            (qg, kg, vg), do)

    def lib():
        torch.autograd.grad(_sdpa(qg, kg, vg, is_causal=True), (qg, kg, vg),
                            do_t)
    turns = {"kernels": [], "sdpa": []}
    for order in ((ours, lib), (lib, ours)):
        for fn in order:
            turns["kernels" if fn is ours else "sdpa"].append(
                time_ms(fn, iters=5, reps=3))
    return {key: statistics.median(x) for key, x in turns.items()}


def check_flash(dev, bw, f32_ops, tc_rate, tf32_rate):
    """The three forward kernels against the plain version. The tensor-core
    kernel (bf16) over every variant (causal, not causal, window,
    segments), GQA rep 1 and 3 and each (D, Dv) of ``TC_HEAD_DIMS`` at S
    256, then at the main paths' shapes: B 1, 2, 4, 8, S 1024, 9 heads, kv
    3, head_dim 64, causal, with the LSE. The split-TF32 kernel (f32) over
    every variant, GQA rep 1, 2 and 3 and each (D, Dv) of
    ``TF32_HEAD_DIMS`` at S 256; ``fwd_tf32_smem`` must equal the source's
    own size at every head dim the route takes. The SIMT kernel over every
    variant at the test shapes (S 256 and 512, GQA rep 2 and 3): in bf16
    at head dims 24 and 40 through its route, in f32 at head dims 16 and
    64 through its raw entry (f32 there takes the split-TF32 route). Each
    held to ``tolerance`` (o) and ``close_lse`` (LSE). Timed at the
    serving prefill's shape (B 1, S 1024, causal, bf16, no LSE): the
    tensor-core and SIMT kernels, the plain version, SDPA and the bound.
    Then in f32 at B 1 and B 8 (S 1024, 9/3 heads, D 64, causal): the
    split-TF32 and SIMT kernels in turns, the plain version, SDPA's f32
    forward, the 3xTF32 and f32-FMA bounds; at B 8 also the f32 forward
    and backward through ``ops.flash_attention`` beside SDPA's."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(6)
    variants = ("causal", "noncausal", "window", "segments")

    def inputs(B, S, H, K, D, Dv, dtype):
        return tuple(torch.randn(sh, generator=gen, device=dev).to(dtype)
                     for sh in ((B, S, H, D), (B, S, K, D), (B, S, K, Dv)))

    def kw_of(variant):
        return dict(causal=variant != "noncausal",
                    window=100 if variant == "window" else 0)

    err_tc, n_tc = 0.0, 0
    for D, Dv in TC_HEAD_DIMS:
        for H, K in ((4, 4), (9, 3)):
            q, k, v = inputs(2, 256, H, K, D, Dv, torch.bfloat16)
            for variant in variants:
                seg = _segments(2, 256, dev, D + H) \
                    if variant == "segments" else None
                err_tc = max(err_tc, _flash_pair(
                    q, k, v, seg, kw_of(variant),
                    f"flash tc {D}/{Dv} {H}/{K} {variant}", "tc"))
                n_tc += 1
    S, H, K, D = 1024, 9, 3, 64
    for B in (1, 2, 4, 8):
        q, k, v = inputs(B, S, H, K, D, D, torch.bfloat16)
        err_tc = max(err_tc, _flash_pair(q, k, v, None, kw_of("causal"),
                                         f"flash tc main shape B{B}", "tc"))
        n_tc += 1
    tf32 = fa._tf32_fwd_lib()
    dims8 = range(8, 257, 8)
    off = [(D_, Dv_) for D_ in dims8 for Dv_ in dims8
           if tf32.tri_flash_fwd_tf32_smem(D_, Dv_)
           != fa.fwd_tf32_smem(D_, Dv_)]
    check(not off, f"fwd_tf32_smem mirrors the split-TF32 source: {off[:4]}")
    err_tf, n_tf = 0.0, 0
    for D_, Dv_ in TF32_HEAD_DIMS:
        for H_, K_ in ((4, 4), (4, 2), (9, 3)):
            q, k, v = inputs(2, 256, H_, K_, D_, Dv_, torch.float32)
            for variant in variants:
                seg = _segments(2, 256, dev, D_ + Dv_ + H_) \
                    if variant == "segments" else None
                err_tf = max(err_tf, _flash_pair(
                    q, k, v, seg, kw_of(variant),
                    f"flash tf32 {D_}/{Dv_} {H_}/{K_} {variant}", "tf32"))
                n_tf += 1
    err_simt, n_simt = 0.0, 0
    for S_ in (256, 512):
        for H_, K_ in ((4, 2), (9, 3)):
            for D_, dtype in ((16, torch.float32), (64, torch.float32),
                              (24, torch.bfloat16), (40, torch.bfloat16)):
                q, k, v = inputs(2, S_, H_, K_, D_, D_, dtype)
                for variant in variants:
                    seg = _segments(2, S_, dev, S_) \
                        if variant == "segments" else None
                    what = f"flash simt {S_} {H_}/{K_} {D_} {dtype} {variant}"
                    err_simt = max(err_simt, _simt_fwd_raw(
                        q, k, v, seg, kw_of(variant), what)
                        if dtype == torch.float32 else _flash_pair(
                            q, k, v, seg, kw_of(variant), what, "simt"))
                    n_simt += 1
    torch.cuda.synchronize()
    log(f"flash_attention: tensor-core kernel {n_tc} variants, split-TF32 "
        f"kernel {n_tf} variants, SIMT kernel {n_simt} variants (f32 through "
        f"its raw entry) within tolerance (max|err| {err_tc:.3g}, "
        f"{err_tf:.3g}, {err_simt:.3g})")

    B = 1
    q, k, v = inputs(B, S, H, K, D, D, torch.bfloat16)
    got = ops.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_ref(q, k, v, causal=True)
    err_tc = max(err_tc, close(got, want, "flash main shape"))
    tc_lib, simt_lib = fa._tc_lib(), fa._lib()
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def raw_tc():
        tc_lib.tri_flash_fwd_tc(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                None, o.data_ptr(), None, B, S, H, K, D, D,
                                1, 0, D ** -0.5, stream)

    args16 = _simt_fwd_args(q, k, v, None, o, None, True, 0)
    ms = time_ms(raw_tc, iters=20)
    simt_bf16 = time_ms(lambda: simt_lib.tri_flash_fwd(*args16), iters=20)
    plain_ms = time_ms(lambda: fa.flash_attention_ref(q, k, v), iters=3)
    lib_ms = time_ms(lambda: _sdpa(q, k, v, is_causal=True), iters=20)
    pairs = B * H * S * (S + 1) / 2            # causal pairs this run needs
    nbytes = 2 * (2 * B * S * H * D + 2 * B * S * K * D)
    b_ms, by = bound(nbytes, pairs * 4 * D, bw, tc_rate)
    log(f"flash_attention B{B} S{S} H{H}/K{K} D{D} bf16 causal: tensor-core "
        f"kernel {ms:.4f} ms, SIMT kernel {simt_bf16:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms "
        f"({by})")
    out = {"flash_attention": {
        "max_abs_err": err_tc, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
        "fwd_route": "tc"}}

    # f32 at the same shape (row 6c's) and at B 8: the split-TF32 kernel,
    # f32's route, beside the SIMT kernel f32 took before
    t1 = _time_f32_forward(*(x.float() for x in (q, k, v)), bw, f32_ops,
                           tf32_rate, "flash_attention_tf32")
    q8, k8, v8 = inputs(8, S, H, K, D, D, torch.float32)
    t8 = _time_f32_forward(q8, k8, v8, bw, f32_ops, tf32_rate,
                           "flash_attention_tf32")
    pair = _time_f32_fwd_bwd(q8, k8, v8, gen)
    log(f"  f32 forward + backward B8 S{S} H{H}/K{K} D{D} causal: "
        f"ops.flash_attention + autograd.grad (split TF32) "
        f"{pair['kernels']:.4f} ms, sdpa forward + backward (f32) "
        f"{pair['sdpa']:.4f} ms")
    out["flash_attention_tf32"] = {
        "max_abs_err": max(err_tf, t1["err_tf32"], t8["err_tf32"]),
        "ms": t1["tf32"], "plain_ms": t1["plain"],
        "bound_ms": t1["tf32_bound"][0], "bound_by": t1["tf32_bound"][1],
        "library_ms": t1["sdpa"], "f32_fma_bound_ms": t1["fma_bound"][0],
        "fwd_route": "tf32", "simt_ms": t1["simt"], "b8_ms": t8["tf32"],
        "b8_simt_ms": t8["simt"], "b8_plain_ms": t8["plain"],
        "b8_library_ms": t8["sdpa"], "b8_bound_ms": t8["tf32_bound"][0],
        "b8_f32_fma_bound_ms": t8["fma_bound"][0],
        "b8_fwd_bwd_ms": pair["kernels"],
        "b8_library_fwd_bwd_ms": pair["sdpa"]}
    out["flash_attention_simt"] = {
        "max_abs_err": max(err_simt, t1["err_simt"], t8["err_simt"]),
        "ms": t1["simt"], "plain_ms": t1["plain"],
        "bound_ms": t1["fma_bound"][0], "bound_by": t1["fma_bound"][1],
        "library_ms": t1["sdpa"], "fwd_route": "simt",
        "bf16_ms": simt_bf16, "b8_ms": t8["simt"]}
    return out


def _bwd_inputs(B, S, H, K, D, Dv, dtype, dev, gen, seg=None, **kw):
    """q, k, v, dO and the plain forward's (o, lse) for one shape."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = (torch.randn(s, generator=gen, device=dev).to(dtype)
                   for s in ((B, S, H, D), (B, S, K, D), (B, S, K, Dv),
                             (B, S, H, Dv)))
    o, lse = fa.flash_attention_ref(q, k, v, seg, with_lse=True, **kw)
    return q, k, v, do, o, lse


def _bwd_pair(q, k, v, do, o, lse, seg, kw, what):
    """The three backward kernels against their plain versions on the same
    inputs -> (the route ``bwd_route`` gave dQ and dK/dV, max |err| per
    kernel); the launches must be counted on that route."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    route = fa.bwd_route(q.dtype, q.shape[-1], v.shape[-1])
    before = dict(ops.LAUNCHES)
    delta = ops.flash_bwd_delta(o, do)
    delta_r = fa.flash_bwd_delta_ref(o, do)
    dq = ops.flash_bwd_dq(q, k, v, do, lse, delta_r, seg, **kw)
    dq_r = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta_r, seg, **kw)
    dk, dv = ops.flash_bwd_dkv(q, k, v, do, lse, delta_r, seg, **kw)
    dk_r, dv_r = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta_r, seg, **kw)
    torch.cuda.synchronize()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        check(ops.LAUNCHES[f"{name}_{route}"] == before[f"{name}_{route}"] + 1,
              f"{what}: {name} on the {route} route")
    return route, {"delta": close(delta, delta_r, what + " delta"),
                   "dq": close(dq, dq_r, what + " dq"),
                   "dkv": max(close(dk, dk_r, what + " dk"),
                              close(dv, dv_r, what + " dv"))}


def _simt_raw(q, k, v, do, o, lse, seg, kw, what):
    """The SIMT dQ and dK/dV through their raw entry (``tri_flash_bwd_dq``
    / ``tri_flash_bwd_dkv``, whatever ``bwd_route`` picks for these inputs:
    f32 callers now get the split-TF32 kernels) against their plain
    versions on the same inputs -> max |err| (dq, dk/dv)."""
    from repro_torch.kernels import flash_attention as fa
    B, S, H, D = q.shape
    K, Dv = k.shape[2], v.shape[-1]
    delta = fa.flash_bwd_delta_ref(o, do)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    ins = tuple(x.data_ptr() for x in (q, k, v, do, lse, delta)) + (
        None if seg is None else seg.data_ptr(),)
    dims = (fa._DTYPE_CODE[q.dtype], B, S, H, K, D, Dv, int(kw["causal"]),
            int(kw["window"]), D ** -0.5, fa.bwd_rows(D, Dv))
    lib, stream = fa._bwd_lib(), torch.cuda.current_stream().cuda_stream
    check(lib.tri_flash_bwd_dq(*ins, dq.data_ptr(), *dims, stream) == 0,
          f"{what}: SIMT dq launched")
    check(lib.tri_flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(), *dims,
                                stream) == 0, f"{what}: SIMT dk/dv launched")
    torch.cuda.synchronize()
    dk_r, dv_r = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, seg, **kw)
    return (close(dq, fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, seg, **kw),
                  what + " simt dq"),
            max(close(dk, dk_r, what + " simt dk"),
                close(dv, dv_r, what + " simt dv")))


def _lm_rungs():
    return [int(r) for r in
            LM_TRAIN_ARGS[LM_TRAIN_ARGS.index("--rungs") + 1].split(",")]


BWD_VARIANTS = ("causal", "noncausal", "window", "segments")


def check_flash_bwd(dev, bw, f32_ops, tc_rate, tf32_rate):
    """The three backward kernels (delta, dQ, dK/dV) against their plain
    versions, each fed the same (q, k, v, dO, o, lse, delta), within
    ``flash_attention.tolerance`` (1e-5 of the largest magnitude plus 1e-5
    relative, and one bf16 ulp in bf16: the sums run in another order, the
    SIMT kernels contract a*b+c, the tensor-core kernels carry P and dS as
    bf16 hi + lo, the split-TF32 kernels every operand as tf32 hi + lo).
    Through the route (``flash_attention.bwd_route``): every bf16 variant
    at the tensor-core head dims takes the tensor-core dQ and dK/dV, every
    f32 variant the split-TF32 ones, and bf16 at head dims 24/64 and 64/40
    the SIMT ones; the launches are counted on that route. Every f32
    variant also runs the SIMT dQ and dK/dV through their raw entry, held
    to the same plain versions; ``bwd_tf32_smem`` must equal the source's
    own size at every head dim the split-TF32 route takes. Over every
    variant (causal, not causal, window, segments): S 256 and 512, GQA rep
    2 and 3, head dims 16 and 64 and two Dv != D, f32 and bf16; then at
    the wide head dims (192, 192),
    (256, 256) and (192, 128) (the SIMT and split-TF32 kernels on 32-row
    tiles, ``flash_attention.bwd_rows``), S 256, 4/2 heads. Then at the LM
    training path's shapes, B = each rung (2, 4, 8), S 1024, 9/3 heads,
    head_dim 64, bf16, causal: the forward kernel with its LSE output (as
    the autograd Function runs it; the tensor-core route) against the
    plain forward's (o, lse), and the three backward kernels. At the top
    rung all are timed: the forward (its SIMT kernel beside it), delta,
    and dQ and dK/dV on the tensor cores beside the SIMT kernels on the
    same bf16 inputs (the route bf16 took before); then in f32 at the same
    shape the split-TF32 dQ and dK/dV (f32's route) and the SIMT ones
    (the route f32 took before), in turns, each row with its bound: the
    split-TF32 rows at the TF32 tensor-core rate for three products a
    product, the f32-FMA bound beside it. The library yardstick for the
    backward rows is the backward of ``scaled_dot_product_attention`` at
    that shape and type (``torch.autograd.grad`` from a saved forward),
    one time for the rows; for the forward row, its forward."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(8)
    err = {r: {"delta": 0.0, "dq": 0.0, "dkv": 0.0}
           for r in ("tc", "tf32", "simt")}
    tf32 = fa._tf32_bwd_lib()
    dims8 = range(8, 257, 8)
    off = [(name, D, Dv) for kern, name in enumerate(("dq", "dkv"))
           for D in dims8 for Dv in dims8
           if tf32.tri_flash_bwd_tf32_smem(kern, D, Dv, fa.bwd_rows(D, Dv))
           != fa.bwd_tf32_smem(name, D, Dv)]
    check(not off, f"bwd_tf32_smem mirrors the split-TF32 source: {off[:4]}")

    def run(S, H, K, D, Dv, dtype, variant, what):
        seg = _segments(2, S, dev, S) if variant == "segments" else None
        kw = dict(causal=variant != "noncausal",
                  window=100 if variant == "window" else 0)
        ins = _bwd_inputs(2, S, H, K, D, Dv, dtype, dev, gen, seg, **kw)
        what = f"flash bwd {what} {dtype} {variant}"
        route, got = _bwd_pair(*ins, seg, kw, what)
        want = ("tf32" if dtype == torch.float32 else
                "tc" if fa.fwd_route(dtype, D, Dv) == "tc" else "simt")
        check(route == want, f"{what}: route {route}")
        err[route] = {k: max(e, got[k]) for k, e in err[route].items()}
        if dtype == torch.float32:      # the SIMT kernels, held all the same
            e_dq, e_dkv = _simt_raw(*ins, seg, kw, what)
            err["simt"]["dq"] = max(err["simt"]["dq"], e_dq)
            err["simt"]["dkv"] = max(err["simt"]["dkv"], e_dkv)
        return route

    def summary(routes):
        return "; ".join(
            f"{routes.count(r)} on the {r} route (max|err| delta "
            f"{err[r]['delta']:.3g}, dq {err[r]['dq']:.3g}, dk/dv "
            f"{err[r]['dkv']:.3g})" for r in ("tc", "tf32", "simt")) + (
            f"; the SIMT kernels through their raw entry on each f32 "
            f"variant, max|err| dq {err['simt']['dq']:.3g}, dk/dv "
            f"{err['simt']['dkv']:.3g}")

    shapes = [(S, hk, D, D) for S in (256, 512) for hk in ((4, 2), (9, 3))
              for D in (16, 64)] + [(256, (9, 3), 64, 32),
                                    (256, (4, 2), 32, 64)]
    routes = [run(S, H, K, D, Dv, dtype, variant, f"{S} {H}/{K} {D}/{Dv}")
              for S, (H, K), D, Dv in shapes
              for dtype in (torch.float32, torch.bfloat16)
              for variant in BWD_VARIANTS]
    # bf16 at head dims the tensor-core kernels refuse: the SIMT route
    routes += [run(256, H, K, D, Dv, torch.bfloat16, variant,
                   f"256 {H}/{K} {D}/{Dv}")
               for (H, K), D, Dv in (((4, 2), 24, 64), ((9, 3), 64, 40))
               for variant in BWD_VARIANTS]
    log(f"flash_attention backward: {len(routes)} variants within "
        f"tolerance, {summary(routes)}")
    wide = []
    for D, Dv in ((192, 192), (256, 256), (192, 128)):
        check(fa.bwd_rows(D, Dv) == 32,
              "SIMT and split TF32: 32-row tiles above head dim 128")
        wide += [run(256, 4, 2, D, Dv, dtype, variant, f"{D}/{Dv}")
                 for dtype in (torch.float32, torch.bfloat16)
                 for variant in BWD_VARIANTS]
    log(f"flash_attention backward at head dims (192, 192), (256, 256), "
        f"(192, 128): {len(wide)} variants within tolerance, "
        f"{summary(wide)}")
    time_wide_heads(dev, gen, bw, tc_rate)

    S, H, K, D = 1024, 9, 3, 64
    kw = dict(causal=True, window=0)
    err_fwd = 0.0
    for B in _lm_rungs():
        q, k, v, do, o, lse = _bwd_inputs(B, S, H, K, D, D, torch.bfloat16,
                                          dev, gen, **kw)
        what = f"flash train shape B{B}"
        o_k, lse_k = fa.flash_attention_cuda(q, k, v, None, with_lse=True,
                                             **kw)
        err_fwd = max(err_fwd, close(o_k, o, what + " fwd"))
        close_lse(lse_k, lse, what + " fwd")
        route, got = _bwd_pair(q, k, v, do, o, lse, None, kw, what + " bwd")
        check(route == "tc", f"{what}: the tensor-core backward")
        err["tc"] = {key: max(e, got[key]) for key, e in err["tc"].items()}
    log(f"flash_attention forward (with LSE) and backward at the training "
        f"rungs {_lm_rungs()}: within tolerance (max|err| fwd "
        f"{err_fwd:.3g}; tensor-core route: delta {err['tc']['delta']:.3g}, "
        f"dq {err['tc']['dq']:.3g}, dk/dv {err['tc']['dkv']:.3g})")
    # timed at the top rung: the inputs of the loop's last pass
    lib, tc_bwd = fa._bwd_lib(), fa._tc_bwd_lib()
    stream = torch.cuda.current_stream().cuda_stream
    tc_lib, simt_lib = fa._tc_lib(), fa._lib()
    o_t, lse_t = torch.empty_like(o), torch.empty_like(lse)
    check(fa.fwd_route(q.dtype, D, D) == "tc", "the training path's route")

    def raw_fwd():
        tc_lib.tri_flash_fwd_tc(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                None, o_t.data_ptr(), lse_t.data_ptr(), B,
                                S, H, K, D, D, 1, 0, D ** -0.5, stream)

    def raw_simt():
        simt_lib.tri_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               None, o_t.data_ptr(), lse_t.data_ptr(), 1, B,
                               S, H, K, D, D, 1, 0, D ** -0.5, stream)

    pairs = B * H * S * (S + 1) / 2            # causal pairs this run needs

    def work(e):
        """(bytes: each input read once, each output written once; ops) of
        each kernel at this shape, for elements of ``e`` bytes."""
        nq, nkv, nl = B * S * H * D * e, B * S * K * D * e, B * H * S * 4
        return {"fwd": (2 * nq + 2 * nkv + nl, pairs * 4 * D),
                "delta": (2 * nq + nl, 2 * B * S * H * D),
                "dq": (2 * nq + 2 * nkv + 2 * nl + nq, pairs * 2 * (3 * D)),
                "dkv": (2 * nq + 2 * nkv + 2 * nl + 2 * nkv,
                        pairs * 2 * (4 * D))}

    fwd_ms = time_ms(raw_fwd, iters=10)
    simt_ms = time_ms(raw_simt, iters=10)
    fwd_plain = time_ms(lambda: fa.flash_attention_ref(
        q, k, v, None, with_lse=True, **kw), iters=2, reps=3)
    fwd_lib = time_ms(lambda: _sdpa(q, k, v, is_causal=True), iters=10)
    fb_ms, fby = bound(*work(2)["fwd"], bw, tc_rate)
    log(f"flash_attention (with LSE) B{B} S{S} H{H}/K{K} D{D} bf16 causal: "
        f"tensor-core kernel {fwd_ms:.4f} ms, SIMT kernel {simt_ms:.4f} ms, "
        f"plain {fwd_plain:.4f} ms, sdpa {fwd_lib:.4f} ms, bound "
        f"{fb_ms:.5f} ms ({fby})")
    out = {"flash_attention@lm_train": {
        "max_abs_err": err_fwd, "ms": fwd_ms, "plain_ms": fwd_plain,
        "bound_ms": fb_ms, "bound_by": fby, "library_ms": fwd_lib,
        "fwd_route": "tc"}}
    delta = torch.empty((B, H, S), device=dev)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    ptr = lambda t: t.data_ptr()          # noqa: E731
    dims = (B, S, H, K, D, D, 1, 0, D ** -0.5)
    ins = (ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), None)
    dgeo = fa.delta_geometry(H, D, 2)
    raw = {
        "delta": lambda: lib.tri_flash_bwd_delta(
            ptr(o), ptr(do), ptr(delta), 1, B, S, H, D, dgeo.ts, dgeo.lpr,
            stream),
        "dq": lambda: tc_bwd.tri_flash_bwd_dq_tc(*ins, ptr(dq), *dims,
                                                 stream),
        "dkv": lambda: tc_bwd.tri_flash_bwd_dkv_tc(
            *ins, ptr(dk), ptr(dv),
            *(w.data_ptr() if w is not None else None
              for w in fa.dkv_workspace(k, v, H)), *dims, stream),
    }
    simt_bf16 = {   # the SIMT kernels on the same bf16 inputs
        "dq": lambda: lib.tri_flash_bwd_dq(*ins, ptr(dq), 1, *dims,
                                           fa.bwd_rows(D, D), stream),
        "dkv": lambda: lib.tri_flash_bwd_dkv(*ins, ptr(dk), ptr(dv), 1,
                                             *dims, fa.bwd_rows(D, D),
                                             stream),
    }
    plain = {
        "delta": lambda: fa.flash_bwd_delta_ref(o, do),
        "dq": lambda: fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kw),
        "dkv": lambda: fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw),
    }
    lib_ms = _sdpa_bwd_ms(q, k, v, do)
    for key, name in (("delta", "flash_attention_bwd_delta"),
                      ("dq", "flash_attention_bwd_dq"),
                      ("dkv", "flash_attention_bwd_dkv")):
        ms = time_ms(raw[key], iters=10)
        plain_ms = time_ms(plain[key], iters=2, reps=3)
        b_ms, by = bound(*work(2)[key], bw, tc_rate)
        e = max(err["tc"][key], err["simt"][key]) if key == "delta" \
            else err["tc"][key]
        simt = (f", SIMT kernel on the same bf16 inputs "
                f"{time_ms(simt_bf16[key], iters=5):.4f} ms"
                if key in simt_bf16 else "")
        if key == "delta":
            dev_ms = device_ms(raw[key])
            simt += f", device time (profiler) {dev_ms:.5f} ms"
        log(f"{name} B{B} S{S} H{H}/K{K} D{D} bf16 causal: kernel "
            f"{ms:.4f} ms{simt}, plain {plain_ms:.4f} ms, bound {b_ms:.5f} "
            f"ms ({by}), max|err| {e:.3g}")
        out[name] = {"max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms}
        if key != "delta":
            out[name]["bwd_route"] = "tc"
        else:
            out[name]["device_ms"] = dev_ms
    log(f"  sdpa backward (all three together, bf16) {lib_ms:.4f} ms")

    # f32 at the same shape: the split-TF32 kernels (f32's route) and the
    # SIMT kernels (the route f32 took before), timed in turns
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    o32, lse32 = fa.flash_attention_ref(q32, k32, v32, with_lse=True, **kw)
    delta32 = fa.flash_bwd_delta_ref(o32, do32)
    args32 = (q32, k32, v32, do32, lse32, delta32)
    check(fa.bwd_route(torch.float32, D, D) == "tf32", "f32 route")
    e_tf = {"dq": close(fa.flash_bwd_dq_cuda(*args32, **kw),
                        fa.flash_bwd_dq_ref(*args32, **kw),
                        "flash bwd tf32 f32 dq"),
            "dkv": max(close(a_, b_, "flash bwd tf32 f32 dk/dv")
                       for a_, b_ in zip(fa.flash_bwd_dkv_cuda(*args32, **kw),
                                         fa.flash_bwd_dkv_ref(*args32,
                                                              **kw)))}
    e_simt = dict(zip(("dq", "dkv"), _simt_raw(
        q32, k32, v32, do32, o32, lse32, None, kw, "flash bwd simt f32")))
    lib32 = _sdpa_bwd_ms(q32, k32, v32, do32)
    dq32, dk32, dv32 = (torch.empty_like(x) for x in (q32, k32, v32))
    ins32 = tuple(ptr(x) for x in args32) + (None,)
    dims32 = (0,) + dims + (fa.bwd_rows(D, D),)
    raw32 = {
        "tf32": {
            "dq": lambda: tf32.tri_flash_bwd_dq_tf32(*ins32, ptr(dq32),
                                                     *dims32, stream),
            "dkv": lambda: tf32.tri_flash_bwd_dkv_tf32(
                *ins32, ptr(dk32), ptr(dv32), *dims32, stream)},
        "simt": {
            "dq": lambda: lib.tri_flash_bwd_dq(*ins32, ptr(dq32), *dims32,
                                               stream),
            "dkv": lambda: lib.tri_flash_bwd_dkv(*ins32, ptr(dk32),
                                                 ptr(dv32), *dims32,
                                                 stream)}}
    turns = {(r, key): [] for r in raw32 for key in ("dq", "dkv")}
    for order in (("tf32", "simt"), ("simt", "tf32")):
        for r in order:
            for key in ("dq", "dkv"):
                turns[(r, key)].append(time_ms(raw32[r][key], iters=5))
    plain32 = {"dq": time_ms(lambda: fa.flash_bwd_dq_ref(*args32, **kw),
                             iters=2, reps=3),
               "dkv": time_ms(lambda: fa.flash_bwd_dkv_ref(*args32, **kw),
                              iters=2, reps=3)}
    for key in ("dq", "dkv"):
        fma_ms, fma_by = bound(*work(4)[key], bw, f32_ops)
        nbytes, nops = work(4)[key]
        tf_ms, tf_by = bound(nbytes, 3 * nops, bw, tf32_rate)
        for r in ("tf32", "simt"):
            name = f"flash_attention_bwd_{key}_{r}"
            t = turns[(r, key)]
            ms = statistics.median(t)
            e = max(e_tf[key], err["tf32"][key]) if r == "tf32" else max(
                e_simt[key], err["simt"][key])
            b_ms, by = (tf_ms, tf_by) if r == "tf32" else (fma_ms, fma_by)
            log(f"{name} B{B} S{S} H{H}/K{K} D{D} f32 causal: kernel "
                f"{ms:.5f} ms (turns {', '.join(f'{x:.5f}' for x in t)}), "
                f"plain {plain32[key]:.4f} ms, sdpa backward (f32) "
                f"{lib32:.4f} ms, bound {b_ms:.5f} ms ({by}"
                + (", three TF32 products a product at the tensor cores' "
                   f"dense rate; the f32-FMA bound {fma_ms:.5f} ms)"
                   if r == "tf32" else ", f32 outside the tensor cores)")
                + f", max|err| {e:.3g}")
            out[name] = {"max_abs_err": e, "ms": ms,
                         "plain_ms": plain32[key], "bound_ms": b_ms,
                         "bound_by": by, "library_ms": lib32,
                         "bwd_route": r}
            if r == "tf32":
                out[name]["f32_fma_bound_ms"] = fma_ms
    pair = {r: sum(out[f"flash_attention_bwd_{key}_{r}"]["ms"]
                   for key in ("dq", "dkv")) for r in ("tf32", "simt")}
    log(f"  f32 dQ + dK/dV: split TF32 {pair['tf32']:.5f} ms, SIMT "
        f"{pair['simt']:.5f} ms, sdpa backward (f32) {lib32:.4f} ms")
    return out


def _sdpa_bwd_ms(q, k, v, do) -> float:
    """Time of SDPA's whole backward (dq, dk, dv) from a saved causal
    forward at these inputs: the library yardstick of the backward rows."""
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    o_lib = _sdpa(qg, kg, vg, is_causal=True)
    do_t = do.transpose(1, 2)
    return time_ms(lambda: torch.autograd.grad(
        o_lib, (qg, kg, vg), do_t, retain_graph=True), iters=10)


def time_wide_heads(dev, gen, bw, tc_rate, D=256) -> None:
    """Log-only times at a wide-head shape no main path runs yet (gemma3-4b's
    head dim 256; B 1, S 1024, 8/4 heads, bf16, causal): the tensor-core
    forward with LSE, the dQ and dK/dV kernels on both routes (the
    tensor-core kernels; the SIMT kernels on 32-row tiles, the route bf16
    took before), SDPA's forward and backward, and each one's bound."""
    from repro_torch.kernels import flash_attention as fa
    B, S, H, K = 1, 1024, 8, 4
    q, k, v, do, o, lse = _bwd_inputs(B, S, H, K, D, D, torch.bfloat16,
                                      dev, gen)
    delta = fa.flash_bwd_delta_ref(o, do)
    pairs = B * H * S * (S + 1) / 2
    nq, nkv, nl = B * S * H * D * 2, B * S * K * D * 2, B * H * S * 4
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    o_lib = _sdpa(qg, kg, vg, is_causal=True)
    lib, stream = fa._bwd_lib(), torch.cuda.current_stream().cuda_stream
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    ins = tuple(x.data_ptr() for x in (q, k, v, do, lse, delta)) + (None,)
    dims = (1, B, S, H, K, D, D, 1, 0, D ** -0.5, fa.bwd_rows(D, D))
    check(fa.bwd_route(q.dtype, D, D) == "tc", "head dim 256: tensor cores")
    b_dq, b_dkv = (3 * nq + 2 * nkv + 2 * nl, pairs * 6 * D), \
        (2 * nq + 4 * nkv + 2 * nl, pairs * 8 * D)
    times = {
        "forward (tensor cores, LSE)": (
            lambda: fa.flash_attention_cuda(q, k, v, with_lse=True),
            (2 * nq + 2 * nkv + nl, pairs * 4 * D)),
        "dQ (tensor cores)": (
            lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta), b_dq),
        "dK/dV (tensor cores)": (
            lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta), b_dkv),
        "dQ (SIMT, 32-row tiles)": (
            lambda: lib.tri_flash_bwd_dq(*ins, dq.data_ptr(), *dims, stream),
            b_dq),
        "dK/dV (SIMT, 32-row tiles)": (
            lambda: lib.tri_flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(),
                                          *dims, stream), b_dkv),
        "sdpa forward": (lambda: _sdpa(q, k, v, is_causal=True), None),
        "sdpa backward": (lambda: torch.autograd.grad(
            o_lib, (qg, kg, vg), do.transpose(1, 2), retain_graph=True),
            None),
    }
    parts = []
    for what, (fn, work) in times.items():
        ms = time_ms(fn, iters=5, reps=3)
        b = f", bound {bound(*work, bw, tc_rate)[0]:.4f}" if work else ""
        parts.append(f"{what} {ms:.4f} ms{b}")
    log(f"  B{B} S{S} H{H}/K{K} D{D} bf16 causal: " + "; ".join(parts))


def check_flash_function(dev) -> dict:
    """The differentiable ``ops.flash_attention`` (forward kernel with LSE,
    then the three backward kernels) against autograd through the plain
    forward in f32 on the same inputs, on the card. In f32 (the split-TF32
    forward, dQ and dK/dV) each gradient within 1e-5 of its
    largest magnitude (the CPU parity test measures 4e-7 between the two
    formulations; the card adds its own summation order). In bf16 (the
    tensor-core routes, forward and backward) within 2^-7 of it: the
    gradients round to bf16 (half an ulp, up to 2^-8 of the largest
    magnitude) and delta is taken from the bf16 o; the same bf16 chain
    through the plain versions stays within it on the CPU
    (``tests/test_torch_flash_bwd_tc.py``), and the kernels add their one
    ulp. Head dim 64, and once 256. The launches are counted on each
    route -> the split-TF32 forward, dQ and dK/dV launches of the f32
    runs."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(9)
    f32_launches = {}
    for dtype, route, bwd, limit in (
            (torch.float32, "tf32", "tf32", 1e-5),
            (torch.bfloat16, "tc", "tc", 2.0 ** -7)):
        worst, n = 0.0, 0
        start = dict(ops.LAUNCHES)
        for S, variant, D in ((256, "causal", 64), (256, "segments", 64),
                              (512, "window", 64), (1024, "causal", 64),
                              (256, "causal", 256)):
            B, H, K = 2, 9, 3
            seg = _segments(B, S, dev, S + 1) \
                if variant == "segments" else None
            kw = dict(causal=True, window=100 if variant == "window" else 0)
            q, k, v, do = (torch.randn(s, generator=gen, device=dev).to(dtype)
                           for s in ((B, S, H, D), (B, S, K, D),
                                     (B, S, K, D), (B, S, H, D)))
            ins = [x.requires_grad_(True) for x in (q, k, v)]
            before = dict(ops.LAUNCHES)
            o = ops.flash_attention(*ins, segments=seg, **kw)
            got = torch.autograd.grad(o, ins, do)
            for key in ("flash_attention", f"flash_attention_{route}",
                        "flash_attention_bwd_delta", "flash_attention_bwd_dq",
                        f"flash_attention_bwd_dq_{bwd}",
                        "flash_attention_bwd_dkv",
                        f"flash_attention_bwd_dkv_{bwd}"):
                check(ops.LAUNCHES[key] == before[key] + 1,
                      f"Function launched {key} once ({dtype})")
            ins32 = [x.detach().float().requires_grad_(True) for x in ins]
            want = torch.autograd.grad(
                fa.flash_attention_ref(*ins32, seg, **kw), ins32, do.float())
            torch.cuda.synchronize()
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                gap = float((g.float() - w).abs().max()) / float(
                    w.abs().max())
                check(gap <= limit, f"Function {dtype} {S} {variant} D{D} "
                      f"{name}: {gap}")
                worst = max(worst, gap)
            n += 1
        grew = {k: ops.LAUNCHES[k] - start[k] for k in ops.LAUNCHES
                if ops.LAUNCHES[k] != start[k]}
        log(f"flash_attention Function, {dtype} (forward {route}, backward "
            f"{bwd}): gradients of {n} variants within {worst:.3g} of plain "
            f"autograd in f32 (relative to each gradient's max; limit "
            f"{limit:.3g}); launches {grew}")
        if dtype == torch.float32:
            f32_launches = {k: grew[k] for k in (
                "flash_attention_tf32", "flash_attention_bwd_dq_tf32",
                "flash_attention_bwd_dkv_tf32")}
    return f32_launches


def _decode_inputs(B, L, H, K, D, Dv, dtype, dev, gen):
    q = torch.randn((B, 1, H, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, L, K, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, L, K, Dv), generator=gen, device=dev).to(dtype)
    return q, k, v


def check_decode(dev, bw, tc_rate):
    """The split-key decode kernel against its plain version, within
    ``tolerance``, f32 and bf16: lengths 0, 1, L and between, and at the
    edges of the cluster's split (N = ``DECODE_CLUSTER`` blocks: below N,
    N, N + 1, c N +- 1 with c = 17 and 64, L - 1, L; and -5 and L + 9,
    which the kernel clamps) at 9/3 heads of 64 and 4/2 of 16, L 256 and
    2048; (D, Dv) = (64, 32) and (256, 256), rep 1 (2/2 heads), rep * Dv =
    2048 (8/1 heads of 256; a two-stage ring in f32), head dims that are not
    whole 16-byte chunks (20 / 36: plain loads); B 1, 2 and 4 at L 2048
    (the serving rungs). Length 0 gives exact zeros. Then at the main
    path's shape (B 4 against a 2048-slot bf16 cache, live lengths
    1024-1088): a bitwise repeat, the C side's shared memory against
    ``decode_geometry``, the kernel timed beside the plain version, SDPA
    with a length mask and the byte bound, by CUDA events and by the
    profiler's device time (also with every length 0: the fixed cost), and
    the cluster sizes 4, 8, 16 timed beside each other (log only)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(7)
    N = fa.DECODE_CLUSTER
    err, n = 0.0, 0

    def run(B, L, H, K, D, Dv, dtype, lens):
        nonlocal err, n
        q, k, v = _decode_inputs(B, L, H, K, D, Dv, dtype, dev, gen)
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = fa.flash_decode_cuda(q, k, v, lens)
        want = fa.flash_decode_ref(q, k, v, lens)
        what = f"decode B{B} L{L} {H}/{K} ({D}, {Dv}) {dtype}"
        err = max(err, close(got, want, what))
        zero = (lens <= 0).nonzero().flatten().tolist()
        check(all(bool((got[i] == 0).all()) for i in zero),
              f"{what}: length 0 gives 0")
        n += 1

    for dtype in (torch.float32, torch.bfloat16):
        for (H, K), D, L in (((4, 2), 16, 256), ((9, 3), 64, 256),
                             ((9, 3), 64, 2048)):
            c = [17, 64] if L > 64 * N else [17]
            edges = [0, 1, N - 1, N, N + 1, L - 1, L, 77, L // 2, -5, L + 9]
            edges += [x * N + d for x in c for d in (-1, 1)]
            run(len(edges), L, H, K, D, D, dtype, edges)
        for (H, K), D, Dv, L in (((9, 3), 64, 32, 256), ((4, 2), 256, 256, 256),
                                 ((2, 2), 64, 64, 2048), ((8, 1), 256, 256,
                                                          2048),
                                 ((4, 2), 20, 36, 256)):
            run(6, L, H, K, D, Dv, dtype, [0, 1, L, 77, L // 2 + 3, L - 1])
        for B in (1, 2, 4):
            run(B, 2048, 9, 3, 64, 64, dtype, [1088, 1071, 1040, 1024][:B])
    check(fa.decode_geometry(2048, 8, 256, 256, 4).stages == 2,
          "rep * Dv 2048 in f32 runs a two-stage ring")
    log(f"flash_decode: {n} variants within tolerance (max|err| {err:.3g}), "
        f"cluster of {N}")

    B, L, H, K, D = 4, 2048, 9, 3, 64
    q, k, v = _decode_inputs(B, L, H, K, D, D, torch.bfloat16, dev, gen)
    lens = torch.tensor([1088, 1071, 1040, 1024], dtype=torch.int32,
                        device=dev)
    got = ops.flash_decode(q, k, v, lens)
    want = fa.flash_decode_ref(q, k, v, lens)
    err = max(err, close(got, want, "decode main shape"))
    again = ops.flash_decode(q, k, v, lens)
    check(same(got, again), "decode main shape: a bitwise repeat")
    lib = fa._decode_lib()
    geo = fa.decode_geometry(L, H // K, D, D, 2)
    check(lib.tri_flash_decode_smem(1, L, H, K, D, D, geo.cluster, geo.tk,
                                    geo.stages, geo.lpr) == geo.smem,
          "decode shared memory: C and decode_geometry agree")
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def raw(cluster=N, lens=lens):
        g = fa.decode_geometry(L, H // K, D, D, 2, cluster)
        return lambda: lib.tri_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
            o.data_ptr(), 1, B, L, H, K, D, D, D ** -0.5, g.cluster, g.tk,
            g.stages, g.lpr, stream)

    sweep = {}
    for cluster in (4, 8, 16):
        check(raw(cluster)() == 0, f"decode launch, cluster {cluster}")
        torch.cuda.synchronize()
        close(o, want, f"decode main shape, cluster {cluster}")
        sweep[cluster] = time_ms(raw(cluster), iters=50)
    ms = time_ms(raw(), iters=50)
    dev_ms = device_ms(raw())
    # the fixed cost: every row of length 0 (launch, length read, barrier,
    # combine and write; no key loaded)
    floor_ms = device_ms(raw(lens=torch.zeros_like(lens)))
    plain_ms = time_ms(lambda: fa.flash_decode_ref(q, k, v, lens), iters=5)
    mask = (torch.arange(L, device=dev)[None, :] < lens[:, None]
            ).reshape(B, 1, 1, L)
    lib_ms = time_ms(lambda: _sdpa(q, k, v, attn_mask=mask), iters=50)
    lib_dev_ms = device_ms(lambda: _sdpa(q, k, v, attn_mask=mask))
    live = int(lens.sum())
    nbytes = 2 * (2 * B * H * D + 2 * live * K * D) + 4 * B
    b_ms, by = bound(nbytes, live * H * 4 * D, bw, tc_rate)
    log(f"flash_decode B{B} L{L} H{H}/K{K} D{D} bf16, live {lens.tolist()}: "
        f"kernel {ms:.5f} ms (cluster {N}; by cluster size "
        + ", ".join(f"{c}: {t:.5f}" for c, t in sweep.items())
        + f"), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms ({by}); device time (profiler) kernel "
        f"{dev_ms:.5f} ms (every length 0: {floor_ms:.5f} ms), sdpa "
        f"{lib_dev_ms:.5f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
            "device_ms": dev_ms, "library_device_ms": lib_dev_ms}


def check_delta(dev) -> float:
    """delta against its plain version, within ``tolerance``, and a bitwise
    repeat of each call: Dv 16, 40, 64, 128 and 256 (and 36, whose bf16
    rows are not whole 16-byte chunks: the scalar tail) in f32 and bf16 at
    B 2, S 1024, 9 heads; S 1000 (a partial last block) at Dv 64 in bf16;
    then the LM rungs (B 2, 4, 8, S 1024, 9 heads, Dv 64, bf16). -> max
    |err|."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(10)
    err, n = 0.0, 0
    cases = [(2, 1024, Dv, dt) for Dv in (16, 36, 40, 64, 128, 256)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(2, 1000, 64, torch.bfloat16)]
    cases += [(B, 1024, 64, torch.bfloat16) for B in _lm_rungs()]
    for B, S, Dv, dtype in cases:
        o, do = (torch.randn((B, S, 9, Dv), generator=gen, device=dev
                             ).to(dtype) for _ in range(2))
        got = ops.flash_bwd_delta(o, do)
        what = f"delta B{B} S{S} Dv{Dv} {dtype}"
        err = max(err, close(got, fa.flash_bwd_delta_ref(o, do), what))
        check(same(got, ops.flash_bwd_delta(o, do)), f"{what}: bitwise repeat")
        n += 1
    log(f"flash_attention_bwd_delta: {n} variants within tolerance and "
        f"repeating bitwise (max|err| {err:.3g})")
    return err


# ------------------------------- phase 4b: LM serving, card vs CPU ---
def _lm_cfg(layers: int):
    """smollm-135m at full width, cut to ``layers`` layers."""
    import dataclasses
    from repro_torch.configs import smollm_135m
    cfg = smollm_135m.config()
    seg = ((cfg.stack.segments[0][0], layers),)
    return dataclasses.replace(cfg, stack=dataclasses.replace(
        cfg.stack, segments=seg))


def check_lm_against_cpu(layers: int = 2, prompt: int = 1024,
                         total: int = 2048, steps: int = 4):
    """One prefill plus ``steps`` teacher-forced decode steps of
    smollm-135m at full width and ``layers`` layers, bf16 weights from one
    seeded init, on the card (kernels) and on the CPU (plain versions).
    Logits within 4 % of their largest magnitude (the bf16 rounding spread
    the CPU parity test sees against the reference,
    tests/test_torch_lm_serve.py), greedy tokens reported."""
    from repro_torch import tree as tu
    from repro_torch.models import lm
    from repro_torch.serve.engine import scatter_prefill
    cfg = _lm_cfg(layers)
    params = lm.lm_init(torch.Generator().manual_seed(3), cfg)
    params = tu.tree_map(lambda x: x.to(torch.bfloat16), params)
    g = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (1, prompt), generator=g,
                         dtype=torch.int32)
    feed = torch.randint(0, cfg.vocab_size, (steps, 1), generator=g,
                         dtype=torch.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        p = tu.tree_map(lambda x: x.to(dev), params)
        logits = []
        with torch.no_grad():
            lg, pre = lm.lm_prefill(p, {"tokens": toks.to(dev)}, cfg)
            logits.append(lg.float().cpu())
            caches = scatter_prefill(
                lm.lm_init_cache(cfg, 1, total, device=dev), pre, 0)
            for i in range(steps):
                lg, caches = lm.lm_decode_step(
                    p, feed[i].to(dev), caches,
                    torch.tensor([prompt + i], device=dev), cfg)
                logits.append(lg.float().cpu())
        out[dev] = torch.stack(logits)
    ref, got = out["cpu"], out["cuda"]
    gap = float((got - ref).abs().max())
    lim = 0.04 * float(ref.abs().max())
    same_top = (got.argmax(-1) == ref.argmax(-1)).float().mean()
    log(f"smollm-135m x{layers} layers, prefill {prompt} + {steps} decode "
        f"steps, card vs CPU: max|dlogit| {gap:.4g} (limit {lim:.4g}, max "
        f"|logit| {float(ref.abs().max()):.4g}), same argmax "
        f"{float(same_top):.2f}")
    check(bool(torch.isfinite(got).all()), "finite logits on the card")
    check(gap <= lim, f"card vs CPU logits {gap} > {lim}")


# ------------------------------ phase 4c: LM train step, card vs CPU ---
def check_lm_step_against_cpu(layers: int = 2, seq: int = 1024,
                              batch: int = 2):
    """One slab-resident train step of smollm-135m at full width and
    ``layers`` layers, S 1024, B 2, on the card (kernels, cuBLAS bf16
    matmuls) and on the CPU (plain versions), from the same init and
    batch. The model computes in bf16, so the two differ by bf16 roundings
    taken after sums in other orders (the CPU parity test against the
    reference measures up to 1.2e-2 of a leaf's largest gradient,
    tests/test_torch_lm_train.py): the momentum (the clipped gradient) is
    held leaf by leaf within 5e-2 of the leaf's largest magnitude, and what
    follows from it by the update's arithmetic:
      master   p_card - p_cpu = -lr * (m_card - m_cpu), up to 2^-21 (|p| +
               |p'_card| + |p'_cpu|): each side rounds once, relative to
               its own magnitudes
      copy     within the masters' gap plus half a bf16 step of each
    loss within rtol 1e-3, codes equal."""
    from repro_torch.core.precision import TriAccelConfig
    from repro_torch.data.synthetic import LMTaskStream
    from repro_torch.train.task import LMTask
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = _lm_cfg(layers)
    tac = TriAccelConfig(ladder="gpu", t_ctrl=1, curvature_method="fisher")
    tcfg = TrainerConfig(total_steps=10, base_lr=0.05, warmup_steps=2,
                         grad_clip=1.0, rungs=(batch,), seq_len=seq)
    data = LMTaskStream(cfg.vocab_size, seq, batch, seed=3).batch(0)
    out = {}
    for dev in ("cpu", "cuda"):
        tr = Trainer(LMTask(cfg, device=dev), tac, tcfg, device=dev)
        b = {k: v.to(dev) for k, v in data.items()}
        p0 = tr.state.params.detach().clone().cpu()  # the step donates
        st, met = tr._step_fn(tr.state, b)
        out[dev] = (p0, st, met)
    view = tr.view
    (p0, sc, mc), (_, sg, mg) = out["cpu"], out["cuda"]
    cpu = lambda t: t.detach().cpu().float()     # noqa: E731
    check(bool(mg["grads_finite"]) and bool(torch.isfinite(mg["loss"])),
          "finite LM step on the card")
    torch.testing.assert_close(cpu(mg["loss"]), mc["loss"], rtol=1e-3,
                               atol=0)
    mo_g, mo_c = cpu(sg.opt_state["mu"]), sc.opt_state["mu"]
    worst = 0.0
    for slot in view.slots:
        rows = slice(slot.row_off, slot.row_off + slot.stack * slot.rows_per)
        gap = float((mo_g[rows] - mo_c[rows]).abs().max())
        worst = max(worst, gap / float(mo_c[rows].abs().max()))
    check(worst <= 5e-2, f"card vs CPU clipped LM gradient: {worst}")
    lr = float(mc["lr"])
    check(float(mg["lr"]) == lr, "learning rate")
    p_g, p_c = cpu(sg.params), sc.params
    # each side rounds p - lr * m once, relative to its own magnitudes: a
    # bf16 gradient entry near zero may be many times larger on one side
    dev_p = ((p_g - p_c) + lr * (mo_g - mo_c)).abs()
    lim_p = 2.0 ** -21 * (p0.abs() + p_c.abs() + p_g.abs())
    w = int(torch.argmax(dev_p - lim_p))
    check(bool((dev_p <= lim_p).all()),
          f"master = p - lr * m on both devices: at {w} p0 "
          f"{float(p0.flatten()[w])!r} p {float(p_g.flatten()[w])!r} / "
          f"{float(p_c.flatten()[w])!r} m {float(mo_g.flatten()[w])!r} / "
          f"{float(mo_c.flatten()[w])!r} lr {lr!r}")
    cp_g, cp_c = cpu(sg.compute["slab"]), sc.compute["slab"].float()
    lim = (p_g - p_c).abs() + 2.0 ** -8 * (p_g.abs() + p_c.abs()) + 2.0 ** -24
    check(bool(((cp_g - cp_c).abs() <= lim).all()), "LM compute copy")
    check(torch.equal(sg.control.codes.cpu(), sc.control.codes), "codes")
    check_layer_views_gradient(tr, {k: v.cuda() for k, v in data.items()})
    log(f"smollm-135m x{layers} layers, one train step at S {seq}, B "
        f"{batch}, card vs CPU: loss {float(mg['loss']):.6f} vs "
        f"{float(mc['loss']):.6f}; momentum (the clipped gradient) within "
        f"{worst:.3g} of each leaf's max; max|dmaster| "
        f"{float((p_g - p_c).abs().max()):.3g}; codes "
        f"{sg.control.codes.tolist()}")


def check_layer_views_gradient(tr, batch) -> None:
    """The stack takes its per-layer views with one ``torch.unbind`` per
    stacked leaf, whose backward stacks the layers' gradients once; the
    gradient of the compute slab must equal, bitwise, the one through
    per-layer indexing ``x[i]`` (whose backward adds a zero tensor the
    size of the stack per layer). Peak bytes of both are reported."""
    from repro_torch import tree as tu
    from repro_torch.core.batch_scaler import measured_peak_bytes
    from repro_torch.nn import blocks

    def slab_grad():
        wrt = tr.state.compute["slab"].detach().requires_grad_(True)
        cp = tr.view.unpack(wrt, like=tr._params_like)
        total = tr.task.loss(cp, {}, batch, None, None)[0]
        return torch.autograd.grad(total, wrt)[0]

    g_unbind, peak_unbind = measured_peak_bytes(slab_grad, "cuda")
    unbind = blocks._layers
    blocks._layers = lambda tree, n: [tu.tree_map(lambda x: x[i], tree)
                                      for i in range(n)]
    try:
        g_index, peak_index = measured_peak_bytes(slab_grad, "cuda")
    finally:
        blocks._layers = unbind
    check(torch.equal(g_unbind, g_index),
          "slab gradient through unbind equals the one through indexing")
    log(f"  slab gradient through per-layer unbind == through indexing, "
        f"bitwise; peak allocated {peak_unbind / 1e9:.3f} GB vs "
        f"{peak_index / 1e9:.3f} GB")


# --------------------------------- phase 5c: the LM training main path ---
def lm_train_main_path():
    """The LM training main path through the launcher:
    ``launch.train.main(LM_TRAIN_ARGS)`` (smollm-135m at 30 layers and
    published widths, S 1024, rungs 2/4/8, 20 steps, sgdm, gpu ladder,
    fisher curvature on b_curv-sized batches) with t_ctrl / t_curv lowered
    to 5 / 10. The launch counts must equal what the code implies: with
    remat each layer runs the forward kernel twice a step (forward, and the
    recompute in backward) and each backward kernel once; the fisher probe
    runs under ``flash_fallback`` and launches none; an OOM retry would
    re-run a step (none may happen at this size)."""
    import io
    import warnings
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    ops.WARNED_FALLBACKS.clear()
    printed = io.StringIO()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed), signals_kept():
            tr = launch_train.main(LM_TRAIN_ARGS, t_ctrl=LM_T_CTRL,
                                   t_curv=LM_T_CURV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    steps = int(LM_TRAIN_ARGS[LM_TRAIN_ARGS.index("--steps") + 1])
    L = tr.task.cfg.num_layers
    fallbacks = [str(w.message) for w in caught
                 if "kernel gate failed" in str(w.message)]
    check(not fallbacks and not ops.WARNED_FALLBACKS,
          f"fallback warnings on the LM training path: {fallbacks}")
    check(not tr.oom_events, f"OOM events {tr.oom_events}")
    check(int(tr.state.control.step) == steps, "all steps taken")
    lines = [json.loads(x) for x in printed.getvalue().splitlines()]
    check(len(lines) == len(tr.metrics_log) == -(-steps // 10),
          f"{len(lines)} JSON lines")
    check(all(math.isfinite(m["loss"]) for m in lines), f"losses {lines}")
    want = {"flash_attention": 2 * L * steps,
            "flash_attention_tc": 2 * L * steps, "flash_attention_tf32": 0,
            "flash_attention_simt": 0,
            "flash_attention_bwd_delta": L * steps,
            "flash_attention_bwd_dq": L * steps,
            "flash_attention_bwd_dq_tc": L * steps,
            "flash_attention_bwd_dq_tf32": 0,
            "flash_attention_bwd_dq_simt": 0,
            "flash_attention_bwd_dkv": L * steps,
            "flash_attention_bwd_dkv_tc": L * steps,
            "flash_attention_bwd_dkv_tf32": 0,
            "flash_attention_bwd_dkv_simt": 0,
            "fused_stats": steps, "fused_apply": steps}
    for k, n in want.items():
        check(launches[k] == n, f"{k}: {launches[k]} launches, expected {n}")
    var, view = lm_train_variant(), lm_train_view()
    check(tr.view.rows == view.rows and tr.view.num_layers ==
          view.num_layers, "the LM slab the fused kernels were checked on")
    check(tr.opt.spec == var["spec"] and tr.tac.ladder == var["ladder"]
          and tr.tac.stochastic_round == var["sr"]
          and tr.task.compute_dtype == var["cp_dtype"]
          and tr.state.compute["slab"].dtype == var["g_dtype"],
          "the fused update variant the kernels were checked on")
    lam = tr.state.control.lam
    check(float(lam.abs().sum()) > 0, "fisher curvature refreshed")
    check(len(tr.scaler.history) == (steps - 1) // LM_T_CTRL,
          f"rung controller every {LM_T_CTRL} steps")
    log(f"LM training main path: launch.train.main({' '.join(LM_TRAIN_ARGS)})"
        f" with t_ctrl {LM_T_CTRL}, t_curv {LM_T_CURV}: {steps} steps in "
        f"{wall:.2f} s (init included), {L} layers, peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    log(f"  logged loss {[round(m['loss'], 4) for m in lines]} at steps "
        f"{[m['step'] for m in lines]}, finite steps all {steps}")
    log(f"  rung history {tr.scaler.history}, measured peak bytes per rung "
        f"{ {k: int(v) for k, v in tr.measured_bytes.items()} }")
    log(f"  codes {tr.state.control.codes.tolist()}, fisher curvature per "
        f"layer {[float(f'{x:.3g}') for x in lam.tolist()]}")
    log(f"  launches {launches}")
    return tr, launches, lm_serving_set(tr)


def lm_serving_set(tr) -> int:
    """The one-pass form's path, at the end of the LM training path: the
    tier-0 serving weight set built from the trained masters with the
    trainer's absmax table (``Trainer.serving_amax_tree``, from the fused
    step's carried per-layer ``p_amax``), as ``ServeEngine(amax_tree=...)``
    builds it: one one-pass launch a leaf, bf16 written directly. Each
    amax must bound its leaf's absmax of the bf16-cast master, and each
    leaf equal the plain version with the same amax, bitwise. -> the
    one-pass launches."""
    from repro_torch import tree as tu
    from repro_torch.kernels import ops
    from repro_torch.kernels import qdq_cast as qc
    from repro_torch.serve.engine import tier_params
    bf = torch.bfloat16
    params = tr.params_tree()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    amax_tree = tr.serving_amax_tree()
    w0 = tier_params(params, 0, "tpu", amax_tree=amax_tree)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    leaves, amaxes = tu.leaves(params), tu.leaves(amax_tree)
    check(launches["qdq_cast_one_pass"] == launches["qdq_cast"]
          == len(leaves) == len(_lm_leaves())
          and launches["qdq_cast_two_pass"] == 0,
          f"one one-pass launch a leaf: {launches}")
    for leaf, a, w in zip(leaves, amaxes, tu.leaves(w0)):
        what = f"tier-0 leaf {tuple(leaf.shape)} from the table"
        true = leaf.to(bf).float().abs().max()
        check(float(a) >= float(true), f"{what}: amax {float(a)} bounds "
              f"{float(true)}")
        want = qc.qdq_cast_ref(leaf.float(), 0, "tpu", a, out_dtype=bf)
        check(w.dtype == bf and same(w, want), what)
        check(bool(torch.isfinite(w).all()), f"{what} finite")
    log(f"LM tier-0 serving set from Trainer.serving_amax_tree: "
        f"{len(leaves)} leaves in {wall * 1e3:.2f} ms (table included), "
        f"bitwise equal to the plain version; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return launches["qdq_cast_one_pass"]


def time_lm_rungs(tr, per_rung: int = 6):
    """Median step time per rung of the main path's trainer: each rung in
    turn for ``per_rung`` steps, host wall time of each step ending in a
    device sync. Each rung's first step (which also measures the rung's
    peak bytes if it is new) and steps that refresh the fisher curvature
    are left out."""
    out = {}
    for i, rung in enumerate(tr.scaler.rungs):
        times = []
        for j in range(per_rung):
            tr.scaler.idx = i
            step = int(tr.state.control.step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.run(1)
            torch.cuda.synchronize()
            if j and step % tr.tac.t_curv:   # not the rung's first step
                times.append((time.perf_counter() - t0) * 1e3)
        out[rung] = statistics.median(times)
    peaks_b = {k: int(v) for k, v in tr.measured_bytes.items()}
    log(f"LM step time by rung (median ms, {per_rung} steps a rung): "
        f"{ {r: round(ms, 3) for r, ms in out.items()} }; measured peak "
        f"bytes per rung {peaks_b}")
    return out


def profile_lm_step(tr) -> None:
    """Where an LM train step's time goes: one step at the top rung."""
    tr.scaler.idx = len(tr.scaler.rungs) - 1
    if int(tr.state.control.step) % tr.tac.t_curv == 0:
        tr.run(1)                       # keep the fisher probe out

    def family(n):
        if "bwd_dq_tc_kernel" in n or "bwd_dkv_tc_kernel" in n:
            return "flash backward dQ, dK/dV (this port's tensor-core kernels)"
        if "delta_kernel" in n:
            return "flash backward delta (this port's kernel)"
        if "dq_kernel" in n or "dkv_kernel" in n:
            return "flash backward SIMT dQ, dK/dV (this port's kernels)"
        if "fwd_tc_kernel" in n:
            return "flash forward (this port's tensor-core kernel)"
        if "fwd_kernel" in n:
            return "flash forward (this port's SIMT kernel)"
        if "stats_partials" in n or "apply_kernel" in n \
                or "reduce_partials" in n:
            return "fused update (this port's kernels)"
        if any(w in n for w in ("gemm", "gemv", "nvjet", "xmma", "cutlass",
                                "sm90", "splitk")):
            return "matmul (projections, FFN, readout; cuBLAS)"
        if "memcpy" in n or "memset" in n or "copy" in n:
            return "casts and copies"
        if "reduce" in n:
            return "reduction (norms, logsumexp, sums)"
        return "elementwise (RoPE, norms, SiLU, softmax-xent, residuals)"

    _profile(lambda: tr.run(1), 1, family,
             f"1 LM train step at rung {tr.scaler.microbatch}")


# ------------------------ phase 5d: the reference training main paths ---
#: the paper's FP32 baseline through the harness, and the static-AMP
#: baseline through the launcher (smollm-135m at 30 layers, S 1024, rung 8)
FP32_ARGS = dict(steps=20, batch0=32)
NO_TRIACCEL_ARGS = ["--arch", "smollm-135m", "--seq", "1024", "--rungs", "8",
                    "--steps", "10", "--ladder", "gpu", "--no-triaccel"]


def _step_ms(tr, steps: int = 5) -> float:
    """Median host time of ``steps`` more train steps of ``tr``, each
    ending in a device sync."""
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run(1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def fp32_main_path(arch: str = "resnet18", name: str = "ResNet-18",
                   bw=None, f32_ops=None):
    """``run_method("fp32", arch, steps=20, batch0=32)``: the reference
    step over tree-form state, no fused-update launch, codes reported as
    fp32, the rung fixed at 32. Then the port's path to ``grad_stats``:
    its op over the gradient tree of the same trainer's first step
    (``make_trainer`` builds the trainer ``run_method`` runs), timed over
    the whole tree when ``bw`` is given -> (that path's result, median step
    ms, peak bytes)."""
    from repro_torch.kernels import ops
    from repro_torch.train.paper_harness import make_trainer, run_method
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = run_method("fp32", arch, device="cuda", **FP32_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    steps, batch0 = FP32_ARGS["steps"], FP32_ARGS["batch0"]
    losses = [m["loss"] for m in res.log]
    check(len(res.log) == steps and all(
        math.isfinite(x) and m["grads_finite"] == 1.0
        for x, m in zip(losses, res.log)), f"fp32 losses {losses}")
    check(sum(launches.values()) == 0, f"fp32 launches {launches}")
    check(res.codes == [2] * len(res.codes), f"fp32 codes {res.codes}")
    check(res.final_batch == batch0 and res.batch_history == []
          and all(m["rung"] == batch0 for m in res.log), "rung fixed")
    walls = [m["wall_s"] for m in res.log]
    step_ms = statistics.median(b - a for a, b in zip(walls[4:], walls[5:]))
    log(f"FP32 main path: run_method('fp32', '{arch}', steps={steps}, "
        f"batch0={batch0}) in {wall:.2f} s (eval included): median step "
        f"{step_ms * 1e3:.3f} ms (steps 5..{steps - 1}), peak allocated "
        f"{peak / 1e9:.3f} GB, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"held-out accuracy {res.accuracy:.2f} %, rung {res.final_batch}, "
        f"codes {res.codes}, launches {launches}")
    tr = make_trainer("fp32", arch, device="cuda", **FP32_ARGS)[0]
    st = tr.state
    return grad_stats_over_gradients(
        name, tr.task, st.params, st.aux_state,
        tr._batch_for_rung(batch0, 0), tr.tac, st.control, bw, f32_ops,
        whole_tree=True), step_ms * 1e3, peak


def no_triaccel_main_path(bw, f32_ops):
    """``launch.train.main(NO_TRIACCEL_ARGS)``: smollm-135m at 30 layers
    and published widths, S 1024, rung 8, the static bf16 baseline on the
    reference step. Launches: the forward kernel 2 x 30 a step (forward
    and remat recompute), each backward kernel 30 a step, no fused update.
    Then the step time, and the port's path to ``grad_stats`` over the
    gradient tree of the trainer's next step (its loss and batch), timed
    on the largest leaf."""
    import io
    import warnings
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    ops.WARNED_FALLBACKS.clear()
    printed = io.StringIO()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed), signals_kept():
            tr = launch_train.main(NO_TRIACCEL_ARGS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    steps = int(NO_TRIACCEL_ARGS[NO_TRIACCEL_ARGS.index("--steps") + 1])
    rung = int(NO_TRIACCEL_ARGS[NO_TRIACCEL_ARGS.index("--rungs") + 1])
    L = tr.task.cfg.num_layers
    fallbacks = [str(w.message) for w in caught
                 if "kernel gate failed" in str(w.message)]
    check(not fallbacks and not ops.WARNED_FALLBACKS,
          f"fallback warnings on the --no-triaccel path: {fallbacks}")
    check(not tr.fused and tr.state.compute == () and not tr.oom_events,
          "the reference step, no OOM")
    check(int(tr.state.control.step) == steps, "all steps taken")
    lines = [json.loads(x) for x in printed.getvalue().splitlines()]
    check(len(lines) == len(tr.metrics_log) == -(-steps // 10) and all(
        math.isfinite(m["loss"]) and m["grads_finite"] == 1.0
        for m in tr.metrics_log), f"logged {lines}")
    want = {"flash_attention": 2 * L * steps,
            "flash_attention_tc": 2 * L * steps,
            "flash_attention_bwd_delta": L * steps,
            "flash_attention_bwd_dq": L * steps,
            "flash_attention_bwd_dq_tc": L * steps,
            "flash_attention_bwd_dkv": L * steps,
            "flash_attention_bwd_dkv_tc": L * steps}
    check({k: v for k, v in launches.items() if v} == want,
          f"--no-triaccel launches {launches}, expected {want}")
    check(tr.scaler.microbatch == rung and tr.scaler.history == [],
          f"rung fixed at {rung}")
    log(f"--no-triaccel main path: launch.train.main("
        f"{' '.join(NO_TRIACCEL_ARGS)}): {steps} steps in {wall:.2f} s "
        f"(init included), {L} layers, peak allocated {peak / 1e9:.3f} GB, "
        f"loss {[round(m['loss'], 4) for m in lines]} at steps "
        f"{[m['step'] for m in lines]}, codes "
        f"{tr.state.control.codes.tolist()}, launches {launches}")
    torch.cuda.reset_peak_memory_stats()
    ms = _step_ms(tr)
    log(f"  step time at rung {rung} (median of 5 more steps) {ms:.3f} "
        f"ms, peak allocated over them "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    profile_lm_step(tr)
    st = tr.state
    out = grad_stats_over_gradients(
        "smollm-135m", tr.task, st.params, st.aux_state,
        tr._batch_for_rung(rung, int(st.control.step)), tr.tac, st.control,
        bw, f32_ops)
    return launches, out


def check_reference_steps_against_cpu():
    """One reference step on the card and on the CPU from the same weights,
    state and batch: ResNet-18 and EfficientNet-B0 at batch 2 (the FP32
    baseline's configuration) and smollm-135m at full width and 2 layers,
    S 1024, B 2 (the --no-triaccel configuration). Bounds as the resident
    steps' (``check_step_against_cpu``, ``check_lm_step_against_cpu``): the
    momentum (the clipped gradient) leaf by leaf within 3e-2 (the vision
    models) and 5e-2 (the bf16 LM) of the leaf's largest magnitude, plus
    1e-5 of the largest over all leaves for EfficientNet-B0; the master
    p_card - p_cpu = -lr (m_card - m_cpu) up to one f32 rounding on each
    side, 2^-21 (|p| + |p'_card| + |p'_cpu|); loss within rtol 1e-4
    (ResNet-18) and 1e-3 (LM); BN statistics within rtol 1e-4; codes
    equal."""
    from repro_torch import tree as tu
    from repro_torch.core.precision import TriAccelConfig
    from repro_torch.data.synthetic import CIFARLikeStream, LMTaskStream
    from repro_torch.models.vision import VisionConfig
    from repro_torch.train.paper_harness import _tac_for
    from repro_torch.train.task import LMTask, VisionTask
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cases = [
        ("ResNet-18", lambda dev: VisionTask(VisionConfig("resnet18"),
                                             device=dev),
         _tac_for("fp32", mem_cap_gb=1.0),
         TrainerConfig(total_steps=10, base_lr=0.05, warmup_steps=2,
                       weight_decay=5e-4, grad_clip=5.0, rungs=(2,),
                       seq_len=1),
         CIFARLikeStream(global_batch=2, seed=3).batch(0), 1e-4, 3e-2, 0.0),
        ("EfficientNet-B0", lambda dev: VisionTask(
            VisionConfig("efficientnet_b0"), device=dev),
         _tac_for("fp32", mem_cap_gb=1.0),
         TrainerConfig(total_steps=10, base_lr=0.05, warmup_steps=2,
                       weight_decay=5e-4, grad_clip=5.0, rungs=(2,),
                       seq_len=1),
         CIFARLikeStream(global_batch=2, seed=3).batch(0), 1e-4, 3e-2, 1e-5),
        ("smollm-135m x2 layers", lambda dev: LMTask(_lm_cfg(2), device=dev),
         TriAccelConfig(ladder="gpu", curvature_method="fisher",
                        enable_precision=False, enable_curvature=False,
                        enable_batch=False, dynamic_precision=False),
         TrainerConfig(total_steps=10, base_lr=0.05, warmup_steps=2,
                       grad_clip=1.0, rungs=(2,), seq_len=1024),
         LMTaskStream(49152, 1024, 2, seed=3).batch(0), 1e-3, 5e-2, 0.0),
    ]
    cpu = lambda t: t.detach().cpu().float()     # noqa: E731
    for name, make, tac, tcfg, batch, loss_rtol, mom_rel, floor in cases:
        out = {}
        for dev in ("cpu", "cuda"):
            tr = Trainer(make(dev), tac, tcfg, device=dev)
            check(not tr.fused, f"{name}: the reference step")
            b = {k: v.to(dev) for k, v in batch.items()}
            st, met = tr._step_fn(tr.state, b)
            out[dev] = (tu.leaves(tr.state.params), st, met)
        (p0, sc, mc), (_, sg, mg) = out["cpu"], out["cuda"]
        check(bool(mg["grads_finite"]) and bool(torch.isfinite(mg["loss"])),
              f"{name}: finite step on the card")
        torch.testing.assert_close(cpu(mg["loss"]), mc["loss"],
                                   rtol=loss_rtol, atol=0)
        lr = float(mc["lr"])
        check(float(mg["lr"]) == lr, f"{name}: learning rate")
        worst = 0.0
        top = max(float(m.abs().max()) for m in tu.leaves(sc.opt_state["mu"]))
        for a0, pg, pc, mg_, mc_ in zip(
                p0, tu.leaves(sg.params), tu.leaves(sc.params),
                tu.leaves(sg.opt_state["mu"]), tu.leaves(sc.opt_state["mu"])):
            pg, mg_ = cpu(pg), cpu(mg_)
            gap = float((mg_ - mc_).abs().max()) / (
                float(mc_.abs().max()) + floor / mom_rel * top)
            worst = max(worst, gap)
            dev_p = ((pg - pc) + lr * (mg_ - mc_)).abs()
            check(bool((dev_p <= 2.0 ** -21 * (a0.abs() + pc.abs()
                                               + pg.abs())).all()),
                  f"{name}: master = p - lr * m on both devices")
        check(worst <= mom_rel, f"{name}: card vs CPU momentum {worst}")
        check(torch.equal(sg.control.codes.cpu(), sc.control.codes),
              f"{name}: codes")
        for a, b in zip(tu.leaves(sg.aux_state), tu.leaves(sc.aux_state)):
            torch.testing.assert_close(cpu(a), b, rtol=1e-4, atol=1e-5)
        log(f"{name}, one reference step, card vs CPU: loss "
            f"{float(mg['loss']):.7f} vs {float(mc['loss']):.7f}; momentum "
            f"(the clipped gradient) within {worst:.3g} of each leaf's max "
            f"(limit {mom_rel})")


# ------------------------------------ phase 5b: the serving main path ---
def serve_main_path(seed: int = 0):
    """The serving main path: ServeSession over smollm-135m at full width,
    prompt 1024, cache 2048, rungs 1/2/4, tiers 1 then 0 (fp8 pinned after
    16 decode steps), eight requests of 64 tokens in two waves: four up
    front, three steps, four more. tok/s counts every generated token over
    the serving wall time from the first submit to the last token."""
    import warnings
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_task
    from repro_torch.serve import ServeConfig, ServeSession
    task = get_task("smollm-135m")
    n_layers, vocab = task.cfg.num_layers, task.cfg.vocab_size
    cfg = ServeConfig(prompt_len=1024, total_len=2048, rungs=(1, 2, 4),
                      tiers=(0, 1), ladder="tpu", max_new_tokens=64,
                      schedule="fifo", seed=seed)
    prompts = np.random.default_rng(seed).integers(0, vocab,
                                                   (8, cfg.prompt_len))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    ops.WARNED_FALLBACKS.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        sess = ServeSession(task, cfg)
        t1 = time.perf_counter()
        sess.warm()
        warm_runs = dict(sess.engine.runs)
        t2 = time.perf_counter()
        for p in prompts[:4]:
            sess.submit({"tokens": p})
        for _ in range(3):
            sess.step()
        for p in prompts[4:]:
            sess.submit({"tokens": p})
        while sess.engine.runs["decode"] - warm_runs["decode"] < 16:
            sess.step()
        sess.set_tier(0)
        stats = sess.run()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t2
    launches = dict(ops.LAUNCHES)
    runs = dict(sess.engine.runs)
    fallbacks = [str(w.message) for w in caught
                 if "kernel gate failed" in str(w.message)]
    check(not fallbacks and not ops.WARNED_FALLBACKS,
          f"fallback warnings on the main path: {fallbacks}")
    reqs = sess.results()
    check(len(reqs) == 8 and all(r.status == "done" for r in reqs.values()),
          "all eight requests done")
    for r in reqs.values():
        check(len(r.tokens) == cfg.max_new_tokens and all(
            0 <= t < vocab for t in r.tokens), f"request {r.rid} tokens")
    decode_steps = sum(len(sess.lat.samples(r, t)) for r in cfg.rungs
                       for t in cfg.tiers)
    n_warm = len(cfg.rungs) * len(cfg.tiers)
    check(runs["admit"] == 8 + n_warm, f"admits {runs['admit']}")
    check(runs["decode"] == decode_steps + n_warm, f"decodes {runs}")
    check(launches["flash_attention"] == n_layers * runs["admit"],
          f"flash_attention launches {launches} vs {runs}")
    check(launches["flash_attention_tc"] == launches["flash_attention"]
          and launches["flash_attention_tf32"] == 0
          and launches["flash_attention_simt"] == 0,
          f"every prefill forward on the tensor-core route: {launches}")
    check(launches["flash_decode"] == n_layers * runs["decode"],
          f"flash_decode launches {launches} vs {runs}")
    check(launches["qdq_cast"] == launches["qdq_cast_two_pass"]
          == len(_lm_leaves()),
          f"qdq_cast launches {launches} vs the tier-0 leaves (two-pass)")
    check(any(t == 0 for _, t in stats["tier_history"]), "fp8 tier decoded")
    check(max(r for _, r in stats["rung_history"]) == 4, "rung reached 4")
    tokens = stats["decoded_tokens"]
    log(f"serving main path: smollm-135m ({n_layers} layers), 8 requests x "
        f"{cfg.max_new_tokens} tokens, prompt {cfg.prompt_len}, cache "
        f"{cfg.total_len}: init {t1 - t0:.2f} s, warm {t2 - t1:.2f} s "
        f"({sess.compile_count} paths), serving {serve_s:.3f} s")
    log(f"  {tokens / serve_s:.1f} tok/s ({tokens} tokens, {stats['steps']} "
        f"steps, {decode_steps} decode steps), TTFT p50 "
        f"{stats['ttft_s_p50'] * 1e3:.1f} ms p99 "
        f"{stats['ttft_s_p99'] * 1e3:.1f} ms, peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    log(f"  rung history {stats['rung_history']}, tier history "
        f"{stats['tier_history']}, measured bytes "
        f"{ {k: int(v) for k, v in sess.mm.measured.items()} }")
    lat = {f"{r}/{t}": round(float(np.median(sess.lat.samples(r, t))) * 1e3,
                             3)
           for r in cfg.rungs for t in cfg.tiers if sess.lat.samples(r, t)}
    log(f"  median decode step ms by rung/tier {lat}")
    log(f"  path runs {runs} (warm-ups {warm_runs}), launches {launches}")
    log(f"  request 0 tokens {reqs[0].tokens[:16]} ...")
    return sess, launches


def _serve_family(n):
    if "decode_split_kernel" in n:
        return "flash_decode (this port's split-key kernel)"
    if "fwd_tc_kernel" in n:
        return "flash forward (this port's tensor-core kernel)"
    if "fwd_kernel" in n:
        return "flash forward (this port's SIMT kernel)"
    if "qdq" in n:
        return "qdq_cast (this port's kernel)"
    if any(w in n for w in ("gemm", "gemv", "nvjet", "xmma", "cutlass",
                            "sm90", "splitk")):
        return "matmul (projections, FFN, readout)"
    if "index" in n:
        return "cache writes, gathers (index kernels)"
    if "copy" in n or "memcpy" in n or "memset" in n:
        return "casts and copies"
    if "reduce" in n:
        return "reduction (norms, argmax)"
    return "elementwise (RoPE, norms, SiLU, residuals)"


def profile_prefill(sess) -> None:
    """Where the prefill's time goes: one serving step that admits four
    fresh prompts (4 prefills of 1024 tokens through 30 layers, the
    scatter into the cache, one decode step at rung 4)."""
    rng = np.random.default_rng(12)
    for _ in range(4):
        sess.submit({"tokens": rng.integers(0, sess.task.cfg.vocab_size,
                                            (sess.cfg.prompt_len,))},
                    max_new_tokens=2)
    _profile(sess.step, 1, _serve_family,
             "1 serving step admitting 4 prompts of "
             f"{sess.cfg.prompt_len} tokens")
    sess.run()


def profile_decode(sess, steps: int = 5) -> None:
    """Where a decode step's time goes: ``steps`` decode steps at rung 4
    (four fresh requests admitted first)."""
    rng = np.random.default_rng(11)
    for _ in range(4):
        sess.submit({"tokens": rng.integers(0, sess.task.cfg.vocab_size,
                                            (sess.cfg.prompt_len,))},
                    max_new_tokens=steps + 4)
    sess.step()              # admits all four, one decode step
    sess.step()

    def run():
        for _ in range(steps):
            sess.step()

    _profile(run, steps, _serve_family,
             f"{steps} decode steps at rung {sess.rung} tier {sess.tier}")
    sess.run()


# --------------------------- phase 8: checkpoint, resume and preemption ---
#: ResNet-18's checkpointed run: its steps, checkpoint cadence and
#: generations kept, and the steps both trainers take after the restore
CKPT_STEPS, CKPT_EVERY, CKPT_KEEP, CKPT_MORE = 20, 10, 2, 5
#: the LM launcher's first call takes SIGTERM in the step before this one
LM_CKPT_CUT = 10


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _generations(directory) -> list:
    """Committed steps of a checkpoint directory; fails on a leftover
    temporary file or directory."""
    names = sorted(p.name for p in Path(directory).iterdir())
    check(not any(".tmp" in n for n in names),
          f"no temporary remnants in {names}")
    return sorted(int(n[len("step_"):-len(".COMMITTED")]) for n in names
                  if n.endswith(".COMMITTED"))


def _bits(t: torch.Tensor) -> torch.Tensor:
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.detach().cpu().contiguous().view(ints[t.element_size()])


def _differing(a, b) -> list:
    """Key paths where two trees of tensors differ in any bit (slabs
    compared whole, padding rows included)."""
    from repro_torch import tree as tu
    return [k for k, x, y in zip(tu.keystrs(a), tu.leaves(a), tu.leaves(b))
            if x.shape != y.shape or x.dtype != y.dtype
            or not torch.equal(_bits(x), _bits(y))]


def _save_timings(tr, directory: str, reps: int) -> dict:
    """``reps`` saves of the trainer's state through an
    ``AsyncCheckpointer``: the host stall of ``save()`` (unpack and the
    device-to-host copy), then the background write (``wait()``), medians
    in ms; the bytes of one generation, held to the master, momentum and
    compute copy of every parameter plus 1 % (headers, control, BatchNorm
    state)."""
    from repro_torch import tree as tu
    from repro_torch.checkpoint import AsyncCheckpointer
    ckpt = AsyncCheckpointer(directory, keep=1)
    step = int(tr.state.control.step)
    stall, write = [], []
    for _ in range(reps):
        _sync(tr.device)
        t0 = time.perf_counter()
        ckpt.save(step, tr._save_state())
        t1 = time.perf_counter()
        ckpt.wait()
        stall.append((t1 - t0) * 1e3)
        write.append((time.perf_counter() - t1) * 1e3)
    nbytes = sum(f.stat().st_size
                 for f in (Path(directory) / f"step_{step:012d}").iterdir())
    n = sum(p.numel() for p in tu.leaves(tr._params_like))
    cp = torch.empty((), dtype=tr.task.compute_dtype).element_size()
    want = n * (4 + 4 + cp)
    check(want <= nbytes <= 1.01 * want,
          f"{nbytes} bytes a generation, {want} in its three copies")
    return {"bytes": nbytes, "stall_ms": statistics.median(stall),
            "write_ms": statistics.median(write)}


def checkpoint_resnet(batch0: int = 32, dev="cuda") -> dict:
    """The paper's Tri-Accel ResNet-18 trainer (``make_trainer``, resident
    fused step) with a checkpoint directory: ``CKPT_STEPS`` steps with a
    generation every ``CKPT_EVERY`` and ``CKPT_KEEP`` kept; a fresh trainer
    restores the last bitwise (every slab, padding included, ``p_amax``,
    control, BatchNorm state, the serving absmax table), and so does one
    on the CPU; both card trainers then take ``CKPT_MORE`` steps (the
    restored one launching ``fused_stats`` and ``fused_apply`` once a step)
    and their losses agree, bitwise where the card's step is deterministic,
    else within rtol 1e-3; the live trainer's generations after them show
    the keep-N collection; a generation the CPU trainer writes restores on
    the card bitwise. -> the save, write and restore times and the bytes
    of one generation."""
    from repro_torch.checkpoint import AsyncCheckpointer
    from repro_torch.kernels import ops
    from repro_torch.train.paper_harness import make_trainer
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    run, on_cpu = str(tmp / "run"), str(tmp / "cpu")
    try:
        def trainer(directory, device=dev):
            tr = make_trainer("triaccel", "resnet18", steps=CKPT_STEPS,
                              batch0=batch0, ckpt_dir=directory,
                              device=device)[0]
            tr.tcfg.ckpt_keep = tr.ckpt.keep = CKPT_KEEP
            return tr
        live = trainer(run)
        check(live.tcfg.ckpt_every == CKPT_EVERY, "the harness's cadence")
        live.run(CKPT_STEPS)
        _sync(dev)
        check(_generations(run) == [CKPT_EVERY, CKPT_STEPS],
              f"generations {_generations(run)}")
        out = _save_timings(live, str(tmp / "timing"), reps=3)
        fresh = trainer(run)
        _sync(dev)
        t0 = time.perf_counter()
        step = fresh.maybe_restore()
        _sync(dev)
        out["restore_ms"] = (time.perf_counter() - t0) * 1e3
        check(step == int(live.state.control.step) == CKPT_STEPS,
              f"restored step {step}")
        bad = _differing(fresh.state, live.state)
        check(not bad, f"restored on the card, bitwise: {bad}")
        check(not _differing(fresh.serving_amax_tree(),
                             live.serving_amax_tree()), "serving table")
        cpu = trainer(run, "cpu")
        check(cpu.maybe_restore() == CKPT_STEPS
              and not _differing(cpu.state, live.state),
              "the card's generation restored on the CPU, bitwise")
        # the rung controller's host state is in no checkpoint (nor in the
        # reference's): the restored trainer takes the live one's, and
        # writes nothing (the live trainer owns the directory)
        fresh.scaler = copy.deepcopy(live.scaler)
        fresh.measured_bytes = dict(live.measured_bytes)
        fresh.ckpt = None
        ops.reset_launches()
        fresh.run(CKPT_MORE)
        _sync(dev)
        launches = dict(ops.LAUNCHES)
        check(launches["fused_stats"] == launches["fused_apply"] == CKPT_MORE,
              f"launches in {CKPT_MORE} steps after the restore: {launches}")
        live.run(CKPT_MORE)
        la = [m["loss"] for m in live.metrics_log[-CKPT_MORE:]]
        lb = [m["loss"] for m in fresh.metrics_log[-CKPT_MORE:]]
        check(all(math.isfinite(x) for x in la + lb), f"losses {la} {lb}")
        gap = max(abs(a - b) / abs(a) for a, b in zip(la, lb))
        bitwise = la == lb and not _differing(fresh.state, live.state)
        check(bitwise or gap <= 1e-3, f"losses after the restore {lb} vs "
              f"the live run's {la}")
        check(_generations(run) == [CKPT_STEPS, CKPT_STEPS + CKPT_MORE],
              f"keep {CKPT_KEEP}: {_generations(run)}")
        cpu.ckpt = AsyncCheckpointer(on_cpu, CKPT_KEEP)
        cpu.run(1)
        fresh.tcfg.ckpt_dir = on_cpu
        check(fresh.maybe_restore() == CKPT_STEPS + 1
              and not _differing(fresh.state, cpu.state),
              "a CPU-written generation restored on the card, bitwise")
        log(f"checkpoint, ResNet-18 Tri-Accel from rung {batch0}: "
            f"generations {CKPT_EVERY}, {CKPT_STEPS} of {CKPT_STEPS} steps, "
            f"restored on the card and on the CPU bitwise; {CKPT_MORE} more "
            f"steps on the restored and the live trainer: losses "
            f"{'bitwise equal' if bitwise else f'within {gap:.3g}'} "
            f"({lb}), launches after the restore "
            f"{ {k: v for k, v in launches.items() if v} }; keep "
            f"{CKPT_KEEP} left {_generations(run)}; a CPU-written "
            f"generation restored on the card bitwise")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def checkpoint_lm() -> dict:
    """smollm-135m through ``launch.train.main(LM_TRAIN_ARGS + ["--ckpt",
    dir])``: the first call takes SIGTERM in step ``LM_CKPT_CUT - 1``
    (as a cluster reclaiming the card would send it), checkpoints at the
    top of the next step and exits with 143; the same call again prints
    ``resumed at step LM_CKPT_CUT`` and takes the remaining steps, its
    launch counts read around it (the flash forward, its three backward
    kernels and the fused update, as in phase 5c). Then the times of a
    save and of ``maybe_restore`` into the same trainer, which must give
    back its state bitwise."""
    import io
    from repro_torch import tree as tu
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.train.trainer import Trainer
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_lm_ckpt_"))
    run = str(tmp / "run")
    argv = LM_TRAIN_ARGS + ["--ckpt", run]
    kw = dict(t_ctrl=LM_T_CTRL, t_curv=LM_T_CURV)
    steps = int(LM_TRAIN_ARGS[LM_TRAIN_ARGS.index("--steps") + 1])
    dispatch = Trainer._dispatch

    def sigterm_before_the_cut(self, step):
        if step == LM_CKPT_CUT - 1:
            signal.raise_signal(signal.SIGTERM)
        return dispatch(self, step)
    try:
        code = None
        with signals_kept(), contextlib.redirect_stdout(io.StringIO()):
            Trainer._dispatch = sigterm_before_the_cut
            try:
                launch_train.main(argv, **kw)
            except SystemExit as e:
                code = e.code
            finally:
                Trainer._dispatch = dispatch
        check(code == 143 and _generations(run) == [LM_CKPT_CUT],
              f"preempted: exit {code}, generations {_generations(run)}")
        torch.cuda.synchronize()
        ops.reset_launches()
        printed = io.StringIO()
        t0 = time.perf_counter()
        with signals_kept(), contextlib.redirect_stdout(printed):
            tr = launch_train.main(argv, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        lines = printed.getvalue().splitlines()
        check(lines[0] == f"resumed at step {LM_CKPT_CUT}", f"{lines[:1]}")
        check(int(tr.state.control.step) == steps, "all steps taken")
        losses = [json.loads(x)["loss"] for x in lines[1:]]
        check(losses and all(math.isfinite(x) for x in losses),
              f"losses {losses}")
        rest, L = steps - LM_CKPT_CUT, tr.task.cfg.num_layers
        want = {"flash_attention": 2 * L * rest,
                "flash_attention_tc": 2 * L * rest,
                "flash_attention_bwd_delta": L * rest,
                "flash_attention_bwd_dq_tc": L * rest,
                "flash_attention_bwd_dkv_tc": L * rest,
                "fused_stats": rest, "fused_apply": rest}
        for k, n in want.items():
            check(launches[k] == n, f"{k}: {launches[k]} launches after the "
                  f"resume, expected {n}")
        check(_generations(run) == [LM_CKPT_CUT, steps],
              f"generations {_generations(run)}")
        out = _save_timings(tr, str(tmp / "timing"), reps=2)
        before = tu.tree_map(lambda x: x.clone(), tr.state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(tr.maybe_restore() == steps, "restored step")
        torch.cuda.synchronize()
        out["restore_ms"] = (time.perf_counter() - t0) * 1e3
        bad = _differing(tr.state, before)
        check(not bad, f"restored on the card, bitwise: {bad}")
        log(f"checkpoint, smollm-135m through launch.train.main("
            f"{' '.join(argv)}): SIGTERM in step {LM_CKPT_CUT - 1}, exit "
            f"143 with generation {LM_CKPT_CUT}; the same call again resumed "
            f"and took {rest} steps in {wall:.2f} s (init included), losses "
            f"{[round(x, 4) for x in losses]}, launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------- phase 9: faults and recovery ---
#: the fault plan's ResNet-18 run (the reference soak's plan at the
#: harness's rung 32): its steps, checkpoint cadence and rungs; the burst,
#: SIGTERM and corruption steps
FAULT_STEPS, FAULT_CKPT_EVERY, FAULT_RUNGS = 24, 4, (16, 32)
FAULT_OOM_AT, FAULT_BURST_AT, FAULT_SIGTERM_AT = 3, 9, 21
FAULT_RECOVERY = dict(watchdog=True, max_nonfinite=3, max_rollbacks=2)
#: the real OOM: the rungs (the larger one made not to fit) and the steps
#: of the recovering trainer and of each fault-free oracle
OOM_RUNGS, OOM_STEPS = (32, 64), 6
#: the watchdog's cost: blocks of steps at rung 32, in turns off/on
WATCH_BLOCK, WATCH_TURNS = 10, 3


def fault_plan():
    """The reference soak's trainer plan (``repro.resilience.soak``): an
    unlimited OOM on the big rung from step 3, a burst of ``max_nonfinite``
    steps from step 9 (the gpu ladder caps the injected inf at 2^24 after
    each step, so each burst step re-fires), SIGTERM at step 21 and a torn
    leaf in the checkpoint that SIGTERM writes."""
    from repro_torch.resilience import Fault, FaultPlan
    return FaultPlan([
        Fault("train.step_oom", step=FAULT_OOM_AT, rung=FAULT_RUNGS[-1],
              repeats=None),
        Fault("train.nonfinite", step=FAULT_BURST_AT,
              repeats=FAULT_RECOVERY["max_nonfinite"]),
        Fault("train.sigterm", step=FAULT_SIGTERM_AT, repeats=1),
        Fault("ckpt.corrupt", step=FAULT_SIGTERM_AT, repeats=1,
              kind="truncate_leaf")], seed=0)


def fault_trainer(ckpt_dir=None, plan=None, device="cuda",
                  rungs=FAULT_RUNGS, steps=FAULT_STEPS, **over):
    """The paper harness's Tri-Accel ResNet-18 trainer (``make_trainer``
    at rung 32: gpu ladder, sgdm, fisher, 11,173,962 parameters) at
    ``rungs``, starting at the largest, with a checkpoint every
    ``FAULT_CKPT_EVERY`` steps into ``ckpt_dir``; ``over`` replaces
    further ``TrainerConfig`` fields."""
    from repro_torch.train.paper_harness import make_trainer
    from repro_torch.train.trainer import Trainer
    base, task, _, tac = make_trainer("triaccel", "resnet18", steps=steps,
                                      batch0=32, device=device)
    tcfg = dataclasses.replace(base.tcfg, rungs=rungs, start_rung=rungs[-1],
                               ckpt_dir=ckpt_dir,
                               ckpt_every=FAULT_CKPT_EVERY, **over)
    del base
    gc.collect()
    tr = Trainer(task, tac, tcfg, device=device, fault_plan=plan)
    # the harness's memory model admits 32 as its largest start; start at
    # the largest rung as its fixed-rung baselines set theirs
    tr.scaler.idx = len(rungs) - 1
    return tr


def check_burst_kernels(view, dev) -> None:
    """fused_stats and fused_apply on what a burst step gives them at the
    ResNet-18 slab: a gradient of +-inf and NaN only (the loss scaled by
    inf, 0 x inf where the gradient was zero) and the finite flag 0; both
    bitwise against the plain versions, every element counted non-finite,
    the master and momentum handed back unchanged."""
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import ops
    rows, L = view.rows, view.num_layers
    g, p, m, _, _, lr, _, qs = _apply_inputs(rows, L, dev, False, 5)
    g[:, ::9] = 0.0
    g = g * float("inf")
    rl = view.row_blocks(dev)
    got = ops.fused_stats(g, rl, L)
    want = fu.fused_stats_ref(g, rl, L)
    torch.cuda.synchronize()
    for n, a, b in zip(("sum", "sum_sq", "absmax", "nonfinite"), got, want):
        check(same(a, b), f"burst fused_stats {n}: {a} vs {b}")
    check(float(got[3].sum()) == rows * 512,
          f"burst: {float(got[3].sum())} of {rows * 512} counted non-finite")
    code = torch.ones(rl.shape, dtype=torch.int32, device=dev)
    scal = torch.tensor([0.5, 0.0, 1.0, 1.0, 10.0], device=dev)
    kw = dict(spec=fu.OptSpec("sgdm", momentum=0.9, weight_decay=5e-4),
              ladder="gpu", cp_dtype=torch.float32, num_layers=L, sr=False)
    args = (g, p, m, None, scal, rl, lr, code, qs)
    _apply_pair(ops, fu, args, kw)
    p2, m2 = ops.fused_apply(*args, **kw)[:2]
    check(torch.equal(_bits(p2), _bits(p)) and torch.equal(_bits(m2),
                                                           _bits(m)),
          "burst: fused_apply keeps the master and momentum bitwise")
    log(f"burst kernels at {rows}x512, L={L}: fused_stats counts all "
        f"{rows * 512} elements non-finite, fused_apply with finite=0 keeps "
        "the master and momentum; both bitwise against the plain versions")


def _state_bits(tr, state=None):
    """Bit copies of a trainer's master and momentum slabs and aux state
    (``state`` in place of the trainer's own)."""
    from repro_torch import tree as tu
    st = tr.state if state is None else state
    return [_bits(x).clone() for x in
            tu.leaves((st.params, st.opt_state, st.aux_state))]


def fault_soak(device) -> dict:
    """``fault_plan()`` through ``fault_trainer`` on ``device`` with the
    watchdog on (``FAULT_RECOVERY``), then the restart: exit 143 at the
    SIGTERM step, the OOM stepping rung 32 down to 16, each burst step
    skipped with the master and momentum slabs and the BatchNorm state
    bitwise, one rollback with ``lr_demote`` 0.5 and a finite loss scale;
    the restart falls back past the torn generation and ends at
    ``FAULT_STEPS`` with the demotion kept. fused_stats and fused_apply
    launch once for each dispatch that reached the step. -> the trails,
    and the card's costs (rollback, OOM step-down)."""
    import warnings
    from repro_torch.kernels import ops
    from repro_torch.resilience import RecoveryConfig
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_faults_"))
    try:
        plan = fault_plan()
        tr = fault_trainer(str(tmp), plan, device,
                           recovery=RecoveryConfig(**FAULT_RECOVERY))
        dispatch, rollback = tr._dispatch, tr._rollback
        calls, entered, skipped, spans, logged = [], [], [], {}, [0]

        def counting(step_fn):        # the dispatches that reach the step
            def counted(state, batch):
                calls.append(1)
                return step_fn(state, batch)
            return counted

        def watched(step):
            _sync(device)
            entered.append((step, time.perf_counter()))
            # a firing logged since the last dispatch is this step's
            burst = len(plan.log) > logged[0] and plan.log[-1][:2] == (
                "train.nonfinite", step)
            logged[0] = len(plan.log)
            before = _state_bits(tr) if burst else None
            t0 = time.perf_counter()
            out = dispatch(step)
            _sync(device)
            spans.setdefault(step, []).append(
                (time.perf_counter() - t0) * 1e3)
            if burst:
                check(not bool(out[1]["grads_finite"]),
                      f"burst step {step} flagged non-finite")
                check(all(torch.equal(a, b) for a, b in zip(
                    _state_bits(tr, out[0]), before)),
                      f"burst step {step} keeps the slabs and BN state")
                skipped.append(step)
            return out

        def timed_rollback(step):
            _sync(device)
            t0 = time.perf_counter()
            tr.ckpt.wait()       # the rollback's first act, timed apart
            t1 = time.perf_counter()
            restored = rollback(step)
            _sync(device)
            spans["rollback"] = (t0, t1, time.perf_counter())
            return restored
        tr._step_fn, tr._dispatch, tr._rollback = (
            counting(tr._step_fn), watched, timed_rollback)
        ops.reset_launches()
        code = None
        with signals_kept():
            tr.install_preemption_handler()
            try:
                tr.run()
            except SystemExit as e:
                code = e.code
        ctl = tr.state.control
        first = dict(code=code, oom_events=list(tr.oom_events),
                     rollback_events=list(tr.rollback_events),
                     log=list(plan.log), skipped=skipped,
                     lr_demote=float(ctl.lr_demote),
                     loss_scale=float(ctl.loss_scale),
                     rung=tr.scaler.microbatch)
        check(code == 143, f"exit {code} at the SIGTERM step")
        check(first["oom_events"] == [(FAULT_OOM_AT, FAULT_RUNGS[-1])]
              and first["rung"] == FAULT_RUNGS[0],
              f"OOM step-down {first['oom_events']}, rung {first['rung']}")
        burst = list(range(FAULT_BURST_AT, FAULT_BURST_AT
                           + FAULT_RECOVERY["max_nonfinite"]))
        check(skipped == burst, f"skipped steps {skipped}")
        check(len(tr.rollback_events) == 1, f"{tr.rollback_events}")
        diverged, restored = tr.rollback_events[0]
        check(first["lr_demote"] == 0.5
              and math.isfinite(first["loss_scale"]),
              f"demotion: lr_demote {first['lr_demote']}, loss scale "
              f"{first['loss_scale']}")
        first_calls = len(calls)
        # the restart: the same trainer without the plan
        tr2 = fault_trainer(str(tmp), None, device)
        tr2._step_fn = counting(tr2._step_fn)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            back = tr2.maybe_restore()
        fell_back = any("failed verification" in str(c.message)
                        for c in caught)
        tr2.run(FAULT_STEPS - back)
        _sync(device)
        launches = dict(ops.LAUNCHES)
        out = dict(first, restored=back, fell_back=fell_back,
                   final_step=int(tr2.state.control.step),
                   final_lr_demote=float(tr2.state.control.lr_demote))
        check(fell_back and back == FAULT_SIGTERM_AT,
              f"restart restored step {back}, fell back {fell_back}")
        check(out["final_step"] == FAULT_STEPS
              and out["final_lr_demote"] < 1.0,
              f"restart ends at {out['final_step']}, lr_demote "
              f"{out['final_lr_demote']}")
        want = FAULT_SIGTERM_AT + (diverged - restored + 1) \
            + FAULT_STEPS - back
        check(len(calls) == want, f"{len(calls)} dispatches reached the "
              f"step, {want} expected")
        on_card = len(calls) if device == "cuda" else 0  # CPU: plain
        check(launches["fused_stats"] == launches["fused_apply"] == on_card,
              f"launches {launches}, {len(calls)} dispatches reached the "
              "step")
        out.update(dispatches=len(calls), first_dispatches=first_calls,
                   launches={k: v for k, v in launches.items() if v})
        if device == "cuda":
            t0, t1, t2 = spans["rollback"]
            resumed = [t for s, t in entered if s == diverged + 1 and t > t2]
            out["writer_ms"] = (t1 - t0) * 1e3
            out["restore_ms"] = (t2 - t1) * 1e3
            out["rollback_ms"] = (resumed[0] - t0) * 1e3
            out["replayed"] = diverged - restored + 1
            out["oom_step_ms"] = spans[FAULT_OOM_AT][0]
            out["step_ms"] = statistics.median(
                v[0] for s, v in spans.items()
                if isinstance(s, int) and s > FAULT_OOM_AT + 1
                and s not in burst)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def real_oom() -> dict:
    """Phase 9's real OOM, in a process of its own (``in_child``): recovery
    from the allocator's own ``torch.OutOfMemoryError``. Two
    fault-free oracles at rung 32 and a probe at rung 64 (one at a time)
    measure each rung's peak (``Trainer.measured_bytes``); a trainer at
    rungs (32, 64) starting at 64 whose first step the ``train.step_oom``
    fault fails takes the same recovery without the allocator; then the
    allocator is capped (``set_per_process_memory_fraction``) halfway
    between the peaks, and a trainer at rungs (32, 64) starting at 64, with
    no fault plan, must catch the OOM of its first step, poison rung 64 and
    re-run the batch at 32. Each takes ``OOM_STEPS`` steps. Every trainer
    here runs cuDNN's deterministic algorithms (``cudnn.deterministic``,
    put back in ``finally``; the default ones sum the convolution backward
    in no fixed order at batch 32). Each recovered trainer's master slab
    equals the oracles' bitwise where the two oracles are bitwise equal,
    else lies within twice their spread. The cap is lifted in ``finally``.
    The cap counts the bytes the allocator reserves, the peaks those it
    allocates: in the script's own process, blocks that earlier phases
    split inside live segments keep so many bytes reserved beyond the
    allocated ones that no cap there both fails rung 64 and leaves rung
    32 its convolutions' workspaces (PERF.md §6). -> peaks, cap,
    the distances and the times of the failed attempt, the retry and an
    oracle's first step, JSON ready."""
    from repro_torch.resilience import Fault, FaultPlan
    small, big = OOM_RUNGS
    oracles, peaks, first_ms, attempts = [], {}, [], []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for rungs in ((small,), (small,), (big,)):
            gc.collect()
            torch.cuda.empty_cache()
            tr = fault_trainer(None, None, "cuda", rungs=rungs,
                               steps=OOM_STEPS)
            t0 = time.perf_counter()
            tr.run(1)
            _sync("cuda")
            first_ms.append((time.perf_counter() - t0) * 1e3)
            if rungs == (big,):
                peaks[big] = tr.measured_bytes[big]
            else:
                peaks[small] = max(peaks.get(small, 0.0),
                                   tr.measured_bytes[small])
                tr.run(OOM_STEPS - 1)
                oracles.append(_bits(tr.state.params).clone())
            del tr
        check(peaks[big] > peaks[small], f"peaks {peaks}")
        gc.collect()
        torch.cuda.empty_cache()
        plan = FaultPlan([Fault("train.step_oom", step=0, rung=big)])
        tr = fault_trainer(None, plan, "cuda", rungs=OOM_RUNGS,
                           steps=OOM_STEPS)
        tr.run(OOM_STEPS)
        check(tr.oom_events == [(0, big)] and tr.scaler.microbatch == small,
              f"injected OOM: events {tr.oom_events}, rung "
              f"{tr.scaler.microbatch}")
        injected = _bits(tr.state.params).clone()
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        total = torch.cuda.get_device_properties(0).total_memory
        cap = (peaks[small] + peaks[big]) / 2
        try:
            torch.cuda.set_per_process_memory_fraction(cap / total)
            tr = fault_trainer(None, None, "cuda", rungs=OOM_RUNGS,
                               steps=OOM_STEPS)
            step_fn = tr._step_fn

            def timed(state, batch):
                t0 = time.perf_counter()
                try:
                    return step_fn(state, batch)
                finally:
                    _sync("cuda")
                    attempts.append((int(batch["labels"].shape[0]),
                                     (time.perf_counter() - t0) * 1e3))
            tr._step_fn = timed
            tr.run(OOM_STEPS)
            _sync("cuda")
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    check(tr.oom_events == [(0, big)] and tr.scaler.microbatch == small
          and tr.scaler.model.measured_key(big) in tr.scaler.model.poisoned,
          f"real OOM: events {tr.oom_events}, rung {tr.scaler.microbatch}")
    f32 = lambda t: t.view(torch.float32)  # noqa: E731
    spread = abs_err(f32(oracles[0]), f32(oracles[1]))
    bitwise = torch.equal(oracles[0], oracles[1])
    gaps = {}
    for name, got in (("injected", injected),
                      ("real", _bits(tr.state.params))):
        gaps[name] = abs_err(f32(got), f32(oracles[0]))
        check(torch.equal(got, oracles[0]) if bitwise
              else gaps[name] <= 2 * spread,
              f"masters after the {name} OOM: {gaps[name]:.3g} from the "
              f"oracle, the oracles {spread:.3g} apart")
    return dict(peaks=peaks, cap=cap, total=total, attempts=attempts,
                oracle_first_ms=first_ms[0], gaps=gaps, spread=spread,
                bitwise=bitwise)


def watchdog_cost() -> dict:
    """Steps of one ResNet-18 trainer at rung 32 with no fault plan and no
    per-step logging, the watchdog off and on in turns (``WATCH_TURNS``
    blocks of ``WATCH_BLOCK`` steps each): the median ms a step of each."""
    from repro_torch.resilience import DivergenceWatchdog, RecoveryConfig
    gc.collect()
    torch.cuda.empty_cache()
    tr = fault_trainer(None, None, "cuda", rungs=(32,), log_every=1 << 30)
    tr.run(3)                                 # first-step work out of the way
    times = {"off": [], "on": []}
    for turn in ["off", "on", "on", "off"] * ((WATCH_TURNS + 1) // 2):
        tr._watchdog = DivergenceWatchdog(
            RecoveryConfig(watchdog=True)) if turn == "on" else None
        _sync("cuda")
        t0 = time.perf_counter()
        tr.run(WATCH_BLOCK)
        _sync("cuda")
        times[turn].append((time.perf_counter() - t0) * 1e3 / WATCH_BLOCK)
    return {k: statistics.median(v) for k, v in times.items()} | {
        "blocks": times}


def faults_phase(card: str, dev) -> dict:
    """Phase 9: the burst's kernel inputs, the fault plan on the card and
    on the CPU (the trails must agree), a real OOM, the watchdog's cost."""
    check_burst_kernels(vision_view(), dev)
    on_card = fault_soak("cuda")
    t0 = time.perf_counter()
    on_cpu = fault_soak("cpu")
    cpu_s = time.perf_counter() - t0
    for k in ("code", "oom_events", "rollback_events", "log", "skipped",
              "lr_demote", "restored", "fell_back", "final_step",
              "dispatches"):
        check(on_card[k] == on_cpu[k],
              f"{k}: card {on_card[k]}, CPU {on_cpu[k]}")
    log(f"faults, ResNet-18 Tri-Accel at rungs {FAULT_RUNGS} with "
        f"{FAULT_RECOVERY}: exit {on_card['code']}; oom_events "
        f"{on_card['oom_events']}, rollback_events "
        f"{on_card['rollback_events']}, skipped {on_card['skipped']} "
        f"(slabs and BN state bitwise), lr_demote {on_card['lr_demote']}, "
        f"loss scale {on_card['loss_scale']}; restart fell back to step "
        f"{on_card['restored']} and ended at {on_card['final_step']} with "
        f"lr_demote {on_card['final_lr_demote']}; {on_card['dispatches']} "
        f"dispatches reached the step, launches {on_card['launches']}; "
        f"fault log {[(s, st) for s, st, _ in on_card['log']]}; the same "
        f"trails on the CPU ({cpu_s:.1f} s)")
    oom = in_child("train-real-oom")
    (a_rung, a_ms), (r_rung, r_ms) = oom["attempts"][:2]
    masters = ("bitwise the oracles' after the real OOM and after the "
               "injected one" if oom["bitwise"] else
               f"{oom['gaps']['real']:.3g} from an oracle's after the real "
               f"OOM, {oom['gaps']['injected']:.3g} after the injected one, "
               f"the two oracles {oom['spread']:.3g} apart")
    log(f"faults, real OOM in a process of its own ({card}): peaks "
        f"{oom['peaks']} bytes, cap {oom['cap']:.0f} of {oom['total']} "
        f"bytes; the failed attempt at "
        f"rung {a_rung} {a_ms:.3f} ms, the retry at rung {r_rung} "
        f"{r_ms:.3f} ms (an oracle's first step at rung {OOM_RUNGS[0]} "
        f"{oom['oracle_first_ms']:.3f} ms); masters after {OOM_STEPS} steps "
        f"{masters}")
    wd = watchdog_cost()
    log(f"faults ({card}): a rollback costs {on_card['rollback_ms']:.3f} ms "
        f"(waiting out the background write of the newest generation "
        f"{on_card['writer_ms']:.3f} ms, the restore and demotion "
        f"{on_card['restore_ms']:.3f} ms, then {on_card['replayed']} "
        f"replayed steps; a plain step "
        f"{on_card['step_ms']:.3f} ms); the injected OOM step (a raise, "
        f"then rung {FAULT_RUNGS[0]}'s first step) "
        f"{on_card['oom_step_ms']:.3f} ms; the real OOM step-down "
        f"{a_ms + r_ms:.3f} ms; a step at rung 32 with the watchdog off "
        f"{wd['off']:.3f} ms, on {wd['on']:.3f} ms (medians of "
        f"{WATCH_BLOCK}-step blocks {wd['blocks']})")
    return on_card


# ------------------------------- phase 10: serving faults and recovery ---
#: the soak's serving plan at smollm-135m's full width and depth: prompt
#: and cache as on the serving main path (phase 5b), six requests
SF_PROMPT, SF_CACHE, SF_REQUESTS = 1024, 2048, 6
#: the real OOM: the rungs (the larger made not to fit), the prompt, the
#: cache, the requests, the tokens each, and the least room wanted between
#: the cap and each path's need. A repack holds both rungs' caches, an
#: admit its rung's and the prefill's own bytes (about 50 MB a 1024-token
#: prompt), so a cap that fails an admit at the larger rung and passes both
#: repacks needs the smaller rung's caches below the prefill's bytes: one
#: row, and a prompt that nearly fills the cache (PERF.md §6)
ROOM_RUNGS, ROOM_PROMPT, ROOM_CACHE = (1, 2), 1792, 2048
ROOM_REQUESTS, ROOM_TOKENS, ROOM_MARGIN = 8, 16, 8 << 20


def _timing(obj, name: str, spans: list, key) -> None:
    """Wrap ``obj.<name>`` so that each call appends (``key(*args)`` taken
    before the call, its ms between two syncs, whether it returned) to
    ``spans``."""
    fn = getattr(obj, name)

    def timed(*a, **kw):
        k, ok = key(*a), False
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out = fn(*a, **kw)
            ok = True
            return out
        finally:
            torch.cuda.synchronize()
            spans.append((k, (time.perf_counter() - t0) * 1e3, ok))
    setattr(obj, name, timed)


def _instrument(sess) -> dict:
    """Spans of a session's recoveries, repacks, decodes and admits, each
    keyed by (step, ...) as it began."""
    spans = {"oom": [], "repack": [], "decode": [], "admit": []}
    eng = sess.engine
    _timing(sess, "_handle_oom", spans["oom"],
            lambda where: (sess.steps, sess.rung, sess.tier, where))
    _timing(eng, "repack", spans["repack"],
            lambda a, b, *_: (sess.steps, a, b))
    for path in ("decode", "admit"):
        _timing(eng, path, spans[path],
                lambda rung, tier, *_: (sess.steps, rung, tier))
    return spans


def _ttft_ms(reqs) -> dict:
    """Median time to first token (ms) of the requests a recovery shed
    (``retries`` > 0) and of the others."""
    out = {}
    for kind, sel in (("shed", lambda r: r.retries > 0),
                      ("unshed", lambda r: r.retries == 0)):
        xs = [(r.first_token_time - r.submit_time) * 1e3 for r in reqs
              if sel(r) and r.first_token_step >= 0]
        out[kind] = statistics.median(xs) if xs else None
    return out


def _trail(sess, plan) -> dict:
    return dict(steps=sess.steps, oom_events=list(sess.oom_events),
                poisoned=sorted(sess.mm.poisoned),
                rung_history=list(sess.rung_history),
                tier_history=list(sess.tier_history),
                fault_log=[(s, st) for s, st, _ in plan.log])


def serve_faults_full(seed: int = 0) -> dict:
    """Phase 10a: the soak's serving plan (``soak.serve_plan``: an OOM on
    rung 2 from step 4, one on rung 1 at tier 1 from step 10, latency
    spikes at steps 14 and 15) and ``ServeConfig`` (rungs 1/2, tiers 0/1,
    4 tokens, ``t_ctrl`` 4, ``max_request_retries`` 2) through a
    ``ServeSession`` over smollm-135m at full width and depth (30 layers,
    134,515,008 parameters, seeded init), prompt ``SF_PROMPT``, cache
    ``SF_CACHE``, ``SF_REQUESTS`` seeded prompts. Every request ends done
    or failed, one at least done; no path runs that ``warm()`` did not;
    the launches are exact: ``flash_attention`` 30 a prefill that reached
    the engine (tensor-core route), ``flash_decode`` 30 a decode that did,
    ``qdq_cast`` (two-pass) once a tier-0 leaf (an injected OOM raises
    before its dispatch and launches nothing). -> the trail, launches,
    spans and requests."""
    from repro_torch import tree as tu
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_task
    from repro_torch.resilience import soak
    from repro_torch.serve import ServeSession
    task = get_task("smollm-135m")
    n_layers, vocab = task.cfg.num_layers, task.cfg.vocab_size
    plan = soak.serve_plan(seed)
    cfg = soak.serve_config(prompt_len=SF_PROMPT, total_len=SF_CACHE,
                            seed=seed)
    prompts = np.random.default_rng(seed).integers(0, vocab,
                                                   (SF_REQUESTS, SF_PROMPT))
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launches()
    sess = ServeSession(task, cfg, fault_plan=plan)
    n_params = sum(x.numel() for x in tu.leaves(sess.engine.params_by_tier[1]))
    check(n_layers == 30 and n_params == 134_515_008,
          f"smollm-135m at {n_layers} layers, {n_params} parameters")
    sess.warm()
    warm_compiles = sess.compile_count
    spans = _instrument(sess)
    for p in prompts:
        sess.submit({"tokens": p})
    t0 = time.perf_counter()
    sess.run(max_steps=400)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches, runs = dict(ops.LAUNCHES), dict(sess.engine.runs)
    reqs = list(sess.results().values())
    check(all(r.status in ("done", "failed") for r in reqs)
          and any(r.status == "done" for r in reqs),
          f"statuses {[r.status for r in reqs]}")
    for r in reqs:
        check(r.status != "done" or (len(r.tokens) == cfg.max_new_tokens
                                     and all(0 <= t < vocab
                                             for t in r.tokens)),
              f"request {r.rid} tokens {r.tokens}")
    check(sess.compile_count == warm_compiles,
          f"paths run after warm(): {sess.compile_count - warm_compiles}")
    check(launches["flash_attention"] == n_layers * runs["admit"]
          == launches["flash_attention_tc"]
          and launches["flash_attention_tf32"] == 0
          and launches["flash_attention_simt"] == 0,
          f"flash_attention launches {launches} vs {runs}")
    check(launches["flash_decode"] == n_layers * runs["decode"],
          f"flash_decode launches {launches} vs {runs}")
    check(launches["qdq_cast"] == launches["qdq_cast_two_pass"]
          == len(_lm_leaves()),
          f"qdq_cast launches {launches} vs the tier-0 leaves (two-pass)")
    return dict(trail=_trail(sess, plan), launches=launches, runs=runs,
                spans=spans, ttft=_ttft_ms(reqs), serve_s=serve_s,
                statuses=[r.status for r in reqs],
                retries=[r.retries for r in reqs],
                tokens=sess.decoded_tokens, warm_compiles=warm_compiles)


def _serve_tokens(task, cfg, prompts) -> dict:
    """A fault-free session's tokens for ``prompts``: {rid: tokens}."""
    from repro_torch.serve import ServeSession
    sess = ServeSession(task, cfg)
    sess.warm()
    for p in prompts:
        sess.submit({"tokens": p})
    sess.run()
    out = {rid: list(r.tokens) for rid, r in sess.results().items()}
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _room(sess, base: float) -> dict:
    """What each path needs while the session serves (allocated bytes),
    from ``warm()``'s peaks (``engine.measured``). ``warm()`` ran each path
    beside the session's own caches at the smaller rung, on scratch caches
    of the path's rung (a repack from and to scratch caches), with ``base``
    bytes allocated before it; serving at rung r holds that rung's caches
    only. So a path's own bytes are its peak less ``base`` and its scratch
    caches, and its need at rung r is that plus ``base`` less the smaller
    rung's caches plus rung r's. -> needs by path, the caches, and where a
    cap fails the larger rung's admit only."""
    from repro_torch import tree as tu
    eng = sess.engine
    small, big = eng.rungs
    row = sum(x.nbytes for x in tu.leaves(sess.caches)) / small
    cache = {r: row * r for r in eng.rungs}
    need = {}
    for key, peak in eng.measured.items():
        path, a, b = key
        held = [a, b] if path == "repack" else [a]
        own = peak - base - sum(cache[r] for r in held)
        need["/".join(map(str, key))] = (
            base - cache[small] + sum(cache[r] for r in held) + own)
    below = max(need[k] for k in (f"admit/{small}/1", f"decode/{small}/1",
                                  f"repack/{small}/{big}",
                                  f"repack/{big}/{small}"))
    return dict(need=need, cache=cache, below=below,
                above=need[f"admit/{big}/1"])


def serve_real_oom(seed: int = 0) -> dict:
    """Phase 10b, in a process of its own (``in_child``, with the
    allocator's expandable segments): the allocator's own
    ``torch.OutOfMemoryError`` with a request in flight. Two fault-free
    sessions at the smaller of ``ROOM_RUNGS`` serve the prompts (the
    oracles); then a session at ``ROOM_RUNGS``, tier 1, no plan, warmed
    uncapped, the cache emptied, is capped
    (``set_per_process_memory_fraction``) halfway between what every path
    of a run at the smaller rung needs (its admit and decode, both
    repacks) and what an admit at the larger needs (``_room``, from
    ``engine.measured``), plus what the allocator holds beyond the
    allocated bytes. The first request is admitted and decodes alone at
    the smaller rung; then the other ``ROOM_REQUESTS`` - 1 arrive, the
    session climbs to the larger rung through a repack that moves the live
    row, and the larger rung's first admit fails. The session must catch
    the OOM, poison (the larger rung, 1), step down through the repack that
    moves the live row back, requeue the request it shed and end with
    every request done, each one's tokens (``ROOM_TOKENS``) the oracles'
    (bitwise where the two agree), the live one's included. The cap is
    lifted in ``finally``. -> the numbers, JSON ready."""
    from repro_torch.models.registry import get_task
    from repro_torch.serve import ServeConfig, ServeSession
    task = get_task("smollm-135m")
    small, big = ROOM_RUNGS
    kw = dict(prompt_len=ROOM_PROMPT, total_len=ROOM_CACHE, tiers=(1,),
              max_new_tokens=ROOM_TOKENS, t_ctrl=4, auto_tier=False,
              mem_cap_bytes=64e9, seed=seed)
    prompts = np.random.default_rng(seed + 1).integers(
        0, task.cfg.vocab_size, (ROOM_REQUESTS, ROOM_PROMPT))
    oracles = [_serve_tokens(task, ServeConfig(rungs=(small,), **kw),
                             prompts) for _ in range(2)]
    sess = ServeSession(task, ServeConfig(rungs=ROOM_RUNGS, **kw))
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    sess.warm()
    out = _room(sess, base)
    gc.collect()
    torch.cuda.empty_cache()
    out.update(allocated=torch.cuda.memory_allocated(),
               reserved=torch.cuda.memory_reserved())
    out["cap"] = ((out["below"] + out["above"]) / 2
                  + out["reserved"] - out["allocated"])
    out["total"] = torch.cuda.get_device_properties(0).total_memory
    check(out["above"] - out["below"] >= 2 * ROOM_MARGIN,
          f"no cap separates rung {small}'s paths from a rung-{big} admit: "
          f"{out}")
    spans = _instrument(sess)
    try:
        torch.cuda.set_per_process_memory_fraction(out["cap"] / out["total"])
        live = sess.submit({"tokens": prompts[0]})
        sess.step()
        reqs = sess.results()
        check(reqs[live].status == "active" and sess.rung == small,
              f"request {live} {reqs[live].status} at rung {sess.rung}")
        for p in prompts[1:]:
            sess.submit({"tokens": p})
        sess.run()
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    out.update(events=list(sess.oom_events),
               rung_history=list(sess.rung_history))
    log(f"serving faults, real OOM: {out}")
    reqs = sess.results()
    check(len(sess.oom_events) == 1 and sess.oom_events[0][1:] == (big, 1,
                                                                  "admit")
          and (big, 1) in sess.mm.poisoned and sess.rung == small
          and [r for _, r in sess.rung_history] == [small, big, small],
          f"real OOM: events {sess.oom_events}, rungs {sess.rung_history}, "
          f"poisoned {sess.mm.poisoned}")
    at = sess.oom_events[0][0]
    moved = [k for k, _, ok in spans["repack"] if ok and k[0] == at]
    check(moved == [(at, small, big), (at, big, small)]
          and reqs[live].retries == 0 and reqs[live].admitted_step < at,
          f"the live request {live} (retries {reqs[live].retries}, admitted "
          f"at step {reqs[live].admitted_step}) through the repacks {moved} "
          f"around the OOM at step {at}")
    check(all(r.status == "done" for r in reqs.values())
          and sum(r.retries for r in reqs.values()) >= 1,
          f"statuses {[(r.status, r.retries) for r in reqs.values()]}")
    agree = {rid: oracles[0][rid] == oracles[1][rid] for rid in reqs}
    for rid, r in reqs.items():
        check(r.tokens == oracles[0][rid] if agree[rid]
              else r.tokens in (oracles[0][rid], oracles[1][rid]),
              f"request {rid}: {r.tokens} vs the oracles' {oracles[0][rid]}"
              f", {oracles[1][rid]}")
    failed = [(k, ms) for k, ms, ok in spans["admit"] if not ok]
    check(len(failed) == 1, f"failed admits {failed}")
    retry = next((k, ms) for k, ms, ok in spans["admit"]
                 if ok and k[0] >= at and k[1] == small)
    out.update(where="admit", failed=failed[0], retry=retry,
               oom=spans["oom"][0], bitwise=sum(agree.values()),
               live_bitwise=agree[live],
               ttft=_ttft_ms(list(reqs.values())))
    return out


def in_child(name: str, alloc_conf: str = "") -> dict:
    """Run ``CHILDREN[name]`` in a fresh process of this script
    (``--child``), its allocator set by ``alloc_conf``
    (``PYTORCH_CUDA_ALLOC_CONF``): there the allocator holds what the check
    makes and little else, so a cap bites where the bytes the check
    measures say. -> its result (its last line of output); the others are
    logged."""
    import os
    env = {k: v for k, v in os.environ.items()
           if k != "PYTORCH_CUDA_ALLOC_CONF"}
    if alloc_conf:
        env["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--child", name], env=env, capture_output=True,
                          text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(f"  [{name}] {line}")
    check(proc.returncode == 0 and lines,
          f"{name} exited {proc.returncode}: {proc.stderr[-4000:]}")
    return json.loads(lines[-1])


def soak_on_card() -> dict:
    """Phase 10c: ``python -m repro_torch.resilience.soak`` on the card
    (``soak.main``, both legs on cuda), its report to a temporary file."""
    import io
    from repro_torch.resilience import soak
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_soak_"))
    try:
        t0 = time.perf_counter()
        with signals_kept(), contextlib.redirect_stdout(io.StringIO()):
            code = soak.main(["--out", str(tmp / "soak.json")])
        secs = time.perf_counter() - t0
        report = json.loads((tmp / "soak.json").read_text())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(code == 0 and report["ok"], f"soak.main: exit {code}, {report}")
    return dict(seconds=secs, legs={leg["leg"]: leg for leg in report["legs"]})


def serve_faults_phase(card: str) -> dict:
    """Phase 10: the soak's serving plan at full width on the card, its
    trail against ``soak.serve_soak(device="cpu")`` run here; a real OOM;
    the soak on the card; the costs beside the card's name and limit."""
    from repro_torch.resilience import soak
    t_phase = time.perf_counter()
    full = serve_faults_full()
    t0 = time.perf_counter()
    cpu = soak.serve_soak(device="cpu")
    cpu_s = time.perf_counter() - t0
    for k, v in full["trail"].items():
        check(cpu[k] == v, f"{k}: card {v}, CPU soak {cpu[k]}")
    tr, sp = full["trail"], full["spans"]
    log(f"serving faults, smollm-135m (30 layers) under the soak's plan, "
        f"prompt {SF_PROMPT}, cache {SF_CACHE}, {SF_REQUESTS} requests: "
        f"{tr['steps']} steps, statuses {full['statuses']}, retries "
        f"{full['retries']}; oom_events {tr['oom_events']}, poisoned "
        f"{tr['poisoned']}, rung history {tr['rung_history']}, tier history "
        f"{tr['tier_history']}, fault log {tr['fault_log']}: the CPU soak's "
        f"({cpu_s:.1f} s); paths {full['warm_compiles']} after warm(), none "
        f"new; path runs {full['runs']}; launches "
        f"{ {k: v for k, v in full['launches'].items() if v} }")
    sk = soak_on_card()
    tleg, sleg = sk["legs"]["train"], sk["legs"]["serve"]
    log(f"serving faults, soak.main on the card in {sk['seconds']:.1f} s: "
        f"train oom_events {tleg['oom_events']}, rollback_events "
        f"{tleg['rollback_events']}, restored {tleg['restored_step']}, final "
        f"step {tleg['final_step']}, lr_demote {tleg['lr_demote']}; serve "
        f"oom_events {sleg['oom_events']}, compiles during the run "
        f"{sleg['compiles_during_run']}")
    # in the script's process, blocks freed inside live segments keep tens
    # of MB more than the gap between the paths; expandable segments keep
    # the child's reserved bytes near its allocated ones
    room = in_child("serve-real-oom", "expandable_segments:True")
    log(f"serving faults, real OOM at rungs {ROOM_RUNGS}, prompt "
        f"{ROOM_PROMPT}, cache {ROOM_CACHE}: "
        f"cap {room['cap']:.0f} of {room['total']} bytes (expandable "
        f"segments), halfway between {room['below']:.0f} (the most a "
        f"rung-{ROOM_RUNGS[0]} path or a repack needs) and "
        f"{room['above']:.0f} (a rung-{ROOM_RUNGS[1]} admit), plus "
        f"{room['reserved'] - room['allocated']} reserved beyond the "
        f"allocated bytes; the "
        f"{room['where']} path failed: events {room['events']}, rung history "
        f"{room['rung_history']}; all {ROOM_REQUESTS} requests done, tokens "
        f"bitwise the oracles' in the {room['bitwise']} requests where the "
        f"two oracles agree, the rest one oracle's")
    down = next(ms for k, ms, _ in sp["oom"] if k[3] == "decode")
    down_repack = next(ms for k, ms, _ in sp["repack"]
                       if k[1:] == (2, 1))
    demote = next(ms for k, ms, _ in sp["oom"] if k[1:3] == (1, 1))
    dec = {t: statistics.median(ms for k, ms, ok in sp["decode"]
                                if ok and k[1:] == (1, t)) for t in (0, 1)}
    (_, a_ms), (_, r_ms) = room["failed"], room["retry"]
    log(f"serving faults ({card}): the injected step-down 2 -> 1 "
        f"{down:.3f} ms (the repack {down_repack:.3f} ms); the tier "
        f"demotion {demote:.3f} ms, then a decode at rung 1 tier 0 "
        f"{dec[0]:.3f} ms against tier 1 {dec[1]:.3f} ms (medians); a shed "
        f"request's TTFT {full['ttft']['shed']:.1f} ms against an unshed "
        f"one's {full['ttft']['unshed']:.1f} ms (medians); the real OOM's "
        f"failed {room['where']} {a_ms:.3f} ms, its recovery "
        f"{room['oom'][1]:.3f} ms, the retry {r_ms:.3f} ms; shed TTFT "
        f"{room['ttft']['shed']:.1f} ms against unshed "
        f"{room['ttft']['unshed']:.1f} ms; phase 10 in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return full


# ------------------------------------------- phase 11: serving, the rest ---
#: 11a: the chunked prefill's prompts (lengths), chunk, cache, tokens a
#: request; the injected OOM's step (rung 2: the first chunk of that step)
CH_PROMPTS, CH_CHUNK, CH_CACHE, CH_TOKENS, CH_OOM_STEP = (
    (17, 64, 100, 128), 16, 512, 8, 1)
#: 11a: the whole-prompt prefill held to the chunked one at these prompt
#: lengths and tiers (prompts this short take the plain attention in the
#: prefill: the flash forward's blocks are 256 rows; a prompt token costs
#: a decode step's host time, so two prompts)
CH_COMPARE = ((17, 0), (128, 1))
#: 11a: chunked against whole-prompt, a fraction of the largest magnitude:
#: first-token logits and the cache rows (K, V) of the prompt's positions.
#: Both compute in bf16 and sum in other orders (the prefill's attention
#: over the prompt against one decode per token) through 30 layers; 1.2 to
#: 1.5 % seen with the plain versions on the CPU at these lengths
CH_TOL = 5e-2
#: 11b: the SLO traffic: classes (``TrafficClass`` fields), trace steps,
#: seed, cache, rungs and the class-0 budget
SLO_CLASSES = (
    dict(priority=0, rate=0.15, prompt_lens=(16, 32), new_tokens=(8,),
         deadline_ms=60_000.0),
    dict(priority=2, rate=0.1, prompt_lens=(48, 96), new_tokens=(8,),
         burst_every=8, burst_size=2))
SLO_STEPS, SLO_SEED, SLO_CACHE, SLO_RUNGS = 24, 11, 128, (1, 2, 4)
#: 11c: the vision sessions: rungs, tiers, eval images (served in waves of
#: 16, 32 and 48, so each wave takes its own rung), and the card-vs-CPU
#: bound on the logits by tier, a fraction of the largest magnitude:
#: cuDNN's and oneDNN's f32 sums in other orders (tier 2); bf16 layer
#: outputs rounded after those sums (tiers 1 and 0; 5.5e-3 seen between
#: the port and the reference on the CPU, tests/test_torch_vision_serve.py)
VIS_RUNGS, VIS_TIERS, VIS_IMAGES = (16, 32, 64), (2, 1, 0), 96
VIS_WAVES = (16, 32, 48)
VIS_TOL = {2: 1e-3, 1: 3e-2, 0: 3e-2}
#: phase 11's seconds are printed against this target
PHASE11_TARGET_S = 90.0
#: 11a and 11b serve smollm-135m cut to this many of its 30 layers (full
#: width): each prompt token is a host-bound B-1 decode step, so their
#: time goes with the depth; cut from 30 to keep the whole script inside
#: its clock with phase 14 (their 30-layer numbers are in PERF.md)
SERVE_REST_DEPTH = 8


def _margins(logits: torch.Tensor) -> torch.Tensor:
    """Top-2 gap of each row of ``logits`` (f32)."""
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def _chunk_against_prefill(eng, prompt, tier: int) -> dict:
    """One prompt through the whole-prompt prefill (``task.prefill``, its
    caches scattered into a 1-row cache) and through the decode hook one
    token at a time on a fresh 1-row cache (what ``chunk_admit`` runs):
    the first-token logits' and the K/V rows' largest gaps over their
    largest magnitudes, positions equal, argmax equal unless a near-tie."""
    from repro_torch.serve.engine import scatter_prefill
    task, params = eng.task, eng.params_by_tier[tier]
    dev = eng.device
    toks = torch.as_tensor(prompt, dtype=torch.int32, device=dev)
    with torch.no_grad():
        lw, pre = task.prefill(params, {"tokens": toks[None]})
        cw = scatter_prefill(eng.init_caches(1), pre, 0)
        cc = eng.init_caches(1)
        pos = torch.arange(len(prompt), dtype=torch.int32, device=dev)
        for j in range(len(prompt)):
            lc, _ = task.decode(params, cc, toks[j:j + 1], pos[j:j + 1])
    lw, lc = lw[0].float(), lc[0].float()
    mw, mc = cw["seg0"]["b0"]["mix"], cc["seg0"]["b0"]["mix"]
    P = len(prompt)
    out = {"logits": float((lw - lc).abs().max() / lw.abs().max()),
           "max_logit": float(lw.abs().max())}
    for key in ("k", "v"):
        a, b = mw[key][:, :, :P].float(), mc[key][:, :, :P].float()
        out[key] = float((a - b).abs().max() / a.abs().max())
    check(torch.equal(mw["pos"], mc["pos"]), f"prompt {P} tier {tier}: "
          "cache positions differ")
    out["same_argmax"] = int(lw.argmax()) == int(lc.argmax())
    out["margin"] = float(_margins(lw))
    return out


def _teacher_margins(eng, prompt, tokens, tier: int) -> list:
    """The top-2 margin at each generated position of ``tokens``: the
    decode hook at ``tier``, teacher-forced over ``prompt`` then
    ``tokens`` on a fresh 1-row cache."""
    dev = eng.device
    seq = torch.as_tensor(list(prompt) + list(tokens), dtype=torch.int32,
                          device=dev)
    pos = torch.arange(len(seq), dtype=torch.int32, device=dev)
    cc, out = eng.init_caches(1), []
    with torch.no_grad():
        for j in range(len(seq) - 1):
            logits, _ = eng.task.decode(eng.params_by_tier[tier], cc,
                                        seq[j:j + 1], pos[j:j + 1])
            if j >= len(prompt) - 1:
                out.append((float(_margins(logits[0])),
                            float(logits[0].float().abs().max())))
    return out


def chunked_prefill_phase(seed: int = 0, device="cuda",
                          reduced: bool = False) -> dict:
    """Phase 11a: chunked prefill at smollm-135m's full width, at the depth
    the registry gives (``serve_rest_phase`` cuts it to
    ``SERVE_REST_DEPTH`` layers).
    A session with ``prefill_chunk`` ``CH_CHUNK`` (rungs 1/2, tiers 0/1
    warmed, tier 1 served, cache ``CH_CACHE``) serves four prompts of
    ``CH_PROMPTS`` tokens; ``serve.step_oom`` at step ``CH_OOM_STEP`` on
    rung 2 fails the first chunk of that step: rung 2 poisoned, the
    session steps down, the youngest request shed and replayed. Every
    request done; no path runs after ``warm()``; the launches exact: no
    flash forward, ``flash_decode`` 30 a decode step and 30 a prompt token
    through the chunk path (warm-ups included), the two-pass ``qdq_cast``
    once a tier-0 leaf. Then a whole-prompt session serves the 128-token
    prompt: its tokens equal the chunked session's, or first differ where
    the top-2 margin is within ``CH_TOL`` of the largest logit. Then the
    first-token logits and the cache rows of each ``CH_COMPARE`` prompt,
    chunked against whole-prompt, within ``CH_TOL``. -> numbers and
    launches."""
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_task
    from repro_torch.resilience import Fault, FaultPlan
    from repro_torch.serve import ServeConfig, ServeSession
    dev = torch.device(device)
    task = get_task("smollm-135m", reduced, device)
    n_layers, vocab = task.cfg.num_layers, task.cfg.vocab_size
    rng = np.random.default_rng(seed + 3)
    prompts = [rng.integers(0, vocab, (n,)) for n in CH_PROMPTS]
    kw = dict(prompt_len=max(CH_PROMPTS), total_len=CH_CACHE,
              rungs=(1, 2), tiers=(0, 1), ladder="tpu",
              max_new_tokens=CH_TOKENS, t_ctrl=4, auto_tier=False, seed=seed)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ops.reset_launches()
    plan = FaultPlan([Fault("serve.step_oom", step=CH_OOM_STEP, rung=2)])
    sess = ServeSession(task, ServeConfig(prefill_chunk=CH_CHUNK, **kw),
                        fault_plan=plan, device=device)
    eng = sess.engine
    warmed = sess.warm()
    spans = []
    if dev.type == "cuda":
        _timing(eng, "chunk_admit", spans, lambda *a: (sess.steps, a[6]))
    for p in prompts:
        sess.submit({"tokens": p})
    t0 = time.perf_counter()
    stats = sess.run(max_steps=2000)
    serve_s = time.perf_counter() - t0
    launches, runs = dict(ops.LAUNCHES), dict(eng.runs)
    reqs = sess.results()
    check(all(r.status == "done" and len(r.tokens) == CH_TOKENS
              and all(0 <= t < vocab for t in r.tokens)
              for r in reqs.values()),
          f"11a statuses {[(r.status, r.tokens) for r in reqs.values()]}")
    check(sess.compile_count == warmed and stats["warm_s"] == 0.0,
          f"11a: paths run after warm(): {sess.compile_count - warmed}")
    check([e[1:] for e in sess.oom_events] == [(2, 1, "chunk")]
          and sess.oom_events[0][0] == CH_OOM_STEP
          and (2, 1) in sess.mm.poisoned and sess.rung == 1
          and sum(r.retries for r in reqs.values()) >= 1,
          f"11a: the injected chunk OOM: events {sess.oom_events}, rungs "
          f"{sess.rung_history}, retries "
          f"{[r.retries for r in reqs.values()]}")
    check(runs["admit"] == 0 and runs["chunk"] >= len(CH_PROMPTS),
          f"11a path runs {runs}")
    prompt_tokens = eng.chunk_tokens
    if dev.type == "cuda":
        check(launches["flash_attention"] == 0,
              f"11a: no flash forward in chunked mode: {launches}")
        check(launches["flash_decode"]
              == n_layers * (runs["decode"] + prompt_tokens),
              f"11a flash_decode launches {launches['flash_decode']} vs "
              f"{n_layers} x ({runs['decode']} decodes + {prompt_tokens} "
              "prompt tokens)")
        check(launches["qdq_cast"] == launches["qdq_cast_two_pass"]
              == len(_lm_leaves()),
              f"11a qdq_cast launches {launches} vs the tier-0 leaves")
    served = sum(CH_PROMPTS) + len(kw["rungs"]) * len(kw["tiers"])
    check(prompt_tokens >= served, f"11a prompt tokens {prompt_tokens} < "
          f"{served}")
    whole = ServeSession(task, ServeConfig(**kw), params=None,
                         device=device)
    whole.warm()
    w = whole.submit({"tokens": prompts[-1]})
    whole.run(max_steps=200)
    got, want = reqs[len(prompts) - 1].tokens, whole.results()[w].tokens
    margins = None
    if got != want:
        margins = _teacher_margins(eng, prompts[-1], got, 1)
        pos = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        m, top = margins[pos]
        check(m <= CH_TOL * top, f"11a: whole-prompt tokens {want} against "
              f"chunked {got}: first differ at {pos}, margin {m} > "
              f"{CH_TOL} x {top}")
    del whole
    cmp = {}
    for P, tier in CH_COMPARE:
        prompt = rng.integers(0, vocab, (P,))
        r = _chunk_against_prefill(eng, prompt, tier)
        check(max(r["logits"], r["k"], r["v"]) <= CH_TOL
              and (r["same_argmax"] or r["margin"]
                   <= CH_TOL * r["max_logit"]),
              f"11a chunked against whole-prompt, prompt {P} tier {tier}: "
              f"{r}")
        cmp[(P, tier)] = r
    chunk_ms = [ms for _, ms, ok in spans if ok]
    per_token = (sum(chunk_ms) / sum(k[1] for k, _, ok in spans if ok)
                 if chunk_ms else None)
    return dict(launches=launches, runs=runs, prompt_tokens=prompt_tokens,
                oom=list(sess.oom_events), rungs=list(sess.rung_history),
                retries=[r.retries for r in reqs.values()],
                tokens=(got, want), margins=margins, compare=cmp,
                serve_s=serve_s, tok_s=stats["tok_s"], chunk_ms=chunk_ms,
                per_token_ms=per_token, ttft=_ttft_ms(list(reqs.values())),
                sess=sess)


def slo_traffic_phase(seed: int = 0, device="cuda",
                      reduced: bool = False) -> dict:
    """Phase 11b: SLO traffic replayed at smollm-135m's full width, at the
    depth the registry gives (``SERVE_REST_DEPTH`` layers in
    ``serve_rest_phase``): ``schedule="slo"``, ``prefill_chunk`` 16, rungs ``SLO_RUNGS``,
    tier 1, cache ``SLO_CACHE``, class 0's step budget 60 s; ``drive``
    over ``poisson_trace(SLO_CLASSES, SLO_STEPS, seed=SLO_SEED)``. No path
    runs after ``warm()`` (``warm_s`` 0.0); completed plus rejected equal
    the offered requests; the launches exact (``flash_decode`` 30 a decode
    step and 30 a prompt token through the chunk path, no flash forward,
    no cast at tier 1). -> the report and the numbers."""
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_task
    from repro_torch.serve import (ServeConfig, ServeSession, TrafficClass,
                                   drive, poisson_trace)
    dev = torch.device(device)
    task = get_task("smollm-135m", reduced, device)
    n_layers, vocab = task.cfg.num_layers, task.cfg.vocab_size
    cfg = ServeConfig(prompt_len=16, total_len=SLO_CACHE, rungs=SLO_RUNGS,
                      tiers=(1,), schedule="slo", prefill_chunk=16,
                      latency_slo_ms={0: 60_000.0}, t_ctrl=4, seed=seed)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ops.reset_launches()
    sess = ServeSession(task, cfg, device=device)
    warmed = sess.warm()
    trace = poisson_trace([TrafficClass(**c) for c in SLO_CLASSES],
                          SLO_STEPS, seed=SLO_SEED)
    rep = drive(sess, trace, vocab=vocab, seed=SLO_SEED)
    launches, runs = dict(ops.LAUNCHES), dict(sess.engine.runs)
    reqs = list(sess.results().values())
    done = [r for r in reqs if r.status == "done"]
    check(rep["compile_count"] == warmed and rep["warm_s"] == 0.0,
          f"11b: paths run after warm(): {rep['compile_count'] - warmed}")
    check(len(done) + rep["rejected"] == rep["offered"] == len(trace)
          and done, f"11b: {len(done)} done + {rep['rejected']} rejected "
          f"!= {rep['offered']} offered")
    check(all(len(r.tokens) == r.max_new_tokens for r in done),
          "11b: every done request has its tokens")
    if dev.type == "cuda":
        check(launches["flash_attention"] == 0 and launches["qdq_cast"] == 0
              and launches["flash_decode"] == n_layers * (
                  runs["decode"] + sess.engine.chunk_tokens),
              f"11b launches {launches} vs {n_layers} x ({runs['decode']} "
              f"decodes + {sess.engine.chunk_tokens} prompt tokens)")
    ttft = {}
    for c in sorted({r.priority for r in done}):
        xs = [(r.first_token_time - r.submit_time) * 1e3 for r in done
              if r.priority == c]
        ttft[c] = (float(np.percentile(xs, 50)), float(np.percentile(xs, 99)))
    step_ms = {r: float(np.median(sess.lat.samples(r, 1))) * 1e3
               for r in SLO_RUNGS if sess.lat.samples(r, 1)}
    return dict(report=rep, launches=launches, runs=runs, ttft=ttft,
                step_ms=step_ms, prompt_tokens=sess.engine.chunk_tokens,
                offered=len(trace))


def _calibrated(arch: str, seed: int):
    """A vision model's seeded weights and BatchNorm statistics from four
    train-mode forwards of 64 training images (so inference normalizes by
    real statistics), on the CPU."""
    from repro_torch.models.registry import get_task
    from repro_torch.models.vision import vision_apply
    task = get_task(arch, device="cpu")
    params, aux = task.init(torch.Generator().manual_seed(seed))
    stream = task.data_stream(64, seed=seed)
    with torch.no_grad():
        for i in range(4):
            _, aux = vision_apply(params, aux, stream.batch(i)["images"],
                                  True, task.cfg)
    images = task.eval_stream(VIS_IMAGES, seed=seed).batch(0)["images"]
    return params, aux, images.numpy()


def _vision_session(arch, params, aux, images, device, seed):
    """One device's vision session: warmed, then per tier (2, 1, 0, pinned)
    the eval images in waves of ``VIS_WAVES``; then, at tier 1, an injected
    ``serve.step_oom`` on rung 64 fails the inference of a 48-image wave:
    the wave shed, rung 64 poisoned, the rest served at 32 and 16. ->
    predictions by tier, the logits of every image by tier (through the
    engine afterwards), the trail, launches, timings."""
    from repro_torch import tree as tu
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_task
    from repro_torch.resilience import Fault, FaultPlan
    from repro_torch.serve import ServeConfig, ServeSession
    dev = torch.device(device)
    task = get_task(arch, device=device)
    p = tu.tree_map(lambda x: x.to(dev), params)
    a = tu.tree_map(lambda x: x.to(dev), aux)
    ops.reset_launches()
    sess = ServeSession(task, ServeConfig(
        rungs=VIS_RUNGS, tiers=VIS_TIERS, ladder="gpu", t_ctrl=1,
        auto_tier=False, seed=seed), params=p, aux_state=a, device=device)
    cast = dict(ops.LAUNCHES)
    warmed = sess.warm()
    preds = {}
    for tier in VIS_TIERS:
        sess.set_tier(tier)
        first = len(sess.requests)
        i = 0
        for n in VIS_WAVES:
            for x in images[i:i + n]:
                sess.submit({"images": x})
            i += n
            sess.run()
        preds[tier] = [sess.requests[first + j].result
                       for j in range(len(images))]
    sess.set_tier(1)
    plan = FaultPlan([Fault("serve.step_oom", step=sess.steps, rung=64)])
    sess.fault_plan = plan
    first = len(sess.requests)
    for x in images[:48]:
        sess.submit({"images": x})
    sess.run()
    reqs = list(sess.requests.values())
    served = dict(ops.LAUNCHES)
    check(sess.compile_count == warmed, f"{arch} on {device}: paths run "
          f"after warm(): {sess.compile_count - warmed}")
    check(all(r.status == "done" and 0 <= r.result < 10 for r in reqs),
          f"{arch} on {device}: statuses")
    oom = list(sess.oom_events)
    check([e[1:] for e in oom] == [(64, 1, "infer")]
          and all(r.retries == 1 for r in reqs[first:])
          and (64, 1) in sess.mm.poisoned,
          f"{arch} on {device}: the injected infer OOM: {oom}, retries "
          f"{[r.retries for r in reqs[first:]]}")
    trail = dict(oom=oom, rungs=list(sess.rung_history),
                 tiers=list(sess.tier_history),
                 poisoned=sorted(sess.mm.poisoned),
                 log=[(s, st) for s, st, _ in plan.log],
                 retries=[r.retries for r in reqs])
    eng = sess.engine
    logits = {}
    for tier in VIS_TIERS:
        out = [eng.infer(64, tier, {"images": images[:64]})[1],
               eng.infer(32, tier, {"images": images[64:]})[1]]
        logits[tier] = torch.cat(out).float().cpu()
    ips, peak = {}, {}
    if dev.type == "cuda":
        for r in VIS_RUNGS:
            for tier in VIS_TIERS:
                batch = {"images": images[:r]}
                ips[(r, tier)] = r / time_ms(
                    lambda: eng.infer(r, tier, batch), iters=2, reps=3) * 1e3
                peak[(r, tier)] = eng.measured.get(("infer", r, tier))
    return dict(preds=preds, logits=logits, trail=trail, cast=cast,
                served=served, ips=ips, peak=peak,
                leaves=sum(1 for x in tu.leaves(params)
                           if x.is_floating_point()))


def vision_serve_phase(seed: int = 0, device="cuda") -> dict:
    """Phase 11c: ResNet-18 and EfficientNet-B0 through ``ServeSession``
    (rungs ``VIS_RUNGS``, tiers ``VIS_TIERS``, gpu ladder), on the card and
    on the CPU (the port's plain path) from the same weights and BatchNorm
    statistics (``_calibrated``): the same trail; at each tier the logits
    of the ``VIS_IMAGES`` eval images within ``VIS_TOL`` and the
    predictions equal wherever the CPU's top-2 margin exceeds that bound;
    the one-pass ``qdq_cast`` launched once a floating leaf of the tier-0
    set (at the session's construction) and nothing else. -> numbers."""
    out = {}
    for arch in ("resnet18", "efficientnet_b0"):
        t0 = time.perf_counter()
        params, aux, images = _calibrated(arch, seed)
        t1 = time.perf_counter()
        card = _vision_session(arch, params, aux, images, device, seed)
        t2 = time.perf_counter()
        cpu = _vision_session(arch, params, aux, images, "cpu", seed)
        secs = (t1 - t0, t2 - t1, time.perf_counter() - t2)
        check(card["trail"] == cpu["trail"], f"{arch}: trail on the card "
              f"{card['trail']} against the CPU's {cpu['trail']}")
        gaps = {}
        for tier in VIS_TIERS:
            lc, lw = card["logits"][tier], cpu["logits"][tier]
            scale = float(lw.abs().max())
            gaps[tier] = float((lc - lw).abs().max()) / scale
            check(gaps[tier] <= VIS_TOL[tier], f"{arch} tier {tier}: card "
                  f"logits {gaps[tier]} of the largest from the CPU's")
            sure = _margins(lw) > VIS_TOL[tier] * scale
            pc = torch.tensor(card["preds"][tier])
            pw = torch.tensor(cpu["preds"][tier])
            check(bool((pc == pw)[sure].all())
                  and bool((pw == lw.argmax(-1))[sure].all()),
                  f"{arch} tier {tier}: predictions differ where the CPU's "
                  "margin is clear")
        if torch.device(device).type == "cuda":
            n = card["leaves"]
            check(card["cast"]["qdq_cast"] == card["cast"][
                "qdq_cast_one_pass"] == n and card["served"] == card["cast"],
                  f"{arch}: qdq_cast launches {card['cast']} / "
                  f"{card['served']} vs {n} floating leaves (one-pass)")
        out[arch] = dict(card=card, gaps=gaps, secs=secs,
                         classes=len(set(cpu["preds"][1])))
    return out


def serve_rest_phase(card: str) -> dict:
    """Phase 11: 11a, 11b, 11c and their numbers beside the card's name
    and power limit. -> the launches by path."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    cut = _registry_config("smollm-135m", _lm_cfg(SERVE_REST_DEPTH))
    with cut:
        ch = chunked_prefill_phase()
    t_a = time.perf_counter() - t0
    sess = ch.pop("sess")
    eng = sess.engine
    rng = np.random.default_rng(21)
    chunk = rng.integers(0, sess.task.cfg.vocab_size, (CH_CHUNK,))
    caches = eng.init_caches(1)
    # two lanes of a chunk: the profiler's own cost grows with the events
    _profile(lambda: eng.chunk_admit(1, 1, caches, 0, chunk, 0, 2, True),
             2, _serve_family, f"a chunk at B 1, per prompt token "
             f"({SERVE_REST_DEPTH} layers, cache {CH_CACHE}; 2 tokens)")
    del sess, eng, caches
    cmp = ", ".join(f"{P}/t{t}: logits {r['logits']:.4f}, K {r['k']:.4f}, "
                    f"V {r['v']:.4f}"
                    for (P, t), r in ch["compare"].items())
    got, want = ch["tokens"]
    log(f"serving, chunked prefill (11a), smollm-135m ({SERVE_REST_DEPTH} "
        f"layers), prompts "
        f"{CH_PROMPTS}, chunk {CH_CHUNK}, cache {CH_CACHE} ({card}): "
        f"{ch['prompt_tokens']} prompt tokens through the chunk path "
        f"(warm-ups included), path runs {ch['runs']}, launches "
        f"{ {k: v for k, v in ch['launches'].items() if v} }; injected OOM "
        f"{ch['oom']}, rungs {ch['rungs']}, retries {ch['retries']}; "
        f"{ch['tok_s']:.1f} tok/s, TTFT shed {ch['ttft']['shed']} / unshed "
        f"{ch['ttft']['unshed']} ms; a chunk's host time "
        f"{statistics.median(ch['chunk_ms']):.3f} ms (median of "
        f"{len(ch['chunk_ms'])}), {ch['per_token_ms']:.3f} ms a prompt "
        f"token")
    log(f"  chunked against whole-prompt (gap / largest, bound {CH_TOL}): "
        f"{cmp}; the 128-token request's tokens chunked {got}, "
        f"whole-prompt {want}"
        + ("" if ch["margins"] is None else "; top-2 margins along the "
           f"chunked tokens {[round(m, 4) for m, _ in ch['margins']]}"))
    t0 = time.perf_counter()
    with _registry_config("smollm-135m", _lm_cfg(SERVE_REST_DEPTH)):
        slo = slo_traffic_phase()
    t_b = time.perf_counter() - t0
    rep = slo["report"]
    log(f"serving, SLO traffic (11b), smollm-135m ({SERVE_REST_DEPTH} "
        f"layers), rungs "
        f"{SLO_RUNGS}, cache {SLO_CACHE}, chunk 16, trace of {SLO_STEPS} "
        f"steps (seed {SLO_SEED}), {slo['offered']} offered ({card}): "
        f"{rep['steps']} steps, {rep['decoded_tokens']} tokens, "
        f"{rep['tok_s']:.1f} tok/s, rejected {rep['rejected']}, rung "
        f"history {rep['rung_history']}; TTFT ms p50/p99 by class "
        f"{ {c: (round(a, 1), round(b, 1)) for c, (a, b) in slo['ttft'].items()} }"
        f"; decode step ms by rung (median) "
        f"{ {r: round(v, 3) for r, v in slo['step_ms'].items()} }; "
        f"launches {slo['launches']['flash_decode']} flash_decode for "
        f"{slo['runs']['decode']} decodes and {slo['prompt_tokens']} prompt "
        f"tokens")
    log(f"  class_report {json.dumps(rep['classes'])}")
    t0 = time.perf_counter()
    vis = vision_serve_phase()
    t_c = time.perf_counter() - t0
    for arch, v in vis.items():
        c = v["card"]
        log(f"serving, vision (11c), {arch}, rungs {VIS_RUNGS}, tiers "
            f"{VIS_TIERS}, {VIS_IMAGES} eval images a tier ({card}): card "
            f"against CPU logits (gap / largest) "
            f"{ {t: round(g, 6) for t, g in v['gaps'].items()} }, "
            f"{v['classes']} classes predicted at tier 1; trail "
            f"{c['trail']['oom']}, rungs {c['trail']['rungs']}; qdq_cast "
            f"(one-pass) {c['cast']['qdq_cast_one_pass']} for {c['leaves']} "
            f"leaves; images/s by (rung, tier) "
            f"{ {k: round(x, 1) for k, x in c['ips'].items()} }; peak bytes "
            f"by (rung, tier) {c['peak']}; seconds: the weights and "
            f"statistics on the CPU {v['secs'][0]:.1f}, the card's session "
            f"{v['secs'][1]:.1f}, the CPU's {v['secs'][2]:.1f}")
    total = time.perf_counter() - t_phase
    # a target, not a check: 11a and 11b run ~900 prompt tokens, each a
    # host-bound decode step whose time moves with the host (PERF.md §5)
    log(f"phase 11 in {total:.1f} s (target {PHASE11_TARGET_S:.0f} s; 11a "
        f"{t_a:.1f}, 11b {t_b:.1f}, 11c {t_c:.1f})")
    return dict(chunk=ch["launches"], slo=slo["launches"],
                vision=sum(v["card"]["cast"]["qdq_cast_one_pass"]
                           for v in vis.values()))


# ----------------------------- phase 11 kernels: the new paths' shapes ---
def _vision_leaves():
    """The floating leaves of ResNet-18's and EfficientNet-B0's
    parameters, as shapes."""
    from repro_torch import tree as tu
    from repro_torch.models.vision import VisionConfig, vision_init
    out = []
    for arch in ("resnet18", "efficientnet_b0"):
        params, _ = vision_init(torch.Generator(), VisionConfig(arch),
                                device="meta")
        out += [tuple(x.shape) for x in tu.leaves(params)
                if x.is_floating_point()]
    return out


def check_qdq_vision(dev, bw, ops_rate) -> dict:
    """qdq_cast bitwise against its plain version at every floating leaf
    of ResNet-18 and EfficientNet-B0 (the vision sessions' tier-0 weight
    sets), both forms (two-pass: the tpu ladder without an absmax;
    one-pass: the gpu ladder, the sessions' own), f32 and bf16 out; the
    one-pass form timed over both models' leaves, f32 in and bf16 out as
    the sessions cast, beside the plain version and the byte bound. -> the
    ``kernels`` line's row ``qdq_cast_one_pass@vision_serve``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import qdq_cast as qc
    gen = torch.Generator(device=dev).manual_seed(8)
    xs = [torch.randn(s, generator=gen, device=dev) * 0.1
          for s in _vision_leaves()]
    err = 0.0
    for x in xs:
        for ladder, form in (("tpu", "two_pass"), ("gpu", "one_pass")):
            check(qc.form(0, ladder, None) == form, f"{ladder}: {form}")
            for out_dtype in (torch.float32, torch.bfloat16):
                got = ops.qdq_cast(x, 0, ladder, out_dtype=out_dtype)
                want = qc.qdq_cast_ref(x, 0, ladder, out_dtype=out_dtype)
                check(same(got, want), f"qdq_cast vision leaf "
                      f"{tuple(x.shape)} {ladder} {out_dtype}")
                err = max(err, abs_err(got, want))
    bf = torch.bfloat16
    run = lambda: [ops.qdq_cast(x, 0, "gpu", out_dtype=bf)  # noqa: E731
                   for x in xs]
    ms, dms = time_ms(run, iters=5), device_ms(run, iters=5)
    plain_ms = time_ms(lambda: [qc.qdq_cast_ref(x, 0, "gpu", out_dtype=bf)
                                for x in xs], iters=2, reps=3)
    elems = sum(x.numel() for x in xs)
    b_ms, by = bound(6.0 * elems, 6.0 * elems, bw, ops_rate)
    log(f"qdq_cast at the vision leaves ({len(xs)} leaves, {elems} "
        f"weights; ResNet-18 and EfficientNet-B0): both forms bitwise the "
        f"plain version; one-pass, f32 in, bf16 out: {ms:.4f} ms by events "
        f"(device {dms:.4f}), plain {plain_ms:.4f}, bound {b_ms:.5f} ({by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "device_ms": dms}


def check_decode_chunk(dev, bw, tc_rate) -> dict:
    """flash_decode at the chunk path's shape: B 1, one live row of ragged
    length (1 to the cache's), against caches of 128, 512 and 2048 slots
    (phases 11b, 11a and 5b), 9/3 heads of 64, f32 and bf16, within
    ``tolerance``; a bitwise repeat; timed at B 1 against the 128-slot
    bf16 cache with 65 live slots (a prompt token of 11b's second chunk)
    beside the plain version, SDPA with a length mask and the byte bound.
    -> the ``kernels`` line's row ``flash_decode@chunked_prefill``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(9)
    H, K, D = 9, 3, 64
    err, n = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for L in (128, 512, 2048):
            for length in (1, 2, 15, 16, 17, 65, 100, 128, L - 1, L):
                q, k, v = _decode_inputs(1, L, H, K, D, D, dtype, dev, gen)
                lens = torch.tensor([length], dtype=torch.int32, device=dev)
                got = ops.flash_decode(q, k, v, lens)
                err = max(err, close(got, fa.flash_decode_ref(q, k, v, lens),
                                     f"decode B1 L{L} length {length} "
                                     f"{dtype}"))
                check(same(got, ops.flash_decode(q, k, v, lens)),
                      f"decode B1 L{L} length {length}: a bitwise repeat")
                n += 1
    L, length = SLO_CACHE, 65
    q, k, v = _decode_inputs(1, L, H, K, D, D, torch.bfloat16, dev, gen)
    lens = torch.tensor([length], dtype=torch.int32, device=dev)
    fn = lambda: ops.flash_decode(q, k, v, lens)  # noqa: E731
    ms, dms = time_ms(fn, iters=50), device_ms(fn)
    plain_ms = time_ms(lambda: fa.flash_decode_ref(q, k, v, lens), iters=10)
    mask = (torch.arange(L, device=dev)[None, :] < lens[:, None]
            ).reshape(1, 1, 1, L)
    lib_ms = time_ms(lambda: _sdpa(q, k, v, attn_mask=mask), iters=50)
    nbytes = 2 * (2 * H * D + 2 * length * K * D) + 4
    b_ms, by = bound(nbytes, length * H * 4 * D, bw, tc_rate)
    log(f"flash_decode at the chunk path's shape: {n} variants (B 1, caches "
        f"128/512/2048, ragged lengths) within tolerance (max|err| "
        f"{err:.3g}); B1 L{L} {length} live, bf16: kernel {ms:.5f} ms "
        f"(device {dms:.5f}), plain {plain_ms:.4f}, sdpa {lib_ms:.4f}, "
        f"bound {b_ms:.6f} ({by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
            "device_ms": dms}


#: the checks that run in a process of their own (``in_child``)
# ------------------------------ phase 12: the dense GQA architectures ---
#: phase 12's models: the training sequence, the serving prompt and cache,
#: and the prompt of the card-vs-CPU check at the cut depth (gemma3-4b:
#: past its 1024-token window, so the local layers mask keys there)
DENSE = {
    "stablelm-1.6b": dict(seq=1024, prompt=1024, total=2048,
                          cpu_prompt=1024),
    "minitron-4b": dict(seq=1024, prompt=1024, total=2048, cpu_prompt=1024),
    "gemma3-4b": dict(seq=2048, prompt=2048, total=4096, cpu_prompt=1280),
}
#: the card-vs-CPU check's cache: full length past every prompt above
DENSE_CPU_TOTAL = 2048
#: training: launcher steps, rungs and the rung controllers' memory cap
#: (the card's 80 GB, for serving too; the default of 16 GB is below each
#: of these models' weights)
DENSE_STEPS, DENSE_RUNGS, DENSE_MEM_CAP_GB = 10, "1,2", 80
#: serving: requests of this many tokens, four up front and two later
DENSE_REQUESTS, DENSE_TOKENS = 6, 32
#: phase 12 trains and serves the three models cut in depth, so the script
#: keeps inside its clock on a slow host: stablelm-1.6b at 6 of its 24
#: layers, minitron-4b at 4 of 32, gemma3-4b at one period of 5 local + 1
#: global and its 4 local, 10 of 34 (with all three at full depth and no
#: phase 14 the script took 740.7-971.2 s on an H100 80GB HBM3); their
#: full-depth numbers are in PERF.md section 6
DENSE_DEPTH = {"stablelm-1.6b": 6, "minitron-4b": 4, "gemma3-4b": 1}
#: the kernels' launches that phase 12 reports per model (its rows)
DENSE_ROWS = ("flash_attention", "flash_attention_bwd_delta",
              "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
              "flash_decode", "fused_stats", "fused_apply", "qdq_cast")


def _dense_depth(cfg, arch: str):
    """The config phase 12 trains and serves: ``cfg`` with its first
    segment repeated ``DENSE_DEPTH[arch]`` times (the full config for the
    others)."""
    n = DENSE_DEPTH.get(arch)
    if n is None:
        return cfg
    (first, _), *rest = cfg.stack.segments
    return dataclasses.replace(cfg, stack=dataclasses.replace(
        cfg.stack, segments=((first, n), *rest)))


@contextlib.contextmanager
def _registry_config(arch: str, cfg):
    """``registry.get_model_config(arch)`` gives ``cfg`` inside, so the
    launcher's own code trains the cut model."""
    from repro_torch.models import registry
    orig = registry.get_model_config

    def get(a, reduced=False):
        return cfg if a == arch and not reduced else orig(a, reduced)
    registry.get_model_config = get
    try:
        yield
    finally:
        registry.get_model_config = orig


def _dense_cut(cfg, arch: str):
    """The card-vs-CPU depth: 2 layers; gemma3-4b one period of its
    pattern (5 local layers and 1 global), recurrentgemma-2b one period of
    its (RG-LRU, RG-LRU, local MQA)."""
    seg = cfg.stack.segments[0]
    n = 1 if arch in ("gemma3-4b", "recurrentgemma-2b") else 2
    return dataclasses.replace(cfg, stack=dataclasses.replace(
        cfg.stack, segments=((seg[0], n),)))


def _dense_cut_params(params, n: int):
    """The first ``n`` stacked layers of segment 0 of a params tree, with
    the embedding, final norm and readout."""
    from repro_torch import tree as tu
    out = {k: v for k, v in params.items() if k != "stack"}
    out["stack"] = {"seg0": tu.tree_map(lambda x: x[:n],
                                        params["stack"]["seg0"])}
    return out


def _pairs(B, H, S, window=0) -> float:
    """(query, key) pairs of causal attention over S positions, each query
    reading at most ``window`` keys (0: all before it)."""
    w = window or S
    return B * H * (w * (w + 1) / 2 + (S - w) * w)


def _n_attn(cfg, kind=("gqa", "mla"), windowed=None) -> int:
    """A config's layers of the given block kinds (attention by default;
    ``windowed`` True / False: only GQA layers with / without a window)."""
    return sum(n * sum(1 for bd in defs if bd.kind in kind and (
        windowed is None or bool(bd.window) == windowed))
        for defs, n in cfg.stack.segments)


def _attn_dims(cfg):
    """(heads, kv heads, q/k head dim, v head dim) of a model's attention:
    GQA's, or MLA's split head dims (nope + rope for q and k, its own for
    v; k carries every head)."""
    m = cfg.stack.mla
    if m is not None:
        return (m.num_heads, m.num_heads, m.qk_nope_dim + m.qk_rope_dim,
                m.v_head_dim)
    a = cfg.stack.attn
    return a.num_heads, a.num_kv_heads, a.head_dim, a.head_dim


def _dense_attention(cfg, spec, dev, bw, tc_rate) -> dict:
    """The flash forward and its three backward kernels against their
    plain versions at the model's training shape (B 2, its S, its heads
    and head dims, causal, bf16; gemma3-4b's local layers' window too),
    timed beside the plain versions, SDPA and the bounds. The global
    shape's numbers fill the rows; the window's are logged and kept as
    ``window_<w>_ms``."""
    from repro_torch.kernels import flash_attention as fa
    B, S = 2, spec["seq"]
    H, K, D, Dv = _attn_dims(cfg)
    windows = sorted({bd.window for defs, _ in cfg.stack.segments
                      for bd in defs if bd.kind in ("gqa", "mla")})
    gen = torch.Generator(device=dev).manual_seed(17)
    out = {}
    for w in windows:
        kw = dict(causal=True, window=w)
        q, k, v, do, o, lse = _bwd_inputs(B, S, H, K, D, Dv, torch.bfloat16,
                                          dev, gen, **kw)
        o = o.contiguous()           # as the forward kernel writes it
        dims = f"D{D}" if D == Dv else f"D{D} Dv{Dv}"
        what = f"{cfg.name} attention B{B} S{S} {H}/{K} {dims} window {w}"
        err_f = _flash_pair(q, k, v, None, kw, what, "tc")
        route, errs = _bwd_pair(q, k, v, do, o, lse, None, kw, what)
        check(route == "tc", f"{what}: dQ and dK/dV on the tensor cores")
        delta = fa.flash_bwd_delta_ref(o, do)
        pairs = _pairs(B, H, S, w)
        # bytes of q (and dq), o (and do), k (and dk), v (and dv), lse
        nq, no, nk, nv = (B * S * n * d * 2 for n, d in ((H, D), (H, Dv),
                                                         (K, D), (K, Dv)))
        nl = B * H * S * 4
        mask = None
        if w:
            i = torch.arange(S, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < w)
        sdpa_kw = dict(attn_mask=mask) if w else dict(is_causal=True)
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        o_lib = _sdpa(qg, kg, vg, **sdpa_kw)
        do_t = do.transpose(1, 2)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            o_lib, (qg, kg, vg), do_t, retain_graph=True), iters=5, reps=3)
        t = {
            "fwd": (time_ms(lambda: fa.flash_attention_cuda(
                q, k, v, with_lse=True, **kw), iters=10, reps=3),
                time_ms(lambda: fa.flash_attention_ref(
                    q, k, v, with_lse=True, **kw), iters=2, reps=2),
                time_ms(lambda: _sdpa(q, k, v, **sdpa_kw), iters=10,
                        reps=3),
                bound(nq + no + nk + nv + nl, pairs * 2 * (D + Dv), bw,
                      tc_rate)),
            "dq": (time_ms(lambda: fa.flash_bwd_dq_cuda(
                q, k, v, do, lse, delta, **kw), iters=10, reps=3),
                time_ms(lambda: fa.flash_bwd_dq_ref(
                    q, k, v, do, lse, delta, **kw), iters=2, reps=2),
                lib_bwd,
                bound(2 * nq + no + nk + nv + 2 * nl,
                      pairs * 2 * (2 * D + Dv), bw, tc_rate)),
            "dkv": (time_ms(lambda: fa.flash_bwd_dkv_cuda(
                q, k, v, do, lse, delta, **kw), iters=10, reps=3),
                time_ms(lambda: fa.flash_bwd_dkv_ref(
                    q, k, v, do, lse, delta, **kw), iters=2, reps=2),
                lib_bwd,
                bound(nq + no + 2 * (nk + nv) + 2 * nl,
                      pairs * 4 * (D + Dv), bw, tc_rate)),
            "delta": (time_ms(lambda: fa.flash_bwd_delta_cuda(o, do),
                              iters=20, reps=3),
                      time_ms(lambda: fa.flash_bwd_delta_ref(o, do), iters=5,
                              reps=2),
                      lib_bwd,
                      bound(2 * no + nl, B * S * H * Dv * 2, bw, tc_rate)),
        }
        log(f"  {what}: " + "; ".join(
            f"{n} kernel {ms:.4f} ms, plain {pl:.4f}, "
            f"{'sdpa backward' if n != 'fwd' else 'sdpa'} {lib:.4f}, bound "
            f"{bd[0]:.4f} ({bd[1]})" for n, (ms, pl, lib, bd) in t.items())
            + f"; max|err| fwd {err_f:.3g}, delta {errs['delta']:.3g}, dq "
            f"{errs['dq']:.3g}, dkv {errs['dkv']:.3g}")
        for n, key, err in (("fwd", "flash_attention", err_f),
                            ("delta", "flash_attention_bwd_delta",
                             errs["delta"]),
                            ("dq", "flash_attention_bwd_dq", errs["dq"]),
                            ("dkv", "flash_attention_bwd_dkv", errs["dkv"])):
            ms, pl, lib, (b_ms, by) = t[n]
            row = {"max_abs_err": err, "ms": ms, "plain_ms": pl,
                   "bound_ms": b_ms, "bound_by": by, "library_ms": lib}
            if key in out:             # the global shape fills the row
                old = out[key]
                old["max_abs_err"] = max(old["max_abs_err"], err)
                old[f"window_{w}_ms"] = ms
                continue
            out[key] = row
        del q, k, v, do, o, lse, delta, qg, kg, vg, o_lib
    return out


def _dense_decode(cfg, spec, dev, bw, tc_rate) -> dict:
    """flash_decode against its plain version at the serving decode's shape
    (B 4 rows against the model's full-length cache, live lengths past the
    prompt), timed beside the plain version, SDPA with a length mask and
    the byte bound. For gemma3-4b also the local layers' decode attention
    (``nn.attention._naive_attention`` on their 1024-slot ring) timed by
    the profiler, one layer's device time."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.nn.attention import _naive_attention
    a = cfg.stack.attn
    B, L, H, K, D = 4, spec["total"], a.num_heads, a.num_kv_heads, a.head_dim
    P = spec["prompt"]
    gen = torch.Generator(device=dev).manual_seed(18)
    q, k, v = _decode_inputs(B, L, H, K, D, D, torch.bfloat16, dev, gen)
    lens = torch.tensor([P + 31, P + 20, P + 5, P], dtype=torch.int32,
                        device=dev)
    got = ops.flash_decode(q, k, v, lens)
    want = fa.flash_decode_ref(q, k, v, lens)
    what = f"{cfg.name} decode B{B} L{L} {H}/{K} D{D}"
    err = close(got, want, what)
    check(same(got, ops.flash_decode(q, k, v, lens)), f"{what}: bitwise "
          "repeat")
    ms = time_ms(lambda: fa.flash_decode_cuda(q, k, v, lens), iters=50)
    dev_ms = device_ms(lambda: fa.flash_decode_cuda(q, k, v, lens))
    plain_ms = time_ms(lambda: fa.flash_decode_ref(q, k, v, lens), iters=5)
    mask = (torch.arange(L, device=dev)[None, :] < lens[:, None]
            ).reshape(B, 1, 1, L)
    lib_ms = time_ms(lambda: _sdpa(q, k, v, attn_mask=mask), iters=50)
    lib_dev_ms = device_ms(lambda: _sdpa(q, k, v, attn_mask=mask))
    live = int(lens.sum())
    b_ms, by = bound(2 * (2 * B * H * D + 2 * live * K * D) + 4 * B,
                     live * H * 4 * D, bw, tc_rate)
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
           "device_ms": dev_ms, "library_device_ms": lib_dev_ms}
    msg = (f"  {what}, live {lens.tolist()}: kernel {ms:.5f} ms (device "
           f"{dev_ms:.5f}), plain {plain_ms:.4f}, sdpa {lib_ms:.4f} (device "
           f"{lib_dev_ms:.5f}), bound {b_ms:.5f} ({by}), max|err| {err:.3g}")
    wins = [bd.window for defs, _ in cfg.stack.segments for bd in defs
            if bd.window]
    if wins:
        w = wins[0]
        ring_k, ring_v = (x[:, :w].contiguous() for x in (k, v))
        cpos = (P + torch.arange(w, device=dev, dtype=torch.int32))[
            None].expand(B, w).contiguous()
        qpos = (P + w - 1) * torch.ones((B, 1), dtype=torch.int32,
                                        device=dev)
        local = lambda: _naive_attention(  # noqa: E731
            q, ring_k, ring_v, qpos, cpos, True, w, a.scale)
        row["local_layer_device_ms"] = device_ms(local)
        msg += (f"; a local layer's decode attention (plain, {w}-slot ring) "
                f"device {row['local_layer_device_ms']:.5f} ms")
    log(msg)
    return row


def _dense_qdq(params, dev, bw, ops_rate) -> dict:
    """The tier-0 cast (two-pass form, f32 in, bf16 out) on the model's
    largest leaf against its plain version, bitwise (past 2^31 bytes in
    f32 for minitron-4b's and gemma3-4b's readouts: 64-bit offsets),
    timed beside the plain version and the byte bound."""
    from repro_torch import tree as tu
    from repro_torch.kernels import ops
    from repro_torch.kernels import qdq_cast as qc
    x = max(tu.leaves(params), key=lambda t: t.numel())
    bf = torch.bfloat16
    got = ops.qdq_cast(x, 0, "tpu", out_dtype=bf)
    want = qc.qdq_cast_ref(x, 0, "tpu", None, out_dtype=bf)
    torch.cuda.synchronize()
    what = f"qdq_cast two-pass on a {tuple(x.shape)} leaf ({x.numel()} " \
        f"elements, {x.numel() * 4} bytes f32)"
    check(got.dtype == bf and same(got, want), what)
    del want
    ms = time_ms(lambda: ops.qdq_cast(x, 0, "tpu", out_dtype=bf), iters=5,
                 reps=3)
    plain_ms = time_ms(lambda: qc.qdq_cast_ref(x, 0, "tpu", None,
                                               out_dtype=bf), iters=1,
                       reps=2)
    b_ms, by = bound(x.numel() * 6, x.numel() * 4, bw, ops_rate)
    log(f"  {what}: bitwise; kernel {ms:.4f} ms, plain {plain_ms:.4f}, "
        f"bound {b_ms:.4f} ({by})")
    return {"max_abs_err": abs_err(got, ops.qdq_cast(x, 0, "tpu",
                                                     out_dtype=bf)),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": by, "library_ms": None}


def _dense_fused(view, dev, bw, f32_ops, what, chunk_rows=1 << 18) -> dict:
    """fused_stats and fused_apply on the model's whole training slab (the
    LM path's variant: sgdm, gpu ladder, bf16 gradient and copy) against
    their plain versions, which run ``chunk_rows`` rows at a time (at
    1.6-4.2 B elements their f32 temporaries would not fit the card
    whole; each row is independent, and the per-layer results combine by
    sum and max). The inputs are drawn chunk by chunk from seeds, so the
    plain versions draw them again after the kernel has updated the slabs
    in place (``donate``, as the trainer's loop runs it). fused_stats:
    absmax and the non-finite count bitwise; the sums and the sums of
    squares held to f64 sums within the kernel's longest chain of f32
    additions times 2^-24 of the sum of |terms| (at 4 B elements the
    squares of kernel and plain version no longer agree to rtol 1e-5).
    fused_apply: master, momentum, copy and the per-layer absmax
    bitwise."""
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import ops
    var = lm_train_variant()
    rows, L = view.rows, view.num_layers
    rl = view.row_blocks(dev)
    T = rl.shape[1]
    chunks = [slice(r, min(r + chunk_rows, rows))
              for r in range(0, rows, chunk_rows)]
    tiles = [slice(c.start // T, c.stop // T) for c in chunks]
    gen = torch.Generator(device=dev)

    def draw(i):
        n = chunks[i].stop - chunks[i].start
        gen.manual_seed(1000 + i)
        g = (torch.randn((n, 512), generator=gen, device=dev) * 1e-3
             ).to(var["g_dtype"])
        p = torch.randn((n, 512), generator=gen, device=dev) * 0.05
        m = torch.randn((n, 512), generator=gen, device=dev) * 1e-3
        return g, p, m

    g = torch.empty((rows, 512), dtype=var["g_dtype"], device=dev)
    p = torch.empty((rows, 512), device=dev)
    m = torch.empty((rows, 512), device=dev)
    for i, sl in enumerate(chunks):
        g[sl], p[sl], m[sl] = draw(i)
    g[5, 7], g[rows // 2, 0], g[rows - 1, 511] = (float("inf"),
                                                  -float("inf"),
                                                  float("nan"))
    bad = [(5, 7), (rows // 2, 0), (rows - 1, 511)]
    # fused_stats, the kernel on the whole slab, the plain version by chunk
    got = ops.fused_stats(g, rl, L)
    acc = None
    truth = torch.zeros(L, dtype=torch.float64, device=dev)
    mass = torch.zeros(L, dtype=torch.float64, device=dev)
    squares = torch.zeros(L, dtype=torch.float64, device=dev)
    for sl, ts in zip(chunks, tiles):
        part = fu.fused_stats_ref(g[sl], rl[ts], L)
        acc = part if acc is None else (
            acc[0] + part[0], acc[1] + part[1],
            torch.maximum(acc[2], part[2]), acc[3] + part[3])
        fin = torch.where(torch.isfinite(g[sl]), g[sl], 0).double()
        ids = rl[ts].reshape(-1).long()
        truth.index_add_(0, ids, fin.sum(dim=1))
        mass.index_add_(0, ids, fin.abs().sum(dim=1))
        squares.index_add_(0, ids, (fin * fin).sum(dim=1))
        del fin
    torch.cuda.synchronize()
    check(same(got[2], acc[2]) and same(got[3], acc[3]),
          f"fused_stats ({what}) absmax and non-finite count")
    check(float(got[3].sum()) == 3.0, "fused_stats counts 3 non-finite")
    # f32 sums of up to 4.2 B terms: each held to the f64 sum of the same
    # finite lanes within the longest chain of f32 additions the kernel
    # makes for one layer (16 a lane, 5 a warp, 32 rows a block, a 256-
    # thread pass over the blocks, 8 in its tree; one more for the square)
    # times 2^-24 of the sum of |terms|; the plain version's chains (torch's
    # reduction by chunk, then the chunks in turn) are shorter
    chain = 16 + 5 + 32 + -(-(rows // fu._lib().tri_rows_per_block())
                           // 256) + 8 + 1
    rel = {}
    for who, i, want_, scale in (("kernel", 0, truth, mass),
                                 ("plain", 0, truth, mass),
                                 ("kernel", 1, squares, squares),
                                 ("plain", 1, squares, squares)):
        val = (got if who == "kernel" else acc)[i].double()
        off = (val - want_).abs()
        rel[(who, i)] = float((off / scale.clamp_min(1e-300)).max())
        check(bool((off <= chain * 2.0 ** -24 * scale).all()),
              f"fused_stats ({what}) {('sum', 'sum_sq')[i]} ({who}) off "
              f"the f64 sum by {rel[(who, i)]:.3g} of the sum of |terms| "
              f"(bound {chain} x 2^-24)")
    err_s = max(abs_err(a_, b_) for a_, b_ in zip(got, acc))
    s_ms = time_ms(lambda: ops.fused_stats(g, rl, L), iters=10, reps=3)
    def stats_plain():            # chunk by chunk, nothing kept
        for sl, ts in zip(chunks, tiles):
            fu.fused_stats_ref(g[sl], rl[ts], L)

    s_plain = time_ms(stats_plain, iters=1, reps=2)
    s_bound = bound(rows * 512 * g.element_size() + rows * 4 + 16 * L,
                    rows * 512 * 8, bw, f32_ops)
    for r, c in bad:
        g[r, c] = 0.0
    # fused_apply, donated, against the plain version by chunk
    gen2 = torch.Generator(device=dev).manual_seed(5)
    lr = torch.full(rl.shape, 1e-2, device=dev)
    code = torch.randint(0, 3, rl.shape, generator=gen2, device=dev,
                         dtype=torch.int32)
    qs = 448.0 / (1.0 + 7.0 * torch.rand(rl.shape, generator=gen2,
                                         device=dev))
    scal = torch.tensor([0.5, 1.0, 1.0, 1.0, 7.0], device=dev)
    kw = dict(spec=var["spec"], ladder=var["ladder"],
              cp_dtype=var["cp_dtype"], num_layers=L, sr=var["sr"])
    cp = torch.empty((rows, 512), dtype=var["cp_dtype"], device=dev)
    outs = ops.fused_apply(g, p, m, None, scal, rl, lr, code, qs,
                           cp_out=cp, donate=True, **kw)
    torch.cuda.synchronize()
    check(outs[0] is p and outs[1] is m and outs[3] is cp,
          "fused_apply(donate=True) writes over its inputs")
    pmax = torch.zeros(L, device=dev)
    err_a = 0.0
    for i, (sl, ts) in enumerate(zip(chunks, tiles)):
        gi, pi, mi = draw(i)
        for r, c in bad:
            if sl.start <= r < sl.stop:
                gi[r - sl.start, c] = 0.0
        want = fu.fused_apply_ref(gi, pi, mi, None, scal, rl[ts], lr[ts],
                                  code[ts], qs[ts], **kw)
        for n, a_, b_ in zip(("p", "m", "cp"), (p[sl], m[sl], cp[sl]),
                             (want[0], want[1], want[3])):
            check(same(a_, b_), f"fused_apply ({what}) {n} rows "
                  f"{sl.start}-{sl.stop}")
            err_a = max(err_a, abs_err(a_, b_))
        pmax = torch.maximum(pmax, want[4])
    check(same(outs[4], pmax), f"fused_apply ({what}) per-layer absmax")
    a_ms = time_ms(lambda: ops.fused_apply(g, p, m, None, scal, rl, lr, code,
                                           qs, cp_out=cp, donate=True, **kw),
                   iters=5, reps=3)
    def apply_plain():            # chunk by chunk, nothing kept
        for sl, ts in zip(chunks, tiles):
            fu.fused_apply_ref(g[sl], p[sl], m[sl], None, scal, rl[ts],
                               lr[ts], code[ts], qs[ts], **kw)

    a_plain = time_ms(apply_plain, iters=1, reps=2)
    elems = rows * 512
    a_bound = bound(elems * (g.element_size() + 16 + cp.element_size())
                    + 16 * rows + 20 + 4 * L, elems * 16, bw, f32_ops)
    log(f"  fused_stats / fused_apply ({what}) {rows}x512 ({elems} "
        f"elements) bf16 gradient, L={L}: stats kernel {s_ms:.4f} ms, plain "
        f"by {len(chunks)} chunks {s_plain:.4f}, bound {s_bound[0]:.4f} "
        f"({s_bound[1]}); apply (donated) kernel {a_ms:.4f} ms, plain "
        f"{a_plain:.4f}, bound {a_bound[0]:.4f} ({a_bound[1]}); apply "
        f"bitwise; sums off the f64 sums by kernel {rel[('kernel', 0)]:.3g}"
        f" / plain {rel[('plain', 0)]:.3g} of sum|g|, squares by "
        f"{rel[('kernel', 1)]:.3g} / {rel[('plain', 1)]:.3g} (bound "
        f"{chain} x 2^-24 = {chain * 2.0 ** -24:.3g})")
    return {"fused_stats": {"max_abs_err": err_s, "ms": s_ms,
                            "plain_ms": s_plain, "bound_ms": s_bound[0],
                            "bound_by": s_bound[1], "library_ms": None},
            "fused_apply": {"max_abs_err": err_a, "ms": a_ms,
                            "plain_ms": a_plain, "bound_ms": a_bound[0],
                            "bound_by": a_bound[1], "library_ms": None}}


def _timed_init(records: list):
    """Record the seconds of each ``LMTask.init`` call made inside the
    context (the seeded draw on the host and the copy to the card)."""
    from repro_torch.train.task import LMTask
    orig = LMTask.init

    def init(self, gen, device=None):
        t0 = time.perf_counter()
        out = orig(self, gen, device)
        if torch.device(self.device if device is None
                        else device).type == "cuda":
            torch.cuda.synchronize()
        records.append(time.perf_counter() - t0)
        return out

    @contextlib.contextmanager
    def ctx():
        LMTask.init = init
        try:
            yield
        finally:
            LMTask.init = orig
    return ctx()


def dense_train(arch: str, spec: dict, device="cuda"):
    """Train ``arch`` at full width through the launcher (at the depth the
    registry gives, which phases 12-14 cut with ``_registry_config``):
    ``launch.train.main(--arch arch --seq S --rungs R --steps 10
    --ladder gpu --mem-cap-gb 80)``, R ``spec["rungs"]`` (default 1,2).
    Launches exact, A the model's attention layers (all L of a dense
    model, none of mamba2's): the forward 2 x A a step on the tensor-core
    route (forward and remat recompute), delta, dQ and dK/dV A a step (dQ
    and dK/dV on the tensor cores), one fused_stats and fused_apply a
    step; no fallback, no OOM, finite losses.
    -> (trainer, launches, seconds of ``task.init``, wall seconds)."""
    import io
    import warnings
    from repro_torch import tree as tu
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    args = ["--arch", arch, "--seq", str(spec["seq"]), "--rungs",
            spec.get("rungs", DENSE_RUNGS), "--steps", str(DENSE_STEPS),
            "--ladder", "gpu",
            "--mem-cap-gb", str(DENSE_MEM_CAP_GB), "--device", device]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    ops.WARNED_FALLBACKS.clear()
    printed, inits = io.StringIO(), []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed), signals_kept(), \
                _timed_init(inits):
            tr = launch_train.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    L, steps = tr.task.cfg.num_layers, DENSE_STEPS
    A = _n_attn(tr.task.cfg)
    fallbacks = [str(w.message) for w in caught
                 if "kernel gate failed" in str(w.message)]
    check(not fallbacks and not ops.WARNED_FALLBACKS,
          f"{arch}: fallback warnings on the training path: {fallbacks}")
    check(not tr.oom_events, f"{arch}: OOM events {tr.oom_events}")
    check(int(tr.state.control.step) == steps, f"{arch}: all steps taken")
    lines = [json.loads(x) for x in printed.getvalue().splitlines()]
    check(lines and all(math.isfinite(m_["loss"]) for m_ in lines),
          f"{arch}: losses {lines}")
    want = {"flash_attention": 2 * A * steps,
            "flash_attention_tc": 2 * A * steps,
            "flash_attention_bwd_delta": A * steps,
            "flash_attention_bwd_dq": A * steps,
            "flash_attention_bwd_dq_tc": A * steps,
            "flash_attention_bwd_dkv": A * steps,
            "flash_attention_bwd_dkv_tc": A * steps,
            "fused_stats": steps, "fused_apply": steps}
    for k, n in want.items():
        check(launches[k] == n, f"{arch}: {k}: {launches[k]} launches, "
              f"expected {n}")
    var = lm_train_variant()
    check(tr.opt.spec == var["spec"] and tr.tac.ladder == var["ladder"]
          and not tr.tac.stochastic_round
          and tr.state.compute["slab"].dtype == var["g_dtype"],
          f"{arch}: the fused update variant the kernels were checked on")
    n = sum(int(x.numel()) for x in tu.leaves(tr._params_like))
    log(f"{arch} training: launch.train.main({' '.join(args)}): {steps} "
        f"steps in {wall:.2f} s; task.init {inits[0]:.2f} s ({n} "
        f"parameters, seeded on the host, copied to the card), "
        f"{L} layers ({A} with attention), slab {tr.view.rows} x 512; "
        f"peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; measured peak "
        f"bytes per rung { {k: int(v) for k, v in tr.measured_bytes.items()} }"
        f", rung history {tr.scaler.history}")
    log(f"  logged loss {[round(m_['loss'], 4) for m_ in lines]}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return tr, launches, inits[0], wall


def dense_serve(arch: str, spec: dict, params, device="cuda",
                tiers=(0, 1)) -> dict:
    """``ServeSession(params=...)`` over the given weights at full width
    and depth: prompt and cache from ``spec``, rungs 1/2/4, ``tiers`` (tiers
    1 then 0, tier 0 pinned after 8 decode steps; tpu ladder: the tier-0
    set two-pass), ``DENSE_REQUESTS`` requests of ``DENSE_TOKENS`` tokens,
    four up front and the rest after three steps. Launches exact: the flash
    forward A a prefill on the tensor-core route (A the attention layers:
    L of a dense model, none of mamba2's), flash_decode once a decode step
    for each GQA layer whose cache the decode kernel takes (unwindowed;
    gemma3-4b's 5 global layers, its 29 local ones on the plain path; none
    for MLA, whose decode is the absorbed form, nor for recurrentgemma's
    local layers), a two-pass qdq_cast a leaf of a tier-0 set; no
    fallback. Then three decode steps profiled."""
    import warnings
    from repro_torch import tree as tu
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_task
    from repro_torch.serve import ServeConfig, ServeSession
    task = get_task(arch, device=device)
    L, vocab = task.cfg.num_layers, task.cfg.vocab_size
    A = _n_attn(task.cfg)
    n_flash = _n_attn(task.cfg, ("gqa",), windowed=False)
    n_mla = _n_attn(task.cfg, ("mla",))
    n_local = _n_attn(task.cfg, ("gqa",), windowed=True)
    n_rec = _n_attn(task.cfg, ("ssd", "rglru"))
    n_leaves = len(tu.leaves(params))
    cfg = ServeConfig(prompt_len=spec["prompt"], total_len=spec["total"],
                      rungs=(1, 2, 4), tiers=tuple(tiers), ladder="tpu",
                      max_new_tokens=DENSE_TOKENS, schedule="fifo", seed=0,
                      mem_cap_bytes=DENSE_MEM_CAP_GB * 1e9)
    prompts = np.random.default_rng(12).integers(
        0, vocab, (DENSE_REQUESTS, cfg.prompt_len))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    ops.WARNED_FALLBACKS.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        sess = ServeSession(task, cfg, params=params, device=device)
        del params
        t1 = time.perf_counter()
        sess.warm()
        warm_runs = dict(sess.engine.runs)
        t2 = time.perf_counter()
        for p in prompts[:4]:
            sess.submit({"tokens": p})
        for _ in range(3):
            sess.step()
        for p in prompts[4:]:
            sess.submit({"tokens": p})
        if len(cfg.tiers) > 1:
            while sess.engine.runs["decode"] - warm_runs["decode"] < 8:
                sess.step()
            sess.set_tier(0)
        stats = sess.run()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t2
    launches = dict(ops.LAUNCHES)
    runs = dict(sess.engine.runs)
    fallbacks = [str(w.message) for w in caught
                 if "kernel gate failed" in str(w.message)]
    check(not fallbacks and not ops.WARNED_FALLBACKS,
          f"{arch}: fallback warnings on the serving path: {fallbacks}")
    reqs = sess.results()
    check(len(reqs) == DENSE_REQUESTS and all(
        r.status == "done" and len(r.tokens) == DENSE_TOKENS
        and all(0 <= t < vocab for t in r.tokens) for r in reqs.values()),
        f"{arch}: every request done")
    check(launches["flash_attention"] == A * runs["admit"]
          == launches["flash_attention_tc"],
          f"{arch}: the flash forward {A} a prefill, tensor cores: "
          f"{launches} vs {runs}")
    check(launches["flash_decode"] == n_flash * runs["decode"],
          f"{arch}: flash_decode {n_flash} a decode step: {launches} vs "
          f"{runs}")
    n_cast = n_leaves if 0 in cfg.tiers else 0
    check(launches["qdq_cast"] == launches["qdq_cast_two_pass"] == n_cast,
          f"{arch}: {n_cast} two-pass qdq_casts, a leaf of a tier-0 set: "
          f"{launches}")
    check(any(t == 0 for _, t in stats["tier_history"]) == (0 in cfg.tiers),
          f"{arch}: tier 0 served where it is warmed")
    check(max(r for _, r in stats["rung_history"]) == 4,
          f"{arch}: rung reached 4")
    tokens = stats["decoded_tokens"]
    peak = torch.cuda.max_memory_allocated()
    lat = {f"{r}/{t}": round(float(np.median(sess.lat.samples(r, t))) * 1e3,
                             3)
           for r in cfg.rungs for t in cfg.tiers if sess.lat.samples(r, t)}
    log(f"{arch} serving, tiers {cfg.tiers}: {L} layers ({n_flash} on "
        f"flash_decode, {n_local} local on the plain decode attention, "
        f"{n_mla} MLA absorbed, {n_rec} recurrent), {DENSE_REQUESTS} "
        f"requests x "
        f"{DENSE_TOKENS} tokens, prompt {cfg.prompt_len}, cache "
        f"{cfg.total_len}: session {t1 - t0:.2f} s, warm {t2 - t1:.2f} s, "
        f"serving {serve_s:.3f} s, {tokens / serve_s:.1f} tok/s, TTFT p50 "
        f"{stats['ttft_s_p50'] * 1e3:.1f} ms p99 "
        f"{stats['ttft_s_p99'] * 1e3:.1f} ms, peak allocated "
        f"{peak / 1e9:.3f} GB")
    log(f"  median decode step ms by rung/tier {lat}; rung history "
        f"{stats['rung_history']}, tier history {stats['tier_history']}; "
        f"path runs {runs}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    # a decode step at rung 4, tier 0: where its device time goes
    rng = np.random.default_rng(13)
    for _ in range(4):
        sess.submit({"tokens": rng.integers(0, vocab, (cfg.prompt_len,))},
                    max_new_tokens=6)
    sess.step()
    sess.step()

    def run():
        for _ in range(3):
            sess.step()
    prof = _profile(run, 3, _serve_family,
                    f"{arch}: 3 decode steps at rung {sess.rung} tier "
                    f"{sess.tier}")
    sess.run()
    del sess
    return {"launches": launches, "runs": runs, "n_local": n_local,
            "decode_busy_ms": prof["busy_ms"], "decode_ops": prof["ops"],
            "tok_s": tokens / serve_s, "lat_ms": lat,
            "peak": peak, "session_s": t1 - t0}


def dense_against_cpu(arch: str, spec: dict, cut, steps: int = 4,
                      card="cuda"):
    """A prefill of ``cpu_prompt`` tokens and ``steps`` teacher-forced
    decode steps at full width and the cut depth (``cut``: the trained
    weights' first layers, bf16, on the host), on the card (kernels) and
    on the CPU (plain versions); logits within 4 % of their largest
    magnitude, as phase 4's smollm-135m check."""
    from repro_torch import tree as tu
    from repro_torch.models import lm
    from repro_torch.models.registry import get_model_config
    from repro_torch.serve.engine import scatter_prefill
    cfg = _dense_cut(get_model_config(arch), arch)
    prompt = spec["cpu_prompt"]
    total = spec.get("cpu_total", DENSE_CPU_TOTAL)
    g = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (1, prompt), generator=g,
                         dtype=torch.int32)
    feed = torch.randint(0, cfg.vocab_size, (steps, 1), generator=g,
                         dtype=torch.int32)
    out, secs = {}, {}
    for dev in ("cpu", card):
        t0 = time.perf_counter()
        p = tu.tree_map(lambda x: x.to(dev), cut)
        logits = []
        with torch.no_grad():
            lg, pre = lm.lm_prefill(p, {"tokens": toks.to(dev)}, cfg)
            logits.append(lg.float().cpu())
            caches = scatter_prefill(
                lm.lm_init_cache(cfg, 1, total, device=dev), pre, 0)
            for i in range(steps):
                lg, caches = lm.lm_decode_step(
                    p, feed[i].to(dev), caches,
                    torch.tensor([prompt + i], device=dev), cfg)
                logits.append(lg.float().cpu())
        out[dev] = torch.stack(logits)
        secs[dev] = time.perf_counter() - t0
        del p, caches, pre
    ref, got = out["cpu"], out[card]
    gap = float((got - ref).abs().max())
    lim = 0.04 * float(ref.abs().max())
    same_top = (got.argmax(-1) == ref.argmax(-1)).float().mean()
    log(f"{arch} x{cfg.num_layers} layers (the trained weights' first), "
        f"prefill {prompt} + {steps} decode steps, card vs CPU: "
        f"max|dlogit| {gap:.4g} (limit {lim:.4g}), same argmax "
        f"{float(same_top):.2f}; CPU {secs['cpu']:.1f} s, card "
        f"{secs[card]:.1f} s")
    check(bool(torch.isfinite(got).all()), f"{arch}: finite card logits")
    check(gap <= lim, f"{arch}: card vs CPU logits {gap} > {lim}")
    return {"gap": gap, "limit": lim, "same_argmax": float(same_top)}


def dense_phase(card: str, dev, bw, f32_ops, tc_ops) -> dict:
    """Phase 12: for each dense GQA architecture, its kernels against their
    plain versions at its shapes, training at full width (at the depth
    ``_dense_depth`` gives) through the launcher, the card-vs-CPU check at
    the cut depth on the trained weights, then serving the trained weights
    at full width and that depth (between the two, three more steps timed
    and one profiled).
    -> {arch: {"rows": {kernel: result}, "launches": {kernel: launches on
    the model's main paths}}}."""
    from repro_torch import tree as tu
    from repro_torch.kernels.layout import slab_view
    from repro_torch.models.registry import get_model_config
    from repro_torch.train.task import LMTask
    t_phase = time.perf_counter()
    log(f"phase 12 starts with {torch.cuda.memory_allocated() / 1e9:.3f} GB "
        "allocated on the card")
    out = {}
    for arch, spec in DENSE.items():
        t_model = time.perf_counter()
        cfg = get_model_config(arch)
        run_cfg = _dense_depth(cfg, arch)
        log(f"{arch}: kernels at its shapes ({card})")
        rows = _dense_attention(cfg, spec, dev, bw, tc_ops)
        rows["flash_decode"] = _dense_decode(cfg, spec, dev, bw, tc_ops)
        task = LMTask(run_cfg, device="cpu")
        like, _ = task.init(torch.Generator(), device="meta")
        rows.update(_dense_fused(slab_view(like, task.grouping(like)), dev,
                                 bw, f32_ops, arch))
        gc.collect()
        torch.cuda.empty_cache()
        with _registry_config(arch, run_cfg):
            tr, tl, init_s, train_s = dense_train(arch, spec)
        step_ms = []
        for _ in range(3):              # unprofiled steps at the top rung
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.run(1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        log(f"{arch}: a train step at rung {tr.scaler.microbatch}, S "
            f"{spec['seq']}: {statistics.median(step_ms):.1f} ms (median of "
            f"3: {[round(x, 1) for x in step_ms]})")
        profile_lm_step(tr)
        params = tr.params_tree()
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        n_cut = _dense_cut(cfg, arch).stack.segments[0][1]
        cut = tu.tree_map(lambda x: x.to(torch.bfloat16).cpu(),
                          _dense_cut_params(params, n_cut))
        rows["qdq_cast"] = _dense_qdq(params, dev, bw, f32_ops)
        with _registry_config(arch, run_cfg):
            sv = dense_serve(arch, spec, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        dense_against_cpu(arch, spec, cut)
        del cut
        launches = {k: tl.get(k, 0) for k in DENSE_ROWS}
        launches["flash_attention"] += sv["launches"]["flash_attention"]
        for k in ("flash_decode", "qdq_cast"):
            launches[k] = sv["launches"][k]
        loc = rows["flash_decode"].get("local_layer_device_ms")
        if loc is not None:
            share = sv["n_local"] * loc / sv["decode_busy_ms"]
            rows["flash_decode"]["local_layers_share"] = share
            log(f"{arch}: the {sv['n_local']} local layers' plain decode "
                f"attention, {loc:.5f} ms each at B 4: {share:.3f} of a "
                f"decode step's device time ({sv['decode_busy_ms']:.3f} ms "
                "busy, profiled at rung 4)")
        out[arch] = {"rows": rows, "launches": launches}
        log(f"{arch}: task.init {init_s:.1f} s, training {train_s:.1f} s, "
            f"the model's part of phase 12 "
            f"{time.perf_counter() - t_model:.1f} s ({card})")
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 12 in {time.perf_counter() - t_phase:.1f} s")
    return out


# ------------------------------ phase 13: MLA and MoE (deepseek-v2-lite) ---
MOE_ARCH = "deepseek-v2-lite-16b"
#: the training sequence, the serving prompt and cache, the card-vs-CPU
#: prompt
MOE = dict(seq=1024, prompt=1024, total=2048, cpu_prompt=1024)
#: training depth: the dense layer 0 and this many MoE layers (7, the most
#: whose peak at rung 2 fits the card, peaked at 64.5 GB; 8 ran out of
#: memory in its third step on an H100 80GB HBM3; PERF.md section 4); 1,
#: to keep the whole script inside its clock
MOE_TRAIN_MOE_LAYERS = 1
#: the fused update's check runs on the slab of the dense layer and this
#: many MoE layers, untrained: 8,973,568 x 512 = 4.59 G elements, past
#: 2^32 (every other model's slab is below it)
MOE_FUSED_MOE_LAYERS = 7
#: card vs CPU: a prompt, then teacher-forced decode steps, at layers 0
#: (dense FFN) and 1 (MoE); logits within this share of their largest
#: magnitude, as phases 4 and 12
MOE_CPU_STEPS, MOE_CPU_TOL = 4, 0.04
#: the kernels' launches phase 13 reports (flash_decode has none: MLA
#: decodes in the absorbed form)
MOE_ROWS = ("flash_attention", "flash_attention_bwd_delta",
            "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
            "fused_stats", "fused_apply", "qdq_cast")


def _moe_cut(cfg, moe_layers: int):
    """``cfg`` with its MoE segment cut to ``moe_layers`` layers (the dense
    layer 0 kept): the launcher has no depth flag, so the depth is cut in
    the config, as ``_dense_cut`` does."""
    (dense, n0), (moe, _) = cfg.stack.segments
    return dataclasses.replace(cfg, stack=dataclasses.replace(
        cfg.stack, segments=((dense, n0), (moe, moe_layers))))


def _moe_qdq(x_host, dev, bw, ops_rate) -> dict:
    """The two-pass tier-0 cast (tpu ladder, f32 in, bf16 out) of one
    stacked expert leaf of the serving set, (26, 64, 2048, 1408): 4.8 G
    elements, past 2^32, bitwise against the plain version, which runs
    layer by layer under the leaf's one absmax (whole, its f32 temporaries
    would not fit the card beside the leaf), and a repeat bitwise (both
    compared layer by layer); timed beside the plain version and the byte
    bound."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import qdq_cast as qc
    bf = torch.bfloat16
    x = x_host.to(dev)
    n = x.numel()
    got = ops.qdq_cast(x, 0, "tpu", out_dtype=bf)
    amax = torch.stack([t.abs().amax() for t in x]).amax()

    def plain(out=None):
        for i, t in enumerate(x):
            r = qc.qdq_cast_ref(t, 0, "tpu", amax, out_dtype=bf)
            if out is not None:
                out.append(same(got[i], r))
    agree = []
    plain(agree)
    what = (f"qdq_cast two-pass on a {tuple(x.shape)} expert leaf ({n} "
            f"elements, {n * 4} bytes f32)")
    check(got.dtype == bf and n > 2 ** 32 and all(agree), what)
    again = ops.qdq_cast(x, 0, "tpu", out_dtype=bf)
    check(all(same(a, b) for a, b in zip(got, again)),
          f"{what}: bitwise repeat")
    del again
    ms = time_ms(lambda: ops.qdq_cast(x, 0, "tpu", out_dtype=bf), iters=3,
                 reps=3)
    plain_ms = time_ms(plain, iters=1, reps=2)
    b_ms, by = bound(n * 6, n * 4, bw, ops_rate)
    log(f"  {what}: bitwise; kernel {ms:.4f} ms, plain by layers "
        f"{plain_ms:.4f}, bound {b_ms:.4f} ({by})")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


def _moe_masters(cfg, seed: int = 0):
    """The full model's f32 masters in host memory (62.8 GB: they cannot
    sit on the card beside a bf16 serving set, and the card machine's host
    refuses to pin that much), drawn layer by layer by the port's
    initializers on the card's seeded generator and copied straight into
    place -> (params, seconds)."""
    from repro_torch import tree as tu
    from repro_torch.models.lm import lm_init
    from repro_torch.nn import blocks
    from repro_torch.nn.layers import embedding_init
    t0 = time.perf_counter()
    host = tu.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype),
                       lm_init(None, cfg, device="meta"))
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def put(dst, src):
        for d, x in zip(tu.leaves(dst), tu.leaves(src)):
            d.copy_(x)
    put(host["embed"], embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                      device="cuda"))
    for si, (defs, n) in enumerate(cfg.stack.segments):
        seg = host["stack"][f"seg{si}"]
        for r in range(n):
            put(tu.tree_map(lambda x: x[r], seg),
                {f"b{i}": blocks.block_init(gen, bd, cfg.stack, "cuda")
                 for i, bd in enumerate(defs)})
    host["final_norm"]["scale"].zero_()
    put(host["unembed"], embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                        device="cuda"))
    torch.cuda.synchronize()
    return host, time.perf_counter() - t0


def _moe_split(cfg, busy_ms: float, dev) -> dict:
    """One MoE layer at the serving decode's shape (4 rows, C 1), device
    time by the profiler: the whole ``moe_apply`` and its dispatch (rank,
    drop, scatter-add), each times the model's MoE layers against a decode
    step's busy time."""
    from repro_torch import tree as tu
    from repro_torch.nn import moe
    m = cfg.stack.moe
    n_moe = cfg.stack.segments[1][1]
    gen = torch.Generator(device=dev).manual_seed(21)
    p = tu.tree_map(lambda w: w.to(torch.bfloat16),
                    moe.moe_init(gen, m, device=dev))
    x = torch.randn((4, 1, m.d_model), device=dev).to(torch.bfloat16)
    C = max(1, math.ceil(4 * m.top_k / m.num_experts * m.capacity_factor))
    with torch.no_grad():
        probs = torch.softmax(x.reshape(4, -1).float() @ p["router"].float(),
                              dim=-1)
        flat_e = moe.top_k(probs, m.top_k)[1].reshape(-1)
        whole = device_ms(lambda: moe.moe_apply(p, x, m), iters=20)
        disp = device_ms(lambda: moe.dispatch(x.reshape(4, -1), flat_e,
                                              m.top_k, m.num_experts, C),
                         iters=20)
    out = {"moe_layer_ms": whole, "dispatch_ms": disp,
           "moe_share": n_moe * whole / busy_ms,
           "dispatch_share": n_moe * disp / busy_ms}
    log(f"  one MoE layer at decode (4 rows, C {C}): device {whole:.5f} ms, "
        f"its dispatch {disp:.5f} ms; x {n_moe} layers: "
        f"{out['moe_share']:.3f} / {out['dispatch_share']:.3f} of a decode "
        f"step's device time ({busy_ms:.3f} ms busy)")
    return out


def _routes(calls) -> list:
    """Recorded ``moe.top_k`` calls -> [(probs, chosen experts as sorted
    rows)] on the host."""
    return [(p.float().cpu(), torch.sort(i, dim=-1).values.cpu())
            for p, i in calls]


def moe_against_cpu(params, spec: dict, card="cuda") -> dict:
    """A prefill of ``cpu_prompt`` tokens and ``MOE_CPU_STEPS`` teacher-
    forced decode steps at full width through layers 0 (MLA + dense FFN)
    and 1 (MLA + MoE), bf16 weights from ``params``, at one batch
    composition (one row) on the card (kernels) and the CPU (plain
    versions). The MoE layer's choice of experts is compared first: a
    token may route differently only where its k-th and (k+1)-th router
    probabilities lie within twice the largest card-vs-CPU gap of that
    call's probabilities (a near-tie); such flips are counted. Then the
    logits within ``MOE_CPU_TOL`` of their largest magnitude."""
    from repro_torch import tree as tu
    from repro_torch.models import lm
    from repro_torch.models.registry import get_model_config
    from repro_torch.nn import moe
    from repro_torch.serve.engine import scatter_prefill
    cfg = _moe_cut(get_model_config(MOE_ARCH), 1)
    cut = {k: v for k, v in params.items() if k != "stack"}
    cut["stack"] = {"seg0": params["stack"]["seg0"],
                    "seg1": tu.tree_map(lambda x: x[:1],
                                        params["stack"]["seg1"])}
    cut = tu.tree_map(lambda x: x.to(torch.bfloat16), cut)
    prompt, steps = spec["cpu_prompt"], MOE_CPU_STEPS
    g = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (1, prompt), generator=g,
                         dtype=torch.int32)
    feed = torch.randint(0, cfg.vocab_size, (steps, 1), generator=g,
                         dtype=torch.int32)
    out, routes, secs = {}, {}, {}
    orig = moe.top_k
    for dev in ("cpu", card):
        calls = []

        def top_k(probs, k):
            vals, idx = orig(probs, k)
            calls.append((probs, idx))
            return vals, idx
        moe.top_k = top_k
        t0 = time.perf_counter()
        try:
            p = tu.tree_map(lambda x: x.to(dev), cut)
            logits = []
            with torch.no_grad():
                lg, pre = lm.lm_prefill(p, {"tokens": toks.to(dev)}, cfg)
                logits.append(lg.float().cpu())
                caches = scatter_prefill(
                    lm.lm_init_cache(cfg, 1, spec["total"], device=dev), pre,
                    0)
                for i in range(steps):
                    lg, caches = lm.lm_decode_step(
                        p, feed[i].to(dev), caches,
                        torch.tensor([prompt + i], device=dev), cfg)
                    logits.append(lg.float().cpu())
        finally:
            moe.top_k = orig
        out[dev] = torch.stack(logits)
        routes[dev] = _routes(calls)
        secs[dev] = time.perf_counter() - t0
        del p, caches, pre, calls
    k = cfg.stack.moe.top_k
    check(len(routes["cpu"]) == len(routes[card]) == 1 + steps,
          f"{MOE_ARCH}: one router call a forward")
    flips, worst_gap = 0, 0.0
    for (pc, ec), (pg, eg) in zip(routes["cpu"], routes[card]):
        diff = (ec != eg).any(dim=-1)
        near = 2.0 * float((pc - pg).abs().max())
        top2 = torch.sort(pc, dim=-1, descending=True).values
        gap = top2[:, k - 1] - top2[:, k]
        if bool(diff.any()):
            worst_gap = max(worst_gap, float(gap[diff].max()))
            check(bool((gap[diff] <= near).all()),
                  f"{MOE_ARCH}: routing differs card vs CPU away from a "
                  f"near-tie: gaps {gap[diff].tolist()} > {near}")
        flips += int(diff.sum())
    ref, got = out["cpu"], out[card]
    gap = float((got - ref).abs().max())
    lim = MOE_CPU_TOL * float(ref.abs().max())
    same_top = (got.argmax(-1) == ref.argmax(-1)).float().mean()
    log(f"{MOE_ARCH} x2 layers (dense, MoE), prefill {prompt} + {steps} "
        f"decode steps, card vs CPU: routing flips {flips} of "
        f"{prompt + steps} tokens (all at near-ties; widest gap "
        f"{worst_gap:.3g}), max|dlogit| {gap:.4g} (limit {lim:.4g}), same "
        f"argmax {float(same_top):.2f}; CPU {secs['cpu']:.1f} s, card "
        f"{secs[card]:.1f} s")
    check(bool(torch.isfinite(got).all()), f"{MOE_ARCH}: finite card logits")
    check(gap <= lim, f"{MOE_ARCH}: card vs CPU logits {gap} > {lim}")
    return {"flips": flips, "gap": gap}


def moe_phase(card: str, dev, bw, f32_ops, tc_ops) -> dict:
    """Phase 13: deepseek-v2-lite-16b, MLA and MoE. Its kernels against
    their plain versions at its shapes (the tensor-core forward and the
    backward at D 192 / Dv 128, the fused update on the cut model's slab);
    training at full width, the depth cut to the dense layer and
    ``MOE_TRAIN_MOE_LAYERS`` MoE layers, through the launcher; the full
    model's f32 masters drawn on the card's generator into host memory;
    the two-pass cast of one 4.8 G-element expert leaf; serving at full
    width and depth (27 layers), one session a tier (tier 1, then tier 0:
    two bf16 sets and a cast's f32 leaf do not fit the card together),
    each set built leaf by leaf from the host masters; the dispatch's
    share of a decode step; card vs CPU at layers 0-1.
    -> {"rows": {kernel: result}, "launches": {kernel: launches}}."""
    from repro_torch import tree as tu
    from repro_torch.kernels.layout import slab_view
    from repro_torch.models.registry import get_model_config
    from repro_torch.train.task import LMTask
    t_phase = time.perf_counter()
    log(f"phase 13 starts with {torch.cuda.memory_allocated() / 1e9:.3f} GB "
        "allocated on the card")
    full = get_model_config(MOE_ARCH)
    cut = _moe_cut(full, MOE_TRAIN_MOE_LAYERS)
    log(f"{MOE_ARCH}: kernels at its shapes ({card})")
    rows = _dense_attention(full, MOE, dev, bw, tc_ops)
    slab_cfg = _moe_cut(full, MOE_FUSED_MOE_LAYERS)
    task = LMTask(slab_cfg, device="cpu")
    like, _ = task.init(torch.Generator(), device="meta")
    rows.update(_dense_fused(slab_view(like, task.grouping(like)), dev, bw,
                             f32_ops, f"{MOE_ARCH} x{slab_cfg.num_layers}"))
    del like
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with _registry_config(MOE_ARCH, cut):
        tr, tl, init_s, train_s = dense_train(MOE_ARCH, MOE)
    aux = {k: tr.metrics_log[0][k] for k in ("moe_load_balance",
                                              "moe_z_loss")}
    check(all(math.isfinite(v) and v != 0.0 for v in aux.values()),
          f"{MOE_ARCH}: MoE aux terms finite and non-zero: {aux}")
    step_ms = []
    for _ in range(3):              # unprofiled steps at the top rung
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tr.run(1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    log(f"{MOE_ARCH} training at {cut.num_layers} layers (1 dense + "
        f"{MOE_TRAIN_MOE_LAYERS} MoE): step 0's aux terms {aux}; a train "
        f"step at rung {tr.scaler.microbatch}, S {MOE['seq']}: "
        f"{statistics.median(step_ms):.1f} ms (median of 3: "
        f"{[round(x, 1) for x in step_ms]}); training part "
        f"{time.perf_counter() - t0:.1f} s")
    profile_lm_step(tr)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    masters, draw_s = _moe_masters(full)
    n = sum(int(x.numel()) for x in tu.leaves(masters))
    log(f"{MOE_ARCH}: {n} parameters drawn on the card's generator into "
        f"host memory in {draw_s:.1f} s")
    rows["qdq_cast"] = _moe_qdq(masters["stack"]["seg1"]["b0"]["ffn"]["w_up"],
                                dev, bw, f32_ops)
    gc.collect()
    torch.cuda.empty_cache()
    serve = {}
    for t in (1, 0):
        serve[t] = dense_serve(MOE_ARCH, MOE, masters, tiers=(t,))
        gc.collect()
        torch.cuda.empty_cache()
    _moe_split(full, serve[0]["decode_busy_ms"], dev)
    gc.collect()
    torch.cuda.empty_cache()
    vs_cpu = moe_against_cpu(masters, MOE)
    del masters
    gc.collect()
    launches = {k: tl.get(k, 0) for k in MOE_ROWS}
    launches["flash_attention"] += sum(sv["launches"]["flash_attention"]
                                       for sv in serve.values())
    launches["qdq_cast"] = serve[0]["launches"]["qdq_cast"]
    check(all(sv["launches"]["flash_decode"] == 0 for sv in serve.values()),
          f"{MOE_ARCH}: flash_decode 0 launches (MLA decodes absorbed)")
    log(f"phase 13 in {time.perf_counter() - t_phase:.1f} s: task.init "
        f"{init_s:.1f} s, training {train_s:.1f} s, masters {draw_s:.1f} s, "
        f"serving sessions {serve[1]['session_s']:.1f} / "
        f"{serve[0]['session_s']:.1f} s (tier 1 / 0), tok/s "
        f"{serve[1]['tok_s']:.1f} / {serve[0]['tok_s']:.1f}, peaks "
        f"{serve[1]['peak'] / 1e9:.3f} / {serve[0]['peak'] / 1e9:.3f} GB, "
        f"routing flips card vs CPU {vs_cpu['flips']} ({card})")
    return {"rows": rows, "launches": launches}


# ----------------------- phase 14: the recurrent architectures -------------
#: per model: the training sequence and rungs, the serving prompt and cache
#: (recurrentgemma's past its 2048-slot rings, so they wrap while decoding),
#: the card-vs-CPU prompt and cache
RECURRENT = {
    "mamba2-370m": dict(seq=1024, rungs="2,4,8", prompt=1024, total=2048,
                        cpu_prompt=1024),
    "recurrentgemma-2b": dict(seq=4096, rungs="1,2", prompt=2048,
                              total=4096, cpu_prompt=2048, cpu_total=4096),
}
#: the kernels each model's paths launch (its rows): mamba2 runs no
#: attention, so no flash kernel; neither model's decode takes flash_decode
RECURRENT_ROWS = {
    "mamba2-370m": ("fused_stats", "fused_apply", "qdq_cast"),
    "recurrentgemma-2b": ("flash_attention", "flash_attention_bwd_delta",
                          "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                          "fused_stats", "fused_apply", "qdq_cast"),
}
_FLASH_KEYS = ("flash_attention", "flash_attention_bwd_delta",
               "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
               "flash_decode")


def _prefill_forward(cfg, spec, dev, bw, tc_rate) -> dict:
    """The tensor-core forward against its plain version at the serving
    prefill's shape (B 1, S the prompt, the model's heads and window),
    timed beside the plain version, SDPA with the window's mask and the
    bound -> the ``prefill_*`` keys of the forward's row."""
    from repro_torch.kernels import flash_attention as fa
    B, S = 1, spec["prompt"]
    H, K, D, Dv = _attn_dims(cfg)
    w = max(bd.window for defs, _ in cfg.stack.segments for bd in defs)
    gen = torch.Generator(device=dev).manual_seed(19)
    q, k, v = (torch.randn(sh, generator=gen, device=dev).to(torch.bfloat16)
               for sh in ((B, S, H, D), (B, S, K, D), (B, S, K, Dv)))
    kw = dict(causal=True, window=w)
    what = f"{cfg.name} prefill attention B{B} S{S} {H}/{K} D{D} window {w}"
    err = _flash_pair(q, k, v, None, kw, what, "tc")
    i = torch.arange(S, device=dev)
    mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < w)
    ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw), iters=10,
                 reps=3)
    plain = time_ms(lambda: fa.flash_attention_ref(q, k, v, **kw), iters=2,
                    reps=2)
    lib = time_ms(lambda: _sdpa(q, k, v, attn_mask=mask), iters=10, reps=3)
    b_ms, by = bound(2 * B * S * (H * D + K * D + K * Dv + H * Dv),
                     _pairs(B, H, S, w) * 2 * (D + Dv), bw, tc_rate)
    log(f"  {what}: kernel {ms:.4f} ms, plain {plain:.4f}, sdpa {lib:.4f}, "
        f"bound {b_ms:.4f} ({by}), max|err| {err:.3g}")
    return {"prefill_max_abs_err": err, "prefill_ms": ms,
            "prefill_plain_ms": plain, "prefill_library_ms": lib,
            "prefill_bound_ms": b_ms, "prefill_bound_by": by}


def recurrent_phase(card: str, dev, bw, f32_ops, tc_ops) -> dict:
    """Phase 14: mamba2-370m and recurrentgemma-2b. For each, its kernels
    against their plain versions at its shapes, training at full width
    through the launcher (three more steps timed, one profiled), the
    trained weights served at full width and depth through tiers 1 and 0,
    then the card-vs-CPU check on its first layers.
    -> {arch: {"rows": {kernel: result}, "launches": {kernel: launches on
    the model's main paths}}}."""
    from repro_torch import tree as tu
    from repro_torch.kernels.layout import slab_view
    from repro_torch.models.registry import get_model_config
    from repro_torch.train.task import LMTask
    t_phase = time.perf_counter()
    log(f"phase 14 starts with {torch.cuda.memory_allocated() / 1e9:.3f} GB "
        "allocated on the card")
    out = {}
    for arch, spec in RECURRENT.items():
        t_model = time.perf_counter()
        cfg = get_model_config(arch)
        log(f"{arch}: kernels at its shapes ({card})")
        rows = {}
        if _n_attn(cfg):
            rows.update(_dense_attention(cfg, spec, dev, bw, tc_ops))
            pre = _prefill_forward(cfg, spec, dev, bw, tc_ops)
            fwd = rows["flash_attention"]
            fwd["max_abs_err"] = max(fwd["max_abs_err"],
                                     pre["prefill_max_abs_err"])
            fwd.update(pre)
        task = LMTask(cfg, device="cpu")
        like, _ = task.init(torch.Generator(), device="meta")
        rows.update(_dense_fused(slab_view(like, task.grouping(like)), dev,
                                 bw, f32_ops, arch))
        del like
        gc.collect()
        torch.cuda.empty_cache()
        tr, tl, init_s, train_s = dense_train(arch, spec)
        step_ms = []
        for _ in range(3):              # unprofiled steps at the top rung
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.run(1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        log(f"{arch}: a train step at rung {tr.scaler.microbatch}, S "
            f"{spec['seq']}: {statistics.median(step_ms):.1f} ms (median of "
            f"3: {[round(x, 1) for x in step_ms]})")
        profile_lm_step(tr)
        params = tr.params_tree()
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        n_cut = _dense_cut(cfg, arch).stack.segments[0][1]
        cut = tu.tree_map(lambda x: x.to(torch.bfloat16).cpu(),
                          _dense_cut_params(params, n_cut))
        rows["qdq_cast"] = _dense_qdq(params, dev, bw, f32_ops)
        sv = dense_serve(arch, spec, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        vs = dense_against_cpu(arch, spec, cut)
        del cut
        check(sv["launches"]["flash_decode"] == 0,
              f"{arch}: no flash_decode (no unwindowed attention cache)")
        if not _n_attn(cfg):
            check(not any(tl.get(k, 0) or sv["launches"][k]
                          for k in _FLASH_KEYS),
                  f"{arch}: no attention kernel on an attention-free model")
        launches = {k: tl.get(k, 0) for k in RECURRENT_ROWS[arch]}
        if "flash_attention" in launches:
            launches["flash_attention"] += sv["launches"]["flash_attention"]
        launches["qdq_cast"] = sv["launches"]["qdq_cast"]
        out[arch] = {"rows": {k: rows[k] for k in RECURRENT_ROWS[arch]},
                     "launches": launches}
        log(f"{arch}: task.init {init_s:.1f} s, training {train_s:.1f} s, "
            f"serving {sv['tok_s']:.1f} tok/s, median decode step ms by "
            f"rung/tier {sv['lat_ms']}, a decode step {sv['decode_ops']:.0f} "
            f"device ops and {sv['decode_busy_ms']:.3f} ms busy, card vs CPU "
            f"max|dlogit| {vs['gap']:.4g}; the model's part of phase 14 "
            f"{time.perf_counter() - t_model:.1f} s ({card})")
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 14 in {time.perf_counter() - t_phase:.1f} s")
    return out


CHILDREN = {"train-real-oom": real_oom, "serve-real-oom": serve_real_oom}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=50,
                    help="ResNet-18 main-path steps")
    ap.add_argument("--batch0", type=int, default=32)
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and hold the kernels against their plain "
                         "versions (phases 1-3), then stop; prints no "
                         "result line")
    ap.add_argument("--dense-only", action="store_true",
                    help="build, then run phase 12 (the dense GQA "
                         "architectures) alone; prints no result line")
    ap.add_argument("--moe-only", action="store_true",
                    help="build, then run phase 13 (deepseek-v2-lite-16b, "
                         "MLA and MoE) alone; prints no result line")
    ap.add_argument("--recurrent-only", action="store_true",
                    help="build, then run phase 14 (mamba2-370m and "
                         "recurrentgemma-2b) alone; prints no result line")
    ap.add_argument("--child", choices=sorted(CHILDREN),
                    help=argparse.SUPPRESS)   # a check's own process
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if args.child:                   # a check's own process: in_child
        print(json.dumps(CHILDREN[args.child](), default=str), flush=True)
        return 0

    t_script = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    bw, f32_ops, tc_ops, tf32_ops = peaks(name)
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    srcs = sorted(p.stem for p in (ROOT / CSRC).glob("*.cu"))
    procs = {s: _build.start_build(s) for s in srcs}     # all at once
    for s, proc in procs.items():
        _build.finish_build(s, proc)
        _build.load(s)
    log(f"built {srcs} in {time.perf_counter() - t0:.1f} s")
    for s, text in _build.BUILD_LOG.items():
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill", text))
        smem = [int(w) for w in re.findall(r"(\d+) bytes smem", text)]
        log(f"  ptxas {s}: {len(regs)} kernels, at most {max(regs)} "
            f"registers a thread, {spills} bytes of spills, static smem "
            f"at most {max(smem, default=0)} bytes")
        if s in ("flash_fwd_sm90", "flash_bwd_sm90", "flash_attention_bwd",
                 "flash_fwd_tf32", "flash_bwd_tf32", "flash_decode_sm90"):
            for kern, nreg, spill in ptxas_kernels(text):
                log(f"    {s}: {kern}: {nreg} registers, {spill} bytes of "
                    "spill stores")
                check(not spill or not s.endswith("sm90"),
                      f"no spills in the Hopper (sm90) sources: {kern}")

    dev = torch.device("cuda")
    if args.dense_only:
        dense_phase(card, dev, bw, f32_ops, tc_ops)
        return 0
    if args.moe_only:
        moe_phase(card, dev, bw, f32_ops, tc_ops)
        return 0
    if args.recurrent_only:
        recurrent_phase(card, dev, bw, f32_ops, tc_ops)
        return 0
    t_phase = time.perf_counter()
    view = vision_view()
    res = {"fused_stats": check_stats(view, dev, bw, f32_ops),
           "fused_apply": check_apply_main(view, dev, bw, f32_ops)}
    res["fused_apply"]["max_abs_err"] = max(res["fused_apply"]["max_abs_err"],
                                            check_apply_variants(dev))
    eff_view = vision_view("efficientnet_b0")
    res["fused_stats@efficientnet_b0"] = check_stats(
        eff_view, dev, bw, f32_ops, what="EfficientNet-B0")
    res["fused_apply@efficientnet_b0"] = check_apply_main(
        eff_view, dev, bw, f32_ops, what="EfficientNet-B0")
    lm_view, lm_var = lm_train_view(), lm_train_variant()
    res["fused_stats@lm_train"] = check_stats(
        lm_view, dev, bw, f32_ops, g_dtype=lm_var["g_dtype"],
        what="smollm-135m")
    res["fused_apply@lm_train"] = check_apply_main(
        lm_view, dev, bw, f32_ops, what="smollm-135m", **lm_var)
    del lm_view
    res.update(check_qdq(dev, bw, f32_ops))
    res["qdq_cast_one_pass@vision_serve"] = check_qdq_vision(dev, bw, f32_ops)
    res.update(check_flash(dev, bw, f32_ops, tc_ops, tf32_ops))
    res["flash_decode"] = check_decode(dev, bw, tc_ops)
    res["flash_decode@chunked_prefill"] = check_decode_chunk(dev, bw, tc_ops)
    delta_err = check_delta(dev)
    res.update(check_flash_bwd(dev, bw, f32_ops, tc_ops, tf32_ops))
    res["flash_attention_bwd_delta"]["max_abs_err"] = max(
        res["flash_attention_bwd_delta"]["max_abs_err"], delta_err)
    for k, n in check_flash_function(dev).items():
        res[k]["f32_function_launches"] = n
    res["grad_stats"] = check_grad_stats(dev, bw, f32_ops)
    log(f"kernel checks in {time.perf_counter() - t_phase:.1f} s")
    if args.kernels_only:
        return 0

    t_phase = time.perf_counter()
    check_step_against_cpu()
    check_step_against_cpu("efficientnet_b0", floor=1e-5)
    check_curvature_against_cpu()
    check_lm_against_cpu()
    check_lm_step_against_cpu()
    check_reference_steps_against_cpu()
    log(f"card-vs-CPU checks in {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    launches = main_path(args.steps, args.batch0)[0]
    eff_launches, eff_ms, eff_peak, eff_rungs = main_path(
        EFF_STEPS, args.batch0, "efficientnet_b0")
    for k in ("fused_stats", "fused_apply"):
        launches[f"{k}@efficientnet_b0"] = eff_launches[k]
    hutchinson_main_path()
    sess, serve_launches = serve_main_path()
    for k in ("qdq_cast", "flash_decode"):
        launches[k] = serve_launches[k]
    log(f"main paths in {time.perf_counter() - t_phase:.1f} s")
    profile_steps(args.batch0)
    profile_steps(args.batch0, arch="efficientnet_b0")
    profile_prefill(sess)
    profile_decode(sess)
    del sess                  # the LM trainer's measured bytes are its own
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    lm_tr, lm_launches, one_pass = lm_train_main_path()
    launches["qdq_cast_one_pass"] = one_pass
    # a kernel that runs on two paths at different shapes has a row for
    # each: its launches on that path beside its time at that path's shape
    launches["flash_attention"] = serve_launches["flash_attention"]
    for k in ("fused_stats", "fused_apply", "flash_attention"):
        launches[f"{k}@lm_train"] = lm_launches[k]
    for k in ("flash_attention_bwd_delta", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv"):
        launches[k] = lm_launches[k]
    check(all(lm_launches[f"{k}_tc"] == lm_launches[k]
              for k in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")),
          "every LM dQ and dK/dV launch on the tensor-core route")
    log(f"LM training main path in {time.perf_counter() - t_phase:.1f} s")
    time_lm_rungs(lm_tr)
    profile_lm_step(lm_tr)
    del lm_tr                 # the reference paths' peaks are their own
    gc.collect()
    torch.cuda.empty_cache()

    # the reference step's main paths, each with its counts read around it;
    # grad_stats' path is its op over each path's gradient tree
    t_phase = time.perf_counter()
    gs_resnet = fp32_main_path()[0]
    profile_steps(FP32_ARGS["batch0"], method="fp32")
    gs_eff, eff_fp32_ms, eff_fp32_peak = fp32_main_path(
        "efficientnet_b0", "EfficientNet-B0", bw, f32_ops)
    profile_steps(FP32_ARGS["batch0"], method="fp32", arch="efficientnet_b0")
    # the paper's comparison (Table 1's EfficientNet-B0 rows): measured here,
    # asserted nothing about
    from repro_torch.train.paper_harness import PAPER_FP32_GB
    log(f"EfficientNet-B0 from rung {args.batch0}: Tri-Accel median step "
        f"{eff_ms:.3f} ms (the controller's rungs {eff_rungs} at steps 10, "
        f"20, ...), peak allocated {eff_peak / 1e9:.3f} GB; "
        f"FP32 (rung fixed) median step {eff_fp32_ms:.3f} ms, peak "
        f"allocated {eff_fp32_peak / 1e9:.3f} GB; the paper's FP32 point "
        f"{PAPER_FP32_GB['efficientnet_b0']} GB (its memory model's "
        "calibration, batch 96)")
    gc.collect()
    torch.cuda.empty_cache()
    nt_launches, gs_lm = no_triaccel_main_path(bw, f32_ops)
    # the split-TF32 and SIMT forwards' launches on the three LM paths
    # (each checked 0; the f32 autograd check counts the split-TF32 one's)
    for route in ("tf32", "simt"):
        launches[f"flash_attention_{route}"] = sum(
            d[f"flash_attention_{route}"]
            for d in (serve_launches, lm_launches, nt_launches))
    # likewise the split-TF32 and SIMT dQ and dK/dV on the two LM training
    # paths (f32 callers' routes; the f32 autograd check counts them)
    for k in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        for route in ("tf32", "simt"):
            launches[f"{k}_{route}"] = sum(
                d[f"{k}_{route}"] for d in (lm_launches, nt_launches))
    launches["grad_stats"] = gs_resnet["launches"]
    res["grad_stats"]["max_abs_err"] = max(res["grad_stats"]["max_abs_err"],
                                           gs_resnet["max_abs_err"])
    launches["grad_stats@lm_reference"] = gs_lm.pop("launches")
    res["grad_stats@lm_reference"] = gs_lm
    launches["grad_stats@efficientnet_b0_reference"] = gs_eff.pop("launches")
    res["grad_stats@efficientnet_b0_reference"] = gs_eff
    log(f"reference main paths in {time.perf_counter() - t_phase:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # checkpoint, resume and preemption: each resumed path with its counts
    # read around it; the card's numbers printed beside its name and limit
    t_phase = time.perf_counter()
    saved = {"ResNet-18": checkpoint_resnet(args.batch0),
             "smollm-135m": checkpoint_lm()}
    for what, r in saved.items():
        log(f"checkpoint, {what} ({card}): one generation {r['bytes']} "
            f"bytes; save() host stall {r['stall_ms']:.3f} ms (unpack and "
            f"device-to-host copy), background write {r['write_ms']:.3f} "
            f"ms, maybe_restore on the card {r['restore_ms']:.3f} ms")
    log(f"checkpoint phase in {time.perf_counter() - t_phase:.1f} s")

    # faults and recovery: the fault plan's path with its counts read
    # around it, a real OOM, the costs beside the card's name and limit
    t_phase = time.perf_counter()
    faults = faults_phase(card, dev)
    for k in ("fused_stats", "fused_apply"):
        res[k]["fault_path_launches"] = faults["launches"][k]
    log(f"faults phase in {time.perf_counter() - t_phase:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # serving faults and recovery: the soak's serving plan at full width with
    # its counts read around it, a real OOM, the soak on the card
    full = serve_faults_phase(card)
    for k in ("flash_attention", "flash_decode", "qdq_cast"):
        res[k]["fault_path_launches"] = full["launches"][k]
    gc.collect()
    torch.cuda.empty_cache()

    # the rest of serving: chunked prefill, SLO traffic, vision inference,
    # each path with its counts read around it
    rest = serve_rest_phase(card)
    launches["flash_decode@chunked_prefill"] = (
        rest["chunk"]["flash_decode"] + rest["slo"]["flash_decode"])
    launches["qdq_cast_one_pass@vision_serve"] = rest["vision"]
    gc.collect()
    torch.cuda.empty_cache()

    # the dense GQA architectures: each model's kernels at its shapes, then
    # its training and serving main paths with their counts read around them
    for arch, d in dense_phase(card, dev, bw, f32_ops, tc_ops).items():
        for k, r in d["rows"].items():
            res[f"{k}@{arch}"] = r
            launches[f"{k}@{arch}"] = d["launches"][k]
    gc.collect()
    torch.cuda.empty_cache()

    # MLA and MoE: deepseek-v2-lite-16b's kernels at its shapes, then its
    # training and serving main paths with their counts read around them
    d = moe_phase(card, dev, bw, f32_ops, tc_ops)
    for k, r in d["rows"].items():
        res[f"{k}@{MOE_ARCH}"] = r
        launches[f"{k}@{MOE_ARCH}"] = d["launches"][k]
    gc.collect()
    torch.cuda.empty_cache()

    # the recurrent architectures: each model's kernels at its shapes, then
    # its training and serving main paths with their counts read around them
    for arch, d in recurrent_phase(card, dev, bw, f32_ops, tc_ops).items():
        for k, r in d["rows"].items():
            res[f"{k}@{arch}"] = r
            launches[f"{k}@{arch}"] = d["launches"][k]

    rows = [{"name": rname, "route": "cuda", "source": src,
             "replaces": replaces, "launches": launches[rname],
             **res[rname]}
            for kname, (src, replaces) in KERNELS.items()
            for rname in res if rname.split("@")[0] == kname]
    check(len(rows) == len(res) and {r["name"].split("@")[0] for r in rows}
          == set(KERNELS), "a row for every kernel and every result")
    log(f"chip_smoke.py in {time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
