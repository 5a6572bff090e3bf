#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one card and check every result.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and exits non-zero, printing no result, without one. It builds the
CUDA kernels from ``src/repro_torch/kernels/csrc`` and imports nothing of
JAX or of the JAX package. No phase's failure is caught.

  1. Device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
     the kernels build (one nvcc per source, in parallel). Per kernel entry,
     under a readable name (``flash_fwd_bf16_kernel<80>``): registers, stack
     and spill bytes from nvcc's ``-Xptxas=-v`` report, the flash kernels'
     dynamic shared memory at danube's D, and the flash library's count of
     tensor-core (HMMA: mma.sync, HGMMA: wgmma) and FFMA instructions from
     ``cuobjdump -sass``; every flash entry phase 2's shapes run, fp32
     (3xTF32 on mma.sync) and bf16 (wgmma), must show tensor-core ones.
  2. Each kernel against its plain PyTorch version on the card. Flash
     attention on the shapes of tests/test_kernels.py's ATTN_CASES, each
     again in bf16 (the wgmma kernel), D = 72 with a non-causal
     window, danube's heads at S = 320 and danube's prefill shape (fp32
     within 1e-4, bf16 within 2e-2, unit-normal inputs), and rows with no
     live key (exactly 0); the kernel, the plain version and one library
     call timed by CUDA events, the least time the card could take
     (``bound_ms``; fp32 at the 3xTF32 rate, a third of the TF32 peak, with
     its bound at the CUDA cores' FMA peak beside it as ``fma_bound_ms``),
     the rate (``tflops``) and its share (``bound_frac``).
     The same at dbrx-132b's attention shape (B=1, S=4096, 48 query / 8 KV
     heads of 128, causal, no window) and at zamba2-1.2b's shared block
     (B=2, S=4096, 32/32 heads of 64, causal, no window), against SDPA with
     ``is_causal``.
  3. The main path, at full width: h2o-danube-1.8b (24 layers, d_model
     2560, random weights from a seed) prefills 2 × 4608 tokens through
     ``launch.steps.make_prefill`` with the flash-attention kernel, against
     the plain dense path, in fp32 (relative max error ≤ 1e-3) and bf16
     (≤ 5e-2); each kernel prefill launches the kernel once per layer.
  4. The serving launcher at full width: 4 requests, 64-token prompts,
     32 generated tokens each (``launch.serve.main``, default device).
  5. Data-parallel training at full width: bert-large (24 layers, d_model
     1024, 333,344,768 parameters, random init from seed 0) on 4 virtual
     ranks, global batch 8 × 128 tokens, 6 steps, through
     ``launch.train.main``, three times: ``--comm xla`` and ``--comm
     lumorph4`` with an fp32 wire (final losses within 1e-4 relative, the
     limit of tests/test_train_integration.py), then ``--comm lumorph2
     --compress`` (int8 payloads and error feedback through the int8
     kernels; final loss within 5 % of the lumorph4 run).
     Then overlap mode (``--overlap 4``): ``lumorph4`` (final loss within
     1e-4 relative of the monolithic lumorph4 run) with checkpoints every 3
     steps, and ``lumorph2 --compress`` (within 1e-3 relative of the
     monolithic compressed run); and a checkpoint round trip: the overlap
     run is restarted from its step-3 checkpoint and must end on the same
     final loss, exactly. Every LayerNorm of these runs goes through the
     LayerNorm kernels: 97 forward, 49 backward and 49 reduction launches
     in each virtual rank's step.
  6. Retired: the benchmark's traced run (``bench/run.py --trace 1``) splits
     a training step by stage and by module on the card.
  7. Overlap mode, the port's twin of the JAX package's overlap benchmark:
     8 virtual ranks, lumorph2, each reduced chunk consumed by the RMSNorm
     kernel over rows of 128 (w = 0), monolithic and C ∈ {2, 4, 8}, at a
     25 MB gradient bucket and at 256 MB per rank: relative error against
     the plain RMSNorm of the plain sum within 1e-5, time per call, one
     kernel launch per chunk. With no consumer, C = 1 equals the monolithic
     program bit for bit, and at 1 MB per rank C = 4 equals its CPU run.
  8. The MLA and MoE blocks at full width: deepseek-v2-lite-16b whole as
     published (27 layers, 15,706,357,760 parameters as ``param_count()``
     counts them, bf16; the latent's RMSNorm, YaRN, the top-6 gates as the
     softmax gives them, dropless routing): (a) ``init_params``' count on the
     card, seed 0; then on the benchmark cell's weights from ``DEEPSEEK_SEED``:
     (b) a bf16 prefill of the cell's prompts (2 × 4096 Zipf tokens from that
     seed) through ``make_prefill`` with ``use_pallas``, timed, which launches
     no flash kernel (MLA never reaches it, as in JAX) and three grouped expert
     products a MoE layer, none of which waits for the card (sync debug mode
     "error"), and fills the latent caches; each MoE layer's pairs per expert
     (``moe.EXPERT_LOADS`` of a profiled call); 16 greedy decode steps
     through the caches; the prefill's served tokens and each step's logits
     judged by the plain fp32 reference
     (``bench/references/deepseek-v2-lite-16b.py``) over the whole sequence,
     every served token within the benchmark cell's ``token_gap`` limit, each
     step's relative error printed; (c) in fp32, 1 × 64 tokens, the
     prefill's logits against 64 decode steps over the rank-512 latent cache
     (≤ 1e-3 relative); (d) the first two layers, fp32, 1 × 256 tokens, the
     card against the CPU (≤ 1e-4 relative, argmax agreement 1.0); (e) with
     those params freed, the serving driver (4 requests, 64-token prompts,
     32 generated tokens).
  9. dbrx-132b's MoE blocks at full width, 2 layers deep (7,751,270,400
     bf16 parameters): prefill of 1 × 4096 tokens in bf16 and fp32 through the
     flash kernel (two launches per prefill) against the plain path, held to
     ``PREFILL_TOL`` in fp32 and printed in bf16 beside a plain-against-plain
     control (the router's top-k makes bf16 rounding move whole rows); layer
     0's attention, kernel against plain, held to ``PREFILL_TOL`` in both;
     then decode steps, finite.
 10. The dense trio at full width, one model at a time, its fp32 params
     (seed 0) freed before the next: phi3-medium-14b (40 layers, 40/10 heads
     of 128), codeqwen1.5-7b (32 layers, 32/32 heads, QKV biases) and
     glm4-9b (40 layers, 32/2 heads, half the lanes rotated). Each prefills
     1 × 4096 tokens through ``make_prefill`` with the flash kernel against
     the plain dense path, in bf16 and fp32, held to ``PREFILL_TOL``, with
     one launch per layer. Then glm4-9b through the serving launcher.
 11. The SSM and hybrid block kinds whole, at full width and depth:
     zamba2-1.2b (38 mamba2 layers, d_model 2048, the shared dense block
     before layers 6, 12, …, 36; 32/32 heads of 64) and xlstm-125m (12
     layers, mLSTM with sLSTM at 3 and 9), fp32 params from seed 0. Each:
     (a) ``param_count()``; (b) a bf16 prefill of 2 × 4096 tokens through
     ``make_prefill`` with ``use_pallas``, timed: zamba2 launches the flash
     kernel once per shared call site (6), xlstm never; one block of each
     kind (and one shared call site) timed on the prefill's embeddings, with
     its share of the prefill; (c) fp32, 1 × 64
     tokens, the prefill's logits against 64 decode steps (≤ 1e-3
     relative); (d) the leading layers in fp32 at 1 × 256, the card
     against the CPU (≤ 1e-4, argmax agreement 1.0): zamba2's first 7
     layers with the first shared site, xlstm's layers 0–3 (mLSTM and
     sLSTM); (e) with those params freed, the serving launcher.
 12. The encdec and vlm kinds whole, at full width and depth, fp32 params
     from seed 0. First the flash kernel alone at whisper-tiny's encoder
     shape (B=4, 1500 frames, 6/6 heads of 64, bidirectional, no window:
     1500 is a multiple of neither the 64-key tile nor the 192-row query
     block), against its plain version (bf16 2e-2, fp32 1e-4; and, relative
     to the output's RMS, within ``TAIL_TOL``, which the plain version over
     zero-padded keys, an unmasked last key tile's answer, must exceed) and
     timed beside SDPA with no mask. whisper-tiny (4 encoder and 4 decoder layers,
     d_model 384): (a) the encoder over 4 × 1500 frames through the kernel,
     one launch per encoder layer, timed; (b) against the dense encoder,
     bf16 within 5e-2 and fp32 within 1e-3 relative, argmax agreement
     printed; (c) fp32, the decoder's logits over 10 tokens against 10
     decode steps over the self and cross caches (≤ 1e-3); (d) the serving
     example ``examples/torch_whisper_serve.py`` (4 requests, 24 tokens,
     bf16), its launches counted alone: one per encoder layer. paligemma-3b (18 layers, d_model 2048, 8/1 heads of 256): (a)
     bf16 and fp32 prefills of 2 × (256 image + 512 text) tokens through
     ``make_prefill`` on the dense path (no flash launch: the kernel cannot
     take the prefix mask), timed, with peak memory; (b) its first 2
     layers, fp32, 1 × (256 + 32), the card against the CPU (≤ 1e-4, argmax
     agreement 1.0); (c) with those params freed, the serving launcher
     (text tokens by replay, as in JAX), its launches counted alone: none.
 13. The α–β cost model, the sharding policy and the KIVI cache. (a)
     bert-large as in phase 5 with ``--comm auto`` (fp32 wire) and ``--comm
     auto --compress``: every step's bucket log names, for every bucket, the
     algorithm the port's ``select_algorithm`` gives for its bytes at p = 4
     (``lumorph4``, ``+int8`` under ``--compress``), and the final losses
     equal phase 5's ``lumorph4`` and ``lumorph2 --compress`` runs exactly
     (at p = 4 the model picks LUMORPH-4 for every bucket, and compression
     always runs LUMORPH-2, as in JAX); the buckets' α–β prices are printed,
     labelled as model outputs of the paper's link constants. (b)
     ``make_policy``'s tp, dp and zero3 on the production single and multi
     meshes for every registered config, each spec checked to divide. (c)
     h2o-danube-1.8b whole, fp32 params from seed 0, bf16 compute: 4 × 64
     prompt tokens replayed and 32 greedy decode steps into the bf16 cache,
     then the same tokens into the int8 cache
     (``cfg.replace(kv_cache_dtype="int8")``): every written slot within the
     quantizer's bound (``|q·scale − x| ≤ scale/2`` plus one fp32 ulp of
     ``amax = 127·scale``, for the fp32 rounding of ``x / scale``), the int8
     cache's decode logits against the bf16 cache's (relative error ≤ 5e-2,
     phase 3's bf16 limit, and argmax agreement), TPOT and the caches' bytes
     (int8: (1 + 4/80)/2 = 0.525 of bf16's without ``pos``).
 14. The dry-run, the roofline and the example twins. (a)
     ``launch.dryrun``'s every (arch × shape) cell on the single and the
     multi mesh, on the meta device (each cell counted once for both
     meshes; the cells shared out over ``DRYRUN_WORKERS`` spawned
     processes), every cell ``ok``: the cell count, the seconds, each cell's
     per-device FLOPs and argument bytes, and the cells whose argument bytes
     exceed this card's memory (printed, not enforced: the policy sizes for
     the reference's 16 GB parts). (b) ``launch.roofline`` over those
     records: the tables and the dominant-term counts; no cell's
     ``roofline_frac`` (uncapped) exceeds 1, which would say its count
     fell short of the model's FLOPs. (c) The roofline
     against the card on two programs that run here: danube's bf16 prefill
     of 2 × 4608 (dense, and through the flash kernel with 24 launches) and
     one bert-large training step as in phase 5 (4 virtual ranks, 8 × 128,
     ``lumorph4``). The dry-run's global FLOPs on a 1 × 1 mesh equal
     ``FlopCounterMode``'s count of the same dense program run on the card;
     the roofline's bound (its three terms printed) does not exceed the
     measured time by more than 5 % (CUDA events for the prefills, run
     dense, kernel, dense, kernel; ``step_s`` for the step). (d) The
     example twins on the card: ``examples/torch_serve_decode.py`` (smoke
     configs, as the JAX example), ``torch_quickstart.py`` (its collectives
     exact, its losses finite) and ``torch_train_bert_lumorph.py`` (finite
     losses, the restart resuming at the step-20 checkpoint). (e) The rack
     simulator, the morph planner and the serving autoscaler, host code,
     at the sizes of the JAX package's benchmarks (``RACK_*`` below), each
     trace made by the port's generators: Fig 2a (2000 events, 64 chips,
     LUMORPH, torus, SiPAC), the Poisson trace of 300 rack-scale tenants
     (the three disciplines), the morph churn (400 events, failure rate
     0.03, 2 fibers per server pair, with and without morph), the pod
     churn (200 events, 128 chips in 2 racks, spanning and confined), the
     serving autoscaler against static provisioning (diurnal and bursty,
     128 chips, 60 s windows), the chaos and glitch-storm traces (64
     chips, 8 tiles per server) and the ``tests/golden`` traces. Each run
     twice, the two equal (the engine asserts chip conservation at every
     event); on Fig 2a LUMORPH has no fragmentation reject and more
     goodput and utilization than torus and SiPAC, on the Poisson trace
     none and an acceptance at least theirs; SiPAC(2, 3) on LUMORPH is
     exact; the golden replays equal their ``SimMetrics`` fixtures bit for
     bit; the three rack example twins run. Each run's summary, a digest
     of all its metrics and its host seconds printed.
 15. The cross-process path: one world of 4 rank processes on this card
     (``python3 chip_smoke.py --dist-rank DIR`` each, under torchrun's
     environment), once for the phase and under a timeout; any rank's
     failure fails it. Its backend is gloo, so every payload is staged
     card → host → gloo → host → card: NCCL puts no two ranks on one GPU.
     (a) bert-large as phase 5 (``TRAIN``) through ``launch.train.main``
     with ``lumorph4 --wire-dtype float32``, ``lumorph2 --compress`` and
     ``xla``: each final loss within 1e-6 relative of phase 5's run with
     the same flags (bit-equality printed), the int8 kernels launched in
     every rank's process under ``--compress``; ``step_s``, the gradient
     communication's seconds per step and peak memory per rank, labelled
     host-staged. (b) the overlapped all-reduce at 25 MB fp32 per rank,
     lumorph2, C ∈ {1, 4}, with the RMSNorm kernel as each chunk's
     consumer: bit-equal to the virtual ranks' ``overlapped_all_reduce`` of
     the same inputs on the card, within 1e-5 of RMSNorm(psum), the kernel
     launched in every rank.
 16. The model axis across processes: a second world of 4 rank processes on
     this card over gloo (``python3 chip_smoke.py --tp-rank DIR``), laid out
     as data 2 × model 2 (``launch.mesh.split_model_axis``), every param,
     optimizer and batch leaf a DTensor placed by the sharding policy. (a)
     bert-large at full width (8 × 128, ``TP_STEPS`` steps) through
     ``launch.train.main --data-parallel 2`` with ``xla`` and ``lumorph4``
     (fp32 wire) and ``lumorph2 --compress``: each final loss within 1e-4
     relative (1e-3 under ``--compress``) of the same flags run here first
     on 2 virtual ranks with a model axis of 1 (the TP partial sums add in
     another order), the int8 kernels launched in every rank under
     ``--compress``; per rank ``step_s``, the gradient communication's
     seconds and the peak memory, labelled host-staged. (b)
     h2o-danube-1.8b at full width, fp32 params from seed 0 (phase 3's
     draws), placed by the policy (16 query and 4 KV heads per rank):
     prefills of 2 × 4608 tokens in fp32 and bf16 through ``make_prefill``
     with the flash kernel, exactly 24 launches per prefill in every rank on
     its local ``[1, 4608, 16, 80]``; the logits gathered on rank 0 against
     phase 3's kernel-path logits within ``PREFILL_TOL``, the argmax
     agreement printed, and each rank's prefill seconds beside phase 3's.
     (c) The production meshes' layout in the same world: the multi-pod mesh
     cut to 4 ranks (``launch.mesh.lay_out_mesh``, a ``DeviceMesh`` with dims
     ``("pod", "data", "model")`` whose gradient group is ``("pod", "data")``
     flattened) and ``flat_dp`` (the whole mesh data parallel). (c1)
     bert-large as (a) through ``launch.train.main --mesh multi``, its
     ``make_production_mesh`` cut to ``(pod 2, data 1, model 2)`` with
     ``xla``, ``lumorph4`` and ``lumorph2 --compress`` (each final loss held
     within 1e-6 relative of (a)'s run of the same flags, bit-equality
     printed), to ``(2, 2, 1)`` with ``xla`` and ``lumorph4`` (within 1e-6 of
     the same flags on 4 virtual ranks, phase 15's layout, run here first),
     and under ``flat_dp`` on ``(data 2, model 2)`` with ``xla`` and
     ``lumorph4`` (within 1e-4 of the same); per rank the final loss,
     ``step_s``, the communication's seconds, the peak memory and the local
     shape of one moment leaf (a quarter of it under ``xla``); the int8
     kernels launched in every rank under ``--compress``. (c2) danube as (b)
     at ``(2, 1, 2)``, its batch over pod (24 launches per prefill in every
     rank on ``[1, 4608, 16, 80]``, the logits within ``PREFILL_TOL`` of phase
     3's), and its placed decode at ``(2, 2, 1)``, batch 1, 8 + 8 in fp32, the
     KV sequence over ``("pod", "data")``, fed the tokens of the same decode in
     this one process and held to its logits within 1e-4 at every step.
 17. The rest of the model axis for the dense decoder: a third world of 4
     rank processes on this card over gloo (``python3 chip_smoke.py
     --decode-rank DIR``), after phase 16's. (a) The decode with every cache
     leaf placed by the policy's cache specs (``launch.steps.make_decode_
     step`` with a policy and a mesh), each run of ``DEC_RUNS`` fed the
     tokens of the same decode in this one process, run here first (a
     prompt replayed, then greedy tokens): the prompt replayed through
     ``serve.prefill_with_caches`` with the policy and the mesh (each rank
     making only its shard of the caches), then the generated
     tokens, each step's logits gathered and held to the one process's
     within ``DEC_TOL`` (1e-4 relative in fp32, 5e-2 in bf16 and with the
     int8 cache), the greedy agreement printed. danube whole at data 1 ×
     model 4, batch 4, 8 + 8 (KV heads over model) in fp32, bf16 and with
     the int8 cache (its scales replicated over model); at data 2 × model
     2, batch 1, 8 + 4 (the sequence over data) in fp32 and bf16; glm4 at
     full width, 4 of its 40 layers, data 1 × model 4, batch 4, 8 + 8 (2 KV
     heads: the sequence over model) in fp32 and bf16. Every rank's
     local cache shapes equal ``steps.shard_shape`` of their specs; TPOT and
     peak memory per rank, labelled host-staged. (b) bert-large as phase
     16(a), its policy ZeRO-3's (``train.main(..., zero3=True)``, which
     passes ``make_policy``'s own argument): each final loss within 1e-6
     relative of phase 16's run with the same flags (bit-equality printed),
     the int8 kernels launched in every rank under ``--compress``; the
     params' local shapes as the trainer returns them (over data under
     ``xla``; replicated over data after the LUMORPH comms' first step, as
     JAX's), ``step_s``, the communication's seconds and the peak memory per
     rank beside phase 16's.
 18. The MoE and MLA block kinds on the model axis: a fourth world of 4 rank
     processes on this card over gloo (``python3 chip_smoke.py --moe-rank
     DIR``), its references run here first (every MoE call's router gaps
     recorded), each arch's params built once per process. (a)
     deepseek-v2-lite-16b at full width, its first 3 of 27 layers, as the
     JAX package has it (``tests/jax_twin.py``: capacity dispatch, fp32
     params; the placed MoE refuses the published model's dropless routing): the prefill of 1 × 512 at data 1 × model 4 (16 experts and 4
     heads per rank) in fp32; decodes of 8 + 8 through the placed step, fed
     the one process's tokens, at 1 × 4 batch 4 in fp32 and bf16 and at 2 × 2
     batch 1 in fp32 (``c_kv``'s sequence over model, ``pos`` over data). (b)
     dbrx-132b at full width, 1 of its 40 layers, bf16 params, at 1 × 4 (4
     experts, 12 query and 2 KV heads per rank): the prefill of 1 × 1024
     through the flash kernel in fp32 and bf16, one launch per layer in
     every rank on ``[1, 1024, 12, 128]``, layer 0's bf16 attention within
     5e-2 of one process; a decode of 8 + 8 at batch 4 in fp32 (KV heads over
     model). fp32 logits within 1e-4 relative of one process on every row
     whose tokens' router gap is at least 1e-6, the rows under it printed
     with their errors (those past 1e-4 fewer than 1 % of the rows); bf16
     printed. Local cache shapes held to ``steps.shard_shape`` of their
     specs; TPOT and peak memory per rank. (c) deepseek at full width, 2
     layers, fp32, trained by ``launch.train.main --data-parallel 2`` with
     ``xla`` and ``lumorph4``, 4 × 128, 2 steps: each final loss within 1e-5
     relative of the same flags on 2 virtual ranks (1e-4 where that run has
     a token under the 1e-6 gap); ``step_s``, communication seconds and peak
     memory per rank. Then, in the same world, the SSM, hybrid,
     encoder-decoder and VLM kinds, fp32 params from seed 0, each held to
     this one process's run of the same inputs: (d) zamba2-1.2b whole (38
     layers; 16 of its 64 SSM heads and 8 of its 32 attention heads per
     rank at model 4): the prefill of 1 × 1024 through the flash kernel, 6
     launches per rank (one per shared-block site) on ``[1, 1024, 8, 64]``,
     within 1e-4; decodes of 8 + 8 at 1 × 4, batch 4, in fp32 (within 1e-4)
     and bf16 (within 5e-2, or within its plain-vs-plain control, the
     one-process bf16 decode against the one-process fp32 decode fed the
     same tokens, where that is larger), every rank's ``h`` ``[4, 16, 64,
     64]``; (e) xlstm-125m whole decoded at 1 × 4 and whisper-tiny whole at
     1 × 4 (its 6 heads replicated, the self cache's sequence over model)
     and 2 × 2 (3 heads per rank), 8 + 8 in fp32, whisper's encoder placed
     through the kernel over 4 × 1500 frames (4 launches per rank, all 6
     heads at 1 × 4 and 3 at 2 × 2) and its cross caches filled placed;
     (f) paligemma-3b at full width, 2 of 18 layers: the prefill of 2 ×
     (256 image + 32 text) on the dense path and a decode of 8 + 8 at 1 ×
     4, fp32, within 1e-4; (g) zamba2 at full width, its first 7 layers
     (one shared-block site), trained at data 2 × model 2 with ``xla`` and
     ``lumorph4``, 4 × 128, 2 steps, fp32: each final loss within 1e-5
     relative of the same flags on 2 virtual ranks. TPOT, ``step_s``, peak
     memory and local shapes per rank, labelled host-staged.

Phase 2 also holds the RMSNorm kernel against its plain version (fp32
within 1e-5, bf16 within 2e-2, the limits of tests/test_kernels.py, or one
bf16 ulp where that is larger) on the shapes of tests/test_kernels.py, odd
widths, an overlap chunk's rows and danube's prefill rows, and times it
from a cold L2 at an overlap chunk of phase 7 and at danube's rows, beside
its plain version and ``torch.nn.functional.rms_norm``.

Phase 2 also holds the LayerNorm pair (forward, backward and the backward's
reduction of the weight gradients) against the plain fp32 layer and
autograd, at bert-large's rows (256 × 128 × 1024) in bf16 and fp32, at
whisper-tiny's and xlstm-125m's widths, at an odd width and past the
register hold: y and dx within one rounding to x's dtype or 1e-5 of their
largest value, dw and db within 1e-5 of their columns' sums of |terms|, the
limits of tests/test_torch_cuda.py. It times the forward and the backward
from a cold L2 at bert's rows in bf16, beside their HBM bound (bytes at
3.35 TB/s), the plain version and ``torch.nn.functional.layer_norm``.

Phase 2 also holds the int8 quantize/dequantize kernels against their plain
versions, equal in every bit (``torch.equal``), on the sizes of
tests/test_kernels.py, an all-zero block, exact .5 ties, a 25 MB gradient
bucket and the 31,254,528-element embedding leaf, and times both at the
bucket and the leaf sizes: each call from a cold L2 cache (``ms``), and
back-to-back calls, host gaps and a warm L2 included (``ms_back_to_back``).

Each main path is driven with the launch counters set to 0 just before it
and read just after: serving (phases 3 and 4), training (phase 5), overlap
mode (phase 7), deepseek (phase 8), dbrx (phase 9), the dense trio (phase
10, per model), the SSM models (phase 11, per model) and whisper and
paligemma (phase 12, per model), the ``--comm auto`` runs and the KIVI
decodes (phase 13), the roofline's danube prefills and the example
twins (phase 14), and each run of phases 15–18 in each rank's process. Each
phase prints its seconds. The last lines are the ``{"kernels": [...]}`` record, the run
record, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import importlib.util
import io
import json
import math
import os
import pathlib
import re
import runpy
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent

# tests/test_kernels.py ATTN_CASES: (b, sq, skv, h, kv, d, causal, window, dtype)
ATTN_CASES = [
    (2, 128, 128, 4, 4, 64, True, None, torch.float32),
    (1, 256, 256, 8, 2, 64, True, None, torch.bfloat16),
    (2, 100, 100, 4, 1, 32, True, 48, torch.float32),
    (1, 64, 192, 2, 2, 128, False, None, torch.float32),
    (1, 160, 160, 2, 2, 80, True, None, torch.float32),
    (1, 96, 96, 3, 3, 64, True, 17, torch.bfloat16),
    # bidirectional, no window, Skv ragged against the 64-key tile: only the
    # Skv mask guards the last tile (an unmasked tail would dominate the output)
    (2, 100, 100, 4, 4, 64, False, None, torch.float32),
    (1, 70, 70, 2, 2, 64, False, None, torch.float32),
]
# danube's prefill: 2 × 4608 tokens, 32 query / 8 KV heads of 80, window 4096
DANUBE = dict(b=2, sq=4608, skv=4608, h=32, kv=8, d=80, causal=True, window=4096)
# the bf16 (tensor-core) kernel on every shape above, D = 72 with a non-causal
# window, and danube's heads at a short S (tests/test_torch_cuda.py's cases)
BF16_CASES = ([(*c[:-1], torch.bfloat16) for c in ATTN_CASES if c[-1] == torch.float32] +
              [(1, 300, 300, 8, 8, 72, False, 40, torch.bfloat16),
               (2, 320, 320, 32, 8, 80, True, 256, torch.bfloat16)])
# dbrx-132b's attention in a 4096-token prefill: 48 query / 8 KV heads of 128, no window
DBRX = dict(b=1, sq=4096, skv=4096, h=48, kv=8, d=128, causal=True, window=None)
# zamba2-1.2b's shared block in a 2 × 4096-token prefill: 32/32 heads of 64, no window
ZAMBA2 = dict(b=2, sq=4096, skv=4096, h=32, kv=32, d=64, causal=True, window=None)
# the kernel entries danube's D = 80, dbrx's D = 128 and zamba2's D = 64 run, by dtype
FLASH_ENTRY = {torch.bfloat16: "flash_fwd_bf16_kernel<80>",
               torch.float32: "flash_fwd_f32_kernel<80>"}
FLASH_ENTRY_128 = {torch.bfloat16: "flash_fwd_bf16_kernel<128>",
                   torch.float32: "flash_fwd_f32_kernel<128>"}
FLASH_ENTRY_64 = {torch.bfloat16: "flash_fwd_bf16_kernel<64>",
                  torch.float32: "flash_fwd_f32_kernel<64>"}
SDPA = torch.nn.functional.scaled_dot_product_attention  # the library yardstick
# rows with no live key: Sq = 300 against Skv = 100, causal, window 48 (rows 147 on)
NO_LIVE_KEY = (1, 300, 100, 4, 2, 80, True, 48, torch.bfloat16)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # the card sums in another order
# whisper's shape, error relative to the output's RMS: the 36 zero keys an
# unmasked last tile would add shift each row by ~1.4 %, the sound bf16 kernel
# ~0.2 % (rounding); the unmasked answer must exceed the limit in the run
TAIL_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-3}
PREFILL_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
# phase 8: deepseek-v2-lite-16b; phase 9: dbrx-132b at 2 of its 40 layers
# the benchmark cell whose prompts (2 x 4096 Zipf tokens) phase 8(b) prefills, from
# DEEPSEEK_SEED, and whose token_gap limit judges them
DEEPSEEK_CELL, DEEPSEEK_SEED = "deepseek-v2-lite-16b.prefill-b2-s4096", 3000000001
DEEPSEEK_DECODE = 16  # greedy bf16 steps through the latent caches after that prefill
DEEPSEEK_REPLAY = 64  # tokens, fp32: prefill against token-by-token decode
DEEPSEEK_DEPTH2 = (("mla_dense", "mla_moe"), 256)  # layers, tokens: card against CPU
DBRX_LAYERS, DBRX_PREFILL, DBRX_DECODE = 2, (1, 4096), 8
# phase 10: the dense trio at full width; glm4-9b also serves
DENSE_TRIO, DENSE_PREFILL, DENSE_SERVED = ("phi3-medium-14b", "codeqwen1.5-7b",
                                           "glm4-9b"), (1, 4096), "glm4-9b"
# phase 11: per SSM arch, its param_count() (tests/test_torch_hybrid.py), its flash
# launches per prefill (one per shared call site) and its leading layers card vs CPU
SSM_ARCHS = {"zamba2-1.2b": dict(param_count=1_112_919_040, launches=6, lead=7),
             "xlstm-125m": dict(param_count=154_423_296, launches=0, lead=4)}
SSM_PREFILL, SSM_REPLAY, SSM_LEAD_TOKENS = (2, 4096), 64, 256
# phase 12: whisper-tiny's encoder attention (B=4, 1500 frames, 6/6 heads of 64,
# bidirectional, no window; 1500 is a multiple of neither the 64-key tile nor the
# 192-row query block), its fp32 decoder replay, and its serving example
WHISPER = dict(b=4, sq=1500, skv=1500, h=6, kv=6, d=64, causal=False, window=None)
WHISPER_REPLAY = 10
WHISPER_SERVE = ["--batch", "4", "--gen", "24"]
# paligemma-3b: prefill of 2 × (256 image + 512 text) tokens; its first 2 layers
# card against CPU at 1 × (256 + 32)
PALIGEMMA_PREFILL, PALIGEMMA_LEAD = (2, 512), (2, 32)
SERVE = ["--batch", "4", "--prompt-len", "64", "--gen", "32"]
# phase 13: --comm auto in phase 5's settings, each against the phase 5 run that
# must end on the same loss; the KIVI decode on danube; its logits limit
AUTO_RUNS = [("auto", ["--comm", "auto", "--wire-dtype", "float32"], "lumorph4"),
             ("auto+int8", ["--comm", "auto", "--compress"], "lumorph2+int8")]
KIVI = dict(batch=4, prompt=64, gen=32)
KIVI_TOL = PREFILL_TOL["bfloat16"]
# phase 14: the roofline against the card; no card beats its bound, 5 % for timing
ROOFLINE_PREFILL = (2, 4608)  # danube, as phase 3
ROOFLINE_FRAC_MAX = 1.05
DRYRUN_MESHES = ("single", "multi")
DRYRUN_WORKERS = 6  # processes sharing out the dry-run's cells (the card host has 8 cores)
BERT_LUMORPH_CKPT = ROOT / "build" / "chip_smoke_bert_lumorph"  # gitignored; removed
# phase 14(e): the rack simulator, the morph planner and the serving autoscaler on the
# host, at the sizes of the JAX package's benchmarks (the constants of its
# fig2a_fragmentation, sim_morph, sim_pod, sim_serve and sim_chaos benchmarks)
RACK_SEED = 0
RACK_KINDS = ("lumorph", "torus", "sipac")
RACK_FIG2A = dict(events=2000, chips=64)
# the Poisson trace of sim_rack: 300 jobs, the Fig 2a mix widened to rack-scale tenants
RACK_POISSON = dict(jobs=300, chips=64, arrival_rate=0.25, mean_steps=15.0, compute_s=1.0,
                    coll_bytes=float(1 << 20), failure_rate=0.005,
                    sizes=(1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32, 48, 64))
RACK_MORPH = dict(events=400, chips=64, failure_rate=0.03, fibers=2)
RACK_POD = dict(events=200, chips=128, racks=2, failure_rate=0.01)
# two serving tenants of a 7B-class TP=4 profile, staggered peaks, a 2-hour day
RACK_SERVE = dict(chips=128, window_s=60.0, horizon_s=7200.0, prompt=2048.0, output=256.0,
                  slo_ttft_s=3.0, slo_tpot_s=0.05, burst_mult=1.8, p_burst=1.0 / 40.0,
                  mean_burst_windows=4.0, max_step_up=8)
RACK_SERVE_RATES = {"diurnal": (4.0, 72.0), "bursty": (8.0, 40.0)}  # (base, peak) req/s
RACK_SERVE_PROFILE = dict(model="serve-7b", tp=4, buckets=(64e6, 64e6, 64e6, 32e6),
                          algos=("ring",) * 4, tp_bytes=4096 * 2048 * 2.0,
                          tp_collectives=128, compute_scale=2.6)
# serving arms: (rho target, the rate each tenant is provisioned for, autoscaled)
RACK_SERVE_ARMS = {"auto": (0.9, "first", True), "static_mean": (0.7, "mean", False),
                   "static_peak": (0.7, "peak", False)}
RACK_CHAOS = dict(events=400, storm_events=200, chips=64, tiles=8, fibers=2)
RACK_GOLDEN = ROOT / "tests" / "golden"
# fixture -> (trace file, simulator arguments), as tests/golden/regen.py
RACK_GOLDEN_RUNS = {
    "fig2a_small_static": ("trace_0", dict(n_chips=64, fibers_per_server_pair=2)),
    "fig2a_small_morph": ("trace_0", dict(n_chips=64, fibers_per_server_pair=2, morph=True)),
    "pod_small_morph": ("trace_1", dict(n_chips=64, n_racks=2, morph=True)),
    "pod_small_confined": ("trace_1", dict(n_chips=64, n_racks=2, span_racks=False)),
}
RACK_TWINS = ("torch_simulate_rack", "torch_morph_rack", "torch_multi_tenant_rack")
RACK_TMP = ROOT / "build" / "chip_smoke_rack"  # gitignored; the twins' temporary files
# H100 SXM published dense peaks (NVIDIA data sheet): fp32 on the CUDA cores,
# bf16 on the tensor cores; HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# the fp32 flash kernel runs each product as three TF32 tensor-core products
# (3xTF32): its least time is its FLOPs at a third of the 495 TFLOP/s TF32 peak
TF32X3_FLOPS = 495e12 / 3
HBM_BYTES_S = 3.35e12
# int8 pair: tests/test_kernels.py's sizes (normal × 5), then a 25 MB gradient
# bucket (6,553,600 fp32) and bert-large's embedding leaf (30522 × 1024)
QUANT_SIZES = [256, 1000, 65536, 12345]
BUCKET_N, LEAF_N = 25 * 1024 * 1024 // 4, 30522 * 1024
TRAIN = ["--arch", "bert-large", "--data-parallel", "4", "--batch", "8", "--seq", "128",
         "--steps", "6", "--log-every", "1"]
TRAIN_RUNS = [("xla", ["--comm", "xla", "--wire-dtype", "float32"]),
              ("lumorph4", ["--comm", "lumorph4", "--wire-dtype", "float32"]),
              ("lumorph2+int8", ["--comm", "lumorph2", "--compress"]),
              ("lumorph4+ovl4", ["--comm", "lumorph4", "--wire-dtype", "float32",
                                 "--overlap", "4", "--ckpt-every", "3"]),
              ("lumorph2+int8+ovl4", ["--comm", "lumorph2", "--compress", "--overlap", "4"])]
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"  # gitignored; removed after phase 5
# phase 15: the cross-process path, 4 ranks in their own processes on this card over
# gloo; its runs held to phase 5's runs of the same flags
DIST_WORLD, DIST_TIMEOUT_S, DIST_LOSS_RTOL = 4, 480, 1e-6
DIST_TRAIN_RUNS = [("lumorph4", ["--comm", "lumorph4", "--wire-dtype", "float32"]),
                   ("lumorph2+int8", ["--comm", "lumorph2", "--compress"]),
                   ("xla", ["--comm", "xla", "--wire-dtype", "float32"])]
DIST_OVL_CHUNKS = (1, 4)
DIST_DIR = ROOT / "build" / "chip_smoke_dist"  # gitignored; the ranks' results
HOST_STAGED = ("gloo, host-staged: each payload goes card -> host -> gloo -> host -> card, "
               "because NCCL puts no two ranks on one GPU; not the paper's link, not NVLink")
# phase 16: the model axis, 4 ranks on this card over gloo as data 2 x model 2; its
# training runs held to the same flags on 2 virtual ranks (model 1), its prefills to
# phase 3's kernel-path logits
TP_DATA, TP_STEPS, TP_TIMEOUT_S = 2, 2, 480
TP_TRAIN = ["--arch", "bert-large", "--data-parallel", str(TP_DATA), "--batch", "8",
            "--seq", "128", "--steps", str(TP_STEPS), "--log-every", "100"]
TP_TRAIN_RUNS = [("xla", ["--comm", "xla", "--wire-dtype", "float32"], 1e-4),
                 ("lumorph4", ["--comm", "lumorph4", "--wire-dtype", "float32"], 1e-4),
                 ("lumorph2+int8", ["--comm", "lumorph2", "--compress"], 1e-3)]
TP_PREFILL = (2, 4608)  # danube, as phase 3
TP_LAYERS = 24  # flash launches per prefill in each rank: one per layer
TP_LOCAL_Q, TP_LOCAL_KV = [1, 4608, 16, 80], [1, 4608, 4, 80]  # each rank's heads
TP_DIR = ROOT / "build" / "chip_smoke_tp"  # gitignored; the ranks' results and logits
PHASE3_LOGITS: dict = {}  # phase 3's kernel-path logits, on the host, for phase 16
# phase 16(c): the production meshes' layout in phase 16's world. (c1) bert-large as
# phase 16(a) on the multi-pod mesh cut to 4 ranks (launch.train.main --mesh multi, its
# make_production_mesh cut so) and under flat_dp ((data 2, model 2), the data entry
# ("data", "model")): name -> (mesh, comm of TP_TRAIN_RUNS, reference, relative limit).
# "tp": phase 16(a)'s run of the same flags (data 2 x model 2, this world); "dp4": the
# same flags on 4 virtual ranks, phase 15's layout, run here first at TP_STEPS
POD_AXES = ("pod", "data", "model")
POD_TRAIN_RUNS = {"212/xla": ((2, 1, 2), "xla", "tp", 1e-6),
                  "212/lumorph4": ((2, 1, 2), "lumorph4", "tp", 1e-6),
                  "212/lumorph2+int8": ((2, 1, 2), "lumorph2+int8", "tp", 1e-6),
                  "221/xla": ((2, 2, 1), "xla", "dp4", 1e-6),
                  "221/lumorph4": ((2, 2, 1), "lumorph4", "dp4", 1e-6),
                  "flat/xla": ("flat", "xla", "dp4", 1e-4),
                  "flat/lumorph4": ("flat", "lumorph4", "dp4", 1e-4)}
_DP = TP_TRAIN.index("--data-parallel")
POD_TRAIN = TP_TRAIN[:_DP] + TP_TRAIN[_DP + 2:]  # TP_TRAIN without its --data-parallel
POD_MOMENT = ("segments", 0, "mlp", "wi")  # the moment leaf whose local shape is printed
# (c2) danube: the TP prefill as (b) at (pod 2, data 1, model 2), the batch over pod;
# the placed decode at (pod 2, data 2, model 1), batch 1, 8 + 8 in fp32 (bf16 cache, as
# phase 17's fp32 runs), the 16 slots over ("pod", "data") and the 8 KV heads whole
POD_PREFILL_MESH, POD_DECODE_MESH = (2, 1, 2), (2, 2, 1)
POD_DECODE = dict(batch=1, prompt=8, gen=8)
POD_K_LOCAL = [1, 4, 8, 80]
POD_REF_DIR = ROOT / "build" / "chip_smoke_pod_refs"  # gitignored; the decode reference
# phase 17: the rest of the model axis for the dense decoder, a third 4-rank world on
# this card over gloo. (a) decodes with every cache leaf placed by the policy's cache
# specs, fed the one-process reference's tokens; name -> (arch, layers (None: all), data,
# batch, prompt, generated, compute dtype, KV cache). Short: with 4 ranks on one card
# every collective costs ~6-8 ms (gloo, host-staged, 4 processes on one card), and a
# danube step makes ~50 of them, 0.3-0.65 s a step
DEC_RUNS = {
    "danube_1x4_fp32": ("h2o-danube-1.8b", None, 1, 4, 8, 8, "float32", "bfloat16"),
    "danube_1x4_bf16": ("h2o-danube-1.8b", None, 1, 4, 8, 8, "bfloat16", "bfloat16"),
    "danube_1x4_int8": ("h2o-danube-1.8b", None, 1, 4, 8, 8, "bfloat16", "int8"),
    "danube_2x2_b1_fp32": ("h2o-danube-1.8b", None, 2, 1, 8, 4, "float32", "bfloat16"),
    "danube_2x2_b1_bf16": ("h2o-danube-1.8b", None, 2, 1, 8, 4, "bfloat16", "bfloat16"),
    "glm4_4l_1x4_fp32": ("glm4-9b", 4, 1, 4, 8, 8, "float32", "bfloat16"),
    "glm4_4l_1x4_bf16": ("glm4-9b", 4, 1, 4, 8, 8, "bfloat16", "bfloat16"),
}
DEC_TOL = {"float32": 1e-4, "bfloat16": 5e-2}  # relative; bf16 and int8: phases 3, 13(c)
# each run's local k leaf: KV heads over model (8 / 4), the sequence over data (12 / 2)
# with KV heads over model (8 / 2), glm4's sequence over model (2 KV heads; 16 / 4)
DEC_K_LOCAL = {"danube_1x4": [4, 16, 2, 80], "danube_2x2_b1": [1, 6, 4, 80],
               "glm4_4l_1x4": [4, 4, 2, 128]}
DEC_TIMEOUT_S = 420
DEC_DIR = ROOT / "build" / "chip_smoke_decode"  # gitignored; the ranks' results
DEC_REF_DIR = ROOT / "build" / "chip_smoke_decode_refs"  # gitignored; the references
# (b) bert-large as phase 16 under a ZeRO-3 policy (make_policy(..., zero3=True)): each
# final loss within Z3_RTOL of phase 16's run of the same flags
Z3_RTOL = 1e-6
# phase 18: the MoE and MLA block kinds on the model axis, a fourth 4-rank world on this
# card over gloo. (a) deepseek-v2-lite-16b at full width, its first 3 of 27 layers
# (mla_dense, mla_moe, mla_moe: 64 experts, 16 per rank at model 4; 16 heads, 4 per rank),
# fp32 params (6.7 GB whole, built in every rank before it keeps its shards); (b)
# dbrx-132b at full width, 1 of its 40 layers, bf16 params (9 GB whole): 4 experts, 12
# heads and 2 KV heads per rank. name -> (arch, layers, data, batch, prompt, generated,
# compute dtype); each decode fed the one-process reference's tokens
MOE_DS, MOE_DBRX = "deepseek-v2-lite-16b", "dbrx-132b"
MOE_LAYERS = {MOE_DS: 3, MOE_DBRX: 1}
MOE_PREFILL = {MOE_DS: (1, 512), MOE_DBRX: (1, 1024)}  # at data 1 x model 4
MOE_DEC_RUNS = {
    "deepseek_1x4_fp32": (MOE_DS, 1, 4, 8, 8, "float32"),
    "deepseek_1x4_bf16": (MOE_DS, 1, 4, 8, 8, "bfloat16"),
    "deepseek_2x2_b1_fp32": (MOE_DS, 2, 1, 8, 8, "float32"),
    "dbrx_1x4_fp32": (MOE_DBRX, 1, 4, 8, 8, "float32"),
}
# every local cache leaf of layer 0 (c_kv's sequence over model, pos over data at 2 x 2
# batch 1; dbrx's 8 KV heads over model), as steps.shard_shape gives it
MOE_CACHE_LOCAL = {
    "deepseek_1x4": {"c_kv": [4, 4, 512], "k_pe": [4, 16, 64], "pos": [4, 16]},
    "deepseek_2x2_b1": {"c_kv": [1, 8, 512], "k_pe": [1, 16, 64], "pos": [1, 8]},
    "dbrx_1x4": {"k": [4, 16, 2, 128], "v": [4, 16, 2, 128], "pos": [4, 16]},
}
MOE_DBRX_LOCAL = [[1, 1024, 12, 128], [1, 1024, 2, 128]]  # each rank's flash q and k
# fp32 logits, relative to the largest: held on every row whose tokens' router gaps (the
# k-th against the (k+1)-th probability, smallest over the MoE layers) are at least
# MOE_MIN_GAP; the rows under it (a TP partial sum may move such a token to another
# expert) are counted and printed with their error, and must stay under MOE_NEAR_TIE_MAX
MOE_TOL, MOE_MIN_GAP, MOE_NEAR_TIE_MAX = 1e-4, 1e-6, 0.01
MOE_ATTN_BF16_TOL = PREFILL_TOL["bfloat16"]  # layer 0's attention in bf16, as phase 9
# (c) deepseek at full width, 2 layers (mla_dense, mla_moe), data 2 x model 2, fp32: each
# final loss within MOE_TRAIN_RTOL of the same flags at model 1 (2 virtual ranks), or
# MOE_NEAR_TIE_RTOL where a token of the model-1 run has a router gap under MOE_MIN_GAP
MOE_TRAIN_LAYERS = 2
MOE_TRAIN = ["--arch", MOE_DS, "--data-parallel", "2", "--batch", "4", "--seq", "128",
             "--steps", "2", "--log-every", "100"]
MOE_TRAIN_RUNS = [("xla", ["--comm", "xla", "--wire-dtype", "float32"]),
                  ("lumorph4", ["--comm", "lumorph4", "--wire-dtype", "float32"])]
MOE_TRAIN_RTOL, MOE_NEAR_TIE_RTOL = 1e-5, 1e-4
# (d)-(g): the SSM, hybrid, encoder-decoder and VLM kinds on the model axis, in the same
# world after (a)-(c), fp32 params from seed 0. (d) zamba2-1.2b whole (38 mamba2 layers,
# the shared block at 6 sites; 64 SSM heads and 32 attention heads, 16 and 8 per rank at
# model 4): the prefill of 1 x 1024 through the flash kernel, one launch per site in
# every rank on its own heads; (e) xlstm-125m and whisper-tiny whole (whisper's 6 heads
# replicated at model 4, split 3 + 3 at model 2; its encoder placed through the kernel
# over 4 x 1500 frames); (f) paligemma-3b at full width, 2 of its 18 layers, the prefill
# of 2 x (256 image + 32 text). name -> (arch, data, batch, prompt, generated, dtype);
# each decode fed the one-process reference's tokens
HYB_Z, HYB_X, HYB_W, HYB_P = "zamba2-1.2b", "xlstm-125m", "whisper-tiny", "paligemma-3b"
HYB_LAYERS = {HYB_Z: None, HYB_X: None, HYB_W: None, HYB_P: 2}
HYB_PREFILL = {HYB_Z: (1, 1024), HYB_P: (2, 32)}  # at data 1 x model 4
HYB_DEC_RUNS = {
    "zamba2_1x4_fp32": (HYB_Z, 1, 4, 8, 8, "float32"),
    "zamba2_1x4_bf16": (HYB_Z, 1, 4, 8, 8, "bfloat16"),
    "xlstm_1x4_fp32": (HYB_X, 1, 4, 8, 8, "float32"),
    "whisper_1x4_fp32": (HYB_W, 1, 4, 8, 8, "float32"),
    "whisper_2x2_fp32": (HYB_W, 2, 4, 8, 8, "float32"),
    "paligemma_1x4_fp32": (HYB_P, 1, 4, 8, 8, "float32"),
}
# relative to the largest logit: fp32 and bf16 (phase 3's). A bf16 decode past it is
# held to its plain-vs-plain control instead: the one-process bf16 decode against the
# one-process fp32 decode fed the same tokens (the SSM drift of PERF.md section 2)
HYB_TOL = {"float32": 1e-4, "bfloat16": PREFILL_TOL["bfloat16"]}
# every local cache leaf of layer 0, as steps.shard_shape gives it: mamba2's h over its 64
# heads; mLSTM's C over its 4; whisper's cross pair whole and its self cache's sequence
# over model at 1 x 4, both over heads at 2 x 2; paligemma's one KV head: the sequence
HYB_CACHE_LOCAL = {
    "zamba2_1x4": {"h": [4, 16, 64, 64], "conv": [4, 3, 4224]},
    "xlstm_1x4": {"C": [4, 1, 384, 384], "n": [4, 4, 384], "m": [4, 4], "conv": [4, 3, 1536]},
    "whisper_1x4": {"self/k": [4, 4, 6, 64], "self/v": [4, 4, 6, 64], "self/pos": [4, 16],
                    "cross_k": [4, 1500, 6, 64], "cross_v": [4, 1500, 6, 64]},
    "whisper_2x2": {"self/k": [2, 16, 3, 64], "self/v": [2, 16, 3, 64], "self/pos": [2, 16],
                    "cross_k": [2, 1500, 3, 64], "cross_v": [2, 1500, 3, 64]},
    "paligemma_1x4": {"k": [4, 4, 1, 256], "v": [4, 4, 1, 256], "pos": [4, 16]},
}
# each rank's flash q and k, and the launches per call: zamba2's prefill (8 of 32 heads
# of 64, one per site), whisper's encode (all 6 heads at model 4, 3 at model 2, one per
# encoder layer)
HYB_FLASH = {"zamba2_prefill": ([[1, 1024, 8, 64], [1, 1024, 8, 64]], 6),
             "whisper_1x4": ([[4, 1500, 6, 64], [4, 1500, 6, 64]], 4),
             "whisper_2x2": ([[2, 1500, 3, 64], [2, 1500, 3, 64]], 4)}
# (g) zamba2 at full width, its first 7 layers (one shared-block site), fp32, trained at
# data 2 x model 2 against the same flags on 2 virtual ranks (model 1)
HYB_TRAIN_LAYERS = 7
HYB_TRAIN = ["--arch", HYB_Z, "--data-parallel", "2", "--batch", "4", "--seq", "128",
             "--steps", "2", "--log-every", "100"]
HYB_TRAIN_RTOL = 1e-5
MOE_TIMEOUT_S = 720
MOE_DIR = ROOT / "build" / "chip_smoke_moe"  # gitignored; the ranks' results
MOE_REF_DIR = ROOT / "build" / "chip_smoke_moe_refs"  # gitignored; the references
# overlap mode (phase 7): the JAX package's overlap benchmark (OVERLAP_SCRIPT and
# CLAIM_BYTES of benchmarks/bench_collective_exec.py) on 8 virtual ranks
OVL_P, OVL_D, OVL_CHUNKS = 8, 128, (2, 4, 8)
OVL_SIZES = {"bucket_25MB": BUCKET_N, "claim_256MB": 64_000_000}  # fp32 per rank
OVL_SMALL = 1024 * 1024 // 4  # 1 MB per rank: card against CPU
# RMSNorm (phase 2): tests/test_kernels.py's cases, odd widths, one overlap chunk's
# rows at 25 MB per rank (C = 4) and danube's prefill rows
RMS_CASES = [((4, 37, 512), torch.float32), ((2, 130, 768), torch.bfloat16),
             ((1, 1, 2048), torch.float32), ((512, 64), torch.float32),
             ((5, 37), torch.float32), ((3, 100), torch.bfloat16),
             ((OVL_P * BUCKET_N // 4 // OVL_D, OVL_D), torch.float32),
             ((2 * 4608, 2560), torch.bfloat16)]
# tests/test_kernels.py's limits. In bf16 a value the two versions round to
# neighbouring bf16 numbers differs by one bf16 ulp, which is above 2e-2 from
# |x| = 4 on (0.03125 in [4, 8)): the bf16 limit is one ulp of the plain value
# where that is larger. The fp32 values before the rounding differ by an ulp or so
# (another summation order); over 23.6 M danube elements a few round apart.
RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# the timed shapes: one chunk of phase 7's 256 MB call at C = 4, and danube's rows
RMS_TIMED = {"overlap_chunk": ((OVL_P * 64_000_000 // 4 // OVL_D, OVL_D), torch.float32),
             "danube_rows": ((2 * 4608, 2560), torch.bfloat16)}
# the LayerNorm pair: bert-large's rows in its benchmark cell (256 × 128, d 1024) in both
# types, whisper-tiny's and xlstm-125m's widths, an odd d and a row past the register
# hold (both the scalar walk); timed at bert's rows in bf16, as its training step runs them
LN_CASES = [((256 * 128, 1024), torch.bfloat16), ((256 * 128, 1024), torch.float32),
            ((2, 300, 384), torch.bfloat16), ((3, 200, 768), torch.float32),
            ((64, 37), torch.bfloat16), ((64, 2048), torch.float32)]
LN_TIMED = ((256 * 128, 1024), torch.bfloat16)
# launches of one bert-large training step on one rank: 49 norms forward (two a block
# and the embeddings'), 48 again in the blocks' recomputation, 49 backward, each backward
# with its reduction of the weight gradients' partials
LN_STEP = {"layernorm_fwd": 97, "layernorm_bwd": 49, "layernorm_bwd_reduce": 49}


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(fn, reps: int) -> float:
    """Mean device time of one ``fn()`` from a cold L2 cache, after one warm-up.

    Before each call a 256 MB read evicts the 50 MB L2, and a ~1 ms spin on
    the card (``torch.cuda._sleep``) holds the stream while the host queues
    the events and every kernel of the call, so the events time its device
    work alone, reading from device memory as the bound assumes. The flush
    reads rather than writes: a write would leave L2 full of dirty lines that
    the timed call would have to write back. (Back-to-back calls on a
    bucket-sized input would read it from L2.)"""
    flush = torch.ones(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    fn()
    pairs = []
    for _ in range(reps):
        flush.sum()
        torch.cuda._sleep(2_000_000)  # clock cycles: ~1 ms at the H100's ~2 GHz
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 numbers (7 stored mantissa bits) at |t|, normal range."""
    return torch.exp2(torch.floor(torch.log2(t.abs().clamp(min=2.0 ** -126))) - 7)


def live_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """(query, key) pairs the mask keeps: the work this input needs."""
    q = torch.arange(sq, dtype=torch.int64)
    hi = torch.clamp(q + 1, max=skv) if causal else torch.full_like(q, skv)
    lo = torch.clamp(q - window + 1, min=0) if window else torch.zeros_like(q)
    return int(torch.clamp(hi - lo, min=0).sum())


def attention_bound(b, sq, skv, h, kv, d, causal, window, dtype,
                    peak: float | None = None) -> tuple[float, str]:
    """Least time for one call: 4·D FLOPs per live pair at ``peak`` (the
    type's peak by default), against q, k, v read once and o written once at
    the HBM rate."""
    flops = 4 * d * b * h * live_pairs(sq, skv, causal, window)
    nbytes = (2 * b * sq * h * d + 2 * b * skv * kv * d) * torch.finfo(dtype).bits // 8
    t_ops, t_bytes = flops / (peak or PEAK_FLOPS[dtype]), nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def entry_name(mangled: str) -> str:
    """A kernel entry's readable name from its mangled one: the kernel's name
    and its int, bool, float and bf16 template arguments
    (``flash_fwd_bf16_kernel<80>``, ``rmsnorm_kernel<bf16, true>``)."""
    i = 3 if mangled.startswith("_ZN") else 2 if mangled.startswith("_Z") else len(mangled)
    name = ""
    while i < len(mangled) and mangled[i].isdigit():  # <length><identifier> pieces
        n = re.match(r"\d+", mangled[i:]).group()
        name = mangled[i + len(n):i + len(n) + int(n)]
        i += len(n) + int(n)
    if not name:
        return mangled
    rest = mangled[i:]
    args, i = [], 1
    while rest.startswith("I") and i < len(rest) and rest[i] != "E":
        num = re.match(r"L([ib])(-?\d+)E", rest[i:])
        if num:
            args.append(num.group(2) if num.group(1) == "i" else
                        ("false", "true")[int(num.group(2))])
            i += num.end()
        elif rest.startswith("13__nv_bfloat16", i):
            args.append("bf16")
            i += len("13__nv_bfloat16")
        elif rest[i] == "f":
            args.append("f32")
            i += 1
        else:
            break
    return f"{name}<{', '.join(args)}>" if args else name


def ptxas_report(log: pathlib.Path) -> dict:
    """Per kernel entry, from nvcc's -Xptxas=-v log: registers, stack frame and
    spill bytes (dynamic shared memory is set at launch: see ``launch_info``)."""
    entries, entry = {}, "?"
    for line in log.read_text().splitlines() if log.exists() else []:
        if "Compiling entry function" in line:
            entry = entry_name(re.search(r"'(\w+)'", line).group(1))
            entries[entry] = {}
        elif "bytes stack frame" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            entries.setdefault(entry, {}).update(stack_bytes=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif "Used" in line and "registers" in line:
            entries.setdefault(entry, {})["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    spills = [k for k, e in entries.items() if e.get("spill_stores") or e.get("spill_loads")]
    return {"entries": entries, "spilling": spills}


def sass_counts(lib: pathlib.Path, nvcc: str) -> dict:
    """Tensor-core (HMMA: mma.sync; HGMMA: wgmma) and fp32 FMA (FFMA)
    instructions per kernel entry of a built library, by ``cuobjdump -sass``
    (from the toolkit beside nvcc)."""
    exe = pathlib.Path(nvcc).with_name("cuobjdump")
    if not exe.exists():
        raise RuntimeError(f"cuobjdump not found beside nvcc at {exe}")
    sass = subprocess.run([str(exe), "-sass", str(lib)], check=True, capture_output=True,
                          text=True, timeout=120).stdout
    counts, entry = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            entry = entry_name(fn.group(1))
            counts[entry] = {"HMMA": 0, "HGMMA": 0, "FFMA": 0}
        elif entry:
            op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", line)
            if op and op.group(1) in counts[entry]:
                counts[entry][op.group(1)] += 1
    return counts


def randn_qkv(gen, b, sq, skv, h, kv, d, dtype):
    def mk(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return mk(b, sq, h, d), mk(b, skv, kv, d), mk(b, skv, kv, d)


def phase_kernels(ops) -> dict:
    """Phase 2: the flash-attention kernels against their plain version."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = []
    cases = ATTN_CASES + BF16_CASES + [(*s.values(), dt) for s in (DANUBE, DBRX, ZAMBA2)
                                       for dt in (torch.float32, torch.bfloat16)]
    for b, sq, skv, h, kv, d, causal, window, dt in cases:
        q, k, v = randn_qkv(gen, b, sq, skv, h, kv, d, dt)
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        plain = ops.flash_attention_plain(q, k, v, causal=causal, window=window)
        err = float((out.float() - plain.float()).abs().max())
        shape = [b, sq, skv, h, kv, d, causal, window]
        checks.append({"shape": shape, "dtype": str(dt).removeprefix("torch."),
                       "max_abs_err": err, "tol": TOL[dt]})
        assert torch.isfinite(out).all(), shape
        assert err <= TOL[dt], (shape, dt, err)
    # rows that see no key: exactly 0 from the kernel (the plain version averages v)
    b, sq, skv, h, kv, d, causal, window, dt = NO_LIVE_KEY
    q, k, v = randn_qkv(gen, b, sq, skv, h, kv, d, dt)
    out = ops.flash_attention(q, k, v, causal=causal, window=window).float()
    plain = ops.flash_attention_plain(q, k, v, causal=causal, window=window).float()
    dead = torch.arange(sq, device="cuda") - (window - 1) >= skv
    err = float((out[:, ~dead] - plain[:, ~dead]).abs().max())
    checks.append({"shape": list(NO_LIVE_KEY[:-1]), "dtype": "bfloat16", "max_abs_err": err,
                   "tol": TOL[dt], "rows_without_key": int(dead.sum()),
                   "those_rows_zero": bool((out[:, dead] == 0).all())})
    assert checks[-1]["those_rows_zero"] and err <= TOL[dt], checks[-1]
    torch.cuda.synchronize()

    timed = {"danube": {}, "dbrx": {}, "zamba2": {}}
    for name, s in (("danube", DANUBE), ("dbrx", DBRX), ("zamba2", ZAMBA2)):
        for dt in (torch.float32, torch.bfloat16):
            timed[name][dt] = time_attention(ops, gen, s, dt, checks)
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return {"checks": checks, "timed": timed}


def time_attention(ops, gen, s: dict, dt, checks) -> dict:
    """The kernel, its plain version and one library call at shape ``s``, with
    the least time the card could take. The yardstick computes the same
    function on [B,H,S,D] copies with the KV heads repeated: with a window it
    takes the mask, without one ``is_causal`` (no mask where bidirectional;
    SDPA's own flash backend)."""
    q, k, v = randn_qkv(gen, s["b"], s["sq"], s["skv"], s["h"], s["kv"], s["d"], dt)
    kw = dict(causal=s["causal"], window=s["window"])
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kh = kh.repeat_interleave(s["h"] // s["kv"], dim=1)
    vh = vh.repeat_interleave(s["h"] // s["kv"], dim=1)
    if s["window"]:
        pos = torch.arange(s["sq"], device="cuda")
        keep = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < s["window"])
        library = functools.partial(SDPA, qh, kh, vh, attn_mask=keep)
        label = "attn_mask"
    else:  # no mask at all where bidirectional
        library = functools.partial(SDPA, qh, kh, vh, is_causal=s["causal"])
        label = "is_causal" if s["causal"] else "no mask"
    # the fp32 kernel's products run on the tensor cores as 3xTF32; its bound
    # at the CUDA cores' FMA peak stays beside it as ``fma_bound_ms``
    fp32 = dt == torch.float32
    bound_ms, bound_by = attention_bound(*s.values(), dt, TF32X3_FLOPS if fp32 else None)
    extra = {"bound_peak": "3xTF32, 495/3 TFLOP/s",
             "fma_bound_ms": attention_bound(*s.values(), dt)[0]} if fp32 else {}
    flops = 4 * s["d"] * s["b"] * s["h"] * live_pairs(s["sq"], s["skv"], s["causal"],
                                                      s["window"])
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v, **kw), 10)
    return {
        "ms": ms, "tflops": flops / ms / 1e9, "flops": flops, "bound_frac": bound_ms / ms,
        "plain_ms": cuda_ms(lambda: ops.flash_attention_plain(q, k, v, **kw), 3),
        "library_ms": cuda_ms(library, 10),
        "library": "SDPA, " + label,
        "bound_ms": bound_ms, "bound_by": bound_by, **extra,
        "max_abs_err": next(c["max_abs_err"] for c in reversed(checks)
                            if c["shape"] == list(s.values())
                            and c["dtype"] == str(dt).removeprefix("torch.")),
        "launch": ops.flash_attention_launch_info(s["d"], dt),
    }


def quant_inputs(gen, n: int) -> torch.Tensor:
    """Normal × 5 (tests/test_kernels.py); from 1024 elements on, block 0 is
    all zeros and block 1 holds exact .5 ties (amax 127 → scale 1)."""
    x = torch.randn(n, generator=gen, device="cuda") * 5
    if n >= 1024:
        x[:512] = 0
        x[256:266] = torch.tensor([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.5])
    return x


def phase_int8(ops, ref) -> dict:
    """Phase 2, int8 pair: each kernel equal in every bit to its plain version
    on the card, then timed with the plain version at the bucket and leaf sizes."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    checks = []
    for n in QUANT_SIZES + [BUCKET_N, LEAF_N]:
        x = quant_inputs(gen, n)
        q, s = ops.quantize_int8(x)
        out = ops.dequantize_int8(q, s, n)
        pq, ps = ref.quantize_int8(x)
        pout = ref.dequantize_int8(pq, ps, n)
        same = [torch.equal(q, pq), torch.equal(s, ps), torch.equal(out, pout)]
        checks.append({"n": n, "q_equal": same[0], "scales_equal": same[1],
                       "dequantized_equal": same[2],
                       "max_abs_err": float((out - pout).abs().max()),
                       "round_trip_err": float((out - x).abs().max())})
        assert all(same), checks[-1]
    torch.cuda.synchronize()
    timed = {}
    for n in (BUCKET_N, LEAF_N):
        x = quant_inputs(gen, n)
        q, s = ops.quantize_int8(x)
        per_elem = {"quantize_int8": 4 + 1 + 4 / 256, "dequantize_int8": 1 + 4 / 256 + 4}
        for name, fn, plain in (
                ("quantize_int8", lambda: ops.quantize_int8(x), lambda: ref.quantize_int8(x)),
                ("dequantize_int8", lambda: ops.dequantize_int8(q, s, n),
                 lambda: ref.dequantize_int8(q, s, n))):
            timed.setdefault(name, {})[n] = {
                "ms": cold_ms(fn, 20), "plain_ms": cold_ms(plain, 5),
                "ms_back_to_back": cuda_ms(fn, 20),
                "bound_ms": per_elem[name] * n / HBM_BYTES_S * 1e3, "bound_by": "bytes"}
        del x, q, s
    torch.cuda.empty_cache()
    print(json.dumps({"int8_library_ms": None,
                      "why": "no single PyTorch call computes per-256-block int8 "
                             "quantization with per-block scales, or its inverse"}), flush=True)
    return {"checks": checks, "timed": timed}


def phase_rmsnorm(ops, ref) -> dict:
    """Phase 2, RMSNorm: the kernel against its plain version on the card, then
    timed with the plain version and ``F.rms_norm`` from a cold L2."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    checks = []
    for shape, dt in RMS_CASES:
        x = torch.randn(shape, generator=gen, device="cuda").to(dt)
        w = torch.randn(shape[-1], generator=gen, device="cuda") * 0.2
        out = ops.fused_rmsnorm(x, w).float()
        plain = ref.reference_rmsnorm(x, w).float()
        diff = (out - plain).abs()
        limit = torch.full_like(plain, RMS_TOL[dt])
        if dt == torch.bfloat16:  # or one bf16 ulp of the plain value, whichever is larger
            limit = torch.maximum(limit, bf16_ulp(plain))
        checks.append({"shape": list(shape), "dtype": str(dt).removeprefix("torch."),
                       "max_abs_err": float(diff.max()), "tol": RMS_TOL[dt],
                       "max_err_over_limit": float((diff / limit).max())})
        assert torch.isfinite(out).all(), checks[-1]
        assert bool((diff <= limit).all()), checks[-1]
    torch.cuda.synchronize()
    timed = {}
    for key, (shape, dt) in RMS_TIMED.items():
        x = torch.randn(shape, generator=gen, device="cuda").to(dt)
        w = torch.randn(shape[-1], generator=gen, device="cuda") * 0.2
        one_plus_w = (1.0 + w).to(dt)  # the library call takes the applied weight
        rows, d = x.numel() // shape[-1], shape[-1]
        nbytes = rows * d * 2 * x.element_size() + 4 * d
        timed[key] = {
            "shape": list(shape), "dtype": str(dt).removeprefix("torch."),
            "ms": cold_ms(lambda: ops.fused_rmsnorm(x, w), 20),
            "plain_ms": cold_ms(lambda: ref.reference_rmsnorm(x, w), 5),
            "library_ms": cold_ms(lambda: torch.nn.functional.rms_norm(
                x, (d,), weight=one_plus_w, eps=ops.RMSNORM_EPS), 20),
            "bound_ms": nbytes / HBM_BYTES_S * 1e3, "bound_by": "bytes",
            "max_abs_err": max(c["max_abs_err"] for c in checks if c["dtype"] ==
                               str(dt).removeprefix("torch."))}
        del x, w, one_plus_w
        torch.cuda.empty_cache()
    return {"checks": checks, "timed": timed}


def layernorm_check(ops, ref, x, w, b, dy) -> dict:
    """The LayerNorm kernels' output and gradients in x, w and b against the plain
    fp32 layer and autograd on the same values, as tests/test_torch_cuda.py holds them:
    y and dx within one rounding to x's dtype (one bf16 ulp of the fp32 value) or 1e-5
    of their largest value; dw and db within 1e-5 of their columns' sums of |terms|
    (another order of the same fp32 sum). Returns each one's largest error over its
    limit."""
    def run(fn, *ts):
        ts = [t.detach().requires_grad_() for t in ts]
        y = fn(*ts)
        return (y.detach(), *torch.autograd.grad(y, ts, dy.to(y.dtype)))
    got = run(ops.fused_layernorm, x, w, b)
    expect = run(ref.reference_layernorm, x.float(), w, b)
    rows = dy.float().reshape(-1, dy.shape[-1])
    xhat = ((expect[0] - b) / w).reshape(rows.shape)
    terms = {"dw": (rows * xhat).abs().sum(0), "db": rows.abs().sum(0)}
    out = {}
    for name, g, e in zip(("y", "dx", "dw", "db"), got, expect):
        assert torch.isfinite(g).all(), name
        if name in terms:
            assert g.dtype == torch.float32, name
            limit = 1e-5 * terms[name]
        else:
            assert g.dtype == x.dtype and g.shape == x.shape, name
            limit = torch.full_like(e, 1e-5 * float(e.abs().max()))
            if x.dtype == torch.bfloat16:
                limit = torch.maximum(limit, bf16_ulp(e))
        out[name] = float(((g.float() - e).abs() / limit).max())
    return out


def phase_layernorm(ops, ref) -> dict:
    """Phase 2, LayerNorm: the forward and backward kernels against the plain fp32
    layer and autograd on ``LN_CASES``, then both timed from a cold L2 at bert-large's
    rows beside their HBM bound, the plain version and ``F.layer_norm``."""
    gen = torch.Generator(device="cuda").manual_seed(33)

    def inputs(shape, dt):
        x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1).to(dt)
        w = 1 + 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")
        b = 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")
        return x, w, b, torch.randn(shape, generator=gen, device="cuda").to(dt)
    checks = []
    for shape, dt in LN_CASES:
        over = layernorm_check(ops, ref, *inputs(shape, dt))
        checks.append({"shape": list(shape), "dtype": str(dt).removeprefix("torch."),
                       "err_over_limit": over})
        assert all(v <= 1.0 for v in over.values()), checks[-1]
        torch.cuda.empty_cache()
    shape, dt = LN_TIMED
    x, w, b, dy = inputs(shape, dt)
    rows, d = x.numel() // shape[-1], shape[-1]
    xg, wg, bg = (t.clone().requires_grad_() for t in (x, w, b))
    y = ops.fused_layernorm(xg, wg, bg)
    y_plain = ref.reference_layernorm(xg, wg, bg)
    y_lib = torch.nn.functional.layer_norm(xg, (d,), wg.to(dt), bg.to(dt), ops.LAYERNORM_EPS)

    def grads(out):
        return lambda: torch.autograd.grad(out, (xg, wg, bg), dy, retain_graph=True)
    # forward: x in, y out; backward: x and dy in, dx out (w, b, dw, db and the rows'
    # statistics and partials, under 4 MB, left out)
    fwd_bytes, bwd_bytes = 2 * rows * d * x.element_size(), 3 * rows * d * x.element_size()
    timed = {"shape": list(shape), "dtype": str(dt).removeprefix("torch."), "bound_by": "bytes"}
    for key, nbytes, fns in (
            ("forward", fwd_bytes, (lambda: ops.fused_layernorm(xg, wg, bg),
                                    lambda: ref.reference_layernorm(xg, wg, bg),
                                    lambda: torch.nn.functional.layer_norm(
                                        xg, (d,), wg.to(dt), bg.to(dt), ops.LAYERNORM_EPS))),
            ("backward", bwd_bytes, (grads(y), grads(y_plain), grads(y_lib)))):
        ms, plain_ms, library_ms = (cold_ms(fn, n) for fn, n in zip(fns, (20, 5, 20)))
        bound_ms = nbytes / HBM_BYTES_S * 1e3
        timed[key] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": bound_ms, "bound_frac": bound_ms / ms}
    del x, w, b, dy, xg, wg, bg, y, y_plain, y_lib
    torch.cuda.empty_cache()
    return {"checks": checks, "timed": timed}


def phase_overlap(ops, ref, collectives) -> dict:
    """Phase 7: overlap mode on 8 virtual ranks, lumorph2, the RMSNorm kernel as
    each chunk's consumer; monolithic against C ∈ {2, 4, 8} at two sizes."""
    w = torch.zeros(OVL_D, device="cuda")

    def compute(y):
        return ops.fused_rmsnorm(y.reshape(-1, OVL_D), w).reshape(y.shape)
    mono_program = collectives.compile_schedule(
        collectives.schedule_for_execution("lumorph2", OVL_P), OVL_P)
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for name, n in OVL_SIZES.items():
        x = torch.randn(OVL_P, n, generator=gen, device="cuda")
        expect = ref.reference_rmsnorm(x.sum(0).reshape(-1, OVL_D), w).reshape(-1)
        runs = {}
        for C in (1, *OVL_CHUNKS):
            if C == 1:
                fn = lambda: compute(mono_program(x))  # noqa: E731
            else:
                fn = collectives.make_overlapped_all_reduce(OVL_P, "lumorph2", C, compute)
                fn = functools.partial(fn, x)
            n0 = ops.LAUNCHES["rmsnorm"]
            y = fn()
            launches = ops.LAUNCHES["rmsnorm"] - n0
            rel = float((y - expect).abs().max() / expect.abs().max())
            assert y.shape == x.shape and torch.isfinite(y).all(), (name, C)
            assert launches == C, (name, C, launches)
            assert rel <= 1e-5, (name, C, rel)
            del y
            runs["mono" if C == 1 else f"c{C}"] = {
                "ms": cuda_ms(fn, 3), "rel_err": rel, "rmsnorm_launches_per_call": launches}
        plain = collectives.overlapped_all_reduce(x, "lumorph2", 1)
        assert torch.equal(plain, mono_program(x)), name  # the wave split adds no arithmetic
        runs["bytes_per_rank"] = 4 * n
        out[name] = runs
        print(json.dumps({"overlap": name, **runs}), flush=True)
        del x, expect, plain
        torch.cuda.empty_cache()
    small = torch.randn(OVL_P, OVL_SMALL, generator=torch.Generator().manual_seed(6))
    card = collectives.overlapped_all_reduce(small.cuda(), "lumorph2", 4)
    out["small_card_equals_cpu"] = torch.equal(
        card.cpu(), collectives.overlapped_all_reduce(small, "lumorph2", 4))
    assert out["small_card_equals_cpu"]
    torch.cuda.synchronize()
    return out


def phase_train(train) -> dict:
    """Phase 5: bert-large data-parallel training at full width, three comms."""
    runs = {}
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    for name, flags in TRAIN_RUNS:
        if "--ckpt-every" in flags:
            flags = flags + ["--ckpt-dir", str(CKPT_DIR)]
        torch.cuda.reset_peak_memory_stats()
        res = train.main(TRAIN + flags)
        torch.cuda.synchronize()
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(json.dumps({"train": name, **res}), flush=True)
        runs[name] = res
        torch.cuda.empty_cache()
        assert res["steps"] == 6 and all(math.isfinite(res[k]) for k in ("first_loss",
                                                                         "final_loss")), res
    # the checkpoint round trip: drop the step-6 checkpoint, restart from step 3
    shutil.rmtree(CKPT_DIR / "step_0000000006")
    res = train.main(TRAIN + TRAIN_RUNS[3][1] + ["--ckpt-dir", str(CKPT_DIR)])
    shutil.rmtree(CKPT_DIR)
    print(json.dumps({"train": "lumorph4+ovl4 restarted at step 3", **res}), flush=True)
    assert res["steps"] == 3, res
    runs["restart_final_loss_equal"] = res["final_loss"] == runs["lumorph4+ovl4"]["final_loss"]
    base, l4, comp, l4o, compo = (runs[k]["final_loss"] for k, _ in TRAIN_RUNS)
    runs["lumorph4_vs_xla_rel"] = abs(l4 - base) / abs(base)
    runs["int8_vs_lumorph4_rel"] = abs(comp - l4) / abs(l4)
    runs["ovl4_vs_lumorph4_rel"] = abs(l4o - l4) / abs(l4)
    runs["int8_ovl4_vs_int8_rel"] = abs(compo - comp) / abs(comp)
    keys = ("lumorph4_vs_xla_rel", "int8_vs_lumorph4_rel", "ovl4_vs_lumorph4_rel",
            "int8_ovl4_vs_int8_rel", "restart_final_loss_equal")
    print(json.dumps({"train_agreement": {k: runs[k] for k in keys}}), flush=True)
    assert runs["lumorph4_vs_xla_rel"] <= 1e-4, runs
    assert runs["int8_vs_lumorph4_rel"] <= 0.05, runs
    assert runs["ovl4_vs_lumorph4_rel"] <= 1e-4, runs
    assert runs["int8_ovl4_vs_int8_rel"] <= 1e-3, runs
    assert runs["restart_final_loss_equal"], runs
    return runs


def phase_dist(runs) -> dict:
    """Phase 15: one 4-rank gloo world on this card, each rank its own process
    (``python3 chip_smoke.py --dist-rank DIR`` under torchrun's environment),
    under a timeout; any rank's failure fails the phase. (a) bert-large as
    phase 5 with each of ``DIST_TRAIN_RUNS``; (b) the overlapped all-reduce
    with the RMSNorm kernel as the consumer, against the virtual ranks."""
    print(json.dumps({"cross_process_wire": HOST_STAGED}), flush=True)
    ranks = run_ranks("--dist-rank", DIST_DIR, DIST_TIMEOUT_S)
    shutil.rmtree(DIST_DIR)
    out = {"wire": HOST_STAGED, "train": {}, "overlap": {}}
    for name, _ in DIST_TRAIN_RUNS:
        per = [rk["train"][name] for rk in ranks]
        ref = runs[name]["final_loss"]
        res = {**{k: per[0][k] for k in ("final_loss", "first_loss", "steps", "world",
                                           "dist_backend")},
               "phase5_final_loss": ref, "rel_to_phase5": abs(per[0]["final_loss"] - ref) /
               abs(ref), "bit_equal_to_phase5": per[0]["final_loss"] == ref,
               "step_s_gloo_host_staged": [x["step_s"] for x in per],
               "grad_comm_s_gloo_host_staged": [x["grad_comm_s"] for x in per],
               "peak_gb_per_rank": [x["peak_gb"] for x in per],
               "launches_per_rank": [x["launches"] for x in per],
               "phase5_step_s_virtual": runs[name]["step_s"]}
        out["train"][name] = res
        print(json.dumps({"cross_process_train": name, **res}), flush=True)
        assert all(x["final_loss"] == per[0]["final_loss"] for x in per), name
        assert res["steps"] == 6 and res["world"] == DIST_WORLD, res
        assert res["dist_backend"] == "gloo", res
        assert res["rel_to_phase5"] <= DIST_LOSS_RTOL, res
        if "--compress" in dict(DIST_TRAIN_RUNS)[name]:
            for x in per:  # the int8 kernels ran in every rank's process
                assert x["launches"]["quantize_int8"] > 0, x
                assert x["launches"]["dequantize_int8"] > 0, x
    for C in DIST_OVL_CHUNKS:
        per = [rk["overlap"][str(C)] for rk in ranks]
        res = {"chunks": C, "bytes_per_rank": 4 * BUCKET_N,
               "bit_equal_to_virtual": [x["bit_equal_to_virtual"] for x in per],
               "rel_err": max(x["rel_err"] for x in per),
               "rmsnorm_launches_per_rank": [x["rmsnorm_launches"] for x in per],
               "ms_gloo_host_staged": [x["ms"] for x in per]}
        out["overlap"][str(C)] = res
        print(json.dumps({"cross_process_overlap": res}), flush=True)
        assert all(res["bit_equal_to_virtual"]), res
        assert res["rel_err"] <= 1e-5, res
        assert all(n > 0 for n in res["rmsnorm_launches_per_rank"]), res
    return out


def run_ranks(flag: str, out_dir: pathlib.Path, timeout_s: float) -> list[dict]:
    """``python3 chip_smoke.py <flag> <out_dir>`` as the ``DIST_WORLD`` ranks
    of one world on this card (torchrun's environment, a free local port),
    under a timeout: until all exit, one fails (its peers would wait on it)
    or time runs out; then every rank still running is killed, and any
    failure fails the phase. Returns each rank's ``rank<r>.json``."""
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    with socket.socket() as sock:  # a free port on this machine for the rendezvous
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
           "WORLD_SIZE": str(DIST_WORLD), "LOCAL_WORLD_SIZE": str(DIST_WORLD),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), flag,
                               str(out_dir)], env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
             for r in range(DIST_WORLD)]
    deadline = time.monotonic() + timeout_s
    try:
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes) or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.5)
    finally:
        for p in procs:  # every rank stops here
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    assert codes == [0] * DIST_WORLD, f"the {flag} ranks exited with {codes}"
    return [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(DIST_WORLD)]


@contextlib.contextmanager
def timed_grad_comm(steps_lib, comm_s: list):
    """The train step's spans as they are; ``train/grad_comm``, the step's
    gradient communication, also timed once per step, alike for every comm."""
    span = steps_lib.record_function

    @contextlib.contextmanager
    def timed_span(label):
        with span(label):
            if label != "train/grad_comm":
                yield
                return
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            comm_s.append(time.perf_counter() - t0)

    steps_lib.record_function = timed_span
    try:
        yield
    finally:
        steps_lib.record_function = span


def rank_train(train, ops, runs, extra: list, zero3=None, flat_dp=False) -> dict:
    """Each of ``runs`` (name, flags, ...) through ``train.main`` in this rank's
    process, under ``make_policy``'s ``zero3`` and ``flat_dp``: its result, the
    kernel launches, the gradient communication's seconds per step and the
    peak memory."""
    from repro_torch.launch import steps as steps_lib
    out, comm_s = {}, []
    with timed_grad_comm(steps_lib, comm_s):
        for name, flags, *_ in runs:
            comm_s.clear()
            for k in ops.LAUNCHES:
                ops.LAUNCHES[k] = 0
            torch.cuda.reset_peak_memory_stats()
            res = train.main(extra + flags + ["--dist-backend", "gloo"], zero3=zero3,
                             flat_dp=flat_dp)
            torch.cuda.synchronize()
            out[name] = {**res, "launches": dict(ops.LAUNCHES),
                         "grad_comm_s": sum(comm_s) / res["steps"],
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            torch.cuda.empty_cache()
    return out


def dist_rank(out_dir: str) -> None:
    """One rank of phase 15's world: its runs, written to ``out_dir/rank<r>.json``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.core import collectives, collectives_dist
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train
    from repro_torch.launch.mesh import init_process_mesh

    torch.backends.cuda.matmul.allow_tf32 = False  # as phase 5's runs
    torch.backends.cudnn.allow_tf32 = False
    mesh = init_process_mesh("cuda", "gloo")
    out = {"rank": mesh.rank, "train": rank_train(train, ops, DIST_TRAIN_RUNS, TRAIN),
           "overlap": {}}  # (a)
    # (b): every rank makes the same x [4, n] and reduces its own row
    x = torch.randn(DIST_WORLD, BUCKET_N, generator=torch.Generator(
        device=mesh.device).manual_seed(4), device=mesh.device)
    w = torch.zeros(OVL_D, device=mesh.device)

    def compute(y):
        return ops.fused_rmsnorm(y.reshape(-1, OVL_D), w).reshape(y.shape)
    expect = ref.reference_rmsnorm(x.sum(0).reshape(-1, OVL_D), w).reshape(-1)
    for C in DIST_OVL_CHUNKS:
        fn = collectives_dist.make_overlapped_all_reduce("lumorph2", C, compute, group=mesh.group)
        ops.LAUNCHES["rmsnorm"] = 0
        y = fn(x[mesh.rank])
        torch.cuda.synchronize()
        launches = ops.LAUNCHES["rmsnorm"]
        virtual = collectives.overlapped_all_reduce(x, "lumorph2", C, compute)[mesh.rank]
        reps = []
        for _ in range(3):
            dist.barrier()
            t0 = time.perf_counter()
            fn(x[mesh.rank])
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0) * 1e3)
        out["overlap"][str(C)] = {
            "bit_equal_to_virtual": bool(torch.equal(y, virtual)), "rmsnorm_launches": launches,
            "rel_err": float((y - expect).abs().max() / expect.abs().max()),
            "ms": statistics.median(reps)}
        del y, virtual
    dist.barrier()
    dist.destroy_process_group()
    pathlib.Path(out_dir, f"rank{mesh.rank}.json").write_text(json.dumps(out))


def phase_tp(train, get_config, tf, steps_lib) -> dict:
    """Phase 16: the model axis. (a)'s references, the same flags on 2 virtual
    ranks with a model axis of 1, (c1)'s on 4 virtual ranks and (c2)'s decode
    in this one process, run here first; then one 4-rank gloo world as data 2
    × model 2 (``python3 chip_smoke.py --tp-rank DIR``), under a timeout, any
    rank's failure failing the phase: (a) bert-large trained by
    ``launch.train.main`` with each of ``TP_TRAIN_RUNS``; (b) danube's TP
    prefills, rank 0's gathered logits held against phase 3's; (c) the
    production meshes' layout (``phase_pod``)."""
    from repro_torch.models import layers
    refs, dp4 = {}, {}
    for name, flags, _ in TP_TRAIN_RUNS:
        refs[name] = train.main(TP_TRAIN + flags)
        torch.cuda.empty_cache()
    # (c1)'s placed runs are DTensors, whose LayerNorm is the plain version; their
    # virtual-rank references take it too, so that the two are held bit for bit
    on_card, layers.on_card = layers.on_card, lambda x: False
    try:
        for name in sorted({c for _, c, kind, _ in POD_TRAIN_RUNS.values() if kind == "dp4"}):
            dp4[name] = train.main(POD_TRAIN + dict((n, f) for n, f, _ in TP_TRAIN_RUNS)[name]
                                   + ["--data-parallel", str(DIST_WORLD)])
            torch.cuda.empty_cache()
    finally:
        layers.on_card = on_card
    dev = torch.device("cuda")
    shutil.rmtree(POD_REF_DIR, ignore_errors=True)
    POD_REF_DIR.mkdir(parents=True)
    cfg = get_config("h2o-danube-1.8b").replace(compute_dtype="float32")
    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    tokens, logits, tpot, _ = _decode_ref(steps_lib, tf, cfg, params, POD_DECODE["batch"],
                                          POD_DECODE["prompt"], POD_DECODE["gen"])
    torch.save({"tokens": tokens.cpu(), "logits": logits.cpu()}, POD_REF_DIR / "decode.pt")
    del params, tokens, logits
    torch.cuda.empty_cache()
    ranks = run_ranks("--tp-rank", TP_DIR, TP_TIMEOUT_S)
    shutil.rmtree(POD_REF_DIR)
    out = {"wire": HOST_STAGED, "mesh": {"data": TP_DATA, "model": DIST_WORLD // TP_DATA},
           "train": {}, "prefill": {}}
    for name, flags, tol in TP_TRAIN_RUNS:  # (a)
        per = [rk["train"][name] for rk in ranks]
        ref = refs[name]["final_loss"]
        res = {**{k: per[0][k] for k in ("final_loss", "first_loss", "steps", "world",
                                           "dist_backend", "data", "model")},
               "model1_final_loss": ref, "rel_to_model1": abs(per[0]["final_loss"] - ref) /
               abs(ref), "tol": tol, "model1_step_s_virtual": refs[name]["step_s"],
               "step_s_gloo_host_staged": [x["step_s"] for x in per],
               "grad_comm_s_gloo_host_staged": [x["grad_comm_s"] for x in per],
               "peak_gb_per_rank_gloo_host_staged": [x["peak_gb"] for x in per],
               "launches_per_rank": [x["launches"] for x in per]}
        out["train"][name] = res
        print(json.dumps({"tp_train": name, **res}), flush=True)
        assert all(x["final_loss"] == per[0]["final_loss"] for x in per), name
        assert math.isfinite(per[0]["final_loss"]), name
        assert res["steps"] == TP_STEPS and res["world"] == DIST_WORLD, res
        assert (res["data"], res["model"]) == (TP_DATA, DIST_WORLD // TP_DATA), res
        assert res["dist_backend"] == "gloo", res
        assert res["rel_to_model1"] <= tol, res
        if "--compress" in flags:
            for x in per:  # the int8 kernels ran in every rank's process
                assert x["launches"]["quantize_int8"] > 0, x
                assert x["launches"]["dequantize_int8"] > 0, x
    dev = torch.device("cuda")
    for dtype in ("float32", "bfloat16"):  # (b)
        per = [rk["prefill"][dtype] for rk in ranks]
        got = torch.load(TP_DIR / f"logits_{dtype}.pt").to(dev)
        expect = PHASE3_LOGITS[dtype].to(dev)
        assert got.shape == expect.shape and got.dtype == expect.dtype, (got.shape, expect.shape)
        assert torch.isfinite(got).all()
        res = {"rel_max_err_to_phase3_kernel": _rel(got, expect), "tol": PREFILL_TOL[dtype],
               "argmax_agree_to_phase3_kernel": _agree(got, expect),
               "launches_per_rank": [x["launches"] for x in per],
               "local_shapes_per_rank": [x["shapes"] for x in per],
               "prefill_s_per_rank_gloo_host_staged": [x["s"] for x in per],
               "peak_gb_per_rank": [rk["prefill_peak_gb"] for rk in ranks],
               "phase3_kernel_prefill_s": None}
        out["prefill"][dtype] = res
        print(json.dumps({"tp_prefill": dtype, **res}), flush=True)
        assert res["rel_max_err_to_phase3_kernel"] <= PREFILL_TOL[dtype], res
        for x in per:  # one launch per layer, on the rank's own heads
            assert x["launches"] == TP_LAYERS, x
            assert x["shapes"] == [[TP_LOCAL_Q, TP_LOCAL_KV]], x
        del got, expect
        torch.cuda.empty_cache()
    out["pod"] = phase_pod(ranks, out, dp4, tpot)
    shutil.rmtree(TP_DIR)
    return out


def phase_pod(ranks: list, tp: dict, dp4: dict, tpot_one_process: float) -> dict:
    """Phase 16(c), held here from the ranks' results: (c1) each run of
    ``POD_TRAIN_RUNS`` against its reference, the int8 kernels launched in
    every rank under ``--compress``, the moment leaf's local shape (a quarter
    of it under ``xla``); (c2) danube's prefill at ``(2, 1, 2)`` against phase
    3's kernel-path logits, one flash launch per layer on each rank's own heads,
    and the decode at ``(2, 2, 1)`` against this process's, every step."""
    out = {"wire": HOST_STAGED, "train": {}, "prefill": {}}
    flags_of = {n: f for n, f, _ in TP_TRAIN_RUNS}
    for name, (mesh, comm, kind, tol) in POD_TRAIN_RUNS.items():  # (c1)
        per = [rk["pod"]["train"][name] for rk in ranks]
        ref = (tp["train"][comm] if kind == "tp" else dp4[comm])["final_loss"]
        res = {"mesh": {"pod": 2, "data": mesh[1], "model": mesh[2]} if mesh != "flat" else
               {"data": 2, "model": 2, "flat_dp": True}, "comm": comm,
               **{k: per[0][k] for k in ("final_loss", "first_loss", "steps", "world",
                                           "dist_backend", "data", "model")},
               "reference": "phase 16(a), data 2 x model 2" if kind == "tp" else
               "4 virtual ranks, phase 15's layout", "reference_final_loss": ref,
               "rel_to_reference": abs(per[0]["final_loss"] - ref) / abs(ref),
               "bit_equal_to_reference": per[0]["final_loss"] == ref, "tol": tol,
               "final_loss_per_rank": [x["final_loss"] for x in per],
               "step_s_gloo_host_staged": [x["step_s"] for x in per],
               "grad_comm_s_gloo_host_staged": [x["grad_comm_s"] for x in per],
               "peak_gb_per_rank_gloo_host_staged": [x["peak_gb"] for x in per],
               "moment_local_shape_per_rank": [x["moment_local"] for x in per],
               "launches_per_rank": [x["launches"] for x in per]}
        out["train"][name] = res
        print(json.dumps({"pod_train": name, **res}), flush=True)
        assert all(x["final_loss"] == per[0]["final_loss"] for x in per), name
        assert math.isfinite(per[0]["final_loss"]), name
        assert res["steps"] == TP_STEPS and res["world"] == DIST_WORLD, res
        assert res["dist_backend"] == "gloo", res
        assert (res["data"], res["model"]) == ((4, 2) if mesh == "flat" else
                                               (2 * mesh[1], mesh[2])), res
        assert all(x.get("pod", 1) == (1 if mesh == "flat" else 2) for x in per), res
        assert res["rel_to_reference"] <= tol, res
        if comm == "xla":  # ZeRO-1: the moments split over the data axes, a quarter each
            assert all(4 * math.prod(x["moment_local"]) == x["moment_numel"] for x in per), res
        if "--compress" in flags_of[comm]:
            for x in per:  # the int8 kernels ran in every rank's process
                assert x["launches"]["quantize_int8"] > 0, x
                assert x["launches"]["dequantize_int8"] > 0, x
    dev = torch.device("cuda")
    for dtype in ("float32", "bfloat16"):  # (c2) the prefill
        per = [rk["pod"]["prefill"][dtype] for rk in ranks]
        got = torch.load(TP_DIR / f"pod_logits_{dtype}.pt").to(dev)
        expect = PHASE3_LOGITS[dtype].to(dev)
        assert got.shape == expect.shape and got.dtype == expect.dtype, (got.shape, expect.shape)
        assert torch.isfinite(got).all()
        res = {"mesh": dict(zip(POD_AXES, POD_PREFILL_MESH)),
               "rel_max_err_to_phase3_kernel": _rel(got, expect), "tol": PREFILL_TOL[dtype],
               "argmax_agree_to_phase3_kernel": _agree(got, expect),
               "launches_per_rank": [x["launches"] for x in per],
               "local_shapes_per_rank": [x["shapes"] for x in per],
               "prefill_s_per_rank_gloo_host_staged": [x["s"] for x in per]}
        out["prefill"][dtype] = res
        print(json.dumps({"pod_prefill": dtype, **res}), flush=True)
        assert res["rel_max_err_to_phase3_kernel"] <= PREFILL_TOL[dtype], res
        for x in per:  # one launch per layer, on the rank's rows and heads
            assert x["launches"] == TP_LAYERS, x
            assert x["shapes"] == [[TP_LOCAL_Q, TP_LOCAL_KV]], x
        del got, expect
        torch.cuda.empty_cache()
    per = [rk["pod"]["decode"] for rk in ranks]  # (c2) the decode
    res = {"mesh": dict(zip(POD_AXES, POD_DECODE_MESH)), **POD_DECODE,
           "compute_dtype": "float32", "kv_cache": "bfloat16", "tol": DEC_TOL["float32"],
           "steps_compared": per[0]["steps"], "rel_max_err_per_rank": [x["rel"] for x in per],
           "greedy_agree_per_rank": [x["agree"] for x in per],
           "k_local_per_rank": [x["local"]["k"] for x in per],
           "k_placements_per_rank": [x["k_placements"] for x in per],
           "cache_shapes_as_spec_per_rank": [x["shapes_ok"] for x in per],
           "flash_launches_per_rank": [x["launches"]["flash_attention"] for x in per],
           "tpot_s_per_rank_gloo_host_staged": [x["tpot_s"] for x in per],
           "tpot_s_one_process": tpot_one_process,
           "peak_gb_per_rank": [x["peak_gb"] for x in per]}
    out["decode"] = res
    print(json.dumps({"pod_decode": "danube_221_b1_fp32", **res}), flush=True)
    assert all(x["steps"] == POD_DECODE["gen"] + 1 and x["finite"] for x in per), res
    assert max(res["rel_max_err_per_rank"]) <= DEC_TOL["float32"], res
    assert all(res["cache_shapes_as_spec_per_rank"]), res
    assert all(k == POD_K_LOCAL for k in res["k_local_per_rank"]), res
    assert all(p == "(Shard(dim=1), Shard(dim=1), Shard(dim=2))"
               for p in res["k_placements_per_rank"]), res  # the slots over pod and data
    assert res["flash_launches_per_rank"] == [0] * DIST_WORLD, res  # decode is dense
    return out


def tp_rank(out_dir: str) -> None:
    """One rank of phase 16's world: its runs, written to ``out_dir/rank<r>.json``
    (and rank 0's gathered prefill logits beside them)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.mesh import init_process_mesh, split_model_axis
    from repro_torch.launch.steps import make_prefill
    from repro_torch.models import transformer as tf
    from repro_torch.sharding.policy import distribute_tree, gather_tree, make_policy

    torch.backends.cuda.matmul.allow_tf32 = False  # as the references' runs
    torch.backends.cudnn.allow_tf32 = False
    world = init_process_mesh("cuda", "gloo")  # kept for the phase: each run reuses it
    out = {"train": rank_train(train, ops, TP_TRAIN_RUNS, TP_TRAIN), "prefill": {}}  # (a)
    mesh = split_model_axis(world, TP_DATA)
    dev = mesh.device
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("h2o-danube-1.8b")
    gen = torch.Generator(device=dev).manual_seed(0)  # phase 3's draws
    params = tf.init_params(gen, cfg)
    tokens = torch.randint(0, cfg.vocab_size, TP_PREFILL, generator=gen, device=dev)
    placed = distribute_tree(params, make_policy(cfg, mesh).param_specs(tf.param_shapes(cfg)),
                             mesh.device_mesh)
    del params  # the rank keeps its shards alone
    torch.cuda.empty_cache()
    shapes = []
    counted = ops.flash_attention

    def seen(q, k, v, **kw):
        shapes.append([list(q.shape), list(k.shape)])
        return counted(q, k, v, **kw)
    ops.flash_attention = seen
    for dtype in ("float32", "bfloat16"):  # (b)
        c = cfg.replace(compute_dtype=dtype, use_pallas=True)
        prefill = make_prefill(c, dev, make_policy(c, mesh), mesh)
        ops.LAUNCHES["flash_attention"] = 0
        shapes.clear()
        dist.barrier()
        logits, s = _timed(prefill, placed, {"tokens": tokens})
        launches = ops.LAUNCHES["flash_attention"]
        full = gather_tree(logits)  # collective
        if mesh.rank == 0:
            torch.save(full.cpu(), pathlib.Path(out_dir, f"logits_{dtype}.pt"))
        distinct = list(dict.fromkeys(json.dumps(sh) for sh in shapes))
        out["prefill"][dtype] = {"s": s, "launches": launches,
                                 "shapes": [json.loads(sh) for sh in distinct]}
        del logits, full
        torch.cuda.empty_cache()
    ops.flash_attention = counted
    out["prefill_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del placed
    torch.cuda.empty_cache()
    out["pod"] = pod_rank(world, train, ops, cfg, tokens, out_dir)  # (c)
    dist.barrier()
    dist.destroy_process_group()
    pathlib.Path(out_dir, f"rank{mesh.rank}.json").write_text(json.dumps(out))


def pod_rank(world, train, ops, cfg, tokens, out_dir: str) -> dict:
    """Phase 16(c) in a rank of phase 16's world: (c1) bert-large with each of
    ``POD_TRAIN_RUNS`` through ``launch.train.main`` (``--mesh multi`` with the
    multi-pod mesh cut to 4 ranks, or ``flat_dp``), each run's moment leaf's
    local shape recorded; (c2) danube's prefills at ``POD_PREFILL_MESH`` (rank
    0's gathered logits written beside the results) and its placed decode at
    ``POD_DECODE_MESH``, fed the reference's tokens."""
    import torch.distributed as dist
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import lay_out_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.sharding.policy import MeshShape, distribute_tree, gather_tree, make_policy
    out = {"train": {}, "prefill": {}}
    flags_of = {n: f for n, f, _ in TP_TRAIN_RUNS}
    init, made, moment = steps_lib.init_train_state, train.make_production_mesh, []

    def recorded(*a, **k):  # the moment leaf's local shape, as the trainer places it
        params, opt = init(*a, **k)
        leaf = opt["m"]
        for key in POD_MOMENT:
            leaf = leaf[key]
        moment.append([list(leaf.to_local().shape), math.prod(leaf.shape)])
        return params, opt
    steps_lib.init_train_state = recorded
    try:
        for name, (mesh, comm, _, _) in POD_TRAIN_RUNS.items():  # (c1)
            if mesh == "flat":
                extra = POD_TRAIN + ["--data-parallel", str(TP_DATA)]
            else:
                train.make_production_mesh = lambda multi_pod=False, m=mesh: MeshShape(POD_AXES,
                                                                                       m)
                extra = POD_TRAIN + ["--mesh", "multi"]
            moment.clear()
            res = rank_train(train, ops, [(name, flags_of[comm])], extra,
                             flat_dp=mesh == "flat")[name]
            train.make_production_mesh = made
            out["train"][name] = {**res, "moment_local": moment[-1][0],
                                  "moment_numel": moment[-1][1]}
    finally:
        steps_lib.init_train_state, train.make_production_mesh = init, made
    dev = world.device
    full = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)  # (b)'s params
    mesh = lay_out_mesh(world, MeshShape(POD_AXES, POD_PREFILL_MESH))
    placed = distribute_tree(full, make_policy(cfg, mesh).param_specs(tf.param_shapes(cfg)),
                             mesh.device_mesh)
    shapes, counted = [], ops.flash_attention

    def seen(q, k, v, **kw):
        shapes.append([list(q.shape), list(k.shape)])
        return counted(q, k, v, **kw)
    ops.flash_attention = seen
    for dtype in ("float32", "bfloat16"):  # (c2) the prefill, the batch over pod
        c = cfg.replace(compute_dtype=dtype, use_pallas=True)
        prefill = steps_lib.make_prefill(c, dev, make_policy(c, mesh), mesh)
        ops.LAUNCHES["flash_attention"] = 0
        shapes.clear()
        dist.barrier()
        logits, s = _timed(prefill, placed, {"tokens": tokens})
        launches = ops.LAUNCHES["flash_attention"]
        whole = gather_tree(logits)  # collective
        if mesh.rank == 0:
            torch.save(whole.cpu(), pathlib.Path(out_dir, f"pod_logits_{dtype}.pt"))
        distinct = list(dict.fromkeys(json.dumps(sh) for sh in shapes))
        out["prefill"][dtype] = {"s": s, "launches": launches,
                                 "shapes": [json.loads(sh) for sh in distinct]}
        del logits, whole
        torch.cuda.empty_cache()
    ops.flash_attention = counted
    del placed
    c = cfg.replace(compute_dtype="float32")  # (c2) the decode, the slots over pod and data
    mesh = lay_out_mesh(world, MeshShape(POD_AXES, POD_DECODE_MESH))
    policy = make_policy(c, mesh)
    placed = distribute_tree(full, policy.param_specs(tf.param_shapes(c)), mesh.device_mesh)
    del full  # whole over model 1: the rank keeps its own copy alone
    torch.cuda.empty_cache()
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    ref = torch.load(POD_REF_DIR / "decode.pt")
    res = _placed_decode_run(c, placed, policy, mesh, ref, POD_DECODE["batch"],
                             POD_DECODE["prompt"], POD_DECODE["gen"])
    caches = steps_lib.init_placed_caches(c, policy, mesh, POD_DECODE["batch"],
                                          POD_DECODE["prompt"] + POD_DECODE["gen"])
    out["decode"] = {**res, "launches": dict(ops.LAUNCHES),
                     "k_placements": str(caches[0]["k"].placements)}
    del placed, caches
    torch.cuda.empty_cache()
    return out



def _dec_config(get_config, arch: str, layers):
    """An arch's config at full width, cut to its first ``layers`` layers."""
    cfg = get_config(arch)
    if layers is None:
        return cfg
    return cfg.replace(n_layers=layers, block_pattern=cfg.block_pattern[:layers])


def _dec_groups() -> dict:
    """The runs of phase 17(a) by (arch, layers, data): one params build each."""
    groups: dict = {}
    for name, (arch, layers, data, *_) in DEC_RUNS.items():
        groups.setdefault((arch, layers, data), []).append(name)
    return groups


def phase_decode_zero3(get_config, tf, steps_lib, tp) -> dict:
    """Phase 17: the placed decode and ZeRO-3. (a)'s references, each run's
    decode in this one process through ``make_decode_step`` (the prompt
    replayed, then greedy tokens), run here first and written with the tokens
    they fed; then one 4-rank gloo world (``python3 chip_smoke.py
    --decode-rank DIR``), under a timeout, any rank's failure failing the
    phase: (a) every run of ``DEC_RUNS`` through the placed step, fed the
    reference's tokens, each rank's gathered logits held to the reference's
    at every step; (b) bert-large with ``TP_TRAIN_RUNS`` under a ZeRO-3
    policy, held to phase 16's runs (``tp``)."""
    dev = torch.device("cuda")
    shutil.rmtree(DEC_REF_DIR, ignore_errors=True)
    DEC_REF_DIR.mkdir(parents=True)
    refs = {}
    for (arch, layers, _), names in _dec_groups().items():
        cfg = _dec_config(get_config, arch, layers)
        params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
        for name in names:
            _, _, _, b, prompt, n_gen, dtype, kv = DEC_RUNS[name]
            c = cfg.replace(compute_dtype=dtype, kv_cache_dtype=kv)
            tokens, logits, tpot, _ = _decode_ref(steps_lib, tf, c, params, b, prompt, n_gen)
            torch.save({"tokens": tokens.cpu(), "logits": logits.cpu()},
                       DEC_REF_DIR / f"{name}.pt")
            refs[name] = {"tpot_s_one_process": tpot}
            del logits, tokens
        del params
        torch.cuda.empty_cache()
    ranks = run_ranks("--decode-rank", DEC_DIR, DEC_TIMEOUT_S)
    shutil.rmtree(DEC_REF_DIR)
    out = {"wire": HOST_STAGED, "decode": {}, "zero3": {}}
    for name, (arch, layers, data, b, prompt, n_gen, dtype, kv) in DEC_RUNS.items():
        per = [rk["decode"][name] for rk in ranks]
        tol = DEC_TOL[dtype]
        res = {"arch": arch, "layers": layers, "mesh": {"data": data,
                                                          "model": DIST_WORLD // data},
               "batch": b, "prompt": prompt, "generated": n_gen, "compute_dtype": dtype,
               "kv_cache": kv, "tol": tol, "steps_compared": per[0]["steps"],
               "rel_max_err_per_rank": [x["rel"] for x in per],
               "greedy_agree_per_rank": [x["agree"] for x in per],
               "k_local_per_rank": [x["k_local"] for x in per],
               "cache_shapes_as_spec_per_rank": [x["shapes_ok"] for x in per],
               "flash_launches_per_rank": [x["launches"]["flash_attention"] for x in per],
               "tpot_s_per_rank_gloo_host_staged": [x["tpot_s"] for x in per],
               "peak_gb_per_rank": [x["peak_gb"] for x in per], **refs[name]}
        out["decode"][name] = res
        print(json.dumps({"placed_decode": name, **res}), flush=True)
        assert all(x["steps"] == n_gen + 1 for x in per), res
        assert all(x["finite"] for x in per), res
        assert max(res["rel_max_err_per_rank"]) <= tol, res
        assert all(res["cache_shapes_as_spec_per_rank"]), res
        key = name.rsplit("_", 1)[0]
        assert all(k == DEC_K_LOCAL[key] for k in res["k_local_per_rank"]), res
        assert res["flash_launches_per_rank"] == [0] * DIST_WORLD, res  # decode is dense
    for name, flags, _ in TP_TRAIN_RUNS:  # (b)
        per = [rk["train"][name] for rk in ranks]
        ref = tp["train"][name]
        res = {**{k: per[0][k] for k in ("final_loss", "first_loss", "steps", "world",
                                           "dist_backend", "data", "model")},
               "phase16_final_loss": ref["final_loss"],
               "rel_to_phase16": abs(per[0]["final_loss"] - ref["final_loss"]) /
               abs(ref["final_loss"]), "tol": Z3_RTOL,
               "bit_equal_to_phase16": per[0]["final_loss"] == ref["final_loss"],
               "local_params": per[0]["local_params"],
               "step_s_gloo_host_staged": [x["step_s"] for x in per],
               "phase16_step_s": ref["step_s_gloo_host_staged"],
               "grad_comm_s_gloo_host_staged": [x["grad_comm_s"] for x in per],
               "phase16_grad_comm_s": ref["grad_comm_s_gloo_host_staged"],
               "peak_gb_per_rank_gloo_host_staged": [x["peak_gb"] for x in per],
               "phase16_peak_gb": ref["peak_gb_per_rank_gloo_host_staged"],
               "launches_per_rank": [x["launches"] for x in per]}
        out["zero3"][name] = res
        print(json.dumps({"zero3_train": name, **res}), flush=True)
        assert all(x["final_loss"] == per[0]["final_loss"] for x in per), name
        assert res["steps"] == TP_STEPS and res["world"] == DIST_WORLD, res
        assert (res["data"], res["model"]) == (TP_DATA, DIST_WORLD // TP_DATA), res
        assert res["rel_to_phase16"] <= Z3_RTOL, res
        # xla keeps ZeRO-3's params over data; the LUMORPH comms gather them at the first
        # step and return them replicated over data, as JAX's shard_map (rep)
        for x in per:
            lp = x["local_params"]
            if name == "xla":
                assert lp["over_data"] > 0 and lp["quarter"] > 0, lp
            else:
                assert lp["over_data"] == 0, lp
        if "--compress" in flags:
            for x in per:  # the int8 kernels ran in every rank's process
                assert x["launches"]["quantize_int8"] > 0, x
                assert x["launches"]["dequantize_int8"] > 0, x
    return out


def decode_rank(out_dir: str) -> None:
    """One rank of phase 17's world: its runs, written to ``out_dir/rank<r>.json``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.bridge import flatten_with_paths
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.mesh import init_process_mesh, split_model_axis
    from repro_torch.models import transformer as tf
    from repro_torch.sharding.policy import distribute_tree, make_policy

    torch.backends.cuda.matmul.allow_tf32 = False  # as the references' runs
    torch.backends.cudnn.allow_tf32 = False
    world = init_process_mesh("cuda", "gloo")  # kept for the phase: each run reuses it
    dev = world.device
    meshes = {d: split_model_axis(world, d) for d in sorted({r[2] for r in DEC_RUNS.values()})}
    out = {"decode": {}}
    for (arch, layers, data), names in _dec_groups().items():  # (a)
        mesh, cfg = meshes[data], _dec_config(get_config, arch, layers)
        full = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
        params = distribute_tree(full, make_policy(cfg, mesh).param_specs(
            tf.param_shapes(cfg)), mesh.device_mesh)
        del full  # the rank keeps its shards alone
        torch.cuda.empty_cache()
        for name in names:
            _, _, _, b, prompt, n_gen, dtype, kv = DEC_RUNS[name]
            c = cfg.replace(compute_dtype=dtype, kv_cache_dtype=kv)
            for k in ops.LAUNCHES:
                ops.LAUNCHES[k] = 0
            res = _placed_decode_run(c, params, make_policy(c, mesh), mesh,
                                     torch.load(DEC_REF_DIR / f"{name}.pt"), b, prompt, n_gen)
            out["decode"][name] = {**res, "k_local": res["local"]["k"],
                                   "launches": dict(ops.LAUNCHES)}
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
    # (b): bert-large as phase 16 under make_policy(..., zero3=True); the params' local
    # shapes as the trainer returns them
    cfg = get_config("bert-large")
    shapes = {p: list(t.shape) for p, t in flatten_with_paths(tf.param_shapes(cfg))}
    out["train"] = rank_train(train, ops, TP_TRAIN_RUNS, TP_TRAIN, zero3=True)
    for res in out["train"].values():
        local = res.pop("local_params")
        res["local_params"] = {
            "leaves": len(local["shapes"]), "over_data": len(local["over_data"]),
            "quarter": sum(4 * math.prod(v) == math.prod(shapes[p])
                           for p, v in local["shapes"].items()),
            "local_numel": sum(math.prod(v) for v in local["shapes"].values()),
            "numel": sum(math.prod(v) for v in shapes.values()),
            "embed": local["shapes"]["embed"]}
    dist.barrier()
    dist.destroy_process_group()
    pathlib.Path(out_dir, f"rank{world.rank}.json").write_text(json.dumps(out))


@contextlib.contextmanager
def router_gaps(moe_lib, gaps: list):
    """While the block runs, every MoE call's gap between each token's k-th and
    (k+1)-th router probability, ``[B, S]``, appended to ``gaps``."""
    pick = moe_lib.top_k_lowest_index_first

    def recorded(probs, k):
        top = torch.topk(probs.detach().float(), k + 1, dim=-1).values
        gaps.append(top[..., k - 1] - top[..., k])
        return pick(probs, k)
    moe_lib.top_k_lowest_index_first = recorded
    try:
        yield
    finally:
        moe_lib.top_k_lowest_index_first = pick


def _decode_ref(steps_lib, tf, c, params, b: int, prompt: int, n_gen: int, moe_lib=None,
                enc_out=None, fed=None):
    """A decode in this one process through ``make_decode_step``: a prompt from
    seed 1 replayed, then greedy tokens (or, given ``fed``, those tokens
    throughout). Given whisper's encoder output ``enc_out``, the cross caches
    are filled from it first. Returns the
    tokens, the logits of the prompt's last step and after ``[n_gen + 1, b,
    V]``, the median TPOT and, given ``moe_lib``, each of those steps'
    smallest router gap per row ``[n_gen + 1, b]`` (over the MoE layers)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, c.vocab_size, (b, prompt + n_gen), generator=gen, device=dev)
    if fed is not None:
        tokens = fed.to(dev).clone()
    step, n = steps_lib.make_decode_step(c, dev), prompt + n_gen
    caches, logits, step_s, gaps = tf.init_caches(c, b, n, dev), [], [], []
    if enc_out is not None:
        tf.fill_cross_caches(params, enc_out, caches, c)
    for t in range(n):
        calls: list = []
        with router_gaps(moe_lib, calls) if moe_lib else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, caches = step(params, caches, tokens[:, t:t + 1], t)
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if calls:
            gaps.append(torch.stack(calls).amin(0)[:, 0])
        logits.append(out[:, -1])
        if prompt - 1 <= t < n - 1 and fed is None:  # greedy from the prompt's last token on
            tokens[:, t + 1] = out[:, -1].argmax(-1)
    logits = torch.stack(logits[prompt - 1:])
    assert torch.isfinite(logits).all()
    return (tokens, logits, statistics.median(step_s[prompt:]),
            torch.stack(gaps[prompt - 1:]) if gaps else None)


def _placed_decode_run(c, params, policy, mesh, ref: dict, b: int, prompt: int,
                       n_gen: int, enc_out=None) -> dict:
    """In a rank: the decode of ``ref`` (``_decode_ref``'s tokens and logits)
    through the placed step, the prompt replayed by ``serve.prefill_with_caches``
    with the policy and the mesh, then its tokens fed. Given whisper's placed
    encoder output ``enc_out``, each rank's shard of the cross caches is
    filled from it first, and the prompt is replayed through the step on
    them. Every step's gathered
    logits against the reference's: the error of each row relative to the
    step's largest logit, the greedy agreement, the local cache shapes against
    ``steps.shard_shape`` of their specs, TPOT and peak memory."""
    import torch.distributed as dist
    from repro_torch.launch import serve
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import transformer as tf
    from repro_torch.sharding.policy import gather_tree
    dev = mesh.device
    tokens, n = ref["tokens"].to(dev), prompt + n_gen
    step = steps_lib.make_decode_step(c, dev, policy, mesh, b, n)
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    if enc_out is None:
        logits, caches = serve.prefill_with_caches(params, {"tokens": tokens[:, :prompt]}, c,
                                                   n, dev, policy, mesh)
    else:
        caches = steps_lib.init_placed_caches(c, policy, mesh, b, n)
        tf.fill_cross_caches(params, enc_out, caches, c)
        for t in range(prompt):
            logits, caches = step(params, caches, tokens[:, t:t + 1], t)
    got, step_s = [gather_tree(logits)[:, -1]], []
    for t in range(prompt, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = step(params, caches, tokens[:, t:t + 1], t)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        got.append(gather_tree(logits)[:, -1])  # collective; not timed
    expect = ref["logits"].to(dev)
    rows = [((g.float() - e.float()).abs().amax(-1) / e.float().abs().max()).tolist()
            for g, e in zip(got, expect)]
    agree = float(torch.stack([(g.argmax(-1) == tokens[:, prompt + i]).float().mean()
                               for i, g in enumerate(got[:-1])]).mean())
    specs = policy.cache_specs(steps_lib.cache_shapes(c, b, n))
    shapes_ok = all(
        tuple(leaf.to_local().shape) == steps_lib.shard_shape(tuple(leaf.shape), spec, mesh)
        for layer, specs_l in zip(caches, specs) for leaf, spec in _cache_leaves(layer, specs_l))
    return {"steps": len(got), "rows": rows, "rel": max(max(r) for r in rows), "agree": agree,
            "finite": all(bool(torch.isfinite(g).all()) for g in got),
            "local": {k: list(leaf.to_local().shape) for k, (leaf, _) in zip(
                _cache_keys(caches[0]), _cache_leaves(caches[0], specs[0]))},
            "shapes_ok": shapes_ok, "tpot_s": statistics.median(step_s),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _cache_keys(layer: dict, prefix: str = "") -> list:
    """The ``/``-joined keys of a layer's cache leaves (whisper nests ``self``)."""
    return [p for k, v in layer.items()
            for p in (_cache_keys(v, f"{prefix}{k}/") if isinstance(v, dict) else [prefix + k])]


def _cache_leaves(layer: dict, spec: dict) -> list:
    """(leaf, spec) pairs of a layer's cache, in ``_cache_keys``' order."""
    return [pair for k, v in layer.items()
            for pair in (_cache_leaves(v, spec[k]) if isinstance(v, dict) else [(v, spec[k])])]


def _held_rows(rows, gaps: torch.Tensor, tol: float) -> dict:
    """``rows``' errors held to ``tol`` where the rows' router gaps are at least
    ``MOE_MIN_GAP``; the rows under it counted and printed with their errors,
    those of them past ``tol`` (a token that took another expert) fewer than
    ``MOE_NEAR_TIE_MAX`` of the rows."""
    rows, gaps = torch.tensor(rows).flatten(), gaps.flatten().cpu()
    near = gaps < MOE_MIN_GAP
    held = float(rows[~near].max())
    moved = int((rows[near] > tol).sum())
    return {"rel_max_err_held_rows": held, "tol": tol, "rows": rows.numel(),
            "smallest_router_gap": float(gaps.min()), "near_tie_rows": int(near.sum()),
            "near_tie_rows_past_tol": moved, "near_tie_row_errs": rows[near].tolist(),
            "ok": held <= tol and moved < MOE_NEAR_TIE_MAX * rows.numel()}


def _layer0_attention(tf, attn, apply_norm, c, embed, segment, tokens):
    """Layer 0's attention through the kernel on its own normed input: the
    first layer of the stacked ``segment``, after ``embed``'s rows of ``tokens``."""
    layer0 = tf._layers(segment, 1)[0]
    positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)[None]
    h = apply_norm(c.norm, layer0["ln1"], tf._lookup(embed, tokens).to(c.cdtype))
    return attn.attention_forward(layer0["attn"], h, positions, c, use_pallas=True)


def _moe_train_config(get_config, arch: str):
    """Phase 18(c)'s config: ``arch`` at full width, its first
    ``MOE_TRAIN_LAYERS`` layers, computing in fp32."""
    return _dec_config(get_config, arch, MOE_TRAIN_LAYERS).replace(compute_dtype="float32")


def _hybrid_train_config(get_config, arch: str):
    """Phase 18(g)'s config: ``arch`` at full width, its first
    ``HYB_TRAIN_LAYERS`` layers, computing in fp32."""
    return _dec_config(get_config, arch, HYB_TRAIN_LAYERS).replace(compute_dtype="float32")


def _hybrid_inputs(cfg, arch: str, dev) -> dict:
    """Phase 18(d)-(f)'s inputs from seed 1: the prefill's batch (paligemma's with
    its image embeds) and whisper's frames."""
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    if arch in HYB_PREFILL:
        b, s = HYB_PREFILL[arch]
        out["prefill"] = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                                  device=dev)}
        if cfg.kind == "vlm":
            out["prefill"]["image_embeds"] = torch.randn(
                (b, cfg.num_image_tokens, cfg.d_model), generator=gen, device=dev)
    if cfg.kind == "encdec":
        out["frames"] = torch.randn((4, cfg.enc_seq_len, cfg.d_model), generator=gen,
                                    device=dev)
    return out


def _hybrid_refs(get_config, tf, steps_lib, train) -> dict:
    """Phase 18(d)-(g)'s references in this one process, each arch's params freed
    before the next: the kernel-path prefills, whisper's kernel encode, the
    decodes (and zamba2's bf16 control: the one-process fp32 decode fed the bf16
    decode's tokens), then (g)'s training at model 1 on 2 virtual ranks. Saved
    under ``MOE_REF_DIR`` for the ranks; returns the timings."""
    dev = torch.device("cuda")
    refs: dict = {"prefill": {}, "decode": {}, "control": {}}
    for arch, layers in HYB_LAYERS.items():
        cfg = _dec_config(get_config, arch, layers).replace(compute_dtype="float32",
                                                            use_pallas=arch == HYB_Z)
        params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
        inp = _hybrid_inputs(cfg, arch, dev)
        saved = {k: (v.cpu() if torch.is_tensor(v) else {n: t.cpu() for n, t in v.items()})
                 for k, v in inp.items()}
        if arch in HYB_PREFILL:
            logits, s = _timed(steps_lib.make_prefill(cfg, dev), params, inp["prefill"])
            assert torch.isfinite(logits).all(), arch
            saved["logits"] = logits.cpu()
            refs["prefill"][arch] = {"prefill_s_one_process": s}
            del logits
        enc = None
        if "frames" in inp:  # whisper's encoder through the kernel, once for its decodes
            enc, s = _timed(steps_lib.make_encode(cfg.replace(use_pallas=True), dev), params,
                            inp["frames"])
            saved["enc_out"] = enc.cpu()
            refs["prefill"][arch] = {"encode_s_one_process": s}
        torch.save(saved, MOE_REF_DIR / f"{arch}_hybrid.pt")
        for name, (a, _, b, prompt, n_gen, dtype) in HYB_DEC_RUNS.items():
            if a != arch:
                continue
            c = cfg.replace(compute_dtype=dtype, use_pallas=False)
            tokens, logits, tpot, _ = _decode_ref(steps_lib, tf, c, params, b, prompt, n_gen,
                                                  enc_out=enc)
            torch.save({"tokens": tokens.cpu(), "logits": logits.cpu()},
                       MOE_REF_DIR / f"{name}.pt")
            refs["decode"][name] = {"tpot_s_one_process": tpot}
            if dtype == "bfloat16":  # the plain-vs-plain control, fed the same tokens
                _, logits32, _, _ = _decode_ref(steps_lib, tf, c.replace(compute_dtype="float32"),
                                                params, b, prompt, n_gen, fed=tokens)
                refs["control"][name] = max(_rel(g, e) for g, e in zip(logits, logits32))
            del logits, tokens
        del params, inp, enc
        torch.cuda.empty_cache()
    get = train.get_config  # (g): the first 7 layers, in fp32, at model 1
    train.get_config = functools.partial(_hybrid_train_config, get)
    try:
        refs["train"] = {name: train.main(HYB_TRAIN + flags) for name, flags in MOE_TRAIN_RUNS}
    finally:
        train.get_config = get
    torch.cuda.empty_cache()
    return refs


def _hybrid_rank(get_config, tf, steps_lib, train, ops, meshes, dev, shapes: list) -> dict:
    """Phase 18(d)-(g) in a rank of the world: the placed prefills and zamba2's
    launches of the flash kernel, whisper's placed encode, each decode of
    ``HYB_DEC_RUNS`` through the placed step, then (g)'s training."""
    import torch.distributed as dist
    from repro_torch.sharding.policy import distribute_tree, gather_tree, make_policy
    out: dict = {"prefill": {}, "decode": {}}

    def counted(fn, *args):
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        shapes.clear()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        y, s = _timed(fn, *args)
        return y, {"s": s, "launches": ops.LAUNCHES["flash_attention"],
                   "shapes": [json.loads(sh) for sh in dict.fromkeys(map(json.dumps, shapes))],
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    for arch, layers in HYB_LAYERS.items():
        cfg = _dec_config(get_config, arch, layers).replace(compute_dtype="float32",
                                                            use_pallas=arch == HYB_Z)
        full = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
        datas = sorted({r[1] for r in HYB_DEC_RUNS.values() if r[0] == arch})
        placed = {d: distribute_tree(full, make_policy(cfg, meshes[d]).param_specs(
            tf.param_shapes(cfg)), meshes[d].device_mesh) for d in datas}
        del full  # the rank keeps its shards alone (the mixers whole: the policy's)
        torch.cuda.empty_cache()
        ref = torch.load(MOE_REF_DIR / f"{arch}_hybrid.pt")
        if arch in HYB_PREFILL:  # (d), (f): at data 1 x model 4
            mesh = meshes[1]
            prefill = steps_lib.make_prefill(cfg, dev, make_policy(cfg, mesh), mesh)
            logits, res = counted(prefill, placed[1], {k: v.to(dev) for k, v in
                                                       ref["prefill"].items()})
            got, expect = gather_tree(logits), ref["logits"].to(dev)  # collective
            res.update(rel=_rel(got, expect), agree=_agree(got, expect),
                       finite=bool(torch.isfinite(got).all()))
            out["prefill"][arch] = res
            del logits, got, expect
        for name, (a, data, b, prompt, n_gen, dtype) in HYB_DEC_RUNS.items():
            if a != arch:
                continue
            c, mesh = cfg.replace(compute_dtype=dtype, use_pallas=False), meshes[data]
            policy = make_policy(c, mesh)
            enc = None
            if "frames" in ref:  # whisper's encode, placed through the kernel, timed alone
                enc, res = counted(steps_lib.make_encode(c.replace(use_pallas=True), dev,
                                                         policy, mesh), placed[data],
                                   ref["frames"].to(dev))
                res["rel"] = _rel(gather_tree(enc), ref["enc_out"].to(dev))
                out["prefill"][name] = res
            for k in ops.LAUNCHES:
                ops.LAUNCHES[k] = 0
            out["decode"][name] = {**_placed_decode_run(
                c, placed[data], policy, mesh, torch.load(MOE_REF_DIR / f"{name}.pt"), b,
                prompt, n_gen, enc), "launches": dict(ops.LAUNCHES)}
            del enc
            torch.cuda.empty_cache()
        del placed, ref
        torch.cuda.empty_cache()
    get = train.get_config  # (g): the first 7 layers in fp32, as the reference's
    train.get_config = functools.partial(_hybrid_train_config, get)
    out["train"] = rank_train(train, ops, MOE_TRAIN_RUNS, HYB_TRAIN)
    train.get_config = get
    for res in out["train"].values():
        res["mixer_local"] = res.pop("local_params")["shapes"]["segments/0/mix/w_in"]
    return out


def _hybrid_hold(refs: dict, ranks: list, hold) -> dict:
    """Phase 18(d)-(g)'s results, printed, each check handed to ``hold``."""
    out: dict = {"prefill": {}, "decode": {}, "train": {}}
    for key, ref in refs["prefill"].items():  # (d), (f) and whisper's encodes
        for name in ([key] if key in HYB_PREFILL else
                     [n for n, r in HYB_DEC_RUNS.items() if r[0] == key]):
            per = [rk["hybrid"]["prefill"][name] for rk in ranks]
            res = {"what": "prefill" if key in HYB_PREFILL else "encode",
                   "rel_max_err": per[0]["rel"], "tol": HYB_TOL["float32"],
                   "flash_launches_per_rank": [x["launches"] for x in per],
                   "flash_shapes_per_rank": [x["shapes"] for x in per],
                   "s_per_rank_gloo_host_staged": [x["s"] for x in per],
                   "peak_gb_per_rank": [x["peak_gb"] for x in per], **ref}
            if key in HYB_PREFILL:
                res.update(tokens=list(HYB_PREFILL[key]), argmax_agree=per[0]["agree"],
                           finite=all(x["finite"] for x in per))
                hold(res["finite"], f"prefill {name} finite")
            out["prefill"][name] = res
            print(json.dumps({"hybrid_prefill": name, **res}), flush=True)
            hold(all(x["rel"] <= HYB_TOL["float32"] for x in per), f"prefill {name}")
            flash = HYB_FLASH.get("zamba2_prefill" if key == HYB_Z else name.rsplit("_", 1)[0])
            if flash is None:  # paligemma's prefix mask takes the dense path
                hold(res["flash_launches_per_rank"] == [0] * DIST_WORLD, f"{name}: launches")
            else:
                hold(res["flash_launches_per_rank"] == [flash[1]] * DIST_WORLD
                     and all(sh == [flash[0]] for sh in res["flash_shapes_per_rank"]),
                     f"{name}: flash launches")
    for name, (arch, data, b, prompt, n_gen, dtype) in HYB_DEC_RUNS.items():
        per = [rk["hybrid"]["decode"][name] for rk in ranks]
        tol = max(HYB_TOL[dtype], refs["control"].get(name, 0.0))
        res = {"arch": arch, "layers": HYB_LAYERS[arch] or "all",
               "mesh": {"data": data, "model": DIST_WORLD // data}, "batch": b,
               "prompt": prompt, "generated": n_gen, "compute_dtype": dtype,
               "steps_compared": per[0]["steps"], "rel_max_err_per_rank": [x["rel"] for x in per],
               "tol": tol, "plain_vs_plain_control": refs["control"].get(name),
               "greedy_agree_per_rank": [x["agree"] for x in per],
               "cache_local_per_rank": [x["local"] for x in per],
               "cache_shapes_as_spec_per_rank": [x["shapes_ok"] for x in per],
               "tpot_s_per_rank_gloo_host_staged": [x["tpot_s"] for x in per],
               "peak_gb_per_rank": [x["peak_gb"] for x in per], **refs["decode"][name]}
        out["decode"][name] = res
        print(json.dumps({"hybrid_decode": name, **res}), flush=True)
        hold(max(res["rel_max_err_per_rank"]) <= tol, f"decode {name}")
        hold(all(x["steps"] == n_gen + 1 and x["finite"] for x in per), f"decode {name} finite")
        hold(all(x["rows"] == per[0]["rows"] for x in per), f"decode {name}: one answer")
        hold(all(res["cache_shapes_as_spec_per_rank"]), f"decode {name}: cache shapes")
        hold(all(loc == HYB_CACHE_LOCAL[name.rsplit("_", 1)[0]]
                 for loc in res["cache_local_per_rank"]), f"decode {name}: local caches")
    for name, _ in MOE_TRAIN_RUNS:  # (g)
        per = [rk["hybrid"]["train"][name] for rk in ranks]
        ref = refs["train"][name]
        res = {**{k: per[0][k] for k in ("final_loss", "first_loss", "steps", "world",
                                           "dist_backend", "data", "model")},
               "layers": HYB_TRAIN_LAYERS, "model1_final_loss": ref["final_loss"],
               "rel_to_model1": abs(per[0]["final_loss"] - ref["final_loss"]) /
               abs(ref["final_loss"]), "tol": HYB_TRAIN_RTOL,
               "model1_step_s_virtual": ref["step_s"],
               "mixer_local_shape": per[0]["mixer_local"],
               "step_s_gloo_host_staged": [x["step_s"] for x in per],
               "grad_comm_s_gloo_host_staged": [x["grad_comm_s"] for x in per],
               "peak_gb_per_rank_gloo_host_staged": [x["peak_gb"] for x in per]}
        out["train"][name] = res
        print(json.dumps({"hybrid_train": name, **res}), flush=True)
        hold(all(x["final_loss"] == per[0]["final_loss"] for x in per)
             and math.isfinite(per[0]["final_loss"]), f"hybrid train {name}: one finite loss")
        hold((res["data"], res["model"], res["steps"]) == (2, 2, 2), f"hybrid train {name}")
        hold(res["rel_to_model1"] <= HYB_TRAIN_RTOL, f"hybrid train {name}: against model 1")
    return out


def _jax_twin():
    """``tests/jax_twin.twin_config``: the configs as the JAX package has them, so
    deepseek-v2-lite-16b with capacity dispatch and fp32 params, which phase 18
    places on the model axis (the placed MoE refuses dropless routing)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from jax_twin import twin_config
    return twin_config


def phase_moe_mla(get_config, tf, steps_lib, train, moe_lib, attn, apply_norm) -> dict:
    """Phase 18: the MoE and MLA block kinds on the model axis. The references run
    here first, each arch's params freed before the next: (a) deepseek's fp32
    prefill and its decodes, (b) dbrx's kernel-path prefills in fp32 and bf16,
    layer 0's bf16 attention and its fp32 decode, every MoE call's router gaps
    recorded; (c) deepseek's 2-layer training at model 1 (2 virtual ranks). Then
    one 4-rank gloo world (``python3 chip_smoke.py --moe-rank DIR``), under a
    timeout, any rank's failure failing the phase, runs each placed and is held
    to them here."""
    dev = torch.device("cuda")
    shutil.rmtree(MOE_REF_DIR, ignore_errors=True)
    MOE_REF_DIR.mkdir(parents=True)
    refs: dict = {"prefill": {}, "decode": {}, "gaps": {}}
    for arch in (MOE_DS, MOE_DBRX):  # (a), (b)
        cfg = _dec_config(get_config, arch, MOE_LAYERS[arch])
        params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
        tokens = torch.randint(0, cfg.vocab_size, MOE_PREFILL[arch], device=dev,
                               generator=torch.Generator(device=dev).manual_seed(1))
        saved = {"tokens": tokens.cpu()}
        for dtype in ("float32",) if arch == MOE_DS else ("float32", "bfloat16"):
            c = cfg.replace(compute_dtype=dtype, use_pallas=arch == MOE_DBRX)
            calls: list = []
            with router_gaps(moe_lib, calls):
                logits, s = _timed(steps_lib.make_prefill(c, dev), params, {"tokens": tokens})
            assert torch.isfinite(logits).all(), (arch, dtype)
            saved[dtype] = logits.cpu()
            refs["gaps"][f"{arch}_{dtype}"] = torch.stack(calls).amin(0)[0].cpu()
            refs["prefill"][f"{arch}_{dtype}"] = {"prefill_s_one_process": s}
            del logits
        if arch == MOE_DBRX:  # layer 0's attention in bf16 through the kernel (phase 9)
            with torch.inference_mode():
                saved["layer0_attention"] = _layer0_attention(
                    tf, attn, apply_norm, cfg.replace(compute_dtype="bfloat16"),
                    params["embed"], params["segments"][0], tokens).cpu()
        torch.save(saved, MOE_REF_DIR / f"{arch}_prefill.pt")
        del saved
        for name, (a, _, b, prompt, n_gen, dtype) in MOE_DEC_RUNS.items():
            if a == arch:
                tokens, logits, tpot, gaps = _decode_ref(
                    steps_lib, tf, cfg.replace(compute_dtype=dtype), params, b, prompt, n_gen,
                    moe_lib)
                torch.save({"tokens": tokens.cpu(), "logits": logits.cpu()},
                           MOE_REF_DIR / f"{name}.pt")
                refs["decode"][name] = {"tpot_s_one_process": tpot}
                refs["gaps"][name] = gaps.cpu()
                del logits, tokens
        del params
        torch.cuda.empty_cache()
    get = train.get_config  # (c): the first 2 layers, in fp32, of the phase's configs
    train.get_config = functools.partial(_moe_train_config, get_config)
    model1 = {}
    try:
        for name, flags in MOE_TRAIN_RUNS:
            calls = []
            with router_gaps(moe_lib, calls):
                model1[name] = train.main(MOE_TRAIN + flags)
            g = torch.cat([x.flatten() for x in calls])
            model1[name]["router_gap"] = {"smallest": float(g.min()),
                                          "near_tie_tokens": int((g < MOE_MIN_GAP).sum())}
            del calls, g
            torch.cuda.empty_cache()
    finally:
        train.get_config = get
    torch.cuda.empty_cache()
    hybrid_refs = _hybrid_refs(get_config, tf, steps_lib, train)  # (d)-(g)
    print(json.dumps({"moe_mla_parent_gb_before_ranks": {
        "allocated": torch.cuda.memory_allocated() / 1e9,
        "reserved": torch.cuda.memory_reserved() / 1e9}}), flush=True)
    ranks = run_ranks("--moe-rank", MOE_DIR, MOE_TIMEOUT_S)
    shutil.rmtree(MOE_REF_DIR)
    out = {"wire": HOST_STAGED, "prefill": {}, "decode": {}, "train": {}}
    failed = []  # every result is printed before any is held

    def hold(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)
    for key, ref in refs["prefill"].items():  # (a), (b): the prefills at data 1 x model 4
        arch, dtype = key.rsplit("_", 1)
        per = [rk["prefill"][key] for rk in ranks]
        res = {"arch": arch, "layers": MOE_LAYERS[arch], "tokens": list(MOE_PREFILL[arch]),
               "compute_dtype": dtype, "mesh": {"data": 1, "model": DIST_WORLD},
               "rel_max_err": per[0]["rel"], "argmax_agree": per[0]["agree"],
               "flash_launches_per_rank": [x["launches"]["flash_attention"] for x in per],
               "flash_shapes_per_rank": [x["shapes"] for x in per],
               "prefill_s_per_rank_gloo_host_staged": [x["s"] for x in per],
               "peak_gb_per_rank": [x["peak_gb"] for x in per], **ref}
        if dtype == "float32":
            res.update(_held_rows(per[0]["rows"], refs["gaps"][key], MOE_TOL))
            hold(res["ok"], f"prefill {key}")
        else:
            res["tol"] = "printed only (top-k routing)"
            res["layer0_attention"] = {"rel_max_err_per_rank": [x["layer0_rel"] for x in per],
                                       "tol": MOE_ATTN_BF16_TOL}
            hold(max(res["layer0_attention"]["rel_max_err_per_rank"]) <= MOE_ATTN_BF16_TOL,
                 f"layer 0's attention {key}")
        out["prefill"][key] = res
        print(json.dumps({"moe_mla_prefill": key, **res}), flush=True)
        hold(all(x["finite"] for x in per), f"prefill {key} finite")
        hold(all(x["rows"] == per[0]["rows"] for x in per), f"prefill {key}: one answer")
        if arch == MOE_DBRX:  # one launch per layer, on each rank's own heads
            hold(res["flash_launches_per_rank"] == [MOE_LAYERS[arch]] * DIST_WORLD
                 and all(sh == [MOE_DBRX_LOCAL] for sh in res["flash_shapes_per_rank"]),
                 f"prefill {key}: flash launches")
        else:  # MLA takes the dense path
            hold(res["flash_launches_per_rank"] == [0] * DIST_WORLD, f"prefill {key}: launches")
    for name, (arch, data, b, prompt, n_gen, dtype) in MOE_DEC_RUNS.items():
        per = [rk["decode"][name] for rk in ranks]
        res = {"arch": arch, "layers": MOE_LAYERS[arch],
               "mesh": {"data": data, "model": DIST_WORLD // data}, "batch": b,
               "prompt": prompt, "generated": n_gen, "compute_dtype": dtype,
               "steps_compared": per[0]["steps"], "rel_max_err_per_rank": [x["rel"] for x in per],
               "greedy_agree_per_rank": [x["agree"] for x in per],
               "cache_local_per_rank": [x["local"] for x in per],
               "cache_shapes_as_spec_per_rank": [x["shapes_ok"] for x in per],
               "tpot_s_per_rank_gloo_host_staged": [x["tpot_s"] for x in per],
               "peak_gb_per_rank": [x["peak_gb"] for x in per], **refs["decode"][name]}
        if dtype == "float32":
            res.update(_held_rows(per[0]["rows"], refs["gaps"][name], MOE_TOL))
            hold(res["ok"], f"decode {name}")
        else:
            res["tol"] = "printed only (top-k routing)"
        out["decode"][name] = res
        print(json.dumps({"moe_mla_decode": name, **res}), flush=True)
        hold(all(x["steps"] == n_gen + 1 and x["finite"] for x in per), f"decode {name} finite")
        hold(all(x["rows"] == per[0]["rows"] for x in per), f"decode {name}: one answer")
        hold(all(res["cache_shapes_as_spec_per_rank"]), f"decode {name}: cache shapes")
        hold(all(loc == MOE_CACHE_LOCAL[name.rsplit("_", 1)[0]]
                 for loc in res["cache_local_per_rank"]), f"decode {name}: local caches")
    for name, flags in MOE_TRAIN_RUNS:  # (c)
        per = [rk["train"][name] for rk in ranks]
        ref, gap = model1[name], model1[name]["router_gap"]
        tol = MOE_NEAR_TIE_RTOL if gap["near_tie_tokens"] else MOE_TRAIN_RTOL
        res = {**{k: per[0][k] for k in ("final_loss", "first_loss", "steps", "world",
                                           "dist_backend", "data", "model")},
               "layers": MOE_TRAIN_LAYERS, "model1_final_loss": ref["final_loss"],
               "rel_to_model1": abs(per[0]["final_loss"] - ref["final_loss"]) /
               abs(ref["final_loss"]), "tol": tol, "model1_router_gap": gap,
               "model1_step_s_virtual": ref["step_s"],
               "experts_local_shape": per[0]["experts_local"],
               "step_s_gloo_host_staged": [x["step_s"] for x in per],
               "grad_comm_s_gloo_host_staged": [x["grad_comm_s"] for x in per],
               "peak_gb_per_rank_gloo_host_staged": [x["peak_gb"] for x in per]}
        out["train"][name] = res
        print(json.dumps({"moe_mla_train": name, **res}), flush=True)
        hold(all(x["final_loss"] == per[0]["final_loss"] for x in per)
             and math.isfinite(per[0]["final_loss"]), f"train {name}: one finite loss")
        hold((res["data"], res["model"], res["steps"]) == (2, 2, 2), f"train {name}: mesh")
        hold(res["rel_to_model1"] <= tol, f"train {name}: against model 1")
    out["hybrid"] = _hybrid_hold(hybrid_refs, ranks, hold)
    assert not failed, failed
    return out


def moe_rank(out_dir: str) -> None:
    """One rank of phase 18's world: its runs, written to ``out_dir/rank<r>.json``."""
    sys.path.insert(0, str(ROOT / "src"))
    get_config = _jax_twin()
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import init_process_mesh, split_model_axis
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import apply_norm
    from repro_torch.sharding.policy import distribute_tree, gather_tree, make_policy

    # 4 ranks share the card: whole 9 GB leaves are built and freed, the trainer's
    # AdamW makes and drops leaf-sized temporaries
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    torch.backends.cuda.matmul.allow_tf32 = False  # as the references' runs
    torch.backends.cudnn.allow_tf32 = False
    world = init_process_mesh("cuda", "gloo")  # kept for the phase: each run reuses it
    dev = world.device
    meshes = {d: split_model_axis(world, d) for d in (1, 2)}
    out = {"prefill": {}, "decode": {}}
    shapes, counted = [], ops.flash_attention

    def seen(q, k, v, **kw):
        shapes.append([list(q.shape), list(k.shape)])
        return counted(q, k, v, **kw)
    ops.flash_attention = seen
    for arch in (MOE_DS, MOE_DBRX):  # (a), (b)
        cfg = _dec_config(get_config, arch, MOE_LAYERS[arch])
        full = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
        datas = sorted({1} | {r[1] for r in MOE_DEC_RUNS.values() if r[0] == arch})
        placed = {d: distribute_tree(full, make_policy(cfg, meshes[d]).param_specs(
            tf.param_shapes(cfg)), meshes[d].device_mesh) for d in datas}
        del full  # the rank keeps its shards alone
        torch.cuda.empty_cache()
        ref = torch.load(MOE_REF_DIR / f"{arch}_prefill.pt")
        tokens, mesh = ref["tokens"].to(dev), meshes[1]
        for dtype in ("float32",) if arch == MOE_DS else ("float32", "bfloat16"):
            c = cfg.replace(compute_dtype=dtype, use_pallas=arch == MOE_DBRX)
            prefill = steps_lib.make_prefill(c, dev, make_policy(c, mesh), mesh)
            for k in ops.LAUNCHES:
                ops.LAUNCHES[k] = 0
            shapes.clear()
            torch.cuda.reset_peak_memory_stats()
            dist.barrier()
            logits, s = _timed(prefill, placed[1], {"tokens": tokens})
            launches = dict(ops.LAUNCHES)
            got, expect = gather_tree(logits), ref[dtype].to(dev)  # collective
            res = {"s": s, "launches": launches,
                   "shapes": [json.loads(sh) for sh in dict.fromkeys(map(json.dumps, shapes))],
                   "rel": _rel(got, expect), "agree": _agree(got, expect),
                   "rows": ((got.float() - expect.float()).abs().amax(-1)
                            / expect.float().abs().max())[0].tolist(),
                   "finite": bool(torch.isfinite(got).all()),
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            del logits, got, expect
            if dtype == "bfloat16":  # layer 0's attention, the kernel on the rank's heads
                with torch.no_grad(), implicit_replication():
                    a = _layer0_attention(tf, attn, apply_norm, c,
                                          steps_lib.param_on_model(placed[1]["embed"]),
                                          _map(steps_lib.param_on_model,
                                               placed[1]["segments"][0]), tokens)
                res["layer0_rel"] = _rel(a.to_local(), ref["layer0_attention"].to(dev))
                del a
            out["prefill"][f"{arch}_{dtype}"] = res
            torch.cuda.empty_cache()
        del ref
        for name, (a, data, b, prompt, n_gen, dtype) in MOE_DEC_RUNS.items():
            if a == arch:
                c = cfg.replace(compute_dtype=dtype)
                for k in ops.LAUNCHES:
                    ops.LAUNCHES[k] = 0
                out["decode"][name] = {**_placed_decode_run(
                    c, placed[data], make_policy(c, meshes[data]), meshes[data],
                    torch.load(MOE_REF_DIR / f"{name}.pt"), b, prompt, n_gen),
                    "launches": dict(ops.LAUNCHES)}
                torch.cuda.empty_cache()
        del placed
        torch.cuda.empty_cache()
    ops.flash_attention = counted
    get = train.get_config  # (c): the first 2 layers in fp32, as the reference's
    train.get_config = functools.partial(_moe_train_config, get_config)
    out["train"] = rank_train(train, ops, MOE_TRAIN_RUNS, MOE_TRAIN)
    train.get_config = get
    for res in out["train"].values():
        res["experts_local"] = res.pop("local_params")["shapes"]["segments/1/moe/wi"]
    ops.flash_attention = seen  # (d)-(g)
    out["hybrid"] = _hybrid_rank(get_config, tf, steps_lib, train, ops, meshes, dev, shapes)
    ops.flash_attention = counted
    dist.barrier()
    dist.destroy_process_group()
    pathlib.Path(out_dir, f"rank{world.rank}.json").write_text(json.dumps(out))


def phase_prefill(get_config, tf, make_prefill, ops) -> dict:
    """Phase 3: full-width danube prefill, kernel path against the plain path."""
    dev = torch.device("cuda")
    cfg = get_config("h2o-danube-1.8b")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tf.init_params(gen, cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 4608), generator=gen, device=dev)
    batch = {"tokens": tokens}
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "tokens": list(tokens.shape),
           "params": sum(t.numel() for t in _leaves(params))}
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(compute_dtype=dtype)
        plain, plain_s = _timed(make_prefill(c, dev), params, batch)
        n0 = ops.LAUNCHES["flash_attention"]
        kern, kern_s = _timed(make_prefill(c.replace(use_pallas=True), dev), params, batch)
        launches = ops.LAUNCHES["flash_attention"] - n0
        assert launches == cfg.n_layers, launches
        assert kern.shape == (2, 4608, cfg.vocab_size) and kern.dtype == c.cdtype
        assert torch.isfinite(kern).all() and torch.isfinite(plain).all()
        kf, pf = kern.float(), plain.float()
        rel = float((kf - pf).abs().max() / pf.abs().max())
        agree = float((kf.argmax(-1) == pf.argmax(-1)).float().mean())
        out[dtype] = {"rel_max_err": rel, "tol": PREFILL_TOL[dtype], "argmax_agree": agree,
                      "kernel_prefill_s": kern_s, "plain_prefill_s": plain_s,
                      "launches_per_prefill": launches}
        print(json.dumps({"prefill": dtype, **out[dtype]}), flush=True)
        assert rel <= PREFILL_TOL[dtype], (dtype, rel)
        PHASE3_LOGITS[dtype] = kern.cpu()  # phase 16 holds its TP prefill to these
        del plain, kern, kf, pf
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return out


def _rel(got: torch.Tensor, expect: torch.Tensor) -> float:
    got, expect = got.float(), expect.float()
    return float((got - expect).abs().max() / expect.abs().max())


def _agree(got: torch.Tensor, expect: torch.Tensor) -> float:
    return float((got.argmax(-1) == expect.argmax(-1)).float().mean())


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _is_norm(path: str) -> bool:
    return "ln1" in path or "ln2" in path or "final_norm" in path or "kv_norm" in path


@contextlib.contextmanager
def _no_host_sync(moe_lib):
    """While the block runs, every dropless MoE call raises on an operation that
    waits for the card (``torch.cuda.set_sync_debug_mode``)."""
    dropless = moe_lib._dropless

    def checked(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dropless(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    moe_lib._dropless = checked
    try:
        yield
    finally:
        moe_lib._dropless = dropless


def _published_reference_check(cell, params, seq, served, steps, s: int) -> dict:
    """Phase 8(b)'s judgement by the ``cell``'s reference
    (``bench/references/deepseek-v2-lite-16b.py``) in fp32 (TF32 off) over each row
    of ``seq`` [b, s + n] (the prompt and the n tokens fed to the decode steps):
    the widest gap by which a served token's logit (the prefill's first choices
    ``served`` [b, s], each step's ``steps`` [b, n, V]) lies below the reference's
    best, held to the cell's ``token_gap`` limit, and each step's logits' error
    relative to the reference's largest."""
    from bench import harness, reference
    bench_cfg, limit = cell.cfg, cell.limits
    model = harness.model_parts(bench_cfg)
    prefill_gap, step_gap, step_err = 0.0, [0.0] * steps.shape[1], [0.0] * steps.shape[1]
    with reference.exact_fp32(), torch.inference_mode():
        for i in range(seq.shape[0]):
            ref = model.forward(params, seq[i:i + 1], bench_cfg, q_rows=1024)[0]  # [s + n, V]
            best = ref.max(-1).values
            gap = best[:s] - ref[:s].gather(-1, served[i].long()[:, None])[:, 0]
            prefill_gap = max(prefill_gap, float(gap.max()))
            for j in range(steps.shape[1]):
                want, got = ref[s + j], steps[i, j]
                step_gap[j] = max(step_gap[j], float(best[s + j] - want[got.argmax()]))
                step_err[j] = max(step_err[j], _rel(got, want))
            del ref, best, gap
    return {"prefill_token_gap": prefill_gap, "decode_token_gap": step_gap,
            "decode_rel_err": step_err, "token_gap_limit": limit["token_gap"],
            "ok": max(prefill_gap, *step_gap) <= limit["token_gap"]}


def phase_deepseek(get_config, tf, steps_lib, flatten_with_paths, ops, moe_lib) -> dict:
    """Phase 8 (a)–(d): deepseek-v2-lite-16b whole on the card as published: (a)
    ``init_params``' bf16 tree from seed 0 counted, (b)–(d) on the benchmark cell's
    weights, drawn as the cell draws them from ``DEEPSEEK_SEED``. Returns numbers
    only, so its params die with the call."""
    dev = torch.device("cuda")
    cfg = get_config("deepseek-v2-lite-16b")
    t0 = time.perf_counter()
    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    flat = flatten_with_paths(params)
    counted = sum(t.numel() for k, t in flat if not _is_norm(k))
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "init_s": time.perf_counter() - t0,
           "params_counted": counted, "param_count": cfg.param_count(),
           "params_with_norms": sum(t.numel() for _, t in flat),
           "param_gb": sum(t.numel() * t.element_size() for _, t in flat) / 1e9}
    del flat
    print(json.dumps({"deepseek_params": out}), flush=True)
    assert counted == cfg.param_count(), out  # 15,706,357,760 (tests/test_torch_mla.py)

    # (b) the published model as the benchmark serves it, bf16, on the cell's weights
    # and prompts: a prefill of 2 x 4096 through make_prefill (no flash launch: MLA
    # takes the dense path; three grouped expert products a MoE layer, none of them
    # reading a value on the host) that fills the latent caches, then greedy decode
    # steps through them; the served tokens and the steps' logits judged by the plain
    # fp32 reference's forward over the whole sequence
    del params
    torch.cuda.empty_cache()
    sys.path.insert(0, str(ROOT))
    from bench import data, harness
    cell = harness.load_cell(DEEPSEEK_CELL)
    model = harness.model_parts(cell.cfg)
    params = data.make_weights(cell.cfg, DEEPSEEK_SEED, dev, model.weight_shapes(cell.cfg))
    b, s = cell.traffic["batch"], cell.traffic["prompt_len"]
    batch = {"tokens": data.tokens(cell.cfg, cell.traffic["tokens"], DEEPSEEK_SEED, 0, b,
                                   s).to(dev)}
    c16 = cfg.replace(use_pallas=True)
    prefill = steps_lib.make_prefill(c16, dev)
    caches = tf.init_caches(c16, b, s + DEEPSEEK_DECODE, dev)
    moe_layers = cfg.block_pattern.count("mla_moe")
    n0 = ops.LAUNCHES["flash_attention"]
    torch.cuda.reset_peak_memory_stats()
    logits, first_s = _timed(prefill, params, batch)
    del logits
    g0 = moe_lib.LAUNCHES["grouped_mm"]
    with _no_host_sync(moe_lib):
        logits, prefill_s = _timed(prefill, params, batch, caches)
    launches = ops.LAUNCHES["flash_attention"] - n0
    grouped = moe_lib.LAUNCHES["grouped_mm"] - g0
    moe_lib.EXPERT_LOADS.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        del logits
        logits = prefill(params, batch, caches)  # the spans keep each layer's loads
    loads = torch.stack(moe_lib.EXPERT_LOADS).cpu()  # [MoE layers, experts]
    moe_lib.EXPERT_LOADS.clear()
    decode = steps_lib.make_decode_step(c16, dev)
    cur = logits[:, -1].argmax(-1, keepdim=True).int()
    seq, steps = [batch["tokens"], cur], []
    t0 = time.perf_counter()
    for i in range(DEEPSEEK_DECODE):
        step, caches = decode(params, caches, cur, s + i)
        steps.append(step[:, 0].float())
        cur = step[:, 0].argmax(-1, keepdim=True).int()
        seq.append(cur)
    torch.cuda.synchronize()
    decode_s = (time.perf_counter() - t0) / DEEPSEEK_DECODE
    served = logits.argmax(-1)  # [b, s]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del logits, caches
    torch.cuda.empty_cache()
    judged = _published_reference_check(cell, params, torch.cat(seq[:-1], 1), served,
                                        torch.stack(steps, 1), s)
    out["prefill_bf16"] = {"tokens": [b, s], "first_s": first_s,
                           "prefill_s": prefill_s, "flash_launches": launches,
                           "grouped_mm_launches": grouped, "moe_layers": moe_layers,
                           "decode_steps": DEEPSEEK_DECODE, "decode_step_s": decode_s,
                           "peak_gb": peak_gb,
                           "expert_load_max_over_mean": (loads.amax(1) / loads.mean(1)).tolist(),
                           "expert_load_min": loads.amin(1).tolist(), **judged}
    print(json.dumps({"deepseek_prefill": out["prefill_bf16"]}), flush=True)
    assert launches == 0 and grouped == 3 * moe_layers, out["prefill_bf16"]
    assert loads.shape == (moe_layers, cfg.moe_experts), loads.shape
    assert bool((loads.sum(1) == b * s * cfg.moe_top_k).all()), loads.sum(1)  # dropless
    assert judged["ok"], out["prefill_bf16"]
    del batch, steps, seq
    torch.cuda.empty_cache()

    # (c) fp32: prefill against token replay over the latent cache, both dropless
    gen = torch.Generator(device=dev).manual_seed(1)
    c32 = cfg.replace(compute_dtype="float32")
    toks = torch.randint(0, cfg.vocab_size, (1, DEEPSEEK_REPLAY), generator=gen, device=dev)
    full = steps_lib.make_prefill(c32, dev)(params, {"tokens": toks})
    decode = steps_lib.make_decode_step(c32, dev)
    caches = tf.init_caches(c32, 1, DEEPSEEK_REPLAY, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    errs = []
    for i in range(DEEPSEEK_REPLAY):
        step_logits, caches = decode(params, caches, toks[:, i:i + 1], i)
        errs.append(_rel(step_logits[:, 0], full[:, i]))
    torch.cuda.synchronize()
    out["replay_fp32"] = {"tokens": DEEPSEEK_REPLAY, "rel_err_last": errs[-1],
                          "rel_err_max": max(errs), "tol": 1e-3,
                          "decode_step_s": (time.perf_counter() - t0) / DEEPSEEK_REPLAY}
    print(json.dumps({"deepseek_replay": out["replay_fp32"]}), flush=True)
    assert max(errs) <= 1e-3, out["replay_fp32"]
    del full, caches, step_logits

    # (d) the first two layers, fp32: the card against the CPU on the same params
    kinds, s2 = DEEPSEEK_DEPTH2
    c2 = cfg.replace(n_layers=len(kinds), block_pattern=kinds, compute_dtype="float32")
    p2 = {**params, "segments": [params["segments"][0],
                                 _map(lambda t: t[:1], params["segments"][1])]}
    toks = torch.randint(0, cfg.vocab_size, (1, s2), generator=gen, device=dev)
    card, card_aux = tf.forward_logits(p2, {"tokens": toks}, c2)
    p2_cpu = _map(lambda t: t.cpu(), p2)
    cpu, cpu_aux = tf.forward_logits(p2_cpu, {"tokens": toks.cpu()}, c2)
    out["depth2_card_vs_cpu"] = {"layers": list(kinds), "tokens": s2,
                                 "rel_err": _rel(card.cpu(), cpu), "tol": 1e-4,
                                 "argmax_agree": _agree(card.cpu(), cpu),
                                 "aux_card": float(card_aux), "aux_cpu": float(cpu_aux)}
    print(json.dumps({"deepseek_depth2": out["depth2_card_vs_cpu"]}), flush=True)
    assert out["depth2_card_vs_cpu"]["rel_err"] <= 1e-4, out["depth2_card_vs_cpu"]
    assert out["depth2_card_vs_cpu"]["argmax_agree"] == 1.0, out["depth2_card_vs_cpu"]
    assert abs(float(card_aux) - float(cpu_aux)) <= 1e-5 * float(cpu_aux)
    return out


def phase_dbrx(get_config, tf, attn, apply_norm, steps_lib, ops) -> dict:
    """Phase 9: dbrx-132b's MoE blocks at full width, ``DBRX_LAYERS`` deep, bf16
    params from seed 0: prefills through the flash kernel against the plain
    path, and decode. The launch count is read after them, before layer 0's
    attention launches the kernel once more per dtype to compare it.

    In bf16 the whole-model comparison is printed, not held to a limit: the
    router's top-k turns a rounding difference into another expert for the
    tokens near a tie, which moves their rows by O(1). Two plain paths that
    round differently (chunked attention, fp32 inside, against dense, P in
    bf16) show the same; fp32 rounds too little to move a choice."""
    dev = torch.device("cuda")
    cfg = get_config("dbrx-132b")
    cfg = cfg.replace(n_layers=DBRX_LAYERS, block_pattern=("moe",) * DBRX_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tf.init_params(gen, cfg)
    tokens = torch.randint(0, cfg.vocab_size, DBRX_PREFILL, generator=gen, device=dev)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "tokens": list(DBRX_PREFILL),
           "params": sum(t.numel() for t in _leaves(params)),
           "param_count": cfg.param_count()}
    for dtype in ("bfloat16", "float32"):
        c = cfg.replace(compute_dtype=dtype)
        n0 = ops.LAUNCHES["flash_attention"]
        kern, kern_s = _timed(steps_lib.make_prefill(c.replace(use_pallas=True), dev),
                              params, {"tokens": tokens})
        launches = ops.LAUNCHES["flash_attention"] - n0
        plain, plain_s = _timed(steps_lib.make_prefill(c, dev), params, {"tokens": tokens})
        assert kern.shape == (*DBRX_PREFILL, cfg.vocab_size) and kern.dtype == c.cdtype
        assert torch.isfinite(kern).all() and torch.isfinite(plain).all()
        out[dtype] = {"rel_max_err": _rel(kern, plain), "tol": PREFILL_TOL[dtype],
                      "argmax_agree": _agree(kern, plain), "kernel_prefill_s": kern_s,
                      "plain_prefill_s": plain_s, "launches_per_prefill": launches}
        if dtype == "bfloat16":
            chunked = steps_lib.make_prefill(c.replace(dense_attn_limit=0), dev)(
                params, {"tokens": tokens})
            out[dtype]["tol"] = "printed only (top-k routing)"
            out[dtype]["control_plain_chunked_vs_dense"] = {
                "rel_max_err": _rel(chunked, plain), "argmax_agree": _agree(chunked, plain)}
            del chunked
        print(json.dumps({"dbrx_prefill": dtype, **out[dtype]}), flush=True)
        assert launches == cfg.n_layers, launches
        if dtype == "float32":
            assert out[dtype]["rel_max_err"] <= PREFILL_TOL[dtype], (dtype, out[dtype])
        del plain, kern
        torch.cuda.empty_cache()
    # decode: token replay of the prompt's first tokens, bf16
    decode = steps_lib.make_decode_step(cfg, dev)
    caches = tf.init_caches(cfg, 1, DBRX_DECODE, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(DBRX_DECODE):
        logits, caches = decode(params, caches, tokens[:, i:i + 1], i)
    torch.cuda.synchronize()
    out["decode"] = {"steps": DBRX_DECODE, "step_s": (time.perf_counter() - t0) / DBRX_DECODE,
                     "finite": bool(torch.isfinite(logits).all())}
    print(json.dumps({"dbrx_decode": out["decode"]}), flush=True)
    assert out["decode"]["finite"], out["decode"]
    out["launches"] = dict(ops.LAUNCHES)  # the main path's, read before the check below

    # layer 0's attention on its own input, the kernel against the plain path
    layer0 = _map(lambda t: t[0], params["segments"][0])
    positions = torch.arange(DBRX_PREFILL[1], dtype=torch.int32, device=dev)[None]
    out["layer0_attention"] = {}
    for dtype in ("bfloat16", "float32"):
        c = cfg.replace(compute_dtype=dtype)
        with torch.inference_mode():
            h = apply_norm(c.norm, layer0["ln1"], params["embed"][tokens].to(c.cdtype))
            kern = attn.attention_forward(layer0["attn"], h, positions, c, use_pallas=True)
            plain = attn.attention_forward(layer0["attn"], h, positions, c)
        out["layer0_attention"][dtype] = {"rel_max_err": _rel(kern, plain),
                                          "tol": PREFILL_TOL[dtype]}
        assert out["layer0_attention"][dtype]["rel_max_err"] <= PREFILL_TOL[dtype], out
    print(json.dumps({"dbrx_layer0_attention": out["layer0_attention"]}), flush=True)
    return out


def _init_counted(tf, flatten_with_paths, cfg, seed: int = 0) -> tuple[dict, dict]:
    """Full-width fp32 params from ``seed`` on the card, and their count."""
    t0 = time.perf_counter()
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(seed), cfg)
    torch.cuda.synchronize()
    flat = flatten_with_paths(params)
    info = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
            "init_s": time.perf_counter() - t0, "param_count": cfg.param_count(),
            "params_with_all_leaves": sum(t.numel() for _, t in flat),
            "param_gb": sum(t.numel() * t.element_size() for _, t in flat) / 1e9}
    return params, info


def phase_dense(get_config, tf, steps_lib, flatten_with_paths, ops, arch: str) -> dict:
    """Phase 10, one model: full width and depth, fp32 params from seed 0; a
    1 × 4096 prefill through the flash kernel against the plain dense path,
    bf16 then fp32. Returns numbers only, so its params die with the call."""
    dev = torch.device("cuda")
    cfg = get_config(arch)
    params, out = _init_counted(tf, flatten_with_paths, cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, DENSE_PREFILL, generator=gen,
                                     device=dev)}
    for dtype in ("bfloat16", "float32"):
        c = cfg.replace(compute_dtype=dtype)
        torch.cuda.reset_peak_memory_stats()
        n0 = ops.LAUNCHES["flash_attention"]
        kern, kern_s = _timed(steps_lib.make_prefill(c.replace(use_pallas=True), dev),
                              params, batch)
        launches = ops.LAUNCHES["flash_attention"] - n0
        plain, plain_s = _timed(steps_lib.make_prefill(c, dev), params, batch)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        assert kern.shape == (*DENSE_PREFILL, cfg.vocab_size) and kern.dtype == c.cdtype
        assert torch.isfinite(kern).all() and torch.isfinite(plain).all()
        out[dtype] = {"rel_max_err": _rel(kern, plain), "tol": PREFILL_TOL[dtype],
                      "argmax_agree": _agree(kern, plain), "kernel_prefill_s": kern_s,
                      "plain_prefill_s": plain_s, "launches_per_prefill": launches,
                      "peak_gb": peak_gb}
        del kern, plain
        torch.cuda.empty_cache()
        print(json.dumps({"dense_prefill": arch, "dtype": dtype, **out[dtype]}), flush=True)
        assert launches == cfg.n_layers, (arch, dtype, launches)
        assert out[dtype]["rel_max_err"] <= PREFILL_TOL[dtype], (arch, dtype, out[dtype])
    return out


def _leading(tf, params, cfg, n: int) -> tuple[object, dict]:
    """The config and params of the model's first ``n`` layers (and the shared
    call sites among them): each segment's stack cut to the layers it keeps."""
    c = cfg.replace(n_layers=n, block_pattern=cfg.block_pattern[:n])
    segs = [_map(lambda t, k=count: t[:k], p)
            for p, (_, count) in zip(params["segments"], tf.segments_of(c))]
    return c, {**params, "segments": segs}


def phase_ssm(get_config, tf, steps_lib, flatten_with_paths, ops, arch: str) -> dict:
    """Phase 11 (a)–(d), one model whole on the card, fp32 params from seed 0.
    Returns numbers only, so its params die with the call."""
    dev, want = torch.device("cuda"), SSM_ARCHS[arch]
    cfg = get_config(arch)
    params, out = _init_counted(tf, flatten_with_paths, cfg)
    print(json.dumps({"ssm_params": out}), flush=True)
    assert out["param_count"] == want["param_count"], out

    # (b) the bf16 prefill, timed: the flash kernel runs at the shared call sites only
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, SSM_PREFILL, generator=gen,
                                     device=dev)}
    prefill = steps_lib.make_prefill(cfg.replace(use_pallas=True), dev)
    torch.cuda.reset_peak_memory_stats()
    n0 = ops.LAUNCHES["flash_attention"]
    logits, first_s = _timed(prefill, params, batch)
    first_launches = ops.LAUNCHES["flash_attention"] - n0
    del logits
    n0 = ops.LAUNCHES["flash_attention"]
    logits, prefill_s = _timed(prefill, params, batch)
    launches = ops.LAUNCHES["flash_attention"] - n0
    out["prefill_bf16"] = {"tokens": list(SSM_PREFILL), "first_s": first_s,
                           "prefill_s": prefill_s, "flash_launches": launches,
                           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                           "finite": bool(torch.isfinite(logits).all())}
    print(json.dumps({"ssm_prefill": arch, **out["prefill_bf16"]}), flush=True)
    assert logits.shape == (*SSM_PREFILL, cfg.vocab_size), logits.shape
    assert out["prefill_bf16"]["finite"], out["prefill_bf16"]
    assert launches == first_launches == want["launches"], (launches, first_launches)
    del logits

    # (b') one block of each kind (and one shared call site) on the prefill's
    # embeddings, timed by CUDA events over 3 calls after a warm one (the
    # events span the gaps while the host queues work): where the prefill's time goes.
    # Its launches are not the main path's: they are counted apart and
    # subtracted.
    n0 = ops.LAUNCHES["flash_attention"]
    c = cfg.replace(use_pallas=True)
    with torch.inference_mode():
        x = params["embed"][batch["tokens"]].to(c.cdtype)
        pos = torch.arange(SSM_PREFILL[1], dtype=torch.int32, device=dev)[None].expand(
            *SSM_PREFILL)
        blocks = {}
        for seg, (kind, _) in zip(params["segments"], tf.segments_of(c)):
            if kind not in blocks:
                layer = _map(lambda t: t[0], seg)
                blocks[kind] = {"count": c.block_pattern.count(kind), "block_ms": cuda_ms(
                    lambda: tf._block_forward(kind, layer, x, pos, c, "causal", 0), 3)}
        if c.shared_attn_every:
            blocks["shared"] = {"count": tf.cache_layout(c).count("shared"), "block_ms": cuda_ms(
                lambda: tf._shared_block_forward(params, x, x, pos, c), 3)}
    for b_ in blocks.values():
        b_["share_of_prefill"] = b_["count"] * b_["block_ms"] / (prefill_s * 1e3)
    out["prefill_bf16"]["blocks"] = blocks
    out["timing_launches"] = ops.LAUNCHES["flash_attention"] - n0
    print(json.dumps({"ssm_blocks": arch, **blocks}), flush=True)
    del x, batch
    torch.cuda.empty_cache()

    # (c) fp32: the prefill against token replay through the recurrent states
    c32 = cfg.replace(compute_dtype="float32")
    toks = torch.randint(0, cfg.vocab_size, (1, SSM_REPLAY), generator=gen, device=dev)
    full = steps_lib.make_prefill(c32, dev)(params, {"tokens": toks})
    decode = steps_lib.make_decode_step(c32, dev)
    caches = tf.init_caches(c32, 1, SSM_REPLAY, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    errs = []
    for i in range(SSM_REPLAY):
        step_logits, caches = decode(params, caches, toks[:, i:i + 1], i)
        errs.append(_rel(step_logits[:, 0], full[:, i]))
    torch.cuda.synchronize()
    out["replay_fp32"] = {"tokens": SSM_REPLAY, "rel_err_last": errs[-1],
                          "rel_err_max": max(errs), "tol": 1e-3,
                          "decode_step_s": (time.perf_counter() - t0) / SSM_REPLAY}
    print(json.dumps({"ssm_replay": arch, **out["replay_fp32"]}), flush=True)
    assert max(errs) <= 1e-3, out["replay_fp32"]
    del full, caches, step_logits

    # (d) the leading layers, fp32: the card against the CPU on the same params
    c_lead, p_lead = _leading(tf, params, c32, want["lead"])
    toks = torch.randint(0, cfg.vocab_size, (1, SSM_LEAD_TOKENS), generator=gen, device=dev)
    with torch.inference_mode():
        card, _ = tf.forward_logits(p_lead, {"tokens": toks}, c_lead)
        cpu, _ = tf.forward_logits(_map(lambda t: t.cpu(), p_lead), {"tokens": toks.cpu()},
                                   c_lead)
    out["leading_card_vs_cpu"] = {"layers": list(tf.cache_layout(c_lead)),
                                  "tokens": SSM_LEAD_TOKENS, "rel_err": _rel(card.cpu(), cpu),
                                  "tol": 1e-4, "argmax_agree": _agree(card.cpu(), cpu)}
    print(json.dumps({"ssm_leading": arch, **out["leading_card_vs_cpu"]}), flush=True)
    assert out["leading_card_vs_cpu"]["rel_err"] <= 1e-4, out["leading_card_vs_cpu"]
    assert out["leading_card_vs_cpu"]["argmax_agree"] == 1.0, out["leading_card_vs_cpu"]
    return out


def _load_example(name: str):
    """A port example (``examples/<name>.py``) as a module."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_flash_whisper(ops) -> dict:
    """Phase 12, the kernel alone at whisper's encoder shape: against its plain
    version, then timed beside SDPA with no mask. Not the main path's launches."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    checks, out = [], {}
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = randn_qkv(gen, *[WHISPER[x] for x in ("b", "sq", "skv", "h", "kv", "d")], dt)
        got = ops.flash_attention(q, k, v, causal=False)
        plain = ops.flash_attention_plain(q, k, v, causal=False)
        err = float((got.float() - plain.float()).abs().max())
        checks.append({"shape": list(WHISPER.values()), "dtype": str(dt).removeprefix("torch."),
                       "max_abs_err": err, "tol": TOL[dt]})
        # the control: the plain version over keys zero-padded to the tile, as the
        # TMA box reads them past Skv, i.e. what an unmasked last tile gives
        pad = -WHISPER["skv"] % 64
        kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v))
        unmasked = ops.flash_attention_plain(q, kp, vp, causal=False)
        checks[-1].update(rel_rms_err=_rel_rms(got, plain), rel_rms_tol=TAIL_TOL[dt],
                          unmasked_tail_rel_rms=_rel_rms(unmasked, plain), padded_keys=pad)
        assert got.shape == q.shape and torch.isfinite(got).all(), checks[-1]
        assert err <= TOL[dt], checks[-1]
        assert checks[-1]["unmasked_tail_rel_rms"] > TAIL_TOL[dt], checks[-1]
        assert checks[-1]["rel_rms_err"] <= TAIL_TOL[dt], checks[-1]
        print(json.dumps({"whisper_flash_check": checks[-1]}), flush=True)
        del q, k, v, got, plain, kp, vp, unmasked
        out[dt] = time_attention(ops, gen, WHISPER, dt, checks)
        print(json.dumps({"whisper_flash": str(dt).removeprefix("torch."),
                          **{k_: v_ for k_, v_ in out[dt].items() if k_ != "launch"}}),
              flush=True)
    torch.cuda.empty_cache()
    return out


def _rel_rms(got: torch.Tensor, expect: torch.Tensor) -> float:
    return float((got.float() - expect.float()).norm() / expect.float().norm())


def phase_whisper(get_config, tf, flatten_with_paths, ops) -> dict:
    """Phase 12, whisper-tiny whole at full width (fp32 params from seed 0):
    (a) the bf16 encoder over 4 × 1500 frames through the flash kernel,
    timed, one launch per encoder layer; (b) the kernel encoder against the
    dense one, bf16 and fp32; (c) fp32, the decoder's logits over
    ``WHISPER_REPLAY`` tokens against as many decode steps over the self and
    cross caches. Returns numbers only, so its params die with the call."""
    dev = torch.device("cuda")
    cfg = get_config("whisper-tiny")
    params, out = _init_counted(tf, flatten_with_paths, cfg)
    out["enc_layers"] = cfg.enc_layers
    print(json.dumps({"whisper_params": out}), flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    frames = torch.randn((WHISPER["b"], cfg.enc_seq_len, cfg.d_model), generator=gen,
                         device=dev)

    # (a) and (b): each kernel encode launches the kernel once per encoder layer
    def encode(c):
        n0 = ops.LAUNCHES["flash_attention"]
        with torch.inference_mode():
            y, s_ = _timed(tf.encoder_forward, params["encoder"], frames, c)
        launches = ops.LAUNCHES["flash_attention"] - n0
        assert launches == (cfg.enc_layers if c.use_pallas else 0), (c.compute_dtype, launches)
        return y, s_, launches
    for dtype in ("bfloat16", "float32"):
        c = cfg.replace(compute_dtype=dtype)
        _, first_s, _ = encode(c.replace(use_pallas=True))
        kern, kern_s, launches = encode(c.replace(use_pallas=True))
        _, plain_first_s, _ = encode(c)  # the dense path's first call sets up its products
        plain, plain_s, _ = encode(c)
        assert kern.shape == frames.shape and kern.dtype == c.cdtype
        assert torch.isfinite(kern).all() and torch.isfinite(plain).all()
        out[f"encode_{dtype}"] = {
            "frames": [WHISPER["b"], cfg.enc_seq_len], "first_s": first_s,
            "kernel_encode_s": kern_s, "plain_first_s": plain_first_s, "plain_encode_s": plain_s,
            "launches_per_encode": launches, "rel_max_err": _rel(kern, plain),
            "tol": PREFILL_TOL[dtype], "argmax_agree": _agree(kern, plain)}
        print(json.dumps({"whisper_encode": dtype, **out[f"encode_{dtype}"]}), flush=True)
        assert out[f"encode_{dtype}"]["rel_max_err"] <= PREFILL_TOL[dtype], out
        del kern, plain

    # (c) fp32: the decoder's logits against token-by-token decode
    c32 = cfg.replace(compute_dtype="float32")
    toks = torch.randint(0, cfg.vocab_size, (WHISPER["b"], WHISPER_REPLAY), generator=gen,
                         device=dev)
    with torch.inference_mode():
        full, _ = tf.forward_logits(params, {"tokens": toks, "frames": frames}, c32)
        caches = tf.init_caches(c32, WHISPER["b"], WHISPER_REPLAY, dev)
        tf.fill_cross_caches(params, tf.encoder_forward(params["encoder"], frames, c32),
                             caches, c32)
        errs = []
        for i in range(WHISPER_REPLAY):
            step_logits, caches = tf.decode_step(params, caches, toks[:, i:i + 1], i, c32)
            errs.append(_rel(step_logits[:, 0], full[:, i]))
    out["replay_fp32"] = {"tokens": WHISPER_REPLAY, "rel_err_max": max(errs), "tol": 1e-3}
    print(json.dumps({"whisper_replay": out["replay_fp32"]}), flush=True)
    assert max(errs) <= 1e-3, out["replay_fp32"]
    return out


def phase_paligemma(get_config, tf, steps_lib, flatten_with_paths, ops) -> dict:
    """Phase 12, paligemma-3b whole at full width (fp32 params from seed 0):
    (a) bf16 and fp32 prefills of 2 × (256 image + 512 text) tokens through
    ``make_prefill`` on the dense path (the kernel cannot take the prefix
    mask), timed, with their peak memory; (b) its first 2 layers, fp32, the
    card against the CPU. Returns numbers only, so its params die with the call."""
    dev = torch.device("cuda")
    cfg = get_config("paligemma-3b")
    params, out = _init_counted(tf, flatten_with_paths, cfg)
    print(json.dumps({"paligemma_params": out}), flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)

    def batch_of(b, s):
        return {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev),
                "image_embeds": torch.randn((b, cfg.num_image_tokens, cfg.d_model),
                                            generator=gen, device=dev)}
    batch = batch_of(*PALIGEMMA_PREFILL)
    s_all = cfg.num_image_tokens + PALIGEMMA_PREFILL[1]
    logits = {}
    for dtype in ("bfloat16", "float32"):
        c = cfg.replace(compute_dtype=dtype)
        prefill = steps_lib.make_prefill(c, dev)
        n0 = ops.LAUNCHES["flash_attention"]
        torch.cuda.reset_peak_memory_stats()
        y, first_s = _timed(prefill, params, batch)
        del y
        logits[dtype], prefill_s = _timed(prefill, params, batch)
        y = logits[dtype]
        out[f"prefill_{dtype}"] = {
            "tokens": [PALIGEMMA_PREFILL[0], s_all], "first_s": first_s, "prefill_s": prefill_s,
            "flash_launches": ops.LAUNCHES["flash_attention"] - n0,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "finite": bool(torch.isfinite(y).all())}
        print(json.dumps({"paligemma_prefill": dtype, **out[f"prefill_{dtype}"]}), flush=True)
        assert y.shape == (PALIGEMMA_PREFILL[0], s_all, cfg.vocab_size) and y.dtype == c.cdtype
        assert out[f"prefill_{dtype}"]["finite"], out
        assert out[f"prefill_{dtype}"]["flash_launches"] == 0, out
    out["bf16_vs_fp32"] = {"rel_max_err": _rel(logits["bfloat16"], logits["float32"]),
                           "argmax_agree": _agree(logits["bfloat16"], logits["float32"]),
                           "tol": "printed only"}
    print(json.dumps({"paligemma_bf16_vs_fp32": out["bf16_vs_fp32"]}), flush=True)
    del logits, y, batch
    torch.cuda.empty_cache()

    # (b) the first two layers, fp32: the card against the CPU on the same params
    c_lead, p_lead = _leading(tf, params, cfg.replace(compute_dtype="float32"), 2)
    lead = batch_of(*PALIGEMMA_LEAD)
    with torch.inference_mode():
        card, _ = tf.forward_logits(p_lead, lead, c_lead)
        cpu, _ = tf.forward_logits(_map(lambda t: t.cpu(), p_lead),
                                   {k: v.cpu() for k, v in lead.items()}, c_lead)
    out["leading_card_vs_cpu"] = {"layers": c_lead.n_layers,
                                  "tokens": [cfg.num_image_tokens, PALIGEMMA_LEAD[1]],
                                  "rel_err": _rel(card.cpu(), cpu), "tol": 1e-4,
                                  "argmax_agree": _agree(card.cpu(), cpu)}
    print(json.dumps({"paligemma_leading": out["leading_card_vs_cpu"]}), flush=True)
    assert out["leading_card_vs_cpu"]["rel_err"] <= 1e-4, out["leading_card_vs_cpu"]
    assert out["leading_card_vs_cpu"]["argmax_agree"] == 1.0, out["leading_card_vs_cpu"]
    return out


def phase_auto(train, grad_comm, cost_model, runs) -> dict:
    """Phase 13(a): bert-large with ``--comm auto`` in phase 5's settings. Each
    step's bucket log is read by wrapping ``all_reduce_grads``, as the JAX
    trainer's test does."""
    logs = []
    inner = grad_comm.all_reduce_grads

    def logged(*args, **kwargs):
        out = inner(*args, **kwargs)
        logs.append(out[2])
        return out

    out = {}
    grad_comm.all_reduce_grads = logged
    try:
        for name, flags, ref in AUTO_RUNS:
            logs.clear()
            res = train.main(TRAIN + flags)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            tag = "+int8" if "--compress" in flags else ""
            picks = [[(n, cost_model.select_algorithm(n, 4, cost_model.LUMORPH_LINK) + tag)
                      for n, _ in log] for log in logs]
            sizes = sorted({n for log in logs for n, _ in log})
            out[name] = {
                **res, "buckets": len(logs[-1]), "steps_logged": len(logs),
                "algos": sorted({a for log in logs for _, a in log}),
                "log_is_select_algorithm": [[list(e) for e in log] for log in logs] ==
                                           [[list(e) for e in log] for log in picks],
                "final_loss_equals": ref, "phase5_final_loss": runs[ref]["final_loss"],
                "final_loss_equal": res["final_loss"] == runs[ref]["final_loss"],
                "phase5_step_s": runs[ref]["step_s"],
                # model outputs of the paper's link constants, not measurements
                "alpha_beta_model_s": {str(n): {a: cost_model.algorithm_cost(
                    a, n, 4, cost_model.LUMORPH_LINK) for a in ("ring", "lumorph2", "lumorph4")}
                    for n in sizes},
                "alpha_beta_label": "alpha-beta model output of the paper's link constants "
                                    "(LUMORPH_LINK: 300 GB/s, alpha 0.7 us, MZI 3.7 us), "
                                    "not a measurement"}
            print(json.dumps({"auto": name, **out[name]}), flush=True)
            assert res["steps"] == 6 and len(logs) == 6, (res, len(logs))
            assert out[name]["log_is_select_algorithm"], out[name]
            assert out[name]["algos"] == ["lumorph4" + tag], out[name]
            assert out[name]["final_loss_equal"], out[name]
    finally:
        grad_comm.all_reduce_grads = inner
    return out


def phase_policies(get_config, registry, make_production_mesh, checked_policy) -> dict:
    """Phase 13(b): the production meshes' policy for every registered config."""
    out = {}
    for arch in sorted(registry):
        for name in ("single", "multi"):
            mesh = make_production_mesh(multi_pod=(name == "multi"))
            policy = checked_policy(get_config(arch), mesh)
            out.setdefault(arch, {})[name] = {"tp": policy.tp, "dp": policy.dp,
                                              "zero3": policy.zero3}
    print(json.dumps({"policies": out}), flush=True)
    assert [a for a, m in out.items() if m["single"]["zero3"]] == ["dbrx-132b"], out
    return out


def phase_kivi(get_config, tf, steps_lib, attn) -> dict:
    """Phase 13(c): danube's decode into the bf16 cache, then the same tokens
    into the int8 (KIVI) cache, at full width."""
    dev = torch.device("cuda")
    cfg = get_config("h2o-danube-1.8b")
    b, prompt, n_gen = KIVI["batch"], KIVI["prompt"], KIVI["gen"]
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tf.init_params(gen, cfg)
    tokens = torch.randint(0, cfg.vocab_size, (b, prompt), generator=gen, device=dev)
    written = []  # every (x, q, scale) the int8 cache takes
    quant = attn._quant_kv

    def recorded(x):
        q, scale = quant(x)
        written.append((x, q, scale))
        return q, scale

    def run(c, feed=None):
        caches = tf.init_caches(c, b, prompt + n_gen, dev)
        decode = steps_lib.make_decode_step(c, dev)
        for t in range(prompt):
            logits, caches = decode(params, caches, tokens[:, t:t + 1], t)
        cur = torch.argmax(logits[:, -1:], dim=-1)
        out, fed = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_gen):
            tok = cur if feed is None else feed[:, i:i + 1]
            logits, caches = decode(params, caches, tok, prompt + i)
            fed.append(tok)
            out.append(logits[:, -1])
            cur = torch.argmax(logits[:, -1:], dim=-1)
        torch.cuda.synchronize()
        tpot = (time.perf_counter() - t0) / n_gen
        nbytes = sum(t.numel() * t.element_size() for t in _leaves(caches))
        no_pos = sum(t.numel() * t.element_size() for c_ in caches for k, t in c_.items()
                     if k != "pos")
        return torch.stack(out, 1).float(), torch.cat(fed, 1), tpot, nbytes, no_pos, caches

    ref, fed, tpot16, bytes16, nopos16, _ = run(cfg)
    attn._quant_kv = recorded
    try:
        got, _, tpot8, bytes8, nopos8, caches8 = run(cfg.replace(kv_cache_dtype="int8"), fed)
    finally:
        attn._quant_kv = quant
    assert all("k_scale" in c for c in caches8) and caches8[0]["k"].dtype == torch.int8
    # the quantizer's bound, in fp64 of the fp32 values: |q·s − x| ≤ s/2 + ulp(127·s)
    excess, over_half, values = 0.0, 0, 0
    for x, q, scale in written:
        s64 = scale.double()[..., None]
        err = (q.double() * s64 - x.double()).abs()
        amax = (scale * 127.0).float()
        ulp = (torch.nextafter(amax, torch.full_like(amax, math.inf)) - amax).double()[..., None]
        excess = max(excess, float(((err - s64 / 2) / ulp).max()))
        over_half += int((err > s64 / 2).sum())
        values += x.numel()
    rel = float((got - ref).abs().max() / ref.abs().max())
    out = {"arch": cfg.name, "batch": b, "prompt": prompt, "gen": n_gen,
           "compute_dtype": cfg.compute_dtype, "param_dtype": cfg.param_dtype,
           "kv_slots": prompt + n_gen, "quantized_writes": len(written),
           "quantized_values": values,
           "bound_excess_max_ulps_of_amax": excess, "values_past_half_scale": over_half,
           "logits_rel_err": rel, "tol": KIVI_TOL,
           "argmax_agree": float((got.argmax(-1) == ref.argmax(-1)).float().mean()),
           "tpot_s": {"bf16": tpot16, "int8": tpot8},
           "cache_bytes": {"bf16": bytes16, "int8": bytes8},
           "cache_bytes_without_pos": {"bf16": nopos16, "int8": nopos8},
           "int8_over_bf16": nopos8 / nopos16, "expected": (1 + 4 / cfg.head_dim) / 2}
    print(json.dumps({"kivi": out}), flush=True)
    assert len(written) == 2 * cfg.n_layers * (prompt + n_gen), len(written)
    assert excess <= 1.0, out
    assert torch.isfinite(got).all() and rel <= KIVI_TOL, out
    assert math.isclose(out["int8_over_bf16"], out["expected"], rel_tol=1e-12), out
    del params, written, caches8
    return out


def _dryrun_cell(cell: tuple[str, str]) -> list[dict]:
    """One dry-run cell on both meshes, in a worker process: the second mesh
    reuses the first's count."""
    from repro_torch.launch import dryrun
    return [dryrun.run_cell(*cell, mesh) for mesh in DRYRUN_MESHES]


def phase_dryrun(dryrun, roofline) -> dict:
    """Phase 14(a) and (b): every dry-run cell on both meshes, the cells shared
    out over ``DRYRUN_WORKERS`` processes (host work on the meta device), then
    the roofline over the records."""
    import multiprocessing
    cells = dryrun.all_cells()
    shutil.rmtree(dryrun.OUT_DIR, ignore_errors=True)  # this run's records only
    mem = torch.cuda.get_device_properties(0).total_memory
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(DRYRUN_WORKERS) as pool:
        by_cell = pool.map(_dryrun_cell, cells, chunksize=1)
    out = {"cells": len(cells), "card_memory_bytes": mem, "workers": DRYRUN_WORKERS,
           "s": time.perf_counter() - t0, "meshes": {}}
    for i, mesh in enumerate(DRYRUN_MESHES):
        recs = [pair[i] for pair in by_cell]
        bad = [(r["arch"], r["shape"], r.get("error")) for r in recs if not r["ok"]]
        assert not bad, bad
        for r in recs:
            print(json.dumps({"dryrun": f"{r['arch']}/{r['shape']}/{mesh}",
                              "flops_per_device": r["cost"]["flops"],
                              "argument_bytes": r["memory"]["argument_bytes"],
                              "s": r["total_s"]}), flush=True)
        over = [f"{r['arch']}/{r['shape']}" for r in recs
                if r["memory"]["argument_bytes"] > mem]
        out["meshes"][mesh] = {"cells": len(recs), "argument_bytes_over_card": over}
        print(json.dumps({"dryrun_mesh": mesh, **out["meshes"][mesh]}), flush=True)
        rows = roofline.main(["--mesh", mesh])
        assert len(rows) == len(cells), (mesh, len(rows))
        out["meshes"][mesh]["dominant"] = roofline.dominant_counts(rows)
        out["meshes"][mesh]["frac_over_1"] = roofline.over_bound(rows)
        print(json.dumps({"roofline_mesh": mesh, "dominant": out["meshes"][mesh]["dominant"],
                          "max_roofline_frac": max(r["roofline_frac"] for r in rows)}),
              flush=True)
        assert not out["meshes"][mesh]["frac_over_1"], out["meshes"][mesh]  # a count too low
    return out


def _count_global(dryrun, arch: str, shape) -> tuple[dict, dict]:
    """The dry-run's count of one program on a 1 × 1 mesh: global FLOPs and
    bytes, and its roofline terms."""
    from repro_torch.launch import roofline
    from repro_torch.sharding.policy import MeshShape
    cell = dryrun.build_cell(arch, shape, MeshShape(("data", "model"), (1, 1)))
    counts = dryrun.count_step(cell["run"], cell["params"],
                               dryrun.param_scopes(cell["cfg"], cell["params"]))
    flops, byts = dryrun.split_per_device(counts, cell["cfg"], cell["policy"], cell["shape"])
    assert flops == counts["global_flops"], (flops, counts["global_flops"])
    terms = roofline.terms(flops, byts, cell["collectives"]["total_bytes"],
                           cell["cfg"].compute_dtype)
    return {"flops": flops, "bytes_accessed": byts}, terms


def phase_roofline_card(dryrun, get_config, tf, steps_lib, pipeline, AdamWConfig, train,
                        ops) -> dict:
    """Phase 14(c): the roofline's count and bound against two programs run
    on the card."""
    from repro_torch.configs.shapes import ShapeSpec
    from torch.utils.flop_counter import FlopCounterMode
    dev = torch.device("cuda")
    out = {}
    # danube's bf16 prefill, dense and through the kernel
    b, s = ROOFLINE_PREFILL
    count, terms = _count_global(dryrun, "h2o-danube-1.8b",
                                 ShapeSpec("prefill_2x4608", "prefill", s, b))
    cfg = get_config("h2o-danube-1.8b")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tf.init_params(gen, cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)}
    dense = steps_lib.make_prefill(cfg, dev)
    kernel = steps_lib.make_prefill(cfg.replace(use_pallas=True), dev)
    with FlopCounterMode(display=False) as fc:
        dense(params, batch)
    card_flops = float(fc.get_total_flops())
    times = {"dense": [], "kernel": []}
    launches = []
    for name in ("dense", "kernel", "dense", "kernel"):
        n0 = ops.LAUNCHES["flash_attention"]
        times[name].append(cuda_ms(lambda: (dense if name == "dense" else kernel)(params, batch),
                                   1) / 1e3)
        launches.append(ops.LAUNCHES["flash_attention"] - n0)
    del params, batch
    torch.cuda.empty_cache()
    # cuda_ms makes two calls (a warm-up and the timed one): 24 launches per prefill
    assert launches == [0, 2 * cfg.n_layers, 0, 2 * cfg.n_layers], launches
    frac = [terms["bound_s"] / t for t in times["dense"]]
    out["danube_prefill"] = {
        "tokens": [b, s], **count, "card_flops": card_flops, **terms,
        "dense_s": times["dense"], "kernel_s": times["kernel"], "roofline_frac": frac,
        "kernel_frac_of_dense_bound": [terms["bound_s"] / t for t in times["kernel"]],
        "flash_launches_per_prefill": launches[1] // 2}
    print(json.dumps({"roofline_card": "danube_prefill", **out["danube_prefill"]}), flush=True)
    assert card_flops == count["flops"], (card_flops, count["flops"])
    assert max(frac) <= ROOFLINE_FRAC_MAX, frac
    # one bert-large training step, phase 5's settings
    rows, seq, dp = 8, 128, 4
    count, terms = _count_global(dryrun, "bert-large", ShapeSpec("train_8x128", "train", seq,
                                                                  rows))
    cfg = get_config("bert-large")
    step = steps_lib.make_train_step(cfg, AdamWConfig(), comm="lumorph4", dp=dp,
                                     wire_dtype=torch.float32, device=dev)
    params, opt = steps_lib.init_train_state(cfg, dp, 0, dev)
    _, batch = next(iter(pipeline.stream(cfg, pipeline.DataConfig(seed=0, global_batch=rows,
                                                                  seq_len=seq))))
    with FlopCounterMode(display=False) as fc:
        step(params, opt, batch)
    card_flops = float(fc.get_total_flops())
    del params, opt, step
    torch.cuda.empty_cache()
    res = train.main(TRAIN + TRAIN_RUNS[1][1])
    torch.cuda.empty_cache()
    frac = terms["bound_s"] / res["step_s"]
    out["bert_step"] = {"rows": rows, "seq": seq, "ranks": dp, "comm": "lumorph4", **count,
                        "card_flops": card_flops, **terms, "step_s": res["step_s"],
                        "roofline_frac": frac, "final_loss": res["final_loss"]}
    print(json.dumps({"roofline_card": "bert_step", **out["bert_step"]}), flush=True)
    assert card_flops == count["flops"], (card_flops, count["flops"])
    assert frac <= ROOFLINE_FRAC_MAX, frac
    return out


def phase_examples() -> dict:
    """Phase 14(d): the three example twins on the card."""
    out = {"serve_decode": _load_example("torch_serve_decode").main(["--device", "cuda"])}
    for arch, res in out["serve_decode"].items():
        assert res["finite"] and res["generated_shape"] == [4, 16], (arch, res)
    torch.cuda.empty_cache()
    quick = _load_example("torch_quickstart").main(["--device", "cuda"])
    assert all(quick["exact"].values()), quick["exact"]
    assert quick["train"]["steps"] == 10 and math.isfinite(quick["train"]["final_loss"])
    out["quickstart"] = quick
    torch.cuda.empty_cache()
    shutil.rmtree(BERT_LUMORPH_CKPT, ignore_errors=True)
    bert = _load_example("torch_train_bert_lumorph").main(
        ["--device", "cuda", "--ckpt-dir", str(BERT_LUMORPH_CKPT)])
    shutil.rmtree(BERT_LUMORPH_CKPT, ignore_errors=True)
    for phase in ("phase1", "phase3"):
        assert all(math.isfinite(bert[phase][k]) for k in ("first_loss", "final_loss")), bert
    assert bert["phase1"]["steps"] == 20 and bert["phase3"]["steps"] == 10, bert  # resumed at 20
    out["train_bert_lumorph"] = bert
    print(json.dumps({"examples": {"serve_decode": out["serve_decode"],
                                   "quickstart": {k: v for k, v in quick.items()},
                                   "train_bert_lumorph": bert}}, default=str), flush=True)
    torch.cuda.empty_cache()
    return out


def _rack_serve_prices(m, prof):
    """The layout-free price an operator sizes a serving deployment by: the TP
    collective at its rank-space LUMORPH cost, no KV handoff."""
    g = m.tenant.granularity(prof)

    def tp(n_bytes: float) -> float:
        if g <= 1 or not prof.tp_collectives:
            return 0.0
        return min(m.cm.algorithm_cost(a, n_bytes, g, m.cm.LUMORPH_LINK)
                   for a in ("ring", "lumorph2", "lumorph4"))

    return m.tenant.SlicePrices(tp_prefill_s=tp(prof.tp_bytes),
                                tp_decode_s=tp(prof.tp_bytes * 16 / 4096.0),
                                kv_base_s=0.0, kv_per_byte_s=0.0)


def _rack_provision(m, trace, rho_target: float, mode: str):
    """Every serving tenant of ``trace`` re-issued at the replicas its
    ``mode`` rate needs (its first, mean or peak window's); training jobs as
    they were."""
    jobs = []
    for j in trace.jobs:
        if j.serve is None:
            jobs.append(j)
            continue
        prices = _rack_serve_prices(m, j.profile)
        if mode == "peak":
            rate = max(w.rate for w in j.serve.windows)
        elif mode == "first":
            rate = j.serve.windows[0].rate
        else:
            rate = j.serve.total_requests / j.serve.horizon_s
        n = m.tenant.required_replicas(j.serve, j.profile, prices, rate=rate,
                                       rho_target=rho_target)
        jobs.append(dataclasses.replace(j, chips=max(2, n) * m.tenant.granularity(j.profile)))
    return m.sim.Trace(jobs, trace.failures)


def rack_modules():
    """The port's modules that phase 14(e) drives, as ``rack_traces`` takes them."""
    import types
    from repro_torch import sim
    from repro_torch.core import cost_model, health, rack, sipac
    from repro_torch.serve import autoscale, requests, tenant
    from repro_torch.sim import workload
    return types.SimpleNamespace(sim=sim, workload=workload, requests=requests, tenant=tenant,
                                 autoscale=autoscale, health=health, cm=cost_model, rack=rack,
                                 sipac=sipac)


def rack_traces(m) -> dict:
    """Phase 14(e)'s traces, made by the generators of ``m`` (a namespace of one
    package's ``sim``, ``workload``, ``requests``, ``tenant``, ``autoscale``,
    ``health`` and ``cm`` modules) from ``RACK_SEED``; the golden ones loaded."""
    w, s, c = m.workload, RACK_SERVE, RACK_CHAOS
    r = RACK_POISSON
    traces = {
        "fig2a": w.fig2a_trace(RACK_FIG2A["events"], seed=RACK_SEED),
        "poisson": w.poisson_trace(
            r["jobs"], arrival_rate=r["arrival_rate"], mean_steps=r["mean_steps"],
            compute_s=r["compute_s"], coll_bytes=r["coll_bytes"],
            size_sampler=lambda rng: int(rng.choice(r["sizes"])),
            failure_rate=r["failure_rate"], n_chips=r["chips"], seed=RACK_SEED),
        "morph": w.fig2a_trace(RACK_MORPH["events"], failure_rate=RACK_MORPH["failure_rate"],
                               n_chips=RACK_MORPH["chips"], seed=RACK_SEED),
        "pod": w.pod_churn_trace(RACK_POD["events"], n_chips=RACK_POD["chips"],
                                 chips_per_rack=RACK_POD["chips"] // RACK_POD["racks"],
                                 failure_rate=RACK_POD["failure_rate"], seed=RACK_SEED),
        "chaos": w.chaos_trace(c["events"], n_chips=c["chips"], tiles_per_server=c["tiles"],
                               link_fail_rate=0.05, trx_fail_rate=0.02, degrade_rate=0.02,
                               max_fibers_cut=2, derate=2.0, mttr=30.0, seed=RACK_SEED),
        "storm": w.glitch_storm_trace(c["storm_events"], n_chips=c["chips"], glitch_every=6.0,
                                      glitch_duration=3.0, glitch_prob=0.5, seed=RACK_SEED),
    }
    traces["failstop"] = w.fail_stop_trace(traces["chaos"], tiles_per_server=c["tiles"])
    prof = m.workload.CollectiveProfile(**RACK_SERVE_PROFILE)
    for pattern, (base, peak) in RACK_SERVE_RATES.items():
        raw = m.requests.serve_trace(
            2, [prof], pattern=pattern, horizon_s=s["horizon_s"], window_s=s["window_s"],
            base_rate=base, peak_rate=peak, prompt_tokens=s["prompt"],
            output_tokens=s["output"], slo_ttft_s=s["slo_ttft_s"], slo_tpot_s=s["slo_tpot_s"],
            seed=RACK_SEED, p_burst=s["p_burst"], mean_burst_windows=s["mean_burst_windows"],
            burst_mult=s["burst_mult"])
        for arm, (rho, mode, _) in RACK_SERVE_ARMS.items():
            traces[f"serve_{pattern}/{arm}"] = _rack_provision(m, raw, rho, mode)
    for name in ("trace_0", "trace_1"):
        traces[name] = m.sim.Trace.from_jsonl((RACK_GOLDEN / f"{name}.jsonl").read_text())
    return traces


def _rack_sim(m, kind: str, trace, **kw):
    return m.sim.RackSimulator(kind, trace, **kw).run()


def rack_runs(m, traces: dict) -> dict:
    """Phase 14(e)'s simulator runs: name -> (trace name, a callable that runs
    one ``RackSimulator`` of ``m`` on that trace and returns its metrics)."""
    p = functools.partial
    runs = {}
    for trace, chips in (("fig2a", RACK_FIG2A["chips"]), ("poisson", RACK_POISSON["chips"])):
        for kind in RACK_KINDS:
            runs[f"{trace}/{kind}"] = (trace, p(_rack_sim, m, kind, n_chips=chips))
    for tag, morph in (("static", None), ("morph", True)):
        runs[f"morph/{tag}"] = ("morph", p(_rack_sim, m, "lumorph", n_chips=RACK_MORPH["chips"],
                                           fibers_per_server_pair=RACK_MORPH["fibers"],
                                           morph=morph))
    for tag, span in (("span", True), ("confined", False)):
        runs[f"pod/{tag}"] = ("pod", p(_rack_sim, m, "lumorph", n_chips=RACK_POD["chips"],
                                       n_racks=RACK_POD["racks"], span_racks=span, morph=True))
    for pattern in RACK_SERVE_RATES:
        for arm, (_, _, auto) in RACK_SERVE_ARMS.items():
            scale = m.autoscale.AutoscaleConfig(max_step_up=RACK_SERVE["max_step_up"]) \
                if auto else None
            runs[f"serve_{pattern}/{arm}"] = (
                f"serve_{pattern}/{arm}",
                p(_rack_sim, m, "lumorph", n_chips=RACK_SERVE["chips"], serve_autoscale=scale))
    chaos = dict(n_chips=RACK_CHAOS["chips"], fibers_per_server_pair=RACK_CHAOS["fibers"],
                 morph=True)
    runs["chaos/degraded"] = ("chaos", p(_rack_sim, m, "lumorph", **chaos))
    runs["chaos/failstop"] = ("failstop", p(_rack_sim, m, "lumorph", **chaos))
    runs["storm/retry"] = ("storm", p(_rack_sim, m, "lumorph", ocs_retry=m.health.OCSRetryPolicy(),
                                      **chaos))
    runs["storm/noretry"] = ("storm", p(_rack_sim, m, "lumorph", ocs_retry=None, **chaos))
    for name, (trace, kw) in RACK_GOLDEN_RUNS.items():
        runs[f"golden/{name}"] = (trace, p(_rack_sim, m, "lumorph", **kw))
    return runs


def rack_record(metrics) -> dict:
    """A run's metrics as plain data: every field, the tenants' records too."""
    out = {}
    for k, v in sorted(vars(metrics).items()):
        if k == "tenants":
            v = {t: dataclasses.asdict(r) for t, r in v.items()}
        out[k] = v
    return out


def phase_rack(m) -> dict:
    """Phase 14(e): ``rack_runs`` on the host, each twice, with the checks of
    the JAX package's benchmarks; the golden fixtures; SiPAC on LUMORPH; the
    rack example twins."""
    t0 = time.perf_counter()
    traces = rack_traces(m)
    out = {"trace_s": time.perf_counter() - t0, "host_s": {}, "summary": {}, "digest": {}}
    for name, (trace, run) in rack_runs(m, traces).items():
        t0 = time.perf_counter()
        first = run(traces[trace])
        out["host_s"][name] = time.perf_counter() - t0
        assert rack_record(run(traces[trace])) == rack_record(first), name  # deterministic
        out["summary"][name] = summary = first.summary()
        if name.startswith("serve_"):
            out["summary"][name] = {**summary, **first.serve_summary()}
        if name.startswith("golden/"):
            fixture = json.loads((RACK_GOLDEN / f"{name.split('/')[1]}.json").read_text())
            assert summary == fixture, name
        out["digest"][name] = hashlib.sha256(json.dumps(
            rack_record(first), sort_keys=True, default=str).encode()).hexdigest()[:16]
        print(json.dumps({"rack_run": name, "host_s": out["host_s"][name],
                          "digest": out["digest"][name], "summary": out["summary"][name]}),
              flush=True)
    # Fig 2a under saturation: no fragmentation reject, and more goodput and
    # utilization than either baseline (raw acceptance converges there, so the
    # acceptance claim is the Poisson trace's, as in the JAX benchmarks)
    lum, tor, sip = (out["summary"][f"fig2a/{k}"] for k in RACK_KINDS)
    assert lum["fragmentation_rejects"] == 0, lum
    for key in ("goodput_chip_seconds", "mean_utilization"):
        assert lum[key] > max(tor[key], sip[key]), key
    lum, tor, sip = (out["summary"][f"poisson/{k}"] for k in RACK_KINDS)
    assert lum["fragmentation_rejects"] == 0, lum
    assert lum["acceptance_rate"] >= max(tor["acceptance_rate"], sip["acceptance_rate"])
    rack = m.rack.default_rack(n_chips=64, tiles_per_server=8, fibers_per_server_pair=64)
    chips = tuple(range(8, 16))
    m.sipac.configure_sipac_on_lumorph(rack, chips, 2, 3)
    out["sipac_exact"] = m.sipac.emulation_is_exact(rack, chips, 2, 3)
    assert out["sipac_exact"], "SiPAC(2, 3) on LUMORPH is not exact"
    out["twins"] = {}
    shutil.rmtree(RACK_TMP, ignore_errors=True)
    RACK_TMP.mkdir(parents=True)
    for name in RACK_TWINS:
        buf = io.StringIO()
        t0 = time.perf_counter()
        tempfile.tempdir = str(RACK_TMP)  # simulate_rack saves its trace there
        try:
            with contextlib.redirect_stdout(buf):
                runpy.run_path(str(ROOT / "examples" / f"{name}.py"), run_name="__main__")
        finally:
            tempfile.tempdir = None
        out["twins"][name] = {"host_s": time.perf_counter() - t0,
                              "lines": len(buf.getvalue().splitlines())}
        print(buf.getvalue(), end="", flush=True)
        if name == "torch_multi_tenant_rack":
            assert "exact=True" in buf.getvalue(), buf.getvalue()
    shutil.rmtree(RACK_TMP, ignore_errors=True)
    out["host_s_total"] = sum(out["host_s"].values())
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _timed(fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = fn(*args)
    torch.cuda.synchronize()
    return y, time.perf_counter() - t0


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available; this script runs on the card only")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.bridge import flatten_with_paths
    from repro_torch.configs import REGISTRY, get_config
    from repro_torch.core import collectives, cost_model
    from repro_torch.kernels import build, ops, ref
    from repro_torch.data import pipeline
    from repro_torch.launch import dryrun, roofline, serve, train
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.optim import grad_comm
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.launch.steps import make_prefill
    from repro_torch.models import attention as attn
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import apply_norm

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_s = {}

    def done(phase: str, t0: float) -> None:
        phase_s[phase] = time.perf_counter() - t0
        print(json.dumps({"phase": phase, "s": phase_s[phase]}), flush=True)

    def reset_launches() -> None:
        for name in ops.LAUNCHES:
            ops.LAUNCHES[name] = 0

    # -- phase 1: device and build ----------------------------------------
    t_phase = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0]}), flush=True)
    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: ptxas_report(path.with_suffix(".log")) for name, path in libs.items()}
    for d, entries in ((DANUBE["d"], FLASH_ENTRY), (DBRX["d"], FLASH_ENTRY_128),
                       (ZAMBA2["d"], FLASH_ENTRY_64)):
        for dt, entry in entries.items():
            ptxas["flash_attention"]["entries"][entry]["dynamic_smem_bytes"] = \
                ops.flash_attention_launch_info(d, dt)["smem_bytes"]
    for name in libs:
        print(json.dumps({"built": name, "build_s": build_s, "ptxas": ptxas[name]}), flush=True)
    flash_sass = sass_counts(libs["flash_attention"], build.nvcc())
    print(json.dumps({"flash_attention_sass": flash_sass}), flush=True)
    # every entry the phase-2 shapes run is a tensor-core kernel, fp32 included
    for entry in {e for m in (FLASH_ENTRY, FLASH_ENTRY_128, FLASH_ENTRY_64) for e in m.values()}:
        assert flash_sass[entry]["HMMA"] + flash_sass[entry]["HGMMA"] > 0, (entry, flash_sass[entry])
    torch.cuda.synchronize()
    done("1_build", t_phase)

    # -- phase 2: kernels against their plain versions ---------------------
    t_phase = time.perf_counter()
    kern = phase_kernels(ops)
    print(json.dumps({"kernel_checks": kern["checks"]}), flush=True)
    int8 = phase_int8(ops, ref)
    print(json.dumps({"int8_checks": int8["checks"]}), flush=True)
    rms = phase_rmsnorm(ops, ref)
    print(json.dumps({"rmsnorm_checks": rms["checks"], "rmsnorm_timed": rms["timed"]}),
          flush=True)
    ln = phase_layernorm(ops, ref)
    print(json.dumps({"layernorm_checks": ln["checks"], "layernorm_timed": ln["timed"]}),
          flush=True)
    done("2_kernels", t_phase)

    # -- phases 3 and 4: the serving path -----------------------------------
    t_phase = time.perf_counter()
    reset_launches()
    prefill = phase_prefill(get_config, tf, make_prefill, ops)
    res = serve.main(["--arch", "h2o-danube-1.8b", *SERVE])
    torch.cuda.synchronize()
    serving = dict(ops.LAUNCHES)
    assert res["finite"] and res["generated_shape"] == [4, 32], res
    assert res["ttft_s"] > 0 and res["tpot_s"] > 0, res
    assert serving["flash_attention"] > 0, serving
    assert all(serving[k] == 0 for k in LN_STEP), serving  # danube's norms are RMSNorm
    torch.cuda.empty_cache()
    done("3_4_serving", t_phase)

    # -- phase 5: the training path -----------------------------------------
    t_phase = time.perf_counter()
    reset_launches()
    runs = phase_train(train)
    torch.cuda.synchronize()
    training = dict(ops.LAUNCHES)
    assert training["quantize_int8"] > 0 and training["dequantize_int8"] > 0, training
    # every LayerNorm of the training path through the kernels: each of the four virtual
    # ranks' steps (six in each of TRAIN_RUNS, three after the restart) launches LN_STEP
    rank_steps = 4 * (6 * len(TRAIN_RUNS) + 3)
    assert all(training[k] == n * rank_steps for k, n in LN_STEP.items()), training
    print(json.dumps({"launches": {"serving": serving, "training": training}}), flush=True)
    done("5_training", t_phase)

    # -- phase 7: overlap mode, the RMSNorm kernel as each chunk's consumer --
    t_phase = time.perf_counter()
    reset_launches()
    overlap = phase_overlap(ops, ref, collectives)
    torch.cuda.synchronize()
    overlapping = dict(ops.LAUNCHES)
    assert overlapping["rmsnorm"] > 0, overlapping
    print(json.dumps({"launches": {"overlap": overlapping}}), flush=True)
    done("7_overlap", t_phase)

    # -- phase 8: deepseek-v2-lite-16b whole: MLA and MoE at full width -------
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    reset_launches()
    deepseek = phase_deepseek(get_config, tf, steps_lib, flatten_with_paths, ops,
                              moe_lib)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9  # (e) starts with nothing of (a)–(d)
    assert held_gb < 1.0, held_gb
    res = serve.main(["--arch", "deepseek-v2-lite-16b", *SERVE])
    torch.cuda.synchronize()
    deepseek["serve"] = {**res, "held_gb_before": held_gb}
    deepseek["launches"] = dict(ops.LAUNCHES)
    assert res["finite"] and res["generated_shape"] == [4, 32], res
    assert res["ttft_s"] > 0 and res["tpot_s"] > 0, res
    assert deepseek["launches"]["flash_attention"] == 0, deepseek["launches"]  # MLA: no kernel
    torch.cuda.empty_cache()
    done("8_deepseek", t_phase)

    # -- phase 9: dbrx-132b's MoE blocks, 2 layers, through the flash kernel ---
    t_phase = time.perf_counter()
    reset_launches()
    dbrx = phase_dbrx(get_config, tf, attn, apply_norm, steps_lib, ops)
    torch.cuda.synchronize()
    assert dbrx["launches"]["flash_attention"] == 2 * DBRX_LAYERS, dbrx["launches"]
    print(json.dumps({"launches": {"deepseek": deepseek["launches"],
                                   "dbrx": dbrx["launches"]}}), flush=True)
    torch.cuda.empty_cache()
    done("9_dbrx", t_phase)

    # -- phase 10: phi3, codeqwen and glm4 at full width, one at a time -------
    t_phase = time.perf_counter()
    dense, dense_launches = {}, {}
    for arch in DENSE_TRIO:
        torch.cuda.empty_cache()
        reset_launches()
        dense[arch] = phase_dense(get_config, tf, steps_lib, flatten_with_paths, ops, arch)
        torch.cuda.synchronize()
        dense_launches[arch] = dict(ops.LAUNCHES)
        # bf16 and fp32 prefills, each one launch per layer
        assert dense_launches[arch]["flash_attention"] == 2 * dense[arch]["n_layers"], arch
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9  # the serving launcher starts with no model held
    assert held_gb < 1.0, held_gb
    reset_launches()
    res = serve.main(["--arch", DENSE_SERVED, *SERVE])
    torch.cuda.synchronize()
    dense["serve"] = {"arch": DENSE_SERVED, **res, "held_gb_before": held_gb}
    dense_launches["serve"] = dict(ops.LAUNCHES)
    assert res["finite"] and res["generated_shape"] == [4, 32], res
    assert res["ttft_s"] > 0 and res["tpot_s"] > 0, res
    print(json.dumps({"launches": {"dense": dense_launches}}), flush=True)
    torch.cuda.empty_cache()
    done("10_dense_trio", t_phase)

    # -- phase 11: zamba2-1.2b and xlstm-125m whole: mamba2, mLSTM, sLSTM ------
    t_phase = time.perf_counter()
    ssm_runs, ssm_launches = {}, {}
    for arch in SSM_ARCHS:
        torch.cuda.empty_cache()
        reset_launches()
        ssm_runs[arch] = phase_ssm(get_config, tf, steps_lib, flatten_with_paths, ops, arch)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held_gb = torch.cuda.memory_allocated() / 1e9
        assert held_gb < 1.0, held_gb
        res = serve.main(["--arch", arch, *SERVE])
        torch.cuda.synchronize()
        ssm_runs[arch]["serve"] = {**res, "held_gb_before": held_gb}
        ssm_launches[arch] = dict(ops.LAUNCHES)
        assert res["finite"] and res["generated_shape"] == [4, 32], res
        assert res["ttft_s"] > 0 and res["tpot_s"] > 0, res
        # the main path's: two bf16 prefills (the replay, card-vs-CPU check and
        # serving launch none), less (b')'s timing launches
        ssm_launches[arch]["flash_attention"] -= ssm_runs[arch]["timing_launches"]
        assert ssm_launches[arch]["flash_attention"] == 2 * SSM_ARCHS[arch]["launches"], arch
        torch.cuda.empty_cache()
    assert ssm_launches["xlstm-125m"]["layernorm_fwd"] > 0, ssm_launches  # xlstm's d 768
    print(json.dumps({"launches": {"ssm": ssm_launches}}), flush=True)
    done("11_ssm_hybrid", t_phase)

    # -- phase 12: whisper-tiny and paligemma-3b whole: the encdec and vlm kinds --
    t_phase = time.perf_counter()
    whisper_flash = phase_flash_whisper(ops)
    reset_launches()
    whisper = phase_whisper(get_config, tf, flatten_with_paths, ops)
    torch.cuda.synchronize()
    # two kernel encodes per dtype in (a)-(b)
    whisper["check_launches"] = dict(ops.LAUNCHES)
    assert whisper["check_launches"]["flash_attention"] == 4 * whisper["enc_layers"], whisper
    torch.cuda.empty_cache()
    reset_launches()  # the main path: the serving example alone
    res = _load_example("torch_whisper_serve").main(WHISPER_SERVE)
    torch.cuda.synchronize()
    whisper["serve"] = res
    whisper["launches"] = dict(ops.LAUNCHES)
    assert res["finite"] and res["generated_shape"] == [4, 24], res
    assert res["encode_s"] > 0 and res["ttft_s"] > 0 and res["tpot_s"] > 0, res
    assert whisper["launches"]["flash_attention"] == whisper["enc_layers"], whisper  # one encode
    # whisper's LayerNorms (d 384) through the forward kernel; serving takes no gradient
    assert whisper["launches"]["layernorm_fwd"] > 0, whisper["launches"]
    assert whisper["launches"]["layernorm_bwd"] == 0, whisper["launches"]
    torch.cuda.empty_cache()
    reset_launches()
    paligemma = phase_paligemma(get_config, tf, steps_lib, flatten_with_paths, ops)
    torch.cuda.synchronize()
    paligemma["check_launches"] = dict(ops.LAUNCHES)
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    assert held_gb < 1.0, held_gb
    reset_launches()  # the main path: the serving launcher alone
    res = serve.main(["--arch", "paligemma-3b", *SERVE])
    torch.cuda.synchronize()
    paligemma["serve"] = {**res, "held_gb_before": held_gb}
    paligemma["launches"] = dict(ops.LAUNCHES)
    assert res["finite"] and res["generated_shape"] == [4, 32], res
    assert res["ttft_s"] > 0 and res["tpot_s"] > 0, res
    assert paligemma["launches"]["flash_attention"] == 0, paligemma["launches"]  # prefix mask
    print(json.dumps({"launches": {"whisper_serve": whisper["launches"],
                                   "whisper_checks": whisper["check_launches"],
                                   "paligemma_serve": paligemma["launches"],
                                   "paligemma_checks": paligemma["check_launches"]}}),
          flush=True)
    torch.cuda.empty_cache()
    done("12_whisper_paligemma", t_phase)

    # -- phase 13: --comm auto, the policy on the drivers, the KIVI cache -------
    t_phase = time.perf_counter()
    reset_launches()
    auto = phase_auto(train, grad_comm, cost_model, runs)
    torch.cuda.synchronize()
    auto_launches = dict(ops.LAUNCHES)
    assert auto_launches["quantize_int8"] > 0 and auto_launches["dequantize_int8"] > 0
    policies = phase_policies(get_config, REGISTRY, make_production_mesh, train.checked_policy)
    torch.cuda.empty_cache()
    reset_launches()
    kivi = phase_kivi(get_config, tf, steps_lib, attn)
    torch.cuda.synchronize()
    kivi_launches = dict(ops.LAUNCHES)
    assert kivi_launches["flash_attention"] == 0, kivi_launches  # KIVI attends densely
    print(json.dumps({"launches": {"auto": auto_launches, "kivi": kivi_launches}}), flush=True)
    torch.cuda.empty_cache()
    done("13_auto_policy_kivi", t_phase)

    # -- phase 14: the dry-run, the roofline against the card, the example twins --
    t_phase = time.perf_counter()
    dry = phase_dryrun(dryrun, roofline)
    reset_launches()
    roof = phase_roofline_card(dryrun, get_config, tf, steps_lib, pipeline, AdamWConfig, train,
                               ops)
    torch.cuda.synchronize()
    roofline_launches = dict(ops.LAUNCHES)
    reset_launches()
    examples = phase_examples()
    torch.cuda.synchronize()
    examples_launches = dict(ops.LAUNCHES)
    print(json.dumps({"launches": {"roofline": roofline_launches,
                                   "examples": examples_launches}}), flush=True)
    assert roofline_launches["flash_attention"] > 0, roofline_launches
    done("14_dryrun_roofline_examples", t_phase)

    # -- phase 14(e): the rack simulator, morph planner and autoscaler (host) ---
    t_phase = time.perf_counter()
    rack_sim = phase_rack(rack_modules())
    print(json.dumps({"rack_sim_host_s": rack_sim["host_s_total"], "card": smi,
                      "note": "host time: the simulator runs on the CPU, not the card"}),
          flush=True)
    done("14e_rack_sim", t_phase)

    # -- phase 15: the cross-process path, 4 ranks over gloo on this card -------
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks hold ~10 GB each
    dist_runs = phase_dist(runs)
    done("15_cross_process", t_phase)

    # -- phase 16: the model axis, data 2 x model 2 over gloo on this card -------
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    tp = phase_tp(train, get_config, tf, steps_lib)
    for dtype, res in tp["prefill"].items():
        res["phase3_kernel_prefill_s"] = prefill[dtype]["kernel_prefill_s"]
        print(json.dumps({"tp_prefill_s": dtype, "per_rank_gloo_host_staged":
                          res["prefill_s_per_rank_gloo_host_staged"],
                          "phase3_one_process": res["phase3_kernel_prefill_s"]}), flush=True)
    done("16_model_axis", t_phase)

    # -- phase 17: the placed decode and ZeRO-3, over gloo on this card ----------
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    rest = phase_decode_zero3(get_config, tf, steps_lib, tp)
    done("17_decode_zero3", t_phase)

    # -- phase 18: the MoE and MLA block kinds on the model axis, over gloo -------
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    moe_mla = phase_moe_mla(_jax_twin(), tf, steps_lib, train, moe_lib, attn, apply_norm)
    done("18_moe_mla_model_axis", t_phase)

    bf, f32 = kern["timed"]["danube"][torch.bfloat16], kern["timed"]["danube"][torch.float32]
    for dt, t in ((torch.bfloat16, bf), (torch.float32, f32)):  # the entries danube's D runs
        t["entry"] = FLASH_ENTRY[dt]
        t["ptxas"] = ptxas["flash_attention"]["entries"][FLASH_ENTRY[dt]]
        t["sass"] = flash_sass[FLASH_ENTRY[dt]]
    dbrx_attn = {"shape": DBRX, "launches": dbrx["launches"]["flash_attention"]}
    for dt, t in kern["timed"]["dbrx"].items():  # the entries dbrx's D = 128 runs
        dbrx_attn[str(dt).removeprefix("torch.")] = {
            **t, "entry": FLASH_ENTRY_128[dt], "sass": flash_sass[FLASH_ENTRY_128[dt]],
            "ptxas": ptxas["flash_attention"]["entries"][FLASH_ENTRY_128[dt]]}
    zamba2_attn = {"shape": ZAMBA2,
                   "launches": ssm_launches["zamba2-1.2b"]["flash_attention"],
                   "launches_per_prefill": ssm_runs["zamba2-1.2b"]["prefill_bf16"][
                       "flash_launches"]}
    for dt, t in kern["timed"]["zamba2"].items():  # the entries zamba2's D = 64 runs
        zamba2_attn[str(dt).removeprefix("torch.")] = {
            **t, "entry": FLASH_ENTRY_64[dt], "sass": flash_sass[FLASH_ENTRY_64[dt]],
            "ptxas": ptxas["flash_attention"]["entries"][FLASH_ENTRY_64[dt]]}
    whisper_attn = {"shape": WHISPER, "launches": whisper["launches"]["flash_attention"],
                    "launches_per_encode": whisper["enc_layers"],
                    "check_launches": whisper["check_launches"]["flash_attention"]}
    for dt, t in whisper_flash.items():  # whisper's D = 64, bidirectional
        whisper_attn[str(dt).removeprefix("torch.")] = {
            **t, "entry": FLASH_ENTRY_64[dt], "sass": flash_sass[FLASH_ENTRY_64[dt]],
            "ptxas": ptxas["flash_attention"]["entries"][FLASH_ENTRY_64[dt]]}
    records = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:31",
        "launches": serving["flash_attention"],
        "max_abs_err": bf["max_abs_err"], "ms": bf["ms"], "kernel_ms": bf["ms"],
        "plain_ms": bf["plain_ms"], "bound_ms": bf["bound_ms"], "bound_by": bf["bound_by"],
        "library_ms": bf["library_ms"], "tflops": bf["tflops"], "bound_frac": bf["bound_frac"],
        "dtype": "bfloat16", "shape": DANUBE,
        **{k: bf[k] for k in ("entry", "ptxas", "sass", "launch")}, "fp32": f32,
        "dbrx": dbrx_attn, "zamba2": zamba2_attn, "whisper": whisper_attn,
        "launches_by_path": {"danube_serving": serving["flash_attention"],
                             "dbrx": dbrx["launches"]["flash_attention"],
                             **{a: dense_launches[a]["flash_attention"] for a in DENSE_TRIO},
                             **{a: ssm_launches[a]["flash_attention"] for a in SSM_ARCHS},
                             "whisper-tiny": whisper["launches"]["flash_attention"],
                             "paligemma-3b": paligemma["launches"]["flash_attention"],
                             "roofline_danube": roofline_launches["flash_attention"],
                             "tp_prefill_per_rank": {
                                 dt: r["launches_per_rank"] for dt, r in tp["prefill"].items()},
                             "pod_mesh_prefill_per_rank": {
                                 dt: r["launches_per_rank"]
                                 for dt, r in tp["pod"]["prefill"].items()},
                             "moe_mla_tp_prefill_per_rank": {
                                 k: r["flash_launches_per_rank"]
                                 for k, r in moe_mla["prefill"].items()},
                             "hybrid_tp_prefill_encode_per_rank": {
                                 k: r["flash_launches_per_rank"]
                                 for k, r in moe_mla["hybrid"]["prefill"].items()}},
    }]
    for name, body in (("quantize_int8", 18), ("dequantize_int8", 27)):
        t = int8["timed"][name]
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/grad_compress.cu",
            "replaces": f"src/repro/kernels/grad_compress.py:{body}",
            "launches": training[name],
            "launches_by_path": {"training": training[name], "auto": auto_launches[name],
                                 "cross_process_per_rank": [
                                     x[name] for x in dist_runs["train"]["lumorph2+int8"][
                                         "launches_per_rank"]],
                                 "model_axis_per_rank": [
                                     x[name] for x in tp["train"]["lumorph2+int8"][
                                         "launches_per_rank"]],
                                 "zero3_per_rank": [
                                     x[name] for x in rest["zero3"]["lumorph2+int8"][
                                         "launches_per_rank"]],
                                 "pod_mesh_per_rank": [
                                     x[name] for x in tp["pod"]["train"]["212/lumorph2+int8"][
                                         "launches_per_rank"]]},
            "max_abs_err": max(c["max_abs_err"] for c in int8["checks"]),
            "ms": t[BUCKET_N]["ms"], "plain_ms": t[BUCKET_N]["plain_ms"],
            "bound_ms": t[BUCKET_N]["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "n": BUCKET_N, "leaf": {"n": LEAF_N, **t[LEAF_N]},
        })
    t = rms["timed"]["overlap_chunk"]
    records.append({
        "name": "rmsnorm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:18",
        "launches": overlapping["rmsnorm"],
        "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": "bytes", "library_ms": t["library_ms"],
        "shape": t["shape"], "dtype": t["dtype"], "danube_rows": rms["timed"]["danube_rows"],
        "launches_by_path": {"overlap": overlapping["rmsnorm"], "cross_process_per_rank": {
            C: r["rmsnorm_launches_per_rank"] for C, r in dist_runs["overlap"].items()}},
    })
    records.append({
        "name": "layernorm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/layernorm.cu",
        "replaces": None, "plain": "src/repro_torch/kernels/ref.py:reference_layernorm",
        "launches": {k: training[k] for k in LN_STEP},
        "launches_per_rank_step": LN_STEP,
        "max_err_over_limit": max(v for c in ln["checks"] for v in c["err_over_limit"].values()),
        **ln["timed"], "ptxas": ptxas["layernorm"],
        "launches_by_path": {"training": {k: training[k] for k in LN_STEP},
                             "auto": {k: auto_launches[k] for k in LN_STEP},
                             "whisper-tiny": {k: whisper["launches"][k] for k in LN_STEP},
                             "xlstm-125m": {k: ssm_launches["xlstm-125m"][k] for k in LN_STEP},
                             "danube_serving": {k: serving[k] for k in LN_STEP}},
    })
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"prefill": prefill, "train": runs, "overlap": overlap,
                      "deepseek": deepseek, "dbrx": dbrx, "dense": dense, "ssm": ssm_runs,
                      "whisper": whisper, "paligemma": paligemma, "auto": auto,
                      "policies": policies, "kivi": kivi, "dryrun": dry, "roofline": roof,
                      "examples": {k: v for k, v in examples.items() if k != "serve_decode"},
                      "rack_sim": {k: v for k, v in rack_sim.items() if k != "summary"},
                      "cross_process": dist_runs, "model_axis": tp,
                      "decode_zero3": rest, "moe_mla_model_axis": moe_mla,
                      "phase_s": phase_s,
                      "card": smi, "total_s": time.perf_counter() - t_start}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-rank"]:
        dist_rank(sys.argv[2])
    elif sys.argv[1:2] == ["--tp-rank"]:
        tp_rank(sys.argv[2])
    elif sys.argv[1:2] == ["--decode-rank"]:
        decode_rank(sys.argv[2])
    elif sys.argv[1:2] == ["--moe-rank"]:
        moe_rank(sys.argv[2])
    else:
        main()
