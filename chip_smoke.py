#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and the script
exits non-zero without printing a result:

  1. device   the card's name and power limit (nvidia-smi) and
              torch.cuda.get_device_name(0); no usable card raises.
  2. build    nvcc builds the kernels from paddle_tpu_torch/csrc (one
              process per source, started together); printed: the seconds
              it took, each kernel's registers and spills (ptxas), the
              backward kernels' shared memory per instantiation and the
              tensor-core instructions in the SASS (cuobjdump -sass: HMMA
              for mma.sync, HGMMA for wgmma) of every instantiation of the
              three flash kernels, their bf16 wgmma kernels (forward, dq
              and dk/dv at d <= 128, which must hold HGMMA and spill
              nothing) and the ragged span forms (the bf16-q one on wgmma
              at d <= 128: HGMMA, no spill; the bf16-q decode form's split
              walk spills nothing either); one without them, or missing,
              fails the run.
  3. kernels  each serving kernel's wrapper against its plain PyTorch
              version on the card: the ragged kernel over fp32 pools (K1)
              at LLaMA-2-7B heads and at a GQA layout over mixed spans
              (decode, chunks at start_pos > 0 crossing page boundaries, a
              dead slot, padded bucket rows); the ragged kernel over int8
              pools with per-page, per-kv-head scales and over
              float8_e4m3fn pools (K1-q) on the same codes and scales at
              LLaMA-2-7B heads (8 decode rows, T = 1, and a 256-row chunk
              at start_pos 256) and at the GQA layout; the paged-decode
              kernel (K2) at b=12, h=32, d=128 over a 4096-key table
              with pos on and off page and split boundaries, up to 4095
              and past the table, and a dead slot, then each of its
              sequences alone (bit for bit its batch output); then each
              at the shapes the engine gives it (phase 8). Tolerance: max |kernel - plain| <= 1e-4 in fp32
              (the two sum in different orders); padded and dead rows must
              be exactly 0. Times are medians of CUDA-event timings. The
              sweep over every head dim the gates admit, GQA group and page
              size is tests/test_torch_cuda.py.
 3s. sampler  the seeded sampler (the runner's _sampled_rows, which every
              sampled token goes through) on the card against the same
              function on the CPU: 64 rows of vocabulary 32000, seeds 0-7 x
              steps 0-7 x temperatures {0.3, 0.7, 1.0, 1.5} x (top_k,
              top_p) in {(None, None), (1, None), (50, None), (None, 0.9),
              (8, 0.9)}. Every token must be equal; one that parts prints
              its perturbed top-2 margin and fails the run.
  4. engine   LLaMA-2-7B at full width and depth, fp32, seeded random
              weights built on the card, served through
              inference.create_serving_engine: 8 requests with seeded
              prompt lengths 100-600 and max_tokens=32 under a 256-token
              prefill budget. Both kernels must have launched on this run
              (K2 once a layer on every decode call) and neither plain
              version; two requests must match
              naive_generate token for token (the first divergence, if
              any, is printed and fails the run).
  5. profile  where a serving step's time goes: torch.profiler over steps
              of one 256-token prefill chunk each and over decode-only
              steps of 8 sequences, device time by kernel group, each
              kernel's device time per launch, and the idle share against
              the wall of as many unprofiled steps. Decode steps run as
              replays of the runner's captured CUDA graph.
 5g. graphs   the same model, 8 sequences of 100-400 tokens prefilled into
              two copies of one pool: a decode step, a greedy horizon of 8
              (decode_multi) and a seeded early-stop horizon of 8, each run
              eagerly on one copy and through its graph on the other, twice
              (the first graphed call runs for real and captures, the second
              replays). Outputs and pools must be bitwise equal (max |diff|
              printed), and the launches a replay credits equal the eager
              call's. Each capture's seconds and graph pool are printed.
 5h. horizon  phase 4's 8 prompts with max_tokens 64: requests 0-3 greedy
              (a stop token each: their fp32 stream's 21st token), 4-7 at
              temperature 0.7, top_k 50, top_p 0.9, seeds 0-3 and a random
              stop token. Served by the per-step engine run eagerly and by
              the engine with decode_horizon=8, pipelined, horizon_sampling
              and horizon_early_stop, its decode kinds as CUDA graphs, each
              engine twice (its first round captures, its second replays).
              The streams must be equal token for token (the first
              divergence is printed), every request must finish and no
              page leak; the
              decode kernel (K2 over fp32 pools, K1-q's decode form over
              int8 / fp8) must launch once a layer on every inner decode
              step, and no plain version. Printed: tokens/s, TTFT, ms per
              decode token, host_syncs_per_token, horizon_overshoot_tokens,
              and a torch.profiler split of a horizon of 8 (device busy,
              host wall, idle share) beside phase 5's per-step decode.
  6. int8,    the same model at 8 of its 32 layers (full width; the
     fp8      process tier of phase 45 took the smoke's time), the same
              requests and budget served from an int8 and then an fp8 KV
              pool (kv_dtype="int8" / "fp8", 1024 pages of 16). Every prefill chunk and every decode
              step must launch the K1-q kernel of that dtype once per
              layer, and nothing else: no plain version, no K1 over fp32
              pools, no K2; chunks launch its span form and decode steps
              its decode form, both at least once. No page may leak. Each engine is then
              profiled as in phase 5. Reported, not gated: each
              engine's greedy agreement with its own naive_generate on
              two requests. cuBLAS rounds a row of
              an fp32 x @ w differently for another row count (printed
              first), the batch-8 engine and naive_generate run other row
              counts, and 1-byte K/V turn those 1-ulp differences into
              whole quantization steps. Gated instead: an engine with one
              slot serves the two shortest prompts (one chunk each, then
              batch-1 decode steps, naive_generate's row counts) through
              K1-q alone and must equal naive_generate token for token,
              for int8 and for fp8. Each pool then runs phases 5g and 5h
              (5h's stop tokens from that pool's own greedy streams).
  7. check    a 2-layer model at full width over int8 and over fp8 pools:
              two 256-token prefill chunks and 8 decode steps (a dead slot
              beside the live one) through K1-q, then the same steps on the
              plain gather path (attn_impl="reference") from fresh pools;
              the logits of every call within 1e-4 * max|logit|; the
              kernel run launches K1-q on every call (span form for the
              chunks, decode form for the steps) and nothing else.
  8. timing   each serving kernel at the engine's shapes against its plain
              version, its bound and the library yardstick (SDPA on K/V
              gathered and dequantized beforehand), with L2 flushed before
              every timed call and the card held ~0.5 ms before it, so the
              host's launch overhead is not timed: K1 and K1-q at a
              256-token chunk at start_pos 256 (span form) and at the
              decode step of 8 sequences (decode form; over fp32 pools at
              GQA n_rep 4, the timed row, and MHA), K2 at that decode
              step. K1, K1-q and K2 are first held against the plain
              version in fp64 at each of these shapes: the kernel's max error
              within twice the fp32 plain version's own; the mean signed
              error of both is printed. Then the engine is freed: under
              1 GiB may stay allocated before the trainer is built.
  9. flash    the flash kernels (K3a forward, K3b-dq, K3b-dkv) through the
              autograd.Function and torch.autograd.grad against their
              plain versions: b=1, s=4096, h=32, d=128 causal, and a sweep
              over d in {64, 128, 256}, causal or not, s in {1, 100, 257,
              1000}
              and cross lengths sq=128 < sk=384 (and sq=384 > sk=128).
              o and lse within 1e-4; each of dq, dk, dv within 1e-4 *
              max|plain gradient| (with one key, where the exact dq and dk
              are 0, within 1e-4 * max|plain dv|).
 10. masked   the same three kernels in their masked forms (K3-m), each
              through the autograd.Function and then through the plain
              versions on the same operands on the card (the wrappers'
              plain branch), at phase 9's tolerances: ERNIE's -1e4 key
              padding and a bool key padding (both lowered to the per-key
              bias), a dense additive mask shared by the heads and one per
              head, a bool mask whose rows 50.. see no key (o and dq
              exactly 0 there), segment ids with causal, a block mask
              implied by a dense mask; then flash_attn_unpadded,
              flashmask_attention (row ranges; a window) and
              sparse_attention (CSR + key padding). d in {64, 128},
              lengths on and off multiples of 64, sq != sk.
 11. trainer  the training path: LLaMA-2-7B widths at 8 of 32 layers,
              fp32, seeded random weights on the card, jit.TrainStep with
              AdamW(1e-4, weight decay 0.01, global-norm clip 1.0) on one
              seeded batch of 4096 tokens, 2 warm-up and 6 timed steps.
              Losses must be finite and fall, each flash kernel must launch
              8 times per step and no plain version at all.
 12. profile  where a training step's time goes: torch.profiler over 2
              steps, device time by group (matmul, K3a, K3b-dq, K3b-dkv,
              optimizer, other), each flash kernel's ms per launch and the
              idle share against 2 unprofiled steps.
 13. check    a 2-layer model at full width, seq 1024, trained one step
              through the kernels and once on the dense path
              (FLAGS_use_flash_attention off) from the same weights and
              batch: loss within 1e-5 relative, every gradient within 1e-3
              * its max|grad|.
 14. timing   at the trainer's shape (b=1, s=4096, h=32, d=128, causal):
              first the kernels against their plain versions (phase 9's
              tolerances) and o, lse, dq, dk, dv against the plain versions
              in fp64, within twice the fp32 plain versions' own error
              (fp32-class products; lse's errors printed in ulp too); the
              forward's o and lse gated so again on the stream the check
              read once phase 37 had drawn from the smoke's stream
              (lse_stream_check: seed 0 moved on by phase 37's draws,
              fault F16); then each flash kernel against its
              plain version, its bound and scaled_dot_product_attention
              as the yardstick, L2 flushed; the backward pair like for
              like: the whole flash_backward and the two kernels alone
              against SDPA's backward alone (autograd.grad of a retained
              graph).
 15. ERNIE    ERNIE-3.0-base pretraining (vocab 40000, hidden 768, 12
              layers, 12 heads, ffn 3072, 512 positions) at full width and
              depth, fp32, seeded random weights on the card, through
              jit.TrainStep(n_inputs=3) and AdamW(1e-4, weight decay 0.01)
              on bench.py::child_ernie's batch: 16 x 512 tokens at 85-100 %
              fill, 15 % masked, dropout 0; 2 warm-up and 6 timed steps.
              Losses must be finite and fall, each masked kernel must
              launch 12 times per step, and no dense flash kernel, plain
              version or dense attention at all.
 16. profile  where an ERNIE step's time goes, as phase 12 (groups K3a-m,
              K3b-dq-m, K3b-dkv-m).
 17. check    a 2-layer ERNIE at full width stepped once through the masked
              kernels and once on the dense path from the same weights and
              padded batch, phase 13's tolerances; then the outputs at
              real positions with the pad ids redrawn, within 2e-5.
 18. timing   phase 14 for the masked kernels at the ERNIE shape (q/k/v
              [16,512,12,64], the batch's kbias [16,512], full; SDPA with
              the broadcast float mask).
 20. bf16     the flash kernels' bf16 instantiations (AMP): (a) on bf16
              operands against the plain versions, both evaluated against
              the plain versions in fp64 on the same operands: o, lse, dq,
              dk and dv within twice the bf16 plain versions' own error,
              and o, dq, dk and dv misrounded (of the outputs the plain
              version rounds to bf16(exact), the share the kernel rounds
              elsewhere) at most 1/16 of the time, which sees the inner
              precision of the P and dS products that the max error
              cannot; at the Llama trainer's shape (causal), the ERNIE batch's
              shape and -1e4 key padding, a sweep over d in {64, 128} x
              causal / full x lengths 1, 100, 257, 1000 and 128 / 384
              crossed, phase 10's masked forms and one d = 256 case; each
              launch through the kernel `kernel_variant` names (wgmma at
              d <= 128, mma.sync above); (b) phase 14 and 18's timing at
              bf16 (plain versions and SDPA on the same bf16 operands; the
              bound at 2-byte operands and 989 TFLOP/s), then dq's time,
              its share of the bound and the pair's factor over SDPA's
              bf16 backward at both shapes.
 21. ERNIE O1 phase 15 at bf16 AMP O1 (child_ernie's amp_level), each masked
              bf16 kernel 12 times a step and nothing else (no fp32 flash
              kernel, plain version or dense attention); the forward, dq
              and dk/dv through their wgmma kernels (d = 64) every time
              (96 launches each), the mma.sync kernels of d > 128 never;
              profiled as 16.
 22. Llama O1 phase 11 at O1 through the dense bf16 kernels, the forward,
              dq and dk/dv through their wgmma kernels (d = 128) every
              time (64 launches each); profiled as 12.
 23. O2       a 2-layer Llama at full width after amp.decorate(level="O2"):
              bf16 parameters, fp32 master copies in AdamW, each parameter
              bit for bit its master cast to bf16 after every step; losses
              fall.
 24. twins    a 2-layer O1 step against the same step on the dense path
              (bf16) and against the fp32 step: loss within 1e-2, gradients
              within 5e-2 / 1e-1 of max|grad|.
 25. GPT      GPT-3 1.3B (GPT3_1_3B: vocab 50304, hidden 2048, 24 layers,
     serving  16 heads of 128, ffn 8192, 1024 positions, tied head) at full
              width and depth, fp32, seeded random weights, served as phase
              4 serves LLaMA-2-7B (1024 pages of 16, 8 slots, 256-token
              prefill budget, 8 requests of 100-600 prompt tokens, 32
              greedy tokens each; max_model_len 1024): every request
              finishes, no leak, K1 on every prefill chunk and K2 once a
              layer on every decode call, nothing else; two requests equal
              naive_generate; then one-slot int8 and fp8 engines through
              K1-q alone, token-exact against naive_generate (phase 6).
              The fp32 engine is profiled as in phase 5. Then K1, K1-q
              and K2 at the GPT shapes (16 heads) against their plain
              versions as phase 1 holds them: 256-token chunks, chunks of
              1-8 rows in the 8-row bucket, decode rows; and phase 7's
              check through GPTRunner: chunks of 256, 256, 8, 3 and 1
              tokens and 8 decode steps of 1-8 rows (the live sequence
              beside dead slots), the logits of every call within 1e-4 *
              max|logit| of the gather path's, at full depth over fp32
              pools and at 2 layers over int8 / fp8 (full depth there
              reported with the share of int8 / fp8 codes the two runs'
              own quantization parted, not gated); the kernel run
              launches K1's span form on the 256-token chunks and its
              decode form on the short ones, K2 (fp32) or K1-q's decode
              form (int8 / fp8) on the steps, and nothing else.
 26. gener-   the same model through models.generation at batch 8, prompt
     ators    256, 32 new tokens, caches of 512 positions:
              PagedGPTGenerator greedy launches K2 once a layer on every
              decode step and nothing else; GPTGenerator (dense cache)
              gives the same tokens, and both stepped on those tokens give
              logits within 1e-4 * max|logit| at every step (where a token
              parts, the top-2 margin there is printed and the run fails);
              a seeded sampled run equals the CPU sampler on the card's
              logits draw for draw; a beam run (num_beams 4) launches K2
              once a layer a step. ms per token step of each, and one
              greedy token step of each generator traced: host wall,
              device busy, idle share, host-to-device copies and stream
              waits a step.
 27. GPT      (a) GPT-3 1.3B at full depth, bf16 O1, [8, 1024] tokens,
     training AdamW(LinearWarmup(CosineAnnealingDecay(2e-4, 6, 2e-5), 2,
              0, 2e-4), weight decay 0.01, clip 1.0), 2 warm-up + 4 timed
              steps, the scheduler stepped after each: losses finite and
              falling, the rate each step reads equal to the scheduler's,
              each bf16 flash kernel once a layer a step on wgmma, nothing
              else; profiled as 12; (b) an fp32 2-layer GPT step at full
              width against the dense path (phase 13's tolerances); (c)
              the bf16 kernels at [8, 1024, 16, 128] causal against fp64
              (phase 20 (a)) and timed against their plain versions, their
              bound and SDPA (phase 20 (b)).
 28. prefix   the shared-prefix page cache at LLaMA-2-7B, full width and
     cache    depth, fp32 pools (1024 pages of 16), 8 slots, max_model_len
              1024, a 256-token prefill budget, audit on: a chat service's
              shared 512-token system prompt, 8 requests of it plus 64-192
              random tokens of their own, 32 greedy tokens each; request 0
              first, the other seven once its first token is out; served
              with the cache off and on: the streams of both arms equal,
              two requests equal naive_generate, prefix_hit_tokens = 7 x
              512, computed + hit tokens = the contexts, no leak after
              release_prefix_cache(), K1 and K2 only, no plain launch;
              cow_copies reported (no write lands on a shared page here).
              A cached page of the live pool forked through
              SequenceKV.ensure_writable: the source page's bytes (K, V,
              int8 scale rows) unchanged and the fork equal to them, on
              fp32, int8 and fp8 pools; the two arms again on one-slot
              int8 and fp8 engines (the first 3 requests, 16 tokens): their
              streams equal. Reported: TTFT (mean, requests 1-7), prefill
              tokens computed, tokens/s of each arm.
 29. fused    fused ragged steps (ragged_batch=True) at LLaMA-2-7B with phase
     ragged   4's traffic, plain then pipelined, counts zeroed before each:
              the streams equal phase 4's unfused engine; each step with
              chunks and decode rows is one ragged_step (K1 once a layer,
              its span form, no K2), each decode-only step K2 once a
              layer, no plain launch, the auditor clean. Profiled: lone
              256-token chunk steps, decode-only steps of 7 rows and fused
              steps of one 256-token chunk beside the 7 decode rows:
              device ms, K1 ms a launch, idle share.
 30. specu-   GPT-3 1.3B at full width, 6 of its 24 layers (cut from full
     lation   depth to pay for phases 40-44), with
              bench.py::child_serving_spec's traffic (8 requests, 256-token prompts repeating a random 3-6
              token pattern, 64 tokens each, a 64-token prefill budget),
              five arms, each served twice (the first round captures): off
              (decode_horizon 8, pipelined, early stop), per_step (4 draft
              tokens, ragged_batch, horizon 1), fused (4 drafts inside
              horizons of 8), draft (fused with spec_draft_model
              "shadow:fp32" and spec_adaptive_k) and draft_int8 (the same
              with "shadow", the int8 rung of phase 32): every arm's
              streams equal off's, two requests equal naive_generate, a
              seeded request (temperature 0.8) on per_step equals
              naive_generate with its seed, proposed > 0 in every
              speculative arm and accepted > 0 in the draft arms, the
              fused arm served eagerly gives its graph replays' streams,
              no leak, no plain launch. Reported: steps and host syncs a
              token, tokens/s, acceptance, capture seconds, K1 launches by
              form (a T = 8 verify span at MHA n_rep 1 takes the decode
              form).
 31. bf16     bf16 serving through create_serving_engine(dtype=bfloat16):
     serving  phase 3's checks of the bf16 variants (K1-bf16 over bf16
              pools, K1-q with bf16 q over int8 / fp8 pools, K2-bf16) at
              the Llama and GPT shapes against their plain versions in
              fp64, within twice the bf16 plain version's error and at
              most 1/16 misrounded, also at GQA-4 decode rows whose walks
              end on and across the decode form's 256-key splits and at
              the verify spans; the decode form's split walk batch-
              invariant bit for bit, and two chained launches under a
              CUDA graph equal to the eager launches; LLaMA-2-7B (after phases 32-33, cast
              to bf16 in place) and GPT-3 1.3B (after phase 30) on phase
              4's traffic: every call through the bf16 variants, no fp32
              kernel, no plain version; a horizon engine (decode_horizon
              8, graphs) equal to the per-step engine token for token;
              one-slot runs over bf16, int8 and fp8 pools token-exact
              against naive_generate (over int8 / fp8 through the span
              form and the split walk, "decode_split"); a 2-layer model at full width: the
              bf16 runner's logits within BF16_TWIN_TOL of max|logit| of
              its fp32 twin's, and (as phases 7 and 25 hold the fp32
              runner) its kernels over bf16, int8 and fp8 pools against
              its own gather path within BF16_GATHER_TOL, with the exact
              launches of every bf16 variant and form. Timed: the bf16
              variants at phase 8's shapes and K1-bf16 at the verify
              spans.
 32. weight   LLaMA-2-7B at 8 of its 32 layers (full width, for the
     ladder   smoke's time; fp32 compute) with weight_dtype int8, int4
              (group 128) and fp8
              on phase 4's traffic: the runner's bytes
              equal the shapes' formula (ladder_bytes), the reduction
              factor fp32 / those bytes, a one-slot engine token-exact
              against naive_generate; reported: tokens/s, decode-step ms,
              peak memory over the resident, the int4 rung's profile (the
              int8 and fp8 rungs cast the same way, one copy a weight).
              The int8 shadow draft runs as phase 30's draft_int8 arm.
 33. mixed    LLaMA-2-7B on a kv_dtype="mixed" pool with phase 28's
     pool     shared-prompt traffic, tenants fp32 and fp8 in turn, prefix
              cache on: no page mapped by both rungs after any step, the
              auditor's tag bijection every step, K1 and K2 only, no
              leak; one-slot twins: fp32 tenants equal the fp32 engine
              token for token, fp8 tenants the native fp8 engine (K1-q
              where the mixed pool decodes through K2) up to a parting
              where the twin's top-2 margin is within MIXED_MARGIN of its
              max|logit|.
 34. fp16     the flash kernels' fp16 instantiations (fp16 AMP; the same
              wgmma kernels at d <= 128 and mma.sync kernels at d = 256 as
              bf16's, with P times 2^14 before its two-term split and dS
              times a power of two per accumulator row from a bound of its
              |dS| (ops.flash_attention.ds_scales), fp16's range):
              (a) phase 20 (a)'s sweep at fp16, and its range cases
              (RANGE_CASES: dO x2^15 of 2^-3 unit normals with values 4x,
              where |dS| passes 65504; dO x2^-15, below fp16's normal
              range; values 64x, where dq and dk overflow) at d in {64,
              128, 256} and ERNIE's batch: the same gates on the outputs
              the plain version gives finite, and the kernels' outputs
              finite exactly there (inf where the plain version's cast
              is); (b) phase 20 (b)'s timing at fp16 at both shapes (the
              plain versions and SDPA at fp16; the bound at 2-byte
              operands and 989 TFLOP/s), each kernel beside its bf16 time;
              (c) the bf16 and fp16 flash kernels at d = 256 (16 heads of
              256 at 4096 tokens, causal: the mma.sync instantiations
              flash_*_{bf16,f16}_kernel<256>) timed against their plain
              versions, bound and SDPA.
 35. ERNIE    ERNIE-3.0-base at full width and depth, fp16 O2 with
     fp16 O2  GradScaler in an eager loop (ScaledStep: auto_cast O2 fp16,
              scale(loss).backward(), step, update) on phase 15's batch, 2
              warm-up and 4 timed steps: losses finite and falling over
              the steps taken, each masked fp16 kernel 12 times a step on
              wgmma and nothing else (no bf16 or fp32 flash kernel, plain
              version or dense attention), every parameter its fp32
              master's cast after every step; the scale and any skipped
              step reported; profiled as 16.
 36. Llama    phase 22 at fp16 O1 (TrainStep(amp_dtype="float16"), 8 of 32
     fp16 O1  layers, 1 x 4096): losses finite and falling, the dense
              fp16 kernels 64 launches each, all on wgmma (d = 128);
              profiled as 12; then phase 24's twins at fp16: a 2-layer O1
              step at full width against the dense path at fp16 and the
              fp32 step, phase 24's tolerances, each backward from the
              loss times 2^12 (GradScaler's recipe; unscaled, the dense
              fp16 path's gradients fall under fp16's range).
 37. fp16     the fp16 serving kernels (K1-fp16: the bf16-q bodies of
     kernels  ragged_paged_attention_bf16.cu at fp16 with P times a power
              of two before its three-term split, per row from its largest
              P times int8 v scale; K1-q with fp16 q; K2-
              fp16): phase 31's checks at fp16 at the Llama and GPT shapes
              and at d = 256 (the tf32 span form and the unsplit decode
              form on fp16 q), within twice the fp16 plain version's error
              against fp64 and misrounding at most 1/16; the decode form's
              batch invariance and graph replay; range cases
              (RAGGED_RANGE_CASES: int8 k and v scales of 1e-6 and 1e2, k
              scales of 1e3, v scales of 1e3 whose outputs pass 65504, q
              x30 over fp16 pools) finite exactly where the plain version
              is, within twice its error and misrounding at most 1/16;
              timed as phase 31's rows at fp16 (SDPA at
              fp16), and K1's d = 256 forms at bf16 and fp16 (16 heads of
              256: a 256-token chunk, GQA-4 decode rows).
 38. fp16     fp16 serving through create_serving_engine(dtype=float16):
     serving  phase 31 at fp16 on LLaMA-2-7B at full depth (the model cast
              to fp16 in place after phase 31) and on GPT-3 1.3B: every
              call through the fp16 variants, no fp32 or bf16 kernel, no
              plain version, every request finished, no non-finite logit;
              the horizon engine equal to the per-step engine; one-slot
              runs over fp16, int8 and fp8 pools token-exact against
              naive_generate; the 2-layer twins at full width against the
              fp32 twin (TWIN_TOL at fp16) and the gather path (GATHER_TOL
              at fp16); GPT-3 1.3B's PagedGPTGenerator at fp16 (K2-fp16
              once a layer a decode step, finite logits, its gap to the
              dense fp16 generator's logits within GATHER_TOL at fp16).
 39. fp16     at fp16: the weight ladder (int8, int4, fp8 weights, cast by
     ladder,  dtype= as the JAX bridge casts them: the runner's bytes the
     mixed,   shapes' formula at fp16, one-slot runs token-exact against
     spec     naive_generate), the mixed pool (phase 33 at fp16, the fp8
              tenants' parting margin MIXED_MARGIN at fp16) on LLaMA-2-7B
              at 8 of its 32 layers (cut from full depth to pay for
              phases 40-41),
              and at GPT-3 1.3B (12 of its 24 layers, cut to pay for
              phases 42-44) a speculation arm with an fp16 target's
              "shadow" (int8) draft beside the off arm: the shadow's
              matrices int8 (fp16 is a numpy floating type), proposed and
              accepted > 0, the streams off's but where off's top-2 margin
              lies within SPEC_F16_MARGIN.
 40. host     the host KV tier (host_tier_phase) at LLaMA-2-7B, full width
     tier     and depth, fp32 pool, random weights: TIER_KNOBS (120 pages
              of 16, 8 slots, a 256-token prefill budget, 128 host pages)
              on 8 requests of 300-600 prompt tokens and 64 new tokens, so
              decode growth preempts and victims resume by page-in; a
              serial arm with sync spills, then spill_async=True with
              pipelined=True. Each arm (tier_arm) under audit_engine after
              every step, through K1 / K2 and no plain version, every
              request finished, preemptions, offload_resumes and page-ins
              > 0, no leaked page or host slot, every restored page read
              back from the card with its CRC equal to the spilled page's
              (read back before the spill) and to the tier's hash of the
              host bytes (TierSpy); the async arm's loop never waits on a
              spill (blocking_joins and sync_spill_reads 0). Tokens: two
              resumed requests of the serial arm token-exact against
              naive_generate (engine_phase's fp32 rule), the async arm's
              streams equal the serial arm's. An int8 pool at 8 of 32
              layers through the same page check (codes and scale rows).
              Printed: each arm's counts, the tier's copy rates (spill and
              page-in GB/s, CUDA events on its side stream), the device ms
              of a page-in resume against a recompute resume of the same
              583-token request, pagein_hidden_ratio, the idle share, the
              phase's seconds.
 41. snapshot phase 40's serial engine run again to a preempted waiter
     restore  beside running requests, ServingEngine.snapshot through
              json, inference.restore_serving_engine on a fresh runner,
              finished: every stream equal to phase 40's uninterrupted
              run; stream_text over a byte-level vocabulary built here
              (ByteVocab, spelled HF-style for TokenizerAdapter, CJK
              characters split across tokens) only appends after every
              step and ends equal to each stream's whole decode.
 42. serving  the in-process serving tier (tier_phase) at LLaMA-2-7B, full
     tier     width and 8 of 32 layers (full depth until phase 46 took the
              smoke's time), fp32, phase 40's int8 arm's random weights
              shared by both replicas of create_serving_router (ROUTER_KNOBS: 400
              pages of 16 each, 8 slots, the prefix cache, horizons of 8,
              audit=True): 16 greedy requests of 300-600 tokens from 4
              tenants sharing a 256-token header, 32 new tokens, in two
              waves, and two chats' second turns under their session ids.
              Gates: every request finished once (no token delivered
              twice); streams equal a single engine's on the same prompts,
              two of them token-exact against naive_generate; the second
              turns on their session's replica; affinity's prefix hits at
              least the random policy's; audit_router; no leak; only K1
              and K2, no plain version; no restart in the fault-free
              arms, whose longest step and capture set the heartbeat (3x,
              at least 5 s). Arms: a crash on a warm runner's call and on
              its restored runner's first (capturing) call, restored twice
              with the streams unchanged; a stall held on the host until
              the Supervisor declares the replica hung, restored;
              rolling_restart mid-stream, after which every old engine,
              runner and host tier is collected, the card's allocated
              memory is within one replica's pools and graph pools of its
              value before and the tiers' pinned bytes are unchanged.
 43. split    prefill_replicas=1 of 2 (disagg_phase) at 8 of 32 layers
     prefill  (since phase 46 took the smoke's time), each replica's host
     / decode tier sized for all the traffic's pages: 16 handoffs out and
              in, no recompute fallback, every handed-off page (fp32;
              int8 codes and scale rows) bit-identical on the card after
              the decode replica's page-in against the prefill replica's
              pages before the spill (HandoffSpy); the fp32 streams equal
              a single fp32 engine's at 8 layers (the int8 arm's reported
              against it). Printed: handoff bytes, export and import GB/s
              (host clock), the device ms from a first token on a prefill
              engine to the first decode step on a decode engine against
              a decode step (at full depth), the idle share.
 44. durable  a journaled tier (fsync "always", 400 host pages; phase 42's
     tier     model, 8 of 32 layers) serves
              phase 42's traffic halfway and is abandoned (replicas
              fenced, supervisor stopped, journal closed); then
              ServingRouter.recover on the card: every stream equal to
              phase 42's, the finished outputs restored as they were, and
              drain_replica, run while the first replica to decode after
              the recovery is held at that call, moves its decoding
              requests with their pages (stage_migration, no recompute).
 45. process  the serving tier over replica PROCESSES (backend="process";
     tier     python -m paddle_tpu_torch.serving.replica children,
              rendezvous through a TCPStore, commands over CRC-framed
              sockets) at LLaMA-2-7B full width and 8 of 32 layers (fp32,
              seed 0; two full-depth children and a respawn would not fit
              the card), ROUTER_KNOBS, phase 42's 16 prompts, the parent
              holding no model while children run. Each child loads the
              kernel library the parent built (by its hash; its path
              printed, equal to the parent's, nothing compiled) and
              records its own launches (counted_runner_factory). Arms:
              (a) 2 mixed children, streams equal a single in-process
              engine's; (g) a corrupted frame of an idempotent RPC on a
              live child is CRC-rejected, NAK'd and retried; (b) SIGKILL
              of a child mid-stream, respawned by the Supervisor; (c)
              SIGSTOP of a child, declared hung (heartbeat 3x the longest
              step, at least 5 s), killed and respawned; (e)
              rolling_restart mid-stream, the card's free memory back
              within one child's footprint; (f) the journaled tier
              abandoned halfway (children killed) and brought back by
              ServingRouter.recover(..., backend="process"), finished
              outputs restored; (d) prefill_replicas=1 of 2, fp32 and
              int8, every handed-off page's CRC on the decode child after
              its page-in equal to the prefill child's before the spill,
              no recompute. Streams unchanged in every arm (the int8
              arm's reported against an int8 engine); every child
              launches K1 and K2 (K1-q over int8) and no plain version;
              no request lost or delivered twice; audit_router; no leak;
              every child joined. Printed: spawn-to-ready seconds per
              child, torch.cuda.mem_get_info before the spawns, after
              every respawn and at the end, the handoff bytes and wire
              GB/s (host clock), the time from a first token to the next
              on the decode child, the phase's seconds.
 46. host-   the host-wide KV store (store_tier_phase): LLaMA-2-7B at full
     wide KV  width and 8 of 32 layers, fp32, seed 0, phase 42's traffic and
     store    second turns; a store of 512 pages (2 GiB) at most half of
              /dev/shm's free space (fewer layers first, never a narrower
              page, never below 64 pages; segments an earlier run left are
              reported and left alone). Arms: (a) two thread replicas over
              one in-process store (pinned buffers): streams equal a
              single engine's; a rolling restart demotes both caches into
              the store and the chats' second turns resume from it
              (store_hit_pages at least the pages their first turns
              wrote, none of those tokens recomputed); audit_store clean;
              (b) prefill_replicas=1 of 2 over the store: 16 handoffs by
              slot reference (handoff_bytes_out 0, no fallback), a shared
              header's second handoff a ref (store_dedup_pages > 0), every
              page bit-identical on the card after its page-in
              (HandoffSpy); the device ms from a first token to the first
              decode step over the store, printed beside phase 43's; (c)
              two replica processes over a shared-memory store (the
              router's StoreServer serving the metadata), split: the
              handoff frames carry no page byte, every handed-off page's
              CRC on the decode child equal to the prefill child's, no
              wire or recompute fallback, streams equal the single
              engine's; (d) the decode child SIGKILLed while it holds
              store refs (SIGSTOPped first, its refs read): the Supervisor
              reaps its owner under the store's lock (the index kept, the
              dead key owning nothing), audit_store clean with the live
              owners, free + used = the store's pages, the segments still
              there, streams unchanged; (e) the journaled tier abandoned
              halfway (children killed, the store's server closed), one
              journaled index entry's bytes corrupted in the segment, then
              ServingRouter.recover(..., backend="process",
              shared_kv_pages=...): the same segments reattached, every
              other journaled entry revived (CRC-checked), the corrupted
              one dropped, streams unchanged; (f) no segment of the phase
              left under /dev/shm, its free space back, every child
              reaped, no tensor of the phase left on the card and its free
              memory back within 1 GiB (workspaces of the CUDA context and
              libraries for what the phase used first). Every
              child launches K1 and K2 and no plain version. Printed:
              /dev/shm's size and free space before and after, the store's
              pages and bytes, store_hit_pages and store_dedup_pages, the
              store RPCs per handoff, spill and page-in GB/s (host clock),
              the time from a first token to the next in (b) and (c), the
              phase's seconds.
 47. tensor   tensor-parallel serving of LLaMA-2-7B (full width) on a
     parallel  mesh of tp shards on the one card
              (serving_mesh(1, tp, devices=[cuda:0] * tp)), each shard's
              weights views of the model's, its pools n_kv / tp heads:
              (a) fp32 at tp = 2, full depth, phase 4's traffic and
              weights: token-exact against the sharded runner's
              naive_generate on two requests (phase 4's gate); the streams
              phase 4's, or parting only where the unsharded runner's top-2
              margin is within 1e-4 of max|logit|; a prefill's and two
              decode steps' logits within 1e-4 of max|logit| of the
              unsharded runner's; per-shard pool bytes half the pool's; K1
              and K2 once a layer a shard on every call, only on 16-head
              pool slices, no plain version. (b) comm_dtype="int8" on the
              same weights: tp_comm_bytes_reduction_x and
              tp_gather_bytes_reduction_x = 4 / (1 + 4/128); a one-slot
              engine token-exact against naive_generate on the two
              shortest prompts (phase 6's rule for quantized arms);
              quantized_psum / quantized_allgather on the card bit-equal to
              their numpy references (tp 2 and 4, chunks 4 and 128, widths
              4096 and 130); the teacher-forced top-5 overlap and mean
              |dlogit| against (a)'s runner, reported (JAX's toy-model
              gates, 0.99 and 0.05, do not hold at LLaMA-2-7B's random
              weights over 32 layers: PERF.md §6), and at 8 layers gated
              at >= 0.9 and <= 0.05; at both depths every step's logits
              part from the fp32 runner's by more than 1e-3 of max|logit|
              (an int8 runner that ran the fp32 reduction fails). (c) bf16
              compute over an int8 pool at tp = 2, 8 of 32 layers: bf16-q
              K1-q once a layer a shard, both forms, the scale pools split;
              streams a single-device bf16 / int8 engine's or parting
              where its margin is within GATHER_TOL[bf16]; a one-slot
              engine token-exact against naive_generate. (d) fp32 at
              tp = 4, 8 of 32 layers: a
              decode_horizon=8 engine with the host tier on phase 40's
              traffic under phase 40's gates (CUDA graphs over 4 shards,
              every paged-in page's CRC in the logical layout), a snapshot
              of it restored onto a tp = 2 runner finishing its streams
              (margin rule at 1e-4). Printed: device and wall ms of a
              256-token chunk and an 8-row decode step at tp 1 / 2 / 4 (8
              layers), capture seconds, per-shard memory, each reduction
              timed alone and its share of the step, K1 at [1,256,16,128]
              and K2 at [8,16,128] (the per-shard heads) against plain,
              bound and SDPA.
 48. framework the Paddle-style Tensor and its op surface
              (paddle_tpu_torch.Tensor, _C_ops) on the card: (a) one
              LLaMA-2-7B decoder layer (hidden 4096, 32 heads x 128, FFN
              11008, RMSNorm, RoPE, SwiGLU) at [1, 4096] tokens, causal,
              written only with port Tensors and _C_ops
              (tests/_framework_layers.py), forward and loss.backward(),
              held against models/llama.py::LlamaBlock on the same
              weights (output and every weight gradient within 1e-5 of
              max|value|: the same ops in the same dtypes); K3a, K3b-dq
              and K3b-dkv launched once each (counts zeroed before, read
              after), no plain version, no other form, torch's
              scaled_dot_product_attention never reached; (b) the same
              layer under amp.auto_cast O1 bf16 (the wgmma forms, gate
              1e-2); (c) one ERNIE-3.0-base layer at 16 x 512 padded tokens
              through _C_ops.scaled_dot_product_attention(attn_mask=...)
              (the masked fp32 kernels once each) against
              models/ernie.py::ErnieBlock; (d) the op sweep: every case of
              the CPU tests' table (tests/_torch_op_cases.py) on CUDA
              Tensors against CPU Tensors, forward and, for
              differentiable ops, the inputs' gradients, at rtol 1e-4 /
              atol 1e-5 (or the case's looser tolerance), the random ops
              by seed determinism and moments. Printed: each arm's gaps,
              launches and seconds, the sweep's count and seconds, the
              phase's seconds and launches.
 49. summary  one JSON line of every kernel's launches, error and times
              (K1's decode-form times as extra decode_* keys, its engine
              launches by form under launches_by_form, the fp64 ratios
              under fp64_ratio; the masked kernels as *_masked rows with
              the ERNIE trainer's launches; the bf16 instantiations as
              *_bf16 and *_masked_bf16 rows with the O1 trainers'
              launches, by kernel variant under launches_by_variant (the
              kernel function under kernel), and their worst misround
              share under misround; the fp16 instantiations as *_fp16 and
              *_masked_fp16 rows with the phase 36 / 35 launches, likewise; the horizon engines' launches of the decode
              kernels under horizon_launches; each serving kernel's and the
              bf16 dense rows' launches on the GPT paths under
              gpt_launches, each serving kernel's error against its plain
              version at the GPT shapes under gpt_max_abs_err, the bf16
              dense rows' numbers at the GPT trainer's shape under
              gpt_shape; phases 28-30's launches under
              prefix_launches_by_form, fused_step and spec_launches, and
              K1 timed at a fused step [8, 256, 32, 128] (one live chunk,
              7 decode rows) and at verify spans [8, 8, 16, 128] (1-5 live
              rows) under fused_step and verify_span; the bf16 variants as
              *_bf16 serving rows with phase 31's launches, their fp64
              ratio and misround share, K1-bf16 at the verify spans, the
              2-layer twin gap and gather-path gaps; the fp16 variants as
              *_fp16 serving rows likewise, with phase 38's launches, K1's
              range cases under range_cases and the fp16 speculation arm's
              launches under spec_fp16_launches; K1's d = 256 forms under
              d256_chunk and d256_decode of the bf16 and fp16 rows; the
              mixed pools' launches under mixed_launches; phase 40's
              launches of K1, K2 and K1-q int8 under host_tier_launches;
              phases 42-44's under tier_launches; phase 45's (children's
              counts) under proc_tier_launches; phase 46's under
              store_tier_launches;
              the dense bf16 and fp16 flash rows' d = 256 times under
              d256; the forward's lse ratio on the stream after phase 37
              under lse_after_phase37_fp64_ratio; phase 48's launches of
              the dense fp32, masked fp32 and dense bf16 flash rows under
              ops_launches), the smoke's
              wall by part (lap), the nvidia-smi line, then the result
              line.

fp32 products stay fp32: TF32 is switched off for matmuls and cuDNN. Bounds
by operations are at fp32-accurate tensor-core products (3xTF32, 495 / 3
TFLOP/s), for the bf16 and fp16 kernels at 989 TFLOP/s, by bytes at 3.35
TB/s. bf16 and fp16 matmuls sum in fp32 (no reduced-precision split-K
reduction).
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16, F16 = torch.bfloat16, torch.float16
# fp32-accurate products on the H100 SXM's tensor cores: 3xTF32 (three
# TF32 products per fp32 product) at a third of the 495 TFLOP/s TF32 peak
PEAK_FP32_ACCURATE_FLOP_PER_S = 495e12 / 3
# dense bf16 (and fp16) tensor-core products on the H100 SXM (NVIDIA data
# sheet): the bound of the 16-bit flash kernels counts the JAX kernel's
# FLOPs at this rate, not the extra products of their two-term split of P
# and dS
PEAK_BF16_FLOP_PER_S = 989e12
TOL = 1e-4


def log(*parts):
    print(*parts, flush=True)


# the smoke's wall by part: lap(label) books the seconds since the last
# lap to label; main prints the whole at its end
_LAPS = {}
_LAP_CLOCK = [time.perf_counter()]


def lap(label):
    now = time.perf_counter()
    _LAPS[label] = _LAPS.get(label, 0.0) + now - _LAP_CLOCK[0]
    _LAP_CLOCK[0] = now


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


_L2_FLUSH = []


def _flush_l2() -> None:
    """Read 128 MiB (over twice the H100's 50 MB L2) so the next launch
    reads its pages from device memory with the cache full of clean
    lines, as in the engine, where each attention call follows the
    layer's weight reads."""
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.ones(32 * 2**20, device="cuda"))
    _L2_FLUSH[0].sum()


# cycles the card spins before each timed call (~0.5 ms), so that the host
# has enqueued the call before the start event is reached
_HOLD_CYCLES = 1_000_000


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` with a cold L2 before each call
    (the flush runs outside the timed interval). Before the start event the
    card spins for ~0.5 ms (torch.cuda._sleep) while the host enqueues the
    call, so the interval holds the call's device time and not the host's
    launch overhead (a wrapper's checks and ctypes call, ~0.1 ms, which a
    kernel of a few microseconds would otherwise wait for)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        _flush_l2()
        torch.cuda._sleep(_HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------ kernels

def _pools(num_pages, page_size, n_kv, d, gen):
    shape = (num_pages, page_size, n_kv, d)
    return (torch.randn(shape, device=gen.device, generator=gen),
            torch.randn(shape, device=gen.device, generator=gen))


def _tables(B, P, num_pages, gen, used=None):
    """[B, P] block tables of distinct random pages (never the scratch
    page 0); with ``used``, sequence b maps used[b] pages and the rest of
    its row is scratch, as the engine pads a table."""
    used = used or [P] * B
    perm = (torch.randperm(num_pages - 1, generator=gen, device=gen.device)
            + 1).tolist()
    table = torch.zeros(B, P, dtype=torch.int32)
    for b, n in enumerate(used):
        table[b, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    return table.to(gen.device)


# the ragged kernel's label per pool storage type
K1_VARIANTS = {"fp32": "K1 ragged", "int8": "K1-q int8 ragged",
               "fp8": "K1-q fp8 ragged"}
# spans (start_pos, q_len, padded T) of the kernel checks
SPANS_MIXED = ([37, 40, 0, 0, 100], [1, 50, 0, 64, 20], 64)
SPANS_DECODE = ([0, 15, 16, 17, 31, 100, 255, 600], [1] * 8, 1)
SPANS_CHUNK = ([256], [256], 256)
# the GPT engine's short chunks: 1-8 rows padded to the 8-row bucket
SPANS_SHORT = ([512, 520, 523, 0, 100, 7, 0, 40], [8, 3, 1, 8, 5, 8, 0, 2], 8)
# a fused ragged step (phase 29): one 256-token chunk beside 7 decode rows,
# every row padded to the chunk's bucket
SPANS_FUSED = ([256, 300, 345, 410, 470, 520, 580, 630],
               [256, 1, 1, 1, 1, 1, 1, 1], 256)
# verify spans (phase 30): the fed token plus 0-4 drafts in the 8-row bucket
SPANS_VERIFY = ([256, 263, 270, 281, 290, 300, 305, 311],
                [5, 3, 1, 4, 2, 5, 1, 3], 8)
# decode rows whose walks end on and across the bf16 decode form's 256-key
# splits (1, 255, 256, 257, 512 and 4096 keys), a dead slot
SPANS_SPLITS = ([0, 254, 255, 256, 4095, 100, 0, 511],
                [1, 1, 1, 1, 1, 0, 1, 1], 1)


def _as_kind(k_pool, v_pool, kind, gen):
    """fp32 pools -> (k, v, k_scale, v_scale) of a ``kind`` pool: int8
    codes with seeded per-page, per-kv-head scales in [1e-3, 5.1e-2], or
    the float8_e4m3fn (bf16, fp16) cast of the values; fp32 as given."""
    if kind == "fp32":
        return k_pool, v_pool, None, None
    if kind in HALF_POOLS:
        return (k_pool.to(HALF_POOLS[kind]), v_pool.to(HALF_POOLS[kind]),
                None, None)
    if kind == "fp8":
        return (k_pool.to(torch.float8_e4m3fn),
                v_pool.to(torch.float8_e4m3fn), None, None)
    codes = [torch.randint(-127, 128, k_pool.shape, device=gen.device,
                           generator=gen, dtype=torch.int8)
             for _ in range(2)]
    scales = [torch.rand(k_pool.shape[0], k_pool.shape[2], device=gen.device,
                         generator=gen) * 0.05 + 1e-3 for _ in range(2)]
    return (*codes, *scales)


# the 16-bit pools by name (a 16-bit pool has q of its dtype)
HALF_POOLS = {"bf16": BF16, "fp16": F16}


def _k1_label(kind, half=None):
    """The wrapper variant's label: K1 / K1-q, with 16-bit q (``half``)
    where asked (a 16-bit pool always has q of its dtype)."""
    if kind in HALF_POOLS:
        return f"K1-{kind} ragged"
    return K1_VARIANTS[kind] + (f" ({HALF_SUFFIX[half]} q)" if half else "")


def _half_gates(name, out, ref, exact):
    """The 16-bit rules (phase 20's): the kernel within twice the 16-bit
    plain version's error against fp64 on the same operands, and at most
    MISROUND_GATE of the outputs the plain version rounds to the 16-bit
    cast of exact rounded elsewhere. Returns (ratio, misround share)."""
    e_kernel, e_plain, ratio = _vs_fp64(out, ref, exact)
    share = misround_share(out, ref, exact)
    if not (ratio <= 2.0 and share <= MISROUND_GATE):
        raise AssertionError(f"{name}: against fp64 {e_kernel:.3e} = "
                             f"{ratio:.2f}x the {HALF_SUFFIX[out.dtype]} "
                             f"plain version's {e_plain:.3e}, misround "
                             f"{share:.4f}")
    return ratio, share


def check_ragged(n_q, n_kv, gen, label, kind="fp32", spans=SPANS_MIXED,
                 half=None, d=128):
    """K1 (fp32 pools) or K1-q (int8 / fp8 pools) against ragged_reference
    on the same operands; with ``half`` (bf16 or fp16), q of that dtype
    (over pools of it for kind "bf16" / "fp16") and the 16-bit gates
    against fp64 in place of TOL. Returns the max abs error (and with
    ``half`` the fp64 ratio and misround share)."""
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention, ragged_reference,
    )
    ps = 16
    start, qlen, T = spans
    B = len(start)
    P = -(-(max(start) + T) // ps)
    k_pool, v_pool = _pools(B * P + 1, ps, n_kv, d, gen)
    k, v, ks, vs = _as_kind(k_pool, v_pool, kind, gen)
    table = _tables(B, P, B * P + 1, gen)
    for b, n in enumerate(qlen):
        if n == 0:
            table[b] = 0                          # dead slot: all scratch
    q = torch.randn(B, T, n_q, d, device=gen.device, generator=gen)
    if half:
        q = q.to(half)
    st = torch.tensor(start, dtype=torch.int32, device=gen.device)
    ql = torch.tensor(qlen, dtype=torch.int32, device=gen.device)
    out = ragged_paged_attention(q, k, v, table, st, ql, k_scale=ks,
                                 v_scale=vs)
    ref = ragged_reference(q, k, v, table, st, ql, k_scale=ks, v_scale=vs)
    err = (out.float() - ref.float()).abs().max().item()
    name = _k1_label(kind, half)
    for b in range(B):
        if not bool((out[b, qlen[b]:] == 0).all()):
            raise AssertionError(f"{name} {label}: rows past q_len of "
                                 f"sequence {b} are not exactly 0")
    gates = ""
    if half:
        pools64 = ((k.double(), v.double()) if kind in HALF_POOLS
                   else (k, v))
        exact = ragged_reference(q.double(), *pools64, table, st, ql,
                                 k_scale=ks, v_scale=vs)
        ratio, share = _half_gates(f"{name} {label}", out, ref, exact)
        gates = (f", against fp64 {ratio:.2f}x the {HALF_SUFFIX[half]} "
                 f"plain version's error, misround {share:.4f}")
    log(f"kernel {name} {label} (n_q={n_q}, n_kv={n_kv}, d={d}, ps={ps}, "
        f"T={T}, spans start={start} q_len={qlen}): max_abs_err={err:.3e}"
        f"{gates}, padded and dead rows exactly 0")
    if half:
        return err, ratio, share
    if not err <= TOL:
        raise AssertionError(f"{name} {label}: max_abs_err {err} > {TOL}")
    return err


def check_paged(gen, h=32, label="", half=None):
    """K2 at ``h`` heads against paged_decode_reference over the engine's
    4096-key table:
    pos on and off page and split boundaries, walks of one split and of
    many (up to the table's last key, 4095), pos past the table (capped)
    and a dead slot (all-scratch table, pos 0). Then batch invariance: each
    sequence alone must give its batch output bit for bit. With ``half``,
    K2-bf16 or K2-fp16 (q and pools of that dtype) under the 16-bit gates
    against fp64 in place of TOL, returning (max abs error, fp64 ratio,
    misround share)."""
    from paddle_tpu_torch.ops.paged_attention import (
        KEYS_PER_SPLIT, paged_decode_attention, paged_decode_reference,
    )
    b, d, ps, P = 12, 128, 16, 256
    pos = [0, 15, 16, 17, KEYS_PER_SPLIT - 1, KEYS_PER_SPLIT, 600, 1000,
           2049, 4095, 5000, 0]
    k_pool, v_pool = _pools(b * P + 1, ps, h, d, gen)
    table = _tables(b, P, b * P + 1, gen)
    table[-1] = 0                                 # dead slot: all scratch
    q = torch.randn(b, h, d, device=gen.device, generator=gen)
    if half:
        q, k_pool, v_pool = (t.to(half) for t in (q, k_pool, v_pool))
    p = torch.tensor(pos, dtype=torch.int32, device=gen.device)
    out = paged_decode_attention(q, k_pool, v_pool, table, p)
    ref = paged_decode_reference(q, k_pool, v_pool, table, p)
    err = (out.float() - ref.float()).abs().max().item()
    name = f"K2-{HALF_SUFFIX[half]}" if half else "K2"
    gates = ""
    if half:
        exact = paged_decode_reference(q.double(), k_pool.double(),
                                       v_pool.double(), table, p)
        ratio, share = _half_gates(f"{name}{label}", out, ref, exact)
        gates = (f", against fp64 {ratio:.2f}x the {HALF_SUFFIX[half]} "
                 f"plain version's error, misround {share:.4f}")
    log(f"kernel {name} paged_decode{label} (b={b}, h={h}, d={d}, ps={ps}, "
        f"P={P}, {KEYS_PER_SPLIT} keys a split, pos={pos}, the last a dead "
        f"slot): max_abs_err={err:.3e}{gates}")
    if not bool(torch.isfinite(out).all()) or (not half and not err <= TOL):
        raise AssertionError(f"{name}: max_abs_err {err} > {TOL}")
    differ = [i for i in range(b) if not torch.equal(
        paged_decode_attention(q[i:i + 1], k_pool, v_pool, table[i:i + 1],
                               p[i:i + 1])[0], out[i])]
    log(f"kernel {name} batch invariance: each of the {b} sequences alone "
        f"equals its batch output bit for bit: {not differ}")
    if differ:
        raise AssertionError(f"{name}: sequences {differ} differ alone from "
                             "their batch output")
    return (err, ratio, share) if half else err


def _ragged_operands(gen, n_q, n_kv, kind, spans, d=128, ps=16, half=BF16):
    """Seeded 16-bit q (``half``), ``kind`` pools (and int8 scales), a
    table of distinct pages (all scratch for a dead slot), start_pos and
    q_len for ``spans``: the operands of a 16-bit-q K1 launch."""
    start, qlen, T = spans
    B = len(start)
    P = -(-(max(start) + T) // ps)
    k_pool, v_pool = _pools(B * P + 1, ps, n_kv, d, gen)
    k, v, ks, vs = _as_kind(k_pool, v_pool, kind, gen)
    table = _tables(B, P, B * P + 1, gen)
    for b, n in enumerate(qlen):
        if n == 0:
            table[b] = 0
    q = torch.randn(B, T, n_q, d, device=gen.device,
                    generator=gen).to(half)
    st = torch.tensor(start, dtype=torch.int32, device=gen.device)
    ql = torch.tensor(qlen, dtype=torch.int32, device=gen.device)
    return q, (k, v, table, st, ql), dict(k_scale=ks, v_scale=vs)


def check_ragged_invariance(gen, kind, n_q=32, n_kv=8, spans=SPANS_SPLITS,
                            half=BF16):
    """Phases 31 and 37: the 16-bit-q decode form (the split walk) over a
    ``kind`` pool at decode rows on and across its split boundaries (GQA-4
    by default, n_kv = n_q: MHA, the one-row walk): each sequence launched
    alone gives its row of the batch launch bit for bit."""
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
    )
    q, (k, v, table, st, ql), sc = _ragged_operands(gen, n_q, n_kv, kind,
                                                    spans, half=half)
    out = ragged_paged_attention(q, k, v, table, st, ql, **sc)
    differ = [b for b in range(q.shape[0]) if not torch.equal(
        ragged_paged_attention(q[b:b + 1], k, v, table[b:b + 1],
                               st[b:b + 1], ql[b:b + 1], **sc)[0], out[b])]
    log(f"kernel {_k1_label(kind, half)} decode form batch invariance "
        f"(q[{q.shape[0]},1,{n_q},128], {n_kv} kv heads, start_pos "
        f"{spans[0]}): each sequence alone equals its batch row bit for "
        f"bit: {not differ}")
    if differ:
        raise AssertionError(f"{_k1_label(kind, half)}: sequences {differ} "
                             "differ alone from their batch rows")


def check_ragged_graph(gen, kind, n_q=32, n_kv=8, spans=SPANS_SPLITS,
                       half=BF16):
    """Phases 31 and 37: two chained 16-bit-q decode-form launches (the
    second takes the first's output as q, so one replay takes each ticket
    twice) captured in one CUDA graph on a side stream, whose workspace and
    tickets its warm-up made outside the capture; replayed on new q, the
    graph's output equals the eager launches' bit for bit. The capture's
    counts are taken back out, as the runners do."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
    )
    q, (k, v, table, st, ql), sc = _ragged_operands(gen, n_q, n_kv, kind,
                                                    spans, half=half)

    def body():
        o = ragged_paged_attention(q, k, v, table, st, ql, **sc)
        return ragged_paged_attention(o, k, v, table, st, ql, **sc)

    side, main = torch.cuda.Stream(), torch.cuda.current_stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        body()                        # the warm-up: the stream's buffers
    main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _build.counts_snapshot()
    with torch.cuda.graph(graph, stream=side):
        out = body()
    _build.counts_credit(_build.counts_delta(before,
                                             _build.counts_snapshot()), -1)
    results = []
    for _ in range(2):
        q.copy_(torch.randn(q.shape, device="cuda", generator=gen))
        graph.replay()
        eager = body()
        torch.cuda.synchronize()
        results.append(torch.equal(out, eager))
    log(f"kernel {_k1_label(kind, half)} decode form under a CUDA graph "
        f"(two chained launches, replayed twice on new q): equals the eager "
        f"launches bit for bit: {results}")
    if not all(results):
        raise AssertionError(f"{_k1_label(kind, half)}: the graph replay "
                             "parts from the eager launches")


# phase 37's range cases of K1 at fp16 q: (label, pool kind, the int8 k
# scales' and the v scales' choices per page and kv head (None: the usual
# [1e-3, 5.1e-2]), q's factor). Scales of 1e-6 put P times the v scale far
# below fp16's normal range and 1e2 above 2^14 (the factor of P a row),
# with pages of both in one span tile; k scales of 1e3 make scores of
# ~7e4 (past the 515.8 that an fp16 row's absmax / 127 can reach); v
# scales of 1e3 make outputs past 65504 (inf where the plain version's
# cast is); q x30 over fp16 pools makes scores of +-100
RAGGED_RANGE_CASES = {
    "int8": ("int8 k, v scales 1e-6 / 1e2", "int8", (1e-6, 1e2),
             (1e-6, 1e2), 1.0),
    "int8-overflow": ("int8 v scales 1e3", "int8", None, (1e3, 1e3), 1.0),
    "fp16": ("fp16 pools, q x30", "fp16", None, None, 30.0),
    "int8-k-large": ("int8 k scales 1e-3 / 1e3", "int8", (1e-3, 1e3), None,
                     1.0),
}


def check_ragged_range(gen, case, n_rep, T, d=128):
    """Phase 37: K1 on fp16 q in a range case (RAGGED_RANGE_CASES) at 2
    kv heads x n_rep, T rows at start_pos [254, 256, 1500, 3] (q_len T,
    T // 2, T, and a dead slot): the output finite exactly where the
    plain version's is (equal to its inf there, but where the exact value
    lies within FP16_OVERFLOW_EDGE of FP16_OVERFLOW), and on the outputs
    both give finite within twice the plain version's error against fp64
    and misrounded (`misround_share`) at most MISROUND_GATE of the time.
    Reported beside them: a second fp32 evaluation of the plain version
    (q and k reversed along d, so its sums round elsewhere) against fp64
    over the plain version's error, the spread of fp32 evaluations at the
    case's scores. Returns (ratio, misround share)."""
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention, ragged_reference,
    )
    label, kind, k_scales, v_scales, q_mul = RAGGED_RANGE_CASES[case]
    ps, n_kv = 16, 2
    start = [254, 256, 1500, 3]
    qlen = [T, max(1, T // 2), T, 0]
    B, P = len(start), -(-(max(start) + T) // ps) + 1
    k_pool, v_pool = _pools(B * P + 1, ps, n_kv, d, gen)
    k, v, ks, vs = _as_kind(k_pool, v_pool, kind, gen)

    def pick(choices, like):
        coin = torch.rand(like.shape, device="cuda", generator=gen) < 0.5
        return torch.where(coin, choices[0], choices[1]).float()

    if k_scales is not None:
        ks = pick(k_scales, ks)
    if v_scales is not None:
        vs = pick(v_scales, vs)
    table = _tables(B, P, B * P + 1, gen)
    table[-1] = 0                                 # dead slot: all scratch
    q = (torch.randn(B, T, n_kv * n_rep, d, device="cuda", generator=gen)
         * q_mul).to(F16)
    st = torch.tensor(start, dtype=torch.int32, device="cuda")
    ql = torch.tensor(qlen, dtype=torch.int32, device="cuda")
    sc = dict(k_scale=ks, v_scale=vs)
    out = ragged_paged_attention(q, k, v, table, st, ql, **sc)
    plain = ragged_reference(q, k, v, table, st, ql, **sc)
    pools64 = (k.double(), v.double()) if kind in HALF_POOLS else (k, v)
    exact = ragged_reference(q.double(), *pools64, table, st, ql, **sc)
    name = f"{_k1_label(kind, F16)} range case {label}"
    fin_p, fin_x = torch.isfinite(plain), torch.isfinite(out)
    edge = (exact.abs() - FP16_OVERFLOW).abs() <= FP16_OVERFLOW_EDGE
    both_inf = ~fin_p & ~fin_x
    if bool(((fin_p != fin_x) & ~edge).any()) or not torch.equal(
            out[both_inf], plain[both_inf]):
        raise AssertionError(f"{name}: not finite exactly where the plain "
                             "version is, with its inf there")
    fin = fin_p & fin_x
    e_kernel, e_plain, ratio = _vs_fp64(out[fin], plain[fin], exact[fin])
    share = misround_share(out[fin], plain[fin], exact[fin])
    second = ragged_reference(q.flip(-1), k.flip(-1), v, table, st, ql, **sc)
    both = fin & torch.isfinite(second)
    spread = _vs_fp64(second[both], plain[both], exact[both])[2]
    zeros = all(bool((out[b, n:] == 0).all()) for b, n in enumerate(qlen))
    log(f"kernel {name} (q[{B},{T},{n_kv * n_rep},{d}], {n_kv} kv heads): "
        f"{int((~fin_p).sum())} inf outputs, as the plain version's; "
        f"against fp64 {e_kernel:.3e} = {ratio:.2f}x the plain version's "
        f"{e_plain:.3e} (a second fp32 evaluation, q and k reversed along "
        f"d: {spread:.2f}x); misround {share:.4f}; padded and dead rows "
        f"exactly 0: {zeros}")
    if not (ratio <= 2.0 and share <= MISROUND_GATE and zeros):
        raise AssertionError(f"{name}: error against fp64 {ratio:.2f}x the "
                             f"plain version's, misround {share:.4f}, or "
                             "rows past q_len not 0")
    return ratio, share


def fp64_ratio(kern, plain, exact) -> float:
    """The kernel's max error against the fp64 evaluation over the fp32
    plain version's own."""
    e_kernel = (kern.double() - exact).abs().max().item()
    e_plain = (plain.double() - exact).abs().max().item()
    return e_kernel / e_plain


def ulp_error(x, exact) -> float:
    """The largest error of ``x`` against the fp64 ``exact`` in fp32 ulp
    at max|exact| (the spacing of fp32 there): the error fp64_ratio
    compares, in units of the output's last place."""
    top = exact.abs().max().float()
    ulp = (torch.nextafter(top, top + 1) - top).item()
    return (x.double() - exact).abs().max().item() / ulp


def signed_error(x, exact) -> float:
    """The mean error against the fp64 evaluation in the direction of the
    exact value, over its mean magnitude: below 0, a result shrunk toward
    zero (a bias rounding to nearest does not have)."""
    return ((x.double() - exact) * exact.sign()).mean().item() \
        / exact.abs().mean().item()


def measure_ragged(gen, n_heads, num_blocks, P, kind="fp32",
                   spans=SPANS_CHUNK, n_kv=None, half=None, d=128):
    """K1 / K1-q at an engine shape, 7B heads (MHA, or ``n_kv`` kv heads;
    head dim ``d``): by default the second 256-token chunk of a longer
    prompt (keys 0..511 visible), or the decode step of the engine's
    sequences (T = 1). Held against the plain version in fp32 (1e-4) and
    in fp64 (within twice the fp32 plain version's error), then timed.
    With ``half`` (bf16 or fp16): q of that dtype (over pools of it for
    kind "bf16" / "fp16"), the 16-bit gates against fp64, 16-bit bytes and
    the 16-bit peak in the bound, SDPA at that dtype."""
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        dequantize_pages, ragged_form, ragged_paged_attention,
        ragged_reference,
    )
    ps = 16
    n_kv = n_kv or n_heads
    start, qlen, T = spans
    B = len(start)
    k_pool, v_pool = _pools(num_blocks, ps, n_kv, d, gen)
    k, v, ks, vs = _as_kind(k_pool, v_pool, kind, gen)
    del k_pool, v_pool
    pages = [-(-(s + T) // ps) for s in start]   # pages each walk reads
    table = _tables(B, P, num_blocks, gen, used=pages)
    q = torch.randn(B, T, n_heads, d, device="cuda", generator=gen)
    if half:
        q = q.to(half)
    st = torch.tensor(start, dtype=torch.int32, device="cuda")
    ql = torch.tensor(qlen, dtype=torch.int32, device="cuda")
    args = (q, k, v, table, st, ql)
    kw = dict(k_scale=ks, v_scale=vs)
    form = ragged_form(n_heads // n_kv, T)
    name = f"{_k1_label(kind, half)} {form} form"
    out = ragged_paged_attention(*args, **kw)
    ref = ragged_reference(*args, **kw)
    err = (out.float() - ref.float()).abs().max().item()
    if not half and not err <= TOL:
        raise AssertionError(f"{name} engine shape: max_abs_err {err} > "
                             f"{TOL}")
    pools64 = ((k.double(), v.double()) if kind in ("fp32", *HALF_POOLS)
               else (k, v))
    exact = ragged_reference(q.double(), *pools64, table, st, ql, **kw)
    extra = {}
    if half:
        ratio, extra["misround"] = _half_gates(name, out, ref, exact)
    else:
        ratio = fp64_ratio(out, ref, exact)
    bias = (signed_error(out, exact), signed_error(ref, exact))
    del exact
    log(f"{name} vs fp64 at q[{B},{T},{n_heads},{d}], {n_kv} kv heads: "
        f"kernel error {ratio:.2f}x the "
        f"{HALF_SUFFIX[half] if half else 'fp32'} plain version's; mean "
        f"signed error kernel {bias[0]:+.2e}, plain {bias[1]:+.2e}"
        + (f"; misround {extra['misround']:.4f}" if half else ""))
    if not ratio <= 2.0:
        raise AssertionError(f"{name}: error against fp64 {ratio:.2f}x the "
                             "fp32 plain version's, above 2x")
    ms = median_ms(lambda: ragged_paged_attention(*args, **kw))
    plain = median_ms(lambda: ragged_reference(*args, **kw), iters=5)
    # library yardstick: SDPA over the visible keys, gathered (and
    # dequantized) beforehand, kv heads repeated for GQA
    L = max(s + T for s in start)
    idx = table[:, :-(-L // ps)].long()
    kg, vg = ((dequantize_pages(pool, idx, sc).flatten(1, 2)[:, :L]
               .repeat_interleave(n_heads // n_kv, dim=2)
               .transpose(1, 2).to(q.dtype).contiguous())
              for pool, sc in ((k, ks), (v, vs)))
    qT = q.transpose(1, 2).contiguous()
    mask = (torch.arange(L, device="cuda")[None, None, :]
            <= (st.long()[:, None, None]
                + torch.arange(T, device="cuda")[None, :, None]))[:, None]
    lib = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qT, kg, vg, attn_mask=mask))
    # the least work of this run's spans: each K/V row the live rows see
    # read once (1 byte per element on int8 / fp8 pools, plus one fp32
    # scale per page and kv head for K and V on int8), the table entries
    # walked, the live q rows read and their out rows written; 4*d FLOPs
    # per visible (live row, key, query head); a dead slot reads nothing
    keys = sum(s + n for s, n in zip(start, qlen) if n)
    walked = sum(-(-(s + n) // ps) for s, n in zip(start, qlen) if n)
    elem = k.element_size()
    qe = q.element_size()
    nbytes = (qe * 2 * sum(qlen) * n_heads * d + elem * 2 * keys * n_kv * d
              + 4 * (walked + 2 * B))
    if kind == "int8":
        nbytes += 4 * 2 * walked * n_kv
    flops = 4 * d * n_heads * sum(s + t + 1 for s, n in zip(start, qlen)
                                  for t in range(n))
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / (PEAK_BF16_FLOP_PER_S if half
                     else PEAK_FP32_ACCURATE_FLOP_PER_S)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=lib, fp64_ratio=ratio, **extra,
                shape=f"q[{B},{T},{n_heads},{d}]"
                      f"{' ' + HALF_SUFFIX[half] if half else ''} "
                      f"start_pos={start} {kind} pool[{num_blocks},{ps},"
                      f"{n_kv},{d}] table[{B},{P}] ({form} form)")


def measure_paged(gen, n_heads, num_blocks, P, positions, half=None):
    """K2 at the engine's decode shape: 8 sequences at ``positions``. Held
    against the plain version in fp32 (1e-4) and in fp64 (within twice the
    fp32 plain version's error), then timed. With ``half``: K2-bf16 or
    K2-fp16 under the 16-bit gates, 16-bit bytes in the bound, SDPA at
    that dtype."""
    from paddle_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_reference,
    )
    b, d, ps = len(positions), 128, 16
    k_pool, v_pool = _pools(num_blocks, ps, n_heads, d, gen)
    table = _tables(b, P, num_blocks, gen,
                    used=[p // ps + 1 for p in positions])
    q = torch.randn(b, n_heads, d, device="cuda", generator=gen)
    if half:
        q, k_pool, v_pool = (t.to(half) for t in (q, k_pool, v_pool))
    name = f"K2-{HALF_SUFFIX[half]}" if half else "K2"
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    out = paged_decode_attention(q, k_pool, v_pool, table, pos)
    ref = paged_decode_reference(q, k_pool, v_pool, table, pos)
    err = (out.float() - ref.float()).abs().max().item()
    if not half and not err <= TOL:
        raise AssertionError(f"K2 engine shape: max_abs_err {err} > {TOL}")
    exact = paged_decode_reference(q.double(), k_pool.double(),
                                   v_pool.double(), table, pos)
    extra = {}
    if half:
        ratio, extra["misround"] = _half_gates(name, out, ref, exact)
    else:
        ratio = fp64_ratio(out, ref, exact)
    bias = (signed_error(out, exact), signed_error(ref, exact))
    del exact
    log(f"{name} vs fp64 at q[{b},{n_heads},{d}]: kernel error {ratio:.2f}x "
        f"the {HALF_SUFFIX[half] if half else 'fp32'} plain version's; mean "
        f"signed error kernel {bias[0]:+.2e}, plain {bias[1]:+.2e}"
        + (f"; misround {extra['misround']:.4f}" if half else ""))
    if not ratio <= 2.0:
        raise AssertionError(f"K2: error against fp64 {ratio:.2f}x the fp32 "
                             "plain version's, above 2x")
    ms = median_ms(lambda: paged_decode_attention(q, k_pool, v_pool, table,
                                                  pos))
    plain = median_ms(lambda: paged_decode_reference(q, k_pool, v_pool,
                                                     table, pos), iters=5)
    L = max(positions) + 1
    npages = -(-L // ps)
    idx = table[:, :npages].long()
    kg = k_pool[idx].reshape(b, npages * ps, n_heads, d)[:, :L]
    vg = v_pool[idx].reshape(b, npages * ps, n_heads, d)[:, :L]
    kg, vg = (t.transpose(1, 2).contiguous() for t in (kg, vg))
    qT = q[:, :, None, :]
    mask = (torch.arange(L, device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    lib = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qT, kg, vg, attn_mask=mask))
    keys = sum(p + 1 for p in positions)
    nbytes = (q.element_size() * (2 * q.numel() + 2 * keys * n_heads * d)
              + 4 * b * (P + 1))
    flops = 4 * d * n_heads * keys
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / (PEAK_BF16_FLOP_PER_S if half
                     else PEAK_FP32_ACCURATE_FLOP_PER_S)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=lib, fp64_ratio=ratio, **extra,
                shape=f"q[{b},{n_heads},{d}]"
                      f"{' ' + HALF_SUFFIX[half] if half else ''} "
                      f"pos={positions} pool[{num_blocks},{ps},{n_heads},"
                      f"{d}] table[{b},{P}]")


# ------------------------------------------------------------- engine

def check_against_naive(runner, prompt, out_tokens, sp, max_model_len):
    """The engine's tokens must equal naive_generate's, token for token."""
    from paddle_tpu_torch.serving import naive_generate
    ref = naive_generate(runner, prompt, sp, max_model_len=max_model_len)
    if ref != out_tokens:
        first = next((i for i, (a, b) in enumerate(zip(ref, out_tokens))
                      if a != b), min(len(ref), len(out_tokens)))
        raise AssertionError(
            f"engine tokens differ from naive_generate first at step {first}:"
            f" engine {out_tokens[first:first + 4]}, naive "
            f"{ref[first:first + 4]}")
    return "token-exact"


def _all_counts():
    """(name, LaunchCounts) of every serving kernel wrapper: the fp32-q
    variants, then the bf16-q ones (a bf16 runner's), then the fp16-q ones
    (an fp16 runner's)."""
    import paddle_tpu_torch.ops.paged_attention as k2
    import paddle_tpu_torch.ops.ragged_paged_attention as k1
    return (("ragged_paged_attention", k1.COUNTS),
            ("ragged_paged_attention_int8", k1.COUNTS_I8),
            ("ragged_paged_attention_fp8", k1.COUNTS_F8),
            ("paged_decode_attention", k2.COUNTS),
            ("ragged_paged_attention_bf16", k1.COUNTS_BF16),
            ("ragged_paged_attention_bf16_int8", k1.COUNTS_BF16_I8),
            ("ragged_paged_attention_bf16_fp8", k1.COUNTS_BF16_F8),
            ("paged_decode_attention_bf16", k2.COUNTS_BF16),
            ("ragged_paged_attention_fp16", k1.COUNTS_F16),
            ("ragged_paged_attention_fp16_int8", k1.COUNTS_F16_I8),
            ("ragged_paged_attention_fp16_fp8", k1.COUNTS_F16_F8),
            ("paged_decode_attention_fp16", k2.COUNTS_F16))


def _half_name(base, kind, half=BF16):
    """The 16-bit-q variant's name of a serving kernel over a ``kind`` pool
    ("bf16", "fp16" or "fp32": the runner's dtype; "int8", "fp8")."""
    return (f"{base}_{HALF_SUFFIX[half]}"
            + ("" if kind in ("fp32", *HALF_POOLS) else f"_{kind}"))


def _path_kernels(kv_dtype, half=None):
    """The kernels an MHA engine's path launches: K1 for its chunks and K2
    for its decode steps over fp32 and mixed pools (16-bit variants for a
    runner cast to ``half``), K1-q for both over int8 / fp8 pools."""
    sfx = f"_{HALF_SUFFIX[half]}" if half else ""
    if kv_dtype in ("fp32", "mixed"):
        return (f"ragged_paged_attention{sfx}", f"paged_decode_attention{sfx}")
    return (f"ragged_paged_attention{sfx}_{kv_dtype}",)


def engine_phase(model, cfg, kv_dtype="fp32", seed=0, n_requests=8,
                 max_tokens=32, ref_tokens=None, max_model_len=4096,
                 dtype=None, gate_naive=None, report_naive=True, **knobs):
    """Serve the seeded requests from a ``kv_dtype`` pool through
    create_serving_engine (``dtype`` and the engine ``knobs``, the weight
    ladder's among them, passed on) and gate the run (phases 4, 6, 25,
    31, 32). The batch engine is gated token-exact against naive_generate
    on two requests only with fp32 pools, compute and weights
    (``gate_naive``; elsewhere reported: cuBLAS rounds a row differently
    at another row count; ``report_naive`` False skips that report where
    a one-slot run gates the same runner). Returns the engine, the
    launches of each kernel
    of the path, the decode positions for phase 8 and every request's
    tokens."""
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.serving import SamplingParams

    if gate_naive is None:
        gate_naive = kv_dtype == "fp32" and dtype is None and not knobs
    t0 = time.perf_counter()
    eng = create_serving_engine(
        model, dtype=dtype, device="cuda", block_size=16, num_blocks=1024,
        max_batch_size=8, max_model_len=max_model_len,
        max_prefill_tokens_per_step=256, kv_dtype=kv_dtype, audit=True,
        **knobs)
    m = eng.metrics
    n_kv = getattr(cfg, "num_kv_heads", cfg.num_heads)
    what = f"{kv_dtype} KV" + (f", {HALF_SUFFIX[dtype]}" if dtype else "") \
        + "".join(f", {k}={v}" for k, v in knobs.items())
    model_gib = sum(p.numel() * p.element_size()
                    for p in model.parameters()) / 2**30
    log(f"engine setup ({what}): {type(model).__name__}, "
        f"{cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, heads {cfg.num_heads}/{n_kv}, model "
        f"{model_gib:.2f} GiB, runner weights "
        f"{eng.runner.weight_bytes() / 2**30:.3f} GiB "
        f"(weight_bytes_reduction_x "
        f"{m.weight_bytes_reduction_x.value:.4f}), pool "
        f"{eng.pool.memory_bytes() / 2**30:.3f} GiB "
        f"(kv_bytes_reduction_x {m.kv_bytes_reduction_x.value:.4f}), "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    lens = rng.integers(100, 601, n_requests)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in lens]
    sp = SamplingParams(max_tokens=max_tokens)

    counts = _all_counts()
    for _, c in counts:
        c.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    ids = [eng.add_request(p, sp) for p in prompts]
    decode_ms = []
    t_run = time.perf_counter()
    while eng.has_work():
        chunks = m.prefill_chunks.value
        t = time.perf_counter()
        eng.step()      # ends in a blocking drain of the step's tokens
        if m.prefill_chunks.value == chunks:
            decode_ms.append(1e3 * (time.perf_counter() - t))
    wall = time.perf_counter() - t_run
    kernel = {name: c.kernel_launches for name, c in counts}
    forms = {name: dict(c.form_launches) for name, c in counts
             if c.form_launches}
    plain = sum(c.plain_launches for _, c in counts)
    outs = eng.outputs()
    peak = torch.cuda.max_memory_allocated()
    log(f"engine run ({what}): {len(outs)}/{n_requests} finished, "
        f"prompt lens {lens.tolist()}, {int(m.tokens_generated.value)} tokens"
        f" in {wall:.3f} s = {m.tokens_generated.value / wall:.1f} tokens/s, "
        f"TTFT mean {1e3 * m.ttft_s.mean:.1f} ms p50 "
        f"{1e3 * m.ttft_s.percentile(50):.1f} ms, {len(decode_ms)} "
        f"decode-only steps mean {statistics.mean(decode_ms):.2f} ms, "
        f"{int(m.prefill_chunks.value)} prefill chunks, "
        f"{m.batch_occupancy.count} decode calls, "
        f"{int(m.preemptions.value)} preemptions, peak memory "
        f"{peak / 2**30:.2f} GiB ({(peak - resident) / 2**30:.3f} GiB over "
        f"the {resident / 2**30:.2f} GiB resident at the start)")
    log(f"engine launches ({what}): {kernel}, by form {forms}, "
        f"plain launches {plain}")
    if len(outs) != n_requests or any(
            o.finish_reason != "length" or len(o.output_tokens) != max_tokens
            for o in outs.values()):
        raise AssertionError("not every request finished with max_tokens")
    if m.nan_logit_events.value:
        raise AssertionError(f"engine ({what}): "
                             f"{int(m.nan_logit_events.value)} logits rows "
                             "were not finite")
    path = _path_kernels(kv_dtype, dtype)
    # a sharded runner (phase 47) launches each kernel once a shard
    shards = eng.runner.tp_size
    if len(path) == 2:
        if min(kernel[n] for n in path) == 0:
            raise AssertionError(f"main path missed a kernel: {kernel}")
        # MHA decode: K2 once a layer (a shard) on every decode call
        calls = m.batch_occupancy.count
        if kernel[path[1]] != cfg.num_layers * shards * calls:
            raise AssertionError(
                f"{path[1]} launched {kernel[path[1]]} times, not "
                f"{cfg.num_layers} layers x {shards} shards x {calls} "
                "decode calls")
    else:
        # K1-q on every prefill chunk and every decode call, once a layer
        # (a shard)
        calls = int(m.prefill_chunks.value) + m.batch_occupancy.count
        if kernel[path[0]] != cfg.num_layers * shards * calls:
            raise AssertionError(
                f"{path[0]} launched {kernel[path[0]]} times, not "
                f"{cfg.num_layers} layers x {shards} shards x {calls} "
                "calls")
        # chunks take the span form, decode steps (G = 1) the decode form
        # (16-bit q: the split walk over tables of more than one split)
        got = set(forms.get(path[0], {}))
        if "span" not in got or not got & {"decode", "decode_split"} or \
                got - {"span", "decode", "decode_split"}:
            raise AssertionError(f"{path[0]} did not launch both forms: "
                                 f"{forms}")
    if plain != 0 or any(n not in path and k for n, k in kernel.items()):
        raise AssertionError(f"the {what} path launched another kernel "
                             f"or a plain version: {kernel}, plain {plain}")
    if not eng.pool.allocator.check_no_leaks():
        raise AssertionError("engine leaked KV pages")
    tokens = [outs[i].output_tokens for i in ids]
    # the longest prompt (prefilled in three chunks) and the shortest
    checked = (int(np.argmax(lens)), int(np.argmin(lens)))
    if gate_naive:
        for i in checked:
            verdict = check_against_naive(eng.runner, prompts[i], tokens[i],
                                          sp, max_model_len)
            log(f"naive_generate check ({kv_dtype} KV), request {i} (prompt "
                f"{lens[i]}): {verdict}")
    else:
        # reported, not gated: cuBLAS rounds a row of x @ w differently
        # for another row count (gemm_row_invariance), the batch-8 engine
        # and naive_generate run other row counts, and 1-byte K/V turn
        # those 1-ulp differences into whole quantization steps
        from paddle_tpu_torch.serving import naive_generate
        if report_naive:
            refs = [naive_generate(eng.runner, prompts[i], sp,
                                   max_model_len=max_model_len)
                    for i in checked]
            _agreement(f"{what} engine vs its naive_generate on requests "
                       f"{list(checked)}", [tokens[i] for i in checked],
                       refs)
        if ref_tokens is not None:
            _agreement(f"{what} engine vs fp32 engine", tokens, ref_tokens)
    positions = [int(n) + max_tokens // 2 for n in lens]
    return (eng, {n: kernel[n] for n in path}, positions, tokens, prompts,
            {n: forms.get(n, {}) for n in path})


def _agreement(label, tokens, refs):
    same = sum(int(a == b) for t, r in zip(tokens, refs) for a, b in zip(t, r))
    total = sum(map(len, refs))
    first = [next((j for j, (a, b) in enumerate(zip(t, r)) if a != b), None)
             for t, r in zip(tokens, refs)]
    log(f"{label} (reported, not gated): greedy agreement {same}/{total} "
        f"tokens = {same / total:.4f}; first divergence per request {first}")


def gemm_row_invariance(gen, ms=(1, 8, 16, 256, 1024)):
    """Whether cuBLAS's fp32 x @ w gives row 0 the same bits at every row
    count M, for the runner's four weight shapes at 7B width."""
    same = {}
    for k, n in ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)):
        w = torch.randn(k, n, device="cuda", generator=gen) * 0.02
        x = torch.randn(max(ms), k, device="cuda", generator=gen)
        row = {m: (x[:m] @ w)[0] for m in ms}
        same[f"{k}x{n}"] = [m for m in ms if torch.equal(row[m], row[1])]
    log(f"gemm row invariance: row counts M whose row 0 of x[:M] @ w equals "
        f"M=1's bit for bit, per weight shape: {json.dumps(same)}")


def single_slot_check(model, cfg, kv_dtype, prompts, max_tokens=32,
                      dtype=None, forms=None, weights=None, **knobs):
    """An engine with one slot serves each prompt in one prefill chunk and
    then batch-1 decode steps: the row counts of naive_generate, so its
    tokens must equal naive_generate's exactly (int8 scales too: both
    write the same chunks), through K1-q alone over int8 / fp8 pools, K1
    for the chunk and K2 for the decode steps over fp32 pools (bf16
    variants with ``dtype`` bf16; ``knobs`` such as the weight ladder's
    passed on). Returns the launches by kernel; ``forms``, a dict, takes
    the engine's launches by form of each kernel, ``weights``, a dict, the
    runner's weight bytes and reduction factor."""
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.serving import SamplingParams

    knobs.setdefault("audit", True)
    eng = create_serving_engine(
        model, dtype=dtype, device="cuda", block_size=16, num_blocks=128,
        max_batch_size=1, max_model_len=1024,
        max_prefill_tokens_per_step=256, kv_dtype=kv_dtype, **knobs)
    sp = SamplingParams(max_tokens=max_tokens)
    counts = _all_counts()
    for _, c in counts:
        c.reset()
    ids = [eng.add_request(p, sp) for p in prompts]
    outs = eng.run()
    kernel = {name: c.kernel_launches for name, c in counts}
    if weights is not None:
        weights.update(bytes=eng.runner.weight_bytes(),
                       reduction=eng.metrics.weight_bytes_reduction_x.value)
    if forms is not None:
        forms.update({name: dict(c.form_launches) for name, c in counts
                      if c.form_launches})
    path = _path_kernels(kv_dtype, dtype)
    chunks = int(eng.metrics.prefill_chunks.value)
    decodes = eng.metrics.batch_occupancy.count
    L = cfg.num_layers * eng.runner.tp_size     # once a layer a shard
    want = ({path[0]: L * (chunks + decodes)} if len(path) == 1
            else {path[0]: L * chunks, path[1]: L * decodes})
    what = f"{kv_dtype} KV" + (f", {HALF_SUFFIX[dtype]}" if dtype else "") \
        + "".join(f", {k}={v}" for k, v in knobs.items() if k != "audit")
    if ({n: k for n, k in kernel.items() if k} != want
            or any(c.plain_launches for _, c in counts)):
        raise AssertionError(f"single-slot engine ({what}): {kernel}, want "
                             f"{want}")
    if eng.metrics.nan_logit_events.value:
        raise AssertionError(f"single-slot engine ({what}): logits rows "
                             "were not finite")
    if not eng.pool.allocator.check_no_leaks():
        raise AssertionError("single-slot engine leaked KV pages")
    for rid, p in zip(ids, prompts):
        verdict = check_against_naive(eng.runner, p, outs[rid].output_tokens,
                                      sp, 1024)
        log(f"naive_generate check ({what}, one slot), prompt "
            f"{len(p)}: {verdict}")
    return want


def quant_paths(model, runner_cls, kind, seed=2, chunks=(256, 256),
                steps=8, rows=(2,), dtype=None):
    """``model`` (full width) served by ``runner_cls`` (with ``dtype``, the
    runner create_serving_engine casts to it) from a ``kind`` pool in the
    runner's dtype: prefill chunks of ``chunks`` tokens (a chunk of at most 8 takes
    K1's decode form) and ``steps`` decode steps whose batch holds the
    sequence in row 0 beside dead slots (``rows[i % len(rows)]`` rows at
    step i); through the kernels, then the same calls on the plain gather
    path from fresh pools. Every count is set to 0 before the kernel run,
    and the reference run must add none. Returns each run's logits of
    every call (row 0), the kernel run's launches {name: (kernel, plain,
    forms)} and each run's pools."""
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.serving import KVCachePool

    cfg = model.cfg
    ps, P = 16, 64
    n = sum(chunks)
    prompt = np.random.default_rng(seed).integers(
        1, cfg.vocab_size, n).tolist()

    def run(attn_impl, feed):
        knobs = dict(block_size=ps, max_model_len=ps * P,
                     attn_impl=attn_impl, kv_dtype=kind)
        if dtype is None:
            runner = runner_cls(model, **knobs)
        else:
            runner = create_serving_engine(model, dtype, "cuda",
                                           num_blocks=1 + P, **knobs).runner
            assert isinstance(runner, runner_cls)
        pool = KVCachePool(cfg.num_layers, 1 + P, ps, runner.n_kv_heads,
                           runner.head_dim, runner.dtype, device="cuda",
                           kv_dtype=kind)
        table = pool.pad_table(pool.allocator.alloc(P), P)
        pools, logits, start = pool.shards, [], 0
        # copies: a replayed decode returns its graph's output buffer,
        # which the next replay overwrites
        for c in chunks:
            lg, pools = runner.prefill_chunk(prompt[start:start + c], start,
                                             table, pools)
            logits.append(lg.float().clone())
            start += c
        for i in range(steps):
            if len(feed) <= i:
                feed.append(int(torch.argmax(logits[-1])))
            dead = rows[i % len(rows)] - 1             # rows 1.. are dead
            lg, pools = runner.decode(
                np.asarray([feed[i]] + [0] * dead, np.int32),
                np.asarray([table] + [[0] * P] * dead, np.int32),
                np.asarray([n + i] + [0] * dead, np.int32), pools)
            logits.append(lg[0].float().clone())
        return logits, pools[0]                 # the one shard's layers

    counts = _all_counts()
    for _, c in counts:
        c.reset()
    feed = []
    out_k, pools_k = run("auto", feed)

    def now():
        return {name: (c.kernel_launches, c.plain_launches,
                       dict(c.form_launches)) for name, c in counts}

    launched = now()
    out_r, pools_r = run("reference", feed)
    if now() != launched:
        raise AssertionError(f"{runner_cls.__name__} {kind}: the reference "
                             f"run launched a kernel: {now()}")
    return out_k, out_r, launched, pools_k, pools_r


def quant_model_check(model, runner_cls, kind, want, gate=True, tol=TOL,
                      **kw):
    """Phases 7, 25 and 31: quant_paths' two runs. The kernel run must
    launch exactly ``want`` ({name: (kernel launches, {form: launches})})
    and no plain version; every call's logits within ``tol`` of its
    max|logit| (reported only, with ``gate`` False). Over int8 / fp8 pools the share
    of K codes that differ between the two runs' pools is reported by
    layer: each run quantizes the K/V its own attention led to, so a
    last-bit difference upstream can move a code by one step, and that
    step is then read by every later layer and call."""
    out_k, out_r, launched, pools_k, pools_r = quant_paths(
        model, runner_cls, kind, **kw)
    got = {name: (k, forms) for name, (k, _, forms) in launched.items()
           if k}
    if got != want or any(p for _, p, _ in launched.values()):
        raise AssertionError(f"{runner_cls.__name__} {kind}: the kernel run "
                             f"launched {launched}, not {want}")
    worst = max(((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(out_k, out_r))
    cfg = model.cfg
    dtype = kw.get("dtype")
    label = f"{runner_cls.__name__} {kind}" + (
        f" (dtype {str(dtype).replace('torch.', '')})" if dtype else "")
    codes = ""
    if kind != "fp32":
        share = [(a[0] != b[0]).float().mean().item()
                 for a, b in zip(pools_k, pools_r)]
        codes = (f"; K codes that differ between the runs' pools, by layer:"
                 f" {' '.join(f'{x:.2e}' for x in share)}")
    log(f"{label} pools, kernels {json.dumps(got)} vs "
        f"the gather path ({cfg.num_layers} layers, full width, chunks "
        f"{list(kw.get('chunks', (256, 256)))} + {kw.get('steps', 8)} "
        f"decode steps of {list(kw.get('rows', (2,)))} rows, all but one "
        f"dead): worst max|logit diff| / max|logit| {worst:.3e}"
        f" (gate {tol:.1e}){'' if gate else ', reported, not gated'}{codes}")
    if gate and not worst <= tol:
        raise AssertionError(f"{label}: logits differ from the gather path "
                             f"by {worst:.3e} > {tol} of their max")
    return worst


# ---------------------------------------- sampling, graphs, horizons

SAMPLE_TEMPS = (0.3, 0.7, 1.0, 1.5)
SAMPLE_CONFIGS = ((None, None), (1, None), (50, None), (None, 0.9), (8, 0.9))


def sampler_phase(rows=64, vocab=32000):
    """The seeded sampler (`_sampled_rows`, every sampled token's path) on
    the card against the same function on the CPU: 64 rows of vocabulary
    32000, seeds 0-7 x steps 0-7 x the temperatures, for every (top_k,
    top_p); every token equal. A token that parts prints its perturbed
    top-2 margin (masked logits + Gumbel noise, on the CPU) and fails the
    run."""
    from paddle_tpu_torch.core import random as prandom
    from paddle_tpu_torch.models.generation import _masked_logits
    from paddle_tpu_torch.serving.model_runner import PagedModelRunner

    rng = np.random.default_rng(0)
    logits = torch.from_numpy(
        (rng.standard_normal((rows, vocab)) * 3).astype(np.float32))
    on_card = logits.cuda()
    grid = [(seed, step, t) for t in SAMPLE_TEMPS for step in range(8)
            for seed in range(8)]
    parted, total, card_ms = [], 0, []
    for top_k, top_p in SAMPLE_CONFIGS:
        for i in range(0, len(grid), rows):
            seeds, steps, temps = (torch.tensor(c) for c in
                                   zip(*grid[i:i + rows]))
            temps = temps.float()
            cpu = PagedModelRunner._sampled_rows(logits, seeds, steps, temps,
                                                 top_k, top_p)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            card = PagedModelRunner._sampled_rows(
                on_card, seeds.cuda(), steps.cuda(), temps.cuda(), top_k,
                top_p)
            end.record()
            card = card.cpu()
            card_ms.append(start.elapsed_time(end))
            total += len(seeds)
            for b in torch.nonzero(card != cpu).flatten().tolist():
                key = prandom.fold_in(prandom.key(seeds[b:b + 1]),
                                      steps[b:b + 1])
                noisy = (_masked_logits(logits[b:b + 1],
                                        temps[b:b + 1, None], top_k, top_p)
                         + prandom.gumbel(key, (vocab,)))[0]
                top2 = torch.topk(noisy, 2).values
                parted.append((int(seeds[b]), int(steps[b]),
                               float(temps[b]), top_k, top_p, int(card[b]),
                               int(cpu[b]), float(top2[0] - top2[1])))
    log(f"sampler: {total} draws ({rows} rows of vocab {vocab}, seeds 0-7 x "
        f"steps 0-7 x temperatures {list(SAMPLE_TEMPS)} x (top_k, top_p) "
        f"{list(SAMPLE_CONFIGS)}): card equals CPU on "
        f"{total - len(parted)}; card ms per {rows}-row call median "
        f"{statistics.median(card_ms):.3f} (first call included in max "
        f"{max(card_ms):.3f})")
    for seed, step, t, k, p, a, b, margin in parted:
        log(f"  parted: seed {seed} step {step} temperature {t} top_k {k} "
            f"top_p {p}: card {a} cpu {b}, perturbed top-2 margin "
            f"{margin:.3e}")
    if parted:
        raise AssertionError(f"{len(parted)} sampled tokens differ between "
                             "the card and the CPU")


def _count_inner_steps(runner):
    """Wrap a runner's decode calls to count the decode steps they run (a
    horizon of s counts s)."""
    seen = {"steps": 0}
    decode, multi = runner.decode, runner.decode_multi

    def counted_decode(*a, **kw):
        out = decode(*a, **kw)
        seen["steps"] += 1
        return out

    def counted_multi(tokens, tables, pos, pools, num_steps, **kw):
        out = multi(tokens, tables, pos, pools, num_steps, **kw)
        seen["steps"] += num_steps
        return out

    runner.decode, runner.decode_multi = counted_decode, counted_multi
    return seen


def graphs_phase(model, cfg, kv_dtype, B=8, seed=3):
    """A captured decode step, greedy horizon of 8 and seeded early-stop
    horizon of 8, each replayed from its graph and run eagerly on the same
    inputs over two copies of the same pools: outputs and pools equal bit
    for bit, the launches one replay credits equal to the eager call's.
    The first graphed call of a kind runs for real and captures; the
    second replays."""
    from paddle_tpu_torch.serving import KVCachePool, LlamaRunner

    runner = LlamaRunner(model, block_size=16, max_model_len=512,
                         kv_dtype=kv_dtype)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(100, 400, B)]
    P = 32
    pools, tables = [], None
    for _ in range(2):
        pool = KVCachePool(cfg.num_layers, B * P + 1, 16, runner.n_kv_heads,
                           runner.head_dim, device="cuda", kv_dtype=kv_dtype)
        rows = [pool.pad_table(pool.allocator.alloc(P), P) for _ in prompts]
        firsts = [int(torch.argmax(runner.prefill(p, r, pool.shards)[0]))
                  for p, r in zip(prompts, rows)]
        pools.append(pool.shards)
        tables = np.asarray(rows, np.int32)
    pos = np.asarray([len(p) for p in prompts], np.int32)
    fed = np.asarray(firsts, np.int32)
    ext = dict(seeds=np.arange(B), base_steps=np.ones(B, np.int32),
               temps=np.asarray([0.7] * (B // 2) + [0.0] * (B - B // 2),
                                np.float32), top_k=50, top_p=0.9,
               stop_ids=np.full((B, 1), -1, np.int32),
               remaining=np.full(B, 8, np.int32), early_stop=True)
    calls = [("decode", (), {}, 0), ("decode", (), {}, 1),
             ("decode_multi", (8,), {}, 2), ("decode_multi", (8,), {}, 10),
             ("decode_multi", (8,), ext, 18), ("decode_multi", (8,), ext, 26)]
    every = _all_counts()
    for i, (kind, n, kw, off) in enumerate(calls):
        args = (fed, tables, pos + off)
        c0 = [c.kernel_launches for _, c in every]
        runner.graphs = False
        eager, _ = getattr(runner, kind)(*args, pools[0], *n, **kw)
        eager = eager.clone()
        c1 = [c.kernel_launches for _, c in every]
        runner.graphs = True
        graphed, _ = getattr(runner, kind)(*args, pools[1], *n, **kw)
        torch.cuda.synchronize()
        c2 = [c.kernel_launches for _, c in every]
        launches_e = {nm: b - a for (nm, _), a, b in zip(every, c0, c1)
                      if b - a}
        launches_g = {nm: b - a for (nm, _), a, b in zip(every, c1, c2)
                      if b - a}
        diff = (graphed.double() - eager.double()).abs().max().item()
        label = kind + ("_x" if kw else "")
        how = "replay" if i % 2 else "first call (real run + capture)"
        log(f"graphs ({kv_dtype} KV) {label} {how}: bitwise equal to eager "
            f"{torch.equal(graphed, eager)}, max|diff| {diff:.3e}; launches "
            f"eager {launches_e}, graphed {launches_g}")
        if not torch.equal(graphed, eager) or launches_e != launches_g:
            raise AssertionError(f"graphs ({kv_dtype}): {label} {how} differs"
                                 " from the eager call")
        last = (torch.argmax(eager, dim=-1) if kind == "decode"
                else eager[0, :, -1])
        fed = last.to(torch.int32).cpu().numpy()
    plain = sum(c.plain_launches for _, c in every)
    same_pools = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                     for sa, sb in zip(*pools) for la, lb in zip(sa, sb)
                     for a, b in zip(la, lb))
    for cap in runner.captures:
        log(f"graphs ({kv_dtype} KV) capture {cap['kind']} key {cap['key']}:"
            f" {cap['seconds']:.3f} s, graph pool "
            f"{cap['pool_bytes'] / 2**20:.1f} MiB")
    log(f"graphs ({kv_dtype} KV): pools bitwise equal after both runs "
        f"{same_pools}, plain launches {plain}")
    if not same_pools or plain:
        raise AssertionError(f"graphs ({kv_dtype}): pools differ or a plain "
                             "version ran")


def horizon_requests(cfg, seed=0, n=8, max_tokens=64, greedy_stops=None):
    """Phase 4's prompts with max_tokens 64: requests 0-3 greedy, 4-7 at
    temperature 0.7, top_k 50, top_p 0.9 and seeds 0-3; one stop token
    each (a greedy request's is its fp32 stream's 21st token)."""
    from paddle_tpu_torch.serving import SamplingParams

    rng = np.random.default_rng(seed)
    lens = rng.integers(100, 601, n)
    prompts = [rng.integers(1, cfg.vocab_size, int(k)).tolist()
               for k in lens]
    stops = np.random.default_rng(seed + 1).integers(1, cfg.vocab_size, n)
    sps = []
    for i in range(n):
        if i < n // 2:
            stop = greedy_stops[i] if greedy_stops else int(stops[i])
            sps.append(SamplingParams(max_tokens=max_tokens,
                                      stop_token_ids=(int(stop),)))
        else:
            sps.append(SamplingParams(
                max_tokens=max_tokens, temperature=0.7, top_k=50,
                top_p=0.9, seed=i - n // 2, stop_token_ids=(int(stops[i]),)))
    return prompts, sps


HORIZON_KNOBS = dict(decode_horizon=8, pipelined=True, horizon_sampling=True,
                     horizon_early_stop=True)


def horizon_phase(model, cfg, kv_dtype, greedy_stops):
    """The 8 requests served by the per-step engine, run eagerly, and by
    the engine with HORIZON_KNOBS, its decode kinds as CUDA graphs, each
    twice (the first round captures the graphs it needs, the second
    replays them): the streams equal token for token, every request
    finished, no page leaked; the attention kernel of the decode path (K2
    over fp32 pools, K1-q's decode form over int8 / fp8) launched once a
    layer on every inner decode step, the prefill kernel once a layer on
    every chunk, nothing else and no plain version. Returns the horizon
    engine's decode-kernel launches of its first round."""
    from paddle_tpu_torch.inference import create_serving_engine

    prompts, sps = horizon_requests(cfg, greedy_stops=greedy_stops)
    streams, launches = [], []
    for label, knobs in (("per-step, eager", {}),
                         ("horizon 8, pipelined, graphs", HORIZON_KNOBS)):
        eng = create_serving_engine(
            model, device="cuda", block_size=16, num_blocks=1024,
            max_batch_size=8, max_model_len=4096,
            max_prefill_tokens_per_step=256, kv_dtype=kv_dtype, audit=True,
            **knobs)
        eng.runner.graphs = bool(knobs)
        inner = _count_inner_steps(eng.runner)
        for rnd in (1, 2):
            tokens, kernel = _horizon_round(eng, cfg, f"{label}, round {rnd}",
                                            inner, prompts, sps)
            streams.append(tokens)
            launches.append(kernel)
        if knobs:
            horizon_profile(eng, cfg)
        del eng
        _free_the_card()
    for n, other in enumerate(streams[1:], 1):
        if other != streams[0]:
            for i, (a, b) in enumerate(zip(streams[0], other)):
                j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                         min(len(a), len(b)))
                if a != b:
                    log(f"  request {i}: first divergence at token {j}: "
                        f"per-step {a[j:j + 4]}, run {n} {b[j:j + 4]}")
            raise AssertionError(f"horizon ({kv_dtype}): run {n}'s streams "
                                 "differ from the per-step engine's")
    log(f"horizon ({kv_dtype} KV): the per-step and horizon engines' "
        f"streams are equal token for token in both rounds "
        f"({sum(map(len, streams[0]))} tokens a round)")
    return launches[2]


def _horizon_round(eng, cfg, label, inner, prompts, sps):
    """Serve the requests once on ``eng`` and gate the run (horizon_phase);
    returns the streams and the decode kernel's launches."""
    kv_dtype = eng.kv_dtype
    decode_kernel = ("paged_decode_attention" if kv_dtype == "fp32"
                     else f"ragged_paged_attention_{kv_dtype}")
    counts = _all_counts()
    for _, c in counts:
        c.reset()
    m = eng.metrics
    base = m.snapshot()
    inner0 = inner["steps"]
    ttft0 = m.ttft_s.count
    ids = [eng.add_request(p, sp) for p, sp in zip(prompts, sps)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    # decode-only steps: wall, tokens committed, inner steps launched
    dec = [0.0, 0, 0]
    while eng.has_work():
        chunks, toks0, i0 = (m.prefill_chunks.value,
                             m.tokens_generated.value, inner["steps"])
        t1 = time.perf_counter()
        eng.step()          # a drain ends every step (pipelined: mid-step)
        if m.prefill_chunks.value == chunks:
            dec[0] += time.perf_counter() - t1
            dec[1] += int(m.tokens_generated.value - toks0)
            dec[2] += inner["steps"] - i0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    outs = eng.outputs()
    kernel = {nm: c.kernel_launches for nm, c in counts}
    forms = {nm: dict(c.form_launches) for nm, c in counts
             if c.form_launches}
    plain = sum(c.plain_launches for _, c in counts)
    snap = m.snapshot()
    toks = snap["tokens_generated"] - base["tokens_generated"]
    syncs = snap["host_syncs"] - base["host_syncs"]
    steps = inner["steps"] - inner0
    ttft = m.ttft_s._samples[ttft0:]
    caps = [(c["kind"], c["key"][2] if len(c["key"]) > 2 else 1,
             round(c["seconds"], 3)) for c in eng.runner.captures]
    grew = {k: int(snap[k] - base[k]) for k in (
        "decode_horizon_steps", "horizon_overshoot_tokens")}
    log(f"horizon ({kv_dtype} KV) {label}: {int(toks)} tokens in "
        f"{wall:.3f} s = {toks / wall:.1f} tokens/s, TTFT mean "
        f"{1e3 * statistics.mean(ttft):.1f} ms, {steps} inner decode steps; "
        f"decode-only steps {1e3 * dec[0]:.1f} ms for {dec[1]} tokens = "
        f"{1e3 * dec[0] / max(dec[1], 1):.3f} ms per decode token, "
        f"{1e3 * dec[0] / max(dec[2], 1):.3f} ms per inner step; "
        f"host_syncs_per_token {syncs / toks:.4f}, {grew}, finish reasons "
        f"{sorted(outs[i].finish_reason for i in ids)}; captures so far "
        f"(kind, steps, s) {caps}")
    log(f"horizon ({kv_dtype} KV) {label} launches: {kernel}, by form "
        f"{forms}, plain {plain}")
    if any(outs.get(i) is None or outs[i].finish_reason not in
           ("stop", "length") for i in ids):
        raise AssertionError(f"horizon ({kv_dtype}) {label}: not every "
                             "request finished")
    if not eng.pool.allocator.check_no_leaks():
        raise AssertionError(f"horizon ({kv_dtype}) {label}: leaked pages")
    # K2 (fp32) or K1-q (int8 / fp8) once a layer on every inner decode
    # step, K1 / K1-q once a layer on every prefill chunk; a chunk of
    # G <= 8 rows takes K1-q's decode form too
    L = cfg.num_layers
    chunks = int(snap["prefill_chunks"] - base["prefill_chunks"])
    if kv_dtype == "fp32":
        want = {decode_kernel: L * steps, "ragged_paged_attention": L * chunks}
        decode_form = kernel[decode_kernel]
    else:
        want = {decode_kernel: L * (steps + chunks)}
        decode_form = forms.get(decode_kernel, {}).get("decode", 0)
    got = {nm: k for nm, k in kernel.items() if k}
    if got != want or plain or decode_form < L * steps:
        raise AssertionError(
            f"horizon ({kv_dtype}) {label}: launches {got}, want {want} for "
            f"{steps} inner decode steps and {chunks} prefill chunks of {L} "
            f"layers; decode form {decode_form}; plain {plain}")
    return [outs[i].output_tokens for i in ids], kernel[decode_kernel]


def horizon_profile(eng, cfg, steps=3, prompt_len=300):
    """Where a horizon's time goes: 8 greedy requests in decode on the
    horizon engine, `steps` steps (one horizon of 8 each, pipelined)
    timed, then as many under torch.profiler; device busy against the
    host wall, idle share."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.serving import SamplingParams

    rng = np.random.default_rng(5)
    for _ in range(8):
        eng.add_request(rng.integers(1, cfg.vocab_size, prompt_len).tolist(),
                        SamplingParams(max_tokens=8 * (2 * steps + 3)))
    while eng.scheduler.waiting or any(
            r.phase == "prefill" for r in eng.scheduler.running) \
            or eng._inflight is None or eng._inflight.s != 8:
        eng.step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    groups, top = _device_ms(prof)
    busy = sum(groups.values()) / steps
    per = {g: round(ms / steps, 4) for g, ms in
           sorted(groups.items(), key=lambda kv: -kv[1])}
    log(f"profile ({eng.kv_dtype} KV) horizon of 8 decode steps (8 "
        f"sequences, graph replay): host wall {wall:.3f} ms/horizon "
        f"({wall / 8:.3f} ms/step), device busy {busy:.3f} ms/horizon, idle "
        f"share {1 - busy / wall:.3f}; device ms/horizon by group "
        f"{json.dumps(per)}")
    for name, ms in top:
        log(f"  {ms / steps:.4f} ms/horizon  {name[:110]}")
    if busy == 0.0:
        log("  torch.profiler recorded no device time here: the device "
            "split of this window is not measured")
    eng.run()


# ------------------------------- prefix cache, fused steps, speculation

def _zeroed_counts():
    """Every serving kernel's LaunchCounts, set to 0."""
    counts = _all_counts()
    for _, c in counts:
        c.reset()
    return counts


def _launches(counts):
    """(kernel launches, launches by form, plain launches) of a run."""
    kernel = {n: c.kernel_launches for n, c in counts if c.kernel_launches}
    forms = {n: dict(c.form_launches) for n, c in counts if c.form_launches}
    return kernel, forms, sum(c.plain_launches for _, c in counts)


def _top2_margin(runner, prompt, tokens, j) -> float:
    """The top-1 minus top-2 logit where a stream's token j is sampled:
    the context prompt + tokens[:j] prefilled on a private pool."""
    from paddle_tpu_torch.serving import KVCachePool
    ctx = list(prompt) + list(tokens[:j])
    n = -(-len(ctx) // runner.block_size)
    pool = KVCachePool(runner.num_layers, n + 1, runner.block_size,
                       runner.n_kv_heads, runner.head_dim, runner.dtype,
                       device=runner.device, kv_dtype=runner.kv_dtype)
    logits, _ = runner.prefill(ctx, pool.allocator.alloc(n), pool.shards)
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def _gate_streams(label, runner, prompts, got, want):
    """Every request's stream equal to the reference's; where a token
    parts, the top-2 margin there is printed and the run fails."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        margin = (_top2_margin(runner, prompts[i], b, j)
                  if runner is not None else float("nan"))
        log(f"{label}: request {i} parts at token {j}: {a[j:j + 4]} against "
            f"{b[j:j + 4]}; the top-2 margin of the reference there "
            f"{margin:.4e}")
        raise AssertionError(f"{label}: request {i}'s stream parts at token "
                             f"{j}")


def _fork_check(eng, prompt, label):
    """Fork a cached page of the engine's live pool through
    SequenceKV.ensure_writable (as tests/test_serving_prefix.py's
    copy-on-write pin does): the source page's bytes (every layer's K and
    V, and the scale rows of an int8 pool) are the same before and after,
    and the fork equals them."""
    from paddle_tpu_torch.serving import SequenceKV
    pool, cache = eng.pool, eng.pool.prefix_cache
    seq = SequenceKV(pool)
    matched = cache.match(prompt)
    if not matched:
        raise AssertionError(f"{label}: no cached page to fork")
    cache.acquire(matched)
    seq.adopt_prefix(matched, pool.block_size)
    src = seq.pages[0]

    def page(p):
        return [t.view(torch.uint8)[p].clone() for layer in pool.pools
                for t in layer]
    before = page(src)
    forked = seq.ensure_writable(0, pool.block_size)
    torch.cuda.synchronize()
    after, fork = page(src), page(seq.pages[0])
    same = all(torch.equal(a, b) for a, b in zip(before, after))
    copied = all(torch.equal(a, c) for a, c in zip(before, fork))
    refs, new = pool.allocator.refcount(src), seq.pages[0]
    seq.release()
    log(f"prefix ({label}): forked cached page {src} -> page {new}: "
        f"{forked} fork, "
        f"{len(before)} tensors a page (every layer's K, V"
        f"{' and scale rows' if pool.kv_dtype == 'int8' else ''}); source "
        f"bytes unchanged {same}, fork equal {copied}, source refcount "
        f"{refs} after the fork")
    if forked != 1 or not same or not copied:
        raise AssertionError(f"prefix ({label}): copy-on-write fork failed")


# phase 28: a chat service's shared 512-token system prompt
PREFIX_SYSTEM = 512


def prefix_requests(cfg, seed=6, n=8):
    """8 requests: the same 512-token system prompt plus 64-192 random
    tokens of their own."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, cfg.vocab_size, PREFIX_SYSTEM).tolist()
    return [system + rng.integers(1, cfg.vocab_size,
                                  int(rng.integers(64, 193))).tolist()
            for _ in range(n)]


def _prefix_arm(model, prompts, on, kv_dtype="fp32", slots=8, max_tokens=32):
    """Serve request 0, then the others once its first token is out, on an
    engine with the prefix cache ``on`` or off. Returns the engine and
    what the run read."""
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.serving import SamplingParams

    eng = create_serving_engine(
        model, device="cuda", block_size=16, num_blocks=1024,
        max_batch_size=slots, max_model_len=1024,
        max_prefill_tokens_per_step=256, kv_dtype=kv_dtype,
        enable_prefix_cache=on, audit=True)
    sp = SamplingParams(max_tokens=max_tokens)
    m = eng.metrics
    counts = _zeroed_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [eng.add_request(prompts[0], sp)]
    while m.tokens_generated.value == 0:
        eng.step()
    ids += [eng.add_request(p, sp) for p in prompts[1:]]
    while eng.has_work():
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernel, forms, plain = _launches(counts)
    outs = eng.outputs()
    if any(outs[i].finish_reason != "length" for i in ids):
        raise AssertionError(f"prefix arm ({kv_dtype}, cache {on}): not "
                             "every request finished")
    ttft = [1e3 * outs[i].ttft_s for i in ids]
    run = dict(tokens=[outs[i].output_tokens for i in ids], ttft_ms=ttft,
               prefill=int(m.prefill_tokens.value),
               hits=int(m.prefix_hit_tokens.value),
               cow=int(m.cow_copies.value), wall=wall,
               tps=m.tokens_generated.value / wall, kernel=kernel,
               forms=forms, plain=plain)
    log(f"prefix ({kv_dtype} KV, {slots} slots, cache "
        f"{'on' if on else 'off'}): {int(m.tokens_generated.value)} tokens "
        f"in {wall:.3f} s = {run['tps']:.1f} tokens/s; TTFT mean "
        f"{statistics.mean(ttft):.1f} ms, request 0 {ttft[0]:.1f} ms, "
        f"requests 1-{len(ids) - 1} mean {statistics.mean(ttft[1:]):.1f} "
        f"ms; prefill tokens computed {run['prefill']}, prefix_hit_tokens "
        f"{run['hits']}, cow_copies {run['cow']}; launches {kernel}, by "
        f"form {forms}, plain {plain}")
    return eng, run


def prefix_phase(model, cfg):
    """Phase 28: the shared-prefix page cache at LLaMA-2-7B. The 8 requests
    of `prefix_requests` (32 greedy tokens each) with the cache off and
    on, 8 slots, fp32 pools: streams equal, two requests equal
    naive_generate, prefix_hit_tokens = 7 x 512, computed + hit = the
    contexts, no leak after release_prefix_cache(), no plain launch;
    cow_copies reported (no write lands on a shared page in this
    traffic). A cached page of the live pool forked on the card (fp32,
    then int8 and fp8). Then both arms on one-slot int8 and fp8 engines
    (the first 3 requests, 16 tokens each): streams equal between the
    arms. Returns the launches by form of the cache-on fp32 run."""
    from paddle_tpu_torch.serving import SamplingParams

    prompts = prefix_requests(cfg)
    total = sum(map(len, prompts))
    runs = {}
    for on in (False, True):
        eng, runs[on] = _prefix_arm(model, prompts, on)
        r = runs[on]
        if r["plain"] or set(r["kernel"]) != {"ragged_paged_attention",
                                              "paged_decode_attention"}:
            raise AssertionError(f"prefix arm (cache {on}): launches "
                                 f"{r['kernel']}, plain {r['plain']}")
        if r["prefill"] + r["hits"] != total:
            raise AssertionError(f"prefix arm (cache {on}): computed "
                                 f"{r['prefill']} + hit {r['hits']} != "
                                 f"context {total}")
        if on:
            want = (len(prompts) - 1) * PREFIX_SYSTEM
            if r["hits"] != want:
                raise AssertionError(f"prefix_hit_tokens {r['hits']} != "
                                     f"{want}")
            for i in (0, int(np.argmax([len(p) for p in prompts]))):
                verdict = check_against_naive(
                    eng.runner, prompts[i], r["tokens"][i],
                    SamplingParams(max_tokens=32), 1024)
                log(f"naive_generate check (prefix cache on), request {i} "
                    f"(prompt {len(prompts[i])}): {verdict}")
            _fork_check(eng, prompts[0], "fp32, 8 slots")
            released = eng.release_prefix_cache()
            log(f"prefix: release_prefix_cache() dropped {released} pages")
        if not eng.pool.allocator.check_no_leaks():
            raise AssertionError(f"prefix arm (cache {on}): leaked pages")
        runner = eng.runner
        del eng
        _free_the_card()
    _gate_streams("prefix (fp32, cache on vs off)", runner, prompts,
                  runs[True]["tokens"], runs[False]["tokens"])
    log(f"prefix (fp32): streams of both arms equal token for token; TTFT "
        f"of requests 1-7 {statistics.mean(runs[False]['ttft_ms'][1:]):.1f}"
        f" -> {statistics.mean(runs[True]['ttft_ms'][1:]):.1f} ms, prefill "
        f"tokens {runs[False]['prefill']} -> {runs[True]['prefill']}, "
        f"tokens/s {runs[False]['tps']:.1f} -> {runs[True]['tps']:.1f}")
    for kind in ("int8", "fp8"):
        few = {}
        for on in (False, True):
            eng, few[on] = _prefix_arm(model, prompts[:3], on, kind,
                                       slots=1, max_tokens=16)
            name = f"ragged_paged_attention_{kind}"
            if few[on]["plain"] or set(few[on]["kernel"]) != {name}:
                raise AssertionError(f"prefix one-slot {kind}: launches "
                                     f"{few[on]['kernel']}")
            if on:
                if few[on]["hits"] != 2 * PREFIX_SYSTEM:
                    raise AssertionError(f"prefix one-slot {kind}: hits "
                                         f"{few[on]['hits']}")
                _fork_check(eng, prompts[0], f"{kind}, one slot")
                eng.release_prefix_cache()
            if not eng.pool.allocator.check_no_leaks():
                raise AssertionError(f"prefix one-slot {kind}: leaked")
            runner = eng.runner
            del eng
            _free_the_card()
        _gate_streams(f"prefix ({kind}, one slot, cache on vs off)", runner,
                      prompts, few[True]["tokens"], few[False]["tokens"])
        log(f"prefix ({kind} KV, one slot): streams of both arms equal")
    return runs[True]["forms"]


def _count_calls(runner, names):
    """Wrap the runner's ``names`` methods to count their calls."""
    seen = dict.fromkeys(names, 0)
    for name in names:
        real = getattr(runner, name)

        def counted(*a, _n=name, _r=real, **kw):
            seen[_n] += 1
            return _r(*a, **kw)
        setattr(runner, name, counted)
    return seen


def ragged_phase(model, cfg, ref_tokens, seed=0, n_requests=8):
    """Phase 29: fused ragged steps at LLaMA-2-7B with phase 4's traffic
    (its seed: 8 requests of 100-600 prompt tokens, 32 greedy tokens,
    budget 256), `ragged_batch=True`, plain then pipelined, counts zeroed
    before each run: tokens equal phase 4's unfused engine, every step
    with chunks and decode rows one ragged_step (K1 once a layer, no K2),
    K2 once a layer on each decode-only step, no plain launch, the
    auditor clean. Then where a fused step's time goes (torch.profiler):
    lone 256-token chunk steps, decode-only steps of 7 rows, and fused
    steps of one 256-token chunk beside the 7 decode rows. Returns the K1
    launches of the plain fused run and its forms, the fused K1 launches'
    device ms and the fused step's numbers."""
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.serving import SamplingParams

    rng = np.random.default_rng(seed)
    lens = rng.integers(100, 601, n_requests)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in lens]
    sp = SamplingParams(max_tokens=32)
    L = cfg.num_layers
    result = {}
    for label, knobs in (("plain", {}), ("pipelined", {"pipelined": True})):
        eng = create_serving_engine(
            model, device="cuda", block_size=16, num_blocks=1024,
            max_batch_size=8, max_model_len=4096,
            max_prefill_tokens_per_step=256, audit=True, ragged_batch=True,
            **knobs)
        calls = _count_calls(eng.runner, ("ragged_step", "prefill_chunk",
                                          "decode"))
        counts = _zeroed_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = [eng.add_request(p, sp) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kernel, forms, plain = _launches(counts)
        outs = eng.outputs()
        tokens = [outs[i].output_tokens for i in ids]
        m = eng.metrics
        log(f"fused ragged ({label}): {int(m.tokens_generated.value)} tokens "
            f"in {wall:.3f} s = {m.tokens_generated.value / wall:.1f} "
            f"tokens/s, TTFT mean {1e3 * m.ttft_s.mean:.1f} ms; runner calls "
            f"{calls}; launches {kernel}, by form {forms}, plain {plain}")
        want = {"ragged_paged_attention": L * (calls["ragged_step"]
                                               + calls["prefill_chunk"]),
                "paged_decode_attention": L * calls["decode"]}
        if (plain or kernel != want or not calls["ragged_step"]
                or not forms["ragged_paged_attention"].get("span")):
            raise AssertionError(f"fused ragged ({label}): launches "
                                 f"{kernel}, want {want}; plain {plain}")
        if not eng.pool.allocator.check_no_leaks():
            raise AssertionError(f"fused ragged ({label}): leaked pages")
        _gate_streams(f"fused ragged ({label}) vs phase 4's engine",
                      eng.runner, prompts, tokens, ref_tokens)
        log(f"fused ragged ({label}): streams equal phase 4's unfused "
            "engine token for token")
        if label == "plain":
            result["launches"] = kernel["ragged_paged_attention"]
            result["forms"] = forms["ragged_paged_attention"]
            result.update(fused_profile(eng, cfg))
        del eng
        _free_the_card()
    return result


def _profiled(eng, steps, before_step, label):
    """Host wall of ``steps`` engine steps, then as many under
    torch.profiler: (wall ms a step, device busy ms a step, {group: ms a
    step}, K1 device ms a launch)."""
    import paddle_tpu_torch.ops.ragged_paged_attention as k1
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        before_step()
        eng.step()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t) / steps
    n1 = k1.COUNTS.kernel_launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            before_step()
            eng.step()
        torch.cuda.synchronize()
    n1 = k1.COUNTS.kernel_launches - n1
    groups, top = _device_ms(prof)
    busy = sum(groups.values()) / steps
    per = {g: round(ms / steps, 4) for g, ms in
           sorted(groups.items(), key=lambda kv: -kv[1])}
    k1_ms = groups.get("K1 ragged_paged_attention", 0.0) / n1 if n1 else 0.0
    log(f"profile {label}: host wall {wall:.3f} ms/step, device busy "
        f"{busy:.3f} ms/step, idle share {1 - busy / wall:.3f}; K1 "
        f"{k1_ms:.4f} device ms a launch over {n1 / steps:.0f} launches a "
        f"step; device ms/step by group {json.dumps(per)}")
    for name, ms in top:
        log(f"  {ms / steps:.4f} ms/step  {name[:110]}")
    if busy == 0.0:
        log("  torch.profiler recorded no device time here: the device "
            "split of this window is not measured")
    return wall, busy, per, k1_ms


def fused_profile(eng, cfg, steps=3):
    """Where a fused step's time goes, on the fused engine: lone 256-token
    chunk steps (no decode row: the unfused chunk path), decode-only steps
    of 7 rows (K2), and fused steps of one 256-token chunk beside the same
    7 decode rows (one ragged_step, T = 256)."""
    from paddle_tpu_torch.serving import SamplingParams

    rng = np.random.default_rng(7)
    one = SamplingParams(max_tokens=1)

    def add_chunk():
        eng.add_request(rng.integers(1, cfg.vocab_size, 256).tolist(), one)
    chunk = _profiled(eng, steps, add_chunk, "fused engine, lone 256-token "
                      "chunk step")
    for _ in range(7):
        eng.add_request(rng.integers(1, cfg.vocab_size, 300).tolist(),
                        SamplingParams(max_tokens=8 * steps + 8))
    while eng.scheduler.waiting or any(
            r.phase == "prefill" for r in eng.scheduler.running):
        eng.step()
    decode = _profiled(eng, steps, lambda: None, "fused engine, decode-only "
                       "step (7 rows)")
    fused = _profiled(eng, steps, add_chunk, "fused step (one 256-token "
                      "chunk + 7 decode rows, T = 256)")
    eng.run()
    both = chunk[1] + decode[1]
    log(f"fused step: {fused[1]:.3f} device ms against a lone chunk step "
        f"{chunk[1]:.3f} + a decode step {decode[1]:.3f} = {both:.3f} ms "
        f"({fused[1] / max(both, 1e-9):.3f}x); K1 {fused[3]:.4f} ms a launch in the "
        f"fused step against {chunk[3]:.4f} in the lone chunk's; idle share "
        f"{1 - fused[1] / fused[0]:.3f}")
    return {"fused_step_device_ms": fused[1], "fused_step_wall_ms": fused[0],
            "chunk_step_device_ms": chunk[1],
            "decode_step_device_ms": decode[1],
            "fused_k1_ms": fused[3], "chunk_k1_ms": chunk[3]}


SPEC_ARMS = (
    ("off", dict(decode_horizon=8, pipelined=True, horizon_early_stop=True)),
    ("per_step", dict(num_speculative_tokens=4, ragged_batch=True)),
    ("fused", dict(num_speculative_tokens=4, decode_horizon=8,
                   pipelined=True, horizon_early_stop=True)),
    ("draft", dict(num_speculative_tokens=4, decode_horizon=8,
                   pipelined=True, horizon_early_stop=True,
                   spec_draft_model="shadow:fp32", spec_adaptive_k=True)),
    # phase 32's draft rung: the JAX default shadow, int8 weights
    ("draft_int8", dict(num_speculative_tokens=4, decode_horizon=8,
                        pipelined=True, horizon_early_stop=True,
                        spec_draft_model="shadow", spec_adaptive_k=True)))


def spec_requests(cfg, seed=0, n=8, prompt=256):
    """bench.py::child_serving_spec's traffic: 256-token prompts that
    repeat a random 3-6 token pattern."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pattern = rng.integers(0, cfg.vocab_size,
                               int(rng.integers(3, 7))).tolist()
        out.append((pattern * (prompt // len(pattern) + 1))[:prompt])
    return out


def _spec_engine(model, knobs, prompt=256, gen=64, slots=8):
    from paddle_tpu_torch.inference import create_serving_engine
    max_len = prompt + gen
    pages = -(-max_len // 16)
    if "spec_draft_model" in knobs:
        knobs = dict(knobs, spec_draft_blocks=slots * (pages + 1) + 1)
    return create_serving_engine(
        model, device="cuda", block_size=16,
        num_blocks=slots * pages + 1, max_batch_size=slots,
        max_model_len=max_len, max_prefill_tokens_per_step=64, audit=True,
        **knobs)


def _spec_round(eng, prompts, label, gen=64):
    from paddle_tpu_torch.serving import SamplingParams

    counts = _zeroed_counts()
    m = eng.metrics
    base = m.snapshot()
    draft = getattr(eng.proposer, "runner", None)
    runners = [eng.runner] + ([draft] if draft is not None else [])
    caps0 = [len(r.captures) for r in runners]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [eng.add_request(p, SamplingParams(max_tokens=gen))
           for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernel, forms, plain = _launches(counts)
    snap = m.snapshot()
    d = {k: snap[k] - base[k] for k in (
        "tokens_generated", "decode_steps", "host_syncs",
        "spec_proposed_tokens", "spec_accepted_tokens",
        "spec_fused_horizons", "spec_rollback_pages")}
    toks = d["tokens_generated"]
    caps = [c for r, n in zip(runners, caps0) for c in r.captures[n:]]
    run = dict(
        tokens=[eng.outputs()[i].output_tokens for i in ids],
        steps_per_token=d["decode_steps"] / toks,
        syncs_per_token=d["host_syncs"] / toks, tps=toks / wall,
        acceptance=(d["spec_accepted_tokens"] / d["spec_proposed_tokens"]
                    if d["spec_proposed_tokens"] else 0.0),
        proposed=int(d["spec_proposed_tokens"]),
        accepted=int(d["spec_accepted_tokens"]),
        capture_s=sum(c["seconds"] for c in caps), kernel=kernel,
        forms=forms, plain=plain)
    log(f"speculation {label}: {int(toks)} tokens in {wall:.3f} s = "
        f"{run['tps']:.1f} tokens/s; steps/token "
        f"{run['steps_per_token']:.4f}, host syncs/token "
        f"{run['syncs_per_token']:.4f}; proposed {run['proposed']}, accepted "
        f"{run['accepted']} (acceptance {run['acceptance']:.4f}), fused "
        f"horizons {int(d['spec_fused_horizons'])}, rollback pages "
        f"{int(d['spec_rollback_pages'])}; {len(caps)} captures "
        f"{run['capture_s']:.3f} s; launches {kernel}, by form {forms}, "
        f"plain {plain}")
    if plain:
        raise AssertionError(f"speculation {label}: {plain} plain launches")
    if not eng.pool.allocator.check_no_leaks():
        raise AssertionError(f"speculation {label}: leaked pages")
    return run


def spec_phase(model, cfg):
    """Phase 30: speculative decoding at GPT-3 1.3B with
    bench.py::child_serving_spec's traffic (8 requests, 256-token periodic
    prompts, 64 tokens each, a 64-token prefill budget), the arms of
    SPEC_ARMS, each served twice (the first round captures its graphs):
    every greedy arm's streams equal off's, two requests equal
    naive_generate; one seeded request (temperature 0.8) on per_step
    equals naive_generate with the same seed; proposed > 0 in every
    speculative arm and accepted > 0 in draft; the fused arm served once
    more eagerly (runner.graphs False) gives its graph-replayed streams;
    no leak, no plain launch. Returns K1's and K2's launches by arm."""
    from paddle_tpu_torch.serving import SamplingParams, naive_generate

    prompts = spec_requests(cfg)
    runs, launches = {}, {}
    for name, knobs in SPEC_ARMS:
        eng = _spec_engine(model, knobs)
        for rnd in (1, 2):
            runs[name, rnd] = _spec_round(eng, prompts,
                                          f"{name}, round {rnd}")
        launches[name] = {k: {"launches": n, "by_form": runs[name, 1][
            "forms"].get(k, {})} for k, n in runs[name, 1]["kernel"].items()}
        if name != "off" and not runs[name, 1]["proposed"]:
            raise AssertionError(f"speculation {name}: nothing proposed")
        if name.startswith("draft") and not runs[name, 1]["accepted"]:
            raise AssertionError(f"speculation {name}: nothing accepted")
        if name == "off":
            for i in (0, 5):
                verdict = check_against_naive(
                    eng.runner, prompts[i], runs[name, 1]["tokens"][i],
                    SamplingParams(max_tokens=64), 320)
                log(f"naive_generate check (speculation off), request {i}: "
                    f"{verdict}")
        if name == "per_step":
            sp = SamplingParams(max_tokens=64, temperature=0.8, seed=1000)
            rid = eng.add_request(prompts[3], sp)
            got = eng.run()[rid].output_tokens
            want = naive_generate(eng.runner, prompts[3], sp,
                                  max_model_len=320)
            if got != want:
                raise AssertionError("speculation per_step: the seeded "
                                     "request parts from naive_generate")
            log("speculation per_step: a seeded request (temperature 0.8, "
                "seed 1000) equals naive_generate token for token; "
                f"proposed so far {int(eng.metrics.spec_proposed_tokens.value)}")
        if name == "fused":
            eng.runner.graphs = False
            eager = _spec_round(eng, prompts, "fused, eager (no graphs)")
            if eager["tokens"] != runs[name, 1]["tokens"] or \
                    eager["accepted"] != runs[name, 1]["accepted"]:
                raise AssertionError("speculation fused: the eager run "
                                     "parts from the graph replays")
            log("speculation fused: the eager run equals the graph "
                "replays token for token")
        runner = eng.runner
        del eng
        _free_the_card()
        for rnd in (1, 2):
            if name != "off":
                _gate_streams(f"speculation {name} round {rnd} vs off",
                              runner, prompts, runs[name, rnd]["tokens"],
                              runs["off", 1]["tokens"])
    log("speculation: every arm's greedy streams equal off's; " + "; ".join(
        f"{n}: steps/token {runs[n, 2]['steps_per_token']:.4f}, syncs/token "
        f"{runs[n, 2]['syncs_per_token']:.4f}, {runs[n, 2]['tps']:.1f} "
        f"tokens/s, acceptance {runs[n, 1]['acceptance']:.4f}, capture "
        f"{runs[n, 1]['capture_s']:.3f} s" for n, _ in SPEC_ARMS))
    return launches


# -------------- 16-bit serving, the weight ladder, the mixed pool

# phase 31's 2-layer gate: the bf16 runner's logits against its fp32
# twin's (bf16 weights and activations against fp32 ones: eight bf16
# rounding steps of 2^-9 through two layers and the head); phase 38's at
# fp16 on the same rule, fp16 rounding at 2^-12
TWIN_TOL = {BF16: 2.0 ** -3, F16: 2.0 ** -6}


def half_twin_check(model, label, dtype=BF16):
    """Phases 31 and 38: ``model`` (2 layers at full width, fp32) through
    two create_serving_engine runners, fp32 and ``dtype`` (bf16 or fp16),
    over their own pools: chunks of 256 and 256 tokens, then 8 one-row
    decode steps fed the fp32 run's argmax; every call's 16-bit logits
    within TWIN_TOL of max|logit| of the fp32 twin's, finite; the 16-bit
    run launches only its variants (K1, K2 of ``dtype``) and no plain
    version."""
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.serving import KVCachePool

    cfg = model.cfg
    ps, P = 16, 40
    prompt = np.random.default_rng(4).integers(1, cfg.vocab_size,
                                               512).tolist()
    logits, launched = [], None
    feed = []
    for dt in (None, dtype):
        runner = create_serving_engine(model, dtype=dt, device="cuda",
                                       block_size=ps, max_model_len=ps * P,
                                       num_blocks=P + 1).runner
        pool = KVCachePool(cfg.num_layers, 1 + P, ps, runner.n_kv_heads,
                           runner.head_dim, runner.dtype, device="cuda")
        table = pool.pad_table(pool.allocator.alloc(P), P)
        counts = _zeroed_counts()
        out = []
        pools = pool.shards
        # copies: a replayed decode returns its graph's output buffer,
        # which the next replay overwrites
        for start in (0, 256):
            lg, pools = runner.prefill_chunk(prompt[start:start + 256],
                                             start, table, pools)
            out.append(lg.float().clone())
        for i in range(8):
            if dt is None:
                feed.append(int(torch.argmax(out[-1])))
            lg, pools = runner.decode(np.asarray([feed[i]], np.int32),
                                      np.asarray([table], np.int32),
                                      np.asarray([512 + i], np.int32), pools)
            out.append(lg[0].float().clone())
        logits.append(out)
        launched = _launches(counts)
        del runner, pool, pools
    kernel, forms, plain = launched
    worst = max(((a - b).abs().max() / a.abs().max()).item()
                for a, b in zip(*logits))
    finite = all(bool(torch.isfinite(x).all()) for x in logits[1])
    sfx, tol = HALF_SUFFIX[dtype], TWIN_TOL[dtype]
    log(f"{PHASE_OF[dtype]} {label}: 2-layer {sfx} runner vs its fp32 twin, "
        f"chunks 256 + 256 and 8 decode steps: worst max|logit diff| / "
        f"max|logit| {worst:.3e} (gate {tol:.3e}), finite {finite}; the "
        f"{sfx} run's launches {kernel}, by form {forms}, plain {plain}")
    if not (worst <= tol and finite):
        raise AssertionError(f"{label}: {sfx} logits {worst:.3e} of max from "
                             f"the fp32 twin's (finite {finite})")
    if plain or set(kernel) != set(_path_kernels("fp32", dtype)):
        raise AssertionError(f"{label}: the {sfx} twin launched {kernel}, "
                             f"plain {plain}")
    return worst


# phase 31's gate of the bf16 runner's kernels against the same runner's
# gather path (attn_impl="reference"), 2 layers at full width. Both runs
# emit bf16 logits, whose step near the top is 2^-8 to 2^-7 of max|logit|,
# so where the two runs' fp32 sums part in their last bits the logits
# part by whole steps: 1-2 steps (5.2e-3 to 9.2e-3 of max at both widths
# and over every pool) on an H100. Output stores that truncate to bf16 in
# place of rounding to nearest (half a step of bias) part by 1.5e-2 to
# 1.6e-2, bf16 halves read in the wrong order by 1.4 to 1.6, and both
# fail this gate; a wrong pool dtype or kernel variant fails the exact
# launches. Phase 38's at fp16: the same number of output steps (fp16
# rounds 8x finer, 1.5e-3) holds the fp16-pool rung on an H100 (1.13e-3
# at LLaMA-2-7B width) but not the int8 rung (1.88e-3): there the two
# runs' codes part (0.8 % of layer 1's K codes differ, each a whole
# quantization step, as at bf16), so the gate is 2^-8, a quarter of the
# fp16 twin's, for every pool; the kernels' rounding is held at the kernel
# level (phase 37's misround gate)
GATHER_TOL = {BF16: 1.2e-2, F16: 2.0 ** -8}
# the phase that checks each 16-bit dtype's serving path
PHASE_OF = {BF16: "phase 31", F16: "phase 38"}
# phase 33's gate of an fp8 tenant against the native fp8 engine (K2 over
# the mixed pool's rounded values against K1-q over fp8 codes): where the
# two streams part, the twin's top-2 margin within this of its max|logit|;
# phase 39's at fp16, where two attention paths' logits part by up to
# GATHER_TOL[F16], within twice that
MIXED_MARGIN = {None: 1e-3, F16: 2 * GATHER_TOL[F16]}


def half_gather_check(model, runner_cls, label, gate=True, dtype=BF16):
    """Phases 31 and 38: ``model`` (2 layers at full width, fp32) through
    the ``dtype`` (bf16 or fp16) runner over pools of that dtype, int8 and
    fp8 pools, its kernels (K1's span and decode forms and K2 of that
    dtype; K1-q with 16-bit q) against the same runner's gather path, as
    phases 7 and 25 hold the fp32 runner: chunks of 256, 256, 8, 3, 1 and
    8 decode steps of 1-8 rows; the exact launches, no plain version,
    every call's logits within GATHER_TOL of max|logit|. Returns {pool:
    that share}."""
    n, worst, sfx = model.cfg.num_layers, {}, HALF_SUFFIX[dtype]
    for kind in ("fp32", "int8", "fp8"):
        name = _half_name("ragged_paged_attention", kind, dtype)
        # 16-bit q's decode form walks the 64-page table in 4 splits
        if kind == "fp32":
            want = {name: (5 * n, {"span": 2 * n, "decode_split": 3 * n}),
                    f"paged_decode_attention_{sfx}": (8 * n, {})}
        else:
            want = {name: (13 * n, {"span": 2 * n, "decode_split": 11 * n})}
        log(f"{PHASE_OF[dtype]} {label}: the {sfx} runner against its "
            "gather path")
        worst[sfx if kind == "fp32" else kind] = quant_model_check(
            model, runner_cls, kind, want, gate, GATHER_TOL[dtype],
            chunks=(256, 256, 8, 3, 1), steps=8, rows=tuple(range(1, 9)),
            dtype=dtype)
        _free_the_card()
    return worst


def half_serving_phase(model, cfg, dtype=BF16, max_model_len=4096):
    """Phases 31 and 38: ``model`` (cast to ``dtype``, bf16 or fp16, its
    fp32 weights freed) served through create_serving_engine(dtype=dtype)
    on phase 4's traffic: pools of that dtype at 8 slots (every call
    through its K1 and K2 variants, no other kernel, no plain version,
    every request finished with max_tokens, finite logits); a horizon
    engine (decode_horizon=8, its decode kinds as CUDA graphs) whose
    streams equal the per-step engine's token for token; one-slot runs
    over fp32-rung, int8 and fp8 pools token-exact against naive_generate
    (K1-q with 16-bit q on the 1-byte pools). Returns {kernel: launches} of the
    phase's runs and the per-step engine's launches by form."""
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.serving import SamplingParams

    phase = PHASE_OF[dtype]
    t0 = time.perf_counter()
    eng, launches, _, tokens, prompts, forms = engine_phase(
        model, cfg, dtype=dtype, max_model_len=max_model_len)
    profile_phase(eng, cfg)
    del eng
    _free_the_card()
    # the horizon engine on the same traffic: its streams equal the
    # per-step engine's (the same kernels on the same row counts)
    eng = create_serving_engine(
        model, dtype=dtype, device="cuda", block_size=16, num_blocks=1024,
        max_batch_size=8, max_model_len=max_model_len,
        max_prefill_tokens_per_step=256, audit=True, decode_horizon=8)
    counts = _zeroed_counts()
    m = eng.metrics
    torch.cuda.synchronize()
    t = time.perf_counter()
    ids = [eng.add_request(p, SamplingParams(max_tokens=32))
           for p in prompts]
    outs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    kernel, hforms, plain = _launches(counts)
    got = [outs[i].output_tokens for i in ids]
    log(f"{phase} {HALF_SUFFIX[dtype]} horizon engine (decode_horizon 8, "
        f"graphs): {int(m.tokens_generated.value)} tokens in {wall:.3f} s = "
        f"{m.tokens_generated.value / wall:.1f} tokens/s, "
        f"{int(m.decode_horizon_steps.value)} horizon steps, captures "
        f"{[(c['kind'], round(c['seconds'], 3)) for c in eng.runner.captures]}"
        f"; launches {kernel}, by form {hforms}, plain {plain}; streams equal "
        f"the per-step engine's {got == tokens}")
    if got != tokens or plain or m.nan_logit_events.value or set(
            kernel) != set(_path_kernels("fp32", dtype)):
        raise AssertionError(f"{phase}: the horizon engine parts from "
                             "the per-step engine, left its path or gave "
                             "non-finite logits")
    if not eng.pool.allocator.check_no_leaks():
        raise AssertionError(f"{phase}: the horizon engine leaked pages")
    del eng
    _free_the_card()
    short = sorted(prompts, key=len)[:2]
    single = {}
    for kind in ("fp32", "int8", "fp8"):
        slot_forms = {}
        single[kind] = single_slot_check(model, cfg, kind, short,
                                         dtype=dtype, forms=slot_forms)
        if kind != "fp32":
            # chunks through the span form, decode steps through the split
            # walk (the one-slot engine's 64-page tables: 4 splits)
            name = _half_name("ragged_paged_attention", kind, dtype)
            got = slot_forms.get(name, {})
            log(f"{phase} one-slot {kind} launches by form: {got}")
            if set(got) != {"span", "decode_split"}:
                raise AssertionError(f"{phase}: {name} did not launch the "
                                     f"span form and the split walk: {got}")
            forms[name] = got
        _free_the_card()
    log(f"{phase} ({type(model).__name__}): {time.perf_counter() - t0:.1f}"
        " s")
    path = {n: launches[n] for n in _path_kernels("fp32", dtype)}
    for kind in ("int8", "fp8"):
        path.update(single[kind])
    return path, forms


def ladder_bytes(model, weight_dtype, group=128, dtype=None):
    """The bytes a runner on the weight ladder should hold, from the
    shapes alone: every matmul weight the runner quantizes (the 2-D
    weights but the embeddings) at its rung (int8 codes and an fp32 scale
    an output channel; int4 half a byte an element and an fp32 scale a
    group of rows and output channel; fp8 one byte), every other
    parameter at fp32. With ``dtype`` (fp16: create_serving_engine's cast
    of the whole dict, as the JAX bridge casts it) every floating tensor
    takes that dtype's bytes: the scales and the other parameters, and the
    fp8 weights, which come back in it."""
    fb = 4 if dtype is None else torch.finfo(dtype).bits // 8
    total = 0
    for name, p in model.named_parameters():
        quantized = p.dim() == 2 and not any(
            k in name for k in ("embed", "wte", "wpe"))
        k, n = p.shape[0], p.shape[-1]
        if not quantized:
            total += fb * p.numel()
        elif weight_dtype == "int4":
            total += (k // 2) * n + fb * n * -(-k // group)
        elif weight_dtype == "int8":
            total += p.numel() + fb * n
        else:
            total += (1 if dtype is None else fb) * p.numel()
    return total


def weight_ladder_phase(model, cfg):
    """Phase 32: ``model`` (fp32 compute) with its matmul weights on each
    rung of the ladder, int8, int4 (group 128) and fp8, on phase 4's
    traffic: the engine's tokens/s, decode-step ms and peak memory
    (engine_phase's lines), the runner's weight bytes equal to
    `ladder_bytes` and weight_bytes_reduction_x to the fp32 bytes over
    them; a one-slot engine on the same rung token-exact against
    naive_generate. Returns {rung: reduction factor}."""
    from paddle_tpu_torch.quantization import INT4_GROUP_SIZE

    t0 = time.perf_counter()
    fp32_bytes = sum(4 * p.numel() for p in model.parameters())
    factors = {}
    for wd in ("int8", "int4", "fp8"):
        knobs = dict(weight_dtype=wd, weight_group_size=INT4_GROUP_SIZE)
        # the batch engine's naive_generate report is left out: the
        # one-slot run below gates the same runner against it
        eng, _, _, _, prompts, _ = engine_phase(
            model, cfg, report_naive=False, **knobs)
        got = eng.runner.weight_bytes()
        want = ladder_bytes(model, wd, INT4_GROUP_SIZE)
        factors[wd] = eng.metrics.weight_bytes_reduction_x.value
        log(f"phase 32 {wd} weights: runner {got} bytes, the shapes' "
            f"formula {want}; weight_bytes_reduction_x {factors[wd]:.4f} "
            f"(fp32 {fp32_bytes} / formula = {fp32_bytes / want:.4f})")
        if got != want or abs(factors[wd] - fp32_bytes / want) > 1e-9:
            raise AssertionError(f"phase 32 {wd}: weight bytes {got} != "
                                 f"{want} or the factor disagrees")
        if wd == "int4":    # int8's and fp8's casts: one eager copy each
            profile_phase(eng, cfg, steps=2)
        del eng
        _free_the_card()
        single_slot_check(model, cfg, "fp32", sorted(prompts, key=len)[:2],
                          **knobs)
        _free_the_card()
    log(f"phase 32: {time.perf_counter() - t0:.1f} s")
    return factors


def f16_ladder_phase(model, cfg, prompts):
    """Phase 39 (Llama): ``model`` (cast to fp16) on each rung of the
    weight ladder, int8, int4 (group 128) and fp8, under
    create_serving_engine(dtype=float16), which casts the whole dict as
    the JAX bridge does (scales and fp8 weights come back fp16): the
    runner's bytes equal `ladder_bytes` at fp16, and a one-slot engine on
    ``prompts`` is token-exact against naive_generate through K1-fp16 and
    K2-fp16 alone, with finite logits. The engine runs unaudited: the
    auditor wants fp32 scales and float8 weights, which the cast replaced,
    and refuses the cast ladder in the JAX package as here
    (tests/test_torch_fp16_serving.py). Returns {rung: weight bytes
    reduction}."""
    from paddle_tpu_torch.quantization import INT4_GROUP_SIZE

    t0 = time.perf_counter()
    factors = {}
    for wd in ("int8", "int4", "fp8"):
        weights = {}
        single_slot_check(model, cfg, "fp32", prompts, dtype=F16,
                          weights=weights, weight_dtype=wd,
                          weight_group_size=INT4_GROUP_SIZE, audit=False)
        want = ladder_bytes(model, wd, INT4_GROUP_SIZE, F16)
        factors[wd] = weights["reduction"]
        log(f"phase 39 {wd} weights at fp16: runner {weights['bytes']} "
            f"bytes, the shapes' formula {want}; weight_bytes_reduction_x "
            f"{factors[wd]:.4f}")
        if weights["bytes"] != want:
            raise AssertionError(f"phase 39 {wd}: weight bytes "
                                 f"{weights['bytes']} != {want}")
        _free_the_card()
    log(f"phase 39 ladder: {time.perf_counter() - t0:.1f} s")
    return factors


def f16_generator_check(model, cfg, batch=8, prompt=256, new=32, seed=4,
                        max_len=512):
    """Phase 38 (GPT): PagedGPTGenerator over ``model`` cast to fp16
    (its pools take the dtype of wte.weight, as JAX's): greedy, batch 8,
    must launch K2-fp16 once a layer on every decode step and nothing
    else, no plain version; stepped on its own tokens, its logits are
    finite at every step and within GATHER_TOL[F16] of max|logit| of the
    dense GPTGenerator's at fp16 (the dense cache's attention: another
    rounding order); the two generators' token agreement is reported.
    Returns the K2-fp16 launches."""
    from paddle_tpu_torch.models.generation import (
        GPTGenerator, PagedGPTGenerator,
    )

    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                        (batch, prompt))).to("cuda")
    paged = PagedGPTGenerator(model, max_len=max_len)
    dense = GPTGenerator(model, max_len=max_len)
    paged.generate(ids, max_new_tokens=2, temperature=0.0)   # set-up
    counts = _zeroed_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = paged.generate(ids, max_new_tokens=new, temperature=0.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    kernel, _, plain = _launches(counts)
    want = {"paged_decode_attention_fp16": cfg.num_layers * (new - 1)}
    out_d = dense.generate(ids, max_new_tokens=new, temperature=0.0)

    def stepwise(g):
        state = g._make_state(batch)
        logits, state = g._prefill_call(ids, state)
        steps = [logits]
        for i in range(new - 1):
            logits, state = g._decode_logits_call(out[:, prompt + i], state,
                                                  prompt + i)
            steps.append(logits)
        return steps

    lp, ld = stepwise(paged), stepwise(dense)
    finite = all(bool(torch.isfinite(x).all()) for x in lp)
    rel = max(((a.float() - b.float()).abs().max()
               / b.float().abs().max()).item() for a, b in zip(lp, ld))
    same = int((out[:, prompt:] == out_d[:, prompt:]).sum())
    log(f"phase 38 PagedGPTGenerator at fp16: batch {batch}, prompt "
        f"{prompt}, {new} greedy tokens in {wall:.3f} s "
        f"({1e3 * wall / new:.2f} ms a token step); launches {kernel}, "
        f"plain {plain}; logits finite at every step {finite}; against the "
        f"dense generator at fp16 on the same tokens, worst max|logit diff| "
        f"/ max|logit| {rel:.3e} (gate {GATHER_TOL[F16]:.3e}), greedy "
        f"agreement {same}/{batch * new} (reported)")
    if kernel != want or plain or not finite or not rel <= GATHER_TOL[F16]:
        raise AssertionError(f"phase 38 paged generator: launches {kernel}, "
                             f"want {want}, plain {plain}, finite {finite}, "
                             f"gap to the dense generator {rel:.3e}")
    return want["paged_decode_attention_fp16"]


# phase 39's speculation arm at fp16: the draft arm's streams against the
# off arm's, which run other kernels (verify spans through K1-fp16's
# decode form, single tokens through K2-fp16) on other row counts; a
# parting must sit where two fp16 evaluations of the same logits can swap
# the top two: within twice the gather gate's gap
SPEC_F16_MARGIN = 2 * GATHER_TOL[F16]


def f16_spec_phase(model, cfg):
    """Phase 39 (GPT): speculation on an fp16 target (``model`` cast to
    fp16, create_serving_engine(dtype=float16)) with phase 30's traffic:
    the off arm and the draft_int8 arm (a "shadow" draft: the shadow of an
    fp16 target goes down the ladder, since fp16 is a numpy floating
    type), one round each: the shadow holds int8 codes, proposed and
    accepted > 0, no plain launch, no leak, finite logits; each request's
    stream equals off's but where off's top-2 margin lies within
    SPEC_F16_MARGIN of its max|logit|. Returns the launches by arm."""
    prompts = spec_requests(cfg)
    runs, launches = {}, {}
    arms = dict(SPEC_ARMS)
    for name in ("off", "draft_int8"):
        eng = _spec_engine(model, dict(arms[name], dtype=F16))
        runs[name] = _spec_round(eng, prompts, f"{name} at fp16")
        launches[name] = runs[name]["kernel"]
        if eng.metrics.nan_logit_events.value:
            raise AssertionError(f"phase 39 speculation {name}: non-finite "
                                 "logits")
        if name == "draft_int8":
            draft = eng.proposer.runner
            quantized = len(draft._quantized_names)
            codes = sorted({str(draft.params[n].dtype)
                            for n in draft._quantized_names})
            log(f"phase 39 speculation: the fp16 target's shadow draft has "
                f"{quantized} matrices at {draft.weight_dtype}, codes "
                f"{codes}")
            if not quantized or draft.weight_dtype != "int8" or not (
                    runs[name]["proposed"] and runs[name]["accepted"]):
                raise AssertionError("phase 39 speculation: the shadow of "
                                     "the fp16 target is not int8, or "
                                     "nothing was accepted")
        runner = eng.runner
        del eng
        _free_the_card()
    parted = [_gate_twin(f"phase 39 speculation draft_int8 request {i}",
                         runner, prompts[i], a, b, SPEC_F16_MARGIN)
              for i, (a, b) in enumerate(zip(runs["draft_int8"]["tokens"],
                                             runs["off"]["tokens"]))]
    log(f"phase 39 speculation at fp16: draft_int8 streams against off's "
        f"(token where each parts, None = never): {parted}")
    return launches


def _gate_twin(label, runner, prompt, got, want, tol=None):
    """A tenant's stream against its twin's: equal, or (with ``tol``)
    parting only at a token where the twin's top-2 margin lies within
    ``tol`` of its max|logit|. Returns the token where they part (None)."""
    if got == want:
        return None
    from paddle_tpu_torch.serving import KVCachePool
    j = next((k for k, (x, y) in enumerate(zip(got, want)) if x != y),
             min(len(got), len(want)))
    ctx = list(prompt) + list(want[:j])
    n = -(-len(ctx) // runner.block_size)
    pool = KVCachePool(runner.num_layers, n + 1, runner.block_size,
                       runner.n_kv_heads, runner.head_dim, runner.dtype,
                       device=runner.device, kv_dtype=runner.kv_dtype)
    pool.tag_pages(pool.allocator.alloc(n), pool.native_kv_tag())
    logits = runner.prefill(ctx, list(range(1, n + 1)), pool.shards)[0]
    top2 = torch.topk(logits.float(), 2).values
    margin = (top2[0] - top2[1]).item()
    top = logits.float().abs().max().item()
    log(f"{label}: parts from its twin at token {j}: {got[j:j + 4]} against "
        f"{want[j:j + 4]}; the twin's top-2 margin there {margin:.4e} = "
        f"{margin / top:.3e} of its max|logit|")
    if tol is None or margin > tol * top:
        raise AssertionError(f"{label}: parts from its twin at token {j}")
    return j


def mixed_pool_phase(model, cfg, dtype=None):
    """Phase 33 (phase 39 with ``dtype`` fp16: the runner cast to it, the
    pool storing it): ``model`` on a kv_dtype="mixed" pool with the prefix
    cache on, phase 28's shared-prompt traffic (request 0 first), requests
    tagged fp32 and fp8 in turn: every request finishes; after every step
    no page is mapped by an fp8 and an fp32 tenant at once (the armed
    auditor also holds each tenant's pages to its tag and the device tag
    planes to the host tags); K1 and K2 only (MHA), no plain version; no
    leak once the cache is released. Then one-slot twins on the first
    three requests (fp32, fp8, fp32 tenants, 16 tokens): each tenant's
    stream equals its twin engine's, the fp32 engine's exactly, the
    native fp8 engine's up to MIXED_MARGIN of the runner's dtype. Returns
    the run's launches."""
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.serving import SamplingParams

    t0 = time.perf_counter()
    phase = "phase 33" if dtype is None else "phase 39"
    prompts = prefix_requests(cfg)
    tags = ["fp32", "fp8"] * (len(prompts) // 2)
    eng = create_serving_engine(
        model, dtype=dtype, device="cuda", block_size=16, num_blocks=1024,
        max_batch_size=8, max_model_len=1024,
        max_prefill_tokens_per_step=256, kv_dtype="mixed",
        enable_prefix_cache=True, audit=True)
    m = eng.metrics
    counts = _zeroed_counts()
    shared = 0

    def step():
        nonlocal shared
        eng.step()
        pages = {"fp32": set(), "fp8": set()}
        for req in eng.scheduler.running:
            pages[req.kv.kv_tag].update(req.kv.pages)
        shared += len(pages["fp32"] & pages["fp8"])

    torch.cuda.synchronize()
    t = time.perf_counter()
    ids = [eng.add_request(prompts[0], SamplingParams(max_tokens=32,
                                                      kv_dtype=tags[0]))]
    while m.tokens_generated.value == 0:
        step()
    ids += [eng.add_request(p, SamplingParams(max_tokens=32, kv_dtype=tg))
            for p, tg in zip(prompts[1:], tags[1:])]
    while eng.has_work():
        step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    kernel, forms, plain = _launches(counts)
    outs = eng.outputs()
    ttft = [1e3 * outs[i].ttft_s for i in ids]
    log(f"{phase} mixed pool ({eng.pool.dtype}, prefix cache on, tenants "
        f"{tags}): "
        f"{int(m.tokens_generated.value)} tokens in {wall:.3f} s = "
        f"{m.tokens_generated.value / wall:.1f} tokens/s; TTFT mean "
        f"{statistics.mean(ttft):.1f} ms; prefill tokens computed "
        f"{int(m.prefill_tokens.value)}, prefix_hit_tokens "
        f"{int(m.prefix_hit_tokens.value)}; pages mapped by both rungs "
        f"{shared}; pool {eng.pool.memory_bytes() / 2**30:.3f} GiB "
        f"(kv_bytes_reduction_x {m.kv_bytes_reduction_x.value:.6f}); "
        f"launches {kernel}, by form {forms}, plain {plain}")
    if any(outs[i].finish_reason != "length" for i in ids) \
            or m.nan_logit_events.value:
        raise AssertionError(f"{phase}: not every request finished, or "
                             "logits were not finite")
    if shared or plain or set(kernel) != set(_path_kernels("mixed", dtype)):
        raise AssertionError(f"{phase}: {shared} pages shared across "
                             f"rungs, launches {kernel}, plain {plain}")
    eng.release_prefix_cache()
    if not eng.pool.allocator.check_no_leaks():
        raise AssertionError(f"{phase}: leaked pages")
    run = dict(launches=kernel, forms=forms)
    del eng
    _free_the_card()
    # one-slot twins
    few, sps = prompts[:3], [SamplingParams(max_tokens=16, kv_dtype=t)
                             for t in ("fp32", "fp8", "fp32")]
    streams, runners = {}, {}
    for kind in ("mixed", "fp32", "fp8"):
        eng = create_serving_engine(
            model, dtype=dtype, device="cuda", block_size=16,
            num_blocks=128, max_batch_size=1, max_model_len=1024,
            max_prefill_tokens_per_step=256, kv_dtype=kind,
            enable_prefix_cache=True, audit=True)
        rids = [eng.add_request(p, sp if kind == "mixed"
                                else SamplingParams(max_tokens=16))
                for p, sp in zip(few, sps)]
        outs = eng.run()
        streams[kind] = [outs[r].output_tokens for r in rids]
        runners[kind] = eng.runner
        eng.release_prefix_cache()
        if not eng.pool.allocator.check_no_leaks():
            raise AssertionError(f"{phase} one-slot {kind}: leaked pages")
        del eng
        _free_the_card()
    parted = []
    for i, sp in enumerate(sps):
        twin = sp.kv_dtype
        j = _gate_twin(f"{phase} one-slot {twin} tenant {i}",
                       runners[twin], few[i], streams["mixed"][i],
                       streams[twin][i],
                       MIXED_MARGIN[dtype] if twin == "fp8" else None)
        parted.append(j)
    log(f"{phase} one-slot twins: fp32 tenants equal the fp32 engine, fp8 "
        f"tenants the native fp8 engine (token where each parts, None = "
        f"never: {parted}); {time.perf_counter() - t0:.1f} s")
    return run


# ------------------------------------------------------------ profile

FLASH_GROUPS = {"flash_fwd_bf16_wgmma_kernel": "K3a-bf16 flash_forward_bf16",
                "flash_bwd_dq_bf16_wgmma_kernel":
                    "K3b-dq-bf16 flash_backward_dq_bf16",
                "flash_bwd_dkv_bf16_wgmma_kernel":
                    "K3b-dkv-bf16 flash_backward_dkv_bf16",
                "flash_fwd_bf16_kernel": "K3a-bf16 flash_forward_bf16",
                "flash_bwd_dq_bf16_kernel":
                    "K3b-dq-bf16 flash_backward_dq_bf16",
                "flash_bwd_dkv_bf16_kernel":
                    "K3b-dkv-bf16 flash_backward_dkv_bf16",
                "flash_fwd_f16_wgmma_kernel": "K3a-fp16 flash_forward_fp16",
                "flash_bwd_dq_f16_wgmma_kernel":
                    "K3b-dq-fp16 flash_backward_dq_fp16",
                "flash_bwd_dkv_f16_wgmma_kernel":
                    "K3b-dkv-fp16 flash_backward_dkv_fp16",
                "flash_fwd_f16_kernel": "K3a-fp16 flash_forward_fp16",
                "flash_bwd_dq_f16_kernel":
                    "K3b-dq-fp16 flash_backward_dq_fp16",
                "flash_bwd_dkv_f16_kernel":
                    "K3b-dkv-fp16 flash_backward_dkv_fp16",
                "flash_fwd_kernel": "K3a flash_forward",
                "flash_bwd_dq_kernel": "K3b-dq flash_backward_dq",
                "flash_bwd_dkv_kernel": "K3b-dkv flash_backward_dkv"}


def _kernel_group(name: str) -> str:
    low = name.lower()
    for kernel, group in FLASH_GROUPS.items():
        if kernel in name:
            return group
    if "paged_decode_kernel" in name:
        return "K2 paged_decode_attention"
    if "ragged_span" in name or "ragged_decode" in name:
        return "K1 ragged_paged_attention"
    if ("gemm" in low or "gemv" in low or "cutlass" in low or "xmma" in low
            or "nvjet" in low):
        return "matmul (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other (elementwise, norms, gathers)"


def _device_ms(prof):
    """{group: ms} and the top kernels of the device time the profiler
    recorded."""
    from torch.autograd import DeviceType
    groups, kernels = {}, {}
    for evt in prof.key_averages():
        # record_function ranges also show on the device's timeline; their
        # spans are not kernels and would count the time twice
        if evt.device_type != DeviceType.CUDA or \
                getattr(evt, "is_user_annotation", False):
            continue
        ms = 1e-3 * getattr(evt, "self_device_time_total",
                            getattr(evt, "self_cuda_time_total", 0.0))
        g = _kernel_group(evt.key)
        groups[g] = groups.get(g, 0.0) + ms
        kernels[evt.key] = kernels.get(evt.key, 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:4]
    return groups, top


def profile_phase(eng, cfg, seed=1, n_requests=8, prompt_len=300,
                  steps=4):
    """Where a step's time goes (phases 5, 6, 31 and 32; K1 counting the
    launches of the engine's variant: K1-q's on an int8 / fp8 pool, the
    bf16 variants' on a bf16 runner): torch.profiler over (a) steps that each
    compute one fresh 256-token prefill chunk and nothing else, and (b)
    decode-only steps of 8 sequences. Device time is summed by kernel
    group; the idle share is 1 - device busy / host wall, the wall taken
    from as many unprofiled steps of the same work just before (the
    profiler's own host cost would inflate it)."""
    import paddle_tpu_torch.ops.paged_attention as k2
    import paddle_tpu_torch.ops.ragged_paged_attention as k1
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.serving import SamplingParams

    rng = np.random.default_rng(seed)
    dt = eng.runner.dtype
    c1 = k1.counts_for(dt, eng.pool.shards[0][0][0].dtype)   # K1 or K1-q
    c2 = k2.counts_for(dt)
    what = f"{eng.kv_dtype} KV" + (f", {HALF_SUFFIX[dt]}" if dt in HALF_SUFFIX
                                   else "") \
        + (f", {eng.runner.weight_dtype} weights"
           if eng.runner.weight_dtype != "fp32" else "")

    def add(n, length, max_tokens):
        for _ in range(n):
            eng.add_request(rng.integers(1, cfg.vocab_size, length).tolist(),
                            SamplingParams(max_tokens=max_tokens))

    def timed_ms():
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            eng.step()      # ends in a blocking drain of the step's tokens
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / steps

    def window(label, wall):
        launches = (c1.kernel_launches, c2.kernel_launches)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
        groups, top = _device_ms(prof)
        busy = sum(groups.values()) / steps
        n1 = c1.kernel_launches - launches[0]
        n2 = c2.kernel_launches - launches[1]
        per = {g: round(ms / steps, 4) for g, ms in
               sorted(groups.items(), key=lambda kv: -kv[1])}
        per_launch = {name: round(groups.get(g, 0.0) / n, 4)
                      for name, g, n in (
                          ("K1", "K1 ragged_paged_attention", n1),
                          ("K2", "K2 paged_decode_attention", n2)) if n}
        log(f"profile ({what}) {label}: host wall {wall:.3f} "
            f"ms/step, device busy {busy:.3f} ms/step, idle share {1 - busy / wall:.3f}; K1/K2 "
            f"launches per step {n1 / steps:.0f}/{n2 / steps:.0f}, device "
            f"ms per launch {json.dumps(per_launch)}; device ms/step by "
            f"group {json.dumps(per)}")
        for name, ms in top:
            log(f"  {ms / steps:.4f} ms/step  {name[:110]}")
        if busy == 0.0:
            log("  torch.profiler recorded no device time here: the device "
                "split of this window is not measured")

    # (a) prompts of exactly one budget and one token each: every step
    # prefills one of them in one chunk and finishes it, with no decode
    budget = eng.max_prefill_tokens_per_step
    add(2 * steps, budget, 1)
    window(f"prefill step (one {budget}-token chunk)", timed_ms())
    # (b) a full batch in decode
    add(n_requests, prompt_len, 32)
    while eng.scheduler.waiting or any(
            r.phase == "prefill" for r in eng.scheduler.running):
        eng.step()
    batch = len(eng.scheduler.decode_ready())
    window(f"decode step ({batch} sequences)", timed_ms())
    eng.run()
    if not eng.pool.allocator.check_no_leaks():
        raise AssertionError("engine leaked KV pages in the profile phase")


# ------------------------------------------------------------- flash

# (COUNTS key, replaced TPU kernel) of K3a, K3b-dq and K3b-dkv
FLASH_KERNELS = (
    ("flash_forward", "paddle_tpu/ops/pallas/flash_attention.py:251"),
    ("flash_backward_dq", "paddle_tpu/ops/pallas/flash_attention.py:312"),
    ("flash_backward_dkv", "paddle_tpu/ops/pallas/flash_attention.py:351"),
)
# the kernel function of each 16-bit wrapper by dtype: (mma.sync, wgmma)
HALF_KERNEL_NAMES = {
    dtype: {"flash_forward": (f"flash_fwd_{t}_kernel",
                              f"flash_fwd_{t}_wgmma_kernel"),
            "flash_backward_dq": (f"flash_bwd_dq_{t}_kernel",
                                  f"flash_bwd_dq_{t}_wgmma_kernel"),
            "flash_backward_dkv": (f"flash_bwd_dkv_{t}_kernel",
                                   f"flash_bwd_dkv_{t}_wgmma_kernel")}
    for dtype, t in ((torch.bfloat16, "bf16"), (torch.float16, "f16"))}


def check_flash(gen, b, sq, sk, h, d, causal):
    """K3a/K3b through the autograd.Function and torch.autograd.grad
    against the plain versions; returns each kernel's max abs error."""
    from paddle_tpu_torch.ops import flash_attention as fa
    q = torch.randn(b, sq, h, d, device="cuda", generator=gen,
                    requires_grad=True)
    k, v = (torch.randn(b, sk, h, d, device="cuda", generator=gen,
                        requires_grad=True) for _ in range(2))
    do = torch.randn(b, sq, h, d, device="cuda", generator=gen)
    o = fa.flash_attention(q, k, v, causal=causal)
    grads = torch.autograd.grad(o, (q, k, v), do)
    with torch.no_grad():
        _, lse = fa.flash_forward(q, k, v, causal)
        ro, rlse = fa.flash_forward_reference(q, k, v, causal)
        refs = fa.flash_backward_reference(q, k, v, ro, do, rlse, causal)
    torch.cuda.synchronize()
    err = {"o": (o - ro).abs().max().item(),
           "lse": (lse - rlse).abs().max().item()}
    label = (f"b={b} sq={sq} sk={sk} h={h} d={d} "
             f"{'causal' if causal else 'full'}")
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"flash {label}: {name} is not finite")
        err[name] = (g - r).abs().max().item()
        # one key: the softmax is constant, the exact dq and dk are 0 and
        # both sides are rounding noise, held to dv's scale
        scale = r.abs().max().item()
        if sk == 1:
            scale = max(scale, refs[2].abs().max().item())
        if not err[name] <= TOL * scale:
            raise AssertionError(f"flash {label}: {name} max_abs_err "
                                 f"{err[name]:.3e} > {TOL} * {scale:.3e}")
    if not (err["o"] <= TOL and err["lse"] <= TOL):
        raise AssertionError(f"flash {label}: o/lse max_abs_err "
                             f"{err['o']:.3e}/{err['lse']:.3e} > {TOL}")
    return err


def flash_checks(gen):
    """Phase 9: the trainer's shape, then the sweep; returns the largest
    abs error of each kernel over all cases."""
    cases = [(1, 4096, 4096, 32, 128, True)]
    cases += [(1, s, s, 4, d, c) for d in (64, 128, 256)
              for c in (True, False) for s in (1, 100, 257, 1000)]
    cases += [(1, 128, 384, 4, d, True) for d in (64, 128, 256)]
    cases += [(1, 384, 128, 4, 128, True)]
    worst = {"flash_forward": 0.0, "flash_backward_dq": 0.0,
             "flash_backward_dkv": 0.0}
    for case in cases:
        err = check_flash(gen, *case)
        worst["flash_forward"] = max(worst["flash_forward"], err["o"],
                                     err["lse"])
        worst["flash_backward_dq"] = max(worst["flash_backward_dq"],
                                         err["dq"])
        worst["flash_backward_dkv"] = max(worst["flash_backward_dkv"],
                                          err["dk"], err["dv"])
        if case[1] == 4096:
            log(f"flash check b=1 s=4096 h=32 d=128 causal: max_abs_err "
                + ", ".join(f"{n} {e:.3e}" for n, e in err.items()))
    log(f"flash checks: {len(cases)} cases (the trainer's shape; d in "
        f"64/128/256 x causal/full x s in 1/100/257/1000; sq 128 < sk 384; "
        f"sq 384 > sk 128) within tolerance; worst abs errors "
        + json.dumps({k: float(f"{v:.3e}") for k, v in worst.items()}))
    return worst


def _half_dtype(half):
    """The operand dtype of a flash path: ``half`` is False (fp32), True
    (bf16) or the 16-bit torch dtype itself (bf16 or fp16)."""
    if isinstance(half, torch.dtype):
        return half
    return torch.bfloat16 if half else torch.float32


# the AMP dtypes by name, and each one's suffix in the kernels line
AMP_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
HALF_SUFFIX = {torch.bfloat16: "bf16", torch.float16: "fp16"}


def _flash_counts(masked=False, half=False):
    """{kernel: (kernel launches, plain launches)} of one form: dense or
    masked, fp32, bf16 or fp16 (`_half_dtype`)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    return {name: (c.kernel_launches, c.plain_launches)
            for name, c in fa.counts_for(masked, _half_dtype(half)).items()}


def _variant_launches(label, masked, half, d, total):
    """{kernel: {variant: launches}} of one form, checked: each kernel
    launched `total` times, all through the variant the entry points take
    for its dtype and head dim d (`kernel_variant`: the bf16 and fp16
    forward, dq and dk/dv on wgmma at d <= 128)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    dtype = _half_dtype(half)
    got = {name: dict(c.form_launches)
           for name, c in fa.counts_for(masked, dtype).items()}
    want = {name: {fa.kernel_variant(name, dtype, d): total} for name in got}
    if got != want:
        raise AssertionError(f"{label}: flash launches by variant {got}, "
                             f"not {want}")
    return got


def _other_flash_launches(masked, half) -> int:
    """Every flash launch, kernel or plain, of the forms that are not
    (masked, dtype), plus that form's plain launches."""
    from paddle_tpu_torch.ops import flash_attention as fa
    ran = fa.counts_for(masked, _half_dtype(half))
    return sum(c.plain_launches + (0 if group is ran else c.kernel_launches)
               for group in fa.COUNTS.values() for c in group.values())


# ------------------------------------------------------ masked flash (K3-m)

@contextlib.contextmanager
def _plain_on_card():
    """The flash wrappers' plain branch on CUDA tensors: the plain versions
    run on the card, on the same operands (the checks' reference only)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    on_card = fa.on_card
    fa.on_card = lambda t: False
    try:
        yield
    finally:
        fa.on_card = on_card


def _padded(gen, b, s, lo=0.85):
    """[b, s] int64 attention mask, 1 on each row's first lengths drawn
    from [lo * s, s] (child_ernie's 85-100 % fill)."""
    lens = torch.randint(int(lo * s), s + 1, (b, 1), device="cuda",
                         generator=gen)
    return (torch.arange(s, device="cuda")[None, :] < lens).long()


def check_masked(gen, label, fn, b, sq, sk, h, d, masks=None,
                 dead_rows=None):
    """One masked form: o = fn(q, k, v) and its three gradients through the
    kernels, then through the plain versions on the same operands. o (and,
    with the canonical `masks`, lse) within TOL, each gradient within TOL *
    max|plain gradient|; the rows `dead_rows` (that see no key) exactly 0
    with zero dq. Returns each kernel's max abs error."""
    from paddle_tpu_torch.ops import flash_attention as fa
    q = torch.randn(b, sq, h, d, device="cuda", generator=gen)
    k, v = (torch.randn(b, sk, h, d, device="cuda", generator=gen)
            for _ in range(2))
    do = torch.randn(b, sq, h, d, device="cuda", generator=gen)

    def run():
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        o = fn(qq, kk, vv)
        grads = torch.autograd.grad(o, (qq, kk, vv), do)
        lse = None
        if masks is not None:
            with torch.no_grad():
                lse = fa.flash_forward(q, k, v, masks[0],
                                       **masks[1]._asdict())[1]
        return o.detach(), lse, grads

    before = _flash_counts(masked=True)
    o, lse, grads = run()
    launched = {n: kl - before[n][0]
                for n, (kl, _) in _flash_counts(masked=True).items()}
    with _plain_on_card():
        ro, rlse, refs = run()
    torch.cuda.synchronize()
    if min(launched.values()) == 0:
        raise AssertionError(f"masked flash {label}: a masked kernel did not "
                             f"launch: {launched}")
    err = {"o": (o - ro).abs().max().item(),
           "lse": 0.0 if lse is None else (lse - rlse).abs().max().item()}
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"masked flash {label}: {name} not finite")
        err[name] = (g - r).abs().max().item()
        if not err[name] <= TOL * r.abs().max().item():
            raise AssertionError(
                f"masked flash {label}: {name} max_abs_err {err[name]:.3e} "
                f"> {TOL} * {r.abs().max().item():.3e}")
    if not (err["o"] <= TOL and err["lse"] <= TOL):
        raise AssertionError(f"masked flash {label}: o/lse max_abs_err "
                             f"{err['o']:.3e}/{err['lse']:.3e} > {TOL}")
    if dead_rows is not None and not (bool((o[:, dead_rows] == 0).all())
                                      and bool((grads[0][:, dead_rows] == 0)
                                               .all())):
        raise AssertionError(f"masked flash {label}: rows that see no key "
                             "are not exactly 0 with zero dq")
    log(f"masked flash {label} (b={b} sq={sq} sk={sk} h={h} d={d}): "
        + ", ".join(f"{n} {e:.3e}" for n, e in err.items())
        + ("; dead rows exactly 0, dq 0" if dead_rows is not None else ""))
    return {"flash_forward": max(err["o"], err["lse"]),
            "flash_backward_dq": err["dq"],
            "flash_backward_dkv": max(err["dk"], err["dv"])}


def _csr(b, h, M, gen):
    """sparse_attention's CSR pattern: each row sees a local window of 16
    keys in its own 128-block and two keys drawn from the blocks up to
    its own, so blocks above the diagonal stay dead."""
    rows = []
    for _ in range(b * h):
        for r in range(M):
            blk = r // 128 * 128
            cols = {blk + (r - blk) // 16 * 16 + j for j in range(16)}
            cols |= set(torch.randint(0, blk + 1, (2,), generator=gen,
                                      device=gen.device).tolist())
            rows.append(sorted(cols))
    lens = torch.tensor([len(c) for c in rows]).reshape(b * h, M)
    offset = torch.zeros(b * h, M + 1, dtype=torch.int64)
    offset[:, 1:] = lens.cumsum(1)
    nnz = int(offset[:, -1].max())
    columns = torch.zeros(b * h, nnz, dtype=torch.int64)
    for i in range(b * h):
        flat = [c for cols in rows[i * M:(i + 1) * M] for c in cols]
        columns[i, :len(flat)] = torch.tensor(flat)
    return (offset.reshape(b, h, M + 1).cuda(),
            columns.reshape(b, h, nnz).cuda())


def masked_checks(gen):
    """Phase 10: every masked form through the kernels against the plain
    versions (d 64 and 128, lengths on and off multiples of 64, sq != sk),
    then the entry points over them; returns each kernel's worst error."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import impl
    worst = dict.fromkeys(("flash_forward", "flash_backward_dq",
                           "flash_backward_dkv"), 0.0)

    def form(label, b, sq, sk, h, d, causal, dead_rows=None, **kw):
        def fn(q, k, v):
            return fa.flash_attention(q, k, v, causal=causal, **kw)
        qs = torch.empty(b, sq, h, d, device="cuda")
        ks = torch.empty(b, sk, h, d, device="cuda")
        masks = (causal, fa.canonical_masks(qs, ks, ks, causal, **kw))
        err = check_masked(gen, label, fn, b, sq, sk, h, d, masks, dead_rows)
        for n, e in err.items():
            worst[n] = max(worst[n], e)

    def entry(label, fn, b, sq, h, d):
        err = check_masked(gen, label, fn, b, sq, sq, h, d)
        for n, e in err.items():
            worst[n] = max(worst[n], e)

    att = _padded(gen, 2, 512)
    form("kbias, ERNIE's -1e4 key padding", 2, 512, 512, 12, 64, False,
         mask=(1.0 - att[:, None, None, :].float()) * -1e4)
    form("kbias, bool key padding, causal", 2, 200, 333, 4, 128, True,
         mask=_padded(gen, 2, 333, 0.5)[:, None, None, :].bool())
    m = torch.randn(2, 1, 300, 300, device="cuda", generator=gen) * 2
    m.masked_fill_(torch.rand(m.shape, device="cuda", generator=gen) < 0.3,
                   fa.NEG_INF)
    form("additive mask, mh = 1", 2, 300, 300, 4, 64, False, mask=m)
    m = torch.randn(1, 4, 256, 256, device="cuda", generator=gen)
    m.masked_fill_(torch.rand(m.shape, device="cuda", generator=gen) < 0.3,
                   fa.NEG_INF)
    form("additive mask, mh = h, causal", 1, 256, 256, 4, 128, True, mask=m)
    keep = torch.rand(2, 1, 100, 160, device="cuda", generator=gen) < 0.7
    keep[:, :, 50:] = False
    form("bool mask, rows 50.. see no key", 2, 100, 160, 4, 64, False,
         dead_rows=slice(50, None), mask=keep)
    cuts = torch.randint(1, 384, (2, 3), device="cuda", generator=gen)
    seg = (torch.arange(384, device="cuda")[None, :, None]
           >= cuts.sort(1).values[:, None, :]).sum(-1)
    form("segment ids, causal", 2, 384, 384, 4, 128, True, segment_ids=seg)
    # a dense mask that hides the off-diagonal 128-blocks, and the block
    # mask it implies: skipping those tiles must change nothing
    m = torch.randn(1, 1, 512, 512, device="cuda", generator=gen)
    blocks = torch.eye(4, dtype=torch.int32, device="cuda")
    blocks[3, 0] = 1
    live = fa._block_live(blocks, 512, 512)
    m.masked_fill_(~live, fa.NEG_INF)
    form("block mask implied by a dense mask", 1, 512, 512, 4, 64, False,
         mask=m, block_mask=blocks)

    lens = [100, 257, 64]
    cu = torch.tensor([0, 100, 357, 421], dtype=torch.int32, device="cuda")
    entry(f"flash_attn_unpadded causal, lengths {lens}",
          lambda q, k, v: impl.flash_attn_unpadded(
              q[0], k[0], v[0], cu, cu, causal=True)[None],
          1, sum(lens), 4, 64)
    lo = torch.randint(0, 321, (1, 1, 320, 1), device="cuda", generator=gen)
    hi = torch.maximum(lo, torch.randint(0, 321, lo.shape, device="cuda",
                                         generator=gen))
    entry("flashmask_attention causal (LTS, LTE)",
          lambda q, k, v: impl.flashmask_attention(
              q, k, v, torch.cat([lo, hi], -1).int(), causal=True),
          1, 320, 4, 128)
    entry("flashmask_attention full window (32, 64)",
          lambda q, k, v: impl.flashmask_attention(
              q, k, v, window_size=(32, 64)), 2, 256, 4, 64)
    offset, columns = _csr(1, 4, 256, gen)
    kpm = _padded(gen, 1, 256, 0.7)
    entry("sparse_attention with key_padding_mask",
          lambda q, k, v: impl.sparse_attention(
              q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
              offset, columns, key_padding_mask=kpm).transpose(1, 2),
          1, 256, 4, 64)
    log("masked flash checks: 11 forms within tolerance; worst abs errors "
        + json.dumps({k: float(f"{v:.3e}") for k, v in worst.items()}))
    return worst


def trainer_phase(cfg, seed=0, warmup=2, steps=6, seq=4096, amp_level=None,
                  amp_dtype="bfloat16"):
    """Phases 11, 22 and 36, the training path: TrainStep + AdamW over
    seeded random weights and one seeded batch, fp32 or (amp_level "O1")
    bf16 or fp16 AMP (amp_dtype) through the 16-bit kernels of that
    dtype. Returns the trainer, its batch, the flash launches of the run
    and their split by kernel variant."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import Llama, llama_loss_fn
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Llama(cfg, device="cuda", seed=seed)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    trainer = TrainStep(model, llama_loss_fn, opt, amp_level=amp_level,
                        amp_dtype=amp_dtype)
    half = AMP_DTYPES[amp_dtype] if amp_level else False
    mode = f"{amp_level} {amp_dtype}" if amp_level else "fp32"
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (1, seq + 1), device="cuda",
                         generator=gen)
    ids, labels = toks[:, :-1], toks[:, 1:]
    n_params = sum(p.numel() for p in model.parameters())
    per_layer = sum(p.numel() for p in model.layers[0].parameters())
    n_full = n_params + (32 - cfg.num_layers) * per_layer
    log(f"trainer setup ({mode}): {cfg.num_layers} of 32 "
        f"layers at LLaMA-2-7B "
        f"widths (hidden {cfg.hidden_size}, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads}, ffn {cfg.ffn_hidden}, vocab "
        f"{cfg.vocab_size}), {n_params / 1e9:.3f} B fp32 params "
        f"({per_layer / 1e6:.1f} M per layer; parameters, gradients and "
        f"two AdamW moments {16 * n_params / 1e9:.1f} GB, at 32 layers "
        f"{n_full / 1e9:.2f} B params and {16 * n_full / 1e9:.1f} GB), "
        f"batch [1, {seq}], {time.perf_counter() - t0:.1f} s")

    fa.reset_counts()
    losses = []

    def one_step():
        before = _flash_counts(half=half)
        losses.append(trainer(ids, labels))
        after = _flash_counts(half=half)
        for name in after:
            if after[name][0] - before[name][0] != cfg.num_layers:
                raise AssertionError(
                    f"{name} launched {after[name][0] - before[name][0]} "
                    f"times in a step, not {cfg.num_layers}")

    with _no_dense_attention():
        for _ in range(warmup):
            one_step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            one_step()
        torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t) / steps
    counts = _flash_counts(half=half)
    launches = {name: kl for name, (kl, _) in counts.items()}
    plain = _other_flash_launches(False, half)
    values = [x.float().item() for x in losses]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"trainer losses ({mode}, {losses[0].dtype}): "
        f"{[round(x, 5) for x in values]}")
    log(f"trainer run ({mode}): {warmup} warm-up + {steps} "
        f"timed steps, mean step {step_ms:.1f} ms = "
        f"{seq / step_ms * 1e3:.1f} tokens/s, peak memory {peak:.2f} GiB, "
        f"{HALF_SUFFIX.get(_half_dtype(half), 'fp32')} flash launches "
        f"{launches} "
        f"({cfg.num_layers} each per step), plain versions and other flash "
        f"forms {plain}, dense attention calls 0")
    if not all(np.isfinite(values)) or not values[-1] < values[0]:
        raise AssertionError(f"trainer losses not finite and falling: "
                             f"{values}")
    if plain != 0 or any(n != cfg.num_layers * (warmup + steps)
                         for n in launches.values()):
        raise AssertionError(f"main path missed a flash kernel: "
                             f"{launches}, plain launches {plain}")
    variants = _variant_launches(
        f"trainer ({mode})", False, half,
        cfg.hidden_size // cfg.num_heads, cfg.num_layers * (warmup + steps))
    log(f"trainer flash launches by variant: {json.dumps(variants)}")
    return trainer, (ids, labels), launches, variants


def _optimizer_ms(trainer, batch, steps):
    """(device ms, span ms) of `optimizer.step()` (the clip and AdamW),
    medians over steps run by hand: the forward and backward as TrainStep
    runs them, then, on an idle card, the update alone, once between CUDA
    events (its span on the device's clock, launch gaps included) and once
    under torch.profiler (its kernels' device time)."""
    from torch.profiler import ProfilerActivity, profile
    device, span = [], []
    n = trainer.n_inputs

    def update(profiled):
        loss = trainer.loss_fn(trainer.model(*batch[:n]), *batch[n:])
        loss.backward()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                     ) if profiled else contextlib.nullcontext() as prof:
            start.record()
            trainer.optimizer.step()
            end.record()
            end.synchronize()
        trainer.optimizer.zero_grad(set_to_none=True)
        if profiled:
            device.append(sum(_device_ms(prof)[0].values()))
        else:
            span.append(start.elapsed_time(end))

    for _ in range(steps):
        update(False)
        update(True)
    return statistics.median(device), statistics.median(span)


# the flash groups under their masked names, for a path that runs only the
# masked forms (the CUDA kernels are the same instantiations)
MASKED_GROUPS = {"K3a flash_forward": "K3a-m flash_forward_masked",
                 "K3b-dq flash_backward_dq":
                     "K3b-dq-m flash_backward_dq_masked",
                 "K3b-dkv flash_backward_dkv":
                     "K3b-dkv-m flash_backward_dkv_masked",
                 "K3a-bf16 flash_forward_bf16":
                     "K3a-m-bf16 flash_forward_masked_bf16",
                 "K3b-dq-bf16 flash_backward_dq_bf16":
                     "K3b-dq-m-bf16 flash_backward_dq_masked_bf16",
                 "K3b-dkv-bf16 flash_backward_dkv_bf16":
                     "K3b-dkv-m-bf16 flash_backward_dkv_masked_bf16",
                 "K3a-fp16 flash_forward_fp16":
                     "K3a-m-fp16 flash_forward_masked_fp16",
                 "K3b-dq-fp16 flash_backward_dq_fp16":
                     "K3b-dq-m-fp16 flash_backward_dq_masked_fp16",
                 "K3b-dkv-fp16 flash_backward_dkv_fp16":
                     "K3b-dkv-m-fp16 flash_backward_dkv_masked_fp16"}


def train_profile_phase(trainer, batch, layers, matmul_weights, label,
                        masked=False, steps=2, half=False):
    """Phases 12, 16, 21, 22, 35 and 36: torch.profiler over `steps` training
    steps, device time by kernel group; the optimizer's kernels are
    profiled apart (`_optimizer_ms`) and their time taken out of the
    elementwise group, where they fall by name. The idle share is 1 -
    device busy / host wall of as many unprofiled steps just before.
    `matmul_weights` counts the elements of every weight used as a matmul
    operand (6 FLOPs per element and token)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        trainer(*batch)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer(*batch)
        torch.cuda.synchronize()
    groups, top = _device_ms(prof)
    if masked:
        groups = {MASKED_GROUPS.get(g, g): ms for g, ms in groups.items()}
    opt_device, opt_span = _optimizer_ms(trainer, batch, steps)
    other = "other (elementwise, norms, gathers)"
    groups["optimizer (clip + AdamW)"] = steps * opt_device
    groups[other] = groups.get(other, 0.0) - steps * opt_device
    busy = sum(groups.values()) / steps
    per = {g: round(ms / steps, 3) for g, ms in
           sorted(groups.items(), key=lambda kv: -kv[1])}
    # the flash groups of the path's dtype (`_half_dtype`): kernel names
    # with _bf16_ or _f16_ for the 16-bit forms, neither for fp32
    tag = {torch.bfloat16: "_bf16_", torch.float16: "_f16_"}.get(
        _half_dtype(half))
    flash = list(dict.fromkeys(
        MASKED_GROUPS[g] if masked else g for k, g in FLASH_GROUPS.items()
        if (tag in k if tag else "_bf16_" not in k and "_f16_" not in k)))
    per_launch = {g: round(groups.get(g, 0.0) / (steps * layers), 4)
                  for g in flash}
    tokens = batch[0].numel()
    mm_flops = 6 * tokens * matmul_weights
    mm_ms = groups.get("matmul (cuBLAS)", 0.0) / steps
    log(f"profile {label} step: host wall {wall:.1f} ms/step, device "
        f"busy {busy:.1f} ms/step, idle share {1 - busy / wall:.3f}; "
        f"flash device ms per launch {json.dumps(per_launch)}; device "
        f"ms/step by group {json.dumps(per)}")
    log(f"  optimizer.step() alone: device {opt_device:.3f} ms, span on the "
        f"device's clock {opt_span:.3f} ms (busy {opt_device / opt_span:.3f}"
        f" of it)")
    if mm_ms > 0:
        log(f"  matmuls: {mm_flops / 1e12:.2f} TFLOP per step at "
            f"{mm_flops / mm_ms / 1e9:.1f} TFLOP/s")
    if groups[other] < 0:
        log("  the optimizer's profiled kernels exceed the elementwise group "
            "they were taken from: the split of those two is not measured")
    for name, ms in top:
        log(f"  {ms / steps:.3f} ms/step  {name[:110]}")


def dense_check_phase(cfg, seed=1, seq=1024, gpt=False):
    """Phases 13 and 27 (b): one step's loss and gradients through the
    flash kernels against the dense path, same weights and batch, for a
    Llama or (``gpt``) a GPT."""
    from paddle_tpu_torch.models import GPT, Llama, gpt_loss_fn, llama_loss_fn
    from paddle_tpu_torch.utils.flags import flag, set_flags

    model = (GPT if gpt else Llama)(cfg, device="cuda", seed=seed)
    loss_fn = gpt_loss_fn if gpt else llama_loss_fn
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (1, seq + 1), device="cuda",
                         generator=gen)

    def run(use_flash):
        old = flag("FLAGS_use_flash_attention")
        set_flags({"FLAGS_use_flash_attention": use_flash})
        try:
            loss = loss_fn(model(toks[:, :-1]), toks[:, 1:])
            loss.backward()
        finally:
            set_flags({"FLAGS_use_flash_attention": old})
        grads = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return loss.item(), grads

    before = _flash_counts()
    loss_k, grads_k = run(True)
    mid = _flash_counts()
    loss_d, grads_d = run(False)
    if _flash_counts() != mid or any(
            mid[n][0] - before[n][0] != cfg.num_layers for n in mid):
        raise AssertionError("the kernel run missed a flash kernel or the "
                             "dense run launched one")
    rel = abs(loss_k - loss_d) / abs(loss_d)
    worst = max(((g - grads_d[n]).abs().max()
                 / grads_d[n].abs().max()).item()
                for n, g in grads_k.items())
    log(f"kernels vs dense ({type(model).__name__}, {cfg.num_layers} "
        f"layers, full width, seq {seq}):"
        f" loss {loss_k:.6f} vs {loss_d:.6f} (rel {rel:.2e}), worst grad "
        f"max|diff| / max|grad| {worst:.2e} over {len(grads_k)} params")
    if not (rel <= 1e-5 and worst <= 1e-3):
        raise AssertionError("the kernels' step differs from the dense "
                             "path's beyond 1e-5 (loss) / 1e-3 (grads)")


def visible_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs of one head that attention computes: all of them,
    or under the bottom-right-aligned causal mask the keys j <= i + sk - sq
    of each row i (rows before sq - sk see none)."""
    if not causal:
        return sq * sk
    lo = max(0, sq - sk)                 # the first row that sees a key
    # row i sees i + sk - sq + 1 keys, from lo up to the last row's sk
    return (sq - lo) * (lo + sk - sq + 1 + sk) // 2


def flash_work(b, sq, sk, h, d, causal, kbias=False, elem=4):
    """{kernel: (bytes, FLOPs)}: the least work of K3a, K3b-dq and K3b-dkv
    on q [b, sq, h, d] and k, v [b, sk, h, d]. Each input is read once
    and each output written once (q, k, v, o, do, dq, dk, dv of `elem`
    bytes: 4 fp32, 2 bf16; lse and delta [b, h, sq] and the per-key bias
    [b, sk] where given fp32); FLOPs per visible (query, key) pair of every
    head: 4 d (q.k and p.v), 6 d (q.k, do.v, ds.k), 8 d (q.k, do.v, p^T.do,
    ds^T.q)."""
    pairs = b * h * visible_pairs(sq, sk, causal)
    qrow, krow = elem * b * sq * h * d, elem * b * sk * h * d
    rowv = 4 * b * h * sq
    kb = 4 * b * sk if kbias else 0
    return {"flash_forward": (2 * qrow + 2 * krow + rowv + kb, 4 * d * pairs),
            "flash_backward_dq": (3 * qrow + 2 * krow + 2 * rowv + kb,
                                  6 * d * pairs),
            "flash_backward_dkv": (2 * qrow + 4 * krow + 2 * rowv + kb,
                                   8 * d * pairs)}


def measure_flash(gen, b=1, s=4096, h=32, d=128, causal=True, att=None,
                  dtype=torch.float32):
    """Phases 14, 18 and 20 (b): each flash kernel against its plain
    version, its bound and SDPA. The dense forms at the trainer's shape,
    causal; with ``att`` ([b, s] 0/1), the masked forms at that batch, its
    -1e4 key padding as kbias [b, s] (SDPA: the broadcast float mask, in
    the operands' dtype), non-causal. ``dtype`` bf16 times the bf16
    instantiations on bf16 operands (the plain versions and SDPA on the
    same operands), their bound at 2-byte operands and the dense bf16
    rate; fp16 the same at fp16 (phase 34 (b)).
    The backward pair is held like for like against SDPA's backward alone
    (torch.autograd.grad of a retained graph): the whole flash_backward
    (backward_delta and both kernels) and the two kernels alone. Returns
    {kernel: row} with the pair's times under "pair"."""
    from paddle_tpu_torch.ops import flash_attention as fa
    import torch.nn.functional as F

    if att is not None:
        b, s = att.shape
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                   .to(dtype) for _ in range(4))
    kbias = None if att is None else ((1.0 - att.float()) * -1e4).contiguous()
    m = fa.Masks(kbias=kbias)
    o, lse = fa.flash_forward(q, k, v, causal, kbias=kbias)
    delta = fa.backward_delta(o, do)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    scale = 1.0 / d ** 0.5
    # fp16: dS's factors, plain torch before the launches as delta is
    row_scale, key_scale = (fa.ds_scales(v, do, scale)
                            if dtype == torch.float16 else (None, None))

    def dq_kernel():
        fa.launch_backward_dq(q, k, v, do, lse, delta, dq, causal, scale, m,
                              row_scale)

    def dkv_kernel():
        fa.launch_backward_dkv(q, k, v, do, lse, delta, dk, dv, causal,
                               scale, m, key_scale)

    ms = {"flash_forward": median_ms(lambda: fa.launch_forward(
              q, k, v, o, lse, causal, scale, m)),
          "flash_backward_dq": median_ms(dq_kernel),
          "flash_backward_dkv": median_ms(dkv_kernel)}
    pair_kernels = median_ms(lambda: (dq_kernel(), dkv_kernel()))
    pair_whole = median_ms(lambda: fa.flash_backward(
        q, k, v, o, do, lse, causal, kbias=kbias))
    plain = {
        "flash_forward": median_ms(lambda: fa.flash_forward_reference(
            q, k, v, causal, kbias=kbias), iters=5),
        "flash_backward_dq": median_ms(lambda: fa.flash_backward_dq_reference(
            q, k, v, do, lse, delta, causal, kbias=kbias), iters=5),
        "flash_backward_dkv": median_ms(
            lambda: fa.flash_backward_dkv_reference(
                q, k, v, do, lse, delta, causal, kbias=kbias), iters=5)}
    qT, kT, vT, doT = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    kw = (dict(is_causal=True) if causal
          else dict(attn_mask=None if kbias is None
                    else kbias[:, None, None, :].to(dtype)))
    lib_fwd = median_ms(lambda: F.scaled_dot_product_attention(
        qT, kT, vT, **kw))
    qg, kg, vg = (t.clone().requires_grad_() for t in (qT, kT, vT))
    out = F.scaled_dot_product_attention(qg, kg, vg, **kw)
    lib_bwd = median_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), doT, retain_graph=True))
    del out
    library = {"flash_forward": lib_fwd, "flash_backward_dq": lib_bwd,
               "flash_backward_dkv": lib_bwd}
    half = dtype in HALF_SUFFIX
    work = flash_work(b, s, s, h, d, causal, kbias is not None,
                      elem=2 if half else 4)
    peak = PEAK_BF16_FLOP_PER_S if half else PEAK_FP32_ACCURATE_FLOP_PER_S
    form = "causal" if causal else f"kbias [{b},{s}] full"
    label = (("" if kbias is None else "_masked")
             + (f"_{HALF_SUFFIX[dtype]}" if half else ""))
    log(f"flash work at q/k/v [{b},{s},{h},{d}] {form}: " + ", ".join(
        f"{name} {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP"
        for name, (nbytes, flops) in work.items()))
    rows = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / PEAK_BYTES_PER_S
        t_ops = flops / peak
        rows[name] = dict(ms=ms[name], plain_ms=plain[name],
                          bound_ms=1e3 * max(t_bytes, t_ops),
                          bound_by="bytes" if t_bytes >= t_ops
                          else "operations",
                          library_ms=library[name])
        log(f"timing {name}{label} at q/k/v [{b},{s},{h},{d}] {form}: "
            f"kernel {ms[name]:.4f} ms, plain {plain[name]:.4f} ms, bound "
            f"{rows[name]['bound_ms']:.4f} ms ({rows[name]['bound_by']}, "
            f"{100 * rows[name]['bound_ms'] / ms[name]:.1f} % of it), "
            f"library {library[name]:.4f} ms")
    rows["pair"] = dict(kernels_ms=pair_kernels, flash_backward_ms=pair_whole,
                        library_ms=lib_bwd)
    log(f"backward pair{label} at q/k/v [{b},{s},{h},{d}] {form}, like for "
        f"like: flash_backward (delta + K3b-dq + K3b-dkv) {pair_whole:.4f} "
        f"ms, the two kernels alone {pair_kernels:.4f} ms; SDPA backward "
        f"alone (autograd.grad of a retained graph) {lib_bwd:.4f} ms; "
        f"factor {pair_whole / lib_bwd:.3f} (kernels alone "
        f"{pair_kernels / lib_bwd:.3f}); SDPA forward {lib_fwd:.4f} ms")
    return rows


def check_vs_fp64(gen, b=1, s=4096, h=32, d=128, causal=True, att=None):
    """Phases 14 and 18, first: the kernels at the trainer's (or with
    ``att``, the ERNIE batch's kbias) shape against their plain versions on
    the same operands (o, lse within 1e-4; each gradient within 1e-4 *
    max|plain gradient|), then o, lse, dq, dk and dv against the plain
    versions evaluated once in fp64: the kernels' max error must stay within
    twice the fp32 plain versions' own, the mark of fp32-class products
    (TF32 products would be ~1000 times off). Returns each kernel's max abs
    error against the fp32 plain version, and the forward's larger fp64
    ratio under "fwd_fp64_ratio"."""
    from paddle_tpu_torch.ops import flash_attention as fa

    if att is not None:
        b, s = att.shape
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                   for _ in range(4))
    kbias = None if att is None else ((1.0 - att.float()) * -1e4).contiguous()
    o, lse = fa.flash_forward(q, k, v, causal, kbias=kbias)
    kern = fa.flash_backward(q, k, v, o, do, lse, causal, kbias=kbias)
    ro, rlse = fa.flash_forward_reference(q, k, v, causal, kbias=kbias)
    err = {"flash_forward": max((o - ro).abs().max().item(),
                                (lse - rlse).abs().max().item())}
    del ro, rlse
    plain = fa.flash_backward_reference(q, k, v, o, do, lse, causal,
                                        kbias=kbias)
    form = (f"q/k/v [{b},{s},{h},{d}] "
            + ("causal" if causal else f"kbias [{b},{s}] full"))
    grad_err = {}
    for name, g, r in zip(("dq", "dk", "dv"), kern, plain):
        grad_err[name] = (g - r).abs().max().item()
        if not (torch.isfinite(g).all()
                and grad_err[name] <= TOL * r.abs().max().item()):
            raise AssertionError(f"K3b {name} at {form}: max_abs_err "
                                 f"{grad_err[name]:.3e} > {TOL} * max|plain|")
    if not err["flash_forward"] <= TOL:
        raise AssertionError(f"K3a at {form}: o/lse max_abs_err "
                             f"{err['flash_forward']:.3e} > {TOL}")
    err["flash_backward_dq"] = grad_err["dq"]
    err["flash_backward_dkv"] = max(grad_err["dk"], grad_err["dv"])
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    o64, lse64 = fa.flash_forward_reference(q64, k64, v64, causal,
                                            kbias=kbias)
    exact = fa.flash_backward_reference(q64, k64, v64, o64, do64, lse64,
                                        causal, kbias=kbias)
    ro, rlse = fa.flash_forward_reference(q, k, v, causal, kbias=kbias)
    fwd = {"o": fp64_ratio(o, ro, o64), "lse": fp64_ratio(lse, rlse, lse64)}
    bias = (signed_error(o, o64), signed_error(ro, o64))
    ulps = (ulp_error(lse, lse64), ulp_error(rlse, lse64))
    del o64, lse64, ro, rlse
    log(f"flash forward vs fp64 at {form}: o {fwd['o']:.2f}x, lse "
        f"{fwd['lse']:.2f}x the fp32 plain version's error (lse max error "
        f"kernel {ulps[0]:.2f} ulp, plain {ulps[1]:.2f} ulp); o's mean "
        f"signed error kernel {bias[0]:+.2e}, plain {bias[1]:+.2e}")
    for name, ratio in fwd.items():
        if not ratio <= 2.0:
            raise AssertionError(f"K3a {name} at {form}: error against fp64 "
                                 f"{ratio:.2f}x the fp32 plain version's, "
                                 "above 2x")
    err["fwd_fp64_ratio"] = max(fwd.values())
    parts = []
    for name, g, p, r in zip(("dq", "dk", "dv"), kern, plain, exact):
        e_kernel = (g.double() - r).abs().max().item()
        e_plain = (p.double() - r).abs().max().item()
        parts.append(f"{name} kernel {e_kernel:.3e} plain {e_plain:.3e} "
                     f"({e_kernel / e_plain:.2f}x)")
        if not e_kernel <= 2 * e_plain:
            raise AssertionError(f"K3b {name} at {form}: error against fp64 "
                                 f"{e_kernel:.3e} > 2 x the fp32 plain "
                                 f"version's {e_plain:.3e}")
    log(f"flash kernels vs plain at {form}: max_abs_err " + ", ".join(
        f"{n} {e:.3e}" for n, e in {**err, **grad_err}.items()
        if n != "fwd_fp64_ratio"))
    log(f"flash backward vs fp64 at {form} (max abs error): "
        + "; ".join(parts) + "; each within 2x the fp32 plain version's")
    return err


def lse_stream_check(gen, offset, label, b=1, s=4096, h=32, d=128):
    """F16's other streams: the fp32 K3a forward at the trainer's shape
    (causal) on unit normals drawn from ``gen`` moved to ``offset``, o and
    lse gated as check_vs_fp64 gates them (2x the fp32 plain version's
    error against fp64, no floor), each error printed in ulp too. Returns
    (o ratio, lse ratio)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    gen.set_offset(offset)
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen)
               for _ in range(3))
    o, lse = fa.flash_forward(q, k, v, True)
    ro, rlse = fa.flash_forward_reference(q, k, v, True)
    o64, lse64 = fa.flash_forward_reference(q.double(), k.double(),
                                            v.double(), True)
    ratio = (fp64_ratio(o, ro, o64), fp64_ratio(lse, rlse, lse64))
    ulps = (ulp_error(lse, lse64), ulp_error(rlse, lse64))
    log(f"flash forward vs fp64 on {label}: o {ratio[0]:.3f}x, lse "
        f"{ratio[1]:.3f}x the fp32 plain version's error (lse kernel "
        f"{ulps[0]:.2f} ulp, plain {ulps[1]:.2f} ulp)")
    if not max(ratio) <= 2.0:
        raise AssertionError(f"K3a on {label}: o / lse error against fp64 "
                             f"{ratio[0]:.2f}x / {ratio[1]:.2f}x the fp32 "
                             "plain version's, above 2x")
    return ratio


# ------------------------------------------------- bf16 AMP (K3 at bf16)

# an error against fp64 below this share of max|exact| counts as exact (a
# few fp32 ulp: the fp32 plain version can be exact where the kernel's
# two-term products still round)
FP64_FLOOR = 2.0 ** -21


def _vs_fp64(x, plain, exact):
    """(the kernel's max error against the fp64 evaluation, the plain
    version's, and their ratio with the FP64_FLOOR floor). The floor is
    relative to max|exact| and at least to 1, the operands' scale: where
    every output is a sum that cancels to 0 (dq and dk with one key, dS =
    dP - delta) each fp32 evaluation leaves the noise of its unit-scale
    terms, and the plain version's may be 0 by chance."""
    e_kernel = (x.double() - exact).abs().max().item()
    e_plain = (plain.double() - exact).abs().max().item()
    den = max(e_plain, FP64_FLOOR * max(exact.abs().max().item(), 1.0))
    return e_kernel, e_plain, (e_kernel / den if den > 0 else
                               0.0 if e_kernel == 0 else float("inf"))


# The max error of a bf16 output is its one bf16 rounding, for the kernel
# and the plain version alike, so it cannot see an inner error up to half a
# bf16 ulp. The misround share can: of the outputs the bf16 plain version
# (fp32 throughout) rounds to bf16(exact), the share the kernel rounds to
# another value. The hi + lo products keep P and dS to ~2^-17, which moves
# only outputs that close to a rounding boundary (a few %); one bf16 term
# of P or dS (2^-9) would move about a third. The gate sits between. fp16
# outputs round at 2^-12, so the same share sees inner errors 8x finer.
MISROUND_GATE = 1 / 16
# An output whose exact value is below this (the operands are unit
# normals) is a sum that cancels exactly, as dq of a row that sees one key
# (dS = dP - delta = 0): any fp32 evaluation leaves its own noise there,
# so the share leaves it out.
EXACT_ZERO = 2.0 ** -24


def misround_share(x, plain, exact) -> float:
    """Of the 16-bit outputs (bf16 or fp16, x's dtype) where ``plain``
    equals exact cast to that dtype (torch's cast) and |exact| >
    EXACT_ZERO, the share where ``x`` does not (0 where there are none)."""
    want = exact.to(x.dtype)
    right = (plain == want) & (exact.abs() > EXACT_ZERO)
    n = int(right.sum())
    return int((right & (x != want)).sum()) / n if n else 0.0


# fp16's cast rounds a value to inf from here on (65504 plus half an ulp)
FP16_OVERFLOW = 65520.0
# half an fp16 ulp at the top of its range: within this of FP16_OVERFLOW
# an exact value's fp32 evaluations may round to either side
FP16_OVERFLOW_EDGE = 16.0


def check_half(gen, label, b, sq, sk, h, d, causal, dead_rows=None,
               dtype=torch.bfloat16, do_scale=1.0, v_scale=1.0, **kw):
    """Phases 20 (a) and 34 (a), one case: the 16-bit kernels (K3a,
    K3b-dq, K3b-dkv) on ``dtype`` operands (bf16 or fp16; unit normals, v
    times v_scale and dO times do_scale) with the JAX function's masking
    arguments ``kw``, and the plain versions on the same operands (fp32
    compute, 16-bit outputs), both against the plain versions evaluated
    in fp64: o, lse (rows that see a key), dq, dk and dv within twice the
    plain version's own error, and o, dq, dk and dv misrounded
    (`misround_share`) at most MISROUND_GATE of the time, on the outputs
    both give finite; the kernels' outputs are finite exactly where the
    plain version's are, and equal to its inf elsewhere (fp16's range:
    past 65504 the cast of the fp32 result is inf), but where the exact
    value lies within FP16_OVERFLOW_EDGE of FP16_OVERFLOW. Each kernel
    must launch once, as its instantiation of that dtype, through the
    variant `kernel_variant` names for d (wgmma at d <= 128, mma.sync
    above). Returns ({kernel: fp64 ratio}, {kernel: max abs error vs
    plain}, {kernel: misround share})."""
    from paddle_tpu_torch.ops import flash_attention as fa
    bf = dtype
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                   for s in (sq, sk, sk, sq))
    q, k, v, do = (t.to(bf) for t in (q, k, v * v_scale, do * do_scale))
    if not all(bool(torch.isfinite(t).all()) for t in (q, k, v, do)):
        raise AssertionError(f"{label}: an operand overflows {bf}")
    m = fa.canonical_masks(q, k, v, causal, **kw)
    ops = m._asdict()
    counts = fa.counts_for(m.given(), bf)
    before = {n: (c.kernel_launches, dict(c.form_launches))
              for n, c in counts.items()}
    o, lse = fa.flash_forward(q, k, v, causal, **ops)
    kern = fa.flash_backward(q, k, v, o, do, lse, causal, **ops)
    for n, c in counts.items():
        variant = fa.kernel_variant(n, bf, d)
        if (c.kernel_launches - before[n][0] != 1
                or c.form_launches.get(variant, 0)
                - before[n][1].get(variant, 0) != 1):
            raise AssertionError(
                f"{HALF_SUFFIX[bf]} flash {label}: {n} did not launch once "
                f"through its {variant} kernel: {before[n]} -> "
                f"{c.kernel_launches}, {c.form_launches}")
    ro, rlse = fa.flash_forward_reference(q, k, v, causal, **ops)
    plain = fa.flash_backward_reference(q, k, v, o, do, lse, causal, **ops)
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    o64, lse64 = fa.flash_forward_reference(q64, k64, v64, causal, **ops)
    exact = fa.flash_backward_reference(q64, k64, v64, o64, do64, lse64,
                                        causal, **ops)
    seen = lse64 > fa.MASKED_BELOW
    outs = {"o": (o, ro, o64), "dq": (kern[0], plain[0], exact[0]),
            "dk": (kern[1], plain[1], exact[1]),
            "dv": (kern[2], plain[2], exact[2])}
    if bool(seen.any()):
        outs["lse"] = (lse[seen], rlse[seen], lse64[seen])
    ratio, err, share, parts, failed = {}, {}, {}, [], []
    n_inf = n_edge = 0
    for name, (x, p, e) in outs.items():
        fin_p, fin_x = torch.isfinite(p), torch.isfinite(x)
        # where the exact value lies within half an fp16 ulp of the cast's
        # overflow threshold, either side's fp32 rounding may tip it
        edge = (e.abs() - FP16_OVERFLOW).abs() <= FP16_OVERFLOW_EDGE
        both_inf = ~fin_p & ~fin_x
        if bool(((fin_p != fin_x) & ~edge).any()) or not torch.equal(
                x[both_inf], p[both_inf]):
            raise AssertionError(
                f"{HALF_SUFFIX[bf]} flash {label}: {name} is not finite "
                "exactly where the plain version's is, with its inf there")
        n_inf += int((~fin_p).sum())
        n_edge += int((fin_p != fin_x).sum())
        fin = fin_p & fin_x
        x, p, e = x[fin], p[fin], e[fin]
        e_kernel, e_plain, ratio[name] = _vs_fp64(x, p, e)
        err[name] = (x.float() - p.float()).abs().max().item()
        parts.append(f"{name} {e_kernel:.2e}/{e_plain:.2e} "
                     f"({ratio[name]:.2f}x)")
        if not ratio[name] <= 2.0:
            failed.append(f"{name} error against fp64 {e_kernel:.3e} > 2 x "
                          f"the plain version's {e_plain:.3e}")
        if name != "lse":
            share[name] = misround_share(x, p, e)
            parts[-1] += f" misround {share[name]:.4f}"
            if not share[name] <= MISROUND_GATE:
                failed.append(f"{name} misrounded {share[name]:.4f} > "
                              f"{MISROUND_GATE}")
    scaled = (f", dO x{do_scale:g}, v x{v_scale:g}, {n_inf} inf outputs, "
              f"{n_edge} parted at the overflow edge"
              if (do_scale, v_scale) != (1.0, 1.0) else "")
    line = (f"{HALF_SUFFIX[bf]} flash {label} (b={b} sq={sq} sk={sk} h={h} "
            f"d={d} {'causal' if causal else 'full'}{scaled}) vs fp64, "
            "kernel/plain max error: " + ", ".join(parts))
    if failed:
        raise AssertionError(f"{line}; failed: " + "; ".join(failed))
    if dead_rows is not None and not (bool((o[:, dead_rows] == 0).all())
                                      and bool((kern[0][:, dead_rows] == 0)
                                               .all())):
        raise AssertionError(f"{HALF_SUFFIX[bf]} flash {label}: rows that see "
                             "no key are not exactly 0 with zero dq")
    log(line)
    return tuple({"flash_forward": max(x.get("o", 0.0), x.get("lse", 0.0)),
                  "flash_backward_dq": x["dq"],
                  "flash_backward_dkv": max(x["dk"], x["dv"])}
                 for x in (ratio, err, share))


# phase 34 (a)'s range cases at fp16: (label, dO's factor, v's factor) on
# unit normals. GradScaler's 2^15 on a gradient of 2^-3 with values 4x:
# |dS| passes 65504 (the split's hi term would be inf without the row
# scale) while the outputs stay finite; 2^-18: dO and dS below fp16's
# normal range; values 64x: dq and dk overflow (inf where the plain
# version's cast gives inf)
RANGE_CASES = (("dO x2^15 of 2^-3, v x4", 2.0 ** 12, 4.0),
               ("dO x2^-15 of 2^-3", 2.0 ** -18, 1.0),
               ("overflow: dO x2^15 of 2^-3, v x64", 2.0 ** 12, 64.0))


def half_flash_checks(gen, att, dtype=torch.bfloat16):
    """Phases 20 (a) and 34 (a): the 16-bit kernels of ``dtype`` against
    fp64 at the Llama trainer's shape (causal), at the ERNIE batch's shape
    with its -1e4 key padding (``att``), over d in {64, 128} x causal /
    full x lengths 1, 100, 257, 1000 and 128 / 384 crossed, in every
    masked form of phase 10 and at d = 256; at fp16 also RANGE_CASES at
    d = 64, 128 and 256 (dense, causal, 1000 x 1000; ERNIE's shape and
    padding for the first).
    Returns the worst fp64 ratio, abs error vs plain and misround share of
    each kernel, dense and masked."""
    from paddle_tpu_torch.ops import flash_attention as fa
    names = ("flash_forward", "flash_backward_dq", "flash_backward_dkv")
    worst = {kind: {key: dict.fromkeys(names, 0.0)
                    for key in ("ratio", "err", "misround")}
             for kind in ("dense", "masked")}
    n = 0

    def case(label, *args, **kw):
        nonlocal n
        got = dict(zip(("ratio", "err", "misround"),
                       check_half(gen, label, *args, dtype=dtype, **kw)))
        kind = "masked" if any(kw.get(key) is not None for key in
                               ("mask", "segment_ids", "block_mask")) \
            else "dense"
        for key, vals in got.items():
            for name in names:
                worst[kind][key][name] = max(worst[kind][key][name],
                                             vals[name])
        n += 1
        _free_the_card()

    case("Llama trainer shape", 1, 4096, 4096, 32, 128, True)
    b, s = att.shape
    case("ERNIE batch, -1e4 key padding", b, s, s, 12, 64, False,
         mask=(1.0 - att[:, None, None, :].float()) * -1e4)
    for d in (64, 128):
        for causal in (True, False):
            for sq, sk in ((1, 1), (100, 100), (257, 257), (1000, 1000),
                           (128, 384), (384, 128)):
                case("sweep", 1, sq, sk, 4, d, causal)
    case("bool key padding", 2, 200, 333, 4, 128, True,
         mask=_padded(gen, 2, 333, 0.5)[:, None, None, :].bool())
    m = torch.randn(2, 1, 300, 300, device="cuda", generator=gen) * 2
    m.masked_fill_(torch.rand(m.shape, device="cuda", generator=gen) < 0.3,
                   fa.NEG_INF)
    case("additive mask, mh = 1", 2, 300, 300, 4, 64, False, mask=m)
    m = torch.randn(1, 4, 256, 256, device="cuda", generator=gen)
    m.masked_fill_(torch.rand(m.shape, device="cuda", generator=gen) < 0.3,
                   fa.NEG_INF)
    case("additive mask, mh = h", 1, 256, 256, 4, 128, True, mask=m)
    keep = torch.rand(2, 1, 100, 160, device="cuda", generator=gen) < 0.7
    keep[:, :, 50:] = False
    case("bool mask, rows 50.. see no key", 2, 100, 160, 4, 64, False,
         dead_rows=slice(50, None), mask=keep)
    cuts = torch.randint(1, 384, (2, 3), device="cuda", generator=gen)
    seg = (torch.arange(384, device="cuda")[None, :, None]
           >= cuts.sort(1).values[:, None, :]).sum(-1)
    case("segment ids", 2, 384, 384, 4, 128, True, segment_ids=seg)
    m = torch.randn(1, 1, 512, 512, device="cuda", generator=gen)
    blocks = torch.eye(4, dtype=torch.int32, device="cuda")
    blocks[3, 0] = 1
    m.masked_fill_(~fa._block_live(blocks, 512, 512), fa.NEG_INF)
    case("block mask", 1, 512, 512, 4, 64, False, mask=m,
         block_mask=blocks)
    case("d > 128: the mma.sync kernels", 1, 257, 257, 4, 256, True)
    if dtype == torch.float16:
        for label, do_scale, v_scale in RANGE_CASES:
            for d in (64, 128, 256):
                case(label, 1, 1000, 1000, 4, d, True, do_scale=do_scale,
                     v_scale=v_scale)
        case(RANGE_CASES[0][0] + ", ERNIE batch", b, s, s, 12, 64, False,
             mask=(1.0 - att[:, None, None, :].float()) * -1e4,
             do_scale=RANGE_CASES[0][1], v_scale=RANGE_CASES[0][2])
    log(f"{HALF_SUFFIX[dtype]} flash checks: {n} cases within 2x the plain "
        f"versions' error against fp64, misrounded at most "
        f"{MISROUND_GATE}; worst ratios, abs errors vs plain and misround "
        "shares "
        + json.dumps({kind: {key: {nm: float(f"{x:.3e}") for nm, x in
                                   vals.items()} for key, vals in w.items()}
                      for kind, w in worst.items()}))
    return worst


def o2_phase(cfg, seed=2, seq=1024, steps=4):
    """Phase 23: O2. A Llama at full width after amp.decorate(level="O2"):
    every parameter bf16, AdamW keeping an fp32 master copy of each, and
    after every step each parameter equal bit for bit to its master copy
    cast to bf16; the losses fall; the bf16 kernels launch once per layer
    and step, nothing else."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import Llama, llama_loss_fn
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

    model = Llama(cfg, device="cuda", seed=seed)
    amp.decorate(model, level="O2")
    params = dict(model.named_parameters())
    if any(p.dtype != torch.bfloat16 for p in params.values()):
        raise AssertionError("O2: a decorated parameter is not bf16")
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    trainer = TrainStep(model, llama_loss_fn, opt, amp_level="O2")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (1, seq + 1), device="cuda",
                         generator=gen)
    before = _flash_counts(half=True)
    others = _other_flash_launches(False, True)
    losses = []
    for _ in range(steps):
        losses.append(trainer(toks[:, :-1], toks[:, 1:]).float().item())
        for name, p in params.items():
            master = opt.state[p]["master"]
            if master.dtype != torch.float32 or not torch.equal(
                    p, master.to(torch.bfloat16)):
                raise AssertionError(f"O2: {name} is not its fp32 master "
                                     "copy cast to bf16")
    after = _flash_counts(half=True)
    launched = {n: after[n][0] - before[n][0] for n in after}
    log(f"O2 ({cfg.num_layers} layers, full width, seq {seq}): "
        f"{len(params)} parameters bf16 with fp32 master copies, each equal "
        f"to its master cast to bf16 after every step; losses "
        f"{[round(x, 5) for x in losses]}; bf16 flash launches {launched}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"O2 losses not finite and falling: {losses}")
    if any(n != steps * cfg.num_layers for n in launched.values()) or \
            _other_flash_launches(False, True) != others:
        raise AssertionError(f"O2 missed a bf16 kernel or ran another: "
                             f"{launched}")


def amp_twins_phase(cfg, seed=1, seq=1024, amp_dtype="bfloat16",
                    loss_scale=1.0):
    """Phases 24 and 36 (b): one O1 step of a Llama at full width through
    the bf16 (or, amp_dtype "float16", fp16) kernels against the same step
    on the dense path (FLAGS_use_flash_attention off: 16-bit
    probabilities, where the kernels keep P in fp32) and against the fp32
    step through the fp32 kernels, same weights and batch. Tolerances
    (bf16 operands round at 2^-9, fp16 at 2^-12): the loss within 1e-2
    relative of both twins, every gradient within 5e-2 * max|grad| of the
    dense twin's and 1e-1 * max|grad| of the fp32 twin's. Each backward
    runs from the loss times ``loss_scale`` and its gradients are divided
    by it (a power of two: exact), as GradScaler runs fp16: unscaled, the
    dense fp16 path's own gradients fall below fp16's range (under 2^-24
    they flush). The dense twin's own distance from the fp32 one is
    printed beside."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import Llama, llama_loss_fn
    from paddle_tpu_torch.utils.flags import flag, set_flags

    model = Llama(cfg, device="cuda", seed=seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (1, seq + 1), device="cuda",
                         generator=gen)

    def run(level, use_flash):
        old = flag("FLAGS_use_flash_attention")
        set_flags({"FLAGS_use_flash_attention": use_flash})
        try:
            with (amp.auto_cast(level=level, dtype=amp_dtype) if level
                  else contextlib.nullcontext()):
                logits = model(toks[:, :-1])
            loss = llama_loss_fn(logits, toks[:, 1:])
            (loss * loss_scale).backward()
        finally:
            set_flags({"FLAGS_use_flash_attention": old})
        grads = {n: p.grad / loss_scale for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return loss.float().item(), grads

    half = AMP_DTYPES[amp_dtype]
    before = (_flash_counts(half=half), _flash_counts())
    loss_k, grads_k = run("O1", True)
    mid = (_flash_counts(half=half), _flash_counts())
    loss_d, grads_d = run("O1", False)
    mid2 = (_flash_counts(half=half), _flash_counts())
    loss_f, grads_f = run(None, True)
    after = (_flash_counts(half=half), _flash_counts())
    if any(mid[0][n][0] - before[0][n][0] != cfg.num_layers for n in mid[0]) \
            or mid[1] != before[1] or mid2 != mid or after[0] != mid2[0] \
            or any(after[1][n][0] - mid2[1][n][0] != cfg.num_layers
                   for n in after[1]):
        raise AssertionError(f"O1 twins ({amp_dtype}): the O1 step missed a "
                             "16-bit kernel, the dense step launched one, or "
                             "the fp32 step ran other than the fp32 kernels")

    def worst(grads, of=grads_k):
        return max(((g.float() - grads[n].float()).abs().max()
                    / grads[n].float().abs().max()).item()
                   for n, g in of.items())

    rel_d, rel_f = (abs(loss_k - x) / abs(x) for x in (loss_d, loss_f))
    w_d, w_f, w_df = worst(grads_d), worst(grads_f), worst(grads_f, grads_d)
    log(f"O1 twins ({amp_dtype}, loss scale {loss_scale:g}, "
        f"{cfg.num_layers} layers, full width, seq {seq}): loss kernels "
        f"{loss_k:.6f}, dense {HALF_SUFFIX[half]} {loss_d:.6f} (rel "
        f"{rel_d:.2e}), fp32 {loss_f:.6f} (rel {rel_f:.2e}); worst grad "
        f"max|diff| / max|grad| vs dense {w_d:.2e}, vs fp32 {w_f:.2e} (the "
        f"dense twin vs fp32 {w_df:.2e})")
    if not (rel_d <= 1e-2 and rel_f <= 1e-2 and w_d <= 5e-2
            and w_f <= 1e-1):
        raise AssertionError("the O1 step differs from its twins beyond "
                             "1e-2 (loss), 5e-2 (grads vs dense) or 1e-1 "
                             "(grads vs fp32)")


# -------------------------------------------------------------- ERNIE

def ernie_batch(vocab, batch, seq, seed):
    """bench.py::child_ernie's batch on the card: mask_tokens at 15 % of
    seeded ids, lengths drawn from 85-100 % of seq, labels -100 on pads,
    token types 0, random sentence-order labels."""
    from paddle_tpu_torch.models import mask_tokens
    rng = np.random.default_rng(seed)
    base = rng.integers(5, vocab, (batch, seq))
    ids, labels = mask_tokens(base, vocab, rng)
    lens = rng.integers(int(seq * 0.85), seq + 1, (batch,))
    att = (np.arange(seq)[None, :] < lens[:, None]).astype(np.int64)
    labels = np.where(att > 0, labels, -100)
    types = np.zeros((batch, seq), np.int64)
    sop = rng.integers(0, 2, (batch,))
    return tuple(torch.from_numpy(a).cuda() for a in
                 (ids, types, att, labels, sop))


@contextlib.contextmanager
def _no_dense_attention():
    """Fail on any call of the dense O(s^2) attention path."""
    from paddle_tpu_torch.ops import impl
    dense = impl._dense_attention

    def refuse(*args, **kwargs):
        raise AssertionError("the ERNIE trainer reached the dense attention "
                             "path")
    impl._dense_attention = refuse
    try:
        yield
    finally:
        impl._dense_attention = dense


def ernie_matmul_weights(model) -> int:
    """Elements of every weight used as a matmul operand on all tokens:
    the encoder's linears, the MLM transform and the tied decoder (the
    word embedding); not the position and token-type tables (gathers) or
    the pooler and SOP head (one token per row)."""
    return sum(p.numel() for n, p in model.named_parameters()
               if p.dim() == 2 and "position" not in n and "token_type"
               not in n and "pooler" not in n and "seq_relationship" not in n)


def ernie_trainer_phase(cfg, seed=0, batch=16, seq=512, warmup=2, steps=6,
                        amp_level=None):
    """Phases 15 and 21: ERNIE-3.0-base pretraining at full width and depth
    through jit.TrainStep and AdamW (child_ernie's recipe), fp32 or
    (amp_level "O1", as child_ernie trains) bf16 AMP through the masked
    bf16 kernels. Returns the trainer, its batch, the masked flash
    launches of the run and their split by kernel variant."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import ErnieForPretraining, \
        ernie_pretrain_loss_fn
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = ErnieForPretraining(cfg, device="cuda", seed=seed)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.named_parameters())
    trainer = TrainStep(model, ernie_pretrain_loss_fn, opt, n_inputs=3,
                        amp_level=amp_level)
    half = amp_level is not None
    data = ernie_batch(cfg.vocab_size, batch, seq, seed)
    n_params = sum(p.numel() for p in model.parameters())
    fill = data[2].float().mean().item()
    log(f"ERNIE setup ({amp_level or 'fp32'}): {cfg.num_layers} layers, "
        f"hidden {cfg.hidden_size}, "
        f"heads {cfg.num_heads}, ffn {cfg.ffn_hidden}, vocab "
        f"{cfg.vocab_size}, {n_params / 1e6:.2f} M fp32 params (decoder tied "
        f"to the word embedding; with gradients and two AdamW moments "
        f"{16 * n_params / 1e9:.2f} GB), batch [{batch}, {seq}] at "
        f"{100 * fill:.1f} % fill, {time.perf_counter() - t0:.1f} s")

    fa.reset_counts()
    losses = []

    def one_step():
        before = _flash_counts(masked=True, half=half)
        losses.append(trainer(*data))
        after = _flash_counts(masked=True, half=half)
        for name in after:
            if after[name][0] - before[name][0] != cfg.num_layers:
                raise AssertionError(
                    f"masked {name} launched "
                    f"{after[name][0] - before[name][0]} times in a step, "
                    f"not {cfg.num_layers}")

    with _no_dense_attention():
        for _ in range(warmup):
            one_step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            one_step()
        torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t) / steps
    masked = _flash_counts(masked=True, half=half)
    launches = {name: kl for name, (kl, _) in masked.items()}
    others = _other_flash_launches(True, half)
    values = [x.float().item() for x in losses]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"ERNIE losses ({amp_level or 'fp32'}, {losses[0].dtype}): "
        f"{[round(x, 5) for x in values]}")
    log(f"ERNIE run ({amp_level or 'fp32'}): {warmup} warm-up + {steps} "
        f"timed steps, mean step "
        f"{step_ms:.1f} ms = {batch * seq / step_ms * 1e3:.1f} tokens/s "
        f"({batch * seq} tokens a step, pads included), peak memory "
        f"{peak:.2f} GiB, masked flash launches {launches} "
        f"({cfg.num_layers} each per step), dense flash and plain launches "
        f"{others}, dense attention calls 0")
    if not all(np.isfinite(values)) or not values[-1] < values[0]:
        raise AssertionError(f"ERNIE losses not finite and falling: "
                             f"{values}")
    if others != 0 or any(n != cfg.num_layers * (warmup + steps)
                          for n in launches.values()):
        raise AssertionError(f"the ERNIE path missed a masked kernel or ran "
                             f"another: {launches}, others {others}")
    variants = _variant_launches(
        f"ERNIE ({amp_level or 'fp32'})", True, half,
        cfg.hidden_size // cfg.num_heads, cfg.num_layers * (warmup + steps))
    log(f"ERNIE flash launches by variant: {json.dumps(variants)}")
    return trainer, data, launches, variants


class ScaledStep:
    """One eager fp16 O2 training step with dynamic loss scaling (upstream
    Paddle's fp16 recipe; TrainStep does no loss scaling, as in JAX): the
    forward under auto_cast(level="O2", dtype="float16"), the loss
    outside it, scaler.scale(loss).backward(), scaler.step(optimizer),
    scaler.update(), zero_grad. ``model`` runs the forward under the same
    auto_cast (train_profile_phase times the optimizer apart through it);
    ``skipped`` lists whether each step's gradients were not finite."""

    def __init__(self, model, loss_fn, optimizer, scaler, n_inputs):
        from paddle_tpu_torch import amp
        self.module, self.loss_fn, self.optimizer = model, loss_fn, optimizer
        self.scaler, self.n_inputs, self.skipped = scaler, n_inputs, []
        self._amp = amp

    def model(self, *inputs):
        with self._amp.auto_cast(level="O2", dtype="float16"):
            return self.module(*inputs)

    def __call__(self, *batch):
        loss = self.loss_fn(self.model(*batch[:self.n_inputs]),
                            *batch[self.n_inputs:])
        self.scaler.scale(loss).backward()
        self.scaler.step(self.optimizer)
        self.skipped.append(self.scaler._found_inf)
        self.scaler.update()
        self.optimizer.zero_grad(set_to_none=True)
        return loss.detach()


def ernie_fp16_scaler_phase(cfg, data, seed=0, warmup=2, steps=4):
    """Phase 35: ERNIE-3.0-base pretraining at full width and depth in fp16
    O2 with dynamic loss scaling, as an eager loop (`ScaledStep`):
    amp.decorate(level="O2", dtype="float16") (fp16 parameters, fp32
    master copies in AdamW(1e-4, weight decay 0.01)), GradScaler at its
    defaults (2^15; halved on a non-finite gradient, the step skipped), on
    phase 15's batch ``data``; 2 warm-up and 4 timed steps. Losses finite
    and falling over the steps not skipped; each masked fp16 kernel 12
    times a step through its wgmma kernel (d = 64) and nothing else (no
    bf16 or fp32 flash kernel, plain version or dense attention); from the
    first step taken, every parameter its master's cast to fp16 after
    each warm-up step and after the run. Reports the scale and the
    skipped steps. Returns the stepper, the masked flash
    launches and their split by kernel variant."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import ErnieForPretraining, \
        ernie_pretrain_loss_fn
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW

    f16 = torch.float16
    torch.cuda.reset_peak_memory_stats()
    model = ErnieForPretraining(cfg, device="cuda", seed=seed)
    amp.decorate(model, level="O2", dtype="float16")
    params = dict(model.named_parameters())
    if any(p.dtype != f16 for p in params.values()):
        raise AssertionError("fp16 O2: a decorated parameter is not fp16")
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.named_parameters())
    step = ScaledStep(model, ernie_pretrain_loss_fn, opt, amp.GradScaler(),
                      n_inputs=3)
    fa.reset_counts()
    losses, scales = [], []

    def one_step():
        before = _flash_counts(masked=True, half=f16)
        losses.append(step(*data))
        scales.append(step.scaler.get_scale())
        after = _flash_counts(masked=True, half=f16)
        for name in after:
            if after[name][0] - before[name][0] != cfg.num_layers:
                raise AssertionError(
                    f"fp16 O2 ERNIE: masked {name} launched "
                    f"{after[name][0] - before[name][0]} times in a step, "
                    f"not {cfg.num_layers}")

    def check_masters():
        # the masters exist from the first step taken (a skipped step
        # leaves the optimizer as it was)
        for name, p in params.items():
            st = opt.state.get(p, {})
            if ("master" in st) != (not all(step.skipped)) or (
                    "master" in st
                    and not torch.equal(p, st["master"].to(f16))):
                raise AssertionError(f"fp16 O2 ERNIE: {name} is not its "
                                     "fp32 master copy cast to fp16")

    with _no_dense_attention():
        for _ in range(warmup):
            one_step()
            check_masters()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            one_step()
        torch.cuda.synchronize()
    check_masters()
    step_ms = 1e3 * (time.perf_counter() - t) / steps
    counts = _flash_counts(masked=True, half=f16)
    launches = {name: kl for name, (kl, _) in counts.items()}
    others = _other_flash_launches(True, f16)
    values = [x.float().item() for x in losses]
    kept = [x for x, bad in zip(values, step.skipped) if not bad]
    peak = torch.cuda.max_memory_allocated() / 2**30
    b, s = data[0].shape
    skipped = [i for i, bad in enumerate(step.skipped) if bad]
    log(f"fp16 O2 ERNIE losses ({losses[0].dtype}): "
        f"{[round(x, 5) for x in values]}; loss scale after each step "
        f"{scales}; skipped steps {skipped}")
    log(f"fp16 O2 ERNIE run (GradScaler): {warmup} warm-up + {steps} timed "
        f"steps, mean step {step_ms:.1f} ms = {b * s / step_ms * 1e3:.1f} "
        f"tokens/s ({b * s} tokens a step, pads included), peak memory "
        f"{peak:.2f} GiB, masked fp16 flash launches {launches} "
        f"({cfg.num_layers} each per step), other flash and plain launches "
        f"{others}, dense attention calls 0")
    if not all(np.isfinite(values)) or len(kept) < 2 or \
            not kept[-1] < kept[0]:
        raise AssertionError(f"fp16 O2 ERNIE losses not finite and falling "
                             f"over the steps taken: {values}, skipped "
                             f"{step.skipped}")
    if others != 0 or any(n != cfg.num_layers * (warmup + steps)
                          for n in launches.values()):
        raise AssertionError(f"the fp16 ERNIE path missed a masked kernel "
                             f"or ran another: {launches}, others {others}")
    variants = _variant_launches(
        "fp16 O2 ERNIE", True, f16, cfg.hidden_size // cfg.num_heads,
        cfg.num_layers * (warmup + steps))
    log(f"fp16 O2 ERNIE flash launches by variant: {json.dumps(variants)}")
    return step, launches, variants


def ernie_check_phase(cfg, seed=1, batch=4, seq=512):
    """Phase 17: a 2-layer ERNIE at full width, one step's loss and
    gradients through the masked kernels against the dense path
    (FLAGS_use_flash_attention off), same weights and padded batch; then
    the JAX package's padding invariance through the kernels: outputs at
    real positions do not depend on the pad tokens' ids."""
    from paddle_tpu_torch.models import ErnieForPretraining, \
        ernie_pretrain_loss_fn
    from paddle_tpu_torch.utils.flags import flag, set_flags

    model = ErnieForPretraining(cfg, device="cuda", seed=seed)
    ids, types, att, labels, sop = ernie_batch(cfg.vocab_size, batch, seq,
                                               seed)

    def run(use_flash):
        old = flag("FLAGS_use_flash_attention")
        set_flags({"FLAGS_use_flash_attention": use_flash})
        try:
            loss = ernie_pretrain_loss_fn(model(ids, types, att), labels, sop)
            loss.backward()
        finally:
            set_flags({"FLAGS_use_flash_attention": old})
        grads = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return loss.item(), grads

    before = _flash_counts(masked=True)
    loss_k, grads_k = run(True)
    mid = _flash_counts(masked=True)
    loss_d, grads_d = run(False)
    if _flash_counts(masked=True) != mid or any(
            mid[n][0] - before[n][0] != cfg.num_layers for n in mid):
        raise AssertionError("the ERNIE kernel run missed a masked kernel or "
                             "the dense run launched one")
    rel = abs(loss_k - loss_d) / abs(loss_d)
    worst = max(((g - grads_d[n]).abs().max()
                 / grads_d[n].abs().max()).item()
                for n, g in grads_k.items())
    log(f"ERNIE kernels vs dense ({cfg.num_layers} layers, full width, batch "
        f"[{batch}, {seq}] padded): loss {loss_k:.6f} vs {loss_d:.6f} (rel "
        f"{rel:.2e}), worst grad max|diff| / max|grad| {worst:.2e} over "
        f"{len(grads_k)} params")
    if not (rel <= 1e-5 and worst <= 1e-3):
        raise AssertionError("the ERNIE kernels' step differs from the dense "
                             "path's beyond 1e-5 (loss) / 1e-3 (grads)")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    other = torch.where(att > 0, ids, torch.randint(
        5, cfg.vocab_size, ids.shape, device="cuda", generator=gen))
    model.eval()
    with torch.no_grad():
        outs = [model.ernie(x, token_type_ids=types, attention_mask=att)
                for x in (ids, other)]
    real = att > 0
    diff = max((outs[0][0] - outs[1][0])[real].abs().max().item(),
               (outs[0][1] - outs[1][1]).abs().max().item())
    log(f"ERNIE padding invariance ({int((~real).sum())} pad ids redrawn): "
        f"max|diff| at real positions and pooled {diff:.3e}")
    if not diff <= 2e-5:
        raise AssertionError(f"ERNIE outputs at real positions depend on "
                             f"the pad ids: {diff:.3e} > 2e-5")


# ---------------------------------------------------------------- GPT

def gpt_generator_phase(model, cfg, batch=8, prompt=256, new=32, seed=4,
                        max_len=512):
    """Phase 26: the generators at GPT-3 1.3B. PagedGPTGenerator greedy
    must launch K2 once a layer on every decode step and nothing else; the
    dense GPTGenerator's tokens must equal its tokens, and both stepped on
    the paged run's tokens give logits within TOL * max|logit| of each
    other at every step (the last step's reported; where a token parts,
    the top-2 margin at that step is printed and the run fails). A sampled
    run (seed 7, temperature 0.8, top-k 50, top-p 0.9) must equal, token
    for token, the CPU sampler over the card's logits and keys; a beam run
    (num_beams=4) must launch K2 once a layer a step. The steps run
    eagerly; each generator first generates 2 tokens untimed (the first
    calls' set-up). Returns the K2 launches of the greedy run."""
    import paddle_tpu_torch.models.generation as generation
    from paddle_tpu_torch.models.generation import (
        GPTGenerator, PagedGPTGenerator,
    )

    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                        (batch, prompt))).to("cuda")
    paged = PagedGPTGenerator(model, max_len=max_len)
    dense = GPTGenerator(model, max_len=max_len)
    counts = _all_counts()

    def run(g, **kw):
        for _, c in counts:
            c.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = g.generate(ids, max_new_tokens=new, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        return out, wall, {n: (c.kernel_launches, c.plain_launches)
                           for n, c in counts}

    def prefill_ms(g):
        torch.cuda.synchronize()
        t = time.perf_counter()
        g._prefill_call(ids, g._make_state(batch))
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t)

    def gate_k2(label, launched, rows):
        want = {n: (0, 0) for n, _ in counts}
        want["paged_decode_attention"] = (cfg.num_layers * (new - 1), 0)
        if launched != want:
            raise AssertionError(f"{label}: launches {launched}, not K2 once "
                                 f"a layer on each of {new - 1} decode steps"
                                 f" of {rows} rows and nothing else")

    for g in (paged, dense):        # warm-up: the first calls' set-up
        g.generate(ids, max_new_tokens=2, temperature=0.0)
    torch.cuda.reset_peak_memory_stats()
    out_p, wall_p, launched = run(paged, temperature=0.0)
    gate_k2("PagedGPTGenerator greedy", launched, batch)
    k2_launches = launched["paged_decode_attention"][0]
    pre_p = prefill_ms(paged)
    out_d, wall_d, dense_launched = run(dense, temperature=0.0)
    if any(k or pl for k, pl in dense_launched.values()):
        raise AssertionError(f"GPTGenerator launched a serving kernel: "
                             f"{dense_launched}")
    pre_d = prefill_ms(dense)
    for label, wall, pre in (("PagedGPTGenerator (K2)", wall_p, pre_p),
                             ("GPTGenerator (dense cache)", wall_d, pre_d)):
        log(f"generator {label}: batch {batch}, prompt {prompt}, {new} "
            f"greedy tokens in {wall:.3f} s = {1e3 * wall / new:.2f} ms per "
            f"token step ({batch * new / wall:.1f} tokens/s); prefill alone "
            f"{pre:.1f} ms, decode {1e3 * (wall - pre / 1e3) / (new - 1):.2f}"
            f" ms per step")
    for label, g in (("paged (K2)", paged), ("dense cache", dense)):
        generator_step_trace(g, label, ids, out_p[:, prompt:])

    # both generators stepped on the paged run's tokens
    def stepwise(g):
        state = g._make_state(batch)
        logits, state = g._prefill_call(ids, state)
        out = [logits]
        for i in range(new - 1):
            logits, state = g._decode_logits_call(out_p[:, prompt + i],
                                                  state, prompt + i)
            out.append(logits)
        return out

    lp, ld = stepwise(paged), stepwise(dense)
    rel = [((a - b).abs().max() / b.abs().max()).item()
           for a, b in zip(lp, ld)]
    log(f"generators, paged (K2) vs dense cache on the same tokens: "
        f"max|logit diff| / max|logit| at the last step {rel[-1]:.3e}, "
        f"worst over the {new} steps {max(rel):.3e}")
    parted = (out_p != out_d).nonzero()
    if len(parted):
        row, col = (int(x) for x in parted[0])
        step = col - prompt
        margins = []
        for name, lg in (("paged", lp), ("dense", ld)):
            top = torch.topk(lg[step][row].float(), 2).values
            margins.append(f"{name} {(top[0] - top[1]).item():.3e}")
        raise AssertionError(f"generators: tokens part at row {row}, step "
                             f"{step}; top-2 margins there " +
                             ", ".join(margins))
    if not max(rel) <= TOL:
        raise AssertionError(f"generators: paged logits differ from the "
                             f"dense cache's by {max(rel):.3e} > {TOL}")
    log(f"generators: greedy tokens of the paged and dense generators equal "
        f"({batch} x {new})")

    # a seeded sampled run against the CPU sampler on the card's logits
    orig = generation._sample_shared_key
    draws = []

    def spy(logits, key, temperature, top_k, top_p):
        tok = orig(logits, key, temperature, top_k, top_p)
        draws.append((logits.cpu(), key.cpu(), tok.cpu()))
        return tok

    kw = dict(temperature=0.8, top_k=50, top_p=0.9, seed=7)
    generation._sample_shared_key = spy
    try:
        out_s, wall_s, launched = run(paged, **kw)
    finally:
        generation._sample_shared_key = orig
    gate_k2("PagedGPTGenerator sampled", launched, batch)
    parts = [i for i, (lg, key, tok) in enumerate(draws)
             if not torch.equal(orig(lg, key, 0.8, 50, 0.9), tok)]
    log(f"generator sampled (seed 7, T 0.8, top-k 50, top-p 0.9): {len(draws)}"
        f" draws of [{batch}, {cfg.vocab_size}], {len(parts)} differ from the"
        f" CPU sampler on the card's logits; {1e3 * wall_s / new:.2f} ms per "
        f"token step")
    if parts or len(draws) != new:
        raise AssertionError(f"sampled generator: draws {parts} differ from "
                             "the CPU sampler")
    out_b, wall_b, launched = run(paged, num_beams=4)
    gate_k2("PagedGPTGenerator beams", launched, 4 * batch)
    if tuple(out_b.shape) != (batch, prompt + new) or not torch.equal(
            out_b[:, :prompt], ids):
        raise AssertionError(f"beam run: output {tuple(out_b.shape)}")
    log(f"generator beams (num_beams 4, {4 * batch} rows): {new} tokens in "
        f"{wall_b:.3f} s = {1e3 * wall_b / new:.2f} ms per token step; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return k2_launches


def generator_step_trace(g, label, ids, tokens, steps=4):
    """Where a generator's greedy token step goes: `generate`'s loop body
    (the key's fold_in, then `_decode_call`) for ``steps`` steps after a
    prefill of ``ids``, fed ``tokens`` [b, steps + 1]; timed, then under
    the profiler. Reports host wall and device busy ms a step, the idle
    share, the host-to-device copies and cudaStreamSynchronize calls a
    step (each blocking copy of a host number makes the host wait for the
    stream), the host's op count and self CPU ms a step and its costliest
    ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.core import random as prandom

    prompt = ids.shape[1]

    def body():
        state = g._make_state(ids.shape[0])
        _, state = g._prefill_call(ids, state)
        key = prandom.key(0).to("cuda")
        torch.cuda.synchronize()
        return state, key

    def loop(state, key):
        for i in range(steps):
            key = prandom.fold_in(key, i)
            g._decode_call(tokens[:, i], state, prompt + i, key, 0.0, None,
                           None)
        torch.cuda.synchronize()

    state, key = body()
    t = time.perf_counter()
    loop(state, key)
    wall = 1e3 * (time.perf_counter() - t) / steps
    state, key = body()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loop(state, key)
    groups, top = _device_ms(prof)
    busy = sum(groups.values()) / steps
    h2d = waits = ops = 0
    cpu = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            h2d += evt.count if "HtoD" in evt.key else 0
            continue
        waits += evt.count if evt.key == "cudaStreamSynchronize" else 0
        if evt.key.startswith("aten::"):
            ops += evt.count
        if evt.key != "cudaDeviceSynchronize":   # the loop's own wait
            cpu[evt.key] = 1e-3 * evt.self_cpu_time_total
    per = {k: round(ms / steps, 4) for k, ms in
           sorted(groups.items(), key=lambda kv: -kv[1])}
    log(f"generator step trace, {label}: host wall {wall:.3f} ms a token "
        f"step, device busy {busy:.3f} ms, idle share "
        f"{1 - busy / wall:.3f}; host-to-device copies {h2d / steps:.2f}, "
        f"cudaStreamSynchronize calls {waits / steps:.2f}, aten ops "
        f"{ops / steps:.0f} and self CPU {sum(cpu.values()) / steps:.3f} ms "
        f"(under the profiler) a step; device ms a step by group "
        f"{json.dumps(per)}")
    for name, ms in top:
        log(f"  {ms / steps:.4f} ms/step  {name[:110]}")
    for name, ms in sorted(cpu.items(), key=lambda kv: -kv[1])[:6]:
        log(f"  host {ms / steps:.4f} ms/step  {name[:100]}")
    if busy == 0.0:
        log("  torch.profiler recorded no device time here: the device "
            "split of this window is not measured")


def gpt_trainer_phase(cfg, seed=0, batch=8, seq=1024, warmup=2, steps=4):
    """Phase 27 (a): GPT-3 1.3B at bf16 O1 through TrainStep and AdamW
    under LinearWarmup(CosineAnnealingDecay(2e-4, T_max, eta_min=2e-5),
    2 warm-up steps from 0 to 2e-4), weight decay 0.01, global-norm clip
    1.0, the scheduler stepped after each step. Losses finite and falling;
    the rate each step reads equals the scheduler's; each bf16 flash kernel
    once a layer a step, all through the wgmma kernels (d = 128), nothing
    else. Returns the trainer, its batch and the bf16 flash launches."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPT, gpt_loss_fn
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm, lr

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = GPT(cfg, device="cuda", seed=seed)
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(
        2e-4, T_max=warmup + steps, eta_min=2e-5), 2, 0.0, 2e-4)
    opt = AdamW(learning_rate=sched, weight_decay=0.01,
                parameters=model.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    trainer = TrainStep(model, gpt_loss_fn, opt, amp_level="O1")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1), device="cuda",
                         generator=gen)
    ids, labels = toks[:, :-1], toks[:, 1:]
    n_params = sum(p.numel() for p in model.parameters())
    log(f"GPT trainer setup (O1): GPT-3 1.3B widths at full depth "
        f"({cfg.num_layers} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_heads} heads of "
        f"{cfg.hidden_size // cfg.num_heads}, ffn {cfg.ffn_hidden}, vocab "
        f"{cfg.vocab_size}, tied head), {n_params / 1e9:.3f} B fp32 params, "
        f"batch [{batch}, {seq}], {time.perf_counter() - t0:.1f} s")
    fa.reset_counts()
    losses, rates = [], []

    def one_step():
        before = _flash_counts(half=True)
        want = sched.get_lr()
        losses.append(trainer(ids, labels))
        rates.append((opt.param_groups[0]["lr"], want))
        sched.step()
        after = _flash_counts(half=True)
        for name in after:
            if after[name][0] - before[name][0] != cfg.num_layers:
                raise AssertionError(
                    f"{name} launched {after[name][0] - before[name][0]} "
                    f"times in a step, not {cfg.num_layers}")

    with _no_dense_attention():
        for _ in range(warmup):
            one_step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            one_step()
        torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t) / steps
    launches = {name: kl for name, (kl, _) in
                _flash_counts(half=True).items()}
    plain = _other_flash_launches(False, True)
    values = [x.float().item() for x in losses]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"GPT trainer losses (O1, {losses[0].dtype}): "
        f"{[round(x, 5) for x in values]}; rates read / scheduled "
        f"{[(float(f'{a:.4e}'), float(f'{b:.4e}')) for a, b in rates]}")
    log(f"GPT trainer run (O1): {warmup} warm-up + {steps} timed steps, mean "
        f"step {step_ms:.1f} ms = {batch * seq / step_ms * 1e3:.1f} "
        f"tokens/s, peak memory {peak:.2f} GiB, bf16 flash launches "
        f"{launches} ({cfg.num_layers} each per step), plain versions and "
        f"other flash forms {plain}, dense attention calls 0")
    if not all(np.isfinite(values)) or not values[-1] < values[0]:
        raise AssertionError(f"GPT losses not finite and falling: {values}")
    if any(a != b for a, b in rates) or len({b for _, b in rates}) < 3:
        raise AssertionError(f"GPT trainer: rates read {rates}")
    if plain != 0 or any(n != cfg.num_layers * (warmup + steps)
                         for n in launches.values()):
        raise AssertionError(f"GPT trainer missed a flash kernel: "
                             f"{launches}, plain launches {plain}")
    variants = _variant_launches("GPT trainer (O1)", False, True,
                                 cfg.hidden_size // cfg.num_heads,
                                 cfg.num_layers * (warmup + steps))
    if set(v for d in variants.values() for v in d) != {"wgmma"}:
        raise AssertionError(f"GPT trainer: not all wgmma: {variants}")
    log(f"GPT trainer flash launches by variant: {json.dumps(variants)}")
    return trainer, (ids, labels), launches


def gpt_phases(gen, gen16):
    """Phases 25-27 at GPT-3 1.3B: serving, the generators, O1 training,
    an fp32 2-layer step against the dense path and the bf16 K3 kernels
    at the GPT trainer's shape. Returns {kernel: launches on the GPT
    paths}, the bf16 K3 rows at that shape and {serving kernel: max abs
    error against its plain version at the GPT shapes}. Phases 37-39's
    checks draw from ``gen16``."""
    from paddle_tpu_torch.models import GPT, GPT3_1_3B
    from paddle_tpu_torch.serving import GPTRunner

    cfg = GPT3_1_3B
    model = GPT(cfg, device="cuda", seed=0)
    eng, launches, _, _, prompts, forms = engine_phase(
        model, cfg, max_model_len=cfg.max_seq_len)
    log(f"GPT engine launches by form: {json.dumps(forms)}")
    profile_phase(eng, cfg)
    del eng
    _free_the_card()
    lap("GPT fp32 engine and profile")
    gpt = {"engine": launches}
    for kind in ("int8", "fp8"):
        counts = dict(_all_counts())
        name = f"ragged_paged_attention_{kind}"
        counts[name].reset()
        single_slot_check(model, cfg, kind, sorted(prompts, key=len)[:2])
        gpt[f"single_slot_{kind}"] = {name: counts[name].kernel_launches}
        _free_the_card()
    lap("GPT int8 / fp8 one-slot")
    # K1, K1-q and K2 at the GPT path's shapes (16 heads of 128, n_rep 1)
    # against their plain versions on the same pools: 256-token chunks
    # (K1's span form), chunks of 1-8 rows in the 8-row bucket (its
    # decode form), decode rows (K1-q; K2 over fp32 pools)
    h = cfg.num_heads
    errs = {"paged_decode_attention": check_paged(gen, h, " GPT")}
    for kind in ("fp32", "int8", "fp8"):
        name = "ragged_paged_attention" + ("" if kind == "fp32"
                                           else f"_{kind}")
        errs[name] = max(check_ragged(h, h, gen, f"GPT {label}", kind, spans)
                         for label, spans in (("chunk", SPANS_CHUNK),
                                              ("short chunks", SPANS_SHORT),
                                              ("decode", SPANS_DECODE)))
    # and their bf16 (phase 31) and fp16 (phase 37) variants at the same
    # shapes, 16-bit gates
    for half, pool, g in ((BF16, "bf16", gen), (F16, "fp16", gen16)):
        errs[f"paged_decode_attention_{HALF_SUFFIX[half]}"] = check_paged(
            g, h, " GPT", half=half)[0]
        for kind in (pool, "int8", "fp8"):
            errs[_half_name("ragged_paged_attention", kind, half)] = max(
                check_ragged(h, h, g, f"GPT {label}", kind, spans,
                             half=half)[0]
                for label, spans in (("chunk", SPANS_CHUNK),
                                     ("short chunks", SPANS_SHORT),
                                     ("decode", SPANS_DECODE)))
    lap("serving kernels vs plain, GPT shapes (16-bit variants: phases 31, "
        "37)")
    # then the same through GPTRunner against its gather path: chunks of
    # 256, 256, 8, 3, 1, decode steps of 1-8 rows; at full depth over
    # fp32 pools; over int8 / fp8 at 2 layers as phase 7 (each run
    # quantizes its own K/V, so at full depth the two runs' codes part;
    # that reading is reported beside them, not gated)
    small = GPT(replace(cfg, num_layers=2), device="cuda", seed=2)
    for kind, m, gate in (("fp32", model, True), ("int8", small, True),
                          ("fp8", small, True), ("int8", model, False),
                          ("fp8", model, False)):
        n = m.cfg.num_layers
        if kind == "fp32":
            want = {"ragged_paged_attention": (5 * n, {"span": 2 * n,
                                                       "decode": 3 * n}),
                    "paged_decode_attention": (8 * n, {})}
        else:
            want = {f"ragged_paged_attention_{kind}": (
                13 * n, {"span": 2 * n, "decode": 11 * n})}
        quant_model_check(m, GPTRunner, kind, want, gate,
                          chunks=(256, 256, 8, 3, 1), steps=8,
                          rows=tuple(range(1, 9)))
        _free_the_card()
    lap("GPTRunner vs gather path")
    for dt in (BF16, F16):
        half_twin_check(small, "GPT-3 1.3B width", dt)
        half_gather_check(small, GPTRunner, "GPT-3 1.3B width", dtype=dt)
    del small
    lap("phases 31 and 38 2-layer twin and gather-path checks")
    gpt["paged_generator"] = {
        "paged_decode_attention": gpt_generator_phase(model, cfg)}
    _free_the_card()
    lap("GPT generators")
    t_spec = time.perf_counter()
    # phase 30 at 6 of GPT-3 1.3B's 24 layers (full width): phases 40-41
    # took the smoke ~55 s longer (12 layers) and phases 42-44 ~147 s more
    # (6), and the arms' streams, acceptance and launches by form need no
    # depth
    spec_cfg = replace(cfg, num_layers=6)
    spec_model = GPT(spec_cfg, device="cuda", seed=0)
    gpt["speculation"] = spec_phase(spec_model, spec_cfg)     # phase 30
    del spec_model
    log(f"phase 30: {time.perf_counter() - t_spec:.1f} s")
    _free_the_card()
    lap("phase 30 (its draft_int8 arm: phase 32)")
    # phase 31 at GPT-3 1.3B: the model cast to bf16 in place, phase 25's
    # traffic
    model.to(torch.bfloat16)
    _free_the_card()
    gpt["bf16"], _ = half_serving_phase(model, cfg,
                                        max_model_len=cfg.max_seq_len)
    lap("phase 31 engines")
    # phases 38-39 at GPT-3 1.3B: the model cast to fp16 in place, phase
    # 25's traffic, the paged generator, the speculation arm
    model.to(F16)
    _free_the_card()
    gpt["fp16"], _ = half_serving_phase(model, cfg, F16,
                                        max_model_len=cfg.max_seq_len)
    gpt["paged_generator_fp16"] = {
        "paged_decode_attention_fp16": f16_generator_check(model, cfg)}
    del model
    _free_the_card()
    # phase 39's speculation arm at 12 of the 24 layers (full width):
    # phases 42-44 took the smoke ~147 s longer, and its streams,
    # acceptance and launches need no depth
    spec16_cfg = replace(cfg, num_layers=12)
    spec16 = GPT(spec16_cfg, device="cuda", seed=0).to(F16)
    gpt["speculation_fp16"] = f16_spec_phase(spec16, spec16_cfg)
    del spec16
    _free_the_card()
    lap("phases 38-39 (GPT)")
    trainer, batch, flash = gpt_trainer_phase(cfg)
    gpt["trainer_o1"] = flash
    train_profile_phase(
        trainer, batch, cfg.num_layers,
        sum(p.numel() for n, p in trainer.model.named_parameters()
            if p.dim() == 2 and n != "wpe.weight"), "GPT O1", half=True)
    del trainer, batch
    _free_the_card()
    dense_check_phase(replace(cfg, num_layers=2), gpt=True)
    _free_the_card()
    lap("GPT trainer and dense check")
    b, s, h, d = 8, cfg.max_seq_len, cfg.num_heads, \
        cfg.hidden_size // cfg.num_heads
    ratio, err, share = check_half(gen, "GPT trainer shape", b, s, s, h, d,
                                   True)
    _free_the_card()
    times = measure_flash(gen, b=b, s=s, h=h, d=d, dtype=torch.bfloat16)
    _free_the_card()
    rows = {name: {"shape": f"[{b},{s},{h},{d}] causal", **times[name],
                   "fp64_ratio": ratio[name], "max_abs_err": err[name],
                   "misround": share[name]}
            for name, _ in FLASH_KERNELS}
    log(f"GPT paths' launches: {json.dumps(gpt)}")
    lap("GPT bf16 flash checks and timings")
    return gpt, rows, errs


# ------------------------------------------------ phases 40-41: host tier

# phase 40's engine: LLaMA-2-7B at full width and depth, fp32 pool, a pool
# of 120 pages of 16 (1.9 GiB) that phase 40's 8 requests of 300-600 prompt
# tokens and 64 new tokens cannot hold together (they need 251 pages), so
# admission fills it and decode growth preempts (twice, in a rehearsal at
# a small width); 128 host pages (2 GiB pinned: an fp32 page of 16 tokens
# is 16 MiB over 32 layers) hold the spills
TIER_KNOBS = dict(block_size=16, num_blocks=120, max_batch_size=8,
                  max_model_len=1024, max_prefill_tokens_per_step=256,
                  host_tier_pages=128)


def tier_requests(cfg, seed=40, n=8, max_tokens=64):
    """Phase 40's traffic: n prompts of 300-600 tokens, max_tokens each."""
    from paddle_tpu_torch.serving import SamplingParams
    rng = np.random.default_rng(seed)
    lens = rng.integers(300, 601, n)
    return ([rng.integers(1, cfg.vocab_size, int(m)).tolist()
             for m in lens], SamplingParams(max_tokens=max_tokens))


def page_crc(pool, page) -> int:
    """CRC-32 of one device page read back (every layer's pool arrays, in
    HostKVTier.content_hash's order)."""
    import zlib
    h = 0x9E3779B9
    for layer in pool.read_pages([page]):
        for a in layer:
            h = zlib.crc32(a[0].view(torch.uint8).numpy().tobytes(), h)
    return h


class TierSpy:
    """Phase 40's page check on a live engine: every page a spill copies is
    read back from the device first and its CRC kept by (slot,
    generation); every page a page-in restores is read back after the
    fence, and its CRC must equal the spilled page's and the tier's own
    hash of the host bytes. ``checked`` counts the restored pages held so.
    (The reads synchronise the card: a check, not the engine's path.)"""

    def __init__(self, eng):
        self.eng, self.tier = eng, eng.pool.host_tier
        self.spilled = {}
        self.checked = 0
        spill, fence = self.tier.spill_pages, eng._fence_pagein

        def spill_pages(pages):
            crcs = [page_crc(eng.pool, p) for p in pages]
            slots = spill(pages)
            for s, c in zip(slots, crcs):
                self.spilled[(s, self.tier.generation(s))] = c
            return slots

        def fence_pagein(admitted):
            pairs = [(p, s) for r in admitted for p, s in r.pending_pagein]
            if pairs:
                self.tier.sync()     # the hashes are final once joined
            want = [(p, s, self.spilled.pop((s, self.tier.generation(s))),
                     self.tier._hash[s]) for p, s in pairs]
            fence(admitted)
            for p, s, crc, h in want:
                got = page_crc(eng.pool, p)
                if not got == crc == h:
                    raise AssertionError(
                        f"phase 40: page {p} paged in from host slot {s} "
                        f"reads CRC {got:#x}, spilled {crc:#x}, the tier's "
                        f"hash {h:#x}")
                self.checked += 1

        self.tier.spill_pages = spill_pages
        eng._fence_pagein = fence_pagein


def tier_arm(model, cfg, label, prompts, sp, phase="phase 40", **knobs):
    """One phase 40 arm (or ``phase``'s): the tier engine serves the traffic under the
    auditor (audit_engine after every step: the tier's slot accounting,
    owners, the CRC spot check), through the path's kernels and no plain
    version, with preemptions resumed by page-in and every restored page
    checked by TierSpy. Returns (the engine, its tokens, the run's
    numbers)."""
    from paddle_tpu_torch.inference import create_serving_engine

    kw = {**TIER_KNOBS, **knobs}
    eng = create_serving_engine(model, device="cuda", audit=True, **kw)
    spy = TierSpy(eng)
    counts = _zeroed_counts()
    ids = [eng.add_request(p, sp) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    while eng.has_work():
        eng.step()
        steps += 1
    wall = time.perf_counter() - t0
    kernel, forms, plain = _launches(counts)
    m, tier = eng.metrics.snapshot(), eng.pool.host_tier
    outs = eng.outputs()
    tier.sync()
    run = {k: m[k] for k in ("preemptions", "offload_spill_pages",
                             "pagein_pages", "pagein_hidden_pages",
                             "pagein_hidden_ratio", "offload_resumes",
                             "offload_recompute_fallbacks",
                             "host_tier_drops", "device_idle_fraction",
                             "tokens_generated")}
    run.update(steps=steps, wall_s=wall, pages_checked=spy.checked,
               blocking_joins=tier.blocking_joins,
               sync_spill_reads=tier.sync_spill_reads, launches=kernel,
               by_form=forms)
    log(f"{phase} {label} ({eng.pool.kv_dtype} pool, "
        f"{cfg.num_layers} layers): {json.dumps(run)}")
    path = _path_kernels(eng.pool.kv_dtype)
    if (len(outs) != len(prompts) or any(
            o.finish_reason != "length" for o in outs.values())):
        raise AssertionError(f"{phase} {label}: not every request finished")
    if m["nan_logit_events"]:
        raise AssertionError(f"{phase} {label}: non-finite logits")
    if plain or set(kernel) != set(path):
        raise AssertionError(f"{phase} {label}: launched {kernel}, plain "
                             f"{plain}; the path is {path}")
    if not (m["preemptions"] > 0 and m["offload_resumes"] > 0
            and m["pagein_pages"] > 0):
        raise AssertionError(f"{phase} {label}: no page-in resume: {run}")
    if spy.checked != m["pagein_pages"]:
        raise AssertionError(f"{phase} {label}: {spy.checked} restored "
                             f"pages checked of {m['pagein_pages']}")
    if knobs.get("spill_async") and (tier.blocking_joins
                                     or tier.sync_spill_reads):
        raise AssertionError(f"{phase} {label}: the engine loop waited on "
                             f"a spill: {run}")
    if not eng.pool.allocator.check_no_leaks() or tier.used_count:
        raise AssertionError(f"{phase} {label}: leaked device pages or "
                             "host slots")
    return eng, [outs[i].output_tokens for i in ids], run


def tier_rates(eng, n=32):
    """The tier's copy rates on the card, CUDA events on its side stream:
    n pages gathered, then copied into pinned slots (spill), and staged
    back from them by the engine's _stage_slots (page-in), three times
    each, the median of bytes over each copy's device time; the gather
    itself is not timed."""
    pool, tier = eng.pool, eng.pool.host_tier
    pages = pool.allocator.alloc(n)
    slots = tier._free[:n]
    gathered = [tuple(a.view(torch.uint8) for a in layer)
                for layer in pool.gather_pages(pages)]
    nbytes = n * pool.page_bytes()
    rates = {"spill": [], "pagein": []}
    staged = None
    torch.cuda.synchronize()
    for name in ("spill", "pagein") * 3:
        # the last page-in's tensors go back to the allocator first, so a
        # timed page-in allocates from its cache and not from the driver
        staged = None
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(tier._stream)
        if name == "spill":
            with tier.stream():
                tier._copy_runs(slots, gathered)
        else:
            staged = eng._stage_slots(tier, slots)    # the engine's path
        end.record(tier._stream)
        end.synchronize()
        rates[name].append(nbytes / (start.elapsed_time(end) * 1e-3) / 1e9)
    del staged, gathered
    pool.allocator.free(pages)
    return {name: statistics.median(r) for name, r in rates.items()}


def resume_device_ms(eng, prompt):
    """The device ms of resuming one request of ``prompt`` tokens by
    recompute (its context prefilled in the engine's 256-token chunks)
    against by page-in (its pages staged from the tier and scattered, the
    engine's _stage_slots and write_pages), CUDA events on the compute
    stream (which waits for the page-in's copies)."""
    pool, runner, tier = eng.pool, eng.runner, eng.pool.host_tier
    pages = pool.allocator.alloc(pool.blocks_for_tokens(len(prompt)))
    table = pool.pad_table(pages, eng.max_pages_per_seq)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for c in range(0, len(prompt), 256):
        runner.prefill_chunk(prompt[c:c + 256], c, table, pool.shards)
    end.record()
    end.synchronize()
    recompute = start.elapsed_time(end)
    slots = tier.spill_pages(pages)
    tier.sync()
    torch.cuda.synchronize()
    start.record()
    staged = list(eng._stage_slots(tier, slots).values())
    compute = torch.cuda.current_stream()
    for _, ev in staged:
        compute.wait_event(ev)
    pool.write_pages(pages, [tuple(torch.stack([d[li][j] for d, _ in staged])
                                   for j in range(len(layer)))
                             for li, layer in enumerate(pool.pools)])
    end.record()
    end.synchronize()
    pagein = start.elapsed_time(end)
    tier.free_slots(slots)
    pool.allocator.free(pages)
    return recompute, pagein


def host_tier_phase(model, cfg, int8_model, int8_cfg):
    """Phase 40: the host KV tier at LLaMA-2-7B (full width and depth, fp32
    pool, random weights), TIER_KNOBS, phase 40's traffic: a serial arm
    with sync spills, then spill_async=True with pipelined=True; each arm
    under tier_arm's gates (every restored page's CRC against its spilled
    page's and the tier's hash, offload_resumes > 0, no leak, the
    auditor after every step; the async arm's loop never waiting on a
    spill). Tokens: two resumed requests of the serial arm token-exact
    against naive_generate (the fp32 rule of engine_phase), the async
    pipelined arm's streams equal the serial arm's. Then an int8 pool at
    ``int8_cfg``'s depth (codes and scale rows through the same page
    check), the tier's copy rates, a page-in resume against a recompute
    resume of one request (device ms), each arm's idle share. Returns the
    numbers, the serial arm's tokens and prompts, and its runner."""
    from paddle_tpu_torch.serving import naive_generate

    t0 = time.perf_counter()
    prompts, sp = tier_requests(cfg)
    eng, tokens, serial = tier_arm(model, cfg, "serial, sync spill",
                                   prompts, sp)
    runner = eng.runner
    resumed = [i for i, r in enumerate(eng._requests.values())
               if r.num_preemptions][:2]
    for i in resumed:
        ref = naive_generate(runner, prompts[i], sp, max_model_len=1024)
        _gate_streams(f"phase 40 request {i} (resumed) vs naive_generate",
                      runner, [prompts[i]], [tokens[i]], [ref])
    log(f"phase 40: resumed requests {resumed} token-exact against "
        "naive_generate")
    rates = tier_rates(eng)
    ms = resume_device_ms(eng, prompts[int(np.argmax(list(map(len,
                                                              prompts))))])
    del eng
    _free_the_card()
    aeng, atokens, pipelined = tier_arm(model, cfg,
                                        "spill_async, pipelined", prompts,
                                        sp, spill_async=True, pipelined=True)
    del aeng
    _free_the_card()
    _gate_streams("phase 40 async pipelined arm vs the serial arm",
                  runner, prompts, atokens, tokens)
    qeng, _, int8 = tier_arm(int8_model, int8_cfg, "int8 pool", prompts,
                             sp, kv_dtype="int8")
    del qeng
    _free_the_card()
    out = {"serial": serial, "async_pipelined": pipelined, "int8": int8,
           "spill_GBps": rates["spill"], "pagein_GBps": rates["pagein"],
           "resume_recompute_ms": ms[0], "resume_pagein_ms": ms[1],
           "resume_speedup_x": ms[0] / ms[1],
           "seconds": time.perf_counter() - t0}
    log(f"phase 40: spill {rates['spill']:.2f} GB/s, page-in "
        f"{rates['pagein']:.2f} GB/s (pinned, the tier's side stream); "
        f"pagein_hidden_ratio serial {serial['pagein_hidden_ratio']:.3f}, "
        f"async pipelined {pipelined['pagein_hidden_ratio']:.3f}; resume of "
        f"a {max(map(len, prompts))}-token request: recompute {ms[0]:.3f} "
        f"device ms, page-in {ms[1]:.3f} device ms ({ms[0] / ms[1]:.2f}x); "
        f"idle share serial {serial['device_idle_fraction']:.3f}, async "
        f"pipelined {pipelined['device_idle_fraction']:.3f}; "
        f"{out['seconds']:.1f} s")
    return out, tokens, prompts, runner


class ByteVocab:
    """A byte-level vocabulary built here (phase 41): each id's raw bytes
    are a 3-byte CJK character, its lead byte, its two continuation bytes
    or an ASCII letter, so multi-byte characters split across tokens; the
    tokenizer spells them HF-style, over GPT-2's bytes_to_unicode alphabet
    (`convert_ids_to_tokens`), which TokenizerAdapter inverts."""

    def __init__(self, vocab):
        from paddle_tpu_torch.serving.detokenize import _byte_decoder
        alphabet = {b: c for c, b in _byte_decoder().items()}
        self.raw = []
        for i in range(vocab):
            ch = chr(0x4E00 + (i * 7919) % 20000).encode()
            self.raw.append((ch, ch[:1], ch[1:],
                             bytes([0x41 + i % 26]))[i % 4])
        self.pieces = ["".join(alphabet[b] for b in r) for r in self.raw]

    def convert_ids_to_tokens(self, tok):
        return self.pieces[int(tok)]

    def text(self, tokens) -> str:
        return b"".join(self.raw[t] for t in tokens).decode("utf-8",
                                                            "replace")


def snapshot_phase(model, cfg, tokens, prompts, runner):
    """Phase 41: phase 40's serial engine run again to a state with a
    preempted waiter and a running request, snapshotted, the snapshot
    through json, restored on a fresh engine through
    inference.restore_serving_engine (a fresh runner of the same model,
    the recorded knobs, the tier's pages not carried), finished: every
    stream equal to phase 40's uninterrupted serial run. stream_text over
    ByteVocab (a TokenizerAdapter) after every step only appends, and the
    final text of every request equals the whole decode of its tokens."""
    from paddle_tpu_torch.inference import (
        create_serving_engine, restore_serving_engine,
    )

    t0 = time.perf_counter()
    _, sp = tier_requests(cfg)
    eng = create_serving_engine(model, device="cuda", audit=True,
                                **TIER_KNOBS)
    ids = [eng.add_request(p, sp) for p in prompts]
    state = None
    for _ in range(400):
        eng.step()
        if (any(r.num_preemptions for r in eng.scheduler.waiting)
                and eng.scheduler.running):
            state = eng.snapshot()
            break
    if state is None:
        raise AssertionError("phase 41: never a preempted waiter beside a "
                             "running request")
    state = json.loads(json.dumps(state))
    shape = {"running": len(eng.scheduler.running),
             "waiting": len(eng.scheduler.waiting),
             "preempted": sum(r["num_preemptions"] > 0
                              for r in state["requests"]),
             "finished": len(state["finished"]),
             "bytes": len(json.dumps(state))}
    del eng
    _free_the_card()
    vocab = ByteVocab(cfg.vocab_size)
    restored = restore_serving_engine(model, state, device="cuda",
                                      audit=True, tokenizer=vocab)
    if restored.pool.host_tier is None or restored.pool.host_tier.used_count:
        raise AssertionError("phase 41: the restored tier is missing or "
                             "holds pages")
    seen = {rid: "" for rid in ids}
    while restored.has_work():
        restored.step()
        for rid in ids:
            text = restored.stream_text(rid)
            if not text.startswith(seen[rid]):
                raise AssertionError(f"phase 41: stream_text of {rid} "
                                     "rewrote its text")
            seen[rid] = text
    outs = restored.outputs()
    got = [outs[rid].output_tokens for rid in ids]
    _gate_streams("phase 41 restored run vs phase 40's uninterrupted run",
                  runner, prompts, got, tokens)
    for rid, toks in zip(ids, got):
        if restored.stream_text(rid) != vocab.text(toks):
            raise AssertionError(f"phase 41: stream_text of {rid} is not "
                                 "the decode of its tokens")
    if not restored.pool.allocator.check_no_leaks():
        raise AssertionError("phase 41: the restored engine leaked pages")
    shape["seconds"] = time.perf_counter() - t0
    log(f"phase 41: snapshot at {json.dumps(shape)}; the restored run's "
        f"{len(ids)} streams equal the uninterrupted run's, stream_text "
        f"equals each stream's decode ({sum(map(len, seen.values()))} "
        f"characters); {shape['seconds']:.1f} s")
    return shape


# ------------------------------------------ the serving tier (42-44)

# phases 42-44's tier: every replica's engine (fp32 pools of 16-token
# pages, the prefix cache, 8-step decode horizons, a 256-token prefill
# budget); the host tier of 64 pages carries a drain's migrations
ROUTER_KNOBS = dict(block_size=16, num_blocks=400, max_batch_size=8,
                    max_model_len=1024, max_prefill_tokens_per_step=256,
                    enable_prefix_cache=True, decode_horizon=8,
                    host_tier_pages=64)


def router_requests(cfg, seed=42, tenants=4, n=16, prefix=256,
                    max_tokens=32):
    """Phase 42's traffic: n greedy requests from ``tenants`` tenants, each
    tenant's prompts sharing a ``prefix``-token header, 300-600 tokens in
    all, max_tokens each; requests 0 and 1 (tenants 0 and 1) carry the
    session ids of a chat that sends a second turn."""
    from paddle_tpu_torch.serving import SamplingParams
    rng = np.random.default_rng(seed)
    heads = [rng.integers(1, cfg.vocab_size, prefix).tolist()
             for _ in range(tenants)]
    reqs = []
    for i in range(n):
        tail = rng.integers(1, cfg.vocab_size,
                            int(rng.integers(300, 601)) - prefix).tolist()
        reqs.append((f"q{i}", heads[i % tenants] + tail, SamplingParams(
            max_tokens=max_tokens,
            session_id=f"chat-{i}" if i < 2 else None)))
    return reqs


def second_turns(cfg, reqs, outs, seed=43, new=16):
    """The two chats' second turns: the first turn's prompt, its reply
    and ``new`` fresh tokens, under the same session id."""
    rng = np.random.default_rng(seed)
    return [(f"t{rid[1:]}", p + outs[rid] + rng.integers(
        1, cfg.vocab_size, new).tolist(), sp)
        for rid, p, sp in reqs if sp.session_id is not None]


class StepClock:
    """The longest engine step and graph capture a tier's replicas took
    (host clock), for the heartbeat: each live engine's step is timed."""

    def __init__(self):
        self.longest = 0.0

    def watch(self, router):
        for rep in router._replicas:
            eng = rep.engine
            if getattr(eng, "_timed", False):
                continue
            step = eng.step

            def timed(step=step):
                t = time.perf_counter()
                try:
                    return step()
                finally:
                    self.longest = max(self.longest, time.perf_counter() - t)
            eng.step, eng._timed = timed, True

    @staticmethod
    def longest_capture(router) -> float:
        return max((c["seconds"] for rep in router._replicas
                    for c in getattr(rep.engine.runner, "captures", ())),
                   default=0.0)


def submit_waves(router, reqs, first_wave=4, timeout_s=600.0):
    """Submit (request id, prompt, sampling) triples in two waves: the first
    ``first_wave`` (one a tenant), then the rest once each of those has its
    first token (its header's pages are registered, so a later request can
    hit them)."""
    for k, (rid, p, sp) in enumerate(reqs):
        if k == first_wave:
            deadline = time.perf_counter() + timeout_s
            while time.perf_counter() < deadline:
                with router._lock:
                    if all(router._reqs[r].tokens
                           for r, _, _ in reqs[:first_wave]):
                        break
                time.sleep(0.002)
        router.submit(p, sp, request_id=rid)


def serve_tier(router, reqs, label, timeout_s=600.0, during=None):
    """Submit the triples in `submit_waves`' two waves, run ``during`` (if
    given) while they are served, drain; returns {request id: tokens}."""
    submit_waves(router, reqs, timeout_s=timeout_s)
    if during is not None:
        during()
    outs = router.drain(timeout_s=timeout_s)
    got = {rid: outs[rid].output_tokens for rid, _, _ in reqs}
    for rid, _, sp in reqs:
        o = outs[rid]
        if o.finish_reason != "length" or len(o.output_tokens) != \
                sp.max_tokens:
            raise AssertionError(f"{label}: {rid} ended {o.finish_reason} "
                                 f"with {len(o.output_tokens)} tokens")
    return got


def gate_tier(router, label, counts, kv_dtype="fp32", crashes=0, hangs=0,
              restarts=0):
    """A tier arm's gates: the auditor over every live replica and the
    registry, no leaked page once the caches release, only the path's
    kernels (no plain version), the crash / hang / restart counts the
    arm expects, no token delivered twice, and no stream left capturing.
    Returns the arm's numbers."""
    from paddle_tpu_torch.serving import audit_router
    from paddle_tpu_torch.serving.model_runner import _capture_stream
    audit_router(router)
    kernel, forms, plain = _launches(counts)
    path = _path_kernels(kv_dtype)
    if plain or set(kernel) != set(path):
        raise AssertionError(f"{label}: launched {kernel}, plain {plain}; "
                             f"the path is {path}")
    m = router.metrics.snapshot()
    got = (m["replica_crashes"], m["replica_hangs"], m["replica_restarts"])
    if got != (crashes, hangs, restarts):
        raise AssertionError(f"{label}: crashes, hangs, restarts {got}, "
                             f"expected {(crashes, hangs, restarts)}")
    if m["duplicate_tokens_dropped"] and not crashes + hangs:
        raise AssertionError(f"{label}: a fault-free arm re-delivered "
                             "tokens")
    with torch.cuda.stream(_capture_stream(torch.device("cuda"))):
        if torch.cuda.is_current_stream_capturing():
            raise AssertionError(f"{label}: the capture stream is left "
                                 "capturing")
    router.release_prefix_caches()
    if not router.check_no_leaks():
        raise AssertionError(f"{label}: leaked device pages")
    eng = router.metrics_snapshot()["engines"]
    return {"launches": kernel, "by_form": forms, "crashes": got[0],
            "hangs": got[1], "restarts": got[2],
            "prefix_hit_tokens": eng["prefix_hit_tokens"],
            "prefill_tokens": eng["prefill_tokens"],
            "tokens": eng["tokens_generated"],
            "device_idle_fraction": eng["device_idle_fraction"],
            "duplicate_tokens_dropped": m["duplicate_tokens_dropped"]}


def crash_at(runner, call, log_to):
    """FaultInjector's crash class on ``runner``'s ``call``-th decode call,
    appending to ``log_to`` "capture" when the runner had captured nothing
    yet (its first decode call captures a graph) and "warm" otherwise."""
    from paddle_tpu_torch.serving import FaultInjector

    class Injector(FaultInjector):
        def _pre(self, op):
            captured = len(self._runner.captures)
            try:
                return super()._pre(op)
            except BaseException:
                log_to.append("capture" if captured == 0 else "warm")
                raise
    return Injector(runner, crash_calls=[call], crash_target="decode")


def tier_phase(model, cfg):
    """Phase 42: the in-process serving tier at LLaMA-2-7B (full width,
    ``cfg``'s depth: 8 of 32 layers since phase 46 took the smoke's time;
    fp32 weights shared by every replica, random weights):
    create_serving_router, 2 replicas, ROUTER_KNOBS, audit=True, on
    router_requests' traffic and two second turns. Gates: every request
    finished once; the streams equal a single engine's on the same
    prompts, the two naive-checked requests token-exact against
    naive_generate (engine_phase's fp32 rule); the second turns on their
    session's replica; affinity's prefix hits at least the random
    policy's; the auditor; no leak; only K1 / K2 launched, no plain
    version; no restart in the fault-free arms. Arms on the same tier: a
    replica crash on a warm runner's call and its restore's crash on its
    first call, a capture (the Supervisor restores twice, the streams
    unchanged); a stall held
    past the heartbeat (hung, restored, streams unchanged); rolling_restart
    mid-stream, after which every old engine, runner and host tier is
    collected and the card's allocated memory is within one replica's
    pools and graph pools of its value before. Returns the numbers, the
    reference streams and the traffic."""
    import weakref

    from paddle_tpu_torch.inference import (
        create_serving_engine, create_serving_router,
    )
    from paddle_tpu_torch.serving import FaultInjector, naive_generate

    t0 = time.perf_counter()
    reqs = router_requests(cfg)
    out = {}
    # the reference: one engine, the same knobs, the same prompts
    counts = _zeroed_counts()
    single = create_serving_engine(model, device="cuda", audit=True,
                                   **ROUTER_KNOBS)
    ids = {rid: single.add_request(p, sp, request_id=rid)
           for rid, p, sp in reqs}
    souts = single.run()
    ref = {rid: souts[rid].output_tokens for rid in ids}
    turns = second_turns(cfg, reqs, ref)
    for rid, p, sp in turns:
        single.add_request(p, sp, request_id=rid)
    souts = single.run()
    ref.update({rid: souts[rid].output_tokens for rid, _, _ in turns})
    runner = single.runner
    runner._graph_cache.clear()     # a weights view for the margins only
    del single, souts
    _free_the_card()
    by_len = sorted(range(len(reqs)), key=lambda i: len(reqs[i][1]))
    for i in (by_len[-1], by_len[0]):
        rid, p, sp = reqs[i]
        _gate_streams(f"phase 42 single engine {rid} vs naive_generate",
                      runner, [p], [ref[rid]],
                      [naive_generate(runner, p, sp, max_model_len=1024)])
    lap("phase 42 reference engine")

    # the fault-free arm; the heartbeat far above any step until measured
    clock = StepClock()
    router = create_serving_router(model, replicas=2, device="cuda",
                                   audit=True, heartbeat_timeout_s=600.0,
                                   **ROUTER_KNOBS)
    clock.watch(router)
    counts = _zeroed_counts()
    t = time.perf_counter()
    got = serve_tier(router, reqs, "phase 42 fault-free")
    homes = {sp.session_id: router._reqs[rid].owner_idx
             for rid, _, sp in reqs if sp.session_id}
    tturns = second_turns(cfg, reqs, got)
    got.update(serve_tier(router, tturns, "phase 42 second turns"))
    wall = time.perf_counter() - t
    for rid, _, sp in tturns:
        if router._reqs[rid].owner_idx != homes[sp.session_id]:
            raise AssertionError(f"phase 42: the second turn {rid} left its "
                                 f"session's replica {homes[sp.session_id]}")
    sticky = router.metrics.snapshot()["session_sticky_hits"]
    if sticky != len(tturns):
        raise AssertionError(f"phase 42: {sticky} session-sticky hits of "
                             f"{len(tturns)} second turns")
    names = [r for r, _, _ in reqs + tturns]
    _gate_streams("phase 42 tier vs the single engine", runner,
                  [p for _, p, _ in reqs + tturns], [got[r] for r in names],
                  [ref[r] for r in names])
    ff = gate_tier(router, "phase 42 fault-free", counts)
    longest_cap = StepClock.longest_capture(router)
    heartbeat = max(5.0, 3.0 * max(clock.longest, longest_cap))
    ff.update(wall_s=wall, longest_step_s=clock.longest,
              longest_capture_s=longest_cap, heartbeat_s=heartbeat,
              captures=sum(len(rep.engine.runner.captures)
                           for rep in router._replicas),
              session_sticky_hits=sticky)
    out["fault_free"] = ff
    log(f"phase 42 fault-free: {json.dumps(ff)}; the longest step "
        f"{clock.longest:.3f} s and capture {longest_cap:.3f} s: heartbeat "
        f"{heartbeat:.1f} s")
    router.supervisor.heartbeat_timeout_s = heartbeat
    lap("phase 42 fault-free tier")

    # a crash on replica 0's second decode call (its graphs captured), then
    # on the restored replica's first (a capture call)
    crashed = []
    rep0 = router._replicas[0]
    rep0.engine.runner = crash_at(rep0.engine.runner, 2, crashed)
    factory = router._runner_factory

    def crash_factory(idx):
        fresh = factory(idx)
        if idx == 0 and len(crashed) == 1:
            return crash_at(fresh, 1, crashed)
        return fresh

    router._runner_factory = crash_factory
    counts = _zeroed_counts()
    arm = [(f"c{rid[1:]}", p, sp) for rid, p, sp in reqs]
    cgot = serve_tier(router, arm, "phase 42 crash arm")
    router._runner_factory = factory
    _gate_streams("phase 42 crash arm vs the fault-free arm", runner,
                  [p for _, p, _ in arm], [cgot[r] for r, _, _ in arm],
                  [got[r] for r, _, _ in reqs])
    if crashed != ["warm", "capture"]:
        raise AssertionError(f"phase 42: crashes at {crashed}, expected a "
                             "warm runner's call then a capture call")
    out["crash"] = gate_tier(router, "phase 42 crash arm", counts,
                             crashes=2, restarts=2)
    del rep0
    out["crash"]["crashed_on"] = crashed
    log(f"phase 42 crash arm: {json.dumps(out['crash'])}")
    lap("phase 42 crash arm")

    # a stall on replica 1's second decode call, held on the host (no
    # stream waits) until the Supervisor declares the replica hung
    held = []

    def hold():
        t = time.perf_counter()
        while (router.metrics.replica_hangs.value < 1
               and time.perf_counter() - t < 10 * heartbeat):
            time.sleep(0.05)
        held.append(time.perf_counter() - t)

    rep1 = router._replicas[1]
    rep1.engine.runner = FaultInjector(rep1.engine.runner, stall_calls=[2],
                                       on_stall=hold)
    counts = _zeroed_counts()
    arm = [(f"h{rid[1:]}", p, sp) for rid, p, sp in reqs]
    hgot = serve_tier(router, arm, "phase 42 stall arm")
    _gate_streams("phase 42 stall arm vs the fault-free arm", runner,
                  [p for _, p, _ in arm], [hgot[r] for r, _, _ in arm],
                  [got[r] for r, _, _ in reqs])
    out["stall"] = gate_tier(router, "phase 42 stall arm", counts,
                             crashes=2, hangs=1, restarts=3)
    del rep1
    out["stall"]["held_s"] = held[0] if held else None
    log(f"phase 42 stall arm: {json.dumps(out['stall'])}")
    lap("phase 42 stall arm")

    # rolling_restart mid-stream: every old engine released, memory back
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    pinned = sum(b.numel() * b.element_size() for rep in router._replicas
                 for layer in rep.engine.pool.host_tier._bufs for b in layer)
    one = max(rep.engine.pool.memory_bytes() + sum(
        c["pool_bytes"] for c in rep.engine.runner.captures)
        for rep in router._replicas)
    old = [weakref.ref(o) for rep in router._replicas
           for o in (rep.engine, rep.engine.pool.host_tier,
                     getattr(rep.engine.runner, "_runner",
                             rep.engine.runner))]
    counts = _zeroed_counts()
    arm = [(f"r{rid[1:]}", p, sp) for rid, p, sp in reqs]
    base = router.metrics.tokens_delivered.value

    def restart_mid_stream():
        deadline = time.perf_counter() + 300
        while (router.metrics.tokens_delivered.value < base + 64
               and time.perf_counter() < deadline):
            time.sleep(0.005)
        router.rolling_restart()

    rgot = serve_tier(router, arm, "phase 42 rolling restart",
                      during=restart_mid_stream)
    _gate_streams("phase 42 rolling restart vs the fault-free arm", runner,
                  [p for _, p, _ in arm], [rgot[r] for r, _, _ in arm],
                  [got[r] for r, _, _ in reqs])
    rr = gate_tier(router, "phase 42 rolling restart", counts, crashes=2,
                   hangs=1, restarts=5)
    m = router.metrics.snapshot()
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    pinned_after = sum(b.numel() * b.element_size()
                       for rep in router._replicas
                       for layer in rep.engine.pool.host_tier._bufs
                       for b in layer)
    alive = sum(r() is not None for r in old)
    rr.update(drains=m["replica_drains"], migrations=m["drain_migrations"],
              allocated_before_GiB=before / 2**30,
              allocated_after_GiB=after / 2**30,
              one_replica_GiB=one / 2**30, pinned_before=pinned,
              pinned_after=pinned_after, old_objects_alive=alive)
    out["rolling_restart"] = rr
    log(f"phase 42 rolling restart: {json.dumps(rr)}")
    if alive:
        raise AssertionError(f"phase 42: {alive} engines, runners or host "
                             "tiers of the restarted replicas are alive")
    if after > before + one or pinned_after != pinned:
        raise AssertionError(
            f"phase 42: after rolling_restart {after / 2**30:.3f} GiB "
            f"allocated against {before / 2**30:.3f} GiB before (one "
            f"replica {one / 2**30:.3f} GiB), pinned {pinned_after} bytes "
            f"against {pinned}")
    if m["replica_drains"] != 2 or m["rolling_restarts"] != 1:
        raise AssertionError(f"phase 42: rolling restart counts {m}")
    router.shutdown()
    del router
    _free_the_card()
    lap("phase 42 rolling restart")

    # the random policy on the same traffic: affinity's hits at least its
    counts = _zeroed_counts()
    rnd = create_serving_router(model, replicas=2, device="cuda",
                                audit=True, policy="random",
                                heartbeat_timeout_s=heartbeat,
                                **ROUTER_KNOBS)
    rgot = serve_tier(rnd, reqs, "phase 42 random policy")
    serve_tier(rnd, second_turns(cfg, reqs, rgot), "phase 42 random turns")
    out["random"] = gate_tier(rnd, "phase 42 random policy", counts)
    rnd.shutdown()
    del rnd
    _free_the_card()
    hits = (ff["prefix_hit_tokens"], out["random"]["prefix_hit_tokens"])
    log(f"phase 42: prefix hit tokens affinity {hits[0]:.0f} (second turns "
        f"included), random {hits[1]:.0f}")
    if hits[0] < hits[1]:
        raise AssertionError(f"phase 42: affinity's prefix hits {hits[0]} "
                             f"below the random policy's {hits[1]}")
    out["seconds"] = time.perf_counter() - t0
    lap("phase 42 random policy")
    return out, ref, reqs, runner


class HandoffSpy:
    """Phase 43's page check: every request a prefill replica stages has
    its pages gathered on the card before the spill (a device copy), and
    every page a decode replica pages in is compared, bit for bit on the
    card, with that copy after the fence: fp32 pages, int8 codes and
    scale rows alike. Also times the host side of extract_handoff and
    import_handoff (the export and import rates)."""

    def __init__(self, router):
        self.sent = {}
        self.checked = 0
        self.export_s = self.import_s = 0.0
        for rep in router._replicas:
            eng = rep.engine
            if rep.role == "prefill":
                self._wrap_prefill(eng)
            else:
                self._wrap_decode(eng)

    def _wrap_prefill(self, eng):
        stage, extract = eng._stage, eng.extract_handoff

        def _stage(req):
            covered = min(req.kv.num_tokens, req.num_context - 1)
            pages = req.kv.pages[:eng.pool.blocks_for_tokens(covered)]
            self.sent[req.request_id] = eng.pool.gather_pages(pages)
            return stage(req)

        def extract_handoff(rid):
            t = time.perf_counter()
            try:
                return extract(rid)
            finally:
                self.export_s += time.perf_counter() - t
        eng._stage, eng.extract_handoff = _stage, extract_handoff

    def _wrap_decode(self, eng):
        fence, imp = eng._fence_pagein, eng.import_handoff

        def import_handoff(state, payload):
            t = time.perf_counter()
            try:
                return imp(state, payload)
            finally:
                self.import_s += time.perf_counter() - t

        def _fence_pagein(admitted):
            fence(admitted)
            for req in admitted:
                sent = self.sent.pop(req.request_id, None)
                if sent is None:
                    continue
                # every page the record covers, whether paged in, promoted
                # from the host prefix index or matched in the device
                # cache: the prefill replica's bytes
                n = sent[0][0].shape[0]
                got = eng.pool.gather_pages(req.kv.pages[:n])
                for a_layer, b_layer in zip(sent, got):
                    for a, b in zip(a_layer, b_layer):
                        if not torch.equal(a.view(torch.uint8),
                                           b.view(torch.uint8)):
                            raise AssertionError(
                                f"phase 43: {req.request_id}'s pages "
                                "differ on the decode replica from the "
                                "prefill replica's")
                self.checked += n
        eng._fence_pagein, eng.import_handoff = _fence_pagein, \
            import_handoff


def handoff_device_ms(model, reqs, store_pages=0):
    """The device ms from a request's first token on a prefill-role engine
    to its first decode step on a decode-role engine (the staging spill,
    the export, the import and CRC checks, the page-in and the step, CUDA
    events on the compute stream), against the device ms of the next
    decode step of the same request on a mixed engine. With
    ``store_pages`` the two engines share a host-wide store of that many
    pages (phase 46: the handoff is a slot reference)."""
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.serving import SharedKVStore

    _, p, sp = reqs[0]
    # one decode step a step: decode_horizon 1
    knobs = dict(ROUTER_KNOBS, decode_horizon=1)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    shared = {}
    if store_pages:
        cfg = model.cfg
        shared["kv_store"] = SharedKVStore(SharedKVStore.layout_for(
            cfg.num_layers, knobs["block_size"], cfg.num_kv_heads,
            cfg.hidden_size // cfg.num_heads), store_pages, pin_memory=True)
    pre = create_serving_engine(model, device="cuda", role="prefill",
                                kv_store_owner="pre", **shared, **knobs)
    dec = create_serving_engine(model, device="cuda", role="decode",
                                kv_store_owner="dec", **shared, **knobs)
    mixed = create_serving_engine(model, device="cuda", **knobs)
    for eng in (pre, mixed):
        eng.add_request(p, sp, request_id="m")
    while not pre._requests["m"].output_tokens:
        pre.step()
    while not mixed._requests["m"].output_tokens:
        mixed.step()
    mixed.step()                 # the first decode step captures a graph
    events[0].record()
    pre.step()                   # stages the request
    dec.import_handoff(*pre.extract_handoff("m"))
    while len(dec._requests["m"].output_tokens) < 2:
        dec.step()
    events[1].record()
    events[2].record()
    n = len(mixed._requests["m"].output_tokens)
    while len(mixed._requests["m"].output_tokens) == n:
        mixed.step()
    events[3].record()
    events[3].synchronize()
    out = (events[0].elapsed_time(events[1]),
           events[2].elapsed_time(events[3]))
    del pre, dec, mixed
    if shared:
        shared["kv_store"].close()
    _free_the_card()
    return out


def disagg_arm(model, cfg, reqs, label, kv_dtype="fp32"):
    """One phase 43 arm: prefill_replicas=1 of 2 over ``model``, each
    replica's host tier sized for every request's pages, the traffic
    served under HandoffSpy. Gates: every request handed off once with
    its pages (handoffs out and in = the requests, no recompute
    fallback), every page paged in bit-identical on the card, only the
    path's kernels. Returns the streams and the arm's numbers."""
    from paddle_tpu_torch.inference import create_serving_router

    pages = sum(-(-(len(p) + sp.max_tokens) // 16) for _, p, sp in reqs)
    counts = _zeroed_counts()
    router = create_serving_router(
        model, replicas=2, prefill_replicas=1, device="cuda", audit=True,
        heartbeat_timeout_s=600.0, kv_dtype=kv_dtype,
        **dict(ROUTER_KNOBS, host_tier_pages=pages))
    spy = HandoffSpy(router)
    t = time.perf_counter()
    got = serve_tier(router, reqs, f"phase 43 {label}")
    wall = time.perf_counter() - t
    numbers = gate_tier(router, f"phase 43 {label}", counts, kv_dtype)
    rm, eng = router.metrics.snapshot(), router.metrics_snapshot()["engines"]
    n = len(reqs)
    if not (eng["handoffs_out"] == eng["handoffs_in"] == rm["handoffs"] == n
            and eng["handoff_recompute_fallbacks"] == 0
            and rm["handoff_fallbacks"] == 0):
        raise AssertionError(f"phase 43 {label}: handoffs {rm['handoffs']}, "
                             f"out {eng['handoffs_out']}, in "
                             f"{eng['handoffs_in']}, recomputed "
                             f"{eng['handoff_recompute_fallbacks']}")
    if spy.checked != eng["handoff_pages_out"] or spy.sent:
        raise AssertionError(f"phase 43 {label}: {spy.checked} pages "
                             f"checked of {eng['handoff_pages_out']} handed "
                             f"off; {len(spy.sent)} requests never paged in")
    if any(o.replicas[:2] != [0, 1] for o in router.outputs().values()):
        raise AssertionError(f"phase 43 {label}: a request did not enter "
                             "on the prefill replica and end on the decode "
                             "replica")
    nbytes = eng["handoff_bytes_out"]
    numbers.update(
        wall_s=wall, handoffs=rm["handoffs"],
        handoff_pages=eng["handoff_pages_in"], pages_checked=spy.checked,
        handoff_bytes=nbytes, export_GBps=nbytes / spy.export_s / 1e9,
        import_GBps=nbytes / spy.import_s / 1e9,
        host_tier_pages=pages)
    router.shutdown()
    del router, spy
    _free_the_card()
    log(f"phase 43 {label} ({kv_dtype} pool, {cfg.num_layers} layers): "
        f"{json.dumps(numbers)}")
    return got, numbers


def disagg_phase(model, cfg, reqs):
    """Phase 43: disaggregated prefill / decode at LLaMA-2-7B's full width
    and cfg's depth (8 of 32 layers since phase 46 took the smoke's time):
    disagg_arm's gates, fp32 pools with every stream equal to a single
    fp32 engine's on the same model, then an int8 pool (codes and scale
    rows bit-identical), its tokens reported against the same engine's;
    the device ms from a first token to the first decode step on the
    other replica against a decode step. Returns the numbers."""
    from paddle_tpu_torch.inference import create_serving_engine

    t0 = time.perf_counter()
    ref = create_serving_engine(model, device="cuda", **ROUTER_KNOBS)
    for rid, p, sp in reqs:
        ref.add_request(p, sp, request_id=rid)
    qouts = ref.run()
    del ref
    _free_the_card()
    names = [r for r, _, _ in reqs]
    got, fp32 = disagg_arm(model, cfg, reqs, "fp32")
    _gate_streams(f"phase 43 disaggregated vs an fp32 engine at "
                  f"{cfg.num_layers} layers", None,
                  [p for _, p, _ in reqs], [got[r] for r in names],
                  [qouts[r].output_tokens for r in names])
    lap("phase 43 fp32 split")
    qgot, int8 = disagg_arm(model, cfg, reqs, "int8", kv_dtype="int8")
    _agreement(f"phase 43 int8 split tier vs an fp32 engine at "
               f"{cfg.num_layers} layers", [qgot[r] for r in names],
               [qouts[r].output_tokens for r in names])
    lap("phase 43 int8 split")
    handoff_ms, step_ms = handoff_device_ms(model, reqs)
    out = {"fp32": fp32, "int8": int8, "first_token_to_decode_ms":
           handoff_ms, "decode_step_ms": step_ms,
           "seconds": time.perf_counter() - t0}
    log(f"phase 43: {fp32['handoff_bytes'] / 2**30:.2f} GiB handed off "
        f"(fp32), export {fp32['export_GBps']:.2f} GB/s, import "
        f"{fp32['import_GBps']:.2f} GB/s (host clock); first token on the "
        f"prefill replica to the first decode step on the decode replica "
        f"{handoff_ms:.3f} device ms against a decode step "
        f"{step_ms:.3f} device ms; idle share fp32 "
        f"{fp32['device_idle_fraction']:.3f}, int8 "
        f"{int8['device_idle_fraction']:.3f}; {out['seconds']:.1f} s")
    lap("phase 43 handoff timing")
    return out


def durability_phase(model, cfg, ref, reqs, runner):
    """Phase 44: a journaled tier (journal_fsync="always", a host tier with
    room for a drain's pages) serves phase 42's traffic halfway and is
    abandoned in process (every replica fenced, the supervisor stopped,
    the journal closed); then ServingRouter.recover on the card rebuilds
    it from the journal, and drain_replica runs on the first replica to
    reach a decode call after the recovery, its call held on the host
    (the injector's stall class) until the drain stops it. Gates: every stream equal to phase 42's,
    none lost or delivered twice, the finished outputs restored as they
    were, and the drain moving its decoding requests with their pages
    (stage_migration, handoffs in, no recompute fallback)."""
    import shutil as _shutil
    import tempfile

    import threading

    from paddle_tpu_torch.inference import create_serving_router
    from paddle_tpu_torch.serving import (
        FaultInjector, RouterJournal, ServingRouter,
    )

    t0 = time.perf_counter()
    knobs = dict(ROUTER_KNOBS, host_tier_pages=400, audit=True,
                 heartbeat_timeout_s=600.0, journal_fsync="always")
    tmp = tempfile.mkdtemp(prefix="tier-journal-")
    path = f"{tmp}/wal.jsonl"
    tiers = []
    try:
        counts = _zeroed_counts()
        router = create_serving_router(model, replicas=2, device="cuda",
                                       journal_path=path, **knobs)
        factory = router._runner_factory
        submit_waves(router, reqs)
        half = sum(sp.max_tokens for _, _, sp in reqs) // 2
        deadline = time.perf_counter() + 300
        while (router.metrics.tokens_delivered.value < half
               and time.perf_counter() < deadline):
            time.sleep(0.002)
        for rep in router._replicas:          # the crash
            rep.fenced = True
            rep.stop = True
            rep.wake.set()
        router.supervisor.stop()
        router._journal.close()
        delivered = router.metrics.tokens_delivered.value
        for rep in router._replicas:
            rep.thread.join(60)
        del router, rep
        _free_the_card()
        state, discarded = RouterJournal.replay(path)
        done = [rid for rid, r in state["reqs"].items() if r["done"]]
        # each recovered replica's runner stalls its first decode call
        # (its batch re-prefilled, decoding); the first replica to get
        # there is held until the drain below stops it, the other goes on
        reached, chosen = threading.Event(), []
        lock = threading.Lock()

        def hold(idx):
            with lock:
                if not chosen:
                    chosen.append(idx)
                    reached.set()
            if chosen[0] != idx:
                return
            t = time.perf_counter()
            while not (tiers and tiers[0]._replicas[idx].stop) \
                    and time.perf_counter() - t < 300:
                time.sleep(0.001)

        wrapped = set()

        def held_factory(idx):
            fresh = factory(idx)
            if idx in wrapped:
                return fresh
            wrapped.add(idx)
            return FaultInjector(fresh, stall_calls=[1],
                                 on_stall=lambda: hold(idx))

        r2 = ServingRouter.recover(held_factory, path, replicas=2, **knobs)
        tiers.append(r2)
        finished = r2.outputs()
        _gate_streams("phase 44 finished before the crash vs phase 42",
                      runner, [p for rid, p, _ in reqs if rid in done],
                      [finished[rid].output_tokens for rid in done],
                      [ref[rid] for rid in done])
        if not reached.wait(120):
            raise AssertionError("phase 44: no replica decoded a recovered "
                                 "request")
        moved = r2.drain_replica(chosen[0])
        outs = r2.drain(timeout_s=600.0)
        names = [r for r, _, _ in reqs]
        if sorted(outs) != sorted(names) or any(
                outs[r].finish_reason != "length" for r in names):
            raise AssertionError("phase 44: a recovered request was lost or "
                                 "did not finish")
        _gate_streams("phase 44 recovered tier vs phase 42", runner,
                      [p for _, p, _ in reqs], [outs[r].output_tokens
                                                for r in names],
                      [ref[r] for r in names])
        rm, eng = r2.metrics.snapshot(), r2.metrics_snapshot()["engines"]
        numbers = gate_tier(r2, "phase 44 recovered tier", counts)
        if not (eng["handoffs_in"] >= 1 and eng["handoff_pages_in"] > 0
                and eng["handoff_recompute_fallbacks"] == 0
                and rm["drain_migrations"] == moved >= 1):
            raise AssertionError(f"phase 44: the drain moved no decoding "
                                 f"request with its pages: {rm}, {eng}")
        numbers.update(
            delivered_before_crash=delivered, finished_before_crash=len(done),
            discarded_lines=discarded,
            recovered_requests=rm["recovered_requests"],
            duplicate_tokens_dropped=rm["duplicate_tokens_dropped"],
            drained_replica=chosen[0], drain_migrations=moved,
            drained_with_pages=eng["handoffs_in"],
            drained_pages=eng["handoff_pages_in"],
            journal=r2.metrics_snapshot()["journal"],
            seconds=time.perf_counter() - t0)
        r2.shutdown()
        del r2
        tiers.clear()
        _free_the_card()
    finally:
        for tier in tiers:
            tier.shutdown()
        _shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 44: {json.dumps(numbers)}")
    lap("phase 44")
    return numbers


# ------------------------------------------------ the process tier (45)

# phase 45's replicas: LLaMA-2-7B at full width and 8 of its 32 layers in
# each child process (two full-depth children, 27 GB of fp32 weights each,
# and a respawned child beside them would not fit the card)
PROC_LAYERS = 8


def store_timing(rec):
    """Patch ServingEngine's store paths (the spill of a handoff's pages in
    _stage, extract_handoff, import_handoff, the page-in fence) to add up,
    into ``rec`` by path, the calls, host seconds, pages copied (spilled
    or paged in), dedup refs and store RPCs (a replica child's
    SharedKVStoreClient counts its round trips) of engines over a
    host-wide store. Returns the undo."""
    from paddle_tpu_torch.serving.engine import ServingEngine
    names = ("_stage", "extract_handoff", "import_handoff", "_fence_pagein")
    orig = {n: getattr(ServingEngine, n) for n in names}

    def wrap(name):
        fn = orig[name]

        def timed(eng, *a, **kw):
            store, tier = eng.kv_store, eng.pool.host_tier
            if store is None:
                return fn(eng, *a, **kw)
            n0 = getattr(store, "rpc_count", 0)
            c0 = (tier.spilled_pages, tier.paged_in_pages, tier.store_dedups)
            t = time.perf_counter()
            try:
                return fn(eng, *a, **kw)
            finally:
                dt = time.perf_counter() - t
                r = rec.setdefault(name, {"calls": 0, "s": 0.0, "pages": 0,
                                          "dedups": 0, "rpcs": 0,
                                          "page_bytes": 0})
                c1 = (tier.spilled_pages, tier.paged_in_pages,
                      tier.store_dedups)
                r["calls"] += 1
                r["s"] += dt
                r["pages"] += (c1[0] - c0[0]) + (c1[1] - c0[1])
                r["dedups"] += c1[2] - c0[2]
                r["rpcs"] += getattr(store, "rpc_count", 0) - n0
                r["page_bytes"] = eng.pool.page_bytes()
        return timed
    for n in names:
        setattr(ServingEngine, n, wrap(n))

    def undo():
        for n, fn in orig.items():
            setattr(ServingEngine, n, fn)
    return undo


def store_rates(recs):
    """Spill and page-in GB/s (host clock) and store RPCs per handoff from
    store_timing records (summed over processes)."""
    tot = {}
    for rec in recs:
        for name, r in rec.items():
            t = tot.setdefault(name, {k: 0 for k in r})
            for k, v in r.items():
                t[k] = v if k == "page_bytes" else t[k] + v
    st, fe = tot.get("_stage", {}), tot.get("_fence_pagein", {})
    handoffs = max(1, tot.get("extract_handoff", {}).get("calls", 0))
    rpcs = {n: tot.get(n, {}).get("rpcs", 0) for n in (
        "_stage", "extract_handoff", "import_handoff", "_fence_pagein")}
    return {
        "spill_GBps": (st["pages"] * st["page_bytes"] / st["s"] / 1e9
                       if st.get("s") else None),
        "pagein_GBps": (fe["pages"] * fe["page_bytes"] / fe["s"] / 1e9
                        if fe.get("s") and fe.get("pages") else None),
        "spilled_pages": st.get("pages", 0),
        "dedup_refs": st.get("dedups", 0),
        "paged_in_pages": fe.get("pages", 0),
        "store_rpcs": rpcs,
        "store_rpcs_per_handoff": sum(rpcs.values()) / handoffs}


class _ChildRecorder:
    """Phase 45's record inside one replica process, rewritten (atomically)
    to ``counts_dir/<pid>.json`` after every runner call: the process's
    launches of every serving kernel (kernel and plain, from process start,
    so a SIGKILLed child leaves its last record), the kernel library's
    path and build seconds, the CRC of every handed-off page (page_crc)
    on the device before its spill here ("staged") and after its page-in
    here ("landed"), and, over a host-wide store, the host seconds, pages
    and store RPCs of its handoff and page-in paths (store_timing)."""

    def __init__(self, counts_dir, runner):
        from paddle_tpu_torch.ops import _build
        from paddle_tpu_torch.serving import FaultInjector
        from paddle_tpu_torch.serving.engine import ServingEngine

        self.path = Path(counts_dir) / f"{os.getpid()}.json"
        self.library = str(_build.BUILD.path)
        self.built_s = _build.BUILD.seconds
        self.staged, self.landed, self.expect = [], [], {}
        # the store paths' timing sits under the CRC reads below, which it
        # must not count
        self.store = {}
        store_timing(self.store)
        rec = self

        class Recorded(FaultInjector):
            def _post(self, op, n, out, packed=False):
                out = super()._post(op, n, out, packed)
                rec.dump()
                return out

        self.runner = Recorded(runner)
        # this process holds one engine: patch its class
        stage, fence = ServingEngine._stage, ServingEngine._fence_pagein
        imp = ServingEngine.import_handoff

        def _stage(eng, req):
            if eng.pool.host_tier is not None:
                covered = min(req.kv.num_tokens, req.num_context - 1)
                pages = req.kv.pages[:eng.pool.blocks_for_tokens(covered)]
                rec.staged.append([req.request_id, [
                    page_crc(eng.pool, p) for p in pages]])
                rec.dump()
            return stage(eng, req)

        def import_handoff(eng, state, payload):
            if payload is not None and payload.get("hashes"):
                rec.expect[state["request_id"]] = len(payload["hashes"])
            return imp(eng, state, payload)

        def _fence_pagein(eng, admitted):
            fence(eng, admitted)
            for req in admitted:
                n = rec.expect.pop(req.request_id, None)
                if n is not None:
                    rec.landed.append([req.request_id, [
                        page_crc(eng.pool, p) for p in req.kv.pages[:n]]])
                    rec.dump()

        ServingEngine._stage = _stage
        ServingEngine.import_handoff = import_handoff
        ServingEngine._fence_pagein = _fence_pagein
        self.dump()

    def dump(self):
        data = {"library": self.library, "built_s": self.built_s,
                "counts": {n: [c.kernel_launches, c.plain_launches]
                           for n, c in _all_counts()},
                "staged": self.staged, "landed": self.landed,
                "store": self.store}
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(data))
        os.replace(tmp, self.path)


def counted_runner_factory(index=0, *, counts_dir, **kw):
    """Phase 45's replica factory, imported by each replica process from
    this file (the spec's sys_path): serving.replica.model_runner_factory's
    runner after loading the kernel library (built by the parent, found by
    its hash), wrapped by _ChildRecorder."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.serving.replica import model_runner_factory
    _build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return _ChildRecorder(counts_dir,
                          model_runner_factory(index, **kw)).runner


def _child_records(counts_dir):
    """Every child's record: {pid: record}."""
    return {int(f.stem): json.loads(f.read_text())
            for f in Path(counts_dir).glob("*.json")}


def _child_launches(counts_dir):
    """{kernel: [kernel launches, plain launches]} summed over children."""
    out = {}
    for r in _child_records(counts_dir).values():
        for name, (k, p) in r["counts"].items():
            tot = out.setdefault(name, [0, 0])
            tot[0] += k
            tot[1] += p
    return out


def _free_gib():
    return torch.cuda.mem_get_info()[0] / 2**30


def _await_free(label, want_gib, deadline_s=120.0, phase="phase 45"):
    """Wait until the card's free memory reaches ``want_gib`` (a dead
    child's memory is released by CUDA after its exit); returns the
    free GiB and the seconds waited, and fails past the deadline."""
    t = time.perf_counter()
    while True:
        free = _free_gib()
        if free >= want_gib:
            waited = time.perf_counter() - t
            log(f"{phase} {label}: {free:.2f} GiB free "
                f"(waited {waited:.1f} s for {want_gib:.2f})")
            return free, waited
        if time.perf_counter() - t > deadline_s:
            raise AssertionError(f"{phase} {label}: {free:.2f} GiB free "
                                 f"after {deadline_s:.0f} s, expected "
                                 f"{want_gib:.2f}")
        time.sleep(0.5)


class _SpawnLog:
    """Phase 45's record of every child the launcher starts: the Popen
    object, its start and the time its engine answered init (host clock),
    by launcher key. Patches the launcher and client classes until
    close()."""

    def __init__(self):
        from paddle_tpu_torch.serving import launch
        self.launch = launch
        self.procs, self.started, self.ready = [], {}, {}
        self._orig = (launch.ReplicaLauncher._spawn_proc,
                      launch.EngineClient.init)
        spawn_proc, init = self._orig
        log_ = self

        def _spawn_proc(launcher, rank):
            proc, key = spawn_proc(launcher, rank)
            log_.procs.append(proc)
            log_.started[key] = time.perf_counter()
            return proc, key

        def _init(client, *a, **kw):
            init(client, *a, **kw)
            log_.ready[client.key] = (time.perf_counter()
                                      - log_.started[client.key])

        launch.ReplicaLauncher._spawn_proc = _spawn_proc
        launch.EngineClient.init = _init

    def close(self):
        (self.launch.ReplicaLauncher._spawn_proc,
         self.launch.EngineClient.init) = self._orig

    def reap_check(self):
        """Every child has exited and been reaped; kills any that has not
        (and fails)."""
        alive = [p.pid for p in self.procs if p.poll() is None]
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
        if alive:
            raise AssertionError(f"phase 45: children {alive} outlived "
                                 "their tier")
        return [p.returncode for p in self.procs]


def _proc_gate(router, label, counts_dir, before, kv_dtype="fp32",
               crashes=0, hangs=0, restarts=0, recovered=False):
    """A process-tier arm's gates: audit_router (inside every live child),
    the children's launches since ``before`` only the path's kernels and
    no plain version, the crash / hang / restart counts, no token
    re-delivered (and dropped) in a fault-free arm (a tier recovered from
    its journal may regenerate what its snapshots lag). Returns the arm's
    numbers."""
    from paddle_tpu_torch.serving import audit_router
    audit_router(router)
    now = _child_launches(counts_dir)
    kernel = {n: k - before.get(n, [0, 0])[0] for n, (k, _) in now.items()
              if k - before.get(n, [0, 0])[0]}
    plain = sum(p - before.get(n, [0, 0])[1] for n, (_, p) in now.items())
    path = _path_kernels(kv_dtype)
    if plain or set(kernel) != set(path):
        raise AssertionError(f"{label}: the children launched {kernel}, "
                             f"plain {plain}; the path is {path}")
    m = router.metrics.snapshot()
    got = (m["replica_crashes"], m["replica_hangs"], m["replica_restarts"])
    if got != (crashes, hangs, restarts):
        raise AssertionError(f"{label}: crashes, hangs, restarts {got}, "
                             f"expected {(crashes, hangs, restarts)}")
    if m["duplicate_tokens_dropped"] and not (crashes + hangs or recovered):
        raise AssertionError(f"{label}: a fault-free arm re-delivered "
                             "tokens")
    return {"launches": kernel, "crashes": got[0], "hangs": got[1],
            "restarts": got[2],
            "duplicate_tokens_dropped": m["duplicate_tokens_dropped"]}


def _release_check(router, label):
    router.release_prefix_caches()
    if not router.check_no_leaks():
        raise AssertionError(f"{label}: a child leaked device pages")


def _handoff_crcs(counts_dir, rids):
    """The staged and landed page CRCs of ``rids`` over every child: each
    landed entry must equal a staged one. Returns the pages checked."""
    staged, landed = [], []
    for r in _child_records(counts_dir).values():
        staged += [(rid, tuple(c)) for rid, c in r["staged"] if rid in rids]
        landed += [(rid, tuple(c)) for rid, c in r["landed"] if rid in rids]
    for rid, crcs in landed:
        if (rid, crcs) not in staged:
            raise AssertionError(
                f"phase 45: {rid}'s pages on the decode child (CRCs "
                f"{[hex(c) for c in crcs[:4]]}...) differ from the prefill "
                "child's before the spill")
    return sum(len(c) for _, c in landed), len(landed)


def _process_split_arm(spec, knobs, reqs, ref, counts_dir, label, prefix,
                       kv_dtype="fp32"):
    """Phase 45 (d): prefill_replicas=1 of 2 children over the wire, each
    child's host tier sized for every request's pages. Gates: every
    request handed off once with its pages (no recompute fallback), every
    landed page's CRC equal to the staged page's, only the path's kernels
    in the children; fp32 streams equal the reference, the int8 arm's
    reported against it. Returns the arm's numbers."""
    from paddle_tpu_torch.serving import ServingRouter

    pages = sum(-(-(len(p) + sp.max_tokens) // 16) for _, p, sp in reqs)
    spec = dict(spec, factory_kw=dict(spec["factory_kw"], kv_dtype=kv_dtype))
    before = _child_launches(counts_dir)
    router = ServingRouter(spec, replicas=2, backend="process",
                           prefill_replicas=1,
                           **dict(knobs, host_tier_pages=pages))
    try:
        pre, dec = (rep.engine for rep in router._replicas)
        moved = {"bytes": 0, "export_s": 0.0, "import_s": 0.0}
        extract, imp = pre.extract_handoff, dec.import_handoff

        def extract_handoff(rid):
            t = time.perf_counter()
            state, payload = extract(rid)
            moved["export_s"] += time.perf_counter() - t
            if payload is not None:
                moved["bytes"] += sum(int(a.nbytes) for layer in
                                      payload["layers"] for a in layer)
            return state, payload

        def import_handoff(state, payload):
            t = time.perf_counter()
            try:
                return imp(state, payload)
            finally:
                moved["import_s"] += time.perf_counter() - t
        pre.extract_handoff, dec.import_handoff = extract_handoff, \
            import_handoff
        # per request: the host time of its last token from the prefill
        # child and of its first from the decode child
        last_pre, first_dec = {}, {}
        deliver = router._deliver

        def timed_deliver(rep, epoch, events):
            now = time.perf_counter()
            for ev in events:
                if rep.role == "prefill":
                    last_pre[ev.request_id] = now
                else:
                    first_dec.setdefault(ev.request_id, now)
            return deliver(rep, epoch, events)
        router._deliver = timed_deliver
        names = {f"{prefix}{rid[1:]}" for rid, _, _ in reqs}
        arm = [(f"{prefix}{rid[1:]}", p, sp) for rid, p, sp in reqs]
        t = time.perf_counter()
        got = serve_tier(router, arm, f"phase 45 split {label}")
        wall = time.perf_counter() - t
        if kv_dtype == "fp32":
            _gate_streams(f"phase 45 split {label} vs the single engine",
                          None, [p for _, p, _ in arm],
                          [got[r] for r, _, _ in arm],
                          [ref[r] for r, _, _ in reqs])
        else:
            _agreement(f"phase 45 split {label} vs an {kv_dtype} engine "
                       "in one process", [got[r] for r, _, _ in arm],
                       [ref[r] for r, _, _ in reqs])
        numbers = _proc_gate(router, f"phase 45 split {label}", counts_dir,
                             before, kv_dtype)
        rm = router.metrics.snapshot()
        eng = router.metrics_snapshot()["engines"]
        n = len(reqs)
        checked, landed = _handoff_crcs(counts_dir, names)
        if not (eng["handoffs_out"] == eng["handoffs_in"] == rm["handoffs"]
                == landed == n
                and eng["handoff_recompute_fallbacks"] == 0
                and rm["handoff_fallbacks"] == 0
                and checked == eng["handoff_pages_in"] > 0):
            raise AssertionError(
                f"phase 45 split {label}: handoffs {rm['handoffs']}, out "
                f"{eng['handoffs_out']}, in {eng['handoffs_in']}, landed "
                f"{landed}, recomputed {eng['handoff_recompute_fallbacks']}"
                f", pages checked {checked} of {eng['handoff_pages_in']}")
        if any(o.replicas[:2] != [0, 1] for o in router.outputs().values()):
            raise AssertionError(f"phase 45 split {label}: a request did "
                                 "not enter on the prefill child and end "
                                 "on the decode child")
        _release_check(router, f"phase 45 split {label}")
        gaps = sorted(first_dec[r] - last_pre[r] for r in names
                      if r in first_dec and r in last_pre)
        numbers.update(
            wall_s=wall, handoffs=rm["handoffs"], pages_checked=checked,
            handoff_bytes=moved["bytes"],
            export_GBps=moved["bytes"] / moved["export_s"] / 1e9,
            import_GBps=moved["bytes"] / moved["import_s"] / 1e9,
            wire_GBps=moved["bytes"] / (moved["export_s"]
                                        + moved["import_s"]) / 1e9,
            prefill_to_decode_token_s={"median": statistics.median(gaps),
                                   "max": gaps[-1], "n": len(gaps)},
            host_tier_pages=pages)
        log(f"phase 45 split {label} ({kv_dtype} pool): "
            f"{json.dumps(numbers)}")
        return numbers
    finally:
        router.shutdown()


def process_tier_phase(cfg, reqs):
    """Phase 45: the serving tier over replica processes (see the module
    docstring): arms (a), (g), (b), (c), (e), (f) on one journaled tier of
    two mixed children, then (d) on split tiers. Returns the numbers."""
    import signal
    import tempfile
    from dataclasses import asdict

    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.models import Llama
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.serving import ServingRouter, WireFaultInjector

    t0 = time.perf_counter()
    pcfg = replace(cfg, num_layers=PROC_LAYERS)
    out = {"layers": PROC_LAYERS}
    # the references: single engines in this process on the same weights,
    # freed before any child starts
    model = Llama(pcfg, device="cuda", seed=0)
    refs = {}
    for kind in ("fp32", "int8"):
        single = create_serving_engine(model, device="cuda", kv_dtype=kind,
                                       **ROUTER_KNOBS)
        for rid, p, sp in reqs:
            single.add_request(p, sp, request_id=rid)
        refs[kind] = {k: o.output_tokens for k, o in single.run().items()}
        del single
    del model
    out["parent_GiB_allocated"] = _free_the_card()
    lap("phase 45 reference engines")

    tmp = tempfile.mkdtemp(prefix="proc-tier-")
    counts_dir = f"{tmp}/counts"
    os.makedirs(counts_dir)
    journal = f"{tmp}/wal.jsonl"
    spec = {"factory": "chip_smoke:counted_runner_factory",
            "factory_kw": dict(model="llama", seed=0, block_size=16,
                               max_model_len=1024, device="cuda",
                               counts_dir=counts_dir, **asdict(pcfg)),
            "sys_path": [str(Path(__file__).resolve().parent)]}
    engine_knobs = {k: v for k, v in ROUTER_KNOBS.items()
                    if k != "block_size"}
    knobs = dict(engine_knobs, audit=True, heartbeat_timeout_s=600.0,
                 command_timeout_s=600.0, rendezvous_timeout_s=300.0)
    spawns = _SpawnLog()
    mem = {"before_spawns": _free_gib()}
    log(f"phase 45: mem_get_info before the spawns: "
        f"{mem['before_spawns']:.2f} GiB free of "
        f"{torch.cuda.mem_get_info()[1] / 2**30:.2f}")
    tiers = []
    ref = refs["fp32"]
    try:
        # (a) two mixed children, journaled from the start for (f)
        before = _child_launches(counts_dir)
        router = ServingRouter(spec, replicas=2, backend="process",
                               journal_path=journal,
                               journal_fsync="always", **knobs)
        tiers.append(router)
        mem["after_spawns"] = _free_gib()
        one = (mem["before_spawns"] - mem["after_spawns"]) / 2
        libs = {pid: (r["library"], r["built_s"])
                for pid, r in _child_records(counts_dir).items()}
        log(f"phase 45: spawn to ready {json.dumps(spawns.ready)} s; "
            f"{mem['after_spawns']:.2f} GiB free, one child "
            f"{one:.2f} GiB; the children's kernel library "
            f"{json.dumps(libs)}, the parent's {_build.BUILD.path}")
        if any(lib != str(_build.BUILD.path) or built
               for lib, built in libs.values()) or len(libs) != 2:
            raise AssertionError(f"phase 45: the children's kernel library "
                                 f"{libs} is not the parent's "
                                 f"{_build.BUILD.path}, or one built it")
        clock = StepClock()
        clock.watch(router)
        t = time.perf_counter()
        got = serve_tier(router, reqs, "phase 45 fault-free")
        wall = time.perf_counter() - t
        _gate_streams("phase 45 process tier vs the single engine", None,
                      [p for _, p, _ in reqs], [got[r] for r, _, _ in reqs],
                      [ref[r] for r, _, _ in reqs])
        if len({router._reqs[r].owner_idx for r, _, _ in reqs}) != 2:
            raise AssertionError("phase 45: one child served everything")
        out["fault_free"] = _proc_gate(router, "phase 45 fault-free",
                                       counts_dir, before)
        heartbeat = max(5.0, 3.0 * clock.longest)
        command_s = max(60.0, 4.0 * heartbeat)
        router.supervisor.heartbeat_timeout_s = heartbeat
        router._launcher.command_timeout_s = command_s
        for rep in router._replicas:
            rep.engine.command_timeout_s = command_s
        out["fault_free"].update(wall_s=wall, longest_step_s=clock.longest,
                                 heartbeat_s=heartbeat,
                                 command_timeout_s=command_s)
        log(f"phase 45 fault-free: {json.dumps(out['fault_free'])}")
        lap("phase 45 (a) fault-free")

        # (g) a corrupted request frame of an idempotent RPC on a live child
        client = router._replicas[0].engine
        client.wire_faults = WireFaultInjector(corrupt_calls=[1, 3],
                                               target="idempotent")
        client.ping()
        client.metrics.snapshot()
        client.wire_faults = None
        st = dict(client.rpc_stats)
        if st["naks"] < 2 or st["retries"] < 2 or client.dead:
            raise AssertionError(f"phase 45: the corrupted frames were not "
                                 f"NAK'd and retried: {st}")
        out["corrupt_frame"] = st
        log(f"phase 45 corrupted frames: {json.dumps(st)}")

        # (b) SIGKILL of a child mid-stream: once the arm has delivered 64
        # tokens, the child with the most tokens still to deliver
        def mid_stream(act):
            base = router.metrics.tokens_delivered.value
            hit = []

            def run():
                deadline = time.perf_counter() + 300
                while (router.metrics.tokens_delivered.value < base + 64
                       and time.perf_counter() < deadline):
                    time.sleep(0.002)
                left = {}
                with router._lock:
                    for rec in router._reqs.values():
                        if not rec.done:
                            left[rec.owner_idx] = left.get(
                                rec.owner_idx, 0) + (rec.sampling.max_tokens
                                                     - len(rec.tokens))
                idx = max(left, key=left.get)
                hit.append((idx, left[idx],
                            router._replicas[idx].engine.proc))
                act(hit[-1][2])
            return run, hit

        def signalled(sig, label):
            run, hit = mid_stream(lambda proc: os.kill(proc.pid, sig))
            arm = [(f"{label[0]}{rid[1:]}", p, sp) for rid, p, sp in reqs]
            got = serve_tier(router, arm, f"phase 45 {label} arm",
                             during=run)
            _gate_streams(f"phase 45 {label} arm vs the fault-free arm",
                          None, [p for _, p, _ in arm],
                          [got[r] for r, _, _ in arm],
                          [ref[r] for r, _, _ in reqs])
            idx, left, proc = hit[0]
            if router._replicas[idx].engine.proc is proc:
                raise AssertionError(f"phase 45: the {label} child was "
                                     "reused")
            return {"victim": idx, "victim_tokens_left": left,
                    "victim_rc": proc.poll()}

        before = _child_launches(counts_dir)
        victim = signalled(signal.SIGKILL, "kill")
        out["sigkill"] = _proc_gate(router, "phase 45 SIGKILL arm",
                                    counts_dir, before, crashes=1,
                                    restarts=1)
        out["sigkill"].update(victim)
        mem["after_sigkill"], out["sigkill"]["free_wait_s"] = _await_free(
            "after the SIGKILL respawn", mem["after_spawns"] - one / 2)
        log(f"phase 45 SIGKILL arm: {json.dumps(out['sigkill'])}")
        lap("phase 45 (b) SIGKILL")

        # (c) SIGSTOP of a child mid-stream: hung, killed, respawned
        before = _child_launches(counts_dir)
        victim = signalled(signal.SIGSTOP, "hang")
        out["sigstop"] = _proc_gate(router, "phase 45 SIGSTOP arm",
                                    counts_dir, before, crashes=1, hangs=1,
                                    restarts=2)
        out["sigstop"].update(victim)
        mem["after_sigstop"], out["sigstop"]["free_wait_s"] = _await_free(
            "after the SIGSTOP respawn", mem["after_spawns"] - one / 2)
        log(f"phase 45 SIGSTOP arm: {json.dumps(out['sigstop'])}")
        lap("phase 45 (c) SIGSTOP")

        # (e) rolling_restart mid-stream
        before = _child_launches(counts_dir)
        free_before = _free_gib()
        old = [rep.engine.proc for rep in router._replicas]
        arm = [(f"r{rid[1:]}", p, sp) for rid, p, sp in reqs]
        rgot = serve_tier(router, arm, "phase 45 rolling restart",
                          during=mid_stream(
                              lambda proc: router.rolling_restart())[0])
        _gate_streams("phase 45 rolling restart vs the fault-free arm",
                      None, [p for _, p, _ in arm],
                      [rgot[r] for r, _, _ in arm],
                      [ref[r] for r, _, _ in reqs])
        out["rolling_restart"] = _proc_gate(
            router, "phase 45 rolling restart", counts_dir, before,
            crashes=1, hangs=1, restarts=4)
        m = router.metrics.snapshot()
        if (m["replica_drains"] != 2 or m["rolling_restarts"] != 1
                or any(p.poll() is None for p in old)):
            raise AssertionError(f"phase 45: rolling restart counts {m}, "
                                 "or an old child still runs")
        mem["after_rolling_restart"], wait = _await_free(
            "after rolling_restart", free_before - one)
        out["rolling_restart"].update(
            drains=m["replica_drains"], migrations=m["drain_migrations"],
            free_before_GiB=free_before,
            free_after_GiB=mem["after_rolling_restart"], free_wait_s=wait)
        log(f"phase 45 rolling restart: {json.dumps(out['rolling_restart'])}")
        lap("phase 45 (e) rolling restart")

        # (f) the journaled tier abandoned halfway, its children killed as
        # a dead router's would be, and recovered from the journal
        arm = [(f"j{rid[1:]}", p, sp) for rid, p, sp in reqs]
        done_before = router.outputs()
        half = (router.metrics.tokens_delivered.value
                + sum(sp.max_tokens for _, _, sp in arm) // 2)
        submit_waves(router, arm)
        deadline = time.perf_counter() + 300
        while (router.metrics.tokens_delivered.value < half
               and time.perf_counter() < deadline):
            time.sleep(0.002)
        for rep in router._replicas:
            rep.fenced = True
            rep.stop = True
            rep.wake.set()
        router.supervisor.stop()
        router._journal.close()
        for rep in router._replicas:
            rep.thread.join(60)
            rep.engine.kill()
        delivered = router.metrics.tokens_delivered.value
        unfinished = sum(not router._reqs[r].done for r, _, _ in arm)
        if not unfinished:
            raise AssertionError("phase 45: every request of the journal "
                                 "arm finished before the crash")
        tiers.remove(router)
        del router, rep, client
        _await_free("after the abandoned tier's children", mem[
            "before_spawns"] - one / 2)
        before = _child_launches(counts_dir)
        t = time.perf_counter()
        r2 = ServingRouter.recover(spec, journal, replicas=2,
                                   backend="process", journal_fsync="always",
                                   **dict(knobs, heartbeat_timeout_s=heartbeat,
                                          command_timeout_s=command_s))
        tiers.append(r2)
        recover_s = time.perf_counter() - t
        mem["after_recover"] = _free_gib()
        restored = r2.outputs()
        for rid, o in done_before.items():
            if restored[rid].output_tokens != o.output_tokens:
                raise AssertionError(f"phase 45: the finished output {rid} "
                                     "was not restored as it was")
        outs = r2.drain(timeout_s=600.0)
        names = [r for r, _, _ in arm]
        if any(outs[r].finish_reason != "length" for r in names):
            raise AssertionError("phase 45: a recovered request was lost or "
                                 "did not finish")
        _gate_streams("phase 45 recovered tier vs the fault-free arm", None,
                      [p for _, p, _ in arm],
                      [outs[r].output_tokens for r in names],
                      [ref[r] for r, _, _ in reqs])
        # a second wave through the recovered tier: both new children serve
        arm2 = [(f"v{rid[1:]}", p, sp) for rid, p, sp in reqs]
        vgot = serve_tier(r2, arm2, "phase 45 recovered tier, next wave")
        _gate_streams("phase 45 recovered tier's next wave vs the fault-free"
                      " arm", None, [p for _, p, _ in arm2],
                      [vgot[r] for r, _, _ in arm2],
                      [ref[r] for r, _, _ in reqs])
        out["recovered"] = _proc_gate(r2, "phase 45 recovered tier",
                                      counts_dir, before, recovered=True)
        rm = r2.metrics.snapshot()
        out["recovered"].update(
            delivered_before_crash=delivered,
            unfinished_at_crash=unfinished, restored_outputs=len(done_before), recover_s=recover_s,
            recovered_requests=rm["recovered_requests"],
            journal=r2.metrics_snapshot()["journal"])
        _release_check(r2, "phase 45 recovered tier")
        log(f"phase 45 recovered tier: {json.dumps(out['recovered'])}")
        r2.shutdown()
        tiers.remove(r2)
        del r2
        _await_free("after the recovered tier", mem["before_spawns"]
                    - one / 2)
        lap("phase 45 (f) journal recovery")

        # (d) prefill / decode split over the wire, fp32 then int8
        split_knobs = dict(knobs, heartbeat_timeout_s=heartbeat,
                           command_timeout_s=command_s)
        out["split_fp32"] = _process_split_arm(
            spec, split_knobs, reqs, ref, counts_dir, "fp32", "s")
        _await_free("after the fp32 split", mem["before_spawns"] - one / 2)
        out["split_int8"] = _process_split_arm(
            spec, split_knobs, reqs, refs["int8"], counts_dir, "int8", "i",
            kv_dtype="int8")
        lap("phase 45 (d) split")
    finally:
        for tier in tiers:
            tier.shutdown()
        spawns.close()
        rcs = spawns.reap_check()
        records = _child_records(counts_dir)
        shutil.rmtree(tmp, ignore_errors=True)
    mem["end"] = _free_gib()
    per_child = {pid: ({n: c[0] for n, c in r["counts"].items() if c[0]},
                       sum(c[1] for c in r["counts"].values()))
                 for pid, r in records.items()}
    log(f"phase 45: launches of each child (kernel, plain): "
        f"{json.dumps(per_child)}")
    paths = (set(_path_kernels("fp32")), set(_path_kernels("int8")))
    for pid, (k, plain) in per_child.items():
        if plain or set(k) not in paths:
            raise AssertionError(f"phase 45: child {pid} launched {k}, "
                                 f"plain {plain}; a child's path is one of "
                                 f"{paths}")
    out.update(per_child_launches={p: k for p, (k, _) in per_child.items()},
               spawn_to_ready_s=spawns.ready, children=len(rcs),
               children_rcs=rcs, mem_free_GiB=mem, one_child_GiB=one,
               seconds=time.perf_counter() - t0)
    log(f"phase 45: {len(rcs)} children spawned, every one reaped (exit "
        f"codes {rcs}); spawn to ready by child (s) "
        f"{json.dumps(spawns.ready)}; mem_get_info free GiB "
        f"{json.dumps(mem)}; {out['seconds']:.1f} s")
    return out


# ------------------------------------------- the host-wide KV store (46)

# phase 46's store: 512 pages of LLaMA-2-7B at 8 of its 32 layers (fp32,
# 4 MiB a page: 2 GiB), at most half of /dev/shm's free space; where that
# does not fit, fewer layers first (never a narrower page), then fewer
# pages, and never fewer than 64
STORE_PAGES, STORE_MIN_PAGES = 512, 64


def _shm_usage() -> dict:
    u = shutil.disk_usage("/dev/shm")
    return {"total": u.total, "used": u.used, "free": u.free}


def store_size(cfg, free: int):
    """(layers, pages, page bytes) of phase 46's store for ``free`` bytes of
    /dev/shm (STORE_PAGES' rule)."""
    def page_bytes(layers):
        return (2 * layers * ROUTER_KNOBS["block_size"] * cfg.num_kv_heads
                * (cfg.hidden_size // cfg.num_heads) * 4)
    for layers in (PROC_LAYERS, 4, 2, 1):
        if STORE_PAGES * page_bytes(layers) <= free // 2:
            return layers, STORE_PAGES, page_bytes(layers)
    pages = free // 2 // page_bytes(1)
    if pages < STORE_MIN_PAGES:
        raise AssertionError(
            f"phase 46: /dev/shm has {free} bytes free; half of it holds "
            f"{pages} pages of one layer, below {STORE_MIN_PAGES}")
    return 1, int(pages), page_bytes(1)


def _store_segments_exist(names):
    return [n for n in names if os.path.exists(f"/dev/shm/{n.lstrip('/')}")]


def _thread_store_arms(model, scfg, reqs, turns, ref, pages):
    """Phase 46 (a) and (b): thread replicas over one in-process store (no
    shared memory; pinned buffers). Returns the arms' numbers."""
    from paddle_tpu_torch.inference import create_serving_router
    from paddle_tpu_torch.serving import audit_store

    out = {}
    # (a) a rolling restart demotes both replicas' caches into the store;
    # the chats' second turns then resume from it on either replica
    counts = _zeroed_counts()
    router = create_serving_router(
        model, replicas=2, device="cuda", audit=True,
        heartbeat_timeout_s=600.0, shared_kv_pages=pages, **ROUTER_KNOBS)
    try:
        if router.kv_store.use_shm or router.kv_store.max_pages != pages:
            raise AssertionError("phase 46 (a): the thread tier's store is "
                                 "not an in-process one of "
                                 f"{pages} pages")
        got = serve_tier(router, reqs, "phase 46 (a)")
        _gate_streams("phase 46 (a) store-backed tier vs the single engine",
                      None, [p for _, p, _ in reqs],
                      [got[r] for r, _, _ in reqs],
                      [ref[r] for r, _, _ in reqs])
        router.rolling_restart()
        base = router.metrics_snapshot()["engines"]
        tgot = serve_tier(router, turns, "phase 46 (a) second turns")
        _gate_streams("phase 46 (a) second turns vs the single engine",
                      None, [p for _, p, _ in turns],
                      [tgot[r] for r, _, _ in turns],
                      [ref[r] for r, _, _ in turns])
        m = router.metrics_snapshot()["engines"]
        hits = m["store_hit_pages"] - base["store_hit_pages"]
        computed = m["prefill_tokens"] - base["prefill_tokens"]
        bs = ROUTER_KNOBS["block_size"]
        # the first turns' written pages: prompt and all but the last token
        covered = sum((len(p) + sp.max_tokens - 1) // bs
                      for _, p, sp in reqs if sp.session_id is not None)
        context = sum(len(p) for _, p, _ in turns)
        if hits < covered or computed != context - bs * hits:
            raise AssertionError(
                f"phase 46 (a): the second turns hit {hits} store pages of "
                f"the {covered} their first turns wrote and computed "
                f"{computed} of {context} tokens")
        audit_store(router.kv_store)
        numbers = gate_tier(router, "phase 46 (a)", counts, restarts=2)
        numbers.update(store_hit_pages=hits, turn2_prefill_tokens=computed,
                       turn2_context_tokens=context, covered_pages=covered,
                       store=router.kv_store.stats())
        out["threads_restart"] = numbers
        log(f"phase 46 (a) threads, rolling restart: {json.dumps(numbers)}")
    finally:
        router.shutdown()
        del router
        _free_the_card()
    lap("phase 46 (a) threads, store resume")

    # (b) the split tier hands off by slot reference
    counts = _zeroed_counts()
    rec = {}
    undo = store_timing(rec)
    router = create_serving_router(
        model, replicas=2, prefill_replicas=1, device="cuda", audit=True,
        heartbeat_timeout_s=600.0, shared_kv_pages=pages, **ROUTER_KNOBS)
    try:
        spy = HandoffSpy(router)
        t = time.perf_counter()
        got = serve_tier(router, reqs, "phase 46 (b)")
        wall = time.perf_counter() - t
        _gate_streams("phase 46 (b) slot-reference split vs the single "
                      "engine", None, [p for _, p, _ in reqs],
                      [got[r] for r, _, _ in reqs],
                      [ref[r] for r, _, _ in reqs])
        rm = router.metrics.snapshot()
        eng = router.metrics_snapshot()["engines"]
        n = len(reqs)
        if not (eng["handoffs_out"] == eng["handoffs_in"] == rm["handoffs"]
                == n and eng["handoff_recompute_fallbacks"] == 0
                and rm["handoff_fallbacks"] == 0
                and eng["handoff_bytes_out"] == 0
                and eng["store_dedup_pages"] > 0):
            raise AssertionError(
                f"phase 46 (b): handoffs {rm['handoffs']}, in "
                f"{eng['handoffs_in']}, recomputed "
                f"{eng['handoff_recompute_fallbacks']}, bytes "
                f"{eng['handoff_bytes_out']}, dedup refs "
                f"{eng['store_dedup_pages']}")
        if spy.checked != eng["handoff_pages_out"] or spy.sent:
            raise AssertionError(f"phase 46 (b): {spy.checked} pages checked "
                                 f"of {eng['handoff_pages_out']}")
        audit_store(router.kv_store)
        numbers = gate_tier(router, "phase 46 (b)", counts)
        numbers.update(wall_s=wall, handoffs=rm["handoffs"],
                       pages_checked=spy.checked,
                       handoff_bytes=eng["handoff_bytes_out"],
                       store_dedup_pages=eng["store_dedup_pages"],
                       store_hit_pages=eng["store_hit_pages"],
                       store=router.kv_store.stats(), **store_rates([rec]))
        out["threads_split"] = numbers
        log(f"phase 46 (b) threads, slot-reference split: "
            f"{json.dumps(numbers)}")
    finally:
        undo()
        router.shutdown()
        del router
        _free_the_card()
    handoff_ms, step_ms = handoff_device_ms(model, reqs, store_pages=pages)
    out["threads_split"].update(first_token_to_decode_ms=handoff_ms,
                                decode_step_ms=step_ms)
    log(f"phase 46 (b): first token on the prefill engine to the first "
        f"decode step on the decode engine over the store {handoff_ms:.3f} "
        f"device ms (phase 43 prints the private tiers' at this depth) "
        f"against a decode step {step_ms:.3f} device ms (not gated)")
    lap("phase 46 (b) threads, slot-reference split")
    return out


def store_tier_phase(cfg, reqs):
    """Phase 46: the host-wide KV store (see the module docstring): thread
    arms (a) and (b) over an in-process store, then (c) a split tier of two
    replica processes over a shared-memory store, (d) the SIGKILL of its
    decode child while it holds store refs and (e) the router's loss, on
    one journaled tier, and (f) the teardown's checks. Returns the
    numbers."""
    import signal
    import tempfile
    from dataclasses import asdict

    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.models import Llama
    from paddle_tpu_torch.serving import (
        ServingRouter, SharedKVStore, audit_store, wire,
    )
    from paddle_tpu_torch.serving.journal import RouterJournal

    t0 = time.perf_counter()
    shm_before = _shm_usage()
    mine = {n for n in os.listdir("/dev/shm") if n.startswith("psm_")}
    if mine:
        log(f"phase 46: /dev/shm holds {len(mine)} segments made before this "
            f"run (left alone): {sorted(mine)[:8]}")
    layers, pages, page_bytes = store_size(cfg, shm_before["free"])
    scfg = replace(cfg, num_layers=layers)
    out = {"layers": layers, "store_pages": pages, "page_bytes": page_bytes,
           "store_bytes": pages * page_bytes, "shm_before": shm_before}
    log(f"phase 46: /dev/shm {json.dumps(shm_before)} bytes; the store: "
        f"{pages} pages of {page_bytes} bytes ({layers} of "
        f"{cfg.num_layers} layers), {pages * page_bytes / 2**30:.2f} GiB")
    _free_the_card()
    mem_before, alloc_before = _free_gib(), torch.cuda.memory_allocated()
    # the reference: one engine on the same weights, both turns
    model = Llama(scfg, device="cuda", seed=0)
    single = create_serving_engine(model, device="cuda", **ROUTER_KNOBS)
    for rid, p, sp in reqs:
        single.add_request(p, sp, request_id=rid)
    ref = {k: o.output_tokens for k, o in single.run().items()}
    turns = second_turns(cfg, reqs, ref)
    for rid, p, sp in turns:
        single.add_request(p, sp, request_id=rid)
    ref.update({rid: single.run()[rid].output_tokens
                for rid, _, _ in turns})
    del single
    _free_the_card()
    lap("phase 46 reference engine")
    out.update(_thread_store_arms(model, scfg, reqs, turns, ref, pages))
    del model
    _free_the_card()

    tmp = tempfile.mkdtemp(prefix="store-tier-")
    counts_dir = f"{tmp}/counts"
    os.makedirs(counts_dir)
    journal = f"{tmp}/wal.jsonl"
    spec = {"factory": "chip_smoke:counted_runner_factory",
            "factory_kw": dict(model="llama", seed=0, block_size=16,
                               max_model_len=1024, device="cuda",
                               counts_dir=counts_dir, **asdict(scfg)),
            "sys_path": [str(Path(__file__).resolve().parent)]}
    geometry = {"num_layers": layers, "block_size": 16,
                "n_kv_heads": scfg.num_kv_heads,
                "head_dim": scfg.hidden_size // scfg.num_heads}
    engine_knobs = {k: v for k, v in ROUTER_KNOBS.items()
                    if k != "block_size"}
    knobs = dict(engine_knobs, audit=True, heartbeat_timeout_s=600.0,
                 command_timeout_s=600.0, rendezvous_timeout_s=300.0)
    store_kw = dict(prefill_replicas=1, shared_kv_pages=pages,
                    shared_kv_geometry=geometry)
    spawns = _SpawnLog()
    tiers, segments = [], []
    try:
        # (c) two children over the shared-memory store, split
        before = _child_launches(counts_dir)
        router = ServingRouter(spec, replicas=2, backend="process",
                               journal_path=journal, journal_fsync="always",
                               **store_kw, **knobs)
        tiers.append(router)
        store = router.kv_store
        segments = list(store.attach_spec()["segments"])
        if not store.use_shm or _store_segments_exist(segments) != segments:
            raise AssertionError(f"phase 46 (c): the store's segments "
                                 f"{segments} are not under /dev/shm")
        pre, dec = (rep.engine for rep in router._replicas)
        moved = {"page_bytes": 0, "frame_bytes": 0, "export_s": 0.0,
                 "import_s": 0.0}
        extract, imp = pre.extract_handoff, dec.import_handoff

        def extract_handoff(rid):
            t = time.perf_counter()
            state, payload = extract(rid)
            moved["export_s"] += time.perf_counter() - t
            if payload is not None:
                moved["page_bytes"] += sum(
                    int(a.nbytes) for layer in payload.get("layers", ())
                    for a in layer)
                header, frames = wire.handoff_to_wire(payload)
                moved["frame_bytes"] += len(json.dumps(header)) + sum(
                    int(f.nbytes) for f in frames)
            return state, payload

        def import_handoff(state, payload):
            t = time.perf_counter()
            try:
                return imp(state, payload)
            finally:
                moved["import_s"] += time.perf_counter() - t
        pre.extract_handoff, dec.import_handoff = extract_handoff, \
            import_handoff
        last_pre, first_dec = {}, {}
        deliver = router._deliver

        def timed_deliver(rep, epoch, events):
            now = time.perf_counter()
            for ev in events:
                if rep.role == "prefill":
                    last_pre[ev.request_id] = now
                else:
                    first_dec.setdefault(ev.request_id, now)
            return deliver(rep, epoch, events)
        router._deliver = timed_deliver
        clock = StepClock()
        clock.watch(router)
        arm = [(f"c{rid[1:]}", p, sp) for rid, p, sp in reqs]
        names = {r for r, _, _ in arm}
        t = time.perf_counter()
        got = serve_tier(router, arm, "phase 46 (c)")
        wall = time.perf_counter() - t
        _gate_streams("phase 46 (c) processes over the store vs the single "
                      "engine", None, [p for _, p, _ in arm],
                      [got[r] for r, _, _ in arm],
                      [ref[r] for r, _, _ in reqs])
        numbers = _proc_gate(router, "phase 46 (c)", counts_dir, before)
        rm = router.metrics.snapshot()
        eng = router.metrics_snapshot()["engines"]
        checked, landed = _handoff_crcs(counts_dir, names)
        n = len(arm)
        if not (eng["handoffs_out"] == eng["handoffs_in"] == rm["handoffs"]
                == landed == n and eng["handoff_recompute_fallbacks"] == 0
                and rm["handoff_fallbacks"] == 0
                and eng["handoff_bytes_out"] == 0
                and moved["page_bytes"] == 0
                and checked == eng["handoff_pages_in"] > 0):
            raise AssertionError(
                f"phase 46 (c): handoffs {rm['handoffs']}, landed {landed}, "
                f"recomputed {eng['handoff_recompute_fallbacks']}, fallbacks "
                f"{rm['handoff_fallbacks']}, page bytes {moved['page_bytes']}"
                f", pages checked {checked} of {eng['handoff_pages_in']}")
        if any(o.replicas[:2] != [0, 1] for o in router.outputs().values()):
            raise AssertionError("phase 46 (c): a request did not enter on "
                                 "the prefill child and end on the decode "
                                 "child")
        gaps = sorted(first_dec[r] - last_pre[r] for r in names
                      if r in first_dec and r in last_pre)
        rates = store_rates(r.get("store", {}) for r in
                            _child_records(counts_dir).values())
        numbers.update(
            wall_s=wall, handoffs=rm["handoffs"], pages_checked=checked,
            handoff_page_bytes=moved["page_bytes"],
            handoff_frame_bytes=moved["frame_bytes"],
            export_s=moved["export_s"], import_s=moved["import_s"],
            prefill_to_decode_token_s={"median": statistics.median(gaps),
                                       "max": gaps[-1], "n": len(gaps)},
            store_hit_pages=eng["store_hit_pages"],
            store_dedup_pages=eng["store_dedup_pages"],
            store=store.stats(), **rates)
        heartbeat = max(5.0, 3.0 * clock.longest)
        command_s = max(60.0, 4.0 * heartbeat)
        router.supervisor.heartbeat_timeout_s = heartbeat
        router._launcher.command_timeout_s = command_s
        for rep in router._replicas:
            rep.engine.command_timeout_s = command_s
        numbers.update(longest_step_s=clock.longest, heartbeat_s=heartbeat,
                       command_timeout_s=command_s)
        out["processes_split"] = numbers
        log(f"phase 46 (c) processes over the shm store: "
            f"{json.dumps(numbers)}")
        log(f"phase 46 (c): the handoff frames carried "
            f"{moved['frame_bytes']} bytes for {rm['handoffs']:.0f} handoffs "
            f"(phase 45: 1.93 GB of pages over the wire); store RPCs per "
            f"handoff {rates['store_rpcs_per_handoff']:.1f}; spill "
            f"{rates['spill_GBps']} GB/s, page-in {rates['pagein_GBps']} "
            "GB/s (host clock, pageable shared memory)")
        lap("phase 46 (c) processes, slot-reference split")

        # (d) SIGKILL of the decode child while it holds store refs
        before = _child_launches(counts_dir)
        reap = {}
        orig_reap = router._reap_store_owner

        def checked_reap(rep):
            # the reap and the index around it under the store's lock:
            # no other op interleaves
            with store._lock:
                idx = dict(store._prefix)
                freed = orig_reap(rep)
                kept = all(store._prefix.get(h) == s
                           and s not in store._free for h, s in idx.items())
                reap.setdefault("reaps", []).append(
                    {"owner": rep.store_owner, "freed": freed,
                     "index_entries": len(idx), "index_kept": kept,
                     "owner_left": sum(rep.store_owner in o for o in
                                       store._owners.values())})
            return freed
        router._reap_store_owner = checked_reap
        victim = {}

        def kill_holding_refs():
            rep = router._replicas[1]
            key, proc = rep.engine.key, rep.engine.proc
            deadline = time.perf_counter() + 300
            while time.perf_counter() < deadline:
                if any(key in o for o in store.owners_snapshot().values()):
                    os.kill(proc.pid, signal.SIGSTOP)
                    held = sum(o.get(key, 0) for o in
                               store.owners_snapshot().values())
                    if held:
                        victim.update(key=key, refs=held, pid=proc.pid)
                        os.kill(proc.pid, signal.SIGKILL)
                        return
                    os.kill(proc.pid, signal.SIGCONT)
                time.sleep(0.001)
            raise AssertionError("phase 46 (d): the decode child never held "
                                 "a store ref")
        arm = [(f"k{rid[1:]}", p, sp) for rid, p, sp in reqs]
        kgot = serve_tier(router, arm, "phase 46 (d)",
                          during=kill_holding_refs)
        _gate_streams("phase 46 (d) after the SIGKILL vs the single engine",
                      None, [p for _, p, _ in arm],
                      [kgot[r] for r, _, _ in arm],
                      [ref[r] for r, _, _ in reqs])
        numbers = _proc_gate(router, "phase 46 (d)", counts_dir, before,
                             crashes=1, restarts=1)
        mine_reaps = [r for r in reap.get("reaps", ())
                      if r["owner"] == victim["key"]]
        audit_store(store, {rep.store_owner for rep in router._replicas})
        if (len(mine_reaps) != 1 or not mine_reaps[0]["index_kept"]
                or mine_reaps[0]["owner_left"]
                or any(victim["key"] in o
                       for o in store.owners_snapshot().values())
                or store.free_count + store.used_count != pages
                or _store_segments_exist(segments) != segments):
            raise AssertionError(f"phase 46 (d): reaps {reap}, victim "
                                 f"{victim}, segments "
                                 f"{_store_segments_exist(segments)}")
        numbers.update(victim=victim, reap=mine_reaps[0],
                       store=store.stats())
        out["processes_sigkill"] = numbers
        log(f"phase 46 (d) SIGKILL of the decode child holding store refs: "
            f"{json.dumps(numbers)}")
        lap("phase 46 (d) processes, SIGKILL")

        # (e) the router lost halfway; recover reattaches the segments and
        # revives the journaled index, minus an entry corrupted here
        arm = [(f"j{rid[1:]}", p, sp) for rid, p, sp in reqs]
        half = (router.metrics.tokens_delivered.value
                + sum(sp.max_tokens for _, _, sp in arm) // 2)
        submit_waves(router, arm)
        deadline = time.perf_counter() + 300
        while (router.metrics.tokens_delivered.value < half
               and time.perf_counter() < deadline):
            time.sleep(0.002)
        for rep in router._replicas:
            rep.fenced = True
            rep.stop = True
            rep.wake.set()
        router.supervisor.stop()
        for rep in router._replicas:
            rep.thread.join(60)
        router._journal.close()
        router._store_server.close()
        for rep in router._replicas:
            rep.engine.kill()
        unfinished = sum(not router._reqs[r].done for r, _, _ in arm)
        state, _ = RouterJournal.replay(journal)
        entries = [e for e in (state.get("store_idx") or {}).get(
            "prefix", ()) if store.content_hash(e[1]) == e[3]]
        if not entries or not unfinished:
            raise AssertionError(f"phase 46 (e): {len(entries)} journaled "
                                 f"index entries, {unfinished} requests "
                                 "unfinished at the crash")
        vh, vs = entries[0][0], entries[0][1]
        store.bufs[0][0][vs] += 1.0            # the segment's bytes
        tiers.remove(router)
        store.close(unlink=False)              # the dead router's mapping
        del router, store, pre, dec, rep
        restored = []
        orig_restore = SharedKVStore.restore_index

        def restore_index(st, idx_state):
            n = orig_restore(st, idx_state)
            restored.append((n, st.has_prefix(vh),
                             list(st._segment_names)))
            return n
        SharedKVStore.restore_index = restore_index
        before = _child_launches(counts_dir)
        try:
            t = time.perf_counter()
            r2 = ServingRouter.recover(
                spec, journal, replicas=2, backend="process",
                journal_fsync="always", **store_kw,
                **dict(knobs, heartbeat_timeout_s=heartbeat,
                       command_timeout_s=command_s))
        finally:
            SharedKVStore.restore_index = orig_restore
        tiers.append(r2)
        recover_s = time.perf_counter() - t
        if restored != [(len(entries) - 1, False, segments)]:
            raise AssertionError(
                f"phase 46 (e): restore_index {restored[:1]}, expected "
                f"{len(entries) - 1} of {len(entries)} entries revived over "
                f"the segments {segments}, the corrupted one dropped")
        outs = r2.drain(timeout_s=600.0)
        names = [r for r, _, _ in arm]
        if any(outs[r].finish_reason != "length" for r in names):
            raise AssertionError("phase 46 (e): a recovered request was lost "
                                 "or did not finish")
        _gate_streams("phase 46 (e) recovered tier vs the single engine",
                      None, [p for _, p, _ in arm],
                      [outs[r].output_tokens for r in names],
                      [ref[r] for r, _, _ in reqs])
        numbers = _proc_gate(r2, "phase 46 (e)", counts_dir, before,
                             recovered=True)
        if r2.kv_store.has_prefix(vh) and r2.kv_store._prefix[vh] == vs \
                and r2.kv_store.slot_hash(vs) != r2.kv_store.content_hash(vs):
            raise AssertionError("phase 46 (e): the corrupted slot serves")
        numbers.update(journaled_entries=len(entries),
                       revived_entries=restored[0][0], recover_s=recover_s,
                       unfinished_at_crash=unfinished,
                       recovered_requests=r2.metrics.snapshot()[
                           "recovered_requests"], store=r2.kv_store.stats())
        _release_check(r2, "phase 46 (e)")
        out["processes_recovered"] = numbers
        log(f"phase 46 (e) router loss and recover: {json.dumps(numbers)}")
        r2.shutdown()
        tiers.remove(r2)
        del r2
        lap("phase 46 (e) processes, router loss")
    finally:
        for tier in tiers:
            tier.shutdown()
        spawns.close()
        rcs = spawns.reap_check()
        records = _child_records(counts_dir)
        shutil.rmtree(tmp, ignore_errors=True)
        SharedKVStore.unlink_spec({"segments": segments})
    # (f) the teardown: no segment of the phase's, /dev/shm's space back,
    # every child reaped, the card's memory back: no tensor of the phase
    # left, and the free memory within 1 GiB (the CUDA context's and the
    # libraries' workspaces for the streams and kernels the phase used
    # first; a child holds 9.2 GiB)
    left = _store_segments_exist(segments)
    shm_after = _shm_usage()
    _free_the_card()
    alloc_after = torch.cuda.memory_allocated()
    free_after, _ = _await_free("at the end", mem_before - 1.0,
                                phase="phase 46")
    if (left or shm_after["free"] < shm_before["free"] - page_bytes
            or alloc_after > alloc_before):
        raise AssertionError(f"phase 46 (f): segments left {left}, /dev/shm "
                             f"free {shm_after['free']} after, "
                             f"{shm_before['free']} before; allocated "
                             f"{alloc_after} bytes after, {alloc_before} "
                             "before")
    per_child = {pid: ({n: c[0] for n, c in r["counts"].items() if c[0]},
                       sum(c[1] for c in r["counts"].values()))
                 for pid, r in records.items()}
    path = set(_path_kernels("fp32"))
    for pid, (k, plain) in per_child.items():
        if plain or set(k) != path:
            raise AssertionError(f"phase 46: child {pid} launched {k}, "
                                 f"plain {plain}; the path is {path}")
    out.update(shm_after=shm_after, segments=segments, children=len(rcs),
               children_rcs=rcs, mem_free_GiB={"before": mem_before,
                                               "after": free_after},
               allocated_bytes={"before": alloc_before,
                                "after": alloc_after},
               per_child_launches={p: k for p, (k, _) in per_child.items()},
               seconds=time.perf_counter() - t0)
    log(f"phase 46: /dev/shm {json.dumps(shm_after)} bytes after "
        f"({json.dumps(shm_before)} before); {len(rcs)} children spawned, "
        f"every one reaped (exit codes {rcs}); no segment left of "
        f"{segments}; mem_get_info free {mem_before:.2f} GiB before, "
        f"{free_after:.2f} after; {out['seconds']:.1f} s")
    lap("phase 46")
    return out


# --------------------------------------- tensor-parallel serving (47)

# the ratio of fp32 to int8 wire bytes of a row of 4096 (or 16000) values:
# one code byte each plus a 4-byte scale per 128-value chunk
QCOMM_REDUCTION = 4 / (1 + 4 / 128)
# phase 47 (b)'s accuracy gate of int8 comm against the fp32 sharded
# runner at 8 layers, teacher-forced (read 0.9647 / 0.0326 on the H100),
# and the least max|dlogit| / max|logit| of a step, at 10 x TOL (the fp32
# sharded runner's own gate), that shows the int8 reduction ran
QCOMM_TOP5_MIN, QCOMM_DLOGIT_MAX = 0.9, 0.05
QCOMM_PARTS_MIN = 10 * TOL


def card_mesh(tp):
    """A (data=1, model=tp) serving mesh of tp shards on card 0."""
    from paddle_tpu_torch.serving import serving_mesh
    return serving_mesh(1, tp, devices=[torch.device("cuda", 0)] * tp)


class HeadSpy:
    """The kv heads of every pool slice K1 and K2 are called on (the
    names the runner calls; a graph replay makes no call), restored by
    close()."""

    def __init__(self):
        import paddle_tpu_torch.serving.model_runner as mr
        self.mr = mr
        self.orig = (mr.ragged_paged_attention, mr.paged_decode_attention)
        self.heads = {"K1": set(), "K2": set()}

        def spy(name, fn):
            def call(q, k_pool, *a, **kw):
                self.heads[name].add(int(k_pool.shape[2]))
                return fn(q, k_pool, *a, **kw)
            return call
        mr.ragged_paged_attention = spy("K1", self.orig[0])
        mr.paged_decode_attention = spy("K2", self.orig[1])

    def close(self):
        self.mr.ragged_paged_attention, self.mr.paged_decode_attention = \
            self.orig


def _runner_logits(runners, prompt, steps, feed_from=0):
    """Teacher-forced logits of ``runners`` (each over a pool of its own
    mesh, eagerly): a prefill of ``prompt`` then ``steps`` decode steps,
    each fed runners[feed_from]'s argmax. Returns per runner the list of
    fp32 logits [V]."""
    from paddle_tpu_torch.serving import KVCachePool
    P = -(-(len(prompt) + steps) // 16)
    out, state = [], []
    for r in runners:
        pool = KVCachePool(r.num_layers, P + 1, 16, r.n_kv_heads,
                           r.head_dim, r.dtype, mesh=r.mesh,
                           model_axis=r.model_axis, device="cuda",
                           kv_dtype=r.kv_dtype)
        table = pool.pad_table(pool.allocator.alloc(P), P)
        graphs, r.graphs = r.graphs, False
        lg, pools = r.prefill(prompt, table, pool.shards)
        out.append([lg.float().clone()])
        state.append((pool, table, pools, graphs))
    for i in range(steps):
        tok = int(torch.argmax(out[feed_from][-1]))
        pos = np.asarray([len(prompt) + i], np.int32)
        for j, r in enumerate(runners):
            pool, table, pools, graphs = state[j]
            lg, pools = r.decode(np.asarray([tok], np.int32),
                                 np.asarray(table, np.int32)[None], pos,
                                 pools)
            out[j].append(lg[0].float().clone())
            state[j] = (pool, table, pools, graphs)
    for r, (_, _, _, graphs) in zip(runners, state):
        r.graphs = graphs
    return out


def _teacher_forced(ref, quant, prompt, steps=16):
    """``quant``'s logits against ``ref``'s over ``ref``'s greedy stream:
    the mean top-5 overlap, the mean |dlogit|, the mean |logit| and the
    least step's max|dlogit| over its max|logit|."""
    lf = _runner_logits([ref, quant], prompt, steps)
    return {"top5": float(np.mean([
                len(set(torch.topk(a, 5).indices.tolist())
                    & set(torch.topk(b, 5).indices.tolist())) / 5.0
                for a, b in zip(*lf)])),
            "mean_abs_dlogit": float(np.mean([(a - b).abs().mean().item()
                                              for a, b in zip(*lf)])),
            "mean_abs_logit": float(np.mean([a.abs().mean().item()
                                             for a in lf[0]])),
            "min_step_rel": min((a - b).abs().max().item()
                                / a.abs().max().item()
                                for a, b in zip(*lf))}


def qcomm_card_check(gen):
    """quantized_psum / quantized_allgather on card tensors against the
    numpy references, bit for bit: tp 2 and 4, chunks 4 and 128, widths
    4096 and 130 (which 128 does not divide)."""
    from paddle_tpu_torch.quantization import qcomm
    cases = 0
    for tp in (2, 4):
        for chunk in (4, 128):
            for width in (4096, 130):
                parts = [torch.randn(8, width, device="cuda", generator=gen)
                         * 10.0 ** (i - 1) for i in range(tp)]
                host = [p.cpu().numpy() for p in parts]
                for fn, ref in (
                        (qcomm.quantized_psum,
                         qcomm.quantized_allreduce_reference),
                        (qcomm.quantized_allgather,
                         qcomm.quantized_allgather_reference)):
                    got = fn(parts, chunk=chunk)
                    want = ref(host, chunk=chunk)
                    for g in got:
                        if not np.array_equal(g.cpu().numpy(), want):
                            raise AssertionError(
                                f"phase 47: {fn.__name__} on the card at tp "
                                f"{tp}, chunk {chunk}, width {width} is not "
                                "bit-equal to its numpy reference")
                    cases += 1
    return cases


def _step_ms(runner, chunk_tokens, decode_rows, reps=5):
    """Device and wall ms of one 256-token prefill chunk (eager) and of one
    decode step of ``decode_rows`` sequences (a graph replay after its
    capture) on ``runner`` over a pool of its mesh: medians of ``reps``
    after two warm-ups. Returns (chunk, decode) dicts."""
    from paddle_tpu_torch.serving import KVCachePool
    P = 64
    pool = KVCachePool(runner.num_layers, decode_rows * P + 1, 16,
                       runner.n_kv_heads, runner.head_dim, runner.dtype,
                       mesh=runner.mesh, model_axis=runner.model_axis,
                       device="cuda")
    tables = [pool.pad_table(pool.allocator.alloc(P), P)
              for _ in range(decode_rows)]
    pools = pool.shards

    def timed(fn):
        dev, wall = [], []
        for i in range(reps + 2):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            if i >= 2:
                wall.append(1e3 * (time.perf_counter() - t))
                dev.append(start.elapsed_time(end))
        return {"device_ms": statistics.median(dev),
                "wall_ms": statistics.median(wall)}

    chunk = timed(lambda: runner.prefill_chunk(chunk_tokens, 256, tables[0],
                                               pools))
    toks = np.ones(decode_rows, np.int32)
    tabs = np.asarray(tables, np.int32)
    pos = np.full(decode_rows, 300, np.int32)
    decode = timed(lambda: runner.decode(toks, tabs, pos, pools))
    return chunk, decode


def tp_phase(model, cfg, q_model, q_cfg, fp32_tokens, positions):
    """Phase 47: tensor-parallel serving of LLaMA-2-7B (full width) on
    serving_mesh(1, tp, devices=[cuda:0] * tp), the shards' weights views
    of the model's. (a) fp32 at tp = 2 and full depth, phase 4's traffic
    and weights: the engine's tokens equal its runner's naive_generate on
    two requests (phase 4's gate), the streams phase 4's where not parting
    at a token whose top-2 margin lies within TOL of max|logit| (the
    unsharded runner's), a prefill's and two decode steps' logits within
    TOL of max|logit| of the unsharded runner's, per-shard pool bytes half
    the pool's, K1 and K2 launched once a layer a shard on every call at
    16 kv heads and no plain version. (b) comm_dtype="int8" on the same
    weights: both wire-byte reductions 4 / (1 + 4/128), a one-slot
    engine's tokens equal to its runner's naive_generate on the two
    shortest prompts (phase 6's rule for quantized arms),
    quantized_psum / quantized_allgather on the card bit-equal to the
    numpy references; the teacher-forced top-5 overlap and mean |dlogit|
    against the fp32 sharded runner at 32 layers (reported) and at 8
    (gated: QCOMM_TOP5_MIN, QCOMM_DLOGIT_MAX), every step's logits parting
    from the fp32 runner's by more than QCOMM_PARTS_MIN of max|logit| at
    both depths. (c) bf16 compute over an int8 pool at tp = 2, 8 of
    32 layers: bf16-q K1-q once a layer a shard (both forms), the scale
    pools split; the streams a single-device bf16 / int8 engine's where
    not parting at a token whose top-2 margin lies within GATHER_TOL[bf16]
    of max|logit|; a one-slot engine token-exact against naive_generate.
    (d) fp32 at tp = 4, 8 of 32 layers: a decode-horizon engine (its
    decode kinds CUDA graphs over 4 shards) with the host tier, phase
    40's traffic under phase 40's gates (every paged-in page's CRC, read
    back in the logical layout, equal to its spilled page's and the
    tier's hash); a snapshot of it restored onto a tp = 2 runner finishes
    its streams (the margin rule at TOL). Then the device and wall ms of a
    chunk and a decode step at tp 1 / 2 / 4 at that depth, the
    reductions' share of the decode step (each reduction timed alone at
    its shape), K1 and K2 at the per-shard head count. Returns the
    numbers."""
    from paddle_tpu_torch.inference import (
        create_serving_engine, restore_serving_engine,
    )
    from paddle_tpu_torch.parallel import psum
    from paddle_tpu_torch.quantization.qcomm import quantized_psum
    from paddle_tpu_torch.serving import LlamaRunner

    t0 = time.perf_counter()
    out = {}
    mesh2, mesh4 = card_mesh(2), card_mesh(4)
    ref = LlamaRunner(model, 16, 4096)        # the unsharded runner
    # (a) fp32 at tp = 2, full depth
    spy = HeadSpy()
    try:
        eng, launches, _, tokens, prompts, forms = engine_phase(
            model, cfg, gate_naive=True, mesh=mesh2)
    finally:
        spy.close()
    runner = eng.runner
    shard_heads = cfg.num_kv_heads // 2 if cfg.num_kv_heads else \
        cfg.num_heads // 2
    if spy.heads != {"K1": {shard_heads}, "K2": {shard_heads}}:
        raise AssertionError(f"phase 47 (a): K1 / K2 called on pool slices "
                             f"of {spy.heads} kv heads, not {shard_heads}")
    pool = eng.pool
    if pool.per_shard_memory_bytes() != pool.memory_bytes() // 2 or any(
            a.shape[2] != shard_heads for shard in pool.shards
            for layer in shard for a in layer):
        raise AssertionError("phase 47 (a): the pool is not split in two "
                             "halves of the kv heads")
    views = all(sp[n].untyped_storage().data_ptr()
                == v.untyped_storage().data_ptr()
                for n, v in runner.params.items()
                for sp in runner._shard_params)
    if not views:
        raise AssertionError("phase 47 (a): a shard's weight is a copy")
    parted = [_gate_twin(f"phase 47 (a) request {i} vs phase 4", ref,
                         prompts[i], a, b, TOL)
              for i, (a, b) in enumerate(zip(tokens, fp32_tokens))]
    a_logits = _runner_logits([ref, runner], prompts[0][:300], 2)
    rel = max((x - y).abs().max().item() / x.abs().max().item()
              for x, y in zip(*a_logits))
    if not rel <= TOL:
        raise AssertionError(f"phase 47 (a): sharded logits part from the "
                             f"unsharded runner's by {rel:.3e} of max|logit|")
    caps = [(c["kind"], round(c["seconds"], 3)) for c in runner.captures]
    out["a"] = {"launches": launches, "by_form": forms, "parted": parted,
                "logits_rel": rel, "heads": shard_heads,
                "per_shard_gib": pool.per_shard_memory_bytes() / 2**30,
                "pool_gib": pool.memory_bytes() / 2**30, "captures": caps}
    log(f"phase 47 (a) fp32 tp=2, {cfg.num_layers} layers: "
        f"{json.dumps(out['a'])}")
    del eng, pool
    runner._graph_cache.clear()
    _free_the_card()
    lap("phase 47 (a) fp32 tp=2")
    # (b) int8 comm on the same weights
    eng, q_launches, _, q_tokens, _, _ = engine_phase(
        model, cfg, mesh=mesh2, comm_dtype="int8", report_naive=False,
        ref_tokens=tokens)
    snap = eng.metrics.snapshot()
    reductions = {k: snap[k] for k in ("tp_comm_bytes_reduction_x",
                                       "tp_gather_bytes_reduction_x")}
    if any(abs(x - QCOMM_REDUCTION) > 1e-9 for x in reductions.values()):
        raise AssertionError(f"phase 47 (b): wire-byte reductions "
                             f"{reductions}, not {QCOMM_REDUCTION}")
    qrunner = eng.runner
    del eng
    _free_the_card()
    # token-exact against naive_generate as phase 6 gates its quantized
    # pools: one slot, each prompt in one chunk (naive_generate's row
    # counts; a batch's rounding moves an int8 code, and a moved code a
    # token, at these widths)
    single_slot_check(model, cfg, "fp32", sorted(prompts, key=len)[:2],
                      mesh=mesh2, comm_dtype="int8")
    _free_the_card()
    # teacher-forced accuracy against the fp32 sharded runner, at full
    # depth (reported: the quantization error of the reductions adds up
    # over depth, PERF.md §6) and at 8 layers (gated); at both, every
    # step's logits part from the fp32 runner's by more than rounding, so
    # an int8 runner that ran the fp32 reduction fails
    accuracy = {cfg.num_layers: _teacher_forced(runner, qrunner,
                                                prompts[1][:300])}
    del qrunner
    _free_the_card()
    accuracy[q_cfg.num_layers] = _teacher_forced(
        LlamaRunner(q_model, 16, 4096).shard(mesh2),
        LlamaRunner(q_model, 16, 4096).shard(mesh2, comm_dtype="int8"),
        prompts[1][:300])
    tf8 = accuracy[q_cfg.num_layers]
    if not (tf8["top5"] >= QCOMM_TOP5_MIN
            and tf8["mean_abs_dlogit"] <= QCOMM_DLOGIT_MAX):
        raise AssertionError(
            f"phase 47 (b): int8 comm at {q_cfg.num_layers} layers reads "
            f"top-5 {tf8['top5']:.4f} (gate >= {QCOMM_TOP5_MIN}), mean "
            f"|dlogit| {tf8['mean_abs_dlogit']:.4f} (gate <= "
            f"{QCOMM_DLOGIT_MAX}) against the fp32 sharded runner")
    parts = {k: a["min_step_rel"] for k, a in accuracy.items()}
    if min(parts.values()) <= QCOMM_PARTS_MIN:
        raise AssertionError(
            f"phase 47 (b): an int8-comm step's logits lie within "
            f"{QCOMM_PARTS_MIN} of max|logit| of the fp32 runner's "
            f"(least step by depth: {parts}): the int8 reduction did not "
            "run")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(47)
    cases = qcomm_card_check(gen)
    out["b"] = {"launches": q_launches, **reductions,
                "teacher_forced": accuracy,
                "qcomm_cases_bit_equal": cases,
                "tp_comm_bytes": snap["tp_comm_bytes"],
                "tp_gather_bytes": snap["tp_gather_bytes"]}
    log(f"phase 47 (b) int8 comm tp=2: {json.dumps(out['b'])}")
    del a_logits
    _free_the_card()
    lap("phase 47 (b) int8 comm")
    # (c) bf16 over an int8 pool at tp = 2, 8 layers
    base, _, _, c_ref, c_prompts, _ = engine_phase(
        q_model, q_cfg, "int8", dtype=BF16, report_naive=False)
    c_runner = base.runner
    del base
    _free_the_card()
    eng, c_launches, _, c_tokens, _, c_forms = engine_phase(
        q_model, q_cfg, "int8", dtype=BF16, report_naive=False, mesh=mesh2)
    if any(s[0][2].shape != (eng.pool.num_blocks, shard_heads)
           for s in eng.pool.shards):
        raise AssertionError("phase 47 (c): the scale pools are not split")
    del eng
    _free_the_card()
    c_parted = [_gate_twin(f"phase 47 (c) request {i} vs one device",
                           c_runner, c_prompts[i], a, b, GATHER_TOL[BF16])
                for i, (a, b) in enumerate(zip(c_tokens, c_ref))]
    del c_runner
    single_slot_check(q_model, q_cfg, "int8", sorted(c_prompts,
                                                     key=len)[:2],
                      dtype=BF16, mesh=mesh2)
    _free_the_card()
    out["c"] = {"launches": c_launches, "by_form": c_forms,
                "parted": c_parted}
    log(f"phase 47 (c) bf16 / int8 pool tp=2, {q_cfg.num_layers} layers: "
        f"{json.dumps(out['c'])}")
    lap("phase 47 (c) bf16 int8 pool")
    # (d) fp32 at tp = 4, 8 layers: horizons as graphs, the host tier, a
    # snapshot restored onto tp = 2
    d_prompts, sp = tier_requests(q_cfg)
    eng, d_tokens, run = tier_arm(q_model, q_cfg, "(d) tp=4", d_prompts,
                                  sp, phase="phase 47", mesh=mesh4,
                                  decode_horizon=8)
    kinds = sorted({c["kind"] for c in eng.runner.captures})
    if "decode_multi" not in kinds:
        raise AssertionError(f"phase 47 (d): no horizon graph ({kinds})")
    d_caps = [(c["kind"], round(c["seconds"], 3), c["pool_bytes"])
              for c in eng.runner.captures]
    d_shard = eng.pool.per_shard_memory_bytes()
    del eng
    _free_the_card()
    snap_eng = create_serving_engine(q_model, device="cuda", audit=True,
                                     mesh=mesh4, decode_horizon=8,
                                     **TIER_KNOBS)
    ids = [snap_eng.add_request(p, sp) for p in d_prompts]
    for _ in range(12):
        snap_eng.step()
    state = json.loads(json.dumps(snap_eng.snapshot()))
    del snap_eng
    _free_the_card()
    restored = restore_serving_engine(q_model, state, mesh=mesh2,
                                      device="cuda", audit=True)
    if restored.runner.tp_size != 2 or state["config"]["mesh_axes"] != {
            "data": 1, "model": 4}:
        raise AssertionError("phase 47 (d): the restore did not move the "
                             "snapshot of tp=4 onto tp=2")
    restored.run()
    outs = restored.outputs()
    del restored
    _free_the_card()
    d_ref = LlamaRunner(q_model, 16, 1024)
    d_parted = [_gate_twin(f"phase 47 (d) restored request {i}", d_ref,
                           d_prompts[i], outs[rid].output_tokens,
                           d_tokens[i], TOL)
                for i, rid in enumerate(ids)]
    out["d"] = {"tier": run, "captures": d_caps, "restored_parted": d_parted,
                "per_shard_gib": d_shard / 2**30}
    log(f"phase 47 (d) fp32 tp=4, {q_cfg.num_layers} layers: "
        f"{json.dumps(out['d'])}")
    lap("phase 47 (d) tp=4 tier and restore")
    # step times at tp 1 / 2 / 4 (8 layers), the reductions alone, K1 / K2
    # at the per-shard heads
    rng = np.random.default_rng(47)
    chunk = rng.integers(1, q_cfg.vocab_size, 256).tolist()
    steps = {}
    for tp in (1, 2, 4):
        r = LlamaRunner(q_model, 16, 1024)
        if tp > 1:
            r.shard(card_mesh(tp))
        c, d = _step_ms(r, chunk, 8)
        steps[tp] = {"chunk": c, "decode": d,
                     "capture_s": [round(x["seconds"], 3)
                                   for x in r.captures]}
        del r
        _free_the_card()
    H = q_cfg.hidden_size
    n_red = 2 * q_cfg.num_layers + 1
    share = {}
    for tp in (2, 4):
        for label, rows in (("chunk", 256), ("decode", 8)):
            parts = [torch.randn(rows, H, device="cuda", generator=gen)
                     for _ in range(tp)]
            fp = median_ms(lambda: psum(parts))
            q8 = median_ms(lambda: quantized_psum(parts))
            step = steps[tp][label]["device_ms"]
            share[f"tp{tp}_{label}"] = {
                "psum_ms": fp, "quantized_psum_ms": q8,
                "reductions": n_red, "fp32_share": n_red * fp / step,
                "int8_share": n_red * q8 / step}
    shard_k = {"K1_chunk": measure_ragged(gen, cfg.num_heads // 2, 1024,
                                          256, "fp32"),
               "K2_decode": measure_paged(gen, cfg.num_heads // 2, 1024,
                                          256, positions)}
    out["steps"], out["reduction_share"] = steps, share
    out["shard_kernels"] = {k: {x: v[x] for x in (
        "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "max_abs_err") if x in v} for k, v in shard_k.items()}
    log(f"phase 47 step ms at {q_cfg.num_layers} layers by tp: "
        f"{json.dumps(steps)}")
    log(f"phase 47 reductions timed alone, share of the step's device "
        f"time: {json.dumps(share)}")
    log(f"phase 47 K1 / K2 at the per-shard head count: "
        f"{json.dumps(out['shard_kernels'])}")
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 47: {out['seconds']:.1f} s")
    lap("phase 47 timings")
    return out


# ------------------------ phase 48: the Paddle-style Tensor and _C_ops

# the card against the CPU in the op sweep: CUDA's transcendental functions
# round differently from the CPU's by a few ulp and its reductions sum in
# another order, so the sweep holds the card to rtol 1e-4, atol 1e-5 (or
# the case's own looser tolerance)
SWEEP_TOL = (1e-4, 1e-5)
# the layers through _C_ops against the port's models on the same weights:
# the same ops in the same dtypes (fp32, or bf16 O1 casts), so the gates
# are tight; the measured gaps are printed
LAYER_TOL = {"fp32": 1e-5, "bf16": 1e-2}


def _tests_path():
    """The repo's tests/ on sys.path: the op sweep's case table and the
    layers written with _C_ops live there (they import no jax)."""
    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)


def _init_linears(block, gen):
    with torch.no_grad():
        for mod in block.modules():
            if hasattr(mod, "std") and hasattr(mod, "weight"):
                mod.weight.normal_(0.0, mod.std, generator=gen)


def _rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@contextlib.contextmanager
def _no_library_attention():
    """Fail on any call of torch's scaled_dot_product_attention."""
    import torch.nn.functional as F
    real = F.scaled_dot_product_attention

    def refuse(*args, **kwargs):
        raise AssertionError("phase 48 reached torch's "
                             "scaled_dot_product_attention")
    F.scaled_dot_product_attention = refuse
    try:
        yield
    finally:
        F.scaled_dot_product_attention = real


def _layer_arm(label, block, layer, x, extra, ref_fn, masked, dtype, gen,
               amp_level=None, head_dim=128):
    """One layer written with _C_ops on port Tensors over ``block``'s
    weights: forward and loss.backward() with the flash counts zeroed
    before and read after (each kernel of the form once, no plain version,
    no other form, never torch's SDPA), then the same forward and backward
    through the module, and the output and every weight gradient held
    against it."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops import flash_attention as fa

    def cast_ctx():
        return (amp.auto_cast(level=amp_level, dtype="bfloat16")
                if amp_level else contextlib.nullcontext())

    t0 = time.perf_counter()
    params = {n: P.Tensor(w.detach().clone(), stop_gradient=False)
              for n, w in block.named_parameters()}
    w = torch.randn(x.shape, generator=gen, device="cuda")
    fa.reset_counts()
    with _no_library_attention():
        with cast_ctx():
            out = layer(P, P.Tensor(x), params, *extra)
        (out * P.Tensor(w)).sum().backward()
    torch.cuda.synchronize()
    counts = _flash_counts(masked, dtype)
    others = _other_flash_launches(masked, dtype)
    if counts != {name: (1, 0) for name in counts} or others:
        raise AssertionError(f"phase 48 {label}: flash launches "
                             f"(kernel, plain) {counts}, {others} of "
                             "other forms or plain; want each kernel once")
    variants = (_variant_launches(f"phase 48 {label}", masked, dtype,
                                  head_dim, 1)
                if dtype != torch.float32 else None)
    seconds = time.perf_counter() - t0
    with cast_ctx():
        ref = ref_fn(x)
    (ref * w).sum().backward()
    err = _rel_err(out._value, ref)
    grads = {n: _rel_err(params[n].grad._value, wt.grad)
             for n, wt in block.named_parameters()}
    tol = LAYER_TOL["fp32" if amp_level is None else "bf16"]
    worst = max(grads.values())
    log(f"phase 48 {label}: output rel err {err:.3g}, worst weight-grad "
        f"rel err {worst:.3g} ({max(grads, key=grads.get)}) against the "
        f"model's block (gate {tol:g}); flash launches "
        f"{ {n: c[0] for n, c in counts.items()} }"
        + (f" by variant {variants}" if variants else "")
        + f", no plain, no SDPA; {seconds:.2f} s")
    if not (err <= tol and worst <= tol):
        raise AssertionError(f"phase 48 {label}: the _C_ops layer parts "
                             f"from the model's block ({err}, {grads})")
    for t in params.values():
        t.clear_grad()
    block.zero_grad(set_to_none=True)
    return {"launches": {n: c[0] for n, c in counts.items()},
            "out_rel_err": err, "grad_rel_err": worst, "seconds": seconds}


def _op_sweep(P):
    """The CPU tests' case table through the port on CUDA Tensors against
    the same ops on CPU Tensors: forward values, dtypes and shapes, and
    the inputs' gradients of differentiable ops; the random ops by dtype,
    shape, determinism under seed and moments against the CPU's draws."""
    _tests_path()
    import _torch_op_cases as oc
    problems = []
    t0 = time.perf_counter()
    n = 0
    for case in oc.CASES:
        n += 1
        try:
            if case.rng:
                P.set_device("gpu")
                P.seed(5)
                got = oc.draw(P, case)
                P.seed(5)
                again = oc.draw(P, case)
                P.set_device("cpu")
                ref = oc.draw(P, case)
                if not np.array_equal(got[2], again[2]):
                    problems.append((case.id, "not determined by seed"))
                if not oc.moments_agree(ref, got):
                    problems.append((case.id, f"draws {got[:2]} mean "
                                     f"{got[2].mean()} std {got[2].std()} "
                                     f"vs the CPU's {ref[:2]} "
                                     f"{ref[2].mean()} {ref[2].std()}"))
                continue
            P.set_device("gpu")
            got = oc.run(P, case)
            P.set_device("cpu")
            ref = oc.run(P, case)
            rtol, atol = case.tol or (oc.RTOL, oc.ATOL)
            bad = oc.compare(ref, got, max(rtol, SWEEP_TOL[0]),
                             max(atol, SWEEP_TOL[1]))
            if bad:
                problems.append((case.id, bad))
        except Exception as e:          # noqa: BLE001 (every case reported)
            problems.append((case.id, f"{type(e).__name__}: {e}"[:300]))
    P.set_device("gpu")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    log(f"phase 48 op sweep: {n} cases of {len({c.op for c in oc.CASES})} "
        f"ops on CUDA tensors against CPU tensors (values, dtypes, shapes, "
        f"gradients; rng ops by moments), {len(problems)} failed, "
        f"{seconds:.1f} s")
    for case_id, why in problems:
        log(f"phase 48 op sweep FAILED {case_id}: {why}")
    if problems:
        raise AssertionError(f"phase 48: {len(problems)} op-sweep cases "
                             "failed on the card")
    return {"cases": n, "seconds": seconds}


def framework_phase():
    """Phase 48: the Paddle-style Tensor and its op surface on the card."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.models import ERNIE3_BASE, LLAMA2_7B
    from paddle_tpu_torch.models.ernie import ErnieBlock
    from paddle_tpu_torch.models.llama import LlamaBlock, rope_tables
    _tests_path()
    from _framework_layers import ernie_layer, llama_layer

    t0 = time.perf_counter()
    P.set_device("gpu")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(48)
    res = {}
    cfg = LLAMA2_7B
    s, d = 4096, cfg.hidden_size // cfg.num_heads
    block = LlamaBlock(cfg, torch.device("cuda"))
    _init_linears(block, gen)
    x = torch.randn(1, s, cfg.hidden_size, generator=gen, device="cuda")
    cos, sin = rope_tables(s, d, cfg.rope_theta, device="cuda")
    extra = (P.Tensor(cos), P.Tensor(sin), cfg.num_heads, cfg.rms_eps)
    res["llama_fp32"] = _layer_arm(
        "(a) LLaMA-2-7B layer fp32 [1, 4096]", block, llama_layer, x, extra,
        block, False, torch.float32, gen)
    res["llama_bf16_o1"] = _layer_arm(
        "(b) LLaMA-2-7B layer bf16 O1 [1, 4096]", block, llama_layer, x,
        extra, block, False, torch.bfloat16, gen, amp_level="O1")
    del block, x, extra, cos, sin
    _free_the_card()
    e_cfg = ERNIE3_BASE
    block = ErnieBlock(e_cfg, torch.device("cuda"), gen)
    _init_linears(block, gen)
    x = torch.randn(16, 512, e_cfg.hidden_size, generator=gen,
                    device="cuda")
    mask = (1.0 - _padded(gen, 16, 512)[:, None, None, :].float()) * -1e4
    res["ernie_fp32"] = _layer_arm(
        "(c) ERNIE-3.0-base layer fp32 16 x 512 padded", block, ernie_layer,
        x, (P.Tensor(mask), e_cfg.num_heads, block.ln1.epsilon),
        lambda v: block(v, attn_mask=mask), True, torch.float32, gen)
    del block, x, mask
    _free_the_card()
    res["sweep"] = _op_sweep(P)
    res["seconds"] = time.perf_counter() - t0
    log(f"phase 48 seconds: {res['seconds']:.1f}")
    log("phase 48 launches: " + json.dumps(
        {arm: res[arm]["launches"] for arm in ("llama_fp32",
                                               "llama_bf16_o1",
                                               "ernie_fp32")}))
    return res


def _free_the_card() -> float:
    """Collect what the freed phases left; returns GiB still allocated."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 2**30


# (BM, BN) of the backward kernels' instantiations (Bwd<MAXD> in
# csrc/flash_attention.cu), for their dynamic shared memory at d = MAXD
BWD_TILES = {64: (128, 32), 128: (128, 32), 256: (64, 16)}


def _kernel_label(mangled: str) -> str:
    """'flash_bwd_dq_kernel<128>' or 'ragged_span_kernel<128,1>' from a
    mangled entry name: its length-prefixed name that ends in _kernel,
    with the integer template arguments after it. Every position of a
    digit run is tried, since a length may follow the digits of an
    anonymous namespace's hash ('...a219flash_bwd_dq_kernelILi128E...'),
    and the last name found wins: the kernel's is the innermost part of
    the nested name, while a hash that ends in digits can read as the
    length of a longer span that also ends in _kernel."""
    found = None
    for m in re.finditer(r"(?=(\d+))", mangled):
        at = m.start() + len(m.group(1))
        name = mangled[at:at + int(m.group(1))]
        if name.endswith("_kernel") and name.isidentifier():
            found = at, name
    if found is None:
        return mangled
    at, name = found
    # template arguments: integers (Li128E) and the element types of the
    # serving kernels (f: float, 13__nv_bfloat16, 6__half), as 'f32',
    # 'bf16' and 'f16'
    types = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}
    args = re.match(r"I((?:Li\d+E|f|13__nv_bfloat16|6__half)+)E",
                    mangled[at + len(name):])
    if not args:
        return name
    return name + "<" + ",".join(
        a or types[t] for a, t in re.findall(
            r"Li(\d+)E|(f|13__nv_bfloat16|6__half)", args.group(1))) + ">"


# the kernels that multiply on the tensor cores, and every instantiation
# of them the build must hold (the ragged span form's second argument is
# the pool type: 0 fp32, 1 int8, 2 fp8, 3 bf16, 4 fp16, its third q's
# type: fp32 q over fp32, int8 and fp8 pools at d <= 128 and 256, bf16 q
# over bf16, int8 and fp8 pools and fp16 q over fp16, int8 and fp8 pools
# at d <= 256 only, RAGGED_SPAN_TYPES; 16-bit q's span form for d <= 128
# is ragged_span_bf16_kernel<pool type> or ragged_span_f16_kernel<pool
# type>): the three bf16 and the three fp16 kernels run on wgmma at d <=
# 128 (flash_attention_wgmma.cu) and keep their mma.sync kernels for d <=
# 256 only
WGMMA_KERNELS = tuple(names[1] for by in HALF_KERNEL_NAMES.values()
                      for names in by.values())
# K1's 16-bit-q span forms on wgmma (d <= 128)
RAGGED_WGMMA_KERNELS = ("ragged_span_bf16_kernel", "ragged_span_f16_kernel")
# kernels whose SASS must hold wgmma's HGMMA: the bf16 and fp16 flash
# kernels on wgmma and K1's 16-bit-q span forms
HGMMA_KERNELS = (*WGMMA_KERNELS, *RAGGED_WGMMA_KERNELS)
# kernels whose ptxas report must show no spill: the wgmma kernels (their
# accumulators would go through local memory) and K1's 16-bit-q forms
NO_SPILL_KERNELS = (*WGMMA_KERNELS, *RAGGED_WGMMA_KERNELS,
                    "ragged_decode_split_kernel", "ragged_decode_row_kernel",
                    "ragged_decode_split_f16_kernel",
                    "ragged_decode_row_f16_kernel")
# the mma.sync kernels of the 16-bit forms (d > 128)
HALF_MMA_KERNELS = tuple(names[0] for by in HALF_KERNEL_NAMES.values()
                         for names in by.values())
TENSOR_CORE_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                       "flash_bwd_dkv_kernel", *HALF_MMA_KERNELS,
                       *WGMMA_KERNELS, "ragged_span_kernel",
                       *RAGGED_WGMMA_KERNELS)
RAGGED_SPAN_TYPES = ((0, "f32"), (1, "f32"), (2, "f32"), (3, "bf16"),
                     (1, "bf16"), (2, "bf16"), (4, "f16"), (1, "f16"),
                     (2, "f16"))
TENSOR_CORE_INSTANTIATIONS = (
    *(f"{k}<{d}>" for k in TENSOR_CORE_KERNELS[:3] for d in (64, 128, 256)),
    *(f"{k}<256>" for k in HALF_MMA_KERNELS),
    *(f"{k}<{d}>" for k in WGMMA_KERNELS for d in (64, 128)),
    *(f"ragged_span_kernel<{d},{kv},{qt}>" for d in (128, 256)
      for kv, qt in RAGGED_SPAN_TYPES if d == 256 or qt == "f32"),
    *(f"ragged_span_{qt}_kernel<{kv}>" for kv, qt in RAGGED_SPAN_TYPES
      if qt != "f32"))


def build_report(build) -> None:
    """Phase 2's report: each kernel entry's registers and spills (ptxas;
    a wgmma kernel or a 16-bit-q form of K1 that spills fails the run:
    NO_SPILL_KERNELS), the backward kernels' shared memory per
    instantiation, and whether the SASS of every tensor-core kernel (the
    three flash kernels, the 16-bit wgmma kernels, the ragged span forms)
    holds tensor-core instructions in every instantiation (HMMA:
    mma.sync, HGMMA: wgmma; the wgmma kernels and the 16-bit span forms
    HGMMA), from cuobjdump -sass
    of the built library; one without them, or missing, fails the run."""
    if not build.log:
        log("  ptxas: the library was built by an earlier process (its "
            "register report is in that build's log)")
    name, spilled = None, {}
    for ln in build.log.splitlines():
        if "Compiling entry function" in ln:
            name = _kernel_label(ln.split("'")[1])
        elif name and ("registers" in ln or "spill" in ln):
            log(f"  ptxas {name}: {ln.split(':', 1)[-1].strip()}")
            if "spill" in ln and name.startswith(NO_SPILL_KERNELS):
                spilled[name] = re.findall(r"(\d+) bytes spill", ln) \
                    != ["0", "0"]
        if "C7512" in ln:   # ptxas serialized a kernel's wgmma
            log(f"  ptxas: {ln.strip()}")
    if any(spilled.values()):
        raise AssertionError(f"a kernel that must not spill spills "
                             f"registers: {spilled}")
    for maxd, (bm, bn) in BWD_TILES.items():
        ld = (maxd + 31) // 32 * 32
        base = (2 * bm + 4 * bn) * ld + 8 * 16 * 32
        log(f"  shared memory at d = {maxd}: flash_bwd_dq_kernel<{maxd}> "
            f"{4 * base} B, flash_bwd_dkv_kernel<{maxd}> "
            f"{4 * (base + 4 * bn)} B (BM {bm}, BN {bn})")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(build.path)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        log(f"  SASS: cuobjdump not usable ({e}); tensor-core use unchecked")
        return
    found = {}
    for section in sass.split("Function : ")[1:]:
        label = _kernel_label(section.split("\n", 1)[0].strip())
        if label.startswith(TENSOR_CORE_KERNELS):
            found[label] = (section.count("HMMA"), section.count("HGMMA"))
            log(f"  SASS {label}: {found[label][0]} HMMA, "
                f"{found[label][1]} HGMMA instructions")
    if set(found) != set(TENSOR_CORE_INSTANTIATIONS) or not all(
            (n[1] if label.startswith(HGMMA_KERNELS) else sum(n)) > 0
            for label, n in found.items()):
        raise AssertionError(f"a tensor-core kernel's SASS holds no "
                             f"tensor-core products (a wgmma kernel no "
                             f"HGMMA), or an instantiation is missing: "
                             f"{found}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    try:
        from paddle_tpu_torch.models import ERNIE3_BASE, LLAMA2_7B, Llama
        from paddle_tpu_torch.ops import _build
        from paddle_tpu_torch.serving import LlamaRunner
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from the "
              "root of a checkout", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 matmuls (AMP) sum in fp32 throughout, as XLA's do: no bf16
    # rounding of cuBLAS's split-K partial sums
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False

    t_start = time.perf_counter()
    card = gpu_line()
    log(f"device: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    _LAP_CLOCK[0] = t_start
    _build.library()
    log(f"build: {_build.BUILD.seconds:.1f} s -> {_build.BUILD.path.name}")
    build_report(_build.BUILD)
    lap("build")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = {"ragged_paged_attention": max(check_ragged(32, 32, gen, "MHA"),
                                          check_ragged(32, 8, gen, "GQA"))}
    for kind in ("int8", "fp8"):
        errs[f"ragged_paged_attention_{kind}"] = max(
            check_ragged(32, 32, gen, "MHA decode", kind, SPANS_DECODE),
            check_ragged(32, 32, gen, "MHA chunk", kind, SPANS_CHUNK),
            check_ragged(32, 8, gen, "GQA", kind))
    errs["paged_decode_attention"] = check_paged(gen)
    # phase 31's kernels at the Llama shapes: bf16 q over bf16 pools
    # (K1-bf16), over int8 / fp8 pools (K1-q), and K2-bf16; each result
    # (max abs error, fp64 ratio, misround share)
    bf16_checks = {}
    for kind in ("bf16", "int8", "fp8"):
        bf16_checks[_half_name("ragged_paged_attention", kind)] = [
            check_ragged(32, 32, gen, "MHA decode", kind, SPANS_DECODE,
                         half=BF16),
            check_ragged(32, 32, gen, "MHA chunk", kind, SPANS_CHUNK,
                         half=BF16),
            check_ragged(32, 8, gen, "GQA", kind, half=BF16),
            check_ragged(32, 8, gen, "GQA-4 decode across splits", kind,
                         SPANS_SPLITS, half=BF16),
            check_ragged(16, 16, gen, "verify spans", kind, SPANS_VERIFY,
                         half=BF16)]
        check_ragged_invariance(gen, kind)              # GQA-4: mma
        check_ragged_invariance(gen, kind, n_kv=32)     # MHA: one row
        check_ragged_graph(gen, kind)
    bf16_checks["paged_decode_attention_bf16"] = [check_paged(gen,
                                                              half=BF16)]
    for name, res in bf16_checks.items():
        errs[name] = max(r[0] for r in res)
    lap("serving kernels vs plain, Llama shapes (bf16 variants: phase 31)")
    # phase 37: the fp16 variants at the same shapes and at d = 256 (the
    # tf32 span form and the unsplit decode form on 16-bit q), their
    # decode form's batch invariance and graph replay, and K1's range
    # cases at fp16. Phases 37-39 draw their inputs from a stream of their
    # own, so the phases that run before and after them keep their inputs
    gen16 = torch.Generator(device="cuda")
    gen16.manual_seed(37)
    f16_checks = {}
    for kind in ("fp16", "int8", "fp8"):
        f16_checks[_half_name("ragged_paged_attention", kind, F16)] = [
            check_ragged(32, 32, gen16, "MHA decode", kind, SPANS_DECODE,
                         half=F16),
            check_ragged(32, 32, gen16, "MHA chunk", kind, SPANS_CHUNK,
                         half=F16),
            check_ragged(32, 8, gen16, "GQA", kind, half=F16),
            check_ragged(32, 8, gen16, "GQA-4 decode across splits", kind,
                         SPANS_SPLITS, half=F16),
            check_ragged(16, 16, gen16, "verify spans", kind, SPANS_VERIFY,
                         half=F16),
            check_ragged(16, 4, gen16, "d=256 chunk", kind, SPANS_CHUNK,
                         half=F16, d=256),
            check_ragged(16, 4, gen16, "d=256 GQA-4 decode", kind,
                         SPANS_DECODE, half=F16, d=256)]
        check_ragged_invariance(gen16, kind, half=F16)
        check_ragged_invariance(gen16, kind, n_kv=32, half=F16)
        check_ragged_graph(gen16, kind, half=F16)
    f16_checks["paged_decode_attention_fp16"] = [check_paged(gen16,
                                                             half=F16)]
    range_cases = {
        f"{case} {n_rep}x{T} d={d}": check_ragged_range(gen16, case, n_rep,
                                                        T, d=d)
        for case in RAGGED_RANGE_CASES for d in (128, 256)
        for n_rep, T in ((1, 1), (4, 2), (1, 300), (4, 64))}
    for name, res in f16_checks.items():
        errs[name] = max(r[0] for r in res)
    # how far phase 37 moves a stream: F16's "stream after phase 37" is the
    # smoke's own stream moved on by this much
    phase37_draws = gen16.get_offset()
    lap("phase 37: fp16 serving kernels vs plain, Llama shapes, range")
    sampler_phase()
    lap("sampler")

    cfg = LLAMA2_7B
    model = Llama(cfg, device="cuda", seed=0)
    eng, launches, positions, fp32_tokens, _, forms = engine_phase(model,
                                                                   cfg)
    profile_phase(eng, cfg)
    del eng
    _free_the_card()
    lap("Llama fp32 engine and profile")
    greedy_stops = [t[20] for t in fp32_tokens[:4]]
    graphs_phase(model, cfg, "fp32")
    _free_the_card()
    horizon_launches = {
        "paged_decode_attention": horizon_phase(model, cfg, "fp32",
                                                greedy_stops)}
    gemm_row_invariance(gen)
    lap("Llama fp32 graphs and horizons")
    # the int8 / fp8 pools at 8 of LLaMA-2-7B's 32 layers (full width):
    # phase 45 took the smoke ~140 s longer, and these phases' launches a
    # layer, graph replays, horizons and one-slot checks need no depth
    q8_cfg = replace(cfg, num_layers=8)
    q8 = Llama(q8_cfg, device="cuda", seed=0)
    for kind in ("int8", "fp8"):
        eng, more, _, q_tokens, prompts, more_forms = engine_phase(
            q8, q8_cfg, kind)
        launches.update(more)
        forms.update(more_forms)
        profile_phase(eng, q8_cfg)
        del eng
        _free_the_card()
        graphs_phase(q8, q8_cfg, kind)
        _free_the_card()
        horizon_launches[f"ragged_paged_attention_{kind}"] = horizon_phase(
            q8, q8_cfg, kind, [t[20] for t in q_tokens[:4]])
        # the two shortest prompts fit one 256-token chunk
        single_slot_check(q8, q8_cfg, kind, sorted(prompts, key=len)[:2])
        _free_the_card()
    del q8
    _free_the_card()
    lap("Llama int8 / fp8 engines, graphs, horizons, one-slot")
    # phases 28-29: the shared-prefix page cache and fused ragged steps
    t_new = time.perf_counter()
    prefix_forms = prefix_phase(model, cfg)
    _free_the_card()
    ragged = ragged_phase(model, cfg, fp32_tokens)
    log(f"phases 28-29: {time.perf_counter() - t_new:.1f} s")
    _free_the_card()
    lap("phases 28-29")
    # phases 33 and 32 on the fp32 model, then phase 31 on the same model
    # cast to bf16 in place (its fp32 weights freed)
    t_new = time.perf_counter()
    mixed = mixed_pool_phase(model, cfg)
    _free_the_card()
    lap("phase 33")
    # phase 32 at 8 of LLaMA-2-7B's 32 layers (full width): phases 37-39
    # took the smoke 84 s longer, and the ladder's bytes and one-slot checks
    # need no depth
    ladder_cfg = replace(cfg, num_layers=8)
    ladder_model = Llama(ladder_cfg, device="cuda", seed=0)
    ladder = weight_ladder_phase(ladder_model, ladder_cfg)
    del ladder_model
    _free_the_card()
    lap("phase 32")
    model.to(torch.bfloat16)
    log(f"phase 31: the model cast to bf16, "
        f"{_free_the_card():.2f} GiB allocated")
    bf16_path, bf16_forms = half_serving_phase(model, cfg)
    launches.update(bf16_path)
    forms.update(bf16_forms)
    log(f"phases 31-33: {time.perf_counter() - t_new:.1f} s; weight bytes "
        f"reduction by rung {json.dumps(ladder)}")
    lap("phase 31 engines")
    # phases 38-39 on the same model cast to fp16 in place: the fp16
    # engines, then the weight ladder and the mixed pool at fp16
    t_new = time.perf_counter()
    model.to(F16)
    log(f"phase 38: the model cast to fp16, "
        f"{_free_the_card():.2f} GiB allocated")
    f16_path, f16_forms = half_serving_phase(model, cfg, F16)
    launches.update(f16_path)
    forms.update(f16_forms)
    lap("phase 38 engines")
    # phase 39 (Llama) at 8 of LLaMA-2-7B's 32 layers (full width), cast to
    # fp16 as the full model was: phases 40-41 took the smoke ~55 s longer,
    # and the ladder's bytes, its one-slot checks and the mixed pool's
    # tenants need no depth
    del model
    _free_the_card()
    l39_cfg = replace(cfg, num_layers=8)
    l39 = Llama(l39_cfg, device="cuda", seed=0).to(F16)
    ladder16 = f16_ladder_phase(l39, l39_cfg, sorted(prompts, key=len)[:2])
    mixed16 = mixed_pool_phase(l39, l39_cfg, dtype=F16)
    log(f"phases 38-39 (Llama): {time.perf_counter() - t_new:.1f} s; "
        f"weight bytes reduction by rung at fp16 {json.dumps(ladder16)}")
    del l39
    _free_the_card()
    lap("phase 39 ladder and mixed pool")
    # phases 40-41: the host KV tier, snapshot / restore and stream_text on
    # LLaMA-2-7B in fp32 again (the same seed's random weights); the int8
    # arm at 8 of 32 layers
    t_new = time.perf_counter()
    model = Llama(cfg, device="cuda", seed=0)
    q_cfg = replace(cfg, num_layers=8)
    q_model = Llama(q_cfg, device="cuda", seed=0)
    tier, tier_tokens, tier_prompts, tier_runner = host_tier_phase(
        model, cfg, q_model, q_cfg)
    _free_the_card()
    lap("phase 40")
    tier["snapshot"] = snapshot_phase(model, cfg, tier_tokens, tier_prompts,
                                      tier_runner)
    del tier_runner
    _free_the_card()
    lap("phase 41")
    log(f"phases 40-41: {time.perf_counter() - t_new:.1f} s")
    # phase 47: tensor-parallel serving on the same weights (phase 4's
    # seed) at full depth, then at phase 40's int8 arm's 8 layers
    tp = tp_phase(model, cfg, q_model, q_cfg, fp32_tokens, positions)
    _free_the_card()
    # phases 42-44: the serving tier over phase 40's int8 arm's model, 8 of
    # LLaMA-2-7B's 32 layers (fp32, its weights shared by every replica):
    # phase 46 took the smoke's time, and the tier's gates (streams,
    # failures, memory, handoff bytes) need no depth
    t_new = time.perf_counter()
    del model
    _free_the_card()
    stier, stier_ref, stier_reqs, stier_runner = tier_phase(q_model, q_cfg)
    stier["disagg"] = disagg_phase(q_model, q_cfg, stier_reqs)
    stier["durability"] = durability_phase(q_model, q_cfg, stier_ref,
                                           stier_reqs, stier_runner)
    del q_model, stier_runner
    _free_the_card()
    log(f"phases 42-44: {time.perf_counter() - t_new:.1f} s")
    # phase 45: the tier over replica processes at 8 of 32 layers, phase
    # 42's traffic; the card holds no model of this process meanwhile
    ptier = process_tier_phase(cfg, stier_reqs)
    lap("phase 45")
    # phase 46: the host-wide KV store at 8 of 32 layers, phase 42's
    # traffic and second turns: thread replicas, then replica processes
    # over shared memory
    store_tier = store_tier_phase(cfg, stier_reqs)
    small = Llama(replace(cfg, num_layers=2), device="cuda", seed=2)
    for kind in ("int8", "fp8"):
        quant_model_check(small, LlamaRunner, kind, {
            f"ragged_paged_attention_{kind}": (20, {"span": 4,
                                                    "decode": 16})})
    lap("Llama 2-layer int8 / fp8 vs gather path")
    twin = {dt: half_twin_check(small, "LLaMA-2-7B width", dt)
            for dt in (BF16, F16)}
    gather = {dt: half_gather_check(small, LlamaRunner, "LLaMA-2-7B width",
                                    dtype=dt) for dt in (BF16, F16)}
    del small
    _free_the_card()
    lap("phases 31 and 38 2-layer twin and gather-path checks")

    P = 4096 // 16
    decode = (positions, [1] * len(positions), 1)
    meas = {}
    for kind in ("fp32", "int8", "fp8"):
        name = ("ragged_paged_attention" if kind == "fp32"
                else f"ragged_paged_attention_{kind}")
        meas[name] = measure_ragged(gen, cfg.num_heads, 1024, P, kind)
        # the decode form at the engine's decode positions, MHA; over fp32
        # pools also at GQA n_rep 4 (8 kv heads), the decode form's other
        # caller (the fp32 MHA engine decodes through K2)
        dec = measure_ragged(gen, cfg.num_heads, 1024, P, kind, decode)
        if kind == "fp32":
            gqa = measure_ragged(gen, cfg.num_heads, 1024, P, kind, decode,
                                 n_kv=cfg.num_heads // 4)
            meas[name]["decode_mha_fp64_ratio"] = dec["fp64_ratio"]
            dec = gqa
        meas[name]["decode"] = dec
        meas[name]["max_abs_err"] = max(meas[name]["max_abs_err"],
                                        dec["max_abs_err"])
    meas["paged_decode_attention"] = measure_paged(gen, cfg.num_heads, 1024,
                                                   P, positions)
    # the bf16 variants (phase 31) and the fp16 ones (phase 37) at the
    # same shapes: the chunk and the decode step (over 16-bit pools the
    # decode form at GQA n_rep 4: MHA decode takes K2 of that dtype), K2 at
    # the engine's decode positions; and K1's d = 256 forms at 16 heads of
    # 256 (the tf32 span form, the unsplit decode form at GQA n_rep 4),
    # timed by no record before
    for half, pool, g in ((BF16, "bf16", gen), (F16, "fp16", gen16)):
        for kind in (pool, "int8", "fp8"):
            name = _half_name("ragged_paged_attention", kind, half)
            meas[name] = measure_ragged(g, cfg.num_heads, 1024, P, kind,
                                        half=half)
            meas[name]["decode"] = measure_ragged(
                g, cfg.num_heads, 1024, P, kind, decode, half=half,
                n_kv=cfg.num_heads // 4 if kind == pool else None)
        name = f"paged_decode_attention_{HALF_SUFFIX[half]}"
        meas[name] = measure_paged(g, cfg.num_heads, 1024, P, positions,
                                   half=half)
    d256 = {half: {"chunk": measure_ragged(gen16, 16, 1024, P, pool,
                                           half=half, d=256),
                   "decode": measure_ragged(gen16, 16, 1024, P, pool,
                                            decode, n_kv=4, half=half,
                                            d=256)}
            for half, pool in ((BF16, "bf16"), (F16, "fp16"))}
    for name, res in (*bf16_checks.items(), *f16_checks.items()):
        m = meas[name]
        parts = [m] + ([m["decode"]] if "decode" in m else [])
        m["fp64_ratio"] = max([r[1] for r in res]
                              + [t["fp64_ratio"] for t in parts])
        m["misround"] = max([r[2] for r in res]
                            + [t["misround"] for t in parts])
        m["max_abs_err"] = max(t["max_abs_err"] for t in parts)
    # K1 at the shapes of this slice's paths: phase 29's fused step (one
    # live 256-token chunk beside 7 decode rows, T = 256, span form) and
    # phase 30's verify spans at GPT-3 1.3B's 16 heads (1-5 live rows in
    # the 8-row bucket, decode form)
    new_shapes = {"fused_step": measure_ragged(gen, cfg.num_heads, 1024, P,
                                               "fp32", SPANS_FUSED),
                  "verify_span": measure_ragged(gen, 16, 1024, P, "fp32",
                                                SPANS_VERIFY)}
    half_verify = {half: measure_ragged(g, 16, 1024, P, pool, SPANS_VERIFY,
                                        half=half)
                   for half, pool, g in ((BF16, "bf16", gen),
                                         (F16, "fp16", gen16))}
    log(f"serving kernel timings on {card}")
    lap("serving kernel timings (bf16 variants: phase 31, fp16: phase 37)")
    rows = []
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "fp64_ratio", "misround")
    k1_src = "paddle_tpu_torch/csrc/ragged_paged_attention.cu"
    # 16-bit q: the span form for d <= 128 and the split walk (the entry
    # points and d > 128's span form stay in k1_src)
    k1b_src = "paddle_tpu_torch/csrc/ragged_paged_attention_bf16.cu"
    k1_tpu = "paddle_tpu/ops/pallas/ragged_paged_attention.py:142"
    k2_src = "paddle_tpu_torch/csrc/paged_decode_attention.cu"
    k2_tpu = "paddle_tpu/ops/pallas/paged_attention.py:92"
    for name, src, replaces in (
            ("ragged_paged_attention", k1_src, k1_tpu),
            ("ragged_paged_attention_int8", k1_src, k1_tpu),
            ("ragged_paged_attention_fp8", k1_src, k1_tpu),
            ("paged_decode_attention", k2_src, k2_tpu),
            ("ragged_paged_attention_bf16", k1b_src, k1_tpu),
            ("ragged_paged_attention_bf16_int8", k1b_src, k1_tpu),
            ("ragged_paged_attention_bf16_fp8", k1b_src, k1_tpu),
            ("paged_decode_attention_bf16", k2_src, k2_tpu),
            ("ragged_paged_attention_fp16", k1b_src, k1_tpu),
            ("ragged_paged_attention_fp16_int8", k1b_src, k1_tpu),
            ("ragged_paged_attention_fp16_fp8", k1b_src, k1_tpu),
            ("paged_decode_attention_fp16", k2_src, k2_tpu)):
        m = meas[name]
        shapes = [(m["shape"], m)]
        if "decode" in m:
            shapes.append((m["decode"]["shape"], m["decode"]))
        for shape, t in shapes:
            log(f"timing {name} at {shape}: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}), library (SDPA on pre-gathered K/V) "
                f"{t['library_ms']:.4f} ms, max_abs_err "
                f"{t['max_abs_err']:.3e}")
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": max(errs[name], m["max_abs_err"]),
               **{k: m[k] for k in keys if k in m}}
        if name in forms:
            row["launches_by_form"] = forms[name]
        if name in horizon_launches:
            row["horizon_launches"] = horizon_launches[name]
        if "decode" in m:
            row.update({f"decode_{k}": m["decode"][k] for k in keys
                        if k in m["decode"]})
        if "decode_mha_fp64_ratio" in m:
            row["decode_mha_fp64_ratio"] = m["decode_mha_fp64_ratio"]
        for run in (mixed, mixed16):    # phases 33 and 39's mixed pools
            if name in run["launches"]:
                row["mixed_launches"] = run["launches"][name]
        half = {"ragged_paged_attention_bf16": BF16,
                "ragged_paged_attention_fp16": F16}.get(name)
        if half is not None:
            t = half_verify[half]
            log(f"timing {_k1_label(HALF_SUFFIX[half])} at the verify span "
                f"shape {t['shape']}: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}), library (SDPA at {HALF_SUFFIX[half]} "
                f"on pre-gathered K/V) {t['library_ms']:.4f} ms, max_abs_err "
                f"{t['max_abs_err']:.3e}")
            row["verify_span"] = {k: t[k] for k in ("shape", "max_abs_err",
                                                    *keys) if k in t}
            for label, t in d256[half].items():
                log(f"timing {_k1_label(HALF_SUFFIX[half])} at d = 256, "
                    f"{t['shape']}: kernel {t['ms']:.4f} ms, plain "
                    f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                    f"({t['bound_by']}), library {t['library_ms']:.4f} ms")
                row[f"d256_{label}"] = {k: t[k] for k in (
                    "shape", "max_abs_err", *keys) if k in t}
            row["twin_2_layer_max_rel"] = twin[half]
            row["gather_2_layer_max_rel"] = gather[half]
            if half == F16:
                row["range_cases"] = range_cases
        if name == "ragged_paged_attention":
            for label, t in new_shapes.items():
                log(f"timing K1 at the {label.replace('_', ' ')} shape "
                    f"{t['shape']}: kernel {t['ms']:.4f} ms, plain "
                    f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                    f"({t['bound_by']}), library (SDPA on pre-gathered K/V) "
                    f"{t['library_ms']:.4f} ms, max_abs_err "
                    f"{t['max_abs_err']:.3e}")
                row[label] = {k: t[k] for k in ("shape", "max_abs_err",
                                                *keys) if k in t}
                row["max_abs_err"] = max(row["max_abs_err"],
                                         t["max_abs_err"])
            row["fused_step"].update(
                launches=ragged["launches"], launches_by_form=ragged["forms"],
                **{k: v for k, v in ragged.items()
                   if k not in ("launches", "forms")})
            row["prefix_launches_by_form"] = prefix_forms
        rows.append(row)

    # the training path: the engines, the model and the runners are gone
    _free_the_card()
    flash_err = flash_checks(gen)
    masked_err = masked_checks(gen)
    lap("flash kernels vs plain")
    left = _free_the_card()
    log(f"before the trainer: {left:.3f} GiB allocated")
    if left >= 1.0:
        raise AssertionError(f"{left:.2f} GiB still allocated after the "
                             "serving phases; the trainer needs the card")
    train_cfg = replace(cfg, num_layers=8)
    trainer, batch, flash_launches, _ = trainer_phase(train_cfg)
    train_profile_phase(
        trainer, batch, train_cfg.num_layers,
        sum(p.numel() for n, p in trainer.model.named_parameters()
            if p.dim() == 2 and n != "embed_tokens.weight"), "training")
    del trainer, batch
    _free_the_card()
    dense_check_phase(replace(cfg, num_layers=2))
    _free_the_card()
    own = gen.get_offset()
    acc = check_vs_fp64(gen)
    _free_the_card()
    # F16: the same gate on the stream the check reads when phase 37 draws
    # from the smoke's stream first
    after37 = torch.Generator(device="cuda")
    after37.manual_seed(0)
    acc["lse_after_phase37"] = lse_stream_check(
        after37, own + phase37_draws,
        f"the stream after phase 37 (seed 0, offset {own} + "
        f"{phase37_draws})")[1]
    _free_the_card()
    flash = measure_flash(gen)
    _free_the_card()
    lap("Llama trainer, dense check, flash timings")

    # the ERNIE pretraining path: the masked kernels (K3-m)
    ernie, data, masked_launches, _ = ernie_trainer_phase(ERNIE3_BASE)
    train_profile_phase(ernie, data, ERNIE3_BASE.num_layers,
                        ernie_matmul_weights(ernie.model), "ERNIE",
                        masked=True)
    del ernie
    _free_the_card()
    ernie_check_phase(replace(ERNIE3_BASE, num_layers=2))
    _free_the_card()
    acc_masked = check_vs_fp64(gen, h=12, d=64, causal=False, att=data[2])
    _free_the_card()
    masked = measure_flash(gen, h=12, d=64, causal=False, att=data[2])
    _free_the_card()
    lap("ERNIE trainer, check, masked flash timings")

    # the bf16 AMP paths: the bf16 kernels, ERNIE and Llama at O1, O2
    bf16_checks = half_flash_checks(gen, data[2])
    flash_bf16 = measure_flash(gen, dtype=torch.bfloat16)
    _free_the_card()
    masked_bf16 = measure_flash(gen, h=12, d=64, causal=False, att=data[2],
                                dtype=torch.bfloat16)
    _free_the_card()
    for shape, times in (("q/k/v [1,4096,32,128] causal", flash_bf16),
                         ("q/k/v [16,512,12,64] + kbias", masked_bf16)):
        dq, pair = times["flash_backward_dq"], times["pair"]
        log(f"K3b-dq-bf16 at {shape}: {dq['ms']:.4f} ms, "
            f"{100 * dq['bound_ms'] / dq['ms']:.1f} % of its bound "
            f"{dq['bound_ms']:.4f} ms; with dk/dv {pair['kernels_ms']:.4f} "
            f"ms, {pair['kernels_ms'] / pair['library_ms']:.3f}x SDPA's bf16 "
            f"backward {pair['library_ms']:.4f} ms")
    ernie, data_o1, masked_bf16_launches, masked_bf16_variants = \
        ernie_trainer_phase(ERNIE3_BASE, amp_level="O1")
    train_profile_phase(ernie, data_o1, ERNIE3_BASE.num_layers,
                        ernie_matmul_weights(ernie.model), "ERNIE O1",
                        masked=True, half=True)
    del ernie, data_o1
    _free_the_card()
    trainer, batch, bf16_launches, bf16_variants = trainer_phase(
        train_cfg, amp_level="O1")
    train_profile_phase(
        trainer, batch, train_cfg.num_layers,
        sum(p.numel() for n, p in trainer.model.named_parameters()
            if p.dim() == 2 and n != "embed_tokens.weight"), "training O1",
        half=True)
    del trainer, batch
    _free_the_card()
    o2_phase(replace(cfg, num_layers=2))
    _free_the_card()
    amp_twins_phase(replace(cfg, num_layers=2))
    _free_the_card()
    lap("bf16 AMP paths")
    log(f"before the GPT phases: {time.perf_counter() - t_start:.1f} s")

    # the GPT family at GPT-3 1.3B widths: serving, generators, O1 training
    gpt_launches, gpt_bf16, gpt_errs = gpt_phases(gen, gen16)
    log(f"after the GPT phases: {time.perf_counter() - t_start:.1f} s")
    _free_the_card()

    # phases 34-36, fp16 AMP: the fp16 kernels against fp64 and timed, the
    # ERNIE fp16 O2 GradScaler loop, the Llama fp16 O1 TrainStep and twins
    f16 = torch.float16
    t_new = time.perf_counter()
    fp16_checks = half_flash_checks(gen, data[2], f16)
    flash_fp16 = measure_flash(gen, dtype=f16)
    _free_the_card()
    masked_fp16 = measure_flash(gen, h=12, d=64, causal=False, att=data[2],
                                dtype=f16)
    _free_the_card()
    for shape, times in (("q/k/v [1,4096,32,128] causal", flash_fp16),
                         ("q/k/v [16,512,12,64] + kbias", masked_fp16)):
        log(f"fp16 kernels at {shape}: " + ", ".join(
            f"{n} {times[n]['ms']:.4f} ms ({times[n]['ms'] / x['ms']:.3f}x "
            f"bf16's {x['ms']:.4f})" for n, x in (
                flash_bf16 if "4096" in shape else masked_bf16).items()
            if n != "pair"))
    # the 16-bit flash kernels at d = 256 (the mma.sync instantiations
    # flash_*_{bf16,f16}_kernel<256>), timed by no record before: 16 heads
    # of 256 at the trainer's 4096 tokens, causal
    from paddle_tpu_torch.ops import flash_attention as fa
    flash_d256 = {}
    for dt in (BF16, f16):
        flash_d256[dt] = measure_flash(gen, h=16, d=256, dtype=dt)
        _free_the_card()
        log(f"{HALF_SUFFIX[dt]} flash kernels at d = 256 launch " + ", ".join(
            f"{n} {fa.kernel_variant(n, dt, 256)}" for n, _ in FLASH_KERNELS))
    lap("phase 34: fp16 flash kernels vs fp64, timings")
    scaled, masked_fp16_launches, masked_fp16_variants = \
        ernie_fp16_scaler_phase(ERNIE3_BASE, data)
    train_profile_phase(scaled, data, ERNIE3_BASE.num_layers,
                        ernie_matmul_weights(scaled.module), "ERNIE fp16 O2",
                        masked=True, half=f16)
    del scaled
    _free_the_card()
    lap("phase 35: ERNIE fp16 O2 GradScaler")
    trainer, batch, fp16_launches, fp16_variants = trainer_phase(
        train_cfg, amp_level="O1", amp_dtype="float16")
    train_profile_phase(
        trainer, batch, train_cfg.num_layers,
        sum(p.numel() for n, p in trainer.model.named_parameters()
            if p.dim() == 2 and n != "embed_tokens.weight"),
        "training fp16 O1", half=f16)
    del trainer, batch
    _free_the_card()
    amp_twins_phase(replace(cfg, num_layers=2), amp_dtype="float16",
                    loss_scale=2.0 ** 12)
    _free_the_card()
    lap("phase 36: Llama fp16 O1 TrainStep and twins")
    log(f"phases 34-36: {time.perf_counter() - t_new:.1f} s")
    framework = framework_phase()
    _free_the_card()
    lap("phase 48: the Tensor and _C_ops")
    spec = gpt_launches.pop("speculation")
    spec16 = gpt_launches.pop("speculation_fp16")
    for row in rows:       # the serving kernels on the GPT paths
        row["gpt_max_abs_err"] = gpt_errs[row["name"]]
        row["gpt_launches"] = {path: n[row["name"]] for path, n in
                               gpt_launches.items() if row["name"] in n}
        row["spec_launches"] = {arm: by[row["name"]] for arm, by in
                                spec.items() if row["name"] in by}
        for arm in ("serial", "async_pipelined", "int8"):
            n = tier[arm]["launches"].get(row["name"])
            if n:
                row.setdefault("host_tier_launches", {})[arm] = n
        for arm, numbers in (
                ("fault_free", stier["fault_free"]),
                ("crash", stier["crash"]), ("stall", stier["stall"]),
                ("rolling_restart", stier["rolling_restart"]),
                ("random_policy", stier["random"]),
                ("split_fp32", stier["disagg"]["fp32"]),
                ("split_int8", stier["disagg"]["int8"]),
                ("recovered", stier["durability"])):
            n = numbers["launches"].get(row["name"])
            if n:
                row.setdefault("tier_launches", {})[arm] = n
        for arm in ("fault_free", "sigkill", "sigstop", "rolling_restart",
                    "recovered", "split_fp32", "split_int8"):
            n = ptier[arm]["launches"].get(row["name"])
            if n:
                row.setdefault("proc_tier_launches", {})[arm] = n
        for arm in ("threads_restart", "threads_split", "processes_split",
                    "processes_sigkill", "processes_recovered"):
            n = store_tier[arm]["launches"].get(row["name"])
            if n:
                row.setdefault("store_tier_launches", {})[arm] = n
        # phase 47: every launch of a shard counted, each at its heads
        for arm, by in (("fp32_tp2", tp["a"]["launches"]),
                        ("int8_comm_tp2", tp["b"]["launches"]),
                        ("bf16_int8_pool_tp2", tp["c"]["launches"]),
                        ("fp32_tp4_tier", tp["d"]["tier"]["launches"])):
            n = by.get(row["name"])
            if n:
                row.setdefault("tp_launches", {})[arm] = n
        shard = {"ragged_paged_attention": "K1_chunk",
                 "paged_decode_attention": "K2_decode"}.get(row["name"])
        if shard:
            row["tp_shard_shape"] = tp["shard_kernels"][shard]
        if any(row["name"] in by for by in spec16.values()):
            row["spec_fp16_launches"] = {arm: by[row["name"]] for arm, by
                                         in spec16.items()
                                         if row["name"] in by}
    # the verify spans' launches: K1's decode form in the per-step and
    # fused arms (the draft arm's also counts its draft model's short
    # catch-up chunks)
    rows[0]["verify_span"]["launches"] = sum(
        spec[arm]["ragged_paged_attention"]["by_form"].get("decode", 0)
        for arm in ("per_step", "fused"))

    for label, times, launches, errs in (
            ("", flash, flash_launches, (flash_err, acc)),
            ("_masked", masked, masked_launches, (masked_err, acc_masked))):
        for name, replaces in FLASH_KERNELS:
            row = {"name": name + label, "route": "cuda",
                   "source": "paddle_tpu_torch/csrc/flash_attention.cu",
                   "replaces": replaces, "launches": launches[name],
                   "max_abs_err": max(e[name] for e in errs),
                   **times[name]}
            if name == "flash_forward":
                row["fp64_ratio"] = errs[1]["fwd_fp64_ratio"]
                if "lse_after_phase37" in errs[1]:
                    row["lse_after_phase37_fp64_ratio"] = \
                        errs[1]["lse_after_phase37"]
            rows.append(row)
    for label, times, launches, variants, kind, dtype, checks in (
            ("_bf16", flash_bf16, bf16_launches, bf16_variants, "dense",
             torch.bfloat16, bf16_checks),
            ("_masked_bf16", masked_bf16, masked_bf16_launches,
             masked_bf16_variants, "masked", torch.bfloat16, bf16_checks),
            ("_fp16", flash_fp16, fp16_launches, fp16_variants, "dense", f16,
             fp16_checks),
            ("_masked_fp16", masked_fp16, masked_fp16_launches,
             masked_fp16_variants, "masked", f16, fp16_checks)):
        for name, replaces in FLASH_KERNELS:
            wgmma = "wgmma" in variants[name]
            rows.append({"name": name + label, "route": "cuda",
                         "source": "paddle_tpu_torch/csrc/" + (
                             "flash_attention_wgmma.cu" if wgmma
                             else "flash_attention.cu"),
                         "kernel": HALF_KERNEL_NAMES[dtype][name][wgmma],
                         "replaces": replaces, "launches": launches[name],
                         "launches_by_variant": variants[name],
                         "max_abs_err": checks[kind]["err"][name],
                         **times[name],
                         "fp64_ratio": checks[kind]["ratio"][name],
                         "misround": checks[kind]["misround"][name]})
            if kind == "dense":
                rows[-1]["d256"] = {
                    "shape": "[1,4096,16,256] causal",
                    "kernel": HALF_KERNEL_NAMES[dtype][name][0],
                    **flash_d256[dtype][name]}
            if kind == "dense" and dtype == torch.bfloat16:
                rows[-1]["gpt_launches"] = {
                    "trainer_o1": gpt_launches["trainer_o1"][name]}
                rows[-1]["gpt_shape"] = gpt_bf16[name]
    # phase 48's layers through _C_ops: each flash kernel's launches there
    for row in rows:
        for suffix, arm in (("", "llama_fp32"), ("_masked", "ernie_fp32"),
                            ("_bf16", "llama_bf16_o1")):
            for name, _ in FLASH_KERNELS:
                if row["name"] == name + suffix:
                    row["ops_launches"] = {
                        arm: framework[arm]["launches"][name]}
    lap("kernels line")
    log(f"time by part (s): {json.dumps(_LAPS)}")
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
