#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero and prints no result on stdout):

1. device  — needs CUDA (there is no CPU fallback); prints the card's name and
   power limit as nvidia-smi reports them.
2. build   — compiles the grouped-GEMM kernel (csrc/grouped_matmul.cu) and the
   flash-attention kernels (csrc/flash_attention.cu, bf16;
   csrc/flash_attention_f32.cu, fp32) with nvcc into build/kernels/, one
   nvcc per source, all three at once; prints each kernel's
   registers and spills, and fails if a wgmma kernel spills or ptxas
   reports that it serialized a kernel's wgmmas (advisories C7513, C7518,
   C7520).
3. kernels — holds ``gmm`` against its plain PyTorch version at the serving
   path's shapes (moe-8x40m: decode with 8 slots, a 256-token prefill chunk
   and a 160-token one at block_t 16), fp32 and bf16, plus an
   empty-group/tail-tile case; each must run the ``gmm_variant`` kernel
   (fp32: "f32_decode" at block_t 8, "f32" above), and at the fp32 prefill
   shape the kernel is launched once more with its last live row tile left
   out, which the same check must reject. The locked generation path's
   shapes follow, each with that planted fault: one decode token (2
   routed rows, 6 of 8 experts empty, a 64-row buffer) at gate/up and
   down and four beams (8 rows) on "f32_decode", a 512-token padded
   prefill (1024 rows in a 1536-row buffer, block_t 64) on "f32". Times the kernel, the plain
   version and ``torch._grouped_mm`` (where it takes the dtype) as a
   yardstick, each launch reading weights from HBM. At the MoE training
   path's shapes (block_t 128) gmm's forward and dX and tgmm must run
   their TMA/wgmma kernels (the
   per-variant launch counts say so), are held against their plain
   versions, and are compared element by element with, and timed in turns
   with, the WMMA kernels that served those shapes before (called through
   the library's C entries with the arguments the wrapper passed then;
   WMMA, wgmma, wgmma, WMMA); at the path shape each
   is launched once more with its last live row tile left out
   (``kernel_check.gmm_skipping_a_tile``, ``tgmm_skipping_a_tile``), and
   the same check must reject it. Then holds ``flash_fwd``, ``flash_bwd_dq`` and
   ``flash_bwd_dkv`` against their plain versions: the training path's
   shape (B 32, H 8, S 1024, D 64, bf16, causal), the fp32 40m path's
   (the same, fp32), fp32 at B 4, GQA 8/2, S 1000 (tail tiles),
   sliding_window, prefix_lm, full and D 128, timing each beside
   ``F.scaled_dot_product_attention`` (forward; forward + backward for the
   backward kernels) as a yardstick, with its TFLOP/s; first of
   them the 1B trainer's shape (B 8, H 16, S 2048, D 128, bf16, causal).
   Each call must run the variant ``flash_variant`` names for its kernel
   (bf16: the wgmma kernels at every head dim; fp32: the three 3xTF32
   kernels). Each output must pass ``ops/kernel_check.compare``
   (per-element limits scaled to the output's RMS, and a normwise limit)
   against the plain version (fp32: evaluated in float64,
   ``kernel_check.reference``; the fp32 plain version's own ratio is
   printed beside it). At the path shapes and the fp32
   cases the kernels are launched once more with one live tile left out of
   their plans, and the same check must reject every output.
4. serve   — serves moe-8x40m at full width (12 layers, seeded random fp32
   weights) through the port's HTTP server and batch engine: 8 slots,
   max_len 1024, paged KV in 32-token blocks, prefix cache, 256-token prefill
   chunks. Checks the responses, the gmm launch count (3 per layer per
   prefill chunk and per decode step: every prefill launch on "f32", every
   decode launch on "f32_decode") and the first token's logits against the
   port's plain path on the CPU. The engine's tracer is on and its registry
   is served on a metrics port: every request sends an ``X-Trace-Id``, and
   ``GET /trace`` must hold one ``request`` span per request carrying it;
   ``GET /metrics`` and the Prometheus exposition must count every request
   in ``serve_ttft_ms``. The decode tok/s printed is with the tracer on.
4b. generate — the locked generation path on the same weights, batch 1:
   greedy ``generate_step`` on the serving phase's three greedy prompts
   must give the batch engine's tokens, and the first one's logprob the
   CPU plain path's within 1e-3; 64 tokens with the fp32 cache and with
   the int8 cache (within the first 8 tokens at most one diverging
   token, the last; with the fp32 tokens fed, its logits the CPU plain
   int8 path's within 1e-3 of the largest, and the first divergence where
   the fp32 top-2 gap is within twice the int8 error); speculative
   greedy (draft 8) the plain greedy tokens; beam search (4 beams, 16
   tokens) a best score whose x length equals the full forward's sum of
   logprobs within 1e-3; top_p, min_p and repetition_penalty through the
   locked server and through the batch engine's fallback, SSE and
   /v1/completions answer 200. Every gmm launch of the phase on
   "f32_decode" or "f32", no flash or tgmm launch. Prints TTFT and decode
   tok/s (fp32 and int8 cache), speculation's and beam search's tok/s.
4c. quant — the batch engine on the same weights, fp32 serving compute
   (``quant_serve_phase``): (a) fp paged; (b) speculation, draft 4 and
   n-gram 3 on partly repetitive prompts (greedy tokens (a)'s, some drafts
   accepted, a sampled run at 0.7 finishes); (c) the int8 KV pool, paged
   against slotted (equal greedy tokens), its first-token logits within
   1e-4 x max|logit| of the CPU plain path's, pool bytes fp32 and int8;
   (d) int8, int8 over the int8 pool, and int4 weights: first-token logits
   within 1e-4 x max|logit| of the CPU plain path's on the same quantized
   weights (quantized on the CPU, copied to the card; the card's own
   quantization must equal the CPU's bit for bit; the CPU path takes the
   card's expert choices and int8 K/V roundings, and how many of the
   prompt's it would have made otherwise is printed), weight bytes, greedy agreement with (a) (reported, not gated:
   random weights have near-ties), gmm launches by variant (every one on
   "f32" or "f32_decode": the dequantized banks go through the fp32
   kernels); (e) ``load_params(weight_dtype="int8")`` from a safetensors
   file equal to ``quantize_weights`` bit for bit, and ``swap_params`` of
   the fp weights into a live int8 engine (version 1, still int8, the same
   greedy tokens); (f) ``export_kv`` -> GKV1 bytes -> ``adopt_kv`` in a
   second engine (the adopting request's greedy tokens a fresh prefill's,
   its prompt from the cache), a corrupted payload refused and its keys
   quarantined. Prints tok/s of each arm beside the card.
4d. fleet — the same weights in a disaggregated fleet (``fleet_phase``):
   one prefill and two decode batch engines (phase 4's settings), each
   behind the port's server on a thread of this process and registered in
   a fleet directory with a heartbeat, behind a ``FleetRouter``, a
   ``FleetController`` (``configs/serve-sample.yaml``'s ``fleet:`` block;
   no scale-down below two) and a scope ``Collector`` (its ``scope:``
   block, scraping through the router's call policy, with
   ``configs/alerts.yaml``'s rules and one the traffic crosses). Ten
   greedy requests of 32 tokens, one at a time: six of 600-900 bytes take
   the handoff (two groups of three share a 512-byte prefix, each group
   routed to its own decode replica) and four under the 64-byte floor
   prefill on the decode side. Gates: every request's tokens a directly
   served engine's; 6 handoffs, 6 prefill-only requests, adopted blocks;
   each push the GKV1 bytes of its full blocks (48 KiB a token of KV plus
   the framing); each group on one decode replica, its later requests
   reusing the 16 shared blocks; gmm launches recorded around each
   replica's part of each request: "f32" only on the prefill replica,
   "f32_decode" on both decode replicas, every launch a kernel's (3 per
   layer per engine step) and no call of the plain version. Then:
   ``/admin/drain`` (503, the router around it, ``/admin/undrain``);
   ``X-Deadline-Ms: 1`` through the router 504 with no engine step, 60000
   200; a decode replica's server stopped between four requests (two on
   it, two replayed on the other; all four the reference tokens), its
   breaker opened by the refusals, the poller reviving it, the breaker
   closing on the next probe; ``FleetController.rolling_swap`` to a second
   seeded checkpoint in the ``runs/`` format under canary traffic (decode
   replicas first, each promoted, no error), then the fleet's tokens a
   direct engine's on the new weights; the collector's TSDB holding the
   router's and all three replicas' series, the extra rule fired and its
   bundle holding every member's ``/metrics``; ``python -m
   ...serve.fleet`` over the fleet directory as a process, routing a
   request, answering ``/metrics`` and exiting 0 on SIGINT. Prints the
   phase's seconds, TTFT and decode tok/s through the fleet (handoff and
   local prefill) beside a direct engine's on the same prompts and phase
   4's, each push's bytes and ms, and the gmm launches by replica.
4e. tp serve — the same weights (``--config configs/model-config-moe-8x40m.yaml
   --seed 0`` draws them) served as ``infer.server --engine batch --mesh
   tp=2`` on 2 gloo ranks of ``parallel.launch`` on the one card
   (``tp_serve_phase``; NCCL refuses two ranks on one device), three arms
   in one launch (``scripts/serve_arms.py``): base, ``--kv-quant``,
   ``--spec-draft-len 4``, each ended by a SIGTERM. Phase 4's three greedy
   prompts and two sharing a 256-byte prefix, one at a time, against a
   one-device engine in this process with the arm's settings: tokens
   identical, first logprob abs <= 1e-3, the same prefix-cache adoptions;
   on both ranks every gmm launch ``f32`` (prefill) or ``f32_decode``
   (decode) at the rank's widths (gate/up N 768, down K 768), 36 a device
   step; every rank exits 0. Prints TTFT and decode tok/s beside the
   one-device engine's (gloo through the host sets the tp pace).
5. train   — trains configs/model-config-40m-adamw.yaml at full width
   (hidden 512, 12 layers, S 1024, batch 32, bf16 over fp32 masters, AdamW)
   through ``Trainer(...).train()`` on a seeded synthetic byte corpus: 30
   steps (``iters`` and ``warmup_steps`` cut to fit a smoke), a log line
   every 5, one validation and the final checkpoint. Checks the loss falls,
   the flash launch counts (12 per step and per validation batch for the
   forward, 12 per step for each backward; every flash launch on the wgmma
   kernels), step 1's loss and gradients
   against the plain attention path on the card at batch 8, and serves the
   final checkpoint through the port's server. Then the fp32 path: the same
   config with ``system.mixed_precision: false`` (compute_dtype float32,
   the port's default), 10 steps through ``Trainer.train()``, a log line
   every 2: every flash launch on the "f32" kernels (12 forwards a step
   and a validation batch, 12 of each backward kernel a step), step 1's
   loss, gradient norm and per-leaf gradients against the plain attention
   path at batch 8 (1e-5 / 1e-6 / 1e-5 relative: fp32 on both sides),
   and the same check against a 1xTF32 attention (the plain version's
   products with TF32 on), which must fail it; finite losses that fall;
   prints step ms and tok/s. This run has ``logging.log_samples`` on (a
   validation at step 10): its log must hold one ``Step 10 sample:``
   line, and a second run without it must log the same losses (1e-5
   relative; bitwise printed).
6. moe     — trains configs/model-config-moe-8x40m.yaml at full width (hidden
   512, intermediate 1536, 12 layers, 8 experts top-2, dropless grouped
   dispatch, router aux and z losses, S 1024, batch 32, bf16 over fp32
   masters, AdamW) the same way: 30 steps, a log line every 5 with routing
   stats, one validation, the final checkpoint. Checks the loss falls, the
   routing stats on every line (no drops), the exact launch counts (per
   step 72 gmm, 36 tgmm and 12 of each flash kernel; per validation batch
   36 gmm and 12 flash_fwd; every gmm, tgmm and flash launch a wgmma
   one), step
   1's loss and gradients with the gmm and
   tgmm kernels against their plain versions (flash kernels in both) at
   batch 8, and serves the final checkpoint.
6b. int8  — moe-8x40m as phase 6 with ``model.matmul_precision: int8``
   (``int8_train_phase``): 10 steps (``iters`` and ``warmup_steps`` cut,
   the mesh dropped, each printed as ``reduced``), a log line every 2, the
   last logged loss below the first; step 1 at batch 8 with the gmm_int8,
   gmm and tgmm kernels against their plain versions under phase 6's
   limits; launches: gmm_int8 3 per layer per step and validation batch
   (every one on its s8 wgmma kernel), the dX gmm (wgmma) and the dW tgmm
   ("f32", 3xTF32 on fp32 copies) 3 per layer per step, the flash kernels
   (wgmma, on int8-gridded q/k/v) as phase 6. Prints step ms, tok/s and
   peak memory beside phase 6's. Phase 3 holds ``gmm_int8`` at this
   path's gate/up and down shapes on its "wgmma" variant: its int32 sums
   bitwise against the plain version (float64 products, exact below
   2^53), its output through the same gate and bitwise against the
   ``mma.sync`` kernel that served these shapes before (timed in turns with
   it), a planted fault (the last live row tile skipped) rejected; timed
   beside the plain version, ``torch._int_mm`` summed over each expert's
   rows and the bf16 gmm. It holds the fp32 tgmm at this path's dW shapes
   (gate/up x [66,560, 512], dy [.., 1,536]; down K 1,536, N 512; block_t
   128; fp32 copies of bf16 values) and at block_t 32 against the plain
   version evaluated in float64, each with a planted fault, timed beside
   one fp32 ``torch.mm`` per expert (TF32 off) and ``torch._grouped_mm``
   in fp32 where this torch takes it.
7. 1b      — trains configs/model-config-1b-singlechip.yaml at full width
   (hidden 2048, intermediate 5632, 4 of its 16 layers (the whole smoke's
   time limit), 16 heads of 128, S 2048, batch 8, bf16 over fp32 masters, flash attention,
   remat "full" on the first half of the layers (the default ratio 0.5),
   scan_layers, Adafactor, async
   checkpoints) from a JSON config. Cut: 16 steps (of 20,000), warmup 2 (of
   2,000), a log line every step, a checkpoint every 8 steps. At step 1 the
   fused CE (2048-row chunks) is held against the plain CE: loss 1e-5 and
   gradient norm 1e-4 relative. Run A trains 16 steps through
   ``Trainer.train()`` (launch counts: 6 flash forwards a step, 4 of each
   backward kernel, all wgmma; every checkpoint verifies); a 2-step side
   run with remat "none" gives the peak memory remat saves. Run B is the
   trainer CLI in a subprocess, sent SIGTERM once its log shows step 4: it
   must save a preemption checkpoint that verifies and exit 0. Run C
   resumes B with ``resume.checkpoint: latest`` to step 16: it must start
   at B's saved step, log "Resumed from checkpoint", and give run A's loss
   at every step within 1e-5 relative (whether bitwise is printed). The
   final checkpoint is served. Prints step ms, tok/s, MFU (the recompute
   not counted) and both peak memories beside the card.
7b. fsdp   — configs/model-config-1b-fsdp.yaml at full width (the 1B widths,
   4 of its 16 layers, batch 32, remat "save_attn" on the first half of the
   layers, AdamW, ZeRO-1,
   overlap_gather, ``mesh: {fsdp: -1}``) through ``parallel.launch`` with
   one NCCL rank (``fsdp: -1`` resolves to 1; ``fsdp_1b_phase``). Cut: 20
   steps (of 20,000), warmup 2 (of 2,000), a log line every step, a
   checkpoint every 10 steps, no metrics port. The one-device reference is
   the same config's trainer with no mesh, its step 1 in the smoke's
   process. Run A trains 20 steps with a profiler window over step 3; run B
   resumes it from step 10 (strict: the step must verify). It runs first,
   right after the build, while this process holds almost none of the
   card. Gates: A's step-1 loss and gradient norm within 1e-5 relative
   of the one-device step (whether bitwise is printed); B's losses A's
   within 1e-5; the loss falls below 0.9 x step 1's; the profile's op
   table holds the three bf16 flash kernels at the one-device step's count
   (every layer's forward, the remat'd ones again, every layer's dQ and
   dK/dV) and the trace no plain attention (einsum/bmm/sdpa) op; every
   flash launch of run A (its ``run_end`` event) on wgmma; the rank's
   sidecar ``step_10_data_p0.json`` in the chief's manifest. Beside run B,
   two ranks on the one card: NCCL refuses them, gloo forms the group; step 1
   of the {fsdp: 2} step (``scripts/profile_torch_train.py --steps 0``, 2
   layers) on two gloo ranks must give one NCCL rank's within 1e-5. Prints
   step ms, tok/s, MFU and peak memory beside the card.
7c. tp    — configs/model-config-1b-tp.yaml at full width (hidden 2048, 16
   heads of 128, intermediate 5632, S 2048, tied embeddings, AdamW, ZeRO-1,
   remat "dots") on its own mesh ``{dp: -1, tp: 4}`` over 4 gloo ranks on
   the one card through ``parallel.launch`` (``tp_1b_phase``; dp resolves
   to 1), right after 7b. Cut: 2 of 16 layers, batch 2 of 32, 16 steps of
   20,000 (warmup 2), a checkpoint at step 8, each cut printed. The
   reference: the same cut config on one rank with no mesh, step 1 in this
   process. Gates: step 1's loss and gradient norm within 2e-3 / 2e-2
   relative (bitwise printed); the loss below 0.9 x step 1's; rank 0's
   profile over step 3 holds the three bf16 flash kernels at the one-rank
   step's count and no plain attention op; every rank (``run_end``'s
   ``ranks``) launched them, all wgmma, at 4 of the 16 heads; run B,
   resumed at step 8 on the 4 ranks, gives A's losses within 1e-5. Prints
   step ms, tok/s and each rank's peak memory beside the card (gloo through
   the host sets the pace).
7d. ep     — configs/model-config-moe-1b.yaml at full width (hidden 2048,
   intermediate 5632, 16 heads of 128, S 2048, 8 experts top-2, AdamW,
   ZeRO-1, remat "dots") on its own mesh ``{ep: 8, fsdp: -1}`` over 8 gloo
   ranks on the one card (``ep_phase(..., EP8)``; fsdp resolves to 1),
   right after 7c and beside 6c (each phase in a thread of its own: their
   ranks are processes of their own and the card holds both, so their
   step times are taken side by side). Cut: 2 of 16 layers, batch 8 of 32 (1 row a rank), 3
   steps (warmup 2), each cut printed. The reference: the same cut on one
   rank with no mesh in this process, on the ranks' global batches. Gates:
   step 1's loss and gradient norm within 2e-3 / 2e-2 relative (bitwise
   printed; steps 2-3 printed beside the reference's); every rank holds 1
   expert a layer and launched every gmm and tgmm on wgmma at the receive
   buffer's 32,896 rows; no drop. Prints step ms, tok/s, each rank's peak
   memory and the all_to_all bytes a step beside the one rank's step.
6c. ep     — configs/model-config-moe-8x40m.yaml on its own mesh ``{dp: -1,
   ep: 4}`` over 4 gloo ranks (``ep_phase(..., EP4)``; dp resolves to 1),
   beside 7d, at full width (hidden 512, intermediate 1536, 8 experts top-2,
   S 1024, bf16 over fp32 masters, AdamW, remat "dots", ZeRO-1). Cut: 4 of
   12 layers, batch 8 of 32 (2 rows a rank), 12 steps (warmup 2), a
   checkpoint at 6. Gates as 7d's at 2 experts and 16,640 rows, and the
   loss below 0.9 x step 1's; run B, resumed at 6, gives A's losses within
   1e-5; then arm C at ``ep_capacity_factor`` 1.0 (3 steps) drops selections on
   every step, its ``moe_dropped_tokens_total`` (``run_end``) is their sum,
   its losses finite. Phase 3 holds the gmm (gate/up, down, both dX) and
   tgmm at both phases' per-rank shapes (E/ep groups over the ``ep * cap``
   buffer, about TK of its rows real; ``ep_kernel_cases``), each timed
   beside its plain version and ``torch._grouped_mm`` with its bound over
   the real rows and over the buffer.
8. flex    — this slice's paths. (a) configs/model-config-100m-muon.yaml at
   full width (hidden 768, 12 layers, 12 heads of 64, S 1024, batch 32,
   bf16 over fp32 masters, flash attention, Muon with Nesterov, 5 NS steps,
   AdamW at 0.015 x the LR for the vectors): step-1 loss and gradient norm,
   kernels against plain at batch 8; run A, 30 steps (warmup 300 -> 10, a
   log line every step, a checkpoint at 15) through ``Trainer.train()``,
   the loss must fall below 0.9x the first and every flash launch be wgmma
   with no score mod; run B resumes from the step-15 checkpoint and its
   steps 16-20 must give A's losses within 1e-5 relative (bitwise printed);
   step ms, tok/s, MFU vs 989 TFLOP/s and peak memory. (b)
   configs/model-config-1m-flex.yaml at full width (flex attention,
   sliding window 128, ALiBi, 6 heads of 16, S 512, batch 16, Muon): step-1
   parity, 30 steps, the loss falls, every flash launch on the wgmma
   kernels with the alibi code. (c) the 1M configs' optimizers
   (adamw_enhanced, lion, shampoo, hybrid; sgd and adamw with ``fused:
   false`` as overrides of the adamw one; D 32, every flash launch on the
   wgmma kernels): 10 steps
   each, finite losses, step-1 parity; then model-config-1m-muon.yaml with
   ``training.lr_finder: {enabled: true, num_steps: 20}``: the sweep runs,
   its suggestion is logged and adopted, and 5 steps follow with finite
   losses. Phase 3 adds the slice's kernel cases: soft_cap 50 and sliding
   128 + alibi at the 100m shape, soft_cap at the 1B shape, the 1m-flex
   shape (D 16, alibi) and the 1M configs' (D 32, GQA) on the wgmma
   kernels, band 256 at D 64, the main path's shape with no mod; each
   takes a planted fault, and is timed against SDPA with a float
   ``attn_mask`` carrying the ALiBi bias and the window (soft_cap:
   ``flex_attention`` under ``torch.compile`` with the soft-cap
   ``score_mod``, compiled beside the build in phase 2, its compile time
   printed on a line of its own).
9. stream  — trains configs/model-config-80m-fineweb.yaml at full width
   (hidden 1024, intermediate 2816, 6 of its 12 layers, 16 query heads over 8 KV
   heads of 64, S 2048, batch 32, bf16 over fp32 masters, flash
   attention, Muon with adamw_lr_ratio 0.02) on seeded synthetic text in
   four local JSONL shards and one WebDataset tar shard, read through
   ``data.streaming.shards`` by the port's StreamingDataManager behind the
   device prefetcher. Changed from the config, each printed as
   ``reduced``: the data source, ``iters``, ``warmup_steps`` and the
   checkpoint interval. The native dataplane must build and give the
   Python packer's rows (both timed); the producer alone gives its
   documents per second; step 1 at batch 8 is held against the plain
   attention path. Run A: 30 steps with prefetch 2 and a checkpoint at 15,
   its logged loss falling below 0.9x the first. Run E: the same with
   prefetch 0 (its losses A's within 1e-5, its step-15 data position A's).
   Run B resumes A from step 15: steps 16-30 give A's losses within 1e-5.
   Run C: prefetch 0 for 5 steps, A's first five losses within 1e-5. Run
   D: 5 steps on token shards that ``write_token_shards`` wrote from the
   same documents (the vocabulary from their index, a validation batch
   from their split). Every batch a run consumed is held, on the device
   before and after its step, against the host batch by checksum. Every
   flash launch of the runs is wgmma with no score mod, 12 forwards a step
   and a validation batch and 12 of each backward a step. Prints step ms
   (per window, and the median between step starts from CUDA events),
   tok/s, MFU, data_wait and h2d ms a step for prefetch 2 and 0, peak
   memory and the producer's documents per second, beside the card.
   Phase 3's ``path_80m`` case holds the three flash kernels at this
   path's shape (B 32, Hq 16, Hkv 8, S 2048, D 64, bf16, causal) with a
   planted fault.
9b. telemetry — moe-8x40m as phase 6 (its config, seed and corpus, written
   as JSON; checkpoints every 10 steps, blocking; spans, events, a metrics
   port and a ``torch.profiler`` window over steps 16-19 on; the
   supervisor's hang timeout 30 s) trained 30 steps through the trainer CLI
   with ``--auto-resume``, so the port's supervisor runs it in a child
   process. Once step 10's manifest lands the child is SIGKILLed; once step
   20's lands its exposition is scraped and it is SIGSTOPped, a hang only
   the watchdog's SIGKILL ends. The supervisor must exit 0 with 2 restarts
   and 1 hang. Every logged loss must be phase 6's at its step within 1e-5
   relative (whether they agree at the events' 6 decimals is printed);
   ``events.jsonl`` must hold two ``restart`` events with ``lost_s`` > 0,
   one ``hang`` fault, resumes at 10 and 20 and ``run_end`` at 30; the
   scrape ``train_step`` > 0, the token counter, the goodput seconds, the
   MoE gauges and the prefetcher's metrics; the profile a trace under
   ``profile/`` and a ``prof_summary.json`` whose fractions sum to 1
   within 1e-6, whose op table holds the five bf16 kernels at 3x phase
   6's launches per step (so the child ran the Hopper kernels); the spans
   of each window in ``trace.json`` their goodput fields within 1e-6 s.
   The supervisor runs with ``--scope``: its collector's TSDB (configs/
   alerts.yaml's rules) must hold the trainer's ``train_step`` series.
   Prints the phase's seconds, each restart's ``lost_s``, and the steady
   step ms and tok/s (windows with no compile, save, eval or profiled step)
   beside phase 6's.
10. report — a ``{"kernels": [...]}`` line (each kernel with the earlier
   kernel's ms where this run timed one, each flash kernel with its
   launches by variant in the 1B run and its launches on each training
   path; the fp32 cases' entries with their launches on the fp32 40m path
   (its own shape's case, "path_fp32") or 0; the serving path's fp32 gmm kernels, "gmm_f32" and
   "gmm_f32_decode", as entries of their own with their launches in the
   serving and the fleet phases (and by fleet replica) and every fp32 row; each of the flex slice's (kernel, variant, score
   mod) cases as an entry named ``kernel:variant:mod:case``, with its
   launches on the path that runs it; the locked generation path's four
   gmm cases as entries ``gmm_<variant>:<case>`` with the generate phase's
   launches at their shapes; the three flash kernels at 80m-fineweb's shape
   as ``<kernel>:wgmma:none:path_80m`` with the streaming phase's
   launches; ``gmm_int8`` with its launches in phase 6b, its bound at
   the H100's 1,979 int8 TOP/s; ``tgmm_f32`` at the int8 path's gate/up
   shape with its launches in phase 6b; the three flash kernels at 1b-tp's
   per-rank shape as phase 7c cuts it (B 2, H 4, S 2048, D 128) with rank
   0's launches there (every rank's beside them), at the config's own
   per-rank batch (B 32, H 4; no phase runs it) and at 1b-fsdp's (B 32,
   H 16) with phase 7b's, whose planted fault must also fail the float64
   arbiter that decides a miss there; the fp32 gmm at moe-8x40m's tp=2 widths, ``gmm_<variant>:tp2_*``,
   with rank 0's launches at that shape in phase 4e and rank 1's beside
   them; the gmm and tgmm at phases 7d's and 6c's per-rank shapes,
   ``gmm_wgmma:ep8_*`` / ``ep4_*`` and ``tgmm_wgmma:ep8_*`` / ``ep4_*``,
   with rank 0's launches at that shape in run A (every rank's beside them;
   a gmm shape serves one product's forward and the other's dX) and the
   bounds over the real rows and over the buffer), the card line, and as
   the last line
   ``{"ok": true, "device": {...}}``. fp32 operation bounds are reckoned at
   495 / 3 TFLOP/s (3xTF32), the card's fastest fp32-accurate rate.

Every path runs with all launch counts set to 0 just before it and read
just after. Every process the smoke starts carries its run id in the
environment (``CHIP_SMOKE_RUN_ID``); the launchers run in process groups of
their own, killed whole when they end, and on the way out the smoke kills
whatever still carries the id (Inductor's compile workers, a rank whose
launcher died), names it on stderr, and waits until it is gone. fp32 matmuls run in full fp32: TF32 is switched off for matmuls
and cuDNN. Imports nothing of JAX.
"""

import concurrent.futures
import json
import math
import os
import subprocess
import sys
import threading
import time

SEED = 0
REPO = os.path.dirname(os.path.abspath(__file__))
# configs/model-config-moe-8x40m.yaml, written out so no YAML is read here.
MOE_8X40M = dict(vocab_size=259, hidden_size=512, intermediate_size=1536,
                 num_layers=12, num_heads=8, num_kv_heads=8, head_dim=64,
                 max_position_embeddings=1024, rms_norm_eps=1e-5,
                 rope_theta=10000.0, tie_word_embeddings=True,
                 num_local_experts=8, num_experts_per_tok=2, moe_impl="grouped")
# H100 SXM data-sheet peaks (dense): HBM bytes/s and FLOP/s by operand type.
# fp32: the card's fastest route to fp32-accurate products is three TF32
# tensor-core passes (3xTF32, as the "f32" gmm kernel runs them): 495 / 3
# TFLOP/s, above the FMA units' 67.
HBM_BYTES_S = 3.35e12
FP32_3XTF32_FLOPS = 495e12 / 3
PEAK_FLOPS = {"float32": FP32_3XTF32_FLOPS, "bfloat16": 989e12}
REPLACES = "mlx_cuda_distributed_pretraining_tpu/ops/grouped_matmul.py:137"
TGMM_REPLACES = "mlx_cuda_distributed_pretraining_tpu/ops/grouped_matmul.py:188"
SOURCE = "mlx_cuda_distributed_pretraining_tpu_torch/csrc/grouped_matmul.cu"
FLASH_SOURCE = "mlx_cuda_distributed_pretraining_tpu_torch/csrc/flash_attention.cu"
FLASH_F32_SOURCE = "mlx_cuda_distributed_pretraining_tpu_torch/csrc/flash_attention_f32.cu"
FLASH_REPLACES = {
    "flash_fwd": "mlx_cuda_distributed_pretraining_tpu/ops/flash_attention.py:404",
    "flash_bwd_dq": "mlx_cuda_distributed_pretraining_tpu/ops/flash_attention.py:466",
    "flash_bwd_dkv": "mlx_cuda_distributed_pretraining_tpu/ops/flash_attention.py:509",
}
FLASH_KERNELS = tuple(FLASH_REPLACES)


T0 = time.perf_counter()


def log(msg: str) -> None:
    """A progress line, stamped with the seconds since the smoke started."""
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


RUN_ID_VAR = "CHIP_SMOKE_RUN_ID"


def own_processes(run_id: str) -> list:
    """``(pid, command line)`` of every other live process whose environment
    carries this run's id: whatever the smoke started, at any depth, also
    one whose parent died first."""
    mark = f"{RUN_ID_VAR}={run_id}".encode()
    found = []
    for name in os.listdir("/proc"):
        if not name.isdigit() or int(name) == os.getpid():
            continue
        try:
            with open(f"/proc/{name}/environ", "rb") as f:
                if mark not in f.read().split(b"\0"):
                    continue  # a zombie's environment reads empty
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:
            continue
        found.append((int(name), cmd))
    return found


def stop_leftovers(run_id: str, timeout: float = 30.0) -> list:
    """Kill every process that :func:`own_processes` finds, reap this
    process's own children, and wait (at most ``timeout`` seconds) until
    none is left. Returns what was found at the start."""
    import signal

    left = own_processes(run_id)
    deadline = time.monotonic() + timeout
    while True:
        alive = own_processes(run_id)
        for pid, _ in alive:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        try:
            while os.waitpid(-1, os.WNOHANG)[0]:
                pass
        except ChildProcessError:
            pass
        if not alive or time.monotonic() > deadline:
            return left
        time.sleep(0.1)


def kill_group(proc) -> None:
    """Kill ``proc`` and everything in its process group (started with
    ``start_new_session=True``: a launcher and its ranks), then reap it."""
    import signal

    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except OSError:  # the group is empty
        pass
    proc.wait()


def reset_launches(gm, fa) -> None:
    gm.reset_launches()
    fa.reset_launches()


def read_launches(gm, fa) -> dict:
    return {"gmm": gm.gmm.launches, "tgmm": gm.tgmm.launches,
            **{name: getattr(fa, name).launches for name in FLASH_KERNELS}}


def read_variants(gm, fa=None) -> dict:
    """Launches of each gmm and tgmm kernel ("wgmma", "wmma", "f32", ...),
    and with ``fa`` of each flash kernel's variants."""
    out = {"gmm": dict(gm.gmm.launches_by_variant),
           "tgmm": dict(gm.tgmm.launches_by_variant)}
    if fa is not None:
        out.update({n: dict(getattr(fa, n).launches_by_variant) for n in FLASH_KERNELS})
    return out


def flash_variants_want(fa, fwd: int, bwd: int) -> dict:
    """The bf16 training path's flash launches by variant: every one on
    the wgmma kernels."""
    zero = dict.fromkeys(fa.FLASH_VARIANTS, 0)
    return {"flash_fwd": {**zero, "wgmma": fwd}, "flash_bwd_dq": {**zero, "wgmma": bwd},
            "flash_bwd_dkv": {**zero, "wgmma": bwd}}


def launched_since(before: dict, counts: dict) -> dict:
    """The variants launched since ``before`` (a copy of ``counts``), with
    their launch counts."""
    return {k: n - before[k] for k, n in counts.items() if n != before[k]}


# -- phase 3: kernel vs plain -----------------------------------------------------
def routed_sizes(torch, rng, selections: int, experts: int, block_t: int):
    """Group sizes of one routing draw, each rounded up to block_t (the
    dispatcher's padding), and the buffer rows the dispatcher allocates."""
    from mlx_cuda_distributed_pretraining_tpu_torch.ops.grouped_matmul import round_up

    ids = torch.randint(0, experts, (selections,), generator=rng)
    counts = torch.bincount(ids, minlength=experts)
    sizes = (counts + block_t - 1) // block_t * block_t
    rows = round_up(selections + experts * (block_t - 1), block_t)
    return sizes.to(torch.int32), rows


def device_ms(torch, fn, copies: int, reps: int = 40) -> float:
    """Mean device time of ``fn(i)`` over ``reps`` back-to-back launches,
    cycling over ``copies`` weight copies (> 2x the 50 MB L2, so every
    launch reads its weights from HBM as the serving path does). A GPU
    sleep queued first lets the host enqueue every launch before the start
    event fires, so host launch overhead is not in the number."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for i in range(reps):
        fn(i % copies)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_case(torch, gm, kernel_check, name, dtype, T, K, N, sizes, block_t,
                fault=False):
    """gmm at one serving shape against its plain version; it must run the
    ``gmm_variant`` kernel. With ``fault`` the kernel is also launched with
    the last live row tile left out, which the same check must reject."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(SEED)
    E = sizes.shape[0]
    live = int(sizes.sum())
    x = torch.randn(T, K, generator=g)
    x[live:] = 0.0  # the dispatcher's tail rows are zero
    x = x.to("cuda", dt)
    w_bytes = E * K * N * x.element_size()
    copies = max(2, int(2 * 50e6 // w_bytes) + 2)
    ws = [(torch.randn(E, K, N, generator=g) / K ** 0.5).to("cuda", dt)
          for _ in range(copies)]
    gs = sizes.to("cuda")

    before = dict(gm.gmm.launches_by_variant)
    out = gm.gmm(x, ws[0], gs, block_t)
    ran = launched_since(before, gm.gmm.launches_by_variant)
    ref = gm.gmm_plain(x, ws[0], gs, block_t)
    torch.cuda.synchronize()
    # kernel_check.compare: the order of the fp32 sums only (bf16: one
    # rounding of it); tail rows exactly zero.
    check = kernel_check.compare(out, ref)
    err = check["max_abs_err"]
    ok = check["ok"] and not out[live:].any().item()
    want = gm.gmm_variant(dt, block_t, K, N)
    if ran != {want: 1}:
        ok = False
        log(f"gmm {name}: ran {ran}, not the {want} kernel")
    bad = None
    if fault:
        bad = kernel_check.compare(
            kernel_check.gmm_skipping_a_tile(x, ws[0], gs, block_t), ref)
        log(f"gmm {name} planted fault (last live row tile skipped): "
            f"limit_ratio={bad['limit_ratio']:.3g} norm={bad['norm_err']:.3g} "
            f"rejected={not bad['ok']}")
        if bad["ok"]:
            ok = False
            log(f"gmm {name}: the check passed a planted fault")

    ms = device_ms(torch, lambda i: gm.gmm(x, ws[i], gs, block_t), copies)
    plain_ms = device_ms(torch, lambda i: gm.gmm_plain(x, ws[i], gs, block_t),
                         copies, reps=10)
    library_ms, library_note = None, "torch._grouped_mm not in this torch"
    grouped_mm = getattr(torch, "_grouped_mm", None)
    if grouped_mm is not None:
        offs = torch.cumsum(gs, 0).to(torch.int32)
        try:
            grouped_mm(x, ws[0], offs=offs)
            library_ms = device_ms(
                torch, lambda i: grouped_mm(x, ws[i], offs=offs), copies)
            library_note = "torch._grouped_mm"
        except RuntimeError as e:  # a yardstick only; the port never calls it
            library_note = f"torch._grouped_mm refused {dtype}: {str(e)[:100]}"
    used = int((sizes > 0).sum())
    nbytes = (live * K + used * K * N + T * N) * x.element_size() + 4 * E
    flops = 2.0 * live * K * N
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    case = {"case": name, "dtype": dtype, "shape": [T, K, N, E],
            "block_t": block_t, "group_sizes": sizes.tolist(), "variants": ran,
            "max_abs_err": err, "check": check, "planted_fault": bad,
            "ok": bool(ok), "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library": library_note,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    log(f"gmm {name} {dtype} x[{T},{K}] w[{E},{K},{N}] block_t={block_t}: "
        f"variant={ran} max_abs_err={err:.3g} limit_ratio={check['limit_ratio']:.3g} "
        f"norm={check['norm_err']:.3g} ok={ok} kernel={ms:.4f} ms plain="
        f"{plain_ms:.4f} ms library={library_ms} ms ({library_note}) "
        f"bound={case['bound_ms']:.4f} ms ({case['bound_by']})")
    del ws
    torch.cuda.empty_cache()
    return case


def kernel_phase(torch, gm, kernel_check):
    rng = torch.Generator().manual_seed(SEED)
    E, D, I = 8, 512, 1536
    dec_sizes, dec_rows = routed_sizes(torch, rng, 16, E, 8)      # 8 slots x top-2
    pre_sizes, pre_rows = routed_sizes(torch, rng, 512, E, 32)    # 256 tokens x top-2
    cases = []
    for dtype in ("float32", "bfloat16"):
        cases.append(kernel_case(torch, gm, kernel_check, "decode_gate_up", dtype,
                                 dec_rows, D, I, dec_sizes, 8))
        cases.append(kernel_case(torch, gm, kernel_check, "prefill_gate_up", dtype,
                                 pre_rows, D, I, pre_sizes, 32))
    cases.append(kernel_case(torch, gm, kernel_check, "decode_down", "float32",
                             dec_rows, I, D, dec_sizes, 8))
    cases.append(kernel_case(torch, gm, kernel_check, "prefill_down", "float32",
                             pre_rows, I, D, pre_sizes, 32, fault=True))
    # a short last prefill chunk: 160 tokens x top-2 pick block_t 16
    short_sizes, short_rows = routed_sizes(torch, rng, 320, E, 16)
    cases.append(kernel_case(torch, gm, kernel_check, "prefill_short_down", "float32",
                             short_rows, I, D, short_sizes, 16))
    edge = torch.tensor([16, 0, 8, 0, 0, 24, 8, 0], dtype=torch.int32)
    cases.append(kernel_case(torch, gm, kernel_check, "empty_groups_tail",
                             "float32", 72, D, I, edge, 8))
    # moe-8x40m at tp 2 (phase 4e): each rank's gate/up at N = I/2, its down
    # at K = I/2
    for name, rows, sizes, bt in (("decode", dec_rows, dec_sizes, 8),
                                  ("prefill", pre_rows, pre_sizes, 32)):
        cases.append(kernel_case(torch, gm, kernel_check, f"tp2_{name}_gate_up", "float32",
                                 rows, D, I // 2, sizes, bt))
        cases.append(kernel_case(torch, gm, kernel_check, f"tp2_{name}_down", "float32",
                                 rows, I // 2, D, sizes, bt, fault=name == "prefill"))
    return cases


# -- phase 3: the MoE training path's grouped GEMMs (gmm fwd / dX, tgmm) ---------
TRAIN_SELECTIONS, TRAIN_BLOCK_T = 32 * 1024 * 2, 128  # B 32 x S 1024 x top-2


def library_call(torch, fn):
    """``fn()`` once to see whether this torch takes it; (fn, note) or
    (None, why not). A yardstick only; the port never calls it."""
    try:
        fn()
        return fn, "ok"
    except (RuntimeError, TypeError, ValueError) as e:
        return None, str(e)[:120]


def earlier_gmm(torch, gm, x, w, gs, block_t, w_trans):
    """The bf16 gmm (forward, or dX with ``w_trans``) on the WMMA kernel that
    served the training path's shapes before the wgmma one: the library's
    ``gmm_forward`` with a CTA row tile of min(block_t, 32), as the wrapper
    called it then. Measurement only; the port never launches it there."""
    T, K = x.shape
    E, N = w.shape[0], w.shape[1 if w_trans else 2]
    out = torch.empty((T, N), dtype=x.dtype, device=x.device)
    err = gm._library().gmm_forward(
        x.data_ptr(), w.data_ptr(), gs.data_ptr(), out.data_ptr(), T, K, N, E,
        min(block_t, 32), 1, int(w_trans), gm._stream(x))
    if err != 0:
        raise RuntimeError(f"WMMA gmm launch failed with CUDA error {err}")
    return out


def earlier_tgmm(torch, gm, x, dy, gs, E, block_t):
    """bf16 tgmm on its WMMA kernel (``tgmm_backward``'s kernel code 1), as
    :func:`earlier_gmm`."""
    T, K = x.shape
    N = dy.shape[1]
    dw = torch.empty((E, K, N), dtype=x.dtype, device=x.device)
    err = gm._library().tgmm_backward(
        x.data_ptr(), dy.data_ptr(), gs.data_ptr(), dw.data_ptr(), T, K, N, E,
        block_t, 1, gm._stream(x))
    if err != 0:
        raise RuntimeError(f"WMMA tgmm launch failed with CUDA error {err}")
    return dw


def against_earlier(torch, new, old) -> dict:
    """Whether the wgmma kernel's output equals the WMMA kernel's, element
    by element, on the same inputs."""
    return {"bitwise_equal": bool(torch.equal(new, old)),
            "max_abs_diff": (new.float() - old.float()).abs().max().item()}


def gemm_row(torch, kernel, plain, library, nbytes, flops, dtype, earlier=None):
    """ms of kernel, plain version and library call (device time, inputs
    larger than L2 so no copies are cycled), and the bound. ``earlier``: the
    kernel that served these shapes before the wgmma one (WMMA; gmm_int8's
    mma.sync kernel), timed in turns with it (earlier, kernel, kernel,
    earlier); ``ms`` and ``earlier_ms`` are the means of each pair."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    turns = {}
    if earlier is not None:
        turns["earlier"] = [device_ms(torch, lambda _: earlier(), 1, reps=5)]
        turns["kernel"] = [device_ms(torch, lambda _: kernel(), 1, reps=20)
                           for _ in range(2)]
        turns["earlier"].append(device_ms(torch, lambda _: earlier(), 1, reps=5))
    else:
        turns["kernel"] = [device_ms(torch, lambda _: kernel(), 1, reps=20)]
    row = {"ms": sum(turns["kernel"]) / len(turns["kernel"]),
           "earlier_ms": (sum(turns["earlier"]) / 2 if earlier is not None else None),
           "turns_ms": turns,
           "plain_ms": device_ms(torch, lambda _: plain(), 1, reps=3),
           "library_ms": (device_ms(torch, lambda _: library(), 1, reps=20)
                          if library is not None else None),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    torch.cuda.empty_cache()
    return row


def fmt_earlier(row) -> str:
    if row["earlier_ms"] is None:
        return ""
    return (f" (earlier WMMA kernel {row['earlier_ms']:.4f} ms, "
            f"{row['earlier_ms'] / row['ms']:.1f}x; turns {row['turns_ms']})")


def train_gmm_case(torch, gm, kernel_check, name, K, N, sizes, rows, w_trans,
                   fault=False, block_t=TRAIN_BLOCK_T):
    """One bf16 gmm product of the training path: the forward ``x [rows, K]
    @ w[e] [K, N]``, or with ``w_trans`` the backward's dX ``dy [rows, K] @
    w[e]^T`` with w stored ``[E, N, K]`` (the forward's weights, read in
    place). It must run the wgmma kernel; with ``fault`` the kernel is also
    launched with the last live row tile left out, which the same check must
    reject."""
    g = torch.Generator().manual_seed(SEED)
    E = sizes.shape[0]
    live = int(sizes.sum())
    x = torch.randn(rows, K, generator=g)
    x[live:] = 0.0
    x = x.to("cuda", torch.bfloat16)
    shape = (E, N, K) if w_trans else (E, K, N)
    w = (torch.randn(*shape, generator=g) / K ** 0.5).to("cuda", torch.bfloat16)
    w_kn = w.transpose(1, 2) if w_trans else w
    gs = sizes.to("cuda")
    before = dict(gm.gmm.launches_by_variant)
    out = gm._gmm_forward(x, w, gs, block_t, w_trans)
    ran = launched_since(before, gm.gmm.launches_by_variant)
    ref = gm.gmm_plain(x, w_kn, gs, block_t)
    torch.cuda.synchronize()
    check = kernel_check.compare(out, ref)
    ok = check["ok"] and not out[live:].any().item()
    if ran != {"wgmma": 1}:
        ok = False
        log(f"gmm {name}: ran {ran}, not the wgmma kernel")
    vs_wmma = against_earlier(
        torch, out, earlier_gmm(torch, gm, x, w, gs, block_t, w_trans))
    log(f"gmm {name}: wgmma vs WMMA output {vs_wmma}")
    del out
    bad = None
    if fault:
        bad = kernel_check.compare(
            kernel_check.gmm_skipping_a_tile(x, w, gs, block_t, w_trans), ref)
        log(f"gmm {name} planted fault (last live row tile skipped): "
            f"limit_ratio={bad['limit_ratio']:.3g} norm={bad['norm_err']:.3g} "
            f"rejected={not bad['ok']}")
        if bad["ok"]:
            ok = False
            log("gmm: the check passed a planted fault")
    del ref
    offs = torch.cumsum(gs, 0).to(torch.int32)
    grouped_mm = getattr(torch, "_grouped_mm", None)
    library, note = (None, "torch._grouped_mm not in this torch") \
        if grouped_mm is None else library_call(
            torch, lambda: grouped_mm(x, w_kn, offs=offs))
    used = int((sizes > 0).sum())
    row = gemm_row(
        torch, lambda: gm._gmm_forward(x, w, gs, block_t, w_trans),
        lambda: gm.gmm_plain(x, w_kn, gs, block_t), library,
        (live * K + used * K * N + rows * N) * 2 + 4 * E, 2.0 * live * K * N,
        "bfloat16",
        earlier=lambda: earlier_gmm(torch, gm, x, w, gs, block_t, w_trans))
    case = {"case": name, "dtype": "bfloat16", "shape": [rows, K, N, E],
            "block_t": block_t, "w_trans": w_trans, "variants": ran,
            "vs_wmma": vs_wmma, "max_abs_err": check["max_abs_err"], "check": check,
            "planted_fault": bad, "ok": bool(ok),
            "library": "torch._grouped_mm" if library else note, **row}
    log(f"gmm {name} bf16 x[{rows},{K}] w[{E},{K},{N}]{' (w^T)' if w_trans else ''}: "
        f"ok={ok} variant={ran} err={check['max_abs_err']:.3g} limit_ratio="
        f"{check['limit_ratio']:.3g} norm={check['norm_err']:.3g} kernel="
        f"{row['ms']:.4f} ms{fmt_earlier(row)} plain={row['plain_ms']:.4f} ms "
        f"library={row['library_ms']} ms ({case['library']}) bound="
        f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return case


def tgmm_case(torch, gm, kernel_check, name, dtype, K, N, sizes, rows, block_t,
              want, fault=False, bf16_values=False):
    """``dW = tgmm(x, dy)`` against ``tgmm_plain`` (fp32: evaluated in
    float64, ``kernel_check.reference``, the fp32 plain version's own error
    printed beside it); it must run the ``want`` variant. With ``fault``
    also the kernel with the last expert's last tile left out of its walk,
    which the same check must reject. A "wgmma" case is also held bitwise
    against the WMMA kernel that served it before, and timed in turns with
    it. ``bf16_values``: fp32 operands holding bf16 values, as the int8
    path's dW gets them. The library yardstick: ``torch._grouped_mm``; for
    fp32 one ``torch.mm`` per expert (TF32 off), with ``torch._grouped_mm``
    in fp32 beside it where this torch takes it."""
    g = torch.Generator().manual_seed(SEED)
    dt = getattr(torch, dtype)
    E = sizes.shape[0]
    live = int(sizes.sum())
    x = torch.randn(rows, K, generator=g)
    x[live:] = 0.0
    dy = torch.randn(rows, N, generator=g)
    if bf16_values:
        x, dy = x.bfloat16(), dy.bfloat16()
    x, dy = x.to("cuda", dt), dy.to("cuda", dt)
    gs = sizes.to("cuda")
    before = dict(gm.tgmm.launches_by_variant)
    dw = gm.tgmm(x, dy, gs, E, block_t)
    ran = launched_since(before, gm.tgmm.launches_by_variant)
    ref = kernel_check.reference(gm.tgmm_plain, x, dy, gs, E, block_t)
    torch.cuda.synchronize()
    check = kernel_check.compare_experts(dw, ref)
    plain_check = None
    if dt == torch.float32:  # the fp32 plain version against the same float64 result
        plain_check = kernel_check.compare_experts(gm.tgmm_plain(x, dy, gs, E, block_t), ref)
        log(f"tgmm {name}: fp32 plain version vs float64: limit_ratio="
            f"{plain_check['limit_ratio']:.3g} norm={plain_check['norm_err']:.3g}")
    empty_ok = all(not dw[e].any().item() for e in range(E) if int(sizes[e]) == 0)
    ok = check["ok"] and empty_ok
    wgmma = want == "wgmma"
    if ran != {want: 1}:
        ok = False
        log(f"tgmm {name}: ran {ran}, not the {want} kernel")
    vs_wmma = None
    if wgmma:
        vs_wmma = against_earlier(torch, dw, earlier_tgmm(torch, gm, x, dy, gs, E, block_t))
        log(f"tgmm {name}: wgmma vs WMMA output {vs_wmma}")
        if not vs_wmma["bitwise_equal"]:  # the same rounding points: the same bits
            ok = False
            log(f"tgmm {name}: the wgmma output differs from the WMMA kernel's")
    bad = None
    if fault:
        bad = kernel_check.compare_experts(
            kernel_check.tgmm_skipping_a_tile(x, dy, gs, E, block_t), ref)
        log(f"tgmm {name} planted fault (last expert's last tile skipped): "
            f"limit_ratio={bad['limit_ratio']:.3g} norm={bad['norm_err']:.3g} "
            f"rejected={not bad['ok']}")
        if bad["ok"]:
            ok = False
            log("tgmm: the check passed a planted fault")
    del ref
    offs = torch.cumsum(gs, 0).to(torch.int32)
    grouped_mm = getattr(torch, "_grouped_mm", None)
    library, note = None, "torch._grouped_mm not in this torch"
    if grouped_mm is not None:  # dW over the contraction: x^T [K, T] . dy [T, N]
        library, note = library_call(torch, lambda: grouped_mm(x.t(), dy, offs=offs))
        if library is None:
            xt = x.t().contiguous().t()
            library, note2 = library_call(
                torch, lambda: grouped_mm(xt.t(), dy, offs=offs))
            note = "x^T as a row-major copy" if library else f"{note}; {note2}"
    library_name = "torch._grouped_mm" + ("" if note == "ok" else f" ({note})")
    grouped_mm_ms = None
    if dt == torch.float32:  # one cuBLAS fp32 product per expert (TF32 is off)
        if library is not None:
            grouped_mm_ms = device_ms(torch, lambda _: library(), 1, reps=20)
        starts = [0] + torch.cumsum(sizes, 0).tolist()
        spans = [(starts[e], starts[e + 1]) for e in range(E) if sizes[e] > 0]

        def per_expert_mm():
            for a, b in spans:
                torch.mm(x[a:b].t(), dy[a:b])

        library, library_name = per_expert_mm, f"torch.mm per expert ({len(spans)} calls)"
    es = x.element_size()
    row = gemm_row(torch, lambda: gm.tgmm(x, dy, gs, E, block_t),
                   lambda: gm.tgmm_plain(x, dy, gs, E, block_t), library,
                   live * (K + N) * es + E * K * N * es + 4 * E,
                   2.0 * live * K * N, dtype,
                   earlier=(lambda: earlier_tgmm(torch, gm, x, dy, gs, E, block_t))
                   if wgmma else None)
    case = {"case": name, "dtype": dtype, "shape": [rows, K, N, E],
            "block_t": block_t, "group_sizes": sizes.tolist(), "variants": ran,
            "bf16_values": bf16_values, "vs_wmma": vs_wmma,
            "max_abs_err": check["max_abs_err"], "check": check,
            "plain_fp32_check": plain_check, "planted_fault": bad, "ok": bool(ok),
            "library": library_name if library else note,
            "grouped_mm_fp32_ms": grouped_mm_ms,
            "grouped_mm_fp32_note": note if dt == torch.float32 else None, **row}
    log(f"tgmm {name} {dtype} x[{rows},{K}] dy[{rows},{N}] E={E} block_t="
        f"{block_t}: ok={ok} variant={ran} err={check['max_abs_err']:.3g} limit_ratio="
        f"{check['limit_ratio']:.3g} norm={check['norm_err']:.3g} kernel="
        f"{row['ms']:.4f} ms{fmt_earlier(row)} plain={row['plain_ms']:.4f} ms library="
        f"{row['library_ms']} ms ({case['library']}) bound={row['bound_ms']:.4f} "
        f"ms ({row['bound_by']})" + (f" grouped_mm fp32={grouped_mm_ms} ms"
                                     if dt == torch.float32 else ""))
    return case


def train_kernel_phase(torch, gm, kernel_check):
    """(gmm cases, tgmm cases) at the MoE training path's shapes."""
    rng = torch.Generator().manual_seed(SEED + 1)
    E, D, I = 8, 512, 1536
    sizes, rows = routed_sizes(torch, rng, TRAIN_SELECTIONS, E, TRAIN_BLOCK_T)
    gmm_cases = [
        train_gmm_case(torch, gm, kernel_check, "train_gate_up", D, I, sizes, rows, False,
                       fault=True),
        train_gmm_case(torch, gm, kernel_check, "train_down", I, D, sizes, rows, False),
        train_gmm_case(torch, gm, kernel_check, "train_dx_gate_up", I, D, sizes, rows, True),
        train_gmm_case(torch, gm, kernel_check, "train_dx_down", D, I, sizes, rows, True),
    ]
    # one expert takes half of the selections, the rest share the other half
    hot = torch.full((E,), TRAIN_SELECTIONS // (2 * (E - 1)), dtype=torch.int64)
    hot[0] = TRAIN_SELECTIONS - int(hot[1:].sum())
    hot = ((hot + TRAIN_BLOCK_T - 1) // TRAIN_BLOCK_T * TRAIN_BLOCK_T).to(torch.int32)
    edge = torch.tensor([256, 0, 128, 0, 384, 128, 128, 0], dtype=torch.int32)
    small, small_rows = routed_sizes(torch, rng, 4096, E, 32)
    tgmm_cases = [
        tgmm_case(torch, gm, kernel_check, "path_gate_up", "bfloat16", D, I, sizes,
                  rows, TRAIN_BLOCK_T, "wgmma", fault=True),
        tgmm_case(torch, gm, kernel_check, "path_down", "bfloat16", I, D, sizes,
                  rows, TRAIN_BLOCK_T, "wgmma"),
        tgmm_case(torch, gm, kernel_check, "imbalanced_gate_up", "bfloat16", D, I,
                  hot, rows, TRAIN_BLOCK_T, "wgmma"),
        tgmm_case(torch, gm, kernel_check, "fp32_gate_up", "float32", D, I, small,
                  small_rows, 32, "f32", fault=True),
        # the int8 path's dW: fp32 copies of bf16 x and dy at its shapes
        tgmm_case(torch, gm, kernel_check, "int8_path_gate_up", "float32", D, I, sizes,
                  rows, TRAIN_BLOCK_T, "f32", fault=True, bf16_values=True),
        tgmm_case(torch, gm, kernel_check, "int8_path_down", "float32", I, D, sizes,
                  rows, TRAIN_BLOCK_T, "f32", fault=True, bf16_values=True),
        tgmm_case(torch, gm, kernel_check, "empty_groups_tail", "bfloat16", D, I,
                  edge, 1280, TRAIN_BLOCK_T, "wgmma"),
    ]
    return gmm_cases, tgmm_cases


INT8_REPLACES = "mlx_cuda_distributed_pretraining_tpu/ops/grouped_matmul.py:235"
INT8_PEAK_OPS = 1979e12  # H100 SXM int8 tensor cores, dense


def earlier_int8(torch, gm, xq, sx, wq, sw, gs, block_t, dtype):
    """gmm_int8 on its ``mma.sync`` kernel (the C entry's variant 0, 64-row
    tiles), which served the training path's shapes before the s8 wgmma
    kernel, with the wrapper's operand preparation. Measurement only; the
    port launches it where block_t has no 64-row tile."""
    T, K = xq.shape
    E, _, N = wq.shape
    pad = -K % 64
    wqt = wq.transpose(1, 2)
    if pad:
        xq, wqt = (torch.nn.functional.pad(xq, (0, pad)),
                   torch.nn.functional.pad(wqt, (0, pad)))
    xq, wqt = xq.contiguous(), wqt.contiguous()
    sx, sw = sx.reshape(T).float().contiguous(), sw.reshape(E, N).float().contiguous()
    out = torch.empty((T, N), dtype=dtype, device=xq.device)
    err = gm._library().gmm_int8(
        xq.data_ptr(), wqt.data_ptr(), gs.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        out.data_ptr(), None, T, K + pad, N, E, min(block_t, 64), 0,
        1 if dtype == torch.bfloat16 else 0, gm._stream(xq))
    if err != 0:
        raise RuntimeError(f"mma.sync gmm_int8 launch failed with CUDA error {err}")
    return out


def int8_gmm_case(torch, gm, kernel_check, name, K, N, sizes, rows, bf16_case,
                  fault=False):
    """``gmm_int8`` at one MoE training shape (bf16 in and out, block_t 128)
    against its plain version: the int32 sums bitwise, the output through
    ``kernel_check.compare_int8``; it must run the "wgmma" variant; with
    ``fault`` the kernel is also launched with the last live row tile left
    out, which the check must reject. Its output must equal the ``mma.sync``
    kernel's (:func:`earlier_int8`) bit for bit, timed in turns with it.
    Timed beside the plain version, ``torch._int_mm`` summed over the
    experts' rows (E calls; PyTorch has no grouped int8 product) and the
    bf16 gmm kernel at the same shape (``bf16_case``)."""
    g = torch.Generator().manual_seed(SEED + 2)
    E = sizes.shape[0]
    live = int(sizes.sum())
    x = torch.randn(rows, K, generator=g)
    x[live:] = 0.0
    x = x.to("cuda", torch.bfloat16)
    w = (torch.randn(E, K, N, generator=g) / K ** 0.5).to("cuda", torch.bfloat16)
    gs = sizes.to("cuda")
    xq, sx, wq, sw = kernel_check.int8_operands(x, w)
    before = dict(gm.gmm_int8.launches_by_variant)
    out, acc = gm.gmm_int8_kernel(xq, sx, wq, sw, gs, TRAIN_BLOCK_T, torch.bfloat16,
                                  with_products=True)
    ran = launched_since(before, gm.gmm_int8.launches_by_variant)
    ref_acc, ref_out = kernel_check.gmm_int8_plain_outputs(xq, sx, wq, sw, gs,
                                                           TRAIN_BLOCK_T, torch.bfloat16)
    torch.cuda.synchronize()
    check = kernel_check.compare_int8(acc, out, ref_acc, ref_out)
    ok = check["ok"] and not out[live:].any().item()
    if ran != {"wgmma": 1}:
        ok = False
        log(f"gmm_int8 {name}: ran {ran}, not the wgmma kernel")
    vs_mma = against_earlier(torch, out, earlier_int8(torch, gm, xq, sx, wq, sw, gs,
                                                      TRAIN_BLOCK_T, torch.bfloat16))
    log(f"gmm_int8 {name}: wgmma vs mma.sync output {vs_mma}")
    if not vs_mma["bitwise_equal"]:  # exact int32 sums, the same epilogue: the same bits
        ok = False
    del out, acc
    bad = None
    if fault:
        bad = kernel_check.compare_int8(*kernel_check.gmm_int8_skipping_a_tile(
            xq, sx, wq, sw, gs, TRAIN_BLOCK_T, torch.bfloat16), ref_acc, ref_out)
        log(f"gmm_int8 {name} planted fault (last live row tile skipped): int32_equal="
            f"{bad['int32_equal']} limit_ratio={bad['limit_ratio']:.3g} rejected={not bad['ok']}")
        if bad["ok"]:
            ok = False
            log("gmm_int8: the check passed a planted fault")
    del ref_acc, ref_out
    starts = [0] + torch.cumsum(sizes, 0).tolist()
    spans = [(e, starts[e], starts[e + 1]) for e in range(E) if sizes[e] > 0]

    def int_mm():
        for e, a, b in spans:
            torch._int_mm(xq[a:b], wq[e])

    library, note = library_call(torch, int_mm)
    # int8 operands and scales read once, the bf16 output written once
    nbytes = live * K + len(spans) * K * N + rows * N * 2 + 4 * rows + 4 * E * N + 4 * E
    row = gemm_row(
        torch, lambda: gm.gmm_int8_kernel(xq, sx, wq, sw, gs, TRAIN_BLOCK_T, torch.bfloat16),
        lambda: kernel_check.gmm_int8_plain_outputs(xq, sx, wq, sw, gs, TRAIN_BLOCK_T,
                                                    torch.bfloat16),
        library, nbytes, 2.0 * live * K * N, "bfloat16",
        earlier=lambda: earlier_int8(torch, gm, xq, sx, wq, sw, gs, TRAIN_BLOCK_T,
                                     torch.bfloat16))
    # the operation bound at the int8 rate, not bf16's
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = 2.0 * live * K * N / INT8_PEAK_OPS * 1e3
    row.update(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
    case = {"case": name, "dtype": "int8->bfloat16", "shape": [rows, K, N, E],
            "block_t": TRAIN_BLOCK_T, "group_sizes": sizes.tolist(), "variants": ran,
            "vs_mma_sync": vs_mma,
            "max_abs_err": check["max_abs_err"], "check": check, "planted_fault": bad,
            "ok": bool(ok), "bf16_gmm_ms": bf16_case["ms"],
            "library": ("torch._int_mm summed over the experts' rows (E calls)"
                        if library else note), **row}
    log(f"gmm_int8 {name} x[{rows},{K}] w[{E},{K},{N}]: ok={ok} variant={ran} int32_equal="
        f"{check['int32_equal']} err={check['max_abs_err']:.3g} kernel={row['ms']:.4f} ms"
        f"{fmt_earlier(row).replace('WMMA', 'mma.sync')} "
        f"plain={row['plain_ms']:.4f} ms library={row['library_ms']} ms ({case['library']}) "
        f"bf16 gmm={bf16_case['ms']:.4f} ms bound={row['bound_ms']:.4f} ms ({row['bound_by']})")
    return case


def int8_kernel_phase(torch, gm, kernel_check, train_cases):
    """``gmm_int8`` at the MoE training path's gate/up and down shapes (the
    same routing draw as the bf16 training cases)."""
    rng = torch.Generator().manual_seed(SEED + 1)
    sizes, rows = routed_sizes(torch, rng, TRAIN_SELECTIONS, 8, TRAIN_BLOCK_T)
    by = {c["case"]: c for c in train_cases}
    return [int8_gmm_case(torch, gm, kernel_check, "int8_train_gate_up", 512, 1536, sizes,
                          rows, by["train_gate_up"], fault=True),
            int8_gmm_case(torch, gm, kernel_check, "int8_train_down", 1536, 512, sizes,
                          rows, by["train_down"])]


# -- phase 3: the flash kernels vs plain -------------------------------------------
# (name, dtype, B, Hq, Hkv, S, D, mask): the 1B trainer's shape first, then
# the 40m / MoE training path's.
FLASH_CASES = [
    ("path_1b", "bfloat16", 8, 16, 16, 2048, 128, "causal"),
    ("path", "bfloat16", 32, 8, 8, 1024, 64, "causal"),
    ("path_fp32", "float32", 32, 8, 8, 1024, 64, "causal"),
    ("fp32", "float32", 4, 8, 8, 1024, 64, "causal"),
    ("gqa", "bfloat16", 8, 8, 2, 1024, 64, "causal"),
    ("tail", "bfloat16", 8, 8, 8, 1000, 64, "causal"),
    ("tail_fp32", "float32", 2, 8, 2, 1000, 64, "causal"),
    ("sliding_window", "bfloat16", 8, 8, 8, 1024, 64, "sliding_window"),
    ("prefix_lm", "bfloat16", 8, 8, 8, 1024, 64, "prefix_lm"),
    ("full", "bfloat16", 8, 8, 8, 1024, 64, "full"),
    ("d128", "bfloat16", 8, 8, 8, 1024, 128, "causal"),
    ("d128_fp32", "float32", 2, 8, 8, 1024, 128, "causal"),
    ("path_80m", "bfloat16", 32, 16, 8, 2048, 64, "causal"),
    # 1b-tp's per-rank shape as phase 7c cuts it (16 heads over tp 4,
    # BATCH_TP rows), and at the config's batch: the batch splits over the
    # data axes only, so a rank of 1b-tp runs B 32 at 4 heads
    ("path_1b_tp", "bfloat16", 2, 4, 4, 2048, 128, "causal"),
    ("path_1b_tp_b32", "bfloat16", 32, 4, 4, 2048, 128, "causal"),
    # 1b-fsdp's shape (phase 7b: B 32). There dQ's worst element against
    # the bf16 plain version sat 1.23x its limit: where they differ most the
    # kernel is the nearer to float64, and both sit 2.76x the limit from it
    # (scripts/flash_bf16_reference.py), so a miss is held to float64
    # (kernel_check.no_worse_than_plain)
    ("path_1b_fsdp", "bfloat16", 32, 16, 16, 2048, 128, "causal", {"f64_arbiter": True}),
]
WINDOW, PREFIX = 256, 384
FP32_CASES = ("path_fp32", "fp32", "tail_fp32", "d128_fp32")
# The kernels the redesigned rows replaced. They left the library, so
# scripts/time_kernels.py times them in turns with their successors from an
# unpacked parent tree (--root); PERF.md keeps those times.
EARLIER = {
    "flash_bwd_dq": "bf16 SIMT dQ (32-row tiles), timed by scripts/time_kernels.py --root",
    "flash_fwd": "fp32 SIMT forward (32-row tiles), timed by scripts/time_kernels.py --root",
    "flash_bwd_dq_f32": "fp32 SIMT dQ (32-row tiles), timed by scripts/time_kernels.py --root",
    "flash_bwd_dkv_f32": "fp32 SIMT dK/dV (32-row tiles), timed by scripts/time_kernels.py "
                         "--root",
}
# The flex slice's cases, (name, dtype, B, Hq, Hkv, S, D, mask, extras): score
# mods at the 100m-muon shape (B 32, H 12, S 1024, D 64) and the 1B's, the
# 1m-flex shape (sliding 128 + alibi, D 16) and the 1M configs' (GQA 4/2, D
# 32), where the three kernels run wgmma on 32- and 64-byte swizzles, the
# band mask, and the main path's shape with no mod. Every one takes a
# planted fault.
FLEX_CASES = [
    ("path_100m", "bfloat16", 32, 12, 12, 1024, 64, "causal", {}),
    ("flex_softcap_100m", "bfloat16", 32, 12, 12, 1024, 64, "causal",
     {"mod": "soft_cap", "arg": 50.0}),
    ("flex_alibi_100m", "bfloat16", 32, 12, 12, 1024, 64, "sliding_window",
     {"window": 128, "mod": "alibi", "arg": 12.0}),
    ("flex_softcap_1b", "bfloat16", 8, 16, 16, 2048, 128, "causal",
     {"mod": "soft_cap", "arg": 50.0}),
    ("path_1m_flex", "bfloat16", 16, 6, 6, 512, 16, "sliding_window",
     {"window": 128, "mod": "alibi", "arg": 6.0}),
    ("path_1m", "bfloat16", 16, 4, 2, 512, 32, "causal", {}),
    ("band", "bfloat16", 8, 8, 8, 1024, 64, "band", {"window": 256}),
]


def flash_work(fa, dtype, B, Hq, Hkv, S, D, mask, window=WINDOW, prefix=PREFIX):
    """(bytes, operations) each kernel needs for these inputs: every input
    read once and every output written once; the products over the pairs
    (row, col) the mask lets through (2 per multiply-add): fwd q.k^T and
    p.v, dQ q.k^T, dO.v^T and dS.k, dK/dV q.k^T, dO.v^T, p^T.dO and dS^T.q.
    A score mod adds elementwise work only, which is not counted."""
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import masks

    mod = fa._mask_mod(mask, window, prefix)
    pairs = S * S if mod is None else int(
        masks.materialize_mask(mod, S, S, device="cuda").sum().item())
    es = 2 if dtype == "bfloat16" else 4
    q_el, kv_el, stat = B * Hq * S * D, B * Hkv * S * D, B * Hq * S * 4
    per_product = 2.0 * B * Hq * D * pairs
    return {"flash_fwd": ((2 * q_el + 2 * kv_el) * es + stat, 2 * per_product),
            "flash_bwd_dq": ((3 * q_el + 2 * kv_el) * es + 2 * stat, 3 * per_product),
            "flash_bwd_dkv": ((4 * q_el + 2 * kv_el) * es + 2 * stat, 4 * per_product)}


def sdpa_calls(torch, q, k, v, do, mask, scale, window=WINDOW, prefix=PREFIX,
               mod="none", arg=0.0):
    """``F.scaled_dot_product_attention`` forward, and forward + backward,
    on the same inputs: a yardstick only, the port never calls it. ALiBi
    rides a float ``attn_mask`` (the bias where the mask allows, -inf
    elsewhere); soft_cap goes to :func:`flex_calls`."""
    import torch.nn.functional as F

    from mlx_cuda_distributed_pretraining_tpu_torch.ops import flash_attention as fa
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import masks

    if mod == "soft_cap":
        return flex_calls(torch, q, k, v, do, mask, scale, window, prefix, arg)
    G = q.shape[1] // k.shape[1]
    if G > 1:
        k, v = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    kw = {"scale": scale}
    S = q.shape[2]
    if mod == "alibi":
        pos = torch.arange(S, device="cuda")
        heads = torch.arange(q.shape[1], device="cuda", dtype=torch.float32)
        slope = torch.exp2(-8.0 * (heads + 1.0) / arg)[:, None, None]
        bias = -slope * (pos[:, None] - pos[None, :]).abs().float()
        allowed = masks.materialize_mask(fa._mask_mod(mask, window, prefix), S, S,
                                         device="cuda")
        if allowed is not None:
            bias = bias.masked_fill(~allowed, float("-inf"))
        kw["attn_mask"] = bias[None].to(q.dtype)
    elif mask == "causal":
        kw["is_causal"] = True
    elif mask != "full":
        kw["attn_mask"] = masks.materialize_mask(fa._mask_mod(mask, window, prefix), S, S,
                                                 device="cuda")
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd(_):
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, **kw)

    def fwd_bwd(_):
        F.scaled_dot_product_attention(qg, kg, vg, **kw).backward(do)

    return fwd, fwd_bwd


# The soft_cap yardstick's compiled callable, block masks and score mods,
# made once: dynamo reuses a compiled graph only for the same callable and
# the same score_mod and block-mask objects, so the cases find what
# warm_flex compiled beside the build.
_FLEX = {}


def _flex_pieces(torch, mask, window, prefix, S, cap):
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    from mlx_cuda_distributed_pretraining_tpu_torch.ops import flash_attention as fa

    if "compiled" not in _FLEX:
        _FLEX["compiled"] = torch.compile(flex_attention, dynamic=False)
    if (mask, window, prefix, S) not in _FLEX:
        mod = fa._mask_mod(mask, window, prefix)
        _FLEX[(mask, window, prefix, S)] = None if mod is None else create_block_mask(
            lambda b, h, qi, ki: mod(qi, ki), None, None, S, S, device="cuda")
    if cap not in _FLEX:
        def soft_cap(score, b, h, qi, ki):
            return cap * torch.tanh(score / cap)
        _FLEX[cap] = soft_cap
    return _FLEX["compiled"], _FLEX[(mask, window, prefix, S)], _FLEX[cap]


def flex_calls(torch, q, k, v, do, mask, scale, window, prefix, cap, when="at its case"):
    """``torch.nn.attention.flex_attention.flex_attention`` under
    ``torch.compile`` with the soft-cap ``score_mod`` (cap tanh(s / cap) of
    the scaled score) and the mask as a block mask: forward, and forward +
    backward, on the same inputs. A yardstick only; the port never calls
    it. The first call of each compiles it; its seconds are printed on a
    line of their own."""
    compiled, block_mask, soft_cap = _flex_pieces(torch, mask, window, prefix, q.shape[2], cap)
    G = q.shape[1] // k.shape[1]
    k, v = (t.repeat_interleave(G, dim=1) if G > 1 else t for t in (k, v))
    q, k, v = (t.contiguous() for t in (q, k, v))
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd(_):
        with torch.no_grad():
            return compiled(q, k, v, score_mod=soft_cap, block_mask=block_mask, scale=scale)

    def fwd_bwd(_):
        compiled(qg, kg, vg, score_mod=soft_cap, block_mask=block_mask,
                 scale=scale).backward(do)

    secs = {}
    for name, fn in (("forward", fwd), ("forward + backward", fwd_bwd)):
        t0 = time.perf_counter()
        fn(0)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    log(f"library compile ({when}): flex_attention soft_cap {cap} {mask} {tuple(q.shape)}: "
        + ", ".join(f"{n} {t:.1f}s" for n, t in secs.items()))
    return fwd, fwd_bwd


def warm_flex(torch) -> None:
    """Compile the soft_cap yardstick for every soft_cap case on inputs of
    its shapes and layout, while nvcc builds the kernels and the card is
    idle; a failure only leaves the compile to the case."""
    try:
        for name, dtype, B, Hq, Hkv, S, D, mask, extras in FLEX_CASES:
            if extras.get("mod") != "soft_cap":
                continue
            q, k, v, do = (torch.randn(B, S, h, D, device="cuda", dtype=getattr(torch, dtype))
                           .transpose(1, 2) for h in (Hq, Hkv, Hkv, Hq))
            flex_calls(torch, q, k, v, do, mask, D ** -0.5, extras.get("window", WINDOW),
                       extras.get("prefix", PREFIX), extras["arg"], when="beside the build")
            del q, k, v, do
    except Exception as e:  # noqa: BLE001 (a yardstick only)
        log(f"library compile beside the build failed: {type(e).__name__}: {str(e)[:200]}")


def fmt_checks(checks: dict) -> str:
    return " ".join(f"{o}:err={c['max_abs_err']:.3g},limit_ratio="
                    f"{c['limit_ratio']:.3g},norm_err={c['norm_err']:.3g}"
                    for o, c in checks.items())


def flash_case(torch, gm, fa, name, dtype, B, Hq, Hkv, S, D, mask, extras=None):
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import kernel_check

    extras = dict(extras or {})
    window, prefix = extras.get("window", WINDOW), extras.get("prefix", PREFIX)
    mod, arg = extras.get("mod", "none"), extras.get("arg", 0.0)
    g = torch.Generator().manual_seed(SEED)
    dt = getattr(torch, dtype)
    # [B, H, S, D] views of [B, S, H, D] tensors: the model's layout.
    q, k, v, do = (torch.randn(B, S, h, D, generator=g).to("cuda", dt)
                   .transpose(1, 2) for h in (Hq, Hkv, Hkv, Hq))
    kw = dict(mask_type=mask, window=window, prefix_len=prefix, scale=D ** -0.5,
              score_mod=mod, score_arg=arg)
    before = read_variants(gm, fa)
    before_mod = {n: dict(getattr(fa, n).launches_by_mod) for n in FLASH_KERNELS}
    o, lse = fa.flash_fwd(q, k, v, **kw)
    ro, rlse = fa.flash_fwd_plain(q, k, v, **kw)
    delta = (do.float() * ro.float()).sum(-1).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, do, rlse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, rlse, delta, **kw)
    torch.cuda.synchronize()
    after = read_variants(gm, fa)
    ran = {n: launched_since(before[n], after[n]) for n in FLASH_KERNELS}
    ran_mod = {n: launched_since(before_mod[n], getattr(fa, n).launches_by_mod)
               for n in FLASH_KERNELS}
    variant = {n: fa.flash_variant(n, dt, D) for n in FLASH_KERNELS}
    want_ran = {n: {variant[n]: 1} for n in FLASH_KERNELS}
    rdq = fa.flash_bwd_dq_plain(q, k, v, do, rlse, delta, **kw)
    rdk, rdv = fa.flash_bwd_dkv_plain(q, k, v, do, rlse, delta, **kw)
    refs = {"o": ro, "dq": rdq, "dk": rdk, "dv": rdv}
    ref_lse, plain_ratio = rlse, None
    if dtype == "float32":
        # The fp32 kernels are held to the plain versions evaluated in
        # float64 (kernel_check.reference); the fp32 plain version's own
        # limit ratio against them is printed beside the kernel's.
        xo, ref_lse = kernel_check.reference(fa.flash_fwd_plain, q, k, v, **kw)
        xdk, xdv = kernel_check.reference(fa.flash_bwd_dkv_plain, q, k, v, do, rlse, delta,
                                          **kw)
        exact = {"o": xo, "dq": kernel_check.reference(fa.flash_bwd_dq_plain, q, k, v, do,
                                                       rlse, delta, **kw),
                 "dk": xdk, "dv": xdv}
        plain_ratio = {out: kernel_check.compare(refs[out], exact[out])["limit_ratio"]
                       for out in refs}
        refs = exact
        del exact, xo, xdk, xdv
    # kernel_check.compare: per element atol 2**-5 x RMS / rtol 2e-2 and
    # normwise 1e-2 for bf16; 1e-5 x RMS / 1e-4 and 1e-5 for fp32. lse is
    # fp32 in both versions: 1e-5; the wgmma soft_cap's tanh (from
    # ex2.approx, within ~5e-7 absolute) moves a score by up to 5e-7 x cap,
    # so there 1e-5 + 2^-20 x cap.
    got = {"o": o, "dq": dq, "dk": dk, "dv": dv}
    checks = {out: kernel_check.compare(got[out], refs[out]) for out in refs}
    exacts = {}
    if extras.get("f64_arbiter"):
        # an output that misses the bf16 plain version is held to the plain
        # version evaluated in float64 (kernel_check.no_worse_than_plain);
        # the planted fault below is held to the same check
        exacts = {out: flash_f64(torch, fa, out, q, k, v, do, rlse, delta, kw)
                  for out in refs}
        for out in [o_ for o_, c in checks.items() if not c["ok"]]:
            arb = kernel_check.no_worse_than_plain(got[out], refs[out], exacts[out])
            log(f"flash {name} {out}: misses the bf16 plain version by "
                f"{checks[out]['limit_ratio']:.3g}x its limit; against float64 (the bf16 "
                f"plain version {arb['plain_limit_ratio']:.3g}x the limit from it) the "
                f"kernel's excess over the plain version's distance {arb['limit_ratio']:.3g}x "
                f"the limit, normwise {arb['norm_err']:.3g}: ok {arb['ok']}")
            checks[out] = dict(arb, bf16_plain_limit_ratio=checks[out]["limit_ratio"])
    errs = {out: c["max_abs_err"] for out, c in checks.items()}
    errs["lse"] = (lse - ref_lse).abs().max().item()
    lse_atol = 1e-5 + (2.0 ** -20 * arg if mod == "soft_cap" and variant["flash_fwd"] == "wgmma"
                       else 0.0)
    ok = all(c["ok"] for c in checks.values()) and bool(torch.isfinite(lse).all()) \
        and torch.allclose(lse, ref_lse, atol=lse_atol, rtol=1e-5)
    if ran != want_ran or ran_mod != {n: {mod: 1} for n in FLASH_KERNELS}:
        ok = False
        log(f"flash {name}: ran {ran} {ran_mod}, not {want_ran} with {mod}")
    fault = fault_f64 = None
    if name.startswith(("path", "flex", "band")) or dtype == "float32":
        # The same check on a planted fault: one live tile left out of each
        # kernel's plan. Every output must fail it, and fail the float64
        # arbiter too where the case has one.
        with kernel_check.planted_fault():
            bad = kernel_check.kernel_outputs(q, k, v, do, rlse, delta, **kw)
        fault = {out: kernel_check.compare(bad[out], refs[out]) for out in refs}
        log(f"flash {name} planted fault (one live tile skipped): "
            + fmt_checks(fault))
        if any(c["ok"] for c in fault.values()):
            ok = False
            log(f"flash {name}: the check passed a planted fault")
        if exacts:
            fault_f64 = {out: kernel_check.no_worse_than_plain(bad[out], refs[out], e)
                         for out, e in exacts.items()}
            log(f"flash {name} planted fault against float64 (no_worse_than_plain): "
                + " ".join(f"{out}: limit_ratio={c['limit_ratio']:.3g} "
                           f"norm_err={c['norm_err']:.3g} ok={c['ok']}"
                           for out, c in fault_f64.items()))
            if any(c["ok"] for c in fault_f64.values()):
                ok = False
                log(f"flash {name}: the float64 arbiter passed a planted fault")
        del bad
    del ro, rdq, rdk, rdv, o, dq, dk, dv, refs, got, exacts
    torch.cuda.empty_cache()

    work = flash_work(fa, dtype, B, Hq, Hkv, S, D, mask, window, prefix)
    try:  # a yardstick only; the port never calls it
        lib = sdpa_calls(torch, q, k, v, do, mask, D ** -0.5, window, prefix, mod, arg)
        library = {"fwd": device_ms(torch, lib[0], 1, reps=10),
                   "fwd_bwd": device_ms(torch, lib[1], 1, reps=10)}
        library_note = (
            "flex_attention under torch.compile (soft-cap score_mod, block mask)"
            if mod == "soft_cap" else "F.scaled_dot_product_attention" + (
                " (ALiBi and the mask as a float attn_mask)" if mod == "alibi" else ""))
    except Exception as e:  # noqa: BLE001 (a compile or launch refusal is reported)
        library, library_note = {}, f"library call refused: {type(e).__name__}: {str(e)[:200]}"
        log(f"flash {name}: {library_note}")
    torch.cuda.empty_cache()
    calls = {
        "flash_fwd": (lambda _: fa.flash_fwd(q, k, v, **kw),
                      lambda _: fa.flash_fwd_plain(q, k, v, **kw), "fwd"),
        "flash_bwd_dq": (lambda _: fa.flash_bwd_dq(q, k, v, do, rlse, delta, **kw),
                         lambda _: fa.flash_bwd_dq_plain(q, k, v, do, rlse, delta, **kw),
                         "fwd_bwd"),
        "flash_bwd_dkv": (lambda _: fa.flash_bwd_dkv(q, k, v, do, rlse, delta, **kw),
                          lambda _: fa.flash_bwd_dkv_plain(q, k, v, do, rlse, delta, **kw),
                          "fwd_bwd"),
    }
    rows = {}
    for kname, (kernel, plain, lib) in calls.items():
        nbytes, flops = work[kname]
        t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
        row = {"ms": device_ms(torch, kernel, 1, reps=20)}
        row.update(plain_ms=device_ms(torch, plain, 1, reps=5),
                   library_ms=library.get(lib), library=library_note,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   tflops=flops / row["ms"] * 1e-9)
        rows[kname] = row
        torch.cuda.empty_cache()
    case = {"case": name, "dtype": dtype, "shape": [B, Hq, Hkv, S, D],
            "mask": mask, "window": window, "prefix": prefix, "score_mod": mod,
            "score_arg": arg, "variant": variant,
            "max_abs_err": errs, "checks": checks, "variants": ran,
            "plain_fp32_limit_ratio": plain_ratio,
            "planted_fault": fault, "planted_fault_f64": fault_f64, "ok": bool(ok),
            "kernels": rows}
    log(f"flash {name} {dtype} B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} {mask} "
        f"(window {window}, prefix {prefix}) mod={mod}({arg}): "
        f"ok={ok} variants={ran} lse:err={errs['lse']:.3g} " + fmt_checks(checks)
        + ("" if plain_ratio is None else " | the fp32 plain version's own limit_ratio: "
           + " ".join(f"{o}:{r:.3g}" for o, r in plain_ratio.items())))
    for kname, r in rows.items():
        log(f"  {kname}: kernel={r['ms']:.4f} ms {r['tflops']:.1f} TFLOP/s "
            f"plain={r['plain_ms']:.4f} ms library={r['library_ms']} ms "
            f"({library_note}) bound={r['bound_ms']:.4f} ms ({r['bound_by']})")
    if library.get("fwd_bwd") is not None:
        both = rows["flash_bwd_dq"]["ms"] + rows["flash_bwd_dkv"]["ms"]
        log(f"  dQ + dK/dV {both:.4f} ms vs {library_note} forward + backward "
            f"{library['fwd_bwd']:.4f} ms ({both / library['fwd_bwd']:.2f}x)")
    return case


def flash_f64(torch, fa, out, q, k, v, do, lse, delta, kw, rows: int = 4):
    """The plain version of ``out`` ("o", "dq", "dk" or "dv") evaluated in
    float64 on the same (bf16) inputs, ``rows`` batch rows at a time."""
    parts = []
    for b0 in range(0, q.shape[0], rows):
        x = [t[b0:b0 + rows].double() for t in (q, k, v, do, lse, delta)]
        if out == "o":
            parts.append(fa.flash_fwd_plain(*x[:3], **kw)[0])
        elif out == "dq":
            parts.append(fa.flash_bwd_dq_plain(*x, **kw))
        else:
            parts.append(fa.flash_bwd_dkv_plain(*x, **kw)[out == "dv"])
    return torch.cat(parts)


def flash_kernel_phase(torch, gm, fa):
    return [flash_case(torch, gm, fa, *c) for c in FLASH_CASES + FLEX_CASES]


# -- phase 4: the serving path ----------------------------------------------------
def post(url: str, body: dict, timeout: float = 600.0, path: str = "/generate",
         headers: dict = None):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, {"error": e.read().decode(errors="replace")}


def get_url(url: str, timeout: float = 60.0):
    """``(status, body bytes)`` of a GET."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read()


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def trace_ids(n: int):
    return ["%032x" % (0x5EED0000 + i) for i in range(n)]


def cpu_first_logits(torch, args, params_cpu, prompt_ids):
    """The port's plain path on the CPU: chunked paged prefill of one prompt
    (same chunking as the engine), returning the last token's logits."""
    from mlx_cuda_distributed_pretraining_tpu_torch.models import llama
    from mlx_cuda_distributed_pretraining_tpu_torch.serve import batch_step

    C, bs = 256, 32
    P = len(prompt_ids)
    nblk = -(-P // bs)
    cache = llama.init_paged_cache(args, nblk + 1, bs, device="cpu")
    table = torch.zeros(1024 // bs, dtype=torch.long)
    table[:nblk] = torch.arange(1, nblk + 1)
    logits = None
    for start in range(0, P, C):
        n = min(C, P - start)
        toks = torch.zeros(C, dtype=torch.long)
        toks[:n] = torch.tensor(prompt_ids[start:start + n])
        attend = min(batch_step.round_up(
            batch_step.attend_bucket(start + C, 1024), bs), 1024)
        logits = batch_step.paged_prefill_step(
            params_cpu, cache, toks, table, start, n - 1, args, attend, bs,
            with_logits=start + n >= P)
    return logits[0]


def path_phase(torch, gm, fa, card):
    from mlx_cuda_distributed_pretraining_tpu_torch.infer.server import (
        InferenceService,
        serve,
    )
    from mlx_cuda_distributed_pretraining_tpu_torch.models import llama
    from mlx_cuda_distributed_pretraining_tpu_torch.serve import EngineConfig
    from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import TokenizerManager

    failures = []
    args = llama.LlamaArgs(**MOE_8X40M)
    tok = TokenizerManager()
    t0 = time.perf_counter()
    params = llama.init_params(args, torch.Generator().manual_seed(SEED),
                               device="cuda")
    torch.cuda.synchronize()
    n_params = llama.num_params(params)
    log(f"path: moe-8x40m {n_params / 1e6:.1f}M params fp32 on cuda "
        f"({time.perf_counter() - t0:.1f}s to draw)")
    service = InferenceService(params, args, tok, run_name="moe-8x40m-random")
    metrics_port = free_port()
    engine = service.attach_engine(EngineConfig(
        num_slots=8, max_len=1024, block_size=32, prefix_cache=True,
        prefill_chunk=256, trace=True, metrics_port=metrics_port))
    httpd = serve(service, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    prefix = ("In the port of a serving system, every request shares this "
              "system prompt: answer briefly, cite the layer you measured, "
              "and name the card and its power limit beside every number. ")
    prefix = (prefix * 3)[:300]
    bodies = [
        {"prompt": prefix + " First question: what bounds decode?",
         "max_tokens": 32},
        {"prompt": prefix + " Second question: what bounds prefill?",
         "max_tokens": 32},
        {"prompt": prefix + " First question: what bounds decode?",
         "max_tokens": 32},
        {"prompt": "Sample me something short.", "max_tokens": 32,
         "temperature": 0.8, "seed": 7},
        {"prompt": "An unrelated greedy prompt about grouped GEMMs.",
         "max_tokens": 32},
    ]
    # every request (the warm-up too) sends its own trace id
    ids = trace_ids(len(bodies) + 1)
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launches(gm, fa)  # count from here: the path's run only
        c0, d0 = engine.prefill_chunks, engine.decode_steps
        warm = post(url, {"prompt": "warm up", "max_tokens": 2},
                    headers={"X-Trace-Id": ids[-1]})
        if warm[0] != 200:
            failures.append(f"warm-up request: HTTP {warm[0]} {warm[1]}")
        t_single = time.perf_counter()
        results = [post(url, bodies[0], headers={"X-Trace-Id": ids[0]})]
        t_single = time.perf_counter() - t_single
        box = {}

        def run(i):
            box[i] = post(url, bodies[i], headers={"X-Trace-Id": ids[i]})

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(1, len(bodies))]
        t_conc = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        t_conc = time.perf_counter() - t_conc
        results += [box.get(i, (0, {"error": "no response"}))
                    for i in range(1, len(bodies))]
        all_launches = read_launches(gm, fa)
        launches = all_launches["gmm"]
        variants = read_variants(gm)["gmm"]
        chunks = engine.prefill_chunks - c0
        steps = engine.decode_steps - d0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        failures += served_telemetry(url, metrics_port, ids)
        metrics = engine.metrics()
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()

    for i, (code, out) in enumerate(results):
        if code != 200:
            failures.append(f"request {i}: HTTP {code} {out}")
            continue
        n = out["tokens"]
        if not (n == 32 or (n < 32 and out["finish_reason"] == "stop")) \
                or len(out["token_ids"]) != n \
                or not all(0 <= t < args.vocab_size for t in out["token_ids"]):
            failures.append(f"request {i}: bad token count/ids {out}")
        log(f"request {i}: HTTP {code} tokens={n} finish={out['finish_reason']}"
            f" ttft_ms={out.get('ttft_ms')} prefix_cached="
            f"{out['prefix_cached_tokens']} text={out['text'][:40]!r}")
    if failures:
        return failures, {}, None
    r1, r2, r3 = results[0][1], results[1][1], results[2][1]
    if r3["token_ids"] != r1["token_ids"]:
        failures.append("the same greedy prompt gave different tokens")
    if r2["prefix_cached_tokens"] <= 0 or r3["prefix_cached_tokens"] <= 0:
        failures.append("prefix cache did not hit on the shared 300-byte prefix")
    per = 3 * args.num_layers
    if chunks <= 0 or steps <= 0 or launches != per * (chunks + steps):
        failures.append(f"gmm launches {launches} != {per} x ({chunks} prefill "
                        f"chunks + {steps} decode steps)")
    log(f"path: gmm launches={launches} = {per} x ({chunks} prefill chunks + "
        f"{steps} decode steps); by variant {variants}")
    # fp32: every prefill chunk (256 tokens, block_t 32) on "f32", every
    # decode step (8 slots, block_t 8) on "f32_decode"
    want_variants = {**dict.fromkeys(gm.GMM_VARIANTS, 0), "f32": per * chunks,
                     "f32_decode": per * steps}
    if variants != want_variants:
        failures.append(f"gmm launches by variant {variants} != {want_variants}")
    if any(all_launches[n] for n in FLASH_KERNELS):
        failures.append(f"serving launched flash kernels: {all_launches}")

    # The first greedy token's logprob from the server vs the plain path on
    # the CPU with the same weights. fp32 on both; 12 layers of different
    # summation orders and atomic scatter-adds: |d logprob| <= 1e-3.
    prompt_ids = [tok.bos_id] + tok.tokenize(bodies[0]["prompt"])
    # init_params draws on the CPU, so the same seed gives the same weights.
    params_cpu = llama.init_params(args, torch.Generator().manual_seed(SEED),
                                   device="cpu")
    ref = cpu_first_logits(torch, args, params_cpu, prompt_ids)
    ref_lp = torch.log_softmax(ref, dim=-1)
    first = r1["token_ids"][0] if r1["token_ids"] else None
    if first is not None:
        d_lp = abs(ref_lp[first].item() - r1["logprobs"][0])
        gap = (ref.max() - ref[first]).item()
        log(f"path: first token {first} cpu_argmax={int(ref.argmax())} "
            f"|d logprob|={d_lp:.3g} cpu top-logit gap={gap:.3g}")
        if d_lp > 1e-3 or gap > 1e-3:
            failures.append(f"first-token logits disagree with the CPU plain "
                            f"path (|d logprob| {d_lp}, gap {gap})")
    dec_s = r1.get("decode_ms", 0.0) / 1e3
    conc_tokens = sum(out["tokens"] for _, out in results[1:])
    perf = {
        "ttft_ms_single": r1.get("ttft_ms"),
        "decode_tok_s_single": (r1["tokens"] - 1) / dec_s if dec_s else None,
        "request_s_single": t_single,
        "tok_s_concurrent_4": conc_tokens / t_conc,
        "peak_mem_gb": peak_gb,
        "prefill_chunks": chunks, "decode_steps": steps,
        "gmm_launches": launches, "gmm_launches_by_variant": variants,
        "prefix_cache_hit_rate": metrics.get("prefix_cache_hit_rate"),
        "trace": True,
    }
    for k, v in perf.items():
        log(f"path: {k}={v} [{card}]")
    # what the generate phase holds the locked path to: the weights, the
    # batch engine's greedy tokens and the CPU plain path's first logprobs
    served = {"params": params, "params_cpu": params_cpu, "args": args, "tok": tok,
              "ref_lp": ref_lp,
              "greedy": [(bodies[i]["prompt"], results[i][1]["token_ids"])
                         for i in (0, 1, 4)]}
    return failures, perf, served


def served_telemetry(url: str, metrics_port: int, ids) -> list:
    """The serving phase's telemetry gates: ``GET /trace`` holds one
    ``request`` span per request, carrying the trace id it was sent with;
    ``GET /metrics`` and the Prometheus exposition count every request in
    ``serve_ttft_ms``."""
    failures = []
    _, body = get_url(url + "/trace")
    spans = [e for e in json.loads(body)["traceEvents"] if e.get("name") == "request"]
    got = sorted(e["args"].get("trace_id") for e in spans)
    log(f"serve telemetry: /trace holds {len(spans)} request spans over "
        f"{len(json.loads(body)['traceEvents'])} events")
    if got != sorted(ids):
        failures.append(f"serve: /trace request spans carry {got}, not the ids sent {ids}")
    m, text = {}, ""
    for _ in range(60):  # the engine mirrors its TTFT histogram every second
        _, body = get_url(url + "/metrics")
        m = json.loads(body)
        if m.get("ttft_ms_count") == len(ids):
            break
        time.sleep(0.1)
    _, raw = get_url(f"http://127.0.0.1:{metrics_port}/metrics")
    text = raw.decode()
    count_line = f"serve_ttft_ms_count {len(ids)}"
    log(f"serve telemetry: /metrics ttft_ms_count={m.get('ttft_ms_count')} "
        f"ttft_ms_sum={m.get('ttft_ms_sum')} ttft_ms_p50={m.get('ttft_ms_p50')}; "
        f"Prometheus has '{count_line}': {count_line in text.splitlines()}")
    if m.get("ttft_ms_count") != len(ids) or not m.get("ttft_ms_sum"):
        failures.append(f"serve: /metrics ttft_ms_count {m.get('ttft_ms_count')} != "
                        f"{len(ids)} requests served")
    if count_line not in text.splitlines():
        failures.append(f"serve: the Prometheus exposition lacks '{count_line}'")
    return failures


# -- phase 4b: the locked generation path ------------------------------------------
def topk_sizes(torch, rng, tokens: int, experts: int, k: int, block_t: int):
    """Group sizes of ``tokens`` routed to ``k`` distinct experts each (as
    top-k routes), rounded up to block_t, and the dispatcher's buffer rows."""
    from mlx_cuda_distributed_pretraining_tpu_torch.ops.grouped_matmul import round_up

    ids = torch.cat([torch.randperm(experts, generator=rng)[:k] for _ in range(tokens)])
    counts = torch.bincount(ids, minlength=experts)
    sizes = (counts + block_t - 1) // block_t * block_t
    rows = round_up(tokens * k + experts * (block_t - 1), block_t)
    return sizes.to(torch.int32), rows


def generate_kernel_cases(torch, gm, kernel_check):
    """gmm at the locked generation path's shapes on moe-8x40m, each with
    its planted fault: one decode token (2 routed rows, 6 of 8 experts
    empty, a 64-row buffer) at gate/up and down, four beams (8 rows), both
    "f32_decode" at block_t 8; a 512-token padded prefill (1024 rows in a
    1536-row buffer, block_t 64) on "f32"."""
    rng = torch.Generator().manual_seed(SEED + 13)
    E, D, I = 8, 512, 1536
    one, one_rows = topk_sizes(torch, rng, 1, E, 2, 8)
    beams, beam_rows = topk_sizes(torch, rng, 4, E, 2, 8)
    pre, pre_rows = topk_sizes(torch, rng, 512, E, 2, 64)
    return [
        kernel_case(torch, gm, kernel_check, "generate_decode_gate_up", "float32",
                    one_rows, D, I, one, 8, fault=True),
        kernel_case(torch, gm, kernel_check, "generate_decode_down", "float32",
                    one_rows, I, D, one, 8, fault=True),
        kernel_case(torch, gm, kernel_check, "beam_decode_gate_up", "float32",
                    beam_rows, D, I, beams, 8, fault=True),
        kernel_case(torch, gm, kernel_check, "generate_prefill_gate_up", "float32",
                    pre_rows, D, I, pre, 64, fault=True),
    ]


def timed_generation(torch, gen):
    """Run a ``generate_step`` iterator to its end: ``(tokens, logprobs,
    ttft_s, decode tok/s)``, the decode rate over the tokens after the
    first, each read on the host as it is yielded."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, lps, t_first = [], [], None
    for tok, lp in gen:
        if t_first is None:
            t_first = time.perf_counter()
        toks.append(tok)
        lps.append(lp)
    t_end = time.perf_counter()
    rate = (len(toks) - 1) / (t_end - t_first) if len(toks) > 1 else None
    return toks, lps, t_first - t0, rate


def generate_phase(torch, gm, fa, card, served, cases):
    """moe-8x40m at full width (the serving phase's seeded fp32 weights) on
    the locked path, batch 1: greedy ``generate_step`` on the serving
    phase's greedy prompts must give the batch engine's tokens, and its
    first logprob the CPU plain path's within 1e-3; the int8 cache at most
    one diverging token, at the tail; speculative greedy the plain greedy
    tokens; beam search (4 beams) a best score equal to its full-forward
    logprobs within 1e-3; the HTTP server (locked, and the batch engine's
    fallback) answers top_p, min_p, repetition_penalty, SSE and
    /v1/completions with 200. Every gmm launch of the phase must be
    "f32_decode" or "f32"; no flash and no tgmm launch. Each of ``cases``
    (``generate_kernel_cases``) gets the launches counted at its shape
    (variant, T, K, N, block_t) in the steps that run it, and must have
    some."""
    from mlx_cuda_distributed_pretraining_tpu_torch.infer import generate as gen
    from mlx_cuda_distributed_pretraining_tpu_torch.infer.server import (
        InferenceService,
        request_stream,
        serve,
    )
    from mlx_cuda_distributed_pretraining_tpu_torch.models import llama
    from mlx_cuda_distributed_pretraining_tpu_torch.serve import EngineConfig

    if served is None:
        return ["generate: the serving phase failed before its weights were served"], {}
    failures = []
    params, args, tok = served["params"], served["args"], served["tok"]
    t_phase = time.perf_counter()
    reset_launches(gm, fa)  # count from here: the generate phase only
    by_step, shapes_by_step = {}, {}

    def counted(name, fn):
        before = dict(gm.gmm.launches_by_variant)
        before_shape = dict(gm.gmm.launches_by_shape)
        out = fn()
        torch.cuda.synchronize()
        by_step[name] = launched_since(before, gm.gmm.launches_by_variant)
        shapes_by_step[name] = {k: n - before_shape.get(k, 0)
                                for k, n in gm.gmm.launches_by_shape.items()
                                if n != before_shape.get(k, 0)}
        return out

    ids = [[tok.bos_id] + tok.tokenize(p) for p, _ in served["greedy"]]
    eos = tok.eos_id

    def greedy(prompt_ids, n=32, kv_quant=False):
        toks, lps, ttft, rate = timed_generation(
            torch, gen.generate_step(params, args, prompt_ids, max_tokens=n,
                                     kv_quant=kv_quant))
        if eos in toks:  # the engine never appends a stop token
            cut = toks.index(eos)
            toks, lps = toks[:cut], lps[:cut]
        return toks, lps, ttft, rate

    # greedy against the batch engine's tokens
    locked = counted("greedy", lambda: [greedy(p) for p in ids])
    for i, ((prompt, want), (toks, lps, _, _)) in enumerate(zip(served["greedy"], locked)):
        log(f"generate: greedy prompt {i}: {len(toks)} tokens, equal to the batch "
            f"engine's: {toks == want}")
        if toks != want:
            failures.append(f"generate: locked greedy tokens differ from the batch "
                            f"engine's on prompt {i}: {toks} vs {want}")
    first = locked[0][0][0] if locked[0][0] else None
    if first is not None:
        d_lp = abs(served["ref_lp"][first].item() - locked[0][1][0])
        log(f"generate: first token {first} |d logprob| vs the CPU plain path {d_lp:.3g}")
        if d_lp > 1e-3:
            failures.append(f"generate: first logprob disagrees with the CPU plain "
                            f"path by {d_lp}")

    # batch-1 speed, warm (the first greedy run above paid any first-use cost)
    fp32 = counted("timed_fp32", lambda: greedy(ids[0], n=64))
    int8 = counted("timed_int8", lambda: greedy(ids[0], n=64, kv_quant=True))
    # The int8 cache: over JAX's horizon (tests/test_generate.py, 8 tokens)
    # at most one diverging token, the last. Past it a greedy path may flip
    # wherever the fp32 cache's top-2 logit gap is within the int8 cache's
    # logit error (the JAX package's locked path flips where the port's does
    # on these weights, cut in depth: scripts/int8_cache_witness.py). With
    # the fp32 tokens fed to both caches: the card's int8
    # logits must be the port's plain int8 logits on the CPU within 1e-3
    # of the largest (the same quantization; fp32 noise can move a value
    # by one int8 step), and the first divergence must sit where the gap
    # is within twice the int8 cache's error against the fp32 cache there.
    first_div = next((i for i, (a, b) in enumerate(zip(fp32[0], int8[0])) if a != b),
                     None if len(int8[0]) == len(fp32[0])
                     else min(len(int8[0]), len(fp32[0])))
    if first_div is not None and first_div < 7:
        failures.append(f"generate: the int8 cache diverged at token {first_div}, inside "
                        f"the first 8: {int8[0][:8]} vs {fp32[0][:8]}")
    seq = ids[0] + fp32[0]
    chose = slice(len(ids[0]) - 1, len(seq) - 1)  # the logits behind each token

    def fed_logits(p, quantize):
        dev = p["norm"]["weight"].device
        with torch.no_grad():
            cache = llama.init_cache(args, 1, max_len=len(seq), quantize=quantize, device=dev)
            return llama.forward(p, torch.tensor([seq], device=dev), args,
                                 cache=cache)[0][0, chose]

    lf, lq = fed_logits(params, False), fed_logits(params, True)
    lq_cpu = fed_logits(served["params_cpu"], True)
    cpu_rel = ((lq.cpu() - lq_cpu).abs().max() / lq_cpu.abs().max()).item()
    err = (lq - lf).abs().amax(dim=-1)
    top2 = lf.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    rel_err = err.max().item() / lf.abs().max().item()
    at_div = first_div is not None and first_div < len(gap)
    explained = not at_div or gap[first_div].item() <= 2 * err[first_div].item()
    log(f"generate: int8 cache vs fp32 over {len(fp32[0])} tokens: first divergence at "
        f"{first_div}; fp32-fed logits: card int8 vs CPU plain int8 {cpu_rel:.3g} of the "
        f"largest; int8 vs fp32 error max {err.max().item():.3g} ({rel_err:.3g} of the "
        f"largest logit); top-2 gap at the divergence "
        + (f"{gap[first_div].item():.3g} vs error {err[first_div].item():.3g}"
           if at_div else "n/a"))
    if cpu_rel > 1e-3 or not explained:
        failures.append(f"generate: int8 logits {cpu_rel:.3g} off the CPU plain path's, or "
                        f"a divergence at {first_div} beyond the int8 error")

    # prompt-lookup speculation, greedy: the plain greedy tokens
    def speculate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gen.generate_speculative(params, args, ids[0], max_tokens=64, draft_len=8,
                                       stop_tokens=[eos])
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (spec, spec_stats), spec_s = counted("speculative", speculate)
    log(f"generate: speculative greedy, {len(spec)} tokens in {spec_stats['verify_calls']:.0f}"
        f" verify calls, tokens_per_call={spec_stats['tokens_per_call']}; equal to plain "
        f"greedy: {spec == fp32[0]}")
    if spec != fp32[0]:
        failures.append(f"generate: speculative greedy differs from plain greedy: "
                        f"{spec} vs {fp32[0]}")

    # beam search: the best beam's score against a full forward's logprobs
    def beams():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gen.beam_search(params, args, ids[1], num_beams=4, max_tokens=16)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (beam_seq, beam_score), beam_s = counted("beam_search", beams)
    with torch.no_grad():
        logits, _ = llama.forward(
            params, torch.tensor([ids[1] + beam_seq], device=params["norm"]["weight"].device),
            args)
        lsm = torch.log_softmax(logits[0], dim=-1)
    P = len(ids[1])
    total = sum(lsm[P - 1 + i, t].item() for i, t in enumerate(beam_seq))
    d_beam = abs(beam_score * len(beam_seq) - total)
    log(f"generate: beam search (4 beams) {len(beam_seq)} tokens, score {beam_score:.6f}, "
        f"|score x len - full-forward sum of logprobs| {d_beam:.3g}")
    if len(beam_seq) != 16 or d_beam > 1e-3:
        failures.append(f"generate: beam score {beam_score} x {len(beam_seq)} vs the full "
                        f"forward's {total}")

    # HTTP: the locked server, then the batch engine's fallback, SSE and
    # /v1/completions
    knobs = [{"top_p": 0.9, "temperature": 0.8}, {"min_p": 0.1, "temperature": 0.8},
             {"repetition_penalty": 1.3}]
    http = {}

    def serve_requests(service, tag):
        httpd = serve(service, port=0)
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            for k in knobs:
                code, out = post(url, {"prompt": served["greedy"][0][0], "max_tokens": 16,
                                       **k})
                http[f"{tag} {sorted(k)}"] = code
                if code == 200 and "engine" in out:
                    failures.append(f"generate: {tag} {k} was not served by the locked path")
            code, out = post(url, {"prompt": served["greedy"][2][0], "max_tokens": 16},
                             path="/v1/completions")
            http[f"{tag} /v1/completions"] = code
            if code == 200 and out.get("object") != "text_completion":
                failures.append(f"generate: {tag} /v1/completions answered {out}")
            if tag == "batch":
                events = list(request_stream(url, served["greedy"][2][0], max_tokens=16,
                                             timeout=300))
                n_tok = sum("token" in e for e in events)
                done = events[-1] if events else {}
                http["batch SSE"] = 200 if done.get("done") and n_tok == done.get(
                    "tokens") and n_tok > 0 else 0
                log(f"generate: SSE {n_tok} token events, then done={done.get('done')}")
        finally:
            httpd.shutdown()
            httpd.server_close()
            service.close()

    counted("http_locked", lambda: serve_requests(
        InferenceService(params, args, tok, run_name="moe-8x40m-random"), "locked"))
    batch_service = InferenceService(params, args, tok, run_name="moe-8x40m-random")
    batch_service.attach_engine(EngineConfig(num_slots=8, max_len=1024, block_size=32,
                                             prefill_chunk=256))
    counted("http_batch", lambda: serve_requests(batch_service, "batch"))
    log(f"generate: HTTP {http}")
    bad = {k: v for k, v in http.items() if v != 200}
    if bad:
        failures.append(f"generate: HTTP not 200: {bad}")

    launches = read_launches(gm, fa)
    variants = read_variants(gm)["gmm"]
    log(f"generate: gmm launches by variant {variants}; by step {by_step}")
    if set(k for k, n in variants.items() if n) - {"f32_decode", "f32"} \
            or not variants.get("f32_decode") or not variants.get("f32"):
        failures.append(f"generate: gmm launches by variant {variants}")
    if launches["tgmm"] or any(launches[n] for n in FLASH_KERNELS):
        failures.append(f"generate: tgmm or flash launched: {launches}")
    # Launches at each kernel case's shape (variant, T, K, N, block_t), as
    # _gmm_forward counts them, in the steps that run that case: the
    # one-token decodes and 512-token prefills of the locked batch-1 steps
    # (speculation's prefill too; its verifies are 18 rows, another
    # shape), and the beams' decodes. A 64-row buffer holds 2 routed rows
    # in a batch-1 decode step and 8 in a beam step, so the steps tell
    # those two cases apart.
    batch1 = ("greedy", "timed_fp32", "timed_int8", "http_locked")
    steps_of = {"generate_decode_gate_up": batch1, "generate_decode_down": batch1,
                "beam_decode_gate_up": ("beam_search",),
                "generate_prefill_gate_up": batch1 + ("speculative",)}
    launches_by_case = {}
    for c in cases:
        T, K, N, _ = c["shape"]
        key = (gm.gmm_variant(torch.float32, c["block_t"], K, N), T, K, N, c["block_t"])
        launches_by_case[c["case"]] = sum(shapes_by_step[k].get(key, 0)
                                          for k in steps_of[c["case"]])
    log(f"generate: gmm launches at each kernel case's shape {launches_by_case}")
    if not all(launches_by_case.values()):
        failures.append(f"generate: a kernel case's shape never ran on the path: "
                        f"{launches_by_case}")
    shapes = {k: {"_".join(map(str, key)): n for key, n in v.items()}
              for k, v in shapes_by_step.items()}
    perf = {
        "ttft_ms_fp32": 1e3 * fp32[2], "decode_tok_s_fp32": fp32[3],
        "ttft_ms_int8": 1e3 * int8[2], "decode_tok_s_int8": int8[3],
        "int8_first_divergence": first_div, "int8_logit_rel_err": rel_err,
        "int8_vs_cpu_plain_rel": cpu_rel,
        "prompt_tokens": len(ids[0]),
        "speculative_tok_s": len(spec) / spec_s,
        "speculative_tokens_per_call": spec_stats["tokens_per_call"],
        "speculative_verify_calls": spec_stats["verify_calls"],
        "beam_tok_s": 4 * len(beam_seq) / beam_s, "beam_best_tok_s": len(beam_seq) / beam_s,
        "gmm_launches": launches["gmm"], "gmm_launches_by_variant": variants,
        "gmm_launches_by_step": by_step, "gmm_launches_by_shape_by_step": shapes,
        "gmm_launches_by_case": launches_by_case,
        "http": http,
        "phase_s": time.perf_counter() - t_phase,
    }
    for k in ("ttft_ms_fp32", "decode_tok_s_fp32", "ttft_ms_int8", "decode_tok_s_int8",
              "speculative_tok_s", "speculative_tokens_per_call", "beam_tok_s",
              "beam_best_tok_s", "phase_s"):
        log(f"generate: {k}={perf[k]} [{card}]")
    return failures, perf


# -- phase 4c: the quantized and speculative batch engine ---------------------------
def first_logits(torch, args, params, prompt_ids, device, quantize=False, taken=None,
                 C=256, bs=32):
    """The last prompt token's logits through the engine's own paged prefill
    step (chunks of ``C``, blocks of ``bs``) on ``device``; ``quantize`` runs
    it over the int8 KV quartet, ``params`` may be a quantized tree.

    Two discrete decisions sit inside a step, and a rounding difference
    can tip either: each token's top-2 experts (the seeded router is near
    uniform, so its top-2 margins are tiny) and each int8 K/V value at a
    rounding boundary. Without ``taken`` the call records both and returns
    ``(logits, taken)``; with ``taken`` (another device's record) it takes
    those decisions instead of its own and returns ``(logits, changed)``,
    the counts of the prompt's expert selections and int8 values its own
    arithmetic would have decided otherwise (the chunk's pad positions are
    left out: no prompt token attends them). Every product, sum and
    dequantization is still the caller's own."""
    from mlx_cuda_distributed_pretraining_tpu_torch.models import llama, moe
    from mlx_cuda_distributed_pretraining_tpu_torch.serve import batch_step

    grouped_ffn, quantize_kv = moe._grouped_ffn, llama._quantize_kv
    record = {"route": [], "kv": []} if taken is None else None
    it = None if taken is None else {k: iter(v) for k, v in taken.items()}
    changed = {"expert_selections": 0, "int8_values": 0}
    live = [0]  # prompt tokens in the current chunk

    def routed(experts, x_flat, gate_idx, gate_w, *a, **kw):
        if record is not None:
            record["route"].append((gate_idx.cpu(), gate_w.cpu()))
        else:
            idx, w = next(it["route"])
            mine = gate_idx.cpu()[:live[0]].sort(-1).values
            changed["expert_selections"] += int(
                (idx[:live[0]].sort(-1).values != mine).any(-1).sum())
            gate_idx, gate_w = idx.to(x_flat.device), w.to(x_flat.device, gate_w.dtype)
        return grouped_ffn(experts, x_flat, gate_idx, gate_w, *a, **kw)

    def quantized(x):
        q, sc = quantize_kv(x)
        if record is not None:
            record["kv"].append((q.cpu(), sc.cpu()))
            return q, sc
        tq, ts = next(it["kv"])
        changed["int8_values"] += int((tq[:, :live[0]] != q.cpu()[:, :live[0]]).sum())
        return tq.to(x.device), ts.to(x.device)

    moe._grouped_ffn, llama._quantize_kv = routed, quantized
    try:
        P = len(prompt_ids)
        nblk = -(-P // bs)
        cache = llama.init_paged_cache(args, nblk + 1, bs, device=device, quantize=quantize)
        table = torch.zeros(1024 // bs, dtype=torch.long, device=device)
        table[:nblk] = torch.arange(1, nblk + 1)
        logits = None
        for start in range(0, P, C):
            n = live[0] = min(C, P - start)
            toks = torch.zeros(C, dtype=torch.long)
            toks[:n] = torch.tensor(prompt_ids[start:start + n])
            attend = min(batch_step.round_up(batch_step.attend_bucket(start + C, 1024), bs),
                         1024)
            logits = batch_step.paged_prefill_step(
                params, cache, toks.to(device), table, start, n - 1, args, attend, bs,
                with_logits=start + n >= P)
    finally:
        moe._grouped_ffn, llama._quantize_kv = grouped_ffn, quantize_kv
    return logits[0].float().cpu(), (record if taken is None else changed)


QUANT_PROMPTS = [
    # repetitive prompts: prompt-lookup drafts have something to copy
    "a b c d a b c d a b c d a b c d a b c d a b c d a b c d",
    "the cat sat on the mat. the cat sat on the mat. the cat sat on the mat. the cat",
    "one two three four five one two three four five one two three four five one two",
    "Grouped GEMMs route each token to two experts; the dispatcher pads every group.",
    "def f(x):\n    return x + 1\n\ndef f(x):\n    return x + 1\n\ndef f(x):\n   ",
    "In the port of a serving system, every request shares this system prompt.",
]


def engine_run(torch, gm, engine, prompts, max_tokens=32, temperature=0.0):
    """Every prompt through a started engine at once: (token lists, results,
    wall seconds, gmm launches by variant, metrics)."""
    gm.reset_launches()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_tokens=max_tokens, temperature=temperature, seed=i)
            for i, p in enumerate(prompts)]
    ok = all(r.wait(600) for r in reqs)
    wall = time.perf_counter() - t0
    errors = [r.error for r in reqs if r.error is not None] + ([] if ok else ["timeout"])
    return {"tokens": [list(r.tokens) for r in reqs],
            "results": [dict(r.result or {}) for r in reqs], "wall_s": wall,
            "tok_s": sum(len(r.tokens) for r in reqs) / wall,
            "variants": dict(gm.gmm.launches_by_variant), "metrics": engine.metrics(),
            "errors": errors}


def pool_bytes(pool) -> int:
    return sum(t.numel() * t.element_size() for layer in pool.cache for t in layer.values())


def quant_serve_phase(torch, gm, fa, card, served):
    """moe-8x40m at full width (the serving phase's seeded fp32 weights)
    through the batch engine, fp32 serving compute: (a) fp paged, (b)
    speculation (draft 4, n-gram 3; greedy tokens (a)'s, some drafts
    accepted, a sampled run at 0.7 finishes), (c) the int8 KV pool, paged
    against slotted (equal greedy tokens; first-token logits within 1e-4 x
    max|logit| of the CPU plain path's over the int8 cache), (d) int8, int8
    with the int8 pool, and int4 weights (first-token logits within 1e-4 x
    max|logit| of the CPU plain path's on the same quantized weights;
    weight bytes, greedy agreement with (a) reported, not gated), (e)
    quantize-on-load equal to host quantization, and a hot swap of the fp
    weights into a live int8 engine (version 1, still int8, the same greedy
    tokens), (f) a GKV1 export from one engine adopted by another (the
    adopting request's greedy tokens a fresh prefill's, its prompt served
    from the cache) and a corrupt payload refused and quarantined. No
    flash or tgmm launch; gmm on "f32" / "f32_decode"."""
    import tempfile

    from mlx_cuda_distributed_pretraining_tpu_torch.checkpoint.manager import (
        CheckpointManager,
    )
    from mlx_cuda_distributed_pretraining_tpu_torch.checkpoint.safetensors_io import (
        save_safetensors,
    )
    from mlx_cuda_distributed_pretraining_tpu_torch.models import quantize as q
    from mlx_cuda_distributed_pretraining_tpu_torch.serve import BatchEngine, EngineConfig
    from mlx_cuda_distributed_pretraining_tpu_torch.serve.kv_transfer import (
        KVTransferPayload,
        _corrupt,
    )
    from mlx_cuda_distributed_pretraining_tpu_torch.utils.tree import flatten_dict, tree_map

    if served is None:
        return ["quant: the serving phase failed before its weights were served"], {}
    failures = []
    params, params_cpu, args, tok = (served["params"], served["params_cpu"],
                                     served["args"], served["tok"])
    t_phase = time.perf_counter()
    perf = {}
    fa.reset_launches()
    base_cfg = dict(num_slots=8, max_len=1024, block_size=32, prefill_chunk=256)

    def engine(**kw):
        return BatchEngine(params, args, tok, EngineConfig(**{**base_cfg, **kw})).start()

    def run(label, prompts=QUANT_PROMPTS, temperature=0.0, **kw):
        eng = engine(**kw)
        try:
            out = engine_run(torch, gm, eng, prompts, temperature=temperature)
        finally:
            eng.stop()
        if out["errors"]:
            failures.append(f"quant {label}: {out['errors']}")
        m = out["metrics"]
        log(f"quant {label}: {out['tok_s']:.1f} tok/s ({len(prompts)} requests, "
            f"{out['wall_s']:.2f}s) gmm by variant {out['variants']} weight_bytes="
            f"{m['weight_bytes']} spec={m.get('spec_accepted')}/{m.get('spec_proposed')} "
            f"[{card}]")
        return out

    def agreement(a, b):
        pairs = [(x, y) for ta, tb in zip(a, b) for x, y in zip(ta, tb)]
        return sum(x == y for x, y in pairs) / max(len(pairs), 1)

    # (a) fp, paged, no speculation
    base = run("a fp paged")
    perf["a_fp_tok_s"] = base["tok_s"]
    fp_bytes = base["metrics"]["weight_bytes"]
    # (b) speculation: greedy tokens equal (a)'s, drafts accepted
    spec = run("b spec draft 4", spec_draft_len=4, spec_max_ngram=3)
    m = spec["metrics"]
    perf.update(b_spec_tok_s=spec["tok_s"], b_spec_acceptance_rate=m["spec_acceptance_rate"],
                b_spec_accepted=m["spec_accepted"], b_spec_proposed=m["spec_proposed"],
                b_decode_steps=m["decode_steps"], a_decode_steps=base["metrics"]["decode_steps"])
    if spec["tokens"] != base["tokens"]:
        failures.append("quant b: speculative greedy tokens differ from plain decode")
    if not m["spec_accepted"] > 0:
        failures.append(f"quant b: no draft accepted ({m['spec_proposed']} proposed)")
    sampled = run("b spec sampled 0.7", temperature=0.7, spec_draft_len=4, spec_max_ngram=3)
    if not all(r.get("tokens", 0) > 0 and r.get("finish_reason") in ("length", "stop")
               for r in sampled["results"]):
        failures.append("quant b: a sampled speculative request did not finish")
    perf["b_sampled_acceptance_rate"] = sampled["metrics"]["spec_acceptance_rate"]

    # (c) the int8 KV pool, paged and slotted; first-token logits vs the CPU
    paged8 = run("c kv8 paged", kv_quant=True)
    slotted8 = run("c kv8 slotted", kv_quant=True, kv_backend="slotted")
    if paged8["tokens"] != slotted8["tokens"]:
        failures.append("quant c: int8 paged and int8 slotted greedy tokens differ")
    perf["c_kv8_agreement_with_fp"] = agreement(paged8["tokens"], base["tokens"])
    eng = engine()
    fp_pool = pool_bytes(eng.pool)
    eng.stop()
    eng = engine(kv_quant=True)
    q_pool = pool_bytes(eng.pool)
    eng.stop()
    perf.update(pool_bytes_fp32=fp_pool, pool_bytes_int8=q_pool)
    log(f"quant c: pool bytes fp32 {fp_pool} int8 {q_pool} ({q_pool / fp_pool:.3f}x) [{card}]")
    prompt_ids = [tok.bos_id] + tok.tokenize(QUANT_PROMPTS[3])

    device = params["tok_embeddings"]["weight"].device

    def logits_check(label, tree_gpu, tree_cpu, quantize):
        # the CPU plain path takes the card's expert choices and int8 K/V
        # roundings (first_logits); how many it would have made otherwise
        # is printed
        got, taken = first_logits(torch, args, tree_gpu, prompt_ids, device, quantize)
        ref, changed = first_logits(torch, args, tree_cpu, prompt_ids, "cpu", quantize,
                                    taken=taken)
        err = (got - ref).abs().max().item()
        lim = 1e-4 * ref.abs().max().item()
        log(f"quant {label}: first-token logits max|d|={err:.3g} limit={lim:.3g} "
            f"argmax {int(got.argmax())}/{int(ref.argmax())}; decided otherwise on the "
            f"CPU: {changed}")
        if not err <= lim:
            failures.append(f"quant {label}: first-token logits differ from the CPU "
                            f"plain path ({err} > {lim})")
        return err

    perf["c_kv8_logits_max_err"] = logits_check("c kv8", params, params_cpu, True)

    # (d) quantized weights
    for label, wd, kvq in (("d w8", "int8", False), ("d w8 kv8", "int8", True),
                           ("d w4", "int4", False)):
        out = run(label, weight_dtype=wd, kv_quant=kvq)
        key = label.split(" ", 1)[1].replace(" ", "_")
        perf[f"{key}_tok_s"] = out["tok_s"]
        perf[f"{key}_weight_bytes"] = out["metrics"]["weight_bytes"]
        perf[f"{key}_agreement_with_fp"] = agreement(out["tokens"], base["tokens"])
        perf[f"{key}_gmm_variants"] = out["variants"]
        if out["metrics"]["weight_dtype"] != wd or not out["metrics"]["weight_bytes"] < fp_bytes:
            failures.append(f"quant {label}: weight dtype/bytes {out['metrics']}")
        if out["variants"].get("f32", 0) + out["variants"].get("f32_decode", 0) \
                != sum(out["variants"].values()) or not out["variants"].get("f32_decode"):
            failures.append(f"quant {label}: gmm launches {out['variants']}")
        # the card's quantization (the engine's) must equal the CPU's bit
        # for bit, values and scales; the logits then run on the same
        # quantized weights, quantized on the CPU and copied to the card
        qcpu = q.quantize_weights(params_cpu, wd)
        qdev = flatten_dict(q.quantize_weights(params, wd))
        differ = sum(int((t.cpu() != qdev[k].cpu()).sum())
                     for k, t in flatten_dict(qcpu).items())
        perf[f"{key}_card_vs_cpu_quantized_leaves_differ"] = differ
        if differ:
            failures.append(f"quant {label}: the card's quantization differs from the "
                            f"CPU's in {differ} values")
        del qdev
        perf[f"{key}_logits_max_err"] = logits_check(
            label, tree_map(lambda t: t.to(device), qcpu), qcpu, kvq)
    perf["fp_weight_bytes"] = fp_bytes

    # (e) quantize-on-load and the hot swap
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        path = os.path.join(tmp, "model.safetensors")
        save_safetensors(path, flatten_dict(params_cpu))
        loaded = flatten_dict(CheckpointManager.load_params(path, like=params_cpu,
                                                            weight_dtype="int8"))
        want = flatten_dict(q.quantize_weights(params_cpu, "int8"))
        same = set(loaded) == set(want) and all(torch.equal(loaded[k], want[k]) for k in want)
        log(f"quant e: load_params(weight_dtype=int8) == quantize_weights: {same}")
        if not same:
            failures.append("quant e: quantize-on-load differs from host quantization")
    eng = engine(weight_dtype="int8")
    try:
        before = engine_run(torch, gm, eng, QUANT_PROMPTS[:3])
        version = eng.swap_params(params)
        after = engine_run(torch, gm, eng, QUANT_PROMPTS[:3])
        m = eng.metrics()
    finally:
        eng.stop()
    log(f"quant e: hot swap -> version {version}, weight_dtype {m['weight_dtype']}, "
        f"tokens equal {after['tokens'] == before['tokens']}")
    if version != 1 or m["params_version"] != 1 or m["weight_dtype"] != "int8" \
            or q.weight_dtype_of(eng.params) != "int8" or after["tokens"] != before["tokens"]:
        failures.append(f"quant e: hot swap into the int8 engine: version {version}, {m}")

    # (f) KV export -> GKV1 bytes -> adopt in another engine
    prompt = QUANT_PROMPTS[5] * 4
    ids = [tok.bos_id] + tok.tokenize(prompt)
    src, dst = engine(), engine()
    try:
        fresh = engine_run(torch, gm, src, [prompt])
        t0 = time.perf_counter()
        data = src.export_kv(ids).to_bytes()
        t_export = time.perf_counter() - t0
        payload = KVTransferPayload.from_bytes(data)
        t0 = time.perf_counter()
        stats = dst.adopt_kv(payload)
        t_adopt = time.perf_counter() - t0
        adopted = engine_run(torch, gm, dst, [prompt])
        cached = adopted["results"][0].get("prefix_cached_tokens", 0)
        try:
            KVTransferPayload.from_bytes(_corrupt(data))
            refused = False
        except ValueError:
            refused = True
        dropped = dst.quarantine_kv(payload.keys)
        left = [dst.pool.prefix.lookup(k) for k in payload.keys]
    finally:
        src.stop()
        dst.stop()
    perf.update(f_payload_bytes=len(data), f_blocks=payload.num_blocks,
                f_export_s=t_export, f_adopt_s=t_adopt, f_cached_tokens=cached)
    log(f"quant f: GKV1 {len(data)} bytes, {payload.num_blocks} blocks, export "
        f"{t_export:.3f}s adopt {t_adopt:.3f}s {stats}; adopting request cached "
        f"{cached} tokens, tokens equal {adopted['tokens'] == fresh['tokens']}; corrupt "
        f"refused {refused}, quarantined {dropped}")
    if adopted["tokens"] != fresh["tokens"] or not cached > 0:
        failures.append(f"quant f: adopted KV gave {adopted['tokens']} (cached {cached}) "
                        f"against a fresh prefill's {fresh['tokens']}")
    if not refused or dropped != payload.num_blocks or any(b is not None for b in left):
        failures.append(f"quant f: corrupt payload refused={refused}, quarantined {dropped}")
    flash = {n: getattr(fa, n).launches for n in FLASH_KERNELS}
    if any(flash.values()) or gm.tgmm.launches:
        failures.append(f"quant: serving launched flash or tgmm kernels: {flash}")
    perf["seconds"] = time.perf_counter() - t_phase
    for k, v in perf.items():
        log(f"quant: {k}={v} [{card}]")
    return failures, perf


# -- phase 4d: the fleet (1 prefill + 2 decode replicas) ------------------------------
FLEET_TOKENS = 32
FLEET_AFFINITY_BLOCK = 32  # the router's affinity block (bytes)


def fleet_prompts(router):
    """Two 512-byte prefixes, each routed by the router's ring to its own
    decode replica (r1, r2); three 600-900-byte prompts on each, four short
    ones under the 64-byte handoff floor, and four short ones routed to r2
    (the replica the phase stops)."""
    base = ("A fleet request with a long shared system prompt: the prefill "
            "replica writes its KV, pushes the blocks to a decode replica, and "
            "the decode replica recomputes the last prompt token. ")
    want = {"r1": None, "r2": None}
    salt = 0
    while None in want.values():
        head = f"[{salt:04d}] "
        owner = router._ring.lookup(router.routing_key({"prompt": head + base}))
        if owner in want and want[owner] is None:
            want[owner] = ((head + base) * 8)[:512]
        salt += 1
    long_ = {}
    for rid, prefix in want.items():
        long_[rid] = [prefix + f" Question {i} for {rid}: " + ("why does the cache "
                      "hit? " * (6 + 4 * i))[:150 + 90 * i] for i in range(3)]
    short = [f"short {i}: grouped GEMMs?" for i in range(4)]
    death, salt = [], 0
    while len(death) < 4:
        p = f"to r2 {salt}: a short one"
        if router._ring.lookup(router.routing_key({"prompt": p})) == "r2":
            death.append(p)
        salt += 1
    return long_, short, death


def swap_prompts(router):
    """For each decode replica, a 512-byte prefix the ring routes to it, one
    prompt on it to send while a rolling swap has the decode pool on the
    new weights and the prefill replica still on the old, and one to send
    after the rollout."""
    base = ("A prompt sent in the middle of a rolling weight swap, whose blocks "
            "must not outlive it in a decode replica's prefix cache. ")
    out, salt = {}, 0
    while len(out) < 2:
        head = f"<{salt:04d}> "
        owner = router._ring.lookup(router.routing_key({"prompt": head + base}))
        if owner in ("r1", "r2") and owner not in out:
            prefix = ((head + base) * 8)[:512]
            out[owner] = (prefix + " Sent while the swap is half done: which weights?",
                          prefix + " Sent after the rollout: the new weights, all of them.")
        salt += 1
    return [out["r1"][0], out["r2"][0]], [out["r1"][1], out["r2"][1]]


class _LaunchWindows:
    """gmm launches by variant around each replica's part of a request,
    recorded while the phase sends one request at a time."""

    def __init__(self, gm):
        self.gm = gm
        self.on = False
        self.rows = []  # (replica id, role, what, {variant: launches}, extra)

    def span(self, rid, role, what, fn):
        before = dict(self.gm.gmm.launches_by_variant)
        t0 = time.perf_counter()
        out = fn()
        if self.on:
            extra = dict(out or {}, wall_ms=1e3 * (time.perf_counter() - t0))
            self.rows.append((rid, role, what,
                              launched_since(before, self.gm.gmm.launches_by_variant), extra))
        return out

    def by_replica(self):
        out = {}
        for rid, _, _, launched, _ in self.rows:
            d = out.setdefault(rid, {})
            for k, n in launched.items():
                d[k] = d.get(k, 0) + n
        return out


def fleet_phase(torch, gm, fa, card, served, path_perf):
    """moe-8x40m at full width (the serving phase's seeded fp32 weights) in
    a disaggregated fleet on the card: one prefill and two decode replicas,
    each a batch engine behind the port's server on a thread of this
    process, registered in a fleet directory, behind a ``FleetRouter`` with
    a ``FleetController`` and a scope ``Collector`` (``configs/serve-sample
    .yaml``'s ``fleet:`` and ``scope:`` blocks). Gates: the greedy tokens of
    six handoff requests (600-900 bytes; three and three share a 512-byte
    prefix) and four short ones equal a directly served engine's; six
    handoffs adopted with the GKV1 bytes of their full blocks; shared
    prefixes on one decode replica, the later ones reusing its cache; "f32"
    gmm launches on the prefill replica, "f32_decode" on both decode
    replicas, no plain gmm call; a rolling swap to a second seeded
    checkpoint, the tokens after it a direct engine's on the new weights,
    also for prompts sent while the decode pool had swapped and the
    prefill replica not (no handoff across the two versions) and for
    prompts sharing their prefixes after the rollout; drain 503 and the
    router around it; ``X-Deadline-Ms: 1`` 504 with no engine step; a
    decode replica's server stopped mid-traffic, its requests replayed on
    the other with the same tokens, its breaker opened by the router's own
    poller, the poller reviving it; the collector's TSDB holding every member's
    series and an alert firing with its bundle; ``python -m ...serve.fleet``
    routing a request, answering ``/metrics`` and exiting on SIGINT."""
    import signal
    import tempfile

    from mlx_cuda_distributed_pretraining_tpu_torch.checkpoint.manager import (
        CheckpointManager,
    )
    from mlx_cuda_distributed_pretraining_tpu_torch.infer.server import (
        InferenceService,
        serve,
    )
    from mlx_cuda_distributed_pretraining_tpu_torch.models import llama
    from mlx_cuda_distributed_pretraining_tpu_torch.obs.alerts import load_rules
    from mlx_cuda_distributed_pretraining_tpu_torch.obs.scope import (
        Collector,
        ScopeConfig,
    )
    from mlx_cuda_distributed_pretraining_tpu_torch.obs.tsdb import parse_series_key
    from mlx_cuda_distributed_pretraining_tpu_torch.serve import (
        BatchEngine,
        EngineConfig,
        FleetConfig,
        FleetController,
        FleetRouter,
        serve_router,
    )
    from mlx_cuda_distributed_pretraining_tpu_torch.serve.fleet import start_heartbeat

    if served is None:
        return ["fleet: the serving phase failed before its weights were served"], {}
    failures = []
    t_phase = time.perf_counter()
    params, args, tok = served["params"], served["args"], served["tok"]
    engine_kw = dict(num_slots=8, max_len=1024, block_size=32, prefill_chunk=256,
                     prefix_cache=True)
    # a token's KV in the fp32 pool: K and V of every layer's kv heads
    kv_token_bytes = 2 * args.num_layers * args.num_kv_heads * args.head_dim * 4
    tmp_obj = tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build"))
    tmp = tmp_obj.name
    fleet_dir = os.path.join(tmp, "fleet")
    sample = os.path.join(REPO, "configs", "serve-sample.yaml")
    fcfg = FleetConfig.from_yaml(sample)
    # the phase keeps both decode replicas: no idle scale-down below two
    fcfg.min_replicas_per_pool = 2
    plain_calls = {"gmm": 0}
    real_plain = gm.gmm_plain

    def counted_plain(*a, **k):
        plain_calls["gmm"] += 1
        return real_plain(*a, **k)

    gm.gmm_plain = counted_plain
    windows = _LaunchWindows(gm)

    class Router(FleetRouter):
        """The fleet's router, recording each replica's gmm launches."""

        def _handoff(self, pre, dec, body, trace_id, deadline=None):
            return windows.span(pre.id, pre.role, "prefill",
                                lambda: super(Router, self)._handoff(
                                    pre, dec, body, trace_id, deadline=deadline))

        def _dispatch_to(self, cands, path, body, trace_id=None, deadline=None):
            # the replica answers a JSON request once it has generated every
            # token, so its launches are in before the response opens
            before = dict(gm.gmm.launches_by_variant)
            resp, r = super()._dispatch_to(cands, path, body, trace_id, deadline=deadline)
            if windows.on:
                windows.rows.append((r.id, r.role, "dispatch",
                                     launched_since(before, gm.gmm.launches_by_variant),
                                     None))
            return resp, r

    replicas, router, rhttpd, ctl, scope, direct = [], None, None, None, None, None
    perf = {}
    try:
        # the direct engine: the reference tokens, served alone as in phase 4
        direct = BatchEngine(params, args, tok, EngineConfig(**engine_kw)).start()
        probe = Router(["http://127.0.0.1:1"], ["http://127.0.0.1:2", "http://127.0.0.1:3"])
        long_, short, death = fleet_prompts(probe)
        in_window, after_window = swap_prompts(probe)
        handoff = [long_["r1"][0], long_["r2"][0], long_["r1"][1], long_["r2"][1],
                   long_["r1"][2], long_["r2"][2]]
        refs, direct_perf = {}, {"ttft_ms": [], "decode_tok_s": []}
        for p in handoff + short + death:
            out = direct.generate(p, max_tokens=FLEET_TOKENS)
            refs[p] = out["token_ids"]
            if p in handoff:
                direct_perf["ttft_ms"].append(out.get("ttft_ms"))
                if out.get("decode_ms"):
                    direct_perf["decode_tok_s"].append(
                        (out["tokens"] - 1) / (out["decode_ms"] / 1e3))
        direct.stop()
        direct = None
        log(f"fleet: {len(refs)} reference generations on a direct engine; handoff "
            f"prompts {[len(p) for p in handoff]} bytes")

        # the fleet: three replicas on this process's threads
        for i, role in enumerate(("prefill", "decode", "decode")):
            svc = InferenceService(params, args, tok, run_name="moe-8x40m-random")
            svc.attach_engine(EngineConfig(role=role, trace=True,
                                           worker_id=f"{role}{i}", **engine_kw))
            httpd = serve(svc, port=0)
            port = httpd.server_address[1]
            url = f"http://127.0.0.1:{port}"
            beat = start_heartbeat(fleet_dir, url, role=role, index=i, interval_s=0.5)
            replicas.append({"role": role, "svc": svc, "httpd": httpd, "url": url,
                             "port": port, "beat": beat})
        router = Router([replicas[0]["url"]], [r["url"] for r in replicas[1:]],
                        canary_fraction=fcfg.canary_fraction,
                        handoff_min_prompt_bytes=fcfg.handoff_min_prompt_bytes,
                        block_size=FLEET_AFFINITY_BLOCK, poll_interval_s=0.5)
        rhttpd = serve_router(router, port=0)
        rurl = f"http://127.0.0.1:{rhttpd.server_address[1]}"
        # the scope: serve-sample.yaml's scope: block over the fleet dir and
        # the router; configs/alerts.yaml's rules plus one the traffic crosses
        scfg = ScopeConfig.from_yaml(sample)
        rules = load_rules(os.path.join(REPO, scfg.alerts_path))
        rules.append({"name": "fleet-served", "kind": "threshold",
                      "metric": "completed", "op": "gt", "value": 0, "agg": "max",
                      "for_s": 0, "actions": ["bundle"]})
        rules_path = os.path.join(tmp, "fleet_alerts.json")
        with open(rules_path, "w") as f:
            json.dump({"alerts": {"rules": rules}}, f)
        scfg.alerts_path, scfg.fleet_dir = rules_path, fleet_dir
        scfg.run_dir = os.path.join(tmp, "scope")
        scfg.tsdb_dir = os.path.join(scfg.run_dir, "scope_tsdb")
        scfg.targets = [{"name": "router", "role": "router", "url": rurl}]
        # built as ``serve.fleet --scope`` builds it: with its own call
        # policy, so the breaker gate below is the router's alone
        scope = Collector(scfg)
        swap_window = {"armed": False, "out": {}, "skew": None}

        def on_log(msg):
            # rolling_swap logs each promotion: after the last decode
            # replica's the prefill replica still serves the old weights
            if swap_window["armed"] and msg.startswith("[fleet] r2 promoted"):
                swap_window["armed"] = False
                skew0 = router._mc_handoffs.value(outcome="version_skew")
                for p in in_window:
                    swap_window["out"][p] = post(rurl, {"prompt": p,
                                                        "max_tokens": FLEET_TOKENS})
                swap_window["skew"] = router._mc_handoffs.value(
                    outcome="version_skew") - skew0

        ctl = FleetController(router, fcfg, fleet_dir=fleet_dir, scope=scope, log=on_log)
        ctl.start(interval_s=1.0)
        engines = [r["svc"].engine for r in replicas]

        def steps():
            return sum(e.prefill_chunks + e.decode_steps for e in engines)

        # -- traffic: one request at a time, each replica's launches recorded
        gm.reset_launches()
        steps0 = [(e.prefill_chunks, e.decode_steps) for e in engines]
        windows.on = True
        order = [handoff[0], handoff[1], short[0], handoff[2], handoff[3], short[1],
                 handoff[4], handoff[5], short[2], short[3]]
        results = {}
        for p in order:
            code, out = post(rurl, {"prompt": p, "max_tokens": FLEET_TOKENS})
            results[p] = (code, out)
        windows.on = False
        scope.collect_once()  # every member up: the traffic fires the extra rule
        fleet_variants = dict(gm.gmm.launches_by_variant)
        fleet_launches = gm.gmm.launches
        per = 3 * args.num_layers
        work = sum((e.prefill_chunks - c) + (e.decode_steps - d)
                   for e, (c, d) in zip(engines, steps0))
        for p in order:
            code, out = results[p]
            if code != 200:
                failures.append(f"fleet: HTTP {code} for a {len(p)}-byte prompt: {out}")
            elif out["token_ids"] != refs[p]:
                failures.append(f"fleet: a {len(p)}-byte prompt's greedy tokens differ "
                                f"from the direct engine's")
        handoffs = [row for row in windows.rows if row[2] == "prefill"]
        dispatches = [row for row in windows.rows if row[2] == "dispatch"]
        n_ok = router._mc_handoffs.value(outcome="ok")
        pre_done = engines[0].metrics()["completed"]
        adopted = sum(e.metrics()["kv_transfer_blocks"]["adopted"] for e in engines[1:])
        log(f"fleet: {int(n_ok)} handoffs ok, the prefill replica completed {pre_done} "
            f"prefill-only requests, the decode replicas adopted {adopted} blocks")
        if n_ok != 6 or pre_done != 6 or len(handoffs) != 6 or adopted <= 0:
            failures.append(f"fleet: handoffs {n_ok} (want 6), prefill-only requests "
                            f"{pre_done} (want 6), adopted blocks {adopted}")
        pushes = []
        for (rid, _, _, launched, summ), p in zip(handoffs, [q for q in order if q in handoff]):
            summ = summ or {}
            blocks = (len(tok.tokenize(p)) + 1) // 32
            raw = blocks * 32 * kv_token_bytes
            got = summ.get("transfer_bytes", 0)
            pushes.append({"bytes": got, "ms": summ.get("transfer_ms"), "blocks": summ.get("blocks"),
                           "adopted": summ.get("adopted"), "reused": summ.get("reused")})
            log(f"fleet: push of {summ.get('blocks')} blocks: {got} bytes of KV in the GKV1 "
                f"payload, {summ.get('transfer_ms')} ms; adopted {summ.get('adopted')} "
                f"reused {summ.get('reused')}")
            if summ.get("blocks") != blocks or got != raw:
                failures.append(f"fleet: a push carried {summ.get('blocks')} blocks / {got} "
                                f"bytes of KV, want {blocks} blocks / {raw} bytes")
        by_prompt = dict(zip([q for q in order], dispatches))
        for rid in ("r1", "r2"):
            group = [p for p in handoff if p in long_[rid]]
            landed = {by_prompt[p][0] for p in group}
            if landed != {rid}:
                failures.append(f"fleet: the prompts sharing {rid}'s prefix landed on {landed}")
        later = [s for s in pushes[2:]]
        if any((s.get("reused") or 0) < 512 // 32 for s in later):
            failures.append(f"fleet: the later prompts of a shared prefix did not reuse "
                            f"its 16 cached blocks on their decode replica: {later}")
        by_rep = windows.by_replica()
        log(f"fleet: gmm launches by replica and variant {by_rep}; in all {fleet_variants}; "
            f"plain gmm calls {plain_calls['gmm']}")
        if set(by_rep.get("r0", {})) != {"f32"} or not by_rep["r0"]["f32"]:
            failures.append(f"fleet: the prefill replica's gmm launches {by_rep.get('r0')}")
        for rid in ("r1", "r2"):
            if not by_rep.get(rid, {}).get("f32_decode"):
                failures.append(f"fleet: decode replica {rid} launched no f32_decode gmm: "
                                f"{by_rep.get(rid)}")
        if plain_calls["gmm"] or fleet_launches != per * work:
            failures.append(f"fleet: {plain_calls['gmm']} plain gmm calls; {fleet_launches} "
                            f"launches against {per} x {work} engine steps")
        # TTFT through the fleet: a handoff's /prefill leg (the prefill
        # replica's queue and prefill, the export and the push, as the
        # router waits for it) plus the decode replica's TTFT (its queue,
        # the recomputed tail, the first token); a short prompt's is the
        # decode replica's alone
        legs = {p: row[4]["wall_ms"] for row, p in
                zip(handoffs, [q for q in order if q in handoff])}
        ttft_h = [round(legs[p] + results[p][1]["ttft_ms"], 3) for p in handoff
                  if results[p][0] == 200]
        ttft_l = [results[p][1].get("ttft_ms") for p in short if results[p][0] == 200]

        def tok_s(out):
            return (out["tokens"] - 1) / (out["decode_ms"] / 1e3) if out.get("decode_ms") else None

        perf.update({
            "ttft_ms_handoff": ttft_h, "ttft_ms_local_prefill": ttft_l,
            "handoff_leg_ms": [round(legs[p], 3) for p in handoff if p in legs],
            "decode_replica_ttft_ms_handoff": [results[p][1].get("ttft_ms") for p in handoff
                                               if results[p][0] == 200],
            "decode_tok_s_handoff": [tok_s(results[p][1]) for p in handoff
                                     if results[p][0] == 200],
            "decode_tok_s_local_prefill": [tok_s(results[p][1]) for p in short
                                           if results[p][0] == 200],
            "direct_ttft_ms_same_prompts": direct_perf["ttft_ms"],
            "direct_decode_tok_s_same_prompts": direct_perf["decode_tok_s"],
            "phase4_ttft_ms_single": path_perf.get("ttft_ms_single"),
            "phase4_decode_tok_s_single": path_perf.get("decode_tok_s_single"),
            "pushes": pushes, "gmm_launches_by_replica": by_rep,
            "gmm_launches_by_variant": fleet_variants, "plain_gmm_calls": plain_calls["gmm"],
        })

        # -- drain: 503 from the replica, the router routes around it
        dec2 = replicas[2]
        code, _ = post(dec2["url"], {"prompt": "x", "max_tokens": 2}, path="/admin/drain")
        code_g, _ = post(dec2["url"], {"prompt": death[0], "max_tokens": 2})
        router.poll_once()
        ok2 = router.metrics_registry.counter("serve_router_requests_total")
        before = ok2.value(replica="r2", outcome="ok")
        code_r, out_r = post(rurl, {"prompt": death[0], "max_tokens": FLEET_TOKENS})
        around = ok2.value(replica="r2", outcome="ok") == before
        post(dec2["url"], {}, path="/admin/undrain")
        router.poll_once()
        state = router.get_replica("r2").state
        log(f"fleet: drain {code}, its /generate {code_g}, through the router {code_r} "
            f"(around it: {around}); undrained: {state}")
        if code != 200 or code_g != 503 or code_r != 200 or not around \
                or out_r.get("token_ids") != refs[death[0]] or state != "active":
            failures.append(f"fleet: drain {code} / {code_g} / router {code_r}, routed "
                            f"around: {around}, after undrain {state}")

        # -- deadline: 504 before any engine step; a long budget passes
        s0 = steps()
        code_d, out_d = post(rurl, {"prompt": short[0], "max_tokens": FLEET_TOKENS},
                             headers={"X-Deadline-Ms": "1"})
        s1 = steps()
        code_ok, out_ok = post(rurl, {"prompt": short[0], "max_tokens": FLEET_TOKENS},
                               headers={"X-Deadline-Ms": "60000"})
        log(f"fleet: X-Deadline-Ms 1 -> {code_d} ({s1 - s0} engine steps); 60000 -> {code_ok}")
        if code_d != 504 or s1 != s0 or code_ok != 200 \
                or out_ok.get("token_ids") != refs[short[0]]:
            failures.append(f"fleet: deadline 1 ms gave {code_d} with {s1 - s0} engine steps; "
                            f"60000 ms gave {code_ok}")

        # -- a decode replica's death in the middle of four requests
        box = {}

        def send(i):
            box[i] = post(rurl, {"prompt": death[i], "max_tokens": FLEET_TOKENS})

        # the poller stops for the drill, so the requests after the stop find
        # r2 refusing (and replay) rather than already marked down
        router.stop()
        first = [threading.Thread(target=send, args=(i,)) for i in range(2)]
        for t in first:
            t.start()
        time.sleep(0.3)
        dec2["httpd"].shutdown()
        dec2["httpd"].server_close()
        rest = [threading.Thread(target=send, args=(i,)) for i in range(2, 4)]
        for t in rest:
            t.start()
        for t in first + rest:
            t.join(timeout=600)
        same = all(box.get(i, (0,))[0] == 200 and box[i][1]["token_ids"] == refs[death[i]]
                   for i in range(4))
        replays = router.metrics_registry.counter("serve_router_requests_total").value(
            replica="r2", outcome="dead")
        down = not router.get_replica("r2").up
        # the router's own poller, as deployed: the refused dispatch and its
        # refused scrapes of r2 (one each 0.5 s) count against r2's breaker
        # until it opens; nothing else calls r2
        router.start()
        t_dead = time.monotonic()
        while router.policy.breaker_state(dec2["url"]) != "open" \
                and time.monotonic() - t_dead < 15.0:
            time.sleep(0.05)
        opened = router.policy.breaker_state(dec2["url"]) == "open"
        open_s = time.monotonic() - t_dead
        dec2["httpd"] = serve(dec2["svc"], port=dec2["port"])
        revived = False
        for _ in range(100):
            if router.get_replica("r2").up:
                revived = True
                break
            time.sleep(0.1)
        # the scrape that revives r2 closes its breaker
        closed = router.policy.breaker_state(dec2["url"]) == "closed"
        log(f"fleet: decode r2 stopped mid-traffic: 4 requests "
            f"{[box.get(i, (0,))[0] for i in range(4)]}, same tokens {same}, refused "
            f"dispatches {replays}, marked down {down}, breaker open {opened} (by the "
            f"router's poller, {open_s:.2f}s after the drill), revived {revived}, "
            f"breaker closed again {closed}")
        if not (same and replays >= 1 and down and opened and revived and closed):
            failures.append(f"fleet: the death drill: same tokens {same}, replays {replays}, "
                            f"down {down}, breaker open {opened}, revived {revived}, "
                            f"closed again {closed}")

        # -- rolling swap to a second seeded checkpoint
        t_swap = time.perf_counter()
        new_cpu = llama.init_params(args, torch.Generator().manual_seed(SEED + 1),
                                    device="cpu")
        run_dir = os.path.join(tmp, "runs", "moe-8x40m-seed1")
        CheckpointManager(run_dir).save(1, new_cpu)
        stop = threading.Event()
        canary_codes = []

        def canary_traffic(k):
            i = 0
            while not stop.is_set():
                p = f"canary {k}.{i}: " + "a long enough prompt for the handoff " * 3
                canary_codes.append(post(rurl, {"prompt": p, "max_tokens": 4})[0])
                i += 1

        traffic = [threading.Thread(target=canary_traffic, args=(k,)) for k in range(3)]
        for t in traffic:
            t.start()
        swap_window["armed"] = True
        try:
            swap = ctl.rolling_swap(run_dir=run_dir, canary_requests=2,
                                    canary_timeout_s=120.0)
        finally:
            swap_window["armed"] = False
            stop.set()
            for t in traffic:
                t.join(timeout=120)
        swap_s = time.perf_counter() - t_swap
        log(f"fleet: rolling swap in {swap_s:.1f}s: {swap}; canary traffic "
            f"{len(canary_codes)} requests, codes {sorted(set(canary_codes))}")
        if swap["failed"] or [s["replica"] for s in swap["swapped"]] != ["r1", "r2", "r0"] \
                or any(c != 200 for c in canary_codes):
            failures.append(f"fleet: rolling swap {swap}; canary codes {set(canary_codes)}")
        direct = BatchEngine(replicas[1]["svc"].engine.params, args, tok,
                             EngineConfig(**engine_kw)).start()
        after = [f"after the swap {i}: " + "x" * (20 + 400 * (i % 2)) for i in range(3)]
        for p in after:
            want = direct.generate(p, max_tokens=FLEET_TOKENS)["token_ids"]
            code, out = post(rurl, {"prompt": p, "max_tokens": FLEET_TOKENS})
            if code != 200 or out["token_ids"] != want:
                failures.append(f"fleet: after the swap a {len(p)}-byte prompt gave "
                                f"HTTP {code} and tokens unlike a direct engine's on the "
                                f"new weights")
        # the prompts sent while only the decode pool had swapped, and the
        # ones sharing their prefixes after the rollout: the new weights'
        # tokens, no handoff across the two versions, the later ones handed
        # off and hitting the blocks their decode replica computed itself
        ok0 = router._mc_handoffs.value(outcome="ok")
        shared, window_lp = [], []
        for p, q in zip(in_window, after_window):
            code_w, out_w = swap_window["out"].get(p, (0, {}))
            code_a, out_a = post(rurl, {"prompt": q, "max_tokens": FLEET_TOKENS})
            shared.append(int(out_a.get("prefix_cached_tokens") or 0))
            for what, code, out, prompt in (("during", code_w, out_w, p),
                                            ("after", code_a, out_a, q)):
                # the first logprob too: KV of the old weights under the last
                # prompt token moves it even where the greedy tokens hold
                want = direct.generate(prompt, max_tokens=FLEET_TOKENS)
                d_lp = (abs(out["logprobs"][0] - want["logprobs"][0])
                        if code == 200 and out.get("logprobs") else float("inf"))
                window_lp.append(d_lp)
                if code != 200 or out.get("token_ids") != want["token_ids"] or d_lp > 1e-3:
                    failures.append(f"fleet: a prompt sent {what} the swap's decode-first "
                                    f"window gave HTTP {code}, tokens unlike a direct "
                                    f"engine's on the new weights or a first logprob "
                                    f"{d_lp:.3g} from its")
        ok_after = router._mc_handoffs.value(outcome="ok") - ok0
        log(f"fleet: swap window: {len(swap_window['out'])} prompts sent after the "
            f"decode pool swapped, handoffs skipped for the weights' version "
            f"{swap_window['skew']}; after the rollout {int(ok_after)} handoffs, cached "
            f"prefix tokens {shared}; |d first logprob| vs a direct engine "
            f"{[f'{x:.3g}' for x in window_lp]}")
        if len(swap_window["out"]) != 2 or (swap_window["skew"] or 0) < 2 \
                or ok_after != 2 or any(n < 512 - 32 for n in shared):
            failures.append(f"fleet: swap window: {len(swap_window['out'])} prompts, "
                            f"{swap_window['skew']} version skips, {ok_after} handoffs "
                            f"after, cached prefix tokens {shared}")
        direct.stop()
        direct = None
        perf.update(swap_s=swap_s, swap=swap)

        # -- the scope: series from every member; an alert with its bundle
        scope.collect_once()
        scope.collect_once()
        keys = scope.db.keys()
        instances = {parse_series_key(k)[1].get("instance") for k in keys}
        want_inst = {"router", "prefill0", "decode1", "decode2"}
        bdir = os.path.join(scfg.run_dir, "bundles")
        bundles = sorted(os.listdir(bdir)) if os.path.isdir(bdir) else []
        held = set()
        for b in bundles:
            for name in want_inst:
                mpath = os.path.join(bdir, b, name, "metrics.txt")
                if os.path.isfile(mpath) and os.path.getsize(mpath) > 0:
                    held.add(name)
        firing = [a["rule"] for a in scope.alerts().get("alerts", [])
                  if a.get("fire_count")]
        log(f"fleet: scope TSDB {len(keys)} series from {sorted(i for i in instances if i)}; "
            f"firing {firing}; bundles {bundles} holding {sorted(held)}")
        if not want_inst <= instances or "fleet-served" not in firing \
                or not bundles or held != want_inst:
            failures.append(f"fleet: scope series from {instances}, firing {firing}, "
                            f"bundles {bundles} with /metrics of {held}")

        # -- the fleet entry point as a process of its own
        fport = free_port()
        proc = subprocess.Popen(
            [sys.executable, "-m", "mlx_cuda_distributed_pretraining_tpu_torch.serve.fleet",
             "--fleet-dir", fleet_dir, "--port", str(fport)],
            cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            furl = f"http://127.0.0.1:{fport}"
            up = wait_for(lambda: _answers(furl + "/healthz"), 120, "the fleet process", proc)
            code_f, out_f = post(furl, {"prompt": after[0], "max_tokens": 4})
            _, prom = get_url(furl + "/metrics?format=prom")
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        out_text = proc.stdout.read()[-2000:]
        log(f"fleet: serve.fleet process: healthz {up}, a request {code_f}, /metrics "
            f"{len(prom)} bytes, exit {rc} on SIGINT")
        if code_f != 200 or b"serve_router_requests_total" not in prom or rc != 0:
            failures.append(f"fleet: the serve.fleet process: request {code_f}, exit {rc}: "
                            f"{out_text}")
    except Exception as e:  # noqa: BLE001 - reported as a failure
        import traceback

        failures.append(f"fleet: {type(e).__name__}: {e}: {traceback.format_exc()[-1500:]}")
    finally:
        gm.gmm_plain = real_plain
        if ctl is not None:
            ctl.stop()
        if rhttpd is not None:
            rhttpd.shutdown()
            rhttpd.server_close()
        if router is not None:
            router.stop()
        for r in replicas:
            r["beat"].set()
            try:
                r["httpd"].shutdown()
                r["httpd"].server_close()
            except Exception:  # noqa: BLE001 - the stopped one
                pass
            r["svc"].close()
        if direct is not None:
            direct.stop()
        tmp_obj.cleanup()
    perf["seconds"] = time.perf_counter() - t_phase
    for k, v in perf.items():
        if k != "swap":
            log(f"fleet: {k}={v} [{card}]")
    return failures, perf


def _answers(url: str) -> bool:
    try:
        return get_url(url, timeout=2.0)[0] == 200
    except Exception:  # noqa: BLE001 - not up yet
        return False


# -- phase 4e: the tp=2 batch engine under the launcher ------------------------------
TP_SERVE_ARMS = [("base", [], {}), ("kv_quant", ["--kv-quant"], {"kv_quant": True}),
                 ("spec", ["--spec-draft-len", "4"], {"spec_draft_len": 4})]
TP_SERVE_TOKENS = 16
TP_SERVE_WARMUP = "warm up"  # shorter than a KV block: it seeds no prefix


def tp_serve_prompts(served):
    """Phase 4's three greedy prompts, then two that share a 256-byte prefix
    (the second adopts the first's cached blocks)."""
    shared = ("Tensor parallel serving splits every head and expert column over "
              "the ranks of the mesh, and the leader broadcasts each step's plan: ")
    shared = (shared * 3)[:256]
    return [p for p, _ in served["greedy"]] + [shared + "first, the prefill.",
                                               shared + "then, the decode."]


def tp_serve_phase(torch, gm, fa, card, served, device: str = "cuda",
                   config: str = os.path.join(REPO, "configs", "model-config-moe-8x40m.yaml")):
    """moe-8x40m's batch engine in fp32 at full width (the serving phase's
    seeded weights: ``--config configs/model-config-moe-8x40m.yaml --seed
    0`` draws the same) served as ``infer.server --engine batch --mesh
    tp=2`` on 2 gloo ranks of ``parallel.launch`` on the one card, one arm
    after another in the same ranks (``scripts/serve_arms.py``): base,
    ``--kv-quant`` and ``--spec-draft-len 4``, each ended by a SIGTERM to the
    launcher. Each arm's prompts go one at a time over HTTP after a short
    warm-up request (the first cuBLAS and gloo calls); the reference is a
    one-device engine in this process with the same settings and arm.
    Gates: greedy tokens identical and the first logprob within abs 1e-3;
    the prefix cache's adopted tokens equal; on both ranks every gmm launch
    on ``f32`` (prefill) or ``f32_decode`` (decode) at the rank's widths (N
    768 for gate/up, K 768 for down), 36 a device step on each; every rank
    exits 0 after each stop. Prints TTFT and decode tok/s beside the card.
    ``device="cpu"`` with a small ``config`` (and ``served`` drawn from it at
    seed 0) rehearses it on the CPU, where only the kernel gates fail."""
    import signal
    import tempfile

    from mlx_cuda_distributed_pretraining_tpu_torch.serve import BatchEngine, EngineConfig

    failures, perf = [], {}
    if served is None:
        return ["tp serve: the serving phase failed before its weights were served"], {}
    t_phase = time.perf_counter()
    args = served["args"]
    prompts = tp_serve_prompts(served)
    engine_kw = dict(num_slots=8, max_len=1024, block_size=32, prefill_chunk=256,
                     prefix_cache=True)
    per = 3 * args.num_layers  # gmm launches a device step, on each rank
    half = args.intermediate_size // 2

    # the one-device reference, each arm on the served weights
    ref = {}
    for name, _, arm in TP_SERVE_ARMS:
        eng = BatchEngine(served["params"], args, served["tok"],
                          EngineConfig(**engine_kw, **arm)).start()
        try:
            eng.generate(TP_SERVE_WARMUP, max_tokens=2, temperature=0.0, timeout=600.0)
            ref[name] = [eng.generate(p, max_tokens=TP_SERVE_TOKENS, temperature=0.0,
                                      timeout=600.0) for p in prompts]
        finally:
            eng.stop()
    if device == "cuda":
        torch.cuda.empty_cache()

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        out_path = os.path.join(tmp, "server.out")
        common = ["--config", config, "--seed", str(SEED), "--engine", "batch", "--device", device,
                  "--mesh", "tp=2", "--host", "127.0.0.1", "--port", "0",
                  "--slots", "8", "--kv-len", "1024", "--block-size", "32",
                  "--prefill-chunk", "256"]
        cmd = launch_cmd(2, "--device", device, "--backend", "gloo", "--timeout-s", "500",
                         "--script", os.path.join(REPO, "scripts", "serve_arms.py"), "--",
                         tmp, json.dumps([a for _, a, _ in TP_SERVE_ARMS]), *common)
        env = dict(os.environ, PYTHONPATH=REPO)
        t0 = time.perf_counter()
        with open(out_path, "w") as out:
            proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=out,
                                    stderr=subprocess.STDOUT, start_new_session=True)
        try:
            for i, (name, _, _) in enumerate(TP_SERVE_ARMS):
                url = None
                deadline = time.monotonic() + 240
                while url is None and time.monotonic() < deadline and proc.poll() is None:
                    found = [ln.rsplit(" on ", 1)[-1].strip() for ln in
                             tail_of(out_path, 10**7).splitlines()
                             if ln.startswith("serving ") and " on http://" in ln]
                    url = found[i] if len(found) > i else None
                    time.sleep(0.2)
                if url is None:
                    failures.append(f"tp serve: arm {name} never served: "
                                    f"{tail_of(out_path, 3000)}")
                    break
                post(url, {"prompt": TP_SERVE_WARMUP, "max_tokens": 2, "temperature": 0.0})
                got, t_arm = [], time.perf_counter()
                for p in prompts:
                    code, res = post(url, {"prompt": p, "max_tokens": TP_SERVE_TOKENS,
                                           "temperature": 0.0})
                    got.append(res if code == 200 else {"error": (code, res)})
                t_arm = time.perf_counter() - t_arm
                metrics = json.loads(get_url(url + "/metrics")[1])
                proc.send_signal(signal.SIGTERM)  # the launcher hands it to both ranks
                perf[name] = {"results": got, "metrics": metrics, "requests_s": t_arm}
            rc = proc.wait(timeout=300)
        except subprocess.TimeoutExpired:
            rc = 124
        finally:
            kill_group(proc)
        wall = time.perf_counter() - t0
        records = {}
        for i, (name, _, _) in enumerate(TP_SERVE_ARMS):
            for r in (0, 1):
                path = os.path.join(tmp, f"arm{i}_rank{r}.json")
                if os.path.isfile(path):
                    with open(path) as f:
                        records[(name, r)] = json.load(f)
        server_log = tail_of(out_path, 10**7)
    log(f"tp serve: the launcher exit {rc} after {wall:.1f}s (three arms, one launch)")
    if rc != 0:
        failures.append(f"tp serve: the launcher exit {rc}: {server_log[-3000:]}")

    for name, _, _ in TP_SERVE_ARMS:
        arm = perf.get(name)
        if arm is None:
            failures.append(f"tp serve: arm {name} has no results")
            continue
        for j, (res, want) in enumerate(zip(arm["results"], ref[name])):
            if "error" in res:
                failures.append(f"tp serve: {name} prompt {j}: {res['error']}")
                continue
            d_lp = abs(res["logprobs"][0] - want["logprobs"][0]) if res["logprobs"] else None
            same = res["token_ids"] == want["token_ids"]
            cached = (res.get("prefix_cached_tokens"), want.get("prefix_cached_tokens"))
            log(f"tp serve: {name} prompt {j}: tokens identical {same}, |d first logprob| "
                f"{d_lp}, prefix cached {cached[0]} vs one device {cached[1]}, ttft_ms "
                f"{res.get('ttft_ms')} vs {want.get('ttft_ms')}")
            if not same or d_lp is None or d_lp > 1e-3 or cached[0] != cached[1]:
                failures.append(f"tp serve: {name} prompt {j}: {res} vs {want}")
        hits = [sum(1 for r in arm["results"] if r.get("prefix_cached_tokens")),
                sum(1 for r in ref[name] if r.get("prefix_cached_tokens"))]
        if hits[0] != hits[1] or hits[0] < 1:
            failures.append(f"tp serve: {name} prefix-cache hits {hits}")
        steps = int(arm["metrics"].get("prefill_chunks", -1)) + \
            int(arm["metrics"].get("decode_steps", -1))
        for r in (0, 1):
            rec = records.get((name, r), {})
            by_v = rec.get("gmm_by_variant", {})
            shapes = {tuple(k): n for k, n in rec.get("gmm_by_shape", [])}
            bad = {k: n for k, n in shapes.items()
                   if not ((k[2], k[3]) in ((args.hidden_size, half), (half, args.hidden_size))
                           and k[0] in ("f32", "f32_decode")
                           and (k[0] == "f32_decode") == (k[4] == 8))}
            n = sum(by_v.values())
            log(f"tp serve: {name} rank {r}: exit {rec.get('rc')}, gmm launches {n} by "
                f"variant { {k: v for k, v in by_v.items() if v} } over {steps} device steps, "
                f"shapes (variant, T, K, N, block_t) {sorted(shapes)}, peak memory "
                f"{rec.get('peak_device_mem_gb')} GB [{card}]")
            if rec.get("rc") != 0 or bad or n != per * steps or \
                    set(k for k, v in by_v.items() if v) != {"f32", "f32_decode"}:
                failures.append(f"tp serve: {name} rank {r}: {rec} (want {per} x {steps} on "
                                f"f32/f32_decode at K/N {half}; off-shape {bad})")
        arm.update(launches={r: records.get((name, r), {}).get("gmm_by_variant")
                             for r in (0, 1)},
                   launches_by_shape={r: records.get((name, r), {}).get("gmm_by_shape")
                                      for r in (0, 1)},
                   device_steps=steps)
    base = perf.get("base", {}).get("results") or []
    ok = [r for r in base if "error" not in r and r.get("decode_ms")]
    if ok:
        perf["ttft_ms"] = [r.get("ttft_ms") for r in ok]
        perf["decode_tok_s"] = [(r["tokens"] - 1) / (r["decode_ms"] / 1e3) for r in ok]
        ref_ok = [r for r in ref["base"] if r.get("decode_ms")]
        perf["one_device_ttft_ms"] = [r.get("ttft_ms") for r in ref_ok]
        perf["one_device_decode_tok_s"] = [(r["tokens"] - 1) / (r["decode_ms"] / 1e3)
                                           for r in ref_ok]
        for k in ("ttft_ms", "decode_tok_s", "one_device_ttft_ms", "one_device_decode_tok_s"):
            log(f"tp serve: {k}={perf[k]} (tp=2 on 2 gloo ranks of one card: the host "
                f"carries every sum over tp and gloo sets the pace) [{card}]")
    perf["seconds"] = time.perf_counter() - t_phase
    log(f"tp serve: the phase took {perf['seconds']:.1f}s")
    return failures, perf


# -- phase 5: the training path ---------------------------------------------------
def config_40m(tmp: str, steps: int, warmup: int) -> dict:
    """configs/model-config-40m-adamw.yaml written out as a dict, with the
    smoke's cuts: ``iters``, ``warmup_steps``, the log, validation and
    checkpoint intervals, and the corpus paths. Every width is the
    config's. The file's ``system.device: "tpu"`` is left out: the port
    keeps that key only for the round trip, and the Trainer's ``device``
    argument decides."""
    return {
        "name": "Llama (40M)", "overwrite": True,
        "data": {"input_file": os.path.join(tmp, "train.jsonl"),
                 "validation_file": os.path.join(tmp, "val.jsonl"),
                 "tokenizer_path": "tokenizer",
                 "preprocessing": {"max_context_size": 1024, "chunk_overlap": 0},
                 "tokenizer": {"normal_vocab_size": 256, "special_tokens": {
                     "pad": "<pad>", "bos": "<bos>", "eos": "<eos>"}}},
        "model": {"architecture": "llama",
                  "dimensions": {"hidden_size": 512, "intermediate_size": 1536,
                                 "num_layers": 12},
                  "attention": {"num_heads": 8, "num_kv_heads": 8, "head_dim": 64,
                                "max_position_embeddings": 1024,
                                "use_flash_attention": True},
                  "normalization": {"rms_norm_eps": 1.0e-5},
                  "rope": {"theta": 10000, "traditional": False, "scaling": None},
                  "misc": {"attention_bias": False, "mlp_bias": False,
                           "tie_word_embeddings": True}},
        "training": {"hyperparameters": {"batch_size": 32, "learning_rate": 6.0e-4,
                                         "weight_decay": 0.05, "gradient_clip": 1.0,
                                         "iters": steps},
                     "scheduler": {"type": "cosine_with_warmup",
                                   "warmup_steps": warmup, "min_lr_ratio": 0.1},
                     "optimization": {"optimizer": "adamw", "betas": [0.9, 0.95]}},
        "logging": {"log_dir": "logs", "checkpoint_dir": "checkpoints",
                    "steps": {"logging_interval": 5, "checkpoint_interval": 1000,
                              "validation_interval": 0},
                    "metrics": {"log_loss": True, "log_perplexity": True,
                                "log_tokens_per_second": True}},
        "system": {"seed": 42, "mixed_precision": True,
                   "precision": "bfloat16"},
    }


def write_corpus(tmp: str, train_bytes: int, val_bytes: int) -> None:
    """A seeded synthetic byte corpus: documents of sentences drawn from a
    small Zipf-weighted vocabulary, so a few steps can learn something."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    syll = ["ka", "lo", "mi", "ne", "su", "ta", "ri", "po", "an", "el", "or", "ve"]
    words = ["".join(rng.choice(syll, size=int(rng.integers(1, 4))))
             for _ in range(96)]
    weights = 1.0 / np.arange(1, len(words) + 1)
    weights /= weights.sum()

    def docs(n_bytes):
        out, total = [], 0
        while total < n_bytes:
            sentences = []
            for _ in range(int(rng.integers(4, 40))):
                ids = rng.choice(len(words), size=int(rng.integers(4, 16)), p=weights)
                sentences.append(" ".join(words[i] for i in ids).capitalize() + ".")
            text = " ".join(sentences)
            out.append(json.dumps({"text": text}))
            total += len(text)
        return "\n".join(out) + "\n"

    with open(os.path.join(tmp, "train.jsonl"), "w") as f:
        f.write(docs(train_bytes))
    with open(os.path.join(tmp, "val.jsonl"), "w") as f:
        f.write(docs(val_bytes))


def first_step_parity(torch, trainer, rows: int, swaps, host_batch=None):
    """Step 1's loss and gradients on ``rows`` rows of the first batch (or
    of ``host_batch``: a streaming loader's batches are not a function of
    the step, so one drawn here would be missing from the run): the
    kernels against their plain versions, the same model code with
    ``swaps`` (``(module, name, plain function)``) set for the second run
    only. The loss is the training loss (an MoE model's router losses in)."""
    from mlx_cuda_distributed_pretraining_tpu_torch.models import llama
    from mlx_cuda_distributed_pretraining_tpu_torch.optim.base import global_norm
    from mlx_cuda_distributed_pretraining_tpu_torch.utils.tree import leaves_with_path

    if host_batch is None:
        host_batch = trainer.data.generate_batch(0)
    batch = {k: torch.from_numpy(v[:rows]).to(trainer.device)
             for k, v in host_batch.items()}
    params = trainer.state["params"]

    def loss_and_grads():
        for _, p in leaves_with_path(params):
            p.grad = None
        loss, _ = llama.loss_fn(params, batch, trainer.model_args,
                                compute_dtype=trainer.compute_dtype)
        loss.backward()
        grads = {"/".join(path): p.grad.float().clone()
                 for path, p in leaves_with_path(params)}
        for _, p in leaves_with_path(params):
            p.grad = None
        return loss.item(), grads

    kernel_loss, kernel_grads = loss_and_grads()
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        plain_loss, plain_grads = loss_and_grads()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    norm_k, norm_p = global_norm(kernel_grads).item(), global_norm(plain_grads).item()
    leaf_rel = {n: ((kernel_grads[n] - plain_grads[n]).norm()
                    / plain_grads[n].norm().clamp_min(1e-30)).item()
                for n in plain_grads}
    worst = max(leaf_rel, key=leaf_rel.get)
    return {"kernel_loss": kernel_loss, "plain_loss": plain_loss,
            "kernel_grad_norm": norm_k, "plain_grad_norm": norm_p,
            "max_leaf_rel_grad_diff": leaf_rel[worst], "worst_leaf": worst}


def parity_ok(par, loss: float = 2e-3, norm: float = 2e-2, leaf: float = 5e-2) -> bool:
    """The step-1 limits, each relative to the plain run: loss, gradient
    norm and every leaf's gradient (by default bf16's 2e-3, 2e-2, 5e-2)."""
    return (abs(par["kernel_loss"] - par["plain_loss"]) <= loss * abs(par["plain_loss"])
            and abs(par["kernel_grad_norm"] - par["plain_grad_norm"])
            <= norm * par["plain_grad_norm"]
            and par["max_leaf_rel_grad_diff"] <= leaf)


def serve_run(torch, run_dir: str, device, run_name: str):
    """One greedy request through the port's server on a finished run."""
    from mlx_cuda_distributed_pretraining_tpu_torch.infer.server import (
        InferenceService,
        serve,
    )
    from mlx_cuda_distributed_pretraining_tpu_torch.serve import EngineConfig
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import load_trained

    params, args, tok, _ = load_trained(run_dir, device=device)
    service = InferenceService(params, args, tok, run_name=run_name)
    service.attach_engine(EngineConfig(num_slots=2, max_len=1024, block_size=32,
                                       prefill_chunk=256))
    httpd = serve(service, port=0)
    try:
        return post(f"http://127.0.0.1:{httpd.server_address[1]}",
                    {"prompt": "Kalo mine su", "max_tokens": 16})
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()


def train_phase(torch, gm, fa, card, steps: int = 30, warmup: int = 10):
    import tempfile

    from mlx_cuda_distributed_pretraining_tpu_torch.config import Config
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer

    failures = []
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        t0 = time.perf_counter()
        write_corpus(tmp, train_bytes=1_100_000, val_bytes=70_000)
        trainer = Trainer(Config.from_dict(config_40m(tmp, steps, warmup)),
                          runs_root=os.path.join(tmp, "runs"), quiet=True,
                          device="cuda")
        log(f"train: 40m-adamw {trainer.n_params / 1e6:.2f}M params, "
            f"{len(trainer.data.train_rows)} train rows, "
            f"{len(trainer.data.val_rows)} val rows of "
            f"{trainer.data.seq_len + 1} tokens, "
            f"{time.perf_counter() - t0:.1f}s to set up")

        # bf16 on both sides with the same rounding points outside the
        # attention; inside it the kernels sum in another order and round p
        # against a running max: bf16-ulp noise (2**-8) that twelve layers
        # carry to the loss at ~1e-4 and to each gradient at ~1e-2. At
        # initialisation the loss is ~ln(259) whatever the attention
        # computes, so the per-leaf gradient limit is the one that gates an
        # attention fault here; the kernel checks above gate each kernel.
        par = first_step_parity(
            torch, trainer, 8,
            [(fa, n, getattr(fa, n + "_plain")) for n in FLASH_KERNELS])
        log(f"train: step-1 parity at batch 8, kernels vs plain on the card: {par}")
        if not parity_ok(par):
            failures.append(f"step-1 loss/gradients disagree with the plain "
                            f"path: {par}")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(gm, fa)  # count from here: the training run only
        t0 = time.perf_counter()
        result = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(gm, fa)
        variants = read_variants(gm, fa)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        windows = trainer.windows
        losses = [w["loss"] for w in windows]
        layers = trainer.model_args.num_layers
        want = {"flash_fwd": layers * (steps + trainer.eval_batches),
                "flash_bwd_dq": layers * steps, "flash_bwd_dkv": layers * steps,
                "gmm": 0, "tgmm": 0}
        want_variants = flash_variants_want(fa, want["flash_fwd"], want["flash_bwd_dq"])
        flash_variants = {n: variants[n] for n in FLASH_KERNELS}
        log(f"train: flash launches by variant {flash_variants}")
        if flash_variants != want_variants:
            failures.append(f"train: flash launches by variant {flash_variants} != "
                            f"{want_variants}")
        log(f"train: {steps} steps + {trainer.eval_batches} validation batches "
            f"in {wall:.1f}s; losses every 5 steps {losses}; final val_loss="
            f"{result['final_val_loss']}; launches {launches}")
        if not all(math.isfinite(x) for x in losses) or len(losses) != steps // 5:
            failures.append(f"train: bad loss log {losses}")
        elif not losses[-1] < 0.9 * losses[0]:
            failures.append(f"train: loss did not fall below 0.9x the first "
                            f"logged ({losses[0]} -> {losses[-1]})")
        if result["final_val_loss"] is None or trainer.eval_batches <= 0:
            failures.append("train: no validation ran")
        if launches != want:
            failures.append(f"train: launches {launches} != {want}")
        code, out = serve_run(torch, trainer.run_dir, trainer.device,
                              "40m-adamw-smoke")
        log(f"train: final checkpoint served: HTTP {code} "
            f"tokens={out.get('tokens')} text={out.get('text', '')[:40]!r}")
        if code != 200 or not out.get("tokens"):
            failures.append(f"serving the final checkpoint: HTTP {code} {out}")

    steady = windows[1:]  # the first window holds the first step's warm-up
    secs = sum(w["seconds"] for w in steady)
    toks = sum(w["toks"] for w in steady)
    tok_s = toks / secs
    perf = {"step_ms": 1e3 * secs / sum(w["steps"] for w in steady),
            "tok_s": tok_s,
            "mfu_vs_989tflops": tok_s * trainer.flops_per_token / PEAK_FLOPS["bfloat16"],
            "flops_per_token": trainer.flops_per_token,
            "peak_mem_gb": peak_gb, "first_window_s": windows[0]["seconds"],
            "losses": losses, "launches": launches,
            "launches_by_variant": flash_variants, "first_step_parity": par}
    for k in ("step_ms", "tok_s", "mfu_vs_989tflops", "peak_mem_gb"):
        log(f"train: {k}={perf[k]} [{card}]")
    return failures, perf


# -- phase 5 (fp32): 40m-adamw without mixed precision ------------------------------
def with_tf32(torch, fn):
    """``fn`` with TF32 on for matmuls while it runs: a plain attention
    function at 1xTF32 precision, the step-1 check's lower-precision
    control."""
    def run(*args, **kw):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return fn(*args, **kw)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return run


def fp32_train_phase(torch, gm, fa, card, steps: int = 10, warmup: int = 2):
    """configs/model-config-40m-adamw.yaml with ``system.mixed_precision``
    false (the port's default: compute_dtype float32) at full width, 10
    steps through ``Trainer.train()``: every flash launch on the "f32"
    kernels (12 forwards a step and a validation batch, 12 of each backward
    kernel a step), step 1 against the plain attention path in fp32 (and a
    1xTF32 attention, which the same limits must reject), the loss falls."""
    import tempfile

    from mlx_cuda_distributed_pretraining_tpu_torch.config import Config
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer

    failures = []
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        t0 = time.perf_counter()
        write_corpus(tmp, train_bytes=1_100_000, val_bytes=70_000)
        cfg = config_40m(tmp, steps, warmup)
        cfg["name"] = "Llama (40M) fp32"
        cfg["system"] = {"seed": 42, "mixed_precision": False}
        cfg["logging"]["steps"]["logging_interval"] = 2
        # a greedy sample at the validation step (the last)
        cfg["logging"]["steps"]["validation_interval"] = steps
        cfg["logging"]["log_samples"] = True
        trainer = Trainer(Config.from_dict(cfg), runs_root=os.path.join(tmp, "runs"),
                          quiet=True, device="cuda")
        log(f"train fp32: 40m-adamw, compute_dtype {trainer.compute_dtype}, "
            f"{time.perf_counter() - t0:.1f}s to set up")
        if trainer.compute_dtype != torch.float32:
            failures.append(f"train fp32: compute_dtype {trainer.compute_dtype}")

        # fp32 on both sides: the kernels (3xTF32 products summed in fp32)
        # and cuBLAS's fp32 products differ by rounding only. The limits
        # (loss 1e-5, gradient norm 1e-6, every leaf 1e-5) lie between that
        # and a 1xTF32 attention (the plain versions' products with TF32
        # on), which must fail them.
        limits = {"loss": 1e-5, "norm": 1e-6, "leaf": 1e-5}
        plain = {n: getattr(fa, n + "_plain") for n in FLASH_KERNELS}
        par = first_step_parity(torch, trainer, 8, [(fa, n, f) for n, f in plain.items()])
        log(f"train fp32: step-1 parity at batch 8, kernels vs plain on the card: {par}")
        if not parity_ok(par, **limits):
            failures.append(f"train fp32: step-1 loss/gradients disagree with the plain "
                            f"path: {par}")
        control = first_step_parity(
            torch, trainer, 8, [(fa, n, with_tf32(torch, f)) for n, f in plain.items()])
        log(f"train fp32: step-1 control, kernels vs a 1xTF32 attention: {control}")
        if parity_ok(control, **limits):
            failures.append(f"train fp32: the step-1 check passed a 1xTF32 attention: "
                            f"{control}")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(gm, fa)  # count from here: the training run only
        t0 = time.perf_counter()
        result = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(gm, fa)
        flash_variants = {n: v for n, v in read_variants(gm, fa).items() if n in FLASH_KERNELS}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        windows = trainer.windows
        losses = [w["loss"] for w in windows]
        layers = trainer.model_args.num_layers
        fwd, bwd = layers * (steps + trainer.eval_batches), layers * steps
        zero = dict.fromkeys(fa.FLASH_VARIANTS, 0)
        want_variants = {"flash_fwd": {**zero, "f32": fwd}, "flash_bwd_dq": {**zero, "f32": bwd},
                         "flash_bwd_dkv": {**zero, "f32": bwd}}
        log(f"train fp32: {steps} steps + {trainer.eval_batches} validation batches in "
            f"{wall:.1f}s; losses every 2 steps {losses}; final val_loss="
            f"{result['final_val_loss']}; flash launches by variant {flash_variants}")
        if flash_variants != want_variants:
            failures.append(f"train fp32: flash launches by variant {flash_variants} != "
                            f"{want_variants}")
        if launches != {"flash_fwd": fwd, "flash_bwd_dq": bwd, "flash_bwd_dkv": bwd,
                        "gmm": 0, "tgmm": 0}:
            failures.append(f"train fp32: launches {launches}")
        if not all(math.isfinite(x) for x in losses) or len(losses) != steps // 2:
            failures.append(f"train fp32: bad loss log {losses}")
        elif not losses[-1] < losses[0]:
            failures.append(f"train fp32: loss did not fall ({losses[0]} -> {losses[-1]})")

        # logging.log_samples: the sample line, and the losses of the same
        # run without it (the embedding gradient's atomic adds may move the
        # last bits, hence 1e-5 relative; bitwise printed)
        with open(os.path.join(trainer.run_dir, "log.txt")) as f:
            samples = [line.strip() for line in f if " sample: " in line]
        log(f"train fp32: log_samples lines {samples}")
        if len(samples) != 1 or not samples[0].startswith(f"Step {steps} sample: "):
            failures.append(f"train fp32: log_samples wrote {samples}")
        cfg["logging"]["log_samples"] = False
        cfg["name"] = "Llama (40M) fp32, no samples"
        t0 = time.perf_counter()
        baseline = Trainer(Config.from_dict(cfg), runs_root=os.path.join(tmp, "runs"),
                           quiet=True, device="cuda")
        baseline.train()
        base_losses = [w["loss"] for w in baseline.windows]
        same = all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(losses, base_losses)) \
            and len(losses) == len(base_losses)
        log(f"train fp32: without log_samples, losses {base_losses} "
            f"({time.perf_counter() - t0:.1f}s); within 1e-5: {same}, bitwise: "
            f"{losses == base_losses}")
        if not same:
            failures.append(f"train fp32: log_samples changed the losses: {losses} vs "
                            f"{base_losses}")
        del baseline

    steady = windows[1:]  # the first window holds the first step's warm-up
    secs = sum(w["seconds"] for w in steady)
    tok_s = sum(w["toks"] for w in steady) / secs
    perf = {"step_ms": 1e3 * secs / sum(w["steps"] for w in steady), "tok_s": tok_s,
            "peak_mem_gb": peak_gb, "first_window_s": windows[0]["seconds"],
            "losses": losses, "launches": launches, "launches_by_variant": flash_variants,
            "first_step_parity": par, "first_step_tf32_control": control, "wall_s": wall}
    for k in ("step_ms", "tok_s", "peak_mem_gb"):
        log(f"train fp32: {k}={perf[k]} [{card}]")
    return failures, perf


# -- phase 6: MoE training ------------------------------------------------------------
def config_moe(tmp: str, steps: int, warmup: int) -> dict:
    """configs/model-config-moe-8x40m.yaml written out as a dict, with the
    smoke's cuts: ``iters``, ``warmup_steps``, the log, validation and
    checkpoint intervals, and the corpus paths. ``system.mesh`` ({dp: -1,
    ep: 4}: expert parallelism over four ranks, phase 6c) is dropped: this
    phase trains in the smoke's process on one device; so is
    ``system.device``. Every width is the config's."""
    cfg = config_40m(tmp, steps, warmup)
    cfg["name"] = "Llama-MoE (8x40M)"
    cfg["model"]["moe"] = {"num_local_experts": 8, "num_experts_per_tok": 2,
                           "impl": "grouped", "capacity_factor": 1.25,
                           "aux_loss_weight": 0.01, "router_z_weight": 0.001,
                           "group_size": 256}
    return cfg


def moe_parity(torch, gm, moe, trainer):
    """Step-1 parity with the gmm and tgmm kernels against their plain
    versions (the flash kernels run in both), and how many of the routing
    selections changed expert between the two runs."""
    chosen = []
    grouped_ffn = moe._grouped_ffn

    def recording(experts, x_flat, gate_idx, *a, **kw):
        chosen.append(gate_idx.sort(dim=-1).values)
        return grouped_ffn(experts, x_flat, gate_idx, *a, **kw)

    def gmm_forward_plain(x, w, gs, block_t, w_trans=False):
        return gm.gmm_plain(x, w.transpose(1, 2) if w_trans else w, gs, block_t)

    moe._grouped_ffn = recording
    try:
        par = first_step_parity(torch, trainer, 8, [
            (gm, "_gmm_forward", gmm_forward_plain), (gm, "tgmm", gm.tgmm_plain)])
    finally:
        moe._grouped_ffn = grouped_ffn
    half = len(chosen) // 2
    par["selections_changed"] = int(sum(
        (a != b).sum().item() for a, b in zip(chosen[:half], chosen[half:])))
    par["selections"] = int(sum(a.numel() for a in chosen[:half]))
    return par


def moe_train_phase(torch, gm, fa, card, steps: int = 30, warmup: int = 10):
    import tempfile

    from mlx_cuda_distributed_pretraining_tpu_torch.config import Config
    from mlx_cuda_distributed_pretraining_tpu_torch.models import moe
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer

    failures = []
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        t0 = time.perf_counter()
        write_corpus(tmp, train_bytes=1_100_000, val_bytes=70_000)
        trainer = Trainer(Config.from_dict(config_moe(tmp, steps, warmup)),
                          runs_root=os.path.join(tmp, "runs"), quiet=True,
                          device="cuda")
        log(f"moe: moe-8x40m {trainer.n_params / 1e6:.2f}M params, "
            f"{trainer.flops_per_token / 1e6:.1f} MFLOP per token (active), "
            f"{len(trainer.data.train_rows)} train rows, "
            f"{time.perf_counter() - t0:.1f}s to set up")

        # bf16 on both sides; the gmm kernels and their plain versions sum
        # each fp32 product in another order before one bf16 rounding (tgmm:
        # each tile's partial and the running sum), the combine and the
        # gather's backward scatter-add with atomics (an ulp per add, run to
        # run), and a token whose top-2 router probabilities nearly tie can
        # route differently in the two runs. The same limits as the dense
        # phase; the selections that changed expert are reported.
        par = moe_parity(torch, gm, moe, trainer)
        log(f"moe: step-1 parity at batch 8, gmm/tgmm kernels vs plain: {par}")
        if not parity_ok(par):
            failures.append(f"moe: step-1 loss/gradients disagree with the plain "
                            f"gmm/tgmm: {par}")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(gm, fa)  # count from here: the MoE training run only
        t0 = time.perf_counter()
        result = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(gm, fa)
        variants = read_variants(gm, fa)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        windows = trainer.windows
        losses = [w["loss"] for w in windows]
        layers, vb = trainer.model_args.num_layers, trainer.eval_batches
        want = {"gmm": 6 * layers * steps + 3 * layers * vb,
                "tgmm": 3 * layers * steps,
                "flash_fwd": layers * (steps + vb),
                "flash_bwd_dq": layers * steps, "flash_bwd_dkv": layers * steps}
        log(f"moe: {steps} steps + {vb} validation batches in {wall:.1f}s; losses "
            f"every 5 steps {losses}; final val_loss={result['final_val_loss']}; "
            f"launches {launches}")
        for w in windows:
            log(f"moe: step {w['step']} moe_entropy={w.get('moe_entropy')} "
                f"moe_drop={w.get('moe_drop')} moe_load_max={w.get('moe_load_max')} "
                f"seconds={w['seconds']:.4f} dispatch_s={w['dispatch_s']:.4f}")
        if not all(math.isfinite(x) for x in losses) or len(losses) != steps // 5:
            failures.append(f"moe: bad loss log {losses}")
        elif not losses[-1] < 0.9 * losses[0]:
            failures.append(f"moe: loss did not fall below 0.9x the first "
                            f"logged ({losses[0]} -> {losses[-1]})")
        if not all(0.0 < w.get("moe_entropy", -1) <= 1.0 and w.get("moe_drop") == 0
                   and 1 / 8 <= w.get("moe_load_max", -1) <= 1.0 for w in windows):
            failures.append("moe: a log line lacks sane routing stats")
        if result["final_val_loss"] is None or vb <= 0:
            failures.append("moe: no validation ran")
        if launches != want:
            failures.append(f"moe: launches {launches} != {want}")
        # bf16 at block_t 128: the TMA/wgmma kernels and no other; the
        # flash kernels on wgmma
        want_variants = {"gmm": {**dict.fromkeys(gm.GMM_VARIANTS, 0), "wgmma": want["gmm"]},
                         "tgmm": {**dict.fromkeys(gm.TGMM_VARIANTS, 0),
                                  "wgmma": want["tgmm"]},
                         **flash_variants_want(fa, want["flash_fwd"], want["flash_bwd_dq"])}
        log(f"moe: launches by variant {variants}")
        if variants != want_variants:
            failures.append(f"moe: launches by variant {variants} != {want_variants}")
        code, out = serve_run(torch, trainer.run_dir, trainer.device,
                              "moe-8x40m-smoke")
        log(f"moe: final checkpoint served: HTTP {code} "
            f"tokens={out.get('tokens')} text={out.get('text', '')[:40]!r}")
        if code != 200 or not out.get("tokens"):
            failures.append(f"moe: serving the final checkpoint: HTTP {code} {out}")
        flops_per_token = trainer.flops_per_token
        del trainer
    torch.cuda.empty_cache()

    steady = windows[1:]  # the first window holds the first step's warm-up
    secs = sum(w["seconds"] for w in steady)
    tok_s = sum(w["toks"] for w in steady) / secs
    perf = {"step_ms": 1e3 * secs / sum(w["steps"] for w in steady),
            "tok_s": tok_s,
            "mfu_active_vs_989tflops": tok_s * flops_per_token / PEAK_FLOPS["bfloat16"],
            "flops_per_token": flops_per_token,
            "peak_mem_gb": peak_gb, "first_window_s": windows[0]["seconds"],
            "losses": losses, "launches": launches, "launches_by_variant": variants,
            "losses_by_step": {w["step"]: w["loss"] for w in windows},
            "steps": steps, "layers": layers, "validation_batches": vb,
            "first_step_parity": par,
            "routing": [{k: w.get(k) for k in ("step", "moe_entropy", "moe_drop",
                                                "moe_load_max")} for w in windows]}
    for k in ("step_ms", "tok_s", "mfu_active_vs_989tflops", "peak_mem_gb"):
        log(f"moe: {k}={perf[k]} [{card}]")
    return failures, perf


# -- phase 9b: telemetry and the supervisor on the MoE training path ----------------
# The bf16 kernels of phase 6's step, as torch.profiler names them.
PROFILED_KERNELS = {"flash_fwd": "flash_fwd_bf16_wgmma_kernel",
                    "flash_bwd_dq": "flash_bwd_dq_bf16_wgmma_kernel",
                    "flash_bwd_dkv": "flash_bwd_dkv_bf16_wgmma_kernel",
                    "gmm": "gmm_bf16_wgmma_kernel", "tgmm": "tgmm_bf16_wgmma_kernel"}
# the torch.profiler window: steps 16-19, well past the SIGKILL at step 10's
# manifest (at 12-14 a host slow to send it let the first child profile too)
TELEMETRY_PROFILE = (16, 20)
TELEMETRY_HANG_S = 30.0


def wait_for(pred, timeout: float, what: str, proc=None, poll: float = 0.05):
    """Poll ``pred`` until it returns something truthy; raise on timeout or
    when ``proc`` ended first."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = pred()
        if got:
            return got
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"the supervisor exited ({proc.returncode}) "
                               f"while waiting for {what}")
        time.sleep(poll)
    raise TimeoutError(f"{what} did not come within {timeout:.0f}s")


def child_pid(run_dir: str, not_pid=None):
    """The training child's pid from its heartbeat (the supervisor's watchdog
    reads the same file)."""
    try:
        with open(os.path.join(run_dir, "heartbeat.json")) as f:
            pid = int(json.load(f)["pid"])
    except (OSError, ValueError, KeyError):
        return None
    return pid if pid != not_pid else None


def span_windows(trace_path: str) -> dict:
    """step -> the span seconds of that window by goodput component, walking
    trace.json in record order (a ``step_window`` marker closes a window,
    ``goodput_flush`` drops what came before the first)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out, acc = {}, {}
    for e in events:
        if e.get("ph") == "X":
            comp = e["name"] + "_s"
            acc[comp] = acc.get(comp, 0.0) + e["args"]["seconds"]
        elif e.get("ph") == "i" and e["name"] in ("step_window", "goodput_flush"):
            if e["name"] == "step_window":
                out[e["args"]["step"]] = acc
            acc = {}
    return out


def telemetry_phase(torch, card, moe_perf, steps: int = 30, warmup: int = 10,
                    device: str = "cuda"):
    """moe-8x40m as phase 6 (its config, seed and corpus, written as JSON),
    trained through the port's trainer CLI with ``--auto-resume``: the
    supervisor runs it in a child process. Spans, events, a metrics port
    and a profile window (steps 16-19) are on; checkpoints every 10 steps.
    The child is SIGKILLed once step 10's manifest lands, and SIGSTOPped
    (a hang: only the watchdog's SIGKILL ends it) once step 20's does."""
    import signal
    import tempfile

    from mlx_cuda_distributed_pretraining_tpu_torch.obs.events import (
        events_path,
        iter_events,
        tally,
    )

    failures = []
    t_phase = time.perf_counter()
    tmp_obj = tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build"))
    tmp = tmp_obj.name
    write_corpus(tmp, train_bytes=1_100_000, val_bytes=70_000)  # phase 6's corpus
    cfg = config_moe(tmp, steps, warmup)
    port = free_port()
    cfg["logging"]["steps"]["checkpoint_interval"] = 10
    cfg["logging"].update(
        trace={"enabled": True}, events={"max_bytes": 1 << 24}, metrics_port=port,
        profile_start=TELEMETRY_PROFILE[0], profile_stop=TELEMETRY_PROFILE[1],
        profile_report={"enabled": True, "top_k": 64}, retention={"keep_last": 2})
    # Blocking interval saves: the manifest lands at its step, so the faults
    # land where they are meant to. (The interval changes no loss.)
    cfg["system"]["async_checkpointing"] = False
    cfg["supervisor"] = {"hang_timeout_s": TELEMETRY_HANG_S, "hang_kill_grace_s": 5.0}
    # the supervisor's --scope collector: a scrape of the child every second
    cfg["scope"] = {"interval_s": 1.0, "scrape_timeout_s": 2.0}
    cfg_path = os.path.join(tmp, "moe_telemetry.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    runs = os.path.join(tmp, "runs")
    run_dir = os.path.join(runs, "moe-telemetry")
    ckdir = os.path.join(run_dir, "checkpoints")
    out_path, err_path = os.path.join(tmp, "sup.out"), os.path.join(tmp, "sup.err")
    cmd = [sys.executable, "-m", "mlx_cuda_distributed_pretraining_tpu_torch.train.trainer",
           "--config", cfg_path, "--runs-root", runs, "--run-name", "moe-telemetry",
           "--device", device, "--auto-resume", "--backoff-base", "1", "--backoff-max", "2",
           "--scope"]
    env = {**os.environ, "PYTHONPATH": REPO}
    with open(out_path, "w") as out_f, open(err_path, "w") as err_f:
        sup = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=out_f, stderr=err_f,
                               start_new_session=True)
    scrape, faults = "", {}
    try:
        wait_for(lambda: os.path.isfile(os.path.join(ckdir, "step_10.manifest.json")),
                 300, "step 10's manifest", sup)
        pid1 = wait_for(lambda: child_pid(run_dir), 30, "the child's heartbeat", sup)
        os.kill(pid1, signal.SIGKILL)
        faults["sigkill"] = {"pid": pid1, "t": time.time()}
        log(f"telemetry: step 10's manifest landed; SIGKILLed child {pid1}")
        wait_for(lambda: os.path.isfile(os.path.join(ckdir, "step_20.manifest.json")),
                 300, "step 20's manifest", sup)
        pid2 = wait_for(lambda: child_pid(run_dir, not_pid=pid1), 30,
                        "the restarted child's heartbeat", sup)
        # a live scrape of the restarted child's exposition
        _, raw = get_url(f"http://127.0.0.1:{port}/metrics", timeout=30)
        scrape = raw.decode()
        os.kill(pid2, signal.SIGSTOP)
        faults["sigstop"] = {"pid": pid2, "t": time.time()}
        log(f"telemetry: step 20's manifest landed; scraped :{port}/metrics "
            f"({len(scrape)} bytes); SIGSTOPped child {pid2}")
        rc = sup.wait(timeout=400)
    except Exception as e:  # noqa: BLE001 - reported as a failure
        failures.append(f"telemetry: {type(e).__name__}: {e}")
        rc = None
    finally:
        try:  # the supervisor's group holds every child, a stopped one too
            os.killpg(sup.pid, signal.SIGKILL)
        except OSError:
            pass
        sup.wait(timeout=30)
    phase_s = time.perf_counter() - t_phase
    err = open(err_path).read()
    done = [ln for ln in err.splitlines() if "supervisor: done:" in ln]
    log(f"telemetry: supervisor exit {rc} after {phase_s:.1f}s; {done[-1:] or err[-2000:]}")
    if rc != 0 or not done or "restarts 2, hangs 1" not in done[-1]:
        failures.append(f"telemetry: the supervised run did not end with exit 0, "
                        f"2 restarts and 1 hang (exit {rc}; {done[-1:]}): {err[-3000:]}")
        tmp_obj.cleanup()
        return failures, {"seconds": phase_s}

    evs = list(iter_events(events_path(run_dir)))
    counts = tally(events_path(run_dir))
    restarts = [e for e in evs if e["type"] == "restart"]
    hangs = [e for e in evs if e["type"] == "fault" and e.get("kind") == "hang"]
    resumes = [e["step"] for e in evs if e["type"] == "resume"]
    run_end = [e for e in evs if e["type"] == "run_end"]
    lost = [e.get("lost_s") for e in restarts]
    log(f"telemetry: events {int(counts['events'])}, restarts {counts['restarts']:g}, "
        f"faults {counts['faults']:g}; restart lost_s {lost}; resumes at {resumes}; "
        f"run_end at {[e['step'] for e in run_end]}")
    if len(restarts) != 2 or not all((x or 0) > 0 for x in lost) or len(hangs) != 1 \
            or resumes != [10, 20] or [e["step"] for e in run_end] != [steps]:
        failures.append(f"telemetry: events: restarts {restarts}, hang faults {hangs}, "
                        f"resumes {resumes}, run_end {run_end}")

    # losses: every logged one is phase 6's at that step
    want = {int(k): v for k, v in moe_perf.get("losses_by_step", {}).items()}
    logged = []  # (step, loss) of every step_window, the restarts' repeats too
    for e in evs:
        if e["type"] == "step_window":
            logged.append((e["step"], e["loss"]))
    rel = [abs(x - want[s]) / abs(want[s]) for s, x in logged if s in want]
    six = all(x == round(want[s], 6) for s, x in logged if s in want)
    max_rel = max(rel) if rel else float("nan")
    log(f"telemetry: {len(logged)} logged losses vs phase 6's: max relative difference "
        f"{max_rel:.3g}; equal to phase 6's at the 6 decimals the events keep: {six}")
    if not rel or {s for s, _ in logged} != set(want) or not max_rel <= 1e-5:
        failures.append(f"telemetry: losses {logged} differ from phase 6's {want}")

    # the live scrape
    lines = scrape.splitlines()
    step_val = next((float(ln.split()[1]) for ln in lines if ln.startswith("train_step ")), 0)
    need = ["train_tokens_total ", 'goodput_seconds_total{component="dispatch_s"}',
            'goodput_seconds_total{component="data_wait_s"}', "moe_balance_entropy ",
            'moe_expert_load_frac{expert="0"}', "moe_dropped_tokens_total ",
            "input_batches_total ", "input_data_wait_seconds_count ",
            "input_h2d_seconds_count ", 'checkpoint_writes_total{mode="blocking"}']
    missing = [n for n in need if not any(ln.startswith(n) for ln in lines)]
    log(f"telemetry: scrape train_step={step_val:g}; missing {missing}")
    if not step_val > 0 or missing:
        failures.append(f"telemetry: the scrape lacks {missing} (train_step {step_val})")

    # the profile window: a torch.profiler trace, the attribution, the kernels
    traces = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(run_dir, "profile"))
              for f in fs if f.endswith(".trace.json")]
    prof = {}
    try:
        with open(os.path.join(run_dir, "prof_summary.json")) as f:
            prof = json.load(f)
    except (OSError, ValueError) as e:
        failures.append(f"telemetry: no prof_summary.json ({e})")
    agg = prof.get("aggregate", {})
    fsum = sum(agg.get(k, 0.0) for k in ("compute_frac", "comm_frac", "host_frac",
                                          "idle_frac"))
    n_prof = TELEMETRY_PROFILE[1] - TELEMETRY_PROFILE[0]
    layers, vb, n = moe_perf.get("layers"), moe_perf.get("validation_batches"), \
        moe_perf.get("steps")
    l6 = moe_perf.get("launches", {})
    per_step = {}
    if layers and n:  # phase 6's counters less its validation batches' launches
        per_step = {"gmm": (l6.get("gmm", 0) - 3 * layers * vb) / n,
                    "tgmm": l6.get("tgmm", 0) / n,
                    "flash_fwd": (l6.get("flash_fwd", 0) - layers * vb) / n,
                    "flash_bwd_dq": l6.get("flash_bwd_dq", 0) / n,
                    "flash_bwd_dkv": l6.get("flash_bwd_dkv", 0) / n}
    ops = {o["op"]: o for o in prof.get("ops", [])}
    seen = {k: ops.get(name, {}).get("count") for k, name in PROFILED_KERNELS.items()}
    want_counts = {k: n_prof * v for k, v in per_step.items()}
    log(f"telemetry: profile {traces}; steps {[s['step'] for s in prof.get('steps', [])]}; "
        f"compute {agg.get('compute_frac')} host {agg.get('host_frac')} idle "
        f"{agg.get('idle_frac')} (sum {fsum!r}); kernels in the op table {seen} vs "
        f"{n_prof} x phase 6's per step {want_counts}")
    for o in prof.get("ops", [])[:12]:
        log(f"telemetry: op {o['op'][:60]} family={o['family']} count={o['count']} "
            f"total_ms={o['total_s'] * 1e3:.3f}")
    if not traces or abs(fsum - 1.0) > 1e-6 or \
            [s["step"] for s in prof.get("steps", [])] != list(range(*TELEMETRY_PROFILE)):
        failures.append(f"telemetry: profile window: traces {traces}, steps "
                        f"{[s['step'] for s in prof.get('steps', [])]}, fractions sum {fsum}")
    if not per_step or seen != want_counts:
        failures.append(f"telemetry: profiled kernel launches {seen} != {want_counts}")
    windows = {}
    for e in evs:  # the last record of each window
        if e["type"] == "step_window":
            windows[e["step"]] = e
    prof_windows = [s for s, e in windows.items() if "prof_compute_frac" in e]
    if not prof_windows or min(prof_windows) != TELEMETRY_PROFILE[1]:
        failures.append(f"telemetry: prof_* fields in windows {prof_windows}")

    # the spans of each window in trace.json (the last child's) against its goodput
    worst, checked = 0.0, 0
    try:
        spans = span_windows(os.path.join(run_dir, "trace.json"))
    except (OSError, ValueError, KeyError) as e:
        spans = {}
        failures.append(f"telemetry: trace.json unreadable ({e})")
    for s, acc in spans.items():
        gp = windows[s]["goodput"]
        for comp, secs in gp.items():
            if comp == "other_s":
                continue
            worst = max(worst, abs(acc.get(comp, 0.0) - secs))
            checked += 1
    log(f"telemetry: trace.json windows {sorted(spans)}: span sums vs goodput, worst "
        f"|difference| {worst:.3g}s over {checked} fields")
    if not spans or worst > 1e-6:
        failures.append(f"telemetry: span sums differ from the goodput fields by {worst}s")

    # steady state: windows with no compile, save, eval or profiled step
    steady = [e for s, e in sorted(windows.items())
              if not any(e["goodput"].get(k, 0) > 0 for k in ("compile_s", "ckpt_save_s",
                                                              "eval_s"))
              and not (s > TELEMETRY_PROFILE[0] and s - e["steps"] < TELEMETRY_PROFILE[1])]
    for s, e in sorted(windows.items()):
        log(f"telemetry: window {s}: {e['steps']} steps, "
            + ", ".join(f"{k}={v:.4f}" for k, v in e["goodput"].items() if v))
    secs = sum(sum(e["goodput"].values()) for e in steady)
    nsteps = sum(e["steps"] for e in steady)
    # the --scope collector's TSDB (configs/alerts.yaml's rules, read
    # without PyYAML where the host has none) holds the trainer's step
    from mlx_cuda_distributed_pretraining_tpu_torch.obs.tsdb import TSDB, parse_series_key

    db = TSDB(os.path.join(run_dir, "scope_tsdb"))
    step_keys = db.select("train_step", {"instance": "trainer0"})
    scoped = [v for k in step_keys for _, v in db.query("train_step", parse_series_key(k)[1])]
    log(f"telemetry: the --scope collector kept {len(db.keys())} series; train_step "
        f"{len(scoped)} samples, last {scoped[-1] if scoped else None}")
    if not scoped:
        failures.append(f"telemetry: the --scope collector's TSDB holds no train_step "
                        f"sample of the trainer ({len(db.keys())} series)")
    perf = {"seconds": phase_s, "restart_lost_s": lost, "faults": faults,
            "scope_train_step_samples": len(scoped),
            "steady_windows": [e["step"] for e in steady],
            "step_ms": 1e3 * secs / nsteps if nsteps else None,
            "tok_s": sum(e["toks"] for e in steady) / secs if secs else None,
            "phase6_step_ms": moe_perf.get("step_ms"), "phase6_tok_s": moe_perf.get("tok_s"),
            "max_rel_loss_diff": max_rel, "losses_equal_at_6_decimals": six,
            "profiled_kernel_launches": seen, "prof_fields": {
                k: windows[TELEMETRY_PROFILE[1]].get(k) for k in (
                    "prof_compute_frac", "prof_comm_frac", "prof_overlap_frac",
                    "prof_idle_frac")} if TELEMETRY_PROFILE[1] in windows else None,
            "span_goodput_worst_s": worst}
    log(f"telemetry: the phase took {phase_s:.1f}s; restart lost_s {lost} [{card}]")
    log(f"telemetry: steady step_ms={perf['step_ms']} tok_s={perf['tok_s']} over windows "
        f"{perf['steady_windows']}; phase 6 step_ms={perf['phase6_step_ms']} "
        f"tok_s={perf['phase6_tok_s']} [{card}]")
    tmp_obj.cleanup()
    return failures, perf


# -- phase 6b: MoE training at matmul_precision int8 ---------------------------------
def int8_plain_kernel(kernel_check):
    """The plain stand-in for ``gm.gmm_int8_kernel`` in a parity run."""
    def plain(xq, sx, wq, sw, gs, block_t, dtype, with_products=False):
        acc, out = kernel_check.gmm_int8_plain_outputs(xq, sx, wq, sw, gs, block_t, dtype)
        return (out, acc) if with_products else out
    return plain


def int8_train_phase(torch, gm, fa, kernel_check, card, moe_perf, steps: int = 10,
                     warmup: int = 2):
    """moe-8x40m at full width with ``model.matmul_precision: int8`` (bf16
    over fp32 masters, batch 32, S 1024): step 1 at batch 8 with the
    gmm_int8, gmm and tgmm kernels against their plain versions (the flash
    kernels in both) under the MoE phase's limits; ``steps`` steps through
    ``Trainer.train()`` with a log line every 2, the last logged loss below
    the first; launches: gmm_int8 3 per layer per step and validation
    batch, the dX gmm on wgmma and the dW tgmm on "f32" 3 per layer per
    step, the flash kernels (on int8-gridded q/k/v) as the bf16 path's."""
    import tempfile

    from mlx_cuda_distributed_pretraining_tpu_torch.config import Config
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer

    failures = []
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        write_corpus(tmp, train_bytes=1_100_000, val_bytes=70_000)
        cfg = config_moe(tmp, steps, warmup)
        cfg["name"] = "Llama-MoE (8x40M) int8"
        cfg["model"]["matmul_precision"] = "int8"
        cfg["logging"]["steps"]["logging_interval"] = 2
        log(f"int8: reduced: training.hyperparameters.iters {steps} (config 10000), "
            f"scheduler.warmup_steps {warmup} (config 500), system.mesh dropped "
            "({dp: -1, ep: 4} needs four devices)")
        trainer = Trainer(Config.from_dict(cfg), runs_root=os.path.join(tmp, "runs"),
                          quiet=True, device="cuda")
        par = first_step_parity(torch, trainer, 8, [
            (gm, "gmm_int8_kernel", int8_plain_kernel(kernel_check)),
            (gm, "_gmm_forward", lambda x, w, gs, bt, w_trans=False: gm.gmm_plain(
                x, w.transpose(1, 2) if w_trans else w, gs, bt)),
            (gm, "tgmm", gm.tgmm_plain)])
        log(f"int8: step-1 parity at batch 8, gmm_int8/gmm/tgmm kernels vs plain: {par}")
        if not parity_ok(par):
            failures.append(f"int8: step-1 loss/gradients disagree with plain: {par}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(gm, fa)
        t0 = time.perf_counter()
        result = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**read_launches(gm, fa), "gmm_int8": gm.gmm_int8.launches}
        variants = read_variants(gm, fa)
        int8_variants = dict(gm.gmm_int8.launches_by_variant)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        windows = trainer.windows
        losses = [w["loss"] for w in windows]
        layers, vb = trainer.model_args.num_layers, trainer.eval_batches
        want = {"gmm_int8": 3 * layers * (steps + vb), "gmm": 3 * layers * steps,
                "tgmm": 3 * layers * steps, "flash_fwd": layers * (steps + vb),
                "flash_bwd_dq": layers * steps, "flash_bwd_dkv": layers * steps}
        log(f"int8: {steps} steps + {vb} validation batches in {wall:.1f}s; losses "
            f"every 2 steps {losses}; final val_loss={result['final_val_loss']}; "
            f"launches {launches}; by variant {variants}")
        if not all(math.isfinite(x) for x in losses) or not losses \
                or not losses[-1] < losses[0]:
            failures.append(f"int8: the logged loss did not fall: {losses}")
        if launches != want:
            failures.append(f"int8: launches {launches} != {want}")
        want_variants = {"gmm": {**dict.fromkeys(gm.GMM_VARIANTS, 0), "wgmma": want["gmm"]},
                         "tgmm": {**dict.fromkeys(gm.TGMM_VARIANTS, 0), "f32": want["tgmm"]},
                         **flash_variants_want(fa, want["flash_fwd"], want["flash_bwd_dq"])}
        if variants != want_variants:
            failures.append(f"int8: launches by variant {variants} != {want_variants}")
        want_int8 = {**dict.fromkeys(gm.GMM_INT8_VARIANTS, 0), "wgmma": want["gmm_int8"]}
        log(f"int8: gmm_int8 launches by variant {int8_variants}")
        if int8_variants != want_int8:
            failures.append(f"int8: gmm_int8 launches by variant {int8_variants} != {want_int8}")
        flops_per_token = trainer.flops_per_token
        del trainer
    torch.cuda.empty_cache()
    steady = windows[1:]
    secs = sum(w["seconds"] for w in steady)
    tok_s = sum(w["toks"] for w in steady) / secs
    perf = {"step_ms": 1e3 * secs / sum(w["steps"] for w in steady), "tok_s": tok_s,
            "mfu_active_vs_989tflops": tok_s * flops_per_token / PEAK_FLOPS["bfloat16"],
            "peak_mem_gb": peak_gb, "losses": losses, "launches": launches,
            "launches_by_variant": variants, "gmm_int8_launches_by_variant": int8_variants,
            "first_step_parity": par,
            "bf16_moe_step_ms": moe_perf.get("step_ms"),
            "bf16_moe_tok_s": moe_perf.get("tok_s"),
            "bf16_moe_peak_mem_gb": moe_perf.get("peak_mem_gb")}
    for k in ("step_ms", "tok_s", "peak_mem_gb", "bf16_moe_step_ms", "bf16_moe_tok_s",
              "bf16_moe_peak_mem_gb"):
        log(f"int8: {k}={perf[k]} [{card}]")
    return failures, perf


# -- phase 7: the 1B single-chip trainer, preempted and resumed -------------------
STEPS_1B = 16
DEPTH_1B = 4  # of the config's 16: the whole smoke's time limit


def config_1b(tmp: str, steps: int = STEPS_1B) -> dict:
    """configs/model-config-1b-singlechip.yaml written out as a dict, with
    the smoke's cuts: ``iters`` 16 (of 20,000), ``warmup_steps`` 2 (of
    2,000: the same tenth), a log line every step (of 20), a checkpoint
    every 8 steps (of 1,000), 4 of its 16 layers (the whole smoke's time
    limit), and the corpus paths. Every width and switch
    is the config's: flash attention, remat "full", scan_layers, Adafactor,
    async checkpoints; validation (every 500) runs once, at the end."""
    return {
        "name": "Llama-1B-singlechip", "overwrite": True,
        "data": {"input_file": os.path.join(tmp, "train.jsonl"),
                 "validation_file": os.path.join(tmp, "val.jsonl"),
                 "tokenizer_path": "tokenizer",
                 "preprocessing": {"max_context_size": 2048, "chunk_overlap": 128},
                 "tokenizer": {"normal_vocab_size": 256, "special_tokens": {
                     "pad": "<pad>", "bos": "<bos>", "eos": "<eos>"}}},
        "model": {"architecture": "llama",
                  "dimensions": {"hidden_size": 2048, "intermediate_size": 5632,
                                 "num_layers": DEPTH_1B},
                  "attention": {"num_heads": 16, "num_kv_heads": 16, "head_dim": 128,
                                "max_position_embeddings": 2048,
                                "attention_type": "flash"},
                  "normalization": {"rms_norm_eps": 1.0e-5},
                  "rope": {"theta": 10000},
                  "misc": {"attention_bias": False, "mlp_bias": False,
                           "tie_word_embeddings": True}},
        "training": {"hyperparameters": {"batch_size": 8, "learning_rate": 1.0e-2,
                                         "weight_decay": 0.0, "gradient_clip": 1.0,
                                         "iters": steps},
                     "scheduler": {"type": "cosine_with_warmup", "min_lr_ratio": 0.1,
                                   "warmup_steps": 2},
                     "optimization": {"optimizer": "adafactor",
                                      "clipping_threshold": 1.0}},
        "logging": {"steps": {"logging_interval": 1, "checkpoint_interval": 8,
                              "validation_interval": 500}},
        "system": {"seed": 42, "compute_dtype": "bfloat16", "remat": "full",
                   "scan_layers": True, "async_checkpointing": True},
    }


def fused_ce_parity(torch, trainer) -> dict:
    """Step 1's loss and gradient norm on the first batch with the fused CE
    (2048-row chunks) and with the plain CE, the rest of the step as the
    trainer runs it."""
    from mlx_cuda_distributed_pretraining_tpu_torch.optim.base import global_norm
    from mlx_cuda_distributed_pretraining_tpu_torch.train.train_step import make_loss_fn
    from mlx_cuda_distributed_pretraining_tpu_torch.utils.tree import leaves_with_path

    batch = trainer._device_batch(trainer.data.generate_batch(0))
    params = trainer.state["params"]
    out = {}
    for chunk in (2048, 0):
        loss_fn = make_loss_fn(trainer.model_args, trainer.compute_dtype,
                               remat=trainer.remat, remat_ratio=trainer.remat_ratio,
                               ce_chunk=chunk)
        loss, _ = loss_fn(params, batch)
        loss.backward()
        grads = [p.grad for _, p in leaves_with_path(params)]
        out[chunk] = (loss.item(), global_norm(grads).item())
        for _, p in leaves_with_path(params):
            p.grad = None
    (lf, gf), (lp, gp) = out[2048], out[0]
    return {"loss_fused": lf, "loss_plain": lp, "loss_rel": abs(lf - lp) / abs(lp),
            "grad_norm_fused": gf, "grad_norm_plain": gp,
            "grad_norm_rel": abs(gf - gp) / gp}


def wait_for_step(proc, log_path: str, step: int, timeout: float):
    """The newest step in a trainer's log.txt once it reaches ``step``;
    None if the process ends first or the time runs out."""
    import re

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and proc.poll() is None:
        if os.path.isfile(log_path):
            with open(log_path) as f:
                steps = [int(m.group(1)) for m in re.finditer(r"^Step (\d+): ", f.read(),
                                                             re.MULTILINE)]
            if steps and max(steps) >= step:
                return max(steps)
        time.sleep(0.05)
    return None


def train_1b_phase(torch, gm, fa, card):
    """Run A: 16 steps in this process. A side run: 2 steps with remat
    "none", for its peak memory. Run B: the trainer CLI in a subprocess,
    SIGTERM once its log shows step 4. Run C: resumes B from "latest" to
    step 16 in this process; its losses must be A's."""
    import re
    import shutil
    import signal
    import tempfile

    from mlx_cuda_distributed_pretraining_tpu_torch.checkpoint.manager import (
        CheckpointManager,
    )
    from mlx_cuda_distributed_pretraining_tpu_torch.config import Config
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer

    failures, steps = [], STEPS_1B
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        t0 = time.perf_counter()
        write_corpus(tmp, train_bytes=600_000, val_bytes=70_000)
        cfg = config_1b(tmp)
        a = Trainer(Config.from_dict(cfg), runs_root=os.path.join(tmp, "runs_a"),
                    quiet=True, device="cuda")
        layers = a.model_args.num_layers
        n_remat = int(round(layers * a.remat_ratio))
        log(f"1b: {a.n_params / 1e6:.2f}M params, {a.flops_per_token / 1e9:.3f} GFLOP "
            f"per token, remat {a.remat} on {n_remat} of {layers} layers, "
            f"{len(a.data.train_rows)} train rows of {a.data.seq_len + 1} tokens, "
            f"{time.perf_counter() - t0:.1f}s to set up; "
            f"{shutil.disk_usage(tmp).free / 1e9:.0f} GB free on disk")

        ce = fused_ce_parity(torch, a)
        log(f"1b: step 1, fused CE (2048-row chunks) vs plain: {ce}")
        if not (ce["loss_rel"] <= 1e-5 and ce["grad_norm_rel"] <= 1e-4):
            failures.append(f"1b: fused CE disagrees with the plain CE: {ce}")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(gm, fa)  # count from here: run A only
        t0 = time.perf_counter()
        result = a.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, variants = read_launches(gm, fa), read_variants(gm, fa)
        peak_full = torch.cuda.max_memory_allocated() / 1e9
        windows = list(a.windows)
        losses_a = {w["step"]: w["loss"] for w in windows}
        vb = a.eval_batches
        # forward: every layer each step and validation batch, and the remat'd
        # layers once more in each backward
        want = {"flash_fwd": (layers + n_remat) * steps + layers * vb,
                "flash_bwd_dq": layers * steps, "flash_bwd_dkv": layers * steps,
                "gmm": 0, "tgmm": 0}
        log(f"1b: run A, {steps} steps + {vb} validation batches in {wall:.1f}s; "
            f"losses {[round(x, 5) for x in losses_a.values()]}; final val_loss="
            f"{result['final_val_loss']}; launches {launches}")
        if sorted(losses_a) != list(range(1, steps + 1)) \
                or not all(math.isfinite(x) for x in losses_a.values()):
            failures.append(f"1b: bad loss log {losses_a}")
        if launches != want:
            failures.append(f"1b: launches {launches} != {want}")
        flash_variants = {n: variants[n] for n in FLASH_KERNELS}
        if flash_variants != flash_variants_want(fa, want["flash_fwd"],
                                                 want["flash_bwd_dq"]):
            failures.append(f"1b: flash launches by variant {flash_variants}")
        saved_a = a.checkpoints.manifested_steps()
        bad = {t: a.checkpoints.verify(t) for t in saved_a}
        log(f"1b: run A checkpoints {bad}")
        if set(saved_a) != {"8", "16", "final"} or not all(ok for ok, _ in bad.values()):
            failures.append(f"1b: run A checkpoints {bad}")
        flops_per_token = a.flops_per_token
        shutil.rmtree(a.run_dir)
        del a
        torch.cuda.empty_cache()

        # The side run: remat "none", two steps, for the peak memory remat saves.
        side = dict(cfg, system=dict(cfg["system"], remat="none"))
        n = Trainer(Config.from_dict(side), runs_root=os.path.join(tmp, "runs_none"),
                    quiet=True, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        none_ms = []
        for i in range(2):
            t = time.perf_counter()
            n.state, _ = n.train_step(n.state, n._device_batch(n.data.generate_batch(i)))
            torch.cuda.synchronize()
            none_ms.append(1e3 * (time.perf_counter() - t))
        peak_none = torch.cuda.max_memory_allocated() / 1e9
        del n
        torch.cuda.empty_cache()
        log(f"1b: peak memory, remat full (run A) {peak_full:.3f} GB, remat none "
            f"(2 steps) {peak_none:.3f} GB; remat none step ms {none_ms} [{card}]")

        # Run B: the trainer CLI, preempted with SIGTERM at step 4 or later.
        runs_bc = os.path.join(tmp, "runs_bc")
        cfg_path = os.path.join(tmp, "1b.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        b_log = os.path.join(runs_bc, cfg["name"], "log.txt")
        with open(os.path.join(tmp, "run_b.out"), "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "mlx_cuda_distributed_pretraining_tpu_torch.train.trainer",
                 "--config", cfg_path, "--runs-root", runs_bc],
                cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), stdout=out,
                stderr=subprocess.STDOUT)
            try:
                seen = wait_for_step(proc, b_log, 4, timeout=600)
                if seen is not None:
                    proc.send_signal(signal.SIGTERM)
                rc = proc.wait(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        b_text = open(b_log).read() if os.path.isfile(b_log) else ""
        m = re.search(r"Preemption signal received: saving checkpoint at step (\d+)", b_text)
        b_step = int(m.group(1)) if m else None
        mgr = CheckpointManager(os.path.join(runs_bc, cfg["name"]))
        b_ckpts = {t: mgr.verify(t) for t in mgr.manifested_steps()}
        log(f"1b: run B signalled at step {seen}, exit {rc}, saved step {b_step}; "
            f"checkpoints {b_ckpts}")
        if rc != 0 or b_step is None or seen is None:
            tail = open(os.path.join(tmp, "run_b.out")).read()[-3000:]
            failures.append(f"1b: run B was not preempted cleanly (signalled at "
                            f"{seen}, exit {rc}, saved {b_step}): {tail}")
        elif not (b_ckpts.get(str(b_step), (False,))[0] and all(
                ok for ok, _ in b_ckpts.values())):
            failures.append(f"1b: run B's checkpoints do not verify: {b_ckpts}")

        # Run C: resume B from "latest" to step 16.
        resume = dict(cfg, overwrite=False, resume={"checkpoint": "latest"})
        c = Trainer(Config.from_dict(resume), runs_root=runs_bc, quiet=True, device="cuda")
        start = c.start_step
        c.train()
        torch.cuda.synchronize()
        losses_c = {w["step"]: w["loss"] for w in c.windows}
        c_text = open(os.path.join(c.run_dir, "log.txt")).read()
        run_dir = c.run_dir
        del c
        torch.cuda.empty_cache()
        rel = {s: abs(x - losses_a[s]) / abs(losses_a[s]) for s, x in losses_c.items()
               if s in losses_a}
        max_rel = max(rel.values()) if rel else float("nan")
        bitwise = bool(rel) and all(losses_c[s] == losses_a[s] for s in rel)
        log(f"1b: run C started at step {start}, ran steps {sorted(losses_c)}; losses "
            f"vs run A: max relative difference {max_rel:.3g}, bitwise {bitwise}")
        if b_step is None or start != b_step or \
                sorted(losses_c) != list(range(b_step + 1, steps + 1)):
            failures.append(f"1b: run C did not resume at B's step {b_step} "
                            f"(start {start}, steps {sorted(losses_c)})")
        if "Resumed from checkpoint" not in c_text:
            failures.append("1b: run C's log.txt lacks 'Resumed from checkpoint'")
        if not max_rel <= 1e-5:
            failures.append(f"1b: resumed losses differ from run A's: {rel}")

        code, out = serve_run(torch, run_dir, torch.device("cuda"), "1b-smoke")
        log(f"1b: final checkpoint served: HTTP {code} tokens={out.get('tokens')} "
            f"text={out.get('text', '')[:40]!r}")
        if code != 200 or not out.get("tokens"):
            failures.append(f"1b: serving the final checkpoint: HTTP {code} {out}")
    torch.cuda.empty_cache()

    steady = windows[1:]  # the first window holds the first step's warm-up
    secs = sum(w["seconds"] for w in steady)
    tok_s = sum(w["toks"] for w in steady) / secs
    perf = {"step_ms": 1e3 * secs / sum(w["steps"] for w in steady), "tok_s": tok_s,
            # the recompute of the remat'd layers is not counted
            "mfu_vs_989tflops": tok_s * flops_per_token / PEAK_FLOPS["bfloat16"],
            "flops_per_token": flops_per_token, "peak_mem_gb_remat_full": peak_full,
            "peak_mem_gb_remat_none": peak_none, "remat_none_step_ms": none_ms,
            "first_window_s": windows[0]["seconds"], "losses": losses_a,
            "launches": launches, "launches_by_variant": flash_variants,
            "fused_ce_parity": ce, "resume": {
                "preempted_at_step": b_step, "resumed_at_step": start,
                "max_rel_loss_diff": max_rel, "bitwise": bitwise}}
    for k in ("step_ms", "tok_s", "mfu_vs_989tflops", "peak_mem_gb_remat_full",
              "peak_mem_gb_remat_none"):
        log(f"1b: {k}={perf[k]} [{card}]")
    return failures, perf


# -- phase 7b: 1b-fsdp through the launcher, one NCCL rank --------------------------
STEPS_FSDP, CKPT_FSDP = 20, 10
BATCH_FSDP = 32
DEPTH_FSDP = 4  # of the config's 16: the whole smoke's time limit
PROFILE_FSDP = (3, 4)  # the torch.profiler window of run A: step 3
TWO_RANK_LAYERS = 2    # the depth of the two-ranks-on-one-card run


def config_1b_fsdp(tmp: str, steps: int = STEPS_FSDP, batch: int = BATCH_FSDP) -> dict:
    """configs/model-config-1b-fsdp.yaml written out as a dict, with the
    smoke's cuts: ``iters`` 20 (of 20,000), ``warmup_steps`` 2 (of 2,000),
    a log line every step (of 10) with the gradient norm, a checkpoint every
    10 steps (of 1,000), no metrics port (9100), no validation split (its
    every-500 never comes), 4 of its 16 layers (the whole smoke's time
    limit: at 16 the step peaked at 78.06 GB and the phase took 316 s on
    an H100 80GB HBM3 at 700 W), a torch.profiler window over step 3 whose op table keeps every
    kernel, and the corpus path. Every width and switch is the config's:
    batch 32, flash attention,
    remat "save_attn" (over ``system.remat``) on the first half of the
    layers, AdamW (0.9/0.95, weight decay 0.1, clip 1.0, lr 3e-4),
    ZeRO-1, ``overlap_gather``, ``scan_layers`` and ``mesh: {fsdp: -1}``."""
    return {
        "name": "Llama-1B-fsdp", "overwrite": True,
        "data": {"input_file": os.path.join(tmp, "train.jsonl"),
                 "tokenizer_path": "tokenizer",
                 "preprocessing": {"max_context_size": 2048, "chunk_overlap": 128},
                 "tokenizer": {"normal_vocab_size": 256, "special_tokens": {
                     "pad": "<pad>", "bos": "<bos>", "eos": "<eos>"}}},
        "model": {"architecture": "llama",
                  "dimensions": {"hidden_size": 2048, "intermediate_size": 5632,
                                 "num_layers": DEPTH_FSDP},
                  "attention": {"num_heads": 16, "num_kv_heads": 16, "head_dim": 128,
                                "max_position_embeddings": 2048,
                                "use_flash_attention": True},
                  "normalization": {"rms_norm_eps": 1.0e-5},
                  "rope": {"theta": 10000, "traditional": False, "scaling": None},
                  "misc": {"attention_bias": False, "mlp_bias": False,
                           "tie_word_embeddings": True},
                  "remat_policy": "save_attn"},
        "training": {"hyperparameters": {"batch_size": batch, "learning_rate": 3.0e-4,
                                         "weight_decay": 0.1, "gradient_clip": 1.0,
                                         "iters": steps},
                     "scheduler": {"type": "cosine_with_warmup", "min_lr_ratio": 0.1,
                                   "warmup_steps": 2},
                     "optimization": {"optimizer": "adamw", "betas": [0.9, 0.95]}},
        "logging": {"steps": {"logging_interval": 1, "checkpoint_interval": CKPT_FSDP,
                              "validation_interval": 500},
                    "log_gradient_norm": True,
                    "profile_start": PROFILE_FSDP[0], "profile_stop": PROFILE_FSDP[1],
                    "profile_report": {"top_k": 1000}},
        "system": {"seed": 42, "mixed_precision": True, "precision": "bfloat16",
                   "gradient_checkpointing": True, "remat": "dots",
                   "zero_optimization_level": 1, "mesh": {"fsdp": -1},
                   "scan_layers": True, "overlap_gather": True},
    }


def read_events(run_dir: str) -> list:
    path = os.path.join(run_dir, "events.jsonl")
    if not os.path.isfile(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def child_run(cmd: list, out_path: str, timeout: float) -> int:
    """A child process of the smoke in a process group of its own, its output
    into ``out_path``; the group is killed when it ends or at ``timeout``
    (124). The children allocate with expandable segments: the
    1b-fsdp step peaks within 2 GB of the card's 80."""
    env = dict(os.environ, PYTHONPATH=REPO, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    with open(out_path, "w") as out:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            return proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return 124
        finally:
            kill_group(proc)  # a launcher's ranks too, should it have died first


def profiled_flash(label: str, run_dir: str, window, per_step: dict):
    """The chief's profile window of a launched run: ``(summary, seen,
    want, plain, traces, failures)``, the three bf16 flash kernels' counts in
    its op table against ``per_step`` a step times the window's steps, and
    the plain attention ops (einsum, bmm, SDPA) in its traces, which no
    flash path runs."""
    failures, prof = [], {}
    try:
        with open(os.path.join(run_dir, "prof_summary.json")) as f:
            prof = json.load(f)
    except (OSError, ValueError) as e:
        failures.append(f"{label}: no prof_summary.json ({e})")
    ops = {o["op"]: o for o in prof.get("ops", [])}
    seen = {k: ops.get(PROFILED_KERNELS[k], {}).get("count") for k in FLASH_KERNELS}
    want = {k: (window[1] - window[0]) * v for k, v in per_step.items()}
    traces = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(run_dir, "profile"))
              for f in fs if f.endswith(".trace.json")]
    plain = {}
    for path in traces:
        with open(path) as f:
            text = f.read()
        for op in ("aten::einsum", "aten::bmm", "aten::_scaled_dot_product"):
            if f'"{op}' in text:
                plain[op] = text.count(f'"{op}')
    if seen != want:
        failures.append(f"{label}: profiled flash kernels {seen} != {want}")
    if plain or not traces:
        failures.append(f"{label}: plain attention in the profile {plain} (traces {traces})")
    return prof, seen, want, plain, traces, failures


def launch_cmd(n: int, *args) -> list:
    """``parallel.launch`` starting ``n`` ranks on this machine."""
    return [sys.executable, "-m", "mlx_cuda_distributed_pretraining_tpu_torch.parallel.launch",
            "--nproc-per-node", str(n), *args]


def tail_of(path: str, n: int = 3000) -> str:
    with open(path) as f:
        return f.read()[-n:]


def two_ranks_on_one_card(tmp: str, card: str, device: str = "cuda") -> dict:
    """Two ranks on the one card: NCCL refuses two ranks on one device
    ("Duplicate GPU detected"); gloo forms the group and carries every
    collective of the path on CUDA tensors through the host. So step 1 of
    the {fsdp: 2} train step (``scripts/profile_torch_train.py --steps 0``
    at 1b-fsdp's widths, 2 layers, the same seeded weights and global
    batch) runs through the launcher with both ranks on ``cuda:0`` on gloo,
    held against the same script's step 1 on one rank (in this process)."""
    import gc
    import importlib.util

    args = ["--config", "1b-fsdp", "--layers", str(TWO_RANK_LAYERS), "--steps", "0"]
    out = {}
    path = os.path.join(tmp, "one_rank.json")
    t0 = time.perf_counter()
    spec = importlib.util.spec_from_file_location(
        "profile_torch_train", os.path.join(REPO, "scripts", "profile_torch_train.py"))
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    rc = prof.main(args + ["--out", path])
    gc.collect()
    if device == "cuda":
        import torch

        torch.cuda.empty_cache()
    row = {"rc": rc, "seconds": time.perf_counter() - t0}
    if rc == 0 and os.path.isfile(path):
        with open(path) as f:
            row.update(first_step=json.load(f).get("first_step"))
    out["one_rank"] = row
    path = os.path.join(tmp, "two_ranks_gloo.json")
    t0 = time.perf_counter()
    rc = child_run(launch_cmd(2, "--device", device, "--backend", "gloo", "--timeout-s", "240",
                              "--script", os.path.join(REPO, "scripts", "profile_torch_train.py"),
                              "--", *args, "--out", path),
                   os.path.join(tmp, "two_ranks_gloo.out"), timeout=300)
    row = {"rc": rc, "seconds": time.perf_counter() - t0}
    if rc == 0 and os.path.isfile(path):
        with open(path) as f:
            got = json.load(f)
        row.update(first_step=got.get("first_step"), mesh=got.get("mesh"),
                   ranks=got.get("ranks"))
    else:
        tail = tail_of(os.path.join(tmp, "two_ranks_gloo.out"), 6000)
        row["error"] = next((ln.strip()[:300] for ln in tail.splitlines()
                             if "Error" in ln), tail[-300:])
    out["two_ranks_gloo"] = row
    ref = (out["one_rank"].get("first_step") or {}).get("loss")
    got = (row.get("first_step") or {}).get("loss")
    if ref is not None and got is not None:
        row["loss_rel"] = abs(got - ref) / abs(ref)
    for label, r in out.items():
        log(f"fsdp: {label}: {r} [{card}]")
    return out


def fsdp_1b_phase(torch, gm, fa, card, device: str = "cuda"):
    """1b-fsdp at full width through ``parallel.launch``, one NCCL rank
    (``fsdp: -1`` resolves to 1). The one-device reference: the same
    config's trainer with no mesh, its step 1 in this process. Run A: 20
    steps with a checkpoint at step 10 and a profiler window over step 3.
    Run B: resumes A from step 10 to 20. Gates: A's step 1 (loss and gradient
    norm) within 1e-5 relative of the one-device step; B's losses A's
    within 1e-5; the loss falls; the profile holds the three bf16 flash
    kernels at the one-device step's count for every layer and no plain
    attention op; A's flash launches all on the wgmma kernels; the rank's
    sidecar and the chief's manifest at step 10. Then two ranks on the one
    card (:func:`two_ranks_on_one_card`): a backend that forms the group
    must give one rank's step-1 loss within 1e-5. ``device="cpu"`` (with a
    small ``config_1b_fsdp``) rehearses it on the CPU, where only the kernel
    gates fail."""
    import gc
    import shutil
    import tempfile

    from mlx_cuda_distributed_pretraining_tpu_torch.config import Config
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer

    failures, perf = [], {}
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    if device == "cuda":  # the children need the card's memory: this runs first
        torch.cuda.empty_cache()
        log(f"fsdp: this process holds {torch.cuda.memory_reserved() / 1e9:.3f} GB of "
            f"the card")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        write_corpus(tmp, train_bytes=600_000, val_bytes=70_000)
        cfg = config_1b_fsdp(tmp)
        layers = cfg["model"]["dimensions"]["num_layers"]

        # the one-device path: the same config's trainer with no mesh, its
        # step 1 in this process (which holds almost none of the card yet)
        single = dict(cfg, name="single",
                      system={k: v for k, v in cfg["system"].items() if k != "mesh"},
                      logging=dict(cfg["logging"], profile_start=0, profile_stop=0))
        t0 = time.perf_counter()
        t = Trainer(Config.from_dict(single), runs_root=os.path.join(tmp, "runs_single"),
                    quiet=True, device=device)
        if t.mesh is not None:
            failures.append(f"fsdp: the one-device trainer built a mesh {t.mesh}")
        reset_launches(gm, fa)
        t.state, m = t.train_step(t.state, t._device_batch(t.data.generate_batch(0)))
        single_step = {"loss": round(float(m["loss"]), 6), "grad_norm": float(m["grad_norm"])}
        per_step = {k: v for k, v in read_launches(gm, fa).items() if k in FLASH_KERNELS}
        t.events.close()
        t.logger.close()
        t.state = None
        del t, m
        gc.collect()  # the trainer's callbacks hold it in reference cycles
        if device == "cuda":
            torch.cuda.empty_cache()
            held = torch.cuda.memory_reserved() / 1e9
            log(f"fsdp: after it this process holds {held:.3f} GB of the card")
            # the children's step peaks at 78.1 GB of the card's 85.0
            if held > 4.0:
                failures.append(f"fsdp: the one-device step left {held:.3f} GB on the card")
                return failures, perf
        shutil.rmtree(os.path.join(tmp, "runs_single"), ignore_errors=True)
        log(f"fsdp: one-device trainer (no mesh), step 1 in {time.perf_counter() - t0:.1f}s: "
            f"{single_step}; flash launches a step {per_step}")

        # run A: the launcher, one NCCL rank, 20 steps, a checkpoint at 10
        runs = os.path.join(tmp, "runs")
        with open(os.path.join(tmp, "a.json"), "w") as f:
            json.dump(cfg, f)
        t0 = time.perf_counter()
        rc_a = child_run(launch_cmd(1, "--device", device, "--config",
                                    os.path.join(tmp, "a.json"), "--runs-root", runs),
                         os.path.join(tmp, "a.out"), 900)
        wall_a = time.perf_counter() - t0
        run_dir = os.path.join(runs, cfg["name"])
        events = read_events(run_dir)
        windows = [e for e in events if e.get("type") == "step_window"]
        losses_a = {e["step"]: e["loss"] for e in windows}
        norms_a = {e["step"]: e.get("grad_norm") for e in windows}
        run_end = next((e for e in events if e.get("type") == "run_end"), {})
        run_start = next((e for e in events if e.get("type") == "run_start"), {})
        a_out = tail_of(os.path.join(tmp, "a.out"), 10**7)
        log_a = (open(os.path.join(run_dir, "log.txt")).read()
                 if os.path.isfile(os.path.join(run_dir, "log.txt")) else "")
        log(f"fsdp: run A (launcher, 1 rank) exit {rc_a} in {wall_a:.1f}s; losses "
            f"{[round(losses_a[s], 5) for s in sorted(losses_a)]}; "
            f"{[ln.split('] ', 1)[-1] for ln in log_a.splitlines() if 'mesh ' in ln][:1]}")
        if rc_a != 0 or sorted(losses_a) != list(range(1, STEPS_FSDP + 1)) or \
                not all(math.isfinite(x) for x in losses_a.values()):
            failures.append(f"fsdp: run A exit {rc_a}, losses {losses_a}: {a_out[-3000:]}")
            return failures, perf
        if "mesh {'fsdp': 1} over 1 rank(s)" not in log_a or \
                "[launch] rank 0/1 backend nccl device cuda" not in a_out:
            failures.append("fsdp: run A did not train on a one-rank NCCL fsdp mesh")

        # gate: step 1 against the one-device trainer
        loss_rel = abs(losses_a[1] - single_step["loss"]) / abs(single_step["loss"])
        norm_rel = abs(norms_a[1] - single_step["grad_norm"]) / single_step["grad_norm"]
        bitwise = losses_a[1] == single_step["loss"] and norms_a[1] == single_step["grad_norm"]
        log(f"fsdp: step 1 vs the one-device trainer: loss {losses_a[1]} vs "
            f"{single_step['loss']} (rel {loss_rel:.3g}), grad_norm {norms_a[1]} vs "
            f"{single_step['grad_norm']} (rel {norm_rel:.3g}); bitwise {bitwise} (the "
            f"loss at the events' 6 decimals, the norm in full)")
        if not (loss_rel <= 1e-5 and norm_rel <= 1e-5):
            failures.append(f"fsdp: step 1 differs from the one-device trainer: loss rel "
                            f"{loss_rel}, grad_norm rel {norm_rel}")
        # gate: the loss falls
        if not losses_a[STEPS_FSDP] < 0.9 * losses_a[1]:
            failures.append(f"fsdp: the loss does not fall: {losses_a[1]} -> "
                            f"{losses_a[STEPS_FSDP]}")

        # gate: the profile window, every layer's attention on the flash kernels
        prof, seen, want, plain, traces, prof_failures = profiled_flash(
            "fsdp", run_dir, PROFILE_FSDP, per_step)
        failures += prof_failures
        comm = {o["op"]: o["count"] for o in prof.get("ops", [])
                if "nccl" in o["op"] or o.get("family") == "comm"}
        log(f"fsdp: profile steps {[st['step'] for st in prof.get('steps', [])]}: flash "
            f"kernels {seen} vs the one-device step's {want}; plain attention "
            f"ops in the trace: {plain or 'none'}; collectives in the table: {comm or 'none'}")
        launched = run_end.get("kernel_launches") or {}
        log(f"fsdp: run A's kernel launches (run_end) {launched}; peak device memory "
            f"{run_end.get('peak_device_mem_gb')} GB")
        if any(launched.get(f"{k}_by_variant", {}).get("f32", 0) for k in FLASH_KERNELS) or \
                launched.get("flash_bwd_dq") != per_step["flash_bwd_dq"] * STEPS_FSDP or \
                launched.get("flash_bwd_dkv") != per_step["flash_bwd_dkv"] * STEPS_FSDP:
            failures.append(f"fsdp: run A's flash launches {launched}")

        # gate: the rank's sidecar listed in the chief's manifest (run B's
        # resume verifies the step's sizes and CRCs)
        ckpt = os.path.join(run_dir, "checkpoints")
        manifest = {}
        manifest_path = os.path.join(ckpt, f"step_{CKPT_FSDP}.manifest.json")
        if os.path.isfile(manifest_path):
            with open(manifest_path) as f:
                manifest = json.load(f).get("artifacts", {})
        sidecar = f"step_{CKPT_FSDP}_data_p0.json"
        log(f"fsdp: step {CKPT_FSDP}'s manifest lists {sorted(manifest)}")
        if sidecar not in manifest or not os.path.isfile(os.path.join(ckpt, sidecar)):
            failures.append(f"fsdp: step {CKPT_FSDP}'s sidecar or manifest: {sorted(manifest)}")

        # run B: resume A from step 10 to 20 through the launcher (no interval
        # save: its losses are what it is run for)
        with open(os.path.join(tmp, "b.json"), "w") as f:
            json.dump(dict(cfg, overwrite=False, resume={"checkpoint": str(CKPT_FSDP),
                                                         "strict": True},
                           logging=dict(cfg["logging"], profile_start=0, profile_stop=0,
                                        steps=dict(cfg["logging"]["steps"],
                                                   checkpoint_interval=0))), f)
        # the two ranks on the card run beside run B: neither times what the
        # other reads, and the card holds both
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
            b_job = pool.submit(child_run, launch_cmd(1, "--device", device, "--config",
                                                      os.path.join(tmp, "b.json"),
                                                      "--runs-root", runs),
                                os.path.join(tmp, "b.out"), 900)
            two = two_ranks_on_one_card(tmp, card, device)
            rc_b = b_job.result()
        wall_b = time.perf_counter() - t0
        events_b = read_events(run_dir)[len(events):]
        losses_b = {e["step"]: e["loss"] for e in events_b if e.get("type") == "step_window"}
        resumed = next((e for e in events_b if e.get("type") == "resume"), {})
        rel = {st: abs(x - losses_a[st]) / abs(losses_a[st]) for st, x in losses_b.items()}
        max_rel = max(rel.values()) if rel else float("nan")
        resume_bitwise = bool(rel) and all(losses_b[st] == losses_a[st] for st in rel)
        log(f"fsdp: run B (resumed at {CKPT_FSDP}, beside the two ranks) exit {rc_b} in "
            f"{wall_b:.1f}s, steps "
            f"{sorted(losses_b)}; losses vs run A: max relative difference {max_rel:.3g}, "
            f"bitwise {resume_bitwise}")
        if rc_b != 0 or sorted(losses_b) != list(range(CKPT_FSDP + 1, STEPS_FSDP + 1)) \
                or not max_rel <= 1e-5 or str(resumed.get("tag")) != str(CKPT_FSDP):
            failures.append(f"fsdp: run B exit {rc_b}, losses {losses_b} vs A {losses_a}: "
                            f"{tail_of(os.path.join(tmp, 'b.out'), 2000)}")
        shutil.rmtree(run_dir, ignore_errors=True)

        # the step's time from run A's windows: past step 1 (the warm-up), out
        # of the profile window, with no checkpoint save in them
        steady = [e for e in windows if e["step"] > 1
                  and not PROFILE_FSDP[0] <= e["step"] < PROFILE_FSDP[1]
                  and not e.get("goodput", {}).get("ckpt_save_s")]
        secs = sum(e["toks"] / e["tok_s"] for e in steady)
        tok_s = sum(e["toks"] for e in steady) / secs
        flops_per_token = run_start.get("flops_per_token") or float("nan")
        perf = {"step_ms": 1e3 * secs / sum(e["steps"] for e in steady), "tok_s": tok_s,
                "mfu_vs_989tflops": tok_s * flops_per_token / PEAK_FLOPS["bfloat16"],
                "flops_per_token": flops_per_token, "batch": BATCH_FSDP,
                "peak_mem_gb": run_end.get("peak_device_mem_gb"),
                "run_a_s": wall_a, "run_b_s": wall_b, "losses": losses_a,
                "step1": {"launcher": {"loss": losses_a[1], "grad_norm": norms_a[1]},
                          "one_device": single_step, "loss_rel": loss_rel,
                          "grad_norm_rel": norm_rel, "bitwise": bitwise},
                "resume": {"max_rel_loss_diff": max_rel, "bitwise": resume_bitwise},
                "launches": {k: launched.get(k, 0) for k in FLASH_KERNELS},
                "profiled_flash_kernels": seen, "flash_launches_a_step": per_step,
                "n_chips": run_start.get("n_chips")}
        perf["two_ranks_one_card"] = two
        if not two["two_ranks_gloo"].get("loss_rel", 1.0) <= 1e-5:
            failures.append(f"fsdp: two gloo ranks on one card against one rank: {two}")
    perf["seconds"] = time.perf_counter() - t_phase
    for k in ("step_ms", "tok_s", "mfu_vs_989tflops", "peak_mem_gb"):
        log(f"fsdp: {k}={perf[k]} [{card}]")
    log(f"fsdp: the phase took {perf['seconds']:.1f}s")
    return failures, perf


# -- phase 7c: 1b-tp over 4 gloo ranks on the one card ------------------------------
BATCH_TP = 2          # of the config's 32: 4 ranks share the card and its host
DEPTH_TP = 2          # of the config's 16: the whole smoke's time limit
STEPS_TP = 16         # of 20,000
CKPT_TP = 8
PROFILE_TP = (3, 4)   # the torch.profiler window of run A: step 3
RANKS_TP = 4


def config_1b_tp(tmp: str) -> dict:
    """configs/model-config-1b-tp.yaml written out as a dict, with the
    smoke's cuts: ``iters`` 16 (of 20,000), ``warmup_steps`` 2 (of 2,000),
    batch 2 (of 32: its four ranks share one card and the host carries
    their sums), 2 of its 16 layers (the whole smoke's time limit), a log
    line every step with the gradient norm, a checkpoint every 8 steps (of
    1,000), no validation split, a torch.profiler window over step 3, and
    the corpus path. Every width and switch is the config's: hidden 2048,
    16 heads of 128, intermediate 5632, S 2048, tied embeddings, flash
    attention, remat "dots", AdamW (0.9/0.95, weight decay 0.1, clip 1.0,
    lr 3e-4), ZeRO-1 and ``mesh: {dp: -1, tp: 4}``."""
    return {
        "name": "Llama-1B-tp", "overwrite": True,
        "data": {"input_file": os.path.join(tmp, "train.jsonl"),
                 "tokenizer_path": "tokenizer",
                 "preprocessing": {"max_context_size": 2048, "chunk_overlap": 128},
                 "tokenizer": {"normal_vocab_size": 256, "special_tokens": {
                     "pad": "<pad>", "bos": "<bos>", "eos": "<eos>"}}},
        "model": {"architecture": "llama",
                  "dimensions": {"hidden_size": 2048, "intermediate_size": 5632,
                                 "num_layers": DEPTH_TP},
                  "attention": {"num_heads": 16, "num_kv_heads": 16, "head_dim": 128,
                                "max_position_embeddings": 2048,
                                "use_flash_attention": True},
                  "normalization": {"rms_norm_eps": 1.0e-5},
                  "rope": {"theta": 10000, "traditional": False, "scaling": None},
                  "misc": {"attention_bias": False, "mlp_bias": False,
                           "tie_word_embeddings": True}},
        "training": {"hyperparameters": {"batch_size": BATCH_TP, "learning_rate": 3.0e-4,
                                         "weight_decay": 0.1, "gradient_clip": 1.0,
                                         "iters": STEPS_TP},
                     "scheduler": {"type": "cosine_with_warmup", "min_lr_ratio": 0.1,
                                   "warmup_steps": 2},
                     "optimization": {"optimizer": "adamw", "betas": [0.9, 0.95]}},
        "logging": {"steps": {"logging_interval": 1, "checkpoint_interval": CKPT_TP,
                              "validation_interval": 500},
                    "log_gradient_norm": True,
                    "profile_start": PROFILE_TP[0], "profile_stop": PROFILE_TP[1],
                    "profile_report": {"top_k": 1000}},
        "system": {"seed": 42, "mixed_precision": True, "precision": "bfloat16",
                   "gradient_checkpointing": True, "remat": "dots",
                   "zero_optimization_level": 1, "mesh": {"dp": -1, "tp": RANKS_TP}},
    }


def tp_1b_phase(torch, gm, fa, card, device: str = "cuda"):
    """1b-tp at full width on its own mesh, ``{dp: -1, tp: 4}``, over 4
    gloo ranks on the one card through ``parallel.launch`` (``dp`` resolves
    to 1; NCCL refuses two ranks on one device). The reference: the same
    cut config trained on one rank with no mesh, its step 1 in this
    process. Run A: 16 steps, a checkpoint at step 8, a profile window over
    step 3. Run B: resumes A at step 8 on the 4 ranks. Gates: A's step 1
    within the bf16 gates for kernels against plain (loss 2e-3, gradient
    norm 2e-2 relative: the row-parallel sums round in another order);
    the loss falls below 0.9 x step 1's; rank 0's profile holds the three
    bf16 flash kernels at the one-rank step's count and no plain attention
    op; every rank launched the flash kernels, all on wgmma, at its 4 of
    the 16 heads; B's losses A's within 1e-5. ``device="cpu"`` (with a
    small ``config_1b_tp``) rehearses it on the CPU, where only the kernel
    gates fail."""
    import gc
    import shutil
    import tempfile

    from mlx_cuda_distributed_pretraining_tpu_torch.config import Config
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer

    failures, perf = [], {}
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        write_corpus(tmp, train_bytes=300_000, val_bytes=70_000)
        cfg = config_1b_tp(tmp)
        heads = cfg["model"]["attention"]["num_heads"]
        log(f"tp: cuts of configs/model-config-1b-tp.yaml: layers {DEPTH_TP} of 16, batch "
            f"{BATCH_TP} of 32, {STEPS_TP} steps of 20,000, warmup 2 of 2,000, a checkpoint "
            f"at step {CKPT_TP}; widths and switches the config's")

        # the reference: one rank, no mesh, its step 1 in this process
        single = dict(cfg, name="single",
                      system={k: v for k, v in cfg["system"].items() if k != "mesh"},
                      logging=dict(cfg["logging"], profile_start=0, profile_stop=0))
        t0 = time.perf_counter()
        t = Trainer(Config.from_dict(single), runs_root=os.path.join(tmp, "runs_single"),
                    quiet=True, device=device)
        reset_launches(gm, fa)
        t.state, m = t.train_step(t.state, t._device_batch(t.data.generate_batch(0)))
        single_step = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
        per_step = {k: v for k, v in read_launches(gm, fa).items() if k in FLASH_KERNELS}
        t.events.close()
        t.logger.close()
        t.state = None
        del t, m
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(os.path.join(tmp, "runs_single"), ignore_errors=True)
        log(f"tp: one rank (no mesh), step 1 in {time.perf_counter() - t0:.1f}s: "
            f"{single_step}; flash launches a step {per_step}")

        # run A: 4 gloo ranks on the card, 16 steps, a checkpoint at 8
        runs = os.path.join(tmp, "runs")
        with open(os.path.join(tmp, "a.json"), "w") as f:
            json.dump(cfg, f)
        launch = ("--device", device, "--backend", "gloo", "--timeout-s", "400")
        t0 = time.perf_counter()
        rc_a = child_run(launch_cmd(RANKS_TP, *launch, "--config", os.path.join(tmp, "a.json"),
                                    "--runs-root", runs), os.path.join(tmp, "a.out"), 450)
        wall_a = time.perf_counter() - t0
        run_dir = os.path.join(runs, cfg["name"])
        events = read_events(run_dir)
        windows = [e for e in events if e.get("type") == "step_window"]
        losses_a = {e["step"]: e["loss"] for e in windows}
        norms_a = {e["step"]: e.get("grad_norm") for e in windows}
        run_end = next((e for e in events if e.get("type") == "run_end"), {})
        log_a = (open(os.path.join(run_dir, "log.txt")).read()
                 if os.path.isfile(os.path.join(run_dir, "log.txt")) else "")
        a_out = tail_of(os.path.join(tmp, "a.out"), 10**7)
        log(f"tp: run A ({RANKS_TP} gloo ranks on one card) exit {rc_a} in {wall_a:.1f}s; "
            f"losses {[round(losses_a[st], 5) for st in sorted(losses_a)]}; "
            f"{[ln.split('] ', 1)[-1] for ln in log_a.splitlines() if 'mesh ' in ln][:1]}")
        if rc_a != 0 or sorted(losses_a) != list(range(1, STEPS_TP + 1)) or \
                not all(math.isfinite(x) for x in losses_a.values()):
            failures.append(f"tp: run A exit {rc_a}, losses {losses_a}: {a_out[-3000:]}")
            return failures, perf
        if f"mesh {{'dp': 1, 'tp': {RANKS_TP}}} over {RANKS_TP} rank(s)" not in log_a or \
                f"[launch] rank 0/{RANKS_TP} backend gloo device {device}" not in a_out:
            failures.append("tp: run A did not train on the {dp: 1, tp: 4} gloo mesh")

        # gate: step 1 against one rank, at the bf16 kernel-vs-plain limits
        loss_rel = abs(losses_a[1] - single_step["loss"]) / abs(single_step["loss"])
        norm_rel = abs(norms_a[1] - single_step["grad_norm"]) / single_step["grad_norm"]
        bitwise = (losses_a[1] == round(single_step["loss"], 6)
                   and norms_a[1] == single_step["grad_norm"])
        log(f"tp: step 1 vs one rank: loss {losses_a[1]} vs {single_step['loss']} (rel "
            f"{loss_rel:.3g}), grad_norm {norms_a[1]} vs {single_step['grad_norm']} (rel "
            f"{norm_rel:.3g}); bitwise {bitwise} (the loss at the events' 6 decimals)")
        if not (loss_rel <= 2e-3 and norm_rel <= 2e-2):
            failures.append(f"tp: step 1 differs from one rank: loss rel {loss_rel}, "
                            f"grad_norm rel {norm_rel}")
        if not losses_a[STEPS_TP] < 0.9 * losses_a[1]:
            failures.append(f"tp: the loss does not fall: {losses_a[1]} -> "
                            f"{losses_a[STEPS_TP]}")

        # gate: rank 0's profile window holds every layer's flash kernels
        _, seen, want, plain, _, prof_failures = profiled_flash("tp", run_dir, PROFILE_TP,
                                                                per_step)
        failures += prof_failures
        log(f"tp: rank 0's profile: flash kernels {seen} vs one rank's step {want}; plain "
            f"attention ops: {plain or 'none'}")

        # gate: every rank launched the flash kernels on wgmma at its 4 heads
        ranks = run_end.get("ranks") or []
        rank_rows = []
        for r, rec in enumerate(ranks):
            kl = (rec or {}).get("kernel_launches") or {}
            rank_rows.append({"rank": r, "heads": rec.get("attention_heads"),
                              "peak_mem_gb": rec.get("peak_device_mem_gb"),
                              **{k: kl.get(k, 0) for k in FLASH_KERNELS},
                              "variants": {k: kl.get(f"{k}_by_variant") for k in FLASH_KERNELS}})
        for row in rank_rows:
            log(f"tp: rank {row['rank']}: heads {row['heads']} of {heads}, flash launches "
                f"{ {k: row[k] for k in FLASH_KERNELS} }, variants {row['variants']}, peak "
                f"memory {row['peak_mem_gb']} GB [{card}]")
        want_run = {k: v * STEPS_TP for k, v in per_step.items() if k != "flash_fwd"}
        if len(rank_rows) != RANKS_TP or any(
                row["heads"] != heads // RANKS_TP
                or any(row[k] != n for k, n in want_run.items())
                or row["flash_fwd"] < per_step["flash_fwd"] * STEPS_TP
                or any({k for k, n in (v or {}).items() if n} - {"wgmma"}
                       for v in row["variants"].values())
                or not all((v or {}).get("wgmma") for v in row["variants"].values())
                for row in rank_rows):
            failures.append(f"tp: the ranks' flash launches {rank_rows} (want {want_run} and "
                            f"wgmma at {heads // RANKS_TP} heads)")

        # run B: resume A at step 8 on the 4 ranks
        with open(os.path.join(tmp, "b.json"), "w") as f:
            json.dump(dict(cfg, overwrite=False, resume={"checkpoint": str(CKPT_TP),
                                                         "strict": True},
                           logging=dict(cfg["logging"], profile_start=0, profile_stop=0,
                                        steps=dict(cfg["logging"]["steps"],
                                                   checkpoint_interval=0))), f)
        t0 = time.perf_counter()
        rc_b = child_run(launch_cmd(RANKS_TP, *launch, "--config", os.path.join(tmp, "b.json"),
                                    "--runs-root", runs), os.path.join(tmp, "b.out"), 450)
        wall_b = time.perf_counter() - t0
        events_b = read_events(run_dir)[len(events):]
        losses_b = {e["step"]: e["loss"] for e in events_b if e.get("type") == "step_window"}
        rel = {st: abs(x - losses_a[st]) / abs(losses_a[st]) for st, x in losses_b.items()}
        max_rel = max(rel.values()) if rel else float("nan")
        resume_bitwise = bool(rel) and all(losses_b[st] == losses_a[st] for st in rel)
        log(f"tp: run B (resumed at {CKPT_TP}) exit {rc_b} in {wall_b:.1f}s, steps "
            f"{sorted(losses_b)}; losses vs run A: max relative difference {max_rel:.3g}, "
            f"bitwise {resume_bitwise}")
        if rc_b != 0 or sorted(losses_b) != list(range(CKPT_TP + 1, STEPS_TP + 1)) \
                or not max_rel <= 1e-5:
            failures.append(f"tp: run B exit {rc_b}, losses {losses_b} vs A {losses_a}: "
                            f"{tail_of(os.path.join(tmp, 'b.out'), 2000)}")

        steady = [e for e in windows if e["step"] > 1
                  and not PROFILE_TP[0] <= e["step"] < PROFILE_TP[1]
                  and not e.get("goodput", {}).get("ckpt_save_s")]
        secs = sum(e["toks"] / e["tok_s"] for e in steady)
        perf = {"step_ms": 1e3 * secs / sum(e["steps"] for e in steady),
                "tok_s": sum(e["toks"] for e in steady) / secs, "batch": BATCH_TP,
                "layers": DEPTH_TP, "ranks": rank_rows, "run_a_s": wall_a, "run_b_s": wall_b,
                "losses": losses_a,
                "step1": {"tp4": {"loss": losses_a[1], "grad_norm": norms_a[1]},
                          "one_rank": single_step, "loss_rel": loss_rel,
                          "grad_norm_rel": norm_rel, "bitwise": bitwise},
                "resume": {"max_rel_loss_diff": max_rel, "bitwise": resume_bitwise},
                "launches": {k: rank_rows[0][k] if rank_rows else 0 for k in FLASH_KERNELS},
                "profiled_flash_kernels": seen, "flash_launches_a_step": per_step}
    perf["seconds"] = time.perf_counter() - t_phase
    for k in ("step_ms", "tok_s"):
        log(f"tp: {k}={perf.get(k)} at {RANKS_TP} gloo ranks on one card: the host carries "
            f"every sum over tp, so gloo sets this pace, not the card [{card}]")
    log(f"tp: the phase took {perf['seconds']:.1f}s")
    return failures, perf


# -- phases 6c and 7d: expert parallelism over gloo ranks on the one card ---------
# 6c: moe-8x40m on {dp: -1, ep: 4}; 7d: moe-1b on {ep: 8, fsdp: -1}. NCCL
# refuses two ranks on one device, so the ranks are gloo ranks on cuda:0 and
# every all_to_all crosses the host.
EP4 = dict(label="ep4", ranks=4, layers=4, rows=2, steps=12, ckpt=6, arm_steps=3,
           ref_steps=4, loss_falls=True, D=512, I=1536, E=8)
EP8 = dict(label="ep8", ranks=8, layers=2, rows=1, steps=3, ckpt=None, arm_steps=0,
           ref_steps=3, loss_falls=False, D=2048, I=5632, E=8)


def ep_geometry(gm, spec, seq: int, k: int = 2) -> dict:
    """A rank's dispatch geometry at a phase's cut: its selections TK (rows
    x S x top-k), the send slots ``cap`` (TK at factor 0), the receive
    buffer ``ep * cap``, the gmm tile and the gmm's row count ``T_buf``."""
    ep, e_loc = spec["ranks"], spec["E"] // spec["ranks"]
    tk = spec["rows"] * seq * k
    rows = ep * tk
    bt = gm.pick_block_t(rows, e_loc)
    return {"tk": tk, "recv_rows": rows, "e_loc": e_loc, "block_t": bt,
            "t_buf": gm.round_up(rows + e_loc * (bt - 1), bt)}


def ep_bounds(K, N, live, rows, used, tgmm=False, es=2) -> dict:
    """The bound over the real rows and over the whole receive buffer (the
    gmm reads and writes every buffer row: its tail tiles write zeros)."""
    ops = 2.0 * live * K * N / PEAK_FLOPS["bfloat16"] * 1e3
    if tgmm:
        real, buf = (live * (K + N) + used * K * N) * es, (rows * (K + N) + used * K * N) * es
    else:
        real = (live * K + used * K * N + live * N) * es
        buf = (rows * K + used * K * N + rows * N) * es
    return {"bound_real_ms": max(real / HBM_BYTES_S * 1e3, ops),
            "bound_buffer_ms": max(buf / HBM_BYTES_S * 1e3, ops)}


def ep_kernel_cases(torch, gm, kernel_check) -> dict:
    """The gmm (gate/up, down, both dX) and tgmm cases at each ep phase's
    per-rank shape: E/ep groups over the ``ep * cap``-row receive buffer,
    of which about TK rows are real (a uniform routing draw)."""
    rng = torch.Generator().manual_seed(SEED + 7)
    out = {}
    for spec, seq in ((EP4, 1024), (EP8, 2048)):
        g = ep_geometry(gm, spec, seq)
        D, I, bt, rows = spec["D"], spec["I"], g["block_t"], g["t_buf"]
        sizes, _ = routed_sizes(torch, rng, g["tk"], g["e_loc"], bt)
        p = spec["label"]
        gmm = [train_gmm_case(torch, gm, kernel_check, f"{p}_gate_up", D, I, sizes, rows,
                              False, fault=True, block_t=bt),
               train_gmm_case(torch, gm, kernel_check, f"{p}_down", I, D, sizes, rows, False,
                              block_t=bt),
               train_gmm_case(torch, gm, kernel_check, f"{p}_dx_gate_up", I, D, sizes, rows,
                              True, block_t=bt),
               train_gmm_case(torch, gm, kernel_check, f"{p}_dx_down", D, I, sizes, rows, True,
                              block_t=bt)]
        tgmm = [tgmm_case(torch, gm, kernel_check, f"{p}_gate_up", "bfloat16", D, I, sizes,
                          rows, bt, "wgmma", fault=True),
                tgmm_case(torch, gm, kernel_check, f"{p}_down", "bfloat16", I, D, sizes, rows,
                          bt, "wgmma")]
        live, used = int(sizes.sum()), int((sizes > 0).sum())
        for c in gmm + tgmm:
            K, N = c["shape"][1], c["shape"][2]
            c.update(ep_bounds(K, N, live, rows, used, tgmm=c in tgmm), geometry=g)
            log(f"{p}: {c['case']} ({'tgmm' if c in tgmm else 'gmm'}) {c['ms']:.4f} ms; bound "
                f"over the {live} real rows {c['bound_real_ms']:.4f} ms, over the buffer's "
                f"{rows} rows {c['bound_buffer_ms']:.4f} ms")
        out[p] = {"gmm": gmm, "tgmm": tgmm, "geometry": g}
    return out


def config_moe_ep4(tmp: str) -> dict:
    """configs/model-config-moe-8x40m.yaml on its own mesh, ``{dp: -1, ep:
    4}``, with the smoke's cuts: 4 of its 12 layers, 2 rows a rank (a global
    batch of 8 of 32), 12 steps (of 10,000), warmup 2 (of 500), a log line a
    step with the gradient norm, a checkpoint at step 6, no validation
    split. Every width and switch is the config's: hidden 512, intermediate
    1536, 8 heads of 64, S 1024, 8 experts top-2, ``ep_capacity_factor`` 0,
    bf16 over fp32 masters, AdamW, remat "dots", ZeRO-1."""
    cfg = config_moe(tmp, EP4["steps"], 2)
    cfg["name"] = "Llama-MoE-8x40M-ep4"
    cfg["data"].pop("validation_file")
    cfg["model"]["dimensions"]["num_layers"] = EP4["layers"]
    cfg["model"]["moe"]["ep_capacity_factor"] = 0.0
    cfg["training"]["hyperparameters"]["batch_size"] = EP4["rows"]
    cfg["logging"]["steps"] = {"logging_interval": 1, "checkpoint_interval": EP4["ckpt"],
                               "validation_interval": 0}
    cfg["logging"]["log_gradient_norm"] = True
    cfg["system"].update(gradient_checkpointing=True, remat="dots", zero_optimization_level=1,
                         mesh={"dp": -1, "ep": EP4["ranks"]})
    return cfg


def config_moe_1b(tmp: str) -> dict:
    """configs/model-config-moe-1b.yaml written out as a dict on its own
    mesh, ``{ep: 8, fsdp: -1}``, with the smoke's cuts: 2 of its 16 layers,
    1 row a rank (a global batch of 8 of 32), 3 steps (of 20,000), warmup 2
    (of 2,000), a log line a step with the gradient norm, no periodic
    checkpoint and no validation split. Every width and switch is the
    config's: hidden 2048, intermediate 5632, 16 heads of 128, S 2048, tied
    embeddings, 8 experts top-2, ``ep_capacity_factor`` 0, flash attention,
    bf16, AdamW (0.9/0.95, weight decay 0.1, clip 1.0, lr 3e-4), remat
    "dots", ZeRO-1."""
    return {
        "name": "Llama-MoE-1B-ep8", "overwrite": True,
        "data": {"input_file": os.path.join(tmp, "train.jsonl"),
                 "tokenizer_path": "tokenizer",
                 "preprocessing": {"max_context_size": 2048, "chunk_overlap": 128},
                 "tokenizer": {"normal_vocab_size": 256, "special_tokens": {
                     "pad": "<pad>", "bos": "<bos>", "eos": "<eos>"}}},
        "model": {"architecture": "llama",
                  "dimensions": {"hidden_size": EP8["D"], "intermediate_size": EP8["I"],
                                 "num_layers": EP8["layers"]},
                  "attention": {"num_heads": 16, "num_kv_heads": 16, "head_dim": 128,
                                "max_position_embeddings": 2048,
                                "use_flash_attention": True},
                  "normalization": {"rms_norm_eps": 1.0e-5},
                  "rope": {"theta": 10000, "traditional": False, "scaling": None},
                  "misc": {"attention_bias": False, "mlp_bias": False,
                           "tie_word_embeddings": True},
                  "moe": {"num_local_experts": EP8["E"], "num_experts_per_tok": 2,
                          "impl": "grouped", "capacity_factor": 1.25,
                          "aux_loss_weight": 0.01, "router_z_weight": 0.001,
                          "group_size": 256, "ep_capacity_factor": 0.0}},
        "training": {"hyperparameters": {"batch_size": EP8["rows"], "learning_rate": 3.0e-4,
                                         "weight_decay": 0.1, "gradient_clip": 1.0,
                                         "iters": EP8["steps"]},
                     "scheduler": {"type": "cosine_with_warmup", "min_lr_ratio": 0.1,
                                   "warmup_steps": 2},
                     "optimization": {"optimizer": "adamw", "betas": [0.9, 0.95]}},
        "logging": {"steps": {"logging_interval": 1, "checkpoint_interval": 0,
                              "validation_interval": 0},
                    "log_gradient_norm": True},
        "system": {"seed": 42, "mixed_precision": True, "precision": "bfloat16",
                   "gradient_checkpointing": True, "remat": "dots",
                   "zero_optimization_level": 1,
                   "mesh": {"ep": EP8["ranks"], "fsdp": -1}},
    }


def ep_reference(torch, gm, fa, cfg: dict, spec: dict, tmp: str, device: str) -> dict:
    """The same cut config on one rank with no mesh, in this process, for
    its first ``ref_steps`` steps, each on the global batch the ranks read
    at that step (each rank's loader at (index i, count ep), their rows in
    rank order): the losses and gradient norms, and the median of steps
    2 on in ms, beside the ranks'."""
    import gc
    import shutil

    import numpy as np

    from mlx_cuda_distributed_pretraining_tpu_torch.config import Config
    from mlx_cuda_distributed_pretraining_tpu_torch.data.streaming import build_data_manager
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer

    ranks = spec["ranks"]
    single = json.loads(json.dumps(cfg))
    single["name"] = "single"
    single["system"].pop("mesh")
    single["training"]["hyperparameters"]["batch_size"] = spec["rows"] * ranks
    t = Trainer(Config.from_dict(single), runs_root=os.path.join(tmp, "runs_single"),
                quiet=True, device=device)
    ccfg = Config.from_dict(cfg)
    loaders = [build_data_manager(ccfg, t.tokenizer, spec["rows"],
                                  seq_len=ccfg.data.max_context_size, seed=ccfg.system.seed,
                                  process_index=i, process_count=ranks) for i in range(ranks)]
    losses, norms, times, tokens = [], [], [], 0.0
    for step in range(spec["ref_steps"]):
        parts = [d.generate_batch(step) for d in loaders]
        batch = t._device_batch({k: np.concatenate([p[k] for p in parts]) for k in parts[0]})
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.state, m = t.train_step(t.state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if step:
            times.append(time.perf_counter() - t0)
            tokens = float(batch["mask"].sum())
    out = {"loss": losses[0], "grad_norm": norms[0], "losses": losses, "grad_norms": norms,
           "step_ms": 1e3 * sorted(times)[len(times) // 2]}
    out["tok_s"] = tokens / (out["step_ms"] / 1e3)
    t.events.close()
    t.logger.close()
    t.state = None
    del t, m, batch
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(tmp, "runs_single"), ignore_errors=True)
    return out


def logged_drops(run_dir: str) -> dict:
    """``{step: moe_drop}`` of the chief's log lines."""
    out = {}
    path = os.path.join(run_dir, "log.txt")
    lines = open(path).read().splitlines() if os.path.isfile(path) else []
    for line in lines:
        if "Step " in line and "moe_drop=" in line and ": loss=" in line:
            step = int(line.split("Step ", 1)[1].split(":", 1)[0])
            out[step] = int(line.split("moe_drop=", 1)[1].split()[0])
    return out


def ep_rank_rows(run_end: dict) -> list:
    rows = []
    for r, rec in enumerate(run_end.get("ranks") or []):
        kl = (rec or {}).get("kernel_launches") or {}
        rows.append({"rank": r, "experts": rec.get("experts"),
                     "peak_mem_gb": rec.get("peak_device_mem_gb"),
                     "gmm": kl.get("gmm", 0), "tgmm": kl.get("tgmm", 0),
                     "gmm_by_variant": kl.get("gmm_by_variant") or {},
                     "tgmm_by_variant": kl.get("tgmm_by_variant") or {},
                     "gmm_by_shape": kl.get("gmm_by_shape") or {},
                     "tgmm_by_shape": kl.get("tgmm_by_shape") or {},
                     "exchanges": rec.get("exchanges") or {}})
    return rows


def ep_launch(tmp: str, cfg: dict, spec: dict, tag: str, device: str, timeout: float):
    """One run of the trainer through ``parallel.launch`` on the phase's gloo
    ranks: ``(rc, wall s, events, output tail)``."""
    path = os.path.join(tmp, f"{tag}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    t0 = time.perf_counter()
    rc = child_run(launch_cmd(spec["ranks"], "--device", device, "--backend", "gloo",
                              "--timeout-s", str(int(timeout) - 30), "--config", path,
                              "--runs-root", os.path.join(tmp, "runs")),
                   os.path.join(tmp, f"{tag}.out"), timeout)
    wall = time.perf_counter() - t0
    events = read_events(os.path.join(tmp, "runs", cfg["name"]))
    return rc, wall, events, tail_of(os.path.join(tmp, f"{tag}.out"), 10**7)


def ep_phase(torch, gm, fa, card, spec: dict, device: str = "cuda"):
    """A config with an ep axis at full width on its own mesh over gloo ranks
    on the one card through ``parallel.launch`` (6c: moe-8x40m, 7d:
    moe-1b). Run A trains ``steps`` steps (6c: a checkpoint at 6, which run
    B resumes strictly; then arm C at ``ep_capacity_factor`` 1.0 for 3
    steps). Gates: A's step 1 within the bf16 kernel-vs-plain limits of the
    same cut on one rank without a mesh (loss 2e-3, gradient norm 2e-2
    relative: the dispatch sums in another order; bitwise printed); 6c's
    last loss below 0.9 x step 1's; every rank holds E/ep experts and ran
    every gmm and tgmm on ``wgmma`` at the receive buffer's rows; no drop
    at factor 0; B's losses A's within 1e-5; C drops on every step, its
    ``moe_dropped_tokens_total`` is the sum, its losses finite. Prints the
    step ms and tok/s beside one rank's, each rank's peak memory and the
    exchanges' bytes a step. ``device="cpu"`` with small configs rehearses
    it on the CPU, where only the kernel gates fail."""
    import tempfile
    from types import SimpleNamespace

    from mlx_cuda_distributed_pretraining_tpu_torch.models.moe import ep_capacity
    from mlx_cuda_distributed_pretraining_tpu_torch.parallel.mesh import mesh_axis_sizes

    label, ranks, steps = spec["label"], spec["ranks"], spec["steps"]
    failures, perf = [], {}
    t_phase = time.perf_counter()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        write_corpus(tmp, train_bytes=300_000, val_bytes=70_000)
        cfg = spec["config"](tmp)
        seq = cfg["data"]["preprocessing"]["max_context_size"]
        geo = ep_geometry(gm, spec, seq)
        log(f"{label}: reduced: layers {spec['layers']} of the config's, batch "
            f"{spec['rows'] * ranks} of 32 ({spec['rows']} rows a rank), {steps} steps, "
            f"warmup 2; widths, mesh {cfg['system']['mesh']} and switches the config's; "
            f"a rank's receive buffer {geo}")
        t0 = time.perf_counter()
        ref = ep_reference(torch, gm, fa, cfg, spec, tmp, device)
        log(f"{label}: one rank (no mesh), the ranks' global batches, in "
            f"{time.perf_counter() - t0:.1f}s: {ref} [{card}]")

        timeout = 400
        rc, wall_a, events, out_a = ep_launch(tmp, cfg, spec, "a", device, timeout)
        windows = [e for e in events if e.get("type") == "step_window"]
        losses = {e["step"]: e["loss"] for e in windows}
        norms = {e["step"]: e.get("grad_norm") for e in windows}
        run_dir = os.path.join(tmp, "runs", cfg["name"])
        drops = logged_drops(run_dir)
        run_end = next((e for e in events if e.get("type") == "run_end"), {})
        log(f"{label}: run A ({ranks} gloo ranks on one card) exit {rc} in {wall_a:.1f}s; "
            f"losses {[round(losses[k], 5) for k in sorted(losses)]}; drops "
            f"{[drops[k] for k in sorted(drops)]}")
        if rc != 0 or sorted(losses) != list(range(1, steps + 1)) or \
                not all(math.isfinite(x) for x in losses.values()):
            failures.append(f"{label}: run A exit {rc}, losses {losses}: {out_a[-3000:]}")
            return failures, perf
        want_mesh = mesh_axis_sizes(SimpleNamespace(mesh=cfg["system"]["mesh"]), ranks)
        if f"[launch] rank 0/{ranks} backend gloo device {device}" not in out_a or \
                f"mesh {want_mesh} over {ranks} rank(s)" not in \
                open(os.path.join(run_dir, "log.txt")).read():
            failures.append(f"{label}: run A did not train on the {want_mesh} gloo mesh")

        loss_rel = abs(losses[1] - ref["loss"]) / abs(ref["loss"])
        norm_rel = abs(norms[1] - ref["grad_norm"]) / ref["grad_norm"]
        bitwise = losses[1] == round(ref["loss"], 6) and norms[1] == ref["grad_norm"]
        log(f"{label}: step 1 vs one rank: loss {losses[1]} vs {ref['loss']} (rel "
            f"{loss_rel:.3g}), grad_norm {norms[1]} vs {ref['grad_norm']} (rel "
            f"{norm_rel:.3g}); bitwise {bitwise} (the loss at the events' 6 decimals)")
        if not (loss_rel <= 2e-3 and norm_rel <= 2e-2):
            failures.append(f"{label}: step 1 differs from one rank: loss rel {loss_rel}, "
                            f"grad_norm rel {norm_rel}")
        later = {k: abs(losses[k] - ref["losses"][k - 1]) / abs(ref["losses"][k - 1])
                 for k in range(2, len(ref["losses"]) + 1)}
        log(f"{label}: steps 2-{len(ref['losses'])}: losses {[losses[k] for k in later]} vs "
            f"one rank's {ref['losses'][1:]} (relative {later}; not gated: bf16 sums in "
            f"another order compound over the updates)")
        if spec["loss_falls"] and not losses[steps] < 0.9 * losses[1]:
            failures.append(f"{label}: the loss does not fall: {losses[1]} -> {losses[steps]}")
        if sorted(drops) != list(range(1, steps + 1)) or any(d != 0 for d in drops.values()):
            failures.append(f"{label}: drops at ep_capacity_factor 0: {drops}")

        rank_rows = ep_rank_rows(run_end)
        for row in rank_rows:
            log(f"{label}: rank {row['rank']}: {row['experts']} experts a layer, gmm "
                f"{row['gmm_by_variant']} at {row['gmm_by_shape']}, tgmm "
                f"{row['tgmm_by_variant']} at {row['tgmm_by_shape']}, exchanges "
                f"{row['exchanges']}, peak memory {row['peak_mem_gb']} GB [{card}]")
        bad = [row["rank"] for row in rank_rows
               if row["experts"] != geo["e_loc"] or row["gmm"] <= 0 or row["tgmm"] <= 0
               or {k for k, n in row["gmm_by_variant"].items() if n} != {"wgmma"}
               or {k for k, n in row["tgmm_by_variant"].items() if n} != {"wgmma"}
               or row["gmm_by_variant"].get("wgmma") != row["gmm"]
               or row["tgmm_by_variant"].get("wgmma") != row["tgmm"]
               or any(int(k.split(":")[1]) != geo["t_buf"]
                      for k in list(row["gmm_by_shape"]) + list(row["tgmm_by_shape"]))]
        if len(rank_rows) != ranks or bad:
            failures.append(f"{label}: ranks {bad} of {len(rank_rows)}: gmm/tgmm not all "
                            f"wgmma at {geo['e_loc']} experts and {geo['t_buf']} rows: "
                            f"{rank_rows}")

        steady = [e for e in windows if e["step"] > 1
                  and not e.get("goodput", {}).get("ckpt_save_s")]
        secs = sum(e["toks"] / e["tok_s"] for e in steady)
        n_steps = sum(e["steps"] for e in steady)
        ex = rank_rows[0]["exchanges"] if rank_rows else {}
        perf = {"step_ms": 1e3 * secs / max(n_steps, 1),
                "tok_s": sum(e["toks"] for e in steady) / secs if secs else None,
                "one_rank": ref, "run_a_s": wall_a, "layers": spec["layers"],
                "rows_a_rank": spec["rows"], "ranks": rank_rows, "geometry": geo,
                "losses": losses, "drops": drops,
                "exchange_bytes_a_step": ex.get("bytes", 0) / steps,
                "exchanges_a_step": ex.get("calls", 0) / steps,
                "later_steps_loss_rel": later,
                "step1": {"loss_rel": loss_rel, "grad_norm_rel": norm_rel,
                          "bitwise": bitwise, "one_rank": {k: ref[k] for k in
                                                           ("loss", "grad_norm")},
                          label: {"loss": losses[1], "grad_norm": norms[1]}}}
        log(f"{label}: step {perf['step_ms']:.2f} ms, {perf['tok_s']} tok/s on {ranks} gloo "
            f"ranks; one rank without a mesh {ref['step_ms']:.2f} ms, {ref['tok_s']:.1f} "
            f"tok/s; exchanges a step a rank {perf['exchanges_a_step']:.1f}, "
            f"{perf['exchange_bytes_a_step'] / 2**20:.1f} MiB sent (each rank as much) "
            f"[{card}]")

        # run B (resume A at the checkpoint), then arm C (capacity factor
        # 1.0): one after the other, since 7d's ranks share the card
        later_runs = {}
        if spec["ckpt"]:
            later_runs["b"] = dict(cfg, overwrite=False,
                                   resume={"checkpoint": str(spec["ckpt"]), "strict": True},
                                   logging=dict(cfg["logging"],
                                                steps=dict(cfg["logging"]["steps"],
                                                           checkpoint_interval=0)))
        if spec["arm_steps"]:
            c = json.loads(json.dumps(cfg))
            c["name"] = cfg["name"] + "-capacity"
            c["model"]["moe"]["ep_capacity_factor"] = 1.0
            c["training"]["hyperparameters"]["iters"] = spec["arm_steps"]
            c["logging"]["steps"]["checkpoint_interval"] = 0
            later_runs["c"] = c
        done = {tag: ep_launch(tmp, run, spec, tag, device, timeout)
                for tag, run in later_runs.items()}

        if "b" in done:
            rc_b, wall_b, ev_b, out_b = done["b"]
            ev_b = ev_b[len(events):]
            losses_b = {e["step"]: e["loss"] for e in ev_b if e.get("type") == "step_window"}
            rel = {k: abs(x - losses[k]) / abs(losses[k]) for k, x in losses_b.items()}
            max_rel = max(rel.values()) if rel else float("nan")
            resume_bitwise = bool(rel) and all(losses_b[k] == losses[k] for k in rel)
            log(f"{label}: run B (resumed at {spec['ckpt']}) exit {rc_b} in {wall_b:.1f}s, "
                f"steps {sorted(losses_b)}; losses vs A: max relative difference "
                f"{max_rel:.3g}, bitwise {resume_bitwise}")
            if rc_b != 0 or sorted(losses_b) != list(range(spec["ckpt"] + 1, steps + 1)) \
                    or not max_rel <= 1e-5:
                failures.append(f"{label}: run B exit {rc_b}, losses {losses_b} vs A "
                                f"{losses}: {out_b[-2000:]}")
            perf["resume"] = {"max_rel_loss_diff": max_rel, "bitwise": resume_bitwise,
                              "run_b_s": wall_b}

        if "c" in done:
            rc_c, wall_c, ev_c, out_c = done["c"]
            win_c = [e for e in ev_c if e.get("type") == "step_window"]
            drops_c = logged_drops(os.path.join(tmp, "runs", c["name"]))
            end_c = next((e for e in ev_c if e.get("type") == "run_end"), {})
            total = end_c.get("moe_dropped_tokens_total")
            cap = ep_capacity(geo["tk"], ranks, 1.0)
            log(f"{label}: arm C (ep_capacity_factor 1.0: {cap} send slots a destination "
                f"for {geo['tk']} selections) exit {rc_c} in {wall_c:.1f}s; losses "
                f"{[e['loss'] for e in win_c]}; drops a step {drops_c}; "
                f"moe_dropped_tokens_total {total}")
            if rc_c != 0 or len(win_c) != spec["arm_steps"] or \
                    not all(math.isfinite(e["loss"]) for e in win_c) or \
                    sorted(drops_c) != list(range(1, spec["arm_steps"] + 1)) or \
                    not all(d > 0 for d in drops_c.values()) or \
                    total != sum(drops_c.values()):
                failures.append(f"{label}: arm C exit {rc_c}, drops {drops_c}, counter "
                                f"{total}: {out_c[-2000:]}")
            perf["capacity_arm"] = {"drops": drops_c, "moe_dropped_tokens_total": total,
                                    "losses": [e["loss"] for e in win_c], "run_c_s": wall_c}
    perf["seconds"] = time.perf_counter() - t_phase
    log(f"{label}: the phase took {perf['seconds']:.1f}s")
    return failures, perf


def ep_entries(ep_cases: dict, ep_perf: dict, card: str) -> list:
    """The kernels line's entries of phases 6c and 7d: the gmm and tgmm at
    each phase's per-rank shape, with rank 0's launches at that shape in
    the phase's run A and every rank's beside them. A gmm shape serves a
    forward and the other product's dX (gate/up's [D -> I] is down's dX
    shape), so each gmm entry counts both and holds both cases."""
    out = []
    for label, group in ep_cases.items():
        run = ep_perf.get(label) or {}
        ranks = run.get("ranks") or []
        bt, t_buf = group["geometry"]["block_t"], group["geometry"]["t_buf"]
        for kernel, cases in (("gmm", group["gmm"]), ("tgmm", group["tgmm"])):
            for c in cases:
                if "_dx_" in c["case"]:
                    continue
                K, N = c["shape"][1], c["shape"][2]
                key = f"wgmma:{t_buf}:{K}:{N}:{bt}"
                by_rank = [r.get(f"{kernel}_by_shape", {}).get(key, 0) for r in ranks]
                both = [c] + [d for d in cases if "_dx_" in d["case"]
                              and (d["shape"][1], d["shape"][2]) == (K, N)]
                entry = kernel_entry(f"{kernel}_wgmma:{c['case']}", SOURCE,
                                     REPLACES if kernel == "gmm" else TGMM_REPLACES,
                                     by_rank[0] if by_rank else 0, c,
                                     max(d["max_abs_err"] for d in both))
                entry.update(variant="wgmma", shape=c["shape"], block_t=bt,
                             launches_by_rank=by_rank, cases=both,
                             bound_real_ms=c["bound_real_ms"],
                             bound_buffer_ms=c["bound_buffer_ms"],
                             geometry=group["geometry"], library=c["library"],
                             path=f"{label}_{len(ranks)}_gloo_ranks", card=card)
                out.append(entry)
        if out:
            out[-1][f"{label}_phase"] = run
    return out


EP4["config"], EP8["config"] = config_moe_ep4, config_moe_1b


# -- phase 8: 100m-muon, the flex path, the other optimizers and the LR finder ----
def config_100m_muon(tmp: str, steps: int, warmup: int, ckpt: int) -> dict:
    """configs/model-config-100m-muon.yaml written out as a dict, with the
    smoke's cuts: ``iters``, ``warmup_steps`` (300 -> 10), a log line every
    step (of 10), a checkpoint every ``ckpt`` steps (of 1000), no interval
    validation, and the corpus paths. Every width is the config's."""
    return {
        "name": "Llama (100M) Muon", "overwrite": True,
        "data": {"input_file": os.path.join(tmp, "train.jsonl"),
                 "validation_file": os.path.join(tmp, "val.jsonl"),
                 "tokenizer_path": "tokenizer",
                 "preprocessing": {"max_context_size": 1024, "chunk_overlap": 0},
                 "tokenizer": {"normal_vocab_size": 256, "special_tokens": {
                     "pad": "<pad>", "bos": "<bos>", "eos": "<eos>"}}},
        "model": {"architecture": "llama",
                  "dimensions": {"hidden_size": 768, "intermediate_size": 2048,
                                 "num_layers": 12},
                  "attention": {"num_heads": 12, "num_kv_heads": 12, "head_dim": 64,
                                "max_position_embeddings": 1024,
                                "use_flash_attention": True},
                  "normalization": {"rms_norm_eps": 1.0e-5},
                  "rope": {"theta": 10000, "traditional": False, "scaling": None},
                  "misc": {"attention_bias": False, "mlp_bias": False,
                           "tie_word_embeddings": True}},
        "training": {"hyperparameters": {"batch_size": 32, "learning_rate": 2.0e-2,
                                         "weight_decay": 0.01, "gradient_clip": 1.0,
                                         "iters": steps},
                     "scheduler": {"type": "cosine_with_warmup", "warmup_steps": warmup,
                                   "min_lr_ratio": 0.05},
                     "optimization": {"optimizer": "muon", "momentum": 0.95,
                                      "nesterov": True, "ns_steps": 5,
                                      "adamw_lr_ratio": 0.015}},
        "logging": {"log_dir": "logs", "checkpoint_dir": "checkpoints",
                    "steps": {"logging_interval": 1, "checkpoint_interval": ckpt,
                              "validation_interval": 0}},
        "system": {"seed": 42, "mixed_precision": True, "precision": "bfloat16"},
    }


def config_1m_flex(tmp: str, steps: int) -> dict:
    """configs/model-config-1m-flex.yaml as a dict: flex attention with a
    128-token sliding window and ALiBi, 6 heads of 16, S 512, batch 16,
    Muon. Cut: ``iters`` (of 5000), a log line every 5 steps (of 10)."""
    return {
        "name": "Llama (1M) Flex", "overwrite": True,
        "data": {"input_file": os.path.join(tmp, "train.jsonl"),
                 "validation_file": os.path.join(tmp, "val.jsonl"),
                 "preprocessing": {"max_context_size": 512, "chunk_overlap": 0},
                 "tokenizer": {"normal_vocab_size": 256, "special_tokens": {
                     "pad": "<pad>", "bos": "<bos>", "eos": "<eos>"}}},
        "model": {"architecture": "llama",
                  "dimensions": {"hidden_size": 96, "intermediate_size": 256,
                                 "num_layers": 4},
                  "attention": {"num_heads": 6, "num_kv_heads": 6, "head_dim": 16,
                                "max_position_embeddings": 512,
                                "use_flex_attention": True,
                                "mask_type": "sliding_window", "window_size": 128,
                                "score_mod": "alibi"},
                  "normalization": {"rms_norm_eps": 1.0e-5},
                  "rope": {"theta": 10000, "traditional": False, "scaling": None},
                  "misc": {"attention_bias": False, "mlp_bias": False,
                           "tie_word_embeddings": True}},
        "training": {"hyperparameters": {"batch_size": 16, "learning_rate": 1.0e-2,
                                         "weight_decay": 0.01, "gradient_clip": 1.0,
                                         "iters": steps},
                     "scheduler": {"type": "cosine", "min_lr_ratio": 0.05},
                     "optimization": {"optimizer": "muon", "adamw_lr_ratio": 0.03}},
        "logging": {"log_dir": "logs", "checkpoint_dir": "checkpoints",
                    "steps": {"logging_interval": 5, "checkpoint_interval": 1000,
                              "validation_interval": 0}},
        "system": {"seed": 42, "mixed_precision": True},
    }


# configs/models/model-config-1m-*.yaml: one model section (hidden 128, 6
# layers, 4 heads of 32 over 2 KV heads, S 512, flash attention, bf16), each
# its own LR and optimization section; sgd and the unfused adamw are
# overrides of model-config-1m-adamw.yaml.
OPTIMIZER_CONFIGS = [
    ("adamw_enhanced", "model-config-1m-adamw-enhanced.yaml", 0.003,
     {"optimizer": "adamw_enhanced", "betas": [0.9, 0.95], "ema_decay": 0.999}),
    ("lion", "model-config-1m-lion.yaml", 0.0003,
     {"optimizer": "lion", "betas": [0.9, 0.99]}),
    ("shampoo", "model-config-1m-shampoo.yaml", 0.001,
     {"optimizer": "shampoo", "update_period": 10, "block_size": 128}),
    ("hybrid", "model-config-1m-hybrid.yaml", 0.015,
     {"optimizer": "hybrid", "matrix_optimizer": "muon", "non_matrix_optimizer": "adamw",
      "adamw_lr_ratio": 0.04}),
    ("sgd", "model-config-1m-adamw.yaml + optimizer sgd", 0.003,
     {"optimizer": "sgd", "betas": [0.9, 0.95]}),
    ("adamw_unfused", "model-config-1m-adamw.yaml + fused false", 0.003,
     {"optimizer": "adamw", "betas": [0.9, 0.95], "fused": False}),
]


def config_1m(tmp: str, name: str, lr: float, optimization: dict, steps: int) -> dict:
    """A configs/models/model-config-1m-*.yaml as a dict. Cut: ``iters``
    (of 2000), warmup (100 -> 2), a log line every step (of 4), no interval
    validation or checkpoint."""
    return {
        "name": f"Llama (1M) {name}", "overwrite": True,
        "data": {"input_file": os.path.join(tmp, "train.jsonl"),
                 "validation_file": os.path.join(tmp, "val.jsonl"),
                 "preprocessing": {"max_context_size": 512, "chunk_overlap": 0},
                 "tokenizer": {"normal_vocab_size": 256, "special_tokens": {
                     "pad": "<pad>", "bos": "<bos>", "eos": "<eos>"}}},
        "model": {"architecture": "llama",
                  "dimensions": {"hidden_size": 128, "intermediate_size": 512,
                                 "num_layers": 6},
                  "attention": {"num_heads": 4, "num_kv_heads": 2, "head_dim": 32,
                                "max_position_embeddings": 512,
                                "attention_type": "flash"},
                  "normalization": {"rms_norm_eps": 1.0e-5},
                  "rope": {"theta": 10000, "traditional": False, "scaling": None},
                  "misc": {"attention_bias": False, "mlp_bias": False,
                           "tie_word_embeddings": True}},
        "training": {"hyperparameters": {"batch_size": 16, "learning_rate": lr,
                                         "weight_decay": 0.01, "gradient_clip": 1.0,
                                         "iters": steps},
                     "scheduler": {"type": "cosine_with_warmup", "warmup_steps": 2,
                                   "min_lr_ratio": 0.05},
                     "optimization": dict(optimization)},
        "logging": {"log_dir": "logs", "checkpoint_dir": "checkpoints",
                    "steps": {"logging_interval": 1, "checkpoint_interval": 1000,
                              "validation_interval": 0}},
        "system": {"seed": 42, "mixed_precision": True, "precision": "bfloat16"},
    }


# bf16 at head dims 16 and 32 (1m-flex, the 1M configs): each kernel's variant
SMALL_D_VARIANTS = dict.fromkeys(FLASH_KERNELS, "wgmma")


def read_mods(fa) -> dict:
    return {n: dict(getattr(fa, n).launches_by_mod) for n in FLASH_KERNELS}


def flash_want(fa, variants: dict, mod: str, fwd: int, bwd: int):
    """Every launch of each flash kernel of a run on its variant
    (``variants[kernel]``) with one score mod."""
    zv, zm = dict.fromkeys(fa.FLASH_VARIANTS, 0), dict.fromkeys(fa.SCORE_MODS, 0)
    return ({"flash_fwd": {**zv, variants["flash_fwd"]: fwd},
             "flash_bwd_dq": {**zv, variants["flash_bwd_dq"]: bwd},
             "flash_bwd_dkv": {**zv, variants["flash_bwd_dkv"]: bwd}},
            {"flash_fwd": {**zm, mod: fwd}, "flash_bwd_dq": {**zm, mod: bwd},
             "flash_bwd_dkv": {**zm, mod: bwd}})


def flash_swaps(fa):
    return [(fa, n, getattr(fa, n + "_plain")) for n in FLASH_KERNELS]


def muon_phase(torch, gm, fa, card, steps: int = 30, warmup: int = 10, ckpt: int = 15,
               compare_to: int = 20):
    """100m-muon at full width: step-1 parity at batch 8, run A (``steps``
    steps, a checkpoint at ``ckpt``), then run B resumed from that
    checkpoint; B's steps ``ckpt + 1 .. compare_to`` must give A's losses."""
    import tempfile

    from mlx_cuda_distributed_pretraining_tpu_torch.config import Config
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer

    failures = []
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        t0 = time.perf_counter()
        write_corpus(tmp, train_bytes=1_100_000, val_bytes=70_000)
        cfg = config_100m_muon(tmp, steps, warmup, ckpt)
        runs = os.path.join(tmp, "runs")
        a = Trainer(Config.from_dict(cfg), runs_root=runs, quiet=True, device="cuda")
        log(f"muon: 100m-muon {a.n_params / 1e6:.2f}M params, "
            f"{a.flops_per_token / 1e6:.1f} MFLOP per token, "
            f"{len(a.data.train_rows)} train rows, {time.perf_counter() - t0:.1f}s to set up")
        par = first_step_parity(torch, a, 8, flash_swaps(fa))
        log(f"muon: step-1 parity at batch 8, kernels vs plain on the card: {par}")
        if not parity_ok(par):
            failures.append(f"muon: step-1 loss/gradients disagree with the plain path: {par}")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(gm, fa)  # count from here: run A only
        t0 = time.perf_counter()
        result = a.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, variants, mods = read_launches(gm, fa), read_variants(gm, fa), read_mods(fa)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        windows = a.windows
        losses = {w["step"]: w["loss"] for w in windows}
        layers, vb = a.model_args.num_layers, a.eval_batches
        want = {"gmm": 0, "tgmm": 0, "flash_fwd": layers * (steps + vb),
                "flash_bwd_dq": layers * steps, "flash_bwd_dkv": layers * steps}
        want_v, want_m = flash_want(fa, dict.fromkeys(FLASH_KERNELS, "wgmma"), "none",
                                    want["flash_fwd"], want["flash_bwd_dq"])
        flash_v = {n: variants[n] for n in FLASH_KERNELS}
        log(f"muon: run A {steps} steps + {vb} validation batches in {wall:.1f}s; "
            f"losses {[round(losses[s], 5) for s in sorted(losses)]}; launches {launches}; "
            f"flash by variant {flash_v} by mod {mods}")
        first, last = losses.get(1), losses.get(steps)
        if len(losses) != steps or not all(math.isfinite(x) for x in losses.values()):
            failures.append(f"muon: bad loss log {losses}")
        elif not last < 0.9 * first:
            failures.append(f"muon: loss did not fall below 0.9x the first ({first} -> {last})")
        if launches != want or flash_v != want_v or mods != want_m:
            failures.append(f"muon: launches {launches} {flash_v} {mods} != {want} "
                            f"{want_v} {want_m}")
        if result["final_val_loss"] is None:
            failures.append("muon: no validation ran")

        # run B: resume from the step-`ckpt` checkpoint, continue to `steps`
        cfg_b = dict(cfg, overwrite=False, resume={"checkpoint": str(ckpt)})
        b = Trainer(Config.from_dict(cfg_b), runs_root=runs, quiet=True, device="cuda")
        start = b.start_step
        b.train()
        b_losses = {w["step"]: w["loss"] for w in b.windows}
        compared = list(range(ckpt + 1, compare_to + 1))
        rel = {s: abs(b_losses.get(s, float("nan")) - losses[s]) / abs(losses[s])
               for s in compared}
        max_rel = max(rel.values())
        bitwise = all(b_losses.get(s) == losses[s] for s in compared)
        rest = {s: b_losses.get(s) == losses[s] for s in range(compare_to + 1, steps + 1)}
        log(f"muon: run B resumed from checkpoint {ckpt} at step {start}; steps "
            f"{compared[0]}-{compared[-1]} max relative loss difference {max_rel:.3g} "
            f"(bitwise {bitwise}); steps {compare_to + 1}-{steps} bitwise "
            f"{all(rest.values())}")
        if start != ckpt or not max_rel <= 1e-5:
            failures.append(f"muon: resume from {ckpt} started at {start}, steps "
                            f"{compared} relative differences {rel}")
        flops_per_token = a.flops_per_token
        del a, b
    torch.cuda.empty_cache()

    steady = windows[1:]  # the first window holds the first step's warm-up
    step_ms = sorted(1e3 * w["seconds"] / w["steps"] for w in steady)
    secs = sum(w["seconds"] for w in steady)
    tok_s = sum(w["toks"] for w in steady) / secs
    perf = {"step_ms": 1e3 * secs / sum(w["steps"] for w in steady),
            "step_ms_median": step_ms[len(step_ms) // 2],
            "tok_s": tok_s,
            "mfu_vs_989tflops": tok_s * flops_per_token / PEAK_FLOPS["bfloat16"],
            "flops_per_token": flops_per_token, "peak_mem_gb": peak_gb,
            "first_window_s": windows[0]["seconds"], "losses": losses,
            "launches": launches, "launches_by_variant": flash_v, "launches_by_mod": mods,
            "first_step_parity": par,
            "resume": {"from": ckpt, "started_at": start, "compared_steps": compared,
                       "max_rel_loss_diff": max_rel, "bitwise": bitwise}}
    for k in ("step_ms", "step_ms_median", "tok_s", "mfu_vs_989tflops", "peak_mem_gb"):
        log(f"muon: {k}={perf[k]} [{card}]")
    return failures, perf


def flex_phase(torch, gm, fa, card, steps: int = 30):
    """1m-flex at full width through ``Trainer.train()``: every attention
    launch with the alibi code, on the wgmma kernels (D 16)."""
    import tempfile

    from mlx_cuda_distributed_pretraining_tpu_torch.config import Config
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer

    failures = []
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        write_corpus(tmp, train_bytes=400_000, val_bytes=40_000)
        tr = Trainer(Config.from_dict(config_1m_flex(tmp, steps)),
                     runs_root=os.path.join(tmp, "runs"), quiet=True, device="cuda")
        par = first_step_parity(torch, tr, 8, flash_swaps(fa))
        log(f"flex: 1m-flex {tr.n_params / 1e6:.3f}M params; step-1 parity at batch 8, "
            f"kernels vs plain: {par}")
        if not parity_ok(par):
            failures.append(f"flex: step-1 loss/gradients disagree with the plain path: {par}")
        torch.cuda.synchronize()
        reset_launches(gm, fa)
        t0 = time.perf_counter()
        tr.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, variants, mods = read_launches(gm, fa), read_variants(gm, fa), read_mods(fa)
        losses = [w["loss"] for w in tr.windows]
        layers, vb = tr.model_args.num_layers, tr.eval_batches
        want_v, want_m = flash_want(fa, SMALL_D_VARIANTS, "alibi", layers * (steps + vb),
                                    layers * steps)
        flash_v = {n: variants[n] for n in FLASH_KERNELS}
        log(f"flex: {steps} steps + {vb} validation batches in {wall:.1f}s; losses every "
            f"5 steps {losses}; flash by variant {flash_v} by mod {mods}")
        if len(losses) != steps // 5 or not all(math.isfinite(x) for x in losses):
            failures.append(f"flex: bad loss log {losses}")
        elif not losses[-1] < 0.9 * losses[0]:
            failures.append(f"flex: loss did not fall below 0.9x the first "
                            f"({losses[0]} -> {losses[-1]})")
        if flash_v != want_v or mods != want_m or launches["gmm"] or launches["tgmm"]:
            failures.append(f"flex: launches {flash_v} {mods} != {want_v} {want_m}")
        steady = tr.windows[1:]
        perf = {"step_ms": 1e3 * sum(w["seconds"] for w in steady)
                / sum(w["steps"] for w in steady),
                "losses": losses, "launches": launches, "launches_by_variant": flash_v,
                "launches_by_mod": mods, "first_step_parity": par}
        del tr
    log(f"flex: step_ms={perf['step_ms']} [{card}]")
    return failures, perf


def optimizers_phase(torch, gm, fa, card, steps: int = 10, finder_steps: int = 20,
                     after_finder: int = 5):
    """The 1M configs' optimizers at full width (flash at D 32 on the wgmma
    kernels): ``steps`` steps each with finite
    losses and step-1 parity; then model-config-1m-muon.yaml with the LR
    finder on."""
    import re
    import tempfile

    from mlx_cuda_distributed_pretraining_tpu_torch.config import Config
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer

    failures, runs = [], {}
    totals = {"variants": None, "mods": None}

    def tally():
        v, m = read_variants(gm, fa), read_mods(fa)
        for key, new in (("variants", {n: v[n] for n in FLASH_KERNELS}), ("mods", m)):
            if totals[key] is None:
                totals[key] = new
            else:
                totals[key] = {n: {k: totals[key][n][k] + c for k, c in new[n].items()}
                               for n in FLASH_KERNELS}

    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        write_corpus(tmp, train_bytes=400_000, val_bytes=40_000)
        for label, source, lr, optimization in OPTIMIZER_CONFIGS:
            tr = Trainer(Config.from_dict(config_1m(tmp, label, lr, optimization, steps)),
                         runs_root=os.path.join(tmp, "runs"), quiet=True, device="cuda")
            par = first_step_parity(torch, tr, 8, flash_swaps(fa))
            reset_launches(gm, fa)
            t0 = time.perf_counter()
            tr.train()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            tally()
            losses = [w["loss"] for w in tr.windows]
            layers, vb = tr.model_args.num_layers, tr.eval_batches
            want_v, want_m = flash_want(fa, SMALL_D_VARIANTS, "none", layers * (steps + vb),
                                        layers * steps)
            got_v = {n: read_variants(gm, fa)[n] for n in FLASH_KERNELS}
            ok = (len(losses) == steps and all(math.isfinite(x) for x in losses)
                  and parity_ok(par) and got_v == want_v and read_mods(fa) == want_m)
            runs[label] = {"config": source, "losses": losses, "first_step_parity": par,
                           "seconds": wall, "ok": ok}
            log(f"optimizers: {label} ({source}): {steps} steps in {wall:.1f}s, losses "
                f"{[round(x, 4) for x in losses]}; step-1 parity {par}; ok={ok}")
            if not ok:
                failures.append(f"optimizers: {label}: losses {losses}, parity {par}, "
                                f"flash {got_v} {read_mods(fa)}")
            del tr

        # model-config-1m-muon.yaml with the LR finder on: the sweep, its
        # suggestion adopted, then steps at it
        cfg = config_1m(tmp, "muon lr_finder", 0.015,
                        {"optimizer": "muon", "adamw_lr_ratio": 0.04}, after_finder)
        cfg["training"]["lr_finder"] = {"enabled": True, "num_steps": finder_steps}
        tr = Trainer(Config.from_dict(cfg), runs_root=os.path.join(tmp, "runs"),
                     quiet=True, device="cuda")
        reset_launches(gm, fa)
        t0 = time.perf_counter()
        tr.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tally()
        text = open(os.path.join(tr.run_dir, "log.txt")).read()
        found = re.search(r"LR finder suggestion: ([0-9.eE+-]+)", text)
        suggested = float(found.group(1)) if found else None
        losses = [w["loss"] for w in tr.windows]
        adopted = tr.config.training.learning_rate
        sweep = open(os.path.join(tr.run_dir, "lr_finder.csv")).read().splitlines()[1:] \
            if os.path.exists(os.path.join(tr.run_dir, "lr_finder.csv")) else []
        ok = (suggested is not None and abs(adopted - suggested) <= 1e-3 * suggested
              and len(losses) == after_finder and all(math.isfinite(x) for x in losses)
              and 4 <= len(sweep) <= finder_steps)
        runs["lr_finder"] = {"config": "model-config-1m-muon.yaml + lr_finder",
                             "sweep_points": len(sweep), "suggested": suggested,
                             "adopted_lr": adopted, "losses": losses, "seconds": wall,
                             "ok": ok}
        log(f"optimizers: lr_finder on 1m-muon: {len(sweep)} sweep points, suggestion "
            f"{suggested}, adopted LR {adopted}; {after_finder} steps at it: losses "
            f"{[round(x, 4) for x in losses]} in {wall:.1f}s; ok={ok}")
        if not ok:
            failures.append(f"optimizers: lr_finder {runs['lr_finder']}")
        del tr
    perf = {"runs": runs, "launches_by_variant": totals["variants"],
            "launches_by_mod": totals["mods"]}
    log(f"optimizers: flash launches by variant {totals['variants']} [{card}]")
    return failures, perf


# -- phase 9: 80m-fineweb on streaming data -------------------------------------------
STREAM_STEPS, STREAM_WARMUP, STREAM_CKPT, STREAM_SHORT = 30, 10, 15, 5


def config_80m_fineweb(shards, steps: int, ckpt: int, prefetch_depth: int = 2,
                       data=None) -> dict:
    """configs/model-config-80m-fineweb.yaml written out as a dict. Changed
    (each printed as ``reduced``): the data source (local JSONL and
    WebDataset tar shards through ``data.streaming.shards`` in place of the
    hub's FineWeb-Edu stream; ``data`` replaces the section for the
    token-shard run), ``iters`` (20000), ``warmup_steps`` (500), the
    checkpoint interval (2000) and the depth (12 layers -> 6);
    ``data.prefetch_depth`` is the default 2 unless a run sets 0. Every
    width, the batch, Muon and every other key are the config's (``system.device: "tpu"`` left out, as in the other
    phases)."""
    return {
        "name": "Llama (80M) FineWeb", "overwrite": True,
        "data": data or {
            "source": "jsonl",
            "streaming": {"shards": shards, "split": "train", "shuffle_buffer": 10000},
            "input_file": None, "validation_file": "val.jsonl",
            "tokenizer_path": "tokenizer",
            "preprocessing": {"max_context_size": 2048, "chunk_overlap": 0},
            "tokenizer": {"normal_vocab_size": 256, "special_tokens": {
                "pad": "<pad>", "bos": "<bos>", "eos": "<eos>"}},
            "prefetch_depth": prefetch_depth},
        "model": {"architecture": "llama",
                  "dimensions": {"hidden_size": 1024, "intermediate_size": 2816,
                                 "num_layers": DEPTH_80M},
                  "attention": {"num_heads": 16, "num_kv_heads": 8, "head_dim": 64,
                                "max_position_embeddings": 2048,
                                "use_flash_attention": True},
                  "normalization": {"rms_norm_eps": 1.0e-5},
                  "rope": {"theta": 10000, "traditional": False, "scaling": None},
                  "misc": {"attention_bias": False, "mlp_bias": False,
                           "tie_word_embeddings": True}},
        "training": {"hyperparameters": {"batch_size": 32, "learning_rate": 1.5e-2,
                                         "weight_decay": 0.01, "gradient_clip": 1.0,
                                         "iters": steps},
                     "scheduler": {"type": "cosine_with_warmup",
                                   "warmup_steps": STREAM_WARMUP, "min_lr_ratio": 0.05},
                     "optimization": {"optimizer": "muon", "adamw_lr_ratio": 0.02}},
        "logging": {"log_dir": "logs", "checkpoint_dir": "checkpoints",
                    "steps": {"logging_interval": 10, "checkpoint_interval": ckpt,
                              "validation_interval": 1000},
                    "metrics": {"log_loss": True, "log_perplexity": True,
                                "log_tokens_per_second": True}},
        "system": {"seed": 42, "mixed_precision": True, "precision": "bfloat16"},
    }


DEPTH_80M = 6  # of the config's 12: the whole smoke's time limit
REDUCED_80M = [
    "data.source hf_stream (HuggingFaceFW/fineweb-edu, sample-10BT) -> jsonl over "
    "data.streaming.shards: 4 local JSONL shards and 1 WebDataset tar shard of seeded "
    "synthetic text (shuffle_buffer 10000 and split kept); run D: token_shards written "
    "from the same documents by write_token_shards",
    f"training.hyperparameters.iters 20000 -> {STREAM_STEPS} (runs A, E; B resumes "
    f"to {STREAM_STEPS}; runs C, D {STREAM_SHORT})",
    f"training.scheduler.warmup_steps 500 -> {STREAM_WARMUP}",
    f"logging.steps.checkpoint_interval 2000 -> {STREAM_CKPT}",
    "data.prefetch_depth: the default 2 (runs A, B, D), 0 (runs C, E)",
    f"model.dimensions.num_layers 12 -> {DEPTH_80M}",
]


def stream_corpus(tmp: str, n_jsonl: int = 4, shard_bytes: int = 700_000):
    """Seeded synthetic text in ``n_jsonl`` JSONL shards and one WebDataset
    tar shard (a ``.txt`` member a document), ``shard_bytes`` of text each:
    documents of sentences over a Zipf-weighted vocabulary, as
    ``write_corpus`` makes them. Returns (shard paths, documents)."""
    import io
    import tarfile

    import numpy as np

    rng = np.random.default_rng(SEED + 80)
    syll = ["ka", "lo", "mi", "ne", "su", "ta", "ri", "po", "an", "el", "or", "ve"]
    words = ["".join(rng.choice(syll, size=int(rng.integers(1, 4)))) for _ in range(96)]
    weights = 1.0 / np.arange(1, len(words) + 1)
    weights /= weights.sum()

    def doc():
        sentences = []
        for _ in range(int(rng.integers(4, 40))):
            ids = rng.choice(len(words), size=int(rng.integers(4, 16)), p=weights)
            sentences.append(" ".join(words[i] for i in ids).capitalize() + ".")
        return " ".join(sentences)

    shards, docs = [], []
    for i in range(n_jsonl + 1):
        texts, total = [], 0
        while total < shard_bytes:
            texts.append(doc())
            total += len(texts[-1])
        docs += texts
        if i < n_jsonl:
            path = os.path.join(tmp, f"shard_{i:02d}.jsonl")
            with open(path, "w") as f:
                f.write("".join(json.dumps({"text": t}) + "\n" for t in texts))
        else:
            path = os.path.join(tmp, f"shard_{i:02d}.tar")
            with tarfile.open(path, "w") as tf:
                for j, t in enumerate(texts):
                    data = t.encode()
                    info = tarfile.TarInfo(f"{j:06d}.txt")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
        shards.append(path)
    return shards, docs


_WEIGHTS = {}


def batch_checksums(torch, batch) -> dict:
    """Position-weighted int64 sums of each array of a batch: numpy on the
    host, torch on the device (exact on both: integer sums far below
    2**63)."""
    import numpy as np

    out = {}
    for k, v in batch.items():
        shape = tuple(v.shape)
        if isinstance(v, np.ndarray):
            w = (np.arange(v.size, dtype=np.int64) % 65521 + 1).reshape(shape)
            out[k] = int((v.astype(np.int64) * w).sum())
        else:
            w = _WEIGHTS.get((shape, v.device))
            if w is None:
                w = _WEIGHTS[(shape, v.device)] = (torch.arange(
                    v.numel(), device=v.device, dtype=torch.int64) % 65521 + 1).view(shape)
            out[k] = (v.long() * w).sum()
    return out


class StepRecorder:
    """Wraps a trainer's ``train_step`` and its loader's ``generate_batch``:
    each step's loss tensor, its batch's checksums on the device before and
    after the step (a batch overwritten while the step reads it changes the
    second), a CUDA event at each step's start, and the host checksums of
    every batch the loader handed out, in order. Reads the device only in
    :meth:`finish`."""

    def __init__(self, torch, trainer):
        self.torch, self.losses, self.device_sums, self.host_sums, self.events = \
            torch, [], [], [], []
        step_fn, fetch = trainer.train_step, trainer.data.generate_batch

        def train_step(state, batch):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            before = batch_checksums(torch, batch)
            state, metrics = step_fn(state, batch)
            self.device_sums.append((before, batch_checksums(torch, batch)))
            self.losses.append(metrics["loss"].detach())
            self.events.append(ev)
            return state, metrics

        def generate_batch(step):
            b = fetch(step)
            self.host_sums.append(batch_checksums(torch, b))
            return b

        trainer.train_step = train_step
        trainer.data.generate_batch = generate_batch

    def finish(self, first_step: int) -> dict:
        """Losses by step, the device's ms between consecutive step starts,
        and the checksum comparison."""
        self.torch.cuda.synchronize()
        losses = {first_step + i: float(x) for i, x in enumerate(self.losses)}
        gaps = [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]
        bad = [i for i, (before, after) in enumerate(self.device_sums)
               if i >= len(self.host_sums)
               or any(int(before[k]) != self.host_sums[i][k]
                      or int(after[k]) != self.host_sums[i][k] for k in before)]
        return {"losses": losses, "step_gap_ms": gaps, "checked": len(self.device_sums),
                "fetched": len(self.host_sums), "checksum_mismatches": bad}


def stream_run(torch, cfg: dict, runs: str, label: str) -> dict:
    """One Trainer.train() on the card with a StepRecorder; the run's
    numbers, its windows and its step-15 data position (when saved)."""
    from mlx_cuda_distributed_pretraining_tpu_torch.config import Config
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer

    tr = Trainer(Config.from_dict(cfg), runs_root=runs, quiet=True, device="cuda")
    start = tr.start_step
    rec = StepRecorder(torch, tr)
    t0 = time.perf_counter()
    result = tr.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = rec.finish(start + 1)
    steady = tr.windows[1:] or tr.windows  # the first window holds step 1's set-up
    secs = sum(w["seconds"] for w in steady)
    steps = max(sum(w["steps"] for w in steady), 1)
    first = tr.windows[0] if tr.windows else {"data_wait_s": 0.0, "h2d_wait_s": 0.0}
    gaps = sorted(out["step_gap_ms"][1:] or out["step_gap_ms"])
    state_path = os.path.join(tr.run_dir, "checkpoints", f"step_{STREAM_CKPT}_state.json")
    state = None
    if os.path.isfile(state_path) and start < STREAM_CKPT:
        with open(state_path) as f:
            state = {k: v for k, v in json.load(f).items()
                     if k in ("step", "total_tokens", "docs_consumed", "buf", "source")}
    out.update(
        label=label, start_step=start, wall_s=wall, result=result,
        prefetch_depth=tr.prefetcher.depth, eval_batches=tr.eval_batches,
        window_losses={w["step"]: w["loss"] for w in tr.windows},
        step_ms=1e3 * secs / steps,
        step_ms_median_events=gaps[len(gaps) // 2] if gaps else None,
        tok_s=sum(w["toks"] for w in steady) / secs if secs else None,
        data_wait_ms_per_step=1e3 * sum(w["data_wait_s"] for w in steady) / steps,
        h2d_ms_per_step=1e3 * sum(w["h2d_wait_s"] for w in steady) / steps,
        first_window_data_wait_ms=1e3 * first["data_wait_s"],
        first_window_h2d_ms=1e3 * first["h2d_wait_s"],
        h2d_blocks_step_loop=tr.prefetcher.h2d_blocks_consumer,
        docs_consumed=getattr(tr.data, "docs_consumed", None),
        flops_per_token=tr.flops_per_token, n_params=tr.n_params,
        vocab_size=tr.model_args.vocab_size, state_at_ckpt=state)
    if out["tok_s"]:
        out["mfu_vs_989tflops"] = out["tok_s"] * tr.flops_per_token / PEAK_FLOPS["bfloat16"]
    log(f"stream: run {label}: steps {start + 1}-{start + len(out['losses'])} in {wall:.1f}s "
        f"(prefetch_depth {out['prefetch_depth']}); losses "
        f"{[round(x, 5) for x in out['losses'].values()]}; {out['checked']} batches "
        f"checked against {out['fetched']} fetched, mismatches {out['checksum_mismatches']}")
    del tr, rec
    torch.cuda.empty_cache()
    return out


def streaming_phase(torch, gm, fa, card, steps: int = STREAM_STEPS, ckpt: int = STREAM_CKPT,
                    short: int = STREAM_SHORT):
    """80m-fineweb at full width on local streaming shards: the native
    dataplane against the Python packer; the producer's documents per
    second; step-1 parity at batch 8; run A (prefetch 2, ``steps`` steps, a
    checkpoint at ``ckpt``), run E (prefetch 0, the same), run B (resumes
    A from ``ckpt``), run C (prefetch 0, ``short`` steps), run D
    (token shards of the same documents, ``short`` steps). Every consumed
    batch is held against the host batch by checksum."""
    import tempfile

    import numpy as np

    from mlx_cuda_distributed_pretraining_tpu_torch import native
    from mlx_cuda_distributed_pretraining_tpu_torch.config import Config
    from mlx_cuda_distributed_pretraining_tpu_torch.data.packing import (
        chunk_tokens,
        pack_documents,
    )
    from mlx_cuda_distributed_pretraining_tpu_torch.data.streaming import build_data_manager
    from mlx_cuda_distributed_pretraining_tpu_torch.data.token_shards import (
        write_token_shards,
    )
    from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import TokenizerManager

    failures, perf = [], {"card": card, "reduced": REDUCED_80M}
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        t0 = time.perf_counter()
        shards, docs = stream_corpus(tmp)
        cfg_a = config_80m_fineweb(shards, steps, ckpt)
        tok = TokenizerManager(Config.from_dict(cfg_a).data)
        B = cfg_a["training"]["hyperparameters"]["batch_size"]
        S = cfg_a["data"]["preprocessing"]["max_context_size"]
        log(f"stream: 80m-fineweb corpus: {len(docs)} documents, "
            f"{sum(map(len, docs)) / 1e6:.2f} MB in {len(shards)} shards "
            f"({time.perf_counter() - t0:.1f}s)")
        for line in REDUCED_80M:
            log(f"stream: reduced: {line}")

        # the native dataplane against the Python packer, at the path's rows
        if not native.available():
            failures.append(f"stream: the native dataplane did not build: "
                            f"{native.build_error()}")
        else:
            byte = tok.tokenizer
            t0 = time.perf_counter()
            rows = native.byte_pack_docs(docs, byte.normal_vocab_size, byte.bos_id,
                                         byte.eos_id, byte.pad_id, row_len=S + 1)
            native_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            chunks = []
            for text in docs:
                chunks.extend(chunk_tokens(tok.tokenize_doc(text, max_length=10**9), S + 1, 0))
            py_rows = pack_documents(chunks, S, tok.pad_id)
            python_s = time.perf_counter() - t0
            same = rows is not None and rows.shape == py_rows.shape \
                and bool(np.array_equal(rows, py_rows))
            perf["native"] = {"rows": int(py_rows.shape[0]), "equal": same,
                              "native_s": native_s, "python_s": python_s,
                              "library": native.library_path().name}
            log(f"stream: native dataplane {native.library_path().name}: "
                f"{py_rows.shape[0]} rows of {S + 1}, equal to the Python path {same}; "
                f"native {native_s * 1e3:.1f} ms, Python {python_s * 1e3:.1f} ms "
                f"({python_s / native_s:.1f}x)")
            if not same:
                failures.append("stream: the native dataplane's rows differ from Python's")

        # the producer alone: 40 batches from a loader on the same shards
        probe = build_data_manager(Config.from_dict(cfg_a), tok, B, seq_len=S, seed=42)
        t0 = time.perf_counter()
        first = probe.generate_batch(0)
        for i in range(1, 40):
            probe.generate_batch(i)
        secs = time.perf_counter() - t0
        consumed = probe.state_dict()["docs_consumed"]
        probe.stop()
        perf["producer"] = {"batches": 40, "seconds": secs, "docs": consumed,
                            "docs_per_s": consumed / secs,
                            "tokens_per_s": 40 * B * S / secs}
        log(f"stream: producer alone: 40 batches, {consumed} documents in {secs:.2f}s: "
            f"{consumed / secs:.0f} docs/s, {40 * B * S / secs:.0f} tok/s [{card}]")

        from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer

        a0 = Trainer(Config.from_dict(dict(cfg_a, name="parity")),
                     runs_root=os.path.join(tmp, "parity"), quiet=True, device="cuda")
        log(f"stream: 80m-fineweb {a0.n_params / 1e6:.2f}M params, "
            f"{a0.flops_per_token / 1e6:.1f} MFLOP per token, vocabulary "
            f"{a0.model_args.vocab_size}")
        par = first_step_parity(torch, a0, 8, flash_swaps(fa), host_batch=first)
        a0.data.stop()
        del a0
        torch.cuda.empty_cache()
        log(f"stream: step-1 parity at batch 8, kernels vs plain on the card: {par}")
        if not parity_ok(par):
            failures.append(f"stream: step-1 loss/gradients disagree with the plain path: {par}")
        perf["first_step_parity"] = par

        runs = os.path.join(tmp, "runs")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(gm, fa)  # count from here: runs A-E only
        a = stream_run(torch, cfg_a, runs, "A")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        e = stream_run(torch, config_80m_fineweb(shards, steps, ckpt, prefetch_depth=0),
                       os.path.join(tmp, "runs_e"), "E")
        b = stream_run(torch, dict(cfg_a, overwrite=False,
                                   resume={"checkpoint": str(ckpt)}), runs, "B")
        c = stream_run(torch, config_80m_fineweb(shards, short, 0, prefetch_depth=0),
                       os.path.join(tmp, "runs_c"), "C")
        shard_dir = os.path.join(tmp, "token_shards")
        index = write_token_shards(iter(docs), tok, shard_dir, shard_tokens=1 << 20)
        data_d = dict(config_80m_fineweb(shards, short, 0)["data"], source="token_shards",
                      input_file=shard_dir, streaming={})
        d = stream_run(torch, config_80m_fineweb(shards, short, 0, data=data_d),
                       os.path.join(tmp, "runs_d"), "D")
        launches, variants, mods = read_launches(gm, fa), read_variants(gm, fa), read_mods(fa)
    torch.cuda.empty_cache()

    runs_ = {"A": a, "E": e, "B": b, "C": c, "D": d}
    layers = cfg_a["model"]["dimensions"]["num_layers"]
    n_steps = sum(len(r["losses"]) for r in runs_.values())
    want = {"gmm": 0, "tgmm": 0, "flash_fwd": layers * (n_steps + d["eval_batches"]),
            "flash_bwd_dq": layers * n_steps, "flash_bwd_dkv": layers * n_steps}
    want_v, want_m = flash_want(fa, dict.fromkeys(FLASH_KERNELS, "wgmma"), "none",
                                want["flash_fwd"], want["flash_bwd_dq"])
    flash_v = {n: variants[n] for n in FLASH_KERNELS}
    log(f"stream: launches {launches}; flash by variant {flash_v} by mod {mods}")
    if launches != want or flash_v != want_v or mods != want_m:
        failures.append(f"stream: launches {launches} {flash_v} {mods} != {want} "
                        f"{want_v} {want_m}")
    for label, r in runs_.items():
        n = {"A": steps, "E": steps, "B": steps - ckpt, "C": short, "D": short}[label]
        if len(r["losses"]) != n or not all(math.isfinite(x) for x in r["losses"].values()):
            failures.append(f"stream: run {label} losses {r['losses']} (want {n} finite)")
        if r["checksum_mismatches"] or r["checked"] != n or r["fetched"] < n:
            failures.append(f"stream: run {label}: batches checked {r['checked']}, fetched "
                            f"{r['fetched']}, checksum mismatches at {r['checksum_mismatches']}")

    def compare(label, other, steps_):
        rel = {s: abs(other["losses"].get(s, float("nan")) - a["losses"][s])
               / abs(a["losses"][s]) for s in steps_}
        worst = max(rel.values())
        bitwise = all(other["losses"].get(s) == a["losses"][s] for s in steps_)
        log(f"stream: run {label} vs A, steps {steps_[0]}-{steps_[-1]}: max relative loss "
            f"difference {worst:.3g} (bitwise {bitwise})")
        if not worst <= 1e-5:
            failures.append(f"stream: run {label} losses differ from run A's: {rel}")
        return {"steps": [steps_[0], steps_[-1]], "max_rel_loss_diff": worst,
                "bitwise": bitwise}

    perf["resume"] = dict(compare("B", b, list(range(ckpt + 1, steps + 1))),
                          started_at=b["start_step"])
    if b["start_step"] != ckpt:
        failures.append(f"stream: run B resumed at step {b['start_step']}, not {ckpt}")
    perf["prefetch_off_short"] = compare("C", c, list(range(1, short + 1)))
    perf["prefetch_off_full"] = compare("E", e, list(range(1, steps + 1)))
    same_state = a["state_at_ckpt"] is not None and a["state_at_ckpt"] == e["state_at_ckpt"]
    log(f"stream: step-{ckpt} data position, prefetch 2 (A) == prefetch 0 (E): {same_state}; "
        f"A's: docs_consumed {(a['state_at_ckpt'] or {}).get('docs_consumed')}, source "
        f"{(a['state_at_ckpt'] or {}).get('source')}")
    if not same_state:
        failures.append("stream: the step-15 data position depends on the prefetch depth")
    logged = [a["window_losses"][s] for s in sorted(a["window_losses"])]
    if not logged[-1] < 0.9 * logged[0]:
        failures.append(f"stream: loss did not fall below 0.9x the first logged "
                        f"({logged[0]} -> {logged[-1]})")
    log(f"stream: run D on token shards ({index['total_tokens']} tokens in "
        f"{len(index['files'])} shards, vocabulary {d['vocab_size']} from the index): "
        f"losses {[round(x, 4) for x in d['losses'].values()]}, "
        f"{d['eval_batches']} validation batches, final val_loss "
        f"{d['result']['final_val_loss']}")
    if d["vocab_size"] != index["vocab_size"] or d["result"]["final_val_loss"] is None:
        failures.append(f"stream: run D vocabulary {d['vocab_size']} / validation "
                        f"{d['result']['final_val_loss']}")
    for label, r in (("prefetch 2 (run A)", a), ("prefetch 0 (run E)", e)):
        log(f"stream: {label}: step_ms={r['step_ms']:.2f} (median between step starts "
            f"{r['step_ms_median_events']:.2f}) tok_s={r['tok_s']:.0f} "
            f"mfu_vs_989tflops={r['mfu_vs_989tflops']:.4f} "
            f"data_wait_ms_per_step={r['data_wait_ms_per_step']:.3f} "
            f"h2d_ms_per_step={r['h2d_ms_per_step']:.3f} "
            f"(on the step loop's path: {r['h2d_blocks_step_loop']}; the first window's "
            f"data_wait {r['first_window_data_wait_ms']:.1f} ms, h2d "
            f"{r['first_window_h2d_ms']:.1f} ms) [{card}]")
    log(f"stream: peak_mem_gb={peak_gb:.2f} (run A) [{card}]")
    log(f"stream: producer docs_per_s={perf['producer']['docs_per_s']:.0f} alone; in run A "
        f"{a['docs_consumed']} documents in {a['wall_s']:.1f}s [{card}]")
    keep = ("losses", "step_gap_ms", "checked", "fetched", "checksum_mismatches",
            "start_step", "wall_s", "prefetch_depth", "eval_batches", "step_ms",
            "step_ms_median_events", "tok_s", "mfu_vs_989tflops", "data_wait_ms_per_step",
            "h2d_ms_per_step", "first_window_data_wait_ms", "first_window_h2d_ms",
            "h2d_blocks_step_loop", "docs_consumed", "vocab_size")
    perf.update(runs={k: {f: r.get(f) for f in keep} for k, r in runs_.items()},
                peak_mem_gb=peak_gb, launches=launches, launches_by_variant=flash_v,
                launches_by_mod=mods, flops_per_token=a["flops_per_token"],
                n_params=a["n_params"], token_shards=index)
    return failures, perf


def kernel_entry(name, source, replaces, launches, row, max_abs_err):
    """One kernel of the report line; ``earlier_ms`` is the kernel that
    served the path before it, where this run timed one in turns with it."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_abs_err, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "earlier_ms": row.get("earlier_ms")}


def main() -> int:
    os.environ[RUN_ID_VAR] = f"{os.getpid()}-{time.time_ns()}"
    # torch.compile's caches (the flex_attention yardstick) stay in the checkout
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(REPO, "build", "compile_cache", sub))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import flash_attention as fa
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import grouped_matmul as gm
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import kernel_check
    from mlx_cuda_distributed_pretraining_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f" | {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    warm = threading.Thread(target=warm_flex, args=(torch,), daemon=True)
    warm.start()  # the soft_cap yardstick compiles while nvcc runs
    srcs = (gm._SRC, fa._SRC, fa._SRC_F32)
    libs = cuda_build.build_libraries(srcs)
    log(f"build: the three sources in {time.perf_counter() - t0:.1f}s")
    warm.join(timeout=600)  # nothing else runs on the card while the phases time it
    log(f"build: with the soft_cap yardstick's compile beside it, {time.perf_counter() - t0:.1f}s")
    failures = []
    for lib, src in zip(libs, srcs):
        secs = cuda_build.BUILD_SECONDS.get(src.name)
        log(f"build: {lib.name} in "
            + (f"{secs:.1f}s" if secs is not None else "0s (already built)"))
        kernel = None
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                log(f"build: {(kernel or '')[-60:]}: {line.strip()}")
                if "wgmma" in (kernel or "") and " 0 bytes spill stores" not in line \
                        and "spill stores" in line:
                    failures.append(f"build: {kernel[-60:]} spills: {line.strip()}")
            if any(c in line for c in ("C7513", "C7518", "C7520")):  # ptxas serialized every wgmma
                log(f"build: {line.strip()}")
                failures.append(f"build: {line.strip()[:200]}")

    fsdp_failures, fsdp_perf = fsdp_1b_phase(torch, gm, fa, card)
    failures += fsdp_failures
    tp_failures, tp_perf = tp_1b_phase(torch, gm, fa, card)
    failures += tp_failures
    torch.cuda.empty_cache()
    # 7d and 6c side by side: their ranks are processes of their own (each
    # phase's gates read its own ranks' counts; the card holds both), and
    # neither in-process reference reads the launch counters
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        ep_jobs = {spec["label"]: pool.submit(ep_phase, torch, gm, fa, card, spec)
                   for spec in (EP8, EP4)}
        ep_perf = {}
        for label, job in ep_jobs.items():
            ep_failures, ep_perf[label] = job.result()
            failures += ep_failures
    torch.cuda.empty_cache()
    cases = kernel_phase(torch, gm, kernel_check)
    gen_cases = generate_kernel_cases(torch, gm, kernel_check)
    train_cases, tgmm_cases = train_kernel_phase(torch, gm, kernel_check)
    int8_cases = int8_kernel_phase(torch, gm, kernel_check, train_cases)
    ep_cases = ep_kernel_cases(torch, gm, kernel_check)
    failures += [f"{k} {c['case']} {c['dtype']}: kernel disagrees with plain "
                 f"(max_abs_err {c['max_abs_err']})"
                 for k, group in (("gmm", cases + gen_cases + train_cases),
                                  ("tgmm", tgmm_cases), ("gmm_int8", int8_cases),
                                  *(("gmm", v["gmm"]) for v in ep_cases.values()),
                                  *(("tgmm", v["tgmm"]) for v in ep_cases.values()))
                 for c in group if not c["ok"]]
    flash_cases = flash_kernel_phase(torch, gm, fa)
    failures += [f"flash {c['case']} {c['dtype']}: kernels disagree with plain "
                 f"(max_abs_err {c['max_abs_err']})" for c in flash_cases
                 if not c["ok"]]
    path_failures, perf, served = path_phase(torch, gm, fa, card)
    failures += path_failures
    gen_failures, gen_perf = generate_phase(torch, gm, fa, card, served, gen_cases)
    failures += gen_failures
    t0 = time.perf_counter()
    quant_failures, quant_perf = quant_serve_phase(torch, gm, fa, card, served)
    failures += quant_failures
    log(f"quant: the phase took {time.perf_counter() - t0:.1f}s")
    fleet_failures, fleet_perf = fleet_phase(torch, gm, fa, card, served, perf)
    failures += fleet_failures
    log(f"fleet: the phase took {fleet_perf.get('seconds', 0.0):.1f}s")
    tps_failures, tps_perf = tp_serve_phase(torch, gm, fa, card, served)
    failures += tps_failures
    del served
    torch.cuda.empty_cache()
    train_failures, train_perf = train_phase(torch, gm, fa, card)
    failures += train_failures
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    f32_failures, f32_perf = fp32_train_phase(torch, gm, fa, card)
    failures += f32_failures
    log(f"train fp32: the phase took {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    moe_failures, moe_perf = moe_train_phase(torch, gm, fa, card)
    failures += moe_failures
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    int8_failures, int8_perf = int8_train_phase(torch, gm, fa, kernel_check, card, moe_perf)
    failures += int8_failures
    log(f"int8: the phase took {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    b1_failures, b1_perf = train_1b_phase(torch, gm, fa, card)
    failures += b1_failures
    torch.cuda.empty_cache()
    muon_failures, muon_perf = muon_phase(torch, gm, fa, card)
    failures += muon_failures
    flex_failures, flex_perf = flex_phase(torch, gm, fa, card)
    failures += flex_failures
    opt_failures, opt_perf = optimizers_phase(torch, gm, fa, card)
    failures += opt_failures
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stream_failures, stream_perf = streaming_phase(torch, gm, fa, card)
    failures += stream_failures
    log(f"stream: the phase took {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    tele_failures, tele_perf = telemetry_phase(torch, card, moe_perf)
    failures += tele_failures

    # gmm and tgmm: launches in the MoE training run, times at its bf16
    # gate/up shapes (gmm forward, tgmm).
    moe_launches = moe_perf.get("launches", {})
    gmm_case = train_cases[0]
    gmm_entry = kernel_entry(
        "gmm", SOURCE, REPLACES, moe_launches.get("gmm", 0), gmm_case,
        max(c["max_abs_err"] for c in train_cases))
    gmm_entry.update(cases=cases + train_cases, serve_path=perf,
                     serve_launches=perf.get("gmm_launches", 0), card=card)
    tgmm_entry = kernel_entry(
        "tgmm", SOURCE, TGMM_REPLACES, moe_launches.get("tgmm", 0), tgmm_cases[0],
        max(c["max_abs_err"] for c in tgmm_cases if c["dtype"] == "bfloat16"))
    tgmm_entry.update(cases=tgmm_cases, moe_train=moe_perf, telemetry=tele_perf,
                      card=card)
    # The serving path's two fp32 kernels, each at its K 1536 shape (down),
    # with its launches in the serving run and the fleet phase's, and every
    # fp32 row it served.
    serve_variants = perf.get("gmm_launches_by_variant", {})
    fleet_variants = fleet_perf.get("gmm_launches_by_variant", {})
    by_case = {c["case"]: c for c in cases if c["dtype"] == "float32"}
    fp32_entries = []
    for kname, variant, row in (("gmm_f32", "f32", "prefill_down"),
                                ("gmm_f32_decode", "f32_decode", "decode_down")):
        rows = [c for c in by_case.values() if c["variants"] == {variant: 1}]
        entry = kernel_entry(kname, SOURCE, REPLACES,
                             serve_variants.get(variant, 0) + fleet_variants.get(variant, 0),
                             by_case[row], max(c["max_abs_err"] for c in rows))
        entry.update(variant=variant, cases=rows, card=card,
                     launches_by_path={"serve": serve_variants.get(variant, 0),
                                       "fleet": fleet_variants.get(variant, 0)},
                     fleet_launches_by_replica={
                         rid: d.get(variant, 0) for rid, d in
                         fleet_perf.get("gmm_launches_by_replica", {}).items()})
        fp32_entries.append(entry)
    fp32_entries[1]["fleet_path"] = fleet_perf
    # The locked generation path's gmm cases, each with the generate phase's
    # launches at its shape.
    gen_launches = gen_perf.get("gmm_launches_by_case", {})
    for c in gen_cases:
        variant = "f32_decode" if c["block_t"] == 8 else "f32"
        entry = kernel_entry(f"gmm_{variant}:{c['case']}", SOURCE, REPLACES,
                             gen_launches.get(c["case"], 0), c, c["max_abs_err"])
        entry.update(variant=variant, shape=c["shape"], block_t=c["block_t"],
                     group_sizes=c["group_sizes"], planted_fault=c["planted_fault"],
                     library=c["library"], path="generate_moe_8x40m", card=card)
        fp32_entries.append(entry)
    fp32_entries[-1].update(generate_path=gen_perf, quant_serve_path=quant_perf)
    # gmm_int8 (matmul_precision int8): its launches in the int8 MoE run,
    # times at the gate/up shape, both training shapes as cases
    int8_entry = kernel_entry(
        "gmm_int8", SOURCE, INT8_REPLACES, int8_perf.get("launches", {}).get("gmm_int8", 0),
        int8_cases[0], max(c["max_abs_err"] for c in int8_cases))
    int8_entry.update(cases=int8_cases, int8_train=int8_perf, variant="wgmma",
                      launches_by_variant=int8_perf.get("gmm_int8_launches_by_variant"),
                      replaces_note="XLA in JAX (_gmm_int8_impl), no Pallas counterpart",
                      card=card)
    # the fp32 tgmm (3xTF32): its launches in the int8 MoE run (the dW of
    # every int8 grouped GEMM), times at that path's gate/up shape
    f32_tgmm = [c for c in tgmm_cases if c["dtype"] == "float32"]
    tgmm_f32_entry = kernel_entry(
        "tgmm_f32", SOURCE, TGMM_REPLACES,
        int8_perf.get("launches_by_variant", {}).get("tgmm", {}).get("f32", 0),
        next(c for c in f32_tgmm if c["case"] == "int8_path_gate_up"),
        max(c["max_abs_err"] for c in f32_tgmm))
    tgmm_f32_entry.update(variant="f32", cases=f32_tgmm, path="moe_8x40m_int8", card=card)
    # The flash kernels: the 1B trainer's shape (B 8, H 16, S 2048, D 128,
    # bf16, causal) and its launches in run A; the 40m and MoE runs'
    # launches beside them.
    path_case = flash_cases[0]
    out_of = {"flash_fwd": ("o", "lse"), "flash_bwd_dq": ("dq",),
              "flash_bwd_dkv": ("dk", "dv")}
    b1_launches = b1_perf.get("launches", {})
    flash_entries = [kernel_entry(
        name, FLASH_SOURCE, FLASH_REPLACES[name], b1_launches.get(name, 0),
        path_case["kernels"][name],
        max(path_case["max_abs_err"][o] for o in out_of[name]))
        for name in FLASH_KERNELS]
    b1_variants = b1_perf.get("launches_by_variant", {})
    for entry in flash_entries:
        name = entry["name"]
        entry.update(launches_by_variant=b1_variants.get(name),
                     tflops=path_case["kernels"][name]["tflops"],
                     launches_by_path={
                         "1b_singlechip": b1_launches.get(name, 0),
                         "1b_fsdp_launcher": fsdp_perf.get("launches", {}).get(name, 0),
                         "moe_8x40m": moe_launches.get(name, 0),
                         "dense_40m": train_perf.get("launches", {}).get(name, 0)})
    flash_entries[0].update(cases=flash_cases, dense_train=train_perf,
                            train_1b=b1_perf, fsdp_1b=fsdp_perf, card=card)
    # The flex slice's (kernel, variant, score mod) cases, each with its
    # launches on the path that runs it (100m-muon: wgmma, no mod; 1m-flex:
    # wgmma, alibi; the 1M optimizer runs: wgmma, no mod; no path runs the
    # others).
    flash_by_case = {c["case"]: c for c in flash_cases}
    paths = {"path_100m": ("100m_muon", muon_perf), "path_1m_flex": ("1m_flex", flex_perf),
             "path_1m": ("1m_optimizers", opt_perf)}
    for case_name, *_ in FLEX_CASES:
        c = flash_by_case[case_name]
        path, run = paths.get(case_name, (None, {}))
        for name in FLASH_KERNELS:
            by_v = (run.get("launches_by_variant") or {}).get(name, {})
            by_m = (run.get("launches_by_mod") or {}).get(name, {})
            variant = c["variant"][name]
            launches = min(by_v.get(variant, 0), by_m.get(c["score_mod"], 0))
            entry = kernel_entry(
                f"{name}:{variant}:{c['score_mod']}:{case_name}", FLASH_SOURCE,
                FLASH_REPLACES[name], launches, c["kernels"][name],
                max(c["max_abs_err"][o] for o in out_of[name]))
            entry.update(variant=variant, score_mod=c["score_mod"],
                         score_arg=c["score_arg"], mask=c["mask"], window=c["window"],
                         shape=c["shape"], path=path,
                         tflops=c["kernels"][name]["tflops"],
                         library=c["kernels"][name]["library"], card=card)
            if name == "flash_bwd_dq" and c["shape"][4] < 64:
                entry["earlier"] = EARLIER["flash_bwd_dq"]
            flash_entries.append(entry)
    # The fp32 cases: the three 3xTF32 kernels; the fp32 40m training
    # path's shape ("path_fp32": B 32, H 8, S 1024, D 64) with its launches
    # there, the others on none.
    f32_launches = f32_perf.get("launches_by_variant", {})
    for case_name in FP32_CASES:
        c = flash_by_case[case_name]
        path = "dense_40m_fp32" if case_name == "path_fp32" else None
        for name in FLASH_KERNELS:
            launches = f32_launches.get(name, {}).get("f32", 0) if path else 0
            entry = kernel_entry(
                f"{name}:f32:none:{case_name}", FLASH_F32_SOURCE, FLASH_REPLACES[name], launches,
                c["kernels"][name], max(c["max_abs_err"][o] for o in out_of[name]))
            entry.update(variant="f32", score_mod="none", mask=c["mask"], shape=c["shape"],
                         path=path, tflops=c["kernels"][name]["tflops"],
                         library=c["kernels"][name]["library"],
                         plain_fp32_limit_ratio=c["plain_fp32_limit_ratio"], card=card)
            entry["earlier"] = EARLIER["flash_fwd" if name == "flash_fwd" else f"{name}_f32"]
            flash_entries.append(entry)
    # 80m-fineweb's shape (B 32, Hq 16, Hkv 8, S 2048, D 64, bf16, causal)
    # with its launches in the streaming phase's runs.
    c = flash_by_case["path_80m"]
    stream_launches = stream_perf.get("launches", {})
    for name in FLASH_KERNELS:
        entry = kernel_entry(
            f"{name}:wgmma:none:path_80m", FLASH_SOURCE, FLASH_REPLACES[name],
            stream_launches.get(name, 0), c["kernels"][name],
            max(c["max_abs_err"][o] for o in out_of[name]))
        entry.update(variant=c["variant"][name], score_mod="none", mask=c["mask"],
                     shape=c["shape"], path="fineweb_80m_streaming",
                     tflops=c["kernels"][name]["tflops"],
                     library=c["kernels"][name]["library"], card=card)
        flash_entries.append(entry)
    flash_entries[-1].update(muon_100m=muon_perf, flex_1m=flex_perf, optimizers_1m=opt_perf,
                             dense_40m_fp32=f32_perf, fineweb_80m=stream_perf)
    # 1b-tp's per-rank shape with rank 0's launches in phase 7c (every
    # rank's beside them), and 1b-fsdp's B 32 shape with phase 7b's
    for case_name, run, path in (("path_1b_tp", tp_perf, "1b_tp_4_gloo_ranks"),
                                 ("path_1b_fsdp", fsdp_perf, "1b_fsdp_launcher")):
        c = flash_by_case[case_name]
        for name in FLASH_KERNELS:
            entry = kernel_entry(
                f"{name}:wgmma:none:{case_name}", FLASH_SOURCE, FLASH_REPLACES[name],
                run.get("launches", {}).get(name, 0), c["kernels"][name],
                max(c["max_abs_err"][o] for o in out_of[name]))
            entry.update(variant=c["variant"][name], score_mod="none", mask=c["mask"],
                         shape=c["shape"], path=path, tflops=c["kernels"][name]["tflops"],
                         library=c["kernels"][name]["library"], card=card)
            if case_name == "path_1b_tp":
                entry["launches_by_rank"] = [r.get(name) for r in run.get("ranks", [])]
            flash_entries.append(entry)
    # 1b-tp's per-rank shape at the config's batch 32: no phase runs it
    c = flash_by_case["path_1b_tp_b32"]
    for name in FLASH_KERNELS:
        entry = kernel_entry(
            f"{name}:wgmma:none:path_1b_tp_b32", FLASH_SOURCE, FLASH_REPLACES[name], 0,
            c["kernels"][name], max(c["max_abs_err"][o] for o in out_of[name]))
        entry.update(variant=c["variant"][name], score_mod="none", mask=c["mask"],
                     shape=c["shape"], path=None, tflops=c["kernels"][name]["tflops"],
                     library=c["kernels"][name]["library"], card=card)
        flash_entries.append(entry)
    flash_entries[-1].update(tp_1b=tp_perf)
    # moe-8x40m's fp32 gmm at tp 2 (phase 4e): each case with rank 0's
    # launches at its shape over the three arms (rank 1's beside them)
    tp2_cases = {c["case"]: c for c in cases if c["case"].startswith("tp2_")}
    half = MOE_8X40M["intermediate_size"] // 2
    for case_name, c in tp2_cases.items():
        variant = "f32_decode" if c["block_t"] == 8 else "f32"
        down = case_name.endswith("_down")
        by_rank = []
        for r in (0, 1):
            n = 0
            for arm in (tps_perf.get(a) or {} for a, _, _ in TP_SERVE_ARMS):
                for key, count in (arm.get("launches_by_shape") or {}).get(r) or []:
                    if key[0] == variant and (key[2] == half if down else key[3] == half):
                        n += count
            by_rank.append(n)
        entry = kernel_entry(f"gmm_{variant}:{case_name}", SOURCE, REPLACES, by_rank[0], c,
                             c["max_abs_err"])
        entry.update(variant=variant, shape=c["shape"], block_t=c["block_t"],
                     launches_by_rank=by_rank, path="moe_8x40m_tp2_2_gloo_ranks",
                     library=c["library"], card=card)
        fp32_entries.append(entry)
    fp32_entries[-1].update(tp_serve=tps_perf)
    report = json.dumps({"kernels": [gmm_entry, tgmm_entry, tgmm_f32_entry, int8_entry]
                                    + fp32_entries + flash_entries
                                    + ep_entries(ep_cases, ep_perf, card)})
    if failures:  # no result on stdout; the measurements go to stderr
        print(report, file=sys.stderr)
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print(report, flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def shut_down() -> None:
    """Stop Inductor's compile workers (the soft_cap yardstick's) and any
    process of this run still alive, and name the latter on stderr."""
    async_compile = sys.modules.get("torch._inductor.async_compile")
    if async_compile is not None:  # at most 20 s: the sweep below kills what is left
        done = threading.Thread(target=async_compile.shutdown_compile_workers, daemon=True)
        done.start()
        done.join(timeout=20)
    for pid, cmd in stop_leftovers(os.environ[RUN_ID_VAR]):
        print(f"shutdown: killed process {pid} left running: {cmd[:300]}", file=sys.stderr)
    left = own_processes(os.environ[RUN_ID_VAR])
    if left:
        print(f"shutdown: still alive: {left}", file=sys.stderr)


if __name__ == "__main__":
    try:
        code = main()
    finally:
        if RUN_ID_VAR in os.environ:
            shut_down()
    sys.exit(code)
