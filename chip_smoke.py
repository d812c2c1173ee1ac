#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases (any failure raises, so the exit code is non-zero):
  0. device check: a CUDA device must be present; prints the card's name
     and power limit (nvidia-smi), torch and CUDA versions;
  1. build: compiles simple_tad_tpu_torch/csrc/*.cu (nvcc, sm_90a) and
     prints the build seconds and the ptxas register / spill report;
  2. kernels against their plain PyTorch versions on the card, at the
     shapes the main path gives them, each within its stated tolerance,
     timed with CUDA events (median of 30 runs after warm-up; the row
     norms A2, B1, E1, D3 and the delta pre-pass, and their plain and
     library calls, QUEUED_CALLS calls a run on two copies of their
     inputs in turn, so that the time is the device's and the input comes
     from device memory).  Every
     case of the bf16/fp32 attention forward (A1 packed and on separate
     operands, C1, C3-fwd, B3, C4-fwd) must launch once on the route
     fa.attention_fwd_route names, and no other: the wgmma kernel at head
     dims 64 to 128 (ViT-S/B/L, IV2-S/B at 64, ViT-H's 80, IV2-1B's 88,
     IV2-6B's 128, and 72, 104, 120 at a ragged N, with or without
     dropout; two launches on the same inputs bit-equal; every case off
     head dim 64 timed with SDPA and its bound), the mma.sync kernel at
     head dim 32 (A1 packed and on separate operands with v strided, C1,
     C4-fwd in both keep forms; timed too), the CUDA-core kernel in fp32;
     each such case's route and error (and times, where timed) are kept in
     the kernels record's "cases".  Every
     LayerNorm case and every bf16 attention case also runs a control: the
     plain version with one required numerics step left out (LayerNorm:
     unbiased variance; attention: probabilities not rounded to bf16
     before PV and the denominator).  The control must fail the bound, so
     the bound is shown to catch it.  The int8 kernels (LayerNorm->int8,
     int8-storage attention) are held to their plain versions by the
     largest code difference (<= 1) and the share of codes that differ,
     with the same two controls (two launches of each B1 case
     bit-equal); every B2 and D2 case must launch once on
     the route fa.attention_i8_route names (the wgmma kernel at head dim
     64, two launches bit-equal; the mma.sync kernel at ViT-H's 80 and
     IV2-1B's 88, timed too).  The training attention kernels (C1,
     the forward with lse; C2, the backward) are checked at ViT-B's
     training shape (8, 1568, 2304) bf16 (C2's wgmma route), ViT-H's head
     dim 80 (2, 1568, 3840) bf16 (C1's wgmma route, C2's mma.sync one),
     head dim 32 (4, 1568, 1152) bf16 (C1's and C2's mma.sync routes) and
     on a masked fp32 tail: C1's out under the attention bounds and its lse
     within LSE_ATOL, C2's dqkv under the bf16 bounds, each with a control
     (the plain version with probabilities not rounded before PV, or before
     dV), and C2's two launches on the same inputs must be bit-equal; they
     are timed at the job's batch, (56, 1568, 2304).  The backward's delta
     pre-pass (attention_delta) is held to the plain rowsum at the fp32
     bounds, against a control that rounds each product to bf16, at
     ViT-B's job batch (timed), IV2-S batch 8 and an fp32 tail.  Every
     kernel is also timed against one PyTorch call that computes the same
     function where there is one (library_ms: scaled_dot_product_attention
     forward or backward, layer_norm; a yardstick the port never calls),
     and its bound_ms is computed from its shapes and the H100's
     data-sheet rates (an attention's also from its N^2 exp2 a (batch,
     head) on the special-function units at the maximum SM clock, the
     record's "bound_term" "exp2" where that term is the larger).
     InternVideo2's kernels are checked at IV2-S and IV2-B batch 32, N =
     2049 (8 x 16 x 16 patches + CLS): A1 on separate operands
     (attention_sep) with v the strided column block of a real qkv tensor,
     timed against SDPA; D2 (attention_i8_sep, int8 storage on separate
     operands) likewise, once with keys masked at n_valid < N, and at
     IV2-1B's head dim 88 (padded to 96), and A1 on separate operands at
     C = 192 (H = 3, Dh = 64), the geometry at which the JAX package takes
     its (B*H, N, Dh) inference kernel; D3 (rmsnorm_quant, RMSNorm->int8)
     at (32 x 2049, 384) with per-head inverse scales (two launches of
     each case bit-equal).  Their controls: the
     probabilities not rounded to bf16 (A1, D2), and for D3 the bf16-rounded
     value quantized instead of the fp32 one.  InternVideo2's training
     attention (C3: attention_sep_fwd_lse, attention_sep_bwd, C1 and C2 on
     separate operands) is checked at IV2-S batch 8 (8, 2049, 384 x 3) bf16
     and a masked fp32 tail, v strided, with C1's and C2's bounds and
     controls plus a gross one (v read with q's row stride), two
     launches of C3-bwd bit-equal, and timed at the job's batch 56 against
     SDPA's forward and backward;
  3. sliding-window evaluation at full width: ViT-B 16x224 bf16 with
     seeded weights on a synthetic 96-frame 360x640 clip (81 windows),
     device resize, token path, batch 32, through FrameEvaluator, timed
     over 5 runs; the launch counters must show 12 attention launches, all
     on the forward's wgmma route, and 25 LayerNorm launches per chunk
     forward and nothing else, and the logits must agree with
     the same model run through the plain versions on the card (and the
     model run through the controls must not);
  4. streaming: 16 batch-1 steps of cli/inference.py's StreamingScorer;
  5. int8 static serving: the same clip through FrameEvaluator(quant8=True)
     (ViT-B quantized from its seeded fp32 masters, calibrated explicitly
     first), timed over 5 runs; the counters must show 24 LayerNorm->int8,
     12 int8 attention (all on B2's wgmma route), 1 LayerNorm (fc_norm)
     and 0 bf16 attention launches per chunk forward.  In one more run
     every int8 kernel call
     of the main path is checked on its own inputs against its plain
     version (the int8 bounds above) and against its control (which must
     fail them).  The logits must agree with the same int8 model run
     through the plain versions within LOGIT_RTOL_I8, and a gross control
     (attention output left unnormalized) must not: with seeded weights
     one flipped int8 code moves the logits by 4.6e-3 of max |logit|, so
     at the logit level the kernels and the subtle controls read alike
     (PERF.md), and the sharp check is the per-site one.  The
     int8-vs-bf16 logit drift is printed, not bounded; then 16 int8
     streaming steps;
  6. frame fine-tuning at full width: ViT-B 16x224 with seeded fp32
     masters computed in bf16, the paper's job hyperparameters
     (jobs/finetune/VideoMAE-B_DoTA.sh: layer decay 0.6, drop path 0.2,
     RandAugment m6 n3, RandomErasing 0.25, crossentropy, AdamW, weight
     decay 0.05), synthetic uint8 clips through ops/augment.py on the
     card.  (i) batch 8: one train step must launch C1 12 times, C2 12
     times (each C2 call is two kernel launches: dk/dv, then dq), all 24
     on the wgmma routes (printed with their counters; head dim 64), the
     delta pre-pass 12 times, the LayerNorm kernel 25 times and the
     inference attention 0 times; the
     step's gradients must agree with the same step run through the plain
     versions (relative error of the global gradient norm within
     GRAD_NORM_RTOL, of the worst parameter within GRAD_PARAM_RTOL), and a
     control (the backward without its delta term) must not;
     (ii) 10 steps on one fixed augmented batch at a constant lr of
     TRAIN_LR: the last loss must be at least LOSS_DROP below the first;
     (iii) FinetuneTrainer at the job's batch 56 in TIMING_PROCESSES fresh
     processes: median step ms and clips/s of TIMED_STEPS steps after
     WARMUP_STEPS, peak device memory; in the first process also the
     device time of the step's parts over BREAKDOWN_STEPS steps (CUDA
     events around the augmentation, forward + backward and the
     optimizer update) and one torch.profiler window of PROFILE_STEPS
     steps (kernel time by name, device busy share);
  7. InternVideo2 serving at full width: IV2-S 8x224 (N = 2049) bf16 with
     seeded weights (LayerScale 0.1, head scale 1) on the same synthetic
     clip with the DoTA job's view setting (--num_frames 8 --view_fps 5:
     every other frame, 82 windows), token path, batch 32, through
     FrameEvaluator, timed over 5 runs; the counters must show 12
     separate-operand attention launches per chunk forward, all on the
     forward's wgmma route, and no other
     kernel (its norms are plain PyTorch, as the JAX package leaves them
     to XLA); every attention call of one run is checked against its plain
     version and its control, and the logits against the plain-version run
     and a gross control (v read with q's row stride, the fault of a
     kernel with one stride pair for all operands); at the logit level
     the kernel and the subtle control read alike (PERF.md), as in phase
     5; then 16 streaming steps;
  8. the same IV2-S as static int8 (quantized from its seeded fp32 masters,
     calibrated explicitly first), once unfused and once with fused_rmsq:
     the counters must show 12 D2 launches per chunk forward (all on the
     wgmma route) and, with
     fused_rmsq, 48 D3 (norm1, norm2, q-norm, k-norm), and nothing else;
     every D2 and D3 call of one run is checked against its plain version
     and its control, and the logits against the plain-version run (and a
     gross control, attention output left unnormalized);
  9. InternVideo2 fine-tuning at full width: IV2-S 8x224 (N = 2049) with
     seeded fp32 masters computed in bf16 (LayerScale 0.1), the IV2-S job's
     hyperparameters (jobs/finetune/IV2-S_DoTA.sh: lr 1e-3 scaled to batch
     56, weight decay 0.05; the CLI's defaults for the rest: layer decay
     0.75, drop path 0.1, RandAugment m6 n3, RandomErasing 0.25), synthetic
     uint8 clips of 8 frames through ops/augment.py on the card; as phase
     6: (i) batch 8, one train step must launch C3-fwd 12 times, C3-bwd 12
     times, all on the wgmma routes, the delta pre-pass 12 times and no other
     kernel (RMSNorm, LayerScale and the pooling head are plain PyTorch),
     its gradients within phase 6's bounds of the
     plain-version step and the control (no delta term) outside them; (ii)
     10 steps on one fixed batch at the constant lr IV2_LR, the loss must
     fall by LOSS_DROP; (iii) FinetuneTrainer at batch 56 in
     TIMING_PROCESSES fresh processes, with the step breakdown and a
     profiler window in the first;
 10. static int8 serving on the fused int8 GEMM kernels (B4) and the
     int8-output attention (B3), at full width on the clip and batch of
     phases 5 and 8, through FrameEvaluator(quant8=True, fused_w8a8=True,
     fused_mlp=True): (i) ViT-B: per chunk forward 24 LayerNorm->int8, 12
     int8-storage attention (B2, all on its wgmma route, as D2's below),
     24 int8_gemm (qkv, proj), 12 int8_mlp, 1 LayerNorm and no
     torch._int_mm call; (ii) ViT-B with qkv_i8=False: 12
     attention_q8 (B3, on the forward's wgmma route) instead of the
     int8-storage attention; (iii) IV2-S:
     12 D2, 24 int8_gemm, 12 int8_mlp (the MLP's input bf16: the JAX
     package's own fused-MLP program), then with fused_rmsq (+48 D3, the
     MLP's input int8); (iv) IV2-S with qkv_i8=False: 12 attention_q8_sep
     (on the wgmma route).
     In each, every kernel call of one run is checked against its plain
     version and its control, the logits against the plain-version run
     and a gross control (attention left unnormalized), and evaluate is
     timed over EVAL_RUNS runs; (i) ends with 16 int8 streaming steps.
     Phase 2 holds int8_gemm (ViT-B qkv and proj on int8 input, fc2 on
     fp32 input, IV2-S qkv on bf16 input), int8_mlp (ViT-B and ViT-L on
     int8 input, IV2-S on bf16 input) and B3 (packed at ViT-B, separate at
     IV2-S with v strided) to their plain versions, B4's two launches on
     the same inputs bit-equal and the GB of a float x its column blocks
     read printed, each with a control the bound must reject: the int8 GEMMs'
     outputs equal the plain version's bit for bit (an exact int32 product
     and the same fp32 epilogue), against q8 rounding half away from zero
     (roundf) where x is fp32, the fp32 rescale done in bf16 where it is
     int8 codes or bf16, and for the MLP fc1's bias left out and its activation
     rounded to bf16 before the q8 (the main-path check, whose seeded
     biases are zero, uses the latter); B3 by codes, against
     probabilities not rounded to bf16.  Their library yardstick is
     torch._int_mm on the same int8 operands, the product alone (no
     quantize, rescale, bias or GELU), and SDPA's forward for B3;
 11. ViT-B fine-tuning with attention dropout ATTN_DROP (0.1, the JAX
     package's own measurement's rate), kernels C4 in both keep sources
     ('mask': an int8 mask in memory; 'rng': Philox bits drawn in the
     kernels from a 2-word seed): (i) inside phase 2, C4-fwd and C4-bwd
     against their plain versions on the same mask or seed at ViT-B's
     training shape (8, 1568, 2304) bf16 and a masked fp32 tail, each with
     three controls that must fail (the denominator summed after dropout,
     or dP not scaled by the keep factor; the mask read transposed, or the
     next seed), each call counted once on the route
     fa.attention_fwd_route / attention_bwd_route name (the wgmma kernels
     at head dim 64; two launches bit-equal), and at ViT-H's head dim 80
     (2, 1568, 3840) H=16 on the forward's wgmma kernel (timed with SDPA)
     and the backward's mma.sync kernels, and at head dim 32 (2, 1568,
     1152) H=12 on the mma.sync kernels both ways (the forward timed with
     SDPA); timed at the job's batch
     56 against SDPA with dropout_p 0.1 forward and backward, the bound
     with the Philox form's integer floor (one philox4x32_10 call's SASS
     instructions from cuobjdump of the built library, its round keys
     counted once a thread, split by pipe: the busier of the FMA pipe's
     IMADs and the ALU pipe's rest at 64 lanes an SM, or all of them at
     128 issued an SM a clock, at the maximum SM clock); (ii) the Philox
     forward's keep bits, read off its output (q = k = 0, v one-hot) at (2, 2, 392, 392)
     bf16, must equal dropout_keep_plain's bit for bit, at head dims 64
     and 80 (the wgmma kernel) and 32 (the mma.sync kernel); (iii) one train
     step per form at batch 8: 12 dropout forward and 12 dropout backward
     calls of the form, all on the wgmma routes, 12 delta calls, 25
     LayerNorm and no C1/C2, its
     gradients within phase 6's bounds of the plain-version step from the
     same generator state and phase 6's control outside them; (iv) the
     batch-56 FinetuneTrainer timing of phase 6 in one fresh process a
     form (Philox and mask), each with the step breakdown and a profiler
     window;
 12. the static int8 ViT's two opt-in serving variants, kernels E1 (the
     residual add + LayerNorm->int8 of the deferred-residual carry,
     add_lnq) and E2 (int8-compute attention, int8_attn): (i) inside phase
     2, E1 at ViT-B's (32 x 1568, 768) bf16, an fp32 tail and a C % 8 != 0
     tail, its sum bit for bit, its codes equal to B1's of the stored sum
     bit for bit and under B1's bounds against the plain version, with B1's
     control and a gross one (the LayerNorm of the residual alone); E2 at
     (32, 1568, 2304) H=12 and N = 131, under the bf16 bounds (at most
     BF16_MISMATCH['attention_int8'] of outputs differing), with three
     controls (the probabilities left unrounded, a max-free softmax, v read
     without the kernel's key permutation), each case once on the route
     fa.attention_int8_route names (the wgmma kernel at head dim 64, two
     launches bit-equal; the mma.sync kernel at head dim 32, (4, 1568,
     1152) H=12); (ii) ViT-B static int8 from
     phase 5's seeded masters and explicit calibration, on phase 3's clip at
     batch 32, through FrameEvaluator in three variants: add_lnq; int8_attn;
     both with fused_w8a8 and fused_mlp.  Each: the launch counts per chunk
     forward (24 E1 and no B1; 12 E2, no B2 or B3, 24 B1; 24 E1, 12 E2, 24
     GEMM and 12 MLP kernels and no torch._int_mm), every kernel call of one
     run against its plain version and its control, windows/s as the median
     of EVAL_RUNS; every E2 and B2 call on its wgmma route; add_lnq's
     logits equal phase 5's (the same static model
     without the carry) bit for bit; the int8_attn variants' logits within
     LOGIT_RTOL_I8 of their plain-version run, a gross control (attention
     left unnormalized) outside it, and their distance from the bf16 and
     the phase-5 int8 logits printed; the last variant ends with 16 batch-1
     streaming steps;
 13. DAPT pre-training at full width (jobs/dapt/pretrain_bdd_capdata.sh):
     MAE-B, the encoder 768 wide and 12 deep on the visible tokens, the
     decoder 384 wide and 4 deep on all 1568, seeded fp32 masters computed
     in bf16, synthetic uint8 clips through ops/augment.py's
     pretrain_augment_align on the card, tube masks; AdamW betas (0.9,
     0.95), weight decay 0.05.  Inside phase 2, C1 and C2 at the path's new
     shapes (DAPT_TRAIN_CASES: N = 392 and 160 of the encoder at mask 0.75
     and 0.9, a 157-row tail, the decoder's C = 384 packed at H = 6, and
     MVD-B's N = 1569) against their plain versions and controls, each call
     on its wgmma route, two launches bit-equal, and at DAPT's batch 200
     (DAPT_TIMED) against their plain versions and controls and timed with
     SDPA's forward and backward and their bounds, in the records' cases; A1 at (32, 1569, 2304) beside the other A1 cases,
     timed.  (i) One step at batch 8 at mask 0.75, then at 0.9: 16 C1 and
     16 C2 calls (12 encoder + 4 decoder blocks), all on the wgmma routes,
     the delta pre-pass 16 times, the LayerNorm kernel 34 times (2 x 12 +
     1 + 2 x 4 + 1) and nothing else; the gradients against the same step
     through the plain versions within GRAD_NORM_RTOL / GRAD_PARAM_RTOL and
     the control (no delta term) outside them.  (ii) TRAIN_STEPS steps on
     one fixed batch at MAE_LR: the loss must fall by LOSS_DROP.  (iii)
     cli/pretrain.py's PretrainTrainer at batch MAE_BATCH (the parts
     MAE_PARTS of the double loop, each pinned on the host while the
     previous step runs, concatenated on the card) in one fresh process
     (phase 17 (ii) times the job's own 240 + 160): median step ms,
     clips/s, peak device memory, and a profiler window of PROFILE_STEPS
     steps;
 14. the MVD-B and UMT-B trunks (jobs/finetune/MVD-B_DoTA.sh: the 3-D
     table, no CLS token, N = 1568; UMT-B_D2K.sh: tubelet 1, 8 frames,
     N = 1568): seeded bf16 weights through FrameEvaluator at batch 32 on
     phase 3's clip (UMT: windows of every other frame), timed over
     EVAL_RUNS, 12 A1 and 25 LayerNorm launches a chunk forward, all A1 on
     the wgmma route; every A1 and LayerNorm call of one evaluate against
     its plain version and control at its inputs; at TRUNK_SEEDS seeds the
     pooled features the head takes against the plain-version run within
     FEATURE_RTOL and the gross control outside it; then the fine-tune
     check at batch 8 with the job's hyperparameters (as phase 6: 12 C1,
     12 C2, 12 delta, 25 LayerNorm, gradients against the plain-version
     step and the control, TRAIN_STEPS fixed-batch steps whose loss must
     fall by LOSS_DROP);
 15. InternVideo2 stage-2 distillation (jobs/distill/IV2-S_dist_1B.sh):
     the IV2-S student (distill_internvideo2_small_patch14_224, seeded
     fp32 masters in bf16, MLP tap decoders to 1408, the final decoder to
     768, drop path 0.05) from the IV2-1B teacher (seeded on the card,
     bf16, grad free), 8 frames at 224 through train_augment, the
     attention mask at 0.8 (the student on 410 visible tokens and the CLS
     token, N = 411), 6 taps (the teacher's at interval 3.34).  Inside
     phase 2, C3-fwd and C3-bwd at (8, 411, 1152) H = 6 (a 27-row tail
     tile) against their plain versions and controls on their wgmma
     routes, two launches bit-equal; timed at the job's batch
     DISTILL_BATCH: A1-sep at the teacher's (B, 2049, 4224) H = 16 (head
     dim 88, wgmma, two launches bit-equal; its plain version and control
     PLAIN_CHUNK samples at a time) and C3 at (B, 411, 1152) H = 6, each
     against its plain version and control, with SDPA and its bound.  (i)
     At batch 8: every A1-sep call of the teacher's forward (40, all
     wgmma, nothing else
     launched) and every C3-fwd, C3-bwd and delta call of one student step
     (12 each, wgmma; the calls counted) against its plain version and
     controls at its own inputs (C3-bwd's subtle control caught at some
     call, its gross one at every call); the teacher's taps, final
     feature and pooling attention against the plain-version teacher
     within FEATURE_RTOL and the gross control (v read with q's row
     stride) outside it in all three; the attention masks from one Gumbel
     draw on the kernels' and the plain teacher's attention, the share of
     positions apart within DISTILL_MASK_SHARE and a mask from the noise
     drawn anew outside it; the student's gradients against the plain-version step
     (GRAD_NORM_RTOL, GRAD_PARAM_RTOL) and the control (no delta term)
     outside them; one real step's launch counts; TRAIN_STEPS steps on
     one batch at DISTILL_LR whose loss must fall by LOSS_DROP.  The mask
     share holds the mask's plumbing, not the kernels (see
     DISTILL_MASK_SHARE).  (iii) The CLI's trainer (cli/distill.py on
     DISTILL_FLAGS: upload, train_augment on the card, the teacher's
     forward, the mask, the student's step) at DISTILL_BATCH (or the
     largest of DISTILL_BATCHES that fits) in DISTILL_PROCESSES fresh
     processes: median step ms after DISTILL_WARMUP (DISTILL_STEPS_FIRST
     steps in the first, DISTILL_STEPS in any other), clips/s, peak
     memory, and in the first a profiler window of PROFILE_STEPS steps
     with the teacher's forward and the whole step timed apart by CUDA
     events;
 16. InternVideo2 probing, class fine-tuning and DAPT, each through its
     CLI's trainer on its job's flags (PROBE_FLAGS, PROBE_6B_FLAGS,
     CLS_FLAGS, the IV2_DAPT_* constants), clips from memory.  Inside
     phase 2, A1-sep at 16 frames (N = 4097) at IV2-1B's head dim 88 and
     IV2-6B's 128 (wgmma, two launches bit-equal), C3 at the IV2-S DAPT
     encoder's (8, 1024,
     1152) H = 6 and C1 / C2 at its decoder's (8, 4096, 576) H = 3
     (wgmma), each against its plain version and controls and timed with
     SDPA and its bound.  (i) The IV2-1B attentive probe (open_block_num 0,
     the pooling head open) at PROBE_CHECK_BATCH: the open parameters'
     gradients against the plain-version step, the gross control (v
     misread) outside the bounds; one real step with every A1-sep call
     (40, wgmma, nothing else launched) against its plain version and
     control, the trunk's output without a grad_fn, every detached
     parameter bit-unchanged, the classifier moved; the same with
     open_block_num 1 (39 A1-sep, C3-fwd, C3-bwd and the delta pre-pass
     once, the control without the delta term).  (ii) The probe at the
     job's PROBE_BATCH in PROBE_PROCESSES fresh processes: median step
     ms, clips/s, peak memory, a profiler window in the first.  (iii)
     IV2-6B at full width (head dim 128), its depth cut to PROBE_6B_DEPTH,
     at PROBE_6B_BATCH, as (i).  (iv) IV2-B class fine-tuning at batch 8:
     train_augment_cls under torch.cuda's sync debug mode 'error' (no
     host read); gradients against the plain-version step and the control
     (no delta term); 12 C3-fwd + 12 C3-bwd + 12 delta (wgmma) and nothing
     else; TRAIN_STEPS steps at CLS_FIT_LR whose loss must fall by
     LOSS_DROP; timed at CLS_BATCH in one process.  (v) IV2-S DAPT at batch
     8 as phase 13 (i)-(ii) (12 C3 + 4 C1 / C2 + 16 delta + 10 LayerNorm;
     the fit at IV2_DAPT_FIT_LR), then PretrainTrainer at IV2_DAPT_PARTS
     in one process.
 17. Gradient checkpointing, the DAPT job's own step on one card, and
     data parallelism.  (i) At batch 8, from the same weights, batch and
     generator state, with ``use_checkpoint`` and without: the MAE-B DAPT
     step (mask 0.75), the ViT-B fine-tune step with drop path 0.1 and
     attention dropout 0.1 in both keep forms, and the IV2-S fine-tune
     step.  Remat's gradients are held to the step without it by phase
     6's bounds (bit-equality printed), the generator's state after the
     step must be equal, and every attention counter (C1, C3-fwd, C4-fwd,
     the backward and delta kernels, the routes) must read the same: the
     recompute launches no forward attention (models/layers.py:
     checkpoint_block); the LayerNorm counter is printed (the recompute
     runs the norms again).  The control, a recompute that redraws its
     masks (ViT-B, Philox form), must fail the bounds.  (ii) The DAPT
     job's step (jobs/dapt/pretrain_bdd_capdata.sh: 240 + 160 clips, MAE-B
     decoder depth 4, mask 0.75) through cli/pretrain.py:PretrainTrainer,
     once with ``--use_checkpoint`` at 240 + 160 and once as 2 x (120 +
     80) with ``--update_freq 2``, each in one fresh process: median job-
     step ms over DAPT_JOB_TIMED steps after DAPT_JOB_WARMUP, clips/s,
     peak memory and, from a profiler window of PROFILE_STEPS job steps,
     the device's busy share.  (iii) In a fresh process given
     DDP_TIMEOUT_S, a one-process NCCL group on a free 127.0.0.1 port:
     DDP_STEPS ViT-B fine-tune steps at batch 8 through FinetuneTrainer,
     through the data-parallel optimizer (parallel/mesh.py: the bucketed
     gradient all-reduce) plain and with ``zero_stage`` 1 (the owner's
     broadcast), must leave the parameters bit-equal to the same steps
     without a process group, the collectives counted.
 18. jobs/vis.sh's MAE reconstruction and the efficiency harness.  (i)
     cli/visualize.py's mae-recon core (``reconstruct``) at the job's
     flags (RECON_MODEL, RECON_FLAGS: MAE-B with decoder depth 4, 16x224,
     tube mask 0.9, seed 42) in fp32 with seeded weights on a synthetic
     16-frame 360x640 clip from memory (resized on the host by the port's
     cubic resize): 12 encoder attention calls at N = 160 and 4 decoder
     calls at N = 1568 (C = 384, H = 6), all on the forward's fp32 route,
     and 34 LayerNorm calls, nothing else launched; the recon within
     RECON_ATOL of the same core on the plain versions, and two controls
     (the un-normalisation without the std; every head reading the next
     head's v) outside it; the reconstruction timed host to host and the
     model's forward by CUDA events.  (ii) cli/efficiency.py's
     benchmark_model on vit_base_patch16_224 in bf16 at
     EFFICIENCY_BATCHES (its rows printed as JSON lines): every forward's
     12 attention calls on A1's wgmma route and 25 LayerNorm calls,
     nothing else launched.
The line before the last is the kernels' JSON record (max_abs_err of an
int8 kernel is in codes); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import multiprocessing
import re
import shutil
import statistics
import subprocess
import time
from unittest import mock

import numpy as np
import torch

# Bounds against the plain version on the same inputs.  Each sits between
# the kernels' largest reading and the controls' smallest, read on an
# NVIDIA H100 80GB HBM3 at these shapes (PERF.md, Findings):
#   bf16 outputs differing   layernorm  < 5e-5 vs control 0.0833
#                            attention  0.0019 vs control 0.4208
#   logits, max |err| / max |logit|     4.535e-3 vs controls 7.234e-3
#   int8 codes differing     layernorm_quant  <= 1.9e-6 vs control >= 9.0e-3
#                            attention_i8     <= 5.2e-5 vs control >= 2.7e-3
#   int8 logits, max |err| / max |logit|  1.004e-2; a single flipped code
#                                         4.6e-3; subtle controls 7.4e-3 to
#                                         9.7e-3 (they saturate)
#   training attention at (8, 1568, 2304) bf16:
#     C1 bf16 outputs differing           1.626e-3 vs control 0.4215
#     C1 lse max |err|                    1.373e-4 (control 5.913e-4; the
#                                         bound is the analytic one below)
#     C2 bf16 dqkv differing              2.058e-3 vs control 0.1412
#   InternVideo2 (IV2-S/B b32, N = 2049; readings at one seeded draw):
#     attention_sep bf16 outputs differing  ~2.1e-3 vs control ~0.42; on
#                                           the IV2-S main path <= 7.3e-4
#                                           vs >= 4.5e-2
#     attention_i8_sep codes differing      <= 3.2e-5 vs control >= 6.6e-3;
#                                           main path <= 9.3e-5 vs >= 1.7e-3
#     rmsnorm_quant codes differing         <= 6.4e-7 vs control >= 2.0e-2;
#                                           main path <= 1.1e-6 vs >= 2.7e-2
#   MVD-B / UMT-B evaluate (phase 14; 6 seeds each, N = 1568):
#     A1 / A2 calls' outputs differing  <= 6.5e-4 / 2.6e-5 vs controls
#                                       >= 4.0e-2 / 0.115
#     head inputs, max ||err|| / ||plain|| over windows  <= 2.438e-3 vs
#                                       the subtle control >= 2.850e-3 (no
#                                       margin: hence the per-call check)
#                                       and the gross control >= 0.661;
#                                       logits / max |logit| read up to
#                                       2.18e-2 where the seeded head's
#                                       logits are small (UMT-B seed 5)
#     IV2-S logits / max |logit|: bf16 3.251e-3 vs the subtle control
#     3.806e-3 (no margin: hence the per-call check) and the gross control
#     4.180e-2; int8 4.801e-3, fused 3.755e-3, vs gross controls >= 9.07e-2
#   static int8 on the fused GEMMs (B4) and B3, at the main-path shapes:
#     int8_gemm, int8_mlp outputs differing  0 (bit for bit) vs controls
#                                          >= 1.1e-3 (roundf at fc2) and
#                                          >= 0.33 (bf16 rescale, bf16 hidden)
#     attention_q8(_sep) codes differing   <= 5.1e-5 vs controls >= 2.0e-2
#     phase 10 logits / max |logit|: ViT-B 8.648e-3 (B3 9.450e-3), IV2-S
#     <= 4.830e-3, vs gross controls >= 8.966e-2
#   ViT-B train step at batch 8, gradients vs the plain-version step:
#     worst parameter ||err|| / ||grad||  8.083e-3 vs control 3.183
#     global gradient norm                1.699e-5; the control leaves it
#                                         at 1.1e-7 (the fc head's gradient
#                                         dominates it), so the per-parameter
#                                         bound is the one that catches it
#   attention dropout (C4), rate 0.1, both forms, at (8, 1568, 2304) bf16
#   (the wgmma kernels) and (2, 1568, 3840) H=16 (head dim 80, read when
#   its forward took the mma.sync kernel):
#     C4-fwd outputs differing            <= 1.722e-3 vs controls >= 0.836
#     C4-bwd dqkv differing               <= 2.331e-3 vs controls >= 0.662
#     ViT-B train step with dropout, worst parameter <= 6.910e-3 vs control
#                                         >= 3.304
#   the static int8 ViT's variants (phases 2 and 12):
#     add_layernorm_quant codes differing <= 9.9e-7 vs controls >= 8.6e-3;
#                                         its sum, and its codes against
#                                         B1's of that sum, bit for bit
#     attention_int8 outputs differing    0 (bit for bit) vs controls
#                                         >= 0.119
#   IV2 stage-2 distillation (phase 15, batch 8; the IV2-1B teacher at
#   N = 2049, head dim 88, read on the mma.sync kernel; the IV2-S student
#   at N = 411):
#     teacher A1-sep calls, outputs differing  <= 7.1e-4 vs control >= 3.75e-2
#     teacher taps / final / attention vs plain, max over features
#                                          8.147e-3 / 3.295e-3 / 1.324e-3
#                                          vs the gross control 0.205 /
#                                          0.361 / 2.85e-2 (the taps' worst
#                                          token 1.90e-2, printed)
#     attention-mask positions apart      2.44e-4 vs the noise drawn anew
#                                          0.321
#     student C3-fwd / C3-bwd calls       <= 1.8e-4 / 4.8e-4 vs the gross
#                                          controls >= 0.998 / 0.583
#     student gradients, worst parameter  5.94e-3 vs control 9.53
#   InternVideo2 probing, class fine-tuning and DAPT (phase 16, batch 2-8):
#     IV2-1B probe A1-sep calls (N = 4097, head dim 88), outputs differing
#                                          <= 1.69e-3 vs the gross control
#                                          >= 0.998; the subtle control
#                                          2.5e-2, under the bound at the
#                                          step's near-uniform probabilities
#                                          (printed; IV2-6B's 2.9e-2, caught
#                                          at 1 of 4 calls)
#     the probes' open parameters' gradients, worst 3.81e-3 (1B) / 4.02e-3
#                                          (6B at depth 4) vs the gross
#                                          control 0.312 / 0.211
#     IV2-B class step gradients, worst    1.28e-2 vs control 9.30
#     IV2-S DAPT step gradients, worst     3.46e-3 vs control 9.66
# Readings are bit-for-bit the same from run to run on one card and
# software stack (no atomics; fixed seeds).
BF16_TOL = dict(atol=1e-2, rtol=1e-2)    # ~1 bf16 ulp (2^-7 relative)
# share of bf16 outputs that may differ from the plain version in any bit
BF16_MISMATCH = {"layernorm": 0.01, "attention": 0.03}
F32_TOL = dict(atol=1e-5, rtol=1e-5)     # fp32 summation order
LOGIT_RTOL = 5.7e-3      # max |logit error| / max |logit|, 12 bf16 layers
# int8 kernels: codes at most 1 apart, and at most this share apart (a
# code moves only where its fp32 value sits within a rounding error of a
# half-integer)
I8_MISMATCH = {"layernorm_quant": 1.5e-4, "attention_i8": 4e-4,
               # E1's codes are B1's of its stored sum: B1's bound
               "add_layernorm_quant": 1.5e-4,
               "attention_i8_sep": 4e-4, "rmsnorm_quant": 1.5e-4,
               # B3 quantizes A1's fp32 result: B2's bounds
               "attention_q8": 4e-4, "attention_q8_sep": 4e-4}
LOGIT_RTOL_I8 = 2.5e-2   # as LOGIT_RTOL, the 12-layer int8 model
EVAL_RUNS = 5
# the row norms (A2, B1, E1, D3) and the delta pre-pass take 0.02-0.14 ms,
# about the host's time in a wrapper call, which one call's event pair
# would include: they are timed QUEUED_CALLS calls to an event pair (as
# kernels/ab_checkouts.py's CALLS_PER_EVENT), taken in turn on two copies
# of their inputs so that each call reads device memory, not the L2 (D3's
# 50 MB input is about the L2's size)
QUEUED_CALLS = 20
# training attention: C1's out is A1's out (its bounds); lse within one
# flipped bf16 rounding of a probability (log2(1 + 2^-7), 0.0112); C2's
# bf16 dqkv by the share of outputs that differ; fp32 backward sums N
# products in another order
BF16_MISMATCH.update({"attention_fwd_lse": BF16_MISMATCH["attention"],
                      "attention_sep": BF16_MISMATCH["attention"],
                      "attention_bwd": 0.02,
                      # C3 is C1 / C2 on separate operands: their bounds
                      "attention_sep_fwd_lse": BF16_MISMATCH["attention"],
                      "attention_sep_bwd": 0.02,
                      # B4: without GELU the exact plain epilogue, bit for
                      # bit; the MLP's GELU (CUDA tanhf / erff) may round
                      # apart from PyTorch's and flip a hidden code
                      "int8_gemm": 0.0, "int8_mlp": 1e-3})
# C4, the dropout attention: C3 with a keep factor, C1's and C2's bounds
BF16_MISMATCH.update({name: BF16_MISMATCH["attention"] for name in (
    "attention_drop_fwd", "attention_drop_rng_fwd")})
BF16_MISMATCH.update({name: BF16_MISMATCH["attention_bwd"] for name in (
    "attention_drop_bwd", "attention_drop_rng_bwd")})
# E2, bf16 out: where exp2f and torch.exp2 round one probability code
# apart, a row's outputs move by about one code's effect (sv * 254 / l)
BF16_MISMATCH["attention_int8"] = 0.01
# kernels whose result is a (dq, dk, dv) tuple
SEP_GRADS = ("attention_sep_bwd", "attention_drop_bwd",
             "attention_drop_rng_bwd")
LSE_ATOL = 1.2e-2
F32_TOL_BWD = dict(atol=1e-4, rtol=1e-4)
# phase 6 (i): one ViT-B train step, kernels vs plain versions
GRAD_NORM_RTOL = 1e-3
GRAD_PARAM_RTOL = 5e-2
TRAIN_BATCH, TRAIN_LR, TRAIN_STEPS, LOSS_DROP = 8, 1e-4, 10, 0.05
JOB_BATCH = 56
# phase 9: the IV2-S job's lr 1e-3 scaled to its batch 56, as the CLI
# scales it (x batch / 256)
IV2_LR = 1e-3 * JOB_BATCH / 256
# one timing process a phase (three until phase 16, two until phase 17
# came: the run's time limit)
TIMING_PROCESSES, WARMUP_STEPS, TIMED_STEPS, PROFILE_STEPS = 1, 3, 10, 2
# phase 11: the attention dropout rate of the JAX package's own measurement
# (simple_tad_tpu/ops/flash_attention.py:flash_attention's docstring); the
# kernel names of each keep source
ATTN_DROP = 0.1
DROP_KERNELS = {"mask": ("attention_drop_fwd", "attention_drop_bwd"),
                "rng": ("attention_drop_rng_fwd", "attention_drop_rng_bwd")}
# C4 checked at ViT-B's training shape (the wgmma kernels), ViT-H's head
# dim 80 (the forward's wgmma kernel, 96-column tiles, timed with SDPA; the
# backward's mma.sync kernels), head dim 32 (the mma.sync kernels both
# ways, the forward timed with SDPA) and a masked fp32 tail, its Philox
# bits read off at (B, H, N, Dh) on each bf16 forward route (head dim 32:
# the mma.sync kernel), timed at the job's batch (B, N, C, H)
DROP_CASES = [((8, 1568, 2304), 12, torch.bfloat16),
              ((2, 1568, 3840), 16, torch.bfloat16),
              ((2, 1568, 1152), 12, torch.bfloat16),
              ((2, 200, 384), 2, torch.float32)]
DROP_PROBES = [(2, 2, 392, 64), (2, 2, 392, 80), (2, 2, 392, 32)]
DROP_TIMED = (JOB_BATCH, 1568, 768, 12)
# the H100's integer rates an SM a clock (NVIDIA's Hopper architecture
# white paper; the CUDA C++ programming guide's throughput table at compute
# capability 9.0): 64 lanes of 32-bit integer multiply-add (IMAD, on the
# FMA pipe), 64 of the ALU pipe beside it (LOP3, IADD3, ISETP, ...), and
# four schedulers issuing a warp instruction each (128 lanes)
INT_LANES = {"fma": 64, "alu": 64}
ISSUE_LANES = 128
# ... and its special-function units' exp2 (MUFU.EX2) lanes an SM a clock
# (the programming guide's table: 32-bit exp2, log2, reciprocal)
SFU_LANES = 16
BREAKDOWN_STEPS = 4
# phase 12 (i): E1 at ViT-B's norm shape and two tails (fp32; C % 8 != 0),
# E2 at ViT-B's attention shape and a masked key tail (N = 131)
E1_CASES = [((32 * 1568, 768), torch.bfloat16), ((4096, 384), torch.float32),
            ((1000, 100), torch.bfloat16)]
E2_CASES = [((32, 1568, 2304), 12), ((4, 131, 2304), 12),
            # head dim 32: E2's mma.sync route
            ((4, 1568, 1152), 12)]
CLIP_H, CLIP_W = 224, 398          # decode_scaled's short side 224, 16:9
# phase 2, the DAPT and MVD / UMT shapes (bf16, head dim 64, the wgmma
# routes): C1 and C2 at the MAE-B encoder's visible tokens at mask 0.75 and
# 0.9 (N = 392; N = 160, and a 157-row tail), at its decoder (all 1568
# tokens, C = 384 packed, H = 6) and at MVD-B's N = 1569 (the CLS token),
# batch 8 (B, N, 3C, H); timed at DAPT's batch MAE_BATCH (B, N, C, H)
DAPT_TRAIN_CASES = [((8, 392, 2304), 12), ((8, 160, 2304), 12),
                    ((8, 157, 2304), 12), ((8, 1568, 1152), 6),
                    ((8, 1569, 2304), 12)]
# phase 13: DAPT, jobs/dapt/pretrain_bdd_capdata.sh: MAE-B (encoder 768 x
# 12, decoder 384 x 4), 16 frames at 224, tube masks at 0.75 (and 0.9),
# finetune-aligned augmentation, AdamW betas (0.9, 0.95), weight decay
# 0.05, lr 3e-4 scaled to the job's total batch 240 + 160 as the CLI scales
# it; timed at half that batch (the whole 400 does not fit one card with
# the masters and moments: PERF.md)
MAE_MASKS = (0.75, 0.9)
MAE_LR = 3e-4 * 400 / 256
MAE_BATCH = 200
MAE_PARTS = (120, 80)              # the job's 240 : 160 split of a batch
MAE_WARMUP, MAE_TIMED = 2, 8
DAPT_TIMED = [(MAE_BATCH, 392, 768, 12), (MAE_BATCH, 1568, 384, 6)]
# phase 14: the MVD-B and UMT-B fine-tuning jobs (jobs/finetune/
# MVD-B_DoTA.sh, UMT-B_D2K.sh): lr 5e-4 scaled to batch 56, layer decay
# 0.6, weight decay 0.05, drop path 0.2; MVD-B as the job builds it (no
# CLS token: N = 1568; N = 1569 is held in phase 2), UMT-B at tubelet 1 and
# 8 frames (N = 1568), windows of every other frame (--view_fps 5)
TRUNK_LR = 5e-4 * JOB_BATCH / 256
TRUNKS = ("mvd", "umt")
# the end-to-end check's seeds, its bound and the controls it must catch:
# held at the head's input, since max |logit error| / max |logit| swings
# with the seeded head's scale (PERF.md); each A1 and LayerNorm call is
# held at its own inputs as well (check_sites)
TRUNK_SEEDS = 3
FEATURE_RTOL = 1e-2
# phase 15: jobs/distill/IV2-S_dist_1B.sh: the IV2-S student
# (distill_internvideo2_small_patch14_224) from the IV2-1B teacher, 8
# frames at 224, the attention mask at 0.8 (2048 - 1638 = 410 visible
# tokens and the CLS token: N = 411), 6 taps (the teacher's at interval
# 3.34: 23, 26, 29, 33, 36, 39; the student's last 6), MLP decoders, loss
# ratio 1 : 1, drop path 0.05; the reference recipe's AdamW (betas 0.9 /
# 0.98, eps 1e-6, weight decay 0.05) at lr 1e-3 scaled to the job's batch
# 128; timed at that batch (or the largest of DISTILL_BATCHES that fits)
# in DISTILL_PROCESSES processes (one since phase 17 took its time)
DISTILL_TEACHER = "internvideo2_1B_patch14_224"
DISTILL_STUDENT = "distill_internvideo2_small_patch14_224"
DISTILL_MASK_RATIO, DISTILL_RETURN_LAYERS, DISTILL_T_INTERVAL = 0.8, 6, 3.34
DISTILL_MASKED = int(2048 * DISTILL_MASK_RATIO)
DISTILL_N = 2048 + 1 - DISTILL_MASKED
DISTILL_BATCH = 128
DISTILL_BATCHES = (DISTILL_BATCH, 96, 64)
DISTILL_LR = 1e-3 * DISTILL_BATCH / 256
DISTILL_BETAS, DISTILL_EPS = (0.9, 0.98), 1e-6
# the job's flags (jobs/distill/IV2-S_dist_1B.sh, which passes the JAX
# CLI's AdamW betas and eps: here the recipe's, as in (i)); no data is read
DISTILL_FLAGS = [
    "--objective", "masked_feature", "--mask_type", "attention",
    "--mask_ratio", str(DISTILL_MASK_RATIO),
    "--clip_return_layer", str(DISTILL_RETURN_LAYERS),
    "--clip_teacher_return_interval", str(DISTILL_T_INTERVAL),
    "--clip_student_return_interval", "1", "--clip_teacher_embed_dim",
    "1408", "--clip_teacher_final_dim", "768", "--clip_loss_ratio", "1",
    "1", "--clip_norm_type", "l2", "--clip_student_decoder", "mlp",
    "--drop_path", "0.05", "--data_set", "K700", "--data_path", "",
    "--model", DISTILL_STUDENT, "--teacher_model", DISTILL_TEACHER,
    "--epochs", "101", "--warmup_epochs", "20", "--lr", "1e-3",
    "--weight_decay", "0.05", "--num_frames", "8", "--sampling_rate", "1",
    "--opt_betas", *map(str, DISTILL_BETAS), "--opt_eps", str(DISTILL_EPS),
    "--device", "cuda"]
# (iii): the first process times DISTILL_STEPS_FIRST steps after
# DISTILL_WARMUP and takes the profiler window, the second DISTILL_STEPS
DISTILL_WARMUP, DISTILL_STEPS_FIRST, DISTILL_STEPS = 2, 5, 3
DISTILL_PROCESSES = 1
# the share of attention-mask positions the kernels' teacher may move from
# the plain one's on the same noise (a token near the threshold flips).
# This holds the mask's plumbing (the step takes the noise it is given, in
# the threshold form), not the kernels: the seeded teacher's pooling
# attention is near uniform, so even the gross control's teacher moves
# fewer positions than this; the kernels are held by the sites and the
# features
DISTILL_MASK_SHARE = 2e-2
# phase 2 at phase 15's shapes: C3 at the student's N = 411 (a 27-row tail
# tile) at batch 8, two launches bit-equal; timed at DISTILL_BATCH: A1-sep
# at the teacher's (B, 2049, 3 x 1408) H = 16 (head dim 88, wgmma) and
# C3 at (B, 411, 3 x 384) H = 6 (wgmma)
DISTILL_CHECK = ((8, DISTILL_N, 1152), 6)
DISTILL_TIMED = [((DISTILL_BATCH, 2049, 4224), 16),
                 ((DISTILL_BATCH, DISTILL_N, 1152), 6)]
# the plain attention at DISTILL_BATCH, taken this many samples at a time
# (its fp32 scores at B = 128 would not fit)
PLAIN_CHUNK = 8
# phase 16: InternVideo2 probing, class fine-tuning and DAPT, each through
# its CLI's trainer on its job's flags (no data is read: clips come from
# memory).  (i)-(ii) jobs/probe/IV2-1B_ap_K710.sh, the attentive probe
# (open_block_num 0, the pooling head open; 16 frames, 710 classes, lr 2e-4,
# no weight decay, layer decay 1.0, drop path 0, the CLI's mixup 0.8 /
# cutmix 1.0 and RandomErasing 0.25), checked at PROBE_CHECK_BATCH (and
# once with open_block_num 1) with warm-up 0 (the job warms the lr up from
# 0, which would leave the checked step's update at 0), timed at the job's
# PROBE_BATCH in PROBE_PROCESSES processes; (iii) jobs/probe/
# IV2-6B_ap_ANet.sh (200 classes, no erasing) at full width, the depth cut
# to PROBE_6B_DEPTH blocks, batch PROBE_6B_BATCH
PROBE_FLAGS = ["--model", "internvideo2_1B_patch14_224", "--anno_train", "",
               "--nb_classes", "710", "--open_block_num", "0",
               "--open_clip_projector", "--epochs", "25",
               "--warmup_epochs", "5", "--lr", "2e-4", "--min_lr", "0",
               "--weight_decay", "0", "--layer_decay", "1.0",
               "--opt", "adamw", "--opt_betas", "0.9", "0.999",
               "--num_frames", "16", "--sparse_sampling",
               "--input_size", "224", "--short_side_size", "224",
               "--drop_path", "0.0", "--test_num_segment", "1",
               "--test_num_crop", "3"]
PROBE_6B_FLAGS = ["--model", "internvideo2_6B_patch14_224",
                  "--data_set", "ANet", "--anno_train", "",
                  "--nb_classes", "200", "--open_block_num", "0",
                  "--open_clip_projector", "--epochs", "40",
                  "--warmup_epochs", "0", "--lr", "2e-4", "--min_lr", "0",
                  "--weight_decay", "0", "--layer_decay", "1.0",
                  "--opt", "adamw", "--opt_betas", "0.9", "0.999",
                  "--num_frames", "16", "--input_size", "224",
                  "--short_side_size", "224", "--drop_path", "0.0",
                  "--reprob", "0.0", "--test_num_segment", "4",
                  "--test_num_crop", "3"]
PROBE_BATCH, PROBE_CHECK_BATCH, PROBE_PROCESSES = 64, 2, 1
PROBE_WARMUP, PROBE_STEPS = 1, 3
PROBE_6B_DEPTH, PROBE_6B_BATCH = 4, 4
# (iv) jobs/finetune/IV2-B_ft_K710.sh: 8 frames, 710 classes, lr 2e-4
# scaled to the batch, warm-up 4 epochs, layer decay 0.75, drop path 0.1,
# the CLI's mixup / cutmix, RandAugment m7 n4, RandomErasing 0.25; checked
# at TRAIN_BATCH (warm-up 0, as (i)), then TRAIN_STEPS steps on one batch at
# the constant CLS_FIT_LR (the job's lr scaled to 8 clips, 6.25e-6, moves
# the loss of 710 classes too little in 10 steps to show the fit); timed at
# the job's CLS_BATCH in one process
CLS_FLAGS = ["--model", "internvideo2_base_patch14_224", "--anno_train", "",
             "--nb_classes", "710", "--epochs", "20", "--warmup_epochs", "4",
             "--lr", "2e-4", "--weight_decay", "0.05", "--layer_decay",
             "0.75", "--opt", "adamw", "--opt_betas", "0.9", "0.999",
             "--num_frames", "8", "--sparse_sampling", "--input_size", "224",
             "--short_side_size", "224", "--drop_path", "0.1",
             "--test_num_segment", "4", "--test_num_crop", "3"]
CLS_BATCH, CLS_FIT_LR = 32, 1e-3
# (v) jobs/dapt/IV2-S_dapt_bdd_capdata.sh: 16 frames, tube masks at 0.75
# over 16 x 16 x 16 tokens (tubelet 1), decoder depth 4, AdamW (0.9, 0.95),
# weight decay 0.05, lr 3e-4 scaled to 64 + 64, pretrain_augment_orig (the
# job passes no --transforms_finetune_align); checked at TRAIN_BATCH, timed
# at the job's IV2_DAPT_PARTS in one process
IV2_DAPT_MODEL = "pretrain_videomae_internvideo2_small_patch14_224"
IV2_DAPT_PARTS = (64, 64)
IV2_DAPT_WINDOW, IV2_DAPT_MASK = (16, 16, 16), 0.75
IV2_DAPT_LR = 3e-4 * sum(IV2_DAPT_PARTS) / 256
# the fixed-batch fit's constant lr: at IV2_DAPT_LR the loss of one batch
# fell 4.5% in 10 steps on the H100, steadily (PERF.md); the fit
# runs at phase 13's MAE_LR
IV2_DAPT_FIT_LR = MAE_LR
# phase 2 at phase 16's shapes: A1-sep at 16 frames (N = 4097), IV2-1B's
# head dim 88 and IV2-6B's 128; C3 at the IV2-S DAPT encoder's 1024
# visible tokens; C1 / C2 at its decoder (C = 192 packed, H = 3)
PROBE_SEP_CASES = [((4, 4097, 4224), 16, "IV2-1B probe"),
                   ((2, 4097, 9600), 25, "IV2-6B probe")]
IV2_DAPT_ENCODER = ((8, 1024, 1152), 6)
IV2_DAPT_DECODER = (8, 4096, 192, 3)
# phase 17: gradient checkpointing, the DAPT job's own step on one card and
# data parallelism.  (i) remat against the step without it at batch 8, drop
# path 0.1, attention dropout ATTN_DROP in the ViT-B case; (ii) the DAPT
# job's 240 + 160 clips a step (jobs/dapt/pretrain_bdd_capdata.sh) with
# --use_checkpoint, and as 2 x (120 + 80) with --update_freq 2, each in
# one fresh process, DAPT_JOB_TIMED steps after DAPT_JOB_WARMUP; (iii) a
# one-process NCCL group: DDP_STEPS ViT-B steps at TRAIN_BATCH through
# FinetuneTrainer, plain and with --zero_stage 1, against the same steps
# without a group, in a process given DDP_TIMEOUT_S
REMAT_DROP_PATH = 0.1
DAPT_JOB_PARTS = (240, 160)
DAPT_ACCUM_PARTS = (120, 80)
DAPT_JOB_WARMUP, DAPT_JOB_TIMED = 2, 5
DDP_STEPS = 3
DDP_TIMEOUT_S = 300
# phase 18: (i) jobs/vis.sh's mae-recon (cli/visualize.py:reconstruct): the
# job's model and flags, seeded weights (the repo holds no checkpoint), fp32,
# on a synthetic 16-frame 360x640 clip from memory; its recon held to the
# same core on the plain versions within RECON_ATOL (the recon is in [0, 1]
# pixel units), against two controls that must fail it (the patches
# un-normalised without the std; every head reading the next head's v);
# the reconstruction timed RECON_RUNS times.  (ii) cli/efficiency.py's
# benchmark_model on ViT-B bf16 at EFFICIENCY_BATCHES, EFFICIENCY_ITERS
# iterations
RECON_MODEL = "pretrain_videomae_base_patch16_224"
RECON_FLAGS = dict(mask_ratio=0.9, decoder_depth=4, num_frames=16,
                   input_size=224, seed=42)
RECON_ATOL = 1e-3
RECON_RUNS = 3
EFFICIENCY_BATCHES = (1, 32)
EFFICIENCY_ITERS = 4
# phases 7 and 8: IV2-S of jobs/finetune/IV2-S_DoTA.sh (--num_frames 8
# --view_fps 5 on 10 fps DoTA: windows of every other frame)
IV2_VIEW_STEP = 2
LOGIT_RTOL_IV2 = 5.7e-3      # as LOGIT_RTOL, the 12-layer bf16 IV2-S
LOGIT_RTOL_IV2_I8 = 2.5e-2   # as LOGIT_RTOL_I8
# the card's data-sheet rates (H100 SXM, dense): bf16 tensor cores, int8
# tensor cores, fp32 outside the tensor cores, device memory
PEAK = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12, "bytes": 3.35e12}
# the training forward with lse at IV2-1B's head dim 88 and IV2-6B's 128
# (the wgmma route's 96- and 128-column tiles), packed (C1) and on
# separate operands (C3-fwd), at N = 2049
WIDE_LSE_CASES = [((4, 2049, 4224), 16), ((2, 2049, 9600), 25)]
# kernel name -> (source, the TPU kernel it replaces)
SOURCES = {
    "layernorm": ("simple_tad_tpu_torch/csrc/layernorm.cu",
                  "simple_tad_tpu/ops/ln.py:27"),
    "attention": ("simple_tad_tpu_torch/csrc/attention.cu",
                  "simple_tad_tpu/ops/flash_attention.py:293"),
    "layernorm_quant": ("simple_tad_tpu_torch/csrc/layernorm.cu",
                        "simple_tad_tpu/ops/ln.py:37"),
    "attention_i8": ("simple_tad_tpu_torch/csrc/attention_i8.cu",
                     "simple_tad_tpu/ops/flash_attention.py:1158"),
    "attention_fwd_lse": ("simple_tad_tpu_torch/csrc/attention.cu",
                          "simple_tad_tpu/ops/flash_attention.py:875"),
    "attention_bwd": ("simple_tad_tpu_torch/csrc/attention_train.cu",
                      "simple_tad_tpu/ops/flash_attention.py:945"),
    # InternVideo2 at N = 2049: the key-grid kernels (the same kernels also
    # take the single-pass _fwd_kernel_nomax_packed / _q8io on separate
    # operands, flash_attention.py:293 and :1158, at shorter N)
    "attention_sep": ("simple_tad_tpu_torch/csrc/attention.cu",
                      "simple_tad_tpu/ops/flash_attention.py:541"),
    "attention_i8_sep": ("simple_tad_tpu_torch/csrc/attention_i8.cu",
                         "simple_tad_tpu/ops/flash_attention.py:645"),
    "rmsnorm_quant": ("simple_tad_tpu_torch/csrc/layernorm.cu",
                      "simple_tad_tpu/ops/ln.py:155"),
    # InternVideo2 training (C3): _fwd_kernel, launched by _flash_fwd_impl,
    # and _bwd_merged_kernel_dt, launched by _flash_bwd_impl (its other
    # orientations _bwd_merged_kernel, _bwd_dq_kernel and _bwd_dkv_kernel,
    # flash_attention.py:2183, :2124, :2151, compute the same function)
    "attention_sep_fwd_lse": ("simple_tad_tpu_torch/csrc/attention.cu",
                              "simple_tad_tpu/ops/flash_attention.py:1532"),
    "attention_sep_bwd": ("simple_tad_tpu_torch/csrc/attention_train.cu",
                          "simple_tad_tpu/ops/flash_attention.py:2238"),
    # static int8 on the fused GEMMs (B4) and the int8-output attention
    # (B3: _fwd_kernel_nomax_packed_q8 on the packed qkv; on separate
    # operands at N = 2049 the key-grid _fwd_kernel_nomax_packed_kv_q8)
    "int8_gemm": ("simple_tad_tpu_torch/csrc/int8_gemm.cu",
                  "simple_tad_tpu/ops/int8_gemm.py:92"),
    "int8_mlp": ("simple_tad_tpu_torch/csrc/int8_gemm.cu",
                 "simple_tad_tpu/ops/int8_gemm.py:170"),
    "attention_q8": ("simple_tad_tpu_torch/csrc/attention.cu",
                     "simple_tad_tpu/ops/flash_attention.py:265"),
    "attention_q8_sep": ("simple_tad_tpu_torch/csrc/attention.cu",
                         "simple_tad_tpu/ops/flash_attention.py:567"),
    # attention dropout (C4): the mask form's _fwd_kernel_drop and
    # _bwd_dq_kernel_drop (with _bwd_dkv_kernel_drop, :1654), the RNG
    # form's _fwd_kernel_drop_rng and _bwd_merged_kernel_drop_rng (its
    # split forms _bwd_dq_kernel_drop_rng, :1863, and
    # _bwd_dkv_kernel_drop_rng, :1898, compute the same function)
    "attention_drop_fwd": ("simple_tad_tpu_torch/csrc/attention.cu",
                           "simple_tad_tpu/ops/flash_attention.py:1606"),
    "attention_drop_bwd": ("simple_tad_tpu_torch/csrc/attention_train.cu",
                           "simple_tad_tpu/ops/flash_attention.py:1628"),
    "attention_drop_rng_fwd": ("simple_tad_tpu_torch/csrc/attention.cu",
                               "simple_tad_tpu/ops/flash_attention.py:1833"),
    "attention_drop_rng_bwd": ("simple_tad_tpu_torch/csrc/attention_train.cu",
                               "simple_tad_tpu/ops/flash_attention.py:1941"),
    # the static int8 ViT's opt-in variants: E1, _add_ln_quant_kernel
    # (launched by fused_add_layernorm_quant, ln.py:135), and E2,
    # _fwd_kernel_int8_packed (launched by flash_attention_qkv_int8,
    # flash_attention.py:1140)
    "add_layernorm_quant": ("simple_tad_tpu_torch/csrc/layernorm.cu",
                            "simple_tad_tpu/ops/ln.py:91"),
    "attention_int8": ("simple_tad_tpu_torch/csrc/attention_int8.cu",
                       "simple_tad_tpu/ops/flash_attention.py:1081"),
    # the backward's delta pre-pass (C2, C3-bwd and C4-bwd launch it): the
    # XLA rowsum _flash_bwd_impl runs beside its TPU kernels (the packed
    # _flash_bwd_packed_qkv_impl's is its einsum at :1020)
    "attention_delta": ("simple_tad_tpu_torch/csrc/attention_train.cu",
                        "simple_tad_tpu/ops/flash_attention.py:2299"),
}


def cuda_ms(fn, runs: int = 30, warmup: int = 3) -> float:
    """Median device time of one call in ms, CUDA events around each run.
    ``fn``: a callable, one call a run; or a tuple of callables (the same
    call on other copies of its inputs, ``in_turn``), QUEUED_CALLS calls a
    run, taken in turn."""
    fns = fn if isinstance(fn, tuple) else (fn,)
    calls = QUEUED_CALLS if isinstance(fn, tuple) else 1
    for i in range(warmup):
        fns[i % len(fns)]()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(calls):
            fns[i % len(fns)]()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def in_turn(fn, *inputs) -> tuple:
    """fn on each of ``inputs`` (argument tuples): calls that cuda_ms times
    queued, in turn; a check takes the first."""
    return tuple(functools.partial(fn, *args) for args in inputs)


def first_call(fn):
    """The call a check makes of a kernel, plain version or control."""
    return fn[0] if isinstance(fn, tuple) else fn


def device_check() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none found")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}")
    return torch.cuda.get_device_name(0)


def build_kernels() -> None:
    from simple_tad_tpu_torch.kernels import build as kbuild
    t0 = time.perf_counter()
    kbuild.load()
    print(f"[build] {time.perf_counter() - t0:.1f} s -> "
          f"{kbuild.library_path()}")
    log = kbuild.library_path().parent / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if any(w in line for w in ("Used", "spill", "Compiling",
                                       "wgmma")):
                print("[ptxas]", line.strip())


def merge_heads(o):
    """(B, H, N, Dh) -> (B, N, C)."""
    B, H, N, D = o.shape
    return o.permute(0, 2, 1, 3).reshape(B, N, H * D)


def sep_heads(num_heads: int, *ts):
    """Separate (B, N, C) operands -> (B, H, N, Dh) views."""
    return [t.view(*t.shape[:2], num_heads, -1).transpose(1, 2) for t in ts]


def _attention_control(q, k, v, scale: float):
    """(B, H, N, Dh) -> the plain attention without the probability
    rounding: fp32 probabilities go into PV and the denominator, as a
    kernel that skipped that step would compute."""
    from simple_tad_tpu_torch.ops.flash_attention import LOG2E
    qs = (q.float() * (scale * LOG2E)).to(q.dtype)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    p = torch.exp2(s - torch.ceil(s.amax(dim=-1, keepdim=True)))
    o = torch.matmul(p, v.float()) / p.sum(dim=-1, keepdim=True)
    return merge_heads(o.to(q.dtype))


def attention_control(qkv, num_heads: int, scale: float):
    """The control of the packed attention (A1)."""
    return _attention_control(*qkv_views(qkv, num_heads), scale)


def attention_sep_control(q, k, v, num_heads: int, scale: float):
    """The control of the separate-operand attention (A1 sep)."""
    return _attention_control(*sep_heads(num_heads, q, k, v), scale)


def _attention_i8_variant(q, k, v, amax, scale: float, out_amax, *,
                          round_p: bool, normalize: bool):
    """int8 (B, H, N, Dh) -> the plain int8 attention with a required step
    left out: the probability rounding to bf16 (``round_p=False``: the
    control) or the softmax denominator (``normalize=False``: the gross
    control of the int8 logit check)."""
    from simple_tad_tpu_torch.ops.flash_attention import LOG2E
    from simple_tad_tpu_torch.ops.ln import quantize_static
    sq, sk, sv = (amax * (1.0 / 127.0))[..., None, None]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * (sq * sk * scale * LOG2E)
    p = torch.exp2(s - torch.ceil(s.amax(dim=-1, keepdim=True)))
    if round_p:
        p = p.to(torch.bfloat16).float()
    o = torch.matmul(p, (v.float() * sv).to(torch.bfloat16).float())
    if normalize:
        o = o / p.sum(dim=-1, keepdim=True)
    return quantize_static(merge_heads(o), out_amax)


def attention_i8_control(qkv_i8, amax, num_heads, scale, out_amax):
    return _attention_i8_variant(*qkv_views(qkv_i8, num_heads), amax, scale,
                                 out_amax, round_p=False, normalize=True)


def attention_i8_unnormalized(qkv_i8, amax, num_heads, scale, out_amax):
    return _attention_i8_variant(*qkv_views(qkv_i8, num_heads), amax, scale,
                                 out_amax, round_p=True, normalize=False)


def _i8_sep_variant(q, k, v, amax, num_heads, scale, out_amax, n_valid=None,
                    **steps):
    q, k, v = sep_heads(num_heads, q, k, v)
    if n_valid is not None:
        k, v = k[:, :, :n_valid], v[:, :, :n_valid]
    return _attention_i8_variant(q, k, v, amax, scale, out_amax, **steps)


def attention_i8_sep_control(*args):
    """The control of the separate-operand int8 attention (D2)."""
    return _i8_sep_variant(*args, round_p=False, normalize=True)


def attention_i8_sep_unnormalized(*args):
    return _i8_sep_variant(*args, round_p=True, normalize=False)


def misread_v(q, v):
    """v read with q's row stride (C) instead of its own (3C, the column
    block of the qkv output): the fault a kernel with one stride pair for
    all operands would make with no error."""
    return v.as_strided(v.shape, q.stride())


def attention_sep_misread_v(q, k, v, num_heads: int, scale: float):
    """The gross control of the IV2 logit check (``misread_v``)."""
    from simple_tad_tpu_torch.ops.flash_attention import flash_attention_plain
    return flash_attention_plain(q, k, misread_v(q, v), num_heads, scale)


def attention_sep_fwd_lse_misread_v(q, k, v, num_heads: int, scale: float):
    """The plain C3 forward with v misread (``misread_v``)."""
    from simple_tad_tpu_torch.ops.flash_attention import (
        flash_attention_fwd_lse_plain)
    return flash_attention_fwd_lse_plain(q, k, misread_v(q, v), num_heads,
                                         scale)


def attention_sep_bwd_misread_v(q, k, v, out, lse, dout, num_heads: int,
                                scale: float):
    """The plain C3 backward with v misread (``misread_v``)."""
    from simple_tad_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_plain)
    return flash_attention_bwd_plain(q, k, misread_v(q, v), out, lse, dout,
                                     num_heads, scale)


def rmsnorm_quant_control(x, weight, inv_c, eps: float = 1e-6):
    """The plain RMSNorm->int8 quantizing the bf16-rounded value instead of
    the fp32 one (the rounding site of the unfused int8 program)."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    y = (y * weight.float()).to(torch.bfloat16).float()
    return torch.clamp(torch.round(y * inv_c.float()), -127,
                       127).to(torch.int8)


def _layernorm_control_f32(x, weight, bias, eps):
    x32 = x.float()
    xc = x32 - x32.mean(dim=-1, keepdim=True)
    var = (xc * xc).sum(dim=-1, keepdim=True) / (x.shape[-1] - 1)
    return xc * torch.rsqrt(var + eps) * weight.float() + bias.float()


def layernorm_control(x, weight, bias, eps: float = 1e-6, out_dtype=None):
    """The plain LayerNorm with the unbiased variance, as a kernel that got
    that step wrong would compute."""
    return _layernorm_control_f32(x, weight, bias, eps).to(
        out_dtype or x.dtype)


def layernorm_quant_control(x, weight, bias, amax, eps: float = 1e-6):
    """The plain LayerNorm->int8 with the unbiased variance."""
    from simple_tad_tpu_torch.ops.ln import quantize_static
    return quantize_static(_layernorm_control_f32(x, weight, bias, eps), amax)


def _q8_variant(q, k, v, scale: float, out_amax, *, round_p: bool,
                normalize: bool):
    """(B, H, N, Dh) bf16/fp32 -> B3's plain computation with a required
    step left out (as ``_attention_i8_variant``), quantized against
    ``out_amax``."""
    from simple_tad_tpu_torch.ops.flash_attention import LOG2E
    from simple_tad_tpu_torch.ops.ln import quantize_static
    qs = (q.float() * (scale * LOG2E)).to(q.dtype)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    p = torch.exp2(s - torch.ceil(s.amax(dim=-1, keepdim=True)))
    if round_p:
        p = p.to(v.dtype).float()
    o = torch.matmul(p, v.float())
    if normalize:
        o = o / p.sum(dim=-1, keepdim=True)
    return quantize_static(merge_heads(o), out_amax)


def attention_q8_control(qkv, num_heads, scale, out_amax):
    """B3's control: probabilities not rounded to bf16."""
    return _q8_variant(*qkv_views(qkv, num_heads), scale, out_amax,
                       round_p=False, normalize=True)


def attention_q8_unnormalized(qkv, num_heads, scale, out_amax):
    return _q8_variant(*qkv_views(qkv, num_heads), scale, out_amax,
                       round_p=True, normalize=False)


def _q8_sep_variant(q, k, v, num_heads, scale, out_amax, n_valid=None,
                    **steps):
    q, k, v = sep_heads(num_heads, q, k, v)
    if n_valid is not None:
        k, v = k[:, :, :n_valid], v[:, :, :n_valid]
    return _q8_variant(q, k, v, scale, out_amax, **steps)


def attention_q8_sep_control(*args):
    return _q8_sep_variant(*args, round_p=False, normalize=True)


def attention_q8_sep_unnormalized(*args):
    return _q8_sep_variant(*args, round_p=True, normalize=False)


def attention_q8_sep_misread_v(q, k, v, num_heads, scale, out_amax,
                               n_valid=None):
    """B3 on separate operands with v misread (``misread_v``)."""
    from simple_tad_tpu_torch.ops.flash_attention import (
        flash_attention_q8_plain)
    return flash_attention_q8_plain(q, k, misread_v(q, v), num_heads, scale,
                                    out_amax, n_valid)


def add_layernorm_quant_control(branch, residual, weight, bias, amax,
                                eps: float = 1e-6):
    """E1's control: B1's (the unbiased variance) on the stored sum ->
    (sum, codes)."""
    from simple_tad_tpu_torch.ops.ln import add_layernorm_quant_plain
    total, _ = add_layernorm_quant_plain(branch, residual, weight, bias,
                                         amax, eps)
    return total, layernorm_quant_control(total, weight, bias, amax, eps)


def add_layernorm_quant_residual_only(branch, residual, weight, bias, amax,
                                      eps: float = 1e-6):
    """E1's gross control: the codes of the residual alone (the add left
    out of the LayerNorm's input) -> (sum, codes)."""
    from simple_tad_tpu_torch.ops.ln import (add_layernorm_quant_plain,
                                             layernorm_quant_plain)
    total, _ = add_layernorm_quant_plain(branch, residual, weight, bias,
                                         amax, eps)
    return total, layernorm_quant_plain(residual, weight, bias, amax, eps)


def unpermuted_keys(n: int, device):
    """(n,) the key whose v each PV term reads where the V tile is staged
    without E2's key permutation: key j reads key perm_key(j) of its 64-key
    tile (csrc/attention_int8.cu), where that is below n."""
    j = torch.arange(n, device=device)
    q = j % 16
    perm = j - q + 4 * ((q % 8) // 2) + q % 2 + 2 * (q // 8)
    return torch.where(perm < n, perm, j)


def _int8_attention_variant(qkv_i8, amax, num_heads, scale, *,
                            round_p=True, max_free=False, normalize=True,
                            permute_v=False):
    """E2's plain computation with a required step left out -> bf16
    (B, N, C): the probability codes not rounded (``round_p=False``), the
    maximum not subtracted (``max_free``: B2's integer running maximum, the
    max-free result), the denominator left out (``normalize=False``: the
    gross control of the logit check), or v read without the key
    permutation (``permute_v``)."""
    from simple_tad_tpu_torch.ops import flash_attention as fa
    q, k, v = qkv_views(qkv_i8, num_heads)
    sq, sk, sv = (amax.float() * (1.0 / 127.0))[..., None, None]
    with fa._fp32_matmul_exact():
        s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * (sq * sk * scale * fa.LOG2E)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - (torch.ceil(m) if max_free else m)) * 127.0
    if round_p:
        p = torch.round(p)
    if permute_v:
        v = v[:, :, unpermuted_keys(v.shape[2], v.device)]
    o = torch.matmul(p.double(), v.double()).float()
    if normalize:
        o = o / p.sum(dim=-1, keepdim=True)
    return merge_heads((o * sv).to(torch.bfloat16))


def attention_int8_unrounded(*args):
    return _int8_attention_variant(*args, round_p=False)


def attention_int8_max_free(*args):
    return _int8_attention_variant(*args, max_free=True)


def attention_int8_unpermuted_v(*args):
    return _int8_attention_variant(*args, permute_v=True)


def attention_int8_unnormalized(*args):
    return _int8_attention_variant(*args, normalize=False)


def _roundf_codes(y, amax):
    """q8 rounding half away from zero (C's roundf) instead of half to
    even: the fault ROADMAP F1 warns of."""
    y = y * (127.0 / torch.clamp(amax.float(), min=1e-12))
    return torch.clamp(torch.sign(y) * torch.floor(y.abs() + 0.5), -127,
                       127).to(torch.int8)


def int8_gemm_roundf(x, w_q, w_scale, a_amax, bias=None, act=None,
                     out_dtype=torch.bfloat16):
    """The GEMM's control where x is a float: q8 with roundf."""
    from simple_tad_tpu_torch.ops.int8_gemm import w8a8_gemm_plain
    if x.dtype != torch.int8:
        x = _roundf_codes(x.float(), a_amax)
    return w8a8_gemm_plain(x, w_q, w_scale, a_amax, bias, act, out_dtype)


def int8_gemm_bf16_rescale(x, w_q, w_scale, a_amax, bias=None, act=None,
                           out_dtype=torch.bfloat16):
    """The GEMM's control where x is int8 codes: the exact product rounded
    to bf16 before an fp32 rescale done in bf16 (the fp32 epilogue left
    out)."""
    from simple_tad_tpu_torch.ops import int8_gemm
    from simple_tad_tpu_torch.ops.ln import quantize_static
    from simple_tad_tpu_torch.ops.quant import _int_mm
    if x.dtype != torch.int8:
        x = quantize_static(x.float(), a_amax)
    y = (_int_mm(x, w_q).to(torch.bfloat16)
         * int8_gemm.rescale(w_scale, a_amax).to(torch.bfloat16)).float()
    if bias is not None:
        y = y + bias
    return int8_gemm.activation(y, act).to(out_dtype)


def int8_mlp_no_bias1(x, w1_q, s1, amax1, b1, *rest):
    """The MLP's control: fc1's bias left out."""
    from simple_tad_tpu_torch.ops.int8_gemm import w8a8_mlp_plain
    return w8a8_mlp_plain(x, w1_q, s1, amax1, None, *rest)


def int8_mlp_bf16_hidden(x, w1_q, s1, amax1, b1, w2_q, s2, amax2, b2,
                         act="gelu_tanh", out_dtype=torch.bfloat16):
    """The MLP's control: fc1's activation rounded to bf16 before its q8
    (the fp32 value is the one quantized; the seeded models' biases are
    zero, so this is the control the main-path check can use)."""
    from simple_tad_tpu_torch.ops.int8_gemm import w8a8_gemm_plain
    h = w8a8_gemm_plain(x, w1_q, s1, amax1, b1, act, torch.bfloat16)
    return w8a8_gemm_plain(h, w2_q, s2, amax2, b2, None, out_dtype)


def int8_library(*products):
    """torch._int_mm on the same int8 operands ((codes, weight) pairs: two
    for the MLP, its hidden codes made beforehand): the products alone,
    with none of the kernels' quantize, rescale, bias or GELU."""
    def run():
        for x_i8, w_q in products:
            torch._int_mm(x_i8.reshape(-1, x_i8.shape[-1]), w_q.t())
    return run


def int8_gemm_bound(M, K, N, in_bytes, out_bytes):
    """-> (bound ms, by): 2 M K N int8 operations; x, W, the (N,) vectors
    read once and y written once."""
    t_ops = 2.0 * M * K * N / PEAK["int8"]
    t_bytes = (M * K * in_bytes + N * K + 8 * N + M * N * out_bytes
               ) / PEAK["bytes"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def int8_mlp_bound(M, dim, hidden, in_bytes, out_bytes):
    """-> (bound ms, by): two products of 2 M dim hidden int8 operations;
    x, both weights and the vectors read once, y written once (the
    (M, hidden) activation never leaves the chip)."""
    t_ops = 4.0 * M * dim * hidden / PEAK["int8"]
    t_bytes = (M * dim * (in_bytes + out_bytes) + 2 * dim * hidden
               + 8 * (dim + hidden)) / PEAK["bytes"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def compare(name, got, want):
    """-> (max abs error, share of elements that differ, within the bounds
    of kernel ``name``)."""
    if name == "add_layernorm_quant" and isinstance(got, tuple):
        # E1: (sum, codes), the sum bit for bit
        err, share, ok = compare(name, got[1], want[1])
        return err, share, ok and torch.equal(got[0], want[0])
    if name in SEP_GRADS:                  # C3-bwd, C4-bwd: (dq, dk, dv)
        got, want = torch.cat(got, -1), torch.cat(want, -1)
    if isinstance(got, tuple):             # C1, C3-fwd: (out, lse)
        err, share, ok = compare(name, got[0], want[0])
        lse_err = (got[1] - want[1]).abs().max().item()
        print(f"[{name}] lse max_abs_err {lse_err:.3e} (bound {LSE_ATOL})")
        return max(err, lse_err), share, ok and lse_err <= LSE_ATOL
    err = (got.float() - want.float()).abs().max().item()
    share = (got != want).float().mean().item()
    if got.dtype == torch.int8:
        ok = err <= 1 and share <= I8_MISMATCH[name]
    elif got.dtype == torch.bfloat16:
        ok = (torch.allclose(got.float(), want.float(), **BF16_TOL)
              and share <= BF16_MISMATCH[name])
    else:
        tol = (F32_TOL_BWD if name == "attention_bwd" or name in SEP_GRADS
               else F32_TOL)
        ok = torch.allclose(got, want, **tol)
    return err, share, ok


def _fwd_lse_control(q, k, v, scale: float):
    """(B, H, N, Dh) -> the plain training forward without the probability
    rounding -> (out (B, N, C), lse (B, H, N))."""
    from simple_tad_tpu_torch.ops.flash_attention import LOG2E
    qs = (q.float() * (scale * LOG2E)).to(q.dtype)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    m = torch.ceil(s.amax(dim=-1, keepdim=True))
    p = torch.exp2(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v.float()) / denom
    return merge_heads(o.to(q.dtype)), (m + torch.log2(denom))[..., 0]


def attention_fwd_lse_control(qkv, num_heads: int, scale: float):
    """The control of the packed training forward (C1)."""
    return _fwd_lse_control(*qkv_views(qkv, num_heads), scale)


def attention_sep_fwd_lse_control(q, k, v, num_heads: int, scale: float):
    """The control of the separate-operand training forward (C3-fwd)."""
    return _fwd_lse_control(*sep_heads(num_heads, q, k, v), scale)


def _bwd_variant(q, k, v, out, lse, dout, num_heads: int, scale: float, *,
                 round_p: bool = True, use_delta: bool = True):
    """(B, H, N, Dh) q, k, v -> the plain training backward's (dq, dk, dv)
    (B, H, N, Dh) fp32 with a required step left out: the rounding of p
    before dV (``round_p=False``, phase 2's control) or the delta term of
    ds (``use_delta=False``, the gradient control of phases 6 and 9)."""
    from simple_tad_tpu_torch.ops.flash_attention import (LOG2E,
                                                          attention_delta)
    dt = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    do = sep_heads(num_heads, dout)[0].float()
    delta = attention_delta(out, dout, num_heads)[..., None]
    s = torch.matmul((q * (scale * LOG2E)).to(dt).float(),
                     k.transpose(-1, -2))
    p = torch.exp2(s - lse[..., None])
    pv = p.to(dt).float() if round_p else p
    dv = torch.matmul(pv.transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = (p * (dp - delta if use_delta else dp)).to(dt).float()
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    dq = torch.matmul(ds, k) * scale
    return dq, dk, dv


def attention_bwd_variant(qkv, out, lse, dout, num_heads: int, scale: float,
                          **steps):
    """``_bwd_variant`` on the packed qkv -> dqkv (B, N, 3C)."""
    B, N, C3 = qkv.shape
    grads = torch.stack(_bwd_variant(*qkv_views(qkv, num_heads), out, lse,
                                     dout, num_heads, scale, **steps))
    return grads.to(qkv.dtype).permute(1, 3, 0, 2, 4).reshape(B, N, C3)


def attention_sep_bwd_variant(q, k, v, out, lse, dout, num_heads: int,
                              scale: float, **steps):
    """``_bwd_variant`` on separate operands -> (dq, dk, dv) (B, N, C)."""
    return tuple(merge_heads(g.to(q.dtype)) for g in _bwd_variant(
        *sep_heads(num_heads, q, k, v), out, lse, dout, num_heads, scale,
        **steps))


def attention_bwd_control(*args):
    return attention_bwd_variant(*args, round_p=False)


def attention_bwd_no_delta(*args):
    return attention_bwd_variant(*args, use_delta=False)


def attention_sep_bwd_control(*args):
    return attention_sep_bwd_variant(*args, round_p=False)


def attention_sep_bwd_no_delta(*args):
    return attention_sep_bwd_variant(*args, use_delta=False)


def qkv_views(qkv, num_heads: int):
    """(B, N, 3C) -> q, k, v views (B, H, N, Dh), no copies."""
    B, N, C3 = qkv.shape
    return qkv.view(B, N, 3, num_heads, -1).permute(2, 0, 3, 1, 4).unbind(0)


def attention_bound(B, N, C, heads, dtype=torch.bfloat16, *, backward=False,
                    int8_qk=False, lse=False, q8_out=False, int8_pv=False):
    """-> (bound ms, 'operations', 'exp2' or 'bytes') of one packed-qkv
    attention call: QK and PV are N^2 Dh multiply-adds each per (batch,
    head) (the backward's five products: 2.5x the forward's) on the tensor
    cores, and the softmax's N^2 exp2 per (batch, head) on the
    special-function units (SFU_LANES an SM a clock at the maximum SM
    clock; the backward recomputes P once), the larger of the two; bytes:
    qkv read once, the output (and lse) written once (backward: qkv, out,
    dout and lse read, dqkv written).  ``int8_pv`` (E2): both products
    int8, int8 qkv in, bf16 out."""
    D = C // heads
    prod = 2.0 * B * heads * N * N * D          # one N x N x Dh product
    esz = 1 if int8_qk else torch.finfo(dtype).bits // 8
    if int8_pv:
        t_ops = 2 * prod / PEAK["int8"]
        nbytes = B * N * 3 * C + 2 * B * N * C
    elif backward:
        t_ops = 5 * prod / PEAK["bf16"]
        nbytes = (2 * B * N * 3 * C + 2 * B * N * C) * esz + B * heads * N * 4
    elif int8_qk:                               # s8 QK, bf16 PV
        t_ops = prod / PEAK["int8"] + prod / PEAK["bf16"]
        nbytes = B * N * 3 * C + B * N * C
    else:
        t_ops = 2 * prod / PEAK["bf16"]
        nbytes = B * N * 4 * C * esz + (B * heads * N * 4 if lse else 0)
        if q8_out:                              # B3: int8 output
            nbytes -= B * N * C * (esz - 1)
    t_exp2 = B * heads * N * N / (SFU_LANES * sm_clock_rate()[0])
    t_bytes = nbytes / PEAK["bytes"]
    by = max((t_ops, "operations"), (t_exp2, "exp2"), (t_bytes, "bytes"))
    return by[0] * 1e3, by[1]


def layernorm_bound(rows, C, in_bytes, out_bytes):
    """LayerNorm reads each input once and writes each output once (~8
    fp32 operations per element outside the tensor cores)."""
    t_bytes = rows * C * (in_bytes + out_bytes) / PEAK["bytes"]
    t_ops = 8.0 * rows * C / PEAK["fp32"]
    return (max(t_ops, t_bytes) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def attention_delta_bf16_products(out, dout, num_heads: int):
    """The control of the delta pre-pass: each product rounded to bf16
    before the sum."""
    B, N, C = out.shape
    prod = (dout.float() * out.float()).bfloat16().float()
    return prod.view(B, N, num_heads, -1).sum(-1).permute(0, 2, 1
                                                          ).contiguous()


def delta_bound(B, N, C, heads, esz):
    """The delta pre-pass reads out and dout once and writes (B, H, N)
    fp32 (2 operations an element outside the tensor cores)."""
    t_bytes = (2 * B * N * C * esz + B * heads * N * 4) / PEAK["bytes"]
    t_ops = 2.0 * B * N * C / PEAK["fp32"]
    return (max(t_ops, t_bytes) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_kernels(dev, seed: int) -> dict:
    """Phase 2 -> {kernel name: {max_abs_err, ms, plain_ms, library_ms,
    bound_ms, bound_by}}; the times are those of the main-path shape (first
    case of each kernel; C1 and C2 at the job's batch)."""
    import torch.nn.functional as F
    from simple_tad_tpu_torch.ops import flash_attention as fa
    from simple_tad_tpu_torch.ops import ln
    g = torch.Generator(device=dev).manual_seed(seed)
    results = {}
    failures = []

    def timed(name, kernel, plain, library=None, bound=None, plain_runs=20,
              case=None, into=None):
        """Time the kernel, its plain version and the library call; the
        first shape timed (``case`` None) is the kernel's record, others
        are printed with their case (and kept in ``into``, a case's
        record, where given)."""
        if case:
            r = {} if into is None else into
        else:
            r = results.setdefault(name, {"max_abs_err": 0.0})
        r["ms"], r["plain_ms"] = cuda_ms(kernel), cuda_ms(plain,
                                                          runs=plain_runs)
        r["library_ms"] = cuda_ms(library) if library is not None else None
        r["bound_ms"], r["bound_by"] = bound
        lib = ("none" if library is None
               else "%.4f ms" % r["library_ms"])
        print(f"[{name}] timed{' ' + case if case else ''}: kernel "
              f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  library "
              f"{lib}  bound {r['bound_ms']:.4f} ms ({r['bound_by']})")

    def run_case(name, case, kernel, plain, control=None, time_it=True,
                 library=None, bound=None, route=None,
                 route_counts=None, plain_runs=20):
        """``kernel``, ``plain`` and ``library``: callables, or tuples of
        them (``in_turn``: the check takes the first, the timing all,
        queued).  ``control``: one callable, or a list of them (each must
        fail the bounds).  The first case of a kernel is timed (its record);
        ``time_it='every'`` times every case.  ``route``: the route the
        kernel call must be counted on, and no other, by ``route_counts``
        (default the forward's, fa.attention_fwd_route); the case is then
        kept in the record's cases; ``plain_runs``: the plain version's
        timed runs."""
        counts = route_counts or fwd_route_counts
        before = counts()
        got = first_call(kernel)()
        moved = {r: n - before[r] for r, n in counts().items()}
        want = first_call(plain)()
        err, share, ok = compare(name, got, want)
        print(f"[{name}] {case}: max_abs_err {err:.3e} differ {share:.3e} "
              f"{'ok' if ok else 'FAIL'}"
              + (f" ({route} route: {moved})" if route else ""))
        if not ok:
            failures.append(f"{name} {case}")
        if route and moved != {r: int(r == route) for r in moved}:
            failures.append(f"{name} {case}: not one {route} launch {moved}")
        controls = control if isinstance(control, list) else (
            [] if control is None else [control])
        for i, ctrl in enumerate(controls):
            c_err, c_share, c_ok = compare(name, ctrl(), want)
            label = "control" if i == 0 else f"control {i + 1}"
            print(f"[{name}] {case}: {label} max_abs_err {c_err:.3e} "
                  f"differ {c_share:.3e} "
                  f"{'NOT CAUGHT' if c_ok else 'caught'}")
            if c_ok:
                failures.append(f"{name} {case}: the bounds let {label} "
                                f"through")
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        entry = {"case": case, "route": route, "max_abs_err": err,
                 "differ": share}
        if route:
            r.setdefault("cases", []).append(entry)
        if time_it == "every" or (time_it and "ms" not in r):
            first = "ms" not in r
            timed(name, kernel, plain, library, bound, plain_runs,
                  case=None if first else case, into=entry)
            if first and route:
                entry.update({k: r[k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})

    def launches_equal(name, case, kernel):
        """Two launches on the same inputs agree bit for bit (no atomics:
        one summation order)."""
        first, second = kernel(), kernel()
        if name in SEP_GRADS:
            first, second = torch.cat(first, -1), torch.cat(second, -1)
        elif isinstance(first, tuple):                 # (out, lse)
            first, second = torch.cat([t.flatten().float() for t in first]), \
                torch.cat([t.flatten().float() for t in second])
        equal = torch.equal(first, second)
        print(f"[{name}] {case}: two launches "
              f"{'bit-equal' if equal else 'DIFFER'}")
        if not equal:
            failures.append(f"{name} {case}: two launches differ")

    print(f"[bounds] bf16: allclose {BF16_TOL} and at most this share of "
          f"outputs differing {BF16_MISMATCH}; fp32: allclose {F32_TOL} "
          f"(backward {F32_TOL_BWD}); lse max_abs_err {LSE_ATOL}; "
          f"int8: codes at most 1 apart and at most this share apart "
          f"{I8_MISMATCH}")
    ln_cases = [((32 * 1568, 768), torch.bfloat16),   # norm1/norm2, ViT-B b32
                ((32, 768), torch.bfloat16),          # fc_norm
                ((4096, 384), torch.float32),
                ((1000, 1280), torch.bfloat16)]
    for shape, dt in ln_cases:
        C = shape[-1]
        x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dt)
        w = torch.randn(C, generator=g, device=dev) * 0.2 + 1
        b = torch.randn(C, generator=g, device=dev) * 0.1
        wl, bl = w.to(dt), b.to(dt)
        xs = ((x,), (x.clone(),))       # taken in turn when timed
        run_case("layernorm", f"{shape} {dt}",
                 in_turn(lambda x: ln.layernorm(x, w, b), *xs),
                 in_turn(lambda x: ln.layernorm_plain(x, w, b), *xs),
                 lambda: layernorm_control(x, w, b),
                 library=in_turn(lambda x: F.layer_norm(x, (C,), wl, bl,
                                                        1e-6), *xs),
                 bound=layernorm_bound(shape[0], C, x.element_size(),
                                       x.element_size()))
        del xs

    attn_cases = [((32, 1568, 2304), 12, torch.bfloat16),   # ViT-B b32
                  ((8, 1568, 2304), 12, torch.bfloat16),    # ViT-B
                  ((8, 1568, 1152), 6, torch.bfloat16),     # ViT-S
                  ((4, 1568, 3072), 16, torch.bfloat16),    # ViT-L
                  ((2, 200, 384), 2, torch.float32),        # masked tail
                  ((2, 1568, 3840), 16, torch.bfloat16),    # ViT-H, Dh=80
                  # MVD-B b32 with its CLS token: a one-row tail tile
                  ((32, 1569, 2304), 12, torch.bfloat16),
                  # head dim 32: the mma.sync kernel's route (8 to 56)
                  ((4, 1568, 1152), 12, torch.bfloat16)]
    for shape, heads, dt in attn_cases:
        qkv = torch.randn(shape, generator=g, device=dev).to(dt)
        D = shape[-1] // 3 // heads
        scale = D ** -0.5
        q, k, v = qkv_views(qkv, heads)
        route = fa.attention_fwd_route(dt, D)
        case = f"{shape} H={heads} {dt}"
        run_case("attention", case,
                 lambda: fa.flash_attention_qkv(qkv, heads, scale),
                 lambda: fa.flash_attention_qkv_plain(qkv, heads, scale),
                 # in fp32 the rounding the control leaves out is exact
                 (lambda: attention_control(qkv, heads, scale))
                 if dt == torch.bfloat16 else None,
                 time_it=("every" if D != fa.WGMMA_HEAD_DIM
                          or shape[1] == 1569 else True),
                 library=lambda: F.scaled_dot_product_attention(
                     q, k, v, scale=scale),
                 bound=attention_bound(shape[0], shape[1], shape[2] // 3,
                                       heads, dt), route=route)
        if route == "wgmma":
            launches_equal("attention", case,
                           lambda: fa.flash_attention_qkv(qkv, heads, scale))
        del qkv, q, k, v
        torch.cuda.empty_cache()

    lnq_cases = [((32 * 1568, 768), torch.bfloat16),   # norm1/norm2 int8
                 ((4096, 384), torch.float32)]
    for shape, dt in lnq_cases:
        C = shape[-1]
        x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dt)
        w = torch.randn(C, generator=g, device=dev) * 0.2 + 1
        b = torch.randn(C, generator=g, device=dev) * 0.1
        # a calibrated absmax: that of the LayerNorm output itself
        amax = ln.layernorm_plain(x, w, b, out_dtype=torch.float32
                                  ).abs().max()
        xs = ((x,), (x.clone(),))
        run_case("layernorm_quant", f"{shape} {dt}",
                 in_turn(lambda x: ln.layernorm_quant(x, w, b, amax), *xs),
                 in_turn(lambda x: ln.layernorm_quant_plain(x, w, b, amax),
                         *xs),
                 lambda: layernorm_quant_control(x, w, b, amax),
                 bound=layernorm_bound(shape[0], C, x.element_size(), 1))
        launches_equal("layernorm_quant", f"{shape} {dt}",
                       lambda: ln.layernorm_quant(x, w, b, amax))
        del x, xs
    torch.cuda.empty_cache()

    i8_cases = [((32, 1568, 2304), 12),     # ViT-B b32
                ((8, 1568, 1152), 6),       # ViT-S
                ((4, 1568, 3072), 16),      # ViT-L
                ((2, 200, 384), 2),         # masked tail
                ((2, 1568, 3840), 16)]      # ViT-H, Dh=80
    for shape, heads in i8_cases:
        B, N, C3 = shape
        D = C3 // 3 // heads
        qkv = torch.randn(shape, generator=g, device=dev)
        amax = qkv.view(B, N, 3, heads, D).abs().amax(dim=(0, 1, 4))
        inv = (127.0 / amax).reshape(-1).repeat_interleave(D)
        qkv_i8 = torch.clamp(torch.round(qkv * inv), -127, 127).to(torch.int8)
        del qkv
        scale = D ** -0.5
        out_amax = fa.attention_i8_plain_f32(qkv_i8, amax, heads,
                                             scale).abs().max()
        route = fa.attention_i8_route(D)
        case = f"{shape} H={heads}"
        run_case("attention_i8", case,
                 lambda: fa.flash_attention_qkv_i8d(qkv_i8, amax, heads,
                                                    scale, out_amax),
                 lambda: fa.flash_attention_qkv_i8d_plain(
                     qkv_i8, amax, heads, scale, out_amax),
                 lambda: attention_i8_control(qkv_i8, amax, heads, scale,
                                              out_amax),
                 time_it="every" if route == "mma_sync" else True,
                 bound=attention_bound(B, N, C3 // 3, heads, int8_qk=True),
                 route=route, route_counts=i8_route_counts)
        if route == "wgmma":
            launches_equal("attention_i8", case,
                           lambda: fa.flash_attention_qkv_i8d(
                               qkv_i8, amax, heads, scale, out_amax))
        del qkv_i8
        torch.cuda.empty_cache()

    # training attention: checked at ViT-B's b8 (the wgmma routes both
    # ways), ViT-H's head dim 80 (the forward's wgmma route, the backward's
    # mma.sync one), head dim 32 (the mma.sync routes both ways) and a
    # masked fp32 tail, timed at the job's batch
    train_cases = [((8, 1568, 2304), 12, torch.bfloat16),
                   ((2, 1568, 3840), 16, torch.bfloat16),
                   ((4, 1568, 1152), 12, torch.bfloat16),
                   ((2, 200, 384), 2, torch.float32)]
    for shape, heads, dt in train_cases:
        B, N, C3 = shape
        qkv = torch.randn(shape, generator=g, device=dev).to(dt)
        dout = torch.randn((B, N, C3 // 3), generator=g, device=dev).to(dt)
        scale = (C3 // 3 // heads) ** -0.5
        bf16 = dt == torch.bfloat16
        route = fa.attention_fwd_route(dt, C3 // 3 // heads)
        run_case("attention_fwd_lse", f"{shape} H={heads} {dt}",
                 lambda: fa.flash_attention_qkv_fwd_lse(qkv, heads, scale),
                 lambda: fa.flash_attention_qkv_fwd_lse_plain(qkv, heads,
                                                              scale),
                 (lambda: attention_fwd_lse_control(qkv, heads, scale))
                 if bf16 else None, time_it=False, route=route)
        if route == "wgmma":
            launches_equal("attention_fwd_lse", f"{shape} H={heads} {dt}",
                           lambda: fa.flash_attention_qkv_fwd_lse(
                               qkv, heads, scale))
        out, lse = fa.flash_attention_qkv_fwd_lse_plain(qkv, heads, scale)
        run_case("attention_bwd", f"{shape} H={heads} {dt}",
                 lambda: fa.flash_attention_qkv_bwd(qkv, out, lse, dout,
                                                    heads, scale),
                 lambda: fa.flash_attention_qkv_bwd_plain(qkv, out, lse,
                                                          dout, heads, scale),
                 (lambda: attention_bwd_control(qkv, out, lse, dout, heads,
                                                scale)) if bf16 else None,
                 time_it=False)
        launches_equal("attention_bwd", f"{shape} H={heads} {dt}",
                       lambda: fa.flash_attention_qkv_bwd(
                           qkv, out, lse, dout, heads, scale))
        del qkv, dout, out, lse
        torch.cuda.empty_cache()
    # the backward's delta pre-pass: at ViT-B's job batch (timed), IV2-S
    # b8 and an fp32 tail
    delta_cases = [((JOB_BATCH, 1568, 768), 12, torch.bfloat16),
                   ((8, 2049, 384), 6, torch.bfloat16),
                   ((2, 200, 384), 2, torch.float32)]
    for (B, N, C), heads, dt in delta_cases:
        out = torch.randn((B, N, C), generator=g, device=dev).to(dt)
        dout = torch.randn((B, N, C), generator=g, device=dev).to(dt)
        pairs = ((out, dout, heads), (out.clone(), dout.clone(), heads))
        run_case("attention_delta", f"{(B, N, C)} H={heads} {dt}",
                 in_turn(fa.flash_attention_delta, *pairs),
                 in_turn(fa.attention_delta, *pairs),
                 lambda: attention_delta_bf16_products(out, dout, heads),
                 bound=delta_bound(B, N, C, heads, out.element_size()))
        del out, dout, pairs
    torch.cuda.empty_cache()
    B, N, C, heads = JOB_BATCH, 1568, 768, 12
    scale = (C // heads) ** -0.5
    qkv = torch.randn((B, N, 3 * C), generator=g,
                      device=dev).to(torch.bfloat16)
    dout = torch.randn((B, N, C), generator=g, device=dev).to(torch.bfloat16)
    q, k, v = qkv_views(qkv, heads)
    timed("attention_fwd_lse",
          lambda: fa.flash_attention_qkv_fwd_lse(qkv, heads, scale),
          lambda: fa.flash_attention_qkv_fwd_lse_plain(qkv, heads, scale),
          lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
          attention_bound(B, N, C, heads, lse=True), plain_runs=5)
    out, lse = fa.flash_attention_qkv_fwd_lse(qkv, heads, scale)
    leaf = qkv.detach().requires_grad_(True)
    ql, kl, vl = qkv_views(leaf, heads)
    sdpa_out = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
    sdpa_dout = dout.view(B, N, heads, -1).transpose(1, 2)
    timed("attention_bwd",
          lambda: fa.flash_attention_qkv_bwd(qkv, out, lse, dout, heads,
                                             scale),
          lambda: fa.flash_attention_qkv_bwd_plain(qkv, out, lse, dout,
                                                   heads, scale),
          lambda: torch.autograd.grad(sdpa_out, leaf, sdpa_dout,
                                      retain_graph=True),
          attention_bound(B, N, C, heads, backward=True), plain_runs=3)
    del qkv, dout, q, k, v, out, lse, leaf, ql, kl, vl, sdpa_out
    torch.cuda.empty_cache()

    # InternVideo2's kernels at IV2-S/B batch 32, N = 2049 (8 x 16 x 16
    # patches + CLS): A1 on separate operands with v the strided column
    # block of a real qkv tensor, D2 likewise in int8 (keys masked once),
    # D3 with per-head inverse scales (the q/k-norm sites)
    sep_cases = [((32, 2049, 1152), 6, torch.bfloat16),    # IV2-S b32
                 ((32, 2049, 2304), 12, torch.bfloat16),   # IV2-B b32
                 ((2, 200, 384), 2, torch.float32),        # masked tail
                 # C = 192 is no multiple of 128: the geometry at which the
                 # JAX package takes _fwd_kernel_nomax (flash_attention.py
                 # :345) on the (B*H, N, Dh) layout; A1 computes the same
                 # function
                 ((8, 2049, 576), 3, torch.bfloat16),
                 # IV2-1B's head dim 88: the wgmma route's 96-column tiles
                 ((4, 2049, 4224), 16, torch.bfloat16),
                 # head dims 72, 104 and 120 (tiles of 96, 128, 128 that
                 # start 8 columns early on odd heads), a 3-row tail tile
                 ((2, 131, 432), 2, torch.bfloat16),
                 ((2, 131, 624), 2, torch.bfloat16),
                 ((2, 131, 720), 2, torch.bfloat16),
                 # head dim 32: the mma.sync route (8 to 56)
                 ((4, 2049, 1152), 12, torch.bfloat16)]
    for shape, heads, dt in sep_cases:
        B, N, C3 = shape
        C = C3 // 3
        qkv = torch.randn(shape, generator=g, device=dev).to(dt)
        q, k, v = (qkv[..., :C].contiguous(), qkv[..., C:2 * C].contiguous(),
                   qkv[..., 2 * C:])
        scale = (C // heads) ** -0.5
        qh, kh, vh = sep_heads(heads, q, k, v)
        route = fa.attention_fwd_route(dt, C // heads)
        case = f"{shape} H={heads} {dt}, v strided"
        run_case("attention_sep", case,
                 lambda: fa.flash_attention(q, k, v, heads, scale),
                 lambda: fa.flash_attention_plain(q, k, v, heads, scale),
                 (lambda: attention_sep_control(q, k, v, heads, scale))
                 if dt == torch.bfloat16 else None,
                 time_it=("every" if C // heads != fa.WGMMA_HEAD_DIM
                          else True),
                 library=lambda: F.scaled_dot_product_attention(
                     qh, kh, vh, scale=scale),
                 bound=attention_bound(B, N, C, heads, dt), route=route)
        if route == "wgmma":
            launches_equal("attention_sep", case,
                           lambda: fa.flash_attention(q, k, v, heads, scale))
        del qkv, q, k, v, qh, kh, vh
        torch.cuda.empty_cache()

    i8_sep_cases = [((32, 2049, 1152), 6, None),      # IV2-S b32
                    ((32, 2049, 1152), 6, 2040),      # keys masked
                    ((32, 2049, 2304), 12, None),     # IV2-B b32
                    ((4, 2049, 4224), 16, None),      # IV2-1B, Dh 88 -> 96
                    ((2, 200, 240), 2, 190)]          # Dh 40 -> 48, tail
    for shape, heads, n_valid in i8_sep_cases:
        B, N, C3 = shape
        C, D = C3 // 3, C3 // 3 // heads
        qkv = torch.randn(shape, generator=g, device=dev)
        amax = qkv.view(B, N, 3, heads, D).abs().amax(dim=(0, 1, 4))
        inv = (127.0 / amax).reshape(-1).repeat_interleave(D)
        qkv_i8 = torch.clamp(torch.round(qkv * inv), -127, 127).to(torch.int8)
        del qkv
        q, k, v = (qkv_i8[..., :C].contiguous(),
                   qkv_i8[..., C:2 * C].contiguous(), qkv_i8[..., 2 * C:])
        scale = D ** -0.5
        out_amax = fa.attention_i8d_plain_f32(q, k, v, amax, heads, scale,
                                              n_valid).abs().max()
        args = (q, k, v, amax, heads, scale, out_amax, n_valid)
        route = fa.attention_i8_route(D)
        case = f"{shape} H={heads} n_valid={n_valid}, v strided"
        run_case("attention_i8_sep", case,
                 lambda: fa.flash_attention_i8d(*args),
                 lambda: fa.flash_attention_i8d_plain(*args),
                 lambda: attention_i8_sep_control(*args),
                 time_it="every" if route == "mma_sync" else True,
                 bound=attention_bound(B, N, C, heads, int8_qk=True),
                 route=route, route_counts=i8_route_counts)
        if route == "wgmma":
            launches_equal("attention_i8_sep", case,
                           lambda: fa.flash_attention_i8d(*args))
        del qkv_i8, q, k, v, args
        torch.cuda.empty_cache()

    # training attention on separate operands (C3): checked at IV2-S batch 8
    # and a masked fp32 tail with v the strided column block of a real qkv
    # tensor, timed at the job's batch
    sep_train_cases = [((8, 2049, 1152), 6, torch.bfloat16),
                       ((2, 200, 384), 2, torch.float32)]
    for shape, heads, dt in sep_train_cases:
        B, N, C3 = shape
        C = C3 // 3
        qkv = torch.randn(shape, generator=g, device=dev).to(dt)
        dout = torch.randn((B, N, C), generator=g, device=dev).to(dt)
        ops = (qkv[..., :C].contiguous(), qkv[..., C:2 * C].contiguous(),
               qkv[..., 2 * C:], heads, (C // heads) ** -0.5)
        bf16 = dt == torch.bfloat16
        route = fa.attention_fwd_route(dt, C // heads)
        run_case("attention_sep_fwd_lse",
                 f"{shape} H={heads} {dt}, v strided",
                 lambda: fa.flash_attention_fwd_lse(*ops),
                 lambda: fa.flash_attention_fwd_lse_plain(*ops),
                 ([lambda: attention_sep_fwd_lse_control(*ops)] if bf16
                  else []) + [lambda: attention_sep_fwd_lse_misread_v(*ops)],
                 time_it=False, route=route)
        if route == "wgmma":
            launches_equal("attention_sep_fwd_lse",
                           f"{shape} H={heads} {dt}, v strided",
                           lambda: fa.flash_attention_fwd_lse(*ops))
        out, lse = fa.flash_attention_fwd_lse_plain(*ops)
        bargs = (*ops[:3], out, lse, dout, *ops[3:])
        run_case("attention_sep_bwd", f"{shape} H={heads} {dt}, v strided",
                 lambda: fa.flash_attention_bwd(*bargs),
                 lambda: fa.flash_attention_bwd_plain(*bargs),
                 ([lambda: attention_sep_bwd_control(*bargs)] if bf16
                  else []) + [lambda: attention_sep_bwd_misread_v(*bargs)],
                 time_it=False)
        launches_equal("attention_sep_bwd",
                       f"{shape} H={heads} {dt}, v strided",
                       lambda: fa.flash_attention_bwd(*bargs))
        del qkv, dout, ops, out, lse, bargs
        torch.cuda.empty_cache()
    B, N, C, heads = JOB_BATCH, 2049, 384, 6
    qkv = torch.randn((B, N, 3 * C), generator=g,
                      device=dev).to(torch.bfloat16)
    dout = torch.randn((B, N, C), generator=g, device=dev).to(torch.bfloat16)
    ops = (qkv[..., :C].contiguous(), qkv[..., C:2 * C].contiguous(),
           qkv[..., 2 * C:], heads, (C // heads) ** -0.5)
    scale = ops[-1]
    timed("attention_sep_fwd_lse",
          lambda: fa.flash_attention_fwd_lse(*ops),
          lambda: fa.flash_attention_fwd_lse_plain(*ops),
          lambda: F.scaled_dot_product_attention(
              *sep_heads(heads, *ops[:3]), scale=scale),
          attention_bound(B, N, C, heads, lse=True), plain_runs=5)
    out, lse = fa.flash_attention_fwd_lse(*ops)
    leaves = [t.detach().requires_grad_(True) for t in ops[:3]]
    sdpa_out = F.scaled_dot_product_attention(*sep_heads(heads, *leaves),
                                              scale=scale)
    sdpa_dout = sep_heads(heads, dout)[0]
    bargs = (*ops[:3], out, lse, dout, *ops[3:])
    timed("attention_sep_bwd",
          lambda: fa.flash_attention_bwd(*bargs),
          lambda: fa.flash_attention_bwd_plain(*bargs),
          lambda: torch.autograd.grad(sdpa_out, leaves, sdpa_dout,
                                      retain_graph=True),
          attention_bound(B, N, C, heads, backward=True), plain_runs=3)
    del qkv, dout, ops, out, lse, leaves, sdpa_out, sdpa_dout, bargs
    torch.cuda.empty_cache()
    for shape, heads in WIDE_LSE_CASES:
        B, N, C3 = shape
        C = C3 // 3
        qkv = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        scale = (C // heads) ** -0.5
        ops = (qkv[..., :C].contiguous(), qkv[..., C:2 * C].contiguous(),
               qkv[..., 2 * C:], heads, scale)
        route = fa.attention_fwd_route(torch.bfloat16, C // heads)
        case = f"{shape} H={heads} bf16"
        run_case("attention_fwd_lse", case,
                 lambda: fa.flash_attention_qkv_fwd_lse(qkv, heads, scale),
                 lambda: fa.flash_attention_qkv_fwd_lse_plain(qkv, heads,
                                                              scale),
                 lambda: attention_fwd_lse_control(qkv, heads, scale),
                 time_it="every",
                 library=lambda: F.scaled_dot_product_attention(
                     *qkv_views(qkv, heads), scale=scale),
                 bound=attention_bound(B, N, C, heads, lse=True),
                 route=route)
        launches_equal("attention_fwd_lse", case,
                       lambda: fa.flash_attention_qkv_fwd_lse(qkv, heads,
                                                              scale))
        case += ", v strided"
        run_case("attention_sep_fwd_lse", case,
                 lambda: fa.flash_attention_fwd_lse(*ops),
                 lambda: fa.flash_attention_fwd_lse_plain(*ops),
                 [lambda: attention_sep_fwd_lse_control(*ops),
                  lambda: attention_sep_fwd_lse_misread_v(*ops)],
                 time_it="every",
                 library=lambda: F.scaled_dot_product_attention(
                     *sep_heads(heads, *ops[:3]), scale=scale),
                 bound=attention_bound(B, N, C, heads, lse=True),
                 route=route)
        launches_equal("attention_sep_fwd_lse", case,
                       lambda: fa.flash_attention_fwd_lse(*ops))
        del qkv, ops
        torch.cuda.empty_cache()

    rmsq_cases = [((32 * 2049, 384), 6, torch.bfloat16),   # IV2-S b32
                  ((4096, 768), 12, torch.float32),
                  ((1000, 100), 2, torch.bfloat16)]        # C % 8 != 0
    for shape, heads, dt in rmsq_cases:
        C = shape[-1]
        x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dt)
        w = torch.randn(C, generator=g, device=dev) * 0.2 + 1
        # per-head calibrated absmax of the output itself, as at q and k
        y = x.float() * torch.rsqrt(x.float().pow(2).mean(-1, keepdim=True)
                                    + 1e-6) * w
        head_amax = y.abs().view(-1, heads, C // heads).amax(dim=(0, 2))
        inv = (127.0 / head_amax).repeat_interleave(C // heads)
        del y
        xs = ((x, w, inv), (x.clone(), w, inv))
        run_case("rmsnorm_quant", f"{shape} {dt} {heads} heads",
                 in_turn(ln.rmsnorm_quant, *xs),
                 in_turn(ln.rmsnorm_quant_plain, *xs),
                 lambda: rmsnorm_quant_control(x, w, inv),
                 bound=layernorm_bound(shape[0], C, x.element_size(), 1))
        launches_equal("rmsnorm_quant", f"{shape} {dt} {heads} heads",
                       lambda: ln.rmsnorm_quant(x, w, inv))
        del x, xs
    torch.cuda.empty_cache()
    check_int8_kernels(dev, g, run_case, launches_equal)
    failures += check_dropout_kernels(dev, g, run_case, timed, launches_equal)
    failures += check_variant_kernels(dev, g, run_case, launches_equal)
    check_pretrain_kernels(dev, g, run_case, launches_equal)
    check_distill_kernels(dev, g, run_case, launches_equal)
    check_probe_kernels(dev, g, run_case, launches_equal)
    if failures:
        raise AssertionError(f"kernel checks failed: {failures}")
    return results


def chunked(fn, n: int = PLAIN_CHUNK):
    """``fn`` applied to its tensor arguments' leading (batch) axis ``n``
    samples at a time, the results concatenated (each item of a tuple
    result): the plain attention at a batch whose fp32 scores would not
    fit at once."""
    def run(*args):
        B = args[0].shape[0]
        parts = [fn(*(a[i:i + n] if torch.is_tensor(a) else a
                      for a in args)) for i in range(0, B, n)]
        if isinstance(parts[0], tuple):
            return tuple(torch.cat(p) for p in zip(*parts))
        return torch.cat(parts)
    return run


def sep_operands(g, dev, shape, heads, dt=torch.bfloat16):
    """Seeded (q, k, v, heads, scale) on separate operands of a (B, N, 3C)
    qkv tensor, v its strided column block."""
    B, N, C3 = shape
    C = C3 // 3
    qkv = torch.randn(shape, generator=g, device=dev).to(dt)
    return (qkv[..., :C].contiguous(), qkv[..., C:2 * C].contiguous(),
            qkv[..., 2 * C:], heads, (C // heads) ** -0.5)


def check_c3_case(g, dev, run_case, launches_equal, shape, heads,
                  label: str, timed: bool) -> None:
    """C3-fwd and C3-bwd at ``shape`` (B, N, 3C), H = ``heads``, bf16, v
    strided, against their plain versions and controls (and the gross
    one, v misread) on their routes; ``timed``: with SDPA's forward and
    backward and their bounds, kept in the records' cases, else two
    launches bit-equal."""
    import torch.nn.functional as F
    from simple_tad_tpu_torch.ops import flash_attention as fa
    dt = torch.bfloat16
    B, N, C3 = shape
    C, D = C3 // 3, C3 // 3 // heads
    ops = sep_operands(g, dev, shape, heads)
    dout = torch.randn((B, N, C), generator=g, device=dev).to(dt)
    case = f"{shape} H={heads} {dt}, v strided ({label})"
    scale = ops[-1]
    sdpa = (lambda: F.scaled_dot_product_attention(
        *sep_heads(heads, *ops[:3]), scale=scale)) if timed else None
    run_case("attention_sep_fwd_lse", case,
             lambda: fa.flash_attention_fwd_lse(*ops),
             lambda: fa.flash_attention_fwd_lse_plain(*ops),
             [lambda: attention_sep_fwd_lse_control(*ops),
              lambda: attention_sep_fwd_lse_misread_v(*ops)],
             time_it="every" if timed else False, library=sdpa,
             bound=attention_bound(B, N, C, heads, lse=True),
             route=fa.attention_fwd_route(dt, D))
    if not timed:
        launches_equal("attention_sep_fwd_lse", case,
                       lambda: fa.flash_attention_fwd_lse(*ops))
    out, lse = fa.flash_attention_fwd_lse_plain(*ops)
    bargs = (*ops[:3], out, lse, dout, *ops[3:])
    library = None
    if timed:
        leaves = [t.detach().requires_grad_(True) for t in ops[:3]]
        sdpa_out = F.scaled_dot_product_attention(
            *sep_heads(heads, *leaves), scale=scale)
        sdpa_dout = sep_heads(heads, dout)[0]
        library = lambda: torch.autograd.grad(  # noqa: E731
            sdpa_out, leaves, sdpa_dout, retain_graph=True)
    run_case("attention_sep_bwd", case,
             lambda: fa.flash_attention_bwd(*bargs),
             lambda: fa.flash_attention_bwd_plain(*bargs),
             [lambda: attention_sep_bwd_control(*bargs),
              lambda: attention_sep_bwd_misread_v(*bargs)],
             time_it="every" if timed else False, library=library,
             bound=attention_bound(B, N, C, heads, backward=True),
             route=fa.attention_bwd_route(dt, D),
             route_counts=bwd_route_counts)
    if not timed:
        launches_equal("attention_sep_bwd", case,
                       lambda: fa.flash_attention_bwd(*bargs))
    del ops, dout, out, lse, bargs
    torch.cuda.empty_cache()


def check_distill_kernels(dev, g, run_case, launches_equal):
    """Phase 2 at phase 15's shapes: C3-fwd and C3-bwd at the student's
    N = 411 (DISTILL_CHECK) against their plain versions and controls on
    their wgmma routes, two launches bit-equal; then, timed at
    DISTILL_BATCH (DISTILL_TIMED) with their plain versions, SDPA and their
    bounds: A1-sep at the IV2-1B teacher's shape on its wgmma route (two
    launches bit-equal; the plain version and its control PLAIN_CHUNK
    samples at a time), and
    C3-fwd and C3-bwd at the student's, each against its plain version and
    controls, kept in the records' cases."""
    import torch.nn.functional as F
    from simple_tad_tpu_torch.ops import flash_attention as fa
    dt = torch.bfloat16
    t0 = time.perf_counter()

    check_c3_case(g, dev, run_case, launches_equal, *DISTILL_CHECK,
                  "distill student", timed=False)
    (shape, heads), student = DISTILL_TIMED
    B, N, C3 = shape
    C = C3 // 3
    q, k, v, _, scale = sep_operands(g, dev, shape, heads)
    qh, kh, vh = sep_heads(heads, q, k, v)
    run_case("attention_sep", f"{shape} H={heads} {dt}, v strided "
             f"(distill teacher)",
             lambda: fa.flash_attention(q, k, v, heads, scale),
             lambda: chunked(fa.flash_attention_plain)(q, k, v, heads,
                                                       scale),
             lambda: chunked(attention_sep_control)(q, k, v, heads, scale),
             time_it="every",
             library=lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                            scale=scale),
             bound=attention_bound(B, N, C, heads),
             route=fa.attention_fwd_route(dt, C // heads), plain_runs=3)
    launches_equal("attention_sep", f"{shape} H={heads} {dt}, v strided "
                   f"(distill teacher)",
                   lambda: fa.flash_attention(q, k, v, heads, scale))
    del q, k, v, qh, kh, vh
    torch.cuda.empty_cache()
    check_c3_case(g, dev, run_case, launches_equal, *student,
                  "distill student", timed=True)
    print(f"[time] phase 2's distillation cases: "
          f"{time.perf_counter() - t0:.1f} s")


def check_probe_kernels(dev, g, run_case, launches_equal):
    """Phase 2 at phase 16's shapes: A1-sep at 16 frames (N = 4097) at
    IV2-1B's width (head dim 88) and IV2-6B's (head dim 128, the first
    launch at 128), on the wgmma route, against the plain version and
    its control, two launches bit-equal, and timed with SDPA and the bound
    (PROBE_SEP_CASES); C3-fwd
    and C3-bwd at the IV2-S DAPT encoder's 1024 visible tokens
    (IV2_DAPT_ENCODER) against their plain versions and controls, timed."""
    import torch.nn.functional as F
    from simple_tad_tpu_torch.ops import flash_attention as fa
    dt = torch.bfloat16
    t0 = time.perf_counter()
    for shape, heads, what in PROBE_SEP_CASES:
        B, N, C3 = shape
        C = C3 // 3
        q, k, v, _, scale = sep_operands(g, dev, shape, heads)
        qh, kh, vh = sep_heads(heads, q, k, v)
        run_case("attention_sep", f"{shape} H={heads} {dt}, v strided "
                 f"({what})",
                 lambda: fa.flash_attention(q, k, v, heads, scale),
                 lambda: fa.flash_attention_plain(q, k, v, heads, scale),
                 lambda: attention_sep_control(q, k, v, heads, scale),
                 time_it="every",
                 library=lambda: F.scaled_dot_product_attention(
                     qh, kh, vh, scale=scale),
                 bound=attention_bound(B, N, C, heads),
                 route=fa.attention_fwd_route(dt, C // heads), plain_runs=3)
        launches_equal("attention_sep", f"{shape} H={heads} {dt}, v strided "
                       f"({what})",
                       lambda: fa.flash_attention(q, k, v, heads, scale))
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()
    check_c3_case(g, dev, run_case, launches_equal, *IV2_DAPT_ENCODER,
                  "IV2-S DAPT encoder", timed=True)
    print(f"[time] phase 2's probing and IV2 DAPT cases: "
          f"{time.perf_counter() - t0:.1f} s")


def check_pretrain_kernels(dev, g, run_case, launches_equal):
    """Phase 2, the DAPT and MVD / UMT shapes: C1 and C2 against their
    plain versions and controls at DAPT_TRAIN_CASES, each call on its wgmma
    route, two launches bit-equal; then C1 and C2 at DAPT's batch
    (DAPT_TIMED) and at the IV2-S DAPT decoder's (IV2_DAPT_DECODER: C =
    192 packed, H = 3, all 4096 tokens), against their plain versions and
    controls on their wgmma route and timed with their plain versions,
    SDPA's forward and backward and their bounds, kept in the records'
    cases."""
    import torch.nn.functional as F
    from simple_tad_tpu_torch.ops import flash_attention as fa
    dt = torch.bfloat16
    for shape, heads in DAPT_TRAIN_CASES:
        B, N, C3 = shape
        D = C3 // 3 // heads
        qkv = torch.randn(shape, generator=g, device=dev).to(dt)
        dout = torch.randn((B, N, C3 // 3), generator=g, device=dev).to(dt)
        scale = D ** -0.5
        case = f"{shape} H={heads} {dt} (DAPT / MVD)"
        run_case("attention_fwd_lse", case,
                 lambda: fa.flash_attention_qkv_fwd_lse(qkv, heads, scale),
                 lambda: fa.flash_attention_qkv_fwd_lse_plain(qkv, heads,
                                                              scale),
                 lambda: attention_fwd_lse_control(qkv, heads, scale),
                 time_it=False, route=fa.attention_fwd_route(dt, D))
        launches_equal("attention_fwd_lse", case,
                       lambda: fa.flash_attention_qkv_fwd_lse(qkv, heads,
                                                              scale))
        out, lse = fa.flash_attention_qkv_fwd_lse_plain(qkv, heads, scale)
        run_case("attention_bwd", case,
                 lambda: fa.flash_attention_qkv_bwd(qkv, out, lse, dout,
                                                    heads, scale),
                 lambda: fa.flash_attention_qkv_bwd_plain(qkv, out, lse,
                                                          dout, heads, scale),
                 lambda: attention_bwd_control(qkv, out, lse, dout, heads,
                                               scale),
                 time_it=False, route=fa.attention_bwd_route(dt, D),
                 route_counts=bwd_route_counts)
        launches_equal("attention_bwd", case,
                       lambda: fa.flash_attention_qkv_bwd(
                           qkv, out, lse, dout, heads, scale))
        del qkv, dout, out, lse
    torch.cuda.empty_cache()

    for (B, N, C, heads), what in ([(c, "DAPT batch") for c in DAPT_TIMED]
                                   + [(IV2_DAPT_DECODER,
                                       "IV2-S DAPT decoder")]):
        scale = (C // heads) ** -0.5
        qkv = torch.randn((B, N, 3 * C), generator=g, device=dev).to(dt)
        dout = torch.randn((B, N, C), generator=g, device=dev).to(dt)
        q, k, v = qkv_views(qkv, heads)
        case = f"({B}, {N}, {3 * C}) H={heads} {dt} ({what})"
        run_case("attention_fwd_lse", case,
                 lambda: fa.flash_attention_qkv_fwd_lse(qkv, heads, scale),
                 lambda: fa.flash_attention_qkv_fwd_lse_plain(qkv, heads,
                                                              scale),
                 lambda: attention_fwd_lse_control(qkv, heads, scale),
                 time_it="every",
                 library=lambda: F.scaled_dot_product_attention(
                     q, k, v, scale=scale),
                 bound=attention_bound(B, N, C, heads, lse=True),
                 route=fa.attention_fwd_route(dt, C // heads))
        out, lse = fa.flash_attention_qkv_fwd_lse_plain(qkv, heads, scale)
        leaf = qkv.detach().requires_grad_(True)
        sdpa_out = F.scaled_dot_product_attention(*qkv_views(leaf, heads),
                                                  scale=scale)
        sdpa_dout = dout.view(B, N, heads, -1).transpose(1, 2)
        run_case("attention_bwd", case,
                 lambda: fa.flash_attention_qkv_bwd(qkv, out, lse, dout,
                                                    heads, scale),
                 lambda: fa.flash_attention_qkv_bwd_plain(qkv, out, lse,
                                                          dout, heads, scale),
                 lambda: attention_bwd_control(qkv, out, lse, dout, heads,
                                               scale),
                 time_it="every",
                 library=lambda: torch.autograd.grad(
                     sdpa_out, leaf, sdpa_dout, retain_graph=True),
                 bound=attention_bound(B, N, C, heads, backward=True),
                 route=fa.attention_bwd_route(dt, C // heads),
                 route_counts=bwd_route_counts)
        del qkv, dout, q, k, v, out, lse, leaf, sdpa_out, sdpa_dout
        torch.cuda.empty_cache()


def _drop_keep(B, heads, N, rate, mask, seed):
    from simple_tad_tpu_torch.ops.flash_attention import dropout_keep_plain
    return mask if mask is not None else dropout_keep_plain(seed, B, heads,
                                                            N, rate)


def attention_drop_fwd_after(q, k, v, heads, scale, rate, *, mask=None,
                             seed=None):
    """The plain dropout forward with its denominator summed over the kept,
    scaled probabilities (after dropout, not before) -> (out, lse): phase
    11's control of C4-fwd."""
    from simple_tad_tpu_torch.ops.flash_attention import LOG2E
    B, N, _ = q.shape
    keep = _drop_keep(B, heads, N, rate, mask, seed)
    qh, kh, vh = sep_heads(heads, q, k, v)
    s = torch.matmul((qh.float() * (scale * LOG2E)).to(q.dtype).float(),
                     kh.float().transpose(-1, -2))
    m = torch.ceil(s.amax(dim=-1, keepdim=True))
    pd = s.sub_(m).exp2_().mul_(keep.float() * (1.0 / (1.0 - rate)))
    denom = pd.sum(dim=-1, keepdim=True)
    o = torch.matmul(pd.to(q.dtype).float(), vh.float()) / denom
    return merge_heads(o.to(q.dtype)), (m + torch.log2(denom))[..., 0]


def attention_drop_bwd_variant(q, k, v, out, lse, dout, heads, scale, rate,
                               *, mask=None, seed=None, scale_dp=True,
                               use_delta=True):
    """The plain dropout backward with a required step left out: dP not
    scaled by the keep factor (``scale_dp=False``, phase 11's control of
    C4-bwd) or no delta term (``use_delta=False``, the gradient control of
    phases 6 and 11) -> (dq, dk, dv) (B, N, C)."""
    from simple_tad_tpu_torch.ops.flash_attention import (LOG2E,
                                                          attention_delta)
    B, N, _ = q.shape
    f = _drop_keep(B, heads, N, rate, mask, seed).float() * (
        1.0 / (1.0 - rate))
    dt = q.dtype
    qh, kh, vh = (t.float() for t in sep_heads(heads, q, k, v))
    do = sep_heads(heads, dout)[0].float()
    delta = attention_delta(out, dout, heads)[..., None]
    p = torch.matmul((qh * (scale * LOG2E)).to(dt).float(),
                     kh.transpose(-1, -2)).sub_(lse[..., None]).exp2_()
    dv = torch.matmul((p * f).to(dt).float().transpose(-1, -2), do)
    dp = torch.matmul(do, vh.transpose(-1, -2))
    if scale_dp:
        dp.mul_(f)
    del f
    ds = (dp.sub_(delta) if use_delta else dp).mul_(p).to(dt).float()
    del dp, p
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
    dq = torch.matmul(ds, kh) * scale
    return tuple(merge_heads(t.to(dt)) for t in (dq, dk, dv))


def attention_drop_bwd_unscaled(*args, **kw):
    return attention_drop_bwd_variant(*args, **kw, scale_dp=False)


def attention_drop_bwd_no_delta(*args, **kw):
    return attention_drop_bwd_variant(*args, **kw, use_delta=False)


def philox_call_cost() -> tuple:
    """-> ({pipe: SASS instructions}, {opcode: instructions}, the round
    keys' instructions) of one philox4x32_10 call: in cuobjdump -sass of
    the built library, (philox_cost_kernel<10, 2> - <0, 2>) - (<10, 1> -
    <0, 1>) (csrc/attention_train.cu), NOPs not counted, the round keys
    (which depend on the seed alone, so a thread computes them once) what
    one call's kernel adds beyond that; IMAD* and IMUL* on the FMA pipe,
    the rest on the ALU pipe."""
    from simple_tad_tpu_torch.kernels import build as kbuild
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(kbuild.library_path())],
                          capture_output=True, text=True, check=True).stdout
    ops, name = {}, None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", line)
        if name and op and op.group(1) != "NOP":
            kernel = ops.setdefault(name, {})
            kernel[op.group(1)] = kernel.get(op.group(1), 0) + 1

    def kernel(rounds, calls):
        found = [k for k in ops
                 if f"philox_cost_kernelILi{rounds}ELi{calls}EE" in k]
        assert len(found) == 1, sorted(ops)
        return ops[found[0]]
    k = {(r, c): kernel(r, c) for r in (10, 0) for c in (1, 2)}
    names = set().union(*k.values())
    call = {op: k[10, 2].get(op, 0) - k[0, 2].get(op, 0)
            - k[10, 1].get(op, 0) + k[0, 1].get(op, 0) for op in names}
    call = {op: n for op, n in sorted(call.items()) if n}
    keys = (sum(k[10, 1].values()) - sum(k[0, 1].values())
            - sum(call.values()))
    fma = sum(n for op, n in call.items() if op.startswith(("IMAD", "IMUL")))
    # ten rounds of two 32 x 32 -> 64 products and two 3-input XORs
    assert fma >= 20 and sum(call.values()) - fma >= 20, (call, keys)
    return {"fma": fma, "alu": sum(call.values()) - fma}, call, keys


@functools.lru_cache(maxsize=None)
def sm_clock_rate() -> tuple:
    """-> (SM clocks a second over the card: its SMs x the maximum SM clock
    nvidia-smi reports, that clock in MHz)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * mhz * 1e6, mhz


def philox_floor_ms(words: float, pipes: dict, sm_hz: float) -> float:
    """The least time the card takes to draw ``words`` keep words, four a
    philox4x32_10 call of ``pipes`` instructions: the busier pipe's time or
    the issue limit's, whichever is longer."""
    clocks = max(max(pipes[p] / INT_LANES[p] for p in INT_LANES),
                 sum(pipes.values()) / ISSUE_LANES)
    return words / 4 * clocks / sm_hz * 1e3


def drop_bound(B, N, C, heads, *, mask: bool, backward: bool = False,
               philox_ms: float = 0.0):
    """-> (bound ms, 'operations' or 'bytes') of one dropout attention call:
    the tensor-core products of C1/C2 (``attention_bound``) and, in the
    Philox form, the integer floor ``philox_ms`` (``philox_floor_ms`` of
    the B H N^2 keep words, each drawn once), against the bytes, with the
    mask's B H N^2 bytes read once in the mask form.  The function needs
    each keep bit once, in the backward too (its two kernels draw them
    twice)."""
    D = C // heads
    prod = 2.0 * B * heads * N * N * D
    t_ops = max((5 if backward else 2) * prod / PEAK["bf16"], philox_ms / 1e3)
    nbytes = (B * N * 3 * C * 2 + B * N * C * 2 + B * heads * N * 4
              + (B * N * 3 * C * 2 + B * N * C * 2 + B * heads * N * 4
                 if backward else 0)
              + (B * heads * N * N if mask else 0))
    t_bytes = nbytes / PEAK["bytes"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def probe_keep_mask(B, heads, N, D, rate, seed, dtype, dev):
    """The keep mask of the Philox forward, read off its output: with
    q = k = 0 every probability is 1 and l = N, and with v one-hot
    (v[key, c] = 1 for key = shift + c) output column c of row q is nonzero
    exactly where (q, shift + c) is kept."""
    from simple_tad_tpu_torch.ops import flash_attention as fa
    C = heads * D
    z = torch.zeros((B, N, C), dtype=dtype, device=dev)
    mask = torch.zeros((B, heads, N, N), dtype=torch.int8, device=dev)
    for shift in range(0, N, D):
        w = min(D, N - shift)
        v = torch.zeros((B, N, heads, D), dtype=dtype, device=dev)
        c = torch.arange(w, device=dev)
        v[:, shift + c, :, c] = 1
        out, _ = fa.flash_attention_drop_fwd(z, z, v.view(B, N, C), heads,
                                             D ** -0.5, rate, seed=seed)
        got = out.view(B, N, heads, D)[..., :w] != 0
        mask[..., shift:shift + w] = got.permute(0, 2, 1, 3).to(torch.int8)
    return mask


def bwd_route_counts() -> dict:
    """-> {route: calls} of the training backward so far."""
    counts = read_counts()
    return {route: counts[f"bwd_route_{route}"]
            for route in ("wgmma", "mma_sync", "fp32")}


def check_dropout_kernels(dev, g, run_case, timed, launches_equal) -> list:
    """Phase 11 (i)-(ii), inside phase 2: C4 in both forms against the plain
    versions on the same mask or seed at ViT-B's training shape (8, 1568,
    2304) bf16 (the wgmma kernels), ViT-H's head dim 80 (the forward's
    wgmma kernel, the backward's mma.sync one), head dim 32 (the mma.sync
    kernels both ways) and a masked fp32 tail, each with its controls, each
    call on its route, two launches of each bf16 case bit-equal; the Philox
    forward's keep bits against dropout_keep_plain's on both bf16 routes;
    then the times at the job's batch.  -> failures."""
    import torch.nn.functional as F
    from simple_tad_tpu_torch.ops import flash_attention as fa
    from simple_tad_tpu_torch.ops.attention import (draw_dropout_seed,
                                                    make_dropout_mask)
    failures = []
    # the Philox form's integer floor: one call's instructions, the rate
    pipes, call_ops, key_ops = philox_call_cost()
    sm_hz, mhz = sm_clock_rate()
    for shape, heads, dt in DROP_CASES:
        B, N, C3 = shape
        C = C3 // 3
        qkv = torch.randn(shape, generator=g, device=dev).to(dt)
        dout = torch.randn((B, N, C), generator=g, device=dev).to(dt)
        args = (*qkv.view(B, N, 3, C).unbind(2), heads, (C // heads) ** -0.5,
                ATTN_DROP)
        # a bf16 forward off head dim 64 is timed with SDPA (dropout_p)
        wide = dt == torch.bfloat16 and C // heads != fa.WGMMA_HEAD_DIM
        qh, kh, vh = qkv_views(qkv, heads)
        mask = make_dropout_mask(g, ATTN_DROP, B, heads, N)
        seed = draw_dropout_seed(g)
        # the gross controls: the mask read transposed, the next seed
        for form, src, gross in (
                ("mask", {"mask": mask},
                 {"mask": mask.transpose(-1, -2).contiguous()}),
                ("rng", {"seed": seed}, {"seed": seed + 1})):
            fwd, bwd = DROP_KERNELS[form]
            case = f"{shape} H={heads} {dt} rate {ATTN_DROP}"
            rng = {} if form == "mask" else {"philox_ms": philox_floor_ms(
                B * heads * N * N, pipes, sm_hz)}
            run_case(fwd, case,
                     lambda: fa.flash_attention_drop_fwd(*args, **src),
                     lambda: fa.flash_attention_drop_fwd_plain(*args, **src),
                     [lambda: attention_drop_fwd_after(*args, **src),
                      lambda: fa.flash_attention_drop_fwd_plain(*args,
                                                                **gross)],
                     time_it="every" if wide else False,
                     library=lambda: F.scaled_dot_product_attention(
                         qh, kh, vh, dropout_p=ATTN_DROP,
                         scale=args[4]),
                     bound=drop_bound(B, N, C, heads, mask=form == "mask",
                                      **rng),
                     route=fa.attention_fwd_route(dt, C // heads),
                     plain_runs=3)
            out, lse = fa.flash_attention_drop_fwd_plain(*args, **src)
            bargs = (*args[:3], out, lse, dout, *args[3:])
            route = fa.attention_bwd_route(dt, C // heads)
            before = bwd_route_counts()
            run_case(bwd, case,
                     lambda: fa.flash_attention_drop_bwd(*bargs, **src),
                     lambda: fa.flash_attention_drop_bwd_plain(*bargs, **src),
                     [lambda: attention_drop_bwd_unscaled(*bargs, **src),
                      lambda: fa.flash_attention_drop_bwd_plain(*bargs,
                                                                **gross)],
                     time_it=False)
            moved = {r: n - before[r] for r, n in bwd_route_counts().items()}
            print(f"[{bwd}] {case}: {route} route: {moved}")
            if moved != {r: int(r == route) for r in moved}:
                failures.append(f"{bwd} {case}: not one {route} call "
                                f"{moved}")
            if dt == torch.bfloat16:
                launches_equal(fwd, case, lambda: fa.flash_attention_drop_fwd(
                    *args, **src))
                launches_equal(bwd, case, lambda: fa.flash_attention_drop_bwd(
                    *bargs, **src))
            del out, lse, bargs
        del qkv, dout, args, mask, qh, kh, vh
        torch.cuda.empty_cache()

    # (ii) the bits the Philox kernels draw, two batches x two heads at
    # N = 392 (q and key tiles past the first), bf16 as on the main path:
    # the wgmma kernel's at head dims 64 and 80, the mma.sync kernel's at 32
    seed = draw_dropout_seed(g)
    for B, heads, N, D in DROP_PROBES:
        route = fa.attention_fwd_route(torch.bfloat16, D)
        got = probe_keep_mask(B, heads, N, D, ATTN_DROP, seed,
                              torch.bfloat16, dev)
        want = fa.dropout_keep_plain(seed, B, heads, N, ATTN_DROP)
        equal = torch.equal(got, want)
        print(f"[attention_drop_rng] keep bits of the {route} kernel (head "
              f"dim {D}) {tuple(got.shape)} "
              f"{'equal' if equal else 'DIFFER from'} dropout_keep_plain's "
              f"({(got != want).sum().item()} differ); keep rate "
              f"{got.float().mean().item():.5f} (1 - rate {1 - ATTN_DROP})")
        if not equal:
            failures.append(f"attention_drop_rng: {route} kernel keep bits")

    print(f"[attention_drop_rng] one philox4x32_10 call: {pipes} SASS "
          f"instructions by pipe {call_ops} (cuobjdump -sass, "
          f"philox_cost_kernel (<10, 2> - <0, 2>) - (<10, 1> - <0, 1>)), "
          f"and {key_ops} for the round keys, once a thread; lanes an SM "
          f"{INT_LANES}, {ISSUE_LANES} issued; "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs "
          f"x {mhz:.0f} MHz (nvidia-smi clocks.max.sm)")

    B, N, C, heads = DROP_TIMED
    scale = (C // heads) ** -0.5
    qkv = torch.randn((B, N, 3 * C), generator=g,
                      device=dev).to(torch.bfloat16)
    dout = torch.randn((B, N, C), generator=g, device=dev).to(torch.bfloat16)
    args = (*qkv.view(B, N, 3, C).unbind(2), heads, scale, ATTN_DROP)
    qh, kh, vh = qkv_views(qkv, heads)
    leaf = qkv.detach().requires_grad_(True)
    sdpa_out = F.scaled_dot_product_attention(
        *qkv_views(leaf, heads), dropout_p=ATTN_DROP, scale=scale)
    sdpa_dout = dout.view(B, N, heads, -1).transpose(1, 2)
    for form, src in (("mask", {"mask": make_dropout_mask(
            g, ATTN_DROP, B, heads, N)}), ("rng", {"seed": seed})):
        fwd, bwd = DROP_KERNELS[form]
        floor = philox_floor_ms(B * heads * N * N, pipes, sm_hz)
        rng = {} if form == "mask" else {"philox_ms": floor}
        if rng:
            for name, backward in ((fwd, False), (bwd, True)):
                cores = drop_bound(B, N, C, heads, mask=False,
                                   backward=backward)[0]
                print(f"[{name}] bound at {DROP_TIMED}: tensor cores and "
                      f"bytes {cores:.4f} ms, Philox integer floor "
                      f"{floor:.4f} ms (the kernels draw each word "
                      f"{2 if backward else 1}x)")
        timed(fwd, lambda: fa.flash_attention_drop_fwd(*args, **src),
              lambda: fa.flash_attention_drop_fwd_plain(*args, **src),
              lambda: F.scaled_dot_product_attention(
                  qh, kh, vh, dropout_p=ATTN_DROP, scale=scale),
              drop_bound(B, N, C, heads, mask=form == "mask", **rng),
              plain_runs=3)
        out, lse = fa.flash_attention_drop_fwd(*args, **src)
        bargs = (*args[:3], out, lse, dout, *args[3:])
        timed(bwd, lambda: fa.flash_attention_drop_bwd(*bargs, **src),
              lambda: fa.flash_attention_drop_bwd_plain(*bargs, **src),
              lambda: torch.autograd.grad(sdpa_out, leaf, sdpa_dout,
                                          retain_graph=True),
              drop_bound(B, N, C, heads, mask=form == "mask", backward=True,
                         **rng),
              plain_runs=3)
        del src, out, lse, bargs
    del qkv, dout, args, qh, kh, vh, leaf, sdpa_out, sdpa_dout
    torch.cuda.empty_cache()
    return failures


def _gemm_operands(g, dev, M, K, N, x_dtype, bias: bool):
    """Seeded GEMM operands at a main-path shape: x (its calibrated absmax
    the 0.999 quantile of |x|, so a few codes clip), the (N, K) int8 weight
    of a trunc-normal fp32 master quantized per channel, its scales, and a
    bias."""
    from simple_tad_tpu_torch.ops.ln import quantize_static
    x = torch.randn((M, K), generator=g, device=dev)
    amax = torch.quantile(x[:4096].abs().flatten().float(), 0.999)
    if x_dtype == torch.int8:
        x = quantize_static(x, amax)
    w = torch.randn((N, K), generator=g, device=dev) * 0.02
    w_scale = torch.clamp(w.abs().amax(dim=1) / 127.0, min=1e-12)
    w_q = torch.clamp(torch.round(w / w_scale[:, None]), -127,
                      127).to(torch.int8)
    b = torch.randn(N, generator=g, device=dev) * 0.1 if bias else None
    return x.to(x_dtype), w_q, w_scale, amax, b


# columns of one GEMM kernel block (csrc/int8_gemm.cu GemmCfg: 256 for an
# fp32 x, else 128): how many times the blocks read and quantize a float x
GEMM_BLOCK_N = {torch.float32: 256, torch.bfloat16: 128, torch.int8: 128}


def x_traffic(m, k, n, x_dtype) -> str:
    """GB of x the GEMM's column blocks read through L2 (each block reads
    its rows of x once), and what 128-column blocks would read."""
    size = m * k * torch.tensor([], dtype=x_dtype).element_size() / 1e9
    now = -(-n // GEMM_BLOCK_N[x_dtype])
    narrow = -(-n // 128)
    return (f"x {size:.3f} GB read by {now} column blocks: "
            f"{now * size:.2f} GB through L2 (128-column blocks: {narrow}, "
            f"{narrow * size:.2f} GB)")


def check_int8_kernels(dev, g, run_case, launches_equal) -> None:
    """Phase 2's static int8 cases: the GEMM and MLP kernels (B4) and the
    int8-output attention (B3), each against its plain version and a
    control, timed against torch._int_mm / SDPA and the bound; B4's two
    launches on the same inputs bit-equal."""
    import torch.nn.functional as F
    from simple_tad_tpu_torch.ops import flash_attention as fa
    from simple_tad_tpu_torch.ops import int8_gemm
    from simple_tad_tpu_torch.ops.ln import quantize_static
    M = 32 * 1568                              # ViT-B batch 32 tokens
    gemm_cases = [("qkv", M, 768, 2304, torch.int8, False),
                  ("proj", M, 768, 768, torch.int8, True),
                  ("fc2", M, 3072, 768, torch.float32, True),
                  # IV2-S: qkv on the bf16 RMSNorm output, an M tail
                  ("iv2 qkv", 32 * 2049, 384, 1152, torch.bfloat16, False)]
    for label, m, k, n, x_dtype, bias in gemm_cases:
        x, w_q, w_s, amax, b = _gemm_operands(g, dev, m, k, n, x_dtype, bias)
        args = (x, w_q, w_s, amax, b, None, torch.bfloat16)
        x_i8 = x if x_dtype == torch.int8 else quantize_static(x.float(),
                                                               amax)
        # roundf moves a code only at an exact tie, which fp32 inputs hit
        # (bf16 ones at these shapes did not, on the CPU rehearsal)
        control = (int8_gemm_roundf if x_dtype == torch.float32
                   else int8_gemm_bf16_rescale)
        case = (f"{label} ({m}, {k}) {x_dtype} -> {n}"
                f"{' + bias' if bias else ''}")
        run_case("int8_gemm", case,
                 lambda: int8_gemm.w8a8_gemm(*args),
                 lambda: int8_gemm.w8a8_gemm_plain(*args),
                 lambda: control(*args),
                 time_it="every", library=int8_library((x_i8, w_q)),
                 bound=int8_gemm_bound(m, k, n, x.element_size(), 2))
        launches_equal("int8_gemm", case, lambda: int8_gemm.w8a8_gemm(*args))
        if x_dtype != torch.int8:
            print(f"[int8_gemm] {label}: {x_traffic(m, k, n, x_dtype)}")
        del x, x_i8, args
        torch.cuda.empty_cache()

    # ViT-L's width takes the MLP kernel too (use_fused_mlp)
    mlp_cases = [("vit-b", M, 768, 3072, torch.int8),
                 ("iv2-s", 32 * 2049, 384, 1536, torch.bfloat16),
                 ("vit-l", M, 1024, 4096, torch.int8)]
    for label, m, dim, hidden, x_dtype in mlp_cases:
        x, w1, s1, a1, b1 = _gemm_operands(g, dev, m, dim, hidden, x_dtype,
                                           True)
        _, w2, s2, _, b2 = _gemm_operands(g, dev, 8, hidden, dim,
                                          torch.float32, True)
        h = int8_gemm.w8a8_gemm_plain(x, w1, s1, a1, b1, "gelu_tanh",
                                      torch.float32)
        a2 = torch.quantile(h[:4096].abs().flatten(), 0.999)
        h_i8 = quantize_static(h, a2)
        del h
        x_i8 = x if x_dtype == torch.int8 else quantize_static(x.float(), a1)
        args = (x, w1, s1, a1, b1, w2, s2, a2, b2, "gelu_tanh",
                torch.bfloat16)
        case = f"{label} ({m}, {dim}) {x_dtype} -> {hidden}"
        run_case("int8_mlp", case,
                 lambda: int8_gemm.w8a8_mlp(*args),
                 lambda: int8_gemm.w8a8_mlp_plain(*args),
                 [lambda: int8_mlp_no_bias1(*args),
                  lambda: int8_mlp_bf16_hidden(*args)],
                 time_it="every",
                 library=int8_library((x_i8, w1), (h_i8, w2)),
                 bound=int8_mlp_bound(m, dim, hidden, x.element_size(), 2))
        launches_equal("int8_mlp", case, lambda: int8_gemm.w8a8_mlp(*args))
        del x, x_i8, h_i8, args
        torch.cuda.empty_cache()

    # B3: packed at ViT-B b32, on separate operands at IV2-S b32 (v the
    # strided column block), and a masked fp32 tail
    for shape, heads, dt in [((32, 1568, 2304), 12, torch.bfloat16),
                             ((2, 200, 384), 2, torch.float32)]:
        B, N, C3 = shape
        qkv = torch.randn(shape, generator=g, device=dev).to(dt)
        scale = (C3 // 3 // heads) ** -0.5
        out_amax = fa.flash_attention_qkv_plain(qkv[:2], heads,
                                                scale).float().abs().max()
        q, k, v = qkv_views(qkv, heads)
        route = fa.attention_fwd_route(dt, C3 // 3 // heads)
        run_case("attention_q8", f"{shape} H={heads} {dt}",
                 lambda: fa.flash_attention_qkv_q8(qkv, heads, scale,
                                                   out_amax),
                 lambda: fa.flash_attention_qkv_q8_plain(qkv, heads, scale,
                                                         out_amax),
                 (lambda: attention_q8_control(qkv, heads, scale, out_amax))
                 if dt == torch.bfloat16 else None,
                 library=lambda: F.scaled_dot_product_attention(
                     q, k, v, scale=scale),
                 bound=attention_bound(B, N, C3 // 3, heads, dt,
                                       q8_out=True), route=route)
        if route == "wgmma":
            launches_equal("attention_q8", f"{shape} H={heads} {dt}",
                           lambda: fa.flash_attention_qkv_q8(
                               qkv, heads, scale, out_amax))
        del qkv, q, k, v
        torch.cuda.empty_cache()
    for shape, heads, dt, n_valid in [
            ((32, 2049, 1152), 6, torch.bfloat16, None),
            ((32, 2049, 1152), 6, torch.bfloat16, 2040),     # keys masked
            # IV2-1B's head dim 88 (96-column tiles), keys masked
            ((4, 2049, 4224), 16, torch.bfloat16, 2040),
            ((2, 200, 384), 2, torch.float32, 190)]:
        B, N, C3 = shape
        C = C3 // 3
        qkv = torch.randn(shape, generator=g, device=dev).to(dt)
        q, k, v = (qkv[..., :C].contiguous(), qkv[..., C:2 * C].contiguous(),
                   qkv[..., 2 * C:])
        scale = (C // heads) ** -0.5
        out_amax = fa.flash_attention_plain(q[:2], k[:2], v[:2], heads,
                                            scale).float().abs().max()
        args = (q, k, v, heads, scale, out_amax, n_valid)
        qh, kh, vh = sep_heads(heads, q, k, v)
        bf16 = dt == torch.bfloat16
        route = fa.attention_fwd_route(dt, C // heads)
        case = f"{shape} H={heads} {dt} n_valid={n_valid}, v strided"
        run_case("attention_q8_sep", case,
                 lambda: fa.flash_attention_q8(*args),
                 lambda: fa.flash_attention_q8_plain(*args),
                 ([lambda: attention_q8_sep_control(*args)] if bf16 else [])
                 + [lambda: attention_q8_sep_misread_v(*args)],
                 time_it=("every" if C // heads != fa.WGMMA_HEAD_DIM
                          else True),
                 library=lambda: F.scaled_dot_product_attention(
                     qh, kh, vh, scale=scale),
                 bound=attention_bound(B, N, C, heads, dt, q8_out=True),
                 route=route)
        if route == "wgmma":
            launches_equal("attention_q8_sep", case,
                           lambda: fa.flash_attention_q8(*args))
        del qkv, q, k, v, qh, kh, vh, args
        torch.cuda.empty_cache()


def check_variant_kernels(dev, g, run_case, launches_equal) -> list:
    """Phase 12 (i): E1 (add_layernorm_quant) and E2 (attention_int8)
    against their plain versions and controls, each timed at its first
    case (the main-path shape) -> the failed checks beyond run_case's."""
    from simple_tad_tpu_torch.ops import flash_attention as fa
    from simple_tad_tpu_torch.ops import ln
    failures = []
    for shape, dt in E1_CASES:
        C = shape[-1]
        branch = (torch.randn(shape, generator=g, device=dev) * 2
                  + 0.5).to(dt)
        residual = (torch.randn(shape, generator=g, device=dev) * 3).to(dt)
        w = torch.randn(C, generator=g, device=dev) * 0.2 + 1
        b = torch.randn(C, generator=g, device=dev) * 0.1
        total = (branch.float() + residual.float()).to(dt)
        # a calibrated absmax: that of the LayerNorm of the sum itself
        amax = ln.layernorm_plain(total, w, b, out_dtype=torch.float32
                                  ).abs().max()
        del total
        args = (branch, residual, w, b, amax)
        got_sum, got = ln.add_layernorm_quant(*args)
        same = torch.equal(got, ln.layernorm_quant(got_sum, w, b, amax))
        print(f"[add_layernorm_quant] {shape} {dt}: codes equal to B1's of "
              f"the stored sum bit for bit: {same}")
        if not same:
            failures.append(f"add_layernorm_quant {shape} {dt}: codes "
                            f"differ from B1's of the stored sum")
        del got_sum, got
        esz = branch.element_size()
        copies = (args, (branch.clone(), residual.clone(), w, b, amax))
        run_case("add_layernorm_quant", f"{shape} {dt}",
                 in_turn(ln.add_layernorm_quant, *copies),
                 in_turn(ln.add_layernorm_quant_plain, *copies),
                 [lambda: add_layernorm_quant_control(*args),
                  lambda: add_layernorm_quant_residual_only(*args)],
                 bound=layernorm_bound(shape[0], C, 2 * esz, esz + 1))
        del branch, residual, args, copies
        torch.cuda.empty_cache()

    for shape, heads in E2_CASES:
        B, N, C3 = shape
        D = C3 // 3 // heads
        qkv = torch.randn(shape, generator=g, device=dev)
        amax = qkv.view(B, N, 3, heads, D).abs().amax(dim=(0, 1, 4))
        inv = (127.0 / amax).reshape(-1).repeat_interleave(D)
        qkv_i8 = torch.clamp(torch.round(qkv * inv), -127, 127).to(torch.int8)
        del qkv, inv
        args = (qkv_i8, amax, heads, D ** -0.5)
        route = fa.attention_int8_route(D)
        case = f"{shape} H={heads}"
        run_case("attention_int8", case,
                 lambda: fa.flash_attention_qkv_int8(*args),
                 lambda: fa.flash_attention_qkv_int8_plain(*args),
                 [lambda: attention_int8_unrounded(*args),
                  lambda: attention_int8_max_free(*args),
                  lambda: attention_int8_unpermuted_v(*args)],
                 time_it="every" if route == "mma_sync" else True,
                 bound=attention_bound(B, N, C3 // 3, heads, int8_pv=True),
                 route=route, route_counts=int8_route_counts)
        if route == "wgmma":
            launches_equal("attention_int8", case,
                           lambda: fa.flash_attention_qkv_int8(*args))
        del qkv_i8, args
        torch.cuda.empty_cache()
    return failures


class MemoryClipDataset:
    """One in-memory clip with the two methods FrameEvaluator calls."""

    def __init__(self, frames: np.ndarray, view_len: int, seed: int,
                 step: int = 1):
        from simple_tad_tpu_torch.data.frame_datasets import (ClipEvalView,
                                                              ClipInfo)
        rng = np.random.default_rng(seed)
        n = frames.shape[0]
        labels = (rng.random(n) < 0.3).astype(np.int64)
        names = [f"{t:06d}.jpg" for t in range(n)]
        clip = ClipInfo(
            name="synthetic", zip_path="", frame_names=names,
            timesteps=np.arange(n), binary_labels=labels, cat_labels=labels,
            ego=False, night=False, ttc=np.zeros(n),
            smoothed=np.stack([1.0 - labels, labels], 1).astype(np.float32))
        span = (view_len - 1) * step + 1
        windows = np.stack([np.arange(s, s + span, step)
                            for s in range(n - span + 1)])
        last = windows[:, -1]
        self.frames = frames
        self.view = ClipEvalView(
            clip=clip, unique_frames=np.arange(n),
            window_idx=windows.astype(np.int32), labels=labels[last],
            smoothed=clip.smoothed[last], ttc=clip.ttc[last],
            frame_names=[names[i] for i in last])

    def clip_eval_views(self):
        return [self.view]

    def decode_clip_frames(self, view, resize_on_host=True):
        if resize_on_host:
            raise ValueError("the in-memory clip is resized on the device")
        return self.frames


@contextlib.contextmanager
def routed(**fns):
    """Route the model's kernel wrappers, by name, through other versions
    (the plain versions or the controls, for the comparison runs only)."""
    from simple_tad_tpu_torch.models import internvideo2, layers
    from simple_tad_tpu_torch.ops import attention
    owner = {"layernorm": layers, "layernorm_quant": layers,
             "flash_attention_qkv": attention,
             "flash_attention_qkv_i8d": attention,
             "flash_attention": attention, "flash_attention_i8d": attention,
             "flash_attention_qkv_q8": layers,
             "flash_attention_q8": internvideo2,
             "rmsnorm_quant": internvideo2, "w8a8_gemm": layers,
             "w8a8_mlp": layers, "add_layernorm_quant": layers,
             "flash_attention_qkv_int8": attention}
    with contextlib.ExitStack() as stack:
        for name, fn in fns.items():
            stack.enter_context(mock.patch.object(owner[name], name, fn))
        yield


def logits_of(res) -> np.ndarray:
    return np.stack([res.rows["logits_safe"], res.rows["logits_risk"]], 1)


N_FRAMES, HEIGHT, WIDTH, BATCH = 96, 360, 640, 32


def vit_b(dev, seed: int, dtype):
    from simple_tad_tpu_torch.models import create_model
    return create_model("vit_base_patch16_224", device=dev, dtype=dtype,
                        generator=torch.Generator().manual_seed(seed),
                        init_scale=1.0)


def synthetic_clip(cfg, seed: int, step: int = 1):
    """-> (dataset of one seeded 96-frame 360x640 clip whose windows take
    every ``step``-th frame, window count, chunk forwards per evaluate)."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (N_FRAMES, HEIGHT, WIDTH, 3), np.uint8)
    ds = MemoryClipDataset(frames, cfg.all_frames, seed, step)
    n_windows = ds.view.window_idx.shape[0]
    assert n_windows == N_FRAMES - (cfg.all_frames - 1) * step
    return ds, n_windows, -(-n_windows // BATCH)


def run_eval(dev, seed: int):
    """Phase 3 -> (model, stats dict)."""
    batch = BATCH
    from simple_tad_tpu_torch.eval.engine import FrameEvaluator
    from simple_tad_tpu_torch.ops import flash_attention, ln
    model = vit_b(dev, seed, torch.bfloat16)
    cfg = model.cfg
    ds, n_windows, chunks = synthetic_clip(cfg, seed)
    ev = FrameEvaluator(model, device=dev, batch_size=batch,
                        resize_on_host=False, precompute_tubelets=True)
    ev.evaluate(ds)                                  # warm-up

    reset_counts()
    res = ev.evaluate(ds)
    launches = read_counts()
    rates = [res.windows_per_sec] + [ev.evaluate(ds).windows_per_sec
                                     for _ in range(EVAL_RUNS - 1)]
    logits = logits_of(res)
    with routed(layernorm=ln.layernorm_plain,
                flash_attention_qkv=flash_attention.flash_attention_qkv_plain):
        plain_res = ev.evaluate(ds)
    with routed(layernorm=layernorm_control,
                flash_attention_qkv=attention_control):
        control = logits_of(ev.evaluate(ds))
    plain = logits_of(plain_res)
    scale = float(np.abs(plain).max())
    err = float(np.abs(logits - plain).max()) / scale
    control_err = float(np.abs(control - plain).max()) / scale
    rate = statistics.median(rates)
    print(f"[eval] vit_base_patch16_224 bf16 batch {batch}: windows "
          f"{res.n_windows}, chunks {chunks}; evaluate median {rate:.2f} "
          f"windows/s over {EVAL_RUNS} runs (min {min(rates):.2f}, max "
          f"{max(rates):.2f}); plain versions {plain_res.windows_per_sec:.2f} "
          f"windows/s (one run)")
    print(f"[eval] AUROC {res.metrics.auroc:.4f}  AUC-MCC "
          f"{res.metrics.mcc_auc:.4f} (seeded labels: shows the metrics "
          f"path runs)")
    print(f"[eval] launches {launches}; logits vs plain: max_abs_err / max "
          f"|logit| {err:.3e}, controls {control_err:.3e} (bound "
          f"{LOGIT_RTOL:.3e}, max |logit| {scale:.3e})")
    assert res.n_windows == n_windows
    assert np.isfinite(logits).all(), "non-finite logits"
    want = dict.fromkeys(COUNTERS, 0)
    # every attention call on the wgmma route (head dim 64)
    want.update(attention=cfg.depth * chunks,
                fwd_route_wgmma=cfg.depth * chunks,
                layernorm=(2 * cfg.depth + 1) * chunks)
    assert launches == want, (launches, want)
    assert err <= LOGIT_RTOL, f"logits disagree with the plain run: {err}"
    assert control_err > LOGIT_RTOL, \
        f"the logit bound lets the controls through: {control_err}"
    return model, {"windows_per_sec": rate, "launches": launches,
                   "logits_err": err, "logits": logits}


def trunk_b(family: str, dev, seed: int, dtype, **kw):
    """MVD-B (3-D sincos table, N = 1568: jobs/finetune/MVD-B_DoTA.sh sets
    no CLS token) or UMT-B (tubelet 1, 8 frames, the UMT table: N = 1568),
    seeded, head scale 1."""
    from simple_tad_tpu_torch.models import create_model
    return create_model(f"{family}_vit_base_patch16_224", device=dev,
                        dtype=dtype, init_scale=1.0,
                        generator=torch.Generator().manual_seed(seed), **kw)


def attention_next_head_v(qkv, num_heads: int, scale: float):
    """The plain packed attention with each head reading the next head's v:
    the gross control of phase 14's feature check."""
    from simple_tad_tpu_torch.ops.flash_attention import (
        flash_attention_qkv_plain)
    C = qkv.shape[-1] // 3
    v = qkv[..., 2 * C:].roll(-(C // num_heads), dims=-1)
    return flash_attention_qkv_plain(torch.cat([qkv[..., :2 * C], v], -1),
                                     num_heads, scale)


def head_inputs(ev, ds, **routes):
    """One evaluate with the wrappers ``routes`` -> (result, the pooled
    features the head took, (windows, C) fp32)."""
    feats = []
    hook = ev.model.head.register_forward_hook(
        lambda mod, args, out: feats.append(args[0].detach().float().cpu()))
    try:
        with routed(**routes):
            res = ev.evaluate(ds)
    finally:
        hook.remove()
    return res, torch.cat(feats).numpy()


def feature_error(got, want) -> float:
    """max over windows of ||got - want|| / ||want||."""
    return float((np.linalg.norm(got - want, axis=1)
                  / np.linalg.norm(want, axis=1)).max())


def run_eval_trunk(dev, seed: int, family: str,
                   seeds: int = TRUNK_SEEDS) -> dict:
    """Phase 14: MVD-B or UMT-B bf16 through FrameEvaluator at batch 32 on
    phase 3's clip (UMT: windows of every other frame), timed over
    EVAL_RUNS; 12 A1 launches a chunk forward, all on the wgmma route, and
    25 LayerNorm; every A1 and LayerNorm call of one evaluate against its
    plain version and its control at the call's inputs (check_sites); then,
    at each of ``seeds`` seeds, the pooled features the head takes (the
    head is the same fp32 Linear in every run, so the logits differ by its
    weight times theirs) against the plain-version run within
    FEATURE_RTOL and the gross control outside it (the subtle one is
    printed: it reads within 1.2x of the kernels, so check_sites holds it)."""
    from simple_tad_tpu_torch.eval.engine import FrameEvaluator
    from simple_tad_tpu_torch.ops import flash_attention as fa
    from simple_tad_tpu_torch.ops import ln
    label = f"{family} eval"
    step = IV2_VIEW_STEP if family == "umt" else 1
    sites = {"attention": ("flash_attention_qkv", fa.flash_attention_qkv,
                           fa.flash_attention_qkv_plain, attention_control),
             "layernorm": ("layernorm", ln.layernorm, ln.layernorm_plain,
                           layernorm_control)}
    controls = {"subtle": dict(layernorm=layernorm_control,
                               flash_attention_qkv=attention_control),
                "gross": dict(flash_attention_qkv=attention_next_head_v)}
    readings = []
    for s in range(seed, seed + seeds):
        model = trunk_b(family, dev, s, torch.bfloat16)
        cfg = model.cfg
        ds, n_windows, chunks = synthetic_clip(cfg, s, step)
        ev = FrameEvaluator(model, device=dev, batch_size=BATCH,
                            resize_on_host=False, precompute_tubelets=True)
        if s == seed:
            ev.evaluate(ds)                              # warm-up
            reset_counts()
            res = ev.evaluate(ds)
            launches = read_counts()
            rates = [res.windows_per_sec] + [
                ev.evaluate(ds).windows_per_sec
                for _ in range(EVAL_RUNS - 1)]
            rate = statistics.median(rates)
            print(f"[{label}] {family}_vit_base_patch16_224 bf16 "
                  f"{cfg.all_frames}x{cfg.img_size} tubelet "
                  f"{cfg.tubelet_size}, N = {cfg.num_patches}, batch "
                  f"{BATCH}: windows {res.n_windows}, chunks {chunks}; "
                  f"evaluate median {rate:.2f} windows/s over {EVAL_RUNS} "
                  f"runs (min {min(rates):.2f}, max {max(rates):.2f})")
            print(f"[{label}] launches {launches}")
            site_failures = check_sites(functools.partial(ev.evaluate, ds),
                                        sites, f"{family} sites")
        res, feats = head_inputs(ev, ds)
        assert res.n_windows == n_windows == feats.shape[0]
        logits = logits_of(res)
        assert np.isfinite(logits).all() and np.isfinite(feats).all(), \
            "non-finite logits or features"
        plain_res, plain = head_inputs(
            ev, ds, layernorm=ln.layernorm_plain,
            flash_attention_qkv=fa.flash_attention_qkv_plain)
        err = feature_error(feats, plain)
        c_errs = {k: feature_error(head_inputs(ev, ds, **r)[1], plain)
                  for k, r in controls.items()}
        logit_err = (float(np.abs(logits - logits_of(plain_res)).max())
                     / float(np.abs(logits_of(plain_res)).max()))
        print(f"[{label}] seed {s}: head inputs vs plain: max over windows "
              f"||err|| / ||plain|| {err:.3e}; controls: subtle (the "
              f"phase-2 controls of A1 and A2) {c_errs['subtle']:.3e}, gross "
              f"(each head reads the next head's v) {c_errs['gross']:.3e} "
              f"(bound {FEATURE_RTOL:.3e}); logits max_abs_err / max "
              f"|logit| {logit_err:.3e} (printed)")
        readings.append((err, c_errs))
        del model, ev
        torch.cuda.empty_cache()
    errs = [r[0] for r in readings]
    print(f"[{label}] {seeds} seeds: head-input error {min(errs):.3e} "
          f"to {max(errs):.3e}; " + ", ".join(
              f"{k} control {min(r[1][k] for r in readings):.3e} to "
              f"{max(r[1][k] for r in readings):.3e}" for k in controls))
    want = dict.fromkeys(COUNTERS, 0)
    want.update(attention=cfg.depth * chunks,
                fwd_route_wgmma=cfg.depth * chunks,
                layernorm=(2 * cfg.depth + 1) * chunks)
    assert not site_failures, site_failures
    assert launches == want, (launches, want)
    assert max(errs) <= FEATURE_RTOL, \
        f"features disagree with the plain run: {errs}"
    assert all(r[1]["gross"] > FEATURE_RTOL for r in readings), \
        f"the feature bound lets the gross control through: {readings}"
    return {"windows_per_sec": rate, "launches": launches,
            "feature_err": max(errs)}


def vit_int8_sites():
    """-> {kernel name: (wrapper name, kernel, plain, control)} of the int8
    ViT's main path."""
    from simple_tad_tpu_torch.ops import flash_attention as fa
    from simple_tad_tpu_torch.ops import ln
    return {"layernorm_quant": ("layernorm_quant", ln.layernorm_quant,
                                ln.layernorm_quant_plain,
                                layernorm_quant_control),
            "attention_i8": ("flash_attention_qkv_i8d",
                             fa.flash_attention_qkv_i8d,
                             fa.flash_attention_qkv_i8d_plain,
                             attention_i8_control)}


def iv2_int8_sites(fused_rmsq: bool):
    """-> the same for static int8 InternVideo2."""
    from simple_tad_tpu_torch.ops import flash_attention as fa
    from simple_tad_tpu_torch.ops import ln
    sites = {"attention_i8_sep": ("flash_attention_i8d",
                                  fa.flash_attention_i8d,
                                  fa.flash_attention_i8d_plain,
                                  attention_i8_sep_control)}
    if fused_rmsq:
        sites["rmsnorm_quant"] = ("rmsnorm_quant", ln.rmsnorm_quant,
                                  ln.rmsnorm_quant_plain,
                                  rmsnorm_quant_control)
    return sites


def check_sites(run, sites, label: str = "int8 sites", *, router=None,
                scaled=(), calls=None) -> list:
    """One ``run()`` in which every kernel call of ``sites`` {name: (route,
    kernel, plain, controls)} also runs the plain version and the controls
    on the same inputs (the run goes on with the kernel's output) -> the
    failed checks.  ``route``: the wrapper's name in ``router`` (default
    ``routed``; ``routed_train`` for the training wrappers).
    ``controls``: one control, which every call must catch, or a list of
    (label, control, must): must 'every' call catch it, 'any' call, or
    None (printed).  ``scaled``: names whose outputs are compared divided
    by the power of two nearest the plain output's largest magnitude
    (exact), so that phase 2's bounds, set on outputs of magnitude ~1, hold
    a training step's small gradients as they hold those.  ``calls``:
    {name: the calls the run must make} (default: at least one), so that
    a path around the routed wrapper fails the check."""
    readings = {name: [] for name in sites}
    spec = {name: c if isinstance(c, list) else [("control", c, "every")]
            for name, (_, _, _, c) in sites.items()}

    def checked(name, kernel, plain, _):
        def fn(*args, **kwargs):
            want = plain(*args, **kwargs)
            got = kernel(*args, **kwargs)
            s = _pow2_scale(want) if name in scaled else None

            def held(out):
                if s is None:
                    return compare(name, out, want)
                return compare(name, _scaled(out, s), _scaled(want, s))

            readings[name].append((held(got), [
                held(ctrl(*args, **kwargs)) for _, ctrl, _ in spec[name]]))
            return got
        return fn

    with (router or routed)(**{route: checked(name, *fns)
                               for name, (route, *fns) in sites.items()}):
        run()
    failures = []
    for name, rs in readings.items():
        want_calls = (calls or {}).get(name)
        if not rs or want_calls not in (None, len(rs)):
            failures.append(f"{name}: {len(rs)} checked calls, expected "
                            f"{want_calls or 'at least one'}")
            continue
        shares = [r[0][1] for r in rs]
        bound = I8_MISMATCH.get(name, BF16_MISMATCH.get(name))
        print(f"[{label}] {name}: {len(rs)} calls on the main path; "
              f"outputs differing from plain max {max(shares):.3e} (mean "
              f"{statistics.mean(shares):.3e}), max_abs_err "
              f"{max(r[0][0] for r in rs):.3e}"
              + (f" (bound {bound:.1e})" if bound is not None else ""))
        failures += [f"{name} call {i}" for i, r in enumerate(rs)
                     if not r[0][2]]
        for j, (c_label, _, must) in enumerate(spec[name]):
            caught = [not r[1][j][2] for r in rs]
            print(f"[{label}] {name}: {c_label} differing min "
                  f"{min(r[1][j][1] for r in rs):.3e}; caught at "
                  f"{sum(caught)} of {len(rs)} calls (required: "
                  f"{must or 'none, printed'})")
            if must == "every":
                failures += [f"{name} call {i}: {c_label} not caught"
                             for i, c in enumerate(caught) if not c]
            elif must == "any" and not any(caught):
                failures.append(f"{name}: {c_label} caught at no call")
    return failures


def static_int8_evaluator(model, dev, seed: int, masters, options: dict):
    """The static int8 serving of phases 5 and 12 (and of the A/B's int8
    evals): ``model`` quantized from the fp32 state dict ``masters`` with
    FrameEvaluator ``options``, on phase 3's clip at its batch, calibrated
    explicitly, then one warm-up evaluate -> (evaluator, clip, windows,
    chunk forwards, calibration seconds)."""
    from simple_tad_tpu_torch.eval.engine import FrameEvaluator
    ds, n_windows, chunks = synthetic_clip(model.cfg, seed)
    ev = FrameEvaluator(model, device=dev, batch_size=BATCH,
                        resize_on_host=False, precompute_tubelets=True,
                        quant8=True, fp32_state=masters, **options)
    t0 = time.perf_counter()
    ev.calibrate(ds)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    ev.evaluate(ds)                                  # warm-up
    return ev, ds, n_windows, chunks, calib_s


def run_eval_int8(model, dev, seed: int, bf16_logits):
    """Phase 5 -> (static int8 model, stats dict)."""
    from simple_tad_tpu_torch.ops import flash_attention as fa
    from simple_tad_tpu_torch.ops import ln
    cfg = model.cfg
    # the int8 model is quantized from the fp32 masters: the same seeded
    # build at fp32 (never the bf16 model's weights)
    masters = vit_b("cpu", seed, torch.float32).state_dict()
    ev, ds, n_windows, chunks, calib_s = static_int8_evaluator(
        model, dev, seed, masters, {})

    reset_counts()
    res = ev.evaluate(ds)
    launches = read_counts()
    rates = [res.windows_per_sec] + [ev.evaluate(ds).windows_per_sec
                                     for _ in range(EVAL_RUNS - 1)]
    logits = logits_of(res)
    site_failures = check_sites(functools.partial(ev.evaluate, ds),
                                vit_int8_sites())
    with routed(layernorm=ln.layernorm_plain,
                layernorm_quant=ln.layernorm_quant_plain,
                flash_attention_qkv_i8d=fa.flash_attention_qkv_i8d_plain):
        plain_res = ev.evaluate(ds)
    with routed(layernorm=ln.layernorm_plain,
                layernorm_quant=ln.layernorm_quant_plain,
                flash_attention_qkv_i8d=attention_i8_unnormalized):
        control = logits_of(ev.evaluate(ds))
    plain = logits_of(plain_res)
    scale = float(np.abs(plain).max())
    err = float(np.abs(logits - plain).max()) / scale
    control_err = float(np.abs(control - plain).max()) / scale
    drift = float(np.abs(logits - bf16_logits).max())
    rate = statistics.median(rates)
    print(f"[int8] vit_base_patch16_224 static int8 batch {BATCH}: "
          f"calibrate {calib_s:.2f} s; evaluate median {rate:.2f} windows/s "
          f"over {EVAL_RUNS} runs (min {min(rates):.2f}, max "
          f"{max(rates):.2f}); plain versions "
          f"{plain_res.windows_per_sec:.2f} windows/s (one run)")
    print(f"[int8] launches {launches} over {chunks} chunk forwards; logits "
          f"vs plain: max_abs_err / max |logit| {err:.3e}, gross control "
          f"{control_err:.3e} (bound {LOGIT_RTOL_I8:.3e}, max |logit| "
          f"{scale:.3e}); int8 vs bf16 max |logit difference| {drift:.3e} "
          f"(seeded weights: printed, not bounded)")
    assert not site_failures, site_failures
    assert res.n_windows == n_windows
    assert np.isfinite(logits).all(), "non-finite int8 logits"
    want = dict.fromkeys(COUNTERS, 0)
    # every int8 attention call on the wgmma route (head dim 64)
    want.update(layernorm_quant=2 * cfg.depth * chunks,
                attention_i8=cfg.depth * chunks,
                i8_route_wgmma=cfg.depth * chunks, layernorm=chunks)
    assert launches == want, (launches, want)
    assert err <= LOGIT_RTOL_I8, \
        f"int8 logits disagree with the plain run: {err}"
    assert control_err > LOGIT_RTOL_I8, \
        f"the int8 logit bound lets the gross control through: {control_err}"
    return ev.model, {"windows_per_sec": rate, "launches": launches,
                      "logits_err": err, "logits": logits}


def run_stream(model, dev, seed: int, steps: int = 16,
               label: str = "stream") -> float:
    """Phase 4 -> median ms per streamed frame (host clock, synchronised)."""
    from simple_tad_tpu_torch.cli.inference import StreamingScorer
    cfg = model.cfg
    rng = np.random.default_rng(seed + 1)
    frames = torch.from_numpy(rng.integers(
        0, 256, (cfg.all_frames + steps, cfg.img_size, cfg.img_size, 3),
        np.uint8)).to(dev)
    scorer = StreamingScorer(model)
    window = frames[:cfg.all_frames]
    window, risk = scorer.step(window, window[-1])          # warm-up
    times, risks = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        window, risk = scorer.step(window, frames[cfg.all_frames + i])
        risks.append(float(risk))                            # synchronises
        times.append((time.perf_counter() - t0) * 1e3)
    assert all(0.0 <= r <= 1.0 for r in risks), risks
    ms = statistics.median(times)
    print(f"[{label}] {steps} batch-1 steps: median {ms:.3f} ms/frame "
          f"(min {min(times):.3f}, max {max(times):.3f})")
    return ms


COUNTERS = {"layernorm": ("ln", "LAUNCHES"),
            "attention_drop_fwd": ("fa", "DROP_FWD_LAUNCHES"),
            "attention_drop_bwd": ("fa", "DROP_BWD_LAUNCHES"),
            "attention_drop_rng_fwd": ("fa", "DROP_RNG_FWD_LAUNCHES"),
            "attention_drop_rng_bwd": ("fa", "DROP_RNG_BWD_LAUNCHES"),
            "layernorm_quant": ("ln", "QUANT_LAUNCHES"),
            "rmsnorm_quant": ("ln", "RMSQ_LAUNCHES"),
            "attention": ("fa", "LAUNCHES"),
            "attention_sep": ("fa", "SEP_LAUNCHES"),
            "attention_i8": ("fa", "I8_LAUNCHES"),
            "attention_i8_sep": ("fa", "I8_SEP_LAUNCHES"),
            "attention_fwd_lse": ("fa", "FWD_LSE_LAUNCHES"),
            "attention_bwd": ("fa", "BWD_LAUNCHES"),
            "attention_sep_fwd_lse": ("fa", "SEP_FWD_LSE_LAUNCHES"),
            "attention_sep_bwd": ("fa", "SEP_BWD_LAUNCHES"),
            "attention_q8": ("fa", "Q8_LAUNCHES"),
            "attention_q8_sep": ("fa", "Q8_SEP_LAUNCHES"),
            "int8_gemm": ("gemm", "GEMM_LAUNCHES"),
            "int8_mlp": ("gemm", "MLP_LAUNCHES"),
            "add_layernorm_quant": ("ln", "ADD_QUANT_LAUNCHES"),
            "attention_int8": ("fa", "INT8_LAUNCHES"),
            "attention_delta": ("fa", "DELTA_LAUNCHES"),
            # the kernels a C2 / C3-bwd / C4-bwd call took
            # (fa.attention_bwd_route)
            "bwd_route_wgmma": ("fa", "BWD_WGMMA_LAUNCHES"),
            "bwd_route_mma_sync": ("fa", "BWD_MMA_LAUNCHES"),
            "bwd_route_fp32": ("fa", "BWD_F32_LAUNCHES"),
            # the kernel an A1, A1-sep, C1, C3-fwd, B3, B3-sep or C4-fwd
            # call took (fa.attention_fwd_route)
            "fwd_route_wgmma": ("fa", "FWD_WGMMA_LAUNCHES"),
            "fwd_route_mma_sync": ("fa", "FWD_MMA_LAUNCHES"),
            "fwd_route_fp32": ("fa", "FWD_F32_LAUNCHES"),
            # the kernel a B2 / D2 call took (fa.attention_i8_route), and an
            # E2 call (fa.attention_int8_route)
            "i8_route_wgmma": ("fa", "I8_WGMMA_LAUNCHES"),
            "i8_route_mma_sync": ("fa", "I8_MMA_LAUNCHES"),
            "int8_route_wgmma": ("fa", "INT8_WGMMA_LAUNCHES"),
            "int8_route_mma_sync": ("fa", "INT8_MMA_LAUNCHES")}


def fwd_route_counts() -> dict:
    """-> {route: launches} of the bf16/fp32 attention forward so far."""
    counts = read_counts()
    return {route: counts[f"fwd_route_{route}"]
            for route in ("wgmma", "mma_sync", "fp32")}


def i8_route_counts() -> dict:
    """-> {route: launches} of the int8-storage attention (B2, D2)."""
    counts = read_counts()
    return {route: counts[f"i8_route_{route}"]
            for route in ("wgmma", "mma_sync")}


def int8_route_counts() -> dict:
    """-> {route: launches} of the int8-compute attention (E2)."""
    counts = read_counts()
    return {route: counts[f"int8_route_{route}"]
            for route in ("wgmma", "mma_sync")}


def _counter_owners():
    from simple_tad_tpu_torch.ops import flash_attention as fa
    from simple_tad_tpu_torch.ops import int8_gemm, ln
    return {"ln": ln, "fa": fa, "gemm": int8_gemm}


def reset_counts() -> None:
    owners = _counter_owners()
    for mod, attr in COUNTERS.values():
        setattr(owners[mod], attr, 0)


def read_counts() -> dict:
    owners = _counter_owners()
    return {name: getattr(owners[mod], attr)
            for name, (mod, attr) in COUNTERS.items()}


def iv2_s(dev, seed: int, dtype):
    """IV2-S 8x224 of the DoTA job, seeded; LayerScale 0.1 (the reference
    goldens' magnitude) and head scale 1, so the trunk moves the logits."""
    from simple_tad_tpu_torch.models import create_model
    return create_model("internvideo2_small_patch14_224", device=dev,
                        dtype=dtype, num_frames=8, init_values=0.1,
                        init_scale=1.0,
                        generator=torch.Generator().manual_seed(seed))


def logit_errors(logits, plain, control):
    """-> (max |logits - plain| / max |plain|, the same for the control)."""
    scale = float(np.abs(plain).max())
    return (float(np.abs(logits - plain).max()) / scale,
            float(np.abs(control - plain).max()) / scale, scale)


def run_eval_iv2(dev, seed: int):
    """Phase 7 -> (model, stats dict)."""
    from simple_tad_tpu_torch.eval.engine import FrameEvaluator
    from simple_tad_tpu_torch.ops import flash_attention as fa
    model = iv2_s(dev, seed, torch.bfloat16)
    cfg = model.cfg
    ds, n_windows, chunks = synthetic_clip(cfg, seed, IV2_VIEW_STEP)
    ev = FrameEvaluator(model, device=dev, batch_size=BATCH,
                        resize_on_host=False, precompute_tubelets=True)
    ev.evaluate(ds)                                  # warm-up
    reset_counts()
    res = ev.evaluate(ds)
    launches = read_counts()
    rates = [res.windows_per_sec] + [ev.evaluate(ds).windows_per_sec
                                     for _ in range(EVAL_RUNS - 1)]
    logits = logits_of(res)
    site_failures = check_sites(
        functools.partial(ev.evaluate, ds),
        {"attention_sep": ("flash_attention", fa.flash_attention,
                           fa.flash_attention_plain, attention_sep_control)},
        "iv2 sites")
    with routed(flash_attention=fa.flash_attention_plain):
        plain_res = ev.evaluate(ds)
    with routed(flash_attention=attention_sep_misread_v):
        control = logits_of(ev.evaluate(ds))
    err, control_err, scale = logit_errors(logits, logits_of(plain_res),
                                           control)
    rate = statistics.median(rates)
    print(f"[iv2 eval] internvideo2_small_patch14_224 8x224 (N = "
          f"{cfg.num_patches + 1}) bf16 batch {BATCH}, view step "
          f"{IV2_VIEW_STEP}: windows {res.n_windows}, chunks {chunks}; "
          f"evaluate median {rate:.2f} windows/s over {EVAL_RUNS} runs (min "
          f"{min(rates):.2f}, max {max(rates):.2f}); plain versions "
          f"{plain_res.windows_per_sec:.2f} windows/s (one run)")
    print(f"[iv2 eval] launches {launches}; logits vs plain: max_abs_err / "
          f"max |logit| {err:.3e}, gross control (v read with q's row "
          f"stride) {control_err:.3e} (bound {LOGIT_RTOL_IV2:.3e}, max "
          f"|logit| {scale:.3e})")
    assert not site_failures, site_failures
    assert res.n_windows == n_windows
    assert np.isfinite(logits).all(), "non-finite IV2 logits"
    want = dict.fromkeys(COUNTERS, 0)
    # every attention call on the wgmma route (head dim 64)
    want["attention_sep"] = want["fwd_route_wgmma"] = cfg.depth * chunks
    assert launches == want, (launches, want)
    assert err <= LOGIT_RTOL_IV2, f"IV2 logits disagree with plain: {err}"
    assert control_err > LOGIT_RTOL_IV2, \
        f"the IV2 logit bound lets the gross control through: {control_err}"
    return model, {"windows_per_sec": rate, "launches": launches,
                   "logits_err": err, "logits": logits}


def run_eval_iv2_int8(dev, seed: int, bf16_logits, fused_rmsq: bool):
    """Phase 8, once unfused and once with ``fused_rmsq`` -> stats dict."""
    from simple_tad_tpu_torch.eval.engine import FrameEvaluator
    from simple_tad_tpu_torch.ops import flash_attention as fa
    from simple_tad_tpu_torch.ops import ln
    model = iv2_s(dev, seed, torch.bfloat16)
    cfg = model.cfg
    ds, n_windows, chunks = synthetic_clip(cfg, seed, IV2_VIEW_STEP)
    masters = iv2_s("cpu", seed, torch.float32).state_dict()
    ev = FrameEvaluator(model, device=dev, batch_size=BATCH,
                        resize_on_host=False, precompute_tubelets=True,
                        quant8=True, fp32_state=masters,
                        fused_rmsq=fused_rmsq)
    del model
    t0 = time.perf_counter()
    ev.calibrate(ds)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    ev.evaluate(ds)                                  # warm-up
    reset_counts()
    res = ev.evaluate(ds)
    launches = read_counts()
    rates = [res.windows_per_sec] + [ev.evaluate(ds).windows_per_sec
                                     for _ in range(EVAL_RUNS - 1)]
    logits = logits_of(res)
    site_failures = check_sites(functools.partial(ev.evaluate, ds),
                                iv2_int8_sites(fused_rmsq))
    plain = dict(flash_attention_i8d=fa.flash_attention_i8d_plain,
                 **({"rmsnorm_quant": ln.rmsnorm_quant_plain}
                    if fused_rmsq else {}))
    with routed(**plain):
        plain_res = ev.evaluate(ds)
    with routed(**dict(plain,
                       flash_attention_i8d=attention_i8_sep_unnormalized)):
        control = logits_of(ev.evaluate(ds))
    err, control_err, scale = logit_errors(logits, logits_of(plain_res),
                                           control)
    drift = float(np.abs(logits - bf16_logits).max())
    rate = statistics.median(rates)
    label = "[iv2 int8" + (" fused_rmsq]" if fused_rmsq else "]")
    print(f"{label} static int8 batch {BATCH}: calibrate {calib_s:.2f} s; "
          f"evaluate median {rate:.2f} windows/s over {EVAL_RUNS} runs (min "
          f"{min(rates):.2f}, max {max(rates):.2f}); plain versions "
          f"{plain_res.windows_per_sec:.2f} windows/s (one run)")
    print(f"{label} launches {launches} over {chunks} chunk forwards; "
          f"logits vs plain: max_abs_err / max |logit| {err:.3e}, gross "
          f"control {control_err:.3e} (bound {LOGIT_RTOL_IV2_I8:.3e}, max "
          f"|logit| {scale:.3e}); int8 vs bf16 max |logit difference| "
          f"{drift:.3e} (seeded weights: printed, not bounded)")
    assert not site_failures, site_failures
    assert res.n_windows == n_windows
    assert np.isfinite(logits).all(), "non-finite IV2 int8 logits"
    want = dict.fromkeys(COUNTERS, 0)
    # every D2 call on the wgmma route (head dim 64)
    want["attention_i8_sep"] = want["i8_route_wgmma"] = cfg.depth * chunks
    if fused_rmsq:   # norm1, norm2, q-norm, k-norm
        want["rmsnorm_quant"] = 4 * cfg.depth * chunks
    assert launches == want, (launches, want)
    assert err <= LOGIT_RTOL_IV2_I8, \
        f"IV2 int8 logits disagree with the plain run: {err}"
    assert control_err > LOGIT_RTOL_IV2_I8, \
        f"the IV2 int8 logit bound lets the control through: {control_err}"
    return {"windows_per_sec": rate, "launches": launches,
            "logits_err": err}


def fused_sites(family: str, qkv_i8: bool, fused_rmsq: bool) -> dict:
    """-> {kernel name: (wrapper name, kernel, plain, control)} of the
    static int8 model on the fused GEMMs (phase 10)."""
    from simple_tad_tpu_torch.ops import flash_attention as fa
    from simple_tad_tpu_torch.ops import int8_gemm
    sites = {"int8_gemm": ("w8a8_gemm", int8_gemm.w8a8_gemm,
                           int8_gemm.w8a8_gemm_plain, int8_gemm_bf16_rescale),
             "int8_mlp": ("w8a8_mlp", int8_gemm.w8a8_mlp,
                          int8_gemm.w8a8_mlp_plain, int8_mlp_bf16_hidden)}
    if family == "vit":
        vit = vit_int8_sites()
        sites["layernorm_quant"] = vit["layernorm_quant"]
        sites.update({"attention_i8": vit["attention_i8"]} if qkv_i8 else {
            "attention_q8": ("flash_attention_qkv_q8",
                             fa.flash_attention_qkv_q8,
                             fa.flash_attention_qkv_q8_plain,
                             attention_q8_control)})
    else:
        sites.update(iv2_int8_sites(fused_rmsq) if qkv_i8 else {
            "attention_q8_sep": ("flash_attention_q8", fa.flash_attention_q8,
                                 fa.flash_attention_q8_plain,
                                 attention_q8_sep_control)})
    return sites


def fused_launches(family: str, depth: int, chunks: int, qkv_i8: bool,
                   fused_rmsq: bool) -> dict:
    """The kernel launches of one static int8 evaluate on the fused GEMMs:
    per block and chunk forward one attention, two GEMM kernels (qkv,
    proj) and one MLP kernel, the ViT's two LayerNorm->int8 and the IV2's
    four RMSNorm->int8 with fused_rmsq (norm1, norm2, q-norm, k-norm), and
    the ViT's fc_norm."""
    want = dict.fromkeys(COUNTERS, 0)
    want.update(int8_gemm=2 * depth * chunks, int8_mlp=depth * chunks)
    if family == "vit":
        want.update(layernorm_quant=2 * depth * chunks, layernorm=chunks)
        want["attention_i8" if qkv_i8 else "attention_q8"] = depth * chunks
    else:
        want["attention_i8_sep" if qkv_i8 else "attention_q8_sep"] = \
            depth * chunks
        if fused_rmsq:
            want["rmsnorm_quant"] = 4 * depth * chunks
    # B2 / D2, or B3, at head dim 64: the wgmma route
    want["i8_route_wgmma" if qkv_i8 else "fwd_route_wgmma"] = depth * chunks
    return want


def run_eval_fused(dev, seed: int, family: str, variants, bf16_logits):
    """Phase 10 for one family: static int8 serving with fused_w8a8 and
    fused_mlp, in each of ``variants`` ((label, qkv_i8, fused_rmsq, runs)),
    from one set of seeded fp32 masters -> {label: stats dict}."""
    from simple_tad_tpu_torch.eval.engine import FrameEvaluator
    from simple_tad_tpu_torch.ops import flash_attention as fa
    from simple_tad_tpu_torch.ops import int8_gemm, ln, quant
    build = vit_b if family == "vit" else iv2_s
    step = 1 if family == "vit" else IV2_VIEW_STEP
    masters = build("cpu", seed, torch.float32).state_dict()
    out = {}
    for label, qkv_i8, fused_rmsq, runs in variants:
        model = build(dev, seed, torch.bfloat16)
        cfg = model.cfg
        ds, n_windows, chunks = synthetic_clip(cfg, seed, step)
        ev = FrameEvaluator(model, device=dev, batch_size=BATCH,
                            resize_on_host=False, precompute_tubelets=True,
                            quant8=True, fp32_state=masters,
                            fused_rmsq=fused_rmsq, fused_w8a8=True,
                            fused_mlp=True, qkv_i8=qkv_i8)
        del model
        ev.calibrate(ds)
        ev.evaluate(ds)                              # warm-up
        reset_counts()
        int_mm = quant.INT_MM_CALLS
        res = ev.evaluate(ds)
        launches = read_counts()
        int_mm = quant.INT_MM_CALLS - int_mm
        rates = [res.windows_per_sec] + [ev.evaluate(ds).windows_per_sec
                                         for _ in range(runs - 1)]
        logits = logits_of(res)
        sites = fused_sites(family, qkv_i8, fused_rmsq)
        site_failures = check_sites(functools.partial(ev.evaluate, ds),
                                    sites, f"{label} sites")
        plain = {route: fns[1] for route, *fns in sites.values()}
        plain.update(layernorm=ln.layernorm_plain)
        with routed(**plain):
            plain_res = ev.evaluate(ds)
        attn = [k for k in sites if k.startswith("attention")][0]
        gross = {"attention_i8": attention_i8_unnormalized,
                 "attention_q8": attention_q8_unnormalized,
                 "attention_i8_sep": attention_i8_sep_unnormalized,
                 "attention_q8_sep": attention_q8_sep_unnormalized}[attn]
        with routed(**dict(plain, **{sites[attn][0]: gross})):
            control = logits_of(ev.evaluate(ds))
        err, control_err, scale = logit_errors(logits, logits_of(plain_res),
                                               control)
        drift = float(np.abs(logits - bf16_logits).max())
        rate = statistics.median(rates)
        bound = LOGIT_RTOL_I8 if family == "vit" else LOGIT_RTOL_IV2_I8
        print(f"[{label}] static int8, fused_w8a8 + fused_mlp"
              f"{'' if qkv_i8 else ', qkv_i8=False'}"
              f"{', fused_rmsq' if fused_rmsq else ''}, batch {BATCH}: "
              f"evaluate median {rate:.2f} windows/s over {runs} runs (min "
              f"{min(rates):.2f}, max {max(rates):.2f}); plain versions "
              f"{plain_res.windows_per_sec:.2f} windows/s (one run)")
        print(f"[{label}] launches {launches} over {chunks} chunk "
              f"forwards, torch._int_mm calls {int_mm}; logits vs plain: "
              f"max_abs_err / max |logit| {err:.3e}, gross control "
              f"{control_err:.3e} (bound {bound:.3e}, max |logit| "
              f"{scale:.3e}); vs bf16 max |logit difference| {drift:.3e} "
              f"(printed, not bounded)")
        assert not site_failures, site_failures
        assert res.n_windows == n_windows
        assert np.isfinite(logits).all(), f"non-finite {label} logits"
        want = fused_launches(family, cfg.depth, chunks, qkv_i8, fused_rmsq)
        assert launches == want, (label, launches, want)
        assert int_mm == 0, f"{label}: {int_mm} torch._int_mm calls"
        assert err <= bound, f"{label} logits disagree with plain: {err}"
        assert control_err > bound, \
            f"the {label} logit bound lets the gross control through"
        if label == "vit fused":
            run_stream(ev.model, dev, seed, label="int8 fused stream")
        out[label] = {"windows_per_sec": rate, "launches": launches,
                      "logits_err": err}
        del ev
        torch.cuda.empty_cache()
    return out


def variant_sites(options: dict) -> dict:
    """-> {kernel name: (wrapper name, kernel, plain, control)} of the
    static int8 ViT with the variants in ``options`` (phase 12)."""
    from simple_tad_tpu_torch.ops import flash_attention as fa
    from simple_tad_tpu_torch.ops import ln
    sites = (fused_sites("vit", True, False) if options.get("fused_w8a8")
             else vit_int8_sites())
    if options.get("add_lnq"):
        del sites["layernorm_quant"]
        sites["add_layernorm_quant"] = (
            "add_layernorm_quant", ln.add_layernorm_quant,
            ln.add_layernorm_quant_plain, add_layernorm_quant_control)
    if options.get("int8_attn"):
        del sites["attention_i8"]
        sites["attention_int8"] = (
            "flash_attention_qkv_int8", fa.flash_attention_qkv_int8,
            fa.flash_attention_qkv_int8_plain, attention_int8_unrounded)
    return sites


def variant_launches(options: dict, depth: int, chunks: int) -> dict:
    """The kernel launches of one evaluate of the static int8 ViT with the
    variants in ``options``: per block and chunk forward two norms (E1 with
    add_lnq, else B1), one attention (E2 with int8_attn, else B2), with the
    fused GEMMs two GEMM kernels and one MLP kernel; the fc_norm."""
    want = dict.fromkeys(COUNTERS, 0)
    want["layernorm"] = chunks
    norm = "add_layernorm_quant" if options.get("add_lnq") \
        else "layernorm_quant"
    attn = "attention_int8" if options.get("int8_attn") else "attention_i8"
    # every int8 attention call on its wgmma route (head dim 64)
    route = "int8_route_wgmma" if options.get("int8_attn") \
        else "i8_route_wgmma"
    want.update({norm: 2 * depth * chunks, attn: depth * chunks,
                 route: depth * chunks})
    if options.get("fused_w8a8"):
        want.update(int8_gemm=2 * depth * chunks, int8_mlp=depth * chunks)
    return want


def run_eval_variants(dev, seed: int, bf16_logits, int8_logits) -> dict:
    """Phase 12 (ii): static int8 ViT-B with add_lnq, with int8_attn, and
    with both on the fused GEMMs, from phase 5's seeded masters and
    explicit calibration on phase 3's clip -> {label: stats dict}.
    ``int8_logits``: phase 5's (the static model without either variant)."""
    from simple_tad_tpu_torch.ops import ln, quant
    masters = vit_b("cpu", seed, torch.float32).state_dict()
    variants = [("add_lnq", dict(add_lnq=True)),
                ("int8_attn", dict(int8_attn=True)),
                ("variants fused", dict(add_lnq=True, int8_attn=True,
                                        fused_w8a8=True, fused_mlp=True))]
    out = {}
    for label, options in variants:
        ev, ds, n_windows, chunks, _ = static_int8_evaluator(
            vit_b(dev, seed, torch.bfloat16), dev, seed, masters, options)
        reset_counts()
        int_mm = quant.INT_MM_CALLS
        res = ev.evaluate(ds)
        launches = read_counts()
        int_mm = quant.INT_MM_CALLS - int_mm
        rates = [res.windows_per_sec] + [ev.evaluate(ds).windows_per_sec
                                         for _ in range(EVAL_RUNS - 1)]
        logits = logits_of(res)
        sites = variant_sites(options)
        site_failures = check_sites(functools.partial(ev.evaluate, ds),
                                    sites, f"{label} sites")
        rate = statistics.median(rates)
        drift = float(np.abs(logits - bf16_logits).max())
        vs_int8 = float(np.abs(logits - int8_logits).max())
        print(f"[{label}] static int8 ViT-B {options}, batch {BATCH}: "
              f"evaluate median {rate:.2f} windows/s over {EVAL_RUNS} runs "
              f"(min {min(rates):.2f}, max {max(rates):.2f})")
        print(f"[{label}] launches {launches} over {chunks} chunk forwards, "
              f"torch._int_mm calls {int_mm}; vs bf16 max |logit "
              f"difference| {drift:.3e}, vs the phase-5 int8 model "
              f"{vs_int8:.3e} (max |bf16 logit| "
              f"{float(np.abs(bf16_logits).max()):.3e}; printed, not "
              f"bounded)")
        assert not site_failures, site_failures
        assert res.n_windows == n_windows
        assert np.isfinite(logits).all(), f"non-finite {label} logits"
        want = variant_launches(options, ev.model.cfg.depth, chunks)
        assert launches == want, (label, launches, want)
        if options.get("fused_w8a8"):
            assert int_mm == 0, f"{label}: {int_mm} torch._int_mm calls"
        stats = {"windows_per_sec": rate, "launches": launches}
        if options.get("int8_attn"):
            plain = {route: fns[1] for route, *fns in sites.values()}
            plain.update(layernorm=ln.layernorm_plain)
            with routed(**plain):
                plain_res = ev.evaluate(ds)
            with routed(**dict(plain, flash_attention_qkv_int8=(
                    attention_int8_unnormalized))):
                control = logits_of(ev.evaluate(ds))
            err, control_err, scale = logit_errors(
                logits, logits_of(plain_res), control)
            print(f"[{label}] logits vs plain: max_abs_err / max |logit| "
                  f"{err:.3e}, gross control {control_err:.3e} (bound "
                  f"{LOGIT_RTOL_I8:.3e}, max |logit| {scale:.3e}); plain "
                  f"versions {plain_res.windows_per_sec:.2f} windows/s (one "
                  f"run)")
            assert err <= LOGIT_RTOL_I8, \
                f"{label} logits disagree with plain: {err}"
            assert control_err > LOGIT_RTOL_I8, \
                f"the {label} logit bound lets the gross control through"
            stats["logits_err"] = err
        else:
            equal = np.array_equal(logits, int8_logits)
            print(f"[{label}] logits equal to the phase-5 static model's "
                  f"(no carry) bit for bit: {equal}")
            assert equal, f"{label}: logits differ from the unfused chain"
        if label == "variants fused":
            run_stream(ev.model, dev, seed, label="int8 variants stream")
        out[label] = stats
        del ev
        torch.cuda.empty_cache()
    return out


class SyntheticTrainDataset:
    """``n`` training windows of seeded uint8 frames (frames, CLIP_H,
    CLIP_W, 3) with the two members TrainLoader reads; the frames cycle
    through a pool of 8 so the host pays copies, not random draws."""

    def __init__(self, n: int, seed: int, frames: int = 16, pool: int = 8):
        import types
        rng = np.random.default_rng(seed)
        self.frames = rng.integers(0, 256, (pool, frames, CLIP_H, CLIP_W, 3),
                                   np.uint8)
        labels = rng.integers(0, 2, n)
        self.samples = [types.SimpleNamespace(
            label=int(y), ttc=0.0,
            smoothed=np.array([1.0 - y, y], np.float32)) for y in labels]

    def __len__(self):
        return len(self.samples)

    def get_window_frames(self, index, *, final_resize=True,
                          resize_scale=None):
        return self.frames[index % len(self.frames)], self.samples[index]


def job_model(dev, seed: int, family: str = "vit", attn_drop: float = 0.0,
              form: str = "rng"):
    """The model of a fine-tuning job, seeded fp32 masters computed in bf16
    with the job's default head init scale: ViT-B 16x224 with drop path 0.2
    (jobs/finetune/VideoMAE-B_DoTA.sh), with attention dropout ``attn_drop``
    in ``form`` (phase 11), or IV2-S 8x224 with the CLI's drop path 0.1
    (jobs/finetune/IV2-S_DoTA.sh) and LayerScale 0.1 (the reference goldens'
    magnitude, as phase 7)."""
    from simple_tad_tpu_torch.models import create_model
    if family == "iv2":
        return create_model("internvideo2_small_patch14_224", device=dev,
                            dtype=torch.bfloat16, param_dtype=torch.float32,
                            num_frames=8, drop_path_rate=0.1,
                            init_values=0.1,
                            generator=torch.Generator().manual_seed(seed))
    if family in TRUNKS:
        return trunk_b(family, dev, seed, torch.bfloat16,
                       param_dtype=torch.float32, drop_path_rate=0.2)
    return create_model("vit_base_patch16_224", device=dev,
                        dtype=torch.bfloat16, param_dtype=torch.float32,
                        drop_path_rate=0.2, attn_drop_rate=attn_drop,
                        attn_dropout_form=form,
                        generator=torch.Generator().manual_seed(seed))


def job_state(model, dev, seed: int, family: str = "vit"):
    """AdamW of the job at a constant lr (weight decay 0.05, no clipping;
    ViT-B: layer decay 0.6 and TRAIN_LR; IV2-S: the CLI's layer decay 0.75
    and IV2_LR), and the generator of the training masks."""
    from simple_tad_tpu_torch.train.optim import FinetuneOptimizer
    from simple_tad_tpu_torch.train.steps import TrainState
    lr, layer_decay = {"iv2": (IV2_LR, 0.75), "mvd": (TRUNK_LR, 0.6),
                       "umt": (TRUNK_LR, 0.6)}.get(family, (TRAIN_LR, 0.6))
    opt = FinetuneOptimizer(dict(model.named_parameters()), lr_schedule=lr,
                            weight_decay=0.05, layer_decay=layer_decay,
                            depth=model.cfg.depth)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    return TrainState.create(model, opt, gen)


def augmented_batch(dev, batch: int, seed: int, frames: int = 16):
    """Seeded uint8 clips of ``frames`` frames through the port's
    train_augment on the card (the jobs' RandAugment m6 n3 and
    RandomErasing 0.25)."""
    from simple_tad_tpu_torch.ops.augment import train_augment
    rng = np.random.default_rng(seed)
    u8 = torch.from_numpy(rng.integers(
        0, 256, (batch, frames, CLIP_H, CLIP_W, 3), np.uint8)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    video = train_augment(u8, gen, crop_size=224, magnitude=6.0,
                          num_layers=3, reprob=0.25, dtype=torch.bfloat16)
    assert video.shape == (batch, frames, 224, 224, 3), video.shape
    assert torch.isfinite(video.float()).all(), "non-finite augmentation"
    labels = torch.from_numpy(rng.integers(0, 2, batch)).to(dev)
    return {"video": video, "label": labels,
            "smoothed": torch.stack([1 - labels, labels], 1).float(),
            "ttc": torch.zeros(batch, device=dev)}


@contextlib.contextmanager
def routed_train(**fns):
    """Route the training kernels' wrappers (the attention forward and
    backward, the LayerNorm forward), by name, through other versions
    (comparison runs only)."""
    from simple_tad_tpu_torch.ops import flash_attention as fa
    from simple_tad_tpu_torch.ops import ln
    with contextlib.ExitStack() as stack:
        for name, fn in fns.items():
            stack.enter_context(mock.patch.object(
                ln if name == "layernorm" else fa, name, fn))
        yield


def train_routes(family: str, no_delta: bool = False) -> dict:
    """The wrappers a train step of ``family`` runs, routed to their plain
    versions, or with the backward's control (no delta term)."""
    from simple_tad_tpu_torch.ops import flash_attention as fa
    from simple_tad_tpu_torch.ops import ln
    if family == "iv2":
        return {"flash_attention_fwd_lse": fa.flash_attention_fwd_lse_plain,
                "flash_attention_bwd": (attention_sep_bwd_no_delta
                                        if no_delta
                                        else fa.flash_attention_bwd_plain)}
    return {"flash_attention_qkv_fwd_lse":
            fa.flash_attention_qkv_fwd_lse_plain,
            "flash_attention_qkv_bwd": (attention_bwd_no_delta if no_delta
                                        else fa.flash_attention_qkv_bwd_plain),
            "layernorm": ln.layernorm_plain}


def step_grads(model, batch, gen, gen_state, soft: bool = False):
    """Forward and backward of one train step (no update) -> {name: grad}
    of the parameters that take one, and the loss (against the labels, or
    with ``soft`` the soft targets, batch['smoothed']); the masks are drawn
    from ``gen`` reset to ``gen_state``."""
    from simple_tad_tpu_torch.train.losses import cross_entropy
    gen.set_state(gen_state)
    model.train()
    for p in model.parameters():
        p.grad = None
    loss = cross_entropy(model(batch["video"], generator=gen),
                         batch["smoothed" if soft else "label"])
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    for p in model.parameters():
        p.grad = None
    return grads, loss.item()


# parameters whose gradient is zero in exact arithmetic: IV2's pooling head
# adds these biases to every key of its one query, which shifts each softmax
# row by a constant, so both runs hold only rounding noise there (on the
# H100 the two read 1.36 of its own norm apart); they are held to the global
# norm
ZERO_GRAD_PARAMS = ("clip_projector.cross_attn.k_bias",
                    "clip_projector.norm1_k.bias")


def grad_errors(got, want):
    """-> (relative error of the global gradient norm, worst relative
    error ||got - want|| / ||want|| of a parameter (of the global norm for
    ZERO_GRAD_PARAMS), its name)."""
    from simple_tad_tpu_torch.train.optim import global_norm
    gn, wn = global_norm(got.values()).item(), global_norm(want.values()).item()
    per = {n: ((got[n] - want[n]).float().norm()
               / (wn if n in ZERO_GRAD_PARAMS else want[n].float().norm())
               ).item()
           for n in want if want[n].float().norm() > 0}
    worst = max(per, key=per.get)
    return abs(gn - wn) / wn, per[worst], worst


def run_finetune(dev, seed: int, family: str = "vit") -> dict:
    """Phase 6 (ViT-B), 9 (IV2-S) or 14 (MVD-B, UMT-B) (i) and (ii) at batch
    TRAIN_BATCH -> stats."""
    from simple_tad_tpu_torch.ops import flash_attention as fa
    from simple_tad_tpu_torch.train.losses import create_criterion
    from simple_tad_tpu_torch.train.steps import make_finetune_train_step
    iv2 = family == "iv2"
    label, frames, lr = {"iv2": ("iv2 finetune", 8, IV2_LR),
                         "mvd": ("mvd finetune", 16, TRUNK_LR),
                         "umt": ("umt finetune", 8, TRUNK_LR)}.get(
                             family, ("finetune", 16, TRAIN_LR))
    model = job_model(dev, seed, family)
    batch = augmented_batch(dev, TRAIN_BATCH, seed, frames)
    state = job_state(model, dev, seed, family)
    g0 = state.generator.get_state()
    kern, loss_k = step_grads(model, batch, state.generator, g0)
    with routed_train(**train_routes(family)):
        plain, loss_p = step_grads(model, batch, state.generator, g0)
    with routed_train(**train_routes(family, no_delta=True)):
        ctrl, _ = step_grads(model, batch, state.generator, g0)
    norm_err, param_err, worst = grad_errors(kern, plain)
    c_norm, c_param, c_worst = grad_errors(ctrl, plain)
    del kern, plain, ctrl
    state.generator.set_state(g0)
    name = {"iv2": "internvideo2_small_patch14_224 8x224",
            "mvd": "mvd_vit_base_patch16_224 (N = 1568)",
            "umt": "umt_vit_base_patch16_224 8x224 tubelet 1"}.get(
                family, "vit_base_patch16_224")
    print(f"[{label}] {name} bf16, fp32 masters, batch {TRAIN_BATCH}: loss "
          f"{loss_k:.6f} (plain versions {loss_p:.6f}); gradients vs plain: "
          f"global norm rel err {norm_err:.3e} (bound {GRAD_NORM_RTOL:.1e}), "
          f"worst parameter {param_err:.3e} ({worst}; bound "
          f"{GRAD_PARAM_RTOL:.1e}); control (no delta): {c_norm:.3e}, "
          f"{c_param:.3e} ({c_worst})")

    step = make_finetune_train_step(create_criterion("crossentropy"))
    reset_counts()
    metrics, logits = step(state, batch)
    torch.cuda.synchronize()
    launches = read_counts()
    losses = [float(metrics["loss"])]
    for _ in range(TRAIN_STEPS - 1):
        metrics, logits = step(state, batch)
        losses.append(float(metrics["loss"]))
    drop = 1.0 - losses[-1] / losses[0]
    print(f"[{label}] launches in one train step {launches} (each backward "
          f"call launches the delta pre-pass, then two kernels: dk/dv, dq)")
    print(f"[{label}] {TRAIN_STEPS} steps on one augmented batch at "
          f"constant lr {lr}: losses "
          f"{' '.join(f'{x:.5f}' for x in losses)}; drop {drop:.3f} "
          f"(required {LOSS_DROP}); last grad_norm "
          f"{float(metrics['grad_norm']):.4e}")
    depth = model.cfg.depth
    head_dim = model.cfg.embed_dim // model.cfg.num_heads
    route = fa.attention_bwd_route(torch.bfloat16, head_dim)
    fwd_route = fa.attention_fwd_route(torch.bfloat16, head_dim)
    print(f"[{label}] routes at head dim {head_dim}: forward {fwd_route} "
          f"(fwd_route_wgmma {launches['fwd_route_wgmma']}, "
          f"fwd_route_mma_sync {launches['fwd_route_mma_sync']}, "
          f"fwd_route_fp32 {launches['fwd_route_fp32']} calls in the step), "
          f"backward {route} "
          f"(bwd_route_wgmma {launches['bwd_route_wgmma']}, "
          f"bwd_route_mma_sync {launches['bwd_route_mma_sync']}, "
          f"bwd_route_fp32 {launches['bwd_route_fp32']} calls in the step)")
    want = dict.fromkeys(COUNTERS, 0)
    if iv2:       # RMSNorm and the pooling head are plain PyTorch
        want.update(attention_sep_fwd_lse=depth, attention_sep_bwd=depth)
    else:
        want.update(layernorm=2 * depth + 1, attention_fwd_lse=depth,
                    attention_bwd=depth)
    want["attention_delta"] = depth
    # every trunk the fine-tuning jobs run has head dim 64: the wgmma kernels
    assert head_dim == 64 and route == fwd_route == "wgmma", (head_dim,
                                                             route)
    want["bwd_route_wgmma"] = want["fwd_route_wgmma"] = depth
    assert logits.shape == (TRAIN_BATCH, 2)
    assert np.isfinite(losses).all(), losses
    assert launches == want, (launches, want)
    assert norm_err <= GRAD_NORM_RTOL and param_err <= GRAD_PARAM_RTOL, \
        "gradients disagree with the plain-version step"
    assert c_norm > GRAD_NORM_RTOL or c_param > GRAD_PARAM_RTOL, \
        "the gradient bounds let the control through"
    assert drop >= LOSS_DROP, \
        f"the fixed-batch loss fell by {drop:.3f}"
    return {"launches": launches, "grad_norm_err": norm_err,
            "grad_param_err": param_err, "losses": losses}


def run_finetune_dropout(dev, seed: int) -> dict:
    """Phase 11 (iii): one ViT-B train step at batch TRAIN_BATCH with
    attention dropout ATTN_DROP in each form -> {form: launches}.  Its
    gradients against the same step through the plain versions from the
    same generator state (phase 6's bounds), and phase 6's control outside
    them (the backward without its delta term); then the launch counts of
    one real step: 12 dropout forward and 12 dropout backward calls of the
    form, 25 LayerNorm, and no C1, C2 or other attention."""
    from simple_tad_tpu_torch.ops import flash_attention as fa
    from simple_tad_tpu_torch.ops import ln
    from simple_tad_tpu_torch.train.losses import create_criterion
    from simple_tad_tpu_torch.train.steps import make_finetune_train_step
    out = {}
    batch = augmented_batch(dev, TRAIN_BATCH, seed)
    for form in ("rng", "mask"):
        label = f"finetune attn_drop {ATTN_DROP} {form}"
        model = job_model(dev, seed, attn_drop=ATTN_DROP, form=form)
        state = job_state(model, dev, seed)
        g0 = state.generator.get_state()
        plain = {"flash_attention_drop_fwd": fa.flash_attention_drop_fwd_plain,
                 "layernorm": ln.layernorm_plain}
        kern, loss_k = step_grads(model, batch, state.generator, g0)
        with routed_train(**plain,
                          flash_attention_drop_bwd=fa
                          .flash_attention_drop_bwd_plain):
            want, loss_p = step_grads(model, batch, state.generator, g0)
        errs = grad_errors(kern, want)
        no_delta = {"flash_attention_drop_bwd": attention_drop_bwd_no_delta}
        with routed_train(**plain, **no_delta):
            ctrl, _ = step_grads(model, batch, state.generator, g0)
        c_errs = grad_errors(ctrl, want)
        del kern, want, ctrl
        print(f"[{label}] {model.cfg.embed_dim}-wide ViT, "
              f"{model.cfg.depth} blocks, bf16, fp32 masters, batch "
              f"{TRAIN_BATCH}: loss {loss_k:.6f} (plain versions "
              f"{loss_p:.6f}); gradients vs plain: global norm rel err "
              f"{errs[0]:.3e} (bound {GRAD_NORM_RTOL:.1e}), worst parameter "
              f"{errs[1]:.3e} ({errs[2]}; bound {GRAD_PARAM_RTOL:.1e}); "
              f"control (no delta): {c_errs[0]:.3e}, {c_errs[1]:.3e} "
              f"({c_errs[2]})")
        step = make_finetune_train_step(create_criterion("crossentropy"))
        state.generator.set_state(g0)
        reset_counts()
        metrics, logits = step(state, batch)
        torch.cuda.synchronize()
        launches = read_counts()
        print(f"[{label}] launches in one train step {launches}; loss "
              f"{float(metrics['loss']):.6f}")
        depth = model.cfg.depth
        want_counts = dict.fromkeys(COUNTERS, 0)
        fwd, bwd = DROP_KERNELS[form]
        # ViT-B's head dim 64: C4-fwd and C4-bwd on the wgmma routes
        assert fa.attention_fwd_route(torch.bfloat16, 64) == \
            fa.attention_bwd_route(torch.bfloat16, 64) == "wgmma"
        want_counts.update({"layernorm": 2 * depth + 1, fwd: depth,
                            bwd: depth, "attention_delta": depth,
                            "fwd_route_wgmma": depth,
                            "bwd_route_wgmma": depth})
        assert logits.shape == (TRAIN_BATCH, 2)
        assert np.isfinite(float(metrics["loss"]))
        assert launches == want_counts, (launches, want_counts)
        assert errs[0] <= GRAD_NORM_RTOL and errs[1] <= GRAD_PARAM_RTOL, \
            f"{label}: gradients disagree with the plain-version step"
        assert c_errs[0] > GRAD_NORM_RTOL or c_errs[1] > GRAD_PARAM_RTOL, \
            f"{label}: the gradient bounds let the control through"
        out[form] = launches
        del model, state, metrics, logits
        torch.cuda.empty_cache()
    return out


def mae_b(dev, seed: int):
    """The DAPT job's MAE-B (decoder depth 4), seeded fp32 masters computed
    in bf16."""
    from simple_tad_tpu_torch.models import create_model
    return create_model("pretrain_videomae_base_patch16_224", device=dev,
                        dtype=torch.bfloat16, param_dtype=torch.float32,
                        decoder_depth=4,
                        generator=torch.Generator().manual_seed(seed))


def mae_state(model, dev, seed: int, lr=MAE_LR):
    """The DAPT job's AdamW (betas 0.9 / 0.95, weight decay 0.05, no layer
    decay) at a constant lr, and the generator of the training masks."""
    from simple_tad_tpu_torch.train.optim import FinetuneOptimizer
    from simple_tad_tpu_torch.train.steps import TrainState
    opt = FinetuneOptimizer(dict(model.named_parameters()), lr_schedule=lr,
                            weight_decay=0.05, betas=(0.9, 0.95))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    return TrainState.create(model, opt, gen)


def mae_masks(batch: int, ratio: float, seed: int, window=(8, 14, 14)):
    """(batch, tokens) tube masks of a token grid (the DAPT job's 8 x 14 x
    14) -> (mask, masked tokens a row)."""
    from simple_tad_tpu_torch.data.masking import TubeMaskingGenerator
    gen = TubeMaskingGenerator(window, ratio)
    return gen.batch(batch, np.random.default_rng(seed)), gen.total_masks


def pretrain_batch(dev, batch: int, seed: int, ratio: float):
    """Seeded uint8 clips through the port's pretrain_augment_align on the
    card (the job's --transforms_finetune_align) and tube masks ->
    ({'video', 'mask'}, masked tokens a row)."""
    from simple_tad_tpu_torch.ops.augment import pretrain_augment_align
    rng = np.random.default_rng(seed)
    u8 = torch.from_numpy(rng.integers(
        0, 256, (batch, 16, CLIP_H, CLIP_W, 3), np.uint8)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    video = pretrain_augment_align(u8, gen, crop_size=224,
                                   dtype=torch.bfloat16)
    assert video.shape == (batch, 16, 224, 224, 3), video.shape
    assert torch.isfinite(video.float()).all(), "non-finite augmentation"
    mask, num_masked = mae_masks(batch, ratio, seed)
    return {"video": video, "mask": torch.from_numpy(mask).to(dev)}, \
        num_masked


def mae_step_grads(model, batch, num_masked: int, gen, gen_state):
    """Forward and backward of one MAE step (train/steps.py:mae_loss, no
    update) -> ({name: grad}, loss), the masks drawn from ``gen`` reset to
    ``gen_state``."""
    from simple_tad_tpu_torch.train.steps import mae_loss
    gen.set_state(gen_state)
    for p in model.parameters():
        p.grad = None
    loss = mae_loss(model, batch, num_masked, gen)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return grads, loss.item()


def run_pretrain(dev, seed: int) -> dict:
    """Phase 13 (i) and (ii): one MAE-B step at batch TRAIN_BATCH at each of
    MAE_MASKS, its gradients against the plain-version step and the control
    (no delta term), the launch counts of one real step (C1 and C2 once a
    block, 12 + 4, on the wgmma routes; the delta pre-pass 16; LayerNorm
    2 * 12 + 1 + 2 * 4 + 1 = 34; nothing else); then TRAIN_STEPS steps on
    one fixed batch at mask 0.75, whose loss must fall by LOSS_DROP."""
    from simple_tad_tpu_torch.ops import flash_attention as fa
    from simple_tad_tpu_torch.train.steps import make_mae_train_step
    out = {}
    for ratio in MAE_MASKS:
        label = f"dapt mask {ratio}"
        model = mae_b(dev, seed)
        cfg = model.cfg
        state = mae_state(model, dev, seed)
        batch, nm = pretrain_batch(dev, TRAIN_BATCH, seed, ratio)
        g0 = state.generator.get_state()
        kern, loss_k = mae_step_grads(model, batch, nm, state.generator, g0)
        with routed_train(**train_routes("vit")):
            plain, loss_p = mae_step_grads(model, batch, nm, state.generator,
                                           g0)
        with routed_train(**train_routes("vit", no_delta=True)):
            ctrl, _ = mae_step_grads(model, batch, nm, state.generator, g0)
        norm_err, param_err, worst = grad_errors(kern, plain)
        c_norm, c_param, c_worst = grad_errors(ctrl, plain)
        del kern, plain, ctrl
        n_vis = cfg.num_patches - nm
        print(f"[{label}] pretrain_videomae_base_patch16_224 (encoder "
              f"{cfg.encoder_embed_dim} x {cfg.encoder_depth} on {n_vis} "
              f"visible tokens, decoder {cfg.decoder_embed_dim} x "
              f"{cfg.decoder_depth} on {cfg.num_patches}) bf16, fp32 "
              f"masters, batch {TRAIN_BATCH}: loss {loss_k:.6f} (plain "
              f"versions {loss_p:.6f}); gradients vs plain: global norm rel "
              f"err {norm_err:.3e} (bound {GRAD_NORM_RTOL:.1e}), worst "
              f"parameter {param_err:.3e} ({worst}; bound "
              f"{GRAD_PARAM_RTOL:.1e}); control (no delta): {c_norm:.3e}, "
              f"{c_param:.3e} ({c_worst})")
        step = make_mae_train_step(num_masked=nm)
        state.generator.set_state(g0)
        reset_counts()
        metrics = step(state, batch)
        torch.cuda.synchronize()
        launches = read_counts()
        print(f"[{label}] launches in one train step {launches}")
        blocks = cfg.encoder_depth + cfg.decoder_depth
        assert fa.attention_fwd_route(torch.bfloat16, 64) == \
            fa.attention_bwd_route(torch.bfloat16, 64) == "wgmma"
        want = dict.fromkeys(COUNTERS, 0)
        want.update(layernorm=2 * blocks + 2, attention_fwd_lse=blocks,
                    attention_bwd=blocks, attention_delta=blocks,
                    fwd_route_wgmma=blocks, bwd_route_wgmma=blocks)
        assert np.isfinite(float(metrics["loss"]))
        assert launches == want, (launches, want)
        assert norm_err <= GRAD_NORM_RTOL and param_err <= GRAD_PARAM_RTOL, \
            f"{label}: gradients disagree with the plain-version step"
        assert c_norm > GRAD_NORM_RTOL or c_param > GRAD_PARAM_RTOL, \
            f"{label}: the gradient bounds let the control through"
        out[ratio] = {"launches": launches, "grad_norm_err": norm_err,
                      "grad_param_err": param_err}
        if ratio == MAE_MASKS[0]:
            losses = [float(metrics["loss"])]
            for _ in range(TRAIN_STEPS - 1):
                metrics = step(state, batch)
                losses.append(float(metrics["loss"]))
            drop = 1.0 - losses[-1] / losses[0]
            print(f"[{label}] {TRAIN_STEPS} steps on one augmented batch at "
                  f"constant lr {MAE_LR}: losses "
                  f"{' '.join(f'{x:.5f}' for x in losses)}; drop "
                  f"{drop:.3f} (required {LOSS_DROP}); last grad_norm "
                  f"{float(metrics['grad_norm']):.4e}")
            assert np.isfinite(losses).all(), losses
            assert drop >= LOSS_DROP, f"the fixed-batch loss fell by {drop}"
            out["losses"] = losses
        del model, state, batch, metrics
        torch.cuda.empty_cache()
    return out


class SyntheticPretrainBatches:
    """Loader batches of the double DAPT loop from memory: each step one
    part per dataset (``parts`` clips), seeded uint8 clips of 16 frames at
    CLIP_H x CLIP_W drawn from a pool of 8, and tube masks at 0.75 over
    ``window``.  The timing takes them as a list made beforehand: the
    CLI's PretrainLoader assembles its batches on worker threads while the
    card runs."""

    def __init__(self, seed: int, pool: int = 8, parts=MAE_PARTS,
                 window=(8, 14, 14)):
        rng = np.random.default_rng(seed)
        self.frames = rng.integers(0, 256, (pool, 16, CLIP_H, CLIP_W, 3),
                                   np.uint8)
        self.seed, self.parts, self.window = seed, parts, window

    def epoch(self, steps: int):
        rng = np.random.default_rng(self.seed)
        for i in range(steps):
            parts = []
            for j, n in enumerate(self.parts):
                idx = rng.integers(0, len(self.frames), n)
                parts.append({"video_u8": self.frames[idx],
                              "mask": mae_masks(n, MAE_MASKS[0],
                                                self.seed + 7 * i + j,
                                                self.window)[0]})
            yield parts


def time_steps(trainer, batches, warmup: int) -> dict:
    """``trainer.train_one_epoch(batches)`` with the host clock read as
    each step starts -> {"step_ms": each step after ``warmup``, to the next
    one's start (the last to the epoch's end), "warmup", "peak_gb"}."""
    starts, step = [], trainer.train_step

    def timed_step(state, batch):
        starts.append(time.perf_counter())
        return step(state, batch)

    trainer.train_step = timed_step
    torch.cuda.reset_peak_memory_stats()
    try:
        trainer.train_one_epoch(batches, 0, print_freq=10 ** 6)
        marks = starts + [time.perf_counter()]
    finally:
        trainer.train_step = step
    return {"step_ms": [(b - a) * 1e3 for a, b in zip(marks[warmup:],
                                                     marks[warmup + 1:])],
            "warmup": warmup,
            "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def profile_window(trainer, batches) -> dict:
    """One torch.profiler window over ``trainer.train_one_epoch(batches)``
    -> its wall ms, kernel ms, kernel ms by category and top kernels."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        trainer.train_one_epoch(batches, 1, print_freq=10 ** 6)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    sums, top, total = _kernel_categories(prof)
    return {"wall_ms": wall, "device_ms": total, "categories": sums,
            "top": top}


def largest_fitting(batches, attempt) -> dict:
    """``attempt(batch)`` for each of ``batches`` in turn until one runs
    without running out of device memory -> its dict, with "batch" and the
    batches that did not fit ("oom")."""
    oom = []
    for batch in batches:
        try:
            return {**attempt(batch), "batch": batch, "oom": oom}
        except torch.OutOfMemoryError:
            oom.append(batch)
        gc.collect()
        torch.cuda.empty_cache()
    return {"oom": oom}


def run_timing(label: str, process, args=(),
               processes: int = TIMING_PROCESSES) -> dict:
    """Phases 6, 9, 11, 13 and 15 (iii): ``process(profile, *args)`` in
    ``processes`` fresh processes one after another, the first with
    ``profile`` (its step parts and profiler window) -> the median steps,
    clips/s and peak memory; each printed."""
    ctx = multiprocessing.get_context("spawn")
    runs = []
    for i in range(processes):
        with ctx.Pool(1) as pool:
            runs.append(pool.apply(process, (i == 0, *args)))
        r = runs[-1]
        if r["oom"]:
            print(f"[{label} timing] process {i}: batch {r['oom']} does "
                  f"not fit (out of memory)")
        assert "batch" in r, "no batch size fits"
        med = statistics.median(r["step_ms"])
        print(f"[{label} timing] process {i}: batch {r['batch']}"
              f"{r.get('note', '')}, median step {med:.2f} ms over "
              f"{len(r['step_ms'])} steps after {r['warmup']} warm-up (min "
              f"{min(r['step_ms']):.2f}, max {max(r['step_ms']):.2f}): "
              f"{r['batch'] * 1e3 / med:.2f} clips/s; peak device memory "
              f"{r['peak_gb']:.2f} GiB")
    parts = runs[0].get("parts")
    if parts:
        print(f"[{label} parts] process 0, median of {BREAKDOWN_STEPS} "
              f"steps: host step {parts['step']:.2f} ms; device ms: augment "
              f"{parts['augment']:.2f}, forward + backward "
              f"{parts['forward_backward']:.2f}, optimizer "
              f"{parts['optimizer']:.2f}")
    prof = runs[0].get("profile")
    if prof:
        busy = prof["device_ms"] / prof["wall_ms"]
        print(f"[{label} profile] {PROFILE_STEPS} steps: wall "
              f"{prof['wall_ms']:.1f} ms, kernel time {prof['device_ms']:.1f}"
              f" ms, device busy {busy:.3f}, idle {1 - busy:.3f}")
        if "augment_ms" in prof:
            print(f"[{label} profile] a step's upload and train_augment_cls "
                  f"(CUDA events, median): "
                  f"{statistics.median(prof['augment_ms']):.2f} ms")
        if "teacher_ms" in prof:
            step = statistics.median(prof["step_ms"])
            teacher = statistics.median(prof["teacher_ms"])
            print(f"[{label} profile] a train step after its upload and "
                  f"augmentation (CUDA events, median): {step:.2f} ms, of "
                  f"it the teacher's forward {teacher:.2f} ms, the rest "
                  f"(the mask, the student's step) {step - teacher:.2f} ms")
        print(f"[{label} profile] by category (ms): " + ", ".join(
            f"{k} {v:.1f}" for k, v in prof["categories"].items()))
        for name, calls, ms in prof["top"]:
            print(f"[{label} profile]   {ms:9.2f} ms  {calls:5d}x  "
                  f"{name[:90]}")
    meds = [statistics.median(r["step_ms"]) for r in runs]
    return {"batch": runs[0]["batch"], "step_ms": meds,
            "clips_per_s": [runs[0]["batch"] * 1e3 / m for m in meds],
            "peak_gb": max(r["peak_gb"] for r in runs)}


def time_pretrain_process(profile: bool, seed: int) -> dict:
    """Phase 13 (iii), in a fresh process: the pre-training CLI's epoch loop
    (cli/pretrain.py:PretrainTrainer: the parts pinned on the host while
    the previous step runs, uploaded, concatenated and augmented on the
    card, the MAE step) at batch MAE_BATCH -> step times, peak memory and,
    with ``profile``, a profiler window."""
    from simple_tad_tpu_torch.cli.pretrain import PretrainTrainer
    from simple_tad_tpu_torch.train.steps import make_mae_train_step
    dev = torch.device("cuda", 0)
    model = mae_b(dev, seed)
    state = mae_state(model, dev, seed)
    step = make_mae_train_step(num_masked=mae_masks(1, MAE_MASKS[0], 0)[1])
    trainer = PretrainTrainer(step, state, device=dev, crop_size=224,
                              align=True, dtype=torch.bfloat16, seed=seed)
    batches = list(SyntheticPretrainBatches(seed).epoch(MAE_WARMUP
                                                        + MAE_TIMED))
    out = {"batch": sum(MAE_PARTS), "oom": [],
           "note": f" ({' + '.join(map(str, MAE_PARTS))}), mask "
                   f"{MAE_MASKS[0]}",
           **time_steps(trainer, batches, MAE_WARMUP)}
    if profile:
        out["profile"] = profile_window(trainer, batches[:PROFILE_STEPS])
    return out


def _kernel_categories(prof):
    """-> ({category: device ms}, top kernels [(name, calls, ms)], total
    device ms) of a torch.profiler run."""
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA]
    # first match wins: copies run inside elementwise kernels
    # the training forward (C1 packed, C3 separate, the dropout forward C4)
    # is attn_fwd_wgmma (attn_fwd_bf16 at head dims other than 64), the
    # backward (C2, C3, C4) attn_bwd_: the launch counts say which ran
    cats = {"attention fwd + lse": ("attn_fwd_wgmma", "attn_fwd_bf16"),
            "attention bwd": ("attn_bwd_",),
            "A2 layernorm": ("layernorm",),
            "gemm (cuBLAS)": ("gemm", "nvjet", "cutlass", "xmma"),
            "copies": ("direct_copy", "copy_kernel", "Memcpy", "memcpy"),
            "reductions": ("reduce_kernel",),
            "indexing": ("index", "gather", "scatter"),
            "elementwise": ("elementwise",)}
    sums = {c: 0.0 for c in cats}
    sums["other"] = 0.0
    rows = []
    for e in events:
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        rows.append((e.key, e.count, ms))
        cat = next((c for c, keys in cats.items()
                    if any(k in e.key for k in keys)), "other")
        sums[cat] += ms
    rows.sort(key=lambda r: -r[2])
    return sums, rows[:15], sum(r[2] for r in rows)


def time_training_process(profile: bool, seed: int, family: str = "vit",
                          attn_drop: float = 0.0, form: str = "rng") -> dict:
    """Phase 6, 9 or 11 (iii), in a fresh process: FinetuneTrainer at the
    job's batch (or the largest of JOB_BATCH, 48, 40, 32 that fits) -> step
    times, peak memory and, with ``profile``, the step's parts and a
    profiler window."""
    from simple_tad_tpu_torch.train.engine import FinetuneTrainer, TrainLoader
    from simple_tad_tpu_torch.train.losses import create_criterion
    from simple_tad_tpu_torch.train.steps import make_finetune_train_step
    dev = torch.device("cuda", 0)
    step = make_finetune_train_step(create_criterion("crossentropy"))

    def attempt(batch):
        model = job_model(dev, seed, family, attn_drop, form)
        state = job_state(model, dev, seed, family)
        data = SyntheticTrainDataset((WARMUP_STEPS + TIMED_STEPS) * batch,
                                     seed, 8 if family == "iv2" else 16)
        trainer = FinetuneTrainer(step, state, device=dev, crop_size=224,
                                  reprob=0.25, dtype=torch.bfloat16,
                                  seed=seed)
        out = time_steps(trainer, TrainLoader(data, batch, seed=seed),
                         WARMUP_STEPS)
        if profile:
            out["parts"] = step_parts(trainer, data, batch, seed)
            out["profile"] = profile_window(trainer, TrainLoader(
                data, batch, seed=seed,
                nb_samples_per_epoch=PROFILE_STEPS * batch))
        return out

    return largest_fitting((JOB_BATCH, 48, 40, 32), attempt)


def step_parts(trainer, data, batch: int, seed: int) -> dict:
    """Median device ms of the augmentation, the forward + backward and the
    optimizer update over BREAKDOWN_STEPS train steps (CUDA events), and
    the median step ms on the host clock."""
    from simple_tad_tpu_torch.train.engine import TrainLoader
    events = []
    device_batch, opt_step = trainer.device_batch, trainer.state.optimizer.step

    def mark():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events[-1].append(ev)

    def timed_batch(*args):
        events.append([])
        mark()
        out = device_batch(*args)
        mark()
        return out

    def timed_opt():
        mark()
        out = opt_step()
        mark()
        return out

    trainer.device_batch, trainer.state.optimizer.step = timed_batch, timed_opt
    try:
        host = time_steps(trainer, TrainLoader(
            data, batch, seed=seed,
            nb_samples_per_epoch=BREAKDOWN_STEPS * batch), 0)
    finally:
        del trainer.device_batch, trainer.state.optimizer.step
    torch.cuda.synchronize()
    parts = {"augment": [], "forward_backward": [], "optimizer": []}
    for a0, a1, o0, o1 in events:
        parts["augment"].append(a0.elapsed_time(a1))
        parts["forward_backward"].append(a1.elapsed_time(o0))
        parts["optimizer"].append(o0.elapsed_time(o1))
    out = {k: statistics.median(v) for k, v in parts.items()}
    out["step"] = statistics.median(host["step_ms"])
    return out


def distill_models(dev, seed: int):
    """Phase 15's models, of jobs/distill/IV2-S_dist_1B.sh: the IV2-1B
    teacher, seeded on the card, its weights in bf16 (grad free); the IV2-S
    student (distill_internvideo2_small_patch14_224: 6 MLP tap decoders to
    1408, the final decoder to 768, drop path 0.05), seeded fp32 masters
    computed in bf16; both 8 frames at 224 with LayerScale 0.1 (the
    reference goldens' magnitude, as phases 7 and 9, so the trunks move
    the features) -> (student, teacher)."""
    from simple_tad_tpu_torch.models import create_model
    teacher = create_model(
        DISTILL_TEACHER, device=dev, dtype=torch.bfloat16, num_frames=8,
        init_values=0.1,
        generator=torch.Generator(device=dev).manual_seed(seed + 1))
    student = create_model(
        DISTILL_STUDENT, device=dev, dtype=torch.bfloat16,
        param_dtype=torch.float32, num_frames=8, init_values=0.1,
        drop_path_rate=0.05, clip_teacher_embed_dim=teacher.cfg.embed_dim,
        clip_teacher_final_dim=teacher.cfg.clip_embed_dim,
        clip_return_layer=DISTILL_RETURN_LAYERS,
        clip_student_return_interval=1.0, clip_student_decoder="mlp",
        generator=torch.Generator().manual_seed(seed))
    return student, teacher


def distill_state(model, dev, seed: int):
    """The job's AdamW (the reference recipe's betas 0.9 / 0.98, eps 1e-6,
    weight decay 0.05) at its lr scaled to its batch, constant, and the
    generator of the drop-path masks and the attention mask's noise."""
    from simple_tad_tpu_torch.train.optim import FinetuneOptimizer
    from simple_tad_tpu_torch.train.steps import TrainState
    opt = FinetuneOptimizer(dict(model.named_parameters()),
                            lr_schedule=DISTILL_LR, weight_decay=0.05,
                            betas=DISTILL_BETAS, eps=DISTILL_EPS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    return TrainState.create(model, opt, gen)


def distill_taps(teacher):
    from simple_tad_tpu_torch.train.distill import teacher_tap_indices
    return teacher_tap_indices(teacher.cfg.depth, DISTILL_RETURN_LAYERS,
                               DISTILL_T_INTERVAL)


def feature_errors(got, want, lead: int) -> tuple:
    """-> (max over features of ||got - want|| / ||want||, a feature being
    the slab under the ``lead`` leading axes (a tap of one sample, as phase
    14's window feature), the same max over rows of the last axis (one
    token's tap, printed))."""
    got, want = got.float(), want.float()
    diff = (got - want).flatten(lead)
    feat = (diff.norm(dim=-1) / want.flatten(lead).norm(dim=-1)).max()
    rows = ((got - want).norm(dim=-1) / want.norm(dim=-1)).max()
    return feat.item(), rows.item()


def _pow2_scale(t) -> float:
    """The power of two nearest max |t| (1 for zeros): dividing by it is
    exact, in bf16 too."""
    top = t.abs().max().item() if torch.is_tensor(t) else max(
        x.abs().max().item() for x in t)
    return 2.0 ** round(np.log2(top)) if top > 0 else 1.0


def _scaled(out, s: float):
    return tuple(t / s for t in out) if isinstance(out, tuple) else out / s


def distill_step_grads(student, teacher, batch, gen, gen_state):
    """Forward and backward of one distillation step (train/distill.py:
    masked_distill_loss, no update) -> ({name: grad}, loss), the drop-path
    masks drawn from ``gen`` reset to ``gen_state``, the attention mask
    from ``batch['gumbel']``."""
    from simple_tad_tpu_torch.train.distill import masked_distill_loss
    gen.set_state(gen_state)
    for p in student.parameters():
        p.grad = None
    loss, _, _ = masked_distill_loss(
        student, teacher, batch, num_masked=DISTILL_MASKED,
        teacher_taps=distill_taps(teacher), mask_type="attention",
        generator=gen)
    loss.backward()
    grads = {n: p.grad.detach().clone()
             for n, p in student.named_parameters()}
    for p in student.parameters():
        p.grad = None
    return grads, loss.item()


def run_distill(dev, seed: int) -> dict:
    """Phase 15 (i): the checks at batch TRAIN_BATCH -> stats."""
    from simple_tad_tpu_torch.models.mae import mask_partition
    from simple_tad_tpu_torch.ops import flash_attention as fa
    from simple_tad_tpu_torch.train import distill as D
    label = "distill"
    student, teacher = distill_models(dev, seed)
    taps = distill_taps(teacher)
    state = distill_state(student, dev, seed)
    batch = {"video": augmented_batch(dev, TRAIN_BATCH, seed, 8)["video"]}
    N = student.cfg.num_patches
    batch["gumbel"] = D.gumbel_noise((TRAIN_BATCH, N), state.generator, dev)
    print(f"[{label}] teacher {DISTILL_TEACHER} bf16 (depth "
          f"{teacher.cfg.depth}, head dim "
          f"{teacher.cfg.embed_dim // teacher.cfg.num_heads}), taps {taps}; "
          f"student {DISTILL_STUDENT} fp32 masters in bf16, taps "
          f"{student.cfg.return_index}; mask attention {DISTILL_MASK_RATIO}:"
          f" {DISTILL_MASKED} of {N} tokens masked, "
          f"{N + 1 - DISTILL_MASKED} visible with the CLS token; batch "
          f"{TRAIN_BATCH}")

    # the teacher: every A1-sep call against its plain version and control
    t_depth, s_depth = teacher.cfg.depth, student.cfg.depth
    with torch.no_grad():
        reset_counts()
        failures = check_sites(
            lambda: teacher(batch["video"], return_taps=taps),
            {"attention_sep": ("flash_attention", fa.flash_attention,
                               fa.flash_attention_plain,
                               attention_sep_control)},
            f"{label} teacher sites", calls={"attention_sep": t_depth})
        torch.cuda.synchronize()
        t_launches = read_counts()
        # its outputs through the kernels, the plain versions and the gross
        # control (v read with q's row stride)
        outs = {"kernels": teacher(batch["video"], return_taps=taps)}
        with routed(flash_attention=fa.flash_attention_plain):
            outs["plain"] = teacher(batch["video"], return_taps=taps)
        with routed(flash_attention=attention_sep_misread_v):
            outs["gross"] = teacher(batch["video"], return_taps=taps)
    # a feature: one tap of one sample (K, B | N, C), one sample's final
    # feature, one sample's attention over the tokens
    readings = {k: [feature_errors(g, w, lead) for g, w, lead in zip(
        outs[k], outs["plain"], (2, 1, 1))] for k in ("kernels", "gross")}
    errs = {k: [r[0] for r in v] for k, v in readings.items()}
    names = ("taps", "final", "attention")
    print(f"[{label}] teacher outputs vs plain, max over features "
          f"||err|| / ||plain||: " + ", ".join(
              f"{n} {e:.3e} (gross control {c:.3e})" for n, e, c in
              zip(names, errs["kernels"], errs["gross"]))
          + f" (bound {FEATURE_RTOL:.1e}); the taps' worst token "
          f"{readings['kernels'][0][1]:.3e} (gross control "
          f"{readings['gross'][0][1]:.3e}; printed)")
    masks = {k: D.attention_mask_from_importance(outs[k][2], DISTILL_MASKED,
                                                 batch["gumbel"])
             for k in outs}
    # the mask's control: the kernels' teacher with the noise drawn anew,
    # the fault of a step that does not take the noise it is given (the
    # seeded teacher's pooling attention is near uniform, so the gross
    # control's attention moves few positions)
    masks["noise"] = D.attention_mask_from_importance(
        outs["kernels"][2], DISTILL_MASKED,
        D.gumbel_noise(batch["gumbel"].shape, state.generator, dev))
    share = {k: (masks[k] != masks["plain"]).float().mean().item()
             for k in ("kernels", "gross", "noise")}
    print(f"[{label}] attention masks from the same Gumbel noise: "
          f"positions differing from the plain teacher's "
          f"{share['kernels']:.3e}; the gross control's teacher "
          f"{share['gross']:.3e} (printed); control (the noise drawn anew) "
          f"{share['noise']:.3e} (bound {DISTILL_MASK_SHARE:.1e})")
    assert (masks["kernels"].sum(1) == DISTILL_MASKED).all()
    vis, _ = mask_partition(masks["kernels"], DISTILL_MASKED)
    assert vis.shape[1] == DISTILL_N and (vis[:, 0] == 0).all()
    del outs, masks

    # the student's gradients against the plain-version step and the
    # control (no delta term)
    g0 = state.generator.get_state()
    kern, loss_k = distill_step_grads(student, teacher, batch,
                                      state.generator, g0)
    with routed_train(**train_routes("iv2")):
        plain, loss_p = distill_step_grads(student, teacher, batch,
                                           state.generator, g0)
    with routed_train(**train_routes("iv2", no_delta=True)):
        ctrl, _ = distill_step_grads(student, teacher, batch,
                                     state.generator, g0)
    norm_err, param_err, worst = grad_errors(kern, plain)
    c_norm, c_param, c_worst = grad_errors(ctrl, plain)
    del kern, plain, ctrl
    print(f"[{label}] student loss {loss_k:.6f} (plain versions "
          f"{loss_p:.6f}); gradients vs plain: global norm rel err "
          f"{norm_err:.3e} (bound {GRAD_NORM_RTOL:.1e}), worst parameter "
          f"{param_err:.3e} ({worst}; bound {GRAD_PARAM_RTOL:.1e}); "
          f"control (no delta): {c_norm:.3e}, {c_param:.3e} ({c_worst})")

    # one real step: its launches, every C3 and delta call checked
    step = D.make_masked_distill_step(teacher, num_masked=DISTILL_MASKED,
                                      teacher_taps=taps,
                                      mask_type="attention")
    # phase 2's controls; at the step's own inputs (near-uniform
    # probabilities over 411 keys) the backward's subtle one (p not
    # rounded before dV) moves too few gradients for the share bound at
    # most calls, so every call is held to the gross one and some call to
    # the subtle one
    gross = "gross control (v misread)"
    s_sites = {"attention_sep_fwd_lse": (
                   "flash_attention_fwd_lse", fa.flash_attention_fwd_lse,
                   fa.flash_attention_fwd_lse_plain,
                   [("control", attention_sep_fwd_lse_control, "every"),
                    (gross, attention_sep_fwd_lse_misread_v, "every")]),
               "attention_sep_bwd": (
                   "flash_attention_bwd", fa.flash_attention_bwd,
                   fa.flash_attention_bwd_plain,
                   [("control", attention_sep_bwd_control, "any"),
                    (gross, attention_sep_bwd_misread_v, "every")]),
               "attention_delta": (
                   "flash_attention_delta", fa.flash_attention_delta,
                   fa.attention_delta, attention_delta_bf16_products)}
    state.generator.set_state(g0)
    metrics = {}
    reset_counts()
    failures += check_sites(
        lambda: metrics.update(step(state, batch)), s_sites,
        f"{label} student sites", router=routed_train,
        scaled=("attention_sep_bwd", "attention_delta"),
        calls=dict.fromkeys(s_sites, s_depth))
    torch.cuda.synchronize()
    launches = read_counts()
    losses = [float(metrics["loss"])]
    for _ in range(TRAIN_STEPS - 1):
        losses.append(float(step(state, batch)["loss"]))
    drop = 1.0 - losses[-1] / losses[0]
    print(f"[{label}] launches in the teacher's forward {t_launches}")
    print(f"[{label}] launches in one step (teacher forward + student "
          f"step) {launches}")
    print(f"[{label}] {TRAIN_STEPS} steps on one batch at constant lr "
          f"{DISTILL_LR}: losses {' '.join(f'{x:.5f}' for x in losses)}; "
          f"drop {drop:.3f} (required {LOSS_DROP})")
    want_t = dict.fromkeys(COUNTERS, 0)
    # IV2-1B's head dim 88: the wgmma route (96-column tiles); its norms,
    # LayerScale and pooling head are plain PyTorch
    want_t.update(attention_sep=t_depth, fwd_route_wgmma=t_depth)
    want = dict(want_t)
    # IV2-S's head dim 64 at N = 411: the wgmma routes; the decoders'
    # LayerNorms are plain PyTorch too
    want.update(attention_sep_fwd_lse=s_depth, attention_sep_bwd=s_depth,
                attention_delta=s_depth, fwd_route_wgmma=t_depth + s_depth,
                bwd_route_wgmma=s_depth)
    assert not failures, failures
    assert t_launches == want_t, (t_launches, want_t)
    assert launches == want, (launches, want)
    assert max(errs["kernels"]) <= FEATURE_RTOL, errs
    assert min(errs["gross"]) > FEATURE_RTOL, \
        f"the feature bound lets the gross control through: {errs}"
    assert share["kernels"] <= DISTILL_MASK_SHARE < share["noise"], share
    assert norm_err <= GRAD_NORM_RTOL and param_err <= GRAD_PARAM_RTOL, \
        "gradients disagree with the plain-version step"
    assert c_norm > GRAD_NORM_RTOL or c_param > GRAD_PARAM_RTOL, \
        "the gradient bounds let the control through"
    assert np.isfinite(losses).all() and drop >= LOSS_DROP, losses
    return {"launches": launches, "teacher_launches": t_launches,
            "feature_err": errs["kernels"], "mask_share": share["kernels"],
            "grad_norm_err": norm_err, "grad_param_err": param_err,
            "losses": losses}


def time_distill_process(profile: bool, seed: int) -> dict:
    """Phase 15 (iii), in a fresh process: the distillation CLI's trainer
    (cli/distill.py: build_models, build_trainer and DistillTrainer's epoch
    loop on the job's flags, DISTILL_FLAGS: the uint8 clips uploaded,
    train_augment on the card, the teacher's forward, the attention mask,
    the student's step) at DISTILL_BATCH, or the largest of
    DISTILL_BATCHES that fits -> step times and peak memory: DISTILL_STEPS
    steps after DISTILL_WARMUP, or with ``profile`` (the first process)
    DISTILL_STEPS_FIRST steps and a profiler window, in which CUDA events
    time the teacher's forward and the whole step apart."""
    from simple_tad_tpu_torch.cli import distill as cli
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (8, 8, CLIP_H, CLIP_W, 3), np.uint8)
    n_steps = DISTILL_WARMUP + (DISTILL_STEPS_FIRST if profile
                                else DISTILL_STEPS)

    def attempt(batch):
        args = cli.build_parser().parse_args(
            DISTILL_FLAGS + ["--batch_size", str(batch), "--seed", str(seed)])
        student, teacher = cli.build_models(args, dev, torch.bfloat16)
        trainer = cli.build_trainer(args, student, teacher, dev,
                                    torch.bfloat16, n_steps)
        # loader batches (PretrainLoader's keys; its tube masks, which the
        # attention mask ignores, as zeros of their shape), made
        # beforehand: the loader assembles them on worker threads
        batches = [{"video_u8": pool[rng.integers(0, len(pool), batch)],
                    "mask": np.zeros((batch, student.cfg.num_patches), bool)}
                   for _ in range(n_steps)]
        out = time_steps(trainer, batches, DISTILL_WARMUP)
        if not profile:
            return out
        events, step, forward = [], trainer.train_step, teacher.forward

        def timed(fn):
            def run(*a, **kw):
                ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
                ev[0].record()
                res = fn(*a, **kw)
                ev[1].record()
                events.append(ev)
                return res
            return run

        trainer.train_step, teacher.forward = timed(step), timed(forward)
        try:
            out["profile"] = profile_window(trainer,
                                            batches[:PROFILE_STEPS])
        finally:
            trainer.train_step = step
            del teacher.forward
        # per step: the teacher's forward's events, then the step's
        out["profile"].update(
            teacher_ms=[a.elapsed_time(b) for a, b in events[0::2]],
            step_ms=[a.elapsed_time(b) for a, b in events[1::2]])
        return out

    return largest_fitting(DISTILL_BATCHES, attempt)


def probe_setup(dev, seed: int, flags, batch: int, *, depth=None,
                extra=()):
    """A class fine-tuning job's setup through its CLI (cli/class_finetune.
    py: get_args on ``flags``, build_optimizer, which detaches the frozen
    parameters of a probe, and ClassFinetuneTrainer with the soft-target
    step): the model at full width seeded on the card, fp32 masters in
    bf16, LayerScale 0.1 (the reference goldens' magnitude, as phases 7, 9
    and 15, so the trunk moves the features); ``depth`` cuts its depth ->
    (args, trainer)."""
    from simple_tad_tpu_torch.cli import class_finetune as CF
    from simple_tad_tpu_torch.models import create_model
    from simple_tad_tpu_torch.train.steps import (TrainState,
                                                  make_finetune_train_step)
    args = CF.get_args(list(flags) + ["--batch_size", str(batch), "--seed",
                                      str(seed), *extra])
    model = create_model(
        args.model, device=dev, dtype=torch.bfloat16,
        param_dtype=torch.float32, num_classes=args.nb_classes,
        num_frames=args.num_frames, img_size=args.input_size,
        drop_path_rate=args.drop_path, init_values=0.1,
        generator=torch.Generator(device=dev).manual_seed(seed),
        **({} if depth is None else {"depth": depth}))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    state = TrainState.create(model, CF.build_optimizer(args, model, 100),
                              gen)
    return args, CF.ClassFinetuneTrainer(
        make_finetune_train_step(CF.soft_target_criterion), state,
        device=dev, args=args)


def class_host_batch(batch: int, frames: int, classes: int, seed: int,
                     pool=None):
    """A host batch as the CLI's epoch_batches gives it: seeded uint8 clips
    at CLIP_H x CLIP_W (from ``pool`` where given) and labels."""
    rng = np.random.default_rng(seed)
    video = (rng.integers(0, 256, (batch, frames, CLIP_H, CLIP_W, 3),
                          np.uint8) if pool is None
             else pool[rng.integers(0, len(pool), batch)])
    return {"video_u8": video, "label": rng.integers(0, classes, batch)}


def class_batch(trainer, dev, batch: int, seed: int, frames: int) -> dict:
    """One host batch through the trainer's device_batch (the upload and
    train_augment_cls on the card), run under torch.cuda's sync debug mode
    'error', which raises if any draw or op reads the device from the host
    -> the step's batch."""
    host = class_host_batch(batch, frames, trainer.aug["num_classes"], seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    staged = trainer.stage(host)
    trainer.device_batch(staged, gen)          # the constants, made once
    torch.cuda.synchronize()
    gen.manual_seed(seed)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = trainer.device_batch(staged, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    crop = trainer.aug["crop_size"]
    assert out["video"].shape == (batch, frames, crop, crop, 3)
    assert torch.isfinite(out["video"].float()).all()
    sums = out["smoothed"].sum(-1)
    assert torch.allclose(sums, torch.ones_like(sums), atol=1e-5)
    return out


def probe_check(dev, seed: int, flags, batch: int, label: str, *,
                depth=None, open_blocks: int = 0) -> dict:
    """Phase 16 (i) and (iii): one probe step of the CLI's trainer at
    ``batch``.  Its open parameters' gradients and loss against the same
    step through the plain versions (GRAD_NORM_RTOL, GRAD_PARAM_RTOL) and
    the gross control (A1-sep with v misread) outside them; with
    ``open_blocks`` 1 the last block's C3 runs under autograd (its plain
    versions in the plain step, no delta term in the control); then one
    real step with every attention call against the plain version at its
    inputs (the open block's too: fa.flash_attention takes C3 there) and
    the gross control, the subtle one printed: at the step's own inputs,
    near-uniform probabilities over 4097 keys, rounding them to bf16 or
    not moves too few outputs for the share bound (2.5e-2 against 3e-2 on
    the H100; phase 2 holds that control at these shapes on random
    inputs): the launch counts (A1-sep on the frozen blocks, C3 on
    the open one, the route of the head dim), the trunk's output without
    a grad_fn when no block is open, the detached parameters bit-unchanged
    and the classifier moved."""
    from simple_tad_tpu_torch.ops import flash_attention as fa
    args, trainer = probe_setup(dev, seed, flags, batch, depth=depth,
                                extra=["--warmup_epochs", "0",
                                       "--open_block_num", str(open_blocks)])
    state = trainer.state
    model = state.model
    depth, detached = model.cfg.depth, state.optimizer.detached
    head_dim = model.cfg.embed_dim // model.cfg.num_heads
    route = fa.attention_fwd_route(torch.bfloat16, head_dim)
    open_names = sorted(n for n, p in model.named_parameters()
                        if p.requires_grad)
    batch_in = class_batch(trainer, dev, batch, seed, args.num_frames)
    print(f"[{label}] {args.model} (depth {depth}, width "
          f"{model.cfg.embed_dim}, head dim {head_dim}: {route}) bf16, fp32 "
          f"masters, {args.num_frames} frames, batch {batch}, "
          f"open_block_num {open_blocks}"
          f"{', the pooling head open' if args.open_clip_projector else ''}"
          f": {len(open_names)} parameters open, {len(detached)} detached")
    plain_routes = {"flash_attention": fa.flash_attention_plain}
    train_plain = train_routes("iv2") if open_blocks else {}
    train_ctrl = train_routes("iv2", no_delta=True) if open_blocks else {}
    g0 = state.generator.get_state()
    kern, loss_k = step_grads(model, batch_in, state.generator, g0, True)
    with routed(**plain_routes), routed_train(**train_plain):
        plain, loss_p = step_grads(model, batch_in, state.generator, g0,
                                   True)
    with routed(flash_attention=attention_sep_misread_v), \
            routed_train(**train_ctrl):
        ctrl, loss_c = step_grads(model, batch_in, state.generator, g0,
                                  True)
    assert sorted(kern) == open_names, "a detached parameter took a grad"
    norm_err, param_err, worst = grad_errors(kern, plain)
    c_norm, c_param, c_worst = grad_errors(ctrl, plain)
    del kern, plain, ctrl
    print(f"[{label}] loss {loss_k:.6f} (plain versions {loss_p:.6f}, gross "
          f"control {loss_c:.6f}); open parameters' gradients vs plain: "
          f"global norm rel err {norm_err:.3e} (bound {GRAD_NORM_RTOL:.1e}),"
          f" worst parameter {param_err:.3e} ({worst}; bound "
          f"{GRAD_PARAM_RTOL:.1e}); gross control: {c_norm:.3e}, "
          f"{c_param:.3e} ({c_worst})")

    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if n in detached}
    head = model.head.weight.detach().clone()
    grad_fns = []
    hook = model.blocks[-1].register_forward_hook(
        lambda mod, inp, out: grad_fns.append(out.grad_fn))
    state.generator.set_state(g0)
    metrics = {}
    reset_counts()
    try:
        failures = check_sites(
            lambda: metrics.update(trainer.train_step(state, batch_in)[0]),
            {"attention_sep": (
                "flash_attention", fa.flash_attention,
                fa.flash_attention_plain,
                [("control", attention_sep_control, None),
                 ("gross control (v misread)", attention_sep_misread_v,
                  "every")])},
            f"{label} sites", calls={"attention_sep": depth})
        torch.cuda.synchronize()
        launches = read_counts()
    finally:
        hook.remove()
    unchanged = [n for n, p in model.named_parameters()
                 if n in frozen and torch.equal(p, frozen[n])]
    moved = not torch.equal(model.head.weight, head)
    print(f"[{label}] launches in one step {launches}; the last block's "
          f"output grad_fn {type(grad_fns[0]).__name__}; detached "
          f"parameters bit-unchanged {len(unchanged)} of {len(frozen)}; "
          f"classifier moved {moved}; loss {float(metrics['loss']):.6f}")
    want = dict.fromkeys(COUNTERS, 0)
    want.update(attention_sep=depth - open_blocks)
    want[f"fwd_route_{route}"] = depth
    if open_blocks:
        want.update(attention_sep_fwd_lse=open_blocks,
                    attention_sep_bwd=open_blocks,
                    attention_delta=open_blocks)
        want[f"bwd_route_{fa.attention_bwd_route(torch.bfloat16, head_dim)}"] \
            = open_blocks
    assert not failures, failures
    assert launches == want, (launches, want)
    assert (grad_fns[0] is None) == (open_blocks == 0), grad_fns
    assert len(unchanged) == len(frozen) > 0, "a detached parameter moved"
    assert moved and np.isfinite(float(metrics["loss"]))
    assert norm_err <= GRAD_NORM_RTOL and param_err <= GRAD_PARAM_RTOL, \
        f"{label}: gradients disagree with the plain-version step"
    assert c_norm > GRAD_NORM_RTOL or c_param > GRAD_PARAM_RTOL, \
        f"{label}: the gradient bounds let the gross control through"
    return {"launches": launches, "grad_norm_err": norm_err,
            "grad_param_err": param_err}


def time_class_process(profile: bool, seed: int, flags, batch: int,
                       warmup: int, steps: int) -> dict:
    """Phase 16 (ii) and (iv) (iii), in a fresh process: the class
    fine-tuning CLI's trainer on ``flags`` at ``batch`` (host batches of
    seeded clips from memory, made beforehand: the CLI decodes them on the
    host between steps) -> step times, peak memory and, with ``profile``,
    a profiler window with the device ms of each step's upload and
    augmentation (CUDA events)."""
    dev = torch.device("cuda", 0)
    args, trainer = probe_setup(dev, seed, flags, batch)
    pool = np.random.default_rng(seed).integers(
        0, 256, (8, args.num_frames, CLIP_H, CLIP_W, 3), np.uint8)
    batches = [class_host_batch(batch, args.num_frames, args.nb_classes,
                                seed + i, pool)
               for i in range(warmup + steps)]
    out = {"batch": batch, "oom": [], **time_steps(trainer, batches,
                                                   warmup)}
    if not profile:
        return out
    # CUDA events around each step's upload and train_augment_cls
    events, device_batch = [], trainer.device_batch

    def timed_batch(*a):
        ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
        ev[0].record()
        res = device_batch(*a)
        ev[1].record()
        events.append(ev)
        return res

    trainer.device_batch = timed_batch
    try:
        out["profile"] = profile_window(trainer, batches[:PROFILE_STEPS])
    finally:
        del trainer.device_batch
    out["profile"]["augment_ms"] = [a.elapsed_time(b) for a, b in events]
    return out


def run_class_finetune(dev, seed: int) -> dict:
    """Phase 16 (iv) (i)-(ii): IV2-B on CLS_FLAGS through the CLI's trainer
    at TRAIN_BATCH: the batch from train_augment_cls under the sync debug
    mode; the step's gradients against the plain-version step and the
    control (no delta term); one real step's launches (12 C3-fwd, 12
    C3-bwd, 12 delta, on the wgmma routes; nothing else); TRAIN_STEPS
    steps on the batch at CLS_FIT_LR, whose loss must fall by LOSS_DROP."""
    label = "iv2-b class finetune"
    args, trainer = probe_setup(dev, seed, CLS_FLAGS, TRAIN_BATCH,
                                extra=["--warmup_epochs", "0"])
    state = trainer.state
    model = state.model
    depth = model.cfg.depth
    batch = class_batch(trainer, dev, TRAIN_BATCH, seed, args.num_frames)
    g0 = state.generator.get_state()
    kern, loss_k = step_grads(model, batch, state.generator, g0, True)
    with routed_train(**train_routes("iv2")):
        plain, loss_p = step_grads(model, batch, state.generator, g0, True)
    with routed_train(**train_routes("iv2", no_delta=True)):
        ctrl, _ = step_grads(model, batch, state.generator, g0, True)
    norm_err, param_err, worst = grad_errors(kern, plain)
    c_norm, c_param, c_worst = grad_errors(ctrl, plain)
    del kern, plain, ctrl
    print(f"[{label}] {args.model} 8x224 bf16, fp32 masters, batch "
          f"{TRAIN_BATCH}, train_augment_cls under the sync debug mode "
          f"'error' (no host read): loss {loss_k:.6f} (plain versions "
          f"{loss_p:.6f}); gradients vs plain: global norm rel err "
          f"{norm_err:.3e} (bound {GRAD_NORM_RTOL:.1e}), worst parameter "
          f"{param_err:.3e} ({worst}; bound {GRAD_PARAM_RTOL:.1e}); control "
          f"(no delta): {c_norm:.3e}, {c_param:.3e} ({c_worst})")
    state.generator.set_state(g0)
    state.optimizer.lr = lambda step: CLS_FIT_LR
    reset_counts()
    metrics, _ = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    launches = read_counts()
    losses = [float(metrics["loss"])]
    for _ in range(TRAIN_STEPS - 1):
        losses.append(float(trainer.train_step(state, batch)[0]["loss"]))
    drop = 1.0 - losses[-1] / losses[0]
    print(f"[{label}] launches in one train step {launches}")
    print(f"[{label}] {TRAIN_STEPS} steps on one batch at constant lr "
          f"{CLS_FIT_LR}: losses {' '.join(f'{x:.5f}' for x in losses)}; "
          f"drop {drop:.3f} (required {LOSS_DROP})")
    want = dict.fromkeys(COUNTERS, 0)
    want.update(attention_sep_fwd_lse=depth, attention_sep_bwd=depth,
                attention_delta=depth, fwd_route_wgmma=depth,
                bwd_route_wgmma=depth)
    assert launches == want, (launches, want)
    assert norm_err <= GRAD_NORM_RTOL and param_err <= GRAD_PARAM_RTOL, \
        "gradients disagree with the plain-version step"
    assert c_norm > GRAD_NORM_RTOL or c_param > GRAD_PARAM_RTOL, \
        "the gradient bounds let the control through"
    assert np.isfinite(losses).all() and drop >= LOSS_DROP, losses
    return {"launches": launches, "grad_norm_err": norm_err,
            "grad_param_err": param_err, "losses": losses}


def iv2_dapt_model(dev, seed: int):
    """The IV2 DAPT job's model (encoder IV2-S 384 x 12, decoder 192 x 4,
    16 frames at 224, tubelet 1), seeded fp32 masters computed in bf16,
    LayerScale 0.1 (as (i))."""
    from simple_tad_tpu_torch.models import create_model
    return create_model(IV2_DAPT_MODEL, device=dev, dtype=torch.bfloat16,
                        param_dtype=torch.float32, all_frames=16,
                        decoder_depth=4, init_values=0.1,
                        generator=torch.Generator(device=dev).manual_seed(
                            seed))


def run_iv2_dapt(dev, seed: int) -> dict:
    """Phase 16 (v) (i)-(ii): one IV2 DAPT step at batch TRAIN_BATCH (the
    job's pretrain_augment_orig on the card, tube masks at 0.75 over 16 x
    16 x 16 tokens): its gradients against the plain-version step and the
    control (no delta term in either backward), one real step's launches
    (C3 once an encoder block, C1 and C2 once a decoder block, 12 + 4, on
    the wgmma routes; the delta pre-pass 16; LayerNorm 2 x 4 + 1 + 1 = 10
    (the decoder's and the encoder's final norm); nothing else), then
    TRAIN_STEPS steps on the batch at IV2_DAPT_FIT_LR, whose loss must
    fall by LOSS_DROP."""
    from simple_tad_tpu_torch.ops.augment import pretrain_augment_orig
    from simple_tad_tpu_torch.train.steps import make_mae_train_step
    label = "iv2-s dapt"
    model = iv2_dapt_model(dev, seed)
    cfg = model.cfg
    state = mae_state(model, dev, seed, lr=IV2_DAPT_LR)
    rng = np.random.default_rng(seed)
    u8 = torch.from_numpy(rng.integers(
        0, 256, (TRAIN_BATCH, 16, CLIP_H, CLIP_W, 3), np.uint8)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    mask, nm = mae_masks(TRAIN_BATCH, IV2_DAPT_MASK, seed, IV2_DAPT_WINDOW)
    assert mask.shape[1] == cfg.num_patches, (mask.shape, cfg.num_patches)
    batch = {"video": pretrain_augment_orig(u8, gen, crop_size=224,
                                            dtype=torch.bfloat16),
             "mask": torch.from_numpy(mask).to(dev)}
    routes = {**train_routes("vit"), **train_routes("iv2")}
    controls = {**train_routes("vit", no_delta=True),
                **train_routes("iv2", no_delta=True)}
    g0 = state.generator.get_state()
    kern, loss_k = mae_step_grads(model, batch, nm, state.generator, g0)
    with routed_train(**routes):
        plain, loss_p = mae_step_grads(model, batch, nm, state.generator, g0)
    with routed_train(**controls):
        ctrl, _ = mae_step_grads(model, batch, nm, state.generator, g0)
    norm_err, param_err, worst = grad_errors(kern, plain)
    c_norm, c_param, c_worst = grad_errors(ctrl, plain)
    del kern, plain, ctrl
    print(f"[{label}] {IV2_DAPT_MODEL} (encoder {cfg.encoder_embed_dim} x "
          f"{cfg.encoder_depth} on {cfg.num_patches - nm} visible tokens, "
          f"decoder {cfg.decoder_embed_dim} x {cfg.decoder_depth} on "
          f"{cfg.num_patches}, tubelet {cfg.tubelet_size}, head "
          f"{cfg.decoder_num_classes}) bf16, fp32 masters, batch "
          f"{TRAIN_BATCH}: loss {loss_k:.6f} (plain versions {loss_p:.6f}); "
          f"gradients vs plain: global norm rel err {norm_err:.3e} (bound "
          f"{GRAD_NORM_RTOL:.1e}), worst parameter {param_err:.3e} ({worst};"
          f" bound {GRAD_PARAM_RTOL:.1e}); control (no delta): "
          f"{c_norm:.3e}, {c_param:.3e} ({c_worst})")
    step = make_mae_train_step(num_masked=nm)
    state.generator.set_state(g0)
    state.optimizer.lr = lambda step: IV2_DAPT_FIT_LR
    reset_counts()
    metrics = step(state, batch)
    torch.cuda.synchronize()
    launches = read_counts()
    losses = [float(metrics["loss"])]
    for _ in range(TRAIN_STEPS - 1):
        losses.append(float(step(state, batch)["loss"]))
    drop = 1.0 - losses[-1] / losses[0]
    print(f"[{label}] launches in one train step {launches}")
    print(f"[{label}] {TRAIN_STEPS} steps on one batch at constant lr "
          f"{IV2_DAPT_FIT_LR}: losses "
          f"{' '.join(f'{x:.5f}' for x in losses)}; drop {drop:.3f} "
          f"(required {LOSS_DROP})")
    enc, dec = cfg.encoder_depth, cfg.decoder_depth
    want = dict.fromkeys(COUNTERS, 0)
    want.update(attention_sep_fwd_lse=enc, attention_sep_bwd=enc,
                attention_fwd_lse=dec, attention_bwd=dec,
                attention_delta=enc + dec, layernorm=2 * dec + 2,
                fwd_route_wgmma=enc + dec, bwd_route_wgmma=enc + dec)
    assert launches == want, (launches, want)
    assert norm_err <= GRAD_NORM_RTOL and param_err <= GRAD_PARAM_RTOL, \
        "gradients disagree with the plain-version step"
    assert c_norm > GRAD_NORM_RTOL or c_param > GRAD_PARAM_RTOL, \
        "the gradient bounds let the control through"
    assert np.isfinite(losses).all() and drop >= LOSS_DROP, losses
    return {"launches": launches, "grad_norm_err": norm_err,
            "grad_param_err": param_err, "losses": losses}


def time_iv2_dapt_process(profile: bool, seed: int) -> dict:
    """Phase 16 (v) (iii), in a fresh process: the pre-training CLI's
    PretrainTrainer (pretrain_augment_orig, the job's) on the IV2 DAPT
    model at the job's IV2_DAPT_PARTS (the double loop's two parts, each
    pinned while the step before runs) -> step times, peak memory and,
    with ``profile``, a profiler window."""
    from simple_tad_tpu_torch.cli.pretrain import PretrainTrainer
    from simple_tad_tpu_torch.train.steps import make_mae_train_step
    dev = torch.device("cuda", 0)
    model = iv2_dapt_model(dev, seed)
    state = mae_state(model, dev, seed, lr=IV2_DAPT_LR)
    nm = mae_masks(1, IV2_DAPT_MASK, 0, IV2_DAPT_WINDOW)[1]
    trainer = PretrainTrainer(make_mae_train_step(num_masked=nm), state,
                              device=dev, crop_size=224, align=False,
                              dtype=torch.bfloat16, seed=seed)
    batches = list(SyntheticPretrainBatches(
        seed, parts=IV2_DAPT_PARTS, window=IV2_DAPT_WINDOW).epoch(
            MAE_WARMUP + MAE_TIMED))
    out = {"batch": sum(IV2_DAPT_PARTS), "oom": [],
           "note": f" ({' + '.join(map(str, IV2_DAPT_PARTS))}), mask "
                   f"{IV2_DAPT_MASK}",
           **time_steps(trainer, batches, MAE_WARMUP)}
    if profile:
        out["profile"] = profile_window(trainer, batches[:PROFILE_STEPS])
    return out


def run_phase16(dev, seed: int, lap) -> None:
    """Phase 16: InternVideo2 probing (IV2-1B and the depth-cut IV2-6B),
    IV2-B class fine-tuning and IV2-S DAPT, each part failing the run when
    it fails."""
    probe_check(dev, seed, PROBE_FLAGS, PROBE_CHECK_BATCH, "iv2-1b probe")
    torch.cuda.empty_cache()
    probe_check(dev, seed, PROBE_FLAGS, PROBE_CHECK_BATCH,
                "iv2-1b probe open_block_num 1", open_blocks=1)
    torch.cuda.empty_cache()
    lap("phase 16 (i)")
    run_timing("iv2-1b probe", time_class_process,
               (seed, PROBE_FLAGS, PROBE_BATCH, PROBE_WARMUP, PROBE_STEPS),
               PROBE_PROCESSES)
    lap("phase 16 (ii)")
    probe_check(dev, seed, PROBE_6B_FLAGS, PROBE_6B_BATCH,
                f"iv2-6b probe (depth {PROBE_6B_DEPTH})",
                depth=PROBE_6B_DEPTH)
    torch.cuda.empty_cache()
    lap("phase 16 (iii)")
    run_class_finetune(dev, seed)
    torch.cuda.empty_cache()
    run_timing("iv2-b class finetune", time_class_process,
               (seed, CLS_FLAGS, CLS_BATCH, WARMUP_STEPS, TIMED_STEPS), 1)
    lap("phase 16 (iv)")
    run_iv2_dapt(dev, seed)
    torch.cuda.empty_cache()
    run_timing("iv2-s dapt", time_iv2_dapt_process, (seed,), 1)
    lap("phase 16 (v)")


# the counters of the attention kernels (everything but the row norms): a
# checkpointed step launches them as often as the plain step
ATTN_COUNTERS = tuple(n for n in COUNTERS if n.startswith(
    ("attention", "fwd_route", "bwd_route")))


def remat_step(build, loss_of, dev, seed: int, remat: bool) -> dict:
    """One forward and backward (no update) of ``build(remat)`` on the loss
    ``loss_of(model, gen)``, its masks from a generator seeded ``seed`` ->
    loss, {name: grad}, the generator's state after the step and the
    launch counts."""
    model = build(remat)
    model.train()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for p in model.parameters():
        p.grad = None
    reset_counts()
    loss = loss_of(model, gen)
    loss.backward()
    torch.cuda.synchronize()
    counts = read_counts()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    out = {"loss": loss.item(), "grads": grads, "gen": gen.get_state(),
           "counts": counts}
    del model, loss
    torch.cuda.empty_cache()
    return out


def run_remat_check(dev, seed: int) -> dict:
    """Phase 17 (i): the MAE-B DAPT step (mask 0.75), the ViT-B fine-tune
    step with drop path REMAT_DROP_PATH and attention dropout ATTN_DROP in
    both keep forms, and the IV2-S fine-tune step, each with
    ``use_checkpoint`` and without, from the same weights, batch and
    generator state: the gradients within phase 6's bounds (bit-equality
    printed), the generator's state after the step equal, the attention
    kernels launched as often (no second forward attention), and the
    control, a recompute that redraws its masks (the ViT-B case), caught
    by the bounds."""
    from simple_tad_tpu_torch.models import create_model, layers
    from simple_tad_tpu_torch.train.losses import cross_entropy
    from simple_tad_tpu_torch.train.steps import mae_loss
    common = dict(device=dev, dtype=torch.bfloat16,
                  param_dtype=torch.float32)
    vit_batch = augmented_batch(dev, TRAIN_BATCH, seed)
    iv2_batch = augmented_batch(dev, TRAIN_BATCH, seed, 8)
    mae_batch, nm = pretrain_batch(dev, TRAIN_BATCH, seed, MAE_MASKS[0])

    def classify(batch):
        return lambda model, gen: cross_entropy(
            model(batch["video"], generator=gen), batch["label"])

    def vit(form):
        return lambda remat: create_model(
            "vit_base_patch16_224", drop_path_rate=REMAT_DROP_PATH,
            attn_drop_rate=ATTN_DROP, attn_dropout_form=form, remat=remat,
            generator=torch.Generator().manual_seed(seed), **common)
    cases = {
        "dapt mae-b": (lambda remat: create_model(
            "pretrain_videomae_base_patch16_224", decoder_depth=4,
            remat=remat, generator=torch.Generator().manual_seed(seed),
            **common), lambda model, gen: mae_loss(model, mae_batch, nm,
                                                    gen)),
        "vit-b attn rng": (vit("rng"), classify(vit_batch)),
        "vit-b attn mask": (vit("mask"), classify(vit_batch)),
        "iv2-s": (lambda remat: create_model(
            "internvideo2_small_patch14_224", num_frames=8,
            drop_path_rate=REMAT_DROP_PATH, init_values=0.1, remat=remat,
            generator=torch.Generator().manual_seed(seed), **common),
            classify(iv2_batch))}
    out = {}
    for label, (build, loss_of) in cases.items():
        plain = remat_step(build, loss_of, dev, seed + 1, False)
        ckpt = remat_step(build, loss_of, dev, seed + 1, True)
        norm_err, param_err, worst = grad_errors(ckpt["grads"],
                                                 plain["grads"])
        bit_equal = ckpt["loss"] == plain["loss"] and all(
            torch.equal(ckpt["grads"][n], g)
            for n, g in plain["grads"].items())
        attn = {n: (plain["counts"][n], ckpt["counts"][n])
                for n in ATTN_COUNTERS if plain["counts"][n]
                or ckpt["counts"][n]}
        same_gen = torch.equal(ckpt["gen"], plain["gen"])
        print(f"[remat {label}] batch {TRAIN_BATCH}: loss "
              f"{ckpt['loss']:.6f} (without remat {plain['loss']:.6f}); "
              f"gradients vs the step without remat: global norm rel err "
              f"{norm_err:.3e} (bound {GRAD_NORM_RTOL:.1e}), worst "
              f"parameter {param_err:.3e} ({worst}; bound "
              f"{GRAD_PARAM_RTOL:.1e}); bit-equal: {bit_equal}; generator "
              f"state after the step equal: {same_gen}")
        print(f"[remat {label}] attention launches (without, with remat) "
              f"{attn}; LayerNorm {plain['counts']['layernorm']} -> "
              f"{ckpt['counts']['layernorm']} (the recompute runs the "
              f"norms again)")
        assert attn and all(a == b for a, b in attn.values()), attn
        assert same_gen, f"{label}: the generator advanced otherwise"
        assert norm_err <= GRAD_NORM_RTOL and param_err <= GRAD_PARAM_RTOL, \
            f"{label}: remat's gradients disagree with the plain step's"
        if label == "vit-b attn rng":
            with mock.patch.object(layers, "checkpoint_block",
                                   functools.partial(layers.checkpoint_block,
                                                     replay_draws=False)):
                ctrl = remat_step(build, loss_of, dev, seed + 1, True)
            c_norm, c_param, c_worst = grad_errors(ctrl["grads"],
                                                   plain["grads"])
            print(f"[remat {label}] control (the recompute redraws its "
                  f"masks): {c_norm:.3e}, {c_param:.3e} ({c_worst}); "
                  f"generator state equal: "
                  f"{torch.equal(ctrl['gen'], plain['gen'])}")
            assert c_norm > GRAD_NORM_RTOL or c_param > GRAD_PARAM_RTOL, \
                "the gradient bounds let the remat control through"
            del ctrl
        out[label] = {"grad_norm_err": norm_err, "grad_param_err": param_err,
                      "bit_equal": bit_equal, "attention": attn}
        del plain, ckpt
        torch.cuda.empty_cache()
    return out


def time_dapt_job_process(profile: bool, seed: int, remat: bool,
                          parts, update_freq: int) -> dict:
    """Phase 17 (ii), in a fresh process: the DAPT job's step through
    cli/pretrain.py:PretrainTrainer on its flags (MAE-B, decoder depth 4,
    mask 0.75, finetune-aligned augmentation, AdamW betas 0.9 / 0.95), at
    ``parts`` clips a call, ``update_freq`` calls an optimizer update, with
    ``use_checkpoint`` = ``remat`` -> the job step's times (the sum of its
    ``update_freq`` calls), peak memory and, with ``profile``, a profiler
    window of PROFILE_STEPS job steps."""
    from simple_tad_tpu_torch.cli.pretrain import PretrainTrainer
    from simple_tad_tpu_torch.models import create_model
    from simple_tad_tpu_torch.train.optim import FinetuneOptimizer
    from simple_tad_tpu_torch.train.steps import (TrainState,
                                                  make_mae_train_step)
    dev = torch.device("cuda", 0)
    model = create_model("pretrain_videomae_base_patch16_224", device=dev,
                         dtype=torch.bfloat16, param_dtype=torch.float32,
                         decoder_depth=4, remat=remat,
                         generator=torch.Generator().manual_seed(seed))
    opt = FinetuneOptimizer(dict(model.named_parameters()),
                            lr_schedule=MAE_LR, weight_decay=0.05,
                            betas=(0.9, 0.95), update_freq=update_freq)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    state = TrainState.create(model, opt, gen)
    step = make_mae_train_step(num_masked=mae_masks(1, MAE_MASKS[0], 0)[1])
    trainer = PretrainTrainer(step, state, device=dev, crop_size=224,
                              align=True, dtype=torch.bfloat16, seed=seed)
    calls = (DAPT_JOB_WARMUP + DAPT_JOB_TIMED) * update_freq
    # two calls' clips in turn: each call still pins and uploads its own
    pool = list(SyntheticPretrainBatches(seed, parts=parts).epoch(2))
    batches = [pool[i % 2] for i in range(calls)]
    t = time_steps(trainer, batches, DAPT_JOB_WARMUP * update_freq)
    ms = t["step_ms"]
    assert opt.count == calls // update_freq, (opt.count, calls)
    how = (f"use_checkpoint, {' + '.join(map(str, parts))}" if remat else
           f"update_freq {update_freq} x ({' + '.join(map(str, parts))})")
    out = {"batch": sum(parts) * update_freq, "oom": [],
           "note": f" ({how}), mask {MAE_MASKS[0]}",
           "step_ms": [sum(ms[i:i + update_freq])
                       for i in range(0, len(ms), update_freq)],
           "warmup": DAPT_JOB_WARMUP, "peak_gb": t["peak_gb"]}
    if profile:
        out["profile"] = profile_window(
            trainer, batches[:PROFILE_STEPS * update_freq])
    return out


def ddp_world1_process(seed: int, port: int) -> dict:
    """Phase 17 (iii), in a fresh process: DDP_STEPS ViT-B fine-tune steps
    at TRAIN_BATCH through FinetuneTrainer (the job's model, optimizer and
    augmentation) without a process group; then in a one-process NCCL group
    on 127.0.0.1:``port``, through the data-parallel optimizer, plain and
    with zero_stage 1 -> {zero_stage: parameters bit-equal to the steps
    without a group} and the collectives each run called."""
    import torch.distributed as dist
    from simple_tad_tpu_torch.parallel.mesh import DataParallel
    from simple_tad_tpu_torch.train.engine import FinetuneTrainer, TrainLoader
    from simple_tad_tpu_torch.train.losses import create_criterion
    from simple_tad_tpu_torch.train.optim import FinetuneOptimizer
    from simple_tad_tpu_torch.train.steps import (TrainState,
                                                  make_finetune_train_step)
    dev = torch.device("cuda", 0)
    calls = {"all_reduce": 0, "broadcast": 0}

    def counted(name):
        fn = getattr(dist, name)

        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    def train(dp, zero_stage):
        model = job_model(dev, seed)
        opt = FinetuneOptimizer(dict(model.named_parameters()),
                                lr_schedule=TRAIN_LR, weight_decay=0.05,
                                layer_decay=0.6, depth=model.cfg.depth,
                                data_parallel=dp, zero_stage=zero_stage)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1)
        state = TrainState.create(model, opt, gen)
        trainer = FinetuneTrainer(
            make_finetune_train_step(create_criterion("crossentropy")),
            state, device=dev, crop_size=224, reprob=0.25,
            dtype=torch.bfloat16, seed=seed)
        data = SyntheticTrainDataset(DDP_STEPS * TRAIN_BATCH, seed)
        trainer.train_one_epoch(TrainLoader(data, TRAIN_BATCH, seed=seed), 0,
                                print_freq=10 ** 6)
        assert state.step == opt.count == DDP_STEPS
        return {n: p.detach().clone() for n, p in model.named_parameters()}

    want = train(None, 0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        dp = DataParallel(1, 0, dev)
        out = {}
        for zero_stage in (0, 1):
            before = dict(calls)
            with mock.patch.object(dist, "all_reduce",
                                   counted("all_reduce")), \
                    mock.patch.object(dist, "broadcast",
                                      counted("broadcast")):
                got = train(dp, zero_stage)
            out[zero_stage] = {
                "bit_equal": all(torch.equal(got[n], w)
                                 for n, w in want.items()),
                "calls": {k: calls[k] - before[k] for k in calls}}
            del got
        out["backend"] = dist.get_backend()
    finally:
        dist.destroy_process_group()
    return out


def run_ddp_world1(seed: int) -> dict:
    """Phase 17 (iii): ``ddp_world1_process`` in a fresh process on a free
    port, within DDP_TIMEOUT_S; every run's parameters must be bit-equal to
    the steps without a group, and the collectives must have run."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(1) as pool:
        out = pool.apply_async(ddp_world1_process, (seed, port)).get(
            timeout=DDP_TIMEOUT_S)
    for zero_stage in (0, 1):
        r = out[zero_stage]
        print(f"[ddp world 1] {out['backend']} group on 127.0.0.1:{port}, "
              f"zero_stage {zero_stage}: {DDP_STEPS} ViT-B steps at batch "
              f"{TRAIN_BATCH} through FinetuneTrainer; parameters bit-equal "
              f"to the steps without a process group: {r['bit_equal']}; "
              f"collectives {r['calls']}")
        assert out["backend"] == "nccl"
        assert r["bit_equal"], f"zero_stage {zero_stage}: parameters differ"
        assert r["calls"]["all_reduce"] >= DDP_STEPS, r
        assert zero_stage == 0 or r["calls"]["broadcast"] >= DDP_STEPS, r
    return out


def recon_without_std(out, cfg) -> np.ndarray:
    """Phase 18's control: ``out``'s predictions painted back with the
    patch means alone (the un-normalisation without the std)."""
    from simple_tad_tpu_torch.cli import visualize as vis
    p, tb = cfg.patch_size, cfg.tubelet_size
    v = vis.patchify(out["orig"], p, tb)
    rec = v.copy()
    idx = out["mask_idx"]
    rec[idx] = (out["pred"].reshape(len(idx), -1, 3)
                + v.mean(axis=1, keepdims=True)[idx])
    return vis.unpatchify(rec, out["orig"].shape, p, tb)


def run_mae_recon(dev, seed: int) -> dict:
    """Phase 18 (i): jobs/vis.sh's reconstruction core at full width."""
    from simple_tad_tpu_torch.cli import visualize as vis
    from simple_tad_tpu_torch.ops import flash_attention, ln
    model = vis.build_mae_model(
        RECON_MODEL, decoder_depth=RECON_FLAGS["decoder_depth"],
        num_frames=RECON_FLAGS["num_frames"],
        input_size=RECON_FLAGS["input_size"], device=dev, seed=seed)
    cfg = model.cfg
    frames = np.random.default_rng(seed).integers(
        0, 256, (RECON_FLAGS["num_frames"], HEIGHT, WIDTH, 3), np.uint8)
    kw = dict(mask_ratio=RECON_FLAGS["mask_ratio"], seed=RECON_FLAGS["seed"])
    vis.reconstruct(model, frames, **kw)                   # warm-up
    times = []
    for _ in range(RECON_RUNS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        reset_counts()
        out = vis.reconstruct(model, frames, **kw)
        times.append((time.perf_counter() - t0) * 1e3)
        launches = read_counts()
    n_vis = cfg.num_patches - out["mask_idx"].size
    x = torch.randn(1, cfg.all_frames, cfg.img_size, cfg.img_size, 3,
                    device=dev)
    mask = torch.zeros(1, cfg.num_patches, dtype=torch.bool, device=dev)
    mask[0, torch.from_numpy(out["mask_idx"]).to(dev)] = True
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(x, mask, out["mask_idx"].size),
                         runs=5, warmup=1)
    with routed(layernorm=ln.layernorm_plain,
                flash_attention_qkv=flash_attention.flash_attention_qkv_plain):
        plain = vis.reconstruct(model, frames, **kw)
    with routed(flash_attention_qkv=attention_next_head_v):
        misread = vis.reconstruct(model, frames, **kw)
    err = float(np.abs(out["recon"] - plain["recon"]).max())
    controls = {"no std": float(np.abs(recon_without_std(plain, cfg)
                                       - plain["recon"]).max()),
                "next head's v": float(np.abs(misread["recon"]
                                              - plain["recon"]).max())}
    print(f"[mae-recon] {RECON_MODEL} fp32, decoder depth "
          f"{cfg.decoder_depth}, {cfg.all_frames}x{cfg.img_size}, mask "
          f"{RECON_FLAGS['mask_ratio']}: {n_vis} visible / "
          f"{out['mask_idx'].size} masked tokens; reconstruct (host to "
          f"host, resize from {HEIGHT}x{WIDTH} on the host) median "
          f"{statistics.median(times):.2f} ms of {RECON_RUNS} (min "
          f"{min(times):.2f}, max {max(times):.2f}); model forward "
          f"{fwd_ms:.4f} ms (CUDA events, median of 5)")
    print(f"[mae-recon] launches {launches}; recon vs plain versions max "
          f"|err| {err:.3e} (bound {RECON_ATOL:.1e}); controls "
          + ", ".join(f"{k} {v:.3e}" for k, v in controls.items()))
    for name in ("orig", "masked", "recon"):
        assert out[name].shape == (cfg.all_frames, cfg.img_size,
                                   cfg.img_size, 3), name
        assert np.isfinite(out[name]).all(), f"non-finite {name}"
    want = dict.fromkeys(COUNTERS, 0)
    blocks = cfg.encoder_depth + cfg.decoder_depth
    want.update(attention=blocks, fwd_route_fp32=blocks,
                layernorm=2 * blocks + 2)
    assert launches == want, (launches, want)
    assert err <= RECON_ATOL, f"recon disagrees with the plain run: {err}"
    for name, value in controls.items():
        assert value > RECON_ATOL, \
            f"the recon bound lets the control through ({name}: {value})"
    return {"ms": statistics.median(times), "forward_ms": fwd_ms,
            "err": err, "launches": launches}


def run_efficiency(dev, seed: int) -> list:
    """Phase 18 (ii): cli/efficiency.py's benchmark_model on ViT-B bf16;
    every forward's 12 attention calls on A1's wgmma route and 25
    LayerNorm calls, nothing else launched."""
    from simple_tad_tpu_torch.cli import efficiency
    reset_counts()
    rows = efficiency.benchmark_model(
        "vit_base_patch16_224", batches=EFFICIENCY_BATCHES,
        iters=EFFICIENCY_ITERS, dtype=torch.bfloat16, device=dev, seed=seed)
    launches = read_counts()
    forwards = launches["attention"] // 12
    print(f"[efficiency] launches {launches} ({forwards} forwards)")
    want = dict.fromkeys(COUNTERS, 0)
    want.update(attention=12 * forwards, fwd_route_wgmma=12 * forwards,
                layernorm=25 * forwards)
    assert forwards >= 2 * len(EFFICIENCY_BATCHES), launches
    assert launches == want, (launches, want)
    assert [r["batch"] for r in rows] == list(EFFICIENCY_BATCHES)
    for r in rows:
        assert r["latency_ms"] > 0 and r["peak_hbm_mb"], r
    return rows


def run_phase18(dev, seed: int, lap) -> dict:
    """Phase 18: jobs/vis.sh's MAE reconstruction and the efficiency
    harness."""
    out = {"recon": run_mae_recon(dev, seed)}
    torch.cuda.empty_cache()
    out["efficiency"] = run_efficiency(dev, seed)
    lap("phase 18")
    return out


def run_phase17(dev, seed: int, lap) -> dict:
    """Phase 17: gradient checkpointing against the step without it, the
    DAPT job's step on one card with --use_checkpoint and with
    --update_freq 2, and the one-process NCCL group."""
    out = {"remat": run_remat_check(dev, seed)}
    torch.cuda.empty_cache()
    lap("phase 17 (i)")
    out["dapt remat"] = run_timing(
        "dapt job use_checkpoint", time_dapt_job_process,
        (seed, True, DAPT_JOB_PARTS, 1), 1)
    out["dapt update_freq 2"] = run_timing(
        "dapt job update_freq 2", time_dapt_job_process,
        (seed, False, DAPT_ACCUM_PARTS, 2), 1)
    lap("phase 17 (ii)")
    out["ddp"] = run_ddp_world1(seed)
    lap("phase 17 (iii)")
    return out



def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    kind = device_check()
    dev = torch.device("cuda", 0)
    clock = [time.perf_counter()] * 2

    def lap(phase: str) -> None:
        """Print the phase's seconds and the run's so far."""
        now = time.perf_counter()
        print(f"[time] {phase}: {now - clock[1]:.1f} s (run "
              f"{now - clock[0]:.1f} s)")
        clock[1] = now
        torch.cuda.empty_cache()

    build_kernels()
    lap("build")
    kstats = check_kernels(dev, args.seed)
    lap("phase 2")
    model, estats = run_eval(dev, args.seed)
    run_stream(model, dev, args.seed)
    lap("phases 3-4")
    qmodel, qstats = run_eval_int8(model, dev, args.seed, estats["logits"])
    del model
    run_stream(qmodel, dev, args.seed, label="int8 stream")
    del qmodel
    lap("phase 5")
    fstats = run_finetune(dev, args.seed)
    torch.cuda.empty_cache()
    run_timing("finetune", time_training_process, (args.seed,))
    lap("phase 6")
    imodel, istats = run_eval_iv2(dev, args.seed)
    run_stream(imodel, dev, args.seed, label="iv2 stream")
    del imodel
    lap("phase 7")
    i8stats = {fused: run_eval_iv2_int8(dev, args.seed, istats["logits"],
                                        fused)
               for fused in (False, True)}
    lap("phase 8")
    f9stats = run_finetune(dev, args.seed, "iv2")
    torch.cuda.empty_cache()
    run_timing("iv2 finetune", time_training_process, (args.seed, "iv2"))
    lap("phase 9")
    # phase 10: (label, qkv_i8, fused_rmsq, evaluate runs)
    p10 = run_eval_fused(dev, args.seed, "vit",
                         [("vit fused", True, False, EVAL_RUNS),
                          ("vit fused q8", False, False, EVAL_RUNS)],
                         estats["logits"])
    p10.update(run_eval_fused(dev, args.seed, "iv2",
                              [("iv2 fused", True, False, EVAL_RUNS),
                               ("iv2 fused rmsq", True, True, EVAL_RUNS),
                               ("iv2 fused q8", False, False, EVAL_RUNS)],
                              istats["logits"]))
    lap("phase 10")
    # phase 11: ViT-B fine-tuning with attention dropout (C4)
    p11 = run_finetune_dropout(dev, args.seed)
    torch.cuda.empty_cache()
    # one process a form (no job sets attention dropout; the time limit)
    for form in ("rng", "mask"):
        run_timing(f"finetune attn_drop {ATTN_DROP} {form}",
                   time_training_process,
                   (args.seed, "vit", ATTN_DROP, form), 1)
    lap("phase 11")
    # phase 12: the static int8 ViT's opt-in variants (E1, E2)
    p12 = run_eval_variants(dev, args.seed, estats["logits"],
                            qstats["logits"])
    lap("phase 12")
    # phase 13: DAPT pre-training (MAE-B)
    run_pretrain(dev, args.seed)
    torch.cuda.empty_cache()
    # one process: phase 17 (ii) times the job's own 240 + 160 step
    run_timing("dapt", time_pretrain_process, (args.seed,), 1)
    lap("phase 13")
    # phase 14: the MVD-B and UMT-B trunks, evaluation and a fine-tune check
    for family in TRUNKS:
        run_eval_trunk(dev, args.seed, family)
        torch.cuda.empty_cache()
        run_finetune(dev, args.seed, family)
        torch.cuda.empty_cache()
    lap("phase 14")
    # phase 15: IV2-S stage-2 distillation from the IV2-1B teacher
    run_distill(dev, args.seed)
    lap("phase 15 (i)")
    run_timing("distill", time_distill_process, (args.seed,),
               DISTILL_PROCESSES)
    lap("phase 15 (iii)")
    # phase 16: InternVideo2 probing, class fine-tuning and DAPT
    run_phase16(dev, args.seed, lap)
    # phase 17: remat, the DAPT job's step on one card, data parallelism
    run_phase17(dev, args.seed, lap)
    # phase 18: jobs/vis.sh's MAE reconstruction, the efficiency harness
    run_phase18(dev, args.seed, lap)

    launches = {**estats["launches"],
                **{k: qstats["launches"][k]
                   for k in ("layernorm_quant", "attention_i8")},
                **{k: fstats["launches"][k]
                   for k in ("attention_fwd_lse", "attention_bwd",
                             "attention_delta")},
                "attention_sep": istats["launches"]["attention_sep"],
                **{k: i8stats[True]["launches"][k]
                   for k in ("attention_i8_sep", "rmsnorm_quant")},
                **{k: f9stats["launches"][k]
                   for k in ("attention_sep_fwd_lse", "attention_sep_bwd")},
                **{k: p10["vit fused"]["launches"][k]
                   for k in ("int8_gemm", "int8_mlp")},
                "attention_q8": p10["vit fused q8"]["launches"][
                    "attention_q8"],
                "attention_q8_sep": p10["iv2 fused q8"]["launches"][
                    "attention_q8_sep"],
                **{name: p11[form][name]
                   for form, names in DROP_KERNELS.items()
                   for name in names},
                "add_layernorm_quant": p12["add_lnq"]["launches"][
                    "add_layernorm_quant"],
                "attention_int8": p12["int8_attn"]["launches"][
                    "attention_int8"]}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         **{k: kstats[name][k] for k in keys},
         # an exp2-bound attention: operations on the special-function units
         **({"bound_by": "operations", "bound_term": "exp2"}
            if kstats[name]["bound_by"] == "exp2" else {}),
         **{k: kstats[name][k] for k in ("cases",) if k in kstats[name]}}
        for name, (src, rep) in SOURCES.items()]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
