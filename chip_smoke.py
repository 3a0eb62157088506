#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's serving path and train step once on an
NVIDIA GPU.

    python3 chip_smoke.py            # phases 1-19 below
    python3 chip_smoke.py --quality  # phases 1-2 and 18 alone
    python3 chip_smoke.py --steps    # phases 1-2 and 19 alone
    python3 chip_smoke.py --sweep    # phases 1-2, then the sampler's cluster / tile sweep

Run from the root of a checkout, on a machine with one CUDA card, nvcc and
PyTorch built for CUDA. Phases (each prints one line or a few):

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN;
2. build: one nvcc per source, all at once, builds every
   ``mlx_vae_tpu_torch/csrc/*.cu`` (sm_90a): the sampler, the step-major
   sampler, the fused encoder, the fused training decoder, the sequence
   LSTM and the gate pair; the
   build fails if ptxas serialized a ``wgmma`` chain (warning C7515);
3. kernel vs plain: both fused sampler kernels, the tensor-core
   ``gen_tc_kernel`` (the default model's route) and the CUDA-core
   ``fused_generate_kernel`` (forced), against their plain PyTorch version
   on the card at the default model width (V=80, E=128, H=256, latent 128,
   1 condition, 2 layers), at every serving tier B = 256, 2048, 8192, L=64,
   f32 and bf16, greedy, stochastic (T=0.8) and truncated (top-k=6 /
   top-p=0.8, T=0.8): tokens agree on >= 99.0% of first tokens and >= 97.0%
   of rows; the first step's scaled logits agree within 1e-4 (f32) / 1e-2
   (bf16) absolute; truncated first tokens lie in the plain version's kept
   set; rows emit only pad after EOS; moving seed blocks to other batch
   positions, or running a block alone at B=256, leaves their tokens
   bitwise unchanged; one B=2048 launch laid out as a coalesced serving
   pass (six request blocks at T=0.5/0.8/1.2 with their own seeds and
   conditions, two padding blocks) gives each request block the tokens of
   its own B=256 launch, bit for bit;
4. the slice: a random-init checkpoint is served by the port's HTTP server
   (tiers 256,2048,8192, max_length 64, f32; background warm-up, waited
   for and free of errors before the counters are reset) and answers
   health, stochastic, repeated-seed, greedy, multi-pass and malformed
   requests; the sampler launch counters, reset just before, must show
   tensor-core launches and no CUDA-core one, and /health names the fused
   sampler and its coalescing; the greedy response agrees with the plain
   version on the same block streams and h0. A V=600 checkpoint, which the
   sampler kernels refuse, is then served through the scan sampler (as the
   JAX server serves it, tiers 256,2048): /health says "scan", same-seed
   requests repeat, no sampler launch; ten greedy jobs coalesced into one
   2048-row pass are held against each alone (the share of equal rows is
   printed; the server may coalesce scan greedy only if they hold bit for
   bit), and ten concurrent greedy
   requests equal their serial reruns. An H=48 checkpoint, which the
   tensor-core kernel refuses, is served through the CUDA-core kernel
   (routed by config, before any launch);
5. times: the tensor-core and CUDA-core sampler kernels in turns, in mols/s,
   at B = 256, 2048, 8192 (L=64, T=0.8, f32 and bf16), and the plain version
   (every f32 tier, bf16 at B=8192), CUDA events after a warm-up; one B=8192
   f32 pass under ``torch.profiler`` (kernel name and device time);
6. train kernels vs plain: the fused encoder's and the fused training
   decoder's forward and backward kernels (both decoder specializations:
   CE and logits) against their plain PyTorch versions at the default
   model, L=64, B=4096, 2053, 2052, 1000, 64 and 34 (the bench batch, phase
   12's eval batches, a ragged one, its monitor batch and its trailing
   train batch), f32 and bf16; each backward kernel gets
   the plain forward's residuals, as its plain twin does. Teacher forcing
   all on: every output and gradient leaf within max |kernel - plain| /
   max |plain| <= 1e-4 (f32; the two sum in different orders) or 2e-2
   (bf16; one ulp of a bf16 rounding is ~4e-3 of the value). In both
   dtypes the encoder forward (the tensor-core step kernel, layer by layer:
   bf16 wgmma, f32 split-TF32) runs twice and must repeat bit for bit, and
   its backward also runs on the kernel forward's residuals against its
   plain version on the same residuals. The encoder backward's reverse chain
   is also held alone (dgates, dx0) against ``encoder_reverse_reference``,
   and a second backward must equal the first bit for bit, in both dtypes.
   In both dtypes the decoder forward (n*L tensor-core step launches and L
   vocab-head launches: ``seq_fwd_step_kernel`` and ``dec_head_kernel`` in
   bf16, ``seq_fwd_tf32_kernel`` and ``dec_head_tf32_kernel`` as
   split-TF32 in f32) must repeat bit for bit, and each head launch alone,
   on the plain forward's residuals, is held against
   ``decoder_head_step_reference`` (f32: ``split_tf32=True``; CE or logits
   within 1e-4, next tokens on >= 99.0% of rows). The decoder backward's reverse alone (the
   head pass over all L*B rows and the tensor-core chain: bf16 ``wgmma``;
   f32 split-TF32, ``dec_head_bwd_tf32_kernel``, ``dec_dtop_tf32_kernel``,
   ``dec_step_tf32_kernel``) is held against
   ``decoder_reverse_steps_reference`` (f32: ``split_tf32=True``, and also
   the plain f32 reverse; dgates, dx0, dlog, d(h_init), d(cond)); in both
   dtypes a second backward must equal the first bit for bit, the head pass
   alone (targets -1, V and 999 mixed in) is held against
   ``decoder_head_bwd_reference`` (f32: ``split_tf32=True``) within 1e-4,
   and the backward also runs on the kernel forward's residuals. Teacher
   forcing 0.9: the fed-token rows agree on >= 97.0% and the first
   argmax-fed step on >= 99.0% (an argmax can flip where two logits tie).
   Teacher forcing 0 (the eval passes): the logits forward's kernel against
   its plain version fed the kernel's own argmax tokens by full teacher
   forcing (so a flip near a tie does not part the two paths), every output
   within the tolerances above, and the bitwise repeat and head-alone
   checks;
7. the train slice: ``train_step`` at full width (default model, bf16,
   B=4096, L=64, fused route) takes 8 steps on a fixed synthetic batch; the
   losses stay finite, the total loss at step 8 is below step 1, and the
   four train-kernel launch counters, reset just before, have risen. One
   step on the fused route is held against the plain route
   (``use_pallas=False``, the scan path with autograd) on the same params
   and noise, in f32 and bf16: the 9 loss scalars, ``grad_norm`` and the
   post-Adam params;
8. train times: each train kernel against its plain version and, for the
   encoder pair, against cuDNN's two-layer ``torch.nn.LSTM`` at the same
   widths (the yardstick only), and the whole step on the fused route
   against the plain route, at B=4096, L=64, bf16 (CUDA events after a
   warm-up), with tokens/s; each reverse chain's mean step-kernel launch
   per layer (``torch.profiler``); one fused step under ``torch.profiler``:
   device time by kernel name and the device's idle share (against the
   profiled wall time and against the wall time of unprofiled calls, since
   the profiler adds host time to every launch); the bf16 step must
   show the tensor-core forward step kernel (``seq_fwd_step_kernel``) and
   the decoder's vocab head (``dec_head_kernel``) and no CUDA-core forward
   (``seq_fwd_kernel``, ``enc_fwd_kernel``, ``dec_fwd_kernel``), and the
   tensor-core reverse step kernels of the encoder (``enc_step_kernel``)
   and of the decoder (``dec_step_kernel``) and no ``enc_bwd_kernel`` or
   ``dec_bwd_kernel``. Then the f32 pass: rows 2-5 in f32 against their
   plain versions in turns, cuDNN's two-layer f32 LSTM with TF32 off (the
   f32 function: rows 2-3's ``library_ms_f32``) and on (printed only), both
   bounds (split-TF32: 3 x the operations over 495 TFLOP/s; CUDA-core: over
   67 TFLOP/s), rows 4 and 5's device time by kernel (``torch.profiler``:
   row 4's step and head launches; row 5's head pass, dtop, gate, chain
   launches, d(h_init) sum, weight-gradient passes and demb), the train
   kernels' launches in one f32 step, the f32 step on the fused route
   against the plain route, and one f32 fused step under
   ``torch.profiler``, which must show the split-TF32 kernels of rows 2-5
   (``seq_fwd_tf32_kernel``, ``enc_step_tf32_kernel``,
   ``wgrad_tf32_kernel``, ``dec_head_tf32_kernel``,
   ``dec_head_bwd_tf32_kernel``, ``dec_dtop_tf32_kernel``,
   ``dec_step_tf32_kernel``) and none of the CUDA-core kernels deleted
   since (``F32_GONE``, ``dec_bwd_kernel`` among them);
9. scaled kernels vs plain: the per-layer sequence LSTM forward and backward
   (I=128, 129 (the scaled decoder's layer 0) and 1024, H=1024, B=2048,
   L=64, f32 and bf16, each backward also over residuals and inputs
   addressed inside layer-stacked arrays, and a second backward bitwise
   equal to the first; the forward, the tensor-core step kernel in both
   dtypes, also repeated bit for bit and with its input and residuals at
   rows 2t + 1 of layer-stacked arrays, bitwise equal to the dense call), the
   fused training decoder's logits specialization at the scaled model
   (H=1024, 4 layers, B=2048, L=64, f32 and bf16, teacher forcing 1.0 and
   0.9; phase 6's bitwise repeat and head-alone checks in both dtypes) and
   the LSTM gate pair at [4096, 1024], [2048, 4096], [4096, 256], [512,
   256], [256, 256] and [37, 102] (f32), each against its plain version,
   with phase 6's tolerances and agreement floors;
10. the scaled slice: ``train_step`` at hidden 1024 / 4 layers / latent 512,
   bf16, B=2048, L=64, fused route (the per-layer one at this size) for 4
   steps: losses finite, the last below the first, and per step 4
   sequence-forward, 8 sequence-backward and 1 decoder logits-forward
   launches and none of the whole-stack kernels. One scaled step, and one
   default-model ``reference_zero_state`` step (whose decoder scan runs the
   gate kernel pair L*n times each way), are held against the plain route
   in f32 and bf16 as in phase 7;
11. scaled times: each new kernel against its plain version and, for the
   sequence LSTM, against cuDNN's one-layer ``torch.nn.LSTM`` (forward;
   backward alone) and for the gate pair against PyTorch's fused LSTM cell
   (``aten::_thnn_fused_lstm_cell``: the median device time of 200 launches
   of each, in turns, each queued behind a 128 MB write that evicts the L2
   and a spin kernel, so that every input comes from device memory and the
   host's launch time stays outside its events;
   ``mlx_vae_tpu_torch/bench_gates.py:median_ms``; at [4096, 256] and at
   [256, 256], the curve-parity study's batch); the whole-stack kernels at
   the scaled
   shape through their ``launch_*`` functions (the route check); the
   scaled step on the fused route against the plain route, in tokens/s;
   and one scaled fused step under ``torch.profiler`` (as in phase 8, with
   the same check of the forward kernels' names). Then the f32 pass at the
   scaled shape: the sequence forward and backward (I=1024 and 128) and the
   decoder's logits forward against their plain versions in turns, cuDNN's
   one-layer f32 LSTM with TF32 off and on, both bounds, row 6's device
   time by kernel (step and head launches), the launches of one f32 scaled
   step, the warm f32 step (the median of three after it), and one f32
   scaled step under ``torch.profiler``, which must show the split-TF32
   sequence kernels (``seq_fwd_tf32_kernel``, ``seq_step_tf32_kernel``) and
   the decoder's split-TF32 vocab head (``dec_head_tf32_kernel``) and none
   of ``F32_GONE``;
12. the train CLI: the port's ``data.prepare``, ``cli.train`` and
   ``cli.generate`` run in this process (``main(argv)``). A 20,523-molecule
   synthetic corpus (split 16,418 / 2,052 / 2,053: four train batches of
   4096 and one of 34 rows; eval batches of 2052 and 2053 rows; the 64-row
   monitor batch; the native packer must build) trains for two epochs at
   the default model's width, bf16, ``--use_pallas``, with ``--eval_test``:
   the history has 2 finite epochs, ``train_recon`` falls, the epoch and
   best checkpoints exist, and the four train-kernel counters, reset just
   before, rose (printed per epoch). ``--resume --epochs 3`` then runs epoch
   index 2 alone under ``--profile``: its trace must show the tensor-core
   forward, head and reverse step kernels and none of the CUDA-core ones
   (phase 8's check), and gives the device's idle share over the epoch. The
   f32 train CLI on a 3,000-molecule corpus, B=256, one epoch, fused route
   against plain route from the same seed: every history value within
   ``CLI_F32_RTOL`` relative. ``cli.generate --data`` serves the trained
   checkpoint (8192 molecules, L=64) on the tensor-core sampler (its
   counter rose) and prints novelty. A 2,000-molecule drug-like SELFIES
   corpus trains for one bf16 epoch at B=256; its checkpoint carries the
   alphabet, and ``cli.generate`` on it prints validity and molecule-level
   metrics. The f32 fused run must launch all four train kernels (their
   counters reset just before) and the plain run none. Printed: epoch 2's
   train pass per batch beside phase 8's step time, the trainer's
   throughput line, the idle share, and the async checkpoint (the default)
   against ``--sync_checkpoint``: three epochs each with a save every
   epoch, in turns async, sync, sync, async, the wall time from the first
   epoch's start to the last save's end, each train pass, and the main
   thread's seconds in ``save_checkpoint``;
13. the eval CLIs, on phase 12's corpus and best checkpoint: first the
   encoder forward at B = 2 and 5 and the greedy sampler at B = 5 and 9
   (the shapes below that no earlier phase holds: a 2-row encoder grid, a
   partial 64-row sampler tile) against their plain versions, f32 and bf16,
   with phase 6's and phase 3's tolerances. Then, in this process, the
   native post-processor must load, and ``cli.encode --split test
   --batch_size 1024`` (2,053 rows: 1024, 1024 and 5 padded to 1024) runs
   in f32 and in bf16, each held against the same functions on the plain
   route (``use_pallas=False``) on the card: ``mu`` and ``logvar`` within
   phase 6's tolerances, ``active_units`` equal, the TF=1 argmax agreeing
   on >= 99.0% of tokens, the greedy rows from z = mu under the sampler
   contract; the encoder-forward, decoder-logits and tensor-core sampler
   counters, reset just before, must read 3 each after a fused run and 0
   after a plain one. ``cli.interpolate --steps 9``: its endpoints equal
   encode's ``mu`` of those rows, its tokens meet the contract against the
   plain route. A predictor head (seeded) is added to the checkpoint, and
   ``cli.optimize --num_molecules 1024 --opt_steps 300`` runs greedy and at
   T=1.0: the objective falls, every |z| <= 3, the descent's objective
   trajectory equals ``optimize_latent``'s on the CPU from the same z0
   within 1e-4, z's coordinates agree within 1e-4 on no fewer (less 5
   points) than the CPU's own run from z0 plus one ulp leaves (Adam's
   near-sign steps make z chaotic at rounding level), and the sampler
   launches once. Printed: encode's mols/s by
   part (encode, TF=1 decode, greedy decode) on both routes, interpolate's
   wall time, and the descent's seconds and ms a step;
14. serving under concurrent load, default model, f32, tiers
    256,2048,8192, L=64, T=0.8: (a) seconds to a bound server with the
    background warm-up against ``--sync_warmup`` (min of two each, in
    turns); (b) ``_run_coalesced`` on 16 jobs of 200 molecules at mixed
    temperatures and seeds: each bitwise equal to itself alone, every launch
    tensor-core, one job against the plain version on its block streams
    under the greedy contract's floors; (c) over HTTP, 16 and 64 concurrent
    clients of 200 molecules, then the same requests one at a time:
    aggregate served mols/s (molecules over the wall time from the first
    send to the last response), p50 and max latency, device passes; (d)
    every concurrent response bitwise equal to its serial rerun, and some
    coalesced. One JSON line ``{"serve_concurrent": ...}`` holds the
    numbers (printed, not gated);
15. multi-device, on phases 12 and 13's corpus and checkpoint, ranks started
    by ``parallel/launch.py:spawn``: (a) NCCL, world size 1, on cuda:0:
    ``make_dp_train_step`` at the default model (bf16, B=4096, L=64, fused
    route) equals ``train_step`` on the same params and noise bit for bit.
    (b) Two gloo ranks sharing cuda:0 (NCCL refuses two ranks on one card):
    one DP step at full width, 2048 rows a rank, raises each rank's four
    train-kernel counters, and a DP eval step (TF 0) the two forwards'; the
    post-Adam params are bitwise equal across the ranks and agree with a
    one-process reference (each half's loss and gradients on the card,
    averaged, clipped, Adam) to within 4 ulp, the loss and grad_norm within
    1e-6 relative (the same kernels at the same shapes). ``cli.train
    --data_parallel`` for one bf16 ``--use_pallas`` epoch at B=1024 (512
    rows a rank; 16 train batches, 2 of validation): a finite history,
    one set of checkpoints (rank 0's), which a one-rank ``--resume`` loads.
    ``cli.generate --data_parallel`` (8192 greedy molecules): tensor-core
    sampler launches on each rank and none of the CUDA-core kernel, its rows
    against the one-rank run under the greedy contract (>= 99.0% first
    tokens, >= 97.0% rows; the share of equal rows is printed).
    ``cli.encode --data_parallel`` (each rank's encoder and TF=1 logits
    forward counters rise): ``mu`` and ``logvar`` within phase 6's
    tolerances of the one-rank run. (c) ``--model_parallel 2`` over the two
    ranks, default width, f32, scan route, B=256: 3 steps within 1e-4 of
    the one-rank plain route (loss scalars relative, params absolute); the
    gathered checkpoint has the one-rank layout key for key. (d) The dry
    run (``parallel/dryrun.py``) on four gloo ranks sharing cuda:0: its
    line, and on every rank a launch in each data-parallel part (the tiny
    tier's four train kernels, the scaled tier's sequence-LSTM pair).
    Printed, not gated: the DP step's ms on the two ranks sharing the card
    beside the one-rank step, and the gloo all-reduce of the gradient
    tree's bytes (the cost of the code path on one shared card, not a
    scaling figure). Rows 1-8 of the kernels line gain ``launches_dp``;
16. curve parity and diagnostics: (a) the three diagnostics
    (``mlx_vae_tpu_torch/diagnostics/``) on cuda:0, each exiting 0; (b) the
    curve-parity study's corpus (``studies/elbo_compare.py:build_corpus``,
    45,000 synthetic molecules) and, through the study's ``run``, the first 3
    epochs of its 50-epoch schedule in ``fixed_decoder`` and epoch 1 of
    ``reference_zero_state`` (seed 67, default model, bf16, B=256, fused
    route): each epoch's ELBO lies within the JAX seeds' mean +- 3 sample SD
    at that epoch (``benchmarks/elbo_compare.json``); the launches are
    counted per mode: rows 2-5 in the fixed mode, rows 2-3 and the gate pair
    in the zero-state mode, each backward once a train step (the gate pair's
    n x L a step), none of the other mode's. Printed: each epoch's step time
    at B=256. Rows 2-5 and 9 of the kernels line gain ``launches_curve``;
17. models the whole-stack kernels refuse, routed before any launch as the
   JAX package routes them: (a) one bf16 train step of a V=600 model at the
   default width (B=512, L=64) and of a 9-layer one (B=256), each with
   every launch count set to 0 just before: rows 7 and 8 n times (the
   encoder on the sequence kernels), row 9 L*n times each way (the decoder
   on the scan), no whole-stack kernel; then each model's step against the
   plain route (``use_pallas=False``) on the same params and noise, V=600
   in f32 and bf16, 9 layers in bf16, with phase 7's bounds. (b)
   ``data.prepare --synthetic 2000 --vocab_size 600`` and ``cli.train
   --use_pallas`` for one bf16 epoch at B=256: a finite history, a best
   checkpoint, rows 7-9 launched and no whole-stack kernel. (c)
   ``cli.encode`` on that checkpoint (f32): its notes name the sequence
   kernels and the gate pair and no sampler kernel, the counters show only
   rows 7 and 9's forwards, and its TF=1 argmax agrees with the plain route
   on the card on >= 99.0% of first tokens and >= 97.0% of rows. Rows 7-9
   of the kernels line gain ``launches_refused``, row 9 its times at [256,
   256] (``*_b256``);
18. quality parity, a short version of ``studies/quality_parity.py`` (one
   seed, 67): its synthetic corpus at 4,500 molecules, then
   ``quality_parity.run_seed``: two checkpoints through ``cli.train`` (2
   bf16 epochs at B=1024, ``--steps_per_dispatch 8``, ``--use_pallas``; one
   with ``--use_property_predictor``), ``studies/conditioning_fidelity.py``
   and ``studies/latent_opt_fidelity.py`` at 2048 rows a target (targets 50
   / 90 / 130, T=0.8, 300 descent steps), ``cli.encode --split test`` (bf16)
   and ``cli.generate`` (50,000 molecules at T=0.8 and 8192 greedy rows),
   on the best and on the final-epoch checkpoints, and the conditioning
   study again on the best plain checkpoint with the f32 sampler and the
   scan sampler. Every number it records is finite; every study but the
   scan rerun ran on the fused route through ``tc::gen_tc_kernel``, all
   with their tokens and latents on cuda; the
   train dispatches took more than one step; rows 1-5 were each launched,
   and the CUDA-core sampler never. Printed: each study's MAE by target, the
   encode report, validity and mols/s, the seconds of each part. Rows 1-5 of
   the kernels line gain ``launches_quality``;
19. the step-major sampler (``csrc/fused_generate_steps.cu``: per step n
   launches of the forward step (bf16 ``gen_step_tma_kernel``: a TMA
   producer warpgroup, ``wgmma`` consumers keeping the f32 stage sums, a
   persistent grid; f32 ``seq_fwd_tf32_kernel``) and one sampling
   head, the route of
   every config the tensor-core kernel refuses from ``STEPS_MIN_H`` on):
   (a) the route, taken by config, against the plain version at the
   scaled model (hidden 1024, 4 layers, V=80) in bf16 and f32, H=768 n=2
   bf16, H=256 n=2 V=300 f32 and the smallest H it takes in each dtype, B
   = 256 and 2048, L=64, greedy, T=0.8 and top-k=6 / top-p=0.8, with phase
   3's tolerances and agreement floors (in bf16 with top-k / top-p the row
   floor is the lower of 97.0% and the CUDA-core kernel's agreement on the
   same inputs less 2 points: ``TRUNC_BF16_MARGIN``), a second call equal bit for bit,
   and at B=2048 its seed blocks moved and alone at B=256 bitwise
   unchanged; (b) a random-init scaled bf16 checkpoint served by
   ``cli.serve`` (tiers 256 and 2048; /health names the route, same seed
   same tokens) and sampled twice by ``cli.generate`` (the same tokens),
   with the launch counters set to 0 just before each and read just after:
   step-route calls alone; (c) at the scaled model, B = 256 / 2048 / 8192,
   both dtypes, the step route, the CUDA-core kernel (forced; timed by one
   call where a call takes seconds) and the plain version in turns
   (``bench_sampler_routes.bench``), and one B=8192 bf16 step-route pass
   under ``torch.profiler`` (device ms by kernel; it must show
   ``gen_step_tma_kernel`` and the head, and no other sampler kernel, no
   ``seq_fwd_step_kernel`` and no ``gen_step_kernel``, the bf16 step it replaced);
   then per launch, the bf16 step's device ms at layer 0 and at layers 1-3,
   B = 256 / 2048 / 8192, beside its bound, ``torch.lstm_cell``'s
   bf16 step at I = H = 1024 (the library yardstick) and the L2 read rate
   (``bench_step_launch``); (d) the step route's bf16 digests
   (``digest_steps``: tokens and first-step logits at (a)'s bf16 configs and
   modes, B = 256 and 2048, with their inputs' hashes), printed for a
   comparison with another tree. The kernels line
   gains ``fused_generate_steps`` (with ``step_ms``, ``library_step_ms``,
   ``step_bound``: ``ms`` and the launch plan's modelled ``l2_bytes``, and
   the digests).

``--steps`` runs phases 1-2 and 19 alone and prints the
``fused_generate_steps`` entry as the kernels line.

``--f32_times`` runs phases 1-2, then only phase 8's and phase 11's f32
passes (their profile is printed, not checked for kernel names), and prints
them as one JSON line ``{"f32_times": ...}``.

``--sweep`` times the tensor-core kernel with each cluster size forced and
the CUDA-core kernel with each rows-per-thread instance forced (1, 2, 4, 8)
at B = 256, 1024, 2048, 8192, L=64, T=0.8, f32 and bf16: three repeats of 5
launches each after a warm-up, CUDA events. It is the measurement behind
``ops/fused_decoder.py:tc_cluster_size`` and ``_tile_rows``.

Any failed check raises, so the script exits non-zero before the last line.
The last line is ``{"ok": true, "device": {...}}``; the line before it is
the per-kernel JSON record (each kernel's launches on its main path, its
largest error against the plain version, its time, the plain version's,
the library call's where one computes the same function, and its bound:
the larger of its operations over the card's peak for their type and its
bytes, each input read once and each output written once, over 3.35 TB/s);
rows 2-8 also carry their f32 numbers (``ms_f32``, ``plain_ms_f32``,
``library_ms_f32``, ``bound_ms_f32`` as split-TF32 and
``bound_ms_f32_cuda_core``, ``launches_f32``); rows 4, 5 and 6 also their
device ms by kernel (``device_ms_f32_by_kernel``: rows 4 and 6 the step
launches and the vocab heads, row 5 every kernel of the backward).
Without CUDA the script exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import torch

TRAIN_KERNELS = ("fused_encoder_fwd", "fused_encoder_bwd", "fused_train_decoder_fwd",
                 "fused_train_decoder_bwd")
# max |kernel - plain| / max |plain| per output or gradient leaf
TRAIN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# dec_head_kernel alone against its twin: the same rounded operands, f32 sums
HEAD_TOL = 1e-4
# the bench batch, phase 12's eval batches, a ragged one, phase 12's monitor
# batch and its trailing train batch
TRAIN_BATCHES = (4096, 2053, 2052, 1000, 64, 34)
AGREE_FIRST = 0.99  # share of first tokens that must agree, kernel vs plain
AGREE_ROWS = 0.97   # share of whole rows that must agree
# |kernel - plain| of the first step's scaled logits; in bf16 an f32
# difference of one ulp can move an operand's rounding by one bf16 step
LOGIT_ATOL = {"float32": 1e-4, "bfloat16": 1e-2}
TIERS = (256, 2048, 8192)
# NVIDIA's published H100 SXM peaks (dense): bf16 tensor cores, f32 outside
# the tensor cores, HBM3
PEAK_TF32 = 495e12  # tensor cores, TF32 (dense)
# by route: bf16 on the tensor cores, f32 on CUDA cores, and f32 as
# split-TF32 (three TF32 products for each f32 product, so a third of the rate)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "split_tf32": PEAK_TF32 / 3}
PEAK_BYTES = 3.35e12
SCALED = dict(hidden_dim=1024, num_layers=4, latent_dim=512)
SB, SL = 2048, 64  # the scaled batch and length


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def default_model(dtype: str):
    from mlx_vae_tpu_torch.config import ModelConfig
    from mlx_vae_tpu_torch.models.decoder import init_decoder_params
    from mlx_vae_tpu_torch.utils.tree import params_from_numpy, params_to_numpy

    cfg = ModelConfig(compute_dtype=dtype)
    gen = torch.Generator().manual_seed(1234)
    params = params_from_numpy(params_to_numpy(init_decoder_params(gen, cfg)), "cuda")
    return cfg, params


def inputs(cfg, params, B: int, temperature: float, seed: int):
    from mlx_vae_tpu_torch.models.decoder import hidden_init_row
    from mlx_vae_tpu_torch.ops.fused_decoder import block_rows

    g = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn((B, cfg.latent_dim), generator=g, device="cuda")
    cond = torch.randn((B, cfg.num_conditions), generator=g, device="cuda")
    nb = -(-B // block_rows(B))
    seeds = torch.randint(0, 2**31 - 1, (nb,), generator=g, device="cuda",
                          dtype=torch.int32)
    temps = torch.full((nb,), temperature, device="cuda")
    h0 = hidden_init_row(params, cfg, z, cond).contiguous()
    return h0, cond.contiguous(), seeds, temps


def agreement(a: torch.Tensor, b: torch.Tensor):
    return ((a[:, 0] == b[:, 0]).float().mean().item(),
            (a == b).all(dim=1).float().mean().item())


def check_eos(toks: torch.Tensor, cfg) -> None:
    ended = torch.cumsum((toks == cfg.end_token).int(), dim=1)
    after = torch.zeros_like(ended, dtype=torch.bool)
    after[:, 1:] = ended[:, :-1] > 0
    bad = (after & (toks != cfg.pad_token)).sum().item()
    if bad:
        raise AssertionError(f"{bad} non-pad tokens after EOS")


def phase_kernel_vs_plain() -> dict:
    """Both sampler kernels (the tensor-core route and the CUDA-core kernel,
    forced) against the plain version. Returns {kernel: (largest |kernel -
    plain| first-step logit, largest share of rows that differed)}."""
    from mlx_vae_tpu_torch.ops.fused_decoder import (
        fused_generate, fused_generate_reference, prepare_weights)
    from mlx_vae_tpu_torch.ops.sampling import truncate_logits_bisect

    L = 64
    worst = {"tc": [0.0, 0.0], "cuda_core": [0.0, 0.0]}
    modes = (("greedy", 1.0, {"greedy": True}), ("T=0.8", 0.8, {}),
             ("top_k=6 top_p=0.8", 0.8, {"top_k": 6, "top_p": 0.8}))
    for dtype in ("float32", "bfloat16"):
        cfg, params = default_model(dtype)
        w = prepare_weights(params, cfg, "cuda")
        for B in TIERS:
            for mode, temp, kw in modes:
                h0, cond, seeds, temps = inputs(cfg, params, B, temp, seed=7)
                lp = torch.empty((B, cfg.vocab_size), device="cuda")
                p = fused_generate_reference(w, h0, cond, seeds, temps, L, logits_out=lp, **kw)
                torch.cuda.synchronize()
                for kernel in ("tc", "cuda_core"):
                    lk = torch.empty_like(lp)
                    k = fused_generate(w, h0, cond, seeds, temps, L, logits_out=lk,
                                       kernel=kernel, **kw)
                    torch.cuda.synchronize()
                    first, rows = agreement(k, p)
                    err = (lk - lp).abs().max().item()
                    worst[kernel] = [max(worst[kernel][0], err),
                                     max(worst[kernel][1], 1.0 - rows)]
                    line = (f"  {kernel} {dtype} B={B} {mode}: first tokens {first:.4%}, rows "
                            f"{rows:.4%}, first-step logits max |diff| {err:.3e}")
                    if "top_k" in kw:
                        kept = truncate_logits_bisect(lp, cfg.vocab_size, 6, 0.8) > -0.5e30
                        inside = kept[torch.arange(B, device="cuda"),
                                      k[:, 0].long()].float().mean().item()
                        line += f", first tokens in the plain kept set {inside:.4%}"
                        if inside < 1.0:
                            raise AssertionError("a truncated first token lies outside "
                                                 "the kept set")
                    log(line)
                    if first < AGREE_FIRST or rows < AGREE_ROWS:
                        raise AssertionError(f"{kernel} {dtype} B={B} {mode}: agreement below "
                                             f"{AGREE_FIRST:.0%} / {AGREE_ROWS:.0%}")
                    if not err <= LOGIT_ATOL[dtype]:
                        raise AssertionError(f"{kernel} {dtype} B={B} {mode}: logits differ by "
                                             f"{err} > {LOGIT_ATOL[dtype]}")
                    if not ((k >= 0) & (k < cfg.vocab_size)).all():
                        raise AssertionError("token id out of range")
                    check_eos(k, cfg)
                    if mode == "T=0.8" and B > 256:
                        check_seed_blocks(w, h0, cond, seeds, temps, k, kernel, f"{dtype} B={B}")
        for kernel in ("tc", "cuda_core"):
            check_mixed_blocks(w, params, cfg, kernel, dtype)
    log("  EOS rows emit only pad after EOS: ok")
    return {k: tuple(v) for k, v in worst.items()}


def check_seed_blocks(w, h0, cond, seeds, temps, k, kernel: str, what: str) -> None:
    """Seed blocks keep their tokens bit for bit when moved to other batch
    positions (all reversed) and when run alone at B=256 (its first, middle
    and last block)."""
    from mlx_vae_tpu_torch.ops.fused_decoder import fused_generate

    bb, L = 256, k.shape[1]
    nb = h0.shape[0] // bb
    perm = torch.arange(nb - 1, -1, -1, device="cuda")
    moved = (perm[:, None] * bb + torch.arange(bb, device="cuda")).reshape(-1)
    kp = fused_generate(w, h0[moved].contiguous(), cond[moved].contiguous(),
                        seeds[perm].contiguous(), temps[perm].contiguous(), L, kernel=kernel)
    torch.cuda.synchronize()
    if not torch.equal(kp, k[moved]):
        raise AssertionError(f"{kernel} {what}: seed-block tokens changed with batch position")
    for blk in (0, nb // 2, nb - 1):
        rows = slice(bb * blk, bb * (blk + 1))
        alone = fused_generate(w, h0[rows].contiguous(), cond[rows].contiguous(),
                               seeds[blk:blk + 1].contiguous(), temps[blk:blk + 1].contiguous(),
                               L, kernel=kernel)
        torch.cuda.synchronize()
        if not torch.equal(alone, k[rows]):
            raise AssertionError(f"{kernel} {what}: seed block {blk} alone at B=256 gave other "
                                 f"tokens")
    log(f"  {kernel} {what}: {nb} seed blocks reversed in the batch, and blocks 0, {nb // 2}, "
        f"{nb - 1} alone at B=256 -> tokens bitwise unchanged")


def check_mixed_blocks(w, params, cfg, kernel: str, dtype: str) -> None:
    """One B=2048 launch laid out as a coalesced serving pass: six 256-row
    blocks of requests, each with its own seed, condition and temperature
    (0.5 / 0.8 / 1.2), then two blocks of padding (zero h0 and conditions,
    seed 0, temperature 1.0). Each request block's tokens equal its own
    B=256 launch bit for bit."""
    from mlx_vae_tpu_torch.models.decoder import hidden_init_row
    from mlx_vae_tpu_torch.ops.fused_decoder import fused_generate

    bb, B, L, real = 256, 2048, 64, 6
    g = torch.Generator(device="cuda").manual_seed(21)
    z = torch.randn((B, cfg.latent_dim), generator=g, device="cuda")
    cond = torch.randn((B // bb, cfg.num_conditions), generator=g,
                       device="cuda").repeat_interleave(bb, 0)
    seeds = torch.randint(0, 2**31 - 1, (B // bb,), generator=g, device="cuda",
                          dtype=torch.int32)
    temps = torch.tensor([0.5, 0.8, 1.2, 1.2, 0.8, 0.5, 1.0, 1.0], device="cuda")
    h0 = hidden_init_row(params, cfg, z, cond).contiguous()
    h0[real * bb:] = 0.0
    cond[real * bb:] = 0.0
    seeds[real:] = 0
    k = fused_generate(w, h0, cond, seeds, temps, L, kernel=kernel)
    for blk in range(real):
        rows = slice(bb * blk, bb * (blk + 1))
        alone = fused_generate(w, h0[rows].contiguous(), cond[rows].contiguous(),
                               seeds[blk:blk + 1].contiguous(), temps[blk:blk + 1].contiguous(),
                               L, kernel=kernel)
        if not torch.equal(alone, k[rows]):
            raise AssertionError(f"{kernel} {dtype}: request block {blk} (T={temps[blk]:.1f}) of a "
                                 f"mixed B=2048 launch differs from its own B=256 launch")
    log(f"  {kernel} {dtype}: one B=2048 launch of {real} request blocks (T=0.5/0.8/1.2, own "
        f"seeds and conditions) and 2 padding blocks -> each request block bitwise equal to "
        f"its own B=256 launch")


def post(base, payload, path="/generate"):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def start_server(argv: list):
    """``cli.serve``'s server in a thread: ``(ready, thread, base url,
    seconds from start to bound)``."""
    from mlx_vae_tpu_torch.cli.serve import build_parser, serve_forever

    args = build_parser().parse_args(["--port", "0", "--device", "cuda", *argv])
    ready = threading.Event()
    thread = threading.Thread(target=serve_forever, args=(args, ready), daemon=True)
    t0 = time.perf_counter()
    thread.start()
    if not ready.wait(timeout=300):
        raise AssertionError("server did not come up")
    up = time.perf_counter() - t0
    return ready, thread, f"http://127.0.0.1:{ready.server.server_address[1]}", up


def wait_warm(ready) -> dict:
    """Wait for the background warm-up; fail on a warm-up error. Returns
    /health's warmup block."""
    if not ready.service.wait_warm(300):
        raise AssertionError("warm-up did not end")
    warm = ready.service.health()["warmup"]
    if warm["error"] is not None or not warm["complete"]:
        raise AssertionError(f"warm-up failed: {warm}")
    return warm


def stop_server(ready, thread) -> None:
    ready.server.shutdown()
    thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("server thread did not stop")


def reset_sampler_counts() -> None:
    from mlx_vae_tpu_torch.ops.fused_decoder import fused_generate

    fused_generate.launches = fused_generate.tc_launches = fused_generate.core_launches = 0
    fused_generate.step_launches = 0


def phase_slice(tmp: str) -> int:
    """Serve a random-init checkpoint; returns the tensor-core sampler
    launches the requests made (they must make no CUDA-core launch)."""
    import numpy as np

    from mlx_vae_tpu_torch.cli.serve import block_streams
    from mlx_vae_tpu_torch.models.decoder import hidden_init_row
    from mlx_vae_tpu_torch.ops.fused_decoder import fused_generate, fused_generate_reference

    cfg, ck = default_checkpoint(f"{tmp}/checkpoint_best.npz")
    ready, thread, base, up = start_server([
        "--checkpoint", ck, "--batch_sizes", "256,2048,8192", "--max_length", "64"])
    fields = {"num_molecules", "target", "temperature", "greedy", "top_k", "top_p",
              "mols_per_sec", "passes", "coalesced", "validity", "uniqueness",
              "selfies"}
    try:
        t0 = time.perf_counter()
        warm = wait_warm(ready)
        log(f"  server up in {up:.2f}s with the 256-row tier warm; the rest of the ladder "
            f"warm {time.perf_counter() - t0:.2f}s later ({warm['warm_programs']} programs, "
            f"no warm-up error)")
        # count only the main path's launches
        reset_sampler_counts()
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        if (health["status"] != "ok" or health["batch_tiers"] != [256, 2048, 8192]
                or health["sampler"] != "fused" or not health["warmup"]["complete"]
                or health["warmup"]["error"] is not None
                or health["coalescing"] != {"stochastic": True, "greedy": True,
                                            "truncated": {}, "block_rows": 256}):
            raise AssertionError(f"bad /health: {health}")
        log(f"  /health: backend={health['backend']} device={health['device']} "
            f"tiers={health['batch_tiers']} warm={health['warmup']['complete']} "
            f"sampler={health['sampler']} coalescing={health['coalescing']}")
        req = {"num_molecules": 200, "target": [90.0], "temperature": 0.8,
               "seed": 11, "return_tokens": True}
        _, a = post(base, req)
        _, b = post(base, req)
        if a["tokens"] != b["tokens"]:
            raise AssertionError("same seed gave different tokens")
        _, g = post(base, {**req, "greedy": True})
        _, big = post(base, {"num_molecules": 10000, "target": [90.0],
                             "temperature": 0.8, "seed": 5, "max_selfies": 10,
                             "return_tokens": True})
        for name, resp, n in (("stochastic", a, 200), ("greedy", g, 200),
                              ("10000", big, 10000)):
            missing = fields - set(resp)
            if missing:
                raise AssertionError(f"{name} response lacks {sorted(missing)}")
            toks = np.asarray(resp["tokens"])
            if toks.shape != (n, 64) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
                raise AssertionError(f"{name}: bad token matrix {toks.shape}")
            if not (0.0 <= resp["validity"] <= 1.0 and 0.0 < resp["uniqueness"] <= 1.0
                    and np.isfinite(resp["mols_per_sec"])):
                raise AssertionError(f"{name}: bad metrics")
            log(f"  {name}: {resp['mols_per_sec']:.1f} mols/s served, "
                f"{resp['passes']} pass(es), validity {resp['validity']:.4f}, "
                f"uniqueness {resp['uniqueness']:.4f}")
        if big["passes"] < 2:
            raise AssertionError("10000 molecules should take more than one pass")
        try:
            post(base, {"num_molecules": 0})
            raise AssertionError("bad request was accepted")
        except urllib.error.HTTPError as e:
            if e.code != 400:
                raise
        log("  same seed -> identical tokens; malformed request -> 400")
        launches = fused_generate.tc_launches
        if launches < 1 or fused_generate.core_launches or launches != fused_generate.launches:
            raise AssertionError(f"the served requests launched {launches} tensor-core and "
                                 f"{fused_generate.core_launches} CUDA-core sampler kernels: the "
                                 f"default config must take the tensor-core route only")
        log(f"  sampler launches during the requests: {launches} tensor-core "
            f"(gen_tc_kernel), 0 CUDA-core")

        # The greedy response (one 256-row block on the coalesced path)
        # against the plain version on the same block streams and h0.
        service = ready.service
        if g["passes"] != 1 or g["coalesced"]:
            raise AssertionError(f"the greedy request should run alone in one pass: {g['passes']}, "
                                 f"coalesced={g['coalesced']}")
        z, seeds = block_streams(11, 0, 1, service.chunk, cfg.latent_dim, "cuda")
        cond = ((torch.full((service.chunk, 1), 90.0, device="cuda")
                 - torch.as_tensor(service.mean, device="cuda"))
                / torch.as_tensor(service.std, device="cuda")).contiguous()
        h0 = hidden_init_row(service.params["decoder"], cfg, z, cond).contiguous()
        plain = fused_generate_reference(service.weights, h0, cond, seeds,
                                         torch.full((1,), 0.8, device="cuda"),
                                         64, greedy=True)[:200].cpu().numpy()
        served = np.asarray(g["tokens"])
        first = float((plain[:, 0] == served[:, 0]).mean())
        rows = float((plain == served).all(1).mean())
        log(f"  served greedy tokens against the plain version on the same block streams: "
            f"first tokens {first:.4%}, rows {rows:.4%}")
        if first < AGREE_FIRST or rows < AGREE_ROWS:
            raise AssertionError("served greedy tokens disagree with the plain version")
    finally:
        stop_server(ready, thread)
    return launches


def phase_scan_served(tmp: str) -> None:
    """A checkpoint the fused sampler refuses (V = 600) is served on the
    card through the scan sampler, as the JAX server serves it: /health
    names the sampler, requests return tokens and the sampler kernel is not
    launched. Greedy coalescing on this route: ten 200-row greedy jobs in
    one 2048-row pass against each alone in a 256-row pass (the share of
    equal rows is printed); the server may declare greedy coalescing only
    if every row holds bit for bit, and concurrent greedy requests equal
    their serial reruns."""
    import numpy as np

    from mlx_vae_tpu_torch.cli.serve import _Job
    from mlx_vae_tpu_torch.config import ModelConfig
    from mlx_vae_tpu_torch.models.decoder import init_decoder_params
    from mlx_vae_tpu_torch.ops.fused_decoder import fused_generate
    from mlx_vae_tpu_torch.train.checkpoint import build_checkpoint_host, write_checkpoint

    cfg = ModelConfig(vocab_size=600)
    ck = f"{tmp}/checkpoint_v600.npz"
    dec = init_decoder_params(torch.Generator().manual_seed(5), cfg)
    write_checkpoint(ck, build_checkpoint_host(
        0, {"encoder": {}, "decoder": dec}, {"encoder": {}, "decoder": {}}, {}))
    ready, thread, base, _ = start_server([
        "--checkpoint", ck, "--batch_sizes", "256,2048", "--max_length", "64",
        "--no_normalize"])
    try:
        wait_warm(ready)
        before = fused_generate.launches
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        if health["sampler"] != "scan" or health["model"]["vocab_size"] != 600:
            raise AssertionError(f"bad /health for the V=600 model: {health}")
        req = {"num_molecules": 300, "target": [0.0], "temperature": 0.8, "seed": 3,
               "return_tokens": True}
        _, a = post(base, req)
        _, b = post(base, req)
        toks = np.asarray(a["tokens"])
        if toks.shape != (300, 64) or toks.min() < 0 or toks.max() >= 600:
            raise AssertionError(f"V=600: bad token matrix {toks.shape}")
        if a["tokens"] != b["tokens"] or fused_generate.launches != before:
            raise AssertionError("V=600: tokens differ between same-seed requests, or the "
                                 "sampler kernel was launched")
        log(f"  V=600 checkpoint: /health sampler={health['sampler']}; 300 molecules in "
            f"{a['passes']} passes at {a['mols_per_sec']:.1f} mols/s, same seed -> same "
            f"tokens, sampler kernel launches 0")

        svc = ready.service

        def jobs():
            return [_Job(200, True, 1.0, np.asarray([[0.2 * i - 1.0]], np.float32), 100 + i)
                    for i in range(10)]

        solo, co = jobs(), jobs()
        for j in solo:
            svc._run_coalesced([j])
        svc._run_coalesced(co)
        a_, b_ = np.concatenate([j.tokens for j in solo]), np.concatenate([j.tokens for j in co])
        first = float((a_[:, 0] == b_[:, 0]).mean())
        rows = float((a_ == b_).all(1).mean())
        declared = health["coalescing"]["greedy"]
        log(f"  V=600 greedy, 10 x 200 rows in one {co[0].passes}-pass group (2048 rows) against "
            f"each alone ({solo[0].passes} pass of 256): first tokens {first:.4%}, rows "
            f"{rows:.4%} equal; the server coalesces scan greedy: {declared}")
        if declared and rows < 1.0:
            raise AssertionError("V=600 greedy rows change when coalesced, yet the server "
                                 "coalesces them")
        out, before = {}, dict(svc._stats)
        greq = [{"num_molecules": 200, "target": [0.2 * i - 1.0], "greedy": True, "seed": 100 + i,
                 "return_tokens": True} for i in range(10)]

        def hit(i):
            out[i] = post(base, greq[i])[1]["tokens"]

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(10)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        coalesced = svc._stats["coalesced_jobs"] - before["coalesced_jobs"]
        if any(post(base, greq[i])[1]["tokens"] != out.get(i) for i in range(10)):
            raise AssertionError("V=600: a concurrent greedy response differs from its serial rerun")
        if not declared and coalesced:
            raise AssertionError("V=600: greedy jobs were coalesced on the scan route")
        log(f"  V=600: 10 concurrent greedy requests each equal their serial rerun; "
            f"{coalesced} coalesced")
    finally:
        stop_server(ready, thread)


def phase_core_served(tmp: str) -> int:
    """A checkpoint the tensor-core sampler refuses (H = 48: no cluster size
    fits) is served on the card through the CUDA-core kernel, by config
    before any launch. Returns its CUDA-core launches."""
    import numpy as np

    from mlx_vae_tpu_torch.config import ModelConfig
    from mlx_vae_tpu_torch.models.decoder import init_decoder_params
    from mlx_vae_tpu_torch.ops.fused_decoder import fused_generate, fused_generate_route
    from mlx_vae_tpu_torch.train.checkpoint import build_checkpoint_host, write_checkpoint

    cfg = ModelConfig(hidden_dim=48)
    if fused_generate_route(cfg) != "cuda_core":
        raise AssertionError("H=48 should take the CUDA-core sampler")
    ck = f"{tmp}/checkpoint_h48.npz"
    dec = init_decoder_params(torch.Generator().manual_seed(6), cfg)
    write_checkpoint(ck, build_checkpoint_host(
        0, {"encoder": {}, "decoder": dec}, {"encoder": {}, "decoder": {}}, {}))
    ready, thread, base, _ = start_server([
        "--checkpoint", ck, "--batch_sizes", "256", "--max_length", "64", "--no_normalize"])
    try:
        wait_warm(ready)
        reset_sampler_counts()
        req = {"num_molecules": 300, "target": [0.0], "temperature": 0.8, "seed": 4,
               "return_tokens": True}
        _, a = post(base, req)
        _, b = post(base, req)
        toks = np.asarray(a["tokens"])
        if toks.shape != (300, 64) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"H=48: bad token matrix {toks.shape}")
        core = fused_generate.core_launches
        if a["tokens"] != b["tokens"] or core < 1 or fused_generate.tc_launches:
            raise AssertionError(f"H=48: same-seed tokens differ, or the route launched "
                                 f"{core} CUDA-core / {fused_generate.tc_launches} tensor-core "
                                 f"kernels")
        log(f"  H=48 checkpoint: 300 molecules in {a['passes']} passes at "
            f"{a['mols_per_sec']:.1f} mols/s through the CUDA-core sampler ({core} launches, "
            f"0 tensor-core), same seed -> same tokens")
    finally:
        stop_server(ready, thread)
    return core


def default_checkpoint(path: str):
    """A random-init default-model checkpoint (f32) with stats and an
    alphabet, as phase 4 serves it: ``(cfg, path)``."""
    from mlx_vae_tpu_torch.data.prepare import make_synthetic_dataset
    from mlx_vae_tpu_torch.train.checkpoint import build_checkpoint_host, write_checkpoint

    cfg, params = default_model("float32")
    alphabet = make_synthetic_dataset(n=4, vocab_size=cfg.vocab_size)["alphabet"]
    write_checkpoint(path, build_checkpoint_host(
        0, {"encoder": {}, "decoder": params}, {"encoder": {}, "decoder": {}}, {},
        data_stats={"properties_mean": [60.0], "properties_std": [25.0],
                    "alphabet": alphabet}))
    return cfg, path


def burst(base: str, reqs: list, concurrent: bool):
    """Send ``reqs`` all at once (a thread each) or one at a time: the
    responses, each one's latency in s, and the wall time from the first
    send to the last response."""
    out, lat = [None] * len(reqs), [None] * len(reqs)

    def hit(i):
        t = time.perf_counter()
        out[i] = post(base, reqs[i])[1]
        lat[i] = time.perf_counter() - t

    t0 = time.perf_counter()
    if concurrent:
        threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
    else:
        for i in range(len(reqs)):
            hit(i)
    wall = time.perf_counter() - t0
    if any(o is None for o in out):
        raise AssertionError("a request got no response")
    return out, lat, wall


def phase_serve_concurrent(tmp: str, smi: str) -> dict:
    """Phase 14: serving under concurrent load at the default model (f32,
    tiers 256,2048,8192, L=64, T=0.8). Returns the record and the
    tensor-core launches of the concurrent HTTP runs."""
    import numpy as np

    from mlx_vae_tpu_torch.cli.serve import _Job, block_streams
    from mlx_vae_tpu_torch.models.decoder import hidden_init_row
    from mlx_vae_tpu_torch.ops.fused_decoder import fused_generate, fused_generate_reference

    cfg, ck = default_checkpoint(f"{tmp}/checkpoint_serve.npz")
    argv = ["--checkpoint", ck, "--batch_sizes", "256,2048,8192", "--max_length", "64"]
    rec = {"card": smi}
    # (a) seconds to a bound server: background warm-up against --sync_warmup, in turns
    ups = {"background": [], "sync": []}
    for mode in ("background", "sync", "sync", "background"):
        ready, thread, _, up = start_server(argv + (["--sync_warmup"] if mode == "sync" else []))
        t0 = time.perf_counter()
        wait_warm(ready)
        ups[mode].append((up, time.perf_counter() - t0))
        stop_server(ready, thread)
    rec["ready_s"] = {m: min(u for u, _ in v) for m, v in ups.items()}
    rec["background_rest_warm_s"] = min(r for _, r in ups["background"])
    log(f"  (a) ready in {rec['ready_s']['background']:.4f} s with background warm-up (the rest "
        f"of the ladder warm {rec['background_rest_warm_s']:.4f} s later) against "
        f"{rec['ready_s']['sync']:.4f} s with --sync_warmup (min of two each, in turns)")

    ready, thread, base, _ = start_server(argv)
    try:
        wait_warm(ready)
        svc = ready.service
        temps = (0.5, 0.8, 1.2, 1.0)

        def jobs():
            return [_Job(200, False, temps[i % 4],
                         (np.asarray([[60.0 + 5 * i]], np.float32) - svc.mean) / svc.std,
                         1000 + i) for i in range(16)]

        # (b) one group of 16 jobs against each job alone, bit for bit
        reset_sampler_counts()
        solo, co = jobs(), jobs()
        for j in solo:
            svc._run_coalesced([j])
        svc._run_coalesced(co)
        if (fused_generate.tc_launches != len(solo) + co[0].passes
                or fused_generate.core_launches):
            raise AssertionError(f"(b) launched {fused_generate.tc_launches} tensor-core and "
                                 f"{fused_generate.core_launches} CUDA-core sampler kernels")
        for i, (a, b) in enumerate(zip(solo, co)):
            if not np.array_equal(a.tokens, b.tokens):
                raise AssertionError(f"(b) job {i} coalesced differs from the job alone")
        j = co[5]
        z, seeds = block_streams(j.seed, 0, 1, svc.chunk, cfg.latent_dim, "cuda")
        cond = torch.as_tensor(j.target_norm, device="cuda").expand(svc.chunk, 1).contiguous()
        h0 = hidden_init_row(svc.params["decoder"], cfg, z, cond).contiguous()
        plain = fused_generate_reference(svc.weights, h0, cond, seeds,
                                         torch.full((1,), j.temperature, device="cuda"),
                                         64)[:200].cpu().numpy()
        first = float((plain[:, 0] == j.tokens[:, 0]).mean())
        rows = float((plain == j.tokens).all(1).mean())
        log(f"  (b) 16 jobs x 200 molecules (T=0.5/0.8/1.2/1.0, own seeds and targets) in one "
            f"group of {co[0].passes} passes: every job bitwise equal to itself alone (1 pass "
            f"of 256); {fused_generate.tc_launches} launches, all tensor-core; job 5 against "
            f"the plain version on its block streams: first tokens {first:.4%}, rows {rows:.4%}")
        if first < AGREE_FIRST or rows < AGREE_ROWS:
            raise AssertionError("(b) the coalesced job disagrees with the plain version")
        # Why a block's h0 is one product of the block's shape: the share of
        # rows whose h0 bits change when the product spans the pass instead
        x, xc = svc._block_inputs(co)[:2]
        zs = torch.cat([block_streams(j.seed, 0, 1, svc.chunk, cfg.latent_dim, "cuda")[0]
                        for j in co])
        dec = svc.params["decoder"]
        h0_changed = {
            "pass_4096": (hidden_init_row(dec, cfg, zs, xc) != x).any(1).float().mean().item(),
            "rows_8": (hidden_init_row(dec, cfg, zs[:8], xc[:8]) != x[:8]).any(1)
            .float().mean().item()}
        log(f"  (b) h0 rows whose bits change against per-block products: one 4096-row product "
            f"{h0_changed['pass_4096']:.4%}, an 8-row product {h0_changed['rows_8']:.4%}")
        rec["group_of_16"] = {"passes": co[0].passes, "plain_first": first, "plain_rows": rows,
                              "h0_rows_changed": h0_changed}

        # (c), (d) over HTTP: concurrent clients, then the same requests one at a time
        launches = 0
        for n in (16, 64):
            reqs = [{"num_molecules": 200, "target": [60.0 + i % 40], "temperature": 0.8,
                     "seed": 5000 + i, "return_tokens": True} for i in range(n)]
            runs = {}
            for mode in ("concurrent", "serial"):
                before = dict(svc._stats)
                reset_sampler_counts()
                out, lat, wall = burst(base, reqs, mode == "concurrent")
                if fused_generate.core_launches or fused_generate.tc_launches < 1:
                    raise AssertionError(f"(c) {mode}: {fused_generate.tc_launches} tensor-core "
                                         f"and {fused_generate.core_launches} CUDA-core launches")
                if mode == "concurrent":
                    launches += fused_generate.tc_launches
                lat_ms = sorted(1e3 * v for v in lat)
                runs[mode] = {
                    "mols_per_s": 200 * n / wall, "wall_s": wall,
                    "p50_ms": float(np.median(lat_ms)), "max_ms": lat_ms[-1],
                    "device_passes": svc._stats["device_passes"] - before["device_passes"],
                    "coalesced_jobs": svc._stats["coalesced_jobs"] - before["coalesced_jobs"],
                    "tc_launches": fused_generate.tc_launches, "tokens": out}
                log(f"  (c) {n} {mode}: {runs[mode]['mols_per_s']:.1f} mols/s served "
                    f"({200 * n} molecules in {wall:.4f} s), latency p50 "
                    f"{runs[mode]['p50_ms']:.2f} ms, max {runs[mode]['max_ms']:.2f} ms, "
                    f"device_passes {runs[mode]['device_passes']}, coalesced_jobs "
                    f"{runs[mode]['coalesced_jobs']} [{smi}]")
            diff = [i for i in range(n) if runs["concurrent"]["tokens"][i]["tokens"]
                    != runs["serial"]["tokens"][i]["tokens"]]
            if diff:
                raise AssertionError(f"(d) {n} clients: responses {diff[:5]} differ from their "
                                     f"serial reruns")
            if runs["concurrent"]["coalesced_jobs"] < 1:
                raise AssertionError(f"(d) {n} concurrent clients: nothing was coalesced")
            log(f"  (d) {n} clients: every concurrent response bitwise equal to its serial rerun")
            for r in runs.values():
                del r["tokens"]
            rec[f"clients_{n}"] = runs
    finally:
        stop_server(ready, thread)
    print(json.dumps({"serve_concurrent": rec}), flush=True)
    return {"record": rec, "launches": launches}


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


GATE_SAMPLES = 200  # launches of each call behind row 9's median
PROFILE_TRIES = 3  # profiler sessions a profile may take (see profile_step)


def profile_step(what: str, fn, smi: str) -> dict:
    """One call of ``fn`` under ``torch.profiler`` after a warm-up call (the
    profiler's warm-up step): the
    device time of each kernel by name, and the device's idle share (1 -
    the summed device time over the call's wall time on CUDA events; the
    port runs on one stream, so its kernels do not overlap), both against
    the profiled call's wall time and against the mean of three calls
    without the profiler (which adds host time to every launch). A session
    in which CUPTI recorded no device time at all is traced again, up to
    ``PROFILE_TRIES`` sessions in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for attempt in range(1, PROFILE_TRIES + 1):
        # the warm-up call runs as the profiler's warm-up step, traced but
        # not kept: CUPTI can drop the kernels launched as tracing starts
        # (row 5's first ones, its zero fills and head pass, went missing
        # so), and the kept step then finds it running. The step's own range
        # on the device ("ProfilerStep#1") is no kernel.
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
        wall = start.elapsed_time(end)
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not e.name.startswith("ProfilerStep"):
                name = e.name.replace("(anonymous namespace)::", "").split("(")[0][:80]
                by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
        if by_name:
            break
        log(f"  profile, {what}: the profiler recorded no device time (session {attempt} "
            f"of {PROFILE_TRIES}) [{smi}]")
    busy = sum(by_name.values())
    if not by_name:
        return {"wall_ms": wall, "device_ms": None, "idle_share": None, "kernels": {}}
    plain_wall = time_ms(fn, 3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    log(f"  profile, {what}: {wall:.3f} ms wall, {busy:.3f} ms of device time, idle share "
        f"{max(0.0, 1 - busy / wall):.4f}; without the profiler {plain_wall:.3f} ms wall, "
        f"idle share {max(0.0, 1 - busy / plain_wall):.4f} [{smi}]")
    for name, ms in top[:12]:
        log(f"    {ms:10.3f} ms {ms / busy:7.2%}  {name}")
    return {"wall_ms": wall, "device_ms": busy, "idle_share": max(0.0, 1 - busy / wall),
            "plain_wall_ms": plain_wall, "kernels": dict(top)}


def chain_layer_us(fn, kernel: str, n: int) -> list:
    """Mean device us of a reverse chain's step-kernel launches per layer in
    one call of ``fn`` under ``torch.profiler``, after a warm-up call: the
    chain launches top down, so its launch i runs layer n - 1 - i % n."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and re.search(rf"\b{kernel}\b", e.name)), key=lambda e: e.time_range.start)
    us = [[] for _ in range(n)]
    for i, e in enumerate(evs):
        us[n - 1 - i % n].append(e.time_range.elapsed_us())
    return [sum(u) / max(len(u), 1) for u in us]


def check_kernels(prof: dict, what: str, role: str, step: str, old: tuple) -> None:
    """A bf16 step's profile must show the tensor-core kernel ``step`` and
    none of the CUDA-core kernels ``old`` that it replaced."""
    import re

    names = list(prof["kernels"])
    new = [n for n in names if re.search(rf"\b{step}\b", n)]
    gone = [n for n in names if re.search(rf"\b({'|'.join(old)})\b", n)]
    if not new or gone:
        raise AssertionError(f"{what}: {role} kernels in the profile: tensor-core {new}, "
                             f"CUDA-core {gone}")
    log(f"  {what}: the {role} ran as {new[0]} ({prof['kernels'][new[0]]:.3f} ms), no "
        f"{' or '.join(old)}")


def check_forward_kernels(prof: dict, what: str) -> None:
    """A bf16 step's forwards run on the tensor-core step kernel, and the
    decoder's vocab projection on dec_head_kernel: no CUDA-core forward."""
    old = ("seq_fwd_kernel", "enc_fwd_kernel", "dec_fwd_kernel")
    check_kernels(prof, what, "forwards", "seq_fwd_step_kernel", old)
    check_kernels(prof, what, "decoder's vocab head", "dec_head_kernel", old)


def phase_times(smi: str) -> dict:
    """Both sampler kernels in turns (CUDA-core, tensor-core, tensor-core,
    CUDA-core) at every tier, f32 and bf16, L=64, T=0.8, and the plain
    version at B=8192 (and every f32 tier); one B=8192 f32 tensor-core pass
    under torch.profiler. Returns {(dtype, B): (tc ms, CUDA-core ms, plain ms
    or None)} and the profile."""
    from mlx_vae_tpu_torch.ops.fused_decoder import (
        fused_generate, fused_generate_reference, prepare_weights)

    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg, params = default_model(dtype)
        w = prepare_weights(params, cfg, "cuda")
        for B in TIERS:
            h0, cond, seeds, temps = inputs(cfg, params, B, 0.8, seed=3)
            run = lambda kernel: fused_generate(w, h0, cond, seeds, temps, 64,  # noqa: E731
                                                kernel=kernel)
            t_ms, c_ms = turns(f"sampler {dtype} B={B} L=64 T=0.8", lambda: run("tc"),
                               lambda: run("cuda_core"), smi, 10, 10, names=("tensor-core",
                                                                              "CUDA-core"))
            p_ms = None
            if dtype == "float32" or B == 8192:
                p_ms = time_ms(lambda: fused_generate_reference(w, h0, cond, seeds, temps, 64), 3)
            out[(dtype, B)] = (t_ms, c_ms, p_ms)
            log(f"  {dtype} B={B}: tensor-core {B / t_ms * 1e3:,.0f} mols/s, CUDA-core "
                f"{B / c_ms * 1e3:,.0f} mols/s ({c_ms / t_ms:.2f}x)"
                + (f", plain {p_ms:.3f} ms ({B / p_ms * 1e3:,.0f} mols/s)" if p_ms else "")
                + f" [{smi}]")
            if dtype == "float32" and B == 8192:
                out["profile"] = profile_step("one B=8192 f32 sampler pass", lambda: run("tc"),
                                              smi)
                if not any("gen_tc_kernel" in k for k in out["profile"]["kernels"]):
                    raise AssertionError("the profile shows no gen_tc_kernel")
    return out


def phase_sweep(smi: str) -> list:
    """Sampler ms with each tensor-core cluster size and each CUDA-core
    rows-per-thread instance forced."""
    from mlx_vae_tpu_torch.ops.fused_decoder import (fused_generate, prepare_weights,
                                                     tc_cluster_size, tc_clusters)
    from mlx_vae_tpu_torch.ops.train_common import RPTS

    out = []
    for dtype in ("float32", "bfloat16"):
        cfg, params = default_model(dtype)
        w = prepare_weights(params, cfg, "cuda")
        for B in (256, 1024, 2048, 8192):
            h0, cond, seeds, temps = inputs(cfg, params, B, 0.8, seed=3)
            cells = []
            forced = ([("tc", "cluster", S) for S in tc_clusters(cfg)]
                      + [("cuda_core", "rows_per_thread", r) for r in sorted(RPTS)])
            for kernel, arg, v in forced:
                reps = [time_ms(lambda: fused_generate(w, h0, cond, seeds, temps, 64,
                                                       kernel=kernel, **{arg: v}), 5)
                        for _ in range(3)]
                out.append({"dtype": dtype, "B": B, "kernel": kernel, arg: v, "ms": reps})
                cells.append(f"{'S' if kernel == 'tc' else 'R'}={v} {min(reps):.3f}-"
                             f"{max(reps):.3f}")
            log(f"  {dtype} B={B} L=64 T=0.8 ms (3 repeats of 5), tensor-core S (rule: "
                f"{tc_cluster_size(cfg)}) and CUDA-core R: {'; '.join(cells)} [{smi}]")
    return out


SOURCES = ("fused_generate", "fused_generate_steps", "fused_encoder", "fused_train_decoder",
           "fused_seq_lstm", "fused_lstm_gates")


def build_all() -> None:
    """One nvcc per CUDA source, all started together, then load each."""
    from mlx_vae_tpu_torch.ops import (fused_decoder, fused_encoder, fused_lstm,
                                       fused_seq_lstm, fused_train_decoder)
    from mlx_vae_tpu_torch.ops.build import compile_sources

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        compile_sources(SOURCES, verbose=True)
    log(out.getvalue().rstrip())
    if "C7515" in out.getvalue():  # ptxas serialized a wgmma chain
        raise AssertionError("ptxas serialized wgmma (C7515): see the build log above")
    for mod in (fused_decoder, fused_encoder, fused_train_decoder, fused_seq_lstm, fused_lstm):
        mod.build_library()
    fused_decoder.build_steps_library()


TRAIN_SOURCES = {
    "fused_encoder_fwd": "mlx_vae_tpu_torch/csrc/fused_encoder.cu",
    "fused_encoder_bwd": "mlx_vae_tpu_torch/csrc/fused_encoder.cu",
    "fused_train_decoder_fwd": "mlx_vae_tpu_torch/csrc/fused_train_decoder.cu",
    "fused_train_decoder_bwd": "mlx_vae_tpu_torch/csrc/fused_train_decoder.cu",
}
# the decoder forward is two kernels of csrc: the step kernel and the head
DEC_FWD_NOTE = ("; n*L launches of train_common.cuh:seq_fwd_step_kernel (bf16) or "
                "seq_fwd_tf32_kernel (f32, split-TF32) and L of fused_train_decoder.cu:"
                "dec_head_kernel or dec_head_tf32_kernel, also each head launch alone against "
                "decoder_head_step_reference (f32: split_tf32=True), each step's CE term or "
                "logits within 1e-4, with targets outside [0, V); teacher forcing 0: the "
                "logits forward against its plain version fed the kernel's own argmax tokens")
# the bf16 decoder backward: the head pass and the chain's step kernel
DEC_BWD_NOTE = ("; bf16: fused_train_decoder.cu:dec_head_bwd_kernel and dec_dtop_kernel "
                "over all L*B rows, then train_common.cuh:gate_kernel and n*L launches of "
                "fused_train_decoder.cu:dec_step_kernel; f32 the same frame as split-TF32 "
                "(dec_head_bwd_tf32_kernel, dec_dtop_tf32_kernel, gate_kernel<float>, "
                "dec_step_tf32_kernel); also the reverse alone against "
                "decoder_reverse_steps_reference (dgates, dx0, dlog, dh_init, dcond; f32 "
                "split_tf32=True and the plain f32 reverse) and the head pass alone against "
                "decoder_head_bwd_reference within 1e-4, with targets outside [0, V)")
TRAIN_NOTES = {"fused_train_decoder_fwd": DEC_FWD_NOTE, "fused_train_decoder_bwd": DEC_BWD_NOTE}
TRAIN_REPLACES = {
    "fused_encoder_fwd": "mlx_vae_tpu/ops/pallas_encoder.py:119",
    "fused_encoder_bwd": "mlx_vae_tpu/ops/pallas_encoder.py:165",
    "fused_train_decoder_fwd": "mlx_vae_tpu/ops/pallas_train_decoder.py:136",
    "fused_train_decoder_bwd": "mlx_vae_tpu/ops/pallas_train_decoder.py:375",
}


def train_model(dtype: str, seed: int = 0):
    from mlx_vae_tpu_torch.bench import init_train_params
    from mlx_vae_tpu_torch.config import ModelConfig

    cfg = ModelConfig(compute_dtype=dtype, use_pallas=True)
    return cfg, init_train_params(cfg, "cuda", seed)


def train_inputs(cfg, B: int, L: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (B, L), generator=g, device="cuda",
                        dtype=torch.int32)
    cond = torch.randn((B, cfg.num_conditions), generator=g, device="cuda")
    h0 = 0.5 * torch.randn((B, cfg.hidden_dim), generator=g, device="cuda")
    return tok, cond, h0, g


def compare(what: str, got, want, dtype: str, worst: list, tol: float = None) -> None:
    """Hold each leaf of ``got`` against ``want``: max |diff| / max |plain|
    within ``tol`` (default TRAIN_TOL[dtype]); ``worst`` keeps (max abs, max
    rel)."""
    tol = TRAIN_TOL[dtype] if tol is None else tol
    line = []
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{what}: leaf {i} of the kernel is not finite")
        diff = (a - b).abs().max().item()
        rel = diff / max(b.abs().max().item(), 1e-30)
        worst[0], worst[1] = max(worst[0], diff), max(worst[1], rel)
        line.append(f"{rel:.2e}")
        if not rel <= tol:
            raise AssertionError(f"{what}: leaf {i} differs by {diff:.3e} "
                                 f"(rel {rel:.3e} > {tol})")
    log(f"  {what}: max|diff|/max|plain| per leaf [{', '.join(line)}]")


def phase_train_kernels() -> dict:
    """Returns {kernel: (largest abs diff, largest rel diff)} over every run."""
    from mlx_vae_tpu_torch.ops import fused_encoder as fe
    from mlx_vae_tpu_torch.ops import fused_train_decoder as fd
    from mlx_vae_tpu_torch.ops import train_common as tc

    L = 64
    worst = {k: [0.0, 0.0] for k in TRAIN_KERNELS}
    for dtype in ("float32", "bfloat16"):
        cfg, params = train_model(dtype)
        we = tc.prepare_stack_weights(params["encoder"], cfg, with_head=False)
        wd = tc.prepare_stack_weights(params["decoder"], cfg, with_head=True)
        for B in TRAIN_BATCHES:
            tag = f"{dtype} B={B}"
            tok, cond, h0, g = train_inputs(cfg, B, L, seed=B)
            k = fe.encoder_fwd(we, tok)
            p = fe.encoder_fwd_reference(we, tok)
            torch.cuda.synchronize()
            compare(f"{tag} encoder fwd [h_last, hs, cs, gs]", k, p, dtype,
                    worst["fused_encoder_fwd"])
            dh = torch.randn((B, cfg.hidden_dim), generator=g, device="cuda")
            kb = fe.encoder_bwd(we, tok, dh, *p[1:])
            pb = fe.encoder_bwd_reference(we, tok, dh, *p[1:])
            torch.cuda.synchronize()
            compare(f"{tag} encoder bwd [dW.., db, demb]", [*kb[0], *kb[1:]],
                    [*pb[0], *pb[1:]], dtype, worst["fused_encoder_bwd"])
            # the reverse chain alone (the tensor-core chain: bf16 wgmma, f32 split-TF32)
            le, st = fe.build_library(), torch.cuda.current_stream().cuda_stream
            kr = fe.launch_encoder_bwd(le, we, tok, dh, *p[1:], st, with_reverse=True)
            pr = fe.encoder_reverse_reference(we, dh, *p[1:])
            torch.cuda.synchronize()
            compare(f"{tag} encoder reverse alone [dgates, dx0]", kr[3:], pr, dtype,
                    worst["fused_encoder_bwd"])
            # one writer per element, fixed-order sums: both dtypes repeat bit for bit
            again = fe.launch_encoder_bwd(le, we, tok, dh, *p[1:], st, with_reverse=True)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip([*kr[0], *kr[1:]],
                                                         [*again[0], *again[1:]])):
                raise AssertionError(f"{tag} encoder bwd: two runs differ")
            log(f"  {tag} encoder bwd: a second run is bitwise equal (dW, db, demb, "
                f"dgates, dx0)")
            del again, kr, pr
            again = fe.encoder_fwd(we, tok)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(k, again)):
                raise AssertionError(f"{tag} encoder fwd: two runs differ")
            log(f"  {tag} encoder fwd: a second run is bitwise equal")
            # the backward on the tensor-core forward's own residuals
            kb = fe.encoder_bwd(we, tok, dh, *k[1:])
            pb = fe.encoder_bwd_reference(we, tok, dh, *k[1:])
            torch.cuda.synchronize()
            compare(f"{tag} encoder bwd on the kernel forward's residuals", [*kb[0], *kb[1:]],
                    [*pb[0], *pb[1:]], dtype, worst["fused_encoder_bwd"])
            del again
            del k, p, kb, pb
            tf_on = torch.ones((L,), dtype=torch.bool, device="cuda")
            for with_ce in (True, False):
                spec = "ce" if with_ce else "logits"
                k = fd.decoder_fwd(wd, h0, cond, tok, tf_on, with_ce)
                p = fd.decoder_fwd_reference(wd, h0, cond, tok, tf_on, with_ce)
                torch.cuda.synchronize()
                if not torch.equal(k[1], p[1]):
                    raise AssertionError(f"{tag} decoder fwd {spec}: fed tokens differ "
                                         f"under full teacher forcing")
                compare(f"{tag} decoder fwd {spec} [out, hs, cs, gs]", (k[0], *k[2:]),
                        (p[0], *p[2:]), dtype, worst["fused_train_decoder_fwd"])
                check_decoder_chain(wd, h0, cond, tok, tf_on, with_ce, k, p, tag,
                                    worst["fused_train_decoder_fwd"])
                din = (torch.randn((B,), generator=g, device="cuda") if with_ce else
                       torch.randn((B, L, cfg.vocab_size), generator=g, device="cuda") / (B * L))
                kb = fd.decoder_bwd(wd, din, tok, p[1], h0, cond, *p[2:], with_ce)
                pb = fd.decoder_bwd_reference(wd, din, tok, p[1], h0, cond, *p[2:], with_ce)
                torch.cuda.synchronize()
                compare(f"{tag} decoder bwd {spec} [dW.., db, dwout, dbout, demb, "
                        f"dh_init, dcond]", [*kb[0], *kb[1:]], [*pb[0], *pb[1:]], dtype,
                        worst["fused_train_decoder_bwd"])
                del kb, pb
                check_decoder_reverse(wd, din, tok, h0, cond, k, p, with_ce, tag, dtype,
                                      worst["fused_train_decoder_bwd"])
                del k, p
            tf = torch.rand((L,), generator=g, device="cuda") < 0.9
            tf[3] = False  # at least one argmax-fed step
            k = fd.decoder_fwd(wd, h0, cond, tok, tf, True)
            p = fd.decoder_fwd_reference(wd, h0, cond, tok, tf, True)
            torch.cuda.synchronize()
            check_fed_tokens(f"{tag} decoder fwd ce, teacher forcing 0.9", k, p, tf)
            check_decoder_chain(wd, h0, cond, tok, tf, True, k, p, tag,
                                worst["fused_train_decoder_fwd"])
            del k, p
            # teacher forcing 0, as in the eval passes: the plain version is fed
            # the kernel's own argmax tokens by full teacher forcing
            tf_off = torch.zeros((L,), dtype=torch.bool, device="cuda")
            k = fd.decoder_fwd(wd, h0, cond, tok, tf_off, False)
            fed = torch.cat([k[1][1:], tok.T[-1:]]).T.contiguous()  # fed[:, t] = k[1][t + 1]
            p = fd.decoder_fwd_reference(wd, h0, cond, fed, tf_on, False)
            torch.cuda.synchronize()
            if not torch.equal(k[1], p[1]):
                raise AssertionError(f"{tag} decoder fwd logits, teacher forcing 0: the plain "
                                     f"version was not fed the kernel's tokens")
            compare(f"{tag} decoder fwd logits, teacher forcing 0, plain fed the kernel's "
                    f"tokens [out, hs, cs, gs]", (k[0], *k[2:]), (p[0], *p[2:]), dtype,
                    worst["fused_train_decoder_fwd"])
            check_decoder_chain(wd, h0, cond, tok, tf_off, False, k, p, tag,
                                worst["fused_train_decoder_fwd"])
            del k, p
    return {k: tuple(v) for k, v in worst.items()}


def check_fed_tokens(what: str, k, p, tf) -> None:
    """Fed tokens after the first argmax-fed step: >= AGREE_FIRST of the
    first such step and >= AGREE_ROWS of rows agree, kernel vs plain."""
    first = int(torch.nonzero(~tf)[0].item())
    first_ok, rows_ok = agreement(k[1].T[:, first + 1:], p[1].T[:, first + 1:])
    log(f"  {what}: fed-token rows agree {rows_ok:.4%}, first argmax-fed step "
        f"(t={first + 1}) {first_ok:.4%}")
    if first_ok < AGREE_FIRST or rows_ok < AGREE_ROWS:
        raise AssertionError(f"{what}: fed tokens agree below "
                             f"{AGREE_FIRST:.0%} / {AGREE_ROWS:.0%}")


def check_decoder_chain(w, h0, cond, tok, tf, with_ce: bool, k, p, tag: str,
                        worst: list) -> None:
    """The decoder forward's chain (bf16 or f32): a second call equals the
    first ``k`` bit for bit; and each step's vocab head alone
    (``dec_head_kernel``, or ``dec_head_tf32_kernel`` on f32 residuals), on
    the plain forward's residuals ``p``, against ``decoder_head_step_reference``
    on the same inputs (f32: its split-TF32 product). Both read the same
    rounded operands, so each step's CE term (from zero) or logits is held
    within HEAD_TOL; the head alone is fed teacher forcing on even steps
    only, so that forced next tokens must equal the target and argmax-fed
    ones agree on >= AGREE_FIRST of rows a step."""
    from mlx_vae_tpu_torch.ops import fused_train_decoder as fd

    spec = "ce" if with_ce else "logits"
    split = p[2].dtype == torch.float32
    head = "dec_head_tf32_kernel" if split else "dec_head_kernel"
    again = fd.decoder_fwd(w, h0, cond, tok, tf, with_ce)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(k, again)):
        raise AssertionError(f"{tag} decoder fwd {spec}: two runs differ")
    del again
    lib, st = fd.build_library(), torch.cuda.current_stream().cuda_stream
    L = tok.shape[1]
    tf_head = torch.arange(L, device="cuda") % 2 == 0
    tgt = tok.clone()  # with targets outside [0, V), which add no CE term
    for j, bad in enumerate((-1, w.cfg.vocab_size, 999)):
        tgt[j::7, j::3] = bad
    k_out, p_out = torch.zeros_like(p[0]), torch.zeros_like(p[0])
    k_toks, p_toks = p[1].clone(), p[1].clone()
    k_terms, p_terms = [], []
    for t in range(L):
        if with_ce:  # each step's CE term alone
            k_out.zero_()
            p_out.zero_()
        fd.launch_decoder_head(lib, w, t, p[2], tgt, tf_head.to(torch.int32), k_toks, k_out,
                               with_ce, st)
        fd.decoder_head_step_reference(w, t, p[2], tgt, tf_head, p_toks, p_out, with_ce,
                                       split_tf32=split)
        if with_ce:
            k_terms.append(k_out.clone())
            p_terms.append(p_out.clone())
    torch.cuda.synchronize()
    if with_ce:
        k_out, p_out = torch.stack(k_terms), torch.stack(p_terms)
    # toks[t + 1]: forced for even t (odd rows), argmax-fed for odd t (even rows from 2)
    if not torch.equal(k_toks[1::2], p_toks[1::2]):
        raise AssertionError(f"{tag} {head}: a forced next token is not the target")
    agree = (k_toks[2::2] == p_toks[2::2]).float().mean(dim=1).min().item()
    log(f"  {tag} decoder fwd {spec}: a second run is bitwise equal; {head} alone "
        f"at all {L} steps: forced next tokens equal, argmax-fed ones agree on >= "
        f"{agree:.4%} of rows a step")
    compare(f"{tag} {head} alone {spec} [out, each step]", [k_out], [p_out],
            "bfloat16", worst, tol=HEAD_TOL)
    if agree < AGREE_FIRST:
        raise AssertionError(f"{tag} {head}: next tokens agree on {agree:.4%}")


def check_decoder_reverse(w, din, tok, h0, cond, k, p, with_ce: bool, tag: str, dtype: str,
                          worst: list) -> None:
    """The decoder backward's reverse alone (the head pass and the
    tensor-core chain: bf16 ``wgmma``, f32 split-TF32) on the plain forward's
    residuals ``p`` against ``decoder_reverse_steps_reference``, its plain
    twin launch by launch (f32: ``split_tf32=True``, and also the plain f32
    reverse): dgates, dx0, dlog, d(h_init), d(cond). Then, in both dtypes: a
    second backward equals the first bit for bit; the head pass alone, with
    targets -1, V and 999 mixed in, against ``decoder_head_bwd_reference``
    (f32: ``split_tf32=True``) within HEAD_TOL (the same rounded operands,
    f32 sums); and the whole backward on the kernel forward's own residuals
    ``k`` against its plain version on the same residuals."""
    from mlx_vae_tpu_torch.ops import fused_train_decoder as fd

    spec = "ce" if with_ce else "logits"
    split = dtype == "float32"
    lib, st = fd.build_library(), torch.cuda.current_stream().cuda_stream

    def run():
        return fd.launch_decoder_bwd(lib, w, din, tok, p[1], h0, cond, *p[2:], with_ce, st,
                                     with_reverse=True)

    kr = run()
    pr = fd.decoder_reverse_steps_reference(w, din, tok, *p[2:], with_ce, split_tf32=split)
    torch.cuda.synchronize()
    twin = "its split-TF32 twin" if split else "its twin"
    compare(f"{tag} decoder reverse alone {spec} against {twin} [dgates, dx0, dlog, dh_init, "
            f"dcond]", kr[7:], pr, dtype, worst)
    del pr
    if split:
        pr = fd.decoder_reverse_steps_reference(w, din, tok, *p[2:], with_ce)
        torch.cuda.synchronize()
        compare(f"{tag} decoder reverse alone {spec} against the plain f32 reverse [dgates, "
                f"dx0, dlog, dh_init, dcond]", kr[7:], pr, dtype, worst)
        del pr
    again = run()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip([*kr[0], *kr[1:]], [*again[0], *again[1:]])):
        raise AssertionError(f"{tag} decoder bwd {spec}: two runs differ")
    log(f"  {tag} decoder bwd {spec}: a second run is bitwise equal (dW, db, dwout, dbout, "
        f"demb, dh_init, dcond, dgates, dx0, dlog)")
    del kr, again
    tgt = tok.clone()  # with targets outside [0, V), which add no one-hot
    for j, bad in enumerate((-1, w.cfg.vocab_size, 999)):
        tgt[j::7, j::3] = bad
    kh = fd.launch_decoder_head_bwd(lib, w, din, tgt, p[2], with_ce, st)
    ph = fd.decoder_head_bwd_reference(w, din, tgt, p[2], with_ce, split_tf32=split)
    torch.cuda.synchronize()
    compare(f"{tag} decoder head pass alone {spec}, targets -1/V/999 mixed in [dlog, dtop]",
            kh, ph, dtype, worst, tol=HEAD_TOL)
    del kh, ph
    kb = fd.decoder_bwd(w, din, tok, k[1], h0, cond, *k[2:], with_ce)
    pb = fd.decoder_bwd_reference(w, din, tok, k[1], h0, cond, *k[2:], with_ce)
    torch.cuda.synchronize()
    compare(f"{tag} decoder bwd {spec} on the kernel forward's residuals", [*kb[0], *kb[1:]],
            [*pb[0], *pb[1:]], dtype, worst)


def synthetic_batch(cfg, B: int, L: int):
    """Tokens [B, L] (pad 0 after EOS) and normalized TPSA [B, 1] from the
    repo's deterministic synthetic corpus, on the card."""
    import numpy as np

    from mlx_vae_tpu_torch.data.prepare import make_synthetic_dataset

    data = make_synthetic_dataset(n=B, vocab_size=cfg.vocab_size, max_length=L, seed=0)
    x = np.zeros((B, L), np.int32)
    for i, seq in enumerate(data["tokenized_sequences"]):
        x[i, :len(seq)] = seq[:L]
    tpsa = np.array([m["tpsa"] for m in data["molecules"]], np.float32)[:, None]
    cond = (tpsa - tpsa.mean()) / tpsa.std()
    return (torch.as_tensor(x, device="cuda"), torch.as_tensor(cond, device="cuda"))


def train_steps(cfg, params, x, cond, steps: int, counters: dict) -> dict:
    """``steps`` train steps on one batch with every launch count set to 0
    just before; checks that the losses stay finite and fall, and returns
    the counts."""
    import math

    from mlx_vae_tpu_torch.config import TrainConfig
    from mlx_vae_tpu_torch.train.optim import adam_init
    from mlx_vae_tpu_torch.train.steps import train_step

    B = x.shape[0]
    opt = {n: adam_init(p) for n, p in params.items()}
    gen = torch.Generator(device="cuda").manual_seed(2)
    reset_counts(counters)  # count only the main path's launches
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        _, _, m = train_step(params, opt, cfg, TrainConfig(batch_size=B), x, cond, gen, 0.05,
                             0.9)
        losses.append(m["total_loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(counters)
    losses = [float(v) for v in losses]
    log(f"  {steps} steps in {wall:.2f}s; total loss per step "
        f"{', '.join(f'{v:.4f}' for v in losses)}; last recon {float(m['recon_loss']):.4f}, "
        f"grad_norm {float(m['grad_norm']):.4f}")
    log(f"  launches during the {steps} steps: {counts}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("a loss is not finite")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"total loss did not fall: {losses[0]} -> {losses[-1]}")
    return counts


def phase_train_slice() -> dict:
    """Eight full-width bf16 steps through the kernels; returns the launch
    count of each train kernel in that run."""
    B, L = 4096, 64
    cfg, params = train_model("bfloat16")
    x, cond = synthetic_batch(cfg, B, L)
    counters = {k: v for k, v in kernel_counters().items() if k in TRAIN_KERNELS}
    launches = train_steps(cfg, params, x, cond, 8, counters)
    if min(launches.values()) < 1:
        raise AssertionError(f"a train kernel was never launched: {launches}")

    # one step, fused route against the plain route, same params and noise
    fused_vs_plain("default", lambda dt: train_model(dt, seed=3), x, cond, B, L)
    return launches


def phase_train_times(smi: str) -> dict:
    """{kernel: (kernel ms, plain ms)} and the whole step's times."""
    from mlx_vae_tpu_torch.config import TrainConfig
    from mlx_vae_tpu_torch.ops import fused_encoder as fe
    from mlx_vae_tpu_torch.ops import fused_train_decoder as fd
    from mlx_vae_tpu_torch.ops import train_common as tc
    from mlx_vae_tpu_torch.train.optim import adam_init
    from mlx_vae_tpu_torch.train.steps import train_step

    B, L = 4096, 64
    cfg, params = train_model("bfloat16")
    we = tc.prepare_stack_weights(params["encoder"], cfg, with_head=False)
    wd = tc.prepare_stack_weights(params["decoder"], cfg, with_head=True)
    tok, cond, h0, g = train_inputs(cfg, B, L, seed=5)
    tf = torch.rand((L,), generator=g, device="cuda") < 0.9
    enc = fe.encoder_fwd_reference(we, tok)
    dh = torch.randn((B, cfg.hidden_dim), generator=g, device="cuda")
    dec = fd.decoder_fwd_reference(wd, h0, cond, tok, tf, True)
    dce = torch.full((B,), 1.0 / (B * L), device="cuda")
    pairs = {
        "fused_encoder_fwd": (lambda: fe.encoder_fwd(we, tok),
                              lambda: fe.encoder_fwd_reference(we, tok)),
        "fused_encoder_bwd": (lambda: fe.encoder_bwd(we, tok, dh, *enc[1:]),
                              lambda: fe.encoder_bwd_reference(we, tok, dh, *enc[1:])),
        "fused_train_decoder_fwd": (
            lambda: fd.decoder_fwd(wd, h0, cond, tok, tf, True),
            lambda: fd.decoder_fwd_reference(wd, h0, cond, tok, tf, True)),
        "fused_train_decoder_bwd": (
            lambda: fd.decoder_bwd(wd, dce, tok, dec[1], h0, cond, *dec[2:], True),
            lambda: fd.decoder_bwd_reference(wd, dce, tok, dec[1], h0, cond, *dec[2:], True)),
    }
    out = {}
    for name, (kern, plain) in pairs.items():
        out[name] = turns(name, kern, plain, smi, 3, 2)
    # the reverse chains' launches by layer (the decoder's layer 0 has N = E + C + H
    # columns, the encoder's E + H)
    st = torch.cuda.current_stream().cuda_stream
    le, ld = fe.build_library(), fd.build_library()
    per_layer = {
        "enc_step_kernel": chain_layer_us(
            lambda: fe.launch_encoder_bwd(le, we, tok, dh, *enc[1:], st), "enc_step_kernel",
            cfg.num_layers),
        "dec_step_kernel": chain_layer_us(
            lambda: fd.launch_decoder_bwd(ld, wd, dce, tok, dec[1], h0, cond, *dec[2:], True,
                                          st), "dec_step_kernel", cfg.num_layers)}
    E, C, H = cfg.embedding_dim, cfg.num_conditions, cfg.hidden_dim
    for name, us in per_layer.items():
        k0 = E + C if name == "dec_step_kernel" else E
        log(f"  {name} per launch by layer (layer 0: N = {k0 + H} columns, "
            f"{-(-(k0 + H) // 128)} column tiles; layer l > 0: N = {2 * H}): "
            f"{', '.join(f'layer {l} {u:.2f} us' for l, u in enumerate(us))} [{smi}]")
    out["chain_layer_us"] = per_layer
    lib = cudnn_lstm_ms(cfg.embedding_dim, cfg.hidden_dim, cfg.num_layers, B, L, "bfloat16")
    out["library"] = {"fused_encoder_fwd": lib[0], "fused_encoder_bwd": lib[1]}
    log(f"  cuDNN torch.nn.LSTM, {cfg.num_layers} layers, I={cfg.embedding_dim} "
        f"H={cfg.hidden_dim} B={B} L={L} bf16: forward {lib[0]} ms, backward alone {lib[1]} ms "
        f"[{smi}]")
    del enc, dec
    tcfg = TrainConfig(batch_size=B)
    xs, conds = synthetic_batch(cfg, B, L)
    gen = torch.Generator(device="cuda").manual_seed(4)
    for route, c in (("plain", cfg.replace(use_pallas=False)), ("fused", cfg),
                     ("fused", cfg), ("plain", cfg.replace(use_pallas=False))):
        p = train_model("bfloat16")[1]
        o = {n: adam_init(v) for n, v in p.items()}
        ms = time_ms(lambda: train_step(p, o, c, tcfg, xs, conds, gen, 0.05, 0.9), 3)
        out.setdefault(f"step_{route}", []).append(ms)
        log(f"  train step, {route} route: {ms:.3f} ms = {B * L / ms * 1e3:,.0f} tokens/s "
            f"(B=4096 L=64 bf16) [{smi}]")
    p = train_model("bfloat16")[1]
    o = {n: adam_init(v) for n, v in p.items()}
    out["profile"] = profile_step("default train step, fused route (B=4096 L=64 bf16)",
                                  lambda: train_step(p, o, cfg, tcfg, xs, conds, gen, 0.05, 0.9),
                                  smi)
    check_forward_kernels(out["profile"], "default train step")
    check_kernels(out["profile"], "default train step", "encoder reverse chain",
                  "enc_step_kernel", ("enc_bwd_kernel",))
    check_kernels(out["profile"], "default train step", "decoder reverse chain",
                  "dec_step_kernel", ("dec_bwd_kernel",))
    heads = {k: v for k, v in out["profile"]["kernels"].items()
             if k in ("dec_head_bwd_kernel", "dec_dtop_kernel")}
    log(f"  default train step: the decoder backward's head pass {heads} (ms) [{smi}]")
    return out


# the f32 default step's kernels: rows 2-5 on split-TF32 wgmma (the
# forwards' step kernel, the reverse chains' step kernels, the
# weight-gradient pass, the decoder's vocab head and the decoder backward's
# head pass) and none of the CUDA-core kernels they and rows 6-8 replaced
F32_NEW = (("encoder forward", "seq_fwd_tf32_kernel"),
           ("encoder reverse chain", "enc_step_tf32_kernel"),
           ("weight-gradient pass", "wgrad_tf32_kernel"),
           ("decoder vocab head", "dec_head_tf32_kernel"),
           ("decoder reverse chain", "dec_step_tf32_kernel"),
           ("decoder backward's head pass", "dec_head_bwd_tf32_kernel"),
           ("decoder backward's dtop", "dec_dtop_tf32_kernel"))
F32_GONE = ("enc_fwd_kernel", "enc_bwd_kernel", "wgrad_f32_kernel", "seq_fwd_kernel",
            "seq_bwd_kernel", "dec_fwd_kernel", "dec_bwd_kernel")
# the f32 scaled step's kernels: rows 6-8 on split-TF32 wgmma
F32_SEQ_NEW = (("sequence forward", "seq_fwd_tf32_kernel"),
               ("sequence reverse chain", "seq_step_tf32_kernel"),
               ("decoder vocab head", "dec_head_tf32_kernel"))


def cudnn_f32_ms(I: int, H: int, layers: int, B: int, L: int) -> tuple:
    """cuDNN's f32 ``torch.nn.LSTM`` with TF32 off (the yardstick: the same
    f32 function) and on (printed only: one TF32 pass keeps ~3 digits and
    does not meet the f32 contract): ((forward, backward) off, (forward,
    backward) on). The flag is restored."""
    prev = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = False
        off = cudnn_lstm_ms(I, H, layers, B, L, "float32")
        torch.backends.cudnn.allow_tf32 = True
        on = cudnn_lstm_ms(I, H, layers, B, L, "float32")
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return off, on


def phase_train_times_f32(smi: str, check: bool = True) -> dict:
    """Phase 8's f32 pass, default model, B=4096, L=64: rows 2-5 against
    their plain versions in turns; rows 4 and 5 alone under
    ``torch.profiler`` (device ms by kernel); cuDNN's two-layer f32 LSTM with
    TF32 off (rows 2-3's library_ms) and on; both bounds (split-TF32 and
    CUDA-core);
    the train kernels' launches in one f32 fused step (counts set to 0 just
    before); the f32 step, fused route against plain route; one f32 fused
    step under ``torch.profiler``, which (``check``) must show the
    split-TF32 kernels of rows 2-5 (``F32_NEW``) and none of the CUDA-core
    ones (``F32_GONE``)."""
    from mlx_vae_tpu_torch.config import TrainConfig
    from mlx_vae_tpu_torch.ops import fused_encoder as fe
    from mlx_vae_tpu_torch.ops import fused_train_decoder as fd
    from mlx_vae_tpu_torch.ops import train_common as tc
    from mlx_vae_tpu_torch.train.optim import adam_init
    from mlx_vae_tpu_torch.train.steps import train_step

    B, L = 4096, 64
    cfg, params = train_model("float32")
    we = tc.prepare_stack_weights(params["encoder"], cfg, with_head=False)
    wd = tc.prepare_stack_weights(params["decoder"], cfg, with_head=True)
    tok, cond, h0, g = train_inputs(cfg, B, L, seed=5)
    tf = torch.rand((L,), generator=g, device="cuda") < 0.9
    enc = fe.encoder_fwd_reference(we, tok)
    dh = torch.randn((B, cfg.hidden_dim), generator=g, device="cuda")
    dec = fd.decoder_fwd_reference(wd, h0, cond, tok, tf, True)
    dce = torch.full((B,), 1.0 / (B * L), device="cuda")
    pairs = {
        "fused_encoder_fwd": (lambda: fe.encoder_fwd(we, tok),
                              lambda: fe.encoder_fwd_reference(we, tok)),
        "fused_encoder_bwd": (lambda: fe.encoder_bwd(we, tok, dh, *enc[1:]),
                              lambda: fe.encoder_bwd_reference(we, tok, dh, *enc[1:])),
        "fused_train_decoder_fwd": (
            lambda: fd.decoder_fwd(wd, h0, cond, tok, tf, True),
            lambda: fd.decoder_fwd_reference(wd, h0, cond, tok, tf, True)),
        "fused_train_decoder_bwd": (
            lambda: fd.decoder_bwd(wd, dce, tok, dec[1], h0, cond, *dec[2:], True),
            lambda: fd.decoder_bwd_reference(wd, dce, tok, dec[1], h0, cond, *dec[2:], True)),
    }
    out = {name: turns(f"{name} f32", kern, plain, smi, 2, 1)
           for name, (kern, plain) in pairs.items()}
    out["dec_fwd_profile"] = profile_step("row 4 f32, the decoder forward with CE (B=4096 L=64)",
                                          pairs["fused_train_decoder_fwd"][0], smi)["kernels"]
    out["dec_bwd_profile"] = profile_step("row 5 f32, the decoder backward with CE (B=4096 L=64)",
                                          pairs["fused_train_decoder_bwd"][0], smi)["kernels"]
    del enc, dec
    off, on = cudnn_f32_ms(cfg.embedding_dim, cfg.hidden_dim, cfg.num_layers, B, L)
    out["library"] = {"fused_encoder_fwd": off[0], "fused_encoder_bwd": off[1]}
    log(f"  cuDNN torch.nn.LSTM, {cfg.num_layers} layers, I={cfg.embedding_dim} "
        f"H={cfg.hidden_dim} B={B} L={L} f32: TF32 off (the yardstick) forward {off[0]} ms, "
        f"backward alone {off[1]} ms; TF32 on (not the f32 function) forward {on[0]} ms, "
        f"backward alone {on[1]} ms [{smi}]")
    out["library_tf32"] = {"fused_encoder_fwd": on[0], "fused_encoder_bwd": on[1]}
    out["bounds"] = {"split_tf32": train_bounds(4, "split_tf32"),
                     "cuda_core": train_bounds(4, "float32")}
    for name in pairs:
        (bt, byt), (bc, byc) = (out["bounds"][r][name] for r in ("split_tf32", "cuda_core"))
        log(f"  {name} f32: {out[name][0]:.3f} ms; bound split-TF32 {bt:.3f} ms ({byt}), "
            f"CUDA-core {bc:.3f} ms ({byc}) [{smi}]")
    tcfg = TrainConfig(batch_size=B)
    xs, conds = synthetic_batch(cfg, B, L)
    gen = torch.Generator(device="cuda").manual_seed(4)
    counters = {k: v for k, v in kernel_counters().items() if k in TRAIN_KERNELS}
    p = train_model("float32")[1]
    o = {k: adam_init(v) for k, v in p.items()}
    reset_counts(counters)  # the main path's launches: one f32 step
    train_step(p, o, cfg, tcfg, xs, conds, gen, 0.05, 0.9)
    torch.cuda.synchronize()
    out["launches"] = read_counts(counters)
    log(f"  launches in one f32 default step (fused route): {out['launches']}")
    if min(out["launches"].values()) < 1:
        raise AssertionError(f"an f32 train kernel was not launched: {out['launches']}")
    for route, c in (("plain", cfg.replace(use_pallas=False)), ("fused", cfg),
                     ("fused", cfg), ("plain", cfg.replace(use_pallas=False))):
        ms = time_ms(lambda: train_step(p, o, c, tcfg, xs, conds, gen, 0.05, 0.9), 2)
        out.setdefault(f"step_{route}", []).append(ms)
        log(f"  train step, {route} route: {ms:.3f} ms = {B * L / ms * 1e3:,.0f} tokens/s "
            f"(B=4096 L=64 f32) [{smi}]")
    out["profile"] = profile_step("default train step, fused route (B=4096 L=64 f32)",
                                  lambda: train_step(p, o, cfg, tcfg, xs, conds, gen, 0.05, 0.9),
                                  smi)
    if check:
        for role, kernel in F32_NEW:
            check_kernels(out["profile"], "default f32 train step", role, kernel, F32_GONE)
    return out


def turns(name: str, kern, plain, smi: str, k_reps: int, p_reps: int,
          names=("kernel", "plain")) -> tuple:
    """(kernel ms, plain ms): the min of two runs each, in the order plain,
    kernel, kernel, plain."""
    p1 = time_ms(plain, p_reps)
    k1 = time_ms(kern, k_reps)
    k2 = time_ms(kern, k_reps)
    p2 = time_ms(plain, p_reps)
    log(f"  {name}: {names[0]} {k1:.3f} / {k2:.3f} ms, {names[1]} {p1:.3f} / {p2:.3f} ms "
        f"({names[1]}, {names[0]}, {names[0]}, {names[1]}) [{smi}]")
    return min(k1, k2), min(p1, p2)


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cudnn_lstm_ms(I: int, H: int, layers: int, B: int, L: int, dtype: str) -> tuple:
    """cuDNN's ``torch.nn.LSTM`` at these widths, a yardstick the port never
    calls: (forward ms, backward-alone ms), or (None, None) where PyTorch
    refuses the dtype."""
    wdt = DTYPES[dtype]
    lstm = torch.nn.LSTM(I, H, num_layers=layers).to("cuda", wdt)
    lstm.flatten_parameters()
    x = torch.randn((L, B, I), device="cuda", dtype=wdt, requires_grad=True)
    hc = (torch.zeros((layers, B, H), device="cuda", dtype=wdt),) * 2
    try:
        fwd = time_ms(lambda: lstm(x.detach(), hc), 3)
    except RuntimeError as e:
        log(f"  torch.nn.LSTM refused {dtype}: {str(e).splitlines()[0]}")
        return None, None
    out, _ = lstm(x, hc)
    g = torch.randn_like(out)
    leaves = [x] + list(lstm.parameters())
    bwd = time_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), 3)
    return fwd, bwd


def bound_ms(flops: float, nbytes: float, dtype: str) -> tuple:
    """(least ms, "operations" or "bytes"): the larger of the operations over
    the card's peak for their type and the bytes over its memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def scaled_model(dtype: str, seed: int = 0, use_pallas: bool = True):
    from mlx_vae_tpu_torch.bench import init_train_params
    from mlx_vae_tpu_torch.config import ModelConfig

    cfg = ModelConfig(compute_dtype=dtype, use_pallas=use_pallas, **SCALED)
    return cfg, init_train_params(cfg, "cuda", seed)


def seq_inputs(I: int, H: int, dtype: str, seed: int, stride: int = 1):
    """Weights like a layer's init, inputs, states and cotangents on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    wdt, s = DTYPES[dtype], H ** -0.5
    dev = dict(device="cuda")
    wcat = ((torch.rand((I + H, 4 * H), generator=g, **dev) * 2 - 1) * s).to(wdt)
    bias = (torch.rand((4 * H,), generator=g, **dev) * 2 - 1) * s
    xs = torch.randn((SL * stride, SB, I), generator=g, **dev).to(wdt)
    h0, c0, dhf, dcf = (0.3 * torch.randn((SB, H), generator=g, **dev) for _ in range(4))
    dhs = torch.randn((SL, SB, H), generator=g, **dev) / (SB * SL) ** 0.5
    return wcat, bias, xs, h0, c0, dhs, dhf, dcf


def phase_scaled_kernels() -> dict:
    """Returns {kernel: [largest abs diff, largest rel diff]} over every run."""
    from mlx_vae_tpu_torch.ops import fused_lstm as fl
    from mlx_vae_tpu_torch.ops import fused_seq_lstm as fs
    from mlx_vae_tpu_torch.ops import fused_train_decoder as fd
    from mlx_vae_tpu_torch.ops import train_common as tc

    worst = {k: [0.0, 0.0] for k in SEQ_RECORDS}
    H = SCALED["hidden_dim"]
    for dtype in ("float32", "bfloat16"):
        # I = 129: the scaled decoder's layer 0 (E + C), rows not 16-byte aligned
        for I in (128, 129, 1024):
            tag = f"{dtype} I={I} H={H} B={SB} L={SL}"
            wcat, bias, xs, h0, c0, dhs, dhf, dcf = seq_inputs(I, H, dtype, seed=I)
            k = fs.seq_lstm_fwd(wcat, bias, xs, h0, c0)
            p = fs.seq_lstm_fwd_reference(wcat, bias, xs, h0, c0)
            torch.cuda.synchronize()
            compare(f"{tag} seq fwd [hs, cs, gs, hf, cf]", k, p, dtype, worst["seq_lstm_fwd"])
            # one writer per element: the step kernels repeat, in both dtypes
            again = fs.seq_lstm_fwd(wcat, bias, xs, h0, c0)
            xs2 = torch.zeros((2 * SL,) + tuple(xs.shape[1:]), dtype=xs.dtype, device="cuda")
            xs2[1::2] = xs
            out = tuple(torch.zeros((2 * SL,) + tuple(a.shape[1:]), dtype=a.dtype,
                                    device="cuda") for a in k[:3])
            ks = fs.seq_lstm_fwd(wcat, bias, xs2, h0, c0, res_stride=2, res_offset=1,
                                 xs_stride=2, xs_offset=1, out=out)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(k, again)):
                raise AssertionError(f"{tag} seq fwd: two runs differ")
            if not (all(torch.equal(a[1::2], b) for a, b in zip(ks[:3], k[:3]))
                    and torch.equal(ks[3], k[3]) and torch.equal(ks[4], k[4])):
                raise AssertionError(f"{tag} seq fwd, strided: differs from the dense call")
            log(f"  {tag} seq fwd: a second run and a strided run (stride 2, offset 1) "
                f"are bitwise equal to the first")
            del again, xs2, out, ks, k
            kb = fs.seq_lstm_bwd_tm(wcat, xs, h0, c0, *p[:3], dhs, dhf, dcf)
            pb = fs.seq_lstm_bwd_reference(wcat, xs, h0, c0, *p[:3], dhs, dhf, dcf)
            torch.cuda.synchronize()
            compare(f"{tag} seq bwd [dxs, dwcat, db, dh0, dc0]", kb, pb, dtype,
                    worst["seq_lstm_bwd"])
            # residuals and input as rows 2t+1 of [2L, B, .] arrays (the decoder's
            # layer-stacked residuals)
            stk = []
            for a in (*p[:3], xs):
                big = torch.zeros((2 * SL,) + tuple(a.shape[1:]), dtype=a.dtype, device="cuda")
                big[1::2] = a
                stk.append(big)
            ks = fs.seq_lstm_bwd_tm(wcat, stk[3], h0, c0, *stk[:3], dhs, dhf, dcf,
                                    res_stride=2, res_offset=1, xs_stride=2, xs_offset=1)
            torch.cuda.synchronize()
            compare(f"{tag} seq bwd, strided (stride 2, offset 1)", ks, pb, dtype,
                    worst["seq_lstm_bwd"])
            # the fixed-order sums repeat bit for bit, in both dtypes
            again = fs.seq_lstm_bwd_tm(wcat, xs, h0, c0, *p[:3], dhs, dhf, dcf)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(kb, again)):
                raise AssertionError(f"{tag} seq bwd: two runs differ")
            log(f"  {tag} seq bwd: a second run is bitwise equal")
            del again, kb, pb, p, ks, stk
            torch.cuda.empty_cache()
        # row 6's counterpart: the decoder's fused forward, logits specialization
        cfg, params = scaled_model(dtype)
        wd = tc.prepare_stack_weights(params["decoder"], cfg, with_head=True)
        tok, cond, h0, g = train_inputs(cfg, SB, SL, seed=11)
        tag = f"{dtype} scaled decoder fwd logits"
        tf_on = torch.ones((SL,), dtype=torch.bool, device="cuda")
        k = fd.decoder_fwd(wd, h0, cond, tok, tf_on, False)
        p = fd.decoder_fwd_reference(wd, h0, cond, tok, tf_on, False)
        torch.cuda.synchronize()
        if not torch.equal(k[1], p[1]):
            raise AssertionError(f"{tag}: fed tokens differ under full teacher forcing")
        compare(f"{tag}, tf 1.0 [logits, hs, cs, gs]", (k[0], *k[2:]), (p[0], *p[2:]), dtype,
                worst["fused_train_decoder_fwd_logits"])
        check_decoder_chain(wd, h0, cond, tok, tf_on, False, k, p, f"{tag}, tf 1.0",
                            worst["fused_train_decoder_fwd_logits"])
        del k, p
        tf = torch.rand((SL,), generator=g, device="cuda") < 0.9
        tf[3] = False  # at least one argmax-fed step
        k = fd.decoder_fwd(wd, h0, cond, tok, tf, False)
        p = fd.decoder_fwd_reference(wd, h0, cond, tok, tf, False)
        torch.cuda.synchronize()
        check_fed_tokens(f"{tag}, tf 0.9", k, p, tf)
        check_decoder_chain(wd, h0, cond, tok, tf, False, k, p, f"{tag}, tf 0.9",
                            worst["fused_train_decoder_fwd_logits"])
        del k, p, wd, params
        torch.cuda.empty_cache()
    for B, Hg in GATE_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(B + Hg)
        gates = 3 * torch.randn((B, 4 * Hg), generator=g, device="cuda")
        c, dh, dc = (torch.randn((B, Hg), generator=g, device="cuda") for _ in range(3))
        k = fl.gates_fwd(gates, c)
        p = fl.gates_fwd_reference(gates, c)
        kb = fl.gates_bwd(gates, c, dh, dc)
        pb = fl.gates_bwd_reference(gates, c, dh, dc)
        torch.cuda.synchronize()
        compare(f"float32 gates fwd [{B}, {Hg}] [h, c]", k, p, "float32",
                worst["lstm_gates_fwd"])
        compare(f"float32 gates bwd [{B}, {Hg}] [dgates, dc_prev]", kb, pb, "float32",
                worst["lstm_gates_bwd"])
    return worst


# the gate pair against its plain version: the scaled and wide shapes, the
# default model's zero-state step (B=4096), the curve-parity study's B=256
# and phase 17's B=512 and 256 (H=256), ragged rows and an unaligned width
GATE_SHAPES = ((4096, 1024), (2048, 4096), (4096, 256), (512, 256), (256, 256), (37, 102))
# the gate pair's timed shapes: the zero-state step's, and the study's B=256,
# where the launch's own latency dominates
GATE_TIMED = ((4096, 256), (256, 256))


def kernel_counters() -> dict:
    """{kernel: (wrapper, the attribute that counts its launches)}."""
    from mlx_vae_tpu_torch.ops import fused_encoder as fe
    from mlx_vae_tpu_torch.ops import fused_lstm as fl
    from mlx_vae_tpu_torch.ops import fused_seq_lstm as fs
    from mlx_vae_tpu_torch.ops import fused_train_decoder as fd

    return {"seq_lstm_fwd": (fs.seq_lstm_fwd, "launches"),
            "seq_lstm_bwd": (fs.seq_lstm_bwd_tm, "launches"),
            "fused_train_decoder_fwd_logits": (fd.decoder_fwd, "logits_launches"),
            "lstm_gates_fwd": (fl.gates_fwd, "launches"),
            "lstm_gates_bwd": (fl.gates_bwd, "launches"),
            "fused_encoder_fwd": (fe.encoder_fwd, "launches"),
            "fused_encoder_bwd": (fe.encoder_bwd, "launches"),
            "fused_train_decoder_fwd": (fd.decoder_fwd, "launches"),
            "fused_train_decoder_bwd": (fd.decoder_bwd, "launches")}


def reset_counts(counters: dict) -> None:
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def read_counts(counters: dict) -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}


def fused_vs_plain(what: str, model, x, cond, B: int, L: int,
                   dtypes=("float32", "bfloat16")) -> None:
    """One step on the fused route against the plain route, same params and
    noise, in each of ``dtypes``: phase 7's bounds."""
    import math

    from mlx_vae_tpu_torch.config import TrainConfig
    from mlx_vae_tpu_torch.train.optim import adam_init
    from mlx_vae_tpu_torch.train.steps import draw_noise, train_step
    from mlx_vae_tpu_torch.utils.tree import tree_leaves, tree_map

    tcfg = TrainConfig(batch_size=B)
    lr = tcfg.learning_rate
    max_step = lr * (1 - tcfg.adam_b1) / math.sqrt(1 - tcfg.adam_b2)
    gen = torch.Generator(device="cuda").manual_seed(6)
    for dtype, s_tol, same_min, leaf_off in (("float32", 1e-4, 0.9999, 1e-4),
                                              ("bfloat16", 1e-2, 0.98, None)):
        if dtype not in dtypes:
            continue
        cfg, p0 = model(dtype)
        noise = draw_noise(gen, cfg, B, L, 0.9)
        out = {}
        for route, c in (("fused", cfg), ("plain", cfg.replace(use_pallas=False))):
            p = tree_map(torch.clone, p0)
            o = {n: adam_init(v) for n, v in p.items()}
            _, _, m = train_step(p, o, c, tcfg, x, cond, None, 0.05, 0.9, noise=noise)
            out[route] = (p, {k: float(v) for k, v in m.items()})
            del o
        del p0
        (pf, mf), (pp, mp) = out["fused"], out["plain"]
        worst = max(abs(mf[k] - mp[k]) / max(abs(mp[k]), 1e-6)
                    for k in mp if k not in ("mu_abs_max", "logvar_min", "logvar_max"))
        dp = [(a.detach() - b.detach()).abs() for a, b in zip(tree_leaves(pf), tree_leaves(pp))]
        off = [int((d > 1e-2 * max_step).sum()) for d in dp]
        same = 1.0 - sum(off) / sum(d.numel() for d in dp)
        worst_leaf = max(o / d.numel() for o, d in zip(off, dp))
        big = max(float(d.max()) for d in dp)
        log(f"  {what} {dtype} one step fused vs plain route: total {mf['total_loss']:.6f} vs "
            f"{mp['total_loss']:.6f}, grad_norm {mf['grad_norm']:.6f} vs {mp['grad_norm']:.6f}; "
            f"worst rel diff over the 9 scalars and grad_norm {worst:.3e} (tol {s_tol}); "
            f"post-Adam params: {same:.4%} of elements took the same step, worst leaf "
            f"{worst_leaf:.4%} off, max |diff| {big:.3e} (one step <= {max_step:.3e})")
        if not worst <= s_tol:
            raise AssertionError(f"{what} {dtype}: fused and plain route scalars differ by "
                                 f"{worst}")
        if not (same >= same_min and big <= 2 * max_step * 1.001):
            raise AssertionError(f"{what} {dtype}: post-Adam params differ ({same:.4%} same)")
        if leaf_off is not None and any(o > max(1, leaf_off * d.numel())
                                        for o, d in zip(off, dp)):
            raise AssertionError(f"{what} {dtype}: a post-Adam leaf differs in "
                                 f"{worst_leaf:.4%} of its elements")
        del out, pf, pp, dp
        torch.cuda.empty_cache()


def phase_scaled_slice() -> dict:
    """Four scaled bf16 steps, then the fused-vs-plain checks; returns the
    launch count of each new kernel on its main path (the scaled steps for
    the sequence and decoder kernels, the zero-state step for the gate
    pair)."""
    import math

    from mlx_vae_tpu_torch.config import ModelConfig, TrainConfig
    from mlx_vae_tpu_torch.train.optim import adam_init
    from mlx_vae_tpu_torch.train.steps import train_step

    cfg, params = scaled_model("bfloat16")
    x, cond = synthetic_batch(cfg, SB, SL)
    counters = kernel_counters()
    steps = 4
    counts = train_steps(cfg, params, x, cond, steps, counters)
    per_step = {"seq_lstm_fwd": 4, "seq_lstm_bwd": 8, "fused_train_decoder_fwd_logits": 1}
    want = {k: steps * per_step.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"scaled launches {counts}, expected {want}")
    del params
    torch.cuda.empty_cache()
    fused_vs_plain("scaled", lambda dt: scaled_model(dt, seed=3), x, cond, SB, SL)

    # the gate pair's main path: a default-model reference_zero_state step
    B, L = 4096, 64
    zcfg = ModelConfig(compute_dtype="bfloat16", use_pallas=True, reference_zero_state=True)
    zx, zcond = synthetic_batch(zcfg, B, L)
    _, zp = train_model("bfloat16", seed=4)
    zo = {n: adam_init(p) for n, p in zp.items()}
    gen = torch.Generator(device="cuda").manual_seed(2)
    reset_counts(counters)
    _, _, m = train_step(zp, zo, zcfg, TrainConfig(batch_size=B), zx, zcond, gen, 0.05, 0.9)
    torch.cuda.synchronize()
    zcounts = read_counts(counters)
    log(f"  reference_zero_state step, default model, bf16, B={B} L={L}: total loss "
        f"{float(m['total_loss']):.4f}; launches {zcounts}")
    n = zcfg.num_layers
    if not (zcounts["lstm_gates_fwd"] == L * n and zcounts["lstm_gates_bwd"] == L * n
            and math.isfinite(float(m["total_loss"]))):
        raise AssertionError(f"gate-kernel launches {zcounts}, expected {L * n} each way")
    del zp, zo, m
    torch.cuda.empty_cache()
    fused_vs_plain("reference_zero_state",
                   lambda dt: (zcfg.replace(compute_dtype=dt), train_model(dt, seed=5)[1]),
                   zx, zcond, B, L)
    counts.update({k: zcounts[k] for k in ("lstm_gates_fwd", "lstm_gates_bwd")})
    return counts


def lstm_flops(B: int, L: int, widths) -> float:
    """Multiply-adds x 2 of the cells' products over L steps of B rows, for
    layers of (input width, H)."""
    return 2.0 * B * L * sum((i + h) * 4 * h for i, h in widths)


def phase_scaled_times(smi: str) -> dict:
    """{kernel: (kernel ms, plain ms, library ms, bound ms, bound by)}, the
    whole-stack kernels' times at the scaled shape, and the scaled step's."""
    from mlx_vae_tpu_torch.bench_gates import l2_scrub, median_ms
    from mlx_vae_tpu_torch.config import TrainConfig
    from mlx_vae_tpu_torch.ops import fused_encoder as fe
    from mlx_vae_tpu_torch.ops import fused_lstm as fl
    from mlx_vae_tpu_torch.ops import fused_seq_lstm as fs
    from mlx_vae_tpu_torch.ops import fused_train_decoder as fd
    from mlx_vae_tpu_torch.ops import train_common as tc
    from mlx_vae_tpu_torch.train.optim import adam_init
    from mlx_vae_tpu_torch.train.steps import train_step

    out = {}
    H, dt, es = SCALED["hidden_dim"], "bfloat16", 2
    M = SB * SL
    for I in (128, 1024):
        wcat, bias, xs, h0, c0, dhs, dhf, dcf = seq_inputs(I, H, dt, seed=I + 1)
        res = fs.seq_lstm_fwd(wcat, bias, xs, h0, c0)
        fl_ops = lstm_flops(SB, SL, [(I, H)])
        fwd_bound, bwd_bound = seq_bounds(I, H, es, dt)
        k_ms, p_ms = turns(f"seq_lstm_fwd I={I}", lambda: fs.seq_lstm_fwd(wcat, bias, xs, h0, c0),
                           lambda: fs.seq_lstm_fwd_reference(wcat, bias, xs, h0, c0), smi, 3, 2)
        kb_ms, pb_ms = turns(f"seq_lstm_bwd I={I}",
                             lambda: fs.seq_lstm_bwd_tm(wcat, xs, h0, c0, *res[:3], dhs, dhf, dcf),
                             lambda: fs.seq_lstm_bwd_reference(wcat, xs, h0, c0, *res[:3], dhs,
                                                               dhf, dcf), smi, 2, 2)
        lib = cudnn_lstm_ms(I, H, 1, SB, SL, dt)
        log(f"  cuDNN torch.nn.LSTM, 1 layer, I={I} H={H} B={SB} L={SL} bf16: forward "
            f"{lib[0]} ms, backward alone {lib[1]} ms [{smi}]")
        out[f"seq_lstm_fwd I={I}"] = (k_ms, p_ms, lib[0], *fwd_bound)
        out[f"seq_lstm_bwd I={I}"] = (kb_ms, pb_ms, lib[1], *bwd_bound)
        log(f"  I={I}: forward {fl_ops / 1e12:.4f} TFLOP, bound "
            f"{out[f'seq_lstm_fwd I={I}'][3]:.4f} ms, {fl_ops / k_ms / 1e9:.1f} TFLOP/s; "
            f"backward bound {out[f'seq_lstm_bwd I={I}'][3]:.4f} ms")
        del res, wcat, xs, dhs
        torch.cuda.empty_cache()

    cfg, params = scaled_model(dt)
    wd = tc.prepare_stack_weights(params["decoder"], cfg, with_head=True)
    we = tc.prepare_stack_weights(params["encoder"], cfg, with_head=False)
    tok, cond, h0, g = train_inputs(cfg, SB, SL, seed=12)
    tf = torch.rand((SL,), generator=g, device="cuda") < 0.9
    n = cfg.num_layers
    k_ms, p_ms = turns("fused_train_decoder_fwd_logits",
                       lambda: fd.decoder_fwd(wd, h0, cond, tok, tf, False),
                       lambda: fd.decoder_fwd_reference(wd, h0, cond, tok, tf, False), smi, 2, 1)
    out["fused_train_decoder_fwd_logits"] = (k_ms, p_ms, None, *dec_logits_bound(cfg, es, dt))

    # route check: the whole-stack kernels at the scaled shape, through their
    # launch functions (no route, no counter)
    st = torch.cuda.current_stream().cuda_stream
    le, ld = fe.build_library(), fd.build_library()
    enc_res = fe.launch_encoder_fwd(le, we, tok, st)
    dec_res = fd.launch_decoder_fwd(ld, wd, h0, cond, tok, tf.int(), True, st)
    dce = torch.full((SB,), 1.0 / M, device="cuda")
    whole = {
        "whole-stack encoder fwd": lambda: fe.launch_encoder_fwd(le, we, tok, st),
        "whole-stack encoder bwd": lambda: fe.launch_encoder_bwd(le, we, tok, h0, *enc_res[1:],
                                                                 st),
        "whole-stack decoder fwd (CE)": lambda: fd.launch_decoder_fwd(ld, wd, h0, cond, tok,
                                                                      tf.int(), True, st),
        "whole-stack decoder bwd (CE)": lambda: fd.launch_decoder_bwd(
            ld, wd, dce, tok, dec_res[1], h0, cond, *dec_res[2:], True, st),
    }
    for name, fn in whole.items():
        ms = time_ms(fn, 1)
        out[name] = ms
        log(f"  route check, {name} at H={H} n={n} B={SB} L={SL} bf16: {ms:.3f} ms [{smi}]")
    del enc_res, dec_res, wd, we, params
    torch.cuda.empty_cache()

    # the gate pair at its main paths' shapes (default model: B=4096 and 256,
    # H=256)
    aten = torch.ops.aten
    for Bg, Hg in GATE_TIMED:
        g = torch.Generator(device="cuda").manual_seed(9)
        gates = torch.randn((Bg, 4 * Hg), generator=g, device="cuda")
        c, dh, dc = (torch.randn((Bg, Hg), generator=g, device="cuda") for _ in range(3))
        zero = torch.zeros_like(gates)
        tag = "" if (Bg, Hg) == GATE_TIMED[0] else f" [{Bg}, {Hg}]"
        k_ms, p_ms = turns(f"lstm_gates_fwd{tag}", lambda: fl.gates_fwd(gates, c),
                           lambda: fl.gates_fwd_reference(gates, c), smi, 50, 50)
        kb_ms, pb_ms = turns(f"lstm_gates_bwd{tag}", lambda: fl.gates_bwd(gates, c, dh, dc),
                             lambda: fl.gates_bwd_reference(gates, c, dh, dc), smi, 50, 50)
        hy, cy, ws = aten._thnn_fused_lstm_cell(gates, zero, c)
        med = median_ms({
            "kernel fwd": lambda: fl.gates_fwd(gates, c),
            "aten fwd": lambda: aten._thnn_fused_lstm_cell(gates, zero, c),
            "kernel bwd": lambda: fl.gates_bwd(gates, c, dh, dc),
            "aten bwd": lambda: aten._thnn_fused_lstm_cell_backward_impl(dh, dc, c, cy, ws,
                                                                         False)},
            GATE_SAMPLES, l2_scrub())
        log(f"  gate pair vs PyTorch's fused LSTM cell (aten::_thnn_fused_lstm_cell) [{Bg}, "
            f"{Hg}] f32, median device ms of {GATE_SAMPLES} launches each, interleaved, each "
            f"behind a 128 MB write that evicts the L2: forward kernel "
            f"{med['kernel fwd']:.5f} / aten {med['aten fwd']:.5f}, backward kernel "
            f"{med['kernel bwd']:.5f} / aten {med['aten bwd']:.5f} [{smi}]")
        units = Bg * Hg
        out[f"lstm_gates_fwd{tag}"] = (med["kernel fwd"], p_ms, med["aten fwd"],
                                       *bound_ms(40.0 * units, 28.0 * units, "float32"))
        out[f"lstm_gates_bwd{tag}"] = (med["kernel bwd"], pb_ms, med["aten bwd"],
                                       *bound_ms(70.0 * units, 48.0 * units, "float32"))
        del gates, c, dh, dc, zero, hy, cy, ws

    # the scaled step, plain route against the fused route
    tcfg = TrainConfig(batch_size=SB)
    xb, cb = synthetic_batch(cfg, SB, SL)
    gen = torch.Generator(device="cuda").manual_seed(4)
    for route, use in (("plain", False), ("fused", True), ("fused", True), ("plain", False)):
        c_, p = scaled_model(dt, use_pallas=use)
        o = {k: adam_init(v) for k, v in p.items()}
        ms = time_ms(lambda: train_step(p, o, c_, tcfg, xb, cb, gen, 0.05, 0.9), 1)
        out.setdefault(f"scaled_step_{route}", []).append(ms)
        log(f"  scaled train step, {route} route: {ms:.3f} ms = {M / ms * 1e3:,.0f} tokens/s "
            f"(H=1024 n=4 B={SB} L={SL} bf16) [{smi}]")
        del p, o
        torch.cuda.empty_cache()
    c_, p = scaled_model(dt)
    o = {k: adam_init(v) for k, v in p.items()}
    out["profile"] = profile_step(f"scaled train step, fused route (H=1024 n=4 B={SB} L={SL} "
                                  f"bf16)", lambda: train_step(p, o, c_, tcfg, xb, cb, gen, 0.05,
                                                               0.9), smi)
    check_forward_kernels(out["profile"], "scaled train step")
    del p, o
    torch.cuda.empty_cache()
    return out


def phase_scaled_times_f32(smi: str) -> dict:
    """Phase 11's f32 pass at the scaled shape (H=1024, B=2048, L=64): the
    sequence forward and backward (rows 7-8, I=1024, and I=128 as the
    encoder's layer 0) and the decoder's logits forward (row 6, 4 layers)
    against their plain versions in turns; cuDNN's one-layer f32 LSTM with
    TF32 off (library_ms) and on; both bounds; the launches of one f32
    scaled fused step (counts set to 0 just before); the warm step (the
    median of three after it, host clock); one warm step under
    ``torch.profiler``, which must show rows 7-8's split-TF32 kernels and
    none of the CUDA-core kernels they replaced."""
    import statistics

    from mlx_vae_tpu_torch.config import TrainConfig
    from mlx_vae_tpu_torch.ops import fused_seq_lstm as fs
    from mlx_vae_tpu_torch.ops import fused_train_decoder as fd
    from mlx_vae_tpu_torch.ops import train_common as tc
    from mlx_vae_tpu_torch.train.optim import adam_init
    from mlx_vae_tpu_torch.train.steps import train_step

    out = {}
    H, dt = SCALED["hidden_dim"], "float32"
    for I in (1024, 128):
        tag = "" if I == 1024 else f" I={I}"
        wcat, bias, xs, h0, c0, dhs, dhf, dcf = seq_inputs(I, H, dt, seed=I + 1)
        res = fs.seq_lstm_fwd_reference(wcat, bias, xs, h0, c0)
        k_ms, p_ms = turns(f"seq_lstm_fwd I={I} f32",
                           lambda: fs.seq_lstm_fwd(wcat, bias, xs, h0, c0),
                           lambda: fs.seq_lstm_fwd_reference(wcat, bias, xs, h0, c0), smi, 3, 1)
        kb_ms, pb_ms = turns(f"seq_lstm_bwd I={I} f32",
                             lambda: fs.seq_lstm_bwd_tm(wcat, xs, h0, c0, *res[:3], dhs, dhf, dcf),
                             lambda: fs.seq_lstm_bwd_reference(wcat, xs, h0, c0, *res[:3], dhs,
                                                               dhf, dcf), smi, 2, 1)
        del res, wcat, xs, dhs
        torch.cuda.empty_cache()
        off, on = cudnn_f32_ms(I, H, 1, SB, SL)
        log(f"  cuDNN torch.nn.LSTM, 1 layer, I={I} H={H} B={SB} L={SL} f32: TF32 off (the "
            f"yardstick) forward {off[0]} ms, backward alone {off[1]} ms; TF32 on forward "
            f"{on[0]} ms, backward alone {on[1]} ms [{smi}]")
        fwd_b = {r: seq_bounds(I, H, 4, r)[0] for r in ("split_tf32", "float32")}
        bwd_b = {r: seq_bounds(I, H, 4, r)[1] for r in ("split_tf32", "float32")}
        out[f"seq_lstm_fwd{tag}"] = dict(ms=k_ms, plain_ms=p_ms, library_ms=off[0],
                                         library_tf32_ms=on[0], bounds=fwd_b)
        out[f"seq_lstm_bwd{tag}"] = dict(ms=kb_ms, plain_ms=pb_ms, library_ms=off[1],
                                         library_tf32_ms=on[1], bounds=bwd_b)
    cfg, params = scaled_model(dt)
    wd = tc.prepare_stack_weights(params["decoder"], cfg, with_head=True)
    tok, cond, h0, g = train_inputs(cfg, SB, SL, seed=12)
    tf = torch.rand((SL,), generator=g, device="cuda") < 0.9
    k_ms, p_ms = turns("fused_train_decoder_fwd_logits f32",
                       lambda: fd.decoder_fwd(wd, h0, cond, tok, tf, False),
                       lambda: fd.decoder_fwd_reference(wd, h0, cond, tok, tf, False), smi, 1, 1)
    out["fused_train_decoder_fwd_logits"] = dict(
        ms=k_ms, plain_ms=p_ms, library_ms=None, library_tf32_ms=None,
        bounds={r: dec_logits_bound(cfg, 4, r) for r in ("split_tf32", "float32")})
    out["dec_fwd_profile"] = profile_step(
        f"row 6 f32, the decoder's logits forward (H=1024 n=4 B={SB} L={SL})",
        lambda: fd.decoder_fwd(wd, h0, cond, tok, tf, False), smi)["kernels"]
    del wd
    for name, rec in out.items():
        if name == "dec_fwd_profile":
            continue
        log(f"  {name} f32 at the scaled shape: {rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} "
            f"ms; bound split-TF32 {rec['bounds']['split_tf32'][0]:.3f} ms, CUDA-core "
            f"{rec['bounds']['float32'][0]:.3f} ms [{smi}]")
    counters = {k: kernel_counters()[k] for k in SEQ_RECORDS if not k.startswith("lstm_gates")}
    o = {k: adam_init(v) for k, v in params.items()}
    xb, cb = synthetic_batch(cfg, SB, SL)
    gen = torch.Generator(device="cuda").manual_seed(4)
    tcfg = TrainConfig(batch_size=SB)

    def step():
        train_step(params, o, cfg, tcfg, xb, cb, gen, 0.05, 0.9)

    def timed_s():
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    reset_counts(counters)  # the main path's launches: one f32 scaled step
    out["step_s"] = timed_s()
    out["launches"] = read_counts(counters)
    log(f"  launches in one f32 scaled step (fused route, {out['step_s']:.3f} s by the host "
        f"clock, the first): {out['launches']}")
    if out["launches"] != {"seq_lstm_fwd": 4, "seq_lstm_bwd": 8,
                           "fused_train_decoder_fwd_logits": 1}:
        raise AssertionError(f"f32 scaled launches {out['launches']}")
    warm = [timed_s() for _ in range(3)]
    out["warm_step_s"] = statistics.median(warm)
    log(f"  f32 scaled step, fused route, warm: median {out['warm_step_s']:.4f} s of "
        f"{', '.join(f'{w:.4f}' for w in warm)} s by the host clock = "
        f"{SB * SL / out['warm_step_s']:,.0f} tokens/s (H=1024 n=4 B={SB} L={SL} f32) [{smi}]")
    out["profile"] = profile_step(f"f32 scaled train step, fused route (H=1024 n=4 B={SB} "
                                  f"L={SL} f32)", step, smi)
    for role, kernel in F32_SEQ_NEW:
        check_kernels(out["profile"], "f32 scaled train step", role, kernel, F32_GONE)
    del params, o
    torch.cuda.empty_cache()
    return out


def train_bounds(es: int, route: str) -> dict:
    """{kernel: (bound ms, bound by)} of rows 2-5 at the shape phase 8 times
    them (default model, B=4096, L=64), residuals and weights of ``es``
    bytes, the operations at ``route``'s rate (``PEAK_FLOPS``)."""
    from mlx_vae_tpu_torch.config import ModelConfig

    cfg = ModelConfig()
    E, C, H, V, n = (cfg.embedding_dim, cfg.num_conditions, cfg.hidden_dim, cfg.vocab_size,
                     cfg.num_layers)
    B, L = 4096, 64
    M = B * L
    res = M * n * 6 * H * es
    enc_w = [(E, H)] + [(H, H)] * (n - 1)
    dec_w = [(E + C, H)] + [(H, H)] * (n - 1)
    enc_ops, dec_ops = lstm_flops(B, L, enc_w), lstm_flops(B, L, dec_w)
    wb = lambda ws: sum((i + h) * 4 * h for i, h in ws)  # noqa: E731
    grads = lambda ws, head: (wb(ws) + n * 4 * H + V * E + head) * 4  # noqa: E731
    out = {}
    out["fused_encoder_fwd"] = bound_ms(enc_ops, M * 4 + (wb(enc_w) + V * E) * es + res
                                        + B * H * 4, route)
    out["fused_encoder_bwd"] = bound_ms(2 * enc_ops, M * 4 + (wb(enc_w) + V * E) * es + res
                                        + B * H * 4 + grads(enc_w, 0), route)
    dec_in = M * 4 + B * (H + C) * 4 + (wb(dec_w) + V * E + 2 * H * V) * es
    out["fused_train_decoder_fwd"] = bound_ms(dec_ops + 2.0 * M * H * V,
                                              dec_in + B * 4 + M * 4 + res, route)
    out["fused_train_decoder_bwd"] = bound_ms(
        2 * dec_ops + 6.0 * M * H * V, dec_in + B * 4 + M * 4 + res
        + grads(dec_w, H * V + V) + B * (H + C) * 4, route)
    return out


def seq_bounds(I: int, H: int, es: int, route: str) -> tuple:
    """((bound ms, bound by) of the sequence forward, of its backward) at the
    scaled shape phase 11 times them (B=2048, L=64)."""
    M = SB * SL
    fl_ops = lstm_flops(SB, SL, [(I, H)])
    w_bytes = (I + H) * 4 * H * es + 4 * H * 4
    fwd_bytes = M * I * es + w_bytes + 2 * SB * H * 4 + M * 6 * H * es + 2 * SB * H * 4
    bwd_bytes = (M * I * es + w_bytes + M * 6 * H * es + M * H * 4 + 4 * SB * H * 4
                 + M * I * 4 + (I + H) * 4 * H * 4 + 4 * H * 4 + 2 * SB * H * 4)
    return bound_ms(fl_ops, fwd_bytes, route), bound_ms(2 * fl_ops, bwd_bytes, route)


def dec_logits_bound(cfg, es: int, route: str) -> tuple:
    """(bound ms, bound by) of the decoder's logits forward at the scaled
    shape (B=2048, L=64)."""
    E, C, V, n, H = (cfg.embedding_dim, cfg.num_conditions, cfg.vocab_size, cfg.num_layers,
                     cfg.hidden_dim)
    M = SB * SL
    dec_widths = [(E + C, H)] + [(H, H)] * (n - 1)
    dec_ops = lstm_flops(SB, SL, dec_widths) + 2.0 * M * H * V
    stack_bytes = sum((i + H) * 4 * H for i, _ in dec_widths) * es
    res_bytes = M * n * 6 * H * es
    return bound_ms(dec_ops, stack_bytes + res_bytes + M * V * 4 + M * 8, route)


def default_bounds() -> dict:
    """{kernel: (bound ms, bound by)} of the sampler and the default-model
    train kernels at the shapes phases 5 and 8 time them; the sampler's by
    route: CUDA-core f32 FMA (67 TFLOP/s), split-TF32 (3 x the operations at
    495 TFLOP/s), bf16 (989 TFLOP/s); the train kernels in bf16."""
    from mlx_vae_tpu_torch.config import ModelConfig

    cfg = ModelConfig()
    E, C, H, V, n = (cfg.embedding_dim, cfg.num_conditions, cfg.hidden_dim, cfg.vocab_size,
                     cfg.num_layers)
    out = {}
    B, L = 8192, 64  # the sampler, f32
    M = B * L
    ops = lstm_flops(B, L, [(E + C, H)] + [(H, H)] * (n - 1)) + 2.0 * M * H * V
    w = ((E + C + H) * 4 * H + (n - 1) * 2 * H * 4 * H + H * V + V * E) * 4
    nbytes = w + B * (H + C) * 4 + M * 4
    out["fused_generate"] = bound_ms(ops, nbytes, "float32")  # CUDA cores
    out["fused_generate_tc"] = bound_ms(ops, nbytes, "split_tf32")
    out["fused_generate_tc_bf16"] = bound_ms(ops, nbytes - w // 2, "bfloat16")
    out.update(train_bounds(2, "bfloat16"))
    return out


def run_cli(main, argv: list):
    """``main(argv)`` of a port CLI in this process: its standard output
    captured (its standard error, the progress bars, dropped) and its last
    lines logged. Returns ``(output, main's return value)``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        res = main(argv)
    text = out.getvalue()
    for line in text.strip().splitlines()[-3:]:
        log(f"    | {line}")
    return text, res


def run_main(main, argv: list) -> str:
    """:func:`run_cli`'s captured standard output alone."""
    return run_cli(main, argv)[0]


def read_history(ck: str) -> dict:
    with open(f"{ck}/training_history.json") as f:
        return json.load(f)


def trace_profile(path: str) -> dict:
    """Device time by kernel name, and the idle share (1 - the device's busy
    time over the span of every event), from a ``torch.profiler`` Chrome
    trace (the train CLI's ``--profile``)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    by_name, busy = {}, 0.0
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            busy += e["dur"] / 1e3
            if e["cat"] == "kernel":
                name = e["name"].replace("(anonymous namespace)::", "").split("(")[0][:80]
                by_name[name] = by_name.get(name, 0.0) + e["dur"] / 1e3
    wall = (max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)) / 1e3
    return {"wall_ms": wall, "device_ms": busy, "idle_share": max(0.0, 1 - busy / wall),
            "kernels": by_name}


def epoch_counts(counters: dict, seen: list):
    """Patch ``ARCVAETrainer.train_epoch`` so that each epoch appends the
    train-kernel launch counts so far to ``seen``; returns the undo."""
    from mlx_vae_tpu_torch.train.trainer import ARCVAETrainer

    real = ARCVAETrainer.train_epoch

    def counted(self, *a, **kw):
        out = real(self, *a, **kw)
        seen.append(read_counts(counters))
        return out

    ARCVAETrainer.train_epoch = counted
    return lambda: setattr(ARCVAETrainer, "train_epoch", real)


def save_timing(rec: dict):
    """Patch ``ARCVAETrainer`` so that ``rec`` gets the clock at each
    epoch's start (``"epoch"``) and at the end of each ``join_saves``
    (``"join"``), and the seconds the calling thread spends in
    ``save_checkpoint`` (``"save_s"``); returns the undo."""
    from mlx_vae_tpu_torch.train.trainer import ARCVAETrainer

    real = {k: getattr(ARCVAETrainer, k) for k in ("train_epoch", "save_checkpoint",
                                                   "join_saves")}
    rec.update(epoch=[], join=[], save_s=0.0)

    def train_epoch(self, *a, **kw):
        rec["epoch"].append(time.perf_counter())
        return real["train_epoch"](self, *a, **kw)

    def save_checkpoint(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return real["save_checkpoint"](self, *a, **kw)
        finally:
            rec["save_s"] += time.perf_counter() - t0

    def join_saves(self):
        try:
            return real["join_saves"](self)
        finally:
            rec["join"].append(time.perf_counter())

    for k, f in (("train_epoch", train_epoch), ("save_checkpoint", save_checkpoint),
                 ("join_saves", join_saves)):
        setattr(ARCVAETrainer, k, f)
    return lambda: [setattr(ARCVAETrainer, k, f) for k, f in real.items()]


TRAIN_PASS = re.compile(r"Throughput: ([\d,]+) tokens/sec \(([\d.]+)s train pass\)")
# history values of the f32 train CLI, fused route against plain route: the
# tolerance of the CPU parity test (tests/test_torch_trainer.py, the port against
# JAX over 2 epochs, f32), whose worst measured error is 8.0e-7
CLI_F32_RTOL = 1e-5


def phase_train_cli(smi: str, step_ms: float, tmp: str) -> dict:
    """The port's train and generate CLIs in this process at the default
    model's width (phase 12 of the docstring), in ``tmp``, where the corpus
    (``s.json``) and the two-epoch run's checkpoints (``ck/``) stay for
    phase 13; returns the train kernels' launches over the two-epoch run and
    the sampler's over the served run, and the times."""
    import os

    from mlx_vae_tpu_torch.cli import generate as cli_generate
    from mlx_vae_tpu_torch.cli import train as cli_train
    from mlx_vae_tpu_torch.data import packer, prepare
    from mlx_vae_tpu_torch.ops.fused_decoder import fused_generate
    from mlx_vae_tpu_torch.train.checkpoint import load_checkpoint

    out = {}
    s, ck = f"{tmp}/s.json", f"{tmp}/ck"
    run_main(prepare.main, ["--synthetic", "20523", "--output", s])
    if packer._get_lib() is None:
        raise AssertionError("native/packer.cpp did not build")
    base = ["--data", s, "--batch_size", "4096", "--compute_dtype", "bfloat16",
            "--use_pallas", "--checkpoint_freq", "1", "--checkpoint_dir", ck]

    # two epochs: 4 batches of 4096 and one of 34, eval at 2052 and 2053 rows
    counters = {k: v for k, v in kernel_counters().items() if k in TRAIN_KERNELS}
    seen = []
    undo = epoch_counts(counters, seen)
    reset_counts(counters)
    try:
        text = run_main(cli_train.main, base + ["--epochs", "2", "--eval_test",
                                                "--verbose"])
    finally:
        undo()
    launches = read_counts(counters)
    for e, c in enumerate(seen):
        log(f"  epoch {e + 1}: train-kernel launches so far {c}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a train kernel was never launched: {launches}")
    h = read_history(ck)
    if h["epoch"] != [0, 1] or not all(math.isfinite(v) for k in h for v in h[k]):
        raise AssertionError(f"history of the two-epoch run: {h}")
    if not h["train_recon"][1] < h["train_recon"][0]:
        raise AssertionError(f"train_recon did not fall: {h['train_recon']}")
    for name in ("checkpoint_epoch_000.npz", "checkpoint_epoch_001.npz",
                 "checkpoint_best.npz"):
        if not os.path.exists(f"{ck}/{name}"):
            raise AssertionError(f"{name} was not written")
    if "Test set (2,053 samples)" not in text:
        raise AssertionError("--eval_test printed no test line")
    passes = TRAIN_PASS.findall(text)
    out["batch_ms"] = float(passes[1][1]) * 1e3 / 5
    out["throughput"] = passes[1][0]
    log(f"  two epochs: train_recon {h['train_recon']}, val_loss {h['val_loss']}; "
        f"train pass epoch 1 {passes[0][1]} s, epoch 2 {passes[1][1]} s over 5 batches "
        f"= {out['batch_ms']:.3f} ms a batch (phase 8's fused step at B=4096: "
        f"{step_ms:.3f} ms); Throughput {passes[1][0]} tokens/s [{smi}]")
    # the async checkpoint (the default) against --sync_checkpoint: three
    # epochs each, a checkpoint every epoch, in turns async, sync, sync,
    # async; the epochs' wall time runs from the first epoch's start to the
    # end of the last save (its join), so it holds every save
    out["save"] = {"async": [], "sync": []}
    for i, mode in enumerate(("async", "sync", "sync", "async")):
        rec = {}
        undo = save_timing(rec)
        try:
            text = run_main(cli_train.main, base[:-1] + [
                f"{tmp}/ck_{mode}_{i}", "--epochs", "3",
                *(["--sync_checkpoint"] if mode == "sync" else [])])
        finally:
            undo()
        passes = [float(p[1]) for p in TRAIN_PASS.findall(text)]
        row = {"epochs_wall_s": rec["join"][-1] - rec["epoch"][0],
               "train_pass_s": passes, "save_call_s": rec["save_s"]}
        out["save"][mode].append(row)
        log(f"  three epochs, {mode} checkpoint: epochs' wall {row['epochs_wall_s']:.4f} s "
            f"(first epoch's start to the last save's end), train passes "
            f"{', '.join(f'{p:.4f}' for p in passes)} s, the main thread in "
            f"save_checkpoint {row['save_call_s']:.4f} s [{smi}]")

    # resume for a third epoch, profiled: the kernels by name and the idle share
    text = run_main(cli_train.main, base + ["--epochs", "3", "--resume",
                                            "--profile", f"{tmp}/prof"])
    if "Resuming from epoch 2" not in text or read_history(ck)["epoch"] != [0, 1, 2]:
        raise AssertionError("--resume did not run epoch index 2 alone")
    prof = trace_profile(f"{tmp}/prof/trace.json")
    check_forward_kernels(prof, "train CLI epoch 3")
    check_kernels(prof, "train CLI epoch 3", "encoder reverse chain", "enc_step_kernel",
                  ("enc_bwd_kernel",))
    check_kernels(prof, "train CLI epoch 3", "decoder reverse chain", "dec_step_kernel",
                  ("dec_bwd_kernel",))
    out["idle_share"] = prof["idle_share"]
    log(f"  train CLI epoch 3 under torch.profiler: {prof['wall_ms']:.3f} ms wall, "
        f"{prof['device_ms']:.3f} ms of device time, idle share {prof['idle_share']:.4f} "
        f"[{smi}]")

    # fused against plain in f32 from the same seed
    f = f"{tmp}/f.json"
    run_main(prepare.main, ["--synthetic", "3000", "--output", f])
    hist = {}
    for route, extra in (("fused", ["--use_pallas"]), ("plain", [])):
        reset_counts(counters)
        run_main(cli_train.main, ["--data", f, "--batch_size", "256", "--epochs", "1",
                                  "--checkpoint_dir", f"{tmp}/{route}", *extra])
        hist[route], f32_launches = read_history(f"{tmp}/{route}"), read_counts(counters)
        log(f"  train CLI f32, {route} route: train-kernel launches {f32_launches}")
        if route == "fused" and min(f32_launches.values()) < 1:
            raise AssertionError(f"the f32 fused run left a train kernel unlaunched: "
                                 f"{f32_launches}")
        if route == "plain" and max(f32_launches.values()) > 0:
            raise AssertionError(f"the plain route launched a train kernel: {f32_launches}")
    worst = max(abs(a - b) / max(abs(b), 1e-6)
                for k in hist["plain"] if k != "epoch"
                for a, b in zip(hist["fused"][k], hist["plain"][k]))
    log(f"  train CLI f32, fused route against plain, 1 epoch of 2400 rows at B=256: "
        f"worst relative difference over the history {worst:.3e} "
        f"(tolerance {CLI_F32_RTOL})")
    if not worst <= CLI_F32_RTOL:
        raise AssertionError(f"fused and plain histories differ: {hist}")
    out["f32_worst"] = worst

    # serve what was trained: the tensor-core sampler, novelty against --data
    fused_generate.launches = fused_generate.tc_launches = 0
    fused_generate.core_launches = 0
    text = run_main(cli_generate.main, [
        "--checkpoint", f"{ck}/checkpoint_best.npz", "--data", s,
        "--num_molecules", "8192", "--batch_size", "8192", "--max_length", "64",
        "--target", "90", "--output", f"{tmp}/gen.npz"])
    out["sampler_launches"] = fused_generate.tc_launches
    if fused_generate.tc_launches < 1 or "Novelty vs training set" not in text:
        raise AssertionError(f"generate: {fused_generate.tc_launches} tensor-core "
                             f"launches; output {text[-500:]}")

    # a real SELFIES corpus: one epoch, the alphabet in the checkpoint, validity
    d, dk = f"{tmp}/d.json", f"{tmp}/dk"
    run_main(prepare.main, ["--drug_like", "2000", "--output", d])
    run_main(cli_train.main, ["--data", d, "--batch_size", "256", "--epochs", "1",
                              "--compute_dtype", "bfloat16", "--use_pallas",
                              "--checkpoint_dir", dk])
    with open(d) as fh:
        alphabet = json.load(fh)["alphabet"]
    if load_checkpoint(f"{dk}/checkpoint_best.npz")["data_stats"]["alphabet"] != alphabet:
        raise AssertionError("the checkpoint does not carry the corpus's alphabet")
    text = run_main(cli_generate.main, [
        "--checkpoint", f"{dk}/checkpoint_best.npz", "--num_molecules", "2048",
        "--batch_size", "2048", "--max_length", "64", "--target", "90",
        "--output", f"{tmp}/gen_d.json"])
    valid = re.search(r"Validity: ([\d.]+)%", text)
    if valid is None or "Molecule-level" not in text:
        raise AssertionError(f"generate on the SELFIES checkpoint: {text[-500:]}")
    log(f"  drug-like corpus, alphabet {len(alphabet)}: one epoch, then validity "
        f"{valid.group(1)}% [{smi}]")
    out["launches"] = launches
    return out


# phase 13: the TF=1 argmax's agreement with the plain route; the latent
# descent on the card against the CPU from the same z0 (300 Adam steps): its
# objective trajectory within OPT_ATOL, and z's coordinates within OPT_ATOL
# on no fewer (less OPT_Z_SLACK) than the CPU's own run from z0 moved up by
# one ulp. z is not a function of z0 to within rounding: Adam's steps are
# near lr * sign(g), so a coordinate whose gradient is at rounding level
# moves +-lr either way (the one-ulp run leaves 74-99% of z within 1e-4,
# by z0, while its objective trajectory agrees within 1e-7)
TF_AGREE = 0.99
OPT_ATOL = 1e-4
OPT_Z_SLACK = 0.05
EVAL_KERNELS = ("fused_encoder_fwd", "fused_train_decoder_fwd_logits", "fused_generate_tc")


def eval_counters() -> dict:
    """The counters of the kernels phase 13 drives: the encoder forward, the
    training decoder's logits forward and the sampler (both its kernels)."""
    from mlx_vae_tpu_torch.ops.fused_decoder import fused_generate

    c = {k: v for k, v in kernel_counters().items() if k in EVAL_KERNELS}
    c["fused_generate_tc"] = (fused_generate, "tc_launches")
    c["fused_generate_core"] = (fused_generate, "core_launches")
    return c


def phase_eval_shapes() -> None:
    """The encoder forward at B = 2 and 5 and the greedy sampler at B = 5
    and 9 (``interpolate``'s and ``encode``'s new shapes: a 2-row encoder
    grid, a partial 64-row sampler tile) against their plain versions, f32
    and bf16, with phase 6's and phase 3's tolerances."""
    from mlx_vae_tpu_torch.ops import fused_encoder as fe
    from mlx_vae_tpu_torch.ops import train_common as tc
    from mlx_vae_tpu_torch.ops.fused_decoder import (fused_generate, fused_generate_reference,
                                                     prepare_weights)

    L = 64
    for dtype in ("float32", "bfloat16"):
        cfg, params = train_model(dtype)
        we = tc.prepare_stack_weights(params["encoder"], cfg, with_head=False)
        for B in (2, 5):
            tok = train_inputs(cfg, B, L, seed=B)[0]
            k, p = fe.encoder_fwd(we, tok), fe.encoder_fwd_reference(we, tok)
            torch.cuda.synchronize()
            compare(f"{dtype} B={B} encoder fwd [h_last, hs, cs, gs]", k, p, dtype, [0.0, 0.0])
        cfg, params = default_model(dtype)
        w = prepare_weights(params, cfg, "cuda")
        for B in (5, 9):
            h0, cond, seeds, temps = inputs(cfg, params, B, 1.0, seed=B)
            lp = torch.empty((B, cfg.vocab_size), device="cuda")
            lk = torch.empty_like(lp)
            p = fused_generate_reference(w, h0, cond, seeds, temps, L, greedy=True, logits_out=lp)
            k = fused_generate(w, h0, cond, seeds, temps, L, greedy=True, logits_out=lk)
            torch.cuda.synchronize()
            first, rows = agreement(k, p)
            err = (lk - lp).abs().max().item()
            log(f"  sampler {dtype} B={B} greedy: first tokens {first:.4%}, rows {rows:.4%}, "
                f"first-step logits max |diff| {err:.3e}")
            if first < AGREE_FIRST or rows < AGREE_ROWS or not err <= LOGIT_ATOL[dtype]:
                raise AssertionError(f"sampler {dtype} B={B}: kernel and plain version part")
            check_eos(k, cfg)


def predictor_checkpoint(ck: str, path: str) -> None:
    """``ck`` with a predictor head (seeded init) added, written to ``path``
    with the port's checkpoint writer."""
    from mlx_vae_tpu_torch.cli.generate import infer_model_shape
    from mlx_vae_tpu_torch.config import ModelConfig
    from mlx_vae_tpu_torch.models.predictor import init_predictor_params
    from mlx_vae_tpu_torch.train.checkpoint import (build_checkpoint_host, load_checkpoint,
                                                    write_checkpoint)
    from mlx_vae_tpu_torch.train.optim import adam_init

    ckpt = load_checkpoint(ck)
    cfg = ModelConfig(**infer_model_shape(ckpt["params"]["decoder"]))
    pred = init_predictor_params(torch.Generator().manual_seed(13), cfg)
    params = {**ckpt["params"], "predictor": pred}
    opt = {**ckpt["opt_states"], "predictor": adam_init(pred)}
    write_checkpoint(path, build_checkpoint_host(ckpt["epoch"], params, opt, ckpt["history"],
                                                 ckpt["best_val_loss"], ckpt["data_stats"]))


def plain_setup(ck: str, dtype: str):
    """The checkpoint's encoder and decoder on the card, and its config on
    the plain route (``use_pallas=False``)."""
    from mlx_vae_tpu_torch.cli.generate import infer_model_shape
    from mlx_vae_tpu_torch.config import ModelConfig
    from mlx_vae_tpu_torch.train.checkpoint import load_checkpoint
    from mlx_vae_tpu_torch.utils.tree import params_from_numpy

    ckpt = load_checkpoint(ck)
    params = {k: params_from_numpy(ckpt["params"][k], "cuda") for k in ("encoder", "decoder")}
    cfg = ModelConfig(compute_dtype=dtype, use_pallas=False,
                      **infer_model_shape(ckpt["params"]["decoder"]))
    return params, cfg


def expect_counts(what: str, got: dict, want: dict) -> None:
    log(f"  {what}: launches {got}")
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def phase_eval_cli(smi: str, tmp: str) -> dict:
    """The port's encode, interpolate and optimize CLIs in this process on
    phase 12's corpus and best checkpoint (phase 13 of the docstring);
    returns each eval kernel's launches over the CLI runs and the times."""
    import numpy as np

    from mlx_vae_tpu_torch.cli import encode as cli_encode
    from mlx_vae_tpu_torch.cli import interpolate as cli_interpolate
    from mlx_vae_tpu_torch.cli import optimize as cli_optimize
    from mlx_vae_tpu_torch.cli.common import normalized_targets, resolve_property_stats
    from mlx_vae_tpu_torch.cli.generate import make_generate_fn
    from mlx_vae_tpu_torch.data import postproc
    from mlx_vae_tpu_torch.data.split import load_and_split
    from mlx_vae_tpu_torch.models.latent_eval import latent_statistics
    from mlx_vae_tpu_torch.models.latent_opt import optimize_latent
    from mlx_vae_tpu_torch.train.checkpoint import load_checkpoint
    from mlx_vae_tpu_torch.utils.tree import params_from_numpy

    if postproc._lib() is None:
        raise AssertionError("native/postproc.cpp did not build: the metrics would run numpy")
    s, ck, ckp = f"{tmp}/s.json", f"{tmp}/ck/checkpoint_best.npz", f"{tmp}/ck_pred.npz"
    predictor_checkpoint(ck, ckp)
    test = load_and_split(s, property_keys=("tpsa",))[2]
    tokens, cond = test.molecules, test.properties_normalized
    n = tokens.shape[0]
    counters = eval_counters()
    total = dict.fromkeys(EVAL_KERNELS, 0)
    out = {"encode": {}}

    def count(what: str, want: dict):
        got = read_counts(counters)
        expect_counts(what, got, {k: want.get(k, 0) for k in counters})
        for k in total:
            total[k] += got[k]

    mu32 = None
    for dtype in ("float32", "bfloat16"):
        reset_counts(counters)
        text, res = run_cli(cli_encode.main, [
            "--checkpoint", ck, "--data", s, "--split", "test", "--batch_size", "1024",
            "--compute_dtype", dtype, "--device", "cuda", "--output", f"{tmp}/lat_{dtype}.npz",
            "--report", f"{tmp}/rep_{dtype}.json"])
        nb = -(-n // 1024)
        count(f"encode {dtype}, {n} rows in {nb} batches of 1024",
              {"fused_encoder_fwd": nb, "fused_train_decoder_fwd_logits": nb,
               "fused_generate_tc": nb})
        params, cfg = plain_setup(ck, dtype)
        reset_counts(counters)
        plain = cli_encode.encode_split(params, cfg, torch.device("cuda"), tokens, cond, 1024)
        count(f"encode {dtype}, plain route", {})
        compare(f"encode {dtype} vs plain route [mu, logvar]",
                [torch.from_numpy(res["mu"]), torch.from_numpy(res["logvar"])],
                [torch.from_numpy(plain["mu"]), torch.from_numpy(plain["logvar"])], dtype,
                [0.0, 0.0])
        au = (latent_statistics(res["mu"], res["logvar"])["active_units"],
              latent_statistics(plain["mu"], plain["logvar"])["active_units"])
        tf = float((res["next_tokens"] == plain["next_tokens"]).mean())
        first, rows = agreement(torch.from_numpy(res["decoded"]),
                                torch.from_numpy(plain["decoded"]))
        log(f"  encode {dtype}: active units {au[0]} (plain {au[1]}); TF=1 argmax agrees on "
            f"{tf:.4%} of tokens; greedy from z=mu: first tokens {first:.4%}, rows {rows:.4%}")
        if au[0] != au[1] or tf < TF_AGREE or first < AGREE_FIRST or rows < AGREE_ROWS:
            raise AssertionError(f"encode {dtype}: the fused route parts from the plain route")
        if "first call loads" in text:
            raise AssertionError(f"encode {dtype}: a kernel build fell inside the timed parts")
        parts = {part: n / sec for part, sec in res["seconds"].items()}
        plain_parts = {part: n / sec for part, sec in plain["seconds"].items()}
        out["encode"][dtype] = {"mols_per_s": parts, "plain_mols_per_s": plain_parts,
                                "seconds": res["seconds"], "plain_seconds": plain["seconds"]}
        log(f"  encode {dtype}, {n} rows, mols/s by part (fused route; plain route): "
            + ", ".join(f"{k} {parts[k]:,.0f} ({plain_parts[k]:,.0f})" for k in parts)
            + f" [{smi}]")
        if dtype == "float32":
            mu32 = res["mu"]
        del params, plain, res
        torch.cuda.empty_cache()

    # interpolate: two endpoints encoded at B=2, nine waypoints decoded at B=9
    params, cfg = plain_setup(ck, "float32")
    reset_counts(counters)
    t0 = time.perf_counter()
    _, doc = run_cli(cli_interpolate.main, [
        "--checkpoint", ck, "--data", s, "--steps", "9", "--device", "cuda",
        "--output", f"{tmp}/interp.json"])
    out["interpolate_s"] = time.perf_counter() - t0
    count("interpolate --steps 9", {"fused_encoder_fwd": 1, "fused_generate_tc": 1})
    z_path = np.asarray(doc["z_path"], np.float32)
    compare("interpolate z_path[0], z_path[-1] vs encode's mu of test rows 0 and 1",
            [torch.from_numpy(z_path[[0, -1]])], [torch.from_numpy(mu32[:2])], "float32",
            [0.0, 0.0])
    t = np.linspace(0.0, 1.0, 9)[:, None].astype(np.float32)
    cond_path = (1 - t) * cond[0] + t * cond[1]
    g = torch.Generator(device="cuda").manual_seed(0)
    want = make_generate_fn(cfg, params["decoder"], tokens.shape[1], 1.0, greedy=True)(
        torch.from_numpy(z_path).cuda(), torch.from_numpy(cond_path).cuda(), g)
    first, rows = agreement(torch.tensor(doc["tokens"], device="cuda"), want)
    log(f"  interpolate: {out['interpolate_s']:.4f} s wall (CLI in process, checkpoint load "
        f"included); tokens vs plain route: first {first:.4%}, rows {rows:.4%} [{smi}]")
    if first < AGREE_FIRST or rows < AGREE_ROWS:
        raise AssertionError("interpolate: the fused route parts from the plain route")
    del params

    # optimize: 1024 candidates, 300 Adam steps, greedy and T=1.0
    ckpt = load_checkpoint(ckp)
    mean, std, _, _ = resolve_property_stats(s, False, ckpt, 1)
    target = torch.from_numpy(normalized_targets([90.0], mean, std, 1))
    pp = {"predictor": params_from_numpy(ckpt["params"]["predictor"], "cpu")}
    out["optimize"] = {}
    witness = None
    for mode, extra in (("greedy", ["--greedy"]), ("T=1.0", ["--temperature", "1.0"])):
        reset_counts(counters)
        _, doc = run_cli(cli_optimize.main, [
            "--checkpoint", ckp, "--data", s, "--target", "90", "--num_molecules", "1024",
            "--opt_steps", "300", "--max_length", "64", "--device", "cuda",
            "--output", f"{tmp}/opt.json", *extra])
        count(f"optimize {mode}", {"fused_generate_tc": 1})
        z = np.asarray(doc["z_optimized"], np.float32)
        zc, info = optimize_latent(pp, cfg, torch.from_numpy(doc["z0"]), target, steps=300)
        zc = zc.numpy()
        if witness is None:  # the CPU against itself, z0 moved up by one ulp
            zu = optimize_latent(pp, cfg, torch.from_numpy(np.nextafter(doc["z0"], np.inf)),
                                 target, steps=300)[0].numpy()
            witness = float((np.abs(zu - zc) <= OPT_ATOL).mean())
        dz = float(np.abs(z - zc).max())
        share = float((np.abs(z - zc) <= OPT_ATOL).mean())
        dobj = float(np.abs(doc["objective"] - info["objective"].numpy()).max())
        sec = doc["opt_seconds"]
        out["optimize"][mode] = {"seconds": sec, "ms_per_step": 1e3 * sec / 300, "dz": dz,
                                 "z_share": share, "ulp_witness_share": witness,
                                 "dobj": dobj}
        log(f"  optimize {mode}: objective {doc['objective_first']:.6f} -> "
            f"{doc['objective_final']:.6f}, max |z| {np.abs(z).max():.4f}; card vs CPU from "
            f"the same z0: max |d objective| {dobj:.3e} (tolerance {OPT_ATOL}), z within "
            f"{OPT_ATOL} on {share:.4%} of coordinates (the CPU against itself from z0 + 1 "
            f"ulp: {witness:.4%}; floor that less {OPT_Z_SLACK}), max |dz| {dz:.3e}; validity "
            f"{doc['validity']:.4f}, "
            f"uniqueness {doc['uniqueness']:.4f}; loop {sec:.4f} s, {1e3 * sec / 300:.3f} ms "
            f"a step [{smi}]")
        if not (doc["objective_final"] < doc["objective_first"] and np.abs(z).max() <= 3.0
                and dobj <= OPT_ATOL and share >= witness - OPT_Z_SLACK):
            raise AssertionError(f"optimize {mode}: descent check failed")
    out["launches"] = total
    return out


# ------------------------------------------------------------------ phase 15
# Multi-device on one card: the rank workers below run in processes that
# ``parallel/launch.py:spawn`` starts (they import this file again, under the
# name ``__mp_main__``, so nothing at its top level may start work).

DP_B, DP_L = 4096, 64      # the DP step's global batch: 2048 rows a rank
TP_B, TP_STEPS = 256, 3    # the tensor-parallel steps (f32, scan route)
# cli.train --data_parallel's batch: the 2,052-row validation split holds two
# (a split smaller than one batch evaluates to the +inf sentinel under DP)
DP_CLI_B = 1024
TP_TOL = 1e-4
DP_REL = 1e-6  # 15(b): the DP step's loss and grad_norm against the reference
DP_ULPS = 4    # 15(b): its post-Adam params, in units of the last place
DRYRUN_N = 4   # 15(d): the dry run's ranks, sharing cuda:0 ((2, 2) and (4, 1) meshes)


def dp_noise(cfg, rank: int, rows: int):
    """Data rank ``rank``'s noise for its ``rows`` rows (its own generator,
    seeded per rank as the trainer seeds it)."""
    from mlx_vae_tpu_torch.parallel.mesh import fold_seed
    from mlx_vae_tpu_torch.train.steps import draw_noise

    g = torch.Generator(device="cuda").manual_seed(fold_seed(7, rank))
    return draw_noise(g, cfg, rows, DP_L, 0.9)


def to_numpy(tree):
    from mlx_vae_tpu_torch.utils.tree import params_to_numpy
    return params_to_numpy(tree)


def rank_nccl_one(rank: int) -> dict:
    """15(a): ``make_dp_train_step`` on a one-rank NCCL mesh against
    ``train_step``, same params and noise: the mean over one rank is exact,
    so the two must agree bit for bit."""
    import torch.distributed as dist

    from mlx_vae_tpu_torch.config import TrainConfig
    from mlx_vae_tpu_torch.parallel.mesh import make_mesh
    from mlx_vae_tpu_torch.train.optim import adam_init
    from mlx_vae_tpu_torch.train.steps import make_dp_train_step, train_step
    from mlx_vae_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg, params = train_model("bfloat16")
    x, cond = synthetic_batch(cfg, DP_B, DP_L)
    tcfg = TrainConfig(batch_size=DP_B)
    noise = dp_noise(cfg, 0, DP_B)
    mesh = make_mesh(1)
    pa, pb = tree_map(torch.clone, params), tree_map(torch.clone, params)
    oa, ob = ({n: adam_init(v) for n, v in p.items()} for p in (pa, pb))
    _, _, ma = make_dp_train_step(mesh, cfg, tcfg)(pa, oa, x, cond, None, 0.05, 0.9, noise)
    _, _, mb = train_step(pb, ob, cfg, tcfg, x, cond, None, 0.05, 0.9, noise=noise)
    leaves = zip(tree_leaves(pa) + tree_leaves(oa), tree_leaves(pb) + tree_leaves(ob))
    diff = max(float((a.detach().float() - b.detach().float()).abs().max())
               for a, b in leaves)
    return {"backend": dist.get_backend(), "max_diff": diff,
            "metrics_equal": all(bool(torch.equal(ma[k], mb[k])) for k in mb),
            "loss": float(ma["total_loss"])}


def quiet(fn, *a):
    """``fn(*a)`` with its standard output captured; returns (result, the
    output's last lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        res = fn(*a)
    return res, out.getvalue().strip().splitlines()[-3:]


def rank_two(rank: int, tmp: str, corpus: str, ck: str) -> dict:
    """15(b) and (c) on one of two gloo ranks sharing the card."""
    import torch.distributed as dist

    from mlx_vae_tpu_torch.cli import encode as cli_encode
    from mlx_vae_tpu_torch.cli import generate as cli_generate
    from mlx_vae_tpu_torch.cli import train as cli_train
    from mlx_vae_tpu_torch.config import ModelConfig, TrainConfig
    from mlx_vae_tpu_torch.ops.fused_decoder import fused_generate
    from mlx_vae_tpu_torch.parallel.comm import grad_mean_
    from mlx_vae_tpu_torch.parallel.mesh import (gather_params, make_mesh, param_layout,
                                                 shard_params)
    from mlx_vae_tpu_torch.train import checkpoint as ckpt_io
    from mlx_vae_tpu_torch.train.optim import adam_init
    from mlx_vae_tpu_torch.train.steps import make_dp_eval_step, make_dp_train_step
    from mlx_vae_tpu_torch.utils.tree import tree_leaves, tree_map

    out = {}
    # (b) one DP step at full width through the train kernels
    cfg, params = train_model("bfloat16")
    x, cond = synthetic_batch(cfg, DP_B, DP_L)
    tcfg = TrainConfig(batch_size=DP_B)
    mesh = make_mesh(1)
    opt = {n: adam_init(v) for n, v in params.items()}
    step = make_dp_train_step(mesh, cfg, tcfg)
    counters = kernel_counters()
    reset_counts(counters)
    _, _, m = step(params, opt, x, cond, None, 0.05, 0.9, dp_noise(cfg, rank, DP_B // 2))
    torch.cuda.synchronize()
    out["step_launches"] = read_counts(counters)
    out["step_metrics"] = {k: float(v) for k, v in m.items()}
    out["step_params"] = to_numpy(params)
    gen = torch.Generator(device="cuda").manual_seed(3)
    reset_counts(counters)
    make_dp_eval_step(mesh, cfg, tcfg)(params, x, cond, gen, 0.05, 0.0)
    torch.cuda.synchronize()
    out["eval_launches"] = read_counts(counters)

    # printed: the DP step on two ranks sharing the card, and the gradient
    # mean's gloo all-reduce alone at the gradient tree's bytes
    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    out["step_ms"] = timed(lambda: step(params, opt, x, cond, gen, 0.05, 0.9), 5)
    grads = (tree_map(torch.zeros_like, params),)
    out["grad_bytes"] = sum(t.numel() * t.element_size() for t in tree_leaves(grads[0]))
    out["allreduce_ms"] = timed(lambda: grad_mean_(grads, mesh.data_group), 10)
    del params, opt, grads

    # the CLIs with --data_parallel, each in this rank's process group
    ck_dp = f"{tmp}/ck_dp"
    _, out["train_tail"] = quiet(cli_train.main, [
        "--data", corpus, "--batch_size", str(DP_CLI_B), "--compute_dtype", "bfloat16",
        "--use_pallas", "--epochs", "1", "--checkpoint_freq", "1", "--checkpoint_dir", ck_dp,
        "--data_parallel"])
    reset_sampler_counts()
    _, out["generate_tail"] = quiet(cli_generate.main, [
        "--checkpoint", ck, "--num_molecules", "8192", "--max_length", "64", "--greedy",
        "--output", f"{tmp}/gen_dp.npz", "--data_parallel"])
    out["sampler"] = {"tc": fused_generate.tc_launches, "core": fused_generate.core_launches}
    reset_counts(counters)
    res, out["encode_tail"] = quiet(cli_encode.main, [
        "--checkpoint", ck, "--data", corpus, "--split", "test", "--batch_size", "1024",
        "--output", f"{tmp}/lat_dp.npz", "--report", f"{tmp}/rep_dp.json", "--data_parallel"])
    out["encode"] = {k: res[k] for k in ("mu", "logvar")}
    out["encode_launches"] = read_counts(counters)

    # (c) tensor parallelism over the two ranks: a (1, 2) mesh, f32, scan route
    cfg_tp = ModelConfig(compute_dtype="float32")
    full = init_tp_params(cfg_tp)
    tp = make_mesh(2)
    layouts = param_layout(full, 2)
    params = shard_params(tp, full, layouts)
    opt = {n: adam_init(v) for n, v in params.items()}
    xt, ct = synthetic_batch(cfg_tp, TP_B, DP_L)
    gen = torch.Generator(device="cuda").manual_seed(9)
    step = make_dp_train_step(tp, cfg_tp, TrainConfig(batch_size=TP_B), layouts)
    out["tp_metrics"] = []
    for _ in range(TP_STEPS):
        _, _, m = step(params, opt, xt, ct, gen, 0.05, 0.9)
        out["tp_metrics"].append({k: float(v) for k, v in m.items()})
    opt_layouts = {n: {"step": False, "m": lay, "v": lay} for n, lay in layouts.items()}
    full_p, full_o = gather_params(tp, params, layouts), gather_params(tp, opt, opt_layouts)
    if rank == 0:
        ckpt_io.write_checkpoint(f"{tmp}/tp_ck.npz", ckpt_io.build_checkpoint_host(
            TP_STEPS - 1, full_p, full_o, {}))
        out["tp_params"] = to_numpy(full_p)
    out["tp_mesh"] = tp.shape
    return out


def init_tp_params(cfg):
    from mlx_vae_tpu_torch.bench import init_train_params
    return init_train_params(cfg, "cuda", 5)


def dp_reference(cfg, params, x, cond) -> tuple:
    """15(b)'s one-process reference: each half's loss and gradients on the
    card (its rank's noise), averaged, clipped, Adam."""
    from mlx_vae_tpu_torch.config import TrainConfig
    from mlx_vae_tpu_torch.train.optim import adam_init, adam_update, clip_by_global_norm
    from mlx_vae_tpu_torch.train.steps import _loss
    from mlx_vae_tpu_torch.utils.tree import tree_leaves, tree_map

    tcfg = TrainConfig(batch_size=DP_B)
    names = ["encoder", "decoder"]
    leaves = tree_leaves({n: params[n] for n in names})
    for leaf in leaves:
        leaf.requires_grad_(True)
    half, grads, totals = DP_B // 2, None, []
    for r in range(2):
        d = _loss(params, cfg, tcfg, x[r * half:(r + 1) * half],
                  cond[r * half:(r + 1) * half], dp_noise(cfg, r, half), 0.05)
        g = torch.autograd.grad(d["total_loss"], leaves)
        grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
        totals.append(float(d["total_loss"].detach()))
    flat = iter([g / 2 for g in grads])
    trees = tuple(tree_map(lambda _: next(flat), params[n]) for n in names)
    trees, norm = clip_by_global_norm(trees, tcfg.grad_clip)
    for n, g in zip(names, trees):
        adam_update(params[n], g, adam_init(params[n]), tcfg.learning_rate,
                    b1=tcfg.adam_b1, b2=tcfg.adam_b2, eps=tcfg.adam_eps,
                    bias_correction=tcfg.adam_bias_correction)
    return params, sum(totals) / 2, float(norm)


def phase_multi_device(smi: str, step_ms: float, tmp: str) -> dict:
    """Phase 15 (the docstring); ``tmp`` holds phase 12's corpus and
    checkpoints. Returns the launches of rows 1-6 per rank."""
    import math

    import numpy as np

    from mlx_vae_tpu_torch.cli import encode as cli_encode
    from mlx_vae_tpu_torch.cli import generate as cli_generate
    from mlx_vae_tpu_torch.cli import train as cli_train
    from mlx_vae_tpu_torch.config import ModelConfig, TrainConfig
    from mlx_vae_tpu_torch.parallel.dryrun import dryrun
    from mlx_vae_tpu_torch.parallel.launch import spawn
    from mlx_vae_tpu_torch.train.checkpoint import load_checkpoint
    from mlx_vae_tpu_torch.train.optim import adam_init
    from mlx_vae_tpu_torch.train.steps import draw_noise, train_step
    from mlx_vae_tpu_torch.utils.tree import tree_leaves

    corpus, ck = f"{tmp}/s.json", f"{tmp}/ck/checkpoint_best.npz"

    # (a) NCCL, one rank
    a = spawn(rank_nccl_one, 1, "cuda", "nccl", timeout=300)[0]
    log(f"  (a) {a['backend']}, world 1: make_dp_train_step vs train_step, default model bf16 "
        f"B={DP_B}: max |diff| over params and Adam states {a['max_diff']}, metrics equal "
        f"{a['metrics_equal']}, loss {a['loss']:.6f}")
    if a["backend"] != "nccl" or a["max_diff"] != 0.0 or not a["metrics_equal"]:
        raise AssertionError(f"15(a): the one-rank NCCL step is not bitwise train_step: {a}")

    # (b), (c) two gloo ranks sharing cuda:0
    t0 = time.perf_counter()
    r = spawn(rank_two, 2, "cuda", "gloo", args=(tmp, corpus, ck), timeout=900)
    log(f"  (b, c) two gloo ranks on cuda:0 done in {time.perf_counter() - t0:.1f}s")
    for i, ri in enumerate(r):
        log(f"  rank {i}: launches in the DP step {ri['step_launches']}; in the DP eval step "
            f"{ri['eval_launches']}; in cli.encode --data_parallel {ri['encode_launches']}")
        if min(ri["step_launches"][k] for k in TRAIN_KERNELS) < 1:
            raise AssertionError(f"15(b) rank {i}: a train kernel was not launched")
        if min(ri["eval_launches"][k] for k in TRAIN_KERNELS if "fwd" in k) < 1:
            raise AssertionError(f"15(b) rank {i}: the DP eval launched no forward kernel")
        if min(ri["encode_launches"][k] for k in ("fused_encoder_fwd",
                                                  "fused_train_decoder_fwd_logits")) < 1:
            raise AssertionError(f"15(b) rank {i}: encode launched no encoder or logits kernel")
    la = tree_leaves(r[0]["step_params"])
    if not all(np.array_equal(p, q) for p, q in zip(la, tree_leaves(r[1]["step_params"]))):
        raise AssertionError("15(b): the post-Adam params differ between the ranks")
    cfg, params = train_model("bfloat16")
    x, cond = synthetic_batch(cfg, DP_B, DP_L)
    ref, total, norm = dp_reference(cfg, params, x, cond)
    m = r[0]["step_metrics"]
    rel = max(abs(m["total_loss"] - total) / abs(total), abs(m["grad_norm"] - norm) / norm)
    # the same kernels at the same 2048-row shapes, and a mean of two that is
    # exact: the step must match to the last bits (a rank fed the other's rows
    # or noise moves the loss, and flips ~lr-sized Adam steps)
    ulps = max(float((np.abs(p - q) / np.spacing(np.abs(q))).max())
               for p, q in zip(la, tree_leaves(to_numpy(ref))))
    log(f"  (b) DP step vs the one-process reference: total {m['total_loss']:.6f} vs "
        f"{total:.6f}, grad_norm {m['grad_norm']:.6f} vs {norm:.6f} (worst rel {rel:.3e}, "
        f"tol {DP_REL}); post-Adam params: largest |diff| {ulps:g} ulp (tol {DP_ULPS})")
    if not (rel <= DP_REL and ulps <= DP_ULPS):
        raise AssertionError("15(b): the DP step parts from the one-process reference")
    del ref, params
    grad_mb = r[0]["grad_bytes"] / 2**20
    log(f"  (b) printed, not gated (the cost of the code path on one shared card, not a "
        f"scaling figure): DP step {r[0]['step_ms']:.2f} / {r[1]['step_ms']:.2f} ms on ranks "
        f"0 / 1 (2048 rows each) vs the one-rank step {step_ms:.2f} ms (4096 rows, phase 8); "
        f"gloo all_reduce of the {grad_mb:.2f} MiB gradient tree "
        f"{r[0]['allreduce_ms']:.2f} / {r[1]['allreduce_ms']:.2f} ms [{smi}]")

    # cli.train --data_parallel: one epoch; rank 0's checkpoints; a one-rank --resume
    ck_dp = f"{tmp}/ck_dp"
    h = read_history(ck_dp)
    files = sorted(f for f in os.listdir(ck_dp) if f.endswith(".npz"))
    log(f"  (b) cli.train --data_parallel: history {h['train_loss']} / {h['val_loss']}; "
        f"files {files}; rank 0: {r[0]['train_tail']}")
    if not (h["epoch"] == [0] and all(map(math.isfinite, h["train_loss"] + h["val_loss"]))):
        raise AssertionError(f"15(b): cli.train --data_parallel history {h}")
    if files != ["checkpoint_best.npz", "checkpoint_epoch_000.npz"]:
        raise AssertionError(f"15(b): checkpoints {files}")
    text = run_main(cli_train.main, [
        "--data", corpus, "--batch_size", str(DP_CLI_B), "--compute_dtype", "bfloat16",
        "--use_pallas", "--epochs", "2", "--checkpoint_freq", "1", "--checkpoint_dir", ck_dp,
        "--resume"])
    if "Resuming from epoch 1" not in text or read_history(ck_dp)["epoch"] != [0, 1]:
        raise AssertionError("15(b): the one-rank --resume did not load rank 0's checkpoint")

    # cli.generate --data_parallel: tensor-core sampler on each rank, greedy contract
    for i, ri in enumerate(r):
        if ri["sampler"]["tc"] < 1 or ri["sampler"]["core"] != 0:
            raise AssertionError(f"15(b) rank {i}: sampler launches {ri['sampler']}")
    run_main(cli_generate.main, ["--checkpoint", ck, "--num_molecules", "8192",
                                 "--max_length", "64", "--greedy", "--output",
                                 f"{tmp}/gen_one.npz"])
    two = torch.from_numpy(np.load(f"{tmp}/gen_dp.npz")["tokens"].astype(np.int64))
    one = torch.from_numpy(np.load(f"{tmp}/gen_one.npz")["tokens"].astype(np.int64))
    first, rows = agreement(two, one)
    log(f"  (b) cli.generate --data_parallel, 8192 greedy rows (2048 a rank a batch): sampler "
        f"launches per rank {[ri['sampler'] for ri in r]}; against the one-rank run first "
        f"tokens {first:.4%}, rows {rows:.4%} equal")
    if two.shape != one.shape or first < AGREE_FIRST or rows < AGREE_ROWS:
        raise AssertionError("15(b): data-parallel greedy parts from the one-rank run")

    # cli.encode --data_parallel against the one-rank run
    _, res = run_cli(cli_encode.main, [
        "--checkpoint", ck, "--data", corpus, "--split", "test", "--batch_size", "1024",
        "--output", f"{tmp}/lat_one.npz", "--report", f"{tmp}/rep_one.json"])
    compare("(b) cli.encode --data_parallel vs one rank [mu, logvar]",
            [torch.from_numpy(r[0]["encode"][k]) for k in ("mu", "logvar")],
            [torch.from_numpy(res[k]) for k in ("mu", "logvar")], "float32", [0.0, 0.0])

    # (c) against the one-rank plain route from the same params and noise
    tp_cfg = ModelConfig(compute_dtype="float32")
    params = init_tp_params(tp_cfg)
    opt = {n: adam_init(v) for n, v in params.items()}
    xt, ct = synthetic_batch(tp_cfg, TP_B, DP_L)
    gen = torch.Generator(device="cuda").manual_seed(9)
    worst = 0.0
    for s, mt in enumerate(r[0]["tp_metrics"]):
        noise = draw_noise(gen, tp_cfg, TP_B, DP_L, 0.9)
        _, _, mo = train_step(params, opt, tp_cfg, TrainConfig(batch_size=TP_B), xt, ct, None,
                              0.05, 0.9, noise=noise)
        worst = max([worst] + [abs(mt[k] - float(mo[k])) / max(abs(float(mo[k])), 1e-6)
                               for k in mo])
    pd = max(float(np.abs(p - q.detach().cpu().numpy()).max())
             for p, q in zip(tree_leaves(r[0]["tp_params"]), tree_leaves(params)))
    got = load_checkpoint(f"{tmp}/tp_ck.npz")
    keys = sorted((k, tuple(v.shape)) for k, v in _flat(got["params"]))
    want = sorted((k, tuple(v.shape)) for k, v in _flat(params))
    log(f"  (c) --model_parallel 2 ({r[0]['tp_mesh']}), f32 scan route, B={TP_B}, {TP_STEPS} "
        f"steps vs the one-rank plain route: worst rel diff over the scalars {worst:.3e}, "
        f"params max |diff| {pd:.3e} (tol {TP_TOL}); gathered checkpoint keys "
        f"{'equal' if keys == want else 'DIFFER'} ({len(keys)} leaves)")
    if not (worst <= TP_TOL and pd <= TP_TOL and keys == want):
        raise AssertionError("15(c): tensor parallelism parts from the one-rank route")

    # (d) the dry run on the card: four gloo ranks sharing cuda:0
    t0 = time.perf_counter()
    dry = dryrun(DRYRUN_N, "cuda", timeout=600)
    log(f"  (d) {dry[0]['line']} ({time.perf_counter() - t0:.1f}s)")
    for i, ri in enumerate(dry):
        got = ri["launches"]
        log(f"  (d) rank {i}: " + "; ".join(
            f"{tier} {part} {{{', '.join(f'{k}: {v}' for k, v in n.items() if v)}}}"
            for tier, parts in got.items() for part, n in parts.items()))
        silent = [f"{tier} {part}" for tier, parts in got.items()
                  for part, n in parts.items() if not any(n.values())]
        if silent or min(got["tiny"]["train"][k] for k in TRAIN_KERNELS) < 1 or min(
                got["scaled"]["train"][k] for k in ("seq_lstm_fwd", "seq_lstm_bwd")) < 1:
            raise AssertionError(f"15(d) rank {i}: a kernel of the dry run's path was not "
                                 f"launched (no launch in: {silent}): {got}")
    sampler = [ri["sampler"]["tc"] for ri in r]
    scaled = dry[0]["launches"]["scaled"]["train"]
    return {"fused_generate_tc": sampler[0], "fused_generate": r[0]["sampler"]["core"],
            "seq_lstm_fwd": scaled["seq_lstm_fwd"], "seq_lstm_bwd": scaled["seq_lstm_bwd"],
            **{k: r[0]["step_launches"][k] for k in TRAIN_KERNELS},
            "fused_train_decoder_fwd_logits": r[0]["encode_launches"][
                "fused_train_decoder_fwd_logits"]}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _flat(v, prefix + (k,))]
    return [(prefix, tree)]


# ------------------------------------------------------------------ phase 16
# 16(b): the first epochs of the curve-parity study's 50-epoch schedule, by
# mode; each epoch's ELBO must lie within the JAX seeds' mean +- CURVE_SDS
# sample SD at that epoch (benchmarks/elbo_compare.json, 16 seeds)
CURVE_EPOCHS = {"fixed_decoder": 3, "reference_zero_state": 1}
CURVE_SDS = 3.0
CURVE_SEED = 67
CURVE_KERNELS = TRAIN_KERNELS + ("lstm_gates_fwd", "lstm_gates_bwd")


def phase_curve(smi: str) -> dict:
    """Phase 16 (the docstring): the diagnostics on the card, then the
    study's first epochs in each mode. Returns the launches of rows 2-5 and
    9 over (b)."""
    import statistics

    from mlx_vae_tpu_torch.diagnostics import check_decoder_grads, data_diagnostic, loss_signs
    from mlx_vae_tpu_torch.studies import elbo_compare as ec

    t_phase = time.perf_counter()
    for name, mod in (("check_decoder_grads", check_decoder_grads),
                      ("data_diagnostic", data_diagnostic), ("loss_signs", loss_signs)):
        t0 = time.perf_counter()
        _, rc = run_cli(mod.main, ["--device", "cuda"])
        log(f"  (a) {name} --device cuda: exit {rc} ({time.perf_counter() - t0:.1f}s)")
        if rc != 0:
            raise AssertionError(f"16(a): {name} exited {rc}")

    with open(ec.REPO / "benchmarks" / "elbo_compare.json") as f:
        ref = json.load(f)
    cfg = ref["config"]
    t0 = time.perf_counter()
    train_ds, val_ds = ec.build_corpus(cfg["molecules"], False, cfg["max_length"])
    B, L = cfg["batch_size"], train_ds.max_length
    steps = math.ceil(len(train_ds) / B)
    log(f"  (b) the study's corpus: {cfg['molecules']} synthetic molecules, train {len(train_ds)} "
        f"({steps} batches of {B}), val {len(val_ds)}, L={L} "
        f"({time.perf_counter() - t0:.1f}s)")
    counters = {k: v for k, v in kernel_counters().items() if k in CURVE_KERNELS}
    total = dict.fromkeys(CURVE_KERNELS, 0)
    for mode, mcfg in ec.mode_configs(use_pallas=True).items():
        stop = CURVE_EPOCHS[mode]
        with tempfile.TemporaryDirectory() as ck:
            tcfg = ec.train_config(cfg["epochs"], B, CURVE_SEED, ck)
            reset_counts(counters)
            with contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(io.StringIO()):
                curve = ec.run(mode, CURVE_SEED, mcfg, tcfg, train_ds, val_ds, cfg["epochs"],
                               device="cuda", stop=stop)
            torch.cuda.synchronize()
            counts = read_counts(counters)
        for c in curve:
            e = c["epoch"]
            xs = [r[e]["elbo"] for r in ref["runs"][mode].values()]
            mu, sd = statistics.mean(xs), statistics.stdev(xs)
            ok = math.isfinite(c["elbo"]) and abs(c["elbo"] - mu) <= CURVE_SDS * sd
            log(f"  (b) {mode} seed {CURVE_SEED} epoch {e + 1}/{cfg['epochs']}: ELBO "
                f"{c['elbo']:.4f} against the JAX seeds' {mu:.4f} +- {CURVE_SDS:g} x "
                f"{sd:.4f} ({len(xs)} seeds): {'inside' if ok else 'OUTSIDE'}; val "
                f"{c['val_loss']:.4f}, MI {c['mutual_info']:.3f}; epoch {c['seconds']:.2f}s, "
                f"train pass {c['train_pass_s']:.2f}s = {c['train_pass_s'] * 1e3 / steps:.3f} ms a step "
                f"[{smi}]")
            if not ok:
                raise AssertionError(f"16(b): {mode} epoch {e}'s ELBO {c['elbo']} lies outside "
                                     f"the JAX band {mu} +- {CURVE_SDS} x {sd}")
        log(f"  (b) {mode}: launches over {stop} epoch(s) {counts}")
        zero = mode == "reference_zero_state"
        want_zero = TRAIN_KERNELS[2:] if zero else ("lstm_gates_fwd", "lstm_gates_bwd")
        used = [k for k in CURVE_KERNELS if k not in want_zero]
        bwd = {"fused_encoder_bwd": steps * stop,
               **({"lstm_gates_bwd": steps * stop * L * mcfg.num_layers} if zero else
                  {"fused_train_decoder_bwd": steps * stop})}
        if (any(counts[k] for k in want_zero) or min(counts[k] for k in used) < 1
                or any(counts[k] != n for k, n in bwd.items())):
            raise AssertionError(f"16(b): {mode}'s launches {counts}: expected none of "
                                 f"{want_zero}, some of each of {used}, backwards {bwd}")
        for k in CURVE_KERNELS:
            total[k] += counts[k]
    log(f"  phase 16 took {time.perf_counter() - t_phase:.1f}s")
    return total


CURVE_NOTE = ("phase 16(b): the curve-parity study's first epochs at B=256 (3 of "
              "fixed_decoder, 1 of reference_zero_state), train, true-loss, validation and "
              "latent-statistics passes")


# ------------------------------------------------------------------ phase 17
# models the whole-stack kernels refuse: a vocabulary beyond the kernels'
# 512 (the encoder on the sequence kernels, rows 7-8, the decoder on the
# scan through the gate pair, row 9) and a 9-layer stack
REFUSED_KERNELS = ("seq_lstm_fwd", "seq_lstm_bwd", "lstm_gates_fwd", "lstm_gates_bwd")
REFUSED_V = 600


def refused_model(dtype: str, seed: int = 0, **kw):
    """A model the whole-stack kernels refuse, on the fused route (so on
    the sequence kernels and the scan), and its params from ``seed``."""
    from mlx_vae_tpu_torch.bench import init_train_params
    from mlx_vae_tpu_torch.config import ModelConfig
    from mlx_vae_tpu_torch.models.decoder import train_decoder_route
    from mlx_vae_tpu_torch.models.encoder import encoder_route

    cfg = ModelConfig(compute_dtype=dtype, use_pallas=True, **kw)
    if (encoder_route(cfg), train_decoder_route(cfg)) != ("seq", "scan"):
        raise AssertionError(f"{kw}: routes {encoder_route(cfg)}, {train_decoder_route(cfg)}, "
                             "expected seq, scan")
    return cfg, init_train_params(cfg, "cuda", seed)


def refused_counts(what: str, got: dict, want: dict) -> None:
    """The launches of a refused model's run: ``want``'s kernels exactly
    where it gives a count, at least once where it gives None, and none of
    the whole-stack kernels."""
    log(f"  {what}: launches {got}")
    bad = {k: v for k, v in got.items()
           if (k in want and (v < 1 if want[k] is None else v != want[k]))
           or (k not in want and v != 0)}
    if bad:
        raise AssertionError(f"{what}: launches {got}, expected {want} and no other")


def phase_refused(smi: str, tmp: str) -> dict:
    """Phase 17 (the docstring): returns the launches of rows 7-9 over (a)'s
    counted steps and (b)'s training run."""
    import numpy as np

    from mlx_vae_tpu_torch.cli import encode as cli_encode
    from mlx_vae_tpu_torch.cli import train as cli_train
    from mlx_vae_tpu_torch.config import TrainConfig
    from mlx_vae_tpu_torch.data import prepare
    from mlx_vae_tpu_torch.data.split import load_and_split
    from mlx_vae_tpu_torch.ops.fused_decoder import fused_generate
    from mlx_vae_tpu_torch.train.optim import adam_init
    from mlx_vae_tpu_torch.train.steps import train_step

    t_phase = time.perf_counter()
    counters = kernel_counters()
    counters["fused_generate_tc"] = (fused_generate, "tc_launches")
    counters["fused_generate_core"] = (fused_generate, "core_launches")
    total = dict.fromkeys(REFUSED_KERNELS, 0)

    # (a) one counted step, then one step against the plain route, V=600
    # (B=512) and 9 layers (B=256)
    for kw, B, dtypes in ((dict(vocab_size=REFUSED_V), 512, ("bfloat16", "float32")),
                          (dict(num_layers=9), 256, ("bfloat16",))):
        L = 64
        cfg, params = refused_model("bfloat16", seed=7, **kw)
        x, cond = synthetic_batch(cfg, B, L)
        opt = {k: adam_init(v) for k, v in params.items()}
        gen = torch.Generator(device="cuda").manual_seed(2)
        reset_counts(counters)
        t0 = time.perf_counter()
        _, _, m = train_step(params, opt, cfg, TrainConfig(batch_size=B), x, cond, gen, 0.05,
                             0.9)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = read_counts(counters)
        n = cfg.num_layers
        tag = ", ".join(f"{k}={v}" for k, v in kw.items())
        refused_counts(f"(a) {tag}, bf16, B={B} L={L}, one step ({ms:.1f} ms with the first "
                       f"call's setup; total loss {float(m['total_loss']):.4f})", got,
                       {"seq_lstm_fwd": n, "seq_lstm_bwd": n, "lstm_gates_fwd": L * n,
                        "lstm_gates_bwd": L * n})
        if not math.isfinite(float(m["total_loss"])):
            raise AssertionError(f"(a) {tag}: the loss is not finite")
        for k in total:
            total[k] += got[k]
        del params, opt, m
        torch.cuda.empty_cache()
        fused_vs_plain(f"(a) {tag} B={B}", lambda dt, kw=kw: refused_model(dt, seed=3, **kw),
                       x, cond, B, L, dtypes)

    # (b) data.prepare and one bf16 epoch of cli.train --use_pallas at V=600
    s, ck = f"{tmp}/v600.json", f"{tmp}/ck600"
    run_main(prepare.main, ["--synthetic", "2000", "--vocab_size", str(REFUSED_V),
                            "--output", s])
    reset_counts(counters)
    t0 = time.perf_counter()
    run_main(cli_train.main, ["--data", s, "--vocab_size", str(REFUSED_V), "--batch_size",
                              "256", "--compute_dtype", "bfloat16", "--use_pallas",
                              "--epochs", "1", "--checkpoint_dir", ck])
    got = read_counts(counters)
    h = read_history(ck)
    log(f"  (b) cli.train --use_pallas, V={REFUSED_V}, 2,000 molecules, B=256, bf16, one "
        f"epoch: {time.perf_counter() - t0:.1f}s; history {h} [{smi}]")
    refused_counts("(b) cli.train", got, dict.fromkeys(REFUSED_KERNELS))
    if h["epoch"] != [0] or not all(math.isfinite(v) for k in h for v in h[k]):
        raise AssertionError(f"(b) the history: {h}")
    if not os.path.exists(f"{ck}/checkpoint_best.npz"):
        raise AssertionError("(b) no checkpoint_best.npz")
    for k in total:
        total[k] += got[k]

    # (c) cli.encode on that checkpoint (f32, the CLI's default), against
    # the plain route on the card
    best = f"{ck}/checkpoint_best.npz"
    reset_counts(counters)
    _, res = run_cli(cli_encode.main, ["--checkpoint", best, "--data", s, "--split", "test",
                                       "--batch_size", "256", "--device", "cuda",
                                       "--output", f"{tmp}/lat600.npz",
                                       "--report", f"{tmp}/rep600.json"])
    refused_counts("(c) cli.encode", read_counts(counters),
                   {"seq_lstm_fwd": None, "lstm_gates_fwd": None})
    notes = res["notes"]
    log(f"  (c) the kernels' notes: {notes}")
    if not ("fused_seq_lstm" in notes["encode"] and "fused_lstm_gates" in notes["next_token"]
            and "fused_lstm_gates" in notes["greedy"]
            and "fused_generate" not in notes["greedy"]):
        raise AssertionError(f"(c) the notes name other kernels than the route's: {notes}")
    test = load_and_split(s, property_keys=("tpsa",))[2]
    params, pcfg = plain_setup(best, "float32")
    plain = cli_encode.encode_split(params, pcfg, torch.device("cuda"), test.molecules,
                                    test.properties_normalized, 256)
    first, rows = agreement(torch.from_numpy(res["next_tokens"]),
                            torch.from_numpy(plain["next_tokens"]))
    tok = float(np.mean(res["next_tokens"] == plain["next_tokens"]))
    greedy = agreement(torch.from_numpy(res["decoded"]), torch.from_numpy(plain["decoded"]))
    log(f"  (c) {len(test.molecules)} test rows: the TF=1 argmax against the plain route: "
        f"first tokens {first:.4%}, rows {rows:.4%}, tokens {tok:.4%}; greedy from z=mu: "
        f"first tokens {greedy[0]:.4%}, rows {greedy[1]:.4%}; mu max |diff| "
        f"{np.abs(res['mu'] - plain['mu']).max():.3e}")
    if first < AGREE_FIRST or rows < AGREE_ROWS:
        raise AssertionError("(c) the TF=1 argmax parts from the plain route")
    log(f"  phase 17 took {time.perf_counter() - t_phase:.1f}s")
    return total


REFUSED_NOTE = ("phase 17: the V=600 (B=512) and 9-layer (B=256) bf16 counted steps and "
                "the V=600 cli.train epoch (2,000 molecules, B=256)")


# ------------------------------------------------------------------ phase 18
# the quality-parity study cut to one seed, 4,500 molecules and 2 epochs
QUALITY_SEED = 67
QUALITY_MOLECULES = 4500


def quality_config() -> dict:
    from mlx_vae_tpu_torch.studies import quality_parity as qp

    return {**qp.RECORD_CONFIG, "epochs": 2, "molecules": QUALITY_MOLECULES,
            "bulk_molecules": 50000}


def finite_numbers(tree, path="") -> list:
    """The paths of every number in ``tree`` that is not finite."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in finite_numbers(v, f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in finite_numbers(v, f"{path}[{i}]")]
    if isinstance(tree, float) and not math.isfinite(tree):
        return [path]
    return []


def phase_quality(smi: str) -> dict:
    """Phase 18 (the docstring); returns the launches of rows 1-5."""
    from mlx_vae_tpu_torch.ops.fused_decoder import fused_generate
    from mlx_vae_tpu_torch.studies import quality_parity as qp

    t_phase = time.perf_counter()
    cfg = quality_config()
    counters = {k: v for k, v in kernel_counters().items() if k in TRAIN_KERNELS}
    counters["fused_generate_tc"] = (fused_generate, "tc_launches")
    counters["fused_generate"] = (fused_generate, "core_launches")
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "corpus.json")
        sha = qp.make_corpus(QUALITY_MOLECULES, data)
        reset_counts(counters)
        with contextlib.redirect_stdout(io.StringIO()):
            rec = qp.run_seed(cfg, QUALITY_SEED, data, tmp, "cuda")
        torch.cuda.synchronize()
        counts = read_counts(counters)
    log(f"  corpus {QUALITY_MOLECULES} molecules (sha256 {sha[:16]}...); seed {QUALITY_SEED}; "
        f"launches {counts}")
    for tag, t in rec["train"].items():
        h = t["history"]
        log(f"  cli.train {tag}: {t['wall_s']:.1f}s, dispatches {t['dispatches']}, final train "
            f"{h['train_loss'][-1]:.4f} val {h['val_loss'][-1]:.4f} [{smi}]")
    studies = {}
    for sel, ev in (("best", rec), ("final", rec["final_checkpoint"])):
        epochs = {tag: t["best_epoch"] if sel == "best" else t["history"]["epoch"][-1]
                  for tag, t in rec["train"].items()}
        log(f"  the {sel} checkpoints (epochs {epochs}):")
        for name in ("conditioning", "latent_opt"):
            doc = studies[f"{sel} {name}"] = ev[name]
            rows = [(r["target"], r["mae"]) if name == "conditioning" else
                    (r["target"], r["conditional"]["mae"], r["optimized"]["mae"],
                     r["optimized"]["surrogate_pred_after"]) for r in doc["results"]]
            log(f"    {name}: route {doc['route']}, tokens on {doc['tokens_device']}; "
                f"(target, MAE{', MAE optimized, surrogate' if name == 'latent_opt' else ''}) "
                f"{rows}")
        r = ev["reconstruction"]
        log(f"    cli.encode: " + ", ".join(f"{k} {r[k]}" for k in qp.RECON_KEYS)
            + f"; seconds {r['seconds']}")
        for name in ("bulk", "greedy"):
            g = ev[name]
            log(f"    cli.generate {name}: {g['num_molecules']} molecules, validity "
                f"{g['validity']:.4f}, {g['mols_per_sec']:,.0f} mols/s (generation), metrics "
                f"on the host {g['metrics_s']:.2f}s, wall {g['wall_s']:.1f}s [{smi}]")
    for name, doc in rec["conditioning_reruns"].items():
        studies[f"rerun {name}"] = doc
        log(f"  conditioning rerun on the best plain checkpoint, {name}: route {doc['route']}, "
            f"MAE {[r['mae'] for r in doc['results']]}")
    bad = finite_numbers(rec)
    if bad:
        raise AssertionError(f"18: numbers not finite at {bad}")
    for name, doc in studies.items():
        want = ({"sampler": "scan", "kernel": None} if name == "rerun scan" else
                {"sampler": "fused", "kernel": "tc::gen_tc_kernel"})
        if {k: doc["route"][k] for k in want} != want:
            raise AssertionError(f"18: {name} ran on {doc['route']}, expected {want}")
        devices = doc["tokens_device"] + doc.get("latent_device", [])
        if not devices or any(not d.startswith("cuda") for d in devices):
            raise AssertionError(f"18: {name}'s tensors on {devices}")
    if min(t["steps_per_dispatch_taken"] for t in rec["train"].values()) < 2:
        raise AssertionError(f"18: no multi-step dispatch: "
                             f"{[t['dispatches'] for t in rec['train'].values()]}")
    if counts["fused_generate"] != 0 or min(v for k, v in counts.items()
                                            if k != "fused_generate") < 1:
        raise AssertionError(f"18: launches {counts}: expected rows 1-5 and no CUDA-core "
                             "sampler")
    log(f"  phase 18 took {time.perf_counter() - t_phase:.1f}s")
    return counts


QUALITY_NOTE = ("phase 18: the quality-parity study cut to one seed, 4,500 molecules and 2 "
                "bf16 epochs at B=1024: two cli.train runs, both studies at 2048 rows a target, "
                "cli.encode of the test split, cli.generate of 50,000 and 8192 greedy molecules")


# kernel: (source, the TPU kernel it replaces, its row in phase 11's times,
# the timed shape)
# ------------------------------------------------------------------ phase 19

# (name, dtype, widths, batches): the configs phase 19(a) holds the step
# route at, against the plain version; "smallest" is filled in from the rule
STEP_CHECKS = (
    ("scaled", "bfloat16", SCALED, (256, 2048)),
    ("scaled", "float32", SCALED, (256, 2048)),
    ("H=768 n=2", "bfloat16", dict(hidden_dim=768), (256, 2048)),
    ("H=256 n=2 V=300", "float32", dict(vocab_size=300), (256, 2048)),
    ("smallest", "bfloat16", None, (256, 2048)),
    ("smallest", "float32", None, (256, 2048)),
)
STEP_MODES = (("greedy", 1.0, {"greedy": True}), ("T=0.8", 0.8, {}),
              ("top_k=6 top_p=0.8", 0.8, {"top_k": 6, "top_p": 0.8}))
STEP_TIMED = (256, 2048, 8192)  # 19(c)'s batches at the scaled model
# 19(a), bf16 with top-k / top-p: the row floor where the CUDA-core kernel,
# an independent implementation, agrees with the plain version on fewer
# rows on the same inputs: its agreement less this margin. In bf16 an f32
# summation order moves some h across a bf16 rounding boundary, which moves
# the logits by ~1e-5, and a random-init model's kept set has its k-th gap
# under 1e-4 in ~2% of a row's steps, so every implementation parts from
# the plain version on some truncated rows: at H=768 the CUDA-core kernel
# agrees on 87.9-97.4% of rows over two init seeds (PERF.md), where
# the step route fell short of it by at most 0.9 points; 0.02 is about
# twice that.
TRUNC_BF16_MARGIN = 0.02


def steps_smallest(dtype: str) -> dict:
    """The smallest hidden width the route sends to the step route at the
    default's other widths (E=128, C=1, V=80, n=2)."""
    from mlx_vae_tpu_torch.config import ModelConfig
    from mlx_vae_tpu_torch.ops.fused_decoder import STEPS_MIN_H, fused_generate_route

    H = STEPS_MIN_H[dtype]
    while fused_generate_route(ModelConfig(hidden_dim=H, compute_dtype=dtype)) != "steps":
        H += 1
    return dict(hidden_dim=H)


def steps_model(dtype: str, widths: dict, seed: int = 0):
    """A random-init decoder at ``widths`` on the card with its prepared
    weights: ``(cfg, params, weights)``."""
    from mlx_vae_tpu_torch.config import ModelConfig
    from mlx_vae_tpu_torch.models.decoder import init_decoder_params
    from mlx_vae_tpu_torch.ops.fused_decoder import prepare_weights
    from mlx_vae_tpu_torch.utils.tree import params_from_numpy, params_to_numpy

    cfg = ModelConfig(compute_dtype=dtype, **widths)
    gen = torch.Generator().manual_seed(seed)
    params = params_from_numpy(params_to_numpy(init_decoder_params(gen, cfg)), "cuda")
    return cfg, params, prepare_weights(params, cfg, "cuda")


def phase_steps_vs_plain() -> tuple:
    """19(a): the step route, taken by config, against the plain version at
    every ``STEP_CHECKS`` config, batch and mode: the first step's scaled
    logits within ``LOGIT_ATOL``, >= 99.0% first tokens and >= 97.0% rows, a
    second call equal bit for bit, tokens in range and pad after EOS,
    truncated first tokens in the plain kept set; at B=2048, T=0.8, its
    seed blocks reversed in the batch and blocks alone at B=256 bitwise
    unchanged. In bf16 with top-k / top-p the CUDA-core kernel (forced) runs
    on the same inputs too, and the row floor is the lower of 97.0% and its
    agreement less ``TRUNC_BF16_MARGIN``. Returns (largest |kernel - plain|
    logit, largest share of rows that differed)."""
    from mlx_vae_tpu_torch.ops.fused_decoder import (
        fused_generate, fused_generate_reference, fused_generate_route)
    from mlx_vae_tpu_torch.ops.sampling import truncate_logits_bisect

    L, worst = 64, [0.0, 0.0]
    for name, dtype, widths, batches in STEP_CHECKS:
        widths = widths if widths is not None else steps_smallest(dtype)
        cfg, params, w = steps_model(dtype, widths)
        if fused_generate_route(cfg) != "steps":
            raise AssertionError(f"{name} {dtype} should take the step route")
        what = f"{name} ({widths}) {dtype}"
        for B in batches:
            for mode, temp, kw in STEP_MODES:
                h0, cond, seeds, temps = inputs(cfg, params, B, temp, seed=7)
                lp = torch.empty((B, cfg.vocab_size), device="cuda")
                lk = torch.empty_like(lp)
                p = fused_generate_reference(w, h0, cond, seeds, temps, L, logits_out=lp, **kw)
                before = fused_generate.step_launches
                k = fused_generate(w, h0, cond, seeds, temps, L, logits_out=lk, **kw)
                again = fused_generate(w, h0, cond, seeds, temps, L, **kw)
                torch.cuda.synchronize()
                if fused_generate.step_launches != before + 2:
                    raise AssertionError(f"{what}: the calls did not take the step route")
                first, rows = agreement(k, p)
                err = (lk - lp).abs().max().item()
                worst = [max(worst[0], err), max(worst[1], 1.0 - rows)]
                line = (f"  steps {what} B={B} {mode}: first tokens {first:.4%}, rows "
                        f"{rows:.4%}, first-step logits max |diff| {err:.3e}, repeat "
                        f"{'bitwise equal' if torch.equal(k, again) else 'DIFFERS'}")
                floor = AGREE_ROWS
                if "top_k" in kw:
                    kept = truncate_logits_bisect(lp, cfg.vocab_size, 6, 0.8) > -0.5e30
                    inside = kept[torch.arange(B, device="cuda"),
                                  k[:, 0].long()].float().mean().item()
                    line += f", first tokens in the plain kept set {inside:.4%}"
                    if inside < 1.0:
                        raise AssertionError("a truncated first token lies outside the kept set")
                    if dtype == "bfloat16":
                        core = fused_generate(w, h0, cond, seeds, temps, L, kernel="cuda_core",
                                              **kw)
                        core_rows = agreement(core, p)[1]
                        floor = min(AGREE_ROWS, core_rows - TRUNC_BF16_MARGIN)
                        line += (f"; the CUDA-core kernel on the same inputs: rows "
                                 f"{core_rows:.4%}, so the row floor is {floor:.4%}")
                log(line)
                if not torch.equal(k, again):
                    raise AssertionError(f"{what} B={B} {mode}: a second call differs")
                if first < AGREE_FIRST or rows < floor:
                    raise AssertionError(f"{what} B={B} {mode}: agreement below "
                                         f"{AGREE_FIRST:.0%} / {floor:.2%}")
                if not err <= LOGIT_ATOL[dtype]:
                    raise AssertionError(f"{what} B={B} {mode}: logits differ by {err} > "
                                         f"{LOGIT_ATOL[dtype]}")
                if not ((k >= 0) & (k < cfg.vocab_size)).all():
                    raise AssertionError("token id out of range")
                check_eos(k, cfg)
                if mode == "T=0.8" and B > 256:
                    check_seed_blocks(w, h0, cond, seeds, temps, k, "steps", f"{what} B={B}")
    return tuple(worst)


def steps_checkpoint(path: str):
    """A random-init scaled-model checkpoint with stats and an alphabet, as
    ``default_checkpoint`` writes the default one: ``(cfg, path)``."""
    from mlx_vae_tpu_torch.data.prepare import make_synthetic_dataset
    from mlx_vae_tpu_torch.train.checkpoint import build_checkpoint_host, write_checkpoint

    cfg, params, _ = steps_model("bfloat16", SCALED, seed=8)
    alphabet = make_synthetic_dataset(n=4, vocab_size=cfg.vocab_size)["alphabet"]
    write_checkpoint(path, build_checkpoint_host(
        0, {"encoder": {}, "decoder": params}, {"encoder": {}, "decoder": {}}, {},
        data_stats={"properties_mean": [60.0], "properties_std": [25.0],
                        "alphabet": alphabet}))
    return cfg, path


def phase_steps_served(tmp: str) -> dict:
    """19(b): a random-init scaled bf16 checkpoint served by ``cli.serve``
    (tiers 256 and 2048) and sampled by ``cli.generate``: the same seed
    gives the same tokens, /health names the route, and the sampler
    launches, counted from 0 just before, are step-route calls alone.
    Returns the step-route calls of each run."""
    import numpy as np

    from mlx_vae_tpu_torch.cli import generate as cli_generate
    from mlx_vae_tpu_torch.ops.fused_decoder import fused_generate

    cfg, ck = steps_checkpoint(f"{tmp}/checkpoint_scaled.npz")
    ready, thread, base, up = start_server([
        "--checkpoint", ck, "--batch_sizes", "256,2048", "--max_length", "64",
        "--compute_dtype", "bfloat16"])
    try:
        wait_warm(ready)
        reset_sampler_counts()
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        if health["sampler"] != "fused" or health["sampler_route"] != "steps":
            raise AssertionError(f"scaled checkpoint: /health sampler {health['sampler']}, "
                                 f"route {health['sampler_route']}")
        req = {"num_molecules": 1500, "target": [90.0], "temperature": 0.8, "seed": 11,
               "return_tokens": True}
        _, a = post(base, req)
        _, b = post(base, req)
        _, g = post(base, {**req, "num_molecules": 200, "greedy": True})
        toks = np.asarray(a["tokens"])
        if a["tokens"] != b["tokens"] or toks.shape != (1500, 64) or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size or np.asarray(g["tokens"]).shape != (200, 64):
            raise AssertionError("scaled checkpoint: same-seed tokens differ, or a bad token "
                                 "matrix")
        served = fused_generate.step_launches
        if served < 1 or fused_generate.core_launches or fused_generate.tc_launches \
                or fused_generate.launches != served:
            raise AssertionError(f"scaled checkpoint served: {served} step-route, "
                                 f"{fused_generate.core_launches} CUDA-core, "
                                 f"{fused_generate.tc_launches} tensor-core calls")
        log(f"  served scaled bf16 checkpoint: /health sampler={health['sampler']} "
            f"route={health['sampler_route']}; 1500 molecules at {a['mols_per_sec']:.1f} "
            f"mols/s ({a['passes']} pass(es)), same seed -> same tokens; {served} step-route "
            f"calls, 0 CUDA-core, 0 tensor-core")
    finally:
        stop_server(ready, thread)
    reset_sampler_counts()
    outs = []
    for i in range(2):
        text = run_main(cli_generate.main, [
            "--checkpoint", ck, "--num_molecules", "4096", "--batch_size", "2048",
            "--max_length", "64", "--target", "90", "--compute_dtype", "bfloat16",
            "--output", f"{tmp}/gen_scaled_{i}.npz"])
        outs.append(np.load(f"{tmp}/gen_scaled_{i}.npz")["tokens"])
    gen = fused_generate.step_launches
    if gen < 2 or fused_generate.core_launches or fused_generate.tc_launches \
            or not np.array_equal(outs[0], outs[1]) or "Validity" not in text:
        raise AssertionError(f"cli.generate on the scaled checkpoint: {gen} step-route calls, "
                             f"{fused_generate.core_launches} CUDA-core, "
                             f"{fused_generate.tc_launches} tensor-core; same tokens twice: "
                             f"{np.array_equal(outs[0], outs[1])}")
    log(f"  cli.generate, scaled bf16 checkpoint, 4096 molecules twice (B=2048): {gen} "
        f"step-route calls, 0 CUDA-core, 0 tensor-core, the same tokens both times")
    return {"serve": served, "generate": gen}


def phase_steps_times(smi: str) -> dict:
    """19(c): at the scaled model (V=80), B = 256 / 2048 / 8192, L=64,
    T=0.8, f32 and bf16: the step route, the CUDA-core kernel (forced) and
    the plain version in turns (``bench_sampler_routes.bench``), each with
    its bound; one B=8192 bf16 step-route pass under ``torch.profiler``.
    Returns the records by "dtype B=..." and the profile."""
    from mlx_vae_tpu_torch.bench_sampler_routes import bench
    from mlx_vae_tpu_torch.ops.fused_decoder import fused_generate

    out = {}
    for dtype in ("bfloat16", "float32"):
        for rec in bench(f"{SCALED['hidden_dim']}:{SCALED['num_layers']}:80", dtype, STEP_TIMED,
                         ["steps", "cuda_core", "plain"], 64, 0.8, 2, 0.5, 2.0, 0, smi):
            out.setdefault(f"{dtype} B={rec['B']}", {})[rec["route"]] = rec
    for key, r in out.items():
        ratio = r["steps"]["ms"] / r["cuda_core"]["ms"]
        log(f"  {key}: steps {r['steps']['ms']:.3f} ms = {ratio:.3f}x the CUDA-core kernel "
            f"({r['cuda_core']['ms']:.3f}), "
            f"{r['steps']['ms'] / r['plain']['ms']:.3f}x plain ({r['plain']['ms']:.3f}); bound "
            f"{r['steps']['bound_ms']:.3f} ({r['steps']['bound_by']}) [{smi}]")
    cfg, params, w = steps_model("bfloat16", SCALED)
    h0, cond, seeds, temps = inputs(cfg, params, 8192, 0.8, seed=3)
    out["profile"] = profile_step(
        "one B=8192 bf16 step-route pass, scaled model",
        lambda: fused_generate(w, h0, cond, seeds, temps, 64), smi)
    names = out["profile"]["kernels"]
    if not any("gen_head_kernel" in k for k in names) or \
            not any("gen_step_tma_kernel" in k for k in names) or \
            any(x in k for k in names
                for x in ("fused_generate_kernel", "gen_tc_kernel", "seq_fwd_step_kernel",
                          "gen_step_kernel")):
        raise AssertionError(f"the step route's profile shows {sorted(names)}")
    out["launch"] = phase_steps_launch(smi)
    return out


def phase_steps_launch(smi: str) -> dict:
    """19(c), per launch: the bf16 step kernel's device ms at layer 0 and at
    layers 1-3 of the scaled model, B = 256 / 2048 / 8192 (medians of one
    pass under the profiler, ``bench_step_launch.launches``), beside each
    launch's bound (its FLOP at 989 TFLOP/s) and the L2 bytes that the
    launch plan models (an input of the bound, not measured),
    ``torch.lstm_cell``'s bf16 step at I = H = 1024 (the library yardstick
    of a layer-1..3 launch; never called by the port), and the L2 read rate
    a kernel gets from a 16 MB resident buffer."""
    from mlx_vae_tpu_torch import bench_step_launch as bsl
    from mlx_vae_tpu_torch.config import ModelConfig
    from mlx_vae_tpu_torch.ops.fused_decoder import steps_launch_plan

    spec = f"{SCALED['hidden_dim']}:{SCALED['num_layers']}:80"
    recs = bsl.launches(spec, STEP_TIMED, smi)
    cfg = ModelConfig(compute_dtype="bfloat16", **SCALED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for r in recs:
        plan = steps_launch_plan(cfg, r["B"], 64, sms)
        r["plan"] = {"layer0_l2_bytes": plan[1]["l2_bytes"], "upper_l2_bytes": plan[2]["l2_bytes"],
                     "kernel": plan[1]["kernel"]}
        if r["upper_ms"] is None or not any("gen_step_tma_kernel" in k for k in r["names"]):
            raise AssertionError(f"19(c): no bf16 step launch timed at B={r['B']}: {r['names']}")
    lib = bsl.library_ms(SCALED["hidden_dim"], STEP_TIMED, smi)
    for r in recs:
        log(f"  B={r['B']}: a layer-1..3 launch {r['upper_ms']:.4f} ms against torch.lstm_cell "
            f"{lib[r['B']]:.4f} ms and its bound {r['upper_bound_ms']:.4f} ms; layer 0 "
            f"{r['layer0_ms']:.4f} ms (bound {r['layer0_bound_ms']:.4f}); the plan's L2 bytes "
            f"a launch {r['plan']['upper_l2_bytes']:.4g} / {r['plan']['layer0_l2_bytes']:.4g}; "
            f"{r['plan']['kernel']} [{smi}]")
    return {"launches": recs, "library_ms": lib, "l2_tb_s": bsl.l2_rate(smi)}


def phase_steps_digest(smi: str) -> dict:
    """19(d): the step route's bf16 digests (``digest_steps``: tokens and
    first-step logits at phase 19(a)'s bf16 configs and modes, B = 256 and
    2048, each beside its inputs' hash), printed for a comparison with the
    same module run in another tree."""
    from mlx_vae_tpu_torch.digest_steps import digest

    out = digest((256, 2048))
    for k, v in out.items():
        log(f"  digest {k}: inputs {v['inputs']} tokens {v['tokens']} logits {v['logits']}")
    log(f"  19(d): {len(out)} step-route digests [{smi}]")
    return out


def phase_steps(smi: str) -> dict:
    """Phase 19 (the docstring): (a), (b) with the counters reset just
    before the served runs and read just after, (c)."""
    log("[19 step-major sampler] (a) the step route vs plain at the scaled model, H=768, V=300 "
        "and the smallest H it takes; (b) a scaled bf16 checkpoint through cli.serve and "
        f"cli.generate; (c) steps vs CUDA-core vs plain at the scaled model [{smi}]")
    worst = phase_steps_vs_plain()
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_steps_served(tmp)
    log(f"[19(c) step-major sampler times] CUDA events [{smi}]")
    times = phase_steps_times(smi)
    log(f"[19(d) step-major sampler digests] the bf16 step route's tokens and logits [{smi}]")
    return {"worst": worst, "launches": launches, "times": times,
            "digest": phase_steps_digest(smi)}


def steps_record(steps: dict) -> dict:
    """The kernels line's ``fused_generate_steps`` entry from phase 19."""
    t = steps["times"]
    main = t["bfloat16 B=8192"]
    step = next(r for r in t["launch"]["launches"] if r["B"] == 8192)
    return {
        "name": "fused_generate_steps", "route": "cuda",
        "source": "mlx_vae_tpu_torch/csrc/fused_generate_steps.cu (gen_init_kernel, "
                  "gen_step_tma_kernel (TMA producer warpgroup, wgmma consumers keeping the f32 "
                  "stage sums, persistent grid) / train_common.cuh seq_fwd_tf32_kernel, "
                  "gen_head_kernel / gen_head_tf32_kernel)",
        "replaces": "mlx_vae_tpu/ops/pallas_decoder.py:142",
        "launches": steps["launches"]["serve"] + steps["launches"]["generate"],
        "launches_note": STEPS_NOTE, "launches_by_run": steps["launches"],
        "max_abs_err": steps["worst"][0],
        "err_metric": "largest |kernel - plain| of the first step's scaled logits over phase "
                      "19(a)'s configs, B=256/2048, greedy/T=0.8/top-k+top-p (tolerance 1e-4 "
                      "f32, 1e-2 bf16)",
        "max_row_disagreement": steps["worst"][1],
        "ms": main["steps"]["ms"], "plain_ms": main["plain"]["ms"],
        "bound_ms": main["steps"]["bound_ms"], "bound_by": main["steps"]["bound_by"],
        "bound_note": "bf16 on the tensor cores at 989 TFLOP/s; f32 (tiers) as split-TF32, 3 x "
                      "the operations at 495 TFLOP/s",
        "library_ms": None, "cuda_core_ms": main["cuda_core"]["ms"],
        "step_ms": step["upper_ms"], "library_step_ms": t["launch"]["library_ms"][8192],
        "step_bound": {"ms": step["upper_bound_ms"], "l2_bytes": step["plan"]["upper_l2_bytes"]},
        "step_note": "a layer-1..3 bf16 step launch (gen_step_tma_kernel, Kp = 2048) at B=8192: "
                     "median device ms of one pass under the profiler; library: one bf16 "
                     "torch.lstm_cell at I = H = 1024 (two cuBLAS products and the cell), never "
                     "called by the port; step_bound: inputs of a bound, not measurements: ms, "
                     "the launch's FLOP at 989 TFLOP/s, and l2_bytes, what the launch plan "
                     "(ops/fused_decoder.py:steps_launch_plan) models its CTAs to read from L2",
        "step_launches": {r["B"]: {k: r[k] for k in ("layer0_ms", "upper_ms", "layer0_bound_ms",
                                                       "upper_bound_ms", "plan")}
                          for r in t["launch"]["launches"]},
        "library_step_ms_by_B": t["launch"]["library_ms"], "l2_tb_s": t["launch"]["l2_tb_s"],
        "digest_steps": steps["digest"],
        "tiers": {k: {r: {"ms": v[r]["ms"], "bound_ms": v[r]["bound_ms"]} for r in v}
                  for k, v in t.items() if k not in ("profile", "launch")},
        "device_ms_by_kernel": t["profile"]["kernels"],
        "idle_share": t["profile"]["idle_share"],
        "timed_shape": "hidden 1024, 4 layers, V=80, E=128, C=1, B=8192 L=64 bf16 T=0.8"}


STEPS_NOTE = ("phase 19(b): a random-init scaled bf16 checkpoint served by cli.serve (tiers "
              "256 and 2048: two 1500-molecule requests and a 200-molecule greedy one) and "
              "cli.generate (4096 molecules at B=2048, twice); counted per call (1 + n*L + L "
              "launches each: gen_init_kernel, gen_step_tma_kernel, gen_head_kernel)")


SEQ_RECORDS = {
    "seq_lstm_fwd": ("fused_seq_lstm.cu", "pallas_seq_lstm.py:116", "seq_lstm_fwd I=1024",
                     "I=1024 H=1024 B=2048 L=64 bf16"),
    "seq_lstm_bwd": ("fused_seq_lstm.cu", "pallas_seq_lstm.py:195", "seq_lstm_bwd I=1024",
                     "I=1024 H=1024 B=2048 L=64 bf16"),
    "fused_train_decoder_fwd_logits": (
        "fused_train_decoder.cu", "pallas_train_decoder.py:203",
        "fused_train_decoder_fwd_logits", "H=1024 n=4 V=80 E=128 B=2048 L=64 bf16 tf 0.9"),
    "lstm_gates_fwd": ("fused_lstm_gates.cu", "pallas_lstm.py:56", "lstm_gates_fwd",
                       "B=4096 H=256 f32"),
    "lstm_gates_bwd": ("fused_lstm_gates.cu", "pallas_lstm.py:68", "lstm_gates_bwd",
                       "B=4096 H=256 f32"),
}


# rows 6-8 in f32: the shapes phase 11's f32 pass times
F32_SCALED_SHAPES = {"seq_lstm_fwd": "I=1024 H=1024 B=2048 L=64 f32",
                     "seq_lstm_bwd": "I=1024 H=1024 B=2048 L=64 f32",
                     "fused_train_decoder_fwd_logits": "H=1024 n=4 V=80 E=128 B=2048 L=64 f32 "
                                                       "tf 0.9"}


def f32_record(rec: dict, kname: str, shape: str) -> dict:
    """A kernel's f32 keys of the kernels line from phase 8's or 11's f32
    pass: its time, the plain version's, cuDNN's with TF32 off (the
    library call that computes the same f32 function; with TF32 on beside
    it), the split-TF32 bound (3 x the operations over 495 TFLOP/s, or the
    bytes) and the CUDA-core one (67 TFLOP/s), and its launches in one f32
    step (default model for rows 2-5, scaled for rows 6-8); rows 4 and 6
    also their device ms by kernel (step and head launches), row 5 every
    kernel of its backward's profile, rows 7-8 also at I=128
    (``*_f32_i128``)."""
    if "bounds" in rec:  # phase 8: per-kernel pairs, shared dicts
        ms, plain = rec[kname]
        lib, lib_tf32 = rec["library"].get(kname), rec["library_tf32"].get(kname)
        bt, bc = rec["bounds"]["split_tf32"][kname], rec["bounds"]["cuda_core"][kname]
    else:
        r = rec[kname]
        ms, plain, lib, lib_tf32 = r["ms"], r["plain_ms"], r["library_ms"], r["library_tf32_ms"]
        bt, bc = r["bounds"]["split_tf32"], r["bounds"]["float32"]
    out = {"ms_f32": ms, "plain_ms_f32": plain, "library_ms_f32": lib,
           "library_ms_f32_tf32_on": lib_tf32, "bound_ms_f32": bt[0], "bound_by_f32": bt[1],
           "bound_ms_f32_cuda_core": bc[0], "launches_f32": rec["launches"][kname],
           "timed_shape_f32": shape}
    if kname.startswith("fused_train_decoder_fwd"):  # rows 4 and 6: step and head launches
        out["device_ms_f32_by_kernel"] = {k: v for k, v in rec["dec_fwd_profile"].items()
                                          if "tf32" in k}
    if kname == "fused_train_decoder_bwd":  # row 5: head pass, chain, sums, dW passes, demb
        out["device_ms_f32_by_kernel"] = rec["dec_bwd_profile"]
    r = rec.get(f"{kname} I=128")
    if r is not None:
        out.update(ms_f32_i128=r["ms"], plain_ms_f32_i128=r["plain_ms"],
                   library_ms_f32_i128=r["library_ms"],
                   bound_ms_f32_i128=r["bounds"]["split_tf32"][0])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true",
                    help="time every sampler cluster size and rows-per-thread instance "
                         "instead of phases 3-18")
    ap.add_argument("--f32_times", action="store_true",
                    help="run only phase 8's and phase 11's f32 passes after the build")
    ap.add_argument("--quality", action="store_true",
                    help="run only phase 18 after the build")
    ap.add_argument("--steps", action="store_true",
                    help="run only phase 19 (the step-major sampler) after the build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1 device] {name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; allow_tf32 matmul=False cudnn=False")

    t0 = time.perf_counter()
    build_all()
    log(f"[2 build] csrc/{'.cu, '.join(SOURCES)}.cu built and loaded in "
        f"{time.perf_counter() - t0:.2f}s")

    device = {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}
    if args.sweep:
        log(f"[sweep] cluster size and rows per thread forced, default model [{smi}]")
        sweep = phase_sweep(smi)
        log(smi)
        print(json.dumps({"tile_sweep": sweep}))
        print(json.dumps({"ok": True, "device": device}))
        return 0
    if args.f32_times:
        log(f"[8 train times, f32] B=4096 L=64, CUDA events [{smi}]")
        f32 = {"default": phase_train_times_f32(smi, check=False)}
        log(f"[11 scaled times, f32] CUDA events [{smi}]")
        f32["scaled"] = phase_scaled_times_f32(smi)
        log(smi)
        print(json.dumps({"f32_times": f32}))
        print(json.dumps({"ok": True, "device": device}))
        return 0

    if args.quality:
        log(f"[18 quality parity] one seed, {QUALITY_MOLECULES} molecules, 2 bf16 epochs "
            f"[{smi}]")
        quality = phase_quality(smi)
        log(smi)
        print(json.dumps({"quality_launches": quality}))
        print(json.dumps({"ok": True, "device": device}))
        return 0

    if args.steps:
        steps = phase_steps(smi)
        log(smi)
        print(json.dumps({"kernels": [steps_record(steps)]}))
        print(json.dumps({"ok": True, "device": device}))
        return 0

    log("[3 kernel vs plain] both sampler kernels, default model, B=256/2048/8192, L=64")
    worst = phase_kernel_vs_plain()

    log("[4 slice] port server, tiers 256,2048,8192, max_length 64, f32")
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_slice(tmp)
        phase_scan_served(tmp)
        core_launches = phase_core_served(tmp)

    log(f"[5 times] tensor-core vs CUDA-core vs plain sampler, CUDA events [{smi}]")
    times = phase_times(smi)

    log(f"[6 train kernels vs plain] default model, L=64, B={'/'.join(map(str, TRAIN_BATCHES))}, "
        f"f32/bf16")
    errs = phase_train_kernels()

    log("[7 train slice] train_step, default model, bf16, B=4096, L=64, fused route")
    launches_train = phase_train_slice()

    log(f"[8 train times] B=4096 L=64 bf16, CUDA events [{smi}]")
    train_times = phase_train_times(smi)
    log(f"[8 train times, f32] B=4096 L=64, CUDA events [{smi}]")
    train_f32 = phase_train_times_f32(smi)

    log("[9 scaled kernels vs plain] sequence LSTM, decoder logits forward, gate pair")
    seq_errs = phase_scaled_kernels()

    log("[10 scaled slice] train_step, hidden 1024 / 4 layers, bf16, B=2048, L=64, fused "
        "route; reference_zero_state gate path")
    launches_seq = phase_scaled_slice()

    log(f"[11 scaled times] CUDA events [{smi}]")
    seq_times = phase_scaled_times(smi)
    log(f"[11 scaled times, f32] CUDA events [{smi}]")
    seq_f32 = phase_scaled_times_f32(smi)

    log("[12 train CLI] cli.train on a 20,523-molecule corpus, default model, bf16, "
        "B=4096, fused route; resume; f32 fused vs plain; cli.generate with --data")
    step_ms = sum(train_times["step_fused"]) / len(train_times["step_fused"])
    with tempfile.TemporaryDirectory() as tmp12:  # phases 12, 13 and 15
        cli = phase_train_cli(smi, step_ms, tmp12)

        log("[13 eval CLIs] cli.encode (f32, bf16), cli.interpolate, cli.optimize on phase 12's "
            "corpus and checkpoint, fused route against plain route; the encoder at B=2/5 and "
            "the greedy sampler at B=5/9 against their plain versions")
        phase_eval_shapes()
        ev = phase_eval_cli(smi, tmp12)["launches"]

        log(f"[14 serve concurrent] default model, f32, tiers 256,2048,8192, L=64, T=0.8 "
            f"[{smi}]")
        with tempfile.TemporaryDirectory() as tmp:
            serve = phase_serve_concurrent(tmp, smi)

        log("[15 multi-device] (a) NCCL, one rank: the DP step vs train_step; (b) two gloo "
            "ranks on cuda:0: a DP step at full width, cli.train / generate / encode "
            "--data_parallel; (c) --model_parallel 2, f32 scan route; (d) the dry run, "
            f"{DRYRUN_N} gloo ranks on cuda:0")
        dp = phase_multi_device(smi, step_ms, tmp12)

    log("[16 curve parity and diagnostics] the three diagnostics on cuda:0; the curve-parity "
        "study's corpus and the first epochs of its 50-epoch schedule, default model, bf16, "
        f"B=256, fused route, against the JAX seeds' band [{smi}]")
    curve = phase_curve(smi)

    log(f"[17 refused models] V={REFUSED_V} and 9-layer train steps on the sequence kernels and "
        "the scan against the plain route; data.prepare, cli.train --use_pallas and "
        f"cli.encode at V={REFUSED_V} [{smi}]")
    with tempfile.TemporaryDirectory() as tmp:
        refused = phase_refused(smi, tmp)

    log(f"[18 quality parity] studies/quality_parity.py cut to one seed, {QUALITY_MOLECULES} "
        f"molecules, 2 bf16 epochs at B=1024; both studies, cli.encode, cli.generate [{smi}]")
    quality = phase_quality(smi)

    steps = phase_steps(smi)

    bounds = default_bounds()
    t_ms, c_ms, p_ms = times[("float32", 8192)]
    sampler_err = ("largest |kernel - plain| of the first step's scaled logits over "
                   "B=256/2048/8192, f32/bf16, greedy/T=0.8/top-k+top-p (tolerance 1e-4 f32, "
                   "1e-2 bf16)")
    tiers = {f"{d} B={B}": {"tc_ms": v[0], "cuda_core_ms": v[1], "plain_ms": v[2]}
             for (d, B), v in ((k, v) for k, v in times.items() if k != "profile")}
    log(smi)
    print(json.dumps({"kernels": [{
        "name": "fused_generate_tc", "route": "cuda",
        "source": "mlx_vae_tpu_torch/csrc/fused_generate.cu (tc::gen_tc_kernel)",
        "replaces": "mlx_vae_tpu/ops/pallas_decoder.py:142",
        "launches": launches,
        "launches_train_cli": cli["sampler_launches"],
        "launches_eval_cli": ev["fused_generate_tc"],
        "launches_serve_concurrent": serve["launches"],
        "max_abs_err": worst["tc"][0], "err_metric": sampler_err,
        "max_row_disagreement": worst["tc"][1],
        "ms": t_ms, "plain_ms": p_ms,
        "bound_ms": bounds["fused_generate_tc"][0], "bound_by": bounds["fused_generate_tc"][1],
        "bound_note": "f32 as split-TF32: 3 x the operations over 495 TFLOP/s, or the bytes "
                      "over 3.35 TB/s; bf16: bound_ms_bf16 (989 TFLOP/s)",
        "bound_ms_bf16": bounds["fused_generate_tc_bf16"][0],
        "bf16_ms": times[("bfloat16", 8192)][0], "tiers": tiers,
        "library_ms": None, "launches_dp": dp["fused_generate_tc"],
        "launches_quality": quality["fused_generate_tc"], "launches_quality_note": QUALITY_NOTE,
        "launches_dp_note": "phase 15(b): cli.generate --data_parallel, 8192 greedy rows, rank "
                            "0 (2048 rows a rank a batch, a warm-up batch and 2)",
        "timed_shape": "B=8192 L=64 f32 T=0.8"}, {
        "name": "fused_generate", "route": "cuda",
        "source": "mlx_vae_tpu_torch/csrc/fused_generate.cu (fused_generate_kernel)",
        "replaces": "mlx_vae_tpu/ops/pallas_decoder.py:142",
        "launches": core_launches,
        "launches_note": "phase 4's H=48 served run (a config the tensor-core sampler does "
                         "not take); the default config's served run launches it 0 times",
        "max_abs_err": worst["cuda_core"][0], "err_metric": sampler_err,
        "max_row_disagreement": worst["cuda_core"][1], "launches_dp": dp["fused_generate"],
        "launches_quality": quality["fused_generate"],
        "ms": c_ms, "plain_ms": p_ms,
        "bound_ms": bounds["fused_generate"][0], "bound_by": bounds["fused_generate"][1],
        "library_ms": None,
        "timed_shape": "B=8192 L=64 f32 T=0.8"}] + [{
            "name": kname, "route": "cuda", "source": TRAIN_SOURCES[kname],
            "replaces": TRAIN_REPLACES[kname], "launches": launches_train[kname],
            "launches_train_cli": cli["launches"][kname], "launches_dp": dp[kname],
            "launches_dp_note": "phase 15(b): one DP step, 2048 rows, rank 0",
            "launches_curve": curve[kname], "launches_curve_note": CURVE_NOTE,
            "launches_quality": quality[kname], "launches_quality_note": QUALITY_NOTE,
            **({"launches_eval_cli": ev[kname]} if kname in ev else {}),
            "max_abs_err": errs[kname][0],
            "err_metric": f"largest |kernel - plain| over every output (forward) or "
                          f"gradient leaf (backward; the encoder's also its reverse chain's "
                          f"dgates and dx0) at B={'/'.join(map(str, TRAIN_BATCHES))}, "
                          f"f32/bf16, teacher forcing on{TRAIN_NOTES.get(kname, '')}"
                          f"; largest max|diff|/max|plain| {errs[kname][1]:.3e} "
                          f"(tolerance 1e-4 f32, 2e-2 bf16)",
            "ms": train_times[kname][0], "plain_ms": train_times[kname][1],
            "bound_ms": bounds[kname][0], "bound_by": bounds[kname][1],
            "library_ms": train_times["library"].get(kname),
            "timed_shape": "B=4096 L=64 bf16" + (" with_ce" if "decoder" in kname else ""),
            **f32_record(train_f32, kname, "B=4096 L=64 f32")}
            for kname in TRAIN_KERNELS] + [{
            "name": kname, "route": "cuda", "source": f"mlx_vae_tpu_torch/csrc/{src}",
            "replaces": f"mlx_vae_tpu/ops/{tpu}", "launches": launches_seq[kname],
            **({"launches_curve": curve[kname], "launches_curve_note": CURVE_NOTE}
               if kname in curve else {}),
            **({"launches_refused": refused[kname], "launches_refused_note": REFUSED_NOTE}
               if kname in refused else {}),
            **({f"{k}_b256": v for k, v in zip(("ms", "plain_ms", "library_ms", "bound_ms"),
                                                seq_times[f"{kname} [256, 256]"])}
               if kname.startswith("lstm_gates") else {}),
            **({"launches_eval_cli": ev[kname]} if kname in ev else {}),
            **({"launches_dp": dp[kname], "launches_dp_note": (
                "phase 15(d): the dry run's scaled data-parallel step (hidden 1024, 4 layers, "
                f"one row a rank of {DRYRUN_N}), rank 0" if kname.startswith("seq_lstm") else
                "phase 15(b): cli.encode --data_parallel, 2,053 rows in 3 batches of 1024, "
                "rank 0")} if kname in dp else {}),
            "max_abs_err": seq_errs[kname][0],
            "err_metric": f"largest |kernel - plain| over every output or gradient leaf "
                          f"(phase 9{DEC_FWD_NOTE if 'decoder' in kname else ''}); largest "
                          f"max|diff|/max|plain| {seq_errs[kname][1]:.3e} "
                          f"(tolerance 1e-4 f32, 2e-2 bf16)",
            **dict(zip(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"), seq_times[row])),
            "timed_shape": shape,
            **(f32_record(seq_f32, kname, F32_SCALED_SHAPES[kname])
               if kname in F32_SCALED_SHAPES else {})}
            for kname, (src, tpu, row, shape) in SEQ_RECORDS.items()] + [steps_record(steps)]}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
