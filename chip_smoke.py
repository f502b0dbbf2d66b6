#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`psvo_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `psvo_tpu_torch/csrc/`, checks each one
against its plain PyTorch version on the card, then drives the paths of two
presets with random weights from a seed. `fhn_fivo_k1024_bench` (FHN, FIVO,
K=1024, B=32, T=100, relu heads (64, 64), in-kernel RNG): serving, through
`make_eval_step` and `filter_posterior`, and training, through
`make_train_step` (10 Adam steps per call). `lorenz63_psvo_k1024`
(Lorenz-63, PSVO with FFBSi smoothing, K=1024, M=16, B=32, T=100, stream
noise): serving through `smooth_posterior` and training through
`make_train_step`. Phases:

  (a) the card (nvidia-smi name and power limit); TF32 off
  (b) kernel build time and per-kernel registers
  (c) K3 ancestor_indices vs its plain version on adversarial rows
  (d) K2 stream_noise, the pair design and the previous one (design=
      "particle"), each bit-equal to the plain Philox and to the other; their
      device times alternated, three pairs (the pair design must be faster
      in each)
  (e) K1 scan_forward, stream mode, vs scan_forward_reference (small, full)
  (f) K1 in-kernel RNG vs K1 and the plain version replaying K2's streams
  (g) serving: eval on batches of 32 and filter_posterior; launch counts
  (h) K4 scan_backward vs scan_backward_reference on one K1 run's residuals
      (small, full; stream mode and in-kernel RNG)
  (i) training: 2 calls of 10 train steps on FHN minibatches of 32; launch
      counts, step time, K4 vs its plain version, peak memory, and the
      device time of one more call by kernel (torch.profiler)
  (j) K1 and K4 at the Lorenz-63 shape (Dx=Dy=3, stream mode, K4 with the
      cache cotangents) vs their plain versions (small, full)
  (k) K5 ffbsi_forward vs its plain version on the cache of one K1 run, and
      K6 ffbsi_backward vs its plain version on K5's selections (small, full;
      every cotangent, the direct bound's, the paths alone); K5's staged
      design vs the previous one (design="path"): sel, x~, x_first and logp
      equal, logq within 1e-6; K6's staged design vs the previous one
      (design="row"): the paths alone bit-equal, otherwise within 1e-5
      relative L2 per leaf, each design bit-equal on a relaunch, also at
      M=256 and at K=8192 (chunked rows); both kernels' designs timed
      alternately by device time, three pairs per cotangent pattern (the
      staged design must be faster in each)
  (l) serving: smooth_posterior on three batches of 32 Lorenz-63
      trajectories; shapes, launch counts (every K5 launch the staged
      design), time per call
  (m) training: 2 calls of 10 PSVO train steps on Lorenz-63 minibatches of
      32; launch counts (K5 and K6 all staged), step time, peak memory,
      profile by kernel

then `lorenz96_fivo_k8192_sharded` (Lorenz-96, Dx=Dy=40, FIVO, K=8192, B=8,
T=100, relu heads (64, 64), in-kernel RNG) with the trained snapshot
`checkpoints/l96_pretrained.npz`, served and trained on one card by the
trunk path:

  (n) K2 at Dx=40 as in (d), both designs
  (o) K7 ancestor_indices_large and K8 gather_particles vs their plain
      versions on adversarial rows (small, full); K7's cluster design equal
      to the previous one (design="row") and the same on a second launch;
      the two timed alternately, three pairs (the cluster design must be
      faster in each)
  (p) K9 trunk_forward (the async design) vs its plain version on every
      step of one kernel run, with the streamed ε and the in-kernel draw
      (small, full), and bit-equal to the previous design (design="tile")
      on every step; the two timed alternately, three pairs per noise mode
      (the async design must be faster in each)
  (q) serving through make_eval_step and filter_posterior (with and without
      the particles): launch counts (every K9 launch the async design,
      every K7 launch the cluster design),
      ELBO, R², time per call, peak memory and a profile by kernel
  (r) K11 segment_sum_scatter vs its float64 plain version on the
      adversarial rows of (o) at K=128, 2048 and 8192 (bit-equal on a second
      launch), with its device time beside zeros + scatter_add_'s; the tiled
      design against the previous one (design="row"), max |d| printed, the
      two timed alternately, three pairs on the adversarial rows and one
      each on healthy and one-ancestor rows (the tiled design must be
      faster in each)
  (s) K10 trunk_backward vs its plain version on every step of one kernel
      run, random cotangents, streamed ε and the in-kernel draw (small, full),
      and vs the previous design (design="simt", fp32 FMA) within 1e-5; the
      two designs timed alternately, three pairs per noise mode, beside the
      fp32 bound and the split bound (forward on fp32, backward 3xTF32)
  (t) training through make_train_step from the snapshot: 3 calls of one
      step on minibatches of 8, launch counts (99 per kernel per step), loss,
      grad norm, step time, peak memory and a profile by kernel; every K9
      launch the async design, every K10 launch the tensor-core design,
      every K7 launch the cluster design, every K11 launch the tiled design

then `lorenz63_svo_k256` (Lorenz-63, SVO with the learned backward proposal,
K=256, M=16, B=32, T=100, relu heads (64, 64), in-kernel RNG, the filter's
cache on) with random weights:

  (u) K1 and K4 at its settings (in-kernel draw, cache, K4 with the cache
      cotangents and the seed) vs their plain versions on K2's streams
      (small, full)
  (v) K12 svo_sweep_forward (the split design) vs its plain version: the
      free runs and every step teacher-forced from the kernel's own
      x~_{t+1} (small, full), and bit-equal to the previous design
      (design="chain") in x_first, lp, lq and x~; the two timed
      alternately, three pairs (the split design must be faster in each)
  (w) K13 svo_sweep_backward vs its plain version on K12's x~, random
      cotangents on all four outputs (zeroed on paths with a relu tie, both
      figures reported), bit-equal on a second launch (small, full), and
      within 1e-5 of the previous design (design="chain"); the two timed
      alternately, three pairs (the split design must be faster in each)
  (x) serving: smooth_posterior(method="svo") on three batches of 32;
      shapes, launch counts (every K12 launch the split design), time per
      call, peak memory, profile by kernel
  (y) training: 2 calls of 10 SVO train steps on minibatches of 32; launch
      counts (every K12 and K13 launch the split design), loss and
      elbo_svo, step time, peak memory, profile by kernel

then, with `fused_step.SCAN_FUSED` off (the per-step path of the
reference's `pallas_step.SCAN_FUSED = False`: one K14 launch per filter
step, one K15 launch per step of the backward, streamed noise):

  (z) K14 step_forward vs step_forward_reference on every step of a chain
      of K14 launches, teacher-forced from the kernel's own state, at Dx=2
      (FHN) and Dx=3 (Lorenz-63), small and full; the chain against one K1
      launch on the same streams (indices equal); device time per launch
  (aa) K15 step_backward vs step_backward_reference on every step of those
      chains' residuals, random cotangents of x_new, α and ℓ (zeroed on
      particles with a relu tie, both figures reported), bit-equal on a
      second launch; the chain of K15 launches against one K4 launch on the
      same residuals; K15 at Dx=3, K=2048, beyond K4's shared memory; device
      time per launch
  (ab) fhn_fivo_k1024_bench: make_eval_step on three batches of 32 and 2
      calls of 10 train steps; launch counts (99 K14 per filter, 99 K15 per
      step, no K1 or K4, no plain version), loss, step time, peak memory and
      profiles; one step's loss and gradients against the whole-scan path on
      the same streams and weights
  (ac) lorenz63_psvo_k1024: smooth_posterior on three batches of 32 and 2
      calls of 10 PSVO train steps; launch counts (K14, K15, K5, K6; K5 and
      K6 all staged), times, peak memory and profiles

and, with the toggle back on, K1 and K4 on thread-block clusters (each row
on C CTAs; every phase above launched them at the C that
fused_step.cluster_size picks):

  (ad) K1 and K4 at each cluster size C in {1, 2, 4, 8} that the gates and
      the card admit, at the FHN shape (B=32, K=1024, hidden 64, Dx=2,
      in-kernel draw) and the Lorenz-63 one (Dx=3, stream noise, cache): the
      card's resident clusters per C and the chosen C; K1's outputs and K4's
      d_x0 bit-equal to C=1, K4's other leaves within 1e-6 relative L2, each
      bit-equal on a relaunch; times per C, C=1 and the chosen C alternated
      (the chosen C must be faster)

and K14 and K15 on S CTAs per row with no cluster (every phase from z on
launched them at the S that fused_step.step_slices picks):

  (ae) K14 and K15 at each slice count S in {1, 2, 4, 8} that the gates
      admit, at the FHN and Lorenz-63 shapes (B=32, K=1024, hidden 64), on
      the residuals of phase z's chains: the card's resident CTAs and the
      chosen S; K14's outputs and K15's d_x bit-equal to S=1, K15's other
      leaves within 1e-6 relative L2 (else no further from a float64 replay
      than S=1's), each bit-equal on a relaunch; device times per S, S=1
      and the chosen S alternated, alone (K15's sum_rows_kernel apart: the
      partial-row traffic) and inside one per-step FHN train call, with
      the step's device time and host-clock time per S

and, with the toggle on, `lorenz63_psvo_k1024` under psvo_bound="direct":

  (af) 3 PSVO train steps (one a call) on minibatches of 32, whose K6
      launches take the all-cotangents branch: step time, a profile by
      kernel, launch counts (K1, K4, K5, K6 once a step, K5 and K6 staged),
      no plain version

and `fhn_fivo_controls` (FHN with Di = 2 exogenous controls, FIVO, K=128,
B=32, T=100, relu heads (64, 64), stream noise) with random weights, its
data and controls from seed 0, whose q1 and f take the controls as a
per-(t, row) first-layer term in the coefficient rows:

  (ag) K1, K4, K14 and K15 in their control mode against their plain
      versions (small, full at K=128, and full at K=1024): K1 (stream, and
      the in-kernel draw small) allclose 2e-4 small, teacher-forced full; K4
      on one K1 run's residuals per leaf within 1e-4 small and 1e-3 full, the
      controls' d_coef columns too; the K14 chain against step_forward_reference
      and one K1 launch; K15 per step with relu-tie cotangents zeroed; the
      control mode with zero controls bit-equal to the uncontrolled launch
      on the same weights; at K=1024 K1 and K4 on clusters of 2 against one
      CTA a row (the controls' columns within 1e-6) and K14/K15 at each slice
      count S against S=1 (S=4 included); the four kernels' times at the
      preset's size beside their plain versions and bounds
  (ah) serving through make_eval_step and filter_posterior with controls on
      three batches of 32: one K1 launch a call, no plain version, log Z, R2,
      time per call; negated controls move log Z; a call without controls
      is refused
  (ai) training through make_train_step: 2 calls of 10 steps (B=32) on the
      whole-scan path (20 K1 and 20 K4 launches) and with
      `fused_step.SCAN_FUSED` off (1980 K14 and 1980 K15), no plain version,
      W_u's rows moved; step time, peak memory and a profile by kernel

and `lorenz63_psvo_k1024_t1025_seg8`, the reference's long-T configuration
(psvo_tpu/benchmark.py:1069-1089: lorenz63_psvo_k1024 at B=8, T=1025,
smc.ffbsi_segments S=8, one train step a call), with random weights:

  (aj) S=8 against S=1 on the same streams and Gumbels at T=1025: the
      forward's log Z, increments and last particles, each segment's replay
      (recompute_segment) against the unsegmented cache, and the smoothed
      paths bit-equal; the loss within 1e-6 relative and every gradient leaf
      within 1e-4 relative L2 and cosine 1 - 1e-6 (SEG_TOL)
  (ak) T=1025: one smooth_posterior call at S=8 and 3 train steps at S=8
      and at S=1, each after a warm-up: host-clock ms, a profile (device
      busy, idle share), K1/K4/K5/K6 launches (S=8: 32/16/17/9 a train step,
      16/0/9/0 a serving call), peak memory after reset_peak_memory_stats
      (S=8's train peak must be below S=1's)
  (al) T=AL_T=2049: one smooth_posterior call and a train step at S=8 (no
      warm-up: the kernels are warm from ak), the same columns, finite
      losses; S=1's peak reckoned from the shapes and, under 70 GB, a train
      step at S=1, the same columns

and the product surface, `psvo_tpu_torch.cli.main` called in-process as
`python -m psvo_tpu_torch.cli` would run, results under a temporary
directory (cli_phases), each command's K1/K4/K5/K6 launches counted and no
plain version or K14/K15 allowed:

  (am) K1 at B = n_test = 40 (the eval's and the plots' batch) against its
      plain version for the three presets below (chosen C printed); then the
      README's Quick start, `train --preset fhn_fivo_k128 --steps 200 --set
      train.eval_every=50`: four finite history records, the test ELBO at
      200 above that at 50, K1 launched 200 + 4 + 1 times (steps, evals, the
      plots' latents) and K4 200, params.json, metrics.jsonl, history.json
      and checkpoints/200.pt written; the train step (1000 / steps_per_sec
      of each eval window), the eval call at B = 40, one checkpoint restore
      and save, the peak memory, the plots note, and a profile of one more
      train call (10 steps) by kernel
  (an) `train --preset fhn_fivo_k1024_bench --steps 40` (evals and saves
      every 20) with `--profile`, then `--steps 60 --resume` twice, each from
      a fresh copy of its checkpoints: "resumed from step 40", history at 60,
      the two resumes' parameters, moments, counters and generator at step
      60 bit-equal, launches as in (am); the Chrome trace parses (its K1 and
      K4 events counted and printed; the launch counters decide)
  (ao) `train --preset lorenz63_psvo_k1024 --steps 20` (evals and saves
      every 10; K1 and K5 23 times, K4 and K6 20), then `eval --checkpoint`:
      finite `elbo` and `elbo_psvo_direct`, the "PSVO bounds" line on
      stderr, the eval's parameters equal to the checkpoint's, K1 and K5
      once

and the general filter path, the counterpart of the reference's plain scan,
for the presets the reference's kernel gates exclude (general_phases; on
CUDA tensors it resamples through K7 and K8, K11 in the backward):
`fhn_iwae_k16` (IWAE, K=16, no resampling, 50 steps a call),
`fhn_fivo_known_dynamics`, `fhn_fivo_tril` and `fhn_fivo_dirac` (FIVO,
K=128), B=32, T=AP_T=50 in ap (the presets' 100, cut for the run's time),
relu heads (64, 64), random weights, data from seed 0:

  (ap) each preset: one make_eval_step and one filter_posterior call,
      AP_CALLS=2 calls of one train step each (fhn_iwae_k16's 50 steps a call cut to
      one: the path is host-bound); launches (K7 and K8 T-1 = 99 a filter, K11 99 a
      train step, none for IWAE; no other kernel, no plain version, no CUDA
      tensor in the plain histogram resampler), a finite loss, test ELBO
      and gradient norm, the train step (host clock), the eval call (CUDA
      events), peak memory; profiles of one more train and eval call for
      fhn_fivo_tril
  (aq) the general path on the card against itself on the CPU, on the same
      draws made on the CPU (the CPU resampling with K7's and K8's plain
      versions, the count form): at B=4, T=20, K=128 (16 for IWAE) log Z and the
      increments within 2e-4 and every gradient leaf within rtol 5e-3,
      atol 5e-4; at B=32, T=100, K=128 the loss within 1e-3, the gradient
      norms within 1% and their cosine >= 0.99 (GENERAL_TOL)
  (ar) bootstrap FIVO against the Kalman log-likelihood on the card: the
      LGSSM of tests/test_torch_oracle.py (K=4096, 4 seeds, every row within
      0.35 nats, the mean error under 0.1) and the correlated-noise tril case
      of tests/test_parity_modes.py (K=2048, every row within 0.5);
      tests/reference_numpy/kalman.py loaded by its path
  (as) `train --preset fhn_fivo_tril` and `fhn_iwae_k16 --steps 4` with an
      eval every 2 through the CLI (AS_STEPS; 2 steps a call): the history,
      the results files and the launches

and the smoothing objectives with Di = 2 exogenous controls (the controls
of fhn_fivo_controls: control scale 0.5), whose K1/K4 run in their control
mode, K5/K6 on support terms that take u_{t+1}, and K12/K13 in their
control mode (f's first layer from b1 + u_{t+1}·W_u), random weights, data
and controls from seed 0 (smoothing_controls_phases); each compares one
train step on the card with the plain versions on the CPU on the same
draws by value, norm and cosine (CPU_TOL):

  (at) lorenz63_psvo_k1024 with controls (K=1024, M=16, B=32, T=100) under
      psvo_bound "forward" and "direct": the card against the CPU at B=8,
      T=20; one smooth_posterior call (K1 and K5 once) and 3 train steps
      (K1, K4, K5, K6 three times each), no plain version; segmented: the
      card against the CPU at B=4, T=17, S=2, and one train step at B=8,
      T=1025, S=8 (K1/K4/K5/K6 32/16/17/9)
  (au) lorenz63_svo_k256 with controls (K=256, M=16, B=32, T=100): K12 and
      K13 in their control mode against their plain versions (small, full:
      K12 allclose 2e-4 small, teacher-forced full; K13 per leaf, d_cbias
      included, within 1e-4 small and 1e-3 full with relu-tie paths zeroed;
      bit-equal on a relaunch; a zero bias bit-equal to the uncontrolled
      launch), both timed beside the same shape uncontrolled, alternated; the
      card against the CPU at B=8, T=20; one smooth_posterior(method="svo")
      call (K1 and K12 once) and 3 train steps (K1, K4, K12, K13 three times
      each, all split), a profile of one more step

and multinomial resampling (sorted iid positions, streamed: the in-kernel
draw makes systematic positions only) on every kernel path
(multinomial_phases):

  (av) fhn_fivo_k1024_bench with resampling "multinomial": K1 (small: its
      plain version's free run to 2e-4) teacher-forced, every step's
      ancestors the count form on the kernel's own weights, bit-equal at
      every cluster size C, and a chain of K14 launches equal to it; K1 and
      K14 timed beside their plain versions; then whole scan and with
      SCAN_FUSED off: the card against the CPU at B=4, T=20, one eval (K1
      once, or K14 99 times) and 3 train steps (K1/K4 3 each, or K14/K15
      297), no K2; lorenz96_fivo_k8192_sharded from the snapshot: the card
      against the CPU on the trunk path at B=2, T=20, K7 on the served run's
      weights and fresh sorted positions equal to its plain version, one
      filter_posterior (K7, K8, K9 99 each) and one train step (K7-K11 99
      each)

and the reference's trunk class (trunk_class_phases): what its trunk gate
takes beyond the whole-scan class — ESS-adaptive resampling, IWAE at K >= 128,
the full FIVO gradient, controls — through K7/K8, K9 (K10/K11 in training)
at the FHN, Lorenz-63 and Lorenz-96 widths:

  (aw) K9 and K10 at (Dx, Dy) = (2, 2) and (3, 3) (fhn_fivo_k1024_bench and
      lorenz63_psvo_k1024: B=32, K=1024, T=100, hidden (64, 64), random
      weights) on every step of one kernel run, teacher-forced: K9 with the
      streamed ε and the in-kernel draw (bit-equal to stream mode on K2's ε
      and to the tile design), per-step rel L2 1e-4; K10 (the simt design at
      these widths) per leaf within 1e-3 with relu-tie cotangents zeroed,
      bit-equal on a relaunch; both timed (pair_ms) beside their plain
      versions; then K9 and K10 in their control mode (Di=2) at
      fhn_fivo_controls' width (B=32, K=1024) and Lorenz-96's (B=8, K=8192)
      against their plain versions (K9 allclose 2e-4, K10 per leaf within
      1e-4, the controls' d_coef columns included), zero controls bit-equal
      to the uncontrolled launch, timed beside it
  (ax) six configurations at full width, one --set each (TRUNK_CLASS):
      fhn_fivo_k1024_bench with smc.ess_threshold=0.5, and with multinomial
      resampling and use_stop_gradient=false (the full FIVO gradient);
      fhn_iwae_k16 at K=128; lorenz63_psvo_k1024 with ess_threshold=0.5 (the
      trunk path's cache, then K5/K6); fhn_fivo_controls with
      ess_threshold=0.5; lorenz96_fivo_k8192_sharded with Di=2 (fresh
      weights). Each: the card against the CPU on the same draws at B=4 (B=2
      for Lorenz-96), T=20 (CPU_TOL); one serving call (make_eval_step, or
      smooth_posterior for PSVO); 3 train steps with launch counts (K7/K8 99
      each a filter when resampling is on, none for IWAE; K9 99; K10 and K11
      99 a train step, no K11 for IWAE; K5/K6 once for PSVO; no K1/K4/K14/K15
      and no plain version); a profile of one more step

and the SVO backward proposal's GRU and PSVO/SVO wherever the reference runs
its plain code (eager_routes_phases): each configuration is a preset with one
change, at full width with random weights (Lorenz-96's snapshot for E), data
from seed 0; each compared with the CPU on the same draws (card_vs_cpu,
CPU_TOL: loss 1e-3, gradient norms 1%, cosine 0.99), served and trained
(launch counts, no plain version, host-clock times, peak memory, a
device-only profile of one more step):

  (ay) A, lorenz63_svo_k256 with smc.qb_rnn=true (K=256, M=16, B=32, T=100,
      GRU width 64): the forward through K1 (K4 in training), the GRU and the
      q_b sweep eager; one make_eval_step and one smooth_posterior(method=
      "svo") call (K1 once each), AZ_TRAIN=1 train step (K1, K4 once, no
      K12/K13)
  (az) B, lorenz63_svo_k256 with known dynamics (eager q_b sweep); C,
      fhn_fivo_dirac as PSVO (K5/K6); D, fhn_fivo_tril as PSVO (eager FFBSi:
      a full-covariance f); E, lorenz96_fivo_k8192_sharded as PSVO with M=16
      (K=8192, B=8: the trunk path, eager FFBSi past the reference's K cap);
      at T=AZ_T=50 (the presets' 100, cut for the run's time). One
      smooth_posterior call (K7/K8 49 each, K9 49 for E, K5 once for C) and
      AZ_TRAIN=1 train step (K7/K8/K11 49 each, K9/K10 49 for E, K5/K6 once
      for C); E's eager sweep alone timed, with its peak memory
  (ba) lorenz63_psvo_k1024_t1025_seg8 with smc.ess_threshold=0.5, and the
      preset with fused_step.SCAN_FUSED off: the plain step body per segment
      on the card, as the reference runs it; the card against the CPU at
      T=33, S=4, B=2; at T=BA_T=257 (the preset's 1025 cut for the run's
      time), S=8, B=8 one smooth_posterior call (K7/K8 512, K5 9) and one
      train step (K7/K8 1024, K11 512, K5 17, K6 9), the first of each, no
      profile (tools/routes_profile.py takes one)

and data and particle sharding (sharded_phases): ranks of one gloo process
group, all on cuda:0 (one card; NCCL refuses two ranks on one GPU), started
by psvo_tpu_torch.parallel.launch, each importing this file for its jobs
(shard_rank); every collective goes through host buffers (gloo), counted:

  (bb) K7, K8 and K11 at the 1x8 mesh's per-shard shape (B=8, K/P=1024,
      D=40) against their plain versions, timed (pair_ms) beside them and
      beside torch.gather and zeros + scatter_add_; then on 2, 4 and 8
      ranks: psum, pmax and a ring shift (and the psum's and the shift's
      gradients) against one process; the resampling island at the
      Lorenz-96 preset's step (B=8, K=8192, D=40, weight_rows): K7 and K8
      launched once a ring step a rank, K7 on the ring's clamped positions
      equal to its plain version, the global ancestors against one rank's
      K7 on the same global weights and positions (differences counted
      with their distance to a CDF boundary, at most 1e-6 and 0.1% of the
      slots), the particles the island's ancestors' exactly; collectives,
      staged bytes and the call's host-clock time
  (bc) lorenz96_fivo_k8192_sharded on its 1x8 mesh at full width (Dx=Dy=40,
      K=8192, 1024 a rank, B=8, hidden (64, 64), the trained snapshot): one
      sharded eval at T=BC_EVAL_T=50 (the preset's 100, cut for the run's
      time; K7/K8 8*49 a rank; its peak memory a rank holds the global draw
      every rank makes); at T cut to
      SHARD_T=10 for the run's time, the card against the CPU's unsharded
      plain loop on the same draws at B=2 (CPU_TOL) and one sharded train
      step (K7/K8/K11 8*9 a rank), no other kernel and no plain version,
      the replicas' gradients equal; collectives, staged host bytes,
      host-clock step time and peak memory a rank
  (bd) lorenz63_psvo_k1024 (M=16) on a 2x2 mesh at B=4, T=SHARD_T: the
      sharded anchor, FFBSi island and data-axis all-reduce against the CPU
      unsharded on the same draws (CPU_TOL), K7/K8/K11 2*9 a rank; then
      fhn_fivo_k1024_bench on a 4x1 data mesh: one train step through K1/K4
      a rank against the unsharded card step on the same streamed draws

and the kernel classes beyond the presets' shapes, each shape outside the
kernels' library built into a shape library of its own beside phases c-:

  (be) the whole-step class (STEP_CLASS): K1/K4 (and K14/K15) against
      their plain versions, the card against the CPU, served and trained
  (bf) resampling at every K and the trunk class (reach_phases): K7 on
      weight_rows at K = 300, 384, 1000, 19456, 24576, 32768 (REACH_K: not
      whole chunks of 256, above the row design's cap, the CDF spread over
      the cluster at 32768), index-equal to its plain version and timed
      beside it; K11 at K=32768 (B=8, D=40) within 1e-6 of float64, timed
      beside zeros + scatter_add_; fhn_fivo_k128 at K=1000 and
      fhn_fivo_tril at K=384 (the plain loop, K7/K8 99 a filter, K11 99 a
      train step): the card against the CPU, one eval and filter_posterior
      call, 3 train steps; the trunk class at REACH_TRUNK's shapes
      (Lorenz-96 at D=20, K=8192, B=8, T=100; FHN with Dy=1 and ESS 0.5;
      Lorenz-96 at D=55 (K10's weights in device memory) and at D=40 with
      three layers of 64 (K9's and K10's), T=20): K9 teacher-forced within
      2e-4 and K10 per leaf within 1e-4 small and 1e-3 full (relu-tie
      cotangents zeroed), bit-equal on a relaunch, both timed beside their
      plain versions and bounds; the card against the CPU at B=2; one eval
      and filter_posterior call (K7/K8/K9 once a step), 3 train steps at T=100
      or one at T=20 (K7-K11 once a step), no plain version, peak memory, a
      profile for D=20; lorenz96_fivo_k8192_sharded from the snapshot at
      K=32768 (K7 spread over 8 CTAs, K11 on 8 tiles): one eval and
      filter_posterior call and 2 train steps, no plain version
  (bg) the smoothing sweeps at the reference's reach
      (smoothing_class_phases): (a) K5/K6's wide kernels at Dx = 4 (K=128,
      the small check, and K=1024), 40 (Lorenz-96's K=1024, M=16, B=8,
      T=100) and 55 (K=2048), M=512 at Dx=3 and M=4096 at Dx=4, K=2048
      (BG_FFBSI), K12/K13 from shape libraries at (3, 1) width 48, (4, 3)
      width 24 and (6, 1) width 8 with Di=1 (BG_SVO; M=32, and M=4096 at
      the first), against their
      plain versions under BG_TOL (K5's selections equal on every (t, row,
      path), x~/x_first/logp within 1e-6 relative L2; K6 per leaf within
      1e-4 small, 1e-3 full, the direct bound's against float64; K12 2e-4;
      K13 per leaf 1e-4 small, 1e-3 full, relu ties zeroed; every kernel
      bit-equal on a relaunch), times and bounds at the main paths' shapes;
      (b) Lorenz-96 PSVO at K=1024, M=16, B=8, T=100 (the trunk filter, the
      wide K5/K6) and (c) SVO at (Dx, Dy) = (3, 1), widths 48, K=256, M=32,
      B=32, T=100 (K1/K4, K12/K13 from shape libraries): the card against
      the CPU, one smooth_posterior call and 3 train steps with launch
      counts, no plain version, times, peak memory and a profile; (d) the
      preset shapes' K1/K4/K14/K15 and K5/K6/K12/K13 outputs (preset_bits)
      bit-equal to the parent's build's (PARENT_BITS)
  (bh) the whole-step kernels above width 64 (wide_step_phases): (a) K1,
      K4, K14 and K15 at widths 72, 128 and 256, two hidden layers, at
      (Dx, Dy) = (2, 2) and (3, 1) (WIDE, WIDE_DIMS; B=32, K=1024, T=100,
      at 256 B=8, T=20: WIDE_SIZES), K1/K14 under the tiled plan: K1
      teacher-forced within 2e-4, K4 per leaf within 1e-3, the chain of K14
      launches bit-equal to K1 and each K14 step within 2e-4, K15 per leaf
      within 1e-3 (relu ties zeroed), bit-equal on a relaunch, its chain
      within 1e-4 of K4 (WIDE_TOL); K1/K4 at every cluster size C and
      K14/K15 at every slice count S the gates admit, bit-equal (K4's and
      K15's sums within 1e-6, else no further from float64 than the first
      size's); at (2, 2) the four timed beside their plain versions and
      bounds, and one train step of each width whole-scan (one K1, one K4)
      and per step (K14, K15 once a step); (b) K1 and the chain of K14
      launches under the tiled plan, forced at the presets' width 64
      (fhn_fivo_k1024_bench and lorenz63_psvo_k1024, B=32, K=1024, T=100),
      bit-equal to the register plan, streamed and in-kernel noise; (c)
      fhn_fivo_k1024_bench with q0/q1/q2/f/g at (128, 128) (WIDE_NET): the
      card against the CPU at B=2, T=20 (CPU_TOL), make_eval_step and
      filter_posterior (K1 once each), WIDE_TRAIN=3 train steps (K1 and K4
      once a step), no plain version, step time, peak memory and a profile;
      (d) lorenz63_psvo_k1024 at (128, 128): likewise, smooth_posterior (K1,
      K5) and 3 PSVO train steps (K1, K4, K5, K6 once a step); (e) (c) with
      fused_step.SCAN_FUSED off: make_eval_step (99 K14) and one train step
      (99 K14, 99 K15)

(ap) begins with K7, K8 and K11 at the general path's shape (B=32, K=128,
D=2) against their plain versions, timed beside them and beside
torch.gather and zeros + scatter_add_. Every profile records the device's
activity alone (CPU events cost the profiler seconds a window, and half a
minute on an eager step of ~50,000 operations).

Every phase prints its lines and its seconds; any failure prints its reason
on stdout and stderr and exits non-zero. A torch.profiler window that comes
back with no device events is run again (profiled_kernels), and if the
profiler stays empty the callers time by CUDA events instead; device time
per call is the mean of a kernel's recorded events times its launches a
call, as windows often hold part of a kernel's events (device_ms). The
alternated design pairs, held to "the new design faster in every pair", are
timed by CUDA events around 20 calls queued behind a spin kernel, the median
of three windows (pair_ms): a profiler window that drops all of one kernel's
events reads a design at half its time. The run ends with the count of each
kind of window. The second-to-last line is the
kernels' JSON record (times beside the bound: the larger of the operations
over 67 TFLOP/s fp32 and the bytes over 3.35 TB/s, the H100 SXM's published
peaks; K2's, K5's, K6's, K7's, K9's, K11's, K12's and K13's rows also carry
"ms_prev", the previous design's time alternated with theirs; K6's row has
both branches, K2's both widths; K1, K4, K14 and K15 appear once more as
"(controls)", their control mode at fhn_fivo_controls' size; K1's, K4's, K5's
and K6's rows carry their segmented launches, "launches_seg_*"; K7, K8 and K11
appear once more as "(general path)", at B=32, K=128, D=2, with the launches
of phase ap's training runs; K12 and K13 as "(controls)", their control mode
at lorenz63_svo_k256's size with Di=2, "ms_uncontrolled" the same shape
without controls; K1 and K14 as "(multinomial)", at fhn_fivo_k1024_bench's
size on multinomial positions; K9 and K10 as "(FHN width)", "(Lorenz-63
width)", "(controls, FHN width)" and "(controls, Lorenz-96 width)", from
phases aw and ax); the rows of K1, K4, K5-K11 carry "launches_routes", the
train steps' launches of phases ay-ba by configuration; K7, K8 and K11 carry
"launches_sharded" (a rank's in bb-bd) and appear once more as "(sharded,
per shard)", at the 1x8 mesh's per-shard shape, timed in bb; K1, K4, K14
and K15 once more per phase-be configuration; K7 as "(any K)", its times by
K in "by_k", K11 as "(K=32768)" and K9 and K10 per REACH_TRUNK shape, from
phase bf; K5 and K6 as "(wide, Lorenz-96)" and K12 and K13 as "(class, (3,
1) width 48)", from phase bg; K1, K4, K14 and K15 as "(width W, (2, 2))"
for W in 72, 128, 256, from phase bh; the last line
is the device record. Imports nothing of JAX: the
machine with the card has none.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
TRAIN_CALLS = 2  # phases i, m, y, ab, ac, ai: train calls (3 until the run's time was cut)
FP32_PEAK = 67e12  # FLOP/s on the CUDA cores, H100 SXM at 700 W
HBM_PEAK = 3.35e12  # bytes/s
TF32_PEAK = 495e12  # FLOP/s on the tensor cores, dense TF32


_LAST = [time.perf_counter()]
_START = _LAST[0]
_PHASES = []  # (label, start, end), seconds after the script's start
_SHAPES_DONE = {}  # phase be's shape library: seconds after the start when its build ended


def phase_done(label: str) -> None:
    """Print the seconds since the previous phase ended."""
    now = time.perf_counter()
    print(f"[time] {label}: {now - _LAST[0]:.1f} s", flush=True)
    _PHASES.append((label, _LAST[0] - _START, now - _START))
    _LAST[0] = now


def build_shapes_beside(keys) -> None:
    """Build phase be's shape libraries in background threads at nice 19, so
    that the compilers take the cores the phases leave idle (the phases'
    host work is one Python thread, bb-bd's gloo ranks aside), and record
    when each build ended (`shapes_line`)."""
    import threading

    from psvo_tpu_torch.ops import _build

    def run(key):
        try:
            _build.load_shape_library(key, niceness=19)
        except Exception:  # noqa: BLE001 - phase be's load_shape_library builds again and raises
            pass
        _SHAPES_DONE[key] = time.perf_counter() - _START

    for key in keys:
        threading.Thread(target=run, args=(key,), daemon=True).start()


def shapes_line(keys) -> str:
    """When each of phase be's shape libraries was built, and the phases
    that ran beside the builds (their host-clock figures shared the host's
    cores with the compilers)."""
    ends = [_SHAPES_DONE.get(k) for k in keys]
    if any(e is None for e in ends):
        return "shape libraries: a build had not ended when phase be began"
    start = next((b for lbl, a, b in _PHASES if lbl.startswith("a, b")), 0.0)
    last = max(ends, default=start)
    beside = [lbl.split(":")[0] for lbl, a, b in _PHASES if b > start and a < last]
    return (f"shape libraries built {start:.1f}-{last:.1f} s after the start ("
            + ", ".join(f"{k} at {e:.1f} s" for k, e in zip(keys, ends))
            + f"), beside phases {beside[0] + '-' + beside[-1] if beside else 'none'}")


def fail(msg: str) -> None:
    """Print msg on both streams (a caller that keeps only one still sees it)
    and exit 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"chip_smoke.py FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


PROFILE_TRIES = 8
PROFILE_WINDOWS = {"windows": 0, "empty": 0, "partial": 0, "events": 0, "queue_ran_dry": 0}
PROFILER_DEAD = [False]  # PROFILE_TRIES windows in a row came back empty


def profiled_kernels(window):
    """The device events of one torch.profiler window around window() (and a
    synchronize), or None if the profiler recorded none. Now and then a
    window comes back with no device events at all although its kernels ran
    (on the H100 with torch 2.11, in a random phase): such a window is run
    again, a second later, up to PROFILE_TRIES times, and counted in
    PROFILE_WINDOWS. Sometimes the profiler then stays empty for the rest of
    the process: after PROFILE_TRIES empty windows in a row every later
    window is tried once, and the callers time by CUDA events instead while
    it stays empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA]
    tries = 1 if PROFILER_DEAD[0] else PROFILE_TRIES
    for attempt in range(1, tries + 1):
        PROFILE_WINDOWS["windows"] += 1
        with profile(activities=acts) as prof:
            window()
            torch.cuda.synchronize()
        kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if kern:
            PROFILER_DEAD[0] = False
            return kern
        PROFILE_WINDOWS["empty"] += 1
        if not PROFILER_DEAD[0]:
            print(f"[profiler] a window recorded no device events (attempt {attempt} of "
                  f"{PROFILE_TRIES})", flush=True)
            time.sleep(1.0)
    if not PROFILER_DEAD[0]:
        print(f"[profiler] {PROFILE_TRIES} windows in a row recorded no device events: timing by "
              f"CUDA events while the profiler stays empty", flush=True)
    PROFILER_DEAD[0] = True
    PROFILE_WINDOWS["events"] += 1
    return None


_SPIN_CYCLES_PER_MS = [0.0]


def queued_ms(fn, n: int = 20) -> float:
    """Device time per call of fn(): CUDA events around n calls queued behind
    a spin kernel (torch.cuda._sleep) that holds the card while the host
    launches them, so that they run back to back and the span holds their
    time and the card's own gaps between kernels, not the host's. If the
    spin ended before the host had queued the n calls, the queue may have
    run dry: the window runs again with a spin twice as long (four times at
    most, then counted in PROFILE_WINDOWS["queue_ran_dry"])."""
    import torch

    fn()
    torch.cuda.synchronize()
    if not _SPIN_CYCLES_PER_MS[0]:
        torch.cuda._sleep(1000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        torch.cuda.synchronize()
        _SPIN_CYCLES_PER_MS[0] = 1e7 / start.elapsed_time(end)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = 2.0 * host_ms + 1.0
    for _ in range(4):
        spun = torch.cuda.Event()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * _SPIN_CYCLES_PER_MS[0]))
        spun.record()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        dry = spun.query()
        torch.cuda.synchronize()
        if not dry:
            return start.elapsed_time(end) / n
        spin_ms *= 2.0
    PROFILE_WINDOWS["queue_ran_dry"] += 1
    return start.elapsed_time(end) / n


def device_ms(fn, n: int = 20) -> float:
    """Device time per call of fn(): the kernels' own time from torch.profiler
    over n calls after one warm-up, without the host's launch gaps (which
    CUDA events around a short call include)."""
    return sum(device_ms_by_kernel(fn, n).values())


def pair_ms(fn, windows: int = 3) -> float:
    """queued_ms(fn) as the median of `windows` windows: the alternated
    design pairs, each held to "the new design faster in every pair", take
    it. torch.profiler is not fit for that gate: its windows on the H100 with
    torch 2.11 often drop a kernel's events, and now and then all of one
    kernel's events, reading a design at about half its time (K6, K9 and K11
    so far), which inverts a pair that the design did not invert."""
    return statistics.median(queued_ms(fn) for _ in range(windows))


def device_ms_by_kernel(fn, n: int = 20) -> dict:
    """device_ms split by kernel name: {name: ms per call of fn()}, each the
    mean of the name's recorded events times its launches a call (its events
    over n, rounded). On the H100 with torch 2.11 a window often records only
    part of a kernel's events (17 of 20 is common, once about half): a sum
    over n calls would read low by the share dropped. Such windows are
    counted in PROFILE_WINDOWS. While the profiler records nothing the
    whole call is timed by queued_ms, under the one name EVENTS_KEY."""
    import torch

    fn()
    torch.cuda.synchronize()

    def window():
        for _ in range(n):
            fn()

    kern = profiled_kernels(window)
    if kern is None:
        return {EVENTS_KEY: queued_ms(fn, n)}
    total, count = {}, {}
    for e in kern:
        total[e.name] = total.get(e.name, 0.0) + e.time_range.elapsed_us()
        count[e.name] = count.get(e.name, 0) + 1
    if any(c % n for c in count.values()):
        PROFILE_WINDOWS["partial"] += 1
    return {name: total[name] / count[name] * max(1, round(count[name] / n)) / 1e3
            for name in total}


EVENTS_KEY = "all kernels (CUDA events, the profiler recorded none)"
PAIR_HOW = "CUDA events over 20 queued calls, median of three windows"


def time_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median milliseconds of fn() over `reps` runs, CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_resources(mangled: str) -> str:
    """Registers and spill stores of a kernel (its mangled name's start) from
    the build's -Xptxas -v output."""
    from psvo_tpu_torch.ops import _build

    log = _build.build_log()
    regs = re.search(re.escape(mangled) + r".*?Used (\d+) registers", log, re.S)
    spill = re.search(re.escape(mangled) + r"[^\n]*\n[^\n]*\n\s*(\d+) bytes stack frame, (\d+) bytes "
                      r"spill stores", log)
    return (f"{regs.group(1) if regs else '?'} registers, "
            f"{spill.group(2) if spill else '?'} bytes spill stores")


def zero_designs(*fns) -> None:
    for fn in fns:
        fn.launches_by_design = dict.fromkeys(fn.launches_by_design, 0)


FHN_KERNELS = {"K1": ("scan_forward_kernel",), "K4": ("scan_backward_kernel", "sum_rows_kernel")}
K6_KERNELS = ("ffbsi_bwd_paths_kernel", "ffbsi_bwd_staged_kernel")  # the staged design's two kernels
PSVO_KERNELS = dict(FHN_KERNELS, K5=("ffbsi_staged_kernel",), K6=K6_KERNELS)
L96_KERNELS = {"K9": ("trunk_forward_async_kernel",), "K7": ("ancestor_indices_cluster_kernel",),
               "K8": ("gather_particles_kernel",)}
L96_TRAIN_KERNELS = dict(L96_KERNELS, K10=("trunk_backward_tf32x3_kernel", "trunk_sum_ctas_kernel",
                                           "trunk_sum_tiles_kernel"),
                         K11=("segment_sum_tiled_kernel",))
L96 = "lorenz96_fivo_k8192_sharded"


def device_breakdown(fn, n_steps: int, groups: dict) -> str:
    """Run fn() once under torch.profiler and split the device time per step
    into the kernels of `groups` (name -> substrings of kernel names) and
    every other kernel; the span runs from the first kernel's start to the
    last one's end, and idle is the share of it with no kernel running (one
    stream, so kernels do not overlap). Each group prints the events it
    recorded: the profiler may drop some, and its time is theirs. The window
    records the device's activity alone: CPU events would cost the profiler
    seconds a window, and half a minute on an eager step of ~50,000
    operations."""
    import torch

    kern = profiled_kernels(fn)
    if kern is None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return (f"span, device busy and idle not measured (torch.profiler recorded no device "
                f"events); one more call {start.elapsed_time(end) / n_steps:.3f} ms/step by CUDA "
                f"events, the host's gaps included")
    span = max(e.time_range.end for e in kern) - min(e.time_range.start for e in kern)
    busy = sum(e.time_range.elapsed_us() for e in kern)
    per = 1e3 * n_steps  # us -> ms per step
    parts, named, n_named = [], 0.0, 0
    for label, keys in groups.items():
        mine = [e for e in kern if any(k in e.name for k in keys)]
        us = sum(e.time_range.elapsed_us() for e in mine)
        named, n_named = named + us, n_named + len(mine)
        parts.append(f"{label} {us / per:.3f} ({len(mine)} events)")
    others = {}
    for e in kern:
        if not any(k in e.name for keys in groups.values() for k in keys):
            others[e.name[:60]] = others.get(e.name[:60], 0.0) + e.time_range.elapsed_us()
    top = sorted(others.items(), key=lambda kv: -kv[1])[:5]
    return (f"span {span / per:.3f} ms/step, device busy {busy / per:.3f} ms/step (idle "
            f"{100 * (1 - busy / span):.1f}% of the span), " + ", ".join(parts)
            + f", {(len(kern) - n_named) / n_steps:.0f} other device ops "
            f"{(busy - named) / per:.3f} ms/step, the largest: "
            + "; ".join(f"{n} {us / per:.3f}" for n, us in top))


def slice_config(small: bool, preset: str = "fhn_fivo_k1024_bench"):
    """The preset, or its small cut (B=4, K=128, T=10, hidden (16, 16))."""
    from psvo_tpu_torch.config import NetConfig, PRESETS

    cfg = PRESETS[preset]
    if not small:
        return cfg, 32
    net = NetConfig(hidden=(16, 16))
    cfg = dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, t_steps=10),
        smc=dataclasses.replace(cfg.smc, n_particles=128),
    ).with_nets(q0=net, q1=net, q2=net, f=net, qb=net,
                g=dataclasses.replace(net, sigma_init=0.5))
    return cfg, 4


def kernel_inputs(ssm, cfg, ys, gen, controls=None):
    """What _forward_filter_fused hands K1, plus ell0, with fresh streams; for
    a model with controls (ssm.di > 0) the coef rows end in the controls'
    first-layer terms (`controls` [B, T, Di], or fresh N(0, 1) draws)."""
    import torch
    from psvo_tpu_torch import smc
    from psvo_tpu_torch.ops import fused_step

    batch, t_steps, _ = ys.shape
    k, dev = cfg.smc.n_particles, ys.device
    ys_tm = ys.transpose(0, 1)
    consts = fused_step.prepare(ssm)
    aq, cq, sq, logsq = fused_step.fusion_coeffs(ssm, cfg.smc, consts, ys_tm)
    eps0 = torch.randn((batch, ssm.dx, k), generator=gen, device=dev)
    eps = torch.randn((t_steps - 1, batch, ssm.dx, k), generator=gen, device=dev)
    u0 = torch.rand((t_steps - 1, batch), generator=gen, device=dev)
    x0, alpha0 = smc._init_t0(ssm, eps0, ys_tm[0], ys_tm[0])
    ab = logsq[1:] - consts["log_sf_sum"] - consts["log_sg_sum"] - ssm.dy * 0.5 * math.log(2 * math.pi)
    ctrl_bias = None
    if ssm.di:
        if controls is None:
            controls = torch.randn((batch, t_steps, ssm.di), generator=gen, device=dev)
        ctrl_bias = fused_step.control_term(consts, controls.transpose(0, 1)[1:])
    coef = fused_step.pack_coef(aq[1:], cq[1:], sq[1:], ys_tm[1:], ab, ctrl_bias)
    ell0 = torch.logsumexp(alpha0, -1) - math.log(k)
    return dict(x0=x0.contiguous(), alpha0=alpha0.contiguous(), coef=coef, consts=consts,
                eps=eps, positions=fused_step.systematic_positions(u0, k), ell0=ell0)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def k5_bytes(ops, kern) -> int:
    """Bytes K5 must move: x_anchor, r, mr, c, lwn and gum read in full; of xs
    and lg only the particles the sweep picked (each distinct (t, b, j) of the
    selections once: Dx floats and one); its outputs (x_first, logp, logq,
    xtilde, sel) written once."""
    import torch

    x_anchor, xs, r, mr, c, lwn, lg, gum = ops
    sel = kern[4]
    t1, b, dx, k = xs.shape
    rows = torch.arange(t1 * b, device=sel.device).view(t1, b, 1) * k
    picked = int(torch.unique(rows + sel.long()).numel())
    return nbytes(x_anchor, r, mr, c, lwn, gum, *kern) + picked * (dx + 1) * xs.element_size()


def bound(flops: float, n_bytes: float):
    """(ms, what bounds it): the least time for the work at the card's peaks."""
    t_ops, t_bytes = flops / FP32_PEAK, n_bytes / HBM_PEAK
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def trunk_flops(consts) -> int:
    """FLOP of the q1, f and g trunk forwards for one particle."""
    dx, dy, h, n_mid = consts["dx"], consts["dy"], consts["hidden"], consts["n_mid"]

    def net(dout):
        return 2 * (dx * h + n_mid * h * h + h * dout)

    return 2 * net(dx) + net(dy)


def max_err(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def close(got, want, tol):
    import torch

    return all(torch.allclose(g, w, rtol=tol, atol=tol) for g, w in zip(got, want))


def teacher_forced(inp, kern, dx):
    """One plain step from each of the kernel's own states: per-step
    agreement with the accumulated drift removed. A particle whose drawn
    position differs by more than 1e-3 took another ancestor (a flip); the
    rest are compared value by value. Returns (flips, max |Δ| elsewhere)."""
    import torch
    from psvo_tpu_torch.ops import fused_step

    x_all, a_all = kern[3], kern[4]
    t1, b, _, k = x_all.shape
    x_prev = torch_cat_prev(inp["x0"], x_all).reshape(t1 * b, dx, k)
    a_prev = torch_cat_prev(inp["alpha0"], a_all).reshape(t1 * b, k)
    ref = fused_step.scan_forward_reference(
        x_prev.contiguous(), a_prev.contiguous(), inp["coef"].reshape(1, t1 * b, -1),
        inp["consts"], inp["eps"].reshape(1, t1 * b, dx, k),
        inp["positions"].reshape(1, t1 * b, k), cache=True,
    )
    x_ref = ref[3].reshape(t1, b, dx, k)
    a_ref = ref[4].reshape(t1, b, k)
    flipped = ((x_ref - x_all).abs() > 1e-3 * (1 + x_all.abs())).any(dim=2)
    ok = ~flipped
    err = max(float((x_ref - x_all).abs().amax(dim=2)[ok].max()),
              float(((a_ref - a_all).abs() / (1 + a_all.abs()))[ok].max()))
    return int(flipped.sum()), err


def free_run_flips(inp, kern, ref):
    """Ancestor flips between the kernel's and the plain version's free runs.
    Per step, each run draws the ancestors of its own incoming weights (the
    teacher-forced check shows the kernel draws exactly the plain ancestors
    of its own weights). A row's first step with a differing ancestor is
    where rounding crossed a CDF boundary; after it the two runs follow other
    particles. Returns, per row, that first step (-1: none) and the number of
    ancestors that differ there."""
    from psvo_tpu_torch.ops import fused_step

    a_k = torch_cat_prev(inp["alpha0"], kern[4])
    a_r = torch_cat_prev(inp["alpha0"], ref[4])
    t1, b, k = a_k.shape
    pos = inp["positions"].reshape(t1 * b, k)
    idx_k = fused_step.count_form_indices(a_k.reshape(t1 * b, k), pos).reshape(t1, b, k)
    idx_r = fused_step.count_form_indices(a_r.reshape(t1 * b, k), pos).reshape(t1, b, k)
    per_step = (idx_k != idx_r).sum(dim=2)  # [T1, B]
    first, count = [], []
    for row in range(b):
        steps = per_step[:, row].nonzero()
        first.append(int(steps[0]) if len(steps) else -1)
        count.append(int(per_step[first[-1], row]) if len(steps) else 0)
    return first, count


def torch_cat_prev(first, stack):
    """[first, stack[0], ..., stack[-2]]: each step's incoming state."""
    import torch

    return torch.cat([first[None], stack[:-1]])


def check_scan(name, ssm, cfg, ys, gen, tol, rng_seed=None):
    """K1 against its plain version on identical inputs. Returns a dict."""
    import torch
    from psvo_tpu_torch.ops import fused_step

    inp = kernel_inputs(ssm, cfg, ys, gen)
    if rng_seed is not None:  # in-kernel RNG; the plain side replays K2's streams
        t1, b = inp["coef"].shape[:2]
        eps, u0 = fused_step.stream_noise(rng_seed, t1, b, ssm.dx, cfg.smc.n_particles, ys.device)
        inp["eps"], inp["positions"] = eps, fused_step.systematic_positions(u0, cfg.smc.n_particles)
        kern = fused_step.scan_forward(inp["x0"], inp["alpha0"], inp["coef"], inp["consts"],
                                       seed=rng_seed, cache=True)
        same = fused_step.scan_forward(inp["x0"], inp["alpha0"], inp["coef"], inp["consts"],
                                       eps=inp["eps"], positions=inp["positions"], cache=True)
        if not all(torch.equal(a, b) for a, b in zip(kern[:3], same[:3])):
            fail(f"{name}: in-kernel RNG run differs from the stream run on K2's streams")
    else:
        kern = fused_step.scan_forward(inp["x0"], inp["alpha0"], inp["coef"], inp["consts"],
                                       eps=inp["eps"], positions=inp["positions"], cache=True)
    ref = fused_step.scan_forward_reference(inp["x0"], inp["alpha0"], inp["coef"], inp["consts"],
                                            inp["eps"], inp["positions"], cache=True)
    torch.cuda.synchronize()
    log_z_k = inp["ell0"] + kern[2][:, :, 0].sum(0)
    log_z_r = inp["ell0"] + ref[2][:, :, 0].sum(0)
    rel = (log_z_k - log_z_r).abs() / log_z_r.abs()
    tf_flips, tf_err = teacher_forced(inp, kern, ssm.dx)
    first, count = free_run_flips(inp, kern, ref)
    clean = torch.tensor([f < 0 for f in first], device=rel.device)
    finite = all(bool(torch.isfinite(t).all()) for t in kern[:3])
    return dict(
        close=close(kern[:3], ref[:3], tol), max_abs_err=max_err(kern[:3], ref[:3]),
        rel_d_log_z=float(rel.max()),
        rel_d_log_z_clean=float(rel[clean].max()) if bool(clean.any()) else 0.0,
        flipped=[f"{float(r):.1e}@t{f}x{n}" for r, f, n in zip(rel, first, count) if f >= 0],
        flip_rows=int((~clean).sum()), tf_flips=tf_flips, tf_err=tf_err, finite=finite,
    )


def scan_line(r) -> str:
    return (f"allclose(2e-4)={r['close']} max|d|={r['max_abs_err']:.3e}; teacher-forced: "
            f"{r['tf_flips']} flips, max|d| {r['tf_err']:.3e}; free run: max rel d logZ "
            f"{r['rel_d_log_z']:.3e}, {r['flip_rows']} rows with an ancestor flip, max rel "
            f"d logZ over rows without {r['rel_d_log_z_clean']:.3e}; flipped rows as "
            f"rel-d-logZ@t<first step>x<ancestors differing there>: {r['flipped']}")


def scan_ok(r, small: bool) -> bool:
    """Small size: allclose at 2e-4. Full size: every step agrees from the
    kernel's own state (teacher-forced, no flips), and every row without an
    ancestor flip in the free run agrees in log Z to 1e-4 relative."""
    if small:
        return r["close"]
    return (r["finite"] and r["tf_flips"] == 0 and r["tf_err"] < 1e-4
            and r["rel_d_log_z_clean"] < 1e-4)


def check_backward(ssm, cfg, ys, gen, rng_seed=None, cache=False):
    """K4 against scan_backward_reference on the residuals of one K1 run, so no
    ancestor can flip. Cotangents: d_ℓ = −1/B on every step, random ones on
    the dropped stats columns, x_last and alpha_last (and under `cache`
    x_all and alpha_all). Returns per-leaf relative L2 errors and max |Δ|,
    whether idx is nondecreasing, and the operands for timing."""
    import torch
    from psvo_tpu_torch.ops import fused_step

    inp = kernel_inputs(ssm, cfg, ys, gen)
    args = (inp["x0"], inp["alpha0"], inp["coef"], inp["consts"])
    t1, b = inp["coef"].shape[:2]
    k, dev = cfg.smc.n_particles, ys.device
    if rng_seed is not None:  # the plain side replays K2's streams
        eps = fused_step.stream_noise(rng_seed, t1, b, ssm.dx, k, dev)[0]
        noise = {"seed": rng_seed}
        fwd = fused_step.scan_forward(*args, seed=rng_seed, cache=cache, save_res=True)
    else:
        eps, noise = inp["eps"], {"eps": inp["eps"]}
        fwd = fused_step.scan_forward(*args, eps=eps, positions=inp["positions"], cache=cache,
                                      save_res=True)
    x_last, alpha_last, stats, x_all, alpha_all, idx = fwd
    d_stats = torch.randn(stats.shape, generator=gen, device=dev)
    d_stats[..., 0] = -1.0 / b
    cots = [torch.randn(t.shape, generator=gen, device=dev) for t in (x_last, alpha_last)]
    if cache:
        cots += [torch.randn(t.shape, generator=gen, device=dev) * 0.1 for t in (x_all, alpha_all)]
    else:
        cots += [None, None]
    bwd = (inp["x0"], x_all, idx, stats, inp["coef"], inp["consts"], d_stats, *cots)
    got = fused_step.scan_backward(*bwd, **noise)
    want = fused_step.scan_backward_reference(inp["x0"], inp["coef"], inp["consts"], eps, idx,
                                              d_stats, *cots)
    torch.cuda.synchronize()
    rel = [float((g - w).norm() / w.norm().clamp_min(1e-30)) for g, w in zip(got, want)]
    h2 = 2 * inp["consts"]["hidden"] if ssm.di else 0  # the controls' d_coef columns
    return dict(
        rel=rel, maxd=[float((g - w).abs().max()) for g, w in zip(got, want)],
        rel_ctrl=float((got[1][..., -h2:] - want[1][..., -h2:]).norm()
                       / want[1][..., -h2:].norm().clamp_min(1e-30)) if h2 else None,
        monotone=bool((idx[..., 1:] >= idx[..., :-1]).all()),
        finite=all(bool(torch.isfinite(g).all()) for g in got),
        kernel=lambda: fused_step.scan_backward(*bwd, **noise),
        plain=lambda: fused_step.scan_backward_reference(inp["x0"], inp["coef"], inp["consts"],
                                                         eps, idx, d_stats, *cots),
        n_bytes=nbytes(*bwd[:5], inp["consts"]["packed"], inp["consts"]["sconst"], d_stats,
                       *cots, None if rng_seed is not None else eps, *got),
        flops=3 * trunk_flops(inp["consts"]) * t1 * b * k,
    )


def ffbsi_operands(ssm, cfg, ys, gen):
    """K5's operands as the PSVO objective builds them, from the cache of one
    K1 run (stream mode): the anchors drawn from the last weights, the
    support x_0 .. x_{T-2}, its transition terms r/mr/c, the normalized
    log-weights, zero emission terms and fresh Gumbels."""
    from types import SimpleNamespace

    import torch
    from psvo_tpu_torch import objectives
    from psvo_tpu_torch.distributions import log_normalize
    from psvo_tpu_torch.ops import fused_step

    inp = kernel_inputs(ssm, cfg, ys, gen)
    x_last, alpha_last, _, x_all, alpha_all, _ = fused_step.scan_forward(
        inp["x0"], inp["alpha0"], inp["coef"], inp["consts"], eps=inp["eps"],
        positions=inp["positions"], cache=True)
    xs = torch.cat([inp["x0"][None], x_all])
    lwn = log_normalize(torch.cat([inp["alpha0"][None], alpha_all])[:-1], dim=-1)[0]
    batch, m, k = ys.shape[0], cfg.smc.n_smoothing_particles, cfg.smc.n_particles
    x_anchor, _ = objectives._sample_final_particles(
        objectives._gumbel(gen, (batch, m, k)), SimpleNamespace(x_last=x_last, logw_last=alpha_last))
    r, mr, c = objectives._support_terms(ssm, xs[:-1], differentiable=False)
    gum = objectives._gumbel(gen, (xs.shape[0] - 1, batch, m, k))
    return [x_anchor.contiguous(), xs[:-1].contiguous(), r, mr, c, lwn.contiguous(),
            torch.zeros_like(lwn), gum]


def check_ffbsi(ops, gen):
    """K5 against its plain version on the same operands, then K6 against its
    plain version on K5's selections, with cotangents on all four outputs
    (the direct bound's case) and on the paths alone (the forward bound's:
    no support gradient wanted). A path with a selection that differs
    somewhere is a flip; every other path is held to x~ equal and logp/logq
    to 1e-5 relative. Returns a dict, with K6's operands for timing."""
    import torch
    from psvo_tpu_torch.ops import ffbsi

    kern = ffbsi.ffbsi_forward(*ops)
    ref = ffbsi.ffbsi_forward_reference(*ops)
    torch.cuda.synchronize()
    differ = kern[4] != ref[4]  # [T-1, B, M]
    clean = ~differ.any(0)  # [B, M]: paths with no differing selection
    same_x = bool(torch.equal(kern[3][:, clean], ref[3][:, clean])
                  and torch.equal(kern[0][clean], ref[0][clean]))
    rel = [float(((a - b).abs() / b.abs().clamp_min(1e-30))[clean].max())
           for a, b in zip(kern[1:3], ref[1:3])]
    x_anchor, xs, r, mr, c, lwn, lg, _ = ops
    sel, xtilde = kern[4], kern[3]
    cots = [torch.randn(t.shape, generator=gen, device=t.device) for t in kern[:4]]
    names = ("d_x_first", "d_logp", "d_logq", "d_xtilde")
    bwd = {}
    for mode, (live, needs) in K6_MODES.items():
        kw = {n: cots[i] if i in live else None for i, n in enumerate(names)}
        args = (x_anchor, xs, r, mr, c, lwn, lg, sel, xtilde)
        got = ffbsi.ffbsi_backward(*args, needs=needs, **kw)
        want = ffbsi.ffbsi_backward_reference(*args, needs=needs, **kw)
        torch.cuda.synchronize()
        pairs = [(g, w) for g, w in zip(got, want) if w is not None]
        reads = (x_anchor, xtilde, sel, r, mr, c, lwn) if mode != "paths only" else (sel,)
        bwd[mode] = dict(
            rel=[float((g - w).norm() / w.norm().clamp_min(1e-30)) for g, w in pairs],
            maxd=[float((g - w).abs().max()) for g, w in pairs],
            finite=all(bool(torch.isfinite(g).all()) for g, _ in pairs),
            nones=all((g is None) == (w is None) for g, w in zip(got, want)),
            kernel=lambda a=args, n=needs, k=kw: ffbsi.ffbsi_backward(*a, needs=n, **k),
            plain=lambda a=args, n=needs, k=kw: ffbsi.ffbsi_backward_reference(*a, needs=n, **k),
            n_bytes=nbytes(*reads, *[v for v in kw.values() if v is not None],
                           *[g for g, _ in pairs]),
            args=args, kw=kw, needs=needs,
        )
    return dict(flips=int(differ.sum()), flip_paths=int((~clean).sum()), same_x=same_x,
                rel_logp=rel[0], rel_logq=rel[1],
                max_abs_err=max(float((a.float() - b.float()).abs().max())
                                for a, b in zip(kern[:4], ref[:4])),
                finite=all(bool(torch.isfinite(t).all()) for t in kern[:4]),
                bwd=bwd, kern=kern)


def k2_check(seed, t1, b, dx, k, dev, label):
    """K2's pair and particle designs against the plain Philox, bit for bit,
    and against each other; their device times alternated, three pairs (the
    pair design must be faster in each). Returns a dict."""
    import torch
    from psvo_tpu_torch.ops import fused_step

    want = fused_step.stream_noise_reference(seed, t1, b, dx, k, dev)
    got = {d: fused_step.stream_noise(seed, t1, b, dx, k, dev, design=d)
           for d in fused_step.K2_DESIGNS}
    torch.cuda.synchronize()
    bad = {d: [int((g[i] != want[i]).sum()) for i in (0, 1)] for d, g in got.items()}
    same = all(torch.equal(got["pair"][i], got["particle"][i]) for i in (0, 1))
    pairs = [tuple(pair_ms(lambda: fused_step.stream_noise(seed, t1, b, dx, k, dev, design=d))
                   for d in fused_step.K2_DESIGNS) for _ in range(3)]
    plain = time_ms(lambda: fused_step.stream_noise_reference(seed, t1, b, dx, k, dev), reps=5)
    eps, u0 = got["pair"]
    bound_ms, by = bound(80.0 * eps.numel(), nbytes(eps, u0))
    r = dict(ms=statistics.mean(p_[0] for p_ in pairs), ms_prev=statistics.mean(p_[1] for p_ in pairs),
             plain=plain, bound=bound_ms, by=by, err=float((eps - want[0]).abs().max()),
             ctas=fused_step.k2_plan(t1, b, dx, k)["ctas"])
    print(f"[{label}] K2 stream_noise [{t1},{b},{dx},{k}]: (eps, u0) mismatches with the plain Philox "
          f"{bad}; pair and particle bit-equal {same}; eps mean {float(eps.mean()):.4f} std "
          f"{float(eps.std()):.4f}, u0 mean {float(u0.mean()):.4f}; device time ({PAIR_HOW}) "
          f"(pair, particle) "
          f"alternated: " + ", ".join(f"({a:.4f}, {c:.4f})" for a, c in pairs)
          + f" ms ({r['ctas']} CTAs, {kernel_resources('stream_noise_pair_kernel')}); plain "
          f"{plain:.4f} ms (events); bound {bound_ms:.4f} ms ({by})", flush=True)
    if any(sum(v) for v in bad.values()) or not same:
        fail(f"K2 at [{t1},{b},{dx},{k}] is not bit-equal to the plain Philox in both designs")
    if not all(a < c for a, c in pairs):
        fail(f"K2 at [{t1},{b},{dx},{k}]: the pair design is not faster than the particle one in "
             f"every pair")
    return r


def ffbsi_sweep(dev, dx, b, m, k, t1, gen):
    """K6's operands off the presets' shapes: support terms of a transition
    with means near the support, normalized weights, anchors; K5's
    selections and trajectories on them."""
    import torch
    from psvo_tpu_torch.ops import ffbsi

    xs = torch.randn((t1, b, dx, k), generator=gen, device=dev) * 8.0
    mean = xs + torch.randn(xs.shape, generator=gen, device=dev)
    scale = 0.5 + 1.5 * torch.rand(xs.shape, generator=gen, device=dev)
    r = 1.0 / (scale * scale)
    c = -0.5 * (mean * mean * r).sum(2) - torch.log(scale).sum(2) - dx * 0.9189385332
    lwn = torch.log_softmax(torch.randn((t1, b, k), generator=gen, device=dev) * 2.0, dim=-1)
    lg = torch.randn((t1, b, k), generator=gen, device=dev)
    u = torch.rand((t1, b, m, k), generator=gen, device=dev).clamp_min(1e-30)
    ops = [v.contiguous() for v in (torch.randn((b, m, dx), generator=gen, device=dev) * 8.0, xs, r,
                                    mean * r, c, lwn, lg, -torch.log(-torch.log(u)))]
    with torch.no_grad():
        fwd = ffbsi.ffbsi_forward(*ops)
    return (*ops[:7], fwd[4], fwd[3]), fwd


K6_MODES = {  # live cotangents among d_x_first, d_logp, d_logq, d_xtilde; the support's needs
    "all cotangents": ((0, 1, 2, 3), (True,) * 5),
    "direct bound": ((2, 3), (True, True, True, True, False)),  # what its train step hands K6
    "paths only": ((0, 3), (False,) * 5),  # the forward bound's
}


def k6_design_check(args, kw, needs):
    """K6 staged against the row design on the same operands and cotangents:
    per-leaf relative L2, whether every leaf is bit-equal, and whether each
    design gives its own bits again on a relaunch."""
    import torch
    from psvo_tpu_torch.ops import ffbsi

    st = ffbsi.ffbsi_backward(*args, needs=needs, **kw)
    again = ffbsi.ffbsi_backward(*args, needs=needs, **kw)
    row = ffbsi.ffbsi_backward(*args, needs=needs, design="row", **kw)
    row2 = ffbsi.ffbsi_backward(*args, needs=needs, design="row", **kw)
    torch.cuda.synchronize()
    pairs = [(a, w) for a, w in zip(st, row) if a is not None]
    return dict(staged=st, row=row,
                rel=[float((a - w).norm() / w.norm().clamp_min(1e-30)) for a, w in pairs],
                equal=all(torch.equal(a, w) for a, w in pairs),
                relaunch=all(torch.equal(a, w) for a, w in zip(st + row, again + row2)
                             if a is not None),
                finite=all(bool(torch.isfinite(a).all()) for a, _ in pairs))


def k6_wide_check(args, kw, needs, staged, plain, row):
    """Per leaf, the relative L2 distance of the staged design, the float32
    plain version and the row design to the plain version replayed in
    float64. Under the direct bound's cotangents (d_logp = 0) d_q is a
    difference of two nearly equal sums, so every float32 order lies about
    1e-4 to 1e-3 from the others there; the staged design must then be as
    close to float64 as the plain version (within twice, or the tolerance)
    and as the row design (within twice, or 1e-5)."""
    from psvo_tpu_torch.ops import ffbsi

    wide = [a.double() if a.is_floating_point() else a for a in args]
    w64 = ffbsi.ffbsi_backward_reference(*wide, needs=needs,
                                         **{n: None if v is None else v.double() for n, v in kw.items()})

    def dist(got):
        return [float((g.double() - w).norm() / w.norm().clamp_min(1e-300))
                for g, w in zip(got, w64) if w is not None]

    return dist(staged), dist(plain), dist(row)


def l96_config(small: bool):
    """The Lorenz-96 preset (B=8), or its small cut (B=4, K=128, T=10,
    hidden (16, 16)); Dx=Dy=40 either way."""
    cfg, batch = slice_config(small, L96)
    return cfg, (4 if small else cfg.train.batch_size)


def weight_rows(k: int, gen):
    """Eight log-weight rows on the card: generic, uniform, ties, zero
    weights, all floored, a floored mix, one dominant particle (the
    degenerate regime) and a wide spread."""
    import torch

    dev = gen.device
    i = torch.arange(k, device=dev)
    return torch.stack([
        torch.randn(k, device=dev, generator=gen) * 3,
        torch.zeros(k, device=dev),
        torch.randint(0, 3, (k,), device=dev, generator=gen).float() * -1,
        torch.where(i % 3 == 0, 0.0, -float("inf")),
        torch.full((k,), -3e30, device=dev),
        torch.where(i % 5 == 0, -1.0, -1e30),
        torch.where(i == (517 * k) // 1024, 0.0, -50.0),
        torch.linspace(-100.0, 0.0, k, device=dev),
    ]).contiguous()


def trunk_run(ssm, cfg, ys, gen, rng_seed=None):
    """One kernel run of the trunk path over all T−1 steps (K7, K8, K9 on the
    run's own state), holding K9's plain version to every step's x_res
    (teacher-forced) and the previous design (design="tile", bit-equal),
    and with the in-kernel draw also K9's stream mode on K2's ε (bit-equal);
    beside it the plain versions' own free run on the same noise. Returns
    the per-step relative L2 of x_new and α, the largest |Δ|, whether every
    step was allclose at 2e-4, whether every step was bit-equal to the tile
    design, the rows whose free runs took another ancestor somewhere (and
    the first such step), log Ẑ's relative difference over all rows and over
    the rows without, K7's index mismatches against its plain version on the
    same log-weights over every step, and the last step's operands."""
    import torch
    from psvo_tpu_torch import smc
    from psvo_tpu_torch.ops import fused_step, trunk
    from psvo_tpu_torch.ops import resample_gather as rg

    batch, t_steps, _ = ys.shape
    k, dx, dy, dev = cfg.smc.n_particles, ssm.dx, ssm.dy, ys.device
    ys_tm = ys.transpose(0, 1)
    consts = fused_step.prepare(ssm)
    aq, cq, sq, logsq = fused_step.fusion_coeffs(ssm, cfg.smc, consts, ys_tm)
    x0, alpha0 = smc._init_t0(ssm, torch.randn((batch, dx, k), generator=gen, device=dev),
                              ys_tm[0], ys_tm[0])
    ab = logsq[1:] - consts["log_sf_sum"] - consts["log_sg_sum"] - dy * 0.5 * math.log(2 * math.pi)
    coef = fused_step.pack_coef(aq[1:], cq[1:], sq[1:], ys_tm[1:], ab)
    pos = fused_step.systematic_positions(torch.rand((t_steps - 1, batch), generator=gen,
                                                     device=dev), k)
    if rng_seed is not None:
        eps = fused_step.stream_noise(rng_seed, t_steps - 1, batch, dx, k, dev)[0]
    else:
        eps = torch.randn((t_steps - 1, batch, dx, k), generator=gen, device=dev)
    x, logw = x0.contiguous(), alpha0.contiguous()
    x_p, logw_p = x, logw  # the plain versions' own free run
    flip_step = torch.full((batch,), -1, device=dev)
    ell_k, ell_p = [], []
    rel, maxd, close_all, same, same_tile, k7_bad = [], [], True, True, True, 0
    for t in range(t_steps - 1):
        idx = rg.ancestor_indices_large(logw, pos[t].contiguous())
        k7_bad += int((idx != rg.ancestor_indices_large_reference(logw, pos[t])).sum())
        idx_p = rg.ancestor_indices_large_reference(logw_p, pos[t])
        flipped = (idx != idx_p).any(dim=-1) & (flip_step < 0)
        flip_step = torch.where(flipped, torch.full_like(flip_step, t), flip_step)
        x_p, logw_p = trunk.trunk_forward_reference(rg.gather_particles_reference(x_p, idx_p),
                                                    coef[t], consts, eps[t])
        x_res = rg.gather_particles(x, idx)
        noise = {"seed": rng_seed, "t": t} if rng_seed is not None else {"eps": eps[t]}
        got = trunk.trunk_forward(x_res, coef[t], consts, **noise)
        same_tile &= all(torch.equal(a, b) for a, b in
                         zip(got, trunk.trunk_forward(x_res, coef[t], consts, **noise,
                                                      design="tile")))
        if rng_seed is not None:
            same &= all(torch.equal(a, b) for a, b in
                        zip(got, trunk.trunk_forward(x_res, coef[t], consts, eps=eps[t])))
        want = trunk.trunk_forward_reference(x_res, coef[t], consts, eps[t])
        rel.append(torch.stack([(g - w).norm() / w.norm().clamp_min(1e-30)
                                for g, w in zip(got, want)]))
        maxd.append(torch.stack([(g - w).abs().max() for g, w in zip(got, want)]))
        close_all &= close(got, want, 2e-4)
        x, logw = got
        ell_k.append(torch.logsumexp(logw, -1))
        ell_p.append(torch.logsumexp(logw_p, -1))
    rel = torch.stack(rel)
    # log Ẑ less the common t = 0 term and the −log K of every step
    log_z_k, log_z_p = torch.stack(ell_k).sum(0), torch.stack(ell_p).sum(0)
    rel_z = (log_z_k - log_z_p).abs() / log_z_p.abs().clamp_min(1e-30)
    clean = flip_step < 0
    return dict(rel_x=float(rel[:, 0].max()), rel_a=float(rel[:, 1].max()),
                flip_rows=int((~clean).sum()), first_flips=flip_step.tolist(),
                rel_z=float(rel_z.max()),
                rel_z_clean=float(rel_z[clean].max()) if bool(clean.any()) else None,
                maxd=float(torch.stack(maxd).max()), close=close_all, same=bool(same),
                same_tile=bool(same_tile), finite=bool(torch.isfinite(x).all() and torch.isfinite(logw).all()),
                k7_bad=k7_bad, last=(x_res, coef[-1], consts, eps[-1]))


def relu_ties(consts, x_res, x_new, tol=1e-5, coef_row=None):
    """[B, K] bool: the particles where a relu pre-activation of q1 or f (on
    x_res) or of g (on x_new) lies within tol of the magnitude of its sum
    (|b| + Σ|w·x|, in float64). There the sign, and so the relu's gradient
    mask, depends on the order of the float32 sum: the kernel and its plain
    version may take either side, and that one unit's whole cotangent then
    passes on one side and not on the other. With controls, coef_row (the
    step's pack_coef row) supplies q1's and f's first-layer control terms."""
    import torch
    from psvo_tpu_torch.ops import fused_step

    cb = (None, None, None)
    if coef_row is not None and consts.get("di"):
        cb = (*fused_step._split_coef(coef_row, consts)[5], None)
    flag = torch.zeros((x_res.shape[0], x_res.shape[-1]), dtype=torch.bool, device=x_res.device)
    for (layers, _), inp, c in zip(fused_step._unpack_nets(consts), (x_res, x_res, x_new), cb):
        h = inp.double()
        for i, (w, b) in enumerate(layers):
            w, b = w.double(), b.double()[:, None]
            if i == 0 and c is not None:
                b = b + c.double()[:, :, None]
            pre = torch.einsum("de,bdk->bek", w, h) + b
            size = torch.einsum("de,bdk->bek", w.abs(), h.abs()) + b.abs()
            flag |= (pre.abs() < tol * size).any(dim=1)
            h = torch.relu(pre)
    return flag


def trunk_backward_run(ssm, cfg, ys, gen, rng_seed=None):
    """K10 against its plain version on every step of one kernel run of the
    trunk path (K7, K8, K9 on the run's own state), with random cotangents
    of x_new and α: teacher-forced, so both see the same x_res and x_new.
    The cotangents are zero on the particles of `relu_ties`, where a relu's
    mask is a coin toss between two float32 summation orders; the raw
    comparison, with every particle's cotangent, is reported beside it.
    The previous design (`design="simt"`) runs on every step's raw operands
    too: both recompute the trunks in K9's order, so their relu masks and
    floor cuts agree and no particle needs zeroing between them.
    Returns the largest per-step relative L2 of each leaf (d_x_res, d_coef,
    d_weights, d_sconst) and |Δ|, the raw ones, those against the previous
    design, the particles zeroed, whether a second launch on the last step
    gave the same bits, K7's index mismatches against its plain version over
    every step, and the last step's operands for timing."""
    import torch
    from psvo_tpu_torch import smc
    from psvo_tpu_torch.ops import fused_step, trunk
    from psvo_tpu_torch.ops import resample_gather as rg

    batch, t_steps, _ = ys.shape
    k, dx, dy, dev = cfg.smc.n_particles, ssm.dx, ssm.dy, ys.device
    ys_tm = ys.transpose(0, 1)
    consts = fused_step.prepare(ssm)
    aq, cq, sq, logsq = fused_step.fusion_coeffs(ssm, cfg.smc, consts, ys_tm)
    x, logw = smc._init_t0(ssm, torch.randn((batch, dx, k), generator=gen, device=dev),
                           ys_tm[0], ys_tm[0])
    ab = logsq[1:] - consts["log_sf_sum"] - consts["log_sg_sum"] - dy * 0.5 * math.log(2 * math.pi)
    coef = fused_step.pack_coef(aq[1:], cq[1:], sq[1:], ys_tm[1:], ab)
    pos = fused_step.systematic_positions(torch.rand((t_steps - 1, batch), generator=gen,
                                                     device=dev), k)
    if rng_seed is not None:
        eps = fused_step.stream_noise(rng_seed, t_steps - 1, batch, dx, k, dev)[0]
    else:
        eps = torch.randn((t_steps - 1, batch, dx, k), generator=gen, device=dev)
    x, logw = x.contiguous(), logw.contiguous()
    rel, maxd, rel_raw, rel_simt, zeroed, k7_bad = [], [], [], [], 0, 0
    for t in range(t_steps - 1):
        idx = rg.ancestor_indices_large(logw, pos[t].contiguous())
        k7_bad += int((idx != rg.ancestor_indices_large_reference(logw, pos[t])).sum())
        x_res = rg.gather_particles(x, idx)
        noise = {"seed": rng_seed, "t": t} if rng_seed is not None else {"eps": eps[t]}
        x_new, alpha = trunk.trunk_forward(x_res, coef[t], consts, **noise)
        d_x_new = torch.randn(x_new.shape, generator=gen, device=dev)
        d_alpha = torch.randn(alpha.shape, generator=gen, device=dev)
        raw = (x_res, x_new, coef[t], consts, d_x_new, d_alpha)
        got_raw = trunk.trunk_backward(*raw, **noise)
        rel_raw.append(torch.stack(
            [(g - w).norm() / w.norm().clamp_min(1e-30) for g, w in
             zip(got_raw, trunk.trunk_backward_reference(*raw[:4], eps[t], *raw[4:]))]))
        rel_simt.append(torch.stack(
            [(g - w).norm() / w.norm().clamp_min(1e-30) for g, w in
             zip(got_raw, trunk.trunk_backward(*raw, **noise, design="simt"))]))
        keep = ~relu_ties(consts, x_res, x_new)
        zeroed += int((~keep).sum())
        bwd = (x_res, x_new, coef[t], consts, d_x_new * keep[:, None], d_alpha * keep)
        got = trunk.trunk_backward(*bwd, **noise)
        want = trunk.trunk_backward_reference(*bwd[:4], eps[t], *bwd[4:])
        rel.append(torch.stack([(g - w).norm() / w.norm().clamp_min(1e-30)
                                for g, w in zip(got, want)]))
        maxd.append(torch.stack([(g - w).abs().max() for g, w in zip(got, want)]))
        x, logw = x_new, alpha
    same = all(torch.equal(a, b) for a, b in zip(got, trunk.trunk_backward(*bwd, **noise)))
    return dict(rel=torch.stack(rel).amax(0).tolist(), maxd=torch.stack(maxd).amax(0).tolist(),
                rel_raw=torch.stack(rel_raw).amax(0).tolist(),
                rel_simt=torch.stack(rel_simt).amax(0).tolist(), zeroed=zeroed,
                n=(t_steps - 1) * batch * k, same=same, finite=all(bool(torch.isfinite(g).all()) for g in got),
                k7_bad=k7_bad, last=(bwd, noise, eps[-1], got))


SVO = "lorenz63_svo_k256"
SVO_KERNELS = dict(FHN_KERNELS, K12=("svo_forward_split_kernel",),
                   K13=("svo_backward_split_kernel", "svo_sum_ctas_kernel"))


def svo_flops(consts, n_path_steps: int) -> float:
    """FLOP of the qb, f and g trunk forwards on n_path_steps (path, step) pairs."""
    dx, dy, h, n_mid = consts["dx"], consts["dy"], consts["hidden"], consts["n_mid"]

    def net(din, dout):
        return 2 * (din * h + n_mid * h * h + h * dout)

    return float(net(dx + dy, dx) + net(dx, dx) + net(dx, dy)) * n_path_steps


def svo_operands(ssm, cfg, ys, gen):
    """K12's operands as the SVO objective builds them, from one K1 run with
    the preset's in-kernel draw and the cache: the anchors drawn from the
    last weights, fresh ε, and y_t of t = 0 .. T-2."""
    from types import SimpleNamespace

    import torch
    from psvo_tpu_torch import objectives
    from psvo_tpu_torch.ops import fused_step, svo

    inp = kernel_inputs(ssm, cfg, ys, gen)
    x_last, alpha_last = fused_step.scan_forward(inp["x0"], inp["alpha0"], inp["coef"],
                                                 inp["consts"], seed=(23, 29), cache=True)[:2]
    batch, t_steps, _ = ys.shape
    m, k = cfg.smc.n_smoothing_particles, cfg.smc.n_particles
    x_anchor, _ = objectives._sample_final_particles(
        objectives._gumbel(gen, (batch, m, k)), SimpleNamespace(x_last=x_last, logw_last=alpha_last))
    eps = torch.randn((t_steps - 1, batch, m, ssm.dx), generator=gen, device=ys.device)
    y = ys.transpose(0, 1)[:-1].contiguous()
    return svo.prepare(ssm), (x_anchor.contiguous(), eps, y)


def svo_forward_check(consts, ops):
    """K12 (the split design) against its plain version: the free runs
    (x_first, lp, lq, every step of x~) and, teacher-forced, one plain step
    from each of the kernel's own x~_{t+1}; and against the previous design
    (design="chain"), bit for bit in all four outputs. Returns a dict."""
    import torch
    from psvo_tpu_torch.ops import svo

    x_anchor, eps, y = ops
    kern = svo.svo_sweep_forward(*ops, consts)
    prev = svo.svo_sweep_forward(*ops, consts, design="chain")
    ref = svo.svo_sweep_forward_reference(*ops, consts)
    t1, b, m, dx = eps.shape
    x_next = torch.cat([kern[3][1:], x_anchor[None]]).reshape(t1 * b, m, dx)
    x_tf, lp_tf, lq_tf = svo._step(svo._nets(consts), consts["sc"], dx, consts["dy"], x_next,
                                   y.reshape(t1 * b, -1), eps.reshape(t1 * b, m, dx))
    x_k = kern[3].reshape(t1 * b, m, dx)
    torch.cuda.synchronize()

    def rel(a, w):
        return float(((a - w).abs() / (1 + w.abs())).max())

    return dict(kern=kern, close=close(kern, ref, 2e-4), max_abs_err=max_err(kern, ref),
                rel_x=rel(kern[3], ref[3]), rel_lp=rel(kern[1], ref[1]), rel_lq=rel(kern[2], ref[2]),
                tf_x=rel(x_k, x_tf), same_prev=all(torch.equal(a, b) for a, b in zip(kern, prev)),
                finite=all(bool(torch.isfinite(t).all()) for t in kern))


def svo_relu_ties(consts, ops, xtilde, tol=1e-5, cbias=None):
    """[B, M] bool: the paths on which, at some step, a relu pre-activation of
    qb (on [x~_{t+1}; y_t]) or of f or g (on x~_t; f's first layer from
    b1 + cbias in the control mode) lies within tol of the magnitude of its
    sum (|b| + sum |w x|, in float64): there the relu's gradient mask depends
    on the order of the float32 sum (see relu_ties)."""
    import torch
    from psvo_tpu_torch.ops import svo

    x_anchor, _, y = ops
    x_next = torch.cat([xtilde[1:], x_anchor[None]])
    y_b = y[:, :, None, :].expand(-1, -1, x_next.shape[2], -1)
    flag = torch.zeros(x_anchor.shape[:2], dtype=torch.bool, device=x_anchor.device)
    nets = svo._nets(consts)
    for n, ((layers, _), inp) in enumerate(zip(nets, (torch.cat([x_next, y_b], -1), xtilde,
                                                      xtilde))):
        h = inp.double()
        for i, (w, b) in enumerate(layers):
            w, b = w.double(), b.double()
            if cbias is not None and n == 1 and i == 0:
                b = b + cbias[:, :, None, :].double()
            pre = h @ w + b
            size = h.abs() @ w.abs() + b.abs()
            flag |= (pre.abs() < tol * size).any(-1).any(0)
            h = torch.relu(pre)
    return flag


def svo_backward_check(consts, ops, xtilde, gen):
    """K13 (the split design) against its plain version on K12's x~, with
    random cotangents of all four outputs: raw, and zeroed on the paths of
    `svo_relu_ties`. Returns per-leaf relative L2 (d_x_anchor, d_weights,
    d_sc) and |Δ| of the masked run, the raw relative L2, the paths zeroed,
    the masked run's relative L2 against the previous design (chain),
    whether a second launch gave the same bits, and the masked run's
    operands for timing."""
    import torch
    from psvo_tpu_torch.ops import svo

    dev = xtilde.device
    b, m = xtilde.shape[1], xtilde.shape[2]
    cots = [torch.randn(s, generator=gen, device=dev) for s in
            ((b, m, xtilde.shape[3]), (b, m), (b, m), tuple(xtilde.shape))]

    def rel(got, want):
        return [float((g - w).norm() / w.norm().clamp_min(1e-30)) for g, w in zip(got, want)]

    raw = rel(svo.svo_sweep_backward(*ops, consts, xtilde, *cots),
              svo.svo_sweep_backward_reference(*ops, consts, xtilde, *cots))
    tie = svo_relu_ties(consts, ops, xtilde)
    keep = (~tie).float()
    cots = [cots[0] * keep[..., None], cots[1] * keep, cots[2] * keep, cots[3] * keep[..., None]]
    got = svo.svo_sweep_backward(*ops, consts, xtilde, *cots)
    want = svo.svo_sweep_backward_reference(*ops, consts, xtilde, *cots)
    again = svo.svo_sweep_backward(*ops, consts, xtilde, *cots)
    prev = svo.svo_sweep_backward(*ops, consts, xtilde, *cots, design="chain")
    torch.cuda.synchronize()
    args = (*ops, consts, xtilde, *cots)
    return dict(rel=rel(got, want), maxd=[float((g - w).abs().max()) for g, w in zip(got, want)],
                rel_raw=raw, zeroed=int(tie.sum()), n=b * m, rel_prev=rel(got, prev),
                same=all(torch.equal(g, a) for g, a in zip(got, again)),
                finite=all(bool(torch.isfinite(g).all()) for g in got), args=args, got=got)


STEP_KERNELS = {"K14": ("step_forward_kernel",),
                "K15": ("step_backward_kernel", "sum_rows_kernel")}
STEP_PSVO_KERNELS = dict(STEP_KERNELS, K5=("ffbsi_staged_kernel",), K6=K6_KERNELS)


STEP_OUTPUTS = ("x_new", "alpha", "ell", "ess", "filtered mean")


def step_outputs(out):
    """K14's float outputs, the stats split by column: x_new, α, ℓ, ESS and
    the filtered mean."""
    x_new, alpha, stats = out[:3]
    return x_new, alpha, stats[:, 0], stats[:, 1], stats[:, 2:]


def step_chain_check(ssm, cfg, ys, gen):
    """K14 chained over T−1 steps on fresh streams. Every step is held to
    step_forward_reference on the kernel's own incoming state (teacher-forced:
    indices equal; x_new, α, ℓ, ESS and the filtered mean by relative L2,
    and elementwise |Δ|/(1+|w|) reported), and the chain to one K1 launch on
    the same streams (indices equal, the largest |Δ| of x_new, α and stats).
    Returns a dict with the chain's residuals [x_all, alpha_all, stats, idx]
    and K1's inputs."""
    import torch
    from psvo_tpu_torch.ops import fused_step

    inp = kernel_inputs(ssm, cfg, ys, gen)
    consts, coef, eps, pos = inp["consts"], inp["coef"], inp["eps"], inp["positions"]
    k1 = fused_step.scan_forward(inp["x0"], inp["alpha0"], coef, consts, eps=eps, positions=pos,
                                 cache=True, save_res=True)
    x, lw = inp["x0"], inp["alpha0"]
    steps, idx_bad, tf_l2, tf_rel, tf_abs = [], 0, [], [], 0.0
    for t in range(coef.shape[0]):
        out = fused_step.step_forward(x, lw, coef[t], consts, eps[t], pos[t])
        ref = fused_step.step_forward_reference(x, lw, coef[t], consts, eps[t], pos[t])
        idx_bad += int((out[3] != ref[3]).sum())
        pairs = list(zip(step_outputs(out), step_outputs(ref)))
        tf_l2.append(torch.stack([(a - w).norm() / w.norm().clamp_min(1e-30) for a, w in pairs]))
        tf_rel.append(torch.stack([((a - w).abs() / (1 + w.abs())).max() for a, w in pairs]))
        tf_abs = max(tf_abs, max_err(out[:3], ref[:3]))
        steps.append(out)
        x, lw = out[0], out[1]
    torch.cuda.synchronize()
    chain = [torch.stack([s[i] for s in steps]) for i in range(4)]
    vs_k1 = [float((a.float() - b.float()).abs().max()) for a, b in
             zip(chain, (k1[3], k1[4], k1[2], k1[5]))]
    return dict(inp=inp, chain=chain, idx_bad=idx_bad, tf_l2=torch.stack(tf_l2).amax(0).tolist(),
                tf_rel=torch.stack(tf_rel).amax(0).tolist(), tf_abs=tf_abs,
                k1_idx=int((chain[3] != k1[5]).sum()), vs_k1=vs_k1[:3],
                finite=all(bool(torch.isfinite(c).all()) for c in chain[:3]))


def step_backward_check(res, gen):
    """K15 against step_backward_reference on every step of a K14 chain's
    residuals, with random d x_new, d α and d ℓ (and random dropped stats
    columns): raw, and with d x_new and d α zeroed on the particles of
    `relu_ties`; bit-equal on a second launch. Then the T−1 K15 launches
    chained in reverse against one K4 launch on the same residuals, with
    K4's cache cotangents (d x_new = the next step's d x + d_x_all[t]; d α =
    d_alpha_all[t], plus d_alpha_last at the end) and d_ℓ = −1/B: d_x0,
    d_coef and the summed weight and sconst gradients. Returns a dict, with
    the last step's masked operands for timing."""
    import torch
    from psvo_tpu_torch.ops import fused_step
    from psvo_tpu_torch.ops.resampling import gather_particles

    inp, (x_all, alpha_all, stats, idx) = res["inp"], res["chain"]
    consts, coef, eps, x0 = inp["consts"], inp["coef"], inp["eps"], inp["x0"]
    t1, b, dx, k = x_all.shape
    dev = x_all.device

    def rel(got, want):
        return torch.stack([(g - w).norm() / w.norm().clamp_min(1e-30) for g, w in zip(got, want)])

    h2 = 2 * consts["hidden"] if consts.get("di") else 0  # the controls' d_coef columns
    rels, raws, maxd, zeroed, same, rel_ctrl = [], [], [], 0, True, 0.0
    for t in range(t1):
        x_in = x0 if t == 0 else x_all[t - 1]
        d_stats = torch.randn(stats[t].shape, generator=gen, device=dev)
        d_xn = torch.randn(x_in.shape, generator=gen, device=dev)
        d_al = torch.randn(alpha_all[t].shape, generator=gen, device=dev)
        args = (x_in, x_all[t], idx[t], stats[t], coef[t], consts, eps[t], d_stats)
        plain = (x_in, coef[t], consts, eps[t], idx[t], d_stats)
        raws.append(rel(fused_step.step_backward(*args, d_xn, d_al),
                        fused_step.step_backward_reference(*plain, d_xn, d_al)))
        keep = ~relu_ties(consts, gather_particles(x_in, idx[t]), x_all[t], coef_row=coef[t])
        zeroed += int((~keep).sum())
        d_xn, d_al = d_xn * keep[:, None], d_al * keep
        got = fused_step.step_backward(*args, d_xn, d_al)
        again = fused_step.step_backward(*args, d_xn, d_al)
        want = fused_step.step_backward_reference(*plain, d_xn, d_al)
        same &= all(torch.equal(g, a) for g, a in zip(got, again))
        rels.append(rel(got, want))
        if h2:
            rel_ctrl = max(rel_ctrl, float(rel((got[1][..., -h2:],), (want[1][..., -h2:],))[0]))
        maxd.append(torch.stack([(g - w).abs().max() for g, w in zip(got, want)]))
    last = (args, d_xn, d_al, got)

    d_stats = torch.randn(stats.shape, generator=gen, device=dev)
    d_stats[..., 0] = -1.0 / b
    d_x_last = torch.randn(x0.shape, generator=gen, device=dev)
    d_a_last = torch.randn((b, k), generator=gen, device=dev)
    d_x_all = torch.randn(x_all.shape, generator=gen, device=dev) * 0.1
    d_a_all = torch.randn(alpha_all.shape, generator=gen, device=dev) * 0.1
    k4 = fused_step.scan_backward(x0, x_all, idx, stats, coef, consts, d_stats, d_x_last, d_a_last,
                                  d_x_all, d_a_all, eps=eps)
    d_x, d_coef, d_packed, d_sconst = d_x_last, [None] * t1, 0.0, 0.0
    for t in reversed(range(t1)):
        d_al = d_a_all[t] + d_a_last if t == t1 - 1 else d_a_all[t]
        d_x, d_coef[t], dp, ds = fused_step.step_backward(
            x0 if t == 0 else x_all[t - 1], x_all[t], idx[t], stats[t], coef[t], consts, eps[t],
            d_stats[t], d_x + d_x_all[t], d_al)
        d_packed, d_sconst = d_packed + dp, d_sconst + ds
    vs_k4 = rel((d_x, torch.stack(d_coef), d_packed, d_sconst), k4)
    torch.cuda.synchronize()
    return dict(rel=torch.stack(rels).amax(0).tolist(), maxd=torch.stack(maxd).amax(0).tolist(),
                rel_raw=torch.stack(raws).amax(0).tolist(), zeroed=zeroed, n=t1 * b * k,
                same=bool(same), vs_k4=vs_k4.tolist(), last=last, rel_ctrl=rel_ctrl,
                finite=all(bool(torch.isfinite(g).all()) for g in got))


def step_bounds(consts, fwd_args, fwd_out, bwd):
    """Bounds of one K14 launch (its operands in, its outputs out, the three
    trunks' FLOP per particle) and of one K15 launch (three times the FLOP, as
    K4 per step; residuals and cotangents in, gradients out)."""
    x = fwd_args[0]
    n_part = x.shape[0] * x.shape[-1]
    k14 = bound(trunk_flops(consts) * n_part,
                nbytes(*fwd_args, consts["packed"], consts["sconst"], *fwd_out))
    args, d_xn, d_al, got = bwd
    k15 = bound(3 * trunk_flops(consts) * n_part,
                nbytes(*args[:5], args[6], args[7], consts["packed"], consts["sconst"], d_xn, d_al,
                       *got))
    return k14, k15


def cluster_sweep(ssm, cfg, ys, gen, rng_seed=None, cache=False):
    """K1 and K4 at every cluster size C that the gates and the card admit,
    against C = 1 on the same inputs (K1's residual mode, the train path's):
    every K1 output and K4's d_x0 bit for bit, K4's d_coef, weight and sconst
    gradients by relative L2, each C bit-equal on a relaunch. Then CUDA-event
    times of each C (median of 5 after 2 warm-up runs), C = 1 and the chosen
    C alternated: 1, chosen, the others, chosen, 1. Returns a dict."""
    import torch
    from psvo_tpu_torch.ops import fused_step

    inp = kernel_inputs(ssm, cfg, ys, gen)
    consts, coef = inp["consts"], inp["coef"]
    b, k, dev = coef.shape[1], cfg.smc.n_particles, ys.device
    noise = ({"seed": rng_seed} if rng_seed is not None
             else {"eps": inp["eps"], "positions": inp["positions"]})
    bnoise = {"seed": rng_seed} if rng_seed is not None else {"eps": inp["eps"]}
    max_active = [fused_step.max_active_clusters(kern, dev, consts, k) for kern in (0, 1)]
    chosen = (fused_step.cluster_size(b, k, fused_step.K1_MIN_SLICE, max_active[0]),
              fused_step.cluster_size(b, k, fused_step.K4_MIN_SLICE, max_active[1]))
    sizes = ([c for c in fused_step.CLUSTER_SIZES if max_active[0][c] > 0
              and (c == 1 or k % (c * fused_step.K1_MIN_SLICE) == 0)],
             [c for c in fused_step.CLUSTER_SIZES if max_active[1][c] > 0
              and fused_step._k4_ok(consts, k, c)])

    def fwd(c):
        return fused_step.scan_forward(inp["x0"], inp["alpha0"], coef, consts, cache=cache,
                                       save_res=True, cluster=c, **noise)

    def equal(xs, ys_):
        return all(torch.equal(a, w) for a, w in zip(xs, ys_) if a is not None)

    one = fwd(1)
    k1 = {}
    for c in sizes[0]:
        got, again = fwd(c), fwd(c)
        k1[c] = {"equal": equal(got, one), "same": equal(got, again)}
    x_last, alpha_last, stats, x_all, alpha_all, idx = one
    d_stats = torch.randn(stats.shape, generator=gen, device=dev)
    d_stats[..., 0] = -1.0 / b
    cots = [torch.randn(t.shape, generator=gen, device=dev) for t in (x_last, alpha_last)]
    cots += ([torch.randn(t.shape, generator=gen, device=dev) * 0.1 for t in (x_all, alpha_all)]
             if cache else [None, None])
    bwd_args = (inp["x0"], x_all, idx, stats, coef, consts, d_stats, *cots)

    def bwd(c):
        return fused_step.scan_backward(*bwd_args, cluster=c, **bnoise)

    base = bwd(1)
    k4 = {}
    for c in sizes[1]:
        got, again = bwd(c), bwd(c)
        k4[c] = {"dx0_equal": torch.equal(got[0], base[0]), "same": equal(got, again),
                 "rel": [float((g - w).norm() / w.norm().clamp_min(1e-30))
                         for g, w in zip(got[1:], base[1:])]}
    torch.cuda.synchronize()
    ms = []
    for kern, fn in ((0, fwd), (1, bwd)):
        c_ = chosen[kern]
        order = [1, c_] + [c for c in sizes[kern] if c not in (1, c_)] + [c_, 1]
        times = {}
        with torch.no_grad():
            for c in order:
                times.setdefault(c, []).append(time_ms(lambda: fn(c)))
        ms.append(times)
    return dict(max_active=max_active, chosen=chosen, sizes=sizes, k1=k1, k4=k4, ms=ms)


def slice_sweep(fwd_args, bwd_args, gen):
    """K14 and K15 at every slice count S that the gates admit, against S = 1
    on one step's operands: K14 on fwd_args (every output bit for bit), K15
    on bwd_args with random cotangents (d_x bit for bit; d_coef, the weight
    and sconst gradients by relative L2, and where one exceeds 1e-6 its
    distance from a float64 replay of step_backward_reference beside S = 1's),
    each S bit-equal on a relaunch. Then device times per S from
    torch.profiler (20 launches), S = 1 and the chosen S alternated: 1,
    chosen, the others, chosen, 1; K15's sum_rows_kernel apart. Returns a dict."""
    import torch
    from psvo_tpu_torch.ops import fused_step

    consts = fwd_args[3]
    b, k = fwd_args[0].shape[0], fwd_args[0].shape[-1]
    dev = fwd_args[0].device
    mins = (fused_step.K1_MIN_SLICE, fused_step.K4_MIN_SLICE)
    resident = [fused_step.resident_ctas(kern, dev, consts, k) for kern in (0, 1)]
    chosen = [fused_step.step_slices(b, k, mins[kern], resident[kern]) for kern in (0, 1)]
    sizes = [[s for s in fused_step.STEP_SLICES if s == 1 or k % (s * m) == 0] for m in mins]
    x, x_new, idx, stats, coef, eps = bwd_args
    cots = (torch.randn(stats.shape, generator=gen, device=dev),
            torch.randn(x_new.shape, generator=gen, device=dev),
            torch.randn((b, k), generator=gen, device=dev))
    bwd_all = (x, x_new, idx, stats, coef, consts, eps, *cots)

    def fwd(s):
        return fused_step.step_forward(*fwd_args, slices=s)

    def bwd(s):
        return fused_step.step_backward(*bwd_all, slices=s)

    def equal(xs, ys_):
        return all(torch.equal(a, w) for a, w in zip(xs, ys_))

    def rel(a, w):
        return float((a - w).norm() / w.norm().clamp_min(1e-30))

    one_f, one_b = fwd(1), bwd(1)
    k14 = {s: {"equal": equal(fwd(s), one_f), "same": equal(fwd(s), fwd(s))} for s in sizes[0]}
    k15, ref64 = {}, None
    for s in sizes[1]:
        got, again = bwd(s), bwd(s)
        r = k15[s] = {"dx_equal": torch.equal(got[0], one_b[0]), "same": equal(got, again),
                      "rel": [rel(g, w) for g, w in zip(got[1:], one_b[1:])], "vs64": {}}
        for i, e in enumerate(r["rel"], 1):
            if e > 1e-6:  # the sums against float64 instead: no further than S = 1's
                if ref64 is None:
                    c64 = dict(consts, packed=consts["packed"].double(),
                               sconst=consts["sconst"].double())
                    ref64 = fused_step.step_backward_reference(
                        x.double(), coef.double(), c64, eps.double(), idx,
                        *(c.double() for c in cots))
                r["vs64"][i] = (rel(got[i].double(), ref64[i]), rel(one_b[i].double(), ref64[i]))
    torch.cuda.synchronize()
    ms = []
    for kern, fn in ((0, fwd), (1, bwd)):
        c_ = chosen[kern]
        order = [1, c_] + [s for s in sizes[kern] if s not in (1, c_)] + [c_, 1]
        times = {}
        with torch.no_grad():
            for s in order:
                times.setdefault(s, []).append(device_ms_by_kernel(lambda: fn(s)))
        ms.append(times)
    return dict(resident=resident, chosen=chosen, sizes=sizes, k14=k14, k15=k15, ms=ms)


CTRL = "fhn_fivo_controls"


def controlled_config(small: bool, k: int = 128, steps_per_call: int = 1):
    """fhn_fivo_controls (or slice_config's small cut of it) at k particles
    and steps_per_call train steps a call."""
    cfg, batch = slice_config(small, CTRL)
    return dataclasses.replace(
        cfg, smc=dataclasses.replace(cfg.smc, n_particles=k),
        train=dataclasses.replace(cfg.train, steps_per_call=steps_per_call)), batch


def zero_control_bits(ssm, cfg, ys, gen):
    """A controlled model's kernels with zero controls against the same
    kernels launched uncontrolled (ctrl 0: the code every uncontrolled model
    runs) on the same weights, inputs and cotangents: K1's outputs, K4's d_x0,
    weight and sconst gradients and d_coef's uncontrolled columns, and one
    mid step's K14 outputs and K15 leaves, bit for bit. Returns
    {kernel: bit-equal}."""
    import torch
    from psvo_tpu_torch.ops import fused_step

    b, t_steps, _ = ys.shape
    inp = kernel_inputs(ssm, cfg, ys, gen,
                        controls=torch.zeros((b, t_steps, ssm.di), device=ys.device))
    consts, coef, eps, pos, x0 = inp["consts"], inp["coef"], inp["eps"], inp["positions"], inp["x0"]
    n0 = coef.shape[-1] - 2 * consts["hidden"]
    plain_c, coef0 = dict(consts, di=0, ctrl_w=None), coef[..., :n0].contiguous()
    out = {}

    def equal(xs, ws):
        return all(torch.equal(a, w) for a, w in zip(xs, ws) if a is not None)

    k1 = [fused_step.scan_forward(x0, inp["alpha0"], c, cs, eps=eps, positions=pos, cache=True,
                                  save_res=True) for c, cs in ((coef, consts), (coef0, plain_c))]
    out["K1"] = equal(k1[0], k1[1])
    x_last, alpha_last, stats, x_all, alpha_all, idx = k1[1]
    cots = [torch.randn(t.shape, generator=gen, device=ys.device)
            for t in (stats, x_last, alpha_last, x_all, alpha_all)]
    k4 = [fused_step.scan_backward(x0, x_all, idx, stats, c, cs, *cots, eps=eps)
          for c, cs in ((coef, consts), (coef0, plain_c))]
    out["K4"] = equal((k4[0][0], k4[0][1][..., :n0], *k4[0][2:]), k4[1])
    t = coef.shape[0] // 2
    k14 = [fused_step.step_forward(x_all[t - 1], alpha_all[t - 1], c[t], cs, eps[t], pos[t])
           for c, cs in ((coef, consts), (coef0, plain_c))]
    out["K14"] = equal(k14[0], k14[1])
    k15 = [fused_step.step_backward(x_all[t - 1], x_all[t], idx[t], stats[t], c[t], cs, eps[t],
                                    cots[0][t], cots[3][t], cots[4][t])
           for c, cs in ((coef, consts), (coef0, plain_c))]
    out["K15"] = equal((k15[0][0], k15[0][1][..., :n0], *k15[0][2:]), k15[1])
    torch.cuda.synchronize()
    return out


def controls_phases(pt, dev, card: str) -> dict:
    """Phases (ag)-(ai): fhn_fivo_controls' kernels against their plain
    versions, served and trained through the entry points. Returns what the
    kernels' JSON record needs."""
    import torch
    from psvo_tpu_torch.ops import fused_step

    leaves = ("d_x0", "d_coef", "d_weights", "d_sconst")
    # (ag) K1, K4, K14 and K15 with controls (fhn_fivo_controls) against their plain versions
    gen_c = torch.Generator(device=dev).manual_seed(SEED + 40)  # this phase's own draws
    cds = pt.generate_dataset(pt.PRESETS[CTRL].data, SEED)
    c_obs = torch.cat([cds.obs_test, cds.obs_train]).to(dev)
    c_u = torch.cat([cds.controls_test, cds.controls_train]).to(dev)
    ag = {}
    for label, small, k_ in (("small", True, 128), ("full", False, 128), ("full K=1024", False, 1024)):
        cfg, batch = controlled_config(small, k_)
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 41), device=dev)
        ys = c_obs[:batch, :cfg.data.t_steps].contiguous()
        tol = 1e-4 if small else 1e-3
        shape = (f"B={batch} K={k_} T={cfg.data.t_steps} hidden={cfg.net('q1').hidden} "
                 f"Di={cfg.data.di}")
        modes = [("stream", None)] + ([("in-kernel RNG", (9, 0xC0DE))] if small else [])
        for mode, rng_seed in modes:
            with torch.no_grad():
                r = check_scan(f"K1 controls {label}", ssm, cfg, ys, gen_c, tol=2e-4,
                               rng_seed=rng_seed)
            print(f"[ag] K1 controls {label} {mode} {shape}, C={fused_step.scan_forward.last_cluster}"
                  f": {scan_line(r)}", flush=True)
            if not scan_ok(r, small):
                fail(f"K1 with controls ({label}, {mode}) disagrees with scan_forward_reference")
            bmodes = [(mode, rng_seed, False)]
            if small and rng_seed is None:
                bmodes.append(("stream, cache cotangents", None, True))
            for bmode, bseed, cache in bmodes:
                with torch.no_grad():
                    rb = check_backward(ssm, cfg, ys, gen_c, bseed, cache)
                print(f"[ag] K4 controls {label} {bmode}, C={fused_step.scan_backward.last_cluster}: "
                      + ", ".join(f"{n} rel L2 {e:.3e} max|d| {m:.3e}"
                                  for n, e, m in zip(leaves, rb["rel"], rb["maxd"]))
                      + f"; the controls' d_coef columns rel L2 {rb['rel_ctrl']:.3e}; idx "
                      f"nondecreasing {rb['monotone']}; bound rel L2 {tol:g}", flush=True)
                if not (rb["monotone"] and rb["finite"] and max(rb["rel"] + [rb["rel_ctrl"]]) <= tol):
                    fail(f"K4 with controls ({label}, {bmode}) disagrees with "
                         f"scan_backward_reference")
            ag[(label, "K1")], ag[(label, "K4")] = r, rb
        with torch.no_grad():
            rs = step_chain_check(ssm, cfg, ys, gen_c)
        print(f"[ag] K14 controls {label} {shape}, S={fused_step.step_forward.last_slices}: every "
              f"step from the kernel's own state: {rs['idx_bad']} indices differ; max per-step rel "
              f"L2 " + ", ".join(f"{n} {e:.3e}" for n, e in zip(STEP_OUTPUTS, rs["tf_l2"]))
              + f" (max|d| {rs['tf_abs']:.3e}); the chain vs one K1 launch: {rs['k1_idx']} indices "
              f"differ, max|d| x {rs['vs_k1'][0]:.3e} alpha {rs['vs_k1'][1]:.3e} stats "
              f"{rs['vs_k1'][2]:.3e}", flush=True)
        if not (rs["finite"] and rs["idx_bad"] == 0 and max(rs["tf_l2"]) <= 1e-4
                and rs["k1_idx"] == 0):
            fail(f"K14 with controls ({label}) disagrees with step_forward_reference or with K1")
        with torch.no_grad():
            rbs = step_backward_check(rs, gen_c)
        print(f"[ag] K15 controls {label}, S={fused_step.step_backward.last_slices}, every step: "
              + ", ".join(f"{n} rel L2 {e:.3e} max|d| {m:.3e}"
                          for n, e, m in zip(("d_x",) + leaves[1:], rbs["rel"], rbs["maxd"]))
              + f"; the controls' d_coef columns rel L2 {rbs['rel_ctrl']:.3e}; bit-equal on a "
              f"second launch {rbs['same']}; cotangents zeroed on {rbs['zeroed']} of {rbs['n']} "
              f"particle-steps with a relu tie; the chain vs one K4 launch, rel L2 "
              + ", ".join(f"{e:.3e}" for e in rbs["vs_k4"]) + f"; bound rel L2 {tol:g}", flush=True)
        if not (rbs["finite"] and rbs["same"] and max(rbs["rel"] + [rbs["rel_ctrl"]]) <= tol
                and max(rbs["vs_k4"]) <= 1e-4):
            fail(f"K15 with controls ({label}) disagrees with step_backward_reference or with K4")
        ag[(label, "K14")], ag[(label, "K15")] = rs, rbs
        with torch.no_grad():
            bits = zero_control_bits(ssm, cfg, ys, gen_c)
        print(f"[ag] {label}: the control mode with zero controls vs the uncontrolled launch on "
              f"the same weights, bit-equal: {bits}", flush=True)
        if not all(bits.values()):
            fail(f"the control mode with zero controls is not the uncontrolled launch ({label})")
        if label == "full K=1024":
            # K1 and K4 on clusters of 2 (the new columns' cross-CTA sums) vs one CTA a row,
            # and K14/K15 on every slice count S vs S = 1 (4 at B=32, K=1024)
            with torch.no_grad():
                inp = kernel_inputs(ssm, cfg, ys, gen_c)
                f_c = {c: fused_step.scan_forward(inp["x0"], inp["alpha0"], inp["coef"],
                                                  inp["consts"], eps=inp["eps"],
                                                  positions=inp["positions"], save_res=True,
                                                  cluster=c) for c in (1, 2)}
                x_last, alpha_last, stats, x_all, _, idx = f_c[1]
                cots = [torch.randn(v.shape, generator=gen_c, device=dev)
                        for v in (stats, x_last, alpha_last)]
                b_c = {c: fused_step.scan_backward(inp["x0"], x_all, idx, stats, inp["coef"],
                                                   inp["consts"], *cots, eps=inp["eps"], cluster=c)
                       for c in (1, 2)}
                h2 = 2 * inp["consts"]["hidden"]

                def rel(a, w):
                    return float((a - w).norm() / w.norm().clamp_min(1e-30))

                rel_c = [rel(a, w) for a, w in zip(b_c[2][1:], b_c[1][1:])]
                ctrl_cols = (b_c[2][1][..., -h2:], b_c[1][1][..., -h2:])
                rel_cc = rel(*ctrl_cols)
                k1_eq = all(torch.equal(a, w) for a, w in zip(f_c[2], f_c[1]) if a is not None)
                vs64 = {}  # a sum beyond 1e-6: its distance from a float64 replay, C = 2 and 1
                if max(rel_c) > 1e-6:
                    c64 = dict(inp["consts"], packed=inp["consts"]["packed"].double(),
                               sconst=inp["consts"]["sconst"].double())
                    ref64 = fused_step.scan_backward_reference(
                        inp["x0"].double(), inp["coef"].double(), c64, inp["eps"].double(), idx,
                        *(c_.double() for c_ in cots))
                    vs64 = {i: (rel(b_c[2][i].double(), ref64[i]), rel(b_c[1][i].double(), ref64[i]))
                            for i, e in enumerate(rel_c, 1) if e > 1e-6}
            print(f"[ag] K1/K4 controls on clusters of 2 vs 1 (B={batch}, K={k_}): K1 bit-equal "
                  f"{k1_eq}; K4 d_x0 bit-equal {torch.equal(b_c[2][0], b_c[1][0])}, rel L2 "
                  + ", ".join(f"{n} {e:.3e}" for n, e in zip(leaves[1:], rel_c))
                  + "".join(f"; {leaves[i]} vs a float64 replay {a:.3e} (C=1 {w:.3e})"
                            for i, (a, w) in vs64.items())
                  + f", the controls' d_coef columns {rel_cc:.3e} (bit-equal "
                  f"{torch.equal(*ctrl_cols)}); bound: the controls' columns 1e-6, the other "
                  f"sums 1e-6 or no further from float64 than C=1's (as phase ae)", flush=True)
            sums_ok = all(e <= 1e-6 or vs64[i][0] <= vs64[i][1] for i, e in enumerate(rel_c, 1))
            if not (k1_eq and torch.equal(b_c[2][0], b_c[1][0]) and rel_cc <= 1e-6 and sums_ok):
                fail("K1/K4 with controls on clusters of 2 disagree with one CTA per row")
            tm = inp["coef"].shape[0] // 2
            x_all_s, alpha_all_s, stats_s, idx_s = (c.clone() for c in rs["chain"])
            ri = rs["inp"]
            with torch.no_grad():
                sw = slice_sweep(
                    (x_all_s[tm - 1], alpha_all_s[tm - 1], ri["coef"][tm], ri["consts"],
                     ri["eps"][tm], ri["positions"][tm]),
                    (x_all_s[tm - 1], x_all_s[tm], idx_s[tm], stats_s[tm], ri["coef"][tm],
                     ri["eps"][tm]), gen_c)
            print(f"[ag] K14/K15 controls by slice count (B={batch}, K={k_}): chosen S "
                  f"{sw['chosen']}; K14 bit-equal to S=1 "
                  + ", ".join(f"S={s_}: {v['equal'] and v['same']}" for s_, v in sw["k14"].items())
                  + "; K15 d_x bit-equal to S=1 and rel L2 of the other leaves "
                  + ", ".join(f"S={s_}: {v['dx_equal']} " + "/".join(f"{e:.2e}" for e in v["rel"])
                              for s_, v in sw["k15"].items()), flush=True)
            if not (all(v["equal"] and v["same"] for v in sw["k14"].values())
                    and all(v["dx_equal"] and v["same"] for v in sw["k15"].values())
                    and 4 in sw["k14"] and sw["chosen"][0] >= 2):
                fail("K14/K15 with controls on slices disagree with one CTA per row")
    # times at the preset's size (B=32, K=128, T=100, hidden (64, 64), stream noise)
    cfg, batch = controlled_config(False)
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 41), device=dev)
    ys = c_obs[:batch].contiguous()
    with torch.no_grad():
        inp = kernel_inputs(ssm, cfg, ys, gen_c, controls=c_u[:batch].contiguous())
        args = (inp["x0"], inp["alpha0"], inp["coef"], inp["consts"])
        noise = dict(eps=inp["eps"], positions=inp["positions"])
        k1c = [time_ms(lambda: fused_step.scan_forward(*args, **noise)),
               time_ms(lambda: fused_step.scan_forward_reference(*args, inp["eps"],
                                                                 inp["positions"]))]
        k1c += [time_ms(lambda: fused_step.scan_forward(*args, **noise)),
                time_ms(lambda: fused_step.scan_forward_reference(*args, inp["eps"],
                                                                  inp["positions"]))]
        rb = ag[("full", "K4")]
        k4c = [time_ms(rb["kernel"]), time_ms(rb["plain"]), time_ms(rb["kernel"]),
               time_ms(rb["plain"])]
        outs_c = fused_step.scan_forward(*args, **noise)
        # the control mode against the same shape without it (the control columns dropped),
        # alternated: controlled, uncontrolled, uncontrolled, controlled
        plain_c = dict(inp["consts"], di=0, ctrl_w=None)
        coef0 = inp["coef"][..., :-2 * inp["consts"]["hidden"]].contiguous()
        res = fused_step.scan_forward(*args, **noise, save_res=True)
        d_st = torch.randn(res[2].shape, generator=gen_c, device=dev)
        k1_pair = [(args, noise), (args[:2] + (coef0, plain_c), noise)]
        k4_pair = [(inp["coef"], inp["consts"]), (coef0, plain_c)]
        k1_vs = [time_ms(lambda: fused_step.scan_forward(*k1_pair[i][0], **k1_pair[i][1]))
                 for i in (0, 1, 1, 0)]
        k4_vs = [time_ms(lambda: fused_step.scan_backward(inp["x0"], res[3], res[5], res[2],
                                                          *k4_pair[i], d_st, eps=inp["eps"]))
                 for i in (0, 1, 1, 0)]
    consts_c = inp["consts"]
    t1c, kc = inp["coef"].shape[0], inp["x0"].shape[-1]
    glue = 2 * (2 * consts_c["hidden"]) * cfg.data.di * t1c * batch  # u·W_u per (t, row)
    k1c_bound = bound(trunk_flops(consts_c) * t1c * batch * kc + glue,
                      nbytes(*args[:3], consts_c["packed"], consts_c["sconst"], inp["eps"],
                             inp["positions"], *outs_c[:3]))
    k4c_bound = bound(rb["flops"] + glue, rb["n_bytes"])
    rs, rbs = ag[("full", "K14")], ag[("full", "K15")]
    ri = rs["inp"]
    tm = ri["coef"].shape[0] // 2
    k14c_args = (rs["chain"][0][tm - 1].contiguous(), rs["chain"][1][tm - 1].contiguous(),
                 ri["coef"][tm], ri["consts"], ri["eps"][tm], ri["positions"][tm])
    args15, d_xn15, d_al15, _ = rbs["last"]
    plain15 = (args15[0], args15[4], args15[5], args15[6], args15[2], args15[7], d_xn15, d_al15)
    with torch.no_grad():
        k14c = [device_ms(lambda: fused_step.step_forward(*k14c_args)),
                device_ms(lambda: fused_step.step_forward_reference(*k14c_args), n=5),
                device_ms(lambda: fused_step.step_forward(*k14c_args))]
        k14c_out = fused_step.step_forward(*k14c_args)
        k15c = [device_ms(lambda: fused_step.step_backward(*args15, d_xn15, d_al15)),
                device_ms(lambda: fused_step.step_backward_reference(*plain15), n=5),
                device_ms(lambda: fused_step.step_backward(*args15, d_xn15, d_al15))]
    k14c_bound, k15c_bound = step_bounds(ri["consts"], k14c_args[:3] + k14c_args[4:], k14c_out,
                                         rbs["last"])
    print(f"[ag] {card}: {CTRL} (B=32, K=128, T=100, hidden (64, 64), Di=2, stream noise): K1 "
          f"{k1c[0]:.3f}/{k1c[2]:.3f} ms vs plain {k1c[1]:.3f}/{k1c[3]:.3f} ms, bound "
          f"{k1c_bound[0]:.4f} ms ({k1c_bound[1]}); K4 {k4c[0]:.3f}/{k4c[2]:.3f} ms vs plain "
          f"{k4c[1]:.3f}/{k4c[3]:.3f} ms, bound {k4c_bound[0]:.4f} ms ({k4c_bound[1]}) (CUDA events, "
          f"kernel/plain alternated, median of 5 after 2 warm-up); K14 "
          f"{k14c[0]:.4f}/{k14c[2]:.4f} ms vs plain {k14c[1]:.4f} ms, bound {k14c_bound[0]:.4f} ms "
          f"({k14c_bound[1]}); K15 {k15c[0]:.4f}/{k15c[2]:.4f} ms vs plain {k15c[1]:.4f} ms, bound "
          f"{k15c_bound[0]:.4f} ms ({k15c_bound[1]}) (device time per launch, torch.profiler); "
          f"the glue's u·W_u {glue:.3e} FLOP a call; the control mode against the same shape "
          f"without it (controlled, uncontrolled, uncontrolled, controlled, CUDA events): K1 "
          + "/".join(f"{v:.3f}" for v in k1_vs) + " ms, K4 " + "/".join(f"{v:.3f}" for v in k4_vs)
          + " ms", flush=True)
    ctrl_small_err = {"K1": ag[("small", "K1")]["max_abs_err"],
                      "K4": max(ag[("small", "K4")]["maxd"]),
                      "K14": ag[("small", "K14")]["tf_abs"],
                      "K15": max(ag[("small", "K15")]["maxd"])}
    del ag
    phase_done("ag")

    # (ah) fhn_fivo_controls served: make_eval_step and filter_posterior with controls
    c_kernels = (fused_step.scan_forward, fused_step.scan_backward, fused_step.step_forward,
                 fused_step.step_backward)
    c_plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
               fused_step.step_forward_reference, fused_step.step_backward_reference,
               fused_step.stream_noise_reference, fused_step.ancestor_indices_reference)

    def c_counted(fn):
        for f in c_plain:
            f.calls = 0
        for f in c_kernels:
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, [f.launches for f in c_kernels], sum(f.calls for f in c_plain)

    cfg, batch = pt.PRESETS[CTRL], 32
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    c_batches = [(c_obs[i * batch:(i + 1) * batch].contiguous(),
                  c_u[i * batch:(i + 1) * batch].contiguous()) for i in range(3)]
    eval_step = pt.make_eval_step(ssm, cfg)
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 42)

    def serve():
        ms = [eval_step(run_gen, ys_, controls=u_) for ys_, u_ in c_batches]
        return ms, [pt.filter_posterior(ssm, ys_, cfg, controls=u_) for ys_, u_ in c_batches]

    (metrics, means), serve_launch, serve_plain = c_counted(serve)
    elbos = [float(m_["elbo"]) for m_ in metrics]
    r2_1 = [float(m_["r2_k"][0]) for m_ in metrics]
    ys0, u0 = c_batches[0]
    ev_ms = [time_ms(lambda: eval_step(run_gen, ys0, controls=u0)) for _ in range(2)]
    fp_ms = time_ms(lambda: pt.filter_posterior(ssm, ys0, cfg, controls=u0))
    flipped = []
    for sign in (1.0, -1.0):
        g_ = torch.Generator(device=dev).manual_seed(SEED + 44)
        flipped.append(float(eval_step(g_, ys0, controls=sign * u0)["elbo"]))
    try:
        pt.filter_posterior(ssm, ys0, cfg)
        refused = False
    except ValueError:
        refused = True
    shapes_ok = all(tuple(m_.shape) == (batch, cfg.data.t_steps, 2) for m_ in means)
    finite = all(math.isfinite(v) for v in elbos + r2_1) and all(
        bool(torch.isfinite(m_).all()) for m_ in means)
    print(f"[ah] {card}: serving {CTRL} (B=32, K=128, T=100, hidden (64, 64), Di=2): log Z per "
          f"batch (elbo) {[round(e, 3) for e in elbos]}, R2(1) {[round(v, 4) for v in r2_1]}; "
          f"launches K1/K4/K14/K15 {serve_launch} for 3 eval_step and 3 filter_posterior calls, "
          f"plain-version calls {serve_plain}; eval_step {ev_ms[0]:.3f}/{ev_ms[1]:.3f} ms, "
          f"filter_posterior {fp_ms:.3f} ms per call of B={batch} (CUDA events, median of 5 after 2 "
          f"warm-up); log Z with the controls {flipped[0]:.4f}, negated {flipped[1]:.4f}; "
          f"filter_posterior without controls refused {refused}; shapes ok {shapes_ok}", flush=True)
    if serve_launch != [6, 0, 0, 0] or serve_plain:
        fail(f"controlled serving launched K1/K4/K14/K15 {serve_launch} (want [6, 0, 0, 0]), plain "
             f"versions {serve_plain}")
    if not (finite and shapes_ok and refused and abs(flipped[0] - flipped[1]) > 1e-3):
        fail("controlled serving: non-finite or misshapen output, negated controls left log Z as "
             "it was, or a call without controls was not refused")
    phase_done("ah")

    # (ai) fhn_fivo_controls trained: TRAIN_CALLS calls of 10 steps, whole scan (K1/K4) then per
    # step (K14/K15)
    cfg, batch = controlled_config(False, 128, steps_per_call=10)
    obs_t, ctl_t = cds.obs_train.to(dev), cds.controls_train.to(dev)
    pick = torch.randint(0, obs_t.shape[0], (TRAIN_CALLS, 10, batch),
                         generator=torch.Generator().manual_seed(SEED + 43))
    c_train = [(obs_t[p_.to(dev)].contiguous(), ctl_t[p_.to(dev)].contiguous()) for p_ in pick]
    ctrl_train = {}
    for scan_fused in (True, False):
        fused_step.SCAN_FUSED = scan_fused
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
        train_step = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
        before = [p_.detach().clone() for p_ in ssm.parameters()]
        w_u = [ssm.heads[n_].weights[0][2:].detach().clone() for n_ in ("q1", "f")]
        run_gen = torch.Generator(device=dev).manual_seed(SEED + 45)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 1e9
        call_s = []

        def train_calls():
            out = []
            for bt, ut in c_train:
                t0 = time.perf_counter()
                out.append(train_step(run_gen, bt, controls=ut))
                torch.cuda.synchronize()
                call_s.append(time.perf_counter() - t0)
            return out

        tm_, launch, plain_n = c_counted(train_calls)
        peak = torch.cuda.max_memory_allocated() / 1e9 - held
        losses = [float(m_["loss"]) for m_ in tm_]
        norms = [float(m_["grad_norm"]) for m_ in tm_]
        moved = any(not torch.equal(a_, p_) for a_, p_ in zip(before, ssm.parameters()))
        w_u_moved = all(not torch.equal(a_, ssm.heads[n_].weights[0][2:])
                        for a_, n_ in zip(w_u, ("q1", "f")))
        step_ms = statistics.median(call_s[1:]) / 10 * 1e3
        path = "whole scan" if scan_fused else "per step"
        profile = device_breakdown(lambda: train_step(run_gen, c_train[0][0],
                                                      controls=c_train[0][1]),
                                   10, FHN_KERNELS if scan_fused else STEP_KERNELS)
        print(f"[ai] {card}: training {CTRL}, {path}: {len(c_train)} calls x 10 steps, B={batch}: "
              f"loss per call "
              f"{[round(v, 3) for v in losses]}, grad norm {[round(v, 3) for v in norms]}, "
              f"parameters moved {moved} (W_u rows too {w_u_moved}); launches K1/K4/K14/K15 "
              f"{launch}, plain-version calls {plain_n}; call times {[round(v, 3) for v in call_s]}"
              f" s, train step {step_ms:.3f} ms (median of the calls after the first, per step); "
              f"peak device memory {peak:.3f} GB above the {held:.3f} GB held before", flush=True)
        print(f"[ai] profile of one more call ({path}): {profile}", flush=True)
        t1c = cfg.data.t_steps - 1
        n_steps = 10 * len(c_train)
        want = [n_steps, n_steps, 0, 0] if scan_fused else [0, 0, n_steps * t1c, n_steps * t1c]
        if launch != want or plain_n:
            fail(f"controlled training ({path}) launched K1/K4/K14/K15 {launch} (want {want}), "
                 f"plain versions {plain_n}")
        if not (all(math.isfinite(v) for v in losses + norms) and moved and w_u_moved):
            fail(f"controlled training ({path}) gave non-finite losses or gradient norms, or left "
                 f"the parameters (W_u's rows) as they were")
        ctrl_train[scan_fused] = (launch, step_ms, peak)
    fused_step.SCAN_FUSED = True
    phase_done("ai")
    return dict(k1=k1c, k4=k4c, k14=k14c, k15=k15c, k1_bound=k1c_bound, k4_bound=k4c_bound,
                k14_bound=k14c_bound, k15_bound=k15c_bound, err=ctrl_small_err, train=ctrl_train)


LONG_T = "lorenz63_psvo_k1024_t1025_seg8"
AL_T = 2049  # phase al's long T (8193 until the script's run time had to make room)
SEG_TOL = {"loss": 1e-6, "grad_rel": 1e-4, "grad_cos": 1 - 1e-6}  # phase aj, set before its first run


def long_t_config(pt, t_steps: int, segments: int):
    """The reference's long-T configuration (psvo_tpu/benchmark.py:1069-1089):
    lorenz63_psvo_k1024 (K=1024, M=16, relu heads (64, 64), stream noise) at
    B=8, T=t_steps, S=segments, one train step a call."""
    cfg = pt.PRESETS["lorenz63_psvo_k1024"]
    return dataclasses.replace(
        cfg, name=LONG_T,
        data=dataclasses.replace(cfg.data, t_steps=t_steps, n_train=16, n_test=8),
        smc=dataclasses.replace(cfg.smc, ffbsi_segments=segments),
        train=dataclasses.replace(cfg.train, batch_size=8, steps_per_call=1))


def psvo_peak_gb(t_steps: int, b: int, k: int, m: int, dx: int) -> float:
    """The unsegmented PSVO train step's largest live set in GB, reckoned from
    the shapes (float32 and int32): the filter's cache xs and logws [T, B, ·,
    K], K1's saved ancestors [T−1, B, K], the Gumbel stack [T−1, B, M, K],
    the support terms r and mr [T−1, B, Dx, K] with c, lwn and lg [T−1, B, K],
    and the backward's d_xs [T−1, B, Dx, K], all live at once."""
    t1 = t_steps - 1
    return 4 * (t_steps * b * k * (dx + 1) + t1 * b * k + t1 * b * m * k
                + t1 * b * k * (2 * dx + 3) + t1 * b * k * dx) / 1e9


def seg_launches(seg: dict, i: int) -> dict:
    """Kernel i of (K1, K4, K5, K6)'s launches on the segmented path: a train
    step and a serving call at T=1025 and S=8 (phase ak), a train step at
    T=8193 and S=8 (phase al)."""
    return {"launches_seg_train": seg["ak"][8]["train"]["launches"][i],
            "launches_seg_serve": seg["ak"][8]["serve"]["launches"][i],
            f"launches_seg_train_t{AL_T}": seg["al"][8]["train"]["launches"][i]}


def segmented_phases(pt, dev, card: str) -> dict:
    """Phases (aj)-(al): segmented long-T PSVO (smc.ffbsi_segments) of the
    reference's lorenz63_psvo_k1024_t1025_seg8 held bit-equal to the
    unsegmented path on the same draws, then served and trained at T=1025
    and T=8193. Returns the launches per call for the kernels' JSON record."""
    import torch
    from psvo_tpu_torch import smc
    from psvo_tpu_torch.objectives import _gumbel
    from psvo_tpu_torch.ops import ffbsi, fused_step

    kernels = (fused_step.scan_forward, fused_step.scan_backward, ffbsi.ffbsi_forward,
               ffbsi.ffbsi_backward)
    plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
             fused_step.stream_noise_reference, fused_step.ancestor_indices_reference,
             ffbsi.ffbsi_forward_reference, ffbsi.ffbsi_backward_reference)

    def counted(fn):
        for f in plain:
            f.calls = 0
        for f in kernels:
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, [f.launches for f in kernels], sum(f.calls for f in plain)

    def free():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # (aj) the same draws: S = 8 against S = 1 at T = 1025
    cfg1 = long_t_config(pt, 1025, 1)
    cfg8 = long_t_config(pt, 1025, 8)
    b, k, m, dx = 8, cfg1.smc.n_particles, cfg1.smc.n_smoothing_particles, 3
    t_steps = cfg1.data.t_steps
    ds = pt.generate_dataset(cfg1.data, SEED)
    ys = ds.obs_train[:b].to(dev).contiguous()
    ssm = pt.init_ssm(cfg1, torch.Generator().manual_seed(SEED + 50), device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 51)  # this phase's own draws
    u0 = torch.rand((t_steps - 1, b), generator=g, device=dev)
    gum = _gumbel(g, (t_steps, b, m, k))
    noise = (torch.randn((b, dx, k), generator=g, device=dev),
             torch.randn((t_steps - 1, b, dx, k), generator=g, device=dev),
             fused_step.systematic_positions(u0, k), gum[0], gum[1:])
    with torch.no_grad():
        whole = smc.forward_filter(ssm, None, ys, cfg1.smc, cache=True, noise=noise[:3])
        seg, seg_cache = smc.forward_filter_segmented(ssm, None, ys, cfg8.smc, 8, noise=noise[:3])
        fwd_equal = {n_: torch.equal(getattr(seg, n_), getattr(whole, n_))
                     for n_ in ("log_z", "increments", "x_last", "logw_last")}
        seg_len = (t_steps - 1) // 8
        replay_equal = []
        for s_ in range(8):
            xs_, lw_ = smc.recompute_segment(seg_cache, s_)
            rows = slice(1 + s_ * seg_len, 1 + (s_ + 1) * seg_len)
            replay_equal.append(torch.equal(xs_, whole.xs[rows])
                                and torch.equal(lw_, whole.logws[rows]))
    del whole, seg, seg_cache, xs_, lw_
    outs, grads = [], []
    for cfg in (cfg1, cfg8):
        out = pt.make_objective(ssm, cfg)(None, ys, noise=noise)
        for p_ in ssm.parameters():
            p_.grad = None
        out.loss.backward()
        outs.append((out.loss.detach(), out.smoothed.detach()))
        grads.append([p_.grad.clone() for p_ in ssm.parameters() if p_.grad is not None])
        del out
    free()
    loss_rel = float((outs[1][0] - outs[0][0]).abs() / outs[0][0].abs())
    paths_equal = torch.equal(outs[1][1], outs[0][1])
    paths_share = float((outs[1][1] == outs[0][1]).float().mean())
    rel = [float((a_ - w_).norm() / w_.norm().clamp_min(1e-30)) for a_, w_ in zip(*grads[::-1])]
    cos = [float(torch.nn.functional.cosine_similarity(a_.flatten(), w_.flatten(), dim=0))
           for a_, w_ in zip(*grads[::-1])]
    print(f"[aj] {card}: {LONG_T} (B={b}, T={t_steps}, K={k}, M={m}), S=8 against S=1 on the same "
          f"streams and Gumbels: forward bit-equal {fwd_equal}; each segment's replay bit-equal to "
          f"the unsegmented cache {replay_equal}; smoothed paths bit-equal {paths_equal} (share "
          f"of equal entries {paths_share:.6f}); loss {float(outs[0][0]):.6f} / "
          f"{float(outs[1][0]):.6f}, relative difference {loss_rel:.3e} (tolerance "
          f"{SEG_TOL['loss']}); {len(rel)} gradient leaves: relative L2 max {max(rel):.3e} "
          f"(tolerance {SEG_TOL['grad_rel']}), cosine min {min(cos):.9f} (tolerance "
          f"{SEG_TOL['grad_cos']})", flush=True)
    if not (all(fwd_equal.values()) and all(replay_equal) and paths_equal):
        fail("the segmented forward, a replay or the smoothed paths differ from the unsegmented "
             "path's bits on the same draws")
    if (loss_rel > SEG_TOL["loss"] or max(rel) > SEG_TOL["grad_rel"]
            or min(cos) < SEG_TOL["grad_cos"]):
        fail("the segmented loss or gradients differ from the unsegmented path's beyond the "
             "stated tolerances")
    del grads, outs, noise, gum
    free()
    phase_done("aj")

    def drive(label, cfg, ys_, n_train, warm=True):
        """One timed smooth_posterior call (S > 1) and n_train timed train
        steps, each after a warm-up call (warm); host ms, launches, peak
        memory and a profile of one more call or step."""
        ssm_ = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 52), device=dev)
        run_gen = torch.Generator(device=dev).manual_seed(SEED + 53)
        res = {}
        if cfg.smc.ffbsi_segments > 1:
            if warm:
                pt.smooth_posterior(ssm_, ys_, cfg, run_gen)
                free()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated() / 1e9
            t0 = time.perf_counter()
            paths, launch, plain_n = counted(lambda: pt.smooth_posterior(ssm_, ys_, cfg, run_gen))
            host = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated() / 1e9
            ok = tuple(paths.shape) == (b, m, ys_.shape[1], dx) and bool(torch.isfinite(paths).all())
            del paths
            prof = device_breakdown(lambda: pt.smooth_posterior(ssm_, ys_, cfg, run_gen), 1,
                                    PSVO_KERNELS)
            print(f"[{label}] serving: one smooth_posterior call {host:.3f} ms (host clock), "
                  f"launches K1/K4/K5/K6 {launch}, plain-version calls {plain_n}, paths of the "
                  f"right shape and finite {ok}; peak device memory {peak:.3f} GB ({held:.3f} GB "
                  f"held before); profile of one more call: {prof}", flush=True)
            if not ok or plain_n or launch[0] == 0 or launch[2] == 0:
                fail(f"{label} serving: launches {launch}, plain versions {plain_n}, paths ok {ok}")
            res["serve"] = dict(ms=host, launches=launch, peak=peak)
            free()
        if n_train:
            train_step = pt.make_train_step(ssm_, cfg, pt.make_optimizer(cfg))
            if warm:
                train_step(run_gen, ys_)
                free()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated() / 1e9
            step_ms = []

            def steps():
                out = []
                for _ in range(n_train):
                    t0 = time.perf_counter()
                    out.append(train_step(run_gen, ys_))
                    torch.cuda.synchronize()
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                return out

            metrics, launch, plain_n = counted(steps)
            peak = torch.cuda.max_memory_allocated() / 1e9
            losses = [float(m_["loss"]) for m_ in metrics]
            norms = [float(m_["grad_norm"]) for m_ in metrics]
            prof = device_breakdown(lambda: train_step(run_gen, ys_), 1, PSVO_KERNELS)
            print(f"[{label}] training: {n_train} steps{' after a warm-up' if warm else ''}, host ms "
                  f"{[round(v, 3) for v in step_ms]}, loss {[round(v, 3) for v in losses]}, grad "
                  f"norm {[round(v, 3) for v in norms]}; launches K1/K4/K5/K6 {launch} "
                  f"({[v / n_train for v in launch]} a step), plain-version calls {plain_n}; peak "
                  f"device memory {peak:.3f} GB ({held:.3f} GB held before); profile of one more "
                  f"step: {prof}", flush=True)
            if plain_n or 0 in launch or not all(math.isfinite(v) for v in losses + norms):
                fail(f"{label} training: launches {launch}, plain versions {plain_n}, losses "
                     f"{losses}, grad norms {norms}")
            res["train"] = dict(ms=statistics.median(step_ms), launches=[v // n_train for v in launch],
                                peak=peak)
        del ssm_
        free()
        return res

    # (ak) T = 1025: serve at S = 8, train at S = 8 and S = 1
    ak = {S: drive(f"ak S={S}", long_t_config(pt, 1025, S), ys, 3) for S in (8, 1)}
    if not ak[8]["train"]["peak"] < ak[1]["train"]["peak"]:
        fail(f"at T=1025 the S=8 train step's peak ({ak[8]['train']['peak']:.3f} GB) is not below "
             f"S=1's ({ak[1]['train']['peak']:.3f} GB)")
    want = [32, 16, 17, 9]  # a train step at S=8: K1 4 passes, K4 2, K5 2 and t=0, K6 1 and t=0
    if ak[8]["train"]["launches"] != want or ak[8]["serve"]["launches"] != [16, 0, 9, 0]:
        fail(f"S=8 launches {ak[8]['train']['launches']} a train step (want {want}), "
             f"{ak[8]['serve']['launches']} a serving call (want [16, 0, 9, 0])")
    phase_done("ak")

    # (al) T = AL_T: serve and train at S = 8; S = 1 only if its reckoned peak fits
    ds_long = pt.generate_dataset(long_t_config(pt, AL_T, 8).data, SEED)
    ys_long = ds_long.obs_train[:b].to(dev).contiguous()
    # the kernels and the glue's operations are warm from (ak): no warm-up calls
    al = {8: drive("al S=8", long_t_config(pt, AL_T, 8), ys_long, 1, warm=False)}
    reckoned = psvo_peak_gb(AL_T, b, k, m, dx)
    print(f"[al] S=1 at T={AL_T}: reckoned peak {reckoned:.3f} GB (the cache, K1's ancestors, the "
          f"Gumbel stack, the support terms and d_xs), under 70 GB: {reckoned < 70}", flush=True)
    if reckoned < 70:
        al[1] = drive("al S=1", long_t_config(pt, AL_T, 1), ys_long, 1, warm=False)
    phase_done("al")
    return dict(ak=ak, al=al)



GENERAL = ("fhn_iwae_k16", "fhn_fivo_known_dynamics", "fhn_fivo_tril", "fhn_fivo_dirac")
# phase aq, set before its first run: the small size per value and per gradient leaf (the
# CPU tests' bands), the full size as the reference's _grads_agree (benchmark.py:697-729)
GENERAL_TOL = {"value": 2e-4, "grad_rtol": 5e-3, "grad_atol": 5e-4, "full_loss": 1e-3,
               "full_norm": 1e-2, "full_cos": 0.99}
AP_CALLS = 2  # phase ap: train calls a preset (3 until the script's run time had to make room)
AP_T = 50  # phase ap: the presets' T (100 until the script's run time had to make room)
AS_STEPS = 4  # phase as: CLI train steps a preset (at most AS_STEPS // 2 a call), evals at 2, 4
GENERAL_PATH_KERNELS = {"K7": ("ancestor_indices",), "K8": ("gather_particles_kernel",),
                        "K11": ("segment_sum",)}


def general_counters():
    """(the general path's kernels K7, K8, K11; every other kernel wrapper;
    every plain version) of the port, for launch and call counts."""
    from psvo_tpu_torch.ops import ffbsi, fused_step, svo, trunk
    from psvo_tpu_torch.ops import resample_gather as rg

    mine = (rg.ancestor_indices_large, rg.gather_particles, rg.segment_sum_scatter)
    others = (fused_step.scan_forward, fused_step.scan_backward, fused_step.step_forward,
              fused_step.step_backward, trunk.trunk_forward, trunk.trunk_backward,
              ffbsi.ffbsi_forward, ffbsi.ffbsi_backward, svo.svo_sweep_forward,
              svo.svo_sweep_backward, fused_step.stream_noise, fused_step.ancestor_indices)
    plain = (rg.ancestor_indices_large_reference, rg.gather_particles_reference,
             rg.segment_sum_scatter_reference, fused_step.scan_forward_reference,
             fused_step.scan_backward_reference, fused_step.step_forward_reference,
             fused_step.step_backward_reference, fused_step.stream_noise_reference,
             fused_step.ancestor_indices_reference, trunk.trunk_forward_reference,
             trunk.trunk_backward_reference, ffbsi.ffbsi_forward_reference,
             ffbsi.ffbsi_backward_reference, svo.svo_sweep_forward_reference,
             svo.svo_sweep_backward_reference)
    return mine, others, plain


def kalman_module():
    """tests/reference_numpy/kalman.py, loaded by its path: the package's
    __init__ imports the NumPy SMC oracle, which imports JAX."""
    import importlib.util

    path = os.path.join(ROOT, "tests", "reference_numpy", "kalman.py")
    spec = importlib.util.spec_from_file_location("psvo_kalman_oracle", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lgssm_case(full: bool):
    """(A, C, L_q, L_r, mu0, s0) of the Kalman oracle's LGSSM: tests/helpers.
    default_lgssm (diagonal noise, q 0.4, r 0.5) or, with `full`,
    tests/test_parity_modes.py::_full_cov_case (correlated noise)."""
    import numpy as np

    theta = 0.4
    a = 0.85 * np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]],
                        np.float32)
    c = np.eye(2, dtype=np.float32)
    if full:
        q_chol = np.array([[0.5, 0.0], [0.3, 0.4]], np.float32)
        r_chol = np.array([[0.4, 0.0], [-0.2, 0.3]], np.float32)
    else:
        q_chol, r_chol = 0.4 * np.eye(2, dtype=np.float32), 0.5 * np.eye(2, dtype=np.float32)
    return a, c, q_chol, r_chol, np.zeros(2, np.float32), 1.0


def simulate_lgssm(rng, a, c, q_chol, r_chol, mu0, s0, t_steps, batch):
    """tests/helpers.simulate_lgssm_full (and, with diagonal factors,
    simulate_lgssm: the same draws in the same order) -> (xs, ys)."""
    import numpy as np

    xs = np.zeros((batch, t_steps, 2), np.float32)
    ys = np.zeros((batch, t_steps, 2), np.float32)
    x = mu0 + s0 * rng.standard_normal((batch, 2))
    for t in range(t_steps):
        if t > 0:
            x = x @ a.T + rng.standard_normal((batch, 2)) @ q_chol.T
        xs[:, t] = x
        ys[:, t] = x @ c.T + rng.standard_normal((batch, 2)) @ r_chol.T
    return xs, ys


def lgssm_model(pt, case, k: int, t_steps: int, full: bool, dev):
    """The oracle's exact model in the port (tests/helpers.lgssm_setup or
    lgssm_full_setup): bootstrap FIVO, linear heads with hidden=(), f and g
    set to (A, L_q) and (C, L_r), constant diagonal or "tril" scales."""
    import torch
    from psvo_tpu_torch.config import Config, DataConfig, NetConfig, SMCConfig

    a, c, q_chol, r_chol, mu0, s0 = case
    floor = 1e-4  # tests/helpers.SIGMA_MIN

    def raw(scale, sigma_min):
        return math.log(math.expm1(max(scale - sigma_min, 1e-8)))

    lin = NetConfig(hidden=(), cov_type="const", sigma_init=1.0, sigma_min=floor)
    fg = dataclasses.replace(lin, cov_type="tril") if full else lin
    cfg = Config(
        name="lgssm_oracle",
        data=DataConfig(datatype="lgssm", dx=2, dy=2, t_steps=t_steps),
        smc=SMCConfig(objective="fivo", n_particles=k, resampling="systematic",
                      use_bootstrap=True),
    ).with_nets(q0=lin, q1=lin, q2=lin, f=fg, g=fg, qb=lin)
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        for name, mat, chol in (("f", a, q_chol), ("g", c, r_chol)):
            head = ssm.heads[name]
            head.mean_w.copy_(torch.tensor(mat.T))
            head.mean_b.zero_()
            if full:
                head.tril_diag.copy_(torch.tensor([raw(float(chol[i, i]), floor) for i in range(2)]))
                head.tril_off.copy_(torch.tensor([float(chol[1, 0])]))
            else:
                head.raw_scale.fill_(raw(float(chol[0, 0]), floor))
        ssm.prior_mean.copy_(torch.tensor(mu0))
        ssm.prior_raw_scale.fill_(raw(s0, 1e-3))
    return cfg, ssm.to(dev)


def general_phases(pt, dev, card: str) -> dict:
    """Phases (ap)-(as): the general filter path (the reference's plain scan:
    K7/K8 resampling, K11 in the backward) for the presets that the
    reference's kernel gates exclude, served and trained through the entry
    points at full width; against itself on the CPU on the same draws;
    bootstrap FIVO against the Kalman oracle; and the CLI. Returns the
    figures for the kernels' JSON record."""
    import copy
    import shutil
    import tempfile

    import numpy as np
    import torch
    from psvo_tpu_torch import cli, smc
    from psvo_tpu_torch.ops import resampling
    from psvo_tpu_torch.ops import resample_gather as rg

    mine, others, plain = general_counters()
    hist_calls = [0]  # the plain histogram resampler, which no CUDA tensor may reach
    hist_fns = {n: getattr(resampling, n) for n in ("systematic_indices_histogram",
                                                    "inverse_cdf_indices")}

    def guarded(fn):
        def wrapper(cumw, *a):
            if cumw.is_cuda:
                hist_calls[0] += 1
            return fn(cumw, *a)
        return wrapper

    for n_, f_ in hist_fns.items():
        setattr(resampling, n_, guarded(f_))

    def zero():
        for f in mine + others:
            f.launches = 0
        for f in plain:
            f.calls = 0
        hist_calls[0] = 0

    def counted(fn):
        """fn() with its K7/K8/K11 launches, every other kernel's launches and
        the plain versions' calls (the histogram resampler's on CUDA tensors
        among them)."""
        zero()
        out = fn()
        torch.cuda.synchronize()
        return (out, [f.launches for f in mine], sum(f.launches for f in others),
                sum(f.calls for f in plain) + hist_calls[0])

    def free():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    figures = {}
    # (ap) first K7, K8 and K11 at the general path's shape (B = 32, K = 128, D = 2): device
    # times beside their plain versions, bounds and library calls
    b, k = 32, 128
    g = torch.Generator(device=dev).manual_seed(SEED + 75)
    lw = torch.randn((b, k), device=dev, generator=g) * 3
    pos = resampling.bulk_positions(g, 1, b, k, "systematic")[0].contiguous()
    idx = rg.ancestor_indices_large(lw, pos)
    xg = torch.randn((b, 2, k), device=dev, generator=g)
    cot = torch.randn((b, 2, k), device=dev, generator=g)
    idx64 = idx.long()[:, None, :].expand(-1, 2, -1)
    # K7's indices and K8's values exact; K11 against its float64 plain version
    errs = [float((idx != rg.ancestor_indices_large_reference(lw, pos)).sum()),
            float((rg.gather_particles(xg, idx) - rg.gather_particles_reference(xg, idx))
                  .abs().max()),
            float((rg.segment_sum_scatter(cot, idx).double() - rg.segment_sum_scatter_reference(
                cot.double(), idx)).abs().max())]
    k7 = [device_ms(lambda: rg.ancestor_indices_large(lw, pos)),
          device_ms(lambda: rg.ancestor_indices_large_reference(lw, pos)), None]
    k8 = [device_ms(lambda: rg.gather_particles(xg, idx)),
          device_ms(lambda: rg.gather_particles_reference(xg, idx)),
          device_ms(lambda: torch.gather(xg, -1, idx64))]
    k11 = [device_ms(lambda: rg.segment_sum_scatter(cot, idx)),
           device_ms(lambda: rg.segment_sum_scatter_reference(cot, idx)),
           device_ms(lambda: torch.zeros_like(cot).scatter_add_(-1, idx64, cot))]
    bounds = [bound(2.0 * lw.numel() * (1 + math.log2(k)), nbytes(lw, pos, idx)),
              bound(0.0, 2 * nbytes(xg) + nbytes(idx)),
              bound(cot.numel(), 2 * nbytes(cot) + nbytes(idx))]
    for name, t_, (bd, by), e_ in zip(("K7", "K8", "K11"), (k7, k8, k11), bounds, errs):
        print(f"[ap] {name} at the general path's shape (B={b}, K={k}, D=2): device time "
              f"{t_[0]:.4f} ms (torch.profiler, 20 calls), plain {t_[1]:.4f} ms, library "
              f"{'none' if t_[2] is None else f'{t_[2]:.4f} ms'}; bound {bd:.6f} ms ({by}); "
              f"max |d| against the plain version {e_:.3e}", flush=True)
    if errs[0] or errs[1] or errs[2] > 1e-5:
        fail(f"K7/K8/K11 at the general path's shape disagree with their plain versions: {errs} "
             "(K7, K8 exact; K11 within 1e-5 of float64)")
    figures["kernels"] = dict(k7=k7, k8=k8, k11=k11, bounds=bounds, errs=errs)
    # (ap) the four presets at full width on generate_dataset(seed 0)
    ap = {}
    for preset in GENERAL:
        # one step a call: fhn_iwae_k16's 50-step calls (a dispatch-amortising chunk of the
        # reference's) take about a minute each on this host-bound path; the CLI (as) runs them
        cfg = pt.PRESETS[preset]
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, steps_per_call=1),
                                  data=dataclasses.replace(cfg.data, t_steps=AP_T))
        t_steps, b = cfg.data.t_steps, cfg.train.batch_size
        resamples = cfg.smc.objective != "iwae"
        per_filter = [t_steps - 1] * 2 + [0] if resamples else [0, 0, 0]
        ds = pt.generate_dataset(cfg.data, SEED)
        obs_test = ds.obs_test[:b].to(dev)
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 70), device=dev)
        run_gen = torch.Generator(device=dev).manual_seed(SEED + 71)
        eval_step = pt.make_eval_step(ssm, cfg)
        with torch.no_grad():
            ev, ev_l, ev_o, ev_p = counted(lambda: eval_step(run_gen, obs_test))
            means, fp_l, fp_o, fp_p = counted(lambda: pt.filter_posterior(ssm, obs_test, cfg, run_gen))
        test_elbo = float(ev["elbo"])
        means_ok = (tuple(means.shape) == (b, t_steps, cfg.data.dx)
                    and bool(torch.isfinite(means).all()))
        if ev_l != per_filter or fp_l != per_filter or ev_o or fp_o or ev_p or fp_p:
            fail(f"(ap) {preset} serving launched K7/K8/K11 {ev_l} / {fp_l} (want {per_filter} a "
                 f"filter), other kernels {ev_o} / {fp_o}, plain versions {ev_p} / {fp_p}")
        if not (math.isfinite(test_elbo) and means_ok):
            fail(f"(ap) {preset} serving: test ELBO {test_elbo}, filtered means ok {means_ok}")
        eval_ms = time_ms(lambda: eval_step(run_gen, obs_test))
        print(f"[ap] {preset} served: K7/K8/K11 {ev_l} / {fp_l}, test ELBO {test_elbo:.3f}, eval "
              f"{eval_ms:.3f} ms", flush=True)
        # training: 3 calls of the preset's steps_per_call steps on random minibatches
        spc = max(int(cfg.train.steps_per_call), 1)
        pick = torch.randint(0, ds.obs_train.shape[0], (AP_CALLS, spc, b),
                             generator=torch.Generator().manual_seed(SEED + 72))
        batches = [ds.obs_train[p_].to(dev) if spc > 1 else ds.obs_train[p_[0]].to(dev)
                   for p_ in pick]
        train_step = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
        before = [p_.detach().clone() for p_ in ssm.parameters()]
        free()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        call_ms = []

        def calls():
            out = []
            for batch in batches:
                t0 = time.perf_counter()
                out.append(train_step(run_gen, batch))
                torch.cuda.synchronize()
                call_ms.append((time.perf_counter() - t0) * 1e3)
                print(f"[ap] {preset} train call {len(call_ms)}: {call_ms[-1]:.1f} ms", flush=True)
            return out

        metrics, tr_l, tr_o, tr_p = counted(calls)
        peak = (torch.cuda.max_memory_allocated() - held) / 1e9
        n_steps = AP_CALLS * spc
        per_step = [t_steps - 1] * 3 if resamples else [0, 0, 0]
        losses = [float(m_["loss"]) for m_ in metrics]
        norms = [float(m_["grad_norm"]) for m_ in metrics]
        moved = any(not torch.equal(a_, p_) for a_, p_ in zip(before, ssm.parameters()))
        step_ms = statistics.median(call_ms[1:]) / spc
        groups = GENERAL_PATH_KERNELS
        # one step in the profile (a window of 50 eager steps holds ~10^6 events); one
        # preset's profiles (reading a window of ~50,000 events takes seconds)
        one = batches[0][0] if spc > 1 else batches[0]
        profile = serve_profile = "not taken (the path's profiles are fhn_fivo_tril's)"
        if preset == "fhn_fivo_tril":
            profile = device_breakdown(lambda: train_step.single_step(run_gen, one), 1, groups)
            serve_profile = device_breakdown(lambda: eval_step(run_gen, obs_test), 1, groups)
        print(f"[ap] {preset} (B={b}, K={cfg.smc.n_particles}, T={t_steps}, hidden "
              f"{cfg.net('q1').hidden}, {cfg.smc.objective}, resampling {cfg.smc.resampling}; "
              f"smc.reference_path {smc.reference_path(ssm, cfg.smc)!r}): serving K7/K8/K11 "
              f"{ev_l} (eval) / {fp_l} (filter_posterior), test ELBO {test_elbo:.3f}, eval "
              f"{eval_ms:.3f} ms (CUDA events, median of 5 after 2); training {n_steps} steps in "
              f"{AP_CALLS} calls: loss {[round(v, 3) for v in losses]}, grad norm "
              f"{[round(v, 3) for v in norms]}, parameters moved {moved}, launches K7/K8/K11 "
              f"{tr_l} (want {[v * n_steps for v in per_step]}), other kernels {tr_o}, plain "
              f"versions {tr_p}; train step {step_ms:.3f} ms (host clock, median of the calls "
              f"after the first, per step; calls {[round(v, 3) for v in call_ms]} ms); peak "
              f"device memory {peak:.3f} GB above what was held ({card})", flush=True)
        print(f"[ap] {preset} profile of one more train step: {profile}", flush=True)
        print(f"[ap] {preset} profile of one more eval call: {serve_profile}", flush=True)
        if tr_l != [v * n_steps for v in per_step] or tr_o or tr_p:
            fail(f"(ap) {preset} training launched K7/K8/K11 {tr_l} (want "
                 f"{[v * n_steps for v in per_step]}), other kernels {tr_o}, plain versions {tr_p}")
        if not (all(math.isfinite(v) for v in losses + norms) and moved):
            fail(f"(ap) {preset} training: losses {losses}, grad norms {norms}, moved {moved}")
        ap[preset] = dict(serve=ev_l, train=[v // n_steps for v in tr_l], train_total=tr_l,
                          eval_ms=eval_ms,
                          step_ms=step_ms, peak=peak, profile=profile, elbo=test_elbo,
                          serve_profile=serve_profile)
        del ssm, train_step, eval_step, metrics, batches
        free()
    figures["ap"] = ap
    phase_done("ap")

    # (aq) the general path on the card against itself on the CPU on the same draws (made on
    # the CPU), the CPU resampling with K7's plain version (the count form), so the indices
    # are the card's
    kernel_form = functools.partial(resampling.maybe_resample, use_kernel=True)
    aq = {}
    for label, b, t_steps in (("small", 4, 20), ("full", 32, 100)):
        for preset in GENERAL:
            cfg = pt.PRESETS[preset]
            k = min(cfg.smc.n_particles, 128)  # fhn_iwae_k16 keeps K = 16 (at 128 the
            # reference's trunk class takes IWAE)
            cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, t_steps=t_steps),
                                      smc=dataclasses.replace(cfg.smc, n_particles=k))
            cpu_ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 73), device="cpu")
            card_ssm = copy.deepcopy(cpu_ssm).to(dev)
            ys = pt.generate_dataset(cfg.data, SEED).obs_train[:b].contiguous()
            g = torch.Generator().manual_seed(SEED + 74)
            method = "none" if cfg.smc.objective == "iwae" else cfg.smc.resampling
            noise = (torch.randn((b, 2, k), generator=g),
                     torch.randn((t_steps - 1, b, 2, k), generator=g),
                     resampling.bulk_positions(g, t_steps - 1, b, k, method) if method != "none"
                     else torch.zeros((t_steps - 1, b, 1)))
            runs = []

            def loss_and_grads(model, where):
                out = pt.make_objective(model, cfg)(None, ys.to(where),
                                                    noise=tuple(n_.to(where) for n_ in noise))
                out.loss.backward()
                return out

            for model, where in ((card_ssm, dev), (cpu_ssm, torch.device("cpu"))):
                if where.type == "cpu":
                    resampling.maybe_resample = kernel_form
                try:
                    out, launches, other, plain_n = counted(lambda: loss_and_grads(model, where))
                finally:
                    resampling.maybe_resample = kernel_form.func
                grads = [p_.grad.detach().double().cpu().flatten() if p_.grad is not None
                         else torch.zeros(p_.numel(), dtype=torch.float64)
                         for p_ in model.parameters()]
                runs.append(dict(loss=float(out.loss.detach()), log_z=out.elbo.detach().cpu(),
                                 inc=out.filter_result.increments.detach().cpu(), grads=grads,
                                 launches=launches, other=other, plain=plain_n))
            card_r, cpu_r = runs
            ga, gc_ = torch.cat(card_r["grads"]), torch.cat(cpu_r["grads"])
            na, nc = float(ga.norm()), float(gc_.norm())
            cos = float(ga @ gc_ / max(na * nc, 1e-30))
            d_logz = float((card_r["log_z"] - cpu_r["log_z"]).abs().max())
            d_inc = float((card_r["inc"] - cpu_r["inc"]).abs().max())
            leaf_bad = sum(int(not torch.allclose(a_, c_, rtol=GENERAL_TOL["grad_rtol"],
                                                  atol=GENERAL_TOL["grad_atol"]))
                           for a_, c_ in zip(card_r["grads"], cpu_r["grads"]))
            leaf_max = max(float((a_ - c_).abs().max()) for a_, c_ in zip(card_r["grads"],
                                                                          cpu_r["grads"]))
            want = [t_steps - 1] * 3 if method != "none" else [0, 0, 0]
            if label == "small":
                ok = (np.allclose(card_r["log_z"], cpu_r["log_z"], rtol=GENERAL_TOL["value"],
                                  atol=GENERAL_TOL["value"])
                      and np.allclose(card_r["inc"], cpu_r["inc"], rtol=GENERAL_TOL["value"],
                                      atol=GENERAL_TOL["value"]) and leaf_bad == 0)
            else:
                ok = (np.allclose(card_r["loss"], cpu_r["loss"], rtol=GENERAL_TOL["full_loss"],
                                  atol=GENERAL_TOL["full_loss"])
                      and abs(na - nc) <= GENERAL_TOL["full_norm"] * max(na, nc) + 1e-3
                      and cos >= GENERAL_TOL["full_cos"])
            print(f"[aq] {label} {preset} (B={b}, T={t_steps}, K={k}): card against CPU on the "
                  f"same draws: loss {card_r['loss']:.6f} / {cpu_r['loss']:.6f}, max |d| log Z "
                  f"{d_logz:.3e}, increments {d_inc:.3e}; gradient norm {na:.6f} / {nc:.6f}, "
                  f"cosine {cos:.9f}, leaves outside rtol {GENERAL_TOL['grad_rtol']} atol "
                  f"{GENERAL_TOL['grad_atol']}: {leaf_bad} of {len(card_r['grads'])} "
                  f"(max |d| {leaf_max:.3e}); card launches K7/K8/K11 {card_r['launches']} (want "
                  f"{want}), other kernels {card_r['other']}, plain versions {card_r['plain']}",
                  flush=True)
            if not ok:
                fail(f"(aq) {label} {preset}: the general path on the card disagrees with the CPU")
            if card_r["launches"] != want or card_r["other"] or card_r["plain"]:
                fail(f"(aq) {label} {preset}: card launches {card_r['launches']} (want {want}), "
                     f"other kernels {card_r['other']}, plain versions {card_r['plain']}")
            aq[(label, preset)] = dict(d_logz=d_logz, cos=cos, leaf_max=leaf_max)
            del cpu_ssm, card_ssm, runs
            free()
    figures["aq"] = aq
    phase_done("aq")

    # (ar) bootstrap FIVO against the Kalman oracle on the card
    kalman = kalman_module()
    ar = {}
    for label, full, seed_, t_steps, batch, k, row_tol, mean_tol in (
            ("diagonal noise", False, 42, 20, 4, 4096, 0.35, 0.1),
            ("correlated noise (tril)", True, 11, 20, 3, 2048, 0.5, None)):
        case = lgssm_case(full)
        a, c, q_chol, r_chol, mu0, s0 = case
        _, ys_np = simulate_lgssm(np.random.default_rng(seed_), a, c, q_chol, r_chol, mu0, s0,
                                  t_steps, batch)
        kf = np.array([kalman.kalman_filter(ys_np[i], a, c, q_chol @ q_chol.T, r_chol @ r_chol.T,
                                            mu0, s0 ** 2 * np.eye(2))[0] for i in range(batch)])
        cfg, ssm = lgssm_model(pt, case, k, t_steps, full, dev)
        objective = pt.make_objective(ssm, cfg)
        ys = torch.from_numpy(ys_np).to(dev)
        with torch.no_grad():
            outs, launches, other, plain_n = counted(lambda: [
                objective(torch.Generator(device=dev).manual_seed(s_), ys).elbo.cpu().numpy()
                for s_ in range(4)])
        err = np.mean(outs, axis=0) - kf
        print(f"[ar] bootstrap FIVO, {label} LGSSM (B={batch}, T={t_steps}, K={k}, 4 seeds) on "
              f"the card against the Kalman log-likelihood: errors {np.round(err, 4).tolist()} "
              f"nats (every row within {row_tol}"
              + (f", mean {float(np.mean(err)):.4f} under {mean_tol}" if mean_tol else "")
              + f"); launches K7/K8/K11 {launches}, other kernels {other}, plain versions "
              f"{plain_n}", flush=True)
        if not (np.all(np.abs(err) < row_tol) and (mean_tol is None or np.mean(err) < mean_tol)):
            fail(f"(ar) bootstrap FIVO ({label}) misses the Kalman oracle: {err}")
        if launches != [4 * (t_steps - 1)] * 2 + [0] or other or plain_n:
            fail(f"(ar) {label}: launches {launches}, other kernels {other}, plain {plain_n}")
        ar[label] = err.tolist()
        del ssm, objective
        free()
    figures["ar"] = ar
    phase_done("ar")

    # (as) the CLI on the card: AS_STEPS steps of fhn_fivo_tril and fhn_iwae_k16, two evals
    tmp = tempfile.mkdtemp(prefix="psvo_general_cli_")
    as_ = {}
    try:
        for preset in ("fhn_fivo_tril", "fhn_iwae_k16"):
            # at most AS_STEPS // 2 steps a call, so that an eval every AS_STEPS // 2 fits
            per_call = min(pt.PRESETS[preset].train.steps_per_call, AS_STEPS // 2)
            argv = ["train", "--preset", preset, "--steps", str(AS_STEPS), "--set",
                    f"train.eval_every={AS_STEPS // 2}", "--set",
                    f"train.steps_per_call={per_call}", "--results-root",
                    os.path.join(tmp, "results")]
            t_steps = pt.PRESETS[preset].data.t_steps
            resamples = pt.PRESETS[preset].smc.objective != "iwae"
            n_filters = AS_STEPS + 2 + 1  # the steps, 2 evals, the plots' latents
            want = ([(t_steps - 1) * n_filters] * 2 + [(t_steps - 1) * AS_STEPS] if resamples
                    else [0, 0, 0])
            free()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            (out, _), launches, other, plain_n = counted(lambda: run_cli(cli, argv))
            wall = time.perf_counter() - t0
            peak = (torch.cuda.max_memory_allocated() - held) / 1e9
            path = next(ln.split(": ", 1)[1] for ln in out.splitlines()
                        if ln.startswith("results: "))
            hist = json.load(open(os.path.join(path, "history.json")))
            files = [os.path.join(path, f) for f in ("params.json", "metrics.jsonl",
                                                     "history.json", f"checkpoints/{AS_STEPS}.pt")]
            keys = ("train_loss", "train_elbo", "test_elbo", "r2_1", "grad_norm")
            print(f"[as] cli train --preset {preset} --steps {AS_STEPS}: history steps "
                  f"{[r['step'] for r in hist]}, test ELBO {[round(r['test_elbo'], 3) for r in hist]}"
                  f", R²(1) {[round(r['r2_1'], 3) for r in hist]}, train step by eval window "
                  f"{[round(1e3 / r['steps_per_sec'], 3) for r in hist]} ms; launches K7/K8/K11 "
                  f"{launches} (want {want}), other kernels {other}, plain versions {plain_n}; "
                  f"files written {all(os.path.exists(f) for f in files)}; peak device memory "
                  f"{peak:.3f} GB; the command {wall:.1f} s ({card})", flush=True)
            if ([r["step"] for r in hist] != [AS_STEPS // 2, AS_STEPS]
                    or not all(math.isfinite(r[k_]) for r in hist for k_ in keys)
                    or not all(os.path.exists(f) for f in files)):
                fail(f"(as) cli train {preset}: history {hist}, files {files}")
            if launches != want or other or plain_n:
                fail(f"(as) cli train {preset}: launches {launches} (want {want}), other kernels "
                     f"{other}, plain versions {plain_n}")
            as_[preset] = dict(launches=launches, step_ms=[1e3 / r["steps_per_sec"] for r in hist],
                               peak=peak)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        for n_, f_ in hist_fns.items():
            setattr(resampling, n_, f_)
    figures["as"] = as_
    phase_done("as")

    return figures


# phases at-av, set before their first run: the card against the CPU on the same draws by
# value, norm and direction, as phase aq's full size (docs/DESIGN.md: at scale an ancestor or
# an FFBSi pick near a boundary may flip between two devices' roundings, so per-leaf allclose
# is the wrong test); the kernels against their plain versions as phases v, w and z
CPU_TOL = {"loss": 1e-3, "norm": 1e-2, "cos": 0.99}
SMOOTHING_KERNELS = {"K1": ("scan_forward_kernel",), "K4": ("scan_backward_kernel",
                                                            "sum_rows_kernel"),
                     "K12": ("svo_forward_split_kernel",),
                     "K13": ("svo_backward_split_kernel", "svo_sum_ctas_kernel",
                             "svo_bias_sum_kernel")}


def with_controls(cfg, steps_per_call: int = 1, **smc):
    """cfg with fhn_fivo_controls' controls (Di = 2, control scale 0.5,
    psvo_tpu/config.py:392-399), `smc` changes and steps_per_call train steps
    a call."""
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, di=2, control_scale=0.5),
        smc=dataclasses.replace(cfg.smc, **smc),
        train=dataclasses.replace(cfg.train, steps_per_call=steps_per_call))


def kernel_counts(kernels, plain, fn):
    """fn() with the launches of `kernels` and the calls of the `plain`
    versions it made."""
    import torch

    for f in kernels:
        f.launches = 0
    for f in plain:
        f.calls = 0
    out = fn()
    torch.cuda.synchronize()
    return out, [f.launches for f in kernels], sum(f.calls for f in plain)


def card_vs_cpu(pt, dev, cfg, ys, u, seed: int, path: str = "fused", load=None,
                replay_ancestors: bool = False) -> dict:
    """One train step's loss and gradient of cfg's objective on the card (its
    kernels) and on the CPU (their plain versions: the whole-scan class's
    path, segmented with smc.ffbsi_segments > 1, or the trunk path; with
    path "general" the CPU takes the path the card takes, the plain loop or
    the plain segments, resampling through K7's and K8's plain versions, the
    count form), on the same draws made on the CPU (the filter's ε and sorted positions, then
    PSVO's Gumbels or SVO's anchors and ε): the losses, the gradient norms,
    their cosine, the largest relative L2 of a leaf, and whether CPU_TOL
    holds. ys, u: CPU tensors; `load(ssm)` sets the weights (else seed).
    With `replay_ancestors` (the trunk path) the CPU takes the card's
    ancestor indices, step by step, in place of its own (K7's plain version):
    the full FIVO gradient's score term weights each pick by a return-to-go
    of hundreds of nats, so an ancestor that a last-bit α difference moves
    across a CDF boundary moves the gradient by far more than the
    arithmetic does; teacher-forcing the ancestors compares the rest."""
    import torch
    from psvo_tpu_torch import objectives, smc
    from psvo_tpu_torch.ops import resample_gather, resampling

    b, t, _ = ys.shape
    sc = cfg.smc
    k, m, dx = sc.n_particles, sc.n_smoothing_particles, cfg.data.dx
    g = torch.Generator().manual_seed(seed)
    resample = sc.objective != "iwae" and sc.resampling != "none"
    noise = [torch.randn((b, dx, k), generator=g), torch.randn((t - 1, b, dx, k), generator=g),
             resampling.bulk_positions(g, t - 1, b, k, sc.resampling) if resample
             else torch.zeros((t - 1, b, 1))]
    if sc.objective in ("psvo", "svo"):
        noise.append(objectives._gumbel(g, (b, m, k)))
        noise.append(objectives._gumbel(g, (t - 1, b, m, k)) if sc.objective == "psvo"
                     else torch.randn((t - 1, b, m, dx), generator=g))
    fused = functools.partial(smc._forward_filter_trunk if path == "trunk"
                              else smc._forward_filter_fused)

    def cpu_filter(ssm, generator, ys_, cfg_, *, cache, encoder_inputs, noise, **kw):
        return fused(ssm, generator, ys_, cfg_, cache=cache, encoder_inputs=encoder_inputs,
                     streams=noise, **kw)

    def cpu_segmented(ssm, generator, ys_, cfg_, n, *, encoder_inputs, noise, **kw):
        return smc._forward_filter_segmented_fused(ssm, generator, ys_, cfg_, n,
                                                   encoder_inputs=encoder_inputs, streams=noise,
                                                   **kw)

    resample = resample_gather.resample_and_gather
    maybe_resample = resampling.maybe_resample
    card_idx = []

    def record(u_, logw, x):
        idx, x_res = resample(u_, logw, x)
        card_idx.append(idx.cpu())
        return idx, x_res

    def replay(u_, logw, x):
        idx = card_idx.pop(0)
        return idx, resample_gather.gather_particles(x.contiguous(), idx)

    losses, grads = [], []
    for dev_ in (dev, torch.device("cpu")):
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(seed), device=dev_)
        if load is not None:
            load(ssm)
        kw = {} if u is None else {"controls": u.to(dev_)}
        real = (objectives.forward_filter, objectives.forward_filter_segmented)
        if dev_ != dev and path != "general":
            objectives.forward_filter, objectives.forward_filter_segmented = (cpu_filter,
                                                                              cpu_segmented)
        if dev_ != dev and path == "general":
            resampling.maybe_resample = functools.partial(maybe_resample, use_kernel=True)
        if replay_ancestors:
            resample_gather.resample_and_gather = record if dev_ == dev else replay
        try:
            out = objectives.make_objective(ssm, cfg)(None, ys.to(dev_),
                                                      noise=[n_.to(dev_) for n_ in noise], **kw)
            out.loss.backward()
        finally:
            objectives.forward_filter, objectives.forward_filter_segmented = real
            resample_gather.resample_and_gather = resample
            resampling.maybe_resample = maybe_resample
        losses.append(float(out.loss.detach()))
        grads.append([torch.zeros(p.shape, dtype=torch.float64) if p.grad is None
                      else p.grad.detach().cpu().double() for p in ssm.parameters()])
    return agreement(losses, grads)


def vs_line(r: dict) -> str:
    return (f"loss card {r['losses'][0]:.6f} CPU {r['losses'][1]:.6f} (rel {r['rel_loss']:.2e}), "
            f"grad norm {r['norms'][0]:.5f}/{r['norms'][1]:.5f} (rel {r['rel_norm']:.2e}), cosine "
            f"{r['cos']:.8f}, largest leaf rel L2 {r['leaf']:.2e}; bound {CPU_TOL}")


def svo_ctrl_check(consts, ops, cbias, gen):
    """K12 and K13 in their control mode against their plain versions on the
    same cbias: K12's free runs (allclose 2e-4) and, teacher-forced, one plain
    step from each of the kernel's own x~_{t+1}; K13 on K12's x~ with random
    cotangents zeroed on the relu-tie paths (cbias counted in f's first
    layer), per leaf (d_cbias last), bit-equal on a second launch; and the
    control mode with a zero bias bit-equal to the uncontrolled launch on the
    same weights."""
    import torch
    from psvo_tpu_torch.ops import svo

    x_anchor, eps, y = ops
    kern = svo.svo_sweep_forward(*ops, consts, cbias=cbias)
    ref = svo.svo_sweep_forward_reference(*ops, consts, cbias)
    t1, b, m, dx = eps.shape
    x_next = torch.cat([kern[3][1:], x_anchor[None]]).reshape(t1 * b, m, dx)
    x_tf = svo._step(svo._nets(consts), consts["sc"], dx, consts["dy"], x_next,
                     y.reshape(t1 * b, -1), eps.reshape(t1 * b, m, dx),
                     cb_t=cbias.reshape(t1 * b, -1))[0]

    def rel_max(a, w):
        return float(((a - w).abs() / (1 + w.abs())).max())

    def rel(got, want):
        return [float((g_ - w).norm() / w.norm().clamp_min(1e-30)) for g_, w in zip(got, want)]

    tie = svo_relu_ties(consts, ops, kern[3], cbias=cbias)
    keep = (~tie).float()
    cots = [torch.randn(s, generator=gen, device=eps.device)
            for s in ((b, m, dx), (b, m), (b, m), tuple(kern[3].shape))]
    cots = [cots[0] * keep[..., None], cots[1] * keep, cots[2] * keep, cots[3] * keep[..., None]]
    got = svo.svo_sweep_backward(*ops, consts, kern[3], *cots, cbias=cbias)
    want = svo.svo_sweep_backward_reference(*ops, consts, kern[3], *cots, cbias=cbias)
    again = svo.svo_sweep_backward(*ops, consts, kern[3], *cots, cbias=cbias)
    zero = torch.zeros_like(cbias)
    zf, uf = (svo.svo_sweep_forward(*ops, consts, cbias=zero), svo.svo_sweep_forward(*ops, consts))
    zb = svo.svo_sweep_backward(*ops, consts, kern[3], *cots, cbias=zero)
    ub = svo.svo_sweep_backward(*ops, consts, kern[3], *cots)
    torch.cuda.synchronize()
    return dict(kern=kern, close=close(kern, ref, 2e-4), max_abs_err=max_err(kern, ref),
                rel_x=rel_max(kern[3], ref[3]), rel_lp=rel_max(kern[1], ref[1]),
                rel_lq=rel_max(kern[2], ref[2]),
                tf_x=rel_max(kern[3].reshape(t1 * b, m, dx), x_tf),
                rel=rel(got, want), maxd=[float((g_ - w).abs().max()) for g_, w in zip(got, want)],
                same=all(torch.equal(g_, a) for g_, a in zip(got, again)),
                zero_bits=(all(torch.equal(a, w) for a, w in zip(zf, uf))
                           and all(torch.equal(a, w) for a, w in zip(zb[:3], ub))),
                zeroed=int(tie.sum()), n=b * m, got=got, cots=cots,
                finite=all(bool(torch.isfinite(v).all()) for v in (*kern, *got)))


def smoothing_controls_phases(pt, dev, card: str) -> dict:
    """Phases (at)-(au): PSVO and SVO with Di = 2 exogenous controls (the
    controls of fhn_fivo_controls) on the card at the full width of their
    presets: the kernels of each path against their plain versions, the card
    against the CPU on the same draws, served and trained through the entry
    points with launch counts. Returns what the kernels' JSON record needs."""
    import torch
    from psvo_tpu_torch.ops import ffbsi, fused_step, svo

    plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
             fused_step.stream_noise_reference, fused_step.ancestor_indices_reference,
             fused_step.step_forward_reference, fused_step.step_backward_reference,
             ffbsi.ffbsi_forward_reference, ffbsi.ffbsi_backward_reference,
             svo.svo_sweep_forward_reference, svo.svo_sweep_backward_reference)
    psvo_k = (fused_step.scan_forward, fused_step.scan_backward, ffbsi.ffbsi_forward,
              ffbsi.ffbsi_backward)
    svo_k = (fused_step.scan_forward, fused_step.scan_backward, svo.svo_sweep_forward,
             svo.svo_sweep_backward)
    figures = {}

    def batches(obs, ctl, n, b, seed):
        pick = torch.randint(0, obs.shape[0], (n, b), generator=torch.Generator().manual_seed(seed))
        return [(obs[p_.to(dev)].contiguous(), ctl[p_.to(dev)].contiguous()) for p_ in pick]

    def train(ssm, cfg, kernels, data, seed):
        """len(data) train steps (one a call): launches, plain calls, losses, step times."""
        step = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
        run_gen = torch.Generator(device=dev).manual_seed(seed)
        step_s = []

        def run():
            out = []
            for ys_, u_ in data:
                t0 = time.perf_counter()
                out.append(step(run_gen, ys_, controls=u_))
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
            return out

        metrics, launches, plain_n = kernel_counts(kernels, plain, run)
        losses = [float(m_["loss"]) for m_ in metrics]
        return launches, plain_n, losses, step_s

    # (at) controlled PSVO: lorenz63_psvo_k1024 with Di = 2 (K=1024, M=16, B=32, T=100)
    p_base = pt.PRESETS["lorenz63_psvo_k1024"]
    p_ds = pt.generate_dataset(with_controls(p_base).data, SEED)
    p_obs, p_ctl = p_ds.obs_train.to(dev), p_ds.controls_train.to(dev)
    at = {}
    for bound_ in ("forward", "direct"):
        cfg = with_controls(p_base, psvo_bound=bound_)
        vs = card_vs_cpu(pt, dev, cfg, p_obs[:8, :20].cpu(), p_ctl[:8, :20].cpu(), SEED + 60)
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
        ys, u = p_obs[:32].contiguous(), p_ctl[:32].contiguous()
        run_gen = torch.Generator(device=dev).manual_seed(SEED + 61)
        pt.smooth_posterior(ssm, ys, cfg, run_gen, controls=u)  # warm-up
        t0 = time.perf_counter()
        paths, serve, serve_plain = kernel_counts(
            psvo_k, plain, lambda: pt.smooth_posterior(ssm, ys, cfg, run_gen, controls=u))
        serve_ms = (time.perf_counter() - t0) * 1e3
        c1 = fused_step.scan_forward.last_cluster
        launches, train_plain, losses, step_s = train(
            ssm, cfg, psvo_k, batches(p_obs, p_ctl, 3, 32, SEED + 62), SEED + 63)
        ok_paths = tuple(paths.shape) == (32, 16, 100, 3) and bool(torch.isfinite(paths).all())
        print(f"[at] {card}: PSVO with Di=2, psvo_bound={bound_!r} (K=1024, M=16, hidden "
              f"(64, 64)): the card vs the CPU, one train step at B=8, T=20: {vs_line(vs)}; "
              f"smooth_posterior B=32, T=100: paths {tuple(paths.shape)} finite {ok_paths}, "
              f"K1/K4/K5/K6 {serve} (K1 in its control mode, C={c1}), plain versions "
              f"{serve_plain}, {serve_ms:.1f} ms (host clock, after a warm-up); 3 train steps "
              f"(B=32): loss {[round(v, 3) for v in losses]}, K1/K4/K5/K6 {launches}, plain "
              f"versions {train_plain}, step times {[round(1e3 * v, 1) for v in step_s]} ms",
              flush=True)
        if not vs["ok"]:
            fail(f"(at) controlled PSVO ({bound_}): the card disagrees with the CPU")
        if serve != [1, 0, 1, 0] or serve_plain or not ok_paths:
            fail(f"(at) controlled smooth_posterior launched K1/K4/K5/K6 {serve} (want "
                 f"[1, 0, 1, 0]), plain versions {serve_plain}, paths ok {ok_paths}")
        if launches != [3] * 4 or train_plain or not all(math.isfinite(v) for v in losses):
            fail(f"(at) controlled PSVO training launched K1/K4/K5/K6 {launches} (want 3 each), "
                 f"plain versions {train_plain}, losses {losses}")
        at[bound_] = dict(serve=serve, train=launches, vs=vs, step_ms=[1e3 * v for v in step_s])
    # segmented: S = 2 against the CPU at T = 17, then one train step at B=8, T=1025, S=8
    seg_cfg = with_controls(long_t_config(pt, 1025, 8))
    seg_ds = pt.generate_dataset(seg_cfg.data, SEED)
    s_obs, s_ctl = seg_ds.obs_train[:8], seg_ds.controls_train[:8]
    vs = card_vs_cpu(pt, dev, with_controls(long_t_config(pt, 17, 2)), s_obs[:4, :17],
                     s_ctl[:4, :17], SEED + 64)
    ssm = pt.init_ssm(seg_cfg, torch.Generator().manual_seed(SEED), device=dev)
    launches, seg_plain, losses, step_s = train(
        ssm, seg_cfg, psvo_k, [(s_obs.to(dev).contiguous(), s_ctl.to(dev).contiguous())],
        SEED + 65)
    print(f"[at] segmented PSVO with Di=2: the card vs the CPU at B=4, T=17, S=2: {vs_line(vs)}; "
          f"one train step at B=8, T=1025, S=8: loss {losses[0]:.3f}, K1/K4/K5/K6 {launches} "
          f"(want [32, 16, 17, 9]), plain versions {seg_plain}, {1e3 * step_s[0]:.1f} ms (host "
          f"clock, the first step)", flush=True)
    if not vs["ok"]:
        fail("(at) segmented controlled PSVO: the card disagrees with the CPU")
    if launches != [32, 16, 17, 9] or seg_plain or not math.isfinite(losses[0]):
        fail(f"(at) segmented controlled PSVO launched K1/K4/K5/K6 {launches}, plain versions "
             f"{seg_plain}, loss {losses}")
    at["segmented"] = dict(train=launches, vs=vs)
    figures["at"] = at
    del ssm
    torch.cuda.empty_cache()
    phase_done("at")

    # (au) controlled SVO: lorenz63_svo_k256 with Di = 2 (K=256, M=16, B=32, T=100)
    v_base = pt.PRESETS[SVO]
    v_ds = pt.generate_dataset(with_controls(v_base).data, SEED)
    v_obs, v_ctl = v_ds.obs_train.to(dev), v_ds.controls_train.to(dev)
    gen_v = torch.Generator(device=dev).manual_seed(SEED + 70)
    au = {}
    for label, small in (("small", True), ("full", False)):
        cfg, batch = slice_config(small, SVO)
        cfg = with_controls(cfg, **({"n_smoothing_particles": 8} if small else {}))
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 12), device=dev)
        ys = v_obs[:batch, :cfg.data.t_steps].contiguous()
        u_tm = v_ctl[:batch, :cfg.data.t_steps].transpose(0, 1)
        with torch.no_grad():
            consts, ops = svo_operands(ssm, cfg, ys, gen_v)
            cbias = svo.control_term(consts, u_tm[1:])
            r = svo_ctrl_check(consts, ops, cbias, gen_v)
        tol = 1e-4 if small else 1e-3
        print(f"[au] K12/K13 control mode {label} B={batch} M={ops[0].shape[1]} "
              f"T={cfg.data.t_steps} hidden={cfg.net('qb').hidden} Di=2: K12 allclose(2e-4) "
              f"{r['close']}, max|d| {r['max_abs_err']:.3e}; max |d|/(1+|x|): x~ {r['rel_x']:.3e}, "
              f"lp {r['rel_lp']:.3e}, lq {r['rel_lq']:.3e}; teacher-forced x~ {r['tf_x']:.3e}; K13 "
              + ", ".join(f"{n} rel L2 {e:.3e} max|d| {m_:.3e}" for n, e, m_ in
                          zip(("d_x_anchor", "d_weights", "d_sc", "d_cbias"), r["rel"], r["maxd"]))
              + f" (bound {tol:g}; cotangents zeroed on {r['zeroed']} of {r['n']} paths with a "
              f"relu tie); bit-equal on a second launch {r['same']}; zero controls bit-equal to "
              f"the uncontrolled launch {r['zero_bits']}", flush=True)
        ok12 = r["close"] if small else (r["tf_x"] <= 1e-5 and r["rel_x"] <= 1e-4
                                         and max(r["rel_lp"], r["rel_lq"]) <= 1e-4)
        if not (ok12 and r["finite"]):
            fail(f"(au) K12's control mode ({label}) disagrees with its plain version")
        if not (len(r["rel"]) == 4 and max(r["rel"]) <= tol and r["same"]):
            fail(f"(au) K13's control mode ({label}) disagrees with its plain version")
        if not r["zero_bits"]:
            fail(f"(au) K12/K13 with zero controls differ from the uncontrolled launch ({label})")
        au[label] = (consts, ops, cbias, r)
    consts, ops, cbias, r = au["full"]
    with torch.no_grad():
        k12_t = [(pair_ms(lambda: svo.svo_sweep_forward(*ops, consts, cbias=cbias)),
                  pair_ms(lambda: svo.svo_sweep_forward(*ops, consts))) for _ in range(3)]
        args13 = (*ops, consts, r["kern"][3], *r["cots"])
        k13_t = [(pair_ms(lambda: svo.svo_sweep_backward(*args13, cbias=cbias)),
                  pair_ms(lambda: svo.svo_sweep_backward(*args13))) for _ in range(3)]
        k12_plain = device_ms(lambda: svo.svo_sweep_forward_reference(*ops, consts, cbias), n=3)
        k13_plain = device_ms(lambda: svo.svo_sweep_backward_reference(*args13, cbias=cbias), n=3)
    t1_s, b_s, m_s = ops[1].shape[:3]
    glue = 2 * cfg.data.di * consts["hidden"] * t1_s * b_s  # u·W_u per (t, row)
    k12_flops = svo_flops(consts, t1_s * b_s * m_s) + glue
    k12c_bound = bound(k12_flops, nbytes(*ops, consts["packed"], consts["sc"], cbias, *r["kern"]))
    k13c_bound = bound(3 * k12_flops, nbytes(*args13[:3], consts["packed"], consts["sc"],
                                              *args13[4:], cbias, *r["got"]))
    k12_ms = statistics.mean(p_[0] for p_ in k12_t)
    k13_ms = statistics.mean(p_[0] for p_ in k13_t)
    print(f"[au] {card}: full (B={b_s}, M={m_s}, T-1={t1_s}, hidden 64, Di=2), device time per "
          f"call ({PAIR_HOW}), (control mode, the same shape uncontrolled) alternated: K12 "
          + ", ".join(f"({a:.4f}, {b_:.4f})" for a, b_ in k12_t) + " ms, K13 "
          + ", ".join(f"({a:.4f}, {b_:.4f})" for a, b_ in k13_t)
          + f" ms; plain K12 {k12_plain:.3f} ms, K13 {k13_plain:.3f} ms (3 calls); bounds K12 "
          f"{k12c_bound[0]:.4f} ms ({k12c_bound[1]}), K13 {k13c_bound[0]:.4f} ms "
          f"({k13c_bound[1]}), the glue's u·W_u {glue:.3e} FLOP counted in; control builds "
          f"{kernel_resources('svo_forward_split_kernelILi3ELi3ELi64ELb1EE')} (K12), "
          f"{kernel_resources('svo_backward_split_kernelILi3ELi3ELi64ELb1EE')} (K13)", flush=True)
    figures["k12"] = dict(ms=k12_ms, plain=k12_plain, bound=k12c_bound,
                          ms_unc=statistics.mean(p_[1] for p_ in k12_t),
                          err=au["small"][3]["max_abs_err"])
    figures["k13"] = dict(ms=k13_ms, plain=k13_plain, bound=k13c_bound,
                          ms_unc=statistics.mean(p_[1] for p_ in k13_t),
                          err=max(au["small"][3]["maxd"]))
    del au, args13
    # the card against the CPU, then served and trained at the preset's size
    cfg = with_controls(v_base)
    vs = card_vs_cpu(pt, dev, cfg, v_obs[:8, :20].cpu(), v_ctl[:8, :20].cpu(), SEED + 72)
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    ys, u = v_obs[:32].contiguous(), v_ctl[:32].contiguous()
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 73)
    pt.smooth_posterior(ssm, ys, cfg, run_gen, method="svo", controls=u)  # warm-up
    zero_designs(svo.svo_sweep_forward, svo.svo_sweep_backward)
    t0 = time.perf_counter()
    paths, serve, serve_plain = kernel_counts(
        svo_k, plain, lambda: pt.smooth_posterior(ssm, ys, cfg, run_gen, method="svo", controls=u))
    serve_ms = (time.perf_counter() - t0) * 1e3
    zero_designs(svo.svo_sweep_forward, svo.svo_sweep_backward)
    launches, train_plain, losses, step_s = train(
        ssm, cfg, svo_k, batches(v_obs, v_ctl, 3, 32, SEED + 74), SEED + 75)
    designs = (dict(svo.svo_sweep_forward.launches_by_design),
               dict(svo.svo_sweep_backward.launches_by_design))
    ok_paths = tuple(paths.shape) == (32, 16, 100, 3) and bool(torch.isfinite(paths).all())
    print(f"[au] {card}: SVO with Di=2 (K=256, M=16, hidden (64, 64)): the card vs the CPU, one "
          f"train step at B=8, T=20: {vs_line(vs)}; smooth_posterior(method='svo') B=32, T=100: "
          f"paths {tuple(paths.shape)} finite {ok_paths}, K1/K4/K12/K13 {serve}, plain versions "
          f"{serve_plain}, {serve_ms:.1f} ms (host clock, after a warm-up); 3 train steps (B=32): "
          f"loss {[round(v, 3) for v in losses]}, K1/K4/K12/K13 {launches} (K12, K13 by design "
          f"{designs}), plain versions {train_plain}, step times "
          f"{[round(1e3 * v, 1) for v in step_s]} ms", flush=True)
    one_more = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
    profile = device_breakdown(lambda: one_more(run_gen, ys, controls=u), 1, SMOOTHING_KERNELS)
    print(f"[au] profile of one more train step: {profile}", flush=True)
    if not vs["ok"]:
        fail("(au) controlled SVO: the card disagrees with the CPU")
    if serve != [1, 0, 1, 0] or serve_plain or not ok_paths:
        fail(f"(au) controlled smooth_posterior(method='svo') launched K1/K4/K12/K13 {serve} "
             f"(want [1, 0, 1, 0]), plain versions {serve_plain}, paths ok {ok_paths}")
    if (launches != [3] * 4 or train_plain or not all(math.isfinite(v) for v in losses)
            or designs != ({"split": 3, "chain": 0}, {"split": 3, "chain": 0})):
        fail(f"(au) controlled SVO training launched K1/K4/K12/K13 {launches} (want 3 each, all "
             f"split: {designs}), plain versions {train_plain}, losses {losses}")
    figures["au"] = dict(serve=serve, train=launches, vs=vs, step_ms=[1e3 * v for v in step_s])
    del ssm
    torch.cuda.empty_cache()
    phase_done("au")
    return figures


def multinomial_phases(pt, dev, card: str) -> dict:
    """Phase (av): multinomial resampling (sorted iid positions, streamed) on
    the whole-scan, per-step and trunk paths: K1 and K14 teacher-forced
    against the count form at every cluster size and slice count, K7 on a
    served run's weights; the card against the CPU; fhn_fivo_k1024_bench
    served and trained through K1/K4 and K14/K15, and
    lorenz96_fivo_k8192_sharded from its snapshot through K7-K11. Returns
    what the kernels' JSON record needs."""
    import torch
    from psvo_tpu_torch.ops import fused_step, resample_gather as rg, trunk

    plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
             fused_step.stream_noise_reference, fused_step.ancestor_indices_reference,
             fused_step.step_forward_reference, fused_step.step_backward_reference,
             rg.ancestor_indices_large_reference, rg.gather_particles_reference,
             trunk.trunk_forward_reference, trunk.trunk_backward_reference,
             rg.segment_sum_scatter_reference)
    fused_k = (fused_step.scan_forward, fused_step.scan_backward, fused_step.step_forward,
               fused_step.step_backward, fused_step.stream_noise)
    trunk_k = (rg.ancestor_indices_large, rg.gather_particles, trunk.trunk_forward,
               trunk.trunk_backward, rg.segment_sum_scatter)
    figures = {}

    def multinomial(cfg):
        return dataclasses.replace(cfg, smc=dataclasses.replace(cfg.smc, resampling="multinomial"),
                                   train=dataclasses.replace(cfg.train, steps_per_call=1))

    # (av) K1 and K14 on multinomial positions: the small size against the plain version, the
    # full size teacher-forced (every step's ancestors the count form on the kernel's own
    # incoming weights) at each cluster size C, and K14's chain against one K1 launch
    gen_m = torch.Generator(device=dev).manual_seed(SEED + 80)
    f_base = pt.PRESETS["fhn_fivo_k1024_bench"]
    f_ds = pt.generate_dataset(f_base.data, SEED)
    f_obs = f_ds.obs_train.to(dev)
    for label, small in (("small", True), ("full", False)):
        cfg, batch = slice_config(small)
        cfg = multinomial(cfg)
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 81), device=dev)
        with torch.no_grad():
            inp = kernel_inputs(ssm, cfg, f_obs[:batch, :cfg.data.t_steps].contiguous(), gen_m)
            t1, k = inp["coef"].shape[0], inp["x0"].shape[-1]
            pos = torch.sort(torch.rand((t1, batch, k), generator=gen_m, device=dev), -1).values
            args = (inp["x0"], inp["alpha0"], inp["coef"], inp["consts"])
            sizes = [c for c in fused_step.CLUSTER_SIZES
                     if c == 1 or k // c >= fused_step.K1_MIN_SLICE]
            runs = {c: fused_step.scan_forward(*args, eps=inp["eps"], positions=pos, cache=True,
                                               save_res=True, cluster=c) for c in sizes}
            chosen = fused_step.scan_forward(*args, eps=inp["eps"], positions=pos)
            c_pick = fused_step.scan_forward.last_cluster
            one = runs[1]
            incoming = torch.cat([inp["alpha0"][None], one[4][:-1]])
            tf_bad = sum(
                int((one[5][t] != fused_step.count_form_indices(incoming[t], pos[t])).sum())
                for t in range(t1))
            c_equal = {c: all(torch.equal(a, w) for a, w in zip(r_, one)) for c, r_ in runs.items()}
            x, lw, chain_bad = inp["x0"], inp["alpha0"], 0
            for t in range(t1):
                x, lw, _, idx = fused_step.step_forward(x, lw, inp["coef"][t], inp["consts"],
                                                        inp["eps"][t], pos[t])
                chain_bad += int((idx != one[5][t]).sum()) + int(not torch.equal(x, one[3][t]))
            s_pick = fused_step.step_forward.last_slices
            chosen_equal = all(torch.equal(a, w) for a, w in zip(chosen[:3], one[:3]))
            ref = fused_step.scan_forward_reference(*args, inp["eps"], pos, cache=True)
            err = max_err(one[:5], ref[:5])
        print(f"[av] K1/K14 multinomial {label} B={batch} K={k} T={cfg.data.t_steps}: "
              f"teacher-forced, {tf_bad} of {t1 * batch * k} ancestors differ from the count form "
              f"on the kernel's own weights; outputs bit-equal to C=1 by cluster size {c_equal} "
              f"(chosen C {c_pick}, its outputs bit-equal {chosen_equal}); "
              f"the chain of K14 launches (S={s_pick}) vs K1: {chain_bad} differing "
              f"ancestors or steps; vs the plain free run max|d| {err:.3e}", flush=True)
        if tf_bad or not (all(c_equal.values()) and chosen_equal) or chain_bad:
            fail(f"(av) K1/K14 on multinomial positions ({label}): ancestors off the count form "
                 f"({tf_bad}), cluster sizes {c_equal}, the K14 chain {chain_bad}")
        if small and not close(one[:5], ref[:5], 2e-4):
            fail(f"(av) K1 on multinomial positions (small) disagrees with its plain version")
        figures[label] = dict(err=err)
    with torch.no_grad():
        k1m = [device_ms(lambda: fused_step.scan_forward(*args, eps=inp["eps"], positions=pos)),
               device_ms(lambda: fused_step.scan_forward_reference(*args, inp["eps"], pos), n=3)]
        tm = t1 // 2
        k14_args = (one[3][tm - 1], one[4][tm - 1], inp["coef"][tm], inp["consts"],
                    inp["eps"][tm], pos[tm])
        k14_out = fused_step.step_forward(*k14_args)
        k14_ref = fused_step.step_forward_reference(*k14_args)
        k14m = [device_ms(lambda: fused_step.step_forward(*k14_args)),
                device_ms(lambda: fused_step.step_forward_reference(*k14_args), n=5)]
    consts_m = inp["consts"]
    k1m_bound = bound(trunk_flops(consts_m) * t1 * batch * k,
                      nbytes(*args[:3], consts_m["packed"], consts_m["sconst"], inp["eps"], pos,
                             *chosen[:3]))
    k14m_bound = bound(trunk_flops(consts_m) * batch * k,
                       nbytes(*k14_args[:3], k14_args[4], k14_args[5], consts_m["packed"],
                              consts_m["sconst"], *k14_out))
    k14_err = max_err(k14_out[:3], k14_ref[:3])
    print(f"[av] {card}: fhn_fivo_k1024_bench with multinomial positions (B=32, K=1024, T=100, "
          f"stream noise): K1 {k1m[0]:.3f} ms vs plain {k1m[1]:.3f} ms, bound {k1m_bound[0]:.4f} "
          f"ms ({k1m_bound[1]}); K14 at a mid step {k14m[0]:.4f} ms vs plain {k14m[1]:.4f} ms, "
          f"bound {k14m_bound[0]:.4f} ms ({k14m_bound[1]}), its max|d| against the plain step "
          f"{k14_err:.3e} (device time per launch, torch.profiler)", flush=True)
    figures["k1"] = dict(ms=k1m[0], plain=k1m[1], bound=k1m_bound)
    figures["k14"] = dict(ms=k14m[0], plain=k14m[1], bound=k14m_bound, err=k14_err)
    del runs, chosen, ref, one

    # the card against the CPU, then served (one eval) and trained (3 steps), whole scan and
    # per step
    cfg = multinomial(f_base)
    served = {}
    for scan_fused in (True, False):
        fused_step.SCAN_FUSED = scan_fused
        vs = card_vs_cpu(pt, dev, cfg, f_obs[:4, :20].cpu(), None, SEED + 82)
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
        run_gen = torch.Generator(device=dev).manual_seed(SEED + 83)
        eval_step = pt.make_eval_step(ssm, cfg)
        ev, serve, serve_plain = kernel_counts(fused_k, plain,
                                               lambda: eval_step(run_gen, f_obs[:32].contiguous()))
        step = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
        pick = torch.randint(0, f_obs.shape[0], (3, 32),
                             generator=torch.Generator().manual_seed(SEED + 84))
        step_s = []

        def run():
            out = []
            for p_ in pick:
                t0 = time.perf_counter()
                out.append(step(run_gen, f_obs[p_.to(dev)].contiguous()))
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
            return out

        metrics, launches, train_plain = kernel_counts(fused_k, plain, run)
        losses = [float(m_["loss"]) for m_ in metrics]
        path = "whole scan" if scan_fused else "per step"
        want_s, want_t = (([1, 0, 0, 0, 0], [3, 3, 0, 0, 0]) if scan_fused
                          else ([0, 0, 99, 0, 0], [0, 0, 297, 297, 0]))
        print(f"[av] {card}: fhn_fivo_k1024_bench multinomial, {path}: the card vs the CPU, one "
              f"train step at B=4, T=20: {vs_line(vs)}; eval B=32: elbo {float(ev['elbo']):.3f}, "
              f"K1/K4/K14/K15/K2 {serve} (want {want_s}), plain versions {serve_plain}; 3 train "
              f"steps (B=32): loss {[round(v, 3) for v in losses]}, K1/K4/K14/K15/K2 {launches} "
              f"(want {want_t}), plain versions {train_plain}, step times "
              f"{[round(1e3 * v, 1) for v in step_s]} ms", flush=True)
        if not vs["ok"]:
            fail(f"(av) multinomial FIVO ({path}): the card disagrees with the CPU")
        if (serve != want_s or launches != want_t or serve_plain or train_plain
                or not all(math.isfinite(v) for v in losses + [float(ev["elbo"])])):
            fail(f"(av) multinomial FIVO ({path}) launched {serve} / {launches} (want {want_s} / "
                 f"{want_t}), plain versions {serve_plain}/{train_plain}, losses {losses}")
        served[scan_fused] = dict(serve=serve, train=launches, vs=vs)
    fused_step.SCAN_FUSED = True
    figures["fhn"] = served
    del ssm
    torch.cuda.empty_cache()

    # Lorenz-96 from the trained snapshot: K7 on the served run's weights and fresh sorted
    # positions against its plain version, the card against the CPU, one filter_posterior and
    # one train step
    l_cfg = multinomial(pt.PRESETS[L96])
    l_ds = pt.generate_dataset(l_cfg.data, SEED)
    l_obs = l_ds.obs_test.to(dev)

    def snapshot(ssm_):
        pt.load_params_npz(ssm_, os.path.join(ROOT, "checkpoints/l96_pretrained.npz"))

    vs = card_vs_cpu(pt, dev, l_cfg, l_ds.obs_test[:2, :20], None, SEED + 85, path="trunk",
                     load=snapshot)
    ssm = pt.init_ssm(l_cfg, torch.Generator().manual_seed(SEED), device=dev)
    snapshot(ssm)
    ys = l_obs[:8].contiguous()
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 86)
    (means, _, logws), serve, serve_plain = kernel_counts(
        trunk_k, plain, lambda: pt.filter_posterior(ssm, ys, l_cfg, run_gen, return_particles=True))
    k_l = logws.shape[-1]
    with torch.no_grad():
        pos_l = torch.sort(torch.rand((logws.shape[1] - 1, 8, k_l), generator=gen_m, device=dev),
                           -1).values
        k7_bad = sum(int((rg.ancestor_indices_large(logws[:, t].contiguous(), pos_l[t])
                          != rg.ancestor_indices_large_reference(logws[:, t].contiguous(),
                                                                 pos_l[t])).sum())
                     for t in range(pos_l.shape[0]))
    step = pt.make_train_step(ssm, l_cfg, pt.make_optimizer(l_cfg))
    t0 = time.perf_counter()
    metrics, launches, train_plain = kernel_counts(
        trunk_k, plain, lambda: step(run_gen, l_ds.obs_train[:8].to(dev).contiguous()))
    step_ms = (time.perf_counter() - t0) * 1e3
    loss = float(metrics["loss"])
    print(f"[av] {card}: {L96} multinomial from the snapshot (B=8, K=8192, T=100): the card vs "
          f"the CPU, one train step at B=2, T=20: {vs_line(vs)}; K7 on the served run's weights "
          f"and fresh sorted positions, {k7_bad} of {pos_l.numel()} ancestors differ from its "
          f"plain version; filter_posterior: means {tuple(means.shape)}, K7/K8/K9/K10/K11 "
          f"{serve} (want [99, 99, 99, 0, 0]), plain versions {serve_plain}; one train step: loss "
          f"{loss:.3f}, K7/K8/K9/K10/K11 {launches} (want [99] * 5), plain versions "
          f"{train_plain}, {step_ms:.1f} ms (host clock)", flush=True)
    if not vs["ok"]:
        fail("(av) multinomial trunk path: the card disagrees with the CPU")
    if (k7_bad or serve != [99, 99, 99, 0, 0] or launches != [99] * 5 or serve_plain
            or train_plain or not math.isfinite(loss) or not bool(torch.isfinite(means).all())):
        fail(f"(av) multinomial trunk path: K7 off its plain version {k7_bad}, launches {serve} / "
             f"{launches}, plain versions {serve_plain}/{train_plain}, loss {loss}")
    figures["l96"] = dict(serve=serve, train=launches, vs=vs)
    del ssm, logws
    torch.cuda.empty_cache()
    phase_done("av")
    return figures


# The reference's trunk class at full width (trunk_class_phases): (label, preset, smc changes,
# data changes), one --set each on a preset; data from generate_dataset seed 0, random weights
TRUNK_CLASS = (
    ("fhn ess", "fhn_fivo_k1024_bench", {"ess_threshold": 0.5}, {}),
    ("fhn full gradient", "fhn_fivo_k1024_bench",
     {"resampling": "multinomial", "use_stop_gradient": False}, {}),
    ("fhn iwae k128", "fhn_iwae_k16", {"n_particles": 128}, {}),
    ("l63 psvo ess", "lorenz63_psvo_k1024", {"ess_threshold": 0.5}, {}),
    ("fhn controls ess", "fhn_fivo_controls", {"ess_threshold": 0.5}, {}),
    ("l96 controls", L96, {}, {"di": 2, "control_scale": 0.5}),
)
TRUNK_CLASS_KERNELS = {"K7": ("ancestor_indices",), "K8": ("gather_particles_kernel",),
                       "K9": ("trunk_forward_async_kernel",),
                       "K10": ("trunk_backward_kernel", "trunk_backward_tf32x3_kernel",
                               "trunk_sum_ctas_kernel", "trunk_sum_tiles_kernel"),
                       "K11": ("segment_sum",), "K5": ("ffbsi_staged_kernel",), "K6": K6_KERNELS}


def trunk_ctrl_check(pt, dev, preset: str, b: int, k: int, gen) -> dict:
    """K9 and K10 in their control mode (Di = 2) at preset's width, hidden
    64, on operands made on the card (x_res, the coefficient row, the
    controls' terms from random controls through the model's W_u): K9 with
    streamed ε and the in-kernel draw against its plain version (allclose
    2e-4), K10 per leaf (the controls' d_coef columns included) against its
    plain version with the relu-tie particles' cotangents zeroed (rel L2
    1e-4), bit-equal on a relaunch; with zero controls both bit-equal to the
    uncontrolled launch on the same weights; both timed (pair_ms) beside the
    uncontrolled launch and their plain versions (device_ms), with bounds."""
    import torch
    from psvo_tpu_torch.ops import fused_step, trunk

    cfg = pt.PRESETS[preset]
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, di=2, control_scale=0.5))
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 95), device=dev)
    dx = ssm.dx
    with torch.no_grad():
        consts = fused_step.prepare(ssm)
        unc = dict(consts, di=0, ctrl_w=None)
        x_res = torch.randn((b, dx, k), generator=gen, device=dev) * 2.0
        base = torch.rand((b, 4 * dx + 1), generator=gen, device=dev) + 0.1
        u = 0.5 * torch.randn((1, b, 2), generator=gen, device=dev)
        coef = torch.cat([base, fused_step.control_term(consts, u)[0]], -1).contiguous()
        zero = torch.cat([base, torch.zeros_like(coef[:, 4 * dx + 1:])], -1).contiguous()
        eps = torch.randn((b, dx, k), generator=gen, device=dev)
        seed = (29, 0xACE)
        eps_rng = fused_step.stream_noise(seed, 6, b, dx, k, dev)[0][5]
        out = {}
        for mode, noise, e in (("stream", {"eps": eps}, eps), ("rng", {"seed": seed, "t": 5},
                                                               eps_rng)):
            got = trunk.trunk_forward(x_res, coef, consts, **noise)
            want = trunk.trunk_forward_reference(x_res, coef, consts, e)
            keep = ~relu_ties(consts, x_res, got[0], coef_row=coef)
            cots = [torch.randn(got[0].shape, generator=gen, device=dev) * keep[:, None],
                    torch.randn(got[1].shape, generator=gen, device=dev) * keep]
            gb = trunk.trunk_backward(x_res, got[0], coef, consts, *cots, **noise)
            wb = trunk.trunk_backward_reference(x_res, got[0], coef, consts, e, *cots)
            rel = [float((a - w).norm() / w.norm().clamp_min(1e-30)) for a, w in zip(gb, wb)]
            again = trunk.trunk_backward(x_res, got[0], coef, consts, *cots, **noise)
            z9 = all(torch.equal(a, c) for a, c in zip(trunk.trunk_forward(x_res, zero, consts,
                                                                           **noise),
                                                       trunk.trunk_forward(x_res, base, unc,
                                                                           **noise)))
            zb = trunk.trunk_backward(x_res, got[0], zero, consts, *cots, **noise)
            ub = trunk.trunk_backward(x_res, got[0], base, unc, *cots, **noise)
            z10 = (torch.equal(zb[0], ub[0]) and torch.equal(zb[1][:, :4 * dx + 1], ub[1])
                   and torch.equal(zb[2], ub[2]) and torch.equal(zb[3], ub[3]))
            out[mode] = dict(err9=max_err(got, want), close9=close(got, want, 2e-4), rel10=rel,
                             err10=max_err(gb, wb), same=all(torch.equal(a, c)
                                                             for a, c in zip(gb, again)),
                             zero9=z9, zero10=z10, zeroed=int((~keep).sum()))
        x_new = got[0]
        t9 = [pair_ms(lambda: trunk.trunk_forward(x_res, coef, consts, seed=seed, t=5)),
              pair_ms(lambda: trunk.trunk_forward(x_res, base, unc, seed=seed, t=5)),
              device_ms(lambda: trunk.trunk_forward_reference(x_res, coef, consts, eps_rng), n=3)]
        bwd = (x_res, x_new, coef, consts, *cots)
        t10 = [pair_ms(lambda: trunk.trunk_backward(*bwd, seed=seed, t=5)),
               pair_ms(lambda: trunk.trunk_backward(x_res, x_new, base, unc, *cots, seed=seed,
                                                    t=5)),
               device_ms(lambda: trunk.trunk_backward_reference(*bwd[:4], eps_rng, *bwd[4:]),
                         n=3)]
    n_part = b * k
    h = consts["hidden"]
    # K9: x_res and the row's operands in, x_new and α out (ε drawn in the kernel); the
    # controls' first-layer terms add 2H per particle
    b9 = bound((trunk_flops(consts) + 2 * h) * n_part,
               2 * nbytes(x_res) + nbytes(coef, consts["packed"], consts["sconst"]) + 4 * n_part)
    b10 = bound((3 * trunk_flops(consts) + 4 * h) * n_part,
                nbytes(x_res, x_new, coef, consts["packed"], consts["sconst"], *cots, *gb))
    return dict(modes=out, k9=t9, k10=t10, b9=b9, b10=b10, design=trunk.k10_design(dx, dx),
                plan=trunk.k9_plan(dx, dx, h, consts["n_mid"]))


def trunk_class_phases(pt, dev, card: str) -> dict:
    """Phases (aw)-(ax): the reference's trunk class on the card. K9 and K10
    at the FHN and Lorenz-63 widths against their plain versions, and in their
    control mode at FHN's and Lorenz-96's; then the configurations the
    reference sends to its trunk kernel at full width (TRUNK_CLASS): the card
    against the CPU on the same draws, one serving call, 3 train steps with
    launch counts and no plain version, and a profile of one more step.
    Returns what the kernels' JSON record and PERF.md need."""
    import torch
    from psvo_tpu_torch.ops import ffbsi, fused_step, resample_gather as rg, trunk

    figures = {"aw": {}, "ctrl": {}, "ax": {}}
    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    leaves = ("d_x_res", "d_coef", "d_weights", "d_sconst")

    # (aw) K9 and K10 at (2, 2) and (3, 3): every step of one kernel run, teacher-forced
    for preset, dx in (("fhn_fivo_k1024_bench", 2), ("lorenz63_psvo_k1024", 3)):
        cfg = pt.PRESETS[preset]
        batch = cfg.train.batch_size
        ds = pt.generate_dataset(cfg.data, SEED)
        ys = ds.obs_train[:batch].to(dev).contiguous()
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 91), device=dev)
        runs = {}
        for mode, rng_seed in (("stream", None), ("in-kernel RNG", (23, 0xC0DE))):
            with torch.no_grad():
                r = trunk_run(ssm, cfg, ys, gen, rng_seed)
                rb = trunk_backward_run(ssm, cfg, ys, gen, rng_seed)
            runs[mode] = (r, rb)
            print(f"[aw] K9 {preset} (Dx=Dy={dx}) B={batch} K={cfg.smc.n_particles} "
                  f"T={cfg.data.t_steps} hidden 64 {mode}: max per-step rel L2 x_new "
                  f"{r['rel_x']:.3e} alpha {r['rel_a']:.3e}, max|d| {r['maxd']:.3e}, every step "
                  f"allclose(2e-4) {r['close']}, finite {r['finite']}"
                  + (f", bit-equal to stream mode on K2's eps {r['same']}" if rng_seed else "")
                  + f", bit-equal to the tile design {r['same_tile']}; K7 mismatches {r['k7_bad']}"
                  f"; free runs: {r['flip_rows']} of {batch} rows with an ancestor flip, max rel d "
                  f"logZ over rows without "
                  + ("none" if r["rel_z_clean"] is None else f"{r['rel_z_clean']:.3e}"),
                  flush=True)
            print(f"[aw] K10 {preset} {mode} ({trunk.k10_design(dx, dx)} design), every step: "
                  + ", ".join(f"{n} rel L2 {e:.3e} max|d| {m:.3e}" for n, e, m in
                              zip(leaves, rb["rel"], rb["maxd"]))
                  + f"; bit-equal on a relaunch {rb['same']}; bound rel L2 1e-3; cotangents zeroed "
                  f"on {rb['zeroed']} of {rb['n']} particle-steps with a relu tie; every particle's "
                  f"cotangent: rel L2 " + ", ".join(f"{e:.3e}" for e in rb["rel_raw"]), flush=True)
            ok9 = (max(r["rel_x"], r["rel_a"]) <= 1e-4 and r["finite"] and r["same"]
                   and r["same_tile"] and not r["k7_bad"]
                   and (r["rel_z_clean"] is None or r["rel_z_clean"] <= 1e-4))
            if not ok9:
                fail(f"(aw) K9 at Dx={dx} ({mode}) disagrees with its plain version")
            if not (rb["finite"] and rb["same"] and max(rb["rel"]) <= 1e-3 and not rb["k7_bad"]):
                fail(f"(aw) K10 at Dx={dx} ({mode}) disagrees with its plain version")
        x_res, coef_t, consts, eps_t = runs["in-kernel RNG"][0]["last"]
        bwd, noise, eps10, got10 = runs["in-kernel RNG"][1]["last"]
        with torch.no_grad():
            t9 = [pair_ms(lambda: trunk.trunk_forward(x_res, coef_t, consts, seed=(23, 0xC0DE),
                                                      t=98)),
                  device_ms(lambda: trunk.trunk_forward_reference(x_res, coef_t, consts, eps_t),
                            n=5)]
            t10 = [pair_ms(lambda: trunk.trunk_backward(*bwd, **noise)),
                   device_ms(lambda: trunk.trunk_backward_reference(*bwd[:4], eps10, *bwd[4:]),
                             n=5)]
        n_part = x_res.shape[0] * x_res.shape[-1]
        b9 = bound(trunk_flops(consts) * n_part,
                   2 * nbytes(x_res) + nbytes(coef_t, consts["packed"], consts["sconst"])
                   + 4 * n_part)
        b10 = bound(3 * trunk_flops(consts) * n_part,
                    nbytes(bwd[0], bwd[1], bwd[2], consts["packed"], consts["sconst"], bwd[4],
                           bwd[5], *got10))
        plan = trunk.k9_plan(dx, dx, 64, 1)
        print(f"[aw] {card}: {preset} (B={batch}, K=1024, hidden 64) device time per call "
              f"({PAIR_HOW}): K9 {t9[0]:.4f} ms (in-kernel draw, plan {plan}) vs plain "
              f"{t9[1]:.4f} ms (torch.profiler), bound {b9[0]:.4f} ms ({b9[1]}); K10 "
              f"{t10[0]:.4f} ms ({trunk.k10_design(dx, dx)}) vs plain {t10[1]:.4f} ms, bound "
              f"{b10[0]:.4f} ms ({b10[1]}); async K9 "
              f"{kernel_resources(f'trunk_forward_async_kernelILi{dx}ELi{dx}ELi64ELb0EE')}, K10 "
              f"{kernel_resources(f'trunk_backward_kernelILi{dx}ELi{dx}ELi64ELb0EE')}", flush=True)
        figures["aw"][dx] = dict(
            err9=max(runs[m][0]["maxd"] for m in runs),
            err10=max(max(runs[m][1]["maxd"]) for m in runs), k9=t9, k10=t10, b9=b9, b10=b10)
        del runs, bwd, got10, x_res
        torch.cuda.empty_cache()
    # the control mode at fhn_fivo_controls' width (B=32, K=1024) and Lorenz-96's (B=8, K=8192)
    for preset, b, k in ((CTRL, 32, 1024), (L96, 8, 8192)):
        c = trunk_ctrl_check(pt, dev, preset, b, k, gen)
        for mode, r in c["modes"].items():
            print(f"[aw] {preset} with Di=2 (B={b}, K={k}, hidden 64) {mode}: K9 control mode "
                  f"max|d| {r['err9']:.3e} allclose(2e-4) {r['close9']}; K10 ({c['design']}) rel "
                  f"L2 " + ", ".join(f"{n} {e:.3e}" for n, e in zip(leaves, r["rel10"]))
                  + f" (bound 1e-4, {r['zeroed']} relu-tie particles' cotangents zeroed), "
                  f"bit-equal on a relaunch {r['same']}; zero controls bit-equal to the "
                  f"uncontrolled launch: K9 {r['zero9']}, K10 {r['zero10']}", flush=True)
            if not (r["close9"] and max(r["rel10"]) <= 1e-4 and r["same"] and r["zero9"]
                    and r["zero10"]):
                fail(f"(aw) K9/K10 in their control mode ({preset}, {mode}) disagree with their "
                     f"plain versions or the uncontrolled launch")
        print(f"[aw] {card}: {preset} with Di=2 (B={b}, K={k}) device time per call "
              f"({PAIR_HOW}): K9 controls {c['k9'][0]:.4f} ms, uncontrolled {c['k9'][1]:.4f} ms, "
              f"plain {c['k9'][2]:.4f} ms (plan {c['plan']}), bound {c['b9'][0]:.4f} ms "
              f"({c['b9'][1]}); K10 controls {c['k10'][0]:.4f} ms, uncontrolled "
              f"{c['k10'][1]:.4f} ms, plain {c['k10'][2]:.4f} ms, bound {c['b10'][0]:.4f} ms "
              f"({c['b10'][1]})", flush=True)
        figures["ctrl"][preset] = c
    torch.cuda.empty_cache()
    phase_done("aw")

    # (ax) the configurations of the trunk class at full width
    plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
             fused_step.stream_noise_reference, fused_step.step_forward_reference,
             fused_step.step_backward_reference, rg.ancestor_indices_large_reference,
             rg.gather_particles_reference, trunk.trunk_forward_reference,
             trunk.trunk_backward_reference, rg.segment_sum_scatter_reference,
             ffbsi.ffbsi_forward_reference, ffbsi.ffbsi_backward_reference)
    kernels = (rg.ancestor_indices_large, rg.gather_particles, trunk.trunk_forward,
               trunk.trunk_backward, rg.segment_sum_scatter, ffbsi.ffbsi_forward,
               ffbsi.ffbsi_backward, fused_step.scan_forward, fused_step.scan_backward,
               fused_step.step_forward, fused_step.step_backward)
    names = "K7/K8/K9/K10/K11/K5/K6/K1/K4/K14/K15"
    for i, (label, preset, smc_kw, data_kw) in enumerate(TRUNK_CLASS):
        base = pt.PRESETS[preset]
        cfg = dataclasses.replace(
            base, smc=dataclasses.replace(base.smc, **smc_kw),
            data=dataclasses.replace(base.data, **data_kw),
            train=dataclasses.replace(base.train, steps_per_call=1))
        psvo = cfg.smc.objective == "psvo"
        resample = cfg.smc.objective != "iwae"
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
        if not (trunk.usable(ssm, cfg.smc) and not fused_step.usable(ssm, cfg.smc)):
            fail(f"(ax) {label}: not in the trunk class")
        ds = pt.generate_dataset(cfg.data, SEED)
        obs = ds.obs_train
        ctl = ds.controls_train if cfg.data.di else None
        b_cpu = 2 if preset == L96 else 4
        score = not cfg.smc.use_stop_gradient
        vs = card_vs_cpu(pt, dev, cfg, obs[:b_cpu, :20],
                         None if ctl is None else ctl[:b_cpu, :20], SEED + 100 + i, path="trunk",
                         replay_ancestors=score)
        if score:  # the free run, reported: its ancestors part where α's last bits differ
            free = card_vs_cpu(pt, dev, cfg, obs[:b_cpu, :20], None, SEED + 100 + i,
                               path="trunk")
            print(f"[ax] {label}: the card vs the CPU with their own ancestors (reported, not "
                  f"gated): {vs_line(free)}", flush=True)
        batch = cfg.train.batch_size
        ys = obs[:batch].to(dev).contiguous()
        ckw = {} if ctl is None else {"controls": ctl[:batch].to(dev).contiguous()}
        run_gen = torch.Generator(device=dev).manual_seed(SEED + 110 + i)
        if psvo:
            serve_fn = lambda: pt.smooth_posterior(ssm, ys, cfg, run_gen, **ckw)  # noqa: E731
        else:
            eval_step = pt.make_eval_step(ssm, cfg)
            serve_fn = lambda: eval_step(run_gen, ys, **ckw)  # noqa: E731
        serve_fn()  # warm-up
        t0 = time.perf_counter()
        served, serve, serve_plain = kernel_counts(kernels, plain, serve_fn)
        serve_ms = (time.perf_counter() - t0) * 1e3
        step = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
        pick = torch.randint(0, obs.shape[0], (3, batch),
                             generator=torch.Generator().manual_seed(SEED + 120 + i))
        data = [(obs[p_].to(dev).contiguous(),
                 {} if ctl is None else {"controls": ctl[p_].to(dev).contiguous()})
                for p_ in pick]
        step_s = []

        def run():
            out = []
            for ys_, kw_ in data:
                t1 = time.perf_counter()
                out.append(step(run_gen, ys_, **kw_))
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t1)
            return out

        metrics, launches, train_plain = kernel_counts(kernels, plain, run)
        losses = [float(m_["loss"]) for m_ in metrics]
        n = cfg.data.t_steps - 1
        r_ = n if resample else 0
        want_serve = [r_, r_, n, 0, 0, int(psvo), 0, 0, 0, 0, 0]
        want_train = [3 * r_, 3 * r_, 3 * n, 3 * n, 3 * r_, 3 * int(psvo), 3 * int(psvo), 0, 0, 0,
                      0]
        profile = device_breakdown(lambda: step(run_gen, *data[0][:1], **data[0][1]), 1,
                                   TRUNK_CLASS_KERNELS)
        if psvo:
            serve_out = f"paths {tuple(served.shape)} finite {bool(torch.isfinite(served).all())}"
            serve_ok = bool(torch.isfinite(served).all())
        else:
            serve_out = (f"elbo {float(served['elbo']):.3f}, ess_mean "
                         f"{float(served['ess_mean']):.1f}")
            serve_ok = math.isfinite(float(served["elbo"]))
        print(f"[ax] {card}: {label} ({preset} with {dict(smc_kw, **data_kw)}; K="
              f"{cfg.smc.n_particles}, B={batch}, T={cfg.data.t_steps}): the card vs the CPU, one "
              f"train step at B={b_cpu}, T=20"
              + (" (the CPU on the card's ancestors)" if score else "") + f": {vs_line(vs)}; serving "
              f"({'smooth_posterior' if psvo else 'make_eval_step'}) {serve_out}, {names} "
              f"{serve} (want {want_serve}), plain versions {serve_plain}, {serve_ms:.1f} ms (host "
              f"clock, after a warm-up); 3 train steps: loss {[round(v, 3) for v in losses]}, "
              f"{names} {launches} (want {want_train}), plain versions {train_plain}, step times "
              f"{[round(1e3 * v, 1) for v in step_s]} ms (host clock)", flush=True)
        print(f"[ax] {label}: profile of one more train step: {profile}", flush=True)
        if not vs["ok"]:
            fail(f"(ax) {label}: the card disagrees with the CPU")
        if (serve != want_serve or launches != want_train or serve_plain or train_plain
                or not serve_ok or not all(math.isfinite(v) for v in losses)):
            fail(f"(ax) {label} launched {serve} / {launches} (want {want_serve} / {want_train}), "
                 f"plain versions {serve_plain}/{train_plain}, losses {losses}")
        figures["ax"][label] = dict(serve=serve, train=launches, vs=vs, serve_ms=serve_ms,
                                    step_ms=[1e3 * v for v in step_s], profile=profile)
        del ssm, step, data
        torch.cuda.empty_cache()
    phase_done("ax")
    return figures


# The slice of the qb GRU and the eager smoothing routes (eager_routes_phases):
# (label, preset, smc changes, the CPU's path in card_vs_cpu). A is the main one.
ROUTE_CONFIGS = (
    ("A", "lorenz63_svo_k256", {"qb_rnn": True}, "fused"),
    ("B", "lorenz63_svo_k256", {"transition": "known"}, "general"),
    ("C", "fhn_fivo_dirac", {"objective": "psvo"}, "general"),
    ("D", "fhn_fivo_tril", {"objective": "psvo"}, "general"),
    ("E", L96, {"objective": "psvo", "n_smoothing_particles": 16}, "trunk"),
)
ROUTE_NAMES = ("K1", "K4", "K5", "K6", "K7", "K8", "K9", "K10", "K11", "K12", "K13", "K14",
               "K15", "K2", "K3")
ROUTE_KERNELS = {"K1": ("scan_forward_kernel",), "K4": ("scan_backward_kernel",
                                                        "sum_rows_kernel"),
                 "K5": ("ffbsi_staged_kernel",), "K6": K6_KERNELS,
                 "K7": ("ancestor_indices",), "K8": ("gather_particles_kernel",),
                 "K9": ("trunk_forward_async_kernel",),
                 "K10": ("trunk_backward_kernel", "trunk_backward_tf32x3_kernel",
                         "trunk_sum_ctas_kernel", "trunk_sum_tiles_kernel"),
                 "K11": ("segment_sum",)}
AZ_TRAIN = 1  # phases ay, az: train steps a configuration (3 until the run's time was cut)
AZ_T = 50  # phase az: T of configurations B-E (the presets' 100 until the run's time was cut)
BA_T, BA_S = 257, 8  # phase ba: the reference's long-T configuration, T cut from 1025 for time


def route_counters():
    """(every kernel wrapper of the port in ROUTE_NAMES' order; every plain
    version) for launch and call counts."""
    from psvo_tpu_torch.ops import ffbsi, fused_step, svo, trunk
    from psvo_tpu_torch.ops import resample_gather as rg

    kernels = (fused_step.scan_forward, fused_step.scan_backward, ffbsi.ffbsi_forward,
               ffbsi.ffbsi_backward, rg.ancestor_indices_large, rg.gather_particles,
               trunk.trunk_forward, trunk.trunk_backward, rg.segment_sum_scatter,
               svo.svo_sweep_forward, svo.svo_sweep_backward, fused_step.step_forward,
               fused_step.step_backward, fused_step.stream_noise, fused_step.ancestor_indices)
    return kernels, general_counters()[2]


def route_want(launches: dict) -> list:
    """ROUTE_NAMES' counts from {name: count}, zero elsewhere."""
    return [launches.get(n, 0) for n in ROUTE_NAMES]


def route_config(pt, preset: str, smc_kw: dict):
    """preset with smc_kw, one train step a call."""
    base = pt.PRESETS[preset]
    return dataclasses.replace(base, smc=dataclasses.replace(base.smc, **smc_kw),
                               train=dataclasses.replace(base.train, steps_per_call=1))


def peak_gb(fn):
    """fn() and the device memory it took at its peak above what was held
    before, in GB."""
    import torch

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - held) / 1e9


def route_run(pt, dev, card, phase, label, cfg, ys, load, want_serve, want_train,
              serve_method, eval_too=False, n_train=3, long_t=False):
    """One configuration at full width on the card: `serve_method` serving
    (smooth_posterior; with `eval_too` also make_eval_step) and n_train train
    steps on ys, with launch counts against ROUTE_NAMES' `want_*` and no
    plain version; host-clock times, peak memory and a device-only profile
    of one more step. With `long_t` (T = 1025: ~800,000 device operations a
    step, whose profile takes minutes to read) no warm-up call and no
    profile: `tools/routes_profile.py` profiles that step on its own.
    Returns its figures."""
    import torch

    kernels, plain = route_counters()
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    if load is not None:
        load(ssm)
    gen = torch.Generator(device=dev).manual_seed(SEED + 130)
    batch = ys.shape[0]
    figs = {}
    calls = [("smooth_posterior", lambda: pt.smooth_posterior(ssm, ys, cfg, gen,
                                                              method=serve_method))]
    if eval_too:
        eval_step = pt.make_eval_step(ssm, cfg)
        calls.append(("make_eval_step", lambda: eval_step(gen, ys)))
    for name, fn in calls:
        if not long_t:
            fn()  # warm-up
        t0 = time.perf_counter()
        out, launches, n_plain = kernel_counts(kernels, plain, fn)
        ms = (time.perf_counter() - t0) * 1e3
        if name == "smooth_posterior":
            ok = tuple(out.shape) == (batch, cfg.smc.n_smoothing_particles, ys.shape[1],
                                      cfg.data.dx) and bool(torch.isfinite(out).all())
            what = f"paths {tuple(out.shape)}"
        else:
            ok = math.isfinite(float(out["elbo"]))
            what = f"elbo {float(out['elbo']):.3f}"
        print(f"[{phase}] {card}: {label} {name}: {what}, launches "
              f"{dict(zip(ROUTE_NAMES, launches))}, plain versions {n_plain}, {ms:.1f} ms (host "
              f"clock, {'the first call' if long_t else 'after a warm-up'})", flush=True)
        if not ok or launches != want_serve or n_plain:
            fail(f"({phase}) {label} {name}: launched {launches} (want {want_serve}), plain "
                 f"versions {n_plain}, output ok {ok}")
        figs[name] = dict(launches=launches, ms=ms)
    step = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
    obs = ys
    step_s = []

    def run():
        out = []
        for _ in range(n_train):
            t1 = time.perf_counter()
            out.append(step(gen, obs))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
        return out

    before = [p.detach().clone() for p in ssm.parameters()]
    (metrics, launches, n_plain), peak = peak_gb(lambda: kernel_counts(kernels, plain, run))
    losses = [float(m_["loss"]) for m_ in metrics]
    norms = [float(m_["grad_norm"]) for m_ in metrics]
    moved = [not torch.equal(a, p.detach()) for a, p in zip(before, ssm.parameters())]
    prof = ("not taken here (tools/routes_profile.py)" if long_t else
            device_breakdown(lambda: step(gen, obs), 1, ROUTE_KERNELS))
    print(f"[{phase}] {card}: {label} {n_train} train steps at B={batch}: loss "
          f"{[round(v, 3) for v in losses]}, grad norm {[round(v, 3) for v in norms]}, "
          f"{sum(moved)} of {len(moved)} parameter tensors moved, launches "
          f"{dict(zip(ROUTE_NAMES, launches))} (want {dict(zip(ROUTE_NAMES, want_train))}), plain "
          f"versions {n_plain}, step times {[round(1e3 * v, 1) for v in step_s]} ms (host clock, "
          f"the first with its warm-up), peak {peak:.3f} GB above what was held; profile of one "
          f"more step: {prof}", flush=True)
    if (launches != want_train or n_plain or not all(math.isfinite(v) for v in losses + norms)
            or not any(moved)):
        fail(f"({phase}) {label} training launched {launches} (want {want_train}), plain "
             f"versions {n_plain}, losses {losses}, grad norms {norms}, moved {any(moved)}")
    figs.update(train=launches, step_ms=[1e3 * v for v in step_s], peak=peak, profile=prof,
                losses=losses, moved=moved, ssm=ssm)
    return figs


def eager_routes_phases(pt, dev, card: str) -> dict:
    """Phases (ay)-(ba): the qb GRU's SVO (A), and PSVO/SVO where the
    reference runs its plain code (B-E), at full width through the entry
    points; segmented PSVO outside the whole-scan class and with SCAN_FUSED
    off (F). Each against the CPU on the same draws (card_vs_cpu, CPU_TOL),
    served and trained with launch counts. Returns the figures for the
    kernels' JSON record and PERF.md."""
    import torch
    from psvo_tpu_torch import objectives, smc
    from psvo_tpu_torch.ops import fused_step

    figures = {}
    for i, (label, preset, smc_kw, path) in enumerate(ROUTE_CONFIGS):
        phase = "ay" if label == "A" else "az"
        cfg = route_config(pt, preset, smc_kw)
        if label != "A":  # the eager routes at T cut for the run's time
            cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, t_steps=AZ_T))
        n = cfg.data.t_steps - 1  # filter steps
        psvo = cfg.smc.objective == "psvo"
        load = None
        if preset == L96:
            snap = os.path.join(ROOT, "checkpoints", "l96_pretrained.npz")
            load = lambda s_: pt.load_params_npz(s_, snap)  # noqa: E731
        ds = pt.generate_dataset(cfg.data, SEED)
        b_cpu = 2 if preset == L96 else 4
        vs = card_vs_cpu(pt, dev, cfg, ds.obs_train[:b_cpu, :20], None, SEED + 140 + i,
                         path=path, load=load)
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device="cpu")
        sweep = objectives._svo_route(ssm, cfg.smc.n_smoothing_particles, True) if not psvo \
            else objectives._ffbsi_route(ssm, cfg.smc.n_particles, cfg.smc.n_smoothing_particles,
                                         True)
        print(f"[{phase}] {card}: {label} ({preset} with {smc_kw}; K={cfg.smc.n_particles}, "
              f"M={cfg.smc.n_smoothing_particles}, B={cfg.train.batch_size}, "
              f"T={cfg.data.t_steps}): forward path {smc.reference_path(ssm, cfg.smc)!r} in the "
              f"reference, sweep route {sweep!r}; the card vs the CPU, one train step at "
              f"B={b_cpu}, T=20: {vs_line(vs)}", flush=True)
        if not vs["ok"]:
            fail(f"({phase}) {label}: the card disagrees with the CPU")
        s_ = AZ_TRAIN
        if label == "A":
            want_serve, want_train = route_want({"K1": 1}), route_want({"K1": s_, "K4": s_})
        elif preset == L96:
            want_serve = route_want({"K7": n, "K8": n, "K9": n})
            want_train = route_want({k_: s_ * n for k_ in ("K7", "K8", "K9", "K10", "K11")})
        else:
            want_serve = route_want({"K7": n, "K8": n, "K5": int(sweep == "kernel")})
            want_train = route_want({"K7": s_ * n, "K8": s_ * n, "K11": s_ * n,
                                     "K5": s_ * int(sweep == "kernel"),
                                     "K6": s_ * int(sweep == "kernel")})
        batch = cfg.train.batch_size
        ys = ds.obs_train[:batch].to(dev).contiguous()
        r = route_run(pt, dev, card, phase, label, cfg, ys, load, want_serve, want_train,
                      cfg.smc.objective, eval_too=label == "A", n_train=AZ_TRAIN)
        r.update(vs=vs, route=sweep)
        if preset == L96:  # the eager FFBSi sweep at K = 8192 alone: time and memory
            ssm = r.pop("ssm")
            g = torch.Generator(device=dev).manual_seed(SEED + 150)
            m, k = cfg.smc.n_smoothing_particles, cfg.smc.n_particles
            with torch.no_grad():
                fwd = smc.forward_filter(ssm, g, ys, cfg.smc, cache=True)
                x_anchor, _ = objectives._sample_final_particles(
                    objectives._gumbel(g, (batch, m, k)), fwd)
                gum = objectives._gumbel(g, (n, batch, m, k))
                args = (ssm, x_anchor, fwd.xs[:-1], fwd.logws[:-1], gum, False)
                sweep_ms = time_ms(lambda: objectives._ffbsi_sweep(*args), reps=3, warmup=1)
                out, sweep_peak = peak_gb(lambda: objectives._ffbsi_sweep(*args))
            print(f"[az] {card}: E's eager FFBSi sweep alone (B={batch}, M={m}, K={k}, Dx=40, "
                  f"T-1={n} support steps): {sweep_ms:.2f} ms a sweep (CUDA events, the host's "
                  f"gaps included, median of 3), peak {sweep_peak:.3f} GB above the forward's "
                  f"cache; paths finite {bool(torch.isfinite(out[3]).all())}", flush=True)
            r.update(sweep_ms=sweep_ms, sweep_peak=sweep_peak)
            del fwd, gum, out, args
        r.pop("ssm", None)
        figures[label] = r
        torch.cuda.empty_cache()
        if label == "A":
            phase_done("ay")
    phase_done("az")

    # (ba) segmented PSVO on the plain body per segment: ESS-adaptive, and SCAN_FUSED off
    figures["F"] = {}
    for variant in ("ess 0.5", "SCAN_FUSED off"):
        fused_step.SCAN_FUSED = variant != "SCAN_FUSED off"
        smc_kw = {"ess_threshold": 0.5} if variant == "ess 0.5" else {}
        try:
            if variant == "ess 0.5":  # the same plain segments serve both variants
                small = long_t_config(pt, 33, 4)
                small = dataclasses.replace(small, smc=dataclasses.replace(small.smc, **smc_kw))
                ds = pt.generate_dataset(small.data, SEED)
                vs = card_vs_cpu(pt, dev, small, ds.obs_train[:2], None, SEED + 160,
                                 path="general")
                print(f"[ba] {card}: {LONG_T} {variant}, the card vs the CPU on the same draws "
                      f"at T=33, S=4, B=2: {vs_line(vs)}", flush=True)
                if not vs["ok"]:
                    fail(f"(ba) {variant}: the card disagrees with the CPU")
            cfg = long_t_config(pt, BA_T, BA_S)
            cfg = dataclasses.replace(cfg, smc=dataclasses.replace(cfg.smc, **smc_kw))
            ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device="cpu")
            if fused_step.usable(ssm, cfg.smc) and fused_step.SCAN_FUSED:
                fail(f"(ba) {variant}: in the whole-scan class")
            ds = pt.generate_dataset(cfg.data, SEED)
            ys = ds.obs_train[:8].to(dev).contiguous()
            t1 = BA_T - 1
            s_ = BA_S
            r = route_run(pt, dev, card, "ba", f"{LONG_T} {variant} (T={BA_T}, S={BA_S}, B=8)",
                          cfg, ys, None, route_want({"K7": 2 * t1, "K8": 2 * t1, "K5": s_ + 1}),
                          route_want({"K7": 4 * t1, "K8": 4 * t1, "K11": 2 * t1,
                                      "K5": 2 * s_ + 1, "K6": s_ + 1}), "psvo", n_train=1,
                          long_t=True)
        finally:
            fused_step.SCAN_FUSED = True
        r.pop("ssm", None)
        r["vs"] = vs
        figures["F"][variant] = r
        torch.cuda.empty_cache()
    phase_done("ba")
    return figures


CLI_KERNELS = ("K1", "K4", "K5", "K6")


def cli_launches(figs: dict, i: int) -> dict:
    """Kernel i of (K1, K4, K5, K6)'s launches in the CLI's runs: fhn_fivo_k128's
    200 steps (am), fhn_fivo_k1024_bench's 40 steps and one resume to 60 (an),
    lorenz63_psvo_k1024's 20 steps and its eval (ao); evals and the plots'
    latents included."""
    return {"launches_cli": {"am": figs["am"]["launches"][i], "an": figs["an"]["launches"][i],
                             "an_resume": figs["an"]["resume_launches"][i],
                             "ao": figs["ao"]["launches"][i],
                             "ao_eval": figs["ao"]["eval_launches"][i]}}


def run_cli(cli, argv, echo: bool = True):
    """cli.main(argv) in-process, its stdout and stderr captured: (stdout,
    stderr). The output is printed after it, a line at a time with [cli]
    before it (stdout only with echo). A non-zero exit or an exception fails
    the run."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    rc, exc = None, None
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = cli.main(argv)
        except (Exception, SystemExit) as e:  # reported below, with the output so far
            exc = e
    for line in (out.getvalue().splitlines() if echo or exc is not None else []):
        print(f"[cli] {line}", flush=True)
    for line in err.getvalue().splitlines():
        print(f"[cli stderr] {line}", flush=True)
    if exc is not None or rc != 0:
        fail(f"cli {' '.join(argv)}: exit {rc}, {exc!r}")
    return out.getvalue(), err.getvalue()


def cli_phases(pt, dev, card: str) -> dict:
    """Phases (am)-(ao): the product surface, `psvo_tpu_torch.cli.main`
    driven in-process as `python -m psvo_tpu_torch.cli` would be, with the
    results under a temporary directory: fhn_fivo_k128 (the README's Quick
    start), fhn_fivo_k1024_bench with a profile and two resumes from one
    checkpoint, and lorenz63_psvo_k1024 trained and then evaluated from its
    checkpoint. Each run counts K1, K4, K5 and K6 launches and plain-version
    calls. Returns the figures for the kernels' JSON record."""
    import shutil
    import tempfile

    import torch
    from psvo_tpu_torch import cli
    from psvo_tpu_torch.ops import ffbsi, fused_step
    from psvo_tpu_torch.utils.checkpoint import Checkpointer

    kernels = (fused_step.scan_forward, fused_step.scan_backward, ffbsi.ffbsi_forward,
               ffbsi.ffbsi_backward)
    plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
             fused_step.stream_noise_reference, fused_step.ancestor_indices_reference,
             ffbsi.ffbsi_forward_reference, ffbsi.ffbsi_backward_reference)
    per_step = (fused_step.step_forward, fused_step.step_backward)  # K14/K15: off this path

    def zero():
        for f in plain:
            f.calls = 0
        for f in kernels + per_step:
            f.launches = 0

    def counted(label, argv, want):
        """One CLI command with its launches, plain calls and peak memory."""
        zero()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out, err = run_cli(cli, argv, echo=argv[0] == "train")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = [f.launches for f in kernels]
        plain_calls = sum(f.calls for f in plain) + sum(f.launches for f in per_step)
        peak = (torch.cuda.max_memory_allocated() - held) / 1e9
        if launches != want or plain_calls:
            fail(f"({label}) cli {argv[0]} launched K1/K4/K5/K6 {launches} (want {want}), "
                 f"plain versions and K14/K15 {plain_calls} times")
        res = dict(out=out, err=err, launches=launches, peak=peak, wall=wall)
        if argv[0] == "train":
            path = next(ln.split(": ", 1)[1] for ln in out.splitlines()
                        if ln.startswith("results: "))
            res.update(path=path, history=json.load(open(os.path.join(path, "history.json"))),
                       note=next(ln for ln in out.splitlines() if ln.startswith("plots:")))
        return res

    def history_ok(label, hist, steps):
        keys = ("train_loss", "train_elbo", "test_elbo", "r2_1", "ess_mean", "grad_norm")
        if [r["step"] for r in hist] != steps or not all(
                math.isfinite(r[k]) for r in hist for k in keys):
            fail(f"({label}) history steps {[r['step'] for r in hist]} (want {steps}) or a "
                 f"non-finite record: {hist}")

    def step_ms(hist):
        """ms a step by the Trainer's steps_per_sec (each window ends in its eval)."""
        return [round(1e3 / r["steps_per_sec"], 3) for r in hist]

    def serve_and_checkpoint(preset, sets, ckdir):
        """The eval call's ms at B = n_test (CUDA events, median of 5 after 2
        warm-up), and one checkpoint restore and save (host clock to a
        synchronize) of the preset's Trainer state."""
        cfg = cli.apply_overrides(pt.preset(preset), sets)
        ds, ssm = cli.build(cfg, None, dev)
        tr = pt.Trainer(cfg, ssm)
        gc.collect()  # no collection of earlier phases' garbage inside the timed calls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if Checkpointer(ckdir, cfg.resume_hash()).restore(tr.state) is None:
            fail(f"no checkpoint in {ckdir}")
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        Checkpointer(os.path.join(tmp, f"save_{preset}"), cfg.resume_hash()).save(tr.state, True)
        save_ms = (time.perf_counter() - t0) * 1e3
        obs = ds.obs_test.to(dev)
        gen_e = torch.Generator(device=dev).manual_seed(SEED + 62)
        eval_ms = time_ms(lambda: tr.eval_step(gen_e, obs))
        return dict(eval_ms=eval_ms, restore_ms=restore_ms, save_ms=save_ms,
                    n_test=obs.shape[0]), tr, ds

    def summary(label, preset, run, times):
        print(f"[{label}] {preset} through the CLI: test ELBO by eval "
              f"{[round(r['test_elbo'], 3) for r in run['history']]} at steps "
              f"{[r['step'] for r in run['history']]}, R²(1) "
              f"{[round(r['r2_1'], 3) for r in run['history']]}; K1/K4/K5/K6 launches "
              f"{run['launches']}, no plain version; train step by eval window "
              f"{step_ms(run['history'])} ms (1000 / steps_per_sec, each window with its eval); "
              f"eval call {times['eval_ms']:.3f} ms at B={times['n_test']}; checkpoint restore "
              f"{times['restore_ms']:.3f} ms, save {times['save_ms']:.3f} ms; peak device memory "
              f"{run['peak']:.3f} GB above what was held; the command {run['wall']:.1f} s; "
              f"{run['note']} ({card})", flush=True)

    tmp = tempfile.mkdtemp(prefix="psvo_cli_")
    root = os.path.join(tmp, "results")
    figures = {}
    try:
        # (am) K1 at the eval's batch (B = n_test = 40) against its plain version, then
        # the README's Quick start: fhn_fivo_k128, 200 steps, an eval every 50
        for preset, rng_seed in (("fhn_fivo_k128", (9, 0xC0FFEE)),
                                 ("fhn_fivo_k1024_bench", (9, 0xC0FFEE)),
                                 ("lorenz63_psvo_k1024", None)):
            cfg = pt.PRESETS[preset]
            ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 60), device=dev)
            ys = pt.generate_dataset(cfg.data, SEED).obs_test.to(dev)
            own = torch.Generator(device=dev).manual_seed(SEED + 61)
            with torch.no_grad():
                r = check_scan(f"am {preset}", ssm, cfg, ys, own, tol=2e-4, rng_seed=rng_seed)
            k = cfg.smc.n_particles
            chosen = fused_step.cluster_size(
                ys.shape[0], k, fused_step.K1_MIN_SLICE,
                fused_step.max_active_clusters(0, dev, fused_step.prepare(ssm), k))
            print(f"[am] K1 {preset} at B={ys.shape[0]} (the eval's batch), K={k}, C={chosen}, "
                  f"{'in-kernel draw' if rng_seed else 'stream'}, cache: {scan_line(r)}",
                  flush=True)
            if not scan_ok(r, small=False):
                fail(f"K1 at B={ys.shape[0]} ({preset}) disagrees with its plain version")
        am = counted("am", ["train", "--preset", "fhn_fivo_k128", "--steps", "200", "--set",
                            "train.eval_every=50", "--results-root", root],
                     [200 + 4 + 1, 200, 0, 0])  # the steps, 4 evals, the plots' latents
        hist = am["history"]
        history_ok("am", hist, [50, 100, 150, 200])
        files = [os.path.join(am["path"], f) for f in ("params.json", "metrics.jsonl",
                                                         "history.json", "checkpoints/200.pt")]
        if not all(os.path.exists(f) for f in files):
            fail(f"(am) missing among {files}")
        if not hist[-1]["test_elbo"] > hist[0]["test_elbo"]:
            fail(f"(am) the test ELBO did not rise: {[r['test_elbo'] for r in hist]}")
        am_t, tr, ds = serve_and_checkpoint("fhn_fivo_k128", [],
                                            os.path.join(am["path"], "checkpoints"))
        summary("am", "fhn_fivo_k128", am, am_t)
        # the preset's first breakdown: one more train call of the restored Trainer's step
        spc, bsz = tr.cfg.train.steps_per_call, tr.cfg.train.batch_size
        pick = torch.randint(0, ds.obs_train.shape[0], (spc, bsz),
                             generator=torch.Generator().manual_seed(SEED + 63))
        batch = ds.obs_train[pick].to(dev)
        gen_p = torch.Generator(device=dev).manual_seed(SEED + 64)
        profile = device_breakdown(lambda: tr.train_step(gen_p, batch), spc, FHN_KERNELS)
        print(f"[am] profile of one more train call ({spc} steps, B={bsz}): {profile}",
              flush=True)
        figures["am"] = dict(launches=am["launches"], step_ms=step_ms(hist), peak=am["peak"],
                             profile=profile, **am_t)
        phase_done("am")

        # (an) the main path's preset: 40 steps with a profile, then two resumes to 60
        # from fresh copies of the step-40 checkpoints
        prof = os.path.join(tmp, "an_profile")
        cad = ["--set", "train.eval_every=20", "--set", "train.save_every=20"]
        an = counted("an", ["train", "--preset", "fhn_fivo_k1024_bench", "--steps", "40", *cad,
                            "--profile", prof, "--results-root", root], [40 + 2 + 1, 40, 0, 0])
        history_ok("an", an["history"], [20, 40])
        resumes, payloads = [], []
        for i in range(2):
            copy = os.path.join(tmp, f"an_resume_{i}")
            shutil.copytree(os.path.join(an["path"], "checkpoints"), copy)
            res = counted("an", ["train", "--preset", "fhn_fivo_k1024_bench", "--steps", "60",
                                 *cad, "--resume", copy, "--results-root", root],
                          [20 + 1 + 1, 20, 0, 0])
            if "resumed from step 40" not in res["out"]:
                fail("(an) the resumed run did not say 'resumed from step 40'")
            history_ok("an", res["history"], [60])
            resumes.append(res)
            payloads.append(torch.load(os.path.join(copy, "60.pt"), map_location="cpu",
                                       weights_only=True))
        a, b = payloads
        same = dict(
            params=all(torch.equal(a["params"][n], b["params"][n]) for n in a["params"]),
            moments=all(torch.equal(x, y) for x, y in zip(a["opt_state"]["mu"] + a["opt_state"]["nu"],
                                                          b["opt_state"]["mu"] + b["opt_state"]["nu"])),
            counters=all(torch.equal(a["opt_state"][c], b["opt_state"][c])
                         for c in ("count", "notfinite_count")),
            generator=torch.equal(a["generator"], b["generator"]))
        trace_path = os.path.join(prof, "trace.json")
        with open(trace_path) as fh:
            events = json.load(fh)["traceEvents"]
        dev_events = [e for e in events if e.get("cat") == "kernel"]
        n_k1 = sum("scan_forward_kernel" in e.get("name", "") for e in dev_events)
        n_k4 = sum("scan_backward_kernel" in e.get("name", "") for e in dev_events)
        n_events, n_dev = len(events), len(dev_events)
        del events, dev_events  # millions of objects: let no later timing collect them
        print(f"[an] profile: {trace_path} {os.path.getsize(trace_path) / 1e6:.1f} MB, "
              f"{n_events} events, {n_dev} device kernels, K1 {n_k1} and K4 {n_k4} "
              f"of them (the window traces steps 21-40: 20 each if the profiler drops none)",
              flush=True)
        print(f"[an] two resumes from one step-40 checkpoint, bit-equal at step 60: {same}; "
              f"test ELBO at 60 {[r['history'][0]['test_elbo'] for r in resumes]}", flush=True)
        if not all(same.values()):
            fail(f"(an) two resumes from one checkpoint differ: {same}")
        an_t = serve_and_checkpoint("fhn_fivo_k1024_bench", [],
                                    os.path.join(tmp, "an_resume_0"))[0]
        an["history"] = an["history"] + resumes[0]["history"]
        summary("an", "fhn_fivo_k1024_bench", an, an_t)
        figures["an"] = dict(launches=an["launches"], resume_launches=resumes[0]["launches"],
                             step_ms=step_ms(an["history"]),
                             resume_step_ms=[step_ms(r["history"])[0] for r in resumes],
                             peak=an["peak"], trace_k1=n_k1, trace_k4=n_k4, **an_t)
        phase_done("an")

        # (ao) PSVO through the CLI: train, then eval from the checkpoint
        ao = counted("ao", ["train", "--preset", "lorenz63_psvo_k1024", "--steps", "20", "--set",
                            "train.eval_every=10", "--set", "train.save_every=10",
                            "--results-root", root], [20 + 2 + 1, 20, 20 + 2 + 1, 20])
        history_ok("ao", ao["history"], [10, 20])
        ck = os.path.join(ao["path"], "checkpoints")
        captured, build = {}, cli.build

        def capturing_build(*args, **kw):
            captured["out"] = build(*args, **kw)
            return captured["out"]

        cli.build = capturing_build
        try:
            ev = counted("ao", ["eval", "--preset", "lorenz63_psvo_k1024", "--checkpoint", ck],
                         [1, 0, 1, 0])
        finally:
            cli.build = build
        out = json.loads(ev["out"])
        saved = torch.load(os.path.join(ck, "20.pt"), map_location="cpu", weights_only=True)
        live = captured["out"][1].state_dict()
        same_params = all(torch.equal(live[n].cpu(), saved["params"][n]) for n in saved["params"])
        print(f"[ao] cli eval of the step-20 checkpoint: elbo {out['elbo']:.3f}, "
              f"elbo_psvo_direct {out['elbo_psvo_direct']:.3f}, R²(1) {out['r2_k'][0]:.3f}; "
              f"K1/K4/K5/K6 launches {ev['launches']}; the eval's parameters equal the "
              f"checkpoint's {same_params}; the PSVO bounds line on stderr "
              f"{'PSVO bounds' in ev['err']}", flush=True)
        if not (math.isfinite(out["elbo"]) and math.isfinite(out["elbo_psvo_direct"])
                and "PSVO bounds" in ev["err"] and same_params):
            fail("(ao) cli eval: a non-finite bound, no PSVO bounds line, or parameters other "
                 "than the checkpoint's")
        ao_t = serve_and_checkpoint("lorenz63_psvo_k1024", [], ck)[0]
        summary("ao", "lorenz63_psvo_k1024", ao, ao_t)
        figures["ao"] = dict(launches=ao["launches"], eval_launches=ev["launches"],
                             step_ms=step_ms(ao["history"]), peak=ao["peak"], **ao_t)
        phase_done("ao")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return figures


# ---------------------------------------------------------------------------
# Data and particle sharding (sharded_phases, bb-bd): ranks of one gloo process group, all
# on cuda:0 (this machine has one card, and NCCL refuses two ranks on one GPU), started by
# psvo_tpu_torch.parallel.launch; each rank imports this file for its jobs (shard_rank)
# ---------------------------------------------------------------------------

SHARD_T = 10  # phases bc, bd: T cut from the presets' 100 for the run's time
BC_EVAL_T = 50  # phase bc's eval: T cut from the preset's 100 for the run's time
SHARD_B, SHARD_K, SHARD_D = 8, 8192, 40  # lorenz96_fivo_k8192_sharded's resampling step
SHARD_KERNELS = ("K1", "K4", "K5", "K6", "K7", "K8", "K9", "K10", "K11")


def shard_counters():
    """(the kernel wrappers of SHARD_KERNELS, in order; every plain version)."""
    from psvo_tpu_torch.ops import ffbsi, fused_step, trunk
    from psvo_tpu_torch.ops import resample_gather as rg

    kernels = (fused_step.scan_forward, fused_step.scan_backward, ffbsi.ffbsi_forward,
               ffbsi.ffbsi_backward, rg.ancestor_indices_large, rg.gather_particles,
               trunk.trunk_forward, trunk.trunk_backward, rg.segment_sum_scatter)
    return kernels, general_counters()[2]


def shard_counted(fn):
    """fn() with this rank's kernel launches {name: n} (nonzero ones), its
    plain-version calls, its collectives (`collectives.counts`) and the
    device memory it took at its peak above what was held before (GB)."""
    import torch
    from psvo_tpu_torch.parallel import collectives

    kernels, plain = shard_counters()
    for f in kernels:
        f.launches = 0
    for f in plain:
        f.calls = 0
    collectives.reset_counts()
    out, peak = peak_gb(fn) if torch.cuda.is_available() else (fn(), 0.0)
    launches = {n: f.launches for n, f in zip(SHARD_KERNELS, kernels) if f.launches}
    return out, launches, sum(f.calls for f in plain), collectives.counts(), peak


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def shard_rank(payload: dict) -> dict:
    """One rank of phases bb-bd: the payload's jobs in order (SHARD_JOBS)."""
    from psvo_tpu_torch.parallel import launch

    device = launch.rank_device(payload["device"])
    return {job["name"]: SHARD_JOBS[job["kind"]](job, device) for job in payload["jobs"]}


def _row_mesh(n: int, k: int, batch: int):
    """A 1 × n mesh (every rank on the particle axis) of K = k, batch rows."""
    from psvo_tpu_torch.config import Config, MeshConfig, SMCConfig, TrainConfig
    from psvo_tpu_torch.parallel import sharding

    return sharding.make_mesh(Config(smc=SMCConfig(n_particles=k), mesh=MeshConfig(1, n),
                                     train=TrainConfig(batch_size=batch)))


def shard_collectives(job, device) -> dict:
    """(bb) psum, pmax and a ring shift of each rank's row of job["x"] on the
    card, and the psum's and the shift's gradients with cotangents job["g"],
    against their single-process values: max |d| each."""
    import torch
    import torch.distributed as dist
    from psvo_tpu_torch.parallel import collectives, context

    n, rank = dist.get_world_size(), dist.get_rank()
    x_all, g_all = job["x"], job["g"]
    x = x_all[rank].to(device).requires_grad_(True)
    g = g_all[rank].to(device)
    with context.using(_row_mesh(n, n, 1)):
        got = {"psum": collectives.psum(x), "pmax": collectives.pmax(x)}
        torch.sum(got["psum"] * g).backward()
        got["psum_grad"], x.grad = x.grad, None
        (got["shift"],) = collectives.ring_shift(x)
        torch.sum(got["shift"] * g).backward()
        got["shift_grad"] = x.grad
    want = {"psum": x_all.sum(0), "pmax": x_all.amax(0), "shift": x_all[(rank - 1) % n],
            "psum_grad": g_all.sum(0), "shift_grad": g_all[(rank + 1) % n]}
    return {k: float((v.detach().cpu() - want[k]).abs().max()) for k, v in got.items()}


def shard_island(job, device) -> dict:
    """(bb) The resampling island on the 1 × n mesh at the Lorenz-96 preset's
    step (B = 8, K = 8192, D = 40, global weights and positions job[...]):
    the launches (K7 and K8 n times), K7 against its plain version on every
    ring step's positions as launched (clamped into [0, 1)), the global
    ancestors and particles gathered to every rank, the collectives, and
    the call's host-clock time (median of 5 after a warm-up)."""
    import torch
    import torch.distributed as dist
    from psvo_tpu_torch.ops import resample_gather as rg
    from psvo_tpu_torch.ops import sharded_resampling
    from psvo_tpu_torch.parallel import context

    n = dist.get_world_size()
    mesh = _row_mesh(n, SHARD_K, SHARD_B)
    u, logw, x = (mesh.local(t, 0, True).to(device) for t in (job["u"], job["logw"], job["x"]))
    recorded, real = [], rg.resample_and_gather

    def record(frac, logw_r, x_r):
        recorded.append((frac, logw_r))
        return real(frac, logw_r, x_r)

    def island():
        return sharded_resampling.sharded_maybe_resample(u, logw, x)

    with context.using(mesh), torch.no_grad():
        rg.resample_and_gather = record
        try:
            out, launches, plain, counts, _ = shard_counted(island)
        finally:
            rg.resample_and_gather = real
        clamped = sum(int(((f == 0) | (f == sharded_resampling.ONE_BELOW)).sum())
                      for f, _ in recorded)
        k7_mism = sum(int((rg.ancestor_indices_large(lw, f) != rg.ancestor_indices_large_reference(
            lw, f)).sum()) for f, lw in recorded)
        times = []
        for _ in range(6):
            _sync(device)
            t0 = time.perf_counter()
            island()
            _sync(device)
            times.append(time.perf_counter() - t0)
    idx_parts = [torch.empty((SHARD_B, SHARD_K // n), dtype=torch.int32) for _ in range(n)]
    dist.all_gather(idx_parts, out[4].cpu())
    x_parts = [torch.empty((SHARD_B, SHARD_D, SHARD_K // n)) for _ in range(n)]
    dist.all_gather(x_parts, out[0].cpu().contiguous())
    return {"launches": launches, "plain": plain, "counts": counts, "ring_calls": len(recorded),
            "clamped": clamped, "k7_ring_mismatches": k7_mism,
            "ms": statistics.median(times[1:]) * 1e3,
            "idx": torch.cat(idx_parts, -1), "x": torch.cat(x_parts, -1)}


def _shard_objective(cfg, ssm, ys, noise, device) -> dict:
    """The objective's loss and the world-summed gradient of the sharded
    train step's rule on this rank's rows of ys (global draws `noise`),
    with its launches, collectives and peak memory."""
    import torch
    from psvo_tpu_torch.objectives import make_objective
    from psvo_tpu_torch.parallel import collectives, context

    mesh = context.get_mesh()

    def step():
        out = make_objective(ssm, cfg)(None, mesh.local(ys, 0).to(device), None,
                                       [t.to(device) for t in noise])
        (out.loss / mesh.size).backward()
        grads = collectives.all_reduce_grads([torch.zeros_like(p) if p.grad is None else p.grad
                                              for p in ssm.parameters()])
        return float(collectives.data_mean(out.loss.detach())), grads

    (loss, grads), launches, plain, counts, peak = shard_counted(step)
    return {"loss": loss, "grads": [g.detach().cpu().double() for g in grads],
            "launches": launches, "plain": plain, "counts": counts, "peak_gb": peak}


def _shard_model(pt, cfg, device, load: bool):
    import torch

    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=device)
    if load:
        pt.load_params_npz(ssm, os.path.join(ROOT, "checkpoints", "l96_pretrained.npz"))
    return ssm


def shard_config_run(job, device) -> dict:
    """(bc, bd) One configuration on its mesh: the card-vs-CPU step (job
    "vs": global ys and draws), then with job["train"] the sharded eval step
    on the test batch and len(job["train"]) sharded train steps on the given
    global batches (draws from a generator seeded alike on every rank, or
    the global draws job["train_noise"]): launches, plain calls,
    collectives, peak memory and host-clock times of each."""
    import torch
    import psvo_tpu_torch as pt
    from psvo_tpu_torch.parallel import context, sharding

    cfg = pt.config.from_dict(job["cfg"])
    mesh = sharding.make_mesh(cfg)
    out = {}
    with context.using(mesh):
        ssm = _shard_model(pt, cfg, device, job["load"])
        if "vs" in job:
            out["vs"] = _shard_objective(cfg, ssm, *job["vs"], device)
        if "test" in job:
            ev_step = sharding.make_sharded_eval_step(ssm, cfg, mesh)
            gen = torch.Generator(device=device).manual_seed(SEED + 1)
            test = job["test"].to(device)
            _sync(device)
            t0 = time.perf_counter()
            ev, launches, plain, counts, peak = shard_counted(lambda: ev_step(gen, test))
            _sync(device)
            out["eval"] = {"elbo": float(ev["elbo"]), "r2_1": float(ev["r2_k"][0]),
                           "launches": launches, "plain": plain, "counts": counts,
                           "peak_gb": peak, "ms": (time.perf_counter() - t0) * 1e3,
                           "t": test.shape[1]}
        if "train" in job:
            ssm = _shard_model(pt, cfg, device, job["load"])
            step = sharding.make_sharded_train_step(ssm, cfg, pt.make_optimizer(cfg), mesh)
            gen = torch.Generator(device=device).manual_seed(SEED + 2)
            noises = job.get("train_noise") or [None] * len(job["train"])
            steps = []
            for batch, noise in zip(job["train"], noises):
                noise = None if noise is None else [t.to(device) for t in noise]
                _sync(device)
                t0 = time.perf_counter()
                metrics, launches, plain, counts, peak = shard_counted(
                    lambda: step(gen, batch.to(device), noise=noise))
                _sync(device)
                steps.append({"loss": float(metrics["loss"]),
                              "grad_norm": float(metrics["grad_norm"]),
                              "ms": (time.perf_counter() - t0) * 1e3, "launches": launches,
                              "plain": plain, "counts": counts, "peak_gb": peak,
                              "grads": [p.grad.detach().cpu().double()
                                        for p in ssm.parameters()]})
            out["train"] = steps
    return out


SHARD_JOBS = {"collectives": shard_collectives, "island": shard_island,
              "config": shard_config_run}


def agreement(losses, grads) -> dict:
    """Two runs' losses and gradient lists (float64, the same leaves): the
    gradient norms, their cosine, the largest relative L2 of a leaf, and
    whether CPU_TOL holds."""
    import torch

    flat = [torch.cat([g_.reshape(-1) for g_ in gs]) for gs in grads]
    norms = [float(f.norm()) for f in flat]
    cos = float(flat[0] @ flat[1] / max(norms[0] * norms[1], 1e-300))
    leaf = max(float((a - w).norm() / w.norm().clamp_min(1e-30)) for a, w in zip(*grads))
    rel_loss = abs(losses[0] - losses[1]) / max(1.0, abs(losses[1]))
    rel_norm = abs(norms[0] - norms[1]) / max(norms[1], 1e-30)
    ok = (all(math.isfinite(v) for v in list(losses) + norms) and rel_loss <= CPU_TOL["loss"]
          and rel_norm <= CPU_TOL["norm"] and cos >= CPU_TOL["cos"])
    return dict(losses=list(losses), norms=norms, cos=cos, leaf=leaf, rel_loss=rel_loss,
                rel_norm=rel_norm, ok=ok)


def shard_draws(cfg, b: int, seed: int) -> list:
    """The global draws of cfg's objective for b rows, made on the CPU (the
    filter's ε and sorted positions, then PSVO's Gumbels), as card_vs_cpu
    makes them."""
    import torch
    from psvo_tpu_torch import objectives
    from psvo_tpu_torch.ops import resampling

    sc, t = cfg.smc, cfg.data.t_steps
    k, m, dx = sc.n_particles, sc.n_smoothing_particles, cfg.data.dx
    g = torch.Generator().manual_seed(seed)
    noise = [torch.randn((b, dx, k), generator=g), torch.randn((t - 1, b, dx, k), generator=g),
             resampling.bulk_positions(g, t - 1, b, k, sc.resampling)]
    if sc.objective == "psvo":
        noise += [objectives._gumbel(g, (b, m, k)), objectives._gumbel(g, (t - 1, b, m, k))]
    return noise


def cpu_objective(pt, cfg, ys, noise, load: bool):
    """The unsharded objective's loss and gradients on the CPU on the same
    draws: the plain loop, resampling through K7's and K8's plain versions
    (the count form, as the island's K7), FFBSi eager."""
    import torch
    from psvo_tpu_torch.ops import resampling

    ssm = _shard_model(pt, cfg, torch.device("cpu"), load)
    real = resampling.maybe_resample
    resampling.maybe_resample = functools.partial(real, use_kernel=True)
    try:
        out = pt.make_objective(ssm, cfg)(None, ys, None, noise)
        out.loss.backward()
    finally:
        resampling.maybe_resample = real
    return float(out.loss.detach()), [torch.zeros(p.shape, dtype=torch.float64) if p.grad is None
                                      else p.grad.detach().double() for p in ssm.parameters()]


def sharded_phases(pt, dev, card: str) -> dict:
    """Phases (bb)-(bd): the collectives and the resampling island on 2, 4
    and 8 ranks; lorenz96_fivo_k8192_sharded on its 1 × 8 mesh at full
    width; lorenz63_psvo_k1024 on a 2 × 2 mesh and fhn_fivo_k1024_bench on a
    4 × 1 data mesh. Every rank is a gloo rank on cuda:0. Returns the
    figures for the kernels' JSON record and PERF.md."""
    import torch
    from psvo_tpu_torch.ops import fused_step, resampling
    from psvo_tpu_torch.ops import resample_gather as rg
    from psvo_tpu_torch.parallel import launch

    kind = dev.type
    figures = {}
    # (bb) K7, K8 and K11 at the per-shard shape of the 1 × 8 mesh (B = 8, K / P = 1024,
    # D = 40), in this process: errors, times (pair_ms) beside their plain versions, bounds and
    # library calls
    b, k, d = SHARD_B, SHARD_K // 8, SHARD_D
    g = torch.Generator(device=dev).manual_seed(SEED + 200)
    lw = torch.randn((b, k), device=dev, generator=g) * 3
    pos = resampling.bulk_positions(g, 1, b, k, "systematic")[0].contiguous()
    idx = rg.ancestor_indices_large(lw, pos)
    xg = torch.randn((b, d, k), device=dev, generator=g)
    cot = torch.randn((b, d, k), device=dev, generator=g)
    idx64 = idx.long()[:, None, :].expand(-1, d, -1)
    d11 = rg.segment_sum_scatter(cot, idx).double() - rg.segment_sum_scatter_reference(
        cot.double(), idx)
    errs = [float((idx != rg.ancestor_indices_large_reference(lw, pos)).sum()),
            float((rg.gather_particles(xg, idx) - rg.gather_particles_reference(xg, idx))
                  .abs().max()),
            float(d11.abs().max())]
    k11_rel = float(d11.norm() / rg.segment_sum_scatter_reference(cot.double(), idx).norm())
    times = [[pair_ms(lambda: rg.ancestor_indices_large(lw, pos)),
              pair_ms(lambda: rg.ancestor_indices_large_reference(lw, pos)), None],
             [pair_ms(lambda: rg.gather_particles(xg, idx)),
              pair_ms(lambda: rg.gather_particles_reference(xg, idx)),
              pair_ms(lambda: torch.gather(xg, -1, idx64))],
             [pair_ms(lambda: rg.segment_sum_scatter(cot, idx)),
              pair_ms(lambda: rg.segment_sum_scatter_reference(cot, idx)),
              pair_ms(lambda: torch.zeros_like(cot).scatter_add_(-1, idx64, cot))]]
    bounds = [bound(2.0 * lw.numel() * (1 + math.log2(k)), nbytes(lw, pos, idx)),
              bound(0.0, 2 * nbytes(xg) + nbytes(idx)),
              bound(cot.numel(), 2 * nbytes(cot) + nbytes(idx))]
    for name, t_, (bd, by), e_ in zip(("K7", "K8", "K11"), times, bounds, errs):
        print(f"[bb] {card}: {name} at the 1x8 mesh's per-shard shape (B={b}, K/P={k}, D={d}): "
              f"{t_[0]:.4f} ms, plain {t_[1]:.4f} ms, library "
              f"{'none' if t_[2] is None else f'{t_[2]:.4f} ms'} ({PAIR_HOW}); bound {bd:.6f} ms "
              f"({by}); max |d| against the plain version {e_:.3e}"
              + (f" (float64; rel L2 {k11_rel:.3e})" if name == "K11" else ""), flush=True)
    if errs[0] or errs[1] or k11_rel > 1e-6:
        fail(f"K7/K8/K11 at the per-shard shape disagree with their plain versions: {errs}, "
             f"K11's rel L2 {k11_rel} (K7, K8 exact; K11 within 1e-6 of float64, as phase r)")
    figures["kernels"] = dict(times=times, bounds=bounds, errs=errs)
    del lw, pos, idx, xg, cot, idx64
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the global step of the island, its one-rank K7/K8 result, and the collectives' inputs
    g = torch.Generator(device=dev).manual_seed(SEED + 201)
    logw_g = weight_rows(SHARD_K, g)
    u_g = resampling.bulk_positions(g, 1, SHARD_B, SHARD_K, "systematic")[0].contiguous()
    x_g = torch.randn((SHARD_B, SHARD_D, SHARD_K), device=dev, generator=g)
    idx_one = rg.ancestor_indices_large(logw_g, u_g)
    x_one = rg.gather_particles(x_g, idx_one)
    cdf = torch.cumsum(torch.exp(logw_g - logw_g.amax(-1, keepdim=True)).double(), -1)
    cdf = cdf / cdf[:, -1:]
    island_in = {"u": u_g.cpu(), "logw": logw_g.cpu(), "x": x_g.cpu()}
    gc_ = torch.Generator().manual_seed(SEED + 202)
    coll_x, coll_g = torch.randn((8, 4096), generator=gc_), torch.randn((8, 4096), generator=gc_)

    # (bc) lorenz96_fivo_k8192_sharded on its 1 × 8 mesh, T cut to SHARD_T but in the eval
    l96 = pt.PRESETS[L96]
    l96 = dataclasses.replace(l96, data=dataclasses.replace(l96.data, t_steps=SHARD_T))
    ds = pt.generate_dataset(l96.data, SEED)
    vs_ys = ds.obs_train[:2]
    vs_noise = shard_draws(l96, 2, SEED + 210)
    t0 = time.perf_counter()
    l96_cpu = cpu_objective(pt, l96, vs_ys, vs_noise, True)
    cpu_s = time.perf_counter() - t0
    b8 = l96.train.batch_size
    # the eval at the preset's T = 100: its peak a rank holds the global draw every rank makes
    test_full = pt.generate_dataset(pt.PRESETS[L96].data, SEED).obs_test[:b8, :BC_EVAL_T]
    l96_job = {"name": "l96", "kind": "config", "cfg": l96.to_dict(), "load": True,
               "vs": (vs_ys, vs_noise), "test": test_full,
               "train": [ds.obs_train[:b8]]}  # one step (three until the run's time was cut)
    # (bd) lorenz63_psvo_k1024 (M = 16) on a 2 × 2 mesh at B = 4, T = SHARD_T; and
    # fhn_fivo_k1024_bench (B = 32) on a 4 × 1 data mesh, one train step on given streams
    l63 = pt.PRESETS["lorenz63_psvo_k1024"]
    l63 = dataclasses.replace(
        l63, data=dataclasses.replace(l63.data, t_steps=SHARD_T),
        train=dataclasses.replace(l63.train, batch_size=4, steps_per_call=1),
        mesh=pt.MeshConfig(data=2, particle=2))
    ds63 = pt.generate_dataset(l63.data, SEED)
    psvo_ys, psvo_noise = ds63.obs_train[:4], shard_draws(l63, 4, SEED + 220)
    l63_cpu = cpu_objective(pt, l63, psvo_ys, psvo_noise, False)
    fhn = pt.PRESETS["fhn_fivo_k1024_bench"]
    fhn = dataclasses.replace(fhn, train=dataclasses.replace(fhn.train, steps_per_call=1),
                              mesh=pt.MeshConfig(data=4, particle=1))
    dsf = pt.generate_dataset(fhn.data, SEED)
    fhn_batch = dsf.obs_train[:fhn.train.batch_size]
    fhn_noise = shard_draws(fhn, fhn.train.batch_size, SEED + 230)
    # the unsharded card step on the same streams
    single = dataclasses.replace(fhn, mesh=pt.MeshConfig())
    ssm = _shard_model(pt, single, dev, False)
    fhn_single, fhn_launch, fhn_plain, _, _ = shard_counted(
        lambda: pt.make_train_step(ssm, single, pt.make_optimizer(single))(
            None, fhn_batch.to(dev), noise=[t_.to(dev) for t_ in fhn_noise]))
    fhn_single_grads = [torch.zeros(p.shape, dtype=torch.float64) if p.grad is None
                        else p.grad.detach().cpu().double() for p in ssm.parameters()]
    del ssm
    print(f"[bd] {card}: fhn_fivo_k1024_bench unsharded on the card, one train step on given "
          f"streams (B={fhn.train.batch_size}, T={fhn.data.t_steps}): loss "
          f"{float(fhn_single['loss']):.6f}, launches {fhn_launch}, plain calls {fhn_plain}",
          flush=True)
    phase_done(f"bb-bd: kernels at the per-shard shape, CPU references ({cpu_s:.1f} s for "
               f"Lorenz-96 at B=2)")

    def spawn(n, jobs):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0_ = time.perf_counter()
        try:
            res = launch.run(n, "chip_smoke:shard_rank", {"device": kind, "jobs": jobs},
                             backend="gloo", timeout=600)
        except RuntimeError as exc:
            fail(f"sharded ranks ({n}) failed: {exc}")
        return res, time.perf_counter() - t0_

    coll_island = [{"name": "collectives", "kind": "collectives", "x": None, "g": None},
                   {"name": "island", "kind": "island", **island_in}]
    runs = {}
    for n, extra in ((2, []), (4, [
            {"name": "psvo 2x2", "kind": "config", "cfg": l63.to_dict(), "load": False,
             "vs": (psvo_ys, psvo_noise)},
            {"name": "fhn 4x1", "kind": "config", "cfg": fhn.to_dict(), "load": False,
             "train": [fhn_batch], "train_noise": [fhn_noise]}]), (8, [l96_job])):
        jobs = [dict(j, x=coll_x[:n], g=coll_g[:n]) if j["kind"] == "collectives" else j
                for j in coll_island] + extra
        runs[n] = spawn(n, jobs)
        res, secs = runs[n]
        c = res[0]["collectives"]
        isl = res[0]["island"]
        flips = (isl["idx"].to(dev) != idx_one)
        n_flips = int(flips.sum())
        dist_max = 0.0
        for b_, i_ in flips.nonzero().tolist():
            dist_max = max(dist_max, float((cdf[b_] - u_g[b_, i_].double()).abs().min()))
        same_x = bool(torch.equal(isl["x"].to(dev), rg.gather_particles(x_g, isl["idx"].to(dev))))
        staged = isl["counts"]["staged_bytes"]
        print(f"[bb] {card}: {n} gloo ranks on cuda:0 ({secs:.1f} s with the start): collectives "
              f"against one process, max |d| {c}; the island at B={SHARD_B}, K={SHARD_K}, "
              f"D={SHARD_D} (weight_rows): launches per rank {isl['launches']} over "
              f"{isl['ring_calls']} ring steps, plain calls {isl['plain']}; K7 on the ring's "
              f"positions as launched ({isl['clamped']} outside the held shard, clamped) against "
              f"its plain version: {isl['k7_ring_mismatches']} mismatches; global ancestors "
              f"against one rank's K7: {n_flips} of {SHARD_B * SHARD_K} differ (largest distance "
              f"of such a position to a CDF boundary {dist_max:.3e}), particles the island's "
              f"ancestors' {same_x}; collectives per rank {isl['counts']}; host-clock "
              f"{isl['ms']:.3f} ms a call (rank 0)", flush=True)
        if (c["psum"] > 1e-4 or any(c[k_] for k_ in ("pmax", "shift", "shift_grad"))
                or c["psum_grad"] > 1e-4):
            fail(f"({n} ranks) a collective disagrees with its single-process value: {c}")
        if (isl["launches"] != {"K7": n, "K8": n} or isl["plain"] or isl["k7_ring_mismatches"]
                or not same_x or dist_max > 1e-6 or n_flips > SHARD_B * SHARD_K // 1000):
            fail(f"({n} ranks) the island: launches {isl['launches']} (want K7, K8 {n} each), "
                 f"plain {isl['plain']}, K7 ring mismatches {isl['k7_ring_mismatches']}, "
                 f"particles {same_x}, {n_flips} ancestor flips, boundary distance {dist_max}")
        figures[f"bb{n}"] = dict(collectives=c, island={k_: v for k_, v in isl.items()
                                                      if k_ not in ("idx", "x")},
                                 flips=n_flips, seconds=secs)
    phase_done("bb: collectives and the island on 2, 4 and 8 ranks")

    # (bc) the Lorenz-96 preset on its mesh
    res = runs[8][0]
    r0 = res[0]["l96"]
    vs = agreement((r0["vs"]["loss"], l96_cpu[0]), (r0["vs"]["grads"], l96_cpu[1]))
    steps = [r["l96"]["train"] for r in res]
    n_res = SHARD_T - 1
    ev = r0["eval"]
    want_filter = {"K7": 8 * (ev["t"] - 1), "K8": 8 * (ev["t"] - 1)}
    want_step = {"K7": 8 * n_res, "K8": 8 * n_res, "K11": 8 * n_res}
    print(f"[bc] {card}: {L96} on its 1x8 mesh (8 gloo ranks on cuda:0), Dx=Dy=40, K={SHARD_K} "
          f"({SHARD_K // 8} a rank), hidden (64, 64), the trained snapshot; T cut to {SHARD_T}: "
          f"the card against the CPU's unsharded plain loop on the same draws at B=2: "
          f"{vs_line(vs)}; that step's launches per rank {r0['vs']['launches']}", flush=True)
    print(f"[bc] sharded eval at B={b8}, the preset's T={ev['t']}: ELBO {ev['elbo']:.3f}, R2(1) "
          f"{ev['r2_1']:.4f}; launches per rank {ev['launches']} (want {want_filter}), plain calls "
          f"{ev['plain']}; collectives per rank {ev['counts']}; host clock {ev['ms']:.1f} ms "
          f"(rank 0, the first call); peak memory {max(r['l96']['eval']['peak_gb'] for r in res):.3f}"
          f" GB a rank (every rank draws the global [T-1, B, Dx, K] noise, then keeps its share)",
          flush=True)
    for i, st in enumerate(steps[0]):
        print(f"[bc] train step {i + 1}: loss {st['loss']:.4f}, grad norm {st['grad_norm']:.4f}, "
              f"host clock {st['ms']:.1f} ms (rank 0; ranks {[round(s[i]['ms'], 1) for s in steps]}),"
              f" launches per rank {st['launches']} (want {want_step}), plain calls "
              f"{st['plain']}, peak memory {max(s[i]['peak_gb'] for s in steps):.3f} GB a rank; "
              f"collectives per rank {st['counts']}", flush=True)
    replicas = all(torch.equal(a, b_) for s in steps[1:] for a, b_ in
                   zip(s[-1]["grads"], steps[0][-1]["grads"]))
    losses = [st["loss"] for st in steps[0]]
    if not vs["ok"]:
        fail("(bc) the sharded Lorenz-96 step on the card disagrees with the CPU")
    if (ev["launches"] != want_filter or ev["plain"]
            or any(s[i]["launches"] != want_step or s[i]["plain"] for s in steps
                   for i in range(len(s)))
            or not all(math.isfinite(v) for v in losses + [ev["elbo"]]) or not replicas):
        fail(f"(bc) launches, plain calls, finite values or replicas: eval {ev['launches']}, "
             f"steps {[st['launches'] for st in steps[0]]}, losses {losses}, replicas {replicas}")
    figures["bc"] = dict(vs=vs, eval=ev, steps=steps[0], seconds=runs[8][1])
    phase_done("bc: lorenz96_fivo_k8192_sharded on 1x8")

    # (bd) the 2 × 2 PSVO mesh and the 4 × 1 data mesh
    res = runs[4][0]
    p0 = res[0]["psvo 2x2"]["vs"]
    vs63 = agreement((p0["loss"], l63_cpu[0]), (p0["grads"], l63_cpu[1]))
    want63 = {"K7": 2 * n_res, "K8": 2 * n_res, "K11": 2 * n_res}
    print(f"[bd] {card}: lorenz63_psvo_k1024 (M=16) on a 2x2 mesh at B=4, T={SHARD_T}: the sharded "
          f"anchor and FFBSi island and the data-axis all-reduce against the CPU unsharded on the "
          f"same draws: {vs_line(vs63)}; launches per rank {p0['launches']} (want {want63}), plain "
          f"calls {p0['plain']}; collectives per rank {p0['counts']}", flush=True)
    f0 = res[0]["fhn 4x1"]["train"][0]
    vsf = agreement((f0["loss"], float(fhn_single["loss"])), (f0["grads"], fhn_single_grads))
    print(f"[bd] fhn_fivo_k1024_bench on a 4x1 data mesh (B=8 a rank), one train step through "
          f"K1/K4 per rank against the unsharded card step on the same streamed draws: "
          f"{vs_line(vsf)}; launches per rank {f0['launches']}, plain calls {f0['plain']}; "
          f"collectives per rank {f0['counts']}; host clock {f0['ms']:.1f} ms", flush=True)
    if not vs63["ok"] or p0["launches"] != want63 or p0["plain"]:
        fail("(bd) the 2x2 PSVO mesh disagrees with the CPU, or launched other kernels")
    if not vsf["ok"] or f0["launches"] != {"K1": 1, "K4": 1} or f0["plain"]:
        fail("(bd) the 4x1 data mesh disagrees with the unsharded card step, or its launches are "
             "not one K1 and one K4 a rank")
    figures["bd"] = dict(psvo=vs63, psvo_counts=p0["counts"], psvo_launches=p0["launches"],
                         fhn=vsf, fhn_counts=f0["counts"], seconds=runs[4][1])
    phase_done("bd: 2x2 PSVO and 4x1 FHN")
    return figures


STEP_CLASS = (  # phase be: (label, preset, data changes, q1/f/g widths, smc changes)
    ("be-A", "fhn_fivo_k1024_bench", {}, (64,), {}),
    ("be-B", "fhn_fivo_k1024_bench", {}, (64, 64, 64), {}),
    ("be-C", "lorenz63_psvo_k1024", {"dy": 1}, (48, 48), {}),
    ("be-D", L96, {"dx": 5, "dy": 5, "di": 2, "control_scale": 0.5}, (8, 8),
     {"n_particles": 2048}),
)
STEP_CLASS_KERNELS = ("K1", "K4", "K14", "K15", "K5", "K6")


def step_class_config(pt, label: str):
    """Phase be's configuration `label` at full width: its preset with the
    data and smc changes, q1, f and g at the widths of STEP_CLASS (their
    other settings the preset's), B = 32, one train step a call, no mesh."""
    _, preset, data_kw, hidden, smc_kw = next(c for c in STEP_CLASS if c[0] == label)
    base = pt.PRESETS[preset]
    cfg = dataclasses.replace(
        base, data=dataclasses.replace(base.data, **data_kw),
        smc=dataclasses.replace(base.smc, **smc_kw),
        train=dataclasses.replace(base.train, steps_per_call=1, batch_size=32),
        mesh=dataclasses.replace(base.mesh, data=1, particle=1))
    return cfg.with_nets(**{n: dataclasses.replace(cfg.net(n), hidden=hidden)
                            for n in ("q1", "f", "g")})


def step_class_shapes(pt) -> list:
    """The shape libraries phase be's configurations launch
    (`fused_step._lib_key`), for `_build.prebuild_shapes`."""
    from psvo_tpu_torch.ops import fused_step

    keys = []
    for label, *_ in STEP_CLASS:
        cfg = step_class_config(pt, label)
        hidden = cfg.net("q1").hidden
        c = fused_step.shape_consts(cfg.data.dx, cfg.data.dy, cfg.data.di, hidden[0],
                                    len(hidden) - 1)
        k = cfg.smc.n_particles
        keys += [k_ for k_ in (fused_step._lib_key(c, False, k), fused_step._lib_key(c, True, k))
                 if k_ is not None]
    return list(dict.fromkeys(keys))


def step_class_counters():
    """(K1, K4, K14, K15, K5, K6 wrappers; every plain version)."""
    from psvo_tpu_torch.ops import ffbsi, fused_step

    return ((fused_step.scan_forward, fused_step.scan_backward, fused_step.step_forward,
             fused_step.step_backward, ffbsi.ffbsi_forward, ffbsi.ffbsi_backward),
            general_counters()[2])


def k1_bound_of(inp, stream: bool):
    """K1's bound on kernel_inputs' operands: the three trunks' FLOP per
    particle-step; x0 and α0 read and x_last and α_last written, coef, the
    weights and sconst read, the stats written, and with `stream` the ε and
    position streams read."""
    t1, b, _ = inp["coef"].shape
    k = inp["x0"].shape[-1]
    n_bytes = (2 * nbytes(inp["x0"], inp["alpha0"])
               + nbytes(inp["coef"], inp["consts"]["packed"], inp["consts"]["sconst"])
               + t1 * b * (2 + inp["x0"].shape[1]) * 4)
    if stream:
        n_bytes += nbytes(inp["eps"], inp["positions"])
    return bound(trunk_flops(inp["consts"]) * t1 * b * k, n_bytes)


def shape_resources(key) -> str:
    """Registers and spill stores of each kernel of a shape library (or of
    the kernels' library: key None) at its shape, from its -Xptxas -v log."""
    from psvo_tpu_torch.ops import _build

    log = _build.build_log(key)
    out = []
    for kern in ("scan_forward_kernel", "step_forward_kernel", "scan_backward_kernel",
                 "step_backward_kernel"):
        for m_ in re.finditer(r"Compiling entry function '(_ZN4psvo\d+" + kern + r"\w*)'.*?Used "
                              r"(\d+) registers", log, re.S):
            spill = re.search(re.escape(m_.group(1)) + r"[^\n]*\n[^\n]*?(\d+) bytes spill "
                              r"stores", log)
            ctrl = " ctrl" if "Lb1E" in m_.group(1) else ""  # K1/K14's control flag
            out.append(f"{kern}{ctrl} {m_.group(2)} regs, "
                       f"{spill.group(1) if spill else '?'} B spilled")
    return "; ".join(out) or "none in this library"


def step_class_phases(pt, dev, card: str) -> dict:
    """Phase (be): the whole-step class beyond the presets' shapes (STEP_CLASS
    at full width): per configuration the kernels against their plain
    versions (K1, and K14 for be-B, teacher-forced within 2e-4; K4, and K15
    for be-B, per leaf within 1e-4 small and 1e-3 full), the card against the
    CPU on the same draws (B = 2, T = 20, CPU_TOL), one serving call and 3
    train steps through the entry points with launch counts and no plain
    version, the kernels' times (pair_ms) against their plain versions' and
    bounds, and the registers of each new instantiation. Returns the figures
    for the kernels' JSON record and PERF.md."""
    import torch
    from psvo_tpu_torch.ops import _build, fused_step

    figures = {}
    kernels, plain = step_class_counters()
    print(f"[be] {card}: {shapes_line(step_class_shapes(pt))}", flush=True)
    for i, (label, preset, _, hidden, _) in enumerate(STEP_CLASS):
        cfg = step_class_config(pt, label)
        sc, n = cfg.smc, cfg.data.t_steps - 1
        psvo = sc.objective == "psvo"
        cpu_ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device="cpu")
        consts = fused_step.shape_consts(cfg.data.dx, cfg.data.dy, cfg.data.di, hidden[0],
                                         len(hidden) - 1)
        keys = (fused_step._lib_key(consts, False, sc.n_particles),
                fused_step._lib_key(consts, True, sc.n_particles))
        if not (fused_step.usable(cpu_ssm, sc) and pt.smc.reference_path(cpu_ssm, sc) == "fused"):
            fail(f"(be) {label}: outside the whole-step class, or not the reference's")
        t0 = time.perf_counter()
        for key in keys:  # built beside phases c-; a build that failed there raises here
            if key is not None:
                _build.load_shape_library(key)
        wait_s = time.perf_counter() - t0
        print(f"[be] {card}: {label} ({preset}, Dx={cfg.data.dx}, Dy={cfg.data.dy}, "
              f"Di={cfg.data.di}, q1/f/g {hidden}, K={sc.n_particles}, B=32, T={n + 1}): plans "
              f"K1/K14 {fused_step.k1_plan(consts)!r}, K4/K15 "
              f"{fused_step.k4_plan(consts, sc.n_particles)!r}; "
              f"libraries {keys[0] or 'the kernels own'} / {keys[1] or 'the kernels own'} "
              f"(waited {wait_s:.1f} s for their builds); "
              + " | ".join(f"{key or 'library'}: {shape_resources(key)}" for key in
                           dict.fromkeys(keys)), flush=True)
        ds = pt.generate_dataset(cfg.data, SEED)
        u_all = ds.controls_train if cfg.data.di else None
        gen = torch.Generator(device=dev).manual_seed(SEED + 170 + i)
        fig = {"keys": keys}
        # kernels against their plain versions, small (B=4, T=10, K=128) and full
        for size in ("small", "full"):
            small = size == "small"
            kcfg = cfg if not small else dataclasses.replace(
                cfg, data=dataclasses.replace(cfg.data, t_steps=10),
                smc=dataclasses.replace(sc, n_particles=128))
            b = 4 if small else 32
            ssm = pt.init_ssm(kcfg, torch.Generator().manual_seed(SEED + 3), device=dev)
            ys = ds.obs_train[:b, :kcfg.data.t_steps].to(dev).contiguous()
            with torch.no_grad():
                r1 = check_scan(label, ssm, kcfg, ys, gen, tol=2e-4)
                r4 = check_backward(ssm, kcfg, ys, gen)
            k4_tol = 1e-4 if small else 1e-3
            print(f"[be] {label} K1 {size}: {scan_line(r1)}; K4 {size}: "
                  + ", ".join(f"{nm} rel L2 {e:.3e} max|d| {m:.3e}" for nm, e, m in
                              zip(("d_x0", "d_coef", "d_weights", "d_sconst"), r4["rel"],
                                  r4["maxd"])), flush=True)
            if not (r1["finite"] and r1["tf_flips"] == 0 and r1["tf_err"] < 2e-4):
                fail(f"(be) {label}: K1 ({size}) disagrees with scan_forward_reference")
            if not (r4["finite"] and r4["monotone"] and max(r4["rel"]) <= k4_tol):
                fail(f"(be) {label}: K4 ({size}) disagrees with scan_backward_reference")
            fig[size] = dict(k1=r1["tf_err"], k4=max(r4["maxd"]))
            if label == "be-B":
                with torch.no_grad():
                    rs = step_chain_check(ssm, kcfg, ys, gen)
                    rb = step_backward_check(rs, gen)
                print(f"[be] {label} K14 {size}: {rs['idx_bad']} ancestors off, rel L2 per "
                      f"output {[f'{v:.1e}' for v in rs['tf_l2']]}, elementwise "
                      f"{[f'{v:.1e}' for v in rs['tf_rel']]}; the chain vs one K1 launch: "
                      f"{rs['k1_idx']} ancestors off, max|d| {rs['vs_k1']}; K15 {size}: rel L2 "
                      f"{[f'{v:.1e}' for v in rb['rel']]} ({rb['zeroed']} of {rb['n']} tied "
                      f"particles zeroed; raw {[f'{v:.1e}' for v in rb['rel_raw']]}), bit-equal "
                      f"on relaunch {rb['same']}, the chain vs one K4 launch "
                      f"{[f'{v:.1e}' for v in rb['vs_k4']]}", flush=True)
                if not (rs["finite"] and rs["idx_bad"] == 0 and max(rs["tf_rel"]) < 2e-4):
                    fail(f"(be) {label}: K14 ({size}) disagrees with step_forward_reference")
                if not (rb["finite"] and rb["same"] and max(rb["rel"]) <= k4_tol):
                    fail(f"(be) {label}: K15 ({size}) disagrees with step_backward_reference")
                fig[size].update(k14=rs["tf_abs"], k15=max(rb["maxd"]))
                if not small:
                    fig["k14_k15"] = (rs, rb)
            if not small:
                fig["k1_check"], fig["k4_check"] = r1, r4
                with torch.no_grad():
                    inp = kernel_inputs(ssm, kcfg, ys, gen)
                fig["inp"] = inp
            del ssm
        # the card against the CPU on the same draws
        fig["vs"] = {}
        for scan_fused in ((True, False) if label == "be-B" else (True,)):
            fused_step.SCAN_FUSED = scan_fused
            try:
                u = u_all[:2, :20] if u_all is not None else None
                vs = card_vs_cpu(pt, dev, cfg, ds.obs_train[:2, :20], u, SEED + 180 + i)
            finally:
                fused_step.SCAN_FUSED = True
            mode = "whole scan" if scan_fused else "SCAN_FUSED off"
            print(f"[be] {card}: {label} ({mode}) the card vs the CPU, one train step at B=2, "
                  f"T=20: {vs_line(vs)}", flush=True)
            if not vs["ok"]:
                fail(f"(be) {label} ({mode}): the card disagrees with the CPU")
            fig["vs"][mode] = vs
        # serving and 3 train steps through the entry points
        ys = ds.obs_train[:32].to(dev).contiguous()
        u = u_all[:32].to(dev).contiguous() if u_all is not None else None
        kw = {} if u is None else {"controls": u}
        for scan_fused in ((True, False) if label == "be-B" else (True,)):
            fused_step.SCAN_FUSED = scan_fused
            mode = "whole scan" if scan_fused else "SCAN_FUSED off"
            try:
                ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
                run_gen = torch.Generator(device=dev).manual_seed(SEED + 190 + i)
                if psvo:
                    serve_name = "smooth_posterior"
                    serve = lambda: pt.smooth_posterior(ssm, ys, cfg, run_gen)  # noqa: E731
                    want_serve = [1, 0, 0, 0, 1, 0]
                else:
                    serve_name = "make_eval_step"
                    eval_step = pt.make_eval_step(ssm, cfg)
                    serve = lambda: eval_step(run_gen, ys, **kw)  # noqa: E731
                    want_serve = [1, 0, 0, 0, 0, 0] if scan_fused else [0, 0, n, 0, 0, 0]
                serve()  # warm-up
                t0 = time.perf_counter()
                out, serve_launches, n_plain = kernel_counts(kernels, plain, serve)
                serve_ms = (time.perf_counter() - t0) * 1e3
                ok = (bool(torch.isfinite(out).all()) if psvo
                      else math.isfinite(float(out["elbo"])))
                print(f"[be] {card}: {label} ({mode}) {serve_name}: launches "
                      f"{dict(zip(STEP_CLASS_KERNELS, serve_launches))}, plain versions "
                      f"{n_plain}, {serve_ms:.1f} ms (host clock, after a warm-up), output "
                      f"finite {ok}", flush=True)
                if serve_launches != want_serve or n_plain or not ok:
                    fail(f"(be) {label} ({mode}) {serve_name}: launched {serve_launches} (want "
                         f"{want_serve}), plain versions {n_plain}, output ok {ok}")
                step = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
                step_s = []

                def run():
                    res = []
                    for _ in range(3):
                        t1 = time.perf_counter()
                        res.append(step(run_gen, ys, **kw))
                        torch.cuda.synchronize()
                        step_s.append(time.perf_counter() - t1)
                    return res

                before = [p_.detach().clone() for p_ in ssm.parameters()]
                (metrics, launches, n_plain), peak = peak_gb(
                    lambda: kernel_counts(kernels, plain, run))
                losses = [float(m_["loss"]) for m_ in metrics]
                moved = sum(not torch.equal(a, p_.detach())
                            for a, p_ in zip(before, ssm.parameters()))
                want = ([3, 3, 0, 0, 3 * psvo, 3 * psvo] if scan_fused
                        else [0, 0, 3 * n, 3 * n, 0, 0])
                print(f"[be] {card}: {label} ({mode}) 3 train steps: loss "
                      f"{[round(v, 3) for v in losses]}, {moved} parameter tensors moved, "
                      f"launches {dict(zip(STEP_CLASS_KERNELS, launches))} (want "
                      f"{dict(zip(STEP_CLASS_KERNELS, want))}), plain versions {n_plain}, step "
                      f"times {[round(1e3 * v, 1) for v in step_s]} ms (host clock, the first "
                      f"with its warm-up), peak {peak:.3f} GB above what was held", flush=True)
                if (launches != want or n_plain or not all(math.isfinite(v) for v in losses)
                        or not moved):
                    fail(f"(be) {label} ({mode}) training launched {launches} (want {want}), "
                         f"plain versions {n_plain}, losses {losses}, moved {moved}")
                fig[mode] = dict(serve=serve_launches, serve_ms=serve_ms,
                                 train=launches, step_ms=[1e3 * v for v in step_s], peak=peak,
                                 losses=losses)
                del ssm, step
            finally:
                fused_step.SCAN_FUSED = True
        # the kernels' times at the full shape against their plain versions and bounds
        inp, r4 = fig.pop("inp"), fig["k4_check"]
        stream = not (sc.kernel_rng and sc.resampling == "systematic")
        noise = (dict(eps=inp["eps"], positions=inp["positions"]) if stream
                 else dict(seed=(11, 0xBE)))
        with torch.no_grad():
            k1 = lambda: fused_step.scan_forward(inp["x0"], inp["alpha0"], inp["coef"],  # noqa
                                                 inp["consts"], **noise)
            k1_plain = lambda: fused_step.scan_forward_reference(  # noqa: E731
                inp["x0"], inp["alpha0"], inp["coef"], inp["consts"], inp["eps"],
                inp["positions"])
            times = dict(k1=(pair_ms(k1), time_ms(k1_plain, reps=1, warmup=1)),
                         k4=(pair_ms(r4["kernel"]), time_ms(r4["plain"], reps=1, warmup=1)))
            bounds = dict(k1=k1_bound_of(inp, stream), k4=bound(r4["flops"], r4["n_bytes"]))
            if "k14_k15" in fig:
                rs, rb = fig.pop("k14_k15")
                fwd_args = (inp["x0"], inp["alpha0"], inp["coef"][0], inp["consts"], inp["eps"][0],
                            inp["positions"][0])
                args, d_xn, d_al, got = rb["last"]
                k14 = lambda: fused_step.step_forward(*fwd_args)  # noqa: E731
                k14_plain = lambda: fused_step.step_forward_reference(*fwd_args)  # noqa: E731
                k15 = lambda: fused_step.step_backward(*args, d_xn, d_al)  # noqa: E731
                k15_plain = lambda: fused_step.step_backward_reference(  # noqa: E731
                    args[0], args[4], args[5], args[6], args[2], args[7], d_xn, d_al)
                times.update(k14=(pair_ms(k14), time_ms(k14_plain, reps=3, warmup=1)),
                             k15=(pair_ms(k15), time_ms(k15_plain, reps=3, warmup=1)))
                b14, b15 = step_bounds(inp["consts"], fwd_args[:3] + fwd_args[4:], k14(),
                                       rb["last"])
                bounds.update(k14=b14, k15=b15)
        fig.pop("k1_check"), fig.pop("k4_check")
        print(f"[be] {card}: {label} kernel times at B=32 ({PAIR_HOW}; the plain versions by "
              f"CUDA events, median of 1-3 after a warm-up): "
              + "; ".join(f"{kk.upper()} {t_[0]:.3f} ms vs plain {t_[1]:.3f} ms, bound "
                          f"{bounds[kk][0]:.4f} ms ({bounds[kk][1]})" for kk, t_ in times.items()),
              flush=True)
        fig.update(times=times, bounds=bounds)
        figures[label] = fig
        torch.cuda.empty_cache()
    phase_done("be: the whole-step class beyond the presets' shapes")
    return figures


REACH_K = (300, 384, 1000, 19456, 24576, 32768)  # phase bf: K7 at K its previous class refused
REACH_GENERAL = (("fhn_fivo_k128", 1000), ("fhn_fivo_tril", 384))  # bf: the plain loop at K
# phase bf: (label, preset, data changes, q1/f/g widths, smc changes, T) of the trunk class
# beyond the kernels' library: Lorenz-96 at D = 20, FHN seen through one channel, and the
# plans whose weights stay in device memory (K10's at D = 55, K9's and K10's at three layers),
# the last two at T = 20 (their check and train step)
REACH_TRUNK = (
    ("D20", L96, {"dx": 20, "dy": 20}, (64, 64), {}, 100),
    ("Dy1", "fhn_fivo_k1024_bench", {"dy": 1}, (64, 64), {"ess_threshold": 0.5}, 100),
    ("D55", L96, {"dx": 55, "dy": 55}, (64, 64), {}, 20),
    ("D40x3", L96, {}, (64, 64, 64), {}, 20),
)
REACH_BIG_K = 32768  # phase bf: the Lorenz-96 preset at K7's and K11's cap


def reach_config(pt, label: str):
    """Phase bf's trunk configuration `label` at full width, one train step a
    call, no mesh, random weights."""
    _, preset, data_kw, hidden, smc_kw, t_steps = next(c for c in REACH_TRUNK if c[0] == label)
    base = pt.PRESETS[preset]
    cfg = dataclasses.replace(
        base, data=dataclasses.replace(base.data, t_steps=t_steps, **data_kw),
        smc=dataclasses.replace(base.smc, **smc_kw),
        train=dataclasses.replace(base.train, steps_per_call=1),
        mesh=dataclasses.replace(base.mesh, data=1, particle=1))
    return cfg.with_nets(**{n: dataclasses.replace(cfg.net(n), hidden=hidden)
                            for n in ("q1", "f", "g")})


def reach_shapes(pt) -> list:
    """The trunk shape libraries phase bf's configurations launch
    (`trunk.lib_key`), for `build_shapes_beside`."""
    from psvo_tpu_torch.ops import trunk

    keys = []
    for label, *_ in REACH_TRUNK:
        cfg = reach_config(pt, label)
        h = cfg.net("q1").hidden
        keys += [trunk.lib_key(cfg.data.dx, cfg.data.dy, h[0], len(h) - 1, bwd)
                 for bwd in (False, True)]
    return list(dict.fromkeys(k_ for k_ in keys if k_ is not None))


def reach_check(ssm, cfg, ys, gen, rng_seed):
    """K9 and K10 against their plain versions on every step of one kernel
    run of the trunk path (K7, K8, K9 on the run's own state, K7 against its
    plain version too): K9 teacher-forced, K10 with random cotangents zeroed
    on `relu_ties`' particles, both on the same x_res and x_new. Returns the
    largest per-step relative L2 and |Δ| of K9's outputs and of K10's leaves,
    whether every K9 step was allclose at 2e-4, the particles zeroed, K7's
    index mismatches, whether K10 gave the same bits on a relaunch of the
    last step, and the last step's operands."""
    import torch
    from psvo_tpu_torch import smc
    from psvo_tpu_torch.ops import fused_step, trunk
    from psvo_tpu_torch.ops import resample_gather as rg

    batch, t_steps, _ = ys.shape
    k, dx, dy, dev = cfg.smc.n_particles, ssm.dx, ssm.dy, ys.device
    ys_tm = ys.transpose(0, 1)
    consts = fused_step.prepare(ssm)
    aq, cq, sq, logsq = fused_step.fusion_coeffs(ssm, cfg.smc, consts, ys_tm)
    x, logw = smc._init_t0(ssm, torch.randn((batch, dx, k), generator=gen, device=dev),
                           ys_tm[0], ys_tm[0])
    ab = logsq[1:] - consts["log_sf_sum"] - consts["log_sg_sum"] - dy * 0.5 * math.log(2 * math.pi)
    coef = fused_step.pack_coef(aq[1:], cq[1:], sq[1:], ys_tm[1:], ab)
    pos = fused_step.systematic_positions(torch.rand((t_steps - 1, batch), generator=gen,
                                                     device=dev), k)
    if rng_seed is not None:
        eps = fused_step.stream_noise(rng_seed, t_steps - 1, batch, dx, k, dev)[0]
    else:
        eps = torch.randn((t_steps - 1, batch, dx, k), generator=gen, device=dev)
    x, logw = x.contiguous(), logw.contiguous()
    rel9, max9, rel10, max10, close_all, zeroed, k7_bad = [], [], [], [], True, 0, 0
    for t in range(t_steps - 1):
        idx = rg.ancestor_indices_large(logw, pos[t].contiguous())
        k7_bad += int((idx != rg.ancestor_indices_large_reference(logw, pos[t])).sum())
        x_res = rg.gather_particles(x, idx)
        noise = {"seed": rng_seed, "t": t} if rng_seed is not None else {"eps": eps[t]}
        got = trunk.trunk_forward(x_res, coef[t], consts, **noise)
        want = trunk.trunk_forward_reference(x_res, coef[t], consts, eps[t])
        rel9.append(torch.stack([(g - w).norm() / w.norm().clamp_min(1e-30)
                                 for g, w in zip(got, want)]))
        max9.append(torch.stack([(g - w).abs().max() for g, w in zip(got, want)]))
        close_all &= close(got, want, 2e-4)
        x_new, alpha = got
        keep = ~relu_ties(consts, x_res, x_new)
        zeroed += int((~keep).sum())
        bwd = (x_res, x_new, coef[t], consts,
               torch.randn(x_new.shape, generator=gen, device=dev) * keep[:, None],
               torch.randn(alpha.shape, generator=gen, device=dev) * keep)
        got10 = trunk.trunk_backward(*bwd, **noise)
        want10 = trunk.trunk_backward_reference(*bwd[:4], eps[t], *bwd[4:])
        rel10.append(torch.stack([(g - w).norm() / w.norm().clamp_min(1e-30)
                                  for g, w in zip(got10, want10)]))
        max10.append(torch.stack([(g - w).abs().max() for g, w in zip(got10, want10)]))
        x, logw = x_new, alpha
    same = all(torch.equal(a, b) for a, b in zip(got10, trunk.trunk_backward(*bwd, **noise)))
    return dict(rel9=torch.stack(rel9).amax(0).tolist(), max9=torch.stack(max9).amax(0).tolist(),
                rel10=torch.stack(rel10).amax(0).tolist(),
                max10=torch.stack(max10).amax(0).tolist(), close=close_all, zeroed=zeroed,
                n=(t_steps - 1) * batch * k, k7_bad=k7_bad, same=same,
                finite=bool(torch.isfinite(x).all()) and all(bool(torch.isfinite(g).all())
                                                             for g in got10),
                last=(bwd, noise, eps[-1], got10))


def reach_drive(pt, dev, card, label, cfg, ys, load, want_serve, want_train, n_train,
                profile: bool = False) -> dict:
    """Serve (make_eval_step, filter_posterior) and train (n_train steps of
    make_train_step) cfg on the card through the entry points, with launch
    counts against ROUTE_NAMES' wants and no plain version; host-clock times,
    peak memory and, with `profile`, a device profile of one more step."""
    import torch

    kernels, plain = route_counters()
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    if load is not None:
        load(ssm)
    gen = torch.Generator(device=dev).manual_seed(SEED + 190)
    eval_step = pt.make_eval_step(ssm, cfg)
    t0 = time.perf_counter()
    (ev, ev_l, ev_p), ev_peak = peak_gb(lambda: kernel_counts(kernels, plain,
                                                              lambda: eval_step(gen, ys)))
    ev_ms = (time.perf_counter() - t0) * 1e3
    means, fp_l, fp_p = kernel_counts(kernels, plain,
                                      lambda: pt.filter_posterior(ssm, ys, cfg, gen))
    elbo = float(ev["elbo"])
    ok = math.isfinite(elbo) and tuple(means.shape) == (ys.shape[0], ys.shape[1], cfg.data.dx) \
        and bool(torch.isfinite(means).all())
    print(f"[bf] {card}: {label} served: ELBO {elbo:.3f}, launches "
          f"{dict(zip(ROUTE_NAMES, ev_l))} (eval) / {dict(zip(ROUTE_NAMES, fp_l))} "
          f"(filter_posterior), plain versions {ev_p + fp_p}, eval {ev_ms:.1f} ms (host clock, "
          f"the first call), peak {ev_peak:.3f} GB above what was held; filtered means ok {ok}",
          flush=True)
    if not ok or ev_l != want_serve or fp_l != want_serve or ev_p or fp_p:
        fail(f"(bf) {label} serving: launches {ev_l} / {fp_l} (want {want_serve}), plain "
             f"versions {ev_p + fp_p}, outputs ok {ok}")
    step = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
    step_ms = []

    def run():
        out = []
        for _ in range(n_train):
            t1 = time.perf_counter()
            out.append(step(gen, ys))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
        return out

    before = [p.detach().clone() for p in ssm.parameters()]
    (metrics, tr_l, tr_p), peak = peak_gb(lambda: kernel_counts(kernels, plain, run))
    losses = [float(m_["loss"]) for m_ in metrics]
    norms = [float(m_["grad_norm"]) for m_ in metrics]
    moved = sum(not torch.equal(a, p.detach()) for a, p in zip(before, ssm.parameters()))
    prof = (device_breakdown(lambda: step(gen, ys), 1, ROUTE_KERNELS)
            if profile else "not taken")
    print(f"[bf] {card}: {label} {n_train} train steps at B={ys.shape[0]}: loss "
          f"{[round(v, 3) for v in losses]}, grad norm {[round(v, 3) for v in norms]}, {moved} of "
          f"{len(before)} parameter tensors moved, launches {dict(zip(ROUTE_NAMES, tr_l))} (want "
          f"{dict(zip(ROUTE_NAMES, want_train))}), plain versions {tr_p}, step times "
          f"{[round(v, 1) for v in step_ms]} ms (host clock, the first with its warm-up), peak "
          f"{peak:.3f} GB above what was held; profile of one more step: {prof}", flush=True)
    if (tr_l != want_train or tr_p or not moved
            or not all(math.isfinite(v) for v in losses + norms)):
        fail(f"(bf) {label} training: launches {tr_l} (want {want_train}), plain versions {tr_p}, "
             f"losses {losses}, grad norms {norms}, moved {moved}")
    return dict(serve=ev_l, train=tr_l, step_ms=step_ms, peak=peak, eval_peak=ev_peak,
                profile=prof, losses=losses)


def reach_phases(pt, dev, card: str) -> dict:
    """Phase (bf): resampling on the card at every K, and the trunk class
    beyond the kernels' library. K7 on adversarial rows at K its previous
    class refused (index-equal to its plain version, timed beside it) and
    K11 at K = 32768 (within 1e-6 of float64); the plain loop at K = 1000
    (fhn_fivo_k128) and K = 384 (fhn_fivo_tril), served and trained; K9 and
    K10 at REACH_TRUNK's shapes against their plain versions (K9 within 2e-4
    teacher-forced, K10 per leaf within 1e-4 small and 1e-3 full, relu ties
    zeroed, bit-equal on a relaunch), the card against the CPU on the same
    draws, served and trained; the Lorenz-96 preset at K = 32768, served and
    trained from the snapshot. Returns the figures for the kernels' JSON
    record and PERF.md."""
    import torch
    from psvo_tpu_torch.ops import _build, fused_step, resampling, trunk
    from psvo_tpu_torch.ops import resample_gather as rg

    figures = {"k7": {}, "trunk": {}}
    keys = reach_shapes(pt)
    print(f"[bf] {card}: {shapes_line(keys)}", flush=True)
    g = torch.Generator(device=dev).manual_seed(SEED + 180)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # K7 at every K of REACH_K: the adversarial rows, systematic and sorted multinomial positions
    for k in REACH_K:
        lw = weight_rows(k, g)
        b = lw.shape[0]
        sys_pos = fused_step.systematic_positions(torch.rand((b,), generator=g, device=dev),
                                                  k).contiguous()
        mult = torch.sort(torch.rand((b, k), generator=g, device=dev), -1).values.contiguous()
        bad = sum(int((rg.ancestor_indices_large(lw, p_)
                       != rg.ancestor_indices_large_reference(lw, p_)).sum())
                  for p_ in (sys_pos, mult))
        c = rg.k7_cluster(b, k, n_sms)
        t_ = [pair_ms(lambda: rg.ancestor_indices_large(lw, sys_pos)),
              pair_ms(lambda: rg.ancestor_indices_large_reference(lw, sys_pos))]
        bd = bound(2.0 * lw.numel() * (1 + math.log2(k)), nbytes(lw, sys_pos) + lw.numel() * 4)
        figures["k7"][k] = dict(ms=t_[0], plain=t_[1], bound=bd, cluster=c,
                                spread=rg.k7_spread(k, c), mismatches=bad)
        print(f"[bf] {card}: K7 at B={b}, K={k} (C={c}, "
              f"{'spread' if rg.k7_spread(k, c) else 'whole'} CDF): {bad} index mismatches "
              f"against its plain version on the adversarial rows (systematic and multinomial); "
              f"{t_[0]:.4f} ms, plain {t_[1]:.4f} ms ({PAIR_HOW}); bound {bd[0]:.6f} ms ({bd[1]})",
              flush=True)
        if bad:
            fail(f"(bf) K7 at K={k} disagrees with its plain version ({bad} indices)")
    # K11 at its cap: B = 8, D = 40, on the adversarial rows' ancestors
    k = rg.MAX_K
    lw = weight_rows(k, g)
    pos = fused_step.systematic_positions(torch.rand((8,), generator=g, device=dev),
                                          k).contiguous()
    idx = rg.ancestor_indices_large(lw, pos)
    cot = torch.randn((8, 40, k), generator=g, device=dev)
    got = rg.segment_sum_scatter(cot, idx)
    want = rg.segment_sum_scatter_reference(cot.double(), idx)
    rel11 = float((got.double() - want).norm() / want.norm())
    max11 = float((got.double() - want).abs().max())
    same11 = bool(torch.equal(got, rg.segment_sum_scatter(cot, idx)))
    idx64 = idx.long()[:, None, :].expand(-1, 40, -1)
    t11 = [pair_ms(lambda: rg.segment_sum_scatter(cot, idx)),
           pair_ms(lambda: rg.segment_sum_scatter_reference(cot, idx)),
           pair_ms(lambda: torch.zeros_like(cot).scatter_add_(-1, idx64, cot))]
    b11 = bound(cot.numel(), 2 * nbytes(cot) + nbytes(idx))
    print(f"[bf] {card}: K11 at B=8, D=40, K={k} (P, C = {rg.k11_plan(k)}): rel L2 {rel11:.3e}, "
          f"max |d| {max11:.3e} against float64, bit-equal on a relaunch {same11}; {t11[0]:.4f} "
          f"ms, plain {t11[1]:.4f} ms, zeros + scatter_add_ {t11[2]:.4f} ms ({PAIR_HOW}); bound "
          f"{b11[0]:.6f} ms ({b11[1]})", flush=True)
    if rel11 > 1e-6 or not same11 or not bool((got[want == 0] == 0).all()):
        fail(f"(bf) K11 at K={k}: rel L2 {rel11} (at most 1e-6), relaunch bit-equal {same11}")
    figures["k11"] = dict(ms=t11[0], plain=t11[1], library=t11[2], bound=b11, err=max11)
    del lw, pos, idx, cot, got, want, idx64
    torch.cuda.empty_cache()
    phase_done("bf-1: K7 at every K, K11 at its cap")

    # the plain loop where K7's previous class raised: fhn_fivo_k128 at K = 1000, fhn_fivo_tril
    # at K = 384 (the reference's fused resample kernel there)
    figures["general"] = {}
    for preset, k in REACH_GENERAL:
        cfg = route_config(pt, preset, {"n_particles": k})
        ssm_cpu = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device="cpu")
        route = pt.smc.filter_route(ssm_cpu, cfg.smc, cfg.data.t_steps, True)
        n = cfg.data.t_steps - 1
        b = cfg.train.batch_size
        ds = pt.generate_dataset(cfg.data, SEED)
        vs = card_vs_cpu(pt, dev, cfg, ds.obs_train[:4, :20], None, SEED + 181, path="general")
        print(f"[bf] {card}: {preset} at K={k} (B={b}, T={n + 1}): route {route!r} (the "
              f"reference's {pt.smc.reference_path(ssm_cpu, cfg.smc)!r}); the card vs the CPU, one "
              f"train step at B=4, T=20: {vs_line(vs)}", flush=True)
        if route != "plain" or not vs["ok"]:
            fail(f"(bf) {preset} at K={k}: route {route}, or the card disagrees with the CPU")
        ys = ds.obs_train[:b].to(dev).contiguous()
        r = reach_drive(pt, dev, card, f"{preset} K={k}", cfg, ys, None,
                        route_want({"K7": n, "K8": n}),
                        route_want({"K7": 3 * n, "K8": 3 * n, "K11": 3 * n}), 3)
        r["vs"] = vs
        figures["general"][preset] = r
        torch.cuda.empty_cache()
    phase_done("bf-2: the plain loop at K = 1000 and 384")

    # the trunk class beyond the kernels' library
    t0 = time.perf_counter()
    for key in keys:  # built beside phases c-; a build that failed there raises here
        _build.load_shape_library(key)
    wait_s = time.perf_counter() - t0
    for i, (label, preset, _, hidden, _, t_steps) in enumerate(REACH_TRUNK):
        cfg = reach_config(pt, label)
        sc, dx, dy = cfg.smc, cfg.data.dx, cfg.data.dy
        h, n_mid = hidden[0], len(hidden) - 1
        n = t_steps - 1
        cpu_ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device="cpu")
        if not (trunk.usable(cpu_ssm, sc) and pt.smc.reference_path(cpu_ssm, sc) == "trunk"):
            fail(f"(bf) {label}: outside the trunk class, or not the reference's trunk path")
        plans = dict(k9=trunk.k9_weights(dx, dy, h, n_mid), k9_parts=trunk.k9_plan(dx, dy, h, n_mid),
                     k10=trunk.k10_weights(dx, dy, h, n_mid),
                     k10_design=trunk.k10_design(dx, dy, h, n_mid),
                     key=trunk.lib_key(dx, dy, h, n_mid, True))
        log = _build.build_log(plans["key"])
        regs = re.findall(r"Compiling entry function '_ZN4psvo\d+(trunk_\w+?kernel)\w*'.*?Used "
                          r"(\d+) registers", log, re.S)
        print(f"[bf] {card}: {label} ({preset}, Dx={dx}, Dy={dy}, q1/f/g {hidden}, "
              f"K={sc.n_particles}, B={cfg.train.batch_size}, T={t_steps}, kernel_rng "
              f"{sc.kernel_rng}): K9 weights in {plans['k9']} (pair, prefetch "
              f"{plans['k9_parts']}), K10 {plans['k10_design']} with weights in {plans['k10']}; "
              f"library {plans['key']} (waited {wait_s:.1f} s for the builds); registers "
              + ", ".join(f"{nm} {r_}" for nm, r_ in regs), flush=True)
        ds = pt.generate_dataset(cfg.data, SEED)
        gen = torch.Generator(device=dev).manual_seed(SEED + 182 + i)
        fig = dict(plans=plans)
        for size in ("small", "full"):
            small = size == "small"
            kcfg = cfg if not small else dataclasses.replace(
                cfg, data=dataclasses.replace(cfg.data, t_steps=10),
                smc=dataclasses.replace(sc, n_particles=128))
            b = 4 if small else cfg.train.batch_size
            ssm = pt.init_ssm(kcfg, torch.Generator().manual_seed(SEED + 3), device=dev)
            ys = ds.obs_train[:b, :kcfg.data.t_steps].to(dev).contiguous()
            modes = (("stream", None),) if small else (("in-kernel RNG", (9, 0xBEEF)),)
            for mode, seed in modes:
                with torch.no_grad():
                    r = reach_check(ssm, kcfg, ys, gen, seed)
                tol10 = 1e-4 if small else 1e-3
                print(f"[bf] {label} {size} ({mode}, B={b}, K={kcfg.smc.n_particles}, "
                      f"T={kcfg.data.t_steps}): K9 teacher-forced x_new/α rel L2 "
                      f"{r['rel9'][0]:.3e}/{r['rel9'][1]:.3e}, max |d| {max(r['max9']):.3e}, every "
                      f"step allclose 2e-4 {r['close']}; K10 "
                      + ", ".join(f"{nm} rel L2 {e:.3e}" for nm, e in
                                  zip(("d_x_res", "d_coef", "d_weights", "d_sconst"), r["rel10"]))
                      + f" (bound {tol10:g}; {r['zeroed']} of {r['n']} particles' cotangents "
                      f"zeroed at relu ties), bit-equal on a relaunch {r['same']}; K7 mismatches "
                      f"{r['k7_bad']}", flush=True)
                if not (r["close"] and max(r["rel10"]) <= tol10 and r["same"] and r["finite"]
                        and r["k7_bad"] == 0):
                    fail(f"(bf) {label} {size}: K9/K10 disagree with their plain versions")
                fig[size] = dict(err9=max(r["max9"]), err10=max(r["max10"]), rel10=r["rel10"])
            if not small:  # times on the last step's operands
                bwd, noise, eps_t, got10 = r["last"]
                x_res, x_new, coef_t, consts = bwd[:4]
                with torch.no_grad():
                    t9 = [pair_ms(lambda: trunk.trunk_forward(x_res, coef_t, consts, **noise)),
                          time_ms(lambda: trunk.trunk_forward_reference(x_res, coef_t, consts,
                                                                        eps_t), 3, 1)]
                    t10 = [pair_ms(lambda: trunk.trunk_backward(*bwd, **noise)),
                           time_ms(lambda: trunk.trunk_backward_reference(*bwd[:4], eps_t,
                                                                          *bwd[4:]), 3, 1)]
                n_part = x_res.shape[0] * x_res.shape[-1]
                b9 = bound(trunk_flops(consts) * n_part,
                           2 * nbytes(x_res) + nbytes(coef_t, consts["packed"], consts["sconst"])
                           + 4 * n_part)
                b10 = bound(3 * trunk_flops(consts) * n_part,
                            nbytes(x_res, x_new, consts["packed"], consts["sconst"], bwd[4],
                                   bwd[5], *got10))
                print(f"[bf] {card}: {label} K9 {t9[0]:.4f} ms ({PAIR_HOW}), plain {t9[1]:.4f} ms "
                      f"(CUDA events, median of 3); bound {b9[0]:.4f} ms ({b9[1]}); K10 "
                      f"{t10[0]:.4f} ms, plain {t10[1]:.4f} ms; bound {b10[0]:.4f} ms ({b10[1]})",
                      flush=True)
                fig.update(t9=t9, t10=t10, b9=b9, b10=b10)
                del r, bwd, noise, got10
        # the card against the CPU on the same draws (B = 2, T = 20 or the configuration's)
        t_vs = min(20, t_steps)
        vs = card_vs_cpu(pt, dev, cfg, ds.obs_train[:2, :t_vs], None, SEED + 186 + i,
                         path="trunk")
        print(f"[bf] {card}: {label} the card vs the CPU, one train step at B=2, T={t_vs}: "
              f"{vs_line(vs)}", flush=True)
        if not vs["ok"]:
            fail(f"(bf) {label}: the card disagrees with the CPU")
        b = cfg.train.batch_size
        ys = ds.obs_train[:b].to(dev).contiguous()
        n_train = 3 if t_steps == 100 else 1
        r = reach_drive(pt, dev, card, label, cfg, ys, None,
                        route_want({"K7": n, "K8": n, "K9": n}),
                        route_want({k_: n_train * n for k_ in ("K7", "K8", "K9", "K10", "K11")}),
                        n_train, profile=label == "D20")
        fig.update(drive=r, vs=vs)
        figures["trunk"][label] = fig
        torch.cuda.empty_cache()
        phase_done(f"bf-3: {label}")

    # the Lorenz-96 preset at K = 32768 from the snapshot: serving and 2 train steps
    cfg = route_config(pt, L96, {"n_particles": REACH_BIG_K})
    snap = os.path.join(ROOT, "checkpoints", "l96_pretrained.npz")
    ds = pt.generate_dataset(cfg.data, SEED)
    b, n = cfg.train.batch_size, cfg.data.t_steps - 1
    ys = ds.obs_train[:b].to(dev).contiguous()
    r = reach_drive(pt, dev, card, f"{L96} K={REACH_BIG_K}", cfg, ys,
                    lambda s_: pt.load_params_npz(s_, snap),
                    route_want({"K7": n, "K8": n, "K9": n}),
                    route_want({k_: 2 * n for k_ in ("K7", "K8", "K9", "K10", "K11")}), 2)
    figures["big_k"] = r
    torch.cuda.empty_cache()
    phase_done(f"bf-4: {L96} at K = {REACH_BIG_K}")
    return figures


def reach_rows(figs: dict) -> list:
    """Phase bf's rows of the kernels' JSON record."""
    # K7 at every K of REACH_K ("by_k"; "ms", "plain_ms" and the bound at K = 32768)
    # with the K7 launches of bf's train steps (the plain loop at K = 1000 and 384, the trunk
    # configurations, the preset at K = 32768); K11 at K = 32768 with the preset's train
    # launches there; K9 and K10 at REACH_TRUNK's shapes with their train launches
    rows = []
    bf_runs = ([r_ for r_ in figs["general"].values()] + [f_["drive"] for f_ in figs["trunk"].values()]
               + [figs["big_k"]])
    top = figs["k7"][max(REACH_K)]
    rows.append({
        "name": "ancestor_indices_large (any K)", "route": "cuda",
        "source": "psvo_tpu_torch/csrc/resample_gather.cu",
        "replaces": "psvo_tpu/ops/pallas_resample.py:338",
        "launches": sum(r_["train"][ROUTE_NAMES.index("K7")] for r_ in bf_runs), "on_path": True,
        "max_abs_err": float(max(v["mismatches"] for v in figs["k7"].values())), "ms": top["ms"],
        "plain_ms": top["plain"], "bound_ms": top["bound"][0], "bound_by": top["bound"][1],
        "library_ms": None,
        "by_k": {str(k_): {"ms": v["ms"], "plain_ms": v["plain"], "bound_ms": v["bound"][0],
                           "cluster": v["cluster"], "spread": v["spread"]}
                 for k_, v in figs["k7"].items()},
        "launches_by_run": {lbl: r_["train"][ROUTE_NAMES.index("K7")] for lbl, r_ in
                            zip([*figs["general"], *figs["trunk"], f"K={REACH_BIG_K}"], bf_runs)}})
    rows.append({
        "name": f"segment_sum_scatter (K={REACH_BIG_K})", "route": "cuda",
        "source": "psvo_tpu_torch/csrc/resample_gather.cu",
        "replaces": "psvo_tpu/ops/pallas_resample.py:902",
        "launches": figs["big_k"]["train"][ROUTE_NAMES.index("K11")], "on_path": True,
        "max_abs_err": figs["k11"]["err"], "ms": figs["k11"]["ms"], "plain_ms": figs["k11"]["plain"],
        "bound_ms": figs["k11"]["bound"][0], "bound_by": figs["k11"]["bound"][1],
        "library_ms": figs["k11"]["library"]})
    for label, f_ in figs["trunk"].items():
        for i, (kernel, src, line, kk) in enumerate((
                ("trunk_forward", "trunk_forward.cuh", "350", "9"),
                ("trunk_backward", "trunk_backward.cuh", "419", "10"))):
            rows.append({
                "name": f"{kernel} ({label})", "route": "cuda",
                "source": f"psvo_tpu_torch/csrc/{src}", "replaces": f"psvo_tpu/ops/pallas_trunk.py:{line}",
                "launches": f_["drive"]["train"][ROUTE_NAMES.index(f"K{kk}")], "on_path": True,
                "max_abs_err": max(f_["small"][f"err{kk}"], f_["full"][f"err{kk}"]),
                "ms": f_[f"t{kk}"][0], "plain_ms": f_[f"t{kk}"][1],
                "bound_ms": f_[f"b{kk}"][0], "bound_by": f_[f"b{kk}"][1], "library_ms": None,
                "weights": f_["plans"]["k9" if kk == "9" else "k10"],
                "shape_library": list(f_["plans"]["key"])})
    return rows


# ---------------------------------------------------------------------------
# phase bg: the smoothing sweeps at the reference's reach (K5/K6's wide
# kernels at any Dx and M, K12/K13 over the reference's SVO class)
# ---------------------------------------------------------------------------

# (Dx, K, M, B, T-1) of K5/K6 against their plain versions: the first the small shape (gates
# 1e-4), Lorenz-96's main path (B = 8, T = 100) second, then Dx = 55, M past the staged K6's
# 256 paths, and the class's corner tested for (M = 4096 at K = 2048)
BG_FFBSI = ((4, 128, 8, 8, 5), (40, 1024, 16, 8, 99), (4, 1024, 16, 8, 20), (55, 2048, 16, 8, 20),
            (3, 1024, 512, 8, 20), (4, 2048, 4096, 8, 3))
# (Dx, Dy, Di, width) of K12/K13 against their plain versions beyond the kernels' library (M =
# 32; B = 8, T - 1 = 20 the small check, B = 32, T - 1 = 99 the full one); BG_BIG_M paths at the
# first
BG_SVO = ((3, 1, 0, 48), (4, 3, 0, 24), (6, 1, 1, 8))
BG_BIG_M = 4096  # ops/svo.py MAX_M
BG_TRAIN = 3  # phase bg (b), (c): train steps
# the gates, set before the phase's first run (PERF.md section 2)
BG_TOL = {"k5_rel": 1e-6, "k6_small": 1e-4, "k6_full": 1e-3, "k12": 2e-4, "k13_small": 1e-4,
          "k13_full": 1e-3}
BG_KERNELS = {"K5": ("ffbsi_wide_kernel",), "K6": ("ffbsi_bwd_wide_kernel",),
              "K7": ("ancestor_indices",), "K8": ("gather_particles_kernel",),
              "K9": ("trunk_forward",), "K10": ("trunk_backward", "trunk_sum"),
              "K11": ("segment_sum",)}
BG_SVO_KERNELS = {"K1": ("scan_forward_kernel",), "K4": ("scan_backward_kernel", "sum_rows_kernel"),
                  "K12": ("svo_forward_split_kernel",),
                  "K13": ("svo_backward_split_kernel", "svo_sum_ctas_kernel")}
# Digests of the preset shapes' K5/K6/K12/K13 outputs (`preset_bits`) from the build of commit
# f2de621 (preset_bits on that commit's package, its ffbsi.cu and svo_sweep*.cu built alone),
# and of their K1/K4/K14/K15 outputs (`step_preset_bits`) from the build of commit 236b45c
# (this file's preset_bits on that commit's package and its whole library, which gave the
# K5-K13 digests above too), on an NVIDIA H100 80GB HBM3 at 700.00 W (132 SMs: K13's CTA rows,
# and so its sums' order, follow the card's SM count, and K4's and K15's cluster and slice
# counts the card's occupancy); phase bg (d) holds this build to them on such a card
PARENT_BITS_CARD = ("NVIDIA H100 80GB HBM3", 132)
PARENT_BITS = {
    "K12 (2, 2) h16 di0 0": "42dc84a6763354d3", "K12 (2, 2) h16 di0 1": "8bf9445fa53cd1e1",
    "K12 (2, 2) h16 di0 2": "46cb39a791876b16", "K12 (2, 2) h16 di0 3": "9ef477dcf1aab966",
    "K12 (2, 2) h16 di2 0": "d16c1dc9bd17ed95", "K12 (2, 2) h16 di2 1": "d2952db12dc84126",
    "K12 (2, 2) h16 di2 2": "e69bd7997b50f8b0", "K12 (2, 2) h16 di2 3": "b29ae9a80693af71",
    "K12 (2, 2) h32 di0 0": "d97fdbb533edbe84", "K12 (2, 2) h32 di0 1": "2de64b7fc7b11971",
    "K12 (2, 2) h32 di0 2": "62d52d82160ac869", "K12 (2, 2) h32 di0 3": "1261f994c43c5dbe",
    "K12 (2, 2) h32 di2 0": "16bcf9a4acf6e6eb", "K12 (2, 2) h32 di2 1": "8a266bd7f0d64a55",
    "K12 (2, 2) h32 di2 2": "33c1ad4e3af19e0e", "K12 (2, 2) h32 di2 3": "590b43a905a7fed8",
    "K12 (2, 2) h64 di0 0": "0c707c1d374b3d65", "K12 (2, 2) h64 di0 1": "138e9ae096421bb1",
    "K12 (2, 2) h64 di0 2": "f833f9ffab79a694", "K12 (2, 2) h64 di0 3": "0b329f2124398ddf",
    "K12 (2, 2) h64 di2 0": "cf60533060421cd6", "K12 (2, 2) h64 di2 1": "47cd82b00556071d",
    "K12 (2, 2) h64 di2 2": "22904dda8958b243", "K12 (2, 2) h64 di2 3": "ad91f1dc6baf8bbb",
    "K12 (3, 3) h16 di0 0": "95c4a6000704c162", "K12 (3, 3) h16 di0 1": "52dcd4421c3d8dd5",
    "K12 (3, 3) h16 di0 2": "07ab9c321e27110a", "K12 (3, 3) h16 di0 3": "ee302d977993b592",
    "K12 (3, 3) h16 di2 0": "2e22bf698a9350eb", "K12 (3, 3) h16 di2 1": "0f1d73f6730de411",
    "K12 (3, 3) h16 di2 2": "9e27fe0095c9ad04", "K12 (3, 3) h16 di2 3": "a8d6881fa2442e57",
    "K12 (3, 3) h32 di0 0": "f2485f8134f939f3", "K12 (3, 3) h32 di0 1": "e67f8c68d1d4ba84",
    "K12 (3, 3) h32 di0 2": "db5392bcc2a5b41e", "K12 (3, 3) h32 di0 3": "02ef0911c9efe1d0",
    "K12 (3, 3) h32 di2 0": "b41b9d4ac90ae654", "K12 (3, 3) h32 di2 1": "010347e0f8ed9223",
    "K12 (3, 3) h32 di2 2": "9bb142fabaa8823d", "K12 (3, 3) h32 di2 3": "9db301a59d9b0018",
    "K12 (3, 3) h64 di0 0": "9dd3abaa45eb501e", "K12 (3, 3) h64 di0 1": "3c572195dfae4c86",
    "K12 (3, 3) h64 di0 2": "fab13c928116f218", "K12 (3, 3) h64 di0 3": "dea361be9bb27f46",
    "K12 (3, 3) h64 di2 0": "b003192a9c8a3ed9", "K12 (3, 3) h64 di2 1": "565edc1ff5503526",
    "K12 (3, 3) h64 di2 2": "e97a362048cb1bf2", "K12 (3, 3) h64 di2 3": "0277be3a5c558529",
    "K13 (2, 2) h16 di0 0": "b94589c153d2874d", "K13 (2, 2) h16 di0 1": "b31aaa2d517feeba",
    "K13 (2, 2) h16 di0 2": "330f80ab7e2f22f3", "K13 (2, 2) h16 di2 0": "9edd2b3b0bb771ea",
    "K13 (2, 2) h16 di2 1": "f529ee595d55c6c3", "K13 (2, 2) h16 di2 2": "1fa975ade3ce51c5",
    "K13 (2, 2) h16 di2 3": "7f97619c87c327bf", "K13 (2, 2) h32 di0 0": "f8c6fccf04162a44",
    "K13 (2, 2) h32 di0 1": "93416e250c1067f2", "K13 (2, 2) h32 di0 2": "aa16b756a1eb6d26",
    "K13 (2, 2) h32 di2 0": "5fee3be366b775e5", "K13 (2, 2) h32 di2 1": "51be0326aff36909",
    "K13 (2, 2) h32 di2 2": "5880bf7576ae230b", "K13 (2, 2) h32 di2 3": "e7fa55700379bd81",
    "K13 (2, 2) h64 di0 0": "29f39704ecabe472", "K13 (2, 2) h64 di0 1": "8e767a5846abe3a1",
    "K13 (2, 2) h64 di0 2": "ebc286f71d309041", "K13 (2, 2) h64 di2 0": "bf3492145d92f4fa",
    "K13 (2, 2) h64 di2 1": "69150f4e3abda490", "K13 (2, 2) h64 di2 2": "876d4fdd86b7340f",
    "K13 (2, 2) h64 di2 3": "b1fb3b32b76b3d9a", "K13 (3, 3) h16 di0 0": "cacdb8ce356272ea",
    "K13 (3, 3) h16 di0 1": "5f6bf25f99de9505", "K13 (3, 3) h16 di0 2": "52b91b8c23d50825",
    "K13 (3, 3) h16 di2 0": "d8b849ede60d3a07", "K13 (3, 3) h16 di2 1": "5b41a9423499b306",
    "K13 (3, 3) h16 di2 2": "5ed3dde1ede816ca", "K13 (3, 3) h16 di2 3": "b1d257a6f182bed2",
    "K13 (3, 3) h32 di0 0": "0a891418e2bf6ac4", "K13 (3, 3) h32 di0 1": "e28f2b6c5ffe11af",
    "K13 (3, 3) h32 di0 2": "f2593fe684e3a878", "K13 (3, 3) h32 di2 0": "e7a7d9a4ee9e0992",
    "K13 (3, 3) h32 di2 1": "c26af089681494c8", "K13 (3, 3) h32 di2 2": "b33424affce3d8ee",
    "K13 (3, 3) h32 di2 3": "490f31bc6ea65702", "K13 (3, 3) h64 di0 0": "e1ebf21bc8c3febc",
    "K13 (3, 3) h64 di0 1": "af4aa287ffca6a36", "K13 (3, 3) h64 di0 2": "646f4897d1246c02",
    "K13 (3, 3) h64 di2 0": "1962f32c5433adf0", "K13 (3, 3) h64 di2 1": "357243a8d9b87905",
    "K13 (3, 3) h64 di2 2": "0e46a7d4b6d94188", "K13 (3, 3) h64 di2 3": "d76d40cdbc57ca89",
    "K5 dx2 out0": "8e64b1e7da0478c9", "K5 dx2 out1": "fbdf15442b6824f2",
    "K5 dx2 out2": "2287f175d33840e7", "K5 dx2 out3": "b1e017a0ed80cd69",
    "K5 dx2 out4": "fea0dd7aae99fedf", "K5 dx3 out0": "468ed71fb3bb0d9a",
    "K5 dx3 out1": "538c7d3806a04ca0", "K5 dx3 out2": "3db6829ff3f5c879",
    "K5 dx3 out3": "283bd321c11a14c3", "K5 dx3 out4": "2e8a25553596e515",
    "K6 dx2 all cotangents 0": "cbf2e646816b56e5", "K6 dx2 all cotangents 1": "ea33dd58ed48c0dd",
    "K6 dx2 all cotangents 2": "d05803de61f2d4f6", "K6 dx2 all cotangents 3": "9fb927ff41668043",
    "K6 dx2 all cotangents 4": "cc41ea84df0f0230", "K6 dx2 all cotangents 5": "bd3b622128c95d33",
    "K6 dx2 all cotangents 6": "4b30789510efe12f", "K6 dx2 direct bound 0": "14a6b16bf3a414a8",
    "K6 dx2 direct bound 1": "cbbeb9933a39be1d", "K6 dx2 direct bound 2": "8f821c04d53e3297",
    "K6 dx2 direct bound 3": "64cf114cfb644c24", "K6 dx2 direct bound 4": "bd3b622128c95d33",
    "K6 dx2 direct bound 5": "bd3b622128c95d33", "K6 dx2 paths only 0": "ad7facb2586fc6e9",
    "K6 dx2 paths only 1": "9adcd904547487c0", "K6 dx3 all cotangents 0": "8f643fdf000f700f",
    "K6 dx3 all cotangents 1": "0fddf331b7182f20", "K6 dx3 all cotangents 2": "8b1255d1cbf4f8bc",
    "K6 dx3 all cotangents 3": "41904526dd3ba62b", "K6 dx3 all cotangents 4": "2eb4906b198caa77",
    "K6 dx3 all cotangents 5": "d5c23c883e967d6a", "K6 dx3 all cotangents 6": "0d04684569fb8b89",
    "K6 dx3 direct bound 0": "e6f85c98a740b74c", "K6 dx3 direct bound 1": "c69645d2e1f724d6",
    "K6 dx3 direct bound 2": "af111807e35e912a", "K6 dx3 direct bound 3": "3e44a06e57a4f6d8",
    "K6 dx3 direct bound 4": "d5c23c883e967d6a", "K6 dx3 direct bound 5": "d5c23c883e967d6a",
    "K6 dx3 paths only 0": "fd9243e1ba57263e", "K6 dx3 paths only 1": "06cadec425ab9b1b",
    "K1 (2, 2) h16 di0 in-kernel": "88bcecfaf42a9b80", "K1 (2, 2) h16 di0 stream": "302aa56814cd1b41",
    "K1 (2, 2) h16 di2 in-kernel": "809b7436e43019b5", "K1 (2, 2) h16 di2 stream": "c37d40797eef3b2e",
    "K1 (2, 2) h32 di0 in-kernel": "2917f5cb2853817a", "K1 (2, 2) h32 di0 stream": "a88d1d2dd63f7c9d",
    "K1 (2, 2) h32 di2 in-kernel": "47ab859598c5cca0", "K1 (2, 2) h32 di2 stream": "781235afdd796343",
    "K1 (2, 2) h64 di0 in-kernel": "09cafb5727b81c82", "K1 (2, 2) h64 di0 stream": "e3364a1551d4637e",
    "K1 (2, 2) h64 di2 in-kernel": "68f9ac1b2c23fb01", "K1 (2, 2) h64 di2 stream": "bc2ee76a9db561b7",
    "K1 (3, 3) h16 di0 in-kernel": "5fbd00503eeb41cd", "K1 (3, 3) h16 di0 stream": "2628826e7c7cd15a",
    "K1 (3, 3) h16 di2 in-kernel": "52fe399d9321e350", "K1 (3, 3) h16 di2 stream": "4ce37271d97daced",
    "K1 (3, 3) h32 di0 in-kernel": "dfdf647aa5d38938", "K1 (3, 3) h32 di0 stream": "df1ad510fd15b360",
    "K1 (3, 3) h32 di2 in-kernel": "0f7e927a72de5ce3", "K1 (3, 3) h32 di2 stream": "d030543b6268f820",
    "K1 (3, 3) h64 di0 in-kernel": "83d30bed45db7898", "K1 (3, 3) h64 di0 stream": "80e84b4421711164",
    "K1 (3, 3) h64 di2 in-kernel": "5e9f66ffd3c64d7a", "K1 (3, 3) h64 di2 stream": "a949dd68728f0cbb",
    "K14 (2, 2) h16 di0": "dc9372d2c921336c", "K14 (2, 2) h16 di2": "fbfdae7ebe94ee0c",
    "K14 (2, 2) h32 di0": "477ad61b8c551f52", "K14 (2, 2) h32 di2": "7184e5cbc7e3d914",
    "K14 (2, 2) h64 di0": "38226a816cfbe53e", "K14 (2, 2) h64 di2": "dc6fcca4e720148e",
    "K14 (3, 3) h16 di0": "18f2546f690f4004", "K14 (3, 3) h16 di2": "3f5a75b6dfdc18d2",
    "K14 (3, 3) h32 di0": "f0a2a897eabdcd46", "K14 (3, 3) h32 di2": "9456209546b576e4",
    "K14 (3, 3) h64 di0": "5bc4cddb447c2fc1", "K14 (3, 3) h64 di2": "ba684a7d5caa0ffe",
    "K15 (2, 2) h16 di0": "7d21b34c886687dd", "K15 (2, 2) h16 di2": "5ced6a78cbd9dc2b",
    "K15 (2, 2) h32 di0": "64f02568ccc38d8b", "K15 (2, 2) h32 di2": "662d574829f8dfbc",
    "K15 (2, 2) h64 di0": "4a6b2b788cdb9d34", "K15 (2, 2) h64 di2": "f64f8d393cf320e3",
    "K15 (3, 3) h16 di0": "7d4562595ad0d6c1", "K15 (3, 3) h16 di2": "85a5a95a6b680f51",
    "K15 (3, 3) h32 di0": "2af6a58eba6e41e4", "K15 (3, 3) h32 di2": "e20c196a2a34e979",
    "K15 (3, 3) h64 di0": "ee89034ad81a2465", "K15 (3, 3) h64 di2": "b504f9325ea55b9f",
    "K4 (2, 2) h16 di0": "5ed3deaec84d03a5", "K4 (2, 2) h16 di2": "e1fd56e9c60bf214",
    "K4 (2, 2) h32 di0": "f382b5b14c68fa1b", "K4 (2, 2) h32 di2": "86332fff3135ab74",
    "K4 (2, 2) h64 di0": "e89ff2c6167f1b46", "K4 (2, 2) h64 di2": "558a560982f189b9",
    "K4 (3, 3) h16 di0": "5f529233dddb0da0", "K4 (3, 3) h16 di2": "45f707690b7e9bbb",
    "K4 (3, 3) h32 di0": "a4a0e5895099e72f", "K4 (3, 3) h32 di2": "c80daefa7c23c55f",
    "K4 (3, 3) h64 di0": "7366ee90f0c3b395", "K4 (3, 3) h64 di2": "ce2e09d08ea2d544",
}


def bg_svo_config(pt, dx, dy, di, h, b=32, t_steps=100, m=32):
    """Lorenz-63's SVO preset reshaped to (Dx, Dy, Di), q1/qb/f/g at (h, h),
    M paths, B = b, T, one train step a call, no mesh."""
    base = pt.PRESETS[SVO]
    cfg = dataclasses.replace(
        base, data=dataclasses.replace(base.data, dx=dx, dy=dy, di=di, t_steps=t_steps),
        smc=dataclasses.replace(base.smc, n_smoothing_particles=m),
        train=dataclasses.replace(base.train, steps_per_call=1, batch_size=b),
        mesh=dataclasses.replace(base.mesh, data=1, particle=1))
    net_of = {n: dataclasses.replace(cfg.net(n), hidden=(h, h)) for n in ("q1", "qb", "f", "g")}
    return cfg.with_nets(**net_of)


def bg_l96_config(pt):
    """Phase bg (b): the Lorenz-96 preset (Dx = Dy = 40, q1/f/g at its (64,
    64)) with PSVO at K = 1024, M = 16, B = 8, T = 100, no mesh."""
    return dataclasses.replace(
        route_config(pt, L96, {"objective": "psvo", "n_particles": 1024,
                               "n_smoothing_particles": 16}),
        mesh=dataclasses.replace(pt.PRESETS[L96].mesh, data=1, particle=1))


def smoothing_class_shapes(pt) -> list:
    """The shape libraries phase bg launches: K12/K13's at BG_SVO, K1/K4's at
    (c)'s shape (`fused_step._lib_key`), for `build_shapes_beside`."""
    from psvo_tpu_torch.ops import fused_step, svo

    keys = [svo.lib_key(dx, dy, h) for dx, dy, _, h in BG_SVO]
    c = fused_step.shape_consts(3, 1, 0, 48, 1)
    keys += [fused_step._lib_key(c, False, 256), fused_step._lib_key(c, True, 256)]  # (c)'s K
    return list(dict.fromkeys(k_ for k_ in keys if k_ is not None))


def _rel(a, w) -> float:
    return float((a.double() - w.double()).norm() / w.double().norm().clamp_min(1e-300))


def bg_ffbsi_check(dev, dx, k, m, b, t1, seed, small):
    """K5 against its plain version on one sweep's operands (`ffbsi_sweep`'s
    recipe, fresh Gumbels): selections on every (t, row, path), x~, x_first,
    logp and logq by relative L2; K6 in each cotangent mode of K6_MODES
    against its plain version per leaf (the direct bound's also against the
    plain version replayed in float64: `k6_wide_check`); each kernel
    bit-equal on a relaunch. Returns a dict with the operands for timing."""
    import torch
    from psvo_tpu_torch.ops import ffbsi

    gen = torch.Generator(device=dev).manual_seed(seed)
    sweep, _ = ffbsi_sweep(dev, dx, b, m, k, t1, gen)
    u = torch.rand((t1, b, m, k), generator=gen, device=dev).clamp_min(1e-30)
    ops = [*sweep[:7], (-torch.log(-torch.log(u))).contiguous()]
    with torch.no_grad():
        kern = ffbsi.ffbsi_forward(*ops)
        ref = ffbsi.ffbsi_forward_reference(*ops)
        again = ffbsi.ffbsi_forward(*ops)
    torch.cuda.synchronize()
    r = dict(sel_bad=int((kern[4] != ref[4]).sum()), n_sel=kern[4].numel(),
             rel5={nm: _rel(kern[i], ref[i]) for i, nm in
                   ((3, "xtilde"), (0, "x_first"), (1, "logp"), (2, "logq"))},
             err5=max_err(kern[:4], ref[:4]),
             same5=all(torch.equal(a, w) for a, w in zip(kern, again)), ops=ops, kern=kern,
             k6={}, kernel=(ffbsi.staged_kernel(dx, m), ffbsi.staged_kernel(dx, m, True)))
    cots = [torch.randn(t.shape, generator=gen, device=dev) for t in kern[:4]]
    names = ("d_x_first", "d_logp", "d_logq", "d_xtilde")
    tol = BG_TOL["k6_small" if small else "k6_full"]
    ok = r["sel_bad"] == 0 and r["same5"] and all(
        r["rel5"][nm] <= BG_TOL["k5_rel"] for nm in ("xtilde", "x_first", "logp"))
    for mode, (live, needs) in K6_MODES.items():
        kw = {n: cots[i] if i in live else None for i, n in enumerate(names)}
        args = (*ops[:7], kern[4], kern[3])
        with torch.no_grad():
            got = ffbsi.ffbsi_backward(*args, needs=needs, **kw)
            want = ffbsi.ffbsi_backward_reference(*args, needs=needs, **kw)
            again6 = ffbsi.ffbsi_backward(*args, needs=needs, **kw)
        torch.cuda.synchronize()
        rel = [_rel(g, w) for g, w in zip(got, want) if w is not None]
        same = all(g is None or torch.equal(g, a) for g, a in zip(got, again6))
        f64 = None
        if mode == "direct bound":  # d_q: a difference of near-equal sums (K6_MODES' note)
            k6_64, plain_64, _ = k6_wide_check(args, kw, needs, got, want, want)
            f64 = (k6_64, plain_64)
            good = all(a <= max(2 * p, tol) for a, p in zip(k6_64, plain_64))
        else:
            good = max(rel) <= tol
        ok = ok and good and same
        r["k6"][mode] = dict(rel=rel, same=same, f64=f64, maxd=max(
            float((g - w).abs().max()) for g, w in zip(got, want) if w is not None),
            args=args, kw=kw, needs=needs, got=got)
    r["ok"] = ok
    return r


def bg_svo_check(pt, dev, dx, dy, di, h, b, m, t1, seed, small):
    """K12 against its plain version (allclose 2e-4) and K13 per leaf on
    K12's x~ with random cotangents zeroed on the relu-tie paths
    (`svo_relu_ties`; d_cbias too with Di > 0), each bit-equal on a relaunch,
    at (Dx, Dy, Di, width h), B = b, M = m, T - 1 = t1: random weights
    nudged off their init, anchors, ε and observations at Lorenz-63 scales.
    Returns a dict with the operands for timing."""
    import torch
    from psvo_tpu_torch.ops import svo

    cfg = bg_svo_config(pt, dx, dy, di, h)
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(seed), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.no_grad():
        for p_ in ssm.parameters():
            p_.add_(0.05 * torch.randn(p_.shape, generator=gen, device=dev))
        consts = svo.prepare(ssm)
        cbias = None
        if di:
            cbias = svo.control_term(consts, torch.randn((t1, b, di), generator=gen,
                                                         device=dev)).contiguous()
        ops = (torch.randn((b, m, dx), generator=gen, device=dev) * 3.0,
               torch.randn((t1, b, m, dx), generator=gen, device=dev),
               torch.randn((t1, b, dy), generator=gen, device=dev) * 3.0)
        kern = svo.svo_sweep_forward(*ops, consts, cbias=cbias)
        ref = svo.svo_sweep_forward_reference(*ops, consts, cbias)
        again = svo.svo_sweep_forward(*ops, consts, cbias=cbias)
        tie = svo_relu_ties(consts, ops, kern[3], cbias=cbias)
        keep = (~tie).float()
        cots = [torch.randn(t.shape, generator=gen, device=dev) for t in kern]
        cots = [cots[0] * keep[..., None], cots[1] * keep, cots[2] * keep,
                cots[3] * keep[..., None]]
        got = svo.svo_sweep_backward(*ops, consts, kern[3], *cots, cbias=cbias)
        want = svo.svo_sweep_backward_reference(*ops, consts, kern[3], *cots, cbias=cbias)
        again13 = svo.svo_sweep_backward(*ops, consts, kern[3], *cots, cbias=cbias)
    torch.cuda.synchronize()
    rel13 = [_rel(g, w) for g, w in zip(got, want)]
    r = dict(close=close(kern, ref, BG_TOL["k12"]), err12=max_err(kern, ref),
             same12=all(torch.equal(a, w) for a, w in zip(kern, again)), rel13=rel13,
             err13=max_err(got, want), same13=all(torch.equal(a, w) for a, w in zip(got, again13)),
             zeroed=int(tie.sum()), n=b * m, consts=consts, ops=ops, cbias=cbias, kern=kern,
             cots=cots, got=got, key=svo.lib_key(dx, dy, h),
             plan=svo.k12_plan(dx, dy, h, 1, b * m, torch.cuda.get_device_properties(
                 dev).multi_processor_count, t1),
             rows13=svo.k13_tile_rows(dx, dy, h, 1, consts["packed"].numel()))
    r["ok"] = (r["close"] and r["same12"] and r["same13"]
               and max(rel13) <= BG_TOL["k13_small" if small else "k13_full"])
    return r


def preset_bits(pt, dev) -> dict:
    """{name: sha256 prefix} of K5/K6's outputs at Dx = 2 and 3 (B = 32, M =
    16, K = 1024, T - 1 = 20; K6 in each mode of K6_MODES) and K12/K13's at
    the kernels' library's six shapes ((2, 2), (3, 3) x widths 16, 32, 64,
    one middle layer; B = 32, M = 16, T - 1 = 20), without and with Di = 2
    controls, on inputs made from numpy seeds on the host (numpy's PCG64 and
    float64 arithmetic: the same bits on any host), weights from a CPU
    torch generator and f's control bias computed on the host (no library
    product whose algorithm the card's size picks), and K1/K4/K14/K15's
    (step_preset_bits): phase bg (d) holds them to the parent's build's."""
    import hashlib

    import numpy as np
    import torch
    from psvo_tpu_torch.ops import ffbsi, svo

    def digest(t):
        return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]

    out = {}
    b, m, k, t1 = 32, 16, 1024, 20
    for dx in (2, 3):
        rng = np.random.default_rng(100 + dx)
        xs = rng.random((t1, b, dx, k)) * 16.0 - 8.0
        mean = xs + rng.random(xs.shape) - 0.5
        sd = 0.5 + 1.5 * rng.random(xs.shape)
        rr = 1.0 / (sd * sd)
        c = -0.5 * np.sum(mean * mean * rr, axis=2) - np.sum(np.log(sd), axis=2)
        lw = rng.random((t1, b, k)) * 4.0
        lwn = lw - np.log(np.sum(np.exp(lw), axis=-1, keepdims=True))
        lg = rng.random((t1, b, k))
        gum = -np.log(-np.log(np.clip(rng.random((t1, b, m, k)), 1e-300, None)))
        xa = xs[-1, :, :, :m].transpose(0, 2, 1) + rng.random((b, m, dx)) - 0.5
        ops = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
               for a in (xa, xs, rr, mean * rr, c, lwn, lg, gum)]
        with torch.no_grad():
            fwd = ffbsi.ffbsi_forward(*ops)
            out.update({f"K5 dx{dx} out{i}": digest(t) for i, t in enumerate(fwd)})
            cots = [torch.from_numpy(np.asarray(rng.random(t.shape) - 0.5, np.float32)).to(dev)
                    for t in fwd[:4]]
            names = ("d_x_first", "d_logp", "d_logq", "d_xtilde")
            for mode, (live, needs) in K6_MODES.items():
                kw = {n: cots[i] if i in live else None for i, n in enumerate(names)}
                got = ffbsi.ffbsi_backward(*ops[:7], fwd[4], fwd[3], needs=needs, **kw)
                out.update({f"K6 dx{dx} {mode} {i}": digest(t) for i, t in enumerate(got)
                            if t is not None})
    for dx, h in [(d, w) for d in (2, 3) for w in (16, 32, 64)]:
        for di in (0, 2):
            cfg = bg_svo_config(pt, dx, dx, di, h)
            ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(7 + h + di), device=dev)
            rng = np.random.default_rng(200 + 10 * dx + h + di)

            def arr(*shape, scale=1.0):
                return torch.from_numpy(np.asarray((rng.random(shape) - 0.5) * scale,
                                                   np.float32)).to(dev)

            with torch.no_grad():
                consts = svo.prepare(ssm)
                cbias = None
                if di:  # u_{t+1}·W_u on the host, in float64
                    u = arr(t1, b, di).cpu().double()
                    cbias = (u @ consts["ctrl_w"].detach().cpu().double()).float().to(dev)
                ops = (arr(b, m, dx, scale=6.0), arr(t1, b, m, dx, scale=3.0),
                       arr(t1, b, dx, scale=6.0))
                k12 = svo.svo_sweep_forward(*ops, consts, cbias=cbias)
                cots = [arr(*t.shape) for t in k12]
                k13 = svo.svo_sweep_backward(*ops, consts, k12[3], *cots, cbias=cbias)
            tag = f"({dx}, {dx}) h{h} di{di}"
            out.update({f"K12 {tag} {i}": digest(t) for i, t in enumerate(k12)})
            out.update({f"K13 {tag} {i}": digest(t) for i, t in enumerate(k13)})
    out.update(step_preset_bits(pt, dev))
    return out


def step_preset_bits(pt, dev) -> dict:
    """{name: sha256 prefix} of K1's outputs (streamed and in-kernel noise,
    cache and residuals), K4's on them, and the chain of K14 launches and
    the K15 launches on it, at the kernels' library's six shapes ((2, 2),
    (3, 3) x widths 16, 32, 64, two hidden layers; B = 32, K = 1024,
    T - 1 = 20), without and with Di = 2 controls, each kernel's outputs in
    one digest; inputs and cotangents from numpy seeds on the host, weights
    from a CPU torch generator, as preset_bits' K5-K13. K1's and K14's bits
    do not depend on C or S, K4's and K15's sums do: the card's occupancy
    picks them, as PARENT_BITS_CARD's."""
    import hashlib

    import numpy as np
    import torch
    from psvo_tpu_torch.ops import fused_step

    def digest(ts):
        h_ = hashlib.sha256()
        for t in ts:
            h_.update(t.detach().contiguous().cpu().numpy().tobytes())
        return h_.hexdigest()[:16]

    out = {}
    b, k, t1 = 32, 1024, 20
    for dx, h in [(d, w) for d in (2, 3) for w in (16, 32, 64)]:
        for di in (0, 2):
            cfg = wide_config(pt, "fhn_fivo_k1024_bench" if dx == 2 else "lorenz63_psvo_k1024", h)
            cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, di=di,
                                                                    control_scale=0.5))
            ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(11 + h + di), device=dev)
            rng = np.random.default_rng(300 + 10 * dx + h + di)

            def arr(*shape, lo=-0.5, hi=0.5):
                return torch.from_numpy(np.asarray(lo + (hi - lo) * rng.random(shape),
                                                   np.float32)).to(dev)

            with torch.no_grad():
                consts = fused_step.prepare(ssm)
                cols = [arr(t1, b, dx), arr(t1, b, dx, lo=0.5, hi=1.0),
                        arr(t1, b, dx, lo=0.3, hi=0.7), arr(t1, b, dx, lo=-3.0, hi=3.0),
                        arr(t1, b, 1)]
                if di:
                    cols.append(arr(t1, b, 2 * h, lo=-0.25, hi=0.25))
                coef = torch.cat(cols, -1).contiguous()
                x0, a0 = arr(b, dx, k, lo=-2.0, hi=2.0), arr(b, k, lo=-1.0, hi=1.0)
                eps = torch.from_numpy(rng.standard_normal((t1, b, dx, k)).astype(np.float32)).to(dev)
                u0 = rng.random((t1, b, 1))
                pos = torch.from_numpy(((np.arange(k) + u0) / k).astype(np.float32)).to(dev)
                k1 = fused_step.scan_forward(x0, a0, coef, consts, eps=eps, positions=pos,
                                             cache=True, save_res=True)
                k1r = fused_step.scan_forward(x0, a0, coef, consts, seed=(5, 6), cache=True,
                                              save_res=True)
                _, _, stats, x_all, a_all, idx = k1
                cots = [arr(*t.shape) for t in (stats, x0, a0, x_all, a_all)]
                k4 = fused_step.scan_backward(x0, x_all, idx, stats, coef, consts, *cots,
                                              eps=eps)
                chain, x, lw = [], x0, a0
                for t in range(t1):
                    chain.append(fused_step.step_forward(x, lw, coef[t], consts, eps[t], pos[t]))
                    x, lw = chain[-1][:2]
                k15 = [fused_step.step_backward(x0 if t == 0 else chain[t - 1][0], chain[t][0],
                                                chain[t][3], chain[t][2], coef[t], consts, eps[t],
                                                cots[0][t], cots[3][t], cots[4][t])
                       for t in range(t1)]
            tag = f"({dx}, {dx}) h{h} di{di}"
            out[f"K1 {tag} stream"] = digest(k1)
            out[f"K1 {tag} in-kernel"] = digest(k1r)
            out[f"K4 {tag}"] = digest(k4)
            out[f"K14 {tag}"] = digest([v for s_ in chain for v in s_])
            out[f"K15 {tag}"] = digest([v for s_ in k15 for v in s_])
    return out


def bg_drive(pt, dev, card, label, cfg, ys, method, want_serve, want_train, groups):
    """Serve (one `smooth_posterior` call with `method`) and train (BG_TRAIN
    steps of make_train_step) cfg on the card through the entry points, with
    launch counts against ROUTE_NAMES' wants and no plain version; host-clock
    times, peak memory and a device profile of one more step."""
    import torch

    kernels, plain = route_counters()
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 250)
    t0 = time.perf_counter()
    (paths, sv_l, sv_p), sv_peak = peak_gb(lambda: kernel_counts(
        kernels, plain, lambda: pt.smooth_posterior(ssm, ys, cfg, gen, method=method)))
    sv_first = (time.perf_counter() - t0) * 1e3
    sv_ms = time_ms(lambda: pt.smooth_posterior(ssm, ys, cfg, gen, method=method), 3, 1)
    b, t = ys.shape[:2]
    ok = (tuple(paths.shape) == (b, cfg.smc.n_smoothing_particles, t, cfg.data.dx)
          and bool(torch.isfinite(paths).all()))
    print(f"[bg] {card}: {label} served: smooth_posterior(method={method!r}) -> "
          f"{tuple(paths.shape)}, finite and shaped {ok}; launches {dict(zip(ROUTE_NAMES, sv_l))}, "
          f"plain versions {sv_p}; {sv_first:.1f} ms the first call, {sv_ms:.2f} ms (CUDA events, "
          f"median of 3 after 1); peak {sv_peak:.3f} GB above what was held", flush=True)
    if not ok or sv_l != want_serve or sv_p:
        fail(f"(bg) {label} serving: launches {sv_l} (want {want_serve}), plain versions {sv_p}, "
             f"paths ok {ok}")
    step = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
    step_ms = []

    def run():
        out = []
        for _ in range(BG_TRAIN):
            t1 = time.perf_counter()
            out.append(step(gen, ys))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
        return out

    before = [p_.detach().clone() for p_ in ssm.parameters()]
    (metrics, tr_l, tr_p), peak = peak_gb(lambda: kernel_counts(kernels, plain, run))
    losses = [float(m_["loss"]) for m_ in metrics]
    norms = [float(m_["grad_norm"]) for m_ in metrics]
    moved = sum(not torch.equal(a, p_.detach()) for a, p_ in zip(before, ssm.parameters()))
    prof = device_breakdown(lambda: step(gen, ys), 1, groups)
    print(f"[bg] {card}: {label} {BG_TRAIN} train steps at B={b}, T={t}: loss "
          f"{[round(v, 3) for v in losses]}, grad norm {[round(v, 3) for v in norms]}, {moved} of "
          f"{len(before)} parameter tensors moved, launches {dict(zip(ROUTE_NAMES, tr_l))} (want "
          f"{dict(zip(ROUTE_NAMES, want_train))}), plain versions {tr_p}, step times "
          f"{[round(v, 1) for v in step_ms]} ms (host clock, the first with its warm-up), peak "
          f"{peak:.3f} GB above what was held; profile of one more step: {prof}", flush=True)
    if (tr_l != want_train or tr_p or not moved
            or not all(math.isfinite(v) for v in losses + norms)):
        fail(f"(bg) {label} training: launches {tr_l} (want {want_train}), plain versions {tr_p}, "
             f"losses {losses}, grad norms {norms}, moved {moved}")
    return dict(serve=sv_l, train=tr_l, step_ms=step_ms, serve_ms=sv_ms, serve_first=sv_first,
                peak=peak, serve_peak=sv_peak, profile=prof, losses=losses)


def smoothing_class_phases(pt, dev, card: str) -> dict:
    """Phase (bg): the smoothing sweeps at the reference's reach. (a) K5/K6's
    wide kernels (BG_FFBSI) and K12/K13 beyond the kernels' library (BG_SVO,
    and BG_BIG_M paths) against their plain versions under BG_TOL, times at
    the main paths' shapes; (b) Lorenz-96 PSVO at full width served and
    trained, the card against the CPU; (c) SVO on Lorenz-63 seen through
    one channel, likewise; (d) the preset shapes' K5/K6/K12/K13 outputs
    against the parent's build (PARENT_BITS). Returns the figures for the
    kernels' JSON record and PERF.md."""
    import torch
    from psvo_tpu_torch.ops import _build, ffbsi, svo

    figs = {"ffbsi": {}, "svo": {}}
    keys = smoothing_class_shapes(pt)
    t0 = time.perf_counter()
    for key in keys:  # built beside phases c-; a build that failed there raises here
        _build.load_shape_library(key)
    print(f"[bg] {card}: {shapes_line(keys)}; waited {time.perf_counter() - t0:.1f} s", flush=True)
    # (a) K5/K6
    for i, (dx, k, m, b, t1) in enumerate(BG_FFBSI):
        small = i == 0
        r = bg_ffbsi_check(dev, dx, k, m, b, t1, SEED + 260 + i, small)
        k6 = "; ".join(
            f"{mode} rel L2 " + "/".join(f"{v:.2e}" for v in v_["rel"])
            + (f" (float64: kernel {'/'.join(f'{a:.1e}' for a in v_['f64'][0])}, plain "
               f"{'/'.join(f'{a:.1e}' for a in v_['f64'][1])})" if v_["f64"] else "")
            + f", relaunch {v_['same']}" for mode, v_ in r["k6"].items())
        print(f"[bg] {card}: K5/K6 at Dx={dx}, K={k}, M={m}, B={b}, T-1={t1} (kernels "
              f"{r['kernel'][0]}/{r['kernel'][1]}): K5 selections differing {r['sel_bad']} of "
              f"{r['n_sel']}, rel L2 " + ", ".join(f"{nm} {v:.2e}" for nm, v in r["rel5"].items())
              + f", relaunch {r['same5']}; K6 {k6} (bounds {BG_TOL}) -> "
              f"{'ok' if r['ok'] else 'FAIL'}", flush=True)
        if not r["ok"]:
            fail(f"(bg) K5/K6 at Dx={dx}, K={k}, M={m} disagree with their plain versions")
        fig = dict(err5=r["err5"], err6=max(v_["maxd"] for v_ in r["k6"].values()),
                   rel5=r["rel5"], rel6={mode: v_["rel"] for mode, v_ in r["k6"].items()})
        if (dx, k, m) == (40, 1024, 16):  # Lorenz-96's main path: times and bounds
            ops, kern = r["ops"], r["kern"]
            pa = r["k6"]["paths only"]
            al = r["k6"]["all cotangents"]
            with torch.no_grad():
                t5 = [pair_ms(lambda: ffbsi.ffbsi_forward(*ops)),
                      time_ms(lambda: ffbsi.ffbsi_forward_reference(*ops), 3, 1)]
                t6 = {mode: [pair_ms(lambda v_=v_: ffbsi.ffbsi_backward(
                                 *v_["args"], needs=v_["needs"], **v_["kw"])),
                             time_ms(lambda v_=v_: ffbsi.ffbsi_backward_reference(
                                 *v_["args"], needs=v_["needs"], **v_["kw"]), 3, 1)]
                      for mode, v_ in (("paths only", pa), ("all cotangents", al))}
            n_pair = t1 * b * m * k
            b5 = bound((4 * dx + 10) * n_pair, k5_bytes(ops, kern))
            b6 = {"paths only": bound(n_pair, nbytes(ops[0], kern[3], kern[4], *[
                      v for v in pa["kw"].values() if v is not None], *[
                      g for g in pa["got"] if g is not None])),
                  "all cotangents": bound((12 * dx + 20) * n_pair, nbytes(
                      ops[0], kern[3], kern[4], *ops[2:6], *[
                          v for v in al["kw"].values() if v is not None], *[
                          g for g in al["got"] if g is not None]))}
            print(f"[bg] {card}: K5 wide at Lorenz-96's shape {t5[0]:.4f} ms ({PAIR_HOW}), plain "
                  f"{t5[1]:.3f} ms (CUDA events, median of 3); bound {b5[0]:.4f} ms ({b5[1]}); K6 "
                  + "; ".join(f"{mode} {t6[mode][0]:.4f} ms, plain {t6[mode][1]:.3f} ms, bound "
                              f"{b6[mode][0]:.4f} ms ({b6[mode][1]})" for mode in t6)
                  + f"; {kernel_resources('ffbsi_wide_kernelILi1E')}, "
                  f"{kernel_resources('ffbsi_bwd_wide_kernel')}", flush=True)
            fig.update(t5=t5, t6=t6, b5=b5, b6=b6)
        figs["ffbsi"][(dx, k, m)] = fig
        del r
    torch.cuda.empty_cache()
    phase_done("bg-a1: K5/K6's wide kernels")
    # (a) K12/K13
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for i, (dx, dy, di, h) in enumerate(BG_SVO):
        fig = {"runs": {}}
        runs = [("small", 8, 32, 20), ("full", 32, 32, 99)]
        if i == 0:
            runs.append((f"M={BG_BIG_M}", 4, BG_BIG_M, 20))
        for size, b, m, t1 in runs:
            r = bg_svo_check(pt, dev, dx, dy, di, h, b, m, t1, SEED + 270 + i, size == "small")
            print(f"[bg] {card}: K12/K13 ({dx}, {dy}) Di={di} width {h} {size} (B={b}, M={m}, "
                  f"T-1={t1}; library {r['key']}, K12 plan {r['plan']}, K13 tile rows "
                  f"{r['rows13']}): K12 allclose {BG_TOL['k12']} {r['close']} (max |d| "
                  f"{r['err12']:.2e}), relaunch {r['same12']}; K13 rel L2 "
                  + "/".join(f"{v:.2e}" for v in r["rel13"])
                  + f" ({r['zeroed']} of {r['n']} paths' cotangents zeroed at relu ties), "
                  f"relaunch {r['same13']} -> {'ok' if r['ok'] else 'FAIL'}", flush=True)
            if not r["ok"]:
                fail(f"(bg) K12/K13 at ({dx}, {dy}) width {h} {size} disagree with their plain "
                     "versions")
            fig["runs"][size] = dict(err12=r["err12"], err13=r["err13"], rel13=r["rel13"])
            if size == "full" and i == 0:  # (c)'s shape: times and bounds
                consts, ops, kern, cots, got = r["consts"], r["ops"], r["kern"], r["cots"], r["got"]
                with torch.no_grad():
                    t12 = [pair_ms(lambda: svo.svo_sweep_forward(*ops, consts)),
                           time_ms(lambda: svo.svo_sweep_forward_reference(*ops, consts), 3, 1)]
                    t13 = [pair_ms(lambda: svo.svo_sweep_backward(*ops, consts, kern[3], *cots)),
                           time_ms(lambda: svo.svo_sweep_backward_reference(
                               *ops, consts, kern[3], *cots), 3, 1)]
                flops = svo_flops(consts, t1 * b * m)
                b12 = bound(flops, nbytes(*ops, consts["packed"], consts["sc"], *kern))
                b13 = bound(3 * flops, nbytes(*ops, consts["packed"], consts["sc"], kern[3], *cots,
                                              *got))
                print(f"[bg] {card}: K12 at (c)'s shape {t12[0]:.4f} ms ({PAIR_HOW}), plain "
                      f"{t12[1]:.3f} ms; bound {b12[0]:.4f} ms ({b12[1]}); K13 {t13[0]:.4f} ms, "
                      f"plain {t13[1]:.3f} ms; bound {b13[0]:.4f} ms ({b13[1]})", flush=True)
                fig.update(t12=t12, t13=t13, b12=b12, b13=b13)
            del r
        figs["svo"][(dx, dy, di, h)] = fig
        torch.cuda.empty_cache()
    phase_done("bg-a2: K12/K13 beyond the kernels' library")

    # (b) Lorenz-96 PSVO at full width
    cfg = bg_l96_config(pt)
    cpu_ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    routes = (pt.smc.filter_route(cpu_ssm, cfg.smc, cfg.data.t_steps, True),
              pt.objectives._ffbsi_route(cpu_ssm, cfg.smc.n_particles,
                                         cfg.smc.n_smoothing_particles, True))
    ds = pt.generate_dataset(cfg.data, SEED)
    vs = card_vs_cpu(pt, dev, cfg, ds.obs_train[:2, :20], None, SEED + 280, path="trunk")
    print(f"[bg] {card}: (b) {L96} PSVO, Dx = Dy = 40, K={cfg.smc.n_particles}, "
          f"M={cfg.smc.n_smoothing_particles}, B={cfg.train.batch_size}, T={cfg.data.t_steps}, "
          f"q1/f/g {cfg.net('q1').hidden}, bound {cfg.smc.psvo_bound!r}: filter route "
          f"{routes[0]!r}, sweep route {routes[1]!r}; the card vs the CPU, one train step at B=2, "
          f"T=20: {vs_line(vs)}", flush=True)
    if routes != ("trunk", "kernel") or not vs["ok"]:
        fail(f"(bg) Lorenz-96 PSVO: routes {routes}, or the card disagrees with the CPU")
    n = cfg.data.t_steps - 1
    ys = ds.obs_train[:cfg.train.batch_size].to(dev).contiguous()
    figs["l96"] = bg_drive(pt, dev, card, "(b) Lorenz-96 PSVO", cfg, ys, None,
                           route_want({"K7": n, "K8": n, "K9": n, "K5": 1}),
                           route_want({"K7": BG_TRAIN * n, "K8": BG_TRAIN * n, "K9": BG_TRAIN * n,
                                       "K10": BG_TRAIN * n, "K11": BG_TRAIN * n, "K5": BG_TRAIN,
                                       "K6": BG_TRAIN}), BG_KERNELS)
    figs["l96"]["vs"] = vs
    torch.cuda.empty_cache()
    phase_done("bg-b: Lorenz-96 PSVO")

    # (c) SVO on Lorenz-63 seen through one channel
    cfg = bg_svo_config(pt, 3, 1, 0, 48)
    cfg = dataclasses.replace(cfg, smc=dataclasses.replace(cfg.smc, n_particles=256))
    cpu_ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    routes = (pt.smc.filter_route(cpu_ssm, cfg.smc, cfg.data.t_steps, True),
              pt.objectives._svo_route(cpu_ssm, cfg.smc.n_smoothing_particles, True))
    ds = pt.generate_dataset(cfg.data, SEED)
    vs = card_vs_cpu(pt, dev, cfg, ds.obs_train[:2, :20], None, SEED + 290)
    print(f"[bg] {card}: (c) {SVO} at (Dx, Dy) = (3, 1), q1/qb/f/g {cfg.net('qb').hidden}, "
          f"K={cfg.smc.n_particles}, M={cfg.smc.n_smoothing_particles}, B={cfg.train.batch_size}, "
          f"T={cfg.data.t_steps}: filter route {routes[0]!r}, sweep route {routes[1]!r}; the card "
          f"vs the CPU, one train step at B=2, T=20: {vs_line(vs)}", flush=True)
    if routes != ("fused", "kernel") or not vs["ok"]:
        fail(f"(bg) SVO (3, 1) width 48: routes {routes}, or the card disagrees with the CPU")
    ys = ds.obs_train[:cfg.train.batch_size].to(dev).contiguous()
    figs["l63"] = bg_drive(pt, dev, card, "(c) Lorenz-63 SVO Dy=1", cfg, ys, "svo",
                           route_want({"K1": 1, "K12": 1}),
                           route_want({"K1": BG_TRAIN, "K4": BG_TRAIN, "K12": BG_TRAIN,
                                       "K13": BG_TRAIN}), BG_SVO_KERNELS)
    figs["l63"]["vs"] = vs
    torch.cuda.empty_cache()
    phase_done("bg-c: Lorenz-63 SVO, Dy = 1, width 48")

    # (d) the preset shapes' bits against the parent's build
    bits = preset_bits(pt, dev)
    print(f"[bg] preset bits: {json.dumps(bits, sort_keys=True)}", flush=True)
    here = (torch.cuda.get_device_name(dev), n_sms)
    if here != PARENT_BITS_CARD:
        print(f"[bg] {card}: (d) not compared: the parent's digests were taken on "
              f"{PARENT_BITS_CARD}, this card is {here}", flush=True)
        figs["bits"] = None
    else:
        bad = sorted(n_ for n_, v in bits.items() if PARENT_BITS.get(n_) != v)
        print(f"[bg] {card}: (d) preset shapes' K1/K4/K14/K15 and K5/K6/K12/K13 outputs: "
              f"{len(bits) - len(bad)} "
              f"of {len(bits)} bit-equal to the parent's build"
              + (f"; differing: {bad}" if bad else ""), flush=True)
        if bad or len(bits) != len(PARENT_BITS):
            fail(f"(bg) {len(bad)} preset outputs differ from the parent's build")
        figs["bits"] = len(bits)
    phase_done("bg-d: the presets' bits")
    return figs


def smoothing_class_rows(figs: dict) -> list:
    """Phase bg's rows of the kernels' JSON record: K5/K6's wide kernels at
    Lorenz-96's main path (launches from (b)'s train steps), K12/K13 at (c)'s
    shape (launches from (c)'s train steps); max_abs_err the largest of
    (a)'s checks of each."""
    l96, l63 = figs["l96"], figs["l63"]
    f5 = figs["ffbsi"][(40, 1024, 16)]
    fs = figs["svo"][BG_SVO[0]]
    err5 = max(v["err5"] for v in figs["ffbsi"].values())
    err6 = max(v["err6"] for v in figs["ffbsi"].values())
    runs = [r_ for f_ in figs["svo"].values() for r_ in f_["runs"].values()]
    err12, err13 = max(r_["err12"] for r_ in runs), max(r_["err13"] for r_ in runs)
    rows = [
        {"name": "ffbsi_forward (wide, Lorenz-96)", "route": "cuda",
         "source": "psvo_tpu_torch/csrc/ffbsi.cu", "replaces": "psvo_tpu/ops/pallas_ffbsi.py:294",
         "launches": l96["train"][ROUTE_NAMES.index("K5")], "on_path": True, "max_abs_err": err5,
         "ms": f5["t5"][0], "plain_ms": f5["t5"][1], "bound_ms": f5["b5"][0],
         "bound_by": f5["b5"][1], "library_ms": None,
         "launches_serve": l96["serve"][ROUTE_NAMES.index("K5")]},
        {"name": "ffbsi_backward (wide, Lorenz-96)", "route": "cuda",
         "source": "psvo_tpu_torch/csrc/ffbsi.cu", "replaces": "psvo_tpu/ops/pallas_ffbsi.py:358",
         "launches": l96["train"][ROUTE_NAMES.index("K6")], "on_path": True, "max_abs_err": err6,
         "ms": f5["t6"]["paths only"][0], "plain_ms": f5["t6"]["paths only"][1],
         "bound_ms": f5["b6"]["paths only"][0], "bound_by": f5["b6"]["paths only"][1],
         "library_ms": None, "ms_all": f5["t6"]["all cotangents"][0],
         "plain_ms_all": f5["t6"]["all cotangents"][1],
         "bound_ms_all": f5["b6"]["all cotangents"][0]},
        {"name": "svo_sweep_forward (class, (3, 1) width 48)", "route": "cuda",
         "source": "psvo_tpu_torch/csrc/svo_sweep.cuh", "replaces": "psvo_tpu/ops/pallas_svo.py:446",
         "launches": l63["train"][ROUTE_NAMES.index("K12")], "on_path": True,
         "max_abs_err": err12, "ms": fs["t12"][0], "plain_ms": fs["t12"][1],
         "bound_ms": fs["b12"][0], "bound_by": fs["b12"][1], "library_ms": None,
         "shape_library": "svo_3_1_48"},
        {"name": "svo_sweep_backward (class, (3, 1) width 48)", "route": "cuda",
         "source": "psvo_tpu_torch/csrc/svo_sweep.cuh", "replaces": "psvo_tpu/ops/pallas_svo.py:521",
         "launches": l63["train"][ROUTE_NAMES.index("K13")], "on_path": True,
         "max_abs_err": err13, "ms": fs["t13"][0], "plain_ms": fs["t13"][1],
         "bound_ms": fs["b13"][0], "bound_by": fs["b13"][1], "library_ms": None,
         "shape_library": "svo_3_1_48"},
    ]
    for row in rows:  # whether (d) held the presets' outputs to the parent's bits on this card
        row["preset_bits_compared"] = figs["bits"] is not None
    return rows


# ---------------------------------------------------------------------------
# (bh) the whole-step kernels K1/K4/K14/K15 above width 64
# ---------------------------------------------------------------------------

WIDE = (72, 128, 256)  # phase bh (a): widths of two hidden layers, K1/K14 under the tiled plan
WIDE_DIMS = ((2, 2), (3, 1))  # (a): FitzHugh-Nagumo's (Dx, Dy), Lorenz-63 through one channel
WIDE_SIZES = {72: (32, 100), 128: (32, 100), 256: (8, 20)}  # (a): B, T by width (K = 1024);
# 256 cut to B = 8, T = 20 for the run's time
WIDE_NET = 128  # (c)-(e): q0/q1/q2/f/g at (128, 128)
WIDE_TRAIN = 3  # (c), (d): train steps
WIDE_NETS = ("q0", "q1", "q2", "f", "g")
WIDE_TOL = {"k1": 2e-4, "k4": 1e-3, "k14": 2e-4, "k15": 1e-3, "k15_vs_k4": 1e-4, "sums": 1e-6}


def wide_config(pt, preset: str, h: int, dx=None, dy=None, t=None, nets=("q1", "f", "g")):
    """preset with `nets` at (h, h), the state and observation widths and T
    changed where given, one train step a call, B = 32, no mesh."""
    base = pt.PRESETS[preset]
    data = {k_: v for k_, v in (("dx", dx), ("dy", dy), ("t_steps", t)) if v is not None}
    cfg = dataclasses.replace(
        base, data=dataclasses.replace(base.data, **data),
        train=dataclasses.replace(base.train, steps_per_call=1, batch_size=32),
        mesh=dataclasses.replace(base.mesh, data=1, particle=1))
    return cfg.with_nets(**{n: dataclasses.replace(cfg.net(n), hidden=(h, h)) for n in nets})


@contextlib.contextmanager
def k1_plan_forced(plan: str):
    """Within the block, K1's and K14's plan at every shape is `plan` (the
    gates' caches cleared on entry and exit): how (b) runs the tiled plan at
    width 64, from a shape library of its own."""
    from psvo_tpu_torch.ops import fused_step

    caches = (fused_step._lib_key_of, fused_step._k1_fits, fused_step._k4_fits,
              fused_step._k15_fits, fused_step._resident_at)
    real = fused_step._k1_plan
    fused_step._k1_plan = lambda shape: plan
    for f in caches:
        f.cache_clear()
    try:
        yield
    finally:
        fused_step._k1_plan = real
        for f in caches:
            f.cache_clear()


def wide_shapes(pt) -> list:
    """The shape libraries of phase bh (`fused_step._lib_key`): (a)'s shapes,
    the tiled plan at the presets' width 64 ((b), forced) and Lorenz-63 at
    (128, 128) ((d)), for `build_shapes_beside`."""
    from psvo_tpu_torch.ops import fused_step

    shapes = [(dx, dy, h) for dx, dy in WIDE_DIMS for h in WIDE] + [(3, 3, WIDE_NET)]
    keys = []
    for dx, dy, h in shapes:  # K = 1024 throughout
        c = fused_step.shape_consts(dx, dy, 0, h, 1)
        keys += [fused_step._lib_key(c, False, 1024), fused_step._lib_key(c, True, 1024)]
    with k1_plan_forced("tile"):
        keys += [fused_step._lib_key(fused_step.shape_consts(d, d, 0, 64, 1), False, 1024)
                 for d in (2, 3)]
    return list(dict.fromkeys(k_ for k_ in keys if k_ is not None))


def size_sweep(inp, gen) -> dict:
    """K1 and K4 at every cluster size C, K14 and K15 at every slice count S
    that the gates and the card admit, on kernel_inputs' operands (stream
    noise): K1's outputs and K4's d_x0 bit-equal to the smallest C's, K4's
    d_coef, weight and sconst sums within WIDE_TOL["sums"] relative L2 of
    it, else within twice its distance from a float64 replay (each adds the
    same float32 tile sums in another association); K14's outputs and K15's
    d_x at a mid step bit-equal to S = 1's, K15's sums likewise. Returns
    {"C": {C: (k1 equal, k4 ok)}, "S": {S: (k14 equal, k15 ok)}, "chosen":
    (C of K1, C of K4, S of K14, S of K15), "rel": {("C" or "S", size):
    [(rel L2 to the first size, or with its float64 distances)]}}."""
    import torch
    from psvo_tpu_torch.ops import fused_step

    consts, coef, eps, pos = inp["consts"], inp["coef"], inp["eps"], inp["positions"]
    x0, a0 = inp["x0"], inp["alpha0"]
    t1, b = coef.shape[:2]
    dev, k = x0.device, x0.shape[-1]
    act = [fused_step.max_active_clusters(kern, dev, consts, k) for kern in (0, 1)]
    c1 = [c for c in fused_step.CLUSTER_SIZES if act[0][c] > 0
          and (c == 1 or k % (c * fused_step.K1_MIN_SLICE) == 0)]
    c4 = [c for c in fused_step.CLUSTER_SIZES if act[1][c] > 0 and fused_step._k4_ok(consts, k, c)]

    def k1(c):
        return fused_step.scan_forward(x0, a0, coef, consts, eps=eps, positions=pos,
                                       cache=True, save_res=True, cluster=c)

    base1 = k1(c1[0])
    _, _, stats, x_all, _, idx = base1
    d_stats = torch.randn(stats.shape, generator=gen, device=dev)
    d_stats[..., 0] = -1.0 / b
    cots = [torch.randn(x0.shape, generator=gen, device=dev),
            torch.randn(a0.shape, generator=gen, device=dev)]
    bwd = (x0, x_all, idx, stats, coef, consts, d_stats, *cots)

    def k4(c):
        return fused_step.scan_backward(*bwd, eps=eps, cluster=c)

    rels = {}

    def sums_ok(tag, got, base, ref64):
        rel = rels[tag] = [_rel(g, w) for g, w in zip(got[1:], base[1:])]
        if max(rel) <= WIDE_TOL["sums"]:
            return True
        want = ref64()
        far = [(e, _rel(g.double(), w), _rel(h_.double(), w))
               for e, g, h_, w in zip(rel, got[1:], base[1:], want[1:])]
        rels[tag] = far
        return all(e <= WIDE_TOL["sums"] or a <= 2.0 * b for e, a, b in far)

    c64 = {}

    def k4_64():
        if "k4" not in c64:
            d = dict(consts, packed=consts["packed"].double(), sconst=consts["sconst"].double())
            c64["k4"] = fused_step.scan_backward_reference(
                x0.double(), coef.double(), d, eps.double(), idx, d_stats.double(),
                *(c_.double() for c_ in cots))
        return c64["k4"]

    base4 = k4(c4[0])
    out = {"C": {}, "S": {}}
    for c in sorted(set(c1) | set(c4)):
        e1 = all(torch.equal(a, w) for a, w in zip(k1(c), base1)) if c in c1 else None
        if c in c4:
            got = k4(c)
            e4 = torch.equal(got[0], base4[0]) and sums_ok(("C", c), got, base4, k4_64)
        else:
            e4 = None
        out["C"][c] = (e1, e4)
    t = t1 // 2
    x_in = x0 if t == 0 else x_all[t - 1]
    fwd = (x_in, base1[4][t - 1] if t else a0, coef[t], consts, eps[t], pos[t])
    s_base = fused_step.step_forward(*fwd, slices=1)
    d_xn = torch.randn(x0.shape, generator=gen, device=dev)
    d_al = torch.randn(a0.shape, generator=gen, device=dev)
    sb = (x_in, s_base[0], s_base[3], s_base[2], coef[t], consts, eps[t], d_stats[t], d_xn, d_al)

    def k15_64():
        if "k15" not in c64:
            d = dict(consts, packed=consts["packed"].double(), sconst=consts["sconst"].double())
            c64["k15"] = fused_step.step_backward_reference(
                x_in.double(), coef[t].double(), d, eps[t].double(), s_base[3],
                d_stats[t].double(), d_xn.double(), d_al.double())
        return c64["k15"]

    b_base = fused_step.step_backward(*sb, slices=1)
    for s in fused_step.STEP_SLICES:
        e14 = (all(torch.equal(a, w) for a, w in zip(fused_step.step_forward(*fwd, slices=s),
                                                     s_base))
               if s == 1 or k % (s * fused_step.K1_MIN_SLICE) == 0 else None)
        if s == 1 or k % (s * fused_step.K4_MIN_SLICE) == 0:
            got = fused_step.step_backward(*sb, slices=s)
            e15 = torch.equal(got[0], b_base[0]) and sums_ok(("S", s), got, b_base, k15_64)
        else:
            e15 = None
        out["S"][s] = (e14, e15)
    fused_step.scan_forward(x0, a0, coef, consts, eps=eps, positions=pos)
    fused_step.scan_backward(*bwd, eps=eps)
    fused_step.step_forward(*fwd)
    fused_step.step_backward(*sb)
    torch.cuda.synchronize()
    out["chosen"] = (fused_step.scan_forward.last_cluster, fused_step.scan_backward.last_cluster,
                     fused_step.step_forward.last_slices, fused_step.step_backward.last_slices)
    out["rel"] = rels
    return out


def wide_check(pt, dev, card, dx, dy, h, gen) -> dict:
    """(a) at one shape: K1 teacher-forced, K4 on its residuals, the chain
    of K14 launches and K15 on it against their plain versions
    (WIDE_TOL), the chain bit-equal to K1 and within 1e-4 of K4, then
    size_sweep; at (2, 2) the kernels' times beside their plain versions'
    and bounds. B, T: WIDE_SIZES; K = 1024; random weights and
    observations."""
    import torch
    from psvo_tpu_torch.ops import fused_step

    t0 = time.perf_counter()
    b, t = WIDE_SIZES[h]
    cfg = wide_config(pt, "fhn_fivo_k1024_bench", h, dx, dy, t)
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + h + dx), device=dev)
    ys = torch.randn((b, t, dy), device=dev, generator=gen)
    with torch.no_grad():
        consts = fused_step.prepare(ssm)
    k = cfg.smc.n_particles
    keys = (fused_step._lib_key(consts, False, k), fused_step._lib_key(consts, True, k))
    with torch.no_grad():
        r1 = check_scan(f"(bh) ({dx}, {dy}) width {h}", ssm, cfg, ys, gen, tol=WIDE_TOL["k1"])
        r4 = check_backward(ssm, cfg, ys, gen)
        rs = step_chain_check(ssm, cfg, ys, gen)
        rb = step_backward_check(rs, gen)
        sw = size_sweep(rs["inp"], gen)
    ok = dict(
        k1=r1["finite"] and r1["tf_flips"] == 0 and r1["tf_err"] < WIDE_TOL["k1"],
        k4=r4["finite"] and r4["monotone"] and max(r4["rel"]) <= WIDE_TOL["k4"],
        k14=(rs["finite"] and rs["idx_bad"] == 0 and max(rs["tf_rel"]) < WIDE_TOL["k14"]
             and rs["k1_idx"] == 0 and max(rs["vs_k1"]) == 0.0),
        k15=(rb["finite"] and rb["same"] and max(rb["rel"]) <= WIDE_TOL["k15"]
             and max(rb["vs_k4"]) <= WIDE_TOL["k15_vs_k4"]),
        sizes=all(v is not False for pair in list(sw["C"].values()) + list(sw["S"].values())
                  for v in pair))
    print(f"[bh] {card}: (a) ({dx}, {dy}) q1/f/g ({h}, {h}), B={b}, K=1024, T={t}: plans K1/K14 "
          f"{fused_step.k1_plan(consts)!r} (tiles of {fused_step.k1_tile(consts)} particles), "
          f"K4/K15 {fused_step.k4_plan(consts, k)!r} (tiles of {fused_step.k4_tile(consts, k)}), "
          f"libraries {keys[0]} / {keys[1]}; K1 "
          f"teacher-forced {r1['tf_flips']} flips, max|d| {r1['tf_err']:.2e}; K4 rel L2 "
          + "/".join(f"{v:.1e}" for v in r4["rel"])
          + f"; K14 {rs['idx_bad']} ancestors off, elementwise "
          + "/".join(f"{v:.1e}" for v in rs["tf_rel"])
          + f", the chain vs one K1 launch {rs['k1_idx']} ancestors off, max|d| {rs['vs_k1']}; "
          f"K15 rel L2 " + "/".join(f"{v:.1e}" for v in rb["rel"])
          + f" ({rb['zeroed']} of {rb['n']} tied particles zeroed), relaunch {rb['same']}, the "
          f"chain vs one K4 launch " + "/".join(f"{v:.1e}" for v in rb["vs_k4"])
          + f"; by C (K1 equal, K4 ok) {sw['C']}, by S (K14 equal, K15 ok) {sw['S']}, the sums' "
          f"rel L2 to the first size (where above {WIDE_TOL['sums']:g}: with the two sizes' "
          f"distances from float64) "
          + ", ".join(f"{kind}={size}: " + "/".join(
              f"{v:.1e}" if not isinstance(v, tuple) else "(" + ", ".join(f"{x:.1e}" for x in v)
              + ")" for v in vals) for (kind, size), vals in sw["rel"].items())
          + f"; chosen C/C/S/S {sw['chosen']}; {time.perf_counter() - t0:.1f} s -> "
          f"{'ok' if all(ok.values()) else 'FAIL ' + str(ok)}",
          flush=True)
    if not all(ok.values()):
        fail(f"(bh) ({dx}, {dy}) width {h}: {[k_ for k_, v in ok.items() if not v]} disagree "
             f"with their plain versions (bounds {WIDE_TOL})")
    fig = dict(keys=keys, chosen=sw["chosen"],
               err=dict(k1=r1["tf_err"], k4=max(r4["maxd"]), k14=rs["tf_abs"],
                        k15=max(rb["maxd"])))
    if (dx, dy) == WIDE_DIMS[0]:
        inp = rs["inp"]
        fwd_args = (inp["x0"], inp["alpha0"], inp["coef"][0], inp["consts"], inp["eps"][0],
                    inp["positions"][0])
        args, d_xn, d_al, _ = rb["last"]
        with torch.no_grad():
            k1 = lambda: fused_step.scan_forward(inp["x0"], inp["alpha0"], inp["coef"],  # noqa
                                                 inp["consts"], eps=inp["eps"],
                                                 positions=inp["positions"])
            k1_plain = lambda: fused_step.scan_forward_reference(  # noqa: E731
                inp["x0"], inp["alpha0"], inp["coef"], inp["consts"], inp["eps"],
                inp["positions"])
            k14 = lambda: fused_step.step_forward(*fwd_args)  # noqa: E731
            k15 = lambda: fused_step.step_backward(*args, d_xn, d_al)  # noqa: E731
            fig["times"] = dict(
                k1=(time_ms(k1, reps=3, warmup=1), time_ms(k1_plain, reps=1, warmup=1)),
                k4=(time_ms(r4["kernel"], reps=3, warmup=1),
                    time_ms(r4["plain"], reps=1, warmup=1)),
                k14=(pair_ms(k14), time_ms(lambda: fused_step.step_forward_reference(*fwd_args),
                                           reps=3, warmup=1)),
                k15=(pair_ms(k15), time_ms(lambda: fused_step.step_backward_reference(
                    args[0], args[4], args[5], args[6], args[2], args[7], d_xn, d_al),
                    reps=3, warmup=1)))
            b14, b15 = step_bounds(consts, fwd_args[:3] + fwd_args[4:], k14(), rb["last"])
        fig["bounds"] = dict(k1=k1_bound_of(inp, True), k4=bound(r4["flops"], r4["n_bytes"]),
                             k14=b14, k15=b15)
        print(f"[bh] {card}: (a) (2, 2) width {h} at B={b}, K=1024, T={t}: "
              + "; ".join(f"{kk.upper()} {v[0]:.3f} ms, plain {v[1]:.3f} ms, bound "
                          f"{fig['bounds'][kk][0]:.4f} ms ({fig['bounds'][kk][1]})"
                          for kk, v in fig["times"].items())
              + f" (K1/K4 by CUDA events, median of 3 after a warm-up; K14/K15 {PAIR_HOW}; the "
              f"plain versions by CUDA events, 1-3 runs); registers and spills {shape_resources(keys[0])}",
              flush=True)
    return fig


def wide_drive(pt, dev, card, label, cfg, ys, serve, want_serve, want_train, n_train,
               profile=True) -> dict:
    """cfg on the card through its entry points: each of `serve` [(name,
    fn(ssm, gen))] once after a warm-up, then n_train train steps on ys,
    with launch counts against ROUTE_NAMES' wants and no plain version;
    host-clock times, the train steps' peak memory and (with `profile`) a
    device profile of one more step. Returns its figures."""
    import torch

    kernels, plain = route_counters()
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 310)
    figs = {"serve": {}}
    for name, fn in serve:
        fn(ssm, gen)  # warm-up
        t0 = time.perf_counter()
        out, launches, n_plain = kernel_counts(kernels, plain, lambda: fn(ssm, gen))
        ms = (time.perf_counter() - t0) * 1e3
        t_ = out if torch.is_tensor(out) else out["elbo"]
        ok = bool(torch.isfinite(t_).all())
        print(f"[bh] {card}: {label} {name}: shape {tuple(t_.shape)}, launches "
              f"{dict(zip(ROUTE_NAMES, launches))}, plain versions {n_plain}, {ms:.1f} ms (host "
              f"clock, after a warm-up), finite {ok}", flush=True)
        if not ok or launches != want_serve[name] or n_plain:
            fail(f"(bh) {label} {name}: launched {launches} (want {want_serve[name]}), plain "
                 f"versions {n_plain}, finite {ok}")
        figs["serve"][name] = dict(launches=launches, ms=ms)
    step = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
    step_s = []

    def run():
        out = []
        for _ in range(n_train):
            t1 = time.perf_counter()
            out.append(step(gen, ys))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
        return out

    before = [p_.detach().clone() for p_ in ssm.parameters()]
    (metrics, launches, n_plain), peak = peak_gb(lambda: kernel_counts(kernels, plain, run))
    losses = [float(m_["loss"]) for m_ in metrics]
    norms = [float(m_["grad_norm"]) for m_ in metrics]
    moved = sum(not torch.equal(a, p_.detach()) for a, p_ in zip(before, ssm.parameters()))
    prof = (device_breakdown(lambda: step(gen, ys), 1, ROUTE_KERNELS) if profile
            else "not taken")
    print(f"[bh] {card}: {label} {n_train} train step(s) at B={ys.shape[0]}: loss "
          f"{[round(v, 3) for v in losses]}, grad norm {[round(v, 3) for v in norms]}, {moved} "
          f"parameter tensors moved, launches {dict(zip(ROUTE_NAMES, launches))} (want "
          f"{dict(zip(ROUTE_NAMES, want_train))}), plain versions {n_plain}, step times "
          f"{[round(1e3 * v, 1) for v in step_s]} ms (host clock, the first with its warm-up), "
          f"peak {peak:.3f} GB above what was held; profile of one more step: {prof}", flush=True)
    if (launches != want_train or n_plain or not all(math.isfinite(v) for v in losses + norms)
            or not moved):
        fail(f"(bh) {label} training launched {launches} (want {want_train}), plain versions "
             f"{n_plain}, losses {losses}, grad norms {norms}, moved {moved}")
    figs.update(train=launches, step_ms=[1e3 * v for v in step_s], peak=peak, profile=prof,
                losses=losses)
    return figs


def wide_step_phases(pt, dev, card: str) -> dict:
    """Phase (bh): the whole-step kernels above width 64. (a) K1/K4/K14/K15
    against their plain versions at widths WIDE (two hidden layers) at
    (Dx, Dy) = (2, 2) and (3, 1) (wide_check: every C and S the gates admit),
    and one train step at (2, 2) of each width whole-scan and per step; (b)
    the tiled plan forced at the presets' width 64 (FHN and Lorenz-63 at
    B = 32, K = 1024, T = 100), bit-equal to the register plan in both noise
    modes, K14's chain too; (c) fhn_fivo_k1024_bench with q0/q1/q2/f/g at
    (128, 128): the card against the CPU, make_eval_step and
    filter_posterior, WIDE_TRAIN train steps (one K1 and one K4 a step);
    (d) lorenz63_psvo_k1024 at (128, 128): smooth_posterior and WIDE_TRAIN
    PSVO train steps through K1/K4 and K5/K6; (e) (c)'s configuration with
    SCAN_FUSED off: make_eval_step and one train step (99 K14, 99 K15).
    Returns the figures for the kernels' JSON record and PERF.md."""
    import torch
    from psvo_tpu_torch.ops import _build, fused_step

    figs = {"a": {}, "drive": {}}
    keys = wide_shapes(pt)
    t0 = time.perf_counter()
    for key in keys:  # built beside phases c-; a build that failed there raises here
        _build.load_shape_library(key)
    widest = {d: max(h for h in range(8, 2049, 8) if fused_step.shape_fits(
        fused_step.shape_consts(d, d, 0, h, 1), fused_step.PLAN_K)) for d in (2, 7)}
    print(f"[bh] {card}: {shapes_line(keys)}; waited {time.perf_counter() - t0:.1f} s; the "
          f"class at two hidden layers and K={fused_step.PLAN_K} reaches width {widest[2]} at "
          f"Dx = Dy = 2 and {widest[7]} at Dx = Dy = 7 (fused_step.shape_fits)", flush=True)
    figs["widest"] = widest
    gen = torch.Generator(device=dev).manual_seed(SEED + 300)
    n = {h: WIDE_SIZES[h][1] - 1 for h in WIDE}
    for dx, dy in WIDE_DIMS:
        for h in WIDE:
            figs["a"][(dx, dy, h)] = wide_check(pt, dev, card, dx, dy, h, gen)
            torch.cuda.empty_cache()
    # one train step at (2, 2) of each width: whole scan, and per step
    for h in WIDE:
        b, t = WIDE_SIZES[h]
        cfg = wide_config(pt, "fhn_fivo_k1024_bench", h, t=t)
        ys = pt.generate_dataset(cfg.data, SEED).obs_train[:b].to(dev).contiguous()
        drives = {}
        for scan_fused in (True, False):
            fused_step.SCAN_FUSED = scan_fused
            try:
                want = route_want({"K1": 1, "K4": 1} if scan_fused
                                  else {"K14": n[h], "K15": n[h]})
                drives[scan_fused] = wide_drive(
                    pt, dev, card, f"(a) FHN (2, 2) width {h} {'whole scan' if scan_fused else 'SCAN_FUSED off'}",
                    cfg, ys, [], {}, want, 1, profile=False)
            finally:
                fused_step.SCAN_FUSED = True
        figs["a"][(2, 2, h)]["drives"] = drives
    phase_done("bh-a: K1/K4/K14/K15 at widths 72, 128, 256")

    # (b) the tiled plan forced at the presets' width 64
    figs["b"] = {}
    for preset, dx in (("fhn_fivo_k1024_bench", 2), ("lorenz63_psvo_k1024", 3)):
        cfg = wide_config(pt, preset, 64)
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 320 + dx), device=dev)
        ys = torch.randn((32, cfg.data.t_steps, dx), device=dev, generator=gen)
        with torch.no_grad():
            inp = kernel_inputs(ssm, cfg, ys, gen)
            args = (inp["x0"], inp["alpha0"], inp["coef"], inp["consts"])
            seed = (31, 0xB1DE)
            runs, ms = {}, {}
            for plan in ("register", "tile"):
                with (k1_plan_forced("tile") if plan == "tile" else contextlib.nullcontext()):
                    key = fused_step._lib_key(inp["consts"], False, 1024)
                    chain, x, lw = [], inp["x0"], inp["alpha0"]
                    for t_ in range(inp["coef"].shape[0]):
                        chain.append(fused_step.step_forward(
                            x, lw, inp["coef"][t_], inp["consts"], inp["eps"][t_],
                            inp["positions"][t_]))
                        x, lw = chain[-1][:2]
                    runs[plan] = (fused_step.scan_forward(*args, eps=inp["eps"],
                                                          positions=inp["positions"],
                                                          cache=True, save_res=True),
                                  fused_step.scan_forward(*args, seed=seed, cache=True,
                                                          save_res=True), chain, key)
                    ms[plan] = time_ms(lambda: fused_step.scan_forward(*args, seed=seed),
                                       reps=3, warmup=1)
        same = [all(torch.equal(a, w) for a, w in zip(runs["register"][i], runs["tile"][i]))
                for i in (0, 1)]
        same.append(all(torch.equal(a, w) for s1, s2 in zip(runs["register"][2], runs["tile"][2])
                        for a, w in zip(s1, s2)))
        print(f"[bh] {card}: (b) {preset} (B=32, K=1024, T=100, q1/f/g (64, 64)): K1 under the "
              f"tiled plan (library {runs['tile'][3]}, forced) vs the register plan (library "
              f"{runs['register'][3] or 'the kernels own'}): stream noise bit-equal {same[0]}, "
              f"in-kernel draw bit-equal {same[1]}, the chain of K14 launches bit-equal "
              f"{same[2]}; K1 in-kernel draw {ms['register']:.3f} ms register, {ms['tile']:.3f} "
              f"ms tiled (CUDA events, median of 3)", flush=True)
        if not all(same):
            fail(f"(bh) (b) {preset}: the tiled plan is not bit-equal to the register plan")
        figs["b"][preset] = dict(same=same, ms=ms)
        del ssm, inp, runs
        torch.cuda.empty_cache()
    phase_done("bh-b: the tiled plan at width 64")

    # (c) FHN at (128, 128)
    cfg = wide_config(pt, "fhn_fivo_k1024_bench", WIDE_NET, nets=WIDE_NETS)
    cpu_ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    route = pt.smc.filter_route(cpu_ssm, cfg.smc, cfg.data.t_steps, True)
    ds = pt.generate_dataset(cfg.data, SEED)
    vs = card_vs_cpu(pt, dev, cfg, ds.obs_train[:2, :20], None, SEED + 330)
    print(f"[bh] {card}: (c) fhn_fivo_k1024_bench, q0/q1/q2/f/g ({WIDE_NET}, {WIDE_NET}), K=1024, "
          f"B=32, T=100: route {route!r}; the card vs the CPU, one train step at B=2, T=20: "
          f"{vs_line(vs)}", flush=True)
    if route != "fused" or not vs["ok"]:
        fail(f"(bh) (c) FHN at ({WIDE_NET}, {WIDE_NET}): route {route}, or the card disagrees "
             "with the CPU")
    ys = ds.obs_train[:32].to(dev).contiguous()
    serve = [("make_eval_step", lambda ssm, g: pt.make_eval_step(ssm, cfg)(g, ys)),
             ("filter_posterior", lambda ssm, g: pt.filter_posterior(ssm, ys, cfg, g))]
    figs["drive"]["c"] = wide_drive(
        pt, dev, card, f"(c) FHN ({WIDE_NET}, {WIDE_NET})", cfg, ys, serve,
        {"make_eval_step": route_want({"K1": 1}), "filter_posterior": route_want({"K1": 1})},
        route_want({"K1": WIDE_TRAIN, "K4": WIDE_TRAIN}), WIDE_TRAIN)
    figs["drive"]["c"]["vs"] = vs
    torch.cuda.empty_cache()
    phase_done("bh-c: FHN at (128, 128)")

    # (d) Lorenz-63 PSVO at (128, 128)
    lcfg = wide_config(pt, "lorenz63_psvo_k1024", WIDE_NET, nets=WIDE_NETS)
    lds = pt.generate_dataset(lcfg.data, SEED)
    vs = card_vs_cpu(pt, dev, lcfg, lds.obs_train[:2, :20], None, SEED + 340)
    print(f"[bh] {card}: (d) lorenz63_psvo_k1024, q0/q1/q2/f/g ({WIDE_NET}, {WIDE_NET}), K=1024, "
          f"M=16, B=32, T=100: the card vs the CPU, one train step at B=2, T=20: {vs_line(vs)}",
          flush=True)
    if not vs["ok"]:
        fail(f"(bh) (d) Lorenz-63 PSVO at ({WIDE_NET}, {WIDE_NET}): the card disagrees with the "
             "CPU")
    lys = lds.obs_train[:32].to(dev).contiguous()
    figs["drive"]["d"] = wide_drive(
        pt, dev, card, f"(d) Lorenz-63 PSVO ({WIDE_NET}, {WIDE_NET})", lcfg, lys,
        [("smooth_posterior", lambda ssm, g: pt.smooth_posterior(ssm, lys, lcfg, g))],
        {"smooth_posterior": route_want({"K1": 1, "K5": 1})},
        route_want({"K1": WIDE_TRAIN, "K4": WIDE_TRAIN, "K5": WIDE_TRAIN, "K6": WIDE_TRAIN}),
        WIDE_TRAIN)
    figs["drive"]["d"]["vs"] = vs
    torch.cuda.empty_cache()
    phase_done("bh-d: Lorenz-63 PSVO at (128, 128)")

    # (e) (c) with SCAN_FUSED off
    fused_step.SCAN_FUSED = False
    n_e = cfg.data.t_steps - 1
    try:
        serve = [("make_eval_step", lambda ssm, g: pt.make_eval_step(ssm, cfg)(g, ys))]
        figs["drive"]["e"] = wide_drive(
            pt, dev, card, f"(e) FHN ({WIDE_NET}, {WIDE_NET}), SCAN_FUSED off", cfg, ys, serve,
            {"make_eval_step": route_want({"K14": n_e})}, route_want({"K14": n_e, "K15": n_e}), 1)
    finally:
        fused_step.SCAN_FUSED = True
    torch.cuda.empty_cache()
    phase_done("bh-e: FHN at (128, 128), SCAN_FUSED off")
    return figs


def wide_rows(figs: dict) -> list:
    """Phase bh's rows of the kernels' JSON record: K1, K4, K14 and K15 at
    (2, 2) for each width of WIDE, their times and bounds at (a)'s shape,
    launches from the train steps of (c) and (e) at width 128 and of (a)'s
    drives at the other widths; max_abs_err the largest of (a)'s checks at
    that width, both (Dx, Dy)."""
    rows = []
    for h in WIDE:
        fig = figs["a"][(2, 2, h)]
        if h == WIDE_NET:
            launches = {"k1": figs["drive"]["c"]["train"], "k14": figs["drive"]["e"]["train"]}
        else:
            launches = {"k1": fig["drives"][True]["train"], "k14": fig["drives"][False]["train"]}
        for kernel, kk, src, line, j, drive in (
                ("scan_forward", "k1", "scan_forward.cuh", "1327", 0, "k1"),
                ("scan_backward", "k4", "scan_backward.cuh", "1425", 1, "k1"),
                ("step_forward", "k14", "scan_forward.cuh", "954", 0, "k14"),
                ("step_backward", "k15", "scan_backward.cuh", "1013", 1, "k14")):
            name = ("K1", "K4") if drive == "k1" else ("K14", "K15")
            rows.append({
                "name": f"{kernel} (width {h}, (2, 2))", "route": "cuda",
                "source": f"psvo_tpu_torch/csrc/{src}",
                "replaces": f"psvo_tpu/ops/pallas_step.py:{line}",
                "launches": launches[drive][ROUTE_NAMES.index(name[j])], "on_path": True,
                "max_abs_err": max(figs["a"][(dx, dy, h)]["err"][kk] for dx, dy in WIDE_DIMS),
                "ms": fig["times"][kk][0], "plain_ms": fig["times"][kk][1],
                "bound_ms": fig["bounds"][kk][0], "bound_by": fig["bounds"][kk][1],
                "library_ms": None, "shape_library": fig["keys"][j],
                "chosen_c_s": fig["chosen"][("k1", "k4", "k14", "k15").index(kk)]})
    return rows


def main() -> int:
    # (a) the card
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as exc:
        fail(f"nvidia-smi: {exc}")
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(card, flush=True)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    import psvo_tpu_torch as pt
    from psvo_tpu_torch.ops import _build, fused_step

    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[a] device={name} count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda} tf32=off", flush=True)

    # (b) build
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    regs = re.findall(r"Compiling entry function '(\w+)'.*?Used (\d+) registers[^\n]*", _build.build_log(), re.S)
    spills = re.findall(r"Function properties for (\w+)\s+\d+ bytes stack frame, (\d+) bytes spill "
                        r"stores", _build.build_log())
    print(f"[b] build {build_s:.1f} s; registers "
          + ", ".join(f"{n}={r}" for n, r in regs)
          + f"; max spill stores {max((int(s) for _, s in spills), default=0)} B; spill stores "
          + (", ".join(f"{n}={s} B" for n, s in spills if int(s)) or "none"), flush=True)
    per_src = sorted(((float(t_), os.path.basename(src)) for src, t_ in re.findall(
        r"-o \S+ (\S+\.cu)\n# exit \d+ after ([\d.]+) s", _build.build_log())), reverse=True)
    print("[b] each source's compile, the slowest first: "
          + ", ".join(f"{n} {t_:.1f} s" for t_, n in per_src), flush=True)
    # phase be's shapes outside the library's: built beside phases c-, at nice 19 (waiting for
    # them here would add about 100 s to a run that takes 850-1080 s of its 1200)
    class_shapes = step_class_shapes(pt)
    reach_keys = reach_shapes(pt)
    bg_keys = [k_ for k_ in smoothing_class_shapes(pt) if k_ not in class_shapes]
    bh_keys = [k_ for k_ in wide_shapes(pt) if k_ not in class_shapes + bg_keys]
    build_shapes_beside(class_shapes + reach_keys + bg_keys + bh_keys)
    print(f"[b] phase be's shape libraries {class_shapes}, phase bf's {reach_keys}, phase "
          f"bg's {bg_keys} and phase bh's {bh_keys}: building beside the next phases at nice 19",
          flush=True)
    phase_done("a, b: card and build")

    gen = torch.Generator(device=dev).manual_seed(SEED)

    # (c) K3 on adversarial rows
    k = 1024
    rows = [
        torch.randn(k, device=dev, generator=gen) * 3,                     # generic
        torch.zeros(k, device=dev),                                        # uniform
        torch.randint(0, 3, (k,), device=dev, generator=gen).float() * -1,  # ties
        torch.where(torch.arange(k, device=dev) % 3 == 0, 0.0, -float("inf")),  # zero weights
        torch.full((k,), -3e30, device=dev),                               # all floored
        torch.where(torch.arange(k, device=dev) % 5 == 0, -1.0, -1e30),    # floored mix
        torch.full((k,), -50.0, device=dev).index_fill_(0, torch.tensor([517], device=dev), 0.0),  # dominant
        torch.linspace(-100.0, 0.0, k, device=dev),                        # wide spread
    ]
    logw = torch.stack(rows).contiguous()
    u0 = torch.tensor([0.0, 0.5, 0.25, 0.99999994, 0.125, 0.7, 0.3, 0.999], device=dev)
    idx_k = fused_step.ancestor_indices(logw, u0)
    idx_r = fused_step.ancestor_indices_reference(logw, u0)
    torch.cuda.synchronize()
    mism = (idx_k != idx_r).nonzero().tolist()
    for b, i in mism:  # boundary distance of every mismatch
        m = logw[b].max()
        cdf = torch.cumsum(torch.exp(logw[b] - m).double(), 0)
        target = fused_step.systematic_positions(u0[b:b + 1], k)[0, i].double() * cdf[-1]
        print(f"[c] mismatch row {b} particle {i}: kernel {int(idx_k[b, i])} plain "
              f"{int(idx_r[b, i])}, boundary distance {float((cdf - target).abs().min()):.3e}")
    bl = torch.randn((32, k), device=dev, generator=gen) * 3
    bu = torch.rand(32, device=dev, generator=gen)
    k3_ms = time_ms(lambda: fused_step.ancestor_indices(bl, bu), reps=20)
    k3_plain = time_ms(lambda: fused_step.ancestor_indices_reference(bl, bu), reps=20)
    k3_err = int((fused_step.ancestor_indices(bl, bu) != fused_step.ancestor_indices_reference(bl, bu)).sum())
    print(f"[c] K3 ancestor_indices: {len(mism)} mismatches on {logw.shape[0]} adversarial rows, "
          f"{k3_err} on [32, {k}] random rows; {k3_ms:.4f} ms vs plain {k3_plain:.4f} ms", flush=True)
    if mism or k3_err:
        fail("K3 disagrees with the plain indices")
    phase_done("c")

    # (d) K2 vs plain Philox at the slice shape, both designs
    seed = (0x1234ABCD, 0x0F0F1234)
    t1, b_, dx = 99, 32, 2
    k2 = k2_check(seed, t1, b_, dx, k, dev, "d")
    phase_done("d")

    # (e) K1 stream mode vs plain, small and full
    results = {}
    for label, small in (("small", True), ("full", False)):
        cfg, batch = slice_config(small)
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
        ys = torch.randn((batch, cfg.data.t_steps, 2), device=dev, generator=gen)
        with torch.no_grad():
            r = check_scan(label, ssm, cfg, ys, gen, tol=2e-4)
        results[label] = r
        print(f"[e] K1 stream {label} B={batch} K={cfg.smc.n_particles} T={cfg.data.t_steps} "
              f"hidden={cfg.net('q1').hidden}: {scan_line(r)}", flush=True)
        if not scan_ok(r, small):
            fail(f"K1 (stream mode, {label}) disagrees with scan_forward_reference")
    phase_done("e")

    # (f) K1 in-kernel RNG vs the plain path on K2's streams
    for label, small in (("small", True), ("full", False)):
        cfg, batch = slice_config(small)
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 1), device=dev)
        ys = torch.randn((batch, cfg.data.t_steps, 2), device=dev, generator=gen)
        with torch.no_grad():
            r = check_scan(label, ssm, cfg, ys, gen, tol=2e-4, rng_seed=(7, 0xDEADBEEF))
        print(f"[f] K1 in-kernel RNG {label}: bit-equal to K1 on K2's streams; vs the plain "
              f"replay {scan_line(r)}", flush=True)
        if not scan_ok(r, small):
            fail(f"K1 (in-kernel RNG, {label}) disagrees with the plain replay")
    phase_done("f")

    # (g) serving through its entry points
    cfg, batch = slice_config(small=False)
    ds = pt.generate_dataset(cfg.data, SEED)
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    obs = torch.cat([ds.obs_test, ds.obs_train]).to(dev)
    batches = [obs[i * batch:(i + 1) * batch].contiguous() for i in range(3)]
    eval_step = pt.make_eval_step(ssm, cfg)
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    fused_step.scan_forward.launches = 0
    fused_step.scan_forward_reference.calls = 0
    fused_step.stream_noise_reference.calls = 0
    t0 = time.perf_counter()
    metrics = [eval_step(run_gen, ys) for ys in batches]
    means, parts, lws = pt.filter_posterior(ssm, batches[0], cfg, return_particles=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_step.scan_forward.launches
    plain_calls = fused_step.scan_forward_reference.calls + fused_step.stream_noise_reference.calls
    elbos = [float(m["elbo"]) for m in metrics]
    r2_1 = [float(m["r2_k"][0]) for m in metrics]
    shapes_ok = (tuple(means.shape) == (batch, 100, 2) and tuple(parts.shape) == (batch, 100, 1024, 2)
                 and tuple(lws.shape) == (batch, 100, 1024))
    finite = all(math.isfinite(e) for e in elbos) and bool(torch.isfinite(means).all())
    with torch.no_grad():
        inp = kernel_inputs(ssm, cfg, batches[0], gen)
        seed = (11, 13)
        eps, u0 = fused_step.stream_noise(seed, 99, batch, 2, 1024, dev)
        pos = fused_step.systematic_positions(u0, 1024)
        args = (inp["x0"], inp["alpha0"], inp["coef"], inp["consts"])
        k1_ms = time_ms(lambda: fused_step.scan_forward(*args, seed=seed))
        k1_plain = time_ms(lambda: fused_step.scan_forward_reference(*args, eps, pos))
        k1_ms_2 = time_ms(lambda: fused_step.scan_forward(*args, seed=seed))
        k1_plain_2 = time_ms(lambda: fused_step.scan_forward_reference(*args, eps, pos))
        ev_ms = time_ms(lambda: eval_step(run_gen, batches[0]))
    print(f"[g] serving fhn_fivo_k1024_bench: ELBO per batch {[round(e, 3) for e in elbos]}, "
          f"R2(1) {[round(v, 4) for v in r2_1]}, K1 launches {launches} for 4 forwards, "
          f"plain-version calls {plain_calls}, shapes ok {shapes_ok}, wall {wall:.2f} s; "
          f"K1 forward {k1_ms:.3f}/{k1_ms_2:.3f} ms vs plain {k1_plain:.3f}/{k1_plain_2:.3f} ms "
          f"(kernel/plain alternated, median of 5 after 2 warm-up); eval_step {ev_ms:.3f} ms", flush=True)
    if launches != 4 or plain_calls != 0:
        fail(f"serving path launched K1 {launches} times (want 4), plain versions {plain_calls}")
    if not (finite and shapes_ok):
        fail("slice outputs non-finite or of the wrong shape")
    phase_done("g")

    t1, k = inp["coef"].shape[0], inp["x0"].shape[-1]
    # reads x0, alpha0, coef and the weights; writes x_last, alpha_last and stats
    k1_bound, k1_by = bound(trunk_flops(inp["consts"]) * t1 * batch * k,
                            2 * nbytes(*args[:2]) + nbytes(args[2], inp["consts"]["packed"],
                                                           inp["consts"]["sconst"])
                            + t1 * batch * (2 + 2) * 4)

    # (h) K4 vs its plain version on one K1 run's residuals
    leaves = ("d_x0", "d_coef", "d_weights", "d_sconst")
    bwd = {}
    for label, small in (("small", True), ("full", False)):
        cfg, batch = slice_config(small)
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 2), device=dev)
        ys = torch.randn((batch, cfg.data.t_steps, 2), device=dev, generator=gen)
        modes = [("stream", None, False), ("in-kernel RNG", (3, 0xC0FFEE), False)]
        if small:
            modes.append(("stream, cache cotangents", None, True))
        for mode, rng_seed, cache in modes:
            with torch.no_grad():
                r = check_backward(ssm, cfg, ys, gen, rng_seed, cache)
            bwd[(label, mode)] = r
            tol = 1e-4 if small else 1e-3
            print(f"[h] K4 {label} B={batch} K={cfg.smc.n_particles} T={cfg.data.t_steps} {mode}: "
                  + ", ".join(f"{n} rel L2 {e:.3e} max|d| {m:.3e}"
                              for n, e, m in zip(leaves, r["rel"], r["maxd"]))
                  + f"; idx nondecreasing {r['monotone']}; bound rel L2 {tol:g}", flush=True)
            if not r["monotone"]:
                fail("K1's ancestor indices are not nondecreasing: K4's segmented scatter needs them so")
            if not (r["finite"] and max(r["rel"]) <= tol):
                fail(f"K4 ({label}, {mode}) disagrees with scan_backward_reference")
    full = bwd[("full", "in-kernel RNG")]
    with torch.no_grad():
        k4_ms = time_ms(full["kernel"])
        k4_plain = time_ms(full["plain"], reps=1, warmup=1)
        k4_ms_2 = time_ms(full["kernel"])
        k4_plain_2 = time_ms(full["plain"], reps=1, warmup=0)
    k4_bound, k4_by = bound(full["flops"], full["n_bytes"])
    print(f"[h] K4 full, in-kernel RNG: {k4_ms:.3f}/{k4_ms_2:.3f} ms vs plain "
          f"{k4_plain:.3f}/{k4_plain_2:.3f} ms (kernel/plain alternated, the kernel the median of "
          f"5 after 2 warm-up, the plain version one run each, after one warm-up); bound {k4_bound:.3f} ms ({k4_by}: {full['flops']:.3e} FLOP, "
          f"{full['n_bytes'] / 1e6:.1f} MB)", flush=True)
    phase_done("h")

    # (i) training through make_train_step: TRAIN_CALLS calls of steps_per_call steps
    cfg, batch = slice_config(small=False)
    n_per_call = cfg.train.steps_per_call
    ds = pt.generate_dataset(cfg.data, SEED)
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    train_step = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
    obs = ds.obs_train.to(dev)
    pick = torch.randint(0, obs.shape[0], (TRAIN_CALLS, n_per_call, batch),
                         generator=torch.Generator().manual_seed(SEED + 7))
    train_batches = [obs[p.to(dev)].contiguous() for p in pick]  # [10, B, T, Dy] each
    before = [p.detach().clone() for p in ssm.parameters()]
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9  # what earlier phases still hold
    plain_fns = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
                 fused_step.stream_noise_reference, fused_step.ancestor_indices_reference)
    for fn in plain_fns:
        fn.calls = 0
    fused_step.scan_forward.launches = 0
    fused_step.scan_backward.launches = 0
    call_s, train_metrics = [], []
    for bt in train_batches:
        t0 = time.perf_counter()
        train_metrics.append(train_step(run_gen, bt))
        torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t0)
    k1_train, k4_train = fused_step.scan_forward.launches, fused_step.scan_backward.launches
    plain_calls = sum(fn.calls for fn in plain_fns)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(m["loss"]) for m in train_metrics]
    norms = [float(m["grad_norm"]) for m in train_metrics]
    moved = any(not torch.equal(a, p) for a, p in zip(before, ssm.parameters()))
    step_ms = statistics.median(call_s[1:]) / n_per_call * 1e3
    print(f"[i] training fhn_fivo_k1024_bench: {len(train_batches)} calls x {n_per_call} steps, "
          f"B={batch}: loss per call {[round(v, 3) for v in losses]}, grad norm "
          f"{[round(v, 3) for v in norms]}, parameters moved {moved}; K1 launches {k1_train}, "
          f"K4 launches {k4_train}, plain-version calls {plain_calls}; call times "
          f"{[round(v, 3) for v in call_s]} s, train step {step_ms:.3f} ms (median of the calls "
          f"after the first, per step); K4 {k4_ms:.3f} ms vs plain {k4_plain:.3f} ms; peak "
          f"device memory {peak_gb:.3f} GB, of which earlier phases held {held_gb:.3f} GB "
          f"before the run", flush=True)
    profile = device_breakdown(lambda: train_step(run_gen, train_batches[0]), n_per_call,
                               FHN_KERNELS)
    print(f"[i] profile of one more call: {profile}", flush=True)
    want = len(train_batches) * n_per_call
    if k1_train != want or k4_train != want or plain_calls != 0:
        fail(f"train path launched K1 {k1_train} and K4 {k4_train} times (want {want} each), "
             f"plain versions {plain_calls}")
    if not (all(math.isfinite(v) for v in losses + norms) and moved):
        fail("training gave non-finite losses or gradient norms, or left the parameters as they were")
    phase_done("i")

    # (j) K1 and K4 at the Lorenz-63 shape, on Lorenz-63 observations
    l63 = "lorenz63_psvo_k1024"
    lcfg = pt.PRESETS[l63]
    lds = pt.generate_dataset(lcfg.data, SEED)
    l_obs = torch.cat([lds.obs_test, lds.obs_train]).to(dev)
    for label, small in (("small", True), ("full", False)):
        cfg, batch = slice_config(small, l63)
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 3), device=dev)
        ys = l_obs[:batch, :cfg.data.t_steps].contiguous()
        with torch.no_grad():
            r = check_scan(label, ssm, cfg, ys, gen, tol=2e-4)
        print(f"[j] K1 Lorenz-63 stream {label} B={batch} K={cfg.smc.n_particles} "
              f"T={cfg.data.t_steps} hidden={cfg.net('q1').hidden}: {scan_line(r)}", flush=True)
        if not scan_ok(r, small):
            fail(f"K1 (Lorenz-63, {label}) disagrees with scan_forward_reference")
        for mode, cache in (("stream", False), ("stream, cache cotangents", True)):
            with torch.no_grad():
                rb = check_backward(ssm, cfg, ys, gen, None, cache)
            tol = 1e-4 if small else 1e-3
            print(f"[j] K4 Lorenz-63 {label} {mode}: "
                  + ", ".join(f"{n} rel L2 {e:.3e} max|d| {m:.3e}"
                              for n, e, m in zip(leaves, rb["rel"], rb["maxd"]))
                  + f"; idx nondecreasing {rb['monotone']}; bound rel L2 {tol:g}", flush=True)
            if not rb["monotone"]:
                fail("K1's ancestor indices are not nondecreasing (Lorenz-63)")
            if not (rb["finite"] and max(rb["rel"]) <= tol):
                fail(f"K4 (Lorenz-63, {label}, {mode}) disagrees with scan_backward_reference")
    with torch.no_grad():  # times at full size: K1 with cache, K4 with the cache cotangents
        inp = kernel_inputs(ssm, cfg, ys, gen)
        args = (inp["x0"], inp["alpha0"], inp["coef"], inp["consts"])
        noise = dict(eps=inp["eps"], positions=inp["positions"], cache=True)
        k1l = [time_ms(lambda: fused_step.scan_forward(*args, **noise)),
               time_ms(lambda: fused_step.scan_forward_reference(*args, inp["eps"], inp["positions"],
                                                                 cache=True))]
        k1l += [time_ms(lambda: fused_step.scan_forward(*args, **noise)),
                time_ms(lambda: fused_step.scan_forward_reference(*args, inp["eps"], inp["positions"],
                                                                  cache=True))]
        k4l_run = rb
        k4l = [time_ms(rb["kernel"]), time_ms(rb["plain"], reps=1, warmup=1),
               time_ms(rb["kernel"]), time_ms(rb["plain"], reps=1, warmup=0)]
    outs_l = fused_step.scan_forward(*args, **noise)
    t1, k = inp["coef"].shape[0], inp["x0"].shape[-1]
    k1l_bound, k1l_by = bound(trunk_flops(inp["consts"]) * t1 * batch * k,
                              nbytes(*args[:3], inp["consts"]["packed"], inp["consts"]["sconst"],
                                     inp["eps"], inp["positions"], *outs_l[:5]))
    k4l_bound, k4l_by = bound(k4l_run["flops"], k4l_run["n_bytes"])
    print(f"[j] Lorenz-63 full: K1 (stream, cache) {k1l[0]:.3f}/{k1l[2]:.3f} ms vs plain "
          f"{k1l[1]:.3f}/{k1l[3]:.3f} ms, bound {k1l_bound:.3f} ms ({k1l_by}); K4 (cache "
          f"cotangents) {k4l[0]:.3f}/{k4l[2]:.3f} ms vs plain {k4l[1]:.3f}/{k4l[3]:.3f} ms, bound "
          f"{k4l_bound:.3f} ms ({k4l_by}); shared memory of K4 "
          f"{fused_step.k4_smem_bytes(inp['consts'], k)} B", flush=True)
    phase_done("j")

    # (k) K5 and K6 vs their plain versions on the cache of one K1 run
    from psvo_tpu_torch.ops import ffbsi

    sweeps = {}
    for label, small in (("small", True), ("full", False)):
        cfg, batch = slice_config(small, l63)
        if small:
            cfg = dataclasses.replace(cfg, smc=dataclasses.replace(cfg.smc, n_smoothing_particles=8))
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 4), device=dev)
        ys = l_obs[:batch, :cfg.data.t_steps].contiguous()
        with torch.no_grad():
            ops = ffbsi_operands(ssm, cfg, ys, gen)
            rf = check_ffbsi(ops, gen)
        sweeps[label] = (ops, rf)
        tol = 1e-4 if small else 1e-3
        print(f"[k] K5 {label} B={batch} M={ops[0].shape[1]} K={cfg.smc.n_particles} "
              f"T={cfg.data.t_steps}: {rf['flips']} differing selections in {rf['flip_paths']} "
              f"paths; paths without: x~ equal {rf['same_x']}, max rel d logp {rf['rel_logp']:.3e}, "
              f"logq {rf['rel_logq']:.3e}; max|d| {rf['max_abs_err']:.3e}", flush=True)
        for mode, rb in rf["bwd"].items():
            dc = k6_design_check(rb["args"], rb["kw"], rb["needs"])
            print(f"[k] K6 {label} {mode} (staged): per-leaf rel L2 against the plain version "
                  + ", ".join(f"{e:.3e}" for e in rb["rel"]) + " (d_x_anchor, d_xs, then the "
                  f"wanted ones of d_r, d_mr, d_c, d_lwn, d_lg), max|d| {max(rb['maxd']):.3e}; "
                  f"bound rel L2 {tol:g}; against the row design "
                  + ("bit-equal" if dc["equal"] else "max rel L2 " + f"{max(dc['rel']):.3e}")
                  + f"; bit-equal on relaunch {dc['relaunch']}", flush=True)
            if not (rb["finite"] and rb["nones"] and dc["relaunch"] and dc["finite"]):
                fail(f"K6 ({label}, {mode}): non-finite, a leaf wrongly None, or not bit-equal on "
                     f"relaunch")
            if mode == "direct bound":
                with torch.no_grad():
                    plain = ffbsi.ffbsi_backward_reference(*rb["args"], needs=rb["needs"], **rb["kw"])
                d_st, d_pl, d_rw = k6_wide_check(rb["args"], rb["kw"], rb["needs"], dc["staged"],
                                                 plain, dc["row"])
                print(f"[k] K6 {label} direct bound: per-leaf rel L2 to the float64 plain replay, "
                      f"staged {', '.join(f'{e:.3e}' for e in d_st)}; float32 plain "
                      f"{', '.join(f'{e:.3e}' for e in d_pl)}; row "
                      f"{', '.join(f'{e:.3e}' for e in d_rw)}", flush=True)
                if not all(a <= max(tol, 2 * p_) and a <= max(1e-5, 2 * r_)
                           for a, p_, r_ in zip(d_st, d_pl, d_rw)):
                    fail(f"K6 ({label}, direct bound): the staged design is further from the "
                         f"float64 replay than the plain version or the row design")
                continue
            if max(rb["rel"]) > tol:
                fail(f"K6 ({label}, {mode}) disagrees with ffbsi_backward_reference")
            if not (max(dc["rel"]) <= 1e-5 and (mode != "paths only" or dc["equal"])):
                fail(f"K6 ({label}, {mode}): the staged design disagrees with the row design")
        if not (rf["finite"] and rf["same_x"] and rf["rel_logq"] <= 1e-5 and rf["rel_logp"] <= 1e-5):
            fail(f"K5 ({label}) disagrees with ffbsi_forward_reference")
        if small and rf["flips"]:
            fail("K5 (small) picked other particles than its plain version")
        # the staged design against the previous one on the same operands
        with torch.no_grad():
            prev = ffbsi.ffbsi_forward(*ops, design="path")
        torch.cuda.synchronize()
        kern = rf["kern"]
        equal = [torch.equal(kern[i], prev[i]) for i in (4, 3, 0, 1)]
        rel_q = float(((kern[2] - prev[2]).abs() / prev[2].abs().clamp_min(1e-30)).max())
        p_k5 = ffbsi.k5_paths(batch, ops[0].shape[1], n_sms)
        print(f"[k] K5 {label}, staged ({p_k5} paths a CTA, chunk "
              f"{ffbsi.k5_chunk(ops[1].shape[2], ops[1].shape[3], p_k5)} particles) against the "
              f"previous design (path): sel, x~, x_first, logp equal {equal}; logq max "
              f"rel {rel_q:.3e} (bound 1e-06)", flush=True)
        if not (all(equal) and rel_q <= 1e-6):
            fail(f"K5 ({label}): the staged design disagrees with the previous one")
    ops, rf = sweeps["full"]
    with torch.no_grad():
        k5_pairs = [tuple(pair_ms(lambda: ffbsi.ffbsi_forward(*ops, design=d))
                          for d in ("staged", "path")) for _ in range(3)]
        k5 = [statistics.mean(p_[0] for p_ in k5_pairs),
              time_ms(lambda: ffbsi.ffbsi_forward_reference(*ops))]
        k5 += [statistics.mean(p_[1] for p_ in k5_pairs),
               time_ms(lambda: ffbsi.ffbsi_forward_reference(*ops))]
        k6 = {}  # mode: (staged, row) device ms alternated, three pairs; plain ms (events)
        for mode, rb in rf["bwd"].items():
            a_, kw_, n_ = rb["args"], rb["kw"], rb["needs"]
            pairs = [tuple(pair_ms(lambda: ffbsi.ffbsi_backward(*a_, needs=n_, design=d, **kw_))
                           for d in ffbsi.K6_DESIGNS) for _ in range(3)]
            k6[mode] = dict(pairs=pairs, plain=time_ms(rb["plain"]),
                            ms=statistics.mean(p_[0] for p_ in pairs),
                            ms_prev=statistics.mean(p_[1] for p_ in pairs))
    t1, batch, m, dx, k = ops[1].shape[0], ops[1].shape[1], ops[0].shape[1], ops[1].shape[2], ops[1].shape[3]
    n_pair = t1 * batch * m * k
    # K5: per (t, b, m, j) the pair (5 operations per state dimension and 3 more), the
    # logit, the Gumbel add and compare, and the running exp-sum: 5·Dx + 8.
    k5_bound, k5_by = bound((5 * dx + 8) * n_pair, k5_bytes(ops, rf["kern"]))
    # K6 with pair cotangents: one evaluation of the pair with its floor and logit
    # (5·Dx + 6), the exp and the sums e, e·mr, e·r (2·Dx + 3), d_pair and its
    # per-particle sums (2·Dx + 9) per (t, b, m, j); on the paths alone one selection
    # compare per (t, b, m, j).
    k6_cost = {mode: (9 * dx + 18) * n_pair for mode in k6}
    k6_cost["paths only"] = n_pair
    k6_bound = {mode: bound(k6_cost[mode], rb["n_bytes"]) for mode, rb in rf["bwd"].items()}
    k5_p = ffbsi.k5_paths(batch, m, n_sms)
    print(f"[k] K5 full, device time per call ({PAIR_HOW}), "
          f"(staged, path) "
          f"alternated: " + ", ".join(f"({a:.4f}, {b_:.4f})" for a, b_ in k5_pairs)
          + f" ms; staged {kernel_resources(f'ffbsi_staged_kernelILi{dx}ELi{k5_p}ELb{int(ffbsi.k5_chunk(dx, k, k5_p) >= k)}EE')}, "
          f"{ffbsi.k5_smem_bytes(dx, k, k5_p)} B of dynamic shared memory ({k5_p} paths a CTA, "
          f"{batch * -(-m // k5_p)} CTAs, {ffbsi.k5_slots(dx, k, k5_p)} slots); path "
          f"{kernel_resources(f'ffbsi_forward_kernelILi{dx}EE')}", flush=True)
    if not all(a < b_ for a, b_ in k5_pairs):
        fail("K5: the staged design is not faster than the previous one in every pair")
    print(f"[k] full: K5 staged {k5[0]:.4f} ms (dev), path {k5[2]:.4f} ms (dev) vs plain "
          f"{k5[1]:.3f}/{k5[3]:.3f} ms, bound {k5_bound:.4f} ms ({k5_by})", flush=True)
    for mode, v in k6.items():
        print(f"[k] full: K6 {mode}, device time ({PAIR_HOW}) (staged, "
              f"row) alternated: "
              + ", ".join(f"({a:.4f}, {b_:.4f})" for a, b_ in v["pairs"])
              + f" ms; plain {v['plain']:.3f} ms (events); bound {k6_bound[mode][0]:.4f} ms "
              f"({k6_bound[mode][1]})", flush=True)
        if not all(a < b_ for a, b_ in v["pairs"]):
            fail(f"K6 ({mode}): the staged design is not faster than the row design in every pair")
    print(f"[k] K6 staged: all-cotangents kernel "
          f"{kernel_resources(f'ffbsi_bwd_staged_kernelILi{dx}ELi{ffbsi.K6_GROUP}ELb1EE')}, "
          f"{ffbsi.k6_smem_bytes(dx, m, k)} B of dynamic shared memory, a persistent CTA per slot "
          f"the card holds; paths-only kernel {kernel_resources(f'ffbsi_bwd_paths_kernelILi{dx}EE')}; "
          f"row design {kernel_resources(f'ffbsi_backward_kernelILi{dx}EE')}", flush=True)
    # K6 off the preset's shapes: M = 256, and K = 8192 (chunked rows), on a generator of
    # their own (the later phases' draws stay as they were)
    gen_x = torch.Generator(device=dev).manual_seed(SEED + 31)
    for label, (b_x, m_x, k_x, t_x) in (("M=256", (8, 256, 1024, 20)), ("K=8192", (2, 16, 8192, 20))):
        args_x, fwd_x = ffbsi_sweep(dev, 3, b_x, m_x, k_x, t_x, gen_x)
        cots_x = [torch.randn(t_.shape, generator=gen_x, device=dev) for t_ in fwd_x[:4]]
        for mode, (live, needs) in K6_MODES.items():
            kw_x = {n_: cots_x[i] if i in live else None
                    for i, n_ in enumerate(("d_x_first", "d_logp", "d_logq", "d_xtilde"))}
            with torch.no_grad():
                got = ffbsi.ffbsi_backward(*args_x, needs=needs, **kw_x)
            want = ffbsi.ffbsi_backward_reference(*args_x, needs=needs, **kw_x)
            rel = [float((g_ - w_).norm() / w_.norm().clamp_min(1e-30))
                   for g_, w_ in zip(got, want) if w_ is not None]
            dc = k6_design_check(args_x, kw_x, needs)
            print(f"[k] K6 {label} (B={b_x}, M={m_x}, K={k_x}, T-1={t_x}) {mode}: max rel L2 against "
                  f"the plain version {max(rel):.3e} (bound 1e-3), against the row design "
                  + ("bit-equal" if dc["equal"] else f"{max(dc['rel']):.3e}")
                  + f", bit-equal on relaunch {dc['relaunch']}", flush=True)
            if not (dc["finite"] and dc["relaunch"]):
                fail(f"K6 at {label} ({mode}): non-finite or not bit-equal on relaunch")
            if mode == "direct bound":
                d_st, d_pl, d_rw = k6_wide_check(args_x, kw_x, needs, dc["staged"], want, dc["row"])
                print(f"[k] K6 {label} direct bound: max rel L2 to the float64 plain replay, staged "
                      f"{max(d_st):.3e}, float32 plain {max(d_pl):.3e}, row {max(d_rw):.3e}", flush=True)
                if not all(a <= max(1e-3, 2 * p_) and a <= max(1e-5, 2 * r_)
                           for a, p_, r_ in zip(d_st, d_pl, d_rw)):
                    fail(f"K6 at {label} (direct bound): the staged design is further from the "
                         f"float64 replay than the plain version or the row design")
            elif not (max(rel) <= 1e-3 and max(dc["rel"]) <= 1e-5
                      and (mode != "paths only" or dc["equal"])):
                fail(f"K6 at {label} ({mode}) disagrees with the plain version or the row design")
        del args_x, fwd_x, cots_x
    phase_done("k")

    # (l) serving: smooth_posterior on three batches of 32 Lorenz-63 trajectories
    cfg, batch = lcfg, 32
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    l_batches = [l_obs[i * batch:(i + 1) * batch].contiguous() for i in range(3)]
    l_plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
               fused_step.stream_noise_reference, fused_step.ancestor_indices_reference,
               ffbsi.ffbsi_forward_reference, ffbsi.ffbsi_backward_reference)
    for fn in l_plain:
        fn.calls = 0
    fused_step.scan_forward.launches = ffbsi.ffbsi_forward.launches = 0
    zero_designs(ffbsi.ffbsi_forward)
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    t0 = time.perf_counter()
    paths = [pt.smooth_posterior(ssm, ys, cfg, run_gen) for ys in l_batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_serve, k5_serve = fused_step.scan_forward.launches, ffbsi.ffbsi_forward.launches
    k5_serve_designs = dict(ffbsi.ffbsi_forward.launches_by_design)
    plain_calls = sum(fn.calls for fn in l_plain)
    shapes_ok = all(tuple(p.shape) == (batch, 16, 100, 3) for p in paths)
    finite = all(bool(torch.isfinite(p).all()) for p in paths)
    sp_ms = [time_ms(lambda: pt.smooth_posterior(ssm, l_batches[0], cfg, run_gen)) for _ in range(2)]
    print(f"[l] serving {l63}: smooth_posterior x3 -> shapes {[tuple(p.shape) for p in paths]} "
          f"ok {shapes_ok}, finite {finite}, K1 launches {k1_serve}, K5 launches {k5_serve} (by "
          f"design {k5_serve_designs}), plain-version calls {plain_calls}, wall {wall:.2f} s; smooth_posterior "
          f"{sp_ms[0]:.3f}/{sp_ms[1]:.3f} ms per call of B={batch} (median of 5 after 2 warm-up)",
          flush=True)
    profile = device_breakdown(lambda: pt.smooth_posterior(ssm, l_batches[0], cfg, run_gen), 1,
                               PSVO_KERNELS)
    print(f"[l] profile of one more call: {profile}", flush=True)
    if k1_serve != 3 or k5_serve != 3 or plain_calls != 0 or k5_serve_designs != {"staged": 3, "path": 0}:
        fail(f"smooth_posterior launched K1 {k1_serve} and K5 {k5_serve} times (want 3 each, every "
             f"K5 launch the staged design: {k5_serve_designs}), plain versions {plain_calls}")
    if not (shapes_ok and finite):
        fail("smooth_posterior gave non-finite paths or the wrong shape")
    phase_done("l")

    # (m) training through make_train_step: 3 calls of steps_per_call PSVO steps
    n_per_call = cfg.train.steps_per_call
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    train_step = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
    obs = lds.obs_train.to(dev)
    pick = torch.randint(0, obs.shape[0], (TRAIN_CALLS, n_per_call, batch),
                         generator=torch.Generator().manual_seed(SEED + 7))
    train_batches = [obs[p.to(dev)].contiguous() for p in pick]
    before = [p.detach().clone() for p in ssm.parameters()]
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_psvo_gb = torch.cuda.memory_allocated() / 1e9
    l_kernels = (fused_step.scan_forward, fused_step.scan_backward, ffbsi.ffbsi_forward,
                 ffbsi.ffbsi_backward)
    for fn in l_plain:
        fn.calls = 0
    for fn in l_kernels:
        fn.launches = 0
    zero_designs(ffbsi.ffbsi_forward, ffbsi.ffbsi_backward)
    call_s, train_metrics = [], []
    for bt in train_batches:
        t0 = time.perf_counter()
        train_metrics.append(train_step(run_gen, bt))
        torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t0)
    psvo_launches = [fn.launches for fn in l_kernels]
    k5_train_designs = dict(ffbsi.ffbsi_forward.launches_by_design)
    k6_train_designs = dict(ffbsi.ffbsi_backward.launches_by_design)
    plain_calls = sum(fn.calls for fn in l_plain)
    peak_psvo_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(m_["loss"]) for m_ in train_metrics]
    norms = [float(m_["grad_norm"]) for m_ in train_metrics]
    em = [float(m_["log_joint_smoothed"]) for m_ in train_metrics]
    moved = any(not torch.equal(a, p) for a, p in zip(before, ssm.parameters()))
    psvo_step_ms = statistics.median(call_s[1:]) / n_per_call * 1e3
    print(f"[m] training {l63}: {len(train_batches)} calls x {n_per_call} steps, B={batch}: loss "
          f"per call {[round(v, 3) for v in losses]}, grad norm {[round(v, 3) for v in norms]}, "
          f"log_joint_smoothed {[round(v, 2) for v in em]}, parameters moved {moved}; launches "
          f"K1/K4/K5/K6 {psvo_launches} (K5 by design {k5_train_designs}, K6 {k6_train_designs}), "
          f"plain-version calls {plain_calls}; call times "
          f"{[round(v, 3) for v in call_s]} s, train step {psvo_step_ms:.3f} ms (median of the calls "
          f"after the first, per step); peak device memory {peak_psvo_gb:.3f} GB, of which earlier "
          f"phases held {held_psvo_gb:.3f} GB before the run", flush=True)
    profile = device_breakdown(lambda: train_step(run_gen, train_batches[0]), n_per_call,
                               PSVO_KERNELS)
    print(f"[m] profile of one more call: {profile}", flush=True)
    want = len(train_batches) * n_per_call
    if (psvo_launches != [want] * 4 or plain_calls != 0
            or k5_train_designs != {"staged": want, "path": 0}
            or k6_train_designs != {"staged": want, "row": 0}):
        fail(f"PSVO train path launched K1/K4/K5/K6 {psvo_launches} times (want {want} each, every "
             f"K5 and K6 launch the staged design: {k5_train_designs}, {k6_train_designs}), plain "
             f"versions {plain_calls}")
    if not (all(math.isfinite(v) for v in losses + norms) and moved):
        fail("PSVO training gave non-finite losses or gradient norms, or left the parameters as they were")
    phase_done("m")

    # (n) K2 at the Lorenz-96 width vs the plain Philox, both designs
    from psvo_tpu_torch.ops import resample_gather as rg
    from psvo_tpu_torch.ops import trunk

    l_cfg, l_batch = l96_config(small=False)
    lk = l_cfg.smc.n_particles
    seed40 = (0x2468ACE0, 0x13579BDF)
    k2l = k2_check(seed40, 3, l_batch, 40, lk, dev, "n")
    phase_done("n")

    # (o) K7 and K8 vs their plain versions, adversarial rows, small and full
    for label, kk, dd in (("small", 128, 40), ("full", lk, 40)):
        lw = weight_rows(kk, gen)
        pos = fused_step.systematic_positions(torch.rand(lw.shape[0], device=dev, generator=gen),
                                              kk).contiguous()
        idx7 = rg.ancestor_indices_large(lw, pos)
        again = rg.ancestor_indices_large(lw, pos)
        idx7_row = rg.ancestor_indices_large(lw, pos, design="row")
        idx7_r = rg.ancestor_indices_large_reference(lw, pos)
        xg = torch.randn((lw.shape[0], dd, kk), device=dev, generator=gen)
        out8 = rg.gather_particles(xg, idx7)
        out8_r = rg.gather_particles_reference(xg, idx7)
        torch.cuda.synchronize()
        k7_bad = int((idx7 != idx7_r).sum())
        k7_bad_row = int((idx7 != idx7_row).sum())
        row_bad = int((idx7_row != idx7_r).sum())
        k7_same = bool(torch.equal(idx7, again))
        k8_equal = bool(torch.equal(out8, out8_r))
        dominant = int(idx7[6].unique().numel())
        print(f"[o] K7/K8 {label} [8, {kk}], D={dd}: K7 cluster design (C = "
              f"{rg.k7_cluster(8, kk, n_sms)}) mismatches {k7_bad} against the "
              f"plain version, {k7_bad_row} against the row design (row against plain {row_bad}), "
              f"same indices on a second launch {k7_same}; K8 bit-equal {k8_equal} (the "
              f"dominant-particle row draws {dominant} distinct ancestor(s))", flush=True)
        if k7_bad or k7_bad_row or row_bad or not k7_same or not k8_equal or dominant != 1:
            fail(f"K7/K8 ({label}) disagree with their plain versions or K7's designs disagree")
    lw = torch.randn((l_batch, lk), device=dev, generator=gen) * 3
    pos = fused_step.systematic_positions(torch.rand(l_batch, device=dev, generator=gen), lk)
    pos = pos.contiguous()
    idx7 = rg.ancestor_indices_large(lw, pos)
    xg = torch.randn((l_batch, 40, lk), device=dev, generator=gen)
    idx64 = idx7.long()[:, None, :].expand(-1, 40, -1)
    k7 = [time_ms(lambda: rg.ancestor_indices_large(lw, pos), reps=20),
          time_ms(lambda: rg.ancestor_indices_large_reference(lw, pos), reps=20)]
    k8 = [time_ms(lambda: rg.gather_particles(xg, idx7), reps=20),
          time_ms(lambda: rg.gather_particles_reference(xg, idx7), reps=20),
          time_ms(lambda: torch.gather(xg, -1, idx64), reps=20)]
    k7 += [time_ms(lambda: rg.ancestor_indices_large(lw, pos), reps=20),
           time_ms(lambda: rg.ancestor_indices_large_reference(lw, pos), reps=20)]
    k8 += [time_ms(lambda: rg.gather_particles(xg, idx7), reps=20),
           time_ms(lambda: rg.gather_particles_reference(xg, idx7), reps=20)]
    # the cluster design and the previous one alternated, three pairs
    k7_pairs = [tuple(pair_ms(lambda: rg.ancestor_indices_large(lw, pos, design=d))
                      for d in rg.K7_DESIGNS) for _ in range(3)]
    k7_dev = [statistics.mean(p_[0] for p_ in k7_pairs),
              device_ms(lambda: rg.ancestor_indices_large_reference(lw, pos)),
              statistics.mean(p_[1] for p_ in k7_pairs)]
    k8_dev = [device_ms(lambda: rg.gather_particles(xg, idx7)),
              device_ms(lambda: rg.gather_particles_reference(xg, idx7)),
              device_ms(lambda: torch.gather(xg, -1, idx64))]
    # K7: the CDF scan and a binary search per particle; logw and positions in,
    # int32 indices out. K8: x read once, the indices, x_res written once.
    k7_bound, k7_by = bound(2.0 * lw.numel() * (1 + math.log2(lk)), nbytes(lw, pos, idx7))
    k8_bound, k8_by = bound(0.0, 2 * nbytes(xg) + nbytes(idx7))
    print(f"[o] full [8, {lk}]: K7 {k7[0]:.4f}/{k7[2]:.4f} ms vs plain {k7[1]:.4f}/{k7[3]:.4f} ms, "
          f"bound {k7_bound:.5f} ms ({k7_by}); K8 (D=40) {k8[0]:.4f}/{k8[3]:.4f} ms vs plain "
          f"{k8[1]:.4f}/{k8[4]:.4f} ms, torch.gather on the int64 index {k8[2]:.4f} ms, bound "
          f"{k8_bound:.4f} ms ({k8_by}); kernel/plain alternated, CUDA events around one call, "
          f"median of 20. Device time per call (torch.profiler, 20 calls): K7 {k7_dev[0]:.4f} ms, "
          f"plain {k7_dev[1]:.4f} ms; K8 {k8_dev[0]:.4f} ms, plain {k8_dev[1]:.4f} ms, "
          f"torch.gather {k8_dev[2]:.4f} ms", flush=True)
    k7_c = rg.k7_cluster(l_batch, lk, n_sms)
    print(f"[o] K7 full [8, {lk}], device time per call ({PAIR_HOW}), "
          f"(cluster, row) "
          f"alternated: " + ", ".join(f"({a:.4f}, {b_:.4f})" for a, b_ in k7_pairs)
          + f" ms; bound {k7_bound:.5f} ms: cluster at {100 * k7_bound / k7_dev[0]:.1f}% of it, row "
          f"at {100 * k7_bound / k7_dev[2]:.1f}%; cluster C = {k7_c} ({l_batch * k7_c} CTAs), "
          f"{kernel_resources('ancestor_indices_cluster_kernel')}, "
          f"{rg.k7_cluster_smem_bytes(lk, k7_c)} B of shared memory per CTA; row "
          f"{kernel_resources('ancestor_indices_large_kernel')}, {rg.k7_smem_bytes(lk)} B",
          flush=True)
    if not all(a < b_ for a, b_ in k7_pairs):
        fail("K7: the cluster design is not faster than the row design in every pair")
    phase_done("o")

    # (p) K9 vs its plain version on every step of one kernel run
    l_ds = pt.generate_dataset(l_cfg.data, SEED)
    l_obs = torch.cat([l_ds.obs_test, l_ds.obs_train]).to(dev)
    snapshot = os.path.join(ROOT, "checkpoints", "l96_pretrained.npz")
    k9 = {}
    for label, small in (("small", True), ("full", False)):
        cfg, batch = l96_config(small)
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 6), device=dev)
        if not small:
            pt.load_params_npz(ssm, snapshot)
        ys = l_obs[:batch, :cfg.data.t_steps].contiguous()
        for mode, rng_seed in (("stream", None), ("in-kernel RNG", (17, 0xBEEF))):
            with torch.no_grad():
                r = trunk_run(ssm, cfg, ys, gen, rng_seed)
            k9[(label, mode)] = r
            print(f"[p] K9 {label} B={batch} K={cfg.smc.n_particles} T={cfg.data.t_steps} "
                  f"hidden={cfg.net('q1').hidden} {mode}: every step allclose(2e-4) {r['close']}, "
                  f"max per-step rel L2 x_new {r['rel_x']:.3e} alpha {r['rel_a']:.3e}, max|d| "
                  f"{r['maxd']:.3e}, finite {r['finite']}"
                  + (f", bit-equal to stream mode on K2's eps {r['same']}" if rng_seed else "")
                  + f", every step bit-equal to the previous design (tile) {r['same_tile']}"
                  + f"; K7 index mismatches against its plain version, every step {r['k7_bad']}"
                  + f"; free runs: {r['flip_rows']} of {batch} rows with an ancestor flip (first "
                  f"flip step per row {r['first_flips']}), max rel d logZ {r['rel_z']:.3e}, over "
                  f"rows without "
                  + ("none (no row without)" if r["rel_z_clean"] is None
                     else f"{r['rel_z_clean']:.3e}"), flush=True)
            ok = (r["close"] if small else max(r["rel_x"], r["rel_a"]) <= 1e-4) \
                and (r["rel_z_clean"] is None or r["rel_z_clean"] <= 1e-4)
            if not (ok and r["finite"] and r["same"]):
                fail(f"K9 ({label}, {mode}) disagrees with trunk_forward_reference")
            if not r["same_tile"]:
                fail(f"K9's async design ({label}, {mode}) is not bit-equal to the tile design")
            if r["k7_bad"]:
                fail(f"K7 ({label}, {mode}) gave other indices than its plain version in the trunk run")
    k9_small_err = max(k9[("small", m)]["maxd"] for m in ("stream", "in-kernel RNG"))
    x_res, coef_t, l_consts, eps_t = k9[("full", "in-kernel RNG")]["last"]
    with torch.no_grad():
        k9t = [time_ms(lambda: trunk.trunk_forward(x_res, coef_t, l_consts, seed=(17, 0xBEEF), t=98),
                       reps=20),
               time_ms(lambda: trunk.trunk_forward_reference(x_res, coef_t, l_consts, eps_t), reps=20),
               time_ms(lambda: trunk.trunk_forward(x_res, coef_t, l_consts, eps=eps_t), reps=20)]
        k9t += [time_ms(lambda: trunk.trunk_forward(x_res, coef_t, l_consts, seed=(17, 0xBEEF), t=98),
                        reps=20),
                time_ms(lambda: trunk.trunk_forward_reference(x_res, coef_t, l_consts, eps_t),
                        reps=20)]
        # the async design and the previous one alternated, three pairs per noise mode
        k9_pairs = {mode: [tuple(pair_ms(lambda: trunk.trunk_forward(x_res, coef_t, l_consts,
                                                                     **noise, design=d))
                                 for d in trunk.K9_DESIGNS) for _ in range(3)]
                    for mode, noise in (("RNG", {"seed": (17, 0xBEEF), "t": 98}),
                                        ("stream", {"eps": eps_t}))}
        k9_dev = [statistics.mean(p_[0] for p_ in k9_pairs["RNG"]),
                  device_ms(lambda: trunk.trunk_forward_reference(x_res, coef_t, l_consts, eps_t)),
                  statistics.mean(p_[0] for p_ in k9_pairs["stream"]),
                  statistics.mean(p_[1] for p_ in k9_pairs["RNG"])]
    n_part = x_res.shape[0] * x_res.shape[-1]
    # x_res and the step's small operands in, x_new and α out (ε drawn in the kernel)
    k9_bound, k9_by = bound(trunk_flops(l_consts) * n_part,
                            2 * nbytes(x_res) + nbytes(coef_t, l_consts["packed"],
                                                       l_consts["sconst"]) + 4 * n_part)
    k9_plan = trunk.k9_plan(40, 40, 64, 1)
    print(f"[p] K9 full (B={x_res.shape[0]}, K={x_res.shape[-1]}, hidden 64): in-kernel RNG "
          f"{k9t[0]:.4f}/{k9t[3]:.4f} ms, stream {k9t[2]:.4f} ms, plain {k9t[1]:.4f}/{k9t[4]:.4f} ms "
          f"(alternated, CUDA events around one call, median of 20); device time per call "
          f"({PAIR_HOW}), (async, tile) alternated: "
          + "; ".join(f"{mode} " + ", ".join(f"({a:.4f}, {b_:.4f})" for a, b_ in v)
                      for mode, v in k9_pairs.items())
          + f" ms, plain {k9_dev[1]:.4f} ms; bound {k9_bound:.4f} ms ({k9_by}, "
          f"{trunk_flops(l_consts) * n_part:.3e} FLOP): async at {100 * k9_bound / k9_dev[0]:.1f}% "
          f"of it, tile at {100 * k9_bound / k9_dev[3]:.1f}% (RNG); async "
          f"{kernel_resources('trunk_forward_async_kernelILi40ELi40ELi64ELb0EE')}, (pair, prefetch) "
          f"{k9_plan}, {trunk.k9_smem_bytes(40, 40, 64, 1, *k9_plan)} B of shared memory per CTA; "
          f"tile {kernel_resources('trunk_forward_kernelILi40ELi40ELi64EE')}, "
          f"{trunk.smem_bytes(40, 40, 64, 1)} B", flush=True)
    if not all(a < b_ for v in k9_pairs.values() for a, b_ in v):
        fail("K9: the async design is not faster than the tile design in every pair")
    del x_res, eps_t
    k9.clear()
    phase_done("p")

    # (q) serving the preset with the trained snapshot through its entry points
    cfg, batch = l_cfg, l_batch
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    pt.load_params_npz(ssm, snapshot)
    ys = l_ds.obs_test[:batch].to(dev).contiguous()
    eval_step = pt.make_eval_step(ssm, cfg)
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    l_kernels = (rg.ancestor_indices_large, rg.gather_particles, trunk.trunk_forward)
    l_plain = (rg.ancestor_indices_large_reference, rg.gather_particles_reference,
               trunk.trunk_forward_reference, fused_step.stream_noise_reference,
               fused_step.scan_forward_reference)
    calls = {"eval_step": lambda: eval_step(run_gen, ys),
             "filter_posterior": lambda: pt.filter_posterior(ssm, ys, cfg, run_gen),
             "filter_posterior(return_particles)": lambda: pt.filter_posterior(
                 ssm, ys, cfg, run_gen, return_particles=True)}
    torch.cuda.synchronize()
    held_l96_gb = torch.cuda.memory_allocated() / 1e9
    outs, serve_launches, serve_peak = {}, {}, {}
    k9_serve_designs, k7_serve_designs = {}, {}
    for label, fn in calls.items():
        for f in l_kernels:
            f.launches = 0
        for f in l_plain:
            f.calls = 0
        zero_designs(trunk.trunk_forward, rg.ancestor_indices_large)
        torch.cuda.reset_peak_memory_stats()
        outs[label] = fn()
        torch.cuda.synchronize()
        serve_peak[label] = torch.cuda.max_memory_allocated() / 1e9 - held_l96_gb
        serve_launches[label] = [f.launches for f in l_kernels] + [sum(f.calls for f in l_plain)]
        k9_serve_designs[label] = dict(trunk.trunk_forward.launches_by_design)
        k7_serve_designs[label] = dict(rg.ancestor_indices_large.launches_by_design)
    metrics = outs["eval_step"]
    means = outs["filter_posterior"]
    p_means, parts, lws = outs["filter_posterior(return_particles)"]
    t_steps = cfg.data.t_steps
    shapes_ok = (tuple(means.shape) == (batch, t_steps, 40)
                 and tuple(parts.shape) == (batch, t_steps, lk, 40)
                 and tuple(lws.shape) == (batch, t_steps, lk))
    finite = (math.isfinite(float(metrics["elbo"])) and bool(torch.isfinite(metrics["r2_k"]).all())
              and bool(torch.isfinite(means).all()) and bool(torch.isfinite(parts).all()))
    del outs, parts, lws, p_means
    serve_ms = {label: time_ms(fn) for label, fn in calls.items()}
    serve_ms_2 = {label: time_ms(fn) for label, fn in calls.items()}
    r2 = [round(float(v), 4) for v in metrics["r2_k"]]
    print(f"[q] serving {L96} (B={batch}, K={lk}, T={t_steps}, trained snapshot): ELBO "
          f"{float(metrics['elbo']):.3f}, mean ESS {float(metrics['ess_mean']):.3f}, R2(1..10) {r2}, "
          f"shapes ok {shapes_ok}, finite {finite}; launches K7/K8/K9 and plain-version calls per "
          f"call {serve_launches}; K9 by design {k9_serve_designs}; K7 by design "
          f"{k7_serve_designs}", flush=True)
    for label in calls:
        print(f"[q] {label}: {serve_ms[label]:.3f}/{serve_ms_2[label]:.3f} ms per call (CUDA "
              f"events, median of 5 after 2 warm-up, two rounds); peak device memory "
              f"{serve_peak[label]:.3f} GB above the {held_l96_gb:.3f} GB held before", flush=True)
    profile = device_breakdown(calls["filter_posterior"], 1, L96_KERNELS)
    print(f"[q] profile of one more filter_posterior call: {profile}", flush=True)
    want_launch = [t_steps - 1] * 3 + [0]
    if any(v != want_launch for v in serve_launches.values()):
        fail(f"serving {L96} launched K7/K8/K9 {serve_launches} (want {want_launch} per call)")
    if any(v != {"async": t_steps - 1, "tile": 0} for v in k9_serve_designs.values()):
        fail(f"serving {L96}: K9 by design {k9_serve_designs} (want every launch async)")
    if any(v != {"cluster": t_steps - 1, "row": 0} for v in k7_serve_designs.values()):
        fail(f"serving {L96}: K7 by design {k7_serve_designs} (want every launch the cluster one)")
    if not (shapes_ok and finite):
        fail(f"serving {L96} gave non-finite outputs or the wrong shapes")
    phase_done("q")

    # (r) K11 vs its float64 plain version on phase (o)'s adversarial rows
    k11 = {}
    for kk in (128, 2048, lk):
        lw = weight_rows(kk, gen)
        pos = fused_step.systematic_positions(torch.rand(lw.shape[0], device=dev, generator=gen),
                                              kk).contiguous()
        idx = rg.ancestor_indices_large(lw, pos)
        g11 = torch.randn((lw.shape[0], 40, kk), device=dev, generator=gen)
        got = rg.segment_sum_scatter(g11, idx)
        again = rg.segment_sum_scatter(g11, idx)
        row = rg.segment_sum_scatter(g11, idx, design="row")
        want = rg.segment_sum_scatter_reference(g11.double(), idx)
        torch.cuda.synchronize()
        k11[kk] = dict(rel=float((got.double() - want).norm() / want.norm()),
                       maxd=float((got.double() - want).abs().max()),
                       d_row=float((got - row).abs().max()),
                       rel_row=float((row.double() - want).norm() / want.norm()),
                       same=bool(torch.equal(got, again)),
                       orphans=bool((got[want == 0] == 0).all()),
                       dominant=int(idx[6].unique().numel()))
        r = k11[kk]
        print(f"[r] K11 segment_sum_scatter [8, 40, {kk}] on the adversarial rows: rel L2 "
              f"{r['rel']:.3e} against the float64 plain version, max|d| {r['maxd']:.3e}, "
              f"bit-equal on a second launch {r['same']}, sources with no child exactly 0 "
              f"{r['orphans']} (the dominant-particle row has {r['dominant']} ancestor); tiled "
              f"design {rg.k11_plan(kk)} (P, tiles), max|d| from the row design {r['d_row']:.3e} "
              f"(the row design's rel L2 {r['rel_row']:.3e})", flush=True)
        if not (r["rel"] <= 1e-6 and r["same"] and r["orphans"] and r["dominant"] == 1):
            fail(f"K11 (K={kk}) disagrees with segment_sum_scatter_reference")
    idx64 = idx.long()[:, None, :].expand(-1, 40, -1)
    healthy = rg.ancestor_indices_large(torch.randn((8, lk), device=dev, generator=gen) * 3,
                                        pos)
    one = torch.full((8, lk), -50.0, device=dev)
    one[torch.arange(8, device=dev), torch.randint(0, lk, (8,), device=dev, generator=gen)] = 0.0
    degenerate = rg.ancestor_indices_large(one, pos)
    # the tiled design and the previous one alternated: three pairs on the
    # adversarial rows, one each on healthy and one-ancestor rows
    k11_pairs = {rows: [tuple(pair_ms(lambda: rg.segment_sum_scatter(g11, ix, design=d))
                              for d in rg.K11_DESIGNS) for _ in range(n)]
                 for rows, ix, n in (("adversarial", idx, 3), ("healthy", healthy, 1),
                                     ("one ancestor", degenerate, 1))}
    k11_dev = [statistics.mean(p_[0] for p_ in k11_pairs["adversarial"]),
               device_ms(lambda: rg.segment_sum_scatter_reference(g11, idx)),
               device_ms(lambda: torch.zeros_like(g11).scatter_add_(-1, idx64, g11)),
               k11_pairs["healthy"][0][0], k11_pairs["one ancestor"][0][0],
               statistics.mean(p_[1] for p_ in k11_pairs["adversarial"])]
    # g read once, the indices, d_x written once; one addition per element
    k11_bound, k11_by = bound(float(g11.numel()), 2 * nbytes(g11) + nbytes(idx))
    print(f"[r] K11 full [8, 40, {lk}]: device time per call (torch.profiler, 20 calls) "
          f"{k11_dev[0]:.4f} ms on the adversarial rows, {k11_dev[3]:.4f} ms on healthy rows, "
          f"{k11_dev[4]:.4f} ms with one ancestor per row; plain version {k11_dev[1]:.4f} ms, "
          f"zeros + scatter_add_ on the int64 index {k11_dev[2]:.4f} ms; bound "
          f"{k11_bound:.4f} ms ({k11_by})", flush=True)
    k11_per, k11_c = rg.k11_plan(lk)
    print(f"[r] K11 full, (tiled, row) alternated ({PAIR_HOW} each): "
          + "; ".join(f"{rows} " + ", ".join(f"({a:.4f}, {b_:.4f})" for a, b_ in v)
                      for rows, v in k11_pairs.items())
          + f" ms; tiled at {100 * k11_bound / k11_dev[0]:.1f}% of the bound, row at "
          f"{100 * k11_bound / k11_dev[5]:.1f}% (adversarial); tiled P = {k11_per}, {k11_c} tiles a "
          f"row ({l_batch * k11_c * -(-40 // (32 // k11_per))} CTAs), "
          f"{kernel_resources(f'segment_sum_tiled_kernelILi{k11_per}E')}, "
          f"{rg.k11_smem_bytes(k11_per)} B of shared memory per CTA; row "
          f"{kernel_resources('segment_sum_scatter_kernel')}, {4 * lk} B", flush=True)
    if not all(a < b_ for v in k11_pairs.values() for a, b_ in v):
        fail("K11: the tiled design is not faster than the row design in every pair")
    del g11, idx64
    phase_done("r")

    # (s) K10 vs its plain version on every step of one kernel run, teacher-forced
    k10 = {}
    for label, small in (("small", True), ("full", False)):
        cfg, batch = l96_config(small)
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 8), device=dev)
        if not small:
            pt.load_params_npz(ssm, snapshot)
        ys = l_obs[:batch, :cfg.data.t_steps].contiguous()
        tol = 1e-4 if small else 1e-3
        for mode, rng_seed in (("stream", None), ("in-kernel RNG", (19, 0xF00D))):
            with torch.no_grad():
                r = trunk_backward_run(ssm, cfg, ys, gen, rng_seed)
            k10[(label, mode)] = r
            print(f"[s] K10 {label} B={batch} K={cfg.smc.n_particles} T={cfg.data.t_steps} {mode}, "
                  f"every step: " + ", ".join(f"{n} rel L2 {e:.3e} max|d| {m:.3e}" for n, e, m in
                                              zip(("d_x_res",) + leaves[1:], r["rel"], r["maxd"]))
                  + f"; bit-equal on a second launch {r['same']}; bound rel L2 {tol:g}; cotangents "
                  f"zeroed on {r['zeroed']} of {r['n']} particle-steps with a relu tie; with every "
                  f"particle's cotangent, rel L2 " + ", ".join(f"{e:.3e}" for e in r["rel_raw"])
                  + "; against the previous design (simt), every particle, rel L2 "
                  + ", ".join(f"{e:.3e}" for e in r["rel_simt"]) + " (bound 1e-05); K7 index "
                  f"mismatches against its plain version, every step {r['k7_bad']}", flush=True)
            if not (r["finite"] and r["same"] and max(r["rel"]) <= tol):
                fail(f"K10 ({label}, {mode}) disagrees with trunk_backward_reference")
            if not max(r["rel_simt"]) <= 1e-5:
                fail(f"K10 ({label}, {mode}) is further than 1e-5 from the previous design")
            if r["k7_bad"]:
                fail(f"K7 ({label}, {mode}) gave other indices than its plain version in the trunk run")
    k10_small_err = max(max(k10[("small", m)]["maxd"]) for m in ("stream", "in-kernel RNG"))
    (bwd10, noise10, eps10, got10) = k10[("full", "in-kernel RNG")]["last"]
    bwd10s, noise10s = k10[("full", "stream")]["last"][:2]
    # the new design and the previous one alternated, three pairs per noise mode
    k10_pairs = {"in-kernel RNG": [], "stream": []}
    with torch.no_grad():
        for mode, (b_, n_) in (("in-kernel RNG", (bwd10, noise10)), ("stream", (bwd10s, noise10s))):
            for _ in range(3):
                k10_pairs[mode].append(tuple(
                    device_ms(lambda: trunk.trunk_backward(*b_, **n_, design=d))
                    for d in ("tf32x3", "simt")))
        k10_plain = device_ms(lambda: trunk.trunk_backward_reference(*bwd10[:4], eps10, *bwd10[4:]))
    k10_ms = statistics.mean(p[0] for p in k10_pairs["in-kernel RNG"])
    k10_ms_simt = statistics.mean(p[1] for p in k10_pairs["in-kernel RNG"])
    x_res, x_new = bwd10[0], bwd10[1]
    n_part = x_res.shape[0] * x_res.shape[-1]
    k10_flops = 3 * trunk_flops(bwd10[3]) * n_part
    # x_res, x_new, d x_new, d α and the small operands in; d x_res and the gradients out
    k10_bound, k10_by = bound(k10_flops, nbytes(x_res, x_new, bwd10[2], bwd10[3]["packed"],
                                                bwd10[3]["sconst"], bwd10[4], bwd10[5], *got10))
    # the split bound of the tensor-core design: the three forward units (a third of the
    # FLOP) on the fp32 cores, the six backward units in three TF32 passes on the tensor cores
    k10_split = (k10_flops / 3 / FP32_PEAK + 3 * (2 * k10_flops / 3) / TF32_PEAK) * 1e3
    log = _build.build_log()
    k10_res = {}
    for kname in ("trunk_backward_tf32x3_kernel", "trunk_backward_kernel"):
        regs = re.search(kname + r"ILi40ELi40ELi64ELb0EE.*?Used (\d+) registers", log, re.S)
        spill = re.search(kname + r"ILi40ELi40ELi64ELb0EE[^\n]*\n[^\n]*\n\s*(\d+) bytes "
                          r"stack frame, (\d+) bytes spill stores", log)
        k10_res[kname] = (regs.group(1) if regs else "?", spill.group(2) if spill else "?")
    for mode, pairs in k10_pairs.items():
        print(f"[s] K10 full (B={x_res.shape[0]}, K={x_res.shape[-1]}, hidden 64) {mode}: device "
              f"time per call (torch.profiler, 20 calls), (tf32x3, simt) alternated "
              + ", ".join(f"({a:.4f}, {b:.4f})" for a, b in pairs) + " ms", flush=True)
    print(f"[s] K10 tf32x3 {k10_ms:.4f} ms, simt {k10_ms_simt:.4f} ms (in-kernel RNG means); plain "
          f"{k10_plain:.4f} ms; fp32 bound {k10_bound:.4f} ms ({k10_by}, {k10_flops:.3e} FLOP): "
          f"tf32x3 at {100 * k10_bound / k10_ms:.1f}% of it, simt at "
          f"{100 * k10_bound / k10_ms_simt:.1f}%; split bound {k10_split:.4f} ms (forward on fp32, "
          f"backward 3xTF32): tf32x3 at {100 * k10_split / k10_ms:.1f}%; registers, spill stores "
          f"tf32x3 {k10_res['trunk_backward_tf32x3_kernel']}, simt "
          f"{k10_res['trunk_backward_kernel']}; shared memory per CTA tf32x3 "
          f"{trunk.k10_smem_bytes(40, 40, 64, 1)} B, simt "
          f"{trunk.k10_smem_bytes(40, 40, 64, 1, 'simt')} B", flush=True)
    del bwd10, bwd10s, got10, eps10, x_res, x_new
    k10.clear()
    phase_done("s")

    # (t) training the preset from the trained snapshot through make_train_step
    cfg, batch = l_cfg, l_batch
    n_per_call = cfg.train.steps_per_call
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    pt.load_params_npz(ssm, snapshot)
    train_step = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
    obs = l_ds.obs_train.to(dev)
    pick = torch.randint(0, obs.shape[0], (3, batch), generator=torch.Generator().manual_seed(SEED + 7))
    train_batches = [obs[p.to(dev)].contiguous() for p in pick]  # [B, T, Dy] each
    before = [p.detach().clone() for p in ssm.parameters()]
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    t_kernels = (rg.ancestor_indices_large, rg.gather_particles, trunk.trunk_forward,
                 trunk.trunk_backward, rg.segment_sum_scatter)
    t_plain = l_plain + (trunk.trunk_backward_reference, rg.segment_sum_scatter_reference,
                         fused_step.scan_backward_reference)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_train_gb = torch.cuda.memory_allocated() / 1e9
    for f in t_kernels:
        f.launches = 0
    zero_designs(trunk.trunk_backward, trunk.trunk_forward, rg.ancestor_indices_large,
                 rg.segment_sum_scatter)
    for f in t_plain:
        f.calls = 0
    call_s, train_metrics = [], []
    for bt in train_batches:
        t0 = time.perf_counter()
        train_metrics.append(train_step(run_gen, bt))
        torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t0)
    train_launches = [f.launches for f in t_kernels]
    k10_by_design = dict(trunk.trunk_backward.launches_by_design)
    k9_by_design = dict(trunk.trunk_forward.launches_by_design)
    k7_by_design = dict(rg.ancestor_indices_large.launches_by_design)
    k11_by_design = dict(rg.segment_sum_scatter.launches_by_design)
    plain_calls = sum(f.calls for f in t_plain)
    peak_train_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(m_["loss"]) for m_ in train_metrics]
    norms = [float(m_["grad_norm"]) for m_ in train_metrics]
    ess_mean = [float(m_["ess_mean"]) for m_ in train_metrics]
    moved = any(not torch.equal(a, p) for a, p in zip(before, ssm.parameters()))
    l96_step_ms = statistics.median(call_s[1:]) / n_per_call * 1e3
    print(f"[t] training {L96} from the snapshot: {len(train_batches)} calls x {n_per_call} step, "
          f"B={batch}, K={lk}: loss per call {[round(v, 3) for v in losses]}, grad norm "
          f"{[round(v, 3) for v in norms]}, mean ESS {[round(v, 3) for v in ess_mean]}, "
          f"parameters moved {moved}; launches K7/K8/K9/K10/K11 {train_launches} (K9 by design "
          f"{k9_by_design}, K10 by design {k10_by_design}, K7 by design {k7_by_design}, K11 by "
          f"design {k11_by_design}), plain-version "
          f"calls {plain_calls}; call times {[round(v, 3) for v in call_s]} s, train step "
          f"{l96_step_ms:.3f} ms (median of the calls after the first); peak device memory "
          f"{peak_train_gb - held_train_gb:.3f} GB above the {held_train_gb:.3f} GB held before",
          flush=True)
    profile = device_breakdown(lambda: train_step(run_gen, train_batches[0]), n_per_call,
                               L96_TRAIN_KERNELS)
    print(f"[t] profile of one more call: {profile}", flush=True)
    want_t = len(train_batches) * n_per_call * (cfg.data.t_steps - 1)
    if (train_launches != [want_t] * 5 or plain_calls != 0
            or k10_by_design != {"tf32x3": want_t, "simt": 0}
            or k9_by_design != {"async": want_t, "tile": 0}
            or k7_by_design != {"cluster": want_t, "row": 0}
            or k11_by_design != {"tiled": want_t, "row": 0}):
        fail(f"training {L96} launched K7/K8/K9/K10/K11 {train_launches} (want {want_t} each; "
             f"K9 by design {k9_by_design}, want all async; K10 by design {k10_by_design}, want "
             f"all tf32x3; K7 {k7_by_design}, want all cluster; K11 {k11_by_design}, want all "
             f"tiled), plain versions {plain_calls}")
    if not (all(math.isfinite(v) for v in losses + norms) and moved):
        fail(f"training {L96} gave non-finite losses or gradient norms, or left the parameters "
             f"as they were")
    phase_done("t")

    # (u) K1 and K4 at the SVO preset's settings: Dx=3, K=256, in-kernel draw, cache
    from psvo_tpu_torch.ops import svo

    s_cfg = pt.PRESETS[SVO]
    s_ds = pt.generate_dataset(s_cfg.data, SEED)
    s_obs = torch.cat([s_ds.obs_test, s_ds.obs_train]).to(dev)
    for label, small in (("small", True), ("full", False)):
        cfg, batch = slice_config(small, SVO)
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 10), device=dev)
        ys = s_obs[:batch, :cfg.data.t_steps].contiguous()
        with torch.no_grad():
            r = check_scan(label, ssm, cfg, ys, gen, tol=2e-4, rng_seed=(31, 0xABCDEF))
            rb = check_backward(ssm, cfg, ys, gen, (37, 0x5EED), cache=True)
        tol = 1e-4 if small else 1e-3
        print(f"[u] K1 {SVO} in-kernel RNG, cache, {label} B={batch} K={cfg.smc.n_particles} "
              f"T={cfg.data.t_steps}: bit-equal to K1 on K2's streams; vs the plain replay "
              f"{scan_line(r)}", flush=True)
        print(f"[u] K4 {label} in-kernel RNG with the cache cotangents: "
              + ", ".join(f"{n} rel L2 {e:.3e} max|d| {m:.3e}"
                          for n, e, m in zip(leaves, rb["rel"], rb["maxd"]))
              + f"; idx nondecreasing {rb['monotone']}; bound rel L2 {tol:g}", flush=True)
        if not scan_ok(r, small):
            fail(f"K1 ({SVO}, {label}) disagrees with the plain replay")
        if not (rb["monotone"] and rb["finite"] and max(rb["rel"]) <= tol):
            fail(f"K4 ({SVO}, {label}) disagrees with scan_backward_reference")
    phase_done("u")

    # (v) K12 vs its plain version, small and full
    k12, k13 = {}, {}
    for label, small in (("small", True), ("full", False)):
        cfg, batch = slice_config(small, SVO)
        if small:
            cfg = dataclasses.replace(cfg, smc=dataclasses.replace(cfg.smc, n_smoothing_particles=8))
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 12), device=dev)
        ys = s_obs[:batch, :cfg.data.t_steps].contiguous()
        with torch.no_grad():
            consts, ops = svo_operands(ssm, cfg, ys, gen)
            r = svo_forward_check(consts, ops)
        k12[label] = (consts, ops, r)
        print(f"[v] K12 {label} B={batch} M={ops[0].shape[1]} T={cfg.data.t_steps} hidden="
              f"{cfg.net('qb').hidden}: allclose(2e-4) {r['close']}, max|d| {r['max_abs_err']:.3e}; "
              f"max |d|/(1+|x|): x~ {r['rel_x']:.3e}, lp {r['rel_lp']:.3e}, lq {r['rel_lq']:.3e}; "
              f"teacher-forced x~ {r['tf_x']:.3e}; finite {r['finite']}; bit-equal to the previous "
              f"design (chain) in x_first, lp, lq and x~ {r['same_prev']}", flush=True)
        ok = r["close"] if small else (r["tf_x"] <= 1e-5 and r["rel_x"] <= 1e-4
                                       and max(r["rel_lp"], r["rel_lq"]) <= 1e-4)
        if not (ok and r["finite"]):
            fail(f"K12 ({label}) disagrees with svo_sweep_forward_reference")
        if not r["same_prev"]:
            fail(f"K12's split design ({label}) is not bit-equal to the chain design")
    consts, ops, r = k12["full"]
    with torch.no_grad():
        # the split design and the previous one alternated, three pairs
        k12_pairs = [tuple(pair_ms(lambda: svo.svo_sweep_forward(*ops, consts, design=d))
                           for d in svo.K12_DESIGNS) for _ in range(3)]
        k12_dev = [statistics.mean(p_[0] for p_ in k12_pairs),
                   device_ms(lambda: svo.svo_sweep_forward_reference(*ops, consts), n=3),
                   statistics.mean(p_[1] for p_ in k12_pairs)]
    t1_s, b_s, m_s = ops[1].shape[:3]
    k12_flops = svo_flops(consts, t1_s * b_s * m_s)
    k12_bound, k12_by = bound(k12_flops, nbytes(*ops, consts["packed"], consts["sc"], *r["kern"]))
    k12_plan = svo.k12_plan(3, 3, 64, 1, b_s * m_s, n_sms, t1_s)
    print(f"[v] K12 full (B={b_s}, M={m_s}, T-1={t1_s}, hidden 64): device time per call "
          f"({PAIR_HOW}), (split, chain) alternated: "
          + ", ".join(f"({a:.4f}, {b_:.4f})" for a, b_ in k12_pairs)
          + f" ms; plain {k12_dev[1]:.3f} ms (3 calls); bound {k12_bound:.4f} ms ({k12_by}, "
          f"{k12_flops:.3e} FLOP): split at {100 * k12_bound / k12_dev[0]:.1f}% of it, chain at "
          f"{100 * k12_bound / k12_dev[2]:.1f}%; split "
          f"{kernel_resources('svo_forward_split_kernelILi3ELi3ELi64ELb0EE')}, (paths, tile rows, "
          f"steps a chunk) {k12_plan}, {svo.k12_smem_bytes(3, 3, 64, 1, *k12_plan)} B of shared "
          f"memory per CTA; chain {kernel_resources('svo_forward_kernelILi3ELi3ELi64EE')}",
          flush=True)
    if not all(a < b_ for a, b_ in k12_pairs):
        fail("K12: the split design is not faster than the chain design in every pair")
    phase_done("v")

    # (w) K13 vs its plain version on K12's saved x~, small and full
    for label in ("small", "full"):
        consts, ops, r = k12[label]
        with torch.no_grad():
            rb = svo_backward_check(consts, ops, r["kern"][3], gen)
        k13[label] = rb
        tol = 1e-4 if label == "small" else 1e-3
        print(f"[w] K13 {label}: " + ", ".join(
                  f"{n} rel L2 {e:.3e} max|d| {m:.3e}"
                  for n, e, m in zip(("d_x_anchor", "d_weights", "d_sc"), rb["rel"], rb["maxd"]))
              + f"; bit-equal on a second launch {rb['same']}; bound rel L2 {tol:g}; cotangents "
              f"zeroed on {rb['zeroed']} of {rb['n']} paths with a relu tie; with every path's "
              f"cotangents, rel L2 " + ", ".join(f"{e:.3e}" for e in rb["rel_raw"])
              + "; against the previous design (chain) " + ", ".join(f"{e:.3e}" for e in rb["rel_prev"])
              + " (bound 1e-05)", flush=True)
        if not (rb["finite"] and rb["same"] and max(rb["rel"]) <= tol):
            fail(f"K13 ({label}) disagrees with svo_sweep_backward_reference")
        if not max(rb["rel_prev"]) <= 1e-5:
            fail(f"K13 ({label}) is further than 1e-5 from the previous design")
    args13 = k13["full"]["args"]
    with torch.no_grad():
        # the split design and the previous one alternated, three pairs
        k13_pairs = [tuple(pair_ms(lambda: svo.svo_sweep_backward(*args13, design=d))
                           for d in ("split", "chain")) for _ in range(3)]
        k13_dev = [statistics.mean(p_[0] for p_ in k13_pairs),
                   device_ms(lambda: svo.svo_sweep_backward_reference(*args13), n=3),
                   statistics.mean(p_[1] for p_ in k13_pairs)]
    k13_flops = 3 * k12_flops
    k13_bound, k13_by = bound(k13_flops, nbytes(*args13[:3], args13[3]["packed"], args13[3]["sc"],
                                                *args13[4:], *k13["full"]["got"]))
    n_w13 = args13[3]["packed"].numel()
    rows13 = svo.k13_tile_rows(3, 3, 64, 1, n_w13)
    p13 = svo.k13_paths(b_s * m_s, n_sms, rows13)
    print(f"[w] K13 full: device time per call ({PAIR_HOW}), "
          f"(split, chain) "
          f"alternated: " + ", ".join(f"({a:.4f}, {b_:.4f})" for a, b_ in k13_pairs)
          + f" ms; plain {k13_dev[1]:.3f} ms (3 calls); bound {k13_bound:.4f} ms ({k13_by}, "
          f"{k13_flops:.3e} FLOP): split at {100 * k13_bound / k13_dev[0]:.1f}% of it, chain at "
          f"{100 * k13_bound / k13_dev[2]:.1f}%; split "
          f"{kernel_resources('svo_backward_split_kernelILi3ELi3ELi64ELb0EE')}, "
          f"{svo.k13_smem_bytes(3, 3, 64, 1, n_w13)} B of shared memory per CTA, tiles of "
          f"{rows13} rows, {p13} paths a group ({-(-b_s * m_s // p13)} groups); chain "
          f"{kernel_resources('svo_backward_kernelILi3ELi3ELi64EE')}, "
          f"{svo.k13_smem_bytes(3, 3, 64, 1, n_w13, 'chain')} B", flush=True)
    if not all(a < b_ for a, b_ in k13_pairs):
        fail("K13: the split design is not faster than the previous one in every pair")
    k12_small_err = k12["small"][2]["max_abs_err"]
    k13_small_err = max(k13["small"]["maxd"])
    del k12, k13, args13
    phase_done("w")

    # (x) serving: smooth_posterior(method="svo") on three batches of 32
    cfg, batch = s_cfg, 32
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    s_batches = [s_obs[i * batch:(i + 1) * batch].contiguous() for i in range(3)]
    s_plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
               fused_step.stream_noise_reference, svo.svo_sweep_forward_reference,
               svo.svo_sweep_backward_reference)
    s_kernels = (fused_step.scan_forward, fused_step.scan_backward, svo.svo_sweep_forward,
                 svo.svo_sweep_backward)
    for fn in s_plain:
        fn.calls = 0
    for fn in s_kernels:
        fn.launches = 0
    zero_designs(svo.svo_sweep_backward, svo.svo_sweep_forward)
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    torch.cuda.synchronize()
    held_svo_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    paths = [pt.smooth_posterior(ssm, ys, cfg, run_gen, method="svo") for ys in s_batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    serve_svo_gb = torch.cuda.max_memory_allocated() / 1e9 - held_svo_gb
    svo_serve = [fn.launches for fn in s_kernels]
    k13_serve_designs = dict(svo.svo_sweep_backward.launches_by_design)
    k12_serve_designs = dict(svo.svo_sweep_forward.launches_by_design)
    plain_calls = sum(fn.calls for fn in s_plain)
    shapes_ok = all(tuple(p.shape) == (batch, 16, 100, 3) for p in paths)
    finite = all(bool(torch.isfinite(p).all()) for p in paths)
    svo_sp_ms = [time_ms(lambda: pt.smooth_posterior(ssm, s_batches[0], cfg, run_gen, method="svo"))
                 for _ in range(2)]
    print(f"[x] serving {SVO}: smooth_posterior(method='svo') x3 -> shapes "
          f"{[tuple(p.shape) for p in paths]} ok {shapes_ok}, finite {finite}; launches "
          f"K1/K4/K12/K13 {svo_serve} (K12 by design {k12_serve_designs}), plain-version calls "
          f"{plain_calls}, wall {wall:.2f} s; "
          f"{svo_sp_ms[0]:.3f}/{svo_sp_ms[1]:.3f} ms per call of B={batch} (median of 5 after 2 "
          f"warm-up); peak device memory {serve_svo_gb:.3f} GB above the {held_svo_gb:.3f} GB "
          f"held before", flush=True)
    profile = device_breakdown(
        lambda: pt.smooth_posterior(ssm, s_batches[0], cfg, run_gen, method="svo"), 1, SVO_KERNELS)
    print(f"[x] profile of one more call: {profile}", flush=True)
    if (svo_serve != [3, 0, 3, 0] or plain_calls != 0
            or k13_serve_designs != {"split": 0, "chain": 0}
            or k12_serve_designs != {"split": 3, "chain": 0}):
        fail(f"smooth_posterior(method='svo') launched K1/K4/K12/K13 {svo_serve} (want "
             f"[3, 0, 3, 0]; K12 by design {k12_serve_designs}, want all split; K13 by design "
             f"{k13_serve_designs}), plain versions {plain_calls}")
    if not (shapes_ok and finite):
        fail("smooth_posterior(method='svo') gave non-finite paths or the wrong shape")
    del paths
    phase_done("x")

    # (y) training through make_train_step: 3 calls of steps_per_call SVO steps
    n_per_call = cfg.train.steps_per_call
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    train_step = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
    obs = s_ds.obs_train.to(dev)
    pick = torch.randint(0, obs.shape[0], (TRAIN_CALLS, n_per_call, batch),
                         generator=torch.Generator().manual_seed(SEED + 7))
    train_batches = [obs[p.to(dev)].contiguous() for p in pick]
    before = [p.detach().clone() for p in ssm.parameters()]
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_svo_gb = torch.cuda.memory_allocated() / 1e9
    for fn in s_plain:
        fn.calls = 0
    for fn in s_kernels:
        fn.launches = 0
    zero_designs(svo.svo_sweep_backward, svo.svo_sweep_forward)
    call_s, train_metrics = [], []
    for bt in train_batches:
        t0 = time.perf_counter()
        train_metrics.append(train_step(run_gen, bt))
        torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t0)
    svo_launches = [fn.launches for fn in s_kernels]
    k13_train_designs = dict(svo.svo_sweep_backward.launches_by_design)
    k12_train_designs = dict(svo.svo_sweep_forward.launches_by_design)
    plain_calls = sum(fn.calls for fn in s_plain)
    peak_svo_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(m_["loss"]) for m_ in train_metrics]
    norms = [float(m_["grad_norm"]) for m_ in train_metrics]
    elbos = [float(m_["elbo_svo"]) for m_ in train_metrics]
    moved = any(not torch.equal(a, p) for a, p in zip(before, ssm.parameters()))
    svo_step_ms = statistics.median(call_s[1:]) / n_per_call * 1e3
    print(f"[y] training {SVO}: {len(train_batches)} calls x {n_per_call} steps, B={batch}: loss "
          f"per call {[round(v, 3) for v in losses]}, elbo_svo {[round(v, 3) for v in elbos]}, "
          f"grad norm {[round(v, 3) for v in norms]}, parameters moved {moved}; launches "
          f"K1/K4/K12/K13 {svo_launches} (K12 by design {k12_train_designs}, K13 by design "
          f"{k13_train_designs}), plain-version calls "
          f"{plain_calls}; call times "
          f"{[round(v, 3) for v in call_s]} s, train step {svo_step_ms:.3f} ms (median of the calls "
          f"after the first, per step); peak device memory {peak_svo_gb - held_svo_gb:.3f} GB "
          f"above the {held_svo_gb:.3f} GB held before", flush=True)
    profile = device_breakdown(lambda: train_step(run_gen, train_batches[0]), n_per_call,
                               SVO_KERNELS)
    print(f"[y] profile of one more call: {profile}", flush=True)
    want = len(train_batches) * n_per_call
    if (svo_launches != [want] * 4 or plain_calls != 0
            or k13_train_designs != {"split": want, "chain": 0}
            or k12_train_designs != {"split": want, "chain": 0}):
        fail(f"SVO train path launched K1/K4/K12/K13 {svo_launches} times (want {want} each, every "
             f"K12 and K13 launch the split design: {k12_train_designs}, {k13_train_designs}), "
             f"plain versions {plain_calls}")
    if not (all(math.isfinite(v) for v in losses + norms + elbos) and moved):
        fail("SVO training gave non-finite losses, ELBOs or gradient norms, or left the "
             "parameters as they were")
    phase_done("y")

    # (z) K14 against its plain version, every step teacher-forced, and its chain against K1
    from psvo_tpu_torch import smc as tsmc
    from psvo_tpu_torch.ops.resampling import gather_particles

    fhn = "fhn_fivo_k1024_bench"
    l63_obs = torch.cat([lds.obs_test, lds.obs_train]).to(dev)  # l_obs holds Lorenz-96's now
    step_runs = {}
    for preset, obs_all, dy in ((fhn, None, 2), (l63, l63_obs, 3)):
        for label, small in (("small", True), ("full", False)):
            cfg, batch = slice_config(small, preset)
            ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 14), device=dev)
            if obs_all is None:
                ys = torch.randn((batch, cfg.data.t_steps, dy), device=dev, generator=gen)
            else:
                ys = obs_all[:batch, :cfg.data.t_steps].contiguous()
            with torch.no_grad():
                r = step_chain_check(ssm, cfg, ys, gen)
            step_runs[(preset, label)] = r
            print(f"[z] K14 {preset} {label} B={batch} K={cfg.smc.n_particles} T={cfg.data.t_steps} "
                  f"hidden={cfg.net('q1').hidden}: every step from the kernel's own state: "
                  f"{r['idx_bad']} indices differ; max per-step rel L2 / max |d|/(1+|w|) "
                  + ", ".join(f"{n} {e:.3e} / {m:.3e}" for n, e, m in
                              zip(STEP_OUTPUTS, r["tf_l2"], r["tf_rel"]))
                  + f" (max|d| {r['tf_abs']:.3e}); chain of {cfg.data.t_steps - 1} "
                  f"launches vs one K1 launch on the same streams: {r['k1_idx']} indices differ, "
                  f"max|d| x {r['vs_k1'][0]:.3e} alpha {r['vs_k1'][1]:.3e} stats "
                  f"{r['vs_k1'][2]:.3e}; finite {r['finite']}; K14 on "
                  f"S={fused_step.step_forward.last_slices} CTAs per row", flush=True)
            if not (r["finite"] and r["idx_bad"] == 0 and max(r["tf_l2"]) <= 1e-4
                    and r["k1_idx"] == 0):
                fail(f"K14 ({preset}, {label}) disagrees with step_forward_reference or with K1")
    k14_small_err = max(step_runs[(p, "small")]["tf_abs"] for p in (fhn, l63))
    slice_inputs = {}  # phase ae's operands: step t_mid of each full chain, and its residuals
    for preset in (fhn, l63):
        rf = step_runs[(preset, "full")]
        tm = rf["inp"]["coef"].shape[0] // 2
        x_all, alpha_all, stats_all, idx_all = (c.clone() for c in rf["chain"])
        slice_inputs[preset] = (
            (x_all[tm - 1], alpha_all[tm - 1], rf["inp"]["coef"][tm], rf["inp"]["consts"],
             rf["inp"]["eps"][tm], rf["inp"]["positions"][tm]),
            (x_all[tm - 1], x_all[tm], idx_all[tm], stats_all[tm], rf["inp"]["coef"][tm],
             rf["inp"]["eps"][tm]))
    full = step_runs[(fhn, "full")]
    inp = full["inp"]
    t_mid = inp["coef"].shape[0] // 2
    x_mid = full["chain"][0][t_mid - 1].contiguous()
    a_mid = full["chain"][1][t_mid - 1].contiguous()
    k14_args = (x_mid, a_mid, inp["coef"][t_mid], inp["consts"], inp["eps"][t_mid],
                inp["positions"][t_mid])
    with torch.no_grad():
        k14_dev = [device_ms(lambda: fused_step.step_forward(*k14_args)),
                   device_ms(lambda: fused_step.step_forward_reference(*k14_args), n=5),
                   device_ms(lambda: fused_step.step_forward(*k14_args))]
        k14_out = fused_step.step_forward(*k14_args)
    k14_regs = re.search(r"step_forward_kernelILi2ELi2ELi64EE.*?Used (\d+) registers",
                         _build.build_log(), re.S)
    print(f"[z] K14 full ({fhn}, B=32, K=1024, hidden 64, step {t_mid}): device time per launch "
          f"(torch.profiler) {k14_dev[0]:.4f}/{k14_dev[2]:.4f} ms (20 launches each), plain "
          f"{k14_dev[1]:.4f} ms (5 calls); registers {k14_regs.group(1) if k14_regs else '?'}",
          flush=True)
    phase_done("z")

    # (aa) K15 against its plain version on K14's residuals; the chain against K4; K=2048
    k15 = {}
    for key, r in step_runs.items():
        with torch.no_grad():
            rb = step_backward_check(r, gen)
        k15[key] = rb
        tol = 1e-4 if key[1] == "small" else 1e-3
        print(f"[aa] K15 {key[0]} {key[1]}, every step: " + ", ".join(
                  f"{n} rel L2 {e:.3e} max|d| {m:.3e}"
                  for n, e, m in zip(("d_x",) + leaves[1:], rb["rel"], rb["maxd"]))
              + f"; bit-equal on a second launch {rb['same']}; bound rel L2 {tol:g}; cotangents "
              f"zeroed on {rb['zeroed']} of {rb['n']} particle-steps with a relu tie; with every "
              f"particle's, rel L2 " + ", ".join(f"{e:.3e}" for e in rb["rel_raw"])
              + "; the chain vs one K4 launch, rel L2 " + ", ".join(f"{e:.3e}" for e in rb["vs_k4"])
              + f" (d_x0, d_coef, summed d_weights, d_sconst); K15 on "
              f"S={fused_step.step_backward.last_slices} CTAs per row", flush=True)
        if not (rb["finite"] and rb["same"] and max(rb["rel"]) <= tol and max(rb["vs_k4"]) <= 1e-4):
            fail(f"K15 ({key[0]}, {key[1]}) disagrees with step_backward_reference or with K4")
        if key[1] == "small":
            del rb["last"]
    k15_small_err = max(max(k15[(p, "small")]["maxd"]) for p in (fhn, l63))
    k15_args = k15[(fhn, "full")]["last"]
    (k14_bound, k14_by), (k15_bound, k15_by) = step_bounds(inp["consts"], k14_args[:3] + k14_args[4:],
                                                           k14_out, k15_args)
    args15, d_xn15, d_al15, _ = k15_args
    plain15 = (args15[0], args15[4], args15[5], args15[6], args15[2], args15[7], d_xn15, d_al15)
    with torch.no_grad():
        k15_dev = [device_ms(lambda: fused_step.step_backward(*args15, d_xn15, d_al15)),
                   device_ms(lambda: fused_step.step_backward_reference(*plain15), n=5),
                   device_ms(lambda: fused_step.step_backward(*args15, d_xn15, d_al15))]
    # K15 at Dx=3, K=2048: one step of K14 at that width, then K15 against its plain version
    wcfg, wbatch = slice_config(False, l63)
    wcfg = dataclasses.replace(wcfg, smc=dataclasses.replace(wcfg.smc, n_particles=2048))
    wssm = pt.init_ssm(wcfg, torch.Generator().manual_seed(SEED + 15), device=dev)
    with torch.no_grad():
        winp = kernel_inputs(wssm, wcfg, l63_obs[:wbatch].contiguous(), gen)
        wc = winp["consts"]
        x_new, alpha, stats, idx = fused_step.step_forward(winp["x0"], winp["alpha0"], winp["coef"][0],
                                                           wc, winp["eps"][0], winp["positions"][0])
        w_keep = ~relu_ties(wc, gather_particles(winp["x0"], idx), x_new)
        w_cots = (torch.randn(stats.shape, generator=gen, device=dev),
                  torch.randn(x_new.shape, generator=gen, device=dev) * w_keep[:, None],
                  torch.randn(alpha.shape, generator=gen, device=dev) * w_keep)
        w_args = (winp["x0"], x_new, idx, stats, winp["coef"][0], wc, winp["eps"][0], *w_cots)
        w_got = fused_step.step_backward(*w_args)
        w_want = fused_step.step_backward_reference(winp["x0"], winp["coef"][0], wc, winp["eps"][0],
                                                    idx, *w_cots)
        w_rel = [float((g - w).norm() / w.norm().clamp_min(1e-30)) for g, w in zip(w_got, w_want)]
        w_dev = device_ms(lambda: fused_step.step_backward(*w_args))
    k15_regs = re.findall(r"step_backward_kernelILi(\d)ELi\dELi64EE.*?Used (\d+) registers",
                          _build.build_log(), re.S)
    print(f"[aa] K15 at Dx=3, K=2048, B={wbatch}, hidden 64 (K4 runs to K="
          f"{max(kk for kk in range(256, 4097, 256) if fused_step._k4_ok(wc, kk))} there, K15 to "
          f"{max(kk for kk in range(256, 4097, 256) if fused_step._k15_ok(wc, kk))}), cotangents "
          f"zeroed on {int((~w_keep).sum())} of {w_keep.numel()} particles with a relu tie: rel L2 "
          + ", ".join(f"{e:.3e}" for e in w_rel) + f"; device time {w_dev:.4f} ms; shared memory "
          f"{fused_step.k15_smem_bytes(wc)} B at any K", flush=True)
    print(f"[aa] K15 full ({fhn}, B=32, K=1024, hidden 64): device time per launch (torch.profiler) "
          f"{k15_dev[0]:.4f}/{k15_dev[2]:.4f} ms (20 launches each, with sum_rows_kernel), plain "
          f"{k15_dev[1]:.4f} ms (5 calls); bound {k15_bound:.4f} ms ({k15_by}); K14 bound "
          f"{k14_bound:.4f} ms ({k14_by}); registers at hidden 64 (Dx, regs) {k15_regs}", flush=True)
    if max(w_rel) > 1e-3:
        fail("K15 at Dx=3, K=2048 disagrees with step_backward_reference")
    del step_runs, k15, k15_args, args15, plain15, w_args, w_got, w_want, winp
    phase_done("aa")

    # (ab) fhn_fivo_k1024_bench with the toggle off: serving and training through K14/K15
    step_plain = (fused_step.step_forward_reference, fused_step.step_backward_reference,
                  fused_step.scan_forward_reference, fused_step.scan_backward_reference,
                  fused_step.stream_noise_reference, fused_step.ancestor_indices_reference)
    step_kernels = (fused_step.step_forward, fused_step.step_backward, fused_step.scan_forward,
                    fused_step.scan_backward)

    def counted(fn):
        for f in step_plain:
            f.calls = 0
        for f in step_kernels:
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, [f.launches for f in step_kernels], sum(f.calls for f in step_plain)

    fused_step.SCAN_FUSED = False
    cfg, batch = slice_config(small=False)
    t1 = cfg.data.t_steps - 1
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    eval_step = pt.make_eval_step(ssm, cfg)
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    metrics, ev_launch, ev_plain = counted(lambda: [eval_step(run_gen, ys) for ys in batches])
    ev_step_ms = [time_ms(lambda: eval_step(run_gen, batches[0])) for _ in range(2)]
    ev_profile = device_breakdown(lambda: eval_step(run_gen, batches[0]), 1, STEP_KERNELS)
    elbos = [float(m_["elbo"]) for m_ in metrics]
    print(f"[ab] serving {fhn}, per-step path: ELBO per batch {[round(e, 3) for e in elbos]}; "
          f"launches K14/K15/K1/K4 {ev_launch} for {len(batches)} eval calls, plain-version calls "
          f"{ev_plain}; eval_step {ev_step_ms[0]:.3f}/{ev_step_ms[1]:.3f} ms per call of B={batch} "
          f"(median of 5 after 2 warm-up, two rounds)", flush=True)
    print(f"[ab] profile of one more eval_step call: {ev_profile}", flush=True)
    if ev_launch != [len(batches) * t1, 0, 0, 0] or ev_plain or not all(map(math.isfinite, elbos)):
        fail(f"per-step serving launched K14/K15/K1/K4 {ev_launch}, plain versions {ev_plain}")

    n_per_call = cfg.train.steps_per_call
    train_step = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
    obs = ds.obs_train.to(dev)
    pick = torch.randint(0, obs.shape[0], (TRAIN_CALLS, n_per_call, batch),
                         generator=torch.Generator().manual_seed(SEED + 7))
    train_batches = [obs[p.to(dev)].contiguous() for p in pick]
    before = [p.detach().clone() for p in ssm.parameters()]
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_step_gb = torch.cuda.memory_allocated() / 1e9
    call_s = []

    def train_calls():
        out = []
        for bt in train_batches:
            t0 = time.perf_counter()
            out.append(train_step(run_gen, bt))
            torch.cuda.synchronize()
            call_s.append(time.perf_counter() - t0)
        return out

    train_metrics, step_train, plain_calls = counted(train_calls)
    peak_step_gb = torch.cuda.max_memory_allocated() / 1e9 - held_step_gb
    losses = [float(m_["loss"]) for m_ in train_metrics]
    norms = [float(m_["grad_norm"]) for m_ in train_metrics]
    moved = any(not torch.equal(a, p) for a, p in zip(before, ssm.parameters()))
    step_fhn_ms = statistics.median(call_s[1:]) / n_per_call * 1e3
    print(f"[ab] training {fhn}, per-step path: {len(train_batches)} calls x {n_per_call} steps, "
          f"B={batch}: loss per call {[round(v, 3) for v in losses]}, grad norm "
          f"{[round(v, 3) for v in norms]}, parameters moved {moved}; launches K14/K15/K1/K4 "
          f"{step_train}, plain-version calls {plain_calls}; call times "
          f"{[round(v, 3) for v in call_s]} s, train step {step_fhn_ms:.3f} ms (median of the calls "
          f"after the first, per step); peak device memory {peak_step_gb:.3f} GB above the "
          f"{held_step_gb:.3f} GB held before", flush=True)
    profile = device_breakdown(lambda: train_step(run_gen, train_batches[0]), n_per_call,
                               STEP_KERNELS)
    print(f"[ab] profile of one more call: {profile}; K14 on S={fused_step.step_forward.last_slices}"
          f", K15 on S={fused_step.step_backward.last_slices} CTAs per row", flush=True)
    fhn_train_batch = train_batches[0]
    want = len(train_batches) * n_per_call * t1
    if step_train != [want, want, 0, 0] or plain_calls != 0:
        fail(f"per-step training launched K14/K15/K1/K4 {step_train} (want [{want}, {want}, 0, 0]), "
             f"plain versions {plain_calls}")
    if not (all(math.isfinite(v) for v in losses + norms) and moved):
        fail("per-step training gave non-finite losses or gradient norms, or left the parameters "
             "as they were")
    # one step's loss and gradients with the toggle off and on, same streams and weights
    ab_ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 16), device=dev)
    ab_ys = train_batches[0][0]
    streams = tsmc._draw_noise(torch.Generator(device=dev).manual_seed(SEED + 17), cfg.smc,
                                 cfg.data.t_steps, batch, 2)
    ab = {}
    for scan_fused in (True, False):
        fused_step.SCAN_FUSED = scan_fused
        for p in ab_ssm.parameters():
            p.grad = None
        fwd = tsmc._forward_filter_fused(ab_ssm, None, ab_ys, cfg.smc, cache=False,
                                           streams=streams)
        loss = -torch.mean(fwd.log_z)
        loss.backward()
        ab[scan_fused] = (float(loss), [p.grad.clone() for p in ab_ssm.parameters()
                                        if p.grad is not None])
    ab_rel = [float((a - b_).norm() / b_.norm().clamp_min(1e-30))
              for a, b_ in zip(ab[False][1], ab[True][1])]
    print(f"[ab] one step on the same streams and weights: loss per-step {ab[False][0]:.6f}, whole "
          f"scan {ab[True][0]:.6f}; per-leaf gradient rel L2 max {max(ab_rel):.3e} over "
          f"{len(ab_rel)} leaves", flush=True)
    if abs(ab[False][0] - ab[True][0]) > 1e-6 * abs(ab[True][0]) or max(ab_rel) > 1e-4:
        fail("the per-step path's loss or gradients differ from the whole-scan path's")
    del ab, ab_ssm
    phase_done("ab")

    # (ac) lorenz63_psvo_k1024 with the toggle off: smooth_posterior and PSVO training
    fused_step.SCAN_FUSED = False
    step_kernels += (ffbsi.ffbsi_forward, ffbsi.ffbsi_backward)
    step_plain += (ffbsi.ffbsi_forward_reference, ffbsi.ffbsi_backward_reference)
    cfg, batch = lcfg, 32
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_l_gb = torch.cuda.memory_allocated() / 1e9
    zero_designs(ffbsi.ffbsi_forward)
    paths, sp_launch, sp_plain = counted(
        lambda: [pt.smooth_posterior(ssm, ys, cfg, run_gen) for ys in l_batches])
    sp_designs = dict(ffbsi.ffbsi_forward.launches_by_design)
    sp_peak_gb = torch.cuda.max_memory_allocated() / 1e9 - held_l_gb
    shapes_ok = all(tuple(p.shape) == (batch, 16, 100, 3) for p in paths)
    finite = all(bool(torch.isfinite(p).all()) for p in paths)
    del paths
    sp_step_ms = [time_ms(lambda: pt.smooth_posterior(ssm, l_batches[0], cfg, run_gen))
                  for _ in range(2)]
    sp_profile = device_breakdown(lambda: pt.smooth_posterior(ssm, l_batches[0], cfg, run_gen), 1,
                                  STEP_PSVO_KERNELS)
    print(f"[ac] serving {l63}, per-step path: smooth_posterior x{len(l_batches)} shapes ok "
          f"{shapes_ok}, finite {finite}; launches K14/K15/K1/K4/K5/K6 {sp_launch} (K5 by design "
          f"{sp_designs}), plain-version calls {sp_plain}; {sp_step_ms[0]:.3f}/{sp_step_ms[1]:.3f} "
          f"ms per call of B={batch} "
          f"(median of 5 after 2 warm-up, two rounds); peak device memory {sp_peak_gb:.3f} GB above "
          f"the {held_l_gb:.3f} GB held before", flush=True)
    print(f"[ac] profile of one more call: {sp_profile}", flush=True)
    n_calls = len(l_batches)
    if (sp_launch != [n_calls * t1, 0, 0, 0, n_calls, 0] or sp_plain or not (shapes_ok and finite)
            or sp_designs != {"staged": n_calls, "path": 0}):
        fail(f"per-step smooth_posterior launched K14/K15/K1/K4/K5/K6 {sp_launch} (K5 by design "
             f"{sp_designs}), plain versions {sp_plain}, shapes ok {shapes_ok}, finite {finite}")

    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED), device=dev)
    train_step = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
    obs = lds.obs_train.to(dev)
    pick = torch.randint(0, obs.shape[0], (TRAIN_CALLS, n_per_call, batch),
                         generator=torch.Generator().manual_seed(SEED + 7))
    train_batches = [obs[p.to(dev)].contiguous() for p in pick]
    before = [p.detach().clone() for p in ssm.parameters()]
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_l_gb = torch.cuda.memory_allocated() / 1e9
    call_s = []
    zero_designs(ffbsi.ffbsi_forward, ffbsi.ffbsi_backward)
    train_metrics, l_train, plain_calls = counted(train_calls)
    l_train_designs = dict(ffbsi.ffbsi_forward.launches_by_design)
    l_train_k6 = dict(ffbsi.ffbsi_backward.launches_by_design)
    peak_l_gb = torch.cuda.max_memory_allocated() / 1e9 - held_l_gb
    losses = [float(m_["loss"]) for m_ in train_metrics]
    norms = [float(m_["grad_norm"]) for m_ in train_metrics]
    moved = any(not torch.equal(a, p) for a, p in zip(before, ssm.parameters()))
    step_l63_ms = statistics.median(call_s[1:]) / n_per_call * 1e3
    print(f"[ac] training {l63}, per-step path: {len(train_batches)} calls x {n_per_call} steps, "
          f"B={batch}: loss per call {[round(v, 3) for v in losses]}, grad norm "
          f"{[round(v, 3) for v in norms]}, parameters moved {moved}; launches K14/K15/K1/K4/K5/K6 "
          f"{l_train} (K5 by design {l_train_designs}, K6 {l_train_k6}), plain-version calls "
          f"{plain_calls}; call "
          f"times {[round(v, 3) for v in call_s]} "
          f"s, train step {step_l63_ms:.3f} ms (median of the calls after the first, per step); "
          f"peak device memory {peak_l_gb:.3f} GB above the {held_l_gb:.3f} GB held before",
          flush=True)
    profile = device_breakdown(lambda: train_step(run_gen, train_batches[0]), n_per_call,
                               STEP_PSVO_KERNELS)
    print(f"[ac] profile of one more call: {profile}", flush=True)
    n_steps = len(train_batches) * n_per_call
    if (l_train != [n_steps * t1, n_steps * t1, 0, 0, n_steps, n_steps] or plain_calls != 0
            or l_train_designs != {"staged": n_steps, "path": 0}
            or l_train_k6 != {"staged": n_steps, "row": 0}):
        fail(f"per-step PSVO training launched K14/K15/K1/K4/K5/K6 {l_train} (K5 by design "
             f"{l_train_designs}, K6 {l_train_k6}), plain versions {plain_calls}")
    if not (all(math.isfinite(v) for v in losses + norms) and moved):
        fail("per-step PSVO training gave non-finite losses or gradient norms, or left the "
             "parameters as they were")
    fused_step.SCAN_FUSED = True
    phase_done("ac")

    # (ad) K1 and K4 by cluster size, at the FHN and Lorenz-63 shapes
    sweeps_c = {}
    for preset, ys, rng_seed, cache in ((fhn, batches[0], (21, 0xBEEF), False),
                                        (l63, l_batches[0], None, True)):
        cfg, batch = slice_config(False, preset)
        ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 19), device=dev)
        with torch.no_grad():
            sw = cluster_sweep(ssm, cfg, ys, gen, rng_seed, cache)
        sweeps_c[preset] = sw
        for kern, name_k, ok_key in ((0, "K1", "equal"), (1, "K4", "dx0_equal")):
            print(f"[ad] {name_k} {preset} B={batch} K={cfg.smc.n_particles} "
                  f"({'in-kernel draw' if rng_seed else 'stream'}{', cache' if cache else ''}): "
                  f"max_active {sw['max_active'][kern]}, chosen C={sw['chosen'][kern]} "
                  f"({batch * sw['chosen'][kern]} CTAs); times by C (ms, median of 5 after 2 "
                  f"warm-up, in the order 1, chosen, others, chosen, 1) "
                  + ", ".join(f"C={c}: " + "/".join(f"{v:.3f}" for v in ts)
                              for c, ts in sw["ms"][kern].items()), flush=True)
        for c, r in sw["k1"].items():
            print(f"[ad] K1 {preset} C={c}: every output (x_last, alpha_last, stats, x_all, "
                  f"alpha_all, idx; 99 free-running steps) bit-equal to C=1 {r['equal']}, "
                  f"bit-equal on a relaunch {r['same']}", flush=True)
        for c, r in sw["k4"].items():
            print(f"[ad] K4 {preset} C={c}: d_x0 bit-equal to C=1 {r['dx0_equal']}, rel L2 to C=1 "
                  + ", ".join(f"{n} {e:.3e}" for n, e in zip(leaves[1:], r["rel"]))
                  + f", bit-equal on a relaunch {r['same']}", flush=True)
        if not all(r["equal"] and r["same"] for r in sw["k1"].values()):
            fail(f"K1 on clusters ({preset}) is not bit-equal to one CTA per row")
        if not all(r["dx0_equal"] and r["same"] and max(r["rel"]) <= 1e-6 for r in sw["k4"].values()):
            fail(f"K4 on clusters ({preset}) disagrees with one CTA per row")
        if min(sw["chosen"]) < 2:
            fail(f"{preset}: K1/K4 chose C={sw['chosen']} at B={batch}, K={cfg.smc.n_particles}")
    fhn_c = sweeps_c[fhn]
    k1_c, k4_c = fhn_c["chosen"]
    k1_ms, k1_ms_c1 = (statistics.mean(fhn_c["ms"][0][c]) for c in (k1_c, 1))
    k4_ms, k4_ms_c1 = (statistics.mean(fhn_c["ms"][1][c]) for c in (k4_c, 1))
    print(f"[ad] {fhn}: K1 at C={k1_c} {k1_ms:.3f} ms vs C=1 {k1_ms_c1:.3f} ms, bound {k1_bound:.3f} "
          f"ms ({100 * k1_bound / k1_ms:.1f}% of it, {100 * k1_bound / k1_ms_c1:.1f}% at C=1); K4 at "
          f"C={k4_c} {k4_ms:.3f} ms vs C=1 {k4_ms_c1:.3f} ms, bound {k4_bound:.3f} ms "
          f"({100 * k4_bound / k4_ms:.1f}%, {100 * k4_bound / k4_ms_c1:.1f}% at C=1)", flush=True)
    if not (k1_ms < k1_ms_c1 and k4_ms < k4_ms_c1):
        fail("K1 or K4 at the chosen cluster size is not faster than at one CTA per row")
    phase_done("ad")

    # (ae) K14 and K15 by slice count S, at the FHN and Lorenz-63 shapes
    def k15_ms(t, part="step_backward_kernel"):
        return sum(v for n_, v in t.items() if part in n_)

    sweeps_s = {}
    for preset in (fhn, l63):
        with torch.no_grad():
            sw = slice_sweep(*slice_inputs[preset], gen)
        sweeps_s[preset] = sw
        b_, k_ = slice_inputs[preset][0][0].shape[0], slice_inputs[preset][0][0].shape[-1]
        n_w = slice_inputs[preset][0][3]["packed"].numel()
        for kern, name_k in ((0, "K14"), (1, "K15")):
            print(f"[ae] {name_k} {preset} B={b_} K={k_} hidden "
                  f"{slice_inputs[preset][0][3]['hidden']}: resident CTAs "
                  f"{sw['resident'][kern]}, chosen S={sw['chosen'][kern]} "
                  f"({b_ * sw['chosen'][kern]} CTAs); device time per launch by S (ms, "
                  f"torch.profiler over 20 launches, in the order 1, chosen, others, chosen, 1) "
                  + ", ".join(f"S={s_}: " + "/".join(f"{sum(t.values()):.4f}" for t in ts)
                              for s_, ts in sw["ms"][kern].items()), flush=True)
        print(f"[ae] K15 {preset}: partial-row traffic, sum_rows_kernel per launch by S (ms; "
              f"B·S rows of {n_w + 2 * slice_inputs[preset][0][0].shape[1]} floats) "
              + ", ".join(f"S={s_}: " + "/".join(f"{k15_ms(t, 'sum_rows_kernel'):.4f}"
                                                  for t in ts)
                          for s_, ts in sw["ms"][1].items())
              + "; step_backward_kernel alone " + ", ".join(
                  f"S={s_}: " + "/".join(f"{k15_ms(t):.4f}" for t in ts)
                  for s_, ts in sw["ms"][1].items()), flush=True)
        for s_, r in sw["k14"].items():
            print(f"[ae] K14 {preset} S={s_}: every output (x_new, alpha, stats, idx) bit-equal to "
                  f"S=1 {r['equal']}, bit-equal on a relaunch {r['same']}", flush=True)
        for s_, r in sw["k15"].items():
            print(f"[ae] K15 {preset} S={s_}: d_x bit-equal to S=1 {r['dx_equal']}, rel L2 to S=1 "
                  + ", ".join(f"{n} {e:.3e}" for n, e in zip(leaves[1:], r["rel"]))
                  + "".join(f"; {leaves[i]} vs a float64 replay {a:.3e} (S=1 {w:.3e})"
                            for i, (a, w) in r["vs64"].items())
                  + f", bit-equal on a relaunch {r['same']}", flush=True)
        if not all(r["equal"] and r["same"] for r in sw["k14"].values()):
            fail(f"K14 on slices ({preset}) is not bit-equal to one CTA per row")
        for s_, r in sw["k15"].items():
            sums_ok = all(e <= 1e-6 or (i in r["vs64"] and r["vs64"][i][0] <= r["vs64"][i][1])
                          for i, e in enumerate(r["rel"], 1))
            if not (r["dx_equal"] and r["same"] and sums_ok):
                fail(f"K15 on {s_} slices ({preset}) disagrees with one CTA per row")
        if min(sw["chosen"]) < 2:
            fail(f"{preset}: K14/K15 chose S={sw['chosen']} at B={b_}, K={k_}")
    # inside one per-step train call of FHN: K14's and K15's device time per launch by S
    fused_step.SCAN_FUSED = False
    cfg, batch = slice_config(small=False)
    ssm = pt.init_ssm(cfg, torch.Generator().manual_seed(SEED + 20), device=dev)
    train_step = pt.make_train_step(ssm, cfg, pt.make_optimizer(cfg))
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    fhn_s = sweeps_s[fhn]
    both = [s_ for s_ in fhn_s["sizes"][0] if s_ in fhn_s["sizes"][1]]
    c_ = fhn_s["chosen"][0]
    launches_per_call = cfg.train.steps_per_call * (cfg.data.t_steps - 1)
    pick_s, in_step = fused_step.step_slices, {}
    try:
        for s_ in [1, c_] + [v for v in both if v not in (1, c_)]:
            fused_step.step_slices = lambda *_, s_=s_: s_
            t = device_ms_by_kernel(lambda: train_step(run_gen, fhn_train_batch), n=1)
            t0 = time.perf_counter()
            train_step(run_gen, fhn_train_batch)
            torch.cuda.synchronize()
            in_step.setdefault(s_, []).append(
                (k15_ms(t, "step_forward_kernel") / launches_per_call,
                 (k15_ms(t) + k15_ms(t, "sum_rows_kernel")) / launches_per_call,
                 sum(t.values()) / cfg.train.steps_per_call,
                 (time.perf_counter() - t0) / cfg.train.steps_per_call * 1e3))
    finally:
        fused_step.step_slices = pick_s
        fused_step.SCAN_FUSED = True
    print(f"[ae] inside one per-step train call of {fhn} ({cfg.train.steps_per_call} steps, "
          f"{launches_per_call} launches of each), by S (K14 ms / K15 ms with sum_rows per launch, "
          f"device busy ms per step, then one more call's host-clock ms per step; order 1, chosen, "
          f"others): "
          + ", ".join(f"S={s_}: " + "; ".join(f"{a:.4f} / {b_:.4f}, {c:.2f}, {d:.2f}"
                                              for a, b_, c, d in v)
                      for s_, v in in_step.items()), flush=True)
    k14_s, k15_s = fhn_s["chosen"]
    k14_ms_s1 = statistics.mean(sum(t.values()) for t in fhn_s["ms"][0][1])
    k15_ms_s1 = statistics.mean(sum(t.values()) for t in fhn_s["ms"][1][1])
    phase_done("ae")

    # (af) PSVO training under the direct bound: K6's all-cotangents branch on the path
    dcfg = dataclasses.replace(lcfg, smc=dataclasses.replace(lcfg.smc, psvo_bound="direct"),
                               train=dataclasses.replace(lcfg.train, steps_per_call=1))
    batch = 32
    ssm = pt.init_ssm(dcfg, torch.Generator().manual_seed(SEED), device=dev)
    train_step = pt.make_train_step(ssm, dcfg, pt.make_optimizer(dcfg))
    obs = lds.obs_train.to(dev)
    pick = torch.randint(0, obs.shape[0], (3, batch), generator=torch.Generator().manual_seed(SEED + 23))
    direct_batches = [obs[p_.to(dev)].contiguous() for p_ in pick]
    before = [p_.detach().clone() for p_ in ssm.parameters()]
    run_gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    l_kernels = (fused_step.scan_forward, fused_step.scan_backward, ffbsi.ffbsi_forward,
                 ffbsi.ffbsi_backward)
    l_plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
               fused_step.stream_noise_reference, fused_step.ancestor_indices_reference,
               ffbsi.ffbsi_forward_reference, ffbsi.ffbsi_backward_reference)
    for fn in l_plain:
        fn.calls = 0
    for fn in l_kernels:
        fn.launches = 0
    zero_designs(ffbsi.ffbsi_forward, ffbsi.ffbsi_backward)
    torch.cuda.synchronize()
    step_s, direct_metrics = [], []
    for bt in direct_batches:
        t0 = time.perf_counter()
        direct_metrics.append(train_step(run_gen, bt))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    direct_launches = [fn.launches for fn in l_kernels]
    direct_designs = (dict(ffbsi.ffbsi_forward.launches_by_design),
                      dict(ffbsi.ffbsi_backward.launches_by_design))
    plain_calls = sum(fn.calls for fn in l_plain)
    losses = [float(m_["loss"]) for m_ in direct_metrics]
    norms = [float(m_["grad_norm"]) for m_ in direct_metrics]
    moved = any(not torch.equal(a_, p_) for a_, p_ in zip(before, ssm.parameters()))
    direct_step_ms = statistics.median(step_s[1:]) * 1e3
    print(f"[af] training {l63} under psvo_bound=\"direct\": {len(direct_batches)} steps, B={batch}: "
          f"loss {[round(v, 3) for v in losses]}, grad norm {[round(v, 3) for v in norms]}, "
          f"parameters moved {moved}; launches K1/K4/K5/K6 {direct_launches} (K5 by design "
          f"{direct_designs[0]}, K6 {direct_designs[1]}), plain-version calls {plain_calls}; step "
          f"times {[round(1e3 * v, 3) for v in step_s]} ms, train step {direct_step_ms:.3f} ms "
          f"(median of the steps after the first)", flush=True)
    profile = device_breakdown(lambda: train_step(run_gen, direct_batches[0]), 1, PSVO_KERNELS)
    print(f"[af] profile of one more step: {profile}", flush=True)
    n_direct = len(direct_batches)
    if (direct_launches != [n_direct] * 4 or plain_calls != 0
            or direct_designs != ({"staged": n_direct, "path": 0}, {"staged": n_direct, "row": 0})):
        fail(f"direct-bound PSVO training launched K1/K4/K5/K6 {direct_launches} (want {n_direct} "
             f"each, K5 and K6 all staged: {direct_designs}), plain versions {plain_calls}")
    if not (all(math.isfinite(v) for v in losses + norms) and moved):
        fail("direct-bound PSVO training gave non-finite losses or gradient norms, or left the "
             "parameters as they were")
    phase_done("af")

    ctrl = controls_phases(pt, dev, card)
    seg = segmented_phases(pt, dev, card)
    cli_figs = cli_phases(pt, dev, card)
    gen_figs = general_phases(pt, dev, card)
    sm_figs = smoothing_controls_phases(pt, dev, card)
    mn_figs = multinomial_phases(pt, dev, card)
    tc_figs = trunk_class_phases(pt, dev, card)
    routes_figs = eager_routes_phases(pt, dev, card)
    shard_figs = sharded_phases(pt, dev, card)
    class_figs = step_class_phases(pt, dev, card)
    reach_figs = reach_phases(pt, dev, card)
    bg_figs = smoothing_class_phases(pt, dev, card)
    bh_figs = wide_step_phases(pt, dev, card)


    # K3: the CDF scan and a binary search per particle; logw and u0 in, int32 indices out.
    k3_bound, k3_by = bound(2.0 * bl.numel() * (1 + math.log2(bl.shape[-1])),
                            nbytes(bl, bu) + bl.numel() * 4)
    kernels = [
        # K2: about 80 operations per normal (the count of earlier runs: a Philox4x32-10
        # call of about 100 integer operations per two normals, the Box-Muller transform
        # about 30 each), counted at the fp32 rate; its output written once. "ms" and
        # "ms_prev" are the pair and particle designs' device times at the FHN width,
        # "*_l96" at Lorenz-96's.
        {"name": "stream_noise", "route": "cuda", "source": "psvo_tpu_torch/csrc/stream_noise.cu",
         "replaces": "psvo_tpu/ops/pallas_step.py:540", "launches": 0, "on_path": False,
         "max_abs_err": k2["err"], "ms": k2["ms"], "plain_ms": k2["plain"],
         "bound_ms": k2["bound"], "bound_by": k2["by"], "library_ms": None,
         "ms_prev": k2["ms_prev"], "ms_l96": k2l["ms"], "ms_prev_l96": k2l["ms_prev"],
         "plain_ms_l96": k2l["plain"], "bound_ms_l96": k2l["bound"]},
        {"name": "ancestor_indices", "route": "cuda", "source": "psvo_tpu_torch/csrc/ancestor_indices.cu",
         "replaces": "psvo_tpu/ops/pallas_resample.py:210", "launches": 0, "on_path": False,
         "max_abs_err": float(k3_err), "ms": k3_ms, "plain_ms": k3_plain,
         "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None},
        {"name": "scan_forward", "route": "cuda", "source": "psvo_tpu_torch/csrc/scan_forward.cuh",
         "replaces": "psvo_tpu/ops/pallas_step.py:1327", "launches": k1_train,
         "max_abs_err": results["small"]["max_abs_err"], "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None, "cluster": k1_c,
         "ms_c1": k1_ms_c1, **seg_launches(seg, 0), **cli_launches(cli_figs, 0)},
        {"name": "scan_backward", "route": "cuda", "source": "psvo_tpu_torch/csrc/scan_backward.cuh",
         "replaces": "psvo_tpu/ops/pallas_step.py:1425", "launches": k4_train,
         "max_abs_err": max(bwd[("small", "stream")]["maxd"]), "ms": k4_ms, "plain_ms": k4_plain,
         "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": None, "cluster": k4_c,
         "ms_c1": k4_ms_c1, **seg_launches(seg, 1), **cli_launches(cli_figs, 1)},
        {"name": "ffbsi_forward", "route": "cuda", "source": "psvo_tpu_torch/csrc/ffbsi.cu",
         "replaces": "psvo_tpu/ops/pallas_ffbsi.py:294", "launches": psvo_launches[2],
         "max_abs_err": sweeps["small"][1]["max_abs_err"], "ms": k5[0], "plain_ms": k5[1],
         "bound_ms": k5_bound, "bound_by": k5_by, "library_ms": None, "ms_prev": k5[2],
         **seg_launches(seg, 2), **cli_launches(cli_figs, 2)},
        # K6: "ms" the paths-only branch (the forward bound's, on the path), "*_all" and
        # "*_direct" the all-cotangents branch with every cotangent and with the direct
        # bound's; "ms_prev*" the row design's, alternated with the staged one.
        {"name": "ffbsi_backward", "route": "cuda", "source": "psvo_tpu_torch/csrc/ffbsi.cu",
         "replaces": "psvo_tpu/ops/pallas_ffbsi.py:358", "launches": psvo_launches[3],
         "max_abs_err": max(max(rb["maxd"]) for rb in sweeps["small"][1]["bwd"].values()),
         "ms": k6["paths only"]["ms"], "plain_ms": k6["paths only"]["plain"],
         "bound_ms": k6_bound["paths only"][0], "bound_by": k6_bound["paths only"][1],
         "library_ms": None, "ms_prev": k6["paths only"]["ms_prev"],
         "ms_all": k6["all cotangents"]["ms"], "ms_prev_all": k6["all cotangents"]["ms_prev"],
         "plain_ms_all": k6["all cotangents"]["plain"],
         "bound_ms_all": k6_bound["all cotangents"][0],
         "ms_direct": k6["direct bound"]["ms"], "ms_prev_direct": k6["direct bound"]["ms_prev"],
         "bound_ms_direct": k6_bound["direct bound"][0], "launches_direct": direct_launches[3],
         **seg_launches(seg, 3), **cli_launches(cli_figs, 3)},
        {"name": "ancestor_indices_large", "route": "cuda",
         "source": "psvo_tpu_torch/csrc/resample_gather.cu",
         "replaces": "psvo_tpu/ops/pallas_resample.py:338",
         "launches": serve_launches["filter_posterior"][0], "max_abs_err": 0.0, "ms": k7_dev[0],
         "plain_ms": k7_dev[1], "bound_ms": k7_bound, "bound_by": k7_by, "library_ms": None,
         "ms_prev": k7_dev[2]},
        {"name": "gather_particles", "route": "cuda", "source": "psvo_tpu_torch/csrc/resample_gather.cu",
         "replaces": "psvo_tpu/ops/pallas_resample.py:489",
         "launches": serve_launches["filter_posterior"][1], "max_abs_err": 0.0, "ms": k8_dev[0],
         "plain_ms": k8_dev[1], "bound_ms": k8_bound, "bound_by": k8_by, "library_ms": k8_dev[2]},
        {"name": "trunk_forward", "route": "cuda", "source": "psvo_tpu_torch/csrc/trunk_forward.cuh",
         "replaces": "psvo_tpu/ops/pallas_trunk.py:350",
         "launches": serve_launches["filter_posterior"][2], "max_abs_err": k9_small_err,
         "ms": k9_dev[0], "plain_ms": k9_dev[1], "bound_ms": k9_bound, "bound_by": k9_by,
         "library_ms": None, "ms_prev": k9_dev[3]},
        {"name": "trunk_backward", "route": "cuda", "source": "psvo_tpu_torch/csrc/trunk_backward.cuh",
         "replaces": "psvo_tpu/ops/pallas_trunk.py:419", "launches": train_launches[3],
         "on_path": True, "max_abs_err": k10_small_err, "ms": k10_ms, "plain_ms": k10_plain,
         "bound_ms": k10_bound, "bound_by": k10_by, "library_ms": None, "ms_simt": k10_ms_simt,
         "bound_split_ms": k10_split},
        {"name": "segment_sum_scatter", "route": "cuda",
         "source": "psvo_tpu_torch/csrc/resample_gather.cu",
         "replaces": "psvo_tpu/ops/pallas_resample.py:902", "launches": train_launches[4],
         "on_path": True, "max_abs_err": max(r["maxd"] for r in k11.values()), "ms": k11_dev[0],
         "plain_ms": k11_dev[1], "bound_ms": k11_bound, "bound_by": k11_by,
         "library_ms": k11_dev[2], "ms_prev": k11_dev[5]},
        {"name": "svo_sweep_forward", "route": "cuda",
         "source": "psvo_tpu_torch/csrc/svo_sweep.cuh",
         "replaces": "psvo_tpu/ops/pallas_svo.py:446", "launches": svo_launches[2],
         "on_path": True, "max_abs_err": k12_small_err, "ms": k12_dev[0], "plain_ms": k12_dev[1],
         "bound_ms": k12_bound, "bound_by": k12_by, "library_ms": None, "ms_prev": k12_dev[2]},
        {"name": "svo_sweep_backward", "route": "cuda",
         "source": "psvo_tpu_torch/csrc/svo_sweep.cuh",
         "replaces": "psvo_tpu/ops/pallas_svo.py:521", "launches": svo_launches[3],
         "on_path": True, "max_abs_err": k13_small_err, "ms": k13_dev[0], "plain_ms": k13_dev[1],
         "bound_ms": k13_bound, "bound_by": k13_by, "library_ms": None, "ms_prev": k13_dev[2]},
        {"name": "step_forward", "route": "cuda", "source": "psvo_tpu_torch/csrc/scan_forward.cuh",
         "replaces": "psvo_tpu/ops/pallas_step.py:954", "launches": step_train[0],
         "on_path": True, "max_abs_err": k14_small_err, "ms": k14_dev[0], "plain_ms": k14_dev[1],
         "bound_ms": k14_bound, "bound_by": k14_by, "library_ms": None, "slices": k14_s,
         "ms_s1": k14_ms_s1},
        {"name": "step_backward", "route": "cuda", "source": "psvo_tpu_torch/csrc/scan_backward.cuh",
         "replaces": "psvo_tpu/ops/pallas_step.py:1013", "launches": step_train[1],
         "on_path": True, "max_abs_err": k15_small_err, "ms": k15_dev[0], "plain_ms": k15_dev[1],
         "bound_ms": k15_bound, "bound_by": k15_by, "library_ms": None, "slices": k15_s,
         "ms_s1": k15_ms_s1},
        # K1, K4, K14 and K15 in their control mode (fhn_fivo_controls: B=32, K=128, T=100,
        # hidden (64, 64), Di=2, stream noise): launches from phase ai's training runs, times
        # from phase ag, bounds with the glue's u·W_u counted in.
        {"name": "scan_forward (controls)", "route": "cuda",
         "source": "psvo_tpu_torch/csrc/scan_forward.cuh", "replaces": "psvo_tpu/ops/pallas_step.py:1327",
         "launches": ctrl["train"][True][0][0], "on_path": True, "max_abs_err": ctrl["err"]["K1"],
         "ms": ctrl["k1"][0], "plain_ms": ctrl["k1"][1], "bound_ms": ctrl["k1_bound"][0],
         "bound_by": ctrl["k1_bound"][1],
         "library_ms": None},
        {"name": "scan_backward (controls)", "route": "cuda",
         "source": "psvo_tpu_torch/csrc/scan_backward.cuh", "replaces": "psvo_tpu/ops/pallas_step.py:1425",
         "launches": ctrl["train"][True][0][1], "on_path": True, "max_abs_err": ctrl["err"]["K4"],
         "ms": ctrl["k4"][0], "plain_ms": ctrl["k4"][1], "bound_ms": ctrl["k4_bound"][0],
         "bound_by": ctrl["k4_bound"][1],
         "library_ms": None},
        {"name": "step_forward (controls)", "route": "cuda",
         "source": "psvo_tpu_torch/csrc/scan_forward.cuh", "replaces": "psvo_tpu/ops/pallas_step.py:954",
         "launches": ctrl["train"][False][0][2], "on_path": True, "max_abs_err": ctrl["err"]["K14"],
         "ms": ctrl["k14"][0], "plain_ms": ctrl["k14"][1],
         "bound_ms": ctrl["k14_bound"][0], "bound_by": ctrl["k14_bound"][1],
         "library_ms": None},
        {"name": "step_backward (controls)", "route": "cuda",
         "source": "psvo_tpu_torch/csrc/scan_backward.cuh", "replaces": "psvo_tpu/ops/pallas_step.py:1013",
         "launches": ctrl["train"][False][0][3], "on_path": True, "max_abs_err": ctrl["err"]["K15"],
         "ms": ctrl["k15"][0], "plain_ms": ctrl["k15"][1],
         "bound_ms": ctrl["k15_bound"][0], "bound_by": ctrl["k15_bound"][1],
         "library_ms": None},
    ]
    # K7, K8 and K11 on the general path (the presets the reference's kernel gates exclude, at
    # B=32, K=128, D=2): launches from phase ap's training runs of the three resampling presets
    # (99 a step each; "launches_serve" a filter), times and bounds at that shape
    gk = gen_figs["kernels"]
    resampling_presets = [p_ for p_ in GENERAL if gen_figs["ap"][p_]["train_total"][0]]
    for i, (kernel, times, source_line) in enumerate((
            ("ancestor_indices_large", gk["k7"], "psvo_tpu/ops/pallas_resample.py:338"),
            ("gather_particles", gk["k8"], "psvo_tpu/ops/pallas_resample.py:489"),
            ("segment_sum_scatter", gk["k11"], "psvo_tpu/ops/pallas_resample.py:902"))):
        kernels.append({
            "name": f"{kernel} (general path)", "route": "cuda",
            "source": "psvo_tpu_torch/csrc/resample_gather.cu", "replaces": source_line,
            "launches": sum(gen_figs["ap"][p_]["train_total"][i] for p_ in resampling_presets),
            "on_path": True, "max_abs_err": gk["errs"][i], "ms": times[0], "plain_ms": times[1],
            "bound_ms": gk["bounds"][i][0], "bound_by": gk["bounds"][i][1],
            "library_ms": times[2],
            "launches_serve": gen_figs["ap"][resampling_presets[0]]["serve"][i],
            "launches_cli": gen_figs["as"]["fhn_fivo_tril"]["launches"][i]})
    # K12 and K13 in their control mode (lorenz63_svo_k256 with Di=2: B=32, M=16, T=100, hidden
    # (64, 64)): launches from phase au's training steps, times and bounds (the glue's u·W_u
    # counted in) from phase au, "ms_uncontrolled" the same shape without controls alternated
    # with it; K1 and K14 on multinomial positions (fhn_fivo_k1024_bench, stream noise):
    # launches from phase av's training steps, times and bounds from phase av
    for kernel, fig, source, line, launches in (
            ("svo_sweep_forward (controls)", sm_figs["k12"], "psvo_tpu_torch/csrc/svo_sweep.cuh",
             "psvo_tpu/ops/pallas_svo.py:446", sm_figs["au"]["train"][2]),
            ("svo_sweep_backward (controls)", sm_figs["k13"], "psvo_tpu_torch/csrc/svo_sweep.cuh",
             "psvo_tpu/ops/pallas_svo.py:521", sm_figs["au"]["train"][3])):
        kernels.append({"name": kernel, "route": "cuda", "source": source, "replaces": line,
                        "launches": launches, "on_path": True, "max_abs_err": fig["err"],
                        "ms": fig["ms"], "plain_ms": fig["plain"], "bound_ms": fig["bound"][0],
                        "bound_by": fig["bound"][1], "library_ms": None,
                        "ms_uncontrolled": fig["ms_unc"]})
    kernels.append({"name": "scan_forward (multinomial)", "route": "cuda",
                    "source": "psvo_tpu_torch/csrc/scan_forward.cuh",
                    "replaces": "psvo_tpu/ops/pallas_step.py:1327",
                    "launches": mn_figs["fhn"][True]["train"][0], "on_path": True,
                    "max_abs_err": mn_figs["small"]["err"], "ms": mn_figs["k1"]["ms"],
                    "plain_ms": mn_figs["k1"]["plain"], "bound_ms": mn_figs["k1"]["bound"][0],
                    "bound_by": mn_figs["k1"]["bound"][1], "library_ms": None})
    kernels.append({"name": "step_forward (multinomial)", "route": "cuda",
                    "source": "psvo_tpu_torch/csrc/scan_forward.cuh",
                    "replaces": "psvo_tpu/ops/pallas_step.py:954",
                    "launches": mn_figs["fhn"][False]["train"][2], "on_path": True,
                    "max_abs_err": mn_figs["k14"]["err"], "ms": mn_figs["k14"]["ms"],
                    "plain_ms": mn_figs["k14"]["plain"], "bound_ms": mn_figs["k14"]["bound"][0],
                    "bound_by": mn_figs["k14"]["bound"][1], "library_ms": None})
    # K9 and K10 at the FHN and Lorenz-63 widths (B=32, K=1024, hidden (64, 64), in-kernel draw)
    # and in their control mode (Di=2) at fhn_fivo_controls' width (B=32, K=1024) and
    # Lorenz-96's (B=8, K=8192): launches from phase ax's training steps of the configurations
    # at that width, times and bounds from phase aw ("ms_uncontrolled" the same launch without
    # controls, alternated with it)
    ax = tc_figs["ax"]
    for label, fig, ax_labels in (
            ("FHN width", tc_figs["aw"][2], ("fhn ess", "fhn full gradient", "fhn iwae k128")),
            ("Lorenz-63 width", tc_figs["aw"][3], ("l63 psvo ess",))):
        for i, (kernel, src, line) in enumerate((
                ("trunk_forward", "psvo_tpu_torch/csrc/trunk_forward.cuh",
                 "psvo_tpu/ops/pallas_trunk.py:350"),
                ("trunk_backward", "psvo_tpu_torch/csrc/trunk_backward.cuh",
                 "psvo_tpu/ops/pallas_trunk.py:419"))):
            t_, b_ = (fig["k9"], fig["b9"]) if i == 0 else (fig["k10"], fig["b10"])
            kernels.append({"name": f"{kernel} ({label})", "route": "cuda", "source": src,
                            "replaces": line,
                            "launches": sum(ax[l_]["train"][2 + i] for l_ in ax_labels),
                            "on_path": True, "max_abs_err": fig["err9"] if i == 0 else fig["err10"],
                            "ms": t_[0], "plain_ms": t_[1], "bound_ms": b_[0], "bound_by": b_[1],
                            "library_ms": None})
    for label, preset, ax_label in (("controls, FHN width", CTRL, "fhn controls ess"),
                                    ("controls, Lorenz-96 width", L96, "l96 controls")):
        c = tc_figs["ctrl"][preset]
        for i, (kernel, src, line) in enumerate((
                ("trunk_forward", "psvo_tpu_torch/csrc/trunk_forward.cuh",
                 "psvo_tpu/ops/pallas_trunk.py:350"),
                ("trunk_backward", "psvo_tpu_torch/csrc/trunk_backward.cuh",
                 "psvo_tpu/ops/pallas_trunk.py:419"))):
            t_, b_ = (c["k9"], c["b9"]) if i == 0 else (c["k10"], c["b10"])
            err = max(r[("err9", "err10")[i]] for r in c["modes"].values())
            kernels.append({"name": f"{kernel} ({label})", "route": "cuda", "source": src,
                            "replaces": line, "launches": ax[ax_label]["train"][2 + i],
                            "on_path": True, "max_abs_err": err, "ms": t_[0], "plain_ms": t_[2],
                            "bound_ms": b_[0], "bound_by": b_[1], "library_ms": None,
                            "ms_uncontrolled": t_[1]})
    # phases ay-ba's launches on the rows of the kernels they ran: the train steps of each
    # configuration (3 for A-E, one for each F variant)
    route_rows = {"scan_forward": "K1", "scan_backward": "K4", "ffbsi_forward": "K5",
                  "ffbsi_backward": "K6", "ancestor_indices_large": "K7",
                  "gather_particles": "K8", "segment_sum_scatter": "K11",
                  "ancestor_indices_large (general path)": "K7",
                  "gather_particles (general path)": "K8",
                  "segment_sum_scatter (general path)": "K11",
                  "trunk_forward": "K9", "trunk_backward": "K10"}
    for row in kernels:
        if row["name"] in route_rows:
            i = ROUTE_NAMES.index(route_rows[row["name"]])
            row["launches_routes"] = dict(
                {c_: routes_figs[c_]["train"][i] for c_ in "ABCDE"},
                **{f"F {v}": routes_figs["F"][v]["train"][i] for v in routes_figs["F"]})
    # K7, K8 and K11 on the sharded path (phases bb-bd): "launches_sharded" on their rows (the
    # launches per rank of the 1x8 mesh's eval, a filter, and train step in bc, of the 2x2 PSVO
    # step in bd and of one island call on 8 ranks in bb), and rows of their own at the 1x8
    # mesh's per-shard shape (B=8, K/P=1024, D=40) timed by pair_ms in bb, whose "launches" are
    # a rank's per train step of bc
    sk, bc, bd = shard_figs["kernels"], shard_figs["bc"], shard_figs["bd"]
    shard_rows = {"ancestor_indices_large": "K7", "gather_particles": "K8",
                  "segment_sum_scatter": "K11"}

    def launches_sharded(kk):
        return {f"bc eval at T={bc['eval']['t']}, per rank": bc["eval"]["launches"].get(kk, 0),
                f"bc train step at T={SHARD_T}, per rank":
                    bc["steps"][0]["launches"].get(kk, 0),
                "bd 2x2 PSVO step, per rank": bd["psvo_launches"].get(kk, 0),
                "bb island on 8 ranks, per rank": shard_figs["bb8"]["island"]["launches"].get(kk, 0)}

    for row in kernels:
        if row["name"] in shard_rows:
            row["launches_sharded"] = launches_sharded(shard_rows[row["name"]])
    for i, (kernel, line) in enumerate((
            ("ancestor_indices_large", "psvo_tpu/ops/pallas_resample.py:837"),
            ("gather_particles", "psvo_tpu/ops/pallas_resample.py:837"),
            ("segment_sum_scatter", "psvo_tpu/ops/pallas_resample.py:902"))):
        kk = shard_rows[kernel]
        kernels.append({"name": f"{kernel} (sharded, per shard)", "route": "cuda",
                        "source": "psvo_tpu_torch/csrc/resample_gather.cu", "replaces": line,
                        "launches": bc["steps"][0]["launches"].get(kk, 0), "on_path": True,
                        "max_abs_err": sk["errs"][i], "ms": sk["times"][i][0],
                        "plain_ms": sk["times"][i][1], "bound_ms": sk["bounds"][i][0],
                        "bound_by": sk["bounds"][i][1], "library_ms": sk["times"][i][2],
                        "launches_sharded": launches_sharded(kk)})
    # K1, K4, K14 and K15 at phase be's shapes beyond the presets' (STEP_CLASS, B=32, T=100):
    # launches from its 3 train steps (K14/K15 with SCAN_FUSED off), times, plain times and
    # bounds at the full shape, max_abs_err the largest of the small and full checks
    # (K1/K14 teacher-forced)
    for label, fig in class_figs.items():
        rows = [("scan_forward", "k1", "scan_forward.cuh", "1327", "whole scan", 0),
                ("scan_backward", "k4", "scan_backward.cuh", "1425", "whole scan", 1)]
        if "k14" in fig["times"]:
            rows += [("step_forward", "k14", "scan_forward.cuh", "954", "SCAN_FUSED off", 2),
                     ("step_backward", "k15", "scan_backward.cuh", "1013", "SCAN_FUSED off", 3)]
        for kernel, kk, src, line, mode, j in rows:
            kernels.append({
                "name": f"{kernel} ({label})", "route": "cuda",
                "source": f"psvo_tpu_torch/csrc/{src}", "replaces": f"psvo_tpu/ops/pallas_step.py:{line}",
                "launches": fig[mode]["train"][j], "on_path": True,
                "max_abs_err": max(fig["small"][kk], fig["full"][kk]),
                "ms": fig["times"][kk][0], "plain_ms": fig["times"][kk][1],
                "bound_ms": fig["bounds"][kk][0], "bound_by": fig["bounds"][kk][1],
                "library_ms": None, "shape_library": fig["keys"][j % 2]})
    kernels += reach_rows(reach_figs)
    kernels += smoothing_class_rows(bg_figs)
    kernels += wide_rows(bh_figs)
    print(f"[profiler] {PROFILE_WINDOWS['windows']} profiler windows, "
          f"{PROFILE_WINDOWS['empty']} of them with no device events (run again); of the timing "
          f"windows, {PROFILE_WINDOWS['partial']} recorded part of a kernel's events (timed by "
          f"the mean of those recorded), {PROFILE_WINDOWS['events']} timed by CUDA events "
          f"instead (the profiler recorded none); {PROFILE_WINDOWS['queue_ran_dry']} queued "
          f"windows ran dry", flush=True)
    print("[summary] phase bg (d): " + (
        f"the presets' {bg_figs['bits']} K1/K4/K14/K15 and K5/K6/K12/K13 outputs bit-equal to "
        "the parent's build"
        if bg_figs["bits"] is not None else "the presets' bits NOT compared (no parent digests "
        f"for this card; PARENT_BITS_CARD {PARENT_BITS_CARD})"), flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
