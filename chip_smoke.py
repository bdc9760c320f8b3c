"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and fails without one; it never continues on the CPU. Phases,
one line each or more:

1. the card's name and power limit, as ``nvidia-smi`` gives them;
2. the build of every kernel source in ``csrc/`` (one nvcc each, started
   together, and probe builds of ``transformer_encode.cu`` and
   ``transformer_encode_train.cu`` with in-kernel clock counters), with its
   time, registers and spills; the registers, spills, shared memory and
   count of ``HMMA`` (tensor-core) instructions in the SASS (``cuobjdump
   -sass``) of the encoder kernels whose products run on the tensor cores,
   none of which may be 0: the bf16 tier, and the f32 tier and row 11's
   forward and reverse (three-pass TF32); the same for every instance of
   the lockstep peer backward (``align_peer_bwd_kernel``: both products on
   ``mma.sync``, three-pass TF32 in f32, bf16 in bf16), the bf16 tiers of
   the peer context, the encoder, the serve kernel and the cell
   (``lstm_mma.cuh``: ``mma.sync`` bf16), the f32 tiers of the peer context,
   the encoder, the serve kernel and the cell (``lstm_mma.cuh``, three-pass
   TF32; each block's shared memory, and the cell's block, as the library
   and the chooser count it), every
   instance of the training backward ``ss_bwd_kernel`` (32- and 16-row
   blocks, one or two unit blocks a warp) and forward ``train_fwd_kernel``
   in their three modes (the decoder's static and per-step context, row 5's
   teacher-forced mode), their blocks at the presets' shapes, at hidden 256
   and at 8 layers, and the lockstep peer forward, and both block shapes of both
   tiers of the transformer decode (``transformer_decode_mma.cuh``, bf16;
   ``transformer_decode_f32mma.cuh``, three-pass TF32; 64 and 32 rows);
3. each kernel against its plain PyTorch version at full width (hidden 128),
   at batches that are not a multiple of the kernels' row tiles:
   ``fused_serve`` without and with a static context (C = 128),
   ``fused_encode`` (its repeats and permuted batches bit-equal), the
   ``lstm_seq_states`` forward, backward-recurrence (its repeats and
   permuted batches bit-equal; also at the 10 s encoder's shape, B = 4096,
   T = 100, L = 2, f32 residuals, in both compute types) and
   dW-reduction kernels, and the ``ss_decode`` forward, backward-recurrence,
   dW and dproj kernels (30 + 30 steps; 1 and 2 layers, with and without a
   context, f32 and bf16 residuals, Bernoulli, all-teacher and all-model
   coins); the lockstep-peer tier of ``fused_serve`` (``peer_context`` and
   the serve kernel with a per-step context) and the six
   ``aligned_ss_decode`` kernels (100 + 100 steps, C = 128, K = 7 and 3
   peers with a row whose every peer is masked, and K = 1, 1 and 2 layers,
   both residual types, the three coin kinds); beside every dW reduction
   its pack kernel at every layer against the plain version and two runs
   of the reduction bit-equal; the static-context ``fused_serve``
   and the ``ss_decode`` kernels at video-fusion's C = 64; ``conv_resize`` at
   five shapes (the JAX suite's, a clip at the feature defaults, the fusion
   maps mode, upsampling, odd sizes) and at a row wider than 48 KB, with
   3 x 3 filters, then with K = 5, 7 and 1 (a ragged last column tile, a
   wide row, whole-frame tiles), each repeat bit-equal; ``fused_encode_tokens`` (B = 16384 at
   T = 30, a ragged B, T = 13 and 64) and ``fused_ar_decode`` (30 + 30 steps,
   L = 2: no peers, K = 4 per-row peers with a row of no valid peer, which
   must equal the peerless rollout, and a row of one; ``peer_pool`` "mean";
   ``peer_window`` 2; and the per-row tier at the TPU streamed tier's shape,
   100 + 100 steps, K = 4, window 0); the shared tier of ``fused_ar_decode``
   at both transformer presets' shapes, ``peer_pool`` "none" and "mean",
   window 0 and the preset's (2 at 30 frames), with and without δv, over
   G = 3 groups (1 row, 37, the rest) under an unsorted gid, one group all
   masked (equal to the peerless rollout), and without δv against the
   per-row kernel on gathered copies; the f32 ``fused_ar_decode`` in blocks
   of 64 rows too (B = 8451, a ragged last block; the checks above run
   blocks of 32), every tier, with δv, each repeat bit-equal; the three
   ``fused_encode_train``
   kernels (B = 4096 at T = 30, a ragged B, T = 13 and 64): forward and
   stash against plain, every gradient against autograd through
   ``_encode``, the reduction equal to the block-order sum, two runs
   bit-equal (and the f32 encoder kernels at T = 1 and L = 8 too, the
   serving kernel's repeat bit-equal); ``fused_lstm_cell`` (D_in = 3 and 128, B = 16384 and 16383;
   in f32, three-pass TF32, also hidden 40, 100, 272 and 1024 at ragged
   batches with x and h at odd offsets, W resident and streamed, each repeat
   bit-equal) against ``lstm_cell``; ``fused_decode`` (L = 1 and 2, C = 0 and 128, 30
   steps, B = 16383) against its plain version; the f32 serve kernel
   (C = 0, 128 and 12, the last padded to a k8 step), ``fused_decode`` and
   the lockstep tier (100 + 100 steps) in the choosers' 64-row blocks and
   in 32-row ones, at ragged batches, each repeat bit-equal and each row
   bit-equal in a permuted batch; the bf16 tiers of
   ``fused_encode_tokens`` and ``fused_ar_decode`` at both transformer
   presets' shapes (per row: no peers, K = 4 "none" and "mean", the
   windows; the shared tier with δv) against their bf16 plain versions
   (BF16_TOL) and the f32 plain versions (JAX's 0.08), the encoder also to
   the floor below and a bit-equal repeat; the bf16-compute
   tiers of the ``lstm_seq_states``, ``ss_decode`` and ``aligned_ss_decode``
   kernels (``train --train-compute bfloat16``) against their bf16 and their
   f32 plain versions (BF16C_*: about 10x the gap read to the bf16 one,
   JAX's contract for the tier to the f32 one, and each rounded output at
   least half as far from the f32 one as the bf16 plain version): B = 4099,
   1 and 2 layers, both residual types, ``ss_decode`` at C = 0, 128 and 64
   with the three coin kinds, the aligned kernels at K = 3 and 7 with a row
   whose every peer is masked; the bf16 tiers of the serving kernels
   (``compute_dtype=bfloat16``, the cell on bf16 tensors) the same way,
   ``fused_serve`` at 30 + 30 steps without and with a static context
   (C = 128 and 64), ``fused_encode`` on the crossuser peer rows, the
   lockstep tier at 100 + 100 steps (K = 7 and 3), the cell at D_in = 3 and
   128, and the serve kernel in blocks of 16 rows too (its tiles of 16
   rows, W resident at L = 1 and from L2 at L = 2, the lockstep tier at
   K = 7); then the time splits of the f32 encoder's probe builds (row 10 at
   B = 16384, row 11's forward and reverse at 4096), each beside the FMA
   design's (``ENC_F32_SPLIT_BEFORE``); the lockstep tier also at K = 9, 16,
   64 and 256 peers in f32 (B·K about 28,672; at K = 256 one viewer a block
   of 256 rows, c and the staging of h in device memory) and 16 in bf16;
4. the ``seq2seq-tf-30`` serving main path: ``serving.make_serve_fn`` behind
   a ``DynamicBatcher`` answers 64 concurrent single-viewer requests and one
   bulk request; every answer equals the direct batched call and the numpy
   oracle. Then serve-bench and ``fused_serve`` alone, kernel against plain,
   beside its time before its three-pass TF32 design (``BEFORE``), its
   bound (the gate products at 495 / 3 TFLOP/s, the feedback on the FMA
   units) and the FMA units' bound; phases 4b (``fused_decode``), 6 (the
   static-context ``fused_serve``), 8 (the lockstep serve kernel and
   ``peer_context``) and 10 (``fused_serve`` at C = 64) report theirs the
   same way;
   4b. the same preset on the paths of the cell and decode kernels:
   ``cell="pallas"`` served by ``make_serve_fn(impl="plain")`` behind the
   batcher at B = 16384 (60 ``fused_lstm_cell`` launches a call), and
   normalize → ``seq2seq.decode_fused`` → denormalize at B = 16384 and
   262,144 (30 cell launches and one ``fused_decode``); every answer against
   the ``cell="xla"`` plain path and the numpy oracle, ``decode_fused``
   against ``serve_fused``; both paths timed at 16384 and 262,144, and
   each kernel alone against plain; the f32 cell (three-pass TF32) at
   B = 16384 (D_in = 3 and 128) and 262,144 also against ``torch.lstm_cell``
   and beside its FMA design's time (``BEFORE``), with its bound on the
   tensor cores and on the FMA units and its device and host time a call;
5. the ``seq2seq-tf-30`` training main path: ``train.train_loop`` at
   B = 4096 through the ``lstm_seq_states`` kernels, with evaluation,
   checkpoints and a resume that equals the uninterrupted run, one step
   through the kernels against plain autograd, the step's speed, and the
   training kernels alone against plain and cuDNN/cuBLAS (the backward, on
   the tensor cores, beside its FMA design's time); then
   ``train_compute="bfloat16"`` (:func:`drive_bf16_training`): a short
   ``train_loop`` through the bf16-compute kernels (counted apart from the
   f32 ones), evaluation, a bit-equal resume, one step on the card against
   the CPU port's bf16 plain step with the same coins and against the f32
   step, the step against the f32 step in turns, and each bf16-compute
   kernel alone against its bf16 plain version, its f32 twin and, for the
   reductions, cuBLAS on bf16 operands; phases 7, 9 and 12 end the same way
   (the static context's peer encoder of 7 stays in f32, as in JAX);
6. the ``stacked-ss-crossuser`` serving main path: the batcher with K = 4
   peer futures per request (some with fewer, some with none) in front of
   ``fused_encode`` + the static-context ``fused_serve``; every answer
   equals the port's plain path on the CPU and, given the same peer
   context, the numpy oracle. Then serve-bench at B = 16384 and 65536, and
   both kernels alone against plain (``fused_encode`` at 262,144 and 65,536
   rows beside its FMA design's times, and at 65,536 against cuDNN);
7. the ``stacked-ss-crossuser`` training main path: ``train.train_loop`` at
   B = 4096 with K = 4 peers and ``teacher_prob`` annealing 1 → 0, through
   ``ss_decode`` (decoder) and ``lstm_seq_states`` (encoder and peers), with
   evaluation through the serving kernels, checkpoints, a resume that equals
   the uninterrupted run (coins included), one step through the kernels
   against plain autograd with the same coins, the step's speed, and the
   ``ss_decode`` kernels alone against plain and cuBLAS, the dproj
   reduction's (both compute types) beside its time before its 16-byte-load
   design (``BEFORE``) and, from ``torch.profiler``, the device
   time of the kernel and of cuBLAS beside the CUDA-event times, which hold
   the host's work;
8. the ``stacked-ss-crossuser-10s`` serving main path (K = 7 time-aligned
   peers, 100 frames in and out): the batcher in front of the lockstep tier,
   every answer against the port's plain path on the CPU and the numpy
   oracle given the same per-step context; the grouped gateway against
   per-row serving; serve-bench at B = 16384 and 65536; a profile of one
   call; the tier and each of its kernels alone against plain (and
   ``peer_context`` against cuDNN at the smaller batch, and at K = 16 over
   the same 28,672 peer rows);
9. the ``stacked-ss-crossuser-10s`` training main path: ``train.train_loop``
   at B = 4096 through ``aligned_ss_decode`` (peers and decoder) and
   ``lstm_seq_states`` (encoder), as in 7, and the aligned kernels alone
   against plain and cuDNN/cuBLAS, the profiled step's device busy time and
   the peer backward's share of it, the peer backward (both compute types)
   beside its time before its tensor-core design (``BEFORE``), its bound
   (f32: its products at a third of the dense TF32 peak, the gates' h part,
   exact in TF32 on bf16 residuals, at half of it) beside the FMA units'
   bound of the same work; row 5's forward and backward alone at the
   encoder's shape (T = 100, L = 2, f32 residuals) in both compute types
   against plain and cuDNN's forward and backward data, beside their FMA
   designs' times (``BEFORE``); the forwards of phases 5, 7 and 9 alone
   likewise (``report_redesign``); 9b. one train step of both crossuser
   presets at hidden 256 (two layers) and at 8 layers of hidden 128, every
   forward and backward on the kernels (counted), in both compute types and
   residual types, against plain autograd (f32 compute on f32 residuals)
   or the CPU port's step (the rounded tiers), within ``STEP_REL_TOL``
   (``ALIGN_STEP_REL_TOL`` for the lockstep decoder); then
   one line per dW reduction (f32 and
   bf16 compute, phases 5, 7 and 9) with its time beside its time before
   the pack-and-tensor-core design (``BEFORE``), its bound's share of it,
   cuBLAS's time and the registers and shared memory of its kernels; phase
   5 also times the pack kernel alone;
10. the feature path: two synthetic uint8 clips (1200 frames of 480 x 960,
   a panning textured scene from the seed) through ``cli extract-features
   --device cuda`` (two ``conv_resize`` launches a clip), checked against
   the port's CPU path on a clip's first frames, then ``prepare-data
   --features``; a blocky clip's features and saliency, card against CPU,
   reported and not gated (ill-conditioned there); frames/s of
   ``extract_clip_features`` with and without the host→card copy, and at
   960 x 1920 on 240 frames made on the card; ``conv_resize`` alone against
   plain and ``F.interpolate`` + ``F.conv2d``, its device time
   (``torch.profiler``) beside its design's before (``BEFORE``), the bound
   and the sector floor (the 32-byte sectors of the source pixels its taps
   read, the output once; and in 64-byte pieces);
11. the ``video-fusion`` serving main path: the batcher with ``features`` in
   every request (a request without them raises) in front of the
   static-context ``fused_serve`` at C = 64, every answer against the port's
   plain path on the CPU and the numpy oracle given the same context; the
   maps mode (64 x 128 maps through ``conv_resize``) against the CPU plain
   path; serve-bench at B = 16384 and 65536; a profile of one call;
12. the ``video-fusion`` training main path: ``train.train_loop`` at
   B = 4096 on the windows of 10 through ``lstm_seq_states`` and
   ``ss_decode`` at C = 64, as in 7; the step's speed and profile; one
   maps-mode step, whose conv leaves must get a gradient;
13. the ``transformer-30`` serving main path: the batcher with
   ``other_future`` in every request (K = 4 peers, two, or K all masked)
   and one bulk request, in front of ``fused_encode_tokens`` and
   ``fused_ar_decode`` in their bf16 tiers (``serve_fused``'s default on
   the card), every answer against the port's plain path on the CPU in the
   same tier (BF16_ANSWER_TOL); the same with an explicit f32
   ``compute_dtype`` against the f32 plain path (ORACLE_TOL); serve-bench
   at B = 16384 and 65536; a profile of one B = 16384 call; both kernels
   alone in both tiers against plain (the encoder also against
   ``nn.TransformerEncoder`` with the same weights, in the tier's type) at
   B = 16384, and the f32 encoder at 65,536 too; the bf16 encoder's time
   beside its time before the tensor-core design (``BEFORE``), its
   bound's share, its readings and the time split of its probe build; the
   f32 encoder's beside its FMA design's (``BEFORE``) and its bound
   beside the FMA units' bound of the same work; both decode tiers (row 9
   on three-pass TF32, row 9c on bf16 ``mma.sync``) beside their FMA
   designs' times, their bounds (f32: the products at a third of the dense
   TF32 peak) and the K/V re-read floor (every step reads its rows' self,
   cross and peer K/V again, in the tier's type), and alone at B = 65,536;
14. the ``transformer-30`` training main path: ``train.train_loop`` at
   B = 4096 with K = 4 peers, noisy teacher forcing annealing 1 → 0.3, the
   encoder on the three ``fused_encode_train`` kernels (``train_impl``
   "auto"), evaluation through both serving kernels, checkpoints and a
   bit-equal resume; one step's gradients on the card against the CPU
   port's and against plain autograd on the card, with the same noise; the
   step's speed under "xla" and "auto" in turns, a profile of each; the
   three kernels alone against plain and ``nn.TransformerEncoder`` under
   autograd, the forward and the reverse beside their FMA design's times;
15. the ``transformer-10s`` serving main path (100 + 100 frames, K = 4,
   window 8): the batcher with per-row peers (K, two, all masked) in front
   of the plain encoder and the per-row decode kernel (bf16 by default,
   against the CPU plain path in bf16; and in f32 against the f32 one);
   serve-bench at B = 4096 and 16384, fused and plain; the grouped gateway
   (``make_grouped_serve_fn`` → the shared tier with δv, through
   ``grouped_predict``) against per-row serving at the daemon's shape, 256
   rows over 8 videos of unequal counts with a masked peer, in bf16
   (GROUPED_BF16_TOL) and in f32 (ANGLE_TOL), and at B = 4096 and 16384
   (G = 8); grouped against per-row calls timed at both batches, profiles
   of both at 4096; the f32 shared tier alone against plain at B = 4096
   beside its FMA design's time, and the per-row kernel alone at the TPU
   streamed tier's shape (window 0), in f32 at the preset's window 8
   against its plain version, and, in bf16, at window 8 beside its f32
   twin and both tiers' FMA designs' times (B = 4096), and at B = 16384;
   ``transformer-30`` grouped at B = 16384;
16. the ``transformer-10s`` training main path: ``train.train_loop`` at
   B = 1024 (plain encoder at T = 100, as in JAX), evaluation through the
   per-row decode kernel, checkpoints, a bit-equal resume; the step's speed
   and profile; the plain encoder against ``nn.TransformerEncoder`` at
   T = 100;
17. the bf16 tiers end to end: ``serve_fused(compute_dtype=bfloat16)``
   behind ``predict_xyz`` for ``seq2seq-tf-30`` (B = 16384 and 262,144),
   ``stacked-ss-crossuser`` (``fused_encode`` and the static tier; 16384
   and 65,536) and ``stacked-ss-crossuser-10s`` (the lockstep tier; 16384
   and 65,536), each against the f32 call on the same weights in turns
   (traj/s, and the deviation in great-circle degrees), a profile of the
   10 s preset's bf16 call at 65,536; ``cell="pallas"``
   on a bf16 ``seq2seq-tf-30`` at 16384 (60 cell launches a call, against
   ``cell="xla"`` and f32); then ``train --bf16`` (``model_param_dtype=
   "bfloat16"``) on ``seq2seq-tf-30``, ``stacked-ss-crossuser``,
   ``stacked-ss-crossuser-10s``, ``video-fusion`` and ``transformer-30``
   at B = 4096 (:func:`drive_bf16_params`: the LSTM cells on the f32
   kernels with f32 gradients and moments, the transformer on plain bf16
   autograd); then each bf16 serving tier alone against its f32 twin, its
   plain version and cuDNN's or cuBLAS's bf16 call; the serve kernel (row
   1b: no context, static context, the lockstep serve kernel), the peer
   context (at B = 4096 and 65,536) and the encoder beside their FMA
   design's times
   (``BEFORE``), their bounds' share and their bounds on the FMA units;
   the bf16 cell (row 2b, on the tensor cores) beside its FMA design's time,
   with its device time and ``torch.lstm_cell``'s (``torch.profiler``) and
   the host's time a call;
18. predict, export and the daemon, through the CLI and ``serve_daemon``
   on the card, weights from ``cli.bench_params_np``: ``export`` of a port
   checkpoint of ``seq2seq-tf-30`` and of ``stacked-ss-crossuser-10s``,
   loaded back onto the card bit-equal; ``predict --tiles --at-frame 400``
   on the 10 s preset (K = 7, and ``--peers 16``) and ``predict
   --peer-group --at-frame 200 --tiles`` on ``transformer-30``, each on the
   card against the same command on the CPU (pitch and the great-circle
   angle within ANGLE_TOL plus the JSONL's rounding of 1e-3 degrees, tiles
   equal on TILES_EQUAL of rows); the ``seq2seq-tf-30`` daemon (max batch
   256, warmup, ``impl="auto"``): one viewer's single-pose push flow on
   each wire, its p50 and p99 and the p50's terms (the codec on both
   sides, the batcher's queue, the device at B = 1 host to card to host,
   the relay as the ``drop`` op's round trip, and what they leave), 64
   clients of 20 ``predict`` each coalescing (``mean_batch`` > 1, every
   answer equal to the serve program's row), a bulk ``predict_batch`` of
   16384 windows on the binary wire beside ``serve-bench``'s traj/s, and a
   ``reload`` of other weights while the 64 clients run (no request fails,
   the version rises, the answers after it are the new weights'); the
   ``stacked-ss-crossuser-10s`` and ``transformer-30`` daemons: 8 viewers
   of one video pushing with ``video``/``frame``, staggered so that the
   later ones get peers from the pool, each answer equal to the serve
   program's with the pool's peer futures, and on ``transformer-30`` a
   grouped ``predict_batch`` against the per-row path (GROUPED_BF16_TOL,
   the card's bf16 tier) with the ``grouped`` block in ``stats``. Any error
   reply to a client of the daemon fails the run;
19. trace ingest and the simulations: 864 head-pose logs written in the
   Tsinghua / MMSys'17 layout (48 users x 18 videos, 60 s at about 30 Hz,
   jittered timestamps, 1.56 M rows; ``write_logs``); ``inspect-traces
   --validate --dataset-format tsinghua`` exits 0 on them and 2 on a copy
   with one file's quaternions scaled by 1.1 (the sniffed run on the copy
   reported); ``prepare-data --traces`` through the C library
   (``csrc/fastio.c``) bit-equal to the plain numpy versions, with files/s,
   rows/s and the parse alone C against numpy (host numbers, beside the
   host's CPU and cores); ``stream-sim`` over one video's 48 viewers (600
   frames at 10 Hz) on the checkpoints of the states phases 5, 7, 9 and 14
   trained (``seq2seq-tf-30``, ``stacked-ss-crossuser --peers 4``, the 10 s
   preset ``--peers 7``, ``transformer-30``), on the card against the CPU
   per deadline (the f32 presets within one hit, 1 / (viewers x ticks),
   plus the rounding; the transformer's bf16 tier within TF_SIM_TOL of the
   CPU's f32), with predictions/s and ms a tick, and the transformer's
   served answers at B = 48 on every TF_SIM_SAMPLE-th tick's windows and
   peers against the port's bf16 plain versions on the CPU
   (BF16_ANSWER_TOL); ``serve`` (``seq2seq-tf-30`` on
   the video's ingested test split, the 10 s preset on its synthetic store)
   and ``predict --traces --at-frame 400`` (K = 7 peers on the 10 s preset),
   card against CPU; what ``eval --plot`` draws (``cli.eval_plot_series``:
   the error curves of the model and of persistence, one window's
   prediction) computed on the card against the CPU, and ``eval --plot``
   and ``train --tb-dir`` on the card, their files where matplotlib and
   tensorboard are installed, else the message that names the package;
20. data parallelism (slice P-1): (a) ``parallel.train_loop_dp`` in a world
   of one over NCCL for 3 steps at each preset's own batch (128) through the
   fused routes on ``seq2seq-tf-30``, ``stacked-ss-crossuser`` (scheduled
   sampling) and ``transformer-30``, its params bit-equal to ``train_loop``'s;
   (b) two ranks on the one card over gloo (``parallel.launch.run_world``,
   CUDA tensors through gloo's ``all_reduce`` and ``broadcast``), the same
   presets and steps, the ranks' params bit-equal to each other and within
   DP_TOL of the single-card run on the global batch; (c) ``python -m
   torch.distributed.run --nproc-per-node 1 -m longterm360fov_tpu_torch train
   --data-parallel`` bit-equal to ``train`` without the flag; (d)
   ``make_sharded_predict_fn`` over ``[cuda:0] x 4`` on ``seq2seq-tf-30`` at
   B = 262,144, ``stacked-ss-crossuser`` and ``stacked-ss-crossuser-10s``
   (K = 7) at 65,536 and ``transformer-30`` at 16,384, each bit-equal to the
   unsharded call, both timed in turns; (e) ``serve_daemon`` on the mesh
   ``[cuda:0] x 4`` (divisor 4, the ladder 4 ... 256 warmed) answering a
   viewer's pushes and a bulk ``predict_batch`` as the daemon without a mesh,
   and ``serve-daemon --data-parallel`` (divisor 1 on the one card) started
   as a process and answering as it. The phase prints its own time;
21. sequence, pipeline and tensor parallelism (slices P-2, P-3) on grids of
   the one card: (a) ``transformer-30`` at B = 4096 through ``train_loop``
   on ``sp_apply_fn`` (ring and gather) and ``pp_apply_fn`` (M = 2 and 4)
   over ``[cuda:0] x 2``, 3 steps each within JAX's trajectory bounds of the
   plain ("xla") loop from the same state, its evaluation's launches of rows
   10b and 9c counted; the steps in turns with the plain step, and profiles
   of the plain, ring and M = 4 steps; (b)
   ``transformer-10s`` at B = 1024 on four sequence shards (the encoder
   sharded): one forward and its gradient, ring and gather, against plain
   ``apply`` and autograd with the same draw, timed in turns; (c)
   ``seq2seq-tf-30`` at B = 4096 on a (2 data, 2 model) grid of
   ``[cuda:0] x 4``: the decode, a gradient and 3 steps against plain, the
   step in turns; (d) ``train --seq-parallel 2`` refused on one card with
   JAX's device-count message and on ``seq2seq-tf-30`` with its family
   message. The phase prints its own time.

Each main path runs with every launch counter set to 0 just before it and
read just after; a kernel of the path that never launched fails the run.
Then one JSON line on the kernels (launches on their main path and on
every path driven, ``launches_on_paths``, max error
over every check, kernel, plain and library times by CUDA events, and the
bound: the larger of the work's FLOP over the peak of its type, the f32
FMA peak or, for the bf16 tiers' products, the dense bf16 tensor-core
peak, or, for the f32 encoder's and the f32 peer backward's products
(three-pass TF32), a third of the dense TF32 peak beside the encoder's
attention on the FMA units (the peer backward's gates' h part, exact in
TF32 on bf16 residuals, at half of it: two passes), and its bytes, in
the types the tier stores and reads, over the memory rate),
and last the contract line
``{"ok": true, "device": {...}}``. Any failure raises.
"""

import contextlib
import ctypes
import dataclasses
import datetime
import functools
import io
import json
import math
import multiprocessing
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

from longterm360fov_tpu_torch import (checkpoint, cli, data, datasets, evaluate, geometry, infer, native, oracle,
                                      parallel,
                                      serving, traces, train, windows)
from longterm360fov_tpu_torch.config import get_preset
from longterm360fov_tpu_torch.features import equirect
from longterm360fov_tpu_torch.models import cross_user, fusion, get_family, seq2seq, transformer
from longterm360fov_tpu_torch.models.cell import LSTMParams, lstm_cell
from longterm360fov_tpu_torch.ops import (_build, conv_resize, fused_lstm, lstm_align, lstm_ss, lstm_train,
                                          transformer_decode, transformer_encode)
from longterm360fov_tpu_torch.ops import transformer_encode_train as encode_train
from longterm360fov_tpu_torch.params import params_from_numpy, tensor_to_array, tree_leaves, tree_unflatten, walk
from longterm360fov_tpu_torch.parallel import launch, pp, sp, tp

PRESET = "seq2seq-tf-30"
CU_PRESET = "stacked-ss-crossuser"
CU10_PRESET = "stacked-ss-crossuser-10s"
FU_PRESET = "video-fusion"
TF_PRESET = "transformer-30"
TF10_PRESET = "transformer-10s"
# serve kernel vs plain, normalized outputs after 60 to 200 steps; the f32
# tier's products are three-pass TF32 (21 bits an operand, a_lo·b_lo dropped,
# chunked f32 sums) in another order than the plain version's exact f32
KERNEL_TOL = 1e-4
ORACLE_TOL = 1e-4  # batcher answers vs the numpy oracle or the CPU plain path, unit xyz
# encode kernel vs plain, f32 over 30 steps of a bounded state (|h| < 1):
# exact f32 FMAs in another order; the peer context over 100 steps, its
# products in three-pass TF32 (about 2^-21 of each product, summed in
# chunks of 32 k-rows), its context summed in the plain version's order
ENC_TOL = 1e-5
# training kernels vs plain: the forward within 1e-5 absolute with f32
# residuals (three-pass TF32 products, their operands split to nearest, in
# chunks of 16 k-rows, in another order than the plain version's f32;
# ss_decode's ys too, since its feedback is f32 on both sides; at a static
# context of unit variance about 4e-6, under the plain f32 version's own gap
# to a float64 loop, PERF.md §6 row 6); with bf16 residuals the same f32
# values round to bf16, and a 1e-7 difference may cross a rounding boundary, so
# within one bf16 step (at most 2^-7 of the value). The backward, fed the
# same residuals, within 1e-4 of max|plain| per output: the reductions sum
# B·T = 122,970 terms in another order.
FWD_TOL = 1e-5
BWD_REL_TOL = 1e-4
# one train step through the kernels against plain autograd, gradients per
# leaf relative to max|plain|: f32 residuals 1e-4; bf16 residuals, the main
# path's default, 2e-2 (the JAX suite's bound for ss_decode) and 3e-2 for
# the lockstep decoder (tests/test_lstm_align.py's bound for its bf16 tier)
STEP_REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
ALIGN_STEP_REL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
TRAIN_B = 4096  # the batch scripts/bench_train.py trains both presets at
# the bounds above, by kind of output: a forward ("fwd", absolute), a
# backward recurrence ("rec") and a reduction fed the plain dgates ("sum";
# "ctx_sum" for the lockstep decoder's, whose loader rebuilds the context),
# both relative to max|plain| per output
F32_LIMIT = {"fwd": FWD_TOL, "rec": BWD_REL_TOL, "sum": BWD_REL_TOL, "ctx_sum": BWD_REL_TOL}
# the bf16-compute tiers (train --train-compute bfloat16): against the f32
# plain version, JAX's contract for the tier against its f32 tier
# (tests/test_lstm_train.py:204-229: the forward within 0.05 absolute, the
# gradients within 6 % of max|g| per output; one train step's loss within
# 1e-2 relative, :232-262). The whole bf16-vs-f32 gap fits under that, so the
# kernel is also held to its bf16 plain version, near this script's and the
# card tests' readings (PERF.md): the forward 1e-2 (read 8.9e-4 with
# f32 residuals; plus one bf16 step on a value stored in bf16), the backward
# recurrences 1e-2 of max|g| (read 2.4e-3), the reductions fed the same
# dgates 1e-4 of max|g| (read 9.0e-6), the lockstep decoder's 2e-3 (read
# 2.5e-4: its loader rebuilds ctx_t = Σ_k w_k·h_k with FMAs, the plain
# version with a rounding per product, so an f32 ulp may round ctx_t the
# other way), one step on the card against the CPU port's loss 5e-5 relative
# (read 3.6e-6) and gradients 1e-2 of max|g| (read 6.8e-4). Both round the
# same operands and sum in f32 in another order, so a rounding may flip and
# carry through a row's later steps: that is the gap the readings show. And
# the kernel rounds: each output the tier rounds stands from the f32 plain
# version at least BF16C_FLOOR of the bf16 plain version's gap, in the mean
# (the largest gap of a value stored in bf16 is one bf16 step whether or
# not its compute rounded; read 0.998-1.000); the step likewise, on the
# largest gaps
BF16C_CONTRACT = {"fwd": 0.05, "rec": 0.06, "sum": 0.06, "ctx_sum": 0.06, "loss": 1e-2, "step": 0.06}
BF16C_TIGHT = {"fwd": 1e-2, "rec": 1e-2, "sum": 1e-4, "ctx_sum": 2e-3, "loss": 5e-5, "step": 1e-2}
BF16C_FLOOR = 0.5
F32_FLOPS = 67e12  # H100 SXM f32 FMA peak outside the tensor cores (data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (data sheet)
# f32-accurate products as three-pass TF32 on the tensor cores: the dense
# TF32 peak (495 TFLOP/s, data sheet) over three passes
TF32X3_FLOPS = 495e12 / 3
HBM_BYTES = 3.35e12  # H100 SXM memory rate (data sheet)
# each redesigned kernel's time before its redesign (PERF.md §6's earlier
# readings, CUDA events on an NVIDIA H100 80GB HBM3 at 700.00 W), printed
# beside this run's (report_redesign): the dW reductions before the
# pack-and-tensor-core design; row 10b before its tensor-core design (B =
# 16384, T = 30, L = 2); rows 10 and 11 on the FMA units (B = 16384 and
# 65,536, and 4096 for row 11); the peer backward (rows 7 / 7b) and dproj
# (rows 6 / 6b) before their tensor-core and 16-byte-load designs; the bf16
# peer context (row 1b, B = 4096 and 65,536) and encoder (row 4b) on the FMA
# units; the bf16 cell (row 2b, B = 16384, D_in = 3 and 128) and the bf16
# transformer decode (row 9c: transformer-30 at B = 16384, transformer-10s
# per row at 4096) on the FMA units; the f32 transformer decode (row 9:
# transformer-30 at B = 16384 and 65,536, transformer-10s per row at 4096 at
# its window 8 and at window 0, the shared tier at 4096) and the bf16 serve
# kernel (row 1b: no context at B = 262,144, static context and the
# lockstep serve kernel at 65,536) on the FMA units; the f32 serve kernel
# (row 1: the same shapes and static C = 64 at 65,536), the decoder from
# given states (row 3, B = 262,144) and the f32 peer context (B = 4096 and
# 65,536) on the FMA units; the scheduled-sampling decoder's backward (row 6
# at B = 4096, T = 30; row 7 at the 10 s shape) and the lockstep peer forward
# (row 7) on the FMA units, both compute tiers; the f32 encoder (row 4: 65,536
# and 262,144 rows) and row 5's backward (both compute tiers, seq2seq-tf-30's
# shape and the 10 s encoder's, the latter from PERF.md §5's step profile) on
# the FMA units; the f32 cell (row 2, B = 16384, D_in = 3 and 128, and
# 262,144) on the FMA units, timed in turns with the tensor-core design
# (scripts/torch_cell_bf16_probe.py --f32 --checkout); conv_resize (row 8)
# before its tiled design, the mean device time a launch (launch_device_ms,
# scripts/torch_conv_probe.py --time-only --checkout, in turns) at 64 frames
# of 960 x 1920 and at a 1200-frame clip
BEFORE = {"lstm_seq_states_dw": 0.888, "lstm_seq_states_dw_bf16": 0.916, "ss_decode_dw": 3.920,
          "ss_decode_dw_bf16": 3.777, "aligned_dec_dw": 20.739, "aligned_dec_dw_bf16": 20.681,
          "aligned_peer_dw": 20.808, "aligned_peer_dw_bf16": 21.833, "fused_encode_tokens_bf16": 19.151,
          "fused_encode_tokens": 23.980, "fused_encode_tokens B=65536": 94.329, "encode_train_fwd": 6.458,
          "encode_train_bwd": 15.915, "aligned_peer_bwd": 53.983, "aligned_peer_bwd_bf16": 47.555,
          "ss_decode_dproj": 0.073, "ss_decode_dproj_bf16": 0.049, "peer_context_bf16": 19.443,
          "peer_context_bf16 B=65536": 303.645, "fused_encode_bf16": 11.112, "fused_lstm_cell_bf16": 0.137,
          "fused_lstm_cell_bf16 D_in=128": 0.219, "fused_ar_decode_bf16": 74.404,
          "fused_ar_decode_bf16 transformer-10s": 172.655, "fused_ar_decode": 88.653,
          "fused_ar_decode B=65536": 339.969, "fused_ar_decode transformer-10s": 137.884,
          "fused_ar_decode transformer-10s window 0": 279.593,
          "fused_ar_decode_shared": 129.154, "fused_serve_bf16": 92.864, "fused_serve_ctx_bf16": 72.126,
          "fused_serve_peers_bf16": 245.214, "fused_serve": 72.896, "fused_serve_ctx": 53.519,
          "fused_serve_ctx C=64": 50.467, "fused_serve_peers": 192.240, "fused_decode": 35.809, "peer_context": 14.098,
          "peer_context B=65536": 219.967, "ss_decode_bwd": 5.706, "ss_decode_bwd_bf16": 5.499,
          "aligned_dec_bwd": 19.415, "aligned_dec_bwd_bf16": 19.800, "aligned_peer_fwd": 19.271,
          "aligned_peer_fwd_bf16": 19.159, "fused_encode": 8.650, "fused_encode 262144 rows": 34.230,
          "lstm_seq_states_bwd": 1.327, "lstm_seq_states_bwd_bf16": 1.368, "lstm_seq_states_bwd 10s": 13.9,
          "lstm_seq_states_bwd_bf16 10s": 14.2, "lstm_seq_states_fwd": 0.774, "lstm_seq_states_fwd_bf16": 0.827,
          "lstm_seq_states_fwd 10s": 9.5, "lstm_seq_states_fwd_bf16 10s": 7.5, "ss_decode_fwd": 3.636,
          "ss_decode_fwd_bf16": 3.470, "aligned_dec_fwd": 8.648, "aligned_dec_fwd_bf16": 10.696,
          "fused_lstm_cell": 0.1187, "fused_lstm_cell D_in=128": 0.2032, "fused_lstm_cell B=262144": 1.934,
          "conv_resize device": 0.0159, "conv_resize device clip": 0.1643}
DW_NAMES = [n for n in BEFORE if n.rsplit("_bf16", 1)[0].endswith("_dw")]
# the cell kernel against lstm_cell: one step, exact f32 FMAs in another order
# (tests/test_fused_lstm.py's bound for the TPU cell)
CELL_TOL = 1e-5
# the serving kernels' kinds of output, absolute like "fwd": the serve
# kernels' normalized predictions ("serve"), the encoder's top-layer h
# ("encode"), the peer context ("ctx"), the cell's h and c ("cell"). In f32
# against the plain version within KERNEL_TOL, ENC_TOL and CELL_TOL. Their
# bf16 tiers (rows 1b, 4b, 2b; compute_dtype=bfloat16, a --bf16 model's
# cell): against the f32 plain version within JAX's bound for the tier (0.05
# on the normalized outputs, tests/test_fused_lstm.py:112-126), at least
# BF16C_FLOOR of the bf16 plain version's mean gap from the f32 one (read
# 0.9999-1.0001), and against the bf16 plain version near this script's
# readings on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md PR 10). Both round
# the same operands and sum in f32 in another order, so a rounding may flip
# and carry through a row's later steps: the predictions read up to 7.3e-4
# in phase 3 and 1.9e-3 at B = 65,536 (mean about 1e-6), against 4.7e-4 to
# 6.5e-3 between the bf16 and f32 plain versions: 1e-2; the peer context
# 5.2e-5 and 1.2e-4: 1e-3; the encoder's h, which is the rounded h, one bf16
# step of it, 9.8e-4: 1e-2; the cell's h and c, one step with no carry,
# stored in bf16 (within adds a bf16 step): CELL_TOL
ABSOLUTE = ("fwd", "serve", "encode", "ctx", "cell")
F32_LIMIT.update(serve=KERNEL_TOL, encode=ENC_TOL, ctx=ENC_TOL, cell=CELL_TOL)
BF16C_CONTRACT.update(serve=0.05, encode=0.05, ctx=0.05, cell=0.05)
BF16C_TIGHT.update(serve=1e-2, encode=1e-2, ctx=1e-3, cell=CELL_TOL)
# the transformer's bf16 tiers against their bf16 plain versions: both round
# the same operands to bf16 and sum in f32 in another order, so a rounding may
# flip, which moves an activation by 2^-8 of itself; past the first flip a
# row's later roundings fall apart, so at thousands of rows the largest gap is
# of the size of the tier's own rounding error (this script measured up to
# 2.03e-2, the decode at B = 16384, against 2.0e-2 to 2.7e-2 between the bf16
# and f32 plain versions, on an NVIDIA H100 80GB HBM3 at 700 W): 5e-2; and
# JAX's own bound for the tier against the f32 reference
# (tests/test_transformer_decode.py:70)
BF16_TOL, BF16_F32_TOL = 5e-2, 0.08
# the bf16 encoder (row 10b, on the tensor cores) as the other
# bf16 tiers are held (check_outputs): within BF16_TOL of its bf16 plain
# version, BF16_F32_TOL of the f32 one, and the floor; its enc_mem is f32
ABSOLUTE += ("tf_encode",)
BF16C_TIGHT["tf_encode"], BF16C_CONTRACT["tf_encode"] = BF16_TOL, BF16_F32_TOL
# the time splits of the f32 encoder's probe builds before the three-pass
# TF32 design (rows 10 and 11 on the FMA units, PERF.md §5,
# scripts/torch_encode_f32_probe.py on an NVIDIA H100 80GB HBM3 at
# 700.00 W), printed beside this run's
ENC_F32_SPLIT_BEFORE = {
    "fused_encode_tokens": {"mma": 0.627, "attention": 0.162, "barriers": 0.052, "chunk waits": 0.051,
                            "in_proj": 0.033, "layer norms": 0.023, "b1 + GELU": 0.022, "epilogues": 0.017},
    "encode_train_fwd": {"mma": 0.608, "attention": 0.159, "chunk waits": 0.062, "barriers": 0.047, "in_proj": 0.035,
                         "layer norms": 0.025, "b1 + GELU": 0.025, "epilogues": 0.016, "stash": 0.013},
    "encode_train_bwd": {"mma": 0.339, "attention": 0.224, "dW products": 0.220, "chunk waits": 0.040, "stash": 0.040,
                         "barriers": 0.037, "partial writes": 0.032, "b1 + GELU": 0.030, "layer norms": 0.025}}
# served bf16 answers (unit xyz) against the CPU plain path in the same tier
# (measured 1.30e-2 over 248 rows in the same run)
BF16_ANSWER_TOL = 5e-2
# grouped against per-row serving in bf16 (great-circle and pitch, radians):
# grouped rows round the raw group K/V and subtract δv in f32, per-row rows
# round the anchored K/V, so the two differ by the tier's rounding error;
# JAX's bound for the tier, read as an angle
GROUPED_BF16_TOL = 0.08

SERVE_SRC = "longterm360fov_tpu_torch/csrc/fused_serve.cu"
LSTM_SRC = "longterm360fov_tpu_torch/csrc/lstm_train.cu"
SS_SRC = "longterm360fov_tpu_torch/csrc/lstm_ss.cu"
ALIGN_SRC = "longterm360fov_tpu_torch/csrc/lstm_align.cu"
COMMON_SRC = "longterm360fov_tpu_torch/csrc/lstm_common.cuh"
CONV_SRC = "longterm360fov_tpu_torch/csrc/conv_resize.cu"
TENC_SRC = "longterm360fov_tpu_torch/csrc/transformer_encode.cu"
TDEC_SRC = "longterm360fov_tpu_torch/csrc/transformer_decode.cu"
TTRAIN_SRC = "longterm360fov_tpu_torch/csrc/transformer_encode_train.cu"
S2S_SERVE, S2S_TRAIN = "serve seq2seq-tf-30", "train seq2seq-tf-30"
S2S_CELL, S2S_DECODE = "serve seq2seq-tf-30 cell=pallas", "serve seq2seq-tf-30 decode_fused"
CU_SERVE, CU_TRAIN = "serve stacked-ss-crossuser", "train stacked-ss-crossuser"
CU10_SERVE, CU10_TRAIN = "serve stacked-ss-crossuser-10s", "train stacked-ss-crossuser-10s"
FE_PATH, FU_SERVE, FU_TRAIN = "features video-fusion", "serve video-fusion", "train video-fusion"
TF_SERVE, TF_SERVE_F32, TF_TRAIN = "serve transformer-30", "serve transformer-30 f32", "train transformer-30"
TF10_SERVE, TF10_SERVE_F32 = "serve transformer-10s", "serve transformer-10s f32"
TF10_GROUPED, TF10_GROUPED_F32 = "serve transformer-10s grouped", "serve transformer-10s grouped f32"
TF10_TRAIN = "train transformer-10s"
S2S_TRAIN_BF16, CU_TRAIN_BF16 = "train seq2seq-tf-30 bf16", "train stacked-ss-crossuser bf16"
CU10_TRAIN_BF16, FU_TRAIN_BF16 = "train stacked-ss-crossuser-10s bf16", "train video-fusion bf16"
# the bf16 serving tiers' paths (compute_dtype=bfloat16; the cell on a --bf16 model)
S2S_SERVE_BF16, S2S_CELL_BF16 = "serve seq2seq-tf-30 bf16", "serve seq2seq-tf-30 cell=pallas bf16"
CU_SERVE_BF16, CU10_SERVE_BF16 = "serve stacked-ss-crossuser bf16", "serve stacked-ss-crossuser-10s bf16"
# the transformer kernels vs plain: 3e-5 absolute on the encoder memory and
# the normalized outputs, the JAX suite's bound for both TPU kernels
# (tests/test_transformer_encode.py:35, tests/test_transformer_decode.py:43)
TF_TOL = 3e-5
# fused_encode_train's gradients vs autograd through _encode: 2e-4 · max(|g|, 1)
# per leaf (tests/test_transformer_encode.py:130)
GRAD_TOL = 2e-4
# grouped answers vs per-row serving, the JAX suite's bound on angles and
# tiles (tests/test_serving.py test_grouped_predict_matches_per_row_serve_path):
# the δv factorisation is exact in real arithmetic, about 1e-5 in f32. Held on
# pitch and on the great-circle angle between the two predicted directions:
# yaw alone is ill-conditioned near the poles (a row at pitch -89.2° moved
# 2.6e-5 in yaw for 1.3e-5 of direction on the CPU; on the card, 1.1e-4 in yaw
# at B = 4096), and is reported, not held
ANGLE_TOL, TILES_EQUAL = 1e-4, 0.99


def direction_gaps(out_a, out_b, h_out):
    """Two packed serve outputs (yaw, pitch: H_out each, then the tiles) →
    (max |Δyaw|, max |Δpitch|, max great-circle angle between the predicted
    directions, share of equal tiles)."""
    a, b = (np.asarray(x, np.float64) for x in (out_a, out_b))

    def xyz(o):
        yaw, pitch = o[:, :h_out], o[:, h_out:2 * h_out]
        return np.stack([np.cos(pitch) * np.cos(yaw), np.cos(pitch) * np.sin(yaw), np.sin(pitch)], -1)

    chord = np.linalg.norm(xyz(a) - xyz(b), axis=-1)
    return (float(np.abs(a[:, :h_out] - b[:, :h_out]).max()),
            float(np.abs(a[:, h_out:2 * h_out] - b[:, h_out:2 * h_out]).max()),
            float((2 * np.arcsin(np.minimum(chord / 2, 1.0))).max()),
            float((a[:, 2 * h_out:] == b[:, 2 * h_out:]).mean()))
# conv_resize vs plain: 1e-5 of max|plain|. The kernel sums the resize's two
# non-zero taps a row where the einsum sums every term (its zeros exactly),
# and the K·K conv taps in another order than cuDNN: a few ulps.
CONV_REL_TOL = 1e-5
# features of the card's pipeline against the port's CPU path on the same
# frames: cuFFT and pocketfft sum in different orders and the log-amplitude
# amplifies the difference (1e-5 on saliency maps at 48 x 96, the CPU tests'
# bound against JAX); 1e-4 of max|CPU| on the pooled features
FEAT_REL_TOL = 1e-4
CLIP_T, CLIP_H, CLIP_W = 1200, 480, 960  # the synthetic clips: as long as the traces
ALIGN_FWD, ALIGN_BWD = "longterm360fov_tpu/ops/lstm_align.py:244", "longterm360fov_tpu/ops/lstm_align.py:570"


class Bf16Count:
    """The bf16 instance of a wrapper's kernel (a bf16-compute tier, or the
    cell on bf16 tensors), counted as :func:`drive` counts a wrapper: its
    ``launches`` are the wrapper's ``launches_bf16``."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self):
        return self.fn.launches_bf16

    @launches.setter
    def launches(self, n):
        self.fn.launches_bf16 = n


# one entry per kernel: "path" is the main path whose run gives its launches
KERNELS = [
    ("fused_serve", SERVE_SRC, "longterm360fov_tpu/ops/fused_lstm.py:503", fused_lstm.fused_serve, S2S_SERVE),
    ("fused_lstm_cell", SERVE_SRC, "longterm360fov_tpu/ops/fused_lstm.py:72", fused_lstm.fused_lstm_cell,
     S2S_CELL),
    ("fused_decode", SERVE_SRC, "longterm360fov_tpu/ops/fused_lstm.py:183", fused_lstm.fused_decode,
     S2S_DECODE),
    ("fused_serve_ctx", SERVE_SRC, "longterm360fov_tpu/ops/fused_lstm.py:503", fused_lstm.fused_serve, CU_SERVE),
    ("fused_encode", SERVE_SRC, "longterm360fov_tpu/ops/fused_lstm.py:741", fused_lstm.fused_encode, CU_SERVE),
    ("lstm_seq_states_fwd", LSTM_SRC, "longterm360fov_tpu/ops/lstm_train.py:172", lstm_train.lstm_fwd, S2S_TRAIN),
    ("lstm_seq_states_bwd", LSTM_SRC, "longterm360fov_tpu/ops/lstm_train.py:396", lstm_train.lstm_bwd, S2S_TRAIN),
    ("lstm_seq_states_dw", LSTM_SRC, "longterm360fov_tpu/ops/lstm_train.py:396", lstm_train.lstm_dw, S2S_TRAIN),
    # the pack pass of every dW reduction (each path's lstm_dw, ss_dw, dec_dw, peer_dw launch it)
    ("lstm_dw_pack", COMMON_SRC, "longterm360fov_tpu/ops/lstm_train.py:396", lstm_train.dw_pack, S2S_TRAIN),
    ("ss_decode_fwd", SS_SRC, "longterm360fov_tpu/ops/lstm_ss.py:175", lstm_ss.ss_fwd, CU_TRAIN),
    ("ss_decode_bwd", SS_SRC, "longterm360fov_tpu/ops/lstm_ss.py:404", lstm_ss.ss_bwd, CU_TRAIN),
    ("ss_decode_dw", SS_SRC, "longterm360fov_tpu/ops/lstm_ss.py:404", lstm_ss.ss_dw, CU_TRAIN),
    ("ss_decode_dproj", SS_SRC, "longterm360fov_tpu/ops/lstm_ss.py:404", lstm_ss.ss_dproj, CU_TRAIN),
    ("fused_serve_peers", SERVE_SRC, "longterm360fov_tpu/ops/fused_lstm.py:503", fused_lstm.fused_serve_peers,
     CU10_SERVE),
    ("peer_context", SERVE_SRC, "longterm360fov_tpu/ops/fused_lstm.py:503", fused_lstm.peer_context, CU10_SERVE),
    ("aligned_peer_fwd", ALIGN_SRC, ALIGN_FWD, lstm_align.peer_fwd, CU10_TRAIN),
    ("aligned_dec_fwd", ALIGN_SRC, ALIGN_FWD, lstm_align.dec_fwd, CU10_TRAIN),
    ("aligned_dec_bwd", ALIGN_SRC, ALIGN_BWD, lstm_align.dec_bwd, CU10_TRAIN),
    ("aligned_peer_bwd", ALIGN_SRC, ALIGN_BWD, lstm_align.peer_bwd, CU10_TRAIN),
    ("aligned_dec_dw", ALIGN_SRC, ALIGN_BWD, lstm_align.dec_dw, CU10_TRAIN),
    ("aligned_peer_dw", ALIGN_SRC, ALIGN_BWD, lstm_align.peer_dw, CU10_TRAIN),
    ("conv_resize", CONV_SRC, "longterm360fov_tpu/ops/conv_resize.py:75", conv_resize.fused_conv_resize, FE_PATH),
    ("fused_encode_tokens", TENC_SRC, "longterm360fov_tpu/ops/transformer_encode.py:226",
     transformer_encode.fused_encode_tokens, TF_SERVE_F32),
    ("fused_ar_decode", TDEC_SRC, "longterm360fov_tpu/ops/transformer_decode.py:754",
     transformer_decode.fused_ar_decode, TF_SERVE_F32),
    ("fused_ar_decode_shared", TDEC_SRC, "longterm360fov_tpu/ops/transformer_decode.py:754",
     transformer_decode.fused_ar_decode_shared, TF10_GROUPED_F32),
    ("fused_encode_tokens_bf16", TENC_SRC, "longterm360fov_tpu/ops/transformer_encode.py:226",
     transformer_encode.fused_encode_tokens_bf16, TF_SERVE),
    ("fused_ar_decode_bf16", TDEC_SRC, "longterm360fov_tpu/ops/transformer_decode.py:754",
     transformer_decode.fused_ar_decode_bf16, TF_SERVE),
    ("encode_train_fwd", TTRAIN_SRC, "longterm360fov_tpu/ops/transformer_encode_train.py:430",
     encode_train.encode_train_fwd, TF_TRAIN),
    ("encode_train_bwd", TTRAIN_SRC, "longterm360fov_tpu/ops/transformer_encode_train.py:486",
     encode_train.encode_train_bwd, TF_TRAIN),
    ("encode_train_dw", TTRAIN_SRC, "longterm360fov_tpu/ops/transformer_encode_train.py:486",
     encode_train.encode_train_dw, TF_TRAIN),
    # the bf16-compute tiers of rows 5-7 (train --train-compute bfloat16)
    ("lstm_seq_states_fwd_bf16", LSTM_SRC, "longterm360fov_tpu/ops/lstm_train.py:172",
     Bf16Count(lstm_train.lstm_fwd), S2S_TRAIN_BF16),
    ("lstm_seq_states_bwd_bf16", LSTM_SRC, "longterm360fov_tpu/ops/lstm_train.py:396",
     Bf16Count(lstm_train.lstm_bwd), S2S_TRAIN_BF16),
    ("lstm_seq_states_dw_bf16", LSTM_SRC, "longterm360fov_tpu/ops/lstm_train.py:396",
     Bf16Count(lstm_train.lstm_dw), S2S_TRAIN_BF16),
    ("lstm_dw_pack_bf16", COMMON_SRC, "longterm360fov_tpu/ops/lstm_train.py:396",
     Bf16Count(lstm_train.dw_pack), S2S_TRAIN_BF16),
    ("ss_decode_fwd_bf16", SS_SRC, "longterm360fov_tpu/ops/lstm_ss.py:175", Bf16Count(lstm_ss.ss_fwd),
     CU_TRAIN_BF16),
    ("ss_decode_bwd_bf16", SS_SRC, "longterm360fov_tpu/ops/lstm_ss.py:404", Bf16Count(lstm_ss.ss_bwd),
     CU_TRAIN_BF16),
    ("ss_decode_dw_bf16", SS_SRC, "longterm360fov_tpu/ops/lstm_ss.py:404", Bf16Count(lstm_ss.ss_dw),
     CU_TRAIN_BF16),
    ("ss_decode_dproj_bf16", SS_SRC, "longterm360fov_tpu/ops/lstm_ss.py:404", Bf16Count(lstm_ss.ss_dproj),
     CU_TRAIN_BF16),
    ("aligned_peer_fwd_bf16", ALIGN_SRC, ALIGN_FWD, Bf16Count(lstm_align.peer_fwd), CU10_TRAIN_BF16),
    ("aligned_dec_fwd_bf16", ALIGN_SRC, ALIGN_FWD, Bf16Count(lstm_align.dec_fwd), CU10_TRAIN_BF16),
    ("aligned_dec_bwd_bf16", ALIGN_SRC, ALIGN_BWD, Bf16Count(lstm_align.dec_bwd), CU10_TRAIN_BF16),
    ("aligned_peer_bwd_bf16", ALIGN_SRC, ALIGN_BWD, Bf16Count(lstm_align.peer_bwd), CU10_TRAIN_BF16),
    ("aligned_dec_dw_bf16", ALIGN_SRC, ALIGN_BWD, Bf16Count(lstm_align.dec_dw), CU10_TRAIN_BF16),
    ("aligned_peer_dw_bf16", ALIGN_SRC, ALIGN_BWD, Bf16Count(lstm_align.peer_dw), CU10_TRAIN_BF16),
    # the bf16 tiers of rows 1b, 4b and 2b (compute_dtype=bfloat16; the cell on a --bf16 model)
    ("fused_serve_bf16", SERVE_SRC, "longterm360fov_tpu/ops/fused_lstm.py:503", Bf16Count(fused_lstm.fused_serve),
     S2S_SERVE_BF16),
    ("fused_serve_ctx_bf16", SERVE_SRC, "longterm360fov_tpu/ops/fused_lstm.py:503",
     Bf16Count(fused_lstm.fused_serve), CU_SERVE_BF16),
    ("fused_encode_bf16", SERVE_SRC, "longterm360fov_tpu/ops/fused_lstm.py:741", Bf16Count(fused_lstm.fused_encode),
     CU_SERVE_BF16),
    ("fused_serve_peers_bf16", SERVE_SRC, "longterm360fov_tpu/ops/fused_lstm.py:503",
     Bf16Count(fused_lstm.fused_serve_peers), CU10_SERVE_BF16),
    ("peer_context_bf16", SERVE_SRC, "longterm360fov_tpu/ops/fused_lstm.py:503", Bf16Count(fused_lstm.peer_context),
     CU10_SERVE_BF16),
    ("fused_lstm_cell_bf16", SERVE_SRC, "longterm360fov_tpu/ops/fused_lstm.py:72",
     Bf16Count(fused_lstm.fused_lstm_cell), S2S_CELL_BF16),
]
BF, F32 = torch.bfloat16, torch.float32
WRAPPERS = {name: wrapper for name, _, _, wrapper, _ in KERNELS}
ERRS = {name: 0.0 for name in WRAPPERS}  # max abs error vs plain over every check
TIMES = {}  # kernel name -> {"ms", "plain_ms", "library_ms", "bound_ms", "bound_by"}
BUILD_LOGS = {}  # kernel source -> nvcc's ptxas report of this run's build


@functools.cache
def sass(path):
    """cuobjdump -sass of a built library, read once a run."""
    return subprocess.run([os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump"), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
PROBE_BUILD = None  # the probe build of transformer_encode.cu (-DTFM_PROBE: clock64 counters)
PROBE_TRAIN_BUILD = None  # the same of transformer_encode_train.cu
PROBE_PARTS = ("prologue", "in_proj", "layer norms", "chunk waits", "mma", "epilogues", "b1 + GELU", "attention",
               "barriers", "rows out", "stash", "dW products", "partial writes")  # tfm::Part, in order


def note_err(name, err):
    ERRS[name] = max(ERRS[name], float(err))


START = time.perf_counter()


def phase(label):
    """One line at the start of each phase: the script's time so far."""
    print(f"[{time.perf_counter() - START:.1f} s] phase {label}", flush=True)


def unit_pasts(rng, n, h_in):
    v = rng.normal(size=(n, h_in, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns, iters):
    """ms per call of each of ``fns`` ({name: fn}), timed in turns: the order
    of ``fns``, then backwards, and the two averaged (plain, kernel, kernel,
    plain), so that a drift of the card's clock falls on every name alike."""
    ms = dict.fromkeys(fns, 0.0)
    for name in list(fns) + list(reversed(fns)):
        ms[name] += cuda_ms(fns[name], iters[name]) / 2
    return ms


def bound(flop, reads, writes, peak=F32_FLOPS):
    """The least time the card could take for this work: the larger of its
    FLOP over ``peak`` (the f32 FMA peak; the bf16 tiers' products at the
    bf16 tensor-core peak) and its bytes (every input read once, every
    output written once, in the types given) over the memory rate → (ms,
    "operations" or "bytes"). ``flop`` may be {peak: FLOP} for work of
    several types (the f32 encoder's three-pass TF32 products beside its
    FMA attention): the operations then take the longest of their types'
    times, the units running side by side."""
    nbytes = sum(t.numel() * t.element_size() for t in reads + writes if t is not None)
    work = flop if isinstance(flop, dict) else {peak: flop}
    ops_ms, bytes_ms = max(f / pk for pk, f in work.items()) * 1e3, nbytes / HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def flop_of(work):
    """The FLOP of a bound()'s work: a number, or its types' sum."""
    return sum(work.values()) if isinstance(work, dict) else work


def stack_flop(batch, t_len, ins, hidden):
    """FLOP of one pass of the stacked gate products: 2·B·T·Σ_l (in_l + H)·4H
    (the forward's [x, h]·W, the backward's dgates·Wᵀ, the dW reduction)."""
    return sum(2 * batch * t_len * (i + hidden) * 4 * hidden for i in ins)


def record(name, ms, flop, reads, writes, peak=F32_FLOPS):
    """Keep a kernel's times and its bound for the kernels line."""
    b_ms, b_by = bound(flop, reads, writes, peak)
    TIMES[name] = {"ms": ms["kernel"], "plain_ms": ms["plain"], "library_ms": ms.get("library"),
                   "bound_ms": b_ms, "bound_by": b_by}


PATH_LAUNCHES = {}  # every path driven -> the launches of its kernels, for the kernels line


def drive(path, fn, also=()):
    """Run one main path with every launch counter at 0 just before and read
    just after; fail if a kernel of the path (those whose launches it gives,
    and ``also``) never launched."""
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    out = fn()
    torch.cuda.synchronize()
    names = [name for name, *_, p in KERNELS if p == path] + list(also)
    launches = {name: WRAPPERS[name].launches for name in names}
    print(f"{path}: main path launches {json.dumps(launches)}", flush=True)
    PATH_LAUNCHES[path] = launches
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"the main path '{path}' never launched kernel {name}")
    return out, launches


def stack(rng, dev, in0, layers, h=128):
    """Glorot-uniform full-width LSTM layers with small biases."""
    ps = []
    for l in range(layers):
        fan = (in0 if l == 0 else h) + h
        lim = np.sqrt(6 / (fan + 4 * h))
        ps.append(LSTMParams(
            torch.tensor(rng.uniform(-lim, lim, size=(fan, 4 * h)).astype(np.float32), device=dev),
            torch.tensor(rng.normal(size=4 * h).astype(np.float32) * 0.1, device=dev)))
    return ps


def randn(rng, dev, shape, scale=1.0):
    """N(0, scale²) drawn on ``dev`` by a generator seeded from ``rng``: the
    large inputs of the checks and timings are not drawn on the host."""
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**62)))
    return torch.randn(shape, generator=gen, device=dev) * scale


def unit_rows(rng, dev, shape):
    """Unit 3-vectors, (*shape, 3), drawn on ``dev`` as :func:`randn`."""
    v = randn(rng, dev, (*shape, 3))
    return v / v.norm(dim=-1, keepdim=True)


def family_fns(fam, **kw):
    """The training hooks of a family, as ``cli train`` passes them; ``kw``
    (a residual dtype) goes to its fused forward."""
    def bind(fn):
        return None if fn is None else (lambda *a, **k: fn(*a, **kw, **k))
    return dict(extras_fn=getattr(fam, "batch_extras", None),
                fused_tf_fn=bind(getattr(fam, "apply_fused_tf", None)),
                fused_ss_fn=bind(getattr(fam, "apply_fused_ss", None)))


# --------------------------------------------------------------- phase 3: kernels vs plain


def same_rows(name, out, run, batch, seed, what):
    """``run(perm)``, the kernel on the batch's rows in ``perm``'s order
    (None: as they are): a repeat bit-equal to ``out``, and every row of a
    permuted batch bit-equal to its row in ``out`` (the batcher and the
    gateway compare answers across batches)."""
    perm = torch.randperm(batch, generator=torch.Generator().manual_seed(seed)).to(out.device)
    if not torch.equal(out, run(None)):
        raise AssertionError(f"{name}: a repeat is not bit-equal ({what})")
    if not torch.equal(out[perm], run(perm)):
        raise AssertionError(f"{name}: a row's answer depends on its place in the batch ({what})")


def take(t, perm, dim=0):
    """``t``'s rows in ``perm``'s order along ``dim`` (None: ``t``)."""
    return t if t is None or perm is None else t.index_select(dim, perm).contiguous()


def check_serve(dev, batch, layers, ctx_dim, seed, t=30, cd=F32, repeat=False):
    """fused_serve (with a static context when ctx_dim > 0) in the compute
    type ``cd`` against fused_serve_reference on the same inputs
    (:func:`check_outputs`, kind "serve"); ``repeat``: also a repeat and a
    permuted batch (:func:`same_rows`)."""
    rng = np.random.default_rng(seed)
    enc, dec = stack(rng, dev, 3, layers), stack(rng, dev, 3 + ctx_dim, layers)
    pw, pb = randn(rng, dev, (128, 3), 0.1), randn(rng, dev, (3,), 0.1)
    past = unit_rows(rng, dev, (batch, t))
    past_n = windows.normalize_window(past)[0].contiguous()
    ctx = randn(rng, dev, (batch, ctx_dim)) if ctx_dim else None
    args = (enc, dec, pw, pb, past_n, t)
    out = fused_lstm.fused_serve(*args, context=ctx, compute_dtype=cd)
    torch.cuda.synchronize()
    if repeat:
        same_rows("fused_serve", out, lambda perm: fused_lstm.fused_serve(
            *args[:4], take(past_n, perm), t, context=take(ctx, perm), compute_dtype=cd), batch, seed,
            f"B={batch}, L={layers}, C={ctx_dim}")
    return check_outputs("fused_serve_ctx" if ctx_dim else "fused_serve", [out],
                         plains(cd, lambda c: [fused_lstm.fused_serve_reference(*args, ctx, compute_dtype=c)]),
                         f"B={batch}, L={layers}, C={ctx_dim}", "serve", cd)


@contextlib.contextmanager
def f32_rows(rows):
    """The f32 serve kernel, fused_decode and the f32 peer context in blocks
    of ``rows`` rows (32: one row of warp tiles; the lockstep serve
    kernel's 32 x 16 tiles in place of 64 x 8), their choosers' other
    shape."""
    serve, peer = fused_lstm.serve_tf32_rows, fused_lstm.peer_tf32_rows
    fused_lstm.serve_tf32_rows = lambda *a, **kw: serve(*a, rows=rows, **kw)
    fused_lstm.peer_tf32_rows = lambda *a, **kw: peer(*a, rows=rows, **kw)
    try:
        yield
    finally:
        fused_lstm.serve_tf32_rows, fused_lstm.peer_tf32_rows = serve, peer


@contextlib.contextmanager
def serve_rows(rows):
    """The bf16 serve kernel in blocks of ``rows`` rows inside the block
    (16: tiles of 16 rows, MT = 1), its chooser's other shape."""
    choose = fused_lstm.serve_tc_rows
    fused_lstm.serve_tc_rows = lambda *a, **kw: choose(*a, rows=rows, **kw)
    try:
        yield
    finally:
        fused_lstm.serve_tc_rows = choose


def check_encode(dev, batch, layers, seed, t=30, cd=F32, repeat=False):
    """fused_encode in the compute type ``cd`` against
    fused_encode_reference (:func:`check_outputs`, kind "encode");
    ``repeat``: also a repeat and a permuted batch (:func:`same_rows`)."""
    rng = np.random.default_rng(seed)
    ps = stack(rng, dev, 3, layers)
    xs = randn(rng, dev, (batch, t, 3), 0.3)
    out = fused_lstm.fused_encode(ps, xs, compute_dtype=cd)
    torch.cuda.synchronize()
    if repeat:
        same_rows("fused_encode", out, lambda perm: fused_lstm.fused_encode(ps, take(xs, perm), compute_dtype=cd),
                  batch, seed, f"B={batch}, L={layers}")
    return check_outputs("fused_encode", [out], plains(cd, lambda c: [fused_lstm.fused_encode_reference(ps, xs, c)]),
                         f"B={batch}, L={layers}", "encode", cd)


def check_cell(dev, batch, d_in, seed, cd=F32, hidden=128, offset=False):
    """fused_lstm_cell against lstm_cell on the same inputs, every tensor
    in ``cd``: in bf16 (a --bf16 model's cell) against ``lstm_cell`` on the
    bf16 tensors, its plain version, and on their f32 widening
    (:func:`check_outputs`, kind "cell", over h and c); ``offset``: x and h
    one element past an aligned address. A repeat is bit-equal."""
    rng = np.random.default_rng(seed)
    (p,) = stack(rng, dev, d_in, 1, h=hidden)
    p = LSTMParams(p.w.to(cd), p.b.to(cd))
    k = int(offset)
    x = randn(rng, dev, (batch * d_in + k,)).to(cd)[k:].view(batch, d_in)
    h = randn(rng, dev, (batch * hidden + k,), 0.5).to(cd)[k:].view(batch, hidden)
    c = randn(rng, dev, (batch, hidden), 0.5).to(cd)
    got = fused_lstm.fused_lstm_cell(p, x, (h, c))
    again = fused_lstm.fused_lstm_cell(p, x, (h, c))
    torch.cuda.synchronize()
    if any(g.dtype != cd for g in got):
        raise AssertionError(f"fused_lstm_cell wrote {[g.dtype for g in got]} on {cd} inputs")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"fused_lstm_cell's repeat differs (B={batch}, D_in={d_in}, H={hidden})")

    def plain(c_):
        return list(lstm_cell(LSTMParams(*(t.to(c_) for t in p)), x.to(c_), (h.to(c_), c.to(c_))))
    return check_outputs("fused_lstm_cell", list(got), plains(cd, plain), f"B={batch}, D_in={d_in}, H={hidden}",
                         "cell", cd)


def check_decode(dev, batch, layers, ctx_dim, seed, t=30, repeat=False):
    """fused_decode against fused_decode_reference from random states →
    max abs error; ``repeat``: also a repeat and a permuted batch
    (:func:`same_rows`)."""
    rng = np.random.default_rng(seed)
    dec = stack(rng, dev, 3 + ctx_dim, layers)
    pw, pb = randn(rng, dev, (128, 3), 0.1), randn(rng, dev, (3,), 0.1)
    h0, c0 = randn(rng, dev, (layers, batch, 128), 0.3), randn(rng, dev, (layers, batch, 128), 0.3)
    y0 = randn(rng, dev, (batch, 3), 0.1)
    ctx = randn(rng, dev, (batch, ctx_dim)) if ctx_dim else None
    out = fused_lstm.fused_decode(dec, pw, pb, h0, c0, y0, t, context=ctx)
    torch.cuda.synchronize()
    if repeat:
        same_rows("fused_decode", out, lambda perm: fused_lstm.fused_decode(
            dec, pw, pb, take(h0, perm, 1), take(c0, perm, 1), take(y0, perm), t, context=take(ctx, perm)), batch,
            seed, f"B={batch}, L={layers}, C={ctx_dim}")
    ref = fused_lstm.fused_decode_reference(dec, pw, pb, h0, c0, y0, t, ctx)
    if out.shape != (batch, t, 3) or not torch.isfinite(out).all():
        raise AssertionError(f"fused_decode output {tuple(out.shape)} not finite or misshapen")
    err = (out - ref).abs().max().item()
    if not err <= KERNEL_TOL:
        raise AssertionError(f"fused_decode disagrees with its plain version (B={batch}, L={layers}, C={ctx_dim}): "
                             f"{err:.3e}")
    note_err("fused_decode", err)
    return err


def within(a, b, kind, limit):
    """``a`` within ``limit`` of ``b``: absolute on a forward output (an
    ABSOLUTE kind; plus one bf16 step, 2^-7 of the value, where ``a`` is
    stored in bf16: an f32 difference of 1e-7 may round either way),
    relative to max|b| on a gradient."""
    diff = (a.float() - b.float()).abs()
    if kind in ABSOLUTE:
        return bool((diff <= limit + (2.0 ** -7 * b.float().abs() if a.dtype == BF else 0.0)).all())
    return diff.max().item() <= limit * b.float().abs().max().item()


def gap(a, b, kind):
    """The largest gap of ``a`` from ``b`` in its limit's unit (within)."""
    diff = (a.float() - b.float()).abs().max().item()
    return diff if kind in ABSOLUTE else diff / (b.float().abs().max().item() or 1.0)


def mean_gap(a, b):
    return (a.float() - b.float()).abs().mean().item()


def check_outputs(name, outs, refs, what, kind, cd=F32, unrounded=0):
    """A kernel's outputs ``outs`` against ``refs[0]``, its plain version's
    in its compute type ``cd``, on the same inputs; ``kind`` is "fwd", "rec",
    "sum" or "ctx_sum", or a serving kernel's "serve", "encode", "ctx" or
    "cell" (F32_LIMIT). In f32 within F32_LIMIT → the largest absolute
    gap. In bf16 (BF16C_*) within BF16C_TIGHT of ``refs[0]`` and
    BF16C_CONTRACT of ``refs[1]``, the f32 plain version's, and each output
    but the last ``unrounded`` (sums of unrounded values: db, dproj_b, dpwt)
    at least BF16C_FLOOR of the bf16 plain version's mean gap from the f32
    one → {"bf16", "f32": the largest gap to each in the limit's unit,
    "floor": the least of those ratios}. The largest absolute gap to
    ``refs[0]`` is kept as the kernel's error."""
    name += "_bf16" if cd == BF else ""
    limits = {"f32": F32_LIMIT[kind]} if cd == F32 else {"bf16": BF16C_TIGHT[kind], "f32": BF16C_CONTRACT[kind]}
    for (tier, limit), ref in zip(limits.items(), refs, strict=True):
        for a, b in zip(outs, ref, strict=True):
            if a.shape != b.shape or not torch.isfinite(a.float()).all() or not within(a, b, kind, limit):
                raise AssertionError(f"{name} disagrees with the {tier} plain version ({what}): "
                                     f"{gap(a, b, kind):.3e} (limit {limit})")
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(outs, refs[0]))
    note_err(name, err)
    if cd == F32:
        return err
    n = len(outs) - unrounded
    ratios = [mean_gap(a, f) / mean_gap(p, f) for a, p, f in zip(outs[:n], refs[0][:n], refs[1][:n])
              if mean_gap(p, f) > 0]
    readings = {tier: max(gap(a, b, kind) for a, b in zip(outs, ref)) for tier, ref in zip(limits, refs)}
    readings["floor"] = min(ratios, default=0.0)
    if not readings["floor"] >= BF16C_FLOOR:
        raise AssertionError(f"{name} stands {readings['floor']:.3f} of its bf16 plain version's gap from the f32 "
                             f"plain version ({what}): it does not round as the tier does")
    return readings


def plains(cd, fn):
    """``fn(compute_dtype)``: the plain version in the compute type ``cd``,
    and in bf16 the f32 one after it."""
    return [fn(cd)] if cd == F32 else [fn(BF), fn(F32)]


def grads(out):
    """A backward's outputs as one list of tensors (per-layer lists
    flattened, absent outputs dropped)."""
    flat = []
    for x in out:
        flat += list(x) if isinstance(x, list) else [] if x is None else [x]
    return flat


def wb(ps):
    """Per-layer parameters (or their gradients) as [w..., b...]."""
    return [p.w for p in ps] + [p.b for p in ps]


def fwd_outs(res):
    return res.hs + res.cs + res.gs


def lstm_case(dev, batch, layers, seed, t=30, d=3, h=128):
    """Random full-width weights, inputs, initial states and upstream
    gradients from a numpy seed."""
    rng = np.random.default_rng(seed)
    ps = stack(rng, dev, d, layers, h)
    ts = [randn(rng, dev, s, sc)
          for s, sc in (((batch, t, d), 0.3), ((layers, batch, h), 0.3), ((layers, batch, h), 0.3),
                        ((batch, t, h), 1.0), ((layers, batch, h), 1.0), ((layers, batch, h), 1.0))]
    return ps, ts[:3], ts[3:]


def check_lstm_kernels(dev, batch, layers, rd, seed, cd=F32, t=30):
    """The three lstm_seq_states kernels in the compute type ``cd`` against
    their plain versions on the same inputs (the backward fed the kernel's
    residuals and random dhs_top, dhT, dcT, the reduction the plain
    dgates), the backward's repeat and permuted batch bit-equal → check_outputs'
    reading of each."""
    ps, (xs, h0, c0), up = lstm_case(dev, batch, layers, seed, t=t)
    what = f"B={batch}, T={t}, L={layers}, {str(rd)[6:]} residuals, {str(cd)[6:]} compute"
    res = lstm_train.lstm_fwd(ps, xs, h0, c0, rd, cd)
    refs = plains(cd, lambda c: lstm_train._forward_reference(ps, xs, h0, c0, rd, c))
    torch.cuda.synchronize()
    errs = {"fwd": check_outputs("lstm_seq_states_fwd", fwd_outs(res), [fwd_outs(r) for r in refs], what, "fwd", cd)}
    bw = lstm_train.lstm_bwd(ps, c0, res, *up, compute_dtype=cd)
    same_bwd_rows(ps, c0, res, up, cd, bw, seed, what)
    bws = plains(cd, lambda c: lstm_train._bwd_recurrence_reference(ps, c0, res, *up, c))
    dps = lstm_train.lstm_dw(ps, xs, h0, res, bws[0][0], cd)
    dws = plains(cd, lambda c: lstm_train._dw_reference(ps, xs, h0, res, bws[0][0], c))
    torch.cuda.synchronize()
    errs["bwd"] = check_outputs("lstm_seq_states_bwd", grads(bw), [grads(b) for b in bws], what, "rec", cd)
    errs["dw"] = check_outputs("lstm_seq_states_dw", wb(dps), [wb(d) for d in dws], what, "sum", cd,
                               unrounded=layers)
    errs["pack"] = check_packs(lstm_train.lstm_dw, (ps, xs, h0, res, bws[0][0]), layers, xs, h0, res, what, cd)
    return errs


def same_bwd_rows(ps, c0, res, up, cd, out, seed, what):
    """lstm_seq_states' backward on the same inputs again and on the batch
    permuted: every output bit-equal, in the permuted order (dgates and dxs
    along their rows, dh0 and dc0 along their batch axis)."""
    batch = c0.shape[1]
    perm = torch.randperm(batch, generator=torch.Generator().manual_seed(seed)).to(c0.device)
    again = lstm_train.lstm_bwd(ps, c0, res, *up, compute_dtype=cd)
    res_p = lstm_train.Residuals(*[[x[perm] for x in part] for part in res])
    cut = lstm_train.lstm_bwd(ps, c0[:, perm], res_p, up[0][perm], up[1][:, perm], up[2][:, perm], compute_dtype=cd)
    if not all(torch.equal(a, b) for a, b in zip(grads(out), grads(again))):
        raise AssertionError(f"lstm_seq_states_bwd: a repeat is not bit-equal ({what})")
    moved = [*[g[perm] for g in out[0]], out[1][perm], out[2][:, perm], out[3][:, perm]]
    if not all(torch.equal(a, b) for a, b in zip(moved, grads(cut))):
        raise AssertionError(f"lstm_seq_states_bwd: a row's gradients depend on its place in the batch ({what})")


def check_packs(dw, args, layers, x0, h0, res, what, cd):
    """The pack kernel of the reduction ``dw`` (its arguments ``args``) at
    every layer against its plain version (``x0`` layer 0's input, its
    first 3 features x_t), and two runs of ``dw`` bit-equal (no float
    atomics) → check_outputs' reading at each layer."""
    readings = []
    for l in range(layers):
        zp = lstm_train.dw_pack(dw, *args, layer=l, compute_dtype=cd)
        refs = plains(cd, lambda c: [lstm_train._pack_reference(x0, h0, res, l, 3 if l == 0 else 0, c)])
        readings.append(check_outputs("lstm_dw_pack", [zp], refs, f"{what}, layer {l}", "fwd", cd))
    first, again = dw(*args, cd), dw(*args, cd)
    torch.cuda.synchronize()
    flat = wb if isinstance(first, list) else (lambda out: [out.w, out.b])
    if not all(torch.equal(a, b) for a, b in zip(flat(first), flat(again), strict=True)):
        raise AssertionError(f"{dw.__name__} is not bit-equal on repeat ({what})")
    return readings


def ss_case(dev, batch, layers, ctx_dim, coins, seed, t=30, d=3, h=128):
    """Full-width decoder weights, states, teacher inputs, coins
    ("bernoulli" at 0.5 from the numpy seed, "1" all teacher, "0" all
    model), context and upstream gradients."""
    rng = np.random.default_rng(seed)
    ps = stack(rng, dev, d + ctx_dim, layers, h)
    if coins == "bernoulli":
        c = torch.tensor((rng.random((t, batch, 1)) < 0.5).astype(np.float32), device=dev)
    else:
        c = torch.full((t, batch, 1), float(coins), device=dev)
    a = dict(proj_w=randn(rng, dev, (h, d), 0.1), proj_b=randn(rng, dev, (d,), 0.1),
             h0=randn(rng, dev, (layers, batch, h), 0.3), c0=randn(rng, dev, (layers, batch, h), 0.3),
             y0=randn(rng, dev, (batch, d), 0.1), teacher=randn(rng, dev, (t, batch, d), 0.1), coins=c,
             ctx=randn(rng, dev, (batch, ctx_dim)) if ctx_dim else None,
             dys=randn(rng, dev, (batch, t, d)))
    return ps, a


def ss_fwd_args(ps, a):
    return (ps, a["proj_w"], a["proj_b"], a["h0"], a["c0"], a["y0"], a["teacher"], a["coins"], a["ctx"])


def check_ss_kernels(dev, batch, layers, ctx_dim, rd, coins, seed, cd=F32):
    """The four ss_decode kernels in the compute type ``cd`` against their
    plain versions on the same inputs: the forward on ys and the residuals;
    the backward recurrence, fed the kernel's residuals, on dgates, dy,
    dteacher, dy0, dh0, dc0 and dctx; the reductions, fed the plain dgates
    and dy, on dW, db, dproj_w and dproj_b → check_outputs' reading of
    each."""
    ps, a = ss_case(dev, batch, layers, ctx_dim, coins, seed)
    what = f"B={batch}, L={layers}, C={ctx_dim}, coins {coins}, {str(rd)[6:]} residuals, {str(cd)[6:]} compute"
    ys, res = lstm_ss.ss_fwd(*ss_fwd_args(ps, a), rd, cd)
    refs = plains(cd, lambda c: lstm_ss._forward_reference(*ss_fwd_args(ps, a), rd, c))
    torch.cuda.synchronize()
    errs = {"fwd": check_outputs("ss_decode_fwd", [ys] + fwd_outs(res), [[y] + fwd_outs(r) for y, r in refs],
                                 what, "fwd", cd)}
    bwd_args = (ps, a["proj_w"], a["c0"], a["coins"], res, a["dys"], ctx_dim)
    bw = lstm_ss.ss_bwd(*bwd_args, cd)
    bws = plains(cd, lambda c: lstm_ss._bwd_recurrence_reference(*bwd_args, compute_dtype=c))
    dw_in = (ps, a["h0"], a["y0"], a["teacher"], a["coins"], a["ctx"], ys, res, bws[0][0])
    dps, dws = lstm_ss.ss_dw(*dw_in, cd), plains(cd, lambda c: lstm_ss._dw_reference(*dw_in, c))
    dproj = lstm_ss.ss_dproj(res.hs[-1], bws[0][1], cd)
    dprojs = plains(cd, lambda c: lstm_ss._dproj_reference(res.hs[-1], bws[0][1], c))
    torch.cuda.synchronize()
    if (bw[6] is None) != (ctx_dim == 0):
        raise AssertionError(f"ss_bwd gave dctx {bw[6] is not None} for C={ctx_dim}")
    errs["bwd"] = check_outputs("ss_decode_bwd", grads(bw), [grads(b) for b in bws], what, "rec", cd)
    errs["dw"] = check_outputs("ss_decode_dw", wb(dps), [wb(d) for d in dws], what, "sum", cd, unrounded=layers)
    x0 = lstm_ss._layer0_input(a["y0"], a["teacher"], a["coins"], a["ctx"], ys)
    errs["pack"] = check_packs(lstm_ss.ss_dw, dw_in, layers, x0, a["h0"], res, what, cd)
    errs["dproj"] = check_outputs("ss_decode_dproj", list(dproj), [list(d) for d in dprojs], what, "sum", cd,
                                  unrounded=1)
    return errs


def peer_inputs(rng, dev, past_n, k, t):
    """K peer futures per viewer, unit vectors in the viewer's anchor frame
    (as ``batch_extras`` gives them), and mask weights ``mask / max(Σ mask,
    1)`` with row 0 all masked."""
    batch = past_n.shape[0]
    anchor = unit_rows(rng, dev, (batch, 1))
    pxs = (unit_rows(rng, dev, (batch, k, t)) - anchor[:, None]).contiguous()
    m = (rng.random((batch, k)) < 0.6).astype(np.float32)
    m[0] = 0.0
    w = torch.tensor(m / np.maximum(m.sum(1, keepdims=True), 1.0), device=dev)
    return pxs, w


def check_peer_serve(dev, batch, layers, k, seed, t=100, cd=F32, repeat=False):
    """The lockstep tier (peer_context, then the serve kernel with the
    per-step context) in the compute type ``cd`` against its plain versions
    with the same peers (:func:`check_outputs`: peer_context kind "ctx",
    the tier's output "serve") → {kernel: its reading}; ``repeat``: also a
    repeat and a permuted batch of both (:func:`same_rows`)."""
    rng = np.random.default_rng(seed)
    enc, dec, peer = stack(rng, dev, 3, layers), stack(rng, dev, 3 + 128, layers), stack(rng, dev, 3, 1)[0]
    pw, pb = randn(rng, dev, (128, 3), 0.1), randn(rng, dev, (3,), 0.1)
    past_n = windows.normalize_window(unit_rows(rng, dev, (batch, t)))[0].contiguous()
    pxs, w = peer_inputs(rng, dev, past_n, k, t)
    ctx = fused_lstm.peer_context(peer, pxs, w, compute_dtype=cd)
    args = (enc, dec, pw, pb, past_n, t)
    kw = dict(peer_params=peer, peer_xs=pxs, peer_w=w)
    out = fused_lstm.fused_serve(*args, compute_dtype=cd, **kw)
    torch.cuda.synchronize()
    what = f"B={batch}, L={layers}, K={k}"
    if out.shape != (batch, t, 3) or ctx[0].any():
        raise AssertionError(f"lockstep tier output misshapen or a masked row not zero ({what})")
    if repeat:
        same_rows("peer_context", ctx, lambda perm: fused_lstm.peer_context(
            peer, take(pxs, perm), take(w, perm), compute_dtype=cd), batch, seed, what)
        same_rows("fused_serve_peers", out, lambda perm: fused_lstm.fused_serve(
            *args[:4], take(past_n, perm), t, compute_dtype=cd, peer_params=peer, peer_xs=take(pxs, perm),
            peer_w=take(w, perm)), batch, seed, what)
    return {"peer_context": check_outputs(
                "peer_context", [ctx], plains(cd, lambda c: [fused_lstm.peer_context_reference(peer, pxs, w, c)]),
                what, "ctx", cd),
            "fused_serve_peers": check_outputs(
                "fused_serve_peers", [out],
                plains(cd, lambda c: [fused_lstm.fused_serve_reference(*args, compute_dtype=c, **kw)]), what,
                "serve", cd)}


def aligned_case(dev, batch, layers, k, coins, seed, t=100):
    """ss_case's decoder inputs, plus a peer cell, peer windows (B·K, T, D)
    and mask weights with an all-masked row."""
    ps, a = ss_case(dev, batch, layers, 128, coins, seed, t=t)
    rng = np.random.default_rng(seed + 100)
    past_n = randn(rng, dev, (batch, 1, 3))
    pxs, w = peer_inputs(rng, dev, past_n, k, t)
    a.update(peer=stack(rng, dev, 3, 1)[0], pxs=pxs.reshape(batch * k, t, 3), pwt=w)
    return ps, a


def check_aligned_kernels(dev, batch, layers, k, rd, coins, seed, cd=F32):
    """The six aligned_ss_decode kernels in the compute type ``cd`` against
    their plain versions on the same inputs: the peer forward on the peer
    h, c and ctx; the decoder forward, fed the plain ctx, on ys and its
    residuals; the decoder backward on dgates, dy, dteacher, dy0, dh0, dc0
    and the per-step dctx; the peer backward, fed the plain dctx, on the
    peer dgates, dpxs and dpwt; the reductions, fed the plain dgates, on dW
    and db → check_outputs' reading of each."""
    ps, a = aligned_case(dev, batch, layers, k, coins, seed)
    what = f"B={batch}, L={layers}, K={k}, coins {coins}, {str(rd)[6:]} residuals, {str(cd)[6:]} compute"
    php, pcp, ctx = lstm_align.peer_fwd(a["peer"], a["pxs"], a["pwt"], rd, cd)
    prefs = plains(cd, lambda c: lstm_align._peer_fwd_reference(a["peer"], a["pxs"], a["pwt"], rd, c))
    fwd_args = (ps, a["proj_w"], a["proj_b"], a["h0"], a["c0"], a["y0"], a["teacher"], a["coins"], prefs[0][2])
    ys, res = lstm_align.dec_fwd(*fwd_args, rd, cd)
    refs = plains(cd, lambda c: lstm_ss._forward_reference(*fwd_args, rd, c))
    torch.cuda.synchronize()
    errs = {"peer_fwd": check_outputs("aligned_peer_fwd", [php, pcp, ctx], [list(r) for r in prefs], what, "fwd", cd),
            "dec_fwd": check_outputs("aligned_dec_fwd", [ys] + fwd_outs(res), [[y] + fwd_outs(r) for y, r in refs],
                                     what, "fwd", cd)}
    bwd_args = (ps, a["proj_w"], a["c0"], a["coins"], res, a["dys"], 128)
    bw = lstm_align.dec_bwd(*bwd_args, cd)
    bws = plains(cd, lambda c: lstm_ss._bwd_recurrence_reference(*bwd_args, step_ctx=True, compute_dtype=c))
    pargs = (a["peer"], a["pxs"], a["pwt"], php, pcp, bws[0][6])
    pb, pbs = lstm_align.peer_bwd(*pargs, cd), plains(cd, lambda c: lstm_align._peer_bwd_reference(*pargs, c))
    dw_in = (ps, a["h0"], a["y0"], a["teacher"], a["coins"], a["pwt"], php, ys, res, bws[0][0])
    dps, dws = lstm_align.dec_dw(*dw_in, cd), plains(cd, lambda c: lstm_align._dw_reference(*dw_in, c))
    pdw_in = (a["peer"], a["pxs"], php, pbs[0][0])
    pdw, pdws = lstm_align.peer_dw(*pdw_in, cd), plains(cd, lambda c: lstm_align._peer_dw_reference(*pdw_in, c))
    torch.cuda.synchronize()
    errs["dec_bwd"] = check_outputs("aligned_dec_bwd", grads(bw), [grads(b) for b in bws], what, "rec", cd)
    errs["peer_bwd"] = check_outputs("aligned_peer_bwd", list(pb), [list(b) for b in pbs], what, "rec", cd,
                                     unrounded=1)
    errs["dec_dw"] = check_outputs("aligned_dec_dw", wb(dps), [wb(d) for d in dws], what, "ctx_sum", cd,
                                   unrounded=layers)
    errs["peer_dw"] = check_outputs("aligned_peer_dw", wb([pdw]), [wb([d]) for d in pdws], what, "sum", cd,
                                    unrounded=1)
    x0 = lstm_ss._layer0_input(a["y0"], a["teacher"], a["coins"], lstm_align._rebuilt_ctx(php, a["pwt"]), ys)
    errs["pack"] = check_packs(lstm_align.dec_dw, dw_in, layers, x0, a["h0"], res, what, cd)
    no_h = torch.zeros((1, php.shape[0], php.shape[2]), device=dev)  # the peers start from zero state
    errs["peer_pack"] = check_packs(lstm_align.peer_dw, pdw_in, 1, a["pxs"], no_h, lstm_train.Residuals([php], [], []),
                                    what, cd)
    return errs


def check_conv_resize(dev, shape, out_hw, c, seed, k=3):
    """conv_resize against conv_resize_reference on the same inputs (frames
    N(0, 1), k x k filters N(0, 1/k²), bias N(0, 0.01)) → max abs error."""
    rng = np.random.default_rng(seed)
    frames, kernels, bias = randn(rng, dev, shape), randn(rng, dev, (c, k, k), 1 / k), randn(rng, dev, (c,), 0.1)
    out = conv_resize.fused_conv_resize(frames, out_hw, kernels, bias)
    again = conv_resize.fused_conv_resize(frames, out_hw, kernels, bias)
    torch.cuda.synchronize()
    ref = conv_resize.conv_resize_reference(frames, out_hw, kernels, bias)
    err = (out - ref).abs().max().item()
    if out.shape != ref.shape or not torch.isfinite(out).all() or not err <= CONV_REL_TOL * ref.abs().max().item():
        raise AssertionError(f"conv_resize disagrees with its plain version ({shape} → {out_hw}, C={c}, K={k}): "
                             f"{err:.3e}")
    if not torch.equal(out, again):
        raise AssertionError(f"conv_resize's repeat differs ({shape} → {out_hw}, C={c}, K={k})")
    note_err("conv_resize", err)
    return err


def check_all_kernels(dev):
    """Phase 3."""
    errs = {}
    for b, l, c in ((4099, 1, 0), (4099, 2, 0), (4099, 2, 128), (4099, 2, 64)):
        errs[f"B={b} L={l} C={c}"] = check_serve(dev, b, l, c, seed=l)
    print(f"fused_serve vs plain, hidden 128, 30+30 steps: max_abs_err {json.dumps(errs)} "
          f"(tolerance {KERNEL_TOL})", flush=True)
    errs = {f"B={b} L={l}": check_encode(dev, b, l, seed=l, repeat=True) for b in (16387, 262144) for l in (1, 2)}
    print(f"fused_encode vs plain (three-pass TF32, lstm_mma::encoder<Tf32Mma>; repeats and permuted batches "
          f"bit-equal), hidden 128, T=30: max_abs_err {json.dumps(errs)} (tolerance {ENC_TOL})", flush=True)
    errs = {}
    for batch in (4099, TRAIN_B):
        for layers in (1, 2):
            for rd in (torch.float32, torch.bfloat16):
                errs[f"B={batch} L={layers} {str(rd)[6:]}"] = check_lstm_kernels(dev, batch, layers, rd, seed=layers)
    print(f"lstm_seq_states kernels vs plain (the dW reduction's pack kernel at every layer too, and the reduction "
          f"bit-equal on repeat; the backward's repeats and permuted batches bit-equal), hidden 128, T=30, max_abs_err "
          f"{json.dumps(errs)} (forward {FWD_TOL}, plus one bf16 step with bf16 residuals; backward {BWD_REL_TOL} "
          f"of max|plain|)", flush=True)
    # row 5's backward at the 10 s encoder's shape, on the f32 residuals it trains with, in both compute types
    errs = {f"B={TRAIN_B} T=100 L=2 float32 {str(cd)[6:]} compute": check_lstm_kernels(dev, TRAIN_B, 2, F32, 10, cd,
                                                                                       t=100)
            for cd in (F32, BF)}
    print(f"lstm_seq_states kernels vs plain at the stacked-ss-crossuser-10s encoder's shape (the backward on "
          f"ss_bwd_kernel's teacher-forced mode), hidden 128: {json.dumps(errs)} (f32 compute: forward {FWD_TOL}, "
          f"backward and reduction {BWD_REL_TOL} of max|plain|; bf16 compute: limits bf16 "
          f"{json.dumps(BF16C_TIGHT)}, f32 {json.dumps(BF16C_CONTRACT)}, floor {BF16C_FLOOR})", flush=True)
    errs = {}
    for batch in (4099, TRAIN_B):
        for layers, ctx_dim in ((1, 0), (2, 128), (2, 64)):
            for rd in (torch.float32, torch.bfloat16):
                for coins in ("bernoulli", "1", "0"):
                    key = f"B={batch} L={layers} C={ctx_dim} {str(rd)[6:]} coins={coins}"
                    errs[key] = check_ss_kernels(dev, batch, layers, ctx_dim, rd, coins, seed=layers)
    print(f"ss_decode kernels vs plain (with the dW pack kernel and a repeat, as above), hidden 128, T=30, D=3, "
          f"max_abs_err {json.dumps(errs)} "
          f"(forward {FWD_TOL}, plus one bf16 step on bf16 residuals; backward and reductions "
          f"{BWD_REL_TOL} of max|plain| per output)", flush=True)
    # K = 9, 16, 64, 256 (predict --peers K): B·K about the 10 s preset's 28,672 peer rows; at K = 256 one
    # viewer a block of 256 rows, c and the staging of h in device memory
    errs = {f"B={b} L={l} K={k}": check_peer_serve(dev, b, l, k, seed=l + k)
            for b, l, k in ((4099, 1, 7), (4099, 2, 7), (4099, 2, 3), (16384, 2, 7), (3186, 2, 9), (1792, 2, 16),
                            (448, 2, 64), (112, 2, 256))}
    print(f"lockstep fused_serve tier vs plain, hidden 128, C=128, 100+100 steps, a row with every peer "
          f"masked: max_abs_err {json.dumps(errs)} (peer_context {ENC_TOL}, outputs {KERNEL_TOL})", flush=True)
    errs = {}
    for batch, coin_kinds, shapes in ((4099, ("bernoulli", "1", "0"), ((1, 3), (2, 7))),
                                      (TRAIN_B, ("bernoulli",), ((1, 3), (2, 7), (2, 1)))):
        for layers, k in shapes:
            for rd in (torch.float32, torch.bfloat16):
                for coins in coin_kinds:
                    key = f"B={batch} L={layers} K={k} {str(rd)[6:]} coins={coins}"
                    errs[key] = check_aligned_kernels(dev, batch, layers, k, rd, coins, seed=layers + k)
    print(f"aligned_ss_decode kernels vs plain (with both dW pack kernels and repeats, as above), hidden 128, "
          f"C=128, T=100, D=3, K=3, 7 and 1, max_abs_err {json.dumps(errs)} "
          f"(forward {FWD_TOL}, plus one bf16 step on bf16 residuals; backward and reductions "
          f"{BWD_REL_TOL} of max|plain| per output)", flush=True)
    errs = {}
    for layers in (1, 2):
        for rd in (F32, BF):
            errs[f"B=4099 L={layers} {str(rd)[6:]}"] = check_lstm_kernels(dev, 4099, layers, rd, layers, BF)
    for layers, ctx_dim in ((1, 0), (2, 128), (2, 64)):
        for rd in (F32, BF):
            for coins in ("bernoulli", "1", "0"):
                key = f"B=4099 L={layers} C={ctx_dim} {str(rd)[6:]} coins={coins}"
                errs[key] = check_ss_kernels(dev, 4099, layers, ctx_dim, rd, coins, layers, BF)
    for layers, k, rd, coins in ((1, 3, F32, "bernoulli"), (1, 3, BF, "bernoulli"), (2, 7, F32, "bernoulli"),
                                 (2, 7, BF, "bernoulli"), (2, 7, BF, "1"), (2, 7, BF, "0"), (2, 1, BF, "bernoulli")):
        key = f"B=4099 L={layers} K={k} {str(rd)[6:]} coins={coins}"
        errs[key] = check_aligned_kernels(dev, 4099, layers, k, rd, coins, layers + k, BF)
    print(f"bf16-compute tiers of lstm_seq_states (T=30), ss_decode (30+30 steps) and aligned_ss_decode (100+100 "
          f"steps, C=128, a row with every peer masked), hidden 128, the largest gap to their bf16 and their f32 "
          f"plain versions (absolute on forwards, of max|plain| per output on gradients) and the least floor "
          f"ratio: {json.dumps(errs)} (limits: bf16 {json.dumps(BF16C_TIGHT)}, f32 {json.dumps(BF16C_CONTRACT)}, "
          f"one bf16 step more on a forward value stored in bf16; floor {BF16C_FLOOR})", flush=True)
    # K = 3 (the main path's filters: the register-window body) at the five
    # shapes and a row past the old design's 48 KB cap; then the body for
    # any odd K: K = 5 and 7 at the 64-frame shape, a ragged last column
    # tile (530 = 2 x 256 + 18 columns), a 20,000-column row and K = 1 in
    # whole-frame tiles
    errs = {f"{s[0]}x{s[1]}x{s[2]}->{hw[0]}x{hw[1]} C={c} K={k}": check_conv_resize(dev, s, hw, c, seed=i, k=k)
            for i, (s, hw, c, k) in enumerate((
                ((3, 48, 96), (16, 32), 4, 3), ((64, 960, 1920), (32, 64), 8, 3), ((4099, 64, 128), (16, 32), 4, 3),
                ((5, 12, 20), (16, 32), 4, 3), ((7, 961, 1917), (32, 64), 8, 3), ((2, 60, 30000), (12, 20000), 4, 3),
                ((64, 960, 1920), (32, 64), 8, 5), ((64, 960, 1920), (32, 64), 8, 7), ((3, 50, 700), (20, 530), 3, 5),
                ((2, 60, 30000), (12, 20000), 4, 7), ((300, 40, 80), (24, 40), 4, 1)))}
    print(f"conv_resize vs plain (tiles of conv_tile; K=3 at the five shapes and 20,000-column rows past the old "
          f"48 KB cap, then odd K=5, 7 and 1; repeats bit-equal): max_abs_err {json.dumps(errs)} (tolerance "
          f"{CONV_REL_TOL} of max|plain|)", flush=True)
    errs = {f"B={b} T={t} L={l}": check_tf_encode(dev, b, t, l, seed=i, repeat=i == 0)
            for i, (b, t, l) in enumerate(((16384, 30, 2), (4099, 30, 2), (4099, 13, 2), (1001, 64, 1), (129, 1, 2),
                                           (51, 30, 8)))}
    print(f"fused_encode_tokens vs plain, hidden 128 (a repeat at B=16384 bit-equal): max_abs_err {json.dumps(errs)} "
          f"(tolerance {TF_TOL})", flush=True)
    errs = {f"K={k} pool={pool} window={w}": check_tf_decode(dev, 4099, k, pool, w, seed=i)
            for i, (k, pool, w) in enumerate(((0, "none", 0), (4, "none", 0), (4, "mean", 0), (4, "none", 2)))}
    print(f"fused_ar_decode vs plain, hidden 128, L=2, 30+30 steps, B=4099 (with peers: a row with no valid peer, "
          f"equal to the peerless rollout, and a row with one): max_abs_err {json.dumps(errs)} (tolerance {TF_TOL})",
          flush=True)
    err = check_tf_decode(dev, 2053, 4, "none", 0, seed=5, t=100)
    print(f"fused_ar_decode per-row tier at the TPU streamed tier's shape (100+100 steps, K=4: 400 peer tokens, "
          f"window 0, B=2053): max_abs_err {err:.3e} (tolerance {TF_TOL})", flush=True)
    errs = {}
    for t, w in ((30, 2), (100, 8)):
        for pool, window, with_dv in (("none", 0, True), ("none", w, False), ("mean", 0, False), ("mean", w, True),
                                      ("none", w, True)):
            errs[f"{t}+{t} pool={pool} window={window} dv={with_dv}"] = check_tf_shared(
                dev, 2053 if t == 100 else 4099, t, pool, window, with_dv, seed=t + window)
    print(f"fused_ar_decode shared tier vs plain, hidden 128, L=2, K=4, G=3 groups (1 row, 37, the rest; gid "
          f"unsorted; one group with every peer masked, equal to the peerless rollout; without δv also against "
          f"the per-row kernel on gathered copies): max_abs_err {json.dumps(errs)} (tolerance {TF_TOL})", flush=True)
    # the f32 body's other block: 64 rows where the batch fills the SMs (the checks above run 32-row blocks)
    errs = {f"K={k} pool={pool} window={w}": check_tf_decode(dev, 8451, k, pool, w, seed=20 + i)
            for i, (k, pool, w) in enumerate(((0, "none", 0), (4, "none", 0), (4, "mean", 0), (4, "none", 2)))}
    for pool, window, with_dv in (("none", 2, True), ("mean", 0, True), ("none", 0, False)):
        errs[f"shared pool={pool} window={window} dv={with_dv}"] = check_tf_shared(dev, 8451, 30, pool, window,
                                                                                with_dv, seed=25 + window)
    rows = transformer_decode.decode_rows(8451, torch.cuda.get_device_properties(dev).multi_processor_count)
    print(f"fused_ar_decode f32 in blocks of {rows} rows "
          f"(B=8451, a ragged last block; B=4099 and 2053 above in blocks of 32), 30+30 steps, every tier, repeats "
          f"bit-equal: max_abs_err {json.dumps(errs)} (tolerance {TF_TOL})", flush=True)
    errs = {}
    for b, t, k, pool, w in ((16384, 30, 0, "none", 0), (4099, 30, 4, "none", 0), (4099, 30, 4, "mean", 0),
                             (4099, 30, 4, "none", 2), (2053, 100, 4, "none", 8)):
        errs[f"B={b} {t}+{t} K={k} pool={pool} window={w}"] = check_tf_bf16(dev, b, t, k, pool, w, seed=b + t + w)
    for b, t, pool, w in ((4099, 30, "none", 2), (4099, 30, "mean", 0), (2053, 100, "none", 8)):
        errs[f"shared B={b} {t}+{t} pool={pool} window={w} dv"] = check_tf_shared_bf16(dev, b, t, pool, w, seed=t + w)
    print(f"bf16 tiers of fused_encode_tokens and fused_ar_decode vs their bf16 plain versions (tolerance "
          f"{BF16_TOL}) and vs f32 plain (tolerance {BF16_F32_TOL}), hidden 128, L=2; the encoder at T <= 64, its "
          f"floor (least mean-gap ratio to the bf16 plain version's, from f32; limit {BF16C_FLOOR}) and a repeat "
          f"bit-equal; the shared tier over G=3 groups with δv: {json.dumps(errs)}", flush=True)
    errs = {f"B={b} D_in={d}": check_cell(dev, b, d, seed=b + d) for b in (16384, 16383) for d in (3, 128)}
    for b, d, hid, off in ((4099, 3, 40, True), (16383, 128, 100, False), (1000, 5, 272, True), (513, 3, 1024, False),
                           (77, 1024, 8, True)):
        geo = fused_lstm.cell_block(d, hid, False)
        errs[f"B={b} D_in={d} H={hid}{' offset' if off else ''} {geo.rows}x{geo.units} "
             f"{'W resident' if geo.w_res else 'W streamed'}"] = check_cell(dev, b, d, b + hid, hidden=hid, offset=off)
    print(f"fused_lstm_cell vs lstm_cell (three-pass TF32, lstm_mma::cell_step<Tf32Mma>; repeats bit-equal), hidden "
          f"128 and the widths the FMA design refused: max_abs_err {json.dumps(errs)} (tolerance {CELL_TOL})",
          flush=True)
    errs = {f"B=16383 L={l} C={c}": check_decode(dev, 16383, l, c, seed=l + c)
            for l in (1, 2) for c in (0, 128)}
    print(f"fused_decode vs plain, hidden 128, 30 steps: max_abs_err {json.dumps(errs)} (tolerance {KERNEL_TOL})",
          flush=True)
    errs = {}
    for rows in (0, 32):  # the f32 bodies' blocks: the choosers' (64 rows) and 32-row ones
        label = "32-row blocks" if rows else "chosen blocks"
        with f32_rows(rows) if rows else contextlib.nullcontext():
            for b, l, c in ((4099, 1, 0), (4099, 2, 128), (4099, 1, 12)):
                errs[f"fused_serve B={b} L={l} C={c} {label}"] = check_serve(dev, b, l, c, seed=l + c + rows,
                                                                             repeat=True)
            for name, r in check_peer_serve(dev, 2053, 2, 7, seed=9 + rows, repeat=True).items():
                errs[f"{name} B=2053 L=2 K=7 {label}"] = r
            errs[f"fused_decode B=4099 L=2 C=128 {label}"] = check_decode(dev, 4099, 2, 128, seed=3 + rows,
                                                                          repeat=True)
    print(f"f32 tier on three-pass TF32 (the serve kernel at C = 0, 128 and 12, the last padded to a k8 step; "
          f"fused_decode; the lockstep tier over 100+100 steps with its peer context) in the choosers' 64-row "
          f"blocks and in 32-row ones, ragged batches, every repeat and every permuted batch bit-equal: max_abs_err "
          f"{json.dumps(errs)} (tolerance: outputs {KERNEL_TOL}, peer_context {ENC_TOL})", flush=True)
    errs = {}
    for b, l, c in ((4099, 1, 0), (16384, 1, 0), (4099, 2, 128), (4099, 2, 64)):
        errs[f"fused_serve B={b} L={l} C={c}"] = check_serve(dev, b, l, c, seed=l, cd=BF)
    for b, l in ((4 * 4099, 1), (4099, 2)):
        errs[f"fused_encode B={b} L={l}"] = check_encode(dev, b, l, seed=l, cd=BF)
    for b, l, k in ((4099, 2, 7), (4099, 1, 3), (1792, 2, 16)):
        for name, r in check_peer_serve(dev, b, l, k, seed=l + k, cd=BF).items():
            errs[f"{name} B={b} L={l} K={k}"] = r
    for b, d in ((16384, 3), (16383, 128)):
        errs[f"fused_lstm_cell B={b} D_in={d}"] = check_cell(dev, b, d, seed=b + d, cd=BF)
    with serve_rows(16):  # the serve kernel's 16-row tiles (MT = 1), W resident and streamed
        for b, l, c in ((4099, 1, 0), (4099, 2, 128)):
            errs[f"fused_serve B={b} L={l} C={c} 16-row blocks"] = check_serve(dev, b, l, c, seed=l + 2, cd=BF)
        errs["fused_serve_peers B=4099 L=2 K=7 16-row blocks"] = check_peer_serve(
            dev, 4099, 2, 7, seed=11, cd=BF)["fused_serve_peers"]
    kinds = ("serve", "encode", "ctx", "cell")
    print(f"bf16 tiers of fused_serve (30+30 steps; static context C=128 and 64; the lockstep tier 100+100, C=128, "
          f"a row with every peer masked), fused_encode (T=30; the crossuser peer rows, 4·B) and fused_lstm_cell "
          f"(bf16 tensors), hidden 128, the largest gap to their bf16 and f32 plain versions (absolute) and the "
          f"least floor ratio: {json.dumps(errs)} (limits: bf16 "
          f"{json.dumps({k: BF16C_TIGHT[k] for k in kinds})}, f32 {json.dumps({k: BF16C_CONTRACT[k] for k in kinds})},"
          f" one bf16 step more on a value stored in bf16; floor {BF16C_FLOOR})", flush=True)
    errs = {f"B={b} T={t} L={l}": check_encode_train(dev, b, t, l, seed=i, repeat=i == 0)
            for i, (b, t, l) in enumerate(((TRAIN_B, 30, 2), (4099, 30, 2), (4099, 13, 2), (1001, 64, 1), (65, 1, 2),
                                           (21, 30, 8)))}
    print(f"fused_encode_train kernels vs plain, hidden 128 (forward and stash vs plain {TF_TOL}; every gradient "
          f"vs autograd through _encode {GRAD_TOL}·max(|g|, 1); the reduction equal to the block-order sum; two runs "
          f"at B={TRAIN_B} bit-equal): {json.dumps(errs)}", flush=True)


# --------------------------------------------------------------- phase 4: seq2seq-tf-30 serving


def serve_batched(cfg, fam, dev, params, requests, bulk, impl="fused", max_batch=1024):
    """Concurrent single requests ({"past", extras}) and one bulk request
    through a DynamicBatcher in front of the serve program (``impl``) →
    (answers in row order, the batcher's stats, the serve program)."""
    serve_fn = serving.make_serve_fn(params, cfg, fam, device=dev, impl=impl)
    bat = serving.DynamicBatcher(serve_fn, h_in=cfg.model.h_in, extra_specs=serving.extra_specs_for(cfg),
                                 required=serving.required_extras_for(cfg), max_batch=max_batch,
                                 max_wait_ms=5.0)
    try:
        with ThreadPoolExecutor(max_workers=64) as pool:
            futs = [pool.submit(lambda r=r: bat.predict(r["past"], **{k: v for k, v in r.items()
                                                                     if k != "past"}))
                    for r in requests]
            chunks = bat.submit_many(bulk["past"], **{k: v for k, v in bulk.items() if k != "past"})
            single_res = [f.result() for f in futs]
        for c in chunks:
            if not c.event.wait(60) or c.error is not None:
                raise AssertionError(f"bulk chunk failed: {c.error}")
        stats = bat.stats()
    finally:
        bat.stop()
    got = {
        key: np.concatenate([np.stack([r[key] for r in single_res])] + [c.result[key] for c in chunks])
        for key in ("yaw", "pitch", "prefetch")
    }
    if not all(np.isfinite(got[k]).all() for k in ("yaw", "pitch")):
        raise AssertionError("non-finite answers")
    return got, stats, serve_fn


def to_xyz(got):
    yaw, pitch = got["yaw"], got["pitch"]
    return np.stack([np.cos(pitch) * np.cos(yaw), np.cos(pitch) * np.sin(yaw), np.sin(pitch)], -1)


def drive_s2s_serving(cfg, fam, dev, params_np, params):
    """64 concurrent single-viewer requests and one bulk request; every
    answer must equal the direct batched call and the numpy oracle."""
    rng = np.random.default_rng(7)
    singles = unit_pasts(rng, 64, cfg.model.h_in)
    bulk = unit_pasts(rng, 1000, cfg.model.h_in)
    got, stats, serve_fn = serve_batched(cfg, fam, dev, params, [{"past": p} for p in singles],
                                         {"past": bulk})
    pasts = np.concatenate([singles, bulk])
    direct = serve_fn.unpack(serve_fn({"past": pasts}).cpu().numpy())
    d_direct = max(float(np.abs(got[k] - direct[k]).max()) for k in ("yaw", "pitch"))
    same_tiles = bool((got["prefetch"] == direct["prefetch"]).all())
    d_oracle = float(np.abs(to_xyz(got) - oracle.oracle_predict(params_np, cfg.model, pasts)).max())
    print(f"{S2S_SERVE}: {len(singles)} single + 1 bulk ({len(bulk)} rows) requests in "
          f"{stats['batches']} batches; max |yaw,pitch - direct| {d_direct:.3e}, prefetch equal "
          f"{same_tiles}; max |xyz - numpy oracle| {d_oracle:.3e} (tolerance {ORACLE_TOL})", flush=True)
    if d_direct > 1e-5 or not same_tiles:
        raise AssertionError("batched answers differ from the direct call")
    if not d_oracle <= ORACLE_TOL:
        raise AssertionError("answers disagree with the numpy oracle")


def serve_bench(preset, batches, smi):
    """serve-bench traj/s, fused against xla (the plain PyTorch path), at
    each (batch, iters)."""
    out = []
    for batch, iters in batches:
        for impl in ("fused", "xla"):
            r = cli.serve_bench(preset=preset, batch=batch, iters=iters, impl=impl, device="cuda:0")
            out.append({k: r[k] for k in ("impl", "batch", "iters", "peers", "ms_per_batch",
                                          "viewers_per_sec")})
    print(f"serve-bench {preset} (traj/s, with tile mask, CUDA events, {smi}): {json.dumps(out)}", flush=True)


def serve_call(cfg, params, dev, batch, tier=None, family=transformer):
    """One serve-bench call (normalize, kernels, denormalize, tile mask) on
    random unit-vector pasts and peer futures, as ``cli.serve_bench`` draws
    them; with ``tier``, ``family``'s serving in that compute dtype."""
    m, rng = cfg.model, np.random.default_rng(0)
    x = {"past": unit_rows(rng, dev, (batch, m.h_in)),
         "other_future": unit_rows(rng, dev, (batch, cfg.n_other_users, m.h_out))}
    if tier is None:
        serve = infer.make_predict_fn(params, cfg, device=dev, with_tiles=True, impl="fused")
        return lambda: serve(x)
    fam = tier_family(tier, family)

    @torch.inference_mode()
    def call():
        xyz = infer.predict_xyz(params, cfg, fam, x, impl="fused")
        return xyz, infer.tiles_for_fov(xyz)
    return call


def tier_family(tier, family=transformer):
    """``family`` with ``serve_fused``'s compute dtype pinned to ``tier``:
    the serving entry points (``make_serve_fn``, ``make_grouped_serve_fn``,
    ``predict_xyz``) call the family's ``serve_fused`` with no dtype, which
    is f32 for the LSTM families and resolves by device for the transformer
    (bf16 on the card)."""
    fam = types.SimpleNamespace(**{k: getattr(family, k) for k in ("init", "apply", "batch_extras")
                                   if hasattr(family, k)})
    fam.serve_fused = functools.partial(family.serve_fused, compute_dtype=tier)
    return fam


def serve_flop(batch, t_in, t_out, enc_ins, dec_ins, hidden, d):
    return (stack_flop(batch, t_in, enc_ins, hidden) + stack_flop(batch, t_out, dec_ins, hidden)
            + 2 * batch * t_out * hidden * d)


def serve_work(flop, feedback_macs, cd):
    """A serve kernel's work for bound(): in f32 its gate products in
    three-pass TF32 at 495 / 3 TFLOP/s beside its feedback y = h·proj_w
    (``feedback_macs`` MACs) on the FMA units; in bf16 all of it at the bf16
    tensor-core peak, as row 1b's bound was first stated."""
    if cd == BF:
        return {BF16_FLOPS: flop}
    return {TF32X3_FLOPS: flop - 2 * feedback_macs, F32_FLOPS: 2 * feedback_macs}


def tier_reads(params, cd):
    """A stack's weights as the ``cd`` tier's kernels read them: W (and
    proj_w) in ``cd``, biases f32."""
    return [t.to(cd) if t.dim() == 2 else t.float() for t in params]


def time_serve_kernel(name, dev, params, cfg, batch, iters, ctx_dim, smi, keep=True, cd=F32):
    """One serve kernel alone in the compute type ``cd`` against its plain
    version at a main-path batch: checked on these inputs first
    (:func:`check_outputs`), then timed in turns (the bf16 tier beside its
    f32 twin); ``keep``: its numbers go to the kernels line. No single
    PyTorch call computes an autoregressive decode with feedback: no library
    time."""
    rng = np.random.default_rng(1)
    x_n = windows.normalize_window(unit_rows(rng, dev, (batch, cfg.model.h_in)))[0]
    x_n = x_n.contiguous()
    ctx = randn(rng, dev, (batch, ctx_dim)) if ctx_dim else None
    args = (params["encoder"], params["decoder"], params["proj"]["w"], params["proj"]["b"], x_n, cfg.model.h_out)
    out = fused_lstm.fused_serve(*args, context=ctx, compute_dtype=cd)
    err = check_outputs(name, [out],
                        plains(cd, lambda c: [fused_lstm.fused_serve_reference(*args, ctx, compute_dtype=c)]),
                        f"B={batch}", "serve", cd)
    fns = {"plain": lambda: fused_lstm.fused_serve_reference(*args, ctx, compute_dtype=cd),
           "kernel": lambda: fused_lstm.fused_serve(*args, context=ctx, compute_dtype=cd)}
    if cd == BF:
        fns["f32_kernel"] = lambda: fused_lstm.fused_serve(*args, context=ctx)
    ms = in_turns(fns, {"plain": max(1, iters // 3), "kernel": iters, "f32_kernel": iters})
    ps = params["encoder"] + params["decoder"]
    m = cfg.model
    flop = serve_flop(batch, m.h_in, m.h_out, [m.d] + [m.hidden] * (m.layers - 1),
                      [m.d + ctx_dim] + [m.hidden] * (m.layers - 1), m.hidden, m.d)
    reads = [x_n, ctx] + tier_reads([params["proj"]["w"], params["proj"]["b"]] + [t for p in ps for t in p], cd)
    work = serve_work(flop, batch * m.h_out * m.hidden * m.d, cd)
    b_ms, b_by = bound(work, reads, [out])
    t = {"ms": ms["kernel"], "plain_ms": ms["plain"], "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    name += "_bf16" if cd == BF else ""
    if keep:
        TIMES[name] = t
    print(f"{name} alone (B={batch}, L={m.layers}, C={ctx_dim}, {str(cd)[6:]}; ms, CUDA events, {smi}): "
          f"{json.dumps(ms)}; bound {b_ms:.3f} ms by {b_by}; vs plain {json.dumps(err)}", flush=True)
    if keep or cd == F32:
        report_redesign(name, smi, t=t, before=name if keep else f"{name} C={ctx_dim}",
                        no_library="none (AR decode with feedback)", fma_bound=bound(flop, reads, [out])[0],
                        extra=f"; B={batch}, L={m.layers}, C={ctx_dim}" + (
                            f"; its f32 twin {ms['f32_kernel']:.4f} ms" if cd == BF else ""))


# --------------------------------------------------------------- phase 4b: the cell and decode kernels


def cell_cfg():
    """seq2seq-tf-30 with the JAX model field cell="pallas": the step loops on
    the one-step cell kernel."""
    return get_preset(PRESET, model_cell="pallas")


def drive_cell_serving(dev, params_np, params, batch):
    """Path (a): cell="pallas" served by make_serve_fn(impl="plain") behind a
    DynamicBatcher (max_batch = ``batch``): 64 single requests and one bulk
    request of the rest; every answer against the cell="xla" plain path on
    the card and the numpy oracle (unit xyz) → the path's launches."""
    cfg, xla = cell_cfg(), get_preset(PRESET)
    fam = get_family(cfg.model_family)
    rng = np.random.default_rng(9)
    pasts = unit_pasts(rng, batch, cfg.model.h_in)
    (got, stats, _), launches = drive(S2S_CELL, lambda: serve_batched(
        cfg, fam, dev, params, [{"past": p} for p in pasts[:64]], {"past": pasts[64:]}, impl="plain",
        max_batch=batch))
    plain_fn = serving.make_serve_fn(params, xla, fam, device=dev, impl="plain")
    plain = plain_fn.unpack(plain_fn({"past": pasts}).cpu().numpy())
    d_plain = float(np.abs(to_xyz(got) - to_xyz(plain)).max())
    d_oracle = float(np.abs(to_xyz(got) - oracle.oracle_predict(params_np, cfg.model, pasts)).max())
    per_call = launches["fused_lstm_cell"] / stats["batches"]
    print(f"{S2S_CELL}: 64 single + 1 bulk ({batch - 64} rows) requests in {stats['batches']} batches, "
          f"{per_call:.1f} fused_lstm_cell launches a call (30 + 30 steps, 1 layer: 60); max |xyz - cell=xla plain "
          f"path| {d_plain:.3e}, max |xyz - numpy oracle| {d_oracle:.3e} (tolerance {ORACLE_TOL})", flush=True)
    if not (d_plain <= ORACLE_TOL and d_oracle <= ORACLE_TOL and per_call == 60):
        raise AssertionError("the cell=pallas serving path disagrees with the plain path or the oracle")
    return launches


def decode_fused_path(params, cfg):
    """Path (b), as scripts/tpu_sweep.py serves it: normalize →
    seq2seq.decode_fused → denormalize, raw xyz pasts → xyz."""
    @torch.inference_mode()
    def call(past):
        past_n, _, anchor = windows.normalize_window(past)
        return windows.denormalize_window(seq2seq.decode_fused(params, cfg.model, past_n.contiguous()), anchor,
                                          to_sphere=True)
    return call


def drive_decode_fused(dev, params_np, params):
    """Path (b) at B = 16384 (the main path, launches counted) and 262,144:
    decode_fused on the cell kernel against serve_fused (the fused_serve
    kernel), the cell="xla" plain path, and at 16384 the numpy oracle."""
    cfg, xla = cell_cfg(), get_preset(PRESET)
    path = decode_fused_path(params, cfg)
    rng = np.random.default_rng(10)
    out = {}
    launches = None
    for batch in (16384, 262144):
        past = unit_rows(rng, dev, (batch, cfg.model.h_in))
        if launches is None:
            got, launches = drive(S2S_DECODE, lambda: path(past), also=["fused_lstm_cell"])
        else:
            got = path(past)
        fused = infer.make_predict_fn(params, xla, device=dev, impl="fused")(past)
        plain = infer.make_predict_fn(params, xla, device=dev, impl="plain")(past)
        gaps = {"vs_serve_fused": (got - fused).abs().max().item(), "vs_xla_plain": (got - plain).abs().max().item()}
        if batch == 16384:
            gaps["vs_oracle"] = float(np.abs(got.cpu().numpy() - oracle.oracle_predict(
                params_np, cfg.model, past.cpu().numpy())).max())
        out[f"B={batch}"] = gaps
    print(f"{S2S_DECODE}: normalize → decode_fused (cell=pallas encoder, one fused_decode) → denormalize, max |xyz "
          f"gap| {json.dumps(out)} (tolerance {ORACLE_TOL}); launches at B=16384 {json.dumps(launches)} "
          f"(30 fused_lstm_cell, 1 fused_decode)", flush=True)
    if not all(v <= ORACLE_TOL for g in out.values() for v in g.values()):
        raise AssertionError("decode_fused disagrees with serve_fused, the plain path or the oracle")
    if launches != {"fused_decode": 1, "fused_lstm_cell": 30}:
        raise AssertionError(f"decode_fused launched {launches}, not 30 cells and 1 decode")
    return launches


def time_cell_paths(dev, params, smi):
    """Both paths against the cell="xla" plain path and fused_serve, serve
    calls on device tensors in turns at B = 16384 and 262,144; then the cell
    kernel alone against lstm_cell and torch.lstm_cell (W split into w_ih
    and w_hh: the library yardstick, which the port never calls) at the main
    path's shapes, and fused_decode alone against its plain version."""
    cfg, xla = cell_cfg(), get_preset(PRESET)
    rng = np.random.default_rng(11)
    for batch, iters in ((16384, {"cell=pallas plain": 3, "cell=xla plain": 3, "decode_fused": 5,
                                  "serve_fused": 5}),
                         (262144, {"cell=pallas plain": 1, "cell=xla plain": 1, "decode_fused": 2,
                                   "serve_fused": 2})):
        past = unit_rows(rng, dev, (batch, cfg.model.h_in))
        fns = {"cell=pallas plain": infer.make_predict_fn(params, cfg, device=dev, impl="plain"),
               "cell=xla plain": infer.make_predict_fn(params, xla, device=dev, impl="plain"),
               "decode_fused": decode_fused_path(params, cfg),
               "serve_fused": infer.make_predict_fn(params, xla, device=dev, impl="fused")}
        ms = in_turns({k: (lambda f=f: f(past)) for k, f in fns.items()}, iters)
        print(f"{S2S_CELL} / {S2S_DECODE}: serve call at B={batch} (ms, CUDA events, {smi}): {json.dumps(ms)}, "
              f"traj/s {json.dumps({k: batch * 1e3 / v for k, v in ms.items()})}", flush=True)
    for d_in, keep in ((3, True), (128, False)):
        time_cell_kernel(dev, smi, d_in, keep)
    time_cell_kernel(dev, smi, 3, False, batch=262144)
    batch, t_out = 262144, 30
    dec = stack(rng, dev, 3, 1)
    pw, pb = randn(rng, dev, (128, 3), 0.1), randn(rng, dev, (3,), 0.1)
    h0, c0 = randn(rng, dev, (1, batch, 128), 0.3), randn(rng, dev, (1, batch, 128), 0.3)
    y0 = randn(rng, dev, (batch, 3), 0.1)
    args = (dec, pw, pb, h0, c0, y0, t_out)
    out = fused_lstm.fused_decode(*args)
    err = (out - fused_lstm.fused_decode_reference(*args)).abs().max().item()
    if not err <= KERNEL_TOL:
        raise AssertionError(f"fused_decode at B={batch} disagrees with its plain version: {err:.3e}")
    note_err("fused_decode", err)
    ms = in_turns({"plain": lambda: fused_lstm.fused_decode_reference(*args),
                   "kernel": lambda: fused_lstm.fused_decode(*args)}, {"plain": 1, "kernel": 3})
    flop = stack_flop(batch, t_out, [3], 128) + 2 * batch * t_out * 128 * 3
    reads = [h0, c0, y0, pw, pb] + [t for p in dec for t in p]
    record("fused_decode", ms, serve_work(flop, batch * t_out * 128 * 3, F32), reads, [out])
    t = TIMES["fused_decode"]
    print(f"fused_decode alone (B={batch}, L=1, {t_out} steps; ms, CUDA events, {smi}): {json.dumps(ms)}; bound "
          f"{t['bound_ms']:.3f} ms by {t['bound_by']}; max_abs_err vs plain {err:.3e} (tolerance {KERNEL_TOL}); "
          f"library: none (AR decode with feedback)", flush=True)
    report_redesign("fused_decode", smi, no_library="none (AR decode with feedback)",
                    fma_bound=bound(flop, reads, [out])[0], extra=f"; B={batch}, L=1, {t_out} steps from given states")


def time_cell_kernel(dev, smi, d_in, keep, cd=F32, batch=16384):
    """The cell kernel alone on ``cd`` tensors (bf16: a --bf16 model's)
    against lstm_cell on the same tensors (its plain version; in bf16 beside
    the f32 kernel on their widening) and torch.lstm_cell (W split into w_ih
    and w_hh: the library yardstick, which the port never calls; in bf16
    cuBLAS rounds the gates to bf16 before the cell update, another
    function), in turns at the main path's shape; then beside its FMA
    design's time (BEFORE) with its bound (f32: the products in three-pass
    TF32, beside the FMA units' bound), its device time and the library's
    (torch.profiler) and the host's time a call; ``keep``: its numbers go to
    the kernels line."""
    rng = np.random.default_rng(12 + d_in)
    (p,) = stack(rng, dev, d_in, 1)
    x, h, c = randn(rng, dev, (batch, d_in)), randn(rng, dev, (batch, 128), 0.5), randn(rng, dev, (batch, 128), 0.5)
    p, x, h, c = LSTMParams(p.w.to(cd), p.b.to(cd)), x.to(cd), h.to(cd), c.to(cd)
    w_ih, w_hh = p.w[:d_in].t().contiguous(), p.w[d_in:].t().contiguous()
    b_hh = torch.zeros_like(p.b)
    got = fused_lstm.fused_lstm_cell(p, x, (h, c))
    lib_err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, torch.lstm_cell(x, [h, c], w_ih, w_hh, p.b, b_hh)))

    def plain(c_):
        return list(lstm_cell(LSTMParams(*(t.to(c_) for t in p)), x.to(c_), (h.to(c_), c.to(c_))))
    err = check_outputs("fused_lstm_cell", list(got), plains(cd, plain), f"B={batch}, D_in={d_in}", "cell", cd)
    fns = {"plain": lambda: lstm_cell(p, x, (h, c)), "kernel": lambda: fused_lstm.fused_lstm_cell(p, x, (h, c)),
           "library": lambda: torch.lstm_cell(x, [h, c], w_ih, w_hh, p.b, b_hh)}
    if cd == BF:
        p32, x32, h32, c32 = LSTMParams(p.w.float(), p.b.float()), x.float(), h.float(), c.float()
        fns["f32_kernel"] = lambda: fused_lstm.fused_lstm_cell(p32, x32, (h32, c32))
    ms = in_turns(fns, dict.fromkeys(fns, 20 if batch <= 16384 else 3))
    flop = stack_flop(batch, 1, [d_in], 128)
    reads, writes = [x, h, c, p.w, p.b], list(got)
    work = {TF32X3_FLOPS: flop} if cd == F32 else {BF16_FLOPS: flop}
    b_ms, b_by = bound(work, reads, writes)
    name = "fused_lstm_cell" + ("_bf16" if cd == BF else "")
    if keep:
        record(name, ms, work, reads, writes)
    print(f"{name} alone (B={batch}, D_in={d_in}, H=128; ms, CUDA events, {smi}): {json.dumps(ms)}; "
          f"bound {b_ms:.4f} ms by {b_by}; vs plain {json.dumps(err)}, vs torch.lstm_cell {lib_err:.3e}", flush=True)
    # on the tensor cores: beside its FMA design, its device and host time a call
    host = {}
    for w in ("kernel", "library"):
        fns[w]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fns[w]()
        host[w] = (time.perf_counter() - t0) / 100 * 1e3
        torch.cuda.synchronize()
    kernel_ms, records = launch_device_ms(fns["kernel"], "lstm_cell_kernel", 20)
    before = f"{name} B={batch}" if batch != 16384 else name if d_in == 3 else f"{name} D_in={d_in}"
    report_redesign(name, smi, {"ms": ms["kernel"], "library_ms": ms["library"], "bound_ms": b_ms,
                                "bound_by": b_by}, before=before,
                    fma_bound=bound(flop, reads, writes)[0] if cd == F32 else None,
                    device={"kernel": kernel_ms, "library": device_ms(fns["library"], 20)},
                    extra=f" (the kernel: the mean of {records} of 20 launches' records); B={batch}, D_in={d_in}; "
                          f"block {tuple(fused_lstm.cell_block(d_in, 128, cd == BF))}; host time a call (ms, 100 "
                          f"calls enqueued): {json.dumps(host)}")


# --------------------------------------------------------------- training paths


def synthetic_windows(cfg):
    """The CLI's synthetic store (8 users, 2 videos, 1200 frames) → (train,
    test) windows, with K peer futures for the families that take peers."""
    store = traces.synthetic_store(n_users=8, n_videos=2, n_frames=1200, rate_hz=cfg.rate_hz, seed=cfg.seed)
    k = cfg.n_other_users if cfg.model_family in ("cross_user", "transformer") else 0
    return data.windows_from_store(store, cfg.model.h_in, cfg.model.h_out, stride=cfg.stride, n_other_users=k)


def drive_training(cfg, path, dev, also, step_tol=STEP_REL_TOL, windows_=None, step_check=True, resume_tol=1e-6):
    """train_loop through the kernels with evaluation and checkpoints, then
    a resume from the middle checkpoint, which must equal the uninterrupted
    run (the scheduled-sampling coins are drawn from (seed, step), so they
    are equal too); then one step through the kernels against one through
    plain autograd, from the trained state on a fresh batch with the same
    coins, within ``step_tol`` per residual dtype. ``also``: the kernels of
    other rows the path must launch (its evaluation's serving kernels, the
    encoder's); ``windows_`` (train, test), else the synthetic store's;
    ``step_check=False`` for the transformer, whose step is checked by
    tf_grad_check; ``resume_tol`` the largest |params - uninterrupted|
    after the resume (0: bit-equal)."""
    fam = get_family(cfg.model_family)
    train_d, test_d = windows_ or synthetic_windows(cfg)
    run = dict(device=dev, eval_data=test_d, **family_fns(fam))
    init = train.init_state(cfg, fam.init, train.make_optimizer(cfg), device=dev)
    with tempfile.TemporaryDirectory() as ck_dir:
        (full, hist), launches = drive(path, lambda: train.train_loop(
            cfg, fam.init, fam.apply, train_d, checkpoint_dir=ck_dir, **run), also)
        print(f"{path}: {len(train_d['past'])} train / {len(test_d['past'])} test windows, "
              f"B={cfg.batch_size}, {cfg.steps} steps; logged "
              f"{json.dumps([{k: m[k] for k in ('step', 'loss', 'teacher_prob', 'eval_great_circle_deg')} for m in hist])}",
              flush=True)
        losses = [m["loss"] for m in hist]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"non-finite training loss: {losses}")
        if cfg.scheduled_sampling:
            # the logged losses are taken at falling teacher_prob, so they
            # need not fall: compare the loss before and after training on
            # one batch with the coins of the last step
            if not hist[-1]["teacher_prob"] < 1.0:
                raise AssertionError("teacher_prob never fell below 1")
            last = cfg.steps - 1
            batch = next(train.batch_iterator(train_d, cfg.batch_size, seed=3))
            grad_fn = train.make_grad_fn(cfg, fam.apply, gc_metric=False, **family_fns(fam))
            before, after = (grad_fn(p, batch, train.step_generator(cfg, last, dev),
                                     train.teacher_prob_at(cfg, last))[0][0].item()
                             for p in (init.params, full.params))
            print(f"{path}: loss on one batch at the last step's coins (teacher_prob "
                  f"{train.teacher_prob_at(cfg, last):.3f}): {before:.5f} at init, {after:.5f} trained",
                  flush=True)
            if not after < before:
                raise AssertionError(f"the training loss did not fall: {before} -> {after}")
        elif not losses[-1] < losses[0]:
            raise AssertionError(f"the training loss did not fall: {losses}")
        ck = checkpoint.Checkpointer(ck_dir, cfg)
        mid = ck.all_steps()[0]
        restored = ck.restore(train.init_state(cfg, fam.init, train.make_optimizer(cfg), device=dev), step=mid)
        resumed, _ = train.train_loop(cfg, fam.init, fam.apply, train_d, state=restored, **run)
    d_resume = max((a - b).abs().max().item() for a, b in zip(tree_leaves(full.params), tree_leaves(resumed.params)))
    print(f"{path}: resume from the checkpoint at step {mid} to step {resumed.step}; max |params - "
          f"uninterrupted| {d_resume:.3e} (tolerance {resume_tol})", flush=True)
    if resumed.step != cfg.steps or not d_resume <= resume_tol:
        raise AssertionError("the resumed run differs from the uninterrupted one")
    if not step_check:
        return full, train_d, launches

    # one step, kernels against plain autograd ("xla"), same coins: loss
    # and gradients (step_tol), then the params after the update
    batch = next(train.batch_iterator(train_d, cfg.batch_size, seed=1))
    plain = cfg.replace(train_impl="xla")
    mid_step = cfg.steps // 2  # coins of a step where teacher and model inputs mix
    tp = train.teacher_prob_at(cfg, mid_step)

    def gen():
        return train.step_generator(cfg, mid_step, dev) if cfg.scheduled_sampling else None

    extras = family_fns(fam)["extras_fn"]
    (l_p, _), g_p = train.make_grad_fn(plain, fam.apply, extras_fn=extras)(full.params, batch, gen(), tp)
    res_one = {}
    for rd in (torch.float32, torch.bfloat16):
        rel = step_tol[str(rd)[6:]]
        (l_k, _), g_k = train.make_grad_fn(cfg, fam.apply, **family_fns(fam, residual_dtype=rd))(
            full.params, batch, gen(), tp)
        # a leaf the loss does not reach (video-fusion's conv stack in the
        # features mode) has a zero gradient on both sides: its error counts absolute
        g_err = max((a - b).abs().max().item() / (b.abs().max().item() or 1.0)
                    for a, b in zip(tree_leaves(g_k), tree_leaves(g_p)))
        l_err = abs(l_k.item() - l_p.item()) / abs(l_p.item())
        if not (g_err <= rel and l_err <= rel):
            raise AssertionError(f"train step through the kernels ({rd}) differs from plain: "
                                 f"loss {l_err:.2e}, grads {g_err:.2e} (tolerance {rel})")
        res_one[str(rd)[6:]] = {"loss_rel": l_err, "grad_rel": g_err}
    opt = train.make_optimizer(cfg)
    k_state, _ = train.make_train_step(cfg, fam.apply, opt, **family_fns(fam))(full, batch)
    p_state, _ = train.make_train_step(plain, fam.apply, opt, extras_fn=extras)(full, batch)
    d_param = max((a - b).abs().max().item()
                  for a, b in zip(tree_leaves(k_state.params), tree_leaves(p_state.params)))
    print(f"{path}: one step at teacher_prob {tp:.3f}, kernels vs plain autograd: {json.dumps(res_one)}; "
          f"max |params after, bf16 residuals - plain| {d_param:.3e} (tolerance 0.1·lr = "
          f"{0.1 * cfg.lr:.0e})", flush=True)
    if not d_param <= 0.1 * cfg.lr:
        raise AssertionError("params after one step through the kernels differ from plain")
    return full, train_d, launches


WIDE_STEPS = ((256, 2), (128, 8))  # (hidden, layers): the widest and the deepest the backward takes
WIDE_ROWS = 64  # windows a step, two forward blocks: the references of the rounded tiers run on the CPU
# the rounded tiers' step through the kernels against the CPU port's (the
# same rounding points), loss and gradients relative to max|reference| per
# leaf, by (compute, residuals): above the largest sound reading and under
# the gap that the step of the other residual type (and, in f32 compute, of
# bf16 compute: a kernel rounding where it should not, or not where it
# should) shows against the same reference: on an H100 the readings were
# at most 4.4e-5 / 1.3e-3 / 1.6e-3, those controls at least 3.9e-3 /
# 1.0e-2 / 1.0e-2 (PERF.md §6, the training forwards)
WIDE_PORT_TOL = {("float32", "bfloat16"): 4e-4, ("bfloat16", "float32"): 5e-3, ("bfloat16", "bfloat16"): 5e-3}


def check_wide_steps(dev, smi):
    """Phase 9b: one train step at hidden 256 (2 layers) and at 8 layers of
    hidden 128, of both crossuser presets (the encoder and the peer encoders
    on lstm_seq_states, the decoder on ss_decode or aligned_ss_decode) under
    train_impl "auto", every forward and backward on the kernels (their
    launches counted), in both compute types and residual types, with the
    same coins (drawn from numpy, teacher_prob 0.5) on WIDE_ROWS windows.
    Loss and gradients relative to max|reference| per leaf: f32 and bf16
    compute on f32 residuals against plain autograd on the card within
    STEP_REL_TOL (ALIGN_STEP_REL_TOL for the lockstep decoder) of their
    compute type; every rounded tier (bf16 residuals, bf16 compute) against
    the CPU port's step, the kernels' plain versions under the same autograd
    functions with the same rounding points, within WIDE_PORT_TOL of its
    tier, beside its controls: the steps of the tiers that differ from it
    in one of the two types, against its reference, of which the other
    residual type's (and in f32 compute bf16 compute's) must lie above the
    limit. Readings are printed before any is held. Each one's gap to plain
    autograd is reported too (bf16 residuals round every layer's h, c and
    gates: the gap grows with depth). Then one make_train_step update,
    finite."""
    draw = seq2seq.draw_coins
    out = {}

    def gaps(a, b):
        (l_a, _), g_a = a
        (l_b, _), g_b = b
        return (abs(l_a.item() - l_b.item()) / abs(l_b.item()),
                max((x.cpu() - y.cpu()).abs().max().item() / (y.abs().max().item() or 1.0)
                    for x, y in zip(tree_leaves(g_a), tree_leaves(g_b))))

    tiers = [(tc, rd) for tc in ("float32", "bfloat16") for rd in (F32, BF)]
    checks, controls = [], []
    try:
        for preset, tol, dec in ((CU_PRESET, STEP_REL_TOL, "ss_decode"), (CU10_PRESET, ALIGN_STEP_REL_TOL,
                                                                          "aligned_dec")):
            for hidden, layers in WIDE_STEPS:
                base = get_preset(preset, batch_size=WIDE_ROWS, steps=2)
                cfg = base.replace(model=dataclasses.replace(base.model, hidden=hidden, layers=layers))
                fam = get_family(cfg.model_family)
                batch = next(train.batch_iterator(synthetic_windows(cfg)[0], WIDE_ROWS, seed=5))
                coins = torch.from_numpy((np.random.default_rng(hidden + layers).random(
                    (cfg.model.h_out, WIDE_ROWS, 1)) < 0.5).astype(np.float32))
                seq2seq.draw_coins = lambda gen, p, t, b, coins=coins: coins.to(gen.device)
                state = train.init_state(cfg, fam.init, train.make_optimizer(cfg), device=dev)
                cpu = tree_unflatten(state.params, [p.cpu() for p in tree_leaves(state.params)])
                plain = train.make_grad_fn(cfg.replace(train_impl="xla"), fam.apply, gc_metric=False,
                                           extras_fn=family_fns(fam)["extras_fn"])(
                    state.params, batch, torch.Generator(device=dev), 0.5)
                got, ref, launches = {}, {}, {}
                for tc, rd in tiers:
                    c = cfg.replace(train_compute=tc)
                    sfx = "_bf16" if tc == "bfloat16" else ""
                    names = [f"lstm_seq_states_fwd{sfx}", f"lstm_seq_states_bwd{sfx}", f"{dec}_fwd{sfx}",
                             f"{dec}_bwd{sfx}"]
                    grad_fn = train.make_grad_fn(c, fam.apply, gc_metric=False, **family_fns(fam, residual_dtype=rd))
                    for wrapper in WRAPPERS.values():
                        wrapper.launches = 0
                    got[tc, rd] = grad_fn(state.params, batch, torch.Generator(device=dev), 0.5)
                    torch.cuda.synchronize()
                    launches[tc, rd] = {n: WRAPPERS[n].launches for n in names}
                    if not all(launches[tc, rd].values()):
                        raise AssertionError(f"{preset} H={hidden} L={layers} {tc}: a kernel of the step never "
                                             f"launched: {launches[tc, rd]}")
                    if (tc, rd) != ("float32", F32):
                        ref[tc, rd] = grad_fn(cpu, batch, torch.Generator(), 0.5)
                    if rd == F32:
                        new, _ = train.make_train_step(c, fam.apply, train.make_optimizer(c), gc_metric=False,
                                                       **family_fns(fam))(state, batch)
                        if not all(torch.isfinite(p).all() for p in tree_leaves(new.params)):
                            raise AssertionError(f"{preset} H={hidden} L={layers} {tc}: non-finite params after a "
                                                 f"step")
                for tc, rd in tiers:
                    tier = (tc, str(rd)[6:])
                    key = f"{preset} H={hidden} L={layers} {tc} compute, {tier[1]} residuals"
                    row = out[key] = {"to_plain_autograd": gaps(got[tc, rd], plain), "launches": launches[tc, rd]}
                    if rd == F32:  # unrounded residuals: plain autograd in the compute type's tolerance
                        checks.append((key, "plain autograd", row["to_plain_autograd"], tol[tc]))
                    if tier in WIDE_PORT_TOL:
                        lim = WIDE_PORT_TOL[tier]
                        row["to_the_cpu_port"] = gaps(got[tc, rd], ref[tc, rd])
                        row["limit"] = lim
                        row["controls"] = {f"{o_tc} compute, {str(o_rd)[6:]} residuals": gaps(got[o_tc, o_rd],
                                                                                              ref[tc, rd])[1]
                                           for o_tc, o_rd in tiers if (o_tc == tc) != (o_rd == rd)}
                        checks.append((key, "the CPU port", row["to_the_cpu_port"], lim))
                        # the controls the limit must tell apart: the other residual type, and in f32
                        # compute bf16 compute; bf16 compute's own gap to the port (rounding flips from
                        # another summation order) is as large as f32 compute's there
                        held = [f"{o_tc} compute, {str(o_rd)[6:]} residuals" for o_tc, o_rd in tiers
                                if (o_tc == tc) != (o_rd == rd) and (o_tc == tc or tc == "float32")]
                        controls.append((key, {k: row["controls"][k] for k in held}, lim))
    finally:
        seq2seq.draw_coins = draw
    print(f"one train step at hidden 256 (2 layers) and 8 layers (hidden 128), B={WIDE_ROWS}, through the kernels, "
          f"loss and gradients relative to max|reference| per leaf: to plain autograd (held to STEP_REL_TOL on f32 "
          f"residuals), to the CPU port's step (the rounded tiers, held to WIDE_PORT_TOL) and, for each, the "
          f"controls' gradient gaps to the same reference ({smi}): {json.dumps(out)}", flush=True)
    for key, what, (l_err, g_err), lim in checks:
        if not (l_err <= lim and g_err <= lim):
            raise AssertionError(f"{key}: the step through the kernels differs from {what}: loss {l_err:.2e}, grads "
                                 f"{g_err:.2e} (tolerance {lim})")
    for key, held, lim in controls:
        if not min(held.values()) > lim:
            raise AssertionError(f"{key}: a control is within the limit {lim}, which then cannot tell it apart: "
                                 f"{held}")


def time_training(cfg, state, train_d, path, smi, plain_iters, kernel_iters=20):
    """The fast train step (the loop's step between logged steps), kernels
    against plain autograd, in turns plain, kernel, kernel, plain."""
    fam = get_family(cfg.model_family)
    batch = next(train.batch_iterator(train_d, cfg.batch_size, seed=2))
    opt = train.make_optimizer(cfg)
    steps = {
        "plain": train.make_train_step(cfg.replace(train_impl="xla"), fam.apply, opt, gc_metric=False,
                                       extras_fn=family_fns(fam)["extras_fn"]),
        "kernel": train.make_train_step(cfg, fam.apply, opt, gc_metric=False, **family_fns(fam)),
    }
    st = {}

    def stepper(which):
        st[which] = state

        def one():
            st[which] = steps[which](st[which], batch)[0]
        return one

    ms = in_turns({w: stepper(w) for w in steps}, {"plain": plain_iters, "kernel": kernel_iters})
    out = {w: {"ms_per_step": ms[w], "steps_per_sec": 1e3 / ms[w],
               "windows_per_sec": cfg.batch_size * 1e3 / ms[w]} for w in ms}
    print(f"{path}: train step (B={cfg.batch_size}, fast step, CUDA events, {smi}): {json.dumps(out)}", flush=True)
    return stepper("kernel")


def drive_bf16_training(cfg, path, dev, also, smi, steps=6, rows=512, windows_=None, iters=10):
    """``train --train-compute bfloat16``: :func:`drive_training` of a short
    run (``steps``, an evaluation and a checkpoint every half, the resume
    bit-equal) with every bf16-compute kernel of ``path`` launched and
    counted apart from the f32 ones; one step's loss and gradients on the
    card against the CPU port's (:func:`bf16_step_check`, ``rows`` windows);
    the fast step against the f32 step, both through the kernels, in turns
    (``iters`` steps each), and a profile of the bf16 step → the path's
    launches."""
    bcfg = cfg.replace(train_compute="bfloat16", steps=steps, eval_every=steps // 2, ckpt_every=steps // 2)
    trained, train_d, launches = drive_training(bcfg, path, dev, also, windows_=windows_, step_check=False,
                                                resume_tol=0.0)
    bf16_step_check(bcfg, trained, train_d, path, rows)
    fam = get_family(cfg.model_family)
    batch = next(train.batch_iterator(train_d, cfg.batch_size, seed=2))
    opt = train.make_optimizer(bcfg)
    st = {}

    def stepper(tc):
        step = train.make_train_step(bcfg.replace(train_compute=tc), fam.apply, opt, gc_metric=False,
                                     **family_fns(fam))
        st[tc] = trained

        def one():
            st[tc] = step(st[tc], batch)[0]
        return one

    steps_ = {tc: stepper(tc) for tc in ("float32", "bfloat16")}
    ms = in_turns(steps_, {"float32": iters, "bfloat16": iters})
    print(f"{path}: train step (B={cfg.batch_size}, fast step, CUDA events, {smi}), through the kernels in "
          f"the f32 and the bf16 compute type: {json.dumps({tc: {'ms_per_step': v} for tc, v in ms.items()})}",
          flush=True)
    prof = profile_device(f"{path}: fast step", steps_["bfloat16"], max(2, iters // 2), smi)
    if any("align_peer_bwd_kernel" in name for name in prof[1]):
        peer_bwd_share(f"{path}: fast step", prof, smi)
    return launches


def bf16_step_check(cfg, state, train_d, path, rows, f32=None, floors=("loss", "grads")):
    """One step's loss and gradients under ``train_compute="bfloat16"`` (or
    of a --bf16 model) on ``rows`` windows at a mid-anneal teacher_prob, the
    same coins and transformer noise (drawn from numpy and swapped in for
    the generator's draws on both sides): the bf16 kernels on the card against the CPU port's bf16
    plain versions, and against the f32 step on the card (``f32``: its
    (cfg, params), by default ``train_compute="float32"`` on the same
    params): loss relative, gradients of max|g| per leaf, the first within
    BF16C_TIGHT, the second within BF16C_CONTRACT, and the card's gap to the
    f32 step at least BF16C_FLOOR of the CPU port's on ``floors``. The
    card's gradients have the CPU port's dtypes, leaf by leaf."""
    fam = get_family(cfg.model_family)
    batch = next(train.batch_iterator(train_d, rows, seed=4))
    tp = train.teacher_prob_at(cfg, cfg.steps // 2)
    coins = torch.from_numpy((np.random.default_rng(19).random((cfg.model.h_out, rows, 1)) < tp)
                             .astype(np.float32))
    noise = torch.from_numpy(np.random.default_rng(20).normal(size=(rows, cfg.model.h_out, 3)).astype(np.float32))
    draw, draw_noise = seq2seq.draw_coins, transformer.draw_noise
    seq2seq.draw_coins = lambda gen, p, t, b: coins.to(gen.device)
    transformer.draw_noise = lambda gen, shape: noise.to(gen.device)
    try:
        cpu = tree_unflatten(state.params, [p.cpu() for p in tree_leaves(state.params)])
        res = {}
        f32_cfg, f32_params = f32 or (cfg.replace(train_compute="float32"), state.params)
        for where, c, params in (("card", cfg, state.params), ("cpu", cfg, cpu), ("card_f32", f32_cfg, f32_params)):
            grad_fn = train.make_grad_fn(c, fam.apply, gc_metric=False, **family_fns(fam))
            res[where] = grad_fn(params, batch, torch.Generator(device=tree_leaves(params)[0].device), tp)
    finally:
        seq2seq.draw_coins, transformer.draw_noise = draw, draw_noise

    def gaps(x, y):
        (l_x, _), g_x = res[x]
        (l_y, _), g_y = res[y]
        return {"loss": abs(l_x.item() - l_y.item()) / abs(l_y.item()),
                "grads": max((a.cpu() - b.cpu()).abs().max().item() / (b.abs().max().item() or 1.0)
                             for a, b in zip(tree_leaves(g_x), tree_leaves(g_y)))}

    if [g.dtype for g in tree_leaves(res["card"][1])] != [g.dtype for g in tree_leaves(res["cpu"][1])]:
        raise AssertionError(f"{path}: the card's gradient dtypes differ from the CPU port's")
    out = {"cpu": gaps("card", "cpu"), "card_f32": gaps("card", "card_f32"), "cpu_to_f32": gaps("cpu", "card_f32")}
    print(f"{path}: one step (B={rows}, teacher_prob {tp:.3f}, the same coins), the bf16 kernels' step on the "
          f"card vs the CPU port's bf16 plain step and vs the f32 step on the card, and the CPU port's vs the f32 "
          f"step, loss relative, gradients relative to max|reference| per leaf: {json.dumps(out)} (limits: vs "
          f"the CPU port loss {BF16C_TIGHT['loss']}, gradients {BF16C_TIGHT['step']}; vs f32 loss "
          f"{BF16C_CONTRACT['loss']}, gradients {BF16C_CONTRACT['step']}; floor {BF16C_FLOOR} of the CPU "
          f"port's gap to f32)", flush=True)
    for key, lim in (("loss", "loss"), ("grads", "step")):
        floor = BF16C_FLOOR * out["cpu_to_f32"][key] if key in floors else 0.0
        if not (out["cpu"][key] <= BF16C_TIGHT[lim] and out["card_f32"][key] <= BF16C_CONTRACT[lim]
                and out["card_f32"][key] >= floor):
            raise AssertionError(f"{path}: the bf16 step's {key} through the kernels differs from its references")


def profile_device(label, fn, iters, smi):
    """Where the device time goes over ``iters`` calls of ``fn``: the CUDA
    kernels torch.profiler (CUPTI) records, summed by name, and the device's
    idle share of the host's wall time (1 - the union of kernel intervals
    over the wall time, which the profiler's own overhead inflates) →
    (device busy ms a call, {kernel name: ms a call})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    by_name, busy, reach = {}, 0.0, float("-inf")
    for start, end, name in spans:
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + (end - start) / 1e3 / iters
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12])
    print(f"{label}: profile over {iters} calls ({smi}): wall {wall_us / 1e3 / iters:.3f} ms per call, "
          f"device busy {busy / 1e3 / iters:.3f} ms, idle share {1 - busy / wall_us:.3f}, "
          f"{len(spans)} device events; ms per call by kernel {json.dumps(top)}", flush=True)
    return busy / 1e3 / iters, by_name


def device_ms(fn, iters):
    """The device time of one call of ``fn``: the CUDA kernels that
    torch.profiler (CUPTI) records over ``iters`` calls, summed, per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / iters


def launch_device_ms(fn, part, iters):
    """The device time of one launch of the kernel whose name holds
    ``part``, under ``fn``: the mean of torch.profiler's records of it over
    ``iters`` calls → (ms, records). A record CUPTI drops is left out of the
    mean, not counted as 0 (device_ms's sum over the calls would count it
    so), and the count says how many were kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and part in e.name]
    return (sum(spans) / len(spans) / 1e3 if spans else float("nan")), len(spans)


def peer_bwd_share(label, prof, smi):
    """The peer backward's share of a profiled 10 s train step's device busy
    time (``prof``: profile_device's)."""
    busy, by_name = prof
    peer = sum(ms for name, ms in by_name.items() if "align_peer_bwd_kernel" in name)
    print(f"{label}: device busy {busy:.3f} ms a step, the peer backward (align_peer_bwd_kernel) {peer:.3f} ms, "
          f"{peer / busy:.1%} of it ({smi})", flush=True)


def report_redesign(name, smi, t=None, io=None, before=None, fma_bound=None, device=None, extra="",
                    no_library="none (another function)"):
    """One redesigned kernel: this run's time (``t``, TIMES' keys; else
    TIMES[name]) beside its time before its design (BEFORE[``before`` or
    name], PERF.md), its bound (from ``io``, bound()'s (work, reads,
    writes), where given) and the bound's share of the time, its library
    call's time, the bound of the same work on the FMA units (``fma_bound``
    ms, or from ``io``: products that moved to the tensor cores), its device
    time and its library's (``device``, {"kernel", "library"}: ms a call
    from torch.profiler, beside the CUDA-event times, which hold the host's
    work too), and ``extra``; ``no_library`` says why a kernel has no
    library time."""
    t = dict(TIMES[name] if t is None else t)
    if io is not None:
        work, reads, writes = io
        t["bound_ms"], t["bound_by"] = bound(work, reads, writes)
        fma_bound = bound(flop_of(work), reads, writes)[0]
    lib = t.get("library_ms")
    lib = no_library if lib is None else f"{lib:.4f} ms ({lib / t['ms']:.2f}x the kernel's time)"
    prev = BEFORE.get(before or name)
    line = (f"{name}: {t['ms']:.4f} ms (before this design "
            + ("not measured" if prev is None else f"{prev} ms, PERF.md") + "), bound "
            f"{t['bound_ms']:.4f} ms by {t['bound_by']} ({t['bound_ms'] / t['ms']:.1%} of the time), library {lib}")
    if fma_bound is not None:
        line += f", on the FMA units {fma_bound:.3f} ms"
    if device is not None:
        line += (f"; device time a call (torch.profiler): kernel {device['kernel']:.4f} ms, library "
                 f"{device['library']:.4f} ms")
    print(f"{line}{extra} ({smi})", flush=True)


def cudnn_lstm(ps, in0, dev, training, dtype=torch.float32):
    """torch.nn.LSTM (cuDNN) in ``dtype`` with the same weights: weight_ih = W[:in]ᵀ,
    weight_hh = W[in:]ᵀ, bias_ih = b, bias_hh = 0; the gate order i, f, g, o
    is the same. ``training`` keeps what the backward needs (cuDNN's reserve
    space: about 80 GB at 262,144 rows, so inference runs without). A
    yardstick only: the port never calls it."""
    hidden = ps[0].w.shape[1] // 4
    net = torch.nn.LSTM(in0, hidden, num_layers=len(ps), batch_first=True).to(device=dev, dtype=dtype)
    with torch.no_grad():
        for l, p in enumerate(ps):
            i = in0 if l == 0 else hidden
            getattr(net, f"weight_ih_l{l}").copy_(p.w[:i].t())
            getattr(net, f"weight_hh_l{l}").copy_(p.w[i:].t())
            getattr(net, f"bias_ih_l{l}").copy_(p.b)
            getattr(net, f"bias_hh_l{l}").zero_()
    net.requires_grad_(False)
    return net.train(training)


def dw_library(zs, dgates, dtype=torch.float32):
    """One cuBLAS call for a stack of dW/db products: zᵀ · dgates per layer,
    z = [input, h_{t-1}, 1] padded to one width → bmm, on operands of
    ``dtype`` (bf16: the bf16-compute tier's product). A yardstick only."""
    width = max(z.shape[1] for z in zs)
    zt = torch.stack([torch.nn.functional.pad(z, (0, width - z.shape[1])).t() for z in zs]).to(dtype)
    dg = torch.stack([g.reshape(-1, g.shape[-1]) for g in dgates]).to(dtype)
    return lambda: torch.bmm(zt, dg)


def time_bf16_tier(calls, work, weights, iters, label, smi):
    """Each bf16-compute kernel alone ("kernel") against its bf16 plain
    version ("plain"), its f32-compute twin ("f32_kernel") and, for the
    reductions, one cuBLAS call on bf16 operands ("library"), in turns;
    recorded with its bound at the bf16 tensor-core peak (``work``: FLOP,
    reads, writes; of the reads, ``weights`` are read in bf16, as the
    wrapper rounds them)."""
    bf16_ids = {id(w) for w in weights}
    out = {}
    for name, fns in calls.items():
        out[name] = in_turns(fns, iters)
        flop, reads, writes = work[name]
        reads = [t.bfloat16() if id(t) in bf16_ids else t for t in reads]
        record(name, out[name], flop, reads, writes, peak=BF16_FLOPS)
    print(f"{label} ({smi}): {json.dumps(out)}", flush=True)


def z_rows(inp, h_prev):
    """(B·T, in + H + 1): [input, h_{t-1}, 1] per row."""
    ones = inp.new_ones(inp.shape[:-1] + (1,))
    return torch.cat([inp, h_prev, ones], dim=-1).reshape(-1, inp.shape[-1] + h_prev.shape[-1] + 1)


def time_lstm_kernels(dev, smi):
    """Each lstm_seq_states kernel alone against its plain version and the
    library's call at seq2seq-tf-30's training shapes (B = 4096, T = 30,
    D = 3, H = 128, one layer, bf16 residuals), in turns."""
    ps, (xs, h0, c0), up = lstm_case(dev, TRAIN_B, 1, seed=3)
    rd = torch.bfloat16
    res = lstm_train.lstm_fwd(ps, xs, h0, c0, rd)
    dg, *bwd_rest = lstm_train.lstm_bwd(ps, c0, res, *up)
    net = cudnn_lstm(ps, 3, dev, training=True)
    x_g = xs.clone().requires_grad_(True)
    h0_g, c0_g = h0.clone().requires_grad_(True), c0.clone().requires_grad_(True)
    y, (hn, cn) = net(x_g, (h0_g, c0_g))
    h_prev = torch.cat([h0[0][:, None], res.hs[0][:, :-1].float()], dim=1)
    calls = {
        "lstm_seq_states_fwd": dict(
            kernel=lambda: lstm_train.lstm_fwd(ps, xs, h0, c0, rd),
            plain=lambda: lstm_train._forward_reference(ps, xs, h0, c0, rd),
            library=lambda: net(x_g, (h0_g, c0_g))),
        "lstm_seq_states_bwd": dict(
            kernel=lambda: lstm_train.lstm_bwd(ps, c0, res, *up),
            plain=lambda: lstm_train._bwd_recurrence_reference(ps, c0, res, *up),
            library=lambda: torch.autograd.grad((y, hn, cn), (x_g, h0_g, c0_g), up, retain_graph=True)),
        "lstm_seq_states_dw": dict(
            kernel=lambda: lstm_train.lstm_dw(ps, xs, h0, res, dg),
            plain=lambda: lstm_train._dw_reference(ps, xs, h0, res, dg),
            library=dw_library([z_rows(xs, h_prev)], dg)),
    }
    flop = stack_flop(TRAIN_B, 30, [3], 128)
    w = [ps[0].w, ps[0].b]
    io = {
        "lstm_seq_states_fwd": ([xs, h0, c0, *w], res.hs + res.cs + res.gs),
        "lstm_seq_states_bwd": ([c0, *up, ps[0].w, *res.cs, *res.gs], dg + bwd_rest),
        "lstm_seq_states_dw": ([xs, h0, *res.hs, *dg], w),
    }
    out = {}
    for name, fns in calls.items():
        out[name] = in_turns(fns, {"plain": 3, "kernel": 10, "library": 10})
        # the forward's [x, h]·W and the backward's dgates · Wᵀ on the tensor cores in three-pass TF32
        # (train_fwd_kernel and ss_bwd_kernel in their teacher-forced modes)
        record(name, out[name], flop + (2 * TRAIN_B * 30 * 4 * 128 if name.endswith("dw") else 0), *io[name],
               peak=F32_FLOPS if name.endswith("dw") else TF32X3_FLOPS)
    print(f"lstm_seq_states kernels alone (ms, B={TRAIN_B}, L=1, bf16 residuals, CUDA events; library: "
          f"cuDNN nn.LSTM forward, its backward data, one cuBLAS bmm; {smi}): {json.dumps(out)}", flush=True)
    for name in ("lstm_seq_states_fwd", "lstm_seq_states_bwd"):
        report_redesign(name, smi, fma_bound=bound(flop, *io[name])[0])
    bcalls = {
        "lstm_seq_states_fwd_bf16": dict(kernel=lambda: lstm_train.lstm_fwd(ps, xs, h0, c0, rd, BF),
                                         plain=lambda: lstm_train._forward_reference(ps, xs, h0, c0, rd, BF)),
        "lstm_seq_states_bwd_bf16": dict(kernel=lambda: lstm_train.lstm_bwd(ps, c0, res, *up, compute_dtype=BF),
                                         plain=lambda: lstm_train._bwd_recurrence_reference(ps, c0, res, *up, BF)),
        "lstm_seq_states_dw_bf16": dict(kernel=lambda: lstm_train.lstm_dw(ps, xs, h0, res, dg, BF),
                                        plain=lambda: lstm_train._dw_reference(ps, xs, h0, res, dg, BF),
                                        library=dw_library([z_rows(xs, h_prev)], dg, BF)),
    }
    for name, fns in bcalls.items():
        fns["f32_kernel"] = calls[name[:-5]]["kernel"]
    bwork = {n: (flop + (2 * TRAIN_B * 30 * 4 * 128 if n.endswith("dw_bf16") else 0), *io[n[:-5]])
             for n in bcalls}
    time_bf16_tier(bcalls, bwork, [ps[0].w], {"plain": 3, "kernel": 10, "f32_kernel": 10, "library": 10},
                   f"lstm_seq_states bf16-compute kernels alone (ms, B={TRAIN_B}, L=1, bf16 residuals, CUDA "
                   f"events, against the f32-compute kernels; library: one cuBLAS bmm on bf16 operands)", smi)
    for name in ("lstm_seq_states_fwd_bf16", "lstm_seq_states_bwd_bf16"):
        report_redesign(name, smi, fma_bound=bound(flop, *io[name[:-5]])[0],
                        no_library="none (cuDNN's bf16 LSTM rounds h and c too: another function)")


def time_lstm_10s(dev, smi):
    """Row 5's forward and backward alone at the stacked-ss-crossuser-10s
    encoder's shape (B = 4096, T = 100, L = 2, f32 residuals, as it
    trains), in both compute types against their plain versions and cuDNN's
    forward and backward data (nn.LSTM in f32, TF32 off), in turns; each
    beside its FMA design's time (BEFORE, PERF.md §5) and its bound."""
    ps, (xs, h0, c0), up = lstm_case(dev, TRAIN_B, 2, seed=12, t=100)
    res = lstm_train.lstm_fwd(ps, xs, h0, c0, F32)
    dg, *rest = lstm_train.lstm_bwd(ps, c0, res, *up)
    net = cudnn_lstm(ps, 3, dev, training=True)
    x_g = xs.clone().requires_grad_(True)
    h0_g, c0_g = h0.clone().requires_grad_(True), c0.clone().requires_grad_(True)
    y, (hn, cn) = net(x_g, (h0_g, c0_g))
    flop = stack_flop(TRAIN_B, 100, [3, 128], 128)
    fwd_io = ([xs, h0, c0, *(t for p in ps for t in p)], res.hs + res.cs + res.gs)
    with torch.no_grad():
        ms = in_turns({"plain": lambda: lstm_train._forward_reference(ps, xs, h0, c0, F32),
                       "kernel": lambda: lstm_train.lstm_fwd(ps, xs, h0, c0, F32),
                       "bf16_kernel": lambda: lstm_train.lstm_fwd(ps, xs, h0, c0, F32, BF),
                       "bf16_plain": lambda: lstm_train._forward_reference(ps, xs, h0, c0, F32, BF),
                       "library": lambda: net(xs, (h0, c0))},
                      {"plain": 1, "kernel": 5, "bf16_kernel": 5, "bf16_plain": 1, "library": 5})
    print(f"lstm_seq_states_fwd alone at the 10 s encoder's shape (ms, B={TRAIN_B}, T=100, L=2, f32 residuals, "
          f"CUDA events, in turns; library: cuDNN nn.LSTM's forward in f32; {smi}): {json.dumps(ms)}", flush=True)
    for name, key, peak in (("lstm_seq_states_fwd 10s", "kernel", TF32X3_FLOPS),
                            ("lstm_seq_states_fwd_bf16 10s", "bf16_kernel", BF16_FLOPS)):
        b_ms, b_by = bound(flop, *fwd_io, peak)
        report_redesign(name, smi, {"ms": ms[key], "library_ms": ms["library"] if key == "kernel" else None,
                                    "bound_ms": b_ms, "bound_by": b_by}, fma_bound=bound(flop, *fwd_io)[0],
                        no_library="none (cuDNN's bf16 LSTM rounds h and c too: another function)")
    fns = {"plain": lambda: lstm_train._bwd_recurrence_reference(ps, c0, res, *up),
           "kernel": lambda: lstm_train.lstm_bwd(ps, c0, res, *up),
           "bf16_kernel": lambda: lstm_train.lstm_bwd(ps, c0, res, *up, compute_dtype=BF),
           "bf16_plain": lambda: lstm_train._bwd_recurrence_reference(ps, c0, res, *up, BF),
           "library": lambda: torch.autograd.grad((y, hn, cn), (x_g, h0_g, c0_g), up, retain_graph=True)}
    ms = in_turns(fns, {"plain": 1, "kernel": 5, "bf16_kernel": 5, "bf16_plain": 1, "library": 5})
    reads, writes = [c0, *up, *(p.w for p in ps), *res.cs, *res.gs], dg + rest
    print(f"lstm_seq_states_bwd alone at the 10 s encoder's shape (ms, B={TRAIN_B}, T=100, L=2, f32 residuals, "
          f"CUDA events, in turns; library: cuDNN nn.LSTM's backward data in f32; {smi}): {json.dumps(ms)}",
          flush=True)
    for name, key, peak in (("lstm_seq_states_bwd 10s", "kernel", TF32X3_FLOPS),
                            ("lstm_seq_states_bwd_bf16 10s", "bf16_kernel", BF16_FLOPS)):
        b_ms, b_by = bound(flop, reads, writes, peak)
        report_redesign(name, smi, {"ms": ms[key], "library_ms": ms["library"] if key == "kernel" else None,
                                    "bound_ms": b_ms, "bound_by": b_by}, fma_bound=bound(flop, reads, writes)[0],
                        no_library="none (cuDNN's bf16 LSTM rounds h and c too: another function)")


def time_dw_pack(dev, smi):
    """The dW reductions' pack kernel alone against its plain version, in
    both compute types: at the main path's shape (seq2seq-tf-30's layer 0,
    B = 4096, T = 30, bf16 residuals: the kernels line's entries) and at
    the heaviest (stacked-ss-crossuser-10s's decoder layer 0, the context
    rebuilt from K = 7 peers' h over T = 100), in turns. Its bound is bytes:
    the sources once, the packed z once, in the types they are stored in."""
    ps, (xs, h0, c0), up = lstm_case(dev, TRAIN_B, 1, seed=3)
    res = lstm_train.lstm_fwd(ps, xs, h0, c0, BF)
    dg = lstm_train.lstm_bwd(ps, c0, res, *up)[0]
    out = {}
    for cd in (F32, BF):
        name = "lstm_dw_pack" + ("_bf16" if cd == BF else "")
        out[name] = in_turns({"plain": lambda cd=cd: lstm_train._pack_reference(xs, h0, res, 0, 3, cd),
                              "kernel": lambda cd=cd: lstm_train.dw_pack(lstm_train.lstm_dw, ps, xs, h0, res, dg,
                                                                         compute_dtype=cd)},
                             {"plain": 5, "kernel": 20})
        zp = lstm_train.dw_pack(lstm_train.lstm_dw, ps, xs, h0, res, dg, compute_dtype=cd)
        record(name, out[name], 0, [xs, h0[0], res.hs[0]], [zp], peak=BF16_FLOPS)
    ps, a = aligned_case(dev, TRAIN_B, 2, 7, "bernoulli", seed=11)
    php, _, ctx = lstm_align.peer_fwd(a["peer"], a["pxs"], a["pwt"], BF)
    ys, res = lstm_align.dec_fwd(ps, a["proj_w"], a["proj_b"], a["h0"], a["c0"], a["y0"], a["teacher"], a["coins"],
                                 ctx, BF)
    no_dg = [torch.zeros(res.gs[0].shape, device=dev)] * 2  # the pack pass reads no dgates
    dw_in = (ps, a["h0"], a["y0"], a["teacher"], a["coins"], a["pwt"], php, ys, res, no_dg)
    x0 = lstm_ss._layer0_input(a["y0"], a["teacher"], a["coins"], lstm_align._rebuilt_ctx(php, a["pwt"]), ys)
    for cd in (F32, BF):
        ms = in_turns({"plain": lambda cd=cd: lstm_train._pack_reference(x0, a["h0"], res, 0, 3, cd),
                       "kernel": lambda cd=cd: lstm_train.dw_pack(lstm_align.dec_dw, *dw_in, compute_dtype=cd)},
                      {"plain": 2, "kernel": 5})
        zp = lstm_train.dw_pack(lstm_align.dec_dw, *dw_in, compute_dtype=cd)
        reads = [a["h0"][0], a["y0"], a["teacher"], a["coins"], a["pwt"], php, ys, res.hs[0]]
        b_ms, _ = bound(0, reads, [zp])
        out[f"aligned layer 0 {str(cd)[6:]}"] = dict(ms, bound=b_ms)
    print(f"lstm_dw_pack alone (ms, layer 0: seq2seq-tf-30 B={TRAIN_B} T=30, and stacked-ss-crossuser-10s "
          f"B={TRAIN_B} K=7 T=100; bf16 residuals, CUDA events; bound: bytes; {smi}): {json.dumps(out)}",
          flush=True)


def ptxas_resources(source, symbol):
    """Registers, shared memory and spills of the first kernel of this run's
    build of ``source`` whose mangled name holds every part of ``symbol``."""
    name, props = None, {}
    for ln in BUILD_LOGS.get(source, "").splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and all(part in name for part in symbol):
            if "spill" in ln:
                props["spill_stores"], props["spill_loads"] = (int(x.split(" bytes")[0]) for x in ln.split(",")[1:3])
            elif "registers" in ln:
                props["registers"] = int(ln.split("Used")[1].split(" registers")[0])
                props["smem_bytes"] = int(ln.split(" bytes smem")[0].split(",")[-1]) if "smem" in ln else 0
                return props
    return {"registers": "not reported (cached build)"}


def report_tensor_cores(builds):
    """The registers, spills and shared memory (ptxas; the dynamic shared
    memory from the libraries) of the encoder kernels whose products run on
    the tensor cores, and the count of HMMA instructions in each one's SASS
    (cuobjdump of the built library); fails if a kernel has none: the bf16
    tier (mma.sync bf16) and the f32 tier and training kernels (three-pass
    TF32)."""
    kernels = {"encode_tokens_kernel<bf16>": ("transformer_encode", ("encode_tokens_kernel", "nv_bfloat16")),
               "encode_tokens_kernel<float>": ("transformer_encode", ("encode_tokens_kernel", "IfE")),
               "encode_stash_kernel": ("transformer_encode_train", ("encode_stash_kernel",)),
               "encode_reverse_kernel": ("transformer_encode_train", ("encode_reverse_kernel",))}
    hmma = dict.fromkeys(kernels, 0)
    for source in ("transformer_encode", "transformer_encode_train"):
        dump = sass(builds[source].path)
        fn = None
        for ln in dump.splitlines():
            if "Function :" in ln:
                fn = next((k for k, (src, parts) in kernels.items()
                           if src == source and all(p in ln for p in parts)), None)
            elif fn and "HMMA" in ln:
                hmma[fn] += 1
    enc = transformer_encode.bind(ctypes.CDLL(str(builds["transformer_encode"].path)))
    dyn = {"encode_tokens_kernel<bf16>": enc.transformer_encode_smem_bytes(1),
           "encode_tokens_kernel<float>": enc.transformer_encode_smem_bytes(0)}
    for name, (source, parts) in kernels.items():
        print(f"{name}: {hmma[name]} HMMA instructions in its SASS; {json.dumps(ptxas_resources(source, parts))}"
              + (f", {dyn[name]} bytes of dynamic shared memory a block" if name in dyn else ""), flush=True)
    if not all(hmma.values()):
        raise AssertionError(f"an encoder kernel has no HMMA instruction, its products off the tensor cores: {hmma}")


def report_peer_bwd(builds):
    """Every instance of the peer backward (residual type, compute type,
    ctx_dim): its registers, spills and shared memory (ptxas; the dynamic
    shared memory of the 10 s training shape's block, from the library) and
    the count of HMMA instructions in its SASS; fails if an instance has
    none: both products of every instance run on mma.sync."""
    dump = sass(builds["lstm_align"].path)
    hmma, fn = {}, None
    for ln in dump.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip() if "align_peer_bwd_kernel" in ln else None
            if fn:
                hmma[fn] = 0
        elif fn and "HMMA" in ln:
            hmma[fn] += 1
    lib = lstm_align.bind(ctypes.CDLL(str(builds["lstm_align"].path)))
    for sym, n in hmma.items():
        args = sym.split("align_peer_bwd_kernelI")[1]
        rt = "bf16" if args.startswith("13__nv_bfloat16") else "f32"
        args = args[len("13__nv_bfloat16") if rt == "bf16" else 1:]
        ct = "f32" if args.startswith("f") else "bf16"
        c = 8 * int(args.split("Li")[1].split("E")[0])
        smem = lib.peer_bwd_smem(c, 7, int(rt == "bf16"), int(ct == "bf16"))
        print(f"align_peer_bwd_kernel<RT {rt}, CT {ct}, C={c}>: {n} HMMA instructions in its SASS; "
              f"{json.dumps(ptxas_resources('lstm_align', (sym,)))}, {smem} bytes of dynamic shared memory at 7 "
              f"warps a block", flush=True)
    if len(hmma) != 4 * len(lstm_align.PEER_BWD_CTX) or not all(hmma.values()):
        raise AssertionError(f"a peer backward instance has no HMMA instruction, its products off the tensor cores: "
                             f"{hmma}")


def report_lstm_mma(builds):
    """The LSTM kernels on the tensor cores (lstm_mma.cuh): the bf16 peer
    context, encoder and serve kernel (rows 1b, 4b; encoder and server on
    bf16 mma.sync), the cell in both tiers (rows 2 and 2b, cell_step; f32 on
    three-pass TF32), and the f32 peer context, encoder and serve kernel
    (rows 1, 3 and 4; encoder and server on three-pass TF32): their
    registers, spills and shared memory (ptxas; the dynamic
    shared memory of the serving shapes' blocks, from ops.fused_lstm's
    choosers) and the count of HMMA instructions in their SASS; fails if one
    has none: their products run on mma.sync."""
    dump = sass(builds["fused_serve"].path)
    hmma, fn = {}, None
    for ln in dump.splitlines():
        if "Function :" in ln:
            bf16 = "nv_bfloat16" in ln
            fn = next((k for k in ("peer_context_kernel", "peer_context_glob_kernel", "fused_encode_kernel",
                                   "lstm_cell_kernel", "fused_serve_kernel") if k in ln), None)
            if fn == "fused_serve_kernel":
                fn += "<true>" if "ILb1E" in ln else "<false>"
            if fn:
                fn += "<bf16>" if bf16 else "<f32>"
                hmma[fn] = 0
        elif fn and "HMMA" in ln:
            hmma[fn] += 1
    blocks = {"peer_context_kernel<bf16>": fused_lstm.peer_tc_rows(128, 7, 3),
              "fused_encode_kernel<bf16>": fused_lstm.encode_tc_rows(128, 1, 3),
              "peer_context_kernel<f32>": fused_lstm.peer_tf32_rows(128, 7, 3),
              # K = 256 (predict --peers 256): one viewer a block of 256 rows, c and the staging in device memory
              "peer_context_glob_kernel<f32>": fused_lstm.peer_tf32_rows(128, 256, 3),
              "fused_encode_kernel<f32>": fused_lstm.encode_tf32_rows(128, 1, 3)}
    for name, geo in blocks.items():
        tier = "nv_bfloat16" if name.endswith("<bf16>") else "IfE"
        print(f"{name}: {hmma.get(name, 0)} HMMA instructions in its SASS; "
              f"{json.dumps(ptxas_resources('fused_serve', (name.split('<')[0], tier)))}, {geo.smem} bytes of dynamic "
              f"shared memory and {geo.warps} warps a block of {geo.rp} rows at the serving shape", flush=True)
    lib = fused_lstm.bind(ctypes.CDLL(str(builds["fused_serve"].path)))
    for tier, sym in (("bf16", "nv_bfloat16"), ("f32", "IfE")):
        blocks = {f"D_in={d}": fused_lstm.cell_block(d, 128, tier == "bf16") for d in (3, 128)}
        print(f"lstm_cell_kernel<{tier}>: {hmma.get(f'lstm_cell_kernel<{tier}>', 0)} HMMA instructions in its SASS; "
              f"{json.dumps(ptxas_resources('fused_serve', ('lstm_cell_kernel', sym)))}; blocks at H = 128 (rows, "
              f"units, warps, W resident, bytes of dynamic shared memory): {json.dumps(blocks)}", flush=True)
    for d, h in ((3, 1), (3, 40), (3, 128), (128, 128), (1024, 128), (5, 272), (3, 1024)):
        for bf16 in (0, 1):  # the library's accounting of each cell block is the chooser's
            got = (ctypes.c_longlong * 5)()
            lib.lstm_cell_block(d, h, bf16, got)
            if tuple(got) != tuple(int(v) for v in fused_lstm.cell_block(d, h, bool(bf16))):
                raise AssertionError(f"the cell's block at D_in={d}, H={h}: the library and the chooser disagree")
    shapes = {"seq2seq-tf-30": (128, 1, 3, 0, False), "stacked-ss-crossuser": (128, 2, 3, 128, False),
              "stacked-ss-crossuser-10s": (128, 2, 3, 128, True), "video-fusion": (128, 2, 3, 64, False)}
    for tier, choose, smem_of in (("bf16", fused_lstm.serve_tc_rows, lib.fused_serve_smem_bytes),
                                  ("f32", fused_lstm.serve_tf32_rows, lib.fused_serve_tf32_smem_bytes)):
        serving = {k: choose(*shape) for k, shape in shapes.items()}
        for k, g in serving.items():  # the library's accounting of each block is the chooser's
            if smem_of(g.rp, 3, shapes[k][3], 128, shapes[k][1], int(g.w_res), int(g.c_smem), int(shapes[k][4])) != \
                    g.smem:
                raise AssertionError(f"the {tier} serve block at {k}: the library and the chooser disagree on its "
                                     f"shared memory")
        for step in ("false", "true"):
            name = f"fused_serve_kernel<{step}><{tier}>"
            sym = ("fused_serve_kernel", "ILb1E" if step == "true" else "ILb0E",
                   "nv_bfloat16" if tier == "bf16" else "ILb" + ("1" if step == "true" else "0") + "EfE")
            print(f"{name}: {hmma.get(name, 0)} HMMA instructions in its SASS; "
                  f"{json.dumps(ptxas_resources('fused_serve', sym))}; blocks at the serving shapes (rows, warps, W "
                  f"resident, c in shared memory, bytes of dynamic shared memory): "
                  f"{json.dumps({k: [g.rp, g.warps, g.w_res, g.c_smem, g.smem] for k, g in serving.items()})}",
                  flush=True)
    for k in (7, 16, 64, 256):  # K = 256: c and the staging of h in device memory
        geo = fused_lstm.peer_tf32_rows(128, k, 3)
        if lib.peer_context_smem_bytes(geo.rp, geo.rows_v * k, 3, 128, 0, int(geo.c_smem), 0,
                                       int(geo.h_smem)) != geo.smem:
            raise AssertionError(f"the f32 peer context's block at K={k}: the library and the chooser disagree on "
                                 f"its shared memory")
    for bf16, choose in ((0, fused_lstm.encode_tf32_rows), (1, fused_lstm.encode_tc_rows)):
        for hidden, layers in ((128, 1), (64, 1), (128, 2)):
            g = choose(hidden, layers, 3)
            if lib.fused_encode_smem_bytes(g.rp, 3, hidden, layers, int(g.w_res), int(g.c_smem), bf16) != g.smem:
                raise AssertionError(f"the encoder's block at H={hidden}, L={layers}: the library and the chooser "
                                     f"disagree on its shared memory")
    if len(hmma) != 11 or not all(hmma.values()):
        raise AssertionError(f"an LSTM kernel on the tensor cores has no HMMA instruction, its products off them: "
                             f"{hmma}")


def report_train_mma(builds):
    """The training recurrences on the tensor cores: every instance of the
    backward (ss_bwd_kernel<RT, MODE, P, STAGES, MT, UB>: lstm_ss.cu's
    static context, lstm_align.cu's per-step one, lstm_train.cu's
    teacher-forced mode, row 5's; 32 rows with the W ring 4 k-pairs deep, or
    2 for deeper stacks; 16 rows with a ring of 2, a warp of one unit block
    or, above hidden 128, two), of the forward (train_fwd_kernel<RT, MODE,
    P>: the same three modes) and of the lockstep peer forward
    (align_peer_fwd_kernel<RT, P, MT>, lstm_mma.cuh's encoder): registers,
    spills and shared memory (ptxas; the dynamic shared memory of the
    training shapes' blocks, from the choosers, which must equal the
    library's) and the count of HMMA instructions in each one's SASS; fails
    if one has none: their products run on mma.sync in both compute tiers."""
    hmma = {}
    for source in ("lstm_ss", "lstm_align", "lstm_train"):
        dump = sass(builds[source].path)
        fn = None
        for ln in dump.splitlines():
            if "Function :" in ln:
                sym = ln.split("Function :")[1].strip()
                fn = (source, sym) if any(k in sym for k in ("ss_bwd_kernel", "train_fwd_kernel",
                                                              "align_peer_fwd_kernel")) else None
                if fn:
                    hmma[fn] = 0
            elif fn and "HMMA" in ln:
                hmma[fn] += 1
    modes = {"0": "static ctx", "1": "step ctx", "2": "teacher-forced"}
    for (source, sym), n in sorted(hmma.items()):
        rt = "bf16" if "I13__nv_bfloat16" in sym.split("kernel")[1][:20] else "f32"
        tier = "bf16" if "Bf16Mma" in sym else "f32 (three-pass TF32)"
        if "align_peer_fwd" in sym:
            name, extra = "align_peer_fwd_kernel", ", MT 1" if "Li1E" in sym else ""
        elif "train_fwd_kernel" in sym:
            mode = sym.split("train_fwd_kernelI")[1].split("EN8lstm_mma")[0][-1]  # the MODE argument, Li<m>E
            name, extra = f"train_fwd_kernel<{modes[mode]}>", ""
        else:
            mode = sym.split("ss_bwd_kernelI")[1].split("EN8lstm_mma")[0][-1]
            stages, mt, ub = (x.split("E")[0] for x in sym.split("MmaE")[1].split("Li")[1:4])
            name = f"ss_bwd_kernel<{modes[mode]}>"
            extra = f", ring {stages}, {16 * int(mt)} rows, {ub} unit block{'s' if ub == '2' else ''} a warp"
        print(f"{source}: {name}<RT {rt}, {tier}{extra}>: {n} HMMA instructions in "
              f"its SASS; {json.dumps(ptxas_resources(source, (sym,)))}", flush=True)
    ss_lib, al_lib, tr_lib = lstm_ss._library(), lstm_align._library(), lstm_train._library()
    blocks = {}
    out = (ctypes.c_int * 3)()

    def same_bwd(lib_fn, g, *args):
        smem = lib_fn(*args, out)
        return smem == g.smem and list(out) == [g.rows, g.warps, g.stages]

    for cd in (F32, BF):
        tier = str(cd)[6:]
        # the decoder backward at the presets' shapes and at the widths and depths taken above them
        for name, (h, layers, c, step) in (
                ("stacked-ss-crossuser", (128, 2, 128, False)), ("stacked-ss-crossuser-10s", (128, 2, 128, True)),
                ("video-fusion", (128, 2, 64, False)), ("H=256 L=2", (256, 2, 128, False)),
                ("H=128 L=8", (128, 8, 128, True))):
            g = lstm_ss.bwd_block(h, layers, 3, c, cd, step)
            if not same_bwd(ss_lib.ss_bwd_smem, g, h, layers, 3, c, int(step), int(cd == BF)):
                raise AssertionError(f"the decoder backward's block at {name}: the library and bwd_block disagree")
            blocks[f"ss_bwd {name} {tier}"] = [g.rows, g.warps, g.stages, g.smem]
            f = lstm_train.fwd_block(h, layers, 3, TRAIN_B, cd, ctx_dim=c, mode="step" if step else "static")
            if ss_lib.ss_fwd_smem(f.rp, 3, c, h, layers, int(f.c_smem), int(step), int(cd == BF)) != f.smem:
                raise AssertionError(f"the decoder forward's block at {name}: the library and fwd_block disagree")
            blocks[f"ss_fwd {name} {tier}"] = [f.rp, f.warps, f.c_smem, f.smem]
        g = lstm_align.peer_fwd_block(128, 7, 3, cd)
        if al_lib.align_peer_fwd_smem(3, 128, 7, g.rows_v, g.rp, g.mt, g.warps, int(g.w_res), int(g.c_smem),
                                      int(cd == BF), int(g.h_smem)) != g.smem:
            raise AssertionError("the peer forward's block: the library and peer_fwd_block disagree")
        blocks[f"peer_fwd K=7 {tier}"] = [g.rp, g.warps, g.w_res, g.smem]
        for name, (h, layers, d) in (("seq2seq-tf-30", (128, 1, 3)), ("crossuser encoder", (128, 2, 3)),
                                     ("video-fusion teacher-forced decoder", (128, 2, 67)),
                                     ("H=256 L=2", (256, 2, 3)), ("H=128 L=8", (128, 8, 3))):
            g = lstm_train.bwd_block(h, layers, d, cd)
            narrow, wide = lstm_train.bwd_split(d)
            if not same_bwd(tr_lib.lstm_bwd_smem, g, h, layers, narrow, wide, int(cd == BF)):
                raise AssertionError(f"row 5's backward block at {name}: the library and bwd_block disagree")
            blocks[f"lstm_bwd {name} {tier}"] = [g.rows, g.warps, g.stages, g.smem]
            f = lstm_train.fwd_block(h, layers, d, TRAIN_B, cd)
            if tr_lib.lstm_fwd_smem(f.rp, d, h, layers, int(f.c_smem), int(cd == BF)) != f.smem:
                raise AssertionError(f"row 5's forward block at {name}: the library and fwd_block disagree")
            blocks[f"lstm_fwd {name} {tier}"] = [f.rp, f.warps, f.c_smem, f.smem]
    print(f"the training recurrences' blocks at B={TRAIN_B} (ss_bwd and lstm_bwd: rows, warps, ring stages, bytes "
          f"of dynamic shared memory; ss_fwd and lstm_fwd: rows, warps, c in shared memory, bytes; peer_fwd: rows, "
          f"warps, W resident, bytes): {json.dumps(blocks)}", flush=True)
    if len(hmma) != 66 or not all(hmma.values()):
        raise AssertionError(f"a training recurrence instance has no HMMA instruction, its products off the tensor "
                             f"cores: {hmma}")


def report_decode_mma(builds):
    """The transformer decode in both tiers (row 9, f32 on three-pass TF32:
    transformer_decode_f32mma.cuh; row 9c, bf16: transformer_decode_mma.cuh)
    in blocks of 64 and of 32 rows: registers, spills and shared memory
    (ptxas; the dynamic shared memory from the library) and the count of
    HMMA instructions in each instance's SASS; fails if one has none."""
    dump = sass(builds["transformer_decode"].path)
    hmma, fn = {}, None
    for ln in dump.splitlines():
        if "Function :" in ln:
            sym = ln.split("Function :")[1].strip()
            fn = sym if "ar_decode_kernel" in sym else None
            if fn:
                hmma[fn] = 0
        elif fn and "HMMA" in ln:
            hmma[fn] += 1
    lib = transformer_decode.bind(ctypes.CDLL(str(builds["transformer_decode"].path)))
    for sym, n in hmma.items():
        rows, bf16 = 32 if "Li32E" in sym else 64, "nv_bfloat16" in sym
        print(f"ar_decode_kernel<{'bf16' if bf16 else 'f32'}, {rows} rows>: {n} HMMA instructions in its SASS; "
              f"{json.dumps(ptxas_resources('transformer_decode', (sym,)))}, "
              f"{lib.transformer_decode_smem_bytes(rows, int(bf16))} bytes of dynamic shared memory, 16 warps a block",
              flush=True)
    if len(hmma) != 4 or not all(hmma.values()):
        raise AssertionError(f"a decode instance has no HMMA instruction, its products off the tensor cores: {hmma}")


def report_dw(smi):
    """One line per dW instance (report_redesign, the library cuBLAS's
    products): with the registers, shared memory and spills of its product
    kernel and its pack kernel (bf16 residuals, the main path's)."""
    sources = {"lstm_seq_states": ("lstm_train", "Li0E"), "ss_decode": ("lstm_ss", "Li1E"),
               "aligned_dec": ("lstm_align", "Li2E"), "aligned_peer": ("lstm_align", "Li0E")}
    for name in DW_NAMES:
        src, mode = sources[name.rsplit("_dw", 1)[0]]
        ct = "13__nv_bfloat16" if name.endswith("bf16") else "f"
        product = ptxas_resources(src, ("lstm_dw_partial_kernel", f"kernelI{ct}E"))
        pack = ptxas_resources(src, ("lstm_dw_pack_kernel", f"kernelI13__nv_bfloat16{mode}{'S0_' if ct != 'f' else 'f'}E"))
        report_redesign(name, smi, extra=f"; product kernel {json.dumps(product)}, pack kernel {json.dumps(pack)}")


# --------------------------------------------------------------- stacked-ss-crossuser serving


def drive_cu_serving(cfg, dev, params_np, path, n_single, n_bulk):
    """Single requests with K peers, with fewer (the rest zero, masked by
    the default mask), with none (zero context), and one bulk request with
    an explicit mask, through the batcher; the answers against the port's
    plain path on the CPU and, given the same peer context (static, or per
    step under peer_align), the numpy oracle's decoder."""
    params = params_from_numpy(params_np, dev)
    m, k = cfg.model, cfg.n_other_users
    rng = np.random.default_rng(8)
    pasts = unit_pasts(rng, n_single + n_bulk, m.h_in)
    others = unit_pasts(rng, (n_single + n_bulk) * k, m.h_out).reshape(-1, k, m.h_out, 3)
    requests = []
    for i in range(n_single):
        kind = i % 3  # K peers, two peers, none
        if kind == 1:
            others[i, 2:] = 0.0
        if kind == 2:
            others[i] = 0.0
        r = {"past": pasts[i]}
        if kind < 2:
            r["other_future"] = others[i, :2] if kind == 1 else others[i]
        requests.append(r)
    mask = (np.abs(others).max(axis=(2, 3)) > 0).astype(np.float32)
    mask[n_single:] = (rng.random((n_bulk, k)) < 0.6).astype(np.float32)
    bulk = {"past": pasts[n_single:], "other_future": others[n_single:], "other_mask": mask[n_single:]}
    (got, stats, _), launches = drive(path, lambda: serve_batched(cfg, cross_user, dev, params, requests, bulk))
    xyz = to_xyz(got)

    params_cpu = params_from_numpy(params_np, "cpu")
    batch = {"past": pasts, "other_future": others, "other_mask": mask}
    plain = infer.make_predict_fn(params_cpu, cfg, device="cpu", impl="plain")(batch).numpy()
    d_plain = float(np.abs(xyz - plain).max())
    with torch.inference_mode():
        anchor = torch.as_tensor(pasts[:, -1:])
        encode = cross_user.encode_peers_aligned if m.peer_align else cross_user.encode_peers
        ctx = encode(params_cpu, m, torch.as_tensor(others) - anchor[:, None], torch.as_tensor(mask)).numpy()
    d_oracle = float(np.abs(xyz - oracle.oracle_predict(params_np, m, pasts, context=ctx)).max())
    print(f"{path}: {n_single} single requests (K={k}, 2 and 0 peers) + 1 bulk ({n_bulk} rows, "
          f"explicit mask) in {stats['batches']} batches; max |xyz - CPU plain path| {d_plain:.3e}; "
          f"max |xyz - numpy oracle given the peer context| {d_oracle:.3e} (tolerance {ORACLE_TOL})", flush=True)
    if not (d_plain <= ORACLE_TOL and d_oracle <= ORACLE_TOL):
        raise AssertionError("crossuser answers disagree with the plain path or the oracle")
    return params, launches


def time_encode_kernel(dev, rows, smi, with_library, cd=F32):
    """fused_encode alone in the compute type ``cd`` at the serving path's
    peer rows (B·K, one layer, as stacked-ss-crossuser's peer encoder),
    checked first, against its plain version (and, in bf16, its f32 twin)
    and, ``with_library``, cuDNN nn.LSTM returning h_n in ``cd`` (TF32 off;
    in bf16 cuDNN rounds c and the gates too, another function; at 262,144
    rows cuDNN asks for more workspace than the card has). The last call's
    numbers go to the kernels line."""
    rng = np.random.default_rng(2)
    ps = stack(rng, dev, 3, 1)
    xs = unit_rows(rng, dev, (rows, 30))
    out = fused_lstm.fused_encode(ps, xs, compute_dtype=cd)
    err = check_outputs("fused_encode", [out], plains(cd, lambda c: [fused_lstm.fused_encode_reference(ps, xs, c)]),
                        f"{rows} rows", "encode", cd)
    fns = {"plain": lambda: fused_lstm.fused_encode_reference(ps, xs, cd),
           "kernel": lambda: fused_lstm.fused_encode(ps, xs, compute_dtype=cd)}
    if cd == BF:
        fns["f32_kernel"] = lambda: fused_lstm.fused_encode(ps, xs)
    note = ""
    if with_library:
        net, xs_lib = cudnn_lstm(ps, 3, dev, training=False, dtype=cd), xs.to(cd)

        def library():
            with torch.no_grad():
                return net(xs_lib)[1][0][-1]

        fns["library"] = library
        note = f", vs cuDNN in {str(cd)[6:]} {(out - library().float()).abs().max().item():.3e}"
    ms = in_turns(fns, {"plain": 2, "kernel": 5, "library": 5, "f32_kernel": 5})
    name = "fused_encode" + ("_bf16" if cd == BF else "")
    flop, reads = stack_flop(rows, 30, [3], 128), [xs] + tier_reads(ps[0], cd)
    record(name, ms, flop, reads, [out], TF32X3_FLOPS if cd == F32 else BF16_FLOPS)
    print(f"{name} alone ({rows} rows, L=1, T=30; ms, CUDA events, library cuDNN nn.LSTM, {smi}): "
          f"{json.dumps(ms)}; bound {TIMES[name]['bound_ms']:.3f} ms by {TIMES[name]['bound_by']}; vs plain "
          f"{json.dumps(err)}{note}", flush=True)
    # rows 4 (three-pass TF32) and 4b (bf16) on the tensor cores (lstm_mma.cuh's encoder)
    report_redesign(name, smi, before=name if with_library or cd == BF else f"{name} {rows} rows",
                    fma_bound=bound(flop, reads, [out])[0],
                    extra=f"; its f32 twin {ms['f32_kernel']:.4f} ms" if cd == BF else f" ({rows} rows)",
                    no_library="cuDNN not run at this size (its workspace grows with rows x steps)")


def check_grouped(cfg, dev, params, rows, n_videos):
    """The grouped gateway (each video's K peers sent once, gathered per row
    on the card) against per-row serving of the same windows: equal
    answers."""
    rng = np.random.default_rng(9)
    k, m = cfg.n_other_users, cfg.model
    keys = rng.integers(0, n_videos, size=rows).tolist()
    sets = {v: unit_pasts(rng, k, m.h_out) for v in range(n_videos)}
    sets[0][k - 2:] = 0.0  # a video with two peers absent
    pasts = unit_pasts(rng, rows, m.h_in)
    fn = serving.make_grouped_serve_fn(params, cfg, cross_user, device=dev, packed=True)
    got = serving.grouped_predict(fn, pasts, keys, sets)
    per_row = serving.make_serve_fn(params, cfg, cross_user, device=dev, impl="fused")
    of = np.stack([sets[v] for v in keys])
    direct = per_row.unpack(per_row({"past": pasts, "other_future": of,
                                     "other_mask": (np.abs(of).max(axis=(2, 3)) > 0).astype(np.float32)})
                            .cpu().numpy())
    d = max(float(np.abs(got[x] - direct[x]).max()) for x in ("yaw", "pitch"))
    same_tiles = bool((got["prefetch"] == direct["prefetch"]).all())
    print(f"{CU10_SERVE}: grouped gateway, {rows} windows of {n_videos} videos (K={k} peers sent once a "
          f"video): max |yaw,pitch - per-row serving| {d:.3e}, prefetch equal {same_tiles} (tolerance 1e-5)",
          flush=True)
    if not (d <= 1e-5 and same_tiles):
        raise AssertionError("the grouped gateway differs from per-row serving")


def time_peer_serve(dev, params, cfg, batch, iters, smi, cd=F32):
    """The lockstep tier in the compute type ``cd`` at a main-path batch:
    checked against its plain version on these inputs, then timed in turns
    as a whole and per kernel (the serve kernel with the per-step context,
    fed the peer context, beside its f32 twin in bf16; ``peer_context``
    alone is timed by time_peer_context). No single PyTorch call computes
    the decode with feedback: no library time."""
    m = cfg.model
    rng = np.random.default_rng(1)
    x_n = windows.normalize_window(unit_rows(rng, dev, (batch, m.h_in)))[0]
    x_n = x_n.contiguous()
    pxs, w = peer_inputs(rng, dev, x_n, cfg.n_other_users, m.h_out)
    peer = params["peer_encoder"]
    kw = dict(peer_params=peer, peer_xs=pxs, peer_w=w)
    args = (params["encoder"], params["decoder"], params["proj"]["w"], params["proj"]["b"], x_n, m.h_out)
    out = fused_lstm.fused_serve(*args, compute_dtype=cd, **kw)
    err = check_outputs("fused_serve_peers", [out],
                        plains(cd, lambda c: [fused_lstm.fused_serve_reference(*args, compute_dtype=c, **kw)]),
                        f"B={batch}", "serve", cd)
    tier = in_turns({"plain": lambda: fused_lstm.fused_serve_reference(*args, compute_dtype=cd, **kw),
                     "kernel": lambda: fused_lstm.fused_serve(*args, compute_dtype=cd, **kw)},
                    {"plain": 1, "kernel": iters})
    ctx = fused_lstm.peer_context(peer, pxs, w, compute_dtype=cd)
    enc, dec = fused_lstm._in_tier(params["encoder"], cd), fused_lstm._in_tier(params["decoder"], cd)
    pw, pb = params["proj"]["w"].to(cd), params["proj"]["b"].float()
    fns = {"plain": lambda: fused_lstm.fused_serve_reference(*args, ctx, compute_dtype=cd),
           "kernel": lambda: fused_lstm._launch_serve(enc, dec, pw, pb, x_n, m.h_out, ctx, step_ctx=True,
                                                      compute_dtype=cd)}
    if cd == BF:
        enc32, dec32 = fused_lstm._in_tier(enc, F32), fused_lstm._in_tier(dec, F32)
        fns["f32_kernel"] = lambda: fused_lstm._launch_serve(enc32, dec32, pw.float(), pb, x_n, m.h_out, ctx,
                                                             step_ctx=True, compute_dtype=F32)
    ms = in_turns(fns, {"plain": 1, "kernel": iters, "f32_kernel": iters})
    ps = params["encoder"] + params["decoder"]
    flop = serve_flop(batch, m.h_in, m.h_out, [m.d] + [m.hidden] * (m.layers - 1),
                      [m.d + m.ctx_dim] + [m.hidden] * (m.layers - 1), m.hidden, m.d)
    name = "fused_serve_peers" + ("_bf16" if cd == BF else "")
    reads = [x_n, ctx] + tier_reads([params["proj"]["w"], params["proj"]["b"]] + [t for p in ps for t in p], cd)
    record(name, ms, serve_work(flop, batch * m.h_out * m.hidden * m.d, cd), reads, [out])
    tier_flop = flop + stack_flop(batch * cfg.n_other_users, m.h_out, [m.d], m.ctx_dim)
    report_redesign(name, smi, no_library="none (AR decode with feedback)", fma_bound=bound(flop, reads, [out])[0],
                    extra=f"; the lockstep serve kernel, B={batch}" + (
                        f", its f32 twin {ms['f32_kernel']:.4f} ms" if cd == BF else ""))
    print(f"lockstep fused_serve tier alone (B={batch}, L={m.layers}, K={cfg.n_other_users}, "
          f"{m.h_in}+{m.h_out} steps, {str(cd)[6:]}; ms, CUDA events, {smi}): whole tier {json.dumps(tier)} "
          f"({tier_flop / tier['kernel'] / 1e9:.1f} TFLOP/s); the serve kernel with the per-step context "
          f"{json.dumps(ms)}, bound {TIMES[name]['bound_ms']:.3f} ms by {TIMES[name]['bound_by']}; vs plain "
          f"{json.dumps(err)}", flush=True)


def time_peer_context(dev, peer, batch, k, t, smi, with_library, cd=F32, keep=True):
    """peer_context alone in the compute type ``cd`` over B·K peer rows,
    checked first, against its plain version (in bf16, and its f32 twin)
    and, ``with_library``, cuDNN nn.LSTM in ``cd`` returning every step's h
    (TF32 off; its workspace grows with rows x steps, so it runs only at the
    smaller batch). The last call's numbers go to the kernels line, unless
    ``keep`` is False (a line of its own: K = 16)."""
    rng = np.random.default_rng(2)
    x_n = randn(rng, dev, (batch, 1, 3))
    pxs, w = peer_inputs(rng, dev, x_n, k, t)
    out = fused_lstm.peer_context(peer, pxs, w, compute_dtype=cd)
    err = check_outputs("peer_context", [out],
                        plains(cd, lambda c: [fused_lstm.peer_context_reference(peer, pxs, w, c)]),
                        f"B={batch}", "ctx", cd)
    fns = {"plain": lambda: fused_lstm.peer_context_reference(peer, pxs, w, cd),
           "kernel": lambda: fused_lstm.peer_context(peer, pxs, w, compute_dtype=cd)}
    if cd == BF:
        fns["f32_kernel"] = lambda: fused_lstm.peer_context(peer, pxs, w)
    if with_library:
        net, flat = cudnn_lstm([peer], 3, dev, training=False, dtype=cd), pxs.reshape(batch * k, t, 3).to(cd)

        def library():
            with torch.no_grad():
                return net(flat)[0]

        fns["library"] = library
    ms = in_turns(fns, {"plain": 1, "kernel": 3, "library": 3, "f32_kernel": 3})
    rows = batch * k
    name = "peer_context" + ("_bf16" if cd == BF else "")
    kept = TIMES.get(name)
    # the products on the tensor cores (bf16, or three-pass TF32), the context sum on the FMA units
    flop, reads = stack_flop(rows, t, [3], 128) + 2 * rows * t * 128, [pxs, w] + tier_reads(peer, cd)
    work = {BF16_FLOPS: flop} if cd == BF else {TF32X3_FLOPS: stack_flop(rows, t, [3], 128),
                                                F32_FLOPS: 2 * rows * t * 128}
    record(name, ms, work, reads, [out])
    print(f"{name} alone (B={batch}, K={k}: {rows} peer rows, T={t}; ms, CUDA events, library cuDNN "
          f"nn.LSTM over the peer rows, {smi}): {json.dumps(ms)}; bound {TIMES[name]['bound_ms']:.3f} "
          f"ms by {TIMES[name]['bound_by']}; vs plain {json.dumps(err)}", flush=True)
    # rows 1 and 1b on the tensor cores (lstm_mma.cuh)
    before = (name if with_library else f"{name} B={batch}") if k == 7 else f"{name} K={k}"
    report_redesign(name, smi, before=before,
                    fma_bound=bound(flop, reads, [out])[0], no_library="cuDNN not run at this batch",
                    extra=f" (B={batch}, K={k})" + (f"; its f32 twin {ms['f32_kernel']:.4f} ms" if cd == BF else ""))
    if not keep:
        TIMES[name] = kept


# --------------------------------------------------------------- stacked-ss-crossuser training


def time_ss_kernels(dev, smi):
    """Each ss_decode kernel alone against its plain version at the
    training path's decoder shapes (B = 4096, T = 30, D = 3, C = 128,
    H = 128, two layers, bf16 residuals, Bernoulli coins), in turns; the
    reductions also against one cuBLAS call. No single PyTorch call
    computes the forward or backward recurrence with feedback."""
    layers, ctx_dim, rd = 2, 128, torch.bfloat16
    ps, a = ss_case(dev, TRAIN_B, layers, ctx_dim, "bernoulli", seed=5)
    ys, res = lstm_ss.ss_fwd(*ss_fwd_args(ps, a), rd)
    bw = lstm_ss.ss_bwd(ps, a["proj_w"], a["c0"], a["coins"], res, a["dys"], ctx_dim)
    dgates, dy = bw[0], bw[1]
    dw_in = (ps, a["h0"], a["y0"], a["teacher"], a["coins"], a["ctx"], ys, res, dgates)
    x0 = lstm_ss._layer0_input(a["y0"], a["teacher"], a["coins"], a["ctx"], ys)
    zs = []
    for l in range(layers):
        inp = x0 if l == 0 else res.hs[l - 1].float()
        zs.append(z_rows(inp, torch.cat([a["h0"][l][:, None], res.hs[l][:, :-1].float()], dim=1)))
    h_top = res.hs[-1].float().reshape(-1, 128)
    h1 = torch.cat([h_top, h_top.new_ones((h_top.shape[0], 1))], dim=1)  # [h_top, 1]
    bwd_args = (ps, a["proj_w"], a["c0"], a["coins"], res, a["dys"], ctx_dim)
    calls = {
        "ss_decode_fwd": dict(kernel=lambda: lstm_ss.ss_fwd(*ss_fwd_args(ps, a), rd),
                              plain=lambda: lstm_ss._forward_reference(*ss_fwd_args(ps, a), rd)),
        "ss_decode_bwd": dict(kernel=lambda: lstm_ss.ss_bwd(*bwd_args),
                              plain=lambda: lstm_ss._bwd_recurrence_reference(*bwd_args)),
        "ss_decode_dw": dict(kernel=lambda: lstm_ss.ss_dw(*dw_in), plain=lambda: lstm_ss._dw_reference(*dw_in),
                             library=dw_library(zs, dgates)),
        "ss_decode_dproj": dict(kernel=lambda: lstm_ss.ss_dproj(res.hs[-1], dy),
                                plain=lambda: lstm_ss._dproj_reference(res.hs[-1], dy),
                                library=lambda: h1.t() @ dy.reshape(-1, 3)),
    }
    ins = [3 + ctx_dim] + [128] * (layers - 1)
    proj = 2 * TRAIN_B * 30 * 128 * 3
    w = [t for p in ps for t in p]
    res_all = res.hs + res.cs + res.gs
    work = {
        # the gates on the tensor cores (three-pass TF32), the projection on the FMA units
        "ss_decode_fwd": ({TF32X3_FLOPS: stack_flop(TRAIN_B, 30, ins, 128), F32_FLOPS: proj},
                          [a["h0"], a["c0"], a["y0"], a["teacher"], a["coins"], a["ctx"], a["proj_w"],
                           a["proj_b"], *w], [ys, *res_all]),
        # dgates · Wᵀ on the tensor cores (three-pass TF32), dy · proj_wᵀ on the FMA units
        "ss_decode_bwd": ({TF32X3_FLOPS: stack_flop(TRAIN_B, 30, ins, 128), F32_FLOPS: proj},
                          [a["dys"], a["c0"], a["coins"], a["proj_w"], *w, *res.cs, *res.gs],
                          [*dgates, *bw[1:6], bw[6]]),
        "ss_decode_dw": (stack_flop(TRAIN_B, 30, ins, 128) + 2 * TRAIN_B * 30 * 4 * 128 * layers,
                         [a["h0"], a["y0"], a["teacher"], a["coins"], a["ctx"], ys, *res.hs,
                          *res.cs[:-1], *res.gs[:-1], *dgates], w),
        "ss_decode_dproj": (2 * TRAIN_B * 30 * 129 * 3, [res.hs[-1], dy], [a["proj_w"], a["proj_b"]]),
    }
    out = {}
    for name, fns in calls.items():
        out[name] = in_turns(fns, {"plain": 3, "kernel": 10, "library": 10})
        record(name, out[name], *work[name])
    print(f"ss_decode kernels alone (ms, B={TRAIN_B}, L={layers}, C={ctx_dim}, bf16 residuals, Bernoulli "
          f"coins, CUDA events; library: one cuBLAS bmm / matmul; {smi}): {json.dumps(out)}", flush=True)
    h1b, dyb = h1.bfloat16(), dy.reshape(-1, 3).bfloat16()
    bcalls = {
        "ss_decode_fwd_bf16": dict(kernel=lambda: lstm_ss.ss_fwd(*ss_fwd_args(ps, a), rd, BF),
                                   plain=lambda: lstm_ss._forward_reference(*ss_fwd_args(ps, a), rd, BF)),
        "ss_decode_bwd_bf16": dict(kernel=lambda: lstm_ss.ss_bwd(*bwd_args, BF),
                                   plain=lambda: lstm_ss._bwd_recurrence_reference(*bwd_args, compute_dtype=BF)),
        "ss_decode_dw_bf16": dict(kernel=lambda: lstm_ss.ss_dw(*dw_in, BF),
                                  plain=lambda: lstm_ss._dw_reference(*dw_in, BF),
                                  library=dw_library(zs, dgates, BF)),
        "ss_decode_dproj_bf16": dict(kernel=lambda: lstm_ss.ss_dproj(res.hs[-1], dy, BF),
                                     plain=lambda: lstm_ss._dproj_reference(res.hs[-1], dy, BF),
                                     library=lambda: h1b.t() @ dyb),
    }
    for name, fns in bcalls.items():
        fns["f32_kernel"] = calls[name[:-5]]["kernel"]
    time_bf16_tier(bcalls, {n: (flop_of(work[n[:-5]][0]), *work[n[:-5]][1:]) for n in bcalls},
                   [p.w for p in ps] + [a["proj_w"]],
                   {"plain": 3, "kernel": 10, "f32_kernel": 10, "library": 10},
                   f"ss_decode bf16-compute kernels alone (ms, B={TRAIN_B}, L={layers}, C={ctx_dim}, bf16 "
                   f"residuals, Bernoulli coins, CUDA events, against the f32-compute kernels; library: one "
                   f"cuBLAS bmm / matmul on bf16 operands; none computes a recurrence with feedback)", smi)
    for name, fns in (("ss_decode_dproj", calls["ss_decode_dproj"]), ("ss_decode_dproj_bf16", bcalls["ss_decode_dproj_bf16"])):
        report_redesign(name, smi, device={w: device_ms(fns[w], 20) for w in ("kernel", "library")})
    report_redesign("ss_decode_bwd", smi, fma_bound=bound(flop_of(work["ss_decode_bwd"][0]),
                                                          *work["ss_decode_bwd"][1:])[0],
                    no_library="none (feedback)")
    report_redesign("ss_decode_bwd_bf16", smi, no_library="none (feedback)")
    report_redesign("ss_decode_fwd", smi, fma_bound=bound(flop_of(work["ss_decode_fwd"][0]),
                                                          *work["ss_decode_fwd"][1:])[0],
                    no_library="none (feedback)")
    report_redesign("ss_decode_fwd_bf16", smi, no_library="none (feedback)")


def time_aligned_kernels(dev, smi):
    """Each aligned_ss_decode kernel alone against its plain version at the
    training path's shapes (B = 4096, K = 7, T = 100, D = 3, C = H = 128,
    two layers, bf16 residuals, Bernoulli coins), in turns; the peer forward
    and backward also against cuDNN nn.LSTM (forward; backward data with
    the peers' upstream gradient), the reductions against one cuBLAS call.
    No single PyTorch call computes the decoder's recurrences with feedback
    and a per-step context."""
    layers, k, c, rd, t = 2, 7, 128, torch.bfloat16, 100
    ps, a = aligned_case(dev, TRAIN_B, layers, k, "bernoulli", seed=11)
    peer, pxs, pwt = a["peer"], a["pxs"], a["pwt"]
    php, pcp, ctx = lstm_align.peer_fwd(peer, pxs, pwt, rd)
    fwd_args = (ps, a["proj_w"], a["proj_b"], a["h0"], a["c0"], a["y0"], a["teacher"], a["coins"], ctx)
    ys, res = lstm_align.dec_fwd(*fwd_args, rd)
    bwd_args = (ps, a["proj_w"], a["c0"], a["coins"], res, a["dys"], c)
    bw = lstm_align.dec_bwd(*bwd_args)
    dgates, dctx = bw[0], bw[6]
    pbw = lstm_align.peer_bwd(peer, pxs, pwt, php, pcp, dctx)
    dpg = pbw[0]
    dw_in = (ps, a["h0"], a["y0"], a["teacher"], a["coins"], pwt, php, ys, res, dgates)
    net = cudnn_lstm([peer], 3, dev, training=True)
    x_g = pxs.clone().requires_grad_(True)
    dh_up = pwt.reshape(-1, 1, 1) * dctx.repeat_interleave(k, dim=0)  # the peers' upstream dh
    calls = {
        "aligned_peer_fwd": dict(kernel=lambda: lstm_align.peer_fwd(peer, pxs, pwt, rd),
                                 plain=lambda: lstm_align._peer_fwd_reference(peer, pxs, pwt, rd),
                                 library=lambda: net(x_g)),
        "aligned_dec_fwd": dict(kernel=lambda: lstm_align.dec_fwd(*fwd_args, rd),
                                plain=lambda: lstm_ss._forward_reference(*fwd_args, rd)),
        "aligned_dec_bwd": dict(kernel=lambda: lstm_align.dec_bwd(*bwd_args),
                                plain=lambda: lstm_ss._bwd_recurrence_reference(*bwd_args, step_ctx=True)),
    }
    out = {name: in_turns(fns, {"plain": 2, "kernel": 5, "library": 5}) for name, fns in calls.items()}
    # cuDNN's backward needs its forward's reserve space (about 29 GiB here):
    # one forward kept for it, timed alone, then freed before the reductions
    y_lib, _ = net(x_g)
    out["aligned_peer_bwd"] = in_turns(dict(
        kernel=lambda: lstm_align.peer_bwd(peer, pxs, pwt, php, pcp, dctx),
        plain=lambda: lstm_align._peer_bwd_reference(peer, pxs, pwt, php, pcp, dctx),
        library=lambda: torch.autograd.grad(y_lib, x_g, dh_up, retain_graph=True)),
        {"plain": 2, "kernel": 5, "library": 5})
    del y_lib, net, x_g, dh_up
    torch.cuda.empty_cache()
    x0 = lstm_ss._layer0_input(a["y0"], a["teacher"], a["coins"], lstm_align._rebuilt_ctx(php, pwt), ys)
    zs = [z_rows(x0 if l == 0 else res.hs[l - 1].float(),
                 torch.cat([a["h0"][l][:, None], res.hs[l][:, :-1].float()], dim=1)) for l in range(layers)]
    zp = z_rows(pxs, torch.cat([torch.zeros_like(php[:, :1]), php[:, :-1]], dim=1).float())
    dpg2 = dpg.reshape(-1, 4 * c)
    calls = {
        "aligned_dec_dw": dict(kernel=lambda: lstm_align.dec_dw(*dw_in),
                               plain=lambda: lstm_align._dw_reference(*dw_in),
                               library=dw_library(zs, dgates)),
        "aligned_peer_dw": dict(kernel=lambda: lstm_align.peer_dw(peer, pxs, php, dpg),
                                plain=lambda: lstm_align._peer_dw_reference(peer, pxs, php, dpg),
                                library=lambda: zp.t() @ dpg2),
    }
    out.update({name: in_turns(fns, {"plain": 2, "kernel": 5, "library": 5}) for name, fns in calls.items()})
    rows = TRAIN_B * k
    ins = [3 + c] + [128] * (layers - 1)
    proj = 2 * TRAIN_B * t * 128 * 3
    peer_pass = stack_flop(rows, t, [3], c)
    gate_h = 2 * rows * t * c * 4 * c  # the recomputed gates' h part
    flop = {"aligned_peer_bwd": 2 * peer_pass}  # where a bound's work is not its FLOP
    w = [x for p in ps for x in p]
    res_all = res.hs + res.cs + res.gs
    work = {
        # the gates on the tensor cores (three-pass TF32), the context sum on the FMA units
        "aligned_peer_fwd": ({TF32X3_FLOPS: peer_pass, F32_FLOPS: 2 * rows * t * c}, [pxs, pwt, *peer],
                             [php, pcp, ctx]),
        "aligned_dec_fwd": ({TF32X3_FLOPS: stack_flop(TRAIN_B, t, ins, 128), F32_FLOPS: proj},
                            [a["h0"], a["c0"], a["y0"], a["teacher"], a["coins"], ctx, a["proj_w"],
                             a["proj_b"], *w], [ys, *res_all]),
        "aligned_dec_bwd": ({TF32X3_FLOPS: stack_flop(TRAIN_B, t, ins, 128), F32_FLOPS: proj},
                            [a["dys"], a["c0"], a["coins"], a["proj_w"], *w, *res.cs, *res.gs],
                            [*dgates, *bw[1:]]),
        # the products on the tensor cores, three-pass TF32, but for the gates'
        # h part, exact in TF32 on bf16 residuals: two passes, 2/3 of its FLOP
        # at the three-pass rate
        "aligned_peer_bwd": ({TF32X3_FLOPS: 2 * peer_pass - (gate_h / 3 if rd == BF else 0)},
                             [pxs, pwt, *peer, php, pcp, dctx], list(pbw)),
        "aligned_dec_dw": (stack_flop(TRAIN_B, t, ins, 128) + 2 * TRAIN_B * t * 4 * 128 * layers
                           + 2 * TRAIN_B * t * c * k,
                           [a["h0"], a["y0"], a["teacher"], a["coins"], pwt, php, ys, *res.hs, *res.cs[:-1],
                            *res.gs[:-1], *dgates], w),
        "aligned_peer_dw": (peer_pass + 2 * rows * t * 4 * c, [pxs, php, dpg], list(peer)),
    }
    for name in work:
        record(name, out[name], *work[name])
    print(f"aligned_ss_decode kernels alone (ms, B={TRAIN_B}, K={k}, T={t}, L={layers}, C=H=128, bf16 residuals, "
          f"Bernoulli coins, CUDA events; library: cuDNN nn.LSTM forward and backward data over the peer "
          f"rows, one cuBLAS bmm / matmul; {smi}): {json.dumps(out)}", flush=True)
    zpb, dpg2b = zp.bfloat16(), dpg2.bfloat16()
    bcalls = {}
    for cd in (BF, torch.float32):
        for name, fn in (
                ("aligned_peer_fwd", lambda cd=cd: lstm_align.peer_fwd(peer, pxs, pwt, rd, cd)),
                ("aligned_dec_fwd", lambda cd=cd: lstm_align.dec_fwd(*fwd_args, rd, cd)),
                ("aligned_dec_bwd", lambda cd=cd: lstm_align.dec_bwd(*bwd_args, cd)),
                ("aligned_peer_bwd", lambda cd=cd: lstm_align.peer_bwd(peer, pxs, pwt, php, pcp, dctx, cd)),
                ("aligned_dec_dw", lambda cd=cd: lstm_align.dec_dw(*dw_in, cd)),
                ("aligned_peer_dw", lambda cd=cd: lstm_align.peer_dw(peer, pxs, php, dpg, cd))):
            bcalls.setdefault(f"{name}_bf16", {})["kernel" if cd == BF else "f32_kernel"] = fn
    for name, fn in (
            ("aligned_peer_fwd_bf16", lambda: lstm_align._peer_fwd_reference(peer, pxs, pwt, rd, BF)),
            ("aligned_dec_fwd_bf16", lambda: lstm_ss._forward_reference(*fwd_args, rd, BF)),
            ("aligned_dec_bwd_bf16", lambda: lstm_ss._bwd_recurrence_reference(*bwd_args, step_ctx=True,
                                                                               compute_dtype=BF)),
            ("aligned_peer_bwd_bf16", lambda: lstm_align._peer_bwd_reference(peer, pxs, pwt, php, pcp, dctx, BF)),
            ("aligned_dec_dw_bf16", lambda: lstm_align._dw_reference(*dw_in, BF)),
            ("aligned_peer_dw_bf16", lambda: lstm_align._peer_dw_reference(peer, pxs, php, dpg, BF))):
        bcalls[name]["plain"] = fn
    bcalls["aligned_dec_dw_bf16"]["library"] = dw_library(zs, dgates, BF)
    bcalls["aligned_peer_dw_bf16"]["library"] = lambda: zpb.t() @ dpg2b
    time_bf16_tier(bcalls, {n: (flop.get(n[:-5], flop_of(work[n[:-5]][0])), *work[n[:-5]][1:]) for n in bcalls},
                   [p.w for p in ps] + [peer.w, a["proj_w"]],
                   {"plain": 1, "kernel": 3, "f32_kernel": 3, "library": 3},
                   f"aligned_ss_decode bf16-compute kernels alone (ms, B={TRAIN_B}, K={k}, T={t}, L={layers}, "
                   f"C=H=128, bf16 residuals, Bernoulli coins, CUDA events, against the f32-compute kernels; "
                   f"library: one cuBLAS bmm / matmul on bf16 operands; none computes a recurrence with "
                   f"feedback)", smi)
    report_redesign("aligned_peer_bwd", smi, fma_bound=2 * peer_pass / F32_FLOPS * 1e3)
    report_redesign("aligned_peer_bwd_bf16", smi)
    report_redesign("aligned_peer_fwd", smi, fma_bound=bound(flop_of(work["aligned_peer_fwd"][0]),
                                                             *work["aligned_peer_fwd"][1:])[0])
    report_redesign("aligned_peer_fwd_bf16", smi)
    report_redesign("aligned_dec_bwd", smi, fma_bound=bound(flop_of(work["aligned_dec_bwd"][0]),
                                                            *work["aligned_dec_bwd"][1:])[0],
                    no_library="none (feedback)")
    report_redesign("aligned_dec_bwd_bf16", smi, no_library="none (feedback)")
    report_redesign("aligned_dec_fwd", smi, fma_bound=bound(flop_of(work["aligned_dec_fwd"][0]),
                                                            *work["aligned_dec_fwd"][1:])[0],
                    no_library="none (feedback)")
    report_redesign("aligned_dec_fwd_bf16", smi, no_library="none (feedback)")


# --------------------------------------------------------------- video-fusion: features


def synthetic_clip(seed, frames=CLIP_T, noise=8):
    """A panning textured scene, (frames, CLIP_H, CLIP_W, 3) uint8 from the
    seed: an 8x upsampled random texture plus per-pixel noise in [-noise,
    noise] grey levels, rolled 4 pixels a frame. Without the noise the
    spectrum has exact zeros whose log-amplitude is FFT rounding noise and
    saliency is ill-conditioned (ROADMAP.md, Known divergences): the gated
    check runs on the noisy clip, and a blocky one is only reported."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, (CLIP_H // 8, CLIP_W // 8, 3)).repeat(8, 0).repeat(8, 1)
    base = np.clip(blocks + rng.integers(-noise, noise + 1, blocks.shape), 0, 255).astype(np.uint8)
    clip = np.empty((frames, CLIP_H, CLIP_W, 3), np.uint8)
    for t in range(frames):
        clip[t] = np.roll(base, 4 * t, axis=1)
    return clip


def conv_resize_work(shape, out_hw, c, k=3):
    """(FLOP, bytes) of the conv_resize function: the source rows and columns
    some tap touches (read once), the output written once, the filters; 9
    FLOP a resized pixel and 2·K·K + 2 per output value."""
    b, src_h, src_w = shape
    h, w = out_hw
    rows = len(np.unique(conv_resize.resize_taps(h, src_h)[0]))
    cols = len(np.unique(conv_resize.resize_taps(w, src_w)[0]))
    nbytes = 4 * (b * rows * cols + b * c * h * w + c * (k * k + 1))
    return b * h * w * (9 + c * (2 * k * k + 2)), nbytes


def conv_sector_floor(shape, out_hw, c, sector, k=3):
    """The least bytes the card's memory moves for conv_resize at this shape
    → (bytes, ms at HBM_BYTES): every ``sector``-byte piece of a frame that
    holds a source pixel some tap reads (both taps of every output row and
    column, as the kernel reads them), the output and the filters once. A
    reading beside the bound, which counts each input byte once."""
    b, src_h, src_w = shape
    h, w = out_hw
    rows = np.unique(conv_resize.resize_taps(h, src_h)[0])
    cols = np.unique(conv_resize.resize_taps(w, src_w)[0])
    pieces = np.unique((rows[:, None] * src_w + cols[None, :]) * 4 // sector).size
    nbytes = sector * b * pieces + 4 * (b * c * h * w + c * (k * k + 1))
    return nbytes, nbytes / HBM_BYTES * 1e3


def time_conv_resize(dev, shape, out_hw, c, smi, keep):
    """conv_resize alone at a main-path shape, checked first, against its
    plain version and the library's F.interpolate (bilinear,
    align_corners=False) + F.conv2d + bias + ReLU, in turns; ``keep``: its
    numbers go to the kernels line."""
    rng = np.random.default_rng(12)
    frames = torch.rand(shape, device=dev)
    kernels, bias = randn(rng, dev, (c, 3, 3), 1 / 3), randn(rng, dev, (c,), 0.1)

    def library():
        small = torch.nn.functional.interpolate(frames[:, None], size=out_hw, mode="bilinear",
                                                align_corners=False, antialias=False)
        return torch.relu(torch.nn.functional.conv2d(small, kernels[:, None], padding=1) + bias[None, :, None, None])

    out = conv_resize.fused_conv_resize(frames, out_hw, kernels, bias)
    ref = conv_resize.conv_resize_reference(frames, out_hw, kernels, bias)
    err, lib_err = (out - ref).abs().max().item(), (library() - ref).abs().max().item()
    if not err <= CONV_REL_TOL * ref.abs().max().item():
        raise AssertionError(f"conv_resize at {shape} disagrees with its plain version: {err:.3e}")
    note_err("conv_resize", err)
    ms = in_turns({"plain": lambda: conv_resize.conv_resize_reference(frames, out_hw, kernels, bias),
                   "kernel": lambda: conv_resize.fused_conv_resize(frames, out_hw, kernels, bias),
                   "library": library}, {"plain": 10, "kernel": 50, "library": 50})
    flop, nbytes = conv_resize_work(shape, out_hw, c)
    ops_ms, bytes_ms = flop / F32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    bound_ms, bound_by = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
    if keep:
        TIMES["conv_resize"] = {"ms": ms["kernel"], "plain_ms": ms["plain"], "library_ms": ms["library"],
                                "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"conv_resize alone ({shape[0]} x {shape[1]}x{shape[2]} -> {out_hw[0]}x{out_hw[1]}, C={c}, K=3; ms, CUDA "
          f"events; library F.interpolate + F.conv2d; {smi}): {json.dumps(ms)}; bound {bound_ms:.5f} ms by "
          f"{bound_by} ({nbytes / 1e6:.2f} MB, {flop / 1e9:.3f} GFLOP); max_abs_err vs plain {err:.3e}, "
          f"library vs plain {lib_err:.3e}", flush=True)
    # a call of a few µs of device work is host-bound under CUDA events: the
    # profiler gives the device's own time of the kernel and of the library
    for name, fn in (("kernel", lambda: conv_resize.fused_conv_resize(frames, out_hw, kernels, bias)),
                     ("library", library)):
        profile_device(f"conv_resize {name} at {shape[0]} x {shape[1]}x{shape[2]}", fn, 20, smi)
    kernel_ms, records = launch_device_ms(lambda: conv_resize.fused_conv_resize(frames, out_hw, kernels, bias),
                                          "conv_resize_kernel", 20)
    floors = {n: conv_sector_floor(shape, out_hw, c, n) for n in (32, 64)}
    prev = BEFORE["conv_resize device" + ("" if shape[0] == 64 else " clip")]
    print(f"conv_resize: device time {kernel_ms:.5f} ms a launch (the mean of {records} of 20 profiler records; "
          f"before this design {prev} ms, PERF.md) at {shape[0]} x {shape[1]}x{shape[2]} -> {out_hw[0]}x{out_hw[1]}, "
          f"tiles {tuple(conv_resize.conv_tile(shape[0], *out_hw, c, 3))}; bound {bound_ms:.5f} ms by {bound_by} "
          f"({bound_ms / kernel_ms:.1%} of the device time); sector floor {floors[32][1]:.5f} ms ({floors[32][0] / 1e6:.2f} "
          f"MB in 32-byte sectors, {floors[32][1] / kernel_ms:.1%}), in 64-byte pieces {floors[64][1]:.5f} ms "
          f"({floors[64][0] / 1e6:.2f} MB, {floors[64][1] / kernel_ms:.1%}) ({smi})", flush=True)


def blocky_report(dev, params_cpu):
    """Reported, not gated: the card against the CPU path on a blocky clip
    (no per-pixel noise), where f32 saliency is ill-conditioned; beside it
    the CPU's own f32 against its f64 reading of the same saliency."""
    clip = synthetic_clip(2, frames=8, noise=0)
    params = {k: v.to(dev) for k, v in params_cpu.items()}
    with torch.inference_mode():
        card = equirect.extract_clip_features(params, clip).cpu().numpy()
        cpu = equirect.extract_clip_features(params_cpu, clip).numpy()
        luma = equirect.luminance(torch.as_tensor(clip))
        sal_card = equirect.saliency_map(luma.to(dev)).cpu().double()
        sal_cpu, sal_64 = equirect.saliency_map(luma).double(), equirect.saliency_map(luma.double())
    if not np.isfinite(card).all():
        raise AssertionError("non-finite features on the blocky clip")
    print(f"{FE_PATH}: blocky clip (8 frames, no per-pixel noise; not gated, ill-conditioned): features max "
          f"|card - CPU| {np.abs(card - cpu).max():.3e} of max|CPU| {np.abs(cpu).max():.3e}; saliency max "
          f"|card - CPU| {(sal_card - sal_cpu).abs().max().item():.3e}, |CPU f32 - CPU f64| "
          f"{(sal_cpu - sal_64).abs().max().item():.3e}, |card - CPU f64| {(sal_card - sal_64).abs().max().item():.3e}",
          flush=True)


def frames_per_s(dev, params, clip_host, label, smi):
    """frames/s of one extract_clip_features pass over a clip on the card
    (CUDA events, after one pass that warms the shape's FFT plans) and, for
    a host clip, over the host array with its copy (host clock)."""
    clip = torch.as_tensor(clip_host, device=dev) if isinstance(clip_host, np.ndarray) else clip_host
    n = clip.shape[0]
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats(dev)
        ms_card = cuda_ms(lambda: equirect.extract_clip_features(params, clip), 1)
        peak = torch.cuda.max_memory_allocated(dev)
        line = (f"{FE_PATH}: extract_clip_features on {n} frames of {clip.shape[1]}x{clip.shape[2]} {label} ({smi}): "
                f"{n * 1e3 / ms_card:.1f} frames/s from a clip on the card ({ms_card:.2f} ms, CUDA events; peak "
                f"{peak / 2**30:.2f} GiB)")
        del clip
        if isinstance(clip_host, np.ndarray):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            equirect.extract_clip_features(params, clip_host)
            torch.cuda.synchronize()
            ms_host = (time.perf_counter() - t0) * 1e3
            line += (f", {n * 1e3 / ms_host:.1f} frames/s from host uint8 arrays, the host->card copy included "
                     f"({ms_host:.2f} ms, host clock)")
    print(line, flush=True)


def drive_features(dev, tmp, smi):
    """Phase 10: the two clips through extract-features on the card, the
    features against the CPU path, prepare-data --features → (train, test)
    windows of video-fusion; frames/s of extract_clip_features."""
    frames_dir = f"{tmp}/frames"
    os.makedirs(frames_dir)
    t0 = time.perf_counter()
    clips = [synthetic_clip(seed) for seed in (0, 1)]
    for v, clip in enumerate(clips):
        np.save(f"{frames_dir}/video{v}.npy", clip)
    print(f"{FE_PATH}: two clips of {CLIP_T} frames of {CLIP_H}x{CLIP_W} uint8 ({clips[0].nbytes / 1e9:.2f} GB "
          f"each) written in {time.perf_counter() - t0:.1f} s", flush=True)
    feats_path = f"{tmp}/features.npz"
    t0 = time.perf_counter()
    _, launches = drive(FE_PATH, lambda: cli.main(["extract-features", "--frames-dir", frames_dir, "--out",
                                                   feats_path, "--device", str(dev)]))
    wall = time.perf_counter() - t0
    if launches["conv_resize"] != 2 * len(clips):
        raise AssertionError(f"extract-features launched conv_resize {launches['conv_resize']} times, not 2 a clip")
    with np.load(feats_path) as z:
        feats = {k: z[k] for k in z.files}
    if sorted(feats) != ["video0", "video1"] or not all(
            f.shape == (CLIP_T, 128) and np.isfinite(f).all() for f in feats.values()):
        raise AssertionError(f"extract-features wrote {[(k, v.shape) for k, v in feats.items()]}")
    n_cpu = 24
    params_cpu = equirect.init_conv_features(torch.Generator().manual_seed(0), device="cpu")
    with torch.inference_mode():
        cpu = equirect.extract_clip_features(params_cpu, clips[1][:n_cpu]).numpy()
    d_cpu = float(np.abs(feats["video1"][:n_cpu] - cpu).max())
    print(f"{FE_PATH}: extract-features (2 clips, decode one ahead on a thread) in {wall:.2f} s wall; "
          f"features {feats['video0'].shape} finite; max |card - CPU path| on video1's first {n_cpu} frames "
          f"{d_cpu:.3e} (tolerance {FEAT_REL_TOL} of max|CPU| = {FEAT_REL_TOL * np.abs(cpu).max():.3e})", flush=True)
    if not d_cpu <= FEAT_REL_TOL * np.abs(cpu).max():
        raise AssertionError("the card's features disagree with the CPU path")
    blocky_report(dev, params_cpu)

    # frames/s: the first clip at the phase's 480 x 960, from the card and
    # from the host; 240 frames at 960 x 1920 (a whole 1200-frame clip's
    # FFTs there would take about 72 GiB), made on the card
    params = equirect.init_conv_features(torch.Generator().manual_seed(0), device=dev)
    frames_per_s(dev, params, clips[0], "(the phase's clip)", smi)
    profile_device(f"{FE_PATH}: extract_clip_features, 240 frames from host arrays",
                   lambda: equirect.extract_clip_features(params, torch.as_tensor(clips[0][:240], device=dev)), 2, smi)
    del clips
    gen = torch.Generator(device=dev).manual_seed(3)
    big = torch.randint(0, 256, (240, 960, 1920, 3), generator=gen, device=dev, dtype=torch.uint8)
    frames_per_s(dev, params, big, "(uniform noise made on the card)", smi)
    del big
    torch.cuda.empty_cache()
    time_conv_resize(dev, (CLIP_T, CLIP_H, CLIP_W), (32, 64), 8, smi, keep=False)
    time_conv_resize(dev, (64, 960, 1920), (32, 64), 8, smi, keep=True)

    win_path = f"{tmp}/fusion_windows.npz"
    cli.main(["prepare-data", "--out", win_path, "--features", feats_path])
    train_d, test_d = data.load_packed(win_path), data.load_packed(win_path.replace(".npz", "_test.npz"))
    print(f"{FE_PATH}: prepare-data --features: {len(train_d['past'])} train / {len(test_d['past'])} test "
          f"windows, features {train_d['features'].shape[1:]}", flush=True)
    return (train_d, test_d), launches


# --------------------------------------------------------------- video-fusion: serving


def drive_fu_serving(cfg, dev, params_np, n_single, n_bulk):
    """Single requests and one bulk request with ``features`` through the
    batcher; the answers against the port's plain path on the CPU and the
    numpy oracle given the same context. Then 64 x 128 maps through
    ``serve_fused`` (conv_resize + the serve kernel) at B = 16384, against
    the CPU plain path on its first rows."""
    params = params_from_numpy(params_np, dev)
    params_cpu = params_from_numpy(params_np, "cpu")
    m = cfg.model
    rng = np.random.default_rng(13)
    pasts = unit_pasts(rng, n_single + n_bulk, m.h_in)
    feats = rng.normal(size=(n_single + n_bulk, fusion.FEATURE_DIM)).astype(np.float32)
    requests = [{"past": pasts[i], "features": feats[i]} for i in range(n_single)]
    bulk = {"past": pasts[n_single:], "features": feats[n_single:]}
    bat = serving.DynamicBatcher(lambda b: None, h_in=m.h_in, extra_specs=serving.extra_specs_for(cfg),
                                 required=serving.required_extras_for(cfg))
    try:
        bat.submit(pasts[0])
        raise AssertionError("a request without features was accepted")
    except ValueError:
        pass
    finally:
        bat.stop()

    def both():
        got, stats, _ = serve_batched(cfg, fusion, dev, params, requests, bulk)
        maps = torch.rand((16384, 64, 128), device=dev)
        past_n = windows.normalize_window(unit_rows(rng, dev, (16384, m.h_in)))[0]
        with torch.inference_mode():
            by_maps = fusion.serve_fused(params, m, past_n.contiguous(), maps=maps)
        return got, stats, (maps[:512].cpu(), past_n[:512].cpu(), by_maps[:512].cpu())

    (got, stats, (maps, past_n, by_maps)), launches = drive(FU_SERVE, both, also=["fused_serve_ctx", "conv_resize"])
    xyz = to_xyz(got)
    batch = {"past": pasts, "features": feats}
    plain = infer.make_predict_fn(params_cpu, cfg, device="cpu", impl="plain")(batch).numpy()
    d_plain = float(np.abs(xyz - plain).max())
    with torch.inference_mode():
        ctx = fusion.project_features(params_cpu, torch.as_tensor(feats)).numpy()
        maps_plain = fusion.apply(params_cpu, m, past_n, maps=maps)
    d_oracle = float(np.abs(xyz - oracle.oracle_predict(params_np, m, pasts, context=ctx)).max())
    d_maps = (by_maps - maps_plain).abs().max().item()
    print(f"{FU_SERVE}: {len(requests)} single + 1 bulk ({n_bulk} rows) requests with features in "
          f"{stats['batches']} batches, a request without them refused; max |xyz - CPU plain path| {d_plain:.3e}; "
          f"max |xyz - numpy oracle given the context| {d_oracle:.3e} (tolerance {ORACLE_TOL}); maps mode "
          f"(B=16384, 64x128 maps, conv_resize + fused_serve): max |normalized - CPU plain path| on 512 rows "
          f"{d_maps:.3e} (tolerance {KERNEL_TOL})", flush=True)
    if not (d_plain <= ORACLE_TOL and d_oracle <= ORACLE_TOL and d_maps <= KERNEL_TOL):
        raise AssertionError("video-fusion answers disagree with the plain path or the oracle")
    return params, launches


def fu_serve_call(cfg, params, dev, batch):
    """One serve-bench call of video-fusion: unit-vector pasts and N(0, 1)
    features, as ``cli.serve_bench`` draws them."""
    rng = np.random.default_rng(0)
    x = {"past": unit_rows(rng, dev, (batch, cfg.model.h_in)),
         "features": randn(rng, dev, (batch, fusion.FEATURE_DIM))}
    serve = infer.make_predict_fn(params, cfg, device=dev, with_tiles=True, impl="fused")
    return lambda: serve(x)


def maps_step(cfg, state, dev, smi):
    """One train step of the maps mode at B = 4096 (64 x 128 maps): the conv
    stack trains on conv_resize_reference; its leaves must get a gradient."""
    fam = get_family(cfg.model_family)
    rng = np.random.default_rng(14)
    m = cfg.model
    v = unit_pasts(rng, cfg.batch_size, m.h_in + m.h_out)
    batch = {"past": v[:, :m.h_in], "future": v[:, m.h_in:],
             "maps": rng.random((cfg.batch_size, 64, 128)).astype(np.float32)}
    grad_fn = train.make_grad_fn(cfg, fam.apply, gc_metric=False, **family_fns(fam))
    gen = train.step_generator(cfg, 0, dev)
    (loss, _), grads = grad_fn(state.params, batch, gen, 0.5)
    g = grads["conv"]
    norms = {k: g[k].norm().item() for k in sorted(g)}
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: grad_fn(state.params, batch, train.step_generator(cfg, 0, dev), 0.5), 3)
    print(f"{FU_TRAIN}: one maps-mode step (B={cfg.batch_size}, 64x128 maps): loss {loss.item():.5f}, conv "
          f"gradient norms {json.dumps(norms)}; {ms:.2f} ms a gradient (CUDA events, {smi})", flush=True)
    if not (all(np.isfinite(list(norms.values()))) and norms["kernels"] > 0 and norms["head_w"] > 0):
        raise AssertionError("the maps-mode step gave the conv stack no gradient")


# --------------------------------------------------------------- transformer-30


def encoder_library(params, device):
    """The yardstick of the encoder kernel: ``nn.TransformerEncoder`` (pre-LN,
    eps 1e-6, tanh GELU, no dropout) carrying the encoder's weights, its
    attention biases zero; called on x = past_n · in_proj + pos, the tokens
    after the embedding. Equal to ``transformer._encode`` for any
    weights (tests/test_torch_transformer_encode.py). Timed here, never
    called by the port."""
    import functools

    enc = params["enc"]
    h = params["in_proj"].shape[1]
    layer = torch.nn.TransformerEncoderLayer(
        h, transformer.N_HEADS, dim_feedforward=transformer.MLP_MULT * h, dropout=0.0,
        activation=functools.partial(torch.nn.functional.gelu, approximate="tanh"), layer_norm_eps=1e-6,
        batch_first=True, norm_first=True)
    net = torch.nn.TransformerEncoder(layer, num_layers=len(enc), enable_nested_tensor=False).to(device)
    with torch.no_grad():
        for mod, p in zip(net.layers, enc):
            a = p["attn"]
            mod.self_attn.in_proj_weight.copy_(torch.cat([a["wq"].t(), a["wk"].t(), a["wv"].t()]))
            mod.self_attn.in_proj_bias.zero_()
            mod.self_attn.out_proj.weight.copy_(a["wo"].t())
            mod.self_attn.out_proj.bias.zero_()
            mod.linear1.weight.copy_(p["mlp"]["w1"].t())
            mod.linear1.bias.copy_(p["mlp"]["b1"])
            mod.linear2.weight.copy_(p["mlp"]["w2"].t())
            mod.linear2.bias.copy_(p["mlp"]["b2"])
            for norm, ln in ((mod.norm1, p["ln1"]), (mod.norm2, p["ln2"])):
                norm.weight.copy_(ln["scale"])
                norm.bias.copy_(ln["bias"])
    net.requires_grad_(False).eval()
    return net


def tf_case(dev, batch, t_in, t_out, layers=2, k=0, pool="none", window=0, seed=0):
    """transformer-30's width (H = 128, 4 heads) with random weights (init's
    limits, LN scales and biases moved off 1 and 0 so that they count),
    unit-vector pasts drawn on the card, normalized, the plain encoder
    memory and, with ``k`` peers, their tokens under a mask with a row of no
    valid peer, a row of one, the rest valid → (model cfg, params, past_n,
    enc_mem, y0, peer_mem, peer_valid)."""
    m = get_preset(TF_PRESET, model_h_in=t_in, model_h_out=t_out, model_layers=layers, model_peer_pool=pool,
                   model_peer_window=window).model
    rng = np.random.default_rng(seed)
    params = transformer.init(torch.Generator().manual_seed(seed), m, device=dev)
    for leaf in [v for lay in params["enc"] + params["dec"] for sub in lay.values()
                 for key, v in sub.items() if key in ("scale", "bias", "b1", "b2")]:
        leaf += randn(rng, dev, leaf.shape, 0.1)
    past = unit_rows(rng, dev, (batch, t_in))
    past_n, _, anchor = windows.normalize_window(past)
    past_n = past_n.contiguous()
    enc = transformer._encode(params, m, past_n)
    pm = pv = None
    if k:
        others = unit_rows(rng, dev, (batch, k, t_out)) - anchor[:, None]
        mask = torch.ones((batch, k), device=dev)
        mask[0] = 0.0
        mask[1, 1:] = 0.0
        pm, pv = (x.contiguous() for x in transformer._peer_tokens(params, m, others, mask))
    return m, params, past_n, enc, past_n[:, -1].contiguous(), pm, pv


def check_tf_encode(dev, batch, t, layers, seed, repeat=False):
    """fused_encode_tokens against transformer._encode (with ``repeat``, a
    second call bit-equal) → max abs error."""
    m, params, past_n, enc, *_ = tf_case(dev, batch, t, 4, layers, seed=seed)
    out = transformer_encode.fused_encode_tokens(params, m, past_n)
    torch.cuda.synchronize()
    err = (out - enc).abs().max().item()
    if out.shape != enc.shape or not torch.isfinite(out).all() or not err <= TF_TOL:
        raise AssertionError(f"fused_encode_tokens disagrees with its plain version (B={batch}, T={t}, "
                             f"L={layers}): {err:.3e}")
    if repeat and not torch.equal(out, transformer_encode.fused_encode_tokens(params, m, past_n)):
        raise AssertionError(f"fused_encode_tokens at B={batch} differs on repeat")
    note_err("fused_encode_tokens", err)
    return err


def check_tf_decode(dev, batch, k, pool, window, seed, t=30):
    """fused_ar_decode against transformer._ar_decode on the same memory →
    max abs error; with peers, the row with no valid peer must equal the
    peerless rollout; a repeat must be bit-equal."""
    m, params, _, enc, y0, pm, pv = tf_case(dev, batch, t, t, 2, k, pool, window, seed)
    out = transformer_decode.fused_ar_decode(params, m, enc, y0, peer_mem=pm, peer_valid=pv)
    torch.cuda.synchronize()
    if not torch.equal(out, transformer_decode.fused_ar_decode(params, m, enc, y0, peer_mem=pm, peer_valid=pv)):
        raise AssertionError(f"fused_ar_decode at B={batch} differs on repeat (K={k}, pool={pool}, window={window})")
    ref = transformer._ar_decode(params, m, enc, pm, pv, y0)
    err = (out - ref).abs().max().item()
    if out.shape != (batch, t, 3) or not torch.isfinite(out).all() or not err <= TF_TOL:
        raise AssertionError(f"fused_ar_decode disagrees with its plain version (B={batch}, K={k}, pool={pool}, "
                             f"window={window}): {err:.3e}")
    if k:
        alone = transformer_decode.fused_ar_decode(params, m, enc, y0)
        d0 = (out[0] - alone[0]).abs().max().item()
        if not d0 <= TF_TOL:
            raise AssertionError(f"a row with no valid peer differs from the peerless rollout: {d0:.3e}")
    note_err("fused_ar_decode", err)
    return err


def shared_groups(dev, params, m, batch, t, rng):
    """G = 3 peer groups of 4 unit-vector tracks (group 1 with two peers
    masked, group 2 with all) and an unsorted gid giving them 1 row, 37 rows
    and the rest → (group memory, its validity, gid)."""
    gmask = torch.ones((3, 4), device=dev)
    gmask[1, 2:] = 0.0
    gmask[2] = 0.0
    gmem, gvalid = (x.contiguous() for x in transformer._peer_tokens(params, m, unit_rows(rng, dev, (3, 4, t)),
                                                                     gmask))
    gid = np.full(batch, 2)
    gid[0], gid[1:38] = 0, 1
    return gmem, gvalid, torch.tensor(rng.permutation(gid), device=dev)


def check_tf_shared(dev, batch, t, pool, window, with_dv, seed):
    """The shared tier against the plain shared decode (each row's group's
    K/V, δv subtracted) → max abs error. G = 3 groups of 1 row, 37 rows and
    the rest under an unsorted gid; the last group has every peer masked and
    its rows must equal the peerless rollout; without δv the tier must equal
    the per-row kernel on gathered copies."""
    m, params, _, enc, y0, *_ = tf_case(dev, batch, t, t, 2, 0, pool, window, seed)
    rng = np.random.default_rng(seed)
    gmem, gvalid, gid = shared_groups(dev, params, m, batch, t, rng)
    dv = randn(rng, dev, (batch, 2, m.hidden), 0.1) if with_dv else None
    out = transformer_decode.fused_ar_decode_shared(params, m, enc, y0, peer_gmem=gmem, peer_gvalid=gvalid,
                                                    peer_gid=gid, peer_dv=dv)
    torch.cuda.synchronize()
    if not torch.equal(out, transformer_decode.fused_ar_decode_shared(params, m, enc, y0, peer_gmem=gmem,
                                                                      peer_gvalid=gvalid, peer_gid=gid, peer_dv=dv)):
        raise AssertionError(f"the shared tier at B={batch} differs on repeat")
    ref = transformer._ar_decode(params, m, enc, gmem, gvalid, y0, peer_gid=gid, peer_dv=dv)
    err = (out - ref).abs().max().item()
    alone = transformer_decode.fused_ar_decode(params, m, enc, y0)
    d_masked = (out[gid == 2] - alone[gid == 2]).abs().max().item()
    d_rows = 0.0
    if not with_dv:
        rows = transformer_decode.fused_ar_decode(params, m, enc, y0, peer_mem=gmem[gid].contiguous(),
                                                  peer_valid=gvalid[gid].contiguous())
        d_rows = (out - rows).abs().max().item()
    if out.shape != (batch, t, 3) or not torch.isfinite(out).all() or not max(err, d_masked, d_rows) <= TF_TOL:
        raise AssertionError(f"the shared tier disagrees (B={batch}, {t}+{t}, pool={pool}, window={window}, "
                             f"dv={with_dv}): vs plain {err:.3e}, masked group vs peerless {d_masked:.3e}, vs the "
                             f"per-row kernel {d_rows:.3e}")
    note_err("fused_ar_decode_shared", err)
    return err


def check_tf_bf16(dev, batch, t, k, pool, window, seed):
    """The bf16 tiers against their bf16 plain versions (BF16_TOL) and the
    f32 plain versions (BF16_F32_TOL): the encoder where it runs a kernel
    (T <= 64), the per-row decode on the f32 plain encoder memory; with
    peers, the row with no valid peer against the peerless bf16 rollout →
    the errors."""
    bf16 = torch.bfloat16
    m, params, past_n, enc, y0, pm, pv = tf_case(dev, batch, t, t, 2, k, pool, window, seed)
    errs = {}
    floor = None
    if transformer_encode.encode_kernel_fits(t):
        enc_k = transformer_encode.fused_encode_tokens(params, m, past_n, compute_dtype=bf16)
        torch.cuda.synchronize()
        readings = check_outputs("fused_encode_tokens", [enc_k], [[transformer._encode(params, m, past_n, bf16)],
                                                                  [enc]], f"B={batch} T={t}", "tf_encode", cd=BF)
        errs["encode"], errs["encode_vs_f32"], floor = readings["bf16"], readings["f32"], readings["floor"]
        if not torch.equal(enc_k, transformer_encode.fused_encode_tokens(params, m, past_n, compute_dtype=bf16)):
            raise AssertionError(f"fused_encode_tokens_bf16 (B={batch}, T={t}) differs on repeat")
    out = transformer_decode.fused_ar_decode(params, m, enc, y0, peer_mem=pm, peer_valid=pv, compute_dtype=bf16)
    torch.cuda.synchronize()
    errs["decode"] = (out - transformer._ar_decode(params, m, enc, pm, pv, y0, compute_dtype=bf16)).abs().max().item()
    errs["decode_vs_f32"] = (out - transformer._ar_decode(params, m, enc, pm, pv, y0)).abs().max().item()
    if k:
        alone = transformer_decode.fused_ar_decode(params, m, enc, y0, compute_dtype=bf16)
        errs["no_peer_row"] = (out[0] - alone[0]).abs().max().item()
    note_err("fused_ar_decode_bf16", errs["decode"])
    if not torch.isfinite(out).all() or not all(v <= (BF16_F32_TOL if key.endswith("f32") else BF16_TOL)
                                                 for key, v in errs.items()):
        raise AssertionError(f"a bf16 tier disagrees (B={batch}, {t}+{t}, K={k}, pool={pool}, window={window}): "
                             f"{json.dumps(errs)}")
    if floor is not None:
        errs["encode_floor"] = floor
    return errs


def check_tf_shared_bf16(dev, batch, t, pool, window, seed):
    """The shared tier's bf16 instance with δv, G = 3 groups as in
    check_tf_shared, against the plain shared decode in bf16 (BF16_TOL) and
    in f32 (BF16_F32_TOL) → the errors."""
    bf16 = torch.bfloat16
    m, params, _, enc, y0, *_ = tf_case(dev, batch, t, t, 2, 0, pool, window, seed)
    rng = np.random.default_rng(seed)
    gmem, gvalid, gid = shared_groups(dev, params, m, batch, t, rng)
    dv = randn(rng, dev, (batch, 2, m.hidden), 0.1)
    out = transformer_decode.fused_ar_decode_shared(params, m, enc, y0, peer_gmem=gmem, peer_gvalid=gvalid,
                                                    peer_gid=gid, peer_dv=dv, compute_dtype=bf16)
    torch.cuda.synchronize()
    errs = {}
    for tier, key in ((bf16, "decode"), (torch.float32, "decode_vs_f32")):
        ref = transformer._ar_decode(params, m, enc, gmem, gvalid, y0, peer_gid=gid, peer_dv=dv, compute_dtype=tier)
        errs[key] = (out - ref).abs().max().item()
    note_err("fused_ar_decode_bf16", errs["decode"])
    if not torch.isfinite(out).all() or not (errs["decode"] <= BF16_TOL and errs["decode_vs_f32"] <= BF16_F32_TOL):
        raise AssertionError(f"the bf16 shared tier disagrees (B={batch}, {t}+{t}, pool={pool}, window={window}): "
                             f"{json.dumps(errs)}")
    return errs


def check_encode_train(dev, batch, t, layers, seed, repeat=False):
    """fused_encode_train's three kernels against their plain versions: the
    forward and its stash within TF_TOL, every gradient (past_n, in_proj and
    each encoder leaf) against autograd through _encode within GRAD_TOL ·
    max(|g|, 1), the reduction equal to the block-order sum of the same
    partials; with ``repeat``, a second run's gradients bit-equal → the
    errors."""
    m, params, past_n, *_ = tf_case(dev, batch, t, 4, layers, seed=seed)
    rng = np.random.default_rng(seed)
    leaves = [params["in_proj"]] + [lay[sub][leaf] for lay in params["enc"] for sub, leaf in encode_train._ENC_LEAVES]
    cot = randn(rng, dev, (batch, t, m.hidden))
    enc_k, stash_k = encode_train.encode_train_fwd(m, past_n, leaves[0], leaves[1:])
    enc_p, stash_p = encode_train._stash_reference(m, past_n, leaves[0], leaves[1:])
    err_f = max((enc_k - enc_p).abs().max().item(), (stash_k - stash_p).abs().max().item())
    _, parts = encode_train.encode_train_bwd(m, past_n, leaves[0], leaves[1:], stash_k, cot, True)
    err_dw = (encode_train.encode_train_dw(parts) - encode_train._dw_reference(parts)).abs().max().item()
    del stash_k, stash_p, parts
    for x in leaves:
        x.requires_grad_(True)
    past = past_n.clone().requires_grad_(True)

    def grads(fn):
        return torch.autograd.grad((fn(params, m, past) * cot).sum(), [past, *leaves])

    got, want = grads(encode_train.fused_encode_train), grads(transformer._encode)
    torch.cuda.synchronize()
    err_b = max((a - b).abs().max().item() for a, b in zip(got, want))
    rel_b = max((a - b).abs().max().item() / max(b.abs().max().item(), 1.0) for a, b in zip(got, want))
    same = all(torch.equal(a, b) for a, b in zip(got, grads(encode_train.fused_encode_train))) if repeat else None
    if not (err_f <= TF_TOL and rel_b <= GRAD_TOL and err_dw == 0.0 and same is not False):
        raise AssertionError(f"fused_encode_train disagrees (B={batch}, T={t}, L={layers}): forward {err_f:.3e}, "
                             f"gradients {rel_b:.3e} of max(|g|, 1), reduction {err_dw:.3e}, repeat bit-equal {same}")
    for name, e in (("encode_train_fwd", err_f), ("encode_train_bwd", err_b), ("encode_train_dw", err_dw)):
        note_err(name, e)
    return {"forward": err_f, "grad_abs": err_b, "grad_rel": rel_b, "reduction": err_dw, "repeat_bit_equal": same}


def drive_tf_serving(cfg, dev, params_np, n_single, n_bulk, path=TF_SERVE, also=(), tier=torch.bfloat16):
    """Single requests that all carry ``other_future``: K peers, two (the
    batcher pads and masks the rest), or K with an explicit all-zero mask
    (no valid peer); one bulk request with an explicit random mask; through
    the batcher in front of the encoder (fused_encode_tokens where T <= 64,
    else the plain _encode) and fused_ar_decode. ``tier``: bf16, the serving
    default on the card (the family as it is), or an explicit f32. Every
    answer against the port's plain path on the CPU in the same tier: the
    bf16 plain versions (serve_fused in bf16 on CPU tensors) within
    BF16_ANSWER_TOL, the f32 plain path (apply) within ORACLE_TOL."""
    params = params_from_numpy(params_np, dev)
    fam = transformer if tier == torch.bfloat16 else tier_family(tier)
    m, k = cfg.model, cfg.n_other_users
    rng = np.random.default_rng(15)
    pasts = unit_pasts(rng, n_single + n_bulk, m.h_in)
    others = unit_pasts(rng, (n_single + n_bulk) * k, m.h_out).reshape(-1, k, m.h_out, 3)
    mask = np.ones((n_single + n_bulk, k), np.float32)
    requests = []
    for i in range(n_single):
        kind = i % 3  # K peers, two peers, K peers all masked
        r = {"past": pasts[i], "other_future": others[i]}
        if kind == 1:
            others[i, 2:] = 0.0
            mask[i, 2:] = 0.0
            r["other_future"] = others[i, :2]
        if kind == 2:
            mask[i] = 0.0
            r["other_mask"] = mask[i]
        requests.append(r)
    mask[n_single:] = (rng.random((n_bulk, k)) < 0.6).astype(np.float32)
    bulk = {"past": pasts[n_single:], "other_future": others[n_single:], "other_mask": mask[n_single:]}
    (got, stats, _), launches = drive(path, lambda: serve_batched(cfg, fam, dev, params, requests, bulk), also)
    batch = {"past": pasts, "other_future": others, "other_mask": mask}
    cpu_params = params_from_numpy(params_np, "cpu")
    if tier == torch.bfloat16:
        with torch.inference_mode():
            plain = infer.predict_xyz(cpu_params, cfg, tier_family(tier),
                                      {key: torch.as_tensor(v) for key, v in batch.items()}, impl="fused")
        tol = BF16_ANSWER_TOL
    else:
        plain = infer.make_predict_fn(cpu_params, cfg, device="cpu", impl="plain")(batch)
        tol = ORACLE_TOL
    d_plain = float(np.abs(to_xyz(got) - plain.numpy()).max())
    print(f"{path}: {n_single} single requests with other_future (K={k}, 2, and K all masked) + 1 bulk "
          f"({n_bulk} rows, explicit mask) in {stats['batches']} batches, serving in {str(tier)[6:]}; max |xyz - "
          f"CPU plain path in {str(tier)[6:]}| {d_plain:.3e} (tolerance {tol})", flush=True)
    if not d_plain <= tol:
        raise AssertionError(f"{cfg.name} answers disagree with the CPU plain path")
    return params, launches


def tf_work(m, batch, kt, attended):
    """FLOP of the encoder and of the decode at width H for ``batch`` rows →
    (encoder, decode). The decode counts its cross and peer K/V projections
    (``kt`` peer tokens a row) and the attention over what this run's data
    attends: ``attended`` peer tokens, summed over rows and steps."""
    h, t_in, t_out, layers, d = m.hidden, m.h_in, m.h_out, m.layers, m.d
    enc = 2 * batch * t_in * (d * h + layers * (12 * h * h + 2 * t_in * h))
    cache_rows = batch * t_out * (t_out + 1) // 2  # step t attends t + 1 cache rows
    products = (16 if kt else 14) * h * h
    dec = 2 * layers * (batch * t_out * (products + 2 * t_in * h) + 2 * h * cache_rows + 2 * h * attended)
    dec += 2 * batch * t_out * 2 * d * h  # output projection and the fed-back token's embedding
    dec += 2 * layers * 2 * h * h * batch * (t_in + kt)  # the cross and peer K, V
    return enc, dec


def reread_ms(m, batch, attended, tier=torch.bfloat16):
    """The re-read floor of a decode that keeps the K/V in device memory
    (a row's K/V does not fit a block's shared memory): every step reads
    its self cache rows (t at step t), the T_in cross tokens and this run's
    ``attended`` peer tokens (summed over rows and steps) again, K and V in
    the tier's type, every layer, over the memory rate → ms."""
    tokens = batch * (m.h_out * (m.h_out - 1) // 2 + m.h_in * m.h_out) + attended
    return m.layers * tokens * 2 * m.hidden * torch.finfo(tier).bits // 8 / HBM_BYTES * 1e3


def decode_work(m, batch, flop, kt, tier):
    """The decode's work by type for bound(): in bf16 every FLOP at the bf16
    tensor-core peak; in f32 the kernel's matrix products (16 or 14 H x H
    a row-layer-step) as three-pass TF32, the rest (the attention, in_proj
    and out_proj, and the wrapper's exact-f32 K/V projections) on the FMA
    units."""
    if tier == torch.bfloat16:
        return flop
    products = 2 * m.layers * batch * m.h_out * (16 if kt else 14) * m.hidden ** 2
    return tf32_work(flop, products)


def stored(tensors, tier):
    """The tensors as the tier stores them: bf16 matrices (the 2-D leaves) in
    the bf16 tier, for its byte count."""
    return [t.to(tier) if t.dim() == 2 else t for t in tensors]


def time_tf_kernels(dev, params, cfg, batch, smi, keep):
    """Both transformer kernels alone, in both tiers, at a serving batch with
    K peers, checked first, against their plain versions in the same tier
    (the encoder also against the nn.TransformerEncoder yardstick, in the
    tier's type), in turns; ``keep``: their numbers go to the kernels line.
    The decode has no library call (AR decode with feedback). Bytes: every
    input read once (past, weights in the tier's type; the decode's encoder
    memory, peer tokens and validity, y0), every output written once; FLOP:
    tf_work, the decode's peer K/V projections included, over the f32 FMA
    peak or, in bf16, the bf16 tensor-core peak."""
    m, k = cfg.model, cfg.n_other_users
    rng = np.random.default_rng(16)
    past_n, _, anchor = windows.normalize_window(unit_rows(rng, dev, (batch, m.h_in)))
    past_n = past_n.contiguous()
    others = unit_rows(rng, dev, (batch, k, m.h_out)) - anchor[:, None]  # as batch_extras anchors them
    net = encoder_library(params, dev)
    emb = past_n @ params["in_proj"] + transformer._pos_enc(m.h_in, m.hidden, device=dev)
    pm, pv = (x.contiguous() for x in transformer._peer_tokens(params, m, others, None))
    y0 = past_n[:, -1].contiguous()
    enc_flop, dec_flop = tf_work(m, batch, pm.shape[1], int(pv.sum()) * m.h_out)
    with torch.inference_mode():
        mem = transformer._encode(params, m, past_n)  # the f32 plain encoder memory
    for tier, sfx, tol, peak in ((torch.float32, "", TF_TOL, F32_FLOPS), (torch.bfloat16, "_bf16", BF16_TOL,
                                                                          BF16_FLOPS)):
        lib_net, lib_emb = (net, emb) if tier == torch.float32 else (encoder_library(params, dev).to(tier),
                                                                    emb.to(tier))
        with torch.inference_mode():
            enc = transformer_encode.fused_encode_tokens(params, m, past_n, compute_dtype=tier)
            ref = transformer._encode(params, m, past_n, tier)
            err_e = (enc - ref).abs().max().item()
            lib_err = (lib_net(lib_emb).float() - ref).abs().max().item()
            if tier == torch.bfloat16:  # as in phase 3: against both plain versions, the floor, a repeat
                enc_readings = check_outputs("fused_encode_tokens", [enc], [[ref], [mem]], f"B={batch}", "tf_encode",
                                             cd=BF)
                if not torch.equal(enc, transformer_encode.fused_encode_tokens(params, m, past_n, compute_dtype=tier)):
                    raise AssertionError(f"fused_encode_tokens_bf16 at B={batch} differs on repeat")
            elif not err_e <= tol:
                raise AssertionError(f"fused_encode_tokens{sfx} at B={batch} disagrees with its plain version: "
                                     f"{err_e:.3e}")
            note_err(f"fused_encode_tokens{sfx}", err_e)
            ms_e = in_turns({"plain": lambda: transformer._encode(params, m, past_n, tier),
                             "kernel": lambda: transformer_encode.fused_encode_tokens(params, m, past_n,
                                                                                      compute_dtype=tier),
                             "library": lambda: lib_net(lib_emb)}, {"plain": 2, "kernel": 3, "library": 3})
            # the decode on the f32 plain encoder memory, as check_tf_bf16
            out = transformer_decode.fused_ar_decode(params, m, mem, y0, peer_mem=pm, peer_valid=pv,
                                                     compute_dtype=tier)
            err_d = (out - transformer._ar_decode(params, m, mem, pm, pv, y0, compute_dtype=tier)).abs().max().item()
            if not err_d <= tol:
                raise AssertionError(f"fused_ar_decode{sfx} at B={batch} disagrees with its plain version: "
                                     f"{err_d:.3e}")
            note_err(f"fused_ar_decode{sfx}", err_d)
            ms_d = in_turns({"plain": lambda: transformer._ar_decode(params, m, mem, pm, pv, y0, compute_dtype=tier),
                             "kernel": lambda: transformer_decode.fused_ar_decode(params, m, mem, y0, peer_mem=pm,
                                                                                peer_valid=pv, compute_dtype=tier)},
                            {"plain": 1, "kernel": 2})
        weights = stored(tree_leaves(params), tier)
        enc_work = enc_flop if tier == BF else tf32_work(enc_flop, 2 * batch * m.h_in * m.layers * 12 * m.hidden ** 2)
        io = {f"fused_encode_tokens{sfx}": (enc_work, [past_n] + stored(
                  [params["in_proj"]] + tree_leaves(params["enc"]), tier), [enc]),
              f"fused_ar_decode{sfx}": (decode_work(m, batch, dec_flop, pm.shape[1], tier), [mem, y0, pm, pv]
                                        + weights, [out])}
        for name, ms, err in ((f"fused_encode_tokens{sfx}", ms_e, err_e), (f"fused_ar_decode{sfx}", ms_d, err_d)):
            b_ms, b_by = bound(io[name][0], *io[name][1:], peak)
            if keep:
                record(name, ms, *io[name], peak)
            print(f"{name} alone (B={batch}, L={m.layers}, {m.h_in}+{m.h_out} steps, K={k}: {pm.shape[1]} peer "
                  f"tokens; ms, CUDA events, {smi}): {json.dumps(ms)}; bound {b_ms:.3f} ms by {b_by} "
                  f"({flop_of(io[name][0]) / ms['kernel'] / 1e9:.2f} TFLOP/s); max_abs_err vs plain {err:.3e} (tolerance "
                  f"{tol})" + (f"; library nn.TransformerEncoder ({str(tier)[6:]}) vs plain {lib_err:.3e}"
                               if name.startswith("fused_encode") else "; library: none (AR decode with feedback)"),
                  flush=True)
            if name == "fused_encode_tokens_bf16":
                enc_bf16 = {"ms": ms["kernel"], "library_ms": ms["library"], "bound_ms": b_ms, "bound_by": b_by}
            elif name == "fused_encode_tokens":
                report_redesign(name, smi, {"ms": ms["kernel"], "library_ms": ms["library"]}, io[name])
            elif name.startswith("fused_ar_decode"):
                report_redesign(name, smi, {"ms": ms["kernel"], "library_ms": None, "bound_ms": b_ms,
                                            "bound_by": b_by}, no_library="none (AR decode with feedback)",
                                fma_bound=None if tier == BF else bound(dec_flop, *io[name][1:])[0],
                                extra=f"; the K/V re-read floor "
                                      f"{reread_ms(m, batch, int(pv.sum()) * m.h_out, tier):.3f} ms")
    report_encode_bf16(enc_bf16, enc_readings, params, m, past_n, smi)


def probe_split(read, fn, blocks, calls=2):
    """The time split of a probe build's kernel: ``fn`` launches it, ``read``
    copies out and zeroes the clock counters (tfm::Part order). The first
    call's counts are dropped, then ``calls`` + 1 calls are counted → (ms a
    call, each part's share of the clocks summed over the blocks, clocks a
    block a call)."""
    buf = (ctypes.c_ulonglong * len(PROBE_PARTS))()
    fn()
    torch.cuda.synchronize()
    read(buf)
    ms = cuda_ms(fn, calls)
    read(buf)
    total = sum(buf)
    return ms, {part: round(v / total, 4) for part, v in zip(PROBE_PARTS, buf) if v}, total / (calls + 1) / blocks


def probe_lib(build, bind, read):
    """A probe build's library, typed: ``bind`` (the wrapper module's) and
    its counters' ``read`` entry point."""
    lib = bind(ctypes.CDLL(str(build.path)))
    getattr(lib, read).argtypes = [ctypes.c_void_p]
    return lib


def encode_split(params, m, past_n, tier=F32):
    """The time split of row 10's tier of ``tier`` in its probe build
    (PROBE_BUILD) on these inputs → (ms, split, clocks a block)."""
    lib = probe_lib(PROBE_BUILD, transformer_encode.bind, "transformer_encode_probe_read")
    tensors, _ = transformer_encode.layer_pointers(params["enc"], transformer_encode._ENC_LEAVES, m.hidden)
    pos = transformer._pos_enc(m.h_in, m.hidden, device=past_n.device)
    with torch.inference_mode():
        return probe_split(lib.transformer_encode_probe_read,
                           lambda: transformer_encode.launch(lib, tensors, params["in_proj"], pos, past_n, tier),
                           -(-past_n.shape[0] // (64 // m.h_in)))


def encode_train_splits(params, m, past_n, cot):
    """The time splits of row 11's forward with the stash and its reverse
    (``cot``, the cotangent of enc_mem) in their probe build
    (PROBE_TRAIN_BUILD) on these inputs → {kernel: (ms, split, clocks a
    block)}."""
    from unittest import mock

    lib = probe_lib(PROBE_TRAIN_BUILD, encode_train.bind, "transformer_encode_train_probe_read")
    leaves = [lay[sub][leaf] for lay in params["enc"] for sub, leaf in encode_train._ENC_LEAVES]
    blocks = -(-past_n.shape[0] // (64 // m.h_in))

    def fwd():
        return encode_train.encode_train_fwd(m, past_n, params["in_proj"], leaves)

    with torch.inference_mode(), mock.patch.object(encode_train, "_library", lambda: lib):
        stash = fwd()[1]
        return {"encode_train_fwd": probe_split(lib.transformer_encode_train_probe_read, fwd, blocks),
                "encode_train_bwd": probe_split(
                    lib.transformer_encode_train_probe_read,
                    lambda: encode_train.encode_train_bwd(m, past_n, params["in_proj"], leaves, stash, cot, True),
                    blocks)}


def time_encode_f32(dev, params, cfg, batch, smi, before):
    """Row 10's f32 tier alone at a larger serving batch, checked first,
    against its plain version and nn.TransformerEncoder in turns, beside its
    FMA design's time there (BEFORE[``before``], PERF.md)."""
    m = cfg.model
    rng = np.random.default_rng(19)
    past_n = windows.normalize_window(unit_rows(rng, dev, (batch, m.h_in)))[0].contiguous()
    net = encoder_library(params, dev)
    emb = past_n @ params["in_proj"] + transformer._pos_enc(m.h_in, m.hidden, device=dev)
    with torch.inference_mode():
        enc = transformer_encode.fused_encode_tokens(params, m, past_n)
        err = (enc - transformer._encode(params, m, past_n)).abs().max().item()
        if not err <= TF_TOL:
            raise AssertionError(f"fused_encode_tokens at B={batch} disagrees with its plain version: {err:.3e}")
        note_err("fused_encode_tokens", err)
        ms = in_turns({"plain": lambda: transformer._encode(params, m, past_n),
                       "kernel": lambda: transformer_encode.fused_encode_tokens(params, m, past_n),
                       "library": lambda: net(emb)}, {"plain": 1, "kernel": 3, "library": 3})
    flop = tf_work(m, batch, 0, 0)[0]
    print(f"fused_encode_tokens alone (B={batch}, L={m.layers}, T={m.h_in}; ms, CUDA events, {smi}): "
          f"{json.dumps(ms)}; max_abs_err vs plain {err:.3e} (tolerance {TF_TOL})", flush=True)
    report_redesign("fused_encode_tokens", smi, {"ms": ms["kernel"], "library_ms": ms["library"]},
                    (tf32_work(flop, 2 * batch * m.h_in * m.layers * 12 * m.hidden ** 2),
                     [past_n, params["in_proj"]] + tree_leaves(params["enc"]), [enc]), before)


def report_f32_splits(dev, smi):
    """Phase 3: the time splits of the f32 encoder's probe builds at the main
    paths' shapes (row 10 at B = 16384, row 11's two kernels at B = 4096;
    T = 30, L = 2), each beside the FMA design's (ENC_F32_SPLIT_BEFORE)."""
    m, params, past_n, *_ = tf_case(dev, 16384, 30, 4, 2, seed=0)
    splits = {"fused_encode_tokens": encode_split(params, m, past_n)}
    m, params, past_n, *_ = tf_case(dev, TRAIN_B, 30, 4, 2, seed=0)
    cot = randn(np.random.default_rng(0), dev, (TRAIN_B, 30, m.hidden))
    splits.update(encode_train_splits(params, m, past_n, cot))
    for name, (ms, split, clocks) in splits.items():
        print(f"{name} time split (probe build, {ms:.3f} ms a call, {clocks:.0f} clocks a block; thread 0's "
              f"clock64 a part, summed over the blocks; {smi}): {json.dumps(split)}; the FMA design's (PERF.md): "
              f"{json.dumps(ENC_F32_SPLIT_BEFORE[name])}", flush=True)


def report_encode_bf16(t, readings, params, m, past_n, smi):
    """Row 10b on the tensor cores (report_redesign, the library
    nn.TransformerEncoder in bf16): with the readings of check_outputs and
    the time split of the probe build (in-kernel clock64 of thread 0 of
    every block, each part's share of the clocks summed over the blocks)."""
    probe_ms, split, clocks = encode_split(params, m, past_n, BF)
    report_redesign("fused_encode_tokens_bf16", smi, t, extra=(
        f"; largest gap to the bf16 plain version {readings['bf16']:.3e}, to f32 {readings['f32']:.3e}, floor "
        f"{readings['floor']:.4f}; a repeat bit-equal; split of the probe build ({probe_ms:.3f} ms a call, "
        f"{clocks:.0f} clocks a block): {json.dumps(split)}"))


def tf_grad_check(cfg, state, train_d):
    """One step's loss and gradients on the same batch with the same
    noisy-teacher-forcing noise (N(0, 1) from numpy, swapped in for the
    generator's draw on both sides) at a mid-anneal teacher_prob: through
    the kernels on the card (``train_impl`` "auto": fused_encode_train)
    against the CPU port's (the same hooks, autograd through _encode there),
    and against plain autograd on the card ("xla"); within
    STEP_REL_TOL["float32"] of max|reference| per leaf (f32 on both sides,
    sums in another order)."""
    fam = transformer
    batch = next(train.batch_iterator(train_d, 512, seed=4))
    noise = torch.from_numpy(np.random.default_rng(17).normal(size=(512, cfg.model.h_out, 3)).astype(np.float32))
    draw = fam.draw_noise
    fam.draw_noise = lambda gen, shape: noise.to(gen.device)
    fns = family_fns(fam)
    try:
        tp = train.teacher_prob_at(cfg, cfg.steps // 2)
        cpu = tree_unflatten(state.params, [p.cpu() for p in tree_leaves(state.params)])
        res = {}
        for where, c, params in (("card", cfg, state.params), ("cpu", cfg, cpu),
                                 ("card_xla", cfg.replace(train_impl="xla"), state.params)):
            grad_fn = train.make_grad_fn(c, fam.apply, gc_metric=False, **fns)
            res[where] = grad_fn(params, batch, torch.Generator(device=params["in_proj"].device), tp)
    finally:
        fam.draw_noise = draw
    (l_k, _), g_k = res["card"]
    out, rel = {}, STEP_REL_TOL["float32"]
    for ref in ("cpu", "card_xla"):
        (l_p, _), g_p = res[ref]
        out[ref] = {"loss": abs(l_k.item() - l_p.item()) / abs(l_p.item()),
                    "grads": max((a.cpu() - b.cpu()).abs().max().item() / (b.abs().max().item() or 1.0)
                                 for a, b in zip(tree_leaves(g_k), tree_leaves(g_p)))}
    print(f"{cfg.name} train: one step (B=512, teacher_prob {tp:.3f}, the same noise), the kernels' step on the card "
          f"vs the CPU port's and vs plain autograd on the card, relative to max|reference| per leaf: "
          f"{json.dumps(out)} (tolerance {rel})", flush=True)
    if not all(v["loss"] <= rel and v["grads"] <= rel for v in out.values()):
        raise AssertionError("the transformer step through the kernels differs from its references")


def time_tf_step(cfg, state, train_d, path, smi, iters=(3, 6)):
    """The fast train step (B = cfg.batch_size), plain autograd ("xla")
    against the kernels' step ("auto"), in turns on the same batch; a
    profile of each."""
    fam = transformer
    batch = next(train.batch_iterator(train_d, cfg.batch_size, seed=2))
    opt = train.make_optimizer(cfg)
    steps = {"plain": train.make_train_step(cfg.replace(train_impl="xla"), fam.apply, opt, gc_metric=False,
                                            extras_fn=fam.batch_extras),
             "kernel": train.make_train_step(cfg, fam.apply, opt, gc_metric=False, **family_fns(fam))}
    st = {}

    def stepper(which):
        st[which] = state

        def one():
            st[which] = steps[which](st[which], batch)[0]
        return one

    ms = in_turns({w: stepper(w) for w in steps}, {"plain": iters[0], "kernel": iters[1]})
    out = {w: {"ms_per_step": ms[w], "steps_per_sec": 1e3 / ms[w],
               "windows_per_sec": cfg.batch_size * 1e3 / ms[w]} for w in ms}
    print(f"{path}: train step (B={cfg.batch_size}, fast step, noisy teacher forcing, CUDA events, {smi}): "
          f"{json.dumps(out)}", flush=True)
    for w in steps:
        profile_device(f"{path}: fast step, {'train_impl xla' if w == 'plain' else 'the kernels (auto)'}",
                       stepper(w), 3, smi)


def tf32_work(flop, products):
    """An f32 tier's work by type: its matrix products on the tensor cores
    as three-pass TF32, the rest (attention, in_proj) on the FMA units →
    {peak: FLOP}, for bound()."""
    return {TF32X3_FLOPS: products, F32_FLOPS: flop - products}


def encoder_train_work(m, batch):
    """FLOP of fused_encode_train at width H → (forward, reverse), each by
    type (tf32_work). The reverse counts what the gradients need: the input
    and the weight gradient of every product (twice the forward's 12·H²
    MACs a token-layer) and of the attention (twice its 2·T·H), and
    in_proj's two."""
    h, t, layers, d = m.hidden, m.h_in, m.layers, m.d
    fwd = 2 * batch * t * (d * h + layers * (12 * h * h + 2 * t * h))
    bwd = 2 * batch * t * (2 * d * h + layers * (24 * h * h + 4 * t * h))
    return (tf32_work(fwd, 2 * batch * t * layers * 12 * h * h),
            tf32_work(bwd, 2 * batch * t * layers * 24 * h * h))


def time_encode_train(dev, params, cfg, batch, smi):
    """Row 11's three kernels alone at the training batch, each against its
    plain version and the yardstick, in turns: the forward with its stash
    against _stash_reference and nn.TransformerEncoder's forward under grad;
    the reverse against _reverse_reference and the yardstick's backward
    (torch.autograd.grad of its output); the reduction against the
    block-order loop and one torch.sum. Then the whole differentiable
    encoder (forward, backward) against autograd through _encode and the
    yardstick. Bytes: each input read once, each output (the stash, the
    partials) written once."""
    m = cfg.model
    rng = np.random.default_rng(18)
    past_n = windows.normalize_window(unit_rows(rng, dev, (batch, m.h_in)))[0].contiguous()
    leaves = [lay[sub][leaf] for lay in params["enc"] for sub, leaf in encode_train._ENC_LEAVES]
    w_in = params["in_proj"]
    cot = randn(rng, dev, (batch, m.h_in, m.hidden))
    enc, stash = encode_train.encode_train_fwd(m, past_n, w_in, leaves)
    d_x, parts = encode_train.encode_train_bwd(m, past_n, w_in, leaves, stash, cot, True)
    grads = encode_train.encode_train_dw(parts)
    net = encoder_library(params, dev).requires_grad_(True)
    emb = (past_n @ w_in + transformer._pos_enc(m.h_in, m.hidden, device=dev)).requires_grad_(True)
    lib_out = net(emb)
    lib_params = [emb, *net.parameters()]
    ms = {
        "encode_train_fwd": in_turns({
            "plain": lambda: encode_train._stash_reference(m, past_n, w_in, leaves),
            "kernel": lambda: encode_train.encode_train_fwd(m, past_n, w_in, leaves),
            "library": lambda: net(emb)}, {"plain": 3, "kernel": 5, "library": 5}),
        "encode_train_bwd": in_turns({
            "plain": lambda: encode_train._reverse_reference(past_n, w_in, leaves, stash, cot, True),
            "kernel": lambda: encode_train.encode_train_bwd(m, past_n, w_in, leaves, stash, cot, True),
            "library": lambda: torch.autograd.grad(lib_out, lib_params, cot, retain_graph=True)},
            {"plain": 2, "kernel": 5, "library": 5}),
        "encode_train_dw": in_turns({
            "plain": lambda: encode_train._dw_reference(parts),
            "kernel": lambda: encode_train.encode_train_dw(parts),
            "library": lambda: parts.sum(dim=0)}, {"plain": 1, "kernel": 5, "library": 5}),
    }
    fwd_flop, bwd_flop = encoder_train_work(m, batch)
    io = {"encode_train_fwd": (fwd_flop, [past_n, w_in, *leaves], [enc, stash]),
          "encode_train_bwd": (bwd_flop, [past_n, w_in, *leaves, stash, cot], [d_x, parts]),
          "encode_train_dw": (0, [parts], [grads])}
    for name, t in ms.items():
        record(name, t, *io[name])
        print(f"{name} alone (B={batch}, T={m.h_in}, L={m.layers}, {parts.shape[0]} blocks; ms, CUDA events, "
              f"{smi}): {json.dumps(t)}; bound {TIMES[name]['bound_ms']:.3f} ms by {TIMES[name]['bound_by']}",
              flush=True)
        if name in BEFORE:
            report_redesign(name, smi, {"ms": t["kernel"], "library_ms": t["library"]}, io[name])
    del stash, parts, lib_out
    x = past_n.clone().requires_grad_(True)
    for leaf in [w_in, *leaves]:
        leaf.requires_grad_(True)

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad((fn(params, m, x) * cot).sum(), [x, w_in, *leaves])

    whole = in_turns({"plain": fwd_bwd(transformer._encode), "kernel": fwd_bwd(encode_train.fused_encode_train),
                      "library": lambda: torch.autograd.grad(net(emb), lib_params, cot)},
                     {"plain": 3, "kernel": 5, "library": 5})
    for leaf in [w_in, *leaves]:
        leaf.requires_grad_(False)
    print(f"fused_encode_train forward + backward (B={batch}, T={m.h_in}; ms, CUDA events, {smi}): "
          f"{json.dumps(whole)} (plain: autograd through _encode; library: nn.TransformerEncoder under autograd)",
          flush=True)


def grouped_inputs(cfg, dev, rows, n_videos, seed):
    """``rows`` windows over ``n_videos`` videos of unequal counts, keys
    unsorted, K peers a video (one video with a peer absent), as host arrays
    → (pasts, keys, sets)."""
    rng = np.random.default_rng(seed)
    k, m = cfg.n_other_users, cfg.model
    weights = np.arange(1, n_videos + 1, dtype=np.float64)
    keys = rng.choice(n_videos, size=rows, p=weights / weights.sum()).tolist()
    sets = {v: unit_pasts(rng, k, m.h_out) for v in range(n_videos)}
    sets[0][k - 1] = 0.0  # a masked peer
    return unit_pasts(rng, rows, m.h_in), keys, sets


def grouped_tol(tier):
    return ANGLE_TOL if tier == torch.float32 else GROUPED_BF16_TOL


def check_grouped_tf(cfg, dev, params, rows, n_videos, label, tier=torch.bfloat16):
    """The grouped gateway of the transformer (``make_grouped_serve_fn``,
    the shared tier with δv, through ``grouped_predict``) against per-row
    serving of the same windows (``make_serve_fn``, each row's peers
    anchored to it), both in ``tier`` (bf16, the default on the card, or
    f32): pitch and the great-circle angle within ANGLE_TOL in f32,
    GROUPED_BF16_TOL in bf16, prefetch tiles equal on more than TILES_EQUAL;
    the packed batch is the request count (no group padded)."""
    fam = transformer if tier == torch.bfloat16 else tier_family(tier)
    tol = grouped_tol(tier)
    pasts, keys, sets = grouped_inputs(cfg, dev, rows, n_videos, seed=rows)
    fn = serving.make_grouped_serve_fn(params, cfg, fam, device=dev, packed=True)
    packed = len(serving.group_pack(keys, fn.tile_b)[0])
    got = serving.grouped_predict(fn, pasts, keys, sets)
    per_row = serving.make_serve_fn(params, cfg, fam, device=dev, impl="fused")
    of = np.stack([sets[v] for v in keys])
    direct = per_row({"past": pasts, "other_future": of,
                      "other_mask": (np.abs(of).max(axis=(2, 3)) > 0).astype(np.float32)}).cpu().numpy()
    d_yaw, d_pitch, d_dir, tiles = direction_gaps(
        np.concatenate([got["yaw"], got["pitch"], got["prefetch"]], -1), direct, cfg.model.h_out)
    print(f"{label}: grouped gateway in {str(tier)[6:]}, {rows} windows of {n_videos} videos (counts "
          f"{np.bincount(keys, minlength=n_videos).tolist()}, keys unsorted, K={cfg.n_other_users} peers sent once "
          f"a video, one masked), packed batch {packed}: against per-row serving max |Δpitch| {d_pitch:.3e} and "
          f"great-circle {d_dir:.3e} rad (tolerance {tol}; |Δyaw| {d_yaw:.3e}), prefetch tiles equal "
          f"{tiles:.5f} (> {TILES_EQUAL})", flush=True)
    if not (d_pitch <= tol and d_dir <= tol and tiles > TILES_EQUAL and packed == rows):
        raise AssertionError("the grouped gateway differs from per-row serving")


def time_grouped(cfg, dev, params, batch, n_videos, smi, label, profile=False):
    """One grouped serve call (the G peer sets on the card, the shared tier)
    against one per-row serve call of the same windows (each row's peers on
    the card), both from device tensors and in bf16 (the default), in turns;
    their answers compared first (GROUPED_BF16_TOL). With ``profile``, a
    profile of each."""
    rng = np.random.default_rng(batch)
    m, k = cfg.model, cfg.n_other_users
    past = unit_rows(rng, dev, (batch, m.h_in))
    gfut = unit_rows(rng, dev, (n_videos, k, m.h_out))
    gmask = torch.ones((n_videos, k), device=dev)
    gid = torch.tensor(rng.integers(0, n_videos, size=batch), device=dev)
    grouped = serving.make_grouped_serve_fn(params, cfg, transformer, device=dev, packed=True)
    per_row = serving.make_serve_fn(params, cfg, transformer, device=dev, impl="fused")
    rows = {"past": past, "other_future": gfut[gid].contiguous(), "other_mask": gmask[gid].contiguous()}
    calls = {"per_row": lambda: per_row(rows), "grouped": lambda: grouped(past, gfut, gmask, gid)}
    d_yaw, d_pitch, d_dir, tiles = direction_gaps(calls["grouped"]().cpu().numpy(),
                                                  calls["per_row"]().cpu().numpy(), m.h_out)
    if not (d_pitch <= GROUPED_BF16_TOL and d_dir <= GROUPED_BF16_TOL and tiles > TILES_EQUAL):
        raise AssertionError(f"{label}: grouped serving at B={batch} differs from per-row: pitch {d_pitch:.3e}, "
                             f"direction {d_dir:.3e}, tiles {tiles}")
    ms = in_turns(calls, {"per_row": 1, "grouped": 1} if batch > 4096 else {"per_row": 2, "grouped": 3})
    print(f"{label}: serve call at B={batch}, G={n_videos} groups, K={k} (ms, CUDA events, {smi}): "
          f"{json.dumps(ms)}, traj/s {json.dumps({w: batch * 1e3 / v for w, v in ms.items()})}; grouped against "
          f"per-row max |Δpitch| {d_pitch:.3e}, great-circle {d_dir:.3e} rad, |Δyaw| {d_yaw:.3e}, tiles equal "
          f"{tiles:.5f}", flush=True)
    if profile:
        for w, fn in calls.items():
            profile_device(f"{label}: {w} serve call at B={batch}", fn, 2, smi)


def time_shared_tier(dev, params, cfg, batch, n_groups, smi):
    """The shared tier alone at the grouped gateway's shape (G groups of
    unit-vector peer tracks, random anchors as δv's source), checked first
    against the plain shared decode, then timed in turns; its numbers go to
    the kernels line. FLOP: tf_work with the peer K/V products of G rows,
    not B, and the attention over the in-window tokens of each row's group;
    bytes: the encoder memory, y0, the group memory and validity, the gid,
    δv and the weights read once, the output written once. No library call
    decodes autoregressively with feedback."""
    rng = np.random.default_rng(20)
    m, k = cfg.model, cfg.n_other_users
    past_n = windows.normalize_window(unit_rows(rng, dev, (batch, m.h_in)))[0].contiguous()
    anchor = unit_rows(rng, dev, (batch,))
    gmem, gvalid = (x.contiguous() for x in transformer._peer_tokens(params, m, unit_rows(rng, dev, (n_groups, k,
                                                                                                m.h_out)), None))
    gid = torch.tensor(rng.integers(0, n_groups, size=batch), device=dev)
    dv = torch.stack([(anchor @ params["in_proj"]) @ layer["peer_attn"]["wv"] for layer in params["dec"]], 1)
    enc = transformer._encode(params, m, past_n)
    y0 = past_n[:, -1].contiguous()
    with torch.inference_mode():
        def plain():
            return transformer._ar_decode(params, m, enc, gmem, gvalid, y0, peer_gid=gid, peer_dv=dv)

        def kernel():
            return transformer_decode.fused_ar_decode_shared(params, m, enc, y0, peer_gmem=gmem, peer_gvalid=gvalid,
                                                             peer_gid=gid, peer_dv=dv)

        out = kernel()
        err = (out - plain()).abs().max().item()
        if not err <= TF_TOL:
            raise AssertionError(f"the shared tier at B={batch} disagrees with its plain version: {err:.3e}")
        note_err("fused_ar_decode_shared", err)
        ms = in_turns({"plain": plain, "kernel": kernel}, {"plain": 1, "kernel": 2})
    kt, seg = gmem.shape[1], (gmem.shape[1] if m.peer_pool == "mean" else m.h_out)
    steps = torch.arange(m.h_out, device=dev)[:, None]
    win = ((torch.arange(kt, device=dev) % seg)[None] - steps).abs() <= (m.peer_window if m.peer_window > 0
                                                                        else kt)
    attended = int((win[None] & gvalid[:, None]).sum(dim=(1, 2))[gid].sum())
    flop = tf_work(m, batch, kt, attended)[1] - 2 * m.layers * 2 * m.hidden ** 2 * (batch - n_groups) * kt
    record("fused_ar_decode_shared", ms, decode_work(m, batch, flop, kt, F32),
           [enc, y0, gmem, gvalid, gid, dv] + tree_leaves(params), [out])
    t = TIMES["fused_ar_decode_shared"]
    print(f"fused_ar_decode shared tier alone (B={batch}, G={n_groups}, L={m.layers}, {m.h_in}+{m.h_out} steps, "
          f"K={k}: {kt} peer tokens a group, window {m.peer_window}; ms, CUDA events, {smi}): {json.dumps(ms)}; "
          f"bound {t['bound_ms']:.3f} ms by {t['bound_by']} ({flop / ms['kernel'] / 1e9:.2f} TFLOP/s); max_abs_err "
          f"vs plain {err:.3e} (tolerance {TF_TOL}); library: none (AR decode with feedback)", flush=True)
    report_redesign("fused_ar_decode_shared", smi, no_library="none (AR decode with feedback)",
                    fma_bound=bound(flop, [enc, y0, gmem, gvalid, gid, dv] + tree_leaves(params), [out])[0],
                    extra=f"; the cross and self K/V re-read floor {reread_ms(m, batch, 0, F32):.3f} ms")


def time_decode_per_row(dev, params, cfg, batch, smi, window=0, tier=F32, twin=True):
    """The per-row decode kernel alone in ``tier`` at the preset's steps
    and K peers and at ``window``: at 100 + 100 steps, 0 is the TPU
    streamed tier's shape (every row's K·T peer tokens attended at every
    step), the preset's 8 ``transformer-10s``'s per-row serving. Checked
    first against the plain version in the same tier, then timed in turns
    (in bf16 beside the f32 kernel, where ``twin``), with its bound over the
    tokens this window attends; in bf16 beside its FMA design's time where
    PERF.md has one, and the K/V re-read floor. Reported beside the kernels
    line, whose entries keep transformer-30's shape at B = 16384."""
    m = get_preset(cfg.name, model_peer_window=window).model
    rng = np.random.default_rng(21)
    past_n, _, anchor = windows.normalize_window(unit_rows(rng, dev, (batch, m.h_in)))
    pm, pv = (x.contiguous() for x in transformer._peer_tokens(
        params, m, unit_rows(rng, dev, (batch, cfg.n_other_users, m.h_out)) - anchor[:, None], None))
    enc, y0 = transformer._encode(params, m, past_n.contiguous()), past_n[:, -1].contiguous()
    tol, sfx = (TF_TOL, "") if tier == F32 else (BF16_TOL, "_bf16")
    with torch.inference_mode():
        def run(kernel, cd):
            if kernel:
                return transformer_decode.fused_ar_decode(params, m, enc, y0, peer_mem=pm, peer_valid=pv,
                                                          compute_dtype=cd)
            return transformer._ar_decode(params, m, enc, pm, pv, y0, compute_dtype=cd)

        out = run(True, tier)
        err = (out - run(False, tier)).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"fused_ar_decode{sfx} at B={batch}, window {window} disagrees with plain: {err:.3e}")
        note_err(f"fused_ar_decode{sfx}", err)
        fns = {"plain": lambda: run(False, tier), "kernel": lambda: run(True, tier)}
        if tier == BF and twin:
            fns["f32_kernel"] = lambda: run(True, F32)
        ms = in_turns(fns, {"plain": 1, "kernel": 2, "f32_kernel": 2})
    mask = transformer._peer_window_mask(m, pm.shape[1], tq=m.h_out, device=dev)
    attended = batch * (int(mask.sum()) if mask is not None else m.h_out * pm.shape[1])
    flop = tf_work(m, batch, pm.shape[1], attended)[1]
    reads = [enc, y0, pm, pv] + stored(tree_leaves(params), tier)
    b_ms, b_by = bound(decode_work(m, batch, flop, pm.shape[1], tier), reads, [out],
                       F32_FLOPS if tier == F32 else BF16_FLOPS)
    shape = ", the TPU streamed tier's shape" if not window and m.h_out == 100 else ""
    print(f"fused_ar_decode{sfx} per-row tier alone ({cfg.name}, B={batch}, {m.h_in}+{m.h_out} steps, "
          f"K={cfg.n_other_users}: {pm.shape[1]} peer tokens, window {window}{shape}; ms, CUDA events, {smi}): "
          f"{json.dumps(ms)}; bound {b_ms:.3f} ms by {b_by}; max_abs_err vs plain {err:.3e} (tolerance {tol}); "
          f"library: none (AR decode with feedback)", flush=True)
    # each tier's kernel beside its time before its design: transformer-10s per row at its window and B = 4096
    # (the f32 one as the bf16 reading's twin), the f32 one also at transformer-30's B = 65,536
    kernels = {tier: ms["kernel"]}
    if "f32_kernel" in ms:
        kernels[F32] = ms["f32_kernel"]
    for cd, t_ms in kernels.items():
        name = "fused_ar_decode" + ("_bf16" if cd == BF else "")
        if window != cfg.model.peer_window:
            before = f"{name} {cfg.name} window {window}"
        else:
            before = f"{name} {cfg.name}" if batch == 4096 else f"{name} B={batch}"
        c_ms, c_by = (b_ms, b_by) if cd == tier else bound(decode_work(m, batch, flop, pm.shape[1], cd), [
            enc, y0, pm, pv] + stored(tree_leaves(params), cd), [out])
        report_redesign(name, smi, {"ms": t_ms, "library_ms": None, "bound_ms": c_ms, "bound_by": c_by},
                        before=before if before in BEFORE else "-", no_library="none (AR decode with feedback)",
                        extra=f"; {cfg.name} B={batch}, window {window}; the K/V re-read floor "
                              f"{reread_ms(m, batch, attended, cd):.3f} ms")


def time_encoder_t100(dev, params, cfg, smi):
    """At T = 100 the encoder runs the plain _encode (JAX routes no kernel
    past T = 64): its forward at a serving batch and its forward + backward
    at the training batch, against nn.TransformerEncoder with the same
    weights, in turns."""
    m = cfg.model
    rng = np.random.default_rng(19)
    net = encoder_library(params, dev)
    out = {}
    for batch, train_ in ((4096, False), (1024, True)):
        past_n = windows.normalize_window(unit_rows(rng, dev, (batch, m.h_in)))[0].contiguous()
        emb = past_n @ params["in_proj"] + transformer._pos_enc(m.h_in, m.hidden, device=dev)
        if train_:
            leaves = tree_leaves({"in_proj": params["in_proj"], "enc": params["enc"]})
            for leaf in leaves:
                leaf.requires_grad_(True)
            net.requires_grad_(True)
            cot = randn(rng, dev, (batch, m.h_in, m.hidden))
            fns = {"plain": lambda: torch.autograd.grad((transformer._encode(params, m, past_n) * cot).sum(), leaves),
                   "library": lambda: torch.autograd.grad((net(emb) * cot).sum(), list(net.parameters()))}
        else:
            fns = {"plain": lambda: transformer._encode(params, m, past_n), "library": lambda: net(emb)}
        with torch.inference_mode(not train_):
            out[f"B={batch} {'forward+backward' if train_ else 'forward'}"] = in_turns(fns, {"plain": 3,
                                                                                           "library": 3})
        if train_:
            for leaf in leaves:
                leaf.requires_grad_(False)
    print(f"{cfg.name}: plain _encode at T={m.h_in} against nn.TransformerEncoder (ms, CUDA events, {smi}): "
          f"{json.dumps(out)}", flush=True)


def ptxas_report(log):
    """nvcc's -Xptxas -v report as "kernel: registers, spill stores/loads"
    a kernel, the kernel named by its demangled-enough symbol."""
    out, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            sym = ln.split("'")[1]
            name = next((k for k in KERNEL_SYMBOLS if k in sym), sym[-40:])
            tags = [t for t, key in (("true", "ILb1E"), ("bf16", "nv_bfloat16")) if key in sym]
            name += f"<{', '.join(tags)}>" if tags else ""
        elif "spill" in ln and name:
            spills = ln.split("bytes stack frame,")[-1].replace(" bytes spill ", " ").strip()
        elif "registers" in ln and name:
            out.append(f"{name}: {ln.split('Used')[1].split(' registers')[0].strip()} regs, {spills}")
            name = None
    return "; ".join(out)


KERNEL_SYMBOLS = ("lstm_dw_pack_kernel", "fused_serve_kernel", "fused_decode_kernel", "lstm_cell_kernel", "peer_context_kernel",
                  "fused_encode_kernel", "encode_tokens_kernel", "ar_decode_kernel", "encode_stash_kernel",
                  "encode_reverse_kernel", "reduce_partials_kernel", "conv_resize_kernel", "lstm_dw_sum_kernel",
                  "lstm_dw_partial_kernel", "train_fwd_kernel", "ss_bwd_kernel",
                  "ss_dw_partial_kernel", "ss_dproj_kernel", "align_peer_fwd_kernel", "align_peer_bwd_kernel",
                  "align_dw_partial_kernel", "align_peer_dw_kernel")


# --------------------------------------------------------------- phase 17: the bf16 tiers end to end


def deviation_deg(a, b):
    """Great-circle angle between two (B, T, 3) predicted directions, in
    degrees: its mean and its max."""
    deg = geometry.great_circle_deg(a.float(), b.float())
    return {"mean_deg": deg.mean().item(), "max_deg": deg.max().item()}


def drive_bf16_serving(path, cfg, family, dev, params, batches, smi):
    """``family.serve_fused(compute_dtype=bfloat16)`` behind ``predict_xyz``
    (normalize → the bf16 kernels → denormalize, tile mask), at each
    (batch, iters): the first batch is the main path (launches counted); at
    each, the bf16 and the f32 call in turns (CUDA events) as traj/s, and
    the bf16 answers' deviation from the f32 ones on the same weights →
    the path's launches."""
    launches, out = None, {}
    for batch, iters in batches:
        calls = {str(cd)[6:]: serve_call(cfg, params, dev, batch, cd, family) for cd in (F32, BF)}
        if launches is None:
            _, launches = drive(path, calls["bfloat16"])
        got = {k: f()[0] for k, f in calls.items()}
        if not torch.isfinite(got["bfloat16"]).all():
            raise AssertionError(f"{path}: non-finite bf16 answers at B={batch}")
        ms = in_turns(calls, {k: iters for k in calls})
        out[f"B={batch}"] = {"ms": ms, "traj_per_s": {k: batch * 1e3 / v for k, v in ms.items()},
                             "bf16_vs_f32": deviation_deg(got["bfloat16"], got["float32"])}
    print(f"{path}: serve_fused(compute_dtype=bfloat16) against f32 on the same weights (serve call with tile mask, "
          f"CUDA events, {smi}): {json.dumps(out)}; launches of the first call {json.dumps(launches)}", flush=True)
    return launches


def drive_cell_bf16(dev, params_np, smi, batch=16384):
    """``cell="pallas"`` on a --bf16 seq2seq-tf-30 model behind
    ``make_predict_fn(impl="plain")``: the step loops hand the cell kernel
    bf16 x, h, c (60 launches a call); the answers against the same model on
    ``cell="xla"`` (``lstm_cell`` on the card) and the bf16-vs-f32 deviation
    from the f32 model of the same values; both cells and the f32 model in
    turns → the path's launches."""
    cfg = get_preset(PRESET, model_cell="pallas", model_param_dtype="bfloat16")
    xla, f32 = get_preset(PRESET, model_param_dtype="bfloat16"), get_preset(PRESET)
    params = params_from_numpy(params_np, dev)
    bparams = tree_unflatten(params, [p.bfloat16() for p in tree_leaves(params)])
    wide = tree_unflatten(params, [p.float() for p in tree_leaves(bparams)])
    past = unit_rows(np.random.default_rng(13), dev, (batch, cfg.model.h_in))
    fns = {"cell=pallas bf16": infer.make_predict_fn(bparams, cfg, device=dev, impl="plain"),
           "cell=xla bf16": infer.make_predict_fn(bparams, xla, device=dev, impl="plain"),
           "f32 serve_fused": infer.make_predict_fn(wide, f32, device=dev, impl="fused")}
    got, launches = drive(S2S_CELL_BF16, lambda: fns["cell=pallas bf16"](past))
    plain, ref = fns["cell=xla bf16"](past), fns["f32 serve_fused"](past)
    ms = in_turns({k: (lambda f=f: f(past)) for k, f in fns.items()}, dict.fromkeys(fns, 3))
    gaps = {"vs_cell_xla_bf16": deviation_deg(got, plain), "bf16_vs_f32": deviation_deg(got, ref)}
    print(f"{S2S_CELL_BF16}: B={batch}, {launches['fused_lstm_cell_bf16']} bf16 cell launches a call (30 + 30 "
          f"steps: 60); {json.dumps(gaps)} (limit vs cell=xla: {BF16_ANSWER_TOL} rad as degrees); serve call "
          f"(CUDA events, {smi}) {json.dumps(ms)}, traj/s {json.dumps({k: batch * 1e3 / v for k, v in ms.items()})}",
          flush=True)
    if launches["fused_lstm_cell_bf16"] != 60 or not gaps["vs_cell_xla_bf16"]["max_deg"] <= math.degrees(
            BF16_ANSWER_TOL):
        raise AssertionError("the bf16 cell=pallas path disagrees with cell=xla or launched other than 60 cells")
    return launches


def check_bf16_dtypes(cfg, state, path):
    """A --bf16 model after train_loop on the fused route, leaf by leaf as
    JAX's: the params bf16 (video-fusion's conv stack f32, as JAX's init
    makes it); the moments f32 where the gradient is: the LSTM cells' W and b
    (the kernels' custom VJPs give f32 dW, db) and the conv stack, bf16
    elsewhere; the transformer, which runs no kernel under bf16, all bf16."""
    keys = []
    walk(state.params, lambda k, _: keys.append(k))
    kernel_cells = cfg.model_family != "transformer"
    want_p = [F32 if k.startswith("conv.") else BF for k in keys]
    want_m = [F32 if k.startswith("conv.") or (kernel_cells and k.split(".")[0] in ("encoder", "decoder",
                                                                                   "peer_encoder")) else BF
              for k in keys]
    got_p = [p.dtype for p in tree_leaves(state.params)]
    for what, want, got in (("params", want_p, got_p), ("mu", want_m, [m.dtype for m in state.opt_state.mu]),
                            ("nu", want_m, [v.dtype for v in state.opt_state.nu])):
        if got != want:
            raise AssertionError(f"{path}: {what} dtypes {[(k, str(g)[6:]) for k, g in zip(keys, got)]}")
    print(f"{path}: dtypes as JAX's: params {sorted({str(d)[6:] for d in got_p})}, moments f32 for "
          f"{[k for k, d in zip(keys, want_m) if d == F32]}, bf16 for the rest", flush=True)


def drive_bf16_params(preset, dev, also, smi, windows_=None, steps=6, rows=512, iters=5):
    """``train --bf16`` (``model_param_dtype="bfloat16"``) on one preset at
    B = TRAIN_B: :func:`drive_training` of a short run (an evaluation,
    which decodes through ``apply`` in bf16, and a checkpoint every half;
    the resume bit-equal; ``also``: the kernels it must launch), the
    params' and moments' dtypes leaf by leaf (:func:`check_bf16_dtypes`),
    one step on the card against the CPU port's and the f32 model's of the
    same values (:func:`bf16_step_check`), ``eval`` of the checkpoint
    refused with JAX's model-hash message, and the fast step against the
    f32 model's, in turns."""
    path = f"train {preset} --bf16"
    cfg = get_preset(preset, model_param_dtype="bfloat16", batch_size=TRAIN_B, steps=steps,
                     eval_every=steps // 2, ckpt_every=steps // 2)
    trained, train_d, launches = drive_training(cfg, path, dev, also, windows_=windows_, step_check=False,
                                                resume_tol=0.0)
    check_bf16_dtypes(cfg, trained, path)
    f32 = get_preset(preset, batch_size=TRAIN_B, steps=steps)
    wide = tree_unflatten(trained.params, [p.float() for p in tree_leaves(trained.params)])
    # the floor on the gradients only: the LSTM presets' fused route computes
    # the loss with the f32 kernels on the widened weights, the f32 model's
    # loss, and only the bf16 leaves' gradients round
    bf16_step_check(cfg, trained, train_d, path, rows, f32=(f32, wide), floors=("grads",))
    with tempfile.TemporaryDirectory() as ck_dir:
        checkpoint.Checkpointer(ck_dir, cfg).save(trained)
        try:
            cli.main(["eval", "--preset", preset, "--ckpt-dir", ck_dir, "--device", "cuda:0"])
            refused = ""
        except SystemExit as e:
            refused = str(e)
    if "model-config hash mismatch" not in refused:
        raise AssertionError(f"{path}: eval did not refuse the bf16 checkpoint ({refused!r})")
    fam = get_family(cfg.model_family)
    batch = next(train.batch_iterator(train_d, cfg.batch_size, seed=2))
    opt = train.make_optimizer(cfg)
    st = {}

    def stepper(c, state, name):
        step = train.make_train_step(c, fam.apply, opt, gc_metric=False, **family_fns(fam))
        st[name] = state

        def one():
            st[name] = step(st[name], batch)[0]
        return one

    ms = in_turns({"float32": stepper(f32, train.TrainState(wide, opt.init(wide), 0, trained.rng), "float32"),
                   "bfloat16": stepper(cfg, trained, "bfloat16")}, {"float32": iters, "bfloat16": iters})
    print(f"{path}: eval of its checkpoint refused ({refused.split(';')[0]}); train step (B={cfg.batch_size}, fast "
          f"step, CUDA events, {smi}), the --bf16 model against the f32 model of the same values: "
          f"{json.dumps({k: {'ms_per_step': v} for k, v in ms.items()})}", flush=True)
    return launches


def time_bf16_serving_kernels(dev, s2s_params, cparams, ccfg, c10params, c10cfg, smi):
    """Each bf16 serving tier alone against its bf16 plain version and its
    f32 twin, in turns, at its main path's shape, with its bound (the bf16
    products at the bf16 tensor-core peak) and the library call where one
    computes a like function: cuDNN nn.LSTM in bf16 for the encoders, and
    torch.lstm_cell on bf16 tensors for the cell (both round more than the
    tier does: another function, timed as a yardstick)."""
    cfg = get_preset(PRESET)
    time_serve_kernel("fused_serve", dev, s2s_params, cfg, 262144, 3, 0, smi, cd=BF)
    time_serve_kernel("fused_serve_ctx", dev, cparams, ccfg, 65536, 3, ccfg.model.ctx_dim, smi, cd=BF)
    time_encode_kernel(dev, 65536, smi, True, cd=BF)
    time_peer_serve(dev, c10params, c10cfg, 65536, 1, smi, cd=BF)
    for batch, with_library in ((65536, False), (4096, True)):
        time_peer_context(dev, c10params["peer_encoder"], batch, c10cfg.n_other_users, c10cfg.model.h_out, smi,
                          with_library, cd=BF)
    time_cell_kernel(dev, smi, 3, True, cd=BF)
    time_cell_kernel(dev, smi, 128, False, cd=BF)


# --------------------------------------------------------------- main


# --------------------------------------------------------------- phase 18: predict, export and the daemon


DAEMON_ERRORS = []  # error replies the daemon's clients got in phase 18: any fails the run
DAEMON_PATHS = {  # the daemon's and predict's main paths → the kernels each must launch
    f"daemon {PRESET}": ["fused_serve"],
    f"daemon {CU10_PRESET}": ["fused_serve_peers", "peer_context"],
    f"daemon {TF_PRESET}": ["fused_encode_tokens_bf16", "fused_ar_decode_bf16"],
    f"predict {CU10_PRESET}": ["fused_serve_peers", "peer_context"],
    f"predict {CU10_PRESET} --peers 16": ["fused_serve_peers", "peer_context"],
    f"predict {TF_PRESET} --peer-group": ["fused_encode_tokens_bf16", "fused_ar_decode_bf16"],
}
BULK_REQ = 2048  # windows a bulk request: the daemon's batcher admits 8 x max_batch rows at a time
# predict prints angles rounded to 1e-3 degrees: its card-vs-CPU gate is ANGLE_TOL plus that rounding
PREDICT_TOL = ANGLE_TOL + math.radians(1e-3)


def answered(reply, what):
    """A daemon reply, with any error reply noted for the end of the phase."""
    if "error" in reply:
        DAEMON_ERRORS.append(f"{what}: {reply['error']}")
    return reply


def export_preset(preset, tmp):
    """A port checkpoint of ``preset`` holding its bench weights, through
    ``cli export`` → the npz, whose params load onto the card bit-equal."""
    cfg = get_preset(preset)
    fam = get_family(cfg.model_family)
    params = params_from_numpy(cli.bench_params_np(cfg, 0), "cpu")
    opt = train.make_optimizer(cfg)
    ck, npz = os.path.join(tmp, f"ck-{preset}"), os.path.join(tmp, f"{preset}.npz")
    checkpoint.Checkpointer(ck, cfg).save(train.TrainState(params, opt.init(params), 1, torch.Generator()))
    cli.main(["export", "--preset", preset, "--ckpt-dir", ck, "--out", npz])
    loaded = serving.load_exported_params(npz, cfg, fam, device="cuda")
    pairs = list(zip(serving.flat_param_items(params), serving.flat_param_items(loaded)))
    same = all(ka == kb and b.is_cuda and torch.equal(a, b.cpu()) for (ka, a), (kb, b) in pairs)
    print(f"export {preset}: {len(pairs)} arrays; load_exported_params(device='cuda') bit-equal to the "
          f"checkpoint's params: {same}", flush=True)
    if not same:
        raise AssertionError(f"export {preset}: the npz does not load back bit-equal")
    return npz


def predict_rows(argv, device, tmp, tag):
    out = os.path.join(tmp, f"{tag}-{device}.jsonl")
    cli.main([*argv, "--device", device, "--out", out])
    with open(out) as f:
        return [json.loads(line) for line in f]


def compare_xyz(r):
    """A predict row's directions (H_out, 3) from its rounded degrees."""
    y, p = np.radians(np.asarray(r["yaw_deg"], np.float64)), np.radians(np.asarray(r["pitch_deg"], np.float64))
    return np.stack([np.cos(p) * np.cos(y), np.cos(p) * np.sin(y), np.sin(p)], -1)


def compare_predictions(label, card, cpu, smi, tol=PREDICT_TOL, tiles_gate=TILES_EQUAL):
    """``predict`` rows of the card against the CPU's: the same rows and
    keys, pitch and the great-circle angle within ``tol`` (yaw reported),
    tiles equal on ``tiles_gate`` of rows (None: reported only)."""
    if len(card) != len(cpu) or any(a.keys() != b.keys() for a, b in zip(card, cpu)):
        raise AssertionError(f"{label}: the card's rows differ from the CPU's in count or keys")
    meta = all(a[k] == b[k] for a, b in zip(card, cpu) for k in a if not k.endswith("_deg") and k != "prefetch_tiles")
    d_pitch = max(np.radians(np.abs(np.subtract(a["pitch_deg"], b["pitch_deg"])).max()) for a, b in zip(card, cpu))
    d_yaw = max(np.radians(np.abs(np.subtract(a["yaw_deg"], b["yaw_deg"])).max()) for a, b in zip(card, cpu))
    d_dir = max(float(np.arccos(np.clip((compare_xyz(a) * compare_xyz(b)).sum(-1), -1, 1)).max())
                for a, b in zip(card, cpu))
    tiles = float(np.mean([a.get("prefetch_tiles") == b.get("prefetch_tiles") for a, b in zip(card, cpu)]))
    print(f"{label}: {len(card)} viewers, peers used {[r.get('peers_used') for r in card]}; card against the CPU: "
          f"max |Δpitch| {d_pitch:.3e}, great-circle {d_dir:.3e} rad (tolerance {tol:.3e}; |Δyaw| {d_yaw:.3e}), "
          f"rows with equal tiles {tiles:.3f} ({'reported' if tiles_gate is None else f'at least {tiles_gate}'}), "
          f"other fields equal {meta} ({smi})", flush=True)
    if not (meta and d_pitch <= tol and d_dir <= tol and (tiles_gate is None or tiles >= tiles_gate)):
        raise AssertionError(f"{label}: the card's predictions differ from the CPU's")


def start_daemon(cfg, params):
    """``serve_daemon`` on the card (max batch 256, warmup, impl "auto") on
    an ephemeral port, served from a thread."""
    server = serving.serve_daemon(params, cfg, get_family(cfg.model_family), device="cuda", host="127.0.0.1",
                                  port=0, max_batch=256, impl="auto")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def stop_daemon(server):
    server.shutdown()
    server.server_close()
    server.batcher.stop()


def pose_walk(rng, n):
    """A viewer's head path: [yaw, pitch] radians, a smooth random walk."""
    yaw = np.cumsum(rng.normal(0.0, 0.02, n)) + rng.uniform(-np.pi, np.pi)
    pitch = np.clip(np.cumsum(rng.normal(0.0, 0.01, n)), -1.2, 1.2)
    return np.stack([yaw, pitch], -1).tolist()


def median_s(fn, n=300):
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def single_pose_traffic(cfg, params, wire):
    """One viewer pushes single poses on ``wire`` to a fresh daemon until its
    window fills, then 300 more; then 300 ``drop`` ops on the same
    connection → the round trips of the answered pushes, the batcher's
    latency p50, the drop's median round trip, the last window and its
    batcher result."""
    server = start_daemon(cfg, params)
    h_in = cfg.model.h_in
    poses = pose_walk(np.random.default_rng(18), h_in + 300)
    client = serving.FovClient(*server.server_address, wire=wire)
    lat = []
    try:
        for i, pose in enumerate(poses):
            t0 = time.perf_counter()
            r = answered(client.push("viewer", pose), f"push on the {wire} wire")
            if i >= h_in - 1:
                lat.append(time.perf_counter() - t0)
                if "yaw" not in r:
                    DAEMON_ERRORS.append(f"a push with a full window got no prediction: {r}")
        batcher_p50 = server.batcher.stats()["latency_ms_p50"]
        relay = median_s(lambda: answered(client.request({"op": "drop", "viewer": "nobody"}), "drop"))
        window = np.stack([serving.pose_to_xyz(p) for p in poses[-h_in:]])
        res = server.batcher.predict(window)
    finally:
        client.close()
        stop_daemon(server)
    return {"lat": lat, "batcher_p50": batcher_p50, "relay": relay, "window": window, "res": res,
            "pose": poses[-1]}


def single_pose_terms(cfg, params, wire, flow, smi):
    """p50 and p99 of a single-pose flow and the p50's terms: the codec
    (the request and the reply encoded and decoded alone, both sides), the
    queue (the batcher's latency p50 less the device term), the device (the
    packed serve program at B = 1, host to card to host, CUDA events), the
    relay (the ``drop`` op's round trip: a dispatch with no device work)
    and what they leave."""
    req, res = {"op": "push", "viewer": "viewer", "pose": flow["pose"], "id": 1}, flow["res"]
    if wire == "json":
        line, reply = (json.dumps(req) + "\n").encode(), (json.dumps(serving.FovServer._prediction(1, res)) + "\n")
        codec = (median_s(lambda: (json.dumps(req) + "\n").encode()) + median_s(lambda: json.loads(line))
                 + median_s(lambda: (json.dumps(serving.FovServer._prediction(1, res)) + "\n").encode())
                 + median_s(lambda: json.loads(reply)))
    else:
        frame, out = serving.encode_frame(req), serving.encode_frame(serving.FovServer._prediction(1, res, raw=True))
        codec = (median_s(lambda: serving.encode_frame(req)) + median_s(lambda: serving.read_frame(io.BytesIO(frame)))
                 + median_s(lambda: serving.encode_frame(serving.FovServer._prediction(1, res, raw=True)))
                 + median_s(lambda: serving.read_frame(io.BytesIO(out))))
    fn = serving.make_serve_fn(params, cfg, get_family(cfg.model_family), device="cuda")
    batch = {"past": flow["window"][None]}
    fn(batch).cpu()

    def device_ms():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(batch).cpu()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    device = float(np.median([device_ms() for _ in range(300)]))
    p50, p99 = (float(np.percentile(flow["lat"], q)) * 1e3 for q in (50, 99))
    terms = {"codec": codec * 1e3, "queue": flow["batcher_p50"] - device, "device": device,
             "relay": flow["relay"] * 1e3}
    terms["unexplained"] = p50 - sum(terms.values())
    print(f"daemon {cfg.name} single-pose push flow, {wire} wire, {len(flow['lat'])} answered pushes: p50 "
          f"{p50:.4f} ms, p99 {p99:.4f} ms; the p50's terms (ms) "
          f"{json.dumps({k: round(v, 4) for k, v in terms.items()})} (codec: the request and the reply encoded and "
          f"decoded on both sides; queue: the batcher's latency p50 {flow['batcher_p50']} less the device term; "
          f"device: the packed serve program at B=1, host to card to host, CUDA events; relay: the drop op's round "
          f"trip) ({smi})", flush=True)
    return {"p50_ms": p50, "p99_ms": p99, **terms}


def client_traffic(server, windows, n_clients, on_count=None):
    """``n_clients`` binary-wire clients send ``predict`` for their share of
    ``windows`` (row i by client i % n_clients) → [(row, time sent,
    reply)]; ``on_count`` = (k, fn): fn() runs once k replies are back."""
    done, lock, fired = [], threading.Lock(), threading.Event()

    def worker(c):
        client = serving.FovClient(*server.server_address, wire="binary")
        try:
            for i in range(c, len(windows), n_clients):
                t0 = time.perf_counter()
                r = answered(client.predict(windows[i]), "predict")
                with lock:
                    done.append((i, t0, r))
                    go = on_count is not None and len(done) >= on_count[0] and not fired.is_set()
                    if go:
                        fired.set()
                if go:
                    on_count[1]()
        finally:
            client.close()

    with ThreadPoolExecutor(max_workers=n_clients) as pool:
        list(pool.map(worker, range(n_clients)))
    return done


def s2s_daemon_traffic(cfg, params, tmp):
    """The ``seq2seq-tf-30`` daemon's traffic: 64 clients x 20 ``predict``,
    a bulk ``predict_batch`` of 16384 windows on the binary wire, and the
    64 clients again with a ``reload`` of other weights once 300 replies
    are back → what each gave (checked by :func:`check_s2s_daemon`)."""
    rng = np.random.default_rng(181)
    out = {"windows": unit_pasts(rng, 64 * 20, cfg.model.h_in), "bulk": unit_pasts(rng, 16384, cfg.model.h_in)}
    out["new_np"] = cli.bench_params_np(cfg, 1)
    npz = os.path.join(tmp, "reload.npz")
    np.savez(npz, **{k: np.asarray(v) for k, v in serving.flat_param_items(out["new_np"])})
    server = start_daemon(cfg, params)
    try:
        before = server.batcher.stats()
        out["coalesced"] = client_traffic(server, out["windows"], 64)
        after = server.batcher.stats()
        out["batches"] = after["batches"] - before["batches"]
        out["mean_batch"] = (after["requests"] - before["requests"]) / max(out["batches"], 1)
        # the batcher admits 8 batches of rows (2048) at a time, as JAX's: the
        # 16384 windows go as 8 requests of 2048 on one connection
        client = serving.FovClient(*server.server_address, wire="binary", timeout=300.0)
        try:
            answered(client.request({"op": "predict_batch", "past": out["bulk"][:256]}), "bulk predict_batch")
            t0 = time.perf_counter()
            parts = [answered(client.request({"op": "predict_batch", "past": out["bulk"][i:i + BULK_REQ]}),
                              "bulk predict_batch") for i in range(0, len(out["bulk"]), BULK_REQ)]
            out["bulk_s"] = time.perf_counter() - t0
        finally:
            client.close()
        out["bulk_reply"] = {k: np.concatenate([r[k] for r in parts]) for k in ("yaw", "pitch")
                             if all(k in r for r in parts)}
        out["version"], reloaded = server.reload_ctx[0].version, {}

        def reload():
            c = serving.FovClient(*server.server_address, wire="json")
            try:
                reloaded["reply"] = answered(c.request({"op": "reload", "path": npz}), "reload")
                reloaded["at"] = time.perf_counter()
            finally:
                c.close()

        out["reload_traffic"] = client_traffic(server, out["windows"], 64, on_count=(300, reload))
        out["reloaded"], out["version_after"] = reloaded, server.reload_ctx[0].version
    finally:
        stop_daemon(server)
    return out


def row_gap(reply, direct, rows):
    return max(float(np.abs(np.asarray(reply[k], np.float64) - direct[k][rows]).max()) for k in ("yaw", "pitch"))


def check_s2s_daemon(cfg, params, t, smi):
    """Every answer of :func:`s2s_daemon_traffic` against the serve
    program's row: coalesced (mean batch > 1), bulk, and around the reload
    (after its reply: the new weights'; before: the old or the new)."""
    fam = get_family(cfg.model_family)
    fn = serving.make_serve_fn(params, cfg, fam, device="cuda")
    new_fn = serving.make_serve_fn(params_from_numpy(t["new_np"], "cuda"), cfg, fam, device="cuda")
    old, new = (fn.unpack(f({"past": t["windows"]}).cpu().numpy()) for f in (fn, new_fn))
    gap = max(row_gap(r, old, i) for i, _, r in t["coalesced"])
    print(f"daemon {cfg.name}: 64 clients x 20 predict requests in {t['batches']} batches, mean batch "
          f"{t['mean_batch']:.2f}; max |answer - the serve program's row| {gap:.3e}", flush=True)
    if not (len(t["coalesced"]) == len(t["windows"]) and t["mean_batch"] > 1 and gap <= 1e-6):
        raise AssertionError("the daemon's concurrent answers did not coalesce or differ from the serve program")
    bench = cli.serve_bench(preset=cfg.name, batch=16384, iters=10, impl="fused", device="cuda:0")
    bulk = fn.unpack(fn({"past": t["bulk"]}).cpu().numpy())
    gap = row_gap(t["bulk_reply"], bulk, slice(None)) if t["bulk_reply"] else float("inf")
    print(f"daemon {cfg.name}: bulk predict_batch of 16384 windows on the binary wire ({16384 // BULK_REQ} requests "
          f"of {BULK_REQ}, one connection) in {t['bulk_s'] * 1e3:.3f} ms, {16384 / t['bulk_s']:.1f} windows/s (max "
          f"batch 256: 64 batches); serve-bench at B=16384 "
          f"{bench['viewers_per_sec']:.1f} traj/s; max |answer - the serve program's row| {gap:.3e} ({smi})",
          flush=True)
    if not gap <= 1e-6:
        raise AssertionError("bulk answers differ from the serve program's rows")
    at = t["reloaded"].get("at", float("inf"))
    after = [(i, r) for i, t0, r in t["reload_traffic"] if t0 > at]
    gap_new = max((row_gap(r, new, i) for i, r in after), default=float("inf"))
    either = all(min(row_gap(r, old, i), row_gap(r, new, i)) <= 1e-6 for i, _, r in t["reload_traffic"])
    print(f"daemon {cfg.name}: reload during 64 clients' traffic: reply {json.dumps(t['reloaded'].get('reply'))}, "
          f"version {t['version']} → {t['version_after']}; {len(t['reload_traffic'])} answers, {len(after)} sent "
          f"after the reload's reply, max |answer - the new weights' row| there {gap_new:.3e}; every answer the old "
          f"or the new weights' {either}", flush=True)
    if not (t["reloaded"].get("reply", {}).get("reloaded") and t["version_after"] == t["version"] + 1
            and len(t["reload_traffic"]) == len(t["windows"]) and after and gap_new <= 1e-6 and either):
        raise AssertionError("the reload during traffic lost a request or served the wrong weights")
    return 16384 / t["bulk_s"], bench["viewers_per_sec"]


def peer_push_traffic(cfg, params):
    """8 viewers of one video push their trace's poses with ``video`` and
    ``frame`` on the binary wire: viewer 0 runs ahead, viewer j stops at
    frame h_in - 1 + 10·j, so the later viewers' last answers condition on
    the pool's peers → (the daemon, still serving; per later viewer: its
    last reply, window and the pool's peer futures for it)."""
    server = start_daemon(cfg, params)
    m = cfg.model
    store = traces.synthetic_store(n_users=8, n_videos=1, n_frames=600, rate_hz=cfg.rate_hz, seed=cfg.seed + 1)
    client = serving.FovClient(*server.server_address, wire="binary")
    out = []
    try:
        for j, tr in enumerate(store.traces):
            last = m.h_in + m.h_out + 80 if j == 0 else m.h_in - 1 + 10 * j
            for f in range(last + 1):
                r = answered(client.request({"op": "push", "viewer": tr.user, "pose": tr.xyz[f], "video": tr.video,
                                             "frame": f}), "push with video")
            if j:
                window = np.stack([serving.pose_to_xyz(p) for p in tr.xyz[last - m.h_in + 1:last + 1]])
                out.append((r, window, server.peers.peers_for(tr.video, tr.user, last)))
    except BaseException:
        stop_daemon(server)
        raise
    finally:
        client.close()
    return server, out


def check_peer_push(cfg, params, viewers, smi):
    """The later viewers' last answers: peers > 0, and equal to the serve
    program's with the pool's peer futures."""
    fn = serving.make_serve_fn(params, cfg, get_family(cfg.model_family), device="cuda")
    peers, gaps = [], []
    for r, window, got in viewers:
        peers.append(int(r.get("peers", -1)))
        extras = {} if got is None else {"other_future": got[0][None], "other_mask": got[1][None]}
        gaps.append(row_gap(r, fn.unpack(fn({"past": window[None], **extras}).cpu().numpy()), 0)
                    if "yaw" in r else float("inf"))
    print(f"daemon {cfg.name}: 8 viewers of one video pushing with video and frame, staggered: peers of the later "
          f"viewers' last answers {peers} (K={cfg.n_other_users}); max |answer - the serve program's with the pool's "
          f"peer futures| {max(gaps):.3e} ({smi})", flush=True)
    if not (all(p > 0 for p in peers) and max(gaps) <= 1e-6):
        raise AssertionError(f"daemon {cfg.name}: live peer context missing or answers off the serve program")


def grouped_on_daemon(cfg, server, smi):
    """A grouped ``predict_batch`` (each video's K peers sent once) against
    the per-row bulk path on the same sets, both on the daemon (the card's
    bf16 tier): pitch and the great-circle angle within GROUPED_BF16_TOL,
    tiles equal on TILES_EQUAL; ``stats`` shows the grouped block."""
    pasts, keys, sets = grouped_inputs(cfg, "cuda", 512, 8, seed=18)
    keys = [str(k) for k in keys]
    sets = {str(k): v for k, v in sets.items()}
    client = serving.FovClient(*server.server_address, wire="binary", timeout=120.0)
    try:
        g = answered(client.predict_group(pasts, keys, sets), "grouped predict_batch")
        of = np.stack([sets[k] for k in keys])
        r = answered(client.request({"op": "predict_batch", "past": pasts, "other_future": of,
                                     "other_mask": (np.abs(of).max(axis=(2, 3)) > 0).astype(np.float32)}),
                     "per-row predict_batch")
        stats = answered(client.request({"op": "stats"}), "stats")
    finally:
        client.close()
    if "yaw" not in g or "yaw" not in r:
        raise AssertionError("the daemon's grouped or per-row bulk request failed")
    d_yaw, d_pitch, d_dir, tiles = direction_gaps(
        np.concatenate([g["yaw"], g["pitch"], g["prefetch"]], -1),
        np.concatenate([r["yaw"], r["pitch"], r["prefetch"]], -1), cfg.model.h_out)
    print(f"daemon {cfg.name}: grouped predict_batch of 512 windows over 8 videos against the per-row path: max "
          f"|Δpitch| {d_pitch:.3e}, great-circle {d_dir:.3e} rad (tolerance {GROUPED_BF16_TOL}; |Δyaw| {d_yaw:.3e}), "
          f"tiles equal {tiles:.4f}; stats' grouped block {json.dumps(stats.get('grouped'))} ({smi})", flush=True)
    if not (d_pitch <= GROUPED_BF16_TOL and d_dir <= GROUPED_BF16_TOL and tiles >= TILES_EQUAL
            and stats.get("grouped", {}).get("requests", 0) >= 1):
        raise AssertionError("the daemon's grouped path differs from its per-row path")


def drive_slice_c(dev, smi):
    """Phase 18: export, predict and the daemon on the card. Each main path
    (``DAEMON_PATHS``) runs under :func:`drive`; the comparisons with the
    serve program and the CPU run outside it."""
    readings = {}
    tcfg = get_preset(TF_PRESET)
    with tempfile.TemporaryDirectory() as tmp:
        s2s_npz = export_preset(PRESET, tmp)
        c10_npz = export_preset(CU10_PRESET, tmp)
        tf_npz = os.path.join(tmp, "tf.npz")
        np.savez(tf_npz, **{k: np.asarray(v) for k, v in serving.flat_param_items(cli.bench_params_np(tcfg, 0))})
        for label, extra in ((f"predict {CU10_PRESET}", []), (f"predict {CU10_PRESET} --peers 16", ["--peers", "16"])):
            argv = ["predict", "--preset", CU10_PRESET, "--params", c10_npz, *extra, "--impl", "fused", "--tiles",
                    "--at-frame", "400"]
            cpu = predict_rows(argv, "cpu", tmp, "cpu")
            card, _ = drive(label, lambda: predict_rows(argv, "cuda", tmp, "card"), also=DAEMON_PATHS[label])
            compare_predictions(label, card, cpu, smi)
        # the card serves the transformer in its bf16 tier, the CPU in f32: held at the repo's bound for that
        # tier against f32 (GROUPED_BF16_TOL), tiles reported
        label = f"predict {TF_PRESET} --peer-group"
        argv = ["predict", "--preset", TF_PRESET, "--params", tf_npz, "--peer-group", "--at-frame", "200", "--tiles"]
        cpu = predict_rows(argv, "cpu", tmp, "cpu")
        card, _ = drive(label, lambda: predict_rows(argv, "cuda", tmp, "card"), also=DAEMON_PATHS[label])
        compare_predictions(label, card, cpu, smi, tol=GROUPED_BF16_TOL, tiles_gate=None)

        cfg = get_preset(PRESET)
        params = serving.load_exported_params(s2s_npz, cfg, get_family(cfg.model_family), device="cuda")
        label = f"daemon {PRESET}"
        (flows, traffic), _ = drive(label, lambda: (
            {wire: single_pose_traffic(cfg, params, wire) for wire in ("json", "binary")},
            s2s_daemon_traffic(cfg, params, tmp)), also=DAEMON_PATHS[label])
        for wire, flow in flows.items():
            readings[wire] = single_pose_terms(cfg, params, wire, flow, smi)
        readings["bulk_windows_per_s"], readings["serve_bench_traj_per_s"] = check_s2s_daemon(cfg, params, traffic,
                                                                                               smi)

    for cfg_ in (get_preset(CU10_PRESET), tcfg):
        params_ = params_from_numpy(cli.bench_params_np(cfg_, 0), dev)
        label = f"daemon {cfg_.name}"
        (server, viewers), _ = drive(label, lambda: peer_push_traffic(cfg_, params_), also=DAEMON_PATHS[label])
        try:
            if cfg_ is tcfg:
                grouped_on_daemon(cfg_, server, smi)
        finally:
            stop_daemon(server)
        check_peer_push(cfg_, params_, viewers, smi)
    print(f"daemon and predict: error replies {len(DAEMON_ERRORS)} {json.dumps(DAEMON_ERRORS[:5])} ({smi})",
          flush=True)
    if DAEMON_ERRORS:
        raise AssertionError(f"the daemon answered {len(DAEMON_ERRORS)} requests with an error")
    print(f"daemon {PRESET} readings: {json.dumps(readings)} ({smi})", flush=True)
    return readings


# --------------------------------------------------------------- phase 19: trace ingest and the simulations


# the logs the phase writes: the Tsinghua / MMSys'17 dataset's dimensions (Wu et al.; datasets.FORMATS["tsinghua"]),
# 48 users x 18 videos, one CSV a (user, video) of rows playback_t, unix_t, qx, qy, qz, qw at about 30 Hz (each
# timestamp jittered by up to 3 ms, so that resample interpolates), 60 s a log
LOG_USERS, LOG_VIDEOS, LOG_SECONDS, LOG_HZ = 48, 18, 60.0, 30.0
SIM_CASES = ((PRESET, None), (CU_PRESET, 4), (CU10_PRESET, 7), (TF_PRESET, None))  # stream-sim (preset, --peers)
INGEST_PATHS = {  # the phase's main paths → the kernels each must launch
    f"stream-sim {PRESET}": ["fused_serve"],
    f"stream-sim {CU_PRESET} --peers 4": ["fused_serve_ctx", "fused_encode"],
    f"stream-sim {CU10_PRESET} --peers 7": ["fused_serve_peers", "peer_context"],
    f"stream-sim {TF_PRESET}": ["fused_encode_tokens_bf16", "fused_ar_decode_bf16"],
    f"cli serve {PRESET}": ["fused_serve"],
    f"cli serve {CU10_PRESET}": ["fused_serve_ctx"],  # serve feeds the past alone: a zero static context, as JAX's
    f"predict --traces {PRESET}": ["fused_serve"],
    f"predict --traces {CU10_PRESET}": ["fused_serve_peers", "peer_context"],
    f"eval --plot {PRESET}": ["fused_serve"],
    f"train --tb-dir {PRESET}": ["lstm_seq_states_fwd", "lstm_seq_states_bwd", "lstm_seq_states_dw",
                                 "lstm_dw_pack", "fused_serve"],
}
# stream-sim, card against CPU, per deadline: the f32 presets one flipped tile apart, 1 / (viewers x ticks), plus
# the two results' rounding to 4 places; the transformer's bf16 tier (the card's) against the CPU's f32 within about
# four times the largest gap read (7e-4 on the preset's bench weights, 2e-4 on its trained state; PERF.md §6)
SIM_ROUNDING, TF_SIM_TOL = 1e-4, 3e-3
TF_SIM_SAMPLE = 30  # every 30th tick of the transformer's simulation: its answers against the bf16 plain versions
SERVE_FLIPS = 2  # serve, card against CPU: frames whose hit may differ (rates rounded to 4 places, tiles to 2)
STATES = {}  # preset -> checkpoint directory of the state its training phase returned (5, 7, 9, 14)


def keep_state(cfg, state, root):
    """Save a training phase's state for phase 19's stream-sim."""
    ck = os.path.join(root, cfg.name)
    checkpoint.Checkpointer(ck, cfg).save(state)
    STATES[cfg.name] = ck


def host_label():
    """The host's CPU model and its cores, beside host-clock numbers."""
    with open("/proc/cpuinfo") as f:
        model = next((line.split(":", 1)[1].strip() for line in f if line.startswith("model name")), None)
    if model is None and shutil.which("lscpu"):
        out = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
        model = next((line.split(":", 1)[1].strip() for line in out.splitlines() if line.startswith("Model name")),
                     None)
    return f"host {model or 'CPU model not reported'}, nproc {len(os.sched_getaffinity(0))}"


def write_logs(root, seed=0):
    """LOG_USERS x LOG_VIDEOS head-pose logs in the Tsinghua layout under
    ``root/userUU/videoVV.csv``; their rows. Each viewer's yaw and pitch mix
    a path shared by the video's viewers (0.6) with the viewer's own (0.4):
    yaw integrates an Ornstein-Uhlenbeck angular velocity (τ = 2 s, about
    34°/s rms), pitch is one (τ = 3 s, about 10° rms), clipped to ±1.3 rad."""
    rng = np.random.default_rng(seed)
    n, dt = int(LOG_SECONDS * LOG_HZ), 1.0 / LOG_HZ

    def ou(shape, tau, sigma):
        out, v = np.empty(shape + (n,)), rng.normal(0.0, sigma * np.sqrt(tau / 2), shape)
        kicks = rng.normal(0.0, sigma * np.sqrt(dt), shape + (n,))
        for i in range(n):
            v += -v * dt / tau + kicks[..., i]
            out[..., i] = v
        return out

    shared = (np.cumsum(ou((LOG_VIDEOS,), 2.0, 0.6), -1) * dt + rng.uniform(-np.pi, np.pi, (LOG_VIDEOS, 1)),
              ou((LOG_VIDEOS,), 3.0, 0.25))
    yaw = 0.6 * shared[0] + 0.4 * np.cumsum(ou((LOG_USERS, LOG_VIDEOS), 2.0, 0.6), -1) * dt
    pitch = np.clip(0.6 * shared[1] + 0.4 * ou((LOG_USERS, LOG_VIDEOS), 3.0, 0.25), -1.3, 1.3)
    cy, sy, cp, sp = np.cos(yaw / 2), np.sin(yaw / 2), np.cos(pitch / 2), np.sin(pitch / 2)
    quat = np.stack([-sy * sp, cy * sp, sy * cp, cy * cp], -1)  # (x, y, z, w) of yaw about z, then pitch
    t = np.arange(n) * dt + rng.uniform(-0.003, 0.003, (LOG_USERS, LOG_VIDEOS, n))
    for u in range(LOG_USERS):
        os.makedirs(f"{root}/user{u:02d}")
        for v in range(LOG_VIDEOS):
            np.savetxt(f"{root}/user{u:02d}/video{v:02d}.csv",
                       np.column_stack([t[u, v], 1.5e9 + 3600 * v + t[u, v], quat[u, v]]), fmt="%.6f",
                       delimiter=",", header="PlaybackTime,UnixTime,qx,qy,qz,qw", comments="")
    return LOG_USERS * LOG_VIDEOS * n


def quiet_cli(argv):
    """``cli.main(argv)`` with its standard output captured → (the output,
    the SystemExit code or message; 0 when it returned)."""
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            cli.main(argv)
        except SystemExit as e:
            code = e.code
    return buf.getvalue(), code


def last_json(text):
    return json.loads(text.strip().splitlines()[-1])


@contextlib.contextmanager
def plain_ingest():
    """The C library's entry points on the ingest path swapped for their
    numpy plain versions."""
    saved = datasets.parse_trace_bytes, native.window_fill
    datasets.parse_trace_bytes, native.window_fill = native.parse_trace_plain, native.window_fill_plain
    try:
        yield
    finally:
        datasets.parse_trace_bytes, native.window_fill = saved


def check_validate(logs, tmp):
    """inspect-traces --validate --dataset-format tsinghua: exit 0 on the
    logs, 2 on a copy with one file's quaternions scaled by 1.1. The layout
    is pinned: sniffing (as JAX's) takes a 6-column file whose quaternions
    are not unit for an euler_deg log, and that file then passes; the
    sniffed run on the copy is reported."""
    pin = ["--validate", "--dataset-format", "tsinghua"]
    t0 = time.perf_counter()
    out, code = quiet_cli(["inspect-traces", "--traces", logs, *pin])
    wall = time.perf_counter() - t0
    bad = os.path.join(tmp, "logs_bad")
    shutil.copytree(logs, bad)
    victim = os.path.join(bad, "user01", "video01.csv")
    rows = np.loadtxt(victim, delimiter=",", skiprows=1)
    rows[:, 2:6] *= 1.1
    np.savetxt(victim, rows, fmt="%.6f", delimiter=",", header="PlaybackTime,UnixTime,qx,qy,qz,qw", comments="")
    bad_out, bad_code = quiet_cli(["inspect-traces", "--traces", bad, *pin])
    fails = [line.strip() for line in bad_out.splitlines() if line.startswith("FAIL") or "error:" in line]
    sniffed, sniffed_code = quiet_cli(["inspect-traces", "--traces", bad, "--validate"])
    victim_line = next(line for line in sniffed.splitlines() if "user01/video01.csv" in line)
    print(f"inspect-traces {' '.join(pin)}: exit {code}, '{out.strip().splitlines()[-1]}' in {wall:.2f} s; on the "
          f"copy with user01/video01.csv's quaternions x 1.1: exit {bad_code}, {fails} "
          f"'{bad_out.strip().splitlines()[-1]}'; sniffed (no --dataset-format) on the copy: exit {sniffed_code}, "
          f"'{victim_line.strip()}'", flush=True)
    shutil.rmtree(bad)
    if code != 0 or bad_code != 2 or len(fails) != 2:
        raise AssertionError("inspect-traces --validate: the logs must pass (exit 0) and the scaled copy fail (2)")


def check_prepare(logs, tmp, rows, smi):
    """prepare-data --traces through the C library and through the plain
    versions: the npz bit-equal; files/s, rows/s, and the parse alone, C
    against numpy (host numbers)."""
    outs, walls = {}, {}
    for route in ("C", "plain"):
        out = os.path.join(tmp, f"ingest-{route}.npz")
        with plain_ingest() if route == "plain" else contextlib.nullcontext():
            t0 = time.perf_counter()
            text, code = quiet_cli(["prepare-data", "--traces", logs, "--out", out])
            walls[route] = time.perf_counter() - t0
        if code != 0:
            raise AssertionError(f"prepare-data --traces ({route}) exited {code}: {text}")
        outs[route] = {split: data.load_packed(path) for split, path in
                       (("train", out), ("test", out.replace(".npz", "_test.npz")))}
    same = all(outs["C"][sp].keys() == outs["plain"][sp].keys() and all(
        np.array_equal(outs["C"][sp][k], outs["plain"][sp][k]) for k in outs["C"][sp]) for sp in ("train", "test"))
    blobs = []
    for root, _, files in sorted(os.walk(logs)):
        for name in sorted(files):
            with open(os.path.join(root, name), "rb") as f:
                blobs.append(f.read())
    parse_s = {}
    for route, fn in (("C", native.parse_trace_bytes), ("plain", native.parse_trace_plain)):
        t0 = time.perf_counter()
        parsed = [fn(b) for b in blobs]
        parse_s[route] = time.perf_counter() - t0
        if route == "C":
            c_parsed = parsed
    parse_same = all(np.array_equal(a, b) for a, b in zip(c_parsed, parsed))
    n_files, mb = len(blobs), sum(map(len, blobs)) / 1e6
    train_d = outs["C"]["train"]
    print(f"prepare-data --traces: {n_files} files, {rows} rows, {mb:.1f} MB → {len(train_d['past'])} train / "
          f"{len(outs['C']['test']['past'])} test windows; C library {walls['C']:.2f} s ({n_files / walls['C']:.1f} "
          f"files/s, {rows / walls['C']:.0f} rows/s), plain versions {walls['plain']:.2f} s; npz bit-equal {same}; "
          f"the parse alone: C {parse_s['C']:.3f} s ({rows / parse_s['C']:.0f} rows/s), numpy {parse_s['plain']:.3f} "
          f"s, x{parse_s['plain'] / parse_s['C']:.1f}, arrays bit-equal {parse_same} ({host_label()}; card {smi})",
          flush=True)
    if not (same and parse_same):
        raise AssertionError("prepare-data --traces through the C library differs from the plain versions")
    return os.path.join(tmp, "ingest-C.npz")


def sim_argv(preset, peers, video_dir, device):
    return ["stream-sim", "--preset", preset, "--ckpt-dir", STATES[preset], "--traces", video_dir, "--device",
            device, *([] if peers is None else ["--peers", str(peers)])]


def sim_label(preset, peers):
    return f"stream-sim {preset}" + ("" if peers is None else f" --peers {peers}")


SIM_CHUNK_TICKS = 45  # ticks of one CPU reference task: the simulations split over the host's cores


SIM_DEADLINES = (1, 10, 30)  # stream-sim's default --deadlines


def sim_ticks(cfg, peers, n_frames):
    """(h_in, the frames a tick looks ahead, the ticks) of stream_simulation."""
    ahead = max(max(SIM_DEADLINES), cfg.model.h_out) if peers else max(SIM_DEADLINES)
    return cfg.model.h_in, ahead, n_frames - ahead - cfg.model.h_in


def viewer_stack(video_dir, cfg):
    """The viewers of ``video_dir`` as stream-sim reads them, cut to the
    shortest → (V, T, 3) float32."""
    xyz = [t.xyz for t in datasets.load_dataset(video_dir, rate_hz=cfg.rate_hz).traces]
    return np.stack([np.asarray(x[:min(map(len, xyz))], np.float32) for x in xyz])


def trained_params(cfg, ck, device):
    """The params of the checkpoint ``ck`` (a state phase 5, 7, 9 or 14
    trained, STATES) on ``device``."""
    return cli._serving_params(types.SimpleNamespace(ckpt_dir=ck, params=None), cfg, get_family(cfg.model_family),
                               device)


def cpu_sim_chunk(preset, ck, xyz, peers, lo, hi):
    """One CPU reference task of start_cpu_sims, run in a worker process
    on one thread: the simulation's ticks [lo, hi) (the frames they read,
    cut from the (V, T, 3) ``xyz``) from the checkpoint ``ck``, as
    stream-sim runs them → (hits by deadline, the tiles a frame summed
    over the ticks)."""
    torch.set_num_threads(1)
    cfg = get_preset(preset)
    h_in, ahead, _ = sim_ticks(cfg, peers, xyz.shape[1])
    hits, tiles, _, ticks, _ = infer._stream_counts(
        trained_params(cfg, ck, "cpu"), cfg, list(xyz[:, lo - h_in:hi + ahead]), device="cpu",
        deadlines=SIM_DEADLINES, tile_rows=6, tile_cols=12, fov_deg=90.0, impl="fused", n_peers=peers)
    if ticks != hi - lo:
        raise AssertionError(f"{preset}: a CPU reference task of {ticks} ticks for [{lo}, {hi})")
    return dict(zip(map(str, SIM_DEADLINES), hits.tolist())), tiles


def card_stream_sims(video_dir, dev, smi):
    """stream-sim on the four presets' trained checkpoints over one video's
    48 viewers, on the card under drive → {label: its JSON}."""
    card = {}
    for preset, peers in SIM_CASES:
        label = sim_label(preset, peers)
        (text, code), _ = drive(label, lambda: quiet_cli(sim_argv(preset, peers, video_dir, str(dev))),
                                also=INGEST_PATHS[label])
        if code != 0:
            raise AssertionError(f"{label} exited {code}: {text}")
        card[label] = r = last_json(text)
        print(f"{label}: {r['viewers']} viewers x {r['ticks']} ticks on the card: {json.dumps(r)}; "
              f"{r['viewers'] / r['predictions_per_sec'] * 1e3:.3f} ms a tick (host clock; {smi})", flush=True)
    return card


def start_cpu_sims(video_dir, pool):
    """The same simulations on the CPU, split by ticks into tasks of
    SIM_CHUNK_TICKS (the hit counts add up), submitted to ``pool`` (one
    worker process a core), the larger models first → [(label, future)]."""
    futures = []
    for preset, peers in reversed(SIM_CASES):
        cfg = get_preset(preset)
        xyz = viewer_stack(video_dir, cfg)
        # stream-sim's --peers -1: the preset's K for the families that take peers
        takes_peers = getattr(get_family(cfg.model_family), "batch_extras", None) is not None
        k = peers if peers is not None else (cfg.n_other_users if takes_peers else 0)
        h_in, _, n_ticks = sim_ticks(cfg, k, xyz.shape[1])
        for lo in range(h_in, h_in + n_ticks, SIM_CHUNK_TICKS):
            futures.append((sim_label(preset, peers),
                            pool.submit(cpu_sim_chunk, preset, STATES[preset], xyz, k, lo,
                                        min(lo + SIM_CHUNK_TICKS, h_in + n_ticks))))
    return futures


def check_cpu_sims(card, futures, t0, workers):
    """The card's simulations against the CPU's, per deadline."""
    parts = [(label, f.result()) for label, f in futures]
    print(f"stream-sim on the CPU: {len(parts)} tasks of up to {SIM_CHUNK_TICKS} ticks over {workers} worker "
          f"processes of one thread, done {time.perf_counter() - t0:.1f} s after they started, beside the serve, "
          f"predict and report checks ({host_label()})", flush=True)
    bad = []
    for preset, peers in SIM_CASES:
        label = sim_label(preset, peers)
        got = card[label]
        n = got["viewers"] * got["ticks"]
        hits = {dl: sum(p[0][dl] for lab, p in parts if lab == label) for dl in got["hit_rate_by_deadline"]}
        ref = {dl: round(h / n, 4) for dl, h in hits.items()}
        tiles = sum(p[1] for lab, p in parts if lab == label) / got["ticks"]
        tol = TF_SIM_TOL if preset == TF_PRESET else 1.0 / n + SIM_ROUNDING
        gap = max(abs(got["hit_rate_by_deadline"][dl] - ref[dl]) for dl in ref)
        print(f"{label}: card against the CPU, hit rate by deadline {json.dumps(got['hit_rate_by_deadline'])} vs "
              f"{json.dumps(ref)} (CPU hits {json.dumps(hits)} of {n}), max gap {gap:.5f} (tolerance {tol:.5f}); "
              f"tiles a frame {got['mean_tiles_per_frame']} vs {tiles:.4f}", flush=True)
        if gap > tol:
            bad.append(label)
    if bad:
        raise AssertionError(f"stream-sim on the card differs from the CPU: {bad}")


def check_tf_sim_answers(video_dir, dev, smi):
    """The transformer's stream-sim at its own batch, B = 48: on every
    TF_SIM_SAMPLE-th tick's windows and peers (as the simulation forms
    them), the card's served answers (the bf16 kernels) against the port's
    bf16 plain versions on the CPU (BF16_ANSWER_TOL), and the tiles each
    predicted frame fetches compared (reported)."""
    cfg = get_preset(TF_PRESET)
    xyz = viewer_stack(video_dir, cfg)
    k, h_out = cfg.n_other_users, cfg.model.h_out
    h_in, _, n_ticks = sim_ticks(cfg, k, xyz.shape[1])
    batches = []
    for t in range(h_in, h_in + n_ticks, TF_SIM_SAMPLE):
        fut = xyz[:, t:t + h_out]
        batches.append({"past": xyz[:, t - h_in:t],
                         "other_future": np.stack([np.roll(fut, -(j + 1), axis=0) for j in range(k)], 1)})
    params, fam = trained_params(cfg, STATES[TF_PRESET], dev), get_family(cfg.model_family)
    with torch.inference_mode():
        card = torch.cat([infer.predict_xyz(params, cfg, fam, {key: torch.as_tensor(v, device=dev)
                                                               for key, v in b.items()}, impl="fused")
                          for b in batches]).cpu()
        full = {key: torch.as_tensor(np.concatenate([b[key] for b in batches])) for key in batches[0]}
        plain = infer.predict_xyz(trained_params(cfg, STATES[TF_PRESET], "cpu"), cfg, tier_family(torch.bfloat16),
                                  full, impl="fused")
    err = (card - plain).abs().max().item()
    tiles = (infer.tiles_for_fov(card) == infer.tiles_for_fov(plain)).all(-1).float().mean().item()
    print(f"stream-sim {TF_PRESET}: {len(batches)} ticks of {xyz.shape[0]} viewers (every {TF_SIM_SAMPLE}th), the "
          f"card's bf16 answers against the CPU's bf16 plain versions: max |xyz| gap {err:.3e} (tolerance "
          f"{BF16_ANSWER_TOL}); frames with equal tiles {tiles:.4f} (reported; {smi})", flush=True)
    if not (torch.isfinite(card).all() and err <= BF16_ANSWER_TOL):
        raise AssertionError(f"stream-sim {TF_PRESET}: the card's answers differ from the bf16 plain versions")


def check_cli_serve(npz, dev, smi):
    """serve on seq2seq-tf-30 (the test split of one video's ingested
    windows) and on the 10 s preset (its synthetic store: the 60 s logs hold
    no 200-frame test window), card against CPU."""
    for preset, extra in ((PRESET, ["--data", npz]), (CU10_PRESET, [])):
        label = f"cli serve {preset}"
        argv = ["serve", "--preset", preset, "--ckpt-dir", STATES[preset], *extra]
        cpu, code = quiet_cli([*argv, "--device", "cpu"])
        (got, code_card), _ = drive(label, lambda: quiet_cli([*argv, "--device", str(dev)]), also=INGEST_PATHS[label])
        if code or code_card:
            raise AssertionError(f"{label} exited {code_card} on the card, {code} on the CPU: {got}{cpu}")
        got, ref = last_json(got), last_json(cpu)
        frames = got["n_windows"] * got["horizon"]
        tol = {"hit_rate": SERVE_FLIPS / frames + SIM_ROUNDING, "tiles_per_frame": 0.01 + SERVE_FLIPS * 72 / frames}
        gaps = {k: abs(got[k] - ref[k]) for k in got if k.endswith(("hit_rate", "tiles_per_frame"))}
        print(f"{label}: card {json.dumps(got)}; CPU {json.dumps(ref)}; gaps {json.dumps(gaps)} (tolerance "
              f"{json.dumps(tol)}; {smi})", flush=True)
        same = all(got[k] == ref[k] for k in ("n_windows", "horizon", "grid", "fov_deg"))
        if not same or any(g > tol["hit_rate" if k.endswith("hit_rate") else "tiles_per_frame"]
                           for k, g in gaps.items()):
            raise AssertionError(f"{label}: the card's prefetch scores differ from the CPU's")


def check_predict_traces(video_dir, tmp, dev, smi):
    """predict --traces at frame 400 of the one-video logs (48 viewers; the
    10 s preset with K = 7 peers), card against CPU."""
    for preset in (PRESET, CU10_PRESET):
        label = f"predict --traces {preset}"
        argv = ["predict", "--preset", preset, "--ckpt-dir", STATES[preset], "--traces", video_dir, "--at-frame",
                "400", "--tiles"]
        cpu = predict_rows(argv, "cpu", tmp, "cpu")
        card, _ = drive(label, lambda: predict_rows(argv, str(dev), tmp, "card"), also=INGEST_PATHS[label])
        compare_predictions(label, card, cpu, smi)


def plot_series(npz, device):
    """What eval --plot draws (``cli.eval_plot_series``) for seq2seq-tf-30's
    trained state on the test split of ``npz``, computed on ``device``."""
    cfg = get_preset(PRESET)
    params = trained_params(cfg, STATES[PRESET], device)
    _, test_d = cli._load_or_synth_data(types.SimpleNamespace(data=npz), cfg)
    return cli.eval_plot_series(params, cfg, test_d, evaluate.evaluate(params, cfg, test_d, impl="fused"), device)


def check_reports(npz, tmp, dev, smi):
    """What eval --plot draws, computed on the card against the CPU (each
    curve is a mean of per-window angles, each within ANGLE_TOL of the
    CPU's, so within it too); then eval --plot and train --tb-dir on the
    card: the files where matplotlib and tensorboard are installed, else
    the message that names the missing package."""
    import importlib.util

    label = f"eval --plot {PRESET}"
    (curves, pred), _ = drive(label, lambda: plot_series(npz, dev), also=INGEST_PATHS[label])
    ref_curves, ref_pred = plot_series(npz, "cpu")
    gaps = {name: float(np.abs(np.subtract(c, ref_curves[name])).max()) for name, c in curves.items()}
    a, b = pred.astype(np.float64), ref_pred.astype(np.float64)
    d_pred = float(np.arctan2(np.linalg.norm(np.cross(a, b), axis=-1), (a * b).sum(-1)).max())
    print(f"{label}: the curves and one window's prediction on the card against the CPU: max curve gaps "
          f"{json.dumps(gaps)} degrees, prediction {d_pred:.3e} rad (tolerance {ANGLE_TOL} rad; {smi})", flush=True)
    if curves.keys() != ref_curves.keys() or not (max(gaps.values()) <= math.degrees(ANGLE_TOL)
                                                  and d_pred <= ANGLE_TOL):
        raise AssertionError(f"{label}: what the card computes for the plots differs from the CPU's")
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    prefix = os.path.join(tmp, "plot")
    text, code = quiet_cli(["eval", "--preset", PRESET, "--ckpt-dir", STATES[PRESET], "--data", npz, "--device",
                            str(dev), "--plot", prefix, "--json"])
    if have_mpl:
        pngs = {os.path.basename(p): os.path.getsize(p) if os.path.exists(p) else 0
                for p in (f"{prefix}_curve.png", f"{prefix}_traj.png")}
        ok = code == 0 and all(pngs.values())
        print(f"eval --plot on the card: exit {code}, bytes written {json.dumps(pngs)}", flush=True)
    else:
        ok = isinstance(code, str) and "matplotlib" in code
        print(f"eval --plot on the card: matplotlib is not installed; exit message {code!r}", flush=True)
    if not ok:
        raise AssertionError(f"eval --plot: {code} {text[-500:]}")
    have_tb = importlib.util.find_spec("tensorboard") is not None
    tb = os.path.join(tmp, "tb")
    argv = ["train", "--preset", PRESET, "--data", npz, "--steps", "2", "--batch-size", "1024", "--device", str(dev),
            "--tb-dir", tb]
    if have_tb:
        (text, code), _ = drive(f"train --tb-dir {PRESET}", lambda: quiet_cli(argv),
                                also=INGEST_PATHS[f"train --tb-dir {PRESET}"])
        events = [f for f in os.listdir(tb) if f.startswith("events.out.tfevents")] if os.path.isdir(tb) else []
        ok = code == 0 and bool(events)
        print(f"train --tb-dir on the card: exit {code}, event files {events}", flush=True)
    else:
        text, code = quiet_cli(argv)
        ok = isinstance(code, str) and "tensorboard" in code
        print(f"train --tb-dir on the card: tensorboard is not installed; exit message {code!r}", flush=True)
    if not ok:
        raise AssertionError(f"train --tb-dir: {code} {text[-500:]}")


def drive_ingest(dev, smi):
    """Phase 19: the logs written, validated, ingested through the C
    library (against the plain versions), then stream-sim, serve, predict
    --traces, eval --plot and train --tb-dir on the card against the CPU."""
    with tempfile.TemporaryDirectory() as tmp:
        logs = os.path.join(tmp, "logs")
        t0 = time.perf_counter()
        rows = write_logs(logs)
        print(f"ingest: {LOG_USERS} users x {LOG_VIDEOS} videos, {LOG_SECONDS:.0f} s logs at about {LOG_HZ:.0f} Hz "
              f"({rows} rows) written in {time.perf_counter() - t0:.1f} s", flush=True)
        check_validate(logs, tmp)
        npz_all = check_prepare(logs, tmp, rows, smi)
        # one video's 48 viewers: the simulations' audience
        video_dir = os.path.join(tmp, "video00")
        for u in range(LOG_USERS):
            os.makedirs(os.path.join(video_dir, f"user{u:02d}"))
            shutil.copy(os.path.join(logs, f"user{u:02d}", "video00.csv"), os.path.join(video_dir, f"user{u:02d}"))
        npz_video = os.path.join(tmp, "video00.npz")
        text, code = quiet_cli(["prepare-data", "--traces", video_dir, "--out", npz_video])
        if code:
            raise AssertionError(f"prepare-data --traces on one video exited {code}: {text}")
        card = card_stream_sims(video_dir, dev, smi)
        # the CPU reference of the simulations runs in worker processes beside the checks that follow
        workers = len(os.sched_getaffinity(0))
        with ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("spawn")) as pool:
            t0 = time.perf_counter()
            futures = start_cpu_sims(video_dir, pool)
            try:
                check_tf_sim_answers(video_dir, dev, smi)
                check_cli_serve(npz_video, dev, smi)
                check_predict_traces(video_dir, tmp, dev, smi)
                check_reports(npz_all, tmp, dev, smi)
                check_cpu_sims(card, futures, t0, workers)
            finally:
                for _, f in futures:
                    f.cancel()


# --------------------------------------------------------------- phase 20: data parallelism

DP_PRESETS = (PRESET, CU_PRESET, TF_PRESET)
DP_STEPS = 3
# the ranks' params against the single-card run on the global batch after
# DP_STEPS Adam updates: the bound of JAX's own DP test (tests/test_parallel.py)
DP_TOL = 2e-6
# each preset's training kernels on its fused route (no in-loop evaluation)
DP_TRAIN_KERNELS = {
    PRESET: ["lstm_seq_states_fwd", "lstm_seq_states_bwd", "lstm_seq_states_dw", "lstm_dw_pack"],
    CU_PRESET: ["lstm_seq_states_fwd", "lstm_seq_states_bwd", "lstm_seq_states_dw", "lstm_dw_pack",
                "ss_decode_fwd", "ss_decode_bwd", "ss_decode_dw", "ss_decode_dproj"],
    TF_PRESET: ["encode_train_fwd", "encode_train_bwd", "encode_train_dw"],
}
DP_W1, DP_W2 = "train_loop_dp world 1 nccl", "train_loop_dp 2 ranks gloo one card"
DP_TIMED = (PRESET, CU_PRESET)  # the DP step timed at TRAIN_B, world 1 and 2
DP_SERVE, DP_DAEMON = "sharded serve [cuda:0]x4", "serve_daemon mesh [cuda:0]x4 seq2seq-tf-30"
# (preset, batch, the serving kernels it launches)
DP_SERVE_CASES = (
    (PRESET, 262144, ["fused_serve"]),
    (CU_PRESET, 65536, ["fused_serve", "fused_encode"]),
    (CU10_PRESET, 65536, ["fused_serve_peers", "peer_context"]),
    (TF_PRESET, 16384, ["fused_encode_tokens_bf16", "fused_ar_decode_bf16"]),
)


def dp_cfg(preset):
    return get_preset(preset, steps=DP_STEPS, eval_every=DP_STEPS)


def dp_state(cfg, dev):
    """The preset's seeded initial state on ``dev`` (the same on every call
    and every rank: the params are drawn by a CPU generator)."""
    return train.init_state(cfg, get_family(cfg.model_family).init, train.make_optimizer(cfg), device=dev)


def dp_step_batch(preset, windows, device, rows=slice(None)):
    """The config at TRAIN_B, its initial state, and ``rows`` of one global
    batch as tensors on ``device`` (the step's time without the copy)."""
    cfg = get_preset(preset, batch_size=TRAIN_B)
    batch = next(train.batch_iterator(windows[preset], TRAIN_B, seed=1))
    return cfg, dp_state(cfg, device), {k: torch.as_tensor(v[rows], device=device) for k, v in batch.items()}


def dp_step_times(mesh, dev, windows, smi):
    """The DP step of a world of one against train.make_train_step at
    TRAIN_B, in turns by CUDA events → {preset: single-card ms}."""
    out = {}
    for preset in DP_TIMED:
        cfg, state, batch = dp_step_batch(preset, windows, dev)
        fam = get_family(cfg.model_family)
        opt = train.make_optimizer(cfg)
        one = train.make_train_step(cfg, fam.apply, opt, **family_fns(fam))
        dp = parallel.make_sharded_train_step(cfg, fam.apply, opt, mesh, **family_fns(fam))
        ms = in_turns({"single card": lambda: one(state, batch), "world 1": lambda: dp(state, batch)},
                      {"single card": 10, "world 1": 10})
        print(f"{DP_W1} {preset}: the step at B={TRAIN_B}, in turns by CUDA events: {ms['world 1']:.3f} ms in a "
              f"world of one over NCCL, {ms['single card']:.3f} ms train.make_train_step ({smi})", flush=True)
        out[preset] = ms["single card"]
    return out


def dp_world_one(dev, windows, smi):
    """20 (a): train_loop_dp in a world of one over NCCL against train_loop,
    bit for bit → the single-card params of each preset (on the CPU), and
    the single-card step's ms at TRAIN_B (:func:`dp_step_times`)."""
    refs = {}
    with tempfile.TemporaryDirectory() as tmp:
        parallel.init_multihost(f"file://{tmp}/store", 1, 0, backend="nccl", device=dev,
                                timeout=datetime.timedelta(seconds=120))
        try:
            mesh = parallel.make_mesh(dev)
            for preset in DP_PRESETS:
                cfg, fam = dp_cfg(preset), get_family(get_preset(preset).model_family)
                init = dp_state(cfg, dev)
                ref, _ = train.train_loop(cfg, fam.init, fam.apply, windows[preset], device=dev, state=init,
                                          **family_fns(fam))
                (state, hist), _ = drive(f"{DP_W1} {preset}", lambda: parallel.train_loop_dp(
                    cfg, fam.init, fam.apply, windows[preset], mesh=mesh, state=init, **family_fns(fam)),
                    also=DP_TRAIN_KERNELS[preset])
                same = all(torch.equal(a, b) for a, b in zip(tree_leaves(state.params), tree_leaves(ref.params)))
                print(f"{DP_W1} {preset}: B={cfg.batch_size}, {DP_STEPS} steps, loss {hist[-1]['loss']:.6f}, "
                      f"n_devices {hist[-1]['n_devices']}; params bit-equal to train_loop's: {same} ({smi})",
                      flush=True)
                if not same:
                    raise AssertionError(f"{DP_W1} {preset}: the params differ from train_loop's")
                refs[preset] = [t.cpu() for t in tree_leaves(ref.params)]
            single_ms = dp_step_times(mesh, dev, windows, smi)
        finally:
            torch.distributed.destroy_process_group()
    return refs, single_ms


def dp_rank(mesh, windows):
    """One rank of 20 (b), started by launch.run_world: each preset's
    train_loop_dp on this rank's rows, its launch counters set to 0 just
    before and read just after → {preset: params on the CPU, launches,
    seconds, last loss}; then the DP step at TRAIN_B (this rank's half) and
    the gradients' all_reduce alone, ms by the host clock over 10 calls
    after a barrier → {("step", preset): ms, ("all_reduce", preset): ms}."""
    fused_lstm.exact_f32_matmul()
    out = {}
    for preset in DP_PRESETS:
        cfg, fam = dp_cfg(preset), get_family(get_preset(preset).model_family)
        init = dp_state(cfg, mesh.device)
        for wrapper in WRAPPERS.values():
            wrapper.launches = 0
        t0 = time.perf_counter()
        state, hist = parallel.train_loop_dp(cfg, fam.init, fam.apply, windows[preset], mesh=mesh, state=init,
                                             **family_fns(fam))
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        out[preset] = {"params": [t.cpu() for t in tree_leaves(state.params)], "seconds": time.perf_counter() - t0,
                       "launches": {n: WRAPPERS[n].launches for n in DP_TRAIN_KERNELS[preset]},
                       "loss": hist[-1]["loss"], "n_devices": hist[-1]["n_devices"]}
    for preset in DP_TIMED:
        cfg, state, batch = dp_step_batch(preset, windows, mesh.device, mesh.rows(TRAIN_B))
        fam = get_family(cfg.model_family)
        step = parallel.make_sharded_train_step(cfg, fam.apply, train.make_optimizer(cfg), mesh, **family_fns(fam))
        grads = tree_unflatten(state.params, [torch.randn_like(p) for p in tree_leaves(state.params)])
        sync = torch.cuda.synchronize if mesh.device.type == "cuda" else (lambda: None)
        for key, fn in (("step", lambda: step(state, batch)), ("all_reduce", lambda: mesh.pmean(0.0, 0.0, grads))):
            fn()
            mesh.barrier()
            sync()
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            sync()
            out[(key, preset)] = (time.perf_counter() - t0) / 10 * 1e3
    return out


def dp_two_ranks(windows, refs, single_ms, smi):
    """20 (b): two ranks on the one card over gloo against the single-card
    run on the global batch; the step's time beside the single card's."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = launch.run_world("chip_smoke:dp_rank", 2, windows, workdir=os.path.join(tmp, "world"),
                                 backend="gloo", device="cuda:0", timeout=300)
        wall = time.perf_counter() - t0
    print(f"{DP_W2}: the world of two started, ran the three presets and joined in {wall:.1f} s ({smi})",
          flush=True)
    for preset in DP_PRESETS:
        r0, r1 = (r[preset] for r in ranks)
        equal = all(torch.equal(a, b) for a, b in zip(r0["params"], r1["params"], strict=True))
        gap = max((a - b).abs().max().item() for a, b in zip(r0["params"], refs[preset], strict=True))
        path = f"{DP_W2} {preset}"
        PATH_LAUNCHES[path] = r0["launches"]
        print(f"{path}: rank 0's launches {json.dumps(r0['launches'])}, rank 1's {json.dumps(r1['launches'])}; "
              f"n_devices {r0['n_devices']}, loss {r0['loss']:.6f}; ranks bit-equal: {equal}; max |params - "
              f"single card, global batch| {gap:.3e} (tolerance {DP_TOL:.0e}); {r0['seconds']:.2f} s on rank 0 "
              f"({smi})", flush=True)
        if not equal or not gap <= DP_TOL or r0["n_devices"] != 2:
            raise AssertionError(f"{path}: the ranks disagree or differ from the single-card run")
        for name in DP_TRAIN_KERNELS[preset]:
            if min(r0["launches"][name], r1["launches"][name]) < 1:
                raise AssertionError(f"the main path '{path}' never launched kernel {name}")
    for preset in DP_TIMED:
        step, reduce = ([r[(key, preset)] for r in ranks] for key in ("step", "all_reduce"))
        print(f"{DP_W2} {preset}: the step at B={TRAIN_B} ({TRAIN_B // 2} rows a rank) {max(step):.3f} ms on the "
              f"slower rank ({min(step):.3f} on the other), host clock over 10 steps after a barrier, against "
              f"{single_ms[preset]:.3f} ms for the single-card step (CUDA events, phase 20 (a)); the gradients' "
              f"gloo all_reduce alone {max(reduce):.3f} ms ({smi})", flush=True)


def dp_cli(tmp, smi):
    """20 (c): train --data-parallel under the launcher (a world of one,
    cuda:LOCAL_RANK) against train without the flag: the checkpoints'
    params bit-equal."""
    base = ["train", "--preset", PRESET, "--steps", str(DP_STEPS), "--batch-size", "128", "--device", "cuda"]
    plain, dp = os.path.join(tmp, "ck-plain"), os.path.join(tmp, "ck-dp")
    out, code = quiet_cli([*base, "--ckpt-dir", plain])
    if code:
        raise AssertionError(f"train exited {code}")
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
                           "-m", "longterm360fov_tpu_torch", *base, "--data-parallel", "--ckpt-dir", dp],
                          capture_output=True, text=True, timeout=300, env=env, cwd=tmp)
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"train --data-parallel under the launcher exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    a, b = (torch.load(os.path.join(d, str(DP_STEPS), "state.pt"), weights_only=True)["params"] for d in (plain, dp))
    same = all(torch.equal(x, y) for x, y in zip(a, b, strict=True))
    print(f"train --data-parallel under python -m torch.distributed.run --nproc-per-node 1: {last_json(proc.stdout)}"
          f" in {wall:.1f} s with the process's start; params bit-equal to train without the flag: {same} ({smi})",
          flush=True)
    if not same or last_json(proc.stdout)["n_devices"] != 1:
        raise AssertionError("train --data-parallel differs from train")


def dp_serve(dev, smi):
    """20 (d): make_sharded_predict_fn over [cuda:0] x 4 against the
    unsharded call, bit for bit, both timed in turns."""
    mesh = [dev] * 4
    for preset, batch, kernels in DP_SERVE_CASES:
        cfg = get_preset(preset)
        fam = get_family(cfg.model_family)
        params = params_from_numpy(cli.bench_params_np(cfg, 0), dev)
        m, rng = cfg.model, np.random.default_rng(1)
        x = {"past": unit_rows(rng, dev, (batch, m.h_in))}
        if cfg.model_family != "seq2seq":
            x["other_future"] = unit_rows(rng, dev, (batch, cfg.n_other_users, m.h_out))
        whole = infer.make_predict_fn(params, cfg, device=dev, impl="fused")
        sharded = parallel.make_sharded_predict_fn(params, cfg, fam, mesh, impl="fused")
        ref = whole(x)
        out, _ = drive(f"{DP_SERVE} {preset}", lambda: sharded(x), also=kernels)
        gap = (out - ref).abs().max().item()
        ms = in_turns({"unsharded": lambda: whole(x), "4 slices": lambda: sharded(x)},
                      {"unsharded": 3, "4 slices": 3})
        print(f"{DP_SERVE} {preset}: B={batch} as 4 slices of {batch // 4}, K={cfg.n_other_users if 'other_future' in x else 0}; "
              f"bit-equal to the unsharded call: {torch.equal(out, ref)} (max |Δ| {gap:.3e}); "
              f"{ms['4 slices']:.3f} ms sharded, {ms['unsharded']:.3f} ms unsharded, in turns by CUDA events "
              f"({smi})", flush=True)
        if not torch.equal(out, ref):
            raise AssertionError(f"{DP_SERVE} {preset}: the sharded answers differ from the unsharded call's")
        del x, out, ref
        torch.cuda.empty_cache()


def first_line(proc, timeout):
    """The first line a process prints, or raise after ``timeout`` s."""
    box = []
    reader = threading.Thread(target=lambda: box.append(proc.stdout.readline()), daemon=True)
    reader.start()
    reader.join(timeout)
    if not box or not box[0]:
        proc.kill()
        raise AssertionError(f"the process printed nothing in {timeout} s:\n{proc.communicate()[1][-3000:]}")
    return box[0]


def dp_daemon(dev, tmp, smi):
    """20 (e): the daemon on [cuda:0] x 4 against the daemon without a
    mesh; then serve-daemon --data-parallel as a process against it."""
    cfg = get_preset(PRESET)
    fam = get_family(cfg.model_family)
    params = params_from_numpy(cli.bench_params_np(cfg, 0), dev)
    opts = dict(device=dev, host="127.0.0.1", port=0, max_batch=256, impl="auto")
    t0 = time.perf_counter()
    meshed = serving.serve_daemon(params, cfg, fam, mesh=[dev] * 4, **opts)
    warm = time.perf_counter() - t0
    plain = serving.serve_daemon(params, cfg, fam, **opts)
    for server in (meshed, plain):
        threading.Thread(target=server.serve_forever, daemon=True).start()
    rng = np.random.default_rng(5)
    poses, pasts = pose_walk(rng, cfg.model.h_in + 4), unit_pasts(rng, 1000, cfg.model.h_in)

    def traffic(server):
        c = serving.FovClient(*server.server_address, timeout=120.0)
        pushes = [answered(c.push("v0", pose), "push") for pose in poses]
        bulk = answered(c.request({"op": "predict_batch", "past": pasts.tolist()}), "predict_batch")
        one = answered(c.predict(pasts[0].tolist()), "predict")
        c.close()
        return pushes[-4:] + [bulk, one]

    try:
        got, _ = drive(DP_DAEMON, lambda: traffic(meshed), also=["fused_serve"])
        ref = traffic(plain)
        same = all(a[k] == b[k] for a, b in zip(got, ref) for k in ("yaw", "pitch", "prefetch") if k in b)
        print(f"{DP_DAEMON}: divisor {meshed.batcher.divisor}, the ladder 4 ... 256 warmed in {warm:.1f} s; "
              f"{len(poses)} pushes, a bulk of {len(pasts)} windows and a predict answered as by the daemon "
              f"without a mesh (divisor {plain.batcher.divisor}): {same}; stats {json.dumps(meshed.batcher.stats())}"
              f" ({smi})", flush=True)
        if not same or meshed.batcher.divisor != 4 or DAEMON_ERRORS:
            raise AssertionError(f"{DP_DAEMON}: the answers differ from the daemon without a mesh {DAEMON_ERRORS}")
        npz = os.path.join(tmp, "dp.npz")
        np.savez(npz, **{k: tensor_to_array(v) for k, v in serving.flat_param_items(params)})
        env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "longterm360fov_tpu_torch", "serve-daemon", "--preset", PRESET,
                                 "--params", npz, "--data-parallel", "--port", "0", "--max-batch", "64"],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=tmp)
        try:
            listening = json.loads(first_line(proc, 300))
            host, port = listening["listening"].rsplit(":", 1)
            c = serving.FovClient(host, int(port), timeout=120.0)
            reply = answered(c.predict(pasts[0].tolist()), "serve-daemon --data-parallel")
            c.close()
        finally:
            proc.send_signal(signal.SIGINT)
            err = proc.communicate(timeout=60)[1]
        same_cli = all(reply[k] == ref[-1][k] for k in ("yaw", "pitch", "prefetch"))
        print(f"serve-daemon --data-parallel: listening after {time.perf_counter() - t0:.1f} s with the process's "
              f"start, answered as the daemon without a mesh: {same_cli}; exit {proc.returncode}, its stats "
              f"{err.strip().splitlines()[-1] if err.strip() else None} ({smi})", flush=True)
        if not same_cli or proc.returncode != 0:
            raise AssertionError("serve-daemon --data-parallel did not answer as the daemon without a mesh")
    finally:
        stop_daemon(meshed)
        stop_daemon(plain)


def drive_dp(dev, smi):
    """Phase 20: data parallelism, (a) to (e)."""
    t0 = time.perf_counter()
    windows = {p: synthetic_windows(get_preset(p))[0] for p in DP_PRESETS}
    refs, single_ms = dp_world_one(dev, windows, smi)
    dp_two_ranks(windows, refs, single_ms, smi)
    with tempfile.TemporaryDirectory() as tmp:
        dp_cli(tmp, smi)
        dp_serve(dev, smi)
        dp_daemon(dev, tmp, smi)
    print(f"phase 20 data parallelism: {time.perf_counter() - t0:.1f} s ({smi})", flush=True)


# --------------------------------------------------------------- phase 21: sequence, pipeline and tensor parallelism

GRID_STEPS = 3
# JAX's own bounds (tests/test_sp.py, test_pp.py, test_tp.py): a forward's
# largest |difference|; a gradient's, over max(max|g|, 1); a 3-step
# trajectory's loss (relative, each step) and params (absolute, at the end)
GRID_FWD_TOL, GRID_GRAD_TOL, GRID_LOSS_REL, GRID_PARAM_TOL = 2e-5, 3e-5, 2e-4, 5e-5
TP_DECODE_TOL, TP_GRAD_TOL = 1e-5, 2e-5
GRID_EVAL = ["fused_encode_tokens_bf16", "fused_ar_decode_bf16"]  # rows 10b and 9c, the in-loop evaluation's


def grid_runs(dev):
    """The sharded transformer-30 forwards of phase 21, each on the one card
    named as often as the grid has entries → {name: apply_fn}."""
    two = [dev] * 2
    return {"sp ring [cuda:0]x2": sp.sp_apply_fn(sp.make_sp_mesh(2, devices=two), impl="ring"),
            "sp gather [cuda:0]x2": sp.sp_apply_fn(sp.make_sp_mesh(2, devices=two), impl="gather"),
            "pp M=2 [cuda:0]x2": pp.pp_apply_fn(pp.make_pp_mesh(2, devices=two), n_microbatches=2),
            "pp M=4 [cuda:0]x2": pp.pp_apply_fn(pp.make_pp_mesh(2, devices=two), n_microbatches=4)}


def trajectory_gaps(hist, ref_hist, state, ref):
    """The largest relative loss gap over the logged steps and the largest
    |params - reference| after them."""
    loss = max(abs(h["loss"] - r["loss"]) / abs(r["loss"]) for h, r in zip(hist, ref_hist, strict=True))
    par = max((a - b).abs().max().item() for a, b in zip(tree_leaves(state.params), tree_leaves(ref.params)))
    return loss, par


def check_gaps(label, loss, par, smi):
    print(f"{label}: {GRID_STEPS} steps against the single card's plain step: loss within {loss:.3e} (relative, "
          f"gate {GRID_LOSS_REL}), params within {par:.3e} (gate {GRID_PARAM_TOL}) ({smi})", flush=True)
    if not (loss <= GRID_LOSS_REL and par <= GRID_PARAM_TOL):
        raise AssertionError(f"{label}: the sharded trajectory leaves JAX's bounds")


def grid_step_times(label, cfg, steps, batch, state, smi):
    """Each step of ``steps`` ({name: step}; "plain" first) from ``state`` on
    ``batch``, in turns by CUDA events, 3 calls a turn."""
    st = {}

    def stepper(name):
        st[name] = state

        def one():
            st[name] = steps[name](st[name], batch)[0]
        return one

    ms = in_turns({n: stepper(n) for n in steps}, dict.fromkeys(steps, 3))
    print(f"{label}: the step at B={len(batch['past'])}, in turns by CUDA events: " + ", ".join(
        f"{n} {ms[n]:.3f} ms ({ms[n] / ms['plain']:.2f}x)" for n in steps) + f" ({smi})", flush=True)


def grid_transformer_30(dev, smi):
    """21 (a): transformer-30 at TRAIN_B through train.train_loop on
    sp_apply_fn (ring and gather) and pp_apply_fn (M = 2 and 4) on
    [cuda:0] x 2, each against the plain ("xla") loop from the same state,
    its in-loop evaluation counted; then the steps in turns."""
    cfg = get_preset(TF_PRESET, batch_size=TRAIN_B, steps=GRID_STEPS, eval_every=1, train_impl="xla")
    fam = transformer
    train_d, test_d = synthetic_windows(cfg)
    test_d = {k: v[:1024] for k, v in test_d.items()}
    init = train.init_state(cfg, fam.init, train.make_optimizer(cfg), device=dev)
    run = dict(device=dev, state=init, eval_data=test_d, extras_fn=fam.batch_extras)
    ref, ref_hist = train.train_loop(cfg, fam.init, fam.apply, train_d, **run)
    runs = grid_runs(dev)
    for name, apply_fn in runs.items():
        (state, hist), _ = drive(f"train {TF_PRESET} {name}",
                                 lambda: train.train_loop(cfg, fam.init, apply_fn, train_d, **run), also=GRID_EVAL)
        check_gaps(f"train {TF_PRESET} {name}", *trajectory_gaps(hist, ref_hist, state, ref), smi)
    opt = train.make_optimizer(cfg)
    steps = {name: train.make_train_step(cfg, fn, opt, gc_metric=False, extras_fn=fam.batch_extras)
             for name, fn in {"plain": fam.apply, **runs}.items()}
    batch = {k: torch.as_tensor(v, device=dev) for k, v in next(train.batch_iterator(train_d, TRAIN_B, seed=2)).items()}
    grid_step_times(f"train {TF_PRESET} sp / pp", cfg, steps, batch, init, smi)
    for name in ("plain", "sp ring [cuda:0]x2", "pp M=4 [cuda:0]x2"):  # where a sharded step's extra time goes
        profile_device(f"train {TF_PRESET} {name}: fast step", lambda name=name: steps[name](init, batch), 2, smi)


def grad_gap(ga, gb):
    return max((a - b).abs().max().item() / max(a.abs().max().item(), 1.0) for a, b in zip(ga, gb, strict=True))


def grid_transformer_10s(dev, smi, batch=1024):
    """21 (b): transformer-10s (100 + 100 frames, K = 4 peers, window 8) on
    four sequence shards of [cuda:0] (100 % 4 == 0: the encoder sharded too):
    one forward with noisy teacher forcing and its gradient, ring and
    gather, against plain apply and autograd with the same draw; forward
    and backward timed in turns."""
    cfg = get_preset(TF10_PRESET)
    m = cfg.model
    params = params_from_numpy(cli.bench_params_np(cfg, 0), dev)
    rng = np.random.default_rng(21)
    past, fut = unit_rows(rng, dev, (batch, m.h_in)), unit_rows(rng, dev, (batch, m.h_out))
    peers = unit_rows(rng, dev, (batch, cfg.n_other_users, m.h_out))
    mask = (randn(rng, dev, (batch, cfg.n_other_users)) > -0.5).float()
    mesh = sp.make_sp_mesh(4, devices=[dev] * 4)
    fns = {"plain": lambda p, g: transformer.apply(p, m, past, fut, rng=g, teacher_prob=0.5, other_future_n=peers,
                                                   other_mask=mask)}
    for impl in ("ring", "gather"):
        fns[f"sp {impl} [cuda:0]x4"] = lambda p, g, impl=impl: sp.sp_decode(
            p, m, mesh, past, fut, rng=g, teacher_prob=0.5, other_future_n=peers, other_mask=mask, impl=impl)

    def fwd_bwd(fn):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        out = fn(tree_unflatten(params, leaves), torch.Generator(device=dev).manual_seed(5))
        return out.detach(), torch.autograd.grad(((out - fut) ** 2).mean(), leaves)

    ref, g_ref = fwd_bwd(fns["plain"])
    for name, fn in list(fns.items())[1:]:
        out, g = fwd_bwd(fn)
        fwd, grad = (out - ref).abs().max().item(), grad_gap(g_ref, g)
        print(f"{TF10_PRESET} {name}: B={batch}, the encoder sharded, one forward within {fwd:.3e} of plain apply "
              f"(gate {GRID_FWD_TOL}), its gradient within {grad:.3e} of autograd's over max(max|g|, 1) (gate "
              f"{GRID_GRAD_TOL}) ({smi})", flush=True)
        if not (fwd <= GRID_FWD_TOL and grad <= GRID_GRAD_TOL):
            raise AssertionError(f"{TF10_PRESET} {name}: the sharded pass leaves JAX's bounds")
    ms = in_turns({n: (lambda fn=fn: fwd_bwd(fn)) for n, fn in fns.items()}, dict.fromkeys(fns, 2))
    print(f"{TF10_PRESET}: forward and gradient at B={batch}, in turns by CUDA events: " + ", ".join(
        f"{n} {ms[n]:.3f} ms ({ms[n] / ms['plain']:.2f}x)" for n in fns) + f" ({smi})", flush=True)


def grid_tensor_parallel(dev, smi):
    """21 (c): seq2seq-tf-30 at TRAIN_B on a (2 data, 2 model) grid of
    [cuda:0] x 4: the decode against plain decode, one gradient against
    autograd's, 3 steps against the single card's plain ("xla") step; the
    steps in turns."""
    cfg = get_preset(PRESET, batch_size=TRAIN_B, train_impl="xla")
    m = cfg.model
    params = params_from_numpy(oracle.init_params_np(0, m), dev)
    mesh = parallel.make_mesh(dev, model_parallel=2, devices=[dev] * 4)
    rng = np.random.default_rng(22)
    batch = {"past": unit_rows(rng, dev, (TRAIN_B, m.h_in)), "future": unit_rows(rng, dev, (TRAIN_B, m.h_out))}
    past_n, fut_n, _ = windows.normalize_window(batch["past"], batch["future"])
    dec = (tp.tp_apply(tp.apply_tp_shardings(params, mesh), m, past_n) - seq2seq.decode(params, m, past_n)).abs().max()

    def grads(apply_fn):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        out = apply_fn(tree_unflatten(params, leaves), m, past_n, fut_n)
        return torch.autograd.grad(((out - fut_n) ** 2).mean(), leaves)

    tp_fn = tp.tp_apply_fn(mesh)
    grad = max((a - b).abs().max().item() for a, b in zip(grads(seq2seq.apply), grads(tp_fn)))
    label = f"train {PRESET} tp (2 data, 2 model) [cuda:0]x4"
    print(f"{label}: B={TRAIN_B}, the decode within {dec.item():.3e} of plain decode (gate {TP_DECODE_TOL}), a "
          f"gradient within {grad:.3e} of autograd's (gate {TP_GRAD_TOL}) ({smi})", flush=True)
    if not (dec <= TP_DECODE_TOL and grad <= TP_GRAD_TOL):
        raise AssertionError(f"{label}: leaves JAX's bounds")
    opt = train.make_optimizer(cfg)
    steps = {"plain": train.make_train_step(cfg, seq2seq.apply, opt),
             "tp (2, 2)": train.make_train_step(cfg, tp_fn, opt)}
    init = train.TrainState(params, opt.init(params), 0, torch.Generator())
    states, hists = {}, {}
    for name, step in steps.items():
        st, hists[name] = init, []
        for _ in range(GRID_STEPS):
            st, met = step(st, batch)
            hists[name].append({"loss": float(met["loss"])})
        states[name] = st
    check_gaps(label, *trajectory_gaps(hists["tp (2, 2)"], hists["plain"], states["tp (2, 2)"], states["plain"]), smi)
    fast = {n: train.make_train_step(cfg, fn, opt, gc_metric=False)
            for n, fn in (("plain", seq2seq.apply), ("tp (2, 2)", tp_fn))}
    grid_step_times(label, cfg, fast, batch, init, smi)


def grid_cli(smi):
    """21 (d): the CLI on the one card: --seq-parallel 2 on transformer-30
    exits with JAX's one-chip device-count message, on seq2seq-tf-30 with
    its family message."""
    n = torch.cuda.device_count()
    _, code = quiet_cli(["train", "--preset", TF_PRESET, "--seq-parallel", "2", "--steps", "1", "--device", "cuda"])
    want = f"need 2 devices for dp=1 x sp=2, have {n}" if n < 2 else 0
    _, family = quiet_cli(["train", "--preset", PRESET, "--seq-parallel", "2", "--steps", "1", "--device", "cuda"])
    print(f"train --preset {TF_PRESET} --seq-parallel 2 on {n} card(s): {code!r}; on {PRESET}: {family!r} ({smi})",
          flush=True)
    if code != want or not str(family).startswith("--seq-parallel applies to the transformer family only"):
        raise AssertionError("train --seq-parallel did not refuse as JAX's CLI does")


def drive_grids(dev, smi):
    """Phase 21: sequence, pipeline and tensor parallelism, (a) to (d)."""
    t0 = time.perf_counter()
    grid_transformer_30(dev, smi)
    torch.cuda.empty_cache()
    grid_transformer_10s(dev, smi)
    torch.cuda.empty_cache()
    grid_tensor_parallel(dev, smi)
    grid_cli(smi)
    print(f"phase 21 sequence, pipeline and tensor parallelism: {time.perf_counter() - t0:.1f} s ({smi})", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device; this script runs only on the card")
    dev = torch.device("cuda:0")
    fused_lstm.exact_f32_matmul()  # the plain versions and cuDNN in exact f32, as the kernels
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}", flush=True)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    # the states that phases 5, 7, 9 and 14 train, saved for phase 19's simulations
    state_dir = tempfile.TemporaryDirectory()

    phase("2 build")
    # 2. build every kernel source, one nvcc each, started together
    sources = ("fused_serve", "lstm_train", "lstm_ss", "lstm_align", "conv_resize", "transformer_encode",
               "transformer_decode", "transformer_encode_train")
    global PROBE_BUILD, PROBE_TRAIN_BUILD
    def build_and_read(name):  # each library's SASS read as soon as it is built, beside the other builds
        b = _build.build(name)
        sass(b.path)
        return b

    with ThreadPoolExecutor(max_workers=len(sources) + 2) as pool:
        probes = [pool.submit(_build.build, name, ("TFM_PROBE",))
                  for name in ("transformer_encode", "transformer_encode_train")]
        builds = dict(zip(sources, pool.map(build_and_read, sources)))
        PROBE_BUILD, PROBE_TRAIN_BUILD = (p.result() for p in probes)
    BUILD_LOGS.update({name: b.log for name, b in builds.items()})
    for name, b in builds.items():
        print(f"build: {name}.cu by nvcc in {b.seconds:.2f} s ({b.path.name}) {ptxas_report(b.log)}", flush=True)
    for name, b in (("transformer_encode", PROBE_BUILD), ("transformer_encode_train", PROBE_TRAIN_BUILD)):
        print(f"build: {name}.cu -DTFM_PROBE (the time split's probe) by nvcc in {b.seconds:.2f} s", flush=True)
    report_tensor_cores(builds)
    report_peer_bwd(builds)
    report_lstm_mma(builds)
    report_decode_mma(builds)
    report_train_mma(builds)

    phase("3 kernels vs plain")
    # 3. every kernel against its plain version at full width; the f32
    # encoder's time splits
    check_all_kernels(dev)
    report_f32_splits(dev, smi)

    phase("4 serve seq2seq-tf-30")
    # 4. seq2seq-tf-30 serving
    cfg = get_preset(PRESET)
    fam = get_family(cfg.model_family)
    params_np = oracle.init_params_np(0, cfg.model)
    params = params_from_numpy(params_np, dev)
    _, s2s_serve = drive(S2S_SERVE, lambda: drive_s2s_serving(cfg, fam, dev, params_np, params))
    serve_bench(PRESET, ((16384, 10), (262144, 3)), smi)
    time_serve_kernel("fused_serve", dev, params, cfg, 262144, 3, 0, smi)

    phase("4b serve seq2seq-tf-30, cell=pallas and decode_fused")
    # 4b. the same preset on the one-step cell kernel (the cell="pallas"
    # plain path behind the batcher) and on the decode kernel (decode_fused)
    s2s_cell = drive_cell_serving(dev, params_np, params, 16384)
    s2s_decode = drive_decode_fused(dev, params_np, params)
    time_cell_paths(dev, params, smi)
    torch.cuda.empty_cache()

    phase("5 train seq2seq-tf-30")
    # 5. seq2seq-tf-30 training
    tcfg = get_preset(PRESET, batch_size=TRAIN_B, steps=40, eval_every=10, ckpt_every=20, train_impl="fused")
    trained, train_d, s2s_train = drive_training(tcfg, S2S_TRAIN, dev, also=["fused_serve"])
    keep_state(tcfg, trained, state_dir.name)
    time_training(tcfg, trained, train_d, S2S_TRAIN, smi, plain_iters=5)
    time_lstm_kernels(dev, smi)
    time_dw_pack(dev, smi)
    # train --train-compute bfloat16: both kernels of the stack in the bf16 compute type
    s2s_train_bf16 = drive_bf16_training(tcfg, S2S_TRAIN_BF16, dev, ["fused_serve"], smi)


    phase("6 serve stacked-ss-crossuser")
    # 6. stacked-ss-crossuser serving
    ccfg = get_preset(CU_PRESET)
    cparams, cu_serve = drive_cu_serving(ccfg, dev, cli.bench_params_np(ccfg, 0), CU_SERVE, 48, 1000)
    serve_bench(CU_PRESET, ((16384, 5), (65536, 3)), smi)
    profile_device(f"{CU_SERVE}: serve call at B=65536", serve_call(ccfg, cparams, dev, 65536), 2, smi)
    time_serve_kernel("fused_serve_ctx", dev, cparams, ccfg, 65536, 3, ccfg.model.ctx_dim, smi)
    for batch, with_library in ((65536, False), (16384, True)):
        time_encode_kernel(dev, batch * ccfg.n_other_users, smi, with_library)

    phase("7 train stacked-ss-crossuser")
    # 7. stacked-ss-crossuser training: teacher_prob anneals 1 → 0 over the run
    ctcfg = get_preset(CU_PRESET, batch_size=TRAIN_B, steps=30, eval_every=10, ckpt_every=15)
    # logged steps evaluate through the serving kernels; the encoder and the
    # peer encoder train on lstm_seq_states
    ctrained, ctrain_d, cu_train = drive_training(ctcfg, CU_TRAIN, dev, also=[
        "fused_serve", "fused_encode", "lstm_seq_states_fwd", "lstm_seq_states_bwd", "lstm_seq_states_dw",
        "lstm_dw_pack"])
    keep_state(ctcfg, ctrained, state_dir.name)
    step = time_training(ctcfg, ctrained, ctrain_d, CU_TRAIN, smi, plain_iters=2)
    profile_device(f"{CU_TRAIN}: fast step", step, 5, smi)
    time_ss_kernels(dev, smi)
    # the bf16 compute type: the encoder and the decoder in bf16, the static
    # context's peer encoder in f32, as in JAX
    cu_train_bf16 = drive_bf16_training(ctcfg, CU_TRAIN_BF16, dev, [
        "fused_serve", "fused_encode", "lstm_seq_states_fwd", "lstm_seq_states_bwd", "lstm_seq_states_dw",
        "lstm_dw_pack", "lstm_seq_states_fwd_bf16", "lstm_seq_states_bwd_bf16", "lstm_seq_states_dw_bf16",
        "lstm_dw_pack_bf16"], smi)
    torch.cuda.empty_cache()

    phase("8 serve stacked-ss-crossuser-10s")
    # 8. stacked-ss-crossuser-10s serving: K = 7 time-aligned peers, 100 + 100 frames
    c10cfg = get_preset(CU10_PRESET)
    c10params, cu10_serve = drive_cu_serving(c10cfg, dev, cli.bench_params_np(c10cfg, 0), CU10_SERVE, 24, 200)
    check_grouped(c10cfg, dev, c10params, rows=1000, n_videos=5)
    serve_bench(CU10_PRESET, ((16384, 2), (65536, 1)), smi)
    profile_device(f"{CU10_SERVE}: serve call at B=65536", serve_call(c10cfg, c10params, dev, 65536), 2, smi)
    time_peer_serve(dev, c10params, c10cfg, 65536, 1, smi)
    for batch, with_library in ((65536, False), (4096, True)):
        time_peer_context(dev, c10params["peer_encoder"], batch, c10cfg.n_other_users, c10cfg.model.h_out, smi,
                          with_library)
    # K = 16 (predict --peers 16) over the same 28,672 peer rows as B = 4096, K = 7
    time_peer_context(dev, c10params["peer_encoder"], 1792, 16, c10cfg.model.h_out, smi, True, keep=False)
    torch.cuda.empty_cache()

    phase("9 train stacked-ss-crossuser-10s")
    # 9. stacked-ss-crossuser-10s training through aligned_ss_decode; the
    # evaluation serves through the lockstep tier, the encoder trains on
    # lstm_seq_states (f32 residuals), dproj on ss_decode's kernel
    c10tcfg = get_preset(CU10_PRESET, batch_size=TRAIN_B, steps=20, eval_every=10, ckpt_every=10)
    c10trained, c10train_d, cu10_train = drive_training(c10tcfg, CU10_TRAIN, dev, also=[
        "fused_serve_peers", "peer_context", "lstm_seq_states_fwd", "lstm_seq_states_bwd", "lstm_seq_states_dw",
        "ss_decode_dproj", "lstm_dw_pack"], step_tol=ALIGN_STEP_REL_TOL)
    keep_state(c10tcfg, c10trained, state_dir.name)
    step = time_training(c10tcfg, c10trained, c10train_d, CU10_TRAIN, smi, plain_iters=1, kernel_iters=5)
    peer_bwd_share(f"{CU10_TRAIN}: fast step", profile_device(f"{CU10_TRAIN}: fast step", step, 3, smi), smi)
    del step, c10trained
    torch.cuda.empty_cache()
    time_aligned_kernels(dev, smi)
    time_lstm_10s(dev, smi)
    report_dw(smi)
    torch.cuda.empty_cache()
    # the bf16 compute type: peers, decoder and (f32 residuals) the encoder
    cu10_train_bf16 = drive_bf16_training(c10tcfg, CU10_TRAIN_BF16, dev, [
        "fused_serve_peers", "peer_context", "lstm_seq_states_fwd_bf16", "lstm_seq_states_bwd_bf16",
        "lstm_seq_states_dw_bf16", "ss_decode_dproj_bf16", "lstm_dw_pack_bf16"], smi, steps=4, rows=256, iters=3)
    torch.cuda.empty_cache()

    phase("9b train at hidden 256 and at 8 layers")
    # 9b. the widths and depths the backward takes again: one step of both
    # crossuser presets at hidden 256 and at 8 layers, through the kernels
    check_wide_steps(dev, smi)
    torch.cuda.empty_cache()

    phase("10 features video-fusion")
    # 10. the feature path: extract-features on the card, prepare-data --features
    with tempfile.TemporaryDirectory() as tmp:
        fu_windows, fe_launches = drive_features(dev, tmp, smi)
    torch.cuda.empty_cache()

    phase("11 serve video-fusion")
    # 11. video-fusion serving: features in every request; the maps mode
    fcfg = get_preset(FU_PRESET)
    fparams, fu_serve = drive_fu_serving(fcfg, dev, cli.bench_params_np(fcfg, 0), 48, 1000)
    serve_bench(FU_PRESET, ((16384, 5), (65536, 3)), smi)
    profile_device(f"{FU_SERVE}: serve call at B=65536", fu_serve_call(fcfg, fparams, dev, 65536), 2, smi)
    time_serve_kernel("fused_serve_ctx", dev, fparams, fcfg, 65536, 3, fcfg.model.ctx_dim, smi, keep=False)
    torch.cuda.empty_cache()

    phase("12 train video-fusion")
    # 12. video-fusion training on the extracted features: the encoder on
    # lstm_seq_states, the decoder on ss_decode at C = 64; evaluation serves
    # through the static-context fused_serve
    ftcfg = get_preset(FU_PRESET, batch_size=TRAIN_B, steps=30, eval_every=10, ckpt_every=15)
    ftrained, ftrain_d, fu_train = drive_training(ftcfg, FU_TRAIN, dev, also=[
        "fused_serve", "lstm_seq_states_fwd", "lstm_seq_states_bwd", "lstm_seq_states_dw", "ss_decode_fwd",
        "ss_decode_bwd", "ss_decode_dw", "ss_decode_dproj", "lstm_dw_pack"], windows_=fu_windows)
    step = time_training(ftcfg, ftrained, ftrain_d, FU_TRAIN, smi, plain_iters=2)
    profile_device(f"{FU_TRAIN}: fast step", step, 5, smi)
    maps_step(ftcfg, ftrained, dev, smi)
    del step, ftrained
    torch.cuda.empty_cache()
    drive_bf16_training(ftcfg, FU_TRAIN_BF16, dev, [
        "fused_serve", "lstm_seq_states_fwd_bf16", "lstm_seq_states_bwd_bf16", "lstm_seq_states_dw_bf16",
        "ss_decode_fwd_bf16", "ss_decode_bwd_bf16", "ss_decode_dw_bf16", "ss_decode_dproj_bf16",
        "lstm_dw_pack_bf16"], smi,
        windows_=fu_windows)
    torch.cuda.empty_cache()

    phase("13 serve transformer-30")
    # 13. transformer-30 serving: K = 4 per-row peers in every request, the
    # encoder and decode kernels in bf16 (serve_fused's default on the card)
    # and, with an explicit compute dtype, in f32; serve-bench (bf16), a
    # profile of each tier, the kernels alone in both
    tfcfg = get_preset(TF_PRESET)
    tparams, tf_serve = drive_tf_serving(tfcfg, dev, cli.bench_params_np(tfcfg, 0), 48, 200)
    _, tf_serve_f32 = drive_tf_serving(tfcfg, dev, cli.bench_params_np(tfcfg, 0), 24, 100, path=TF_SERVE_F32,
                                       tier=torch.float32)
    serve_bench(TF_PRESET, ((16384, 3), (65536, 2)), smi)
    for tier in (torch.bfloat16, torch.float32):
        profile_device(f"{TF_SERVE}: {str(tier)[6:]} serve call at B=16384",
                       serve_call(tfcfg, tparams, dev, 16384, tier), 2, smi)
    time_tf_kernels(dev, tparams, tfcfg, 16384, smi, keep=True)
    time_decode_per_row(dev, tparams, tfcfg, 65536, smi, tier=BF, twin=False)  # row 9c at B = 65,536
    time_decode_per_row(dev, tparams, tfcfg, 65536, smi)  # row 9 at B = 65,536
    time_encode_f32(dev, tparams, tfcfg, 65536, smi, before="fused_encode_tokens B=65536")
    torch.cuda.empty_cache()

    phase("14 train transformer-30")
    # 14. transformer-30 training: the parallel pass with the encoder on
    # fused_encode_train's kernels (train_impl "auto"), noisy teacher forcing
    # 1 → 0.3 with its noise from (seed, step); evaluation serves through both
    # serving kernels; the resume bit-equal
    ttcfg = get_preset(TF_PRESET, batch_size=TRAIN_B, steps=20, eval_every=10, ckpt_every=10)
    ttrained, ttrain_d, tf_train = drive_training(ttcfg, TF_TRAIN, dev, also=[
        "fused_encode_tokens_bf16", "fused_ar_decode_bf16"], step_check=False, resume_tol=0.0)
    keep_state(ttcfg, ttrained, state_dir.name)
    tf_grad_check(ttcfg, ttrained, ttrain_d)
    time_tf_step(ttcfg, ttrained, ttrain_d, TF_TRAIN, smi)
    time_encode_train(dev, ttrained.params, ttcfg, TRAIN_B, smi)
    del ttrained
    torch.cuda.empty_cache()

    phase("15 serve transformer-10s, grouped")
    # 15. transformer-10s serving (100 + 100 frames, K = 4, window 8): the
    # batcher with per-row peers in front of the plain encoder (T = 100) and
    # the per-row decode kernel; serve-bench; the grouped gateway through the
    # shared tier against per-row serving, at the daemon's shape (the main
    # path of the shared tier) and at the matrix's batches, transformer-30's
    # too; profiles of a grouped and a per-row call
    t10cfg = get_preset(TF10_PRESET)
    t10params, _ = drive_tf_serving(t10cfg, dev, cli.bench_params_np(t10cfg, 0), 24, 100,
                                    path=TF10_SERVE, also=["fused_ar_decode_bf16"])
    drive_tf_serving(t10cfg, dev, cli.bench_params_np(t10cfg, 0), 12, 50, path=TF10_SERVE_F32,
                     also=["fused_ar_decode"], tier=torch.float32)
    serve_bench(TF10_PRESET, ((4096, 2), (16384, 1)), smi)
    drive(TF10_GROUPED, lambda: check_grouped_tf(t10cfg, dev, t10params, 256, 8, TF10_GROUPED),
          also=["fused_ar_decode_bf16"])
    _, tf10_grouped_f32 = drive(TF10_GROUPED_F32, lambda: check_grouped_tf(
        t10cfg, dev, t10params, 256, 8, TF10_GROUPED_F32, tier=torch.float32))
    profile_device(f"{TF10_SERVE}: f32 serve call at B=4096", serve_call(t10cfg, t10params, dev, 4096,
                                                                          torch.float32), 2, smi)
    for batch in (4096, 16384):
        check_grouped_tf(t10cfg, dev, t10params, batch, 8, TF10_GROUPED)
        time_grouped(t10cfg, dev, t10params, batch, 8, smi, TF10_GROUPED, profile=batch == 4096)
    time_shared_tier(dev, t10params, t10cfg, 4096, 8, smi)
    time_decode_per_row(dev, t10params, t10cfg, 4096, smi)
    time_decode_per_row(dev, t10params, t10cfg, 4096, smi, window=t10cfg.model.peer_window)  # f32 per row
    time_decode_per_row(dev, t10params, t10cfg, 4096, smi, window=t10cfg.model.peer_window, tier=BF)
    time_decode_per_row(dev, t10params, t10cfg, 16384, smi, window=t10cfg.model.peer_window, tier=BF, twin=False)
    torch.cuda.empty_cache()
    check_grouped_tf(tfcfg, dev, tparams, 16384, 8, f"{TF_SERVE} grouped")
    time_grouped(tfcfg, dev, tparams, 16384, 8, smi, f"{TF_SERVE} grouped")
    torch.cuda.empty_cache()

    phase("16 train transformer-10s")
    # 16. transformer-10s training at the matrix's B = 1024: the plain encoder
    # (T = 100 is past the kernels' 64, as in JAX), K = 4 peers, window 8,
    # noisy teacher forcing 1 → 0.3; evaluation serves through the per-row
    # decode kernel; the resume bit-equal; the plain encoder against the
    # nn.TransformerEncoder yardstick at T = 100
    t10tcfg = get_preset(TF10_PRESET, batch_size=1024, steps=20, eval_every=10, ckpt_every=10)
    t10trained, t10train_d, _ = drive_training(t10tcfg, TF10_TRAIN, dev, also=["fused_ar_decode_bf16"],
                                               step_check=False, resume_tol=0.0)
    time_tf_step(t10tcfg, t10trained, t10train_d, TF10_TRAIN, smi, iters=(2, 2))
    time_encoder_t100(dev, t10params, t10cfg, smi)

    phase("17 the bf16 tiers: bf16 serving and train --bf16")
    # 17. the serving kernels' bf16 tiers behind their entry points
    # (compute_dtype=bfloat16), the cell on a --bf16 model, then train --bf16
    # on five presets (the LSTM cells train on the f32 kernels with f32
    # gradients; the transformer on plain autograd in bf16, as in JAX), and
    # each bf16 tier alone against its f32 twin
    s2s_serve_bf16 = drive_bf16_serving(S2S_SERVE_BF16, cfg, seq2seq, dev, params, ((16384, 10), (262144, 2)), smi)
    cu_serve_bf16 = drive_bf16_serving(CU_SERVE_BF16, ccfg, cross_user, dev, cparams, ((16384, 5), (65536, 2)), smi)
    cu10_serve_bf16 = drive_bf16_serving(CU10_SERVE_BF16, c10cfg, cross_user, dev, c10params,
                                         ((16384, 1), (65536, 1)), smi)
    profile_device(f"{CU10_SERVE_BF16}: bf16 serve call at B=65536",
                   serve_call(c10cfg, c10params, dev, 65536, BF, cross_user), 2, smi)
    s2s_cell_bf16 = drive_cell_bf16(dev, params_np, smi)
    torch.cuda.empty_cache()
    lstm_kernels = ["lstm_seq_states_fwd", "lstm_seq_states_bwd", "lstm_seq_states_dw", "lstm_dw_pack"]
    ss_kernels = ["ss_decode_fwd", "ss_decode_bwd", "ss_decode_dw", "ss_decode_dproj"]
    drive_bf16_params(PRESET, dev, lstm_kernels, smi)
    drive_bf16_params(CU_PRESET, dev, lstm_kernels + ss_kernels, smi)
    drive_bf16_params(CU10_PRESET, dev, lstm_kernels + ["ss_decode_dproj"] + [
        name for name, *_, p in KERNELS if p == CU10_TRAIN], smi, steps=4, rows=256, iters=2)
    drive_bf16_params(FU_PRESET, dev, lstm_kernels + ss_kernels, smi, windows_=fu_windows)
    drive_bf16_params(TF_PRESET, dev, [], smi, steps=4)
    torch.cuda.empty_cache()
    time_bf16_serving_kernels(dev, params, cparams, ccfg, c10params, c10cfg, smi)

    phase("18 predict, export and the daemon")
    # 18. export, predict (the lockstep tier at K = 7 and 16, the transformer's
    # grouped gateway) and the TCP daemon on the card
    drive_slice_c(dev, smi)
    torch.cuda.empty_cache()

    phase("19 trace ingest and the simulations")
    # 19. logs written in the Tsinghua layout, validated, ingested through the
    # C library; stream-sim, serve, predict --traces, eval --plot and train
    # --tb-dir on the card against the CPU
    drive_ingest(dev, smi)
    state_dir.cleanup()
    torch.cuda.empty_cache()

    phase("20 data parallelism")
    # 20. train_loop_dp over NCCL (a world of one) and over gloo (two ranks
    # on the one card), the CLI under the launcher, sharded serving and the
    # daemon on a mesh of the one card named four times
    drive_dp(dev, smi)
    torch.cuda.empty_cache()

    phase("21 sequence, pipeline and tensor parallelism")
    # 21. the transformer's training pass sequence- and pipeline-parallel and
    # the seq2seq family tensor-parallel, on grids of the one card, each
    # against the single card's plain path; the CLI's one-card refusals
    drive_grids(dev, smi)
    torch.cuda.empty_cache()

    phase("done")
    launches = {S2S_SERVE: s2s_serve, S2S_CELL: s2s_cell, S2S_DECODE: s2s_decode, S2S_TRAIN: s2s_train,
                CU_SERVE: cu_serve, CU_TRAIN: cu_train, CU10_SERVE: cu10_serve, CU10_TRAIN: cu10_train,
                FE_PATH: fe_launches, TF_SERVE: tf_serve, TF_SERVE_F32: tf_serve_f32, TF_TRAIN: tf_train,
                TF10_GROUPED_F32: tf10_grouped_f32, S2S_TRAIN_BF16: s2s_train_bf16, CU_TRAIN_BF16: cu_train_bf16,
                CU10_TRAIN_BF16: cu10_train_bf16, S2S_SERVE_BF16: s2s_serve_bf16, CU_SERVE_BF16: cu_serve_bf16,
                CU10_SERVE_BF16: cu10_serve_bf16, S2S_CELL_BF16: s2s_cell_bf16}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "path": path,
         "launches": launches[path][name], "max_abs_err": ERRS[name], **TIMES[name],
         "launches_on_paths": {p: n[name] for p, n in PATH_LAUNCHES.items() if name in n}}
        for name, src, rep, _, path in KERNELS
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    t0 = time.time()
    main()
    print(f"chip_smoke: {time.time() - t0:.1f} s", file=sys.stderr)
