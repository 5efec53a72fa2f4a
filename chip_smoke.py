"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA, print the card's name and power limit;
2. build: compile every CUDA source of ``src/repro_torch/csrc`` with nvcc
   (in parallel) and warm up the Triton kernels;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes the serving and training paths give it, with its
   time, its plain version's time, a library call's time where one exists,
   and its bound (the least time the card could take for the same work);
4. serve gemma3-1b at full width and depth (26 layers, bf16, seeded random
   weights): (a) fixed batch 4, prompt 1024, 32 new tokens, q8 cache;
   (b) the same with a q4 cache; (c) the continuous scheduler, 8 requests
   of 200-1000 prompt tokens and 32 new tokens each through 4 slots, q8.
   Each run starts with the launch counts at 0 and must launch every
   kernel of its path; bytes/token must equal the wire accounting; logits
   must be finite; prefill logits must match the same forward in reference
   mode, and decode from the same caches in reference mode must give every
   request the same tokens and leave the same caches; the decode, which
   replays a CUDA graph of the decode step (the launcher's default on the
   card), must give the same tokens, caches and launch counts as the same
   run with ``graph=False`` (for (c) the eager scheduler: its later
   requests reuse the slots of the graph captured at the first chunk),
   with decode tokens/s both ways and the capture's seconds printed;
   torch.profiler splits the device time of (a)'s prefill and (b)'s decode
   step by kernel;
5. train ResNet-18 at full width, the paper's layout (5 workers x 128
   images, 32x32x3, 10 classes, seeded init, f32: the phase turns both
   TF32 flags on, PyTorch's cuDNN default, and every step must find them
   off, as the training entry point sets them, and both back on after
   it), a few steps each of (d) LQ-SGD rank 1, b = 8, (e) LQ-SGD rank 1,
   b = 4 and (f) QSGD b = 4, each step a CUDA-graph replay (the entry
   point's default on the card: warm-up, capture, replays). Each run
   starts with the launch counts at 0 and must launch every kernel of its
   path; the same run with ``graph=False`` must equal it bit for bit
   (losses, every step's bits, synced gradients and wire arrays, final
   parameters, launch counts), with ms/step both ways; every step's wire
   bits must equal the static accounting (370136 bits for (d), 3.655093
   MB/epoch) and its collectives the count from the plans; losses must be
   finite; and the same run in reference mode, from the same init and
   batches, must ship the same codes (but for one-step bin-edge flips;
   QSGD's bytes exactly, from the same per-leaf generators) and end with
   the same synced gradients and parameters, within the tolerance of
   :func:`train_tol`;
6. serve mamba2-370m at full width and depth (48 Mamba-2 layers, bf16,
   seeded random weights; f32 matmuls with TF32 off, as phase 1 sets),
   fixed scheduler: (g1) batch 4, prompt 1024 (4 chunks), 32 new tokens,
   raw and with ``--cache-bits 8`` (which leaves the SSM cache raw);
   (g2) batch 4, prompt 1000 (a ragged last chunk); (g3) batch 1, prompt
   8192 (32 chunks). Each prefill launches ``ssd_chunk`` once per layer and
   each decode step none; prefill logits and caches must match the same
   prefill in reference mode; greedy tokens are compared with a
   reference-mode run; the graphed decode must equal the eager one
   (tokens, caches, launches), as in phase 4; bytes/token must equal the
   accounting (48290.909 for (g1), the JAX package's figure);
7. the gradient-inversion trust claim (paper §V-C), run last, after
   phases 8, 9 and 10 (its (h2) graph = eager check failed after (i) and (j)
   until the attack step's backward ran on one thread:
   ``core/privacy/gia.py``), through
   ``python -m repro_torch.bench.gia_ssim``'s ``bench``: (h1) the JAX
   benchmark's sweep as it stands (its 2-conv victim net, a 16x16x3 target,
   all 8 methods, 10 victim steps, attacks at steps 0 and 9, best of 8
   restarts, 300 sign-Adam steps) and (h2) the same harness on ResNet-18 at
   full width (one 32x32x3 target; sgd, lq_sgd_r1, lq_sgd_r1_b4), in f32:
   the phase turns both TF32 flags on and every victim sync and gradient
   must find them off. Each run starts with the launch counts at 0 and
   must launch the LQ-SGD kernels; every victim step's observed gradient
   must equal the same run's in reference mode (codes but for one-step
   bin-edge flips, synced gradients within :func:`train_tol`) and its bits
   the accounting; at (h1)'s cold start SGD must leak more than 0.15 SSIM,
   and at its steady state at least as much as LQ-SGD r1 by the mean best
   SSIM of 8 restarts over 32 groups (the JAX package's own claims). Every
   attack replays a CUDA graph of its step (the harness's default on the
   card); the (sgd, cold_start) cell's attack, run again graphed and with
   ``graph=False``, must give equal x̂ and losses and the main run's SSIM.
   It prints the SSIM table, the seconds of that attack both ways, the ms
   of one batched attack step, its idle share and a torch.profiler split
   of (h2)'s;

8. the composite compressor on ResNet-18 as in phase 5 (TF32 turned on
   first and found off in every step): (i1) the per-leaf policy
   ``fc=qsgd:bits=4,stage3=lq_sgd:rank=1:bits=4,*=lq_sgd:bits=8`` (a QSGD
   b4 group, LQ-SGD b4 and b8 sub-groups), warm-up 2 with the rebuild at
   step 2, fused, 6 steps, and the ``policy="auto"`` plan under the H100's
   cost model printed (not trained); (i2) LQ-SGD r1 b8 fused with lazy
   aggregation (tau 2.0, max_stale 2), 8 steps, in ``lazy_mode="elide"``,
   ``"gate"`` and elide in reference mode; (i3) the server wire
   (participation 0.5, tau 1.5, max_stale 4) on non-IID shards (Dirichlet
   alpha 0.3), 8 steps. Each kernel run starts with the launch counts at 0
   and must launch the kernels of its path; against reference mode the
   fire patterns, participation masks and contributions are equal, codes
   equal but for one-step flips, QSGD's bytes exact, synced gradients of
   every step and final parameters within :func:`train_tol`; elide equals
   gate bit for bit (synced gradients, parameters, every state tensor,
   effective bits and collectives); a skipped elide round gathers nothing,
   launches nothing and runs one collective; every step's effective bits
   equal the accounting (the static sideband plus the payload of what
   fired or contributed) and, on the server wire, the downlink 32 bits a
   parameter. Every step's grad / sync / update ms is printed, (i2)'s sync
   split by fired and skipped rounds;
9. LM training, the JAX package's main path (``train/step.py`` under the
   runtime), gemma3-1b at full width (999,826,048 parameters, bf16, seeded
   random weights) over 4 simulated workers of 2 rows x 512 tokens, each
   step one CUDA-graph replay with the state donated and the layer
   pattern rematerialized (the launcher's jitted step), with
   deterministic algorithms on (warn only; ops without one are named):
   first one eager step at smoke widths under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync in the step);
   (j1) LQ-SGD r1 b8, Adam lr 1e-3, the sync ``Trainer``, 3 steps graphed
   and the same with ``graph=False``, equal bit for bit (the step-0
   gradients into the sync, every step's synced gradients, wire arrays,
   bits and losses, the final parameters, the launch counts), then the
   graphed run in reference mode: every step's tokens (read from the
   step's batch buffer) equal numpy's ``lm_batch``, the step-0 gradients
   into the sync are equal bit for bit, wire codes equal but for one-step
   flips, every step ships 9,236,960 bits (the JAX package's figure) in
   the plans' collectives, the step-0 synced gradients and the final
   parameters agree within the bounds stated at ``BF16_ULP``; launches of
   #1 and #5 but not #3, #6 or #7; then, with deterministic algorithms
   off, the graphed step, the eager step and the eager step without
   rematerialization timed (tokens/s, peak memory, capture seconds, the
   device idle share 1 - replay / eager host time) and a replay's device
   time by kernel. (j2) LQ-SGD r1 b4 (4,624,864 bits), SGD lr 0.05,
   microbatch 2, 4 steps, through ``AsyncRunner`` (prefetch 2, metrics
   every step) and through ``Trainer``, both over the graphed step: equal
   bit for bit (parameters, compressor state, metrics); #3 and #5 launch;
   the host-blocked fraction of both printed. (j3) at gemma3-1b's smoke
   widths: a background checkpoint at step 2 restored and run on to step
   4 (the graphed step binding to the restored state) equals 4 steps at
   once bit for bit, and a failed write raises on ``drain()``;
10. the randomized privacy codecs (``dlog``, ``lrq``: plain-torch draws and
   rounding, the nibble pack #2 and the dequant #5 on the card), before
   phase 7: (k1) (j1)'s run (gemma3-1b full width, 4 workers x 2 x 512,
   LQ-SGD r1 b8, Adam, 3 steps, deterministic algorithms on) with
   ``dp_epsilon`` 48, so every leaf is dlog and the step the composite's
   eager one: every step ships (j1)'s 9,236,960 bits in the plans'
   collectives, the per-step epsilon is the JAX package's 7056, the step-0
   gradients into the sync equal (j1)'s bit for bit; against the same run
   in reference mode, from the same generators, step 0's raw and P gathers
   are equal, every later code equal but for one-step flips (#5's 2-ulp
   difference reaches the Q phase, where a dither may round the other
   way), the synced gradients and parameters within the bounds stated at
   ``BF16_ULP``; #5 launches and #1, #2, #3 do not; ms a step, the sync's
   ms split into the randomized codes and the rest (CUDA events), peak
   memory. (k2) ResNet-18 as (d)/(e) (TF32 turned on first and found off in
   every step): at each of its 62 leaf shapes the zero-noise dlog b8 and
   lrq b4 ``codec_phase`` equal ``log``'s bit for bit (#1, #3, #5); dlog
   b4 at 16 and lrq b4 with 2 layers, 3 steps each: (e)'s bits every step,
   every nibble a b4 code, #2 and #5 launch, step 0's raw and P gathers
   equal reference mode's and every later code but for one-step flips,
   the synced gradients and parameters within ``train_tol``, one seed the
   same bytes twice and another seed other bytes; at (j)'s largest factor
   and ResNet-18's largest leaf, over 64 reseeded encodes: unbiasedness in
   16 bins of x within 5 standard errors, dlog's noise std within 3% of
   ``gaussian_sigma``, lrq's spread rising with its layers. (k3)
   ``bench/gia_ssim.py``'s Pareto sweep (the 2-conv victim, 10 victim
   steps, the steady-state attack, best of 8 restarts x 300 sign-Adam
   steps, graphed): each row's wire bits (2056 / 49216) and per-step
   epsilon (80.0, 240.0, 428.9773445944901) ``BENCH_privacy.json``'s,
   ``_pareto_gate`` passed at the JAX tolerances; the table and the attack
   seconds printed;
11. the model zoo (the untied head and the MoE layers), right after phase
   4, each model freed before the next is built: (l1) mistral-nemo-12b at
   full width on 20 of its 40 layers (6,794,982,400 parameters), batch 4,
   prompt 1024, 32 new tokens, q8 then q4; (l2) granite-20b (26 of 52
   layers, MQA), q8; (l3) mixtral-8x7b at full width cut to 16 of its 32 layers,
   batch 2, prompt 5120 (past its window of 4096), q8; (l4) jamba-v0.1-52b,
   one period of its 8 layers (7 Mamba-2, 4 with MoE, 1 attention), batch
   4, prompt 1024, q8 (the attention cache only). Each as phase 4's (a):
   prefill logits against reference mode, the routing held to the kernel
   run's (``models/moe.py:routing``), with the flips reference mode would
   make counted per MoE layer, each at a margin below MOE_FLIP_MARGIN, and
   the assignments dropped at capacity printed; (l4)'s prefill caches as
   (g1)'s; the graphed decode equal to the eager one; decode from the same
   caches in reference mode with the same tokens and caches; bytes/token
   the accounting; #1 or #3, #4 and #6 launched, #7 once a Mamba-2 layer
   a prefill; peak memory. (l5) MoE training: mixtral-8x7b's widths with
   one MoE layer (1,713,418,240 parameters), 2 workers x 2 x 512, LQ-SGD
   r1 b8, Adam, 3 steps, deterministic algorithms on: graphed = eager bit
   for bit (losses, moe_aux, bits, synced gradients, parameters,
   launches), every step 2,626,336 bits (the JAX package's), against
   reference mode with the routing held as (j1); ms a step both ways.
   Phase 3 holds #6 at head_dim 128 (4-way GQA, 48-way MQA, the 4096
   window at 5120), #4 on 128- and 64-byte rows and #7 at jamba's 128
   heads of state 16 to their plain versions, with times and bounds.
12. the model zoo's last two and Mamba-2 training, right after phase 11
   (``phase_zoo_rest``: (m1)-(m5), see ``_zoo_serve`` / ``_zoo_train``);
13. data parallelism across processes, right after phase 9: (n1) (j1)'s
   run (gemma3-1b full width, 4 workers x 2 x 512, LQ-SGD r1 b8, Adam, 3
   steps, deterministic algorithms on) through an NCCL ``DistComm`` of
   world 1 holding the 4 workers, in this process: each step one
   CUDA-graph replay with its collectives captured, bit for bit (j1)'s
   ``SimComm`` run (step-0 gradients into the sync, every step's synced
   gradients, gathered wire arrays, bits, losses, final parameters,
   launches), then ms a step graphed and eager against (j1)'s; (n2)
   ResNet-18 as (d) over 4 gloo ranks sharing the card, 1 worker x 128
   each, 2 eager steps, ``launch/train_resnet.py`` in the 2x2 torchrun of
   ``phase_tp`` (phases 13-17 share their torchruns): every rank's
   gathers byte for byte, synced gradients, losses and parameters equal
   to ``SimComm(4)``'s in this process, the gathered bits plus the scales
   the accounting, the ranks' launches of #1 and #5 counted, ms a step and
   its share in the collectives; (n3) ``launch.train`` at gemma3-1b's
   smoke widths over 2 gloo ranks on the card (the 1x2 torchrun), a
   checkpoint at step 2 resumed in this process equal to 4 steps at once;
14. the compressors that raised across ranks before, right after phase
   3, while this process holds little device memory: 2 gloo ranks x 2
   workers sharing the card, in the 1x2 torchrun that phases 14-17 share
   (``phase_tp``; ``_o_rank``), drive (o1)
   (f)'s QSGD b4, (o2) a dlog / log / lrq b4 policy with a warm-up step
   and lazy groups (elide), (o3) (i3)'s server wire (gate) and (o4)
   (k1)'s gemma3-1b at full width (its error feedback in bf16) through
   the launchers with ``--deterministic --dump``; then each launcher and
   its arguments here over ``SimComm(4)``: every gather, the accounting,
   the lazy counters and participation flags, synced gradients, losses,
   parameters and the compressor state's rows bit for bit ((o1) from step
   0 only: QSGD's raw leaves psum in the ring's order), the kernels
   launched on each rank, ms a step and its share in the collectives, the
   draws' ms a step (all N workers' values, and a rank's rows alone)
   against the sync's, and (o4)'s peak memory a rank.
15. tensor-parallel serving, right after phase 14 (this process again
   holds little device memory; (p3)'s ranks hold 3.6 B parameters
   between them): #1, #3, #4 and #6 at the ranks' shapes against their plain
   versions, then for each of (p1) gemma3-1b at a 1x2 mesh, q8 (the cache
   split by sequence), (p2) gemma3-1b at 2x2, q4 (the batch over data too)
   and (p3) mistral-nemo-12b at 1x2, q8 (the cache split by KV heads), all
   full width, (p1) and (p2) at 14 of gemma3-1b's 26 layers, (p3) at 10
   of its 40 (``P_REPEATS``), batch 4, prompt 1024, 16 new tokens: the
   launcher in this process (graphed decode), then, in the torchrun of
   its mesh that phases 15-17 share (``phase_tp``, ``TP_SPAWNS``), its
   gloo ranks sharing the card (``_p_rank``: ``launch/serve.py``'s
   ``main`` with ``--mesh``, eager decode, then a teacher-forced decode on
   this process's tokens). Each
   rank's prefill and teacher-forced logits within LOGITS_REL_TOL of the
   one-process run's, its free-running greedy tokens equal but where the
   one-process margin is below P_TOKEN_MARGIN, its cache shard against
   the block of the one-process cache its spec cuts (``_p_caches``), the
   ranks' bytes/token shares summing to the one-process figure; each
   rank's launches of #1 or #3, #4 and #6, prefill ms, decode ms a token,
   share of host time in collectives and peak memory.
16. tensor-parallel training, right after phase 15: #1, #3 and #5 at the
   ranks' factor shapes against their plain versions, then for each of
   (q1) gemma3-1b whole at a 2x2 mesh, 2 workers x 4 x 512 (the global
   batch of (j1)), LQ-SGD r1 b8 and Adam, and (q2) mistral-nemo-12b at
   full width on 2 of its 40 layers at 1x2, 1 x 2 x 512, LQ-SGD r1 b4 and
   SGD, 3 steps each: ``launch/train.py`` in this process (``--mesh
   Dx1``, graphed, ``--dump --dump-steps``), then, in the shared torchrun
   of its mesh, its gloo ranks (``_q_rank``: the launcher's ``main`` with
   ``--mesh``, eager, then a graphed step under gloo, which must raise).
   Each rank's
   losses within Q_LOSS_REL of the one-process run's, its step-0 synced
   gradient within Q_SYNC_SHARE of each leaf's largest value where no
   wire code it is made of moved, the codes moved at step 0 reported per
   phase, the accounted bits the JAX package's figure and the data-axis
   collectives the plan's every step, each data row's physical bits the
   accounting plus (M - 1) x the bits replicated over the model axis, the
   replicated leaves' fingerprints equal on every rank after every step;
   each rank's launches of #1 or #3 and #5, ms a step, its shares in
   model-axis and data-axis collectives, and its peak memory.
17. tensor-parallel serving of the rest of the zoo and the continuous
   scheduler, right after phase 16: #1, #3, #4, #6 and #7 at the ranks'
   shapes against their plain versions, then per mesh the one-process
   runs in this process (eager, their MoE routing recorded) and, in the
   shared torchrun of each mesh (``chip_smoke.py --tp-spawn-rank DIR
   MESH``, ``tp_spawn_rank_main``, which runs the mesh's (p), (q) and (r)
   runs in turn, their device memory returned between runs), its gloo
   ranks: at 1x2 (r1) jamba-v0.1-52b one period, q8, (r3)
   deepseek-v3-671b on 4 of 61 layers, q8 latent cache, (r4)
   musicgen-medium on 12 of 48 layers after its prefix, q4, each
   ``launch/serve.py``'s ``main`` with ``--mesh`` and the one-process
   routing held, then a teacher-forced decode on the one-process tokens;
   at 2x2 (r2) mamba2-370m on 12 of 48 layers, raw cache, the same, and
   (r5) gemma3-1b on 14 of 26 layers through the continuous scheduler
   (``run_continuous`` over (c)'s 8 requests, 4 slots, q8). All at full
   width, batch 4, prompt 1024, 16 new tokens. Checks as phase 15's, plus
   every rank's raw SSM state and conv window within LOGITS_REL_TOL of
   the block of the one-process one, MoE flips from the ranks' own
   router logits at margins <= MOE_FLIP_MARGIN, and (r5)'s requests equal
   up to a token at a one-process margin below P_TOKEN_MARGIN; each
   run's kernels launched on every rank (``R_KERNELS``).
18. tensor-parallel training of the rest of the zoo, right after phase 17,
   run as phase 16's runs (``S_RUNS``, in the same shared torchruns): #1,
   #3 and #5 at the ranks' factor shapes against their plain versions,
   then at 1x2 (s1) mixtral-8x7b one MoE layer (4 of 8 experts a rank),
   b8, Adam, (s2) deepseek-v3-671b's 3 dense MLA lead layers and the MTP
   head, b8, SGD and a bf16 error feedback, (s3) jamba-v0.1-52b positions
   1 and 4 of its period (a Mamba-2 layer with a MoE FFN of 16 experts,
   and the attention layer), b8, SGD, (s4) musicgen-medium on 6 of 48
   layers with its codebooks and conditioning prefix, b4, Adam, and at
   2x2 (s5) mamba2-370m on 6 of 48 layers, b8, Adam; all at full width, 2
   x 512 tokens a worker, 3 steps, LQ-SGD r1. Phase 16's checks, plus
   every rank's ce, mtp_ce and moe_aux within Q_LOSS_REL of the
   one-process run's, the router's and MLA's ``wq_a`` / ``wkv_a`` step-0
   synced gradients printed, the accounted bits of (s1) and (s5) the JAX
   package's (``S_BITS``), and each rank's step-0 MoE choices against the
   one-process run's, a flip only at a router margin (from the rank's own
   logits) <= MOE_FLIP_MARGIN.
19. training over a (data, model) mesh with every compressor, in the 2x2
   torchrun after phase 18's (s5) (``T_RUNS``, ``_t_rank``,
   ``_t_one_process``, ``_t_checks``): gemma3-1b whole at (q1)'s shapes,
   bf16, Adam 1e-3, with (t1) TopK 1%, (t2) QSGD b4, (t3) LQ-SGD r1 b8
   over dlog at DP epsilon 48, (t4) r1 b4 over lrq, (t5) a per-leaf
   policy of two lazy groups after a warm-up step (a warm fire, skips and
   a forced fire in 4 steps), (t6) r1 b8 on the server wire at
   participation 0.5, each against the one-process launcher. Phase 16's
   checks (the synced gradient with TopK's swap allowance, QSGD's moved
   elements held through their codes), plus TopK's k entries a worker
   and leaf, (t5)'s fire pattern and (t6)'s participation flags the one
   process's on every rank, (t3)'s DP epsilon the JAX package's figure,
   a lazy round's physical bits without its skipped groups; each run's
   kernels launched on every rank (``T_KERNELS``), the phase's seconds
   and the script's disk writes printed;
20. the dry run (``launch/dryrun.py``), right after phase 9 (u): (u1) the
   CLI in a subprocess traces gemma3-1b ``train_4k`` and ``decode_32k`` on
   the H100 production mesh (32 x 8 over a fake process group of 256
   ranks) with fake CUDA tensors, and prints its records; meanwhile (u2)
   traces (j1)'s own configuration in this process (gemma3-1b, one
   process, 4 workers x 2 x 512, LQ-SGD r1 b8, Adam) and holds it to
   (j1)'s timed run: the argument bytes equal (j1)'s state and batch bytes
   exactly, the traced peak lies within ``U2_PEAK_REL`` x + ``U2_PEAK_SLACK``
   of ``torch.cuda.max_memory_allocated`` over (j1)'s eager step, the trace
   allocates nothing on the card, and the counted FLOPs over (j1)'s replay
   ms are printed as a share of 989 TFLOP/s (``mfu``).

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Nothing of JAX is imported.
"""

import contextlib
import functools
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over the memory rate and its operations
# over the peak rate for their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}
# f32 operations per value of the log-quant maps (abs, scale, log1p/expm1,
# divide, sign, level multiply, round, clip), counted from the formula
QUANT_OPS, DEQUANT_OPS = 10, 7
# integer operations per code of the nibble pack (mask, shift, or), counted
# at the f32 rate: the table of peaks has no int32 ALU rate, and the pack's
# bound is its bytes by a factor of ~30 at either rate
PACK_OPS = 2

ARCH = "gemma3-1b"
BATCH, PROMPT, GEN = 4, 1024, 32
REPEATS = 4  # gemma3-1b's scan leaves stack 4 repeats of LLLLLG
N_REQUESTS, SLOTS = 8, 4
# Prefill last-position logits, kernel path vs the same forward in reference
# mode, both bf16 through 26 layers: the flash kernel and the plain
# attention round to bf16 at different points, and the difference is carried
# through every later layer. Bound: max |diff| <= 5% of max |logit|; and in
# every row whose reference top-2 margin exceeds twice the row's max |diff|,
# the same argmax.
LOGITS_REL_TOL = 5e-2
# Decode, kernel path vs reference mode from the same caches: the encode and
# dequant kernels match their plain versions bit for bit off bin edges and
# decode attention is plain torch in both, so greedy tokens must be equal.
# Caches after decode: codes equal but for one-step bin-edge flips; scales
# within 1% of the largest (a flip moves what later layers see).
CACHE_SCALE_REL_TOL = 1e-2

TRAIN_WORKERS, TRAIN_BATCH, TRAIN_HW, TRAIN_CLASSES = 5, 128, 32, 10
TRAIN_STEPS, TRAIN_LR = 3, 0.05
CIFAR_TRAIN_IMAGES = 50_000
# (i1) three handler groups: fc by QSGD b4, stage3 by LQ-SGD r1 b4, the rest
# by LQ-SGD b8; warm-up for 2 steps, rebuilt at step 2
I1_SPEC = "fc=qsgd:bits=4,stage3=lq_sgd:rank=1:bits=4,*=lq_sgd:bits=8"
I1_STEPS = 6
# (i2) symmetric lazy aggregation: a skip needs innovation below tau^2 = 4
# of the norm, and a fire is forced after 2 skips in a row
I2_THRESH, I2_MAX_STALE, I2_STEPS = 2.0, 2, 8
# (i3) the JAX federated benchmark's federated_gate / noniid_a0.3 setting
I3_STEPS, I3_ALPHA = 8, 0.3
# Training, kernel path vs reference mode from the same init and batches:
# the encodes match their plain versions but for one-step flips at bin
# edges and the dequant within 2 ulp, so synced gradients and parameters
# agree to f32 noise (1e-5 of a leaf's largest value over 3 steps) unless a
# code flipped. A one-step flip of one worker's code moves the mean code by
# 1/N level, which scales that value by at most (1 + alpha)^(1/(N L)); the
# bound then is twice that change. QSGD's path differs only in the exact
# pack, so its bytes, gradients and parameters must be equal.
ALPHA = 10.0

# the hand-written kernels of a gemma3-1b step, by a substring of the kernel
# name the profiler reports, for the step's device time by kernel
GEMMA_KERNELS = {"flash_attention": "flash_fwd", "dequant": "dequant_rows"}
MATMUL_KERNELS = ("gemm", "gemv", "cutlass", "xmma", "nvjet")  # cuBLAS

SSM_ARCH = "mamba2-370m"
# (g1) batch 4, prompt 1024 (4 chunks of 256); (g2) prompt 1000, a ragged
# last chunk; (g3) one prompt of 8192 (32 chunks), the long-prompt case
SSM_RUNS = {"g1": (4, 1024), "g2": (4, 1000), "g3": (1, 8192)}
SSM_GEN = 32
# (g1)'s cache: conv (48, 4, 3, 2304) bf16 + ssm (48, 4, 32, 64, 128) f32 =
# 203,980,800 bytes over 4 x 1056 positions, the JAX package's
# cache_bytes_per_token for this shape
SSM_G1_BYTES_PER_TOKEN = 203_980_800 / (4 * 1056)
# ssd_chunk vs its plain version, f32: max abs error <= 1e-4 of max |Y|.
# Both sum up to N + Q = 384 f32 products an entry, in other orders (K eps
# = 2.3e-5 for K = 384).
SSD_REL_TOL = 1e-4
# Prefill, kernel path vs reference mode: the intra-chunk term may differ
# from the plain version's in the last f32 bits (another summation order),
# every layer casts its output to bf16, where such a difference now and
# then flips a rounding (2^-8 relative), and 48 layers carry the flips on.
# Logits: LOGITS_REL_TOL and the argmax rule, as for gemma3-1b; caches
# (conv window, SSM state): within 5% of each leaf's largest value.
SSM_CACHE_REL_TOL = 5e-2


# Phase 9, LM training (j): gemma3-1b at full width (26 layers, d 1152,
# vocab 262144, bf16, seeded random weights) over 4 simulated workers of 2
# rows x 512 tokens each (the launcher's --mesh 4x1 --batch 8 --seq 512)
LM_ARCH = "gemma3-1b"
LM_MESH = (4, 1)
LM_BATCH, LM_SEQ = 8, 512
J1_STEPS, J1_LR = 3, 1e-3  # LQ-SGD r1 b8, Adam, the sync Trainer
J1_TIMED_STEPS = 5  # the timed runs: warm-up, capture, 3 steps timed
J2_STEPS, J2_LR, J2_MICROBATCH = 4, 0.05, 2  # LQ-SGD r1 b4, SGD, k = 2
J3_STEPS = 4  # checkpoint at 2, restore, continue (smoke widths)
# the JAX package's make_model_compressor(get_config("gemma3-1b"), lq_sgd
# rank 1, b8 / b4).wire_bits_per_step() (tests/test_torch_lm_layout.py)
J1_BITS, J2_BITS = 9_236_960, 4_624_864
# (j1) against reference mode. The sync returns the synced gradient in the
# parameters' bf16, so a 2-ulp f32 difference of the wire dequant may round
# it the other way: one bf16 ulp (2^-8) of the leaf's largest value on top
# of train_tol. The parameters: Adam's step of a coordinate for t <= 3 is
# at most 1.01 lr (Cauchy-Schwarz on its bias-corrected moving averages at
# beta 0.9 / 0.999), and a gradient as close as one ulp gives the same
# step but for its rounding: so without code flips the final parameters
# differ by train_tol of how far they moved plus one bf16 ulp of the
# leaf's largest value; with flips, a coordinate whose gradient changed
# sign may move the other way, by up to 2 x 1.01 lr a step.
BF16_ULP = 2.0**-8
ADAM_STEP_MAX = 1.01

# Phase 20, the dry run (u). (u2)'s traced peak of live bytes against the
# caching allocator's peak over (j1)'s eager step: the trace counts storage
# bytes as they are; the card adds the allocator's rounding (512 B a block)
# and the libraries' workspaces (cuBLAS's, kept across the script's
# phases), so within 10% of the measured peak plus 256 MiB
U2_PEAK_REL, U2_PEAK_SLACK = 0.10, 256 * 2**20
# (u1): counted FLOPs within 15% of the analytic model with the attention
# term charged as the plain attention computes it (tests/test_torch_dryrun.py)
U1_ANALYTIC_REL = 0.15
U1_SHAPES = ("train_4k", "decode_32k")

# Phase 10, the randomized privacy codecs (k). (k1): (j1)'s run with dlog at
# a per-use budget of 48; the JAX package's per-step epsilon for it, 2 x 48
# a low-rank leaf and 48 a raw one (tests/test_torch_privacy_codecs.py)
K1_EPSILON, K1_STEPS = 48.0, 3
K1_EPS_PER_STEP = 7056.0
# (k2): dlog b4 at a budget of 16 and lrq b4 with 2 layers on (e)'s run
K2_RUNS = {
    "dlog_b4_eps16": dict(name="lq_sgd", rank=1, bits=4, dp_epsilon=16.0),
    "lrq_b4_2_layers": dict(name="lq_sgd", rank=1, bits=4, codec="lrq", lrq_layers=2),
}
# (k2)'s statistics: 64 reseeded encodes; unbiasedness by the deviation of
# the mean expand from x in 16 bins of x, each within 5 standard errors;
# dlog's noise std at a budget of 48 (sigma 0.101: |x| <= 0.5 saturates
# beyond 5 sigma) within 3% of sigma, its dither adding < 0.4%
K2_DRAWS, K2_BINS, K2_Z_BOUND, K2_SEED = 64, 16, 5.0, 11
K2_STD_EPSILON, K2_STD_TOL = 48.0, 0.03
# (k3): BENCH_privacy.json's wire bits (the b4 wire; post-hoc's f32) and
# per-step epsilons, by row
K3_BITS = (2056, 49216)
K3_EPS = {
    "lq_det": None,
    "lq_dlog_eps16": 80.0,
    "posthoc_eps16": 80.0,
    "lq_dlog_eps48": 240.0,
    "posthoc_eps48": 240.0,
    "lq_lrq": 428.9773445944901,
}

# Phase 7, the GIA runs: (h1) the JAX benchmark's victim net, (h2) ResNet-18
GIA_RUNS = {"h1": "cnn", "h2": "resnet18"}
# the JAX package's claims (tests/test_privacy.py): at the cold start the
# attack recovers structure from the raw gradient (SSIM above 0.15); at the
# steady state SGD leaks at least as much as LQ-SGD r1
GIA_COLD_SSIM_MIN = 0.15
# The steady-state claim is about the benchmark's statistic, the best SSIM of
# 8 restarts, whose spread between draws is larger than the effect: over 16
# harness seeds SGD's best of 8 minus LQ-SGD r1's was 0.139 +- 0.186 (sd) on
# the CPU and 0.068 +- 0.235 on the H100, below 0 in 4 and 5 of them
# (tools/gia_ordering.py). One draw does not decide it, so the check takes
# the mean best of 8 over 32 groups of 8 restarts (256 restarts in one
# batched attack a method, the same starting images for both methods).
GIA_ORDER_RESTARTS, GIA_ORDER_GROUP = 256, 8
# the device-time split of an attack step: cuDNN's convolutions by kernel name
CONV_KERNELS = ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd")


def train_tol(bits, flips, workers=TRAIN_WORKERS):
    if flips == 0:
        return 1e-5
    levels = (1 << (bits - 1)) - 1
    # a code's largest step (its top one), of the factor's largest value
    step = ((1 + ALPHA) - (1 + ALPHA) ** ((levels - 1) / levels)) / ALPHA
    return 2 * ((1 + ALPHA) ** (1 / (workers * levels)) - 1)


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters):
    """Mean device time of ``fn`` in ms: ``iters`` calls captured into one
    CUDA graph (after a warm-up call on a side stream) and replayed between
    CUDA events, so the host's launch overhead between calls is not timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, repeats=3):
    """Median host time of ``fn`` in ms, each call ending in a device sync:
    what a caller waits for, launch overhead included."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def device_ms_by_kernel(fn):
    """Device time of one warm call of ``fn`` by kernel name, from
    torch.profiler: {name: [ms, launches]}; empty where the profiler saw no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            ms_n = by_name.setdefault(evt.name, [0.0, 0])
            ms_n[0] += evt.time_range.elapsed_us() / 1e3
            ms_n[1] += 1
    return by_name


def bound_ms(n_bytes, n_ops, kind):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[kind]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# --------------------------------------------------------------------- phases
def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; it needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    v = sys.version.split()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {v}")
    return card


def phase_build():
    from repro_torch.kernels import build, log_quant

    t0 = time.perf_counter()
    names = sorted(p.stem for p in build.CSRC_DIR.glob("*.cu"))
    libs = build.build_all(names)
    t_nvcc = time.perf_counter() - t0
    for name, so in libs.items():
        report = so.with_suffix(".log")
        for line in report.read_text().splitlines() if report.exists() else []:
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    x = torch.randn(4096, device="cuda")
    # every launch shape of the encode, the fused encode + pack (its table
    # counts packed bytes) and the wire dequant, at the unit scale their
    # callers pass; then every launch shape of the bare pack
    warm_ups = (
        (log_quant.QUANTIZE_LAUNCH, 1, log_quant.log_quantize_triton, 8),
        (log_quant.PACK_LAUNCH, 2, log_quant.log_quantize_pack_triton, 4),
        (log_quant.DEQUANT_LAUNCH, 1, log_quant.log_dequantize_triton, 8),
    )
    for table, per_row, kernel, bits in warm_ups:
        for top, _, _ in table:
            n = per_row * top if top else 1 << 20
            kernel(torch.randn(n, device="cuda"), 1.0, bits=bits)
    codes = log_quant.log_quantize_triton(x, 1.0, bits=8).clamp(-8, 7)
    for top, _, _ in log_quant.NIBBLE_LAUNCH:  # in packed bytes, two codes each
        n = 2 * top if top else 1 << 20
        log_quant.pack_nibbles_triton(codes.repeat(n // codes.numel()))
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    print(
        f"build: {len(names)} CUDA source(s) by nvcc in {t_nvcc:.1f} s, "
        f"Triton warm-up done at {t_all:.1f} s"
    )


def _near_half(x, bits):
    """Where the exact pre-rounding value q*L of normalized ``x`` lies within
    1e-4 of a half-integer: there the device's log1p may round either way."""
    levels = (1 << (bits - 1)) - 1
    # a code's largest step (its top one), of the factor's largest value
    step = ((1 + ALPHA) - (1 + ALPHA) ** ((levels - 1) / levels)) / ALPHA
    u = torch.log1p(10.0 * x.double().abs()) / math.log1p(10.0) * levels
    return ((u - u.floor()) - 0.5).abs() < 1e-4


def _code_flips(got, want, near, label):
    """Codes must be equal, except by one step where ``near`` holds."""
    diff = (got.int() - want.int()).abs()
    bad = (diff > 1) | ((diff == 1) & ~near)
    check(not bool(bad.any()), f"{label}: {int(bad.sum())} codes differ off a bin edge")
    flips = int((diff > 0).sum())
    print(f"  {label}: codes equal but {flips} one-step flip(s) at bin edges")
    return int(diff.max())


def _rows(gen, shape):
    """Normalized rows as the encode gets them: ``shape`` f32, each last-dim
    row divided by its max |x|; on a max_seq axis the rows past the prompt
    are zero, as in prefill's padded cache."""
    x = torch.randn(shape, generator=gen, device="cuda")
    if shape[-2] == PROMPT + GEN:
        x[..., PROMPT:, :] = 0
    scale = x.abs().amax(-1, keepdim=True)
    return x / torch.where(scale > 0, scale, torch.ones_like(scale)), scale


def phase_kernels(gen):
    from repro_torch.configs import get_config
    from repro_torch.core.codec import unpack_nibbles
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.log_dequant_rows import log_dequantize_rows_cuda
    from repro_torch.kernels.log_quant import (
        log_dequantize_triton,
        log_quantize_pack_triton,
        log_quantize_triton,
        pack_nibbles_triton,
    )
    from repro_torch.kernels.ssd_chunk import ssd_chunk_cuda

    results = {}
    layer = (BATCH, 1, PROMPT + GEN, 256)
    # the encodes' shapes on the serving path: prefill quantizes a tail
    # layer's K or V, and a scan leaf's K or V stacked over its repeats, in
    # one launch each; every decode step quantizes one token per layer (a
    # size below one program's block, so its tail is masked)
    encode_shapes = {
        "prefill layer": layer,
        "prefill scan leaf": (REPEATS,) + layer,
        "decode append": (BATCH, 1, 1, 256),
    }
    encoders = (
        ("log_quantize", 8, log_quantize_triton, ref.log_quantize_ref),
        ("log_quantize_pack", 4, log_quantize_pack_triton, ref.log_quantize_pack_ref),
    )
    print("kernels at the serving path's shapes")

    # ---- #1 log_quantize b = 8 and #3 log_quantize_pack b = 4; the prefill
    # layer's codes and scales feed #4 below
    layer_codes = {}
    for where, shape in encode_shapes.items():
        xn, scale = _rows(gen, shape)
        n = xn.numel()
        main = where == "prefill layer"
        if main:
            layer_scale = scale
        for name, bits, kernel, plain in encoders:
            got, want = kernel(xn, 1.0, bits=bits), plain(xn, 1.0, bits, 10.0)
            if main:
                layer_codes[bits] = want
            if bits <= 4:
                got, want = unpack_nibbles(got, n), unpack_nibbles(want, n)
            err = _code_flips(
                got.reshape(-1),
                want.reshape(-1),
                _near_half(xn, bits).reshape(-1),
                f"{name} b={bits} {where} {shape}",
            )
            out_bytes = n * bits // 8
            b_ms, b_by = bound_ms(n * 4 + out_bytes, n * QUANT_OPS, "f32")
            res = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: kernel(xn, 1.0, bits=bits), 50),
                plain_ms=cuda_ms(lambda: plain(xn, 1.0, bits, 10.0), 20),
                bound_ms=b_ms,
                bound_by=b_by,
                library_ms=None,
            )
            emit({"kernel": name, "shape": list(shape), **res})
            if main:
                results[name] = res

    # ---- #4 log_dequantize_rows, q8 and q4: relative error <= 1e-6
    r, d = layer_scale.numel(), 256
    codes8, packed4 = layer_codes[8], layer_codes[4]
    s2 = layer_scale.reshape(r, 1).contiguous()
    errs = {}
    for bits, c in ((8, codes8.reshape(r, d)), (4, packed4.reshape(r, d // 2))):
        got = log_dequantize_rows_cuda(c, s2, bits=bits)
        want = ref.log_dequantize_rows_ref(c, s2, bits, 10.0)
        rel = (got - want).abs() / want.abs().clamp_min(1e-30)
        rel = rel.masked_fill(want == 0, 0)
        check(bool(((got == 0) == (want == 0)).all()), f"dequant q{bits}: zeros moved")
        check(float(rel.max()) <= 1e-6, f"dequant q{bits}: rel err {float(rel.max())}")
        errs[bits] = float((got - want).abs().max())
        nb = c.shape[1]
        b_ms, b_by = bound_ms(r * nb + r * 4 + r * d * 4, r * d * DEQUANT_OPS, "f32")
        res = dict(
            max_abs_err=errs[bits],
            ms=cuda_ms(lambda: log_dequantize_rows_cuda(c, s2, bits=bits), 50),
            plain_ms=cuda_ms(
                lambda: ref.log_dequantize_rows_ref(c, s2, bits, 10.0), 20
            ),
            bound_ms=b_ms,
            bound_by=b_by,
            library_ms=None,
        )
        print(f"  log_dequantize_rows q{bits}: max rel err {float(rel.max()):.2e}")
        emit({"kernel": f"log_dequantize_rows_q{bits}", **res})
        if bits == 8:
            results["log_dequantize_rows"] = res

    # ---- #6 flash attention, bf16, atol 2e-2 against the f32 plain version
    def qkv(s):
        q = torch.randn((BATCH, 4, s, 256), generator=gen, device="cuda")
        k = torch.randn((BATCH, 1, s, 256), generator=gen, device="cuda")
        v = torch.randn((BATCH, 1, s, 256), generator=gen, device="cuda")
        return [t.to(torch.bfloat16) for t in (q, k, v)]

    worst = 0.0
    for s, window in ((PROMPT, None), (PROMPT, 512), (1000, None)):
        q, k, v = qkv(s)
        got = flash_attention_cuda(q, k, v, window=window)
        want = ref.attention_ref(q.float(), k.float(), v.float(), window=window)
        e = float((got.float() - want).abs().max())
        check(e <= 2e-2, f"flash_attention S={s} window={window}: max err {e}")
        worst = max(worst, e)
        if s != PROMPT:
            print(f"  flash_attention ragged S={s}: max abs err {e:.2e}")
            continue
        kr, vr = (t.repeat_interleave(4, dim=1) for t in (k, v))
        i = torch.arange(s, device="cuda")
        mask = i[None, :] <= i[:, None]
        if window is not None:
            mask &= i[None, :] > i[:, None] - window
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if window is None:
            lib = lambda: sdpa(q, kr, vr, is_causal=True)
        else:
            lib = lambda: sdpa(q, kr, vr, attn_mask=mask)
        pairs = int(mask.sum()) * BATCH * 4
        n_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        b_ms, b_by = bound_ms(n_bytes, 4 * 256 * pairs, "bf16")
        res = dict(
            max_abs_err=e,
            ms=cuda_ms(lambda: flash_attention_cuda(q, k, v, window=window), 10),
            plain_ms=cuda_ms(lambda: ref.attention_ref(q, k, v, window=window), 5),
            bound_ms=b_ms,
            bound_by=b_by,
            library_ms=cuda_ms(lib, 10),
        )
        print(f"  flash_attention S={s} window={window}: max abs err {e:.2e}")
        emit({"kernel": f"flash_attention_window_{window}", **res})
        if window is None:
            results["flash_attention"] = res
    results["flash_attention"]["max_abs_err"] = worst

    print("kernels at the training path's shapes")
    # ---- #5 log_dequantize, within 2 ulp of the plain version: the
    # paper-mode mean of 5 workers' b=8 codes at the largest factor of
    # ResNet-18 (P of a 3x3x512 conv, 4608 x rank 1), and the decoded codes
    # of 5 workers for the largest raw leaf (512) under dequant_then_mean
    def codes(shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda").float()

    inputs = {
        "paper-mode mean": codes((TRAIN_WORKERS, 4608, 1)).mean(0),
        "raw codes": codes((TRAIN_WORKERS, 512)),
    }
    for where, c in inputs.items():
        shape = tuple(c.shape)
        got = log_dequantize_triton(c, 1.0, bits=8)
        want = ref.log_dequantize_ref(c, 1.0, 8, ALPHA)
        ulp = torch.nextafter(want.abs(), torch.full_like(want, math.inf)) - want.abs()
        check(bool(((got - want).abs() <= 2 * ulp).all()), f"dequant {where}: > 2 ulp")
        n = c.numel()
        b_ms, b_by = bound_ms(n * 4 + n * 4, n * DEQUANT_OPS, "f32")
        res = dict(
            max_abs_err=float((got - want).abs().max()),
            ms=cuda_ms(lambda: log_dequantize_triton(c, 1.0, bits=8), 50),
            plain_ms=cuda_ms(lambda: ref.log_dequantize_ref(c, 1.0, 8, ALPHA), 20),
            bound_ms=b_ms,
            bound_by=b_by,
            library_ms=None,
        )
        print(f"  log_dequantize {where} {shape}: max abs err {res['max_abs_err']:.2e}")
        emit({"kernel": "log_dequantize", "input": where, "shape": list(shape), **res})
        if where == "paper-mode mean":
            results["log_dequantize"] = res

    # ---- #2 pack_nibbles, exact: QSGD b=4 codes of ResNet-18's largest leaf
    # (3x3x512x512) over the 5 workers, packed in one launch
    shape = (TRAIN_WORKERS, 3, 3, 512, 512)
    c = torch.randint(-7, 8, shape, generator=gen, device="cuda").to(torch.int8)
    got, want = pack_nibbles_triton(c), ref.pack_nibbles_ref(c)
    check(torch.equal(got, want), "pack_nibbles: bytes differ from the plain version")
    n = c.numel()
    b_ms, b_by = bound_ms(n + (n + 1) // 2, n * PACK_OPS, "f32")
    res = dict(
        max_abs_err=0,
        ms=cuda_ms(lambda: pack_nibbles_triton(c), 50),
        plain_ms=cuda_ms(lambda: ref.pack_nibbles_ref(c), 20),
        bound_ms=b_ms,
        bound_by=b_by,
        library_ms=None,
    )
    print(f"  pack_nibbles {shape}: bytes equal to the plain version")
    emit({"kernel": "pack_nibbles", "shape": list(shape), **res})
    results["pack_nibbles"] = res

    print("kernels at the LM training path's shapes")
    # ---- #1 (b8), #3 (b4) and #5 at (j)'s largest factors: each of 4
    # workers' P of gemma3-1b's embedding (262144 x rank 1) and Q (1152),
    # scaled by the pmax over workers as codec_phase scales them; the wire
    # dequant of the mean b8 codes of that P
    for where, numel in (("embedding P", 262144), ("embedding Q", 1152)):
        x = torch.randn((LM_MESH[0], numel), generator=gen, device="cuda")
        xn = x / x.abs().amax()
        for name, bits, kernel, plain in encoders:
            got, want = kernel(xn, 1.0, bits=bits), plain(xn, 1.0, bits, ALPHA)
            if bits <= 4:
                got, want = (unpack_nibbles(t, xn.numel()) for t in (got, want))
            err = _code_flips(
                got.reshape(-1),
                want.reshape(-1),
                _near_half(xn, bits).reshape(-1),
                f"{name} b={bits} LM {where} {tuple(xn.shape)}",
            )
            n = xn.numel()
            b_ms, b_by = bound_ms(n * 4 + n * bits // 8, n * QUANT_OPS, "f32")
            res = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: kernel(xn, 1.0, bits=bits), 50),
                plain_ms=cuda_ms(lambda: plain(xn, 1.0, bits, ALPHA), 20),
                bound_ms=b_ms,
                bound_by=b_by,
                library_ms=None,
            )
            emit({"kernel": name, "lm": where, "shape": list(xn.shape), **res})
    c = codes((LM_MESH[0], 262144, 1)).mean(0)
    got = log_dequantize_triton(c, 1.0, bits=8)
    want = ref.log_dequantize_ref(c, 1.0, 8, ALPHA)
    ulp = torch.nextafter(want.abs(), torch.full_like(want, math.inf)) - want.abs()
    within = bool(((got - want).abs() <= 2 * ulp).all())
    check(within, "dequant LM embedding P: > 2 ulp")
    n = c.numel()
    b_ms, b_by = bound_ms(n * 8, n * DEQUANT_OPS, "f32")
    res = dict(
        max_abs_err=float((got - want).abs().max()),
        ms=cuda_ms(lambda: log_dequantize_triton(c, 1.0, bits=8), 50),
        plain_ms=cuda_ms(lambda: ref.log_dequantize_ref(c, 1.0, 8, ALPHA), 20),
        bound_ms=b_ms,
        bound_by=b_by,
        library_ms=None,
    )
    print(f"  log_dequantize LM embedding P {tuple(c.shape)}: within 2 ulp")
    emit({"kernel": "log_dequantize", "lm": "embedding P", "shape": [n, 1], **res})

    print("kernels at the SSM serving path's shapes")
    # ---- #7 ssd_chunk, f32, max abs error <= SSD_REL_TOL of max |Y|: one
    # prefill layer of mamba2-370m at (g1) 4 x 1024 and (g3) 1 x 8192 tokens
    cfg = get_config(SSM_ARCH)
    h, q = cfg.ssm_heads, cfg.ssm_chunk
    for run in ("g1", "g3"):
        batch, prompt = SSM_RUNS[run]
        x, a_cum, bm, cm = _ssd_inputs(gen, cfg, batch, prompt // q)
        got = ssd_chunk_cuda(x, a_cum, bm, cm)
        bh, ch = (t.expand(-1, h, -1, -1, -1) for t in (bm, cm))
        want = ref.ssd_chunk_ref(x, a_cum, bh, ch)
        err, top = float((got - want).abs().max()), float(want.abs().max())
        check(err <= SSD_REL_TOL * top, f"ssd_chunk ({run}): max err {err} of {top}")
        # the work the function needs over the causal pairs: S = C B^T once
        # per (batch, group, chunk), M X per (batch, head, chunk), in f32
        pairs = q * (q + 1) // 2
        groups = x.shape[0] * bm.shape[1] * x.shape[2]
        cells = x.shape[0] * h * x.shape[2]
        n_ops = pairs * (groups * 2 * cfg.ssm_state + cells * 2 * cfg.ssm_head_dim)
        n_bytes = 4 * (2 * x.numel() + bm.numel() + cm.numel() + a_cum.numel())
        b_ms, b_by = bound_ms(n_bytes, n_ops, "f32")
        per_head = cells * pairs * 2 * (cfg.ssm_state + cfg.ssm_head_dim)
        print(
            f"  ssd_chunk ({run}) work: {n_ops / 1e9:.3f} GFLOP with S once per "
            f"group ({per_head / 1e9:.3f} GFLOP if every head formed its own "
            f"S), {n_bytes / 1e6:.1f} MB"
        )
        res = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: ssd_chunk_cuda(x, a_cum, bm, cm), 10),
            plain_ms=cuda_ms(lambda: ref.ssd_chunk_ref(x, a_cum, bh, ch), 3),
            bound_ms=b_ms,
            bound_by=b_by,
            library_ms=None,
        )
        shape = list(x.shape)
        print(
            f"  ssd_chunk ({run}) x {shape}: max abs err {err:.2e}, "
            f"{err / top:.2e} of max |Y|; {res['ms']:.4f} ms, bound {b_ms:.4f} ms"
        )
        emit({"kernel": "ssd_chunk", "run": run, "shape": shape, **res})
        if run == "g1":
            results["ssd_chunk"] = res

    print("kernels at the model zoo's shapes (phase 11)")
    # ---- #6 at head_dim 128, bf16, atol 2e-2 against the f32 plain version:
    # (l1)'s 4-way GQA, (l2)'s 48-way MQA and (l3)'s window of 4096 at a
    # prompt past it; SDPA with enable_gqa, the window as an explicit mask
    # (SDPA's slow path)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for where, b, hq, hkv, s, window in (
        ("l1 gqa4", 4, 32, 8, 1024, None),
        ("l2 mqa48", 4, 48, 1, 1024, None),
        ("l3 window4096", 2, 32, 8, 5120, 4096),
    ):
        q = torch.randn((b, hq, s, 128), generator=gen, device="cuda").bfloat16()
        k = torch.randn((b, hkv, s, 128), generator=gen, device="cuda").bfloat16()
        v = torch.randn((b, hkv, s, 128), generator=gen, device="cuda").bfloat16()
        plain = ref.chunked_attention_ref if s > 2048 else ref.attention_ref
        got = flash_attention_cuda(q, k, v, window=window)
        want = plain(q.float(), k.float(), v.float(), window=window)
        e = float((got.float() - want).abs().max())
        check(e <= 2e-2, f"flash_attention {where}: max err {e}")
        del want
        i = torch.arange(s, device="cuda")
        mask = i[None, :] <= i[:, None]
        if window is not None:
            mask &= i[None, :] > i[:, None] - window
        if window is None:
            lib = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)
        else:
            lib = lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True)
        pairs = int(mask.sum()) * b * hq
        n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        b_ms, b_by = bound_ms(n_bytes, 4 * 128 * pairs, "bf16")
        res = dict(
            max_abs_err=e,
            ms=cuda_ms(lambda: flash_attention_cuda(q, k, v, window=window), 10),
            plain_ms=cuda_ms(lambda: plain(q, k, v, window=window), 3),
            bound_ms=b_ms,
            bound_by=b_by,
            library_ms=cuda_ms(lib, 10),
        )
        print(
            f"  flash_attention {where} q {list(q.shape)} k/v {list(k.shape)}: max "
            f"abs err {e:.2e}; {res['ms']:.4f} ms, bound {b_ms:.4f}, plain "
            f"{res['plain_ms']:.4f}, SDPA {res['library_ms']:.4f}"
        )
        emit({"kernel": "flash_attention", "zoo": where, "shape": list(q.shape), **res})
        del q, k, v, mask

    # ---- #4 on 128-code rows: (l1)'s K of one layer at decode, 4 x 8 heads x
    # 1056 positions, q8 (128 B a row) and q4 (64 B); relative error <= 1e-6
    r, d = BATCH * 8 * (PROMPT + GEN), 128
    x = torch.randn((r, d), generator=gen, device="cuda")
    scale = x.abs().amax(-1, keepdim=True)
    xn = x / scale
    for bits, c in (
        (8, ref.log_quantize_ref(xn, 1.0, 8, 10.0)),
        (4, ref.log_quantize_pack_ref(xn, 1.0, 4, 10.0).reshape(r, d // 2)),
    ):
        got = log_dequantize_rows_cuda(c, scale, bits=bits)
        want = ref.log_dequantize_rows_ref(c, scale, bits, 10.0)
        rel = (got - want).abs() / want.abs().clamp_min(1e-30)
        rel = rel.masked_fill(want == 0, 0)
        check(float(rel.max()) <= 1e-6, f"dequant q{bits} 128: rel {float(rel.max())}")
        nb = c.shape[1]
        b_ms, b_by = bound_ms(r * nb + r * 4 + r * d * 4, r * d * DEQUANT_OPS, "f32")
        res = dict(
            max_abs_err=float((got - want).abs().max()),
            ms=cuda_ms(lambda: log_dequantize_rows_cuda(c, scale, bits=bits), 50),
            plain_ms=cuda_ms(
                lambda: ref.log_dequantize_rows_ref(c, scale, bits, 10.0), 20
            ),
            bound_ms=b_ms,
            bound_by=b_by,
            library_ms=None,
        )
        print(
            f"  log_dequantize_rows q{bits}, {r} rows of {nb} B: max rel err "
            f"{float(rel.max()):.2e}; {res['ms']:.5f} ms, bound {b_ms:.5f}"
        )
        emit({"kernel": "log_dequantize_rows", "zoo": f"q{bits} {nb} B rows", **res})

    # ---- #7 at jamba-v0.1-52b's prefill layer: B 4, H 128, NC 4, Q 256, P 64,
    # N 16, one group
    jcfg = get_config("jamba-v0.1-52b")
    h, q = jcfg.ssm_heads, jcfg.ssm_chunk
    x, a_cum, bm, cm = _ssd_inputs(gen, jcfg, 4, 4)
    got = ssd_chunk_cuda(x, a_cum, bm, cm)
    bh, ch = (t.expand(-1, h, -1, -1, -1) for t in (bm, cm))
    want = ref.ssd_chunk_ref(x, a_cum, bh, ch)
    err, top = float((got - want).abs().max()), float(want.abs().max())
    check(err <= SSD_REL_TOL * top, f"ssd_chunk (l4): max err {err} of {top}")
    pairs = q * (q + 1) // 2
    groups = x.shape[0] * bm.shape[1] * x.shape[2]
    cells = x.shape[0] * h * x.shape[2]
    n_ops = pairs * (groups * 2 * jcfg.ssm_state + cells * 2 * jcfg.ssm_head_dim)
    n_bytes = 4 * (2 * x.numel() + bm.numel() + cm.numel() + a_cum.numel())
    b_ms, b_by = bound_ms(n_bytes, n_ops, "f32")
    res = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: ssd_chunk_cuda(x, a_cum, bm, cm), 10),
        plain_ms=cuda_ms(lambda: ref.ssd_chunk_ref(x, a_cum, bh, ch), 3),
        bound_ms=b_ms,
        bound_by=b_by,
        library_ms=None,
    )
    print(
        f"  ssd_chunk (l4) x {list(x.shape)}, N {jcfg.ssm_state}: max abs err "
        f"{err:.2e}, {err / top:.2e} of max |Y|; {res['ms']:.4f} ms, bound "
        f"{b_ms:.4f} ms, plain {res['plain_ms']:.4f}"
    )
    emit({"kernel": "ssd_chunk", "run": "l4", "shape": list(x.shape), **res})
    del x, a_cum, bm, cm, got, want
    _kernels_zoo_rest(gen)
    return results


def _kernels_zoo_rest(gen):
    """Phase 12's kernel shapes: #6 at MLA's head_dim 192 (128 nope + 64
    rope) at (m1)'s prefill, bf16, no GQA, V zero-padded from 128 as the
    model pads it, and a small f32 case; #4 on (m1)'s latent rows (ckv 512
    codes: 512 B at q8, 256 B at q4; krope 64: 64 and 32 B) and (m2)'s K
    rows (64 codes: 64 and 32 B)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.log_dequant_rows import log_dequantize_rows_cuda

    print("kernels at the zoo's last shapes (phase 12)")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for where, b, h, s, dtype, atol in (
        ("m1 mla192", 4, 128, 1024, torch.bfloat16, 2e-2),
        ("f32 mla192", 1, 4, 300, torch.float32, 1e-4),
    ):
        q = torch.randn((b, h, s, 192), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, h, s, 192), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, h, s, 128), generator=gen, device="cuda").to(dtype)
        v = torch.nn.functional.pad(v, (0, 64))
        got = flash_attention_cuda(q, k, v)
        want = ref.attention_ref(q.float(), k.float(), v.float())
        e = float((got.float() - want).abs().max())
        check(e <= atol, f"flash_attention {where}: max err {e}")
        check(bool((got[..., 128:] == 0).all()), f"flash_attention {where}: pad")
        del want
        pairs = s * (s + 1) // 2 * b * h
        n_bytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        b_ms, b_by = bound_ms(n_bytes, 4 * 192 * pairs, kind)
        res = dict(
            max_abs_err=e,
            ms=cuda_ms(lambda: flash_attention_cuda(q, k, v), 10),
            plain_ms=cuda_ms(lambda: ref.attention_ref(q, k, v), 3),
            bound_ms=b_ms,
            bound_by=b_by,
            library_ms=cuda_ms(lambda: sdpa(q, k, v, is_causal=True), 10),
        )
        print(
            f"  flash_attention {where} q/k/v {list(q.shape)} ({dtype}): max abs "
            f"err {e:.2e}; {res['ms']:.4f} ms, bound {b_ms:.4f}, plain "
            f"{res['plain_ms']:.4f}, SDPA {res['library_ms']:.4f}"
        )
        emit({"kernel": "flash_attention", "zoo": where, "shape": list(q.shape), **res})
        del q, k, v

    # rows of one layer's leaf: (m1) 4 x 1056 positions, (m2) 4 x 24 heads
    # x 1120 positions
    for where, r, d in (
        ("m1 ckv", 4 * (1024 + 32), 512),
        ("m1 krope", 4 * (1024 + 32), 64),
        ("m2 k", 4 * 24 * (64 + 1024 + 32), 64),
    ):
        x = torch.randn((r, d), generator=gen, device="cuda")
        scale = x.abs().amax(-1, keepdim=True)
        xn = x / scale
        for bits, c in (
            (8, ref.log_quantize_ref(xn, 1.0, 8, 10.0)),
            (4, ref.log_quantize_pack_ref(xn, 1.0, 4, 10.0).reshape(r, d // 2)),
        ):
            got = log_dequantize_rows_cuda(c, scale, bits=bits)
            want = ref.log_dequantize_rows_ref(c, scale, bits, 10.0)
            rel = (got - want).abs() / want.abs().clamp_min(1e-30)
            rel = float(rel.masked_fill(want == 0, 0).max())
            nb = c.shape[1]
            check(rel <= 1e-6, f"dequant {where} q{bits} {nb} B: rel {rel}")
            n_bytes = r * nb + r * 4 + r * d * 4
            b_ms, b_by = bound_ms(n_bytes, r * d * DEQUANT_OPS, "f32")
            res = dict(
                max_abs_err=float((got - want).abs().max()),
                ms=cuda_ms(lambda: log_dequantize_rows_cuda(c, scale, bits=bits), 50),
                plain_ms=cuda_ms(
                    lambda: ref.log_dequantize_rows_ref(c, scale, bits, 10.0), 20
                ),
                bound_ms=b_ms,
                bound_by=b_by,
                library_ms=None,
            )
            print(
                f"  log_dequantize_rows {where} q{bits}, {r} rows of {nb} B: max rel "
                f"err {rel:.2e}; {res['ms']:.5f} ms, bound {b_ms:.5f}, plain "
                f"{res['plain_ms']:.5f}"
            )
            emit(
                {
                    "kernel": "log_dequantize_rows",
                    "zoo": f"{where} q{bits} {nb} B rows",
                    **res,
                }
            )


def _ssd_inputs(gen, cfg, batch, nc):
    """One layer's ssd_chunk inputs at ``cfg``'s widths as the model hands
    them over: permuted views of x (B, NC, Q, H, P), a_cum and B/C per group
    (B, NC, Q, G, N). The per-step log-decay dt * A is drawn from [-1.6, 0],
    so a_cum falls to about -200 within a chunk of 256, as in the model."""
    q, h, g = cfg.ssm_chunk, cfg.ssm_heads, cfg.ssm_groups
    x = torch.randn((batch, nc, q, h, cfg.ssm_head_dim), generator=gen, device="cuda")
    a = -torch.rand((batch, nc, q, h), generator=gen, device="cuda") * 1.6
    bc = torch.randn((2, batch, nc, q, g, cfg.ssm_state), generator=gen, device="cuda")
    heads_first = (0, 3, 1, 2, 4)
    a_cum = torch.cumsum(a.permute(0, 3, 1, 2), dim=-1)
    bm, cm = (t.permute(heads_first) for t in bc)
    return x.permute(heads_first), a_cum, bm, cm


def _logits_close(got, want, label):
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{label}: non-finite logits")
    diff = (g - w).abs()
    rel = float(diff.max()) / float(w.abs().max())
    check(rel <= LOGITS_REL_TOL, f"{label}: logits vs reference mode rel {rel:.3e}")
    top2 = w.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * diff.amax(-1)
    agree = g.argmax(-1) == w.argmax(-1)
    check(bool((agree | ~decided).all()), f"{label}: argmax differs past its margin")
    print(
        f"  {label}: prefill logits vs reference mode rel {rel:.3e}, argmax equal "
        f"in {int(agree.sum())} of {agree.numel()} rows ({int(decided.sum())} "
        "decided by margin)"
    )


def _caches_match(got, want, label):
    """Two cache trees, leaf by leaf, by the rule of CACHE_SCALE_REL_TOL."""
    from repro_torch.core.codec import unpack_nibbles
    from repro_torch.serving.kv_cache import QuantKV, tree_leaves

    flips = 0
    for (path, g), (_, w) in zip(tree_leaves(got), tree_leaves(want), strict=True):
        if isinstance(g, QuantKV):
            gc, wc = g.codes, w.codes
            if g.bits <= 4:
                n = 2 * gc.shape[-1]
                gc, wc = unpack_nibbles(gc, n), unpack_nibbles(wc, n)
            diff = (gc.int() - wc.int()).abs()
            check(int(diff.max()) <= 1, f"{label}: cache codes at {path} differ")
            flips += int((diff > 0).sum())
            g, w = g.scale, w.scale
        g, w = g.float(), w.float()
        rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        check(rel <= CACHE_SCALE_REL_TOL, f"{label}: cache at {path}: rel {rel:.3e}")
    return flips


def _cache_tensors(caches):
    from repro_torch.serving.kv_cache import QuantKV, tree_leaves

    for path, leaf in tree_leaves(caches):
        if isinstance(leaf, QuantKV):
            yield path, leaf.codes
            yield path, leaf.scale
        else:
            yield path, leaf


def _graph_equals_eager(label, card, graphed, eager, counts, eager_counts):
    """A served run that replayed the decode step's CUDA graph against the
    same run with ``graph=False``: tokens and every cache tensor equal,
    the same launch counts; prints and emits decode tokens/s both ways and
    the capture's host seconds."""
    if "scheduler" in graphed:  # run_continuous
        check(graphed["tokens"] == eager["tokens"], f"{label}: graph tokens differ")
        caches = graphed["scheduler"].caches, eager["scheduler"].caches
        n_tokens = sum(len(t) for t in graphed["tokens"].values())
        secs = graphed["seconds"], eager["seconds"]
        what = "requests' tokens, end to end"
    else:
        same = torch.equal(graphed["tokens"], eager["tokens"])
        check(same, f"{label}: graph tokens differ from the eager decode")
        caches = graphed["caches"], eager["caches"]
        b, n = graphed["tokens"].shape[:2]  # (B, gen[, codebooks])
        n_tokens = b * (n - 1)
        secs = graphed["decode_s"], eager["decode_s"]
        what = "decode tokens"
    pairs = zip(_cache_tensors(caches[0]), _cache_tensors(caches[1]), strict=True)
    for (path, g), (_, e) in pairs:
        check(torch.equal(g, e), f"{label}: graph cache at {path} differs from eager")
    check(counts == eager_counts, f"{label}: launches {counts} vs {eager_counts}")
    rate = [n_tokens / t for t in secs]
    print(
        f"  {label}: CUDA-graph decode equal to the eager decode (tokens, caches, "
        f"launches); {what}/s graph {rate[0]:.1f} (capture "
        f"{graphed['capture_s']:.3f} s) vs eager {rate[1]:.1f}; {card}"
    )
    emit(
        {
            "graph_vs_eager": label,
            "card": card,
            "tokens_per_s": rate[0],
            "eager_tokens_per_s": rate[1],
            "capture_s": graphed["capture_s"],
            "launches": counts,
        }
    )


def phase_serve(card, gen):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import count_params, init_params
    from repro_torch.serving.engine import (
        build_decode_step,
        build_generate_fn,
        build_prefill_step,
        greedy_sample,
    )
    from repro_torch.serving.kv_cache import CacheQuantConfig
    from repro_torch.serving.scheduler import ContinuousScheduler, Request

    need = {
        "a": ("log_quantize", "log_dequantize_rows", "flash_attention"),
        "b": ("log_quantize_pack", "log_dequantize_rows", "flash_attention"),
        "c": ("log_quantize", "log_dequantize_rows", "flash_attention"),
    }
    expect_bpt = {8: 13520.0, 4: 6864.0}
    total = {name: 0 for name in ops.KERNELS}

    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, 1, "cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    print(
        f"serve {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
        f"{count_params(params)} params in {cfg.dtype}, init {t_init:.1f} s"
    )
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT))).cuda()

    for variant, bits in (("a", 8), ("b", 4)):
        qcfg = CacheQuantConfig(bits=bits)
        prefill = build_prefill_step(cfg, PROMPT + GEN, qcfg=qcfg)
        with ops.reference_mode():
            ref_logits, _ = prefill(params, tokens)
        ops.reset_launch_counts()
        out = serve.run_fixed(cfg, params, tokens, gen=GEN, qcfg=qcfg)
        counts = ops.launch_counts()
        label = f"({variant}) fixed batch {BATCH} x prompt {PROMPT} + {GEN}, q{bits}"
        print(f"{label}: launches {counts}")
        for name in need[variant]:
            check(counts[name] > 0, f"{label}: kernel {name} never launched")
        for name, c in counts.items():
            total[name] += c
        # the same run with the decode steps dispatched one by one
        ops.reset_launch_counts()
        eager = serve.run_fixed(cfg, params, tokens, gen=GEN, qcfg=qcfg, graph=False)
        _graph_equals_eager(label, card, out, eager, counts, ops.launch_counts())
        del eager
        _logits_close(out["logits"], ref_logits, label)
        toks = out["tokens"]
        check(tuple(toks.shape) == (BATCH, GEN), f"{label}: tokens {tuple(toks.shape)}")
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), f"{label}: bad ids")
        # decode vs reference mode from the same caches: the kernel path's
        # prefill again (deterministic, so the main run's caches), then every
        # decode step in reference mode must pick the main run's tokens and
        # leave the main run's caches
        logits, caches = prefill(params, tokens)
        check(torch.equal(greedy_sample(logits), toks[:, :1]), f"{label}: first token")
        with ops.reference_mode():
            caches, _, _, sampled = build_generate_fn(cfg)(
                params, caches, toks[:, :1], PROMPT, None, GEN - 1
            )
        same = sampled == toks[:, 1:]
        check(
            bool(same.all()),
            f"{label}: {int((~same).sum())} of {same.numel()} decode tokens "
            "differ from reference mode",
        )
        flips = _caches_match(out["caches"], caches, label)
        print(
            f"  {label}: {same.numel()} decode tokens equal to reference mode, "
            f"caches equal but {flips} one-step code flip(s)"
        )
        bpt, acc = out["bytes_per_token"], out["bytes_per_token_accounted"]
        check(bpt == acc == expect_bpt[bits], f"{label}: bytes/token {bpt} vs {acc}")
        # where the time goes: each step eager (host clock, launch overhead
        # included) against the same step replayed from a CUDA graph (device
        # time only); one more decode step at the last cache position
        caches, last = out["caches"], out["tokens"][:, -1:].contiguous()
        decode = build_decode_step(cfg)
        steps = {
            "prefill": lambda: prefill(params, tokens),
            "decode_step": lambda: decode(params, caches, last, PROMPT + GEN - 1),
        }
        for step, fn in steps.items():
            emit(
                {
                    "split": f"{step}_q{bits}",
                    "card": card,
                    "host_ms": host_ms(fn),
                    "graph_ms": cuda_ms(fn, 1),
                }
            )
            if (variant, step) in (("a", "prefill"), ("b", "decode_step")):
                _kernel_split(
                    f"{step}_q{bits}", card, device_ms_by_kernel(fn), GEMMA_KERNELS
                )
        emit(
            {
                "serve": f"fixed_q{bits}",
                "card": card,
                "prefill_ms": out["prefill_s"] * 1e3,
                "decode_tokens_per_s": BATCH * (GEN - 1) / out["decode_s"],
                "capture_s": out["capture_s"],
                "bytes_per_token": bpt,
                "bytes_per_token_accounted": acc,
            }
        )

    prompts = [
        rng.integers(0, cfg.vocab_size, size=int(n))
        for n in rng.integers(200, 1001, size=N_REQUESTS)
    ]
    def continuous(graph=None):
        return serve.run_continuous(
            cfg,
            params,
            prompts,
            gen=GEN,
            slots=SLOTS,
            qcfg=CacheQuantConfig(bits=8),
            graph=graph,
        )

    ops.reset_launch_counts()
    out = continuous()
    counts = ops.launch_counts()
    label = f"(c) continuous {N_REQUESTS} requests through {SLOTS} slots, q8"
    print(f"{label}: prompt lengths {[len(p) for p in prompts]}, launches {counts}")
    for name in need["c"]:
        check(counts[name] > 0, f"{label}: kernel {name} never launched")
    for name, c in counts.items():
        total[name] += c
    # the same requests through an eager scheduler: requests 5-8 enter the
    # slots that 1-4 left, so the graph captured at the first chunk replays
    # over reused slots
    ops.reset_launch_counts()
    eager = continuous(graph=False)
    _graph_equals_eager(label, card, out, eager, counts, ops.launch_counts())
    del eager
    done = out["tokens"]
    check(sorted(done) == list(range(N_REQUESTS)), f"{label}: requests {sorted(done)}")
    for uid, toks in done.items():
        check(len(toks) == GEN, f"{label}: request {uid} has {len(toks)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in toks), f"{label}: bad ids")
    # the same requests again with every decode chunk in reference mode (a
    # graph of its own); the admission prefills stay on the kernels, so each
    # chunk starts from the main run's caches, and every request must get
    # the main run's tokens
    sched = out["scheduler"]
    ref_sched = ContinuousScheduler(
        cfg,
        params,
        slots=SLOTS,
        max_seq=sched.max_seq,
        qcfg=CacheQuantConfig(bits=8),
        device="cuda",
    )
    kernel_chunk = ref_sched._decode_chunk

    def plain_chunk():
        with ops.reference_mode():
            return kernel_chunk()

    ref_sched._decode_chunk = plain_chunk
    want = ref_sched.run(
        [Request(uid=i, prompt=p, max_new=GEN) for i, p in enumerate(prompts)]
    )
    for uid, toks in done.items():
        n_diff = sum(a != b for a, b in zip(toks, want[uid], strict=True))
        check(n_diff == 0, f"{label}: request {uid}: {n_diff} tokens differ")
    flips = _caches_match(sched.caches, ref_sched.caches, label)
    print(
        f"  {label}: every request's tokens equal to reference-mode decode, "
        f"caches equal but {flips} one-step code flip(s)"
    )
    # the slot grid's caches as the run left them: one more decode step at
    # each slot's next position must give finite logits
    logits, _ = build_decode_step(cfg)(
        params,
        sched.caches,
        torch.as_tensor(sched.cur[:, None], device="cuda"),
        torch.as_tensor(sched.lengths, device="cuda"),
    )
    check(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")
    bpt, acc = out["bytes_per_token"], out["bytes_per_token_accounted"]
    check(bpt == acc == expect_bpt[8], f"{label}: bytes/token {bpt} vs {acc}")
    emit(
        {
            "serve": "continuous_q8",
            "card": card,
            "seconds": out["seconds"],
            "capture_s": out["capture_s"],
            "tokens_per_s": N_REQUESTS * GEN / out["seconds"],
            "decode_chunks": out["scheduler"].steps,
            "bytes_per_token": bpt,
            "bytes_per_token_accounted": acc,
        }
    )
    return total


def _wire_codes(g, bits):
    """A gathered wire array as integer codes (b <= 4 unpacked)."""
    from repro_torch.core.codec import unpack_nibbles

    return unpack_nibbles(g, 2 * g.shape[-1]) if bits <= 4 else g.int()


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def resnet18_train_flops(hw, n_classes, images):
    """FLOPs of forward + backward of ResNet-18 over ``images`` images at
    hw x hw: the forward counted from the conv and head shapes (2 kh kw cin
    cout per output pixel), the backward as twice the forward."""
    size, cin = hw, 64
    fwd = 2 * 9 * 3 * 64 * size * size  # stem
    for cout, blocks, stride in ((64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)):
        for bi in range(blocks):
            s = stride if bi == 0 else 1
            size = -(-size // s)
            fwd += 2 * 9 * (cin + cout) * cout * size * size  # conv1, conv2
            if s != 1 or cin != cout:
                fwd += 2 * cin * cout * size * size  # 1x1 projection
            cin = cout
    fwd += 2 * 512 * n_classes
    return 3 * fwd * images


def phase_train(card):
    # the same init and batches give the same gradients in both modes
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    # TF32 on, as PyTorch leaves cuDNN's convolutions: the runs below must
    # hold the training entry point's own f32 setting, not phase_device's
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    was = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        return _train_runs(card)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = was


def _train_run(cfg, graph=None):
    """``train_one`` on (d)-(f)'s shape, recording each step's synced
    gradients (clones: under a graph they are the replay's, overwritten by
    the next), wire arrays and TF32 flags."""
    from repro_torch.core.comm import SimComm
    from repro_torch.core.tree import tree_leaves
    from repro_torch.train.data_parallel import train_one

    comm = SimComm(TRAIN_WORKERS, record=True)
    log = {"grads": [], "wire": [], "tf32": []}
    flags = torch.backends.cudnn, torch.backends.cuda.matmul

    def on_sync(step, synced, state):
        if step == 0:  # the gathers of one step: the warm-up's, or eager's
            log["per_step"] = len(comm.gathered)
        log["grads"].append([g.clone() for g in tree_leaves(synced)])
        log["wire"].append(comm.gathered[-log["per_step"] :])

    out = train_one(
        cfg,
        n_workers=TRAIN_WORKERS,
        batch=TRAIN_BATCH,
        hw=TRAIN_HW,
        n_classes=TRAIN_CLASSES,
        steps=TRAIN_STEPS,
        lr=TRAIN_LR,
        seed=0,
        device="cuda",
        comm=comm,
        graph=graph,
        on_step=lambda step, res: log["tf32"].extend(f.allow_tf32 for f in flags),
        on_sync=on_sync,
    )
    return out, log


def _graph_equals_eager_train(label, out, log, eager, eager_log, counts, e_counts):
    """(d)-(f): the graphed run against the same run with ``graph=False``,
    bit for bit: every step's loss, bits, synced gradients and wire arrays,
    the final parameters, and the launch counts."""
    from repro_torch.core.tree import tree_leaves

    check(counts == e_counts, f"{label}: launches {counts} graphed, {e_counts} eager")
    check(out.losses == eager.losses, f"{label}: graphed losses differ from eager")
    for st, est in zip(out.steps, eager.steps, strict=True):
        same = (st.rec.bits_sent, st.rec.n_collectives) == (
            est.rec.bits_sent,
            est.rec.n_collectives,
        )
        check(same, f"{label}: graphed bits or collectives differ from eager")
    for t, (gs, es) in enumerate(zip(log["grads"], eager_log["grads"], strict=True)):
        for g, e in zip(gs, es, strict=True):
            check(torch.equal(g, e), f"{label}: step {t} synced grads, graph != eager")
    for t, (ws, es) in enumerate(zip(log["wire"], eager_log["wire"], strict=True)):
        for w, e in zip(ws, es, strict=True):
            check(torch.equal(w, e), f"{label}: step {t} wire, graph != eager")
    pairs = zip(tree_leaves(out.params), tree_leaves(eager.params), strict=True)
    for p, e in pairs:
        check(torch.equal(p, e), f"{label}: final params, graph != eager")


def _train_runs(card):
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.models.resnet import init_resnet18
    from repro_torch.train.data_parallel import mb_per_epoch

    runs = {
        "d": (
            CompressorConfig(name="lq_sgd", rank=1, bits=8),
            ("log_quantize", "log_dequantize"),
        ),
        "e": (
            CompressorConfig(name="lq_sgd", rank=1, bits=4),
            ("log_quantize_pack", "log_dequantize"),
        ),
        "f": (CompressorConfig(name="qsgd", bits=4), ("pack_nibbles",)),
    }
    total = {name: 0 for name in ops.KERNELS}
    init = tree_leaves(init_resnet18(TRAIN_CLASSES, seed=0, device="cuda"))
    flags = torch.backends.cudnn, torch.backends.cuda.matmul

    for variant, (cfg, need) in runs.items():
        tag = f"{cfg.name}_b{cfg.bits}" + ("_r1" if cfg.name == "lq_sgd" else "")
        label = f"({variant}) ResNet-18 {tag}, {TRAIN_WORKERS} workers x {TRAIN_BATCH}"
        with ops.reference_mode():
            want, ref_log = _train_run(cfg)
        ops.reset_launch_counts()
        out, log = _train_run(cfg)  # the main path: a CUDA-graph replay a step
        counts = ops.launch_counts()
        ops.reset_launch_counts()
        eager, eager_log = _train_run(cfg, graph=False)
        e_counts = ops.launch_counts()
        print(f"{label}: launches {counts}")
        for name in need:
            check(counts[name] > 0, f"{label}: kernel {name} never launched")
        for name, c in counts.items():
            total[name] += c
        for lg in (log, eager_log, ref_log):
            tf32 = lg["tf32"]
            check(tf32 and not any(tf32), f"{label}: a step ran with TF32 on")
        check(all(f.allow_tf32 for f in flags), f"{label}: TF32 flags not restored")
        _graph_equals_eager_train(label, out, log, eager, eager_log, counts, e_counts)

        comp = out.comp
        n_raw = sum(pl.route != "lowrank" for pl in comp.plans)
        n_comp = len(comp.plans) - n_raw
        if cfg.name == "lq_sgd":  # a scale pmax + a gather per tensor per phase
            colls = 2 * 2 * n_comp + 2 * n_raw
        else:  # raw pmeans + a scale pmax and a gather per quantized tensor
            colls = n_raw + 2 * n_comp
        bits = comp.wire_bits_per_step()
        if variant == "d":
            check(bits == 370136, f"{label}: {bits} wire bits/step, not 370136")
        for st in out.steps + want.steps:
            check(st.rec.bits_sent == bits, f"{label}: sent {st.rec.bits_sent} bits")
            check(st.rec.n_collectives == colls, f"{label}: {st.rec.n_collectives}")
        losses = out.losses + want.losses
        check(all(math.isfinite(v) for v in losses), f"{label}: losses {losses}")

        with torch.no_grad():
            got_w = [w for ws in log["wire"] for w in ws]
            want_w = [w for ws in ref_log["wire"] for w in ws]
            check(len(got_w) == len(want_w), f"{label}: gathers differ in number")
            flips = n_codes = 0
            for g, w in zip(got_w, want_w):
                if cfg.name == "qsgd":
                    check(torch.equal(g, w), f"{label}: wire bytes differ")
                    continue
                d = (_wire_codes(g, cfg.bits) - _wire_codes(w, cfg.bits)).abs()
                check(int(d.max()) <= 1, f"{label}: a code moved more than one step")
                flips += int((d > 0).sum())
                n_codes += d.numel()
            check(flips <= 1e-3 * max(n_codes, 1), f"{label}: {flips} code flips")
            tol = 0.0 if cfg.name == "qsgd" else train_tol(cfg.bits, flips)
            grad_rel = param_rel = 0.0
            pairs = zip(tree_leaves(out.last_grads), tree_leaves(want.last_grads))
            for g, w in pairs:
                err, top = float((g - w).abs().max()), float(w.abs().max())
                check(err <= tol * top, f"{label}: synced grads differ by {err:.3e}")
                grad_rel = max(grad_rel, err / max(top, 1e-30))
            trios = zip(tree_leaves(out.params), tree_leaves(want.params), init)
            for p, w, p0 in trios:
                err, moved = float((p - w).abs().max()), float((w - p0).abs().max())
                check(err <= tol * moved, f"{label}: params differ by {err:.3e}")
                param_rel = max(param_rel, err / max(moved, 1e-30))

        # eager: the phases of the steps after the first; graphed: the steps
        # after the capture, pure replays
        steady = eager.steps[1:]
        split = {
            "grad": _median([st.grad_ms for st in steady]),
            "sync": _median([st.sync_ms for st in steady]),
            "update": _median([st.update_ms for st in steady]),
        }
        eager_ms = _median([st.step_ms for st in steady])
        graph_ms = _median([st.step_ms for st in out.steps[2:]])
        mb = mb_per_epoch(comp, CIFAR_TRAIN_IMAGES, TRAIN_WORKERS * TRAIN_BATCH)
        flops = resnet18_train_flops(
            TRAIN_HW, TRAIN_CLASSES, TRAIN_WORKERS * TRAIN_BATCH
        )
        grad_tflops = flops / (split["grad"] * 1e-3) / 1e12
        print(
            f"  {label}: {bits} wire bits/step = {mb:.6f} MB/epoch, {colls} "
            f"collectives/step; ms/step graph {graph_ms:.1f} (a replay, CUDA "
            f"events) vs eager {eager_ms:.1f} (grad {split['grad']:.1f}, "
            f"{flops / 1e12:.3f} TFLOP, {grad_tflops:.1f} TFLOP/s; sync "
            f"{split['sync']:.1f}; update {split['update']:.1f}); graph = eager "
            f"bit for bit (losses, bits, synced grads and wire of every step, "
            f"params, launches); losses {[round(v, 4) for v in out.losses]}; vs "
            f"reference mode: {flips} of {n_codes} codes flipped, synced grads rel "
            f"{grad_rel:.2e}, params rel {param_rel:.2e}; {card}"
        )
        emit(
            {
                "train": f"{variant}_{tag}",
                "card": card,
                "mb_per_epoch": mb,
                "wire_bits_per_step": bits,
                "collectives_per_step": colls,
                "graph_step_ms": graph_ms,
                "eager_step_ms": eager_ms,
                "eager_split_ms": split,
                "grad_tflop": flops / 1e12,
                "grad_tflop_per_s": grad_tflops,
                "losses": out.losses,
                "reference_losses": want.losses,
                "launches": counts,
                "code_flips": flips,
                "synced_grad_rel_err": grad_rel,
                "param_rel_err": param_rel,
            }
        )
    return total


def _steps_recorder(comm):
    """on_step / on_sync hooks that keep, per step, the synced grads, the
    gathers the step added to ``comm``, the launches it ran, the effective
    bits and collectives, and the step times; and the state at the end."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import ops

    log = {"grads": [], "gathers": [], "launches": [], "steps": [], "tf32": []}
    seen = {"gathers": 0, "launches": ops.launch_counts()}
    flags = torch.backends.cudnn, torch.backends.cuda.matmul

    def on_step(step, res):
        log["steps"].append(res)
        log["tf32"].extend(f.allow_tf32 for f in flags)

    def on_sync(step, synced, state):
        log["grads"].append([g.clone() for g in tree_leaves(synced)])
        log["gathers"].append(comm.gathered[seen["gathers"] :])
        seen["gathers"] = len(comm.gathered)
        now = ops.launch_counts()
        log["launches"].append({k: now[k] - seen["launches"][k] for k in now})
        seen["launches"] = now
        log["state"] = state

    return log, on_step, on_sync


def _composite_run(cfg, steps, **kw):
    from repro_torch.core.comm import SimComm
    from repro_torch.train.data_parallel import train_one

    comm = SimComm(TRAIN_WORKERS, record=True)
    log, on_step, on_sync = _steps_recorder(comm)
    out = train_one(
        cfg,
        n_workers=TRAIN_WORKERS,
        batch=TRAIN_BATCH,
        hw=TRAIN_HW,
        n_classes=TRAIN_CLASSES,
        steps=steps,
        lr=TRAIN_LR,
        seed=0,
        device="cuda",
        comm=comm,
        on_step=on_step,
        on_sync=on_sync,
        **kw,
    )
    check(log["tf32"] and not any(log["tf32"]), f"{cfg}: a step ran with TF32 on")
    check(all(math.isfinite(v) for v in out.losses), f"losses {out.losses}")
    return out, log


def _wire_flips(got, want, label, exact=()):
    """Gathered wire arrays of two runs: f32 arrays (flags) and those at
    the positions in ``exact`` equal; codes equal but for one-step flips,
    an int8 array read as b8 codes or as two b4 nibbles, whichever holds.
    Returns (flips, codes)."""
    from repro_torch.core.codec import unpack_nibbles

    check(len(got) == len(want), f"{label}: gathers differ in number")
    flips = n_codes = 0
    for j, (g, w) in enumerate(zip(got, want)):
        if g.dtype == torch.float32 or j in exact:
            check(torch.equal(g, w), f"{label}: gather {j} differs")
            continue
        d8 = (g.int() - w.int()).abs()
        nibbles = [unpack_nibbles(a, 2 * a.shape[-1]) for a in (g, w)]
        d4 = (nibbles[0] - nibbles[1]).abs()
        d = d8 if int(d8.max()) <= 1 else d4
        check(int(d.max()) <= 1, f"{label}: a code moved more than one step")
        flips += int((d > 0).sum())
        n_codes += d.numel()
    check(flips <= 1e-3 * max(n_codes, 1), f"{label}: {flips} code flips")
    return flips, n_codes


def _close_to_reference(label, out, want, log, ref_log, bits, flips, init):
    """Synced grads of every step and the final params against the
    reference-mode run: within 1e-5 of each leaf's largest value, or
    ``train_tol`` where a code flipped."""
    from repro_torch.core.tree import tree_leaves

    tol = train_tol(bits, flips)
    grad_rel = param_rel = 0.0
    for step, (gs, ws) in enumerate(zip(log["grads"], ref_log["grads"])):
        for g, w in zip(gs, ws):
            err, top = float((g - w).abs().max()), float(w.abs().max())
            check(err <= tol * top, f"{label}: step {step} grads differ by {err:.3e}")
            grad_rel = max(grad_rel, err / max(top, 1e-30))
    trios = zip(tree_leaves(out.params), tree_leaves(want.params), init)
    for p, w, p0 in trios:
        err, moved = float((p - w).abs().max()), float((w - p0).abs().max())
        check(err <= tol * moved, f"{label}: params differ by {err:.3e}")
        param_rel = max(param_rel, err / max(moved, 1e-30))
    return grad_rel, param_rel


def _split_ms(steps, fired=None):
    """Median grad / sync / update ms over the steps after the first; the
    sync split by fired and skipped rounds when ``fired`` is given."""
    rest = list(enumerate(steps))[1:]
    split = {
        "grad": _median([st.grad_ms for _, st in rest]),
        "sync": _median([st.sync_ms for _, st in rest]),
        "update": _median([st.update_ms for _, st in rest]),
    }
    if fired is not None:
        for name, want in (("sync_fired", True), ("sync_skipped", False)):
            ms = [st.sync_ms for t, st in rest if fired[t] == want]
            split[name] = _median(ms) if ms else None
    return split


def _print_steps(label, steps, fired=None):
    for t, st in enumerate(steps):
        tag = "" if fired is None else (" fired" if fired[t] else " skipped")
        print(
            f"    {label} step {t}{tag}: grad {st.grad_ms:.1f} ms, sync "
            f"{st.sync_ms:.1f} ms, update {st.update_ms:.1f} ms; wire "
            f"{st.wire_bits:g} bits, {st.collectives:g} collectives"
        )


def phase_composite(card):
    """(i) the composite compressor on ResNet-18: per-leaf policies and
    warm-up, symmetric lazy aggregation, the server wire."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    was = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        total = {}
        for part in (_composite_policy, _composite_lazy, _composite_server):
            for name, c in part(card).items():
                total[name] = total.get(name, 0) + c
        return total
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = was


def _collectives_per_step(comp):
    """The static collectives of a round where every group fires."""
    n = sum(
        comp.handlers[m].group_collectives([comp.plans[i] for i in idxs])
        for m, idxs in comp.groups.items()
    )
    return n + len(comp.lazy_groups)


def _composite_policy(card):
    from repro_torch.core.compressors import CompressorConfig, make_compressor
    from repro_torch.core.policy import format_plan_report
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels import ops
    from repro_torch.models.resnet import init_resnet18

    label = f"(i1) ResNet-18 per-leaf policy + warm-up, {TRAIN_WORKERS} x {TRAIN_BATCH}"
    cfg = CompressorConfig(
        name="lq_sgd",
        rank=1,
        bits=8,
        policy=I1_SPEC,
        warmup_steps=2,
        fuse_collectives=True,
    )
    init = tree_leaves(init_resnet18(TRAIN_CLASSES, seed=0, device="cuda"))
    with ops.reference_mode():
        want, ref_log = _composite_run(cfg, I1_STEPS)
    ops.reset_launch_counts()
    out, log = _composite_run(cfg, I1_STEPS)
    counts = ops.launch_counts()
    print(f"{label}: launches {counts}")
    for name in ("log_quantize", "log_quantize_pack", "log_dequantize", "pack_nibbles"):
        check(counts[name] > 0, f"{label}: kernel {name} never launched")
    comp = out.comp
    check(comp.schedule.warmup_steps == 0, f"{label}: no rebuild at the warm-up's end")
    groups = {
        m: sorted({comp.plans[i].policy.bits for i in idxs})
        for m, idxs in comp.groups.items()
    }
    check(groups == {"qsgd": [4], "lq_sgd": [4, 8]}, f"{label}: groups {groups}")
    bits, colls = comp.wire_bits_per_step(), _collectives_per_step(comp)
    for st in log["steps"] + ref_log["steps"]:
        check(st.wire_bits == bits, f"{label}: sent {st.wire_bits} bits, not {bits}")
        check(st.collectives == colls, f"{label}: {st.collectives} collectives")
    per_step = len(log["gathers"][0])
    # the qsgd group syncs first (leaf 0 is fc's bias): its gather is the
    # first of every step, and its bytes come from the same generator seeds
    qsgd_at = {t * per_step for t in range(I1_STEPS)}
    flat = [g for gs in log["gathers"] for g in gs]
    flat_ref = [g for gs in ref_log["gathers"] for g in gs]
    flips, n_codes = _wire_flips(flat, flat_ref, label, exact=qsgd_at)
    grad_rel, param_rel = _close_to_reference(
        label, out, want, log, ref_log, 4, flips, init
    )
    split = _split_ms(log["steps"])
    _print_steps("(i1)", log["steps"])
    print(
        f"  {label}: groups {groups}, {bits} wire bits/step, {colls} collectives"
        f"/step, step ms {split}; vs reference mode: {flips} of {n_codes} codes "
        f"flipped, synced grads rel {grad_rel:.2e}, params rel {param_rel:.2e}; {card}"
    )
    # the planner with the H100's constants, on ResNet-18's shapes (not trained)
    auto_cfg = CompressorConfig(name="lq_sgd", policy="auto", error_budget=0.25)
    params = init_resnet18(TRAIN_CLASSES, seed=0, device="cpu")
    abstract = tree_map(lambda t: torch.empty(t.shape, device="meta"), params)
    auto = make_compressor(auto_cfg, abstract)
    print(format_plan_report(auto.plan_report))
    print(
        f"  (i1) auto plan, H100 cost model, budget 0.25: "
        f"{auto.wire_bits_per_step()} wire bits/step, by method "
        f"{auto.wire_bits_by_method()}"
    )
    emit(
        {
            "train": "i1_policy_warmup",
            "card": card,
            "spec": I1_SPEC,
            "wire_bits_per_step": bits,
            "collectives_per_step": colls,
            "step_ms": split,
            "per_step_ms": [
                [st.grad_ms, st.sync_ms, st.update_ms] for st in log["steps"]
            ],
            "losses": out.losses,
            "reference_losses": want.losses,
            "launches": counts,
            "code_flips": flips,
            "synced_grad_rel_err": grad_rel,
            "param_rel_err": param_rel,
            "auto_wire_bits_per_step": auto.wire_bits_per_step(),
            "auto_by_method": auto.wire_bits_by_method(),
        }
    )
    return counts


def _composite_lazy(card):
    import dataclasses

    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.models.resnet import init_resnet18

    label = f"(i2) ResNet-18 lq_sgd r1 b8 lazy, {TRAIN_WORKERS} x {TRAIN_BATCH}"
    cfg = CompressorConfig(
        name="lq_sgd",
        rank=1,
        bits=8,
        fuse_collectives=True,
        lazy_thresh=I2_THRESH,
        max_stale=I2_MAX_STALE,
    )
    init = tree_leaves(init_resnet18(TRAIN_CLASSES, seed=0, device="cuda"))
    with ops.reference_mode():
        want, ref_log = _composite_run(cfg, I2_STEPS)
    gate_cfg = dataclasses.replace(cfg, lazy_mode="gate")
    gate, gate_log = _composite_run(gate_cfg, I2_STEPS)
    ops.reset_launch_counts()
    out, log = _composite_run(cfg, I2_STEPS)
    counts = ops.launch_counts()
    print(f"{label}: launches {counts}")
    for name in ("log_quantize", "log_dequantize"):
        check(counts[name] > 0, f"{label}: kernel {name} never launched")
    comp = out.comp
    payload = comp.wire_bits_per_step() - comp.decision_bits_per_step()
    side = comp.decision_bits_per_step()
    colls = _collectives_per_step(comp)

    def fire_pattern(steps):
        return [st.collectives > 1 for st in steps]

    fired = fire_pattern(log["steps"])
    check(fired[0], f"{label}: round 0 did not fire")
    check(any(fired[1:]) and not all(fired), f"{label}: fire pattern {fired}")
    # kernel path vs reference mode: the same decisions, and values
    ref_fired = fire_pattern(ref_log["steps"])
    check(fired == ref_fired, f"{label}: fire {fired}, reference mode {ref_fired}")
    flat = [g for gs in log["gathers"] for g in gs]
    flat_ref = [g for gs in ref_log["gathers"] for g in gs]
    flips, n_codes = _wire_flips(flat, flat_ref, label)
    grad_rel, param_rel = _close_to_reference(
        label, out, want, log, ref_log, 8, flips, init
    )
    # elide vs gate: bit for bit
    for t, (gs, ws) in enumerate(zip(log["grads"], gate_log["grads"])):
        same = all(torch.equal(g, w) for g, w in zip(gs, ws))
        check(same, f"{label}: step {t} grads elide != gate")
    for p, w in zip(tree_leaves(out.params), tree_leaves(gate.params)):
        check(torch.equal(p, w), f"{label}: params elide != gate")
    for ns, sub in log["state"].items():
        if ns == "step":
            continue
        for k, v in sub.items():
            same = torch.equal(v, gate_log["state"][ns][k])
            check(same, f"{label}: state {ns}/{k} elide != gate")
    for st, gst in zip(log["steps"], gate_log["steps"]):
        same = (st.wire_bits, st.collectives) == (gst.wire_bits, gst.collectives)
        check(same, f"{label}: effective counts elide != gate")
    # what a skip issues, and the accounting
    for t, st in enumerate(log["steps"]):
        want_bits = side + (payload if fired[t] else 0)
        sent = f"{label}: step {t} sent {st.wire_bits} bits, {st.collectives} coll."
        check(st.wire_bits == want_bits, f"{sent}; accounted {want_bits}")
        check(st.collectives == (colls if fired[t] else 1), sent)
        if not fired[t]:
            check(not log["gathers"][t], f"{label}: skipped step {t} gathered")
            ran = {k: v for k, v in log["launches"][t].items() if v}
            check(not ran, f"{label}: skipped step {t} launched {ran}")
    split = _split_ms(log["steps"], fired)
    gate_split = _split_ms(gate_log["steps"], fired)
    _print_steps("(i2) elide", log["steps"], fired)
    _print_steps("(i2) gate", gate_log["steps"], fired)
    print(
        f"  {label}: fire pattern {''.join('F' if f else 's' for f in fired)}, "
        f"fired {payload + side} bits / skipped {side} bits, step ms elide {split}, "
        f"gate {gate_split}; vs reference mode: {flips} of {n_codes} codes flipped, "
        f"synced grads rel {grad_rel:.2e}, params rel {param_rel:.2e}; {card}"
    )
    emit(
        {
            "train": "i2_lazy",
            "card": card,
            "fired": fired,
            "fired_bits": payload + side,
            "skipped_bits": side,
            "step_ms_elide": split,
            "step_ms_gate": gate_split,
            "per_step_sync_ms_elide": [st.sync_ms for st in log["steps"]],
            "per_step_sync_ms_gate": [st.sync_ms for st in gate_log["steps"]],
            "losses": out.losses,
            "launches": counts,
            "code_flips": flips,
            "synced_grad_rel_err": grad_rel,
            "param_rel_err": param_rel,
        }
    )
    return counts


def _composite_server(card):
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.core.lazy import SERVER_DECISION_BITS_PER_GROUP
    from repro_torch.core.tree import tree_leaves
    from repro_torch.core.wire import PARTICIPATION_FLAG_BITS
    from repro_torch.kernels import ops
    from repro_torch.models.resnet import init_resnet18

    label = f"(i3) ResNet-18 server wire, {TRAIN_WORKERS} x {TRAIN_BATCH}"
    cfg = CompressorConfig(
        name="lq_sgd",
        rank=1,
        bits=8,
        fuse_collectives=True,
        topology="server",
        participation=0.5,
        lazy_thresh=1.5,
        max_stale=4,
    )
    init = tree_leaves(init_resnet18(TRAIN_CLASSES, seed=0, device="cuda"))
    with ops.reference_mode():
        want, ref_log = _composite_run(cfg, I3_STEPS, noniid_alpha=I3_ALPHA)
    ops.reset_launch_counts()
    out, log = _composite_run(cfg, I3_STEPS, noniid_alpha=I3_ALPHA)
    counts = ops.launch_counts()
    print(f"{label}: launches {counts}")
    for name in ("log_quantize", "log_dequantize"):
        check(counts[name] > 0, f"{label}: kernel {name} never launched")
    comp = out.comp
    n_params = sum(math.prod(pl.shape) for pl in comp.plans)
    payload = comp.wire_bits_per_step() - comp.decision_bits_per_step()
    side = PARTICIPATION_FLAG_BITS + SERVER_DECISION_BITS_PER_GROUP
    colls = _collectives_per_step(comp) + 1  # and the participation gather
    masks, contribs = [], []
    for t, (gs, rs) in enumerate(zip(log["gathers"], ref_log["gathers"])):
        # the round's first gather is the participation flags, the second
        # the contribution flags; both f32, one a worker
        part, contrib = gs[0], gs[1]
        check(torch.equal(part, rs[0]), f"{label}: step {t} participation masks differ")
        check(torch.equal(contrib, rs[1]), f"{label}: step {t} contributions differ")
        masks.append([int(v) for v in part.tolist()])
        contribs.append([int(v) for v in contrib.tolist()])
        st = log["steps"][t]
        want_bits = side + float(contrib.mean()) * payload
        sent = f"{label}: step {t} sent {st.wire_bits} bits, {st.collectives} coll."
        check(abs(st.wire_bits - want_bits) <= 1e-6 * want_bits, f"{sent}; {want_bits}")
        check(st.collectives == colls, f"{sent}; accounted {colls}")
        check(st.rec.down_bits == 32 * n_params, f"{label}: {st.rec.down_bits} down")
    check(any(0 < sum(m) < TRAIN_WORKERS for m in masks), f"{label}: masks {masks}")
    flat = [g for gs in log["gathers"] for g in gs]
    flat_ref = [g for gs in ref_log["gathers"] for g in gs]
    flips, n_codes = _wire_flips(flat, flat_ref, label)
    grad_rel, param_rel = _close_to_reference(
        label, out, want, log, ref_log, 8, flips, init
    )
    split = _split_ms(log["steps"])
    _print_steps("(i3)", log["steps"])
    print(
        f"  {label}: participation {masks}, contributions {contribs}, down "
        f"{32 * n_params} bits/step, step ms {split}; vs reference mode: {flips} of "
        f"{n_codes} codes flipped, synced grads rel {grad_rel:.2e}, params rel "
        f"{param_rel:.2e}; {card}"
    )
    emit(
        {
            "train": "i3_server",
            "card": card,
            "participation_masks": masks,
            "contributions": contribs,
            "wire_bits": [st.wire_bits for st in log["steps"]],
            "collectives_per_step": colls,
            "down_bits_per_step": 32 * n_params,
            "step_ms": split,
            "losses": out.losses,
            "launches": counts,
            "code_flips": flips,
            "synced_grad_rel_err": grad_rel,
            "param_rel_err": param_rel,
        }
    )
    return counts


def phase_lm_train(card):
    """(j) LM training: gemma3-1b at full width, the JAX package's main path.
    Deterministic algorithms are on for the phase (warn only), so both
    modes' gradients come out of the same reductions; any op that has no
    deterministic version is named."""
    import warnings

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            total = {}
            for part in (_lm_j1, _lm_j2, _lm_j3):
                for name, c in part(card).items():
                    total[name] = total.get(name, 0) + c
    finally:
        torch.use_deterministic_algorithms(False)
    nondet = sorted(
        {str(w.message).splitlines()[0] for w in caught if "determin" in str(w.message)}
    )
    print(f"  (j) ops without a deterministic version: {nondet or 'none'}")
    return total


def _free_cuda():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _lm_data(cfg, batch, seq):
    """The LM training data of ``cfg`` (codebook grids for musicgen)."""
    from repro_torch.data.synthetic import LMDataConfig

    return LMDataConfig(
        vocab_size=cfg.vocab_size,
        seq_len=seq,
        batch=batch,
        n_codebooks=cfg.n_codebooks,
    )


def _lm_batch(cfg, data, step):
    """``step``'s batch as the training launcher draws it: the tokens and,
    for a conditioned model, its conditioning prefix."""
    from repro_torch.data.synthetic import cond_batch, lm_batch

    b = lm_batch(data, step)
    if cfg.cond_len:
        b["cond"] = cond_batch(data, step, cfg.cond_len, cfg.d_model)
    return b


def _lm_run(
    cfg,
    comp_cfg,
    opt,
    steps,
    *,
    runner="sync",
    microbatch=1,
    graph=None,
    every=False,
    timed=False,
    shape=(LM_MESH, LM_BATCH, LM_SEQ),
    comm=None,
):
    """Train ``cfg`` over ``shape``'s workers (mesh, global batch, sequence;
    by default LM_MESH, LM_BATCH, LM_SEQ) through the LM training path
    (``train/step.py`` under ``Trainer`` or ``AsyncRunner``; a CUDA-graph
    replay a step unless ``graph=False``). Returns {state, loop, step, comp,
    comm, log}: the log holds every step's CommRecord and wire arrays, the
    batch each step read (its device batch, a graph's static buffer, read
    after the step), the first step's per-worker gradients into the sync
    and its synced gradients on the host (``every``: every step's synced
    gradients), the wall seconds of the run and (``timed``) each step's
    host ms between device syncs. ``comm`` (one that records its gathers)
    carries the sync in place of a ``SimComm`` of the mesh's workers."""
    from repro_torch.core.comm import SimComm
    from repro_torch.core.tree import tree_leaves
    from repro_torch.train.runtime import AsyncRunner, RuntimeConfig
    from repro_torch.train.step import (
        build_train_step,
        init_train_state,
        make_model_compressor,
        n_dp_of,
    )
    from repro_torch.train.trainer import Trainer

    mesh, batch, seq = shape
    n = n_dp_of(mesh)
    comp = make_model_compressor(cfg, comp_cfg)
    comm = comm if comm is not None else SimComm(n, record=True)
    log = {"rec": [], "tokens": [], "synced": [], "wire": [], "step_ms": []}

    def on_sync(grads, synced, comp_state, rec):
        log["rec"].append(rec)
        if len(log["rec"]) == 1:  # the gathers of one step
            log["per_step"] = len(comm.gathered)
            log["grads0"] = [g.to("cpu") for g in tree_leaves(grads)]
        if every or len(log["rec"]) == 1:
            log["synced"].append([g.to("cpu") for g in tree_leaves(synced)])
        log["wire"].append(comm.gathered[-log["per_step"] :])

    step = build_train_step(
        cfg,
        mesh,
        comp,
        opt,
        accum_steps=microbatch,
        comm=comm,
        on_sync=on_sync,
        graph=graph,
    )

    def stepped(state, batch):
        if timed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, metrics = step(state, batch)
        if timed:
            torch.cuda.synchronize()
            log["step_ms"].append((time.perf_counter() - t0) * 1e3)
        log["tokens"].append(step.batch["tokens"].clone())
        return state, metrics

    data = _lm_data(cfg, batch, seq)
    rcfg = RuntimeConfig(
        steps=steps, log_every=1, verbose=False, microbatch=microbatch, prefetch=2
    )
    cls = AsyncRunner if runner == "async" else Trainer
    loop = cls(stepped, lambda i: _lm_batch(cfg, data, i), rcfg)
    state = init_train_state(cfg, 0, opt, comp, n, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = loop.run(state)
    torch.cuda.synchronize()
    log["wall_s"] = time.perf_counter() - t0
    return dict(state=state, loop=loop, step=step, comp=comp, comm=comm, log=log)


def _lm_tokens_checked(label, cfg, log, steps, batch=LM_BATCH, seq=LM_SEQ):
    """The tokens every step read against numpy's ``lm_batch``."""
    from repro_torch.data.synthetic import lm_batch

    data = _lm_data(cfg, batch, seq)
    check(len(log["tokens"]) == steps, f"{label}: {len(log['tokens'])} steps' tokens")
    for t, got in enumerate(log["tokens"]):
        want = torch.from_numpy(lm_batch(data, t)["tokens"]).to(got.dtype)
        check(torch.equal(got.cpu(), want), f"{label}: step {t} tokens differ")


def _lm_no_host_sync(card):
    """One eager LM step at smoke widths (Adam, LQ-SGD, the deterministic
    algorithms of the phase) under ``torch.cuda.set_sync_debug_mode("error")``:
    any op that waits for the device (what a capture cannot hold) raises."""
    from repro_torch.configs import get_config
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.data.synthetic import LMDataConfig, lm_batch
    from repro_torch.train.optimizer import adam
    from repro_torch.train.step import (
        build_train_step,
        init_train_state,
        make_model_compressor,
    )

    cfg = get_config(LM_ARCH, smoke=True)
    comp = make_model_compressor(cfg, CompressorConfig(name="lq_sgd", rank=1))
    opt = adam(J1_LR)
    state = init_train_state(cfg, 0, opt, comp, LM_MESH[0], "cuda")
    data = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=64, batch=LM_BATCH)
    batch = {"tokens": torch.from_numpy(lm_batch(data, 0)["tokens"]).cuda()}
    step = build_train_step(cfg, LM_MESH, comp, opt, graph=False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"  (j) an eager step under sync debug mode 'error': no host sync; {card}")


def _host_params(state):
    from repro_torch.core.tree import tree_leaves

    return [w.detach().to("cpu", copy=True) for w in tree_leaves(state["params"])]


def _lm_graph_equals_eager(label, g, e, names=("graph", "eager")):
    """(j1): the graphed run against the eager one (or the runs ``names``
    names), bit for bit."""
    ne = "{} != {}".format(*names)
    counts = f"{g['counts']} / {e['counts']}"
    check(g["counts"] == e["counts"], f"{label}: launches {counts}")
    gl, el = g["log"], e["log"]
    for a, b in zip(gl["grads0"], el["grads0"], strict=True):
        check(torch.equal(a, b), f"{label}: step-0 grads into the sync, {ne}")
    for t, (gs, es) in enumerate(zip(gl["synced"], el["synced"], strict=True)):
        for a, b in zip(gs, es, strict=True):
            check(torch.equal(a, b), f"{label}: step {t} synced grads, {ne}")
    for t, (gs, es) in enumerate(zip(gl["wire"], el["wire"], strict=True)):
        for a, b in zip(gs, es, strict=True):
            check(torch.equal(a.cpu(), b.cpu()), f"{label}: step {t} wire, {ne}")
    for a, b in zip(gl["rec"], el["rec"], strict=True):
        same = (a.effective_bits(), a.effective_collectives()) == (
            b.effective_bits(),
            b.effective_collectives(),
        )
        check(same, f"{label}: bits or collectives, {ne}")
    for a, b in zip(g["params"], e["params"], strict=True):
        check(torch.equal(a, b), f"{label}: final params, {ne}")
    check(g["losses"] == e["losses"], f"{label}: losses, {ne}")


_J1_GRADS0 = []  # (j1)'s per-worker gradients into its step-0 sync, on the host
_J1_GRAPH = {}  # (j1)'s graphed run (on the host) and its timed steps, for (n1)


def _lm_close_to_reference(
    label, got, ref, init, steps, exact=(), workers=LM_MESH[0], lr=J1_LR
):
    """An LM run against the same run in reference mode: wire codes equal
    but for one-step flips (the gathers at the positions in ``exact``
    equal), the step-0 synced gradients and the final parameters within the
    bounds stated at ``BF16_ULP``. Returns (flips, codes, flips at step 0,
    grads rel, params rel)."""
    gathered, ref_gathered = got["gathered"], ref["gathered"]
    flips, n_codes = _wire_flips(gathered, ref_gathered, label, exact)
    per_step = len(gathered) // steps
    flips0, _ = _wire_flips(gathered[:per_step], ref_gathered[:per_step], label)
    tol0 = train_tol(8, flips0, workers=workers) + BF16_ULP
    grad_rel = 0.0
    pairs = zip(got["log"]["synced"][0], ref["log"]["synced"][0], strict=True)
    for g, w in pairs:
        err, top = float((g.float() - w.float()).abs().max()), float(w.abs().max())
        check(err <= tol0 * top, f"{label}: step-0 synced grads differ by {err:.3e}")
        grad_rel = max(grad_rel, err / max(top, 1e-30))
    tol = train_tol(8, flips, workers=workers)
    param_rel = 0.0
    for p, w, p0 in zip(got["params"], ref["params"], init, strict=True):
        p, w, p0 = p.float(), w.float(), p0.float()
        err = float((p - w).abs().max())
        moved, top = float((w - p0).abs().max()), float(w.abs().max())
        if flips == 0:
            bound = tol * moved + BF16_ULP * top
        else:
            bound = 2 * ADAM_STEP_MAX * lr * steps + BF16_ULP * top
        check(err <= bound, f"{label}: params differ by {err:.3e} > {bound:.3e}")
        param_rel = max(param_rel, err / max(moved, 1e-30))
    return flips, n_codes, flips0, grad_rel, param_rel


def _lm_j1(card):
    from repro_torch.configs import get_config
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.train.optimizer import adam
    from repro_torch.train.step import init_train_params

    cfg = get_config(LM_ARCH)
    comp_cfg = CompressorConfig(name="lq_sgd", rank=1, bits=8)
    label = (
        f"(j1) {LM_ARCH} full width, {LM_MESH[0]} workers x "
        f"{LM_BATCH // LM_MESH[0]} x {LM_SEQ}, LQ-SGD r1 b8, Adam, Trainer"
    )
    init = init_train_params(cfg, 0, "cuda")
    n_params = sum(w.numel() for w in tree_leaves(init))
    init = [w.detach().to("cpu") for w in tree_leaves(init)]
    check(n_params == 999_826_048, f"{label}: {n_params} parameters")
    _free_cuda()
    _lm_no_host_sync(card)
    runs = {}
    for name, graph in (("graph", None), ("eager", False)):
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        r = _lm_run(cfg, comp_cfg, adam(J1_LR), J1_STEPS, graph=graph, every=True)
        runs[name] = dict(
            counts=ops.launch_counts(),
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            params=_host_params(r["state"]),
            log=r["log"],
            losses=[h["loss"] for h in r["loop"].history],
            capture_s=r["step"].capture_s,
            gathered=[w.cpu() for ws in r["log"]["wire"] for w in ws],
        )
        _lm_tokens_checked(f"(j1) {name}", cfg, r["log"], J1_STEPS)
        del r
    _lm_graph_equals_eager(label, runs["graph"], runs["eager"])
    got = runs["graph"]
    counts = got["counts"]
    print(
        f"{label}: {n_params} parameters, launches {counts} (graph = eager), "
        f"peak graph {got['peak_gb']:.1f} GB, eager {runs['eager']['peak_gb']:.1f} "
        f"GB (deterministic algorithms on)"
    )
    for name in ("log_quantize", "log_dequantize"):
        check(counts[name] > 0, f"{label}: kernel {name} never launched")
    for name in ("log_quantize_pack", "flash_attention", "ssd_chunk"):
        check(counts[name] == 0, f"{label}: kernel {name} launched")
    _free_cuda()
    with ops.reference_mode():
        r = _lm_run(cfg, comp_cfg, adam(J1_LR), J1_STEPS)
    ref = dict(
        params=_host_params(r["state"]),
        log=r["log"],
        losses=[h["loss"] for h in r["loop"].history],
        gathered=[w.cpu() for ws in r["log"]["wire"] for w in ws],
    )
    comp = r["comp"]
    del r
    _free_cuda()

    colls = comp.handler.group_collectives(comp.plans)
    check(comp.wire_bits_per_step() == J1_BITS, f"{label}: {comp.wire_bits_per_step()}")
    for rec in got["log"]["rec"] + ref["log"]["rec"]:
        check(rec.effective_bits() == J1_BITS, f"{label}: {rec.effective_bits()} bits")
        check(rec.effective_collectives() == colls, f"{label}: collectives")
    for g, w in zip(got["log"]["grads0"], ref["log"]["grads0"], strict=True):
        check(torch.equal(g, w), f"{label}: step-0 gradients into the sync differ")
    # (k1) holds its own step-0 gradients into the sync to these
    _J1_GRADS0[:] = got["log"]["grads0"]
    # (n1) holds its NCCL run to the graphed run bit for bit
    _J1_GRAPH.update(got)
    flips, n_codes, flips0, grad_rel, param_rel = _lm_close_to_reference(
        label, got, ref, init, J1_STEPS
    )
    losses = got["losses"]
    check(all(math.isfinite(v) for v in losses), f"{label}: losses {losses}")
    print(
        f"  {label}: {J1_BITS} wire bits/step ({J1_BITS / 8e6:.3f} MB against "
        f"{n_params * 4 / 1e6:.1f} MB uncompressed), {colls} collectives/step; "
        f"graph = eager bit for bit over {J1_STEPS} steps (step-0 gradients into "
        f"the sync, every step's synced grads, wire, bits, losses, final params, "
        f"launches); vs reference mode: step-0 gradients into the sync equal, "
        f"{flips} of {n_codes} codes flipped ({flips0} at step 0), step-0 synced "
        f"grads rel {grad_rel:.2e}, params rel {param_rel:.2e}; losses "
        f"{[round(v, 4) for v in losses]}; {card}"
    )
    torch.use_deterministic_algorithms(False)
    try:
        timed = _lm_timed(cfg, comp_cfg, card)
    finally:
        torch.use_deterministic_algorithms(True, warn_only=True)
    _J1_GRAPH["timed"] = timed
    emit(
        {
            "train": "j1_gemma3_1b_lq_sgd_r1_b8_adam",
            "card": card,
            "params": n_params,
            "wire_bits_per_step": J1_BITS,
            "collectives_per_step": colls,
            "graph_equals_eager": True,
            "idle_share": timed["idle_share"],
            "peak_memory_gb_deterministic": {
                k: runs[k]["peak_gb"] for k in ("graph", "eager")
            },
            "capture_s": got["capture_s"],
            "timed": timed,
            "losses": losses,
            "reference_losses": ref["losses"],
            "launches": counts,
            "code_flips": flips,
            "step0_synced_grad_rel_err": grad_rel,
            "param_rel_err": param_rel,
        }
    )
    return counts


def _lm_timed(
    cfg,
    comp_cfg,
    card,
    shape=(LM_MESH, LM_BATCH, LM_SEQ),
    lr=J1_LR,
    tag="j1",
    comm=None,
    variants=("graph", "graph_no_remat", "eager", "eager_no_remat"),
):
    """(j1)'s step (or ``tag``'s, at ``shape`` and ``lr``) timed as the
    launcher runs it, deterministic algorithms off: the graphed and the
    eager step, each with and without rematerialization, or the
    ``variants`` named (host ms a step ending in a device sync, and the ms
    between CUDA events around it); peak memory and tokens/s of each, the
    graphs' capture seconds, and the device idle share of the eager step
    (1 - replay device ms / eager host ms, both with remat, the launcher's
    setting). The kernels of a replay by device time (torch.profiler).
    ``comm`` carries the sync in place of a ``SimComm``."""
    from repro_torch.train.optimizer import adam
    from repro_torch.train.step import (
        build_train_step,
        init_train_state,
        make_model_compressor,
    )

    mesh, batch, seq = shape
    comp = make_model_compressor(cfg, comp_cfg)
    data = _lm_data(cfg, batch, seq)
    batches = [_lm_batch(cfg, data, i) for i in range(J1_TIMED_STEPS)]
    tokens = batch * seq
    _free_cuda()
    opt = adam(lr)
    # one state for them all: only the times, tokens/s and memory are read
    state = init_train_state(cfg, 0, opt, comp, mesh[0], "cuda")
    # the step's arguments on the card: the state's storages and a batch's
    arg_bytes = _storage_bytes(state) + sum(v.nbytes for v in batches[0].values())
    out = {"argument_bytes": arg_bytes}
    for name, graph, remat in (
        ("graph", None, True),
        ("graph_no_remat", None, False),
        ("eager", False, True),
        ("eager_no_remat", False, False),
    ):
        if name not in variants:
            continue
        torch.cuda.reset_peak_memory_stats()
        step = build_train_step(
            cfg, mesh, comp, opt, graph=graph, remat=remat, comm=comm
        )
        host, device = [], []
        for batch in batches:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            state, _ = step(state, batch)
            end.record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            device.append(start.elapsed_time(end))
        # the steps after the warm-up and the capture
        host_ms, device_ms = _median(host[2:]), _median(device[2:])
        out[name] = dict(
            host_ms=host_ms,
            device_ms=device_ms,
            tokens_per_s=tokens / (host_ms / 1e3),
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            peak_bytes=torch.cuda.max_memory_allocated(),
            capture_s=step.capture_s,
            per_step_host_ms=host,
        )
        if name == "graph":
            by_name = device_ms_by_kernel(lambda: step(state, batches[-1]))
            loss = {"loss": ("softmax", "nll")}
            _kernel_split(f"lm_train_step_{tag}_replay", card, by_name, loss)
        step.release()
        del step
        _free_cuda()
    del state
    for name, r in out.items():
        if not isinstance(r, dict):
            continue
        print(
            f"  ({tag}) timed, {name}: {r['host_ms']:.1f} ms a step on the host "
            f"clock ({r['device_ms']:.1f} ms between CUDA events), "
            f"{r['tokens_per_s']:.0f} tokens/s, peak {r['peak_gb']:.1f} GB"
            + (f", capture {r['capture_s']:.2f} s" if r["capture_s"] else "")
            + f"; {card}"
        )
    idle = 1 - out["graph"]["device_ms"] / out["eager"]["host_ms"]
    print(
        f"  ({tag}) timed: the eager step's device idle share {idle:.1%} (1 - replay "
        f"{out['graph']['device_ms']:.1f} ms / eager host "
        f"{out['eager']['host_ms']:.1f} ms); deterministic algorithms off; {card}"
    )
    return {**out, "idle_share": idle}


def _storage_bytes(tree):
    """The bytes of the distinct storages of ``tree``'s tensors."""
    from repro_torch.core.tree import tree_leaves

    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


SPLIT_KEYS = ("grad", "sync", "update")


def _lm_j2(card):
    from repro_torch.configs import get_config
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.train.optimizer import sgd

    cfg = get_config(LM_ARCH)
    comp_cfg = CompressorConfig(name="lq_sgd", rank=1, bits=4)
    label = (
        f"(j2) {LM_ARCH} full width, LQ-SGD r1 b4, SGD, microbatch "
        f"{J2_MICROBATCH}, AsyncRunner against Trainer, both over the graphed "
        "step"
    )
    out = {}
    counts = None
    for runner in ("sync", "async"):
        if runner == "async":
            ops.reset_launch_counts()
        r = _lm_run(
            cfg,
            comp_cfg,
            sgd(J2_LR),
            J2_STEPS,
            runner=runner,
            microbatch=J2_MICROBATCH,
        )
        state, loop, log = r["state"], r["loop"], r["log"]
        if runner == "async":
            counts = ops.launch_counts()
        _lm_tokens_checked(f"(j2) {runner}", cfg, log, J2_STEPS)
        for rec in log["rec"]:
            check(rec.effective_bits() == J2_BITS, f"{label}: {rec.effective_bits()}")
        out[runner] = dict(
            state=[
                x.detach().to("cpu") if isinstance(x, torch.Tensor) else x
                for x in tree_leaves(state)
            ],
            history=[
                {k: v for k, v in h.items() if k != "wall_s"} for h in loop.history
            ],
            host_s=loop.host_s,
            wall_s=log["wall_s"],
        )
        del r, state, loop, log
        _free_cuda()
    print(f"{label}: launches {counts}")
    for name in ("log_quantize_pack", "log_dequantize"):
        check(counts[name] > 0, f"{label}: kernel {name} never launched")
    a, b = out["sync"], out["async"]
    check(len(a["state"]) == len(b["state"]), f"{label}: states differ in leaves")
    for x, y in zip(a["state"], b["state"]):
        same = torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        check(same, f"{label}: async state differs from the sync loop's")
    check(a["history"] == b["history"], f"{label}: async metrics differ")
    frac = {k: v["host_s"] / v["wall_s"] for k, v in out.items()}
    tok_s = {k: J2_STEPS * LM_BATCH * LM_SEQ / v["wall_s"] for k, v in out.items()}
    losses = [h["loss"] for h in b["history"]]
    check(all(math.isfinite(v) for v in losses), f"{label}: losses {losses}")
    print(
        f"  {label}: async = sync bit for bit over the graphed step (params, "
        f"compressor state, metrics), {J2_BITS} wire bits/step; host-blocked "
        f"fraction sync {frac['sync']:.3f} async {frac['async']:.3f}; tokens/s "
        f"(whole run) sync {tok_s['sync']:.0f} async {tok_s['async']:.0f}; losses "
        f"{[round(v, 4) for v in losses]}; {card}"
    )
    emit(
        {
            "train": "j2_gemma3_1b_lq_sgd_r1_b4_sgd_async",
            "card": card,
            "wire_bits_per_step": J2_BITS,
            "host_blocked_fraction": frac,
            "tokens_per_s": tok_s,
            "wall_s": {k: v["wall_s"] for k, v in out.items()},
            "losses": losses,
            "launches": counts,
        }
    )
    return counts


def _lm_j3(card):
    """Checkpoints at gemma3-1b's smoke widths on the card: a background
    save at step 2, restored and run on to 4, equals 4 steps at once; a
    write that fails raises on drain()."""
    import tempfile

    from repro_torch.checkpoint.io import peek_step, restore
    from repro_torch.configs import get_config
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.synthetic import LMDataConfig, lm_batch
    from repro_torch.kernels import ops
    from repro_torch.train.optimizer import adam
    from repro_torch.train.runtime import AsyncRunner, RuntimeConfig
    from repro_torch.train.step import (
        build_train_step,
        init_train_state,
        make_model_compressor,
    )

    cfg = get_config(LM_ARCH, smoke=True)
    n = LM_MESH[0]
    comp = make_model_compressor(cfg, CompressorConfig(name="lq_sgd", rank=1, bits=8))
    opt = adam(J1_LR)
    step = build_train_step(cfg, LM_MESH, comp, opt)
    data = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=64, batch=LM_BATCH)

    def run(state, steps, **kw):
        rcfg = RuntimeConfig(steps=steps, verbose=False, **kw)
        return AsyncRunner(step, lambda i: lm_batch(data, i), rcfg).run(state)

    label = f"(j3) {cfg.name} checkpoint on the card"
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(Path(tmp) / "state.ckpt")
        whole = run(init_train_state(cfg, 0, opt, comp, n, "cuda"), J3_STEPS)
        first = init_train_state(cfg, 0, opt, comp, n, "cuda")
        run(first, 2, ckpt_every=1, ckpt_path=ck)
        check(peek_step(ck) == 2, f"{label}: peek_step {peek_step(ck)}")
        restored = restore(ck, init_train_state(cfg, 1, opt, comp, n, "cuda"))
        resumed = run(restored, J3_STEPS)
        for x, y in zip(tree_leaves(whole), tree_leaves(resumed), strict=True):
            same = torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
            check(same, f"{label}: the resumed run differs from the uninterrupted one")
        blocker = Path(tmp) / "file"
        blocker.write_text("x")
        try:
            run(
                init_train_state(cfg, 0, opt, comp, n, "cuda"),
                1,
                ckpt_every=1,
                ckpt_path=str(blocker / "state.ckpt"),
            )
            raised = False
        except RuntimeError as e:
            raised = "async checkpoint write" in str(e)
        check(raised, f"{label}: a failed write did not raise on drain()")
    counts = ops.launch_counts()
    for name in ("log_quantize", "log_dequantize"):
        check(counts[name] > 0, f"{label}: kernel {name} never launched")
    print(
        f"{label}: save at step 2 in the background, restore, run on to "
        f"{J3_STEPS}: equal to {J3_STEPS} steps at once bit for bit; a failed "
        f"write raised on drain(); launches {counts}; {card}"
    )
    return counts


def _greedy(cfg, params, logits, caches, prompt, n):
    """``n`` greedy tokens from a prefill's last-position logits and caches
    (decoded from them in place), and the top-2 logit gap of each step."""
    from repro_torch.serving.engine import build_decode_step, greedy_sample

    decode = build_decode_step(cfg)
    toks, gaps = [], []
    for i in range(n):
        if i:
            logits, caches = decode(params, caches, toks[-1], prompt + i - 1)
        top2 = logits[:, -1].float().topk(2, dim=-1).values
        gaps.append(top2[:, 0] - top2[:, 1])
        toks.append(greedy_sample(logits))
    return torch.cat(toks, dim=1), torch.stack(gaps, dim=1)


def kernel_groups(by_name, kernels):
    """Device ms of :func:`device_ms_by_kernel`'s kernels by group: each of
    ``kernels`` (group name -> a substring of its kernel's name, or a tuple
    of them), the matmuls (cuBLAS) and everything else."""
    groups = dict.fromkeys([*kernels, "matmul", "other"], 0.0)
    keys = {g: (k,) if isinstance(k, str) else k for g, k in kernels.items()}
    for name, (ms, _) in by_name.items():
        low = name.lower()
        mine = [group for group, ks in keys.items() if any(k in low for k in ks)]
        if mine:
            groups[mine[0]] += ms
        elif any(k in low for k in MATMUL_KERNELS):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    return groups


def _kernel_split(label, card, by_name, kernels):
    """Print and emit one step's device time by :func:`kernel_groups` and
    its eight longest kernels."""
    total = sum(ms for ms, _ in by_name.values())
    if not total:
        print(f"  {label}: device time by kernel not measured (no device events)")
        return
    groups = kernel_groups(by_name, kernels)
    n = sum(c for _, c in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    print(
        f"  {label}: {n} kernels, {total:.2f} ms of device time: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in groups.items())
    )
    emit(
        {
            "profile": label,
            "card": card,
            "kernels": n,
            "device_ms": total,
            "groups_ms": groups,
            "top": [[name[:80], ms, c] for name, (ms, c) in top],
        }
    )


def phase_ssm(card):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import count_params, init_params
    from repro_torch.serving.engine import build_decode_step, build_prefill_step
    from repro_torch.serving.kv_cache import (
        CacheQuantConfig,
        tree_is_quantized,
        tree_leaves,
    )

    cfg = get_config(SSM_ARCH)
    total = {name: 0 for name in ops.KERNELS}
    # one prefill: ssd_chunk once per layer, no other kernel (no attention,
    # no KV leaf to quantize); a decode step launches none
    per_prefill = {**total, "ssd_chunk": cfg.n_layers}
    t0 = time.perf_counter()
    params = init_params(cfg, 1, "cuda")
    torch.cuda.synchronize()
    n_params = count_params(params)
    print(
        f"serve {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, d_inner "
        f"{cfg.d_inner}, {cfg.ssm_heads} heads of {cfg.ssm_head_dim}, state "
        f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, {n_params} params in "
        f"{cfg.dtype}, init {time.perf_counter() - t0:.1f} s"
    )
    check(n_params == 368_338_432, f"{cfg.name}: {n_params} params")
    rng = np.random.default_rng(1)
    decode = build_decode_step(cfg)

    def main_run(tokens, qcfg, label):
        ops.reset_launch_counts()
        out = serve.run_fixed(cfg, params, tokens, gen=SSM_GEN, qcfg=qcfg)
        counts = ops.launch_counts()
        check(counts == per_prefill, f"{label}: launches {counts}")
        for name, c in counts.items():
            total[name] += c
        return out

    for run, (batch, prompt) in SSM_RUNS.items():
        label = f"({run}) {cfg.name} batch {batch} x prompt {prompt} + {SSM_GEN}"
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt)))
        tokens = tokens.cuda()
        max_seq = prompt + SSM_GEN
        prefill = build_prefill_step(cfg, max_seq)

        # prefill, kernel path vs reference mode: logits and caches
        logits, caches = prefill(params, tokens)
        with ops.reference_mode():
            ref_logits, ref_caches = prefill(params, tokens)
        _logits_close(logits, ref_logits, label)
        worst = {}
        pairs = zip(tree_leaves(caches), tree_leaves(ref_caches), strict=True)
        for (path, g), (_, w) in pairs:
            g, w = g.float(), w.float()
            check(bool(torch.isfinite(g).all()), f"{label}: non-finite {path}")
            rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            check(rel <= SSM_CACHE_REL_TOL, f"{label}: cache {path} rel {rel:.3e}")
            worst[path[-1]] = max(worst.get(path[-1], 0.0), rel)
        print(f"  {label}: prefill caches vs reference mode, max rel {worst}")
        with ops.reference_mode():
            ref_toks, ref_gaps = _greedy(
                cfg, params, ref_logits, ref_caches, prompt, SSM_GEN
            )
        del caches, ref_caches

        # the main path: prefill + decode through the launcher's run_fixed,
        # then the same with the decode steps dispatched one by one
        out = main_run(tokens, None, label)
        ops.reset_launch_counts()
        eager = serve.run_fixed(cfg, params, tokens, gen=SSM_GEN, graph=False)
        _graph_equals_eager(label, card, out, eager, per_prefill, ops.launch_counts())
        del eager
        toks = out["tokens"]
        check(tuple(toks.shape) == (batch, SSM_GEN), f"{label}: tokens {toks.shape}")
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), f"{label}: ids")
        check(bool(torch.isfinite(out["logits"]).all()), f"{label}: logits")
        same = toks == ref_toks
        note = ""
        if not bool(same.all()):
            row, step = (int(v) for v in (~same).nonzero()[0])
            gap = float(ref_gaps[row, step])
            note = (
                f"; first divergence at row {row} step {step}, where the "
                f"reference's top-2 logit gap is {gap:.4g}"
            )
        print(
            f"  {label}: greedy tokens equal to the reference-mode run in "
            f"{int(same.sum())} of {same.numel()}{note}"
        )
        leaves = list(tree_leaves(out["caches"]))
        n_bytes = sum(t.numel() * t.element_size() for _, t in leaves)
        bpt, acc = out["bytes_per_token"], out["bytes_per_token_accounted"]
        check(bpt == acc == n_bytes / (batch * max_seq), f"{label}: {bpt} vs {acc}")
        if run == "g1":
            check(bpt == SSM_G1_BYTES_PER_TOKEN, f"{label}: bytes/token {bpt}")
            q8 = main_run(tokens, CacheQuantConfig(bits=8), label + ", q8")
            check(not tree_is_quantized(q8["caches"]), f"{label}: q8 quantized")
            check(q8["bytes_per_token"] == bpt, f"{label}: q8 bytes/token")
            check(torch.equal(q8["tokens"], toks), f"{label}: q8 changed tokens")
            print(f"  {label}: --cache-bits 8 leaves the cache raw, tokens equal")
        print(
            f"  {label}: {bpt:.3f} bytes/token measured = accounted; prefill "
            f"{out['prefill_s'] * 1e3:.1f} ms, decode "
            f"{batch * (SSM_GEN - 1) / out['decode_s']:.1f} tokens/s; {card}"
        )

        # where the time goes: each step eager against a CUDA-graph replay
        caches, last = out["caches"], toks[:, -1:].contiguous()
        steps = {
            "prefill": lambda: prefill(params, tokens),
            "decode_step": lambda: decode(params, caches, last, max_seq - 1),
        }
        for step, fn in steps.items():
            h_ms, g_ms = host_ms(fn), cuda_ms(fn, 1)
            emit(
                {
                    "split": f"mamba_{step}_{run}",
                    "card": card,
                    "host_ms": h_ms,
                    "graph_ms": g_ms,
                    "idle_share": 1 - g_ms / h_ms,
                }
            )
            if run == "g1":
                _kernel_split(
                    f"mamba_{step}_{run}",
                    card,
                    device_ms_by_kernel(fn),
                    {"ssd_chunk": "ssd_chunk"},
                )
        emit(
            {
                "serve": f"mamba_{run}",
                "card": card,
                "prefill_ms": out["prefill_s"] * 1e3,
                "decode_tokens_per_s": batch * (SSM_GEN - 1) / out["decode_s"],
                "capture_s": out["capture_s"],
                "bytes_per_token": bpt,
                "bytes_per_token_accounted": acc,
                "tokens_equal_reference": int(same.sum()),
                "tokens": same.numel(),
            }
        )
        del out, caches
    return total


def _tf32_flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


class _SyncRecorder:
    """A compressor whose one-worker syncs are kept in ``log``: each call's
    synced gradient, ``CommRecord``, gathered wire and TF32 flags."""

    def __init__(self, inner, log):
        self.inner, self.log = inner, log

    def init_state(self, seed, n_workers, device):
        return self.inner.init_state(seed, n_workers, device)

    def sync_once(self, grads, state, *, comm=None):
        from repro_torch.core.comm import SimComm

        comm = SimComm(1, record=True)
        out, new_state, rec = self.inner.sync_once(grads, state, comm=comm)
        bits = self.inner.wire_bits_per_step()
        self.log.append(
            dict(out=out, rec=rec, bits=bits, wire=comm.gathered, tf32=_tf32_flags())
        )
        return out, new_state, rec


def _recorded_victim(model, logs, flags):
    """``gia_ssim.setup(model)`` with every compressed method's syncs kept in
    ``logs[method]`` and the TF32 flags of every gradient call in ``flags``."""
    from repro_torch.bench import gia_ssim
    from repro_torch.core.compressors import make_compressor

    victim = gia_ssim.setup(model, "cuda")
    inner_grad = victim["grad_fn"]

    def grad_fn(p, x, y):
        flags.append(_tf32_flags())
        return inner_grad(p, x, y)

    def recorded(cfg, log):
        return lambda abstract: _SyncRecorder(make_compressor(cfg, abstract), log)

    methods = {}
    for name, cfg in victim["methods"].items():
        if cfg is not None:
            logs[name] = []
            cfg = recorded(cfg, logs[name])
        methods[name] = cfg
    return {**victim, "grad_fn": grad_fn, "methods": methods}


# ---------------------------------------------------------------- phase 10
class _CudaSpans:
    """CUDA events around every call of ``cls.name`` while in the block:
    ``spans`` gets ``(tag(), start, end)`` a call, ``tag`` read when the
    call returns (a step index)."""

    def __init__(self, cls, name, spans, tag):
        self.cls, self.name, self.spans, self.tag = cls, name, spans, tag

    def __enter__(self):
        fn = getattr(self.cls, self.name)
        self.own = self.name in vars(self.cls)

        def timed(*args, **kw):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.spans.append((self.tag(), start, end))
            return out

        self.fn = fn
        setattr(self.cls, self.name, timed)

    def __exit__(self, *exc):
        if self.own:
            setattr(self.cls, self.name, self.fn)
        else:
            delattr(self.cls, self.name)


def _span_ms(spans, steps):
    """The ms of ``spans`` summed by tag (a step index), for ``steps`` steps."""
    torch.cuda.synchronize()
    out = [0.0] * steps
    for tag, start, end in spans:
        out[tag] += start.elapsed_time(end)
    return out


def phase_privacy(card):
    """(k) the randomized privacy codecs (dlog, lrq): (k1) LM training with
    a DP budget, (k2) Algorithm 1 on ResNet-18 and the codecs' statistics at
    real shapes, (k3) the Pareto sweep of the JAX benchmark."""
    total = {}
    for part in (_privacy_k1, _privacy_k2, _privacy_k3):
        for name, c in part(card).items():
            total[name] = total.get(name, 0) + c
    return total


def _privacy_k1(card):
    from repro_torch.configs import get_config
    from repro_torch.core.codec import DitheredLogQuantCodec
    from repro_torch.core.composite import CompositeCompressor
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.train.optimizer import adam
    from repro_torch.train.step import init_train_params

    cfg = get_config(LM_ARCH)
    comp_cfg = CompressorConfig(name="lq_sgd", rank=1, bits=8, dp_epsilon=K1_EPSILON)
    label = (
        f"(k1) {LM_ARCH} full width, {LM_MESH[0]} workers x "
        f"{LM_BATCH // LM_MESH[0]} x {LM_SEQ}, LQ-SGD r1 b8 dlog "
        f"dp_epsilon {K1_EPSILON:g}, Adam, Trainer, eager (the composite)"
    )
    _free_cuda()
    init = tree_leaves(init_train_params(cfg, 0, "cuda"))
    init = [w.detach().to("cpu") for w in init]
    _free_cuda()
    # (j1)'s setting, so the step-0 gradients into the sync are (j1)'s
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        syncs, codes = [], []
        with (
            _CudaSpans(CompositeCompressor, "sync", syncs, lambda: len(syncs)),
            _CudaSpans(DitheredLogQuantCodec, "codes", codes, lambda: len(syncs)),
        ):
            r = _lm_run(cfg, comp_cfg, adam(J1_LR), K1_STEPS, timed=True)
        counts = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        sync_ms, codes_ms = _span_ms(syncs, K1_STEPS), _span_ms(codes, K1_STEPS)
        got = dict(
            params=_host_params(r["state"]),
            log=r["log"],
            losses=[h["loss"] for h in r["loop"].history],
            gathered=[w.cpu() for ws in r["log"]["wire"] for w in ws],
        )
        comp, step_ms = r["comp"], r["log"]["step_ms"]
        del r
        _free_cuda()
        with ops.reference_mode():
            r = _lm_run(cfg, comp_cfg, adam(J1_LR), K1_STEPS)
        ref = dict(
            params=_host_params(r["state"]),
            log=r["log"],
            losses=[h["loss"] for h in r["loop"].history],
            gathered=[w.cpu() for ws in r["log"]["wire"] for w in ws],
        )
        del r
        _free_cuda()
    finally:
        torch.use_deterministic_algorithms(False)

    check(isinstance(comp, CompositeCompressor), f"{label}: {type(comp).__name__}")
    check("dlog" in (comp.graph_refusal() or ""), f"{label}: {comp.graph_refusal()}")
    eps = comp.privacy_epsilon_per_step(1e-5)
    check(abs(eps - K1_EPS_PER_STEP) <= 1e-9, f"{label}: epsilon/step {eps}")
    colls = _collectives_per_step(comp)
    check(comp.wire_bits_per_step() == J1_BITS, f"{label}: {comp.wire_bits_per_step()}")
    for rec in got["log"]["rec"] + ref["log"]["rec"]:
        check(rec.effective_bits() == J1_BITS, f"{label}: {rec.effective_bits()} bits")
        check(rec.effective_collectives() == colls, f"{label}: collectives")
    check(len(_J1_GRADS0) == len(got["log"]["grads0"]), f"{label}: no (j1) grads")
    for g, j, w in zip(got["log"]["grads0"], _J1_GRADS0, ref["log"]["grads0"]):
        check(torch.equal(g, j), f"{label}: step-0 gradients into the sync != (j1)'s")
        check(torch.equal(g, w), f"{label}: step-0 gradients into the sync differ")
    _J1_GRADS0.clear()
    # step 0's raw leaves and P phase come first and ship the same bytes: the
    # same inputs and draws, and no kernel before them
    n_raw = sum(pl.route != "lowrank" for pl in comp.plans)
    n_low = len(comp.plans) - n_raw
    flips, n_codes, flips0, grad_rel, param_rel = _lm_close_to_reference(
        label, got, ref, init, K1_STEPS, exact=set(range(n_raw + n_low))
    )
    losses = got["losses"]
    check(all(math.isfinite(v) for v in losses), f"{label}: losses {losses}")
    check(counts["log_dequantize"] > 0, f"{label}: log_dequantize never launched")
    for name in ("log_quantize", "log_quantize_pack", "pack_nibbles"):
        check(counts[name] == 0, f"{label}: {name} launched (every leaf is dlog)")
    ms = _median(step_ms[1:])
    sync, enc = _median(sync_ms[1:]), _median(codes_ms[1:])
    print(
        f"{label}: launches {counts}; {J1_BITS} wire bits/step ((j1)'s), {colls} "
        f"collectives/step, epsilon/step {eps:g} (calibrated); vs reference mode: "
        f"step-0 gradients into the sync equal (and equal (j1)'s), step 0's raw "
        f"and P gathers equal, {flips} of {n_codes} codes flipped ({flips0} at "
        f"step 0), step-0 synced grads rel {grad_rel:.2e}, params rel "
        f"{param_rel:.2e}; losses {[round(v, 4) for v in losses]}"
    )
    print(
        f"  (k1) {ms:.1f} ms a step (host clock, median of steps 1-{K1_STEPS - 1}; "
        f"{[round(v, 1) for v in step_ms]}), the sync {sync:.1f} ms (CUDA events), "
        f"of it the randomized codes (draws + transform, plain torch) {enc:.1f} "
        f"ms and the rest {sync - enc:.1f} ms; peak {peak_gb:.1f} GB "
        f"(deterministic algorithms on); {card}"
    )
    emit(
        {
            "train": "k1_gemma3_1b_lq_sgd_r1_b8_dlog_eps48_adam",
            "card": card,
            "wire_bits_per_step": J1_BITS,
            "collectives_per_step": colls,
            "epsilon_per_step": eps,
            "step_ms": step_ms,
            "sync_ms": sync_ms,
            "randomized_codes_ms": codes_ms,
            "peak_memory_gb": peak_gb,
            "losses": losses,
            "reference_losses": ref["losses"],
            "launches": counts,
            "code_flips": flips,
            "step0_synced_grad_rel_err": grad_rel,
            "param_rel_err": param_rel,
        }
    )
    return counts


def _resnet_shapes():
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models.resnet import init_resnet18

    params = init_resnet18(TRAIN_CLASSES, device="cuda")
    return [tuple(w.shape) for w in tree_leaves(params)]


def _zero_noise_phases(label):
    """At each of ResNet-18's leaf shapes (5 workers), ``codec_phase`` with
    the zero-noise dlog (b8) and lrq (b4) gathers log's bytes and returns
    log's values, bit for bit."""
    from repro_torch.core.codec import codec_phase, make_codec
    from repro_torch.core.comm import CommRecord, SimComm

    gen = torch.Generator(device="cuda").manual_seed(1)
    xs = [
        torch.randn((TRAIN_WORKERS,) + s, generator=gen, device="cuda")
        for s in _resnet_shapes()
    ]
    pairs = (
        ("dlog:bits=8,dither=False", "log:bits=8"),
        ("lrq:bits=4,n_layers=1,dither=False", "log:bits=4"),
    )
    for zero, log in pairs:
        runs = []
        for spec in (zero, log):
            comm = SimComm(TRAIN_WORKERS, record=True)
            codec = make_codec(spec)
            outs = codec_phase(xs, [False] * len(xs), codec, comm, CommRecord())
            runs.append((outs, comm.gathered))
        (o1, g1), (o2, g2) = runs
        check(len(g1) == len(g2) == len(xs), f"{label}: {zero}: gathers")
        for a, b in zip(g1 + o1, g2 + o2):
            check(torch.equal(a, b), f"{label}: {zero} differs from {log}")
    return len(xs)


def _factor_shapes():
    """(j)'s largest LQ-SGD r1 factor and ResNet-18's largest leaf, as 1-D
    element counts."""
    from repro_torch.configs import get_config
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.train.step import make_model_compressor

    comp = make_model_compressor(
        get_config(LM_ARCH), CompressorConfig(name="lq_sgd", rank=1)
    )
    factor = max(
        (pl.shape[0] if pl.stacked else 1) * max(pl.mat_shape) * pl.eff_rank
        for pl in comp.plans
        if pl.route == "lowrank"
    )
    leaf = max(math.prod(s) for s in _resnet_shapes())
    return {"j_factor": factor, "resnet_leaf": leaf}


def _draw_stats(codec, x, draws=K2_DRAWS):
    """Sum and sum of squares (f64) of expand(codes(x)) over ``draws``
    encodes, with the generators a sync gives one leaf's P phase at steps
    0 .. draws - 1. (Generators seeded 0, 1, 2, ... directly draw
    correlated uniforms: |z| up to 14 in these bins at 262,144 values, on
    the CPU and the card; ``leaf_seed`` hashes its seeds.)"""
    from repro_torch.core.compressors import PHASE_STREAMS, leaf_generator

    s = torch.zeros_like(x, dtype=torch.float64)
    s2 = torch.zeros_like(s)
    for step in range(draws):
        key = leaf_generator(K2_SEED, step, 0, "cuda", stream=PHASE_STREAMS["p"])
        v = codec.expand(codec.codes(x, key=key).float()).double()
        s += v
        s2 += v * v
    return s, s2


def _codec_statistics(label):
    """The JAX package's statistical claims at real shapes on the card:
    unbiasedness (dlog's dither, lrq's layers), dlog's noise std and lrq's
    variance rising with its layers. Unbiasedness: the elements sorted by x
    into K2_BINS bins, each bin's summed deviation of the mean expand from
    x, over its standard error from the draws' own variance, within
    K2_Z_BOUND (a normal tail of 6e-7 a bin)."""
    from repro_torch.core.codec import make_codec
    from repro_torch.core.privacy.accounting import gaussian_sigma

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(2)
    for where, n in _factor_shapes().items():
        x = torch.randn(n, generator=gen, device="cuda")
        x = x / x.abs().max()
        order = torch.argsort(x)
        for spec in ("dlog:bits=8", "dlog:bits=4", "lrq:bits=4,n_layers=2"):
            s, s2 = _draw_stats(make_codec(spec), x)
            mean = s / K2_DRAWS
            var = (s2 - s * mean) / (K2_DRAWS - 1)  # each element's draws
            dev, se2 = (mean - x.double())[order], (var / K2_DRAWS)[order]
            z = [
                float(d.sum() / max(float(e.sum()), 1e-300) ** 0.5)
                for d, e in zip(dev.chunk(K2_BINS), se2.chunk(K2_BINS))
            ]
            zmax = max(abs(v) for v in z)
            check(zmax <= K2_Z_BOUND, f"{label}: {spec} at {where}: bin z {z}")
            out[f"{where}/{spec}/max_bin_z"] = zmax
        # dlog's noise: std sigma where the noised value cannot saturate
        sigma = gaussian_sigma(K2_STD_EPSILON, 1e-5)
        s, s2 = _draw_stats(make_codec(f"dlog:bits=8,dp_epsilon={K2_STD_EPSILON}"), x)
        inner = x.abs() <= 0.5
        xd = x.double()[inner]
        mse = float(((s2[inner] - 2 * xd * s[inner]) / K2_DRAWS + xd * xd).mean())
        ratio = mse**0.5 / sigma
        check(abs(ratio - 1) <= K2_STD_TOL, f"{label}: dlog std / sigma {ratio}")
        out[f"{where}/dlog_eps{K2_STD_EPSILON:g}/std_over_sigma"] = ratio
        # lrq: more layers, a wider output distribution
        spread = []
        for layers in (1, 2, 3):
            s, s2 = _draw_stats(make_codec(f"lrq:bits=4,n_layers={layers}"), x)
            xd = x.double()
            spread.append(float(((s2 - 2 * xd * s) / K2_DRAWS + xd * xd).mean()))
        check(spread[0] < spread[1] < spread[2], f"{label}: lrq spread {spread}")
        out[f"{where}/lrq_b4_mse_by_layers"] = spread
    return out


def _privacy_k2(card):
    from repro_torch.core.comm import SimComm
    from repro_torch.core.codec import unpack_nibbles
    from repro_torch.core.compressors import CompressorConfig, make_compressor
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.models.resnet import init_resnet18

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    was = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = True  # each step must find it off
    total = {name: 0 for name in ops.KERNELS}
    try:
        label = f"(k2) ResNet-18, {TRAIN_WORKERS} workers x {TRAIN_BATCH}"
        ops.reset_launch_counts()
        n_shapes = _zero_noise_phases(label)
        counts = ops.launch_counts()
        for name in ("log_quantize", "log_quantize_pack", "log_dequantize"):
            check(counts[name] > 0, f"{label}: zero noise: {name} never launched")
        for name, c in counts.items():
            total[name] += c
        print(
            f"{label}: the zero-noise dlog b8 and lrq b4 codec_phase = log's bit "
            f"for bit (gathers, values) at {n_shapes} leaf shapes; launches {counts}"
        )
        init = tree_leaves(init_resnet18(TRAIN_CLASSES, seed=0, device="cuda"))
        abstract = [torch.empty(w.shape, device="meta") for w in init]
        want_bits = make_compressor(
            CompressorConfig(name="lq_sgd", rank=1, bits=4), abstract
        ).wire_bits_per_step()
        for tag, knobs in K2_RUNS.items():
            cfg, run = CompressorConfig(**knobs), f"{label} {tag}"
            with ops.reference_mode():
                want, ref_log = _train_run(cfg)
            ops.reset_launch_counts()
            out, log = _train_run(cfg)  # the composite: eager
            counts = ops.launch_counts()
            for name, c in counts.items():
                total[name] += c
            for lg in (log, ref_log):
                check(lg["tf32"] and not any(lg["tf32"]), f"{run}: TF32 on in a step")
            for name in ("pack_nibbles", "log_dequantize"):
                check(counts[name] > 0, f"{run}: kernel {name} never launched")
            for name in ("log_quantize", "log_quantize_pack"):
                check(counts[name] == 0, f"{run}: kernel {name} launched")
            comp = out.comp
            n_raw = sum(pl.route != "lowrank" for pl in comp.plans)
            n_comp = len(comp.plans) - n_raw
            colls = 2 * 2 * n_comp + 2 * n_raw
            bits = comp.wire_bits_per_step()
            check(bits == want_bits, f"{run}: {bits} bits/step, (e)'s {want_bits}")
            for st in out.steps + want.steps:
                check(st.rec.bits_sent == bits, f"{run}: sent {st.rec.bits_sent}")
                check(st.rec.n_collectives == colls, f"{run}: {st.rec.n_collectives}")
            got_w = [w for ws in log["wire"] for w in ws]
            want_w = [w for ws in ref_log["wire"] for w in ws]
            for w in got_w:  # b4 codes lie in [-7, 7]: no nibble reads -8
                codes = unpack_nibbles(w, 2 * w.shape[-1])
                check(int(codes.min()) >= -7, f"{run}: a nibble outside the codes")
            flips, n_codes = _wire_flips(
                got_w, want_w, run, exact=set(range(n_raw + n_comp))
            )
            grad_rel, param_rel = _close_to_reference(
                run, out, want, log, ref_log, 4, flips, init
            )
            # the same seed draws the same bytes, another seed others
            gen = torch.Generator(device="cuda").manual_seed(3)
            grads = [
                torch.randn(
                    (TRAIN_WORKERS,) + tuple(w.shape), generator=gen, device="cuda"
                )
                for w in init
            ]

            def wire(seed):
                comm = SimComm(TRAIN_WORKERS, record=True)
                comp.sync(grads, comp.init_state(seed, TRAIN_WORKERS, "cuda"), comm)
                return comm.gathered

            ops.reset_launch_counts()
            a, b, c = wire(0), wire(0), wire(1)
            for name, n in ops.launch_counts().items():
                total[name] += n
            check(all(torch.equal(x, y) for x, y in zip(a, b)), f"{run}: seed 0 twice")
            differ = sum(not torch.equal(x, y) for x, y in zip(a, c))
            check(differ > 0, f"{run}: seeds 0 and 1 ship the same bytes")
            split = _split_ms(out.steps)
            print(
                f"  {run}: launches {counts}; {bits} wire bits/step ((e)'s), "
                f"{colls} collectives/step, every nibble a b4 code; eager ms/step "
                f"grad {split['grad']:.1f}, sync {split['sync']:.1f}, update "
                f"{split['update']:.1f}; losses {[round(v, 4) for v in out.losses]}; "
                f"vs reference mode: step 0's raw and P gathers equal, {flips} of "
                f"{n_codes} codes flipped, synced grads rel {grad_rel:.2e}, params "
                f"rel {param_rel:.2e}; seed 0 twice the same bytes, seed 1 other "
                f"bytes in {differ} of {len(a)} gathers; {card}"
            )
            emit(
                {
                    "train": f"k2_resnet18_{tag}",
                    "card": card,
                    "wire_bits_per_step": bits,
                    "collectives_per_step": colls,
                    "epsilon_per_step": comp.privacy_epsilon_per_step(1e-5),
                    "eager_split_ms": split,
                    "losses": out.losses,
                    "launches": counts,
                    "code_flips": flips,
                    "synced_grad_rel_err": grad_rel,
                    "param_rel_err": param_rel,
                }
            )
        t0 = time.perf_counter()
        stats = _codec_statistics(label)
        shown = ", ".join(f"{k} {v}" for k, v in stats.items())
        print(
            f"  {label}: the codecs' statistics at real shapes, {K2_DRAWS} draws "
            f"each ({time.perf_counter() - t0:.1f} s): {shown}; {card}"
        )
        emit({"codec_statistics": stats, "draws": K2_DRAWS, "card": card})
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = was
    return total


def _privacy_k3(card):
    from repro_torch.bench import gia_ssim
    from repro_torch.kernels import ops

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    label = "(k3) the Pareto sweep (bench/gia_ssim.py --pareto, the 2-conv victim)"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pareto = gia_ssim._pareto_bench(device="cuda")
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    for name in ("log_quantize_pack", "pack_nibbles", "log_dequantize"):
        check(counts[name] > 0, f"{label}: kernel {name} never launched")
    rows = pareto["rows"]
    check([r["method"] for r in rows] == list(K3_EPS), f"{label}: rows {rows}")
    for r in rows:
        want_bits = K3_BITS[1] if r["matched_to"] else K3_BITS[0]
        check(r["wire_bits"] == want_bits, f"{label}: {r['method']} {r['wire_bits']}")
        want_eps, eps = K3_EPS[r["method"]], r["epsilon"]
        ok = eps is None if want_eps is None else abs(eps - want_eps) <= 1e-9
        check(ok, f"{label}: {r['method']} epsilon {eps}, not {want_eps}")
        check(math.isfinite(r["final_loss"]), f"{label}: {r['method']} loss")
    gate = pareto["gate"]
    print(f"{label}: launches {counts}, {secs:.1f} s; {card}")
    for r in rows:
        eps = "inf" if r["epsilon"] is None else f"{r['epsilon']:.4f}"
        print(
            f"    {r['method']:<15} {r['codec']:<12} eps/step {eps:>9} wire "
            f"{r['wire_bits']:>6} bits  ssim best {r['ssim']:.4f} mean "
            f"{r['ssim_mean']:.4f}  final loss {r['final_loss']:.4f}  attack "
            f"{r['attack_seconds']:.3f} s"
        )
    for c in gate["checks"]:
        print(
            f"    gate {c['randomized']} vs {c['posthoc']}: wire {c['wire_ok']}, "
            f"ssim {c['ssim_ok']}, loss {c['loss_ok']}"
        )
    print(
        f"  (k3) _pareto_gate passed={gate['passed']} at the JAX tolerances (ssim "
        f"{gate['ssim_tol']}, loss {gate['loss_tol']})"
    )
    emit({"pareto": pareto, "seconds": secs, "launches": counts, "card": card})
    check(gate["passed"], f"{label}: the Pareto gate failed: {gate}")
    return counts


def phase_gia(card):
    # the same init, generators and cuDNN algorithms give the same attack
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    # TF32 on, as PyTorch leaves cuDNN's convolutions: the harness must hold
    # its own f32 setting
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    was = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        return _gia_runs(card)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = was


def _check_victim_steps(label, comp_cfgs, logs, ref_logs):
    """Every compressed method's victim syncs against reference mode's."""
    from repro_torch.core.tree import tree_leaves

    for name, log in logs.items():
        want_log, cfg = ref_logs[name], comp_cfgs[name]
        check(len(log) == len(want_log) > 0, f"{label} {name}: {len(log)} syncs")
        bits = log[0]["bits"]
        flips = n_codes = 0
        grad_rel = 0.0
        for step, (got, want) in enumerate(zip(log, want_log)):
            at = f"{label} {name} step {step}"
            for rec in (got["rec"], want["rec"]):
                check(rec.bits_sent == bits, f"{at}: sent {rec.bits_sent} of {bits}")
            check(not any(got["tf32"]), f"{at}: a sync ran with TF32 on")
            check(len(got["wire"]) == len(want["wire"]), f"{at}: gathers differ")
            step_flips = 0
            for g, w in zip(got["wire"], want["wire"]):
                if g.dtype == torch.float32 or cfg.name != "lq_sgd":
                    check(torch.equal(g, w), f"{at}: wire differs")
                    continue
                d = (_wire_codes(g, cfg.bits) - _wire_codes(w, cfg.bits)).abs()
                check(int(d.max()) <= 1, f"{at}: a code moved more than one step")
                step_flips += int((d > 0).sum())
                n_codes += d.numel()
            flips += step_flips
            tol = train_tol(cfg.bits, step_flips, workers=1)
            pairs = zip(tree_leaves(got["out"]), tree_leaves(want["out"]), strict=True)
            for g, w in pairs:
                err, top = float((g - w).abs().max()), float(w.abs().max())
                check(err <= tol * top, f"{at}: synced grads differ by {err:.3e}")
                grad_rel = max(grad_rel, err / max(top, 1e-30))
        check(flips <= 1e-3 * max(n_codes, 1), f"{label} {name}: {flips} code flips")
        print(
            f"  {label} {name}: {len(log)} victim steps equal to reference mode: "
            f"{bits} wire bits each, {flips} of {n_codes} codes flipped, synced "
            f"grads rel {grad_rel:.2e}"
        )


def _attack_step_split(label, card, victim, cfg, model):
    """One batched attack step (every restart) of ``victim``: its host time,
    a CUDA-graph replay's time, and (ResNet-18) torch.profiler's split of
    its device time."""
    from repro_torch.core.privacy.gia import make_attack_step
    from repro_torch.train.data_parallel import _tf32_off

    params, x, y = victim["params"], victim["x"], victim["y"]
    g_obs = victim["grad_fn"](params, x, y)
    step = make_attack_step(victim["grad_fn"], params, g_obs, y, cfg.gia)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (cfg.n_attack_seeds,) + tuple(x.shape)
    xs = torch.randn(shape, generator=gen, device="cuda")
    m, v = torch.zeros_like(xs), torch.zeros_like(xs)
    t = torch.zeros((), device="cuda")
    with _tf32_off():
        h_ms = host_ms(lambda: step(xs, m, v, t), repeats=5)
        g_ms = cuda_ms(lambda: step(xs, m, v, t), 1)
        by_name = device_ms_by_kernel(lambda: step(xs, m, v, t))
    n_kernels = sum(c for _, c in by_name.values())
    print(
        f"  ({label}) {model} attack step, {cfg.n_attack_seeds} restarts batched: "
        f"{h_ms:.3f} ms on the host clock, graph replay {g_ms:.3f} ms, idle "
        f"{1 - g_ms / h_ms:.1%}, {n_kernels} kernels; {card}"
    )
    emit(
        {
            "split": f"gia_attack_step_{label}",
            "card": card,
            "host_ms": h_ms,
            "graph_ms": g_ms,
            "idle_share": 1 - g_ms / h_ms,
        }
    )
    if model == "resnet18":
        _kernel_split(f"gia_attack_step_{label}", card, by_name, {"conv": CONV_KERNELS})


def _attack_graph_vs_eager(label, card, model, cfg, row):
    """The (sgd, cold_start) cell's attack again, as the harness runs it
    (the victim's initial weights, its raw gradient, the cell's restart
    generators), graphed and with ``graph=False``: x̂ and the losses must be
    equal, and the graphed best SSIM the main run's. Prints the seconds of
    each whole attack on the host clock."""
    from repro_torch.bench import gia_ssim
    from repro_torch.core.privacy import invert_gradients_batched, ssim
    from repro_torch.core.privacy.harness import _restart_keys
    from repro_torch.train.data_parallel import _tf32_off

    victim = gia_ssim.setup(model, "cuda")
    params, x, y, grad_fn = (victim[k] for k in ("params", "x", "y", "grad_fn"))
    with _tf32_off():  # as the harness observes it
        g_obs = grad_fn(params, x, y)
    out, secs = {}, {}
    for graph in (None, False):
        keys = _restart_keys(cfg.seed, 0, cfg.n_attack_seeds, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[graph] = invert_gradients_batched(
            grad_fn, params, g_obs, tuple(x.shape), y, keys, cfg.gia, graph=graph
        )
        torch.cuda.synchronize()
        secs[graph] = time.perf_counter() - t0
    (gx, gl), (ex, el) = out[None], out[False]
    at = f"({label}) {model} sgd cold-start attack"
    check(torch.equal(gx, ex), f"{at}: graphed x-hat differs from the eager loop's")
    check(torch.equal(gl, el), f"{at}: graphed losses differ from the eager loop's")
    best = max(float(ssim(x, gx[s])) for s in range(cfg.n_attack_seeds))
    check(best == row["ssim"], f"{at}: best ssim {best} vs the main run's {row}")
    print(
        f"  {at}, {cfg.gia.steps} steps x {cfg.n_attack_seeds} restarts: CUDA graph "
        f"{secs[None]:.2f} s vs eager {secs[False]:.2f} s, x-hat and losses equal, "
        f"best ssim {best:.4f} = the main run's; {card}"
    )
    emit(
        {
            "gia_attack_graph_vs_eager": label,
            "card": card,
            "steps": cfg.gia.steps,
            "restarts": cfg.n_attack_seeds,
            "graph_s": secs[None],
            "eager_s": secs[False],
        }
    )


def _gia_ordering(label, card, cfg):
    """(h1)'s steady-state claim, SGD leaks at least as much as LQ-SGD r1,
    on the mean best of ``GIA_ORDER_GROUP`` restarts over
    ``GIA_ORDER_RESTARTS`` restarts."""
    import dataclasses
    import statistics

    from repro_torch.bench import gia_ssim

    victim = gia_ssim.setup("cnn", "cuda")
    methods = ("sgd", "lq_sgd_r1")
    victim["methods"] = {m: victim["methods"][m] for m in methods}
    steady = max(cfg.attack_steps)
    many = dataclasses.replace(
        cfg, attack_steps=(steady,), n_attack_seeds=GIA_ORDER_RESTARTS
    )
    t0 = time.perf_counter()
    rows, _ = gia_ssim.bench(model="cnn", cfg=many, victim=victim)
    k = GIA_ORDER_GROUP
    best = {}
    for r in rows:
        s = r["seed_ssims"]
        best[r["method"]] = [max(s[i : i + k]) for i in range(0, len(s), k)]
    mean = {m: statistics.fmean(best[m]) for m in methods}
    diffs = [a - b for a, b in zip(best["sgd"], best["lq_sgd_r1"], strict=True)]
    se = statistics.stdev(diffs) / math.sqrt(len(diffs))
    wins = sum(d >= 0 for d in diffs)
    print(
        f"  {label}: steady state over {len(diffs)} groups of {k} restarts: mean "
        f"best-of-{k} ssim sgd {mean['sgd']:.4f}, lq_sgd_r1 {mean['lq_sgd_r1']:.4f} "
        f"(difference {statistics.fmean(diffs):.4f} +- {se:.4f} s.e.; sgd >= "
        f"lq_sgd_r1 in {wins} of {len(diffs)} groups), {time.perf_counter() - t0:.1f} "
        f"s; {card}"
    )
    check(mean["sgd"] >= mean["lq_sgd_r1"], f"{label}: LQ-SGD leaks more than SGD")
    emit(
        {
            "gia_ordering": "h1",
            "card": card,
            "restarts": GIA_ORDER_RESTARTS,
            "group": k,
            "mean_best": mean,
            "difference_se": se,
            "groups_sgd_ge_lq": wins,
        }
    )


def _gia_runs(card):
    import dataclasses

    from repro_torch.bench import gia_ssim
    from repro_torch.kernels import ops

    need = {
        "lq_sgd_r4": ("log_quantize", "log_dequantize"),
        "lq_sgd_r1": ("log_quantize", "log_dequantize"),
        "lq_sgd_r1_b4": ("log_quantize_pack", "log_dequantize"),
    }
    total = {name: 0 for name in ops.KERNELS}
    cfg = gia_ssim.harness_config(quick=False)
    for run, model in GIA_RUNS.items():
        t0 = time.perf_counter()
        label = f"({run}) GIA {model}"
        comp_cfgs = gia_ssim.setup(model, "cuda")["methods"]
        # the victim's trajectory in reference mode, no attack
        ref_logs, ref_flags = {}, []
        victim = _recorded_victim(model, ref_logs, ref_flags)
        with ops.reference_mode():
            gia_ssim.bench(
                model=model,
                device="cuda",
                cfg=dataclasses.replace(cfg, attack_steps=()),
                victim=victim,
            )
        # the main path: the sweep as the entry point runs it
        logs, flags = {}, []
        victim = _recorded_victim(model, logs, flags)
        ops.reset_launch_counts()
        rows, _ = gia_ssim.bench(model=model, device="cuda", victim=victim)
        counts = ops.launch_counts()
        seconds = time.perf_counter() - t0
        print(f"{label}: {len(victim['methods'])} methods, launches {counts}")
        for name in {k for m in victim["methods"] for k in need.get(m, ())}:
            check(counts[name] > 0, f"{label}: kernel {name} never launched")
        for name, c in counts.items():
            total[name] += c
        check(flags and not any(any(f) for f in flags), f"{label}: TF32 was on")
        check(all(_tf32_flags()), f"{label}: TF32 flags not restored")
        _check_victim_steps(label, comp_cfgs, logs, ref_logs)

        by = {(r["method"], r["phase"]): r for r in rows}
        for r in rows:
            finite = math.isfinite(r["ssim"]) and math.isfinite(r["psnr"])
            check(finite, f"{label}: {r['method']} {r['phase']}: not finite")
            print(
                f"  {label} {r['method']:>13} {r['phase']:>12}: ssim {r['ssim']:.4f} "
                f"psnr {r['psnr']:.2f} attack {r['attack_seconds']:.2f} s"
            )
        steady, cold = by[("sgd", "steady_state")], by[("sgd", "cold_start")]
        lq = by[("lq_sgd_r1", "steady_state")]
        order = ">=" if steady["ssim"] >= lq["ssim"] else "<"
        print(
            f"  {label}: steady state ssim sgd {steady['ssim']:.4f}, lq_sgd_r1 "
            f"{lq['ssim']:.4f} (SGD {order} LQ-SGD r1); cold start sgd "
            f"{cold['ssim']:.4f}; phase {seconds:.1f} s; {card}"
        )
        if run == "h1":
            check(cold["ssim"] > GIA_COLD_SSIM_MIN, f"{label}: cold-start SGD ssim")
            _gia_ordering(label, card, cfg)
        table = [{k: v for k, v in r.items() if k != "seed_ssims"} for r in rows]
        emit(
            {
                "gia": run,
                "model": model,
                "card": card,
                "seconds": seconds,
                "rows": table,
            }
        )
        _attack_step_split(run, card, gia_ssim.setup(model, "cuda"), cfg, model)
        _attack_graph_vs_eager(run, card, model, cfg, by[("sgd", "cold_start")])
    return total


# Phase 11, the model zoo (l): the untied head and the MoE layers at full
# width, seeded bf16. (l1)-(l4) serve, (l5) trains: run -> (arch, the cut of
# its depth, batch, prompt, cache bits). jamba-v0.1-52b keeps one period of
# its 8 (of 4) to fit one card with room for the reference-mode runs;
# mixtral-8x7b 8 of its 32 layers, mistral-nemo-12b 10 of its 40 and
# granite-20b 13 of its 52 so that the script keeps within its time (16,
# 20 and 26 from phase 16 to phase 18; halved with phase 19, when the
# script's final run took 1174.2 s of its 1200 on a slower host than the
# one before); the rest is at full depth.
ZOO_SERVE = {
    "l1": ("mistral-nemo-12b", {"repeats": 10}, 4, 1024, (8, 4)),
    "l2": ("granite-20b", {"repeats": 13}, 4, 1024, (8,)),
    "l3": ("mixtral-8x7b", {"repeats": 8}, 2, 5120, (8,)),
    "l4": ("jamba-v0.1-52b", {"repeats": 1}, 4, 1024, (8,)),
    # phase 12 (m): deepseek-v3-671b cut to its 3 dense lead layers and 1
    # MoE layer (4 of 61, about 31.6 GB in bf16), MTP in the tree;
    # musicgen-medium on 24 of its 48 layers (whole until phase 19),
    # prompts after its 64-step prefix
    "m1": ("deepseek-v3-671b", {"repeats": 1}, 4, 1024, (8,)),
    "m2": ("musicgen-medium", {"repeats": 24}, 4, 1024, (8, 4)),
}
ZOO_GEN = 32
# the JAX package's parameter counts of these cuts (tests/test_torch_zoo.py)
ZOO_PARAMS = {
    "l1": 4_068_582_400,
    "l2": 7_494_862_848,
    "l3": 11_872_309_248,
    "l4": 13_267_656_416,
    "l5": 1_713_418_240,
    # tests/test_torch_zoo_rest.py
    "m1": 15_797_366_784,
    "m2": 931_210_752,
    "m3": 91_094_080,
    "m4": 251_678_208,
    "m5a": 793_408,
    "m5b": 1_480_872,
}
# the accounting: layers x (K, V) x KV heads x (head_dim codes + a 4-byte
# scale) at q8, (head_dim / 2 + 4) at q4
ZOO_BYTES_PER_TOKEN = {
    ("l1", 8): 10 * 2 * 8 * (128 + 4),
    ("l1", 4): 10 * 2 * 8 * (64 + 4),
    ("l2", 8): 13 * 2 * 1 * (128 + 4),
    ("l3", 8): 8 * 2 * 8 * (128 + 4),
    # MLA: layers x (ckv 512 + krope 64 codes, two 4-byte scales)
    ("m1", 8): 4 * (512 + 64 + 2 * 4),
    ("m2", 8): 24 * 2 * 24 * (64 + 4),
    ("m2", 4): 24 * 2 * 24 * (32 + 4),
}
# The MoE layers against reference mode. At seeded init the router's top-2
# margins are small, and the kernel path (#6) and the plain attention round
# their bf16 outputs apart, so reference mode would now and then route a
# token to another expert, which replaces that token's whole FFN output:
# the logits check would then measure routing, not kernels. So reference
# mode is held to the kernel run's choices (moe.routing) and the logits are
# held to LOGITS_REL_TOL as for the dense models. Separately, at every MoE
# layer the choices reference mode would make from its own router logits
# (with the layers before held) are counted against the kernel run's; a
# flip needs the two runs' logits to cross between the k-th and the
# (k+1)-th expert, so reference mode's margin there must be small: at most
# MOE_FLIP_MARGIN, in logits, which are ~N(0, 1) at this init (the bf16
# residual streams of the two runs differ by ~1-2% after 16 layers, and the
# largest logit difference of 10240 tokens by ~4 sigma of that).
MOE_FLIP_MARGIN = 0.25
# Training runs, LQ-SGD r1 b8 and Adam, 3 steps: run -> (arch, the cut of
# its depth, smoke widths?, (mesh, global batch, sequence), learning rate,
# the JAX package's wire bits a step for this tree (tests/test_torch_zoo.py,
# tests/test_torch_zoo_rest.py), against reference mode and timed (1/0)).
# (l5): mixtral-8x7b's widths, one MoE layer. Adam at (j1)'s 1e-3 moves
# every weight of the untied 4096 x 32000 head by 1e-3 at its first step,
# which moves a logit by up to ~3 and raises the loss at the second step;
# 1e-4 moves it by ~0.3, and the full-width runs of phase 12 take it too.
# (m3) mamba2-370m and (m4) musicgen-medium (with its conditioning prefix)
# at full width, cut to 6 of their 48 layers so that the script keeps
# within its time with phases 13, 15 and 16 added (the checks are those
# of the whole depth, their bits and parameters the JAX package's for the
# cut, tests/test_torch_zoo_rest.py);
# (m5a) deepseek-v3-671b and (m5b) jamba-v0.1-52b
# at smoke widths: one MLA layer with deepseek's 129,280-token embedding,
# head and MTP head is ~3.1 B parameters, ~93 GB to train at (l5)'s ~30
# bytes a parameter, and jamba's smallest full-width unit (a period) 13.3 B.
ZOO_CUT6 = {"repeats": 6}
ZOO_TRAIN = {
    "l5": ("mixtral-8x7b", {"repeats": 1}, False, ((2, 1), 4, 512), 1e-4, 2_626_336, 1),
    "m3": ("mamba2-370m", ZOO_CUT6, False, ((4, 1), 8, 512), 1e-4, 1_200_544, 1),
    "m4": ("musicgen-medium", ZOO_CUT6, False, ((2, 1), 4, 512), 1e-4, 2_001_760, 1),
    "m5a": ("deepseek-v3-671b", {}, True, ((2, 1), 4, 64), 1e-3, 122_112, 0),
    "m5b": ("jamba-v0.1-52b", {}, True, ((2, 1), 4, 64), 1e-3, 144_992, 0),
}
ZOO_TRAIN_STEPS = 3
# the runs whose step-0 wire codes must equal reference mode's exactly (the
# step-0 gradients into the sync are equal bit for bit)
ZERO_FLIPS_AT_STEP0 = ("m3",)
# the step metrics besides ce and loss that a zoo model may log
ZOO_AUX = ("moe_aux", "mtp_ce")


def phase_zoo(card):
    """(l) the model zoo: four architectures served at full width, MoE
    training through the LQ-SGD sync. Each model is freed before the next
    is built."""
    total = {}
    for run in ("l1", "l2", "l3", "l4"):
        for name, c in _zoo_serve(card, run).items():
            total[name] = total.get(name, 0) + c
        _free_cuda()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, c in _zoo_train(card, "l5").items():
            total[name] = total.get(name, 0) + c
    finally:
        torch.use_deterministic_algorithms(False)
    _free_cuda()
    return total


def phase_zoo_rest(card):
    """(m) the zoo's last two architectures and Mamba-2 training: (m1)
    deepseek-v3-671b (MLA with its latent cache, 256 experts) and (m2)
    musicgen-medium (codebook heads after the conditioning prefix) served
    at full width; (m3) mamba2-370m and (m4) musicgen-medium trained at
    full width on 6 of their 48 layers, (m5) deepseek-v3-671b and
    jamba-v0.1-52b at smoke widths, through the LQ-SGD sync. Deterministic
    algorithms are on for the training comparisons, as in (l5). Each model
    is freed before the next is built."""
    total = {}
    for run in ("m1", "m2"):
        t0 = time.perf_counter()
        for name, c in _zoo_serve(card, run).items():
            total[name] = total.get(name, 0) + c
        _free_cuda()
        print(f"({run}) {time.perf_counter() - t0:.1f} s")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for run in ("m3", "m4", "m5a", "m5b"):
            t0 = time.perf_counter()
            for name, c in _zoo_train(card, run).items():
                total[name] = total.get(name, 0) + c
            _free_cuda()
            print(f"({run}) {time.perf_counter() - t0:.1f} s")
    finally:
        torch.use_deterministic_algorithms(False)
    return total


def _zoo_cfg(arch, cut, smoke=False):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch, smoke=smoke), **cut)


def _moe_flips(label, cfg, kernel_calls, held_calls, who="reference-mode"):
    """Per MoE layer, the assignments reference mode (``who``) would route
    otherwise (from its own router logits, the layers before held to the
    kernel run's choices), each at a reference margin <= MOE_FLIP_MARGIN.
    Returns the flips per layer."""
    k = cfg.experts_per_token
    per_layer, worst = [], 0.0
    for (chosen, _), (_, logits) in zip(kernel_calls, held_calls, strict=True):
        probs = torch.softmax(logits, dim=-1)
        own = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]
        overlap = (own[..., :, None] == chosen[..., None, :]).any(-1).sum(-1)
        moved = k - overlap  # assignments of each token routed otherwise
        top = logits.topk(k + 1, dim=-1).values
        margin = top[..., k - 1] - top[..., k]
        flipped = moved > 0
        if bool(flipped.any()):
            m = float(margin[flipped].max())
            check(
                m <= MOE_FLIP_MARGIN,
                f"{label}: a routing flip at a reference margin of {m:.3g}",
            )
            worst = max(worst, m)
        per_layer.append(int(moved.sum()))
    n = kernel_calls[0][0].numel()
    print(
        f"  {label}: {who} routing flips per MoE layer {per_layer} of "
        f"{n} assignments each, largest reference margin {worst:.3g} "
        f"(bound {MOE_FLIP_MARGIN})"
    )
    return per_layer


def _dropped(cfg, calls):
    """Assignments past each MoE layer's capacity, per layer."""
    from repro_torch.models import moe

    out = []
    for chosen, _ in calls:
        t = chosen.shape[1]
        cap = moe.moe_capacity(t, cfg)
        hits = chosen.reshape(-1, 1) == torch.arange(cfg.n_experts, device="cuda")
        out.append(int((hits.sum(0) - cap).clamp_min(0).sum()))
    return out


def _zoo_prefill_checks(label, cfg, params, tokens, prefill):
    """The prefill, kernel path against reference mode (the routing held to
    the kernel run's): logits by LOGITS_REL_TOL and the argmax rule; with
    Mamba-2 layers, every cache leaf (dequantized K/V, raw conv window and
    SSM state) within SSM_CACHE_REL_TOL of its largest value, as (g1)."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.serving.kv_cache import QuantKV, dequantize_kv, tree_leaves

    with moe.routing() as rec:
        logits, caches = prefill(params, tokens)
    held = rec.choices if cfg.n_experts else None
    with ops.reference_mode(), moe.routing(held) as ref_rec:
        ref_logits, ref_caches = prefill(params, tokens)
    _logits_close(logits, ref_logits, label)
    if any(spec.kind == "mamba" for spec in cfg.layers):
        worst = {}
        pairs = zip(tree_leaves(caches), tree_leaves(ref_caches), strict=True)
        for (path, g), (_, w) in pairs:
            if isinstance(g, QuantKV):
                g, w = dequantize_kv(g), dequantize_kv(w)
            g, w = g.float(), w.float()
            check(bool(torch.isfinite(g).all()), f"{label}: non-finite {path}")
            rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            check(rel <= SSM_CACHE_REL_TOL, f"{label}: cache {path} rel {rel:.3e}")
            worst[path[-1]] = max(worst.get(path[-1], 0.0), rel)
        print(f"  {label}: prefill caches vs reference mode, max rel {worst}")
    out = {"logits": logits}
    if cfg.n_experts:
        out["flips"] = _moe_flips(label, cfg, rec.calls, ref_rec.calls)
        out["dropped"] = _dropped(cfg, rec.calls)
        cap = moe.moe_capacity(rec.calls[0][0].shape[1], cfg)
        print(
            f"  {label}: capacity {cap} a expert at prefill, dropped assignments "
            f"per MoE layer {out['dropped']}"
        )
    return out


def _zoo_serve(card, run):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.models.model import count_params, init_params
    from repro_torch.models.multimodal import (
        codec_tokens_stub,
        conditioning_stub,
        vq_tokens_stub,
    )
    from repro_torch.serving.engine import (
        build_decode_step,
        build_generate_fn,
        build_prefill_step,
        greedy_sample,
    )
    from repro_torch.serving.kv_cache import CacheQuantConfig, tree_leaves

    arch, cut, batch, prompt, bits_list = ZOO_SERVE[run]
    cfg = _zoo_cfg(arch, cut)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, 1, "cuda")
    torch.cuda.synchronize()
    n_params = count_params(params)
    cut_note = f", cut to {cfg.n_layers} layers" if cut else ""
    if cfg.use_mla:
        heads = (
            f"MLA, {cfg.n_heads} heads of {cfg.qk_nope_dim} + {cfg.qk_rope_dim}, "
            f"latent {cfg.kv_lora_rank} + {cfg.qk_rope_dim}"
        )
    else:
        heads = f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}"
    print(
        f"({run}) serve {arch}: {cfg.n_layers} layers{cut_note}, d={cfg.d_model}, "
        f"{heads}, {n_params} params in {cfg.dtype} "
        f"({torch.cuda.memory_allocated() / 1e9:.1f} GB), init "
        f"{time.perf_counter() - t0:.1f} s"
    )
    check(n_params == ZOO_PARAMS[run], f"({run}) {arch}: {n_params} params")
    gen = torch.Generator(device="cuda").manual_seed(3)
    if cfg.n_codebooks:
        tokens = codec_tokens_stub(gen, batch, prompt, cfg)
    elif cfg.arch_type == "vlm":
        tokens = vq_tokens_stub(gen, batch, prompt, cfg)
    else:
        tokens = torch.randint(
            0, cfg.vocab_size, (batch, prompt), generator=gen, device="cuda"
        )
    cond = conditioning_stub(gen, batch, cfg) if cfg.cond_len else None
    n_mamba = sum(spec.kind == "mamba" for spec in cfg.layers)
    # decode goes on after the conditioning prefix and the prompt
    start = prompt + cfg.cond_len
    max_seq = start + ZOO_GEN
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    total = {name: 0 for name in ops.KERNELS}
    for bits in bits_list:
        label = f"({run}) {arch} batch {batch} x prompt {prompt} + {ZOO_GEN}, q{bits}"
        qcfg = CacheQuantConfig(bits=bits)
        prefill = functools.partial(
            build_prefill_step(cfg, max_seq, qcfg=qcfg), cond=cond
        )
        pre = _zoo_prefill_checks(label, cfg, params, tokens, prefill)

        # the main path: prefill + graphed decode through the launcher's
        # run_fixed, then the same with the decode steps one by one
        ops.reset_launch_counts()
        out = serve.run_fixed(cfg, params, tokens, gen=ZOO_GEN, qcfg=qcfg, cond=cond)
        counts = ops.launch_counts()
        print(f"{label}: launches {counts}")
        encode = "log_quantize" if bits == 8 else "log_quantize_pack"
        for name in (encode, "log_dequantize_rows", "flash_attention"):
            check(counts[name] > 0, f"{label}: kernel {name} never launched")
        # one prefill: ssd_chunk once a Mamba-2 layer; a decode step none
        check(counts["ssd_chunk"] == n_mamba, f"{label}: ssd_chunk {counts}")
        for name, c in counts.items():
            total[name] += c
        same = torch.equal(out["logits"], pre["logits"])
        check(same, f"{label}: the prefill is not repeatable")
        ops.reset_launch_counts()
        eager = serve.run_fixed(
            cfg, params, tokens, gen=ZOO_GEN, qcfg=qcfg, graph=False, cond=cond
        )
        _graph_equals_eager(label, card, out, eager, counts, ops.launch_counts())
        del eager
        toks = out["tokens"]
        want_shape = (batch, ZOO_GEN) + cb
        check(tuple(toks.shape) == want_shape, f"{label}: tokens {toks.shape}")
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), f"{label}: bad ids")

        # decode vs reference mode from the same caches (the kernel path's
        # prefill again): every step must pick the main run's token and
        # leave the main run's caches
        logits, caches = prefill(params, tokens)
        check(torch.equal(greedy_sample(logits), toks[:, :1]), f"{label}: first token")
        with ops.reference_mode():
            caches, _, _, sampled = build_generate_fn(cfg)(
                params, caches, toks[:, :1], start, None, ZOO_GEN - 1
            )
        same = sampled == toks[:, 1:]
        check(
            bool(same.all()),
            f"{label}: {int((~same).sum())} of {same.numel()} decode tokens "
            "differ from reference mode",
        )
        flips = _caches_match(out["caches"], caches, label)
        del caches
        print(
            f"  {label}: {same.numel()} decode tokens equal to reference mode, "
            f"caches equal but {flips} one-step code flip(s)"
        )
        bpt, acc = out["bytes_per_token"], out["bytes_per_token_accounted"]
        leaves = list(tree_leaves(out["caches"]))
        n_bytes = 0
        for _, t in leaves:
            for part in (t.codes, t.scale) if hasattr(t, "codes") else (t,):
                n_bytes += part.numel() * part.element_size()
        check(bpt == acc == n_bytes / (batch * max_seq), f"{label}: {bpt} vs {acc}")
        want_bpt = ZOO_BYTES_PER_TOKEN.get((run, bits))
        if want_bpt is not None:
            check(bpt == want_bpt, f"{label}: bytes/token {bpt} != {want_bpt}")
        # where the time goes: each step eager (host clock) against the same
        # step replayed from a CUDA graph (device time); one more decode
        # step at the last cache position
        caches, last = out["caches"], toks[:, -1:].contiguous()
        decode = build_decode_step(cfg)
        steps = {
            "prefill": lambda: prefill(params, tokens),
            "decode_step": lambda: decode(params, caches, last, max_seq - 1),
        }
        split = {}
        for step, fn in steps.items():
            h_ms, g_ms = host_ms(fn), cuda_ms(fn, 1)
            split[step] = {"host_ms": h_ms, "graph_ms": g_ms}
            emit({"split": f"{run}_{step}_q{bits}", "card": card, **split[step]})
        if bits == 8:
            by_name = device_ms_by_kernel(steps["decode_step"])
            _kernel_split(f"{run}_decode_step_q8", card, by_name, GEMMA_KERNELS)
        print(
            f"  {label}: prefill {split['prefill']['host_ms']:.1f} ms eager, "
            f"{split['prefill']['graph_ms']:.1f} ms a replay; a decode step "
            f"{split['decode_step']['host_ms']:.2f} ms eager, "
            f"{split['decode_step']['graph_ms']:.2f} ms a replay"
        )
        del caches, steps
        peak = torch.cuda.max_memory_allocated() / 1e9
        decode_tps = batch * (ZOO_GEN - 1) / out["decode_s"]
        print(
            f"  {label}: {bpt:.3f} bytes/token measured = accounted; prefill "
            f"{out['prefill_s'] * 1e3:.1f} ms, decode {decode_tps:.1f} tokens/s, "
            f"peak {peak:.1f} GB; {card}"
        )
        emit(
            {
                "serve": f"{run}_{arch}_q{bits}",
                "card": card,
                "params": n_params,
                "layers": cfg.n_layers,
                "prefill_ms": out["prefill_s"] * 1e3,
                "decode_tokens_per_s": decode_tps,
                "capture_s": out["capture_s"],
                "bytes_per_token": bpt,
                "bytes_per_token_accounted": acc,
                "peak_memory_gb": peak,
                "split": split,
                "launches": counts,
                "moe_flips_per_layer": pre.get("flips"),
                "moe_dropped_per_layer": pre.get("dropped"),
            }
        )
        del out, pre
        _free_cuda()
    if cfg.n_experts:
        # decode: one token a row, T = batch, capacity 8
        cap = moe.moe_capacity(batch, cfg)
        check(cap == 8, f"({run}): decode capacity {cap}")
        print(f"  ({run}) {arch}: capacity {cap} a expert at decode")
    del params
    return total


def _zoo_train(card, run):
    """A zoo training run of ``ZOO_TRAIN`` through the LQ-SGD sync (the
    launcher's Trainer, Adam): the graphed step against graph=False bit for
    bit (losses, the aux metrics, step-0 gradients into the sync, every
    step's synced gradients and wire, bits, final params, launches), the
    wire bits a step against the JAX package's accounting; where the table
    asks, then reference mode (an MoE model's routing held to the eager
    kernel run's) as (j1), and the step timed as the launcher runs it."""
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.train.optimizer import adam
    from repro_torch.train.step import init_train_params

    arch, cut, smoke, shape, lr, bits, vs_reference = ZOO_TRAIN[run]
    cfg = _zoo_cfg(arch, cut, smoke)
    mesh, batch, seq = shape
    steps = ZOO_TRAIN_STEPS
    comp_cfg = CompressorConfig(name="lq_sgd", rank=1, bits=8)
    widths = "smoke widths" if smoke else "full width"
    label = (
        f"({run}) {cfg.name} {widths}, {cfg.n_layers} layers, {mesh[0]} workers "
        f"x {batch // mesh[0]} x {seq}, LQ-SGD r1 b8, Adam lr {lr:g}, Trainer"
    )
    init = init_train_params(cfg, 0, "cuda")
    n_params = sum(w.numel() for w in tree_leaves(init))
    init = [w.detach().to("cpu") for w in tree_leaves(init)]
    check(n_params == ZOO_PARAMS[run], f"{label}: {n_params} parameters")
    runs = {}
    for name, graph in (("graph", None), ("eager", False)):
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        # the eager run's routing is recorded, for reference mode to hold
        record = graph is False and cfg.n_experts
        with moe.routing() if record else contextlib.nullcontext() as rec:
            r = _lm_run(
                cfg,
                comp_cfg,
                adam(lr),
                steps,
                graph=graph,
                every=True,
                timed=True,
                shape=shape,
            )
        step_ms = r["log"]["step_ms"]
        history = r["loop"].history
        runs[name] = dict(
            counts=ops.launch_counts(),
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            params=_host_params(r["state"]),
            log=r["log"],
            losses=[h["loss"] for h in history],
            aux={k: [h[k] for h in history] for k in ZOO_AUX if k in history[0]},
            capture_s=r["step"].capture_s,
            gathered=[w.cpu() for ws in r["log"]["wire"] for w in ws],
            choices=rec.choices if rec is not None else None,
            # graphed: step 0 is the warm-up, 1 the capture, 2 a replay
            step_ms=step_ms,
            ms_per_step=step_ms[-1] if graph is None else _median(step_ms),
        )
        _lm_tokens_checked(f"({run}) {name}", cfg, r["log"], steps, batch, seq)
        del r
    g, e = runs["graph"], runs["eager"]
    _lm_graph_equals_eager(label, g, e)
    check(g["aux"] == e["aux"], f"{label}: {sorted(g['aux'])}, graph != eager")
    want_aux = {"moe_aux"} if cfg.n_experts else set()
    want_aux |= {"mtp_ce"} if cfg.mtp else set()
    check(set(g["aux"]) == want_aux, f"{label}: metrics {sorted(g['aux'])}")
    counts = g["counts"]
    for name in ("log_quantize", "log_dequantize"):
        check(counts[name] > 0, f"{label}: kernel {name} never launched")
    # the training forward takes the plain attention and the plain SSD
    for name in ("log_quantize_pack", "flash_attention", "ssd_chunk"):
        check(counts[name] == 0, f"{label}: kernel {name} launched")
    if cfg.n_experts:
        # each MoE layer's forward a worker a step, and remat's recompute of
        # the scanned ones
        n_scan = sum(spec.moe for spec in cfg.pattern) * cfg.repeats
        n_moe = sum(spec.moe for spec in cfg.layers)
        n_calls = (n_moe + n_scan) * mesh[0] * steps
        check(len(e["choices"]) == n_calls, f"{label}: {len(e['choices'])} MoE calls")
    comp, colls = None, None
    for rec in g["log"]["rec"] + e["log"]["rec"]:
        check(rec.effective_bits() == bits, f"{label}: {rec.effective_bits()} bits")
    summary = (
        f"  {label}: {n_params} parameters, {bits} wire bits/step (the JAX "
        f"package's accounting); graph = eager bit for bit over {steps} steps "
        f"(losses, {sorted(g['aux'])}, step-0 gradients into the sync, every "
        f"step's synced grads, wire, bits, final params, launches {counts}); "
        f"losses {[round(v, 4) for v in g['losses']]}, "
        f"{ {k: [round(x, 4) for x in v] for k, v in g['aux'].items()} }"
    )
    out = {
        "train": f"{run}_{cfg.name}_lq_sgd_r1_b8_adam",
        "card": card,
        "params": n_params,
        "wire_bits_per_step": bits,
        "graph_equals_eager": True,
        "ms_per_step_deterministic": {k: runs[k]["ms_per_step"] for k in runs},
        "step_ms_deterministic": {k: runs[k]["step_ms"] for k in runs},
        "lr": lr,
        "peak_memory_gb": {k: runs[k]["peak_gb"] for k in runs},
        "capture_s": g["capture_s"],
        "losses": g["losses"],
        "aux": g["aux"],
        "launches": counts,
    }
    check(all(math.isfinite(v) for v in g["losses"]), f"{label}: {g['losses']}")
    if vs_reference:
        _free_cuda()
        held = moe.routing(e["choices"]) if cfg.n_experts else contextlib.nullcontext()
        with ops.reference_mode(), held:
            r = _lm_run(
                cfg, comp_cfg, adam(lr), steps, graph=False, every=True, shape=shape
            )
        ref = dict(
            params=_host_params(r["state"]),
            log=r["log"],
            losses=[h["loss"] for h in r["loop"].history],
            gathered=[w.cpu() for ws in r["log"]["wire"] for w in ws],
        )
        comp = r["comp"]
        del r
        _free_cuda()
        colls = comp.handler.group_collectives(comp.plans)
        planned = comp.wire_bits_per_step()
        check(planned == bits, f"{label}: {planned} bits planned")
        for rec in g["log"]["rec"] + e["log"]["rec"] + ref["log"]["rec"]:
            check(rec.effective_bits() == bits, f"{label}: {rec.effective_bits()} bits")
            check(rec.effective_collectives() == colls, f"{label}: collectives")
        for a, b in zip(g["log"]["grads0"], ref["log"]["grads0"], strict=True):
            check(torch.equal(a, b), f"{label}: step-0 gradients into the sync differ")
        flips, n_codes, flips0, grad_rel, param_rel = _lm_close_to_reference(
            label, g, ref, init, steps, workers=mesh[0], lr=lr
        )
        if run in ZERO_FLIPS_AT_STEP0:
            check(flips0 == 0, f"{label}: {flips0} code flips at step 0")
        torch.use_deterministic_algorithms(False)
        try:
            timed = _lm_timed(cfg, comp_cfg, card, shape=shape, lr=lr, tag=run)
        finally:
            torch.use_deterministic_algorithms(True, warn_only=True)
        held_note = ", the routing held" if cfg.n_experts else ""
        summary += (
            f"; {colls} collectives a step; vs reference mode{held_note}: step-0 "
            f"gradients into the sync equal, {flips} of {n_codes} codes flipped "
            f"({flips0} at step 0), step-0 synced grads rel {grad_rel:.2e}, params "
            f"rel {param_rel:.2e}"
        )
        out.update(
            collectives_per_step=colls,
            timed=timed,
            idle_share=timed["idle_share"],
            reference_losses=ref["losses"],
            code_flips=flips,
            code_flips_step0=flips0,
            step0_synced_grad_rel_err=grad_rel,
            param_rel_err=param_rel,
        )
    print(
        summary + f"; ms a step (host clock to a device sync) graphed "
        f"{g['ms_per_step']:.1f} (a replay; warm-up and capture "
        f"{g['step_ms'][0]:.1f}, {g['step_ms'][1]:.1f}; capture "
        f"{g['capture_s']:.2f} s), eager {e['ms_per_step']:.1f} (median); peak "
        f"{g['peak_gb']:.1f} / {e['peak_gb']:.1f} GB (deterministic algorithms "
        f"on); {card}"
    )
    emit(out)
    return counts


# Phase 13, data parallelism across processes (n). (n1): (j1)'s run through
# an NCCL DistComm of world 1 holding the 4 workers, in this process; (n2):
# ResNet-18 as (d) over 4 gloo ranks sharing the card, 1 worker x 128 each,
# spawned through torchrun and launch/train_resnet.py; (n3): launch.train at
# smoke widths over 2 gloo ranks, checkpoint at step 2, resumed here
N2_RANKS, N2_STEPS = 4, 2
N3_RANKS, N3_CKPT, N3_STEPS = 2, 2, 4
N3_ARGS = [
    "--arch", LM_ARCH, "--smoke", "--mesh", "2x1", "--batch", "4", "--seq",
    "32", "--compressor", "lq_sgd", "--rank", "1", "--bits", "8",
    "--log-every", "1", "--deterministic",
]  # fmt: skip
# a spawn that has not ended by then fails (phase_tp's 1x2 torchrun, the
# longest, took ~150 s)
TORCHRUN_TIMEOUT_S = 450


def phase_dryrun(card):
    """(u) The dry run: (u1) the CLI over the production mesh in a
    subprocess, (u2) (j1)'s configuration in this process against (j1)'s
    timed run (module doc, phase 20). Launches no kernel."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "dryrun_u1.json"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun"]
        cmd += ["--arch", "gemma3-1b", "--shape", ",".join(U1_SHAPES)]
        cmd += ["--device", "cuda", "--out", str(out)]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        u1 = subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        try:
            u2 = _dryrun_u2(card)
            log, _ = u1.communicate(timeout=300)
        finally:
            if u1.poll() is None:
                u1.kill()
                u1.wait()
        print(log.rstrip())
        check(u1.returncode == 0, f"(u1) the dry run exited {u1.returncode}")
        u1_s = time.perf_counter() - t0
        recs = {r["shape"]: r for r in json.loads(out.read_text())}
    check(sorted(recs) == sorted(U1_SHAPES), f"(u1) records {sorted(recs)}")
    for shape, r in recs.items():
        check(r["status"] == "ok", f"(u1) {shape}: {r['status']}")
        check(
            r["chips"] == 256 and r["mesh"] == [32, 8] and r["device"] == "cuda:0",
            f"(u1) {shape}: {r['chips']} cards, mesh {r['mesh']}, {r['device']}",
        )
        check(r["counted_flops_per_device"] > 0, f"(u1) {shape}: no FLOPs counted")
    train = recs["train_4k"]
    dense = train["analytic_dense_attn_flops_per_device"]
    rel = abs(train["counted_flops_per_device"] - dense) / dense
    check(rel < U1_ANALYTIC_REL, f"(u1) train_4k: counted FLOPs {rel:.3f} off")
    keep = (
        "trace_s",
        "counted_flops_per_device",
        "analytic_flops_per_device",
        "analytic_dense_attn_flops_per_device",
        "bytes_per_device",
        "memory",
        "collective_counts",
        "model_axis_wire_bytes",
        "data_axis_wire_bytes",
        "compressor_phys_bits",
        "compute_s",
        "memory_s",
        "collective_s",
        "dominant",
    )
    for shape, r in recs.items():
        emit(
            {
                "dryrun": f"u1_gemma3_1b_{shape}_32x8",
                "card": card,
                **{k: r[k] for k in keep if k in r},
            }
        )
    print(
        f"  (u1) gemma3-1b on the production mesh 32x8 (fake CUDA tensors): "
        f"{u1_s:.1f} s with its start; train_4k counted FLOPs {rel:.2%} from "
        f"the analytic model (attention as computed), "
        f"{train['counted_flops_per_device'] / train['analytic_flops_per_device']:.3f}"
        f"x the JAX model's; {card}"
    )
    emit({"dryrun": "u2_j1", "card": card, **u2})
    return {}


def _dryrun_u2(card):
    """(j1)'s configuration traced in this process (fake CUDA tensors),
    held to (j1)'s timed run."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.launch import dryrun
    from repro_torch.roofline import hw
    from repro_torch.train.optimizer import adam

    timed = _J1_GRAPH["timed"]
    label = (
        f"(u2) {LM_ARCH} {LM_MESH[0]} workers x {LM_BATCH // LM_MESH[0]} x "
        f"{LM_SEQ}, LQ-SGD r1 b8, Adam, traced"
    )
    shape = InputShape("j1", LM_SEQ, LM_BATCH, "train")
    before = torch.cuda.memory_allocated()
    r = dryrun.trace_one(
        get_config(LM_ARCH),
        shape,
        mesh=LM_MESH,
        one_process=True,
        comp_cfg=CompressorConfig(name="lq_sgd", rank=1, bits=8),
        optimizer=adam(J1_LR),
        device="cuda",
        verbose=False,
    )
    check(
        torch.cuda.memory_allocated() == before,
        f"{label}: the trace allocated on the card",
    )
    mem = r["memory"]
    want_args = timed["argument_bytes"]
    check(
        mem["argument_bytes"] == want_args,
        f"{label}: argument bytes {mem['argument_bytes']} against (j1)'s {want_args}",
    )
    measured = timed["eager"]["peak_bytes"]
    traced = mem["peak_est_bytes"]
    bound = U2_PEAK_REL * measured + U2_PEAK_SLACK
    check(
        abs(traced - measured) <= bound,
        f"{label}: traced peak {traced} against (j1)'s eager {measured} (bound "
        f"{bound:.0f})",
    )
    replay_ms = timed["graph"]["device_ms"]
    mfu = r["counted_flops_per_device"] / (replay_ms / 1e3) / hw.PEAK_FLOPS_BF16
    print(
        f"  {label}: argument bytes {mem['argument_bytes']} = (j1)'s state and "
        f"batch; traced peak {traced / 1e9:.3f} GB against the eager step's "
        f"{measured / 1e9:.3f} GB ({(traced - measured) / measured:+.2%}, bound "
        f"+-{bound / 1e9:.3f} GB); counted {r['counted_flops_per_device']:.4e} "
        f"FLOPs a step over (j1)'s replay {replay_ms:.1f} ms: mfu {mfu:.4f} of "
        f"989 TFLOP/s; traced in {r['trace_s']} s, nothing allocated on the "
        f"card; {card}"
    )
    return dict(
        argument_bytes=mem["argument_bytes"],
        traced_peak_bytes=traced,
        eager_peak_bytes=measured,
        peak_rel=(traced - measured) / measured,
        counted_flops=r["counted_flops_per_device"],
        analytic_flops=r["analytic_flops_per_device"],
        replay_ms=replay_ms,
        mfu=mfu,
        trace_s=r["trace_s"],
    )


def phase_dist(card):
    """(n1) the LQ-SGD sync's collectives as torch.distributed ones, in this
    process ((n2) and (n3) run in the torchruns of ``phase_tp``)."""
    return _dist_n1(card)


def _torchrun(label, ranks, module_args, script=False, env=None):
    """``python -m torch.distributed.run`` of ``ranks`` processes on this
    host (a rendezvous on a free local port) running a module (or, with
    ``script``, the script ``module_args`` begins with), in a process
    group of its own that is killed whole on the deadline, with ``env``
    added to this process's environment. Returns (stdout, seconds)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone"]
    cmd += [f"--nproc-per-node={ranks}", *([] if script else ["-m"]), *module_args]
    paths = (str(ROOT / "src"), os.environ.get("PYTHONPATH"))
    path = os.pathsep.join(p for p in paths if p)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        cmd,
        cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=path, **(env or {})),
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
        start_new_session=True,
    )
    try:
        out, err = proc.communicate(timeout=TORCHRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SmokeFailure(f"{label}: torchrun not done in {TORCHRUN_TIMEOUT_S} s")
    secs = time.perf_counter() - t0
    for line in out.splitlines()[-8:]:
        print(f"    {label} | {line}")
    rc = proc.returncode
    if rc != 0:  # the ranks' tracebacks, beyond the failure's own tail
        print(err[-20000:])
    check(rc == 0, f"{label}: torchrun exited {rc}: {err[-3000:]}")
    return out, secs


def _dist_n1(card):
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.comm import DistComm
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.kernels import ops
    from repro_torch.train.optimizer import adam

    j1 = _J1_GRAPH
    check("params" in j1 and "timed" in j1, "(n1): no (j1) run to hold it to")
    cfg = get_config(LM_ARCH)
    comp_cfg = CompressorConfig(name="lq_sgd", rank=1, bits=8)
    label = (
        f"(n1) {LM_ARCH} full width, NCCL DistComm of world 1 x {LM_MESH[0]} "
        f"local workers x {LM_BATCH // LM_MESH[0]} x {LM_SEQ}, LQ-SGD r1 b8, Adam"
    )
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            comm = DistComm(LM_MESH[0], record=True)
            _free_cuda()
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                ops.reset_launch_counts()
                r = _lm_run(
                    cfg, comp_cfg, adam(J1_LR), J1_STEPS, every=True, comm=comm
                )
                counts = ops.launch_counts()
            finally:
                torch.use_deterministic_algorithms(False)
            step = r["step"]
            replays = step.graph is not None and step.graph.captured
            check(replays, f"{label}: the step is not one CUDA-graph replay")
            got = dict(
                counts=counts,
                params=_host_params(r["state"]),
                log=r["log"],
                losses=[h["loss"] for h in r["loop"].history],
                gathered=[w.cpu() for ws in r["log"]["wire"] for w in ws],
            )
            _lm_tokens_checked("(n1)", cfg, r["log"], J1_STEPS)
            del r, step
            _free_cuda()
            for name in ("log_quantize", "log_dequantize"):
                check(counts[name] > 0, f"{label}: kernel {name} never launched")
            _lm_graph_equals_eager(label, got, j1, names=("NCCL", "(j1) SimComm"))
            n_gathers = len(got["gathered"])
            print(
                f"{label}: {comm!r}; each step one CUDA-graph replay with its "
                f"NCCL collectives captured; bit for bit (j1)'s SimComm run over "
                f"{J1_STEPS} steps (step-0 gradients into the sync, every step's "
                f"synced grads, {n_gathers} gathered wire arrays, bits, losses, "
                f"final params, launches {counts}); {card}"
            )
            del got
            timed = _lm_timed(
                cfg, comp_cfg, card, tag="n1", comm=comm, variants=("graph", "eager")
            )
        finally:
            dist.destroy_process_group()
    ref = j1["timed"]
    for name in ("graph", "eager"):
        print(
            f"  (n1) {name}: {timed[name]['host_ms']:.1f} ms a step over NCCL "
            f"({timed[name]['device_ms']:.1f} between CUDA events) against (j1)'s "
            f"SimComm {ref[name]['host_ms']:.1f} ({ref[name]['device_ms']:.1f}); "
            f"{card}"
        )
    emit(
        {
            "dist": "n1_gemma3_1b_nccl_world1_x4",
            "card": card,
            "bit_equal_to_j1": True,
            "timed": timed,
            "j1_timed": {k: ref[k] for k in ("graph", "eager")},
            "launches": counts,
        }
    )
    _J1_GRAPH.clear()
    return counts


N2_ARGV = [
    "--workers", str(N2_RANKS), "--batch", str(TRAIN_BATCH),
    "--hw", str(TRAIN_HW), "--classes", str(TRAIN_CLASSES),
    "--steps", str(N2_STEPS), "--lr", str(TRAIN_LR),
    "--dist-backend", "gloo", "--device", "cuda:0", "--deterministic",
]  # fmt: skip


def _n2_rank(out_dir):
    """One rank's (n2) run in the torchrun of the 2x2 mesh (world 4) that
    phases (n2)-(r) share: ``launch/train_resnet.py``'s ``main``, dumping
    to ``out_dir/n2/``."""
    from repro_torch.launch import train_resnet

    train_resnet.main(N2_ARGV + ["--dump", str(Path(out_dir, "n2"))])


def _n2_checks(card, out_dir):
    """(n2): the 4 ranks' dumps against the same run over SimComm(4) in
    this process."""
    from repro_torch.core.comm import SimComm
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.train.data_parallel import train_one

    cfg = CompressorConfig(name="lq_sgd", rank=1, bits=8)
    label = (
        f"(n2) ResNet-18 over {N2_RANKS} gloo ranks on one card x 1 worker x "
        f"{TRAIN_BATCH}, LQ-SGD r1 b8, {N2_STEPS} eager steps"
    )
    # the same algorithms in every process: the ranks' --deterministic
    torch.backends.cudnn.deterministic = True
    ranks = [
        torch.load(Path(out_dir, "n2", f"rank{r}.pt"), weights_only=False)
        for r in range(N2_RANKS)
    ]
    comm = SimComm(N2_RANKS, record=True)
    synced = []
    ops.reset_launch_counts()
    want = train_one(
        cfg,
        n_workers=N2_RANKS,
        batch=TRAIN_BATCH,
        hw=TRAIN_HW,
        n_classes=TRAIN_CLASSES,
        steps=N2_STEPS,
        lr=TRAIN_LR,
        seed=0,
        device="cuda",
        comm=comm,
        graph=False,
        on_sync=lambda step, g, st: synced.append([x.cpu() for x in tree_leaves(g)]),
    )
    counts = ops.launch_counts()
    gathered = [g.cpu() for g in comm.gathered]
    params = [p.detach().cpu() for p in tree_leaves(want.params)]
    bits = want.comp.wire_bits_per_step()
    per_step = len(gathered) // N2_STEPS
    payload = sum(g[0].numel() * g.element_size() * 8 for g in gathered[:per_step])
    launches = {name: 0 for name in ops.KERNELS}
    for r, res in enumerate(ranks):
        who = f"{label}, rank {r}"
        check(len(res["gathered"]) == len(gathered), f"{who}: gathers in number")
        for i, (g, w) in enumerate(zip(res["gathered"], gathered)):
            check(
                g.dtype == w.dtype and torch.equal(g, w),
                f"{who}: gather {i} differs from SimComm({N2_RANKS})'s bytes",
            )
        for t, (gs, ws) in enumerate(zip(res["synced"], synced, strict=True)):
            for g, w in zip(gs, ws, strict=True):
                check(torch.equal(g, w), f"{who}: step {t} synced grads differ")
        for p, w in zip(res["params"], params, strict=True):
            check(torch.equal(p, w), f"{who}: final params differ")
        check(res["losses"] == want.losses, f"{who}: losses differ")
        check(res["bits"] == [bits] * N2_STEPS, f"{who}: bits {res['bits']} != {bits}")
        for name in ("log_quantize", "log_dequantize"):
            check(res["launches"][name] > 0, f"{who}: kernel {name} never launched")
        for name, c in res["launches"].items():
            launches[name] += c
    # the accounting: each gathered code byte, plus one f32 scale per tensor
    check(bits == payload + 32 * per_step, f"{label}: {payload} bits gathered")
    # the last step's: step 0 also connects gloo's pairs and warms up cuDNN
    r0 = ranks[0]
    coll_ms = 1e3 * (r0["collective_s"][-1] - r0["collective_s"][-2])
    share = coll_ms / r0["step_ms"][-1]
    print(
        f"{label}: {r0['comm']}; every rank's {len(gathered)} gathers byte for "
        f"byte, synced grads, losses and params equal to SimComm({N2_RANKS}) in "
        f"one process; {payload} bits gathered a step a worker + 32 x {per_step} "
        f"scale bits = {bits} (the accounting); ranks' launches {launches}"
    )
    print(
        f"  (n2) ms a step (rank 0, eager, host clock): {r0['step_ms']} (sync "
        f"{r0['sync_ms']}); the last step's collectives {coll_ms:.1f} ms of its "
        f"{r0['step_ms'][-1]:.1f} ({share:.1%}, host clock, gloo's host staging "
        f"included); SimComm({N2_RANKS}) in one process "
        f"{[round(st.step_ms, 1) for st in want.steps]} (sync "
        f"{[round(st.sync_ms, 1) for st in want.steps]}); {card}"
    )
    emit(
        {
            "dist": "n2_resnet18_gloo_4_ranks_one_card",
            "card": card,
            "bit_equal_to_simcomm": True,
            "wire_bits_per_step": bits,
            "gathered_bits_per_step": payload,
            "rank0_step_ms": r0["step_ms"],
            "rank0_sync_ms": r0["sync_ms"],
            "rank0_collective_s_at_step_end": r0["collective_s"],
            "collective_share": share,
            "simcomm_step_ms": [st.step_ms for st in want.steps],
            "launches": launches,
        }
    )
    return {name: launches[name] + counts[name] for name in launches}


def _n3_ckpt(out_dir):
    return Path(out_dir, "n3", "state.ckpt")


def _n3_rank(out_dir):
    """One rank's (n3) run in the torchrun of the 1x2 mesh (world 2) that
    phases (n3)-(r) share: ``launch.train`` at smoke widths, a checkpoint
    at step N3_CKPT to ``out_dir/n3/``."""
    from repro_torch.launch import train as launch_train

    ck = _n3_ckpt(out_dir)
    ck.parent.mkdir(exist_ok=True)
    launch_train.main(
        N3_ARGS
        + ["--device", "cuda:0", "--dist-backend", "gloo"]
        + ["--steps", str(N3_CKPT), "--ckpt-every", str(N3_CKPT)]
        + ["--ckpt-path", str(ck)]
    )


def _n3_checks(card, out_dir, spawn_out):
    """(n3): the ranks' checkpoint resumed in this process equals one run
    of N3_STEPS steps here."""
    import io

    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train

    label = (
        f"(n3) {LM_ARCH} smoke, launch.train over {N3_RANKS} gloo ranks on one "
        f"card, checkpoint at step {N3_CKPT} resumed in one process"
    )

    def here(argv):
        with contextlib.redirect_stdout(io.StringIO()):
            out = launch_train.main(N3_ARGS + ["--device", "cuda"] + argv)
        return [w.detach().cpu() for w in tree_leaves(out["state"]["params"])], out

    ck = str(_n3_ckpt(out_dir))
    check(f"world={N3_RANKS}" in spawn_out, f"{label}: no process group of {N3_RANKS}")
    ops.reset_launch_counts()
    resumed, r = here(["--steps", str(N3_STEPS), "--resume", "--ckpt-path", ck])
    whole, w = here(["--steps", str(N3_STEPS)])
    counts = ops.launch_counts()
    for a, b in zip(resumed, whole, strict=True):
        check(torch.equal(a, b), f"{label}: params differ from one {N3_STEPS}-step run")
    tail = [m["loss"] for m in w["history"][N3_CKPT:]]
    check([m["loss"] for m in r["history"]] == tail, f"{label}: losses differ")
    print(
        f"{label}: the {N3_RANKS} ranks' checkpoint (all 2 workers' rows, "
        f"written by rank 0) resumed here equals {N3_STEPS} steps at once bit "
        f"for bit (params, losses); {card}"
    )
    return counts


# Phase 14, the compressors that raised across ranks before slice 16 (o):
# each run through its launcher in ONE torchrun of 2 gloo ranks sharing
# the card, 2 workers a rank (k = 2, where (n2) has k = 1), with
# --deterministic --dump, then the same launcher and arguments in this
# process over SimComm(4), and the dumps compared. (o1) (f)'s QSGD b4;
# (o2) a per-leaf policy of (k2)'s knobs, dlog b4 at a budget of 16 on
# stage3 and lrq b4 with 2 layers on the rest, and the log b4 codec on fc,
# with a warm-up step and symmetric lazy groups at (i2)'s knobs (elide);
# (o3) (i3)'s server wire in gate mode; (o4) (k1)'s run, gemma3-1b at full
# width with dlog at a budget of 48 and Adam, its error feedback stored in
# bf16: the composite's sync is functional, so a rank holds the old and the
# new error feedback of its 2 workers, and two ranks of (k1)'s f32 state
# (38.5 GB a rank at the Adam update) do not fit one 80 GB card.
O_RANKS, O_WORKERS = 2, 4
O_LAZY = f"lazy_thresh={I2_THRESH}:max_stale={I2_MAX_STALE}"
O2_SPEC = ",".join(
    [
        f"stage3=lq_sgd:rank=1:bits=4:codec=dlog:dp_epsilon=16.0:{O_LAZY}",
        f"fc=lq_sgd:rank=1:bits=4:{O_LAZY}",
        f"*=lq_sgd:rank=1:bits=4:codec=lrq:{O_LAZY}",
    ]
)
O4_STEPS = 2
_O_RESNET = [
    "--workers", str(O_WORKERS), "--batch", str(TRAIN_BATCH), "--hw",
    str(TRAIN_HW), "--classes", str(TRAIN_CLASSES), "--lr", str(TRAIN_LR),
]  # fmt: skip
# run -> (launcher, its arguments, steps, the kernels each rank must launch)
O_RUNS = {
    "o1": (
        "train_resnet",
        _O_RESNET + ["--compressor", "qsgd", "--bits", "4", "--steps", "2"],
        2,
        ("pack_nibbles",),
    ),
    "o2": (
        "train_resnet",
        _O_RESNET
        + ["--policy", O2_SPEC, "--warmup", "1", "--lazy-thresh", str(I2_THRESH)]
        + ["--max-stale", str(I2_MAX_STALE), "--lazy-mode", "elide", "--steps", "4"],
        4,
        ("pack_nibbles", "log_quantize_pack", "log_dequantize"),
    ),
    "o3": (
        "train_resnet",
        _O_RESNET
        + ["--rank", "1", "--bits", "8", "--fuse", "--wire", "server"]
        + ["--participation", "0.5", "--lazy-thresh", "1.5", "--max-stale", "4"]
        + ["--lazy-mode", "gate", "--noniid-alpha", str(I3_ALPHA), "--steps", "4"],
        4,
        ("log_quantize", "log_dequantize"),
    ),
    "o4": (
        "train",
        ["--arch", LM_ARCH, "--mesh", f"{LM_MESH[0]}x1", "--batch", str(LM_BATCH)]
        + ["--seq", str(LM_SEQ), "--compressor", "lq_sgd", "--rank", "1"]
        + ["--bits", "8", "--dp-epsilon", str(K1_EPSILON), "--optimizer", "adam"]
        + ["--lr", str(J1_LR), "--runtime", "sync", "--log-every", "1"]
        + ["--comp-dtype", "bfloat16", "--steps", str(O4_STEPS)],
        O4_STEPS,
        ("log_dequantize",),
    ),
}
O_RANK_ARGS = ["--dist-backend", "gloo", "--device", "cuda:0", "--deterministic"]


def _launcher(name):
    from repro_torch.launch import train, train_resnet

    return {"train": train, "train_resnet": train_resnet}[name]


def _o_rank(out_dir):
    """One rank's (o) runs in the torchrun of the 1x2 mesh that phases (o),
    (p), (q) and (r) share (``tp_spawn_rank_main``): every run of
    ``O_RUNS`` through its launcher's ``main`` in this process group, each
    with the launch counts and the peak memory at 0 first, dumping to
    ``out_dir/o/<run>/``; rank 0 writes each run's seconds to
    ``out_dir/o/seconds.json``."""
    import torch.distributed as dist

    from repro_torch.kernels import ops

    seconds = {}
    for run, (name, argv, _, _) in O_RUNS.items():
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        dump = ["--dump", os.path.join(out_dir, "o", run)]
        _launcher(name).main(argv + O_RANK_ARGS + dump)
        seconds[run] = time.perf_counter() - t0
        _free_cuda()
    if dist.get_rank() == 0:
        Path(out_dir, "o", "seconds.json").write_text(json.dumps(seconds))


def _o_checks(card, out_dir):
    """(o) QSGD, the randomized codecs, a policy with schedules, lazy groups
    and the server wire across processes (the ranks' dumps under
    ``out_dir/o``), each equal to SimComm(4)."""
    seconds = json.loads(Path(out_dir, "o", "seconds.json").read_text())
    dumps = {
        run: [
            torch.load(Path(out_dir, "o", run, f"rank{r}.pt"), weights_only=False)
            for r in range(O_RANKS)
        ]
        for run in O_RUNS
    }
    by_run = {run: round(s, 1) for run, s in seconds.items()}
    print(
        f"(o) {O_RANKS} gloo ranks on one card x {O_WORKERS // O_RANKS} workers: "
        f"by run {by_run}; {card}"
    )
    total = {}
    for run in O_RUNS:
        counts = _dist_codecs_run(card, run, dumps.pop(run), seconds[run])
        for name, c in counts.items():
            total[name] = total.get(name, 0) + c
    return total


@contextlib.contextmanager
def _recorded_draws():
    """Within the block every randomized codec's draw (``core/codec.py:
    draw``) appends ``(kind, shape, high)`` to the yielded list: the shape
    of all N workers' values, which each rank draws."""
    from repro_torch.core import codec

    draws, draw = [], codec.draw

    def recorded(kind, x, key, high=0):
        n = key.n if isinstance(key, codec.WorkerRows) else x.shape[0]
        draws.append((kind, (n,) + tuple(x.shape[1:]), high))
        return draw(kind, x, key, high)

    codec.draw = recorded
    try:
        yield draws
    finally:
        codec.draw = draw


def _here(run):
    """``run``'s launcher and arguments in this process over SimComm(4),
    with its draws recorded and, for the LM step (eager: the composite),
    its syncs timed between CUDA events. Returns (its dump, the sync's ms
    by step or None, the draws, its launches)."""
    from repro_torch.core.composite import CompositeCompressor
    from repro_torch.kernels import ops

    name, argv, steps, _ = O_RUNS[run]
    syncs = []
    timed = (
        _CudaSpans(CompositeCompressor, "sync", syncs, lambda: len(syncs))
        if name == "train"
        else contextlib.nullcontext()
    )
    _free_cuda()
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        with timed, _recorded_draws() as draws:
            here = ["--device", "cuda", "--deterministic", "--dump", tmp]
            _launcher(name).main(argv + here)
        dump = torch.load(Path(tmp, "rank0.pt"), weights_only=False)
    counts = ops.launch_counts()
    _free_cuda()
    return dump, _span_ms(syncs, steps) if syncs else None, draws, counts


def _draws_ms(draws, steps, k):
    """The recorded draws replayed on the card (the default generator), in
    ms a step between CUDA events: whole, as each rank draws them (all N
    workers' values), and at a rank's k rows alone."""
    from repro_torch.core.codec import draw_values

    def replay(rows):
        for kind, shape, high in draws:
            shp = shape if rows is None else (rows,) + tuple(shape[1:])
            draw_values(kind, shp, None, "cuda", high)

    out = []
    for rows in (None, k):
        replay(rows)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        replay(rows)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / steps)
    return out


def _strip_wall(history):
    return [{k: v for k, v in m.items() if k != "wall_s"} for m in history]


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


# (o1): QSGD's bias and norm leaves psum in f32 in the ring's order, so
# step 0 holds as stated (every other leaf's bytes and synced grads equal,
# those within O1_PSUM_RTOL); from step 1 the two runs train from params
# that differ in those last bits, which a ResNet-18 step amplifies (on an
# H100 ~1e-3 of step 1's codes moved, some by 2 levels; PERF.md §6), so
# step 1 is held to its loss, taken before its sync, and its codes, synced
# grads and the final params are reported
O1_PSUM_RTOL, O1_LOSS_RTOL = 1e-6, 1e-6


def _o1_close(who, got, want):
    """(o1)'s step 0 (module comment); returns step 1's synced grads' and
    the final params' largest difference relative to their leaf's largest
    value."""
    from repro_torch.core.compressors import CompressorConfig, make_compressor
    from repro_torch.models.resnet import init_resnet18

    comp = make_compressor(
        CompressorConfig(name="qsgd", bits=4),
        init_resnet18(TRAIN_CLASSES, device="cpu"),
    )
    zipped = enumerate(zip(got["synced"][0], want["synced"][0], strict=True))
    for i, (g, w) in zipped:
        if comp.plans[i].route == "lowrank":
            check(torch.equal(g, w), f"{who}: step 0 leaf {i} synced differs")
        else:
            err = _rel(g, w)
            check(err <= O1_PSUM_RTOL, f"{who}: step 0 leaf {i} rel {err:.2e}")
    (l0, l1), (w0, w1) = got["losses"], want["losses"]
    check(l0 == w0, f"{who}: step-0 loss differs")
    check(abs(l1 - w1) <= O1_LOSS_RTOL * abs(w1), f"{who}: step-1 loss {l1} {w1}")
    synced1 = max(_rel(g, w) for g, w in zip(got["synced"][1], want["synced"][1]))
    params = max(_rel(p, w) for p, w in zip(got["params"], want["params"]))
    return synced1, params


def _code_moves(got, want):
    """Gathered b4 code arrays of two runs: (codes that differ, of them
    those that moved by more than one level, codes)."""
    moved = far = n = 0
    for g, w in zip(got, want, strict=True):
        d = (_wire_codes(g, 4) - _wire_codes(w, 4)).abs()
        moved += int((d > 0).sum())
        far += int((d > 1).sum())
        n += d.numel()
    return moved, far, n


def _resnet_equal(who, run, got, want, rank, k):
    """A rank's dump of train_resnet against this process's: accounting and
    lazy counters equal; synced grads, params and losses bit-equal ((o1):
    :func:`_o1_close`, which returns what it reports)."""
    check(got["bits"] == want["bits"], f"{who}: bits {got['bits']}")
    check(got["effective"] == want["effective"], f"{who}: effective bits differ")
    for t, (gs, ws) in enumerate(zip(got["stale"], want["stale"], strict=True)):
        for m, c in ws.items():
            mine = c[rank * k : (rank + 1) * k] if c.dim() else c
            check(torch.equal(gs[m], mine), f"{who}: step {t} lazy counter differs")
    if run == "o1":
        return _o1_close(who, got, want)
    for t, (gs, ws) in enumerate(zip(got["synced"], want["synced"], strict=True)):
        same = all(torch.equal(g, w) for g, w in zip(gs, ws, strict=True))
        check(same, f"{who}: step {t} synced grads differ")
    same = all(torch.equal(p, w) for p, w in zip(got["params"], want["params"]))
    check(same, f"{who}: final params differ")
    check(got["losses"] == want["losses"], f"{who}: losses differ")
    return None


def _fingerprints_equal(who, got, want, rank, k):
    """A rank's fingerprints of the compressor state against this
    process's: its rows of a per-worker leaf, the whole of a shared one."""
    check(got.keys() == want.keys(), f"{who}: compressor state leaves differ")
    for key, w in want.items():
        mine = w[rank * k : (rank + 1) * k] if isinstance(w, list) else w
        check(got[key] == mine, f"{who}: compressor state {key} differs")


def _dist_codecs_run(card, run, ranks, run_s):
    name, argv, steps, kernels = O_RUNS[run]
    k = O_WORKERS // O_RANKS
    label = f"({run}) {name} over {O_RANKS} gloo ranks x {k} workers"
    want, sync_ms, draws, launches = _here(run)
    draw_ms, draw_k_ms = _draws_ms(draws, steps, k)
    per_step = len(want["gathered"]) // steps
    # every gather equal; (o1)'s from step 0 only (O1_PSUM_RTOL's comment)
    n_exact = per_step if run == "o1" else len(want["gathered"])
    drift = moves = None
    for r, got in enumerate(ranks):
        who = f"{label}, rank {r}"
        for kname in kernels:
            check(got["launches"][kname] > 0, f"{who}: kernel {kname} never launched")
        for kname, c in got["launches"].items():
            launches[kname] += c
        check(len(got["gathered"]) == len(want["gathered"]), f"{who}: gathers")
        for j, (g, w) in enumerate(zip(got["gathered"][:n_exact], want["gathered"])):
            same = g.dtype == w.dtype and torch.equal(g, w)
            check(same, f"{who}: gather {j} differs")
        _fingerprints_equal(who, got["comp"], want["comp"], r, k)
        if name == "train":
            check(_strip_wall(got["history"]) == _strip_wall(want["history"]), who)
            check(got["params"] == want["params"], f"{who}: final params differ")
        else:
            drift = _resnet_equal(who, run, got, want, r, k)
        if run == "o1":
            moves = _code_moves(got["gathered"][n_exact:], want["gathered"][n_exact:])
    r0 = ranks[0]
    if name == "train":
        step_ms = [1e3 * s for s in r0["step_s"]]
        coll_ms = [1e3 * s for s in r0["collective_s"]]
        wire = [m["wire_mb_per_step"] for m in want["history"]]
        check(all(abs(w - J1_BITS / 8e6) <= 1e-6 for w in wire), f"{label}: {wire}")
        peaks = [round(d["peak_bytes"] / 1e9, 2) for d in ranks]
        history = _strip_wall(want["history"])
        extra = f"peak memory by rank {peaks} GB; history {history}"
    else:
        step_ms = r0["step_ms"]
        ends = [0.0] + r0["collective_s"]
        coll_ms = [1e3 * (b - a) for a, b in zip(ends, ends[1:])]
        fired = [c > 1 for _, c in want["effective"]]
        extra = f"losses {want['losses']}"
        if run == "o2":
            check(fired[0] and not all(fired), f"{label}: fire pattern {fired}")
            for (b, _), f_ in zip(want["effective"], fired):
                want_b = want["wire_bits_per_step"] if f_ else b
                check(b == want_b, f"{label}: a fired round sent {b} bits")
            extra += f"; fire pattern {''.join('F' if f_ else 's' for f_ in fired)}"
        if run == "o3":
            masks = [want["gathered"][t * per_step] for t in range(steps)]
            check(any(float(m.min()) == 0 for m in masks), f"{label}: no drop-out")
            extra += f"; participation {[m.int().tolist() for m in masks]}"
    # the sync: SimComm(4)'s between CUDA events (the LM step), else rank
    # 0's on the host clock (train_resnet's eager split; this process's
    # QSGD run replays a CUDA graph, which has no split)
    where = f"SimComm({O_WORKERS})'s" if sync_ms else "rank 0's"
    sync_ms = sync_ms or r0["sync_ms"]
    sync = _median(sync_ms[1:]) if steps > 1 else sync_ms[0]
    share = coll_ms[-1] / step_ms[-1]
    if run == "o1":
        equal = (
            f"step 0's {n_exact} gathers, the accounting and both losses "
            f"equal SimComm({O_WORKERS})'s on both ranks, step 0's synced "
            f"grads too (its bias and norm leaves within {O1_PSUM_RTOL:g}); "
            f"step 1 from params that differ in their last bits: {moves[0]} "
            f"of {moves[2]} codes moved ({moves[1]} by 2 or more levels), "
            f"synced grads rel {drift[0]:.3e}, final params rel {drift[1]:.3e}"
        )
    else:
        equal = (
            f"every gather ({len(want['gathered'])}), the accounting, the lazy "
            f"counters, synced grads, losses and params equal SimComm"
            f"({O_WORKERS})'s in this process bit for bit on both ranks"
        )
    print(
        f"{label}: {equal}; compressor state rows equal; launches "
        f"{ {n: c for n, c in launches.items() if c} }; {extra}"
    )
    print(
        f"  ({run}) {run_s:.1f} s in the shared spawn; rank 0 ms a "
        f"step {[round(v, 1) for v in step_ms]} (host clock), the last step's "
        f"collectives {coll_ms[-1]:.1f} ms ({share:.1%}, gloo's host staging "
        f"included); the draws {draw_ms:.3f} ms a step on each rank (all "
        f"{O_WORKERS} workers' values; {draw_k_ms:.3f} for its {k} rows alone) "
        f"against {where} sync {sync:.1f} ms ({draw_ms / sync:.2%}); {card}"
    )
    emit(
        {
            "dist_codecs": run,
            "card": card,
            "equal_to_simcomm": run != "o1",
            "step1_code_moves": moves,
            "step1_synced_and_param_rel": drift,
            "run_s": run_s,
            "rank0_step_ms": step_ms,
            "rank0_collective_ms": coll_ms,
            "collective_share": share,
            "draw_ms_per_step": draw_ms,
            "draw_ms_per_step_k_rows": draw_k_ms,
            "sync_ms": sync_ms,
            "sync_of": where,
            "peak_bytes_by_rank": [d.get("peak_bytes") for d in ranks],
            "launches": launches,
        }
    )
    return launches


# ------------------------------------------------ phase 15 (p): tensor parallel
# run -> (arch, mesh, cache bits): each one torchrun of data x model gloo
# ranks sharing the card, launch/serve.py at full width, batch 4, prompt
# 1024, 32 new tokens, against the one-process launcher in this process
P_RUNS = {
    "p1": ("gemma3-1b", "1x2", 8),  # the sequence-sharded cache
    "p2": ("gemma3-1b", "2x2", 4),  # the batch over data
    "p3": ("mistral-nemo-12b", "1x2", 8),  # the head-sharded cache
}
# cuts for time, made when phase 16 (q) came and halved with phase 19:
# gemma3-1b serves 1 of its 4 repeats of the scanned pattern (8 of 26
# layers), mistral-nemo-12b 5 of its 40 layers, 16 new tokens (at full
# depth the phase took twice as long as at 14 and 10 layers)
P_REPEATS = {"p1": 1, "p2": 1, "p3": 5}
P_GEN = 16
P_ARGS = ["--batch", str(BATCH), "--prompt-len", str(PROMPT), "--gen", str(P_GEN)]
P_RANK_ARGS = ["--dist-backend", "gloo", "--device", "cuda:0"]


def _p_argv(run):
    """``launch/serve.py``'s arguments of ``run`` (no mesh, no device)."""
    arch, _, bits = P_RUNS[run]
    cut = ["--repeats", str(P_REPEATS[run])] if run in P_REPEATS else []
    return ["--arch", arch, "--cache-bits", str(bits), *P_ARGS, *cut]


def _p_cfg(run):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(P_RUNS[run][0])
    if run in P_REPEATS:
        cfg = dataclasses.replace(cfg, repeats=P_REPEATS[run])
    return cfg
# Tensor-parallel vs one process, both bf16: a row-parallel product's ranks
# each round their partial to bf16 before the f32 sum, where one process
# rounds the whole sum once, so every layer's output moves by ~2^-8 and the
# difference is carried through the later layers. Prefill and
# teacher-forced decode logits are held to LOGITS_REL_TOL, as phase 4 holds
# the kernel path to reference mode; a free-running greedy token may then
# differ only where the one-process top-2 margin is below what that bound
# allows, P_TOKEN_MARGIN of the row's largest |logit| (twice the bound);
# the row is compared no further after its first such difference.
P_TOKEN_MARGIN = 2 * LOGITS_REL_TOL


def _p_world(mesh):
    data, model = (int(x) for x in mesh.split("x"))
    return data * model


def _p_teacher(cfg, params, prompt, bits, tokens, shard=None):
    """A fresh prefill of ``prompt``, then ``P_GEN`` decode steps fed
    ``tokens`` (B, P_GEN), eager: the logits of every step, (B, P_GEN, V),
    and
    the caches on the host (:func:`_p_cache`), which the one-process run
    and the ranks fill from the same tokens, so they compare even where
    the free-running tokens part."""
    from repro_torch.serving.engine import build_decode_step, build_prefill_step
    from repro_torch.serving.kv_cache import CacheQuantConfig

    qcfg = CacheQuantConfig(bits=bits)
    pre = build_prefill_step(cfg, PROMPT + P_GEN, qcfg=qcfg, shard=shard)
    dec = build_decode_step(cfg, shard)
    _, caches = pre(params, prompt)
    steps = [
        dec(params, caches, tokens[:, i : i + 1], PROMPT + i)[0]
        for i in range(P_GEN)
    ]
    return torch.cat(steps, dim=1), _p_cache(caches)


def _p_cache(caches):
    from repro_torch.serving.kv_cache import QuantKV, tree_leaves

    return [
        (path, leaf.codes.cpu(), leaf.scale.cpu())
        for path, leaf in tree_leaves(caches)
        if isinstance(leaf, QuantKV)
    ]


def _p_rank(out_dir, run):
    """One rank's (p) run in the shared torchrun (``tp_spawn_rank_main``):
    ``launch/serve.py``'s ``main`` over the mesh of ``run`` with the launch
    counts and the peak memory at 0 first, then the teacher-forced decode
    on the one-process tokens (``out_dir/<run>_tokens.pt``)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    _, mesh, bits = P_RUNS[run]
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out = serve.main(_p_argv(run) + ["--mesh", mesh] + P_RANK_ARGS)
    launches = ops.launch_counts()
    shard = out["shard"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows = shard.rows()
    tokens = torch.load(Path(out_dir, f"{run}_tokens.pt"))[rows].cuda()
    cfg = _p_cfg(run)
    teacher, caches = _p_teacher(cfg, out["params"], out["prompt"], bits, tokens, shard)
    res = dict(
        rows=(rows.start, rows.stop),
        sizes=shard.mesh.sizes,
        coords=shard.mesh.coords,
        cache_specs=shard.cache_specs,
        seq_shards=shard.seq_shards(),
        logits=out["logits"].cpu(),
        tokens=out["tokens"].cpu(),
        teacher=teacher.cpu(),
        caches=caches,
        bytes=out["bytes_per_token"],
        bytes_accounted=out["bytes_per_token_accounted"],
        prefill_s=out["prefill_s"],
        decode_s=out["decode_s"],
        collective_s=out["collective_s"],
        collectives=shard.axis.comm.stats(),
        seq_collectives=(
            shard.axis.seq.stats()["calls"]
            if shard.axis.seq is not shard.axis.comm
            else "the model group's"
        ),
        launches=launches,
        peak_gb=peak_gb,
    )
    del out
    return res


def _p_kernels(gen):
    """#1, #3, #4 and #6 at the ranks' shapes against their plain versions,
    with times (graph replays), bounds and SDPA's time for #6."""
    from repro_torch.core.codec import unpack_nibbles
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.log_dequant_rows import log_dequantize_rows_cuda
    from repro_torch.kernels.log_quant import (
        log_quantize_pack_triton,
        log_quantize_triton,
    )

    half = (PROMPT + P_GEN) // 2
    print("kernels at the tensor-parallel ranks' shapes")
    encodes = (
        ("log_quantize", 8, log_quantize_triton, ref.log_quantize_ref, (4,)),
        ("log_quantize_pack", 4, log_quantize_pack_triton, ref.log_quantize_pack_ref, (2,)),
    )  # fmt: skip
    for name, bits, kernel, plain, batches in encodes:
        for b in batches:
            for where, shape in (
                (f"p scan leaf b{b}", (P_REPEATS["p1"], b, 1, half, 256)),
                (f"p decode append b{b}", (b, 1, 1, 256)),
            ):
                xn, _ = _rows(gen, shape)
                n = xn.numel()
                got, want = kernel(xn, 1.0, bits=bits), plain(xn, 1.0, bits, 10.0)
                if bits <= 4:
                    got, want = unpack_nibbles(got, n), unpack_nibbles(want, n)
                _code_flips(
                    got.reshape(-1),
                    want.reshape(-1),
                    _near_half(xn, bits).reshape(-1),
                    f"{name} b={bits} {where} {shape}",
                )
                b_ms, b_by = bound_ms(n * 4 + n * bits // 8, n * QUANT_OPS, "f32")
                ms = cuda_ms(lambda: kernel(xn, 1.0, bits=bits), 50)
                pl = cuda_ms(lambda: plain(xn, 1.0, bits, 10.0), 20)
                print(f"    {ms:.5f} ms, bound {b_ms:.5f} ({b_by}), plain {pl:.5f}")
                emit({"kernel": name, "tp": where, "shape": list(shape), "ms": ms,
                      "bound_ms": b_ms, "plain_ms": pl})  # fmt: skip
    # #4 over a rank's K or V of one layer: (p1) 4 x 528 rows of 256 B,
    # (p2) 2 x 528 of 128 B (q4), (p3) 4 x 4 heads x 1056 of 128 B
    for where, rows, d, bits in (
        ("p1", 4 * half, 256, 8),
        ("p2", 2 * half, 256, 4),
        ("p3", 4 * 4 * (PROMPT + P_GEN), 128, 8),
    ):
        nb = d * bits // 8
        c = torch.randint(-128, 128, (rows, nb), generator=gen, device="cuda")
        c = c.to(torch.int8)
        sc = torch.rand((rows, 1), generator=gen, device="cuda")
        got = log_dequantize_rows_cuda(c, sc, bits=bits)
        want = ref.log_dequantize_rows_ref(c, sc, bits, 10.0)
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).masked_fill(
            want == 0, 0
        )
        check(float(rel.max()) <= 1e-6, f"dequant {where}: rel {float(rel.max())}")
        b_ms, b_by = bound_ms(rows * (nb + 4 + d * 4), rows * d * DEQUANT_OPS, "f32")
        ms = cuda_ms(lambda: log_dequantize_rows_cuda(c, sc, bits=bits), 50)
        pl = cuda_ms(lambda: ref.log_dequantize_rows_ref(c, sc, bits, 10.0), 20)
        print(
            f"  log_dequantize_rows {where} ({rows} rows of {nb} B): max rel "
            f"{float(rel.max()):.2e}; {ms:.5f} ms, bound {b_ms:.5f} ({b_by}), "
            f"plain {pl:.5f}"
        )
        emit({"kernel": "log_dequantize_rows", "tp": where, "rows": rows, "ms": ms,
              "bound_ms": b_ms, "plain_ms": pl})  # fmt: skip
    # #6 on a rank's heads: (p1) 2 of gemma3-1b's 4 Q heads over its 1 KV
    # head, window None and 512; (p2) the same at 2 rows; (p3) 16 of
    # mistral-nemo-12b's 32 over 4 of its 8 KV heads
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for where, b, hq, hkv, hd, window in (
        ("p1", 4, 2, 1, 256, None),
        ("p1 window", 4, 2, 1, 256, 512),
        ("p2", 2, 2, 1, 256, None),
        ("p3", 4, 16, 4, 128, None),
    ):
        q, k, v = (
            torch.randn((b, h, PROMPT, hd), generator=gen, device="cuda").bfloat16()
            for h in (hq, hkv, hkv)
        )
        got = flash_attention_cuda(q, k, v, window=window)
        want = ref.attention_ref(q.float(), k.float(), v.float(), window=window)
        e = float((got.float() - want).abs().max())
        check(e <= 2e-2, f"flash_attention {where}: max err {e}")
        i = torch.arange(PROMPT, device="cuda")
        mask = i[None, :] <= i[:, None]
        if window is not None:
            mask &= i[None, :] > i[:, None] - window
        pairs = int(mask.sum()) * b * hq
        n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        b_ms, b_by = bound_ms(n_bytes, 4 * hd * pairs, "bf16")
        ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, window=window), 10)
        pl = cuda_ms(lambda: ref.attention_ref(q, k, v, window=window), 5)
        lib = cuda_ms(
            lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True), 10
        )
        print(
            f"  flash_attention {where} q {list(q.shape)} k/v {list(k.shape)}: max "
            f"abs err {e:.2e}; {ms:.4f} ms, bound {b_ms:.4f} ({b_by}), plain "
            f"{pl:.4f}, SDPA {lib:.4f}"
        )
        emit({"kernel": "flash_attention", "tp": where, "shape": list(q.shape),
              "ms": ms, "bound_ms": b_ms, "plain_ms": pl, "library_ms": lib})  # fmt: skip
        del q, k, v, want, got


def _p_one_process(run, out_dir):
    """``run``'s launcher in this process (graphed decode), then the
    teacher-forced decode on its own tokens: everything on the host, the
    tokens written to ``out_dir/<run>_tokens.pt`` for the ranks."""
    from repro_torch.launch import serve

    bits = P_RUNS[run][2]
    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    out = serve.main(_p_argv(run) + ["--device", "cuda"])
    cfg = _p_cfg(run)
    teacher, caches = _p_teacher(
        cfg, out["params"], out["prompt"], bits, out["tokens"]
    )
    one = dict(
        logits=out["logits"].cpu(),
        tokens=out["tokens"].cpu(),
        teacher=teacher.cpu(),
        caches=caches,
        bytes=out["bytes_per_token"],
        bytes_accounted=out["bytes_per_token_accounted"],
        prefill_s=out["prefill_s"],
        decode_s=out["decode_s"],
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    torch.save(one["tokens"], Path(out_dir, f"{run}_tokens.pt"))
    del out, teacher
    _free_cuda()
    return one


def _p_logits(label, got, want):
    """``got`` within LOGITS_REL_TOL of the largest |logit| of ``want``,
    and the same argmax in every row whose margin exceeds twice the row's
    difference; returns the relative difference."""
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{label}: non-finite logits")
    diff = (g - w).abs()
    rel = float(diff.max()) / float(w.abs().max())
    check(rel <= LOGITS_REL_TOL, f"{label}: logits vs one process rel {rel:.3e}")
    top2 = w.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * diff.amax(-1)
    agree = g.argmax(-1) == w.argmax(-1)
    check(bool((agree | ~decided).all()), f"{label}: argmax differs past its margin")
    return rel, int(agree.sum()), agree.numel()


def _p_tokens(label, got, want, prefill, teacher):
    """Free-running greedy tokens: equal, but a row may differ where the
    one-process top-2 margin (of its prefill logits for token 0, of its
    teacher-forced logits for the rest: the logits that chose ``want``) is
    below P_TOKEN_MARGIN of the row's largest |logit|; such a row is
    compared no further. Returns the differences (row, step, margin)."""
    w = torch.cat([prefill, teacher[:, : want.shape[1] - 1]], dim=1).float()
    top2 = w.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]) / w.abs().amax(-1)
    found = []
    for r in range(want.shape[0]):
        for i in range(want.shape[1]):
            if int(got[r, i]) != int(want[r, i]):
                m = float(margin[r, i])
                check(m < P_TOKEN_MARGIN, f"{label}: row {r} step {i} at margin {m}")
                found.append((r, i, m))
                break
    return found


def _p_caches(who, res, one, bits):
    """A rank's teacher-forced cache shard against the block its spec cuts
    from the one-process run's (both fed the same tokens). Deep layers
    drift: a bf16 model at seeded init carries a last-bit difference of
    one layer's sum through every later layer, as the kernel path against
    reference mode does (~2% of the logits at 26 layers, phase 4), and a
    log-quant code near 0 is ~500 steps per unit of the row's scale, so a
    small value moves by several codes. So: the first layer's codes, whose
    inputs differ by the embedding's exact sum at most, equal but for
    one-step flips; every layer's dequantized values within LOGITS_REL_TOL
    of its largest |value|, as the logits, plus one code step there (the
    two runs' values may round to neighbouring codes: (1 + alpha)^(1/L) - 1
    of a value, L = 2^(b-1) - 1 levels; 1.9% at b = 8, 41% at b = 4).
    Prints each layer's share of codes moved. Returns (codes moved by one,
    by two or more)."""
    from repro_torch.core.codec import unpack_nibbles
    from repro_torch.launch.sharding import cut
    from repro_torch.serving.kv_cache import QuantKV, dequantize_kv, tree_leaves

    specs = {path: s for path, s in tree_leaves(res["cache_specs"])}
    # the model's first layer (a quantized cache only where it attends:
    # jamba-v0.1-52b's first layer is a Mamba-2 one, its state raw)
    first = ("lead", 0) if res["cache_specs"]["lead"] else ("scan", 0)
    flips = moved2 = 0
    shares, worst = [], 0.0
    bound = LOGITS_REL_TOL + (1 + ALPHA) ** (1 / ((1 << (bits - 1)) - 1)) - 1
    for (path, codes, scale), (p2, w_codes, w_scale) in zip(
        res["caches"], one["caches"], strict=True
    ):
        check(path == p2, f"{who}: cache leaves {path} / {p2}")
        spec = specs[path]
        w_codes = cut(w_codes, spec, res["sizes"], res["coords"])
        w_scale = cut(w_scale, spec, res["sizes"], res["coords"])
        check(codes.shape == w_codes.shape, f"{who}: cache shape at {path}")
        stacked = path[0] == "scan"
        for r in range(codes.shape[0] if stacked else 1):
            pick = (lambda t: t[r]) if stacked else (lambda t: t)
            a, b = pick(codes), pick(w_codes)
            d = a.shape[-1] * (2 if bits <= 4 else 1)
            deq = [
                dequantize_kv(QuantKV(c.cuda(), sc.cuda(), bits, ALPHA, d))
                for c, sc in ((a, pick(scale)), (b, pick(w_scale)))
            ]
            rel = float((deq[0] - deq[1]).abs().max() / deq[1].abs().max())
            worst = max(worst, rel)
            check(rel <= bound, f"{who}: cache {path}[{r}] values rel {rel}")
            if bits <= 4:
                a, b = unpack_nibbles(a, d), unpack_nibbles(b, d)
            diff = (a.int() - b.int()).abs()
            one_step, more = int((diff == 1).sum()), int((diff > 1).sum())
            if path[:2] == first and r == 0:
                check(more == 0, f"{who}: the first layer's {path} moved {more} by 2+")
            flips, moved2 = flips + one_step, moved2 + more
            where = "/".join(str(x) for x in path) + (f"[{r}]" if stacked else "")
            shares.append(f"{where} {(one_step + more) / diff.numel():.3f}")
    print(
        f"  {who}: teacher-forced caches: dequantized values rel <= {worst:.3e} "
        f"(bound {bound:.3e}); "
        f"share of codes moved by leaf {' '.join(shares)}"
    )
    return flips, moved2


def _p_run(card, run, one, ranks, one_s):
    """(p)'s checks of ``run``: its ranks (from the shared torchrun)
    against the one-process run ``one``."""
    arch, mesh, bits = P_RUNS[run]
    label = f"({run}) {arch} {mesh} q{bits}"
    print(
        f"{label}: one process {one_s:.1f} s (prefill {one['prefill_s'] * 1e3:.1f} "
        f"ms, decode {one['decode_s'] * 1e3 / (P_GEN - 1):.2f} ms/token graphed, "
        f"peak {one['peak_gb']:.2f} GB); the ranks' run "
        f"{max(r['run_s'] for r in ranks):.1f} s"
    )
    flips_total, moved_total, diffs = 0, 0, []
    for res in ranks:
        r = res["coords"]
        rows = slice(*res["rows"])
        who = f"{label} rank (d{r['data']}, m{r['model']})"
        rel, agree, n = _p_logits(f"{who} prefill", res["logits"], one["logits"][rows])
        t_rel = max(
            _p_logits(f"{who} teacher step {i}", res["teacher"][:, i],
                      one["teacher"][rows, i])[0]
            for i in range(P_GEN)
        )  # fmt: skip
        diffs += [
            (r, *d)
            for d in _p_tokens(
                who,
                res["tokens"],
                one["tokens"][rows],
                one["logits"][rows],
                one["teacher"][rows],
            )
        ]
        flips, moved2 = _p_caches(who, res, one, bits)
        flips_total += flips
        moved_total += moved2
        total_s = res["prefill_s"] + res["decode_s"]
        print(
            f"  {who}: prefill logits rel {rel:.3e} (argmax {agree}/{n}), teacher-"
            f"forced {P_GEN} steps rel <= {t_rel:.3e}, cache codes {flips} one-step "
            f"flip(s) and {moved2} by 2+; prefill {res['prefill_s'] * 1e3:.1f} ms, decode "
            f"{res['decode_s'] * 1e3 / (P_GEN - 1):.2f} ms/token eager, collectives "
            f"{res['collective_s']:.3f} s = {res['collective_s'] / total_s:.1%} "
            f"(host clock), peak {res['peak_gb']:.2f} GB; {card}"
        )
        calls = res["collectives"]["calls"]
        print(
            f"    collectives by tag: model group {calls}, sequence group "
            f"{res['seq_collectives']}"
        )
    for key in ("bytes", "bytes_accounted"):
        total = sum(res[key] for res in ranks)
        check(
            abs(total - one[key]) <= 1e-9 * one[key],
            f"{label}: summed {key} {total} vs one process {one[key]}",
        )
    print(
        f"  {label}: bytes/token summed over ranks {sum(r['bytes'] for r in ranks)} "
        f"= one process {one['bytes']}; cache codes moved by one {flips_total}, "
        f"by 2+ {moved_total}; greedy "
        f"differences (rank, row, step, one-process margin) {diffs}"
    )
    emit({"phase": "p", "run": run, "card": card, "cache_flips": flips_total,
          "cache_moved_2": moved_total,
          "token_differences": diffs, "one_s": one_s,
          "ranks": [{k: res[k] for k in ("coords", "prefill_s", "decode_s",
                     "collective_s", "peak_gb", "bytes")} for res in ranks]})  # fmt: skip
    counts = {}
    for res in ranks:
        for name, c in res["launches"].items():
            counts[name] = counts.get(name, 0) + c
    encode = "log_quantize" if bits == 8 else "log_quantize_pack"
    for name in (encode, "log_dequantize_rows", "flash_attention"):
        for res in ranks:
            check(res["launches"].get(name, 0) > 0, f"{label}: {name} not launched")
    print(f"  {label}: the ranks' launches {counts}")
    return counts


# ------------------------------------------ phase 16 (q): tensor-parallel training
# run -> (arch, mesh, arguments): each one torchrun of data x model gloo ranks
# sharing the card through launch/train.py (one worker a rank), against the
# one-process launcher (--mesh Dx1, graphed) on the same seeded weights and
# batches. (q1): gemma3-1b whole, (j1)'s global batch of 8 x 512 over a
# 2x2 mesh (2 workers x 4 rows), LQ-SGD r1 b8, Adam; (q2): mistral-nemo-12b
# at full width cut to Q2_REPEATS of its 40 layers (so that the one-process
# run, whose error feedback and gradients are whole, fits the card), 1x2,
# 1 worker x 2 x 512, LQ-SGD r1 b4, SGD.
Q_STEPS = 3
Q2_REPEATS = 2
Q_RUNS = {
    "q1": ("gemma3-1b", "2x2", [
        "--batch", "8", "--seq", "512", "--compressor", "lq_sgd", "--rank", "1",
        "--bits", "8", "--optimizer", "adam", "--lr", "1e-3",
    ]),
    "q2": ("mistral-nemo-12b", "1x2", [
        "--repeats", str(Q2_REPEATS), "--batch", "2", "--seq", "512",
        "--compressor", "lq_sgd", "--rank", "1", "--bits", "4", "--optimizer",
        "sgd", "--lr", "0.05",
    ]),
}  # fmt: skip
Q_COMMON = ["--steps", str(Q_STEPS), "--log-every", "1", "--runtime", "sync"]
Q_COMMON += ["--dump-steps"]
Q_RANK_ARGS = ["--dist-backend", "gloo", "--device", "cuda:0"]
# The checks, both runs bf16 at full width. A row-parallel product's ranks
# round their partials to bf16 before the f32 sum where one process rounds
# once, and so does a split branch's input gradient: the difference is
# carried through the layers (~2% of the logits over 26-40 layers, phase
# 15). The loss is a mean over every token: within Q_LOSS_REL of the
# one-process run's at every step. Step 0's synced gradient, leaf by leaf:
# |diff| within Q_SYNC_SHARE of the one-process leaf's largest value (phase
# 15's bound for bf16 logits), plus, for an element made of wire codes that
# moved by k steps in all (its P and Q codes, rank 1), what k of a code's
# largest steps move it: (1 + d)^k - 1 of the leaf's largest value, d =
# ((1 + alpha) - (1 + alpha)^((L - 1) / L)) / alpha the top step of the
# factor's largest value (L levels: 2.05% at b8, 31.9% at b4; the drift puts
# some codes across a bin edge); such elements are counted, and the codes
# moved reported per phase.
# Replicated leaves: the same bits on every rank after
# every step. The accounted bits: the JAX package's figure (J1_BITS for
# (q1)); the physical bits of a data row's model ranks: the accounting plus
# (M - 1) x the bits replicated over the model axis; the data-axis
# collectives of every rank: the plan's (Q1_COLLECTIVES: gemma3-1b's LQ-SGD
# r1 b8 plan, as (j1) counts it; 166 is ResNet-18's).
Q_LOSS_REL = 1e-2
Q_SYNC_SHARE = 5e-2
Q1_COLLECTIVES = 294


def _q_world(mesh):
    data, model = (int(x) for x in mesh.split("x"))
    return data, model


def _q_rank(out_dir, run):
    """One rank's (q) or (s) run in the shared torchrun
    (``tp_spawn_rank_main``): ``launch/train.py``'s ``main`` over the mesh
    of ``run`` with the launch counts and the peak memory at 0 first,
    dumping to ``out_dir/<run>_ranks/rank<r>.pt`` (an MoE model's routing
    of step 0's forward to ``routing<r>.pt`` beside); then a graphed step
    under gloo, which must be refused (its message to ``refusal<r>.txt``
    beside)."""
    from repro_torch.configs import get_config
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.train.optimizer import sgd
    from repro_torch.train.step import build_train_step, make_model_compressor

    arch, mesh, argv = TRAIN_RUNS[run]
    dump = Path(out_dir, f"{run}_ranks")
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with _s_routing(run, dump) as keep:
        out = train.main(
            ["--arch", arch, *argv, *Q_COMMON, "--mesh", mesh, *Q_RANK_ARGS]
            + ["--dump", str(dump)]
        )
        keep(f"routing{out['mesh'].rank}.pt")
    rank = out["mesh"].rank
    cfg = get_config("gemma3-1b", smoke=True)
    comp = make_model_compressor(cfg, CompressorConfig(name="lq_sgd"))
    step = build_train_step(
        cfg, out["mesh"].shape, comp, sgd(0.05), comm=out["comm"],
        tp=out["tp"], graph=True,
    )  # fmt: skip
    try:
        step(out["state"], {})
        refusal = "none"
    except NotImplementedError as e:
        refusal = str(e)
    Path(dump, f"refusal{rank}.txt").write_text(refusal)
    del out, step


def _q_plan(run):
    """(cfg, the compressor) of ``run``, on abstract shapes."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.train.step import make_model_compressor

    arch, _, argv = TRAIN_RUNS[run]
    cfg = get_config(arch, smoke="--smoke" in argv)
    if "--repeats" in argv:
        cfg = dataclasses.replace(cfg, repeats=int(argv[argv.index("--repeats") + 1]))
    if "--keep-pattern" in argv:
        keep = [int(i) for i in argv[argv.index("--keep-pattern") + 1].split(",") if i]
        cfg = dataclasses.replace(cfg, pattern=tuple(cfg.pattern[i] for i in keep))
    bits = int(argv[argv.index("--bits") + 1])
    ccfg = CompressorConfig(name="lq_sgd", rank=1, bits=bits)
    comp = make_model_compressor(cfg, ccfg)
    return cfg, comp, bits


def _q_layout(comp, dims):
    """For each data-axis gather of one LQ-SGD step, in the sync's order
    (the raw leaves, then every low-rank leaf's P, then its Q): (phase,
    leaf index, the factor's per-worker shape, the dim of it a rank holds
    a block of, or None, and that dim's unflattened sizes with the index
    of the one the model axis cuts: a P's rows are the leaf's dims but its
    last, so a rank's rows of a (cb, V, d) leaf split on V are a block of
    every codebook's)."""
    out = []
    for i, pl in enumerate(comp.plans):
        if pl.route != "lowrank":
            d = dims[i]
            rows = None if d is None else ((pl.shape[d],), 0)
            out.append(("raw", i, pl.shape, d, rows))
    lowrank = [(i, pl) for i, pl in enumerate(comp.plans) if pl.route == "lowrank"]
    for phase in ("P", "Q"):
        for i, pl in lowrank:
            n, m = pl.mat_shape
            lead = (pl.shape[0],) if pl.stacked else ()
            shape = lead + ((n if phase == "P" else m), pl.eff_rank)
            d = dims[i]
            kind = None if d is None else ("col" if d == len(pl.shape) - 1 else "row")
            if phase == "P" and kind == "row":
                rows = (pl.shape[len(lead) : -1], d - len(lead))
                out.append((phase, i, shape, len(shape) - 2, rows))
            elif phase == "Q" and kind == "col":
                out.append((phase, i, shape, len(shape) - 2, ((m,), 0)))
            else:
                out.append((phase, i, shape, None, None))
    return out


def _q_factor_block(w, dim, rows, coords, sizes):
    """The rank's block of a gathered (N, ...) factor ``w`` whose per-worker
    ``dim`` flattens the sizes ``rows[0]``, of which the model axis cuts
    the one at ``rows[1]`` (:func:`_q_layout`)."""
    dims, cut = rows
    shape = w.shape[: dim + 1] + tuple(dims) + w.shape[dim + 2 :]
    block = _q_block(w.reshape(shape), dim + 1 + cut, coords, sizes)
    return block.reshape(w.shape[: dim + 1] + (-1,) + w.shape[dim + 2 :])


def _q_steps(block, stacked, moved):
    """How many code steps moved in the codes each element of a synced leaf
    block (``block``'s shape) is made of: a raw leaf's own code; for a
    low-rank leaf (rank 1: each entry of P Q^T is one P code times one Q
    code) its row's P code plus its column's Q code; the most any worker's
    moved."""
    if "raw" in moved:
        return moved["raw"].reshape(block.shape)
    lead = block.shape[:1] if stacked else ()
    rows = moved["P"].amax(-1)  # (L?, n_b)
    cols = moved["Q"].amax(-1)  # (L?, m_b)
    steps = rows.reshape(lead + (-1, 1)) + cols.reshape(lead + (1, -1))
    return steps.reshape(block.shape)


def _q_codes(arr, shape, bits):
    from repro_torch.core.codec import unpack_nibbles

    numel = int(np.prod(shape))
    if bits <= 4:
        arr = unpack_nibbles(arr, 2 * arr.shape[-1])[:, :numel]
    return arr.reshape((arr.shape[0],) + tuple(shape))


def _q_block(x, dim, coords, sizes):
    if dim is None:
        return x
    n = x.shape[dim] // sizes["model"]
    return x.narrow(dim, coords["model"] * n, n)


def _q_kernels(gen):
    """#1 (b8), #3 (b4) and #5 at the ranks' factor shapes of (q1) / (q2)
    over a model axis of 2 against their plain versions, with times (CUDA
    events), bounds and the plain versions' times."""
    _train_kernels(gen, ("q1", "q2"))


def _s_kernels(gen):
    """:func:`_q_kernels` at (s1)-(s5)'s ranks' factor shapes."""
    _train_kernels(gen, tuple(S_RUNS))


def _train_kernels(gen, runs):
    """#1 (b8) or #3 (b4), and #5, at the largest factor block and the
    largest whole factor a rank of each of ``runs`` encodes over a model
    axis of 2, against their plain versions."""
    from repro_torch.core.compressors import model_split
    from repro_torch.kernels import ref
    from repro_torch.kernels.log_quant import (
        log_dequantize_triton,
        log_quantize_pack_triton,
        log_quantize_triton,
    )
    from repro_torch.core.codec import unpack_nibbles
    from repro_torch.train.step import train_param_specs

    class _Two:  # a model axis of 2, rank 0: shapes only
        size, rank = 2, 0

    print(f"kernels at the tensor-parallel training ranks' factor shapes {runs}")
    for run in runs:
        cfg, comp, bits = _q_plan(run)
        kernel, plain, name = (
            (log_quantize_triton, ref.log_quantize_ref, "log_quantize")
            if bits == 8
            else (log_quantize_pack_triton, ref.log_quantize_pack_ref,
                  "log_quantize_pack")
        )  # fmt: skip
        dims = model_split(_Two(), train_param_specs(cfg, 2)).dims
        layout = _q_layout(comp, dims)
        # the largest block and the largest whole factor a rank encodes
        blocks = {}
        for phase, _, shape, dim, _ in layout:
            shp = list(shape)
            if dim is not None:
                shp[dim] //= 2
            key = "block" if dim is not None else "whole"
            biggest = int(np.prod(blocks.get(key, [0])))
            if phase != "raw" and int(np.prod(shp)) > biggest:
                blocks[key] = [1] + shp
        for key, shape in blocks.items():
            x = torch.randn(shape, generator=gen, device="cuda")
            xn = x / x.abs().amax()
            n = xn.numel()
            got, want = kernel(xn, 1.0, bits=bits), plain(xn, 1.0, bits, 10.0)
            if bits <= 4:
                got, want = unpack_nibbles(got, n), unpack_nibbles(want, n)
            _code_flips(
                got.reshape(-1), want.reshape(-1), _near_half(xn, bits).reshape(-1),
                f"{name} b={bits} ({run}) {key} factor {shape}",
            )  # fmt: skip
            b_ms, b_by = bound_ms(n * 4 + n * bits // 8, n * QUANT_OPS, "f32")
            ms = cuda_ms(lambda: kernel(xn, 1.0, bits=bits), 50)
            pl = cuda_ms(lambda: plain(xn, 1.0, bits, 10.0), 20)
            print(f"    {ms:.5f} ms, bound {b_ms:.5f} ({b_by}), plain {pl:.5f}")
            emit({"kernel": name, "tp_train": f"{run} {key}", "shape": shape,
                  "ms": ms, "bound_ms": b_ms, "plain_ms": pl})  # fmt: skip
            # #5 on the mean of two workers' codes of the same shape
            c = torch.stack([want.reshape(-1).float(), want.reshape(-1).float()])
            mean = c.mean(0).reshape(shape)
            d_got = log_dequantize_triton(mean, 1.0, bits=bits)
            d_want = ref.log_dequantize_ref(mean, 1.0, bits, 10.0)
            e = float((d_got - d_want).abs().max())
            check(e <= 1e-6, f"log_dequantize ({run}) {key} {shape}: max err {e}")
            b_ms, b_by = bound_ms(n * 8, n * DEQUANT_OPS, "f32")
            ms = cuda_ms(lambda: log_dequantize_triton(mean, 1.0, bits=bits), 50)
            pl = cuda_ms(lambda: ref.log_dequantize_ref(mean, 1.0, bits, 10.0), 20)
            print(
                f"  log_dequantize b={bits} ({run}) {key} mean codes {shape}: max "
                f"abs err {e:.2e}; {ms:.5f} ms, bound {b_ms:.5f} ({b_by}), plain "
                f"{pl:.5f}"
            )
            emit({"kernel": "log_dequantize", "tp_train": f"{run} {key}",
                  "shape": shape, "ms": ms, "bound_ms": b_ms, "plain_ms": pl})  # fmt: skip


def _q_one_process(run, out_dir):
    """``run``'s launcher in this process (graphed steps), its dump read
    back; the device freed after, the cuBLAS workspaces of the streams its
    warm-up and capture used included: each is an allocation of the
    caching allocator kept for its stream, which would pin the whole
    segment it lies in, and (k1) later needs all but ~3 GB of the card."""
    from repro_torch.launch import train

    arch, mesh, argv = TRAIN_RUNS[run]
    data, _ = _q_world(mesh)
    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    with _s_routing(run, out_dir) as keep:
        train.main(
            ["--arch", arch, *argv, *Q_COMMON, "--mesh", f"{data}x1"]
            + ["--device", "cuda", "--dump", str(out_dir)]
        )
        keep("routing.pt")
    torch._C._cuda_clearCublasWorkspaces()
    _free_cuda()
    return torch.load(Path(out_dir, "rank0.pt"), weights_only=False)


def _q_run(card, run, one, rank_dir, one_s):
    """(q)'s checks of ``run``: its ranks' dumps in ``rank_dir`` (from the
    shared torchrun) against the one-process run ``one``."""
    from repro_torch.core.tree import flatten_with_paths
    from repro_torch.launch.train import sample_stride

    arch, mesh, argv = TRAIN_RUNS[run]
    data, model = _q_world(mesh)
    world = data * model
    cfg, comp, bits = _q_plan(run)
    label = f"({run}) {arch} {mesh} LQ-SGD r1 b{bits}"
    ranks = [
        torch.load(Path(rank_dir, f"rank{r}.pt"), weights_only=False)
        for r in range(world)
    ]
    refusals = [Path(rank_dir, f"refusal{r}.txt").read_text() for r in range(world)]
    n_params = sum(int(np.prod(pl.shape)) for pl in comp.plans)
    one_ms = 1e3 * one["step_s"][-1]  # step 0 eager, step 1 the capture
    print(
        f"{label}: {n_params / 1e9:.3f} B parameters, {len(cfg.layers)} "
        f"layers; one process {one_s:.1f} s ({one_ms:.1f} ms its last step, "
        f"a replay where the step is graphed, peak "
        f"{one['peak_bytes'] / 1e9:.2f} GB)"
    )
    one_loss = [h["loss"] for h in one["history"]]
    one_synced = dict(flatten_with_paths(one["synced0"]))
    layout = _q_layout(comp, ranks[0]["dims"])
    n_layout = len(layout)
    levels = (1 << (bits - 1)) - 1
    # a code's largest step (its top one), of the factor's largest value
    step = ((1 + ALPHA) - (1 + ALPHA) ** ((levels - 1) / levels)) / ALPHA
    check(one["recs"][0][0] == comp.wire_bits_per_step(), f"{label}: one-process bits")
    if run == "q1":
        bits0 = one["recs"][0][0]
        check(bits0 == J1_BITS, f"{label}: {bits0} != {J1_BITS}")
        check(one["recs"][0][2] == Q1_COLLECTIVES, f"{label}: one-process collectives")
    if run in S_BITS:
        bits0 = one["recs"][0][0]
        check(bits0 == S_BITS[run], f"{label}: {bits0} != {S_BITS[run]}")
    rows, moved = {}, {}
    for r, res in enumerate(ranks):
        coords, sizes = _q_coords(r, data, model)
        who = f"{label} rank (d{coords['data']}, m{coords['model']})"
        loss = [h["loss"] for h in res["history"]]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(loss, one_loss))
        check(
            loss_rel <= Q_LOSS_REL,
            f"{who}: loss rel {loss_rel:.3e} {loss} vs {one_loss}",
        )
        for s, (bits_s, phys, colls) in enumerate(res["recs"]):
            bits_1, _, colls_1 = one["recs"][s]
            check(bits_s == bits_1, f"{who}: step {s} accounted bits {bits_s}")
            check(colls == colls_1, f"{who}: step {s} data-axis collectives {colls}")
            row = rows.setdefault((coords["data"], s), [])
            row.append((phys, res["replicated_bits"]))
        # step 0's wire against the block of the one-process wire
        moved_at = {}  # leaf index -> phase -> where a worker's code moved
        for j in range(n_layout):
            phase, i, shape, dim, flat = layout[j]
            w = _q_codes(one["gathered"][j], shape, bits)
            bshape = list(shape)
            if dim is not None:
                bshape[dim] //= model
                w = _q_factor_block(w, dim, flat, coords, sizes)
            g = _q_codes(res["gathered"][j], bshape, bits)
            diff = (g.int() - w.int()).abs()
            m = moved.setdefault(phase, [0, 0, 0])
            m[0] += int((diff == 1).sum())
            m[1] += int((diff > 1).sum())
            m[2] += diff.numel()
            moved_at.setdefault(i, {})[phase] = diff.amax(0)
        # step 0's synced gradient: each element within Q_SYNC_SHARE of the
        # leaf's largest value, plus, where the codes it is made of moved by
        # k steps in all, the k steps' move of itself (on the card: a
        # billion elements a rank)
        worst, touched_n, total_n, named = (0.0, ""), 0, 0, {}
        synced = flatten_with_paths(res["synced0"])
        tops = one.get("synced0_max")  # a sample's leaves: the whole leaf's
        for i, ((path, g), dim) in enumerate(zip(synced, res["dims"])):
            w = _q_block(one_synced[path], dim, coords, sizes).cuda().float()
            g = g.cuda()
            diff = (g.float() - w).abs()
            top = max(float(w.abs().max()) if tops is None else tops[i], 1e-30)
            share = diff / top
            if i in moved_at:
                at = {ph: m.cuda() for ph, m in moved_at[i].items()}
                stride = 1
                if "--dump-sample" in argv:  # the block's whole last dim
                    stride = sample_stride(comp.plans[i].shape[-1])
                whole = torch.empty(g.shape[:-1] + (g.shape[-1] * stride,), device="meta")
                steps = _q_steps(whole, comp.plans[i].stacked, at)[..., ::stride]
                touched_n += int((steps > 0).sum())
                share = (share - (torch.pow(1 + step, steps.float()) - 1)).clamp_min(0)
            total_n += g.numel()
            worst = max(worst, (float(share.max()), path))
            if run in S_RUNS and any(f"['{k}']" in path for k in S_NAMED):
                named[path] = float(share.max())
        check(
            worst[0] <= Q_SYNC_SHARE,
            f"{who}: step-0 synced {worst[1]} share {worst[0]:.3e}",
        )
        check("gloo" in refusals[r], f"{who}: a graphed step under gloo ran")
        step_ms = 1e3 * _median(res["step_s"][1:])
        data_share = sum(res["collective_s"][1:]) / sum(res["step_s"][1:])
        model_share = sum(res["model_collective_s"][1:]) / sum(res["step_s"][1:])
        print(
            f"  {who}: loss rel <= {loss_rel:.3e}, step-0 synced <= {worst[0]:.3e} of "
            f"its leaf's largest ({worst[1]}) beyond the moved codes' steps, "
            f"{touched_n / total_n:.3%} of it made of a moved code; "
            f"{step_ms:.1f} ms a step eager (host "
            f"clock), model-axis collectives {model_share:.1%}, data-axis "
            f"{data_share:.1%}; peak {res['peak_bytes'] / 1e9:.2f} GB; {card}"
        )
        print(f"    model-axis collectives by tag: {res['model_comm']['calls']}")
        if named:
            print(
                "    step-0 synced share beyond the moved codes' steps: "
                + ", ".join(f"{p} {v:.3e}" for p, v in named.items())
            )
    for (d, s), got in rows.items():
        rep = {b for _, b in got}
        check(len(got) == model and len(rep) == 1, f"{label}: row {d} step {s} ranks")
        total = sum(p for p, _ in got)
        want = one["recs"][s][0] + (model - 1) * rep.pop()
        check(total == want, f"{label}: row {d} step {s} physical {total} != {want}")
    # replicated leaves: the same bits on every rank after every step
    for s in range(Q_STEPS):
        first = ranks[0]["prints"][s]
        for res in ranks[1:]:
            for (key, fp), dim in zip(first.items(), res["dims"]):
                if dim is None:
                    same = res["prints"][s][key] == fp
                    check(same, f"{label}: step {s} {key} differs")
    phys = {(d, s): sum(p for p, _ in got) for (d, s), got in rows.items()}
    shares = {
        ph: f"{(a + b) / max(n, 1):.3%} moved ({a} by one, {b} by 2+ of {n})"
        for ph, (a, b, n) in moved.items()
    }
    print(
        f"  {label}: accounted {one['recs'][0][0]} bits a step (the JAX package's "
        f"figure), data-axis collectives {one['recs'][0][2]} a rank; physical bits "
        f"of each data row's model ranks {sorted(set(phys.values()))} = accounting "
        f"+ {model - 1} x {ranks[0]['replicated_bits']} replicated; step-0 codes "
        f"against one process: {shares}; replicated leaves bit-identical on all "
        f"{world} ranks after each of {Q_STEPS} steps; a graphed step under gloo "
        "refused"
    )
    emit({"phase": run[0], "run": run, "card": card, "one_s": one_s,
          "one_ms": one_ms, "codes_moved": moved, "accounted_bits": one["recs"][0][0],
          "replicated_bits": ranks[0]["replicated_bits"],
          "ranks": [{"rank": i, "step_s": r["step_s"],
                     "collective_s": r["collective_s"],
                     "model_collective_s": r["model_collective_s"],
                     "peak_bytes": r["peak_bytes"],
                     "losses": [h["loss"] for h in r["history"]]}
                    for i, r in enumerate(ranks)]})  # fmt: skip
    counts = {}
    encode = "log_quantize" if bits == 8 else "log_quantize_pack"
    for res in ranks:
        for name in (encode, "log_dequantize"):
            check(res["launches"].get(name, 0) > 0, f"{label}: {name} not launched")
        for name, c in res["launches"].items():
            counts[name] = counts.get(name, 0) + c
    print(f"  {label}: the ranks' launches {counts}")
    return counts


def _q_coords(r, data, model):
    return {"data": r // model, "model": r % model}, {"data": data, "model": model}


# ------------------ phase 18 (s): tensor-parallel training of the rest of the zoo
# run -> (arch, mesh, arguments), run as (q)'s: in the shared torchrun of its
# mesh through launch/train.py (one worker a rank) against the one-process
# launcher (--mesh Dx1) on the same seeded weights and batches, 3 steps of
# LQ-SGD r1 at the configs' widths, 2 x 512 tokens a worker, cut in depth so
# that two ranks, or the one-process run, fit the card: (s1) mixtral-8x7b one
# MoE layer of 32 (4 of 8 experts a rank), b8, Adam 1e-4 as (l5); (s2)
# deepseek-v3-671b its 3 dense MLA lead layers and the MTP head, no MoE
# layer (one is 11.3 B parameters), b8, SGD, a bf16 error feedback as (o4)
# (Adam's moments would not fit the one-process run); (s3) jamba-v0.1-52b
# positions 1 and 4 of its period (a Mamba-2 layer with an FFN of 16
# experts, 8 a rank, and the attention layer), b8, SGD; (s4)
# musicgen-medium 6 of 48 layers with its codebooks and conditioning prefix,
# b4, Adam 1e-4 as (m4); (s5) mamba2-370m 6 of 48 layers at 2x2 (2 workers),
# b8, Adam 1e-4 as (m3). Step 0's synced gradients are kept at a sample of
# each leaf's last dim (launch/train.py --dump-sample: 56-128 columns a
# matrix), held to Q_SYNC_SHARE of the whole leaf's largest value: whole,
# (s1)-(s3)'s dumps wrote ~39 GB, past the machine's 45 GiB of disk
# writes with the earlier phases'. SGD at 0.005: at (q2)'s 0.05 both models' losses
# rose at the third step (deepseek 16.1, 14.0, 18.2), and the ranks' bf16
# drift grew with it past Q_LOSS_REL.
S_TOKENS = ["--seq", "512", "--compressor", "lq_sgd", "--rank", "1", "--dump-sample"]
S_ADAM = ["--optimizer", "adam", "--lr", "1e-4"]
S_SGD = ["--optimizer", "sgd", "--lr", "0.005"]
S_RUNS = {
    "s1": ("mixtral-8x7b", "1x2", [
        "--repeats", "1", "--batch", "2", *S_TOKENS, "--bits", "8", *S_ADAM,
    ]),
    "s2": ("deepseek-v3-671b", "1x2", [
        "--keep-pattern", "", "--batch", "2", *S_TOKENS, "--bits", "8", *S_SGD,
        "--comp-dtype", "bfloat16",
    ]),
    "s3": ("jamba-v0.1-52b", "1x2", [
        "--repeats", "1", "--keep-pattern", "1,4", "--batch", "2", *S_TOKENS,
        "--bits", "8", *S_SGD,
    ]),
    "s4": ("musicgen-medium", "1x2", [
        "--repeats", "6", "--batch", "2", *S_TOKENS, "--bits", "4", *S_ADAM,
    ]),
    "s5": ("mamba2-370m", "2x2", [
        "--repeats", "6", "--batch", "4", *S_TOKENS, "--bits", "8", *S_ADAM,
    ]),
}  # fmt: skip
TRAIN_RUNS = {**Q_RUNS, **S_RUNS}
# the accounted bits a step where the CPU tests hold the JAX package's figure
# for the same tree ((l5), (m3))
S_BITS = {"s1": 2_626_336, "s5": 1_200_544}
# the leaves whose step-0 synced gradient (s) prints, beside the worst
S_NAMED = ("router", "wq_a", "wkv_a")
# the step metrics besides the loss held to Q_LOSS_REL
S_METRICS = ("ce", "mtp_ce", "moe_aux")


@contextlib.contextmanager
def _s_routing(run, out_dir):
    """For an (s) run of a model with MoE layers: its MoE calls' routing
    recorded (``models.moe.routing``); ``keep(name)`` writes step 0's
    forward calls (the first of the run: one a MoE layer) to
    ``out_dir/name``. Otherwise nothing is recorded or written."""
    from repro_torch.models import moe

    cfg = _q_plan(run)[0] if run in S_RUNS else None
    n_moe = 0 if cfg is None else sum(spec.moe for spec in cfg.layers)
    if not n_moe:
        yield lambda name: None
        return
    with moe.routing() as rec:

        def keep(name):
            calls = [(c.cpu(), lg.cpu()) for c, lg in rec.calls[:n_moe]]
            torch.save(calls, Path(out_dir, name))

        yield keep


def _s_checks(run, one_dir, rank_dir, one):
    """(s)'s checks beside (q)'s (:func:`_q_run`): every rank's ce, mtp_ce
    and moe_aux within Q_LOSS_REL of the one-process run's at every step,
    and its step-0 MoE choices against the one-process run's, each flip at
    a router margin (from the rank's own logits) <= MOE_FLIP_MARGIN."""
    arch, mesh, _ = S_RUNS[run]
    data, model = _q_world(mesh)
    cfg = _q_plan(run)[0]
    label = f"({run}) {arch} {mesh}"
    for r in range(data * model):
        res = torch.load(Path(rank_dir, f"rank{r}.pt"), weights_only=False)
        worst = {}
        for key in S_METRICS:
            if key not in one["history"][0]:
                continue
            for h, w in zip(res["history"], one["history"], strict=True):
                rel = abs(h[key] - w[key]) / max(abs(w[key]), 1e-30)
                check(rel <= Q_LOSS_REL, f"{label} rank {r}: {key} {h[key]} vs {w[key]}")
                worst[key] = max(worst.get(key, 0.0), rel)
        print(f"  {label} rank {r}: rel of each metric against one process {worst}")
        if Path(one_dir, "routing.pt").exists():
            want = torch.load(Path(one_dir, "routing.pt"), weights_only=False)
            got = torch.load(Path(rank_dir, f"routing{r}.pt"), weights_only=False)
            who = "the rank's (its own router logits against one process's choices)"
            flips = _moe_flips(f"{label} rank {r} step 0", cfg, want, got, who)
            emit({"phase": "s", "run": run, "rank": r, "moe_flips": flips})


# ------------- phase 19 (t): training over a (data, model) mesh, every compressor
# run -> (steps, arguments): gemma3-1b whole at (q1)'s shapes (2 workers x 4
# x 512 over 2x2, bf16, Adam 1e-3), in the 2x2 torchrun, each held as (q)
# holds (q1) to the one-process launcher (--mesh 2x1) on the same seeded
# weights and batches: (t1) TopK 1%; (t2) QSGD b4; (t3) LQ-SGD r1 b8 over
# dlog at (k1)'s budget, DP epsilon 48 a use; (t4) r1 b4 over lrq; (t5) a
# per-leaf policy of two lazy groups (the power iteration on the leaves
# named w*, at most 2 skips in a row; LQ-SGD b8 on the rest, at most 1;
# threshold 2.0) after a warm-up step, so that a warm fire, skips, voted
# and forced fires occur in 4 steps (with at most 2 in both, the LQ-SGD
# group voted at steps 2 and 3 and was never forced, NVIDIA H100 80GB
# HBM3, 700 W; the lazy knobs ride the policy spec: --lazy-thresh reaches a
# uniform policy only, as in the JAX package), its error feedback, cached
# aggregate and references in bf16 as (s2)'s (in f32 the composite's
# state, which it does not donate, took each rank to 18.7 GB at a fired
# step, and four ranks beside this process overran the card); (t6) r1 b8
# on the server wire at participation 0.5. The wire arrays of step 0 only
# are kept (--dump-wire-steps; TopK's, the dense f32 stand-in, none):
# whole, they would be tens of GB on the disk.
T_ARCH, T_MESH, T_DEVICE = "gemma3-1b", "2x2", "cuda"
T_POLICY = (
    "w=powersgd:lazy_thresh=2.0:max_stale=2,"
    "*=lq_sgd:bits=8:lazy_thresh=2.0:max_stale=1"
)
T_COMMON = ["--batch", "8", "--seq", "512", "--optimizer", "adam", "--lr", "1e-3"]
T_COMMON += ["--log-every", "1", "--runtime", "sync", "--dump-steps", "--dump-sample"]
T_LQ = ["--compressor", "lq_sgd", "--rank", "1"]
T_RUNS = {
    "t1": (2, ["--compressor", "topk", "--dump-wire-steps", "0"]),
    "t2": (2, ["--compressor", "qsgd", "--bits", "4", "--dump-wire-steps", "1"]),
    "t3": (2, [*T_LQ, "--bits", "8", "--codec", "dlog", "--dp-epsilon", "48",
               "--dump-wire-steps", "1"]),
    "t4": (2, [*T_LQ, "--bits", "4", "--codec", "lrq", "--dump-wire-steps", "1"]),
    "t5": (4, ["--policy", T_POLICY, "--warmup", "1", "--comp-dtype", "bfloat16",
               "--dump-wire-steps", "0"]),
    "t6": (3, [*T_LQ, "--bits", "8", "--wire", "server", "--participation", "0.5",
               "--dump-wire-steps", "1"]),
}  # fmt: skip
# (t3)'s per-step DP epsilon over gemma3-1b's whole tree at dp_epsilon 48:
# the JAX package's figure (tests/test_torch_privacy_codecs.py holds it)
T3_EPSILON = 7056.0
# the kernels each run's path must launch on every rank: the randomized
# codes (QSGD, dlog, lrq) come from plain torch, their b <= 4 pack and the
# log codec's expand from the Triton kernels
T_KERNELS = {
    "t2": ("pack_nibbles",),
    "t3": ("log_dequantize",),
    "t4": ("pack_nibbles", "log_dequantize"),
    "t5": ("log_quantize", "log_dequantize"),
    "t6": ("log_quantize", "log_dequantize"),
}


def _t_argv(run):
    steps, argv = T_RUNS[run]
    if run == "t6":
        argv = [*argv, "--participation-seed", str(_t6_seed())]
    return ["--arch", T_ARCH, *argv, *T_COMMON, "--steps", str(steps)]


@functools.cache
def _t6_seed():
    """The first participation seed whose round 0 takes one of the two
    workers on this device (the draw is the device's generator's), so that
    (t6)'s step-0 synced gradient is a participation-weighted mean: seed 0
    drops both at round 0 on the H100, and its step 0 syncs zeros."""
    from repro_torch.core.wire import participation_draw

    for seed in range(64):
        if int(participation_draw(seed, 0, 2, 0.5, T_DEVICE).sum()) == 1:
            return seed
    raise SmokeFailure("(t6): no participation seed below 64 takes one worker")


@contextlib.contextmanager
def _t_recording():
    """Inside the block: each server round's participation flags of this
    process's workers (``ServerWire.prepare``) and, for each TopK leaf a
    step, ``k``, each worker's count of kept entries of this process's
    block and the least magnitude kept (``compressors.topk_mask``; not in a
    CUDA graph's capture, so a graphed run records its eager step 0)."""
    from repro_torch.core import compressors, wire

    seen = {"flags": [], "kept": []}
    prepare, mask = wire.ServerWire.prepare, compressors.topk_mask

    def rec_prepare(self, rec):
        seen["flags"].append(self.active().cpu())
        return prepare(self, rec)

    def rec_mask(flat, k, block=None):
        out = mask(flat, k, block)
        if not torch.cuda.is_current_stream_capturing():  # a graph's: none
            least = torch.where(out > 0, flat.abs(), torch.inf).amin(1)
            seen["kept"].append((k, out.sum(1).cpu(), least.cpu()))
        return out

    wire.ServerWire.prepare, compressors.topk_mask = rec_prepare, rec_mask
    try:
        yield seen
    finally:
        wire.ServerWire.prepare, compressors.topk_mask = prepare, mask


def _t_rank(out_dir, run):
    """One rank's (t) run in the 2x2 torchrun: ``launch/train.py``'s
    ``main`` over the mesh with the launch counts and peak memory at 0
    first, dumping to ``out_dir/<run>_ranks/rank<r>.pt``, what
    :func:`_t_recording` saw to ``seen<r>.pt`` beside."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    dump = Path(out_dir, f"{run}_ranks")
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with _t_recording() as seen:
        out = train.main(
            _t_argv(run) + ["--mesh", T_MESH, *Q_RANK_ARGS, "--dump", str(dump)]
        )
    torch.save(seen, Path(dump, f"seen{out['mesh'].rank}.pt"))
    del out


def _t_one_process(run, out_dir):
    """``run``'s launcher in this process (--mesh 2x1: graphed where the
    compressor allows), its dump and recording read back."""
    from repro_torch.launch import train

    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    with _t_recording() as seen:
        train.main(
            _t_argv(run) + ["--mesh", "2x1", "--device", "cuda"]
            + ["--dump", str(out_dir)]
        )  # fmt: skip
    torch._C._cuda_clearCublasWorkspaces()
    _free_cuda()
    one = torch.load(Path(out_dir, "rank0.pt"), weights_only=False)
    return {**one, **seen}


def _t_plan(run):
    """``run``'s compressor on gemma3-1b's abstract tree, its config's
    fields from the launcher's own parser."""
    from repro_torch.configs import get_config
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.launch.train import _parser
    from repro_torch.train.step import make_model_compressor

    a = _parser().parse_args(_t_argv(run))
    ccfg = CompressorConfig(
        name=a.compressor, rank=a.rank, bits=a.bits, codec=a.codec,
        dp_epsilon=a.dp_epsilon, policy=a.policy, warmup_steps=a.warmup,
        topology=a.wire, participation=a.participation,
    )  # fmt: skip
    return make_model_compressor(get_config(T_ARCH), ccfg)


def _t_layout(run, comp, dims):
    """Step 0's data-axis gathers of ``run`` as :func:`_q_layout` gives
    them (QSGD: each low-rank leaf's codes), after the server wire's
    participation flags; None where its wire is not kept."""
    if run == "t2":
        return [
            ("raw", i, pl.shape, dims[i],
             None if dims[i] is None else ((pl.shape[dims[i]],), 0))
            for i, pl in enumerate(comp.plans)
            if pl.route == "lowrank"
        ]  # fmt: skip
    if run in ("t3", "t4", "t6"):
        return _q_layout(comp, dims)
    return None


def _t_checks(card, run, one, rank_dir, one_s):
    """(t)'s checks of ``run``: its ranks' dumps in ``rank_dir`` against the
    one-process run ``one`` (module comment above :data:`T_RUNS`)."""
    from repro_torch.core.compressors import ModelSplit
    from repro_torch.core.tree import flatten_with_paths
    from repro_torch.launch.train import sample_stride

    t0 = time.perf_counter()
    data, model = _q_world(T_MESH)
    steps, argv = T_RUNS[run]
    comp = _t_plan(run)
    bits = int(argv[argv.index("--bits") + 1]) if "--bits" in argv else 8
    label = f"({run}) {T_ARCH} {T_MESH} {' '.join(argv[:-2])}"
    ranks = [
        torch.load(Path(rank_dir, f"rank{r}.pt"), weights_only=False)
        for r in range(data * model)
    ]
    seen = [
        torch.load(Path(rank_dir, f"seen{r}.pt"), weights_only=False)
        for r in range(data * model)
    ]
    dims = ranks[0]["dims"]
    split = ModelSplit(None, dims)
    one_loss = [h["loss"] for h in one["history"]]
    one_synced = dict(flatten_with_paths(one["synced0"]))
    levels = (1 << (bits - 1)) - 1
    step = ((1 + ALPHA) - (1 + ALPHA) ** ((levels - 1) / levels)) / ALPHA
    check(len(one_loss) == steps, f"{label}: {len(one_loss)} one-process steps")
    if run == "t3":
        eps = comp.privacy_epsilon_per_step(1e-5)
        check(eps == T3_EPSILON, f"{label}: epsilon a step {eps} != {T3_EPSILON}")
    if run not in ("t5", "t6"):  # no gate, no sideband: the plan's bits
        bits0 = one["recs"][0][0]
        check(bits0 == comp.wire_bits_per_step(), f"{label}: one-process bits {bits0}")
    layout = _t_layout(run, comp, dims)
    skip = 1 if run == "t6" else 0  # the participation flags' gather
    one_stale = one.get("stale")
    if run == "t5":  # a warm fire in every group; skips, forced and voted fires
        from repro_torch.core.lazy import group_max_stale

        seen_kinds = set()
        for m in one_stale[0]:
            cap = group_max_stale(comp.plans, comp.lazy_groups[m])
            pattern = [int(st[m]) for st in one_stale]
            print(f"  {label}: group {m} (cap {cap}) staleness by step {pattern}")
            check(pattern[0] == 0, f"{label}: group {m} skipped its warm step")
            for s_, p in enumerate(pattern[1:], 1):
                before = pattern[s_ - 1]
                seen_kinds.add("skip" if p else "forced" if before >= cap else "vote")
        check(
            seen_kinds >= {"skip", "forced"},
            f"{label}: the groups' rounds were {sorted(seen_kinds)}: no skip and "
            "forced fire",
        )
    if run == "t6":
        pattern = [f.tolist() for f in one["flags"]]
        check(sum(pattern[0]) == 1, f"{label}: round 0's flags {pattern[0]}")
        print(
            f"  {label}: participation seed {_t6_seed()}, flags by round {pattern}"
        )
    # TopK at step 0: each worker's k-th largest magnitude of each leaf (its
    # least kept, over its data row's ranks; the larger of the ranks' and
    # one process's), at which the bf16 drift may swap an entry in or out
    # of that worker's kept set: the synced mean moves by at most the sum
    # over the workers / n
    least = {}
    if run == "t1":
        lowrank = [i for i, pl in enumerate(comp.plans) if pl.route == "lowrank"]
        for j, i in enumerate(lowrank):
            taus = []
            for w in range(data):
                row = range(w * model, (w + 1) * model)  # its data row's ranks
                tau = min(float(seen[q]["kept"][j][2].max()) for q in row)
                taus.append(max(tau, float(one["kept"][j][2][w])))
            least[i] = sum(taus)
    rows, moved = {}, {}
    summary = {}
    for r, res in enumerate(ranks):
        coords, sizes = _q_coords(r, data, model)
        d = coords["data"]
        who = f"{label} rank (d{d}, m{coords['model']})"
        loss = [h["loss"] for h in res["history"]]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(loss, one_loss, strict=True))
        check(loss_rel <= Q_LOSS_REL, f"{who}: loss rel {loss_rel:.3e}")
        for s, (bits_s, phys, colls) in enumerate(res["recs"]):
            bits_1, _, colls_1 = one["recs"][s]
            check(bits_s == bits_1, f"{who}: step {s} accounted bits {bits_s}")
            check(colls == colls_1, f"{who}: step {s} data-axis collectives {colls}")
            rows.setdefault((d, s), []).append(phys)
        if one_stale is not None:  # the fire pattern: one process's
            got = [{m: int(v) for m, v in st.items()} for st in res["stale"]]
            want = [{m: int(v) for m, v in st.items()} for st in one_stale]
            check(got == want, f"{who}: staleness {got} != {want}")
        if run == "t6":
            got = [f.tolist() for f in seen[r]["flags"]]
            want = [f[d : d + 1].tolist() for f in one["flags"]]
            check(got == want, f"{who}: participation flags {got} != {want}")
        # step 0's wire against the block of the one-process wire, on the card
        moved_at = {}
        for j in range(len(layout or ())):
            phase, i, shape, dim, flat = layout[j]
            w = _q_codes(one["gathered"][skip + j].cuda(), shape, bits)
            bshape = list(shape)
            if dim is not None:
                bshape[dim] //= model
                w = _q_factor_block(w, dim, flat, coords, sizes)
            g = _q_codes(res["gathered"][skip + j].cuda(), bshape, bits)
            diff = (g.int() - w.int()).abs()
            m = moved.setdefault(phase, [0, 0, 0])
            m[0] += int((diff == 1).sum())
            m[1] += int((diff > 1).sum())
            m[2] += diff.numel()
            moved_at.setdefault(i, {})[phase] = diff.amax(0)
            if run == "t2":  # QSGD's linear grid: one level, or a sign flip
                bad = (diff > 1) & (g.int() != -w.int())  # of a value near 0
                check(not bad.any(), f"{who}: {phase} {i} code moved {diff.max()}")

        # step 0's synced gradient, at the sampled positions
        worst, held, total_n = (0.0, "", ""), 0, 0
        synced = flatten_with_paths(res["synced0"])
        tops = one["synced0_max"]
        for i, ((path, g), dim) in enumerate(zip(synced, dims, strict=True)):
            w = _q_block(one_synced[path], dim, coords, sizes).cuda().float()
            g = g.cuda().float()
            top = max(tops[i], 1e-30)
            share = (g - w).abs() / top
            if i in least:  # a swapped entry moves the mean by |x| / n
                share = (share - least[i] / data / top).clamp_min(0)
            if i in moved_at and run != "t5":
                stride = sample_stride(comp.plans[i].shape[-1])
                shape = g.shape[:-1] + (g.shape[-1] * stride,)
                whole = torch.empty(shape, device="meta")
                at = {ph: v.cuda() for ph, v in moved_at[i].items()}
                steps_at = _q_steps(whole, comp.plans[i].stacked, at)[..., ::stride]
                if run == "t2":  # a QSGD element is held through its codes
                    share = torch.where(steps_at > 0, 0.0, share)
                else:
                    allow = torch.pow(1 + step, steps_at.float()) - 1
                    share = (share - allow).clamp_min(0)
                held += int((steps_at > 0).sum())
            total_n += g.numel()
            if float(share.max()) > worst[0]:  # its largest difference, and why
                at = int(share.argmax())
                beyond = int((share > Q_SYNC_SHARE).sum())
                one_side = int(((g == 0) != (w == 0)).sum())
                why = (
                    f"one {float(w.reshape(-1)[at]):.4e}, rank "
                    f"{float(g.reshape(-1)[at]):.4e}, largest {top:.4e}, least "
                    f"kept (sum over workers) {least.get(i, 0.0):.4e}; {beyond} of {g.numel()} sampled "
                    f"beyond, {one_side} kept on one side only"
                )
                worst = (float(share.max()), path, why)
        ok = worst[0] <= Q_SYNC_SHARE
        check(ok, f"{who}: step-0 synced {worst[1]} {worst[0]:.3e}: {worst[2]}")
        step_ms = 1e3 * _median(res["step_s"][1:])
        data_share = sum(res["collective_s"][1:]) / sum(res["step_s"][1:])
        model_share = sum(res["model_collective_s"][1:]) / sum(res["step_s"][1:])
        summary[r] = dict(
            loss_rel=loss_rel, synced=worst[0], step_ms=step_ms,
            model_share=model_share, data_share=data_share,
            peak_gb=res["peak_bytes"] / 1e9,
        )  # fmt: skip
        print(
            f"  {who}: loss rel <= {loss_rel:.3e}, step-0 synced <= {worst[0]:.3e} "
            f"of its leaf's largest ({worst[1]}: {worst[2]}) beyond the allowance, "
            f"{held / max(total_n, 1):.3%} of it made of a moved code; "
            f"{step_ms:.1f} ms a step eager (host clock), model-axis collectives "
            f"{model_share:.1%}, data-axis {data_share:.1%}; peak "
            f"{res['peak_bytes'] / 1e9:.2f} GB; {card}"
        )
        print(f"    model-axis collectives by tag: {res['model_comm']['calls']}")
    if run == "t1":  # k a worker and leaf, over each data row's ranks
        lowrank = [i for i, pl in enumerate(comp.plans) if pl.route == "lowrank"]
        for d in range(data):
            row = [seen[r]["kept"] for r in range(data * model) if r // model == d]
            for j, (k, _, _) in enumerate(one["kept"][: len(lowrank)]):
                counts = [int(x[j][1].sum()) for x in row]
                want = k if dims[lowrank[j]] is not None else k * model
                check(sum(counts) == want, f"{label}: row {d} TopK call {j} {counts}")
        check(all(bool((c == k).all()) for k, c, _ in one["kept"]), f"{label}: one k")
    for (d, s), got in rows.items():
        skipped = []
        if one_stale is not None:
            skipped = [m for m, v in one_stale[s].items() if int(v) != 0]
        if skipped:
            rep = comp.model_replicated_bits(split, skipped)
        else:
            rep = comp.model_replicated_bits(split)
        want = one["recs"][s][1] + (model - 1) * rep
        check(sum(got) == want, f"{label}: row {d} step {s} physical {sum(got)}")
    for s in range(steps):  # replicated leaves: the same bits on every rank
        first = ranks[0]["prints"][s]
        for res in ranks[1:]:
            for (key, fp), dim in zip(first.items(), dims):
                if dim is None:
                    check(res["prints"][s][key] == fp, f"{label}: step {s} {key}")
    shares = {
        ph: f"{(a + b) / max(n, 1):.3%} moved ({a} by one, {b} by 2+ of {n})"
        for ph, (a, b, n) in moved.items()
    }
    one_ms = 1e3 * one["step_s"][-1]
    print(
        f"  {label}: accounted {one['recs'][0][0]} bits at step 0, data-axis "
        f"collectives {one['recs'][0][2]} a rank; each data row's physical bits = "
        f"one process's + {model - 1} x the replicated; step-0 codes against one "
        f"process: {shares or 'no codes kept'}; replicated leaves bit-identical on "
        f"all ranks after each of {steps} steps; one process {one_s:.1f} s "
        f"({one_ms:.1f} ms its last step, peak {one['peak_bytes'] / 1e9:.2f} GB); "
        f"checks {time.perf_counter() - t0:.1f} s; the run's dumps "
        f"{_tree_gb(rank_dir) + _tree_gb(rank_dir.parent / f'{run}_one'):.3f} GB"
    )
    emit({"phase": "t", "run": run, "card": card, "one_s": one_s, "one_ms": one_ms,
          "codes_moved": moved, "ranks": summary,
          "accounted_bits": one["recs"][0][0]})  # fmt: skip
    counts = {}
    for res in ranks:
        for name in T_KERNELS.get(run, ()):
            check(res["launches"].get(name, 0) > 0, f"{label}: {name} not launched")
        for name, c in res["launches"].items():
            counts[name] = counts.get(name, 0) + c
    print(f"  {label}: the ranks' launches {counts}")
    return counts


def _tree_gb(path):
    """The bytes of the files under ``path``, in GB."""
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file()) / 1e9


def _disk_writes_gb():
    """The bytes this process and its reaped children wrote to storage,
    in GB (``write_bytes`` of /proc/self/io)."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("write_bytes:"):
                    return int(line.split()[1]) / 1e9
    except OSError:
        pass
    return float("nan")  # not readable here


# ------------------------------------ phase 17 (r): tensor-parallel zoo serving
# run -> (arch, mesh, cache bits, the cut of its depth), at full width, batch
# 4, prompt 1024, R_GEN new tokens; the ranks of one mesh run their runs in
# ONE torchrun of gloo ranks sharing the card (TP_SPAWNS), against the
# one-process run in this process on the same seeded weights and prompts.
# (r1) jamba-v0.1-52b one period (8 layers): Mamba-2 heads, 8 of 16 experts
# a rank, attention over 4 of 8 KV heads, #7 on 64 heads; (r2) mamba2-370m
# 6 of 48 layers at 2x2: the data axis with a head-split SSM state; (r3)
# deepseek-v3-671b 4 of 61 layers (3 dense + 1 MoE): 128 experts and 64
# heads a rank, the latent cache split by sequence, #6 at head_dim 192;
# (r4) musicgen-medium 6 of 48 layers after its 64-step prefix: codebooks
# and cond, 12 of 24 KV heads; (r5) gemma3-1b on 8 of 26 layers (as (p1)),
# the continuous scheduler over (c)'s 8 requests through 4 slots at 2x2.
# (r2), (r4) and (r5) at half their depth of phases 17 and 18 since phase 19.
R_RUNS = {
    "r1": ("jamba-v0.1-52b", "1x2", 8, {"repeats": 1}),
    "r2": ("mamba2-370m", "2x2", 0, {"repeats": 6}),
    "r3": ("deepseek-v3-671b", "1x2", 8, {"repeats": 1}),
    "r4": ("musicgen-medium", "1x2", 4, {"repeats": 6}),
    "r5": ("gemma3-1b", "2x2", 8, {"repeats": 1}),
}
# the runs of phases (p), (q) and (r) over each mesh, in ONE torchrun each
TP_SPAWNS = {
    "1x2": ("o", "n3", "p1", "p3", "q2", "r1", "r3", "r4", "s1", "s2", "s3", "s4"),
    "2x2": (
        "n2", "p2", "q1", "r2", "r5", "s5", "t1", "t2", "t3", "t4", "t5", "t6",
    ),
}
R_CONTINUOUS = "r5"
# The ranks share the card and draw their weights in turn (launch/serve.py),
# each returning its cached blocks after its turn; a rank's shards are cut
# while the whole layer is live, so they land inside the segments of its
# draws (a 15 GB f32 draw of a deepseek-v3-671b expert stack) and pin them:
# expandable segments return the unused pages of a segment.
R_ALLOC = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
R_GEN = 16
# the kernels each run's path must launch, on every rank
R_KERNELS = {
    "r1": ("log_quantize", "log_dequantize_rows", "flash_attention", "ssd_chunk"),
    "r2": ("ssd_chunk",),
    "r3": ("log_quantize", "log_dequantize_rows", "flash_attention"),
    "r4": ("log_quantize_pack", "log_dequantize_rows", "flash_attention"),
    "r5": ("log_quantize", "log_dequantize_rows", "flash_attention"),
}


def _r_release():
    """Return this process's device memory to the card, the cuBLAS
    workspaces of its streams included (each pins the segment it lies in,
    as ``_q_one_process`` found): the ranks that share the card next draw
    a deepseek-v3-671b MoE layer whole (~48 GB at its peak)."""
    torch._C._cuda_clearCublasWorkspaces()
    _free_cuda()


def _r_cfg(run):
    import dataclasses

    from repro_torch.configs import get_config

    arch, _, _, cut = R_RUNS[run]
    return dataclasses.replace(get_config(arch), **cut)


def _r_argv(run):
    """``launch/serve.py``'s arguments of a fixed run (no mesh, no device)."""
    arch, _, bits, cut = R_RUNS[run]
    return ["--arch", arch, "--cache-bits", str(bits), "--repeats",
            str(cut["repeats"]), *P_ARGS[:4], "--gen", str(R_GEN)]  # fmt: skip


def _r_qcfg(bits):
    from repro_torch.serving.kv_cache import CacheQuantConfig

    return CacheQuantConfig(bits=bits) if bits else None


def _r5_prompts(cfg):
    """(c)'s 8 requests: phase 4's draws after its (a) / (b) prompts."""
    rng = np.random.default_rng(0)
    rng.integers(0, cfg.vocab_size, (BATCH, PROMPT))
    return [
        rng.integers(0, cfg.vocab_size, size=int(n))
        for n in rng.integers(200, 1001, size=N_REQUESTS)
    ]


def _r_caches(caches):
    """(path, codes, scale) of every quantized cache leaf and (path, raw)
    of every raw one (SSM state, conv window), on the host."""
    from repro_torch.serving.kv_cache import QuantKV, tree_leaves

    quant, raw = [], []
    for path, leaf in tree_leaves(caches):
        if isinstance(leaf, QuantKV):
            quant.append((path, leaf.codes.cpu(), leaf.scale.cpu()))
        else:
            raw.append((path, leaf.float().cpu()))
    return quant, raw


def _r_teacher(cfg, params, prompt, cond, bits, tokens, shard=None):
    """A fresh prefill of ``prompt`` (after ``cond``), then R_GEN decode
    steps fed ``tokens``, eager: the prefill logits, every step's logits
    and the caches on the host (:func:`_r_caches`)."""
    from repro_torch.serving.engine import build_decode_step, build_prefill_step

    start = PROMPT + cfg.cond_len
    qcfg = _r_qcfg(bits)
    pre = build_prefill_step(cfg, start + R_GEN, qcfg=qcfg, shard=shard)
    dec = build_decode_step(cfg, shard)
    logits, caches = pre(params, prompt, cond)
    steps = [
        dec(params, caches, tokens[:, i : i + 1], start + i)[0]
        for i in range(R_GEN)
    ]
    return logits.cpu(), torch.cat(steps, dim=1).cpu(), _r_caches(caches)


def _r_calls(rec):
    return [(c.cpu(), lg.cpu()) for c, lg in rec.calls]


def _r_fixed_rank(out_dir, run, mesh):
    """One rank's fixed run: ``launch/serve.py``'s ``main`` over ``mesh``
    with its MoE layers held to the one-process run's routing, then the
    teacher-forced run on the one-process tokens, held alike."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import moe

    bits = R_RUNS[run][2]
    held = torch.load(Path(out_dir, f"{run}_routing.pt"))
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with moe.routing([c.cuda() for c in held["free"]] or None):
        out = serve.main(_r_argv(run) + ["--mesh", mesh] + P_RANK_ARGS)
    launches = ops.launch_counts()
    shard = out["shard"]
    rows = shard.rows()
    tokens = torch.load(Path(out_dir, f"{run}_tokens.pt"))[rows].cuda()
    with moe.routing([c.cuda() for c in held["teacher"]] or None) as rec:
        prefill, teacher, (quant, raw) = _r_teacher(
            _r_cfg(run), out["params"], out["prompt"], out["cond"], bits, tokens, shard
        )
    res = dict(
        rows=(rows.start, rows.stop),
        sizes=shard.mesh.sizes,
        coords=shard.mesh.coords,
        cache_specs=shard.cache_specs,
        logits=prefill,
        tokens=out["tokens"].cpu(),
        teacher=teacher,
        caches=quant,
        raw=raw,
        routing=_r_calls(rec),
        bytes=out["bytes_per_token"],
        bytes_accounted=out["bytes_per_token_accounted"],
        prefill_s=out["prefill_s"],
        decode_s=out["decode_s"],
        collective_s=out["collective_s"],
        collectives=shard.axis.comm.stats()["calls"],
        launches=launches,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    del out
    return res


def _r_continuous_rank(out_dir, run, mesh):
    """One rank's continuous run: ``launch/serve.py``'s ``run_continuous``
    over ``mesh`` on (c)'s requests, eager."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import parse_mesh
    from repro_torch.serving.engine import serve_shard
    from repro_torch.weights import init_sharded_params

    cfg, bits = _r_cfg(run), R_RUNS[run][2]
    dmesh = make_mesh(parse_mesh(mesh), "cuda:0")
    shard = serve_shard(cfg, dmesh, SLOTS)
    params = init_sharded_params(cfg, 1, "cuda:0", shard.param_specs, dmesh)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out = serve.run_continuous(
        cfg, params, _r5_prompts(cfg), gen=R_GEN, slots=SLOTS,
        qcfg=_r_qcfg(bits), graph=False, shard=shard,
    )  # fmt: skip
    return dict(
        coords=dmesh.coords,
        tokens=out["tokens"],
        bytes=out["bytes_per_token"],
        bytes_accounted=out["bytes_per_token_accounted"],
        seconds=out["seconds"],
        collective_s=out["collective_s"],
        steps=out["scheduler"].steps,
        launches=ops.launch_counts(),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
    )


def tp_spawn_rank_main(out_dir, mesh):
    """One rank of the torchrun of ``mesh`` that phases (p), (q) and (r)
    share: each run of ``TP_SPAWNS[mesh]`` in turn (:func:`_p_rank`,
    :func:`_q_rank`, :func:`_r_fixed_rank`, :func:`_r_continuous_rank`),
    its device memory returned before the next; writes
    ``out_dir/<run>_rank<r>.pt`` ((q): its launcher's dump)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed

    init_distributed("gloo", "cuda:0")
    try:
        for run in TP_SPAWNS[mesh]:
            t0 = time.perf_counter()
            if run in ("o", "n2", "n3"):
                res = {"o": _o_rank, "n2": _n2_rank, "n3": _n3_rank}[run](out_dir)
            elif run in TRAIN_RUNS:
                res = _q_rank(out_dir, run)
            elif run in T_RUNS:
                res = _t_rank(out_dir, run)
            elif run in P_RUNS:
                res = _p_rank(out_dir, run)
            elif run == R_CONTINUOUS:
                res = _r_continuous_rank(out_dir, run, mesh)
            else:
                res = _r_fixed_rank(out_dir, run, mesh)
            if res is not None:
                res["run_s"] = time.perf_counter() - t0
                torch.save(res, Path(out_dir, f"{run}_rank{dist.get_rank()}.pt"))
            del res
            _r_release()
            print(
                f"# ({run}) rank {dist.get_rank()}: {time.perf_counter() - t0:.1f} "
                f"s, {torch.cuda.memory_reserved() / 1e9:.2f} GB reserved after",
                flush=True,
            )
            dist.barrier()
    finally:
        dist.destroy_process_group()


def _r_one_fixed(run, out_dir):
    """``run`` in this process, eager, on the launcher's seeded weights and
    prompts (``launch_inputs``), its MoE layers' routing recorded, then the
    teacher-forced run on its own tokens; writes the tokens and the
    routing for the ranks."""
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.models.model import init_params

    cfg, bits = _r_cfg(run), R_RUNS[run][2]
    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 1, "cuda")
    tokens, cond = serve.launch_inputs(cfg, BATCH, PROMPT)
    tokens, cond = tokens.cuda(), None if cond is None else cond.cuda()
    with moe.routing() as free:
        out = serve.run_fixed(
            cfg, params, tokens, gen=R_GEN, qcfg=_r_qcfg(bits), graph=False, cond=cond
        )
    with moe.routing() as rec:
        prefill, teacher, (quant, raw) = _r_teacher(
            cfg, params, tokens, cond, bits, out["tokens"]
        )
    one = dict(
        logits=prefill,
        free_logits=out["logits"].cpu(),
        tokens=out["tokens"].cpu(),
        teacher=teacher,
        caches=quant,
        raw=raw,
        routing=_r_calls(rec),
        bytes=out["bytes_per_token"],
        bytes_accounted=out["bytes_per_token_accounted"],
        prefill_s=out["prefill_s"],
        decode_s=out["decode_s"],
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    torch.save(one["tokens"], Path(out_dir, f"{run}_tokens.pt"))
    routing = {"free": [c.cpu() for c in free.choices], "teacher": [c for c, _ in one["routing"]]}
    torch.save(routing, Path(out_dir, f"{run}_routing.pt"))
    del params, out, free, rec
    _r_release()
    return one


def _r_one_continuous(run):
    """(r5) in this process, eager: every request's tokens, and each
    request's one-process top-2 margins at the positions that chose them
    (a prefill of its prompt and tokens with full logits: the decode's
    logits but for the q8 cache's rounding)."""
    from repro_torch.launch import serve
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import build_prefill_step

    cfg, bits = _r_cfg(run), R_RUNS[run][2]
    _free_cuda()
    params = init_params(cfg, 1, "cuda")
    prompts = _r5_prompts(cfg)
    out = serve.run_continuous(
        cfg, params, prompts, gen=R_GEN, slots=SLOTS, qcfg=_r_qcfg(bits), graph=False
    )
    margins = {}
    for uid, p in enumerate(prompts):
        toks = out["tokens"][uid]
        seq = np.concatenate([p, np.asarray(toks[:-1])])
        pre = build_prefill_step(cfg, len(seq), full_logits=True)
        logits, _ = pre(params, torch.from_numpy(seq)[None].cuda())
        w = logits[0, len(p) - 1 :].float()
        top2 = w.topk(2, dim=-1).values
        margins[uid] = ((top2[:, 0] - top2[:, 1]) / w.abs().amax(-1)).cpu()
        del logits, w
    one = dict(
        tokens=out["tokens"],
        margins=margins,
        bytes=out["bytes_per_token"],
        bytes_accounted=out["bytes_per_token_accounted"],
        seconds=out["seconds"],
    )
    del params, out
    _r_release()
    return one


def _r_tokens(label, got, want, prefill, teacher):
    """``_p_tokens`` with codebooks: a step's token is one id a codebook
    (B, G, cb), and every codebook of a row reads all of the row's previous
    ids, so a row is compared up to its first step where any codebook
    differs, and each codebook that differs there must do so at a
    one-process margin below P_TOKEN_MARGIN."""
    if got.dim() == 2:
        return _p_tokens(label, got, want, prefill, teacher)
    w = torch.cat([prefill, teacher[:, : want.shape[1] - 1]], dim=1).float()
    top2 = w.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]) / w.abs().amax(-1)  # (B, G, cb)
    found = []
    for r in range(want.shape[0]):
        for i in range(want.shape[1]):
            differ = (got[r, i] != want[r, i]).nonzero().flatten().tolist()
            if differ:
                m = max(float(margin[r, i, c]) for c in differ)
                check(m < P_TOKEN_MARGIN, f"{label}: row {r} step {i} at margin {m}")
                found.append((r, i, m))
                break
    return found


def _r_raw(who, res, one):
    """A rank's raw cache shard (SSM state, conv window) against the block
    of the one-process run's, within LOGITS_REL_TOL of its largest value
    (no code step: the leaves stay raw). Returns the worst share."""
    from repro_torch.launch.sharding import cut
    from repro_torch.serving.kv_cache import tree_leaves

    specs = {path: s for path, s in tree_leaves(res["cache_specs"])}
    worst = {}
    for (path, got), (p2, want) in zip(res["raw"], one["raw"], strict=True):
        check(path == p2, f"{who}: raw leaves {path} / {p2}")
        want = cut(want, specs[path], res["sizes"], res["coords"])
        check(got.shape == want.shape, f"{who}: raw shape at {path}")
        check(bool(torch.isfinite(got).all()), f"{who}: non-finite {path}")
        rel = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        check(rel <= LOGITS_REL_TOL, f"{who}: {path} rel {rel:.3e}")
        worst[path[-1]] = max(worst.get(path[-1], 0.0), rel)
    return worst


def _r_launches(run, ranks):
    """Each kernel of ``run``'s path launched on every rank; the ranks'
    launches summed."""
    total = {}
    for res in ranks:
        for name in R_KERNELS[run]:
            n = res["launches"].get(name, 0)
            check(n > 0, f"({run}) rank {res['coords']}: {name} not launched")
        for name, c in res["launches"].items():
            total[name] = total.get(name, 0) + c
    print(f"  ({run}) the ranks' launches {total}")
    return total


def _r_fixed_checks(card, run, one, ranks):
    arch, mesh, bits, cut = R_RUNS[run]
    cfg = _r_cfg(run)
    label = f"({run}) {arch} {cfg.n_layers} layers {mesh} q{bits}"
    flips, moved2, diffs, flips_moe = 0, 0, [], []
    for res in ranks:
        r = res["coords"]
        rows = slice(*res["rows"])
        who = f"{label} rank (d{r['data']}, m{r['model']})"
        rel, agree, n = _p_logits(f"{who} prefill", res["logits"], one["logits"][rows])
        t_rel = max(
            _p_logits(f"{who} teacher step {i}", res["teacher"][:, i],
                      one["teacher"][rows, i])[0]
            for i in range(R_GEN)
        )  # fmt: skip
        found = _r_tokens(
            who,
            res["tokens"],
            one["tokens"][rows],
            one["free_logits"][rows],
            one["teacher"][rows],
        )
        diffs += [(r, *d) for d in found]
        if res["caches"]:
            f1, f2 = _p_caches(who, res, one, bits)
            flips, moved2 = flips + f1, moved2 + f2
        raw = _r_raw(who, res, one) if res["raw"] else {}
        if cfg.n_experts:
            flips_moe.append(_moe_flips(who, cfg, one["routing"], res["routing"]))
        total_s = res["prefill_s"] + res["decode_s"]
        print(
            f"  {who}: prefill logits rel {rel:.3e} (argmax {agree}/{n}), teacher-"
            f"forced {R_GEN} steps rel <= {t_rel:.3e}, raw caches rel {raw}; "
            f"prefill {res['prefill_s'] * 1e3:.1f} ms, decode "
            f"{res['decode_s'] * 1e3 / (R_GEN - 1):.2f} ms/token eager, collectives "
            f"{res['collective_s']:.3f} s = {res['collective_s'] / total_s:.1%} "
            f"(host clock), peak {res['peak_gb']:.2f} GB; rank's run "
            f"{res['run_s']:.1f} s; {card}"
        )
        print(f"    collectives by tag: {res['collectives']}")
    for key in ("bytes", "bytes_accounted"):
        total = sum(res[key] for res in ranks)
        check(
            abs(total - one[key]) <= 1e-9 * one[key],
            f"{label}: summed {key} {total} vs one process {one[key]}",
        )
    print(
        f"  {label}: one process prefill {one['prefill_s'] * 1e3:.1f} ms, decode "
        f"{one['decode_s'] * 1e3 / (R_GEN - 1):.2f} ms/token eager, peak "
        f"{one['peak_gb']:.2f} GB; bytes/token summed over ranks "
        f"{sum(r['bytes'] for r in ranks)} = one process {one['bytes']}; cache "
        f"codes moved by one {flips}, by 2+ {moved2}; greedy differences (rank, "
        f"row, step, one-process margin) {diffs}; MoE flips by rank {flips_moe}"
    )
    emit({"phase": "r", "run": run, "card": card, "cache_flips": flips,
          "cache_moved_2": moved2, "token_differences": diffs,
          "moe_flips": flips_moe, "one": {k: one[k] for k in (
              "prefill_s", "decode_s", "peak_gb", "bytes")},
          "ranks": [{k: res[k] for k in ("coords", "prefill_s", "decode_s",
                     "collective_s", "peak_gb", "bytes", "run_s")}
                    for res in ranks]})  # fmt: skip
    return _r_launches(run, ranks)


def _r_continuous_checks(card, run, one, ranks):
    arch, mesh, bits, _ = R_RUNS[run]
    label = f"({run}) {arch} continuous {mesh} q{bits}"
    diffs = []
    for res in ranks:
        r = res["coords"]
        who = f"{label} rank (d{r['data']}, m{r['model']})"
        check(sorted(res["tokens"]) == sorted(one["tokens"]), f"{who}: requests")
        for uid, want in one["tokens"].items():
            got = res["tokens"][uid]
            check(len(got) == len(want) == R_GEN, f"{who}: request {uid} length")
            for i, (g, w) in enumerate(zip(got, want)):
                if g != w:
                    m = float(one["margins"][uid][i])
                    check(m < P_TOKEN_MARGIN, f"{who}: request {uid} step {i} at margin {m}")
                    diffs.append((r, uid, i, m))
                    break
        print(
            f"  {who}: {res['steps']} chunks in {res['seconds']:.2f} s eager, "
            f"collectives {res['collective_s']:.3f} s = "
            f"{res['collective_s'] / res['seconds']:.1%} (host clock), peak "
            f"{res['peak_gb']:.2f} GB; rank's run {res['run_s']:.1f} s; {card}"
        )
    for key in ("bytes", "bytes_accounted"):
        total = sum(res[key] for res in ranks)
        check(
            abs(total - one[key]) <= 1e-9 * one[key],
            f"{label}: summed {key} {total} vs one process {one[key]}",
        )
    print(
        f"  {label}: one process {one['seconds']:.2f} s eager; bytes/token summed "
        f"{sum(r['bytes'] for r in ranks)} = one process {one['bytes']}; greedy "
        f"differences (rank, request, step, one-process margin) {diffs}"
    )
    emit({"phase": "r", "run": run, "card": card, "token_differences": diffs,
          "one_s": one["seconds"], "ranks": [{k: res[k] for k in (
              "coords", "seconds", "collective_s", "peak_gb", "bytes", "run_s")}
              for res in ranks]})  # fmt: skip
    return _r_launches(run, ranks)


def phase_tp(card):
    """(o), (p), (q), (r), (s) and (t): every compressor across 2 ranks,
    tensor-parallel serving and training, and training over a (data, model)
    mesh with every compressor, over gloo ranks sharing the card.
    Each phase's kernels at its ranks' shapes first; then per mesh the
    one-process runs here and ONE torchrun of its ranks for the runs of
    all the phases (``TP_SPAWNS``: a torchrun's start-up and first calls
    cost ~15-25 s), then each run's checks ((o)'s SimComm(4) runs here).
    Returns the ranks' launches and the seconds of each phase: its
    kernels, one-process runs, checks and its runs' share of the torchruns
    (the slowest rank's time in its runs, and the start-up split over the
    runs)."""
    seconds = dict.fromkeys(("n2", "n3", "o", "p", "q", "r", "s", "t"), 0.0)
    for phase, kernels, seed in (("p", _p_kernels, 15), ("q", _q_kernels, 16),
                                 ("r", _r_kernels, 17), ("s", _s_kernels, 18)):  # fmt: skip
        t0 = time.perf_counter()
        kernels(torch.Generator(device="cuda").manual_seed(seed))
        seconds[phase] += time.perf_counter() - t0
    total, dumps_gb = {}, 0.0
    for mesh, runs in TP_SPAWNS.items():
        world = _p_world(mesh)
        with tempfile.TemporaryDirectory() as tmp:
            one, one_s = {}, {}
            for run in runs:
                t0 = time.perf_counter()
                if run in ("o", "n2", "n3"):  # references after the ranks'
                    one[run] = None
                elif run in P_RUNS:
                    one[run] = _p_one_process(run, tmp)
                elif run in TRAIN_RUNS:
                    one[run] = _q_one_process(run, Path(tmp, f"{run}_one"))
                elif run in T_RUNS:
                    one[run] = _t_one_process(run, Path(tmp, f"{run}_one"))
                elif run == R_CONTINUOUS:
                    one[run] = _r_one_continuous(run)
                else:
                    one[run] = _r_one_fixed(run, tmp)
                one_s[run] = time.perf_counter() - t0
                seconds[run if run in seconds else run[0]] += one_s[run]
            args = [str(ROOT / "chip_smoke.py"), "--tp-spawn-rank", tmp, mesh]
            print(
                f"(o, p, q, r) {mesh}: this process holds "
                f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved"
            )
            out, spawn_s = _torchrun(
                f"(o, p, q, r) {mesh}", world, args, script=True, env=R_ALLOC
            )
            # each run's slowest rank, from the ranks' own lines
            run_s = {run: 0.0 for run in runs}
            for line in out.splitlines():
                if line.startswith("# (") and " s, " in line:
                    run = line[3 : line.index(")")]
                    took = float(line.split(": ")[1].split(" s,")[0])
                    run_s[run] = max(run_s[run], took)
            start_s = (spawn_s - sum(run_s.values())) / len(runs)
            print(
                f"(o, p, q, r) {mesh}: ONE torchrun of {world} gloo ranks for {runs}: "
                f"{spawn_s:.1f} s, by run (slowest rank) {run_s}, start-up "
                f"{start_s * len(runs):.1f} s"
            )
            for run in runs:
                t0 = time.perf_counter()
                if run == "o":
                    counts = _o_checks(card, tmp)
                elif run == "n2":
                    counts = _n2_checks(card, tmp)
                elif run == "n3":
                    counts = _n3_checks(card, tmp, out)
                elif run in TRAIN_RUNS:
                    rank_dir = Path(tmp, f"{run}_ranks")
                    counts = _q_run(card, run, one[run], rank_dir, one_s[run])
                    if run in S_RUNS:
                        _s_checks(run, Path(tmp, f"{run}_one"), rank_dir, one[run])
                elif run in T_RUNS:
                    rank_dir = Path(tmp, f"{run}_ranks")
                    counts = _t_checks(card, run, one[run], rank_dir, one_s[run])
                else:
                    ranks = [
                        torch.load(Path(tmp, f"{run}_rank{r}.pt"), weights_only=False)
                        for r in range(world)
                    ]
                    if run in P_RUNS:
                        counts = _p_run(card, run, one[run], ranks, one_s[run])
                    elif run == R_CONTINUOUS:
                        counts = _r_continuous_checks(card, run, one[run], ranks)
                    else:
                        counts = _r_fixed_checks(card, run, one[run], ranks)
                t = time.perf_counter() - t0 + run_s[run] + start_s
                seconds[run if run in seconds else run[0]] += t
                for name, c in counts.items():
                    total[name] = total.get(name, 0) + c
            dumps_gb += _tree_gb(tmp)
    print(
        "(o, p, q, r) seconds by phase (kernels, one process, checks, the ranks' "
        "runs and a share of the torchruns' start-up): "
        + ", ".join(f"({k}) {v:.1f}" for k, v in seconds.items())
    )
    print(
        f"(t) {seconds['t']:.1f} s; the script's disk writes so far "
        f"{_disk_writes_gb():.2f} GB (write_bytes, this process and its reaped "
        f"children); the torchruns' dumps {dumps_gb:.3f} GB"
    )
    return total, seconds


def _r_kernels(gen):
    """#1, #3, #4, #6 and #7 at the (r) ranks' shapes against their plain
    versions, with times (graph replays), bounds and SDPA's time for #6."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.codec import unpack_nibbles
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.log_dequant_rows import log_dequantize_rows_cuda
    from repro_torch.kernels.log_quant import (
        log_quantize_pack_triton,
        log_quantize_triton,
    )
    from repro_torch.kernels.ssd_chunk import ssd_chunk_cuda

    seq = PROMPT + R_GEN
    music = seq + get_config("musicgen-medium").cond_len
    print("kernels at the tensor-parallel zoo ranks' shapes")
    encodes = (
        # (r1) a layer's K (or V) over 4 of jamba's 8 KV heads, (r3) a
        # rank's half of the latent rows, (r4) musicgen's over 12 of 24
        ("log_quantize", 8, log_quantize_triton, ref.log_quantize_ref, (
            ("r1 K/V leaf", (4, 4, seq, 128)), ("r1 decode append", (4, 4, 1, 128)),
            ("r3 ckv shard", (4, seq // 2, 512)), ("r3 decode append", (4, 1, 512)))),
        ("log_quantize_pack", 4, log_quantize_pack_triton, ref.log_quantize_pack_ref, (
            ("r4 K/V leaf", (4, 12, music, 64)), ("r4 decode append", (4, 12, 1, 64)))),
    )  # fmt: skip
    for name, bits, kernel, plain, shapes in encodes:
        for where, shape in shapes:
            xn, _ = _rows(gen, shape)
            n = xn.numel()
            got, want = kernel(xn, 1.0, bits=bits), plain(xn, 1.0, bits, 10.0)
            if bits <= 4:
                got, want = unpack_nibbles(got, n), unpack_nibbles(want, n)
            _code_flips(
                got.reshape(-1),
                want.reshape(-1),
                _near_half(xn, bits).reshape(-1),
                f"{name} b={bits} {where} {shape}",
            )
            b_ms, b_by = bound_ms(n * 4 + n * bits // 8, n * QUANT_OPS, "f32")
            ms = cuda_ms(lambda: kernel(xn, 1.0, bits=bits), 50)
            pl = cuda_ms(lambda: plain(xn, 1.0, bits, 10.0), 20)
            print(f"    {ms:.5f} ms, bound {b_ms:.5f} ({b_by}), plain {pl:.5f}")
            emit({"kernel": name, "tp": where, "shape": list(shape), "ms": ms,
                  "bound_ms": b_ms, "plain_ms": pl})  # fmt: skip
    # #4 over a rank's leaf of one layer: (r1) 4 x 4 x 1040 rows of 128 B,
    # (r3) 4 x 520 ckv rows of 512 B, (r4) 4 x 12 x 1104 rows of 32 B (q4)
    for where, rows, d, bits in (
        ("r1", 4 * 4 * seq, 128, 8),
        ("r3", 4 * seq // 2, 512, 8),
        ("r4", 4 * 12 * music, 64, 4),
    ):
        nb = d * bits // 8
        c = torch.randint(-128, 128, (rows, nb), generator=gen, device="cuda")
        c = c.to(torch.int8)
        sc = torch.rand((rows, 1), generator=gen, device="cuda")
        got = log_dequantize_rows_cuda(c, sc, bits=bits)
        want = ref.log_dequantize_rows_ref(c, sc, bits, 10.0)
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).masked_fill(
            want == 0, 0
        )
        check(float(rel.max()) <= 1e-6, f"dequant {where}: rel {float(rel.max())}")
        b_ms, b_by = bound_ms(rows * (nb + 4 + d * 4), rows * d * DEQUANT_OPS, "f32")
        ms = cuda_ms(lambda: log_dequantize_rows_cuda(c, sc, bits=bits), 50)
        pl = cuda_ms(lambda: ref.log_dequantize_rows_ref(c, sc, bits, 10.0), 20)
        print(
            f"  log_dequantize_rows {where} ({rows} rows of {nb} B): max rel "
            f"{float(rel.max()):.2e}; {ms:.5f} ms, bound {b_ms:.5f} ({b_by}), "
            f"plain {pl:.5f}"
        )
        emit({"kernel": "log_dequantize_rows", "tp": where, "rows": rows, "ms": ms,
              "bound_ms": b_ms, "plain_ms": pl})  # fmt: skip
    # #6 on a rank's heads: (r1) 16 of jamba's 32 over 4 of its 8 KV heads;
    # (r3) 64 of deepseek's 128 at head_dim 192; (r4) 12 of musicgen's 24
    # over its prefix and prompt; (r5) one request's prefill bucket, 2 of
    # gemma3-1b's 4 query heads over its one KV head
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for where, b, hq, hkv, s, hd in (
        ("r1", 4, 16, 4, PROMPT, 128),
        ("r3", 4, 64, 64, PROMPT, 192),
        ("r4", 4, 12, 12, PROMPT + get_config("musicgen-medium").cond_len, 64),
        ("r5", 1, 2, 1, PROMPT, 256),
    ):
        q, k, v = (
            torch.randn((b, h, s, hd), generator=gen, device="cuda").bfloat16()
            for h in (hq, hkv, hkv)
        )
        got = flash_attention_cuda(q, k, v)
        want = ref.attention_ref(q.float(), k.float(), v.float())
        e = float((got.float() - want).abs().max())
        check(e <= 2e-2, f"flash_attention {where}: max err {e}")
        i = torch.arange(s, device="cuda")
        mask = i[None, :] <= i[:, None]
        pairs = int(mask.sum()) * b * hq
        n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        b_ms, b_by = bound_ms(n_bytes, 4 * hd * pairs, "bf16")
        ms = cuda_ms(lambda: flash_attention_cuda(q, k, v), 10)
        pl = cuda_ms(lambda: ref.attention_ref(q, k, v), 5)
        lib = cuda_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), 10)
        print(
            f"  flash_attention {where} q {list(q.shape)} k/v {list(k.shape)}: max "
            f"abs err {e:.2e}; {ms:.4f} ms, bound {b_ms:.4f} ({b_by}), plain "
            f"{pl:.4f}, SDPA {lib:.4f}"
        )
        emit({"kernel": "flash_attention", "tp": where, "shape": list(q.shape),
              "ms": ms, "bound_ms": b_ms, "plain_ms": pl, "library_ms": lib})  # fmt: skip
        del q, k, v, want, got
    # #7 on a rank's heads: (r1) 64 of jamba's 128 (state 16), (r2) 16 of
    # mamba2-370m's 32 (state 128) on a data rank's 2 rows
    for where, arch, batch in (("r1", "jamba-v0.1-52b", 4), ("r2", "mamba2-370m", 2)):
        cfg = get_config(arch)
        half = dataclasses.replace(cfg, d_model=cfg.d_model // 2)  # H / 2 heads
        h, q = half.ssm_heads, half.ssm_chunk
        x, a_cum, bm, cm = _ssd_inputs(gen, half, batch, PROMPT // q)
        got = ssd_chunk_cuda(x, a_cum, bm, cm)
        bh, ch = (t.expand(-1, h, -1, -1, -1) for t in (bm, cm))
        want = ref.ssd_chunk_ref(x, a_cum, bh, ch)
        err, top = float((got - want).abs().max()), float(want.abs().max())
        check(err <= SSD_REL_TOL * top, f"ssd_chunk ({where}): max err {err} of {top}")
        pairs = q * (q + 1) // 2
        groups = x.shape[0] * bm.shape[1] * x.shape[2]
        cells = x.shape[0] * h * x.shape[2]
        n_ops = pairs * (groups * 2 * cfg.ssm_state + cells * 2 * cfg.ssm_head_dim)
        n_bytes = 4 * (2 * x.numel() + bm.numel() + cm.numel() + a_cum.numel())
        b_ms, b_by = bound_ms(n_bytes, n_ops, "f32")
        ms = cuda_ms(lambda: ssd_chunk_cuda(x, a_cum, bm, cm), 10)
        pl = cuda_ms(lambda: ref.ssd_chunk_ref(x, a_cum, bh, ch), 3)
        print(
            f"  ssd_chunk ({where}) x {list(x.shape)}, N {cfg.ssm_state}: max abs "
            f"err {err:.2e}, {err / top:.2e} of max |Y|; {ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), plain {pl:.4f}"
        )
        emit({"kernel": "ssd_chunk", "tp": where, "shape": list(x.shape), "ms": ms,
              "bound_ms": b_ms, "plain_ms": pl})  # fmt: skip
        del x, a_cum, bm, cm, got, want


KERNEL_INFO = {
    "log_quantize": (
        "triton",
        "src/repro_torch/kernels/log_quant.py",
        "src/repro/kernels/log_quant.py:63",
    ),
    "log_quantize_pack": (
        "triton",
        "src/repro_torch/kernels/log_quant.py",
        "src/repro/kernels/log_quant.py:153",
    ),
    "log_dequantize_rows": (
        "cuda",
        "src/repro_torch/csrc/log_dequant_rows.cu",
        "src/repro/kernels/log_quant.py:215",
    ),
    "flash_attention": (
        "cuda",
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:75",
    ),
    "pack_nibbles": (
        "triton",
        "src/repro_torch/kernels/log_quant.py",
        "src/repro/kernels/log_quant.py:99",
    ),
    "log_dequantize": (
        "triton",
        "src/repro_torch/kernels/log_quant.py",
        "src/repro/kernels/log_quant.py:258",
    ),
    "ssd_chunk": (
        "cuda",
        "src/repro_torch/csrc/ssd_chunk.cu",
        "src/repro/kernels/ssd_chunk.py:45",
    ),
}


def main():
    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    measured = phase_kernels(gen)
    seconds = {"device_build_kernels": time.perf_counter() - t0}
    # (o), (p), (q), (r) first of the runs, in one torchrun a mesh: their
    # ranks share the card with this process while it holds little device
    # memory ((o4) takes 36 GB a rank, and after the other phases this
    # process held ~7 GB more, and a rank ran out; (q1)'s four ranks share
    # the card, (r3)'s two hold 15.8 B parameters)
    t = time.perf_counter()
    codec_launches, tp_seconds = phase_tp(card)
    seconds["ranks_o_p_q_r"] = time.perf_counter() - t
    seconds.update({f"ranks_{k}": v for k, v in tp_seconds.items()})
    t = time.perf_counter()
    launches = phase_serve(card, gen)
    seconds["serve"] = time.perf_counter() - t
    for name, c in codec_launches.items():
        launches[name] += c
    # (h) last: its (h2) graph = eager check holds after (i), (j) and (k)
    # since the attack's backward runs on one thread (core/privacy/gia.py)
    phases = (
        phase_zoo,
        phase_zoo_rest,
        phase_train,
        phase_ssm,
        phase_composite,
        phase_lm_train,
        phase_dryrun,
        phase_dist,
        phase_privacy,
        phase_gia,
    )
    for phase in phases:
        t = time.perf_counter()
        for name, c in phase(card).items():
            launches[name] += c
        seconds[phase.__name__.removeprefix("phase_")] = time.perf_counter() - t
    seconds["total"] = time.perf_counter() - t0
    print("seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    print(f"disk writes: {_disk_writes_gb():.2f} GB (write_bytes, with reaped children)")
    emit({"phase_seconds": seconds, "card": card})
    kernels = []
    for name, (route, source, replaces) in KERNEL_INFO.items():
        entry = {
            "name": name,
            "route": route,
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            **measured[name],
        }
        emit({"kernel": name, "card": card, "kernel_ms": entry["ms"], **entry})
        kernels.append(entry)
    emit({"kernels": kernels})
    emit(
        {
            "ok": True,
            "device": {
                "platform": "gpu",
                "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count(),
            },
        }
    )


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-spawn-rank"]:  # one rank of an (o)-(r) torchrun
        tp_spawn_rank_main(sys.argv[2], sys.argv[3])
    else:
        main()
