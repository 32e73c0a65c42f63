#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sharetrade_tpu_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases build,kernels

Phases, in order (any failure exits non-zero before the final line):

1. device    — refuse to run without CUDA; print the card's name and power
               limit as ``nvidia-smi`` reports them.
2. build     — compile every CUDA source of the package (one ``nvcc`` per
               source, all started together); print the build time and each
               kernel's registers, spill bytes and static shared memory
               from the ``-Xptxas -v`` log (``flash_bwd_dq_wgmma``'s per
               head dim and cluster size on their own).
3. kernels   — hold each kernel against its plain PyTorch version (computed
               in float32 from the same inputs) at the shapes the main paths
               give it and the other shapes its TPU counterparts served;
               time kernel, plain version and the library yardstick with
               CUDA events (median device time, L2 flushed before every
               launch, the host one call ahead of the device); then, untimed,
               the bf16 edge cases (T < 64 and ragged T, window 1, D = 64,
               D = 32 padded to 64, non-causal tq != tk, B*H > 64); print
               one JSON line per case
               (``flash_bwd_dq``'s with the cluster size it launched and
               whether a second call gave the same bits).
4. train     — the training main path: PPO on the flagship episode
               transformer at full width (512 agents, unroll 1024, L=2,
               H=2, Dh=128, window 201, bf16_mixed, adagrad), seeded random
               weights and synthetic prices, two chunks. Kernel launch
               counts are reset just before and read after each chunk; the
               second chunk is broken down with CUDA events (trunk, rollout
               loop, GAE, replay forward/backward, update); then one
               minibatch's replayed log-probabilities and values, loss
               terms and gradients through the kernels are held against
               the same minibatch through the plain attention, both
               measured against the fp32 model (see MB_FACTOR).
5. serve     — the serving main path: the serving engine on the same model
               (max_batch 64, slots 256), driven in closed loop through a
               warm phase and an eviction phase. Counts reset just before
               and read just after; the first cold batch's logits are held
               against the same batch through the plain attention.
5b. serve_tiers — the rest of the serving engine on the same flagship
               config, counts reset once just before and read just after:
               (a) 192 sessions in closed loop for 3 s while ``tag_best`` is
               saved at steps 1 and 2 and the swap watcher (polling every
               0.2 s) swaps them in: every tick names one step, no
               session's step goes back, and a first batch after the
               swaps agrees with the plain attention under the new
               weights; then, polled by hand, a candidate with one byte
               flipped is refused (quarantined, serving on) and
               ``swap_breaker_failures`` more open the breaker once;
               (b) 320 sessions over the 256 slots with a warm store of
               ~160 carries, fed batch by batch the exact sequence an
               engine with a slot for every session answered: every
               answer bit-equal, parks and warm hits, ``flash_fwd``
               launches = layers x cold ticks (none for a re-install), the
               page-out and install device ms per tick, one carry's
               bytes; then 3 s of closed loop at 320 sessions with the
               tier and without it (qps, p99, cold share); (c) the same
               with ~8 carries in RAM and the rest spilled to disk: every
               answer bit-equal, a corrupted record lands cold (bit-equal
               to a fresh session), and after ``stop`` and
               ``page_out_all`` a second engine adopts every session warm
               through its session clock, bit-equal to the never-evicted
               engine continuing; (d) open loop at twice (b)'s closed-loop
               qps with ``max_queue=64``, ``shed_policy=oldest`` and 50 ms
               deadlines: completed + failed = offered - dropped and
               failed = shed + expired; (e) ``max_restarts=2``: a
               malformed observation rebuilds the engine (the warm session
               then answers as a fresh one, bit for bit), and a storm of
               them ends in ``ServeEngineFailed`` with a clean ``stop``;
               (f) ``BatchOneServer`` at concurrency 1 for 3 s, and ``cli
               serve --rate`` with (d)'s knobs.
5c. serve_slo — serving's telemetry and control loop on the same flagship
               config, counts reset once just before and read just after;
               nothing is caught: (a) 192 sessions in closed loop for 2 s
               with stats every 0.5 s: every answer's stages sum to its
               latency, the decomposition counter 0, the end-to-end
               histogram counting every response, its p50 / p99 within a
               bucket of the nearest-rank ones, ``serve_p99_ms`` published
               in every window with completions, ``flash_fwd`` = layers x
               cold ticks; (b) ``set_knobs`` above config clamps to it, and
               ``set_knobs(0.5, 64)`` halfway through another 2 s closed
               loop retargets the queue bound and the ``serve_knob_*``
               gauges; every answer of (a) and (b), replayed tick by tick
               through an engine on the plain attention, within
               ``LOGIT_ATOL`` / ``VALUE_ATOL``; (c) the online controller
               (target half of (a)'s p99 kept within 40-50 ms,
               ``SLO_TARGET_BOUNDS_MS``; a tick every 0.25 s) over 320
               sessions in open loop at twice (a)'s qps with ``max_queue``
               256, shed-oldest and 50 ms deadlines for 4 s, then at a
               light rate for 4 s (a tenth of that rate, halved until a
               1 s probe's windows sit under the re-arm line,
               ``SLO_LIGHT_FRAC``): it tightens, then grows back,
               every knob read at or under config, every adjustment
               counted, the outcomes reconciling exactly; (d) on the same
               engine (``obs.slo_availability=0.999``, the target as
               ``obs.slo_target_p99_ms``, a 1 s window): the availability
               burn past its threshold under overload and 0 in a clean
               window, the latency burn positive whenever the window's p99
               is over the target, the exemplar ring bounded with every
               split summing to its latency; (e) ``tools/torch_autotune.py
               --quick --spec serve`` on the card, ``cli serve`` at the
               defaults under its profile with the controller (the JAX
               summary's ``controller_adjustments``, ``stage_p99_ms``,
               ``slowest``; the profile's ``serve.max_batch`` in the ready
               line; ``describe`` naming the profile), a copy of the
               profile with ``"backend": "tpu"`` refused with exit code 2,
               and ``cli train`` at the defaults under a profile setting
               ``runtime.megachunk_factor=4`` (runs ``fused_update``).
6. cli       — ``python -m sharetrade_tpu_torch.cli serve`` for a few seconds.
7. cli_train — ``python -m sharetrade_tpu_torch.cli train`` on the flagship
               config with a 2,249-price series (one 2-chunk episode); it
               must end on the eager step's portfolio digits
               (``FLAGSHIP_DIGITS``).
8. resilience — checkpoints, supervision and evaluation at the flagship,
               one save per chunk (``runtime.checkpoint_every_updates=16``),
               the 2,249-price series: (a) two uninterrupted 2-chunk runs,
               whose largest leaf difference is the nondeterminism floor
               (ops named when it is not 0); (b) preempted after chunk 1,
               resumed from ``tag_preempt``; (c) a fault in chunk 2 and a
               supervised restart; (d) one agent's budget NaN after chunk 1,
               healed in place; (e) one byte of the newest ``state.npz``
               flipped, then resumed (quarantine and walk-back); (b), (c)
               and (e) end within the floor of (a); (f) the greedy replay
               on the 6,046-tick series, timed alone, then ``evaluate()``
               with its ``tag_best`` save timed on its own: ``flash_fwd``
               over the whole episode's trunk (its T printed) in each;
               (g) ``cli train --eval``,
               then ``cli serve`` from the same checkpoint directory boots
               from ``tag_best``. Prints the checkpoint's bytes, the save's
               loop-thread and writer-thread times, a verified restore's
               time, and, in one 4-chunk run saving every 32 updates, the
               chunk beside a save's writer against the chunks without.

9. reference — the reference workload, the JAX package's defaults at full
               width (the 203 -> 200 -> 3 Q-network, Q-learning, 10 workers,
               200-step chunks, adagrad, the 6,046-tick series): (a) one
               whole episode through the orchestrator, its final partial
               chunk included, then the greedy eval; (b) one more chunk
               split by CUDA events (selection + env, TD forward, backward,
               update), and one under ``torch.profiler`` (the device's busy
               share); (c) two chunks each of DQN (uniform and PER), PG and
               A2C; (d) DQN preempted after chunk 2 and resumed, against
               two uninterrupted runs. Counts reset before (a) and read
               after (c): ``fused_update`` once per env step of the
               Q-learners and once per PG/A2C update. Prints agent-steps/s,
               chunk ms, launches per chunk, the DQN save's bytes and time.
10. pipeline — the chunk as a CUDA graph (``agents/base.py``
               ``ChunkProgram``) and the orchestrator's default hot loop:
               (a) the reference workload's episode over the series'
               first ``PIPELINE_PRICES`` ticks (nine chunks and a partial
               tenth) eagerly (``agent.step``), then through the
               orchestrator at its defaults (an eager first chunk, then
               one graph replay a chunk, the async readback pipeline, a
               sample every 10 chunks), at K=8, and at K=8 with double
               buffering: each bit-equal to the eager episode and ending
               on its portfolio mean and std; chunk ms and agent-steps/s
               of each, the capture's seconds and graph nodes, launches per
               replay, and of a replayed chunk its CUDA-event time and
               ``torch.profiler`` busy share; (b) three chunks each of DQN,
               PER, PG and A2C and (c) of the flagship PPO, eager against
               graph (the third a plain replay): bit-equal states and
               metrics, the same launches per chunk (34/32/32/16 at the
               flagship), chunk ms, capture seconds, graph nodes and peak
               device memory of each, and the flagship's replayed chunk
               timed and profiled as in (a).
11. journal  — DQN's transition journal at the JAX defaults
               (``learner.algo=dqn``, ``learner.journal_replay=true``:
               q_mlp 203 -> 200 -> 3, 10 agents, 200-step chunks,
               replay_capacity 65,536, replay_batch 256, the 5,845-step
               series) through the orchestrator's defaults: (a) one
               episode each of uniform replay and PER, counts reset just
               before and read just after: records, rows against the
               expected 58,450, stamps strictly increasing, and the rows,
               decoded, equal to the final replay buffer's bit for bit
               (each pushed row journaled exactly once), 200 fused_update
               launches a replay; (b) the first four chunks eagerly,
               encoded as the orchestrator journals them, byte-equal to
               the graph run's first four records; (c) preempted after
               chunk 10 and resumed: the warm-started buffer equals the
               checkpoint's bit for bit (uniform and PER), and the uniform
               run ends bit-equal to (a)'s with no stamp journaled twice;
               (d) a fault-hook restart and a heal: stamps increasing,
               every pushed row journaled once, the restart bit-equal to
               (a); (e) the episode journaled and not, a replayed chunk of
               each by CUDA events, a chunk's readback ms and bytes, the
               host's append ms; (f) ``cli train --device cuda`` with no
               ``--set`` and ``cli query --symbol MSFT`` in a fresh working
               directory, whose price journal the port's service recovers.
12. cli_defaults — ``cli train --eval`` and ``cli serve`` with no ``--set``
               but the checkpoint directory; train must end on
               ``REFERENCE_DIGITS``, serve boots from train's ``tag_best``
               with the swap watcher running and nothing unported.
13. families — the other policy families at full width (``FAMILIES``:
               the window transformer L 2, H 4, Dh 64 fp32 and H 2, Dh 128
               bf16, with unroll 32; with an 8-expert MoE FFN, top-2 and
               top-0; the LSTM (hidden 200) and the TCN (64 channels, 7
               blocks) with unroll 128; the window transformer over the
               2-asset MSFT/AAPL portfolio, 405 inputs, 5 actions, 404
               tokens), 10 agents, PPO: (a) three chunks eagerly, each
               kernel's launches per chunk (the three attention kernels
               must launch on every transformer), chunk ms and losses,
               then the same three chunks through the orchestrator's
               defaults (no restarts allowed) over a series of exactly
               three chunks, bit-equal, with the same launches, the
               capture's seconds and graph nodes, then three more replays
               timed alone; (b) for the transformers, one replay minibatch
               through the kernels and the plain attention (``MB_*``);
               (c) the serving engine on each family: 64 sessions for 4
               ticks (one cold, three warm), every device batch against the
               plain path on its own rows and, but for the MoE top-2 whose
               routing spans the batch, every answer against the plain
               model stepped session by session with its carry threaded
               (``FAMILY_SERVE_ATOL`` per compute dtype), then 2 s in
               closed loop (qps, p50, p99), and ``cli serve`` for 2 s on
               each (the portfolio: ``cli train --symbol MSFT,AAPL`` over
               three chunks), the seven CLI runs at once after the
               in-process runs; (d) ``flash_fwd`` (and at the replay's bh the
               backward) at the window shapes, timed beside SDPA with
               ``is_causal``, and ``fused_update`` over each family's
               leaves (``FAMILY_UPDATE_CASES``) against its plain version.

14. fleet    — the serving fleet on the same flagship serving config, two
               ``cli serve --listen`` workers time-slicing the one card (so
               this measures the tier's overhead and correctness, not
               scale-out): (a) ``cli fleet`` as a user runs it (an empty
               checkpoint directory: both workers boot the seeded init),
               192 sessions in closed loop for 3 s through ``WireEngine``
               in a client process of its own (qps, client p50 / p99, the
               router's merged ``fleet_request_ms``, and the CPU seconds
               each process spent meanwhile: client, router, workers, this
               process and the busiest others); (b) 32 sessions x 8 steps through the
               router, one request in flight each, against an in-process
               engine fed the same sequences (``LOGIT_ATOL`` /
               ``VALUE_ATOL``); the relay overhead (sequential p50 through
               the router minus straight to one worker); SIGTERM: exit 75,
               requests = completed + refused, nothing unrouted, each
               worker's summary with ``flash_fwd`` launches; (c) in this
               process, ``EnginePool`` + ``FleetRouter`` + ``ServeFrontend``
               with a shared spill arena: one worker SIGKILLed under 192
               sessions in closed loop (every request one outcome,
               migrations, the victim respawned once, two endpoints again),
               then ``pool.scale(1)``: the retired worker pages out, the
               survivor adopts warm (``serve_adopt_warm_total``) and every
               answer before and after stays within the bf16 tolerances of
               an in-process engine. The fleet's ``flash_fwd`` launches are
               the workers' own counts (each worker's summary). Telemetry
               (d): (a) runs with ``obs.enabled`` (the router journals as
               ``fleet``, the workers as ``engine-<id>``): ``cli obs
               --trace list`` is non-empty, every trace that spans the
               router and a worker stitches with no error (one rendered by
               ``cli obs --trace <id> --out``), and ``cli obs --dir <fleet
               dir> --history`` reads the router's rows; (c) journals its
               spans (``obs.span_dir``, obs otherwise off): after the
               SIGKILL ``migrated_traces`` finds at least the migrated
               requests, each stitched with no error.
15. remat_moe — the episode transformer's mixture of experts and
               rematerialisation, counts reset before each part and read
               before its comparisons: (a) the flagship with an 8-expert
               MoE FFN (``MOE_FLAGSHIPS``), dense-mask top-1 and capacity
               top-2: three chunks eagerly and through the chunk program,
               bit-equal, each chunk the flagship's launches
               (34/32/32/16), the replay's ms; one minibatch through the
               kernels against the plain attention (``MB_*``) with its
               balance loss > 0; served as the families are (every batch
               against the plain path; at top-0 every session's answers
               against the plain lockstep ``apply_batch``), and ``cli
               serve`` at top-2. Here (not in the families phase) every
               plain and fp32 pass of the MoE takes the routing of the
               same pass through the kernels (``_routing``): in bf16 a
               near tie in the gate flips between the two attention
               paths. The decisions so overridden are held by
               ``_flip_check`` (kernel-vs-plain flips at most
               ``MB_FACTOR`` times plain-vs-fp32 flips plus ``MB_FLOOR``
               of all decisions), and the kernels' rerun of each served
               batch must give the served answers bit for bit; (b)
               ``ppo_transformer_b1024_bf16`` (``B1024``) with
               ``learner.remat`` on and off and (c)
               ``ppo_tr_episode_large_d1024`` (``D1024``) with
               ``model.remat_blocks`` on and off, each from the same
               seeded state through a chunk program (``_eager_vs_graph``,
               graph mode: eager, capture, then one plain replay at b1024
               and three at d1024, ``B1024_CHUNKS``): per chunk ms,
               launches against ``_expected_launches`` (a checkpointed
               pass runs ``flash_fwd`` again in its backward) and peak
               device memory; the median replay's agent-steps/s and MFU
               (``utils/flops.py`` against the card's data-sheet peak)
               and the recompute's price (the remat replay's
               agent-steps/s over the plain one's); the final states
               bit-equal or within ``MB_FLOOR`` of each leaf's change
               (reported which); remat must show more ``flash_fwd``
               launches and a lower peak; then one minibatch of the remat
               configuration through the kernels against the plain
               attention and fp32 (``MB_*``); (d) the attention kernels
               at (b)'s and (c)'s grids (``REMAT_ATTENTION_CASES``) and
               fused_update over d1024's and the top-2 MoE flagship's
               leaves (``REMAT_UPDATE_CASES``) against their plain
               versions, timed.
16. actors   — actors and the flywheel at the reference workload's width
               (``ACTORS``: the JAX defaults under DQN, two actors), the
               CLIs run as a user runs them, ``cli learner`` and ``cli
               fleet --learner`` (``FLYWHEEL``, one engine) started
               together: (e) once the fleet is ready, journaling sessions
               over the wire until a response names weights newer than the
               engine booted with, then SIGTERM (exit 75, served rows
               ingested, no learner restart); (a) ``learner_ready``, both
               actors alive in ``status.json`` with their rows growing
               (rows/s per actor); (c) a0 SIGKILLed: respawned,
               ``restarts_total`` = 1 injected, the learner's pid
               unchanged, a0's stamps continuing past its high-water; while
               it respawns, (b) in this process a DQN learner on the card
               over the live actors' journals, uniform and PER: after an
               ingest tick (its rows and ms) the replay buffer's size
               grown by the rows read and the last row read just behind
               its write position, then one replayed chunk bit-equal to an
               eager chunk from a copy of the same state and generator;
               (d) every live actor's ``params_step`` past its boot
               weights once the learner republishes ``tag_best``, and
               in this process an actor from a seeded init given
               ``tag_best`` while its capture chunk runs: each replayed
               chunk's greedy actions equal the argmax of a plain forward of
               that chunk's weights (the chunk replay timed); (f) the
               ``scale`` file retires a1, the learner ingests up to the
               last stamp of a1's drained journal (the final ingest), then
               SIGTERM drains the learner (exit 75, both actors retired,
               no actor pid left in ``/proc``); from the learner's events
               (``cli learner --events``), per actor and tick: read on from
               the cursor the last tick left, 10 rows a counted env step
               from its first record to its new cursor, and where that
               record starts past the cursor the rows between retired
               unread (none of them still in the journal; reported); the
               ticks' sums the learner's counts, and a1's cursor at its
               drained journal's high-water; the learner's episode times
               and ingest ticks from its events. ``fused_update``'s
               launches are the two CLI learners' own counts (each process
               counts from 0).

17. obs      — telemetry on the card, counts reset once just before and
               read just after (``cli train``'s from its summary): (a) ``cli
               train`` with ``obs.enabled`` on the flagship (``OBS_TRAIN``:
               every chunk read back) over ``OBS_CHUNKS`` chunks: every
               chunk's ``dispatch``, ``readback`` and ``host_process``
               spans, ``manifest.json`` naming the card and the config's
               hash, ``metrics.prom`` parsing with ``train_chunk_seconds``
               counting the chunks, ``cli obs --dir`` printing the
               manifest, trace and metrics sections, and the kernels'
               launches per chunk those of the obs-off runs of (b); (b) in
               this process, from one seeded state, obs off, on, on, off
               (``OBS_TURNS``): an episode of ``OBS_TURN_CHUNKS`` chunks
               (the eager first chunk and the capture), then an episode of
               replays under ``torch.profiler`` with each dispatch between
               CUDA events: the final parameters bit-equal, the same
               device syncs and device-to-host copies per chunk
               (``_SYNC_CALLS``, ``Memcpy DtoH``), the same launches per
               chunk and graph nodes; each turn's replayed chunk ms and
               agent-steps/s are reported, with no limit; (c) the flagship
               served with obs off, on, on, off at 192 sessions in closed
               loop (qps, p50, p99 of each), then an open-loop overload of
               ``OBS_OVERLOAD_SESSIONS`` sessions on the obs engine: every
               terminal outcome traced (``serve_request`` spans = requests,
               the sheds among them), every completed request's four stage
               spans inside its envelope, the decomposition counter 0,
               ``serve_exemplars.json`` written; (e) a fault at chunk
               ``OBS_FAULT_CHUNK`` of the reference workload through the
               fault hook: one restart and ``flight_recorder.json`` with
               reason ``supervision`` and that chunk.

Every price read journals into a fresh scratch directory, and every CLI
run works in a fresh scratch directory (the checkout on ``PYTHONPATH``):
nothing is written into the checkout's ``journal/``, and no run recovers a
series that a run with another ``data.synthetic_length`` journaled.

The orchestrator-driven steps (``cli_train``, ``resilience``, ``reference``
(a) and (d), ``cli_defaults``) run the chunk program at the defaults: one
CUDA graph replay a chunk after an eager first chunk.

Opt-in: ``profile`` (a serving device-time breakdown).

Then a ``{"phase_seconds": {...}}`` line (each phase's wall seconds), one
``{"kernels": [...]}`` line, and last the
``{"ok": true, "device": {...}}`` line. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

PHASES = ("build", "kernels", "train", "serve", "serve_tiers", "serve_slo",
          "cli",
          "cli_train",
          "resilience", "reference", "pipeline", "journal", "cli_defaults",
          "families", "fleet", "remat_moe", "actors", "obs")
#: Opt-in phases (name them in --phases): a device-time breakdown of one
#: cold and one warm serving tick.
EXTRA_PHASES = ("profile",)

#: Published H100 SXM peaks (NVIDIA data sheet): memory bandwidth and the
#: compute rate for each input type (bf16 on the tensor cores; float32 on
#: the FMA units, which is what the f32 path of the kernel uses).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

#: Tolerances, kernel against the plain version computed in float32 from
#: the same inputs: |out - ref| <= atol + rtol * |ref|. float32: both sum
#: the same products in f32, in another order. bfloat16: the kernel rounds
#: its output to bf16 (half an ulp, 2^-9 relative) and rounds P to bf16
#: before P.V as the TPU kernel does (absolute noise of a few 1e-3 on
#: outputs of order 1); rtol is one bf16 ulp, 2^-7.
ATOL = {"float32": 2e-5, "bfloat16": 4e-3}
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}
LSE_ATOL = {"float32": 1e-4, "bfloat16": 1e-3}

#: bf16 serving: the first cold batch through the kernel vs through the
#: plain attention, both in the bf16 model. The two attention outputs
#: differ by bf16 roundings; the trunk and heads (policy std 0.01, value
#: He-normal) carry that into logits of order 0.1 and values of order 1.
LOGIT_ATOL = 2e-2
VALUE_ATOL = 5e-2

#: Backward kernels against the plain backward computed in float32 from the
#: same inputs (lse and delta from the plain forward), on dq, dk and dv.
#: float32: |err| <= 5e-5 + 1e-5 * |ref| (the same f32 products summed in
#: another order over up to 8,192 rows). bfloat16: the kernels round dS
#: (and P for dV) to bf16 before their products, as the TPU kernels do, and
#: round their outputs to bf16; on random inputs of unit scale that alone
#: moves a gradient by up to ~1.5e-2 from the float32 reference, the same
#: for the plain backward run in bf16 on the same inputs (which makes the
#: same roundings). So a bf16 kernel passes when its largest error against
#: the float32 reference is at most twice the plain bf16 backward's
#: largest error, plus 1e-3 (the check FlashAttention's own tests make).
BWD_ATOL_F32, BWD_RTOL_F32 = 5e-5, 1e-5
BWD_BF16_FACTOR, BWD_BF16_ATOL = 2.0, 1e-3

#: fused_update against its plain version on the same leaves: the kernel
#: uses IEEE 1/sqrt where the plain adagrad uses torch.rsqrt (within 2 ulp
#: on the card), which moves a master by at most about one ulp; adam and
#: sgd round every operation identically.
UPDATE_ATOL, UPDATE_RTOL = 1e-6, 1e-6

#: One PPO minibatch of the flagship, three ways on the card: the bf16 model
#: through the kernels, the bf16 model through the plain attention, and the
#: fp32 model through the plain attention (the reference). For the replayed
#: log-probabilities and values (largest absolute error), each gradient
#: leaf (L2 norm of the error) and the value and entropy terms, the kernel
#: path's error against the reference must be at most MB_FACTOR times the
#: plain bf16 path's, plus MB_FLOOR times the reference's own size (max
#: |x|, the leaf's L2 norm, |term|): both bf16 paths share every rounding
#: outside the attention, so a fault in the attention shows as an error well
#: past the plain path's. The policy term sits near 0 (ratios ~1 on
#: normalised advantages), so it is held by the bound its formula gives: the
#: clipped surrogate moves by at most |adv| * |ratio change| per step, so
#: the kernel and plain terms may differ by at most the active mean of
#: |adv| * |ratio_kernel - ratio_plain| (plus MB_POLICY_SLACK for the f32
#: sums), with the ratios taken from the log-probabilities checked above.
MB_FACTOR = 2.0
MB_FLOOR = 2.0 ** -8
MB_POLICY_SLACK = 1e-6

#: The training main path: ppo_tr_episode_b512_u1024_bf16
#: (benchmarks/run_all.py) at full width, depth and width uncut.
FLAGSHIP_TRAIN = [
    "learner.algo=ppo", "model.kind=transformer", "model.seq_mode=episode",
    "model.num_layers=2", "model.num_heads=2", "model.head_dim=128",
    "env.window=201", "precision.mode=bf16_mixed",
    "parallel.num_workers=512", "learner.unroll_len=1024",
    "runtime.chunk_steps=1024",
]
TRAIN_CHUNKS = 2

#: The resilience phase: the training path at one save per chunk on the
#: 2,249-price series (horizon 2,048: one episode of two chunks), with a
#: short backoff so a restart does not wait seconds.
RESILIENCE = FLAGSHIP_TRAIN + [
    "data.synthetic_length=2249", "runtime.checkpoint_every_updates=16",
    "runtime.backoff_initial_s=0.01", "runtime.backoff_max_s=0.05"]
#: The loop thread's part of a save (host enqueue + the device copy it
#: makes the next chunk wait for) may take at most this share of a chunk.
SAVE_LOOP_SHARE = 0.10


def _print(obj) -> None:
    print(json.dumps(obj), flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


_L2_FLUSH: list = []


#: GPU cycles of the sleep queued ahead of a timed call (about 1 ms).
_HOST_AHEAD_CYCLES = 2_000_000


def _time_ms(torch, fn, *, warmup: int = 3, iters: int = 25,
             host_ahead: bool = True, clean_l2: bool = False) -> float:
    """Median milliseconds of ``fn`` over ``iters`` CUDA-event-timed runs,
    each after writing 128 MB (the 50 MB L2 flushed, outside the timing).
    The L2 then holds up to 50 MB of dirty lines, which ``fn`` writes back
    as it evicts them; ``clean_l2`` flushes by reading the 128 MB instead,
    so ``fn`` moves only its own bytes (the time the bound describes).

    With ``host_ahead`` a ~1 ms GPU sleep is queued before the start event,
    so the host has enqueued ``fn``'s launches before the timer starts and
    the time is the device's alone (a call whose host side takes longer than
    the sleep still shows the excess). Without it, the time includes the
    host's enqueueing whenever the host is the slower side (the serving
    ticks of the profile phase, which are host-bound)."""
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(32 * 2 ** 20, dtype=torch.float32,
                                     device="cuda"))
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if clean_l2:
            _L2_FLUSH[0].sum()
        else:
            _L2_FLUSH[0].zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if host_ahead:
            torch.cuda._sleep(_HOST_AHEAD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(nbytes: float, ops: float, dname: str) -> dict:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dname] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops}


def _band_pairs(t: int, window: int | None) -> int:
    """(row, key) pairs a causal band of width ``window`` holds."""
    w = t if window is None else min(window, t)
    return sum(min(r + 1, w) for r in range(t))


def _demangle(names: list[str]) -> list[str]:
    """``kernel<args>`` for each mangled name (``c++filt`` where it exists;
    else the mangled name)."""
    import re
    import shutil
    tool = shutil.which("c++filt")
    if not tool or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    short = []
    for full in out:
        full = full.replace("(anonymous namespace)::", "")
        m = re.match(r"(?:void )?(?:\w+::)*(\w+(?:<[^(]*>)?)\(", full)
        short.append(m.group(1) if m else full)
    return short if len(short) == len(names) else names


def phase_build() -> dict:
    from sharetrade_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    per_source = cuda_build.build_all()
    seconds = time.perf_counter() - t0
    resources = {}
    for name in cuda_build.sources():
        usage = cuda_build.kernel_resources(name)
        for short, info in zip(_demangle(list(usage)), usage.values()):
            resources[f"{name}:{short}"] = info
    # flash_bwd_dq's bf16 kernel per <head_dim, cluster size>.
    dq_wgmma = {key.split(":", 1)[1]: {
        k: info.get(k) for k in ("registers", "spill_stores", "spill_loads",
                                 "stack")}
        for key, info in resources.items()
        if key.startswith("flash_bwd:flash_bwd_dq_wgmma")}
    return {"phase": "build", "seconds": seconds, "sources": per_source,
            "nvcc": cuda_build.nvcc_path(), "flash_bwd_dq_wgmma": dq_wgmma,
            "ptxas": resources}


def _host_us(torch, fn, calls: int = 50) -> float:
    """Host microseconds to enqueue one call of ``fn`` (the wrapper's
    checks, the tensor-map encoding, the launch), with the device held busy
    by a sleep so no call waits on it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50 * _HOST_AHEAD_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def check_flash_fwd(torch, *, name: str, batch: int, heads: int, seq: int,
                    head_dim: int, window: int | None, dtype,
                    causal: bool = True, kv_len: int | None = None,
                    timed: bool = True) -> dict:
    import torch.nn.functional as F

    from sharetrade_tpu_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(seq * 131 + head_dim)
    shape = (batch, heads, seq, head_dim)
    kv_shape = (batch, heads, kv_len or seq, head_dim)
    q = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(kv_shape, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    scale = head_dim ** -0.5
    before = attention.launch_counts["flash_fwd"]
    out, lse = attention.flash_fwd(q, k, v, causal=causal, sm_scale=scale,
                                   window=window)
    torch.cuda.synchronize()
    ref_out, ref_lse = attention._plain_forward(
        q.float(), k.float(), v.float(), causal, scale, window)
    dname = str(dtype).removeprefix("torch.")
    diff = (out.float() - ref_out).abs()
    err = diff.max().item()
    within = bool((diff <= ATOL[dname] + RTOL[dname] * ref_out.abs()).all())
    lse_err = (lse - ref_lse).abs().max().item()
    ok = (within and lse_err <= LSE_ATOL[dname]
          and bool(torch.isfinite(out).all()))
    row = {
        "phase": "kernels", "kernel": "flash_fwd", "case": name,
        "shape": list(shape), "kv_len": kv_shape[2], "causal": causal,
        "window": window, "dtype": dname, "max_abs_err": err,
        "tolerance": {"atol": ATOL[dname], "rtol": RTOL[dname]},
        "lse_max_abs_err": lse_err, "lse_tolerance": LSE_ATOL[dname],
        "launches": attention.launch_counts["flash_fwd"] - before, "ok": ok,
    }
    if not timed:
        return row

    kernel_fn = lambda: attention.flash_fwd(  # noqa: E731
        q, k, v, causal=causal, sm_scale=scale, window=window)
    kernel_ms = _time_ms(torch, kernel_fn)
    kernel_call_ms = _time_ms(torch, kernel_fn, host_ahead=False)
    plain_ms = _time_ms(torch, lambda: attention._plain_forward(
        q, k, v, causal, scale, window), iters=10)
    if window is None:
        lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=True, scale=scale)
    else:
        idx = torch.arange(seq, device="cuda")
        band = (idx[None, :] <= idx[:, None]) & \
            (idx[None, :] > idx[:, None] - window)
        lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=band, scale=scale)
    library_ms = _time_ms(torch, lib_fn, iters=10)

    elem = q.element_size()
    nbytes = 4 * q.numel() * elem + lse.numel() * 4
    ops = 4 * head_dim * batch * heads * _band_pairs(seq, window)
    row.update({
        "kernel_ms": kernel_ms, "kernel_call_ms": kernel_call_ms,
        "host_us_per_call": _host_us(torch, kernel_fn),
        "plain_ms": plain_ms,
        "library_ms": library_ms, **_bound(nbytes, ops, dname)})
    return row


def check_flash_bwd(torch, *, name: str, batch: int, heads: int, seq: int,
                    head_dim: int, window: int | None, dtype,
                    causal: bool = True, kv_len: int | None = None,
                    timed: bool = True) -> list[dict]:
    """flash_bwd_dq and flash_bwd_dkv against the plain backward in float32
    from the same inputs; one row per kernel."""
    import torch.nn.functional as F

    from sharetrade_tpu_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(seq * 17 + head_dim)
    shape = (batch, heads, seq, head_dim)
    kv_shape = (batch, heads, kv_len or seq, head_dim)
    q, dout = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for _ in range(2))
    k, v = (torch.randn(kv_shape, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    scale = head_dim ** -0.5
    qf, kf, vf, df = (x.float() for x in (q, k, v, dout))
    out, lse = attention._plain_forward(qf, kf, vf, causal, scale, window)
    delta = (df * out).sum(dim=-1)
    kw = dict(causal=causal, sm_scale=scale, window=window)
    before = dict(attention.launch_counts)
    dq = attention.flash_bwd_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = attention.flash_bwd_dkv(q, k, v, dout, lse, delta, **kw)
    before_repeat = attention.launch_counts["flash_bwd_dq"]
    torch.cuda.synchronize()
    ref = attention._plain_backward(qf, kf, vf, df, lse, delta, causal, scale,
                                    window)
    dname = str(dtype).removeprefix("torch.")
    if dtype == torch.float32:
        tolerance = {"atol": BWD_ATOL_F32, "rtol": BWD_RTOL_F32}
        plain_err = [0.0, 0.0, 0.0]
    else:
        plain = attention._plain_backward(q, k, v, dout, lse, delta, causal,
                                          scale, window)
        plain_err = [(p.float() - r).abs().max().item()
                     for p, r in zip(plain, ref)]
        del plain
        tolerance = {"factor_of_plain_bf16_err": BWD_BF16_FACTOR,
                     "atol": BWD_BF16_ATOL, "plain_bf16_err": plain_err}

    def err(got, want, j):
        diff = (got.float() - want).abs()
        worst = diff.max().item()
        if dtype == torch.float32:
            ok = bool((diff <= BWD_ATOL_F32 + BWD_RTOL_F32 * want.abs()).all())
        else:
            ok = worst <= BWD_BF16_FACTOR * plain_err[j] + BWD_BF16_ATOL
        return worst, ok and bool(torch.isfinite(got).all())

    common = {"phase": "kernels", "case": name, "shape": list(shape),
              "kv_len": kv_shape[2], "causal": causal, "window": window,
              "dtype": dname, "tolerance": tolerance}
    e_dq, ok_dq = err(dq, ref[0], 0)
    # dQ's sums run in a fixed order (bf16: a cluster's partial sums in
    # rank order), so a second call gives the same bits.
    repeat_equal = torch.equal(
        dq, attention.flash_bwd_dq(q, k, v, dout, lse, delta, **kw))
    ok_dq = ok_dq and repeat_equal
    e_dk, ok_dk = err(dk, ref[1], 1)
    e_dv, ok_dv = err(dv, ref[2], 2)
    rows = [{**common, "kernel": "flash_bwd_dq", "max_abs_err": e_dq,
             "launches": before_repeat - before["flash_bwd_dq"],
             "repeat_bitwise": repeat_equal, "ok": ok_dq,
             "cluster": attention.flash_bwd_dq_cluster(
                 q, k, causal=causal, window=window)},
            {**common, "kernel": "flash_bwd_dkv",
             "max_abs_err": max(e_dk, e_dv),
             "launches": attention.launch_counts["flash_bwd_dkv"]
             - before["flash_bwd_dkv"], "ok": ok_dk and ok_dv}]
    if not timed:
        return rows

    # The library yardstick: SDPA with the band mask (``is_causal`` where
    # the band is plain causal). Its backward alone (one forward kept,
    # autograd.grad timed with retain_graph) is the same function as the
    # two kernels together; forward + backward is kept beside it.
    idx = torch.arange(seq, device="cuda")
    band = idx[None, :] <= idx[:, None]
    if window is not None:
        band = band & (idx[None, :] > idx[:, None] - window)
    mask = (dict(is_causal=True) if window is None
            else dict(attn_mask=band))
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))

    def library_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, scale=scale, **mask)
        torch.autograd.grad(o, (qg, kg, vg), dout)

    lib_out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale,
                                             **mask)
    library_bwd_ms = _time_ms(torch, lambda: torch.autograd.grad(
        lib_out, (qg, kg, vg), dout, retain_graph=True), iters=10)
    library_fwd_bwd_ms = _time_ms(torch, library_fwd_bwd, iters=10)
    del lib_out
    elem = q.element_size()
    pairs = batch * heads * _band_pairs(seq, window)
    rows_bytes = 2 * batch * heads * seq * 4            # lse, delta
    library = {"library_bwd_ms": library_bwd_ms,
               "library_fwd_bwd_ms": library_fwd_bwd_ms,
               "library": "SDPA with the band mask (is_causal when "
                          "unbanded): backward alone "
                          "(library_bwd_ms), forward + backward "
                          "(library_fwd_bwd_ms); both kernels together"}
    dq_fn = lambda: attention.flash_bwd_dq(  # noqa: E731
        q, k, v, dout, lse, delta, **kw)
    dkv_fn = lambda: attention.flash_bwd_dkv(  # noqa: E731
        q, k, v, dout, lse, delta, **kw)
    rows[0].update({
        **library, "kernel_ms": _time_ms(torch, dq_fn),
        "kernel_call_ms": _time_ms(torch, dq_fn, host_ahead=False),
        "host_us_per_call": _host_us(torch, dq_fn),
        "plain_ms": _time_ms(torch, lambda: attention._plain_dq(
            q, k, v, dout, lse, delta, causal, scale, window), iters=10),
        # q, k, v, dO read, dQ written; S, dP, dQ products.
        **_bound(5 * q.numel() * elem + rows_bytes, 6 * head_dim * pairs,
                 dname)})
    rows[1].update({
        **library, "kernel_ms": _time_ms(torch, dkv_fn),
        "kernel_call_ms": _time_ms(torch, dkv_fn, host_ahead=False),
        "host_us_per_call": _host_us(torch, dkv_fn),
        "plain_ms": _time_ms(torch, lambda: attention._plain_dkv(
            q, k, v, dout, lse, delta, causal, scale, window), iters=10),
        # q, k, v, dO read, dK, dV written; S, dP, dV, dK products.
        **_bound(6 * q.numel() * elem + rows_bytes, 8 * head_dim * pairs,
                 dname)})
    return rows


def _model_params(torch, model: str = "flagship"):
    """A parameter tree on the card: the flagship's (34 leaves), the
    reference Q-network's (``q_mlp``, 203 -> 200 -> 3: 4 leaves, 41,403
    parameters), the actor-critic MLP's (``ac_mlp``: 8 leaves, 81,804
    parameters), a family's of ``FAMILIES`` at its full width (the
    portfolio's over 2 assets: 405 inputs, 5 actions) or one of
    ``REMAT_UPDATE_MODELS``."""
    from sharetrade_tpu_torch.models.mlp import ac_mlp, q_mlp
    from sharetrade_tpu_torch.models.transformer_episode import (
        episode_transformer_policy)
    if model in REMAT_UPDATE_MODELS:
        from sharetrade_tpu_torch.config import FrameworkConfig
        from sharetrade_tpu_torch.models import build_model
        cfg = FrameworkConfig().apply_overrides(REMAT_UPDATE_MODELS[model])
        return build_model(cfg.model, cfg.env.window + 2, device="cuda",
                           num_actions=3).init(
                               torch.Generator().manual_seed(0))
    if model in FAMILIES:
        from sharetrade_tpu_torch.config import FrameworkConfig
        from sharetrade_tpu_torch.models import build_model
        cfg = FrameworkConfig().apply_overrides(FAMILY_BASE + FAMILIES[model])
        assets = len(PORTFOLIO_SYMBOLS) if model == "ppo_portfolio" else 1
        return build_model(
            cfg.model, assets * cfg.env.window + 1 + assets, device="cuda",
            num_actions=2 * assets + 1, num_assets=assets).init(
                torch.Generator().manual_seed(0))
    build = {
        "flagship": lambda: episode_transformer_policy(
            203, 3, num_layers=2, num_heads=2, head_dim=128, device="cuda"),
        "q_mlp": lambda: q_mlp(203, 200, 3, parity=False, device="cuda"),
        "ac_mlp": lambda: ac_mlp(203, 200, 3, device="cuda"),
    }[model]
    return build().init(torch.Generator().manual_seed(0))


#: fused_update's cases in the kernels phase, timed (tools/torch_update_ab.py
#: runs the same cases against the parent's kernel).
UPDATE_CASES = [
    # The training path's case: adagrad, bf16 grads, and the next bf16
    # compute copy written by the same pass.
    dict(name="adagrad_bf16", optimizer="adagrad",
         grad_dtype="bfloat16", emit=True),
    dict(name="adam_f32", optimizer="adam", grad_dtype="float32"),
    dict(name="sgd_bf16", optimizer="sgd", grad_dtype="bfloat16"),
    # The reference workload's shapes: the Q-network's 4 leaves (a
    # 3-element bias among them) at every env step, and the
    # actor-critic MLP's 8 (a 1-element bias) at every PG/A2C update;
    # fp32 (the default) and bf16_mixed.
    dict(name="q_mlp_adagrad_f32", optimizer="adagrad",
         grad_dtype="float32", model="q_mlp"),
    dict(name="q_mlp_adagrad_bf16", optimizer="adagrad",
         grad_dtype="bfloat16", emit=True, model="q_mlp"),
    dict(name="ac_mlp_adagrad_f32", optimizer="adagrad",
         grad_dtype="float32", model="ac_mlp"),
    dict(name="ac_mlp_adagrad_bf16", optimizer="adagrad",
         grad_dtype="bfloat16", emit=True, model="ac_mlp"),
]


def update_inputs(torch, *, name: str, optimizer: str, grad_dtype: str,
                  model: str = "flagship", **_):
    """An update case's leaves on the card: (params, grads, state lists,
    adam's bias or None), grads of scale 0.05 in ``grad_dtype``, moments a
    few steps in, drawn from a generator seeded by the case."""
    from sharetrade_tpu_torch.models.core import tree_leaves
    from sharetrade_tpu_torch.ops import fused_update as fu

    gen = torch.Generator(device="cuda").manual_seed(len(name))
    params = tree_leaves(_model_params(torch, model))
    grads = [(torch.randn(p.shape, generator=gen, device="cuda") * 0.05)
             .to(getattr(torch, grad_dtype)) for p in params]
    n_state = {"adagrad": 1, "adam": 2, "sgd": 0}[optimizer]
    state = [[torch.rand(p.shape, generator=gen, device="cuda") * 0.01
              + (0.1 if optimizer == "adagrad" else 0.0) for p in params]
             for _ in range(n_state)]
    count = torch.tensor(3, dtype=torch.int32, device="cuda")
    _, bias = fu.adam_bias(count)
    return params, grads, state, bias if optimizer == "adam" else None


def check_fused_update(torch, *, name: str, optimizer: str, grad_dtype: str,
                       emit: bool = False, model: str = "flagship") -> dict:
    """fused_update over a model's leaf set against the plain per-leaf
    math on the same leaves, one step from a state three steps in; with
    ``emit`` the bf16 compute copy it writes must be the exact recast of
    the new masters. Timed: the kernel's device time, its call (host
    included), the host's µs a call, the plain version and torch.optim."""
    from sharetrade_tpu_torch.ops import fused_update as fu

    params, grads, state, bias = update_inputs(
        torch, name=name, optimizer=optimizer, grad_dtype=grad_dtype,
        model=model)
    n_state = len(state)

    def clone(leaves):
        return [x.clone() for x in leaves]

    def emitted():
        return ([torch.empty_like(p, dtype=torch.bfloat16) for p in params]
                if emit else None)

    p_k, s_k, c_k = clone(params), [clone(x) for x in state], emitted()
    before = fu.launch_counts["fused_update"]
    fu.fused_update(optimizer, 0.01, p_k, grads, s_k, bias=bias, compute=c_k)
    launches = fu.launch_counts["fused_update"] - before
    torch.cuda.synchronize()
    ok = not emit or all(torch.equal(c, p.to(torch.bfloat16))
                         for c, p in zip(c_k, p_k))
    errs = []
    for i, p in enumerate(params):
        p_ref, s_ref = fu._plain_leaf(optimizer, 0.01, p, grads[i],
                                      [x[i] for x in state], bias)
        for got, want in [(p_k[i], p_ref)] + [
                (s_k[j][i], s_ref[j]) for j in range(n_state)]:
            diff = (got - want).abs()
            errs.append(diff.max().item())
            ok = ok and bool((diff <= UPDATE_ATOL
                              + UPDATE_RTOL * want.abs()).all())

    p_t, s_t, c_t = clone(params), [clone(x) for x in state], emitted()
    kernel_fn = lambda: fu.fused_update(  # noqa: E731
        optimizer, 0.01, p_t, grads, s_t, bias=bias, compute=c_t)
    kernel_ms = _time_ms(torch, kernel_fn)
    kernel_clean_ms = _time_ms(torch, kernel_fn, clean_l2=True)
    kernel_call_ms = _time_ms(torch, kernel_fn, host_ahead=False)
    host_us = _host_us(torch, kernel_fn)

    def plain():
        for i, p in enumerate(p_t):
            p_new, _ = fu._plain_leaf(optimizer, 0.01, p, grads[i],
                                      [x[i] for x in s_t], bias)
            if emit:
                p_new.to(torch.bfloat16)

    plain_ms = _time_ms(torch, plain, iters=10)
    lib_params = [torch.nn.Parameter(p.clone()) for p in params]
    for lp, g in zip(lib_params, grads):
        lp.grad = g.float()
    if optimizer == "adagrad":
        opt = torch.optim.Adagrad(lib_params, lr=0.01,
                                  initial_accumulator_value=0.1, eps=1e-7,
                                  foreach=True)
    elif optimizer == "adam":
        opt = torch.optim.Adam(lib_params, lr=0.01, fused=True)
    else:
        opt = torch.optim.SGD(lib_params, lr=0.01, foreach=True)
    library_ms = _time_ms(torch, opt.step, iters=10)
    library_call_ms = _time_ms(torch, opt.step, iters=10, host_ahead=False)

    n = sum(p.numel() for p in params)
    g_bytes = grads[0].element_size()
    # p read + written, g read, each moment read + written, the bf16 copy
    # written.
    nbytes = n * (8 + g_bytes + 8 * n_state + (2 if emit else 0))
    flops = n * {"adagrad": 7, "adam": 16, "sgd": 2}[optimizer]
    return {"phase": "kernels", "kernel": "fused_update", "case": name,
            "model": model, "optimizer": optimizer,
            "grad_dtype": grad_dtype, "emit_compute": emit,
            "leaves": len(params), "parameters": n,
            "max_abs_err": max(errs),
            "tolerance": {"atol": UPDATE_ATOL, "rtol": UPDATE_RTOL},
            "kernel_ms": kernel_ms, "kernel_clean_l2_ms": kernel_clean_ms,
            "kernel_call_ms": kernel_call_ms, "host_us": host_us,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "library_call_ms": library_call_ms,
            "library": type(opt).__name__ + (
                " (fused)" if optimizer == "adam" else " (foreach)"),
            **_bound(nbytes, flops, "float32"),
            "launches": launches, "ok": ok}


def check_fused_update_gate(torch) -> dict:
    """``fused_apply``'s gate at the reference Q-network's leaves, adam
    (its count is the state a gate most easily forgets): a gate that is
    off leaves params, moments and count as they were, bit for bit, and
    writes the bf16 compute copy as the recast of the unchanged masters; a
    gate that is on gives what the ungated update gives, bit for bit.
    Held, not timed."""
    from sharetrade_tpu_torch.models.core import tree_leaves
    from sharetrade_tpu_torch.ops import fused_update as fu

    gen = torch.Generator(device="cuda").manual_seed(7)
    params = _model_params(torch, "q_mlp")
    grads = [torch.randn(p.shape, generator=gen, device="cuda")
             for p in tree_leaves(params)]
    results = {}
    for label, flag in (("off", False), ("on", True), ("none", None)):
        p = {k: {n: x.clone() for n, x in v.items()}
             for k, v in params.items()}
        state = fu.init_state("adam", p)
        state[0].count.fill_(3)
        gate = (None if flag is None
                else torch.tensor(flag, device="cuda"))
        _, _, compute = fu.fused_apply("adam", 0.01, grads, state, p,
                                       emit_compute=True, gate=gate)
        torch.cuda.synchronize()
        results[label] = (tree_leaves(p), tree_leaves(state[0].mu),
                          tree_leaves(state[0].nu), int(state[0].count),
                          tree_leaves(compute))
    orig = tree_leaves(params)
    off, on, plain = results["off"], results["on"], results["none"]
    ok = (off[3] == 3 and on[3] == 4 and plain[3] == 4
          and all(torch.equal(a, b) for a, b in zip(off[0], orig))
          and all(not bool(x.any()) for x in off[1] + off[2])
          and all(torch.equal(c, a.to(torch.bfloat16))
                  for c, a in zip(off[4], orig))
          and all(torch.equal(a, b) for part in (0, 1, 2, 4)
                  for a, b in zip(on[part], plain[part])))
    return {"phase": "kernels", "kernel": "fused_update", "case": "q_mlp_gate",
            "model": "q_mlp", "optimizer": "adam",
            "count_after": {k: v[3] for k, v in results.items()}, "ok": ok}


def _update_against_plain(torch, optimizer, params, grads, *, emit,
                          gate=None, seed=0) -> dict:
    """One fused_update of copies of ``params`` (moments drawn from
    ``seed``) against the plain per-leaf math: within UPDATE_ATOL/RTOL,
    the compute copy the exact recast of the new masters; with the gate
    off, masters and moments bit-equal to what they were."""
    from sharetrade_tpu_torch.ops import fused_update as fu

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_state = {"adagrad": 1, "adam": 2, "sgd": 0}[optimizer]
    state = [[torch.rand(p.shape, generator=gen, device="cuda") + 0.1
              for p in params] for _ in range(n_state)]
    _, bias = fu.adam_bias(torch.tensor(2, dtype=torch.int32, device="cuda"))
    bias = bias if optimizer == "adam" else None
    got_p = [p.clone() for p in params]
    got_s = [[x.clone() for x in s] for s in state]
    compute = ([torch.empty_like(p, dtype=torch.bfloat16) for p in params]
               if emit else None)
    before = fu.launch_counts["fused_update"]
    fu.fused_update(optimizer, 0.01, got_p, grads, got_s, bias=bias,
                    compute=compute, gate=gate)
    launches = fu.launch_counts["fused_update"] - before
    torch.cuda.synchronize()
    flag = None if gate is None else gate.reshape(()).bool()
    ok, err = True, 0.0
    for i, p in enumerate(params):
        want_p, want_s = fu._plain_leaf(optimizer, 0.01, p, grads[i],
                                        [s[i] for s in state], bias, flag)
        for got, want in [(got_p[i], want_p)] + [
                (got_s[j][i], want_s[j]) for j in range(n_state)]:
            diff = (got - want).abs()
            if diff.numel():
                err = max(err, diff.max().item())
            ok = ok and bool((diff <= UPDATE_ATOL
                              + UPDATE_RTOL * want.abs()).all())
        if compute is not None:
            ok = ok and torch.equal(compute[i], got_p[i].to(torch.bfloat16))
        if flag is not None and not bool(flag):
            ok = ok and torch.equal(got_p[i], p) and all(
                torch.equal(got_s[j][i], state[j][i]) for j in range(n_state))
    return {"ok": ok, "max_abs_err": err, "launches": launches}


def _graph_replay(torch, optimizer: str, emit: bool, gated: bool) -> bool:
    """``fused_apply`` captured once in a CUDA graph and replayed three
    times (the gate flipped on, off, on between replays) against three
    eager calls: masters, moments, adam's count and the compute copy
    bit-equal."""
    from sharetrade_tpu_torch.models.core import tree_leaves
    from sharetrade_tpu_torch.ops import fused_update as fu

    gen = torch.Generator(device="cuda").manual_seed(6)
    shapes = [(203, 200), (200,), (200, 3), (3,), (1025,)]
    init = {f"l{i}": torch.randn(s, generator=gen, device="cuda")
            for i, s in enumerate(shapes)}
    grads = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    flags = (True, False, True)
    gate = torch.tensor(True, device="cuda") if gated else None

    def fresh():
        p = {k: v.clone() for k, v in init.items()}
        return p, fu.init_state(optimizer, p)

    def step(p, state):
        return fu.fused_apply(optimizer, 0.01, grads, state, p,
                              emit_compute=emit, gate=gate)

    eager = fresh()
    for flag in flags:
        if gated:
            gate.fill_(flag)
        eager_out = step(*eager)
    graphed = fresh()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step(*graphed)
    torch.cuda.current_stream().wait_stream(side)
    for a, b in zip(tree_leaves(graphed), tree_leaves(fresh())):
        a.copy_(b)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        graph_out = step(*graphed)
    for flag in flags:
        if gated:
            gate.fill_(flag)
        graph.replay()
    torch.cuda.synchronize()
    pairs = list(zip(tree_leaves(graphed), tree_leaves(eager)))
    if emit:
        pairs += zip(tree_leaves(graph_out[2]), tree_leaves(eager_out[2]))
    return all(torch.equal(a, b) for a, b in pairs)


def check_fused_update_corners(torch) -> list[dict]:
    """fused_update's corner cases, held and not timed: leaves of odd sizes
    (0, 1, 3, 7, 8, 9, 1,023, 1,025: a scalar tail after the 16-byte units)
    and views at element offset 1 (the scalar path whole), a gate in its
    own dtype (bool and int32, off and on), more leaves than one launch
    takes, and fused_apply captured in a CUDA graph and replayed."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(n, dtype=torch.float32):
        return torch.randn(n, generator=gen, device="cuda").to(dtype)

    sizes = [0, 1, 3, 7, 8, 9, 1023, 1025]
    for optimizer, dname, emit in (("adagrad", "bfloat16", True),
                                   ("adam", "float32", True),
                                   ("sgd", "float32", False)):
        dtype = getattr(torch, dname)
        params = [randn(n) for n in sizes] + [randn(1026)[1:], randn(1026),
                                              randn(9)[1:]]
        grads = [randn(n, dtype) for n in sizes] + [
            randn(1025, dtype), randn(1027, dtype)[1:], randn(9, dtype)[1:]]
        rows.append({"case": f"odd_sizes_misaligned_{optimizer}_{dname}",
                     **_update_against_plain(torch, optimizer, params, grads,
                                             emit=emit)})
    shapes = [(203, 200), (200,), (200, 3), (3,)]
    params = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    grads = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    for dtype in (torch.bool, torch.int32):
        for value in (0, 1):
            gate = torch.tensor(value, device="cuda").to(dtype)
            rows.append({
                "case": f"gate_{str(dtype)[6:]}_{('off', 'on')[value]}",
                **_update_against_plain(torch, "adagrad", params, grads,
                                        emit=True, gate=gate, seed=5)})
    many = [randn(n) for n in [35] * 66 + [1, 3, 1000, 130 * 257]]
    row = _update_against_plain(torch, "adam", many,
                                [randn(p.numel()) for p in many], emit=True)
    rows.append({"case": "70_leaves", **row,
                 "ok": row["ok"] and row["launches"] == 2})
    for optimizer, emit, gated in (("adam", True, True),
                                   ("adagrad", False, True),
                                   ("sgd", True, False)):
        rows.append({"case": f"graph_replay_{optimizer}",
                     "ok": _graph_replay(torch, optimizer, emit, gated)})
    return [{"phase": "kernels", "kernel": "fused_update", **r} for r in rows]


def phase_kernels(torch) -> list[dict]:
    fwd_cases = [
        # The serving shape: a cold batch of 64 sessions, 2 heads, the
        # (L-1)*(W-1) + W = 401-tick prefill, band 201.
        dict(name="serving_bf16", batch=64, heads=2, seq=401, head_dim=128,
             window=201, dtype=torch.bfloat16),
        dict(name="serving_f32", batch=64, heads=2, seq=401, head_dim=128,
             window=201, dtype=torch.float32),
        # The training path: the rollout trunk (B = 1 representative, hist
        # 200 + window 201 + unroll 1024 = 1,425 ticks) and the replay
        # forward (1,424 ticks), band 201.
        dict(name="trunk_bf16", batch=1, heads=2, seq=1425, head_dim=128,
             window=201, dtype=torch.bfloat16),
        dict(name="replay_bf16", batch=1, heads=2, seq=1424, head_dim=128,
             window=201, dtype=torch.bfloat16),
        # The shape class the TPU's streaming kernel (K2) served.
        dict(name="long_banded_bf16", batch=2, heads=2, seq=8192,
             head_dim=128, window=201, dtype=torch.bfloat16),
        dict(name="causal_f32", batch=8, heads=4, seq=256, head_dim=64,
             window=None, dtype=torch.float32),
    ]
    bwd_cases = [
        # The training replay: B = 1 representative, 2 heads, hist 200 +
        # window 201 + unroll 1024 - 1 = 1,424 ticks, band 201.
        dict(name="replay_bf16", batch=1, heads=2, seq=1424, head_dim=128,
             window=201, dtype=torch.bfloat16),
        dict(name="replay_f32", batch=1, heads=2, seq=1424, head_dim=128,
             window=201, dtype=torch.float32),
        # The shape class of the TPU's streaming backward (K5/K6).
        dict(name="long_banded_bf16", batch=2, heads=2, seq=8192,
             head_dim=128, window=201, dtype=torch.bfloat16),
        dict(name="causal_f32", batch=8, heads=4, seq=256, head_dim=64,
             window=None, dtype=torch.float32),
    ]
    bf16 = torch.bfloat16
    # Corners of the bf16 (wgmma + TMA) kernels, held and not timed: shorter
    # than one tile, ragged tiles, each row seeing only itself, D = 64,
    # non-causal with tq != tk, more than 64 heads in the grid, a plain
    # causal band of up to 8 key tiles (flash_bwd_dq over a cluster of 2),
    # and D = 32 (zero-padded to the kernel's 64).
    edge_cases = [
        dict(name="t37_d64", batch=1, heads=1, seq=37, head_dim=64,
             window=None, dtype=bf16),
        dict(name="t130_window1", batch=2, heads=2, seq=130, head_dim=128,
             window=1, dtype=bf16),
        dict(name="t401_d64", batch=1, heads=2, seq=401, head_dim=64,
             window=201, dtype=bf16),
        dict(name="cross_100x257", batch=2, heads=2, seq=100, head_dim=64,
             window=None, dtype=bf16, causal=False, kv_len=257),
        dict(name="bh80_t130", batch=40, heads=2, seq=130, head_dim=128,
             window=None, dtype=bf16),
        # Plain causal over 8 query tiles: rank 0 of a pair walks 4 tiles.
        dict(name="t512_causal", batch=1, heads=2, seq=512, head_dim=128,
             window=None, dtype=bf16),
        # A head narrower than the built widths: padded to 64 and back.
        dict(name="t130_d32", batch=2, heads=2, seq=130, head_dim=32,
             window=33, dtype=bf16),
    ]
    rows = [check_flash_fwd(torch, **case) for case in fwd_cases]
    for case in bwd_cases:
        rows += check_flash_bwd(torch, **case)
    for case in edge_cases:
        rows.append(check_flash_fwd(torch, **case, timed=False))
        rows += check_flash_bwd(torch, **case, timed=False)
    rows += [check_fused_update(torch, **case) for case in UPDATE_CASES]
    rows.append(check_fused_update_gate(torch))
    rows += check_fused_update_corners(torch)
    return rows


FLAGSHIP = [
    # ppo_tr_episode_b512_u1024_bf16 (benchmarks/run_all.py), served.
    "learner.algo=ppo", "model.kind=transformer", "model.seq_mode=episode",
    "model.num_layers=2", "model.num_heads=2", "model.head_dim=128",
    "env.window=201", "precision.mode=bf16_mixed",
    "serve.max_batch=64", "serve.slots=256",
]


#: Every kernel of the port: its source, the Pallas kernels it replaces and
#: its design per input dtype (the wrappers dispatch by dtype).
#: ``fused_update``'s ``vec16+persistent`` moves every f32 operand as 16-byte
#: vectors; with bf16 grads, the grads and the bf16 compute copy go as
#: 8-byte vectors of 4 values, so that a warp's f32 and bf16 accesses cover
#: the same contiguous elements (PERF.md section 6 has why).
_WGMMA = {"bfloat16": "wgmma+tma", "float32": "simt"}
KERNELS = {
    "flash_fwd": ("sharetrade_tpu_torch/csrc/flash_fwd.cu",
                  "sharetrade_tpu/ops/attention.py:88",
                  ["sharetrade_tpu/ops/attention.py:284"], _WGMMA),
    "flash_bwd_dq": ("sharetrade_tpu_torch/csrc/flash_bwd.cu",
                     "sharetrade_tpu/ops/attention.py:375",
                     ["sharetrade_tpu/ops/attention.py:476"],
                     {"bfloat16": "wgmma+tma+cluster", "float32": "simt"}),
    "flash_bwd_dkv": ("sharetrade_tpu_torch/csrc/flash_bwd.cu",
                      "sharetrade_tpu/ops/attention.py:423",
                      ["sharetrade_tpu/ops/attention.py:514"], _WGMMA),
    "fused_update": ("sharetrade_tpu_torch/csrc/fused_update.cu",
                     "sharetrade_tpu/ops/fused_update.py:102", [],
                     {"bfloat16": "vec16+persistent",
                      "float32": "vec16+persistent"}),
}
#: Where the port's main paths launch each kernel: ``file::function`` of the
#: call into the kernel's wrapper (``ops/attention.flash_attention``, whose
#: forward runs ``flash_fwd`` and whose backward ``flash_bwd_dq`` and
#: ``flash_bwd_dkv``; ``ops/fused_update.fused_apply``).
_ATTENTION_SITES = [
    "sharetrade_tpu_torch/models/transformer_episode.py::"
    "episode_transformer_policy",
    "sharetrade_tpu_torch/models/transformer.py::transformer_policy",
]
LAUNCH_SITES = {
    "flash_fwd": _ATTENTION_SITES,
    "flash_bwd_dq": _ATTENTION_SITES,
    "flash_bwd_dkv": _ATTENTION_SITES,
    "fused_update": ["sharetrade_tpu_torch/agents/base.py::make_update_fn"],
}
#: The kernels-phase case each kernel's line reports: the main paths' shape.
KERNEL_CASE = {"flash_fwd": "serving_bf16", "flash_bwd_dq": "replay_bf16",
               "flash_bwd_dkv": "replay_bf16",
               "fused_update": "adagrad_bf16"}


def kernels_line(results: dict) -> dict:
    """Every kernel of the port, with the Pallas kernels it replaces, the
    numbers of its main-path case and its launches on the main paths (the
    train and serve runs, each counted from 0). ``library_ms`` of the
    backward kernels is SDPA's backward alone; ``design`` is the kernel's
    design for each input dtype."""
    entries = []
    for name, (source, replaces, also, design) in KERNELS.items():
        row = next(r for r in results["kernels"]
                   if r["kernel"] == name and r["case"] == KERNEL_CASE[name])
        by_path = {path: results[path]["launches"].get(name, 0)
                   for path in ("train", "serve", "serve_tiers", "serve_slo",
                                "resilience", "reference", "pipeline",
                                "journal", "families", "fleet", "remat_moe",
                                "actors", "obs")
                   if path in results}
        # The same kernel at the families' shapes (families (d)) and at
        # the remat / MoE paths' (remat_moe (d)).
        family_rows = [
            {k: r[k] for k in (
                "phase", "case", "shape", "dtype", "model", "grad_dtype",
                "leaves", "parameters", "max_abs_err", "kernel_ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_bwd_ms")
             if k in r}
            for phase in ("families", "remat_moe")
            for r in results.get(phase, {}).get("kernels", [])
            if r["kernel"] == name]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "also_replaces": also,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row.get("library_bwd_ms", row.get("library_ms")),
            "case": row["case"], "design": design,
            "launch_sites": LAUNCH_SITES[name],
            **({"family_rows": family_rows} if family_rows else {}),
        })
    return {"kernels": entries}


def _all_launch_counts() -> dict:
    from sharetrade_tpu_torch.ops import attention, fused_update
    return {**attention.launch_counts, **fused_update.launch_counts}


def _reset_launch_counts() -> None:
    from sharetrade_tpu_torch.ops import attention, fused_update
    attention.reset_launch_counts()
    fused_update.reset_launch_counts()


def _plain_attention(cfg):
    """The plain attention in the shape of ``cfg``'s transformer's
    ``attention_fn``: banded ``(q, k, v, window)`` in episode mode, causal
    ``(q, k, v)`` in window mode."""
    from sharetrade_tpu_torch.ops import attention
    if cfg.model.seq_mode == "episode":
        sm_scale = cfg.model.head_dim ** -0.5
        return lambda q, k, v, w: attention.reference_attention(
            q, k, v, causal=True, sm_scale=sm_scale, local_window=w)
    return lambda q, k, v: attention.reference_attention(q, k, v,
                                                         causal=True)


@contextlib.contextmanager
def _routing(pins: list, *, replay: bool):
    """The MoE's routing decisions, call by call, through
    ``parallel/moe.route_hook``: recorded into ``pins``, or (``replay``)
    handed back in the same order, so that a pass through the plain
    attention routes every token as the pass through the kernels did (in
    bf16 a near tie in the gate flips between the two, and a flipped
    token's output moves by an expert's size: PERF.md section 6).
    Yields a dict: ``decisions`` counts the decisions taken, and on a
    replay ``own`` keeps the path's own decisions (at the pinned routing
    of the layers before) and ``flipped`` counts those that differ from
    the pinned ones."""
    from sharetrade_tpu_torch.parallel import moe
    calls = iter(list(pins))
    stats = {"decisions": 0, "flipped": 0, "own": []}

    def hook(picks):
        stats["decisions"] += picks.numel()
        if not replay:
            pins.append(picks.clone())
            return picks
        pinned = next(calls)
        if pinned.shape != picks.shape:
            raise RuntimeError("chip_smoke: a routing replay is out of step "
                               "with its recording")
        stats["own"].append(picks.clone())
        stats["flipped"] += int((pinned != picks).sum())
        return pinned

    moe.route_hook = hook
    try:
        yield stats
    finally:
        moe.route_hook = None


def _flip_check(pairs: list) -> dict:
    """The routing flips of pinned passes (``(plain, fp32)`` pairs of
    ``_routing`` replays at the kernel path's routing), held as the MB_*
    rule holds an error: the decisions where the kernel path and the plain
    one part may number at most ``MB_FACTOR`` times those where the plain
    path and fp32 part, plus ``MB_FLOOR`` of all decisions. Rank-ordered
    top-k picks count one flip per rank that differs."""
    decisions = sum(p["decisions"] for p, _ in pairs)
    kernel_plain = sum(p["flipped"] for p, _ in pairs)
    between = sum(int((a != b).sum()) for p, f in pairs
                  for a, b in zip(p["own"], f["own"]))
    limit = MB_FACTOR * between + MB_FLOOR * decisions
    return {"decisions": decisions, "kernel_vs_plain": kernel_plain,
            "kernel_vs_fp32": sum(f["flipped"] for _, f in pairs),
            "plain_vs_fp32": between, "limit": limit,
            "ok": kernel_plain <= limit}


def _minibatch_check(torch, cfg, env, agent, ts,
                     overrides=FLAGSHIP_TRAIN, *,
                     pin_routing: bool = False) -> dict:
    """One PPO minibatch (the first minibatch's agents of a fresh rollout
    from ``ts``) through the kernels, through the plain attention and
    through the fp32 model, held as the MB_* constants state.
    ``overrides`` is ``cfg``'s config (its fp32 form is the reference).
    With ``pin_routing`` a mixture of experts' plain and fp32 paths take
    the kernel path's routing (``_routing``), and the decisions they would
    have taken otherwise are held by ``_flip_check``."""
    from sharetrade_tpu_torch.agents import build_agent
    from sharetrade_tpu_torch.agents.ppo import num_minibatches
    from sharetrade_tpu_torch.agents.rollout import (
        collect_rollout, gae_advantages, normalize_advantages_masked,
        replay_forward)
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.models import build_model
    from sharetrade_tpu_torch.precision import policy_from_config

    def plain_agent(c):
        model = build_model(c.model, env.obs_dim, device="cuda",
                            attention_fn=_plain_attention(c),
                            num_actions=env.num_actions,
                            num_assets=env.num_assets)
        return build_agent(c, env, model, device="cuda")

    compute = policy_from_config(cfg.precision).cast_compute(ts.params)
    _, traj, bootstrap, init_carry = collect_rollout(
        agent.model, env, ts, cfg.runtime.chunk_steps,
        cfg.parallel.num_workers, params=compute)
    workers = cfg.parallel.num_workers
    idx = torch.arange(workers // num_minibatches(cfg.learner, workers),
                       device="cuda")
    with torch.no_grad():
        adv = gae_advantages(traj.reward, traj.value, traj.active, bootstrap,
                             cfg.learner.gamma, cfg.learner.gae_lambda)
        ret = (adv + traj.value).index_select(1, idx)
        adv = adv.index_select(1, idx)
    traj = traj.take(idx)
    carry = {k: v.index_select(0, idx) for k, v in init_carry.items()}
    carry32 = {k: v.float() if v.is_floating_point() else v
               for k, v in carry.items()}
    cfg32 = FrameworkConfig().apply_overrides(
        list(overrides) + ["precision.mode=fp32"])
    paths = {"kernel": (agent, compute, carry),
             "plain": (plain_agent(cfg), compute, carry),
             "fp32": (plain_agent(cfg32), ts.params, carry32)}
    got, pins, routed = {}, [], {}
    pin = pin_routing and bool(cfg.model.moe_experts)
    for name, (ag, params, c) in paths.items():
        with (_routing(pins, replay=name != "kernel") if pin
              else contextlib.nullcontext()) as stats:
            with torch.no_grad():
                logits, values, aux = replay_forward(ag.model, params, traj,
                                                     c)
                logp = torch.log_softmax(logits.float(), dim=-1).gather(
                    -1, traj.action[..., None])[..., 0]
            terms, grads = ag.minibatch_grads(params, traj, c, adv, ret)
        routed[name] = stats
        got[name] = {"logp": logp, "value": values.float(),
                     "terms": terms.float(), "aux": float(aux),
                     "grads": [g.float() for g in grads]}
    ref = got["fp32"]

    def errs(path):
        g = got[path]
        return {"logp": (g["logp"] - ref["logp"]).abs().max().item(),
                "value": (g["value"] - ref["value"]).abs().max().item(),
                "value_loss": abs(g["terms"][2] - ref["terms"][2]).item(),
                "entropy": abs(g["terms"][3] - ref["terms"][3]).item(),
                "grads": [(a - b).norm().item()
                          for a, b in zip(g["grads"], ref["grads"])]}

    size = {"logp": ref["logp"].abs().max().item(),
            "value": ref["value"].abs().max().item(),
            "value_loss": abs(ref["terms"][2]).item(),
            "entropy": abs(ref["terms"][3]).item(),
            "grads": [g.norm().item() for g in ref["grads"]]}
    e_k, e_p = errs("kernel"), errs("plain")
    failed = []
    for key in ("logp", "value", "value_loss", "entropy", "grads"):
        triples = (zip(e_k[key], e_p[key], size[key]) if key == "grads"
                   else [(e_k[key], e_p[key], size[key])])
        for j, (ek, ep, sz) in enumerate(triples):
            if not ek <= MB_FACTOR * ep + MB_FLOOR * sz:
                failed.append(key if key != "grads" else f"grad leaf {j}")

    weight = traj.active
    denom = torch.clamp(weight.sum(), min=1.0)
    ratio = {k: torch.exp(got[k]["logp"] - traj.logp)
             for k in ("kernel", "plain")}
    policy_bound = ((normalize_advantages_masked(adv, weight, denom).abs()
                     * (ratio["kernel"] - ratio["plain"]).abs()
                     * weight).sum() / denom).item() + MB_POLICY_SLACK
    policy_diff = abs(got["kernel"]["terms"][1]
                      - got["plain"]["terms"][1]).item()
    if not policy_diff <= policy_bound:
        failed.append("policy term")
    routing = (_flip_check([(routed["plain"], routed["fp32"])]) if pin
               else None)
    if routing and not routing["ok"]:
        failed.append("routing flips")
    gk, gp = got["kernel"]["grads"], got["plain"]["grads"]
    leaf_rel = [((a - b).norm() / b.norm()).item() for a, b in zip(gk, gp)]
    return {
        "agents": len(idx),
        "kernel_err_vs_fp32": e_k, "plain_err_vs_fp32": e_p,
        "fp32_size": size,
        "kernel_vs_plain": {
            "logp_max_abs": (got["kernel"]["logp"]
                             - got["plain"]["logp"]).abs().max().item(),
            "terms": [got["kernel"]["terms"].tolist(),
                      got["plain"]["terms"].tolist()],
            "grad_leaf_rel_l2_max": max(leaf_rel),
            "grad_leaf_rel_l2_median": statistics.median(leaf_rel)},
        "policy_term_diff": policy_diff, "policy_term_bound": policy_bound,
        "aux": {k: g["aux"] for k, g in got.items()},
        **({"routing": routing} if pin else {}),
        "rule": {"factor": MB_FACTOR, "floor": MB_FLOOR,
                 "policy_slack": MB_POLICY_SLACK},
        "failed": failed,
    }


def phase_train(torch) -> dict:
    """The training main path; see the module docstring."""
    from sharetrade_tpu_torch.agents import build_agent
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.env.trading import make_trading_env
    from sharetrade_tpu_torch.models.core import tree_leaves

    cfg = FrameworkConfig().apply_overrides(FLAGSHIP_TRAIN)
    prices = _prices(cfg.data)
    env = make_trading_env(prices, window=cfg.env.window,
                           initial_budget=cfg.env.initial_budget,
                           initial_shares=cfg.env.initial_shares,
                           device="cuda")
    agent = build_agent(cfg, env, device="cuda")
    ts = agent.init(cfg.seed)
    workers, unroll = cfg.parallel.num_workers, cfg.runtime.chunk_steps
    torch.cuda.synchronize()

    # ---- the counted window: counts reset just before, read just after.
    _reset_launch_counts()
    per_chunk, chunk_s, metrics_rows, breakdown = [], [], [], {}
    for c in range(TRAIN_CHUNKS):
        marks = []

        def marker(label, marks=marks):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((label, ev))

        before = _all_launch_counts()
        t0 = time.perf_counter()
        if c == TRAIN_CHUNKS - 1:
            marker("start")
            ts, metrics = agent.step(ts, marker=marker)
        else:
            ts, metrics = agent.step(ts)
        row = {k: float(v) for k, v in metrics.items()}   # syncs
        chunk_s.append(time.perf_counter() - t0)
        after = _all_launch_counts()
        per_chunk.append({k: after[k] - before[k] for k in after})
        metrics_rows.append(row)
        for (_, a), (label, b) in zip(marks, marks[1:]):
            breakdown[label] = breakdown.get(label, 0.0) + a.elapsed_time(b)
    torch.cuda.synchronize()
    launches = _all_launch_counts()
    # ---- end of the counted window.

    minibatch = _minibatch_check(torch, cfg, env, agent, ts)
    chunk_ms = [1e3 * t for t in chunk_s]
    total_ms = sum(breakdown.values())
    updates = cfg.learner.ppo_epochs * cfg.learner.ppo_minibatches
    layers = cfg.model.num_layers
    expect = {"flash_fwd": layers * (1 + updates),
              "flash_bwd_dq": layers * updates,
              "flash_bwd_dkv": layers * updates,
              "fused_update": updates}
    row = {
        "phase": "train", "config": FLAGSHIP_TRAIN, "chunks": TRAIN_CHUNKS,
        "agents": workers, "unroll": unroll,
        "parameters": sum(p.numel() for p in tree_leaves(ts.params)),
        "chunk_ms": chunk_ms,
        "agent_steps_per_s": workers * unroll / chunk_s[-1],
        "losses": [{k: r[k] for k in ("loss", "policy_loss", "value_loss",
                                       "entropy")} for r in metrics_rows],
        "env_steps": metrics_rows[-1]["env_steps"],
        "updates": metrics_rows[-1]["updates"],
        "launches": launches, "launches_per_chunk": per_chunk,
        "expected_per_chunk": expect,
        "breakdown_ms": breakdown,
        "breakdown_share": {k: v / total_ms for k, v in breakdown.items()},
        "minibatch": minibatch,
    }
    problems = []
    if any(c != expect for c in per_chunk):
        problems.append("kernel launches per chunk differ from the "
                        "expected counts")
    if not all(np.isfinite(list(r.values())).all() for r in metrics_rows):
        problems.append("non-finite chunk metrics")
    if minibatch["failed"]:
        problems.append("one minibatch through the kernels disagrees with "
                        f"the plain attention's: {minibatch['failed']}")
    if metrics_rows[-1]["env_steps"] != TRAIN_CHUNKS * unroll:
        problems.append("env steps do not add up")
    row["problems"] = problems
    return row


def phase_serve(torch) -> dict:
    """The serving main path; see the module docstring."""
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.env.trading import obs_dim
    from sharetrade_tpu_torch.models import build_model
    from sharetrade_tpu_torch.ops import attention
    from sharetrade_tpu_torch.precision import policy_from_config
    from sharetrade_tpu_torch.serve import ServeEngine
    from sharetrade_tpu_torch.serve.driver import make_sessions, run_closed_loop

    cfg = FrameworkConfig().apply_overrides(FLAGSHIP)
    window = cfg.env.window
    prices = _prices(cfg.data)
    model = build_model(cfg.model, obs_dim(window), device="cuda")
    params = model.init(torch.Generator().manual_seed(cfg.seed))
    policy = policy_from_config(cfg.precision)
    engine = ServeEngine(model, cfg.serve, params, precision=policy)
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    slots = cfg.serve.slots

    # ---- the counted window: counts reset just before, read just after.
    _reset_launch_counts()
    before = dict(engine.counters)
    first = make_sessions(prices, window, cfg.serve.max_batch,
                          seed=cfg.seed, prefix="first")
    first_obs = [s.observation() for s in first]
    handles = [engine.submit(s.sid, o) for s, o in zip(first, first_obs)]
    first_results = [h.wait(120.0) for h in handles]
    # Warm phase: the population fits the arena (64 + 192 = 256 slots).
    warm = run_closed_loop(
        engine, make_sessions(prices, window, slots - cfg.serve.max_batch,
                              seed=cfg.seed + 1, prefix="w"),
        concurrency=slots - cfg.serve.max_batch, duration_s=3.0)
    # Eviction phase: 320 sessions > 256 slots, so LRU eviction and cold
    # re-prefill run every tick.
    evict = run_closed_loop(
        engine, make_sessions(prices, window, 320, seed=cfg.seed + 2,
                              prefix="e"),
        concurrency=320, duration_s=3.0)
    drained = engine.drain(60.0)
    torch.cuda.synchronize()
    all_launches = _all_launch_counts()
    launches = all_launches["flash_fwd"]
    after = dict(engine.counters)
    # ---- end of the counted window.
    stopped = engine.stop(drain=False, timeout_s=10.0)
    delta = {k: after[k] - before[k] for k in after}

    # The first cold batch, again, through the plain attention on the card.
    if any(r is None for r in first_results):
        raise RuntimeError("chip_smoke: a first-batch request failed")
    got_logits = np.stack([r.logits for r in first_results])
    got_values = np.array([r.value for r in first_results])
    sm_scale = cfg.model.head_dim ** -0.5
    plain_model = build_model(
        cfg.model, obs_dim(window), device="cuda",
        attention_fn=lambda q, k, v, w: attention.reference_attention(
            q, k, v, causal=True, sm_scale=sm_scale, local_window=w))
    with torch.inference_mode():
        ref, _ = plain_model.apply_prefill(
            policy.cast_compute(params),
            torch.from_numpy(np.stack(first_obs)).cuda())
    ref_logits = ref.logits.cpu().numpy()
    ref_values = ref.value.cpu().numpy()
    logit_err = float(np.abs(got_logits - ref_logits).max())
    value_err = float(np.abs(got_values - ref_values).max())

    row = {
        "phase": "serve", "config": FLAGSHIP, "warmup_s": warmup_s,
        "warm_phase": warm, "evict_phase": evict,
        "counters": delta, "flash_fwd_launches": launches,
        "launches": all_launches,
        "num_layers": cfg.model.num_layers,
        "first_batch_logit_max_abs_err": logit_err,
        "first_batch_value_max_abs_err": value_err,
        "logit_atol": LOGIT_ATOL, "value_atol": VALUE_ATOL,
        "drained": drained, "stopped_clean": stopped,
    }
    problems = []
    if launches <= 0 or launches != cfg.model.num_layers * delta[
            "cold_batches"]:
        problems.append("flash_fwd launches != num_layers x cold ticks")
    if delta["warm_batches"] <= 0 or delta["evictions"] <= 0:
        problems.append("the warm program or LRU eviction never ran")
    if warm["failed"] or evict["failed"] or delta["failed"]:
        problems.append("requests failed")
    if not (np.isfinite(got_logits).all() and got_logits.shape
            == (cfg.serve.max_batch, cfg.model.num_actions)):
        problems.append("first-batch logits not finite or misshapen")
    if logit_err > LOGIT_ATOL or value_err > VALUE_ATOL:
        problems.append("first-batch outputs disagree with plain attention")
    if not (drained and stopped):
        problems.append("engine did not drain and stop cleanly")
    row["problems"] = problems
    return row


_ROOT = os.path.dirname(os.path.abspath(__file__))
#: This run's scratch directory (``main`` makes it and removes it at the
#: end): every price read journals into a fresh directory under it, and
#: every CLI run works in a fresh directory under it, so nothing is written
#: into the checkout's journal/ and no run recovers a series another run
#: journaled (the cache recovered from a journal wins over the config's
#: ``data.synthetic_length``, as in the JAX package).
_SCRATCH = ""


def _fresh_dir(prefix: str) -> str:
    import tempfile
    return tempfile.mkdtemp(prefix=prefix, dir=_SCRATCH)


def _prices(data) -> np.ndarray:
    """The MSFT prices of ``data`` (a ``DataConfig``) through the port's
    data service, journaled into a fresh scratch directory; the service is
    closed again."""
    import dataclasses

    from sharetrade_tpu_torch.data.service import PriceDataService
    service = PriceDataService(config=dataclasses.replace(
        data, journal_dir=_fresh_dir("prices-")))
    try:
        return service.request("MSFT").series.prices
    finally:
        service.close()


def _cli_env() -> dict:
    """The environment of a CLI run from the scratch directory: the
    checkout on ``PYTHONPATH``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def phase_cli() -> dict:
    """``cli serve`` as a user runs it, on the flagship config."""
    import tempfile
    cmd = [sys.executable, "-m", "sharetrade_tpu_torch.cli", "serve",
           "--duration", "3", "--sessions", "320"]
    # An empty checkpoint directory: the seeded init, never a policy some
    # earlier run left in the checkout.
    with tempfile.TemporaryDirectory(prefix="cli-serve-") as ckpts:
        for item in FLAGSHIP + [f"runtime.checkpoint_dir={ckpts}"]:
            cmd += ["--set", item]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300, cwd=_fresh_dir("cli-"),
                              env=_cli_env())
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    summary = json.loads(lines[-1]) if lines else {}
    ok = (proc.returncode == 0 and len(lines) >= 2
          and json.loads(lines[0]).get("params_step") == 0
          and summary.get("completed", 0) > 0
          and summary.get("failed", 1) == 0
          and summary.get("flash_fwd_launches", 0) > 0)
    row = {"phase": "cli", "rc": proc.returncode,
           "seconds": time.perf_counter() - t0, "summary": summary,
           "ok": ok}
    if not ok:
        row["stderr_tail"] = proc.stderr[-2000:]
    return row


def phase_cli_train() -> dict:
    """``cli train`` as a user runs it, on the flagship config with a
    series of 2,249 prices: horizon 2,048, one episode of two chunks."""
    import tempfile
    cmd = [sys.executable, "-m", "sharetrade_tpu_torch.cli", "train"]
    with tempfile.TemporaryDirectory(prefix="cli-train-") as ckpts:
        for item in FLAGSHIP_TRAIN + ["data.synthetic_length=2249",
                                      f"runtime.checkpoint_dir={ckpts}"]:
            cmd += ["--set", item]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600, cwd=_fresh_dir("cli-"),
                              env=_cli_env())
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    summary = json.loads(lines[-1]) if lines else {}
    launches = summary.get("kernel_launches", {})
    ok = (proc.returncode == 0
          and (summary.get("avg_portfolio"), summary.get("std_portfolio"))
          == FLAGSHIP_DIGITS
          and summary.get("env_steps") == 2048
          and all(launches.get(k, 0) > 0 for k in KERNELS))
    row = {"phase": "cli_train", "rc": proc.returncode,
           "seconds": time.perf_counter() - t0, "summary": summary,
           "ok": bool(ok)}
    if not ok:
        row["stderr_tail"] = proc.stderr[-2000:]
    return row


def _state_diff(a, b) -> dict:
    """Largest |a - b| over the leaves of each part of two training states
    (params, opt_state, carry, env_state, DQN's extras), and whether the
    generators' states are equal."""
    from sharetrade_tpu_torch import convert
    la, lb = convert.train_state_leaves(a), convert.train_state_leaves(b)
    out = {"params": 0.0, "opt_state": 0.0, "carry": 0.0, "env_state": 0.0,
           "extras": 0.0}
    for name, x in la.items():
        part = name.split(".")[0]
        if part in out:
            d = (x.float() - lb[name].float()).abs().max().item()
            out[part] = max(out[part], d if d == d else float("inf"))
    out["max"] = max(out.values())
    out["rng_equal"] = bool((la["rng"] == lb["rng"]).all())
    return out


def _nondeterministic_ops(torch, cfg, prices) -> list[str]:
    """The ops PyTorch names as nondeterministic in one flagship chunk (its
    warn-only deterministic mode), each message once."""
    import warnings
    from sharetrade_tpu_torch.agents import build_agent
    from sharetrade_tpu_torch.env.trading import make_trading_env
    env = make_trading_env(prices, window=cfg.env.window, device="cuda")
    agent = build_agent(cfg, env, device="cuda")
    ts = agent.init(cfg.seed)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            agent.step(ts)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).splitlines()[0][:200] for w in caught})


def phase_resilience(torch) -> dict:
    """Checkpoints, supervision and evaluation; see the module docstring."""
    import shutil
    import tempfile
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.ops import attention
    from sharetrade_tpu_torch.runtime import Orchestrator, Phase

    base = FrameworkConfig().apply_overrides(RESILIENCE)
    prices = _prices(base.data)
    root = tempfile.mkdtemp(prefix="resilience-")
    problems: list[str] = []
    row: dict = {"phase": "resilience", "config": RESILIENCE,
                 "prices": len(prices)}

    def run(name, *extra, hook=None, resume=False, series=prices):
        """One orchestrator over ``series``; returns it, the wall-clock
        time of each chunk's hook call and the chunk rows."""
        cfg = FrameworkConfig().apply_overrides(
            RESILIENCE + [f"runtime.checkpoint_dir={os.path.join(root, name)}"]
            + list(extra))
        marks: list = []

        def record(i, r):
            marks.append((i, time.perf_counter(), dict(r)))
            if hook is not None:
                hook(orch, i, r)

        orch = Orchestrator(cfg, device="cuda", fault_hook=record)
        orch.send_training_data(series, resume=resume)
        t0 = time.perf_counter()
        orch.start_training(background=False)
        orch.stop()
        torch.cuda.synchronize()
        marks.insert(0, (None, t0, {}))
        return orch, marks

    def completed(orch, name):
        if orch.lifecycle.phase is not Phase.COMPLETED:
            problems.append(f"{name}: ended {orch.lifecycle.phase.value} "
                            f"({orch.last_error!r})")

    _reset_launch_counts()
    t_phase = time.perf_counter()
    # (a) two uninterrupted runs: the nondeterminism floor.
    a1, marks1 = run("a1")
    a2, marks2 = run("a2", "runtime.checkpoint_every_updates=0")
    completed(a1, "a1")
    completed(a2, "a2")
    floor = _state_diff(a1.train_state, a2.train_state)
    row["a_floor"] = floor
    if floor["max"] != 0.0 or not floor["rng_equal"]:
        row["a_nondeterministic_ops"] = _nondeterministic_ops(
            torch, base, prices)
    shutil.rmtree(os.path.join(root, "a2"), ignore_errors=True)
    saves = [s for s in a1.checkpoints.save_stats if "loop_ms" in s]

    def chunk_ms(marks):
        """Hook to hook: a chunk and the boundary actions before it."""
        return [(t1 - t0) * 1e3 for (_, t0, _), (_, t1, _)
                in zip(marks, marks[1:])]

    # A 4-chunk episode saving every 32 updates: the writer of the save at
    # chunk 2's boundary runs beside chunk 3, none beside chunks 2 and 4.
    series = _prices(FrameworkConfig().apply_overrides(
        ["data.synthetic_length=4297"]).data)
    t_run, marks_t = run("t", "runtime.checkpoint_every_updates=32",
                         series=series)
    completed(t_run, "t")
    t_ms = chunk_ms(marks_t)
    shutil.rmtree(os.path.join(root, "t"), ignore_errors=True)
    loop_ms = statistics.median(s["loop_ms"] for s in saves)
    d2h_ms = statistics.median(s["d2h_ms"] for s in saves)
    without = (t_ms[1] + t_ms[3]) / 2
    row["save"] = {
        "bytes": saves[-1]["bytes"], "async_saves": len(saves),
        "loop_thread_host_ms_median": loop_ms,
        "loop_thread_d2h_device_ms_median": d2h_ms,
        "writer_thread_ms_median": statistics.median(
            s["writer_ms"] for s in saves),
        "per_save": list(a1.checkpoints.save_stats),
        "chunk_ms_with_save": t_ms[2], "chunk_ms_without_save": without,
        "chunk_ms_4_chunk_run": t_ms,
        # Across runs: (a1) saves every chunk, (a2) never.
        "chunk_ms_a1_saving": chunk_ms(marks1),
        "chunk_ms_a2_not_saving": chunk_ms(marks2),
    }
    share = (loop_ms + d2h_ms) / without
    row["save"]["loop_thread_share_of_chunk"] = share
    if share > SAVE_LOOP_SHARE:
        problems.append(f"the loop thread's part of a save is {share:.1%} of "
                        f"a chunk (limit {SAVE_LOOP_SHARE:.0%})")
    # A verified restore of the newest checkpoint: read, verify, H2D.
    template = a1.agent.init(a1.cfg.seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored, step = a1.checkpoints.restore(template)
    torch.cuda.synchronize()
    row["restore"] = {"seconds": time.perf_counter() - t0, "step": step}
    del restored, template

    def within_floor(name, orch):
        diff = _state_diff(a1.train_state, orch.train_state)
        row[f"{name}_diff"] = diff
        if diff["max"] > floor["max"] or (floor["rng_equal"]
                                          and not diff["rng_equal"]):
            problems.append(f"{name}: final state differs from (a) by "
                            f"{diff['max']} (floor {floor['max']})")

    # (b) preempted after chunk 1, resumed from tag_preempt.
    b1, _ = run("b", hook=lambda o, i, r: o.request_preempt()
                if i == 0 else None)
    if not (b1.preempted and b1.preempt_saved):
        problems.append("b: the preempted run wrote no tag_preempt")
    b2, _ = run("b", resume=True)
    completed(b2, "b")
    row["b"] = {"preempt_meta": b1.checkpoints.tagged_metadata("preempt"),
                "chunks_after_resume": b2.chunks}
    within_floor("b", b2)
    shutil.rmtree(os.path.join(root, "b"), ignore_errors=True)

    # (c) a fault in chunk 2: one supervised restart from chunk 1's save.
    fired: list = []

    def fault(o, i, r):
        if i == 1 and not fired:
            fired.append(i)
            raise RuntimeError("injected fault in chunk 2")

    c, _ = run("c", hook=fault)
    completed(c, "c")
    row["c"] = {"restarts": c.restarts, "chunks": c.chunks}
    if c.restarts != 1:
        problems.append(f"c: {c.restarts} restarts, expected 1")
    within_floor("c", c)
    shutil.rmtree(os.path.join(root, "c"), ignore_errors=True)

    # (d) agent 3's budget NaN after chunk 1: healed in place.
    def poison(o, i, r):
        if i == 0:
            env = o._ts.env_state
            budget = env.budget.clone()
            budget[3] = float("nan")
            o._ts = o._ts.replace(env_state=env.replace(budget=budget))

    d, marks_d = run("d", hook=poison)
    completed(d, "d")
    cursors = d.train_state.env_state.t
    losses = [m[2].get("loss") for m in marks_d[1:]]
    row["d"] = {"agent_heals": d.agent_heals, "restarts": d.restarts,
                "losses": losses,
                "unhealthy_per_chunk": [m[2].get("unhealthy_workers")
                                        for m in marks_d[1:]],
                "healed_row_cursor": int(cursors[3]),
                "survivor_cursor": int(cursors[0])}
    if d.agent_heals != 1 or d.restarts != 0:
        problems.append(f"d: {d.agent_heals} heals, {d.restarts} restarts; "
                        "expected 1 and 0")
    if not np.isfinite(losses).all():
        problems.append("d: a non-finite loss")
    if not bool((cursors == cursors[0]).all()):
        problems.append("d: the healed row's cursor is not the survivors'")
    shutil.rmtree(os.path.join(root, "d"), ignore_errors=True)

    # (e) the newest state.npz of run (a1) with one byte flipped, resumed.
    a_dir = os.path.join(root, "a1")
    newest = max(a1.checkpoints.steps())
    path = os.path.join(a_dir, f"ckpt_{newest:010d}", "state.npz")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    e, _ = run("a1", resume=True)
    completed(e, "e")
    quarantined = sorted(n for n in os.listdir(a_dir)
                         if n.startswith("corrupt_"))
    report = e.checkpoints.last_restore_report
    row["e"] = {"flipped": path, "quarantined": quarantined,
                "resumed_step": report.get("step"),
                "skipped": report.get("skipped")}
    if quarantined != [f"corrupt_{newest:010d}_state_checksum"] or \
            report.get("step") != newest - 16:
        problems.append("e: the corrupt newest checkpoint was not "
                        "quarantined and walked back")
    within_floor("e", e)
    params = {k: v for k, v in a1.train_state.params.items()}
    for orch in (a1, a2, b1, b2, c, d, e):
        orch.stop()
    shutil.rmtree(a_dir, ignore_errors=True)

    # (f) greedy evaluation over the 6,046-tick series: the replay alone
    # (twice: the first call meets the shape first), then evaluate(), whose
    # tag_best save is timed on its own.
    cfg = FrameworkConfig().apply_overrides(
        FLAGSHIP_TRAIN + [f"runtime.checkpoint_dir={os.path.join(root, 'f')}"])
    series = _prices(cfg.data)
    f_orch = Orchestrator(cfg, device="cuda")
    f_orch.send_training_data(series, params=params)
    shapes: list = []
    launch = attention._launch

    def spy(name, fn, *args):
        if name == "flash_fwd":
            shapes.append(list(args[0].shape))
        return launch(name, fn, *args)

    save_s: list = []
    save_tagged = f_orch.checkpoints.save_tagged

    def timed_save(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return save_tagged(*args, **kwargs)
        finally:
            save_s.append(time.perf_counter() - t0)

    f_orch.checkpoints.save_tagged = timed_save

    def timed(fn, *args):
        """(result, seconds, flash_fwd q shapes) of one call."""
        shapes.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, list(shapes)

    attention._launch = spy
    try:
        replays = [timed(f_orch._evaluate_params, f_orch.train_state.params)
                   for _ in range(2)]
        result, eval_s, eval_shapes = timed(f_orch.evaluate)
    finally:
        attention._launch = launch
    horizon = len(series) - cfg.env.window
    row["f"] = {**result, "horizon": horizon,
                "replay_seconds": [r[1] for r in replays],
                "evaluate_seconds": eval_s,
                "tag_best_save_seconds": save_s,
                "replay_flash_fwd_q_shapes": replays[0][2],
                "evaluate_flash_fwd_q_shapes": eval_shapes,
                "tag_best": f_orch.checkpoints.tagged_metadata("best")}
    f_orch.stop()
    shutil.rmtree(os.path.join(root, "f"), ignore_errors=True)
    trunk_t = (cfg.model.num_layers - 1) * (cfg.env.window - 1) \
        + cfg.env.window + horizon
    if not all(np.isfinite(r[0]["eval_portfolio"]) for r in replays) or \
            not np.isfinite(result["eval_portfolio"]):
        problems.append("f: non-finite eval_portfolio")
    if any(r[0] != result for r in replays):
        problems.append("f: the replay and evaluate() disagree")
    if len(save_s) != 1:
        problems.append(f"f: {len(save_s)} tag_best saves, expected 1")
    for got in [r[2] for r in replays] + [eval_shapes]:
        if len(got) != cfg.model.num_layers or any(
                s[2] != trunk_t for s in got):
            problems.append(f"f: flash_fwd launches {got}, expected "
                            f"{cfg.model.num_layers} over T = {trunk_t}")
    torch.cuda.synchronize()
    row["launches"] = _all_launch_counts()
    row["in_process_s"] = time.perf_counter() - t_phase

    # (g) cli train --eval, then cli serve from the same directory.
    g_dir = os.path.join(root, "g")
    cmd = [sys.executable, "-m", "sharetrade_tpu_torch.cli", "train",
           "--eval"]
    for item in RESILIENCE + [f"runtime.checkpoint_dir={g_dir}"]:
        cmd += ["--set", item]
    t0 = time.perf_counter()
    train = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=600, cwd=_fresh_dir("cli-"),
                           env=_cli_env())
    lines = [ln for ln in train.stdout.splitlines() if ln.startswith("{")]
    summary = json.loads(lines[-1]) if lines else {}
    best_path = os.path.join(g_dir, "tag_best", "meta.json")
    best = (json.load(open(best_path)) if os.path.exists(best_path)
            else {})
    cmd = [sys.executable, "-m", "sharetrade_tpu_torch.cli", "serve",
           "--duration", "2", "--sessions", "128"]
    for item in FLAGSHIP + [f"runtime.checkpoint_dir={g_dir}"]:
        cmd += ["--set", item]
    serve = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=300, cwd=_fresh_dir("cli-"),
                           env=_cli_env())
    served = [json.loads(ln) for ln in serve.stdout.splitlines()
              if ln.startswith("{")]
    row["g"] = {"train_rc": train.returncode, "train_summary": summary,
                "tag_best": best, "serve_rc": serve.returncode,
                "serving_ready": served[0] if served else None,
                "serve_summary": served[-1] if served else None,
                "seconds": time.perf_counter() - t0}
    if (train.returncode != 0 or serve.returncode != 0 or not served
            or not np.isfinite(summary.get("eval_portfolio", float("nan")))
            or not best.get("updates")
            or served[0].get("params_step") != best["updates"]
            or served[-1].get("failed", 1) != 0):
        problems.append("g: cli train --eval then cli serve did not boot "
                        "from tag_best")
        row["g"]["stderr_tail"] = (train.stderr[-1500:]
                                   + serve.stderr[-1500:])
    shutil.rmtree(root, ignore_errors=True)
    row["problems"] = problems
    return row


#: The reference workload: the JAX package's defaults, which are the source
#: system (SURVEY.md): the 203 -> 200 -> 3 Q-network (q_mlp), online
#: Q-learning, 10 workers, 200 steps per chunk, adagrad lr 0.01, window 201,
#: the synthetic 6,046-tick MSFT series (horizon 5,845). Nothing is cut: no
#: override.
REFERENCE: list[str] = []
REFERENCE_OTHERS = {
    "dqn": ["learner.algo=dqn"],
    "dqn_per": ["learner.algo=dqn", "learner.replay_priority=per"],
    "pg": ["learner.algo=pg"],
    "a2c": ["learner.algo=a2c"],
}
#: fused_update launches per chunk of each learner: one per env step for
#: the Q-learners (gated, not skipped, when nothing may update), one per
#: unroll for PG and A2C.
REFERENCE_LAUNCHES = {"qlearn": 200, "dqn": 200, "dqn_per": 200, "pg": 1,
                      "a2c": 1}
#: The DQN preempt/resume check: 1,001 prices (horizon 800, four chunks),
#: preempted after chunk 2.
DQN_RESUME = ["learner.algo=dqn", "data.synthetic_length=1001",
              "runtime.backoff_initial_s=0.01"]


def _chunk_rows(torch, agent, ts, chunks: int):
    """``chunks`` steps of ``agent`` from ``ts``: per chunk the wall ms
    (ending in a readback of the metrics), the fused_update launches and the
    metrics."""
    from sharetrade_tpu_torch.ops import fused_update
    rows = []
    for _ in range(chunks):
        before = fused_update.launch_counts["fused_update"]
        t0 = time.perf_counter()
        ts, metrics = agent.step(ts)
        row = {k: float(v) for k, v in metrics.items()}   # syncs
        rows.append({"ms": (time.perf_counter() - t0) * 1e3,
                     "launches": fused_update.launch_counts["fused_update"]
                     - before, "metrics": row})
    return ts, rows


def _device_busy(torch, fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the kernels' device
    time (self time of the CUDA events), the wall time of the call, the
    device's busy share of it, the kernel launches, and the five kernels
    with the most device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    stats = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            stats.append((dev_us, ev.key, ev.count))
    stats.sort(reverse=True)
    device_ms = sum(us for us, _, _ in stats) / 1e3
    return {"profiled_wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "device_kernels": sum(c for _, _, c in stats),
            "device_top": [{"kernel": k[:80], "ms": us / 1e3, "calls": c}
                           for us, k, c in stats[:5]]}


def phase_reference(torch) -> dict:
    """The reference workload on the card; see the module docstring."""
    import shutil
    import tempfile
    from sharetrade_tpu_torch.agents import build_agent
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.env.trading import make_trading_env
    from sharetrade_tpu_torch.ops import fused_update
    from sharetrade_tpu_torch.runtime import Orchestrator, Phase

    base = FrameworkConfig().apply_overrides(REFERENCE)
    prices = _prices(base.data)
    horizon = len(prices) - base.env.window
    workers, steps = base.parallel.num_workers, base.runtime.chunk_steps
    root = tempfile.mkdtemp(prefix="reference-")
    problems: list[str] = []
    row: dict = {"phase": "reference", "prices": len(prices),
                 "horizon": horizon, "agents": workers, "chunk_steps": steps}

    # ---- the counted window: counts reset just before, read just after.
    _reset_launch_counts()
    # (a) one episode of the default Q-learning through the orchestrator,
    # the final partial chunk included, then the greedy eval.
    marks: list = []
    hooked: list[tuple[int, float]] = []   # (chunk index, env_steps) a row

    def record(i, r):
        marks.append((time.perf_counter(),
                      fused_update.launch_counts["fused_update"], dict(r)))
        hooked.append((i, r.get("env_steps")))

    cfg = FrameworkConfig().apply_overrides(
        REFERENCE + [f"runtime.checkpoint_dir={os.path.join(root, 'qlearn')}"])
    orch = Orchestrator(cfg, device="cuda", fault_hook=record)
    orch.send_training_data(prices)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks.append((t0, fused_update.launch_counts["fused_update"], {}))
    orch.start_training(background=False)
    episode_s = time.perf_counter() - t0
    chunk_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(marks, marks[1:])]
    per_chunk = [b[1] - a[1] for a, b in zip(marks, marks[1:])]
    losses = [m[2].get("loss") for m in marks[1:]]
    last = marks[-1][2]
    t0 = time.perf_counter()
    evaluation = orch.evaluate()
    eval_s = time.perf_counter() - t0
    orch.stop()
    chunks = -(-horizon // steps)
    row["qlearn"] = {
        "chunks": len(chunk_ms), "episode_s": episode_s,
        "agent_steps_per_s": workers * horizon / episode_s,
        "chunk_ms_median": statistics.median(chunk_ms),
        "chunk_ms_first": chunk_ms[0], "chunk_ms_last": chunk_ms[-1],
        "fused_update_per_chunk": sorted(set(per_chunk)),
        "losses_finite": bool(np.isfinite(losses).all()),
        "env_steps": last.get("env_steps"), "updates": last.get("updates"),
        "avg_portfolio": last.get("portfolio_mean"),
        "std_portfolio": last.get("portfolio_std"),
        "eval": evaluation, "eval_s": eval_s}
    if orch.lifecycle.phase is not Phase.COMPLETED:
        problems.append(f"qlearn: ended {orch.lifecycle.phase.value} "
                        f"({orch.last_error!r})")
    if len(chunk_ms) != chunks or last.get("env_steps") != horizon \
            or last.get("updates") != horizon:
        problems.append(f"qlearn: {len(chunk_ms)} chunks, env_steps "
                        f"{last.get('env_steps')}, updates "
                        f"{last.get('updates')}; expected {chunks} chunks "
                        f"and {horizon} steps (restarts {orch.restarts}, "
                        f"last error {orch.last_error!r}, rows {hooked})")
    if set(per_chunk) != {REFERENCE_LAUNCHES["qlearn"]}:
        problems.append(f"qlearn: fused_update launches per chunk {per_chunk}")
    if not (row["qlearn"]["losses_finite"]
            and np.isfinite(evaluation["eval_portfolio"])):
        problems.append("qlearn: a non-finite loss or eval_portfolio")

    # One more chunk split by CUDA events: per step the selection forward
    # and env step, the TD forward, the backward and the update.
    agent = orch.agent
    ts = agent.init(cfg.seed)
    ts, _ = agent.step(ts)
    events: list = []

    def marker(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((label, ev))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marker("start")
    ts, metrics = agent.step(ts, marker=marker)
    float(metrics["loss"])
    wall_ms = (time.perf_counter() - t0) * 1e3
    breakdown: dict = {}
    for (_, a), (label, b) in zip(events, events[1:]):
        breakdown[label] = breakdown.get(label, 0.0) + a.elapsed_time(b)
    total = sum(breakdown.values())
    row["qlearn_breakdown"] = {
        "chunk_ms": wall_ms, "events_ms": total, "ms": breakdown,
        "share": {k: v / total for k, v in breakdown.items()},
        "agent_steps_per_s": workers * steps / wall_ms * 1e3,
        **_device_busy(torch, lambda: float(agent.step(ts)[1]["loss"]))}

    # (b) two chunks of each other learner, the second one timed.
    for name, extra in REFERENCE_OTHERS.items():
        c = FrameworkConfig().apply_overrides(REFERENCE + extra)
        env = make_trading_env(prices, window=c.env.window, device="cuda")
        learner = build_agent(c, env, device="cuda")
        _, rows = _chunk_rows(torch, learner, learner.init(c.seed), 2)
        m = rows[-1]["metrics"]
        row[name] = {
            "chunk_ms": [r["ms"] for r in rows],
            "agent_steps_per_s": workers * steps / rows[-1]["ms"] * 1e3,
            "fused_update_per_chunk": [r["launches"] for r in rows],
            "loss": m["loss"], "env_steps": m["env_steps"],
            "updates": m["updates"],
            **{k: m[k] for k in ("replay_size", "per_max_priority")
               if k in m}}
        if any(r["launches"] != REFERENCE_LAUNCHES[name] for r in rows):
            problems.append(f"{name}: fused_update launches per chunk "
                            f"{[r['launches'] for r in rows]}")
        if not all(np.isfinite(list(r["metrics"].values())).all()
                   for r in rows):
            problems.append(f"{name}: non-finite chunk metrics")
        del learner, env
    torch.cuda.synchronize()
    row["launches"] = _all_launch_counts()
    # ---- end of the counted window.

    # (c) DQN preempted after chunk 2 and resumed from tag_preempt, against
    # two uninterrupted runs (their difference is the floor).
    def dqn_run(name, hook=None, resume=False):
        c = FrameworkConfig().apply_overrides(
            REFERENCE + DQN_RESUME
            + [f"runtime.checkpoint_dir={os.path.join(root, name)}"])
        series = _prices(c.data)
        o = Orchestrator(c, device="cuda",
                         fault_hook=None if hook is None
                         else lambda i, r: hook(o, i, r))
        o.send_training_data(series, resume=resume)
        o.start_training(background=False)
        o.stop()
        torch.cuda.synchronize()
        return o

    save_s: list = []

    def preempt(o, i, r):
        if i == 1:
            save_tagged = o.checkpoints.save_tagged

            def timed(*args, **kwargs):
                t = time.perf_counter()
                try:
                    return save_tagged(*args, **kwargs)
                finally:
                    save_s.append(time.perf_counter() - t)

            o.checkpoints.save_tagged = timed
            o.request_preempt()

    u1, u2 = dqn_run("u1"), dqn_run("u2")
    floor = _state_diff(u1.train_state, u2.train_state)
    p1 = dqn_run("p", hook=preempt)
    p2 = dqn_run("p", resume=True)
    diff = _state_diff(u1.train_state, p2.train_state)
    state_npz = os.path.join(root, "p", "tag_preempt", "state.npz")
    row["dqn_resume"] = {
        "floor": floor, "diff": diff, "preempted": p1.preempted,
        "chunks_after_resume": p2.chunks,
        "save_bytes": (os.path.getsize(state_npz)
                       if os.path.exists(state_npz) else None),
        "save_s": save_s}
    for o, name in ((u1, "u1"), (u2, "u2"), (p2, "p2")):
        if o.lifecycle.phase is not Phase.COMPLETED:
            problems.append(f"dqn {name}: ended {o.lifecycle.phase.value} "
                            f"({o.last_error!r})")
    if not (p1.preempted and p1.preempt_saved):
        problems.append("dqn: the preempted run wrote no tag_preempt")
    if diff["max"] > floor["max"] or (floor["rng_equal"]
                                      and not diff["rng_equal"]):
        problems.append(f"dqn: the resumed run differs from the "
                        f"uninterrupted one by {diff['max']} (floor "
                        f"{floor['max']})")
    shutil.rmtree(root, ignore_errors=True)
    row["problems"] = problems
    return row


#: The portfolios (avg, std) that the eager step ends on: ``cli train``
#: with no ``--set`` (the reference episode), and the flagship's 2-chunk
#: ``cli train`` (the ``cli_train`` phase). The graph must not move a bit
#: of them.
REFERENCE_DIGITS = (3817.440673828125, 592.10595703125)
#: The pipeline phase's (a) episode: the first 2,046 ticks of the series
#: (horizon 1,845: nine chunks and a partial tenth, as the whole episode
#: ends on a partial chunk), so the eager reference takes a third of the
#: whole episode's time; ``REFERENCE_DIGITS`` over the whole episode are
#: held by ``cli_defaults`` and serve_slo (e).
PIPELINE_PRICES = 2046
FLAGSHIP_DIGITS = (2320.290771484375, 263.25079345703125)


def _bit_equal(torch, a, b) -> bool:
    """Two training states equal leaf for leaf, bit for bit (bf16 leaves
    compared as their bits), generators included."""
    from sharetrade_tpu_torch.agents.base import state_items
    ia, ib = state_items(a), state_items(b)
    if [p for p, _ in ia] != [p for p, _ in ib]:
        return False
    for (_, x), (_, y) in zip(ia, ib):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        if not torch.equal(x, y):
            return False
    return bool(torch.equal(a.rng.get_state(), b.rng.get_state()))


def _eager_vs_graph(torch, agent, seed: int, chunks: int = 3,
                    modes=("eager", "graph"), finals=None) -> dict:
    """``chunks`` chunks from ``agent.init(seed)`` eagerly (``agent.step``)
    and through a chunk program (chunk 1 eager, chunk 2 captured and
    replayed, then replays), each of ``modes``: each chunk's wall ms
    (ending in its metrics' readback; the last one a plain replay), the
    launches of each kernel per chunk, peak device memory per chunk (reset
    before each) and over the run, whether the two modes' states and every
    chunk's metrics are bit-equal, and the capture's seconds and graph
    nodes. ``finals``, when given, receives each mode's final state."""
    from sharetrade_tpu_torch.agents.base import ChunkProgram, _metric_vector
    out: dict = {}
    finals = {} if finals is None else finals
    rows = {}
    for mode in modes:
        program = ChunkProgram(agent) if mode == "graph" else None
        ts = agent.init(seed)
        ms, vectors, launches, peaks = [], [], [], []
        for _ in range(chunks):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = _all_launch_counts()
            t0 = time.perf_counter()
            if program is None:
                ts, metrics = agent.step(ts)
                vector = _metric_vector(metrics, tuple(metrics), "cuda")
            else:
                ts, stacked = program(ts)
                vector = stacked.values[0].clone()
            vector.cpu()                                       # syncs
            ms.append((time.perf_counter() - t0) * 1e3)
            after = _all_launch_counts()
            launches.append({k: after[k] - before[k] for k in after
                             if after[k] != before[k]})
            peaks.append(torch.cuda.max_memory_allocated())
            vectors.append(vector)
        finals[mode], rows[mode] = ts, vectors
        out[mode] = {"chunk_ms": ms, "launches_per_chunk": launches,
                     "peak_allocated_bytes": max(peaks),
                     "peak_allocated_bytes_per_chunk": peaks,
                     "metrics": [v.tolist() for v in vectors]}
        if program is not None:
            out[mode].update(capture_s=program.capture_seconds,
                             graph_nodes=program.nodes,
                             launches_per_replay=program.launches_per_replay)
    if len(modes) == 2:
        out["bit_equal"] = (
            _bit_equal(torch, finals["eager"], finals["graph"])
            and all(torch.equal(a, b)
                    for a, b in zip(rows["eager"], rows["graph"])))
        out["launches_equal"] = (out["eager"]["launches_per_chunk"]
                                 == out["graph"]["launches_per_chunk"])
    return out


def _graph_chunk_profile(torch, agent, seed: int) -> dict:
    """A chunk program warmed and captured on a fresh state, then: the
    CUDA-event time of 5 replays (median), and one replay under
    ``torch.profiler`` (the device's busy share)."""
    from sharetrade_tpu_torch.agents.base import ChunkProgram
    program = ChunkProgram(agent)
    holder = [agent.init(seed)]

    def chunk():
        holder[0], stacked = program(holder[0])
        return stacked

    for _ in range(2):
        chunk()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        chunk()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return {"graph_chunk_event_ms": statistics.median(times),
            **_device_busy(torch, lambda: chunk().values.cpu())}


def phase_pipeline(torch) -> dict:
    """The chunk as a CUDA graph and the orchestrator's default hot loop;
    see the module docstring."""
    import shutil
    import tempfile
    from sharetrade_tpu_torch.agents import build_agent
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.env.trading import make_trading_env
    from sharetrade_tpu_torch.runtime import Orchestrator, Phase
    from sharetrade_tpu_torch.utils.logging import EventLog

    base = FrameworkConfig().apply_overrides(REFERENCE)
    prices = _prices(base.data)[:PIPELINE_PRICES]
    horizon = len(prices) - base.env.window
    workers, steps = base.parallel.num_workers, base.runtime.chunk_steps
    chunks = -(-horizon // steps)
    root = tempfile.mkdtemp(prefix="pipeline-")
    problems: list[str] = []
    row: dict = {"phase": "pipeline"}

    # ---- the counted window: counts reset just before, read just after.
    _reset_launch_counts()
    # (a) the reference workload's episode over the series' first
    # PIPELINE_PRICES ticks: eagerly (agent.step, each chunk read back),
    # then through the orchestrator at its defaults (graph, async pipeline,
    # a sample every 10 chunks), at K=8, and at K=8 with double buffering
    # (pipeline off).
    env = make_trading_env(prices, window=base.env.window, device="cuda")
    agent = build_agent(base, env, device="cuda")
    ts = agent.init(base.seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(chunks):
        ts, metrics = agent.step(ts)
        float(metrics["loss"])                             # syncs
    eager_s = time.perf_counter() - t0
    eager_ts = ts
    eager_digits = (float(metrics["portfolio_mean"]),
                    float(metrics["portfolio_std"]))
    runs = {}
    for name, extra in (
            ("default", []),
            ("k8", ["runtime.megachunk_factor=8"]),
            ("k8_double_buffer", ["runtime.megachunk_factor=8",
                                  "runtime.async_pipeline=false",
                                  "runtime.double_buffer_dispatch=true"])):
        cfg = FrameworkConfig().apply_overrides(
            REFERENCE + extra
            + [f"runtime.checkpoint_dir={os.path.join(root, name)}"])
        log_path = os.path.join(root, f"{name}.jsonl")
        events = EventLog(log_path)
        orch = Orchestrator(cfg, device="cuda", event_log=events)
        orch.send_training_data(prices)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orch.start_training(background=False)
        wall_s = time.perf_counter() - t0
        orch.stop()
        events.close()
        done = [json.loads(ln) for ln in open(log_path)
                if '"training_completed"' in ln]
        program = orch._program
        avg, std = orch.get_avg().value, orch.get_std().value
        runs[name] = {
            "completed": orch.lifecycle.phase is Phase.COMPLETED,
            "wall_s": wall_s, "agent_steps_per_s": workers * horizon / wall_s,
            "timer": {k: done[0].get(k) for k in (
                "chunks_timed", "total_seconds", "mean_chunk_seconds",
                "mean_agent_steps_per_sec")} if done else None,
            "avg_portfolio": avg, "std_portfolio": std,
            "bit_equal_eager": _bit_equal(torch, orch.train_state, eager_ts),
            "capture_s": program.capture_seconds,
            "graph_nodes": program.nodes, "replays": program.replays,
            "launches_per_replay": program.launches_per_replay,
            "pipeline_stats": orch.pipeline_stats}
        if not runs[name]["completed"] or not runs[name]["bit_equal_eager"]:
            problems.append(f"reference {name}: completed "
                            f"{runs[name]['completed']}, bit-equal to the "
                            f"eager episode {runs[name]['bit_equal_eager']} "
                            f"({orch.last_error!r})")
        if (avg, std) != eager_digits:
            problems.append(f"reference {name}: portfolio {avg!r} / {std!r}, "
                            f"the eager episode's {eager_digits}")
        if program.launches_per_replay != {
                "fused_update": REFERENCE_LAUNCHES["qlearn"]}:
            problems.append(f"reference {name}: launches per replay "
                            f"{program.launches_per_replay}")
        del orch
    row["reference"] = {
        "prices": len(prices), "chunks": chunks, "eager_episode_s": eager_s,
        "eager_chunk_ms": eager_s / chunks * 1e3,
        "eager_agent_steps_per_s": workers * horizon / eager_s,
        "runs": runs,
        "graph_chunk_ms": runs["default"]["wall_s"] / chunks * 1e3,
        "graph": _graph_chunk_profile(torch, agent, base.seed)}
    del agent, env, ts, eager_ts

    # (b) three chunks of each other learner, eager against graph.
    for name, extra in REFERENCE_OTHERS.items():
        c = FrameworkConfig().apply_overrides(REFERENCE + extra)
        env = make_trading_env(prices, window=c.env.window, device="cuda")
        learner = build_agent(c, env, device="cuda")
        row[name] = _eager_vs_graph(torch, learner, c.seed)
        if not (row[name]["bit_equal"] and row[name]["launches_equal"]):
            problems.append(f"{name}: graph chunks differ from eager ones "
                            f"(bit-equal {row[name]['bit_equal']}, launches "
                            f"equal {row[name]['launches_equal']})")
        del learner, env

    # (c) the flagship: three PPO chunks, eager against graph.
    cfg = FrameworkConfig().apply_overrides(FLAGSHIP_TRAIN)
    series = _prices(cfg.data)
    env = make_trading_env(series, window=cfg.env.window, device="cuda")
    flagship = build_agent(cfg, env, device="cuda")
    row["flagship"] = _eager_vs_graph(torch, flagship, cfg.seed)
    updates = cfg.learner.ppo_epochs * cfg.learner.ppo_minibatches
    layers = cfg.model.num_layers
    expect = {"flash_fwd": layers * (1 + updates),
              "flash_bwd_dq": layers * updates,
              "flash_bwd_dkv": layers * updates, "fused_update": updates}
    row["flagship"]["expected_per_chunk"] = expect
    got = row["flagship"]["graph"]["launches_per_chunk"]
    if any(c != expect for c in got):
        problems.append(f"flagship: launches per chunk {got}, expected "
                        f"{expect}")
    if not row["flagship"]["bit_equal"]:
        problems.append("flagship: graph chunks differ from eager ones")
    row["flagship"]["graph_profile"] = _graph_chunk_profile(
        torch, flagship, cfg.seed)
    del flagship, env
    torch.cuda.synchronize()
    row["launches"] = _all_launch_counts()
    # ---- end of the counted window.
    shutil.rmtree(root, ignore_errors=True)
    row["problems"] = problems
    return row


#: The journal phase: DQN at the JAX package's defaults (the 203 -> 200 -> 3
#: Q-network, 10 agents, 200-step chunks, replay_capacity 65,536,
#: replay_batch 256, the 6,046-tick series: horizon 5,845) with the
#: transition journal on (``learner.journal_replay``), through the
#: orchestrator's defaults (graph, async pipeline, sampled readback).
JOURNAL = ["learner.algo=dqn", "learner.journal_replay=true"]
#: (c) preempts once this many chunks are done, (d) raises in chunk
#: JOURNAL_FAULT_CHUNK (once) and poisons agent 3 after chunk
#: JOURNAL_POISON_CHUNK (once).
JOURNAL_PREEMPT_CHUNK = 10
JOURNAL_FAULT_CHUNK = 8
JOURNAL_POISON_CHUNK = 4


def _journal_records(path: str) -> list[tuple[int, int, bytes]]:
    """``(env-step stamp, rows, payload)`` of each transition record of the
    journal at ``path`` (sealed segments first), in order."""
    from sharetrade_tpu_torch.data.journal import (
        iter_framed_records, segment_paths)
    from sharetrade_tpu_torch.data.transitions import peek_transitions_header
    out = []
    for p in (*segment_paths(path), path):
        for _, payload in iter_framed_records(p):
            head = peek_transitions_header(payload)
            if head is not None:
                out.append((head[2], head[0], payload))
    return out


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def _journal_vs_replay(path: str, replay) -> dict:
    """The journal's records against a replay buffer that never wrapped:
    rows, stamps (strictly increasing: no chunk journaled twice), and
    whether its rows, decoded in order, are the buffer's first rows bit
    for bit (each pushed row journaled exactly once)."""
    from sharetrade_tpu_torch.data.transitions import read_tail_transitions
    recs = _journal_records(path)
    stamps = [s for s, _, _ in recs]
    rows = sum(n for _, n, _ in recs)
    size = int(replay.size)
    tail = read_tail_transitions(path, 0)
    equal = tail is not None and rows == size and all(
        np.array_equal(_bits(got), _bits(want[:size].cpu().numpy()))
        for got, want in zip(tail[:4], (replay.obs, replay.action,
                                        replay.reward, replay.next_obs)))
    return {"records": len(recs), "rows": rows, "replay_size": size,
            "stamps_increasing": all(a < b for a, b in
                                     zip(stamps, stamps[1:])),
            "rows_equal_replay": bool(equal),
            "bytes": sum(len(p) for _, _, p in recs)}


def _replay_equal(torch, a, b) -> bool:
    """Two replay buffers' slots, write position and size bit for bit."""
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in
               ("obs", "action", "reward", "next_obs", "pos", "size"))


def phase_journal(torch) -> dict:
    """DQN's transition journal and its warm start through the chunk
    graph, and the price journal through the CLI; see the module
    docstring."""
    import dataclasses
    import shutil
    from sharetrade_tpu_torch.agents import build_agent
    from sharetrade_tpu_torch.agents.base import (
        ChunkProgram, _split_transitions)
    from sharetrade_tpu_torch.config import DataConfig, FrameworkConfig
    from sharetrade_tpu_torch.data.journal import Journal
    from sharetrade_tpu_torch.data.service import PriceDataService
    from sharetrade_tpu_torch.data.transitions import encode_transitions
    from sharetrade_tpu_torch.env.trading import make_trading_env
    from sharetrade_tpu_torch.runtime import Orchestrator, Phase
    from sharetrade_tpu_torch.utils.logging import EventLog

    root = _fresh_dir("journal-")
    problems: list[str] = []
    row: dict = {"phase": "journal", "card": _nvidia_smi()}

    def config(name, *extra, journal=True):
        return FrameworkConfig().apply_overrides(
            REFERENCE + (JOURNAL if journal else ["learner.algo=dqn"])
            + list(extra)
            + [f"runtime.checkpoint_dir={os.path.join(root, name, 'ckpt')}",
               f"data.journal_dir={os.path.join(root, name, 'journal')}"])

    def journal_path(name):
        return os.path.join(root, name, "journal", "transitions.journal")

    base = config("base")
    prices = _prices(base.data)
    horizon = len(prices) - base.env.window
    workers, steps = base.parallel.num_workers, base.runtime.chunk_steps
    chunks = -(-horizon // steps)
    expected_rows = workers * horizon
    row.update(prices=len(prices), horizon=horizon, chunks=chunks,
               expected_rows=expected_rows)
    runs = 0

    def run(name, *extra, journal=True, hook=None, resume=False,
            draw_hook=None, before=None):
        """One run to its end through the orchestrator; returns it and its
        facts (wall s, the timer's chunk ms, journal appends' host ms)."""
        nonlocal runs
        runs += 1
        cfg = config(name, *extra, journal=journal)
        log_path = os.path.join(root, f"events-{runs}.jsonl")
        events = EventLog(log_path)
        o = Orchestrator(cfg, device="cuda", event_log=events,
                         fault_hook=None if hook is None
                         else lambda i, r: hook(o, i, r))
        append_ms: list[float] = []
        append = o._journal_transitions

        def timed_append(transitions, env_steps):
            t = time.perf_counter()
            append(transitions, env_steps)
            append_ms.append((time.perf_counter() - t) * 1e3)

        o._journal_transitions = timed_append
        o.send_training_data(prices, resume=resume)
        if draw_hook is not None:
            o._program.agent = dataclasses.replace(
                o.agent, draw=draw_hook(o, o.agent.draw))
        if before is not None:
            before(o)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o.start_training(background=False)
        wall = time.perf_counter() - t0
        o.stop()
        events.close()
        done = [json.loads(ln) for ln in open(log_path)
                if '"training_completed"' in ln]
        timer = done[0] if done else {}
        facts = {"completed": o.lifecycle.phase is Phase.COMPLETED,
                 "wall_s": wall, "chunks": o.chunks,
                 "mean_chunk_ms": (timer.get("mean_chunk_seconds") or 0) * 1e3,
                 "restarts": o.restarts, "agent_heals": o.agent_heals,
                 "pipeline_stalls": o.metrics.counters().get(
                     "pipeline_stalls_total", 0.0),
                 "checkpoints": o.metrics.counters().get(
                     "checkpoints_total", 0.0)}
        if append_ms:
            facts["append_ms_median"] = statistics.median(append_ms)
            facts["append_ms_max"] = max(append_ms)
        if not facts["completed"] and not o.preempted:
            problems.append(f"{name}: ended {o.lifecycle.phase.value} "
                            f"({o.last_error!r})")
        return o, facts

    # ---- the counted window: counts reset just before, read just after.
    _reset_launch_counts()
    # (a) one journaled episode, uniform and PER: the rows journaled
    # against the expected count, each exactly once.
    finals = {}
    for name, extra in (("uniform", []),
                        ("per", ["learner.replay_priority=per"])):
        o, facts = run(name, *extra)
        program = o._program
        facts.update(_journal_vs_replay(journal_path(name),
                                        o.train_state.extras.replay))
        facts.update(capture_s=program.capture_seconds,
                     graph_nodes=program.nodes, replays=program.replays,
                     launches_per_replay=program.launches_per_replay)
        row[f"a_{name}"] = facts
        if not (facts["rows"] == expected_rows
                and facts["records"] == chunks
                and facts["stamps_increasing"]
                and facts["rows_equal_replay"]):
            problems.append(f"a {name}: {facts['records']} records, "
                            f"{facts['rows']} rows (expected {chunks}, "
                            f"{expected_rows}), stamps increasing "
                            f"{facts['stamps_increasing']}, rows equal the "
                            f"replay {facts['rows_equal_replay']}")
        if program.launches_per_replay != {
                "fused_update": REFERENCE_LAUNCHES["dqn"]}:
            problems.append(f"a {name}: launches per replay "
                            f"{program.launches_per_replay}")
        finals[name] = o
    torch.cuda.synchronize()
    row["launches"] = _all_launch_counts()
    # ---- end of the counted window.

    # (b) the first four chunks eagerly, their transitions encoded as the
    # orchestrator journals them: byte-equal to the graph run's records
    # (chunk 1 its eager warm-up, 2 its capture's first replay, 3-4
    # replays), stamps included.
    env = make_trading_env(prices, window=base.env.window, device="cuda")
    agent = build_agent(base, env, device="cuda")
    ts = agent.init(base.seed)
    records = _journal_records(journal_path("uniform"))
    same = []
    for c in range(4):
        ts, metrics = agent.step(ts)
        _, tr = _split_transitions(metrics)
        host = {k: v.cpu().numpy() for k, v in tr.items()}
        valid = host["valid"].reshape(-1)
        flat = {k: host[k].reshape((-1,) + host[k].shape[2:])[valid]
                for k in ("obs", "action", "reward", "next_obs")}
        payload = encode_transitions(
            flat["obs"], flat["action"], flat["reward"], flat["next_obs"],
            env_steps=int(metrics["env_steps"]))
        same.append(payload == records[c][2])
    row["b"] = {"chunks_byte_equal": same}
    if not all(same):
        problems.append(f"b: graph records differ from eager chunks {same}")
    del agent, env, ts

    # (c) preempted once JOURNAL_PREEMPT_CHUNK chunks are done, resumed:
    # the warm-started replay equals the checkpoint's, and the uniform run
    # ends bit-equal to (a)'s.
    def preempt_after(o, draw):
        def hooked(ts):
            if int(ts.env_steps) >= JOURNAL_PREEMPT_CHUNK * steps:
                o.request_preempt()
            return draw(ts)
        return hooked

    c_row = {}
    for name, extra in (("uniform", []),
                        ("per", ["learner.replay_priority=per"])):
        tag = f"resume_{name}"
        p1, _ = run(tag, *extra, draw_hook=preempt_after)
        warm = {}

        def compare(o, warm=warm):
            saved, _meta = o.checkpoints.restore_tagged(
                o.agent.init(o.cfg.seed), "preempt")
            warm["equal"] = _replay_equal(torch, o._ts.extras.replay,
                                          saved.extras.replay)
            warm["size"] = int(o._ts.extras.replay.size)

        if name == "uniform":
            p2, facts = run(tag, *extra, resume=True, before=compare)
            facts.update(_journal_vs_replay(journal_path(tag),
                                            p2.train_state.extras.replay))
            facts["bit_equal_uninterrupted"] = _bit_equal(
                torch, p2.train_state, finals["uniform"].train_state)
        else:
            # PER reseeds the priorities by design: its rows are checked,
            # not its run.
            cfg = config(tag, *extra)
            p2 = Orchestrator(cfg, device="cuda")
            p2.send_training_data(prices, resume=True)
            compare(p2)
            p2.stop()
            facts = {}
        facts.update(preempted=p1.preempted, preempt_saved=p1.preempt_saved,
                     warm_start_equal_checkpoint=warm.get("equal"),
                     warm_rows=warm.get("size"))
        c_row[name] = facts
        if not (p1.preempted and p1.preempt_saved and warm.get("equal")
                and warm.get("size", 0) > 0):
            problems.append(f"c {name}: preempted {p1.preempted}, saved "
                            f"{p1.preempt_saved}, warm-started rows "
                            f"{warm.get('size')} equal to the checkpoint's "
                            f"{warm.get('equal')}")
        if name == "uniform" and not (
                facts["bit_equal_uninterrupted"]
                and facts["stamps_increasing"]
                and facts["rows"] == expected_rows
                and facts["rows_equal_replay"]):
            problems.append(f"c uniform: bit-equal "
                            f"{facts['bit_equal_uninterrupted']}, rows "
                            f"{facts['rows']}, stamps increasing "
                            f"{facts['stamps_increasing']}, rows equal the "
                            f"replay {facts['rows_equal_replay']}")
        del p1, p2
    row["c"] = c_row

    # (d) a fault in chunk JOURNAL_FAULT_CHUNK + 1 (a supervised restart
    # from the last checkpoint, whose chunks re-run) and a poisoned agent
    # healed in place: nothing journaled twice, every pushed row once.
    fired: list[int] = []

    def fault(o, i, r):
        if i == JOURNAL_FAULT_CHUNK and not fired:
            fired.append(i)
            raise RuntimeError("injected fault")

    poisoned: list[int] = []

    def poison(o, i, r):
        if i == JOURNAL_POISON_CHUNK and not poisoned:
            poisoned.append(i)
            env_state = o._ts.env_state
            budget = env_state.budget.clone()
            budget[3] = float("nan")
            o._ts = o._ts.replace(env_state=env_state.replace(budget=budget))

    d_row = {}
    for name, hook in (("restart", fault), ("heal", poison)):
        o, facts = run(name, "runtime.backoff_initial_s=0.01",
                       "runtime.backoff_max_s=0.05", hook=hook)
        facts.update(_journal_vs_replay(journal_path(name),
                                        o.train_state.extras.replay))
        if name == "restart":
            facts["bit_equal_uninterrupted"] = _bit_equal(
                torch, o.train_state, finals["uniform"].train_state)
            ok = (o.restarts == 1 and facts["rows"] == expected_rows
                  and facts["bit_equal_uninterrupted"])
        else:
            ok = o.agent_heals == 1 and o.restarts == 0
        ok = (ok and facts["completed"] and facts["stamps_increasing"]
              and facts["rows_equal_replay"])
        d_row[name] = facts
        if not ok:
            problems.append(f"d {name}: {facts}")
        del o
    row["d"] = d_row

    # (e) what journaling costs: the episode with and without it, a
    # replayed chunk of each by CUDA events, and one chunk's readback.
    plain, plain_facts = run("plain", journal=False)
    del plain
    env = make_trading_env(prices, window=base.env.window, device="cuda")
    e_row = {"plain": plain_facts,
             "journaled": {k: row["a_uniform"][k] for k in (
                 "wall_s", "mean_chunk_ms", "append_ms_median",
                 "append_ms_max")}}
    for name, cfg in (("plain", config("e", journal=False)), ("journaled",
                                                               base)):
        agent = build_agent(cfg, env, device="cuda")
        e_row[name]["graph"] = _graph_chunk_profile(torch, agent, cfg.seed)
        program = ChunkProgram(agent)
        ts = agent.init(cfg.seed)
        for _ in range(3):
            ts, stacked = program(ts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        readback = program.readback(stacked)
        readback.rows()
        host = readback.transitions()
        e_row[name]["readback_ms"] = (time.perf_counter() - t0) * 1e3
        e_row[name]["readback_bytes"] = stacked.values.numel() * 8 + (
            0 if host is None else sum(v.nbytes for v in host.values()))
        del agent, program, ts, stacked
    row["e"] = e_row

    # (f) cli query and a default cli train in a fresh working directory:
    # the price journal they leave is recovered by the port's service.
    cwd = _fresh_dir("cli-journal-")

    def cli(*args, timeout):
        return subprocess.run(
            [sys.executable, "-m", "sharetrade_tpu_torch.cli", *args],
            capture_output=True, text=True, timeout=timeout, cwd=cwd,
            env=_cli_env())

    train = cli("train", "--device", "cuda", timeout=600)
    query = cli("query", "--symbol", "MSFT", timeout=120)
    price_journal = os.path.join(cwd, "journal", "price-events.journal")

    def refuse(symbol, start=None, end=None):
        raise RuntimeError("a recovered cache must not fetch")

    fetches, recovered, rows = [], [], None
    if os.path.exists(price_journal):
        with Journal(price_journal) as j:
            fetches = [e["type"] for e in j.replay()]
        service = PriceDataService(provider=refuse, config=DataConfig(
            journal_dir=os.path.join(cwd, "journal")))
        try:
            recovered = service.cached_symbols()
            if recovered == ["MSFT"]:
                rows = len(service.request("MSFT").series)
        finally:
            service.close()
    lines = [ln for ln in train.stdout.splitlines() if ln.startswith("{")]
    summary = json.loads(lines[-1]) if lines else {}
    query_line = (json.loads(query.stdout.strip().splitlines()[-1])
                  if query.stdout.strip() else {})
    row["f"] = {"train_rc": train.returncode, "query_rc": query.returncode,
                "query": query_line, "fetch_events": fetches,
                "recovered": recovered, "recovered_rows": rows,
                "train_avg_portfolio": summary.get("avg_portfolio")}
    if not (train.returncode == 0 and query.returncode == 0
            and fetches == ["prices_fetched"] and recovered == ["MSFT"]
            and rows == len(prices) and query_line.get("rows") == len(prices)
            and query_line.get("symbol") == "MSFT"
            and np.isfinite(summary.get("avg_portfolio", float("nan")))):
        problems.append(f"f: {row['f']}")
        row["f"]["stderr_tail"] = train.stderr[-1500:] + query.stderr[-500:]
    finals.clear()
    shutil.rmtree(root, ignore_errors=True)
    row["problems"] = problems
    return row


def phase_cli_defaults() -> dict:
    """``cli train --eval`` and then ``cli serve`` as a user runs them, at
    the JAX package's defaults (the reference workload), with no ``--set``
    but the checkpoint directory: serve boots from train's ``tag_best``."""
    import tempfile
    row: dict = {"phase": "cli_defaults"}
    with tempfile.TemporaryDirectory(prefix="cli-defaults-") as ckpts:
        where = ["--set", f"runtime.checkpoint_dir={ckpts}"]
        t0 = time.perf_counter()
        train = subprocess.run(
            [sys.executable, "-m", "sharetrade_tpu_torch.cli", "train",
             "--eval"] + where, capture_output=True, text=True, timeout=600,
            cwd=_fresh_dir("cli-"), env=_cli_env())
        row["train_seconds"] = time.perf_counter() - t0
        lines = [ln for ln in train.stdout.splitlines() if ln.startswith("{")]
        summary = json.loads(lines[-1]) if lines else {}
        best_path = os.path.join(ckpts, "tag_best", "meta.json")
        best = (json.load(open(best_path)) if os.path.exists(best_path)
                else {})
        t0 = time.perf_counter()
        serve = subprocess.run(
            [sys.executable, "-m", "sharetrade_tpu_torch.cli", "serve",
             "--duration", "3"] + where, capture_output=True, text=True,
            timeout=300, cwd=_fresh_dir("cli-"), env=_cli_env())
        row["serve_seconds"] = time.perf_counter() - t0
    served = [json.loads(ln) for ln in serve.stdout.splitlines()
              if ln.startswith("{")]
    row.update(train_rc=train.returncode, train_summary=summary,
               serve_rc=serve.returncode,
               serving_ready=served[0] if served else None,
               serve_summary=served[-1] if served else None,
               unported_warnings=serve.stderr.count("not yet ported"))
    ok = (train.returncode == 0 and serve.returncode == 0 and len(served) >= 2
          and set(summary) >= {"avg_portfolio", "std_portfolio", "env_steps",
                               "agent_steps_per_sec", "restarts"}
          and (summary.get("avg_portfolio"), summary.get("std_portfolio"))
          == REFERENCE_DIGITS
          and np.isfinite(summary.get("eval_portfolio", float("nan")))
          and summary.get("kernel_launches", {}).get("fused_update", 0) > 0
          and best.get("updates")
          and served[0].get("params_step") == best["updates"]
          and served[0].get("model") == "q_mlp"
          and served[-1].get("completed", 0) > 0
          and served[-1].get("failed", 1) == 0
          and served[0].get("swap_watcher") is True
          and row["unported_warnings"] == 0)
    row["ok"] = bool(ok)
    if not ok:
        row["stderr_tail"] = train.stderr[-1500:] + serve.stderr[-1500:]
    return row


#: The families phase: the other policy families at full width, each a
#: config of benchmarks/run_all.py (``ppo_transformer``,
#: ``ppo_transformer_bf16``, ``ppo_lstm``, ``ppo_tcn``) or the README's
#: (the window transformer with ``moe_experts=8``, top-2 and the
#: dense-mask top-0; the 2-asset portfolio of ``--symbol MSFT,AAPL``), at
#: the JAX defaults otherwise: 10 agents, window 201, adagrad, 4 epochs of
#: 2 minibatches (4 requested, the largest divisor of 10 below).
_FAMILY_TRANSFORMER = ["model.kind=transformer", "model.num_layers=2",
                       "model.num_heads=4", "model.head_dim=64",
                       "learner.unroll_len=32", "runtime.chunk_steps=32"]
FAMILIES = {
    "ppo_transformer": _FAMILY_TRANSFORMER,
    "ppo_transformer_bf16": [
        "model.kind=transformer", "model.num_layers=2", "model.num_heads=2",
        "model.head_dim=128", "precision.mode=bf16_mixed",
        "learner.unroll_len=32", "runtime.chunk_steps=32"],
    "ppo_transformer_moe_top2": _FAMILY_TRANSFORMER + [
        "model.moe_experts=8", "model.moe_top_k=2"],
    "ppo_transformer_moe_top0": _FAMILY_TRANSFORMER + [
        "model.moe_experts=8", "model.moe_top_k=0"],
    "ppo_lstm": ["model.kind=lstm", "learner.unroll_len=128",
                 "runtime.chunk_steps=128"],
    "ppo_tcn": ["model.kind=tcn", "model.hidden_dim=64",
                "learner.unroll_len=128", "runtime.chunk_steps=128"],
    "ppo_portfolio": _FAMILY_TRANSFORMER,
}
FAMILY_BASE = ["learner.algo=ppo", "parallel.num_workers=10"]
#: fused_update over each family's leaf list (3-D leaves among them: the
#: TCN's (3, 64, 64) filters, the MoE's (8, 256, 1024) expert matrices),
#: adagrad, with the gradient dtype its training path gives it: float32,
#: or under bf16_mixed bf16 and the compute copy emitted; the MoE's and the
#: TCN's 3-D leaves in both. Held as UPDATE_CASES are (families (d)).
FAMILY_UPDATE_CASES = [
    dict(name=f"{family}_adagrad_{tag}", optimizer="adagrad",
         grad_dtype={"f32": "float32", "bf16": "bfloat16"}[tag],
         emit=tag == "bf16", model=family)
    for family, tag in (
        ("ppo_transformer", "f32"), ("ppo_transformer_bf16", "bf16"),
        ("ppo_transformer_moe_top2", "f32"),
        ("ppo_transformer_moe_top2", "bf16"), ("ppo_lstm", "f32"),
        ("ppo_tcn", "f32"), ("ppo_tcn", "bf16"), ("ppo_portfolio", "f32"))]
#: The portfolio family's symbols (``cli train --symbol MSFT,AAPL``).
PORTFOLIO_SYMBOLS = ("MSFT", "AAPL")
FAMILY_CHUNKS = 3
#: Closed-loop serving of each family: sessions, seconds.
FAMILY_SERVE_SESSIONS, FAMILY_SERVE_S = 192, 2.0
#: Ticks of the checked serving batch: one cold, then warm.
FAMILY_SERVE_TICKS = 4
#: Serving the families, (logits, values) against the plain path on the
#: same rows. float32: the kernel and the plain attention sum the same f32
#: products in another order (errors of about 1e-7 to 1e-6 on logits of
#: order 0.1 and values of order 1 on the H100, PERF.md), so 1e-4 leaves
#: two orders for depth and batch. bfloat16: the flagship's LOGIT_ATOL /
#: VALUE_ATOL.
FAMILY_SERVE_ATOL = {"float32": (1e-4, 1e-4),
                     "bfloat16": (LOGIT_ATOL, VALUE_ATOL)}


def _family_prices(name: str, data) -> np.ndarray:
    """The family's series: MSFT's prices, or the portfolio's (2, T)
    matrix of MSFT and AAPL on their common dates (``cli train``'s
    ``align_series``), journaled into a fresh scratch directory."""
    import dataclasses

    from sharetrade_tpu_torch.data.ingest import align_series
    from sharetrade_tpu_torch.data.service import PriceDataService
    if name != "ppo_portfolio":
        return _prices(data)
    service = PriceDataService(config=dataclasses.replace(
        data, journal_dir=_fresh_dir("prices-")))
    try:
        return align_series([service.request(s).series
                             for s in PORTFOLIO_SYMBOLS])
    finally:
        service.close()


def _family_env(prices, cfg):
    from sharetrade_tpu_torch.env.portfolio import make_portfolio_env
    from sharetrade_tpu_torch.env.trading import make_trading_env
    make = make_portfolio_env if prices.ndim == 2 else make_trading_env
    return make(prices, window=cfg.env.window,
                initial_budget=cfg.env.initial_budget,
                initial_shares=cfg.env.initial_shares, device="cuda")


def _family_train(torch, name, cfg, overrides, prices) -> tuple[dict, list]:
    """(a) FAMILY_CHUNKS chunks eagerly (``agent.step``, each read back),
    then the same chunks through the orchestrator at its defaults (an eager
    first chunk, then graph replays, the async readback pipeline,
    checkpoints) over a series of exactly that many chunks: the final
    states bit-equal, every kernel's launches equal; then three replays
    timed alone (``replay_chunk_ms``); (b) for the
    transformers, one replay minibatch through the kernels and the plain
    attention (MB_* rules)."""
    import shutil
    import tempfile
    from sharetrade_tpu_torch.agents import build_agent
    from sharetrade_tpu_torch.runtime import Orchestrator, Phase

    window, steps = cfg.env.window, cfg.runtime.chunk_steps
    series = prices[..., :window + FAMILY_CHUNKS * steps]
    env = _family_env(series, cfg)
    agent = build_agent(cfg, env, device="cuda")
    problems: list[str] = []
    row: dict = {"config": overrides, "obs_dim": env.obs_dim,
                 "num_actions": env.num_actions}
    ts = agent.init(cfg.seed)
    torch.cuda.synchronize()
    chunk_ms, per_chunk, losses = [], [], []
    for _ in range(FAMILY_CHUNKS):
        before = _all_launch_counts()
        t0 = time.perf_counter()
        ts, metrics = agent.step(ts)
        losses.append({k: float(metrics[k]) for k in (
            "loss", "policy_loss", "value_loss", "entropy")})      # syncs
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        after = _all_launch_counts()
        per_chunk.append({k: after[k] - before[k] for k in after})
    row["eager"] = {"chunk_ms": chunk_ms, "launches_per_chunk": per_chunk,
                    "losses": losses}
    if not all(np.isfinite(list(x.values())).all() for x in losses):
        problems.append(f"{name}: non-finite losses")
    if cfg.model.kind == "transformer" and any(
            c[k] <= 0 for c in per_chunk
            for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")):
        problems.append(f"{name}: an attention kernel did not launch")
    if any(c["fused_update"] <= 0 for c in per_chunk):
        problems.append(f"{name}: fused_update did not launch")

    root = tempfile.mkdtemp(prefix="family-", dir=_SCRATCH)
    # No restarts: a fault fails the check at once instead of backing off.
    ocfg = cfg.apply_overrides(["runtime.episodes=1", "runtime.max_restarts=0",
                                f"runtime.checkpoint_dir={root}"])
    orch = Orchestrator(ocfg, device="cuda")
    orch.send_training_data(series)
    before = _all_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    orch.start_training(background=False)
    wall_s = time.perf_counter() - t0
    after = _all_launch_counts()
    program = orch._program
    completed = orch.lifecycle.phase is Phase.COMPLETED
    bit_equal = _bit_equal(torch, orch.train_state, ts)
    launches = {k: after[k] - before[k] for k in after}
    eager_total = {k: sum(c[k] for c in per_chunk) for k in per_chunk[0]}
    # A replayed chunk alone, after the run (the state goes on past it).
    replay_ms, live = [], orch.train_state
    for _ in range(3):
        t1 = time.perf_counter()
        live, stacked = program(live)
        stacked.values.cpu()                                   # syncs
        replay_ms.append((time.perf_counter() - t1) * 1e3)
    row["orchestrator"] = {
        "completed": completed, "wall_s": wall_s,
        "agent_steps_per_s": (cfg.parallel.num_workers * FAMILY_CHUNKS
                              * steps / wall_s),
        "bit_equal_eager": bit_equal, "capture_s": program.capture_seconds,
        "graph_nodes": program.nodes, "replays": program.replays,
        "replay_chunk_ms": replay_ms, "launches": launches,
        "launches_per_replay": program.launches_per_replay}
    orch.stop()
    del orch
    shutil.rmtree(root, ignore_errors=True)
    if not (completed and bit_equal):
        problems.append(f"{name}: orchestrator run completed {completed}, "
                        f"bit-equal to the eager chunks {bit_equal}")
    if launches != eager_total or program.replays != FAMILY_CHUNKS + 2 or \
            program.launches_per_replay != {
                k: n for k, n in per_chunk[-1].items() if n}:
        problems.append(f"{name}: launches {launches} / per replay "
                        f"{program.launches_per_replay}, eager {per_chunk}")
    # The main path's launches end here: the minibatch check compares.
    row["launches"] = _all_launch_counts()
    if cfg.model.kind == "transformer":
        row["minibatch"] = _minibatch_check(torch, cfg, env, agent,
                                            agent.init(cfg.seed + 1),
                                            overrides)
        if row["minibatch"]["failed"]:
            problems.append(f"{name}: one minibatch through the kernels "
                            f"disagrees with the plain attention's: "
                            f"{row['minibatch']['failed']}")
    del agent, env, ts
    return row, problems


def _apply_by_step(model, params, obs, carry):
    """``model.apply_batch`` over a batch whose rows may sit at different
    episode steps: the episode transformer's lockstep step takes one step
    per call, so its rows go in groups of one step clock (their answers do
    not depend on each other's at top-0); other carries in one call."""
    import torch
    from sharetrade_tpu_torch.models.core import ModelOut
    if not (isinstance(carry, dict) and "t" in carry):
        return model.apply_batch(params, obs, carry)
    logits = torch.empty((obs.shape[0], model.num_actions),
                         dtype=torch.float32, device=obs.device)
    value = torch.empty((obs.shape[0],), dtype=torch.float32,
                        device=obs.device)
    new = {k: v.clone() for k, v in carry.items()}
    for step in carry["t"].unique().tolist():
        idx = (carry["t"] == step).nonzero()[:, 0]
        out, sub = model.apply_batch(params, obs[idx],
                                     {k: v[idx] for k, v in carry.items()})
        logits[idx], value[idx] = out.logits, out.value
        for k in new:
            new[k][idx] = sub[k].to(new[k].dtype)
    return ModelOut(logits=logits, value=value), new


def _family_serve(torch, name, cfg, prices, *,
                  pin_routing: bool = False) -> tuple[dict, list]:
    """(c) The serving engine on the family's model (its generic program,
    or for the episode transformer its prefill and warm programs):
    ``FAMILY_SERVE_TICKS`` ticks of ``max_batch`` sessions, the first cold
    and the others warm (each session moves on by its served action),
    checked two ways within ``FAMILY_SERVE_ATOL`` for the compute dtype:

    - every device batch the engine ran, recorded with its padded rows and
      the carries it gathered, against the plain path on the same inputs
      (the plain attention for the transformers; the LSTM and the TCN run
      no kernel here, so for them this is the model against itself, as is
      the episode transformer's warm program, whose cache attention is
      plain);
    - where a row's answer does not depend on the rest of its batch (all
      but the MoE top-2, whose routing groups and capacity span the batch),
      every answer against the plain model stepped tick by tick from the
      init carry (``apply_batch``: the episode transformer's lockstep
      step), a session's carry threaded through, apart from the engine:
      this holds the arena's carry bookkeeping (the LSTM's ``(h, c)``
      across warm ticks, the episode transformer's K/V ring).

    With ``pin_routing`` a mixture of experts' plain passes (and an fp32
    pass of each) take the routing of the same pass through the kernels
    (``_routing``, recomputed on the recorded inputs, which must give the
    served answers bit for bit), and ``_flip_check`` holds the decisions
    they would have taken otherwise.

    Then ``FAMILY_SERVE_S`` seconds in closed loop."""
    import dataclasses

    from sharetrade_tpu_torch.models import build_model
    from sharetrade_tpu_torch.models.core import tree_map
    from sharetrade_tpu_torch.precision import policy_from_config
    from sharetrade_tpu_torch.serve import ServeEngine
    from sharetrade_tpu_torch.serve.driver import (make_sessions,
                                                   run_closed_loop)

    window = cfg.env.window
    env = _family_env(prices[..., :window + 2], cfg)
    kw = dict(num_actions=env.num_actions, num_assets=env.num_assets)
    model = build_model(cfg.model, env.obs_dim, device="cuda", **kw)
    params = model.init(torch.Generator().manual_seed(cfg.seed))
    policy = policy_from_config(cfg.precision)
    recorded, recording = [], [False]
    pair = (model.apply_prefill is not None
            and model.apply_serve_batch is not None)
    programs = (("apply_prefill", "apply_serve_batch") if pair
                else ("apply_batch",))

    def recorder(program):
        fn = getattr(model, program)

        def run(p, obs, *rows):
            # Rows copied before the call: the warm program updates the
            # gathered carry in place.
            saved = tree_map(torch.clone, rows) if recording[0] else None
            out, new_rows = fn(p, obs, *rows)
            if recording[0]:
                recorded.append((program, obs.clone(), saved,
                                 out.logits.clone(), out.value.clone()))
            return out, new_rows
        return run

    engine = ServeEngine(dataclasses.replace(
        model, **{program: recorder(program) for program in programs}),
        cfg.serve, params, precision=policy)
    engine.warmup()
    _reset_launch_counts()
    before = dict(engine.counters)
    sessions = make_sessions(prices, window, cfg.serve.max_batch,
                             seed=cfg.seed, prefix="first")
    asked, served = [], []
    recording[0] = True
    for _ in range(FAMILY_SERVE_TICKS):
        obs = np.stack([s.observation() for s in sessions])
        sids = [s.sid for s in sessions]
        results = [h.wait(120.0) for h in [
            engine.submit(sid, o) for sid, o in zip(sids, obs)]]
        if any(r is None for r in results):
            break
        for sess, r in zip(sessions, results):
            sess.advance(r.action)
        asked.append((sids, obs))
        served.append(results)
    recording[0] = False
    load = run_closed_loop(
        engine, make_sessions(prices, window, FAMILY_SERVE_SESSIONS,
                              seed=cfg.seed + 1, prefix="c"),
        concurrency=FAMILY_SERVE_SESSIONS, duration_s=FAMILY_SERVE_S)
    drained = engine.drain(60.0)
    torch.cuda.synchronize()
    launches = _all_launch_counts()
    counters = {k: v - before[k] for k, v in engine.counters.items()}
    stopped = engine.stop(drain=False, timeout_s=10.0)
    if len(served) < FAMILY_SERVE_TICKS:
        return {"failed_ticks": True}, [f"{name}: a request of the checked "
                                        "ticks failed"]
    # The main path's launches end here: the plain path compares.
    plain = (build_model(cfg.model, env.obs_dim, device="cuda",
                         attention_fn=_plain_attention(cfg), **kw)
             if cfg.model.kind == "transformer" else model)
    compute = policy.cast_compute(params)
    dname = "bfloat16" if policy.mixed else "float32"
    logit_atol, value_atol = FAMILY_SERVE_ATOL[dname]
    moe = pin_routing and bool(cfg.model.moe_experts)
    batch_err, rerun_equal, batch_pairs = [0.0, 0.0], True, []

    def floats(rows):
        return tree_map(lambda r: r.float() if r.is_floating_point()
                        else r.clone(), rows)

    def pinned(program, obs, rows):
        """``plain``'s answer on one batch; with a mixture of experts at
        the routing of ``model`` (the kernels) on the same batch, beside
        the kernels' own answer, and an fp32 pass at that routing too."""
        if not moe:
            return getattr(plain, program)(compute, obs,
                                           *tree_map(torch.clone, rows))
        pins = []
        with _routing(pins, replay=False):
            own, own_rows = getattr(model, program)(
                compute, obs, *tree_map(torch.clone, rows))
        with _routing(pins, replay=True) as stats:
            ref, ref_rows = getattr(plain, program)(
                compute, obs, *tree_map(torch.clone, rows))
        with _routing(pins, replay=True) as stats32:
            getattr(plain, program)(params, obs, *floats(rows))
        batch_pairs.append((stats, stats32))
        return ref, ref_rows, own

    with torch.inference_mode():
        for program, obs, rows, logits, value in recorded:
            ref, _, *own = pinned(program, obs, rows)
            if own:
                rerun_equal &= bool(torch.equal(own[0].logits, logits)
                                    and torch.equal(own[0].value, value))
            batch_err[0] = max(batch_err[0],
                               (logits - ref.logits).abs().max().item())
            batch_err[1] = max(batch_err[1],
                               (value - ref.value).abs().max().item())
        session_err, session_routing = None, None
        if not (cfg.model.moe_experts and cfg.model.moe_top_k > 0):
            init = tree_map(lambda c: c[None].expand(
                (len(sessions),) + c.shape).contiguous(), policy.cast_carry(
                    model.init_carry(), model))

            def stepped(m, p=compute, init=init):
                """``m`` under ``p`` stepped tick by tick over the asked
                sessions from ``init``, a session's carry threaded through:
                the answers of each tick."""
                carry, last, answers = init, None, []
                for sids, obs in asked:
                    if last is not None:
                        # A session that wrapped comes back as a new one.
                        fresh = torch.tensor(
                            [a != b for a, b in zip(sids, last)],
                            device="cuda")
                        carry = tree_map(lambda c, c0: torch.where(
                            fresh.reshape((-1,) + (1,) * (c.ndim - 1)), c0,
                            c), carry, init)
                    ref, carry = _apply_by_step(
                        m, p, torch.from_numpy(obs).cuda(), carry)
                    carry = tree_map(lambda c, c0: c.to(c0.dtype), carry,
                                     init)
                    answers.append((ref.logits.cpu().numpy(),
                                    ref.value.cpu().numpy()))
                    last = sids
                return answers

            if moe:
                # Top-1 routes each token alone: the plain steps take the
                # kernel steps' routing, token for token.
                pins = []
                with _routing(pins, replay=False):
                    stepped(model)
                with _routing(pins, replay=True) as stats:
                    answers = stepped(plain)
                with _routing(pins, replay=True) as stats32:
                    stepped(plain, params, floats(init))
                session_routing = _flip_check([(stats, stats32)])
            else:
                answers = stepped(plain)
            session_err = [0.0, 0.0]
            for results, (ref_logits, ref_values) in zip(served, answers):
                session_err[0] = max(session_err[0], float(np.abs(
                    np.stack([r.logits for r in results])
                    - ref_logits).max()))
                session_err[1] = max(session_err[1], float(np.abs(
                    np.array([r.value for r in results])
                    - ref_values).max()))
    row = {"qps": load["qps"], "p50_ms": load.get("p50_ms"),
           "p99_ms": load.get("p99_ms"), "requests": load.get("completed"),
           "failed": load["failed"] + counters["failed"],
           "counters": counters, "launches": launches,
           "checked_ticks": FAMILY_SERVE_TICKS,
           "checked_batches": len(recorded),
           "batch_logit_max_abs_err": batch_err[0],
           "batch_value_max_abs_err": batch_err[1],
           "session_logit_max_abs_err": session_err and session_err[0],
           "session_value_max_abs_err": session_err and session_err[1],
           **({"routing": {"batches": _flip_check(batch_pairs),
                           "sessions": session_routing,
                           "rerun_bit_equal": rerun_equal}}
              if moe else {}),
           "tolerance": {"logit_atol": logit_atol, "value_atol": value_atol}}
    problems: list[str] = []
    for what, err in (("batches", batch_err), ("sessions", session_err)):
        if err and (err[0] > logit_atol or err[1] > value_atol):
            problems.append(f"{name}: served outputs ({what}) disagree with "
                            f"the plain path: {err}")
    if moe:
        if not rerun_equal:
            problems.append(f"{name}: the kernels' rerun of a served batch "
                            "differs from the served answers")
        for what, check in row["routing"].items():
            if isinstance(check, dict) and not check["ok"]:
                problems.append(f"{name}: routing flips ({what}) between "
                                f"the kernels and the plain path: {check}")
    if not recorded or row["failed"] or not (drained and stopped):
        problems.append(f"{name}: serving failed requests or did not stop")
    batches = counters["cold_batches" if pair else "generic_batches"]
    if cfg.model.kind == "transformer" and launches["flash_fwd"] != \
            cfg.model.num_layers * batches:
        problems.append(f"{name}: flash_fwd launches != layers x batches "
                        "through the attention")
    del engine, model, plain, params, recorded
    return row, problems


def _family_cli(name: str, cfg, overrides) -> tuple[dict, list]:
    """The family through the CLI, as a user runs it, in a fresh working
    directory with an empty checkpoint directory: ``cli serve`` for 2 s
    (the seeded init); for the portfolio ``cli train --symbol MSFT,AAPL``
    over a series of three chunks instead (``cli serve`` serves the first
    symbol, as the JAX package's does)."""
    import tempfile
    portfolio = name == "ppo_portfolio"
    cmd = [sys.executable, "-m", "sharetrade_tpu_torch.cli"]
    cmd += (["train", "--symbol", ",".join(PORTFOLIO_SYMBOLS)] if portfolio
            else ["serve", "--duration", "2", "--sessions", "128"])
    steps = FAMILY_CHUNKS * cfg.runtime.chunk_steps
    extra = ([f"data.synthetic_length={cfg.env.window + steps}"]
             if portfolio else [])
    with tempfile.TemporaryDirectory(prefix="family-cli-") as ckpts:
        for item in overrides + extra + [f"runtime.checkpoint_dir={ckpts}"]:
            cmd += ["--set", item]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300, cwd=_fresh_dir("cli-"),
                              env=_cli_env())
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    summary = json.loads(lines[-1]) if lines else {}
    attention = cfg.model.kind == "transformer"
    if portfolio:
        ok = (summary.get("env_steps") == steps and np.isfinite(
            summary.get("avg_portfolio", float("nan")))
              and summary.get("kernel_launches", {}).get("flash_fwd", 0) > 0)
    else:
        ok = (summary.get("completed", 0) > 0
              and summary.get("failed", 1) == 0
              and (summary.get("flash_fwd_launches", 0) > 0) == attention)
    ok = ok and proc.returncode == 0
    row = {"command": "train" if portfolio else "serve",
           "rc": proc.returncode, "seconds": time.perf_counter() - t0,
           "summary": summary, "ok": bool(ok)}
    if not ok:
        row["stderr_tail"] = proc.stderr[-2000:]
    return row, ([] if ok else [f"{name}: cli {row['command']} failed"])


def _family_kernel_rows(torch) -> list[dict]:
    """(d) The attention kernels at the window families' shapes, causal
    with no band: float32 D 64 (4 heads) and bf16 D 128 (2 heads), T 202
    (the window transformer) and 404 (the 2-asset portfolio), at the
    rollout's bh (10 agents x heads), the replay's (32 steps x 5 agents x
    heads) and the serving batch's (64 x heads); the backward at the
    replay's. Timed as the kernels phase times, beside SDPA with
    ``is_causal``. Then fused_update over each family's leaves
    (``FAMILY_UPDATE_CASES``) against its plain version."""
    rows = []
    for dtype, heads, dim in ((torch.float32, 4, 64),
                              (torch.bfloat16, 2, 128)):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for seq in (202, 404):
            for where, batch in (("rollout", 10), ("replay", 160),
                                 ("serving", 64)):
                case = dict(name=f"window_{where}_{tag}_t{seq}", batch=batch,
                            heads=heads, seq=seq, head_dim=dim, window=None,
                            dtype=dtype)
                rows.append(check_flash_fwd(torch, **case))
                if where == "replay":
                    rows += check_flash_bwd(torch, **case)
    rows += [check_fused_update(torch, **case) for case in FAMILY_UPDATE_CASES]
    return [{**r, "phase": "families"} for r in rows]


def phase_families(torch) -> dict:
    """The other policy families; see the module docstring."""
    from concurrent.futures import ThreadPoolExecutor

    from sharetrade_tpu_torch.config import FrameworkConfig

    row: dict = {"phase": "families"}
    problems: list[str] = []
    totals: dict = {}
    cli_args = []
    for name, extra in FAMILIES.items():
        overrides = FAMILY_BASE + extra
        cfg = FrameworkConfig().apply_overrides(overrides)
        prices = _family_prices(name, cfg.data)
        t0 = time.perf_counter()
        _reset_launch_counts()
        train, bad = _family_train(torch, name, cfg, overrides, prices)
        launches = train["launches"]
        problems += bad
        serve, bad = _family_serve(torch, name, cfg, prices)
        problems += bad
        cli_args.append((name, cfg, overrides))
        for k, n in launches.items():
            totals[k] = totals.get(k, 0) + n + serve.get(
                "launches", {}).get(k, 0)
        row[name] = {"train": train, "serve": serve,
                     "seconds": time.perf_counter() - t0}
        torch.cuda.empty_cache()
    # (c) Every family's CLI run at once, after the in-process runs (whose
    # times they would otherwise disturb): most of a run is its process
    # start, and one after another they took half the phase.
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(cli_args)) as pool:
        clis = list(pool.map(lambda args: _family_cli(*args), cli_args))
    row["cli_seconds"] = time.perf_counter() - t0
    for (name, _, _), (cli, bad) in zip(cli_args, clis):
        row[name]["cli"] = cli
        problems += bad
    row["kernels"] = _family_kernel_rows(torch)
    problems += [f"{r['kernel']}:{r['case']} disagrees with its plain "
                 "version" for r in row["kernels"] if not r["ok"]]
    row["launches"] = totals
    row["problems"] = problems
    return row


#: The serving tiers phase (``serve_tiers``): the flagship served as in
#: ``serve``, with the swap watcher, the warm and spill tiers, overload
#: shedding, deadlines, supervised restarts and the batch-1 baseline.
TIERS_SESSIONS = 320            # 320 sessions over the 256-slot arena
TIERS_CYCLES = 3                # passes over them, 64-session batches
TIERS_WARM_CARRIES = 160        # (b): the warm store holds ~160 carries
TIERS_SPILL_WARM_CARRIES = 8    # (c): ~8 in RAM, the rest on disk
TIERS_LOOP_S = 3.0              # each closed / open loop


class _Recorder:
    """The engine's ``submit`` with each result's session, step and tick
    recorded (the swap check's evidence)."""

    def __init__(self, engine):
        self.engine = engine
        self.seen: list[tuple] = []

    def submit(self, sid, obs, callback=None, **kw):
        def cb(result):
            if result is not None:
                self.seen.append((sid, result.params_step, result.batch))
            if callback is not None:
                callback(result)
        return self.engine.submit(sid, obs, cb, **kw)


def _params_state(torch, params, updates: int):
    """A ``TrainState`` holding only ``params`` (the rest empty scalars),
    enough for ``save_tagged`` and a params-only restore."""
    from types import SimpleNamespace

    from sharetrade_tpu_torch.agents.base import TrainState
    zero = torch.zeros(())
    return TrainState(
        params=params, opt_state=({},), carry={},
        env_state=SimpleNamespace(t=zero, budget=zero, shares=zero,
                                  share_value=zero),
        rng=torch.Generator(), env_steps=torch.zeros((), dtype=torch.int32),
        updates=torch.tensor(updates, dtype=torch.int32))


def _flip_byte(path: str) -> None:
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))


def _wait_until(predicate, timeout_s: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


def _serve_round(engine, sids, obs, **kw) -> list:
    """One batch of requests submitted together and waited for."""
    handles = [engine.submit(s, o, **kw) for s, o in zip(sids, obs)]
    return [h.wait(120.0) for h in handles]


def _same(a, b) -> bool:
    """Two answers bit for bit (logits and value)."""
    return (a is not None and b is not None
            and np.array_equal(a.logits, b.logits) and a.value == b.value)


def _tiers_swaps(torch, ctx) -> tuple[dict, list]:
    """(a) Hot swaps under closed-loop load (the watcher's thread polling
    every 0.2 s), then a corrupt candidate and the breaker."""
    import threading

    from sharetrade_tpu_torch.checkpoint import CheckpointManager
    from sharetrade_tpu_torch.serve import ServeEngine, WeightSwapWatcher
    from sharetrade_tpu_torch.serve.driver import make_sessions, run_closed_loop
    from sharetrade_tpu_torch.utils.metrics import MetricsRegistry

    cfg, model, params, policy, prices = (ctx[k] for k in (
        "cfg", "model", "params", "policy", "prices"))
    window = cfg.env.window
    registry = MetricsRegistry()
    engine = ServeEngine(model, cfg.serve, params, precision=policy,
                         registry=registry)
    engine.warmup()
    ckpt = _fresh_dir("swap-ckpt-")
    manager = CheckpointManager(ckpt, fsync=False,
                                precision_mode=cfg.precision.mode)
    versions = {k: model.init(torch.Generator().manual_seed(cfg.seed + k))
                for k in (1, 2, 3)}
    failures = cfg.serve.swap_breaker_failures
    watcher = WeightSwapWatcher(
        engine, manager, params, tag="best", poll_s=0.2,
        breaker_failures=failures, breaker_cooldown_s=60.0).start()
    recorder = _Recorder(engine)
    load: dict = {}
    thread = threading.Thread(target=lambda: load.update(run_closed_loop(
        recorder, make_sessions(ctx["prices"], window, 192, seed=cfg.seed + 5,
                                prefix="sw"), concurrency=192,
        duration_s=TIERS_LOOP_S)))
    thread.start()
    for k in (1, 2):
        time.sleep(0.8)
        manager.save_tagged("best", _params_state(torch, versions[k], k),
                            metadata={"updates": k})
        _wait_until(lambda: engine.params_step == k, 5.0)
    thread.join(60.0)
    steps_seen = sorted({step for _sid, step, _b in recorder.seen})
    by_batch: dict = {}
    by_session: dict = {}
    backwards = 0
    for sid, step, batch in recorder.seen:
        by_batch.setdefault(batch, set()).add(step)
        if step < by_session.get(sid, -1):
            backwards += 1
        by_session[sid] = step
    mixed = sum(1 for s in by_batch.values() if len(s) > 1)
    # The first batch after the swaps: fresh sessions through the plain
    # attention under the new weights.
    fresh = make_sessions(prices, window, cfg.serve.max_batch,
                          seed=cfg.seed + 6, prefix="post")
    obs = np.stack([s.observation() for s in fresh])
    post = _serve_round(engine, [s.sid for s in fresh], obs)
    with torch.inference_mode():
        ref, _ = ctx["plain_model"].apply_prefill(
            policy.cast_compute(versions[2]), torch.from_numpy(obs).cuda())
    post_ok = all(r is not None and r.params_step == 2 for r in post)
    logit_err = value_err = float("inf")
    if post_ok:
        logit_err = float(np.abs(np.stack([r.logits for r in post])
                                 - ref.logits.cpu().numpy()).max())
        value_err = float(np.abs(np.array([r.value for r in post])
                                 - ref.value.cpu().numpy()).max())
    # The rest polls by hand (the thread stopped), so no poll can fall
    # between a save and the flipped byte. A corrupt third candidate:
    # refused, serving continues on step 2.
    watcher.stop()
    state = os.path.join(ckpt, "tag_best", "state.npz")
    manager.save_tagged("best", _params_state(torch, versions[3], 3),
                        metadata={"updates": 3})
    _flip_byte(state)
    refused = watcher.poll_once() is False and watcher.rejected == 1
    still = _serve_round(engine, ["still-up"], obs[:1])[0]
    rejected_once = registry.counters().get("serve_swap_rejected_total") == 1
    # swap_breaker_failures bad candidates: the breaker opens once.
    for k in range(failures):
        manager.save_tagged("best", _params_state(torch, versions[3], 4 + k),
                            metadata={"updates": 4 + k})
        _flip_byte(state)
        watcher.poll_once()
    stopped = engine.stop(timeout_s=30.0)
    counters = registry.counters()
    row = {"load": load, "steps_seen": steps_seen,
           "batches": len(by_batch), "mixed_batches": mixed,
           "steps_going_back": backwards, "swaps": counters.get(
               "serve_swaps_total", 0),
           "post_swap_logit_max_abs_err": logit_err,
           "post_swap_value_max_abs_err": value_err,
           "corrupt_refused": refused, "swap_rejected": counters.get(
               "serve_swap_rejected_total", 0),
           "breaker_opens": watcher.breaker_opens,
           "breaker_open_gauge": registry.latest("serve_swap_breaker_open"),
           "quarantined": sorted(n for n in os.listdir(ckpt)
                                 if n.startswith("corrupt_"))}
    problems = []
    if steps_seen != [0, 1, 2] or mixed or backwards:
        problems.append(f"(a) swaps under load: steps {steps_seen}, "
                        f"{mixed} mixed batches, {backwards} going back")
    if not post_ok or logit_err > LOGIT_ATOL or value_err > VALUE_ATOL:
        problems.append("(a) the post-swap batch disagrees with the plain "
                        "attention under the new weights")
    if not (refused and rejected_once and still is not None
            and still.params_step == 2):
        problems.append("(a) the corrupt candidate was not refused while "
                        "serving went on")
    if watcher.breaker_opens != 1 or not (load.get("completed", 0) > 0
                                          and stopped):
        problems.append(f"(a) breaker opened {watcher.breaker_opens} times, "
                        "or the load failed")
    return row, problems


def _tiers_reference_run(engine, sessions, rounds_rng, cycles):
    """Drive ``engine`` (slots for every session: never evicted) through
    ``cycles`` passes over ``sessions`` in 64-session batches; returns
    the batches asked (sids, observations) and the answers."""
    asked, answers = [], []
    batch = engine.cfg.max_batch
    for _ in range(cycles):
        order = rounds_rng.permutation(len(sessions))
        for lo in range(0, len(order), batch):
            group = [sessions[i] for i in order[lo:lo + batch]]
            sids = [s.sid for s in group]
            obs = np.stack([s.observation() for s in group])
            results = _serve_round(engine, sids, obs)
            if any(r is None for r in results):
                raise RuntimeError("chip_smoke: a reference request failed")
            for sess, r in zip(group, results):
                sess.advance(r.action)
            asked.append((sids, obs))
            answers.append(results)
    return asked, answers


def _replay(engine, asked, answers) -> tuple[int, int]:
    """The same batches through ``engine``: (answers bit-equal, asked)."""
    equal = total = 0
    for (sids, obs), want in zip(asked, answers):
        got = _serve_round(engine, sids, obs)
        equal += sum(_same(g, w) for g, w in zip(got, want))
        total += len(sids)
    return equal, total


def _tiers_warm(torch, ctx) -> tuple[dict, list]:
    """(b) The warm tier, bit-equal to an engine that never evicts, then
    closed loop with and without it."""
    import dataclasses

    from sharetrade_tpu_torch.serve import ServeEngine
    from sharetrade_tpu_torch.serve.driver import make_sessions, run_closed_loop
    from sharetrade_tpu_torch.utils.metrics import MetricsRegistry

    cfg, model, params, policy, prices = (ctx[k] for k in (
        "cfg", "model", "params", "policy", "prices"))
    window = cfg.env.window
    carry_bytes = ctx["carry_bytes"]
    never = ServeEngine(model, dataclasses.replace(
        cfg.serve, slots=TIERS_SESSIONS), params, precision=policy)
    never.warmup()
    asked, answers = _tiers_reference_run(
        never, make_sessions(prices, window, TIERS_SESSIONS,
                             seed=cfg.seed + 7, prefix="t"),
        np.random.default_rng(cfg.seed), TIERS_CYCLES)
    never.stop(timeout_s=30.0)
    registry = MetricsRegistry()
    tiered = ServeEngine(model, dataclasses.replace(
        cfg.serve, warm_bytes=TIERS_WARM_CARRIES * carry_bytes), params,
        precision=policy, registry=registry)
    tiered.warmup()
    torch.cuda.synchronize()
    start = _all_launch_counts()["flash_fwd"]
    before = dict(tiered.counters)
    equal, total = _replay(tiered, asked, answers)
    torch.cuda.synchronize()
    launches = _all_launch_counts()["flash_fwd"] - start
    cold_ticks = tiered.counters["cold_batches"] - before["cold_batches"]
    counters = registry.counters()
    paging = tiered.paging_ms()
    # Closed loop at 320 sessions, with the tier and without it.
    loops = {}
    for name, engine in (("warm_tier", tiered), ("no_tier", None)):
        if engine is None:
            engine = ServeEngine(model, cfg.serve, params, precision=policy)
            engine.warmup()
        start = dict(engine.counters)
        loop = run_closed_loop(
            engine, make_sessions(prices, window, TIERS_SESSIONS,
                                  seed=cfg.seed + 8, prefix=f"l{name}"),
            concurrency=TIERS_SESSIONS, duration_s=TIERS_LOOP_S)
        engine.drain(60.0)
        cold = engine.counters["cold_rows"] - start["cold_rows"]
        warm = engine.counters["warm_rows"] - start["warm_rows"]
        loops[name] = {"qps": loop["qps"], "p50_ms": loop["p50_ms"],
                       "p99_ms": loop["p99_ms"], "failed": loop["failed"],
                       "cold_share": cold / max(cold + warm, 1)}
        engine.stop(timeout_s=30.0)
    row = {"carry_bytes": carry_bytes,
           "warm_bytes": TIERS_WARM_CARRIES * carry_bytes,
           "bit_equal": equal, "answers": total,
           "parks": counters.get("serve_warm_parks_total", 0),
           "warm_hits": counters.get("serve_warm_hits_total", 0),
           "demotions": counters.get("serve_warm_demotions_total", 0),
           "cold_ticks": cold_ticks, "flash_fwd_launches": launches,
           "pageout_ms_per_tick": paging["pageout"],
           "install_ms_per_tick": paging["install"], "loops": loops}
    problems = []
    if equal != total:
        problems.append(f"(b) warm tier: {total - equal} of {total} answers "
                        "differ from the never-evicted engine")
    if not (row["parks"] > 0 and row["warm_hits"] > 0):
        problems.append("(b) the warm tier never parked or hit")
    if launches != cfg.model.num_layers * cold_ticks:
        problems.append(f"(b) flash_fwd launches {launches} != layers x "
                        f"cold ticks {cold_ticks}")
    if any(loop["failed"] for loop in loops.values()):
        problems.append("(b) a closed-loop request failed")
    ctx["closed_loop_qps"] = loops["warm_tier"]["qps"]
    return row, problems


def _tiers_spill(torch, ctx) -> tuple[dict, list]:
    """(c) The spill tier: adoptions bit-equal, a corrupt record cold, and
    a drained engine's sessions adopted by a second engine."""
    import dataclasses

    from sharetrade_tpu_torch.serve import ServeEngine
    from sharetrade_tpu_torch.serve.driver import make_sessions
    from sharetrade_tpu_torch.serve.spill import record_name
    from sharetrade_tpu_torch.utils.metrics import MetricsRegistry

    cfg, model, params, policy, prices = (ctx[k] for k in (
        "cfg", "model", "params", "policy", "prices"))
    window = cfg.env.window
    spill_dir = _fresh_dir("spill-")
    tier_cfg = dataclasses.replace(
        cfg.serve, warm_bytes=TIERS_SPILL_WARM_CARRIES * ctx["carry_bytes"],
        spill_dir=spill_dir, spill_bytes=256 * 2 ** 20)
    # The reference never evicts, with room for one fresh session more.
    never = ServeEngine(model, dataclasses.replace(
        cfg.serve, slots=TIERS_SESSIONS + cfg.serve.max_batch), params,
        precision=policy)
    never.warmup()
    sessions = make_sessions(prices, window, TIERS_SESSIONS,
                             seed=cfg.seed + 9, prefix="c")
    asked, answers = _tiers_reference_run(
        never, sessions, np.random.default_rng(cfg.seed + 1), TIERS_CYCLES)
    registry = MetricsRegistry()
    spill = ServeEngine(model, tier_cfg, params, precision=policy,
                        registry=registry)
    spill.warmup()
    t0 = time.perf_counter()
    equal, total = _replay(spill, asked, answers)
    replay_s = time.perf_counter() - t0
    spill.drain(60.0)
    clock = {}
    for sids, _obs in asked:
        for sid in sids:
            clock[sid] = clock.get(sid, 0) + 1
    # A corrupted record: its session restarts cold, a fresh session's
    # answer bit for bit.
    on_disk = [s for s in sessions
               if os.path.exists(os.path.join(spill_dir,
                                              record_name(s.sid)))]
    corrupt_ok = False
    if on_disk:
        victim = on_disk[0]
        _flip_byte(os.path.join(spill_dir, record_name(victim.sid)))
        obs = victim.observation()
        got = _serve_round(spill, [victim.sid], [obs])[0]
        fresh = _serve_round(never, ["fresh-corrupt"], [obs])[0]
        corrupt_ok = _same(got, fresh)
        sessions = [s for s in sessions if s is not victim]
    counters = registry.counters()
    # Drain, stop, page out; a second engine adopts every session warm.
    stopped = spill.stop(timeout_s=30.0)
    pageout = spill.page_out_all()
    reg2 = MetricsRegistry()
    adopter = ServeEngine(model, tier_cfg, params, precision=policy,
                          registry=reg2)
    adopter.warmup()
    adopt_equal = 0
    batch = cfg.serve.max_batch
    for lo in range(0, len(sessions), batch):
        group = sessions[lo:lo + batch]
        sids = [s.sid for s in group]
        obs = np.stack([s.observation() for s in group])
        handles = [adopter.submit(s, o, session_clock=clock[s])
                   for s, o in zip(sids, obs)]
        got = [h.wait(120.0) for h in handles]
        want = _serve_round(never, sids, obs)
        adopt_equal += sum(_same(g, w) for g, w in zip(got, want))
    adopted = reg2.counters()
    adopter.stop(timeout_s=30.0)
    never.stop(timeout_s=30.0)
    row = {"bit_equal": equal, "answers": total, "replay_s": replay_s,
           "spill_puts": counters.get("serve_spill_puts_total", 0),
           "spill_hits": counters.get("serve_spill_hits_total", 0),
           "spill_corrupt": counters.get("serve_spill_corrupt_total", 0),
           "corrupt_cold_bit_equal_fresh": corrupt_ok,
           "page_out_all": pageout, "stopped_clean": stopped,
           "adopted_bit_equal": adopt_equal, "adopted_sessions":
           len(sessions), "adopt_warm": adopted.get(
               "serve_adopt_warm_total", 0),
           "adopt_cold": adopted.get("serve_adopt_cold_total", 0)}
    problems = []
    if equal != total or row["spill_hits"] <= 0:
        problems.append(f"(c) spill tier: {total - equal} of {total} answers "
                        f"differ, {row['spill_hits']} spill hits")
    if not corrupt_ok or row["spill_corrupt"] != 1:
        problems.append("(c) the corrupted record did not land cold, bit "
                        "for bit a fresh session")
    if not stopped or pageout["refused"] or \
            adopt_equal != len(sessions) or \
            row["adopt_warm"] != len(sessions) or row["adopt_cold"]:
        problems.append(f"(c) adoption after page_out_all: {adopt_equal} of "
                        f"{len(sessions)} bit-equal, {row['adopt_warm']} "
                        "warm")
    return row, problems


def _tiers_overload(torch, ctx) -> tuple[dict, list]:
    """(d) Open loop at twice (b)'s closed-loop rate, shedding the oldest,
    with 50 ms deadlines: the counts reconcile."""
    import dataclasses

    from sharetrade_tpu_torch.serve import ServeEngine
    from sharetrade_tpu_torch.serve.driver import make_sessions, run_open_loop
    from sharetrade_tpu_torch.utils.metrics import MetricsRegistry

    cfg, model, params, policy, prices = (ctx[k] for k in (
        "cfg", "model", "params", "policy", "prices"))
    registry = MetricsRegistry()
    engine = ServeEngine(model, dataclasses.replace(
        cfg.serve, **OVERLOAD_KNOBS), params, precision=policy,
        registry=registry)
    engine.warmup()
    rate = 2.0 * ctx["closed_loop_qps"]
    stats = run_open_loop(
        engine, make_sessions(prices, cfg.env.window, 512, seed=cfg.seed + 10,
                              prefix="o"), rate_qps=rate,
        duration_s=TIERS_LOOP_S)
    engine.drain(60.0)
    stopped = engine.stop(timeout_s=30.0)
    counters = registry.counters()
    shed = int(counters.get("serve_shed_total", 0))
    expired = int(counters.get("serve_deadline_expired_total", 0))
    row = {**stats, "shed": shed, "deadline_expired": expired,
           "stopped_clean": stopped}
    problems = []
    if (stats["completed"] + stats["failed"]
            != stats["offered"] - stats["dropped"]
            or stats["failed"] != shed + expired or not stopped):
        problems.append(f"(d) overload counts do not reconcile: {row}")
    return row, problems


def _tiers_restarts(torch, ctx) -> tuple[dict, list]:
    """(e) A malformed observation rebuilds the engine once, then a storm
    of them ends in the terminal failed state."""
    import dataclasses

    from sharetrade_tpu_torch.serve import ServeEngine, ServeEngineFailed
    from sharetrade_tpu_torch.serve.driver import make_sessions
    from sharetrade_tpu_torch.utils.metrics import MetricsRegistry

    cfg, model, params, policy, prices = (ctx[k] for k in (
        "cfg", "model", "params", "policy", "prices"))
    registry = MetricsRegistry()
    engine = ServeEngine(model, dataclasses.replace(
        cfg.serve, max_restarts=2, restart_backoff_s=0.01,
        restart_backoff_max_s=0.05), params, precision=policy,
        registry=registry, restart_seed=0)
    engine.warmup()
    sess = make_sessions(prices, cfg.env.window, 1, seed=cfg.seed + 11,
                         prefix="r")[0]
    for _ in range(2):
        result = _serve_round(engine, [sess.sid], [sess.observation()])[0]
        sess.advance(result.action)
    bad = _serve_round(engine, ["bad"], [np.ones(3, np.float32)])[0]
    obs = sess.observation()
    healed = _serve_round(engine, [sess.sid], [obs])[0]
    fresh = _serve_round(engine, ["fresh-restart"], [obs])[0]
    heal_ok = bad is None and _same(healed, fresh)
    restarts_after_heal = registry.counters().get("serve_restarts_total", 0)
    for i in range(3):
        if engine.failed is not None:
            break
        _serve_round(engine, [f"storm{i}"], [np.ones(3, np.float32)])
    terminal = _wait_until(lambda: engine.failed is not None, 10.0)
    try:
        engine.submit("late", obs)
        refused = False
    except ServeEngineFailed:
        refused = True
    stopped = engine.stop(drain=False, timeout_s=30.0)
    row = {"healed_bit_equal_fresh": heal_ok,
           "restarts_after_heal": restarts_after_heal,
           "restarts": registry.counters().get("serve_restarts_total", 0),
           "terminal": terminal, "submit_refused": refused,
           "serve_failed_gauge": registry.latest("serve_failed"),
           "stopped_clean": stopped}
    problems = []
    if not (heal_ok and restarts_after_heal == 1):
        problems.append("(e) the engine did not heal once, bit for bit a "
                        "fresh session")
    if not (terminal and refused and stopped):
        problems.append("(e) the fault storm did not end in a clean "
                        "terminal failure")
    return row, problems


#: (d)'s and (f)'s overload knobs.
OVERLOAD_KNOBS = {"max_queue": 64, "shed_policy": "oldest",
                  "default_deadline_ms": 50.0}


def _tiers_baseline_and_cli(torch, ctx) -> tuple[dict, list]:
    """(f) The batch-1 baseline at concurrency 1, and ``cli serve --rate``
    with (d)'s knobs."""
    import tempfile

    from sharetrade_tpu_torch.serve.driver import (BatchOneServer,
                                                   make_sessions,
                                                   run_closed_loop)

    cfg, model, params, policy, prices = (ctx[k] for k in (
        "cfg", "model", "params", "policy", "prices"))
    server = BatchOneServer(model, params, precision=policy)
    server.warmup()
    base = run_closed_loop(
        server, make_sessions(prices, cfg.env.window, 64, seed=cfg.seed + 12,
                              prefix="b"), concurrency=1,
        duration_s=TIERS_LOOP_S)
    server.stop()
    rate = 2.0 * ctx["closed_loop_qps"]
    cmd = [sys.executable, "-m", "sharetrade_tpu_torch.cli", "serve",
           "--duration", str(TIERS_LOOP_S), "--sessions", "512", "--rate",
           str(round(rate))]
    with tempfile.TemporaryDirectory(prefix="cli-rate-") as ckpts:
        for item in FLAGSHIP + [f"serve.{k}={v}"
                                for k, v in OVERLOAD_KNOBS.items()] + [
                f"runtime.checkpoint_dir={ckpts}"]:
            cmd += ["--set", item]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300, cwd=_fresh_dir("cli-"),
                              env=_cli_env())
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    summary = json.loads(lines[-1]) if lines else {}
    cli_ok = (proc.returncode == 0 and summary.get("mode") == "open_loop"
              and summary.get("completed", 0) > 0
              and summary["completed"] + summary["failed"]
              == summary["offered"] - summary["dropped"]
              and summary["failed"] == summary["shed"]
              + summary["deadline_expired"])
    row = {"batch1": {k: base[k] for k in ("qps", "p50_ms", "p99_ms",
                                           "completed", "failed")},
           "cli_rate": {"rc": proc.returncode, "rate_qps": rate,
                        "seconds": time.perf_counter() - t0,
                        "summary": summary, "ok": bool(cli_ok)}}
    problems = []
    if base["failed"] or base["completed"] <= 0:
        problems.append("(f) the batch-1 baseline failed requests")
    if not cli_ok:
        row["cli_rate"]["stderr_tail"] = proc.stderr[-2000:]
        problems.append("(f) cli serve --rate failed or did not reconcile")
    return row, problems


def phase_serve_tiers(torch) -> dict:
    """The rest of the serving engine on the flagship; see the module
    docstring."""
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.env.trading import obs_dim
    from sharetrade_tpu_torch.models import build_model
    from sharetrade_tpu_torch.models.core import tree_leaves
    from sharetrade_tpu_torch.ops import attention
    from sharetrade_tpu_torch.precision import policy_from_config

    cfg = FrameworkConfig().apply_overrides(FLAGSHIP)
    window = cfg.env.window
    model = build_model(cfg.model, obs_dim(window), device="cuda")
    policy = policy_from_config(cfg.precision)
    sm_scale = cfg.model.head_dim ** -0.5
    ctx = {
        "cfg": cfg, "model": model, "policy": policy,
        "prices": _prices(cfg.data),
        "params": model.init(torch.Generator().manual_seed(cfg.seed)),
        "carry_bytes": sum(x.numel() * x.element_size() for x in tree_leaves(
            policy.cast_carry(model.init_carry(), model))),
        "plain_model": build_model(
            cfg.model, obs_dim(window), device="cuda",
            attention_fn=lambda q, k, v, w: attention.reference_attention(
                q, k, v, causal=True, sm_scale=sm_scale, local_window=w)),
    }
    row: dict = {"phase": "serve_tiers", "config": FLAGSHIP}
    problems: list[str] = []
    t_phase = time.perf_counter()
    # The counted window: counts reset just before, read just after.
    _reset_launch_counts()
    for name, part in (("swaps", _tiers_swaps), ("warm", _tiers_warm),
                       ("spill", _tiers_spill),
                       ("overload", _tiers_overload),
                       ("restarts", _tiers_restarts),
                       ("baseline_cli", _tiers_baseline_and_cli)):
        t0 = time.perf_counter()
        try:
            row[name], found = part(torch, ctx)
        except Exception as exc:   # noqa: BLE001 — reported as a problem
            row[name], found = {"error": repr(exc)}, [f"({name}) raised "
                                                      f"{exc!r}"]
        row[name]["seconds"] = time.perf_counter() - t0
        problems += found
    torch.cuda.synchronize()
    row["launches"] = _all_launch_counts()
    row["seconds"] = time.perf_counter() - t_phase
    if row["launches"]["flash_fwd"] <= 0:
        problems.append("flash_fwd never launched in serve_tiers")
    row["problems"] = problems
    return row


#: The telemetry and control phase (``serve_slo``): the flagship served as
#: in ``serve``, its stats published every 0.5 s (0.25 s under the
#: controller), 192 sessions in closed loop for (a) and (b), and 320 sessions
#: (more than ``max_queue`` 256 holds) in open loop for (c) and (d).
SLO_SESSIONS = 192
SLO_LOOP_S = 2.0
SLO_OVERLOAD_SESSIONS = 320
SLO_OVERLOAD = {"max_queue": 256, "shed_policy": "oldest",
                "default_deadline_ms": 50.0, "stats_interval_s": 0.25}
SLO_CONTROLLER_INTERVAL_S = 0.25
#: (c)'s target is half of (a)'s p99, kept within these bounds (ms). (a)'s
#: p99 (111-267 ms in this phase's runs) is set by one window that holds a
#: gen-2 garbage collection of the host (76-240 ms pauses), while the
#: overload's completed latencies sit near the 50 ms deadline plus a tick
#: (window p99s 62-99 ms) and the relaxed phase's windows run 14-40 ms: a
#: target in these bounds is one the overload exceeds and, at half of it
#: (the controller's re-arm line), one the relaxed phase gets under
#: (PERF.md section 6).
SLO_TARGET_BOUNDS_MS = (40.0, 50.0)
#: The relaxed phase's rate: a tenth of the overload's, halved (up to three
#: times) until a probe's windows' median p99 sits under this share of the
#: controller's re-arm line (half the target). The load at a tenth ran at
#: a window p99 of ~30 ms on some hosts, over a 20-25 ms re-arm line, and
#: the controller then rightly never relaxed (ROADMAP C13).
SLO_LIGHT_FRAC = 0.8
SLO_LIGHT_PROBES = 4
SLO_BURN = {"slo_availability": 0.999, "slo_window_s": 1.0,
            "slo_burn_threshold": 2.0, "exemplar_k": 4}


class _Answers:
    """The engine's ``submit`` with every completed request's session,
    observation and result recorded (the plain path replays them)."""

    def __init__(self, engine):
        import threading
        self.engine = engine
        self.lock = threading.Lock()
        self.done: list[tuple] = []

    def submit(self, sid, obs, callback=None, **kw):
        def cb(result):
            if result is not None:
                with self.lock:
                    self.done.append((sid, obs, result))
            if callback is not None:
                callback(result)
        return self.engine.submit(sid, obs, cb, **kw)


def _against_plain(ctx, done: list) -> dict:
    """Every recorded answer against the same sessions through an engine
    on the plain attention, fed tick by tick in the engine's order (every
    session has a slot in both, so each one's carry threads the same way):
    the largest logit and value errors."""
    from sharetrade_tpu_torch.serve import ServeEngine

    cfg = ctx["cfg"]
    plain = ServeEngine(ctx["plain_model"], cfg.serve, ctx["params"],
                        precision=ctx["policy"])
    plain.warmup()
    ticks: dict = {}
    for sid, obs, result in done:
        ticks.setdefault(result.batch, []).append((sid, obs, result))
    logit_err = value_err = 0.0
    try:
        for serial in sorted(ticks):
            group = ticks[serial]
            got = _serve_round(plain, [g[0] for g in group],
                               [g[1] for g in group])
            if any(r is None for r in got):
                raise RuntimeError("chip_smoke: a plain-path request failed")
            logit_err = max(logit_err, float(np.abs(
                np.stack([g[2].logits for g in group])
                - np.stack([r.logits for r in got])).max()))
            value_err = max(value_err, float(np.abs(
                np.array([g[2].value for g in group])
                - np.array([r.value for r in got])).max()))
    finally:
        plain.stop(timeout_s=30.0)
    return {"answers": len(done), "ticks": len(ticks),
            "logit_max_abs_err": logit_err, "value_max_abs_err": value_err}


def _window_rows(registry, since: float) -> list[dict]:
    """The stats publishes after ``since`` (wall clock), one dict a
    publish: every gauge written by that publish."""
    names = ("serve_qps", "serve_p50_ms", "serve_p99_ms", "serve_overload",
             "serve_queue_depth", "serve_batch_occupancy",
             "serve_sessions_hot", "serve_slo_availability_burn",
             "serve_slo_latency_burn", "serve_knob_batch_timeout_ms",
             "serve_knob_max_queue")
    rows: dict = {}
    for name in names:
        for ts, value in registry.series(name):
            if ts > since:
                rows.setdefault(ts, {"t": ts})[name] = value
    return [rows[t] for t in sorted(rows)]


def _slo_telemetry(torch, ctx) -> tuple[dict, list]:
    """(a) Telemetry under closed-loop load and (b) live knobs under it."""
    import dataclasses
    import threading

    from sharetrade_tpu_torch.serve import ServeEngine, latency_percentiles
    from sharetrade_tpu_torch.serve.driver import make_sessions, run_closed_loop
    from sharetrade_tpu_torch.utils.metrics import MetricsRegistry

    cfg, model, params, policy, prices = (ctx[k] for k in (
        "cfg", "model", "params", "policy", "prices"))
    window = cfg.env.window
    registry = MetricsRegistry()
    engine = ServeEngine(model, dataclasses.replace(
        cfg.serve, stats_interval_s=0.5), params, precision=policy,
        registry=registry)
    engine.warmup()
    answers = _Answers(engine)
    problems = []
    # (a) telemetry under closed-loop load.
    torch.cuda.synchronize()
    launches0 = _all_launch_counts()["flash_fwd"]
    before = dict(engine.counters)
    since = time.time()
    with _GcPauses() as gc_pauses:
        load = run_closed_loop(answers, make_sessions(
            prices, window, SLO_SESSIONS, seed=cfg.seed + 20, prefix="slo"),
            concurrency=SLO_SESSIONS, duration_s=SLO_LOOP_S)
    drained = engine.drain(60.0)
    torch.cuda.synchronize()
    launches = _all_launch_counts()["flash_fwd"] - launches0
    cold_ticks = engine.counters["cold_batches"] - before["cold_batches"]
    done_a = list(answers.done)
    lat = [r.latency_ms for _s, _o, r in done_a]
    telescoped = sum(
        1 for _s, _o, r in done_a
        if abs(r.stages["queue_wait_ms"] + r.stages["batch_wait_ms"]
               + r.stages["device_ms"] - r.latency_ms) <= 1e-6)
    hist = engine.latency_histogram
    exact = latency_percentiles(lat)
    est = {"p50_ms": hist.quantile(0.50), "p99_ms": hist.quantile(0.99)}
    within = {}
    for key in ("p50_ms", "p99_ms"):
        i = next((k for k, b in enumerate(hist.bounds) if exact[key] <= b),
                 len(hist.bounds) - 1)
        lo = hist.bounds[i - 1] if i else 0.0
        within[key] = lo <= est[key] <= hist.bounds[i]
    windows = _window_rows(registry, since)
    busy = [w for w in windows if w.get("serve_qps", 0) > 0]
    counters = registry.counters()
    a = {"load": load, "answers": len(done_a), "telescoped": telescoped,
         "decomposition_errors": counters.get(
             "serve_trace_decomposition_error_total", 0),
         "histogram_count": hist.count,
         "responses": counters.get("serve_responses_total", 0),
         "nearest_rank": exact, "histogram": est, "within_a_bucket": within,
         "windows": len(windows), "windows_with_completions": len(busy),
         "windows_with_p99": sum(1 for w in busy if "serve_p99_ms" in w),
         "window_p99_ms": [w.get("serve_p99_ms") for w in busy],
         "stage_p99_ms": _stage_p99s(registry),
         "gc_gen2_pauses_ms": gc_pauses.pauses,
         "slowest": engine.exemplars()[:2], "cold_ticks": cold_ticks,
         "flash_fwd_launches": launches, "drained": drained}
    if telescoped != len(done_a) or a["decomposition_errors"]:
        problems.append(f"(a) {len(done_a) - telescoped} stage splits do "
                        "not sum to their latency")
    if not (hist.count == len(done_a) == a["responses"] > 0):
        problems.append(f"(a) histogram count {hist.count}, answers "
                        f"{len(done_a)}, responses {a['responses']}")
    if not all(within.values()):
        problems.append(f"(a) histogram p50/p99 {est} not within a bucket of "
                        f"the nearest-rank {exact}")
    if not busy or a["windows_with_p99"] != len(busy):
        problems.append(f"(a) {len(busy)} windows with completions, "
                        f"{a['windows_with_p99']} published serve_p99_ms")
    if launches <= 0 or launches != cfg.model.num_layers * cold_ticks:
        problems.append(f"(a) flash_fwd launches {launches} != layers x "
                        f"cold ticks {cold_ticks}")
    if load["failed"] or not drained:
        problems.append("(a) requests failed or the engine did not drain")
    ctx["slo_qps"], ctx["slo_p99_ms"] = load["qps"], exact["p99_ms"]
    # (b) live knobs under load: above config clamps to config; then, in
    # the middle of a closed loop, a tighter vector.
    clamped = engine.set_knobs(batch_timeout_ms=1e3, max_queue=10 ** 6)
    clamp_ok = (tuple(clamped) == (cfg.serve.batch_timeout_ms,
                                   cfg.serve.max_queue)
                and engine._q.maxsize == cfg.serve.max_queue)
    n_a = len(answers.done)
    load_b: dict = {}
    thread = threading.Thread(target=lambda: load_b.update(run_closed_loop(
        answers, make_sessions(prices, window, SLO_SESSIONS,
                               seed=cfg.seed + 21, prefix="knob"),
        concurrency=SLO_SESSIONS, duration_s=SLO_LOOP_S)))
    thread.start()
    time.sleep(SLO_LOOP_S / 2)
    tight = engine.set_knobs(batch_timeout_ms=0.5, max_queue=64)
    retarget = {"knobs": list(tight), "queue_maxsize": engine._q.maxsize,
                "gauges": [registry.latest("serve_knob_batch_timeout_ms"),
                           registry.latest("serve_knob_max_queue")]}
    thread.join(120.0)
    engine.drain(60.0)
    stopped = engine.stop(timeout_s=30.0)
    b = {"clamped": list(clamped), "clamp_ok": clamp_ok, "load": load_b,
         "answers": len(answers.done) - n_a, **retarget,
         "stopped_clean": stopped}
    if not clamp_ok:
        problems.append(f"(b) set_knobs above config gave {list(clamped)}")
    if not (retarget["knobs"] == [0.5, 64] and retarget["queue_maxsize"] == 64
            and retarget["gauges"] == [0.5, 64.0]):
        problems.append(f"(b) the knob change did not retarget: {retarget}")
    if not (load_b.get("completed", 0) > 0 and stopped):
        problems.append("(b) no answers under the new knobs, or stop unclean")
    # Every answer of (a) and (b) against the plain path.
    plain = _against_plain(ctx, answers.done)
    a["plain"] = plain
    if (plain["logit_max_abs_err"] > LOGIT_ATOL
            or plain["value_max_abs_err"] > VALUE_ATOL):
        problems.append(f"(a)/(b) answers disagree with the plain path: "
                        f"{plain}")
    return {"telemetry": a, "knobs": b}, problems


class _GcPauses:
    """The host's gen-2 garbage-collection pauses (ms) while active, via
    ``gc.callbacks``: what the exemplars of a tail window point at."""

    def __enter__(self):
        import gc
        self.pauses: list[float] = []
        self._t0 = 0.0
        gc.callbacks.append(self._callback)
        return self

    def _callback(self, phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.pauses.append((time.perf_counter() - self._t0) * 1e3)

    def __exit__(self, *exc):
        import gc
        gc.callbacks.remove(self._callback)
        return False


def _stage_p99s(registry) -> dict:
    from sharetrade_tpu_torch.obs import serve_stage_p99s
    return serve_stage_p99s(registry)


def _light_rate(engine, registry, sessions, rate: float,
                under_ms: float) -> dict:
    """The relaxed phase's load: ``rate`` (a tenth of the overload's) or
    its halving, down to ``SLO_LIGHT_PROBES`` probes, whichever first
    serves with its windows' median p99 under ``under_ms``. Each probe is
    an open loop of ``SLO_LOOP_S`` / 2 s on the engine, the controller not
    yet running and the knobs at config."""
    from sharetrade_tpu_torch.serve.driver import run_open_loop
    probes = []
    for _ in range(SLO_LIGHT_PROBES):
        since = time.time()
        run_open_loop(engine, sessions, rate_qps=rate,
                      duration_s=SLO_LOOP_S / 2)
        engine.drain(60.0)
        p99s = [w["serve_p99_ms"] for w in _window_rows(registry, since)
                if "serve_p99_ms" in w]
        probes.append({"rate_qps": rate, "window_p99_ms": p99s})
        if p99s and statistics.median(p99s) < under_ms:
            break
        rate /= 2.0
    return {"rate_qps": probes[-1]["rate_qps"], "probes": probes}


def _slo_controller(torch, ctx) -> tuple[dict, list]:
    """(c) The controller under overload, then at a light rate, and
    (d) the SLO burn gauges and the exemplar ring of the same engine."""
    import dataclasses
    import threading

    from sharetrade_tpu_torch.config import ObsConfig
    from sharetrade_tpu_torch.serve import ServeController, ServeEngine
    from sharetrade_tpu_torch.serve.driver import make_sessions, run_open_loop
    from sharetrade_tpu_torch.utils.metrics import MetricsRegistry

    cfg, model, params, policy, prices = (ctx[k] for k in (
        "cfg", "model", "params", "policy", "prices"))
    serve_cfg = dataclasses.replace(cfg.serve, **SLO_OVERLOAD)
    lo, hi = SLO_TARGET_BOUNDS_MS
    target = min(max(ctx["slo_p99_ms"] / 2.0, lo), hi)
    obs_cfg = ObsConfig(slo_target_p99_ms=target, **SLO_BURN)
    registry = MetricsRegistry()
    engine = ServeEngine(model, serve_cfg, params, precision=policy,
                         registry=registry, obs_cfg=obs_cfg)
    engine.warmup()
    ceiling = (serve_cfg.batch_timeout_ms, serve_cfg.max_queue)
    reads: list[tuple] = []
    phases: dict = {}
    sessions = make_sessions(prices, cfg.env.window, SLO_OVERLOAD_SESSIONS,
                             seed=cfg.seed + 22, prefix="ol")
    light = _light_rate(engine, registry, sessions, 0.2 * ctx["slo_qps"],
                        SLO_LIGHT_FRAC * 0.5 * target)
    controller = ServeController(
        engine, target_p99_ms=target,
        interval_s=SLO_CONTROLLER_INTERVAL_S).start()
    starts = {}
    for name, rate in (("overload", 2.0 * ctx["slo_qps"]),
                       ("relaxed", light["rate_qps"])):
        since = starts[name] = time.time()
        adjust0 = controller.adjustments
        counters0 = registry.counters()
        out: dict = {}
        thread = threading.Thread(target=lambda r=rate: out.update(
            run_open_loop(engine, sessions, rate_qps=r,
                          duration_s=2 * SLO_LOOP_S)))
        thread.start()
        while thread.is_alive():
            reads.append(tuple(engine.knobs))
            thread.join(0.02)
        engine.drain(60.0)
        counters = registry.counters()

        def grew(key, _c=counters, _c0=counters0):
            return int(_c.get(key, 0) - _c0.get(key, 0))

        phases[name] = {
            "rate_qps": rate, **out, "shed": grew("serve_shed_total"),
            "deadline_expired": grew("serve_deadline_expired_total"),
            "adjustments": controller.adjustments - adjust0,
            "knobs_after": list(engine.knobs),
            "windows": _window_rows(registry, since)}
    controller.stop()
    exemplars = engine.exemplars()
    window_slowest = len(engine._window_slowest)
    stopped = engine.stop(timeout_s=30.0)
    counters = registry.counters()
    over, relaxed = phases["overload"], phases["relaxed"]
    # The knob gauges' trajectory (set_knobs writes both at once), and the
    # grow steps of the relaxed phase.
    trajectory = [(ts, t, q) for (ts, t), (_ts, q) in zip(
        registry.series("serve_knob_batch_timeout_ms"),
        registry.series("serve_knob_max_queue"))]
    grow_steps = sum(
        1 for prev, cur in zip(trajectory, trajectory[1:])
        if cur[0] > starts["relaxed"] and (cur[1] > prev[1]
                                           or cur[2] > prev[2]))
    c = {"target_p99_ms": target, "half_of_a_p99_ms": ctx["slo_p99_ms"] / 2,
         "light_rate_probes": light["probes"],
         "ceiling": list(ceiling),
         "knob_reads": len(reads),
         "max_read": [max(r[0] for r in reads), max(r[1] for r in reads)],
         "min_read": [min(r[0] for r in reads), min(r[1] for r in reads)],
         "adjustments": controller.adjustments,
         "adjustments_counter": counters.get(
             "serve_controller_adjustments_total", 0),
         "knob_trajectory": [[t, q] for _ts, t, q in trajectory],
         "relaxed_grow_steps": grow_steps,
         **{k: {kk: vv for kk, vv in v.items() if kk != "windows"}
            for k, v in phases.items()}, "stopped_clean": stopped}
    problems = []
    if over["adjustments"] < 1 or over["knobs_after"][1] >= ceiling[1]:
        problems.append(f"(c) no tightening under overload: {c['overload']}")
    if any(r[0] > ceiling[0] or r[1] > ceiling[1] for r in reads):
        problems.append(f"(c) a knob read above config: {c['max_read']}")
    if c["adjustments"] != c["adjustments_counter"]:
        problems.append("(c) adjustments and their counter disagree")
    for name in ("overload", "relaxed"):
        p = phases[name]
        if (p["completed"] + p["failed"] != p["offered"] - p["dropped"]
                or p["failed"] != p["shed"] + p["deadline_expired"]):
            problems.append(f"(c) {name}: the outcomes do not reconcile: "
                            f"{c[name]}")
    if any(t > ceiling[0] or q > ceiling[1] for _ts, t, q in trajectory):
        problems.append(f"(c) a knob gauge above config: {trajectory}")
    if grow_steps < 1:
        problems.append(f"(c) the controller did not relax at the light "
                        f"rate: {c['relaxed']}")
    # (d) the burn gauges and the exemplars.
    threshold = SLO_BURN["slo_burn_threshold"]
    burns = [w["serve_slo_availability_burn"] for w in over["windows"]
             if "serve_slo_availability_burn" in w]
    clean = [w["serve_slo_availability_burn"] for w in relaxed["windows"]
             if "serve_slo_availability_burn" in w]
    # Windows whose p99 is over the target. Where it lies in a bucket
    # wholly above the target, one of the window's completions at least
    # was slower than the target, so the latency burn must be positive;
    # an estimate inside the target's own bucket may sit above it with
    # none slower.
    bounds = engine.latency_histogram.bounds
    slow = [w for w in over["windows"] + relaxed["windows"]
            if w.get("serve_p99_ms", 0.0) > target]
    surely_slow = [w for w in slow
                   if max((b for b in bounds if b < w["serve_p99_ms"]),
                          default=0.0) >= target]
    k = SLO_BURN["exemplar_k"]
    split_ok = all(abs(sum(e["stages"].values()) - e["latency_ms"]) <= 2e-3
                   for e in exemplars)
    d = {"availability_burn_max_overload": max(burns, default=None),
         "availability_burn_relaxed": clean,
         "p99_and_latency_burn_when_slow": [
             [w["serve_p99_ms"], w.get("serve_slo_latency_burn")]
             for w in slow],
         "burn_alerts": counters.get("serve_slo_burn_alerts_total", 0),
         "exemplars": len(exemplars), "window_slowest": window_slowest,
         "exemplar_split_ok": split_ok, "slowest": exemplars[:3]}
    if not burns or max(burns) <= threshold:
        problems.append(f"(d) availability burn {max(burns, default=None)} "
                        f"never passed {threshold} under overload")
    if 0.0 not in clean:
        problems.append(f"(d) no clean window burned 0: {clean}")
    if (not any(w.get("serve_slo_latency_burn", 0) > 0 for w in slow)
            or any(not w.get("serve_slo_latency_burn", 0) > 0
                   for w in surely_slow)):
        problems.append("(d) the latency burn was not positive while the "
                        "p99 sat over its target")
    if not (0 < len(exemplars) <= 5 * k and window_slowest <= k
            and split_ok):
        problems.append(f"(d) exemplars: {len(exemplars)} (K {k}), window "
                        f"{window_slowest}, splits ok {split_ok}")
    return {"controller": c, "burn": d}, problems


def _slo_cli(torch, ctx) -> tuple[dict, list]:
    """(e) The tuned profile: ``tools/torch_autotune.py --quick --spec
    serve`` on the card, ``cli serve`` at the defaults under it with the
    controller, a foreign copy refused, and ``cli train`` at the defaults
    under a profile setting ``runtime.megachunk_factor``."""
    import tempfile

    from sharetrade_tpu_torch import tuning
    from sharetrade_tpu_torch.config import FrameworkConfig

    work = _fresh_dir("slo-cli-")
    profile = os.path.join(work, "tuned_profile.json")
    t0 = time.perf_counter()
    sweep = subprocess.run(
        [sys.executable, os.path.join(_ROOT, "tools", "torch_autotune.py"),
         "--quick", "--spec", "serve", "--json", "--out", profile],
        capture_output=True, text=True, timeout=300, cwd=work,
        env=_cli_env())
    row: dict = {"autotune_rc": sweep.returncode,
                 "autotune_seconds": time.perf_counter() - t0}
    problems = []
    if sweep.returncode != 0:
        row["stderr_tail"] = sweep.stderr[-2000:]
        return row, ["(e) tools/torch_autotune.py failed"]
    summary = json.loads(sweep.stdout.strip().splitlines()[-1])
    knobs = tuning.load_profile(profile)["knobs"]
    row.update(profile_knobs=knobs, fingerprint=summary["fingerprint"],
               objective=summary["objectives"]["serve"])
    desc = tuning.describe(tuning.apply_profile(
        FrameworkConfig().apply_overrides([f"tuning.profile={profile}"])))
    defaults = tuning.default_knob_values()
    sources = {k: desc["knobs"][k]["source"] for k in knobs}
    row["describe_sources"] = sources
    if any(sources[k] != ("profile" if v != defaults[k] else "default")
           for k, v in knobs.items()) or "profile" not in sources.values():
        problems.append(f"(e) describe's sources: {sources}")
    with tempfile.TemporaryDirectory(prefix="slo-ckpt-") as ckpts:
        where = ["--set", f"runtime.checkpoint_dir={ckpts}"]
        t0 = time.perf_counter()
        serve = subprocess.run(
            [sys.executable, "-m", "sharetrade_tpu_torch.cli", "serve",
             "--duration", "3", "--set", f"tuning.profile={profile}",
             "--set", "tuning.serve_controller=true"] + where,
            capture_output=True, text=True, timeout=300,
            cwd=_fresh_dir("cli-"), env=_cli_env())
        row["serve_seconds"] = time.perf_counter() - t0
        foreign = os.path.join(work, "foreign.json")
        doc = json.load(open(profile))
        doc["fingerprint"]["backend"] = "tpu"
        tuning.write_profile(foreign, doc)
        refused = subprocess.run(
            [sys.executable, "-m", "sharetrade_tpu_torch.cli", "serve",
             "--duration", "1", "--set", f"tuning.profile={foreign}"] + where,
            capture_output=True, text=True, timeout=300,
            cwd=_fresh_dir("cli-"), env=_cli_env())
        train_profile = os.path.join(work, "train_profile.json")
        tuning.write_profile(train_profile, tuning.build_profile(
            {"runtime.megachunk_factor": 4}, notes="chip_smoke serve_slo"))
        t0 = time.perf_counter()
        train = subprocess.run(
            [sys.executable, "-m", "sharetrade_tpu_torch.cli", "train",
             "--set", f"tuning.profile={train_profile}"] + where,
            capture_output=True, text=True, timeout=600,
            cwd=_fresh_dir("cli-"), env=_cli_env())
        row["train_seconds"] = time.perf_counter() - t0
    served = [json.loads(ln) for ln in serve.stdout.splitlines()
              if ln.startswith("{")]
    trained = [json.loads(ln) for ln in train.stdout.splitlines()
               if ln.startswith("{")]
    tsum = trained[-1] if trained else {}
    row.update(
        serve_rc=serve.returncode,
        serving_ready=served[0] if served else None,
        serve_summary=({k: served[-1].get(k) for k in (
            "qps", "p99_ms", "completed", "failed", "controller_adjustments",
            "stage_p99_ms", "slowest")} if served else None),
        foreign_rc=refused.returncode,
        foreign_stderr=refused.stderr.strip().splitlines()[-1:],
        train_rc=train.returncode,
        train_summary={k: tsum.get(k) for k in (
            "avg_portfolio", "std_portfolio", "env_steps",
            "agent_steps_per_sec", "kernel_launches")},
        train_knob_applied="applied: runtime.megachunk_factor=4"
        in train.stderr,
        train_reference_digits=(tsum.get("avg_portfolio"),
                                tsum.get("std_portfolio"))
        == REFERENCE_DIGITS)
    last = served[-1] if served else {}
    if not (serve.returncode == 0 and len(served) >= 2
            and {"controller_adjustments", "stage_p99_ms", "slowest"}
            <= set(last) and last.get("completed", 0) > 0
            and served[0].get("max_batch") == knobs["serve.max_batch"]):
        row["serve_stderr_tail"] = serve.stderr[-2000:]
        problems.append("(e) cli serve under the profile and the "
                        "controller failed or lacks the summary keys")
    if not (refused.returncode == 2 and "ProfileError" in refused.stderr
            and "different host" in refused.stderr):
        problems.append(f"(e) the foreign profile was not refused: rc "
                        f"{refused.returncode} {row['foreign_stderr']}")
    if not (train.returncode == 0 and row["train_knob_applied"]
            and np.isfinite(tsum.get("avg_portfolio", float("nan")))
            and tsum.get("kernel_launches", {}).get("fused_update", 0) > 0):
        row["train_stderr_tail"] = train.stderr[-2000:]
        problems.append("(e) cli train under the profile failed or did not "
                        "apply runtime.megachunk_factor")
    return row, problems


def phase_serve_slo(torch) -> dict:
    """Serving's telemetry and control loop on the flagship; see the
    module docstring. Nothing is caught: a part that raises fails the
    run."""
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.env.trading import obs_dim
    from sharetrade_tpu_torch.models import build_model
    from sharetrade_tpu_torch.ops import attention
    from sharetrade_tpu_torch.precision import policy_from_config

    cfg = FrameworkConfig().apply_overrides(FLAGSHIP)
    window = cfg.env.window
    model = build_model(cfg.model, obs_dim(window), device="cuda")
    sm_scale = cfg.model.head_dim ** -0.5
    ctx = {
        "cfg": cfg, "model": model,
        "policy": policy_from_config(cfg.precision),
        "prices": _prices(cfg.data),
        "params": model.init(torch.Generator().manual_seed(cfg.seed)),
        "plain_model": build_model(
            cfg.model, obs_dim(window), device="cuda",
            attention_fn=lambda q, k, v, w: attention.reference_attention(
                q, k, v, causal=True, sm_scale=sm_scale, local_window=w)),
    }
    row: dict = {"phase": "serve_slo", "config": FLAGSHIP}
    problems: list[str] = []
    t_phase = time.perf_counter()
    # The counted window: counts reset just before, read just after.
    _reset_launch_counts()
    for name, part in (("telemetry_knobs", _slo_telemetry),
                       ("controller_burn", _slo_controller),
                       ("cli", _slo_cli)):
        t0 = time.perf_counter()
        part_row, found = part(torch, ctx)
        part_row["seconds"] = time.perf_counter() - t0
        row[name] = part_row
        _print({"phase": "serve_slo", "part": name, **part_row,
                "problems": found})
        problems += found
    torch.cuda.synchronize()
    row["launches"] = _all_launch_counts()
    row["seconds"] = time.perf_counter() - t_phase
    if row["launches"]["flash_fwd"] <= 0:
        problems.append("flash_fwd never launched in serve_slo")
    row["problems"] = problems
    return row


def phase_profile(torch, *, ticks: int = 20) -> dict:
    """Where a serving tick's device time goes, at the flagship width: the
    cold program (prefill of a full 64-row batch) and the warm program
    (one incremental step of 64 rows), each timed with CUDA events and
    broken down by kernel with ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.env.trading import obs_dim
    from sharetrade_tpu_torch.models import build_model
    from sharetrade_tpu_torch.precision import policy_from_config
    from sharetrade_tpu_torch.serve.driver import make_sessions

    cfg = FrameworkConfig().apply_overrides(FLAGSHIP)
    window, batch = cfg.env.window, cfg.serve.max_batch
    prices = _prices(cfg.data)
    model = build_model(cfg.model, obs_dim(window), device="cuda")
    policy = policy_from_config(cfg.precision)
    params = policy.cast_compute(
        model.init(torch.Generator().manual_seed(cfg.seed)))
    sessions = make_sessions(prices, window, batch, seed=cfg.seed)
    obs = torch.from_numpy(
        np.stack([s.observation() for s in sessions])).cuda()
    row = {"phase": "profile", "batch": batch}
    with torch.inference_mode():
        _, carry = model.apply_prefill(params, obs)
        programs = {
            "cold": lambda: model.apply_prefill(params, obs),
            "warm": lambda: model.apply_serve_batch(
                params, obs, {k: v.clone() for k, v in carry.items()}),
        }
        for name, fn in programs.items():
            row[f"{name}_tick_ms"] = _time_ms(torch, fn, iters=ticks,
                                              host_ahead=False)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(ticks):
                    fn()
                torch.cuda.synchronize()
            stats = []
            for ev in prof.key_averages():
                # Device-side events only: the kernels themselves (the
                # host-side aten events would count their time again).
                if not str(ev.device_type).endswith("CUDA"):
                    continue
                dev_us = getattr(ev, "self_device_time_total", None)
                if dev_us is None:
                    dev_us = getattr(ev, "self_cuda_time_total", 0.0)
                if dev_us > 0:
                    stats.append((dev_us, ev.key, ev.count))
            stats.sort(reverse=True)
            total = sum(us for us, _, _ in stats)
            row[f"{name}_device_ms_per_tick"] = total / ticks / 1e3
            row[f"{name}_top"] = [
                {"kernel": key[:90], "ms_per_tick": us / ticks / 1e3,
                 "share": us / total if total else 0.0,
                 "calls_per_tick": count / ticks}
                for us, key, count in stats[:10]]
    return row


# ---------------------------------------------------------------------------
# The fleet: cli fleet, the wire, the router, the engine pool.

#: The fleet phase's config: the served flagship (``FLAGSHIP``) on two
#: ``cli serve --listen`` workers sharing the card by time-slicing.
FLEET = FLAGSHIP + ["fleet.num_engines=2"]
#: (c)'s pool: the warm tier (a few carries) and a shared spill arena, so a
#: retired engine pages its sessions out for the survivor to adopt.
FLEET_TIERS = ["serve.warm_bytes=16777216", "serve.spill_bytes=4294967296"]
FLEET_SESSIONS = 192
FLEET_LOOP_S = 3.0
#: (a)'s wire client, run in a process of its own (no CUDA device visible)
#: so its threads share no interpreter with the smoke's earlier phases:
#: ``python -c FLEET_CLIENT HOST PORT PRICES.npy WINDOW SESSIONS SECONDS``
#: prints the closed loop's summary as one JSON line.
FLEET_CLIENT = """\
import json, sys
import numpy as np
from sharetrade_tpu_torch.fleet import WireEngine
from sharetrade_tpu_torch.serve.driver import make_sessions, run_closed_loop
host, port, prices, window, n, seconds = sys.argv[1:]
wire = WireEngine(host, int(port), workers=int(n), timeout_s=120.0)
try:
    row = run_closed_loop(wire, make_sessions(
        np.load(prices), int(window), int(n), seed=1, prefix="fa"),
        concurrency=int(n), duration_s=float(seconds))
    row["wire_drained"] = wire.drain(60.0)
finally:
    wire.stop()
print(json.dumps(row), flush=True)
"""


def _json_lines(path: str) -> list[dict]:
    """The JSON objects among a log's lines (a worker's stdout and stderr
    share its pool log)."""
    out = []
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            for line in f:
                if line.startswith("{"):
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        pass
    except OSError:
        pass
    return out


def _worker_summaries(fleet_dir: str) -> dict:
    """Per worker log: its ``engine_listening`` lines' ``proto_backend``
    and every incarnation's final summary (``mode: listen``)."""
    out = {}
    for name in sorted(os.listdir(fleet_dir)):
        if not (name.startswith("e") and name.endswith(".log")):
            continue
        rows = _json_lines(os.path.join(fleet_dir, name))
        out[name[:-4]] = {
            "proto_backends": [r.get("proto_backend") for r in rows
                               if r.get("event") == "engine_listening"],
            "summaries": [r for r in rows if r.get("mode") == "listen"]}
    return out


def _lockstep(submit, sids: list, sessions: list, steps: int,
              workers: int) -> list[list[dict]]:
    """``steps`` rounds: every session's current observation submitted at
    once (one request in flight per session), each round waited for, every
    session advanced by its own served action. ``submit(sid, obs) ->
    dict`` (the wire reply). Returns per round, per session: the reply and
    the observation sent."""
    from concurrent.futures import ThreadPoolExecutor

    rounds = []
    with ThreadPoolExecutor(workers) as pool:
        for _ in range(steps):
            obs = [s.observation() for s in sessions]
            replies = list(pool.map(submit, sids, obs, timeout=120.0))
            for sess, reply in zip(sessions, replies):
                sess.advance(int(reply["action"]))
            rounds.append([{**r, "obs": o} for r, o in zip(replies, obs)])
    return rounds


def _wire_submit(host: str, port: int):
    """A ``submit(sid, obs) -> reply`` over one keep-alive FleetClient per
    calling thread."""
    import threading

    from sharetrade_tpu_torch.fleet import FleetClient
    local = threading.local()
    clients = []

    def submit(sid, obs):
        client = getattr(local, "client", None)
        if client is None:
            client = local.client = FleetClient(host, port, timeout_s=120.0)
            clients.append(client)
        return client.submit(sid, obs)

    submit.close = lambda: [c.close() for c in clients]
    return submit


def _reference_errors(torch, engine, rounds: list[list[dict]],
                      sids: list) -> dict:
    """The same observation sequences through an in-process engine, round
    by round (its sessions never evicted): the largest logit and value
    differences against the wire's answers."""
    logit_err = value_err = 0.0
    for rnd in rounds:
        handles = [engine.submit(sid, r["obs"]) for sid, r in zip(sids, rnd)]
        for h, r in zip(handles, rnd):
            res = h.wait(120.0)
            if res is None:
                raise RuntimeError(f"chip_smoke: reference request failed: "
                                   f"{h.error!r}")
            logit_err = max(logit_err, float(np.abs(
                np.asarray(r["logits"], np.float32) - res.logits).max()))
            value_err = max(value_err, abs(float(r["value"]) - res.value))
    return {"logit_max_abs_err": logit_err, "value_max_abs_err": value_err}


def _cpu_s(pid: int) -> float | None:
    """User + system CPU seconds of a live process (``/proc/<pid>/stat``),
    or None once it is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rpartition(")")[2].split()
    except OSError:
        return None
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def _all_cpu_s() -> dict:
    """``{pid: (command name, CPU seconds)}`` of every process visible."""
    out = {}
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/comm") as f:
                    comm = f.read().strip()
            except OSError:
                continue
            cpu = _cpu_s(int(entry))
            if cpu is not None:
                out[int(entry)] = (comm, cpu)
    return out


def _host_share(pids: dict, run) -> tuple:
    """Run ``run()`` and return its result with where the host's CPU went
    meanwhile: CPU seconds per named process (``pids``; this process as
    ``smoke``, the children ``run`` waits for as ``client``) and of the
    busiest other processes, the wall seconds, and this process's live
    threads by name (digits dropped)."""
    import resource
    import threading

    pids = {"smoke": os.getpid(), **pids}
    before = _all_cpu_s()
    kids = resource.getrusage(resource.RUSAGE_CHILDREN)
    t0 = time.perf_counter()
    out = run()
    wall = time.perf_counter() - t0
    kids_after = resource.getrusage(resource.RUSAGE_CHILDREN)
    after = _all_cpu_s()
    spent = {pid: (comm, cpu - before.get(pid, (comm, 0.0))[1])
             for pid, (comm, cpu) in after.items()}
    cpu = {k: spent.get(v, ("", None))[1] for k, v in pids.items()}
    cpu["client"] = (kids_after.ru_utime + kids_after.ru_stime
                     - kids.ru_utime - kids.ru_stime)
    named = set(pids.values())
    others = sorted(((c, comm, pid) for pid, (comm, c) in spent.items()
                     if pid not in named and c > 0.05), reverse=True)
    threads: dict = {}
    for t in threading.enumerate():
        name = "".join(c for c in t.name if not c.isdigit()).strip("-_ ")
        threads[name] = threads.get(name, 0) + 1
    return out, {"wall_s": wall, "cores": os.cpu_count(), "cpu_s": cpu,
                 "other_processes": len(after) - len(named),
                 "busiest_others": [{"pid": pid, "comm": comm, "cpu_s": c}
                                    for c, comm, pid in others[:6]],
                 "smoke_threads": threads}


def _p50_ms(fn, n: int) -> float:
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        lat.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(lat))


def _wait_for(predicate, timeout_s: float, what: str) -> float:
    t0 = time.monotonic()
    while not predicate():
        if time.monotonic() - t0 > timeout_s:
            raise RuntimeError(f"chip_smoke: timed out waiting for {what}")
        time.sleep(0.1)
    return time.monotonic() - t0


def _fleet_cli(torch, engine, problems: list) -> dict:
    """(a), (b) and the relay overhead of (d): ``cli fleet`` as a user runs
    it, driven over the wire, then SIGTERM."""
    import signal
    import tempfile

    from sharetrade_tpu_torch.fleet import FleetClient
    from sharetrade_tpu_torch.serve.driver import make_sessions

    cfg_prices = _prices(_flagship_cfg().data)
    window = _flagship_cfg().env.window
    work = _fresh_dir("fleet-cli-")
    fleet_dir = os.path.join(work, "fleet")
    obs_dir = os.path.join(work, "obs")
    ckpts = tempfile.mkdtemp(prefix="ckpt-", dir=work)   # empty: seeded init
    cmd = [sys.executable, "-m", "sharetrade_tpu_torch.cli", "fleet"]
    for item in FLEET + [f"runtime.checkpoint_dir={ckpts}",
                         f"fleet.dir={fleet_dir}", "obs.enabled=true",
                         f"obs.dir={obs_dir}"]:
        cmd += ["--set", item]
    out_path = os.path.join(work, "fleet.out")
    err_path = os.path.join(work, "fleet.err")
    row: dict = {}
    t0 = time.perf_counter()
    with open(out_path, "wb") as out, open(err_path, "wb") as err:
        proc = subprocess.Popen(cmd, stdout=out, stderr=err, cwd=work,
                                env=_cli_env())
    try:
        ready = None

        def _ready():
            nonlocal ready
            if proc.poll() is not None:
                raise RuntimeError("chip_smoke: cli fleet exited before "
                                   "fleet_ready")
            for r in _json_lines(out_path):
                if r.get("event") == "fleet_ready":
                    ready = r
            return ready is not None

        _wait_for(_ready, 300.0, "fleet_ready")
        row["ready_s"] = time.perf_counter() - t0
        row["ready"] = ready
        if ready["engines"] != 2:
            problems.append(f"fleet_ready with {ready['engines']} engines")
        host, port = ready["host"], ready["port"]

        # (a) closed loop through the router, from a fresh client process.
        prices_path = os.path.join(work, "prices.npy")
        np.save(prices_path, cfg_prices)
        with open(os.path.join(fleet_dir, "engine_pool.json")) as f:
            workers = {name: e["pid"] for name, e in json.load(f)[
                "engines"].items()}
        client, row["host"] = _host_share(
            {"router": proc.pid, **workers}, lambda: subprocess.run(
                [sys.executable, "-c", FLEET_CLIENT, host, str(port),
                 prices_path, str(window), str(FLEET_SESSIONS),
                 str(FLEET_LOOP_S)], capture_output=True, text=True,
                timeout=300, cwd=work, env={**_cli_env(),
                                            "CUDA_VISIBLE_DEVICES": ""}))
        if client.returncode != 0:
            raise RuntimeError(f"chip_smoke: the fleet's wire client "
                               f"failed:\n{client.stderr[-2000:]}")
        row["closed_loop"] = json.loads(client.stdout.strip().splitlines()[-1])
        time.sleep(1.2)         # two router polls past the loop
        with open(os.path.join(fleet_dir, "fleet_status.json")) as f:
            status = json.load(f)
        row["router"] = {"fleet_request_ms": status["fleet_request_ms"],
                         **{k: status["gauges"].get(k) for k in (
                             "fleet_p50_ms", "fleet_p99_ms",
                             "fleet_engines_live")}}
        if (row["closed_loop"]["failed"] or not row["closed_loop"]["completed"]
                or not row["closed_loop"]["wire_drained"]):
            problems.append("(a) closed loop had failures or no answers")

        # (b) 32 sessions x 8 steps, one in flight each, against an
        # in-process engine on the same seeded weights.
        sids = [f"ans{i}" for i in range(32)]
        submit = _wire_submit(host, port)
        try:
            rounds = _lockstep(submit, sids, make_sessions(
                cfg_prices, window, 32, seed=2, prefix="ans"), 8, 32)
        finally:
            submit.close()
        row["answers"] = {"sessions": 32, "steps": 8, **_reference_errors(
            torch, engine, rounds, sids)}
        row["answers"]["engines"] = sorted({r["engine"] for rnd in rounds
                                            for r in rnd})
        if (row["answers"]["logit_max_abs_err"] > LOGIT_ATOL
                or row["answers"]["value_max_abs_err"] > VALUE_ATOL):
            problems.append("(b) fleet answers disagree with the "
                            "in-process engine")

        # (d) relay overhead: sequential warm requests through the router
        # against the same straight to one worker.
        with open(os.path.join(fleet_dir, "engine_pool.json")) as f:
            worker_port = next(e["port"] for e in json.load(f)[
                "engines"].values() if e["port"])
        obs = make_sessions(cfg_prices, window, 1, seed=3)[0].observation()
        via, direct = FleetClient(host, port), FleetClient(host, worker_port)
        try:
            via.submit("ov-r", obs)
            direct.submit("ov-d", obs)
            row["router_p50_ms"] = _p50_ms(lambda: via.submit("ov-r", obs),
                                           100)
            row["direct_p50_ms"] = _p50_ms(
                lambda: direct.submit("ov-d", obs), 100)
        finally:
            via.close()
            direct.close()
        row["relay_overhead_ms"] = row["router_p50_ms"] - row["direct_p50_ms"]

        proc.send_signal(signal.SIGTERM)
        row["rc"] = proc.wait(120.0)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = _json_lines(out_path)
    summary = lines[-1] if lines else {}
    row["summary"] = summary
    row["workers"] = _worker_summaries(fleet_dir)
    if row.get("rc") != 75:
        problems.append(f"cli fleet exited {row.get('rc')} on SIGTERM, "
                        "not 75")
    if not (summary.get("requests") and summary.get("requests")
            == summary.get("completed", 0) + summary.get("refused", 0)
            and summary.get("unrouted", 1) == 0):
        problems.append("cli fleet summary: requests != completed + refused, "
                        "or unrouted requests")
    launches = [w["summaries"][-1].get("flash_fwd_launches", 0)
                if w["summaries"] else 0 for w in row["workers"].values()]
    row["worker_flash_fwd_launches"] = launches
    if len(launches) != 2 or min(launches) <= 0:
        problems.append("(a) a worker's summary shows no flash_fwd launch")
    if not ready or ready.get("proto_backend") != "py":
        problems.append("fleet_ready names no live proto_backend")
    if row.get("rc") != 75:
        row["stderr_tail"] = open(err_path, errors="replace").read()[-2000:]
    row["obs"] = _fleet_cli_traces(obs_dir, fleet_dir, work, problems)
    return row


def _cli_obs(args: list, work: str):
    """``cli obs`` with ``args`` (no device): (returncode, parsed stdout)."""
    out = subprocess.run(
        [sys.executable, "-m", "sharetrade_tpu_torch.cli", "obs", *args],
        capture_output=True, text=True, timeout=300, cwd=work,
        env={**_cli_env(), "CUDA_VISIBLE_DEVICES": ""})
    try:
        return out.returncode, json.loads(out.stdout)
    except ValueError:
        return out.returncode, None


def _stitch_all(spans: list) -> list[dict]:
    """Every trace of ``spans`` stitched: grouped by trace id in one pass,
    each group stitched on its own (``stitch`` scans what it is given)."""
    from sharetrade_tpu_torch.obs import collect
    groups: dict = {}
    for s in spans:
        groups.setdefault(s["trace"], []).append(s)
    return [collect.stitch(group, tid) for tid, group in groups.items()]


def _fleet_cli_traces(obs_dir: str, fleet_dir: str, work: str,
                      problems: list) -> dict:
    """(d) on ``cli fleet``'s run: ``cli obs --trace list``, every trace
    that spans the router and a worker stitched, one through ``cli obs
    --trace <id> --out``, and ``cli obs --dir <fleet dir> --history``."""
    from sharetrade_tpu_torch.obs import collect
    rc, listed = _cli_obs(["--dir", obs_dir, "--trace", "list"], work)
    traces = (listed or {}).get("traces", {})
    stitched = _stitch_all(collect.read_span_dir(
        os.path.join(obs_dir, "spans")))
    both = [t for t in stitched if "fleet" in t["procs"]
            and any(p.startswith("engine-") for p in t["procs"])]
    row = {"list_rc": rc, "traces": len(traces),
           "router_and_worker": len(both),
           "with_errors": sum(1 for t in both if t["errors"]),
           "errors_sample": [t["errors"][:2] for t in both
                             if t["errors"]][:3]}
    if both:
        tid = both[0]["trace_id"]
        rc_one, view = _cli_obs(["--dir", obs_dir, "--trace", tid, "--out",
                                 os.path.join(work, "trace.json")], work)
        row["one"] = {"rc": rc_one, "trace_id": tid,
                      "procs": (view or {}).get("procs"),
                      "spans": len((view or {}).get("spans", []))}
    rc_hist, history = _cli_obs(["--dir", fleet_dir, "--history", "0"], work)
    row["history"] = {"rc": rc_hist, "rows": (history or {}).get("rows")}
    if rc != 0 or not traces:
        problems.append("(d) cli obs --trace list found no trace")
    if not both or row["with_errors"] or row["one"]["rc"] != 0:
        problems.append("(d) no trace spanning the router and a worker "
                        "stitched without errors")
    if rc_hist != 0 or not row["history"]["rows"]:
        problems.append("(d) cli obs --history read no row")
    return row


def _flagship_cfg(extra: list | None = None):
    from sharetrade_tpu_torch.config import FrameworkConfig
    return FrameworkConfig().apply_overrides(FLAGSHIP + (extra or []))


def _fleet_pool(torch, engine_factory, problems: list) -> dict:
    """(c): EnginePool + FleetRouter + ServeFrontend in this process."""
    import signal
    import tempfile

    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.fleet import (
        EnginePool, FleetClient, FleetRouter, ServeFrontend, WireEngine)
    from sharetrade_tpu_torch.obs.exporter import parse_prom_text
    from sharetrade_tpu_torch.serve.driver import make_sessions, run_closed_loop
    from sharetrade_tpu_torch.utils.metrics import MetricsRegistry

    from sharetrade_tpu_torch.fleet.wire import WireTracer
    from sharetrade_tpu_torch.obs import build_obs, collect

    work = _fresh_dir("fleet-pool-")
    spans_dir = os.path.join(work, "spans")
    cfg = FrameworkConfig().apply_overrides(FLEET + FLEET_TIERS + [
        f"runtime.checkpoint_dir={tempfile.mkdtemp(dir=work)}",
        f"fleet.dir={os.path.join(work, 'fleet')}",
        f"data.journal_dir={os.path.join(work, 'journal')}",
        f"obs.span_dir={spans_dir}", "obs.span_proc=fleet"])
    prices = _prices(cfg.data)
    window = cfg.env.window
    registry = MetricsRegistry()
    row: dict = {}
    # The workers are `python -m sharetrade_tpu_torch.cli` children of this
    # process: they find the checkout through PYTHONPATH while the pool runs.
    saved_path = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = _cli_env()["PYTHONPATH"]
    t0 = time.perf_counter()
    # Obs off but the span journal on: the router's relay and the
    # workers' (obs.span_dir handed on by the pool) spans stitch across
    # the SIGKILL below.
    obs = build_obs(cfg, registry, device="cuda")
    pool = EnginePool(cfg, registry=registry, device="cuda").start()
    router = FleetRouter(pool, cfg.fleet, registry, obs_cfg=cfg.obs,
                         obs=obs).start()
    frontend = ServeFrontend(router, registry,
                             tracer=WireTracer(obs.spans, mint=True)).start()

    def engine(engine_id: str) -> dict:
        return pool.status()["engines"][engine_id]

    try:
        _wait_for(lambda: len(pool.endpoints()) == 2, 300.0,
                  "two pool workers listening")
        row["bring_up_s"] = time.perf_counter() - t0
        router.poll_once()

        # 1. SIGKILL one worker under a closed loop of 192 sessions.
        counters0 = dict(registry.counters())
        wire = WireEngine(frontend.host, frontend.port,
                          workers=FLEET_SESSIONS, timeout_s=120.0)
        import threading
        loop: dict = {}
        runner = threading.Thread(target=lambda: loop.update(run_closed_loop(
            wire, make_sessions(prices, window, FLEET_SESSIONS, seed=4,
                                prefix="fk"),
            concurrency=FLEET_SESSIONS, duration_s=FLEET_LOOP_S)))
        runner.start()
        time.sleep(1.0)
        victim_pid = engine("e0")["pid"]
        os.kill(victim_pid, signal.SIGKILL)
        runner.join(120.0)
        drained = wire.drain(60.0)
        wire.stop()
        counters = registry.counters()
        delta = {k: counters.get(k, 0) - counters0.get(k, 0) for k in (
            "fleet_requests_total", "fleet_completed_total",
            "fleet_refused_total", "fleet_unrouted_total",
            "fleet_migrations_total")}
        row["kill"] = {"closed_loop": loop, "router": delta,
                       "wire_drained": drained}
        if not (drained and loop and loop["completed"] + loop["failed"]
                == delta["fleet_requests_total"]
                and loop["completed"] == delta["fleet_completed_total"]):
            problems.append("(c) a request under the kill did not end in "
                            "exactly one outcome")
        if delta["fleet_migrations_total"] <= 0:
            problems.append("(c) the SIGKILL migrated no request")
        row["kill"]["respawn_s"] = _wait_for(
            lambda: (pool.restarts_total == 1 and len(pool.endpoints()) == 2
                     and engine("e0")["state"] == "alive"
                     and engine("e0")["pid"] != victim_pid),
            300.0, "the killed worker's respawn")
        router.poll_once()
        row["kill"]["restarts_total"] = pool.restarts_total
        row["kill"]["endpoints_after"] = len(pool.endpoints())

        # 2. scale(1): the newest engine drains and pages out; the survivor
        # adopts its sessions warm through their session clocks.
        sids = [f"ad{i}" for i in range(32)]
        sessions = make_sessions(prices, window, 32, seed=5, prefix="ad")
        submit = _wire_submit(frontend.host, frontend.port)
        try:
            rounds = _lockstep(submit, sids, sessions, 4, 32)
            homes = [r["engine"] for r in rounds[-1]]
            pool.scale(1)
            retired = "e1"
            row["scale"] = {"homes": {e: homes.count(e) for e in set(homes)},
                            "retire_s": _wait_for(
                                lambda: engine(retired)["state"]
                                == "retired", 120.0, "e1's retirement")}
            rounds += _lockstep(submit, sids, sessions, 1, 32)
        finally:
            submit.close()
        survivor = pool.endpoints()
        row["scale"]["endpoints_after"] = sorted(survivor)
        client = FleetClient(*survivor["e0"])
        try:
            metrics = parse_prom_text(client.metrics())["counters"]
        finally:
            client.close()
        row["scale"]["adopt_warm"] = metrics.get(
            "sharetrade_serve_adopt_warm_total", 0)
        row["scale"]["adopt_cold"] = metrics.get(
            "sharetrade_serve_adopt_cold_total", 0)
        row["scale"]["last_engines"] = sorted({r["engine"]
                                               for r in rounds[-1]})
        ref = engine_factory()
        try:
            row["scale"].update(_reference_errors(torch, ref, rounds, sids))
        finally:
            ref.stop(drain=False, timeout_s=10.0)
        if row["scale"]["adopt_warm"] <= 0:
            problems.append("(c) no session adopted warm after scale(1)")
        if homes.count(retired) == 0:
            problems.append("(c) no session lived on the retired engine")
        if (row["scale"]["logit_max_abs_err"] > LOGIT_ATOL
                or row["scale"]["value_max_abs_err"] > VALUE_ATOL):
            problems.append("(c) answers after the scale-down disagree "
                            "with the in-process engine")
        if row["kill"]["restarts_total"] != 1:
            problems.append("(c) the pool did not respawn the victim once")
    finally:
        frontend.stop()
        router.stop()
        pool.stop(grace_s=30.0)
        obs.close()
        if saved_path is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = saved_path
    t0 = time.perf_counter()
    spans = collect.read_span_dir(spans_dir)
    migrated = collect.migrated_traces(spans)
    row["traces"] = {
        "spans": len(spans), "migrated": len(migrated),
        "migrated_with_errors": sum(1 for t in migrated if t["errors"]),
        "migrated_through_the_victim": sum(
            1 for t in migrated if "engine-e0" in t["engines"]),
        "collect_s": time.perf_counter() - t0}
    if (not migrated or row["traces"]["migrated_with_errors"]
            or len(migrated) < row["kill"]["router"][
                "fleet_migrations_total"]):
        problems.append("(c) migrated_traces missed a migrated request or "
                        "one did not stitch cleanly")
    row["workers"] = _worker_summaries(os.path.join(work, "fleet"))
    row["flash_fwd_launches"] = sum(
        s.get("flash_fwd_launches", 0) for w in row["workers"].values()
        for s in w["summaries"])
    return row


def phase_fleet(torch) -> dict:
    """The serving fleet on the card; see the module docstring."""
    from sharetrade_tpu_torch.env.trading import obs_dim
    from sharetrade_tpu_torch.models import build_model
    from sharetrade_tpu_torch.precision import policy_from_config
    from sharetrade_tpu_torch.serve import ServeEngine

    cfg = _flagship_cfg()
    model = build_model(cfg.model, obs_dim(cfg.env.window), device="cuda")
    params = model.init(torch.Generator().manual_seed(cfg.seed))
    policy = policy_from_config(cfg.precision)

    def engine_factory():
        engine = ServeEngine(model, cfg.serve, params, precision=policy)
        engine.warmup()
        return engine

    problems: list = []
    t0 = time.perf_counter()
    reference = engine_factory()
    try:
        cli_row = _fleet_cli(torch, reference, problems)
    finally:
        reference.stop(drain=False, timeout_s=10.0)
    pool_row = _fleet_pool(torch, engine_factory, problems)
    launches = sum(cli_row.get("worker_flash_fwd_launches", [])) \
        + pool_row["flash_fwd_launches"]
    return {"phase": "fleet", "config": FLEET, "seconds":
            time.perf_counter() - t0, "cli": cli_row, "pool": pool_row,
            "worker_bring_up_s": {"cli_fleet_ready": cli_row.get("ready_s"),
                                  "pool_two_listening":
                                  pool_row.get("bring_up_s")},
            "relay_overhead_ms": cli_row.get("relay_overhead_ms"),
            "proto_backend": (cli_row.get("ready") or {}).get(
                "proto_backend"),
            "launches": {"flash_fwd": launches},
            "logit_atol": LOGIT_ATOL, "value_atol": VALUE_ATOL,
            "problems": problems}


#: The remat_moe phase. (a) The flagship (``FLAGSHIP_TRAIN``) with an
#: 8-expert MoE FFN in every block, dense-mask top-1 and capacity top-2,
#: trained and served (64-row batches, 256 slots, as ``FLAGSHIP``).
MOE_FLAGSHIPS = {
    f"flagship_moe_top{k}": FLAGSHIP_TRAIN + [
        "model.moe_experts=8", f"model.moe_top_k={k}",
        "serve.max_batch=64", "serve.slots=256"]
    for k in (0, 2)}
#: (b) ``ppo_transformer_b1024_bf16`` (benchmarks/run_all.py:138): the
#: window transformer, 1,024 agents, unroll 32; ``learner.remat`` on (as
#: there) and off.
B1024 = ["learner.algo=ppo", "model.kind=transformer", "model.num_layers=2",
         "model.num_heads=2", "model.head_dim=128",
         "precision.mode=bf16_mixed", "parallel.num_workers=1024",
         "learner.unroll_len=32", "runtime.chunk_steps=32"]
#: (c) ``ppo_tr_episode_large_d1024`` and ``_remat`` (run_all.py:180, :190):
#: d_model 1,024 (L 4, H 8, Dh 128), 64 agents, unroll 512;
#: ``model.remat_blocks`` off and on.
D1024 = ["learner.algo=ppo", "model.kind=transformer",
         "model.seq_mode=episode", "model.num_layers=4", "model.num_heads=8",
         "model.head_dim=128", "precision.mode=bf16_mixed",
         "parallel.num_workers=64", "learner.unroll_len=512",
         "runtime.chunk_steps=512"]
#: Chunks of each remat pair's run through the chunk program: the eager
#: warm-up, the capture (and its replay), then plain replays, whose median
#: wall time is the replay's. b1024 runs one plain replay (its chunks take
#: 3.6-4.9 s and remat's price, ~25%, is far outside their spread); d1024
#: three (its price sits inside one replay's spread).
REMAT_CHUNKS = 5
B1024_CHUNKS = 3
#: (d) The attention kernels at these paths' own grids, bf16 D 128, against
#: their plain versions and timed: d1024's rollout trunk (1 representative
#: x 8 heads, hist 600 + window 201 + unroll 512 = 1,313 ticks) and shared
#: replay (1,312), band 201; b1024's rollout step (1,024 agents x 2 heads)
#: and replay fold group (2,048 rows x 2 heads), causal over T 202. The
#: backward at the replays'.
REMAT_ATTENTION_CASES = [
    dict(name="d1024_trunk_bf16", batch=1, heads=8, seq=1313, window=201),
    dict(name="d1024_replay_bf16", batch=1, heads=8, seq=1312, window=201,
         backward=True),
    dict(name="b1024_rollout_bf16", batch=1024, heads=2, seq=202,
         window=None),
    dict(name="b1024_replay_bf16", batch=2048, heads=2, seq=202, window=None,
         backward=True),
]
#: (d) fused_update over the leaves of d1024 (4 blocks at d 1,024) and of
#: the top-2 MoE flagship (the (8, 256, 1024) / (8, 1024, 256) expert
#: leaves), as the training path runs it: adagrad, bf16 grads, the bf16
#: compute copy written.
REMAT_UPDATE_MODELS = {"ppo_tr_episode_large_d1024": D1024,
                       "flagship_moe_top2": MOE_FLAGSHIPS["flagship_moe_top2"]}
REMAT_UPDATE_CASES = [dict(name=f"{model}_adagrad_bf16", optimizer="adagrad",
                           grad_dtype="bfloat16", emit=True, model=model)
                      for model in REMAT_UPDATE_MODELS]


def _expected_launches(cfg) -> dict:
    """Kernel launches of one PPO chunk of ``cfg``, from the code: the
    rollout's attention passes (one trunk pass a layer in episode mode;
    ``unroll + 1`` batched steps a layer in window mode), then per update
    one replay pass a layer (episode mode) or one per fold group and layer
    (``agents/rollout.replay_forward``), each with its backward; a
    checkpointed replay runs its forward once more in the backward."""
    from sharetrade_tpu_torch.agents.ppo import num_minibatches
    from sharetrade_tpu_torch.agents.rollout import _MAX_FOLD_ROWS
    layers, steps = cfg.model.num_layers, cfg.runtime.chunk_steps
    workers = cfg.parallel.num_workers
    updates = cfg.learner.ppo_epochs * num_minibatches(cfg.learner, workers)
    if cfg.model.seq_mode == "episode":
        rollout, groups = 1, 1
    else:
        rows = workers // num_minibatches(cfg.learner, workers)
        fold = max(f for f in range(1, steps + 1) if steps % f == 0
                   and (f * rows <= _MAX_FOLD_ROWS or f == 1))
        rollout, groups = steps + 1, steps // fold
    passes = layers * updates * groups
    remat = cfg.learner.remat or cfg.model.remat_blocks
    return {"flash_fwd": layers * rollout + passes * (2 if remat else 1),
            "flash_bwd_dq": passes, "flash_bwd_dkv": passes,
            "fused_update": updates}


def _moe_flagship(torch, name, overrides) -> tuple[dict, list]:
    """(a) One MoE flagship: three chunks eagerly and through the chunk
    program (``_eager_vs_graph``: bit-equal, the same launches, each chunk
    the flagship's counts), one minibatch through the kernels against the
    plain attention (MB_*; its replay's aux > 0), then served
    (``_family_serve``: every batch against the plain path, and at top-0
    every session's answers too), and for top-2 ``cli serve``."""
    from sharetrade_tpu_torch.agents import build_agent
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.env.trading import make_trading_env

    cfg = FrameworkConfig().apply_overrides(overrides)
    prices = _prices(cfg.data)
    env = make_trading_env(prices, window=cfg.env.window,
                           initial_budget=cfg.env.initial_budget,
                           initial_shares=cfg.env.initial_shares,
                           device="cuda")
    agent = build_agent(cfg, env, device="cuda")
    problems: list[str] = []
    before = _all_launch_counts()
    train = _eager_vs_graph(torch, agent, cfg.seed)
    after = _all_launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    expect = _expected_launches(cfg)
    replay_ms = train["graph"]["chunk_ms"][-1]
    train.update(expected_per_chunk=expect, replay_ms=replay_ms,
                 agent_steps_per_s=(cfg.parallel.num_workers
                                    * cfg.runtime.chunk_steps
                                    / (replay_ms / 1e3)))
    if not (train["bit_equal"] and train["launches_equal"]):
        problems.append(f"{name}: graph chunks differ from the eager ones")
    if any({k: c.get(k, 0) for k in expect} != expect
           for c in train["eager"]["launches_per_chunk"]):
        problems.append(f"{name}: launches per chunk differ from {expect}")
    if not np.isfinite(train["eager"]["metrics"]).all():
        problems.append(f"{name}: non-finite chunk metrics")
    minibatch = _minibatch_check(torch, cfg, env, agent,
                                 agent.init(cfg.seed + 1), overrides,
                                 pin_routing=True)
    if minibatch["failed"]:
        problems.append(f"{name}: one minibatch through the kernels "
                        f"disagrees with the plain attention's: "
                        f"{minibatch['failed']}")
    if not minibatch["aux"]["kernel"] > 0.0:
        problems.append(f"{name}: the replay's balance loss is not live")
    del agent
    torch.cuda.empty_cache()
    serve, bad = _family_serve(torch, name, cfg, prices, pin_routing=True)
    problems += bad
    for k, n in serve.get("launches", {}).items():
        launches[k] = launches.get(k, 0) + n
    row = {"config": overrides, "train": train, "minibatch": minibatch,
           "serve": serve, "launches": launches}
    if cfg.model.moe_top_k:
        row["cli"], bad = _family_cli(name, cfg, overrides)
        problems += bad
    return row, problems


def _remat_state_check(torch, a, b, start) -> dict:
    """Two states after the same chunks with remat on (``a``) and off
    (``b``): bit-equal (expected: the recompute runs the same kernels on
    the same inputs), or else each parameter leaf within ``MB_FLOOR`` of
    that leaf's own change over the chunks, in L2 norm."""
    from sharetrade_tpu_torch import convert
    out = {"bit_equal": _bit_equal(torch, a, b), **_state_diff(a, b)}
    if out["bit_equal"]:
        out["within"] = "bit_equal"
        return out
    la, lb = convert.train_state_leaves(a), convert.train_state_leaves(b)
    l0 = convert.train_state_leaves(start)
    worst = 0.0
    for leaf, x in la.items():
        if not leaf.startswith("params."):
            continue
        moved = (lb[leaf].float() - l0[leaf].float()).norm().item()
        diff = (x.float() - lb[leaf].float()).norm().item()
        worst = max(worst, diff / max(moved, 1e-30))
    out["worst_param_diff_over_change"] = worst
    out["within"] = "mb_floor" if worst <= MB_FLOOR else "no"
    return out


def _remat_pair(torch, name, overrides, knob,
                chunks: int = REMAT_CHUNKS) -> tuple[dict, list]:
    """(b), (c) One configuration with ``knob`` on and off from the same
    seeded state, each through a chunk program (``_eager_vs_graph`` in
    graph mode, ``chunks`` chunks: eager, capture, replays): per
    chunk the wall ms, the launches against ``_expected_launches`` and the
    peak device memory; agent-steps/s and MFU of the median replay. Then
    the two final states held by ``_remat_state_check``, and remat must
    show more ``flash_fwd`` launches and a lower peak. An out-of-memory
    error of the run without remat is reported, not raised. Last, one
    minibatch of the remat configuration through the kernels against the
    plain attention and fp32 (``_minibatch_check``; with remat, because
    the fp32 path without it would keep twice the plain run's residuals,
    37 GB at b1024)."""
    from sharetrade_tpu_torch.agents import build_agent
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.env.trading import make_trading_env
    from sharetrade_tpu_torch.runtime.orchestrator import _clone_state
    from sharetrade_tpu_torch.utils import flops

    row: dict = {"config": overrides, "knob": knob}
    problems: list[str] = []
    finals, launches = {}, {}
    for remat in (True, False):
        tag = "remat" if remat else "plain"
        cfg = FrameworkConfig().apply_overrides(
            overrides + [f"{knob}={'true' if remat else 'false'}"])
        env = make_trading_env(_prices(cfg.data), window=cfg.env.window,
                               initial_budget=cfg.env.initial_budget,
                               initial_shares=cfg.env.initial_shares,
                               device="cuda")
        agent = build_agent(cfg, env, device="cuda")
        states: dict = {}
        try:
            run = _eager_vs_graph(torch, agent, cfg.seed, chunks,
                                  modes=("graph",), finals=states)["graph"]
        except torch.cuda.OutOfMemoryError as exc:
            run = {"out_of_memory": str(exc).splitlines()[0][:300]}
            if remat:
                problems.append(f"{name} {tag}: out of memory")
        if "out_of_memory" not in run:
            steps = cfg.parallel.num_workers * cfg.runtime.chunk_steps
            replay_ms = statistics.median(run["chunk_ms"][2:])
            rate = steps / (replay_ms / 1e3)
            run.update(
                replay_ms=replay_ms, agent_steps_per_s=rate,
                model_flops_per_agent_step=flops.train_flops_per_agent_step(
                    cfg, env.obs_dim),
                mfu=flops.mfu(rate, cfg, env.obs_dim),
                expected_per_chunk=_expected_launches(cfg))
            if not np.isfinite(run["metrics"]).all():
                problems.append(f"{name} {tag}: non-finite metrics")
            for c in run["launches_per_chunk"]:
                for k, n in c.items():
                    launches[k] = launches.get(k, 0) + n
            if any({k: c.get(k, 0) for k in run["expected_per_chunk"]}
                   != run["expected_per_chunk"]
                   for c in run["launches_per_chunk"]):
                problems.append(f"{name} {tag}: launches per chunk differ "
                                f"from {run['expected_per_chunk']}")
            finals[tag] = _clone_state(states["graph"])
        row[tag] = run
        if remat:
            remat_cfg, remat_env, remat_agent = cfg, env, agent
        del agent, states
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    if len(finals) == 2:
        cfg = FrameworkConfig().apply_overrides(overrides)
        env = make_trading_env(_prices(cfg.data), window=cfg.env.window,
                               device="cuda")
        start = build_agent(cfg, env, device="cuda").init(cfg.seed)
        row["remat_vs_plain"] = _remat_state_check(
            torch, finals["remat"], finals["plain"], start)
        if row["remat_vs_plain"]["within"] == "no":
            problems.append(f"{name}: the state with remat differs from "
                            "the state without")
        fwd = [row[t]["launches_per_chunk"][0].get("flash_fwd", 0)
               for t in ("remat", "plain")]
        peak = [row[t]["peak_allocated_bytes"] for t in ("remat", "plain")]
        row["recompute_price"] = (row["remat"]["agent_steps_per_s"]
                                  / row["plain"]["agent_steps_per_s"])
        if not (fwd[0] > fwd[1] and peak[0] < peak[1]):
            problems.append(f"{name}: remat shows flash_fwd {fwd} and peak "
                            f"bytes {peak} (remat, plain)")
        del start, finals
    # The main path's launches end here: the minibatch check compares.
    row["launches"] = launches
    row["minibatch"] = _minibatch_check(
        torch, remat_cfg, remat_env, remat_agent,
        remat_agent.init(remat_cfg.seed + 1), overrides + [f"{knob}=true"])
    if row["minibatch"]["failed"]:
        problems.append(f"{name}: one minibatch through the kernels "
                        f"disagrees with the plain attention's: "
                        f"{row['minibatch']['failed']}")
    del remat_agent
    torch.cuda.empty_cache()
    return row, problems


def _remat_kernel_rows(torch) -> list[dict]:
    """(d) ``REMAT_ATTENTION_CASES`` and ``REMAT_UPDATE_CASES`` against
    their plain versions, timed as the kernels phase times."""
    rows = []
    for case in REMAT_ATTENTION_CASES:
        case = dict(case, head_dim=128, dtype=torch.bfloat16)
        backward = case.pop("backward", False)
        rows.append(check_flash_fwd(torch, **case))
        if backward:
            rows += check_flash_bwd(torch, **case)
    rows += [check_fused_update(torch, **case) for case in REMAT_UPDATE_CASES]
    return [{**r, "phase": "remat_moe"} for r in rows]


def phase_remat_moe(torch) -> dict:
    """The episode transformer's MoE and rematerialisation; see the
    module docstring."""
    row: dict = {"phase": "remat_moe"}
    problems: list[str] = []
    totals: dict = {}
    parts = [(name, lambda n=name, o=overrides: _moe_flagship(torch, n, o))
             for name, overrides in MOE_FLAGSHIPS.items()]
    parts += [("ppo_transformer_b1024_bf16",
               lambda: _remat_pair(torch, "ppo_transformer_b1024_bf16",
                                   B1024, "learner.remat", B1024_CHUNKS)),
              ("ppo_tr_episode_large_d1024",
               lambda: _remat_pair(torch, "ppo_tr_episode_large_d1024",
                                   D1024, "model.remat_blocks"))]
    for name, run in parts:
        t0 = time.perf_counter()
        _reset_launch_counts()
        part, bad = run()
        part["seconds"] = time.perf_counter() - t0
        problems += bad
        for k, n in part["launches"].items():
            totals[k] = totals.get(k, 0) + n
        row[name] = part
        torch.cuda.empty_cache()
    row["kernels"] = _remat_kernel_rows(torch)
    problems += [f"{r['kernel']}:{r['case']} disagrees with its plain "
                 "version" for r in row["kernels"] if not r["ok"]]
    row["launches"] = totals
    row["problems"] = problems
    return row


# ---------------------------------------------------------------------------
# actors: cli learner with its actor pool, the ingest into the chunk graph,
# the kill test, weight swaps, the flywheel, the drain
# ---------------------------------------------------------------------------

#: The actors phase: the reference workload (the JAX package's defaults:
#: q_mlp 203 -> 200 -> 3, 10 agents a process, 200-step chunks, replay
#: capacity 65,536, the 6,046-tick MSFT history) under DQN with two actors.
#: The rest paces the run and cuts no width: episodes without end (the
#: phase ends the run), no cadence checkpoint (a DQN save is ~110 MB), a
#: greedy eval every 30 chunks (republishes ``tag_best``), a readback every
#: chunk (the learner ingests every chunk) and quick polls; the actors'
#: journals rotate at ``cli learner``'s default of 256 records a segment.
#: An actor retires whole segments once twice ``replay_capacity`` newer
#: rows cover them, so a learner that falls that far behind loses rows it
#: has not read; (f) accounts for them tick by tick and reports them.
ACTORS = [
    "learner.algo=dqn", "distrib.num_actors=2", "runtime.episodes=100000",
    "runtime.checkpoint_every_updates=0", "runtime.eval_every_updates=6000",
    "runtime.metrics_every_chunks=1", "distrib.weight_poll_s=0.5",
    "distrib.heartbeat_interval_s=0.2", "distrib.supervise_interval_s=0.1",
    "distrib.actor_backoff_initial_s=0.1", "distrib.actor_backoff_max_s=0.5"]
#: ``cli fleet --learner``: one engine serving the learner's Q-network, the
#: learner republishing ``tag_best`` every 10 chunks, the engine polling it
#: every 0.5 s.
FLYWHEEL = [
    "learner.algo=dqn", "fleet.num_engines=1", "runtime.episodes=100000",
    "runtime.checkpoint_every_updates=0", "runtime.eval_every_updates=2000",
    "runtime.metrics_every_chunks=1", "serve.swap_poll_s=0.5"]
FLYWHEEL_SESSIONS = 16


def _spawn_cli(argv: list, sets: list, cwd: str):
    """``python -m sharetrade_tpu_torch.cli <argv> --set ...`` in ``cwd``,
    its output to files there: ``(proc, out_path, err_path)``."""
    os.makedirs(cwd, exist_ok=True)
    cmd = [sys.executable, "-m", "sharetrade_tpu_torch.cli", *argv]
    for item in sets:
        cmd += ["--set", item]
    out_path = os.path.join(cwd, "out.txt")
    err_path = os.path.join(cwd, "err.txt")
    with open(out_path, "wb") as out, open(err_path, "wb") as err:
        proc = subprocess.Popen(cmd, stdout=out, stderr=err, cwd=cwd,
                                env=_cli_env())
    return proc, out_path, err_path


def _event_line(proc, out_path: str, event: str, timeout_s: float) -> dict:
    found: list = []

    def ready():
        if proc.poll() is not None:
            raise RuntimeError(f"chip_smoke: the process exited "
                               f"(rc {proc.returncode}) before {event}")
        found[:] = [r for r in _json_lines(out_path)
                    if r.get("event") == event]
        return bool(found)

    _wait_for(ready, timeout_s, event)
    return found[0]


def _pid_gone(pid: int) -> bool:
    """No process ``pid`` (or only its zombie) in ``/proc``."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


def _ingest_ticks(events_path: str) -> list[dict]:
    """``cli learner --events``: its ingest ticks, oldest first."""
    return [e for e in _json_lines(events_path)
            if e.get("kind") == "actor_feed_ingest"]


def _learner_timeline(events_path: str, t0: float) -> dict:
    """From ``cli learner``'s events: the wall seconds (since ``t0``) at
    which each episode completed, and its ingest ticks."""
    events = _json_lines(events_path)
    rows = [e["rows"] for e in events if e.get("kind") == "actor_feed_ingest"]
    return {"episodes_completed_at_s": [
                round(e["ts"] - t0, 2) for e in events
                if e.get("kind") == "episode_completed"],
            "ingest_ticks": len(rows),
            "ingest_rows_median": statistics.median(rows) if rows else 0}


def _reconcile_feed(ticks: list[dict], stamps: list[tuple[int, int]],
                    feed: dict, workers: int) -> tuple[dict, list]:
    """One actor's rows, tick by tick, against its journal. Every agent is
    active at every counted env step, so a record stamped s holding r rows
    covers the stamps (s - r / workers, s]. Each tick must read on from
    the cursor the previous one left, and read exactly ``workers`` rows a
    stamp from its first record to the cursor it leaves; where its first
    record starts past its cursor, the rows between were retired unread
    (the actor keeps twice ``replay_capacity`` rows of sealed segments),
    and the journal must hold no record there now. The ticks' sum is the
    learner's count and their last cursor its cursor."""
    problems = []
    cursor = lost = read = 0
    for i, tick in enumerate(ticks):
        first_stamp, first_rows = tick["first"]
        start = first_stamp - first_rows // workers
        if (tick["cursor"] != cursor or first_rows % workers
                or start < cursor
                or tick["rows"] != workers * (tick["high_water"] - start)):
            problems.append(f"tick {i} {tick} after cursor {cursor}")
        if start > cursor:
            if any(cursor < s <= start for s, _ in stamps):
                problems.append(f"tick {i} skipped surviving records in "
                                f"({cursor}, {start}]")
            lost += workers * (start - cursor)
        read += tick["rows"]
        cursor = tick["high_water"]
    if read != feed["rows"] or cursor != feed["cursor"]:
        problems.append(f"the ticks sum to {read} rows to cursor {cursor}, "
                        f"the learner counted {feed}")
    return {**feed, "ticks": len(ticks), "rows_read_by_ticks": read,
            "retired_unread_rows": lost,
            "committed_rows_to_cursor": workers * cursor,
            "journal_high_water": stamps[-1][0] if stamps else None,
            "journal_oldest": list(stamps[0]) if stamps else None}, problems


def _last_row(path: str, stamp: int) -> np.ndarray:
    """The newest observation of the record stamped ``stamp``."""
    from sharetrade_tpu_torch.data.transitions import (
        read_new_transitions, transition_stamps)
    stamps = [s for s, _ in transition_stamps(path)]
    before = stamps[stamps.index(stamp) - 1] if stamps.index(stamp) else 0
    return read_new_transitions(path, before, 1)[0][-1]


def _actors_ingest(torch, pool_dir: str, prices, work: str) -> dict:
    """(b): an in-process DQN learner on the card over the live actors'
    journals: two chunks (eager, then the capture and a replay), an ingest
    tick, then one replayed chunk against one eager chunk from a copy of the
    same state and generator; uniform replay and PER."""
    from sharetrade_tpu_torch.agents.base import _metric_vector
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.runtime import Orchestrator
    from sharetrade_tpu_torch.runtime.orchestrator import _clone_state
    out: dict = {}
    for priority in ("uniform", "per"):
        cfg = FrameworkConfig().apply_overrides([
            "learner.algo=dqn", f"learner.replay_priority={priority}",
            "distrib.ingest_without_pool=true",
            f"distrib.actor_dir={pool_dir}",
            f"runtime.checkpoint_dir={os.path.join(work, priority, 'ck')}",
            f"data.journal_dir={os.path.join(work, priority, 'j')}"])
        orch = Orchestrator(cfg, device="cuda")
        try:
            orch.send_training_data(prices)
            for _ in range(2):
                orch._dispatch(1)
            size0 = int(orch._ts.extras.replay.size)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = orch.ingest_actor_feeds()
            torch.cuda.synchronize()
            ticks = [{"rows": rows, "ms": (time.perf_counter() - t0) * 1e3}]
            replay = orch._ts.extras.replay
            size1 = int(replay.size)
            # The last row pushed (the last actor's newest row read) in the
            # live buffer, the graph's, just behind the write position.
            last_aid = max(a for a, f in orch.actor_feeds.items() if f["rows"])
            last = _last_row(os.path.join(pool_dir, last_aid,
                                          "transitions.journal"),
                             orch.actor_feeds[last_aid]["cursor"])
            slot = (int(replay.pos) - 1) % replay.obs.shape[0]
            landed = (size1 == min(replay.obs.shape[0], size0 + rows)
                      and bool(torch.equal(replay.obs[slot].cpu(),
                                           torch.from_numpy(last))))
            eager = _clone_state(orch._ts)
            eager, metrics = orch.agent.step(eager,
                                             draws=orch.agent.draw(eager))
            stacked = orch._dispatch(1)
            vector = _metric_vector(metrics, stacked.keys, "cuda")
            equal = (_bit_equal(torch, orch._ts, eager)
                     and bool(torch.equal(vector, stacked.values[0])))
            out[priority] = {
                "replay_size_before": size0, "replay_size_after": size1,
                "landed_in_the_live_buffer": landed,
                "ticks": ticks, "bit_equal": bool(equal),
                "replays": orch._program.replays,
                "feeds": orch.actor_feeds}
        finally:
            orch.stop()
    return out


def _actors_greedy_swap(torch, prices, work: str, tag_dir: str) -> dict:
    """(d) in process: a rollout actor on the card from a seeded fresh init,
    every gate 0 (greedy wherever the ramp allows); while chunk 2 (the
    capture and the first replay) runs, the learner's ``tag_best`` is
    staged; chunk 3 replays with it. Each replayed chunk's actions against
    the argmax of a plain forward of its weights; then five more replays
    timed by CUDA events and the loop's rows per second."""
    import threading

    from sharetrade_tpu_torch.agents.qlearn import Draws, q_values
    from sharetrade_tpu_torch.checkpoint import CheckpointManager
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.data.journal import (
        iter_framed_records, segment_paths)
    from sharetrade_tpu_torch.data.transitions import decode_transitions
    from sharetrade_tpu_torch.distrib.actor import RolloutActor
    cfg = FrameworkConfig().apply_overrides([
        "learner.algo=dqn", "distrib.weight_poll_s=0",
        f"runtime.checkpoint_dir={os.path.join(work, 'own-ck')}",
        f"distrib.actor_dir={os.path.join(work, 'actors')}"])
    steps, agents = cfg.runtime.chunk_steps, cfg.parallel.num_workers
    staged: dict = {}

    def draw(ts):
        if actor.chunks == 1 and not staged:     # chunk 2 is starting
            params, meta = CheckpointManager(tag_dir).restore_tagged(
                actor._template, "best")
            staged.update(params=params, step=int(meta.get("updates", 0)))
            actor.swap_params(params, staged["step"])
        return Draws(torch.zeros((steps, agents), device="cuda"),
                     torch.randint(0, 3, (steps, agents), device="cuda",
                                   generator=ts.rng))

    actor = RolloutActor(cfg, prices, actor_id="smoke",
                         workdir=os.path.join(work, "actors", "smoke"),
                         device="cuda", draw=draw)
    fresh = actor.params
    t0 = time.perf_counter()
    summary = actor.run(threading.Event(), max_chunks=8)
    loop_s = time.perf_counter() - t0
    path = actor.journal_path
    recs = [decode_transitions(p) for part in (*segment_paths(path), path)
            for _, p in iter_framed_records(part)]
    checks = {}
    for idx, params in ((1, fresh), (2, staged["params"])):
        obs = torch.tensor(recs[idx][0], device="cuda")
        greedy = q_values(actor.model, params, obs).argmax(-1).cpu().numpy()
        other = q_values(actor.model, staged["params"] if idx == 1 else fresh,
                         obs).argmax(-1).cpu().numpy()
        checks[f"chunk{idx + 1}"] = {
            "rows": int(obs.shape[0]),
            "greedy_equal": bool((recs[idx][1] == greedy).all()),
            "other_weights_differ": int((greedy != other).sum())}
    program = actor.program
    ts = program._live
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ts, _ = program(ts)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return {"summary": summary, "tag_step": staged.get("step"),
            "checks": checks, "capture_s": program.capture_seconds,
            "graph_nodes": program.nodes,
            "replay_ms": statistics.median(times),
            "loop_s_8_chunks": loop_s,
            "rows_per_s_in_loop": summary["rows_journaled"] / loop_s}


def _actors_flywheel(fleet, out_path: str, work: str, prices,
                     problems: list) -> dict:
    """(e): journaling sessions over the wire until a response names
    weights newer than the engine booted with (the learner's republished
    ``tag_best``); then SIGTERM."""
    import signal

    from sharetrade_tpu_torch.fleet import FleetClient
    from sharetrade_tpu_torch.fleet.flywheel import (
        SessionTransitionJournal, make_journaling_sessions)
    from sharetrade_tpu_torch.config import FrameworkConfig
    window = FrameworkConfig().env.window
    ready = _event_line(fleet, out_path, "fleet_ready", 180.0)
    journal = SessionTransitionJournal(
        os.path.join(work, "feeds"), "wire0", obs_dim=window + 2,
        flush_rows=64)
    sessions = make_journaling_sessions(prices, window, FLYWHEEL_SESSIONS,
                                        journal=journal, seed=3)
    boot = [r for r in _json_lines(os.path.join(ready["dir"], "e0.log"))
            if r.get("event") == "serving_ready"][0]["params_step"]
    client = FleetClient(ready["host"], ready["port"], timeout_s=60.0)
    steps: list[int] = []
    t0 = time.monotonic()
    try:
        while time.monotonic() - t0 < 120.0:
            for s in sessions:
                reply = client.submit(s.sid, s.observation())
                s.advance(int(reply["action"]))
                steps.append(int(reply["params_step"]))
            journal.flush()
            if max(steps) > boot and len(steps) >= 20 * FLYWHEEL_SESSIONS:
                break
    finally:
        client.close()
        journal.close()
    time.sleep(1.5)                     # a learner tick past the last flush
    fleet.send_signal(signal.SIGTERM)
    rc = fleet.wait(90)
    summary = _json_lines(out_path)[-1]
    first_new = next((i for i, s in enumerate(steps) if s > boot), None)
    row = {"ready": ready, "rc": rc, "requests": len(steps),
           "engine_boot_params_step": boot,
           "rows_journaled": journal.rows_journaled,
           "params_steps_seen": sorted(set(steps)),
           "first_request_on_new_weights": first_new,
           "seconds_driven": time.monotonic() - t0, "summary": summary}
    if rc != 75 or not summary.get("preempted"):
        problems.append(f"cli fleet --learner drained with rc {rc}")
    if ready.get("learner") is not True or ready.get("engines") != 1:
        problems.append(f"fleet_ready {ready}")
    if first_new is None:
        problems.append("no served response named weights newer than the "
                        "engine's boot weights")
    if not 0 < summary.get("rows_ingested", 0) <= journal.rows_journaled:
        problems.append(f"the flywheel learner ingested "
                        f"{summary.get('rows_ingested')} of "
                        f"{journal.rows_journaled} served rows")
    if summary.get("learner_restarts") != 0:
        problems.append("the flywheel learner restarted")
    return row


def phase_actors(torch) -> dict:
    """Actors and the flywheel at the reference workload's width; see the
    module docstring."""
    import signal

    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.data.transitions import transition_stamps
    from sharetrade_tpu_torch.distrib.pool import read_status

    work = _fresh_dir("actors-")
    problems: list[str] = []
    row: dict = {"phase": "actors", "card": _nvidia_smi()}
    t_phase = time.perf_counter()
    learner_dir, fleet_dir = (os.path.join(work, "learner"),
                              os.path.join(work, "fleet"))
    pool_dir = os.path.join(learner_dir, "actors")
    ckpt_dir = os.path.join(learner_dir, "ckpt")
    events_path = os.path.join(learner_dir, "events.jsonl")
    t_spawn = time.time()
    learner, l_out, l_err = _spawn_cli(
        ["learner", "--events", events_path],
        ACTORS + [f"distrib.actor_dir={pool_dir}",
                  f"runtime.checkpoint_dir={ckpt_dir}"], learner_dir)
    fleet, f_out, f_err = _spawn_cli(
        ["fleet", "--learner"], FLYWHEEL + [
            f"fleet.dir={os.path.join(fleet_dir, 'fleet')}",
            f"distrib.actor_dir={os.path.join(fleet_dir, 'feeds')}",
            f"runtime.checkpoint_dir={os.path.join(fleet_dir, 'ckpt')}"],
        fleet_dir)
    prices = _prices(FrameworkConfig().data)
    seen_pids: set[int] = set()

    def status() -> dict:
        return read_status(pool_dir) or {}

    def actors() -> dict:
        got = status().get("actors", {})
        seen_pids.update(a["pid"] for a in got.values() if a.get("pid"))
        return got

    try:
        # (e) the flywheel first: its fleet boots beside the learner, and
        # the actors come up meanwhile.
        ready = _event_line(learner, l_out, "learner_ready", 180.0)
        row["learner_ready_s"] = time.perf_counter() - t_phase
        row["e"] = _actors_flywheel(fleet, f_out, fleet_dir, prices,
                                    problems)

        # (a) both actors rolling.
        _wait_for(lambda: len(actors()) == 2 and all(
            a["state"] == "alive" and (a.get("rows") or 0) > 0
            for a in actors().values()), 180.0, "both actors rolling")
        row["actors_rolling_s"] = time.perf_counter() - t_phase
        first, t_first = actors(), time.monotonic()
        time.sleep(2.0)
        second, t_second = actors(), time.monotonic()
        rates = {aid: (second[aid]["rows"] - first[aid]["rows"])
                 / (t_second - t_first) for aid in first}
        row["a"] = {"ready": ready, "rows_per_s": rates}
        if not all(r > 0 for r in rates.values()):
            problems.append(f"actor rows not growing: {rates}")

        # (c) the kill test; (b) runs while the pool respawns a0.
        victim = actors()["a0"]
        journal_a0 = os.path.join(pool_dir, "a0", "transitions.journal")
        high_water = max(s for s, _ in transition_stamps(journal_a0))
        os.kill(victim["pid"], signal.SIGKILL)
        injected = 1
        t_kill = time.monotonic()

        # (b) the ingest lands in the chunk graph.
        _reset_launch_counts()
        row["b"] = _actors_ingest(torch, pool_dir, prices,
                                  os.path.join(work, "ingest"))
        in_process = _all_launch_counts()
        for name, part in row["b"].items():
            if not part["bit_equal"]:
                problems.append(f"{name}: the replay after an ingest is not "
                                "bit-equal to the eager chunk")
            if part["ticks"][0]["rows"] <= 0:
                problems.append(f"{name}: the ingest tick read no rows")
            if not part["landed_in_the_live_buffer"]:
                problems.append(
                    f"{name}: the ingest did not land in the live replay "
                    f"buffer: size {part['replay_size_before']} -> "
                    f"{part['replay_size_after']}")

        _wait_for(lambda: (actors()["a0"]["pid"] not in (None, victim["pid"])
                           and actors()["a0"]["state"] == "alive"
                           and (actors()["a0"].get("rows") or 0) > 0),
                  120.0, "a0 respawned and rolling")
        respawn_s = time.monotonic() - t_kill
        # The respawn's first records reach the disk at its journal's next
        # group commit (0.5 s at most between appends).
        stamps: list[int] = []

        def past_high_water():
            stamps[:] = [s for s, _ in transition_stamps(journal_a0)]
            return stamps[-1] > high_water

        _wait_for(past_high_water, 30.0, "a0's stamps past its high-water")
        st = status()
        row["c"] = {"killed_pid": victim["pid"],
                    "respawned_pid": st["actors"]["a0"]["pid"],
                    "respawn_s": respawn_s,
                    "restarts_total": st["restarts_total"],
                    "high_water_before": high_water,
                    "high_water_after": stamps[-1],
                    "learner_pid": ready["pid"], "status_pid": st["pid"]}
        if st["restarts_total"] != injected:
            problems.append(f"restarts_total {st['restarts_total']} != "
                            f"{injected} injected")
        if learner.poll() is not None or st["pid"] != ready["pid"]:
            problems.append("the learner did not survive the actor's kill")
        if stamps != sorted(set(stamps)) or stamps[-1] <= high_water:
            problems.append("a0's stamps did not continue past its "
                            "high-water")

        # (d) weight swaps: every actor's params_step past its boot
        # weights, and the greedy check in process.
        _wait_for(lambda: all((a.get("params_step") or 0) > 0
                              for a in actors().values()
                              if a["state"] == "alive"),
                  120.0, "the actors swapping in tag_best")
        row["d"] = {"params_steps": {aid: a["params_step"]
                                     for aid, a in actors().items()},
                    "swap_seen_s": time.perf_counter() - t_phase,
                    **_actors_greedy_swap(torch, prices,
                                          os.path.join(work, "greedy"),
                                          ckpt_dir)}
        for name, check in row["d"]["checks"].items():
            if not check["greedy_equal"] or not check["other_weights_differ"]:
                problems.append(f"(d) {name}: {check}")

        # (f) a1 retired by the scale file, the learner's last ticks
        # over its drained journal, then SIGTERM drains the rest.
        with open(os.path.join(pool_dir, "scale"), "w") as f:
            f.write("1")
        _wait_for(lambda: actors()["a1"]["state"] == "retired", 60.0,
                  "a1 retired")
        # The final ingest: a learner's tick whose cursor reaches the last
        # stamp of a1's drained journal.
        a1_last = transition_stamps(os.path.join(
            pool_dir, "a1", "transitions.journal"))[-1][0]
        row["f_catch_up_s"] = _wait_for(
            lambda: any(t["feeds"].get("a1", {}).get("high_water") == a1_last
                        for t in _ingest_ticks(events_path)),
            90.0, "the learner's ingest reaching a1's drained high-water")
        learner.send_signal(signal.SIGTERM)
        rc = learner.wait(120)
        summary = _json_lines(l_out)[-1]
        final = status()
        row["f"] = {"rc": rc, "summary": summary,
                    "states": {aid: a["state"]
                               for aid, a in final["actors"].items()},
                    "learner_events": _learner_timeline(events_path,
                                                        t_spawn)}
        if rc != 75 or not summary.get("preempted"):
            problems.append(f"cli learner drained with rc {rc}")
        if (summary.get("learner_restarts") != 0
                or summary.get("actor_restarts") != injected
                or summary.get("actors_retired") != 2
                or summary.get("actors_alive") != 0
                or summary.get("rows_ingested", 0) <= 0):
            problems.append(f"cli learner's summary {summary}")
        # Tick by tick, every row each actor's journal committed up to the
        # learner's cursor: read once, or retired before the learner read
        # it (reported).
        workers = FrameworkConfig().parallel.num_workers
        ticks = _ingest_ticks(events_path)
        reconcile = {}
        for aid, feed in summary.get("actor_feeds", {}).items():
            reconcile[aid], bad = _reconcile_feed(
                [t["feeds"][aid] for t in ticks if aid in t["feeds"]],
                transition_stamps(os.path.join(pool_dir, aid,
                                               "transitions.journal")),
                feed, workers)
            problems += [f"(f) {aid}: {b}" for b in bad]
        row["f"]["reconcile"] = reconcile
        if set(reconcile) != {"a0", "a1"}:
            problems.append(f"(f) the learner's feeds: {sorted(reconcile)}")
        if reconcile.get("a1", {}).get("cursor") != \
                reconcile.get("a1", {}).get("journal_high_water"):
            problems.append("the last ingest did not reach a1's drained "
                            "high-water")
        time.sleep(0.5)
        row["f"]["actor_pids"] = sorted(seen_pids)
        survivors = [p for p in seen_pids if not _pid_gone(p)]
        if survivors:
            problems.append(f"actor pids survived the drain: {survivors}")
        learner_launches = summary.get("kernel_launches", {})
        fleet_launches = row["e"]["summary"].get("kernel_launches", {})
        # The main paths' launches: the two CLI learners' own counts.
        row["launches"] = {"fused_update": (
            learner_launches.get("fused_update", 0)
            + fleet_launches.get("fused_update", 0))}
        row["launches_by_part"] = {"learner": learner_launches,
                                   "fleet_learner": fleet_launches,
                                   "in_process_ingest": in_process}
        if not learner_launches.get("fused_update"):
            problems.append("cli learner launched no fused_update")
    except Exception as exc:    # noqa: BLE001 — reported, fails the phase
        problems.append(f"{type(exc).__name__}: {exc}")
        for name, path in (("learner", l_err), ("fleet", f_err)):
            try:
                with open(path, errors="replace") as f:
                    row[f"{name}_stderr_tail"] = f.read()[-3000:]
            except OSError:
                pass
    finally:
        for proc in (learner, fleet):
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
        for pid in seen_pids:
            if not _pid_gone(pid):
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
    row.setdefault("launches", {})
    row["seconds"] = time.perf_counter() - t_phase
    row["problems"] = problems
    return row


#: The obs phase. (a) ``cli train`` with ``obs.enabled`` on the flagship
#: (``OBS_TRAIN``: every chunk read back, no cadence checkpoint) over a
#: series of ``OBS_CHUNKS`` chunks; (b) the same config in this process from
#: one seeded state, obs off, on, on, off (``OBS_TURNS``), each run an
#: episode of ``OBS_TURN_CHUNKS`` chunks (the eager first chunk and the
#: capture) and then a second episode of replays only, the first off and
#: the first on turn's under ``torch.profiler`` (its parse of a graph's
#: ~74,000 kernels a replay takes seconds, so the later turns run
#: unprofiled and give the replay times); (c) the
#: flagship served with obs on and off in turns at ``SLO_SESSIONS``, then an
#: open-loop overload (``OBS_OVERLOAD``); (e) a supervised restart of the
#: reference workload with obs on.
OBS_CHUNKS = 4
OBS_TURN_CHUNKS = 2
OBS_TURNS = (False, True, True, False)
OBS_TRAIN = FLAGSHIP_TRAIN + ["runtime.metrics_every_chunks=1",
                              "runtime.checkpoint_every_updates=0"]
OBS_SERVE = {"max_queue": 256, "shed_policy": "oldest",
             "stats_interval_s": 0.5}
OBS_LOOP_S = 2.0
OBS_OVERLOAD_SESSIONS = 320
OBS_OVERLOAD_QUEUE = 64
OBS_OVERLOAD_S = 1.0
OBS_FAULT_CHUNK = 1
#: CUDA runtime calls that wait for the device, counted from
#: ``torch.profiler``'s CUDA API events; device-to-host copies are its
#: ``Memcpy DtoH`` device events.
_SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize",
               "cudaDeviceSynchronize", "cudaMemcpy")


def _obs_series(chunks: int) -> str:
    return f"data.synthetic_length={chunks * 1024 + 201}"


def _trace_events(run_dir: str) -> list[dict]:
    from sharetrade_tpu_torch.obs import read_trace
    return read_trace(os.path.join(run_dir, "trace.jsonl"))


def _obs_cli_train(torch, problems: list) -> dict:
    """(a): ``cli train`` with obs on, and ``cli obs --dir`` on its run."""
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.obs import parse_prom_text
    from sharetrade_tpu_torch.obs.manifest import config_hash

    work = _fresh_dir("obs-train-")
    obs_dir = os.path.join(work, "obs")
    sets = OBS_TRAIN + [_obs_series(OBS_CHUNKS), "obs.enabled=true",
                        f"obs.dir={obs_dir}",
                        f"runtime.checkpoint_dir={os.path.join(work, 'ck')}"]
    cmd = [sys.executable, "-m", "sharetrade_tpu_torch.cli", "train"]
    for item in sets:
        cmd += ["--set", item]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          cwd=work, env=_cli_env())
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    summary = json.loads(lines[-1]) if lines else {}
    row = {"rc": proc.returncode, "seconds": time.perf_counter() - t0,
           "summary": summary}
    if proc.returncode != 0 or summary.get("env_steps") != OBS_CHUNKS * 1024:
        problems.append("(a) cli train with obs did not complete its "
                        f"{OBS_CHUNKS} chunks")
        row["stderr_tail"] = proc.stderr[-2000:]
        return row
    events = _trace_events(obs_dir)
    chunks = {name: sorted(e["args"]["chunk"] for e in events
                           if e["name"] == name and e["ph"] == "X")
              for name in ("dispatch", "readback", "host_process")}
    row["span_chunks"] = chunks
    if any(c != list(range(OBS_CHUNKS)) for c in chunks.values()):
        problems.append("(a) a chunk lacks its dispatch / readback / "
                        "host_process span")
    with open(os.path.join(obs_dir, "manifest.json")) as f:
        manifest = json.load(f)
    want_hash = config_hash(FrameworkConfig().apply_overrides(sets))
    row["manifest"] = {k: manifest.get(k) for k in (
        "config_hash", "backend", "device_count", "device_name",
        "torch_version")}
    if (manifest.get("device_name") != torch.cuda.get_device_name(0)
            or manifest.get("backend") != "cuda"
            or manifest.get("config_hash") != want_hash):
        problems.append("(a) manifest.json does not name the card and the "
                        "config's hash")
    with open(os.path.join(obs_dir, "metrics.prom")) as f:
        prom = parse_prom_text(f.read())
    seconds = prom["histograms"].get("sharetrade_train_chunk_seconds", {})
    row["train_chunk_seconds_count"] = seconds.get("count")
    if seconds.get("count") != OBS_CHUNKS:
        problems.append("(a) train_chunk_seconds does not count the chunks")
    shown = subprocess.run(
        [sys.executable, "-m", "sharetrade_tpu_torch.cli", "obs", "--dir",
         obs_dir], capture_output=True, text=True, timeout=120, cwd=work,
        env={**_cli_env(), "CUDA_VISIBLE_DEVICES": ""})
    sections = (sorted(json.loads(shown.stdout)) if shown.returncode == 0
                else [])
    row["cli_obs_sections"] = sections
    if not {"manifest", "trace", "metrics"} <= set(sections):
        problems.append("(a) cli obs --dir lacks the manifest, trace or "
                        "metrics section")
    launches = summary.get("kernel_launches", {})
    row["launches_per_chunk"] = {k: launches.get(k, 0) / OBS_CHUNKS
                                 for k in KERNELS}
    return row


def _profile_counts(prof) -> dict:
    syncs = d2h = 0
    for ev in prof.key_averages():
        if ev.key in _SYNC_CALLS:
            syncs += ev.count
        elif ev.key.startswith("Memcpy DtoH"):
            d2h += ev.count
    return {"syncs": syncs, "d2h_copies": d2h}


def _obs_turn(torch, obs_on: bool, profiled: bool, prices,
              work: str) -> dict:
    """One turn of (b): an episode from the seeded state (eager first
    chunk, capture, replays), then an episode of replays, each dispatch
    bracketed by CUDA events, under ``torch.profiler`` when
    ``profiled``."""
    from torch.profiler import ProfilerActivity, profile

    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.models.core import tree_leaves
    from sharetrade_tpu_torch.runtime import Orchestrator

    import tempfile
    turn_dir = tempfile.mkdtemp(prefix="turn-", dir=work)
    sets = OBS_TRAIN + [_obs_series(OBS_TURN_CHUNKS),
                        f"runtime.checkpoint_dir={turn_dir}/ck"]
    if obs_on:
        sets += ["obs.enabled=true", f"obs.dir={turn_dir}/obs"]
    cfg = FrameworkConfig().apply_overrides(sets)
    orch = Orchestrator(cfg, device="cuda")
    try:
        orch.send_training_data(prices)
        orch.start_training(background=False)
        marks: list = []
        dispatch = orch._dispatch

        def timed(k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = dispatch(k)
            end.record()
            marks.append((start, end))
            return out

        orch._dispatch = timed
        torch.cuda.synchronize()
        before = _all_launch_counts()
        t_prof = time.perf_counter()
        with (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
              if profiled else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            orch.start_training(background=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        after = _all_launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        done = orch.is_everything_done().state.name
        counts = _profile_counts(prof) if profiled else None
        profiler_s = time.perf_counter() - t_prof - wall
        chunk_ms = [a.elapsed_time(b) for a, b in marks]
        params = [t.detach().clone() for t in tree_leaves(
            orch.train_state.params)]
        nodes = orch._program.nodes
    finally:
        orch.stop()
    chunks = len(marks)
    return {"obs": obs_on, "profiled": profiled, "done": done,
            "replays": chunks, "replay_chunk_ms": chunk_ms,
            "agent_steps_per_s": (cfg.parallel.num_workers
                                  * cfg.runtime.chunk_steps * chunks / wall),
            "episode_wall_s": wall, "profiler_s": profiler_s,
            "graph_nodes": nodes,
            "launches_per_chunk": {k: v / max(chunks, 1)
                                   for k, v in launches.items()},
            "per_chunk": ({k: v / max(chunks, 1) for k, v in counts.items()}
                          if counts else None),
            "counts": counts, "_params": params}


def _obs_turns(torch, problems: list) -> dict:
    """(b): obs off, on, on, off from one seeded state."""
    from sharetrade_tpu_torch.config import FrameworkConfig

    work = _fresh_dir("obs-turns-")
    prices = _prices(FrameworkConfig().apply_overrides(
        OBS_TRAIN + [_obs_series(OBS_TURN_CHUNKS)]).data)
    turns = [_obs_turn(torch, on, i < 2, prices, work)
             for i, on in enumerate(OBS_TURNS)]
    torch.cuda.empty_cache()
    ref = turns[0]["_params"]
    for t in turns:
        params = t.pop("_params")
        t["params_bit_equal_to_first_off"] = all(
            torch.equal(a, b) for a, b in zip(params, ref))
    off = [t for t in turns if not t["obs"]]
    on = [t for t in turns if t["obs"]]
    profiled = [t for t in turns if t["profiled"]]
    row = {"turns": turns}
    if not all(t["done"] == "COMPLETED" and t["replays"] == OBS_TURN_CHUNKS
               for t in turns):
        problems.append("(b) a turn did not replay its episode")
    if not all(t["params_bit_equal_to_first_off"] for t in turns):
        problems.append("(b) final parameters differ between obs on and off")
    if (sorted(t["obs"] for t in profiled) != [False, True]
            or len({json.dumps(t["per_chunk"], sort_keys=True)
                    for t in profiled}) != 1):
        problems.append("(b) device syncs or device-to-host copies per chunk "
                        "differ with obs on")
    if off[0]["counts"]["syncs"] <= 0 or off[0]["counts"]["d2h_copies"] <= 0:
        problems.append("(b) the profiler saw no sync or no device-to-host "
                        "copy (the count would prove nothing)")
    if len({json.dumps(t["launches_per_chunk"], sort_keys=True)
            for t in turns}) != 1 or len({t["graph_nodes"]
                                          for t in turns}) != 1:
        problems.append("(b) kernel launches per chunk or graph nodes "
                        "differ with obs on")
    # The unprofiled turns' replays: what the chunk costs with obs on / off.
    row["median_replay_ms"] = {
        "off": statistics.median(ms for t in off if not t["profiled"]
                                 for ms in t["replay_chunk_ms"]),
        "on": statistics.median(ms for t in on if not t["profiled"]
                                for ms in t["replay_chunk_ms"])}
    row["agent_steps_per_s"] = {
        "off": [t["agent_steps_per_s"] for t in off],
        "on": [t["agent_steps_per_s"] for t in on]}
    return row


def _obs_serve(torch, problems: list) -> dict:
    """(c): the flagship served with obs off, on, on, off at 192 sessions
    in closed loop, then an open-loop overload on the obs-on engine."""
    import dataclasses

    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.env.trading import obs_dim
    from sharetrade_tpu_torch.models import build_model
    from sharetrade_tpu_torch.obs import build_obs
    from sharetrade_tpu_torch.precision import policy_from_config
    from sharetrade_tpu_torch.serve import ServeEngine
    from sharetrade_tpu_torch.serve.driver import (
        make_sessions, run_closed_loop, run_open_loop)
    from sharetrade_tpu_torch.utils.metrics import MetricsRegistry

    work = _fresh_dir("obs-serve-")
    cfg = FrameworkConfig().apply_overrides(FLAGSHIP + [
        "obs.enabled=true", f"obs.dir={work}/obs",
        "obs.export_interval_s=1.0"])
    serve_cfg = dataclasses.replace(cfg.serve, **OBS_SERVE)
    model = build_model(cfg.model, obs_dim(cfg.env.window), device="cuda")
    params = model.init(torch.Generator().manual_seed(cfg.seed))
    policy = policy_from_config(cfg.precision)
    prices = _prices(cfg.data)
    engines = {}
    for on in (False, True):
        registry = MetricsRegistry()
        obs = build_obs(cfg, registry, device="cuda") if on else None
        engine = ServeEngine(model, serve_cfg, params, precision=policy,
                             registry=registry, obs=obs, obs_cfg=cfg.obs)
        engine.warmup()
        engines[on] = (engine, registry, obs)
    loops = []
    try:
        for i, on in enumerate(OBS_TURNS):
            engine = engines[on][0]
            stats = run_closed_loop(engine, make_sessions(
                prices, cfg.env.window, SLO_SESSIONS, seed=10 + i,
                prefix=f"t{i}-"), concurrency=SLO_SESSIONS,
                duration_s=OBS_LOOP_S)
            loops.append({"obs": on, **{k: stats.get(k) for k in (
                "qps", "p50_ms", "p99_ms", "completed", "failed")}})
        engine, registry, obs = engines[True]
        # 320 sessions in flight over a live bound of 64 (set_knobs lowers
        # it below config): the oldest are shed.
        engine.set_knobs(max_queue=OBS_OVERLOAD_QUEUE)
        overload = run_open_loop(engine, make_sessions(
            prices, cfg.env.window, OBS_OVERLOAD_SESSIONS, seed=20,
            prefix="ov-"), rate_qps=4.0 * max(lp["qps"] for lp in loops),
            duration_s=OBS_OVERLOAD_S)
    finally:
        for engine, _, _ in engines.values():
            engine.stop(timeout_s=30.0)
    obs.close()
    counters = registry.counters()
    events = _trace_events(obs.run_dir)
    envelopes: dict = {}
    children: dict = {}
    for e in events:
        rid = e.get("args", {}).get("request")
        if rid is None:
            continue
        if e["name"] == "serve_request":
            envelopes[rid] = e
        else:
            children.setdefault(rid, []).append(e)
    outcomes: dict = {}
    for e in envelopes.values():
        outcome = e["args"]["outcome"]
        outcomes[outcome] = outcomes.get(outcome, 0) + 1
    escaped = sum(
        1 for rid, kids in children.items() for c in kids
        if rid not in envelopes or c["ts"] < envelopes[rid]["ts"] - 0.002
        or c["ts"] + c["dur"] > envelopes[rid]["ts"] + envelopes[rid]["dur"]
        + 0.002)
    nested = sum(1 for e in envelopes.values()
                 if e["args"]["outcome"] == "completed"
                 and len(children.get(e["args"]["request"], [])) == 4)
    row = {"loops": loops, "overload": overload,
           "requests": engine.counters["requests"],
           "traced_requests": len(envelopes), "outcomes": outcomes,
           "completed_with_four_stages": nested,
           "children_outside_envelope": escaped,
           "decomposition_errors": counters.get(
               "serve_trace_decomposition_error_total", 0),
           "shed": counters.get("serve_shed_total", 0),
           "exemplars_file": os.path.isfile(
               os.path.join(obs.run_dir, "serve_exemplars.json"))}
    on = [lp for lp in loops if lp["obs"]]
    off = [lp for lp in loops if not lp["obs"]]
    row["qps"] = {"off": [lp["qps"] for lp in off],
                  "on": [lp["qps"] for lp in on]}
    row["p99_ms"] = {"off": [lp["p99_ms"] for lp in off],
                     "on": [lp["p99_ms"] for lp in on]}
    if not row["exemplars_file"]:
        problems.append("(c) serve_exemplars.json was not written")
    if row["decomposition_errors"] != 0:
        problems.append("(c) serve_trace_decomposition_error_total != 0")
    if (row["traced_requests"] != row["requests"]
            or outcomes.get("shed_oldest", 0) != row["shed"]
            or row["shed"] <= 0):
        problems.append("(c) not every terminal outcome was traced (or the "
                        "overload shed nothing)")
    if escaped or nested != outcomes.get("completed", -1):
        problems.append("(c) serve_request spans do not nest their stages")
    return row


def _obs_fault(torch, problems: list) -> dict:
    """(e): a fault at chunk ``OBS_FAULT_CHUNK`` through the fault hook of
    an obs run of the reference workload: one supervised restart, and the
    flight bundle names the supervision and the failing chunk."""
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.runtime import Orchestrator

    work = _fresh_dir("obs-fault-")
    cfg = FrameworkConfig().apply_overrides([
        "data.synthetic_length=803", "obs.enabled=true",
        f"obs.dir={work}/obs", f"runtime.checkpoint_dir={work}/ck",
        "runtime.backoff_initial_s=0.01", "runtime.backoff_max_s=0.02"])
    fired: list = []

    def hook(chunk_idx, row):
        if chunk_idx == OBS_FAULT_CHUNK and not fired:
            fired.append(chunk_idx)
            raise RuntimeError("chip_smoke: injected fault")

    orch = Orchestrator(cfg, device="cuda", fault_hook=hook)
    try:
        orch.send_training_data(_prices(cfg.data))
        orch.start_training(background=False)
        done = orch.is_everything_done().state.name
        restarts = orch.restarts
    finally:
        orch.stop()
    with open(os.path.join(work, "obs", "flight_recorder.json")) as f:
        bundle = json.load(f)
    row = {"done": done, "restarts": restarts,
           "reason": bundle.get("reason"),
           "failing_chunk": bundle.get("failing_chunk"),
           "events": len(bundle.get("events", []))}
    if (row["reason"] != "supervision"
            or row["failing_chunk"] != OBS_FAULT_CHUNK or restarts != 1
            or done != "COMPLETED"):
        problems.append("(e) the supervision fault left no bundle naming "
                        "the supervision and the failing chunk")
    return row


def phase_obs(torch) -> dict:
    """Telemetry on the card; see the module docstring."""
    problems: list = []
    row: dict = {"phase": "obs", "config": OBS_TRAIN}
    t_phase = time.perf_counter()
    # The counted window: counts reset just before, read just after; `cli
    # train` counts in its own process (its summary's counts are added).
    _reset_launch_counts()
    by_part: dict = {}
    for name, part in (("train_cli", _obs_cli_train), ("turns", _obs_turns),
                       ("serve", _obs_serve), ("fault", _obs_fault)):
        before = _all_launch_counts()
        t0 = time.perf_counter()
        part_row = part(torch, problems)
        part_row["seconds"] = time.perf_counter() - t0
        after = _all_launch_counts()
        by_part[name] = {k: after[k] - before[k] for k in KERNELS}
        row[name] = part_row
    by_part["train_cli"] = {k: row["train_cli"].get("summary", {}).get(
        "kernel_launches", {}).get(k, 0) for k in KERNELS}
    row["launches_by_part"] = by_part
    row["launches"] = {k: sum(p[k] for p in by_part.values())
                       for k in KERNELS}
    per_chunk = row["train_cli"].get("launches_per_chunk")
    first_off = row["turns"]["turns"][0]["launches_per_chunk"]
    if per_chunk != {k: first_off.get(k, 0) for k in KERNELS}:
        problems.append("(a) cli train's launches per chunk with obs differ "
                        "from the obs-off run's")
    row["seconds"] = time.perf_counter() - t_phase
    row["problems"] = problems
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma list of {PHASES + EXTRA_PHASES} "
                             f"(default: {','.join(PHASES)})")
    args = parser.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES) - set(EXTRA_PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script measures the "
              "port on a GPU and has nothing to run without one",
              file=sys.stderr)
        return 1
    import sharetrade_tpu_torch  # noqa: F401 — fails outside a checkout

    import shutil
    import tempfile
    global _SCRATCH
    _SCRATCH = tempfile.mkdtemp(prefix="chip-smoke-")
    try:
        return _run_phases(torch, phases)
    finally:
        shutil.rmtree(_SCRATCH, ignore_errors=True)


def _run_phases(torch, phases: list[str]) -> int:
    print(_nvidia_smi(), flush=True)
    # Full float32 matrix products for every f32 comparison (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results: dict = {}
    seconds: dict = {}

    def _timed(name, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[name] = time.perf_counter() - t0

    if "build" in phases:
        _print(_timed("build", phase_build))
    if "kernels" in phases:
        results["kernels"] = _timed("kernels", phase_kernels, torch)
        for row in results["kernels"]:
            _print(row)
        bad = [f"{r['kernel']}:{r['case']}" for r in results["kernels"]
               if not r["ok"]]
        if bad:
            print(f"chip_smoke: kernels disagree with their plain versions "
                  f"in {bad}", file=sys.stderr)
            return 1
    if "train" in phases:
        results["train"] = _timed("train", phase_train, torch)
        _print(results["train"])
        if results["train"]["problems"]:
            print(f"chip_smoke: training path failed: "
                  f"{results['train']['problems']}", file=sys.stderr)
            return 1
    if "serve" in phases:
        results["serve"] = _timed("serve", phase_serve, torch)
        _print(results["serve"])
        if results["serve"]["problems"]:
            print(f"chip_smoke: serving path failed: "
                  f"{results['serve']['problems']}", file=sys.stderr)
            return 1
    if "serve_tiers" in phases:
        results["serve_tiers"] = _timed("serve_tiers", phase_serve_tiers, torch)
        _print(results["serve_tiers"])
        if results["serve_tiers"]["problems"]:
            print(f"chip_smoke: the serving tiers failed: "
                  f"{results['serve_tiers']['problems']}", file=sys.stderr)
            return 1
    if "serve_slo" in phases:
        results["serve_slo"] = _timed("serve_slo", phase_serve_slo, torch)
        _print(results["serve_slo"])
        if results["serve_slo"]["problems"]:
            print(f"chip_smoke: serving's telemetry and control loop "
                  f"failed: {results['serve_slo']['problems']}",
                  file=sys.stderr)
            return 1
    if "cli" in phases:
        row = _timed("cli", phase_cli)
        _print(row)
        if not row["ok"]:
            print("chip_smoke: cli serve failed", file=sys.stderr)
            return 1
    if "cli_train" in phases:
        row = _timed("cli_train", phase_cli_train)
        _print(row)
        if not row["ok"]:
            print("chip_smoke: cli train failed", file=sys.stderr)
            return 1
    if "resilience" in phases:
        results["resilience"] = _timed("resilience", phase_resilience, torch)
        _print(results["resilience"])
        if results["resilience"]["problems"]:
            print(f"chip_smoke: resilience failed: "
                  f"{results['resilience']['problems']}", file=sys.stderr)
            return 1
    if "reference" in phases:
        results["reference"] = _timed("reference", phase_reference, torch)
        _print(results["reference"])
        if results["reference"]["problems"]:
            print(f"chip_smoke: reference workload failed: "
                  f"{results['reference']['problems']}", file=sys.stderr)
            return 1
    if "pipeline" in phases:
        results["pipeline"] = _timed("pipeline", phase_pipeline, torch)
        _print(results["pipeline"])
        if results["pipeline"]["problems"]:
            print(f"chip_smoke: the chunk program / hot loop failed: "
                  f"{results['pipeline']['problems']}", file=sys.stderr)
            return 1
    if "journal" in phases:
        results["journal"] = _timed("journal", phase_journal, torch)
        _print(results["journal"])
        if results["journal"]["problems"]:
            print(f"chip_smoke: the journaled DQN path failed: "
                  f"{results['journal']['problems']}", file=sys.stderr)
            return 1
    if "cli_defaults" in phases:
        row = _timed("cli_defaults", phase_cli_defaults)
        _print(row)
        if not row["ok"]:
            print("chip_smoke: cli train / serve at the defaults failed",
                  file=sys.stderr)
            return 1
    if "families" in phases:
        results["families"] = _timed("families", phase_families, torch)
        _print(results["families"])
        if results["families"]["problems"]:
            print(f"chip_smoke: the policy families failed: "
                  f"{results['families']['problems']}", file=sys.stderr)
            return 1
    if "fleet" in phases:
        results["fleet"] = _timed("fleet", phase_fleet, torch)
        _print(results["fleet"])
        if results["fleet"]["problems"]:
            print(f"chip_smoke: the serving fleet failed: "
                  f"{results['fleet']['problems']}", file=sys.stderr)
            return 1
    if "remat_moe" in phases:
        results["remat_moe"] = _timed("remat_moe", phase_remat_moe, torch)
        _print(results["remat_moe"])
        if results["remat_moe"]["problems"]:
            print(f"chip_smoke: the episode MoE / remat paths failed: "
                  f"{results['remat_moe']['problems']}", file=sys.stderr)
            return 1
    if "actors" in phases:
        results["actors"] = _timed("actors", phase_actors, torch)
        _print(results["actors"])
        if results["actors"]["problems"]:
            print(f"chip_smoke: actors and the flywheel failed: "
                  f"{results['actors']['problems']}", file=sys.stderr)
            return 1
    if "obs" in phases:
        results["obs"] = _timed("obs", phase_obs, torch)
        _print(results["obs"])
        if results["obs"]["problems"]:
            print(f"chip_smoke: telemetry failed: "
                  f"{results['obs']['problems']}", file=sys.stderr)
            return 1
    if "profile" in phases:
        _print(phase_profile(torch))
    _print({"phase_seconds": seconds})
    if "kernels" in phases and {"serve", "serve_tiers", "serve_slo", "train",
                                "resilience", "reference", "pipeline",
                                "journal", "families", "fleet",
                                "remat_moe", "actors", "obs"} & set(phases):
        _print(kernels_line(results))
    _print({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
