#!/usr/bin/env python3
"""GPU smoke run of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--profile | --mesh-only | --token-sum-only |
                           --conv-pool-only]

Needs one NVIDIA GPU with the CUDA toolkit's ``nvcc``; fails at once
without CUDA (there is no CPU path here). It

  1. names the card (``nvidia-smi`` name and power limit) and the
     toolchain;
  2. builds the thirteen hand-written ``sm_90a`` kernels (seven sources)
     from ``src/repro_torch/kernels/csrc/``;
  3. holds every kernel against its plain PyTorch version on the card —
     f32 and bf16, ragged sizes and every leaf shape the driven paths
     hand it (the paper's MLP with 10 and with 1024 users, the full-width
     CNN with 10; the AirComp and robust merges with 2 and with 64 rows),
     including the masked non-finite row and the all-zero-weight merge,
     and the AirComp and robust merges' bit-level contracts with the
     plain merge; the server step of the objectives layer in its three
     kinds (identity, FedAvgM, FedAdam) with its passthrough contracts,
     FedAvgM bit-equal to ``optim.sgd_momentum_update``;
     the merges' shared row walk where its vector path splits (gather,
     FedAvg, AirComp with a noise plane, and robust; ragged and skewed
     operands, K = 1, 5, 9, 10, 17, 65 around its groups of rows in
     flight, a NaN row at zero weight, all-zero weights, winner ids against positions, FedAvg with
     1024 rows of which 2 are live, a K past the shared-memory limit
     refused) bit for bit; the multi-leaf SGD step on lists of aligned
     and unaligned leaves, more than one launch's worth included; the
     leaf-list Eq. 2 reduction and server step (one launch for every
     leaf) on the MLP's and the CNN's leaf lists at 10 and 1024 users, a
     ragged list with skewed operands and a 40-leaf list (two launches),
     the reduction bit-identical run to run and the server step bit-equal
     in every kind; the SGD step and the Eq. 2 reduction on the MLP's and
     the CNN's leaf lists at the stacked, ragged and partial-cohort
     widths U = 1, 2 and 64, and the gather, AirComp (no ``idx``) and
     robust merges over (m, ...) stacks of every leaf whose every row is
     a winner, m = 1, 2, 64; the
     three contention passes bit for bit at every (B, M) pool
     shape the contention loop runs on, with forced expiry ties, dead
     lanes and rows with no live lane; the LLM local step's fixed-order
     token sum at every (rows, tokens, columns) shape the --arch paths
     give it, and ragged ones, bit for bit, each row alone = the stack —
     and times kernel, plain version
     and, where one exists, the single PyTorch library call (eager and
     from a CUDA graph, like the kernel) — the merges at K = 64 in f32 and
     bf16, a whole MLP SGD step against ``torch._foreach_add_`` and the
     CNN's permuted-gradient copy; the Eq. 2 reduction and the server
     step as whole-model calls and on the fc1.w leaf alone, at 10 and
     1024 users, f32 and bf16, and the server step on a 16 M-element
     leaf; the persistent contention loop at the engine's pools;
  4. drives the port's main path through its normal entry points:
     ``launch.train.build_paper_engine`` with the paper's defaults (MLP
     784x200x10, 10 users, 2 winners a round, ``priority-distributed``)
     for 20 rounds, the full-width CNN for 3 rounds, and after each the
     ``core.server`` merges and the backend's own merge on a freshly
     trained stack, held against the plain version; the MLP cell through
     ``FLEngine.run`` (on the fused path the E = 1 case of the sweep loop
     below) and through the per-round loop (``FLEngine.run_round``), in
     turns, each with its launches predicted; then device CSMA
     contention (``--contention-backend device``): the persistent loop
     kernel (one launch a pool attempt) against the plain Python loop
     with the same counter draws — every field and per-row events, the
     retry ladder past the shared-memory limit included — and against
     the ``device="cpu"`` run, the loop with the three pass kernels, the
     dense 1e4-1e6-contender regime of ``benchmarks/contention_bench.py``
     through ``CSMASimulator(backend="device")`` (against numpy at 1e4),
     the paper's MLP cell for 20 rounds and the MLP with 1000 users and
     64 winners a round; then the channel and fault layers on the MLP
     cell, 20 rounds each: the AirComp merge under Rayleigh fading and
     receiver noise, ``channel-distributed`` selection under a lossy
     waterfall PER, the robust merge under the active fault spec of
     ``benchmarks/faults_bench.py``, and that fault spec at 1000 users
     and 64 winners with device contention for 3 rounds; then the
     objectives layer on the MLP cell, 20 rounds each: FedDyn + FedAvgM
     under the lossy channel (rounds with attempts and no deliveries
     still update h) and FedProx + FedAdam, and FedDyn + FedAvgM at
     1000 users for 3 rounds; the AirComp, fault and objective forms of
     the fused merge through the per-round loop, 10 rounds each; then
     the per-round fallback paths on the
     MLP cell: ``--round-mode stacked`` for 20 rounds,
     ``random-centralized`` (partial-cohort rounds: only the two winners
     train, as one stack) for 20, the same at 1000 users and 64 winners
     for 3, and an uneven cohort (odd users 40 examples short, so nothing
     stacks: every user trains on its own) for 10; then the winner-sparse
     round path, which the factory picks for the 1000-user, 64-winner
     cell without ``--round-mode``: its exact prepass in turns with the
     fused route (winners equal, priorities, losses and globals within
     rtol 1e-5, launches a round predicted exactly, the device's idle
     share of each), its stale priorities, 10 000 users on the stale,
     prepass and fused routes in turns, and the fault, AirComp and
     FedDyn + FedAvgM layers on the sparse route against their fused
     twins, 3 rounds each; then the sweep path
     (``FLEngine.run_sweep``; ``FLEngine.run`` on the fused path above is
     its E = 1 case): the Fig. 3 grid (the four paper strategies x seeds 0
     and 1, 8 lanes, 20 rounds) against the 8 sequential runs of its
     cells and against itself with its overlap off, and 4 seeds of the
     1000-user cell, with device contention on the fused route and with
     numpy contention on the sparse one, against their 4 sequential runs,
     in turns, each with its launches a round predicted exactly; the layers as sweep lanes (five objectives
     and a plain lane under the lossy channel, AirComp at three SNR
     points, the active faults over three seeds); checkpoint / resume
     (``tools/kill_resume_smoke_torch.py`` on the card, a checkpointed
     fused, stacked and stale winner-sparse run of the MLP cell resumed
     by fresh engines); then the cohort split (``HostBackend(mesh=...)``
     over a ``cohort_mesh`` of ``cuda:0`` D times, the chunks run in
     turn): the MLP cell on a 1-device and a 2-way mesh, the 1000-user
     cell fused and winner-sparse 4-way, the Fig. 3 sweep 2-way over its
     lanes and a 3-lane sweep 2-way over its users, each bit-equal to
     the unsplit run in turns, launches predicted exactly (with more than
     one card visible, the 1000-user cells and the Fig. 3 sweep also
     split over every card, chunk i on ``cuda:i``); then the LLM
     stack: the SGD step, Eq. 2 and the
     gather merge on the reduced yi-9b, gemma2-27b, deepseek-v3 (56
     leaves: two launches of each leaf-list kernel), kimi-k2, mamba2-370m
     and hymba-1.5b leaf tables at 10 users, f32 and bf16 (each row's
     Eq. 2 bits the same alone as in the stack), the federated finetune
     of each through
     ``launch.train.main(["--arch", ...])`` for 5 rounds (10 users, k =
     2, 32 sequences of 128 tokens a user) against the same run on the
     CPU, its launches a round held to PERF.md's prediction, a steady
     round, peak memory (and its parts: what was held, the engine, one
     local step, one evaluation) and the idle share, the cell with
     ``cfg.remat`` off and on in turns (2 rounds a fresh engine: peaks,
     round seconds, the same bits; for yi-9b and mamba2 the local step
     aten op by aten op at the sweep's width with ``remat`` on), and yi-9b,
     deepseek-v3, mamba2-370m and hymba-1.5b as 3-lane sweeps whose lane
     0 must be the run bit for bit (the first local step at 10 and at 30
     rows compared aten op by aten op: no op's bits may follow the row
     count); the token sums' routes (the kernel, its plain tree, torch's
     own sum) in turns on the six cells and at phi3-mini's published
     widths (``silo_round_full``'s cell), the kernel's losses and
     priorities the tree's bits;
     ``launch.serve`` for the nine dense, vlm, moe, ssm and hybrid archs
     and the audio one (decode against ``forward`` within 1e-3, whisper's
     prefill only: see ``WHISPER_REDUCED``; hymba's 80-token prompt
     past its 64-token window, and its long-context variant through a
     64-entry ring cache that wraps); deepseek-v3 at its published
     widths (4 layers, MTP kept, 26.7 B params in bf16): prefill and
     decode timed against their bounds, the dropped share of its routing,
     and decode against ``forward`` with nothing dropped, row by row
     where the two routed alike; and
     yi-9b at its published dims in bf16, its 8.8 B params drawn on the
     card: 4 prompts of 512 tokens prefilled, 16 greedy tokens, every
     step's logits against ``forward``'s within the bar PERF.md states,
     prefill and decode timed against their bounds; then the SGD step,
     Eq. 2 and the gather merge on its full-width leaves at U = 2, one
     at a time (the 4.3 G-element ``w_gate`` stack, past 2^31, included;
     the Eq. 2 sums also against their f64 values); mamba2-370m (48
     layers) and hymba-1.5b (32) at their published widths and depth in
     bf16: the same prompts through the chunked SSD prefill and the
     single-step recurrence, decode against ``forward`` within the bars
     of ``SSM_FULL``, prefill and decode against their bounds;
     whisper-small (``launch.serve`` reduced: the prefill against
     ``forward``, every decode step against the same decode on the CPU)
     and at its published dims in bf16 (4 x 1500 frames through the
     encoder, 64-token prompts, 16 tokens: the prefill against
     ``forward``, the decode against the f32 decode of the same weights,
     encoder, prefill and decode timed against their bounds); then the
     cross-silo path: ``SiloBackend`` through ``FLEngine.run`` (the
     reduced phi3-mini, 4 silos, 6 rounds) against the same run on the
     CPU, its launches a round predicted exactly, and a bf16 merge
     against the f32 one; then at phi3-mini's published widths, 2 layers,
     bf16, 4 silos x 4 x 1024 tokens: every round's Eq. 2 against the
     plain version and every merge against the plain formula, launches
     a round exact, round ms, idle share and peak beside their bounds,
     and the memory levers off, as published (``remat``) and with
     ``flash_chunk_remat`` too, fresh engines in turns: peaks and round
     ms, losses, priorities, winners and globals bit-equal; ``token_sum``
     at every shape the ``--arch`` rounds and that cell launched it with
     (``TOKEN_SUM_CENSUS`` exactly), against ``torch.sum`` and its byte
     bound; the dry run
     (``launch/dryrun.py``, counted on the meta device) against the card:
     parameter bytes of phi3-mini at 2 layers and yi-9b exactly, and the
     counted FLOPs of the silo local step and of yi-9b's prefill against
     the bounds' operation counts —
     with the launch counts set to zero just before each path and read
     just after;
  5. checks the result by the repository's own means: the pinned
     winners of ``tests/winner_pins.json`` (``tools/check_winner_pins_torch.py
     --device cuda``: 50 lanes, twins bit-equal), the card against the CPU run
     of the same rounds (channel, AirComp with and without receiver
     noise, fault and active-objective lanes included, and the stacked,
     ragged and ``random-centralized`` lanes, seeds 0 and 1, the stacked
     one also with the lossy channel, the faults and noisy AirComp; the
     winner-sparse pin sweeps — plain, channel-off, faults-off and the
     inert objective, whose lanes also equal the pins — and a stale
     sparse lane; the noisy AirComp
     lane also through the default counter-based noise draw on each
     side; a 4-strategy sweep over seeds 0 and 1, whose lanes also equal
     the pins; the fused lanes through the per-round loop, whose winners
     also equal ``run``'s; and the layer sweeps), the sweep lanes against their
     sequential runs on the card (winners equal, losses and priorities
     within rtol 1e-5), every resumed run bit-equal to the uninterrupted
     one, inert
     objectives bit-equal to the plain run on the card,
     run-to-run bit-equality on the card (a noisy AirComp run and a
     FedAdam run included),
     a finite global in every round of the fault and objective paths,
     and the
     contention invariants and numpy parity of
     ``tests/test_contention_device.py``.

``--mesh-only`` builds the kernels and runs the cohort split's phase
alone, then ends with ``{"ok": true, "mesh_only": true, ...}``: run it
on a machine with several cards to drive the split across them.

``--token-sum-only`` builds ``token_sum`` alone, holds it against its
plain version (``check_token_sum``) and times every shape of
``TOKEN_SUM_CENSUS`` against ``torch.sum`` and its bound, then ends with
``{"ok": true, "token_sum_only": true, ...}``: a few minutes, for work
on that kernel. ``tools/ab_main_path_torch.py --cells token_sum``
compares two trees'.

``--conv-pool-only`` builds the kernels and runs the CNN first block's
phase alone (``phase_conv_pool``: ``conv_pool`` / ``conv_pool_grad``
against their plain version at ``CONV_POOL_SHAPES``, a user's bits
alone = in a stack = on every card, their times beside the bound and the
parent's chain, one CNN local step's leaves again, as a sweep lane and as
a split chunk, one fused CNN round's launches, the CNN's sweep lanes and
cohort splits, over every card too, with the same winners), then ends
with ``{"ok": true, "conv_pool_only": true, ...}``.

``--profile`` adds ``torch.profiler`` passes over a few rounds of each
path through ``FLEngine.run`` after a warm-up run, the MLP cell's
per-round loop and the Fig. 3 sweep (device time and launches by kernel,
the device's idle share); the default run does not depend on the
profiler.

Every phase prints one JSON line; any failed check raises. The line
before the last two is the per-kernel record, then the card's name and
power limit, then ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import importlib.util
import io
import json
import os
import statistics
from collections import Counter
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: "
             "torch.cuda.is_available() is False")

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.channel import ChannelSpec               # noqa: E402
from repro_torch.checkpoint import load_fl_checkpoint     # noqa: E402
from repro_torch.configs.registry import get_config       # noqa: E402
from repro_torch.core import client as fl_client          # noqa: E402
from repro_torch.core import server as fl_server          # noqa: E402
from repro_torch.core.csma import CSMAConfig, CSMASimulator  # noqa: E402
from repro_torch.core.priority import priority_product     # noqa: E402
from repro_torch.data import make_token_stream            # noqa: E402
from repro_torch.engine import (ExperimentSpec, FLEngine,  # noqa: E402
                                FLHistory, PAPER_STRATEGIES, SiloBackend,
                                SweepSpec, build_host_engine,
                                get_strategy_class)
from repro_torch.engine import backends as fl_backends     # noqa: E402
from repro_torch.engine.backends import (aircomp_noise,  # noqa: E402
                                         compact_weights)
from repro_torch.faults import FaultSpec                  # noqa: E402
from repro_torch.kernels import build as kbuild           # noqa: E402
from repro_torch.kernels import contention as kcont       # noqa: E402
from repro_torch.kernels import delta_norm as kdn          # noqa: E402
from repro_torch.kernels import fused_sgd as kfused        # noqa: E402
from repro_torch.kernels import ops, ref                  # noqa: E402
from repro_torch.kernels import server_opt as kso          # noqa: E402
from repro_torch.kernels import token_sum as ktsum         # noqa: E402
from repro_torch.launch import dryrun as launch_dryrun    # noqa: E402
from repro_torch.launch import mesh as launch_mesh        # noqa: E402
from repro_torch.launch import serve as launch_serve      # noqa: E402
from repro_torch.launch import steps as launch_steps      # noqa: E402
from repro_torch.launch import train as launch_train      # noqa: E402
from repro_torch.models import blocks as llm_blocks       # noqa: E402
from repro_torch.models import frontends as llm_frontends  # noqa: E402
from repro_torch.models import model as llm               # noqa: E402
from repro_torch.models.paper_models import get_paper_model  # noqa: E402
from repro_torch.objectives import ObjectiveSpec          # noqa: E402
from repro_torch.optim import sgd_momentum_update         # noqa: E402
from repro_torch.sharding import cohort_mesh              # noqa: E402
from repro_torch.tree import tree_leaves, tree_map        # noqa: E402

DEV = torch.device("cuda")
#: the card's rates, one set for the bounds here and the dry run's
#: roofline (``launch/mesh.py``): H100 SXM HBM, f32 outside the tensor
#: cores, dense bf16 on them
HBM_BYTES_PER_S = launch_mesh.HBM_BW
F32_FLOPS_PER_S = launch_mesh.PEAK_FLOPS_F32
BF16_FLOPS_PER_S = launch_mesh.PEAK_FLOPS_BF16
LR = 1e-2

#: tolerances of the CPU parity tests: f32 rtol 1e-5 / atol 1e-6; bf16
#: one ulp of the output type; the two f32 sums of delta_norm rtol 1e-5
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
       torch.bfloat16: dict(rtol=1e-5, atol=0.02)}

KERNELS = {
    "fused_sgd": dict(source="src/repro_torch/kernels/csrc/fused_sgd.cu",
                      replaces="src/repro/kernels/fused_sgd.py:39"),
    "delta_norm": dict(source="src/repro_torch/kernels/csrc/delta_norm.cu",
                       replaces="src/repro/kernels/delta_norm.py:55"),
    "gather_combine": dict(source="src/repro_torch/kernels/csrc/combine.cu",
                           replaces="src/repro/kernels/gather.py:83"),
    "fedavg_combine": dict(source="src/repro_torch/kernels/csrc/combine.cu",
                           replaces="src/repro/kernels/fedavg.py:50"),
    "contention_min": dict(
        source="src/repro_torch/kernels/csrc/contention.cu",
        replaces="src/repro/kernels/contention.py:133"),
    "contention_expiry": dict(
        source="src/repro_torch/kernels/csrc/contention.cu",
        replaces="src/repro/kernels/contention.py:139"),
    "contention_transition": dict(
        source="src/repro_torch/kernels/csrc/contention.cu",
        replaces="src/repro/kernels/contention.py:147"),
    # the three passes fused with the host event loop that drove them
    "contention_loop": dict(
        source="src/repro_torch/kernels/csrc/contention.cu",
        replaces="src/repro/kernels/contention.py:113"),
    "aircomp_combine": dict(source="src/repro_torch/kernels/csrc/combine.cu",
                            replaces="src/repro/kernels/aircomp.py:65"),
    "robust_combine": dict(source="src/repro_torch/kernels/csrc/combine.cu",
                           replaces="src/repro/kernels/robust.py:57"),
    "server_opt": dict(source="src/repro_torch/kernels/csrc/server_opt.cu",
                       replaces="src/repro/kernels/server_opt.py:63"),
    # no Pallas kernel stands behind it: the reference's sums over a
    # user's tokens are XLA's (the loss mean; the norm scales' gradients)
    "token_sum": dict(source="src/repro_torch/kernels/csrc/token_sum.cu",
                      replaces="src/repro/models/layers.py:190"),
}
CONTENTION = ("contention_min", "contention_expiry", "contention_transition")
LOOP_KERNEL = "contention_loop"
LOOP_FIELDS = ("winners", "finish_slots", "collisions", "elapsed_slots",
               "n_delivered")
#: the channel and fault layers' specs on the main path. LOSSY: waterfall
#: PER under Rayleigh fading with the threshold raised to 15 dB, so the
#: MLP cell's 10 users lose a good share of their uploads (the default
#: 5 dB loses few); AIRCOMP: the over-the-air merge with receiver noise and
#: a truncation floor; ACTIVE: benchmarks/faults_bench.py:153-155
LOSSY = ChannelSpec(fading="rayleigh", per_snr_threshold_db=15.0)
AIRCOMP = dict(merge_backend="aircomp",
               channel=ChannelSpec(fading="rayleigh", aircomp_sigma=0.01,
                                   aircomp_gain_floor=0.1))
ACTIVE = FaultSpec(crash_prob=0.1, straggle_prob=0.2, corrupt_prob=0.1,
                   outage_prob=0.1, max_retries=2, clip_norm=2.0)
MERGE_K = (2, 64)                # rows a merge reads: k = 2 and k = 64
#: the objectives layer on the main path: FedDyn + FedAvgM under LOSSIER
#: (LOSSY at a 20 dB threshold: there 20 rounds of the MLP cell hold
#: rounds whose two attempts are both lost, which must still update h; at
#: 15 dB a CPU run of them held none) and FedProx + FedAdam
LOSSIER = ChannelSpec(fading="rayleigh", per_snr_threshold_db=20.0)
FEDDYN = ObjectiveSpec(local="feddyn", alpha=0.01, aggregator="fedavgm",
                       beta=0.9, server_lr=1.0)
FEDADAM = ObjectiveSpec(local="fedprox", mu=0.01, aggregator="fedadam",
                        server_lr=0.01)
#: server_opt consts [kind, beta1, beta2, server_lr, eps]: identity,
#: FedAvgM, FedAdam (FedAdam's is the one timed)
SERVER_KINDS = {0: [0, 0.9, 0.99, 0.5, 1e-3], 1: [1, 0.9, 0.0, 0.5, 1e-3],
                2: [2, 0.9, 0.99, 0.1, 1e-3]}
BIG = ref.CONTENTION_BIG
SLOT_S = 20e-6
#: the LLM stack: the --arch cells (phase tag -> arch), the serving archs
#: (the dense, vlm, moe, ssm and hybrid families), the --arch cell's
#: arguments beyond the launcher's defaults (--llm-seq 128
#: --llm-seqs-per-user 32 are its defaults, given for the record), and the
#: launches a round that PERF.md predicts: rows 1-3 (one local step of L
#: leaves, ceil(L / 32) launches of each leaf-list kernel; the merge once
#: a leaf: L = 12 / 13 / 56 / 25 / 11 / 22), and ``token_sum`` (the local
#: step's: one for the loss mean, two a MoE block, one a norm's scale in
#: the backward, six a Mamba-2 layer's parameters (``broadcast``'s five
#: and the gated norm's scale); then the evaluation's forward,
#: ``LLM_EVAL_TOKEN_SUMS``)
LLM_CELLS = {"yi9b": "yi-9b", "gemma2": "gemma2-27b",
             "deepseek": "deepseek-v3-671b", "kimi": "kimi-k2-1t-a32b",
             "mamba2": "mamba2-370m", "hymba": "hymba-1.5b"}
SERVE_ARCHS = ("yi-9b", "gemma2-27b", "phi3-mini-3.8b", "phi4-mini-3.8b",
               "phi-3-vision-4.2b", "deepseek-v3-671b", "kimi-k2-1t-a32b",
               "mamba2-370m", "hymba-1.5b", "whisper-small")
#: the reduced whisper's bars (``llm_serve_reduced``): the reference's
#: ``decode_step`` adds concatenated sin / cos halves where ``forward``
#: interleaves them (``models/layers.py``, ROADMAP's reference faults),
#: so its decode misses ``forward`` by design; the prefill is held to
#: ``forward`` (1e-3 absolute) and every decode step on the card to the
#: same teacher-forced decode on the CPU (the CPU tests tie that one to
#: the reference's ``decode_step``)
WHISPER_REDUCED = dict(prefill_bar=1e-3, cpu_bar=1e-4)
#: the reduced serving's prompt where it is not 32: hymba's beyond its
#: local layer's 64-token window, so the window slides in the prefill and
#: in every decode step
SERVE_PROMPT = {"hymba-1.5b": 80}
#: the ring cache's wrap: the long-context variant of the reduced
#: hymba-1.5b windows every layer at 64 (its global layers at the
#: long-context window), so a 64-entry ring serves it; a 32-token prefill,
#: then a decode step a token to position 96, the ring's slots wrapping
#: from position 64 on
RING_WRAP = dict(arch="hymba-1.5b", prefill=32, cache=64)
LLM_ARGV = ("--users", "10", "--k", "2", "--llm-seq", "128",
            "--llm-seqs-per-user", "32")
#: deepseek's Eq. 3 N scaled by 2^10: its Eq. 2 product over 56 leaves
#: starts near 3.4e4 (14 zero-initialised norm scales, each ratio capped
#: at 1), so at N = 2048 every window is under a slot and every attempt
#: collides (no delivery in 5 rounds on the CPU, in both packages). The
#: ssm and hybrid cells need none: their products start near 32 and 257
LLM_CELL_ARGV = {"deepseek": ("--cw-base", "2097152")}
LLM_ROUND_LAUNCHES = {
    "yi-9b": {"fused_sgd": 1, "delta_norm": 1, "gather_combine": 12,
              "token_sum": 7},
    "gemma2-27b": {"fused_sgd": 1, "delta_norm": 1, "gather_combine": 13,
                   "token_sum": 11},
    "deepseek-v3-671b": {"fused_sgd": 2, "delta_norm": 2,
                         "gather_combine": 56, "token_sum": 28},
    "kimi-k2-1t-a32b": {"fused_sgd": 1, "delta_norm": 1,
                        "gather_combine": 25, "token_sum": 11},
    "mamba2-370m": {"fused_sgd": 1, "delta_norm": 1, "gather_combine": 11,
                    "token_sum": 17},
    "hymba-1.5b": {"fused_sgd": 1, "delta_norm": 1, "gather_combine": 22,
                   "token_sum": 23}}
LLM_EVAL_TOKEN_SUMS = {"yi-9b": 1, "gemma2-27b": 1, "deepseek-v3-671b": 6,
                       "kimi-k2-1t-a32b": 3, "mamba2-370m": 1,
                       "hymba-1.5b": 1}
LLM_KERNELS = ("fused_sgd", "delta_norm", "gather_combine", "token_sum")
#: the --arch cells whose held-out loss must fall in 5 rounds
HELD_OUT_ARCHS = ("yi-9b", "gemma2-27b", "mamba2-370m", "hymba-1.5b")
#: lanes of the --arch sweeps (E x L leaves in one Eq. 2 call, more than
#: one launch takes), and the cells run as a sweep: lane 0 must equal the
#: run bit for bit
LLM_SWEEP_LANES = 3
LLM_SWEEP_CELLS = ("yi9b", "deepseek", "mamba2", "hymba")
#: the full-width yi-9b serving check (PERF.md states the bar): every
#: decode step's and the prefill's logits against forward's row, the
#: largest gap over the row's logit range
YI_FULL = dict(batch=4, prompt=512, gen=16, bar=0.05)
#: the full-width SSM and hybrid serving checks (tag -> arch, and the
#: bars on the bf16 decode's gap to the bf16 forward over the row's logit
#: range: on the prefill and the first ``early`` decode steps, and on
#: every step): published widths, every layer, bf16, yi-9b's prompts and
#: tokens. Both are also held in f32 (decode = forward within
#: ``SSM_F32_BAR``) and by accuracy (the bf16 decode no further off the f32
#: logits than ``SSM_BF16_FACTOR`` x the bf16 forward is). hymba holds
#: 0.05 on every step. mamba2's 48 random layers amplify bf16 rounding:
#: its bf16 forward lies 0.13-0.28 of the range off the f32 logits, and
#: the decode's gap to the bf16 forward grows a step at a time (PERF.md
#: section 6; tests/test_torch_llm_ssm.py holds the port's bf16 drift to
#: the reference's at 2, 8 and 16 layers), so it holds 0.05 on the prefill
#: and 4 decode steps and 0.1 on every step
SSM_FULL = {"mamba2": ("mamba2-370m", dict(early=4, early_bar=0.05,
                                           bar=0.1)),
            "hymba": ("hymba-1.5b", dict(early=0, early_bar=0.05,
                                         bar=0.05))}
SSM_F32_BAR = 1e-3
SSM_BF16_FACTOR = 1.25
#: whisper-small at its published dims (12 encoder + 12 decoder layers,
#: d_model 768, 1500 frames, vocab 51865), bf16: 4 x 1500 frames, a
#: 64-token prompt, 16 tokens. The prefill against ``forward`` within
#: ``prefill_bar`` of the row's logit range; the bf16 decode against the
#: f32 decode of the same weights, frames and tokens within ``f32_bar``
#: (PERF.md states both before the call that first ran them)
WHISPER_FULL = dict(batch=4, prompt=64, gen=16, prefill_bar=0.05,
                    f32_bar=0.02)
#: the cross-silo round (``SiloBackend`` through ``FLEngine.run``): the
#: reference's demo and tests' arch, reduced; 4 silos, batch 4, 64-token
#: sequences, 6 rounds, ``priority-distributed``, k = 1 (the demo's lr and
#: counter threshold); and the launches a round PERF.md predicts: one
#: local step of 12 leaves (one ``fused_sgd`` launch), one Eq. 2 call
#: (one ``delta_norm`` launch), the step's six token sums (the loss mean,
#: five norm scales' gradients); the merge is the reference's plain
#: einsum, no kernel
SILO = dict(arch="phi3-mini-3.8b", silos=4, batch=4, seq=64, rounds=6,
            lr=3e-2, threshold=0.5, seed=0)
SILO_ROUND_LAUNCHES = {"fused_sgd": 1, "delta_norm": 1, "token_sum": 6,
                       "gather_combine": 0, "fedavg_combine": 0}
#: the bf16 merge's bars against the f32 merge: 0.02 absolute, and 1e-2
#: of the f32 merge's own update (its largest move off the global), so
#: a merge that drops the update or takes another silo's fails
SILO_BF16_ATOL = 0.02
SILO_BF16_REL = 1e-2
#: the cross-silo round at phi3-mini's published widths (d_model 3072,
#: 32 heads of 96, d_ff 8192, vocab 32064 padded to 32256), its depth cut
#: from 32 layers to 2 (the reduced cell's), bf16 as published; 4 silos,
#: batch 4, 1024-token sequences, 4 rounds. Its launches a round are
#: ``SILO_ROUND_LAUNCHES`` (12 leaves, 2 layers: the same six token sums)
SILO_FULL = dict(arch="phi3-mini-3.8b", layers=2, silos=4, batch=4,
                 seq=1024, rounds=4, lr=3e-2, threshold=0.5, seed=0)
#: the full-width leaves rows 1-3 run on one at a time (U = 2, bf16)
YI_FULL_LEAVES = ("blocks0/mlp/w_gate", "blocks0/attn/wq", "embed/embedding")


T_START = time.perf_counter()


def emit(phase, **fields):
    """One phase's JSON line; ``t_s``: seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": time.perf_counter() - T_START}), flush=True)


def randn(seed, shape, dtype):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float32) \
        .to(DEV).to(dtype)


def randn_dev(seed, shape, dtype):
    """``randn`` drawn on the card (for the 1024-user stacks)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randn(shape, generator=g, device=DEV).to(dtype)


def model_leaves(model):
    """The leaf shapes (tree order) of one of the paper's models."""
    return [tuple(l.shape) for l in tree_leaves(
        get_paper_model(model)[0](0, device="cpu"))]


# ------------------------------------------------------------ comparisons
def compare(name, got, want, dtype, rel_only=False):
    """Kernel result vs plain version; returns (max_abs_err, bit_equal).
    Raises when they disagree beyond the stated tolerance."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if g.shape != w.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: shape/dtype {tuple(g.shape)} "
                             f"{got.dtype} vs {tuple(w.shape)} {want.dtype}")
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    tol = dict(rtol=1e-5, atol=0.0) if rel_only else TOL[dtype]
    if not torch.allclose(g, w, **tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e}, tol {tol})")
    return err, bool(torch.equal(got, want))


def merge_inputs(S, winners, k_pad):
    idx = np.zeros(k_pad, np.int32)
    w = np.zeros(k_pad, np.float32)
    idx[:len(winners)] = winners
    sizes = np.arange(1, len(winners) + 1, dtype=np.float64) * 100.0
    w[:len(winners)] = (sizes / sizes.sum()).astype(np.float32)
    assert max(winners) < S
    return torch.from_numpy(idx).to(DEV), torch.from_numpy(w).to(DEV)


def check_kernels_at(shape, U, dtype, seed):
    """All four kernels against their plain versions for one leaf shape
    and cohort size; returns {kernel: (err, bit_equal)}."""
    out = {}
    stack = randn(seed, (U,) + shape, dtype)
    glob = randn(seed + 1, shape, dtype)
    grad = randn(seed + 2, (U,) + shape, dtype)

    want = ref.fused_sgd_ref(stack, grad, LR)
    got = ops.fused_sgd(stack.clone(), grad, LR)
    out["fused_sgd"] = compare("fused_sgd", got, want, dtype)

    d2w, g2w = ref.delta_norm_stacked_ref(stack, glob)
    d2, g2 = ops.delta_norm_stacked(stack, glob)
    e1, b1 = compare("delta_norm.d2", d2, d2w, torch.float32, rel_only=True)
    e2, b2 = compare("delta_norm.g2", g2, g2w, torch.float32, rel_only=True)
    d2o, g2o = ops.delta_norm(stack[0].contiguous(), glob)
    compare("delta_norm.d2[0]", d2o, d2w[0], torch.float32, rel_only=True)
    # relative error is what the tolerance is stated in for the two sums
    rel = max(float(((d2 - d2w).abs() / d2w.clamp(min=1e-30)).max()),
              float((g2 - g2w).abs() / g2w.clamp(min=1e-30)))
    out["delta_norm"] = (max(e1, e2), b1 and b2, rel)

    winners = [U - 1, 0, U // 2] if U >= 3 else [0]
    idx, w = merge_inputs(U, winners, k_pad=len(winners) + 1)
    want = ref.gather_combine_ref(stack, idx, w, glob)
    got = ops.gather_combine(stack, idx, w, glob)
    out["gather_combine"] = compare("gather_combine", got, want, dtype)

    alphas = torch.zeros(U, dtype=torch.float32, device=DEV)
    alphas[idx[:len(winners)].long()] = w[:len(winners)]
    want = ref.fedavg_combine_ref(stack, alphas)
    got = ops.fedavg_combine(stack, alphas)
    out["fedavg_combine"] = compare("fedavg_combine", got, want, dtype)

    for K in MERGE_K:
        idx, a, c, sc = channel_merge_inputs(U, K, seed + K, zero=K > 2)
        noise = randn(seed + 3, shape, torch.float32) * 0.01
        rows = torch.index_select(stack, 0, idx.long())
        w_air, scale = ops.aircomp_weights(a, c, DEV)
        want = ref.aircomp_combine_ref(rows, w_air, noise, scale[0])
        got = ops.aircomp_combine(stack, a, c, noise, idx=idx)
        fold(out, "aircomp_combine",
             compare(f"aircomp_combine K={K}", got, want, dtype))
        want = ref.robust_combine_ref(rows, a, sc, glob)
        got = ops.robust_combine(rows, a, sc, glob)
        fold(out, "robust_combine",
             compare(f"robust_combine K={K}", got, want, dtype))
    out["server_opt"] = check_server_opt_at(shape, dtype, seed + 50)
    return out


def check_server_opt_at(shape, dtype, seed):
    """The server step in each kind against its plain version (all three
    outputs), and its contracts bitwise: kind 1 is
    ``optim.sgd_momentum_update`` on ``old - avg``; kind 0, and kind 1
    with beta1 = 0 and server_lr = 1, return avg's bits; server_lr = 0.5 is not a
    passthrough; m passes through under kind 0 and v under kinds 0 and
    1. Returns (worst error, every output bit-equal)."""
    avg, old, m = (randn(seed + i, shape, dtype) for i in range(3))
    v = randn(seed + 3, shape, dtype).abs()
    err, equal = 0.0, True
    for kind, consts in SERVER_KINDS.items():
        got = ops.server_opt_combine(avg, old, m, v, consts)
        want = ref.server_opt_combine_ref(avg, old, m, v,
                                          torch.tensor(consts))
        for part, g, w in zip(("out", "m", "v"), got, want):
            e, b = compare(f"server_opt kind {kind} {part}", g, w, dtype)
            err, equal = max(err, e), equal and b
        if kind in (0, 1) and not torch.equal(got[2], v) \
                or kind == 0 and not torch.equal(got[1], m):
            raise AssertionError(f"server_opt kind {kind}: m / v did not "
                                 "pass through")
    # kind 1 (FedAvgM) is optim.sgd_momentum_update on the pseudo-gradient
    # old - avg, bit for bit: the same f32 ops on the f32 copies, cast back
    k1 = SERVER_KINDS[1]
    out, nm, _ = ops.server_opt_combine(avg, old, m, v, k1)
    a32, o32, m32 = avg.float(), old.float(), m.float()
    wp, wm = sgd_momentum_update({"p": o32}, {"p": o32 - a32}, {"p": m32},
                                 lr=k1[3], momentum=k1[1])
    if not (torch.equal(out, wp["p"].to(avg.dtype))
            and torch.equal(nm, wm["p"].to(m.dtype))):
        raise AssertionError(f"server_opt kind 1 {tuple(shape)} {dtype}: not "
                             "sgd_momentum_update's bits")
    for consts, inert in (([0, 0.9, 0.99, 0.5, 1e-3], True),
                          ([1, 0.0, 0.0, 1.0, 1e-3], True),
                          ([1, 0.0, 0.0, 0.5, 1e-3], False)):
        out = ops.server_opt_combine(avg, old, m, v, consts)[0]
        torch.cuda.synchronize()
        if torch.equal(out, avg) != inert:
            raise AssertionError(f"server_opt {consts}: passthrough is "
                                 f"{not inert}, the law says {inert}")
    return err, equal


def fold(out, name, result):
    """Keep the worst error and the AND of bit-equality over cases."""
    if name in out:
        result = (max(out[name][0], result[0]), out[name][1] and result[1])
    out[name] = result


def channel_merge_inputs(U, K, seed, zero):
    """The AirComp / robust merge inputs for K rows of a (U, ...) stack:
    row indices in a delivery order (repeating when K > U), alphas on the
    simplex, power-control coefficients below 1 and shrink scales with a
    1.0 (the passthrough); with ``zero`` the middle slot has weight 0 and
    a NaN scale, which must not leak."""
    rng = np.random.default_rng(seed)
    idx = ((U - 1 - 7 * np.arange(K)) % U).astype(np.int32)
    a = rng.uniform(0.1, 1.0, K)
    a = (a / a.sum()).astype(np.float32)
    c = rng.uniform(0.3, 1.0, K).astype(np.float32)
    c[0] = 1.0
    sc = rng.uniform(0.1, 1.0, K).astype(np.float32)
    sc[0] = 1.0
    if zero:
        a[K // 2], sc[K // 2] = 0.0, np.nan
    return [torch.from_numpy(v).to(DEV) for v in (idx, a, c, sc)]


def check_merge_contracts(dtype):
    """The merge's exactness contracts, bitwise, on the card."""
    S, shape = 6, (2, 129, 5)
    stack, glob = randn(40, (S,) + shape, dtype), randn(41, shape, dtype)
    idx, w = merge_inputs(S, [4, 1, 3], k_pad=4)
    clean = ops.gather_combine(stack, idx, w, glob)
    for bad in (float("inf"), float("nan")):
        poisoned = stack.clone()
        poisoned[0] = bad               # the pad slot's row, weight zero
        poisoned[5] = bad               # a row nobody selected
        out = ops.gather_combine(poisoned, idx, w, glob)
        torch.cuda.synchronize()
        if not torch.equal(out, clean):
            raise AssertionError("gather_combine: a zero-weight "
                                 f"{bad} row leaked into the merge")
        alphas = torch.zeros(S, dtype=torch.float32, device=DEV)
        alphas[idx[:3].long()] = w[:3]
        dense = ops.fedavg_combine(poisoned, alphas)
        if not torch.equal(dense, ops.fedavg_combine(stack, alphas)):
            raise AssertionError("fedavg_combine: a zero-weight "
                                 f"{bad} row leaked into the merge")
    keep = ops.gather_combine(stack, idx, torch.zeros_like(w), glob)
    if not torch.equal(keep, glob) or keep.data_ptr() == glob.data_ptr():
        raise AssertionError("gather_combine: all-zero weights must "
                             "return a fresh bit-copy of glob")
    for k_pad in (3, 8, 17):
        i2, w2 = merge_inputs(S, [4, 1, 3], k_pad=k_pad)
        if not torch.equal(ops.gather_combine(stack, i2, w2, glob), clean):
            raise AssertionError("gather_combine: the pad width changed "
                                 "the bits of the merge")
    compact = stack[idx.long()].contiguous()
    pos = torch.arange(4, dtype=torch.int32, device=DEV)
    if not torch.equal(ops.gather_combine(compact, pos, w, glob), clean):
        raise AssertionError("gather_combine: winner ids into (U, ...) "
                             "and positions into (K, ...) disagree")
    a = ops.delta_norm_stacked(stack, glob)
    b = ops.delta_norm_stacked(stack, glob)
    if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
        raise AssertionError("delta_norm: two runs differ bitwise")
    # the channel and fault merges: unit coefficients without noise, and
    # all-ones scales, are the plain merge bit for bit; a zero weight
    # masks an inf / NaN row (and a NaN scale) to exact zero
    ones = torch.ones(4, dtype=torch.float32, device=DEV)
    rows = stack[idx.long()].contiguous()
    for coeffs in (None, ones):
        air = ops.aircomp_combine(stack, w, coeffs, None, idx=idx)
        if not torch.equal(air, clean):
            raise AssertionError("aircomp_combine: unit coefficients and "
                                 "no noise are not the plain merge's bits")
    if not torch.equal(ops.robust_combine(rows, w, ones, glob), clean):
        raise AssertionError("robust_combine: all-ones scales are not the "
                             "plain merge's bits")
    scales = torch.tensor([0.5, 1.0, 0.25, float("nan")], device=DEV)
    coeffs = torch.tensor([0.5, 1.0, 0.25, 0.8], device=DEV)
    noise = randn(42, shape, torch.float32)
    air_clean = ops.aircomp_combine(stack, w, coeffs, noise, idx=idx)
    rob_clean = ops.robust_combine(rows, w, scales, glob)
    for bad in (float("inf"), float("nan")):
        poisoned = stack.clone()
        poisoned[0] = bad               # the pad slot's row, weight zero
        prows = poisoned[idx.long()].contiguous()
        if not (torch.equal(ops.aircomp_combine(poisoned, w, coeffs, noise,
                                                idx=idx), air_clean)
                and torch.equal(ops.robust_combine(prows, w, scales, glob),
                                rob_clean)
                and torch.isfinite(rob_clean.float()).all()):
            raise AssertionError("aircomp / robust: a zero-weight "
                                 f"{bad} row leaked into the merge")


#: where the merges' row walk splits from its one-column path: n % 4 != 0,
#: n < 4, n % 8 != 0 (bf16); and around its groups of rows in flight (4
#: rows a group up to 8 live rows, 16 past them): with one zero weight,
#: 4, 8, 9, 16 and 64 live rows
SPLIT_K = (1, 5, 9, 10, 17, 65)
SPLIT_SHAPES = ((3,), (10,), (2, 7), (4, 130), (784, 200))


def skewed(t):
    """``t``'s values in a fresh buffer one element past a 16-byte
    boundary: the same contiguous tensor, but the one-column path."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=DEV)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def same_bits(a, b):
    """Two tensors of one float dtype hold the same bit patterns."""
    torch.cuda.synchronize()
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def bit_check(name, got, want, dtype):
    """``compare``, and raise unless the kernel is bit-equal."""
    e, b = compare(name, got, want, dtype)
    if not b:
        raise AssertionError(f"{name}: not bit-equal to the plain version "
                             f"(max abs err {e:.3e})")
    return e


def check_combine_split(dtype):
    """gather / FedAvg / AirComp (one kernel) where the vector path
    splits: SPLIT_K rows out of an (S = K + 3, ...) stack, every
    SPLIT_SHAPES leaf, a NaN row at zero weight (delivery slot 8 or 13, or
    the last), each operand in turn skewed off its 16-byte boundary, a noise
    plane; and the contracts there: winner ids into (S, ...) against
    positions into the gathered (K, ...) rows, all-zero weights giving
    glob's bits, AirComp without idx. Everything bit-equal to the plain
    versions; returns {kernel: (worst error, True)}."""
    err = {"gather_combine": 0.0, "fedavg_combine": 0.0,
           "aircomp_combine": 0.0}
    for K in SPLIT_K:
        for shape in SPLIT_SHAPES:
            n, S = int(np.prod(shape)), K + 3
            seed = 31 * K + n
            stack = randn(seed, (S,) + shape, dtype)
            glob = randn(seed + 1, shape, dtype)
            noise = randn(seed + 2, shape, torch.float32) * 0.01
            idx, a, c, _ = channel_merge_inputs(S, K, seed, zero=False)
            poisoned = stack.clone()
            if K > 1:
                z = min(K - 1, 13)
                a[z] = 0.0
                poisoned[int(idx[z])] = float("nan")
            tag = f"K={K} {shape} {str(dtype)[6:]}"
            # gather
            want = ref.gather_combine_ref(stack, idx, a, glob)
            for label, st, g in (("aligned", poisoned, glob),
                                 ("stack skewed", skewed(poisoned), glob),
                                 ("glob skewed", poisoned, skewed(glob))):
                e = bit_check(f"gather_combine {tag} {label}",
                              ops.gather_combine(st, idx, a, g), want, dtype)
                err["gather_combine"] = max(err["gather_combine"], e)
            rows = poisoned[idx.long()].contiguous()
            pos = torch.arange(K, dtype=torch.int32, device=DEV)
            bit_check(f"gather_combine {tag} positions",
                      ops.gather_combine(rows, pos, a, glob), want, dtype)
            for g in (glob, skewed(glob)):
                keep = ops.gather_combine(poisoned, idx, torch.zeros_like(a),
                                          g)
                if not same_bits(keep, g):
                    raise AssertionError(f"gather_combine {tag}: all-zero "
                                         "weights did not return glob's bits")
            # FedAvg over every row of the stack, in row order
            alphas = torch.zeros(S, dtype=torch.float32, device=DEV)
            alphas[idx.long()] = a
            want = ref.fedavg_combine_ref(stack, alphas)
            for label, st in (("aligned", poisoned),
                              ("skewed", skewed(poisoned))):
                e = bit_check(f"fedavg_combine {tag} {label}",
                              ops.fedavg_combine(st, alphas), want, dtype)
                err["fedavg_combine"] = max(err["fedavg_combine"], e)
            # AirComp with a noise plane, through idx and without
            w_air, scale = ops.aircomp_weights(a, c, DEV)
            want = ref.aircomp_combine_ref(stack[idx.long()], w_air, noise,
                                           scale[0])
            for label, st, nz, i in (
                    ("aligned", poisoned, noise, idx),
                    ("stack skewed", skewed(poisoned), noise, idx),
                    ("noise skewed", poisoned, skewed(noise), idx),
                    ("no idx", rows, noise, None)):
                e = bit_check(f"aircomp_combine {tag} {label}",
                              ops.aircomp_combine(st, a, c, nz, idx=i),
                              want, dtype)
                err["aircomp_combine"] = max(err["aircomp_combine"], e)
    # FedAvg's masked scan: 1024 rows of a (784, 200) leaf, 2 of them live
    stack = randn(77, (1024, 784, 200), dtype)
    alphas = torch.zeros(1024, dtype=torch.float32, device=DEV)
    alphas[1023], alphas[3] = 0.625, 0.375
    e = bit_check("fedavg_combine 1024 rows, 2 live",
                  ops.fedavg_combine(stack, alphas),
                  ref.fedavg_combine_ref(stack, alphas), dtype)
    err["fedavg_combine"] = max(err["fedavg_combine"], e)
    del stack
    # a K past the shared-memory limit is refused, never run another way
    big = kbuild.library("combine").repro_combine_max_k() + 1
    st = randn(78, (2, 8), dtype)
    try:
        ops.gather_combine(st, torch.zeros(big, dtype=torch.int32,
                                           device=DEV),
                           torch.ones(big, device=DEV), st[0])
    except RuntimeError:
        pass
    else:
        raise AssertionError(f"gather_combine: K = {big} past the limit "
                             "was not refused")
    return {k: (v, True) for k, v in err.items()}


#: the cohort widths the stacked, ragged and partial-cohort rounds hand the
#: training kernels: U = 1 (a ragged user, a one-winner round), 2
#: (random-centralized at k = 2) and 64 (random-centralized at k = 64),
#: and the merges' row counts S = m there (every row a winner)
SMALL_U = (1, 2, 64)


def check_sgd_leaves(dtype):
    """The multi-leaf SGD step against the plain version leaf by leaf,
    bit for bit: the MLP's four stacked leaves at U = 10 (aligned, one
    launch), the MLP's and the CNN's at U = 1, 2, 64 (``SMALL_U``), a
    list of ragged and skewed leaves, and 40 leaves (two launches).
    Returns (worst error, True)."""
    mlp = [(10, 200), (10, 784, 200), (10, 10), (10, 200, 10)]
    ragged = [(3,), (10,), (2, 7), (4, 130), (10, 784, 200), (1,), (4097,)]
    many = [(int(k) % 7 + 1, 33 * (int(k) % 5) + 8) for k in range(40)]
    err = 0.0
    for label, shapes, skew in (
            ("mlp", mlp, ()), ("ragged", ragged, (1, 4)),
            ("40 leaves", many, (5, 17)),
            *((f"{m} U={U}", [(U,) + sh for sh in model_leaves(m)], ())
              for m in ("mlp", "cnn") for U in SMALL_U)):
        ps = [randn(300 + i, sh, dtype) for i, sh in enumerate(shapes)]
        gs = [randn(400 + i, sh, dtype) for i, sh in enumerate(shapes)]
        for i in skew:
            ps[i], gs[i] = skewed(ps[i]), skewed(gs[i])
        want = [ref.fused_sgd_ref(p, g, LR) for p, g in zip(ps, gs)]
        before = ops.LAUNCHES["fused_sgd"]
        got = ops.fused_sgd_leaves(ps, gs, LR)
        launches = ops.LAUNCHES["fused_sgd"] - before
        if launches != -(-len(shapes) // kfused.max_leaves()):
            raise AssertionError(f"fused_sgd_leaves {label}: {launches} "
                                 f"launches for {len(shapes)} leaves")
        for i, (g, w) in enumerate(zip(got, want)):
            err = max(err, bit_check(
                f"fused_sgd_leaves {label} leaf {i} {tuple(g.shape)} "
                f"{str(dtype)[6:]}", g, w, dtype))
    return err, True


#: leaf lists beside the models': sizes that are no multiple of 4 or 8,
#: below 4, one past a warp's span, past one chunk; and more leaves than
#: one launch takes
RAGGED_LEAVES = [(1,), (3,), (7,), (2, 5), (513,), (4097,), (3, 129, 5),
                 (8,)]
MANY_LEAVES = [(k % 7 + 1, 33 * (k % 5) + 8) for k in range(40)]


def check_leaf_lists(dtype):
    """The two leaf-list kernels against their plain versions, leaf by
    leaf. ``delta_norm_leaves`` (rtol 1e-5, and two runs bit-identical)
    on the MLP's and the CNN's stacked leaves at U = 10, U = 1024 and
    ``SMALL_U``, a ragged list with skewed operands and 40 leaves (two
    launches);
    ``server_opt_leaves`` bit-equal in every kind on the MLP's and the
    CNN's leaves, the ragged list skewed and the 40 leaves, the inert
    settings passing avg's bits through. Both raise on any failure.
    Returns {kernel: (worst abs error, bit_equal)} and delta_norm's
    worst relative error."""
    worst = {"delta_norm": 0.0, "server_opt": 0.0}
    worst_rel = 0.0
    tag = str(dtype)[6:]
    for label, shapes, U, skew in (
            ("mlp", model_leaves("mlp"), 10, ()),
            ("mlp", model_leaves("mlp"), 1024, ()),
            ("cnn", model_leaves("cnn"), 10, ()),
            ("cnn", model_leaves("cnn"), 1024, ()),
            ("ragged", RAGGED_LEAVES, 5, (1, 5)),
            ("40 leaves", MANY_LEAVES, 3, (2, 30)),
            *((m, model_leaves(m), U, ()) for m in ("mlp", "cnn")
              for U in SMALL_U)):
        st = [randn_dev(800 + i, (U,) + sh, dtype)
              for i, sh in enumerate(shapes)]
        gl = [randn_dev(900 + i, sh, dtype) for i, sh in enumerate(shapes)]
        for i in skew:
            st[i], gl[i] = skewed(st[i]), skewed(gl[i])
        before = ops.LAUNCHES["delta_norm"]
        d2, g2 = ops.delta_norm_leaves(st, gl)
        launches = ops.LAUNCHES["delta_norm"] - before
        if launches != -(-len(shapes) // kdn.max_leaves()):
            raise AssertionError(f"delta_norm_leaves {label}: {launches} "
                                 f"launches for {len(shapes)} leaves")
        d2b, g2b = ops.delta_norm_leaves(st, gl)
        if not (same_bits(d2, d2b) and same_bits(g2, g2b)):
            raise AssertionError(f"delta_norm_leaves {label} U={U} {tag}: "
                                 "two runs differ bitwise")
        for l, (x, g) in enumerate(zip(st, gl)):
            d2r, g2r = ref.delta_norm_stacked_ref(x, g)
            name = f"delta_norm_leaves {label} U={U} leaf {l} {tag}"
            for got, want in ((d2[l], d2r), (g2[l], g2r)):
                e, _ = compare(name, got, want, torch.float32, rel_only=True)
                worst["delta_norm"] = max(worst["delta_norm"], e)
                worst_rel = max(worst_rel, float(
                    ((got - want).abs() / want.abs().clamp(min=1e-30))
                    .max()))
        del st, gl
        torch.cuda.empty_cache()
    for label, shapes, skew in (("mlp", model_leaves("mlp"), ()),
                                ("cnn", model_leaves("cnn"), ()),
                                ("ragged", RAGGED_LEAVES, (1, 5)),
                                ("40 leaves", MANY_LEAVES, (3, 33))):
        four = [[randn_dev(1000 + 50 * j + i, sh, dtype)
                 for i, sh in enumerate(shapes)] for j in range(4)]
        four[3] = [v.abs() for v in four[3]]
        for i in skew:
            for j in range(4):
                four[j][i] = skewed(four[j][i])
        settings = [*SERVER_KINDS.values(), [1, 0.0, 0.0, 1.0, 1e-3]]
        for consts in settings:
            before = ops.LAUNCHES["server_opt"]
            got = ops.server_opt_leaves(*four, consts)
            launches = ops.LAUNCHES["server_opt"] - before
            if launches != -(-len(shapes) // kso.max_leaves()):
                raise AssertionError(f"server_opt_leaves {label}: "
                                     f"{launches} launches for "
                                     f"{len(shapes)} leaves")
            inert = consts[0] == 0 or consts[0] == 1 and consts[1] == 0 \
                and consts[3] == 1
            for l in range(len(shapes)):
                want = ref.server_opt_combine_ref(
                    *(x[l] for x in four), torch.tensor(consts))
                for part, g, w in zip(("out", "m", "v"),
                                      (x[l] for x in got), want):
                    worst["server_opt"] = max(worst["server_opt"], bit_check(
                        f"server_opt_leaves {label} {consts} leaf {l} "
                        f"{part} {tag}", g, w, dtype))
                if inert and not same_bits(got[0][l], four[0][l]):
                    raise AssertionError(f"server_opt_leaves {consts}: the "
                                         "inert step did not pass avg's "
                                         "bits through")
    # delta_norm within rtol 1e-5, never bit-equal (its own order);
    # server_opt bit-equal or it raised
    return ({"delta_norm": (worst["delta_norm"], False),
             "server_opt": (worst["server_opt"], True)}, worst_rel)




def check_winner_stacks(dtype):
    """The gather merge of the stacked, ragged and partial-cohort rounds:
    over (m, ...) stacks of every MLP and CNN leaf whose every row is a
    winner, m = 1, 2, 64 (``SMALL_U``), ``gather_combine`` (positions in
    a delivery order, padded to k_pad = max(m, 2) as the k = 2 merge
    pads a one-winner round), ``aircomp_combine`` with ``idx=None`` and a
    noise plane, and ``robust_combine``, each bit-equal to its plain
    version or it raises. Returns {kernel: (worst abs error, True)}."""
    err = {"gather_combine": 0.0, "aircomp_combine": 0.0,
           "robust_combine": 0.0}
    tag = str(dtype)[6:]
    for model in ("mlp", "cnn"):
        for m in SMALL_U:
            seed = 1200 + 10 * m
            rng = np.random.default_rng(seed)
            a = rng.uniform(0.1, 1.0, m)
            a = (a / a.sum()).astype(np.float32)
            k_pad = max(m, 2)
            idx = np.zeros(k_pad, np.int32)
            idx[:m] = rng.permutation(m)
            w = np.zeros(k_pad, np.float32)
            w[:m] = a
            c = rng.uniform(0.3, 1.0, m).astype(np.float32)
            sc = rng.uniform(0.1, 1.0, m).astype(np.float32)
            sc[0] = 1.0
            idx, w, a, c, sc = (torch.from_numpy(v).to(DEV)
                                for v in (idx, w, a, c, sc))
            w_air, scale = ops.aircomp_weights(a, c, DEV)
            for l, sh in enumerate(model_leaves(model)):
                x = randn_dev(seed + l, (m,) + sh, dtype)
                g = randn_dev(seed + 100 + l, sh, dtype)
                noise = randn_dev(seed + 200 + l, sh, torch.float32) * 0.05
                name = f"m={m} {model} leaf {l} {tag}"
                for kernel, got, want in (
                        ("gather_combine", ops.gather_combine(x, idx, w, g),
                         ref.gather_combine_ref(x, idx, w, g)),
                        ("aircomp_combine",
                         ops.aircomp_combine(x, a, c, noise),
                         ref.aircomp_combine_ref(x, w_air, noise, scale[0])),
                        ("robust_combine", ops.robust_combine(x, a, sc, g),
                         ref.robust_combine_ref(x, a, sc, g))):
                    err[kernel] = max(err[kernel], bit_check(
                        f"{kernel} {name}", got, want, dtype))
        torch.cuda.empty_cache()
    return {k: (v, True) for k, v in err.items()}


def check_robust_split(dtype):
    """robust_combine where its vector path splits from its scalar path
    (n % 4 != 0, n < 4, n % 8 != 0 for bf16, an operand 4 bytes off a
    16-byte boundary) and around its groups of rows in flight (SPLIT_K),
    with a NaN row at zero weight (row 8 or 13, or the last): bit-equal
    to the plain version on the unpoisoned rows, or it raises. Returns
    (worst error, True)."""
    err = 0.0
    for K in SPLIT_K:
        for shape in ((3,), (10,), (2, 7), (4, 130), (784, 200)):
            n = int(np.prod(shape))
            stack = randn(K * 7 + n, (K,) + shape, dtype)
            glob = randn(K * 7 + n + 1, shape, dtype)
            _, a, _, sc = channel_merge_inputs(K, K, seed=K + n, zero=False)
            poisoned = stack.clone()
            if K > 1:
                z = min(K - 1, 13)
                a[z], sc[z] = 0.0, float("nan")
                poisoned[z] = float("nan")
            want = ref.robust_combine_ref(stack, a, sc, glob)
            for label, rows, g in (("aligned", poisoned, glob),
                                   ("stack skewed", skewed(poisoned), glob),
                                   ("glob skewed", poisoned, skewed(glob))):
                err = max(err, bit_check(
                    f"robust_combine K={K} {shape} {str(dtype)[6:]} {label}",
                    ops.robust_combine(rows, a, sc, g), want, dtype))
    return err, True


# ------------------------------------------------------------ contention
def event_inputs(B, N, seed, kind):
    """One (counters, live, doublings, windows, rand) pool on the card.

    ``"tie"``: small counters, a forced expiry tie in row 0, dead lanes
    and (B > 1) a last row with no live lane; ``"dead"``: no live lane
    at all; ``"loop"``: absolute expiries as the loop holds them (up to
    BIG, BIG where a lane has left), windows up to 1e6 slots so redraws
    reach the clamp."""
    rng = np.random.default_rng(seed)
    dbl = rng.integers(0, 6, (B, N)).astype(np.int32)
    rand = rng.random((B, N)).astype(np.float32)
    if kind == "loop":
        cnt = rng.integers(0, 1 << 20, (B, N)).astype(np.int32)
        cnt[rng.random((B, N)) < 0.2] = BIG
        cnt[:, :min(3, N)] = cnt[:, :1]            # a tie at the row min
        live = cnt < BIG
        win = rng.uniform(1.0, 1e6, (B, N)).astype(np.float32)
    else:
        cnt = rng.integers(0, 50, (B, N)).astype(np.int32)
        live = rng.random((B, N)) > 0.3
        cnt[0, :min(4, N)] = 5
        live[0, :min(4, N)] = True
        if B > 1:
            live[-1] = False
        if kind == "dead":
            live[:] = False
        win = rng.uniform(1.0, 1e4, (B, N)).astype(np.float32)
    return [torch.from_numpy(a).to(DEV) for a in (cnt, live, dbl, win, rand)]


def check_contention_at(B, N, seed):
    """The event op (three kernels) against its plain version at one
    pool shape: every output bit-equal, dtypes equal; raises if not."""
    for kind, mds in (("tie", (5, 7)), ("dead", (5,)), ("loop", (5,))):
        args = event_inputs(B, N, seed, kind)
        for md in mds:
            got = ops.contention_event(*args, md)
            want = ref.contention_event_ref(*args, md)
            torch.cuda.synchronize()
            for name, g, w in zip(("step", "nexp", "winner", "counters",
                                   "doublings", "active"), got, want):
                if g.dtype != w.dtype or g.shape != w.shape:
                    raise AssertionError(
                        f"contention {name} at {(B, N)}: {g.dtype} "
                        f"{tuple(g.shape)} vs {w.dtype} {tuple(w.shape)}")
                if not torch.equal(g, w):
                    err = float((g.double() - w.double()).abs().max())
                    raise AssertionError(
                        f"contention {name} at {(B, N)} ({kind}, max "
                        f"doublings {md}): not bit-equal to the plain "
                        f"version (max abs err {err})")


def dense_inputs(n, lanes, seed):
    """``benchmarks/contention_bench.py::_dense_inputs``: CW = n/2 slots
    (about two expiries a slot), in seconds."""
    rng = np.random.default_rng(seed)
    cw = (n // 2) * SLOT_S
    return rng.uniform(0.0, 1.0, (lanes, n)) * cw, np.full(n, cw)


def check_contention_invariants(name, res, k, part=None):
    """``tests/test_contention_device.py::test_pool_mode_invariants_large_n``
    per row: unique, participating winners, exactly k, increasing
    finish slots."""
    for b in range(res.winners.shape[0]):
        w = res.winners[b][res.winners[b] >= 0]
        if not len(w) == len(set(w.tolist())) == k:
            raise AssertionError(f"{name}: row {b} delivered {w.tolist()}")
        if part is not None and not part[b, w].all():
            raise AssertionError(f"{name}: row {b}: a refrained winner")
        if not (np.diff(res.finish_slots[b][:k]) > 0).all():
            raise AssertionError(f"{name}: row {b}: finish slots not "
                                 "increasing")


def contention_run(sim, backoffs, windows, k):
    """One ``contend_batch`` through the simulator with the launch counts
    and loop stats set to 0 just before and read just after; returns
    (result, seconds, launches, loop stats)."""
    torch.cuda.synchronize()
    ops.reset_launches()
    kcont.reset_loop_stats()
    t0 = time.perf_counter()
    res = sim.contend_batch(backoffs, windows, k_target=k)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k_: ops.LAUNCHES[k_] for k_ in (*CONTENTION, LOOP_KERNEL)}
    loop = dict(kcont.LOOP, shapes=sorted(kcont.LOOP["shapes"]))
    if launches != {**{k_: 0 for k_ in CONTENTION},
                    LOOP_KERNEL: loop["attempts"]} or loop["events"] < 1:
        raise AssertionError(f"contention: launches {launches} are not one "
                             f"loop kernel per attempt ({loop})")
    return res, dt, launches, loop


def loop_agree_cases():
    """(backoff slots, window slots, k, participating, overrides) of the
    persistent kernel's corners: the dense grid's 1e4 x 64, the retry
    ladder (identical backoffs drain the pool), the ladder of a
    10 000-user, k = 64 round (pools of 512, 4096 — 48 KB of lanes and the
    static buffer: the opt-in edge — and 10 000 lanes), the ladder past
    the shared-memory limit (its last attempt runs on global-memory state),
    the 1000-user round's pool (priority-scaled windows, k = 64), a
    horizon that cuts rows mid-run, and rows with k = 0, a row nobody
    contends in and masked participation."""
    rng = np.random.default_rng(15)
    wide = 2 * kcont.loop_shared_lanes()
    prio = 1.0 + rng.random(1000)
    part = rng.random((6, 3000)) > 0.4
    part[2] = False
    return {
        "dense_1e4x64": (*(a / SLOT_S for a in dense_inputs(
            10_000, 64, seed=10_000)), 8, None, {}),
        "retry_ladder_2x2000": (np.full((2, 2000), 50.0),
                                np.full(2000, 2.5e6), 3, None, {}),
        "retry_ladder_1x10000_k64": (np.full((1, 10_000), 50.0),
                                     np.full(10_000, 2.5e6), 64, None, {}),
        f"past_shared_2x{wide}": (np.full((2, wide), 50.0),
                                  np.full(wide, 2.5e6), 3, None, {}),
        "u1000_pool": (rng.uniform(0, 1, (1, 1000)) * 1024 / prio,
                       1024 / prio, 64, None, {}),
        "tiny_max_sim_slots": (rng.uniform(0, 400, (16, 500)),
                               np.full(500, 400.0), 8, None,
                               dict(max_sim_slots=900)),
        "k0_rows_masked": (rng.uniform(0, 1500, (6, 3000)),
                           np.full(3000, 1500.0),
                           np.array([8, 0, 5, 64, 0, 1]), part, {}),
    }


def contend(bo, win, k, part, kw, **hooks):
    """One ``device_contend_batch`` with LOOP and the launch counts set to
    0 just before and read just after: (result, seconds, LOOP, launches)."""
    torch.cuda.synchronize()
    kcont.reset_loop_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = kcont.device_contend_batch(bo, win, k, part, **kw, **hooks)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    loop = dict(kcont.LOOP, shapes=sorted(kcont.LOOP["shapes"]))
    return res, dt, loop, dict(ops.LAUNCHES)


def same_result(label, got, want, what):
    for f in LOOP_FIELDS:
        if not np.array_equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"contention_kernel_loop_agree {label}: {f} "
                                 f"differs from {what}")


def phase_contention_kernel_loop_agree():
    """The persistent kernel (one launch an attempt) against the plain
    Python loop on the card, fed the same counter draws: every field,
    the per-row events of every attempt and the attempts bit-equal; the
    loop with the three pass kernels as its event op equal too (so they
    stay on a path); one case equal to the ``device="cpu"`` run. Returns
    (every pool shape run, the three passes' launches on their path)."""
    out, shapes, passes = {}, set(), None
    for label, (bo, win, k, part, cfg) in loop_agree_cases().items():
        kw = dict(entropy=1234, call_index=5, tx_slots=50,
                  max_backoff_doublings=5, max_sim_slots=2_000_000,
                  device=DEV)
        kw.update(cfg)
        got, t_kernel, lk, launches = contend(bo, win, k, part, kw)
        want, t_plain, lp, _ = contend(
            bo, win, k, part, kw, event_op=ref.contention_event_ref,
            draw=kcont.counter_draw(kw["entropy"], kw["call_index"], DEV))
        same_result(label, got, want, "the plain loop")
        if lk["row_events"] != lp["row_events"] \
                or lk["attempts"] != lp["attempts"]:
            raise AssertionError(f"contention_kernel_loop_agree {label}: "
                                 f"per-row events {lk['row_events']} vs "
                                 f"{lp['row_events']}")
        if launches[LOOP_KERNEL] != lk["attempts"] \
                or any(launches[c] for c in CONTENTION):
            raise AssertionError(f"contention_kernel_loop_agree {label}: "
                                 f"launches {launches}")
        shapes |= set(lk["shapes"])
        row = dict(kernel_s=t_kernel, plain_loop_s=t_plain,
                   attempts=lk["attempts"], events=lk["events"],
                   max_row_events=[max(r) for r in lk["row_events"]],
                   pool_shapes=lk["shapes"],
                   delivered=int(got.n_delivered.sum()),
                   collisions=int(got.collisions.sum()))
        if label == "retry_ladder_2x2000":
            three, t3, l3, passes = contend(bo, win, k, part, kw,
                                            event_op=ops.contention_event)
            same_result(label, three, got, "the three-pass loop")
            if not passes["contention_min"] == l3["events"] >= 1:
                raise AssertionError(f"three-pass loop: launches {passes}")
            passes = {c: passes[c] for c in CONTENTION}
            row.update(three_pass_loop_s=t3, three_pass_launches=passes)
        if label == "u1000_pool":
            cpu = kcont.device_contend_batch(bo, win, k, part,
                                             **dict(kw, device="cpu"))
            same_result(label, got, cpu, "the device='cpu' run")
            row["equals_cpu_run"] = True
        out[label] = row
    lanes = kcont.loop_shared_lanes()
    if not any(m > lanes for _, m in shapes):
        raise AssertionError("contention_kernel_loop_agree: no pool past "
                             "the shared-memory limit ran")
    for label in ("retry_ladder_2x2000", f"past_shared_2x{2 * lanes}"):
        if out[label]["attempts"] < 2:
            raise AssertionError(f"{label}: the retry ladder was not "
                                 "climbed")
    emit("contention_kernel_loop_agree", bit_equal=True,
         fields=[*LOOP_FIELDS, "row_events", "attempts"],
         shared_lanes=lanes, cases=out)
    return shapes, passes


def phase_contention_dense():
    """``benchmarks/contention_bench.py``'s dense grid through
    ``CSMASimulator(backend="device")``: against numpy at 1e4 x 64 (the
    bars of ``tests/test_contention_device.py``'s 1e5 test), invariants
    at 1e5 x 64 and 1e6 x 8."""
    k, out, shapes = 8, {}, set()
    for n, lanes in ((10_000, 64), (100_000, 64), (1_000_000, 8)):
        backoffs, windows = dense_inputs(n, lanes, seed=n)
        sim = CSMASimulator(CSMAConfig(), seed=0, backend="device",
                            device=DEV)
        res, first_s, _, loop = contention_run(sim, backoffs, windows, k)
        shapes.update(map(tuple, loop["shapes"]))
        steady = []
        for _ in range(2):
            res, dt, launches, loop = contention_run(sim, backoffs, windows,
                                                     k)
            steady.append(dt)
            shapes.update(map(tuple, loop["shapes"]))
        check_contention_invariants(f"contention_dense {n}", res, k)
        row = dict(contenders=n, lanes=lanes, first_call_s=first_s,
                   steady_s=min(steady), events=loop["events"],
                   attempts=loop["attempts"],
                   launches=launches,
                   launches_per_event=sum(launches.values())
                   / loop["events"],
                   pool_width=max(m for _, m in loop["shapes"]),
                   rounds_per_s=lanes / min(steady),
                   delivered=int(res.n_delivered.sum()),
                   collisions=int(res.collisions.sum()),
                   mean_elapsed_slots=float(res.elapsed_slots.mean()),
                   numpy_s=None)
        if n == 10_000:
            t0 = time.perf_counter()
            host = CSMASimulator(CSMAConfig(), seed=0).contend_batch(
                backoffs, windows, k_target=k, seeds=list(range(lanes)))
            row["numpy_s"] = time.perf_counter() - t0
            if not np.array_equal(res.n_delivered, host.n_delivered):
                raise AssertionError("contention_dense: deliveries differ "
                                     "from numpy")
            dc, hc = int(res.collisions.sum()), int(host.collisions.sum())
            if abs(dc - hc) > max(20, int(0.5 * hc)):
                raise AssertionError(f"contention_dense: collisions {dc} "
                                     f"vs numpy {hc}")
            a, b = res.elapsed_slots.mean(), host.elapsed_slots.mean()
            if abs(a - b) > 0.5 * max(a, b):
                raise AssertionError(f"contention_dense: mean airtime {a} "
                                     f"vs numpy {b}")
            row.update(numpy_collisions=hc,
                       numpy_mean_elapsed_slots=float(b))
        out[f"{n}x{lanes}"] = row
        del backoffs, windows
    emit("contention_dense", k=k, regime="CW = n/2 slots",
         invariants="unique participating winners, exactly k, increasing "
                    "finish slots", sizes=out)
    return shapes


# ----------------------------------------------------------------- timing
def time_ms(fn, reps, samples=5, warmup=3):
    """Median over ``samples`` of (CUDA-event time of ``reps`` calls) /
    ``reps``, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def graph_ms(fn, reps=20):
    """Device time of one call: ``reps`` calls captured into a CUDA
    graph and replayed, so no launch waits for the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, reps=3) / reps


def rotating(make, n_sets):
    """``n_sets`` independent input sets, visited in turn, so that a call
    does not find its operands in the L2 cache."""
    sets = [make(i) for i in range(n_sets)]
    state = {"i": 0}

    def nxt():
        state["i"] = (state["i"] + 1) % n_sets
        return sets[state["i"]]
    return nxt


def measure(kernel, plain, library, nbytes, ops_count, reps, plain_reps,
            graph_reps=20):
    """Kernel and library call, each eager and from a CUDA graph (the
    graph times compare like with like), the plain version, and the
    bound: the larger of bytes over the HBM rate and operations over the
    f32 rate outside the tensor cores (the integer passes are counted at
    that rate too; bytes bound every kernel here)."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_count / F32_FLOPS_PER_S * 1e3
    return dict(
        ms=time_ms(kernel, reps),
        graph_ms=graph_ms(kernel, graph_reps),
        plain_ms=time_ms(plain, plain_reps, samples=3, warmup=1),
        library_ms=(time_ms(library, reps) if library else None),
        library_graph_ms=(graph_ms(library, graph_reps) if library
                          else None),
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        bytes=nbytes, ops=ops_count)


def bench_contention(B, N, reps):
    """The three passes at one (B, N) pool shape, on a pool as the loop
    holds it (operands stay in L2, as they do in the loop)."""
    cnt, live, dbl, win, rand = event_inputs(B, N, seed=B * N, kind="loop")
    step = kcont.contention_min_cuda(cnt, live)
    nexp, _ = kcont.contention_expiry_cuda(cnt, live, step)
    big = torch.tensor(BIG, dtype=torch.int32, device=DEV)
    lanes, plain_reps = B * N, max(1, min(reps, 50))
    return {
        # reads counter + live flag a lane, writes (B,) int32
        "contention_min": measure(
            lambda: kcont.contention_min_cuda(cnt, live),
            lambda: ref.contention_min_ref(cnt, live),
            lambda: torch.where(live, cnt, big).amin(1),
            5 * lanes + 4 * B, 2 * lanes, reps, plain_reps),
        # reads counter + live flag a lane and step, writes two (B,) int32
        "contention_expiry": measure(
            lambda: kcont.contention_expiry_cuda(cnt, live, step),
            lambda: ref.contention_expiry_ref(cnt, live, step),
            None, 5 * lanes + 12 * B, 4 * lanes, reps, plain_reps),
        # reads 17 bytes a lane and step / nexp, writes 9 bytes a lane
        "contention_transition": measure(
            lambda: kcont.contention_transition_cuda(
                cnt, live, dbl, win, rand, step, nexp, 5),
            lambda: ref.contention_transition_ref(
                cnt, live, dbl, win, rand, step, nexp, 5),
            None, 26 * lanes + 8 * B, 10 * lanes, reps, plain_reps)}


#: the pools the engine's contention calls build, as (rows B, contenders
#: N, winners k): the paper cell, the 1000-user round, the dense 1e4 x 64
LOOP_POOLS = ((1, 10, 2), (1, 1000, 64), (64, 10_000, 8))


def bench_loop(B, N, k):
    """The persistent loop kernel on one attempt at the pool an engine
    call of B rows, N contenders and k winners builds (the dense regime,
    CW = N/2 slots): kernel eager and from a CUDA graph, the plain Python
    loop on the card (held bit-equal first), and the bound from this
    run's events: 12 bytes a lane read once, the (B,) thresholds and k,
    the packed result written; three operations a lane an event (the
    scan's compare-select and the redraw test). No PyTorch call computes
    a contention loop: no library yardstick."""
    backoffs, windows = dense_inputs(N, B, seed=N + B)
    counters = np.minimum(np.maximum(0, np.round(backoffs / SLOT_S)),
                          BIG).astype(np.int32)
    M = min(N, max(128, 8 * k))
    pool = kcont.gather_pool(
        counters, np.broadcast_to(windows / SLOT_S, (B, N)), M)
    args = [torch.from_numpy(np.array(a, dtype=d, order="C")).to(DEV)
            for a, d in zip(pool, (np.int32, np.float32, np.int32, np.int32))]
    k_dev = torch.full((B,), k, dtype=torch.int32, device=DEV)
    kw = dict(k_max=k, tx_slots=50, max_doublings=5,
              max_sim_slots=2_000_000)
    key = kcont.counter_key(7, 0)

    def kernel():
        return kcont.contention_loop_cuda(*args, k_dev, key=key, **kw)

    def plain():
        return kcont._contend_device(
            *args, k_dev, draw=lambda ev, b, m: kcont.counter_uniform(
                key, ev, b, m, DEV),
            event_op=ref.contention_event_ref, **kw)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"contention_loop at {(B, M)}: not bit-equal "
                             "to the plain loop")
    events = got[:, kcont.HEAD.index("events")]
    row = measure(kernel, plain, None,
                  12 * B * M + 8 * B + 4 * got.numel(),
                  3 * M * int(events.sum()), reps=20, plain_reps=1,
                  graph_reps=5)
    row.update(pool=[B, M], k=k, max_row_events=int(events.max()),
               events_per_us=float(events.max()) / (row["graph_ms"] * 1e3))
    return row


def bench_kernels(U, shape, dtype, reps, K=2):
    """Times at one leaf shape: kernel (eager, cold operands), kernel
    from a CUDA graph, plain version, library call; plus the bound. The
    gather, AirComp and robust merges read ``K`` rows (the round's
    winners, spread over the stack); in bf16 the library calls take bf16
    operands too."""
    n = int(np.prod(shape))
    item = torch.empty((), dtype=dtype).element_size()
    set_bytes = (2 * U + K) * n * item
    n_sets = max(2, min(16, int(128e6 // set_bytes) + 1))
    winners = [U - 1, 0]                       # k_per_round = 2
    idx, w = merge_inputs(U, winners, k_pad=2)
    alphas = torch.zeros(U, dtype=torch.float32, device=DEV)
    alphas[idx.long()] = w
    # every row live and shrunk but the first (the passthrough)
    idx_k, a_k, c_k, s_k = channel_merge_inputs(U, K, seed=7, zero=False)
    w_air, scale = ops.aircomp_weights(a_k, c_k, DEV)
    sc = float(scale)
    a_lib, w_air_lib, alphas_lib = (v.to(dtype) for v in (a_k, w_air,
                                                           alphas))

    def make(i):
        # stack, grads, glob, K gathered rows, the noise plane, and the
        # noise in the stack's dtype for the library call
        nz = randn(500 + i, shape, torch.float32)
        return (randn(100 + i, (U,) + shape, dtype),
                randn(200 + i, (U,) + shape, dtype),
                randn(300 + i, shape, dtype),
                randn(400 + i, (K,) + shape, dtype), nz, nz.to(dtype))
    nxt = rotating(make, n_sets)
    res = {}

    def record(name, kernel, plain, library, nbytes, flops, plain_reps):
        res[name] = measure(kernel, plain, library, nbytes, flops, reps,
                            plain_reps)

    def sgd_k():
        p, g, *_ = nxt()
        ops.fused_sgd(p, g, LR)

    def sgd_p():
        p, g, *_ = nxt()
        ref.fused_sgd_ref(p, g, LR)

    def sgd_l():
        # in place, as the kernel: the out-of-place torch.add writes a
        # fresh buffer that a graph's pool hands back each call, so its
        # writes stay in L2 (timed beside it, not as the yardstick)
        p, g, *_ = nxt()
        p.add_(g, alpha=-LR)

    record("fused_sgd", sgd_k, sgd_p, sgd_l, 3 * U * n * item, 2 * U * n,
           reps)
    res["fused_sgd"]["torch_add_out_of_place_graph_ms"] = graph_ms(
        lambda: torch.add(*nxt()[:2], alpha=-LR))

    def gc_k():
        s, _, g, *_ = nxt()
        ops.gather_combine(s, idx_k, a_k, g)

    def gc_p():
        s, _, g, *_ = nxt()
        ref.gather_combine_ref(s, idx_k, a_k, g)

    def gc_l():
        # the gather and the weighted sum: index_select, then one gemv
        s, *_ = nxt()
        return torch.mv(torch.index_select(s, 0, idx_k.long())
                        .reshape(K, n).T, a_lib)

    # every weight is nonzero: K rows read, one written, glob unread
    record("gather_combine", gc_k, gc_p, gc_l, (K + 1) * n * item,
           2 * K * n, max(1, min(reps, 2000 // K)))

    def fa_k():
        s, *_ = nxt()
        ops.fedavg_combine(s, alphas)

    def fa_p():
        s, *_ = nxt()
        ref.fedavg_combine_ref(s, alphas)

    def fa_l():
        s, *_ = nxt()
        torch.mv(s.reshape(U, n).T, alphas_lib)

    # masked rows are not read: this run's alphas have two nonzero rows
    record("fedavg_combine", fa_k, fa_p, fa_l, (2 + 1) * n * item,
           2 * 2 * n, max(1, min(reps, 2000 // U)))

    def air_k():
        # the kernel alone: the merge forms (w, scale) once, not per leaf
        s, _, _, _, nz, _ = nxt()
        ops.aircomp_combine_weighted(s, w_air, scale, nz, idx=idx_k)

    def air_p():
        s, _, _, _, nz, _ = nxt()
        ref.aircomp_combine_ref(torch.index_select(s, 0, idx_k.long()),
                                w_air, nz, scale[0])

    def air_l():
        # on the K rows already gathered: one call, (noise + rows^T w) sc
        _, _, _, rows, _, nz_lib = nxt()
        return torch.addmv(nz_lib.reshape(n), rows.reshape(K, n).T,
                           w_air_lib, beta=sc, alpha=sc)

    # K rows read, the noise plane (f32) read, one plane written
    record("aircomp_combine", air_k, air_p, air_l,
           K * n * item + 4 * n + n * item, 2 * K * n + 2 * n,
           max(1, min(reps, 2000 // K)))

    def rob_k():
        _, _, g, rows, *_ = nxt()
        ops.robust_combine(rows, a_k, s_k, g)

    def rob_p():
        _, _, g, rows, *_ = nxt()
        ref.robust_combine_ref(rows, a_k, s_k, g)

    # sum_k w_k (g + s_k (x_k - g)) = rows^T (w s) + g sum_k w_k (1 - s_k):
    # one call on the gathered rows, its coefficients formed beforehand
    ws_k = (a_k * s_k).to(dtype)
    beta = float((a_k * (1.0 - s_k)).sum())

    def rob_l():
        _, _, g, rows, *_ = nxt()
        return torch.addmv(g.reshape(n), rows.reshape(K, n).T, ws_k,
                           beta=beta)

    # each library call computes its kernel's function, to the rounding of
    # a reordered sum (and, in bf16, of bf16 weights): checked once on one
    # input set, outside the timing
    tol = (dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2e-2, atol=2e-2))
    s0, _, g, rows, nz, nz_lib = nxt()
    for name, lib, plain in (
            ("gather_combine",
             torch.mv(torch.index_select(s0, 0, idx_k.long())
                      .reshape(K, n).T, a_lib),
             ref.gather_combine_ref(s0, idx_k, a_k, g)),
            ("fedavg_combine", torch.mv(s0.reshape(U, n).T, alphas_lib),
             ref.fedavg_combine_ref(s0, alphas)),
            ("aircomp_combine",
             torch.addmv(nz_lib.reshape(n), rows.reshape(K, n).T,
                         w_air_lib, beta=sc, alpha=sc),
             ref.aircomp_combine_ref(rows, w_air, nz, scale[0])),
            ("robust_combine",
             torch.addmv(g.reshape(n), rows.reshape(K, n).T, ws_k,
                         beta=beta),
             ref.robust_combine_ref(rows, a_k, s_k, g))):
        if not torch.allclose(lib.float(), plain.reshape(n).float(), **tol):
            raise AssertionError(f"{name}: the library call does not "
                                 "compute the kernel's function")

    # the K gathered rows and the old global read, one plane written; a
    # shrunk row costs 5 operations an element, the passthrough row 2
    passthrough = int((s_k == 1.0).sum())
    record("robust_combine", rob_k, rob_p, rob_l, (K + 2) * n * item,
           (5 * (K - passthrough) + 2 * passthrough) * n,
           max(1, min(reps, 2000 // K)))
    return res


def bench_delta_norm(U, dtype, reps):
    """``delta_norm_leaves`` at U users: the MLP's fc1.w leaf alone and
    the MLP's four stacked leaves in one launch (a round's priority
    call): kernel eager and from a CUDA graph, the plain version, and the
    bound — every stack and global read once, (U + 1) floats a leaf
    written; three operations an element of each of the U + 1 rows (the
    global's row is its squares). No single PyTorch call computes it: no
    library yardstick."""
    item = torch.empty((), dtype=dtype).element_size()
    out = {}
    for label, shapes in (("fc1w", [(784, 200)]),
                          ("mlp", model_leaves("mlp"))):
        n = sum(int(np.prod(sh)) for sh in shapes)
        set_bytes = (U + 1) * n * item
        nxt = rotating(lambda i: (
            [randn_dev(1200 + 10 * i + l, (U,) + sh, dtype)
             for l, sh in enumerate(shapes)],
            [randn_dev(1600 + 10 * i + l, sh, dtype)
             for l, sh in enumerate(shapes)]),
            max(2, min(16, int(128e6 // set_bytes) + 1)))
        row = measure(lambda: ops.delta_norm_leaves(*nxt()),
                      lambda: ref.delta_norm_leaves_ref(*nxt()), None,
                      set_bytes + 4 * (U + 1) * len(shapes),
                      3 * (U + 1) * n, reps, max(1, min(reps, 20)))
        row.update(leaves=[[U, *sh] for sh in shapes],
                   share_of_bound=row["bound_ms"] / row["graph_ms"])
        out[label] = row
        del nxt
        torch.cuda.empty_cache()
    return out


def bench_server_opt(dtype, reps):
    """``server_opt_leaves``, FedAdam (the kind with the most work): the
    MLP's fc1.w leaf alone, the MLP's four leaves in one launch (an
    objective merge), and one 16 M-element leaf, where bytes, not the
    launch, bound it. Operands rotated out of L2; the bound: four
    leaf-shaped reads and three writes, 13 operations an element. No
    single PyTorch call computes this law: no library yardstick."""
    item = torch.empty((), dtype=dtype).element_size()
    adam = SERVER_KINDS[2]
    adam_t = torch.tensor(adam)
    out = {}
    for label, shapes in (("fc1w", [(784, 200)]),
                          ("mlp", model_leaves("mlp")),
                          ("16M", [(1 << 24,)])):
        n = sum(int(np.prod(sh)) for sh in shapes)
        nxt = rotating(lambda i: [
            [randn_dev(2000 + 100 * i + 10 * j + l, sh, dtype).abs()
             if j == 3 else randn_dev(2000 + 100 * i + 10 * j + l, sh, dtype)
             for l, sh in enumerate(shapes)] for j in range(4)],
            max(2, min(64, int(160e6 // (4 * n * item)) + 1)))

        def plain():
            for leaf in zip(*nxt()):
                ref.server_opt_combine_ref(*leaf, adam_t)

        row = measure(lambda: ops.server_opt_leaves(*nxt(), adam), plain,
                      None, 7 * n * item, 13 * n, reps,
                      max(1, min(reps, 20)))
        row.update(leaves=[list(sh) for sh in shapes],
                   share_of_bound=row["bound_ms"] / row["graph_ms"])
        out[label] = row
        del nxt
        torch.cuda.empty_cache()
    return out


def bench_sgd_step(U, dtype, reps):
    """One local SGD step of the MLP at U users: its four stacked leaves
    in one ``fused_sgd_leaves`` launch, against ``torch._foreach_add_``
    (one call that updates the list in place) and the plain version leaf
    by leaf; the bound: every leaf's p and g read once, p written."""
    shapes = [(U,) + tuple(l.shape) for l in
              tree_leaves(get_paper_model("mlp")[0](0, device="cpu"))]
    n = sum(int(np.prod(sh)) for sh in shapes)
    item = torch.empty((), dtype=dtype).element_size()
    nxt = rotating(lambda i: tuple(
        [randn(700 + 40 * i + 10 * j + leaf, sh, dtype)
         for leaf, sh in enumerate(shapes)] for j in range(2)),
        max(2, min(16, int(128e6 // (2 * n * item)) + 1)))

    def kernel():
        ops.fused_sgd_leaves(*nxt(), LR)

    def plain():
        for p, g in zip(*nxt()):
            ref.fused_sgd_ref(p, g, LR)

    def library():
        torch._foreach_add_(*nxt(), alpha=-LR)

    row = measure(kernel, plain, library, 3 * n * item, 2 * n, reps, reps)
    row.update(leaves=[list(sh) for sh in shapes])
    return row


#: (R, N, C) shapes ``token_sum`` takes on the --arch paths: the reduced
#: models' norm-scale gradients (d 256, and MLA's latent ranks 64 / 64),
#: the loss mean (nll and mask: C = 2), the MoE's mean router probability
#: (E = 4) and its aux sum (4 values), over a user's 4096 tokens, at the
#: run's 10 rows and a 3-lane sweep's 30, and the evaluation's 2048 tokens
#: (R = 1); the largest: the silo's norms at d 3072, Mamba-2's widest
#: parameter gradient and its long-N ones; then ragged N and C around
#: the kernel's lanes, runs and chunks, and a long N
TOKEN_SUM_SHAPES = [(10, 4096, 256), (30, 4096, 256), (10, 4096, 64),
                    (30, 4096, 64), (10, 4096, 2), (30, 4096, 2),
                    (10, 4096, 4), (30, 4096, 4), (10, 4, 1), (30, 4, 1),
                    (1, 2048, 2), (1, 2048, 4), (1, 4, 1),
                    (4, 4096, 3072), (30, 4096, 2176), (10, 131072, 16),
                    (30, 131072, 16), (3, 37, 5), (2, 1, 33), (4, 31, 31),
                    (5, 129, 40), (2, 33, 65), (3, 5000, 6),
                    (1, 1048576, 3)]
#: shapes checked with edge values in columns 0-3: all -0.0 (+0.0 where
#: N is not a power of two: the padding's zeros are added; -0.0 where it
#: is), one inf, one nan, and +inf with -inf (nan)
TOKEN_SUM_EDGES = [(3, 3, 4), (2, 4, 4), (3, 37, 5), (2, 4096, 8),
                   (4, 5000, 16), (2, 131072, 4), (2, 4096, 260)]
#: every (R, N, C) shape the --arch rounds (``LLM_CELLS``: the run, its
#: 3-lane sweep, the evaluation) and ``silo_round_full`` launch
#: ``token_sum`` with; the full run asserts ``recording_token_sums`` saw
#: exactly these, and ``--token-sum-only`` times them
TOKEN_SUM_CENSUS = [
    (1, 4, 1), (1, 2048, 2), (1, 2048, 4), (4, 4096, 2), (4, 4096, 3072),
    (10, 4, 1), (10, 4096, 2), (10, 4096, 4), (10, 4096, 16),
    (10, 4096, 64), (10, 4096, 256), (10, 4096, 512), (10, 4096, 544),
    (10, 4096, 2176), (10, 131072, 16), (30, 4, 1), (30, 4096, 2),
    (30, 4096, 4), (30, 4096, 16), (30, 4096, 64), (30, 4096, 256),
    (30, 4096, 512), (30, 4096, 544), (30, 4096, 2176), (30, 131072, 16)]


def edge_columns(x):
    """``x`` with columns 0-3 set to the ``TOKEN_SUM_EDGES`` values."""
    N = x.shape[1]
    x[:, :, 0] = -0.0
    x[:, N // 2, 1] = float("inf")
    x[:, N - 1, 2] = float("nan")
    x[:, 0, 3] = float("inf")
    x[:, N - 1, 3] = float("-inf")
    return x


def check_token_sum():
    """``token_sum`` against its plain version (the same tree of
    elementwise adds on the card) at ``TOKEN_SUM_SHAPES`` and, with
    -0.0, inf and nan columns, at ``TOKEN_SUM_EDGES``: bit for bit, and
    every row's bits the same summed alone as in the stack. Returns
    (max abs error over the finite shapes, bit_equal)."""
    worst = 0.0
    cases = [(s, False) for s in TOKEN_SUM_SHAPES] + \
        [(s, True) for s in TOKEN_SUM_EDGES]
    for i, ((R, N, C), edges) in enumerate(cases):
        x = randn(6000 + i, (R, N, C), torch.float32)
        if edges:
            x = edge_columns(x)
        got = ops.token_sum(x)
        want = ref.token_sum_ref(x)
        name = f"token_sum {(R, N, C)}{' edges' if edges else ''}"
        if edges:
            if not same_bits(got, want):
                raise AssertionError(f"{name}: not bit-equal to the plain "
                                     "version")
        else:
            worst = max(worst, bit_check(name, got, want, torch.float32))
        alone = torch.cat([ops.token_sum(x[r:r + 1]) for r in range(R)])
        if not same_bits(alone, got):
            raise AssertionError(f"{name}: rows summed alone differ from "
                                 "the stack's bits")
        del x, got, want, alone
    torch.cuda.empty_cache()
    return worst, True


def time_token_sums(shapes, calls=None, where=None):
    """``token_sum`` at each (R, N, C) of ``shapes``: the kernel's and
    ``torch.sum(dim=1)``'s time from a CUDA graph and the byte bound (the
    input read once, the output written once); ``calls`` / ``where``:
    each shape's calls and the phases that made them."""
    rows = []
    for i, shape in enumerate(shapes):
        R, N, C = shape
        nxt = rotating(lambda k: randn(7000 + 10 * i + k, shape,
                                       torch.float32), 4)
        nbytes = 4 * R * C * (N + 1)
        rows.append(dict(
            shape=list(shape), graph_ms=graph_ms(lambda: ops.token_sum(nxt())),
            torch_sum_graph_ms=graph_ms(lambda: torch.sum(nxt(), dim=1)),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes,
            **({} if calls is None else dict(calls=calls[shape],
                                             phases=where[shape]))))
        torch.cuda.empty_cache()
    return rows


def with_plans(rows):
    """``time_token_sums``' rows, each with its launch's plan."""
    for r in rows:
        r["plan"] = ktsum.token_sum_plan(*r["shape"])._asdict()
    return rows


def bench_token_sum(R=10, N=4096, C=256, reps=200):
    """``token_sum`` at the --arch step's widest call (a norm scale's
    gradient over a user's 4096 tokens, d 256, 10 users): the kernel,
    the plain version (the tree of elementwise adds on the card) and
    ``torch.sum(dim=1)`` (torch's own reduction, whose bits follow R);
    the bound: the input read once, the output written once."""
    nxt = rotating(lambda i: randn(6100 + i, (R, N, C), torch.float32), 8)
    row = measure(lambda: ops.token_sum(nxt()),
                  lambda: ref.token_sum_ref(nxt()),
                  lambda: torch.sum(nxt(), dim=1),
                  4 * R * C * (N + 1), R * C * N, reps, reps)
    row.update(shape=[R, N, C])
    return row


def bench_grad_copy(U=10, batch=32):
    """The CNN's gradient copy: ``vmap(grad)`` hands a conv weight's
    gradient back as a permuted view (the weight is HWIO, the convolution
    reads OIHW), and ``sgd_update`` makes it contiguous before the SGD
    launch. On the gradients of one real step at U users, each
    non-contiguous leaf's ``.contiguous()`` from a CUDA graph against its
    bound (the leaf read once and written once)."""
    init, apply = get_paper_model("cnn")
    stack = tree_map(lambda p: p.unsqueeze(0).expand((U,) + tuple(p.shape))
                     .contiguous(), init(0, device=DEV))
    gen = torch.Generator(device="cpu").manual_seed(5)
    data = {"x": torch.randn((U, batch, 28, 28, 1), generator=gen).to(DEV),
            "y": torch.randint(0, 10, (U, batch), generator=gen).to(DEV)}

    def loss_fn(params, b):
        return torch.nn.functional.cross_entropy(apply(params, b["x"]),
                                                 b["y"])

    grads = torch.func.vmap(torch.func.grad(loss_fn))(stack, data)
    rows = []
    for g in tree_leaves(grads):
        if g.is_contiguous():
            continue
        nbytes = 2 * g.numel() * g.element_size()
        rows.append(dict(shape=list(g.shape), stride=list(g.stride()),
                         graph_ms=graph_ms(lambda g=g: g.contiguous()),
                         bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                         bytes=nbytes))
    return dict(leaves=rows, step_graph_ms=sum(r["graph_ms"] for r in rows),
                step_bound_ms=sum(r["bound_ms"] for r in rows))


# ------------------------------------------------ the CNN's first block
#: (label, stack rows — None: an unstacked call —, B, H, W, C) into 128
#: channels: the cell's local step, one user (the per-client trainer), the
#: evaluation's batches of 256 and its last of 232, the CIFAR variant
CONV_POOL_SHAPES = (("cell_U10", 10, 32, 28, 28, 1),
                    ("U1", 1, 32, 28, 28, 1),
                    ("eval_B256", None, 256, 28, 28, 1),
                    ("eval_B232", None, 232, 28, 28, 1),
                    ("cifar_U10", 10, 32, 32, 32, 3))
CONV_POOL_O = 128
#: the evaluation's first-block launches a call: the paper cell's test
#: examples in ``make_accuracy_eval``'s batches of 256
CNN_EVAL_BATCHES = -(-launch_train.make_parser().parse_args([]).n_test
                     // 256)


def conv_pool_inputs(R, B, H, W, C, seed):
    """The block's operands on the card (weights and bias at the scale
    of ``init_cnn``'s conv1 after some training), and a cotangent of its
    output."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    lead = () if R is None else (R,)
    O = CONV_POOL_O
    x = torch.randn(lead + (B, H, W, C), generator=g, device=DEV)
    w = 0.05 * torch.randn(lead + (5, 5, C, O), generator=g, device=DEV)
    b = 0.05 * torch.randn(lead + (O,), generator=g, device=DEV)
    cot = (B,) + lead + (O, H // 2, W // 2)
    return x, w, b, torch.randn(cot, generator=g, device=DEV)


def conv_pool_work(R, B, H, W, C):
    """(forward FLOP, bytes, backward FLOP, bytes). The forward: every
    tap of every conv output (2 * 25 * C a conv output), x, w and b read
    once, the pooled output (f32) and its codes (1 byte) written once.
    The backward: the winner's 25 * C taps a pooled output and one add
    into db; the cotangent, the codes and x read once, dw and db written
    once."""
    R, O, P = R or 1, CONV_POOL_O, (H // 2) * (W // 2)
    x_bytes, w_bytes, outs = 4 * R * B * H * W * C, 4 * R * (25 * C + 1) \
        * O, R * B * O * P
    return (2 * R * B * O * H * W * 25 * C, x_bytes + w_bytes + 5 * outs,
            (2 * 25 * C + 1) * outs, 5 * outs + x_bytes + w_bytes)


def _stacked(t, axis, R):
    return t if R is not None else t.unsqueeze(axis)


def _pre_pool(x, w, b):
    """One user's relu(conv + b) (B, O, H, W), the plain chain's."""
    y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2),
                                   w.permute(3, 2, 0, 1), padding=2)
    return torch.relu(y + b.reshape(1, -1, 1, 1))


def check_conv_pool(label, R, B, H, W, C, seed):
    """The kernel pair against the plain version on the card. Forward:
    f32 rtol 1e-5, atol 1e-6; where a winner code differs from the plain
    max-pool's, the plain activation at the kernel's winner must be the
    plain maximum within that bar (a near-tie), and "none" only where the
    plain maximum is within 1e-6 of 0. Backward, on the kernel's own
    codes: each dw / db sum within 1e-5 of its absolute sum of the exact
    (float64) sum over the same winners (rule 4's f32 rtol on the sum's
    condition); the plain version's own f32 backward, on its own codes,
    read on the same yardstick."""
    x, w, b, gz = conv_pool_inputs(R, B, H, W, C, seed)
    out, codes = ops.conv_pool(x, w, b)
    p_out, p_codes = ref.conv_pool_ref(x, w, b)
    torch.cuda.synchronize()
    fwd_err = float((out - p_out).abs().max())
    if not torch.allclose(out, p_out, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"conv_pool {label}: forward off by {fwd_err}")
    differ = codes != p_codes
    if differ.any():
        y = (_pre_pool(x, w, b) if R is None else torch.func.vmap(
            _pre_pool, out_dims=1)(x, w, b))
        H2, W2 = H // 2, W // 2
        win = y[..., :2 * H2, :2 * W2].unflatten(-2, (H2, 2)).unflatten(
            -1, (W2, 2)).transpose(-3, -2).flatten(-2)
        at = win.gather(-1, codes.clamp(max=3).long().unsqueeze(-1))[..., 0]
        at = torch.where(codes == 4, torch.zeros_like(at), at)
        bad = differ & ((at - p_out).abs() > 1e-6 + 1e-5 * p_out.abs())
        if bad.any():
            raise AssertionError(f"conv_pool {label}: {int(bad.sum())} "
                                 "winners differ beyond a near-tie")
    dw, db = ops.conv_pool_grad(gz, x, w, b, codes)
    xs, gs = _stacked(x, 0, R), _stacked(gz, 1, R)

    def rel(dw, db, cs):
        e_dw, e_db = ref.conv_pool_grad_codes_ref(gs.double(), xs, cs)
        s_dw, s_db = ref.conv_pool_grad_codes_ref(gs.abs().double(),
                                                  xs.abs(), cs)
        return max(float(((_stacked(dw, 0, R).double() - e_dw).abs()
                          / s_dw.clamp_min(1e-300)).max()),
                   float(((_stacked(db, 0, R).double() - e_db).abs()
                          / s_db.clamp_min(1e-300)).max()))
    grad_rel = rel(dw, db, _stacked(codes, 1, R))
    p_dw, p_db = ref.conv_pool_grad_ref(gz, x, w, b)
    plain_rel = rel(p_dw, p_db, _stacked(p_codes, 1, R))
    if grad_rel > 1e-5 or not (dw.is_contiguous() and db.is_contiguous()):
        raise AssertionError(f"conv_pool_grad {label}: {grad_rel} of the "
                             "absolute sum")
    return dict(forward_max_abs_err=fwd_err,
                codes_differ=int(differ.sum()), codes=int(codes.numel()),
                codes_none=int((codes == 4).sum()),
                grad_max_rel_to_abs_sum=grad_rel,
                plain_grad_max_rel_to_abs_sum=plain_rel,
                grad_vs_plain_max_abs=max(float((dw - p_dw).abs().max()),
                                          float((db - p_db).abs().max())))


def conv_pool_row_bits(seed, E=3):
    """A user's forward, codes, dw and db: the same bits alone, in the
    cohort of U and in a sweep's E x U stack, at the cell's shape (the
    first of ``CONV_POOL_SHAPES``); and the cohort's bits on every other
    visible card equal to ``cuda:0``'s (each card needs its own
    shared-memory opt-in). Returns the cards read."""
    _, U, B, H, W, C = CONV_POOL_SHAPES[0]
    x, w, b, gz = conv_pool_inputs(E * U, B, H, W, C, seed)

    def run(rows, dev=DEV):
        xs, ws, bs, gs = (t.to(dev) for t in (x[rows], w[rows], b[rows],
                                              gz[:, rows]))
        with torch.cuda.device(xs.device):
            o, c = ops.conv_pool(xs, ws, bs)
            dw, db = ops.conv_pool_grad(gs, xs, ws, bs, c)
        return [t.to(DEV) for t in (o.transpose(0, 1), c.transpose(0, 1),
                                    dw, db)]
    full, cohort = run(slice(0, E * U)), run(slice(0, U))
    for r in (0, U - 1):
        alone = run(slice(r, r + 1))
        if not all(torch.equal(a[0], f[r]) and torch.equal(a[0], c[r])
                   for a, f, c in zip(alone, full, cohort)):
            raise AssertionError("conv_pool: a user's bits follow the rows "
                                 "beside it")
    cards = torch.cuda.device_count()
    for i in range(1, cards):
        there = run(slice(0, U), torch.device("cuda", i))
        if not all(torch.equal(a, c) for a, c in zip(there, cohort)):
            raise AssertionError(f"conv_pool: cuda:{i} gives other bits "
                                 "than cuda:0")
    return cards


def _parent_block(x, w, b):
    return torch.nn.functional.max_pool2d(_pre_pool(x, w, b), 2)


def bench_conv_pool(R, B, H, W, C, reps=50):
    """The kernel pair eager and from a CUDA graph, the plain version
    (forward with its codes; the vjp with its recomputed forward), and
    the parent's chain as a local step ran it (``library_ms``: the block
    under vmap with autograd's graph, then autograd's backward for w and
    b; an unstacked call under no_grad, as the evaluation runs it),
    against the bound (``conv_pool_work``), in ms a call."""
    x, w, b, gz = conv_pool_inputs(R, B, H, W, C, seed=7)
    out, codes = ops.conv_pool(x, w, b)
    f_flop, f_bytes, b_flop, b_bytes = conv_pool_work(R, B, H, W, C)
    stacked = R is not None
    wr, br = w.clone().requires_grad_(), b.clone().requires_grad_()
    chain = (torch.func.vmap(_parent_block, out_dims=1) if stacked
             else _parent_block)

    def parent_fwd():
        if stacked:
            return chain(x, wr, br)
        with torch.no_grad():
            return chain(x, w, b)

    def row(kernel, plain, parent, nbytes, flop):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flop / F32_FLOPS_PER_S * 1e3
        return dict(ms=time_ms(kernel, reps), graph_ms=graph_ms(kernel),
                    plain_ms=time_ms(plain, max(reps // 5, 3), samples=3,
                                     warmup=1),
                    library_ms=time_ms(parent, reps),
                    bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    bytes=nbytes, ops=flop)
    out = dict(forward=row(lambda: ops.conv_pool(x, w, b),
                           lambda: ref.conv_pool_ref(x, w, b), parent_fwd,
                           f_bytes, f_flop))
    if stacked:
        p_out = chain(x, wr, br)
        out["backward"] = row(
            lambda: ops.conv_pool_grad(gz, x, w, b, codes),
            lambda: ref.conv_pool_grad_ref(gz, x, w, b),
            lambda: torch.autograd.grad(p_out, (wr, br), gz,
                                        retain_graph=True),
            b_bytes, b_flop)
    return out


def cnn_contracts(rounds, *extra):
    """The paper CNN's rule-4 runs on the card, ``rounds`` rounds each:
    a 3-seed sweep against its lanes' sequential runs, the cohort split
    2-way on one card against no mesh, and, with more than one card
    visible, a sweep of one seed a card split over every card
    (``cohort_mesh()``, a lane a card) against the same sweep unsplit
    (``route_gap`` each). Returns (the gaps by run, the launches by
    run, the local steps of a run)."""
    base = paper_engine("cnn", rounds, *extra)
    cohort = cohort_of(base)
    steps = max(1, base.backend.num_examples(0) // base.spec.batch_size) \
        * base.spec.local_epochs * rounds
    gaps, launches, runs = {}, {}, {}

    def run(key, eng, call):
        res, _, launches[key], _, _ = timed(eng, call)
        return res

    def lanes_of(res):
        return [(res[e], tree_leaves(res.lane_params(e)))
                for e in range(len(res))]
    sweep = SweepSpec.grid(base.spec, seed=[0, 1, 2])
    lanes = lanes_of(run("sweep", cell_engine(base, sweep.specs[0]),
                         lambda e: e.run_sweep(sweep)))
    for e, spec in enumerate(sweep.specs):
        gaps[f"sweep_lane{e}"] = route_gap(lanes[e], run(
            "sequential", cell_engine(base, spec), lambda e: kept(e.run(), e)))
    del base, lanes
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        over = SweepSpec.grid(cohort["spec"], seed=list(range(n_cards)))
        for key, mesh in (("cards_sweep_none", None),
                          (f"cards_sweep_{n_cards}cards", cohort_mesh())):
            runs[key] = lanes_of(run(key, mesh_engine(cohort, "fused", mesh),
                                     lambda e: e.run_sweep(over)))
        for e, (a, b) in enumerate(zip(
                runs["cards_sweep_none"],
                runs[f"cards_sweep_{n_cards}cards"])):
            gaps[f"{n_cards}cards_lane{e}"] = route_gap(b, a)
    torch.cuda.empty_cache()
    for key, mesh in (("mesh_none", None),
                      ("mesh_2way", cohort_mesh([DEV] * 2))):
        runs[key] = run(key, mesh_engine(cohort, "fused", mesh),
                        lambda e: kept(e.run(), e))
    gaps["mesh_2way"] = route_gap(runs["mesh_2way"], runs["mesh_none"])
    lost = [k for k, g in gaps.items() if not g["winners_equal"]]
    if lost:
        raise AssertionError(f"cnn contracts: the winners differ in {lost}: "
                             f"{gaps}")
    return gaps, launches, steps


#: a conv1 gradient's largest gap, relative to the leaf's largest
#: magnitude, between one local step and the same step again, as a
#: sweep's lane 0 or as a cohort split's first chunk (``cnn_step_bits``):
#: about 11 times the largest of 15 readings of the ATen chain this
#: kernel pair replaced (1.83e-7, a few ulps; H100 80GB HBM3)
CNN_CONV1_STEP_GAP = 2e-6


def cnn_step_bits(lanes=3, chunk=5):
    """One local step of the paper cell's cohort (``cohort_step``), leaf
    by leaf, against the same step at U rows: again, as lane 0 of
    ``lanes`` x U rows (a sweep's first step) and as the first ``chunk``
    rows (a cohort split's first chunk). conv2's grouped input gradient
    (cuDNN) is not repeatable on the card and feeds conv1's gradients
    alone, so every other leaf and the losses keep their bits. Returns
    by reading whether the losses are equal and each leaf's largest gap
    relative to its largest magnitude."""
    grad_fn, stack, batch = cohort_step(paper_engine("cnn", 1))
    g, loss = grad_fn(stack, batch)
    U = loss.shape[0]
    runs = dict(
        again=(U, (stack, batch)),
        sweep_lane0=(U, [tree_map(lambda x: x.repeat(
            (lanes,) + (1,) * (x.dim() - 1)), t) for t in (stack, batch)]),
        chunk=(chunk, [tree_map(lambda x: x[:chunk].contiguous(), t)
                       for t in (stack, batch)]))
    out = {}
    for key, (m, args) in runs.items():
        gk, lk = grad_fn(*args)
        gaps = {f"{mod}/{k}": float(
            (v[:m] - g[mod][k][:m]).abs().max()
            / g[mod][k][:m].abs().max().clamp_min(1e-30))
            for mod in g for k, v in gk[mod].items()}
        out[key] = dict(losses_equal=torch.equal(lk[:m], loss[:m]),
                        leaf_gaps=gaps)
    return out


def conv2_dgrad_bits(U=10, E=3, B=32):
    """conv2's grouped input gradient alone, as ``vmap(grad)`` runs it
    (cuDNN, f32, TF32 off): the same call twice, and U groups against
    the first U of E x U groups, bit for bit."""
    g = torch.Generator(device=DEV).manual_seed(11)
    x = torch.randn(B, E * U * 128, 14, 14, generator=g, device=DEV)
    w = 0.02 * torch.randn(E * U * 256, 128, 5, 5, generator=g, device=DEV)
    gy = torch.randn(B, E * U * 256, 14, 14, generator=g, device=DEV)

    def dgrad(G):
        xx = x[:, :G * 128].clone().requires_grad_()
        y = torch.nn.functional.conv2d(xx, w[:G * 256], padding=2, groups=G)
        return torch.autograd.grad(y, xx, gy[:, :G * 256])[0]
    one = dgrad(U)
    return dict(repeatable=torch.equal(one, dgrad(U)),
                groups_u_equal_in_e_x_u=torch.equal(
                    one, dgrad(E * U)[:, :U * 128]))


def phase_conv_pool(rounds=2, *extra):
    """The CNN's first block (``ops.conv_pool`` / ``ops.conv_pool_grad``).
    Each shape of ``CONV_POOL_SHAPES`` against the plain version
    (``check_conv_pool``); a user's bits alone = in a cohort = in a
    sweep's stack = on every card (``conv_pool_row_bits``); the pair
    timed beside its bound and the parent's chain (``bench_conv_pool``).
    Then the paper CNN: one local step, where every leaf but conv1's and
    the losses keep their bits again, as a sweep's lane and as a split's
    chunk, and conv1's gradients keep within ``CNN_CONV1_STEP_GAP``
    (``cnn_step_bits``: conv2's cuDNN input gradient, which feeds them,
    is not repeatable on the card, ``conv2_dgrad_bits``; ROADMAP Queue
    C); one fused round's launches, 18 + 18 training and
    ``CNN_EVAL_BATCHES`` evaluation ones, and none on the MLP's round
    (``check_main_path`` predicts every kernel's); and the rule-4 runs
    (``cnn_contracts``) with the same winners in every lane and split
    and their launches predicted, their gaps reported."""
    agree = {label: check_conv_pool(label, R, B, H, W, C, seed=100 + i)
             for i, (label, R, B, H, W, C) in enumerate(CONV_POOL_SHAPES)}
    cards = conv_pool_row_bits(seed=200)
    emit("conv_pool_agree", shapes={s[0]: list(s[1:]) for s in
                                    CONV_POOL_SHAPES},
         out_channels=CONV_POOL_O, agree=agree,
         user_bits_alone_equal_cohort_and_sweep_stack=True,
         cards_bit_equal=cards,
         tolerance="forward f32 rtol 1e-5 atol 1e-6, differing winners "
                   "only at near-ties; each gradient sum within 1e-5 of "
                   "its absolute sum of the float64 sum on the kernel's "
                   "winners")
    times = {s[0]: bench_conv_pool(*s[1:]) for s in CONV_POOL_SHAPES}
    emit("conv_pool_times", times=times, unit="ms a call")
    torch.cuda.empty_cache()
    step = cnn_step_bits()
    conv1 = max(v for r in step.values() for k, v in r["leaf_gaps"].items()
                if k.startswith("conv1/"))
    emit("cnn_step_bits", readings=step, conv1_max_gap=conv1,
         conv1_bound=CNN_CONV1_STEP_GAP, conv2_dgrad=conv2_dgrad_bits())
    for key, r in step.items():
        moved = [k for k, v in r["leaf_gaps"].items()
                 if v != 0.0 and not k.startswith("conv1/")]
        if not r["losses_equal"] or moved:
            raise AssertionError(f"cnn step {key}: the losses or {moved} "
                                 f"lost their bits: {r}")
    if not conv1 <= CNN_CONV1_STEP_GAP:
        raise AssertionError(f"cnn step: conv1's gradients {conv1} apart, "
                             f"over {CNN_CONV1_STEP_GAP}")
    per_round = {}
    for model in ("cnn", "mlp"):
        hist, engine, _, l, round_s, _ = run_main_path(model, 1, *extra)
        check_main_path(f"conv_pool_round_{model}", hist, engine, l, 1,
                        False, eval_batches=CNN_EVAL_BATCHES
                        if model == "cnn" else 0)
        per_round[model] = {k: l[k] for k in ("fused_sgd", "conv_pool",
                                              "conv_pool_grad")}
        del engine
    gaps, l_runs, steps = cnn_contracts(rounds, *extra)
    conv = ("conv_pool", "conv_pool_grad")
    evals = CNN_EVAL_BATCHES * rounds
    got = dict(round_cnn=per_round["cnn"], round_mlp=per_round["mlp"],
               **{k: {c: v[c] for c in conv} for k, v in l_runs.items()})
    want = dict(round_cnn={"fused_sgd": steps // rounds,
                           "conv_pool": steps // rounds + CNN_EVAL_BATCHES,
                           "conv_pool_grad": steps // rounds},
                round_mlp={"fused_sgd": per_round["mlp"]["fused_sgd"],
                           "conv_pool": 0, "conv_pool_grad": 0})
    n = torch.cuda.device_count()
    runs = dict(sweep=(3, 1), sequential=(1, 1), mesh_none=(1, 1),
                mesh_2way=(1, 2), cards_sweep_none=(n, 1),
                **{f"cards_sweep_{n}cards": (n, n)})    # (lanes, chunks)
    for key in l_runs:
        lanes, chunks = runs[key]
        want[key] = {"conv_pool": chunks * steps + lanes * evals,
                     "conv_pool_grad": chunks * steps}
    emit("conv_pool_engine", rounds=rounds, launches=got,
         launches_predicted=want, gaps=gaps,
         bitwise={k: g["bitwise"] for k, g in gaps.items()},
         note="winners enforced, the rest reported: conv2's grouped "
              "input gradient (cuDNN) is not repeatable, so conv1's "
              "gradients differ run to run on the card whatever conv1 "
              "runs on, and every leaf after a step")
    if got != want:
        raise AssertionError(f"conv_pool: launches {got}, predicted {want}")
    return agree, times


# -------------------------------------------------------------- main path
def paper_args(*extra):
    return launch_train.make_parser().parse_args(["--device", "cuda", *extra])


def paper_engine(model, rounds, *extra, **spec):
    """The paper's cell through ``launch.train.build_paper_engine``
    (``extra``: command-line flags; ``spec``: spec fields the command line
    has no flag for: ``channel``, ``faults``, ``merge_backend``,
    ``objective``)."""
    return launch_train.build_paper_engine(
        paper_args("--model", model, "--rounds", str(rounds), *extra),
        **spec)


def round_loop(engine):
    """``engine``'s rounds through the per-round loop a caller drives with
    ``FLEngine.run_round`` — the loop ``run`` takes where it does not
    delegate to the sweep loop — evaluating as ``run`` does. Returns the
    history."""
    spec = engine.spec
    hist = FLHistory(selections=np.zeros(engine.num_users, np.int64))
    for t in range(spec.rounds):
        engine.run_round(t, hist)
        if engine.eval_fn is not None and (
                t % spec.eval_every == 0 or t == spec.rounds - 1):
            hist.accuracy.append(float(engine.eval_fn(engine.global_params)))
            hist.eval_round.append(t)
    return hist


def run_main_path(model, rounds, *extra, split=None, merges=None,
                  finite=None, h_moved=None, engine=None, loop="run",
                  **spec):
    """The paper's cell (``paper_engine``) through ``FLEngine.run`` — for
    a fused cell the E = 1 sweep loop it delegates to — or, with
    ``loop="run_round"``, through the per-round loop (``round_loop``);
    returns (history, engine, seconds, launches, per-round seconds,
    contention events). The engine evaluates after every round, so the
    clock is read inside its eval callback, after a synchronize
    (``lane_round_s``). A ``split`` dict collects the seconds spent in training (``train_round``; within it
    the SGD loop over the stack, ``sgd``, and the host's batch draws and
    gathers, ``batch_epoch``), in selection (``select``) and in the
    merge (``merge``); a ``merges``
    list the kind of each merge the engine asks for ("digital",
    "aircomp", "robust", "robust+stale", "objective", and
    "objective-empty" for an objective merge with attempts but no
    deliveries); an ``h_moved`` list, for each "objective-empty" merge
    of an h-carrying objective, whether the merge changed the attempt
    winners' FedDyn h rows; a ``finite`` list whether every leaf of the
    global was finite after each round. ``engine``, when given, is run
    instead of the cell the arguments name."""
    if engine is None:
        engine = paper_engine(model, rounds, *extra, **spec)
    inner, stamps, marks = engine.eval_fn, [], []
    drawn = (fl_backends, fl_client)
    batch_epoch = [m.batch_epoch for m in drawn]
    # a fused run is the E = 1 case of the sweep loop (FLEngine._delegates):
    # its training, selection and merges go through the sweep's methods
    delegated = loop == "run" and engine._delegates()
    if split is not None:
        be = engine.backend
        spied = ((be, "sweep_train", "train_round"),
                 (be, "_epoch_run", "sgd"),
                 (engine, "_select_lanes", "select"),
                 (be, "sweep_merge", "merge"),
                 (be, "sweep_merge_faults", "merge")) if delegated else (
            (be, "train_round", "train_round"), (be, "_epoch_run", "sgd"),
            (engine.strategy, "select", "select"), (be, "merge", "merge"))
        if be.sparse_capable():
            # the winner-sparse round: the prepass, then the retrain
            spied += ((be, "sparse_priorities", "prepass"),
                      (be, "sparse_train", "train_round"))
        for obj, attr, key in spied:
            split[key] = 0.0
            setattr(obj, attr, _timed(getattr(obj, attr), split, key))
        split["batch_epoch"] = 0.0
        for m, fn in zip(drawn, batch_epoch):
            m.batch_epoch = _timed(fn, split, "batch_epoch", sync=False)
    if merges is not None and delegated:
        engine._dispatch_sweep_merge = sweep_merge_spy(
            engine._dispatch_sweep_merge, merges, h_moved)
    elif merges is not None:
        inner_merge = engine.backend.merge

        be = engine.backend

        def spy(state, tr, winners, merge_ctx=None, fault_ctx=None,
                attempts=None):
            kind = ("robust+stale" if fault_ctx.stale else "robust"
                    ) if fault_ctx is not None else (
                "aircomp" if merge_ctx is not None
                else ("objective" if winners else "objective-empty")
                if be.objective_active() else "digital")
            merges.append(kind)
            watch = (kind == "objective-empty" and be.objective_needs_h()
                     and h_moved is not None)
            if watch:
                rows = torch.as_tensor(attempts, device=DEV)
                before = [h[rows].clone()
                          for h in tree_leaves(be._ensure_obj_h(state))]
            out = inner_merge(state, tr, winners, merge_ctx=merge_ctx,
                              fault_ctx=fault_ctx, attempts=attempts)
            if watch:
                h_moved.append(all(
                    not torch.equal(b, h[rows]) for b, h in
                    zip(before, tree_leaves(be._ensure_obj_h(state)))))
            return out
        engine.backend.merge = spy

    def timed_eval(params):
        acc = inner(params)
        if finite is not None:
            finite.append(all(bool(torch.isfinite(l).all())
                              for l in tree_leaves(params)))
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        marks.append(dict(kcont.LOOP))
        return acc

    engine.eval_fn = timed_eval
    torch.cuda.synchronize()
    ops.reset_launches()                      # just before the main path
    kcont.reset_loop_stats()
    t0 = time.perf_counter()
    try:
        hist = engine.run() if loop == "run" else round_loop(engine)
    finally:
        for m, fn in zip(drawn, batch_epoch):
            m.batch_epoch = fn
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)             # just after it
    cont = dict(kcont.LOOP, shapes=sorted(kcont.LOOP["shapes"]))
    # contention events and pool attempts of each round, read at the
    # round's eval
    for key in ("events", "attempts"):
        cont["round_" + key] = np.diff(
            [0, *[m[key] for m in marks]]).tolist()
    return hist, engine, dt, launches, lane_round_s(t0, stamps, delegated), \
        cont


def lane_round_s(t0, stamps, lanes_loop):
    """Per-round seconds from the stamps taken at each round's first
    evaluation. In the sweep loop (``lanes_loop``) a round's evaluation
    comes after the next round's training was queued, so its stamp waits
    for that training too: interval t holds round t + 1's training and
    the last one none. The last is dropped there (with three rounds or
    more), so every interval after the first is one round's work."""
    round_s = np.diff([t0, *stamps]).tolist()
    return round_s[:-1] if lanes_loop and len(round_s) > 2 else round_s


def lane_merge_kind(lane, merged, stale, attempts, guarded):
    """The kind of merge a sweep lane's round runs (None: no merge — the
    lane keeps its global), by the rule of a sequential run: the robust
    merge where the fault guard is on and the lane has candidates or a
    stale group; else AirComp, objective or digital where it delivered;
    an h-carrying objective also merges a round of attempts alone."""
    obj = lane.spec.objective
    active = obj is not None and not obj.is_plain
    if guarded:
        return ("robust+stale" if stale else "robust") \
            if merged or stale else None
    if merged:
        return ("aircomp" if lane.spec.merge_backend == "aircomp"
                else "objective" if active else "digital")
    return "objective-empty" if active and obj.uses_h and attempts else None


def sweep_merge_spy(dispatch, merges, h_moved, merge_lanes=None):
    """``FLEngine._dispatch_sweep_merge`` recording each lane's merge kind
    into ``merges`` (and the lane into ``merge_lanes``, when given) and,
    for an "objective-empty" merge of an h-carrying objective, whether it
    moved the attempt winners' rows of the lane's FedDyn h (into
    ``h_moved``, when given)."""
    def spy(lanes, st, tr, merged_all, rfs, stales, lead_faults, k_pad, t,
            attempts=None, **kw):
        guarded = lead_faults is not None and lead_faults.merge_guarded
        watch = []
        for e, lane in enumerate(lanes):
            kind = lane_merge_kind(lane, merged_all[e], stales[e],
                                   attempts[0][e], guarded)
            if kind is not None:
                merges.append(kind)
                if merge_lanes is not None:
                    merge_lanes.append(e)
            if kind == "objective-empty" and h_moved is not None:
                rows = torch.as_tensor(attempts[0][e], device=DEV)
                watch.append((e, rows, [h[e][rows].clone()
                                        for h in tree_leaves(st.h)]))
        out = dispatch(lanes, st, tr, merged_all, rfs, stales, lead_faults,
                       k_pad, t, attempts=attempts, **kw)
        for e, rows, before in watch:
            h_moved.append(all(not torch.equal(b, h[e][rows]) for b, h in
                               zip(before, tree_leaves(st.h))))
        return out
    return spy


def _timed(fn, split, key, sync=True):
    """``fn`` adding its seconds to ``split[key]``; with ``sync`` the
    card's queue is drained before and after (host-only work needs no
    sync)."""
    def wrapped(*args, **kwargs):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if sync:
            torch.cuda.synchronize()
        split[key] += time.perf_counter() - t0
        return out
    return wrapped


def training_launches(engine, hist):
    """The ``fused_sgd`` and ``delta_norm`` launches a run's training
    makes, round by round, from the round path each round takes: a fused
    or stacked round is one SGD launch a local step for the whole stack
    and one Eq. 2 launch; a ragged round (batch counts differ, or one
    user) one SGD launch a step for each user and one Eq. 2 launch a
    user. A round trains every user, or, for a strategy that selects
    before training, only its winners. Priorities only where the
    strategy uses them. A winner-sparse round (``sparse_capable``) is a
    prepass of ceil(U / C) chunks, each one SGD launch a step and one
    Eq. 2 launch, where the mode is ``"prepass"`` and the strategy uses
    priorities; then the retrain of the (K_max, ...) winner stack, one
    SGD launch a step and one Eq. 2 launch whatever the strategy (its
    priorities are always computed), skipped in a ``"stale"`` round
    without winners. One launch takes up to ``max_leaves()`` leaves.
    Returns the two totals and the rounds of each path."""
    be, spec = engine.backend, engine.spec
    leaves = len(tree_leaves(engine.global_params))
    sgd_per = -(-leaves // kfused.max_leaves())
    dn_per = -(-leaves // kdn.max_leaves()) if \
        engine.strategy.uses_priority else 0
    E = spec.local_epochs

    def nb(u):
        return max(1, be.num_examples(u) // spec.batch_size)

    sgd = dn = 0
    paths = Counter()
    sparse = be.sparse_capable() and not \
        engine.strategy.trains_before_selection
    dn_all = -(-leaves // kdn.max_leaves())
    for winners in hist.winners:
        if sparse:
            paths["sparse"] += 1
            steps = sgd_per * nb(0) * E
            prepass = be._sparse_priority == "prepass"
            if prepass and engine.strategy.uses_priority:
                chunks = -(-be.num_users // max(1, min(be._sparse_chunk,
                                                       be.num_users)))
                sgd += steps * chunks
                dn += dn_all * chunks
            if winners or prepass:
                sgd += steps
                dn += dn_all
            continue
        ids = (list(winners) if engine.strategy.trains_before_selection
               else list(range(be.num_users)))
        if not ids:
            continue
        if be._can_fuse(ids) or be._can_stack(ids):
            paths["fused" if be._can_fuse(ids) else "stacked"] += 1
            sgd += sgd_per * nb(ids[0]) * E
            dn += dn_per
        else:
            paths["ragged"] += 1
            sgd += sgd_per * sum(nb(u) for u in ids) * E
            dn += dn_per * len(ids)
    return sgd, dn, dict(paths)


def check_main_path(name, hist, engine, launches, rounds, check_accuracy,
                    events=0, attempts=0, merges=None, token_sums=0,
                    eval_batches=0):
    """``token_sums``: the ``token_sum`` launches of an LLM run (its local
    steps' and evaluations' sums over tokens; none elsewhere).
    ``eval_batches``: the batches of one evaluation of the paper CNN,
    each one ``conv_pool`` launch; its local steps (a stack's, or a
    user's on the ragged path) take one ``conv_pool`` and one
    ``conv_pool_grad`` launch each, and no other model takes either.
    ``events`` / ``attempts``: the contention loop's events and pool
    attempts in the run (0 on the numpy backend); each attempt launches
    the persistent loop kernel once, and the three per-event passes
    never run.
    ``merges``: the kinds of the run's merges (``run_main_path``); None
    for a run without channel, faults and objective, where every round
    with winners merges digitally. Training launches as
    ``training_launches`` predicts them; a merge launches its kernel
    once per leaf; the
    robust merge makes one ``delta_norm`` call and runs
    ``robust_combine`` once per leaf for each group (fresh, and stale
    when there is one); the objective merge runs ``gather_combine`` once
    per leaf and, when the aggregator carries m / v and a weight is
    nonzero, makes one ``server_opt`` call. A call of the two leaf-list
    kernels is one launch for up to ``max_leaves()`` leaves. Without
    faults a round merges when it delivered, or when it had attempts and
    the objective carries h."""
    leaves = len(tree_leaves(engine.global_params))
    sgd, dn, paths = training_launches(engine, hist)
    needs_h = engine.backend.objective_needs_h()
    server = (engine.backend.objective_active()
              and engine.spec.objective.uses_server)
    if merges is None:
        merges = ["digital"] * sum(1 for w in hist.winners if w)
    elif engine.spec.faults is None and len(merges) != sum(
            1 for w, d in zip(hist.winners, hist.delivered)
            if d or (w and needs_h)):
        raise AssertionError(f"{name}: {len(merges)} merges for "
                             f"{hist.winners} / {hist.delivered}")
    kinds = Counter(merges)
    groups = kinds["robust"] + 2 * kinds["robust+stale"]
    # one launch a call takes every leaf (up to max_leaves())
    want = {"fused_sgd": sgd,
            "delta_norm": dn + -(-leaves // kdn.max_leaves()) * groups,
            "gather_combine": leaves * (kinds["digital"] + kinds["objective"]
                                        + kinds["objective-empty"]),
            "fedavg_combine": 0,
            **{k: 0 for k in CONTENTION}, LOOP_KERNEL: attempts,
            "aircomp_combine": leaves * kinds["aircomp"],
            "robust_combine": leaves * groups,
            "server_opt": (-(-leaves // kso.max_leaves()) * kinds["objective"]
                           if server else 0),
            "token_sum": token_sums,
            "conv_pool": 0, "conv_pool_grad": 0}
    if "conv1" in engine.global_params:
        steps = sgd // -(-leaves // kfused.max_leaves())
        want.update(conv_pool=steps + eval_batches * len(hist.accuracy),
                    conv_pool_grad=steps)
    if engine.spec.contention_backend == "device" and events < rounds:
        raise AssertionError(f"{name}: {events} contention events in "
                             f"{rounds} rounds")
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, the code "
                             f"predicts {want}")
    if min(want["fused_sgd"], len(merges)) < 1 \
            or engine.strategy.uses_priority and want["delta_norm"] < 1 \
            or server and want["server_opt"] < 1:
        raise AssertionError(f"{name}: a kernel of the path never ran")
    if len(hist.winners) != rounds or len(hist.train_loss) != rounds:
        raise AssertionError(f"{name}: history is short")
    for t, winners in enumerate(hist.winners):
        # a round ends with deliveries, or with a recorded reason for none
        if not winners and hist.collisions == 0:
            raise AssertionError(f"{name}: round {t} has no winners and "
                                 "no collision was recorded")
    prios = np.asarray(hist.priorities)
    if engine.strategy.uses_priority != (len(prios) == rounds) or not (
            np.isfinite(hist.train_loss).all() and np.isfinite(prios).all()
            and (prios >= 1.0).all()):
        raise AssertionError(f"{name}: losses / priorities not finite or "
                             "priorities below 1")
    for leaf in tree_leaves(engine.global_params):
        if not torch.isfinite(leaf).all():
            raise AssertionError(f"{name}: non-finite global parameter")
    if check_accuracy:
        # the global after the last round beats the one after the first,
        # and the training loss fell
        if not (hist.accuracy[-1] > hist.accuracy[0]
                and hist.train_loss[-1] < 0.7 * hist.train_loss[0]):
            raise AssertionError(
                f"{name}: no learning: accuracy {hist.accuracy}, "
                f"loss {hist.train_loss}")
    return leaves, paths, len(merges)


def phase_main_path(model, rounds, check_accuracy):
    hist, engine, dt, launches, round_s, _ = run_main_path(model, rounds)
    leaves, _, merged = check_main_path(
        f"main_path_{model}", hist, engine, launches, rounds, check_accuracy,
        eval_batches=CNN_EVAL_BATCHES if model == "cnn" else 0)
    steps = engine.backend._nb * engine.spec.local_epochs
    if launches["fused_sgd"] != steps * rounds:
        raise AssertionError(f"main_path_{model}: {launches['fused_sgd']} "
                             f"SGD launches for {steps * rounds} local steps")
    steady = statistics.median(round_s[1:])
    emit(f"main_path_{model}", rounds=rounds, seconds=dt,
         first_round_s=round_s[0], median_later_round_s=steady,
         rounds_per_s=1.0 / steady, launches=launches,
         launches_per_round={"fused_sgd": steps,
                             "delta_norm": launches["delta_norm"] / rounds,
                             "gather_combine": leaves,
                             "conv_pool": launches["conv_pool"] / rounds,
                             "conv_pool_grad":
                             launches["conv_pool_grad"] / rounds},
         merged_rounds=merged, collisions=hist.collisions,
         accuracy_first=hist.accuracy[0], accuracy_best=max(hist.accuracy),
         accuracy_last=hist.accuracy[-1], loss_first=hist.train_loss[0],
         loss_last=hist.train_loss[-1],
         priority_max=float(np.max(hist.priorities)),
         peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20)
    return engine, launches


def phase_server_path(engine, model):
    """On a freshly trained stack of ``model``: the backend's merge is
    bit-equal to the plain version on the same stack, and the
    ``core.server`` merges agree with it (masked dense merge in index
    order vs gather merge in delivery order)."""
    be = engine.backend
    U = be.num_users
    ids = list(range(U))
    state = engine.state
    tr = be.train_round(state, 0, ids, need_priority=True)
    trained = tr.local_handle["fused_stack"]
    winners = [7, 3, 5]                        # delivery != index order
    sizes = [be.num_examples(u) for u in winners]
    locals_ = [be.extract_local(tr, u) for u in winners]
    ops.reset_launches()                       # just before the path
    masked = fl_server.fedavg_masked(
        trained, fl_server.winner_alphas(U, winners, sizes))
    listed = fl_server.fedavg(locals_, sizes)
    deltas = [tree_map(lambda l, g: l - g, loc, state) for loc in locals_]
    delta = fl_server.fedavg_delta(state, deltas, sizes)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)              # just after it
    # the plain version first: the merge overwrites the trained stack
    idx, w = compact_weights(be._k_pad(len(winners)), winners, sizes)
    idx_d, w_d = torch.from_numpy(idx).to(DEV), torch.from_numpy(w).to(DEV)
    plain = tree_map(lambda l, g: ref.gather_combine_ref(l, idx_d, w_d, g),
                     trained, state)
    gathered = be.merge(state, tr, winners)
    torch.cuda.synchronize()
    leaves = len(tree_leaves(state))
    if launches["fedavg_combine"] != 3 * leaves:
        raise AssertionError(f"server_path_{model}: launches {launches}")
    for p, g in zip(tree_leaves(plain), tree_leaves(gathered)):
        if not (torch.isfinite(g).all() and torch.equal(p, g)):
            raise AssertionError(
                f"server_path_{model}: the backend's merge of a leaf of "
                f"shape {tuple(g.shape)} is not bit-equal to the plain "
                "version on the same trained stack")
    worst = 0.0
    for m, l, d, g in zip(*(tree_leaves(t) for t in
                            (masked, listed, delta, gathered))):
        # same rows and weights, summed in index order (masked) vs
        # delivery order (gathered): f32 rounding only
        if not torch.allclose(m, g, rtol=1e-6, atol=1e-7):
            raise AssertionError("server_path: fedavg_masked disagrees "
                                 "with the gather merge")
        # the listed form stacks the winners in delivery order: bit-equal
        if not torch.equal(l, g):
            raise AssertionError("server_path: fedavg over the winners' "
                                 "models is not bit-equal to the gather "
                                 "merge")
        if not torch.allclose(d, g, rtol=1e-4, atol=1e-6):
            raise AssertionError("server_path: fedavg_delta disagrees")
        worst = max(worst, float((m - g).abs().max()))
    emit(f"server_path_{model}", launches=launches, winners=winners,
         merge_bit_equal_to_plain=True,
         masked_vs_gather_max_abs_err=worst, listed_bit_equal=True)
    return launches


# ------------------------------------------------- correctness of results
def pin_scenario(strategy, seed, device, rounds=4, noise_draw=None,
                 loop="run", **spec):
    """The scenario of ``tools/check_winner_pins.py``: 8 users, a 16 -> 4
    linear model, 4 rounds; ``spec`` adds spec fields, ``noise_draw``
    replaces the backend's AirComp noise draw. Run through
    ``FLEngine.run``, or with ``loop="run_round"`` through the per-round
    loop (``round_loop``). Returns the run's history and final global."""
    engine = pin_engine(strategy, seed, device, rounds, **spec)
    if noise_draw is not None:
        engine.backend._noise_draw = noise_draw
    hist = engine.run() if loop == "run" else round_loop(engine)
    return hist, engine.global_params


@functools.lru_cache(maxsize=None)
def load_tool(name):
    """A script of ``tools/`` as a module (loaded once)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def pin_engine(strategy, seed, device, rounds=4, **spec):
    """The pin scenario's engine (see ``pin_scenario``):
    ``tools/check_winner_pins_torch.py``'s."""
    return load_tool("check_winner_pins_torch").pin_engine(
        strategy, seed, device, rounds, **spec)


def phase_pins_tool():
    """``tools/check_winner_pins_torch.py --device cuda`` (its ``main``,
    in this process): the pin scenario's 50 lanes — the paper strategies
    x seeds 0 and 1 and their channel-off, faults-off, sparse and inert
    objective twins — equal ``tests/winner_pins.json`` on the card, each
    twin's globals bit-equal to its plain lane's."""
    t0 = time.perf_counter()
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        rc = load_tool("check_winner_pins_torch").main(["--device", "cuda"])
    lines = said.getvalue().strip().splitlines()
    emit("pins_tool", rc=rc, result=json.loads(lines[0]), said=lines[1:],
         seconds=time.perf_counter() - t0)
    if rc != 0:
        raise AssertionError("pins_tool: " + said.getvalue())


def pin_sweep_lanes(pins):
    """The four paper strategies x seeds 0 and 1 as ONE sweep on the pin
    scenario, on the card and on the CPU: every lane's winners equal the
    pins, and the card's history counts the CPU's."""
    runs = {}
    for device in ("cuda", "cpu"):
        engine = pin_engine("priority-distributed", 0, device)
        sweep = SweepSpec.grid(engine.spec, strategy=list(PAPER_STRATEGIES),
                               seed=[0, 1])
        runs[device] = engine.run_sweep(sweep)
    gaps = []
    for label, g, c in zip(sweep.labels, runs["cuda"], runs["cpu"]):
        key = label.replace("strategy=", "").replace(",seed=", "/seed")
        if g.winners != pins[key]:
            raise AssertionError(f"reference_small sweep lane {key}: winners "
                                 f"{g.winners} differ from the pins")
        for f in HISTORY_COUNTS:
            if getattr(g, f) != getattr(c, f):
                raise AssertionError(f"reference_small sweep lane {key}: {f} "
                                     "differs between the card and the CPU")
    for a, b in zip(tree_leaves(runs["cuda"].final_globals),
                    tree_leaves(runs["cpu"].final_globals)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)
        gaps.append(float((a.cpu() - b).abs().max()))
    return dict(lanes=sweep.labels, max_abs_gap_global=max(gaps))


def pin_round_loop_lanes():
    """The fused lanes of ``reference_small`` (plain, ``LAYER_LANES``,
    ``OBJ_ACTIVE``; seed 0) through the per-round loop (``round_loop``:
    ``HostBackend.merge`` in its digital, AirComp, robust and objective
    forms), where ``run`` takes the E = 1 sweep loop: the card's run equals
    the CPU's in every history count, globals within rtol 1e-4 / atol
    1e-6, and chooses the winners the card's ``run`` chooses."""
    cells = {"plain": ("priority-distributed", {}), **LAYER_LANES,
             **{f"objective/{k}": ("priority-distributed",
                                   dict(objective=o))
                for k, o in OBJ_ACTIVE.items()}}
    out = {}
    for label, (strategy, spec) in cells.items():
        gh, gp = pin_scenario(strategy, 0, "cuda", loop="run_round", **spec)
        ch, cp = pin_scenario(strategy, 0, "cpu", loop="run_round", **spec)
        dh, _ = pin_scenario(strategy, 0, "cuda", **spec)
        for f in HISTORY_COUNTS:
            if getattr(gh, f) != getattr(ch, f):
                raise AssertionError(f"reference_small run_round/{label}: "
                                     f"{f} differs between the card and "
                                     "the CPU")
        if gh.winners != dh.winners:
            raise AssertionError(f"reference_small run_round/{label}: the "
                                 "per-round loop and run's sweep loop chose "
                                 f"differently on the card: {gh.winners} "
                                 f"vs {dh.winners}")
        for a, b in zip(tree_leaves(gp), tree_leaves(cp)):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       rtol=1e-4, atol=1e-6)
        out[label] = dict(
            winners=gh.winners, upload_failures=gh.upload_failures,
            stale_merges=gh.stale_merges,
            quarantined=gh.quarantined_updates,
            max_abs_gap_global=max(float((a.cpu() - b).abs().max())
                                   for a, b in zip(tree_leaves(gp),
                                                   tree_leaves(cp))))
    return out


def cpu_noise(key, leaf_index, shape, device):
    """The AirComp noise plane drawn on the CPU and moved to ``device``:
    the card and the CPU run then merge the same planes."""
    return aircomp_noise(key, leaf_index, shape, "cpu").to(device)


#: the channel, AirComp and fault lanes of tests/test_torch_{channel,faults}
#: .py on the pin scenario: waterfall PER with Rayleigh fading at a 20 dB
#: threshold (these 8 users then lose uploads), the AirComp merge with a
#: truncation floor, noiseless and with receiver noise (the card and the
#: CPU handed the same planes), and the active fault spec over it
PIN_LOSSY = ChannelSpec(fading="rayleigh", per_snr_threshold_db=20.0)
AIR_NOISY = dict(merge_backend="aircomp", channel=ChannelSpec(
    fading="rayleigh", aircomp_gain_floor=0.3, aircomp_sigma=0.05))
LAYER_LANES = {
    "channel/priority-distributed": ("priority-distributed",
                                     dict(channel=PIN_LOSSY)),
    "channel/channel-distributed": ("channel-distributed",
                                    dict(channel=PIN_LOSSY)),
    "aircomp-sigma0": ("priority-distributed", dict(
        merge_backend="aircomp",
        channel=ChannelSpec(fading="rayleigh", aircomp_gain_floor=0.3))),
    "aircomp-sigma0.05": ("priority-distributed",
                          dict(noise_draw=cpu_noise, **AIR_NOISY)),
    "faults-nan": ("priority-distributed", dict(channel=PIN_LOSSY,
                                                faults=ACTIVE)),
}
#: the objective lanes of tests/test_torch_objectives.py (the active and
#: the inert specs of tests/test_objectives.py:302-309 and :266-273)
OBJ_ACTIVE = {
    "fedprox/fedavg": ObjectiveSpec(local="fedprox", mu=0.1),
    "feddyn/fedavg": ObjectiveSpec(local="feddyn", alpha=0.1),
    "fedavg/fedavgm": ObjectiveSpec(aggregator="fedavgm", beta=0.9,
                                    server_lr=0.5),
    "fedavg/fedadam": ObjectiveSpec(aggregator="fedadam", server_lr=0.1),
    "feddyn/fedavgm": ObjectiveSpec(local="feddyn", alpha=0.05,
                                    aggregator="fedavgm", beta=0.5,
                                    server_lr=0.8)}
OBJ_INERT = {
    "fedavg/fedavg": ObjectiveSpec(),
    "fedprox-mu0": ObjectiveSpec(local="fedprox", mu=0.0),
    "feddyn-alpha0": ObjectiveSpec(local="feddyn", alpha=0.0),
    "fedavgm-beta0-slr1": ObjectiveSpec(aggregator="fedavgm", beta=0.0,
                                        server_lr=1.0),
    "feddyn+fedavgm-inert": ObjectiveSpec(local="feddyn", alpha=0.0,
                                          aggregator="fedavgm", beta=0.0,
                                          server_lr=1.0)}
#: the stacked, ragged and partial-cohort lanes of
#: tests/test_torch_round_modes.py on the pin scenario, seeds 0 and 1:
#: strategy and spec fields (``round_mode`` among them)
ROUND_LANES = {
    "stacked": ("priority-distributed", dict(round_mode="stacked")),
    "ragged": ("priority-distributed", dict(round_mode="ragged")),
    "random-centralized": ("random-centralized", {}),
    "stacked/channel": ("priority-distributed",
                        dict(round_mode="stacked", channel=PIN_LOSSY)),
    "stacked/faults": ("priority-distributed",
                       dict(round_mode="stacked", channel=PIN_LOSSY,
                            faults=ACTIVE)),
    "stacked/aircomp-sigma0.05": ("priority-distributed",
                                  dict(round_mode="stacked", **AIR_NOISY)),
}
HISTORY_COUNTS = ("winners", "delivered", "upload_failures", "collisions",
                  "contention_slots", "round_seconds", "round_energy_j",
                  "retries", "dropped_clients", "stale_merges",
                  "quarantined_updates")


def noise_bits_gap(calls):
    """For each ``(key, leaf, shape)`` noise plane, the card's draw
    against the CPU's: elements compared, the count that differ, and the
    largest gap in f32 ulps (the difference of the bit patterns)."""
    total = differ = gap = 0
    for key, leaf, shape in calls:
        a = aircomp_noise(key, leaf, shape, "cuda").cpu().view(torch.int32)
        b = aircomp_noise(key, leaf, shape, "cpu").view(torch.int32)
        d = (a.long() - b.long()).abs()
        total += d.numel()
        differ += int((d != 0).sum())
        gap = max(gap, int(d.max()))
    return dict(elements=total, differing=differ, max_ulp_gap=gap)


def lane_default_noise():
    """Noisy AirComp (sigma 0.05) through the DEFAULT noise route, the
    counter-based draw computed where each run lives: the card's run
    equals the CPU's in every history count, globals within rtol 1e-5 /
    atol 1e-6. A third run on the card records its planes through a hook
    that calls the same default draw (it must give the first run's bits);
    those planes and 2^20 more draws are then compared card against CPU
    element by element."""
    gh, gp = pin_scenario("priority-distributed", 0, "cuda", **AIR_NOISY)
    ch, cp = pin_scenario("priority-distributed", 0, "cpu", **AIR_NOISY)
    for f in HISTORY_COUNTS:
        if getattr(gh, f) != getattr(ch, f):
            raise AssertionError(f"reference_small aircomp default noise: {f} "
                                 "differs between the card and the CPU")
    for a, b in zip(tree_leaves(gp), tree_leaves(cp)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    calls = []

    def recording(key, leaf_index, shape, device):
        calls.append((key, leaf_index, tuple(shape)))
        return aircomp_noise(key, leaf_index, shape, device)

    rh, rp = pin_scenario("priority-distributed", 0, "cuda",
                          noise_draw=recording, **AIR_NOISY)
    if rh.winners != gh.winners or not all(
            torch.equal(a, b) for a, b in zip(tree_leaves(rp),
                                              tree_leaves(gp))):
        raise AssertionError("reference_small aircomp default noise: the "
                             "recording run is not the default run's bits")
    return dict(
        winners=gh.winners, planes=len(calls),
        merged_planes=noise_bits_gap(calls),
        million_draws=noise_bits_gap([((20230917, 3), 1, (1 << 20,))]),
        max_abs_gap_global=max(float((a.cpu() - b).abs().max())
                               for a, b in zip(tree_leaves(gp),
                                               tree_leaves(cp))))


def phase_reference_small():
    """The card's winners equal the pinned ones, and for a priority
    strategy (whose winners depend on trained floats) the card and the
    CPU run of the same rounds agree — with the channel, AirComp, fault
    and active-objective lanes too; the inert objectives give the plain
    lane's winners and its global bit for bit on the card. One strategy
    and seed each: the CPU tests hold every pinned cell against the
    reference package."""
    with open(os.path.join(ROOT, "tests", "winner_pins.json")) as f:
        pins = json.load(f)["winners"]
    hist, _ = pin_scenario("random-distributed", 0, "cuda")
    if hist.winners != pins["random-distributed/seed0"]:
        raise AssertionError("random-distributed winners differ from "
                             f"the pins: {hist.winners}")
    gh, gp = pin_scenario("priority-distributed", 0, "cuda")
    ch, cp = pin_scenario("priority-distributed", 0, "cpu")
    if gh.winners != ch.winners or gh.collisions != ch.collisions \
            or gh.contention_slots != ch.contention_slots:
        raise AssertionError("priority-distributed: the card and the CPU "
                             f"chose differently: {gh.winners} vs "
                             f"{ch.winners}")
    if gh.winners != pins["priority-distributed/seed0"]:
        raise AssertionError("priority-distributed: winners differ from "
                             "the pins")
    np.testing.assert_allclose(gh.priorities, ch.priorities, rtol=1e-4)
    for a, b in zip(tree_leaves(gp), tree_leaves(cp)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                   rtol=1e-4, atol=1e-6)
    lanes = {}
    plain = gp                  # the plain lane's global on the card
    for label, (strategy, spec) in LAYER_LANES.items():
        gh, gp = pin_scenario(strategy, 0, "cuda", **spec)
        ch, cp = pin_scenario(strategy, 0, "cpu", **spec)
        for f in HISTORY_COUNTS:
            if getattr(gh, f) != getattr(ch, f):
                raise AssertionError(f"reference_small {label}: {f} differs "
                                     f"between the card and the CPU")
        for a, b in zip(tree_leaves(gp), tree_leaves(cp)):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       rtol=1e-4, atol=1e-6)
        lanes[label] = dict(upload_failures=gh.upload_failures,
                            retries=gh.retries, stale_merges=gh.stale_merges,
                            quarantined=gh.quarantined_updates)
    lanes["aircomp-sigma0.05-default-noise"] = lane_default_noise()
    round_lanes = {}
    for label, (strategy, spec) in ROUND_LANES.items():
        for seed in (0, 1):
            tag = f"{label}/seed{seed}"
            gh, gp = pin_scenario(strategy, seed, "cuda", **spec)
            ch, cp = pin_scenario(strategy, seed, "cpu", **spec)
            for f in HISTORY_COUNTS:
                if getattr(gh, f) != getattr(ch, f):
                    raise AssertionError(f"reference_small {tag}: {f} "
                                         "differs between the card and the "
                                         "CPU")
            if strategy == "random-centralized" and gh.winners != pins[
                    f"random-centralized/seed{seed}"]:
                raise AssertionError(f"reference_small {tag}: winners "
                                     f"{gh.winners} differ from the pins")
            for a, b in zip(tree_leaves(gp), tree_leaves(cp)):
                np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                           rtol=1e-4, atol=1e-6)
            round_lanes[tag] = dict(
                winners=gh.winners, stale_merges=gh.stale_merges,
                upload_failures=gh.upload_failures,
                max_abs_gap_global=max(float((a.cpu() - b).abs().max())
                                       for a, b in zip(tree_leaves(gp),
                                                       tree_leaves(cp))))
    gaps = {}
    for label, obj in OBJ_ACTIVE.items():
        oh, op = pin_scenario("priority-distributed", 0, "cuda", objective=obj)
        ch, cp = pin_scenario("priority-distributed", 0, "cpu", objective=obj)
        for f in HISTORY_COUNTS:
            if getattr(oh, f) != getattr(ch, f):
                raise AssertionError(f"reference_small objective {label}: "
                                     f"{f} differs between the card and "
                                     "the CPU")
        for a, b in zip(tree_leaves(op), tree_leaves(cp)):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       rtol=1e-4, atol=1e-6)
        gaps[label] = max(float((a.cpu() - b).abs().max())
                          for a, b in zip(tree_leaves(op), tree_leaves(cp)))
    for label, obj in OBJ_INERT.items():
        ih, ip = pin_scenario("priority-distributed", 0, "cuda", objective=obj)
        if ih.winners != pins["priority-distributed/seed0"] or not all(
                torch.equal(a, b) for a, b in zip(tree_leaves(ip),
                                                  tree_leaves(plain))):
            raise AssertionError(f"reference_small inert objective {label}: "
                                 "not the plain lane's winners and global "
                                 "bits on the card")
    sweep_lanes = pin_sweep_lanes(pins)
    loop_lanes = pin_round_loop_lanes()
    sparse_lanes = pin_sparse_lanes(pins)
    emit("reference_small", agree_with_pins=["random-distributed/seed0",
                                             "priority-distributed/seed0",
                                             "random-centralized/seed0",
                                             "random-centralized/seed1",
                                             *OBJ_INERT,
                                             *sweep_lanes["lanes"]],
         sweep_lanes=sweep_lanes, sparse_lanes=sparse_lanes,
         sparse_lanes_agree_with_pins=[
             f"*/{t}" for t in sparse_lanes if t != "stale"],
         card_equals_cpu=["priority-distributed/seed0", *lanes,
                          *OBJ_ACTIVE, *round_lanes,
                          *(f"run_round/{k}" for k in loop_lanes)],
         run_round_lanes=loop_lanes,
         layer_lanes=lanes, round_lanes=round_lanes,
         objective_max_abs_gap_card_vs_cpu=gaps,
         inert_objectives_bit_equal_to_plain=list(OBJ_INERT),
         sparse_twins_bit_equal_to_sparse=[
             t for t in sparse_lanes if t not in ("sparse", "stale")],
         tolerance="history counts exact; globals rtol 1e-4 atol 1e-6 "
                   "(the default-noise AirComp lane rtol 1e-5 atol 1e-6); "
                   "inert objectives bitwise")


def phase_determinism(rounds=5):
    """Two runs of the MLP cell, two of its noisy AirComp variant
    (receiver noise drawn on the card) and two of its FedProx + FedAdam
    variant are bit-equal."""
    winners = {}
    for label, spec in (("mlp", {}), ("mlp_aircomp", AIRCOMP),
                        ("mlp_fedadam", dict(objective=FEDADAM))):
        runs = []
        for _ in range(2):
            hist, engine, _, _, _, _ = run_main_path("mlp", rounds, **spec)
            runs.append((hist.winners, [l.clone() for l in
                                        tree_leaves(engine.global_params)]))
        if runs[0][0] != runs[1][0]:
            raise AssertionError(f"determinism {label}: winners differ "
                                 "between two runs")
        for a, b in zip(runs[0][1], runs[1][1]):
            if not torch.equal(a, b):
                raise AssertionError(f"determinism {label}: final globals "
                                     "differ bitwise between two runs")
        winners[label] = runs[0][0]
    emit("determinism", rounds=rounds, winners=winners,
         final_global_bit_equal=True)


def phase_main_path_device(rounds=20):
    """The paper's MLP cell with ``--contention-backend device``, run
    twice: the checks of ``check_main_path`` (learning included), the
    persistent loop kernel launched once per pool attempt, and the two
    runs bit-equal in winners and final global."""
    runs = []
    for _ in range(2):
        hist, engine, dt, launches, round_s, loop = run_main_path(
            "mlp", rounds, "--contention-backend", "device")
        leaves, _, merged = check_main_path(
            "main_path_mlp_device", hist, engine, launches, rounds, True,
            events=loop["events"], attempts=loop["attempts"])
        steps = engine.backend._nb * engine.spec.local_epochs
        runs.append((hist, [l.clone() for l in
                            tree_leaves(engine.global_params)]))
        del engine
    if runs[0][0].winners != runs[1][0].winners or not all(
            torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1])):
        raise AssertionError("main_path_mlp_device: two runs differ in "
                             "winners or final global")
    steady = statistics.median(round_s[1:])
    emit("main_path_mlp_device", rounds=rounds, seconds=dt,
         first_round_s=round_s[0], median_later_round_s=steady,
         rounds_per_s=1.0 / steady, launches=launches,
         events=loop["events"], attempts=loop["attempts"],
         pool_shapes=loop["shapes"],
         launches_per_round={"fused_sgd": steps,
                             "delta_norm": launches["delta_norm"] / rounds,
                             "gather_combine": leaves,
                             LOOP_KERNEL: loop["attempts"] / rounds},
         merged_rounds=merged, collisions=hist.collisions,
         contention_slots=hist.contention_slots,
         accuracy_first=hist.accuracy[0], accuracy_last=hist.accuracy[-1],
         loss_first=hist.train_loss[0], loss_last=hist.train_loss[-1],
         winners_and_global_bit_equal_run_to_run=True)
    return launches, set(map(tuple, loop["shapes"]))


def phase_main_path_u1000(rounds=3):
    """The MLP at full width with 1000 users and 64 winners a round —
    the large-cohort regime device contention exists for (the fc1 stack
    alone is 627 MB f32) — with the seconds spent in training and in
    selection."""
    torch.cuda.reset_peak_memory_stats()
    split = {}
    hist, engine, dt, launches, round_s, loop = run_main_path(
        "mlp", rounds, "--users", "1000", "--k", "64", "--n-train",
        "60000", "--round-mode", "fused", "--contention-backend", "device",
        split=split)
    check_main_path("main_path_mlp_U1000_device", hist, engine, launches,
                    rounds, False, events=loop["events"],
                    attempts=loop["attempts"])
    steady = statistics.median(round_s[1:])
    emit("main_path_mlp_U1000_device", rounds=rounds, seconds=dt,
         first_round_s=round_s[0], median_later_round_s=steady,
         rounds_per_s=1.0 / steady, round_s=round_s, launches=launches,
         events=loop["events"], attempts=loop["attempts"],
         round_events=loop["round_events"],
         round_attempts=loop["round_attempts"],
         pool_shapes=loop["shapes"],
         train_s=split["train_round"], select_s=split["select"],
         train_share=split["train_round"] / dt,
         select_share=split["select"] / dt,
         deliveries=[len(w) for w in hist.winners],
         collisions=hist.collisions, contention_slots=hist.contention_slots,
         accuracy=hist.accuracy, loss=hist.train_loss,
         peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20)
    return launches, set(map(tuple, loop["shapes"]))


# ------------------------------------------------- the winner-sparse path
#: the README's 1000-user command (k * 8 <= users: the factory picks the
#: winner-sparse round path) and its 10 000-user variant (32 examples a
#: user: the non-IID shards divide evenly, so the cohort is rectangular)
U1000 = ("--users", "1000", "--k", "64", "--n-train", "60000",
         "--contention-backend", "device")
U10000 = ("--users", "10000", "--k", "64", "--n-train", "320000",
          "--contention-backend", "device")


def cohort_of(engine):
    """What engines over ``engine``'s cohort share — spec, initial
    weights, loss, data and evaluation — read before it runs (a run
    wraps its evaluation)."""
    be = engine.backend
    return dict(spec=engine.spec, init=engine._init_params,
                loss=be._loss_fn, data=[c.data for c in be.clients],
                eval_fn=engine.eval_fn)


def cohort_engine(cohort, mode=None, **spec):
    """An engine over ``cohort`` (``cohort_of``) on the round path
    ``mode`` (None: the factory's choice), the spec's fields ``spec``
    replaced."""
    return build_host_engine(
        dataclasses.replace(cohort["spec"], **spec), cohort["init"],
        cohort["loss"], cohort["data"], cohort["eval_fn"], round_mode=mode,
        device="cuda")


def kept(hist, engine):
    """A run's history and a copy of its final global's leaves."""
    return hist, [x.clone() for x in tree_leaves(engine.global_params)]


def route_gap(a, b):
    """Two runs of one cell on two round paths (``kept``): winners equal,
    the largest relative gap of their priorities and losses, the largest
    gap of the final globals relative to each leaf's largest magnitude
    (0 where bitwise), the globals within rtol 1e-5 / atol 1e-6, and
    whether all of it is bitwise."""
    (ha, ga), (hb, gb) = a, b

    def rel(x, y):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        if x.shape != y.shape:
            return float("inf")
        return float(np.max(np.abs(x / y - 1.0))) if x.size else 0.0
    prios = rel(ha.priorities, hb.priorities)
    losses = rel(ha.train_loss, hb.train_loss)
    glob = max(float((p - q).abs().max() / q.abs().max().clamp_min(1e-30))
               for p, q in zip(ga, gb))
    winners = ha.winners == hb.winners
    return dict(winners_equal=winners,
                max_rel_gap_priorities_losses=max(prios, losses),
                max_rel_gap_priorities=prios, max_rel_gap_losses=losses,
                max_rel_gap_global=glob,
                globals_close=all(torch.allclose(p, q, rtol=1e-5, atol=1e-6)
                                  for p, q in zip(ga, gb)),
                globals_bitwise=all(torch.equal(p, q)
                                    for p, q in zip(ga, gb)),
                bitwise=winners and max(prios, losses) == 0.0 and all(
                    torch.equal(p, q) for p, q in zip(ga, gb)))


def check_routes(name, gap, within=True):
    """``route_gap``'s verdict: winners equal, and with ``within`` the
    priorities, losses and globals within rtol 1e-5."""
    if not gap["winners_equal"] or within and not (
            gap["globals_close"]
            and gap["max_rel_gap_priorities_losses"] < 1e-5):
        raise AssertionError(f"{name}: the sparse route and the fused one "
                             f"disagree on the card: {gap}")


def routes_in_turns(name, cohort, routes, order, rounds):
    """``order``'s runs of ``cohort`` (``routes``: a route's round mode and
    spec fields), each held to ``check_main_path``'s launches predicted
    round by round (``training_launches``), its peak memory on top of what
    was live before it. Returns each route's first run (``kept``), its
    launches, median later-round seconds and peak memory of every run,
    and contention attempts."""
    runs, launches = {}, {}
    steady = {r: [] for r in routes}
    peak = {r: [] for r in routes}
    for route in order:
        mode, spec = routes[route]
        engine = cohort_engine(cohort, mode, **spec)
        torch.cuda.reset_peak_memory_stats()
        base_mb = torch.cuda.memory_allocated() / 2**20
        hist, engine, dt, l, round_s, loop = run_main_path(
            "mlp", rounds, engine=engine)
        check_main_path(f"{name}/{route}", hist, engine, l, rounds, False,
                        events=loop["events"], attempts=loop["attempts"])
        steady[route].append(statistics.median(round_s[1:]))
        peak[route].append(torch.cuda.max_memory_allocated() / 2**20
                           - base_mb)
        if route not in runs:
            runs[route], launches[route] = kept(hist, engine), l
        del engine
        torch.cuda.empty_cache()
    return runs, launches, steady, peak


def phase_main_path_u1000_sparse(rounds=3):
    """The README's 1000-user command without ``--round-mode``: the
    factory picks the winner-sparse path (exact prepass). That run first
    (it also warms the card to the path's shapes), then in turns with the
    same cell on ``--round-mode fused`` (fused, sparse, sparse, fused),
    every run held to ``check_main_path``'s launches: here 5
    ``fused_sgd``, 5 ``delta_norm`` and 4 ``gather_combine`` launches a
    round on the sparse route (4 prepass chunks of 256 users and the
    winner retrain), and one ``contention_loop`` launch a pool attempt;
    the two routes' winners equal, their priorities, losses and globals
    within rtol 1e-5 (the largest relative gap printed: 0 where bitwise).
    Then a sparse run's seconds a round in the prepass, the retrain,
    selection and the merge (a run of its own: the split synchronizes),
    and a profile of a fresh engine of each route (no evaluation): the
    device's idle share."""
    base = paper_engine("mlp", rounds, *U1000)
    if base.backend._mode != "sparse":
        raise AssertionError(f"main_path_mlp_U1000_sparse: the factory chose "
                             f"{base.backend._mode!r}")
    cohort = cohort_of(base)
    hist, base, _, first, _, loop = run_main_path("mlp", rounds, engine=base)
    check_main_path("main_path_mlp_U1000_sparse/readme", hist, base, first,
                    rounds, False, events=loop["events"],
                    attempts=loop["attempts"])
    del base
    routes = {"sparse": (None, {}), "fused": ("fused", {})}
    runs, launches, steady, peak = routes_in_turns(
        "main_path_mlp_U1000_sparse", cohort, routes,
        ["fused", "sparse", "sparse", "fused"], rounds)
    if first != launches["sparse"]:
        raise AssertionError(f"main_path_mlp_U1000_sparse: the first run's "
                             f"launches {first} differ from the later "
                             f"{launches['sparse']}")
    gap = route_gap(runs["sparse"], runs["fused"])
    want = {"fused_sgd": 5 * rounds, "delta_norm": 5 * rounds,
            "gather_combine": 4 * rounds}
    got = {k: launches["sparse"][k] for k in want}
    split = {}
    run_main_path("mlp", rounds, engine=cohort_engine(cohort), split=split)
    idle = {}
    for route, (mode, spec) in routes.items():
        idle[route] = profiled(f"mlp_U1000_{route}", cohort_engine(
            cohort, mode, **spec), lambda e: e.run(), rounds)[
            "device_idle_share"]
        torch.cuda.empty_cache()
    emit("main_path_mlp_U1000_sparse", rounds=rounds,
         order=["sparse (the README command)", "fused", "sparse", "sparse",
                "fused"],
         median_later_round_s=steady,
         rounds_per_s={r: [1.0 / t for t in v] for r, v in steady.items()},
         sparse_vs_fused_round_time=statistics.mean(steady["sparse"])
         / statistics.mean(steady["fused"]),
         launches=launches, launches_per_round={
             r: per_round(v, rounds) for r, v in launches.items()},
         predicted_sparse_launches=want, **gap,
         split_s_per_round={k: t / rounds for k, t in split.items()},
         device_idle_share=idle, peak_mem_mb=peak,
         winners=runs["sparse"][0].winners)
    check_routes("main_path_mlp_U1000_sparse", gap)
    if got != want:
        raise AssertionError(f"main_path_mlp_U1000_sparse: launches {got}, "
                             f"predicted {want}")
    return launches["sparse"]


def phase_main_path_u1000_sparse_stale(rounds=3):
    """The same cell with ``sparse_priority="stale"`` (the spec field; the
    command line has none): no prepass, so 1 ``fused_sgd``, 1
    ``delta_norm`` and 4 ``gather_combine`` launches a round (and one
    ``contention_loop`` launch a pool attempt), held to
    ``check_main_path``; rounds/s and peak memory."""
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2**20
    hist, engine, dt, launches, round_s, loop = run_main_path(
        "mlp", rounds, *U1000, sparse_priority="stale")
    if engine.backend._sparse_priority != "stale":
        raise AssertionError("main_path_mlp_U1000_sparse_stale: not stale")
    check_main_path("main_path_mlp_U1000_sparse_stale", hist, engine,
                    launches, rounds, False, events=loop["events"],
                    attempts=loop["attempts"])
    want = {"fused_sgd": rounds, "delta_norm": rounds,
            "gather_combine": 4 * rounds}
    got = {k: launches[k] for k in want}
    steady = statistics.median(round_s[1:])
    emit("main_path_mlp_U1000_sparse_stale", rounds=rounds, seconds=dt,
         first_round_s=round_s[0], median_later_round_s=steady,
         rounds_per_s=1.0 / steady, launches=launches,
         launches_per_round=per_round(launches, rounds),
         predicted_launches=want, attempts=loop["attempts"],
         winners=hist.winners, loss=hist.train_loss,
         cached_users=int((engine.backend.priority_cache_state() != 1.0)
                          .sum()),
         peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20 - base_mb)
    if got != want:
        raise AssertionError(f"main_path_mlp_U1000_sparse_stale: launches "
                             f"{got}, predicted {want}")
    del engine
    torch.cuda.empty_cache()
    return launches


def phase_main_path_u10000_sparse(rounds=3):
    """10 000 users, k = 64, 32 examples a user, device contention — the
    K << U regime the winner-sparse path exists for — on the stale and
    the prepass sparse routes and the fused one, in turns (stale, prepass,
    fused, fused, prepass, stale), each run held to ``check_main_path``'s
    launch predictions: rounds/s and peak memory of each; prepass must
    equal fused in winners and its priorities bit for bit, and no Eq. 2
    sum may follow the row count (``delta_norm_widths``; the loss and
    global gaps printed)."""
    base = paper_engine("mlp", rounds, *U10000)
    if base.backend._mode != "sparse" or not base.backend._rect:
        raise AssertionError("main_path_mlp_U10000_sparse: not a "
                             "rectangular sparse cohort")
    cohort = cohort_of(base)
    del base
    routes = {"stale": (None, dict(sparse_priority="stale")),
              "prepass": (None, {}), "fused": ("fused", {})}
    order = ["stale", "prepass", "fused", "fused", "prepass", "stale"]
    runs, launches, steady, peak = routes_in_turns(
        "main_path_mlp_U10000_sparse", cohort, routes, order, rounds)
    gap = route_gap(runs["prepass"], runs["fused"])
    idle = {}
    for route in ("prepass", "fused"):
        mode, spec = routes[route]
        idle[route] = profiled(f"mlp_U10000_{route}", cohort_engine(
            cohort, mode, **spec), lambda e: e.run(), rounds)[
            "device_idle_share"]
        torch.cuda.empty_cache()
    widths = delta_norm_widths(
        [tuple(p.shape) for p in tree_leaves(cohort["init"])])
    widths_differ = sum(w["rows_differ"] for w in widths.values())
    emit("main_path_mlp_U10000_sparse", rounds=rounds, order=order,
         device_idle_share=idle, delta_norm_width_bits=widths,
         median_later_round_s=steady,
         rounds_per_s={r: [1.0 / t for t in v] for r, v in steady.items()},
         vs_fused_round_time={r: statistics.mean(v) / statistics.mean(
             steady["fused"]) for r, v in steady.items()},
         launches_per_round={r: per_round(v, rounds)
                             for r, v in launches.items()},
         prepass_vs_fused=gap, peak_mem_mb=peak)
    check_routes("main_path_mlp_U10000_sparse", gap)
    if widths_differ or gap["max_rel_gap_priorities"] != 0.0:
        raise AssertionError("main_path_mlp_U10000_sparse: the prepass "
                             "priorities are not fused's bits "
                             f"({gap}; delta_norm widths {widths})")
    del cohort
    torch.cuda.empty_cache()


def delta_norm_widths(shapes, widths=(1000, 10_000), chunk=256):
    """Eq. 2's reduction of one (U, ...) stack of every leaf of
    ``shapes`` (random, on the card) against that of its chunks of
    ``chunk`` rows, as the prepass calls it: for each U, the rows whose
    d2 bits differ, of every leaf, and the largest relative gap.
    ``delta_norm``'s rows a block (1, 2 or 4) follow the row count; a
    row's partition and summation order must not, so no sum may differ."""
    out = {}
    for U in widths:
        stacks = [randn_dev(31 + i, (U, *s), torch.float32)
                  for i, s in enumerate(shapes)]
        globs = [randn_dev(131 + i, s, torch.float32)
                 for i, s in enumerate(shapes)]
        full, _ = ops.delta_norm_leaves(stacks, globs)
        parts = torch.cat([ops.delta_norm_leaves(
            [x[lo:lo + chunk] for x in stacks], globs)[0]
            for lo in range(0, U, chunk)], dim=1)
        out[U] = dict(rows=U * len(shapes),
                      rows_differ=int((full != parts).sum()),
                      max_rel_gap=float(((full - parts).abs()
                                         / full.abs()).max()))
        del stacks, full, parts
        torch.cuda.empty_cache()
    return out


def phase_sparse_layers(rounds=3):
    """The fault layer (LOSSY + ACTIVE: the robust merge, whose rows are
    read by delivery position and weights by user id, stragglers taken
    by position), AirComp (power-control coefficients by user id) and
    FedDyn + FedAvgM under the 20 dB channel (h rows written by user id
    from positions) through the winner-sparse route at 1000 users, each
    in turn with its fused twin: both runs held to ``check_main_path``'s
    launch predictions from their merge kinds, a finite global after
    every round and h moved by every attempt-only merge; every history
    count equal, priorities, losses and globals within rtol 1e-5 (the
    largest gap printed). Returns the sparse runs' launches together."""
    base = paper_engine("mlp", rounds, *U1000)
    cohort = cohort_of(base)
    del base
    out, total = {}, Counter()
    for name, spec in (("faults", dict(channel=LOSSY, faults=ACTIVE)),
                       ("aircomp", AIRCOMP),
                       ("feddyn_fedavgm", dict(channel=LOSSIER,
                                               objective=FEDDYN))):
        runs = {}
        for route, mode in (("sparse", None), ("fused", "fused")):
            merges, finite, h_moved = [], [], []
            hist, engine, dt, l, round_s, cont = run_main_path(
                "mlp", rounds, engine=cohort_engine(cohort, mode, **spec),
                merges=merges, finite=finite, h_moved=h_moved)
            label = f"sparse_layers/{name}/{route}"
            if (engine.backend._mode == "sparse") != (route == "sparse"):
                raise AssertionError(f"{label}: round mode "
                                     f"{engine.backend._mode!r}")
            check_main_path(label, hist, engine, l, rounds, False,
                            events=cont["events"], attempts=cont["attempts"],
                            merges=merges)
            if not (len(finite) == rounds and all(finite) and all(h_moved)):
                raise AssertionError(f"{label}: finite {finite}, h moved "
                                     f"{h_moved}")
            runs[route] = kept(hist, engine)
            if route == "sparse":
                total.update(l)
                out[name] = dict(launches_per_round=per_round(l, rounds),
                                 merges=dict(Counter(merges)),
                                 median_later_round_s=statistics.median(
                                     round_s[1:]),
                                 stale_merges=hist.stale_merges,
                                 quarantined=hist.quarantined_updates,
                                 upload_failures=hist.upload_failures,
                                 attempt_only_merges_h_moved=h_moved)
            else:
                out[name]["fused_median_later_round_s"] = statistics.median(
                    round_s[1:])
            del engine
            torch.cuda.empty_cache()
        (hs, _), (hf, _) = runs["sparse"], runs["fused"]
        differ = [f for f in HISTORY_COUNTS
                  if getattr(hs, f) != getattr(hf, f)]
        gap = route_gap(runs["sparse"], runs["fused"])
        out[name].update(gap, history_counts_equal=not differ)
        if differ:
            raise AssertionError(f"sparse_layers/{name}: {differ} differ "
                                 "between the sparse and the fused route")
        check_routes(f"sparse_layers/{name}", gap)
    emit("sparse_layers", rounds=rounds, users=1000, layers=out)
    return dict(total)


def phase_sweep_mlp_u1000_sparse(rounds=3):
    """Four seeds of the 1000-user, k = 64 cell on its auto-selected
    winner-sparse route (prepass) as one ``run_sweep``, with numpy
    contention (each lane redraws from its own stream, so the lanes must
    equal their sequential sparse runs in winners, priorities and losses
    within rtol 1e-5), against the four sequential runs, in turns
    (``sweep_in_turns``); the launches held to ``sweep_expected``."""
    base = launch_train.build_paper_engine(paper_args(
        "--model", "mlp", "--rounds", str(rounds), "--users", "1000",
        "--k", "64", "--n-train", "60000"))
    if not base.backend.sweep_sparse_capable():
        raise AssertionError("sweep_mlp_U1000_sparse: not a sparse cell")
    sweep = SweepSpec.grid(base.spec, seed=[0, 1, 2, 3])
    launches = sweep_in_turns("sweep_mlp_U1000_sparse", base, sweep, True)
    torch.cuda.empty_cache()
    return launches


def pin_sparse_lanes(pins):
    """The winner-sparse twins of ``tools/check_winner_pins.py`` on the
    pin scenario, on the card and on the CPU: the four paper strategies x
    seeds 0 and 1 as ONE sparse sweep (prepass), and its channel-off,
    faults-off and inert-objective twins (FedDyn at alpha 0 + FedAvgM at
    beta 0 / server_lr 1, without ``random-centralized``): every lane's
    winners equal the pins (``.../sparse``, ``.../channel-off``,
    ``.../faults-off``, ``.../objective-inert-sparse``), every twin's
    globals bit-equal to the sparse sweep's on the card, and the card's
    history counts the CPU's, globals within rtol 1e-4 / atol 1e-6. Then
    one stale run (``priority-distributed``, seed 0): card = CPU."""
    inert = ObjectiveSpec(local="feddyn", alpha=0.0, aggregator="fedavgm",
                          beta=0.0, server_lr=1.0)
    twins = {"sparse": {}, "channel-off": dict(
        channel=ChannelSpec(per_model="off")),
        "faults-off": dict(faults=FaultSpec()),
        "objective-inert-sparse": dict(objective=inert)}
    cells = [(s, seed) for s in PAPER_STRATEGIES for seed in (0, 1)]
    out, plain = {}, None
    for tag, fields in twins.items():
        lanes = [(s, seed) for s, seed in cells if not (
            "objective" in fields and s == "random-centralized")]
        res = {}
        for device in ("cuda", "cpu"):
            engine = pin_engine("priority-distributed", 0, device,
                                round_mode="sparse")
            res[device] = engine.run_sweep([ExperimentSpec(
                rounds=4, strategy=s, seed=seed, round_mode="sparse",
                **fields) for s, seed in lanes])
        gaps = []
        for e, (s, seed) in enumerate(lanes):
            key = f"{s}/seed{seed}"
            g, c = res["cuda"][e], res["cpu"][e]
            if g.winners != pins[f"{key}/{tag}"]:
                raise AssertionError(f"reference_small {key}/{tag}: winners "
                                     f"{g.winners} differ from the pins")
            for f in HISTORY_COUNTS:
                if getattr(g, f) != getattr(c, f):
                    raise AssertionError(f"reference_small {key}/{tag}: {f} "
                                         "differs between the card and "
                                         "the CPU")
            for a, b in zip(tree_leaves(res["cuda"].lane_params(e)),
                            tree_leaves(res["cpu"].lane_params(e))):
                np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                           rtol=1e-4, atol=1e-6)
                gaps.append(float((a.cpu() - b).abs().max()))
            if tag == "sparse":
                continue
            ref_e = cells.index((s, seed))
            if not all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(res["cuda"].lane_params(e)),
                    tree_leaves(plain.lane_params(ref_e)))):
                raise AssertionError(f"reference_small {key}/{tag}: globals "
                                     "not bit-equal to the sparse sweep's")
        if tag == "sparse":
            plain = res["cuda"]
        out[tag] = dict(lanes=len(lanes), max_abs_gap_global=max(gaps))
    gh, gp = pin_scenario("priority-distributed", 0, "cuda",
                          round_mode="sparse", sparse_priority="stale")
    ch, cp = pin_scenario("priority-distributed", 0, "cpu",
                          round_mode="sparse", sparse_priority="stale")
    for f in HISTORY_COUNTS:
        if getattr(gh, f) != getattr(ch, f):
            raise AssertionError(f"reference_small sparse stale: {f} differs "
                                 "between the card and the CPU")
    for a, b in zip(tree_leaves(gp), tree_leaves(cp)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)
    out["stale"] = dict(winners=gh.winners, max_abs_gap_global=max(
        float((a.cpu() - b).abs().max())
        for a, b in zip(tree_leaves(gp), tree_leaves(cp))))
    return out


def phase_layer_path(name, rounds, check_accuracy, *extra,
                     attempt_only=False, loop="run", **spec):
    """A channel / fault / objective path of the MLP cell (``spec``: the
    layers' spec fields; ``extra``: command-line flags; ``loop``: as
    ``run_main_path`` takes it): the checks of
    ``check_main_path`` with the launches predicted from the kinds of the
    run's merges, and a finite global after every round. With an
    h-carrying objective, every merge of a round with attempts but no
    deliveries must have moved the attempt winners' h rows; with
    ``attempt_only`` the run must hold such a round."""
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2**20
    merges, finite, h_moved = [], [], []
    hist, engine, dt, launches, round_s, cont = run_main_path(
        "mlp", rounds, *extra, merges=merges, finite=finite,
        h_moved=h_moved, loop=loop, **spec)
    check_main_path(name, hist, engine, launches, rounds, check_accuracy,
                    events=cont["events"], attempts=cont["attempts"],
                    merges=merges)
    if len(finite) != rounds or not all(finite):
        raise AssertionError(f"{name}: the global was not finite after "
                             f"every round: {finite}")
    if not all(h_moved) or attempt_only and not h_moved:
        raise AssertionError(f"{name}: rounds with attempts and no "
                             f"deliveries: h moved {h_moved}")
    steady = statistics.median(round_s[1:])
    emit(name, rounds=rounds, seconds=dt, first_round_s=round_s[0],
         median_later_round_s=steady, rounds_per_s=1.0 / steady,
         round_s=round_s, loop=loop, launches=launches,
         merges=dict(Counter(merges)),
         events=cont["events"], attempts=cont["attempts"],
         round_events=cont["round_events"],
         round_attempts=cont["round_attempts"],
         uploads_total=hist.uploads_total,
         delivered=sum(len(d) for d in hist.delivered),
         upload_failures=hist.upload_failures, retries=hist.retries,
         dropped_clients=hist.dropped_clients,
         stale_merges=hist.stale_merges,
         quarantined_updates=hist.quarantined_updates,
         collisions=hist.collisions, contention_slots=hist.contention_slots,
         simulated_s=hist.elapsed_seconds(),
         energy_j=float(sum(hist.round_energy_j)),
         accuracy_first=hist.accuracy[0], accuracy_last=hist.accuracy[-1],
         loss_first=hist.train_loss[0], loss_last=hist.train_loss[-1],
         finite_every_round=True, attempt_only_merges_h_moved=h_moved,
         # what the path allocated on top of what was live before it
         peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20 - base_mb,
         peak_mem_total_mb=torch.cuda.max_memory_allocated() / 2**20)
    del engine
    torch.cuda.empty_cache()
    return launches


def uneven_mlp_engine(rounds):
    """The paper's MLP cell with an uneven cohort, through
    ``build_host_engine``: the cell ``build_paper_engine`` makes (data,
    initial weights, loss, evaluation and spec), its odd users then
    dropping 40 examples — the reference's recipe
    (``tests/test_engine.py``) — so they hold 17 batches of 32 against
    the even users' 18 and nothing stacks: the default round mode runs
    every user on its own (the ragged path, U = 1 launches)."""
    base = paper_engine("mlp", rounds)
    data = [{k: v[: len(v) - 40 * (u % 2)] for k, v in c.data.items()}
            for u, c in enumerate(base.backend.clients)]
    return build_host_engine(base.spec, base.state, base.backend._loss_fn,
                             data, base.eval_fn, device="cuda")


def phase_round_path(name, rounds, check_accuracy, path, *extra,
                     engine=None):
    """A stacked, ragged or partial-cohort path of the MLP cell: the
    checks of ``check_main_path`` (training launches predicted round by
    round from the path each round takes, which must be ``path``), with
    rounds/s, first-round seconds, the training and selection seconds,
    the seconds of the SGD loop, of the host's batch draws and of the
    merge, launches a round per kernel and peak memory (what
    the path allocated on top of what was live before it, and in
    all)."""
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2**20
    split = {}
    hist, engine, dt, launches, round_s, _ = run_main_path(
        "mlp", rounds, *extra, split=split, engine=engine)
    leaves, paths, merged = check_main_path(name, hist, engine, launches,
                                            rounds, check_accuracy)
    if set(paths) != {path}:
        raise AssertionError(f"{name}: rounds took the paths {paths}, not "
                             f"{path} alone")
    steady = statistics.median(round_s[1:])
    emit(name, rounds=rounds, seconds=dt, first_round_s=round_s[0],
         median_later_round_s=steady, rounds_per_s=1.0 / steady,
         round_s=round_s, paths=paths, launches=launches,
         launches_per_round={k: v / rounds for k, v in launches.items()
                             if v},
         train_s=split["train_round"], select_s=split["select"],
         train_share=split["train_round"] / dt,
         sgd_s=split["sgd"], host_batch_s=split["batch_epoch"],
         merge_s=split["merge"],
         trained_per_round=[len(w) for w in hist.winners]
         if engine.strategy.trains_before_selection else engine.num_users,
         batches_per_user=sorted({engine.backend.num_examples(u)
                                  // engine.spec.batch_size
                                  for u in range(engine.num_users)}),
         merged_rounds=merged, collisions=hist.collisions,
         accuracy_first=hist.accuracy[0], accuracy_last=hist.accuracy[-1],
         loss_first=hist.train_loss[0], loss_last=hist.train_loss[-1],
         peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20 - base_mb,
         peak_mem_total_mb=torch.cuda.max_memory_allocated() / 2**20)
    del engine
    torch.cuda.empty_cache()
    return launches


def phase_round_paths_in_turns(rounds=5):
    """The MLP cell on the fused, stacked and ragged round paths and
    under ``random-centralized`` (a stacked partial-cohort round), in
    turns (fused, stacked, ragged, random-centralized, then back in
    reverse), so that the host's drift over the call falls on all four
    alike: the median later-round seconds of each run, and its seconds a
    round in training, in the SGD loop within it, in the host's batch
    draws, in selection and in the merge (``run_main_path``'s split)."""
    variants = {"fused": ("--round-mode", "fused"),
                "stacked": ("--round-mode", "stacked"),
                "ragged": ("--round-mode", "ragged"),
                "random_centralized": ("--strategy", "random-centralized")}
    order = ["fused", "stacked", "ragged", "random_centralized",
             "random_centralized", "ragged", "stacked", "fused"]
    out = {v: [] for v in variants}
    splits = {v: [] for v in variants}
    for v in order:
        split = {}
        _, _, _, _, round_s, _ = run_main_path("mlp", rounds, *variants[v],
                                               split=split)
        out[v].append(statistics.median(round_s[1:]))
        splits[v].append({k: t / rounds for k, t in split.items()})
    emit("round_paths_in_turns", rounds=rounds, order=order,
         median_later_round_s=out, split_s_per_round=splits,
         vs_fused={v: statistics.mean(out[v]) / statistics.mean(out["fused"])
                   for v in variants})


def phase_loops_in_turns(rounds=20):
    """The MLP cell through ``FLEngine.run`` (the E = 1 sweep loop it
    delegates to) and through the per-round loop (``round_loop``), in
    turns (run, run_round, run_round, run), so that the host's drift over
    the call falls on both alike. Every run is held to ``check_main_path``
    (launch predictions and learning); the two loops' winners must be
    equal, their losses and priorities within rtol 1e-5. Emits the seconds
    a round of each: the whole run over its rounds (evaluation included,
    as a user's run has it) and the median later round (read as
    ``lane_round_s`` reads each loop's stamps)."""
    order = ["run", "run_round", "run_round", "run"]
    per_s = {k: [] for k in order[:2]}
    steady = {k: [] for k in order[:2]}
    hists, globs, launches = {}, {}, {}
    for loop in order:
        hist, engine, dt, l, round_s, _ = run_main_path("mlp", rounds,
                                                        loop=loop)
        check_main_path(f"main_path_mlp_loops_in_turns/{loop}", hist,
                        engine, l, rounds, True)
        per_s[loop].append(dt / rounds)
        steady[loop].append(statistics.median(round_s[1:]))
        if loop not in hists:
            hists[loop], launches[loop] = hist, l
            globs[loop] = [x.clone() for x in
                           tree_leaves(engine.global_params)]
        del engine
    a, b = hists["run"], hists["run_round"]
    gap = max(float(np.max(np.abs(np.asarray(x) / np.asarray(y) - 1.0)))
              for x, y in ((a.priorities, b.priorities),
                           (a.train_loss, b.train_loss)))
    emit("main_path_mlp_loops_in_turns", rounds=rounds, order=order,
         seconds_per_round=per_s, median_later_round_s=steady,
         run_vs_run_round=statistics.mean(per_s["run"])
         / statistics.mean(per_s["run_round"]),
         launches_per_round={k: per_round(v, rounds)
                             for k, v in launches.items()},
         winners_equal=a.winners == b.winners,
         max_rel_gap_losses_priorities=gap,
         final_global_bit_equal=all(torch.equal(x, y) for x, y in zip(
             globs["run"], globs["run_round"])))
    if a.winners != b.winners or gap >= 1e-5 \
            or launches["run"] != launches["run_round"]:
        raise AssertionError(
            "main_path_mlp_loops_in_turns: run and the per-round loop "
            f"differ: winners equal {a.winners == b.winners}, largest "
            f"relative gap {gap:.3e}, launches {launches}")
    return launches["run_round"]


def phase_run_round_layers(rounds=10):
    """The AirComp, fault and objective forms of the fused MLP cell
    through the per-round loop (``round_loop``; ``run`` takes the E = 1
    sweep loop for them): ``HostBackend.merge``'s AirComp, robust and
    objective merges, each run held to ``check_main_path``'s launch
    predictions from its merge kinds (``phase_layer_path``). Returns the
    launches of the four runs together."""
    total = Counter()
    for name, spec in (("aircomp", AIRCOMP),
                       ("faults", dict(channel=LOSSY, faults=ACTIVE)),
                       ("fedprox_fedadam", dict(objective=FEDADAM)),
                       ("feddyn_fedavgm", dict(channel=LOSSIER,
                                               objective=FEDDYN))):
        total.update(phase_layer_path(f"main_path_mlp_run_round_{name}",
                                      rounds, False, loop="run_round",
                                      **spec))
    return dict(total)


def phase_layer_overhead(rounds=6):
    """The MLP cell plain, with the AirComp merge, with the fault layer
    and with FedProx + FedAdam, in turns (plain, AirComp, faults,
    objectives, objectives, faults, AirComp, plain), so that the host's
    drift over the call falls on all four alike: the median later-round
    seconds of each run."""
    variants = {"plain": {}, "aircomp": AIRCOMP,
                "faults": dict(channel=LOSSY, faults=ACTIVE),
                "objectives": dict(objective=FEDADAM)}
    order = ["plain", "aircomp", "faults", "objectives", "objectives",
             "faults", "aircomp", "plain"]
    out = {v: [] for v in variants}
    for v in order:
        _, _, _, _, round_s, _ = run_main_path("mlp", rounds, **variants[v])
        out[v].append(statistics.median(round_s[1:]))
    emit("layer_overhead", rounds=rounds, order=order,
         median_later_round_s=out,
         vs_plain={v: statistics.mean(out[v]) / statistics.mean(out["plain"])
                   for v in variants})


# ------------------------------------------------------------ the sweep
def cell_engine(base, spec, device="cuda", init=None):
    """An engine for ``spec`` over ``base``'s cohort — its data, initial
    weights (never written; ``init`` replaces them), loss, evaluation and
    round mode: the cell one lane of a sweep over ``base`` runs, as a
    sequential run. On ``device="cpu"`` it evaluates nothing."""
    be = base.backend
    return build_host_engine(
        spec, base.state if init is None else init, be._loss_fn,
        [c.data for c in be.clients],
        base.eval_fn if device == "cuda" else None,
        round_mode=be._mode, device=device)


def timed(engine, call):
    """``call(engine)`` (a ``run`` or ``run_sweep``) with the launch
    counts and contention statistics set to 0 just before it and read
    just after; every round stamped at its first evaluation, after a
    synchronize (``lane_round_s``; the sparse sweep loop queues no next
    round before its evaluations, so all its intervals count). Returns
    (result, seconds, launches, per-round seconds, contention
    attempts)."""
    E, queued = [0], [False]
    inner, stamps, calls = engine.eval_fn, [], [0]

    def timed_eval(params):
        if calls[0] % max(E[0], 1) == 0:
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        calls[0] += 1
        return inner(params)

    def spy(loop, queues):
        def spy_lanes(lanes, **kw):
            E[0], queued[0] = len(lanes), queues
            return loop(lanes, **kw)
        return spy_lanes
    loops = (engine._run_lanes, engine._run_lanes_sparse)
    engine._run_lanes = spy(loops[0], True)
    engine._run_lanes_sparse = spy(loops[1], False)
    engine.eval_fn = timed_eval
    torch.cuda.synchronize()
    ops.reset_launches()                      # just before the path
    kcont.reset_loop_stats()
    t0 = time.perf_counter()
    try:
        out = call(engine)
        torch.cuda.synchronize()
    finally:
        engine.eval_fn = inner
        engine._run_lanes, engine._run_lanes_sparse = loops
    dt = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)             # just after it
    return (out, dt, launches, lane_round_s(t0, stamps, queued[0]),
            kcont.LOOP["attempts"])


def sweep_expected(engine, res, merges, merge_lanes, attempts=0):
    """The launches a sweep makes, from its shape and the kinds of its
    lanes' merges: ``fused_sgd`` one a local step for every lane, Eq. 2
    one ``delta_norm_leaves`` call over the E x L leaf list a round (a
    sparse sweep: each of the ceil(U / C) prepass chunks, where the mode
    is ``"prepass"`` and a lane uses priorities, and the winner retrain,
    whose priorities are always computed, one training pass each); per
    merge of a lane, one launch a leaf of its merge kernel (gather,
    AirComp, robust once per group, with one ``delta_norm`` call a group)
    and, for an objective merge with a nonzero weight whose aggregator
    carries m / v, one ``server_opt`` call; one ``contention_loop`` launch
    a pool attempt. A call of a leaf-list kernel takes up to
    ``max_leaves()`` leaves."""
    be = engine.backend
    L = len(tree_leaves(engine.global_params))
    E, R = len(res), len(res[0].winners)
    prio = any(get_strategy_class(sp.strategy).uses_priority
               for sp in res.specs)
    kinds = Counter(merges)
    groups = kinds["robust"] + 2 * kinds["robust+stale"]
    server = sum(1 for k, e in zip(merges, merge_lanes)
                 if k == "objective" and res.specs[e].objective.uses_server)
    per = -(-L // kdn.max_leaves())
    passes, calls = R, R if prio else 0      # training passes, Eq. 2 calls
    if be.sweep_sparse_capable():
        chunks = -(-be.num_users // max(1, min(be._sparse_chunk,
                                               be.num_users)))
        pre = chunks if prio and be._sparse_priority == "prepass" else 0
        passes = calls = (pre + 1) * R
    want = {k: 0 for k in ops.LAUNCHES}
    want.update(
        fused_sgd=-(-L // kfused.max_leaves()) * be._nb
        * engine.spec.local_epochs * passes,
        delta_norm=-(-E * L // kdn.max_leaves()) * calls + per * groups,
        gather_combine=L * (kinds["digital"] + kinds["objective"]
                            + kinds["objective-empty"]),
        aircomp_combine=L * kinds["aircomp"],
        robust_combine=L * groups,
        server_opt=-(-L // kso.max_leaves()) * server)
    want[LOOP_KERNEL] = attempts
    return want


def run_checked_sweep(name, engine, sweep):
    """``engine.run_sweep(sweep)`` with every lane's merges recorded, its
    launches held against ``sweep_expected`` exactly and a finite global
    in every lane. Returns (result, seconds, launches, per-round seconds,
    merge kinds)."""
    merges, lanes = [], []
    engine._dispatch_sweep_merge = sweep_merge_spy(
        engine._dispatch_sweep_merge, merges, None, lanes)
    res, dt, launches, round_s, attempts = timed(
        engine, lambda e: e.run_sweep(sweep))
    del engine._dispatch_sweep_merge
    want = sweep_expected(engine, res, merges, lanes, attempts)
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, the code "
                             f"predicts {want}")
    if min(want["fused_sgd"], len(merges)) < 1:
        raise AssertionError(f"{name}: a kernel of the path never ran")
    for e in range(len(res)):
        if len(res[e].winners) != sweep.specs[0].rounds or not all(
                torch.isfinite(l).all()
                for l in tree_leaves(res.lane_params(e))):
            raise AssertionError(f"{name}: lane {e} is short or not finite")
    return res, dt, launches, round_s, dict(Counter(merges))


def per_round(launches, rounds):
    return {k: v / rounds for k, v in launches.items() if v}


def same_sweep(a, b):
    """Two sweep results hold the same bits: every lane's history and
    every final global."""
    return all(x.winners == y.winners and x.train_loss == y.train_loss
               and x.priorities == y.priorities and x.accuracy == y.accuracy
               for x, y in zip(a, b)) and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(a.final_globals),
                                          tree_leaves(b.final_globals)))


def sweep_in_turns(name, base, sweep, check_lanes, overlap_pair=False):
    """The sweep (checked by ``run_checked_sweep``) and its cells as
    sequential ``FLEngine.run`` calls over the same cohort, in turns:
    sweep, sequential, sequential, sweep. With ``check_lanes`` every lane's
    winners must equal its sequential run's, losses and priorities within
    rtol 1e-5 (not for a strategy that trains before it selects: its
    sweep lane trains the whole cohort). With ``overlap_pair`` the sweep
    also runs with its overlap off, inside the two sweeps (sweep, sweep
    without overlap, sequential, sequential, sweep without overlap,
    sweep), and must give the bits of the overlapped sweep. Emits the
    steady round, lane-rounds per second of each, launches a round and
    peak memory."""
    E, R = len(sweep), sweep.specs[0].rounds
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2**20
    res, dt, launches, round_s, kinds = run_checked_sweep(
        name, cell_engine(base, sweep.specs[0]), sweep)
    peak = torch.cuda.max_memory_allocated() / 2**20
    sweep_steady, sweep_wall = [statistics.median(round_s[1:])], [dt]
    seq_steady, seq_wall, seq_hists = [], [], []
    off_steady, off_wall, off_same = [], [], []

    def overlap_off():
        out, t, _, r_s, _ = timed(
            cell_engine(base, sweep.specs[0]),
            lambda e: e.run_sweep(sweep, overlap=False))
        off_steady.append(statistics.median(r_s[1:]))
        off_wall.append(t)
        off_same.append(same_sweep(out, res))
    if overlap_pair:
        overlap_off()
    for turn in range(2):
        steadies, wall = [], 0.0
        for spec in sweep.specs:
            hist, t, _, r_s, _ = timed(cell_engine(base, spec),
                                       lambda e: e.run())
            steadies.append(statistics.median(r_s[1:]))
            wall += t
            if turn == 0:
                seq_hists.append(hist)
        seq_steady.append(statistics.mean(steadies))
        seq_wall.append(wall)
    if overlap_pair:
        overlap_off()
    _, dt2, _, round_s2, _ = timed(cell_engine(base, sweep.specs[0]),
                                   lambda e: e.run_sweep(sweep))
    sweep_steady.append(statistics.median(round_s2[1:]))
    sweep_wall.append(dt2)
    gaps, equal = [], []
    for e, (got, want) in enumerate(zip(res, seq_hists)):
        equal.append(got.winners == want.winners)
        if not get_strategy_class(sweep.specs[e].strategy) \
                .trains_before_selection:
            gaps.append(max(
                float(np.max(np.abs(np.asarray(got.priorities)
                                    / np.asarray(want.priorities) - 1.0)))
                if got.priorities else 0.0,
                float(np.max(np.abs(np.asarray(got.train_loss)
                                    / np.asarray(want.train_loss) - 1.0)))))
    lane_rps = [E / t for t in sweep_steady]
    seq_rps = [1.0 / t for t in seq_steady]
    fields = dict(
        lanes=E, rounds=R, labels=sweep.labels, order=[
            "sweep", "sequential", "sequential", "sweep"],
        sweep_seconds=sweep_wall, sequential_seconds=seq_wall,
        sweep_round_ms=[1e3 * t for t in sweep_steady],
        sequential_round_ms=[1e3 * t for t in seq_steady],
        lane_rounds_per_s=lane_rps, sequential_lane_rounds_per_s=seq_rps,
        speedup=statistics.mean(lane_rps) / statistics.mean(seq_rps),
        whole_run_speedup=statistics.mean(seq_wall)
        / statistics.mean(sweep_wall),
        first_round_s=round_s[0], launches=launches,
        launches_per_round=per_round(launches, R), merges=kinds,
        lanes_equal_sequential=equal,
        max_rel_gap_losses_priorities=max(gaps, default=0.0),
        accuracy_last=[h.accuracy[-1] for h in res],
        peak_mem_mb=peak - base_mb, peak_mem_total_mb=peak)
    if overlap_pair:
        fields.update(
            order=["sweep", "sweep_overlap_off", "sequential",
                   "sequential", "sweep_overlap_off", "sweep"],
            overlap_off_seconds=off_wall,
            overlap_off_round_ms=[1e3 * t for t in off_steady],
            overlap_off_lane_rounds_per_s=[E / t for t in off_steady],
            overlap_gain=statistics.mean(off_steady)
            / statistics.mean(sweep_steady),
            overlap_gain_whole_run=statistics.mean(off_wall)
            / statistics.mean(sweep_wall),
            overlap_off_bit_equal=off_same)
    emit(name, **fields)
    if not all(off_same):
        raise AssertionError(f"{name}: the sweep without overlap is not "
                             f"the overlapped sweep's bits: {off_same}")
    if check_lanes and not (all(equal) and max(gaps, default=0.0) < 1e-5):
        raise AssertionError(
            f"{name}: sweep lanes differ from their sequential runs on the "
            f"card: winners equal {equal}, largest relative gap of losses "
            f"and priorities {max(gaps, default=0.0):.3e}")
    return launches


def phase_sweep_paper_fig3(rounds=20):
    """Fig. 3 as one ``run_sweep``: the four paper strategies x seeds 0
    and 1, the MLP cell (non-IID shards, 10 users), against the eight
    sequential runs of the same cells on the card, and against itself
    with its overlap off."""
    base = paper_engine("mlp", rounds)
    sweep = SweepSpec.grid(base.spec, strategy=list(PAPER_STRATEGIES),
                           seed=[0, 1])
    return sweep_in_turns("sweep_paper_fig3", base, sweep, True,
                          overlap_pair=True)


def phase_sweep_mlp_u1000(rounds=3):
    """Four seeds of the 1000-user, k = 64 MLP cell with device
    contention as one sweep, against the four sequential runs. The lanes
    contend in one batched device call, whose collision redraws come from
    the lead lane's counter: equal to the sequential runs in distribution
    only, so their winners are reported, not required."""
    base = launch_train.build_paper_engine(paper_args(
        "--model", "mlp", "--rounds", str(rounds), "--users", "1000",
        "--k", "64", "--n-train", "60000", "--round-mode", "fused",
        "--contention-backend", "device"))
    sweep = SweepSpec.grid(base.spec, seed=[0, 1, 2, 3])
    launches = sweep_in_turns("sweep_mlp_U1000", base, sweep, False)
    torch.cuda.empty_cache()
    return launches


def layer_sweeps(spec):
    """The layers' sweeps of ``sweep_layers`` over the cell ``spec``."""
    rep = dataclasses.replace
    return {
        "objectives": [rep(spec, channel=LOSSY, objective=o)
                       for o in (None, *OBJ_ACTIVE.values())],
        "aircomp": [rep(spec, merge_backend="aircomp", channel=ChannelSpec(
            fading="rayleigh", aircomp_sigma=0.01, aircomp_gain_floor=0.1,
            tx_power_dbm=tx)) for tx in (10.0, 20.0, 30.0)],
        "faults": [rep(spec, seed=s, channel=LOSSY, faults=ACTIVE)
                   for s in (0, 1, 2)]}


def phase_sweep_layers(rounds=4):
    """The layers as sweep lanes on the MLP cell: the five active
    objectives and a plain lane under the lossy channel, the AirComp
    merge at three SNR points (transmit power 10 / 20 / 30 dBm, receiver
    noise), the active faults under the lossy channel over three seeds.
    Each sweep on the card (launches held against ``sweep_expected``) and
    on the CPU: every history count of every lane equal."""
    base = paper_engine("mlp", rounds)
    init_cpu = tree_map(lambda p: p.cpu(), base.state)
    out, total = {}, Counter()
    for name, specs in layer_sweeps(base.spec).items():
        sweep = SweepSpec(specs=specs)
        res, dt, launches, round_s, kinds = run_checked_sweep(
            f"sweep_layers/{name}", cell_engine(base, specs[0]), sweep)
        total.update(launches)
        cpu = cell_engine(base, specs[0], "cpu", init_cpu).run_sweep(sweep)
        for e, (g, c) in enumerate(zip(res, cpu)):
            for f in HISTORY_COUNTS:
                if getattr(g, f) != getattr(c, f):
                    raise AssertionError(
                        f"sweep_layers/{name} lane {e}: {f} differs between "
                        "the card and the CPU")
        gap = max(float((a.cpu() - b).abs().max()) for a, b in zip(
            tree_leaves(res.final_globals), tree_leaves(cpu.final_globals)))
        out[name] = dict(
            lanes=len(specs), seconds=dt, round_ms=[1e3 * t for t in round_s],
            launches_per_round=per_round(launches, rounds), merges=kinds,
            upload_failures=[h.upload_failures for h in res],
            stale_merges=[h.stale_merges for h in res],
            quarantined=[h.quarantined_updates for h in res],
            max_abs_gap_global_card_vs_cpu=gap)
    emit("sweep_layers", rounds=rounds, sweeps=out,
         card_equals_cpu="every history count of every lane")
    return dict(total)


def phase_kill_resume(rounds=4):
    """Checkpoint / resume on the card: ``tools/kill_resume_smoke_torch.py``
    (its ``main``, in this process; a child a scenario killed after its
    first checkpoint, resumed, bit-identical; both scenarios), then the
    MLP cell run with checkpoints every two rounds and resumed by a fresh
    engine: the fused run (its E = 1 sweep writes the sweep payload) and
    the stacked run and a winner-sparse run under stale priorities (the
    per-round "run" payload, the latter with its priority cache), each
    resumed run bit-identical to the uninterrupted one."""
    t0 = time.perf_counter()
    tool = load_tool("kill_resume_smoke_torch")
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        rc = tool.main(["--device", "cuda"])    # its children: processes
    if rc != 0:
        raise AssertionError("kill_resume: the tool failed:\n"
                             + said.getvalue())
    tool_s = time.perf_counter() - t0
    paths = {}
    for label, extra, spec in (
            ("fused", (), {}), ("stacked", ("--round-mode", "stacked"), {}),
            ("sparse_stale", ("--round-mode", "sparse"),
             dict(sparse_priority="stale"))):
        args = paper_args("--model", "mlp", "--rounds", str(rounds), *extra)
        ref = launch_train.build_paper_engine(args, **spec)
        want = ref.run()
        with tempfile.TemporaryDirectory() as d:
            first = launch_train.build_paper_engine(args, **spec)
            h1 = first.run(checkpoint_dir=d, checkpoint_every=2)
            payload = load_fl_checkpoint(d)
            kind = payload["kind"]
            cache = payload.get("priority_cache")
            again = launch_train.build_paper_engine(args, **spec)
            h2 = again.run(checkpoint_dir=d)
        for h, e, what in ((h1, first, "checkpointed"), (h2, again,
                                                         "resumed")):
            if h.winners != want.winners or h.train_loss != want.train_loss \
                    or not all(torch.equal(a, b) for a, b in zip(
                        tree_leaves(e.global_params),
                        tree_leaves(ref.global_params))):
                raise AssertionError(f"kill_resume {label}: the {what} run "
                                     "is not the uninterrupted run's bits")
        paths[label] = dict(payload=kind, winners=want.winners,
                            priority_cache=cache is not None)
    if [paths[k]["payload"] for k in ("fused", "stacked", "sparse_stale")] \
            != ["sweep", "run", "run"] \
            or not paths["sparse_stale"]["priority_cache"]:
        raise AssertionError(f"kill_resume: payloads {paths}")
    emit("kill_resume", tool=said.getvalue().strip().splitlines(),
         tool_seconds=tool_s, rounds=rounds, paths=paths,
         bit_identical=True, seconds=time.perf_counter() - t0)


def profile_report(label, prof, wall_ms, rounds):
    """Device time by kernel name and the device's busy share, from a
    ``torch.profiler`` window of ``wall_ms``."""
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    if not rows:
        raise AssertionError("profile: the profiler saw no device time")
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    ours = sum(r[1] for r in rows if "repro" in r[0] or "sgd_leaves" in r[0]
               or "delta_norm" in r[0] or "combine_kernel" in r[0]
               or "robust_kernel" in r[0] or "server_opt" in r[0]
               or "contention_cu" in r[0] or "loop_kernel" in r[0]
               or "token_sum" in r[0])
    fields = dict(
        rounds=rounds, wall_ms=wall_ms,
        device_busy_ms=busy_ms, device_idle_share=1.0 - busy_ms / wall_ms,
        port_kernels_ms=ours, port_kernels_share_of_busy=ours / busy_ms,
        token_sum_ms=sum(r[1] for r in rows if "token_sum" in r[0]),
        device_kernels=len(rows),
        launches=sum(r[2] for r in rows),
        top=[dict(name=k[:90], ms=ms, count=c) for k, ms, c in rows[:12]],
        # every device kernel's launches in the window, by name
        launch_counts={k[:90]: c for k, _, c in rows},
        host_top=[dict(name=e.key[:60], self_cpu_ms=e.self_cpu_time_total
                       / 1e3, count=e.count)
                  for e in sorted(prof.key_averages(),
                                  key=lambda e: -e.self_cpu_time_total)[:10]])
    emit(f"profile_{label}", **fields)
    return fields


def profiled(label, engine, call, rounds):
    """``call(engine)`` under ``torch.profiler``, with no evaluation and
    the cohort's data already on the card (set-up, not a round), then
    ``profile_report``."""
    from torch.profiler import ProfilerActivity, profile
    engine.eval_fn = None
    if engine.backend.sweep_capable() or engine.backend.sparse_capable():
        engine.backend._ensure_xstack()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call(engine)
        torch.cuda.synchronize()
    return profile_report(label, prof, (time.perf_counter() - t0) * 1e3,
                          rounds)


def phase_profile_sweep(rounds=6):
    """``--profile``: the Fig. 3 sweep (8 lanes) under ``torch.profiler``,
    after a warm-up sweep: its device idle share."""
    base = paper_engine("mlp", rounds)
    sweep = SweepSpec.grid(base.spec, strategy=list(PAPER_STRATEGIES),
                           seed=[0, 1])
    base.run_sweep(sweep)                      # warm-up
    profiled("sweep_paper_fig3", base, lambda e: e.run_sweep(sweep), rounds)


def phase_profile(label, make, loop="run", rounds=4):
    """``--profile``: where a run's time goes — device time by kernel name
    and the device's busy share, from ``torch.profiler`` over the rounds
    of a fresh engine (``make()``, ``rounds`` rounds), after a warm-up run
    of another: through ``FLEngine.run`` (for a fused cell, the E = 1
    sweep loop it delegates to) or, with ``loop="run_round"``, through
    the per-round loop (``round_loop``)."""
    make().run()                               # warm-up
    profiled(label, make(),
             round_loop if loop == "run_round" else lambda e: e.run(), rounds)


# -------------------------------------------------------------------- run
# ------------------------------------------------------------ LLM stack
def llm_leaves(arch):
    """The reduced arch's leaf shapes (tree order), from meta params."""
    cfg = get_config(arch).reduced()
    return [tuple(p.shape) for p in
            tree_leaves(launch_steps.params_struct(cfg))]


def rel_gap(got, want):
    return float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())


def check_llm_leaf_table(label, shapes, U, dtype, seed, winners=(7, 2)):
    """Rows 1-3 on one leaf table of (U, ...) stacks: the multi-leaf SGD
    step and the gather merge (every leaf) bit for bit, the Eq. 2 sums
    rtol 1e-5, one launch a call for up to ``max_leaves()`` leaves, and
    every row's sums the same bits reduced alone as inside the stack.
    Returns ({kernel: (err, bit_equal)}, delta_norm's relative error)."""
    stacks = [randn(seed + i, (U,) + s, dtype) for i, s in enumerate(shapes)]
    grads = [randn(seed + 100 + i, (U,) + s, dtype)
             for i, s in enumerate(shapes)]
    globs = [randn(seed + 200 + i, s, dtype) for i, s in enumerate(shapes)]
    out = {}
    want = [ref.fused_sgd_ref(p, g, LR) for p, g in zip(stacks, grads)]
    before = ops.LAUNCHES["fused_sgd"]
    got = ops.fused_sgd_leaves([p.clone() for p in stacks], grads, LR)
    if ops.LAUNCHES["fused_sgd"] - before != -(-len(shapes)
                                               // kfused.max_leaves()):
        raise AssertionError(f"{label}: fused_sgd launches")
    out["fused_sgd"] = (max(bit_check(
        f"{label} fused_sgd leaf {i} {tuple(g.shape)}", g, w, dtype)
        for i, (g, w) in enumerate(zip(got, want))), True)
    before = ops.LAUNCHES["delta_norm"]
    d2, g2 = ops.delta_norm_leaves(stacks, globs)
    if ops.LAUNCHES["delta_norm"] - before != -(-len(shapes)
                                                // kdn.max_leaves()):
        raise AssertionError(f"{label}: delta_norm launches")
    d2w, g2w = ref.delta_norm_leaves_ref(stacks, globs)
    e1, b1 = compare(f"{label} delta_norm.d2", d2, d2w, torch.float32,
                     rel_only=True)
    e2, b2 = compare(f"{label} delta_norm.g2", g2, g2w, torch.float32,
                     rel_only=True)
    alone = torch.cat([ops.delta_norm_leaves([s[u:u + 1] for s in stacks],
                                             globs)[0] for u in range(U)], 1)
    if not same_bits(alone, d2):
        raise AssertionError(f"{label}: delta_norm rows reduced alone "
                             "differ from the stack's bits")
    out["delta_norm"] = (max(e1, e2), b1 and b2)
    idx, w = merge_inputs(U, list(winners), k_pad=len(winners))
    out["gather_combine"] = (max(bit_check(
        f"{label} gather_combine leaf {i}", ops.gather_combine(s, idx, w, g),
        ref.gather_combine_ref(s, idx, w, g), dtype)
        for i, (s, g) in enumerate(zip(stacks, globs))), True)
    return out, max(rel_gap(d2, d2w), rel_gap(g2, g2w))


def phase_llm_kernels(U=10):
    """Rows 1-3 on the reduced leaf tables of the --arch cells at U = 10
    (an --arch round's cohort; deepseek-v3's 56 leaves take two launches
    of each leaf-list kernel), f32 and bf16. Returns {kernel: {dtype:
    (err, bit_equal)}} and delta_norm's relative error."""
    worst = {k: {} for k in LLM_KERNELS if k != "token_sum"}
    rel, tables = 0.0, {}
    for tag, arch in LLM_CELLS.items():
        shapes = llm_leaves(arch)
        tables[arch] = [[U, *s] for s in shapes]
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).split(".")[1]
            got, r = check_llm_leaf_table(f"llm_kernels {arch} {key}",
                                          shapes, U, dtype, seed=5000)
            rel = max(rel, r)
            for k, v in got.items():
                old = worst[k].get(key, (0.0, True))
                worst[k][key] = (max(old[0], v[0]), old[1] and v[1])
    emit("llm_kernels", U=U, leaf_tables=tables,
         max_abs_err={k: {d: e for d, (e, _) in v.items()}
                      for k, v in worst.items()},
         bit_equal_to_plain={k: all(b for _, b in v.values())
                             for k, v in worst.items()},
         delta_norm_max_rel_err=rel,
         tolerance="fused_sgd and gather_combine bit-equal; delta_norm "
                   "sums rtol 1e-5, each row's bits the same alone as in "
                   "the stack")
    torch.cuda.empty_cache()
    return worst, rel


def quiet(fn, *a, **kw):
    """``fn`` with its standard output kept; returns (result, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue()


def phase_llm_fl_round(tag, rounds=5):
    """Federated finetune of the reduced arch through
    ``launch.train.main(["--arch", ...])``: 10 users, k = 2, 128-token
    sequences, 32 a user, ``priority-distributed``. The card's run
    against the CPU's (``--device cpu``): equal selections and uploads,
    globals within rtol 1e-4. Then a fresh engine of the same cell
    through ``run_main_path`` (round stamps), its launches held to
    ``check_main_path``'s prediction and to PERF.md's a round; a steady
    round, peak memory with its parts (``memory``), and the device's idle
    share from a profiled run. Returns the launches."""
    arch = LLM_CELLS[tag]
    argv = ["--arch", arch, "--rounds", str(rounds), *LLM_ARGV,
            *LLM_CELL_ARGV.get(tag, ())]
    name = f"llm_fl_round_{tag}"
    torch.cuda.synchronize()
    ops.reset_launches()                      # just before the path
    t0 = time.perf_counter()
    (engine, summary), text = quiet(launch_train.main, argv)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    l_main = dict(ops.LAUNCHES)               # just after it
    t0 = time.perf_counter()
    (cpu, cpu_summary), _ = quiet(launch_train.main, argv + ["--device",
                                                            "cpu"])
    cpu_s = time.perf_counter() - t0
    if (summary["selections"] != cpu_summary["selections"]
            or summary["uploads_total"] != cpu_summary["uploads_total"]):
        raise AssertionError(f"{name}: the card ({summary}) and the CPU "
                             f"({cpu_summary}) disagree")
    gap = 0.0
    for p, q in zip(tree_leaves(engine.global_params),
                    tree_leaves(cpu.global_params)):
        p = p.cpu()
        if not torch.allclose(p, q, rtol=1e-4, atol=1e-6):
            raise AssertionError(f"{name}: globals beyond rtol 1e-4 of the "
                                 "CPU run's")
        gap = max(gap, float((p - q).abs().max() / q.abs().max()))
    del engine, cpu
    args = launch_train.make_parser().parse_args(argv)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**20
    eng = launch_train.build_llm_engine(args)
    built = torch.cuda.memory_allocated() / 2**20
    hist, eng, dt, launches, round_s, _ = run_main_path(
        None, rounds, engine=eng)
    peak = torch.cuda.max_memory_allocated() / 2**20
    # the peak's parts: one local step of the cohort, one evaluation
    grad_fn, stack, batch = cohort_step(eng)
    mem = dict(held_at_reset_mb=held, engine_mb=built - held, peak_mb=peak,
               local_step_peak_mb=peak_above(lambda: grad_fn(stack, batch)),
               eval_peak_mb=peak_above(
                   lambda: eng.eval_fn(eng.global_params)))
    del grad_fn, stack, batch
    want = {k: v * rounds for k, v in LLM_ROUND_LAUNCHES[arch].items()}
    leaves, paths, merged = check_main_path(
        name, hist, eng, launches, rounds, check_accuracy=False,
        token_sums=want["token_sum"])
    if {k: launches[k] for k in want} != want or \
            {k: l_main[k] for k in want} != want:
        raise AssertionError(f"{name}: launches {launches} (main {l_main}), "
                             f"PERF.md predicts {want}")
    # learning: the winners' training loss falls in every cell; the
    # held-out loss (IID tokens) in the dense cells. The MoE cells' held-out
    # loss barely moves in 5 rounds (kimi's rose 0.003, the CPU's run alike:
    # two non-IID winners a round pull the global their way)
    if not hist.train_loss[-1] < hist.train_loss[0] or (
            arch in HELD_OUT_ARCHS
            and not hist.accuracy[-1] > hist.accuracy[0]):
        raise AssertionError(f"{name}: no learning: training loss "
                             f"{hist.train_loss}, held-out {hist.accuracy}")
    sweep = llm_sweep(name, args, hist, eng) if tag in LLM_SWEEP_CELLS \
        else None
    del eng
    remat = llm_remat_turns(name, tag, args)
    torch.cuda.empty_cache()
    prof = profiled(f"llm_{tag}", launch_train.build_llm_engine(args),
                    lambda e: e.run(), rounds)
    emit(name, arch=arch, argv=argv, rounds=rounds, leaves=leaves,
         paths=paths, main_s=main_s, cpu_s=cpu_s,
         selections=summary["selections"],
         uploads_total=summary["uploads_total"], card_equals_cpu=True,
         global_max_rel_gap_vs_cpu=gap, winners=hist.winners,
         held_out_loss=[-a for a in hist.accuracy],
         priorities_round0=[float(p) for p in hist.priorities[0]],
         launches=launches, launches_per_round={
             k: launches[k] / rounds for k in LLM_KERNELS},
         predicted_per_round=LLM_ROUND_LAUNCHES[arch],
         first_round_s=round_s[0],
         median_later_round_s=statistics.median(round_s[1:]),
         device_idle_share=prof["device_idle_share"], peak_mem_mb=peak,
         memory=mem,
         printed_summary=json.loads(text), sweep=sweep, remat=remat)
    torch.cuda.empty_cache()
    return launches


#: the --arch cells whose local step ``row_count_bits`` also reads with
#: ``remat`` on
REMAT_ROW_BITS = ("yi9b", "mamba2")


def llm_remat_turns(name, tag, args, rounds=2):
    """The cell for ``rounds`` rounds with ``cfg.remat`` off and on (the
    lever ``reduced()`` turns off), a fresh engine each, in turns (off,
    on, off, on): each run's peak and its second round's seconds, one
    local step's peak above what was held, the launches; the lever on
    must give the lever off's winners, training losses and global bit for
    bit, and, for ``REMAT_ROW_BITS``, ``row_count_bits`` at the sweep's
    width no op whose bits follow the row count."""
    a = argparse.Namespace(**{**vars(args), "rounds": rounds})
    runs, first, rows = {}, {}, None
    for lever in (False, True, False, True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng = launch_train.build_llm_engine(a, cfg_fields=dict(remat=lever))
        hist, _, launches, round_s, _ = timed(eng, lambda e: e.run())
        peak = torch.cuda.max_memory_allocated() / 2**20
        grad_fn, stack, batch = cohort_step(eng)
        step_peak = peak_above(lambda: grad_fn(stack, batch))
        del grad_fn, stack, batch
        key = "on" if lever else "off"
        r = runs.setdefault(key, dict(round_s=[], peak_mb=[],
                                      local_step_peak_mb=[],
                                      launches={k: launches[k]
                                                for k in LLM_KERNELS}))
        r["round_s"].append(round_s[-1])
        r["peak_mb"].append(peak)
        r["local_step_peak_mb"].append(step_peak)
        if key not in first:
            first[key] = (hist, [p.cpu() for p in
                                 tree_leaves(eng.global_params)])
        if lever and rows is None and tag in REMAT_ROW_BITS:
            rows = row_count_bits(eng, LLM_SWEEP_LANES)
        del eng
    (h0, g0), (h1, g1) = first["off"], first["on"]
    out = dict(rounds=rounds, order=["off", "on", "off", "on"], **runs,
               bits_equal=(h1.winners == h0.winners
                           and h1.train_loss == h0.train_loss
                           and all(torch.equal(x, y)
                                   for x, y in zip(g1, g0))),
               round_s_on_over_off=statistics.mean(runs["on"]["round_s"])
               / statistics.mean(runs["off"]["round_s"]),
               local_step_peak_on_over_off=statistics.mean(
                   runs["on"]["local_step_peak_mb"]) / statistics.mean(
                   runs["off"]["local_step_peak_mb"]),
               row_count_bits=rows)
    if not out["bits_equal"] or rows is not None and (
            rows["differing"] or not rows["grads_equal"]
            or not rows["losses_equal"] or not rows["repeat_equal"]):
        emit(f"{name}_remat_fault", **out)
        raise AssertionError(f"{name}: remat on is not the lever off's "
                             "bits")
    return out


def bits_hash(t):
    """A position-weighted int64 sum of ``t``'s bits (wraps, exact): equal
    bits give equal sums, and a differing element changes the sum."""
    t = t.detach().contiguous().view(-1)
    width = {8: torch.int64, 4: torch.int32, 2: torch.int16}
    b = t.view(width.get(t.element_size(), torch.uint8)) \
        if t.dtype != torch.bool else t.view(torch.uint8)
    w = torch.arange(b.numel(), device=b.device) % 65521 + 1
    return (b.long() * w).sum()


class OpBits(TorchDispatchMode):
    """Every aten op's output bits as ``bits_hash`` sums, with the output
    shapes: recorded (``want=None``), or against such a record, each
    output first cut to the recorded extent along the one dimension where
    the two shapes differ (lane 0's rows come first). Uninitialised
    outputs and read-only views are left out."""
    SKIP = ("empty", "empty_like", "new_empty", "empty_strided",
            "new_empty_strided")

    def __init__(self, want=None):
        super().__init__()
        self.want, self.got = want, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in self.SKIP or any(
                r.alias_info is not None and not r.alias_info.is_write
                for r in func._schema.returns):
            return out
        ts = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if self.want is not None:
            ts = [cut_to(t, s) for t, s in zip(ts, self.want[len(self.got)][2])]
        # on the card: an op may hand back a CPU tensor (a wrapped scalar)
        self.got.append((name, [bits_hash(t).to(DEV) for t in ts],
                         [tuple(t.shape) for t in ts]))
        return out


def cut_to(t, shape):
    """``t`` narrowed to ``shape`` along the one dimension where they
    differ by a whole factor (the row dimension of a wider run), or ``t``
    itself where the shapes agree."""
    dims = [d for d in range(t.dim()) if t.shape[d] != shape[d]]
    if not dims:
        return t
    if len(dims) != 1 or t.shape[dims[0]] % shape[dims[0]]:
        raise AssertionError(f"row bits: {tuple(t.shape)} against {shape}")
    return t.narrow(dims[0], 0, shape[dims[0]])


def cohort_step(eng):
    """The cell's local step: ``vmap(grad_and_value(loss))``, the global
    broadcast to the cohort's U rows, and the cohort's first batch."""
    be = eng.backend
    be._ensure_xstack()
    batch = tree_map(lambda a: a[:, 0], be._fused_batches())
    return (torch.func.vmap(torch.func.grad_and_value(be._loss_fn)),
            be._bcast(eng.state), batch)


def peak_above(fn):
    """MiB that ``fn()`` allocated at its peak above what was held."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - held) / 2**20


def gemm_kernels(fn):
    """The GEMM kernels (cuBLAS / CUTLASS names) that ``fn()`` launched,
    with their counts."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:90]: e.count for e in prof.key_averages()
            if e.device_type.name == "CUDA" and any(
                s in e.key for s in ("gemm", "nvjet", "cutlass", "xmma"))}


def row_count_bits(eng, lanes):
    """One local step of the cell's cohort at U rows and at ``lanes`` x U
    rows (the U rows repeated, lane 0 first: a sweep's first step), aten
    op by aten op: the ops whose lane-0 part of the wide output differs
    from the U-row output's bits, the first of them, whether a second
    U-row step repeats the first's bits, whether the grads and losses
    agree, and the GEMM kernels each width launched."""
    grad_fn, stack, batch = cohort_step(eng)
    wide = [tree_map(lambda x: x.repeat((lanes,) + (1,) * (x.dim() - 1)),
                     t) for t in (stack, batch)]
    with OpBits() as narrow:
        g, loss = grad_fn(stack, batch)
    with OpBits(narrow.got) as again:
        grad_fn(stack, batch)
    with OpBits(narrow.got) as wider:
        gw, lw = grad_fn(*wide)
    U = loss.shape[0]

    def differing(run):
        if [n for n, _, _ in run.got] != [n for n, _, _ in narrow.got]:
            raise AssertionError("row bits: the two widths ran other ops")
        same = torch.stack([a == b for (_, ha, _), (_, hb, _) in zip(
            narrow.got, run.got) for a, b in zip(ha, hb)]).tolist()
        ops, i = [], 0
        for k, (name, hs, shapes) in enumerate(narrow.got):
            if not all(same[i:i + len(hs)]):
                ops.append((k, name, shapes[0]))
            i += len(hs)
        return ops

    ops = differing(wider)
    return dict(
        ops=len(narrow.got), repeat_equal=not differing(again),
        differing=dict(Counter(n for _, n, _ in ops)),
        first_differing=[dict(index=k, op=n, shape=s) for k, n, s in ops[:6]],
        grads_equal=all(torch.equal(a, b[:U]) for a, b in zip(
            tree_leaves(g), tree_leaves(gw))),
        losses_equal=torch.equal(loss, lw[:U]),
        gemm_kernels_narrow=gemm_kernels(lambda: grad_fn(stack, batch)),
        gemm_kernels_wide=gemm_kernels(lambda: grad_fn(*wide)))


def llm_sweep(name, args, hist, eng):
    """The cell as a ``LLM_SWEEP_LANES``-seed sweep (``--sweep-seeds``):
    its launches held to ``sweep_expected`` (one Eq. 2 call over E x L
    leaves a round: ceil(E * L / 32) launches; the local step's token
    sums once for the E x U rows, the evaluation's once a lane), lane 0
    against the single run ``hist`` / ``eng`` of the same cell: winners
    equal and the global BIT FOR BIT (the reference's contract), and
    ``row_count_bits`` at the sweep's width must find no op whose lane-0
    bits differ."""
    arch = args.arch
    base = launch_train.build_llm_engine(args)
    sw = SweepSpec.grid(base.spec, seed=range(args.seed, args.seed
                                              + LLM_SWEEP_LANES))
    res, dt, launches, round_s, _ = timed(base, lambda e: e.run_sweep(sw))
    merges = ["digital"] * sum(1 for h in res for w in h.winners if w)
    want = sweep_expected(base, res, merges, [])
    rounds = len(hist.winners)
    step = LLM_ROUND_LAUNCHES[arch]["token_sum"] - LLM_EVAL_TOKEN_SUMS[arch]
    want["token_sum"] = (step + LLM_SWEEP_LANES
                         * LLM_EVAL_TOKEN_SUMS[arch]) * rounds
    if launches != want:
        raise AssertionError(f"{name} sweep: launches {launches}, the code "
                             f"predicts {want}")
    rows = row_count_bits(eng, LLM_SWEEP_LANES)
    if not rows["repeat_equal"]:
        raise AssertionError(f"{name}: a local step's bits differ run to run")
    lane0 = res.lane_params(0)
    pairs = list(zip(tree_leaves(lane0), tree_leaves(eng.global_params)))
    out = dict(lanes=LLM_SWEEP_LANES, launches_per_round={
        k: launches[k] / rounds for k in LLM_KERNELS},
        lane0_bitwise=all(torch.equal(a, b) for a, b in pairs),
        lane0_max_abs_gap=max(float((a - b).abs().max()) for a, b in pairs),
        row_count_bits=rows,
        median_later_round_s=statistics.median(round_s[1:]))
    if res[0].winners != hist.winners or not out["lane0_bitwise"] \
            or rows["differing"] or not rows["grads_equal"] \
            or not rows["losses_equal"]:
        emit(f"{name}_sweep_fault", **out)
        raise AssertionError(f"{name} sweep: lane 0 is not the run bit for "
                             f"bit (row_count_bits: {rows['differing']})")
    return out


def decode_gaps(params, cfg, prompts, res, prefix=None, per_row=None,
                frames=None):
    """``generate``'s prefill and decode logits against ``forward`` over
    the prompt and the generated tokens (and the same vlm patches or
    audio frames): per step (the prefill first), the largest absolute gap
    and the largest gap over the row's logit range; and the share of rows
    whose argmax agrees. A ``per_row`` list gets each step's (B,) gaps
    over the row's range."""
    P = 0 if prefix is None else prefix.shape[1]
    S = prompts.shape[1]
    toks = torch.cat([prompts, res["tokens"][:, :-1].to(prompts.dtype)], 1)
    with torch.no_grad():
        full, _, _ = llm.forward(params, toks, cfg, prefix_embeds=prefix,
                                 enc_frames=frames)
    absg, relg, agree = [], [], []
    for i, got in enumerate([res["prefill_logits"], *res["step_logits"]]):
        want = full[:, P + S - 1 + i, :cfg.vocab_size].float()
        got = got[:, :cfg.vocab_size].float()
        d = (got - want).abs().amax(dim=-1)
        span = want.amax(dim=-1) - want.amin(dim=-1)
        absg.append(float(d.max()))
        relg.append(float((d / span).max()))
        if per_row is not None:
            per_row.append((d / span).cpu())
        agree.append(float((got.argmax(-1) == want.argmax(-1))
                           .float().mean()))
    del full
    return absg, relg, agree


def forced_decode(params, cfg, prompts, tokens, frames=None):
    """The prefill of ``prompts`` into fresh caches on their device, then
    a decode step a token of ``tokens`` (a generation's, teacher-forced):
    the prefill's last logits and each step's, as ``generate`` lists
    them (``[prefill, step 1, ...]``), so another device or dtype can be
    held to a run's steps on the same inputs."""
    B, S = prompts.shape
    G = tokens.shape[1]
    with torch.no_grad():
        caches = llm.make_caches(
            cfg, B, S + G, device=prompts.device,
            enc_len=None if frames is None else frames.shape[1])
        logits, caches, _ = llm.forward(params, prompts, cfg, caches=caches,
                                        enc_frames=frames)
        out = [logits[:, -1]]
        for i in range(G - 1):
            logits, caches = llm.decode_step(params, caches, tokens[:, i],
                                             S + i, cfg)
            out.append(logits)
    return out


def ring_wrap_gaps(params, cfg, toks):
    """``cfg``'s long-context variant (every layer windowed, within the
    ring) decoded through a ring cache of ``RING_WRAP["cache"]`` entries:
    the prefill of ``RING_WRAP["prefill"]`` tokens of ``toks``, then a
    decode step a token to its end, past the ring's length. The largest
    absolute gap to the long-context ``forward``'s row, per step (the
    prefill first)."""
    P, C = RING_WRAP["prefill"], RING_WRAP["cache"]
    wins = cfg.layer_windows(0, long_context=True)
    if not 0 < min(wins) <= max(wins) <= C < toks.shape[1]:
        raise AssertionError(f"ring wrap: windows {wins}, ring {C}, "
                             f"{toks.shape[1]} positions")
    with torch.no_grad():
        full = llm.forward(params, toks, cfg, long_context=True)[0]
        caches = llm.make_caches(cfg, toks.shape[0], C, long_context=True,
                                 device=toks.device)
        pre, caches, _ = llm.forward(params, toks[:, :P], cfg,
                                     caches=caches, long_context=True)
        gaps = [float((pre - full[:, :P]).abs().max())]
        for i in range(P, toks.shape[1]):
            logits, caches = llm.decode_step(params, caches, toks[:, i], i,
                                             cfg, long_context=True)
            gaps.append(float((logits - full[:, i]).abs().max()))
    return gaps


def phase_llm_serve_reduced():
    """``launch.serve`` for each arch of ``SERVE_ARCHS`` (reduced, f32): 4
    prompts of 32 tokens (hymba's of 80, past its 64-token window), 16
    greedy tokens; every decode step's logits and the prefill's against
    ``forward``'s row at that position within 1e-3 absolute (the bar of
    tests/test_decode_parity.py). hymba's 96 tokens also through its
    long-context variant's wrapping ring cache (``ring_wrap_gaps``), at
    the same bar. whisper-small (an encoder over 64 stub frames, then the
    cross-attention decoder) holds ``WHISPER_REDUCED``'s bars instead."""
    rows = {}
    for arch in SERVE_ARCHS:
        argv = ["--arch", arch, "--batch", "4", "--prompt-len",
                str(SERVE_PROMPT.get(arch, 32)), "--gen-len", "16"]
        (cfg, params, inputs, res), text = quiet(launch_serve.main, argv)
        frames = inputs["enc_frames"]
        absg, relg, agree = decode_gaps(params, cfg, inputs["tokens"], res,
                                        inputs["prefix_embeds"],
                                        frames=frames)
        rows[arch] = dict(prompt=inputs["tokens"].shape[1],
                          prefill_ms=res["prefill_s"] * 1e3,
                          decode_ms_per_token=res["decode_s"] * 1e3 / 15,
                          max_abs_gap=max(absg), argmax_agree=min(agree),
                          printed=text.strip().splitlines())
        if cfg.is_encdec:
            cpu = forced_decode(
                tree_map(lambda t: t.cpu(), params), cfg,
                inputs["tokens"].cpu(), res["tokens"].cpu(), frames.cpu())
            card = [res["prefill_logits"], *res["step_logits"]]
            vs_cpu = [float((a.cpu() - b).abs().max())
                      for a, b in zip(card, cpu)]
            rows[arch].update(
                frames=list(frames.shape), prefill_vs_forward=absg[0],
                decode_vs_cpu_decode=vs_cpu,
                decode_vs_forward_reference_fault=absg[1:],
                bars=WHISPER_REDUCED)
            if absg[0] >= WHISPER_REDUCED["prefill_bar"] \
                    or max(vs_cpu) >= WHISPER_REDUCED["cpu_bar"]:
                raise AssertionError(
                    f"llm_serve_reduced {arch}: prefill against forward "
                    f"{absg[0]}, the card's decode against the CPU's "
                    f"{vs_cpu}")
        elif max(absg) >= 1e-3:
            raise AssertionError(f"llm_serve_reduced {arch}: decode against "
                                 f"forward {absg}")
        if arch == RING_WRAP["arch"]:
            toks = torch.cat([inputs["tokens"], res["tokens"].to(
                inputs["tokens"].dtype)], 1)
            ring = ring_wrap_gaps(params, cfg, toks)
            rows[arch]["ring_wrap"] = dict(RING_WRAP, end=toks.shape[1],
                                           max_abs_gap=max(ring))
            if max(ring) >= 1e-3:
                raise AssertionError(f"llm_serve_reduced {arch}: the "
                                     f"ring-cache decode against forward "
                                     f"{ring}")
        del params, res
    emit("llm_serve_reduced", archs=rows, bar="1e-3 absolute, f32")
    torch.cuda.empty_cache()


def randn_bf16(seed, shape):
    g = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randn(shape, generator=g, device=DEV, dtype=torch.bfloat16)


def check_full_leaf(path, shape, U=2, seed=0, cols=1 << 27):
    """Rows 1-3 on one full-width bf16 leaf, a (U, ...) stack: the Eq. 2
    sums against the plain version row by row (rtol 1e-5), the gather
    merge and the SGD step against the plain version column slice by
    column slice (both elementwise along the columns), bit for bit. Each
    kernel's time and bound ride along. Returns {kernel: (err, bit)}."""
    n = int(np.prod(shape))
    stack = randn_bf16(seed, (U,) + shape)
    glob = randn_bf16(seed + 1, shape)
    flat, gflat = stack.view(U, n), glob.view(n)
    item = 2
    out, times = {}, {}

    def clock(fn):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        r = fn()
        b.record()
        b.synchronize()
        return r, a.elapsed_time(b)

    (d2, g2), ms = clock(lambda: ops.delta_norm_leaves([stack], [glob]))
    times["delta_norm"] = dict(ms=ms, bound_ms=(U + 1) * n * item
                               / HBM_BYTES_PER_S * 1e3)
    rows = [ref.delta_norm_stacked_ref(stack[u:u + 1], glob)
            for u in range(U)]
    d2w, g2w = torch.cat([d for d, _ in rows]), rows[0][1]
    del rows
    # the exact sums, in f64 over column slices: which side of a gap errs
    exact = torch.zeros(U + 1, dtype=torch.float64, device=DEV)
    for lo in range(0, n, cols):
        g = gflat[lo:lo + cols].double()
        exact[:U] += ((flat[:, lo:lo + cols].double() - g) ** 2).sum(1)
        exact[U] += (g * g).sum()
    got = torch.cat([d2[0], g2]).double()
    plain = torch.cat([d2w, g2w.reshape(1)]).double()
    sums = dict(kernel_rel_err_vs_f64=float(((got - exact) / exact).abs()
                                            .max()),
                plain_rel_err_vs_f64=float(((plain - exact) / exact).abs()
                                           .max()))
    emit("llm_full_leaf_sums", leaf=path, **sums)
    e1, b1 = compare(f"{path} delta_norm.d2", d2[0], d2w, torch.float32,
                     rel_only=True)
    e2, b2 = compare(f"{path} delta_norm.g2", g2[0], g2w, torch.float32,
                     rel_only=True)
    out["delta_norm"] = (max(e1, e2), b1 and b2)
    idx, w = merge_inputs(U, [1, 0], k_pad=2)
    merged, ms = clock(lambda: ops.gather_combine(stack, idx, w, glob))
    times["gather_combine"] = dict(ms=ms, bound_ms=3 * n * item
                                   / HBM_BYTES_PER_S * 1e3)
    mflat, err = merged.view(n), 0.0
    for lo in range(0, n, cols):
        sl = slice(lo, min(n, lo + cols))
        err = max(err, bit_check(
            f"{path} gather_combine cols {lo}", mflat[sl],
            ref.gather_combine_ref(flat[:, sl], idx, w, gflat[sl]),
            torch.bfloat16))
    out["gather_combine"] = (err, True)
    del merged, mflat
    grad = randn_bf16(seed + 2, (U,) + shape)
    p = stack.clone()
    _, ms = clock(lambda: ops.fused_sgd_leaves([p], [grad], LR))
    times["fused_sgd"] = dict(ms=ms, bound_ms=3 * U * n * item
                              / HBM_BYTES_PER_S * 1e3)
    pflat, grflat, err = p.view(U, n), grad.view(U, n), 0.0
    for lo in range(0, n, cols):
        sl = slice(lo, min(n, lo + cols))
        err = max(err, bit_check(
            f"{path} fused_sgd cols {lo}", pflat[:, sl],
            ref.fused_sgd_ref(flat[:, sl], grflat[:, sl], LR),
            torch.bfloat16))
    out["fused_sgd"] = (err, True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del stack, glob, grad, p, flat, gflat, pflat, grflat
    torch.cuda.empty_cache()
    return out, dict(leaf=[U, *shape], elements=U * n,
                     past_2_31=U * n > 2**31, peak_gb=peak, times=times,
                     **sums)


def profile_decode(params, cfg, prompts, steps, frames=None):
    """``steps`` decode steps after a prefill (of an encoder-decoder's
    ``frames`` too), under ``torch.profiler``: the device's busy time and
    kernel launches a step, its idle share, and the kernels that take
    most of it."""
    from torch.profiler import ProfilerActivity, profile
    S = prompts.shape[1]
    with torch.no_grad():
        caches = llm.make_caches(
            cfg, prompts.shape[0], S + steps + 1, device=DEV,
            enc_len=None if frames is None else frames.shape[1])
        _, caches, _ = llm.forward(params, prompts, cfg, caches=caches,
                                   enc_frames=frames)
        tok = prompts[:, -1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(steps):
                _, caches = llm.decode_step(params, caches, tok, S + i, cfg)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted([e for e in prof.key_averages()
                   if e.device_type.name == "CUDA"
                   and e.self_device_time_total > 0],
                  key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    return dict(steps=steps, wall_ms_per_step_profiled=wall / steps,
                device_busy_ms_per_step=busy / steps,
                device_idle_share=1.0 - busy / wall,
                launches_per_step=sum(e.count for e in rows) / steps,
                top=[dict(name=e.key[:70], ms_per_step=e.self_device_time_total
                          / 1e3 / steps, count=e.count) for e in rows[:6]])


def phase_llm_serve_yi9b_full(seed=0):
    """yi-9b at its published dims (48 layers, d_model 4096, 32 heads
    with kv 4, head_dim 128, d_ff 11008, vocab 64000), bf16, params drawn
    on the card from a CUDA generator seeded with ``seed``: 4 prompts of
    512 tokens prefilled into ``make_caches(..., 528)``, 16 greedy
    tokens, twice (the second timed; both must give the same tokens);
    the prefill's and every decode step's logits against ``forward``'s
    row at that position, the largest gap over the row's logit range
    within ``YI_FULL["bar"]``. Then, the params freed, rows 1-3 on the
    full-width leaves of ``YI_FULL_LEAVES`` at U = 2, one leaf at a time.
    Returns {kernel: (err, bit)} over those leaves."""
    cfg = get_config("yi-9b")
    B, S, G = YI_FULL["batch"], YI_FULL["prompt"], YI_FULL["gen"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(seed)
    t0 = time.perf_counter()
    params = llm.init_params(gen, cfg, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = llm.param_count(params)
    param_gb = sum(p.numel() * p.element_size()
                   for p in tree_leaves(params)) / 1e9
    shapes = {"/".join(k): tuple(v.shape) for k, v in _paths(params)}
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=DEV, dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    first = launch_serve.generate(params, cfg, prompts, G)
    res = launch_serve.generate(params, cfg, prompts, G)
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    if not torch.equal(first["tokens"], res["tokens"]):
        raise AssertionError("llm_serve_yi9b_full: two runs generated "
                             "different tokens")
    absg, relg, agree = decode_gaps(params, cfg, prompts, res)
    decode_prof = profile_decode(params, cfg, prompts, steps=2)
    kv = llm.make_caches(cfg, B, S + G, device="meta")
    kv_gb = sum(t.numel() * t.element_size() for t in tree_leaves(kv)) / 1e9
    # bounds: a decode step reads every weight once (bytes); the prefill
    # does two operations a weight a token on the tensor cores, the
    # embedding table's rows only gathered (operations)
    dense = n_params - int(np.prod(shapes["embed/embedding"]))
    prefill_bound = max(param_gb * 1e9 / HBM_BYTES_PER_S,
                        2.0 * dense * B * S / BF16_FLOPS_PER_S) * 1e3
    decode_bound = param_gb * 1e9 / HBM_BYTES_PER_S * 1e3
    fields = dict(
        arch="yi-9b", layers=cfg.num_layers, d_model=cfg.d_model,
        params=n_params, param_gb=param_gb, kv_cache_gb=kv_gb,
        batch=B, prompt=S, gen=G, init_s=init_s, init_peak_gb=init_peak,
        serve_peak_gb=serve_peak,
        prefill_ms=res["prefill_s"] * 1e3,
        prefill_ms_first=first["prefill_s"] * 1e3,
        prefill_bound_ms=prefill_bound,
        decode_ms_per_token=res["decode_s"] * 1e3 / (G - 1),
        decode_bound_ms=decode_bound,
        max_abs_gap=absg, max_gap_over_range=relg, argmax_agree=agree,
        bar=YI_FULL["bar"], decode_profile=decode_prof)
    del params, first, res
    torch.cuda.empty_cache()
    if max(relg) > YI_FULL["bar"]:
        emit("llm_serve_yi9b_full", **fields)
        raise AssertionError("llm_serve_yi9b_full: decode logits beyond "
                             f"{YI_FULL['bar']} of the row's range: {relg}")
    worst, leaves = {}, {}
    for i, path in enumerate(YI_FULL_LEAVES):
        torch.cuda.reset_peak_memory_stats()
        got, info = check_full_leaf(path, shapes[path], seed=9000 + 10 * i)
        leaves[path] = info
        for k, v in got.items():
            fold(worst, k, v)
    emit("llm_serve_yi9b_full", **fields, full_leaves=leaves,
         full_leaf_max_abs_err={k: e for k, (e, _) in worst.items()},
         full_leaf_bit_equal={k: b for k, (_, b) in worst.items()})
    return worst


def ssm_serving_work(cfg, shapes, B, S, G):
    """What a full-width SSM / hybrid serving run must do, from the
    shapes: the prefill's bf16 operations (2 a GEMM weight a token: every
    leaf but an untied embedding table, whose rows are only gathered),
    its f32 operations (the chunked SSD scan's four contractions, and the
    hybrid layers' causal attention scores and sums within the window:
    the reference's f32 math) and the bytes a decode step must move (the
    weights it reads, the SSM and conv states read and written, the KV
    cache read at the mean step's length)."""
    L = cfg.num_layers
    Din, N, H, P = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads,
                    cfg.ssm_head_dim)
    n_all = sum(int(np.prod(v)) for v in shapes.values())
    table = 0 if cfg.tie_embeddings else int(np.prod(
        shapes["embed/embedding"]))
    bf16_ops = 2.0 * (n_all - table) * B * S
    l = min(cfg.ssm_chunk, S)
    chunks = -(-S // l)
    # CB and the intra-chunk sum over the causal pairs (l (l + 1) / 2 of
    # them: n and h p multiply-adds each), the chunk states and the
    # chunk-start term (l h p n each)
    pairs = l * (l + 1) / 2
    f32_ops = 2.0 * L * B * chunks * (pairs * (N + Din) + 2 * l * Din * N)
    kv_step = 0.0
    if cfg.family == "hybrid":
        Hq, Kv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        for w in cfg.layer_windows(S):
            pairs = sum(min(i + 1, w or S) for i in range(S))
            f32_ops += 2.0 * 2 * B * pairs * Hq * Dh
            kv_step += 2.0 * B * min(S + G / 2, w or S + G) * Kv * Dh * 2
    state = L * B * (H * P * N * 4 + (cfg.ssm_conv_width - 1)
                     * (Din + 2 * N) * 2)
    step_bytes = (n_all - table) * 2 + 2 * state + kv_step
    return dict(prefill_bf16_ops=bf16_ops, prefill_f32_ops=f32_ops,
                prefill_bound_ms=max(
                    (n_all - table) * 2 / HBM_BYTES_PER_S,
                    bf16_ops / BF16_FLOPS_PER_S + f32_ops / F32_FLOPS_PER_S)
                * 1e3,
                decode_step_gb=step_bytes / 1e9, state_gb=state / 1e9,
                decode_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3)


def phase_llm_serve_ssm_full(tag, seed=0):
    """``SSM_FULL[tag]`` at its published widths and depth (mamba2-370m:
    48 Mamba-2 layers, d_model 1024; hymba-1.5b: 32 hybrid layers, d_model
    1600), bf16, params drawn on the card from a CUDA generator seeded
    with ``seed``: ``YI_FULL``'s 4 prompts of 512 tokens prefilled (the
    chunked SSD scan over two 256-token chunks, into the caches), 16
    greedy tokens by the single-step recurrence, twice (the second timed;
    equal tokens); prefill and decode against their bounds
    (``ssm_serving_work``), the decode profile (launches a step, the
    device's idle share) and the peaks. Decode against ``forward``: the
    bf16 run's prefill and step logits against the bf16 forward over its
    tokens (within the arch's bars) and against the f32
    forward of the same weights (no further off than ``SSM_BF16_FACTOR``
    x the bf16 forward), and the same generation in f32 against the f32
    forward within ``SSM_F32_BAR`` of the row's range."""
    arch, bars = SSM_FULL[tag]
    name = f"llm_serve_{tag}_full"
    cfg = get_config(arch)
    B, S, G = YI_FULL["batch"], YI_FULL["prompt"], YI_FULL["gen"]
    V = cfg.vocab_size
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(seed)
    t0 = time.perf_counter()
    params = llm.init_params(gen, cfg, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    shapes = {"/".join(k): tuple(v.shape) for k, v in _paths(params)}
    prompts = torch.randint(0, V, (B, S), generator=gen, device=DEV,
                            dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    first = launch_serve.generate(params, cfg, prompts, G)
    res = launch_serve.generate(params, cfg, prompts, G)
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    if not torch.equal(first["tokens"], res["tokens"]):
        raise AssertionError(f"{name}: two runs generated different tokens")
    decode_prof = profile_decode(params, cfg, prompts, steps=2)
    # the same weights in f32: its forward against the bf16 run's steps and
    # the bf16 forward's rows on the same tokens, and its own generation
    # against its own forward
    p32 = tree_map(lambda t: t.float(), params)
    c32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    _, gap16, _ = decode_gaps(params, cfg, prompts, res)
    _, dec16_vs32, _ = decode_gaps(p32, c32, prompts, res)
    toks = torch.cat([prompts, res["tokens"][:, :-1].to(prompts.dtype)], 1)
    with torch.no_grad():
        full = llm.forward(params, toks, cfg)[0]
    _, fwd16_vs32, _ = decode_gaps(p32, c32, prompts, dict(
        tokens=res["tokens"], prefill_logits=full[:, S - 1],
        step_logits=[full[:, S + i] for i in range(G - 1)]))
    del full
    r32 = launch_serve.generate(p32, c32, prompts, G)
    _, gap32, _ = decode_gaps(p32, c32, prompts, r32)
    caches = llm.make_caches(cfg, B, S + G, device="meta")
    fields = dict(
        arch=arch, family=cfg.family, layers=cfg.num_layers,
        d_model=cfg.d_model, ssm_heads=cfg.ssm_heads, ssm_state=cfg.ssm_state,
        windows=sorted(set(cfg.layer_windows(S))),
        params=llm.param_count(params),
        param_gb=sum(p.numel() * p.element_size()
                     for p in tree_leaves(params)) / 1e9,
        cache_gb=sum(t.numel() * t.element_size()
                     for t in tree_leaves(caches)) / 1e9,
        batch=B, prompt=S, gen=G, init_s=init_s, init_peak_gb=init_peak,
        serve_peak_gb=serve_peak, units="GB = 1e9 bytes",
        prefill_ms=res["prefill_s"] * 1e3,
        prefill_ms_first=first["prefill_s"] * 1e3,
        decode_ms_per_token=res["decode_s"] * 1e3 / (G - 1),
        **ssm_serving_work(cfg, shapes, B, S, G),
        bf16_decode_vs_forward=gap16, bf16_bars=bars,
        bf16_decode_vs_f32=dec16_vs32, bf16_forward_vs_f32=fwd16_vs32,
        f32_decode_vs_forward=gap32, f32_bar=SSM_F32_BAR,
        f32_tokens_equal_bf16=bool(torch.equal(r32["tokens"],
                                               res["tokens"])),
        decode_profile=decode_prof,
        # the profiler slows the host: the idle share against the timed
        # (unprofiled) decode step
        decode_idle_share_timed=1.0 - decode_prof["device_busy_ms_per_step"]
        / (res["decode_s"] * 1e3 / (G - 1)))
    del params, p32, first, res, r32
    torch.cuda.empty_cache()
    emit(name, **fields)
    early = gap16[:bars["early"] + 1]
    if max(early) > bars["early_bar"] or max(gap16) > bars["bar"]:
        raise AssertionError(f"{name}: bf16 decode logits beyond {bars} of "
                             f"the row's range: {gap16}")
    if max(dec16_vs32) > SSM_BF16_FACTOR * max(fwd16_vs32):
        raise AssertionError(f"{name}: the bf16 decode lies further off the "
                             f"f32 logits ({dec16_vs32}) than the bf16 "
                             f"forward does ({fwd16_vs32})")
    if max(gap32) > SSM_F32_BAR:
        raise AssertionError(f"{name}: f32 decode logits beyond "
                             f"{SSM_F32_BAR} of the row's range: {gap32}")
    return fields


def whisper_serving_work(cfg, shapes, B, S, G):
    """What a full-width whisper serving run must do, from the shapes.
    The prefill: the encoder's GEMMs (2 operations a weight a frame), its
    bidirectional attention (the reference's f32 math: QK^T and PV, 4
    B H T^2 Dh a layer), the cross keys and values (2 a ``wk`` / ``wv``
    weight a frame), the decoder's GEMMs over the prompt (the tied
    table's unembedding included) and its f32 causal self- and cross
    attention. A decode step's bytes: the decoder's weights but the
    cross ``wk`` / ``wv`` (their keys are cached), the tied table, the
    cross caches and the self caches at the mean step's length."""
    T, L, Le = cfg.encoder_seq, cfg.num_layers, cfg.encoder_layers
    H, Kv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    size = {k: int(np.prod(v)) for k, v in shapes.items()}
    enc = sum(v for k, v in size.items() if k.startswith("encoder/"))
    xkv = sum(v for k, v in size.items()
              if k.startswith("blocks0/xattn/w") and k[-2:] in ("wk", "wv"))
    dec = sum(v for k, v in size.items() if k.startswith("blocks0/")) - xkv
    table = size["embed/embedding"]
    enc_bf16 = 2.0 * enc * B * T
    enc_f32 = 4.0 * B * H * T * T * Dh * Le
    dec_bf16 = 2.0 * (xkv * B * T + (dec + table) * B * S)
    dec_f32 = 4.0 * B * H * Dh * L * (S * (S + 1) / 2 + S * T)
    all_bytes = sum(size.values()) * 2
    cross = L * 2 * B * T * Kv * Dh * 2
    step_bytes = ((dec + table) * 2 + cross
                  + L * 2 * B * (S + G / 2) * Kv * Dh * 2)

    def bound(nbytes, bf16, f32):
        return max(nbytes / HBM_BYTES_PER_S,
                   bf16 / BF16_FLOPS_PER_S + f32 / F32_FLOPS_PER_S) * 1e3

    return dict(
        encoder_bf16_ops=enc_bf16, encoder_f32_ops=enc_f32,
        decoder_prefill_bf16_ops=dec_bf16, decoder_prefill_f32_ops=dec_f32,
        encoder_bound_ms=bound(enc * 2, enc_bf16, enc_f32),
        decoder_prefill_bound_ms=bound((dec + xkv + table) * 2, dec_bf16,
                                       dec_f32),
        prefill_bound_ms=bound(all_bytes, enc_bf16 + dec_bf16,
                               enc_f32 + dec_f32),
        cross_cache_gb=cross / 1e9, decode_step_gb=step_bytes / 1e9,
        decode_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3)


def phase_llm_serve_whisper_full(seed=0):
    """whisper-small at its published dims (12 encoder and 12 decoder
    layers, d_model 768, 12 heads, d_ff 3072, vocab 51865), bf16, params
    and 4 x 1500 frame embeddings drawn on the card from a CUDA generator
    seeded with ``seed``: 64-token prompts prefilled (the encoder, then
    the decoder writing its self and cross caches), 16 greedy tokens,
    twice (the second timed; equal tokens). The prefill against
    ``forward`` within ``WHISPER_FULL["prefill_bar"]`` of the row's logit
    range; the bf16 run's prefill and steps against the f32 decode of the
    same weights, frames and tokens within ``WHISPER_FULL["f32_bar"]``.
    The encoder timed alone; prefill, encoder, decoder prefill and decode
    against their bounds (``whisper_serving_work``); launches a decode
    step, the device's idle share, the peaks."""
    cfg = get_config("whisper-small")
    B, S, G = WHISPER_FULL["batch"], WHISPER_FULL["prompt"], \
        WHISPER_FULL["gen"]
    V = cfg.vocab_size
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(seed)
    t0 = time.perf_counter()
    params = llm.init_params(gen, cfg, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    shapes = {"/".join(k): tuple(v.shape) for k, v in _paths(params)}
    prompts = torch.randint(0, V, (B, S), generator=gen, device=DEV,
                            dtype=torch.int32)
    frames = llm_frontends.audio_frame_embeddings(gen, B, cfg)
    torch.cuda.reset_peak_memory_stats()
    first = launch_serve.generate(params, cfg, prompts, G, enc_frames=frames)
    res = launch_serve.generate(params, cfg, prompts, G, enc_frames=frames)
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    if not torch.equal(first["tokens"], res["tokens"]):
        raise AssertionError("llm_serve_whisper_full: two runs generated "
                             "different tokens")
    enc_ms = []
    with torch.no_grad():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            llm.encode_audio(params, frames, cfg)
            torch.cuda.synchronize()
            enc_ms.append((time.perf_counter() - t0) * 1e3)
    decode_prof = profile_decode(params, cfg, prompts, steps=2,
                                 frames=frames)
    absg, relg, _ = decode_gaps(params, cfg, prompts, res, frames=frames)
    p32 = tree_map(lambda t: t.float(), params)
    c32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    f32 = forced_decode(p32, c32, prompts, res["tokens"], frames.float())
    vs_f32 = []
    for got, want in zip([res["prefill_logits"], *res["step_logits"]], f32):
        got, want = got[:, :V].float(), want[:, :V]
        span = want.amax(dim=-1) - want.amin(dim=-1)
        vs_f32.append(float(((got - want).abs().amax(dim=-1) / span).max()))
    del p32, f32
    caches = llm.make_caches(cfg, B, S + G, device="meta")
    prefill_ms = res["prefill_s"] * 1e3
    decode_ms = res["decode_s"] * 1e3 / (G - 1)
    fields = dict(
        arch="whisper-small", layers=cfg.num_layers,
        encoder_layers=cfg.encoder_layers, d_model=cfg.d_model,
        frames=list(frames.shape), params=llm.param_count(params),
        param_gb=sum(p.numel() * p.element_size()
                     for p in tree_leaves(params)) / 1e9,
        cache_gb=sum(t.numel() * t.element_size()
                     for t in tree_leaves(caches)) / 1e9,
        batch=B, prompt=S, gen=G, init_s=init_s, init_peak_gb=init_peak,
        serve_peak_gb=serve_peak, units="GB = 1e9 bytes",
        prefill_ms=prefill_ms, prefill_ms_first=first["prefill_s"] * 1e3,
        encoder_ms=min(enc_ms), encoder_ms_runs=enc_ms,
        decoder_prefill_ms=prefill_ms - min(enc_ms),
        decode_ms_per_token=decode_ms,
        **whisper_serving_work(cfg, shapes, B, S, G),
        prefill_vs_forward_over_range=relg[0],
        prefill_vs_forward_abs=absg[0],
        decode_vs_forward_reference_fault=relg[1:],
        bf16_vs_f32_decode=vs_f32, bars=WHISPER_FULL,
        decode_profile=decode_prof,
        decode_idle_share_timed=1.0 - decode_prof["device_busy_ms_per_step"]
        / decode_ms)
    del params, first, res
    torch.cuda.empty_cache()
    emit("llm_serve_whisper_full", **fields)
    if relg[0] > WHISPER_FULL["prefill_bar"] \
            or max(vs_f32) > WHISPER_FULL["f32_bar"]:
        raise AssertionError(
            f"llm_serve_whisper_full: prefill against forward {relg[0]} "
            f"of the range, bf16 against f32 decode {vs_f32}")
    return fields


def silo_engine(device, merge_dtype="float32", rounds=None, cell=None,
                init=None):
    """A cross-silo cell (``SILO``, or ``cell``) on ``device``:
    ``SiloBackend`` over ``make_token_stream``'s non-IID silos (the
    reference demo's data) through ``FLEngine``; the reduced arch from
    the seed (a CPU generator: the same on every device) unless the
    cell cuts the published arch's depth (``layers``) and ``init`` draws
    its params; the cell's ``levers`` replace config fields."""
    c = cell or SILO
    cfg = get_config(c["arch"])
    cfg = dataclasses.replace(cfg, num_layers=c["layers"]) if "layers" in c \
        else cfg.reduced()
    cfg = dataclasses.replace(cfg, **c.get("levers", {}))
    S, B, R = c["silos"], c["batch"], rounds or c["rounds"]
    data = make_token_stream(S, c["seq"], c["rounds"] * B, cfg.vocab_size,
                             noniid=True, seed=c["seed"])
    backend = SiloBackend(cfg, data, lr=c["lr"], batch_size=B,
                          merge_dtype=merge_dtype, device=device)
    spec = ExperimentSpec(rounds=R, k_per_round=1,
                          strategy="priority-distributed",
                          counter_threshold=c["threshold"], seed=c["seed"])
    params = init(cfg) if init else llm.init_params(c["seed"], cfg,
                                                    device=device)
    return FLEngine(spec, backend, params)


def expanded_over_silos(stacked):
    """Whether every leaf of a silo stack is one tensor expanded over the
    silo axis (stride 0): its replicas equal by construction."""
    return all(p.stride(0) == 0 for p in tree_leaves(stacked))


def stamped_run(eng):
    """``eng.run()`` with each round stamped at its training (the device
    synchronised) and the merges' stacks checked ``expanded_over_silos``;
    the launches counted from zero just before the run and read just
    after. Returns (history, launches, round ms, run s, peak MiB,
    expanded after each merge)."""
    be = eng.backend
    expanded, stamps = [], []
    merge, train = be.merge, be.train_round

    def spy_merge(state, tr, winners, **kw):
        out = merge(state, tr, winners, **kw)
        expanded.append(expanded_over_silos(out))
        return out

    def spy_train(*a, **kw):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return train(*a, **kw)
    be.merge, be.train_round = spy_merge, spy_train
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                      # just before the path
    t0 = time.perf_counter()
    hist = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)             # just after it
    peak = torch.cuda.max_memory_allocated() / 2**20
    stamps.append(time.perf_counter())
    be.merge, be.train_round = merge, train
    round_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    return hist, launches, round_ms, dt, peak, expanded


def phase_silo_round():
    """The cross-silo path: ``SiloBackend`` through ``FLEngine.run`` on
    the card (``SILO``), each round stamped; its launches held to
    ``SILO_ROUND_LAUNCHES`` (PERF.md's prediction) exactly; the same run
    on the CPU: every history count equal, the globals within 1e-5 of
    each leaf's largest magnitude; round ms, peak memory, and the
    device's idle share from a profiled run of a fresh engine; then one
    round with ``merge_dtype="bfloat16"`` against the f32 merge's
    (``SILO_BF16_ATOL``, and ``SILO_BF16_REL`` of the f32 merge's move
    off the global). The replicas after each merge are one tensor
    expanded over the silo axis, equal by construction; that structure
    is what is checked. Returns the launches."""
    R = SILO["rounds"]
    eng = silo_engine(DEV)
    hist, launches, round_ms, dt, peak, expanded = stamped_run(eng)
    t0 = time.perf_counter()
    cpu = silo_engine("cpu")
    chist = cpu.run()
    cpu_s = time.perf_counter() - t0
    for name in HISTORY_COUNTS:
        if getattr(hist, name) != getattr(chist, name):
            raise AssertionError(f"silo_round: {name} {getattr(hist, name)} "
                                 f"on the card, {getattr(chist, name)} on "
                                 "the CPU")
    if not np.array_equal(hist.selections, chist.selections):
        raise AssertionError("silo_round: selections differ from the CPU's")
    gap = max(float((p.cpu() - q).abs().max() / q.abs().max().clamp(
        min=1e-30)) for p, q in zip(tree_leaves(eng.global_params),
                                     tree_leaves(cpu.global_params)))
    del eng
    want = {k: v * R for k, v in SILO_ROUND_LAUNCHES.items()}
    got = {k: launches[k] for k in want}
    prof = profiled("silo_round", silo_engine(DEV), lambda e: e.run(), R)
    # one round with the deltas shipped in bf16, against the f32 merge
    one = {m: silo_engine(DEV, m, rounds=1) for m in ("float32", "bfloat16")}
    start = [p.clone() for p in tree_leaves(one["float32"].global_params)]
    for e in one.values():
        e.run()
    m16, m32 = (tree_leaves(one[m].global_params)
                for m in ("bfloat16", "float32"))
    bf16_gap = max(float((p - q).abs().max()) for p, q in zip(m16, m32))
    update = max(float((q - w).abs().max()) for q, w in zip(m32, start))
    del one, start, m16, m32
    fields = dict(
        arch=SILO["arch"], cell=SILO, winners=hist.winners,
        selections=hist.selections.tolist(),
        uploads_total=hist.uploads_total, train_loss=hist.train_loss,
        priorities_round0=hist.priorities[0], card_equals_cpu=True,
        global_max_rel_gap_vs_cpu=gap, cpu_s=cpu_s,
        replicas_expanded_after_each_merge=expanded,
        launches=launches, predicted=want, run_s=dt, round_ms=round_ms,
        median_later_round_ms=statistics.median(round_ms[1:]),
        peak_mem_mb=peak, device_idle_share=prof["device_idle_share"],
        launches_profiled=prof["launches"],
        bf16_merge_max_abs_gap=bf16_gap, f32_merge_update_max_abs=update,
        bf16_gap_over_update=bf16_gap / max(update, 1e-30),
        bf16_atol=SILO_BF16_ATOL, bf16_rel_to_update=SILO_BF16_REL)
    emit("silo_round", **fields)
    if got != want:
        raise AssertionError(f"silo_round: launches {got}, PERF.md "
                             f"predicts {want}")
    if not expanded or not all(expanded):
        raise AssertionError(f"silo_round: replicas after the merges "
                             f"{expanded}")
    if gap > 1e-5:
        raise AssertionError(f"silo_round: globals {gap} off the CPU's")
    if update <= 0 or bf16_gap > SILO_BF16_ATOL \
            or bf16_gap > SILO_BF16_REL * update:
        raise AssertionError(f"silo_round: the bf16 merge {bf16_gap} off "
                             f"the f32 one, whose update is {update}")
    torch.cuda.empty_cache()
    return launches


def silo_round_work(cfg, shapes, S, B, T):
    """What one cross-silo round must do, from the shapes. Operations:
    the local step's GEMMs, 6 a weight a token (forward, the input's and
    the weight's gradients) over every block weight and the head, bf16;
    its causal attention in f32 as the model computes it (QK^T and PV, 4
    Dh a query-key pair a head, times 3 with the backward). Bytes: the
    global read, each silo's trained local written and read by Eq. 2,
    the winner's local read, the merged global written. The memory floor:
    the global, the S trained locals and their S gradients at once."""
    H, Dh, L = cfg.num_heads, cfg.resolved_head_dim, cfg.num_layers
    size = {k: int(np.prod(v)) for k, v in shapes.items()}
    P = sum(size.values())
    gemm = sum(v for k, v in size.items() if k.startswith("blocks")
               and not k.endswith("/scale")) + size["head/w_out"]
    tokens = S * B * T
    bf16_ops = 6.0 * gemm * tokens
    f32_ops = 12.0 * S * B * H * Dh * (T * (T + 1) / 2) * L
    nbytes = (3 + 2 * S) * P * 2.0
    ops_ms = (bf16_ops / BF16_FLOPS_PER_S + f32_ops / F32_FLOPS_PER_S) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(params=P, gemm_params=gemm, tokens_a_round=tokens,
                bf16_ops=bf16_ops, f32_ops=f32_ops, bytes=nbytes,
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                weights_floor_gb=(1 + 2 * S) * P * 2 / 1e9)


def silo_full_init(cfg):
    """``SILO_FULL``'s params, drawn on the card from its seed."""
    gen = torch.Generator(device=DEV).manual_seed(SILO_FULL["seed"])
    return llm.init_params(gen, cfg, device=DEV)


def phase_silo_round_full():
    """The cross-silo round at phi3-mini's published widths
    (``SILO_FULL``: the depth cut to 2 layers, bf16, 4 silos x 4 x 1024
    tokens), params drawn on the card from a CUDA generator. Three fresh
    engines from the same seed: the first checked a round at a time
    (each silo's Eq. 2 against the plain ``delta_norm`` on the same
    trained locals, rtol 1e-5; the merged global against the plain
    formula ``(w + (w_u - w)) -> bf16`` of the winner u, or the global
    where no silo won, bit for bit; losses and priorities finite); the
    second counted (launches a round held to ``SILO_ROUND_LAUNCHES``
    exactly) and stamped; the third under ``torch.profiler`` (the
    device's idle share) — all three with the config as published
    (``remat`` on); then ``silo_levers``. Round ms, peak and weights
    against ``silo_round_work``'s bounds. Returns the launches."""
    c = SILO_FULL
    R = c["rounds"]
    cfg = dataclasses.replace(get_config(c["arch"]), num_layers=c["layers"])
    shapes = {"/".join(k): tuple(v.shape)
              for k, v in _paths(launch_steps.params_struct(cfg))}
    work = silo_round_work(cfg, shapes, c["silos"], c["batch"], c["seq"])

    def make():
        return silo_engine(DEV, cell=c, init=silo_full_init)

    torch.cuda.empty_cache()
    eng = make()
    be = eng.backend
    checks = []
    train, merge = be.train_round, be.merge

    def spy_train(state, t, *a, **kw):
        res = train(state, t, *a, **kw)
        locs = tree_leaves(res.local_handle)
        globs = tree_leaves(be.global_params(state))
        d2, g2 = ref.delta_norm_leaves_ref(locs, globs)
        plain = priority_product(d2, g2[:, None]).double().cpu().numpy()
        got = np.asarray(res.priorities)
        checks.append(dict(
            round=t, losses=[res.losses[u] for u in sorted(res.losses)],
            priorities=got.tolist(),
            eq2_rel_gap_vs_plain=float(np.abs(got / plain - 1).max()),
            merged=False))
        return res

    def spy_merge(state, tr, winners, **kw):
        # the engine merges only a round with a winner (k = 1: alpha 1)
        out = merge(state, tr, winners, **kw)
        glob = tree_leaves(be.global_params(state))
        local = [w[winners[0]] for w in tree_leaves(tr.local_handle)]
        merged = tree_leaves(be.global_params(out))
        checks[-1].update(
            merged=True, winners=list(winners),
            merge_equals_plain=all(
                torch.equal(m, (g.float() + (w.float() - g.float()))
                            .to(g.dtype))
                for m, w, g in zip(merged, local, glob)),
            merged_moved=sum(int((m != g).sum())
                             for m, g in zip(merged, glob)),
            merged_off_winner_local=sum(int((m != w).sum())
                                        for m, w in zip(merged, local)),
            expanded=expanded_over_silos(out))
        return out
    be.train_round, be.merge = spy_train, spy_merge
    hist0 = eng.run()
    del eng, be, train, merge
    torch.cuda.empty_cache()
    hist, launches, round_ms, dt, peak, expanded = stamped_run(make())
    torch.cuda.empty_cache()
    prof = profiled("silo_round_full", make(), lambda e: e.run(), R)
    torch.cuda.empty_cache()
    levers = silo_levers(c, silo_full_init)
    want = {k: v * R for k, v in SILO_ROUND_LAUNCHES.items()}
    got = {k: launches[k] for k in want}
    steady = statistics.median(round_ms[1:])
    fields = dict(
        arch=c["arch"], cell=c,
        reduced=["num_layers: 32 -> 2 (every width as published)"],
        **work, param_gb=work["params"] * 2 / 1e9,
        winners=hist.winners, uploads_total=hist.uploads_total,
        train_loss=hist.train_loss, same_winners_as_checked_run=(
            hist.winners == hist0.winners),
        checks=checks, launches=launches, predicted=want, run_s=dt,
        round_ms=round_ms, median_later_round_ms=steady,
        steady_round_over_bound=steady / work["bound_ms"],
        peak_gb=peak * 2**20 / 1e9, units="GB = 1e9 bytes",
        device_idle_share=prof["device_idle_share"],
        device_busy_ms_a_round=prof["device_busy_ms"] / R,
        port_kernels_ms_a_round=prof["port_kernels_ms"] / R,
        device_launches_a_round=prof["launches"] / R,
        replicas_expanded_after_each_merge=expanded, levers=levers)
    emit("silo_round_full", **fields)
    if got != want:
        raise AssertionError(f"silo_round_full: launches {got}, PERF.md "
                             f"predicts {want}")
    merges = [ch for ch in checks if ch["merged"]]
    if len(checks) != R or not merges or not expanded \
            or not all(expanded):
        raise AssertionError(f"silo_round_full: {len(checks)} rounds "
                             f"checked, {len(merges)} merged, replicas "
                             f"{expanded}")
    for ch in checks:
        if not (np.isfinite(ch["losses"]).all()
                and np.isfinite(ch["priorities"]).all()
                and min(ch["priorities"]) >= 1.0
                and ch["eq2_rel_gap_vs_plain"] <= 1e-5
                and (not ch["merged"] or (ch["merge_equals_plain"]
                                          and ch["expanded"]))):
            raise AssertionError(f"silo_round_full: round {ch}")
    if hist.winners != hist0.winners:
        raise AssertionError("silo_round_full: two runs from one seed "
                             f"chose {hist0.winners} and {hist.winners}")
    if not all(v["bits_equal_to_off"] for v in levers.values()) or any(
            v["launches"] != want for v in levers.values()):
        raise AssertionError(f"silo_round_full: the levers {levers}")
    return launches


#: ``silo_round_full``'s memory levers: (i) off, (ii) the config as
#: published (``remat``), (iii) ``remat`` and ``flash_chunk_remat``
SILO_LEVERS = {"off": dict(remat=False, flash_chunk_remat=False),
               "remat": dict(remat=True, flash_chunk_remat=False),
               "remat+flash": dict(remat=True, flash_chunk_remat=True)}


def silo_levers(c, init):
    """The full-width silo cell ``c`` with each of ``SILO_LEVERS``, a
    fresh engine from the same seed each, in turns (i, ii, iii, iii, ii,
    i): each lever's peak and steady round ms (the median of rounds 2 on,
    ``stamped_run``) and its ms over (i)'s; the losses, priorities,
    winners and merged global of (ii) and (iii) against (i)'s bits."""
    runs, first = {}, {}
    order = list(SILO_LEVERS) + list(SILO_LEVERS)[::-1]
    for tag in order:
        torch.cuda.empty_cache()
        eng = silo_engine(DEV, cell={**c, "levers": SILO_LEVERS[tag]},
                          init=init)
        hist, launches, round_ms, _, peak, _ = stamped_run(eng)
        r = runs.setdefault(tag, dict(steady_ms=[], peak_gb=[],
                                      launches={k: launches[k] for k in
                                                SILO_ROUND_LAUNCHES}))
        r["steady_ms"].append(statistics.median(round_ms[1:]))
        r["peak_gb"].append(peak * 2**20 / 1e9)
        if tag not in first:
            first[tag] = (hist, [p.cpu() for p in
                                 tree_leaves(eng.global_params)])
        del eng
    torch.cuda.empty_cache()
    h0, g0 = first["off"]
    for tag, r in runs.items():
        h, g = first[tag]
        r["ms"] = statistics.mean(r["steady_ms"])
        r["ms_over_off"] = r["ms"] / statistics.mean(
            runs["off"]["steady_ms"])
        r["bits_equal_to_off"] = (
            h.winners == h0.winners and h.train_loss == h0.train_loss
            and all(np.array_equal(np.asarray(a), np.asarray(b))
                    for a, b in zip(h.priorities, h0.priorities))
            and all(torch.equal(a, b) for a, b in zip(g, g0)))
        r["levers"] = SILO_LEVERS[tag]
    return runs


TOKEN_SUM_ROUTES = {"kernel": None, "tree": ref.token_sum_ref,
                    "torch_sum": lambda x: torch.sum(x, dim=1)}


@contextlib.contextmanager
def token_sum_route(fn):
    """``ops.token_sum`` replaced by ``fn`` (``None``: left as it is)."""
    inner = ops.token_sum
    if fn is not None:
        ops.token_sum = fn
    try:
        yield
    finally:
        ops.token_sum = inner


def same_history(h, h0):
    """Two runs' winners, training losses, held-out losses and
    priorities, bit for bit."""
    return (h.winners == h0.winners and h.train_loss == h0.train_loss
            and h.accuracy == h0.accuracy
            and len(h.priorities) == len(h0.priorities)
            and all(np.array_equal(np.asarray(a), np.asarray(b))
                    for a, b in zip(h.priorities, h0.priorities)))


def route_cells(rounds):
    """``llm_token_sum_routes``'s cells: tag -> a function that builds a
    fresh engine and runs it, returning (history, per-round seconds):
    the six --arch cells (``LLM_ARGV``, ``rounds`` rounds, stamped by
    ``run_main_path``) and ``silo_round_full``'s (``SILO_FULL``, remat
    on as published, stamped by ``stamped_run``)."""
    def arch(tag):
        args = launch_train.make_parser().parse_args(
            ["--arch", LLM_CELLS[tag], "--rounds", str(rounds), *LLM_ARGV,
             *LLM_CELL_ARGV.get(tag, ())])
        hist, _, _, _, round_s, _ = run_main_path(
            None, rounds, engine=launch_train.build_llm_engine(args))
        return hist, round_s

    def silo():
        hist, _, round_ms, _, _, _ = stamped_run(
            silo_engine(DEV, cell=SILO_FULL, init=silo_full_init))
        return hist, [ms / 1e3 for ms in round_ms]
    cells = {tag: functools.partial(arch, tag) for tag in LLM_CELLS}
    cells["silo_round_full"] = silo
    return cells


def phase_llm_token_sum_routes(rounds=3):
    """What the fixed-order token sums cost end to end: each of
    ``route_cells`` on each of ``TOKEN_SUM_ROUTES`` in turns (kernel,
    tree, torch_sum, torch_sum, tree, kernel), a fresh engine a run
    (``rounds`` rounds an --arch run, ``SILO_FULL``'s a silo run): the
    median later round of each run and the median of each route's two.
    Every route must pick the same winners, and the kernel route's
    training losses, held-out losses and priorities must be the tree
    route's bits."""
    rows = {}
    order = ("kernel", "tree", "torch_sum", "torch_sum", "tree", "kernel")
    for tag, run in route_cells(rounds).items():
        steady, first = {k: [] for k in TOKEN_SUM_ROUTES}, {}
        for route in order:
            torch.cuda.empty_cache()
            with token_sum_route(TOKEN_SUM_ROUTES[route]):
                hist, round_s = run()
            steady[route].append(statistics.median(round_s[1:]))
            first.setdefault(route, hist)
            if hist.winners != first["kernel"].winners:
                raise AssertionError(f"llm_token_sum_routes {tag}: {route} "
                                     "picked other winners")
        if not same_history(first["kernel"], first["tree"]):
            raise AssertionError(f"llm_token_sum_routes {tag}: the kernel "
                                 "route's losses or priorities are not the "
                                 "tree route's bits")
        base = statistics.median(steady["torch_sum"])
        rows[tag] = dict(
            median_later_round_s=steady,
            cost_vs_torch_sum={k: statistics.median(v) / base - 1.0
                               for k, v in steady.items()},
            kernel_bits_equal_tree=True)
        torch.cuda.empty_cache()
    emit("llm_token_sum_routes", rounds=rounds, cells=rows,
         order=", ".join(order))
    return rows


#: deepseek-v3 at its published widths (arXiv:2412.19437: d 7168, 128
#: heads, MLA ranks q 1536 / kv 512, nope / rope / v 128 / 64 / 128, 256
#: experts of 2048, top-8, 1 shared, vocab 129280), bf16, the depth cut
#: from 61 layers to the 3 dense layers and 1 MoE layer, MTP kept (1
#: depth, as published): 4 prompts of 512 tokens, 16 greedy tokens at the
#: config's own capacity factor (timed); decode against forward at
#: ``moe_capacity_factor = num_experts`` (no token dropped) on 4 prompts
#: of 32, within ``bar`` of the row's logit range where the two paths
#: routed the token alike, and of the router logits' range everywhere
#: (``routed_parity``)
DS_FULL = dict(layers=4, batch=4, prompt=512, gen=16, parity_prompt=32,
               bar=0.05)


@contextlib.contextmanager
def moe_routing_log(log, keep=False):
    """Every ``apply_moe`` call of the blocks records its routing:
    tokens, assignments, the capacity, the assignments dropped beyond
    it, and the experts hit (one host read a call: not for timed runs);
    with ``keep``, also its router logits (T, E) and top-K ids on the
    host."""
    inner = llm_blocks.apply_moe

    def spy(params, x, cfg, capacity_factor=None):
        cf = cfg.moe_capacity_factor if capacity_factor is None \
            else capacity_factor
        E, K = cfg.num_experts, cfg.experts_per_token
        T = x.shape[0] * x.shape[1]
        A = T * K
        cap = int(min(A, max(1, -(-A * cf // E))))
        logits = x.reshape(T, -1).float() @ params["router"]
        top = torch.topk(torch.softmax(logits, -1), K, dim=-1).indices
        counts = torch.bincount(top.reshape(-1), minlength=E)
        log.append(dict(tokens=T, assignments=A, cap=cap,
                        dropped=int(torch.clamp(counts - cap, min=0).sum()),
                        experts_hit=int((counts > 0).sum())))
        if keep:
            log[-1].update(logits=logits.cpu(), ids=top.cpu())
        return inner(params, x, cfg, capacity_factor=capacity_factor)

    llm_blocks.apply_moe = spy
    try:
        yield log
    finally:
        llm_blocks.apply_moe = inner


def moe_serving_weights(shapes, cfg, experts):
    """(elements, bytes) of the weights a serving forward reads for one
    token batch when ``experts`` routed experts a MoE layer are hit:
    every weight but the embedding table (rows only) and the MTP subtree
    (training only); the routed experts' three matrices counted
    ``experts`` / E; bf16 but the f32 router."""
    elements = nbytes = 0
    for path, shape in shapes.items():
        if path.startswith(("mtp/", "embed/")):
            continue
        n = int(np.prod(shape))
        if "/moe/" in path and "/shared/" not in path \
                and path.rsplit("/", 1)[1] in ("w_gate", "w_up", "w_down"):
            n = n * experts // cfg.num_experts
        elements += n
        nbytes += n * (4 if path.endswith("/router") else 2)
    return elements, nbytes


def phase_llm_serve_deepseek_full(seed=0):
    """deepseek-v3 at its published widths (``DS_FULL``), bf16, params
    drawn on the card from a CUDA generator (the expert leaves in slices
    of ``layers.DRAW_SLICE``): 4 prompts of 512 tokens prefilled, 16
    greedy tokens at the config's capacity factor (widened to 4 with a
    cache, as the reference does), twice (the second timed; equal
    tokens), and a third time with the routing logged (the dropped share
    of the prefill and of the decode steps, the experts each step hits).
    Bounds: the prefill by operations, 2 x the params a token uses (the
    dense layers, attention, router, shared expert, K of the E routed
    experts, the head) x tokens; a decode step by the bytes of the
    weights it must read (the routed experts it hits, from the log),
    beside the bytes the (E, cap) layout reads (every expert). Then the
    decode profile, and decode against ``forward`` at capacity factor E
    (nothing dropped) on 4 prompts of 32 tokens, row by row
    (``routed_parity``): within ``DS_FULL["bar"]`` of the row's logit
    range where both paths routed the token to the same experts, and of
    the router logits' range for every row."""
    cfg = dataclasses.replace(get_config("deepseek-v3-671b"),
                              num_layers=DS_FULL["layers"])
    B, S, G = DS_FULL["batch"], DS_FULL["prompt"], DS_FULL["gen"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(seed)
    t0 = time.perf_counter()
    params = llm.init_params(gen, cfg, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = llm.param_count(params)
    param_gb = sum(p.numel() * p.element_size()
                   for p in tree_leaves(params)) / 1e9
    shapes = {"/".join(k): tuple(v.shape) for k, v in _paths(params)}
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=DEV, dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    first = launch_serve.generate(params, cfg, prompts, G)
    res = launch_serve.generate(params, cfg, prompts, G)
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    with moe_routing_log([]) as log:
        third = launch_serve.generate(params, cfg, prompts, G)
    if not (torch.equal(first["tokens"], res["tokens"])
            and torch.equal(third["tokens"], res["tokens"])):
        raise AssertionError("llm_serve_deepseek_full: runs generated "
                             "different tokens")
    if len(log) != G or log[0]["tokens"] != B * S:
        raise AssertionError(f"llm_serve_deepseek_full: {len(log)} MoE "
                             f"calls logged for one prefill and {G - 1} "
                             "steps")
    steps = log[1:]
    E, K = cfg.num_experts, cfg.experts_per_token
    # the params a token uses: everything but the embedding table and MTP,
    # the routed experts at K / E
    active = moe_serving_weights(shapes, cfg, K)[0]
    prefill_ops = 2.0 * active * B * S
    prefill_bytes = moe_serving_weights(shapes, cfg,
                                        log[0]["experts_hit"])[1]
    prefill_bound = max(prefill_bytes / HBM_BYTES_PER_S,
                        prefill_ops / BF16_FLOPS_PER_S) * 1e3
    step_bytes = [moe_serving_weights(shapes, cfg, st["experts_hit"])[1]
                  for st in steps]
    layout_bytes = moe_serving_weights(shapes, cfg, E)[1]
    decode_bound = statistics.mean(step_bytes) / HBM_BYTES_PER_S * 1e3
    decode_prof = profile_decode(params, cfg, prompts, steps=2)
    # decode against forward with nothing dropped
    P = DS_FULL["parity_prompt"]
    pcfg = dataclasses.replace(cfg, moe_capacity_factor=float(E))
    torch.cuda.reset_peak_memory_stats()
    with moe_routing_log([], keep=True) as glog:
        pres = launch_serve.generate(params, pcfg, prompts[:, :P], G)
    rows = []
    with moe_routing_log([], keep=True) as flog:
        absg, relg, agree = decode_gaps(params, pcfg, prompts[:, :P], pres,
                                        per_row=rows)
    parity = routed_parity(glog, flog[0], torch.stack(rows), B, P, K)
    parity_peak = torch.cuda.max_memory_allocated() / 1e9
    fields = dict(
        arch="deepseek-v3-671b", layers=cfg.num_layers,
        groups=[[n, b, k] for n, b, k, _ in llm.layer_groups(cfg)],
        d_model=cfg.d_model, experts=E, top_k=K, params=n_params,
        param_gb=param_gb, batch=B, prompt=S, gen=G,
        capacity_factor=cfg.moe_capacity_factor, init_s=init_s,
        init_peak_gb=init_peak, serve_peak_gb=serve_peak,
        units="GB = 1e9 bytes",
        prefill_ms=res["prefill_s"] * 1e3,
        prefill_ms_first=first["prefill_s"] * 1e3,
        prefill_active_params=active, prefill_ops=prefill_ops,
        prefill_bound_ms=prefill_bound,
        decode_ms_per_token=res["decode_s"] * 1e3 / (G - 1),
        decode_bound_ms=decode_bound,
        decode_step_weight_gb=[b / 1e9 for b in step_bytes],
        decode_layout_weight_gb=layout_bytes / 1e9,
        decode_layout_bound_ms=layout_bytes / HBM_BYTES_PER_S * 1e3,
        routing_prefill=log[0],
        prefill_dropped_share=log[0]["dropped"] / log[0]["assignments"],
        decode_dropped_share=sum(st["dropped"] for st in steps)
        / sum(st["assignments"] for st in steps),
        decode_experts_hit=[st["experts_hit"] for st in steps],
        parity_prompt=P, parity_capacity_factor=float(E),
        max_abs_gap=absg, max_gap_over_range=relg, argmax_agree=agree,
        bar=DS_FULL["bar"], parity=parity, parity_peak_gb=parity_peak,
        decode_profile=decode_prof)
    del params, first, res, third, pres
    torch.cuda.empty_cache()
    emit("llm_serve_deepseek_full", **fields)
    bar = DS_FULL["bar"]
    if parity["same_routing_max_gap"] > bar or parity["router_max_gap"] > bar:
        raise AssertionError(
            f"llm_serve_deepseek_full: decode against forward beyond {bar} "
            f"of the row's range: logits {parity['same_routing_max_gap']} "
            f"where the routing agrees, router logits "
            f"{parity['router_max_gap']}")
    return fields


def routed_parity(glog, fwd, rel_rows, B, P, K):
    """Decode against forward, row by row, split by the MoE layer's
    routing. ``glog``: the generate's MoE calls (the prefill of B x P
    tokens, then one a step), ``fwd``: the forward's call over B x (P +
    steps - 1) tokens, ``rel_rows``: (steps, B) logit gaps over the
    row's range. A row whose token the two paths routed to the same K
    experts is held to the bar on its logits; every row is held to it on
    its router logits (continuous, upstream of the top-K choice). A row
    routed to other experts (a near-tie at the K-th expert that bf16
    rounding tips) is counted, with its gaps and the forward's margin
    between its K-th and (K+1)-th router logit."""
    steps = rel_rows.shape[0]
    L = P + steps - 1
    same, router, flipped = [], [], []
    for i in range(steps):
        for b in range(B):
            dec = glog[0] if i == 0 else glog[i]
            at = b * P + P - 1 if i == 0 else b
            ld, idd = dec["logits"][at], dec["ids"][at]
            f = b * L + P - 1 + i
            lf, idf = fwd["logits"][f], fwd["ids"][f]
            span = float(lf.max() - lf.min())
            rg = float((ld - lf).abs().max()) / span
            router.append(rg)
            gap = float(rel_rows[i, b])
            if set(idd.tolist()) == set(idf.tolist()):
                same.append(gap)
                continue
            top = torch.sort(lf, descending=True).values
            flipped.append(dict(step=i, row=b, gap_over_range=gap,
                                router_gap_over_range=rg,
                                forward_margin=float(top[K - 1] - top[K])))
    return dict(rows=steps * B, same_routing_rows=len(same),
                same_routing_max_gap=max(same) if same else 0.0,
                router_max_gap=max(router), flipped=flipped)


# ------------------------------------------------- the cohort split
def mesh_engine(cohort, mode, mesh, **spec):
    """``cohort_engine`` with ``mesh`` handed to the backend."""
    return build_host_engine(
        dataclasses.replace(cohort["spec"], **spec), cohort["init"],
        cohort["loss"], cohort["data"], cohort["eval_fn"], round_mode=mode,
        mesh=mesh, device="cuda")


def split_expected(plain, engine, rounds, D, lanes=1, over_lanes=False,
                   prio=True):
    """The launches of a D-way split run, from the unsplit run's: the
    split training pass (the fused round, the sweep, or the sparse
    winner retrain) launches the SGD step once a chunk a local step, and
    Eq. 2 (when the strategy reads priorities, or on the sparse retrain)
    once a chunk over the chunk's lanes' leaves, where the unsplit pass
    launches each once; the merge and contention are the unsplit run's.
    A 1-long mesh: the unsplit launches."""
    if D == 1:
        return dict(plain)
    be = engine.backend
    L = len(tree_leaves(engine.global_params))
    step = -(-L // kfused.max_leaves()) * be._nb * engine.spec.local_epochs
    per_chunk = [lanes // D] * D if over_lanes else [lanes] * D
    dn = (sum(-(-e * L // kdn.max_leaves()) for e in per_chunk)
          - -(-lanes * L // kdn.max_leaves()))
    want = dict(plain)
    want["fused_sgd"] += (D - 1) * step * rounds
    if prio:
        want["delta_norm"] += dn * rounds
    return want


def mesh_case(name, make, call, meshes, rounds, expect, same):
    """One case of ``phase_mesh_paths``: the runs ``call(make(mesh))`` for
    no mesh and each of ``meshes`` in turns (none, then each mesh, then
    each mesh again, then none), each timed with its launches counted
    (``timed``); every mesh run bit-equal to the first unsplit run
    (``same``) and its launches equal to ``expect(plain launches, D,
    engine)`` exactly; a split run trains at least one chunk more a round
    than the unsplit run, a 1-device mesh none. Returns the case's line
    fields and the launches of its widest split."""
    order = [None] + list(meshes) + list(meshes) + [None]
    runs, round_ms, launches, chunks = {}, {}, {}, {}
    for mesh in order:
        key = mesh_key(mesh)
        engine = make(mesh)
        be, passes = engine.backend, [0]
        for method in ("_train_rows", "_train_lanes"):
            def counted(*a, _f=getattr(be, method), **k):
                passes[0] += 1
                return _f(*a, **k)
            setattr(be, method, counted)
        res, dt, l, round_s, _ = timed(engine, call)
        chunks.setdefault(key, passes[0])
        more = passes[0] - chunks["none"]
        if (more >= rounds) != (key not in ("none", "1dev")) or (
                key == "1dev" and more):
            raise AssertionError(f"{name}/{key}: {passes[0]} chunk "
                                 f"trainings against {chunks['none']} "
                                 f"unsplit in {rounds} rounds")
        round_ms.setdefault(key, []).append(
            1e3 * statistics.median(round_s[1:]))
        got = res if hasattr(res, "final_globals") else (
            res, [x.clone() for x in tree_leaves(engine.global_params)])
        if key not in runs:
            runs[key], launches[key] = got, l
        elif not same(runs[key], got):
            raise AssertionError(f"{name}/{key}: two runs differ")
        if key != "none":
            D = mesh.size
            want = expect(launches["none"], D, engine)
            if l != want:
                raise AssertionError(f"{name}/{key}: launches {l}, "
                                     f"predicted {want}")
            if not same(runs["none"], got):
                raise AssertionError(f"{name}/{key}: the split run is not "
                                     "bit-equal to the unsplit run")
        del engine
        torch.cuda.empty_cache()
    widest = max(launches, key=lambda k: 0 if k == "none" else
                 (1 if k == "1dev" else int(k.rstrip("waycards"))))
    fields = dict(
        rounds=rounds, order=[("none" if m is None else str(m.size))
                              for m in order],
        ms_a_round=round_ms,
        vs_unsplit={k: statistics.mean(v) / statistics.mean(
            round_ms["none"]) for k, v in round_ms.items()},
        launches_per_round={k: per_round(v, rounds)
                            for k, v in launches.items()},
        chunk_trainings=chunks, bit_equal_to_unsplit=True)
    return fields, launches[widest]


def mesh_key(mesh):
    """A run's name in ``mesh_case``: ``none``, ``1dev``, ``<D>way`` (one
    card D times) or ``<D>cards`` (D distinct cards)."""
    if mesh is None:
        return "none"
    if mesh.size == 1:
        return "1dev"
    distinct = len({str(d) for d in np.asarray(mesh.devices).ravel()})
    return f"{mesh.size}{'cards' if distinct > 1 else 'way'}"


def same_run(a, b):
    """Two single runs (history, global leaves) hold the same bits."""
    return route_gap(a, b)["bitwise"]


def phase_mesh_paths():
    """The cohort split (``HostBackend(mesh=...)``) on one card: a mesh
    over ``cuda:0`` D times runs the D chunks in turn, each with the
    kernels of the unsplit path. Cases, each against no mesh in turns:
    the MLP cell (10 users, k = 2, 20 rounds, ``run``: the E = 1 sweep
    split over its users) on a 1-device mesh and a 2-way one; the MLP at
    1000 users, k = 64, fused (``run``) and winner-sparse with the
    prepass (the (64, ...) winner stack split), 3 rounds, 4-way; the
    Fig. 3 sweep (E = 8, 20 rounds) 2-way over its lanes and a 10-user E =
    3 sweep 2-way over its users. Every split run bit-equal to the
    unsplit run (winners, losses, priorities, globals), its launches
    predicted exactly (``split_expected``). One card runs the chunks one
    after another: the split is a correctness witness here, not a speed
    path. With more than one card visible, the 1000-user cases and the
    Fig. 3 sweep also run split over every card (``cohort_mesh()``, chunk
    i on ``cuda:i``) where the card count divides their stacks; the CNN's
    split over every card, which is not bit-equal on the card, is
    ``phase_conv_pool``'s (``cnn_contracts``). Returns the launches of
    the 2-way Fig. 3 sweep."""
    one, two, four = (cohort_mesh([DEV]), cohort_mesh([DEV] * 2),
                      cohort_mesh([DEV] * 4))
    n_cards = torch.cuda.device_count()

    def cards(*counts):
        return ([cohort_mesh()] if n_cards > 1
                and all(c % n_cards == 0 for c in counts) else [])
    lines = {}
    mlp = cohort_of(paper_engine("mlp", 20))
    fields, _ = mesh_case(
        "mesh_mlp", lambda m: mesh_engine(mlp, "fused", m),
        lambda e: e.run(), [one, two], 20,
        lambda l, D, e: split_expected(l, e, 20, D), same_run)
    lines["mlp_U10"] = fields
    big = cohort_of(paper_engine("mlp", 3, *U1000))
    fields, _ = mesh_case(
        "mesh_mlp_U1000_fused", lambda m: mesh_engine(big, "fused", m),
        lambda e: e.run(), [four] + cards(1000), 3,
        lambda l, D, e: split_expected(l, e, 3, D), same_run)
    lines["mlp_U1000_fused"] = fields
    fields, _ = mesh_case(
        "mesh_mlp_U1000_sparse", lambda m: mesh_engine(big, "sparse", m),
        lambda e: e.run(), [four] + cards(64), 3,
        lambda l, D, e: split_expected(l, e, 3, D), same_run)
    lines["mlp_U1000_sparse"] = fields
    del big
    torch.cuda.empty_cache()
    fig3 = SweepSpec.grid(mlp["spec"], strategy=list(PAPER_STRATEGIES),
                          seed=[0, 1])
    fields, l_fig3 = mesh_case(
        "mesh_sweep_fig3", lambda m: mesh_engine(mlp, "fused", m),
        lambda e: e.run_sweep(fig3), [two] + cards(8), 20,
        lambda l, D, e: split_expected(l, e, 20, D, lanes=8,
                                       over_lanes=True),
        same_sweep)
    lines["sweep_fig3_over_lanes"] = fields
    seeds3 = SweepSpec.grid(mlp["spec"], seed=[0, 1, 2])
    fields, _ = mesh_case(
        "mesh_sweep_U10_E3", lambda m: mesh_engine(mlp, "fused", m),
        lambda e: e.run_sweep(seeds3), [two], 20,
        lambda l, D, e: split_expected(l, e, 20, D, lanes=3), same_sweep)
    lines["sweep_E3_over_users"] = fields
    emit("mesh_paths", cases=lines, cards=n_cards,
         note="<D>way: one card, the D chunks run one after another; "
              "<D>cards: chunk i on cuda:i")
    return l_fig3


def phase_dryrun_witness():
    """The dry run (``launch/dryrun.py``, counted on the meta device)
    against the card. Parameter bytes: phi3-mini at 2 layers (the
    ``silo_round_full`` model) and yi-9b whole, bf16, as the dry run
    sizes them on one card, against ``init_params`` on the card: the
    tensors' bytes exactly, and the allocator's growth no less than
    their 512-byte blocks and no more than 1 MiB a leaf above them (a
    large-pool block keeps a remainder under 1 MiB unsplit). FLOPs: the
    counted FLOPs of ``silo_round_full``'s local step (4 silos x 4 x 1024
    tokens; remat off and on, as published) against
    ``silo_round_work``'s operations, and of yi-9b's 4 x 512 prefill
    against the serving bound's (2 a weight a token); the gaps printed,
    the remat-off step and the prefill within 5 %; the card's
    ``total_memory`` against ``launch/mesh.py``'s ``HBM_BYTES``."""
    from repro_torch.core.silo import make_fl_round_step, silo_batch_struct
    from repro_torch.core.silo import stack_for_silos
    c = SILO_FULL
    phi = dataclasses.replace(get_config(c["arch"]), num_layers=c["layers"])
    yi = get_config("yi-9b")
    total = torch.cuda.get_device_properties(0).total_memory
    params = {}
    for label, cfg in (("phi3_mini_2_layers", phi), ("yi9b", yi)):
        want = launch_dryrun.param_bytes(cfg)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        gen = torch.Generator(device=DEV).manual_seed(0)
        p = llm.init_params(gen, cfg, device=DEV)
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - before
        held = sum(t.numel() * t.element_size() for t in tree_leaves(p))
        blocks = sum(-(-t.numel() * t.element_size() // 512) * 512
                     for t in tree_leaves(p))
        params[label] = dict(dryrun_bytes=want, tensor_bytes=held,
                             allocator_growth=grown, in_blocks=blocks,
                             unsplit_remainders=grown - blocks)
        leaves = len(tree_leaves(p))
        del p
        torch.cuda.empty_cache()
        if held != want or not 0 <= grown - blocks < leaves * 2**20:
            emit("dryrun_witness", params=params)
            raise AssertionError(f"dryrun_witness: {label}'s parameter "
                                 f"bytes {params[label]}")
    shapes = {"/".join(k): tuple(v.shape)
              for k, v in _paths(launch_steps.params_struct(phi))}
    work = silo_round_work(phi, shapes, c["silos"], c["batch"], c["seq"])
    flops = {}
    for remat in (False, True):
        cfg = dataclasses.replace(phi, remat=remat)
        step = make_fl_round_step(cfg, do_merge=False)
        stacked = stack_for_silos(launch_steps.params_struct(cfg),
                                  c["silos"])
        batch = silo_batch_struct(cfg, c["silos"], c["batch"], c["seq"])
        alphas = torch.empty((c["silos"],), device="meta")
        _, counted, _ = launch_dryrun.count(step, stacked, batch, alphas)
        bound = work["bf16_ops"] + work["f32_ops"]
        flops[f"silo_local_step_remat_{'on' if remat else 'off'}"] = dict(
            counted=counted, bound_ops=bound, gemm_ops=work["bf16_ops"],
            attention_ops_causal=work["f32_ops"], rel_gap=counted / bound - 1)
    B, S = YI_FULL["batch"], YI_FULL["prompt"]
    ystruct = launch_steps.params_struct(yi)
    n = launch_dryrun.count_params(ystruct)
    dense = n - int(np.prod(ystruct["embed"]["embedding"].shape))
    caches = llm.make_caches(yi, B, S + YI_FULL["gen"], device="meta")
    toks = {"tokens": torch.empty((B, S), dtype=torch.int32, device="meta")}
    with torch.no_grad():
        _, counted, _ = launch_dryrun.count(
            launch_steps.make_prefill_step(yi), ystruct, caches, toks)
    flops["yi9b_prefill_4x512"] = dict(
        counted=counted, bound_ops=2.0 * dense * B * S,
        rel_gap=counted / (2.0 * dense * B * S) - 1)
    emit("dryrun_witness", params=params, flops=flops,
         total_memory=total, hbm_bytes_constant=launch_mesh.HBM_BYTES,
         card=torch.cuda.get_device_name(0))
    for key in ("silo_local_step_remat_off", "yi9b_prefill_4x512"):
        if abs(flops[key]["rel_gap"]) > 0.05:
            raise AssertionError(f"dryrun_witness: {key} counted "
                                 f"{flops[key]}")
    if (torch.cuda.get_device_name(0) == "NVIDIA H100 80GB HBM3"
            and total != launch_mesh.HBM_BYTES):
        raise AssertionError(f"dryrun_witness: total_memory {total} is not "
                             f"launch/mesh.py's HBM_BYTES "
                             f"{launch_mesh.HBM_BYTES}")


#: the (rows, tokens, columns) shapes of every ``token_sum`` launch on the
#: card, by the phase that made it (``recording_token_sums``)
TOKEN_SUM_SEEN = {}


@contextlib.contextmanager
def recording_token_sums(label):
    """``ops.token_sum`` counting the shape of every call on the card."""
    inner = ops.token_sum
    seen = TOKEN_SUM_SEEN.setdefault(label, Counter())

    def spy(x):
        if x.is_cuda:
            seen[tuple(x.shape)] += 1
        return inner(x)
    ops.token_sum = spy
    try:
        yield
    finally:
        ops.token_sum = inner


def phase_token_sum_shapes():
    """``token_sum`` at every shape the ``--arch`` rounds and
    ``silo_round_full`` launched it with (``TOKEN_SUM_SEEN``), which must
    be ``TOKEN_SUM_CENSUS`` exactly: ``time_token_sums``, each shape with
    its calls in the phases that made it."""
    shapes = Counter()
    where = {}
    for label, seen in TOKEN_SUM_SEEN.items():
        for shape, calls in seen.items():
            shapes[shape] += calls
            where.setdefault(shape, []).append(label)
    if set(shapes) != set(TOKEN_SUM_CENSUS):
        raise AssertionError(
            "token_sum_shapes: the paths launched "
            f"{sorted(set(shapes) - set(TOKEN_SUM_CENSUS))} beyond "
            "TOKEN_SUM_CENSUS and never "
            f"{sorted(set(TOKEN_SUM_CENSUS) - set(shapes))} of it")
    emit("token_sum_shapes", rows=with_plans(
        time_token_sums(sorted(shapes), shapes, where)))


def phase_token_sum_only():
    """``--token-sum-only``: ``token_sum`` built alone, held against its
    plain version (``check_token_sum``), then ``TOKEN_SUM_CENSUS`` timed
    (``time_token_sums``)."""
    t0 = time.perf_counter()
    built = kbuild.build_all(verbose=True, stems=("token_sum",))
    kbuild.library("token_sum")
    emit("build", seconds=time.perf_counter() - t0,
         nvcc=kbuild.find_nvcc(), flags=" ".join(kbuild.NVCC_FLAGS),
         libraries=sorted(os.path.basename(str(p)) for p in built.values()))
    err, bits = check_token_sum()
    emit("token_sum_agree", max_abs_err=err, bit_equal_to_plain=bits,
         rows_alone_equal_stack=True,
         shapes=[list(t) for t in TOKEN_SUM_SHAPES],
         edge_shapes=[list(t) for t in TOKEN_SUM_EDGES])
    emit("token_sum_census",
         rows=with_plans(time_token_sums(sorted(TOKEN_SUM_CENSUS))))


def _paths(tree, prefix=()):
    """(key path, leaf) pairs of a nested dict, in tree order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree



def main():
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    if "--token-sum-only" in sys.argv[1:]:
        phase_token_sum_only()
        print(smi, flush=True)
        print(json.dumps({"ok": True, "token_sum_only": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return
    t0 = time.perf_counter()
    built = kbuild.build_all(verbose=True)
    for stem in built:
        kbuild.library(stem)                   # load, set argtypes
    emit("build", seconds=time.perf_counter() - t0,
         nvcc=kbuild.find_nvcc(), flags=" ".join(kbuild.NVCC_FLAGS),
         libraries=sorted(os.path.basename(str(p)) for p in built.values()))
    if "--conv-pool-only" in sys.argv[1:]:
        phase_conv_pool()
        print(smi, flush=True)
        print(json.dumps({"ok": True, "conv_pool_only": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return
    if "--mesh-only" in sys.argv[1:]:
        phase_mesh_paths()
        print(smi, flush=True)
        print(json.dumps({"ok": True, "mesh_only": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return

    # ---- every kernel against its plain version ----------------------
    # the leaf shapes are read off the models the main path trains, so a
    # path cannot hand a kernel a shape that is compared nowhere
    leaves = {m: [tuple(l.shape) for l in tree_leaves(
        get_paper_model(m)[0](0, device="cpu"))] for m in ("mlp", "cnn")}
    cases = [((127,), 3), ((2, 129, 5), 4)]
    cases += [(s, U) for U in (10, 1024) for s in leaves["mlp"]]
    cases += [(s, 10) for s in leaves["cnn"]]
    worst = {k: {"float32": 0.0, "bfloat16": 0.0} for k in KERNELS}
    bit_equal = {k: True for k in KERNELS}
    dn_rel = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for i, (shape, U) in enumerate(cases):
            got = check_kernels_at(shape, U, dtype, seed=10 * i)
            for k, v in got.items():
                key = str(dtype).split(".")[1]
                worst[k][key] = max(worst[k][key], v[0])
                bit_equal[k] = bit_equal[k] and v[1]
            dn_rel = max(dn_rel, got["delta_norm"][2])
        check_merge_contracts(dtype)
        key = str(dtype).split(".")[1]
        split = check_combine_split(dtype)
        split["robust_combine"] = check_robust_split(dtype)
        split["fused_sgd"] = check_sgd_leaves(dtype)
        lists, rel = check_leaf_lists(dtype)
        split.update(lists)
        dn_rel = max(dn_rel, rel)
        for k, v in check_winner_stacks(dtype).items():
            fold(split, k, v)
        for k, (e, b) in split.items():
            worst[k][key] = max(worst[k][key], e)
            bit_equal[k] = bit_equal[k] and b
        torch.cuda.empty_cache()
    # the contention passes at the JAX test's shapes, the paper cell's
    # pool, the dense pool and its first retry, the exact M = N fallback;
    # every pool shape the loop runs on later is checked after it ran
    c_shapes = [(3, 7), (2, 300), (4, 2049), (1, 10), (1, 128), (64, 128),
                (64, 1024), (8, 100000)]
    for i, (B, N) in enumerate(c_shapes):
        check_contention_at(B, N, seed=1000 + i)
    torch.cuda.empty_cache()
    worst["token_sum"]["float32"], bit_equal["token_sum"] = check_token_sum()
    emit("kernels_agree", cases=[[list(s), U] for s, U in cases],
         max_abs_err=worst, bit_equal_to_plain=bit_equal,
         delta_norm_max_rel_err=dn_rel,
         tolerance="f32 rtol 1e-5 atol 1e-6; bf16 atol 0.02 (one ulp of "
                   "the output type); delta_norm sums rtol 1e-5; "
                   "contention: bit-equal, all six outputs and dtypes; "
                   "token_sum: bit-equal, each row alone = the stack",
         token_sum_shapes=[list(t) for t in TOKEN_SUM_SHAPES],
         token_sum_edge_shapes=[list(t) for t in TOKEN_SUM_EDGES],
         merge_contracts="bitwise: zero weight masks inf/NaN rows, "
                         "all-zero weights return glob, pad width, "
                         "S=U ids vs S=K positions; server_opt kinds 0 "
                         "and 1 (beta1 0, server_lr 1) return avg, "
                         "server_lr 0.5 does not, m / v pass through "
                         "where the law keeps them; kind 1 (beta1 0.9, "
                         "server_lr 0.5) = optim.sgd_momentum_update on "
                         "old - avg",
         small_cohort_cases="fused_sgd_leaves and delta_norm_leaves on the "
                            "MLP's and the CNN's leaf lists at U = 1, 2, 64; "
                            "gather (positions, k_pad max(m, 2)), AirComp "
                            "(idx=None, a noise plane) and robust over "
                            "(m, ...) stacks of every leaf, every row a "
                            "winner, m = 1, 2, 64; bit-equal but delta_norm",
         contention_cases=[list(c) for c in c_shapes],
         contention_inputs="forced expiry tie, dead lanes, a row with no "
                           "live lane (B > 1), no live lane at all, "
                           "absolute expiries up to BIG; max doublings 5 "
                           "and 7")

    # ---- times at the main path's largest leaf, and its small ones ---
    timed = {}
    for label, U, shape, reps, K, dtype in (
            ("mlp_fc1w_U10", 10, (784, 200), 200, 2, torch.float32),
            ("mlp_fc2b_U10", 10, (10,), 200, 2, torch.float32),
            ("mlp_fc1w_U1024", 1024, (784, 200), 10, 64, torch.float32),
            ("mlp_fc1w_U1024_bf16", 1024, (784, 200), 10, 64,
             torch.bfloat16)):
        timed[label] = bench_kernels(U, shape, dtype, reps, K)
        torch.cuda.empty_cache()
    timed["mlp_sgd_step_U10"] = bench_sgd_step(10, torch.float32, reps=200)
    for U, dtype, reps in ((10, torch.float32, 200),
                           (10, torch.bfloat16, 200),
                           (1024, torch.float32, 10),
                           (1024, torch.bfloat16, 10)):
        bf = "_bf16" if dtype == torch.bfloat16 else ""
        timed[f"delta_norm_U{U}{bf}"] = bench_delta_norm(U, dtype, reps)
    timed["server_opt"] = bench_server_opt(torch.float32, reps=200)
    timed["server_opt_bf16"] = bench_server_opt(torch.bfloat16, reps=200)
    timed["cnn_grad_copy_U10"] = bench_grad_copy()
    timed["token_sum_U10"] = {"token_sum": bench_token_sum()}
    torch.cuda.empty_cache()
    # the contention passes at the paper cell's pool (1, 10), the 1000-
    # user pool (1, 512), (1, 128), the dense pool (64, 128) and a pool
    # of the exact fallback's size (8, 100000)
    for B, N in ((1, 10), (1, 128), (1, 512), (64, 128), (8, 100000)):
        timed[f"contention_{B}x{N}"] = bench_contention(B, N, reps=200)
    # the persistent loop at the pools the engine's calls build
    for B, N, k in LOOP_POOLS:
        row = bench_loop(B, N, k)
        timed["contention_loop_{}x{}".format(*row["pool"])] = row
    emit("kernel_times", dtype="float32 / int32; bfloat16 where the entry "
         "says bf16", timed=timed)

    # ---- the main path, through the entry points ---------------------
    torch.cuda.reset_peak_memory_stats()
    engine, l_mlp = phase_main_path("mlp", rounds=20, check_accuracy=True)
    l_srv = phase_server_path(engine, "mlp")
    del engine
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine, l_cnn = phase_main_path("cnn", rounds=3, check_accuracy=False)
    phase_server_path(engine, "cnn")
    del engine
    torch.cuda.empty_cache()
    phase_conv_pool()
    torch.cuda.empty_cache()
    phase_reference_small()
    phase_pins_tool()
    phase_determinism()
    l_loop = phase_loops_in_turns()

    # ---- device contention --------------------------------------------
    ran, l_passes = phase_contention_kernel_loop_agree()
    ran |= phase_contention_dense()
    l_dev, s_dev = phase_main_path_device()
    torch.cuda.empty_cache()
    l_u1000, s_u1000 = phase_main_path_u1000()
    torch.cuda.empty_cache()
    ran |= s_dev | s_u1000
    late = sorted(ran - set(c_shapes))
    for i, (B, N) in enumerate(late):
        check_contention_at(B, N, seed=2000 + i)
    emit("contention_shapes_agree", loop_pool_shapes=sorted(ran),
         checked_before=[list(c) for c in c_shapes],
         checked_now=[list(c) for c in late], bit_equal=True)

    # ---- the channel and fault layers -----------------------------------
    l_air = phase_layer_path("main_path_mlp_aircomp", 20, False, **AIRCOMP)
    l_chan = phase_layer_path("main_path_mlp_channel", 20, True,
                              "--strategy", "channel-distributed",
                              channel=LOSSY)
    l_flt = phase_layer_path("main_path_mlp_faults", 20, False,
                             channel=LOSSY, faults=ACTIVE)
    l_u1000f = phase_layer_path(
        "main_path_mlp_U1000_faults", 3, False, "--users", "1000", "--k",
        "64", "--n-train", "60000", "--round-mode", "fused",
        "--contention-backend", "device", channel=LOSSY, faults=ACTIVE)
    phase_layer_overhead()

    # ---- the objectives layer ------------------------------------------
    l_dyn = phase_layer_path("main_path_mlp_feddyn_fedavgm", 20, False,
                             attempt_only=True, channel=LOSSIER,
                             objective=FEDDYN)
    l_adam = phase_layer_path("main_path_mlp_fedprox_fedadam", 20, False,
                              objective=FEDADAM)
    l_u1000o = phase_layer_path(
        "main_path_mlp_U1000_feddyn", 3, False, "--users", "1000", "--k",
        "64", "--n-train", "60000", "--round-mode", "fused",
        "--contention-backend", "device", objective=FEDDYN)
    # the layers' merges through the per-round loop (run takes the sweep's)
    l_loop_layers = phase_run_round_layers()

    # ---- the stacked, ragged and partial-cohort round paths -------------
    l_stk = phase_round_path("main_path_mlp_stacked", 20, True, "stacked",
                             "--round-mode", "stacked")
    l_rc = phase_round_path("main_path_mlp_random_centralized", 20, True,
                            "stacked", "--strategy", "random-centralized")
    l_rc1000 = phase_round_path(
        "main_path_mlp_U1000_random_centralized", 3, False, "stacked",
        "--users", "1000", "--k", "64", "--n-train", "60000",
        "--round-mode", "fused", "--strategy", "random-centralized")
    l_rag = phase_round_path("main_path_mlp_ragged", 10, True, "ragged",
                             engine=uneven_mlp_engine(10))
    phase_round_paths_in_turns()

    # ---- the winner-sparse round path -----------------------------------
    l_sp = phase_main_path_u1000_sparse()
    l_sps = phase_main_path_u1000_sparse_stale()
    phase_main_path_u10000_sparse()
    l_splay = phase_sparse_layers()

    # ---- the sweep path and checkpoint / resume -------------------------
    l_fig3 = phase_sweep_paper_fig3()
    torch.cuda.empty_cache()
    l_su = phase_sweep_mlp_u1000()
    l_ssp = phase_sweep_mlp_u1000_sparse()
    l_slay = phase_sweep_layers()
    phase_kill_resume()
    l_mesh = phase_mesh_paths()

    # ---- the LLM stack: --arch rounds, serving, full-width leaves -------
    llm_worst, llm_rel = phase_llm_kernels()
    l_llm = {}
    for tag in LLM_CELLS:
        with recording_token_sums(f"llm_fl_round_{tag}"):
            l_llm[tag] = phase_llm_fl_round(tag)
    phase_llm_token_sum_routes()
    phase_llm_serve_reduced()
    full_worst = phase_llm_serve_yi9b_full()
    phase_llm_serve_deepseek_full()
    for tag in SSM_FULL:
        phase_llm_serve_ssm_full(tag)
    phase_llm_serve_whisper_full()

    # ---- the cross-silo path --------------------------------------------
    l_silo = phase_silo_round()
    with recording_token_sums("silo_round_full"):
        l_silo_full = phase_silo_round_full()
    phase_token_sum_shapes()
    phase_dryrun_witness()
    for k, per in llm_worst.items():
        for key, (e, b) in per.items():
            worst[k][key] = max(worst[k][key], e)
            bit_equal[k] = bit_equal[k] and b
    for k, (e, b) in full_worst.items():
        worst[k]["bfloat16"] = max(worst[k]["bfloat16"], e)
        bit_equal[k] = bit_equal[k] and b
    dn_rel = max(dn_rel, llm_rel)

    t_checks = time.perf_counter() - t_start
    if "--profile" in sys.argv[1:]:
        mlp = functools.partial(paper_engine, "mlp", 4)
        phase_profile("mlp", mlp)
        phase_profile("mlp_run_round", mlp, loop="run_round")
        phase_profile("mlp_device", functools.partial(
            mlp, "--contention-backend", "device"))
        phase_profile("mlp_aircomp", functools.partial(mlp, **AIRCOMP))
        phase_profile("mlp_faults", functools.partial(
            mlp, channel=LOSSY, faults=ACTIVE))
        phase_profile("mlp_objectives", functools.partial(
            mlp, objective=FEDADAM))
        phase_profile("mlp_stacked", functools.partial(
            mlp, "--round-mode", "stacked"))
        phase_profile("mlp_random_centralized", functools.partial(
            mlp, "--strategy", "random-centralized"))
        phase_profile("mlp_ragged", lambda: uneven_mlp_engine(4))
        phase_profile("cnn", functools.partial(paper_engine, "cnn", 2),
                      rounds=2)
        phase_profile_sweep()

    # ---- the record ---------------------------------------------------
    # the three passes left the main path (the loop kernel fuses them):
    # their launches are those of the loop they still drive
    record = []
    path_of = {"fedavg_combine": l_srv, "aircomp_combine": l_air,
               "robust_combine": l_flt, "server_opt": l_dyn,
               LOOP_KERNEL: l_dev, "token_sum": l_llm["yi9b"],
               **{k: l_passes for k in CONTENTION}}
    timed_at = {
        **{k: ("contention_1x10", "int32 (1, 10): the paper cell's "
               "contention pool, 10 users") for k in CONTENTION},
        LOOP_KERNEL: ("contention_loop_1x512", "one attempt at the (1, 512) "
                      "pool of a 1000-user, k = 64 round"),
        "delta_norm": ("delta_norm_U10", "f32: the MLP's four stacked "
                       "leaves at 10 users, one launch (a round's "
                       "priorities)"),
        "server_opt": ("server_opt", "f32: the MLP's four leaves, FedAdam, "
                       "one launch (an objective merge)"),
        "token_sum": ("token_sum_U10", "f32 (10, 4096, 256): a norm scale's "
                      "gradient over a user's 4096 tokens, 10 users (the "
                      "--arch step's widest call)")}
    # the kernels of the winner-sparse path, and where each must run
    sparse_path = {"fused_sgd": (l_sp, l_sps, l_ssp),
                   "delta_norm": (l_sp, l_sps, l_ssp),
                   "gather_combine": (l_sp, l_sps, l_ssp),
                   LOOP_KERNEL: (l_sp, l_sps)}
    for name, runs in sparse_path.items():
        if min(r[name] for r in runs) < 1:
            raise AssertionError(f"{name}: never launched on a run of the "
                                 "winner-sparse path")
    for name in LLM_KERNELS:
        if min(l[name] for l in l_llm.values()) < 1:
            raise AssertionError(f"{name}: never launched on an --arch run")
    for name in ("fused_sgd", "delta_norm", "token_sum"):
        if min(l_silo[name], l_silo_full[name]) < 1:
            raise AssertionError(f"{name}: never launched on a silo run")
    for name, meta in KERNELS.items():
        integer = name in CONTENTION or name == LOOP_KERNEL
        launches = path_of.get(name, l_mlp)[name]
        if launches < 1:
            raise AssertionError(f"{name}: never launched on its path")
        entry, where = timed_at.get(name, (
            "mlp_fc1w_U10", "f32 (10, 784, 200): the MLP's fc1.w leaf, 10 "
            "users"))
        t = timed[entry] if name == LOOP_KERNEL else timed[entry][
            "mlp" if name in ("delta_norm", "server_opt") else name]
        record.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches,
            max_abs_err=worst[name]["float32"], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            graph_ms=t["graph_ms"], library_graph_ms=t["library_graph_ms"],
            max_abs_err_bf16=(None if integer or name == "token_sum"
                              else worst[name]["bfloat16"]),
            # delta_norm's outputs are sums of ~1e5: its tolerance is
            # relative, and so is the error worth reading
            max_rel_err=(dn_rel if name == "delta_norm" else None),
            bit_equal_to_plain=bit_equal[name],
            launches_cnn=l_cnn[name],
            launches_U1000_device=l_u1000[name],
            launches_channel=l_chan[name],
            launches_U1000_faults=l_u1000f[name],
            launches_fedadam=l_adam[name],
            launches_U1000_feddyn=l_u1000o[name],
            launches_stacked=l_stk[name],
            launches_random_centralized=l_rc[name],
            launches_U1000_random_centralized=l_rc1000[name],
            launches_ragged=l_rag[name],
            launches_run_round=l_loop[name],
            launches_run_round_layers=l_loop_layers.get(name, 0),
            launches_sweep=l_fig3[name],
            launches_sweep_U1000=l_su[name],
            launches_sweep_layers=l_slay.get(name, 0),
            launches_U1000_sparse=l_sp[name],
            launches_U1000_sparse_stale=l_sps[name],
            launches_U1000_sparse_layers=l_splay.get(name, 0),
            launches_sweep_U1000_sparse=l_ssp[name],
            launches_mesh_sweep_fig3=l_mesh[name],
            launches_llm_yi9b=l_llm["yi9b"][name],
            launches_llm_gemma2=l_llm["gemma2"][name],
            launches_llm_deepseek=l_llm["deepseek"][name],
            launches_llm_kimi=l_llm["kimi"][name],
            launches_llm_mamba2=l_llm["mamba2"][name],
            launches_llm_hymba=l_llm["hymba"][name],
            launches_silo=l_silo[name],
            launches_silo_full=l_silo_full[name],
            timed_at=where))
    emit("total", seconds=time.perf_counter() - t_start,
         before_profile_s=t_checks)
    print(json.dumps({"kernels": record}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
