#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one line each (a failing phase raises and the run exits non-zero):

1. build     — compile the hand CUDA kernels from ``src/repro_torch/csrc``
               (one nvcc per source, in parallel), report the card, ptxas's
               registers and spills, B1's wgmma (HGMMA) and TMA
               (UTMALDG) instruction counts and the tensor-core (HMMA)
               count of every bf16 B3 kernel, from cuobjdump (none: fail);
2. kernels   — each kernel against its plain PyTorch version in bf16 at the
               main paths' shapes (atol = rtol = 2e-2; B1 also to 5e-3 in
               ||got - want|| / ||want|| per (batch, head) against the plain
               version in f32, a limit that a dropped key tile, emulated in
               the plain version, must exceed), with median times of the
               kernel, the plain version and, as a yardstick only,
               ``scaled_dot_product_attention`` (``library_ms``; none for
               the SSD scan, which no PyTorch call computes; for B4,
               ``torch._grouped_mm``).  ``ms`` and
               ``library_ms`` are calls issued one by one, the host's launch
               cost included, ``host_us`` the wrapper's host work per call;
               ``graph_ms`` and
               ``library_graph_ms`` the same calls replayed from a CUDA
               graph (device time).  A case bound by bytes cycles through
               copies of its inputs, so what a call reads has left the L2
               cache.  Each case has its bound, ``tflops`` and
               ``share_of_bound`` (bound / ms).  Two identical B1 calls must
               be bit-equal.  B3 in bf16 is held the same way on y and the
               state (``kernels/checks.py``: SSD_REL_TOL, against a dropped
               64-token u-tile), at 4 x 2048 for both models, a ragged
               length and one 16384-token prompt alone.  B4 in bf16 at
               Mellum2's prefill (4096 x 8 rows, d -> ff and ff -> d) and
               decode (1, 2 and 8 lanes x 8 rows) over 64 experts, to 5e-3
               in relative norm against its plain version in f32, a limit
               that one expert's rows dropped must exceed; its repeats
               bit-equal.  Untimed edge cases
               hold B1, B2 and B3 to their plain versions at the edges of
               their tiles, splits and chunks, B3 also at a slow decay that
               carries the state across 17 chunks (a cut state passing and
               a dropped entering state must read above the limit), and
               B3's f32 kernel to 2e-5, the encoder-decoder's edges: B1
               with one query row, causal and across to 1024 frames, B1
               unmasked over 1024 frames, B2 over a full 1024-key cross
               cache, and B1 and B2 in f32 at the shapes the ``claims``
               phase gives them (4 q / 2 KV heads of 64, 128-token
               context) to 2e-5, where the last key or 64 keys dropped
               must read above the limit (``edge_cases``, through
               ``kernels/checks.py``);
3. engine    — full-width mistral_7b (random bf16 weights from a seed) on one
               ReplicaEngine: a preempted 1536-token prefill resumes bit for
               bit, and a prefix-cache hit runs the suffix prefill at
               q_offset 256 and agrees with a from-scratch prefill;
4. serve     — the same model behind MiniCluster(pecsched) serving 16
               requests (12 shorts, 4 longs), with each kernel's launch
               count read around this run (the dense main path);
5. profile   — torch.profiler over decode iterations at 8 slots: wall and
               device-busy time per iteration and the top kernels;
6. claims    — the 26 engine specs of the smoke grid (1,378 requests, the
               analytic clock) through ``experiments.run_sweep`` on the card,
               over the reference's reduced f32 stack: every engine-side
               claim passes, B1 and B2 launch, and two smoke_mini specs run
               again on the CPU and on the card give the same summaries
               (the same decisions) and the same greedy tokens;
7. cluster   — ``launch/serve_cluster.py`` at the full width and depth of
               mistral_7b in bf16: 2 + 1 engines with a 4096-token context,
               the measured clock, 24 azure_default requests at 4x the
               measured short capacity (the long runs 3,488 tokens and
               claims both general engines) under pecsched
               and fifo, each served with its target length of in-vocab
               tokens, pecsched preempting the long at least once; serving
               metrics, launches, and the measured seconds per prefill layer
               beside the cost model's;
8. overhead  — ``launch/engine_overhead.py`` at full width: context switch,
               suspension state against the KV, KV migration;
9. ssm       — full-width mamba2_130m,
10. hybrid   — full-width zamba2_2_7b,
11. moe      — olmoe_1b_7b at full width and depth (64 experts, top 8),
12. audio    — seamless_m4t_large_v2 at full width and depth (24 encoder
               and 24 decoder layers), and
13. vlm      — internvl2_76b at full width and 24 of its 80 layers (all 80
               do not fit one card in bf16), each with random bf16 weights
               from seed 0 through ``launch/quickstart.py``: prefill of 4 x
               2048 positions (vlm: 256 patch embeddings + 1792 tokens;
               audio: 1024 encoder frames and a BOS decoder prompt), then 32
               greedy decode steps, with launches read around the prefill
               and around the decode steps (each family's main path) and
               checked exactly, and a profile of 4 more decode steps and of
               one more prefill (device idle share, operations per step);
14. invariant — the five models in f32 at full width (depth cut where
               ``INVARIANT_MODELS`` says): after prefill, decode_step's
               logits equal the last logits of a forward over the extended
               sequence;
15. train    — ``launch/train.py --full`` at the full width of mistral_7b in
               bf16 (32 layers if they fit), batch 1 x 2048, remat, 5 AdamW
               steps on one batch: finite losses that fall, no hand kernel
               launched, seconds per step, tokens/s, peak memory, mfu; the
               kernels refusing autograd; one reduced f32 train step of
               each family on the card equal to the CPU's;
16. train_lm — ``launch/train_lm.py`` at its ~100M parameters, 200 steps:
               the loss falls by 0.3, the checkpoint reloads equal;
17. ring     — llama3_8b's serve step at long_500k, full width and depth in
               bf16: 12,288 tokens prefilled into a ring of 8192, 32 ring
               decode steps, launches exact; in f32 at 4 layers the ring's
               logits equal a windowed forward's (1e-3 / 5e-3);
18. gang     — gang sequence-parallel prefill (paper §5.3) on a mesh whose
               ranks share the card: B1 with its LSE at the ring's hop
               shapes (the diagonal, a hop that sees every key, a fully
               masked hop at exactly 0 / -inf; the kernel table times the
               first two); full-width mistral_7b in bf16 prefilling 8192
               tokens by a gang of 4 on a (2, 2) mesh with each inner
               strategy against the single-replica engine (the same first
               token, GANG_REL_TOL, B1 launched 32 x 4 x 2 times exactly);
               `EngineBackend` gang-prefilling the reference test's long
               through pecsched, preempted and not, with the same tokens;
               f32 on the reference test's model (4 layers, d_model 256)
               to its 5e-4 / 5e-5, card = CPU, the ring's last hop
               dropped reading above them; distributed
               decode over 4 ranks of a 4 x 8192 cache against B2 and the
               plain decode;
19. dryrun   — the dry run's meta account (``launch/dryrun.py``): the
               80-combo matrix through ``dryrun_all.run_matrix`` (66 OK,
               14 SKIP, 0 FAIL; how many fit 80 GB per device on each
               production mesh, and the combos whose verdict the
               per-device account moved from the whole step's peak over n,
               `fits_changed`; host work on the meta device, run in a
               process of its own from the start of the script); the
               account of the runs the ``train``, ``vlm`` and ``ring``
               phases measured, on a one-card host
               mesh, within ACCOUNT_TOL of their peak memory (the train
               account without its optimizer moments must fall outside,
               internvl2_76b at all 80 layers must not fit); and the
               sequence-sharded decode at full width — llama3_8b's ring
               serve step at long_500k over 4 ranks (cache_seq over data
               and model) and mistral_7b with 8 sequences of a 2048-token
               cache over 4 model ranks — against the unsharded serve step
               (B2) with its tokens, in bf16 and in f32: logits within
               SHARDED_REL_TOL (bf16, the plain unsharded decode's
               readings beside them as the yardstick of one more rounding)
               and SHARDED_F32_TOL with B2's greedy tokens (f32), no B2
               launch;
20. partition — the prefill and serve steps partitioned under the
               sharding rules (``launch/partition.py``, ``models/tp.py``)
               on (data, model) meshes whose ranks share the card, from
               shards of the same weights (views): llama31_70b at full
               width and PARTITION_LAYERS (8) of 80 layers on (1, 4) and
               (2, 2), 4 x 2048 prompt tokens into a cache of 2080 and 32
               serve steps, against the unpartitioned steps (B1, B2) — bf16
               within PARTITION_REL_TOL with the same first token (a
               reduce-scatter that drops the last rank's partial must read
               above it, and so must PARTITION_FAULT_STEPS serve steps
               whose all-reduce drops it), f32 at PARTITION_F32_LAYERS within
               PARTITION_F32_TOL with every greedy token — B1 exactly
               layers x ranks per prefill, no B2; the collective bytes
               counted on the card equal to the dry run's count
               (``dryrun.collective_bytes``, what run_combo records) for
               the same arch, shapes, cache length and mesh; the card's
               rise in memory over one bf16 serve step of llama31_70b
               within ACCOUNT_TOL of n x the dry run's per-device account
               (its ranks share the card and their shards are views, so
               the rise is every rank's temporaries and new outputs; the
               account with the decode's partials left out must read
               outside, and the old estimate, the whole step's peak, is
               reported beside it), over the prefill reported (the card
               runs B1, the account the plain attention); qwen2_7b's 28 heads on (1, 8)
               through the sequence fallback (B1 at q_offset) the same way, and
               phi3_14b's 40 q / 10 KV heads on (1, 4), whose KV heads stay whole
               and reach B1 repeated per query head;
21. partition_train — the FSDP train step partitioned under the fsdp
               rules (``partition.train``): mistral_7b at full width and
               PT_LAYERS of its 32 layers in bf16, batch PT_BATCH x PT_SEQ,
               remat, over [card] x 4 shaped (1, 4), (2, 2) and (4, 1) (FSDP
               alone), against the whole-tensor step from the same weights:
               the loss within PT_LOSS_TOL, the grad norm and every leaf's
               gradient within PARTITION_REL_TOL in relative norm (on (4, 1)
               a gradient reduce-scatter that drops the last rank's partial
               must read above it on every leaf it touches), no kernel
               launched, the card's collective bytes equal to the dry run's
               count, the card's rise in memory over the timed step within
               ACCOUNT_TOL of n x the dry run's per-device account
               (``_held_account``: rank 0's FSDP-gathered weights left out
               reported, the forward and backward left out reading
               outside); reported: step and gradient seconds against the
               whole-tensor step's, a profiled step's idle share and
               operations, the card's peak, each rank's parameter, gradient
               and moment GB; in f32 at PT_F32_LAYERS layers, two steps of
               each mesh against two whole-tensor steps: loss and grad norm
               to TRAIN_TOL, the params after each step by `_params_close`;
22. partition_moe — the moe family's partitioned steps, its experts over
               "model" (``models/tp._moe``), on [card] x 4 from shards of one
               set of random bf16 weights: olmoe_1b_7b at full width and
               PM_LAYERS (4) of 16 layers (64 experts top-8) on (1, 4) and
               (2, 2), a prefill of
               4 x 2048 into a cache of 2080 and 32 serve steps, held as
               ``partition`` holds its runs against the unpartitioned steps
               (B1, B2) routed as the partitioned run was (each token's
               top-k experts, slots and keeps replayed, the gates from the
               unpartitioned step's own logits: one more rounding of the
               routing input reorders near ties, and a token routed
               otherwise moves by O(gate)); the share of routed (token, k)
               assignments per layer whose expert or keep differs from the
               unpartitioned run's own routing held to ROUTING_FLIP_TOL,
               the readings against that run reported; an expert sum
               without the last expert rank's partial reading above
               PARTITION_REL_TOL; f32 at PM_F32_LAYERS within
               PARTITION_F32_TOL with every greedy token;
               llama4_maverick_400b_a17b at full width and PM_LLAMA4_LAYERS
               of its 48 layers (the shared expert, top-1, 32 experts and
               10 q / 2 KV heads per rank) in bf16 on (1, 4), its expert
               fault on a rank its compared tokens reach; and olmoe's FSDP
               train step at PM_TRAIN_LAYERS of 16 layers as
               ``partition_train`` holds mistral_7b's (the loss with 0.01 x
               the load-balance loss, the router's gradient among the
               leaves, the whole-tensor gradients and f32 steps routed as
               the partitioned ones were), over (1, 4), (2, 2) and (4, 1),
               f32 at PM_TRAIN_F32_LAYERS;
23. partition_ssm — the ssm and hybrid families' partitioned steps
               (``models/tp._mamba``: in_proj, the conv and the gate over
               the whole gathered sequence on every model rank, the scan
               over the rank's heads or rows; the hybrid's shared block
               tensor-parallel) on ranks sharing the card, from shards of
               one set of random weights: mamba2_130m and zamba2_2_7b at
               full width and PS_LAYERS (8 of 24, 18 of 54) in bf16 on
               (1, 4) and (2, 2) (B3 on 6
               / 20 heads per rank on (1, 4)), a prefill of 4 x 2048 into a
               cache of 2080 and PS_STEPS serve steps, against the
               unpartitioned steps (B3, B1, B2): prefill logits, the conv
               state and the shared block's K/V per (layer, row, head), the
               SSM state per (layer, row) (bf16: within the larger of the
               limit and the plain versions' unpartitioned prefill's own
               reading, the yardstick of one more rounding; per head
               reported) and each serve step's logits within
               PARTITION_REL_TOL (the first token reported), B3 exactly
               layers x ranks and B1 shared-block uses x ranks per
               prefill, no kernel in a serve step, the collective bytes
               equal to the dry run's, the last rank's heads dropped from
               y's all-gather reading above the limit; f32 at
               PS_F32_LAYERS within PARTITION_F32_TOL with every greedy
               token; mamba2_130m's 24 heads on (1, 16) (the dry run's
               pod16x16 case: each rank scans 128 rows from a zero state
               and adds the state entering them) at PS_ROWS_LAYERS in
               bf16 and f32, the entering state dropped reading above the
               limit; the FSDP train step as ``partition_train`` holds
               mistral_7b's, zamba2_2_7b at PS_TRAIN_LAYERS (one segment
               under one remat) with in_proj's gradient sum over "model"
               dropping the last rank's partial reading above the limit on
               (1, 4), and mamba2_130m at PS_SSM_TRAIN_LAYERS;
24. partition_audio — the audio family's partitioned steps (``models/
               tp._encode``, ``_dec_layer``: the encoder's residual whole
               over "model", its attention unmasked over the frames, the
               decoder's cross K/V projected per rank's heads and moved
               into the cross cache by the prefill's all-to-all, the serve
               step's cross decode over the rank's slice of the cross
               cache) on ranks sharing the card, from shards of one set of
               random weights: seamless_m4t_large_v2 at full width and
               depth (24 + 24 layers) in bf16 on (1, 4) and (2, 2),
               PARTITION_BATCH x PA_FRAMES frames and a BOS token into a
               self cache of 1024 and the cross cache, PS_STEPS serve
               steps, against the unpartitioned steps (B1, B2): prefill
               logits, the self and cross K/V per (layer, row, head) and
               each serve step's logits within PARTITION_REL_TOL with the
               same first token, B1 exactly (24 + 2 x 24) x ranks per
               prefill, no kernel in a serve step, the collective bytes
               equal to the dry run's, the last model rank's partial
               dropped from the first encoder all-reduce and the last
               rank's slice of the cross cache dropped from
               PARTITION_FAULT_STEPS serve steps' merge each reading above
               the limit; f32 at PA_F32_LAYERS + PA_F32_LAYERS within
               PARTITION_F32_TOL with every greedy token; the FSDP train
               step as ``partition_train`` holds mistral_7b's, at
               PA_TRAIN_LAYERS + PA_TRAIN_LAYERS layers, PA_FRAMES frames
               and 512 decoder tokens a sequence, the encoder's output
               detached in the decoder reading above the limit on every
               encoder leaf on (1, 4).

Then one JSON line with every kernel's numbers (launches summed over the
serve, claims, cluster, overhead, ssm, hybrid, moe, audio, vlm, ring, gang,
dryrun, partition, partition_moe, partition_ssm and partition_audio phases;
the train phases launch none)
and, last, the result line ``{"ok": true, "device": {...}}``.  The script exits non-zero without a
result line when CUDA is absent or the port's sources are not beside it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import multiprocessing
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 2e-2                      # bf16: atol = rtol
REL_TOL = 5e-3                  # bf16 B1: ||got - want|| / ||want|| per (batch, head,
Q_ROWS = 1024                   # ... block of Q_ROWS queries)
#: bf16 B4: ||got - want|| / ||want|| against the plain version in f32 on the
#: same bf16 inputs (f32 sums in another order, the output rounded once)
B4_REL_TOL = 5e-3
#: claims: the share of requests whose greedy tokens are the same on the CPU
#: and the card (a near tie between the top two logits may flip one argmax
#: between devices, and then that request's later tokens)
GREEDY_AGREEMENT = 0.95
#: cluster: arrivals over the measured short capacity.  The long's prefill
#: is bound by the card (32 layers of ~3.4 ms at 3,488 tokens) and a short's
#: service by the host (decode iterations), so the arrival rate the
#: calibration gives moves with the host's speed: at 4x the shorts behind
#: the long arrive inside its prefill, at 1.2x they may come after it ends
CLUSTER_UTILIZATION = 4.0
#: ring: the prompt prefilled into llama3_8b's ring of 8192 (one and a half windows)
RING_PROMPT = 12288
#: gang: mistral_7b's prompt, prefilled by a gang of GANG_DEGREE ranks on a
#: (2, 2) mesh: each outer segment, a ring hop's query and key length, is
#: GANG_SEG tokens
GANG_PROMPT, GANG_DEGREE = 8192, 4
GANG_SEG = GANG_PROMPT // 2
#: gang: full width in bf16, the gang's logits and each (layer, KV head)'s
#: KV against the single replica's, in ||got - want|| / ||want||.  The two
#: are bf16 roundings apart, not equal: the ring merges hop outputs that B1
#: rounded to bf16 (as the reference merges its bf16 hop outputs), one more
#: rounding of every attention output (2^-9 relative), carried down the
#: residual stream; on the CPU at 8-16 layers of a narrower model the
#: readings are 1.1e-2 - 1.6e-2.  A dropped hop reads O(1) (the f32 fault).
GANG_REL_TOL = 5e-2
#: gang: f32 on tests/multidevice/test_gang_sp.py's model (mistral_7b
#: reduced to 4 layers, d_model 256) and prompt (96 tokens, seed 1), to
#: its limits: logits and KV, max |error|
GANG_F32_LAYERS, GANG_F32_PROMPT = 4, 96
GANG_F32_TOL = {"logits": 5e-4, "kv": 5e-5}
#: dryrun: the account's per-device total against the peak memory a phase
#: measured (torch.cuda.max_memory_allocated after reset_peak_memory_stats),
#: as a ratio's distance from 1
ACCOUNT_TOL = 0.10
#: dryrun: the sharded decode's logits against the unsharded serve step's
#: (B2), ||got - want|| / ||want|| per row and step; both bf16 at full width
SHARDED_REL_TOL = 5e-2
#: dryrun: the same in f32 at full width, where the greedy tokens must agree
SHARDED_F32_TOL = 1e-4
#: dryrun: bf16 steps of the planted fault (the merge drops the last rank's
#: partial), each of which must read above SHARDED_REL_TOL
SHARDED_FAULT_STEPS = 4
#: partition: llama31_70b at full width and PARTITION_LAYERS of its 80
#: layers (80 are ~141 GB in bf16, over one card), prefilling
#: PARTITION_BATCH x PARTITION_PROMPT tokens into a cache of PARTITION_CACHE
#: positions and PARTITION_STEPS serve steps, partitioned over each of
#: PARTITION_MESHES (data, model) on ranks that share the card; f32 at
#: PARTITION_F32_LAYERS.  qwen2_7b's 28 heads on (1, 8) take the rules'
#: sequence fallback at PARTITION_F32_LAYERS layers
#: (bf16 at 8 of 80 layers: cut from 24 to keep the script within its time
#: limit once partition_ssm runs; at 4 layers one of the 4 rows' first
#: token flips on (1, 4), so the cut stops at 8)
PARTITION_LAYERS, PARTITION_F32_LAYERS = 8, 4
PARTITION_BATCH, PARTITION_PROMPT, PARTITION_STEPS = 4, 2048, 32
PARTITION_CACHE = PARTITION_PROMPT + PARTITION_STEPS
PARTITION_MESHES = ((1, 4), (2, 2))
#: partition: logits per row and step and every (layer, sequence)'s K and V
#: against the unpartitioned steps (B1, B2), in ||got - want|| / ||want||:
#: bf16 (partial sums rounded to bf16 before their reduction, the gang's
#: and the sharded decode's limit) and f32 (where every greedy token agrees)
PARTITION_REL_TOL, PARTITION_F32_TOL = 5e-2, 1e-4
#: partition_moe: per layer, the most routed (token, k) assignments, as a
#: share, whose (expert, keep) may differ from the unpartitioned step's: in
#: bf16 one more rounding of the routing input reorders near ties (olmoe at
#: full width read 2-4 % per layer on the card), a wrong routing reads ~1
ROUTING_FLIP_TOL = 0.1
#: partition: teacher-forced serve steps on a mesh whose all-reduce drops
#: the last rank's partial (the first mesh, bf16), each above the limit
PARTITION_FAULT_STEPS = 2
#: partition_train: mistral_7b at full width and PT_LAYERS of its 32
#: layers in bf16 (both steps hold their own weights and moments: the
#: update runs in place; the whole-tensor step alone peaks at 48.4 GB at
#: 32 layers), PT_BATCH x PT_SEQ tokens, remat, partitioned over each of
#: PT_MESHES (data, model) on ranks that share the card; f32 at
#: PT_F32_LAYERS, two steps (bf16 at 2 layers: cut from 8 to 4 and then to
#: 2, as PARTITION_LAYERS is, to keep the script within its time limit)
PT_LAYERS, PT_F32_LAYERS = 2, 2
PT_BATCH, PT_SEQ = 4, 2048
PT_MESHES = ((1, 4), (2, 2), (4, 1))
#: partition_train: bf16 loss against the whole-tensor step's, relative
PT_LOSS_TOL = 1e-2
#: partition_moe: olmoe_1b_7b's serving run at PM_LAYERS of 16 on PM_MESHES
#: (f32 at PM_F32_LAYERS), llama4_maverick_400b_a17b's at PM_LLAMA4_LAYERS
#: of 48 (~37 GB in bf16) on (1, 4), olmoe's train step at PM_TRAIN_LAYERS
#: of 16 (f32 at PM_TRAIN_F32_LAYERS) on PT_MESHES; the PARTITION_* shapes.
#: Depth is cut for the script's time limit, as PARTITION_LAYERS is: the
#: serving run from 16 layers to 4 (at 2 one of the 4 rows' first token
#: flips on (1, 4), so the cut stops at 4) and the train step from 8 to 4,
#: 2 and then 1 (at 8 it took 276 s of the phase's 451 s on the card, H100
#: 80GB HBM3, 700 W)
PM_MESHES = ((1, 4), (2, 2))
PM_LAYERS, PM_F32_LAYERS, PM_LLAMA4_LAYERS = 4, 4, 1
PM_TRAIN_LAYERS, PM_TRAIN_F32_LAYERS = 1, 1
#: peak GB measured by the train, vlm and ring phases, read by dryrun
#: partition_ssm: mamba2_130m and zamba2_2_7b at full width and
#: PS_LAYERS (cut from their full 24 and 54 layers for the script's time
#: limit; zamba2 at 3 of 9 shared-block uses) in bf16 on PM_MESHES, the
#: PARTITION_* shapes; f32 at PS_F32_LAYERS (zamba2: one segment);
#: mamba2_130m's 24 heads on (1, 16), the rules' sequence fallback (the
#: dry run's pod16x16 case), at PS_ROWS_LAYERS in bf16 and f32; the FSDP
#: train step of zamba2 at PS_TRAIN_LAYERS (one segment) and of mamba2_130m
#: at PS_SSM_TRAIN_LAYERS of 24 on PT_MESHES, f32 at the least depth
#: (zamba2 6, mamba2_130m 1)
PS_LAYERS = {"mamba2_130m": 8, "zamba2_2_7b": 18}
PS_F32_LAYERS = {"mamba2_130m": 4, "zamba2_2_7b": 6}
#: serve steps per run (a partitioned zamba2 step takes ~1.2 s of host time
#: on the shared card)
PS_STEPS = 8
PS_ROWS_MESH, PS_ROWS_LAYERS = (1, 16), 4
PS_TRAIN_LAYERS, PS_SSM_TRAIN_LAYERS = 6, 4
#: partition_audio: seamless_m4t_large_v2 at full width and depth (24
#: encoder and 24 decoder layers) in bf16 on PM_MESHES, PARTITION_BATCH x
#: PA_FRAMES frames and a BOS token into the reference's self cache of
#: AUDIO_SELF_CACHE and a cross cache of PA_FRAMES, PS_STEPS serve steps;
#: f32 at PA_F32_LAYERS encoder and decoder layers; the FSDP train step at
#: PA_TRAIN_LAYERS of each (PA_FRAMES frames and AUDIO_DECODER_TRAIN_LEN
#: decoder tokens per sequence) on PT_MESHES, f32 at the same depth
PA_FRAMES, PA_F32_LAYERS, PA_TRAIN_LAYERS = 1024, 4, 2
PEAK_GB = {}
HBM_BPS = 3.35e12               # H100 SXM data sheet
BF16_FLOPS = 989e12


def _say(phase: str, **fields) -> None:
    print(f"{phase}: {json.dumps(fields)}", flush=True)


def _eager(calls, reps: int = 10, trials: int = 5):
    """(ms, host_us): median over `trials` of the mean per-call time of
    `reps` back-to-back calls issued one by one, timed with CUDA events
    after a warm-up call of each, and the host's own time per call (the
    wrapper's work up to the launch returning).  `calls` is one call or a
    list taken in turn (`_copies`)."""
    import torch
    calls = calls if isinstance(calls, list) else [calls]
    for fn in calls:
        fn()
    times, host = [], []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for i in range(reps):
            calls[i % len(calls)]()
        host.append(1e6 * (time.perf_counter() - t0) / reps)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times), statistics.median(host)


def _median_ms(calls, reps: int = 10, trials: int = 5) -> float:
    """The device-timed part of `_eager`."""
    return _eager(calls, reps, trials)[0]


def _graph_ms(calls, reps: int = 20, trials: int = 5) -> float:
    """Device time per call: median over `trials` of one replay of a CUDA
    graph holding `reps` calls (taken in turn from `calls`, as in
    `_eager`), timed with CUDA events.  Unlike `_eager`, this
    leaves out the host's cost of each launch, which bounds a short
    kernel's time issued one by one."""
    import torch
    calls = calls if isinstance(calls, list) else [calls]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                  # warm-up outside capture
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            calls[i % len(calls)]()
    graph.replay()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    del graph
    return statistics.median(times)


def _kernel_times(calls):
    """A kernel's `ms` (issued one by one), `host_us` (its wrapper's host
    work per call) and `graph_ms` (device time)."""
    ms, host_us = _eager(calls)
    return dict(ms=ms, host_us=host_us, graph_ms=_graph_ms(calls))


def _copies(torch, dev, nbytes, bound_by, tensors):
    """`tensors` and, for a case bound by bytes, clones of them: enough
    sets that cycling through them reads twice the L2 cache's size between
    two reads of one set, so each call finds its inputs out of L2 as a
    serving step finds each layer's.  One set for a case bound by
    operations, whose inputs are reread from L2 by design."""
    n = 1
    if bound_by == "bytes":
        l2 = torch.cuda.get_device_properties(dev).L2_cache_size
        n = 1 + -(-2 * l2 // nbytes)
    return [tensors] + [tuple(t.clone() for t in tensors) for _ in range(n - 1)]


def _visible_pairs(sq, kv_len, causal, window, q_offset):
    """(query, key) pairs attention must compute for these inputs, per
    batch element: the work the data needs, not the padded maximum."""
    total = 0
    for kl in kv_len:
        for i in range(sq):
            qpos = i + q_offset
            hi = min(kl, qpos + 1) if causal else kl
            lo = max(0, qpos - window + 1) if window else 0
            total += max(0, hi - lo)
    return total


def _bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of operations over the bf16 peak and
    bytes over the memory rate."""
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BPS
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def _timed(row, flops, nbytes):
    """Add to a case its bound, the achieved rate and the share of the
    bound the kernel reaches (bound_ms / ms), also on device time."""
    bound_ms, bound_by = _bound(flops, nbytes)
    row.update(bound_ms=bound_ms, bound_by=bound_by,
               tflops=flops / (row["ms"] * 1e-3) / 1e12,
               share_of_bound=bound_ms / row["ms"],
               graph_share_of_bound=bound_ms / row["graph_ms"])
    return row


def _sass_functions(lib_path):
    """{mangled function name: its SASS} of a built library, from cuobjdump."""
    from repro_torch.kernels import _build
    exe = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(exe), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return {chunk.split("\n", 1)[0].strip(): chunk
            for chunk in sass.split("Function : ")[1:]}


def _sass_counts(lib_path):
    """Tensor-core (HGMMA, i.e. wgmma) and TMA (UTMALDG) instructions in each
    tensor-core kernel of B1's library."""
    counts = {}
    for fn, body in _sass_functions(lib_path).items():
        m = re.search(r"fa_tc_kernelILi(\d+)E", fn)
        if m:
            counts[f"fa_tc_kernel<{m.group(1)}>"] = {
                op: len(re.findall(rf"\b{op}\b", body)) for op in ("HGMMA", "UTMALDG")}
    if len(counts) != 3 or not all(min(c.values()) > 0 for c in counts.values()):
        raise AssertionError(f"B1's tensor-core kernels lack wgmma or TMA: {counts}")
    return counts


def _ssd_sass_counts(lib_path):
    """Tensor-core instructions (HMMA, i.e. mma.sync) in every instantiation
    of B3's three bf16 product kernels: (instantiations, least, most)."""
    counts = {}
    for fn, body in _sass_functions(lib_path).items():
        for kernel in ("cb_kernel", "state_kernel", "out_kernel"):
            if kernel in fn:
                counts.setdefault(kernel, []).append(len(re.findall(r"\bHMMA\b", body)))
    if set(counts) != {"cb_kernel", "state_kernel", "out_kernel"} \
            or min(min(c) for c in counts.values()) == 0:
        raise AssertionError(f"B3's bf16 kernels lack tensor-core HMMA: {counts}")
    return {k: dict(instantiations=len(c), hmma_min=min(c), hmma_max=max(c))
            for k, c in counts.items()}


def phase_kernels(torch, dev):
    import torch.nn.functional as F

    from repro_torch.kernels.checks import rel_err
    from repro_torch.kernels.flash_attention import flash_attention, torch_attention
    from repro_torch.kernels.flash_decode import flash_decode, split_plan, torch_decode

    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)

    def check(name, got, want):
        err = (got.float() - want.float()).abs().max().item()
        if not torch.allclose(got.float(), want.float(), atol=TOL, rtol=TOL):
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version, max |err| {err} (tol {TOL})")
        return err

    def rel_rows(got, want):
        """rel_err per (batch, head, block of Q_ROWS queries): a fault in a
        few rows of a long sequence reads in its own block."""
        return max(rel_err(a, b) for a, b in zip(got.split(Q_ROWS, 2),
                                                 want.split(Q_ROWS, 2)))

    def check_rel(name, got, want):
        rel = rel_rows(got, want)
        if not rel < REL_TOL:
            raise AssertionError(f"{name}: ||got - want|| / ||want|| {rel} in a "
                                 f"(batch, head, {Q_ROWS} queries) (limit {REL_TOL})")
        return rel

    cases, rows = [], {}
    # flash attention: prefill quantum, suffix after a cache hit, window
    # (mistral_7b: H 32, KV 8, D 128); zamba2's shared block (MHA, D 80);
    # olmoe_1b_7b's prefill (MHA 16, D 128); seamless_m4t_large_v2's encoder
    # (unmasked over 1024 frames, MHA 16, D 64) and its decoder's BOS row
    # across to those frames; internvl2_76b's prefill (64 q / 8 KV heads);
    # llama3_8b's ring prefill at long_500k (12,288 tokens, window 8192);
    # the gang SP ring's hops of mistral_7b at 8192 tokens over a (2, 2)
    # mesh (GANG_*: 16 q / 4 KV heads per rank over a 4096-token segment),
    # the diagonal and the hop that sees every key; the partitioned prefill's
    # per-rank shapes: llama31_70b on 4 model ranks (16 q / 2 KV heads) and
    # qwen2_7b's last of 8 ranks in the sequence fallback (256 query rows at
    # q_offset 1792 against all 2048 keys, 28 q / 4 KV heads); the
    # partitioned moe prefill's on 4 model ranks: olmoe_1b_7b (MHA 4) and
    # llama4_maverick_400b_a17b (10 q / 2 KV heads); the partitioned hybrid
    # prefill's shared block on 4 model ranks: zamba2_2_7b (MHA 8, D 80);
    # the partitioned audio prefill's on 4 model ranks: seamless_m4t_large_v2's
    # encoder (MHA 4, D 64, unmasked over 1024 frames) and its decoder's
    # cross attention (one query row across those frames).
    # q is a transposed (B, S, H, D) view, as attention_block passes it.
    for name, B, H, KV, D, sq, sk, qo, win, ragged, causal in (
            ("fa_causal_1536", 1, 32, 8, 128, 1536, 1536, 0, 0, False, True),
            ("fa_suffix_256_at_256", 1, 32, 8, 128, 256, 512, 256, 0, False, True),
            ("fa_window64_512_ragged", 2, 32, 8, 128, 512, 512, 0, 64, True, True),
            ("fa_mha_d80_causal_2048", 4, 32, 32, 80, 2048, 2048, 0, 0, False, True),
            ("fa_olmoe_mha16_causal_2048", 4, 16, 16, 128, 2048, 2048, 0, 0, False,
             True),
            ("fa_audio_enc_noncausal_1024_d64", 4, 16, 16, 64, 1024, 1024, 0, 0,
             False, False),
            ("fa_audio_cross_sq1_1024_d64", 4, 16, 16, 64, 1, 1024, 0, 0, False,
             False),
            ("fa_vlm_gqa8_causal_2048", 4, 64, 8, 128, 2048, 2048, 0, 0, False,
             True),
            ("fa_ring_llama3_w8192_12288", 1, 32, 8, 128, RING_PROMPT, RING_PROMPT,
             0, 8192, False, True),
            ("fa_gang_hop_diagonal_4096", 1, 16, 4, 128, GANG_SEG, GANG_SEG, 0, 0,
             False, True),
            ("fa_gang_hop_visible_4096", 1, 16, 4, 128, GANG_SEG, GANG_SEG,
             GANG_SEG, 0, False, True),
            ("fa_partition_tp4_gqa8_causal_2048", PARTITION_BATCH, 16, 2, 128,
             PARTITION_PROMPT, PARTITION_PROMPT, 0, 0, False, True),
            ("fa_partition_rows8_qwen2_256_at_1792", PARTITION_BATCH, 28, 4, 128,
             PARTITION_PROMPT // 8, PARTITION_PROMPT, PARTITION_PROMPT * 7 // 8, 0,
             False, True),
            ("fa_partition_moe_olmoe_mha4_causal_2048", PARTITION_BATCH, 4, 4, 128,
             PARTITION_PROMPT, PARTITION_PROMPT, 0, 0, False, True),
            ("fa_partition_moe_llama4_10q2kv_causal_2048", PARTITION_BATCH, 10, 2, 128,
             PARTITION_PROMPT, PARTITION_PROMPT, 0, 0, False, True),
            ("fa_partition_zamba2_mha8_d80_causal_2048", PARTITION_BATCH, 8, 8, 80,
             PARTITION_PROMPT, PARTITION_PROMPT, 0, 0, False, True),
            ("fa_partition_audio_enc_mha4_noncausal_1024_d64", PARTITION_BATCH, 4, 4, 64,
             PA_FRAMES, PA_FRAMES, 0, 0, False, False),
            ("fa_partition_audio_cross_sq1_mha4_1024_d64", PARTITION_BATCH, 4, 4, 64, 1,
             PA_FRAMES, 0, 0, False, False)):
        q = rn(B, sq, H, D).transpose(1, 2)
        k, v = rn(B, KV, sk, D), rn(B, KV, sk, D)
        kl = [sk, sk - 77] if ragged else [sk] * B
        kvl = torch.tensor(kl, dtype=torch.int32, device=dev) if ragged else None
        kw = dict(causal=causal, sliding_window=win, q_offset=qo, kv_len=kvl)
        got = flash_attention(q, k, v, **kw)
        # the plain version in f32 on the same bf16 inputs; rounded to bf16
        # it is torch_attention(q, k, v) itself
        want = torch_attention(q.float(), k.float(), v.float(), **kw)
        err = check(name, got, want.to(q.dtype))
        rel = check_rel(name, got, want)
        # the readings of faults: the last 128-key tile of each sequence
        # dropped (the plain version with kv_len 128 shorter) and, where the
        # window spans more than a tile, the window one tile shorter
        faults = {"dropped_key_tile": dict(
            kv_len=torch.tensor(kl, dtype=torch.int32, device=dev) - 128)}
        if win > 128:
            faults["window_short_by_a_tile"] = dict(sliding_window=win - 128)
        fault = {}
        for what, over in faults.items():
            fault[what] = rel_rows(torch_attention(
                q.float(), k.float(), v.float(), **dict(kw, **over)).to(q.dtype), want)
            if not fault[what] > REL_TOL:
                raise AssertionError(f"{name}: fault {what} reads {fault[what]}, "
                                     f"inside the limit {REL_TOL}")
        del want
        if not torch.equal(got, flash_attention(q, k, v, **kw)):
            raise AssertionError(f"{name}: two identical calls differ")
        qpos = torch.arange(sq, device=dev)[:, None] + qo
        kpos = torch.arange(sk, device=dev)[None]
        mask = ((qpos >= kpos) if causal else True) & ((qpos - kpos < win) if win
                                                      else True)
        mask = mask & (kpos[None, None] < torch.tensor(kl, device=dev)[:, None, None,
                                                                       None])
        # every key visible to every query: SDPA runs it unmasked
        full = causal and qo >= sk - 1 and not win and not ragged
        dense = full or (qo == 0 and win == 0 and not ragged
                         and (sq == sk or not causal))
        pairs = _visible_pairs(sq, kl, causal, win, qo)
        flops = 4 * H * D * pairs
        k_rows = sum(min(x, sq + qo) if causal else x for x in kl)
        nbytes = 2 * (2 * B * H * sq * D + 2 * KV * k_rows * D)
        sets = _copies(torch, dev, nbytes, _bound(flops, nbytes)[1], (q, k, v))
        calls = [lambda t=t: flash_attention(*t, **kw) for t in sets]
        lib = [(lambda t=t: F.scaled_dot_product_attention(
                    *t, is_causal=causal and not full, enable_gqa=True))
               if dense else
               (lambda t=t: F.scaled_dot_product_attention(*t, attn_mask=mask,
                                                           enable_gqa=True))
               for t in sets]
        row = _timed(dict(max_abs_err=err, tol=TOL, rel_err=rel, rel_tol=REL_TOL,
                          fault_rel_err=fault, bit_equal_repeat=True,
                          copies=len(sets), **_kernel_times(calls),
                          plain_ms=_median_ms(lambda: torch_attention(q, k, v, **kw),
                                              3, 3),
                          library_ms=_median_ms(lib), library_graph_ms=_graph_ms(lib)),
                     flops, nbytes)
        del sets, calls, lib
        cases.append(dict(case=name, pairs=pairs, **row))
        rows.setdefault("flash_attention", row)
    # flash decode: 8 slots with ragged cache lengths, with and without
    # window (mistral_7b), zamba2's shared block (MHA, D 80), olmoe_1b_7b's
    # decode (4 x ~2048, MHA 16, D 128), seamless_m4t_large_v2's cross
    # attention over a full cache of 1024 frames (MHA 16, D 64),
    # internvl2_76b's decode (8 query heads per KV head, 4 x ~2080) and
    # llama3_8b's ring decode at long_500k (one sequence, a full ring of 8192)
    for name, B, S, H, KV, D, win, full in (
            ("fd_b8_s2048_ragged_win0", 8, 2048, 32, 8, 128, 0, False),
            ("fd_b8_s2048_ragged_win64", 8, 2048, 32, 8, 128, 64, False),
            ("fd_mha_d80_b8_s2048_ragged", 8, 2048, 32, 32, 80, 0, False),
            ("fd_olmoe_mha16_b4_s2088_ragged", 4, 2088, 16, 16, 128, 0, False),
            ("fd_audio_cross_b4_s1024_d64", 4, 1024, 16, 16, 64, 0, True),
            ("fd_vlm_rep8_b4_s2080_ragged", 4, 2080, 64, 8, 128, 0, False),
            ("fd_ring_llama3_b1_s8192_full", 1, 8192, 32, 8, 128, 0, True)):
        q, k, v = rn(B, H, D), rn(B, KV, S, D), rn(B, KV, S, D)
        cl = torch.randint(1, S + 1, (B,), generator=g, device=dev,
                           dtype=torch.int32)
        cl[0] = S
        if full:
            cl.fill_(S)
        err = check(name, flash_decode(q, k, v, cl, sliding_window=win),
                    torch_decode(q, k, v, cl, sliding_window=win))
        kpos = torch.arange(S, device=dev)[None]
        valid = kpos < cl[:, None]
        if win:
            valid &= kpos >= cl[:, None] - win
        mask = valid[:, None, None, :]
        read = sum(min(x, win) if win else x for x in cl.tolist())
        nbytes = 2 * (2 * KV * D * read + 2 * B * H * D)
        flops = 4 * H * D * read
        n_split, chunk = split_plan(B, KV, S, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        sets = _copies(torch, dev, nbytes, _bound(flops, nbytes)[1], (q, k, v))
        calls = [lambda t=t: flash_decode(*t, cl, sliding_window=win) for t in sets]
        lib = [lambda t=t: F.scaled_dot_product_attention(
            t[0][:, :, None], t[1], t[2], attn_mask=mask, enable_gqa=True)
            for t in sets]
        row = _timed(dict(max_abs_err=err, tol=TOL, copies=len(sets),
                          **_kernel_times(calls),
                          plain_ms=_median_ms(lambda: torch_decode(
                              q, k, v, cl, sliding_window=win)),
                          library_ms=_median_ms(lib), library_graph_ms=_graph_ms(lib)),
                     flops, nbytes)
        del sets, calls, lib
        cases.append(dict(case=name, tokens_read=read, n_split=n_split,
                          split_keys=chunk, blocks=KV * B * n_split, **row))
        rows.setdefault("flash_decode", row)
    edges = _edge_cases(torch, dev, g, rn)
    edges += _ssd_edge_cases(torch, dev, g)
    _ssd_cases(torch, dev, g, cases, rows)
    _b4_cases(torch, dev, g, cases, rows)
    _say("kernels", cases=cases, edge_cases=edges)
    return rows


def _edge_cases(torch, dev, g, rn):
    """B1 and B2 in bf16 at the edges of their tiling and splits, each
    against its plain version (`kernels/checks.py`: 2e-2, B1 also B1_REL_TOL
    in relative norm, repeats bit-equal), untimed: B1 with ragged Sq/Sk, a
    q_offset with Sq < Sk, a window across tile edges, ragged kv_len and
    rows with no visible key (output 0, LSE -inf where the plain version
    has it), at D 64/80/128; B2 with cache_len 0, 1, under one split, on a
    split boundary, one past it and S, with windows across a boundary; and
    the encoder-decoder's edges (`checks.cross_edge_checks`): B1 with one
    query row, causal and across to 1024 frames, B1 unmasked over 1024, B2
    over a full 1024-key cross cache; and B1 and B2 in f32 at the evaluation
    path's engine shapes (`checks.engine_f32_checks`)."""
    from repro_torch.kernels.checks import (attention_check, cross_edge_checks,
                                            decode_check, engine_f32_checks)
    from repro_torch.kernels.flash_decode import split_plan
    out = []
    for name, B, H, KV, D, sq, sk, causal, win, qo, kvl in (
            ("fa_ragged_100_at_60_of_160_d64", 2, 16, 4, 64, 100, 160, True, 0, 60,
             [160, 155]),
            ("fa_window70_200_d128", 1, 32, 8, 128, 200, 200, True, 70, 0, None),
            ("fa_noncausal_kvlen37_d80", 2, 8, 8, 80, 130, 130, False, 0, 0, [130, 37]),
            ("fa_empty_rows_d128", 2, 32, 8, 128, 96, 192, True, 17, -8, [192, 0])):
        q = rn(B, sq, H, D).transpose(1, 2)
        k, v = rn(B, KV, sk, D), rn(B, KV, sk, D)
        kv_len = torch.tensor(kvl, dtype=torch.int32, device=dev) if kvl else None
        out.append(attention_check(name, q, k, v, causal=causal, sliding_window=win,
                                   q_offset=qo, kv_len=kv_len))
    B, KV, S = 8, 8, 2048
    n_split, chunk = split_plan(B, KV, S, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    cl = torch.tensor([0, 1, chunk // 3, chunk, chunk + 1, S, 2 * chunk - 5, S - 1],
                      dtype=torch.int32, device=dev)
    for D, H in ((128, 32), (80, 8), (64, 64)):
        q, k, v = rn(B, H, D), rn(B, KV, S, D), rn(B, KV, S, D)
        for win in (0, chunk // 2 + 3):
            name = f"fd_split_edges_d{D}_rep{H // KV}_win{win}"
            out.append(dict(decode_check(name, q, k, v, cl, sliding_window=win),
                            n_split=n_split, split_keys=chunk))
    out += cross_edge_checks(generator=g, device=dev)
    # their own generator: the draws above and below stay as they were
    return out + engine_f32_checks(
        generator=torch.Generator(device=dev).manual_seed(16), device=dev)


def _ssd_cases(torch, dev, g, cases, rows):
    """B3 at both models' prefill shapes (4 x 2048), at the models' own
    chunks, with a ragged length, one 16384-token prompt alone, and at the
    partitioned prefill's per-rank shapes (a rank's 6 / 20 heads on 4 model
    ranks; mamba2_130m's 128 rows on 16, from a zero state); y and the
    final state checked as `checks.ssd_check` says, then timed."""
    from repro_torch.kernels.checks import ssd_check, ssd_inputs
    from repro_torch.kernels.ssd_kernel import chunk_len, ssd_scan, torch_ssd_scan
    for name, b, nh, hd, ns, chunk, s, init in (
            ("ssd_mamba2_130m_b4_s2048", 4, 24, 64, 128, 256, 2048, True),
            ("ssd_zamba2_b4_s2048", 4, 80, 64, 64, 64, 2048, False),
            ("ssd_mamba2_130m_b4_s2000_ragged", 4, 24, 64, 128, 256, 2000, False),
            # one long prompt prefilled alone, the traffic PecSched preempts for
            ("ssd_mamba2_130m_b1_s16384", 1, 24, 64, 128, 256, 16384, True),
            ("ssd_partition_mamba2_130m_6h_b4_s2048", 4, 6, 64, 128, 256, 2048, False),
            ("ssd_partition_zamba2_20h_b4_s2048", 4, 20, 64, 64, 64, 2048, False),
            ("ssd_partition_rows16_mamba2_130m_b4_s128", 4, 24, 64, 128, 256, 128, False)):
        xbc, x, dt, A, B, C, D, h0 = ssd_inputs(b, s, nh, hd, ns, init=init,
                                                generator=g, device=dev)
        kw = dict(chunk=chunk, init_state=h0, return_state=True)
        checked = ssd_check(name, x, dt, A, B, C, D, chunk=chunk, init_state=h0)
        # work this input needs: C.B^T once per (batch, chunk) pair t >= u,
        # scores.x per head, and C.h and the state update per token
        pairs = sum(n * (n + 1) // 2 for n in
                    [chunk] * (s // chunk) + ([s % chunk] if s % chunk else []))
        flops = (2 * b * pairs * ns + 2 * b * nh * pairs * hd
                 + 4 * b * nh * s * hd * ns)
        nbytes = (2 * (2 * b * s * nh * hd + 2 * b * s * ns) + 4 * b * s * nh
                  + 4 * 2 * nh + 4 * b * nh * hd * ns * (2 if init else 1))

        def call(xbc, dt, h0=None):
            x = xbc[..., :nh * hd].reshape(b, s, nh, hd)
            return ssd_scan(x, dt, A, xbc[..., nh * hd:nh * hd + ns],
                            xbc[..., nh * hd + ns:], D, **dict(kw, init_state=h0))
        sets = _copies(torch, dev, nbytes, _bound(flops, nbytes)[1],
                       (xbc, dt) + ((h0,) if init else ()))
        calls = [lambda t=t: call(*t) for t in sets]
        # device time of each of the call's kernels (the four passes in bf16)
        passes = _profile_steps(torch, calls[0], 3)["top_kernels_ms_per_iter"]
        row = _timed(dict(checked, copies=len(sets), passes_ms=passes,
                          **_kernel_times(calls),
                          plain_ms=_median_ms(lambda: torch_ssd_scan(x, dt, A, B, C, D,
                                                                     **kw), 3, 3),
                          library_ms=None), flops, nbytes)
        del sets, calls
        cases.append(dict(case=name, chunk=chunk, kernel_chunk=chunk_len(s, ns),
                          flops=flops, bytes=nbytes, **row))
        rows.setdefault("ssd_scan", row)


def _b4_cases(torch, dev, g, cases, rows):
    """B4 at the main path's shapes over 64 experts, each token routed to 8
    distinct experts at random: Mellum2's 4096-token prefill (4096 x 8 rows,
    d 2304 -> ff 896 for the gate and up products, ff 896 -> d 2304 for
    the down product) and its decode at 1, 2 and 8 lanes x 8 rows.  Each
    against the plain version on the same inputs (B4_REL_TOL in relative
    norm, as the card tests hold it; the plain version with one expert's
    rows dropped must read above it), two identical calls bit-equal, one
    launch counted a call; then timed beside ``torch._grouped_mm`` on the
    same offsets (the library yardstick, which the port never calls)."""
    from repro_torch.kernels.moe_grouped_gemm import moe_grouped_gemm, torch_grouped_gemm

    def rel_err(got, want):
        return float((got.float() - want).norm() / want.norm())
    E, K = 64, 8
    for name, tokens, d_in, d_out in (
            ("b4_prefill_4096x8_gate_up", 4096, 2304, 896),
            ("b4_prefill_4096x8_down", 4096, 896, 2304),
            ("b4_decode_8x8_gate_up", 8, 2304, 896),
            ("b4_decode_8x8_down", 8, 896, 2304),
            ("b4_decode_2x8_gate_up", 2, 2304, 896),
            ("b4_decode_1x8_gate_up", 1, 2304, 896)):
        expert = torch.rand((tokens, E), generator=g, device=dev).topk(K, -1).indices
        counts = torch.bincount(expert.flatten(), minlength=E)
        offsets = torch.zeros(E + 1, dtype=torch.int32, device=dev)
        offsets[1:] = counts.cumsum(0)
        n_rows = tokens * K
        a = torch.randn((n_rows, d_in), generator=g, device=dev, dtype=torch.bfloat16)
        b = (torch.randn((E, d_in, d_out), generator=g, device=dev)
             * d_in ** -0.5).to(torch.bfloat16)
        before = moe_grouped_gemm.launches
        got = moe_grouped_gemm(a, b, offsets)
        again = moe_grouped_gemm(a, b, offsets)
        if moe_grouped_gemm.launches != before + 2:
            raise AssertionError(f"{name}: two calls counted "
                                 f"{moe_grouped_gemm.launches - before} launches")
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: two identical calls differ")
        want = torch_grouped_gemm(a.float(), b.float(), offsets)
        rel = rel_err(got, want)
        if not rel < B4_REL_TOL:
            raise AssertionError(f"{name}: ||got - want|| / ||want|| {rel} "
                                 f"(limit {B4_REL_TOL})")
        bounds = offsets.tolist()
        e = next(i for i in range(E) if bounds[i + 1] > bounds[i])
        dropped = want.clone()
        dropped[bounds[e]:bounds[e + 1]] = 0
        fault = rel_err(dropped, want)
        if not fault > B4_REL_TOL:
            raise AssertionError(f"{name}: one expert's rows dropped reads "
                                 f"{fault}, inside the limit {B4_REL_TOL}")
        del want, dropped, again
        hit = int((counts > 0).sum())
        flops = 2 * n_rows * d_in * d_out
        nbytes = 2 * (hit * d_in * d_out + n_rows * (d_in + d_out))
        sets = _copies(torch, dev, nbytes, _bound(flops, nbytes)[1], (a, b, offsets))
        calls = [lambda t=t: moe_grouped_gemm(*t) for t in sets]
        lib = [lambda t=t: torch._grouped_mm(t[0], t[1], offs=t[2][1:])
               for t in sets]
        row = _timed(dict(rel_err=rel, rel_tol=B4_REL_TOL,
                          fault_rel_err={"dropped_expert_rows": fault},
                          bit_equal_repeat=True, copies=len(sets),
                          **_kernel_times(calls),
                          plain_ms=_median_ms(lambda: torch_grouped_gemm(a, b, offsets),
                                              3, 3),
                          library_ms=_median_ms(lib), library_graph_ms=_graph_ms(lib)),
                     flops, nbytes)
        del sets, calls, lib
        cases.append(dict(case=name, rows=n_rows, experts=E, experts_hit=hit,
                          flops=flops, bytes=nbytes, **row))
        rows.setdefault("moe_grouped_gemm", row)


def _ssd_edge_cases(torch, dev, g):
    """B3 untimed on `checks.ssd_edge_cases` (the edges of its 64-token
    tiles and its chunk, and a slow decay over 17 chunks with the carry
    faults) at ns 64 and 128, b 1 and 2, as `checks.ssd_check` holds it;
    and the f32 CUDA-core kernel to 2e-5 (dt in Mamba2's initial range, as
    tests/test_torch_cuda.py draws it)."""
    from repro_torch.kernels.checks import ssd_check, ssd_edge_cases, ssd_inputs
    from repro_torch.kernels.ssd_kernel import chunk_len, ssd_scan, torch_ssd_scan
    out = []
    for ns, nh in ((64, 5), (128, 3)):
        for b in (1, 2):
            for s, init, slow in ssd_edge_cases(ns, b):
                name = (f"ssd_{'slow' if slow else 'edges'}_ns{ns}_b{b}_s{s}"
                        f"{'_init' if init else ''}")
                _, x, dt, A, B, C, D, h0 = ssd_inputs(b, s, nh, 64, ns, init=init,
                                                      generator=g, device=dev,
                                                      slow=slow)
                out.append(dict(case=name, kernel_chunk=chunk_len(s, ns),
                                **ssd_check(name, x, dt, A, B, C, D, chunk=64,
                                            init_state=h0, carry=slow)))
    _, x, dt, A, B, C, D, h0 = ssd_inputs(2, 300, 3, 64, 128, init=True, generator=g,
                                          device=dev, dtype=torch.float32,
                                          dt_shift=4.0)
    kw = dict(chunk=256, init_state=h0, return_state=True)
    y, h = ssd_scan(x, dt, A, B, C, D, **kw)
    wy, wh = torch_ssd_scan(x, dt, A, B, C, D, **kw)
    err = max((y - wy).abs().max().item(), (h - wh).abs().max().item())
    if not (torch.allclose(y, wy, atol=2e-5, rtol=2e-5)
            and torch.allclose(h, wh, atol=2e-5, rtol=2e-5)):
        raise AssertionError(f"ssd f32: CUDA-core kernel off its plain version by {err}")
    out.append(dict(case="ssd_f32_b2_s300_ns128", max_abs_err=err, tol=2e-5))
    return out


def phase_engine(torch, dev, cfg, params):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.serving.engine import ReplicaEngine

    eng = ReplicaEngine(cfg, params, max_len=2048, layers_per_quantum=2,
                        device=dev)
    rng = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, 1536), generator=rng)

    def run(st):
        done = st.layer >= cfg.num_layers
        while not done:
            st, done = eng.prefill_quantum(st)
        return st

    t0 = time.perf_counter()
    ref = run(eng.start_prefill(0, toks))
    ref_logits = eng.prefill_logits(ref)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    st = eng.start_prefill(1, toks)
    for _ in range(2):                               # 2 quanta, then preempted
        st, _ = eng.prefill_quantum(st)
    other = run(eng.start_prefill(2, toks[:, :300]))  # another request runs
    eng.prefill_logits(other)
    st = run(st)                                     # resumed
    bit_exact = (torch.equal(eng.prefill_logits(st), ref_logits)
                 and all(torch.equal(a, b) for a, b in
                         zip(st.kv_k + st.kv_v, ref.kv_k + ref.kv_v)))
    if not bit_exact:
        raise AssertionError("preempted prefill did not resume bit for bit")
    del ref, st, other

    a = torch.randint(0, cfg.vocab_size, (512,), generator=rng)
    b = torch.cat([a[:256], torch.randint(0, cfg.vocab_size, (256,),
                                          generator=rng)])
    host_a = tuple(a.tolist())
    host_b = tuple(b.tolist())
    st_a = run(eng.start_prefill(10, a[None], host_tokens=host_a))
    eng.cache_prompt(10, *st_a.full_kv(), host_tokens=host_a)
    hit, pk, pv = eng.lookup_cached_prefix(host_b)
    if hit.n_tokens != 256 or pk is None:
        raise AssertionError(f"prefix cache missed: hit {hit.n_tokens} tokens")
    before = flash_attention.launches
    st_c = run(eng.start_prefill(11, b[None], prefix_k=pk, prefix_v=pv,
                                 host_tokens=host_b))
    suffix_launches = flash_attention.launches - before
    if st_c.prefix_len != 256 or suffix_launches != cfg.num_layers:
        raise AssertionError("suffix prefill did not run the attention kernel "
                             f"at q_offset 256 once per layer ({suffix_launches})")
    hit_logits = eng.prefill_logits(st_c).float()
    scratch_logits = eng.prefill_logits(run(eng.start_prefill(12, b[None]))).float()
    err = (hit_logits - scratch_logits).abs().max().item()
    if not torch.allclose(hit_logits, scratch_logits, atol=TOL, rtol=TOL):
        raise AssertionError(f"cache-hit logits differ from scratch by {err}")
    if int(hit_logits.argmax()) != int(scratch_logits.argmax()):
        raise AssertionError("cache-hit and scratch prefills chose other tokens")
    _say("engine", prefill_1536_s=prefill_s, preempt_resume_bit_exact=True,
         prefix_hit_tokens=hit.n_tokens, suffix_attention_launches=suffix_launches,
         cache_hit_vs_scratch_max_abs_err=err, tol=TOL,
         argmax_equal=True)
    del eng


def phase_serve(torch, dev, cfg, params):
    import numpy as np

    from repro_torch.serving import MiniCluster, ServeRequest

    max_new = 16
    mc = MiniCluster(cfg, params, n_engines=2, policy="pecsched", max_len=2048,
                     long_threshold=512, layers_per_quantum=2, device=dev)
    rng = np.random.default_rng(0)
    longs = {1, 4, 7, 10}
    t = 0.0
    for i in range(16):
        is_long = i in longs
        n = int(rng.integers(1024, 1537) if is_long else rng.integers(32, 257))
        mc.submit(ServeRequest(rid=i, arrival=t, max_new=max_new, is_long=is_long,
                               tokens=rng.integers(0, cfg.vocab_size, n).astype(np.int32)))
        t += float(rng.exponential(0.03))
    torch.cuda.reset_peak_memory_stats()
    _, wall, counts = _run_counted(torch, mc.run)
    launches = {n: counts[n] for n in ("flash_attention", "flash_decode")}
    done = {r.rid: r for r in mc.done}
    if len(done) != 16 or any(len(r.generated) != max_new for r in done.values()):
        raise AssertionError("not every request completed with max_new tokens: "
                             f"{ {r.rid: len(r.generated) for r in mc.done} }")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel never ran on the serving path: {launches}")
    for r in done.values():
        if not all(0 <= x < cfg.vocab_size for x in r.generated):
            raise AssertionError(f"request {r.rid} generated an invalid token")

    def stats(xs):
        return {"mean": float(np.mean(xs)), "p99": float(np.percentile(xs, 99))}
    ttft = [r.first_token - r.arrival for r in done.values()]
    tpot = [(r.finish - r.first_token) / (max_new - 1) for r in done.values()]
    be = mc.backend
    _say("serve", requests=len(done), wall_s=wall, metrics=mc.metrics(),
         ttft_s=stats(ttft), tpot_s=stats(tpot),
         decode_tokens=be.stats["decode_tokens"], decode_s=be.decode_s,
         decode_tokens_per_s=be.stats["decode_tokens"] / be.decode_s,
         prefill_quanta=be.stats["prefill_quanta"],
         prefix_cache=be.prefix_cache_stats(), launches=launches,
         launches_per_request={k: v / len(done) for k, v in launches.items()},
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches


def phase_profile(torch, dev, cfg, params):
    """Where a decode iteration's time goes at the serving batch (8 slots of
    ~256 cached tokens): wall time per iteration, the device's busy share
    over it and the kernels that take the most device time."""
    from repro_torch.serving.engine import ReplicaEngine

    eng = ReplicaEngine(cfg, params, max_len=2048, device=dev)
    g = torch.Generator().manual_seed(2)
    slots = {}
    for rid in range(eng.max_slots):
        st = eng.start_prefill(rid, torch.randint(0, cfg.vocab_size, (1, 256),
                                                  generator=g))
        done = False
        while not done:
            st, done = eng.prefill_quantum(st)
        slots[eng.admit(rid, st)] = int(eng.prefill_logits(st)[0].argmax())
    for _ in range(2):                               # warm: view built, caches hot
        slots = eng.decode_iteration(slots)
    state = {"slots": slots}

    def step():
        state["slots"] = eng.decode_iteration(state["slots"])
    _say("profile", what="decode_iteration, 8 slots x 256 tokens",
         **_profile_steps(torch, step, 5))
    del eng


def phase_claims(torch, dev):
    """The engine cells of the smoke grid (`experiments.smoke_grid`, all on
    the analytic clock) on torch engines on the card, over the reference's
    reduced f32 stack (2 layers, d_model 256, 4 q / 2 KV heads of 64): every
    engine-side claim must evaluate and pass, and B1 and B2 must launch.
    Two smoke_mini specs then run on the CPU and again on the card: their
    summaries must equal the sweep's apart from the wall-clock fields (on
    the analytic clock decisions do not depend on numerics, so this holds
    the decisions, not the kernels), and at least GREEDY_AGREEMENT of their
    requests must generate the same greedy tokens on both.  The kernels'
    numerics at these shapes are held in the kernels phase
    (`checks.engine_f32_checks`)."""
    import repro_torch.experiments as ex
    from repro_torch.experiments import runner

    specs = [s for s in ex.smoke_grid() if s.backend == "engine"]
    results, wall, counts = _run_counted(
        torch, lambda: ex.run_sweep(specs, device=dev))
    cres = [r for r in ex.evaluate_claims(ex.smoke_sweep_cells(results))
            if r.backend == "engine"]
    failed = [(r.cid, r.skipped or r.value) for r in cres
              if r.skipped or not r.passed]
    if failed:
        raise AssertionError(f"claims: engine-side claims failed on the card: "
                             f"{failed}")
    launches = {n: counts[n] for n in ("flash_attention", "flash_decode")}
    if min(launches.values()) == 0:
        raise AssertionError(f"claims: a kernel never ran: {launches}")
    volatile = ("wall_s", "sched_time_s")
    again = [s for s in specs
             if s.scenario == "smoke_mini" and s.policy in ("pecsched", "fifo")]
    agree = {}
    for spec in again:
        tokens = {}
        for where in ("cpu", dev):
            summary = ex.run_spec(spec, device=where)
            diff = sorted(k for k in set(summary) | set(results[spec])
                          if k not in volatile
                          and summary.get(k) != results[spec].get(k))
            if diff:
                raise AssertionError(f"claims: {spec.key()} run on {where} "
                                     f"differs from the card's sweep in {diff}")
            backend = runner.engine_stack(spec.model, spec.engine_clock, where)[3]
            tokens[str(where)] = {r: list(t) for r, t in backend.generated.items()}
        cpu, card = tokens["cpu"], tokens[str(dev)]
        if {r: len(t) for r, t in cpu.items()} != {r: len(t) for r, t in card.items()}:
            raise AssertionError(f"claims: {spec.key()} generated other lengths "
                                 "on the CPU and the card")
        agree[spec.policy] = dict(
            requests=len(cpu), tokens=sum(map(len, cpu.values())),
            equal_requests=sum(cpu[r] == card[r] for r in cpu),
            equal_tokens=sum(a == b for r in cpu for a, b in zip(cpu[r], card[r])))
        if agree[spec.policy]["equal_requests"] < GREEDY_AGREEMENT * len(cpu):
            raise AssertionError(f"claims: {spec.key()} greedy tokens on the CPU "
                                 f"and the card: {agree[spec.policy]} (at least "
                                 f"{GREEDY_AGREEMENT} of the requests equal)")
    _say("claims", specs=len(specs),
         requests=sum(s.n_requests for s in specs),
         claims_passed=sum(r.passed for r in cres), claims_total=len(cres),
         wall_s=wall, launches=counts,
         cpu_summaries_equal=[s.policy for s in again],
         cpu_card_greedy=agree, greedy_agreement_min=GREEDY_AGREEMENT)
    return counts


def phase_cluster(torch, dev):
    """launch/serve_cluster.py at the full width and depth of mistral_7b in
    bf16: 2 general engines + 1 decode engine with a 4096-token context,
    the measured clock, the azure_default scenario (24 requests, 16 new
    tokens each; a request's engine prompt is its cluster length over 64,
    so the long runs 3,488 tokens) under pecsched and fifo, arriving at
    CLUSTER_UTILIZATION times the measured short capacity; the prefill
    target is fitted so the long claims both general engines.  Every
    request completes with its target length of in-vocab tokens, and
    pecsched preempts the long's prefill at least once.  Per policy: the
    serving metrics and the kernels' launches; then the measured seconds
    per prefill layer of the long beside the cost model's.  The summary's
    TTFT and TPOT (``sim_`` keys) are not engine times: the policy stamps
    them on the virtual clock with the cost model's price of the trace's
    cluster-scale output lengths (the engines decode at most 16 of them),
    so the engines' own time per output token is
    `decode_ms_per_iteration`."""
    from repro_torch.launch import serve_cluster

    stack = serve_cluster.build(device=dev, max_new=16)
    trace = serve_cluster.make_trace(stack, "azure_default", 24,
                                     utilization=CLUSTER_UTILIZATION)
    reqs = trace["requests"]
    longs = [r for r in reqs if r.is_long]
    totals = dict.fromkeys(_counters(), 0)
    per_policy = {}
    for policy in ("pecsched", "fifo"):
        torch.cuda.reset_peak_memory_stats()
        r, wall, counts = _run_counted(
            torch, lambda: serve_cluster.run_policy(stack, reqs, policy))
        if len(r["done"]) != len(reqs):
            raise AssertionError(f"cluster: {policy} completed {len(r['done'])} "
                                 f"of {len(reqs)} requests")
        for rid, toks in r["generated"].items():
            if len(toks) != r["target_new"][rid]:
                raise AssertionError(f"cluster: {policy} request {rid} generated "
                                     f"{len(toks)} of {r['target_new'][rid]}")
            if not all(0 <= t < stack.cfg.vocab_size for t in toks):
                raise AssertionError(f"cluster: {policy} request {rid} generated "
                                     "a token outside the vocab")
        if min(counts["flash_attention"], counts["flash_decode"]) == 0:
            raise AssertionError(f"cluster: a kernel never ran: {counts}")
        s = r["summary"]
        if policy == "pecsched" and not s["preemptions"] > 0:
            raise AssertionError("cluster: pecsched never preempted the long's "
                                 "prefill")
        per_policy[policy] = dict(
            done=len(r["done"]), short_qd_mean_s=s["short_qd_mean"],
            short_qd_p99_s=s["short_qd_pct"]["99"],
            long_jct_mean_s=s["long_jct_mean"], preemptions=s["preemptions"],
            sim_ttft_mean_s=s["ttft_mean"], sim_ttft_p99_s=s["ttft_pct"]["99"],
            sim_tpot_mean_s=s["tpot_mean"],
            decode_tokens=r["decode_tokens"],
            decode_tokens_per_s=r["decode_tokens"] / r["decode_s"],
            decode_tokens_per_iteration=r["decode_tokens"] / r["decode_iters"],
            decode_ms_per_iteration=1e3 * r["decode_s"] / r["decode_iters"],
            measured_s=r["measured_s"], wall_s=wall, launches=counts,
            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
        for n in totals:
            totals[n] += counts[n]
    cfg = stack.cfg
    _say("cluster", arch="mistral_7b", layers=cfg.num_layers, d_model=cfg.d_model,
         dtype=cfg.dtype, engines="2+1", max_len=stack.backend.max_len,
         clock="measured", scenario="azure_default", requests=len(reqs),
         longs=len(longs), utilization=CLUSTER_UTILIZATION,
         arrival_rps=trace["rps"], max_new=16,
         prefill_target_s=stack.em.target_prefill_s,
         long_claims=[stack.em.replicas_needed(r.input_len) for r in longs],
         engine_prompt_tokens=sorted({stack.backend.prompt_len(r) for r in reqs}),
         policies=per_policy,
         prefill_layer=serve_cluster.layer_seconds(stack, reqs))
    return totals


def phase_overhead(torch, dev):
    """launch/engine_overhead.py at full width (mistral_7b bf16, a long of
    1536 tokens paused halfway for a 16-token short)."""
    from repro_torch.launch import engine_overhead

    out, _, counts = _run_counted(torch, lambda: engine_overhead.run(device=dev))
    _say("overhead", launches=counts, **out)
    return counts


def _profile_steps(torch, step, n):
    """torch.profiler over n calls of step(): wall and device-busy time per
    call, the device's idle share and the kernels taking the most time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel, launched = {}, 0
    for e in prof.key_averages():
        # device-side kernel events only: an operator's own entry repeats
        # the time of the kernels it launched
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + us
            launched += e.count
    busy = sum(per_kernel.values()) / 1e6
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    return dict(iterations=n, wall_ms_per_iter=1e3 * wall / n,
                device_busy_ms_per_iter=(1e3 * busy / n) if busy else "not measured",
                device_idle_share=(1 - busy / wall) if busy else "not measured",
                device_ops_per_iter=launched / n if busy else "not measured",
                top_kernels_ms_per_iter={k[:60]: v / 1e3 / n for k, v in top})


def _counters():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.moe_grouped_gemm import moe_grouped_gemm
    from repro_torch.kernels.ssd_kernel import ssd_scan
    return {"flash_attention": flash_attention, "flash_decode": flash_decode,
            "ssd_scan": ssd_scan, "moe_grouped_gemm": moe_grouped_gemm}


def _run_counted(torch, fn):
    """fn() with every launch count set to 0 just before it and read just
    after; returns (fn's result, wall seconds to the card's end, counts)."""
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {n: c.launches for n, c in counters.items()}


def _expect(phase, what, got, want):
    if got != want:
        raise AssertionError(f"{phase}: {what} launched {got} times, "
                             f"expected {want}")


def _expected_launches(cfg):
    """{kernel: (launches per prefill, per decode step)} on a model's main
    path through the model API: B4 three times in every moe layer (gate,
    up, down)."""
    n, fam = cfg.num_layers, cfg.family
    if fam in ("ssm", "hybrid"):
        attn = n // cfg.attn_every if cfg.attn_every else 0
        return {"ssd_scan": (n, 0), "flash_attention": (attn, 0),
                "flash_decode": (0, attn), "moe_grouped_gemm": (0, 0)}
    if fam == "audio":      # encoder, decoder self and cross attention
        return {"ssd_scan": (0, 0), "flash_attention": (cfg.encoder_layers + 2 * n, 0),
                "flash_decode": (0, 2 * n), "moe_grouped_gemm": (0, 0)}
    b4 = 3 * n if fam == "moe" else 0
    return {"ssd_scan": (0, 0), "flash_attention": (n, 0), "flash_decode": (0, n),
            "moe_grouped_gemm": (b4, b4)}


def _nbytes(tree):
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def phase_model(torch, dev, phase, arch, layers=None, cut=None):
    """A model's main path at full width in bf16 (random weights from seed
    0) through launch/quickstart.py: prefill of 4 sequences of 2048
    positions (vlm: 256 patch embeddings and 1792 tokens; audio: 1024
    encoder frames and a BOS decoder prompt), then 32 greedy decode steps,
    with each kernel's launches checked exactly, and a profile of 4 more
    decode steps and of one more prefill.  `layers` cuts the depth."""
    from repro_torch.configs import get_config
    from repro_torch.launch import quickstart
    from repro_torch.models import decode_step, init_params

    cfg = get_config(arch)
    full_layers = cfg.num_layers
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    B, S, N = 4, 2048, 32
    prompt_len = S - cfg.frontend_tokens if cfg.family == "vlm" else S
    params = init_params(cfg, seed=0, device=dev)
    weights_gb = _nbytes(params) / 1e9
    # warm-up at a short prompt: first-call costs stay out of the timings
    lg, cache = quickstart.start(cfg, params, quickstart.make_batch(
        cfg, B, 64, seed=1, device=dev), 3)
    quickstart.greedy(cfg, params, cache, lg, 3)
    del cache, lg
    batch = quickstart.make_batch(cfg, B, prompt_len, seed=0, device=dev)
    torch.cuda.reset_peak_memory_stats()
    (lg, cache), prefill_s, pre = _run_counted(
        torch, lambda: quickstart.start(cfg, params, batch, N + 8))
    prefill_finite = bool(torch.isfinite(lg).all())
    (toks, finite), decode_s, dec = _run_counted(
        torch, lambda: quickstart.greedy(cfg, params, cache, lg, N + 1))
    if not (prefill_finite and finite):
        raise AssertionError(f"{phase}: a logit is not finite")
    if not all(0 <= int(t.min()) and int(t.max()) < cfg.vocab_size for t in toks):
        raise AssertionError(f"{phase}: a generated token is out of the vocab")
    for name, (per_prefill, per_step) in _expected_launches(cfg).items():
        _expect(phase, f"{name} per prefill", pre[name], per_prefill)
        _expect(phase, f"{name} over {N} decode steps", dec[name], per_step * N)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    PEAK_GB[phase] = peak_gb
    # where a decode step's time goes: 4 more steps under the profiler
    prof = _profile_steps(torch, lambda: decode_step(cfg, params, cache, toks[-1]), 4)
    # and a prefill's: one more under the profiler
    del cache, lg
    pre_prof = _profile_steps(torch, lambda: quickstart.start(cfg, params, batch,
                                                              N + 8), 1)
    extra = dict(layers_full=full_layers, cut=cut) if layers else {}
    _say(phase, arch=arch, family=cfg.family, layers=cfg.num_layers, **extra,
         d_model=cfg.d_model, dtype=cfg.dtype, weights_gb=weights_gb, batch=B,
         prefill_positions=S, prompt_tokens=batch["tokens"].shape[1],
         prefill_s=prefill_s, prefill_positions_per_s=B * S / prefill_s,
         decode_steps=N, decode_ms_per_step=1e3 * decode_s / N,
         decode_tokens_per_s=B * N / decode_s, launches_prefill=pre,
         launches_decode=dec, logits_finite=True, max_memory_allocated_gb=peak_gb,
         decode_step_profile=prof, prefill_profile=pre_prof)
    return {n: pre[n] + dec[n] for n in pre}


#: the invariant's models (f32, full width): (arch, layers kept, why cut)
INVARIANT_MODELS = (
    ("mamba2_130m", 12, "12 of 24 layers"),
    ("zamba2_2_7b", 12, "12 of 54 layers (two hybrid segments)"),
    ("olmoe_1b_7b", None, None),
    ("seamless_m4t_large_v2", None, None),
    ("internvl2_76b", 12, "12 of 80 layers: 3.4 GB each in f32"))


def phase_invariant(torch, dev):
    """The serving invariant on the card, in f32 at full width (depth cut
    where `INVARIANT_MODELS` says): prefill's logits equal the last logits
    of forward (1e-3), and decode_step's after prefill equal forward's over
    the extended sequence (5e-3), the tolerances of tests/test_models.py;
    moe with the dropless capacity factor E, as there.  2 sequences of 300
    tokens (vlm: after 256 patch embeddings; audio: against 1024 frames)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import quickstart
    from repro_torch.models import decode_step, forward, init_params

    errs, cuts = {}, {}
    for arch, layers, cut in INVARIANT_MODELS:
        cfg = dataclasses.replace(get_config(arch), dtype="float32")
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
            cuts[arch] = cut
        params = init_params(cfg, seed=0, device=dev)
        batch = quickstart.make_batch(cfg, 2, 300, seed=2, device=dev)
        batch["tokens"] = quickstart.make_prompt(cfg, 2, 300, seed=2, device=dev)
        cf = float(cfg.num_experts) if cfg.family == "moe" else None
        logits, _ = forward(cfg, params, batch, moe_cf=cf)
        lg, cache = quickstart.start(cfg, params, batch, 1)
        tok = lg.argmax(-1)
        lg2, _ = decode_step(cfg, params, cache, tok)
        full, _ = forward(cfg, params, dict(
            batch, tokens=torch.cat([batch["tokens"], tok[:, None]], 1)), moe_cf=cf)
        for what, got, want, tol in (("prefill", lg, logits[:, -1], 1e-3),
                                     ("decode", lg2, full[:, -1], 5e-3)):
            err = (got - want).abs().max().item()
            if not torch.allclose(got, want, atol=tol, rtol=tol):
                raise AssertionError(f"invariant: {arch} {what} logits differ "
                                     f"from forward by {err} (tol {tol})")
            errs[f"{arch}_{what}_max_abs_err"] = err
        del params, cache, logits, full
        torch.cuda.empty_cache()
    _say("invariant", dtype="float32", batch=2, prompt_len=300, depth_cut=cuts,
         tol_prefill=1e-3, tol_decode=5e-3, **errs)


def _tree_to(tree, dev):
    """A copy of the tree on `dev` (a copy on the CPU too: the train step
    updates its params in place)."""
    from repro_torch.models.model import param_leaves, tree_like
    return tree_like(tree, [t.to(dev, copy=True) for t in param_leaves(tree)])


def _params_close(got, want, lr=3e-4):
    """(max |got - want|, elements off): params after one AdamW step from
    equal weights, held to rtol = atol = TRAIN_TOL but for at most 1e-4 of
    a leaf's elements (one at least), each within 2 x lr: where a
    gradient is ~0, its rounding on either device decides the sign of
    m̂ / sqrt(v̂) ~ ±1, and so an update of ±lr.  Compared on `got`'s
    device (the host's elementwise passes over GBs of f32 params took most
    of each partitioned f32 train case's minute on the card's machine)."""
    import torch
    from repro_torch.models.model import param_leaves
    worst, off_total = 0.0, 0
    for g, w in zip(param_leaves(got), param_leaves(want)):
        g = g.detach().float()
        w = w.detach().to(g.device).float()
        diff = (g - w).abs()
        off = int((~torch.isclose(g, w, rtol=TRAIN_TOL, atol=TRAIN_TOL)).sum())
        if off > max(1, w.numel() // 10_000) or float(diff.max()) > 2 * lr:
            raise AssertionError(f"train: {off} of {w.numel()} params off by up "
                                 f"to {float(diff.max())}")
        worst, off_total = max(worst, float(diff.max())), off_total + off
    return worst, off_total


#: card against CPU: one reduced f32 train step (TF32 off on the card)
TRAIN_TOL = 1e-4
TRAIN_FAMILIES = ("qwen2_7b", "olmoe_1b_7b", "mamba2_130m", "zamba2_2_7b",
                  "seamless_m4t_large_v2", "internvl2_76b")


def phase_train(torch, dev):
    """launch/train.py --full at the full width and depth of mistral_7b in
    bf16 (32 layers; out of memory fails the phase), batch 1 x 2048 tokens,
    remat, 5 AdamW steps on one repeated batch: every loss
    and grad_norm finite, the last loss below the first, and no hand
    kernel launched (the train step runs the plain attention, as the
    reference trains with "xla").  Seconds per step (median of steps 2-5),
    tokens/s, peak memory and mfu (launch/train.py's `step_flops` over the
    step time and 989e12).  Then: ops.* with impl="auto" on CUDA inputs
    under autograd raise; and one build_train_step step of a reduced f32
    config of each family equals the same step on the CPU (loss, grad_norm
    and params to TRAIN_TOL; `_params_close`)."""
    import numpy as np

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps, train
    from repro_torch.models import init_params
    from repro_torch.training import adamw_init

    t_phase = time.perf_counter()
    argv = ["--arch", "mistral_7b", "--full", "--batch", "1", "--seq", "2048",
            "--steps", "5", "--same-batch", "--device", str(dev)]
    out, _, counts = _run_counted(torch, lambda: train.main(argv))
    if out["layers"] != get_config("mistral_7b").num_layers:
        raise AssertionError(f"train: ran {out['layers']} layers, not the full depth")
    losses, norms = out["losses"], out["grad_norms"]
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"train: a loss or grad_norm is not finite: {out}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    if any(counts.values()):
        raise AssertionError(f"train: a hand kernel ran in a train step: {counts}")
    PEAK_GB["train"] = out["peak_gb"]
    # where a step's time goes: one more step under the profiler
    cfg = dataclasses.replace(get_config("mistral_7b"), num_layers=out["layers"])
    step = steps.build_train_step(cfg)
    batch = train.make_batch(cfg, 1, 2048, np.random.default_rng(0), dev)
    state = {"params": out.pop("params_tree"), "opt": out.pop("opt")}

    def one_step():
        state["params"], state["opt"], _ = step(state["params"], state["opt"], batch)
    prof = _profile_steps(torch, one_step, 1)
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()

    # the hand kernels refuse autograd on the card as on the CPU
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((1, 4, 64, 64), generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    x = torch.randn((1, 64, 2, 64), generator=g, device=dev, dtype=torch.bfloat16)
    bc = torch.randn((1, 64, 16), generator=g, device=dev, dtype=torch.bfloat16)
    dt = torch.rand((1, 64, 2), generator=g, device=dev)
    a, d = -torch.rand(2, generator=g, device=dev), torch.ones(2, device=dev)
    refused = []
    for name, fn, wrt in (
            ("attention", lambda: ops.attention(q, k, v), (q,)),
            ("decode_attention", lambda: ops.decode_attention(
                q[:, :, 0], k, v, torch.full((1,), 64, device=dev)), (k,)),
            ("ssd_scan", lambda: ops.ssd_scan(x, dt, a, bc, bc, d), (x,))):
        for t in wrt:
            t.requires_grad_(True)
        try:
            fn()
        except RuntimeError as e:
            if 'impl="torch"' not in str(e):
                raise
            refused.append(name)
        for t in wrt:
            t.requires_grad_(False)
    if len(refused) != 3:
        raise AssertionError(f"train: impl='auto' ran under autograd: {refused}")

    # one reduced f32 step per family, the card against the CPU
    parity = {}
    for arch in TRAIN_FAMILIES:
        cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype="float32")
        cpu_params = init_params(cfg, seed=0, device="cpu")
        batch = train.make_batch(cfg, 2, 16, np.random.default_rng(1), "cpu")
        res = {}
        for where in ("cpu", dev):
            p = _tree_to(cpu_params, where)
            step = steps.build_train_step(cfg)
            p, _, info = step(p, adamw_init(p), _tree_to(batch, where))
            res[str(where)] = (p, float(info["loss"]), float(info["grad_norm"]))
        (p_cpu, loss_cpu, norm_cpu), (p_card, loss_card, norm_card) = (
            res["cpu"], res[str(dev)])
        for what, c_, g_ in (("loss", loss_cpu, loss_card),
                             ("grad_norm", norm_cpu, norm_card)):
            if not abs(g_ - c_) <= TRAIN_TOL * abs(c_):
                raise AssertionError(f"train: {arch} {what} card {g_} cpu {c_}")
        worst, off = _params_close(p_card, p_cpu)
        parity[arch] = dict(loss=loss_card,
                            loss_rel_err=abs(loss_card - loss_cpu) / abs(loss_cpu),
                            grad_norm_rel_err=abs(norm_card - norm_cpu) / abs(norm_cpu),
                            params_max_abs_err=worst, params_outside_tol=off)
    out.pop("losses")
    _say("train", **out, losses=losses, launches=counts, step_profile=prof, autograd_refused=refused,
         card_vs_cpu=parity, tol=TRAIN_TOL,
         phase_s=time.perf_counter() - t_phase)


def phase_train_lm(torch, dev):
    """launch/train_lm.py at its full size (~100M parameters, f32, 200
    steps of batch 8 x 256 synthetic tokens): the loss falls by at least
    0.3 (the script's own assertion) and the checkpoint reloads equal."""
    from repro_torch.launch import train_lm

    t0 = time.perf_counter()
    out, _, counts = _run_counted(torch, lambda: train_lm.main(["--device", str(dev)]))
    if not (out["loss_drop"] >= train_lm.MIN_DROP and out["checkpoint_equal"]):
        raise AssertionError(f"train_lm: {out}")
    if any(counts.values()):
        raise AssertionError(f"train_lm: a hand kernel ran in a train step: {counts}")
    _say("train_lm", **out, steps_per_s=out["steps"] / out["wall_s"],
         tokens_per_s=out["steps"] * out["batch"] * out["seq"] / out["wall_s"],
         launches=counts, phase_s=time.perf_counter() - t0)


#: ring: the f32 invariant's depth (the bf16 run keeps all 32 layers)
RING_F32_LAYERS = 4


def phase_ring(torch, dev):
    """The serve step of llama3_8b (8192-token window) at long_500k: full
    width and depth in bf16, a prefill of RING_PROMPT tokens into a ring of
    8192 (B1 once per layer) and 32 greedy ring decode steps (B2 once per
    layer per step), the launches checked exactly, finite logits, in-vocab
    tokens.  Then the ring in f32 at RING_F32_LAYERS layers through the
    kernels (B1 f32 in the prefill, B2 f32 over the ring): the prefill's
    last logits equal a windowed forward's on the plain attention
    (impl="torch", 1e-3) and 4 ring decode steps' equal that forward's over
    the extended sequence (5e-3), the `invariant` phase's limits.  The bf16
    B1 and B2 calls at this shape are held against their plain versions in
    the kernel table (fa_ring_llama3_w8192_12288, fd_ring_llama3_b1_s8192_full)."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch import steps
    from repro_torch.models import forward, init_cache, init_params

    t_phase = time.perf_counter()
    shape = INPUT_SHAPES["long_500k"]
    cfg = get_config("llama3_8b")
    max_len, _ = steps.cache_lengths(cfg, shape)
    if not (steps.ring_buffer(cfg, shape) and max_len == cfg.sliding_window):
        raise AssertionError(f"ring: long_500k does not ring llama3_8b ({max_len})")
    prefill_step = steps.build_prefill_step(cfg, shape)
    serve_step = steps.build_serve_step(cfg, shape)
    toks = torch.randint(0, cfg.vocab_size, (1, RING_PROMPT),
                         generator=torch.Generator().manual_seed(4)).to(dev)
    params = init_params(cfg, seed=0, device=dev)
    cache = init_cache(cfg, 1, max_len, device=dev)
    torch.cuda.reset_peak_memory_stats()
    (lg, cache), prefill_s, pre = _run_counted(
        torch, lambda: prefill_step(params, {"tokens": toks}, cache))
    N = 32

    def decode():
        out, finite, last = [], True, lg
        for _ in range(N):
            out.append(last.argmax(-1))
            last, _ = serve_step(params, cache, out[-1])
            finite &= bool(torch.isfinite(last).all())
        return out, finite
    (gen, finite), decode_s, dec = _run_counted(torch, decode)
    if not (finite and bool(torch.isfinite(lg).all())):
        raise AssertionError("ring: a logit is not finite")
    if not all(0 <= int(t) < cfg.vocab_size for t in gen):
        raise AssertionError("ring: a generated token is out of the vocab")
    for name, (per_prefill, per_step) in _expected_launches(cfg).items():
        _expect("ring", f"{name} per prefill", pre[name], per_prefill)
        _expect("ring", f"{name} over {N} ring decode steps", dec[name], per_step * N)
    if int(cache["len"][0]) != RING_PROMPT + N:
        raise AssertionError(f"ring: cache length {cache['len'].tolist()}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    PEAK_GB["ring"] = peak_gb
    del params, cache, lg
    torch.cuda.empty_cache()

    # f32 at a cut depth: the ring against a windowed forward
    cfg32 = dataclasses.replace(cfg, dtype="float32", num_layers=RING_F32_LAYERS)
    params = init_params(cfg32, seed=0, device=dev)
    prefill_step = steps.build_prefill_step(cfg32, shape)
    serve_step = steps.build_serve_step(cfg32, shape)
    lg, cache = prefill_step(params, {"tokens": toks},
                             init_cache(cfg32, 1, max_len, device=dev))
    first, seq, outs = lg, toks, []
    for _ in range(4):
        seq = torch.cat([seq, lg.argmax(-1)[:, None]], 1)
        lg, cache = serve_step(params, cache, seq[:, -1])
        outs.append(lg)
    with torch.no_grad():
        full, _ = forward(cfg32, params, {"tokens": seq}, impl="torch")
    errs = {}
    for what, got, want, tol in (
            ("prefill", first, full[:, RING_PROMPT - 1], 1e-3),
            ("decode", torch.stack(outs, 1), full[:, RING_PROMPT:], 5e-3)):
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, atol=tol, rtol=tol):
            raise AssertionError(f"ring: f32 {what} logits differ from a windowed "
                                 f"plain forward by {err} (tol {tol})")
        errs[f"f32_{what}_max_abs_err"] = err
    del params, cache, full
    torch.cuda.empty_cache()
    _say("ring", arch="llama3_8b", layers=cfg.num_layers, d_model=cfg.d_model,
         dtype=cfg.dtype, shape="long_500k", window=cfg.sliding_window,
         ring_len=max_len, prompt_tokens=RING_PROMPT, prefill_s=prefill_s,
         prefill_tokens_per_s=RING_PROMPT / prefill_s, decode_steps=N,
         decode_ms_per_step=1e3 * decode_s / N, launches_prefill=pre,
         launches_decode=dec, logits_finite=True, max_memory_allocated_gb=peak_gb,
         f32_layers=RING_F32_LAYERS, f32_decode_steps=4, tol_prefill=1e-3,
         tol_decode=5e-3, **errs, phase_s=time.perf_counter() - t_phase)
    return {n: pre[n] + dec[n] for n in pre}


def _gang_trace(n_shorts=12, long_output=6, gap=2e-3):
    """tests/multidevice/test_gang_sp.py's gang trace: a 300K-token long at
    0 and `n_shorts` shorts every `gap` seconds behind it."""
    import numpy as np

    from repro_torch.core.request import Request
    reqs = [Request(rid=0, arrival=0.0, input_len=300_000,
                    output_len=long_output, is_long=True)]
    rng = np.random.default_rng(4)
    for i in range(1, n_shorts + 1):
        reqs.append(Request(rid=i, arrival=round(i * gap, 6),
                            input_len=int(rng.integers(300, 3000)),
                            output_len=int(rng.integers(2, 8))))
    return reqs


def _gang_tokens(req):
    """That test's engine prompts: 224 tokens for the long, 16 a short."""
    import numpy as np
    rng = np.random.default_rng(req.rid + 11)
    return rng.integers(0, 1000, 224 if req.is_long else 16).astype(np.int32)


def _engine_prefill(torch, eng, toks):
    """(logits, k, v) of a single-replica prefill of `toks` (S,)."""
    st = eng.start_prefill(0, torch.as_tensor(toks[None], dtype=torch.long))
    done = False
    while not done:
        st, done = eng.prefill_quantum(st)
    return (eng.prefill_logits(st), *st.full_kv())


def _gang_run(runner, toks, layers, device):
    """(logits, k, v) of a gang prefill of `toks` in quanta of `layers`
    layers, the KV joined on `device`."""
    from repro_torch.sp import SPPlan
    plan = SPPlan({"a2a": "ulysses", "allgather": "megatron"}[runner.strategy],
                  "ulysses", 0.0)
    st = runner.start(0, toks, plan)
    done = False
    while not done:
        st, done = runner.quantum(st, layers)
    return (runner.logits(st), *runner.gather_kv(st, device))


def _gang_errs(got, want):
    """{"logits": max |error|, "kv": max |error| over K and V}."""
    return {"logits": (got[0].float().cpu() - want[0].float().cpu()).abs().max().item(),
            "kv": max((a.float().cpu() - b.float().cpu()).abs().max().item()
                      for a, b in zip(got[1:], want[1:]))}


def phase_gang(torch, dev):
    """Gang sequence-parallel prefill (paper §5.3) on a single-controller
    mesh whose ranks share the card:

    1. B1 at the ring's hop shapes (a GANG_PROMPT prompt over a (2, 2)
       mesh: q (1, 16, GANG_SEG, 128), k/v (1, 4, GANG_SEG, 128)) with its
       LSE, against the plain version (`checks.attention_check`): the
       diagonal, the hop that sees every key (q_offset +GANG_SEG) and the
       fully masked one (-GANG_SEG), which must give exactly 0 and -inf;
       the kernel table times the first two;
    2. full-width mistral_7b in bf16 (32 layers), a GANG_PROMPT prompt, a
       gang of GANG_DEGREE on [card] * 4 with each inner strategy, against
       the single-replica `ReplicaEngine` prefill: the same first token,
       logits and every (layer, KV head)'s KV within GANG_REL_TOL in
       relative norm, B1 launched layers x ranks x hops times per gang
       prefill; the wall times of both (the ranks share one card: the gang
       is not expected to be faster) and a profile of one more of each
       (device busy time, idle share, operations);
    3. `EngineBackend` at full width on the measured clock, pecsched, 2
       general + 1 decode engine, sp_devices=[card] * 2, the gang trace of
       tests/multidevice/test_gang_sp.py: the long is gang-prefilled and
       scattered in ceil(32 / (2 x lpq)) quanta, and preempted by 16
       shorts it generates exactly its quiet run's tokens; sp_per_layer_s;
    4. f32 on the reference test's model and prompt (mistral_7b reduced to
       GANG_F32_LAYERS layers, GANG_F32_PROMPT tokens): the gang (both
       strategies) against the single replica on the card and the gang on
       the card against the gang on the CPU, to GANG_F32_TOL; the ring's
       last hop dropped must read above those limits;
    5. distributed decode over 4 ranks of a 4 x GANG_PROMPT cache: bf16
       against B2 over the whole cache (2e-2), f32 against the plain
       decode (2e-5), with and without a window.
    Returns the launches of the main path (parts 2 and 3)."""
    import numpy as np

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core import ClusterConfig, ExecutionModel, Simulator, make_policy
    from repro_torch.hardware import H100_SXM
    from repro_torch.kernels.checks import F32_TOL, attention_check, rel_err
    from repro_torch.kernels.checks import TOL as BF16_TOL
    from repro_torch.kernels.flash_decode import flash_decode, torch_decode
    from repro_torch.models import init_params
    from repro_torch.serving.backend import EngineBackend
    from repro_torch.serving.engine import ReplicaEngine
    from repro_torch.sp import (GangMesh, GangSPRunner, distributed_decode_attention,
                                make_gang_mesh)
    from repro_torch.sp import ring as sp_ring

    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(18)

    def rn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    # 1. B1 at the hop shapes, output and LSE
    q, k, v = rn(1, 16, GANG_SEG, 128), rn(1, 4, GANG_SEG, 128), rn(1, 4, GANG_SEG, 128)
    hops = [attention_check(f"gang_hop_{name}", q, k, v, causal=True, q_offset=qo)
            for name, qo in (("diagonal", 0), ("visible", GANG_SEG),
                             ("masked", -GANG_SEG))]
    if hops[2]["empty_rows"] != q.shape[1] * q.shape[2]:
        raise AssertionError(f"gang: the masked hop left {hops[2]['empty_rows']} "
                             "empty rows, not all")
    del q, k, v

    # 2. full width bf16: the gang against the single replica
    cfg = get_config("mistral_7b")
    params = init_params(cfg, seed=0, device=dev)
    toks = np.random.default_rng(18).integers(0, cfg.vocab_size,
                                              GANG_PROMPT).astype(np.int32)
    eng = ReplicaEngine(cfg, params, max_slots=1, max_len=GANG_PROMPT,
                        layers_per_quantum=2, device=dev)
    _engine_prefill(torch, eng, toks)                      # first-call costs
    want, single_s, single_counts = _run_counted(
        torch, lambda: _engine_prefill(torch, eng, toks))
    single_prof = _profile_steps(torch, lambda: _engine_prefill(torch, eng, toks), 1)
    del eng
    first = int(want[0][0].argmax())
    totals = dict.fromkeys(_counters(), 0)
    full = {}
    for strategy in ("a2a", "allgather"):
        mesh = make_gang_mesh(GANG_DEGREE, cfg.num_heads, [dev] * GANG_DEGREE)
        runner = GangSPRunner(cfg, params, mesh, strategy)
        quantum = 2 * GANG_DEGREE                  # lpq 2 x degree, as the backend
        _gang_run(runner, toks, quantum, dev)
        got, gang_s, counts = _run_counted(
            torch, lambda: _gang_run(runner, toks, quantum, dev))
        _expect("gang", f"flash_attention per {strategy} gang prefill",
                counts["flash_attention"],
                cfg.num_layers * GANG_DEGREE * mesh.shape["ring"])
        rel = {"logits": rel_err(got[0][None], want[0][None].float()),
               "kv": max(rel_err(a, b.float()) for a, b in zip(got[1:], want[1:]))}
        token = int(got[0][0].argmax())
        if token != first:
            raise AssertionError(f"gang: {strategy} chose token {token}, the "
                                 f"single replica {first}")
        if not max(rel.values()) < GANG_REL_TOL:
            raise AssertionError(f"gang: {strategy} against the single replica "
                                 f"{rel} (limit {GANG_REL_TOL})")
        for n in totals:
            totals[n] += counts[n]
        full[strategy] = dict(rel_err=rel, first_token=token, gang_wall_s=gang_s,
                              launches=counts, profile=_profile_steps(
                                  torch, lambda: _gang_run(runner, toks, quantum, dev),
                                  1))
        del runner, got
    del want

    # 3. through the scheduler: a preempted gang long gives its quiet tokens
    lpq = 2
    cc = ClusterConfig(n_nodes=1, gpus_per_node=3, tp=1, hw=H100_SXM,
                       n_short_decode_replicas=1, max_decode_concurrency=8)
    em = ExecutionModel(cfg, cc.replica_spec(), target_prefill_s=0.05)
    be = EngineBackend(cfg, params, max_len=256, layers_per_quantum=lpq,
                       clock="measured", token_provider=_gang_tokens, device=dev,
                       sp_devices=[dev] * 2)
    be.warmup([16, 224], [0, 1, 2])
    be.warmup_gang([224], [2])

    def serve(trace):
        be.reset()
        s = Simulator(make_policy("pecsched", cc, em), backend=be).run(trace)
        if be.stats["gang_prefills"] != 1 or be.stats["gang_scatters"] < 1:
            raise AssertionError(f"gang: the long was not gang-prefilled and "
                                 f"scattered: {dict(be.stats)}")
        if be.stats["sp_prefill_quanta"] != -(-cfg.num_layers // (2 * lpq)):
            raise AssertionError(f"gang: {be.stats['sp_prefill_quanta']} gang quanta "
                                 f"for {cfg.num_layers} layers at {2 * lpq} a quantum")
        if s["long_completed"] != 1 or s["short_completed"] != len(trace) - 1:
            raise AssertionError(f"gang: the trace did not complete: {s}")
        return s, list(be.generated[0]), dict(be.stats)
    quiet, quiet_tokens, _ = serve(_gang_trace(n_shorts=0))
    (busy, busy_tokens, stats), busy_s, counts = _run_counted(
        torch, lambda: serve(_gang_trace(n_shorts=16, gap=1e-4)))
    if not busy["preemptions"] > 0:
        raise AssertionError("gang: short pressure never preempted the gang")
    if busy_tokens != quiet_tokens:
        raise AssertionError(f"gang: the preempted long generated {busy_tokens}, "
                             f"unpreempted {quiet_tokens}")
    for n in totals:
        totals[n] += counts[n]
    sched = dict(preemptions=busy["preemptions"], tokens=busy_tokens,
                 gang_prefills=stats["gang_prefills"],
                 gang_scatters=stats["gang_scatters"],
                 sp_prefill_quanta=stats["sp_prefill_quanta"],
                 long_jct_s=busy["long_jct_mean"], wall_s=busy_s,
                 sp_per_layer_s=be.sp_per_layer_s(), launches=counts)
    del be, params
    gc.collect()
    torch.cuda.empty_cache()

    # 4. f32 on the reference test's model: its limits, card = CPU, a fault
    cfg32 = dataclasses.replace(reduced_config(cfg, layers=GANG_F32_LAYERS),
                                dtype="float32", sliding_window=0)
    p32 = init_params(cfg32, seed=0, device=dev)
    toks32 = np.random.default_rng(1).integers(0, cfg32.vocab_size,
                                               GANG_F32_PROMPT).astype(np.int32)
    eng = ReplicaEngine(cfg32, p32, max_slots=1, max_len=GANG_F32_PROMPT,
                        layers_per_quantum=2, device=dev)
    want = _engine_prefill(torch, eng, toks32)
    del eng
    mesh = make_gang_mesh(GANG_DEGREE, cfg32.num_heads, [dev] * GANG_DEGREE)

    def within(what, errs):
        if any(errs[n] > GANG_F32_TOL[n] for n in errs):
            raise AssertionError(f"gang: f32 {what} {errs} (limits {GANG_F32_TOL})")
        return errs
    f32 = {}
    card = {}
    for strategy in ("a2a", "allgather"):
        card[strategy] = _gang_run(GangSPRunner(cfg32, p32, mesh, strategy), toks32,
                                   2 * GANG_DEGREE, dev)
        f32[f"{strategy}_vs_single"] = within(strategy, _gang_errs(card[strategy],
                                                                  want))
    cpu = _gang_run(GangSPRunner(cfg32, _tree_to(p32, "cpu"),
                                 make_gang_mesh(GANG_DEGREE, cfg32.num_heads,
                                                ["cpu"] * GANG_DEGREE), "a2a"),
                    toks32, 2 * GANG_DEGREE, "cpu")
    f32["card_vs_cpu"] = within("card against the CPU", _gang_errs(card["a2a"], cpu))
    # the planted fault: every rank's last ring hop left out of its merge (the
    # ring merges hop by hop, each over every rank in rank order)
    real, calls, n_hops = sp_ring.merge_partials, [0], mesh.shape["ring"]

    def last_hop_dropped(o1, l1, o2, l2):
        hop = calls[0] // GANG_DEGREE % n_hops
        calls[0] += 1
        return (o1, l1) if hop == n_hops - 1 else real(o1, l1, o2, l2)
    sp_ring.merge_partials = last_hop_dropped
    try:
        fault = _gang_errs(_gang_run(GangSPRunner(cfg32, p32, mesh, "a2a"), toks32,
                                     2 * GANG_DEGREE, dev), want)
    finally:
        sp_ring.merge_partials = real
    if not all(fault[n] > GANG_F32_TOL[n] for n in fault):
        raise AssertionError(f"gang: the ring's last hop dropped reads {fault}, "
                             f"inside the limits {GANG_F32_TOL}")
    del p32, card, cpu, want
    torch.cuda.empty_cache()

    # 5. distributed decode over 4 ranks of a 4 x GANG_PROMPT cache
    B, H, KV, S, D = 4, cfg.num_heads, cfg.num_kv_heads, GANG_PROMPT, cfg.head_dim
    q, k, v = rn(B, H, D), rn(B, KV, S, D), rn(B, KV, S, D)
    cl = torch.tensor([S, S - S // 8, S // 2 + 1, 123], dtype=torch.int32, device=dev)
    mesh = GangMesh([dev] * 4, (4,), ("data",))
    decode = {}
    for name, dt, tol, plain in (("bf16_vs_b2", torch.bfloat16, BF16_TOL, flash_decode),
                                 ("f32_vs_plain", torch.float32, F32_TOL, torch_decode)):
        for win in (0, S // 2):
            args = [t.to(dt) for t in (q, k, v)] + [cl]
            got = distributed_decode_attention(*args, mesh=mesh, seq_axes=("data",),
                                               sliding_window=win).float()
            ref = plain(*args, sliding_window=win).float()
            err = (got - ref).abs().max().item()
            if not torch.allclose(got, ref, atol=tol, rtol=tol):
                raise AssertionError(f"gang: distributed decode {name} window {win}:"
                                     f" max |error| {err} (tol {tol})")
            decode[f"{name}_w{win}"] = err
    _say("gang", arch="mistral_7b", layers=cfg.num_layers, d_model=cfg.d_model,
         dtype=cfg.dtype, prompt_tokens=GANG_PROMPT, degree=GANG_DEGREE,
         mesh={"ring": GANG_DEGREE // 2, "sp": 2}, ranks_on="one card",
         hops=hops, single_replica_wall_s=single_s, single_launches=single_counts,
         single_replica_profile=single_prof,
         first_token=first, rel_tol=GANG_REL_TOL, strategies=full,
         scheduler=sched, f32_model=dict(layers=GANG_F32_LAYERS,
                                         d_model=cfg32.d_model),
         f32_prompt=GANG_F32_PROMPT,
         f32_tol=GANG_F32_TOL, f32_max_abs_err=f32, f32_fault_last_hop_dropped=fault,
         decode_ranks=4, decode_cache=[B, S], decode_max_abs_err=decode,
         decode_tol={"bf16": BF16_TOL, "f32": F32_TOL},
         phase_s=time.perf_counter() - t_phase)
    return totals


def _account_holds(torch, dev):
    """run_combo on a one-card host mesh for the runs the train, vlm and
    ring phases measured: each per_device_total within ACCOUNT_TOL of the
    phase's peak; the train account without its optimizer moments outside
    it; internvl2_76b at all 80 layers not fitting."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    host = make_host_mesh(1, devices=[dev])
    vlm_shape = ShapeConfig("vlm_4x2048", 2048, 4, "prefill")
    cases = {   # name: (arch, shape, layers) as the phase ran it
        "train": ("mistral_7b", ShapeConfig("train_1x2048", 2048, 1, "train"), None),
        "vlm": ("internvl2_76b", vlm_shape, 24),
        "ring": ("llama3_8b", dataclasses.replace(INPUT_SHAPES["long_500k"],
                                                  seq_len=RING_PROMPT, kind="prefill"), None)}
    holds = {}
    for name, (arch, shape, layers) in cases.items():
        rec = dryrun.run_combo(arch, shape, layers=layers, mesh=host)
        mem = rec["memory"]
        ratio = mem["per_device_total"] / 1e9 / PEAK_GB[name]
        if abs(ratio - 1) > ACCOUNT_TOL:
            raise AssertionError(f"dryrun: the {name} account {mem['per_device_total'] / 1e9:.2f} "
                                 f"GB is {ratio:.3f} x the measured {PEAK_GB[name]:.2f} GB")
        holds[name] = dict(arch=arch, layers=rec["layers"], kind=rec["kind"],
                           account_gb=mem["per_device_total"] / 1e9,
                           arguments_gb={k: v / 1e9 for k, v in mem["arguments"].items()},
                           temp_gb=mem["temp_size_in_bytes"] / 1e9,
                           measured_gb=PEAK_GB[name], ratio=ratio,
                           account_s=rec["account"]["seconds"])
        if name == "train":     # planted fault: the optimizer moments left out
            fault = (mem["per_device_total"] - mem["arguments"]["opt"]) / 1e9 / PEAK_GB[name]
            if abs(fault - 1) <= ACCOUNT_TOL:
                raise AssertionError(f"dryrun: the train account without its moments "
                                     f"reads {fault:.3f}, inside the limit")
            holds[name]["without_moments_ratio"] = fault
    full = dryrun.run_combo("internvl2_76b", vlm_shape, mesh=host)
    if full["memory"]["fits"]:
        raise AssertionError("dryrun: internvl2_76b at 80 layers fits one card")
    holds["vlm_80_layers"] = dict(
        layers=full["layers"], fits=False,
        weights_gb=full["memory"]["arguments"]["params"] / 1e9,
        account_gb=full["memory"]["per_device_total"] / 1e9)
    return holds


@contextlib.contextmanager
def _uncounted(obj, name):
    """Within: ``obj.<name>`` runs outside the dry run's account (its
    storages, FLOPs and bytes never count): a planted fault of the
    per-device account."""
    from torch.utils._python_dispatch import _disable_current_modes
    fn = getattr(obj, name)

    def uncounted(*a, **kw):
        with _disable_current_modes():
            return fn(*a, **kw)
    setattr(obj, name, uncounted)
    try:
        yield
    finally:
        setattr(obj, name, fn)


def _held_account(arch, shape, layers, mesh, rise_gb, faults=None, max_len=None):
    """The dry run's per-device account of the partitioned step of `shape`
    (`dryrun.run_combo` of `arch` at `layers` on `mesh`, a host mesh whose
    ranks share the card; with `max_len`, the prefill into that cache,
    `dryrun.rank_account`): its temp and new outputs times the ranks,
    against `rise_gb`, the card's rise in memory over one such step (the
    ranks' shards are views, so the rise is every rank's temporaries and
    new outputs), and the whole step's peak (the old estimate, whole / n x
    n) beside it.  `faults` ({name: (object, attribute)}), where given,
    are planted faults, each the account with that function left out
    (`_uncounted`); the account must then read within ACCOUNT_TOL and the
    last fault outside it.  Returns the readings, each as a ratio to the
    rise."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    n = mesh.n_ranks
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)

    parts = []

    def account(n_parts=0):
        if max_len is not None:
            acct = dryrun.rank_account(cfg, shape, mesh, max_len=max_len, parts=n_parts)
            parts[:] = acct.get("parts", [])
            return n * (acct["temp"] + acct["new_out"]) / 1e9
        mem = dryrun.run_combo(arch, shape, layers=layers, mesh=mesh, parts=n_parts)["memory"]
        parts[:] = [(p["bytes"], p["what"], p["count"]) for p in mem.get("temp_parts", [])]
        return n * (mem["temp_size_in_bytes"] + mem["output_size_in_bytes"]
                    - mem["alias_size_in_bytes"]) / 1e9
    t0 = time.perf_counter()
    got = account(4)
    whole = dryrun.step_account(cfg, shape)
    old = (whole["temp"] + whole["new_out"]) / 1e9
    row = dict(card_rise_gb=rise_gb, account_gb=got, ratio=got / rise_gb,
               old_estimate_gb=old, old_estimate_ratio=old / rise_gb,
               # the largest groups of storages live at rank 0's peak
               rank0_peak_parts=[f"{c} x {what}: {b / 1e9:.4f} GB" for b, what, c in parts])
    if not faults:
        return dict(row, account_s=time.perf_counter() - t0)
    row["faults"] = {}
    for name, (obj, attr) in faults.items():
        with _uncounted(obj, attr):
            row["faults"][name] = account() / rise_gb
    row["fault_held"] = name
    row["account_s"] = time.perf_counter() - t0
    if abs(row["ratio"] - 1) > ACCOUNT_TOL:
        raise AssertionError(f"the per-device account of {arch} {shape.name} on {dict(mesh.shape)}"
                             f" reads {row['ratio']:.3f} of the card's rise (readings: {row})")
    if abs(row["faults"][name] - 1) <= ACCOUNT_TOL:
        raise AssertionError(f"the account of {arch} {shape.name} on {dict(mesh.shape)} with "
                             f"{name} left out reads {row['faults'][name]:.3f}, inside the limit")
    return row


def _train_faults():
    """The planted faults of the train step's account: rank 0's
    FSDP-gathered weights left out (at PT_LAYERS the step peaks in the
    optimizer's update of the head, where no gathered weight is alive, so
    it reads inside the limit, reported), then the forward and backward
    (`partition.loss_and_grads`: the gradients) left out, held."""
    from repro_torch.launch import partition
    from repro_torch.models import tp
    return {"gathered_weights": (tp, "_weight"), "gradients": (partition, "loss_and_grads")}


def _serve_faults():
    """The planted faults of the serve step's account: the gathered weights
    left out (no FSDP in the serve step: reported), then the decode's f32
    partials over the rank's slice of the cache (`tp.distributed_decode_local`)
    left out, held."""
    from repro_torch.models import tp
    return {"gathered_weights": (tp, "_weight"),
            "decode_partials": (tp, "distributed_decode_local")}


def _rel_norms(got, want, vocab=None):
    """Per step, the largest ||got - want|| / ||want|| over the batch's rows,
    over the first `vocab` logits (the padded vocabulary's -1e30 would
    swamp any difference)."""
    from repro_torch.kernels.checks import rel_err
    return [rel_err(g[None, :, :vocab], w[None, :, :vocab].float())
            for (_, g), (_, w) in zip(got, want)]


def _same_tokens(got, want):
    """(steps whose greedy tokens all agree, rows that agree)."""
    eq = [g.argmax(-1) == w.argmax(-1) for (_, g), (_, w) in zip(got, want)]
    return sum(int(e.all()) for e in eq), sum(int(e.sum()) for e in eq)


def _dropping_last_rank(mesh):
    """`mesh` with a psum that leaves out the last rank's addend: the
    sequence-sharded decode's merge then loses that rank's partial (its
    keys' share of both the weighted sum and the normaliser)."""
    import torch
    from repro_torch.sp.common import GangMesh

    class Dropping(GangMesh):
        def psum(self, xs, axes):
            return super().psum(xs[:-1] + [torch.zeros_like(xs[-1])], axes)
    return Dropping(mesh.devices, tuple(mesh.shape.values()), mesh.axis_names)


def _sharded_decode(torch, dev, arch, shape, prompt, model_ranks, dtype):
    """Prefill `prompt` tokens at full width in `dtype`, then N serve steps
    from copies of that cache: without rules (B2), the greedy run; with the
    sequence-sharded cache over a host mesh of 4 ranks on the card, fed B2's
    tokens; in bf16 also without rules on the plain decode (impl="torch"),
    fed them too.  bf16: the sharded logits within SHARDED_REL_TOL of B2's
    at every step; one more rounding of every attention output moves
    random-weight logits by ~2 % over 32 layers and flips near-tied greedy
    tokens, so the plain decode's readings stand beside them as the
    yardstick; and a planted fault, the sharded decode over a mesh whose
    merge drops the last rank's partial (`_dropping_last_rank`), must read
    above SHARDED_REL_TOL in each of its SHARDED_FAULT_STEPS steps.  f32:
    within SHARDED_F32_TOL and B2's greedy token in every step and row.  No
    B2 launch off the B2 run."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.sharding import standard_rules

    N = 32
    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    mesh = make_host_mesh(model_ranks, devices=[dev] * 4)
    seq_axes = standard_rules(mesh, long_context=shape.global_batch == 1).rules["cache_seq"]
    params = init_params(cfg, seed=0, device=dev)
    max_len, _ = steps.cache_lengths(cfg, shape)
    toks = torch.randint(0, cfg.vocab_size, (shape.global_batch, prompt),
                         generator=torch.Generator().manual_seed(5)).to(dev)
    (lg, cache), _, pre = _run_counted(torch, lambda: steps.build_prefill_step(cfg, shape)(
        params, {"tokens": toks}, init_cache(cfg, shape.global_batch, max_len, device=dev)))
    _expect("dryrun", f"{arch} flash_attention per prefill", pre["flash_attention"],
            cfg.num_layers)
    runs = {"b2": steps.build_serve_step(cfg, shape),
            "sharded": steps.build_serve_step(cfg, shape, mesh=mesh)}
    if dtype == "bfloat16":
        runs["plain"] = steps.build_serve_step(cfg, shape, impl="torch")
        fault_step = steps.build_serve_step(cfg, shape, mesh=_dropping_last_rank(mesh))
        fault_cache = {k: v.clone() for k, v in cache.items()}
    caches = [cache] + [{k: v.clone() for k, v in cache.items()} for _ in runs][1:]

    def run(step, c, inputs, n=N):
        out, last = [], lg
        for i in range(n):
            tok = last.argmax(-1) if inputs is None else inputs[i]
            last, _ = step(params, c, tok)
            out.append((tok, last))
        return out
    out, forced = {}, None
    launches = dict(pre)
    for (name, step), c in zip(runs.items(), caches):
        out[name], secs, counts = _run_counted(torch, lambda: run(step, c, forced))
        forced = forced or [t for t, _ in out[name]]
        _expect("dryrun", f"{arch} {dtype} flash_decode over {N} {name} steps",
                counts["flash_decode"], cfg.num_layers * N if name == "b2" else 0)
        out[name + "_ms_per_step"] = 1e3 * secs / N
        launches = {k: launches[k] + counts[k] for k in launches}
    errs = _rel_norms(out["sharded"], out["b2"])
    steps_same, rows_same = _same_tokens(out["sharded"], out["b2"])
    res = dict(arch=arch, dtype=dtype, layers=cfg.num_layers, batch=shape.global_batch,
               prompt_tokens=prompt, cache_len=max_len, ring=steps.ring_buffer(cfg, shape),
               mesh=dict(mesh.shape), cache_seq=list(seq_axes), steps=N,
               rel_err_first=errs[0], rel_err_max=max(errs),
               steps_tokens_same=steps_same, rows_tokens_same=rows_same,
               rows=N * shape.global_batch,
               **{k: v for k, v in out.items() if k.endswith("_ms_per_step")})
    if dtype == "bfloat16":
        if max(errs) > SHARDED_REL_TOL:
            raise AssertionError(f"dryrun: {arch} sharded decode against B2: rel-norm "
                                 f"{max(errs):.3e} (tol {SHARDED_REL_TOL})")
        p_steps, p_rows = _same_tokens(out["plain"], out["b2"])
        fault = _rel_norms(run(fault_step, fault_cache, forced, SHARDED_FAULT_STEPS),
                           out["b2"])
        del fault_cache
        if min(fault) <= SHARDED_REL_TOL:
            raise AssertionError(f"dryrun: {arch} sharded decode with the last rank's "
                                 f"partial dropped reads {fault} against B2, not above "
                                 f"{SHARDED_REL_TOL}")
        res.update(dropped_rank_rel_err=fault,
                   plain_vs_b2_rel_err_max=max(_rel_norms(out["plain"], out["b2"])),
                   sharded_vs_plain_rel_err_max=max(_rel_norms(out["sharded"], out["plain"])),
                   plain_steps_tokens_same=p_steps, plain_rows_tokens_same=p_rows)
    elif max(errs) > SHARDED_F32_TOL or steps_same != N:
        raise AssertionError(f"dryrun: {arch} f32 sharded decode against B2: rel-norm "
                             f"{max(errs):.3e} (tol {SHARDED_F32_TOL}), the same greedy "
                             f"tokens in {steps_same} of {N} steps")
    del params, caches, cache, lg, out
    torch.cuda.empty_cache()
    return res, launches


def _matrix_job(out_dir):
    """The dry run's matrix (`dryrun_all.run_matrix`): (its records, its
    seconds).  Host work on the meta device alone, so `main` runs it in a
    process of its own beside the card's phases."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun_all
    t0 = time.perf_counter()
    recs = dryrun_all.run_matrix(out_dir=out_dir, log=lambda line: None)
    return recs, time.perf_counter() - t0


def phase_dryrun(torch, dev, smi, matrix_job):
    """The dry run: the matrix (`matrix_job`, an async result of
    `_matrix_job`), the account against the card's measured peaks, and the
    sequence-sharded decode at full width (module doc, 19)."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, dryrun_all

    t_phase = time.perf_counter()
    recs, matrix_s = matrix_job.get()
    n = dryrun_all.summary(recs)
    if (n["ok"], n["skipped"], n["failed"]) != (66, 14, 0):
        raise AssertionError(f"dryrun: the matrix reads {n}, not 66 ok / 14 skipped")
    ok = [r for r in recs if r.get("ok")]
    largest = max(ok, key=lambda r: r["memory"]["per_device_total"])
    matrix = dict(n, seconds=matrix_s, waited_s=time.perf_counter() - t_phase,
                  fit_80gb={m: sum(r["memory"]["fits"] for r in ok if r["mesh"] == m)
                            for m in ("pod16x16", "pod2x16x16")},
                  ok_per_mesh={m: sum(r["mesh"] == m for r in ok)
                               for m in ("pod16x16", "pod2x16x16")},
                  largest_per_device_gb=largest["memory"]["per_device_total"] / 1e9,
                  largest=dryrun.tag(largest),
                  # the combos whose verdict the per-device account moved
                  # from the whole step's peak over n
                  fits_changed=[dryrun.tag(r) for r in ok if r["memory"]["fits"] != (
                      r["memory"]["per_device_total_whole_step_over_n"]
                      <= r["hbm_per_device"])])
    holds = _account_holds(torch, dev)
    decode, launches = {}, dict.fromkeys(_counters(), 0)
    for name, args in (
            ("llama3_8b_long_500k", ("llama3_8b", INPUT_SHAPES["long_500k"], RING_PROMPT, 1)),
            ("mistral_7b_8x2048", ("mistral_7b", ShapeConfig("decode_8x2048", 2048, 8, "decode"),
                                   2048 - 32, 4))):
        for dtype in ("bfloat16", "float32"):
            decode[f"{name}_{dtype}"], counts = _sharded_decode(torch, dev, *args, dtype)
            for k, v in counts.items():
                launches[k] += v
    _say("dryrun", nvidia_smi=smi, matrix=matrix, account_tol=ACCOUNT_TOL,
         account=holds, sharded_rel_tol=SHARDED_REL_TOL, sharded_decode=decode,
         launches=launches, phase_s=time.perf_counter() - t_phase)
    return launches

def _dropping_last_partial(mesh, op="psum_scatter"):
    """`mesh` whose `op` (psum_scatter or psum) leaves out the last rank's
    partial: a reduce-scatter drops that rank's share of the prefill's
    row-parallel projections (wo, w_down) and embedding, an all-reduce its
    share of the serve step's, and of its decode's merge."""
    import torch
    from repro_torch.sp.common import GangMesh

    def drop(xs, here):
        return xs[:-1] + [torch.zeros_like(xs[-1])] if op == here else xs

    class Dropping(GangMesh):
        def psum_scatter(self, xs, axes, *, scatter_dimension):
            return super().psum_scatter(drop(xs, "psum_scatter"), axes,
                                        scatter_dimension=scatter_dimension)

        def psum(self, xs, axes):
            return super().psum(drop(xs, "psum"), axes)
    return Dropping(mesh.devices, tuple(mesh.shape.values()), mesh.axis_names)


@contextlib.contextmanager
def _routes():
    """Within: every moe routing (`moe.route_logits`) recorded, per rank of
    a partitioned step (None: a whole-tensor step), in call order."""
    import threading

    from repro_torch.models import moe, tp
    seen, local = {}, threading.local()
    route, block = moe.route_logits, tp._moe

    def recording(*a, **k):
        r = route(*a, **k)
        seen.setdefault(getattr(local, "rank", None), []).append(
            moe.Routing(*(t.detach() for t in r[:-1]), r.capacity))
        return r

    def ranked(rk, *a, **k):
        local.rank = rk.rank
        return block(rk, *a, **k)
    moe.route_logits, tp._moe = recording, ranked
    try:
        yield seen
    finally:
        moe.route_logits, tp._moe = route, block


def _joined_routes(ranks, mesh, pl):
    """Per call, the routing of every group from `_routes`' record of a
    partitioned step: the ranks at model index 0, each its own groups in
    the order of the batch axes (`tp.Plan.moe_batch`), or rank 0's where
    every rank routed every group."""
    import torch

    from repro_torch.models.moe import Routing
    firsts = sorted((mesh.axis_index(r, pl.batch), r) for r in ranks
                    if not mesh.axis_index(r, "model"))
    if pl.moe_batch != pl.batch:
        firsts = firsts[:1]
    return [Routing(*(torch.cat([getattr(ranks[r][i], f) for _, r in firsts])
                      for f in Routing._fields[:-1]), ranks[firsts[0][1]][i].capacity)
            for i in range(len(ranks[firsts[0][1]]))]


@contextlib.contextmanager
def _replaying(routes):
    """Within: `moe.route_logits` takes the choices of `routes` in turn
    (each token's top-k experts, their slots and keeps) and computes the
    gates from its own logits as it does: a whole-tensor step routed as a
    partitioned one was."""
    from repro_torch.models import moe
    route, it = moe.route_logits, iter(routes)

    def replay(cfg, logits, **kw):
        r = next(it)
        if r.probs.shape != logits.shape:
            raise AssertionError(f"replayed routing {tuple(r.probs.shape)} for logits "
                                 f"{tuple(logits.shape)}")
        probs = logits.softmax(-1)
        gate = probs.gather(-1, r.expert)
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        return moe.Routing(probs, r.expert, gate * r.keep, r.slot, r.keep, r.capacity)
    moe.route_logits = replay
    try:
        yield
    finally:
        moe.route_logits = route


def _routing_flips(whole, part, n_experts):
    """(per call, the share of routed (token, k) assignments of `part` whose
    (expert, keep) `whole` did not give that token, the order of its k
    choices aside; the tokens, flattened over the groups, with one in any
    call).  `whole`, `part`: routings of every group, one per call."""
    import torch.nn.functional as F

    def held(r):         # (G, Tg, 2E): each token's (expert, keep) pairs
        return F.one_hot(r.expert * 2 + r.keep.long(), 2 * n_experts).sum(-2)
    shares, tokens = [], set()
    for w, p in zip(whole, part):
        d = (held(p) - held(w)).abs().sum(-1) // 2
        shares.append(int(d.sum()) / p.expert.numel())
        tokens.update(d.flatten().nonzero().flatten().tolist())
    return shares, tokens


@contextlib.contextmanager
def _dropping_expert_partial(cfg, mesh, victim):
    """Within: the expert sum of a partitioned moe block without the partial
    of expert rank `victim` (its `moe.expert_partial` zeroed before the
    reduce-scatter)."""
    from repro_torch.models import moe
    partial = moe.expert_partial
    e0 = victim * (cfg.num_experts // mesh.axis_size("model"))

    def dropping(cfg_, p, r, x, **kw):
        y = partial(cfg_, p, r, x, **kw)
        return y.zero_() if kw.get("e0", 0) == e0 else y
    moe.expert_partial = dropping
    try:
        yield
    finally:
        moe.expert_partial = partial


def _partition_case(torch, dev, arch, layers, dtype, meshes, account=False):
    """One model at full width, `layers` deep, in `dtype`: the unpartitioned
    prefill (B1) and PARTITION_STEPS greedy serve steps (B2), then per mesh
    shape the same from shards of the same weights (views) on ranks that
    share the card: launches exact, logits and K/V against the
    unpartitioned run, the collective bytes counted on the card against the
    dry run's count (bf16: its model's dtype), planted faults in the
    prefill's reduce-scatter (moe: the last expert rank's partial of the
    expert sum) and the serve step's all-reduce (bf16, the first mesh), moe's
    routing flips per layer, and for the record wall seconds, the device's
    idle share and operations of a serve step, the card's peak and each
    rank's argument bytes.  With `account` (bf16), the dry run's per-device
    account against the card's rise in memory over one serve step, held
    (`_held_account`), and over the prefill, reported (the card runs B1,
    the account the plain attention)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.checks import rel_err
    from repro_torch.launch import dryrun, partition, steps
    from repro_torch.launch import shardings as shd
    from repro_torch.models import init_cache, init_params, tp
    from repro_torch.sp.common import GangMesh

    t_case = time.perf_counter()
    bf16 = dtype == "bfloat16"
    tol = PARTITION_REL_TOL if bf16 else PARTITION_F32_TOL
    B, S, N, C = PARTITION_BATCH, PARTITION_PROMPT, PARTITION_STEPS, PARTITION_CACHE
    cfg = dataclasses.replace(get_config(arch), num_layers=layers, dtype=dtype)
    V = cfg.vocab_size          # logits compared without the padded vocabulary
    pre = ShapeConfig(f"prefill_{B}x{S}", S, B, "prefill")
    dec = ShapeConfig(f"decode_{B}x{C}", C, B, "decode")
    params = init_params(cfg, seed=0, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(5)).to(dev)
    prefill, serve = steps.build_prefill_step(cfg, pre), steps.build_serve_step(cfg, dec)
    cache = init_cache(cfg, B, C, device=dev)
    moe = cfg.family == "moe"
    with _routes() as whole_routes:
        (lg, cache), pre_s, counts = _run_counted(
            torch, lambda: prefill(params, {"tokens": toks}, cache))
    _expect("partition", f"{arch} unpartitioned flash_attention per prefill",
            counts["flash_attention"], layers)
    ref_kv = {k: cache[k][:, :, :, :S].clone() for k in ("k", "v")}

    whole_steps = []         # moe: each serve step's routings

    def greedy():
        out, last = [], lg
        for _ in range(N):
            tok = last.argmax(-1)
            with _routes() as routes:
                last, _ = serve(params, cache, tok)
            whole_steps.append(routes.get(None))
            out.append((tok, last))
        return out

    def replayed(prefill_routes, step_routes, tokens):
        """The unpartitioned prefill and serve steps (fed `tokens`), each
        routed as the partitioned run was (moe): (prefill logits, its K/V,
        [(token, logits)] per step)."""
        c = init_cache(cfg, B, C, device=dev)
        with _replaying(prefill_routes):
            first, c = prefill(params, {"tokens": toks}, c)
        kv = {k: c[k][:, :, :, :S].clone() for k in ("k", "v")}
        outs = []
        for tok, routes in zip(tokens, step_routes):
            with _replaying(routes):
                last, c = serve(params, c, tok)
            outs.append((tok, last))
        return first, kv, outs
    want, dec_s, dc = _run_counted(torch, greedy)
    _expect("partition", f"{arch} unpartitioned flash_decode over {N} steps",
            dc["flash_decode"], layers * N)
    launches = {k: counts[k] + dc[k] for k in counts}
    del cache
    res = dict(arch=arch, dtype=dtype, layers=layers, batch=B, prompt=S, cache_len=C,
               steps=N, tol=tol, unpartitioned=dict(prefill_s=pre_s,
                                                    decode_ms_per_step=1e3 * dec_s / N))
    for shape in meshes:
        n = shape[0] * shape[1]
        mesh = GangMesh([dev] * n, shape, ("data", "model"))
        tag = f"{shape[0]}x{shape[1]}"

        def shards(mesh):
            pspecs = shd.param_specs(cfg, params, mesh,
                                     fsdp=shd.needs_fsdp(cfg, mesh, "prefill"))
            c = init_cache(cfg, B, C, device=dev)
            cspecs = shd.cache_specs(cfg, c, mesh, global_batch=B)
            return (partition.shard_tree(params, pspecs, mesh),
                    partition.shard_tree({"tokens": toks}, shd.batch_specs(cfg, pre, mesh),
                                         mesh),
                    partition.shard_tree(c, cspecs, mesh),
                    shd.per_device_bytes(params, pspecs, mesh)
                    + shd.per_device_bytes(c, cspecs, mesh))
        p, b, c, rank_bytes = shards(mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        mesh.reset_bytes()
        with _routes() as rank_routes:
            (lg_s, c), p_pre_s, pc = _run_counted(torch, lambda: prefill(p, b, c))
        pre_rise = (torch.cuda.max_memory_allocated() - before) / 1e9
        pre_bytes = dict(mesh.collective_bytes[0])
        _expect("partition", f"{arch} {tag} flash_attention per prefill",
                pc["flash_attention"], layers * n)
        got = partition.unshard_tree(lg_s)
        kv = partition.unshard_tree(c)
        kv = {k: kv[k][:, :, :, :S].clone() for k in ("k", "v")}
        tspec = shd.batch_specs(cfg, dec, mesh)["token"]
        step_bytes, rank_steps = [], []

        def run(c=c):
            out, last = [], got
            for i in range(N):
                # bf16 teacher-forced by the unpartitioned tokens (one
                # more rounding flips near-tied random-weight argmaxes);
                # f32 greedy on its own
                tok = want[i][0] if bf16 else last.argmax(-1)
                mesh.reset_bytes()
                with _routes() as routes:
                    lg_i, c = serve(p, c, partition.shard_tree(tok, tspec, mesh))
                rank_steps.append(routes)
                step_bytes.append(dict(mesh.collective_bytes[0]))
                last = partition.unshard_tree(lg_i)
                out.append((tok, last))
            return out, c
        (out, c), p_dec_s, sc = _run_counted(torch, run)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        _expect("partition", f"{arch} {tag} flash_decode over {N} steps", sc["flash_decode"], 0)
        _expect("partition", f"{arch} {tag} flash_attention over {N} steps",
                sc["flash_attention"], 0)
        fails, flips, base, base_kv, base_out = [], {}, lg, ref_kv, want
        if moe:
            # a token that one more rounding routes otherwise (a near tie)
            # moves by O(gate): the partitioned run is held against the
            # unpartitioned steps routed as it was, its routing against
            # theirs (ROUTING_FLIP_TOL), and its readings against the
            # unpartitioned run's own routing are reported
            part_pre = _joined_routes(rank_routes, mesh, tp.plan(
                cfg, mesh, batch=B, seq=S, long_context=False))
            pl1 = tp.plan(cfg, mesh, batch=B, seq=1, long_context=False)
            part_steps = [_joined_routes(r, mesh, pl1) for r in rank_steps]
            share, tokens = _routing_flips(whole_routes[None], part_pre, cfg.num_experts)
            step_flips = [_routing_flips(w, r, cfg.num_experts)
                          for w, r in zip(whole_steps, part_steps)]
            # over every step and layer: a step routes B tokens only
            serve_share = (sum(sum(sh) for sh, _ in step_flips)
                           / sum(len(sh) for sh, _ in step_flips))
            flips = dict(
                routing_flip_share_per_layer=share, prefill_tokens_flipped=len(tokens),
                serve_routing_flip_share=serve_share,
                serve_rows_flipped=sum(len(t) for _, t in step_flips),
                unreplayed=dict(
                    prefill_logits_rel_err=rel_err(got[None, :, :V], lg[None, :, :V].float()),
                    kv_rel_err=max(rel_err(kv[k].flatten(0, 1), ref_kv[k].flatten(0, 1).float())
                                   for k in ("k", "v")),
                    serve_rel_err_max=max(_rel_norms(out, want, V)),
                    steps_tokens_same=_same_tokens(out, want)[0]))
            if max(share + [serve_share]) > ROUTING_FLIP_TOL:
                fails.append(f"routing flips {max(share):.3e} (prefill), {serve_share:.3e} "
                             f"(serve) above {ROUTING_FLIP_TOL}")
            base, base_kv, base_out = replayed(part_pre, part_steps, [t for t, _ in out])
        first_same = bool(torch.equal(got.argmax(-1), base.argmax(-1)))
        logits_err = rel_err(got[None, :, :V], base[None, :, :V].float())
        kv_err = max(rel_err(kv[k].flatten(0, 1), base_kv[k].flatten(0, 1).float())
                     for k in ("k", "v"))
        del kv
        errs = _rel_norms(out, base_out, V)
        steps_same, rows_same = _same_tokens(out, base_out)
        if bf16 and not first_same:
            fails.append("the first token differs")
        if max([logits_err, kv_err] + errs) > tol:
            fails.append(f"logits {logits_err:.3e}, K/V {kv_err:.3e}, serve steps "
                         f"{max(errs):.3e} against the limit {tol}")
        if not bf16 and steps_same != N:
            fails.append(f"the same greedy tokens in {steps_same} of {N} steps")
        if any(sb != step_bytes[0] for sb in step_bytes):
            fails.append("the serve steps moved different collective bytes")
        row = dict(mesh=dict(mesh.shape), first_token_same=first_same,
                   prefill_logits_rel_err=logits_err, kv_rel_err=kv_err,
                   serve_rel_err_max=max(errs), steps_tokens_same=steps_same,
                   rows_tokens_same=rows_same, prefill_s=p_pre_s,
                   decode_ms_per_step=1e3 * p_dec_s / N, card_peak_gb=peak_gb,
                   rank_argument_gb=rank_bytes / 1e9,
                   collective_bytes=dict(prefill=pre_bytes, serve_step=step_bytes[0]),
                   **flips)
        if bf16:
            # the dry run's count on meta ranks (run_combo's numbers),
            # the prefill's with the card's cache of C positions
            t_dry = time.perf_counter()
            recs = {"prefill": dryrun.collective_bytes(cfg, pre, mesh, max_len=C),
                    "serve_step": dryrun.collective_bytes(cfg, dec, mesh)}
            row["dry_run_count_s"] = time.perf_counter() - t_dry
            row["dry_run_collectives_equal"] = recs == row["collective_bytes"]
            if not row["dry_run_collectives_equal"]:
                fails.append(f"collective bytes on the card {row['collective_bytes']} "
                             f"against the dry run's {recs}")
            # two serve steps under the profiler (the device's idle share),
            # the cache's length set back by two: it is full
            tok = partition.shard_tree(want[0][0], tspec, mesh)
            back = partition.Sharded([dict(t, len=t["len"] - 2) for t in c.local],
                                     c.specs, mesh)
            if account:
                # the card's rise over one serve step against the dry
                # run's per-device account (both the plain distributed
                # decode), and over the prefill above (B1 against the
                # plain attention: reported)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                serve(p, back, tok)
                torch.cuda.synchronize()
                step_rise = (torch.cuda.max_memory_allocated() - before) / 1e9
                row["account"] = {
                    "serve_step": _held_account(arch, dec, layers, mesh, step_rise,
                                                _serve_faults()),
                    "prefill": _held_account(arch, pre, layers, mesh, pre_rise, max_len=C)}
            row["serve_step_profile"] = _profile_steps(
                torch, lambda: serve(p, back, tok), 2)
        if bf16 and shape == meshes[0]:
            if moe:
                # the last expert rank's partial dropped; at one layer only
                # the compared tokens' own assignments reach the logits, so
                # where none of them lies on that rank, the rank holding
                # most of them
                m = mesh.axis_size("model")
                ends = torch.arange(1, B + 1, device=dev) * S - 1
                hits = sum(torch.bincount(
                    (r.expert.flatten(0, 1)[ends] // (cfg.num_experts // m))[
                        r.keep.flatten(0, 1)[ends]], minlength=m) for r in whole_routes[None])
                victim = m - 1 if layers > 1 or hits[-1] else int(hits.argmax())
                fp, fb, fc, _ = shards(mesh)
                with _dropping_expert_partial(cfg, mesh, victim):
                    fault = partition.unshard_tree(prefill(fp, fb, fc)[0])
                what = f"an expert sum without expert rank {victim}'s partial"
                row.update(dropped_expert_rank=victim,
                           dropped_expert_rank_hits=int(hits[victim]))
            else:
                fp, fb, fc, _ = shards(_dropping_last_partial(mesh))
                fault = partition.unshard_tree(prefill(fp, fb, fc)[0])
                what = "a reduce-scatter without the last rank's partial"
            key = "dropped_expert_partial_rel_err" if moe else "dropped_partial_rel_err"
            row[key] = rel_err(fault[None, :, :V], lg[None, :, :V].float())
            del fp, fb, fc, fault
            if row[key] <= tol:
                fails.append(f"{what} reads {row[key]:.3e}, inside the limit")
            # the serve step's own all-reduces: the same shards on a mesh
            # whose psum drops the last rank's partial, the cache's length
            # set back to the prompt's, fed the unpartitioned tokens
            fm = _dropping_last_partial(mesh, "psum")
            fp = partition.Sharded(p.local, p.specs, fm)
            fc = partition.Sharded([dict(t, len=torch.full_like(t["len"], S)) for t in c.local],
                                   c.specs, fm)
            fault_out = []
            for i in range(PARTITION_FAULT_STEPS):
                lg_f, fc = serve(fp, fc, partition.shard_tree(want[i][0], tspec, fm))
                fault_out.append((want[i][0], partition.unshard_tree(lg_f)))
            row["dropped_psum_serve_rel_err"] = _rel_norms(fault_out, want, V)
            del fp, fc, fault_out
            if min(row["dropped_psum_serve_rel_err"]) <= tol:
                fails.append(f"serve steps whose all-reduce drops the last rank's partial "
                             f"read {row['dropped_psum_serve_rel_err']}, inside the limit")
        for k in launches:
            launches[k] += pc[k] + sc[k]
        res[tag] = row
        del p, b, c, lg_s, got, out
        torch.cuda.empty_cache()
        if fails:
            raise AssertionError(f"partition: {arch} {dtype} on {tag}: " + "; ".join(fails)
                                 + f" (readings: {json.dumps(row, default=str)[:3000]})")
    del params, want, ref_kv, lg
    torch.cuda.empty_cache()
    res["case_s"] = time.perf_counter() - t_case
    return res, launches


def phase_partition(torch, dev, smi):
    """The partitioned prefill and serve steps (module doc, 20)."""
    t0 = time.perf_counter()
    runs, launches = {}, dict.fromkeys(_counters(), 0)
    for name, arch, layers, dtype, meshes in (
            ("llama31_70b_bf16", "llama31_70b", PARTITION_LAYERS, "bfloat16", PARTITION_MESHES),
            ("llama31_70b_f32", "llama31_70b", PARTITION_F32_LAYERS, "float32",
             PARTITION_MESHES),
            ("qwen2_7b_bf16", "qwen2_7b", PARTITION_F32_LAYERS, "bfloat16", ((1, 8),)),
            ("qwen2_7b_f32", "qwen2_7b", PARTITION_F32_LAYERS, "float32", ((1, 8),)),
            ("phi3_14b_bf16", "phi3_14b", PARTITION_F32_LAYERS, "bfloat16", ((1, 4),)),
            ("phi3_14b_f32", "phi3_14b", PARTITION_F32_LAYERS, "float32", ((1, 4),))):
        runs[name], counts = _partition_case(torch, dev, arch, layers, dtype, meshes,
                                             account=name == "llama31_70b_bf16")
        for k, v in counts.items():
            launches[k] += v
    _say("partition", nvidia_smi=smi, rel_tol=PARTITION_REL_TOL, account_tol=ACCOUNT_TOL,
         f32_tol=PARTITION_F32_TOL,
         cut=f"llama31_70b {PARTITION_LAYERS} of 80 layers in bf16, {PARTITION_F32_LAYERS} "
         f"in f32; qwen2_7b and phi3_14b {PARTITION_F32_LAYERS}", runs=runs, launches=launches,
         phase_s=time.perf_counter() - t0)
    return launches


def _grad_errs(got, want):
    """Per leaf (in `param_leaves` order), ||got - want|| / ||want||."""
    from repro_torch.models.model import param_leaves
    return [float((g.float() - w.float()).norm() / w.float().norm().clamp_min(1e-30))
            for g, w in zip(param_leaves(got), param_leaves(want))]


def _pt_batch(cfg, mesh, batch):
    """A train batch cut by `batch_specs` over `mesh`."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import partition
    from repro_torch.launch import shardings as shd
    B, S = batch["tokens"].shape
    return partition.shard_tree(batch, shd.batch_specs(
        cfg, ShapeConfig("train", S, B, "train"), mesh), mesh)


def _pt_shards(cfg, params, mesh, clone):
    """params (a copy where `clone`: a step updates them in place) and a
    fresh optimizer state cut by the fsdp specs over `mesh`, and the
    per-rank GB of the params (= gradients) and the moments."""
    from repro_torch.launch import partition
    from repro_torch.launch import shardings as shd
    from repro_torch.training import adamw_init
    p = _tree_to(params, params["embed"].device) if clone else params
    opt = adamw_init(p)
    pspecs = shd.param_specs(cfg, p, mesh, fsdp=True)
    ospecs = shd.opt_specs(pspecs, opt)
    return (partition.shard_tree(p, pspecs, mesh), partition.shard_tree(opt, ospecs, mesh),
            dict(params_gb=shd.per_device_bytes(p, pspecs, mesh) / 1e9,
                 moments_gb=shd.per_device_bytes(opt, ospecs, mesh) / 1e9))


def _pt_case(torch, dev, arch, layers, f32_layers, meshes, profile=True,
             model_psum_fault=None, account=False):
    """The partitioned FSDP train step of `arch` at full width against the
    whole-tensor step from the same weights (module doc, 21): bf16 at
    `layers` on each of `meshes` (the fault on (4, 1); with `profile` one
    more step profiled; with `model_psum_fault` a leaf name, on (1, 4) the
    last model rank's partial dropped from that leaf's gradient sum over
    "model", `_dropping_model_partial`; with `account` the dry run's
    per-device account against the card's rise in memory over the timed
    step, `_held_account`), f32 at `f32_layers`, two steps each; returns
    {"<arch>_bf16", "<arch>_f32"}."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, partition, steps, train
    from repro_torch.launch import shardings as shd
    from repro_torch.models import init_params
    from repro_torch.models.model import param_leaves
    from repro_torch.sp.common import GangMesh, as_axes
    from repro_torch.training import adamw_init

    t_case = time.perf_counter()
    full = get_config(arch)
    audio = full.family == "audio"
    B, S = PT_BATCH, PT_SEQ
    if audio:
        # the decoder's tokens; the encoder takes frontend_tokens frames
        S = steps.AUDIO_DECODER_TRAIN_LEN
    shape = ShapeConfig(f"train_{B}x{S}", full.frontend_tokens if audio else S, B, "train")

    def depth(n, **kw):
        """`full` at n layers (audio: n encoder and n decoder layers)."""
        return dataclasses.replace(full, num_layers=n, encoder_layers=n if audio else 0, **kw)
    runs = {}
    # bf16: the whole-tensor step's gradients and one timed step, then per
    # mesh the partitioned gradients and one timed step from a copy
    cfg = depth(layers)
    params = init_params(cfg, seed=0, device=dev)
    batch = train.make_batch(cfg, B, S, np.random.default_rng(0), dev)
    moe = cfg.family == "moe"
    with _routes() as whole_routes:
        (w_loss, w_grads), _, c = _run_counted(
            torch, lambda: steps.loss_and_grads(cfg, params, batch))
    _expect("partition_train", "a kernel in the whole-tensor gradients", sum(c.values()), 0)
    w_loss = float(w_loss)
    w_norm = float(torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                  for g in param_leaves(w_grads))))
    p1 = _tree_to(params, dev)
    o1 = adamw_init(p1)
    torch.cuda.reset_peak_memory_stats()
    (_, _, w_info), w_s, _ = _run_counted(
        torch, lambda: steps.build_train_step(cfg)(p1, o1, batch))
    whole = dict(loss=w_loss, grad_norm=w_norm, step_s=w_s, step_loss=float(w_info["loss"]),
                 card_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del p1, o1
    torch.cuda.empty_cache()
    bf16 = {}
    for mshape in meshes:
        tag = f"{mshape[0]}x{mshape[1]}"
        mesh = GangMesh([dev] * 4, mshape, ("data", "model"))
        p = partition.shard_tree(params, shd.param_specs(cfg, params, mesh, fsdp=True), mesh)
        b = _pt_batch(cfg, mesh, batch)
        with _routes() as rank_routes:
            (_, grads), grads_s, c = _run_counted(
                torch, lambda: partition.loss_and_grads(cfg, p, b))
        grads = partition.unshard_tree(grads)
        base, routing = w_grads, {}
        if moe:
            # held against the whole-tensor gradients routed as the
            # partitioned step was (forward, then the remat's recompute);
            # the flips against the whole step's own routing counted, and
            # its gradients' readings reported
            part = _joined_routes(rank_routes, mesh, partition._train_plan(cfg, p, b))
            share, _ = _routing_flips(whole_routes[None][:layers], part[:layers],
                                      cfg.num_experts)
            with _replaying(part):
                _, base = steps.loss_and_grads(cfg, params, batch)
            routing = dict(routing_flip_share_per_layer=share,
                           grads_rel_err_max_unreplayed=max(_grad_errs(grads, w_grads)))
        errs = _grad_errs(grads, base)
        names = ["/".join(map(str, path)) for path, _ in _spec_leaves(p.specs)]
        worst = sorted(zip(errs, names), reverse=True)[:6]
        del grads, base
        torch.cuda.empty_cache()
        sp, so, rank_gb = _pt_shards(cfg, params, mesh, clone=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        mesh.reset_bytes()
        (_, so, info), step_s, sc = _run_counted(
            torch, lambda: steps.build_train_step(cfg)(sp, so, b))
        counted = dict(mesh.collective_bytes[0])
        peak = torch.cuda.max_memory_allocated() / 1e9
        rise = (torch.cuda.max_memory_allocated() - before) / 1e9
        prof = (_profile_steps(torch, lambda: steps.build_train_step(cfg)(sp, so, b), 1)
                if profile else "not measured")
        del sp, so
        torch.cuda.empty_cache()
        t_dry = time.perf_counter()
        record = dryrun.collective_bytes(cfg, shape, mesh)
        dry_s = time.perf_counter() - t_dry
        loss = float(info["loss"])
        row = dict(loss=loss, loss_rel_err=abs(loss - w_loss) / abs(w_loss),
                   grad_norm=float(info["grad_norm"]),
                   grad_norm_rel_err=abs(float(info["grad_norm"]) - w_norm) / w_norm,
                   grads_rel_err_max=max(errs),
                   grads_rel_err_worst={n: e for e, n in worst}, grads_s=grads_s, step_s=step_s,
                   card_peak_gb=peak, rank_gb=dict(rank_gb, grads_gb=rank_gb["params_gb"]),
                   collective_bytes=counted, dry_run_collectives_equal=record == counted,
                   dry_run_count_s=dry_s,
                   step_profile=prof, **routing)
        fails = []
        if account:
            try:
                row["account"] = _held_account(arch, shape, layers, mesh, rise,
                                               _train_faults())
            except AssertionError as e:
                fails.append(str(e))
        if moe and max(routing["routing_flip_share_per_layer"]) > ROUTING_FLIP_TOL:
            fails.append(f"routing flips {max(routing['routing_flip_share_per_layer']):.3e} "
                         f"above {ROUTING_FLIP_TOL}")
        if sum(c.values()) + sum(sc.values()):
            fails.append(f"a kernel launched: {c} {sc}")
        if row["loss_rel_err"] > PT_LOSS_TOL:
            fails.append(f"loss {loss} against {w_loss}")
        if row["grad_norm_rel_err"] > PARTITION_REL_TOL or max(errs) > PARTITION_REL_TOL:
            fails.append(f"grad norm {row['grad_norm_rel_err']:.3e}, gradients up to "
                         f"{max(errs):.3e} against the limit {PARTITION_REL_TOL}")
        if not row["dry_run_collectives_equal"]:
            fails.append(f"collective bytes on the card {counted} against the dry run's {record}")
        if mshape == (4, 1):
            # FSDP alone: the backward reduce-scatters the gradients of the
            # weights' all-gathers; drop the last rank's partial there
            fm = _dropping_last_partial(mesh)
            fp = partition.Sharded(p.local, p.specs, fm)
            fb = partition.Sharded(b.local, b.specs, fm)
            _, fg = partition.loss_and_grads(cfg, fp, fb)
            ferrs = _grad_errs(partition.unshard_tree(fg), w_grads)
            del fg, fp, fb
            touched = [e for e, (_, spec) in zip(ferrs, _spec_leaves(p.specs))
                       if any("data" in as_axes(a) for a in spec)]
            row["dropped_partial_rel_err_min"] = min(touched)
            row["dropped_partial_leaves"] = len(touched)
            if min(touched) <= PARTITION_REL_TOL:
                fails.append(f"a gradient reduce-scatter without the last rank's partial "
                             f"reads {min(touched):.3e}, inside the limit")
        if model_psum_fault and mshape == (1, 4):
            leaf = next(t for path, t in _spec_leaves(p.local[0])
                        if path[-1] == model_psum_fault)
            with _dropping_model_partial(tuple(leaf.shape)):
                _, fg = partition.loss_and_grads(cfg, p, b)
            ferrs = _grad_errs(partition.unshard_tree(fg), w_grads)
            del fg
            hit = [e for e, (path, _) in zip(ferrs, _spec_leaves(p.specs))
                   if path[-1] == model_psum_fault]
            row[f"dropped_{model_psum_fault}_partial_rel_err_min"] = min(hit)
            row[f"dropped_{model_psum_fault}_partial_leaves"] = len(hit)
            if min(hit) <= PARTITION_REL_TOL:
                fails.append(f"{model_psum_fault}'s gradient without the last model rank's "
                             f"partial reads {min(hit):.3e}, inside the limit")
        if audio and mshape == (1, 4):
            # the encoder's output detached inside every decoder layer: no
            # gradient reaches the encoder
            with _detaching_encoder():
                _, fg = partition.loss_and_grads(cfg, p, b)
            ferrs = _grad_errs(partition.unshard_tree(fg), w_grads)
            del fg
            hit = [e for e, (path, _) in zip(ferrs, _spec_leaves(p.specs))
                   if path[0] in ("encoder", "enc_norm")]
            row["detached_encoder_rel_err_min"] = min(hit)
            row["detached_encoder_leaves"] = len(hit)
            if min(hit) <= PARTITION_REL_TOL:
                fails.append(f"the encoder's gradients with its output detached in the "
                             f"decoder read {min(hit):.3e}, inside the limit")
        bf16[tag] = row
        del p, b
        torch.cuda.empty_cache()
        if fails:
            raise AssertionError(f"partition_train: {arch} bf16 on {tag}: " + "; ".join(fails)
                                 + f" (readings: {json.dumps(row, default=str)[:3000]})")
    runs[f"{arch}_bf16"] = dict(layers=cfg.num_layers, layers_full=full.num_layers,
                                batch=B, seq=S, frames=shape.seq_len if audio else 0,
                                whole=whole, **bf16)
    runs[f"{arch}_bf16"]["case_s"] = time.perf_counter() - t_case
    t_case = time.perf_counter()
    del params, w_grads, batch
    torch.cuda.empty_cache()

    # f32: two steps of the whole-tensor step and of each partitioned one
    cfg = depth(f32_layers, dtype="float32")
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(1)
    batches = [train.make_batch(cfg, B, S, rng, dev) for _ in range(2)]
    p1 = _tree_to(params, dev)
    o1 = adamw_init(p1)
    want = []
    for bt in batches:
        p1, o1, info = steps.build_train_step(cfg)(p1, o1, bt)
        want.append((float(info["loss"]), float(info["grad_norm"]), _tree_to(p1, "cpu")))
    del p1, o1
    f32 = {}
    for mshape in meshes:
        tag = f"{mshape[0]}x{mshape[1]}"
        mesh = GangMesh([dev] * 4, mshape, ("data", "model"))
        sp, so, _ = _pt_shards(cfg, params, mesh, clone=True)
        row, got = {}, []
        for bt in batches:
            b = _pt_batch(cfg, mesh, bt)
            with _routes() as rank_routes:
                sp, so, info = steps.build_train_step(cfg)(sp, so, b)
            got.append((float(info["loss"]), float(info["grad_norm"]),
                        partition.unshard_tree(sp),
                        _joined_routes(rank_routes, mesh, partition._train_plan(cfg, sp, b))
                        if moe else None))
        base = want
        if moe:
            # the whole-tensor steps routed as the partitioned ones were
            p1 = _tree_to(params, dev)
            o1 = adamw_init(p1)
            base = []
            for bt, (*_, routes) in zip(batches, got):
                with _replaying(routes):
                    p1, o1, info = steps.build_train_step(cfg)(p1, o1, bt)
                base.append((float(info["loss"]), float(info["grad_norm"]), _tree_to(p1, "cpu")))
            del p1, o1
        for i, (loss, norm, gp, _) in enumerate(got):
            wl, wn, wp = base[i]
            for what, g_, w_ in (("loss", loss, wl), ("grad_norm", norm, wn)):
                if not abs(g_ - w_) <= TRAIN_TOL * abs(w_):
                    raise AssertionError(f"partition_train: {arch} f32 on {tag} step {i}: "
                                         f"{what} {g_} against {w_}")
            worst, off = _params_close(gp, wp)
            row[f"step{i + 1}"] = dict(loss=loss, loss_rel_err=abs(loss - wl) / abs(wl),
                                       grad_norm_rel_err=abs(norm - wn) / abs(wn),
                                       params_max_abs_err=worst, params_outside_tol=off)
        f32[tag] = row
        del sp, so, got, base
        torch.cuda.empty_cache()
    runs[f"{arch}_f32"] = dict(layers=cfg.num_layers, batch=B, seq=S, tol=TRAIN_TOL, **f32,
                               case_s=time.perf_counter() - t_case)
    del params, batches, want
    torch.cuda.empty_cache()
    return runs


def phase_partition_train(torch, dev, smi):
    """The partitioned FSDP train step (module doc, 21)."""
    t0 = time.perf_counter()
    runs = _pt_case(torch, dev, "mistral_7b", PT_LAYERS, PT_F32_LAYERS, PT_MESHES,
                    account=True)
    _say("partition_train", nvidia_smi=smi, account_tol=ACCOUNT_TOL,
         cut=f"{PT_LAYERS} of 32 layers "
         f"(bf16; f32 {PT_F32_LAYERS}): the whole-tensor and the partitioned step each hold "
         "their own weights and moments", loss_tol=PT_LOSS_TOL, rel_tol=PARTITION_REL_TOL,
         runs=runs, launches=dict.fromkeys(_counters(), 0),
         phase_s=time.perf_counter() - t0)
    return dict.fromkeys(_counters(), 0)


def phase_partition_moe(torch, dev, smi):
    """The moe family's partitioned steps (module doc, 22)."""
    t0 = time.perf_counter()
    runs, launches = {}, dict.fromkeys(_counters(), 0)
    for name, arch, layers, dtype, meshes in (
            ("olmoe_1b_7b_bf16", "olmoe_1b_7b", PM_LAYERS, "bfloat16", PM_MESHES),
            ("olmoe_1b_7b_f32", "olmoe_1b_7b", PM_F32_LAYERS, "float32", PM_MESHES),
            ("llama4_maverick_400b_a17b_bf16", "llama4_maverick_400b_a17b",
             PM_LLAMA4_LAYERS, "bfloat16", ((1, 4),))):
        runs[name], counts = _partition_case(torch, dev, arch, layers, dtype, meshes)
        for k, v in counts.items():
            launches[k] += v
    runs["train"] = _pt_case(torch, dev, "olmoe_1b_7b", PM_TRAIN_LAYERS,
                             PM_TRAIN_F32_LAYERS, PT_MESHES, profile=False)
    _say("partition_moe", nvidia_smi=smi, rel_tol=PARTITION_REL_TOL,
         f32_tol=PARTITION_F32_TOL, loss_tol=PT_LOSS_TOL,
         cut=f"llama4_maverick_400b_a17b {PM_LLAMA4_LAYERS} of 48 layers; olmoe_1b_7b's "
         f"bf16 serving run {PM_LAYERS} of 16, its train step {PM_TRAIN_LAYERS} of 16 (f32 {PM_TRAIN_F32_LAYERS}), its f32 serving "
         f"run {PM_F32_LAYERS}", runs=runs, launches=launches,
         phase_s=time.perf_counter() - t0)
    return launches


@contextlib.contextmanager
def _dropping_model_partial(shape):
    """Within: a gradient sum over "model" of a leaf of `shape`
    (`partition.loss_and_grads` psums it with grad mode off) leaves out the
    last model rank's partial."""
    from repro_torch.launch import partition
    psum = partition.Rank.psum

    def dropping(self, x, axes):
        if (not x.requires_grad and tuple(x.shape) == shape and "model" in axes
                and self.index("model") == self.size("model") - 1):
            x = x.new_zeros(x.shape)
        return psum(self, x, axes)
    partition.Rank.psum = dropping
    try:
        yield
    finally:
        partition.Rank.psum = psum


@contextlib.contextmanager
def _dropping_heads(cfg, mesh):
    """Within: the scan of the last model rank's heads gives y zeroed, so
    y's all-gather over the heads lacks them."""
    from repro_torch.models import mamba2
    scan = mamba2.mamba2_scan
    last = cfg.ssm_heads - cfg.ssm_heads // mesh.axis_size("model")

    def dropping(*a, heads=None, **kw):
        y, h = scan(*a, heads=heads, **kw)
        return (y.new_zeros(y.shape) if heads and heads[0] == last else y), h
    mamba2.mamba2_scan = dropping
    try:
        yield
    finally:
        mamba2.mamba2_scan = scan


@contextlib.contextmanager
def _dropping_entering_state():
    """Within: the sequence fallback's ranks keep their rows' scan from a
    zero state (`mamba2.enter_state` adds nothing)."""
    from repro_torch.models import mamba2
    enter = mamba2.enter_state
    mamba2.enter_state = lambda y, *a: y
    try:
        yield
    finally:
        mamba2.enter_state = enter


def _layer_rows_err(torch, cfg, params, mesh, pl, x):
    """Layer 0's Mamba2 block (`tp._mamba`) on every rank of `mesh` from
    one input x (B, S, d), the ranks' rows joined, against the whole
    layer's output (`model._mamba_layer`, B3): the largest ||got - want|| /
    ||want|| over the (batch, position) rows.  A row's output depends on
    the state entering its rank's piece, which a fast decay forgets within
    a few rows: the last token's logits cannot see that state, the first
    rows of every piece can."""
    from repro_torch.launch import partition
    from repro_torch.launch import shardings as shd
    from repro_torch.kernels.checks import rel_err
    from repro_torch.models import model as mdl
    from repro_torch.models import tp
    specs = shd.param_specs(cfg, params, mesh, fsdp=False)
    p = partition.shard_tree(params, specs, mesh)
    with torch.no_grad():
        want, _ = mdl._mamba_layer(cfg, params["layers"][0], x, impl="auto",
                                   write_cache=False)
        outs = partition.run_lockstep(mesh, lambda rk: tp._mamba(
            rk, cfg, pl, p.local[rk.rank]["layers"][0], specs["layers"][0],
            rk.local(rk.local(x, 0, pl.batch), 1, pl.seq), impl="auto")[0])
    got = partition._join(shd.P(pl.batch, pl.seq), outs, mesh)
    return rel_err(got[..., None], want[..., None].float())


def _ssm_caches(cache, S):
    """Copies of an ssm or hybrid cache's prefill state: conv, ssm, and the
    shared block's first S positions of sh_k / sh_v."""
    out = {"conv": cache["ssm"].conv.clone(), "ssm": cache["ssm"].ssm.clone()}
    out.update({k: cache[k][:, :, :, :S].clone() for k in ("sh_k", "sh_v") if k in cache})
    return out


def _ssm_cache_errs(got, want):
    """||got - want|| / ||want|| of each `_ssm_caches` tensor per (layer,
    batch row, head), and of the SSM state per (layer, batch row) over
    every head (`ssm_row`: the state one layer of one sequence hands the
    next token)."""
    from repro_torch.kernels.checks import rel_err
    out = {k: rel_err(got[k].flatten(0, 1), want[k].flatten(0, 1).float()) for k in want}
    out["ssm_row"] = rel_err(got["ssm"].flatten(2), want["ssm"].flatten(2).float())
    return out


def _partition_ssm_case(torch, dev, arch, layers, dtype, meshes):
    """One ssm or hybrid model at full width, `layers` deep, in `dtype`:
    the unpartitioned prefill (B3, B1) and PARTITION_STEPS greedy serve
    steps (B2), then per mesh shape the same from shards of the same
    weights on ranks that share the card: launches exact (B3 layers x
    ranks, B1 shared-block uses x ranks per prefill, none in a serve step),
    the prefill's logits, conv state and shared-block K/V per (layer, row,
    head), its SSM state per (layer, row) and each serve step's logits
    against the unpartitioned run (the SSM state per head reported: a head
    whose decay forgets all but a few tokens keeps a tiny state, f32's
    rounding of its log-decay ~|dt·A| x 64 per chunk reads 1e-4 of it, and
    in bf16 the readings of the plain versions' unpartitioned prefill, the
    yardstick of one more rounding, reach 0.2 per head and 0.1 per row at
    zamba2's 54 layers: bf16 holds the state per row to the larger of the
    limit and that yardstick; the first token reported, one more rounding
    may flip a near tie), the collective bytes
    against the dry run's (bf16), and on the first mesh in bf16 the
    planted fault of its scan layout: the last rank's heads dropped from
    y's all-gather (the prefill's logits); in the sequence fallback every
    row of layer 0's output against the whole layer's (`_layer_rows_err`),
    and in bf16 the entering state dropped there."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.checks import rel_err
    from repro_torch.launch import dryrun, partition, steps
    from repro_torch.launch import shardings as shd
    from repro_torch.models import init_cache, init_params, tp
    from repro_torch.sp.common import GangMesh

    t_case = time.perf_counter()
    bf16 = dtype == "bfloat16"
    tol = PARTITION_REL_TOL if bf16 else PARTITION_F32_TOL
    B, S, N, C = PARTITION_BATCH, PARTITION_PROMPT, PS_STEPS, PARTITION_CACHE
    cfg = dataclasses.replace(get_config(arch), num_layers=layers, dtype=dtype)
    uses = layers // cfg.attn_every if cfg.family == "hybrid" else 0
    V = cfg.vocab_size
    pre = ShapeConfig(f"prefill_{B}x{S}", S, B, "prefill")
    dec = ShapeConfig(f"decode_{B}x{C}", C, B, "decode")
    params = init_params(cfg, seed=0, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(5)).to(dev)
    prefill, serve = steps.build_prefill_step(cfg, pre), steps.build_serve_step(cfg, dec)
    cache = init_cache(cfg, B, C, device=dev)
    (lg, cache), pre_s, counts = _run_counted(
        torch, lambda: prefill(params, {"tokens": toks}, cache))
    _expect("partition_ssm", f"{arch} unpartitioned ssd_scan per prefill",
            counts["ssd_scan"], layers)
    _expect("partition_ssm", f"{arch} unpartitioned flash_attention per prefill",
            counts["flash_attention"], uses)
    ref = _ssm_caches(cache, S)
    limits = dict.fromkeys(("conv", "sh_k", "sh_v", "ssm_row"), tol)
    yardstick = {}
    if bf16:
        c = init_cache(cfg, B, C, device=dev)
        lg_plain, c = steps.build_prefill_step(cfg, pre, impl="torch")(
            params, {"tokens": toks}, c)
        yardstick = dict(_ssm_cache_errs(_ssm_caches(c, S), ref),
                         logits=rel_err(lg_plain[None, :, :V], lg[None, :, :V].float()))
        limits["ssm_row"] = max(tol, yardstick["ssm_row"])
        del c, lg_plain

    def greedy():
        out, last = [], lg
        for _ in range(N):
            tok = last.argmax(-1)
            last, _ = serve(params, cache, tok)
            out.append((tok, last))
        return out
    want, dec_s, dc = _run_counted(torch, greedy)
    _expect("partition_ssm", f"{arch} unpartitioned flash_decode over {N} steps",
            dc["flash_decode"], uses * N)
    launches = {k: counts[k] + dc[k] for k in counts}
    del cache
    res = dict(arch=arch, dtype=dtype, layers=layers, shared_block_uses=uses, batch=B,
               prompt=S, cache_len=C, steps=N, tol=tol, limits=limits,
               plain_vs_kernels=yardstick,
               unpartitioned=dict(prefill_s=pre_s, decode_ms_per_step=1e3 * dec_s / N))
    for shape in meshes:
        n = shape[0] * shape[1]
        mesh = GangMesh([dev] * n, shape, ("data", "model"))
        tag = f"{shape[0]}x{shape[1]}"
        pl = tp.plan(cfg, mesh, batch=B, seq=S, long_context=False)
        layout = "heads" if pl.ssd_heads else "rows" if pl.ssd_rows else "whole"

        def shards(mesh):
            pspecs = shd.param_specs(cfg, params, mesh,
                                     fsdp=shd.needs_fsdp(cfg, mesh, "prefill"))
            c = init_cache(cfg, B, C, device=dev)
            cspecs = shd.cache_specs(cfg, c, mesh, global_batch=B)
            return (partition.shard_tree(params, pspecs, mesh),
                    partition.shard_tree({"tokens": toks}, shd.batch_specs(cfg, pre, mesh),
                                         mesh),
                    partition.shard_tree(c, cspecs, mesh),
                    shd.per_device_bytes(params, pspecs, mesh)
                    + shd.per_device_bytes(c, cspecs, mesh))
        p, b, c, rank_bytes = shards(mesh)
        torch.cuda.reset_peak_memory_stats()
        mesh.reset_bytes()
        (lg_s, c), p_pre_s, pc = _run_counted(torch, lambda: prefill(p, b, c))
        pre_bytes = dict(mesh.collective_bytes[0])
        _expect("partition_ssm", f"{arch} {tag} ssd_scan per prefill", pc["ssd_scan"],
                layers * n)
        _expect("partition_ssm", f"{arch} {tag} flash_attention per prefill",
                pc["flash_attention"], uses * n)
        got = partition.unshard_tree(lg_s)
        caches = _ssm_caches(partition.unshard_tree(c), S)
        tspec = shd.batch_specs(cfg, dec, mesh)["token"]
        step_bytes = []

        def run(c=c):
            out, last = [], got
            for i in range(N):
                # bf16 teacher-forced by the unpartitioned tokens; f32 greedy
                tok = want[i][0] if bf16 else last.argmax(-1)
                mesh.reset_bytes()
                lg_i, c = serve(p, c, partition.shard_tree(tok, tspec, mesh))
                step_bytes.append(dict(mesh.collective_bytes[0]))
                last = partition.unshard_tree(lg_i)
                out.append((tok, last))
            return out
        out, p_dec_s, sc = _run_counted(torch, run)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        for k in sc:
            _expect("partition_ssm", f"{arch} {tag} {k} over {N} steps", sc[k], 0)
        logits_err = rel_err(got[None, :, :V], lg[None, :, :V].float())
        cache_errs = _ssm_cache_errs(caches, ref)
        del caches
        errs = _rel_norms(out, want, V)
        steps_same, rows_same = _same_tokens(out, want)
        first_same = bool(torch.equal(got.argmax(-1), lg.argmax(-1)))
        fails = []
        if (max([logits_err] + errs) > tol
                or any(cache_errs[k] > lim for k, lim in limits.items() if k in cache_errs)):
            fails.append(f"logits {logits_err:.3e}, caches {cache_errs}, serve steps "
                         f"{max(errs):.3e} against the limits {tol}, {limits}")
        if not bf16 and steps_same != N:
            fails.append(f"the same greedy tokens in {steps_same} of {N} steps")
        if any(sb != step_bytes[0] for sb in step_bytes):
            fails.append("the serve steps moved different collective bytes")
        row = dict(mesh=dict(mesh.shape), scan_layout=layout, first_token_same=first_same,
                   prefill_logits_rel_err=logits_err, cache_rel_err=cache_errs,
                   serve_rel_err_max=max(errs), steps_tokens_same=steps_same,
                   rows_tokens_same=rows_same, prefill_s=p_pre_s,
                   decode_ms_per_step=1e3 * p_dec_s / N, card_peak_gb=peak_gb,
                   rank_argument_gb=rank_bytes / 1e9,
                   collective_bytes=dict(prefill=pre_bytes, serve_step=step_bytes[0]))
        if bf16:
            t_dry = time.perf_counter()
            recs = {"prefill": dryrun.collective_bytes(cfg, pre, mesh, max_len=C),
                    "serve_step": dryrun.collective_bytes(cfg, dec, mesh)}
            row["dry_run_count_s"] = time.perf_counter() - t_dry
            row["dry_run_collectives_equal"] = recs == row["collective_bytes"]
            if not row["dry_run_collectives_equal"]:
                fails.append(f"collective bytes on the card {row['collective_bytes']} "
                             f"against the dry run's {recs}")
        if layout == "rows":
            # every row of layer 0's output, whose first rows in each
            # rank's piece read the state entering it
            x0 = params["embed"][toks].to(getattr(torch, dtype))
            row["layer0_rows_rel_err"] = _layer_rows_err(torch, cfg, params, mesh, pl, x0)
            if row["layer0_rows_rel_err"] > tol:
                fails.append(f"layer 0's rows {row['layer0_rows_rel_err']:.3e} against "
                             f"the limit {tol}")
            if bf16:
                with _dropping_entering_state():
                    row["dropped_entering_state_rel_err"] = _layer_rows_err(
                        torch, cfg, params, mesh, pl, x0)
                if row["dropped_entering_state_rel_err"] <= tol:
                    fails.append(f"layer 0's rows without the entering state read "
                                 f"{row['dropped_entering_state_rel_err']:.3e}, inside "
                                 "the limit")
            del x0
        if bf16 and shape == meshes[0] and layout == "heads":
            fp, fb, fc, _ = shards(mesh)
            with _dropping_heads(cfg, mesh):
                fault = partition.unshard_tree(prefill(fp, fb, fc)[0])
            row["dropped_heads_rel_err"] = rel_err(fault[None, :, :V], lg[None, :, :V].float())
            del fp, fb, fc, fault
            if row["dropped_heads_rel_err"] <= tol:
                fails.append(f"a prefill without the last rank's heads in y reads "
                             f"{row['dropped_heads_rel_err']:.3e}, inside the limit")
        for k in launches:
            launches[k] += pc[k] + sc[k]
        res[tag] = row
        del p, b, c, lg_s, got, out
        torch.cuda.empty_cache()
        if fails:
            raise AssertionError(f"partition_ssm: {arch} {dtype} on {tag}: " + "; ".join(fails)
                                 + f" (readings: {json.dumps(row, default=str)[:3000]})")
    del params, want, ref, lg
    torch.cuda.empty_cache()
    res["case_s"] = time.perf_counter() - t_case
    return res, launches


def phase_partition_ssm(torch, dev, smi):
    """The ssm and hybrid families' partitioned steps (module doc, 23)."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    runs, launches = {}, dict.fromkeys(_counters(), 0)
    cases = []
    for arch in ("mamba2_130m", "zamba2_2_7b"):
        cases += [(f"{arch}_bf16", arch, PS_LAYERS[arch], "bfloat16", PM_MESHES),
                  (f"{arch}_f32", arch, PS_F32_LAYERS[arch], "float32", PM_MESHES)]
    cases += [(f"mamba2_130m_rows_{dt}", "mamba2_130m", PS_ROWS_LAYERS, dt, (PS_ROWS_MESH,))
              for dt in ("bfloat16", "float32")]
    for name, arch, layers, dtype, meshes in cases:
        runs[name], counts = _partition_ssm_case(torch, dev, arch, layers, dtype, meshes)
        for k, v in counts.items():
            launches[k] += v
    runs["train"] = dict(
        **_pt_case(torch, dev, "zamba2_2_7b", PS_TRAIN_LAYERS, PS_TRAIN_LAYERS, PT_MESHES,
                   profile=False, model_psum_fault="in_proj"),
        **_pt_case(torch, dev, "mamba2_130m", PS_SSM_TRAIN_LAYERS, 1, PT_MESHES,
                   profile=False))
    _say("partition_ssm", nvidia_smi=smi, rel_tol=PARTITION_REL_TOL,
         f32_tol=PARTITION_F32_TOL, loss_tol=PT_LOSS_TOL,
         cut=f"bf16 serving runs at {PS_LAYERS} layers, f32 at {PS_F32_LAYERS}; the "
         f"sequence fallback at "
         f"{PS_ROWS_LAYERS} of 24; zamba2_2_7b's train step {PS_TRAIN_LAYERS} of 54 "
         f"(one segment; f32 the same), mamba2_130m's {PS_SSM_TRAIN_LAYERS} of 24 (f32 1)",
         runs=runs, launches=launches, phase_s=time.perf_counter() - t0)
    return launches


@contextlib.contextmanager
def _detaching_encoder():
    """Within: every decoder layer (`tp._dec_layer`) reads the encoder's
    output detached, so no gradient reaches the encoder."""
    from repro_torch.models import tp
    layer = tp._dec_layer

    def detaching(rk, cfg, pl, p, ps, x, enc, *a, **kw):
        return layer(rk, cfg, pl, p, ps, x, enc.detach(), *a, **kw)
    tp._dec_layer = detaching
    try:
        yield
    finally:
        tp._dec_layer = layer


@contextlib.contextmanager
def _dropping_encoder_partial(frames, d):
    """Within: the last model rank's partial left out of the first encoder
    all-reduce (layer 0's wo sum, (b, frames, d)) of every rank."""
    import threading

    from repro_torch.launch import partition
    psum, seen, lock = partition.Rank.psum, set(), threading.Lock()

    def dropping(self, x, axes):
        if tuple(x.shape[1:]) == (frames, d) and "model" in axes:
            with lock:
                first = self.rank not in seen
                seen.add(self.rank)
            if first and self.index("model") == self.size("model") - 1:
                x = x.new_zeros(x.shape)
        return psum(self, x, axes)
    partition.Rank.psum = dropping
    try:
        yield seen
    finally:
        partition.Rank.psum = psum


@contextlib.contextmanager
def _dropping_cross_slice(cross_k):
    """Within: the serve step's cross decode over `cross_k`'s storage (a
    sharded cross cache) leaves the last rank's slice out of the merge
    (its keys masked in its partial)."""
    from repro_torch.models import tp
    decode, hits = tp.distributed_decode_local, []

    def dropping(q, k, v, lens, **kw):
        if k[0].untyped_storage().data_ptr() == cross_k.untyped_storage().data_ptr():
            hits.append(1)
            lens = lens[:-1] + [lens[-1].new_zeros(lens[-1].shape)]
        return decode(q, k, v, lens, **kw)
    tp.distributed_decode_local = dropping
    try:
        yield hits
    finally:
        tp.distributed_decode_local = decode


def _first_tokens(got, want):
    """The greedy tokens of logits `got` against `want` (rows, vocab): rows
    whose argmax agrees, and whether it agrees in every row whose margin in
    `want` (top-1 minus top-2) exceeds twice the row's largest |got -
    want|, where no rounding of that size can reorder the top two (a row
    under that margin is a near tie: its token is reported, not held)."""
    top2 = want.float().topk(2, -1).values
    margin = top2[:, 0] - top2[:, 1]
    moved = (got.float() - want.float()).abs().amax(-1)
    same = got.argmax(-1) == want.argmax(-1)
    clear = margin > 2 * moved
    return dict(rows_same=int(same.sum()), rows=int(same.numel()),
                clear_rows=int(clear.sum()), clear_rows_same=bool(same[clear].all()),
                margins=margin.tolist(), max_logit_moves=moved.tolist())


def _audio_caches(cache, S):
    """Copies of an audio cache's prefill state: the self K/V's first S
    positions, the cross K/V."""
    out = {k: cache[k][:, :, :, :S].clone() for k in ("k", "v")}
    out.update({k: cache[k].clone() for k in ("cross_k", "cross_v")})
    return out


def _partition_audio_case(torch, dev, layers, dtype, meshes):
    """seamless_m4t_large_v2 at full width, `layers` encoder and decoder
    layers, in `dtype`: the unpartitioned prefill of PARTITION_BATCH x
    PA_FRAMES frames and a BOS token (B1) and PS_STEPS greedy serve steps
    (B2), then per mesh shape the same from shards of the same weights on
    ranks that share the card: launches exact (B1 (encoder + 2 x decoder
    layers) x ranks per prefill, no kernel in a serve step), the prefill's
    logits, its self and cross K/V per (layer, row, head) and each serve
    step's logits against the unpartitioned run (bf16: the first token
    equal; f32: every token), the collective bytes against the dry run's
    (bf16), and on the first mesh in bf16 the planted faults: the last
    model rank's partial dropped from the first encoder all-reduce (the
    prefill's logits) and the last rank's slice of the cross cache dropped
    from PARTITION_FAULT_STEPS serve steps' merge; a profiled serve step."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.checks import rel_err
    from repro_torch.launch import dryrun, partition, steps
    from repro_torch.launch import shardings as shd
    from repro_torch.models import init_cache, init_params
    from repro_torch.sp.common import GangMesh

    t_case = time.perf_counter()
    bf16 = dtype == "bfloat16"
    tol = PARTITION_REL_TOL if bf16 else PARTITION_F32_TOL
    B, F, N, C = PARTITION_BATCH, PA_FRAMES, PS_STEPS, steps.AUDIO_SELF_CACHE
    cfg = dataclasses.replace(get_config("seamless_m4t_large_v2"), num_layers=layers,
                              encoder_layers=layers, dtype=dtype)
    V, kinds = cfg.vocab_size, cfg.encoder_layers + 2 * cfg.num_layers
    pre = ShapeConfig(f"prefill_{B}x{F}", F, B, "prefill")
    dec = ShapeConfig(f"decode_{B}x{F}", F, B, "decode")
    params = init_params(cfg, seed=0, device=dev)
    g = torch.Generator().manual_seed(5)
    batch = {"tokens": torch.randint(0, V, (B, 1), generator=g).to(dev),
             "frames": torch.randn((B, F, cfg.d_model), generator=g).to(
                 dev, getattr(torch, dtype))}
    prefill, serve = steps.build_prefill_step(cfg, pre), steps.build_serve_step(cfg, dec)
    cache = init_cache(cfg, B, C, enc_len=F, device=dev)
    (lg, cache), pre_s, counts = _run_counted(torch, lambda: prefill(params, batch, cache))
    _expect("partition_audio", f"unpartitioned {dtype} flash_attention per prefill",
            counts["flash_attention"], kinds)
    ref = _audio_caches(cache, 1)

    def greedy():
        out, last = [], lg
        for _ in range(N):
            tok = last.argmax(-1)
            last, _ = serve(params, cache, tok)
            out.append((tok, last))
        return out
    want, dec_s, dc = _run_counted(torch, greedy)
    _expect("partition_audio", f"unpartitioned {dtype} flash_decode over {N} steps",
            dc["flash_decode"], 2 * cfg.num_layers * N)
    launches = {k: counts[k] + dc[k] for k in counts}
    del cache
    res = dict(arch="seamless_m4t_large_v2", dtype=dtype, encoder_layers=layers,
               decoder_layers=layers, batch=B, frames=F, self_cache=C, steps=N, tol=tol,
               unpartitioned=dict(prefill_s=pre_s, decode_ms_per_step=1e3 * dec_s / N))
    if bf16:
        # the yardstick of one more rounding: the unpartitioned prefill on
        # the plain versions (impl "torch") against the kernels'
        c = init_cache(cfg, B, C, enc_len=F, device=dev)
        lg_plain, c = steps.build_prefill_step(cfg, pre, impl="torch")(params, batch, c)
        res["plain_vs_kernels"] = dict(
            prefill_logits_rel_err=rel_err(lg_plain[None, :, :V], lg[None, :, :V].float()),
            first_token=_first_tokens(lg_plain[:, :V], lg[:, :V]))
        del c, lg_plain
    for shape in meshes:
        n = shape[0] * shape[1]
        mesh = GangMesh([dev] * n, shape, ("data", "model"))
        tag = f"{shape[0]}x{shape[1]}"

        def shards(mesh):
            pspecs = shd.param_specs(cfg, params, mesh,
                                     fsdp=shd.needs_fsdp(cfg, mesh, "prefill"))
            c = init_cache(cfg, B, C, enc_len=F, device=dev)
            cspecs = shd.cache_specs(cfg, c, mesh, global_batch=B)
            return (partition.shard_tree(params, pspecs, mesh),
                    partition.shard_tree(batch, shd.batch_specs(cfg, pre, mesh), mesh),
                    partition.shard_tree(c, cspecs, mesh),
                    shd.per_device_bytes(params, pspecs, mesh)
                    + shd.per_device_bytes(c, cspecs, mesh), c)
        p, b, c, rank_bytes, whole_c = shards(mesh)
        torch.cuda.reset_peak_memory_stats()
        mesh.reset_bytes()
        (lg_s, c), p_pre_s, pc = _run_counted(torch, lambda: prefill(p, b, c))
        pre_bytes = dict(mesh.collective_bytes[0])
        _expect("partition_audio", f"{dtype} {tag} flash_attention per prefill",
                pc["flash_attention"], kinds * n)
        got = partition.unshard_tree(lg_s)
        caches = _audio_caches(partition.unshard_tree(c), 1)
        tspec = shd.batch_specs(cfg, dec, mesh)["token"]
        step_bytes = []

        def run(c=c):
            out, last = [], got
            for i in range(N):
                # bf16 teacher-forced by the unpartitioned tokens; f32 greedy
                tok = want[i][0] if bf16 else last.argmax(-1)
                mesh.reset_bytes()
                lg_i, c = serve(p, c, partition.shard_tree(tok, tspec, mesh))
                step_bytes.append(dict(mesh.collective_bytes[0]))
                last = partition.unshard_tree(lg_i)
                out.append((tok, last))
            return out
        out, p_dec_s, sc = _run_counted(torch, run)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        for k in sc:
            _expect("partition_audio", f"{dtype} {tag} {k} over {N} steps", sc[k], 0)
        logits_err = rel_err(got[None, :, :V], lg[None, :, :V].float())
        cache_errs = {k: rel_err(caches[k].flatten(0, 1), ref[k].flatten(0, 1).float())
                      for k in ref}
        del caches
        errs = _rel_norms(out, want, V)
        steps_same, rows_same = _same_tokens(out, want)
        first = _first_tokens(got[:, :V], lg[:, :V])
        first_same = first["rows_same"] == B
        fails = []
        if max([logits_err] + errs + list(cache_errs.values())) > tol:
            fails.append(f"logits {logits_err:.3e}, caches {cache_errs}, serve steps "
                         f"{max(errs):.3e} against the limit {tol}")
        if bf16 and not first["clear_rows_same"]:
            fails.append(f"the first token differs in a row whose margin is clear: {first}")
        if not bf16 and steps_same != N:
            fails.append(f"the same greedy tokens in {steps_same} of {N} steps")
        if any(sb != step_bytes[0] for sb in step_bytes):
            fails.append("the serve steps moved different collective bytes")
        row = dict(mesh=dict(mesh.shape), first_token_same=first_same, first_token=first,
                   prefill_logits_rel_err=logits_err, cache_rel_err=cache_errs,
                   serve_rel_err_max=max(errs), steps_tokens_same=steps_same,
                   rows_tokens_same=rows_same, prefill_s=p_pre_s,
                   decode_ms_per_step=1e3 * p_dec_s / N, card_peak_gb=peak_gb,
                   rank_argument_gb=rank_bytes / 1e9,
                   collective_bytes=dict(prefill=pre_bytes, serve_step=step_bytes[0]))
        if bf16:
            t_dry = time.perf_counter()
            recs = {"prefill": dryrun.collective_bytes(cfg, pre, mesh, max_len=C),
                    "serve_step": dryrun.collective_bytes(cfg, dec, mesh)}
            row["dry_run_count_s"] = time.perf_counter() - t_dry
            row["dry_run_collectives_equal"] = recs == row["collective_bytes"]
            if not row["dry_run_collectives_equal"]:
                fails.append(f"collective bytes on the card {row['collective_bytes']} "
                             f"against the dry run's {recs}")
            tok = partition.shard_tree(want[0][0], tspec, mesh)
            back = partition.Sharded([dict(t, len=t["len"] - 2) for t in c.local],
                                     c.specs, mesh)
            row["serve_step_profile"] = _profile_steps(torch, lambda: serve(p, back, tok), 2)
        if bf16 and shape == meshes[0]:
            fp, fb, fc, _, _ = shards(mesh)
            with _dropping_encoder_partial(F, cfg.d_model) as seen:
                fault = partition.unshard_tree(prefill(fp, fb, fc)[0])
            row["dropped_encoder_partial_rel_err"] = rel_err(fault[None, :, :V],
                                                             lg[None, :, :V].float())
            if len(seen) != n or row["dropped_encoder_partial_rel_err"] <= tol:
                fails.append(f"a prefill without the last model rank's partial of the first "
                             f"encoder all-reduce reads "
                             f"{row['dropped_encoder_partial_rel_err']:.3e}, inside the limit")
            del fp, fb, fc, fault
            # the same shards fed the unpartitioned tokens from the prompt's
            # length on, their cross decode without the last rank's slice
            fc = partition.Sharded([dict(t, len=torch.ones_like(t["len"])) for t in c.local],
                                   c.specs, mesh)
            fault_out = []
            with _dropping_cross_slice(whole_c["cross_k"]) as hits:
                for i in range(PARTITION_FAULT_STEPS):
                    lg_f, fc = serve(p, fc, partition.shard_tree(want[i][0], tspec, mesh))
                    fault_out.append((want[i][0], partition.unshard_tree(lg_f)))
            row["dropped_cross_slice_rel_err"] = _rel_norms(fault_out, want, V)
            del fc, fault_out
            if (len(hits) != PARTITION_FAULT_STEPS * cfg.num_layers
                    or min(row["dropped_cross_slice_rel_err"]) <= tol):
                fails.append(f"serve steps whose cross decode drops the last rank's slice "
                             f"read {row['dropped_cross_slice_rel_err']}, inside the limit")
        for k in launches:
            launches[k] += pc[k] + sc[k]
        res[tag] = row
        del p, b, c, lg_s, got, out, whole_c
        torch.cuda.empty_cache()
        if fails:
            raise AssertionError(f"partition_audio: {dtype} on {tag}: " + "; ".join(fails)
                                 + f" (readings: {json.dumps(row, default=str)[:3000]})")
    del params, want, ref, lg
    torch.cuda.empty_cache()
    res["case_s"] = time.perf_counter() - t_case
    return res, launches


def phase_partition_audio(torch, dev, smi):
    """The audio family's partitioned steps (module doc, 24)."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    runs, launches = {}, dict.fromkeys(_counters(), 0)
    full = get_config("seamless_m4t_large_v2").num_layers
    for name, layers, dtype in (("seamless_m4t_large_v2_bf16", full, "bfloat16"),
                                ("seamless_m4t_large_v2_f32", PA_F32_LAYERS, "float32")):
        runs[name], counts = _partition_audio_case(torch, dev, layers, dtype, PM_MESHES)
        for k, v in counts.items():
            launches[k] += v
    runs["train"] = _pt_case(torch, dev, "seamless_m4t_large_v2", PA_TRAIN_LAYERS,
                             PA_TRAIN_LAYERS, PT_MESHES, profile=False)
    _say("partition_audio", nvidia_smi=smi, rel_tol=PARTITION_REL_TOL,
         f32_tol=PARTITION_F32_TOL, loss_tol=PT_LOSS_TOL,
         cut=f"f32 serving run at {PA_F32_LAYERS} + {PA_F32_LAYERS} layers; the train "
         f"step at {PA_TRAIN_LAYERS} + {PA_TRAIN_LAYERS} of 24 + 24 (f32 the same)",
         runs=runs, launches=launches, phase_s=time.perf_counter() - t0)
    return launches


def _spec_leaves(specs):
    """[(path, spec)] of a spec tree, in `param_leaves` order."""
    from repro_torch.launch.shardings import walk
    out = []
    walk(lambda path, spec, n: out.append((path, spec)), specs)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    # the dry run's matrix is host work on the meta device: it runs in a
    # process of its own from here to the dryrun phase, which waits for it
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        matrix_job = pool.apply_async(_matrix_job, (ROOT / "build" / "dryrun_torch",))
        return _phases(torch, smi, matrix_job)
    finally:
        pool.terminate()
        pool.join()


def _phases(torch, smi, matrix_job) -> int:
    """Every phase after the card's checks, in order (module doc), and the
    closing JSON lines."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import init_params

    dev = torch.device("cuda", 0)
    build_s = _build.build_all()
    ptxas = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln
                 or ("spill" in ln and "0 bytes spill stores, 0 bytes spill loads"
                     not in ln)]
             for n, log in _build.build_logs.items()}
    _say("build", build_s=build_s, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         nvidia_smi=smi, ptxas_registers=ptxas,
         b1_sass=_sass_counts(_build._lib_path("flash_attention")),
         b3_bf16_sass=_ssd_sass_counts(_build._lib_path("ssd_scan_tc")))
    print(smi.splitlines()[0], flush=True)

    rows = phase_kernels(torch, dev)
    cfg = get_config("mistral_7b")                 # full width and depth, bf16
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    _say("model", arch="mistral_7b", layers=cfg.num_layers, d_model=cfg.d_model,
         dtype=cfg.dtype, init_s=time.perf_counter() - t0,
         weights_gb=torch.cuda.memory_allocated() / 1e9)
    phase_engine(torch, dev, cfg, params)
    torch.cuda.empty_cache()
    launches = dict.fromkeys(_counters(), 0)
    launches.update(phase_serve(torch, dev, cfg, params))
    torch.cuda.empty_cache()
    phase_profile(torch, dev, cfg, params)
    del params
    torch.cuda.empty_cache()
    for phase in (phase_claims, phase_cluster, phase_overhead):
        for name, n in phase(torch, dev).items():
            launches[name] += n
        torch.cuda.empty_cache()
    for phase, arch, layers, cut in (
            ("ssm", "mamba2_130m", None, None),
            ("hybrid", "zamba2_2_7b", None, None),
            ("moe", "olmoe_1b_7b", None, None),
            ("audio", "seamless_m4t_large_v2", None, None),
            ("vlm", "internvl2_76b", 24,
             "24 of 80 layers: 80 are ~141 GB in bf16, over one card's 80 GB")):
        for name, n in phase_model(torch, dev, phase, arch, layers, cut).items():
            launches[name] += n
        torch.cuda.empty_cache()
    phase_invariant(torch, dev)
    torch.cuda.empty_cache()
    phase_train(torch, dev)
    torch.cuda.empty_cache()
    phase_train_lm(torch, dev)
    torch.cuda.empty_cache()
    for name, n in phase_ring(torch, dev).items():
        launches[name] += n
    torch.cuda.empty_cache()
    for name, n in phase_gang(torch, dev).items():
        launches[name] += n
    torch.cuda.empty_cache()
    for name, n in phase_dryrun(torch, dev, smi, matrix_job).items():
        launches[name] += n
    torch.cuda.empty_cache()
    for name, n in phase_partition(torch, dev, smi).items():
        launches[name] += n
    torch.cuda.empty_cache()
    for name, n in phase_partition_train(torch, dev, smi).items():
        launches[name] += n
    torch.cuda.empty_cache()
    for name, n in phase_partition_moe(torch, dev, smi).items():
        launches[name] += n
    torch.cuda.empty_cache()
    for name, n in phase_partition_ssm(torch, dev, smi).items():
        launches[name] += n
    torch.cuda.empty_cache()
    for name, n in phase_partition_audio(torch, dev, smi).items():
        launches[name] += n

    sources = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:85"),
               "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                                "src/repro/kernels/flash_decode.py:72"),
               "ssd_scan": ("src/repro_torch/csrc/ssd_scan_tc.cu",
                            "src/repro/kernels/ssd_kernel.py:74"),
               # no TPU kernel: the reference's one-hot einsum dispatch
               "moe_grouped_gemm": ("src/repro_torch/csrc/moe_grouped_gemm.cu",
                                    "src/repro/models/moe.py:83")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = rows[name]
        err = {"rel_err": r["rel_err"]} if "max_abs_err" not in r else {
            "max_abs_err": r["max_abs_err"]}
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces, launches=launches[name],
                            **err, ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
