#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc`` with
nvcc (sm_90a), then:

  1. device   — requires CUDA; prints the card's name and power limit;
  2. kernels  — holds each kernel against its plain PyTorch version on the
                card at the shapes of phases 3 and 5-9 (page gather/scatter
                and the tile copy bit-exact, the gather also as a masked
                read into an existing buffer; attention within 3e-5 where
                its output is f32, and where it is bf16 within bf16's
                rounding of the same result (never 2e-2), at max_len
                1024 and at the launcher's 256; at gemma3's: a 1500-token
                prefill with window 1024 and without, the same for its
                96-token prompt's f32 bucket 128, decode over 1024-slot
                rings whose positions have wrapped and over the 2048-slot
                global cache, these also with bf16 q over f32 K/V; at
                jamba's attention layer (32/8 heads), bf16 q over f32 K/V
                in decode and an all-bf16 500-token prefill; at
                gemma-7b's head dim 256: decode over its cache and prefill
                of a long and a short bucket in f32 and bf16; at
                deepseek-v2's MLA prefill, Dk 192 / Dv 128 over 128 heads,
                buckets 1024 and 64 in bf16 and f32; at olmoe's, a
                1024-bucket and a 64-bucket prefill and a ragged decode of
                8 rows (gemma-7b's, MLA's and olmoe's f32 bucket 64 and
                gemma3's bucket 128 must take the short form of the f32
                prefill, ``prefill_plan``'s form "short"; every prefill
                row prints its plan's form); every
                decode shape through the split-KV kernel in the form
                ``decode_layout`` gives it (each decode row prints its
                form, cluster size and CTAs, and is bit-equal call to
                call; tinyllama's and K3d's must take the cluster form,
                a cluster of splits combined through distributed shared
                memory); K4 against ``clone()`` in 8 alternating pairs of
                windows; and the decode
                kernel over int8 K/V with per-token, per-head scales, K3d,
                at tinyllama's, gemma3's ring and global and jamba's
                attention shapes, beside SDPA over K/V dequantised outside
                its timed window; at seamless-m4t's, the non-causal
                encoder over 4096 frames, cross attention (queries at
                2**29, frames at 0 or at 2**30 where masked) in prefill
                and decode, and the decoder's self-attention decode at
                G 1; at qwen2-vl's, an exact-length bf16 prefill whose
                temporal ids repeat over an image; at training's, B 8 x
                S 512 at tinyllama's heads in f32 under autograd (K3e:
                the forward within 3e-5; the backward kernel's dq/dk/dv
                each within 2x the f32 twin's own relative L2 gap to the
                twin in f64, bit-equal call to call), timed forward plus
                backward and the backward alone beside SDPA's; at
                the three published attention shapes of phase 26 (head
                dims 224 and 512, groups 1, 64 and 128) a prefill of
                bucket 1024 and a decode of 8 rows over T 1024, each in
                bf16 and in f32, and the decode also with bf16 q over
                f32 K/V (every dtype pair phase 26 launches)), the
                tile copy also on odd shapes, dtypes and sizes, and times
                kernel, plain version and one library call for the same
                function;
  3. serving  — full-width tinyllama-1.1b (random weights from a seed)
                through ``Engine``: 8 requests, 32 decode steps, a suspend
                wave of 4 sessions, one resume wave, decode to completion;
                a suspended-and-resumed request must yield exactly the
                tokens of the same request decoded uninterrupted, no resume
                may fail its checksums, the stats must add up, and every
                kernel's launch counter, reset just before the measured
                Engine and read after its last step, must equal what that
                run's stats and movement dispatches call for (a suspend
                or resume wave launches as one session does; and so be
                above 0);
  3b. tile_copy — every leaf of that Engine's live KV cache goes through a
                device->device ``movement`` transfer (the ``tile_copy`` leg,
                K4): each copy bit-exact and a new tensor, and K4's counter,
                reset just before, equal to the number of executes;
  4. numbers  — serving and per-kernel times, each tagged with the card
                (a kernel's, its plain version's and its library call's
                times, the host's time to run the wrapper included where it
                outlasts the L2 flush, as in every earlier run; beside
                them the kernel's and the library call's device time, that
                host time hidden behind a GPU sleep, and the host's us to
                queue one call), and a decode profile;
  5. launcher — ``python -m repro_torch.launch.serve`` (the scheduler over
                the Engine) at full width, once plain and once with
                ``--fork-prefix`` and ``--trace-out``: every job completes,
                the stats and the resume waves add up, no resume fails its
                checksums, each kernel's counter (reset before each run)
                equals what the run's stats call for, K4 is not launched,
                and the trace parses as Chrome trace JSON;
  6. gemma3   — full-width gemma3-27b cut to 14 layers (f32, 28.8 GB of
                random weights from a seed: the 62 layers, 108 GB, do not
                fit), sliding-window layers with 1024-slot ring caches:
                the Engine (4 slots, max_len 2048, prompts of 96-1500
                tokens, a suspend and a resume wave of the two longest;
                tokens must equal an uninterrupted run, no resume may fail
                its checksums, the stats must add up, each launch counter
                must equal what the stats call for), its numbers and a
                decode profile, then the Scheduler over a fresh Engine with
                prompts past the window (every job completes, resumes equal
                the resume waves' widths, the counters add up, K4 is not
                launched);
  7. gemma-7b — full width, 14 of its 28 layers (head dim 256, f32; cut to
                pay for phase 26), K3 at head dim 256: the Engine and the
                Scheduler, held as in phase 6;
  8. gemma3 62 layers — all of gemma3-27b with bf16 weights (54 GB) over
                the Engine's f32 cache: bf16 prefill, decode with bf16 q
                over f32 K/V; the Engine and the Scheduler, as in phase 6;
  9. qwen1.5  — qwen1.5-110b at full width with bf16 weights, cut to 8 of
                its 80 layers (26.8 GB; 80 are 222 GB): the Engine with one
                suspend and one resume wave;
  10. olmoe   — olmoe-1b-7b at full width, 8 of its 16 layers of attn_full
                + MoE (64 experts top-8; f32; cut to pay for phase 26):
                the Engine (8
                slots, prompts 16-700) and the Scheduler, as in phase 7;
                one decode batch run twice, each from its own copy of the
                same cache, must give bit-equal logits (the MoE combine is
                deterministic); a decode profile with the expert products'
                and the dispatch's device time;
  11. deepseek — deepseek-v2-236b at full width with bf16 weights over the
                Engine's f32 cache, cut to 8 of its 60 alike MLA + MoE
                layers (65.7 GB; fewer, at least 4, if the card's free
                memory says so): the Engine with one suspend and one resume
                wave; K3 runs its prefill at Dk 192 / Dv 128 and never
                decodes (MLA decodes through its absorbed einsums);
  12. int8 KV — full-width tinyllama-1.1b (f32) decodes 4 rows token by
                token through ``lm.decode_step`` for 256 teacher-forced
                steps from an empty cache, over an int8 cache (K3d, 22 x
                256 launches) and over an f32 one: each within 0.05 of the
                port's ``forward``, relative to its largest logit;
  13. rwkv6-7b — full width, 16 of its 32 layers (f32; cut to pay for
                phase 26): the
                Engine (4 slots, exact-length prompts of 16-500, a suspend
                and a resume wave of 17.3 MB state snapshots) and the
                Scheduler, as in phase 7; no K3;
  14. jamba   — jamba-v0.1-52b at full width with bf16 weights over the
                Engine's f32 cache, cut to 16 of its 32 layers (two periods
                of 7 mamba + 1 attention layer, 8 MoE layers of 16 experts
                top-2; 52.1 GB): the Engine with one suspend and one resume
                wave; K3's prefill at exact lengths and its decode equal
                the stats;
  15. seamless — seamless-m4t-medium at full width and depth (12 encoder
                and 12 decoder layers, f32, 3.9 GB) through its enc-dec
                path: ``lm.prefill`` of 4 prompts with 4096 random frame
                embeddings each, then 256 teacher-forced ``lm.decode_step``
                calls over the cached cross K/V, every logit within 1e-4
                of the cacheless ``lm.forward`` (relative to its largest),
                K3 launching 36 times a prefill and 24 a step;
  16. qwen2-vl — qwen2-vl-72b at full width with bf16 weights over the
                Engine's f32 cache, at least 32 of its 80 layers (as many
                as leave 10 GB of the card free): M-RoPE through the
                Engine (exact-length prompts, one suspend and one resume
                wave) and the Scheduler, as in phase 13, and an image
                prompt's ``lm.prefill`` at 3-part position ids, whose
                cache positions must be the temporal ids and whose logits
                must equal the cacheless ``lm.forward``'s;
  17. fleet   — full-width tinyllama-1.1b (f32, one 4.4 GB copy of the
                weights) as ``serve.cluster.Cluster`` replicas on the card:
                a migration wave of three routes (K2 out of one replica's
                pool, K1 into another's) with tokens equal to an
                uninterrupted fleet's and rows bit-equal to their sources;
                the launcher with --replicas 4 (migrating) and
                --no-migrate; chaos at --fault-rate 0.25 twice (equal
                ledgers) and --no-recovery; route faults between K2 and
                K1 with retries; a snapshot restore after a replica
                failure decoding the uninterrupted run's tokens, and a
                ClusterScheduler run surviving one.
  18. DRAM    — the paper's evaluation through the port's DRAM modules
                on the card, each part also on the CPU: Table 1 through
                ``execute_copy`` on a full-geometry DDR3_1600 bank (rows
                bit-equal, costs the spec's), bench_fig3_fig4's grid of 6
                configs x 50 workloads x 4096 requests as 300 lanes of one
                ``simulate_grid``, and the demo's trace cut to 8,192
                requests (to keep the run inside its time):
                VILLA hits and accesses equal to the CPU's, floats within
                1e-6, the paper's orderings;
  19. training — reduced tinyllama with tests/test_train_loop.py's recipe
                (40 steps, the loss falls, the first 10 losses those of the
                CPU port), then full-width tinyllama-1.1b in f32 through
                ``python -m repro_torch.launch.train`` (its state donated,
                updated in place) for 10 steps of 8 x 512 tokens, its peak
                memory, and a run
                checkpointed at step 5 and resumed whose params end
                bit-equal to the uninterrupted run's; K3's
                prefill launches layers x forward passes (K3e), again in
                each rep's recompute under the config's remat, its
                backward kernel layers x steps.
  20. mesh    — LISA's hop chains over a ``StackedAxis`` on the card, a
                hop one K2 launch over the stack viewed as 1 KiB rows:
                rbm_hop, lisa_copy (both ways, ring and linear chain) and
                lisa_broadcast over 8 FSDP shards of tinyllama-1.1b's f32
                weights (550 MB each), bit-equal to their oracles and the
                plain gather; the ring all-gather, reduce-scatter and
                all-reduce over 4 x 1 GiB, bit-equal to the CPU's run;
                the all-gather matmul at tinyllama's MLP width (1e-4);
                the compressed all-reduce of its embedding gradient
                (2e-2); ring attention over 8 x 2048 tokens at its heads
                within 3e-5 of K3's prefill; GPipe, 4 stages x 2 layers at
                D 2048 (1e-5 of the sequential run); the migration and
                fork plans over 4 replica pools, bit-exact; K2 and K1
                launches equal to the hops and the plans' page legs; the
                hop rows' times beside the byte bound, the plain gather
                and index_select; the NCCL route with two cards or more,
                else a line saying it did not run.
  21. sharded training — full-width tinyllama-1.1b in f32 (phase 19's
                seed, batch and OptConfig) trained MT_STEPS steps on a
                stacked 2 x 2 mesh (fsdp, tensor_parallel) and a 4 x 1 one
                through ``make_train_step(cfg, mesh, ...)``: step 1's loss
                and grad norm within rel 1e-5 of phase 19's, its params as
                tests/test_torch_train.py's _same_update against one
                single-device step, every loss within rel 1e-4; the 2 x 2
                state saved at step MT_SAVE and restored onto 4 x 1 (slices
                bit-equal to the saved arrays', the next steps within rel
                1e-5 of the uninterrupted run's); the launcher on a reduced
                2 x 2 mesh resumed bit-exactly there and onto 4 x 1; the
                elastic example; K2 launches == the axes' hops ==
                ``mesh_step_counts`` a step (the split compute's:
                model-split leaves gathered over data only, the model
                axis's reductions), K3 prefill == layers a step for
                the whole stack, K3e's backward kernel == layers a step;
                ms a step, the collectives' device ms
                beside their byte bound, peak memory; the NCCL route with
                two cards or more, else a line saying it did not run.
                With the config's remat: a stacked leaf gathered a rep at
                a time, again in the recompute, K3e twice a layer a step.
  22. split training — full-width tinyllama-1.1b in f32 (phase 19's seed
                and OptConfig) SP_STEPS donated steps on a stacked 1 x 4
                mesh with tensor parallelism and a 2 x 2 one with
                sequence parallelism, 8 x 512 a step with the config's
                remat (the reference's layout stores the MLP whole on each
                device at model 4: without remat 8 x 512 did not fit):
                step 1's loss and grad norm within rel 1e-5 of the single
                device's over the same rows, every loss within rel 1e-4;
                hops and reductions == ``mesh_step_counts``, K2 == the
                hops, K3e launches 44 a step for the whole stack and its
                backward kernel 22; ms a
                step, peak memory, one step profiled by op.
  23. mesh serving — ``make_prefill_step`` + SV_STEPS greedy
                ``make_serve_step`` decode steps over a laid-out cache:
                full-width tinyllama-1.1b in f32 on 2 x 2 and 1 x 4, and
                full-width, full-depth olmoe-1b-7b in f32 on 1 x 4
                (experts over model, each stored once), against the
                single-device ``lm.prefill``/``decode_step``, fed its
                greedy tokens: logits within SV_BAR (olmoe SV_MOE_BAR),
                greedy tokens equal but at ties (an MoE row whose routing
                moved at a near-tie left out, counted); K3's prefill route
                layers a prefill and its decode route layers a step for
                the whole stack, K2 == the hops; ms a prefill and a step,
                peak memory.
  24. split mesh serving — the same steps for MLA, rwkv, mamba and the
                enc-dec model split over model, at full width: deepseek-v2 bf16 (2
                layers) and rwkv6 f32 (full depth) on 1 x 2, jamba bf16
                (its first 5 layers, one rep of every kind) on 2 x 2,
                seamless-m4t-medium f32 (full depth, 1024 frames) on 1 x
                2; teacher-forced on the single device's tokens and MoE
                routing (where the mesh's own top-k differs, a near-tie);
                logits within SV_BAR, or where a run's rounding moves them
                further (bf16; rwkv's group norm), a relative L2 gap at
                most SS_RATIO x the single device's own to its weights in
                f32 or moved by one ulp; K3's launches what the layers
                call for, K2 == the hops; phase 2 times K3 at its
                local-head shapes.
  25. entry-point audit and live roofline — full-width tinyllama-1.1b in
                f32 at phase 3's slots and max_len: (a) every registered
                entry point (``repro_torch.analysis.entrypoints``: decode,
                each prefill bucket, suspend, suspend_many, resume,
                resume_many, a 2-replica Cluster's migrate route,
                simulate_params) audited on the card by one watched call:
                launches a call of each kernel as its contract says (a
                wave's as one call's), no device->host sync, its state in
                place (data pointers kept, no allocation of its size), no
                uint8 page widened; any finding fails; (b) each entry
                point once under torch.profiler: the cost model's flops
                and bytes (``roofline/cost.py``), its bound, device ms
                under kernels and, apart, under copies and sets, share =
                bound / kernel device ms (above 105% fails: the model
                counts work the call does not do), the dominant kernel
                and the device's busy share (``roofline/attribution.py``).
                Every profile here (phases 4-16, 21-22, 25) is
                ``attribution.capture``'s: a lead-in of one-element
                kernels takes the device records a profiling session
                drops at its start, the call runs in a marked region, and
                a launch of the region without its device record fails
                the run; each profile prints how many lead-in records
                were dropped.
  26. head shapes — tinyllama-1.1b at full width cut to HS_LAYERS layers
                with the attention of Zyphra/Zamba2-7B-Instruct (32 heads
                over 32 kv heads, head dim 224), deepseek-ai/
                DeepSeek-V4-Flash (64 over 1, head dim 512, window 128:
                layer 0 local, layer 1 global) and DeepSeek-V4-Pro (128
                over 1, head dim 512), each in f32 and in bf16 weights,
                through ``Engine`` (a suspend and a resume wave, tokens
                equal to the uninterrupted run's) and the Scheduler: every
                prefill and decode through K3 (head dim 224 padded into
                width 256; 512 at its own width, the prefill's groups cut
                into head slices), the launch counters equal to what the
                stats call for.

Each phase prints its wall time.  The last line of standard output is
``{"ok": true, "device": {...}}``; any failure exits non-zero before it.
Imports torch, numpy and repro_torch only.
"""
from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the card's peaks and K3's bounds live in the port's roofline layer
# (repro_torch/roofline/analysis.py, the one home of the H100's peaks)
from repro_torch.roofline.analysis import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S, PEAK_BF16_FLOPS as BF16_FLOP_PER_S,
    PEAK_F32_FLOPS as F32_FLOP_PER_S, PEAK_TF32_FLOPS)
from repro_torch.roofline.cost import attention_bound, tc_bound  # noqa: E402
SLEEP_CYCLES = 400_000           # ~0.2 ms of GPU sleep ahead of a timing
SLOTS, MAX_LEN, N_SESSIONS, SEED = 8, 1024, 32, 0
SERVE_LEN = 256                  # the launcher's --max-len in phase 5
PREFILL_BUCKETS = (16, 512)      # phase 2's tinyllama prefill rows
# phase 2's MLA rows: (bucket, prompt length) of deepseek-v2's prefill
MLA_BUCKETS = ((1024, 700), (64, 40))
# phase 6: gemma3-27b at full width, cut to 14 layers (two 6-layer periods
# and the 2-layer local tail, so both stages run): 7.19 B f32 parameters,
# 28.8 GB, where all 62 layers (27.0 B, 108 GB) do not fit in 80 GB
G_LAYERS, G_SLOTS, G_MAX_LEN, G_SESSIONS = 14, 4, 2048, 16
G_PROMPTS, G_MAX_NEW, G_FIRST = (96, 700, 1010, 1500), 48, 24
G_SCHED_LENS = (300, 1100)       # the Scheduler run's prompt lengths
# phase 7: gemma-7b at full width (head dim 256, MHA), cut to D7_LAYERS of
# its 28 layers (to pay for phase 26; at full depth 8.54 B f32 parameters,
# 34.2 GB); K/V take 32 KB a token a layer, so 4 slots at max_len 1024 hold
# 1.9 GB and a store of 8 sessions (and its fast tier of 2) 4.7 GB
D7_LAYERS, D7_SLOTS, D7_MAX_LEN, D7_SESSIONS = 14, 4, 1024, 8
D7_PROMPTS, D7_MAX_NEW, D7_FIRST = (40, 200, 333, 700), 48, 24
D7_SCHED_LENS = (100, 600)
# phase 8: gemma3-27b at all 62 layers, bf16 weights (54 GB) over the
# Engine's f32 cache: a max_len-2048 slot holds (10 x 2048 + 52 x 1024)
# token-layers x 16 KB = 1.21 GB, so 4 slots take 4.8 GB and the store 6
# sessions (and its fast tier of 2), 9.7 GB
G62_SESSIONS = 6
# phase 9: qwen1.5-110b at full width, bf16 weights, cut to 8 of 80 layers
# (13.4 B parameters, 26.8 GB)
Q_LAYERS, Q_SLOTS, Q_MAX_LEN, Q_SESSIONS = 8, 4, 1024, 8
Q_PROMPTS, Q_MAX_NEW, Q_FIRST = (24, 150, 400, 800), 24, 12
# phase 10: olmoe-1b-7b at full width (64 experts of which 8 a token, MHA
# 16/16, head dim 128), f32, cut to O_LAYERS of its 16 layers (to pay for
# phase 26; at full depth 6.92 B parameters, 27.7 GB); K/V take 16 KB a
# token a layer, so 8 slots at max_len 1024 hold 1.1 GB and a store of 16
# sessions (and its fast tier of 4) 2.7 GB
O_LAYERS, O_SLOTS, O_MAX_LEN, O_SESSIONS = 8, 8, 1024, 16
O_PROMPTS = (16, 40, 90, 150, 260, 380, 520, 700)
O_SHORT_PROMPT = 40             # phase 2's short-form row: bucket 64
O_MAX_NEW, O_FIRST = 32, 16
O_SCHED_LENS = (100, 600)
# phase 11: deepseek-v2-236b at full width, bf16 weights, cut to 8 of its
# 60 layers (3.97 B parameters a layer: 63.6 GB, 65.7 GB with the
# embedding and the head); its compressed cache takes 576 f32 a token a
# layer, 75 MB at 4 slots x 1024
DS_LAYERS, DS_MIN_LAYERS, DS_RESERVE = 8, 4, 8e9
DS_SLOTS, DS_MAX_LEN, DS_SESSIONS = 4, 1024, 8
DS_PROMPTS, DS_MAX_NEW, DS_FIRST = (24, 150, 400, 800), 24, 12
# phase 2's K3d rows and phase 12: tinyllama-1.1b at full width and depth
# (f32), I8_B rows decoded token by token for I8_STEPS teacher-forced steps
# from an empty cache, over an int8 cache and over an f32 one
I8_B, I8_STEPS = 4, 256
# phase 13: rwkv6-7b at full width, f32, cut to R_LAYERS of its 32 layers
# (to pay for phase 26; at full depth 7.53 B parameters, 30.1 GB); its
# state is 1.08 MB a session a layer, whatever the length
R_LAYERS, R_SLOTS, R_MAX_LEN, R_SESSIONS = 16, 4, 1024, 8
R_PROMPTS, R_MAX_NEW, R_FIRST = (16, 120, 300, 500), 24, 12
R_SCHED_LENS = (100, 400)
# phase 14: jamba-v0.1-52b at full width, bf16 weights, cut to 16 of its 32
# layers (two 8-layer periods: 7 mamba + 1 attention, MoE every other
# layer; 26.05 B parameters, 52.1 GB)
J_LAYERS, J_SLOTS, J_MAX_LEN, J_SESSIONS = 16, 4, 1024, 8
J_PROMPTS, J_MAX_NEW, J_FIRST = (16, 120, 300, 500), 24, 12
# phase 15: seamless-m4t-medium at full width and depth (12 encoder and 12
# decoder layers, 16/16 heads of 64, f32: 0.978 B parameters, 3.9 GB):
# S_B rows of S_FRAMES random frame embeddings (std 0.02) and an S_PROMPT-
# token prompt each, prefilled into an S_MAX_LEN cache, then S_STEPS
# teacher-forced decode steps
S_B, S_FRAMES, S_PROMPT, S_MAX_LEN, S_STEPS = 4, 4096, 16, 512, 256
# phase 16: qwen2-vl-72b at full width, bf16 weights over the Engine's f32
# cache: 1.76 GB a layer, 4.98 GB of embedding and head; at least V_LAYERS
# of its 80 layers (61.2 GB), more while V_RESERVE of the card stays free
V_LAYERS, V_RESERVE = 32, 10e9
V_SLOTS, V_MAX_LEN, V_SESSIONS = 4, 1024, 8
V_PROMPTS, V_MAX_NEW, V_FIRST = (16, 120, 300, 500), 24, 12
V_SCHED_LENS = (100, 400)
# phase 2's row (e) and phase 16's image prefill: V_IMG_LEN tokens, a text
# prefix, one V_IMG_GRID x V_IMG_GRID image, text after it
V_IMG_LEN, V_IMG_PREFIX, V_IMG_GRID = 500, 100, 16
# phase 17: tinyllama-1.1b at full width and depth (f32, 4.4 GB) as a fleet
# of F_REPLICAS replicas on one card sharing one copy of the weights,
# F_SLOTS slots a replica at max_len SERVE_LEN (45,056 B of K/V a token: an
# 11.5 MB snapshot); prompt i is admitted on replica i // 2, and the wave
# F_MOVES runs three routes: 0->2 (two sessions, 2 hops), 1->3 (2 hops)
# and 3->0 (1 hop)
F_REPLICAS, F_SLOTS, F_SESSIONS = 4, 2, 16
F_PROMPTS = (16, 40, 64, 90, 120, 150, 180, 200)
F_MAX_NEW, F_FIRST = 24, 8
F_BOUNCES = 8                    # waves of the route-fault check in (d)
F_MOVES = ((0, 2), (1, 2), (2, 3), (7, 0))
F_CLUSTER_ARGV = ("--arch", "tinyllama-1.1b", "--replicas", "4", "--slots",
                  "1", "--requests", "8", "--followups", "16", "--bursty",
                  "--mean-gap-ns", "700", "--seed", "2")
F_CHAOS_ARGV = ("--arch", "tinyllama-1.1b", "--replicas", "2", "--slots",
                "2", "--requests", "4", "--followups", "6", "--fault-rate",
                "0.25", "--fault-seed", "7")
# phase 18: the paper's DRAM evaluation on the card, as the reference's
# benchmarks/run.py runs it: bench_fig3_fig4's grid of DRAM_CONFIGS x 50
# workloads (5 copy probabilities x 5 Zipf exponents x 2 seeds) of
# DRAM_GRID_REQUESTS requests, and the demo's trace
# (repro_torch.examples.lisa_dram_demo: 16,384 requests, six configs)
DRAM_GRID_REQUESTS = 4096
# (c)'s trace: half the demo's 16,384 requests (to keep the whole run
# inside its time with phase 26)
DRAM_DEMO_REQUESTS = 8192
DRAM_COPY_PROBS = (0.002, 0.005, 0.01, 0.02, 0.04)
DRAM_ZIPFS = (1.0, 1.2, 1.4, 1.6, 1.8)
DRAM_SEEDS = (1, 2)
DRAM_FLOAT_BAR = 1e-6            # the card's floats against the CPU's, rtol
# Table 1's rows -> (mechanism, src_sa, src_row, dst_sa, dst_row), as
# bench_table1 runs them
DRAM_COPIES = {"memcpy": ("memcpy", 0, 1, 7, 2),
               "RC-InterSA": ("rc_intersa", 0, 1, 7, 2),
               "RC-Bank": ("rc_bank", 0, 1, 7, 2),
               "RC-IntraSA": ("rc_intrasa", 0, 1, 0, 2),
               "LISA-RISC-1": ("lisa", 0, 1, 1, 2),
               "LISA-RISC-7": ("lisa", 0, 1, 7, 2),
               "LISA-RISC-15": ("lisa", 0, 1, 15, 2)}
# phase 2's flash_attention_train row and phase 19 (b): tinyllama-1.1b at
# full width and depth in f32 trained on T_BATCH x T_SEQ tokens a step for
# T_STEPS steps through the launcher, checkpointed at T_CKPT and resumed
# (the steps cut to keep the whole run inside its time with phase 26)
T_BATCH, T_SEQ, T_STEPS, T_CKPT = 8, 512, 10, 5
T_LR = 3e-4        # at this width the launcher's default 3e-3 raises the loss
# K3e's backward kernel: each of dq, dk and dv within BW_RATIO times the f32
# twin's own relative L2 gap to the twin in f64 (suspects_f64.py's RATIO)
BW_RATIO = 2.0
# phase 2's flash_attention_heads row and phase 26: tinyllama-1.1b at full
# width cut to HS_LAYERS layers, its attention replaced by a published one,
# (n_heads, n_kv_heads, head_dim, window): Zyphra/Zamba2-7B-Instruct's
# config.json (attention_head_dim 224, 32 heads over 32 kv heads),
# deepseek-ai/DeepSeek-V4-Flash's (head_dim 512, 64 heads over 1,
# sliding_window 128) and DeepSeek-V4-Pro's (head_dim 512, 128 over 1)
HS_SHAPES = {"zamba2-7b": (32, 32, 224, 0),
             "deepseek-v4-flash": (64, 1, 512, 128),
             "deepseek-v4-pro": (128, 1, 512, 0)}
HS_LAYERS, HS_SLOTS, HS_MAX_LEN, HS_SESSIONS = 2, 4, 1024, 8
HS_PROMPTS, HS_MAX_NEW, HS_FIRST = (40, 300, 700), 16, 8
HS_SCHED_LENS = (100, 600)
HS_ROWS = 8                      # phase 2: decode rows over HS_MAX_LEN
# phase 19 (a): tests/test_train_loop.py's recipe on reduced tinyllama
# (lr 8e-3, warmup 2, B 4, S 64, repeat 8) for TL_STEPS steps; the first
# TL_MATCH losses within TL_BAR of the CPU port's run
TL_STEPS, TL_MATCH, TL_BAR = 40, 10, 1e-4
# phase 20: LISA's hop chains over a StackedAxis on the card.  Hops at
# M_HOP_N devices, a shard each of tinyllama-1.1b's f32 weights cut into
# FSDP shards (param_count x 4 = 4,399,824,896 B / 8 = 549,978,112 B);
# ring collectives at M_RING_N devices of M_RING_VALUES f32 (1 GiB) each;
# the all-gather matmul at tinyllama's MLP width (x M_MM_ROWS x d_model,
# w d_model x d_ff) and the compressed all-reduce of its embedding
# gradient (vocab x d_model, N(0, M_GRAD_STD**2)) at M_RING_N; ring
# attention at its heads over M_HOP_N x M_SEQ_SHARD tokens (B 1, f32);
# GPipe at M_PIPE_STAGES stages x M_PIPE_LAYERS layers of tanh(x @ w + b)
# at d_model, M_PIPE_MICRO microbatches of M_PIPE_ROWS rows; the migration
# and fork plans over F_REPLICAS replica pools of phase 17's shape
# (F_SESSIONS rows of a max_len-SERVE_LEN snapshot)
M_HOP_N, M_RING_N, M_RING_VALUES = 8, 4, 268_435_456
M_MM_ROWS, M_GRAD_STD, M_SEQ_SHARD = 4096, 0.01, 2048
M_PIPE_STAGES, M_PIPE_LAYERS, M_PIPE_MICRO, M_PIPE_ROWS = 4, 2, 8, 2048
M_PIPE_BAR, M_RING_BAR, M_MM_BAR, M_GRAD_BAR = 1e-5, 3e-5, 1e-4, 2e-2
# (name, plan kind, src replica, dst replica, src rows, dst rows)
M_PLANS = (("migration", "move", 0, 2, (1, 5), (0, 3)),
           ("fork", "fork", 1, 3, (2,), (6,)))
M_NCCL_TIMEOUT = 300             # s: the NCCL ranks, where cards allow
# phase 21: phase 19 (b)'s full-width tinyllama training (T_BATCH x T_SEQ,
# T_LR, T_STEPS' schedule) for MT_STEPS steps on each stacked mesh of
# MT_MESHES, the first saved at step MT_SAVE and restored onto the second;
# the launcher on reduced tinyllama at MT_ARGV's recipe (that of
# tests/test_train_loop.py, at 8 rows so that 4 data devices split them),
# checkpointed at MT_LAUNCH_CKPT
MT_MESHES, MT_STEPS, MT_SAVE = ((2, 2), (4, 1)), 4, 3
MT_STEP_BAR, MT_LOSS_BAR = 1e-5, 1e-4
MT_ARGV = ("--arch", "tinyllama-1.1b", "--reduced", "--steps", "12",
           "--batch", "8", "--seq", "64", "--lr", "8e-3", "--log-every",
           "6")
MT_LAUNCH_CKPT = 6
# phase 22: phase 19 (b)'s full-width tinyllama training for SP_STEPS steps
# on each (mesh, ParallelConfig keywords, rows a step) of SP_RUNS.  At
# model 4 the reference's layout keeps tinyllama's MLP whole on every
# device (22 layers do not divide 4): the 1 x 4 state alone is 40.6 GB;
# without remat its step of T_BATCH rows ran out of the card's memory in
# the backward; with remat (the config's) it holds one rep's activations
SP_STEPS = 2
SP_RUNS = (((1, 4), {}, T_BATCH),
           ((2, 2), {"sequence_parallel": True}, T_BATCH))
# phase 23: SV_BATCH prompts of SV_PROMPT random tokens prefilled into a
# cache of SV_MAX_LEN slots, then SV_STEPS greedy decode steps, on each
# mesh of SV_MESHES (olmoe on SV_MOE_MESH), fed the single device's
# greedy tokens; logits within SV_BAR of the single device's
SV_BATCH, SV_PROMPT, SV_MAX_LEN, SV_STEPS = 4, 128, 256, 32
SV_MESHES, SV_MOE_MESH, SV_BAR = ((2, 2), (1, 4)), (1, 4), 3e-5
# an MoE row whose expert choice first differs from the single device's
# where the single device's k-th and (k+1)-th router probabilities lie
# within SV_TIE is a near-tie moved by rounding: the row is counted and
# left out of the logit bar from there on (the split sums in another
# order, as tests/test_torch_mla.py exempts bf16 near-ties)
SV_TIE = 1e-5
# olmoe's bar: its 16 MoE layers sum in other orders on 1 x 4 (each
# token's 8 experts over 4 devices, their products in other tile shapes,
# the combine's psum): every row came within 1.0e-4-1.4e-4 of the single
# device's on an H100 80GB HBM3 at 700 W, ~5x tinyllama's 2e-5, not 3e-5
SV_MOE_BAR = 3e-4
# phase 24: the families item 16c left whole, split over model through
# make_prefill_step + make_serve_step at full width: SS_BATCH prompts of
# SS_PROMPT tokens (seamless's over SS_FRAMES frame embeddings, std 0.02)
# into a cache of SS_MAX_LEN slots, then SS_STEPS teacher-forced greedy
# decode steps, against the single device's lm.prefill/decode_step with
# its copy of the weights beside the laid-out one.  (name, arch, weights'
# dtype, mesh, layers or None for full depth, the truth's dtype or None,
# why that depth).  Logits are held within SV_BAR of the single device's,
# but where a run's own rounding moves them further than that bar, the
# run names a truth, the single device's run of other weights fed its
# tokens and routing, and the mesh's relative L2 gap to the single device
# must be at most SS_RATIO times the single device's own gap to it: a
# bf16 run (the split rounds each device's partial sums before the
# reduction: 1.4-2.1% relative L2 at width 1024 on the CPU, tinyllama's
# too) against its weights in f32; rwkv6 against its weights each moved
# by one f32 ulp ("ulp"): its per-head group norm divides rows whose
# variance (2e-4 at random weights) lies below its 6.4e-4 epsilon, so any
# rounding grows with depth (at width 1024 on the CPU: the split's gap
# 1.0e-5 at 4 layers, 4.2e-4 at 16, and the ulp-moved weights' 1.7e-5
# and 2.4e-4; 4.4e-5 at 4 full-width layers on an H100), and its scan
# pins f32, so no wider dtype exists to hold it to.
SS_BATCH, SS_PROMPT, SS_MAX_LEN, SS_STEPS, SS_FRAMES = 4, 64, 128, 8, 1024
SS_RUNS = (
    # 3.97 B parameters a layer, 7.9 GB in bf16: 2 layers and the 1 GB
    # embedding and head in bf16 beside their f32 copy are 51 GB, then
    # beside the laid-out copy 34 GB
    ("deepseek-v2", "deepseek-v2-236b", "bfloat16", (1, 2), 2, "float32",
     "MLA's 128 heads and the 160 experts over model; every layer alike"),
    # 30.1 GB in f32 beside the ulp-moved copy, then beside the laid-out
    # one (wr and wg whole on both devices) ~65 GB
    ("rwkv6", "rwkv6-7b", "float32", (1, 2), None, "ulp",
     "64 heads and ff over model; full depth"),
    # the first 5 layers are one of each kind (mamba with dense and MoE
    # MLPs, the attention layer at index 4), one rep of 6.6 B parameters:
    # 13 GB in bf16 beside their f32 copy, then two bf16 copies and the
    # rep's gather over data on 2 x 2 are ~45 GB; a whole 8-layer period
    # would pass 80
    ("jamba", "jamba-v0.1-52b", "bfloat16", (2, 2), 5, "float32",
     "inner 8192 and 8 KV heads over model, 16 experts; one rep of every "
     "layer kind"),
    ("seamless", "seamless-m4t-medium", "float32", (1, 2), None, None,
     "the encoder and cross attention over 16 heads; full depth"),
)
SS_RATIO = 2.0
# phase 25: a roofline share (bound / device ms) above this fails the run;
# each entry point's profile holds this many calls (device ms a call)
SHARE_LIMIT = 1.05
# K3's routes (kernels/flash_attention.py::prefill_route), by the source
# each runs
ROUTE_SOURCES = {
    "wgmma": "wgmma: csrc/flash_prefill_wgmma.cu (all-bf16 prefill)",
    "mma": "mma: csrc/flash_attention.cu (prefill)",
    "decode": "decode: csrc/flash_decode.cu"}
ROOFLINE_CALLS = 3


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def timed(fn, reps=20, flush=None, device=False):
    """Median ms of ``fn`` over ``reps`` calls between CUDA events, after
    warm-up; ``flush`` runs before each call, outside the timed window.
    The start event is recorded before ``fn``'s Python runs, so the window
    holds the host's time to queue the kernels wherever it outlasts the
    flush on the card.  With ``device=True`` a GPU sleep queued ahead of
    the start event keeps the card busy while the host runs ``fn``, and the
    window holds the device time of the kernels alone."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        if device:
            torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: chip_smoke runs on a GPU only")
    import numpy as np
    from repro_torch import movement as MV
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import lm
    from repro_torch.movement import paging
    from repro_torch.serve.engine import Engine, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    tag = card()
    print(f"card: {tag}  torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- build ---------------------------------------------------------
    t_start = t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name in sorted(built):
        log = (_build.BUILD_DIR / f"{name}.log").read_text()
        entry, info = "", []
        for line in log.splitlines():
            m = re.search(r"entry function '([^']+)'", line)
            if m:
                entry, info = kernel_name(m.group(1)), []
            if "spill" in line:
                info.append(line.split(":", 1)[-1].strip())
            if "registers" in line:
                info.append(line.split(":", 1)[-1].strip())
                print(f"  ptxas {name} {entry}: {'; '.join(info)}")
    check_sass(built)
    lap = [time.perf_counter()]

    def wall(phase):
        now = time.perf_counter()
        print(f"phase {phase}: {now - lap[0]:.1f} s wall")
        lap[0] = now

    cfg = get_config("tinyllama-1.1b")
    spec = paging.PageSpec.for_cache(lm.init_cache(cfg, 1, MAX_LEN,
                                                   device=dev))
    n_pages, page = spec.n_pages, spec.page_bytes
    print(f"snapshot: {spec.total_bytes} B = {n_pages} pages of {page} B")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush = lambda: scratch.fill_(1)         # noqa: E731  (evict L2)
    rows = {}

    # ---- phase 2: kernels against their plain versions -------------------
    pool = torch.randint(0, 256, (N_SESSIONS * n_pages, 8, 128),
                         dtype=torch.uint8, device=dev, generator=gen)
    table = paging.row_page_table(spec, 7).to(dev)
    got = ops.villa_gather(pool, table)
    check(torch.equal(got, ref.villa_gather_ref(pool, table)),
          "villa_gather differs from index_select")

    def masked_gather(tab, label):
        """K2 as the resume path calls it: -1 entries keep out's rows."""
        tab = tab.clone()
        tab[::5] = -1
        before = torch.randint(0, 256, (tab.numel(), 8, 128),
                               dtype=torch.uint8, device=dev, generator=gen)
        got = ops.villa_gather(pool, tab, out=before.clone())
        check(torch.equal(got, ref.villa_gather_ref(pool, tab,
                                                    before.clone()))
              and torch.equal(got[::5], before[::5]),
              f"villa_gather's masked read differs at {label}")

    masked_gather(table, f"{n_pages} pages")
    idx = table.long()
    nbytes = 2 * n_pages * page + 4 * n_pages
    rows["villa_gather"] = dict(
        **kernel_times(lambda: ops.villa_gather(pool, table),
                       lambda: ref.villa_gather_ref(pool, table),
                       lambda: pool.index_select(0, idx), flush),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        max_abs_err=0.0)

    upd = torch.randint(0, 256, (n_pages, 8, 128), dtype=torch.uint8,
                        device=dev, generator=gen)
    wtab = paging.row_page_table(spec, 5).to(dev)
    check(torch.equal(ops.villa_scatter(pool.clone(), wtab, upd),
                      ref.villa_scatter_ref(pool.clone(), wtab, upd)),
          "villa_scatter differs from its plain version at the path shape")
    for dt in (torch.uint8, torch.float32, torch.bfloat16, torch.int8):
        small = torch.randn((4096, 8, 128), device=dev,
                            generator=gen).mul(50).to(dt)
        upd2 = torch.randn((1500, 8, 128), device=dev,
                           generator=gen).mul(50).to(dt)
        t = torch.randint(0, 512, (1500,), device=dev, generator=gen,
                          dtype=torch.int32)       # many duplicates
        t[::7] = -1                                # skips
        a = ops.villa_scatter(small.clone(), t, upd2)
        b = ref.villa_scatter_ref(small.clone(), t, upd2)
        check(torch.equal(a.view(torch.uint8), b.view(torch.uint8)),
              f"villa_scatter ({dt}) differs: duplicates / -1 skips")
    # the launcher's snapshot (phase 5 serves at max_len SERVE_LEN)
    spec_s = paging.PageSpec.for_cache(lm.init_cache(cfg, 1, SERVE_LEN,
                                                     device=dev))
    rtab = paging.row_page_table(spec_s, 3).to(dev)
    check(torch.equal(ops.villa_gather(pool, rtab),
                      ref.villa_gather_ref(pool, rtab)),
          f"villa_gather differs at the max_len {SERVE_LEN} snapshot")
    masked_gather(rtab, f"the max_len {SERVE_LEN} snapshot")
    upd_s = upd[:spec_s.n_pages].contiguous()
    check(torch.equal(ops.villa_scatter(pool.clone(), rtab, upd_s),
                      ref.villa_scatter_ref(pool.clone(), rtab, upd_s)),
          f"villa_scatter differs at the max_len {SERVE_LEN} snapshot")
    print(f"villa_gather/villa_scatter: bit-exact at {n_pages} and "
          f"{spec_s.n_pages} pages, the gather also as a masked read")
    widx = wtab.long()
    rows["villa_scatter"] = dict(
        **kernel_times(lambda: ops.villa_scatter(pool, wtab, upd),
                       lambda: ref.villa_scatter_ref(pool, wtab, upd),
                       lambda: pool.index_copy_(0, widx, upd), flush),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        max_abs_err=0.0)
    del pool, upd, small, upd2

    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(SEED)

    def attn_case(B, S, T, lens, dtype=torch.float32, empty_row=False):
        q = torch.randn((B, S, H, D), device=dev, generator=gen).to(dtype)
        k = torch.randn((B, T, K, D), device=dev, generator=gen).to(dtype)
        v = torch.randn((B, T, K, D), device=dev, generator=gen).to(dtype)
        kv_pos = np.full((B, T), 2**30, np.int32)
        q_pos = np.full((B, S), 2**30, np.int32)
        for b, n in enumerate(lens):
            kv_pos[b, :n] = np.arange(n)
            if S == 1:
                q_pos[b, 0] = n - 1
            else:
                q_pos[b, :n] = np.arange(n)      # prefill: pads at 2**30
        if empty_row:
            kv_pos[0] = 2**30                    # batch row 0: no valid key
            q_pos[0] = 0
        return (q, k, v, torch.from_numpy(q_pos).to(dev),
                torch.from_numpy(kv_pos).to(dev), lens)

    def attn_err(case):
        q, k, v, qp, kp, _ = case
        out = ops.chunked_attention(q, k, v, qp, kp)
        err, _ = attention_err(f"{tuple(q.shape)} x {tuple(k.shape)} "
                               f"{q.dtype}", out, q, k, v, qp, kp)
        return err, out

    errs = []
    for bucket in (16, 64, 256):
        case = attn_case(1, bucket, bucket, [int(rng.integers(bucket // 2 + 1,
                                                              bucket + 1))])
        errs.append(attn_err(case)[0])
        print(f"attention prefill bucket {bucket}: max_abs_err {errs[-1]:.3g}")
    # phase 5's shapes: the forked 24-token prefix prefills in bucket 32,
    # and decode attends over the launcher's max_len
    errs.append(attn_err(attn_case(1, 32, 32, [24]))[0])
    print(f"attention prefill bucket 32 (24 valid): max_abs_err "
          f"{errs[-1]:.3g}")
    slens = [int(x) for x in rng.integers(7, 57, SLOTS)]
    dec = attn_case(SLOTS, 1, SERVE_LEN, slens, empty_row=True)
    errs.append(attn_err(dec)[0])
    _, text = decode_form(dec[0], dec[1], f"tinyllama decode T={SERVE_LEN}",
                          due="cluster")
    print(f"attention decode S=1 T={SERVE_LEN} B={SLOTS}: max_abs_err "
          f"{errs[-1]:.3g}; {text}")
    dlens = [int(x) for x in rng.integers(17, 333, SLOTS)]
    dec = attn_case(SLOTS, 1, MAX_LEN, dlens, empty_row=True)
    n_cluster = FA.chunked_attention.decode_cluster
    err, out = attn_err(dec)
    check(not out[0].any(), "a row with no valid key must give 0")
    check(bit_equal(out, ops.chunked_attention(*dec[:5])),
          "tinyllama decode: two calls differ")
    check(FA.chunked_attention.decode_cluster - n_cluster == 2,
          "tinyllama decode: not counted as cluster launches")
    errs.append(err)
    _, text = decode_form(dec[0], dec[1], f"tinyllama decode T={MAX_LEN}",
                          due="cluster")
    print(f"attention decode S=1 T={MAX_LEN} B={SLOTS}: max_abs_err {err:.3g}"
          f"; {text}")
    bf = attn_case(2, 64, 64, [40, 64], dtype=torch.bfloat16)
    print(f"attention bf16 prefill 64: max_abs_err {attn_err(bf)[0]:.3g}")

    dec = attn_case(SLOTS, 1, MAX_LEN, dlens)
    q, k, v, qp, kp, _ = dec
    sdpa_mask = (kp[:, None, None, :] <= qp[:, None, :, None])
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = lambda: sdpa(qt, kt, vt, attn_mask=sdpa_mask,  # noqa: E731
                           enable_gqa=True)
    bound, by = attention_bound(q, k, qp, kp, 0)
    rows["flash_attention"] = dict(
        **kernel_times(lambda: ops.chunked_attention(q, k, v, qp, kp),
                       lambda: ref.chunked_attention_ref(q, k, v, qp, kp),
                       library, flush),
        bound_ms=bound, bound_by=by, max_abs_err=max(errs))
    rows["flash_attention_prefill"] = prefill_rows(attn_case, flush, tag)
    rows["flash_attention_window"] = window_attention_rows(dev, gen, flush,
                                                           tag)
    rows["flash_attention_d256"], rows["flash_attention_mixed"] = \
        wide_and_mixed_rows(dev, gen, flush, tag)
    rows["flash_attention_mla"], rows["flash_attention_moe"] = \
        mla_and_moe_rows(dev, gen, flush, tag)
    rows["flash_attention_int8"] = int8_rows(dev, gen, flush, tag)
    rows["flash_attention_encdec"], rows["flash_attention_mrope"] = \
        encdec_and_mrope_rows(dev, gen, flush, tag)
    rows["flash_attention_train"], rows["flash_attention_backward"] = \
        train_attention_row(dev, gen, flush, tag)
    rows["flash_attention_heads"] = head_shape_rows(dev, gen, flush, tag)
    # phase 24's local-head shapes, beside each path's rows
    for entry, extra in split_family_rows(dev, gen, flush, tag).items():
        row = rows[entry]
        row.setdefault("shapes", {}).update(extra)
        row["max_abs_err"] = max([row["max_abs_err"]] + [
            r["max_abs_err"] for r in extra.values()
            if r["dtypes"] == row["dtypes"]])

    # K4 at the tile_copy path's shape: one K leaf of the serving cache
    leaf = torch.randn((cfg.n_layers, SLOTS, MAX_LEN, K, D), device=dev,
                       generator=gen)
    got, want = ops.rbm_copy(leaf), ref.rbm_copy_ref(leaf)
    check(bit_equal(got, want),
          f"rbm_copy differs from its plain version at {tuple(leaf.shape)}")
    copy_err = float((got - want).abs().max())
    del got, want
    odd = [((1000, 333), torch.float32), ((7, 129, 65), torch.bfloat16),
           ((4096,), torch.int32), ((256, 128), torch.int8),
           ((13,), torch.uint8), ((0,), torch.float32),
           ((3, 5, 7), torch.bool)]
    for shape, dt in odd:
        x = torch.randn(shape, device=dev, generator=gen).mul(60).to(dt)
        got = ops.rbm_copy(x, tile_rows=64)
        check(got.shape == x.shape and got.dtype == x.dtype
              and bit_equal(got, ref.rbm_copy_ref(x, tile_rows=64))
              and bit_equal(got, x), f"rbm_copy differs at {shape} {dt}")
    skew = torch.randint(0, 256, (100_003,), dtype=torch.uint8, device=dev,
                         generator=gen)[1:]          # not 16-byte aligned
    check(bit_equal(ops.rbm_copy(skew), ref.rbm_copy_ref(skew)),
          "rbm_copy differs on a misaligned view")
    print(f"rbm_copy: bit-exact at {tuple(leaf.shape)} f32 and on "
          f"{len(odd) + 1} odd cases")
    c_bytes = 2 * leaf.numel() * leaf.element_size()
    rows["rbm_copy"] = dict(
        **kernel_times(lambda: ops.rbm_copy(leaf),
                       lambda: ref.rbm_copy_ref(leaf), lambda: leaf.clone(),
                       flush),
        bound_ms=c_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        max_abs_err=copy_err)
    # K4 against clone() in alternating windows (kernel, clone, clone,
    # kernel, ...): whether its gap to the call passes the windows' spread
    ab = alternating(lambda: ops.rbm_copy(leaf), lambda: leaf.clone(), flush)
    rows["rbm_copy"]["against_clone"] = ab
    print(f"rbm_copy against clone(), 8 alternating pairs: device ms "
          f"kernel {ab['a_ms']:.4f} (spread {ab['a_spread']:.2%}), clone "
          f"{ab['b_ms']:.4f} (spread {ab['b_spread']:.2%}), kernel / clone "
          f"{ab['a_ms'] / ab['b_ms']:.4f}; windows kernel {ab['a_windows']}, "
          f"clone {ab['b_windows']} [{tag}]")
    del scratch, leaf
    torch.cuda.synchronize()
    wall(2)

    # ---- phase 3: full-width serving through the Engine ------------------
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    torch.cuda.synchronize()
    print(f"params: {sum(t.numel() for t in _leaves(params))} f32 "
          f"in {time.perf_counter() - t0:.1f} s")
    lens = [int(x) for x in np.random.default_rng(SEED).integers(16, 301, 8)]
    prompts = [np.random.default_rng(SEED + 1 + i).integers(
        0, cfg.vocab_size, n).astype(np.int32) for i, n in enumerate(lens)]
    max_new, first_steps, wave = 48, 32, [1, 3, 5, 7]

    solo = Engine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                  n_sessions=N_SESSIONS, device=dev)
    solo_reqs = [Request(uid, p, max_new) for uid, p in enumerate(prompts)]
    for r in solo_reqs:
        solo.submit(r)
    while solo.active:
        solo.step()
    # warm the resume path (policy ops, masked page moves) once, so the
    # timed waves below measure steady state, not first-use module loads
    solo.resume_many([0, 1, 2, 3], 2)
    while solo.active:
        solo.step()

    # the counters cover the measured engine alone, up to its last step
    ops.reset_launch_counts()
    short0 = FA.chunked_attention.prefill_short
    eng = Engine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                 n_sessions=N_SESSIONS, device=dev)
    reqs = [Request(uid, p, max_new) for uid, p in enumerate(prompts)]
    prefill_ms = {}
    for r in reqs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.submit(r)                        # ends in the next-token read
        prefill_ms.setdefault(eng._bucket_len(len(r.prompt)), []).append(
            (time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(first_steps):
        eng.step()                           # each ends in its token read
    decode_s = time.perf_counter() - t0
    held = {s: eng.active[s] for s in wave}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.suspend_many(wave)
    torch.cuda.synchronize()
    suspend_s = time.perf_counter() - t0
    uids = [held[s].uid for s in wave]
    extra = [max_new - len(held[s].generated) + 1 for s in wave]
    t0 = time.perf_counter()
    slots = eng.resume_many(uids, extra)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    resumed = {eng.active[s].uid: eng.active[s] for s in slots}
    while eng.active:
        eng.step()
    counts = ops.launch_counts()
    print(f"serving: {FA.chunked_attention.prefill_short - short0} of "
          f"{counts['flash_attention_prefill']} prefill launches in the "
          f"short form (buckets {sorted(prefill_ms)})")

    for r, s in zip(reqs, solo_reqs):
        got = (r.generated + resumed[r.uid].generated[1:]
               if r.uid in resumed else r.generated)
        check(len(s.generated) == max_new and got == s.generated,
              f"uid {r.uid}: tokens differ from the uninterrupted run")
    check(eng.verify_failure_count() == 0, "a resume failed its checksums")
    check(int(eng.verify_store()) == 0, "the session store fails its scrub")
    st = eng.stats
    n_susp, n_res = len(wave) + len(reqs), len(wave)
    check(st["prefills"] == 8 and st["suspends"] == n_susp
          and st["resumes"] == n_res, f"stats counts: {st}")
    check(st["decoded_tokens"] == len(reqs) * (max_new - 1),
          f"decoded_tokens {st['decoded_tokens']}")
    check(st["decode_dispatches"] == st["host_transfers"], "one read a step")
    want = (n_susp * eng.plan_suspend.cost.ns_lisa
            + n_res * eng.plan_resume.cost.ns_lisa)
    check(math.isclose(st["modeled_move_ns_lisa"], want, rel_tol=1e-9),
          "modeled movement does not add up")
    check_counts(counts, serving_launches(cfg, eng), "the Engine's path")
    print(f"serving: tokens match the uninterrupted run for all 8 requests "
          f"({len(wave)} suspended+resumed); stats {json.dumps(st)}")

    # ---- phase 3b: the tile_copy leg over the live KV cache --------------
    ops.reset_launch_counts()
    executes = 0
    for x in paging.cache_leaves(eng.cache):         # k, pos, v
        np_dtype = np.dtype(str(x.dtype).removeprefix("torch."))
        p = MV.plan(MV.Transfer(MV.Tier("device"), MV.Tier("device"),
                                MV.Layout.dense(x.shape, np_dtype)))
        check([leg.kind for leg in p.legs] == ["tile_copy"],
              f"device->device plan: {p.legs}")
        out = MV.execute(p, data=x)["data"]
        executes += 1
        check(out.untyped_storage().data_ptr()
              != x.untyped_storage().data_ptr(), "tile_copy aliased its source")
        check(out.shape == x.shape and out.dtype == x.dtype
              and bit_equal(out, x), f"tile_copy differs on {tuple(x.shape)}")
    torch.cuda.synchronize()
    check_counts(ops.launch_counts(), {"rbm_copy": executes}, "tile_copy")
    counts["rbm_copy"] = executes
    print(f"tile_copy: {executes} live cache leaves copied bit-exact through "
          f"movement.execute")
    wall("3-3b")

    # ---- phase 4: numbers ----------------------------------------------
    snap = eng.snapshot_bytes
    print(f"decode: {first_steps} steps x {SLOTS} slots, "
          f"{decode_s / first_steps * 1e3:.3f} ms/step, "
          f"{first_steps * SLOTS / decode_s:.1f} tok/s [{tag}]")
    for b in sorted(prefill_ms):
        print(f"prefill bucket {b}: {statistics.median(prefill_ms[b]):.3f} ms "
              f"(n={len(prefill_ms[b])}) [{tag}]")
    print(f"suspend wave of {len(wave)}: {suspend_s * 1e3:.3f} ms, "
          f"{len(wave) * snap / suspend_s / 1e9:.2f} GB/s [{tag}]")
    print(f"resume wave of {len(wave)}: {resume_s * 1e3:.3f} ms, "
          f"{len(wave) * snap / resume_s / 1e9:.2f} GB/s [{tag}]")
    profile_decode(eng, tag)
    del eng, solo
    torch.cuda.empty_cache()
    wall(4)

    # ---- phase 5: scheduler-driven serving through the launcher ----------
    for run in serve_runs(tag):
        for name, n in run.items():
            counts[name] += n
    wall(5)

    # ---- phases 6-14: gemma3-27b (14 layers, f32), gemma-7b (f32),
    # gemma3-27b (62 layers, bf16 weights), qwen1.5-110b (bf16 weights),
    # olmoe-1b-7b (f32), deepseek-v2-236b (bf16 weights); tinyllama's int8
    # decode_step (12); rwkv6-7b (f32) and jamba-v0.1-52b (bf16 weights) --
    del params
    torch.cuda.empty_cache()
    paths = {}

    def add(run, entry):
        for name in ("villa_scatter", "villa_gather", "rbm_copy"):
            counts[name] += run[name]
        counts["flash_attention_prefill_wgmma"] += run.get(
            "flash_attention_prefill_wgmma", 0)
        k3 = paths.setdefault(entry, {"prefill": 0, "decode": 0})
        k3["prefill"] += run["flash_attention_prefill"]
        k3["decode"] += run["flash_attention_decode"]

    for phase, (entry, fn) in enumerate(
            (("flash_attention_window", gemma3_phase),
             ("flash_attention_d256", gemma7b_phase),
             ("flash_attention_mixed", gemma3_bf16_phase),
             ("flash_attention_mixed", qwen_phase),
             ("flash_attention_moe", olmoe_phase),
             ("flash_attention_mla", deepseek_phase)), start=6):
        add(fn(tag), entry)
        wall(phase)
    # the int8 run's K3 launches are K3d's; the forward it is held to and
    # the f32-cache run launch tinyllama's prefill and decode rows
    i8 = int8_decode_phase(tag)
    add(i8["int8"], "flash_attention_int8")
    for run in (i8["forward"], i8["float32"]):
        for route in ("prefill", "decode"):
            counts[f"flash_attention_{route}"] += \
                run[f"flash_attention_{route}"]
    wall(12)
    # rwkv6-7b launches no K3 (its K1/K2 count); jamba's attention layers
    # run the bf16-weight routes: bf16 prefill, bf16 q over the f32 cache
    for phase, (entry, fn) in ((13, ("flash_attention_mixed", rwkv_phase)),
                               (14, ("flash_attention_mixed", jamba_phase))):
        add(fn(tag), entry)
        wall(phase)
    # seamless's enc-dec path: the forward it is held to, then the
    # prefill and the decode steps; qwen2-vl's Engine, Scheduler and image
    # prefill
    for run in seamless_phase(tag).values():
        add(run, "flash_attention_encdec")
    wall(15)
    add(qwen2vl_phase(tag), "flash_attention_mrope")
    wall(16)
    # tinyllama's fleet: its K3 launches count on tinyllama's rows, its K1
    # and K2 launches (the migration routes' included) on theirs
    for name, n in fleet_phase(tag).items():
        counts[name] += n
    wall(17)
    # the DRAM evaluation runs no kernel of ours (the reference's is jnp,
    # with no pallas_call); training launches K3's prefill under autograd
    dram_phase(tag)
    wall(18)
    train, train_hist = train_phase(tag)
    wall(19)
    # the hop chains over a StackedAxis: every hop one K2 launch, the
    # plans' page legs one K2 and one K1 each; the NCCL route where the
    # machine has two cards or more
    mesh = mesh_phase(tag)
    for name, n in mesh["counts"].items():
        counts[name] += n
    counts["villa_gather_hop"] = mesh["hop_launches"]
    rows["villa_gather_hop"] = mesh["row"]
    nccl_route(tag)
    wall(20)
    # sharded training over stacked meshes: its hops are K2 launches, its
    # device forwards K3's prefill under autograd (K3e's row)
    sharded = mesh_train_phase(tag, train_hist)
    counts["villa_gather"] += sharded["villa_gather"]
    counts["villa_gather_hop"] += sharded["villa_gather"]
    train["prefill"] += sharded["flash_attention_prefill"]
    train["backward"] += sharded["flash_attention_backward"]
    wall(21)
    # the split compute: its hops are K2 launches, its forwards K3e
    split = split_train_phase(tag, train_hist)
    counts["villa_gather"] += split["villa_gather"]
    counts["villa_gather_hop"] += split["villa_gather"]
    train["prefill"] += split["flash_attention_prefill"]
    train["backward"] += split["flash_attention_backward"]
    counts["flash_attention_train"] = train["prefill"] + train["decode"]
    counts["flash_attention_backward"] = train.pop("backward")
    wall(22)
    # the prefill and decode steps over a mesh: tinyllama's K3 launches
    # count on tinyllama's rows, olmoe's on its own
    served = serve_steps_phase(tag)
    counts["villa_gather"] += served["villa_gather"]
    counts["villa_gather_hop"] += served["villa_gather"]
    for route in ("prefill", "decode"):
        counts[f"flash_attention_{route}"] += served["tinyllama"][route]
        paths["flash_attention_moe"][route] += served["olmoe"][route]
    wall(23)
    # the families item 16c left whole, split over a laid-out cache:
    # deepseek-v2's K3 launches count on the MLA row, jamba's on the
    # bf16-weight (mixed) row, seamless's on the enc-dec row; rwkv6 runs
    # no K3
    split_served = split_serve_phase(tag)
    counts["villa_gather"] += split_served["villa_gather"]
    counts["villa_gather_hop"] += split_served["villa_gather"]
    for name, entry in (("deepseek-v2", "flash_attention_mla"),
                        ("jamba", "flash_attention_mixed"),
                        ("seamless", "flash_attention_encdec")):
        for route in ("prefill", "decode"):
            paths[entry][route] += split_served[name][route]
        counts["flash_attention_prefill_wgmma"] += \
            split_served[name]["wgmma"]
    wall(24)
    # the entry points' audit and live roofline: tinyllama's K1, K2 and K3
    # launches count on its rows
    for name, n in audit_phase(tag).items():
        counts[name] += n
    wall(25)
    # the published attention shapes: their K3 launches count on their
    # own row, by route
    add(head_shape_phase(tag), "flash_attention_heads")
    wall(26)
    routes = {"flash_attention": {"prefill": counts["flash_attention_prefill"],
                                  "decode": counts["flash_attention_decode"]},
              **paths, "flash_attention_train": train}
    for entry, k3 in paths.items():
        counts[entry] = k3["prefill"] + k3["decode"]
    # K3 on tinyllama's paths by route: the decode row, then the prefill row
    counts["flash_attention"] = counts["flash_attention_decode"]

    replaces = {
        "villa_scatter": "src/repro/kernels/rbm_copy.py:93",
        "villa_gather": "src/repro/kernels/rbm_copy.py:58",
        "villa_gather_hop": "src/repro/kernels/rbm_copy.py:58",
        "flash_attention": "src/repro/kernels/flash_attention.py:81",
        "flash_attention_window": "src/repro/kernels/flash_attention.py:81",
        "flash_attention_prefill": "src/repro/kernels/flash_attention.py:81",
        "flash_attention_d256": "src/repro/kernels/flash_attention.py:81",
        "flash_attention_mixed": "src/repro/kernels/flash_attention.py:81",
        "flash_attention_moe": "src/repro/kernels/flash_attention.py:81",
        "flash_attention_mla": "src/repro/kernels/flash_attention.py:81",
        "flash_attention_int8": "src/repro/kernels/flash_attention.py:81",
        "flash_attention_encdec": "src/repro/kernels/flash_attention.py:81",
        "flash_attention_mrope": "src/repro/kernels/flash_attention.py:81",
        "flash_attention_train": "src/repro/kernels/flash_attention.py:81",
        "flash_attention_heads": "src/repro/kernels/flash_attention.py:81",
        "flash_attention_prefill_wgmma":
            "src/repro/kernels/flash_attention.py:81",
        # the reference's _flash_bwd, which reaches no pallas_call
        "flash_attention_backward": "src/repro/kernels/ops.py:31",
        "rbm_copy": "src/repro/kernels/rbm_copy.py:27"}
    csrc = "src/repro_torch/kernels/csrc/"
    decode_src = csrc + "flash_decode.cu"
    sources = {"villa_scatter": csrc + "page_copy.cu",
               "villa_gather": csrc + "page_copy.cu",
               "villa_gather_hop": csrc + "page_copy.cu",
               "flash_attention": decode_src,
               "flash_attention_window": decode_src,
               "flash_attention_prefill": csrc + "flash_attention.cu",
               "flash_attention_d256": decode_src,
               "flash_attention_mixed": decode_src,
               "flash_attention_moe": decode_src,
               "flash_attention_mla": csrc + "flash_attention.cu",
               "flash_attention_int8": decode_src,
               "flash_attention_encdec": decode_src,
               "flash_attention_mrope": csrc + "flash_attention.cu",
               "flash_attention_train": csrc + "flash_attention.cu",
               "flash_attention_heads": csrc + "flash_attention.cu",
               "flash_attention_prefill_wgmma":
                   csrc + "flash_prefill_wgmma.cu",
               "flash_attention_backward": csrc + "flash_backward.cu",
               "rbm_copy": csrc + "rbm_copy.cu"}
    # a row whose headline shape is a prefill names its route's source
    for name, r in rows.items():
        if str(r.get("route", "")).split(":")[0] in ("wgmma", "mma"):
            sources[name] = csrc + r["route"].split(": ")[1].split()[0] \
                .removeprefix("csrc/")
    # the wgmma route's row: gemma3's bf16 prefill under its window (the
    # bf16-weight paths launch it), and every phase-2 shape on the route
    wg_shapes = {f"{entry}.{shape}": r for entry, row in rows.items()
                 for shape, r in row.get("shapes", {}).items()
                 if isinstance(r, dict)
                 and str(r.get("route", "")).startswith("wgmma")}
    head = rows["flash_attention_mixed"]["shapes"]["prefill_local_bf16"]
    rows["flash_attention_prefill_wgmma"] = dict(
        head, shapes=wg_shapes,
        max_abs_err=max(r["max_abs_err"] for r in wg_shapes.values()))
    routes["flash_attention_prefill_wgmma"] = {
        "prefill": counts["flash_attention_prefill_wgmma"]}
    check(counts["flash_attention_prefill_wgmma"] > 0,
          "the wgmma prefill route was launched no time on the paths")
    check(counts["flash_attention_backward"] > 0,
          "K3e's backward kernel was launched no time on the paths")
    # flash_attention counts K3's decode kernel on the tinyllama paths
    # (phases 3 and 5), flash_attention_prefill its prefill kernel there;
    # flash_attention_window both on gemma3's 14-layer f32 path (phase 6),
    # flash_attention_d256 both on gemma-7b's (phase 7), and
    # flash_attention_mixed both on the bf16-weight paths (phases 8, 9 and
    # 14: bf16 prefill, bf16 q over the f32 cache in decode), by route
    # beside, with the dtypes each route ran there; flash_attention_moe
    # both on olmoe's path (phase 10), flash_attention_mla the prefill at
    # Dk 192 / Dv 128 on deepseek-v2's (phase 11, which decodes without
    # K3), flash_attention_int8 the decode kernel over int8 K/V (K3d) on
    # the int8 decode_step path (phase 12); tinyllama's f32 decode_step run
    # (phase 12) counts under flash_attention; flash_attention_encdec both
    # routes on seamless's enc-dec path (phase 15: encoder, self and cross
    # attention), flash_attention_mrope both on qwen2-vl's (phase 16),
    # flash_attention_train the prefill kernel under autograd (K3e) on the
    # training path (phase 19), flash_attention_backward K3e's backward
    # kernel there (one call a layer a step: phases 19, 21 and 22); a row's
    # source is its headline route's (the prefill kernel is
    # csrc/flash_attention.cu), and of the split compute's training
    # (phases 21-22, K3e once a layer for the whole stack); phase 23's
    # prefill and decode steps over a mesh count on tinyllama's rows and
    # olmoe's (flash_attention_moe); villa_gather_hop counts the K2
    # launches of phases 20-23's hops (each also in villa_gather), timed
    # at the shift of every shard of tinyllama's weights over 8 stacked
    # devices; flash_attention_heads both routes at the published attention
    # shapes of phase 26 (head dims 224 and 512, groups 1, 64 and 128);
    # flash_attention_prefill_wgmma K3's all-bf16 prefill route (its own
    # kernel, csrc/flash_prefill_wgmma.cu, also counted in each path's
    # prefill launches) on the bf16-weight paths (phases 8, 9, 11, 14, 16,
    # 24 and 26), timed at gemma3's bf16 prefill under its window, every
    # phase-2 shape on the route in its shapes
    kernels = []
    for name in ("villa_scatter", "villa_gather", "villa_gather_hop",
                 "flash_attention",
                 "flash_attention_prefill", "flash_attention_window",
                 "flash_attention_d256", "flash_attention_mixed",
                 "flash_attention_moe", "flash_attention_mla",
                 "flash_attention_int8", "flash_attention_encdec",
                 "flash_attention_mrope", "flash_attention_train",
                 "flash_attention_heads", "flash_attention_prefill_wgmma",
                 "flash_attention_backward", "rbm_copy"):
        r = rows[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": sources[name], "replaces": replaces[name],
                        "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
        kernels[-1].update({key: r[key] for key in
                            ("device_ms", "library_device_ms", "enqueue_us",
                             "library_enqueue_us", "tc_bound_ms", "dtypes",
                             "library_operands", "shapes", "timed", "route",
                             "forward_ms", "forward_device_ms",
                             "forward_bound_ms", "forward_tc_bound_ms",
                             "grads_rel_l2", "twin_rel_l2",
                             "grads_bit_equal_call_to_call")
                            if key in r})
        if name in routes:
            kernels[-1]["launches_by_route"] = routes[name]
        if name == "flash_attention_mixed":
            kernels[-1]["route_dtypes"] = {
                "prefill": f"q bfloat16, k/v bfloat16 (shapes: "
                           f"prefill_local_bf16, "
                           f"jamba_prefill_{max(J_PROMPTS)}_bf16)",
                "decode": "q bfloat16, k/v float32 (shapes: decode_ring, "
                          "decode_global, qwen_decode, jamba_decode)"}
        if name == "flash_attention_heads":
            kernels[-1]["route_dtypes"] = {
                route: "q, k/v float32 (f32 weights); q bfloat16 over k/v "
                       + ("bfloat16" if route == "prefill" else "float32")
                       + " (bf16 weights over the Engine's f32 cache)"
                for route in ("prefill", "decode")}
        if name == "flash_attention_int8":
            kernels[-1]["route_dtypes"] = {
                "decode": "q float32, k/v int8 with float32 scales"}
        if name == "flash_attention_encdec":
            kernels[-1]["route_dtypes"] = {
                "prefill": "q, k/v float32 (shapes: encoder, non-causal; "
                           "cross_prefill, cross_prefill_pads)",
                "decode": "q, k/v float32 (shapes: cross_decode, "
                          "self_decode)"}
        if name == "flash_attention_mrope":
            kernels[-1]["route_dtypes"] = {
                "prefill": "q, k/v bfloat16 (shape: "
                           f"prefill_{V_IMG_LEN}_image_bf16)",
                "decode": "q bfloat16, k/v float32 (the flash_attention_"
                          "mixed row qwen_decode's shape)"}
        print(f"kernel {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, library {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), launches "
              f"{counts[name]}; device time: kernel {r['device_ms']:.4f} "
              f"ms, library {r['library_device_ms']:.4f} ms; host to queue "
              f"a call: kernel {r['enqueue_us']:.1f} us, library "
              f"{r['library_enqueue_us']:.1f} us [{tag}]")
    print(f"all phases: {time.perf_counter() - t_start:.1f} s wall after "
          f"the build started")
    print(json.dumps({"kernels": kernels}))
    print(tag)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernel_times(kernel, plain, library, flush) -> dict:
    """The times of one path shape: the kernel's, its plain version's and
    the library call's ms as every run has timed them (``timed``); the
    kernel's and the library call's device ms (``timed(device=True)``);
    and the host's us a call to queue each (``enqueue_us``)."""
    return dict(ms=timed(kernel, flush=flush),
                plain_ms=timed(plain, flush=flush),
                library_ms=timed(library, flush=flush),
                device_ms=timed(kernel, flush=flush, device=True),
                library_device_ms=timed(library, flush=flush, device=True),
                enqueue_us=enqueue_us(kernel),
                library_enqueue_us=enqueue_us(library))


def enqueue_us(fn, calls=50) -> float:
    """Host us a call of ``fn`` takes to return, its kernels queued but
    not run: ``calls`` calls back to back on the host clock, the card
    synchronised before and after, outside the window."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def attention_err(label, got, q, k, v, qp, kp, window=0, causal=True):
    """K3's output ``got`` against its plain version on the same inputs,
    element by element under ``ref.attention_bar`` (3e-5 where the output
    is f32; where it is bf16, 3e-5 plus two bf16 ulps of the value, plus
    2**-8 of the attention over |v| where the prefill's products are bf16,
    never past 2e-2).  Returns (max abs error, the largest error's share of
    its bar); fails the run past the bar."""
    from repro_torch.kernels import ref

    want = ref.chunked_attention_ref(q, k, v, qp, kp, window=window,
                                     causal=causal)
    bar = ref.attention_bar(got, want, q, k, v, qp, kp, window=window,
                            causal=causal)
    diff = (got.float() - want.float()).abs()
    share = float((diff / bar).max())
    check(got.dtype == q.dtype and share <= 1,
          f"attention {label}: error {float(diff.max())} past its bar "
          f"({share:.3g} of it, {got.dtype})")
    return float(diff.max()), share


def prefill_rows(attn_case, flush, tag) -> dict:
    """Phase 2's tinyllama prefill shapes (the Engine's buckets 16 and 512,
    a full prompt): the prefill kernel within 3e-5 of its plain version,
    timed beside it and SDPA (causal boolean mask), with its f32 and
    tensor-core bounds.  Returns the ``kernels`` entry: bucket 512's
    numbers, both buckets' in ``shapes``."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops, ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for bucket in PREFILL_BUCKETS:
        q, k, v, qp, kp, _ = attn_case(1, bucket, bucket, [bucket])
        got = ops.chunked_attention(q, k, v, qp, kp)
        want = ref.chunked_attention_ref(q, k, v, qp, kp)
        err = float((got - want).abs().max())
        check(err <= 3e-5, f"prefill bucket {bucket}: error {err} > 3e-5")
        mask = kp[:, None, None, :] <= qp[:, None, :, None]
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        bound, by = attention_bound(q, k, qp, kp, 0)
        r = out[f"bucket_{bucket}"] = dict(
            **kernel_times(lambda: ops.chunked_attention(q, k, v, qp, kp),
                           lambda: ref.chunked_attention_ref(q, k, v, qp, kp),
                           lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                        enable_gqa=True), flush),
            bound_ms=bound, bound_by=by, tc_bound_ms=tc_bound(q, k, qp, kp, 0),
            max_abs_err=err, route=ROUTE_SOURCES[FA.prefill_route(
                q.dtype, k.dtype, q.shape[-1], v.shape[-1])],
            form=FA.launch_plan(q, k, v).form)
        print(f"attention prefill bucket {bucket} ({r['form']} form): "
              f"kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, "
              f"bound {bound:.5f} ms ({by}), tensor-core bound "
              f"{r['tc_bound_ms']:.5f} ms; device time: kernel "
              f"{r['device_ms']:.4f} ms, SDPA {r['library_device_ms']:.4f} ms;"
              f" max_abs_err {err:.3g} [{tag}]")
    row = dict(out[f"bucket_{max(PREFILL_BUCKETS)}"])
    row["max_abs_err"] = max(r["max_abs_err"] for r in out.values())
    row["shapes"] = out
    return row


def check_sass(built) -> None:
    """The compiled code shows the design: every kernel of the mma.sync
    prefill library is an instantiation of the prefill kernel running
    tensor-core MMAs (HMMA): three (the f32 and the two mixed q, K/V dtype
    pairs) at each unpadded width of ``flash_attention.TILE_WIDTHS`` and
    at each of ``PADDED_WIDTHS`` (the general template: masked past the
    head dim, and taking head slices), a fourth, all-bf16, at the widths
    the wgmma route leaves it (16, 32 and 512 unpadded; 96 and 512
    padded), and one f32 of each at Dk 192 / Dv 128, and again the three
    of the f32 path at each width up to 256 in their kFresh form (K3e's
    forward: the row log-sum-exp written, the scores summed a k-step at a
    time); beside them the short form's kernel (``prefill_short_kernel``,
    running HMMA), f32 at each (Dk, Dv) of ``flash_attention.SHORT_DIMS``
    at 16, 32 and 64 rows a CTA; every kernel of the backward library
    (csrc/flash_backward.cu) its gradients kernel (the
    dK/dV and dQ blocks of one launch) running HMMA, one for f32 and one
    for bf16 at each of ``flash_attention.BACKWARD_WIDTHS``, or its prep
    or widening kernel; every kernel of the wgmma library one of the
    all-bf16 prefill at each of its widths (``WGMMA_WIDTHS``), with warpgroup MMAs (HGMMA: at least Dk/16 for
    QK^T and BN/16 for PV) and TMA tensor loads (UTMALDG: at least one a
    64-column panel of K and of V); every kernel of the decode library one
    of the split-KV kernel or of its cluster form, one of the latter at
    each of ``flash_attention.CLUSTER_DECODE``; K4 issues bulk copies
    (UBLKCP).  Prints how
    many instantiations each library holds.  Reads the SASS with the
    toolkit's cuobjdump."""
    import shutil

    from repro_torch.kernels import flash_attention as FA

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    ops_ = ("HMMA", "HGMMA", "UTMALDG", "UBLKCP")
    counts = {}
    for name in ("flash_attention", "flash_prefill_wgmma", "flash_decode",
                 "flash_backward", "rbm_copy"):
        sass = subprocess.run([tool, "-sass", str(built[name])],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        fn = None
        lib = counts[name] = {}
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = kernel_name(m.group(1))
                lib[fn] = dict.fromkeys(ops_, 0)
            elif fn is not None:
                for op in ops_:
                    lib[fn][op] += re.search(rf"\b{op}\b", line) is not None
    prefill, decode = counts["flash_attention"], counts["flash_decode"]
    check(prefill and all(("prefill_kernel" in k
                           or "prefill_short_kernel" in k) and c["HMMA"] > 0
                          for k, c in prefill.items()),
          f"prefill kernels without tensor-core MMAs or outside the design: "
          f"{prefill}")
    short = {}
    for k in [k for k in prefill if "prefill_short_kernel" in k]:
        m = re.search(r"prefill_short_kernelILi(\d+)ELi(\d+)ELi(\d+)E", k)
        check(m is not None, f"short-form kernel outside the design: {k}")
        short[(int(m.group(1)), int(m.group(2)),
               16 * int(m.group(3)))] = prefill.pop(k)["HMMA"]
    due = {(dk, dv, r) for dk, dv in FA.SHORT_DIMS for r in FA.SHORT_ROWS}
    check(set(short) == due, f"short-form instantiations (Dk, Dv, rows) "
                             f"{sorted(short)}, {sorted(due)} due")
    widths = {}
    for k in prefill:
        dims = tuple(int(x) for x in re.search(
            r"Li(\d+)ELi(\d+)ELb([01])ELb([01])E", k).groups())
        widths[dims] = widths.get(dims, 0) + 1
    want = {(w, w, 0, 0): 3 + (w in (16, 32, 512)) for w in FA.TILE_WIDTHS}
    want.update({(w, w, 1, 0): 3 + (w in (96, 512))
                 for w in FA.PADDED_WIDTHS})
    want.update({(w, w, 0, 1): 3 for w in FA.TILE_WIDTHS if w <= 256})
    want.update({(w, w, 1, 1): 3 for w in FA.PADDED_WIDTHS if w <= 256})
    want[FA.MLA_DIMS + (0, 0)] = want[FA.MLA_DIMS + (1, 0)] = 1
    check(widths == want, f"prefill instantiations by (Dk, Dv, general, "
                          f"kFresh) {widths}, {want} due")
    back = counts["flash_backward"]
    grads = {}
    for k, c in back.items():
        m = re.search(r"(grads)_kernelI(f|13__nv_bfloat16)Li(\d+)E", k)
        check(m is not None or re.search(r"(prep|widen)_kernel", k),
              f"backward library kernel outside the design: {k}")
        if m:
            check(c["HMMA"] > 0, f"backward kernel {k} runs no HMMA: {c}")
            key = (m.group(1), m.group(2)[:1], int(m.group(3)))
            grads[key] = c["HMMA"]
    due = {("grads", t, w) for t in ("f", "1") for w in FA.BACKWARD_WIDTHS}
    check(set(grads) == due, f"backward instantiations {sorted(grads)}, "
                             f"{sorted(due)} due")
    wg = counts["flash_prefill_wgmma"]
    due = {(w, w) if w != FA.MLA_DIMS[0] else FA.MLA_DIMS: w
           for w in FA.WGMMA_WIDTHS}
    got = {}
    for k, c in wg.items():
        dk, dv = (int(x) for x in re.search(r"Li(\d+)ELi(\d+)E", k).groups())
        keys = FA.WGMMA_KEYS[dk]
        check("prefill_wgmma_kernel" in k
              and c["HGMMA"] >= dk // 16 + keys // 16
              and c["UTMALDG"] >= dk // 64 + dv // 64 and c["HMMA"] == 0,
              f"wgmma prefill {k}: {c}, at least {dk // 16 + keys // 16} "
              f"HGMMA and {dk // 64 + dv // 64} UTMALDG due, no HMMA")
        got[(dk, dv)] = c
    check(set(got) == set(due), f"wgmma prefill instantiations {sorted(got)}"
                                f", {sorted(due)} due")
    check(decode and all("decode_split_kernel" in k
                         or "decode_cluster_kernel" in k for k in decode),
          f"decode library outside the design: {sorted(decode)}")
    clusters = [k for k in decode if "decode_cluster_kernel" in k]
    check(len(clusters) == len(FA.CLUSTER_DECODE),
          f"{len(clusters)} cluster-form decode kernels, "
          f"{len(FA.CLUSTER_DECODE)} due (flash_attention.CLUSTER_DECODE)")
    bulk = [c["UBLKCP"] for k, c in counts["rbm_copy"].items()
            if "bulk_copy" in k]
    check(bulk and all(n > 0 for n in bulk), "K4 issues no bulk copies")
    for k in sorted(prefill):
        print(f"  sass {k}: {prefill[k]['HMMA']} HMMA")
    for dk, dv, r in sorted(short):
        print(f"  sass prefill_short_kernel<{dk}, {dv}, {r} rows>: "
              f"{short[(dk, dv, r)]} HMMA")
    for (dk, dv), c in sorted(got.items()):
        print(f"  sass prefill_wgmma_kernel<{dk}, {dv}>: {c['HGMMA']} "
              f"HGMMA, {c['UTMALDG']} UTMALDG")
    for kind, t, w in sorted(grads):
        print(f"  sass {kind}_kernel<{'float' if t == 'f' else 'bf16'}, "
              f"{w}>: {grads[(kind, t, w)]} HMMA")
    print(f"  sass: {len(prefill)} mma.sync prefill kernels and "
          f"{len(short)} of its short form, all with HMMA; "
          f"{len(grads)} backward kernels, all with HMMA; "
          f"{len(wg)} wgmma prefill kernels, all with HGMMA and UTMALDG; "
          f"{len(decode) - len(clusters)} split-KV decode kernels and "
          f"{len(clusters)} of its cluster form; bulk_copy_kernel: "
          f"{bulk[0]} UBLKCP")


def window_attention_rows(dev, gen, flush, tag) -> dict:
    """Phase 2 at gemma3-27b's attention shapes (32 q / 16 kv heads, head
    dim 128, window 1024), which phase 6 launches: K3 against its plain
    version (``attention_err``) in f32 and in bf16 for a 1500-token prefill
    (local, window 1024, and global), a ragged decode of 4 rows over 1024-
    slot rings whose positions have wrapped (slot t % 1024 holds token t),
    and over the 2048-slot global cache; each f32 shape timed beside its
    plain version, SDPA with the boolean (window) mask and its bound.
    Returns the ``kernels`` entry: the ring decode's numbers (12 of the 14
    layers launch it every decode step) and every shape's in ``shapes``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref

    cfg = get_config("gemma3-27b")
    H, K, D, W = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.window
    ends = np.array(G_PROMPTS) + G_MAX_NEW - 1   # the last decode's positions
    B, P = len(ends), max(G_PROMPTS)
    prefill = np.arange(P, dtype=np.int32)[None]
    ring = np.full((B, W), 2**30, np.int32)
    glob = np.full((B, G_MAX_LEN), 2**30, np.int32)
    for b, n in enumerate(ends):
        t = np.arange(max(0, n - W + 1), n + 1)
        ring[b, t % W] = t
        glob[b, :n + 1] = np.arange(n + 1)
    wrapped = [b for b in range(B) if ends[b] >= W and (ends[b] + 1) % W]
    check(wrapped and all((np.diff(ring[b]) < 0).any() for b in wrapped),
          "the ring positions did not wrap")
    shapes = {  # name: (q_pos, kv_pos, window, check bf16 too)
        "prefill_local": (prefill, prefill, W, True),
        "prefill_global": (prefill, prefill, 0, False),
        "decode_ring": (ends[:, None].astype(np.int32), ring, W, True),
        "decode_global": (ends[:, None].astype(np.int32), glob, 0, False),
        "decode_global_windowed": (ends[:, None].astype(np.int32), glob, W,
                                   False)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for name, (qp_np, kp_np, window, bf16) in shapes.items():
        nb, S = qp_np.shape
        T = kp_np.shape[1]
        qp = torch.from_numpy(qp_np).to(dev)
        kp = torch.from_numpy(kp_np).to(dev)
        q = torch.randn((nb, S, H, D), device=dev, generator=gen)
        k = torch.randn((nb, T, K, D), device=dev, generator=gen)
        v = torch.randn((nb, T, K, D), device=dev, generator=gen)
        plan = ""
        if S == 1:
            plan = ", " + decode_form(q, k, f"gemma3 {name}")[1]
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            if dt == torch.bfloat16 and not bf16:
                continue
            args = (q.to(dt), k.to(dt), v.to(dt), qp, kp)
            got = ops.chunked_attention(*args, window=window)
            errs[str(dt).removeprefix("torch.")] = attention_err(
                f"{name} window {window}", got, *args, window)[0]
        print(f"attention {name} S={S} T={T} B={nb} window {window}{plan}: "
              f"max_abs_err {errs}")
        if name == "decode_global_windowed":
            continue                  # a check only: no layer launches it
        mask = kp[:, None, None, :] <= qp[:, None, :, None]
        if window > 0:
            mask &= kp[:, None, None, :] > qp[:, None, :, None] - window
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        bound, by = attention_bound(q, k, qp, kp, window)
        out[name] = dict(
            **kernel_times(
                lambda: ops.chunked_attention(q, k, v, qp, kp,
                                              window=window),
                lambda: ref.chunked_attention_ref(q, k, v, qp, kp,
                                                  window=window),
                lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True),
                flush),
            bound_ms=bound, bound_by=by, max_abs_err=errs["float32"],
            max_abs_err_bf16=errs.get("bfloat16"))
        r = out[name]
        if S > 1:
            r["tc_bound_ms"] = tc_bound(q, k, qp, kp, window)
        if name == "prefill_local":         # bf16, a finding beside SDPA's
            qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
            qbt, kbt, vbt = (x.transpose(1, 2) for x in (qb, kb, vb))
            r["bf16"] = dict(
                ms=timed(lambda: ops.chunked_attention(qb, kb, vb, qp, kp,
                                                       window=window),
                         flush=flush),
                device_ms=timed(lambda: ops.chunked_attention(
                    qb, kb, vb, qp, kp, window=window), flush=flush,
                    device=True),
                library_device_ms=timed(lambda: sdpa(
                    qbt, kbt, vbt, attn_mask=mask, enable_gqa=True),
                    flush=flush, device=True),
                tc_bound_ms=tc_bound(qb, kb, qp, kp, window))
            print(f"attention {name} bf16: kernel {r['bf16']['ms']:.4f} ms, "
                  f"device {r['bf16']['device_ms']:.4f} ms, SDPA device "
                  f"{r['bf16']['library_device_ms']:.4f} ms, tensor-core "
                  f"bound {r['bf16']['tc_bound_ms']:.5f} ms [{tag}]")
        print(f"attention {name}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, bound "
              f"{bound:.5f} ms ({by}); device time: kernel "
              f"{r['device_ms']:.4f} ms, SDPA {r['library_device_ms']:.4f} ms; "
              f"host to queue a call: kernel {r['enqueue_us']:.1f} us, SDPA "
              f"{r['library_enqueue_us']:.1f} us [{tag}]")
    # the bucket of the shortest prompt, which phase 6 prefills in the
    # short form in its windowed and its global layers
    n = min(G_PROMPTS)
    S = min(max(16, 1 << (n - 1).bit_length()), G_MAX_LEN)
    pos = np.full((1, S), 2**30, np.int32)
    pos[0, :n] = np.arange(n)
    pos = torch.from_numpy(pos).to(dev)
    for name, window in ((f"prefill_{S}_local", W), (f"prefill_{S}_global",
                                                      0)):
        q, k, v = (torch.randn((1, S, h, D), device=dev, generator=gen)
                   for h in (H, K, K))
        out[name] = attention_row(
            f"gemma3 prefill bucket {S} ({n} tokens)", q, k, v, pos, pos,
            window, flush, tag)
        short_due(out[name], f"gemma3 f32 prefill bucket {S}, window "
                             f"{window}")
    row = {k: v for k, v in out["decode_ring"].items()
           if k != "max_abs_err_bf16"}
    for name in ("prefill_local", "prefill_global"):
        print(f"attention {name}: device {out[name]['device_ms']:.4f} ms "
              f"against the target of 50% of the f32 bound "
              f"({2 * out[name]['bound_ms']:.4f} ms); tensor-core bound "
              f"{out[name]['tc_bound_ms']:.4f} ms [{tag}]")
    row["max_abs_err"] = max(r["max_abs_err"] for r in out.values())
    row["shapes"] = out
    return row


def short_due(row, label) -> None:
    """Fail the run unless phase 2's ``row`` (from :func:`attention_row`)
    ran the short form of the f32 prefill."""
    check(row["form"] == "short", f"{label}: the {row['form']} form ran; "
                                  f"the short form is due")


def decode_form(q, k, label, due=None):
    """A phase-2 decode row's layout (``FA.decode_launch_plan``): returns
    ``(plan, text)``, the text naming its form, head group, splits, the
    CTAs a cluster and the grid's CTAs; fails the run where ``due`` names
    a form and another runs."""
    from repro_torch.kernels import flash_attention as FA

    plan = FA.decode_launch_plan(q, k)
    check(due is None or plan.form == due,
          f"{label}: the {plan.form} decode form ran; the {due} form is due")
    return plan, (f"{plan.form} form, head group {plan.head_group}, "
                  f"{plan.n_split} splits of {plan.split_len} slots, "
                  f"cluster {plan.cluster}, {plan.ctas} CTAs")


def alternating(a, b, flush, pairs=8) -> dict:
    """Device ms of ``a`` and ``b`` (``timed(device=True)`` windows) in
    alternating order, ``pairs`` pairs: a b, b a, a b, ...  Returns each
    side's median and windows and the spread of each (max over min of its
    windows, minus 1)."""
    got = {"a": [], "b": []}
    for i in range(pairs):
        for side in (("a", "b") if i % 2 == 0 else ("b", "a")):
            got[side].append(timed(a if side == "a" else b, flush=flush,
                                   device=True))
    out = {}
    for side in ("a", "b"):
        w = got[side]
        out.update({f"{side}_ms": statistics.median(w), f"{side}_windows": w,
                    f"{side}_spread": max(w) / min(w) - 1})
    return out


def attention_row(label, q, k, v, qp, kp, window, flush, tag,
                  causal=True) -> dict:
    """One attention shape: the kernel held to its plain version
    (``attention_err``), then timed beside it and SDPA
    (``enable_gqa``, boolean mask; none without ``causal``), with its
    bound (operations at the
    bf16 peak when q and K/V are bf16, else at the f32 peak) and, for a
    prefill, its tensor-core bound.  SDPA takes one dtype: a mixed row's
    operands are promoted to f32 before its timed window."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops, ref

    kw = dict(window=window, causal=causal)
    route = ("decode" if q.shape[1] == 1 else
             FA.prefill_route(q.dtype, k.dtype, q.shape[-1], v.shape[-1]))
    form = FA.launch_plan(q, k, v).form if q.shape[1] > 1 else None
    dplan = dtext = None
    if q.shape[1] == 1:
        dplan, dtext = decode_form(q, k, label)
        form = dplan.form
    n0 = FA.chunked_attention.prefill_wgmma
    n1 = FA.chunked_attention.prefill_short
    n2 = FA.chunked_attention.decode_cluster
    got = ops.chunked_attention(q, k, v, qp, kp, **kw)
    check(FA.chunked_attention.prefill_wgmma - n0 == (route == "wgmma")
          and FA.chunked_attention.prefill_short - n1 == (form == "short")
          and FA.chunked_attention.decode_cluster - n2 == (form == "cluster"),
          f"attention {label}: the {route} route's launch ({form} form) was "
          f"not counted as such")
    if dplan is not None:
        check(bit_equal(got, ops.chunked_attention(q, k, v, qp, kp, **kw)),
              f"attention {label}: two decode calls differ")
    err, share = attention_err(label, got, q, k, v, qp, kp, **kw)
    mixed = q.dtype != k.dtype
    lq, lk, lv = ((x.float() if mixed else x).transpose(1, 2)
                  for x in (q, k, v))
    mask = kp[:, None, None, :] <= qp[:, None, :, None] if causal else None
    if window > 0:
        mask &= kp[:, None, None, :] > qp[:, None, :, None] - window
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # the operations at the peak of the products' type: bf16 only when q
    # and K/V are both bf16 (an f32 operand promotes the product)
    bf16 = q.dtype == k.dtype == torch.bfloat16
    dv = v.shape[-1]
    bound, by = attention_bound(q, k, qp, kp, window,
                                BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S,
                                dv=dv, causal=causal)
    r = dict(**kernel_times(
        lambda: ops.chunked_attention(q, k, v, qp, kp, **kw),
        lambda: ref.chunked_attention_ref(q, k, v, qp, kp, **kw),
        lambda: sdpa(lq, lk, lv, attn_mask=mask, enable_gqa=True), flush),
        bound_ms=bound, bound_by=by, max_abs_err=err, err_share_of_bar=share,
        dtypes=f"q {str(q.dtype)[6:]}, k/v {str(k.dtype)[6:]}",
        route=ROUTE_SOURCES[route], form=form)
    if dplan is not None:
        r.update(plan=dtext, cluster=dplan.cluster, ctas=dplan.ctas)
    if mixed:
        r["library_operands"] = "promoted to float32 outside its timed window"
    if q.shape[1] > 1:
        r["tc_bound_ms"] = tc_bound(q, k, qp, kp, window, dv, causal)
    print(f"attention {label} ({r['dtypes']}; {r['route']}"
          + (f", {dtext}" if dtext else f", {form} form" if form else "")
          + f") "
          f"S={q.shape[1]} T={k.shape[1]} "
          f"B={q.shape[0]} window {window}"
          f"{'' if causal else ' non-causal'}: max_abs_err {err:.3g} "
          f"({share:.3g} of its bar); kernel "
          f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA "
          f"{r['library_ms']:.4f} ms, bound {bound:.5f} ms ({by})"
          + (f", tensor-core bound {r['tc_bound_ms']:.5f} ms"
             if "tc_bound_ms" in r else "")
          + f"; device time: kernel {r['device_ms']:.4f} ms, SDPA "
          f"{r['library_device_ms']:.4f} ms [{tag}]")
    return r


def wide_and_mixed_rows(dev, gen, flush, tag):
    """Phase 2 at the shapes phases 7-9 launch and no earlier phase does.
    Head dim 256 at gemma-7b's (16 heads, MHA): decode over its D7_MAX_LEN
    cache for D7_SLOTS rows, and the prefill of the buckets of its longest
    and shortest prompts (700 tokens in 1024, 40 in 64), in f32 and bf16.
    The bf16-weight paths (phases 8, 9) at gemma3-27b's: bf16 q over f32
    K/V (bf16 weights over the Engine's f32 cache) in decode over wrapped
    1024-slot rings and the 2048-slot global cache, and in the 1500-token
    prefill under window 1024; the prefill those paths launch, all bf16,
    at that length; at qwen1.5-110b's (64 q / 8 kv heads, head group
    8), bf16 q over its f32 Q_MAX_LEN cache; and at jamba's attention
    layer (32 q / 8 kv heads, head group 4, phase 14), bf16 q over its f32
    J_MAX_LEN cache and the all-bf16 prefill of its longest prompt at
    exact length.  Returns the ``kernels``
    entries (headline rows: the head-dim-256 decode and the mixed ring
    decode), every row in ``shapes``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config

    def case(B, S, H, K, D, qp_np, kp_np, qdt, kvdt):
        T = kp_np.shape[1]
        q = torch.randn((B, S, H, D), device=dev, generator=gen).to(qdt)
        k = torch.randn((B, T, K, D), device=dev, generator=gen).to(kvdt)
        v = torch.randn((B, T, K, D), device=dev, generator=gen).to(kvdt)
        return (q, k, v, torch.from_numpy(qp_np).to(dev),
                torch.from_numpy(kp_np).to(dev))

    f32, bf16 = torch.float32, torch.bfloat16
    g7 = get_config("gemma-7b")
    H, K, D = g7.n_heads, g7.n_kv_heads, g7.head_dim
    wide = {}
    ends = np.array(D7_PROMPTS) + D7_MAX_NEW - 1
    kp_np = np.full((len(ends), D7_MAX_LEN), 2**30, np.int32)
    for b, n in enumerate(ends):
        kp_np[b, :n + 1] = np.arange(n + 1)
    qp_np = ends[:, None].astype(np.int32)
    wide["decode"] = attention_row(
        "gemma-7b decode", *case(len(ends), 1, H, K, D, qp_np, kp_np, f32,
                                 f32), 0, flush, tag)
    for n in (max(D7_PROMPTS), min(D7_PROMPTS)):
        bucket = min(max(16, 1 << (n - 1).bit_length()), D7_MAX_LEN)
        pos = np.full((1, bucket), 2**30, np.int32)
        pos[0, :n] = np.arange(n)               # the Engine's padded bucket
        for dt in (f32, bf16):
            wide[f"prefill_{bucket}_{str(dt)[6:]}"] = attention_row(
                f"gemma-7b prefill bucket {bucket} ({n} tokens)",
                *case(1, bucket, H, K, D, pos, pos, dt, dt), 0, flush, tag)
    short_due(wide[f"prefill_{bucket}_float32"],
              f"gemma-7b f32 prefill bucket {bucket}")

    g3 = get_config("gemma3-27b")
    H, K, D, W = g3.n_heads, g3.n_kv_heads, g3.head_dim, g3.window
    ends = np.array(G_PROMPTS) + G_MAX_NEW - 1
    ring = np.full((len(ends), W), 2**30, np.int32)
    glob = np.full((len(ends), G_MAX_LEN), 2**30, np.int32)
    for b, n in enumerate(ends):
        t = np.arange(max(0, n - W + 1), n + 1)
        ring[b, t % W] = t
        glob[b, :n + 1] = np.arange(n + 1)
    qp_np = ends[:, None].astype(np.int32)
    P = max(G_PROMPTS)
    pre = np.arange(P, dtype=np.int32)[None]
    mixed = {
        "decode_ring": attention_row(
            "gemma3 mixed decode_ring",
            *case(len(ends), 1, H, K, D, qp_np, ring, bf16, f32), W, flush,
            tag),
        "decode_global": attention_row(
            "gemma3 mixed decode_global",
            *case(len(ends), 1, H, K, D, qp_np, glob, bf16, f32), 0, flush,
            tag),
        "prefill_local": attention_row(
            "gemma3 mixed prefill_local",
            *case(1, P, H, K, D, pre, pre, bf16, f32), W, flush, tag),
        "prefill_local_bf16": attention_row(
            "gemma3 bf16 prefill_local",
            *case(1, P, H, K, D, pre, pre, bf16, bf16), W, flush, tag)}
    qw = get_config("qwen1.5-110b")
    ends = np.array(Q_PROMPTS) + Q_MAX_NEW - 1
    kp_np = np.full((len(ends), Q_MAX_LEN), 2**30, np.int32)
    for b, n in enumerate(ends):
        kp_np[b, :n + 1] = np.arange(n + 1)
    mixed["qwen_decode"] = attention_row(
        "qwen1.5 mixed decode",
        *case(len(ends), 1, qw.n_heads, qw.n_kv_heads, qw.head_dim,
              ends[:, None].astype(np.int32), kp_np, bf16, f32), 0, flush,
        tag)
    jb = get_config("jamba-v0.1-52b")
    H, K, D = jb.n_heads, jb.n_kv_heads, jb.head_dim
    ends = np.array(J_PROMPTS) + J_MAX_NEW - 1
    kp_np = np.full((len(ends), J_MAX_LEN), 2**30, np.int32)
    for b, n in enumerate(ends):
        kp_np[b, :n + 1] = np.arange(n + 1)
    mixed["jamba_decode"] = attention_row(
        "jamba mixed decode",
        *case(len(ends), 1, H, K, D, ends[:, None].astype(np.int32), kp_np,
              bf16, f32), 0, flush, tag)
    P = max(J_PROMPTS)                  # state layers prefill at exact length
    pre = np.arange(P, dtype=np.int32)[None]
    mixed[f"jamba_prefill_{P}_bf16"] = attention_row(
        f"jamba bf16 prefill {P}", *case(1, P, H, K, D, pre, pre, bf16, bf16),
        0, flush, tag)
    out = []
    for head, rows in ((wide["decode"], wide), (mixed["decode_ring"], mixed)):
        row = dict(head)
        row["max_abs_err"] = max(r["max_abs_err"] for r in rows.values()
                                 if r["dtypes"] == head["dtypes"])
        row["shapes"] = rows
        out.append(row)
    return out


def head_shape_rows(dev, gen, flush, tag) -> dict:
    """Phase 2 at the published attention shapes phase 26 serves
    (HS_SHAPES), at every (q, K/V) dtype pair phase 26 launches there: for
    each, a prefill of bucket HS_MAX_LEN (B 1, every query valid; under
    DeepSeek-V4-Flash's window 128, its local layer's) in bf16 and in f32,
    and a ragged decode of HS_ROWS rows over T HS_MAX_LEN (its global
    layer's) in bf16, in f32 and with bf16 q over f32 K/V (bf16 weights
    over the Engine's f32 cache); each held to ``ref.attention_bar`` and
    timed beside its plain version and SDPA with its bounds.  Returns the
    ``kernels`` entry: DeepSeek-V4-Pro's bf16 prefill's numbers (128 heads
    over one kv head at width 512, four head slices a query), every row in
    ``shapes``."""
    import numpy as np
    import torch

    def case(B, S, H, K, D, qp, kp, qdt, kvdt):
        T = kp.shape[1]
        q = torch.randn((B, S, H, D), device=dev, generator=gen).to(qdt)
        k = torch.randn((B, T, K, D), device=dev, generator=gen).to(kvdt)
        v = torch.randn((B, T, K, D), device=dev, generator=gen).to(kvdt)
        return (q, k, v, torch.from_numpy(qp).to(dev),
                torch.from_numpy(kp).to(dev))

    pos = np.arange(HS_MAX_LEN, dtype=np.int32)[None]
    lens = np.random.default_rng(SEED + 26).integers(HS_MAX_LEN // 4,
                                                     HS_MAX_LEN + 1,
                                                     HS_ROWS)
    kp = np.full((HS_ROWS, HS_MAX_LEN), 2**30, np.int32)
    for b, n in enumerate(lens):
        kp[b, :n] = np.arange(n)
    qp = (lens - 1)[:, None].astype(np.int32)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {}
    for name, (H, K, D, W) in HS_SHAPES.items():
        for dt in (bf16, f32):
            d = str(dt)[6:]
            rows[f"{name}_prefill_{HS_MAX_LEN}_{d}"] = attention_row(
                f"{name} prefill bucket {HS_MAX_LEN} ({H}/{K} heads, D {D})",
                *case(1, HS_MAX_LEN, H, K, D, pos, pos, dt, dt), W, flush,
                tag)
        for qdt, kvdt, d in ((bf16, bf16, "bfloat16"), (f32, f32, "float32"),
                             (bf16, f32, "mixed")):
            rows[f"{name}_decode_{HS_ROWS}x{HS_MAX_LEN}_{d}"] = attention_row(
                f"{name} decode ({H}/{K} heads, D {D})",
                *case(HS_ROWS, 1, H, K, D, qp, kp, qdt, kvdt), 0, flush, tag)
    head = rows[f"deepseek-v4-pro_prefill_{HS_MAX_LEN}_bfloat16"]
    row = dict(head)
    row["max_abs_err"] = max(r["max_abs_err"] for r in rows.values()
                             if r["dtypes"] == head["dtypes"])
    row["shapes"] = rows
    return row


def head_shape_config(name):
    """tinyllama-1.1b at full width, HS_LAYERS layers, with the attention
    of HS_SHAPES[name] (under a window, layer 0 local and layer 1 global),
    by ``dataclasses.replace`` as the reference's frozen config takes it."""
    import dataclasses

    from repro_torch.configs import get_config

    H, K, D, W = HS_SHAPES[name]
    return dataclasses.replace(
        get_config("tinyllama-1.1b"), n_layers=HS_LAYERS, n_heads=H,
        n_kv_heads=K, head_dim=D, window=W, swa_period=2 if W else 0)


def head_shape_phase(tag) -> dict:
    """Phase 26: each published attention shape of HS_SHAPES on
    tinyllama-1.1b's full width (HS_LAYERS layers, random weights from
    SEED), in f32 and in bf16 weights over the Engine's f32 cache, through
    the Engine (a suspend and a resume wave; tokens equal to the
    uninterrupted run's; the launch counters equal to what the stats call
    for) and the Scheduler.  Returns the launch counts, summed."""
    import torch
    from repro_torch import sched

    total = {}
    for name in HS_SHAPES:
        cfg = head_shape_config(name)
        for dt in (torch.float32, torch.bfloat16):
            label = f"{name} {str(dt)[6:]}"
            params = model_params(
                cfg, dt, label,
                f"{HS_LAYERS} layers of tinyllama-1.1b's width with "
                f"{cfg.n_heads} heads over {cfg.n_kv_heads} kv heads of "
                f"head dim {cfg.head_dim}"
                + (f", window {cfg.window} (layer 0)" if cfg.window else ""))
            wl = sched.WorkloadConfig(n_fresh=4, n_followups=4,
                                      arrival="bursty",
                                      prompt_lens=HS_SCHED_LENS,
                                      new_tokens=(8, 16))
            counts = serve_phase(label, cfg, params,
                                 _prompts(cfg, HS_PROMPTS, SEED + 26), tag,
                                 slots=HS_SLOTS, max_len=HS_MAX_LEN,
                                 n_sessions=HS_SESSIONS,
                                 max_new=HS_MAX_NEW, first=HS_FIRST,
                                 sched_wl=wl, profile=False)
            for key, n in counts.items():
                total[key] = total.get(key, 0) + n
            del params
            torch.cuda.empty_cache()
    return total


def model_params(cfg, dtype, label, why) -> dict:
    """Random weights for ``cfg`` from a CUDA generator seeded with SEED, in
    ``dtype`` (the norms stay f32, as the reference's); prints their size
    and ``why`` the run has this depth."""
    import torch
    from repro_torch.models import lm

    t0 = time.perf_counter()
    params = lm.init_lm(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                        dtype=dtype, device="cuda")
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    n = sum(t.numel() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"{label}: {n} parameters, {nbytes / 1e9:.1f} GB "
          f"({str(dtype).removeprefix('torch.')} weights, f32 norms) in "
          f"{time.perf_counter() - t0:.1f} s; {cfg.n_layers} layers, stages "
          f"(reps, group size) {[(r, len(g)) for r, g in lm.stages_of(cfg)]}"
          f": {why}")
    return params


def serve_phase(label, cfg, params, prompts, tag, *, slots, max_len,
                n_sessions, max_new, first, sched_wl=None,
                profile=True) -> dict:
    """One model served through the Engine: every prompt decoded once
    uninterrupted, then again with a suspend and a resume wave of the two
    longest (one of gemma3's rolled at prefill, one crossing its window in
    decode): tokens must equal the uninterrupted run's, no resume may fail
    its checksums, the stats must add up, and each launch counter, reset
    just before the measured Engine, must equal what its stats call for.
    Prints its sizes, prefill and decode times, the waves' rates and a
    decode profile; with ``sched_wl`` also the Scheduler over a fresh
    Engine (every job completes, resumes equal the resume waves' widths,
    the counters add up, K4 is not launched).  Returns the launch counts of
    its runs, summed."""
    import torch
    from repro_torch import sched
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, Request

    dev = torch.device("cuda")
    kw = dict(slots=slots, max_len=max_len, n_sessions=n_sessions,
              device=dev)
    solo = Engine(cfg, params, **kw)
    solo_reqs = [Request(uid, p, max_new) for uid, p in enumerate(prompts)]
    for r in solo_reqs:
        solo.submit(r)
    while solo.active:
        solo.step()
    solo.resume_many([0, 1], 2)      # warm the resume path before timing it
    while solo.active:
        solo.step()
    del solo
    torch.cuda.empty_cache()

    ops.reset_launch_counts()
    eng = Engine(cfg, params, **kw)
    lengths = sorted({lm.cache_len(cfg, m, max_len)
                      for m in cfg.layer_kinds()})
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(eng.cache))
    store_bytes = sum(t.numel() * t.element_size() for t in
                      (eng.sessions.slow, eng.sessions.fast))
    print(f"{label} snapshot: {eng.snapshot_bytes} B = "
          f"{eng.page_spec.n_pages} pages; cache lengths {lengths}; live "
          f"cache {cache_bytes / 1e9:.2f} GB ({slots} slots, max_len "
          f"{max_len}), session store {store_bytes / 1e9:.2f} GB "
          f"({n_sessions} sessions and the fast tier); card memory "
          f"allocated {torch.cuda.memory_allocated() / 1e9:.1f} GB")
    reqs = [Request(uid, p, max_new) for uid, p in enumerate(prompts)]
    prefill_ms = {}
    for r in reqs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.submit(r)                        # ends in the next-token read
        prefill_ms[len(r.prompt)] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(first):
        eng.step()
    decode_s = time.perf_counter() - t0
    wave = sorted(eng.active, key=lambda s: len(eng.active[s].prompt))[-2:]
    held = {s: eng.active[s] for s in wave}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.suspend_many(wave)
    torch.cuda.synchronize()
    suspend_s = time.perf_counter() - t0
    uids = [held[s].uid for s in wave]
    extra = [max_new - len(held[s].generated) + 1 for s in wave]
    t0 = time.perf_counter()
    slots_back = eng.resume_many(uids, extra)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    resumed = {eng.active[s].uid: eng.active[s] for s in slots_back}
    while eng.active:
        eng.step()
    counts = ops.launch_counts()

    for r, s in zip(reqs, solo_reqs):
        got = (r.generated + resumed[r.uid].generated[1:]
               if r.uid in resumed else r.generated)
        check(len(s.generated) == max_new and got == s.generated,
              f"{label} uid {r.uid}: tokens differ from the uninterrupted "
              f"run")
    check(eng.verify_failure_count() == 0,
          f"{label}: a resume failed its checksums")
    check(int(eng.verify_store()) == 0, f"{label}: the store fails its scrub")
    st = eng.stats
    n_susp, n_res = len(wave) + len(reqs), len(wave)
    check(st["prefills"] == len(reqs) and st["suspends"] == n_susp
          and st["resumes"] == n_res, f"{label} stats counts: {st}")
    check(st["decoded_tokens"] == len(reqs) * (max_new - 1),
          f"{label} decoded_tokens {st['decoded_tokens']}")
    check(st["decode_dispatches"] == st["host_transfers"], "one read a step")
    want = (n_susp * eng.plan_suspend.cost.ns_lisa
            + n_res * eng.plan_resume.cost.ns_lisa)
    check(math.isclose(st["modeled_move_ns_lisa"], want, rel_tol=1e-9),
          f"{label}: modeled movement does not add up")
    check_counts(counts, serving_launches(cfg, eng), f"{label}'s Engine path")
    print(f"{label} serving: tokens match the uninterrupted run for all "
          f"{len(reqs)} requests ({len(wave)} suspended+resumed); launches "
          f"{json.dumps(counts)}; stats {json.dumps(st)}")
    snap = eng.snapshot_bytes
    print(f"{label} decode: {first} steps x {slots} slots, "
          f"{decode_s / first * 1e3:.3f} ms/step, "
          f"{first * slots / decode_s:.1f} tok/s [{tag}]")
    for n, ms in prefill_ms.items():
        print(f"{label} prefill {n} tokens: {ms:.3f} ms [{tag}]")
    print(f"{label} suspend wave of {len(wave)}: {suspend_s * 1e3:.3f} ms, "
          f"{len(wave) * snap / suspend_s / 1e9:.2f} GB/s [{tag}]")
    print(f"{label} resume wave of {len(wave)}: {resume_s * 1e3:.3f} ms, "
          f"{len(wave) * snap / resume_s / 1e9:.2f} GB/s [{tag}]")
    if profile:
        profile_decode(eng, tag, label=f"{label} profile",
                       experts=cfg.n_experts)
    del eng
    torch.cuda.empty_cache()
    if sched_wl is None:
        return counts

    # the Scheduler over a fresh Engine
    arrivals = sched.generate_workload(sched_wl, seed=4,
                                       vocab_size=cfg.vocab_size)
    eng = Engine(cfg, params, slots=slots, max_len=max_len,
                 n_sessions=sched.n_sessions_for(sched_wl), device=dev)
    ops.reset_launch_counts()
    s = sched.Scheduler(eng, policy="cost_aware", arrivals=arrivals)
    t0 = time.perf_counter()
    summary = s.run()
    torch.cuda.synchronize()
    sched_s = time.perf_counter() - t0
    sched_counts = ops.launch_counts()
    st = eng.stats
    jobs = sched_wl.n_fresh + sched_wl.n_followups
    check(summary["jobs_completed"] == jobs
          and all(j.state == "done" for j in s.jobs()),
          f"{label} scheduler: not every job completed")
    check(st["resumes"] == sum(s.metrics.wave_widths("resume_wave")),
          f"{label} scheduler: resumes outside the resume waves")
    check(st["decode_dispatches"] == st["host_transfers"],
          f"{label} scheduler: not one host read per decode dispatch")
    check(eng.verify_failure_count() == 0,
          f"{label} scheduler: a resume failed its checksums")
    check_counts(sched_counts, serving_launches(cfg, eng),
                 f"{label} scheduler")
    print(f"{label} scheduler: {summary['jobs_completed']} jobs, "
          f"{st['decoded_tokens']} tokens in {s.tick_count} ticks, "
          f"{sched_s:.3f} s, {st['decoded_tokens'] / sched_s:.1f} tok/s, "
          f"{st['prefills']} prefills, {st['suspends']} suspends, "
          f"{st['resumes']} resumes, launches {json.dumps(sched_counts)} "
          f"[{tag}]")
    del eng, s
    torch.cuda.empty_cache()
    return {name: counts[name] + sched_counts[name] for name in counts}


def _prompts(cfg, lens, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def gemma3_phase(tag) -> dict:
    """Phase 6: full-width gemma3-27b cut to G_LAYERS layers (f32) through
    the Engine (4 slots, max_len 2048, a suspend and a resume wave of ring
    caches) and the Scheduler (prompts on both sides of the window)."""
    import dataclasses

    import torch
    from repro_torch import sched
    from repro_torch.configs import get_config, param_count

    full = get_config("gemma3-27b")
    cfg = dataclasses.replace(full, n_layers=G_LAYERS)
    params = model_params(
        cfg, torch.float32, "gemma3-27b",
        f"{G_LAYERS} of {full.n_layers} layers: at full depth the f32 "
        f"weights ({4 * param_count(full) / 1e9:.0f} GB) do not fit in the "
        f"card's memory, and {G_LAYERS} layers run both stages (the 5:1 "
        f"local/global periods and the local tail)")
    wl = sched.WorkloadConfig(n_fresh=6, n_followups=12, arrival="bursty",
                              prompt_lens=G_SCHED_LENS, new_tokens=(8, 16))
    counts = serve_phase("gemma3", cfg, params,
                         _prompts(cfg, G_PROMPTS, SEED + 6), tag,
                         slots=G_SLOTS, max_len=G_MAX_LEN,
                         n_sessions=G_SESSIONS, max_new=G_MAX_NEW,
                         first=G_FIRST, sched_wl=wl)
    del params
    torch.cuda.empty_cache()
    return counts


def gemma7b_phase(tag) -> dict:
    """Phase 7: gemma-7b at full width, D7_LAYERS of its 28 layers (head dim
    256, MHA, GeGLU, tied embeddings; f32, the reference's serving precision)
    through the Engine and the Scheduler: K3 at head dim 256 on both
    routes."""
    import dataclasses

    import torch
    from repro_torch import sched
    from repro_torch.configs import get_config

    full = get_config("gemma-7b")
    cfg = dataclasses.replace(full, n_layers=D7_LAYERS)
    params = model_params(cfg, torch.float32, "gemma-7b",
                          f"{D7_LAYERS} of {full.n_layers} layers (the f32 "
                          f"weights fit at full depth; cut to pay for "
                          f"phase 26)")
    wl = sched.WorkloadConfig(n_fresh=6, n_followups=12, arrival="bursty",
                              prompt_lens=D7_SCHED_LENS, new_tokens=(8, 16))
    counts = serve_phase("gemma-7b", cfg, params,
                         _prompts(cfg, D7_PROMPTS, SEED + 7), tag,
                         slots=D7_SLOTS, max_len=D7_MAX_LEN,
                         n_sessions=D7_SESSIONS, max_new=D7_MAX_NEW,
                         first=D7_FIRST, sched_wl=wl)
    del params
    torch.cuda.empty_cache()
    return counts


def gemma3_bf16_phase(tag) -> dict:
    """Phase 8: gemma3-27b at all 62 layers with bf16 weights over the
    Engine's f32 cache (the reference Engine's own cache dtype): prefill
    runs K3 in bf16, decode its bf16-q-over-f32-K/V route; the Engine's
    waves, then the Scheduler."""
    import torch
    from repro_torch import sched
    from repro_torch.configs import get_config

    cfg = get_config("gemma3-27b")
    params = model_params(cfg, torch.bfloat16, "gemma3-27b bf16",
                          "full depth: bf16 weights fit where f32 ones "
                          "(108 GB) do not")
    wl = sched.WorkloadConfig(n_fresh=G62_SESSIONS, n_followups=8,
                              arrival="bursty", prompt_lens=G_SCHED_LENS,
                              new_tokens=(8, 16))
    counts = serve_phase("gemma3-62L bf16", cfg, params,
                         _prompts(cfg, G_PROMPTS, SEED + 8), tag,
                         slots=G_SLOTS, max_len=G_MAX_LEN,
                         n_sessions=G62_SESSIONS, max_new=G_MAX_NEW,
                         first=G_FIRST, sched_wl=wl)
    del params
    torch.cuda.empty_cache()
    return counts


def qwen_phase(tag) -> dict:
    """Phase 9: qwen1.5-110b (QKV bias, GQA 64/8, head dim 128) at full
    width with bf16 weights, cut to Q_LAYERS of its 80 layers: a short
    Engine run with one suspend and one resume wave."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config, param_count

    full = get_config("qwen1.5-110b")
    cfg = dataclasses.replace(full, n_layers=Q_LAYERS)
    params = model_params(
        cfg, torch.bfloat16, "qwen1.5-110b bf16",
        f"{Q_LAYERS} of {full.n_layers} layers: all {full.n_layers} in "
        f"bf16 are {2 * param_count(full) / 1e9:.0f} GB, past the card's "
        f"80 GB; "
        f"every layer is alike (dense, QKV bias), so depth adds no path")
    counts = serve_phase("qwen1.5", cfg, params,
                         _prompts(cfg, Q_PROMPTS, SEED + 9), tag,
                         slots=Q_SLOTS, max_len=Q_MAX_LEN,
                         n_sessions=Q_SESSIONS, max_new=Q_MAX_NEW,
                         first=Q_FIRST, profile=False)
    del params
    torch.cuda.empty_cache()
    return counts


def mla_and_moe_rows(dev, gen, flush, tag):
    """Phase 2 at the shapes phases 10-11 launch.  deepseek-v2's MLA
    prefill: q and K (1, S, 128, 192), V (1, S, 128, 128), causal, for the
    1024 bucket of a 700-token prompt and the 64 bucket of a 40-token one
    (pads at 2**30, as the Engine's buckets), in bf16 (phase 11's path)
    and f32 (the other instantiation the wrapper takes).  olmoe-1b-7b's
    (16 heads MHA, head dim 128, f32): the prefill of the 1024 bucket of
    its longest prompt and of the 64 bucket of O_SHORT_PROMPT (the short
    form's), and a decode over its 1024-slot cache for O_SLOTS
    rows with ragged ends.  Each held to ``ref.attention_bar`` and timed
    beside its plain version and SDPA, which takes Dv != Dk.  Returns the
    two ``kernels`` entries: MLA's headline the bf16 bucket-1024 row,
    olmoe's its decode row (16 layers launch it every step), every row in
    ``shapes``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config

    def case(S, H, dk, dv, n, dt):
        pos = np.full((1, S), 2**30, np.int32)
        pos[0, :n] = np.arange(n)
        q = torch.randn((1, S, H, dk), device=dev, generator=gen).to(dt)
        k = torch.randn((1, S, H, dk), device=dev, generator=gen).to(dt)
        v = torch.randn((1, S, H, dv), device=dev, generator=gen).to(dt)
        qp = torch.from_numpy(pos).to(dev)
        return q, k, v, qp, qp

    ds = get_config("deepseek-v2-236b")
    dk, dv = ds.qk_nope_dim + ds.qk_rope_dim, ds.v_head_dim
    mla = {}
    for bucket, n in MLA_BUCKETS:
        for dt in (torch.bfloat16, torch.float32):
            mla[f"prefill_{bucket}_{str(dt)[6:]}"] = attention_row(
                f"deepseek-v2 MLA prefill bucket {bucket} ({n} tokens)",
                *case(bucket, ds.n_heads, dk, dv, n, dt), 0, flush, tag)
    bucket = min(b for b, _ in MLA_BUCKETS)
    short_due(mla[f"prefill_{bucket}_float32"],
              f"deepseek-v2 MLA f32 prefill bucket {bucket}")
    om = get_config("olmoe-1b-7b")
    H, K, D = om.n_heads, om.n_kv_heads, om.head_dim
    moe = {}
    for n in (max(O_PROMPTS), O_SHORT_PROMPT):
        bucket = min(max(16, 1 << (n - 1).bit_length()), O_MAX_LEN)
        moe[f"prefill_{bucket}"] = attention_row(
            f"olmoe prefill bucket {bucket} ({n} tokens)",
            *case(bucket, H, D, D, n, torch.float32), 0, flush, tag)
    short_due(moe[f"prefill_{bucket}"], f"olmoe f32 prefill bucket {bucket}")
    ends = np.array(O_PROMPTS) + O_MAX_NEW - 1
    kp_np = np.full((len(ends), O_MAX_LEN), 2**30, np.int32)
    for b, e in enumerate(ends):
        kp_np[b, :e + 1] = np.arange(e + 1)
    B = len(ends)
    q = torch.randn((B, 1, H, D), device=dev, generator=gen)
    k = torch.randn((B, O_MAX_LEN, K, D), device=dev, generator=gen)
    v = torch.randn((B, O_MAX_LEN, K, D), device=dev, generator=gen)
    moe["decode"] = attention_row(
        "olmoe decode", q, k, v,
        torch.from_numpy(ends[:, None].astype(np.int32)).to(dev),
        torch.from_numpy(kp_np).to(dev), 0, flush, tag)
    out = []
    for head, rows in ((mla["prefill_1024_bfloat16"], mla),
                       (moe["decode"], moe)):
        row = dict(head)
        row["max_abs_err"] = max(r["max_abs_err"] for r in rows.values()
                                 if r["dtypes"] == head["dtypes"])
        row["shapes"] = rows
        out.append(row)
    return out


def int8_rows(dev, gen, flush, tag) -> dict:
    """Phase 2's K3d rows: the decode kernel over int8 K/V with per-token,
    per-head f32 scales, quantised from random K/V by the model's own
    quantiser, at the shapes the int8 decode paths give it: tinyllama
    (I8_B rows, T 1024, 32/4 heads, D 64; ragged ends), gemma3's ring
    (window 1024, 1024 slots whose positions have wrapped) and global
    layer (T 2048), and jamba's attention layer (32/8 heads, D 128, T
    1024).  Each held within 3e-5 of its plain version on the same inputs
    and timed beside it and beside SDPA, which takes no int8 K/V with
    scales: its K/V are dequantised outside its timed window.  Bounds
    count the int8 K/V, their scales (8 bytes a row and kv head), q, the
    output and the positions.  Returns the ``kernels`` entry: tinyllama's
    numbers (the int8 decode_step phase launches it), every shape's in
    ``shapes``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models.attention import quantise

    sdpa = torch.nn.functional.scaled_dot_product_attention
    g3 = get_config("gemma3-27b")
    W = g3.window
    ends = np.array(G_PROMPTS) + G_MAX_NEW - 1
    ring = np.full((len(ends), W), 2**30, np.int32)
    glob = np.full((len(ends), G_MAX_LEN), 2**30, np.int32)
    for b, n in enumerate(ends):
        t = np.arange(max(0, n - W + 1), n + 1)
        ring[b, t % W] = t
        glob[b, :n + 1] = np.arange(n + 1)
    rng = np.random.default_rng(SEED + 12)
    ragged = rng.integers(MAX_LEN // 8, MAX_LEN, I8_B)
    lin = np.full((I8_B, MAX_LEN), 2**30, np.int32)
    for b, n in enumerate(ragged):
        lin[b, :n] = np.arange(n)
    tl, jb = get_config("tinyllama-1.1b"), get_config("jamba-v0.1-52b")
    shapes = {  # name: (heads, kv heads, D, q positions, kv positions, window)
        "tinyllama": (tl.n_heads, tl.n_kv_heads, tl.head_dim,
                      ragged - 1, lin, 0),
        "gemma3_ring": (g3.n_heads, g3.n_kv_heads, g3.head_dim, ends, ring,
                        W),
        "gemma3_global": (g3.n_heads, g3.n_kv_heads, g3.head_dim, ends,
                          glob, 0),
        "jamba": (jb.n_heads, jb.n_kv_heads, jb.head_dim, ragged - 1, lin,
                  0)}
    out = {}
    for name, (H, K, D, qp_np, kp_np, window) in shapes.items():
        B, T = kp_np.shape
        qp = torch.from_numpy(qp_np[:, None].astype(np.int32)).to(dev)
        kp = torch.from_numpy(kp_np).to(dev)
        q = torch.randn((B, 1, H, D), device=dev, generator=gen)
        (k8, ks), (v8, vs) = (quantise(torch.randn(
            (B, T, K, D), device=dev, generator=gen)) for _ in range(2))
        args = (q, k8, v8, qp, kp)
        kw = dict(window=window, k_scale=ks, v_scale=vs)
        got = ops.chunked_attention(*args, **kw)
        want = ref.chunked_attention_ref(*args, **kw)
        err = float((got - want).abs().max())
        check(err <= 3e-5, f"int8 decode {name}: error {err} > 3e-5")
        kf, vf = k8.float() * ks[..., None], v8.float() * vs[..., None]
        mask = kp[:, None, None, :] <= qp[:, None, :, None]
        if window > 0:
            mask &= kp[:, None, None, :] > qp[:, None, :, None] - window
        qt, kt, vt = q.transpose(1, 2), kf.transpose(1, 2), vf.transpose(1, 2)
        bound, by = attention_bound(q, k8, qp, kp, window, scale_bytes=8)
        dplan, text = decode_form(q, k8, f"int8 decode {name}",
                                  due="cluster" if name == "tinyllama"
                                  else None)
        check(bit_equal(got, ops.chunked_attention(*args, **kw)),
              f"int8 decode {name}: two calls differ")
        r = out[name] = dict(
            **kernel_times(lambda: ops.chunked_attention(*args, **kw),
                           lambda: ref.chunked_attention_ref(*args, **kw),
                           lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                        enable_gqa=True), flush),
            bound_ms=bound, bound_by=by, max_abs_err=err,
            dtypes="q float32, k/v int8 with f32 scales",
            library_operands="SDPA over K/V dequantised to float32 outside "
                             "its timed window (no PyTorch call takes int8 "
                             "K/V with scales)",
            plan=text, form=dplan.form, cluster=dplan.cluster,
            ctas=dplan.ctas)
        print(f"attention int8 decode {name} (B={B} T={T} {H}/{K} heads "
              f"D={D} window {window}; {r['plan']}): max_abs_err {err:.3g}; "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA "
              f"(dequantised K/V) {r['library_ms']:.4f} ms, bound "
              f"{bound:.5f} ms ({by}); device time: kernel "
              f"{r['device_ms']:.4f} ms, SDPA {r['library_device_ms']:.4f} "
              f"ms [{tag}]")
    row = {k: v for k, v in out["tinyllama"].items() if k != "plan"}
    row["max_abs_err"] = max(r["max_abs_err"] for r in out.values())
    row["shapes"] = out
    return row


def vl_positions(prefix, grid_h, grid_w, suffix):
    """(3, prefix + h*w + suffix) int32 ids as Qwen2-VL numbers a text
    prefix, one image of an h x w patch grid and a text suffix: text at
    ids 0..prefix-1 (all three equal), patch (i, j) at temporal id
    ``prefix``, height ``prefix + i``, width ``prefix + j``, and the text
    after it from ``prefix + max(h, w)`` on."""
    import numpy as np
    ids = [np.tile(np.arange(prefix), (3, 1))]
    i, j = np.divmod(np.arange(grid_h * grid_w), grid_w)
    ids.append(np.stack([np.full_like(i, prefix), prefix + i, prefix + j]))
    start = prefix + max(grid_h, grid_w)
    ids.append(np.tile(np.arange(start, start + suffix), (3, 1)))
    return np.concatenate(ids, 1).astype(np.int32)


def encdec_and_mrope_rows(dev, gen, flush, tag):
    """Phase 2 at the shapes phases 15-16 launch.  seamless-m4t-medium's
    (16/16 heads, D 64, f32): (a) the encoder, S_B rows of S_FRAMES
    frames, non-causal; (b) cross attention in prefill, the S_PROMPT-token
    prompts over the frames, queries at 2**29 and frames at 0, and the
    same with each row's last 96 frames at 2**30 (an encoder mask's
    pads); (c) cross attention in decode, S_B rows over the frames; (d)
    the decoder's self-attention in decode over its S_MAX_LEN cache at
    the last step's position (G 1: the head group of 2).  qwen2-vl-72b's
    (64/8 heads, D 128, bf16): (e) the prefill of V_IMG_LEN tokens at
    exact length whose temporal ids repeat over a V_IMG_GRID^2 patch
    block after a V_IMG_PREFIX-token text prefix.  Each held to
    ``ref.attention_bar`` and timed beside its plain version and SDPA.
    Returns the two ``kernels`` entries: enc-dec's headline the cross
    decode (12 layers launch it every step), M-RoPE's row (e)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config

    def case(B, S, T, H, K, D, qp_np, kp_np, dt):
        q = torch.randn((B, S, H, D), device=dev, generator=gen).to(dt)
        k = torch.randn((B, T, K, D), device=dev, generator=gen).to(dt)
        v = torch.randn((B, T, K, D), device=dev, generator=gen).to(dt)
        return (q, k, v, torch.from_numpy(np.ascontiguousarray(qp_np)).to(dev),
                torch.from_numpy(np.ascontiguousarray(kp_np)).to(dev))

    sm = get_config("seamless-m4t-medium")
    H, D, B, T, f32 = sm.n_heads, sm.head_dim, S_B, S_FRAMES, torch.float32
    frames = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    cross_q = np.full((B, S_PROMPT), 2**29, np.int32)
    valid = np.zeros((B, T), np.int32)
    padded = valid.copy()
    padded[:, -96:] = 2**30
    end = S_PROMPT + S_STEPS - 1             # the last decode step's position
    self_kv = np.full((B, S_MAX_LEN), 2**30, np.int32)
    self_kv[:, :end + 1] = np.arange(end + 1)
    ed = {
        "encoder": attention_row(
            "seamless encoder", *case(B, T, T, H, H, D, frames, frames, f32),
            0, flush, tag, causal=False),
        "cross_prefill": attention_row(
            "seamless cross prefill",
            *case(B, S_PROMPT, T, H, H, D, cross_q, valid, f32), 0, flush,
            tag),
        "cross_prefill_pads": attention_row(
            "seamless cross prefill, 96 pad frames",
            *case(B, S_PROMPT, T, H, H, D, cross_q, padded, f32), 0, flush,
            tag),
        "cross_decode": attention_row(
            "seamless cross decode",
            *case(B, 1, T, H, H, D, cross_q[:, :1], valid, f32), 0, flush,
            tag),
        "self_decode": attention_row(
            "seamless self decode (G 1)",
            *case(B, 1, S_MAX_LEN, H, H, D, np.full((B, 1), end, np.int32),
                  self_kv, f32), 0, flush, tag)}
    vl = get_config("qwen2-vl-72b")
    suffix = V_IMG_LEN - V_IMG_PREFIX - V_IMG_GRID ** 2
    pos = vl_positions(V_IMG_PREFIX, V_IMG_GRID, V_IMG_GRID, suffix)[:1]
    mr = {f"prefill_{V_IMG_LEN}_image_bf16": attention_row(
        f"qwen2-vl bf16 prefill {V_IMG_LEN} (a {V_IMG_GRID}x{V_IMG_GRID} "
        f"image's repeated temporal ids)",
        *case(1, V_IMG_LEN, V_IMG_LEN, vl.n_heads, vl.n_kv_heads,
              vl.head_dim, pos, pos, torch.bfloat16), 0, flush, tag)}
    out = []
    for head, rows in ((ed["cross_decode"], ed),
                       (mr[f"prefill_{V_IMG_LEN}_image_bf16"], mr)):
        row = dict(head)
        row["max_abs_err"] = max(r["max_abs_err"] for r in rows.values()
                                 if r["dtypes"] == head["dtypes"])
        row["shapes"] = rows
        out.append(row)
    return out


def split_family_rows(dev, gen, flush, tag) -> dict:
    """Phase 2 at the K3 shapes phase 24's mesh steps launch and no
    earlier row holds: each device's local heads of the folded stack
    (SS_BATCH rows on each of 2 devices at 1 x 2, 2 rows on each of 4 at
    2 x 2: 8 rows).  deepseek-v2's MLA prefill (64 of 128 heads, Dk 192 /
    Dv 128, bf16); jamba's attention layer (16/4 of 32/8 heads, D 128):
    the bf16 prefill and the decode of bf16 q over the f32 cache;
    seamless-m4t-medium's (8 of 16 heads, D 64, f32): the encoder over
    SS_FRAMES frames, non-causal, cross attention in prefill and decode,
    and the decoder's self-attention in decode.  Each held to
    ``ref.attention_bar`` and timed beside its plain version and SDPA.
    Returns {kernels entry: {shape name: row}}."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config

    B, S, L, T = 8, SS_PROMPT, SS_MAX_LEN, SS_FRAMES
    last = SS_PROMPT + SS_STEPS - 1          # the last decode step's position
    causal = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    frames = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    cache = np.full((B, L), 2**30, np.int32)
    cache[:, :last + 1] = np.arange(last + 1)
    at_last = np.full((B, 1), last, np.int32)

    def case(S, T, H, K, dk, dv, qp, kp, qdt, kvdt):
        q = torch.randn((B, S, H, dk), device=dev, generator=gen).to(qdt)
        k = torch.randn((B, T, K, dk), device=dev, generator=gen).to(kvdt)
        v = torch.randn((B, T, K, dv), device=dev, generator=gen).to(kvdt)
        return (q, k, v, torch.from_numpy(qp).to(dev),
                torch.from_numpy(kp).to(dev))

    bf, f32 = torch.bfloat16, torch.float32
    ds = get_config("deepseek-v2-236b")
    dk = ds.qk_nope_dim + ds.qk_rope_dim
    jb = get_config("jamba-v0.1-52b")
    jh, jk, jd = jb.n_heads // 2, jb.n_kv_heads // 2, jb.head_dim
    sm = get_config("seamless-m4t-medium")
    sh, sd = sm.n_heads // 2, sm.head_dim
    cross_q = np.full((B, S), 2**29, np.int32)
    cross_d = np.full((B, 1), 2**29, np.int32)
    valid = np.zeros((B, T), np.int32)
    return {
        "flash_attention_mla": {
            "mesh_prefill_64_heads_bf16": attention_row(
                "deepseek-v2 MLA mesh prefill, 64 local heads", *case(
                    S, S, ds.n_heads // 2, ds.n_heads // 2, dk,
                    ds.v_head_dim, causal, causal, bf, bf), 0, flush, tag)},
        "flash_attention_mixed": {
            "jamba_mesh_prefill_bf16": attention_row(
                "jamba mesh prefill, 16/4 local heads", *case(
                    S, S, jh, jk, jd, jd, causal, causal, bf, bf), 0,
                flush, tag),
            "jamba_mesh_decode": attention_row(
                "jamba mesh decode, 16/4 local heads", *case(
                    1, L, jh, jk, jd, jd, at_last, cache, bf, f32), 0,
                flush, tag)},
        "flash_attention_encdec": {
            "mesh_encoder_8_heads": attention_row(
                "seamless mesh encoder, 8 local heads", *case(
                    T, T, sh, sh, sd, sd, frames, frames, f32, f32), 0,
                flush, tag, causal=False),
            "mesh_cross_prefill": attention_row(
                "seamless mesh cross prefill, 8 local heads", *case(
                    S, T, sh, sh, sd, sd, cross_q, valid, f32, f32), 0,
                flush, tag),
            "mesh_cross_decode": attention_row(
                "seamless mesh cross decode, 8 local heads", *case(
                    1, T, sh, sh, sd, sd, cross_d, valid, f32, f32), 0,
                flush, tag),
            "mesh_self_decode": attention_row(
                "seamless mesh self decode, 8 local heads", *case(
                    1, L, sh, sh, sd, sd, at_last, cache, f32, f32), 0,
                flush, tag)},
    }


def repeat_decode(label, cfg, params, prompts, slots, max_len) -> None:
    """One decode batch run twice, each from its own copy of the same cache
    (prefilled with ``prompts``, one a slot, the last slot idle): the
    logits and both caches must be bit-equal, which the MoE combine's fixed
    order of summation makes them."""
    import numpy as np
    import torch
    from repro_torch.models import lm

    dev = torch.device("cuda")
    cache = lm.init_cache(cfg, slots, max_len, device=dev)
    for s, p in enumerate(prompts[:slots - 1]):
        lm.prefill(cfg, params, torch.from_numpy(p)[None].to(dev), cache,
                   slot=s)
    lens = [len(p) for p in prompts[:slots - 1]] + [0]
    active = np.array([n > 0 for n in lens])
    toks = torch.tensor([int(p[-1]) for p in prompts[:slots - 1]] + [0],
                        device=dev)
    pos = torch.tensor(lens, dtype=torch.int32, device=dev)
    copies = [{st: {b: {k: t.clone() for k, t in c.items()}
                    for b, c in blocks.items()}
               for st, blocks in cache.items()} for _ in range(2)]
    del cache
    logits = [lm.decode_logits(cfg, params, c, toks, pos, active)
              for c in copies]
    torch.cuda.synchronize()
    check(bit_equal(logits[0], logits[1]),
          f"{label}: a decode batch run twice gives different logits")
    check(all(bit_equal(a, b) for a, b in zip(_leaves(copies[0]),
                                                _leaves(copies[1]))),
          f"{label}: a decode batch run twice writes different caches")
    print(f"{label}: one decode batch of {int(active.sum())} rows, run twice "
          f"from two copies of one cache: logits and caches bit-equal")
    del copies
    torch.cuda.empty_cache()


def olmoe_phase(tag) -> dict:
    """Phase 10: olmoe-1b-7b at full width, O_LAYERS of its 16 layers
    (attn_full + MoE, f32)
    through the Engine and the Scheduler, K3 on both routes at head dim 128
    and G 1; one decode batch run twice must give bit-equal logits."""
    import dataclasses

    import torch
    from repro_torch import sched
    from repro_torch.configs import get_config

    full = get_config("olmoe-1b-7b")
    cfg = dataclasses.replace(full, n_layers=O_LAYERS)
    params = model_params(cfg, torch.float32, "olmoe-1b-7b",
                          f"{O_LAYERS} of {full.n_layers} layers (the f32 "
                          f"weights fit at full depth; cut to pay for "
                          f"phase 26)")
    prompts = _prompts(cfg, O_PROMPTS, SEED + 10)
    repeat_decode("olmoe", cfg, params, prompts, O_SLOTS, O_MAX_LEN)
    wl = sched.WorkloadConfig(n_fresh=6, n_followups=12, arrival="bursty",
                              prompt_lens=O_SCHED_LENS, new_tokens=(8, 16))
    counts = serve_phase("olmoe", cfg, params, prompts, tag, slots=O_SLOTS,
                         max_len=O_MAX_LEN, n_sessions=O_SESSIONS,
                         max_new=O_MAX_NEW, first=O_FIRST, sched_wl=wl)
    del params
    torch.cuda.empty_cache()
    return counts


def deepseek_phase(tag) -> dict:
    """Phase 11: deepseek-v2-236b at full width with bf16 weights over the
    Engine's f32 cache, cut to DS_LAYERS of its 60 layers, or to as many as
    the card's free memory holds beside DS_RESERVE bytes (at least
    DS_MIN_LAYERS): the Engine with one suspend and one resume wave.  Its
    prefill runs K3 at Dk 192 / Dv 128 in bf16; its decode the absorbed
    einsums over the compressed cache."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config, param_count

    full = get_config("deepseek-v2-236b")
    one = 2 * param_count(dataclasses.replace(full, n_layers=1))
    layer = 2 * param_count(dataclasses.replace(full, n_layers=2)) - one
    free, _ = torch.cuda.mem_get_info()
    fit = int((free - DS_RESERVE - (one - layer)) // layer)
    n = min(DS_LAYERS, fit)
    check(n >= DS_MIN_LAYERS, f"deepseek-v2: {free / 1e9:.1f} GB free holds "
          f"{fit} layers, fewer than {DS_MIN_LAYERS}")
    cfg = dataclasses.replace(full, n_layers=n)
    params = model_params(
        cfg, torch.bfloat16, "deepseek-v2-236b bf16",
        f"{n} of {full.n_layers} layers ({DS_LAYERS} asked; "
        f"{free / 1e9:.1f} GB free held {fit} beside {DS_RESERVE / 1e9:.0f} "
        f"GB kept for the Engine): all {full.n_layers} in bf16 are "
        f"{2 * param_count(full) / 1e9:.0f} GB, past the card's 80 GB, and "
        f"every layer is alike (MLA + MoE), so depth adds no path")
    counts = serve_phase("deepseek-v2", cfg, params,
                         _prompts(cfg, DS_PROMPTS, SEED + 11), tag,
                         slots=DS_SLOTS, max_len=DS_MAX_LEN,
                         n_sessions=DS_SESSIONS, max_new=DS_MAX_NEW,
                         first=DS_FIRST)
    del params
    torch.cuda.empty_cache()
    return counts


def int8_decode_phase(tag) -> dict:
    """Phase 12: full-width tinyllama-1.1b (f32) decodes I8_B rows token by
    token for I8_STEPS teacher-forced steps through ``lm.decode_step``
    from an empty cache, once over an int8 cache (K3d: every layer's
    attention runs the decode kernel over int8 K/V with their scales) and
    once over an f32 one, each against the port's ``forward`` over the
    same tokens: the relative error of the logits must stay below 0.05,
    the reference's bar (its tests/test_int8_kv.py).  The int8 run must
    launch K3d layers x steps times and nothing else.  Returns the launch
    counts of the forward, the int8 run and the f32 run."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    dev = torch.device("cuda")
    cfg = get_config("tinyllama-1.1b")
    params = model_params(cfg, torch.float32, "tinyllama-1.1b (int8 KV)",
                          "full depth: the f32 weights fit")
    toks = torch.from_numpy(np.random.default_rng(SEED + 12).integers(
        0, cfg.vocab_size, (I8_B, I8_STEPS)).astype(np.int32)).to(dev)
    ops.reset_launch_counts()
    full, _, _ = lm.forward(cfg, params, toks)
    torch.cuda.synchronize()
    out = {"forward": ops.launch_counts()}
    top = float(full.abs().max())
    greedy = {}
    for dt in (torch.int8, torch.float32):
        name = str(dt).removeprefix("torch.")
        cache = lm.init_cache(cfg, I8_B, I8_STEPS, dtype=dt, device=dev)
        logits = torch.empty_like(full)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for t in range(I8_STEPS):
            lg, _ = lm.decode_step(cfg, params, cache, toks[:, t:t + 1], t)
            logits[:, t] = lg[:, 0]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = out[name] = ops.launch_counts()
        err = float((logits - full).abs().max()) / (top + 1e-9)
        greedy[name] = logits.argmax(-1)
        check(bool(torch.isfinite(logits).all()) and err < 0.05,
              f"int8 phase: decode over the {name} cache is {err:.4g} from "
              f"forward (relative), the bar is 0.05")
        due = cfg.n_layers * I8_STEPS
        want = {"flash_attention": due, "flash_attention_decode": due}
        if dt == torch.int8:
            want["flash_attention_decode_int8"] = due
        check_counts(counts, want, f"the {name} decode_step run")
        if dt == torch.int8:
            hold_int8_cache(cfg, cache, dev, tag)
        cache_bytes = sum(t.numel() * t.element_size()
                          for t in _leaves(cache))
        print(f"int8 phase, {name} cache ({cache_bytes / 1e6:.1f} MB at "
              f"{I8_B} rows x {I8_STEPS} slots): {I8_STEPS} decode_step "
              f"calls, {secs / I8_STEPS * 1e3:.3f} ms a step; logits "
              f"{err:.4g} from forward relative to its largest "
              f"({top:.3f}); launches {json.dumps(counts)} [{tag}]")
        del cache
    agree = float((greedy["int8"] == greedy["float32"]).float().mean())
    print(f"int8 phase: greedy tokens of the int8 and f32 caches agree at "
          f"{agree:.4f} of {I8_B * I8_STEPS} positions")
    del params, full
    torch.cuda.empty_cache()
    return out


def hold_int8_cache(cfg, cache, dev, tag) -> None:
    """K3d against its plain version at phase 12's own shapes and split
    plan (I8_B rows, T I8_STEPS, uniform positions): the last layer's int8
    K/V, scales and positions as the run left them, and as they stood
    after step I8_STEPS // 2 (decode writes slot t at step t, so the later
    slots held code 0, scale 0 and position 2**30 then), each under a q
    drawn at the path's (B, 1, H, D); within 3e-5.  Run after the path's
    launches were read, so they do not count."""
    import torch
    from repro_torch.kernels import ops, ref

    c = next(b for st in cache.values() for b in st.values()
             if "k_scale" in b)
    last = {name: t[-1] for name, t in c.items()}      # (B, L, ...) leaves
    gen = torch.Generator(device=dev).manual_seed(SEED + 120)
    q = torch.randn((I8_B, 1, cfg.n_heads, cfg.head_dim), device=dev,
                    generator=gen)
    for n in (I8_STEPS // 2 + 1, I8_STEPS):
        keep = torch.arange(I8_STEPS, device=dev) < n
        k8, v8 = (torch.where(keep[None, :, None, None], last[x], 0)
                  for x in ("k", "v"))
        ks, vs = (torch.where(keep[None, :, None], last[x], 0.0)
                  for x in ("k_scale", "v_scale"))
        kp = torch.where(keep[None], last["pos"], 2**30)
        qp = torch.full((I8_B, 1), n - 1, dtype=torch.int32, device=dev)
        kw = dict(k_scale=ks, v_scale=vs)
        got = ops.chunked_attention(q, k8, v8, qp, kp, **kw)
        err = float((got - ref.chunked_attention_ref(q, k8, v8, qp, kp,
                                                     **kw)).abs().max())
        check(k8.dtype == torch.int8 and err <= 3e-5,
              f"int8 phase: K3d over the path's cache after step {n - 1} "
              f"is {err} from its plain version, the bar is 3e-5")
        print(f"int8 phase: K3d over layer {cfg.n_layers - 1}'s int8 cache "
              f"after step {n - 1} (T {I8_STEPS}, {n} slots written): "
              f"max_abs_err {err:.3g} [{tag}]")


def rwkv_phase(tag) -> dict:
    """Phase 13: rwkv6-7b at full width, R_LAYERS of its 32 rwkv layers (f32)
    through the Engine (4 slots, exact-length prompts of 16-500, a suspend
    and a resume wave of the 34.6 MB state snapshots) and the Scheduler;
    it launches no K3."""
    import dataclasses

    import torch
    from repro_torch import sched
    from repro_torch.configs import get_config

    full = get_config("rwkv6-7b")
    cfg = dataclasses.replace(full, n_layers=R_LAYERS)
    params = model_params(cfg, torch.float32, "rwkv6-7b",
                          f"{R_LAYERS} of {full.n_layers} layers (the f32 "
                          f"weights fit at full depth; cut to pay for "
                          f"phase 26)")
    wl = sched.WorkloadConfig(n_fresh=6, n_followups=12, arrival="bursty",
                              prompt_lens=R_SCHED_LENS, new_tokens=(8, 16))
    counts = serve_phase("rwkv6-7b", cfg, params,
                         _prompts(cfg, R_PROMPTS, SEED + 13), tag,
                         slots=R_SLOTS, max_len=R_MAX_LEN,
                         n_sessions=R_SESSIONS, max_new=R_MAX_NEW,
                         first=R_FIRST, sched_wl=wl)
    del params
    torch.cuda.empty_cache()
    return counts


def jamba_phase(tag) -> dict:
    """Phase 14: jamba-v0.1-52b at full width with bf16 weights over the
    Engine's f32 cache, cut to J_LAYERS of its 32 layers (two periods of 7
    mamba layers and 1 attention layer, MoE every other layer, 16 experts
    top-2): the Engine with one suspend and one resume wave.  Its
    attention layers run K3: bf16 prefill at each prompt's exact length,
    decode of bf16 q over the f32 cache."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config, param_count

    full = get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(full, n_layers=J_LAYERS)
    params = model_params(
        cfg, torch.bfloat16, "jamba-v0.1-52b bf16",
        f"{J_LAYERS} of {full.n_layers} layers: all {full.n_layers} in "
        f"bf16 are {2 * param_count(full) / 1e9:.0f} GB, past the card's "
        f"80 GB; {J_LAYERS} are two whole periods of the 8-layer pattern")
    counts = serve_phase("jamba", cfg, params,
                         _prompts(cfg, J_PROMPTS, SEED + 14), tag,
                         slots=J_SLOTS, max_len=J_MAX_LEN,
                         n_sessions=J_SESSIONS, max_new=J_MAX_NEW,
                         first=J_FIRST)
    del params
    torch.cuda.empty_cache()
    return counts


def seamless_phase(tag) -> dict:
    """Phase 15: seamless-m4t-medium at full width and depth (f32) through
    its enc-dec path: ``lm.init_cache(..., enc_len=S_FRAMES)``,
    ``lm.prefill`` of S_B S_PROMPT-token prompts with their frame
    embeddings, then S_STEPS teacher-forced ``lm.decode_step`` calls.
    Every logit of the prefill and the steps must stay within 1e-4 of the
    cacheless ``lm.forward`` over the whole sequence, relative to its
    largest (the reference's own bar, its
    tests/test_decode_consistency.py), and K3 must launch 3 x 12 times a
    prefill (encoder, self, cross) and 2 x 12 a step.  Prints the prefill's
    ms, its encoder's alone, ms a step and the greedy agreement.  Returns
    the launch counts of the forward and of the prefill and steps."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    dev = torch.device("cuda")
    cfg = get_config("seamless-m4t-medium")
    params = model_params(cfg, torch.float32, "seamless-m4t-medium",
                          f"full depth ({cfg.n_enc_layers} encoder layers): "
                          f"the f32 weights fit")
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    frames = torch.randn((S_B, S_FRAMES, cfg.d_model), device=dev,
                         generator=gen) * 0.02
    toks = torch.from_numpy(np.random.default_rng(SEED + 15).integers(
        0, cfg.vocab_size, (S_B, S_PROMPT + S_STEPS)).astype(np.int32)
                            ).to(dev)
    ops.reset_launch_counts()
    full, _, _ = lm.forward(cfg, params, toks, enc_embeds=frames)
    torch.cuda.synchronize()
    out = {"forward": ops.launch_counts()}
    top = float(full.abs().max())
    enc_ms = []
    for _ in range(3):                      # the encoder alone, warm
        t0 = time.perf_counter()
        lm._encode(cfg, params, frames)
        torch.cuda.synchronize()
        enc_ms.append((time.perf_counter() - t0) * 1e3)
    cache = lm.init_cache(cfg, S_B, S_MAX_LEN, device=dev, enc_len=S_FRAMES)
    logits = torch.empty_like(full)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lg, _ = lm.prefill(cfg, params, toks[:, :S_PROMPT], cache,
                       enc_embeds=frames)
    logits[:, :S_PROMPT] = lg
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for t in range(S_PROMPT, S_PROMPT + S_STEPS):
        lg, _ = lm.decode_step(cfg, params, cache, toks[:, t:t + 1], t)
        logits[:, t] = lg[:, 0]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / S_STEPS * 1e3
    counts = out["path"] = ops.launch_counts()
    err = float((logits - full).abs().max()) / (top + 1e-9)
    check(bool(torch.isfinite(logits).all()) and err < 1e-4,
          f"seamless: prefill + decode_step logits are {err:.4g} from "
          f"forward (relative to its largest), the bar is 1e-4")
    n = cfg.n_layers
    pre, dec = 3 * n, 2 * n * S_STEPS
    check_counts(counts, {"flash_attention": pre + dec,
                          "flash_attention_prefill": pre,
                          "flash_attention_decode": dec},
                 "seamless's prefill and decode_step path")
    check_counts(out["forward"], {"flash_attention": 3 * n,
                                  "flash_attention_prefill": 3 * n},
                 "seamless's forward")
    agree = float((logits.argmax(-1) == full.argmax(-1)).float().mean())
    c = cache["stage0"]["b0"]
    check(not c["enc_pos"].any() and bool(c["enc_k"][-1].any()),
          "seamless: the prefill did not write every layer's cross K/V")
    cache_bytes = sum(t.numel() * t.element_size() for t in _leaves(cache))
    print(f"seamless: prefill of {S_B} x {S_PROMPT} tokens over {S_FRAMES} "
          f"frames {prefill_ms:.3f} ms, its encoder alone "
          f"{statistics.median(enc_ms):.3f} ms; {S_STEPS} decode_step calls "
          f"{step_ms:.3f} ms a step; cache {cache_bytes / 1e9:.2f} GB; "
          f"logits {err:.4g} from forward relative to its largest "
          f"({top:.3f}); greedy agreement {agree:.4f} of "
          f"{S_B * (S_PROMPT + S_STEPS)} positions; launches "
          f"{json.dumps(counts)} [{tag}]")
    del params, full, logits, cache
    torch.cuda.empty_cache()
    return out


def qwen2vl_layers(full) -> tuple:
    """(layers, GB of weights, GB the card keeps free) of phase 16: the
    most of qwen2-vl-72b's layers whose bf16 weights, with the embedding
    and head and the Engine's cache and store (V_SLOTS live slots,
    V_SESSIONS stored ones and the fast tier's 2, f32 K/V and positions at
    V_MAX_LEN), leave V_RESERVE of the card free, and room besides for the
    head's f32 draw, the largest temporary of ``init_lm``, which comes
    last; at least V_LAYERS."""
    import dataclasses

    import torch
    from repro_torch.configs import param_count

    fixed = 2 * param_count(dataclasses.replace(full, n_layers=0))
    layer = 2 * param_count(dataclasses.replace(full, n_layers=1)) - fixed
    draw = 4 * full.vocab_size * full.d_model
    slot = V_MAX_LEN * (2 * full.n_kv_heads * full.head_dim + 1) * 4
    per = layer + (V_SLOTS + V_SESSIONS + 2) * slot
    free = torch.cuda.mem_get_info()[0]
    n = min(full.n_layers, max(V_LAYERS, int(
        (free - V_RESERVE - draw - fixed) // per)))
    return n, (fixed + n * layer) / 1e9, (free - fixed - n * per) / 1e9


def qwen2vl_phase(tag) -> dict:
    """Phase 16: qwen2-vl-72b (M-RoPE, QKV bias, GQA 64/8, head dim 128)
    at full width with bf16 weights over the Engine's f32 cache, cut to
    ``qwen2vl_layers``' count: the Engine (exact-length prompts at (3, 1,
    n) arange positions, a suspend and a resume wave) and the Scheduler
    over a fresh Engine; then ``lm.prefill`` of an image prompt (phase 2's
    row (e): V_IMG_LEN tokens whose temporal ids repeat over a
    V_IMG_GRID^2 patch block) into a fresh batch-1 cache, whose positions
    must be the temporal ids and whose logits must equal a cacheless
    ``lm.forward`` over the same ids within 2e-2 (bf16).  Returns the
    launch counts of its runs, summed."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import sched
    from repro_torch.configs import get_config, param_count
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    dev = torch.device("cuda")
    full = get_config("qwen2-vl-72b")
    n, gb, left = qwen2vl_layers(full)
    cfg = dataclasses.replace(full, n_layers=n)
    params = model_params(
        cfg, torch.bfloat16, "qwen2-vl-72b bf16",
        f"{n} of {full.n_layers} layers ({gb:.1f} GB of weights, "
        f"{left:.1f} GB of the card left beside the Engine's cache and "
        f"store): all {full.n_layers} in bf16 are "
        f"{2 * param_count(full) / 1e9:.0f} GB, past the card's 80 GB; "
        f"every layer is alike (dense, QKV bias, M-RoPE)")
    wl = sched.WorkloadConfig(n_fresh=6, n_followups=12, arrival="bursty",
                              prompt_lens=V_SCHED_LENS, new_tokens=(8, 16))
    counts = serve_phase("qwen2-vl", cfg, params,
                         _prompts(cfg, V_PROMPTS, SEED + 16), tag,
                         slots=V_SLOTS, max_len=V_MAX_LEN,
                         n_sessions=V_SESSIONS, max_new=V_MAX_NEW,
                         first=V_FIRST, sched_wl=wl)
    suffix = V_IMG_LEN - V_IMG_PREFIX - V_IMG_GRID ** 2
    pos = torch.from_numpy(vl_positions(V_IMG_PREFIX, V_IMG_GRID,
                                        V_IMG_GRID, suffix)[:, None]).to(dev)
    toks = torch.from_numpy(_prompts(cfg, [V_IMG_LEN], SEED + 160)[0]
                            )[None].to(dev)
    cache = lm.init_cache(cfg, 1, V_MAX_LEN, device=dev)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, _ = lm.prefill(cfg, params, toks, cache, positions=pos)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    image = ops.launch_counts()
    check_counts(image, {"flash_attention": n, "flash_attention_prefill": n,
                         "flash_attention_prefill_wgmma": n},
                 "qwen2-vl's image prefill")
    want, _, _ = lm.forward(cfg, params, toks, positions=pos)
    err = float((got.float() - want.float()).abs().max())
    check(bool(torch.isfinite(got).all()) and err <= 2e-2,
          f"qwen2-vl: the image prefill's logits are {err} from forward, "
          f"the bar is 2e-2")
    for st in cache.values():
        for c in st.values():
            check(torch.equal(c["pos"][:, 0, :V_IMG_LEN],
                              pos[0].expand(c["pos"].shape[0], V_IMG_LEN)),
                  "qwen2-vl: the image prefill's cache positions are not "
                  "the temporal ids")
            check(bool((c["pos"][:, 0, V_IMG_LEN:] == 2**30).all()),
                  "qwen2-vl: the image prefill wrote past its tokens")
    print(f"qwen2-vl image prefill: {V_IMG_LEN} tokens ({V_IMG_PREFIX} text, "
          f"a {V_IMG_GRID}x{V_IMG_GRID} image at temporal id "
          f"{V_IMG_PREFIX}, {suffix} text), {ms:.3f} ms; logits "
          f"{err:.3g} from forward; cache positions the temporal ids; "
          f"launches {json.dumps(image)} [{tag}]")
    del params, cache, got, want
    torch.cuda.empty_cache()
    return {name: counts[name] + image[name] for name in counts}


def train_attention_row(dev, gen, flush, tag) -> tuple:
    """Phase 2's K3e rows at the training shape of phase 19 (b): f32, B
    T_BATCH x S T_SEQ, tinyllama's 32 q / 4 kv heads, head dim 64, causal.
    Under grad the forward is the prefill kernel (within 3e-5 of the plain
    twin, writing each row's log-sum-exp) and the backward one call of the
    backward kernel (csrc/flash_backward.cu, counted in
    ``chunked_attention.backward``): for each of dq, dk and dv the relative
    L2 gap to the twin's autograd gradients in f64 is at most BW_RATIO
    times the f32 twin's own (its largest gap printed), and two calls give
    bit-equal gradients.  Returns two rows.  K3e's: forward plus backward
    timed against the plain twin's and SDPA's (``is_causal``), bound by
    that work (q, k, v and the upstream gradient read, the output and
    dq/dk/dv written; 14*H*D FLOP a valid (query, key) pair, 4 forward and
    10 backward: the scores again, dV, dP, dQ and dK, at the f32 peak),
    beside the forward alone (the same kernel without grad) with its f32
    and tensor-core bounds.  The backward kernel's: the backward alone
    from the saved output and log-sum-exp, against the twin's autograd
    backward and SDPA's backward (each of a recorded graph), bound by
    10*H*D FLOP a valid pair at the f32 peak and by the bytes of q, k, v,
    the output, dO and the log-sum-exp read and dq, dk and dv written; its
    tensor-core bound three TF32 products each at the TF32 peak."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops, ref

    B, S, H, K, D = T_BATCH, T_SEQ, 32, 4, 64
    q = torch.randn((B, S, H, D), device=dev, generator=gen)
    k = torch.randn((B, S, K, D), device=dev, generator=gen)
    v = torch.randn((B, S, K, D), device=dev, generator=gen)
    up = torch.randn((B, S, H, D), device=dev, generator=gen)
    pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    pos = pos.contiguous()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    twins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.chunked_attention(*leaves, pos, pos)
    want = ref.chunked_attention_ref(*twins, pos, pos)
    err = float((out - want).abs().max())
    check(err <= 3e-5 and out.grad_fn is not None
          and type(out.grad_fn).__name__ == "TrainAttentionBackward",
          f"K3e forward: error {err} (bar 3e-5) or no K3e grad_fn "
          f"({type(out.grad_fn).__name__})")
    n0 = FA.chunked_attention.backward
    got = torch.autograd.grad(out, leaves, up)
    check(FA.chunked_attention.backward == n0 + 1,
          f"K3e backward: {FA.chunked_attention.backward - n0} kernel "
          f"calls, 1 due")
    again = torch.autograd.grad(ops.chunked_attention(*leaves, pos, pos),
                                leaves, up)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    check(same, "K3e backward: two calls give different gradients")
    exp = torch.autograd.grad(want, twins, up)
    f64 = ref.twin_grads_f64(q, k, v, pos, pos, up)
    gaps = [ref.rel_l2(a, x) for a, x in zip(got, f64)]
    twin_gaps = [ref.rel_l2(e, x) for e, x in zip(exp, f64)]
    grad_err = max(float((a.double() - x).abs().max())
                   for a, x in zip(got, f64))
    check(all(g <= BW_RATIO * t for g, t in zip(gaps, twin_gaps)),
          f"K3e backward: relative L2 gaps of dq, dk, dv to the f64 twin "
          f"{gaps}, the f32 twin's {twin_gaps} (bar {BW_RATIO}x)")
    del out, want, got, again, exp, f64

    def k3e():
        o = ops.chunked_attention(*leaves, pos, pos)
        return torch.autograd.grad(o, leaves, up)

    def plain():
        o = ref.chunked_attention_ref(*twins, pos, pos)
        return torch.autograd.grad(o, twins, up)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = [t.detach().transpose(1, 2).contiguous().requires_grad_()
           for t in (q, k, v)]
    up_t = up.transpose(1, 2).contiguous()

    def library():
        o = sdpa(*lib, is_causal=True, enable_gqa=True)
        return torch.autograd.grad(o, lib, up_t)

    r = kernel_times(k3e, plain, library, flush)
    with torch.no_grad():
        fwd = lambda: ops.chunked_attention(q, k, v, pos, pos)  # noqa: E731
        r["forward_ms"] = timed(fwd, flush=flush)
        r["forward_device_ms"] = timed(fwd, flush=flush, device=True)
    r["forward_bound_ms"], fwd_by = attention_bound(q, k, pos, pos, 0)
    r["forward_tc_bound_ms"] = tc_bound(q, k, pos, pos, 0)
    pairs = B * S * (S + 1) // 2
    nbytes = 4 * (3 * B * S * H * D + 3 * B * S * K * D * 2
                  + 2 * pos.numel())
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 14 * H * D * pairs / F32_FLOP_PER_S
    r.update(bound_ms=max(t_bytes, t_ops) * 1e3,
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             max_abs_err=err, grads_rel_l2=gaps, twin_rel_l2=twin_gaps,
             timed="forward + backward (dq, dk, dv); library: SDPA "
                   "is_causal forward + backward")

    # the backward alone, from the saved output and log-sum-exp
    lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    with torch.no_grad():
        o = FA.chunked_attention(q, k, v, pos, pos, lse=lse)
    saved = ref.chunked_attention_ref(*twins, pos, pos)
    lib_out = sdpa(*lib, is_causal=True, enable_gqa=True)
    rb = kernel_times(
        lambda: FA.attention_backward(q, k, v, o, lse, up, pos, pos),
        lambda: torch.autograd.grad(saved, twins, up, retain_graph=True),
        lambda: torch.autograd.grad(lib_out, lib, up_t, retain_graph=True),
        flush)
    b_bytes = 4 * (4 * B * S * H * D + 4 * B * S * K * D + B * H * S
                   + 2 * pos.numel()) / HBM_BYTES_PER_S
    b_ops = 10 * H * D * pairs / F32_FLOP_PER_S
    rb.update(bound_ms=max(b_bytes, b_ops) * 1e3,
              bound_by="bytes" if b_bytes >= b_ops else "operations",
              tc_bound_ms=3 * 10 * H * D * pairs / PEAK_TF32_FLOPS * 1e3,
              max_abs_err=grad_err, grads_rel_l2=gaps,
              twin_rel_l2=twin_gaps, grads_bit_equal_call_to_call=same,
              timed="backward alone (dq, dk, dv from the saved output "
                    "and log-sum-exp); plain: the twin's autograd "
                    "backward; library: SDPA's autograd backward")
    print(f"attention train (K3e) B {B} S {S} 32/4 heads D 64 f32: forward "
          f"+ backward {r['ms']:.4f} ms (device {r['device_ms']:.4f}), "
          f"plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms "
          f"(device {r['library_device_ms']:.4f}), bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}); forward alone "
          f"{r['forward_ms']:.4f} ms (device {r['forward_device_ms']:.4f}),"
          f" bound {r['forward_bound_ms']:.4f} ms ({fwd_by}), tensor-core "
          f"bound {r['forward_tc_bound_ms']:.4f} ms; forward error {err:.3g}"
          f" [{tag}]")
    print(f"attention backward (K3e, csrc/flash_backward.cu) alone: "
          f"{rb['ms']:.4f} ms (device {rb['device_ms']:.4f}), the twin's "
          f"backward {rb['plain_ms']:.4f} ms, SDPA's backward "
          f"{rb['library_ms']:.4f} ms (device "
          f"{rb['library_device_ms']:.4f}), bound {rb['bound_ms']:.4f} ms "
          f"({rb['bound_by']}), tensor-core bound {rb['tc_bound_ms']:.4f} "
          f"ms; dq, dk, dv relative L2 gaps to the f64 twin "
          f"{', '.join(f'{g:.3g}' for g in gaps)} (the f32 twin's "
          f"{', '.join(f'{t:.3g}' for t in twin_gaps)}; bar {BW_RATIO}x), "
          f"largest gap {grad_err:.3g}; bit-equal call to call; one "
          f"backward call counted [{tag}]")
    del leaves, twins, lib, saved, lib_out, o, lse
    torch.cuda.empty_cache()
    return r, rb


def dram_phase(tag) -> dict:
    """Phase 18: the paper's DRAM evaluation through the port on the card,
    each part also on the CPU in this process, the two held together.

    (a) Table 1 through ``substrate.execute_copy`` on a full-geometry
        DDR3_1600 bank (16 subarrays x 64 rows x 8 KiB, random from a
        seed): each destination row bit-equal to its source, latency and
        energy the spec's ``table1()``, the input bank unchanged, and the
        card's resulting state bit-equal to the CPU's;
    (b) bench_fig3_fig4's grid: DRAM_CONFIGS' six configs x 50 workloads
        of DRAM_GRID_REQUESTS requests, as 300 lanes of one
        ``controller.simulate_grid``; its wall seconds and requests a
        second;
    (c) the demo's trace, cut to DRAM_DEMO_REQUESTS requests, under its
        six configs.
    For (b) and (c): VILLA hits and accesses equal to the CPU's, the
    floats within DRAM_FLOAT_BAR (rtol; it prints whether they are
    bit-equal), and the orderings tests/test_dram_controller.py asserts.
    Returns the numbers it printed."""
    import numpy as np
    import torch
    from repro_torch.core.dram import substrate as S
    from repro_torch.core.dram.controller import (MechanismConfig,
                                                  simulate_grid,
                                                  weighted_speedup)
    from repro_torch.core.dram.spec import DDR3_1600
    from repro_torch.core.dram.traces import (Trace, TraceConfig,
                                              generate_batch)
    from repro_torch.examples import lisa_dram_demo as demo

    dev = torch.device("cuda")
    fields = ("cells", "row_buffer", "rb_valid", "open_row")
    spec = DDR3_1600
    bank = S.make_bank(spec, generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)
    cpu_bank = S.BankState(*(getattr(bank, f).cpu() for f in fields))
    keep = bank.cells.clone()
    out = {"table1": {}}
    for mech, (lat, ene) in spec.table1().items():
        name, ssa, srow, dsa, drow = DRAM_COPIES[mech]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = S.execute_copy(bank, name, ssa, srow, dsa, drow, spec=spec)
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) * 1e6
        cres = S.execute_copy(cpu_bank, name, ssa, srow, dsa, drow,
                              spec=spec)
        check(torch.equal(res.state.cells[dsa, drow], bank.cells[ssa, srow])
              and res.latency_ns == lat and res.energy_uj == ene,
              f"Table 1 {mech}: the row or the cost differs "
              f"({res.latency_ns} ns, {res.energy_uj} uJ; want {lat}, {ene})")
        check(all(torch.equal(getattr(res.state, f).cpu(),
                              getattr(cres.state, f)) for f in fields),
              f"Table 1 {mech}: the card's bank state differs from the CPU's")
        out["table1"][mech] = {"latency_ns": lat, "energy_uJ": ene,
                               "us": us}
        print(f"table1 {mech}: {lat} ns, {ene} uJ, the copy "
              f"{us:.1f} us on the host clock [{tag}]")
    check(torch.equal(bank.cells, keep), "a copy changed its input bank")
    del bank, cpu_bank, keep, res, cres

    def held(label, grid, cgrid):
        for key in ("villa_hits", "villa_accesses"):
            check(torch.equal(grid[key].cpu(), cgrid[key]),
                  f"{label}: {key} differ between the card and the CPU")
        exact = {}
        for key in ("core_stall", "energy_uJ", "avg_latency_ns",
                    "villa_hit_rate"):
            a, b = grid[key].cpu().double(), cgrid[key].double()
            rel = float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
            check(rel <= DRAM_FLOAT_BAR,
                  f"{label}: {key} {rel:.3g} from the CPU's (bar "
                  f"{DRAM_FLOAT_BAR})")
            exact[key] = ("bit-equal" if torch.equal(grid[key].cpu(),
                                                     cgrid[key])
                          else f"rel {rel:.3g}")
        return exact

    # (b) the fig3/fig4 grid
    cells = [(cp, z, sd) for cp in DRAM_COPY_PROBS for z in DRAM_ZIPFS
             for sd in DRAM_SEEDS]
    tcfg = TraceConfig(n_requests=DRAM_GRID_REQUESTS)
    traces = generate_batch([torch.Generator().manual_seed(sd)
                             for _, _, sd in cells],
                            [cp for cp, _, _ in cells],
                            [z for _, z, _ in cells], tcfg, device=dev)
    names = ["base", "lisa", "villa", "comb", "rc_villa", "lip"]
    mcfgs = [MechanismConfig("memcpy"), MechanismConfig("lisa"),
             MechanismConfig("lisa", use_villa=True),
             MechanismConfig("lisa", use_villa=True, use_lip=True),
             MechanismConfig("memcpy", use_villa=True,
                             villa_copy_mech="rc_intersa"),
             MechanismConfig("memcpy", use_lip=True)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = simulate_grid(traces, tcfg, mcfgs)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cgrid = simulate_grid(Trace(*(x.cpu() for x in traces)), tcfg, mcfgs)
    cpu_s = time.perf_counter() - t0
    exact = held("the fig3/fig4 grid", grid, cgrid)
    lanes = len(mcfgs) * len(cells)
    g = {k: v.cpu().numpy() for k, v in grid.items()}
    ws = {n: np.asarray(weighted_speedup(torch.from_numpy(
        g["core_stall"][0]), torch.from_numpy(g["core_stall"][i])))
        for i, n in enumerate(names)}
    gm = lambda xs: float(np.exp(np.mean(np.log(np.maximum(xs, 1e-9)))))  # noqa: E731
    gms = {n: gm(w) for n, w in ws.items()}
    hit = float(np.mean(g["villa_hit_rate"][2]))
    en_red = float(np.mean(1 - g["energy_uJ"][3] / g["energy_uJ"][0]))
    check(gms["lisa"] > 1.0 and gms["villa"] > gms["lisa"]
          and gms["comb"] > gms["villa"] and 1.0 < gms["lip"] < 1.5
          and gms["rc_villa"] < 1.0 and en_red > 0.3,
          f"the fig3/fig4 grid breaks the paper's orderings: {gms}, "
          f"energy reduction {en_red}")
    for j, (cp, z, _) in enumerate(cells):
        if (cp, z) in ((0.002, 1.0), (0.02, 1.6)):
            check(ws["lisa"][j] > 1.0 and ws["comb"][j] > 0.95 * ws["lisa"][j],
                  f"workload {cells[j]}: lisa {ws['lisa'][j]}, combined "
                  f"{ws['comb'][j]} (test_workload_sweep_orderings_hold)")
    rps = lanes * DRAM_GRID_REQUESTS / card_s
    out["grid"] = {"lanes": lanes, "card_s": card_s, "cpu_s": cpu_s,
                   "requests_per_s": rps, "cpu_requests_per_s":
                   lanes * DRAM_GRID_REQUESTS / cpu_s, "exact": exact,
                   "hit_rate": hit, "energy_reduction": en_red,
                   "ws_geomean": gms}
    print(f"fig3/fig4 grid: {len(mcfgs)} configs x {len(cells)} workloads x "
          f"{DRAM_GRID_REQUESTS} requests = {lanes} lanes: card {card_s:.3f} "
          f"s wall ({rps:.0f} requests/s), CPU {cpu_s:.3f} s; against the "
          f"CPU: hits and accesses equal, {json.dumps(exact)} [{tag}]")
    print(f"fig3 villa hit rate {hit:.3f} (paper 0.15-0.8); villa over risc "
          f"+{(gms['villa'] / gms['lisa'] - 1) * 100:.1f}% (paper +16.5%); "
          f"rc_villa {(gms['rc_villa'] - 1) * 100:.1f}% (paper -52.3%); "
          f"fig4 risc +{(gms['lisa'] - 1) * 100:.1f}% (paper +59.6%), lip "
          f"over risc+villa +{(gms['comb'] / gms['villa'] - 1) * 100:.1f}% "
          f"(paper +8.8%), lip alone +{(gms['lip'] - 1) * 100:.1f}% (paper "
          f"+10.3%), combined +{(gms['comb'] - 1) * 100:.1f}% (paper "
          f"+94.8%), energy -{en_red * 100:.1f}% (paper -49%)")
    del traces, grid, cgrid

    # (c) the demo's trace under its six configs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, grid = demo.system_eval(dev, n_requests=DRAM_DEMO_REQUESTS)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, cgrid = demo.system_eval("cpu", n_requests=DRAM_DEMO_REQUESTS)
    cpu_s = time.perf_counter() - t0
    exact = held("the demo's trace", grid, cgrid)
    stall = grid["core_stall"].cpu()[:, 0]
    ws = [float(weighted_speedup(stall[0], stall[i]))
          for i in range(len(demo.CONFIGS))]
    e = grid["energy_uJ"].cpu()[:, 0]
    red = 1 - float(e[4]) / float(e[0])
    hit = float(grid["villa_hit_rate"][3, 0])
    check(ws[2] > ws[1] > ws[0] == 1.0 and ws[3] > ws[2] and ws[4] > ws[3]
          and ws[5] < 1.0 and red > 0.3 and hit > 0.3,
          f"the demo's trace breaks the paper's orderings: WS {ws}, energy "
          f"reduction {red}, hit rate {hit}")
    out["demo"] = {"card_s": card_s, "cpu_s": cpu_s, "ws": ws,
                   "energy_reduction": red, "hit_rate": hit, "exact": exact}
    print(f"demo trace ({DRAM_DEMO_REQUESTS} requests x {len(demo.CONFIGS)} "
          f"configs): card {card_s:.3f} s wall, CPU {cpu_s:.3f} s; WS "
          f"{[round(w, 4) for w in ws]}, combined energy -{red * 100:.1f}%, "
          f"villa hit rate {hit:.3f}; against the CPU: hits and accesses "
          f"equal, {json.dumps(exact)} [{tag}]")
    return out


def train_phase(tag) -> tuple:
    """Phase 19: training on the card.

    (a) reduced tinyllama with tests/test_train_loop.py's recipe for
        TL_STEPS steps from params drawn on the CPU: the ce of the last 4
        steps at least 0.15 below the first 4's, and the first TL_MATCH
        losses within TL_BAR of the CPU port's run from the same params
        and batches;
    (b) full-width tinyllama-1.1b in f32 through ``launch.train.run`` for
        T_STEPS steps of T_BATCH x T_SEQ tokens: every loss and grad norm
        finite; then the same run checkpointed at step T_CKPT (the process
        "crashes" right after that save) and resumed from it: the resumed
        run's params bit-equal to the uninterrupted run's and its losses
        (``last_loss`` among them) equal;
    (c) K3's launches in each run: its prefill kernel layers x forward
        passes (the backward launches none), no decode, no K1/K2/K4.
    Returns K3's launches by route over (a) and (b), and (b)'s
    uninterrupted run's history (``launch.train.run``'s third value)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import manager
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import lm
    from repro_torch.optim.adamw import OptConfig, tree_leaves, tree_map
    from repro_torch.train import step as TS

    dev = torch.device("cuda")
    total = {"prefill": 0, "decode": 0, "backward": 0}

    def counted(n_layers, passes, path, remat=False):
        """K3e forwards: a layer's each forward pass, again in the
        backward's recompute under remat; its backward kernel once a layer
        a step."""
        counts = ops.launch_counts()
        n = n_layers * passes * (2 if remat else 1)
        check_counts(counts, {"flash_attention": n,
                              "flash_attention_prefill": n,
                              "flash_attention_backward": n_layers * passes},
                     path)
        total["prefill"] += counts["flash_attention_prefill"]
        total["decode"] += counts["flash_attention_decode"]
        total["backward"] += counts["flash_attention_backward"]

    # (a)
    cfg = get_reduced("tinyllama-1.1b")
    pcfg = TS.ParallelConfig(fsdp=False)
    step = TS.make_train_step(cfg, pcfg, OptConfig(
        lr=8e-3, warmup_steps=2, total_steps=TL_STEPS))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4,
                      repeat_len=8)
    params = lm.init_lm(cfg, torch.Generator().manual_seed(SEED),
                        device="cpu")
    # the card's state first: the CPU's steps (donated, as the reference's
    # make_train_step) update params in place
    card = TS.state_from_params(
        tree_map(lambda p: p.to(dev, copy=True), params), pcfg)
    st = TS.state_from_params(params, pcfg)
    cpu_losses = []
    for i in range(TL_MATCH):
        st, m = step(st, batch_at(dcfg, i, device="cpu"))
        cpu_losses.append(float(m["loss"]))
    st = card
    ops.reset_launch_counts()
    losses, ces = [], []
    for i in range(TL_STEPS):
        st, m = step(st, batch_at(dcfg, i, device=dev))
        losses.append(float(m["loss"]))
        ces.append(float(m["ce"]))
    counted(cfg.n_layers, TL_STEPS, "reduced training", cfg.remat)
    diff = max(abs(a - b) for a, b in zip(losses, cpu_losses))
    drop = statistics.mean(ces[:4]) - statistics.mean(ces[-4:])
    check(drop >= 0.15, f"reduced training: ce fell {drop} over {TL_STEPS} "
                        f"steps (test_train_loop's bar 0.15)")
    check(diff <= TL_BAR, f"reduced training: losses {diff} from the CPU "
                          f"port's (bar {TL_BAR})")
    print(f"train (a) reduced tinyllama: ce {ces[0]:.4f} -> {ces[-1]:.4f} "
          f"over {TL_STEPS} steps (the last 4 {drop:.4f} below the first "
          f"4), first {TL_MATCH} losses within {diff:.3g} of the CPU "
          f"port's [{tag}]")
    del st, card, params

    # (b) full width, uninterrupted; then checkpointed, crashed, resumed
    full = get_config("tinyllama-1.1b")
    argv = ["--arch", "tinyllama-1.1b", "--steps", str(T_STEPS), "--lr",
            str(T_LR), "--batch", str(T_BATCH), "--seq", str(T_SEQ),
            "--seed", str(SEED), "--log-every", "5"]
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res_a, st_a, hist_a = launch_train.run(argv)
    run_s = time.perf_counter() - t0
    counted(full.n_layers, T_STEPS, "the full-width training run",
            full.remat)
    check(all(math.isfinite(x) for x in hist_a["losses"]
              + hist_a["grad_norms"]),
          f"full-width training: a loss or grad norm is not finite "
          f"{hist_a}")
    n_params = sum(p.numel() for p in tree_leaves(st_a.params))
    params_a = st_a.params
    del st_a
    torch.cuda.empty_cache()
    step_ms = statistics.median(hist_a["step_s"][1:]) * 1e3
    tok_s = T_BATCH * T_SEQ / step_ms * 1e3
    print(f"train (b) full-width tinyllama-1.1b f32 ({n_params} params), "
          f"{T_BATCH} x {T_SEQ} tokens a step: {T_STEPS} steps, loss "
          f"{res_a['first_loss']:.4f} -> {res_a['last_loss']:.4f}; "
          f"{step_ms:.1f} ms a step (median of steps 2-{T_STEPS}; the "
          f"first {hist_a['step_s'][0] * 1e3:.1f}), {tok_s:.0f} tokens/s, "
          f"the run {run_s:.1f} s wall; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{tag}]")

    class Crash(Exception):
        pass

    real_save = manager.save

    def save_then_crash(tree, ckpt_dir, step, keep_last=3):
        real_save(tree, ckpt_dir, step, keep_last)
        raise Crash(step)

    ckdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        manager.save = save_then_crash
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            launch_train.run(argv + ["--ckpt-dir", ckdir, "--ckpt-every",
                                     str(T_CKPT)])
            check(False, "the checkpointed run did not stop at its save")
        except Crash:
            pass
        crash_s = time.perf_counter() - t0
        manager.save = real_save
        counted(full.n_layers, T_CKPT, "the checkpointed run", full.remat)
        check(manager.latest_step(ckdir) == T_CKPT,
              f"no checkpoint at step {T_CKPT}: {manager.all_steps(ckdir)}")
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res_c, st_c, hist_c = launch_train.run(argv + ["--ckpt-dir", ckdir])
        resume_s = time.perf_counter() - t0
        counted(full.n_layers, T_STEPS - T_CKPT, "the resumed run",
                full.remat)
    finally:
        manager.save = real_save
        shutil.rmtree(ckdir, ignore_errors=True)
    same = all(bit_equal(a, b) for a, b in zip(tree_leaves(params_a),
                                               tree_leaves(st_c.params)))
    check(same and res_c["last_loss"] == res_a["last_loss"]
          and hist_c["losses"] == hist_a["losses"][T_CKPT:],
          f"the resumed run differs from the uninterrupted one: params "
          f"bit-equal {same}, losses {hist_c['losses']} against "
          f"{hist_a['losses'][T_CKPT:]}")
    print(f"train (b) resume: a run checkpointed at step {T_CKPT} (saved, "
          f"then stopped: {crash_s:.1f} s wall) and resumed ({resume_s:.1f} "
          f"s wall, the restore included) ends with params bit-equal to the "
          f"uninterrupted run's and last_loss {res_c['last_loss']!r}; K3 "
          f"prefill {full.n_layers} x {T_STEPS} launches uninterrupted"
          f"{', twice under remat (the recompute)' if full.remat else ''}"
          f", its backward kernel {full.n_layers} x {T_STEPS} calls [{tag}]")
    del params_a, st_c
    torch.cuda.empty_cache()
    return total, hist_a


def kernel_name(mangled: str) -> str:
    """The kernel part of a mangled entry name, its namespaces dropped:
    ``prefill_kernelIfLi128E`` is ``pf::prefill_kernel<float, 128>``,
    ``decode_split_kernelI13__nv_bfloat16Li64ELi4E`` the bf16 decode
    kernel at head_dim 64, head group 4."""
    s = mangled[3:] if mangled.startswith("_ZN") else mangled
    name = ""
    while (m := re.match(r"\d+", s)):
        n = int(m.group(0))
        name, s = s[m.end():m.end() + n], s[m.end() + n:]
    return re.sub(r"E(Ev|v|P).*$", "", name + s)


def bit_equal(a, b) -> bool:
    """Same shape and the same bytes (NaNs and signed zeros included)."""
    import torch
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8)))


def fleet_phase(tag) -> dict:
    """Phase 17: tinyllama-1.1b at full width as a fleet of F_REPLICAS
    replicas on one card (``repro_torch.serve.cluster.Cluster``).

    (a) migration: prompts F_PROMPTS, two a replica, decode F_FIRST steps,
        suspend all, migrate the wave F_MOVES (then back to the sources and
        out again, each wave timed), resume every session on its replica
        and decode to F_MAX_NEW: tokens must equal an uninterrupted
        fleet's, each moved row and checksum row must be bit-equal to the
        source row captured before the move (the source row unchanged),
        and every replica must hold replica 0's parameter tensors;
    (b) launches over (a): K1 and K2 each what the fleet's serving stats
        call for plus one a route wave (``migration_waves`` +
        ``migration_retries`` + ``fork_materializations``), K3 what the
        stats call for, K4 none;
    (c) the launcher with F_CLUSTER_ARGV and again with ``--no-migrate``:
        every job completes, sessions migrate in the first run and not in
        the second, the launches add up as in (b);
    (d) chaos: the launcher with F_CHAOS_ARGV twice and once with
        ``--no-recovery``: every job completes, the ledger's identities
        hold, the two runs' ledgers are equal, the audit arm neither
        recovers nor retries; then one session migrated F_BOUNCES times
        between two replicas at a movement-fault rate of 0.6, faults
        landing between K2 and K1: every clean wave's row bit-equal to its
        source, no source row written, one K2 and one K1 a wave and retry;
    (e) recovery: a session snapshotted, its replica failed, restored on
        the other and decoded on must give the uninterrupted run's tokens
        with its restored row and checksums bit-equal to the snapshot's
        and verifying at resume; and a ClusterScheduler run with a replica
        failure at tick 25 and snapshots every 8 ticks completes every job,
        recovers sessions, and no resume or scrub fails its checksums.

    Returns the launch counts of (a), (c) and (d)'s route-fault waves,
    summed."""
    import numpy as np
    import torch
    from repro_torch import sched
    from repro_torch.configs import get_config
    from repro_torch.faults import (FaultInjector, FaultSpec,
                                    restore_session, snapshot_sessions)
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serve.cluster import Cluster
    from repro_torch.serve.engine import Request

    dev = torch.device("cuda")
    cfg = get_config("tinyllama-1.1b")
    params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    prompts = _prompts(cfg, F_PROMPTS, SEED + 17)
    kw = dict(n_replicas=F_REPLICAS, slots=F_SLOTS, max_len=SERVE_LEN,
              n_sessions=F_SESSIONS, device=dev)

    def admit(cl, max_new):
        reqs = [Request(uid, p, max_new) for uid, p in enumerate(prompts)]
        for r in reqs:
            cl.submit(r, replica=r.uid // F_SLOTS)
        return reqs

    # the uninterrupted fleet, at the same geometry (the same batch shapes)
    solo = Cluster(cfg, params, **kw)
    solo_reqs = admit(solo, F_MAX_NEW)
    while solo.active:
        solo.step()
    del solo

    # ---- (a) migration, (b) its launches --------------------------------
    ops.reset_launch_counts()
    cl = Cluster(cfg, params, **kw)
    want_ptrs = [t.data_ptr() for t in _leaves(params)]
    for eng in cl.replicas:
        check([t.data_ptr() for t in _leaves(eng.params)] == want_ptrs,
              f"fleet: replica {eng.replica_id} holds its own weights")
    reqs = admit(cl, F_MAX_NEW)
    for _ in range(F_FIRST):
        cl.step()
    cl.suspend_many(sorted(cl.active))
    rows = {}
    for uid, _ in F_MOVES:
        eng = cl.replicas[cl.residence[uid]]
        r = eng.forks.resolve(uid)
        rows[uid] = (eng, r, eng.sessions.slow[r].clone(),
                     eng.session_sums[r].clone())

    def wave(moves):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cl.migrate_many(list(moves))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # the wave, then back to the sources and out again: the first wave
    # is a process's first migration (its buffers' first allocations),
    # the third one a warm one; every row is checked after the first
    mig_s = [wave(F_MOVES)]
    for uid, dst in F_MOVES:
        s_eng, s_row, pages, sums = rows[uid]
        d_eng = cl.replicas[dst]
        d_row = d_eng.forks.resolve(uid)
        check(cl.residence[uid] == dst and uid not in s_eng.session_pos,
              f"fleet: uid {uid} did not move to replica {dst}")
        check(torch.equal(d_eng.sessions.slow[d_row], pages)
              and torch.equal(d_eng.session_sums[d_row], sums),
              f"fleet: uid {uid}'s row or checksums differ from the "
              f"source's after the move")
        check(torch.equal(s_eng.sessions.slow[s_row], pages),
              f"fleet: the move changed uid {uid}'s source row")
    mig_s.append(wave([(uid, uid // F_SLOTS) for uid, _ in F_MOVES]))
    mig_s.append(wave(F_MOVES))
    extra = {uid: F_MAX_NEW - len(r.generated) + 1
             for uid, r in enumerate(reqs)}
    resumed, pending = {}, sorted(extra)
    while pending:
        free, batch = cl.free_by_replica(), []
        for uid in pending:
            if free[cl.residence[uid]]:
                free[cl.residence[uid]] -= 1
                batch.append(uid)
        for uid, g in zip(batch, cl.resume_many(batch,
                                                [extra[u] for u in batch])):
            resumed[uid] = cl.active[g]
        pending = [u for u in pending if u not in batch]
        while cl.active:
            cl.step()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for r, s in zip(reqs, solo_reqs):
        check(r.generated + resumed[r.uid].generated[1:] == s.generated,
              f"fleet: uid {r.uid}'s tokens differ from the uninterrupted "
              f"fleet's")
    check(cl.verify_failure_count() == 0 and cl.scrub() == 0,
          "fleet: a resume or the scrub failed its checksums")
    cs, st = cl.cluster_stats, cl.stats
    n_routes = len({(u // F_SLOTS, d) for u, d in F_MOVES})
    check(cs["migrations"] == 3 * len(F_MOVES)
          and cs["migration_waves"] == 3 * n_routes
          and cs["migrated_bytes"] == 3 * len(F_MOVES) * cl.snapshot_bytes,
          f"fleet: migration stats {cs}")
    check_counts(counts, fleet_launches(cfg, cl), "the fleet's migration")
    hops = [cl.topo.hops(u // F_SLOTS, d) for u, d in F_MOVES]
    nbytes = len(F_MOVES) * cl.snapshot_bytes
    print(f"fleet: {F_REPLICAS} replicas x {F_SLOTS} slots, one copy of "
          f"the weights; a wave of {len(F_MOVES)} sessions over {n_routes} "
          f"routes (hops {hops}), {nbytes / 1e6:.1f} MB, there, back and "
          f"there again in "
          f"{', '.join(f'{t * 1e3:.3f}' for t in mig_s)} ms "
          f"({nbytes / mig_s[-1] / 1e9:.2f} GB/s warm, host clock); tokens "
          f"equal the uninterrupted fleet's; rows and checksums bit-equal "
          f"to the sources; launches {json.dumps(counts)} [{tag}]")
    del cl
    total = dict(counts)

    # ---- (c) the launcher, migration on and off -------------------------
    runs = {}
    for arm, extra_argv in (("migrate", []), ("no-migrate",
                                              ["--no-migrate"])):
        ops.reset_launch_counts()
        out, s = serve.run(list(F_CLUSTER_ARGV) + extra_argv)
        torch.cuda.synchronize()
        got = ops.launch_counts()
        check(out["jobs_completed"] == 24
              and all(j.state == "done" for j in s.jobs()),
              f"fleet launcher ({arm}): not every job completed")
        check(s.eng.verify_failure_count() == 0,
              f"fleet launcher ({arm}): a resume failed its checksums")
        check_counts(got, fleet_launches(cfg, s.eng),
                     f"the fleet launcher ({arm})")
        for name, n in got.items():
            total[name] += n
        runs[arm] = out
        mig = out["migration"]
        print(f"fleet launcher ({arm}): {out['jobs_completed']} jobs, "
              f"{out['seconds']} s, {out['tokens_per_s']} tok/s, "
              f"{mig['sessions_migrated']} sessions migrated, "
              f"{out['migrated_bytes'] / 1e9:.3f} GB in "
              f"{s.eng.cluster_stats['migration_waves']} waves, p99 "
              f"{out['p99_latency_ns']} ns (virtual clock) [{tag}]")
    check(runs["migrate"]["migration"]["sessions_migrated"] > 0,
          "fleet launcher: no session migrated")
    check(runs["no-migrate"]["migration"]["sessions_migrated"] == 0
          and runs["no-migrate"]["migrations"] == 0,
          "fleet launcher: --no-migrate migrated")

    # ---- (d) chaos -------------------------------------------------------
    ledgers = []
    for arm, extra_argv in (("chaos", []), ("chaos replay", []),
                            ("no-recovery", ["--no-recovery"])):
        out, s = serve.run(list(F_CHAOS_ARGV) + extra_argv)
        led = out["fault_ledger"]
        check(out["jobs_completed"] == 10
              and all(j.state == "done" for j in s.jobs()),
              f"{arm}: not every job completed")
        check(led["new_corrupt"] == led["detected"] + led["recovered"]
              + led["destroyed"] + led["at_rest_corrupt"]
              and out["verify_failed"] == led["detected"]
              and out["at_rest_corrupt"] == led["at_rest_corrupt"],
              f"{arm}: the ledger's identities fail: {out}")
        if arm == "no-recovery":
            check(led["recovered"] == led["retries"] == 0,
                  f"{arm}: recovered or retried: {led}")
        else:
            ledgers.append(led)
        print(f"{arm}: {out['jobs_completed']} jobs, ledger "
              f"{json.dumps(led)}, verify_failed {out['verify_failed']}, "
              f"retries {s.eng.cluster_stats['migration_retries']}, "
              f"{out['seconds']} s [{tag}]")
    check(ledgers[0] == ledgers[1], "chaos: the replay's ledger differs")
    # the launcher's chaos draws hit stored sessions; this corrupts the
    # route itself, between K2 and K1: a session bounced between two
    # replicas under a heavy movement-fault rate, each clean wave's row
    # bit-equal to the source row and the source row never written
    inj = FaultInjector(FaultSpec(rate=0.6, seed=3, max_retries=8))
    cl = Cluster(cfg, params, n_replicas=2, slots=2, max_len=SERVE_LEN,
                 n_sessions=8, faults=inj, device=dev)
    cl.submit(Request(3, prompts[7], 4), replica=0)
    while cl.active:
        cl.step()
    ops.reset_launch_counts()
    src, n_events = 0, 0
    for _ in range(F_BOUNCES):
        s_eng, d_eng = cl.replicas[src], cl.replicas[1 - src]
        s_row = s_eng.forks.resolve(3)
        pages = s_eng.sessions.slow[s_row].clone()
        cl.migrate(3, 1 - src)
        check(torch.equal(s_eng.sessions.slow[s_row], pages),
              "route faults: a corrupted wave wrote its source row")
        for ev in cl.drain_fault_events():
            n_events += 1
            if ev["corrupt_uid"] is None:
                check(torch.equal(d_eng.sessions.slow[
                    d_eng.forks.resolve(3)], pages),
                      "route faults: a clean wave's row differs from its "
                      "source")
            else:
                inj.consume_corrupt(3, "detected")
        src = 1 - src
    torch.cuda.synchronize()
    got = ops.launch_counts()
    waves = (cl.cluster_stats["migration_waves"]
             + cl.cluster_stats["migration_retries"])
    check_counts(got, {"villa_gather": waves, "villa_scatter": waves},
                 "the faulted routes")
    led = inj.summary()
    check(led["movement_fired"] >= 1 and led["retries"] >= 1
          and n_events == led["retry_fixed"] + led["new_corrupt"]
          + led["merged"],
          f"route faults: the ledger {led} over {n_events} events")
    for name, n in got.items():
        total[name] += n
    print(f"route faults: {F_BOUNCES} waves of one session, "
          f"{led['retries']} retries, ledger {json.dumps(led)}; launches "
          f"{json.dumps(got)} [{tag}]")
    del cl

    # ---- (e) recovery ----------------------------------------------------
    rkw = dict(n_replicas=2, slots=2, max_len=SERVE_LEN, n_sessions=8,
               device=dev)
    prompt = prompts[5]
    straight = Request(7, prompt, 32)
    clean = Cluster(cfg, params, **rkw)
    clean.submit(straight, replica=1)
    while clean.active:
        clean.step()
    del clean
    cl = Cluster(cfg, params, faults=FaultInjector(FaultSpec(seed=1)), **rkw)
    req = Request(7, prompt, 4)
    cl.submit(req, replica=0)
    while cl.active:
        cl.step()
    snaps, snap_cost = snapshot_sessions(cl)
    cl.fail_replica(0)
    check(7 not in cl.session_pos, "recovery: the session outlived its "
                                   "replica")
    rec_cost = restore_session(cl, snaps[7], 1)
    eng = cl.replicas[1]
    row = eng.forks.resolve(7)
    check(torch.equal(eng.sessions.slow[row].cpu(),
                      torch.from_numpy(snaps[7].pages))
          and np.array_equal(eng.session_sums[row].cpu().numpy(),
                             snaps[7].sums.astype(np.int64)),
          "recovery: the restored row differs from the snapshot")
    g = cl.resume(7, extra_new=32 - len(req.generated) + 1)
    r2 = cl.active[g]
    while cl.active:
        cl.step()
    check(req.generated + r2.generated[1:] == straight.generated,
          "recovery: the restored session's tokens differ from the "
          "uninterrupted run's")
    check(cl.verify_failure_count() == 0,
          "recovery: the restored session failed its checksums")
    del cl
    wl = sched.WorkloadConfig(n_fresh=4, n_followups=6)
    arrivals = sched.generate_workload(wl, seed=5, vocab_size=cfg.vocab_size)
    inj = FaultInjector(FaultSpec(replica_failures=((25, 1),)))
    cl = Cluster(cfg, params, n_replicas=2, slots=2, max_len=48,
                 n_sessions=sched.n_sessions_for(wl), faults=inj,
                 device=dev)
    s = sched.ClusterScheduler(cl, arrivals=arrivals, snapshot_every=8)
    summary = s.run()
    f = summary["faults"]["counters"]
    check(summary["jobs_completed"] == len(arrivals)
          and f["replica_failures"] == 1 and f.get("recovered", 0) >= 1,
          f"recovery: the scheduler run {summary['faults']}")
    check(cl.verify_failure_count() == 0 and cl.scrub() == 0,
          "recovery: a resume or the scrub failed its checksums")
    print(f"recovery: restored session's tokens equal the uninterrupted "
          f"run's ({len(straight.generated)}), snapshot "
          f"{snap_cost.bytes / 1e6:.1f} MB, restore priced "
          f"{rec_cost.ns_lisa:.1f} ns (lisa); the scheduler run with a "
          f"replica failure at tick 25: {summary['jobs_completed']} jobs, "
          f"faults {json.dumps(f)} [{tag}]")
    del cl, params
    torch.cuda.empty_cache()
    return total


def fleet_launches(cfg, cl) -> dict:
    """The launches a fleet's run calls for: the serving launches of
    its replicas' engines (``serving_launches`` of the cluster), and one
    K2 and one K1 a route wave — a migration wave, each of its retries,
    each cross-replica fork materialization."""
    st = cl.stats
    due = serving_launches(cfg, cl)
    waves = (st["migration_waves"] + st["migration_retries"]
             + st["fork_materializations"])
    for name in ("villa_gather", "villa_scatter"):
        due[name] = due.get(name, 0) + waves
    return {name: n for name, n in due.items() if n}


def serving_launches(cfg, eng) -> dict:
    """The launches a serving run of ``eng`` (an Engine or a Cluster) calls
    for, from its stats and its movement dispatches.  K3 runs once an
    attention layer per prefill (its prefill kernel: every prompt is longer
    than one token) and, in a GQA layer, per decode dispatch (its decode
    kernel; an MLA layer decodes through its absorbed einsums, without K3;
    a mamba or rwkv layer runs no K3; an Engine of bf16 weights prefills
    on the wgmma route where ``wgmma_prefill`` says so); a suspend
    dispatch (one session or
    a wave) writes the slow rows and their fast copies (two K1), a resume
    dispatch reads the slow rows and the fast slots (two K2) and inserts
    into the fast tier (one K1), a demotion clones a row (one K2, one K1);
    K4 is not on the serving path.  Kernels due no launch are left out
    (``check_counts`` holds them to 0)."""
    st, moves = eng.stats, eng.move_dispatches
    kinds = cfg.layer_kinds()
    n_pre = sum(kind in ("attn_full", "attn_local", "mla") for kind in kinds)
    n_dec = sum(kind in ("attn_full", "attn_local") for kind in kinds)
    prefill = n_pre * st["prefills"]
    decode = n_dec * st["decode_dispatches"]
    params = getattr(eng, "params", None)
    wgmma = params is not None and wgmma_prefill(cfg, params["embed"].dtype)
    due = {"flash_attention": prefill + decode,
           "flash_attention_prefill": prefill,
           "flash_attention_prefill_wgmma": prefill if wgmma else 0,
           "flash_attention_decode": decode,
           "villa_scatter": 2 * moves["suspend"] + moves["resume"]
           + st["demotions"],
           "villa_gather": 2 * moves["resume"] + st["demotions"]}
    return {name: n for name, n in due.items() if n}


def mesh_phase(tag) -> dict:
    """Phase 20: LISA's hop chains on the card over a ``StackedAxis``,
    each hop one K2 launch over the stack viewed as 1 KiB rows.

    (a) hops at M_HOP_N: rbm_hop both ways, lisa_copy both ways round
        the ring and along a linear chain, lisa_broadcast to a subset and
        to all, each bit-equal to its oracle (clone, then index), and the
        shift bit-equal to the plain gather of its own table;
    (b) ring collectives at M_RING_N over 1 GiB a device from numpy:
        ring_reduce_scatter and ring_allreduce bit-equal to the CPU's
        StackedAxis run of the same inputs, ring_allgather (on the card
        and on the CPU) bit-equal to the concatenation; the peak memory;
    (c) ring_allgather_matmul within M_MM_BAR of x @ w_full;
    (d) allreduce_mean_compressed within M_GRAD_BAR of the exact mean and
        within half its shared scale;
    (e) ring attention, causal and not, within M_RING_BAR of K3's prefill
        over the whole sequence (run after the counted window);
    (f) GPipe within M_PIPE_BAR of the sequential run, on every stage;
    (g) the migration and fork plans (page_gather -> hop_chain ->
        page_scatter over ``axes``) landing bit-exactly as the oracle,
        every other byte of the pools unchanged;
    (h) launches over (a)-(g): K2 one a hop (the axes' hop counters) plus
        one a plan's gather leg, K1 one a plan's scatter leg, no K3 or K4;
    (i) times: the shift hop and a single-pair hop (ms, device ms, the
        byte bound, the plain gather, index_select), the collectives, ring
        attention beside K3, GPipe and the plans;
    (j) the NCCL route (``nccl_route``).
    Returns the launch counts of (h), the K2 launches of the hops among
    them, and the K2 hop row."""
    import numpy as np
    import torch
    from repro_torch import movement as MV
    from repro_torch.configs import get_config, param_count
    from repro_torch.core.lisa import compression as C
    from repro_torch.core.lisa import rbm
    from repro_torch.core.lisa.ring_attention import ring_attention
    from repro_torch.core.lisa.topology import MeshTopology
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import StackedAxis, hop_rows, hop_table
    from repro_torch.models import lm
    from repro_torch.movement import paging
    from repro_torch.train.pipeline import pipeline_transformer

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    cfg = get_config("tinyllama-1.1b")
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    rng = np.random.default_rng(SEED + 20)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush = lambda: scratch.fill_(1)         # noqa: E731  (evict L2)
    axes = []

    def axis(n, name="x"):
        a = StackedAxis(n, device=dev, name=name)
        axes.append(a)
        return a

    def sync_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()

    # ---- (a) hops at M_HOP_N over FSDP shards of tinyllama's weights ----
    n = M_HOP_N
    nbytes = param_count(cfg) * 4
    x = torch.randn((n, nbytes // 4 // n), device=dev, generator=gen)
    ax = axis(n)

    def moved(src, dsts):
        want = x.clone()
        want[list(dsts)] = x[src]
        return want

    hops = (("rbm_hop +1", lambda: rbm.rbm_hop(x, ax, 1),
             lambda: torch.roll(x, 1, 0)),
            ("rbm_hop -1", lambda: rbm.rbm_hop(x, ax, -1),
             lambda: torch.roll(x, -1, 0)),
            ("lisa_copy 1->6 (3 hops back)",
             lambda: rbm.lisa_copy(x, 1, 6, ax), lambda: moved(1, [6])),
            ("lisa_copy 6->1 (3 hops on)",
             lambda: rbm.lisa_copy(x, 6, 1, ax), lambda: moved(6, [1])),
            ("lisa_copy 2->6 (4 hops)",
             lambda: rbm.lisa_copy(x, 2, 6, ax), lambda: moved(2, [6])),
            ("chain 6->1 (5 hops, no wrap)",
             lambda: rbm.lisa_copy(x, 6, 1, ax, wraparound=False),
             lambda: moved(6, [1])),
            ("lisa_broadcast 3->[0,5,7]",
             lambda: rbm.lisa_broadcast(x, 3, ax, dsts=[0, 5, 7]),
             lambda: moved(3, [0, 5, 7])),
            ("lisa_broadcast 3->all", lambda: rbm.lisa_broadcast(x, 3, ax),
             lambda: moved(3, range(n))))
    hop_s = {}
    for label, fn, oracle in hops:
        before = ax.hops
        got, hop_s[label] = sync_s(fn)
        check(torch.equal(got, oracle()),
              f"mesh: {label} differs from its oracle")
        hop_s[label] = (hop_s[label], ax.hops - before)
        del got
    shift = [(i, (i + 1) % n) for i in range(n)]
    row_bytes = hop_rows(nbytes // n)
    rows = x.view(torch.uint8).view(-1, row_bytes)
    per = rows.shape[0] // n
    table = hop_table([(d - 1) % n for d in range(n)], per, dev)
    check(torch.equal(ax.ppermute(x, shift).view(torch.uint8)
                      .view(-1, row_bytes), ref.villa_gather_ref(rows, table)),
          "mesh: the shift hop differs from the plain gather of its table")
    print(f"mesh hops: {n} shards of {nbytes // n:,} B ({nbytes:,} B of "
          f"tinyllama's f32 weights), as {per:,} rows of {row_bytes:,} B a "
          f"shard, "
          f"bit-equal to their oracles: " + "; ".join(
              f"{k} {h} hops {t * 1e3:.3f} ms" for k, (t, h)
              in hop_s.items()) + f" (host clock) [{tag}]")

    # ---- (b) ring collectives at M_RING_N, 1 GiB a device -------------
    m = M_RING_N
    host = rng.random((m, M_RING_VALUES), dtype=np.float32)
    ax4 = axis(m)
    cpu = StackedAxis(m, device="cpu")
    xc = torch.from_numpy(host)
    xg = xc.to(dev)
    mem0 = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    coll_s = {}
    got, coll_s["ring_allgather"] = sync_s(lambda: rbm.ring_allgather(xg,
                                                                     ax4))
    check(torch.equal(got, xg.reshape(1, -1).expand(m, -1)),
          "mesh: ring_allgather differs from the concatenation")
    del got
    check(torch.equal(rbm.ring_allgather(xc, cpu),
                      xc.reshape(1, -1).expand(m, -1)),
          "mesh: the CPU's ring_allgather differs from the concatenation")
    chunks = (xg.view(m, m, -1), xc.view(m, m, -1))
    got, coll_s["ring_reduce_scatter"] = sync_s(
        lambda: rbm.ring_reduce_scatter(chunks[0], ax4))
    check(torch.equal(got.cpu(), rbm.ring_reduce_scatter(chunks[1], cpu)),
          "mesh: ring_reduce_scatter is not bit-equal to the CPU's run")
    check(torch.allclose(got, chunks[0].sum(0), atol=1e-5),
          "mesh: ring_reduce_scatter is not the sum")
    del got
    got, coll_s["ring_allreduce"] = sync_s(lambda: rbm.ring_allreduce(xg,
                                                                     ax4))
    check(torch.equal(got.cpu(), rbm.ring_allreduce(xc, cpu)),
          "mesh: ring_allreduce is not bit-equal to the CPU's run")
    del got, chunks, xc, xg, host
    peak_coll = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.empty_cache()
    print(f"mesh collectives at {m} devices x {M_RING_VALUES:,} f32 (1 GiB "
          f"each): " + ", ".join(f"{k} {t * 1e3:.3f} ms" for k, t
                                 in coll_s.items())
          + f" (host clock, first call); reduce-scatter and all-reduce "
          f"bit-equal to the CPU's StackedAxis run, all-gather to the "
          f"concatenation; peak memory {peak_coll / 2**30:.2f} GiB "
          f"(before them {mem0 / 2**30:.2f}) [{tag}]")

    # ---- (c) the all-gather matmul at tinyllama's MLP width -----------
    d, f = cfg.d_model, cfg.d_ff
    xm = torch.randn((m, M_MM_ROWS, d), device=dev, generator=gen)
    w_full = torch.randn((d, f), device=dev, generator=gen) / math.sqrt(d)
    mm, mm_s = sync_s(lambda: rbm.ring_allgather_matmul(
        xm, w_full.view(m, d // m, f), ax4))
    mm_err = float((mm - xm @ w_full).abs().max())
    check(mm_err <= M_MM_BAR, f"mesh: ring_allgather_matmul is {mm_err:.3g} "
          f"from x @ w_full (bar {M_MM_BAR})")
    del mm

    # ---- (d) the compressed all-reduce of the embedding gradient ------
    g = torch.randn((m, cfg.vocab_size, d), device=dev,
                    generator=gen) * M_GRAD_STD
    (mean, err), c_s = sync_s(lambda: C.allreduce_mean_compressed(
        g, torch.zeros_like(g), ax4))
    scale = float(g.abs().max()) / 127.0
    c_err = float((mean - g.mean(0)).abs().max())
    check(c_err <= M_GRAD_BAR and c_err <= scale / 2 * (1 + 1e-5)
          and float(err.abs().max()) <= scale / 2 * (1 + 1e-5),
          f"mesh: the compressed mean is {c_err:.3g} from the exact one "
          f"(bar {M_GRAD_BAR}, half its scale {scale / 2:.3g})")
    del g, mean, err
    print(f"mesh: ring_allgather_matmul ({m} x {M_MM_ROWS} x {d} @ {d} x "
          f"{f}, w sharded on its input dim) {mm_err:.3g} from x @ w_full, "
          f"{mm_s * 1e3:.3f} ms; allreduce_mean_compressed of {m} x "
          f"{cfg.vocab_size} x {d} gradients (std {M_GRAD_STD}) "
          f"{c_err:.3g} from the exact mean (scale {scale:.3g}), "
          f"{c_s * 1e3:.3f} ms (host clock) [{tag}]")

    # ---- (e) ring attention at tinyllama's heads ----------------------
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    S = n * M_SEQ_SHARD
    qkv = [torch.randn((1, S, h, D), device=dev, generator=gen)
           for h in (H, K, K)]
    shards = [t.view(1, n, M_SEQ_SHARD, t.shape[2], D).transpose(0, 1)
              .contiguous() for t in qkv]
    ring = {}
    for causal in (True, False):
        before = ax.hops
        out, ring_s = sync_s(lambda: ring_attention(*shards, ax,
                                                    causal=causal))
        check(ax.hops - before == n,
              f"mesh: ring attention made {ax.hops - before} hops")
        ring[causal] = (out.transpose(0, 1).reshape(1, S, H, D), ring_s)

    # ---- (f) GPipe ------------------------------------------------------
    ps, pl = M_PIPE_STAGES, M_PIPE_LAYERS
    params = {"w": torch.randn((ps, pl, d, d), device=dev,
                               generator=gen) / math.sqrt(d),
              "b": torch.randn((ps, pl, d), device=dev, generator=gen) * 0.1}
    micro = torch.randn((M_PIPE_MICRO, M_PIPE_ROWS, d), device=dev,
                        generator=gen)

    def layer_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"].unsqueeze(-2))

    axp = axis(ps, "pp")
    pipe, pipe_s = sync_s(lambda: pipeline_transformer(axp, layer_fn, pl)(
        params, micro.expand((ps,) + micro.shape)))
    seq = micro
    for st in range(ps):
        for i in range(pl):
            seq = torch.tanh(seq @ params["w"][st, i] + params["b"][st, i])
    pipe_err = float((pipe - seq).abs().max())
    check(pipe_err <= M_PIPE_BAR and axp.hops == ps + M_PIPE_MICRO - 1,
          f"mesh: GPipe is {pipe_err:.3g} from the sequential run (bar "
          f"{M_PIPE_BAR}) over {axp.hops} hops")
    del pipe, seq, params, micro

    # ---- (g) the migration and fork plans over replica pools -----------
    spec = paging.PageSpec.for_cache(lm.init_cache(cfg, 1, SERVE_LEN,
                                                   device=dev))
    pools = torch.randint(0, 256, (F_REPLICAS, F_SESSIONS * spec.n_pages,
                                   spec.page_rows, spec.page_lanes),
                          dtype=torch.uint8, device=dev, generator=gen)
    want = pools.clone()
    axr = axis(F_REPLICAS, "replica")
    plan_s, legs = {}, {"page_gather": 0, "page_scatter": 0}
    for name, kind, src, dst, src_rows, dst_rows in M_PLANS:
        st = torch.cat([paging.row_page_table(spec, r) for r in src_rows])
        dt = torch.cat([paging.row_page_table(spec, r) for r in dst_rows])
        plan = MV.plan(MV.Transfer(
            MV.Tier("slow", index=src, axis="replica"),
            MV.Tier("slow", index=dst, axis="replica"),
            MV.Layout.raw_pages(len(st), spec.page_rows, spec.page_lanes,
                                np.uint8), kind=kind),
            topo=MeshTopology(F_REPLICAS))
        check([l.kind for l in plan.legs] == ["page_gather", "hop_chain",
                                              "page_scatter"],
              f"mesh: the {name} plan's legs {plan.describe()}")
        before = axr.hops
        _, plan_s[name] = sync_s(lambda: MV.execute(
            plan, src_pool=pools, src_table=st, dst_pool=pools,
            dst_table=dt, axes={"replica": axr}))
        check(axr.hops - before == plan.legs[1].hops,
              f"mesh: the {name} plan's chain is not its priced route")
        for leg in plan.legs:
            legs[leg.kind] = legs.get(leg.kind, 0) + 1
        want[dst, dt.long()] = want[src, st.long()]
        check(torch.equal(pools, want), f"mesh: the {name} plan did not "
              f"land bit-exactly, or wrote another pool")
    moved_mb = {name: len(sr) * spec.total_bytes / 1e6
                for name, _, _, _, sr, _ in M_PLANS}
    del want

    # ---- (h) launches over (a)-(g) --------------------------------------
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    hop_launches = sum(a.hops for a in axes)
    check_counts(counts, {"villa_gather": hop_launches + legs["page_gather"],
                          "villa_scatter": legs["page_scatter"]},
                 "the mesh phase")
    peak = torch.cuda.max_memory_allocated()
    print(f"mesh: GPipe {ps} stages x {pl} layers at D {d}, "
          f"{M_PIPE_MICRO} x {M_PIPE_ROWS} rows, {pipe_err:.3g} from the "
          f"sequential run, {pipe_s * 1e3:.3f} ms; plans over {F_REPLICAS} "
          f"pools of {F_SESSIONS} x {spec.n_pages} pages: " + ", ".join(
              f"{k} {moved_mb[k]:.1f} MB in {t * 1e3:.3f} ms"
              for k, t in plan_s.items()) + f" (host clock), bit-exact; "
          f"launches {json.dumps(counts)} ({hop_launches} K2 hops); peak "
          f"memory since (c) {peak / 2**30:.2f} GiB [{tag}]")
    del pools

    # ---- (e) against K3, after the counted window -----------------------
    pos = torch.arange(S, dtype=torch.int32, device=dev).view(1, S)
    for causal, (out, ring_s) in ring.items():
        k3 = ops.chunked_attention(*qkv, pos, pos, causal=causal)
        r_err = float((out - k3).abs().max())
        check(r_err <= M_RING_BAR, f"mesh: ring attention (causal "
              f"{causal}) is {r_err:.3g} from K3 (bar {M_RING_BAR})")
        ring_dev = timed(lambda: ring_attention(*shards, ax, causal=causal),
                         reps=3, device=True)
        k3_dev = timed(lambda: ops.chunked_attention(*qkv, pos, pos,
                                                     causal=causal),
                       reps=5, device=True)
        print(f"mesh: ring attention over {n} x {M_SEQ_SHARD} tokens "
              f"({H}/{K} heads, D {D}, f32, causal {causal}) {r_err:.3g} "
              f"from K3 over the whole sequence; {ring_s * 1e3:.3f} ms "
              f"first call (host clock), device {ring_dev:.4f} ms against "
              f"K3's {k3_dev:.4f} ms [{tag}]")
    del ring, qkv, shards

    # ---- (i) the K2 hop rows --------------------------------------------
    idx = table.long()
    row = dict(**kernel_times(lambda: ax.ppermute(x, shift),
                              lambda: ref.villa_gather_ref(rows, table),
                              lambda: rows.index_select(0, idx), flush),
               bound_ms=2 * nbytes / HBM_BYTES_PER_S * 1e3,
               bound_by="bytes", max_abs_err=0.0)
    pair = hop_table([-1, -1, -1, 2] + [-1] * (n - 4), per, dev)
    sel = torch.arange(2 * per, 3 * per, device=dev)
    out = torch.zeros_like(rows)
    p_row = dict(**kernel_times(lambda: ops.villa_gather(rows, pair, out),
                                lambda: ref.villa_gather_ref(rows, pair, out),
                                lambda: rows.index_select(0, sel), flush),
                 bound_ms=2 * (nbytes // n) / HBM_BYTES_PER_S * 1e3)
    for label, r, moved in (("shift (every shard moves)", row, nbytes),
                            ("one pair (K2 alone into a zeroed stack)",
                             p_row, nbytes // n)):
        print(f"mesh K2 hop, {label}: {moved:,} B read and written, "
              f"{r['ms']:.4f} ms, device {r['device_ms']:.4f} ms, byte "
              f"bound {r['bound_ms']:.4f} ms (2 x bytes / 3.35 TB/s: on "
              f"one card a hop is an HBM copy, not a link), plain gather "
              f"{r['plain_ms']:.4f} ms, index_select {r['library_ms']:.4f} "
              f"ms (device {r['library_device_ms']:.4f}) [{tag}]")
    del x, rows, out
    torch.cuda.empty_cache()
    print(f"mesh phase: {time.perf_counter() - t_phase:.1f} s [{tag}]")
    return {"counts": counts, "hop_launches": hop_launches, "row": row}


def group_check(axis) -> None:
    """The hops, collectives and plans of phase 20 at a cut size on a
    ``GroupAxis`` rank: each rank's shard of every result equal to the
    same function's on a CPU ``StackedAxis`` over all ranks' inputs (drawn
    from one seed on every rank).  Raises on a difference."""
    import numpy as np
    import torch
    from repro_torch import movement as MV
    from repro_torch.core.lisa import rbm
    from repro_torch.core.lisa.topology import MeshTopology
    from repro_torch.launch.mesh import StackedAxis

    n, r = axis.size, axis.rank
    cpu = StackedAxis(n, device="cpu", name=axis.name)
    gen = torch.Generator().manual_seed(SEED + 20)
    x = torch.randn((n, 1 << 18), generator=gen)
    odd = torch.randint(0, 256, (n, 1001), dtype=torch.uint8, generator=gen)
    pools = torch.randint(0, 256, (n, 64, 8, 128), dtype=torch.uint8,
                          generator=gen)
    dst = min(2, n - 1)
    plan = MV.plan(MV.Transfer(MV.Tier("slow", index=0, axis=axis.name),
                               MV.Tier("slow", index=dst, axis=axis.name),
                               MV.Layout.raw_pages(3, 8, 128, np.uint8)),
                   topo=MeshTopology(n))

    def migrate(a, p):
        MV.execute(plan, src_pool=p, src_table=[1, 4, 63], dst_pool=p,
                   dst_table=[0, 2, 5], axes={axis.name: a})
        return p

    cases = {"hop +1": (lambda a, t: rbm.rbm_hop(t, a, 1), x),
             "hop -1 (1001 B shards)": (lambda a, t: rbm.rbm_hop(t, a, -1),
                                        odd),
             "lisa_copy": (lambda a, t: rbm.lisa_copy(t, 0, n - 1, a), x),
             "chain": (lambda a, t: rbm.lisa_copy(t, n - 1, 0, a,
                                                  wraparound=False), x),
             "lisa_broadcast": (lambda a, t: rbm.lisa_broadcast(t, 0, a), x),
             "ring_allgather": (lambda a, t: rbm.ring_allgather(t, a), x),
             "ring_reduce_scatter": (lambda a, t: rbm.ring_reduce_scatter(
                 t.view(t.shape[0], n, -1), a), x),
             "ring_allreduce": (lambda a, t: rbm.ring_allreduce(t, a), x),
             "migration plan": (migrate, pools)}
    for name, (fn, t) in cases.items():
        want = fn(cpu, t.clone())[r:r + 1]
        got = fn(axis, t[r:r + 1].clone().to(axis.device))
        check(torch.equal(got.cpu(), want),
              f"rank {r}: {name} differs from the StackedAxis run")


def nccl_route(tag) -> None:
    """Phase 20's NCCL route: with two or more cards, min(count, 8) ranks
    (``python chip_smoke.py --nccl-rank``, torchrun's env) each run
    ``group_check`` over NCCL; with one card, a line that says it did not
    run and why."""
    import os
    import socket
    import torch
    count = torch.cuda.device_count()
    if count < 2:
        print(f"mesh NCCL route: not run: torch.cuda.device_count() is "
              f"{count}, and NCCL takes one card a rank; phase 20's hop "
              f"chains ran over a StackedAxis on this card only, so the "
              f"NCCL route stays unverified on a card [{tag}]")
        return
    ranks = min(count, 8)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--nccl-rank"],
        env={**os.environ, "RANK": str(r),
             "WORLD_SIZE": str(ranks), "LOCAL_RANK": str(r),
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(ranks)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=M_NCCL_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"NCCL rank {r} failed:\n{logs[r][-3000:]}")
    print(f"mesh NCCL route: {ranks} ranks over NCCL, hops, collectives "
          f"and the migration plan equal to the StackedAxis run [{tag}]")


def nccl_rank_main() -> int:
    """One rank of ``nccl_route``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import GroupAxis
    axis = GroupAxis.from_env(name="x")
    try:
        group_check(axis)
    finally:
        dist.destroy_process_group()
    print(f"rank {axis.rank} ok")
    return 0


def leaf_rules(like, shardings, mesh, batch_axes, pcfg, cfg) -> list:
    """Each param leaf's rule in one mesh step (``train/step.py``):
    ``(like leaf, sharding, kept axes, sum axes, sliced, stacked, lead)``:
    the model axis is kept (not gathered) where the split compute uses the
    leaf's stored model slice (``shardings.compute_dim``, one piece); a
    leaf it splits otherwise is gathered whole and sliced (``sliced``: the
    slices' gradients are all-gathered over the model axis); the gradient
    is summed over the batch axes, and over the model axis
    (tensor_parallel) for a leaf each device of a model group uses whole;
    a ``stacked`` layer leaf is gathered a rep at a time (``step.Reps``),
    but along the axes ``lead`` that split its reps dim, gathered once."""
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.models import sharding as SHD
    from repro_torch.train import shardings as SH
    from repro_torch.train import step as TS
    tp = pcfg.tensor_parallel and mesh.shape["model"] > 1
    out = []
    with SHD.use_sharding(mesh, TS.sharding_rules(pcfg),
                          batch_axes=batch_axes):
        for (path, x), (_, sh) in zip(_flatten(like), _flatten(shardings)):
            keys = path.split("/")
            cd = SH.compute_dim(keys, x.shape, cfg)
            keep = (("model",) if cd is not None
                    and SH.compute_pieces(keys) == 1
                    and dict(sh.dims()).get(cd) == ("model",) else ())
            sums = tuple(batch_axes) + (("model",) if tp and cd is None
                                        else ())
            stacked = TS._stacked(keys)
            lead = dict(sh.dims()).get(0, ()) if stacked else ()
            out.append((x, sh, keep, sums, tp and cd is not None
                        and not keep, stacked, lead))
    return out


def split_reductions(cfg, m, sp) -> int:
    """The model axis's collectives in one train step of a dense GQA
    model's split compute, forward and backward: each partial output's
    reduction (the embedding where the vocab splits, every attention and
    MLP block where its heads or ff split), under sequence parallelism
    every block input's all-gather and the final norm's; the cross
    entropy's pmax and its two psums where the vocab splits.  Under
    ``cfg.remat`` a block's forward collectives run again in its
    recompute."""
    vs = cfg.vocab_size % m == 0
    block = ((2 if cfg.n_heads % m == 0 else 0)
             + (2 if cfg.d_ff % m == 0 else 0) + (4 if sp else 0))
    if cfg.remat:
        block += block // 2
    return ((2 if vs else 0) + cfg.n_layers * block + (2 if sp else 0)
            + (5 if vs else 0))


def mesh_step_counts(rules, sizes, batch_axes, pcfg, cfg):
    """{axis: (hops, reductions)} that one mesh step's rule calls for
    (``train/step.py``, :func:`leaf_rules`): a leaf's all-gather makes n
    hops on each axis of n devices it is split over but a kept one, its
    gradient's reduce-scatter n - 1 more on a sum axis; a leaf whole
    along a sum axis is all-reduced over it (2n - 1 hops); a stacked leaf
    does that once a rep, its gathers twice under remat (the recompute),
    but along its reps dim's axes once; the clip's norm reduces once on
    each axis a leaf is split over, grad compression's scale once more,
    the metrics once on each batch axis, and the split compute's
    collectives (:func:`split_reductions`, and a sliced leaf's gradient
    all-gather a rep) on the model axis.  On a stacked mesh each hop is
    one K2 launch."""
    hops = {a: 0 for a in sizes}
    red = {a: 0 for a in sizes}
    for x, sh, keep, sums, sliced, stacked, lead in rules:
        reps = x.shape[0] if stacked else 1
        again = 2 if stacked and cfg.remat else 1
        split = [a for a in sh.axes() if sizes[a] > 1]
        red["model"] += reps if sliced else 0
        for a in split:
            red[a] += 2 if pcfg.grad_compress else 1
            if a in keep:
                continue
            back = sizes[a] - 1 if a in sums else 0
            if a in lead:
                hops[a] += sizes[a] + back
            else:
                hops[a] += reps * (again * sizes[a] + back)
        for a in sums:
            if a not in split:
                hops[a] += reps * (2 * sizes[a] - 1)
    for a in batch_axes:
        red[a] += 1
    if pcfg.tensor_parallel and sizes["model"] > 1:
        red["model"] += split_reductions(cfg, sizes["model"],
                                         pcfg.sequence_parallel)
    return {a: (hops[a], red[a]) for a in sizes}


def hop_bytes(rules, sizes) -> tuple:
    """Bytes the hops of one mesh step move, (the all-gathers', the
    gradient reductions'), by :func:`leaf_rules`: every hop carries the
    whole stack, ``n_local`` devices' current slices; a reduce-scatter's
    hops carry one chunk a device, an all-reduce's 2n - 1 hops one padded
    chunk each."""
    import math
    gather = reduce = 0
    for x, sh, keep, sums, *_ in rules:
        n_local = sh.mesh.n_local
        split = [a for a in sh.axes() if sizes[a] > 1]
        cur = x.numel() * x.element_size() // math.prod(
            sizes[a] for a in split)
        shard = cur
        for _, names in sh.dims():          # _gather's order
            for a in reversed(names):
                if sizes[a] > 1 and a not in keep:
                    gather += sizes[a] * n_local * cur
                    cur *= sizes[a]
        for _, names in reversed(sh.dims()):    # _grad_to_shards' order
            for a in names:
                if sizes[a] > 1 and a not in keep:
                    cur //= sizes[a]
                    if a in sums:
                        reduce += (sizes[a] - 1) * n_local * cur
        for a in sums:
            if a not in split:
                chunk = -(-shard // x.element_size() // sizes[a]) \
                    * x.element_size()
                reduce += (2 * sizes[a] - 1) * n_local * chunk
    return gather, reduce


def mesh_train_phase(tag, single_hist) -> dict:
    """Phase 21: sharded training on stacked meshes of the card.

    (a) full-width tinyllama-1.1b in f32 from phase 19's seed, batch and
        OptConfig, MT_STEPS steps on each mesh of MT_MESHES (fsdp,
        tensor_parallel): step 1's loss and grad norm within MT_STEP_BAR
        (relative) of phase 19's uninterrupted run (``single_hist``), its
        params within 1e-5 of one single-device step's where the gradient
        is above 1e-6 and within lr everywhere, every loss within
        MT_LOSS_BAR of phase 19's;
    (b) the first mesh's state saved at step MT_SAVE (its full arrays,
        gathered over the rings) and restored onto the second: every
        restored slice bit-equal to the saved array's, and the restored
        run's next steps within MT_STEP_BAR of the uninterrupted run's;
    (c) ``launch.train`` on reduced tinyllama (MT_ARGV) on --data 2
        --model 2: stopped after its step-MT_LAUNCH_CKPT save and resumed
        on the same mesh (params and losses equal the uninterrupted
        run's) and onto --data 4 --model 1 (losses within MT_STEP_BAR);
        the elastic example (``repro_torch.examples.elastic_rescale``);
    (d) every step of (a) and (b): the axes' hops and reductions equal
        ``mesh_step_counts``, K2 launches equal the hops, K3's prefill
        route layers a step (K3e: one forward of the folded stack, the
        model axis splitting its heads), nothing else;
    (e) ms a step on the host clock (median of steps 2-MT_STEPS), the
        device ms of one step's all-gathers and of its gradient
        reductions beside their byte bound, the peak memory of each run,
        one step of the last mesh profiled by op, the phase's seconds;
    (f) the NCCL route (``mesh_train_nccl``).
    Returns the K2 and K3-prefill launches of (d)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.checkpoint import manager
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.examples import elastic_rescale
    from repro_torch.kernels import ops
    from repro_torch.launch import specs
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import shardings as SH
    from repro_torch.train import step as TS

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = get_config("tinyllama-1.1b")
    ocfg = OptConfig(lr=T_LR, warmup_steps=max(T_STEPS // 10, 1),
                     total_steps=T_STEPS)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=T_SEQ,
                      global_batch=T_BATCH, seed=SEED)
    pcfg = TS.ParallelConfig(fsdp=True)
    like = specs.state_specs(cfg, pcfg, torch.float32)
    batches = [batch_at(dcfg, i, device=dev) for i in range(MT_STEPS)]
    total = {"villa_gather": 0, "flash_attention_prefill": 0,
             "flash_attention_backward": 0}
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED)  # noqa: E731

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-12)

    # one single-device step: its params, and where its gradient is > 1e-6
    one = TS.ParallelConfig(fsdp=False)
    st = TS.init_train_state(cfg, gen(), one, device=dev)
    grads = TS.grads_of(cfg, one, st.params, batches[0])[2]
    big = {p: (g.abs() > 1e-6).cpu() for p, g in _flatten(grads)}
    del grads
    s1, m1 = TS.make_train_step(cfg, one, ocfg)(st, batches[0])
    single = (float(m1["loss"]), float(m1["grad_norm"]))
    check(rel(single[0], single_hist["losses"][0]) <= MT_STEP_BAR
          and rel(single[1], single_hist["grad_norms"][0]) <= MT_STEP_BAR,
          f"sharded training: the single-device step 1 {single} is not "
          f"phase 19's ({single_hist['losses'][0]}, "
          f"{single_hist['grad_norms'][0]})")
    p1 = {p: t.cpu() for p, t in _flatten(s1.params)}
    del st, s1
    torch.cuda.empty_cache()

    def same_update(label, params, sh):
        """Step 1's laid-out params against the single-device step's,
        leaf by leaf on the card (gathered outside the counted steps)."""
        moved = 0.0
        for (path, leaf), (_, s) in zip(_flatten(params), _flatten(sh)):
            diff = (SH._gather(leaf, s)[0] - p1[path].to(dev)).abs()
            mask = big[path].to(dev)
            moved = max(moved, float(diff[mask].max()) if mask.any() else 0)
            check(bool((diff[mask] <= 1e-5).all())
                  and bool((diff <= ocfg.lr).all()),
                  f"sharded training {label}: step 1's {path} is not the "
                  f"single-device step's")
        return moved

    def run(shape, first, state=None, save_to=None):
        """Steps ``first``..MT_STEPS - 1 on a stacked ``shape`` mesh from
        phase 19's initial state, or from a laid-out ``state``."""
        label = f"{shape[0]}x{shape[1]}"
        mesh = make_local_mesh(*shape, device=dev)
        _, compile_step, state_shardings = TS.make_train_step(cfg, mesh,
                                                              pcfg, ocfg)
        sh = state_shardings(like)
        step = compile_step(like, batches[0])
        if state is None:
            state = SH.shard(TS.init_train_state(cfg, gen(), pcfg,
                                                 device=dev), sh)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        batch_axes = tuple(a for a in ("data",) if mesh.shape[a] > 1)
        want = mesh_step_counts(
            leaf_rules(like.params, sh.params, mesh, batch_axes, pcfg, cfg),
            mesh.shape, batch_axes, pcfg, cfg)
        hops = sum(h for h, _ in want.values())
        layers = cfg.n_layers * (2 if cfg.remat else 1)     # K3e forwards
        out = {"loss": [], "grad_norm": [], "step_s": []}
        for i in range(first, MT_STEPS):
            ops.reset_launch_counts()
            mesh.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batches[i])
            out["loss"].append(float(m["loss"]))
            out["step_s"].append(time.perf_counter() - t0)
            out["grad_norm"].append(float(m["grad_norm"]))
            check(mesh.counts() == want,
                  f"sharded training {label} step {i + 1}: hops and "
                  f"reductions {mesh.counts()}, {want} due")
            check_counts(ops.launch_counts(),
                         {"villa_gather": hops, "flash_attention": layers,
                          "flash_attention_prefill": layers,
                          "flash_attention_backward": cfg.n_layers},
                         f"sharded training {label} step {i + 1}")
            total["villa_gather"] += hops
            total["flash_attention_prefill"] += layers
            total["flash_attention_backward"] += cfg.n_layers
            if i == 0:
                out["moved"] = same_update(label, state.params, sh.params)
            if save_to is not None and i + 1 == MT_SAVE:
                t0 = time.perf_counter()
                manager.save(state, save_to, MT_SAVE, shardings=sh)
                out["save_s"] = time.perf_counter() - t0
        out["peak"] = torch.cuda.max_memory_allocated()
        out["want"], out["n_local"] = want, mesh.n_local
        if first == 0 and shape == MT_MESHES[-1]:
            # one step's device time by op (the first mesh's split is the
            # same with twice the rows: profiled once, to keep the phase
            # short)
            profile_step(lambda: step(state, batches[0]), label, tag)
        del state
        torch.cuda.empty_cache()
        return out

    # (a) each mesh from step 0, the first saved at MT_SAVE
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_mesh_train_")
    try:
        runs = {}
        for k, shape in enumerate(MT_MESHES):
            label = f"{shape[0]}x{shape[1]}"
            r = runs[label] = run(shape, 0, save_to=ckdir if k == 0
                                  else None)
            r1 = (rel(r["loss"][0], single_hist["losses"][0]),
                  rel(r["grad_norm"][0], single_hist["grad_norms"][0]))
            check(max(r1) <= MT_STEP_BAR,
                  f"sharded training {label}: step 1 loss {r['loss'][0]} "
                  f"grad norm {r['grad_norm'][0]} against phase 19's "
                  f"{single_hist['losses'][0]}, "
                  f"{single_hist['grad_norms'][0]}")
            worst = max(rel(a, b) for a, b in zip(
                r["loss"], single_hist["losses"][:MT_STEPS]))
            check(worst <= MT_LOSS_BAR,
                  f"sharded training {label}: losses {r['loss']} against "
                  f"phase 19's {single_hist['losses'][:MT_STEPS]}")
            step_ms = statistics.median(r["step_s"][1:]) * 1e3
            print(f"sharded training {label} (stacked, fsdp, "
                  f"tensor_parallel; one forward of {r['n_local']} devices' "
                  f"{T_BATCH // shape[0]} x {T_SEQ} folded, the model axis "
                  f"splitting it): losses "
                  f"{r['loss']}; step 1 loss rel {r1[0]:.3g}, grad norm rel "
                  f"{r1[1]:.3g} from phase 19's, every loss within "
                  f"{worst:.3g}; step 1's params within {r['moved']:.3g} of "
                  f"the single device's where |g| > 1e-6; {step_ms:.1f} ms a "
                  f"step (median of steps 2-{MT_STEPS}; steps "
                  f"{[round(t * 1e3, 1) for t in r['step_s']]}; phase 19's "
                  f"single device 860.6 ms, PR 21); peak memory "
                  f"{r['peak'] / 2**30:.2f} GiB; hops and reductions a step "
                  f"{r['want']} [{tag}]")
            if k == 0:
                print(f"sharded training: the {label} state saved at step "
                      f"{MT_SAVE} in {r['save_s']:.1f} s [{tag}]")

        # (b) restored onto the second mesh, stepped on
        first, second = (f"{a}x{b}" for a, b in MT_MESHES)
        sh2 = TS.make_train_step(
            cfg, make_local_mesh(*MT_MESHES[1], device=dev), pcfg,
            ocfg)[2](like)
        t0 = time.perf_counter()
        restored = manager.restore(like, ckdir, shardings=sh2)
        restore_s = time.perf_counter() - t0
        data = np.load(Path(ckdir) / f"step_{MT_SAVE:08d}" / "arrays.npz")
        for (path, leaf), (_, s) in zip(_flatten(restored), _flatten(sh2)):
            a = data[path]
            for j, sl in enumerate(s.slices(a.shape)):
                check(torch.equal(leaf[j].cpu(),
                                  torch.from_numpy(np.array(a[sl]))),
                      f"elastic restore: {path} slice {j} is not the saved "
                      f"array's")
        r2 = run(MT_MESHES[1], MT_SAVE, state=restored)
        del restored
        want = runs[first]["loss"][MT_SAVE:]
        got = [rel(a, b) for a, b in zip(r2["loss"], want)]
        check(max(got) <= MT_STEP_BAR,
              f"elastic restore: {second}'s steps {MT_SAVE + 1}-{MT_STEPS} "
              f"losses {r2['loss']} against {first}'s {want}")
        print(f"sharded training: {first}'s step-{MT_SAVE} checkpoint "
              f"restored onto {second} in {restore_s:.1f} s, every slice "
              f"bit-equal to the saved arrays'; steps {MT_SAVE + 1}-"
              f"{MT_STEPS} losses {r2['loss']} against {want} (rel "
              f"{max(got):.3g}) [{tag}]")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()

    # (e) one step's collectives alone: device time against the bound
    for shape in MT_MESHES:
        mesh = make_local_mesh(*shape, device=dev)
        sh = TS.make_train_step(cfg, mesh, pcfg, ocfg)[2](like).params
        params = SH.shard(lm.init_lm(cfg, gen(), device=dev), sh)
        torch.cuda.empty_cache()
        batch_axes = tuple(a for a in ("data",) if mesh.shape[a] > 1)
        rules = leaf_rules(like.params, sh, mesh, batch_axes, pcfg, cfg)
        pairs = [(x, r[1], r[2]) for (_, x), r in zip(_flatten(params),
                                                      rules)]
        # (the sliced leaves' gradient all-gathers are not timed here)
        gather_ms = timed(lambda: [SH._gather(x, s, k) for x, s, k in pairs],
                          reps=5, device=True)
        # each leaf's gradient as the step's backward gets it: the shape
        # of its gathered copy
        grads = [(SH._gather(torch.ones((mesh.n_local,)
                                        + s.local_shape(x.shape),
                                        device=dev), s, k), s, sums, k)
                 for x, s, k, sums, *_ in rules]
        reduce_ms = timed(lambda: [SH._grad_to_shards(g, s, sums, k)
                                   for g, s, sums, k in grads], reps=5,
                          device=True)
        gb, rb = hop_bytes(rules, mesh.shape)
        print(f"sharded training {shape[0]}x{shape[1]} collectives a step "
              f"(K2 hops and the ring's copies): all-gathers "
              f"{gather_ms:.2f} device ms, its hops moving {gb:,} B (bound "
              f"{2 * gb / HBM_BYTES_PER_S * 1e3:.2f} ms: 2 x bytes / 3.35 "
              f"TB/s); gradient reductions {reduce_ms:.2f} device ms, "
              f"{rb:,} B (bound {2 * rb / HBM_BYTES_PER_S * 1e3:.2f} ms) "
              f"[{tag}]")
        del params, pairs, grads
        torch.cuda.empty_cache()

    # (c) the launcher on a reduced mesh, and the elastic example
    class Crash(Exception):
        pass

    argv = list(MT_ARGV) + ["--data", "2", "--model", "2"]
    res, st_a, hist = launch_train.run(argv)
    real_save = manager.save

    def save_then_crash(*a, **kw):
        real_save(*a, **kw)
        raise Crash

    ckdir = tempfile.mkdtemp(prefix="chip_smoke_mesh_launch_")
    try:
        manager.save = save_then_crash
        try:
            launch_train.run(argv + ["--ckpt-dir", ckdir, "--ckpt-every",
                                     str(MT_LAUNCH_CKPT)])
            check(False, "the launcher's checkpointed mesh run did not stop")
        except Crash:
            pass
        manager.save = real_save
        _, st_b, hist_b = launch_train.run(argv + ["--ckpt-dir", ckdir])
        _, _, hist_c = launch_train.run(
            list(MT_ARGV) + ["--data", "4", "--model", "1", "--ckpt-dir",
                             ckdir])
    finally:
        manager.save = real_save
        shutil.rmtree(ckdir, ignore_errors=True)
    same = all(bit_equal(a, b) for (_, a), (_, b) in zip(
        _flatten(st_a.params), _flatten(st_b.params)))
    tail = hist["losses"][MT_LAUNCH_CKPT:]
    check(same and hist_b["losses"] == tail,
          f"the launcher's resumed 2x2 run differs: params bit-equal {same},"
          f" losses {hist_b['losses']} against {tail}")
    onto = max(rel(a, b) for a, b in zip(hist_c["losses"], tail))
    check(onto <= MT_STEP_BAR,
          f"the launcher resumed onto 4x1: losses {hist_c['losses']} "
          f"against {tail}")
    ex = elastic_rescale.main([])
    print(f"sharded training launcher (reduced, --data 2 --model 2): loss "
          f"{res['first_loss']:.4f} -> {res['last_loss']:.4f}; resumed from "
          f"step {MT_LAUNCH_CKPT} bit-exactly, and onto --data 4 --model 1 "
          f"within rel {onto:.3g}; the elastic example 4x2 -> 2x2 resumed "
          f"at step {ex['resumed_step']}, losses {ex['phase1_loss']:.4f}, "
          f"{ex['phase2_loss']:.4f} [{tag}]")
    del st_a, st_b
    torch.cuda.empty_cache()
    mesh_train_nccl(tag, hist)
    print(f"sharded training phase: {time.perf_counter() - t_phase:.1f} s "
          f"[{tag}]")
    return total


def profiled(fn, **kw):
    """``fn()`` once under torch.profiler (``roofline.attribution.
    capture``: a lead-in of one-element kernels absorbs the device records
    a session drops, then ``fn`` in a marked region, the card
    synchronised before and after it): (the profile, the attribution of
    the region over the host window of the call and its sync).  Fails if
    a launch of the region has no device record."""
    from repro_torch.roofline import attribution as AT
    prof, att = AT.capture(fn, top=12, **kw)
    check(att["unrecorded"] == 0,
          f"profile: {att['unrecorded']} launches of the region without "
          f"a device record (the lead-in's {AT.LEAD_IN} launches lost "
          f"{att['lead_in_unrecorded']})")
    return prof, att


def device_split(prof, att) -> str:
    """One profile's device time three ways: under kernels and under
    copies and sets (the region's records, ``roofline.attribution``), and
    the sum of ``key_averages()``' self device time of its device events
    (torch's own table of the whole profile: the lead-in's one-element
    kernels included, the region's own annotation, which spans it, left
    out); and the lead-in's records the session dropped."""
    from repro_torch.roofline import attribution as AT
    table_ms = sum(e.self_device_time_total for e in prof.key_averages()
                   if "CUDA" in str(e.device_type)
                   and e.key != AT.REGION) / 1e3
    return (f"kernels {att['kernel_ms']:.3f} ms ({att['launches']}), "
            f"copies and sets {att['copy_ms']:.3f} ms ({att['copies']}), "
            f"key_averages {table_ms:.3f} ms, lead-in records dropped "
            f"{att['lead_in_unrecorded']}")


def profile_step(fn, label, tag, ops_shown=10) -> None:
    """Device time of one training step by the operator that launched it
    (torch.profiler), and the device's busy share of the host window
    (``roofline.attribution``)."""
    prof, att = profiled(fn)
    by_op = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                    for e in prof.key_averages()
                    if "CUDA" not in str(e.device_type)
                    and e.self_device_time_total > 0), reverse=True)
    print(f"sharded training {label} profile of one step: host "
          f"{att['window_ms']:.1f} ms (profiled), device busy "
          f"{att['busy_ms']:.1f} ms ({100 * att['busy_share']:.1f}%): "
          f"{device_split(prof, att)} [{tag}]")
    for ms, n, key in by_op[:ops_shown]:
        print(f"  {label} op {ms:.2f} device ms, {n} calls: {key[:60]} "
              f"[{tag}]")


def mesh_train_nccl(tag, want) -> None:
    """Phase 21's NCCL route: with two cards or more, the launcher of
    (c) as min(count, 4) ranks on a (ranks x 1) mesh
    (``Mesh.from_env``), its losses within MT_STEP_BAR of the stacked 2 x
    2 run's ``want``; with one card, a line that says it did not run."""
    import os
    import socket
    import torch
    count = torch.cuda.device_count()
    if count < 2:
        print(f"sharded training NCCL route: not run: "
              f"torch.cuda.device_count() is {count}, and NCCL takes one "
              f"card a rank; phase 21's meshes ran stacked on this card "
              f"only [{tag}]")
        return
    ranks = 4 if count >= 4 else 2
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = [sys.executable, "-m", "repro_torch.launch.train", *MT_ARGV,
            "--data", str(ranks), "--model", "1"]
    procs = [subprocess.Popen(
        argv, cwd=str(ROOT), env={
            **os.environ, "PYTHONPATH": str(ROOT / "src"), "RANK": str(r),
            "WORLD_SIZE": str(ranks), "LOCAL_RANK": str(r),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(ranks)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=M_NCCL_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"NCCL rank {r} failed:\n{logs[r][-3000:]}")
    got = json.loads(logs[0].strip().splitlines()[-1])
    last = want["losses"][-1]
    check(abs(got["last_loss"] - last) <= MT_STEP_BAR * abs(last),
          f"NCCL ranks' last loss {got['last_loss']} against {last}")
    print(f"sharded training NCCL route: {ranks} ranks over NCCL "
          f"(--data {ranks}), last loss {got['last_loss']} against the "
          f"stacked 2x2 run's {last} [{tag}]")


def split_train_phase(tag, single_hist) -> dict:
    """Phase 22: the split compute of the model axis in training.

    Full-width tinyllama-1.1b in f32 from phase 19's seed and OptConfig,
    SP_STEPS steps of the donated step (the state updated in place) on
    each (mesh, ParallelConfig, rows) of SP_RUNS: stacked 1 x 4 with
    tensor parallelism (8 q heads, 1 KV head, 1408 of ff and 8000 of the
    vocab a device) and 2 x 2 with sequence parallelism; step 1's loss and
    grad norm within MT_STEP_BAR of the single device's run over the same
    batches (phase 19's at T_BATCH rows, else one run here), every loss
    within MT_LOSS_BAR; every step's hops and reductions equal
    ``mesh_step_counts``, K2 the hops, K3's prefill route (K3e) the
    layers, nothing else; ms a step, peak memory, one step profiled by op.
    Returns the K2 and K3-prefill launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import ops
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train import shardings as SH
    from repro_torch.train import step as TS

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    cfg = get_config("tinyllama-1.1b")
    ocfg = adamw.OptConfig(lr=T_LR, warmup_steps=max(T_STEPS // 10, 1),
                           total_steps=T_STEPS)
    total = {"villa_gather": 0, "flash_attention_prefill": 0,
             "flash_attention_backward": 0}
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED)  # noqa: E731

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-12)

    for shape, kw, rows in SP_RUNS:
        label = f"{shape[0]}x{shape[1]}" + (" SP" if kw else " TP")
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=T_SEQ,
                          global_batch=rows, seed=SEED)
        batches = [batch_at(dcfg, i, device=dev) for i in range(SP_STEPS)]
        want = single_hist
        if rows != T_BATCH:
            # the single device over the same rows (phase 19's recipe)
            one = TS.ParallelConfig(fsdp=False)
            step1 = TS.make_train_step(cfg, one, ocfg)
            st = TS.init_train_state(cfg, gen(), one, device=dev)
            want = {"losses": [], "grad_norms": []}
            for b in batches:
                st, m = step1(st, b)
                want["losses"].append(float(m["loss"]))
                want["grad_norms"].append(float(m["grad_norm"]))
            del st, step1
            torch.cuda.empty_cache()
        pcfg = TS.ParallelConfig(fsdp=True, **kw)
        like = specs.state_specs(cfg, pcfg, torch.float32)
        mesh = make_local_mesh(*shape, device=dev)
        _, compile_step, state_shardings = TS.make_train_step(
            cfg, mesh, pcfg, ocfg, donate=True)
        sh = state_shardings(like)
        step = compile_step(like, batches[0])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # phase 19's initial state laid out, its moments made in place
        laid = SH.shard(lm.init_lm(cfg, gen(), device=dev), sh.params)
        n = mesh.n_local
        zeros = lambda: adamw.tree_map(torch.zeros_like, laid)  # noqa: E731
        state = TS.TrainState(
            laid, adamw.OptState(zeros(), zeros(), torch.zeros(
                (n,), dtype=torch.int32, device=dev)),
            torch.zeros((n,), dtype=torch.int32, device=dev), None)
        del laid
        torch.cuda.empty_cache()
        batch_axes = tuple(a for a in ("data",) if mesh.shape[a] > 1)
        due = mesh_step_counts(
            leaf_rules(like.params, sh.params, mesh, batch_axes, pcfg, cfg),
            mesh.shape, batch_axes, pcfg, cfg)
        hops = sum(h for h, _ in due.values())
        layers = cfg.n_layers * (2 if cfg.remat else 1)     # K3e forwards
        losses, gnorms, step_s = [], [], []
        for i in range(SP_STEPS):
            ops.reset_launch_counts()
            mesh.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batches[i])
            losses.append(float(m["loss"]))
            step_s.append(time.perf_counter() - t0)
            gnorms.append(float(m["grad_norm"]))
            check(mesh.counts() == due,
                  f"split training {label} step {i + 1}: hops and "
                  f"reductions {mesh.counts()}, {due} due")
            check_counts(ops.launch_counts(),
                         {"villa_gather": hops,
                          "flash_attention": layers,
                          "flash_attention_prefill": layers,
                          "flash_attention_backward": cfg.n_layers},
                         f"split training {label} step {i + 1}")
            total["villa_gather"] += hops
            total["flash_attention_prefill"] += layers
            total["flash_attention_backward"] += cfg.n_layers
        peak = torch.cuda.max_memory_allocated()
        r1 = (rel(losses[0], want["losses"][0]),
              rel(gnorms[0], want["grad_norms"][0]))
        worst = max(rel(a, b) for a, b in zip(
            losses, want["losses"][:SP_STEPS]))
        check(max(r1) <= MT_STEP_BAR and worst <= MT_LOSS_BAR,
              f"split training {label}: losses {losses}, grad norms "
              f"{gnorms} against the single device's "
              f"{want['losses'][:SP_STEPS]}, "
              f"{want['grad_norms'][:SP_STEPS]}")
        step_ms = statistics.median(step_s[1:]) * 1e3
        print(f"split training {label} (stacked, fsdp, {pcfg}, donated; "
              f"{rows} x {T_SEQ} a step): losses {losses}; step 1 loss rel "
              f"{r1[0]:.3g}, grad norm rel {r1[1]:.3g} from the single "
              f"device's ({'phase 19' if rows == T_BATCH else 'run here'}"
              f"), every loss within {worst:.3g}; {step_ms:.1f} ms a step "
              f"(median of steps 2-{SP_STEPS}; steps "
              f"{[round(t * 1e3, 1) for t in step_s]}); peak memory "
              f"{peak / 2**30:.2f} GiB; K3e {layers} launches a step "
              f"for the {n}-device stack (remat {cfg.remat}); hops and "
              f"reductions a step {due} "
              f"[{tag}]")
        profile_step(lambda: step(state, batches[0]), label, tag)
        del state, step
        torch.cuda.empty_cache()
    print(f"split training phase: {time.perf_counter() - t_phase:.1f} s "
          f"[{tag}]")
    return total


def one_ulp(t, gen):
    """A copy of ``t`` with each value moved by one ulp of f32 (2**-24 of
    its magnitude), up or down at random from ``gen``, a chunk at a time
    (a large leaf's temporaries stay small)."""
    import torch
    out = t.clone()
    flat = out.view(-1)
    for i in range(0, flat.numel(), 1 << 26):
        c = flat[i:i + (1 << 26)]
        step = c.abs().mul_(2.0 ** -24)
        up = torch.rand(c.shape, generator=gen, device=c.device) < 0.5
        c.add_(torch.where(up, step, -step))
    return out


def single_serve(cfg, params, toks, max_len, steps, enc=None, fed=None):
    """The single device's prefill logits of ``toks`` (over ``enc``'s
    frames for an enc-dec config) into a cache of ``max_len``, each greedy
    decode step's logits, and its greedy tokens (``steps`` + 1 of them),
    which the meshes are fed; with ``fed``, each step takes those tokens
    instead of its own."""
    import torch
    from repro_torch.models import lm
    B, S = toks.shape
    cache = lm.init_cache(cfg, B, max_len, device=toks.device,
                          enc_len=0 if enc is None else enc.shape[1])
    logits, _ = lm.prefill(cfg, params, toks, cache, enc_embeds=enc)
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    out, own = [], [tok]
    for i in range(steps):
        lg, _ = lm.decode_step(cfg, params, cache,
                               tok if fed is None else fed[i], S + i)
        out.append(lg)
        tok = lg[:, -1:].argmax(-1).to(torch.int32)
        own.append(tok)
    del cache
    return logits, out, own


def tokens_of(probs, ids, mesh):
    """A call's (probs, ids) rows in global token order: a mesh's from
    the devices at model position 0, by data position."""
    if mesh is None:
        return (probs.reshape(-1, probs.shape[-1]),
                ids.reshape(-1, ids.shape[-1]))
    c = mesh.coords()
    sel = sorted((int(c[i][0]), i) for i in range(len(c))
                 if int(c[i][1]) == 0)
    pick = [i for _, i in sel]
    return (probs[pick].reshape(-1, probs.shape[-1]),
            ids[pick].reshape(-1, ids.shape[-1]))


class Routes:
    """Every MoE layer's router probabilities and top-k choices of a run,
    in call order (``torch.topk`` over the experts, wrapped).  With
    ``force`` (another run's calls, global token order) and its ``mesh``,
    the run is teacher-forced on the routing too: each call takes the
    forced choices (each mesh device its rows'), and records its own
    beside them (``own``)."""

    def __init__(self, n_experts, force=None, mesh=None):
        import torch
        self.n, self.calls, self._real = n_experts, [], torch.topk
        self.force, self.mesh, self.own = force, mesh, []

    def __enter__(self):
        import torch

        def spy(x, k, *a, **kw):
            out = self._real(x, k, *a, **kw)
            if x.shape[-1] != self.n:
                return out
            ids = out.indices
            if self.force is not None:
                self.own.append(ids.clone())
                want = tokens_of(*self.force[len(self.calls)], None)[1]
                if self.mesh is None:
                    ids = want.reshape(ids.shape)
                else:
                    rows = [int(c[0]) for c in self.mesh.coords()]
                    ids = want.reshape(-1, x.shape[1], k)[rows]
                out = (x.gather(-1, ids), ids)
            self.calls.append((x.detach().clone(), ids.clone()))
            return out
        torch.topk = spy
        return self

    def __exit__(self, *exc):
        import torch
        torch.topk = self._real


def greedy_check(mine, want, bar):
    """(tokens that differ, near-ties exempted): the mesh's greedy token
    against the single device's at every row, a difference exempted only
    where the single device's top two logits lie within 2 x ``bar`` (a
    tie inside the bar is no disagreement)."""
    a = mine[:, -1].argmax(-1)
    top = want[:, -1].topk(2, dim=-1).values
    tie = (top[:, 0] - top[:, 1]) <= 2 * bar
    diff = a != want[:, -1].argmax(-1)
    return int((diff & ~tie).sum()), int((diff & tie).sum())


def serve_steps_phase(tag) -> dict:
    """Phase 23: ``make_prefill_step`` and ``make_serve_step`` over a
    laid-out cache on stacked meshes of the card.

    Full-width tinyllama-1.1b (f32, random weights from SEED) on each
    mesh of SV_MESHES and full-width, full-depth olmoe-1b-7b (f32, 27.7
    GB; experts over model, each stored once) on SV_MOE_MESH: SV_BATCH
    prompts of SV_PROMPT tokens prefilled into a cache of SV_MAX_LEN, then
    SV_STEPS greedy decode steps;
    each fed the single device's greedy tokens: every prefill and step's
    logits within SV_BAR (olmoe: SV_MOE_BAR) of the single-device
    ``lm.prefill``/
    ``decode_step``'s and the greedy tokens equal (but where the single
    device's top two logits tie within 2 x SV_BAR: counted); an MoE row
    whose expert choice first differs at a near-tie (SV_TIE) leaves the
    bar from there, counted, and at least one row stays; K3's
    prefill route cfg.n_layers launches for the prefill and its decode
    route cfg.n_layers a step, for the whole stack; K2 == the hops;
    nothing else; ms a prefill and a decode step, peak memory.  Returns
    the K2 launches and K3's by route and model."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.train import shardings as SH
    from repro_torch.train import step as TS

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    out = {"villa_gather": 0, "tinyllama": {"prefill": 0, "decode": 0},
           "olmoe": {"prefill": 0, "decode": 0}}
    pcfg = TS.ParallelConfig()

    def route_flips(single_calls, mesh_calls, mesh, per_call_rows):
        """{batch row: the call at which its expert choice first differs},
        and the largest single-device margin (k-th minus (k+1)-th
        probability) at such a first difference."""
        first, worst = {}, 0.0
        for c, ((p1, i1), (p2, i2)) in enumerate(zip(single_calls,
                                                     mesh_calls)):
            p1, i1 = tokens_of(p1, i1, None)
            _, i2 = tokens_of(p2, i2, mesh)
            k = i1.shape[-1]
            diff = (i1.sort(-1).values != i2.sort(-1).values).any(-1)
            top = p1.topk(k + 1, dim=-1).values
            margin = top[:, k - 1] - top[:, k]
            for t in torch.nonzero(diff).flatten().tolist():
                b = t // per_call_rows(c)
                if b not in first:
                    first[b] = c
                    worst = max(worst, float(margin[t]))
        return first, worst

    for name, arch, meshes in (("tinyllama", "tinyllama-1.1b", SV_MESHES),
                               ("olmoe", "olmoe-1b-7b", (SV_MOE_MESH,))):
        cfg = get_config(arch)
        params = model_params(cfg, torch.float32, arch,
                              "full width and depth")
        toks = torch.randint(0, cfg.vocab_size, (SV_BATCH, SV_PROMPT),
                             device=dev, dtype=torch.int32,
                             generator=torch.Generator(device=dev)
                             .manual_seed(SEED + 23))
        moe = "moe" in cfg.mlp_kinds()
        with Routes(cfg.n_experts) as r1:
            want_pre, want_steps, fed = single_serve(
                cfg, params, toks, SV_MAX_LEN, SV_STEPS)
        n_moe = sum(k == "moe" for k in cfg.mlp_kinds())
        for shape in meshes:
            label = f"{name} {shape[0]}x{shape[1]}"
            mesh = make_local_mesh(*shape, device=dev)
            cache = lm.init_cache(cfg, SV_BATCH, SV_MAX_LEN, device="meta")
            _, pcomp = TS.make_prefill_step(cfg, mesh, pcfg)
            _, scomp = TS.make_serve_step(cfg, mesh, pcfg)
            ps = SH.tree_shardings(params, mesh, SH.param_spec)
            cs = SH.tree_shardings(cache, mesh, SH.cache_spec)
            lg_sh = TS._logits_sharding(cfg, mesh, SV_BATCH)
            laid_p = SH.shard(params, ps)
            laid_c = SH.shard(lm.init_cache(cfg, SV_BATCH, SV_MAX_LEN,
                                            device=dev), cs, stack_dim=1)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            batch = {"tokens": toks}
            pstep = pcomp(params, cache, batch)
            tok0 = toks[:, :1]
            sstep = scomp(params, cache, tok0)
            ops.reset_launch_counts()
            mesh.reset_counts()
            outs, step_s = [], []
            with Routes(cfg.n_experts) as r2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, laid_c = pstep(laid_p, laid_c, batch)
                torch.cuda.synchronize()
                prefill_ms = (time.perf_counter() - t0) * 1e3
                outs.append(SH.unshard({"l": lg}, {"l": lg_sh})["l"])
                for i in range(SV_STEPS):
                    # teacher-forced: fed the single device's greedy token,
                    # so that every step's logits compare (one flipped tie
                    # would send the two runs down different texts)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    lg, laid_c = sstep(laid_p, laid_c, fed[i],
                                       SV_PROMPT + i)
                    outs.append(SH.unshard({"l": lg}, {"l": lg_sh})["l"])
                    torch.cuda.synchronize()
                    step_s.append(time.perf_counter() - t0)
            # rows whose expert choice moved at a near-tie leave the bar
            # from the call where it moved (prefill calls: n_moe, then
            # n_moe a step)
            first, tie_margin = ({}, 0.0) if not moe else route_flips(
                r1.calls, r2.calls, mesh,
                lambda c: SV_PROMPT if c < n_moe else 1)
            err, err_own, differ, ties = 0.0, 0.0, 0, 0
            row_err = [0.0] * SV_BATCH
            for i, (full, want) in enumerate(zip(outs, [want_pre]
                                                 + want_steps)):
                keep = [b for b in range(SV_BATCH)
                        if first.get(b, 1 << 30) >= n_moe * (i + 1)]
                if not keep:
                    continue
                for b in keep:
                    row_err[b] = max(row_err[b], float(
                        (full[b] - want[b]).abs().max()))
                d, t = greedy_check(full[keep], want[keep], SV_BAR)
                differ, ties = differ + d, ties + t
            err = max(row_err)
            check(tie_margin <= SV_TIE and len(first) < SV_BATCH,
                  f"mesh serving {label}: expert choices differ from the "
                  f"single device's in rows {first} (calls), the largest "
                  f"margin there {tie_margin} (a near-tie is within "
                  f"{SV_TIE})")
            hops = sum(h for h, _ in mesh.counts().values())
            check_counts(ops.launch_counts(), {
                "villa_gather": hops,
                "flash_attention": cfg.n_layers * (1 + SV_STEPS),
                "flash_attention_prefill": cfg.n_layers,
                "flash_attention_decode": cfg.n_layers * SV_STEPS},
                f"mesh serving {label}")
            bar = SV_MOE_BAR if moe else SV_BAR
            check(err <= bar and differ == 0,
                  f"mesh serving {label}: logits {err} from the single "
                  f"device's (bar {bar}; by row {row_err}, rows "
                  f"{first} left out from those calls), {differ} greedy "
                  f"tokens differ outside a tie")
            out["villa_gather"] += hops
            out[name]["prefill"] += cfg.n_layers
            out[name]["decode"] += cfg.n_layers * SV_STEPS
            print(f"mesh serving {label} (stacked, tensor_parallel, "
                  f"experts over model where MoE): prefill of {SV_BATCH} x "
                  f"{SV_PROMPT} {prefill_ms:.1f} ms, {SV_STEPS} greedy "
                  f"decode steps {statistics.median(step_s) * 1e3:.2f} ms "
                  f"a step (median; host clock with a sync, the logits "
                  f"gathered), every logit within {err:.3g} of the single "
                  f"device's (teacher-forced; by row "
                  f"{[float(f'{e:.3g}') for e in row_err]}; bar {bar}), "
                  f"greedy tokens equal but "
                  f"at {ties} ties within 2 x {SV_BAR}; "
                  + (f"MoE rows whose expert choice moved at a near-tie "
                     f"(margin <= {tie_margin:.3g}), left out from that "
                     f"call: {first}; " if moe else "")
                  + f"K3 {cfg.n_layers} "
                  f"launches a prefill and a step for the "
                  f"{mesh.n_local}-device stack, K2 {hops} hops; peak "
                  f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
                  f" GiB [{tag}]")
            del laid_p, laid_c, pstep, sstep
            torch.cuda.empty_cache()
        del params, want_pre, want_steps
        torch.cuda.empty_cache()
    print(f"mesh serving phase: {time.perf_counter() - t_phase:.1f} s "
          f"[{tag}]")
    return out


def split_serve_phase(tag) -> dict:
    """Phase 24: ``make_prefill_step`` and ``make_serve_step`` of the
    families item 16c left whole, split over ``model`` on stacked meshes
    of the card (SS_RUNS: deepseek-v2's MLA heads and experts, rwkv6's
    heads and ``ff``, jamba's mamba channels, attention heads and experts,
    seamless's encoder and cross attention), at full width, each cut in
    depth as SS_RUNS says, with random weights from SEED.

    SS_BATCH prompts of SS_PROMPT tokens (seamless's over SS_FRAMES frame
    embeddings) into a cache of SS_MAX_LEN, then SS_STEPS decode steps,
    teacher-forced on the single device's greedy tokens, and an MoE model
    on its routing too (``Routes(force=)``: a near-tie moved by rounding
    would send a token to another expert, and with it every later
    position); where the mesh's own top-k differs, the single device's
    margin there must be a near-tie.  Logits within SV_BAR of the single
    device's, or where a run names a truth (its weights in a wider dtype
    on the single device, fed its tokens and routing), at most SS_RATIO
    times the single device's own relative L2 gap to it, the near-tie
    band of its routing likewise twice the single device's own move of
    each token's router probabilities.  Greedy tokens equal but at ties
    within twice the bar (against a truth: its own largest move); K3's
    launches what the run's layers call for
    (MLA decodes through its absorbed einsums, rwkv and mamba run none),
    K2 == the hops, nothing else.  Returns the K2 launches and K3's by
    route and model."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.train import shardings as SH
    from repro_torch.train import step as TS

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    pcfg = TS.ParallelConfig()
    out = {"villa_gather": 0}
    for k, (name, arch, dtype, shape, layers, truth_dt,
            why) in enumerate(SS_RUNS):
        full = get_config(arch)
        cfg = full if layers is None else dataclasses.replace(
            full, n_layers=layers)
        dt = getattr(torch, dtype)
        params = model_params(cfg, dt, f"{arch} {dtype}",
                              f"{cfg.n_layers} of {full.n_layers} layers: "
                              f"{why}")
        gen = torch.Generator(device=dev).manual_seed(SEED + 24 + k)
        toks = torch.randint(0, cfg.vocab_size, (SS_BATCH, SS_PROMPT),
                             device=dev, dtype=torch.int32, generator=gen)
        enc = (torch.randn((SS_BATCH, SS_FRAMES, cfg.d_model), device=dev,
                           generator=gen) * 0.02 if cfg.encdec else None)
        moe = "moe" in cfg.mlp_kinds()
        with Routes(cfg.n_experts) as r1:
            want_pre, want_steps, fed = single_serve(
                cfg, params, toks, SS_MAX_LEN, SS_STEPS, enc)
        want = [want_pre] + want_steps
        truth = None
        if truth_dt is not None:
            # the single device over the truth's weights, fed its tokens
            # and routing: how far its own rounding moves the logits
            if truth_dt == "ulp":
                g_ulp = torch.Generator(device=dev).manual_seed(SEED + 240)
                p_hi = SH.tree_map(lambda t: one_ulp(t, g_ulp), params)
            else:
                p_hi = SH.tree_map(
                    lambda t: t.to(getattr(torch, truth_dt)), params)
            with Routes(cfg.n_experts,
                        force=r1.calls if moe else None) as r_hi:
                t_pre, t_steps, _ = single_serve(
                    cfg, p_hi, toks, SS_MAX_LEN, SS_STEPS, enc, fed=fed)
            truth = [t_pre] + t_steps
            del p_hi, t_pre, t_steps
            torch.cuda.empty_cache()
        label = f"{name} {shape[0]}x{shape[1]}"
        mesh = make_local_mesh(*shape, device=dev)
        enc_len = 0 if enc is None else SS_FRAMES
        like = lm.init_cache(cfg, SS_BATCH, SS_MAX_LEN, device="meta",
                             enc_len=enc_len)
        _, pcomp = TS.make_prefill_step(cfg, mesh, pcfg)
        _, scomp = TS.make_serve_step(cfg, mesh, pcfg)
        ps = SH.tree_shardings(params, mesh, SH.param_spec)
        cs = SH.tree_shardings(like, mesh, SH.cache_spec)
        lg_sh = TS._logits_sharding(cfg, mesh, SS_BATCH)
        laid_p = SH.shard(params, ps)
        laid_c = SH.shard(lm.init_cache(cfg, SS_BATCH, SS_MAX_LEN,
                                        device=dev, enc_len=enc_len), cs,
                          stack_dim=1)
        batch = {"tokens": toks}
        if enc is not None:
            batch["enc_embeds"] = enc
        pstep = pcomp(params, like, batch)
        sstep = scomp(params, like, toks[:, :1])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        mesh.reset_counts()
        outs, step_s = [], []
        with Routes(cfg.n_experts, force=r1.calls if moe else None,
                    mesh=mesh) as r2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, laid_c = pstep(laid_p, laid_c, batch)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            outs.append(SH.unshard({"l": lg}, {"l": lg_sh})["l"])
            for i in range(SS_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, laid_c = sstep(laid_p, laid_c, fed[i], SS_PROMPT + i)
                outs.append(SH.unshard({"l": lg}, {"l": lg_sh})["l"])
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
        counts = ops.launch_counts()
        hops = sum(h for h, _ in mesh.counts().values())
        peak = torch.cuda.max_memory_allocated()
        # the routing: where the mesh's own choice differs, a near-tie:
        # the single device's margin (k-th minus (k+1)-th probability)
        # within SV_TIE, or against a truth within twice how far the
        # single device's rounding moves that token's probabilities
        flips, margin, over = 0, 0.0, 0
        for c, ((p1, i1), own) in enumerate(zip(r1.calls, r2.own)):
            p1, i1 = tokens_of(p1, i1, None)
            n_k = i1.shape[-1]
            mine = tokens_of(own, own, mesh)[1]
            diff = (i1.sort(-1).values != mine.sort(-1).values).any(-1)
            top = p1.topk(n_k + 1, dim=-1).values
            gap = top[:, n_k - 1] - top[:, n_k]
            tie = (torch.full_like(gap, SV_TIE) if truth is None else
                   2 * (p1 - tokens_of(*r_hi.calls[c], None)[0]
                        .to(p1.dtype)).abs().amax(-1))
            flips += int(diff.sum())
            over += int((diff & (gap > tie)).sum())
            if bool(diff.any()):
                margin = max(margin, float(gap[diff].max()))
        check(over == 0,
              f"mesh serving {label}: the mesh's own expert choice differs "
              f"from the single device's at {flips} tokens, {over} of them "
              f"outside a near-tie (the largest margin {margin})")
        err, err_own, differ, ties = 0.0, 0.0, 0, 0
        sq = {"mesh": 0.0, "own": 0.0, "norm": 0.0}
        for i, (got, w) in enumerate(zip(outs, want)):
            got, w = got.float(), w.float()
            e = float((got - w).abs().max())
            err = max(err, e)
            if truth is None:
                bar = SV_BAR
                check(e <= bar, f"mesh serving {label}: logits {e} from "
                                f"the single device's (bar {bar})")
            else:
                t = truth[i].float()
                bar = float((w - t).abs().max())    # its own move, a tie
                err_own = max(err_own, bar)
                sq["mesh"] += float((got - w).square().sum())
                sq["own"] += float((w - t).square().sum())
                sq["norm"] += float(w.square().sum())
            d, n_tie = greedy_check(got, w, bar)
            differ, ties = differ + d, ties + n_tie
        check(differ == 0, f"mesh serving {label}: {differ} greedy tokens "
                           f"differ outside a tie")
        gaps = ""
        if truth is not None:
            gap = math.sqrt(sq["mesh"] / sq["norm"])
            own = math.sqrt(sq["own"] / sq["norm"])
            what = ("its weights moved by one ulp" if truth_dt == "ulp"
                    else f"its weights in {truth_dt}")
            check(gap <= SS_RATIO * own,
                  f"mesh serving {label}: the logits' relative L2 gap to "
                  f"the single device's {gap:.4g}, past {SS_RATIO} x its "
                  f"own gap to {what} ({own:.4g})")
            gaps = (f", relative L2 gap {gap:.4g} against the single "
                    f"device's own {own:.4g} to {what} (bar {SS_RATIO} "
                    f"x); largest {err_own:.3g} against {what}'s")
        kinds = cfg.layer_kinds()
        attn = sum(k in ("attn_full", "attn_local") for k in kinds)
        pre = attn + sum(k == "mla" for k in kinds) + (
            cfg.n_enc_layers + cfg.n_layers if cfg.encdec else 0)
        dec = (attn + (cfg.n_layers if cfg.encdec else 0)) * SS_STEPS
        due = {"villa_gather": hops}
        if pre + dec:
            due.update(flash_attention=pre + dec)
        if pre:
            due["flash_attention_prefill"] = pre
        wgmma = pre if wgmma_prefill(cfg, getattr(torch, dtype)) else 0
        if wgmma:
            due["flash_attention_prefill_wgmma"] = wgmma
        if dec:
            due["flash_attention_decode"] = dec
        check_counts(counts, due, f"mesh serving {label}")
        out["villa_gather"] += hops
        out[name] = {"prefill": pre, "decode": dec, "wgmma": wgmma}
        print(f"mesh serving {label} ({dtype} weights, f32 cache; stacked, "
              f"tensor_parallel): prefill of {SS_BATCH} x {SS_PROMPT}"
              f"{f' over {SS_FRAMES} frames' if enc is not None else ''} "
              f"{prefill_ms:.1f} ms, {SS_STEPS} teacher-forced decode steps "
              f"{statistics.median(step_s) * 1e3:.2f} ms a step (median; "
              f"host clock with a sync, the logits gathered); logits within "
              f"{err:.3g} of the single device's{gaps}; greedy tokens "
              f"equal but at {ties} ties"
              + (f"; routing forced on the single device's, the mesh's own "
                 f"top-k differing at {flips} tokens (margin <= "
                 f"{margin:.3g})" if moe else "")
              + f"; K3 {pre} launches a prefill and {dec // SS_STEPS} a "
              f"step for the {mesh.n_local}-device stack, K2 {hops} hops; "
              f"peak memory {peak / 2**30:.2f} GiB [{tag}]")
        del params, laid_p, laid_c, pstep, sstep, want, truth, outs
        torch.cuda.empty_cache()
    print(f"split mesh serving phase: {time.perf_counter() - t_phase:.1f} "
          f"s [{tag}]")
    return out


def audit_phase(tag) -> dict:
    """Phase 25: the entry points of full-width tinyllama-1.1b (f32, SLOTS
    slots at MAX_LEN, N_SESSIONS sessions, waves of SLOTS // 2) audited on
    the card and each one's live roofline.  Returns the launches the
    phase made, by counter."""
    import numpy as np
    import torch
    from repro_torch.analysis import dispatch as D
    from repro_torch.analysis import entrypoints as E
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.roofline import cost as C

    dev = torch.device("cuda")
    cfg = get_config("tinyllama-1.1b")
    params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    wave = SLOTS // 2
    ops.reset_launch_counts()
    targets, eng = E.default_targets(
        device=dev, params=params, reduced=False, slots=SLOTS,
        max_len=MAX_LEN, n_sessions=N_SESSIONS, wave=wave, seed=SEED)
    # (a) the audit: one warm call and one watched call a target
    audit = D.run_audit(targets, device=dev, extra_findings=(
        D.audit_bucket_stability(eng, E.prefill_buckets(eng))))
    for rec in audit["targets"]:
        print(f"audit {rec['name']}: launches {json.dumps(rec['launches'])}"
              f", syncs {rec['syncs']}, in place {rec['inplace']} "
              f"({rec['inplace_tensors']} tensors, {rec['alloc_bytes']} B "
              f"allocated), uint8 upcasts {rec.get('uint8_upcasts', '-')} "
              f"[{tag}]")
    check(audit["findings"] == [],
          f"entry-point audit findings: {json.dumps(audit['findings'])}")

    # (b) the live roofline of each entry point
    spec = eng.page_spec
    by_name = {t.name: t for t in targets}

    def cost_of(t):
        if t.name == "decode":
            return C.decode_cost(cfg, eng.params, eng.cache, eng.pos,
                                 [s in eng.active for s in range(SLOTS)])
        if t.name.startswith("prefill["):
            lb = int(t.name.split("=")[1].rstrip("]"))
            return C.prefill_cost(cfg, eng.params, eng.cache, lb,
                                  np.arange(lb))
        if t.name == "simulate_params":
            return C.tree_read_cost(t.args)
        moved = wave if t.name in ("suspend_many", "resume_many",
                                   "migrate") else 1
        return C.page_move_cost(moved, spec.total_bytes, spec.n_pages)

    # the process's first profile loads the profiler's own modules and
    # runs slower: one of the decode step is taken first and dropped
    profiled(lambda: by_name["decode"].fn())
    dropped = {}
    for name, t in by_name.items():
        cost = cost_of(t)

        def calls():
            for _ in range(ROOFLINE_CALLS):
                t.fn(*t.args, **t.kwargs)

        prof, att = profiled(calls)
        dropped[name] = att["lead_in_unrecorded"]
        check(att["kernel_ms"] > 0, f"roofline {name}: no device time")
        device_ms = att["kernel_ms"] / ROOFLINE_CALLS
        bound = C.bound_ms(cost)
        share = bound / device_ms
        row = {"entry": name, "flops": cost["flops"],
               "useful_flops": cost["useful_flops"], "bytes": cost["bytes"],
               "bound_ms": bound, "bound_by": C.bound_by(cost),
               "device_ms": device_ms,
               "copy_ms": att["copy_ms"] / ROOFLINE_CALLS, "share": share,
               "dominant_kernel": att["dominant"],
               "port_kernels": {k: {"device_ms": v["device_ms"]
                                    / ROOFLINE_CALLS,
                                    "count": v["count"] / ROOFLINE_CALLS}
                                for k, v in att["port_kernels"].items()},
               "busy_share": att["busy_share"],
               "window_ms": att["window_ms"] / ROOFLINE_CALLS,
               "launches": att["launches"] / ROOFLINE_CALLS,
               "copies": att["copies"] / ROOFLINE_CALLS,
               "lead_in_dropped": att["lead_in_unrecorded"]}
        print(json.dumps({"roofline": row}, allow_nan=False))
        check(share <= SHARE_LIMIT,
              f"roofline {name}: bound {bound:.4f} ms over device "
              f"{device_ms:.4f} ms is {share:.3f}: the cost model "
              f"counts work the call does not do")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"audit and roofline: {len(targets)} entry points, each "
          f"profile complete; lead-in records the profiles dropped "
          f"{json.dumps(dropped)}; launches {json.dumps(counts)} [{tag}]")
    del targets, eng, params
    torch.cuda.empty_cache()
    return {name: counts[name] for name in
            ("villa_scatter", "villa_gather", "flash_attention_prefill",
             "flash_attention_decode")}


def wgmma_prefill(cfg, dtype) -> bool:
    """Whether ``cfg``'s attention prefills at weights of ``dtype`` take
    K3's wgmma route: all-bf16 q, k and v (bf16 weights) at the head dims
    ``flash_attention.prefill_route`` sends there (MLA's expanded Dk / Dv
    among them)."""
    import torch
    from repro_torch.kernels import flash_attention as FA

    if "mla" in cfg.layer_kinds():
        dk, dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    else:
        dk = dv = cfg.head_dim
    return dtype == torch.bfloat16 and FA.prefill_route(
        dtype, dtype, dk, dv) == "wgmma"


def check_counts(counts, due, path) -> None:
    """Each kernel launched exactly as often as ``due`` says (never, for a
    kernel ``due`` leaves out), and each kernel ``due`` names at least
    once."""
    for name, n in counts.items():
        want = due.get(name, 0)
        check(n == want, f"kernel {name}: {n} launches on {path}, {want} due")
    for name, want in due.items():
        check(want > 0, f"kernel {name} was not launched on {path}")


def serve_runs(tag):
    """Phase 5: ``repro_torch.launch.serve.run`` at full width, plain and
    with a forked prefix plus a trace.  Yields each run's launch counts."""
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    cfg = get_config("tinyllama-1.1b")
    argv = ["--arch", "tinyllama-1.1b", "--slots", str(SLOTS),
            "--max-len", str(SERVE_LEN),
            "--requests", "16", "--followups", "32", "--max-new", "32",
            "--bursty", "--seed", "4"]
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = str(Path(tmp) / "trace.json")
        for extra in ([], ["--fork-prefix", "24", "--trace-out",
                           trace_path]):
            ops.reset_launch_counts()
            out, s = serve.run(argv + extra)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            eng, st = s.eng, s.eng.stats
            name = "launcher" + (" fork+trace" if extra else "")
            check(out["jobs_completed"] == 16 + 32
                  and all(j.state == "done" for j in s.jobs()),
                  f"{name}: not every job completed")
            check(st["resumes"] == sum(s.metrics.wave_widths("resume_wave")),
                  f"{name}: resumes outside the resume waves")
            check(out["decode_dispatches"] == out["host_transfers"],
                  f"{name}: not one host read per decode dispatch")
            check(eng.verify_failure_count() == 0,
                  f"{name}: a resume failed its checksums")
            if extra:
                check(out["fork"]["forks"] == 16
                      and out["fork"]["prefills"] == 1,
                      f"{name}: fork block {out['fork']}")
                with open(trace_path) as f:
                    events = json.load(f)["traceEvents"]
                check(len(events) > 0 and all("ph" in e for e in events),
                      f"{name}: the trace is not Chrome trace JSON")
            check_counts(counts, serving_launches(cfg, eng), name)
            print(f"{name}: {out['jobs_completed']} jobs, "
                  f"{out['tokens_per_s']} tok/s, {out['ticks']} ticks, "
                  f"{out['seconds']} s, p50 {out['p50_latency_ns']} ns, "
                  f"p99 {out['p99_latency_ns']} ns (virtual clock), "
                  f"launches {json.dumps(counts)} [{tag}]")
            yield counts


def profile_decode(eng, tag, steps=4, label="profile", experts=0):
    """Device time by kernel over a few decode steps of every slot
    (torch.profiler, ``roofline.attribution``), and the device's busy
    share of the host window.  With ``experts`` (an MoE model's expert
    count) also the device time of the routed expert products (the
    batched matmuls over ``experts`` weight matrices) and of the dispatch
    (sort, searchsorted, gather, scatter, topk), from the operators that
    launched them."""
    # budget: the seed token, one warm step, the window, and one more, so
    # no request completes (and suspends) inside the window
    eng.resume_many(sorted(eng.session_pos)[:eng.slots], steps + 3)
    eng.step()

    def window():
        for _ in range(steps):
            eng.step()

    prof, att = profiled(window, record_shapes=experts > 0)
    print(f"{label}: {steps} decode steps, host window "
          f"{att['window_ms']:.3f} ms, device busy {att['busy_ms']:.3f} ms "
          f"({100 * att['busy_share']:.1f}%), "
          f"{att['launches'] / steps:.0f} kernels/step; over the window: "
          f"{device_split(prof, att)} [{tag}]")
    for r in att["kernels"]:
        port = f" [{r['port']}]" if r["port"] else ""
        print(f"  {label} {r['kind']} {r['device_ms'] / steps:.4f} ms/step, "
              f"{r['count']} launches: {r['name'][:80]}{port}")
    if experts:
        dispatch = ("aten::sort", "aten::searchsorted", "aten::gather",
                    "aten::scatter_", "aten::topk")
        part = {"experts": [0.0, 0], "dispatch": [0.0, 0]}
        for e in prof.key_averages(group_by_input_shape=True):
            us = getattr(e, "device_time_total", None)
            us = e.cuda_time_total if us is None else us
            shapes = e.input_shapes or [[]]
            if e.key == "aten::bmm" and shapes[0][:1] == [experts]:
                name = "experts"
            elif e.key in dispatch:
                name = "dispatch"
            else:
                continue
            part[name][0] += us / 1e3
            part[name][1] += e.count
        print(f"{label}: routed expert products (bmm over {experts} "
              f"experts) {part['experts'][0] / steps:.4f} ms/step in "
              f"{part['experts'][1] / steps:.0f} calls; dispatch "
              f"(sort/searchsorted/gather/scatter/topk) "
              f"{part['dispatch'][0] / steps:.4f} ms/step in "
              f"{part['dispatch'][1] / steps:.0f} calls; "
              f"{att['launches'] / steps:.0f} kernels/step [{tag}]")
    while eng.active:
        eng.step()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(nccl_rank_main() if sys.argv[1:] == ["--nccl-rank"]
             else main())
